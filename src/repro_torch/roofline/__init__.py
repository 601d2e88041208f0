"""Roofline analysis of the port's steps against one H100 (counterpart of
``repro.roofline``): counted by ``op_stats`` over a step run on fake tensors
or on the card."""

from repro_torch.roofline.analysis import RooflineReport, model_flops, roofline

__all__ = ["RooflineReport", "model_flops", "roofline"]
