"""Datasheet peaks of one NVIDIA H100 80GB HBM3 (SXM5), dense, no sparsity,
at its full 700 W power limit. Frozen here so the yardstick does not move
with the program: the bf16 and HBM figures are copied from
``src/repro_torch/roofline/hw.py``; int8 is NVIDIA's datasheet's 1,979
TOP/s. A card set below 700 W runs slower under load, so every result line
carries the card's power limit beside these peaks."""

NAME = "NVIDIA H100 80GB HBM3 (SXM5), 700 W datasheet"
ASSUMED_POWER_LIMIT_W = 700.0
PEAK_BF16_FLOPS = 989.4e12  # dense bf16 tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core OP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
