"""Formulas the metric readers share. A reader takes the run's record:
``run`` (the configuration's ``run`` group), ``mix`` (the traffic mix),
``calls`` (the measured window's calls), ``window_s``, ``setup_s``,
``profiled`` (the traced calls, after the window) and ``trace`` (their
:class:`~portbench.trace.DeviceTrace`, or None without ``--trace 1``).
A reader that finds nothing to read returns None."""

from __future__ import annotations

import re

from portbench import work


def tokens_per_s(rec, what: str):
    """Tokens of every call in the window over the calls' total wall time:
    prompt tokens (``prompt``) or generated tokens (``generated``)."""
    if not rec.calls:
        return None
    n = sum(c.call.batch * (c.call.prompt_len if what == "prompt" else c.call.gen_len) for c in rec.calls)
    return n / sum(c.wall_s for c in rec.calls)


def decode_step_ms(rec):
    steps = sum(c.call.gen_len - 1 for c in rec.calls)
    if not steps:
        return None
    return 1e3 * sum(c.decode_s for c in rec.calls) / steps


def kernel_seconds(rec, kernel: str) -> float:
    """Device seconds of the kernels whose function is named ``kernel`` or
    starts with it (``cim_fq_kernel`` matches ``void (anonymous
    namespace)::cim_fq_kernel<2, false>(...)``)."""
    pat = re.compile(r"(^|[\s:])" + re.escape(kernel))
    return sum(sec for name, (_, sec) in rec.trace.by_name.items() if pat.search(name))


def launches_per_forward(rec):
    if rec.trace is None or not rec.profiled:
        return None
    return rec.trace.launches / sum(c.call.gen_len for c in rec.profiled)


def k1_roofline(rec):
    """K1's share of its roofline over the traced calls: the least time of
    every CiM linear over the device time of the kernels named
    ``cim_fq_kernel``."""
    if rec.trace is None:
        return None
    t = kernel_seconds(rec, "cim_fq_kernel")
    if not t:
        return None
    bound = sum(work.k1_seconds(rec.run, lin) for c in rec.profiled for lin in work.cim_linears(rec.run, c.call))
    return 100.0 * bound / t


def k2_roofline(rec):
    """K2's share of its roofline over the traced calls: the least time of
    every prefill attention over the device time of the ``flash_`` kernels."""
    if rec.trace is None:
        return None
    t = kernel_seconds(rec, "flash_")
    if not t:
        return None
    bound = sum(work.attention_seconds(rec.run, *a) for c in rec.profiled for a in work.attention_calls(rec.run, c.call))
    return 100.0 * bound / t


def idle_pct(rec):
    if rec.trace is None or not rec.trace.window_s:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def mfu_pct(rec):
    """The ideal time of the window's model FLOPs (each at the peak of its
    arithmetic) over the window's wall time."""
    if not rec.calls:
        return None
    return 100.0 * sum(work.model_ideal_seconds(rec.run, c.call) for c in rec.calls) / rec.window_s
