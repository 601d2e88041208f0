"""Work reports of calls that are not aten ops, to the open op counters.

The port's CUDA kernels (K1..K4) are ``ctypes`` calls, and the int8 product
of ``core.cim_linear`` pads its rows on the card only, so an aten-op counter
(``roofline.op_stats.count_ops``) would see neither what the card does nor
the same thing on the card and on fake CPU tensors. Such a function is
decorated with :func:`kernel`: while a counter is open, each call reports
its own work once and the aten ops of its body stay uncounted.

A counter registers itself in :data:`ACTIVE` while it is open and takes
``enter_kernel(name, dot_flops, ops, n_bytes)`` and ``exit_kernel()``.
"""

from __future__ import annotations

import functools

__all__ = ["ACTIVE", "kernel"]

# counters open now. A plain list, not thread-local: autograd runs a CUDA
# backward (and remat's recompute, with its K1 calls) on its device threads.
ACTIVE: list = []


def kernel(name: str, work):
    """Decorator: ``work(*args, **kwargs)`` returns ``(dot_flops, ops,
    n_bytes)`` of one call, reported under ``name`` to every open counter.
    With no counter open the function runs as it is."""

    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            counters = list(ACTIVE)
            done = work(*args, **kwargs)
            for c in counters:
                c.enter_kernel(name, *done)
            try:
                return fn(*args, **kwargs)
            finally:
                for c in counters:
                    c.exit_kernel()

        return counted

    return wrap
