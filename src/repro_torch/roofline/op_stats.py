"""Per-step operation statistics of the port (counterpart of
``repro.roofline.hlo_stats``, which parses XLA's optimized HLO text; the
port has no HLO, so it counts the aten ops a step dispatches).

:class:`count_ops` is a ``TorchDispatchMode``: every aten op that runs inside
it, the backward pass's included, adds to an :class:`OpStats` with
``HloStats``' fields:

  * ``dot_flops``   — ``2·prod(result)·K`` of every op of the matmul family
                      (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_int_mm``,
                      ...); elementwise FLOPs are excluded, as in the JAX
                      package.
  * ``op_bytes``    — operand plus result bytes of every aten op that
                      launches a kernel (views and metadata ops excluded):
                      eager PyTorch's traffic with no fusion. It is not the
                      JAX package's fusion model and is not held to it.

One process runs the whole step, so no collective is counted (the JAX
package's ``collectives`` and ``collective_total`` have no counterpart).

The port's CUDA kernels (K1..K4) are ``ctypes`` calls, not aten ops, and the
int8 product pads its rows on the card only: each such function is
decorated with :func:`repro_torch.work.kernel`, which reports its own work
(its dot FLOPs, and the operations and bytes of its bound in ``PERF.md``)
once and keeps the aten ops of its body (the plain version on the CPU, the
launch's set-up on the card) out of the count. So a step counts the same on
the card and on fake CPU tensors (``FakeTensorMode``).

Example::

    >>> import torch
    >>> with count_ops() as c:
    ...     _ = torch.ones(4, 8) @ torch.ones(8, 3)
    >>> c.stats.dot_flops
    192.0
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import work

__all__ = ["OpStats", "count_ops"]

aten = torch.ops.aten

# matmul family: the position of the left operand
_DOTS = {
    aten.mm: 0, aten.bmm: 0, aten._int_mm: 0, aten.mv: 0, aten.dot: 0, aten.vdot: 0,
    aten.addmm: 1, aten.baddbmm: 1, aten.addbmm: 1, aten.addmv: 1,
}

# ops that launch no kernel (allocation, aliasing, metadata, host reads);
# ``prim`` ops (a fake tensor's ``device`` query) neither
_NO_KERNEL = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty, aten.new_empty_strided,
    aten.detach, aten.alias, aten.lift_fresh, aten._local_scalar_dense, aten.sym_size,
    aten.sym_stride, aten.sym_numel, aten.sym_storage_offset, aten.resize_, aten.set_,
    aten.is_same_size, aten._unsafe_view, aten.view, aten._reshape_alias,
}


class OpStats:
    """Counts of one step (``HloStats``' ``dot_flops`` and ``op_bytes``)
    and, per reported function (:mod:`repro_torch.work`), ``kernels[name]``
    = calls, dot FLOPs, operations and bytes."""

    def __init__(self):
        self.dot_flops = 0.0
        self.op_bytes = 0.0
        self.kernels: dict = {}
        self.n_ops = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _dot_flops(packet, args, out) -> float:
    """``2·prod(result)·K``; 0 for K = 1, an outer product that XLA's
    simplifier turns into a multiply (the backward of a norm's ``x·x``), so
    no dot of the JAX package's HLO."""
    lhs = args[_DOTS[packet]]
    if packet in (aten.dot, aten.vdot):
        return 2.0 * lhs.numel()
    k = lhs.shape[-1]
    return 2.0 * out.numel() * k if k > 1 else 0.0


class count_ops(TorchDispatchMode):
    """Count the aten ops run inside it into ``self.stats`` (an
    :class:`OpStats`). Enter it inside a ``FakeTensorMode`` to count a step
    without running it."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self._quiet = 0

    def __enter__(self):
        work.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def enter_kernel(self, name, dot_flops, ops, n_bytes):
        """A reported call begins: add its work; count no aten op until
        :meth:`exit_kernel`."""
        k = self.stats.kernels.setdefault(name, {"calls": 0, "dot_flops": 0.0, "ops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["dot_flops"] += dot_flops
        k["ops"] += ops
        k["bytes"] += n_bytes
        self.stats.dot_flops += dot_flops
        self.stats.op_bytes += n_bytes
        self._quiet += 1

    def exit_kernel(self):
        self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._quiet:
            return out
        packet = func.overloadpacket
        if packet in _DOTS:
            self.stats.dot_flops += _dot_flops(packet, args, out)
        if not (func.is_view or packet in _NO_KERNEL or func.namespace == "prim"):
            self.stats.n_ops += 1
            self.stats.op_bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out)))
        return out

