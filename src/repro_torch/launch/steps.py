"""Step builders and shape-only input stand-ins for every (arch × shape) cell
(counterpart of ``repro.launch.steps``).

A stand-in is a tensor on the ``meta`` device: a shape and a dtype, no
storage (the JAX package's ``ShapeDtypeStruct``). ``build_cell`` gives the
cell's step function, the stand-ins of its arguments (params, optimizer
state or cache, inputs) equal to ``jax.eval_shape``'s leaf for leaf, the
plan's partition specs for them and the donated arguments. The params
come from ``Model.init`` run under ``FakeTensorMode``, the optimizer state
and the caches from ``opt_init`` and ``Model.make_cache`` on the ``meta``
device: nothing is allocated, at any width.

:func:`count_step` runs a cell's step under ``FakeTensorMode`` with
``roofline.op_stats`` counting, and :func:`materialize` makes real arguments
(seeded weights) on a device, for the same step run for real.

The port plans a mesh but runs the whole step in one process: it has no
activation sharding constraints (the JAX package's ``layers.set_act_rules``,
read by its partitioner at trace time), and ``build_cell`` sets no global
state.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import for_shape, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import shardings as sh
from repro_torch.launch.train import value_and_grad
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.optim.adafactor import AdafactorState
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.roofline import op_stats
from repro_torch.tree import tree_map

__all__ = ["input_specs", "param_stand_ins", "build_cell", "Cell", "count_step", "materialize"]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype, device="meta")


def _meta(tree):
    return tree_map(lambda t: _sds(tuple(t.shape), t.dtype), tree)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model-input stand-ins for one cell (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.input_kind == "embeddings":  # modality-frontend stub
            inputs = _sds((b, s, cfg.d_model), cfg.compute_dtype)
        else:
            inputs = _sds((b, s), "int32")
        return {"inputs": inputs, "labels": _sds((b, s), "int32")}
    if shape.kind == "prefill":
        if cfg.input_kind == "embeddings":
            return {"inputs": _sds((b, s, cfg.d_model), cfg.compute_dtype)}
        return {"inputs": _sds((b, s), "int32")}
    # decode: one new token against a cache of seq_len
    if cfg.input_kind == "embeddings":
        token = _sds((b, cfg.d_model), cfg.compute_dtype)
    else:
        token = _sds((b,), "int32")
    return {"token": token, "pos": _sds((), "int32")}


def param_stand_ins(cfg: ModelConfig) -> dict:
    """The params of ``cfg``'s model as stand-ins (``jax.eval_shape`` of
    the JAX package's ``model.init``)."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        return _meta(build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))


class Cell(NamedTuple):
    arch: str
    shape: str
    cfg: ModelConfig
    fn: Any  # step function on real or fake tensors
    args: tuple  # stand-in (meta tensor) trees of the arguments
    in_shardings: tuple  # spec trees of the arguments
    donate: tuple


def _adafactor_specs(params_sh, params_sds) -> AdafactorState:
    """Adafactor state specs: the factored row (column) statistics take the
    param's spec without its last (second-last) dim; the rest replicate."""

    def padded(spec, p):
        return tuple(spec) + (None,) * (len(p.shape) - len(spec))

    def vr(spec, p):
        return () if len(p.shape) < 2 else padded(spec, p)[:-1]

    def vc(spec, p):
        if len(p.shape) < 2:
            return ()
        s = list(padded(spec, p))
        del s[-2]
        return tuple(s)

    # the param tree drives each map, so a spec tuple arrives whole
    return AdafactorState(
        v_row=tree_map(lambda p, spec: vr(spec, p), params_sds, params_sh),
        v_col=tree_map(lambda p, spec: vc(spec, p), params_sds, params_sh),
        v_full=tree_map(lambda p, spec: () if len(p.shape) >= 2 else spec, params_sds, params_sh),
        count=(),
    )


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    lr: float = 3e-4,
    cfg_override: ModelConfig | None = None,
    device="cpu",
) -> Cell:
    """Construct (step fn, argument stand-ins, specs) for one dry-run cell;
    the step's model lives on ``device`` (the CPU by default: a count on fake
    tensors takes the plain versions of the kernels, as the CPU does)."""
    shape = SHAPES[shape_name]
    cfg = cfg_override or for_shape(get_config(arch), shape)
    model = build_model(cfg, device)
    params_sds = param_stand_ins(cfg)
    params_sh = sh.param_shardings(mesh, params_sds, cfg)
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        opt_init, opt_update = make_optimizer(cfg.optimizer)
        opt_sds = opt_init(params_sds)  # meta in, meta out
        if cfg.optimizer == "adamw":
            opt_sh = AdamWState(m=params_sh, v=params_sh, count=())
        else:
            opt_sh = _adafactor_specs(params_sh, params_sds)
        batch_sh = sh.batch_shardings(mesh, specs)

        def train_step(params, opt_state, batch, step):
            (loss, mets), grads = value_and_grad(model.loss_fn, params, batch)
            lr_t = warmup_cosine(step, lr, warmup=2000, total=100_000).to(loss.device)
            new_params, new_opt, opt_mets = opt_update(grads, opt_state, params, lr_t)
            metrics = {"loss": loss, **mets, **opt_mets, "lr": lr_t}
            return new_params, new_opt, metrics

        args = (params_sds, opt_sds, specs, _sds((), "int32"))
        in_sh = (params_sh, opt_sh, batch_sh, ())
        return Cell(arch, shape_name, cfg, train_step, args, in_sh, donate=(0, 1))

    cache_sds = build_model(cfg, "meta").make_cache(shape.global_batch, shape.seq_len)
    cache_sh = sh.cache_shardings(mesh, cache_sds, cfg)
    if shape.kind == "prefill":
        batch_sh = sh.batch_shardings(mesh, specs)

        def prefill_step(params, inputs, cache):
            return model.prefill(params, inputs, cache)

        args = (params_sds, specs["inputs"], cache_sds)
        in_sh = (params_sh, batch_sh["inputs"], cache_sh)
        return Cell(arch, shape_name, cfg, prefill_step, args, in_sh, donate=(2,))

    # decode
    tok_sds = specs["token"]
    dp_size = sh.axes_size(mesh, sh.logical_to_mesh(mesh)["dp"])
    tok_logical = ("dp",) + (None,) * (len(tok_sds.shape) - 1)
    if tok_sds.shape and tok_sds.shape[0] % dp_size == 0:
        tok_sh = sh.spec_for(mesh, tok_sds.shape, tok_logical, "token")
    else:
        tok_sh = ()

    def decode_step(params, token, pos, cache):
        return model.decode_step(params, token, pos, cache)

    args = (params_sds, tok_sds, specs["pos"], cache_sds)
    in_sh = (params_sh, tok_sh, (), cache_sh)
    return Cell(arch, shape_name, cfg, decode_step, args, in_sh, donate=(3,))


def _scalar(arg) -> bool:
    """The train step's ``step`` and the decode position: a 0-d integer
    stand-in, passed to the step as the Python int 0."""
    return isinstance(arg, torch.Tensor) and arg.dim() == 0 and not arg.is_floating_point()


def _leaf(t: torch.Tensor, device, gen=None):
    """A tensor for stand-in ``t`` on ``device``: integers are token ids in
    [0, 256), floats are normal draws (zeros without ``gen``: a fake tensor
    holds no values)."""
    if gen is None:
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    if t.is_floating_point():
        return torch.randn(t.shape, generator=gen, device=device).to(t.dtype)
    return torch.randint(0, 256, t.shape, generator=gen, device=device, dtype=t.dtype)


def count_step(cell: Cell) -> op_stats.OpStats:
    """The cell's step run once on fake tensors (nothing is computed or
    allocated) under ``op_stats.count_ops``: its dot FLOPs, op bytes and each
    port kernel's counted work."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(0 if _scalar(a) else tree_map(functools.partial(_leaf, device="cpu"), a) for a in cell.args)
        with op_stats.count_ops() as counter:
            cell.fn(*args)
    return counter.stats


def materialize(cell: Cell, device, seed: int = 0) -> tuple:
    """Real arguments of the cell's step on ``device``: seeded params from
    ``Model.init``, zero optimizer state (``opt_init``) and cache
    (``make_cache``), seeded inputs (token ids below 256 and below the
    vocab), step and position 0."""
    model = build_model(cell.cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen)
    shape = SHAPES[cell.shape]
    if shape.kind == "train":
        opt_init, _ = make_optimizer(cell.cfg.optimizer)
        batch = tree_map(lambda t: _leaf(t, model.device, gen), cell.args[2])
        return params, opt_init(params), batch, 0
    cache = model.make_cache(shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return params, _leaf(cell.args[1], model.device, gen), cache
    return params, _leaf(cell.args[1], model.device, gen), 0, cache
