"""PyTorch port vs JAX package: the step builders, the sharding rules, the
dry-run planner, the roofline and the hillclimb variants, on the CPU.

The JAX side plans on ``Mesh``es of the host devices that
``tests/conftest.py`` forces (8) and reads the compiled HLO; the port plans
on shape-only meshes and counts its step on fake tensors
(``roofline.op_stats``). Tiny shapes are registered in both packages'
``SHAPES`` for a test. ``repro.launch.dryrun`` and ``repro.launch.hillclimb``
are not imported (they set ``XLA_FLAGS`` when imported), and the JAX
``build_cell``'s global activation rules are restored after every test.

Dot FLOPs of a prefill and a decode step equal JAX's exactly on 1x1. A train
step differs by named products: JAX's blocked attention checkpoints each KV
chunk (``repro/models/layers.py:331``), so its backward recomputes the q.k
score product once per layer and chunk, which the port's attention saves;
the MoE and Mamba2 steps also differ in which products are taken as dots
(see ``test_train_step_dot_flops``). On 2x2 the port's global
count over 4 devices is held within 1% of JAX's partitioned per-device
count.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh, NamedSharding

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs import shapes as j_shapes
from repro.configs.base import ShapeConfig as JShape
from repro.core.cim_linear import CiMConfig as JCiM
from repro.launch import shardings as j_sh
from repro.launch.steps import build_cell as j_build_cell
from repro.launch.steps import input_specs as j_input_specs
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.roofline import analysis as j_analysis
from repro.roofline import report as j_report
from repro_torch import tree as ttree
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs import shapes as t_shapes
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import for_shape
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.launch import dryrun, hillclimb, steps
from repro_torch.launch import shardings as t_sh
from repro_torch.launch.mesh import Mesh as TMesh
from repro_torch.launch.mesh import make_chip_mesh, make_local_mesh, make_production_mesh
from repro_torch.roofline import analysis as t_analysis
from repro_torch.roofline import hw
from repro_torch.roofline import op_stats
from repro_torch.roofline import report as t_report

TINY = {"tiny_train": (32, 2, "train"), "tiny_prefill": (32, 2, "prefill"), "tiny_decode": (32, 2, "decode")}
FAMILIES = ["smollm-135m", "qwen3-moe-30b-a3b", "mamba2-130m", "zamba2-7b"]


@pytest.fixture(autouse=True)
def _restore_act_rules():
    saved = j_layers.ACT_RULES
    yield
    j_layers.set_act_rules(saved)


@pytest.fixture
def tiny(monkeypatch):
    for name, (s, b, kind) in TINY.items():
        monkeypatch.setitem(j_shapes.SHAPES, name, JShape(name, s, b, kind))
        monkeypatch.setitem(t_shapes.SHAPES, name, ShapeConfig(name, s, b, kind))


def _jmesh(data, model):
    return Mesh(np.array(jax.devices()[: data * model]).reshape(data, model), ("data", "model"))


class _Spec:
    """A spec tuple held as one leaf of a tree."""

    def __init__(self, spec):
        self.spec = spec


def _port_leaves(args, specs):
    """[(shape, dtype name, spec)] of the port's stand-ins in JAX's leaf order."""
    flat = ttree.tree_leaves(ttree.tree_map(lambda t, s: (t, _Spec(s)), args, specs))
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch."), s.spec) for t, s in zip(flat[::2], flat[1::2])]


def _jax_leaves(args, shardings):
    shd = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    sds = jax.tree.leaves(args)
    assert len(shd) == len(sds)
    return [(tuple(a.shape), str(a.dtype), tuple(s.spec)) for a, s in zip(sds, shd)]


def _jax_resident(cell):
    shd = jax.tree.leaves(cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    return sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize for a, s in zip(jax.tree.leaves(cell.args), shd))


def _jax_roofline(arch, shape_name, mesh, cfg):
    cell = j_build_cell(arch, shape_name, mesh, cfg_override=cfg)
    with mesh:
        hlo = jax.jit(cell.fn, in_shardings=cell.in_shardings, donate_argnums=cell.donate).lower(*cell.args).compile().as_text()
    return j_analysis.roofline(arch, j_shapes.SHAPES[shape_name], cell.cfg, {}, hlo, mesh.devices.size, {})


def _port_flops(arch, shape_name, cfg, mesh=None):
    cell = steps.build_cell(arch, shape_name, mesh or make_local_mesh(), cfg_override=cfg)
    return steps.count_step(cell)


# ---------------------------------------------------------------------------
# meshes, specs, stand-ins, resident bytes
# ---------------------------------------------------------------------------


def test_production_and_local_meshes():
    single, multi, local = make_production_mesh(), make_production_mesh(multi_pod=True), make_local_mesh()
    assert (single.axis_names, tuple(single.shape.values()), single.size) == (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, tuple(multi.shape.values()), multi.size) == (("pod", "data", "model"), (2, 16, 16), 512)
    assert (local.axis_names, tuple(local.shape.values()), local.size) == (("data", "model"), (1, 1), 1)
    assert t_sh.logical_to_mesh(multi) == {"tp": ("model",), "fsdp": ("pod", "data"), "dp": ("pod", "data")}
    assert t_sh.shard_shape(multi, (64, 32, 3), (("pod", "data"), "model")) == (2, 2, 3)
    assert make_chip_mesh(2, 4) == TMesh((("data", 2), ("model", 4))) and make_chip_mesh(2, 4).size == 8


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax_on_production_meshes(arch):
    """Full-width params on (16, 16) and (2, 16, 16): specs and fallbacks."""
    sds = jax.eval_shape(j_build_model(J_ARCHS[arch]).init, jax.random.PRNGKey(0))
    stand = steps.param_stand_ins(ARCHS[arch])
    for multi in (False, True):
        jm = (AbstractMesh(axis_sizes=(2, 16, 16), axis_names=("pod", "data", "model")) if multi
              else AbstractMesh(axis_sizes=(16, 16), axis_names=("data", "model")))
        with j_sh.record_fallbacks() as jfb:
            jl = _jax_leaves(sds, j_sh.param_shardings(jm, sds, J_ARCHS[arch]))
        with t_sh.record_fallbacks() as tfb:
            tl = _port_leaves(stand, t_sh.param_shardings(make_production_mesh(multi_pod=multi), stand, ARCHS[arch]))
        assert tl == jl
        assert sorted(tfb) == sorted(jfb)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cells_match_jax_build_cell(arch):
    """Every valid cell at full width on 1x2, 2x2 and 2x4: the stand-ins of
    params, optimizer state (AdamW or Adafactor), batch, caches and decode
    token equal ``jax.eval_shape``'s leaf for leaf, and the specs equal
    ``tuple(NamedSharding.spec)``, with the same fallbacks."""
    for shape_name in t_shapes.valid_cells(ARCHS[arch]):
        for data, model in ((1, 2), (2, 2), (2, 4)):
            with j_sh.record_fallbacks() as jfb:
                jc = j_build_cell(arch, shape_name, _jmesh(data, model))
            with t_sh.record_fallbacks() as tfb:
                tc = steps.build_cell(arch, shape_name, make_chip_mesh(data, model))
            assert _port_leaves(tc.args, tc.in_shardings) == _jax_leaves(jc.args, jc.in_shardings), (shape_name, data, model)
            assert sorted(tfb) == sorted(jfb)
            assert tc.donate == jc.donate


@pytest.mark.parametrize("arch,shape_name", [("smollm-135m", "train_4k"), ("llama3-405b", "train_4k"),
                                             ("command-r-plus-104b", "decode_32k"), ("zamba2-7b", "decode_32k"),
                                             ("qwen3-moe-30b-a3b", "decode_32k")])
def test_resident_bytes_match_jax(arch, shape_name):
    """Full width on 2x4: AdamW (smollm), Adafactor (llama3-405b), int8 KV
    caches, the hybrid's caches."""
    jc = j_build_cell(arch, shape_name, _jmesh(2, 4))
    tc = steps.build_cell(arch, shape_name, make_chip_mesh(2, 4))
    assert dryrun.resident_bytes(tc, make_chip_mesh(2, 4)) == _jax_resident(jc)


def test_input_specs_match_jax():
    for arch in ("smollm-135m", "pixtral-12b"):  # tokens and embeddings
        for shape in t_shapes.SHAPES.values():
            cj, ct = for_shape_pair(arch, shape.name)
            want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), j_input_specs(cj, j_shapes.SHAPES[shape.name]))
            got = ttree.tree_map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), steps.input_specs(ct, shape))
            assert got == want
            assert all(t.device.type == "meta" for t in ttree.tree_leaves(steps.input_specs(ct, shape)))


def for_shape_pair(arch, shape_name):
    from repro.configs.registry import for_shape as j_for_shape

    return j_for_shape(J_ARCHS[arch], j_shapes.SHAPES[shape_name]), for_shape(ARCHS[arch], t_shapes.SHAPES[shape_name])


# ---------------------------------------------------------------------------
# counted FLOPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_dot_flops_equal_jax(arch, tiny):
    for shape_name in ("tiny_prefill", "tiny_decode"):
        want = _jax_roofline(arch, shape_name, _jmesh(1, 1), j_reduced(j_get_config(arch))).flops_per_device
        assert _port_flops(arch, shape_name, reduced(get_config(arch))).dot_flops == want, shape_name


def test_fake_quant_prefill_dot_flops_equal_jax(tiny):
    """K1 reports its tile dots (2·M·K·N, K padded to the rows) once: the
    count equals the JAX package's einsum plus the STE's float product."""
    cj = dataclasses.replace(j_reduced(j_get_config("smollm-135m")), cim=JCiM(mode="fake_quant"))
    ct = dataclasses.replace(reduced(get_config("smollm-135m")), cim=CiMConfig(mode="fake_quant"))
    want = _jax_roofline("smollm-135m", "tiny_prefill", _jmesh(1, 1), cj).flops_per_device
    stats = _port_flops("smollm-135m", "tiny_prefill", ct)
    assert stats.dot_flops == want
    assert stats.kernels["cim_matmul_fq"]["calls"] == 7 * ct.n_layers


# JAX's train step less the port's: the products each side takes that the other does not
TRAIN_TOL = {"smollm-135m": 0.0, "qwen3-moe-30b-a3b": 0.03, "mamba2-130m": 0.02}


@pytest.mark.parametrize("arch", sorted(TRAIN_TOL))
def test_train_step_dot_flops(arch, tiny):
    """smollm-135m: JAX = port + the q.k score product recomputed once per
    layer by JAX's checkpointed attention chunk (one chunk at seq 32), exact.
    qwen3-moe: that recompute, and the loss chunk's logits product, which
    the port takes in the forward pass and again in the backward pass's
    per-chunk recompute, where XLA merges the two (the untied unembedding,
    one chunk): within 3%. mamba2: JAX's checkpointed SSD chunk recomputes
    its score products, and XLA takes the backward's sums over the head dim
    (B, S, H, P) . (B, S, H, P) as dots where torch multiplies and sums:
    within 2%."""
    cj, ct = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    want = _jax_roofline(arch, "tiny_train", _jmesh(1, 1), cj).flops_per_device
    got = _port_flops(arch, "tiny_train", ct).dot_flops
    if arch == "smollm-135m":
        b, s = j_shapes.SHAPES["tiny_train"].global_batch, j_shapes.SHAPES["tiny_train"].seq_len
        assert s <= ct.attn_chunk
        assert want == got + ct.n_layers * 2 * b * ct.n_heads * s * s * ct.head_dim
    else:
        assert abs(got - want) <= TRAIN_TOL[arch] * want, (got, want)


def test_per_device_flops_on_2x2_within_one_percent_of_jax(tiny):
    mesh_t = make_chip_mesh(2, 2)
    for shape_name in ("tiny_prefill", "tiny_decode", "tiny_train"):
        cfg_t = reduced(get_config("smollm-135m"))
        jr = _jax_roofline("smollm-135m", shape_name, _jmesh(2, 2), j_reduced(j_get_config("smollm-135m")))
        stats = _port_flops("smollm-135m", shape_name, cfg_t, mesh_t)
        tr = t_analysis.roofline("smollm-135m", t_shapes.SHAPES[shape_name], cfg_t, stats, 4)
        want = jr.flops_per_device
        if shape_name == "tiny_train":  # the named recompute (test_train_step_dot_flops), per device
            want -= cfg_t.n_layers * 2 * 2 * cfg_t.n_heads * 32 * 32 * cfg_t.head_dim / 4
        assert abs(tr.flops_per_device - want) <= 0.01 * want, (shape_name, tr.flops_per_device, want)
        assert tr.bottleneck in ("compute", "memory")


def test_fake_count_equals_real_count():
    """The same step on real CPU tensors and on fake tensors: the same dot
    FLOPs and K1 work (a fake_quant + STE train step, remat on, so the
    recompute's K1 calls count too)."""
    cfg = dataclasses.replace(reduced(get_config("smollm-135m")), cim=CiMConfig(mode="fake_quant"), remat="full")
    shape = ShapeConfig("tiny_train", 32, 2, "train")
    t_shapes.SHAPES["tiny_train"] = shape
    try:
        cell = steps.build_cell("smollm-135m", "tiny_train", make_local_mesh(), cfg_override=cfg)
        fake = steps.count_step(cell)
        args = steps.materialize(cell, "cpu")
        with op_stats.count_ops() as real:
            new_params, _, metrics = cell.fn(*args)
    finally:
        del t_shapes.SHAPES["tiny_train"]
    assert fake.dot_flops == real.stats.dot_flops > 0
    assert fake.kernels == real.stats.kernels
    # a fake tensor's metadata queries (prim ops) count nothing; only the
    # constants the first run made and kept differ
    assert real.stats.op_bytes == pytest.approx(fake.op_bytes, rel=1e-6)
    assert fake.kernels["cim_matmul_fq"]["calls"] == 2 * 7 * cfg.n_layers
    assert np.isfinite(float(metrics["loss"]))
    assert ttree.tree_leaves(new_params)[0].device.type == "cpu"


def test_kernel_work_is_reported_once():
    """K1's wrapper adds its own work, and none of its plain body's ops."""
    x = torch.randint(-8, 8, (5, 32)).float()
    w = torch.randint(-8, 8, (32, 6)).float()
    from repro_torch.kernels.cim_matmul import cim_matmul_fq

    with op_stats.count_ops() as c:
        cim_matmul_fq(x, w, rows=16, step=1.0)
    assert c.stats.kernels == {"cim_matmul_fq": {"calls": 1, "dot_flops": 2.0 * 5 * 32 * 6,
                                                 "ops": 2.0 * 5 * 32 * 6, "bytes": 5 * 32 + 32 * 6 + 4 * 5 * 6}}
    assert c.stats.dot_flops == 2.0 * 5 * 32 * 6 and c.stats.n_ops == 0


@pytest.mark.parametrize("m", [4, 17, 32])
def test_int8_product_reports_the_cards_padded_work(m):
    """On the card ``_int_mm`` runs on M rounded up to 32 rows, after a
    zero-row pad: the count reports that work once on every device, and none
    of the CPU body's aten ops."""
    from repro_torch.core import cim_linear as cl

    x = torch.randint(-127, 128, (m, 64), dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 24), dtype=torch.int8)
    with op_stats.count_ops() as c:
        y = cl._int8_product(x, w)
    assert torch.equal(y, (x.long() @ w.long()).int())
    rows, k, n = 32, 64, 24
    pad = m * k + rows * k if m != rows else 0
    flops = 2.0 * rows * k * n
    assert c.stats.kernels == {"int8_mm": {"calls": 1, "dot_flops": flops, "ops": flops,
                                           "bytes": rows * k + k * n + 4 * rows * n + pad}}
    assert c.stats.dot_flops == flops and c.stats.n_ops == 0


def test_int8_dot_decode_counts_the_padded_rows(monkeypatch):
    """A decode at batch 4 (M 4) with ``int8_dot`` linears: each of a
    layer's 7 products counts 32 rows, as the card runs it; with the 28 pad
    rows taken out, the count equals the JAX package's."""
    monkeypatch.setitem(j_shapes.SHAPES, "tiny_decode4", JShape("tiny_decode4", 32, 4, "decode"))
    monkeypatch.setitem(t_shapes.SHAPES, "tiny_decode4", ShapeConfig("tiny_decode4", 32, 4, "decode"))
    cj = dataclasses.replace(j_reduced(j_get_config("smollm-135m")), cim=JCiM(mode="int8_dot", ste=False))
    ct = dataclasses.replace(reduced(get_config("smollm-135m")), cim=CiMConfig(mode="int8_dot", ste=False))
    stats = _port_flops("smollm-135m", "tiny_decode4", ct)
    d, q, kv = ct.d_model, ct.n_heads * ct.head_dim, ct.n_kv_heads * ct.head_dim
    kn = d * q + 2 * d * kv + q * d + 3 * d * ct.d_ff
    mm = stats.kernels["int8_mm"]
    assert mm["calls"] == 7 * ct.n_layers and mm["dot_flops"] == 2.0 * 32 * kn * ct.n_layers
    want = _jax_roofline("smollm-135m", "tiny_decode4", _jmesh(1, 1), cj).flops_per_device
    assert stats.dot_flops - mm["dot_flops"] / 32 * 28 == want


def test_model_flops_equal_jax():
    for arch in sorted(ARCHS):
        for shape in t_shapes.SHAPES.values():
            for impl in ("blocked", "flash"):
                cj, ct = for_shape_pair(arch, shape.name)
                cj, ct = dataclasses.replace(cj, attn_impl=impl), dataclasses.replace(ct, attn_impl=impl)
                js = j_shapes.SHAPES[shape.name]
                assert t_analysis.model_flops(ct, shape) == j_analysis.model_flops(cj, js)


# ---------------------------------------------------------------------------
# report, run_cell, run_variant
# ---------------------------------------------------------------------------


def _columns(table: str, names) -> list:
    """The cells of ``names``' columns, row by row (header included)."""
    rows = [[c.strip() for c in line.split("|")[1:-1]] for line in table.splitlines() if not line.startswith("|---")]
    idx = [rows[0].index(n) for n in names]
    return [[row[i] for i in idx] for row in rows]


def test_report_equals_jax_on_the_same_records(tiny):
    """The port's table has the JAX package's columns but the collective
    ones (a one-process step counts no collectives) and equals JAX's in
    them, the lever apart; its summary equals JAX's without the most
    collective-bound cells."""
    recs = []
    for arch, shape_name in (("smollm-135m", "tiny_prefill"), ("mamba2-130m", "tiny_decode"), ("qwen3-moe-30b-a3b", "tiny_prefill")):
        rep = _jax_roofline(arch, shape_name, _jmesh(1, 1), j_reduced(j_get_config(arch)))
        recs.append({"arch": arch, "shape": shape_name, "status": "ok", "memory": {"bytes": 3 * 2**29},
                     "roofline": json.loads(json.dumps(rep.to_dict())), "roofline_fraction": rep.roofline_fraction})
    fail = {"arch": "zamba2-7b", "shape": "tiny_train", "status": "fail", "error": "RuntimeError: boom"}
    want = dict(j_report.summary(recs + [fail]))
    del want["most_collective_bound"]
    assert t_report.summary(recs + [fail]) == want
    table, jtable = t_report.roofline_table(recs), j_report.roofline_table(recs)
    names = [c.strip() for c in table.splitlines()[0].split("|")[1:-1]]
    jnames = [c.strip() for c in jtable.splitlines()[0].split("|")[1:-1]]
    assert names == [n for n in jnames if n not in ("t_collective", "top collective")]
    shared = names[:-1]  # all but the lever
    assert _columns(table, shared) == _columns(jtable, shared)
    assert "| zamba2-7b | tiny_train | FAIL |" in t_report.roofline_table([fail])
    assert "RuntimeError: boom" in t_report.roofline_table([fail])


def test_run_cell_and_run_variant_reach_ok(tiny, tmp_path, capsys, monkeypatch):
    """Reduced configs registered under the cells' arch names, a tiny
    ``decode_32k`` and the 1x1 mesh in place of the production mesh."""
    cfg = dataclasses.replace(reduced(get_config("smollm-135m")), cim=CiMConfig(mode="fake_quant"))
    name = "C_commandr_decode/opt_int8_weights"
    arch, shape_name, over = hillclimb.VARIANTS[name]
    assert over["cim"] == CiMConfig(mode="int8_dot", ste=False)
    monkeypatch.setitem(ARCHS, "command-r-plus-104b", reduced(get_config(arch)))
    monkeypatch.setitem(ARCHS, "smollm-135m", cfg)
    monkeypatch.setitem(t_shapes.SHAPES, "decode_32k", ShapeConfig("decode_32k", 32, 2, "decode"))
    monkeypatch.setattr(hillclimb, "make_production_mesh", make_local_mesh)

    rec = dryrun.run_cell("smollm-135m", "tiny_train", False, tmp_path / "dr", mesh=make_local_mesh())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "1x1" and rec["n_devices"] == 1 and rec["memory"]["fits_one_h100"]
    assert rec["kernels"]["cim_matmul_fq"]["calls"] == 7 * cfg.n_layers
    assert rec["roofline"]["bottleneck"] in ("compute", "memory") and rec["roofline_fraction"] > 0
    assert (tmp_path / "dr" / "smollm-135m__tiny_train__1x1.json").exists()
    assert "fits one H100: yes" in capsys.readouterr().out
    # a cached green cell is read back
    assert dryrun.run_cell("smollm-135m", "tiny_train", False, tmp_path / "dr", mesh=make_local_mesh())["status"] == "ok"

    vrec = hillclimb.run_variant(name, out=tmp_path / "hc")
    assert vrec["status"] == "ok", vrec.get("traceback")
    assert vrec["roofline"]["flops_per_device"] > 0


def test_h100_constants():
    assert hw.PEAK_FLOPS_BF16 == 989.4e12 and hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80 * 10**9 and "H100" in hw.NAME
