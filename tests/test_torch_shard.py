"""PyTorch port vs JAX package: the multi-chip fabric (``fabric.shard``) and
the pieces it needs (``launch.mesh``, ``launch.shardings``, ``obs.fallback``,
the mesh rollups), on the CPU.

Plans, fallbacks, rollups and markdown must equal the JAX package's on every
mesh it can build (``tests/conftest.py`` forces 8 host devices); 16-chip
plans, which the JAX package cannot build on this jax, are held to the
analytic numbers. ``execute_sharded_matmul`` must equal the JAX executor bit
for bit on 1x1 (noisy ADC included) and within the JAX tests' own tolerance
(atol 1e-4, rtol 1e-5) on 1x2, 2x1 and 2x2, on the same backend, with equal
conversion and comparison counts; the port's two backend names must give
equal tensors. The JAX side runs eagerly (its ``shard_map`` backend compiles), so
each JAX call here is one that a parity case needs.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import fabric as jfab
from repro.configs.registry import get_config as j_get_config
from repro.core import cim_linear as jcl
from repro.fabric import shard as jshard
from repro.launch import shardings as jsh
from repro.obs import fallback as jfallback
from repro_torch import fabric as tfab
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import cim_linear as tcl
from repro_torch.core import prng
from repro_torch.fabric import shard as tshard
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import shardings as tsh
from repro_torch.obs import fallback as tfallback
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4)]
FB = dict(mode="pair_sar", rows=16, cols=32, n_arrays=8)
BP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
FQ = dict(mode="fake_quant", a_bits=8, w_bits=8, adc_bits=5, rows=16, ste=False)
NOISY = dict(BP, comparator_sigma=0.05)
CIMS = {"bitplane": BP, "noisy": NOISY, "fake_quant": FQ}


def _meshes(data=1, model=1, **fabric):
    fj, ft = jfab.FabricConfig(**(fabric or FB)), tfab.FabricConfig(**(fabric or FB))
    return jfab.ChipMeshConfig(data=data, model=model, fabric=fj), tfab.ChipMeshConfig(data=data, model=model, fabric=ft)


def _plain(obj):
    """A JSON round trip, so the two packages' numbers compare as plain
    values."""
    return json.loads(json.dumps(obj, default=str))


def _sp_dict(sp):
    return {
        "name": sp.name, "m": sp.m, "k": sp.k, "n": sp.n, "k_splits": sp.k_splits, "d_splits": sp.d_splits,
        "fallbacks": sp.fallbacks, "chip": sp.chip.stats(), "chip_tiles": _plain([dataclasses.asdict(t) for t in sp.chip.tiles]),
        "bits": sp.crosschip_bits_per_pass, "energy": sp.crosschip_energy_pj, "latency": sp.crosschip_latency_s,
        "active": sp.n_chips_active,
    }


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# planning: shape only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,model", MESHES)
def test_shard_plans_rollups_and_markdown_equal_jax(data, model):
    """``shard_placement`` (divisible and ragged layers), ``shard_model``
    (smollm-135m, one block, tokens 4), ``overlapped_mesh_latency`` and
    ``sharded_fabric_report`` (dict and markdown) equal the JAX package's."""
    cj, ct = _meshes(data, model)
    for m, k, n in [(4, 64, 64), (8, 128, 48), (3, 40, 64), (6, 96, 40)]:
        pj = jfab.shard_placement(jfab.map_matmul("l", m, k, n, cj.fabric), cj, array_offset=3)
        pt = tfab.shard_placement(tfab.map_matmul("l", m, k, n, ct.fabric), ct, array_offset=3)
        assert _sp_dict(pt) == _sp_dict(pj)
    fab = dict(mode="hybrid", n_arrays=60)
    cj, ct = _meshes(data, model, **fab)
    sj = jfab.shard_model(j_get_config("smollm-135m"), cj, tokens=4, block_only=True)
    st = tfab.shard_model(t_get_config("smollm-135m"), ct, tokens=4, block_only=True)
    assert [_sp_dict(p) for p in st] == [_sp_dict(p) for p in sj]
    assert tfab.overlapped_mesh_latency(st) == jfab.overlapped_mesh_latency(sj)
    rj, rt = jfab.sharded_fabric_report(sj, cj), tfab.sharded_fabric_report(st, ct)
    assert _plain(rt) == _plain(rj)
    assert tfab.render_markdown(rt) == jfab.render_markdown(rj)


def test_replication_fallbacks_recorded_with_the_jax_messages():
    cj, ct = _meshes(2, 2)
    # 40 rows are 3 K-tiles (model 2 does not divide them); 3 batch rows on data 2
    for m, k, n in [(4, 40, 64), (3, 64, 64), (3, 40, 32)]:
        with jsh.record_fallbacks() as fj, tsh.record_fallbacks() as ft:
            pj = jfab.shard_placement(jfab.map_matmul("odd", m, k, n, cj.fabric), cj)
            pt = tfab.shard_placement(tfab.map_matmul("odd", m, k, n, ct.fabric), ct)
        assert pt.fallbacks == pj.fallbacks and pt.fallbacks and ft == fj
        assert (pt.k_splits, pt.d_splits) == (pj.k_splits, pj.d_splits)
        with pytest.raises(ValueError, match="replication fallbacks leave realized splits") as ej:
            jfab.resolve_backend(pj, "shard_map")
        with pytest.raises(ValueError, match="replication fallbacks leave realized splits") as et:
            tfab.resolve_backend(pt, "shard_map")
        assert str(et.value) == str(ej.value)
    # auto falls back to sequential with a structured replication_fallback record
    with tmetrics.collecting() as reg, ttrace.tracing() as tr:
        assert tfab.resolve_backend(pt, "auto") == "sequential"
    assert reg.counter("fabric_fallback_total").value(reason="replication_fallback") == 1.0
    assert tr.events[0]["attrs"]["component"] == "fabric.shard"


def test_a_16_chip_plan_equals_the_analytic_numbers():
    """The JAX package cannot build a 4x4 mesh on 8 host devices (its
    ``AbstractMesh`` call fails on this jax); the port plans it from the
    shape alone."""
    cfg = t_get_config("qwen2.5-32b")
    cm = tfab.ChipMeshConfig(data=4, model=4, fabric=tfab.FabricConfig(mode="hybrid", n_arrays=256))
    mesh = cm.mesh()
    assert mesh.axis_names == ("data", "model") and dict(mesh.shape) == {"data": 4, "model": 4}
    assert tmesh.make_chip_mesh(4, 4) == mesh  # no device count: one device holds every chip
    sps = tfab.shard_model(cfg, cm, tokens=4, block_only=True)
    assert [sp.name for sp in sps] == [f"block.{n}" for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                                             "up_proj", "down_proj")]
    for sp in sps:
        k_tiles = math.ceil(sp.k / 16)
        assert k_tiles % 4 == 0 and not sp.fallbacks
        assert (sp.k_splits, sp.d_splits, sp.n_chips_active) == (4, 4, 16)
        assert sp.crosschip_bits_per_pass == 3 * sp.m * sp.n * cm.psum_bits
        assert (sp.chip.m, sp.chip.k, sp.chip.n, sp.chip.k_tiles) == (1, sp.k // 4, sp.n, k_tiles // 4)
    rep = tfab.sharded_fabric_report(sps, cm)
    assert rep["mesh"]["n_chips"] == 16 and not rep["mesh"]["fallbacks"]
    assert rep["totals"]["crosschip_bits_per_pass"] == sum(3 * 4 * sp.n * 24 for sp in sps)
    # 16 chips each digitize 1/16 of a layer: the mesh total is the one-chip count
    assert rep["totals"]["conversions"] == sum(8 * 8 * 4 * math.ceil(sp.k / 16) * sp.n for sp in sps)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 4)])
def test_spec_for_and_record_fallbacks_equal_jax(data, model):
    from repro.launch.mesh import make_chip_mesh as j_make_chip_mesh

    mj, mt = j_make_chip_mesh(data, model), tmesh.make_chip_mesh(data, model)
    assert tuple(mt.axis_names) == tuple(mj.axis_names) and dict(mt.shape) == dict(mj.shape)
    assert tsh.logical_to_mesh(mt) == jsh.logical_to_mesh(mj)
    for shape, logical in [((16, 8), ("tp", "dp")), ((3, 8), ("tp", "dp")), ((16, 5), (None, "dp")), ((7, 9), ("tp", "fsdp"))]:
        with jsh.record_fallbacks() as fj, tsh.record_fallbacks() as ft:
            with tsh.record_fallbacks() as inner:
                spec = tsh.spec_for(mt, shape, logical, "t")
            assert tuple(spec) == tuple(jsh.spec_for(mj, shape, logical, "t"))
        assert ft == fj == inner
    assert tsh.axes_size(mt, ("data", "model")) == jsh.axes_size(mj, ("data", "model"))
    with pytest.raises(ValueError):
        tmesh.make_chip_mesh(0, 2)


@pytest.mark.parametrize("arch,block_only", [("smollm-135m", True), ("smollm-135m", False), ("qwen3-moe-30b-a3b", True),
                                             ("mamba2-130m", True), ("mamba2-130m", False)])
def test_model_forward_chain_equals_jax(arch, block_only):
    chain = tfab.model_forward_chain(t_get_config(arch), 4, block_only=block_only)
    assert chain == jfab.model_forward_chain(j_get_config(arch), 4, block_only=block_only)
    assert all(n_prev == k_next for (*_, n_prev), (_, _, k_next, _) in zip(chain, chain[1:]))
    if arch == "qwen3-moe-30b-a3b":
        assert [n for n, *_ in chain] == ["block.q_proj", "block.o_proj", "block.expert0.gate_proj",
                                          "block.expert0.down_proj"]


def test_fallback_taxonomy_equals_jax():
    assert tfallback.FALLBACK_REASONS == jfallback.FALLBACK_REASONS
    for problems in (["host has 8 jax device(s) < 16 chips"], ["replication fallback: realized 2x2 != mesh 4x4"],
                     ["layer 0 (l) has replication fallbacks: realized 1x1 != mesh 2x2"], ["chain break"], []):
        assert tfallback.classify_fallback(problems) == jfallback.classify_fallback(problems)
    with tmetrics.collecting() as reg, ttrace.tracing() as tr:
        tfallback.record_fallback("fabric.program", "ragged_batch", "batch 3 % data 2 != 0")
    assert tr.events[0]["name"] == "fabric.fallback"
    assert tr.events[0]["attrs"] == {"component": "fabric.program", "reason": "ragged_batch", "detail": "batch 3 % data 2 != 0"}
    assert reg.counter("fabric_fallback_total").value(reason="ragged_batch") == 1.0


# ---------------------------------------------------------------------------
# execution against the JAX executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(CIMS))
def test_execute_sharded_1x1_is_bit_exact_with_jax(mode):
    """On one chip the sharded executor is the JAX package's bit for bit, and
    the port's unsharded ``execute_matmul``; the noisy ADC draws equal."""
    cj, ct = _meshes()
    x, w = _inputs(3, 80, 40, seed=1) if mode == "noisy" else _inputs(4, 64, 48)
    cim = CIMS[mode]
    jkey, tkey = (jax.random.PRNGKey(7), prng.PRNGKey(7)) if mode == "noisy" else (None, None)
    yj, sj = jfab.execute_sharded_matmul(x, w, cj, jcl.CiMConfig(**cim), key=jkey, return_stats=True)
    yt, st = tfab.execute_sharded_matmul(torch.from_numpy(x), torch.from_numpy(w), ct, tcl.CiMConfig(**cim), key=tkey,
                                         return_stats=True)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert (int(st.conversions), float(st.comparisons)) == (int(sj.conversions), float(sj.comparisons))
    y1 = tfab.execute_matmul(torch.from_numpy(x), torch.from_numpy(w), ct.fabric, tcl.CiMConfig(**cim), key=tkey)
    assert torch.equal(yt, y1)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1), (2, 2)])
def test_execute_sharded_multichip_matches_jax_on_each_backend(data, model):
    """``bitplane`` on the sequential backend and ``fake_quant`` on the
    ``shard_map`` backend, against the JAX executor on the same mesh and
    backend (atol 1e-4, rtol 1e-5, the JAX tests' tolerance), with equal
    conversion and comparison counts; batched leading dims."""
    cj, ct = _meshes(data, model)
    x, w = _inputs(4, 64, 48, seed=2)
    x = x.reshape(2, 2, 64)
    for cim, backend in ((BP, "sequential"), (FQ, "shard_map")):
        yj, sj = jfab.execute_sharded_matmul(x, w, cj, jcl.CiMConfig(**cim), return_stats=True, backend=backend)
        yt, st = tfab.execute_sharded_matmul(torch.from_numpy(x), torch.from_numpy(w), ct, tcl.CiMConfig(**cim),
                                             return_stats=True, backend=backend)
        assert yt.shape == (2, 2, 48)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-5)
        assert (int(st.conversions), float(st.comparisons)) == (int(sj.conversions), float(sj.comparisons))


@pytest.mark.parametrize("mode", sorted(CIMS))
def test_the_ports_backends_give_equal_tensors_on_2x2(mode):
    """Both backend names run the one chip loop, which sums the chips'
    partials in chip order: equal tensors and stats, noisy ADC included.
    K 120 is 8 tiles with a ragged last one (the JAX ``shard_map`` backend
    pads it)."""
    _, ct = _meshes(2, 2)
    x, w = (torch.from_numpy(a) for a in _inputs(4, 120, 64, seed=4))
    tkey = prng.PRNGKey(5) if mode == "noisy" else None
    cim = tcl.CiMConfig(**CIMS[mode])
    ys, ss = tfab.execute_sharded_matmul(x, w, ct, cim, key=tkey, return_stats=True, backend="sequential")
    ym, sm = tfab.execute_sharded_matmul(x, w, ct, cim, key=tkey, return_stats=True, backend="shard_map")
    assert torch.equal(ys, ym)
    assert torch.equal(ss.conversions, sm.conversions) and torch.equal(ss.comparisons, sm.comparisons)


def test_chip_noise_keys_equal_jax_fold_in():
    key = jax.random.PRNGKey(11)
    assert tshard._chip_noise_key(None, 3) is None
    for c in range(4):
        want = np.asarray(jshard._chip_noise_key(key, c)).astype(np.int64)
        np.testing.assert_array_equal(prng.as_key(tshard._chip_noise_key(prng.PRNGKey(11), c)).numpy(), want)


def test_ragged_runtime_batch_records_the_fallback_and_runs_sequential():
    cj, ct = _meshes(2, 2)
    sp = tfab.shard_placement(tfab.map_matmul("l", 4, 64, 48, ct.fabric), ct)
    x, w = (torch.from_numpy(a) for a in _inputs(5, 64, 48, seed=7))
    cim = tcl.CiMConfig(**BP)
    with tmetrics.collecting() as reg:
        y = tfab.execute_sharded_matmul(x, w, ct, cim, sharded=sp)
    assert reg.counter("fabric_fallback_total").value(reason="ragged_batch") == 1.0
    assert torch.equal(y, tfab.execute_sharded_matmul(x, w, ct, cim, sharded=sp, backend="sequential"))
    with pytest.raises(ValueError, match="not divisible by the data axis") as et:
        tfab.execute_sharded_matmul(x, w, ct, cim, sharded=sp, backend="shard_map")
    spj = jfab.shard_placement(jfab.map_matmul("l", 4, 64, 48, cj.fabric), cj)
    with pytest.raises(ValueError) as ej:
        jfab.execute_sharded_matmul(x.numpy(), w.numpy(), cj, jcl.CiMConfig(**BP), sharded=spj, backend="shard_map")
    assert str(et.value) == str(ej.value)


def test_resolve_backend_and_the_executors_checks():
    _, ct = _meshes()
    sp1 = tfab.shard_placement(tfab.map_matmul("l", 4, 64, 48, ct.fabric), ct)
    assert tfab.resolve_backend(sp1, "auto") == "sequential"  # one chip: nothing to combine
    assert tfab.resolve_backend(sp1, "shard_map") == "shard_map"
    with pytest.raises(ValueError, match="unknown backend"):
        tfab.resolve_backend(sp1, "pmap")
    x, w = (torch.from_numpy(a) for a in _inputs(4, 64, 48))
    with pytest.raises(ValueError, match="bitplane|fake_quant"):
        tfab.execute_sharded_matmul(x, w, ct, tcl.CiMConfig(mode="exact"))
    with pytest.raises(ValueError, match="K=32"):
        tfab.execute_sharded_matmul(x, w, ct, tcl.CiMConfig(**BP),
                                    sharded=tfab.shard_placement(tfab.map_matmul("l", 4, 32, 48, ct.fabric), ct))
    _, other = _meshes(mode="pair_sar", rows=32, cols=32, n_arrays=8)
    with pytest.raises(ValueError, match="different ChipMeshConfig"):
        tfab.execute_sharded_matmul(x, w, other, tcl.CiMConfig(**BP), sharded=sp1)
    with pytest.raises(ValueError, match="different FabricConfig"):
        tfab.shard_placement(tfab.map_matmul("l", 4, 64, 64, tfab.FabricConfig(mode="hybrid", n_arrays=12)), ct)


# ---------------------------------------------------------------------------
# serve --fabric on a mesh
# ---------------------------------------------------------------------------


def test_serve_mesh_rollup_and_validation_matmul_equal_jax(capsys):
    """``fabric_rollup`` on a 2x2 mesh is the JAX serve's sharded rollup,
    and the validation matmul on the ``shard_map`` backend equals the JAX
    executor's bit for bit."""
    from repro.configs.base import reduced as j_reduced
    from repro_torch.configs import reduced as t_reduced

    cj, ct = _meshes(2, 2, mode="hybrid", n_arrays=60)
    cfg_j, cfg_t = j_reduced(j_get_config("smollm-135m")), t_reduced(t_get_config("smollm-135m"))
    rollup_j = jfab.sharded_fabric_report(jfab.shard_model(cfg_j, cj, tokens=2), cj)
    rollup_j["exec_backend"] = "shard_map"
    rollup_t = tserve.fabric_rollup(cfg_t, ct.fabric, 2, device="cpu", mesh=(2, 2), backend="shard_map")
    assert _plain(rollup_t) == _plain(rollup_j)
    assert "[serve] fabric exec backend: shard_map (1 cpu device(s) for 4 chip(s))" in capsys.readouterr().out
    fb = cj.fabric
    skey = jax.random.PRNGKey(0)
    x_s = jax.random.normal(skey, (2 * cj.data, cj.model * fb.rows))
    w_s = jax.random.normal(jax.random.fold_in(skey, 1), (cj.model * fb.rows, fb.cols))
    sp = jfab.shard_placement(jfab.map_matmul("smoke", *x_s.shape, fb.cols, fb), cj)
    cim = jcl.CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=fb.adc_bits, rows=fb.rows, ste=False)
    want = jfab.execute_sharded_matmul(x_s, w_s, cj, cim, sharded=sp, backend="sequential")
    got = tserve.validation_matmul(ct.fabric, device="cpu", chip_mesh=ct, backend="shard_map")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_on_a_4_chip_mesh(capsys):
    out = tserve.main([
        "--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
        "--gen-len", "4", "--cim", "fake_quant", "--fabric", "hybrid", "--fabric-chips", "4",
        "--fabric-backend", "shard_map",
    ])
    text = capsys.readouterr().out
    assert "[serve] fabric exec backend: shard_map (1 cpu device(s) for 4 chip(s))" in text
    assert "[serve] batch 2x12 tok on 4 chip(s) [shard_map]" in text and "**mesh:** 2x2 (data x model) = 4 chips" in text
    assert out["fabric"]["exec_backend"] == "shard_map" and out["fabric"]["n_chips"] == 4
    assert out["fabric"]["crosschip_bits_per_request"] > 0
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "smollm-135m", "--device", "cpu", "--fabric", "hybrid",
                     "--fabric-chips", "4", "--fabric-mesh", "2x2"])
    assert "not both" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "smollm-135m", "--device", "cpu", "--fabric-chips", "4"])
    assert "require --fabric" in capsys.readouterr().err
