"""PyTorch port vs JAX package: the single-chip fabric and the analytic core,
on the CPU.

Topology, placements, schedules, throughput, reports (dicts and markdown),
the analytic area/energy/noise/schedule models and the report CLI must equal
the JAX package's exactly. ``execute_matmul`` and ``column_tile_matmul`` must
equal it bit for bit in both fidelity modes, noiseless and noisy; the JAX
side runs eagerly, its Pallas fake-quant kernel in interpret mode.
"""

import contextlib
import dataclasses
import io
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core import cim_linear as jcl
from repro.core import energy_area as jea
from repro.core import noise as jnoise
from repro.core import schedule as jsched
from repro import fabric as jfab
from repro.fabric import report as jreport
from repro_torch import fabric as tfab
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import cim_linear as tcl
from repro_torch.core import energy_area as tea
from repro_torch.core import noise as tnoise
from repro_torch.core import schedule as tsched
from repro_torch.fabric import report as treport
from repro_torch.launch import serve as tserve

KEY = jax.random.PRNGKey(1)
FABRIC_MODES = ["pair_sar", "flash", "hybrid", "conventional_sar", "conventional_flash"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _fabrics(**kw):
    return jfab.FabricConfig(**kw), tfab.FabricConfig(**kw)


@pytest.fixture(scope="module")
def whole_smollm():
    """The whole of smollm-135m (262k tiles) mapped by both packages once,
    hybrid on 252 arrays at tokens 1: (JAX fabric, port fabric, JAX
    placements, port placements)."""
    fj, ft = _fabrics(mode="hybrid", n_arrays=252)
    return (fj, ft, jfab.map_model(j_get_config("smollm-135m"), fj, tokens=1),
            tfab.map_model(t_get_config("smollm-135m"), ft, tokens=1))


def _asdict(obj):
    """dataclasses.asdict, with the two packages' config classes compared by
    their fields."""
    return json.loads(json.dumps(dataclasses.asdict(obj), default=str))


def _placement_asdict(p):
    """``_asdict`` of a port placement, its tiles read one by one from the
    ``TileGrid`` that holds them (``asdict`` does not descend into it)."""
    return {**_asdict(dataclasses.replace(p, tiles=[])), "tiles": [_asdict(t) for t in p.tiles]}


# ---------------------------------------------------------------------------
# the analytic core: energy/area, noise, schedules (pure Python copies)
# ---------------------------------------------------------------------------


def test_energy_area_tables_match_jax():
    assert tea.table1() == jea.table1()
    assert tea.design_space() == jea.design_space()
    for style in tea.ADC_STYLES:
        for bits in (3, 5, 8):
            assert tea.area_um2(style, bits) == jea.area_um2(style, bits)
            assert tea.latency_cycles(style, bits) == jea.latency_cycles(style, bits)
            for kw in (dict(), dict(vdd=0.8, flash_bits=3, flash_share=4)):
                assert tea.energy_pj(style, bits, **kw) == jea.energy_pj(style, bits, **kw)


def test_noise_models_match_jax():
    for freq, vdd in ((10e6, 1.0), (40e6, 0.8), (100e6, 0.6), (1e6, 1.2)):
        ej, et = jnoise.AnalogEnv(freq, vdd), tnoise.AnalogEnv(freq, vdd)
        assert tnoise.effective_sigma(et) == jnoise.effective_sigma(ej)
        assert tnoise.conversion_energy_pj(et, 3.7) == jnoise.conversion_energy_pj(ej, 3.7)
        assert tnoise.power_uw(et, 5.0) == jnoise.power_uw(ej, 5.0)


@pytest.mark.parametrize("bits,flash_bits", [(5, 2), (6, 3), (4, 1)])
def test_schedules_match_jax(bits, flash_bits):
    assert tsched.throughput_summary(bits, flash_bits) == jsched.throughput_summary(bits, flash_bits)
    for tj, tt in ((jsched.pair_sar_schedule(bits, 6), tsched.pair_sar_schedule(bits, 6)),
                   (jsched.hybrid_schedule(bits, flash_bits, 4), tsched.hybrid_schedule(bits, flash_bits, 4))):
        assert _asdict(tt) == _asdict(tj)
        assert tt.utilization() == tj.utilization() and tt.utilization("ref_gen") == tj.utilization("ref_gen")


# ---------------------------------------------------------------------------
# topology, mapping, pipeline, report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", FABRIC_MODES)
def test_fabric_config_groups_and_area_match_jax(mode):
    for kw in (dict(n_arrays=64), dict(n_arrays=130, adc_bits=6, flash_bits=3, n_cim_per_group=4),
               dict(area_budget_um2=2.5e5), dict(n_arrays=None)):
        fj, ft = _fabrics(mode=mode, **kw)
        for attr in ("n_ref_per_group", "compute_arrays_per_group", "group_size", "adc_style",
                     "array_area_um2", "digitizer_area_um2", "per_array_area_um2", "n_groups",
                     "n_compute_arrays"):
            assert getattr(ft, attr) == getattr(fj, attr), attr
        for meth in ("resolved_n_arrays", "chip_area_um2", "chip_adc_area_um2", "weight_capacity_bits"):
            assert getattr(ft, meth)() == getattr(fj, meth)(), meth
        assert tfab.arrays_for_area(1e6, ft) == jfab.arrays_for_area(1e6, fj)
        if not mode.startswith("conventional"):
            assert _asdict(ft.iso_area_counterpart()) == _asdict(fj.iso_area_counterpart())
    for bad in (dict(mode="star"), dict(mode="hybrid", flash_bits=5), dict(n_cim_per_group=0),
                dict(mode="flash", n_arrays=10)):
        with pytest.raises(ValueError):
            jfab.FabricConfig(**bad)
        with pytest.raises(ValueError):
            tfab.FabricConfig(**bad)
    cj = jfab.ChipMeshConfig(data=2, model=3, fabric=jfab.FabricConfig(mode=mode))
    ct = tfab.ChipMeshConfig(data=2, model=3, fabric=tfab.FabricConfig(mode=mode))
    assert (ct.n_chips, ct.shape, ct.total_area_um2(), ct.total_weight_capacity_bits()) == (
        cj.n_chips, cj.shape, cj.total_area_um2(), cj.total_weight_capacity_bits())
    assert tfab.MODES == jfab.MODES and tfab.BITCELL_UM2_65NM == jfab.BITCELL_UM2_65NM


def test_map_matmul_and_map_model_match_jax(whole_smollm):
    fj, ft = _fabrics(mode="pair_sar", n_arrays=8)
    for m, k, n, off in ((1, 40, 70, 0), (4, 64, 64, 3), (3, 100, 33, 7)):
        pj = jfab.map_matmul("l", m, k, n, fj, array_offset=off)
        pt = tfab.map_matmul("l", m, k, n, ft, array_offset=off)
        assert _placement_asdict(pt) == _asdict(pj)
        tiles = list(pt.tiles)
        assert (pt.tiles[-1], pt.tiles[1:3], len(pt.tiles)) == (tiles[-1], tiles[1:3], len(tiles))
        assert (pt.resident, pt.weight_load_bits, pt.activation_bits, pt.conversions,
                pt.conversions_per_array_max, pt.stats()) == (
            pj.resident, pj.weight_load_bits, pj.activation_bits, pj.conversions,
            pj.conversions_per_array_max, pj.stats())
    with pytest.raises(ValueError):
        tfab.map_matmul("l", 1, 32, 32, ft, cim=tcl.CiMConfig(rows=32))
    def rows(ps):  # every placement field and tile, without asdict's deep copies
        return [(p.name, p.m, p.k, p.n, p.k_tiles, p.n_tiles, p.rounds, _asdict(p.cim), _asdict(p.fabric),
                 [(t.k_tile, t.n_tile, t.array, t.round, t.k0, t.k1, t.n0, t.n1) for t in p.tiles]) for p in ps]

    fj, ft = _fabrics(mode="hybrid", n_arrays=60)
    for arch in ("smollm-135m", "qwen3-moe-30b-a3b", "zamba2-7b", "mamba2-130m"):
        for block_only in (True, False):
            assert tfab.model_matmuls(t_get_config(arch), 4, block_only) == jfab.model_matmuls(
                j_get_config(arch), 4, block_only)
        if arch == "zamba2-7b":  # its matmul list is held above; its placements are the same map_matmul at wider shapes
            continue
        pj = jfab.map_model(j_get_config(arch), fj, tokens=4, block_only=True)
        pt = tfab.map_model(t_get_config(arch), ft, tokens=4, block_only=True)
        assert rows(pt) == rows(pj)
    # the whole of smollm-135m, tile for tile
    *_, pj, pt = whole_smollm
    assert rows(pt) == rows(pj)


@pytest.mark.parametrize("mode", FABRIC_MODES)
def test_pipeline_matches_jax(mode):
    fj, ft = _fabrics(mode=mode, n_arrays=120)
    for n_conv in (1, 7, 32):
        assert _asdict(tfab.pipelined_schedule(ft, n_conv)) == _asdict(jfab.pipelined_schedule(fj, n_conv))
    assert tfab.fabric_throughput(ft) == jfab.fabric_throughput(fj)
    if not mode.startswith("conventional"):
        assert tfab.iso_area_comparison(ft) == jfab.iso_area_comparison(fj)
    assert tfab.overlap_rounds([1.0, 2.0, 0.5], [0.7, 3.0, 0.1]) == jfab.overlap_rounds([1.0, 2.0, 0.5], [0.7, 3.0, 0.1])
    placement_t = tfab.map_matmul("l", 4, 96, 80, ft)
    placement_j = jfab.map_matmul("l", 4, 96, 80, fj)
    assert tfab.conversion_cycles(placement_t, 0.37) == jfab.conversion_cycles(placement_j, 0.37)


@pytest.mark.parametrize("mode", ["pair_sar", "flash", "hybrid", "conventional_sar"])
def test_fabric_report_and_markdown_match_jax(mode, request):
    fj, ft = _fabrics(mode=mode, n_arrays=252)
    placements = [(jfab.map_model(j_get_config(arch), fj, tokens=tokens, block_only=True),
                   tfab.map_model(t_get_config(arch), ft, tokens=tokens, block_only=True))
                  for arch, tokens in (("smollm-135m", 4), ("qwen3-moe-30b-a3b", 2))]
    if mode == "hybrid":  # the whole model once: 211 rows, "... more layers"
        placements.append(request.getfixturevalue("whole_smollm")[2:])
    for pj, pt in placements:
        rj, rt = jfab.fabric_report(pj, fj), tfab.fabric_report(pt, ft)
        assert rt == rj
        for max_layers in (24, 3, None):
            assert tfab.render_markdown(rt, max_layers) == jfab.render_markdown(rj, max_layers)


def test_render_markdown_of_a_mesh_report_matches_jax():
    """The port renders the JAX package's mesh sections (cross-chip columns,
    graph, overlap) as it does, though the graph section's producer waits
    for A7."""
    cm = jfab.ChipMeshConfig(model=2, fabric=jfab.FabricConfig(mode="hybrid", n_arrays=60))
    sps = jfab.shard_model(j_get_config("smollm-135m"), cm, tokens=4, block_only=True)
    rep = jfab.sharded_fabric_report(sps, cm, graph=jfab.model_forward_graph(j_get_config("smollm-135m"), 4, True))
    rep = json.loads(json.dumps(rep, default=float))
    assert treport.render_markdown(rep) == jreport.render_markdown(rep)


def _cli(main, argv):
    old = sys.argv
    sys.argv = ["report"] + argv
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = old
    return out.getvalue()


@pytest.mark.parametrize("argv", [
    ["--arch", "smollm-135m", "--mode", "hybrid", "--arrays", "252", "--block-only", "--tokens", "4", "--json"],
    ["--arch", "smollm-135m", "--mode", "pair_sar", "--arrays", "100", "--tokens", "2"],
])
def test_report_cli_prints_what_the_jax_cli_prints(argv):
    assert _cli(treport.main, argv) == _cli(jreport.main, argv)


# ---------------------------------------------------------------------------
# numerical execution
# ---------------------------------------------------------------------------


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32), (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)


def test_analytic_cim_stats_and_its_int32_overflow_match_jax():
    for kw in (dict(mode="fake_quant", a_bits=4, w_bits=4), dict(mode="fake_quant", search="sar_asym")):
        sj = jfab.analytic_cim_stats(jcl.CiMConfig(**kw), 2, 3, 8)
        st = tfab.analytic_cim_stats(tcl.CiMConfig(**kw), 2, 3, 8)
        assert st.conversions.dtype == torch.int32
        assert (int(st.conversions), int(st.comparisons)) == (int(sj.conversions), int(sj.comparisons))
    # a full-width count past int32 (8/8 bits: 64 plane pairs x 1024 x 36 x 1536)
    big = (1024, 36, 1536)
    with pytest.raises(OverflowError, match="int32"):
        jfab.analytic_cim_stats(jcl.CiMConfig(mode="fake_quant"), *big)
    with pytest.raises(OverflowError, match="int32"):
        tfab.analytic_cim_stats(tcl.CiMConfig(mode="fake_quant"), *big)


@pytest.mark.parametrize("noisy", [False, True], ids=["noiseless", "noisy"])
def test_column_tile_matmul_with_key_and_row_offset_matches_jax(noisy):
    kw = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
    if noisy:
        kw.update(comparator_sigma=0.03, ref_mismatch_sigma=0.02)
    x, w = _operands(3, 40, 64, 2)
    xi, _ = jcl.quantize_symmetric(jnp.asarray(x), 4, True)
    wi, _ = jcl.quantize_symmetric(jnp.asarray(w), 4, True, per_axis=-1)
    key = KEY if noisy else None
    y_j, s_j = jfab.column_tile_matmul(xi, wi, jcl.CiMConfig(**kw), 32, key=key, row_offset=5)
    y_t, s_t = tfab.column_tile_matmul(_t(xi), _t(wi), tcl.CiMConfig(**kw), 32, key=key, row_offset=5)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert (int(s_t.conversions), int(s_t.comparisons)) == (int(s_j.conversions), int(s_j.comparisons))


@pytest.mark.parametrize(
    "mode,noisy,ste",
    [("bitplane", False, False), ("bitplane", True, False), ("bitplane", True, True),
     ("fake_quant", False, False), ("fake_quant", False, True)],
)
def test_execute_matmul_matches_jax(mode, noisy, ste):
    kw = dict(mode=mode, a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=ste)
    if noisy:
        kw.update(comparator_sigma=0.02, ref_mismatch_sigma=0.01)
    fj, ft = _fabrics(mode="hybrid", n_arrays=12)
    x, w = _operands(3, 40, 64, 3)
    key = KEY if noisy else None
    y_j, s_j = jfab.execute_matmul(jnp.asarray(x), jnp.asarray(w), fj, jcl.CiMConfig(**kw), key=key,
                                   return_stats=True, use_kernel=False)
    y_t, s_t = tfab.execute_matmul(_t(x), _t(w), ft, tcl.CiMConfig(**kw), key=key, return_stats=True)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert (int(s_t.conversions), int(s_t.comparisons)) == (int(s_j.conversions), int(s_j.comparisons))
    # and the unmapped op, bit for bit (the noisy mapped run draws per-tile keys)
    if not noisy:
        y_op = tcl.cim_matmul(_t(x), _t(w), tcl.CiMConfig(**kw))
        np.testing.assert_array_equal(y_t.numpy(), y_op.numpy())
    if mode == "fake_quant":  # the full-width path, without a call per tile
        y_nk = tfab.execute_matmul(_t(x), _t(w), ft, tcl.CiMConfig(**kw), use_kernel=False)
        np.testing.assert_array_equal(y_nk.numpy(), y_t.numpy())
    # leading dimensions are flattened and restored
    y_b = tfab.execute_matmul(_t(x).reshape(3, 1, 40), _t(w), ft, tcl.CiMConfig(**kw), key=key)
    assert tuple(y_b.shape) == (3, 1, 64)
    np.testing.assert_array_equal(y_b.reshape(3, 64).numpy(), y_t.numpy())


def test_execute_matmul_fake_quant_per_tile_matches_jax_kernel_path():
    """``use_kernel`` (one op call per 32-column tile; the last tile 6 wide)
    against the JAX package's Pallas kernel per tile, interpret mode, eager."""
    fj, ft = _fabrics(mode="hybrid", n_arrays=12)
    x, w = _operands(3, 40, 70, 4)
    cim = dict(mode="fake_quant", a_bits=8, w_bits=8, adc_bits=5, rows=16, ste=False)
    with jax.disable_jit():
        y_j = jfab.execute_matmul(jnp.asarray(x), jnp.asarray(w), fj, jcl.CiMConfig(**cim))
    y_t = tfab.execute_matmul(_t(x), _t(w), ft, tcl.CiMConfig(**cim))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(
        tfab.execute_linear(_t(x), _t(w), _t(np.ones(70, np.float32)), ft, tcl.CiMConfig(**cim)).numpy(),
        y_t.numpy() + 1.0,
    )
    with pytest.raises(ValueError, match="bitplane\\|fake_quant"):
        tfab.execute_matmul(_t(x), _t(w), ft, tcl.CiMConfig(mode="exact"))
    with pytest.raises(ValueError, match="placement"):
        tfab.execute_matmul(_t(x), _t(w), ft, tcl.CiMConfig(**cim), placement=tfab.map_matmul("l", 3, 40, 64, ft))


# ---------------------------------------------------------------------------
# serve --fabric on one chip
# ---------------------------------------------------------------------------


def test_serve_validation_matmul_equals_jax_sharded_matmul_on_one_chip():
    fj, ft = _fabrics(mode="hybrid", n_arrays=60)
    cm = jfab.ChipMeshConfig(fabric=fj)
    cim = jcl.CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=fj.adc_bits, rows=fj.rows, ste=False)
    skey = jax.random.PRNGKey(0)
    x_s = jax.random.normal(skey, (2, fj.rows))
    w_s = jax.random.normal(jax.random.fold_in(skey, 1), (fj.rows, fj.cols))
    sp = jfab.shard_placement(jfab.map_matmul("smoke", 2, fj.rows, fj.cols, fj), cm)
    assert jfab.resolve_backend(sp, "auto") == "sequential"
    want = jfab.execute_sharded_matmul(x_s, w_s, cm, cim, sharded=sp, backend="sequential")
    np.testing.assert_array_equal(tserve.validation_matmul(ft, device="cpu").numpy(), np.asarray(want))


def test_serve_batch_fabric_rollup_matches_jax(capsys):
    from repro.configs.base import reduced as j_reduced
    from repro.launch import serve as jserve
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics as tmetrics

    fj, ft = _fabrics(mode="hybrid", n_arrays=60)
    cfg_j, cfg_t = j_reduced(j_get_config("smollm-135m")), t_reduced(t_get_config("smollm-135m"))
    st_j, st_t = jserve.ServeSettings(batch=2, prompt_len=8, gen_len=3), tserve.ServeSettings(batch=2, prompt_len=8, gen_len=3)
    rollup_j = jfab.fabric_report(jfab.map_model(cfg_j, fj, tokens=2), fj)
    rollup_j["exec_backend"] = "sequential"
    rollup_t = tserve.fabric_rollup(cfg_t, ft, 2, device="cpu")
    assert rollup_t == rollup_j
    fab_j = jserve.serve_batch(cfg_j, st_j, fabric_rollup=rollup_j)["fabric"]
    lines_j = capsys.readouterr().out.splitlines()
    fab_t = tserve.serve_batch(cfg_t, st_t, device="cpu", fabric_rollup=rollup_t)["fabric"]
    lines_t = capsys.readouterr().out.splitlines()
    assert fab_t == fab_j
    assert lines_t[-1] == lines_j[-1] and lines_t[-1].startswith("[serve] batch 2x11 tok on 1 chip(s) [sequential]")
    # with metrics collected, the batching line is the observability summary
    with jmetrics.collecting():
        jserve.serve_batch(cfg_j, st_j, fabric_rollup=rollup_j)
    with tmetrics.collecting() as reg:
        tserve.serve_batch(cfg_t, st_t, device="cpu", fabric_rollup=rollup_t)
        assert reg.snapshot()["fabric_ema_bits_total"]
    line_j, line_t = capsys.readouterr().out.splitlines()
    # the JAX package's line: fused/fallback requests, conversions, link bits
    # and gauges (none written here), and the estimate
    assert line_t.startswith("[serve] obs batch 2x11 tok on 1 chip(s) [sequential]: ")
    assert line_t == line_j
    assert line_t.split(" est. ")[1] == line_j.split(" est. ")[1]
    conversions = re.compile(r"(\S+) conversions")
    assert conversions.search(line_t).group(1) == conversions.search(line_j).group(1)


@pytest.mark.parametrize("arch,flags,error", [
    ("smollm-135m", ["--fabric-chips", "4", "--fabric-mesh", "2x2"],
     "pass either --fabric-mesh or the --fabric-chips sugar, not both"),
    ("smollm-135m", ["--fabric-scan"], "--fabric-scan requires --fabric-program"),
    ("mamba2-130m", ["--fabric-program", "--fabric-scan"],
     "--fabric-scan needs a matmul-graph family (dense/moe); mamba2-130m is 'mamba'"),
    ("mamba2-130m", ["--fabric-autotune"],
     "--fabric-autotune needs a matmul-graph family (dense/moe); mamba2-130m is 'mamba'"),
    ("smollm-135m", ["--fabric-mesh", "2x1", "--fabric-program", "--fabric-scan"], None),
    ("smollm-135m", ["--fabric-mesh", "2x1", "--fabric-autotune"], None),
], ids=[f"flags{i}" for i in range(6)])
def test_serve_cli_refuses_what_waits_for_a_mesh(arch, flags, error, monkeypatch, capsys):
    """The CLI refuses what the JAX CLI refuses, with its words and in its
    order (both mesh flags; ``--fabric-scan`` without ``--fabric-program``;
    scan or autotune on a family without a matmul graph); the graph program,
    its scan form and the autotuner now serve (``tests/test_torch_graph.py``,
    ``tests/test_torch_autotune.py``)."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8", "--gen-len", "2",
            "--cim", "fake_quant", "--fabric", "hybrid"] + flags
    if error is None:
        out = tserve.main(argv + ["--device", "cpu"])
        text = capsys.readouterr().out
        if "--fabric-autotune" in flags:
            assert "[serve] autotune: mesh " in text and "maxdiff 0.00e+00 vs per-node reference" in text
        else:
            assert ("[serve] fused graph: scanned 2-block model (15 matmuls, block traced once) on shard_map, "
                    "maxdiff 0.00e+00 vs per-node loop") in text
        assert out["generated"].shape == (2, 2)
        return
    from repro.launch import serve as jserve

    errors = []
    for main in (lambda: tserve.main(argv + ["--device", "cpu"]), lambda: jserve.main()):
        monkeypatch.setattr("sys.argv", ["serve"] + argv)
        with pytest.raises(SystemExit):
            main()
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] == f"serve: error: {error}"


def test_parse_fabric_mesh_and_the_one_chip_backend():
    from repro.launch.serve import parse_fabric_mesh as j_parse

    for spec in ("2x4", "1X1", " 3 x 2 "):
        assert tserve.parse_fabric_mesh(spec) == j_parse(spec)
    for bad in ("2x", "axb", "0x2", "2x2x2"):
        with pytest.raises(ValueError):
            tserve.parse_fabric_mesh(bad)
    y = tserve.validation_matmul(tfab.FabricConfig(mode="pair_sar", n_arrays=8), device="cpu")
    assert tuple(y.shape) == (2, 32) and bool(torch.isfinite(y).all())


def test_serve_cli_with_a_one_chip_fabric(capsys):
    tserve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                 "--gen-len", "2", "--fabric", "flash", "--fabric-arrays", "70", "--fabric-mesh", "1x1"])
    out = capsys.readouterr().out
    assert "[serve] fabric exec backend: sequential (1 cpu device(s) for 1 chip(s))" in out
    assert "[serve] batch 2x10 tok on 1 chip(s) [sequential]" in out
    assert "### fabric: flash — 68 arrays" in out
