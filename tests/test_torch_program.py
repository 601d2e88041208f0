"""PyTorch port vs JAX package: the fused forward over the residual chain
(``fabric.program``), on the CPU.

The same seeded numpy inputs, and weights drawn by both packages' PRNGs
(equal bit for bit), go through the JAX package's jitted ``shard_map``
program and the port's fused program. On 1x1 the two are bit-exact, and
both equal the port's per-layer ``execute_sharded_matmul`` loop, noisy ADC
included; on 1x2 and 2x2 the port is within atol 1e-5, rtol 1e-6 of the JAX
program (the JAX tests' tolerance for fused against loop), and bit-exact
with its own loop. The port's collective census equals the count of
collective primitives in the JAX program's jaxpr. The weights are drawn
once, in a module-scoped fixture, and each JAX program is compiled by the
one case that needs it.
"""

import jax
import numpy as np
import pytest
import torch

from repro import fabric as jfab
from repro.core import cim_linear as jcl
from repro.obs import metrics as jmetrics
from repro_torch import fabric as tfab
from repro_torch.core import cim_linear as tcl
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.obs import metrics as tmetrics

FB = dict(mode="pair_sar", rows=16, cols=32, n_arrays=8)
BP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
FQ = dict(mode="fake_quant", a_bits=8, w_bits=8, adc_bits=5, rows=16, ste=False)
NOISY = dict(BP, comparator_sigma=0.05)
SHAPES = [("l0", 4, 64, 64), ("l1", 4, 64, 96), ("l2", 4, 96, 32)]
CASES = {"bitplane": (BP, None), "noisy": (NOISY, 9), "fake_quant": (FQ, None)}


def _meshes(data=1, model=1):
    fj, ft = jfab.FabricConfig(**FB), tfab.FabricConfig(**FB)
    return jfab.ChipMeshConfig(data=data, model=model, fabric=fj), tfab.ChipMeshConfig(data=data, model=model, fabric=ft)


def _chains(data, model, cim, shapes=SHAPES):
    cj, ct = _meshes(data, model)
    return (
        [jfab.shard_placement(jfab.map_matmul(n, m, k, nn, cj.fabric, cim=jcl.CiMConfig(**cim)), cj) for n, m, k, nn in shapes],
        [tfab.shard_placement(tfab.map_matmul(n, m, k, nn, ct.fabric, cim=tcl.CiMConfig(**cim)), ct) for n, m, k, nn in shapes],
    )


def _programs(data, model, cim, **kw):
    cj, ct = _meshes(data, model)
    sj, st = _chains(data, model, cim)
    return jfab.compile_forward(sj, cj, jcl.CiMConfig(**cim), **kw), tfab.compile_forward(st, ct, tcl.CiMConfig(**cim), **kw)


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """The chain's weights drawn by both packages (``random_weights`` of
    key 1): (JAX arrays, port tensors)."""
    pj, pt = _programs(1, 1, BP)
    return pj.random_weights(jax.random.PRNGKey(1)), pt.random_weights(prng.PRNGKey(1))


def _run(data, model, case, x_np, weights):
    """One fused forward of the 3-layer chain by each package, with stats:
    ((JAX y, JAX stats), (port y, port stats), port program)."""
    cim, seed = CASES[case]
    pj, pt = _programs(data, model, cim)
    assert pj.backend == pt.backend == "shard_map"
    jkey, tkey = (jax.random.PRNGKey(seed), prng.PRNGKey(seed)) if seed is not None else (None, None)
    yj, sj = pj(x_np, weights[0], key=jkey, return_stats=True)
    yt, st = pt(torch.from_numpy(x_np), weights[1], key=tkey, return_stats=True)
    return (np.asarray(yj), sj), (yt, st), pt, tkey


def test_random_weights_and_example_input_equal_jax(weights):
    pj, pt = _programs(1, 1, BP)
    for wj, wt in zip(*weights):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(pt.example_input(prng.PRNGKey(0)).numpy(),
                                  np.asarray(pj.example_input(jax.random.PRNGKey(0))))
    assert pt.weight_shapes == pj.weight_shapes and pt.m == pj.m and pt.n_layers == 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_1x1_is_bit_exact_with_jax_and_the_per_layer_loop(case, x_np, weights):
    (yj, sj), (yt, st), pt, tkey = _run(1, 1, case, x_np, weights)
    np.testing.assert_array_equal(yt.numpy(), yj)
    assert (int(st.conversions), float(st.comparisons)) == (int(sj.conversions), float(sj.comparisons))
    y_loop, s_loop = tfab.per_layer_forward(torch.from_numpy(x_np), weights[1], pt.placements, pt.chip_mesh, pt.cim,
                                            key=tkey, return_stats=True)
    assert torch.equal(yt, y_loop) and torch.equal(st.conversions, s_loop.conversions)


@pytest.mark.parametrize("data,model,case", [(1, 2, "bitplane"), (2, 2, "bitplane"), (2, 2, "noisy"), (2, 2, "fake_quant")])
def test_fused_multichip_matches_jax_and_equals_the_per_layer_loop(data, model, case, x_np, weights):
    (yj, sj), (yt, st), pt, tkey = _run(data, model, case, x_np, weights)
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-6)
    assert (int(st.conversions), float(st.comparisons)) == (int(sj.conversions), float(sj.comparisons))
    # the collectives sum in chip order, as the loop does: equal, not close
    assert torch.equal(yt, pt.reference_forward(torch.from_numpy(x_np), weights[1], key=tkey))


@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (2, 2)])
def test_collective_census_equals_the_jax_jaxpr(data, model):
    """One all_gather and one reduce_scatter per layer on a model axis > 1,
    none on 1x1; a pmax per layer and two psums (the stats) always; no
    ppermute or all_to_all."""
    pj, pt = _programs(data, model, BP)
    counts = pt.collective_counts(device="cpu")
    assert counts == pj.collective_counts()
    assert counts["ppermute"] == counts["all_to_all"] == 0
    assert counts["reduce_scatter"] == (3 if model > 1 else 0) and counts["all_gather"] == (model > 1)


def test_program_eligibility_messages_equal_jax():
    cj, ct = _meshes(2, 2)
    cases = [
        [("a", 4, 64, 64), ("b", 4, 96, 64)],  # chain break
        [("a", 4, 64, 64), ("b", 2, 64, 64)],  # batch mismatch (and a replicated data axis)
        [("r", 4, 40, 64)],  # 3 K-tiles: replication fallback, ragged K
        [("n", 4, 64, 33)],  # N does not divide the model axis
    ]
    for shapes in cases:
        sj, st = _chains(2, 2, BP, shapes)
        probs = tfab.program_eligibility(st, ct)
        assert probs and probs == jfab.program_eligibility(sj, cj)
    assert tfab.program_eligibility([], ct) == ["empty layer chain"]
    assert tfab.program_eligibility(_chains(2, 2, BP)[1], ct) == []
    # a 16-chip mesh is eligible in the port (the JAX package lacks the devices)
    big = tfab.ChipMeshConfig(data=4, model=4, fabric=ct.fabric)
    sp_big = [tfab.shard_placement(tfab.map_matmul("l", 16, 256, 64, ct.fabric), big)]
    assert tfab.program_eligibility(sp_big, big) == []


def test_compile_forward_backends_fallbacks_and_errors(x_np, weights):
    _, ct = _meshes(2, 2)
    st = _chains(2, 2, BP)[1]
    assert tfab.compile_forward(st, ct, tcl.CiMConfig(**BP), backend="sequential").backend == "sequential"
    ragged = _chains(2, 2, BP, [("r", 4, 40, 64)])[1]
    prog = tfab.compile_forward(ragged, ct, tcl.CiMConfig(**BP))
    assert prog.backend == "sequential" and prog.problems
    with pytest.raises(ValueError, match="fused shard_map program unavailable"):
        tfab.compile_forward(ragged, ct, tcl.CiMConfig(**BP), backend="shard_map")
    with pytest.raises(ValueError, match="ste=False"):
        tfab.compile_forward(st, ct, tcl.CiMConfig(mode="bitplane", rows=16, ste=True))
    with pytest.raises(ValueError, match="bitplane|fake_quant"):
        tfab.compile_forward(st, ct, tcl.CiMConfig(mode="exact", ste=False))
    # a fallback request records its reason
    xr = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 40)).astype(np.float32))
    with tmetrics.collecting() as reg:
        prog(xr, prog.random_weights(prng.PRNGKey(2)))
        tfab.compile_forward(st, ct, tcl.CiMConfig(**BP), backend="sequential")(torch.from_numpy(x_np), weights[1])
    fallback = reg.counter("fabric_fallback_total")
    assert fallback.value(reason="replication_fallback") == 1.0 and fallback.value(reason="requested_sequential") == 1.0
    assert reg.counter("fabric_requests_total").value(path="fallback") == 2.0
    # shape checks
    fused = tfab.compile_forward(st, ct, tcl.CiMConfig(**BP))
    with pytest.raises(ValueError, match="weight matrices"):
        fused(torch.from_numpy(x_np), weights[1][:-1])
    with pytest.raises(ValueError, match="expects weights"):
        fused(torch.from_numpy(x_np), list(reversed(weights[1])))
    with pytest.raises(ValueError, match="input features"):
        fused(torch.zeros(4, 32), weights[1])


def test_ragged_and_batched_inputs():
    """Leading dims flatten; a batch the data axis does not divide falls
    back to the sequential loop (auto, recorded) or raises (shard_map)."""
    _, ct = _meshes(2, 2)
    st = _chains(2, 2, BP, [("l0", 8, 64, 64)])[1]
    prog = tfab.compile_forward(st, ct, tcl.CiMConfig(**BP))
    ws = prog.random_weights(prng.PRNGKey(1))
    x = prng.normal(prng.PRNGKey(0), (2, 4, 64))
    y = prog(x, ws)
    assert y.shape == (2, 4, 64) and torch.equal(y, prog.reference_forward(x, ws))
    x5 = prng.normal(prng.PRNGKey(4), (5, 64))
    with tmetrics.collecting() as reg:
        y5 = prog(x5, ws)
    assert reg.counter("fabric_fallback_total").value(reason="ragged_batch") == 1.0
    assert torch.equal(y5, tfab.per_layer_forward(x5, ws, st, ct, prog.cim))
    assert not prog.fused_available(x5)
    strict = tfab.compile_forward(st, ct, tcl.CiMConfig(**BP), backend="shard_map")
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        strict(x5, ws)


def test_measure_forward_keys_and_link_validation_equal_jax(x_np, weights):
    pj, pt = _programs(2, 2, FQ)
    mj = jfab.measure_forward(pj, x=x_np, weights=weights[0], iters=1, per_layer_backend="sequential")
    mt = tfab.measure_forward(pt, x=torch.from_numpy(x_np), weights=weights[1], iters=1,
                              per_layer_backend="sequential", device="cpu")
    assert sorted(mt) == sorted(mj)
    assert mt["backend"] == "shard_map" and mt["n_chips"] == 4 and mt["mesh"] == "2x2"
    assert mt["fused_s"] > 0 and mt["local_s"] > 0 and mt["per_layer_s"] > 0 and mt["measured_collective_s"] >= 0
    for key in ("modeled_link_s", "modeled_serial_latency_s", "modeled_overlapped_latency_s", "modeled_hidden_link_s"):
        assert mt[key] == mj[key]
    for measured in (None, 0.0, 2.5e-4):
        assert tfab.link_validation(pt.placements, measured) == jfab.link_validation(pj.placements, measured)
    v1 = tfab.link_validation(_chains(1, 1, BP)[1], 1e-3)
    assert v1 == jfab.link_validation(_chains(1, 1, BP)[0], 1e-3) and v1["measured_over_modeled"] is None
    # the gauges the serve's obs line reads
    with jmetrics.collecting() as rj, tmetrics.collecting() as rt:
        jfab.link_validation(pj.placements, 2.5e-4)
        tfab.link_validation(pt.placements, 2.5e-4)
    assert rt.snapshot() == rj.snapshot()
    # the report's program section renders as the JAX package renders it
    rep_j = jfab.sharded_fabric_report(pj.placements, pj.chip_mesh, measured=mj)
    rep_t = tfab.sharded_fabric_report(pt.placements, pt.chip_mesh, measured=mj)
    assert "fused program" in tfab.render_markdown(rep_t)
    assert tfab.render_markdown(rep_t) == jfab.render_markdown(rep_j)
    # with a forward graph, the report's graph section equals the JAX package's
    from repro.configs.registry import get_config as j_get_config
    from repro_torch.configs import get_config

    gj = jfab.model_forward_graph(j_get_config("smollm-135m"), 4, block_only=True)
    gt = tfab.model_forward_graph(get_config("smollm-135m"), 4, block_only=True)
    sec_t = tfab.sharded_fabric_report(pt.placements, pt.chip_mesh, graph=gt)["graph"]
    assert sec_t == jfab.sharded_fabric_report(pj.placements, pj.chip_mesh, graph=gj)["graph"]
    assert sec_t["n_matmuls"] == 7 and sec_t["collective_budget"]["reduce_scatter"] == 7


def test_full_smollm_chain_plans_as_the_smoke_runs_it():
    """The chain the card runs (``chip_smoke.py`` ``[program]``): smollm-135m
    at full width, tokens 4, on 1x4: 121 linears, fused."""
    from repro_torch.configs import get_config

    cm = tfab.ChipMeshConfig(model=4, fabric=tfab.FabricConfig(mode="hybrid", n_arrays=256))
    prog = tfab.compile_forward(get_config("smollm-135m"), cm, tcl.CiMConfig(mode="fake_quant", ste=False), tokens=4)
    assert prog.backend == "shard_map" and prog.n_layers == 121 and not prog.problems
    assert [sp.name for sp in prog.placements[:4]] == ["layer0.q_proj", "layer0.o_proj", "layer0.gate_proj",
                                                       "layer0.down_proj"]
    assert prog.placements[-1].name == "unembed"


# ---------------------------------------------------------------------------
# serve --fabric-program
# ---------------------------------------------------------------------------


def test_serve_fabric_program_runs_the_fused_chain_on_mamba(capsys):
    argv = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--gen-len", "3", "--cim", "fake_quant", "--fabric", "hybrid", "--fabric-mesh", "1x2", "--fabric-program"]
    with tmetrics.collecting():
        out = tserve.main(argv)
    text = capsys.readouterr().out
    assert "[serve] fabric exec backend: shard_map (1 cpu device(s) for 2 chip(s))" in text
    assert "[serve] fused chain: 1-layer block on shard_map, maxdiff 0.00e+00 vs per-layer loop" in text
    # the obs batching line reads the fused/fallback requests and the link gauges
    line = next(s for s in text.splitlines() if s.startswith("[serve] obs batch"))
    assert "[shard_map]: fused 1 / fallback 0 requests;" in line and "link_clock_calibration" in line
    assert out["fabric"]["n_chips"] == 2
    assert "**fused program** (1 layers, shard_map)" in text


def test_serve_fabric_program_is_refused_on_a_dense_model(capsys):
    """``--fabric-program`` on a dense model runs the full-block fused graph
    (one block, bit-plane 4/4) against its per-node loop and prints the JAX
    CLI's ``fused graph`` line; the rollup gains the graph section."""
    out = tserve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen-len", "4", "--cim", "fake_quant", "--fabric", "hybrid", "--fabric-mesh", "2x1",
                       "--fabric-backend", "shard_map", "--fabric-program"])
    text = capsys.readouterr().out
    assert ("[serve] fused graph: 13-node block (7 matmuls) on shard_map, maxdiff 0.00e+00 vs per-node loop; "
            "collectives ") in text
    assert "**forward graph:** 13 nodes" in text and "**fused program** (7 layers, shard_map)" in text
    assert out["generated"].shape == (2, 4)
