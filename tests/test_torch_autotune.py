"""PyTorch port vs JAX package: continuous batching for the fused graph
(``fabric.autotune``), on the CPU.

The request histogram, the bucket validation, the LRU's keying and eviction,
the autotuner's plans and report section must equal the JAX package's (on
at most 8 chips, which ``tests/conftest.py``'s 8 host devices can build); the
hit, miss and pad-waste counters and the metric registry after a bucketed
and a too-large batch equal the JAX package's on a 1x1 mesh (jax 0.9.0
cannot slice a padded batch off a data-sharded output, ROADMAP C). A ragged
batch padded into a bucket equals the unpadded per-node reference bit for
bit on every mesh (the claim of ``tests/test_fabric_autotune.py`` at its
2x2 shape and ``init_transformer`` weights, and every batch 1..8 here),
noisy ADC included.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import fabric as jfab
from repro.configs.base import ModelConfig as JCfg
from repro.core import cim_linear as jcl
from repro.models.transformer import init_transformer
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import fabric as tfab
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import cim_linear as tcl
from repro_torch.core import prng
from repro_torch.fabric.tiles import column_tile_matmul
from repro_torch.models.weights import params_from_jax
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

FB = dict(mode="pair_sar", rows=16, cols=32, n_arrays=8)
BP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
NOISY = dict(BP, comparator_sigma=0.05)
FQ = dict(mode="fake_quant", a_bits=8, w_bits=8, adc_bits=5, rows=16, ste=False)
# the JAX autotune tests' config: graph-eligible on 2x2
CFG = dict(name="autotune-test", family="dense", n_layers=1, d_model=64, vocab=64, n_heads=4, n_kv_heads=2,
           head_dim=16, d_ff=128, pad_vocab_multiple=16, param_dtype="float32", compute_dtype="float32")
SEQ = 4


def _mesh(pkg, data=1, model=1):
    return pkg.ChipMeshConfig(data=data, model=model, fabric=pkg.FabricConfig(**FB))


def _caches(data, model, cim, buckets, **kw):
    return (jfab.BucketedGraphCache(JCfg(**CFG), _mesh(jfab, data, model), jcl.CiMConfig(**cim), buckets, seq=SEQ, **kw),
            tfab.BucketedGraphCache(TCfg(**CFG), _mesh(tfab, data, model), tcl.CiMConfig(**cim), buckets, seq=SEQ, **kw))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the suite
    runs files side by side in worker processes that would otherwise contend
    for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX autotune tests' weights (``init_transformer`` of key 0), as
    (JAX graph weights, port graph weights via ``params_from_jax``)."""
    pj = init_transformer(jax.random.PRNGKey(0), JCfg(**CFG))
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), TCfg(**CFG), device="cpu")
    return jfab.transformer_graph_weights(pj, JCfg(**CFG)), tfab.transformer_graph_weights(pt, TCfg(**CFG))


def _x(b: int, seed: int = 0) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), (b, SEQ, 64))``, bit for bit."""
    return prng.normal(prng.PRNGKey(seed), (b, SEQ, 64))


def test_request_histogram_equals_jax():
    for batches in ([3, 1, 3, 4], range(1, 9), [2]):
        assert tfab.request_histogram(batches) == jfab.request_histogram(batches)
    assert tfab.request_histogram([3, 1, 3, 4]) == {1: 1, 3: 2, 4: 1}
    for pkg in (jfab, tfab):
        with pytest.raises(ValueError, match="request batch sizes must be >= 1, got 0"):
            pkg.request_histogram([2, 0])


def test_bucket_boundaries_validate_as_jax():
    errors = []
    for pkg, cfg, cim in ((jfab, JCfg(**CFG), jcl.CiMConfig(**BP)), (tfab, TCfg(**CFG), tcl.CiMConfig(**BP))):
        msgs = []
        for buckets, kw in (((3,), {}), ((), {}), ((2,), {"capacity": 0})):
            with pytest.raises(ValueError) as e:
                pkg.BucketedGraphCache(cfg, _mesh(pkg, 2, 2), cim, buckets=buckets, seq=SEQ, **kw)
            msgs.append(str(e.value))
        errors.append(msgs)
    assert errors[1] == errors[0]
    cj, ct = _caches(2, 2, BP, (4, 2, 4))
    assert ct.buckets == cj.buckets == (2, 4)
    assert [ct.bucket_for(b) for b in range(1, 6)] == [cj.bucket_for(b) for b in range(1, 6)] == [2, 2, 4, 4, None]


def test_lru_keying_and_eviction_equal_jax():
    """The same touches on both caches (capacity 2): equal stats after each,
    a resident program returned as the same object, an evicted one rebuilt,
    and the noisy ADC keyed apart."""
    cj, ct = _caches(2, 2, BP, (2, 4, 6), capacity=2)
    first = {}
    for pb, noisy in ((2, False), (4, False), (2, False), (4, False), (6, False), (4, False), (2, False), (2, True)):
        prog = ct.program_for(pb, noisy=noisy)
        cj.program_for(pb, noisy=noisy)
        assert ct.stats() == cj.stats()
        first.setdefault((pb, noisy), prog)
    # resident at the end: bucket 2 (rebuilt after 6 evicted it) and 2-noisy
    assert ct.stats()["compiles"] == 5 and ct.stats()["evictions"] == 3
    assert ct.program_for(2, noisy=True) is first[2, True]
    assert ct.program_for(2) is not first[2, False]
    assert ct.program_for(4) is not first[4, False]  # evicted by 2-noisy, rebuilt
    assert ct.program_for(4).m == 4 * SEQ and ct.program_for(4).backend == "shard_map"


@pytest.mark.parametrize("noisy", [False, True])
def test_ragged_bucket_equals_the_unpadded_reference_where_jax_claims_it(noisy, weights):
    """B=3 on the 2x2 mesh, padded to the 4-bucket, fused, sliced: equal to
    the unpadded per-node reference bit for bit, the claim and the inputs of
    ``tests/test_fabric_autotune.py`` (its noisy case's key 7, on the first
    token of each sequence: the port's threefry is the CPU cost)."""
    cim, key = (NOISY, prng.PRNGKey(7)) if noisy else (BP, None)
    _, cache = _caches(2, 2, cim, (4,))
    prog = cache.program_for(4, noisy=noisy)
    assert prog.backend == "shard_map"
    x = _x(3)[:, :1].contiguous() if noisy else _x(3)
    y = cache(x, weights[1], key=key)
    assert torch.equal(y, prog.reference_forward(x, weights[1], key=key))
    assert tuple(y.shape) == (3, x.shape[1], 64) and cache.stats()["pad_waste_rows"] == 1


@pytest.mark.parametrize("data,model", [(2, 1), (4, 1), (2, 2), (1, 2)])
def test_every_ragged_batch_against_the_reference(data, model, weights):
    """Batches 1..8 through buckets (data, 2 data, 8) in ``fake_quant``:
    ``torch.equal`` to the unpadded per-node reference."""
    _, cache = _caches(data, model, FQ, (data, 2 * data, 8))
    for b in range(1, 9):
        x = _x(b, seed=b)
        y = cache(x, weights[1])
        y_ref = cache.program_for(cache.bucket_for(b)).reference_forward(x, weights[1])
        assert torch.equal(y, y_ref), b
    assert cache.stats()["hits"] == 8 and cache.stats()["misses"] == 0
    assert cache.stats()["pad_waste_rows"] == sum(cache.bucket_for(b) - b for b in range(1, 9))


def test_pad_rows_do_not_shift_noise_draws():
    """A row's comparator draws derive from its GLOBAL row id, so truncating
    the batch or slicing it at an offset re-deals no surviving row's draws,
    while another key changes them."""
    key = prng.PRNGKey(5)
    x_int, _ = tcl.quantize_symmetric(prng.normal(prng.PRNGKey(1), (6, 32)), 4, True)
    w_int, _ = tcl.quantize_symmetric(prng.normal(prng.PRNGKey(2), (32, 24)), 4, True, per_axis=-1)
    cim = tcl.CiMConfig(**NOISY)
    y6, _ = column_tile_matmul(x_int, w_int, cim, cols=8, key=key)
    y4, _ = column_tile_matmul(x_int[:4], w_int, cim, cols=8, key=key)
    assert torch.equal(y6[:4], y4)
    y_off, _ = column_tile_matmul(x_int[2:], w_int, cim, cols=8, key=key, row_offset=2)
    assert torch.equal(y6[2:], y_off)
    y_other, _ = column_tile_matmul(x_int, w_int, cim, cols=8, key=prng.PRNGKey(99))
    assert not torch.equal(y6, y_other)


def test_padded_stats_and_obs_totals_are_the_real_rows(weights):
    """B=2 padded 2 -> 4 on 2x2 equals the unpadded fused run, stats
    included; a padded 3 -> 4 request's conversion and link-bit totals are
    3/4 of an aligned 4-row request's, and its span counts 3 rows' tokens."""
    _, cache = _caches(2, 2, BP, (4,))
    prog = cache.program_for(4)
    y_pad, st_pad = cache(_x(2), weights[1], return_stats=True)
    y_ref, st_ref = prog(_x(2), weights[1], return_stats=True)
    assert torch.equal(y_pad, y_ref)
    assert int(st_pad.conversions) == int(st_ref.conversions) and float(st_pad.comparisons) == float(st_ref.comparisons)
    with ttrace.tracing() as tr, tmetrics.collecting() as reg:
        cache(_x(3), weights[1])
        conv_pad, link_pad = reg.counter("fabric_conversions_total").value(), reg.counter("fabric_link_bits_total").value()
    (span,) = [s for s in tr.spans if s["name"] == "fabric.graph.forward"]
    assert span["attrs"]["tokens"] == 3 * SEQ
    with tmetrics.collecting() as reg:
        cache(_x(4), weights[1])
        conv_4, link_4 = reg.counter("fabric_conversions_total").value(), reg.counter("fabric_link_bits_total").value()
    assert conv_pad > 0 and link_pad > 0 and conv_pad * 4 == conv_4 * 3 and link_pad * 4 == link_4 * 3


def test_hit_miss_and_pad_waste_counters_equal_jax(weights):
    """A ragged batch in a bucket is a hit (no ``ragged_batch`` fallback); a
    batch larger than every bucket a miss with the ``no_bucket`` record,
    served by the per-node loop. The registries, the fallback events and
    the cache stats equal the JAX package's (1x1, ``fake_quant``)."""
    cj, ct = _caches(1, 1, FQ, (4,))
    x3, x6 = _x(3), _x(6, seed=1)
    with jtrace.tracing() as trj, jmetrics.collecting() as rj:
        yj3 = np.asarray(cj(x3.numpy(), weights[0]))
        yj6 = np.asarray(cj(x6.numpy(), weights[0]))
    with ttrace.tracing() as trt, tmetrics.collecting() as rt:
        yt3 = ct(x3, weights[1])
        yt6 = ct(x6, weights[1])
    assert rt.snapshot() == rj.snapshot()
    assert rt.counter("fabric_bucket_hits_total").value() == 1.0
    assert rt.counter("fabric_bucket_misses_total").value() == 1.0
    assert rt.counter("fabric_pad_waste_rows_total").value() == 1.0
    assert rt.counter("fabric_fallback_total").value(reason="no_bucket") == 1.0
    assert rt.counter("fabric_fallback_total").value(reason="ragged_batch") == 0.0
    events = [e["attrs"] for e in trt.events if e["name"] == "fabric.fallback"]
    assert events == [e["attrs"] for e in trj.events if e["name"] == "fabric.fallback"]
    assert "exceeds largest bucket 4" in events[0]["detail"]
    assert ct.stats() == cj.stats()
    for yt, yj in ((yt3, yj3), (yt6, yj6)):
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-6 * np.abs(yj).max())
    assert torch.equal(yt6, ct.program_for(4).reference_forward(x6, weights[1]))


@pytest.mark.parametrize("n_chips,hist,default", [
    (8, {1: 2, 3: 1}, (1, 8)), (4, {3: 2, 1: 1, 2: 1}, (2, 2)), (4, {2: 1}, None), (2, {1: 5, 3: 10}, None),
    (8, {b: 1 for b in range(1, 9)}, None),
])
def test_autotune_plan_and_section_equal_jax(n_chips, hist, default, weights):
    """Plans on at most 8 chips, where the JAX package's device-count
    condition holds, equal the port's field for field — infeasible meshes
    (GQA heads, ``n_kv_heads % model``) rejected alike — and so does the
    report section, with a cache's stats."""
    for cim in (BP, FQ):
        pj = jfab.autotune_plan(JCfg(**CFG), hist, n_chips, jfab.FabricConfig(**FB), seq=SEQ,
                                cim=jcl.CiMConfig(**cim), default_mesh=default)
        pt = tfab.autotune_plan(TCfg(**CFG), hist, n_chips, tfab.FabricConfig(**FB), seq=SEQ,
                                cim=tcl.CiMConfig(**cim), default_mesh=default)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        assert (pt.mesh, pt.speedup_vs_baseline) == (pj.mesh, pj.speedup_vs_baseline)
        assert pt.expected_latency_s <= pt.baseline_latency_s and CFG["n_kv_heads"] % pt.model == 0
        assert tfab.autotune_section(pt) == jfab.autotune_section(pj)
    cj = jfab.BucketedGraphCache(JCfg(**CFG), _mesh(jfab, pj.data, pj.model), jcl.CiMConfig(**FQ), pj.buckets, seq=SEQ)
    ct = tfab.BucketedGraphCache(TCfg(**CFG), _mesh(tfab, pt.data, pt.model), tcl.CiMConfig(**FQ), pt.buckets, seq=SEQ)
    cj.program_for(pj.buckets[-1])
    ct.program_for(pt.buckets[-1])
    assert tfab.autotune_section(pt, ct) == jfab.autotune_section(pj, cj)
    assert tfab.render_markdown({**tfab.fabric_report([], tfab.FabricConfig(**FB)),
                                 "autotune": tfab.autotune_section(pt, ct)}).count("autotune") >= 1


def test_autotune_plans_meshes_the_host_cannot_hold():
    """The port has no device-count condition (every chip runs on the one
    device), so 16 chips plan where the JAX package, on 8 host devices,
    finds no feasible mesh; the plan is the cheapest eligible one."""
    plan = tfab.autotune_plan(TCfg(**CFG), {2: 1}, 16, tfab.FabricConfig(**FB), seq=SEQ, cim=tcl.CiMConfig(**BP))
    assert plan.data * plan.model == 16 and CFG["n_kv_heads"] % plan.model == 0
    cm = _mesh(tfab, plan.data, plan.model)
    assert tfab.graph_eligibility(*tfab.shard_forward_graph(TCfg(**CFG), cm, tokens=plan.data * SEQ), cm) == []
    with pytest.raises(ValueError, match="non-empty request histogram"):
        tfab.autotune_plan(TCfg(**CFG), {}, 4, tfab.FabricConfig(**FB))
    # K = 40 is not a whole number of 16-row tiles on any mesh
    with pytest.raises(ValueError, match="no feasible"):
        tfab.autotune_plan(dataclasses.replace(TCfg(**CFG), d_model=40, head_dim=10), {2: 1}, 4,
                           tfab.FabricConfig(**FB), seq=SEQ)


def test_smollm_plan_on_three_chips_as_the_smoke_runs_it():
    """``chip_smoke.py`` ``[autotune]``: smollm-135m on 3 chips, request
    batches 1..8 (``fake_quant``). The plan is host arithmetic; the card's
    run holds its dict to ``chip_smoke.SMOLLM_PLAN_3``, the JAX package's
    plan (which takes the JAX package ~26 s to map here, so this test holds
    the port to the recorded dict)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    fb = tfab.FabricConfig(mode="hybrid", n_arrays=256)
    hist = tfab.request_histogram(range(1, 9))
    plan = tfab.autotune_plan(t_get_config("smollm-135m"), hist, 3, fb, cim=tcl.CiMConfig(mode="fake_quant", ste=False))
    assert dataclasses.asdict(plan) == chip_smoke.SMOLLM_PLAN_3
