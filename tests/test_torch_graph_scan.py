"""The PyTorch port's full-block fused graph (``fabric.graph``) against
itself, on the CPU: the fused graph equals its per-node loop with
``torch.equal`` on every mesh (a norm's sum of squares is added chip by
chip in both), noisy ADC included; the scan form (the block's nodes once per layer over ``block.``-stacked weights)
equals the unrolled form on every mesh, with the census of per-block census
x layers + tail; ``real_rows`` masks bucket padding and scales the stats;
and the per-node noise keys are independent (``key_fn``). The port's own
seeded init supplies the weights (``tests/test_torch_graph.py`` holds the
port to the JAX package). Noisy cases run a few tokens: the port's threefry
is their CPU cost.
"""

import numpy as np
import pytest
import torch

from repro_torch import fabric as tfab
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import cim_linear as tcl
from repro_torch.core import prng
from repro_torch.fabric import graph as tgraph
from repro_torch.models import build_model
from repro_torch.obs import trace as ttrace

FB = dict(mode="pair_sar", rows=16, cols=32, n_arrays=8)
BP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
NOISY = dict(BP, comparator_sigma=0.05)
FQ = dict(mode="fake_quant", a_bits=8, w_bits=8, adc_bits=5, rows=16, ste=False)
CIMS = {"bitplane": BP, "noisy": NOISY, "fake_quant": FQ}
SEEDS = {"bitplane": None, "noisy": 7, "fake_quant": None}
DENSE = dict(name="graph-test", family="dense", n_layers=2, d_model=64, vocab=64, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128, pad_vocab_multiple=16, param_dtype="float32", compute_dtype="float32")
MOE = dict(DENSE, name="graph-moe", family="moe", d_ff=0, n_experts=8, top_k=2, d_ff_expert=64)
CFGS = {"dense": DENSE, "moe": MOE}


def _program(family, data, model, cim, n_layers=2, **kw):
    cm = tfab.ChipMeshConfig(data=data, model=model, fabric=tfab.FabricConfig(**FB))
    return tfab.compile_graph_forward(TCfg(**dict(CFGS[family], n_layers=n_layers)), cm, tcl.CiMConfig(**cim),
                                      tokens=8, **kw)


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
def model_weights():
    """The port's seeded init of each toy config at 2 layers: (graph
    weights, params), and the 1-layer graph's share of them."""
    out = {}
    for family, kw in CFGS.items():
        params = build_model(TCfg(**kw), "cpu").init(torch.Generator().manual_seed(0))
        ws = tfab.transformer_graph_weights(params, TCfg(**kw))
        out[family, 2] = (ws, params)
        out[family, 1] = ({k: v for k, v in ws.items() if not k.startswith("layer1.")}, None)
    return out


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(0).standard_normal((2, 4, 64)).astype(np.float32)


def _x_for(case, x_np, data=1):
    """One 2-token sequence per data chip where the noisy ADC runs, else all
    8 tokens."""
    return torch.from_numpy(x_np[:data, :2].copy() if case == "noisy" else x_np)


@pytest.mark.parametrize("family,data,model,case", [
    ("dense", 2, 1, "noisy"), ("moe", 2, 1, "bitplane"), ("moe", 1, 1, "noisy"), ("dense", 2, 2, "noisy"),
    ("moe", 1, 2, "bitplane"), ("dense", 1, 4, "fake_quant"),
])
def test_fused_graph_equals_its_per_node_loop_on_every_mesh(family, data, model, case, model_weights, x_np):
    pt = _program(family, data, model, CIMS[case], n_layers=1)
    wt, _ = model_weights[family, 1]
    tkey = prng.PRNGKey(SEEDS[case]) if SEEDS[case] is not None else None
    x = _x_for(case, x_np, data)
    y, st = pt(x, wt, key=tkey, return_stats=True)
    y_ref, st_ref = pt.reference_forward(x, wt, key=tkey, return_stats=True)
    assert torch.equal(y, y_ref)
    assert torch.equal(st.conversions, st_ref.conversions) and torch.equal(st.comparisons, st_ref.comparisons)
    assert bool(torch.isfinite(y).all()) and tuple(y.shape) == (*x.shape[:2], 64)


@pytest.mark.parametrize("family,data,model,case", [
    ("dense", 1, 1, "noisy"), ("moe", 1, 1, "bitplane"), ("dense", 2, 2, "bitplane"), ("moe", 1, 2, "fake_quant"),
])
def test_scan_form_equals_the_unrolled_form(family, data, model, case, model_weights, x_np):
    """The scan form (``block.``-stacked weights from ``stack_block_weights``)
    gives the unrolled program's tensor with ``torch.equal``, noisy ADC
    included, on every mesh; its census (noiseless cases) is the per-block
    census times the layers plus the tail, which is the unrolled budget."""
    unrolled = _program(family, data, model, CIMS[case])
    scanned = _program(family, data, model, CIMS[case], scan_layers=True)
    wt, params = model_weights[family, 2]
    stacked = tfab.stack_block_weights(params, TCfg(**dict(CFGS[family], n_layers=2)))
    tkey = prng.PRNGKey(SEEDS[case]) if SEEDS[case] is not None else None
    x = _x_for(case, x_np)
    y_scan, st_scan = scanned(x, stacked, key=tkey, return_stats=True)
    y_unroll, st_unroll = unrolled(x, wt, key=tkey, return_stats=True)
    assert torch.equal(y_scan, y_unroll)
    assert torch.equal(st_scan.conversions, st_unroll.conversions)
    assert torch.equal(st_scan.comparisons, st_unroll.comparisons)
    if case != "noisy":  # the census runs a forward
        counts = scanned.collective_counts(x=x, weights=stacked)
        per_block = scanned.block_graph.block_census(model)
        tail = scanned.tail_graph.collective_budget(model)
        assert counts == unrolled.collective_budget()
        assert counts == {k: per_block[k] * scanned.n_blocks + tail[k] for k in counts}
    # the reference loop takes the stacked dict too
    assert torch.equal(scanned.reference_forward(x, stacked, key=tkey), y_scan)


def test_real_rows_masks_pad_rows_and_scales_the_stats(model_weights):
    """``real_rows``: the padded fused run equals the unpadded one on the real
    rows (a 2x1 mesh, noisy ADC), the stats are the real rows' share, and the
    span counts the real tokens only."""
    pt = _program("dense", 2, 1, NOISY, n_layers=1)
    wt, _ = model_weights["dense", 1]
    key = prng.PRNGKey(5)
    x = prng.normal(prng.PRNGKey(4), (4, 1, 64))
    x[2:] = 0.0
    with ttrace.tracing() as tr:
        y_pad, st_pad = pt(x, wt, key=key, return_stats=True, real_rows=2)
    y2, st2 = pt(x[:2], wt, key=key, return_stats=True)
    assert torch.equal(y_pad, y2) and tuple(y_pad.shape) == (2, 1, 64)
    assert int(st_pad.conversions) == int(st2.conversions)
    (span,) = [s for s in tr.spans if s["name"] == "fabric.graph.forward"]
    assert span["attrs"]["tokens"] == 2
    with pytest.raises(ValueError, match="real_rows=5 outside"):
        pt(x, wt, real_rows=5)


def test_noise_keys_are_independent_via_key_fn(model_weights, x_np, monkeypatch):
    """k_proj and v_proj have equal shapes; with equal weights and one input
    their noisy outputs differ (node keys 1 and 2), while a ``key_fn`` that
    hands both the same key makes them equal; and reusing layer 0's keys in
    layer 1 changes the logits (the global matmul index keys every layer),
    so a scan that reused layer keys would diverge from the unrolled
    program."""
    pt = _program("dense", 1, 1, NOISY, n_layers=1)
    ws = dict(model_weights["dense", 1][0])
    ws["layer0.v_proj"] = ws["layer0.k_proj"]
    x = torch.from_numpy(x_np[:1, :2].copy())
    key = prng.PRNGKey(11)
    real = tgraph.execute_sharded_matmul

    def outputs(**kw):
        got = []

        def record(*args, **kwargs):
            got.append(real(*args, **kwargs))
            return got[-1]
        monkeypatch.setattr(tgraph, "execute_sharded_matmul", record)
        tfab.per_node_forward(x, ws, pt.graph, pt.placements, pt.chip_mesh, pt.cim, key=key, **kw)
        return got

    own = outputs()
    assert not torch.equal(own[1], own[2])  # k_proj vs v_proj
    shared = outputs(key_fn=lambda k, i: prng.fold_in(k, 1 if i in (1, 2) else i))
    assert torch.equal(shared[1], shared[2]) and torch.equal(shared[1], own[1])
    monkeypatch.setattr(tgraph, "execute_sharded_matmul", real)
    two = _program("dense", 1, 1, NOISY)
    wt = model_weights["dense", 2][0]
    per_block = len(tfab.model_block_template(TCfg(**DENSE), 8)[0].matmul_nodes)
    reuse = lambda k, i: prng.fold_in(k, i % per_block if i < 2 * per_block else i)  # noqa: E731
    y_reuse = tfab.per_node_forward(x, wt, two.graph, two.placements, two.chip_mesh, two.cim, key=key, key_fn=reuse)
    assert not torch.equal(y_reuse, two(x, wt, key=key))
