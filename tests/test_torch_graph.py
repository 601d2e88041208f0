"""PyTorch port vs JAX package: the full-transformer-block fused graph
(``fabric.graph``, the mapper's forward graph, ``report.graph_section``), on
the CPU.

Plans, budgets, report sections, eligibility messages and the weights both
packages draw must be equal. The CiM arithmetic is held exactly where its
inputs are the same; the graph's mixing ops are not: torch's ``exp``,
``rsqrt`` and ``sigmoid`` differ from XLA's by a few ulp on a share of their
inputs, and a norm's one-ulp change moves every activation scale after it.
So the port's logits are held to the JAX ``GraphProgram``'s within a
tolerance measured here (the largest difference seen on these inputs was
1.9e-7 of max|logit|; each test allows 1e-6 of it), and the quantization
codes at every matmul boundary are counted against the JAX package's,
so that a real fault cannot hide in the tolerance. Against itself the port
is exact: the fused graph equals its per-node loop with ``torch.equal`` on
every mesh, noisy ADC included, and the scan form equals the unrolled form
(``tests/test_torch_graph_scan.py``).

Model weights cross from ``init_transformer`` by ``params_from_jax``; every
JAX program is the jitted ``GraphProgram`` (its per-node loop runs eagerly
and only in ``fake_quant``, where it is fast). ``tests/conftest.py`` forces 8
host devices.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import fabric as jfab
from repro.configs.base import ModelConfig as JCfg
from repro.configs.registry import get_config as j_get_config
from repro.core import cim_linear as jcl
from repro.fabric import graph as jgraph
from repro.models.transformer import init_transformer
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import fabric as tfab
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import cim_linear as tcl
from repro_torch.core import prng
from repro_torch.fabric import graph as tgraph
from repro_torch.models.weights import params_from_jax
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

FB = dict(mode="pair_sar", rows=16, cols=32, n_arrays=8)
BP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
NOISY = dict(BP, comparator_sigma=0.05)
FQ = dict(mode="fake_quant", a_bits=8, w_bits=8, adc_bits=5, rows=16, ste=False)
CIMS = {"bitplane": BP, "noisy": NOISY, "fake_quant": FQ}
SEEDS = {"bitplane": None, "noisy": 7, "fake_quant": None}
# graph-eligible on 2x2: every K tile-aligns (64/128 % (2*16) == 0) and the
# q/kv heads (4/2) divide the model axis
DENSE = dict(name="graph-test", family="dense", n_layers=1, d_model=64, vocab=64, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128, pad_vocab_multiple=16, param_dtype="float32", compute_dtype="float32")
MOE = dict(DENSE, name="graph-moe", family="moe", d_ff=0, n_experts=8, top_k=2, d_ff_expert=64)
CFGS = {"dense": DENSE, "moe": MOE}
# the port's logits against the JAX program's: libm-level differences only
LOGIT_RTOL = 1e-6  # of max|logit|; measured <= 1.9e-7 on these inputs


def _meshes(data=1, model=1):
    fj, ft = jfab.FabricConfig(**FB), tfab.FabricConfig(**FB)
    return jfab.ChipMeshConfig(data=data, model=model, fabric=fj), tfab.ChipMeshConfig(data=data, model=model, fabric=ft)


def _programs(family, data, model, cim, n_layers=1, **kw):
    cj, ct = _meshes(data, model)
    cfg = dict(CFGS[family], n_layers=n_layers)
    return (jfab.compile_graph_forward(JCfg(**cfg), cj, jcl.CiMConfig(**cim), tokens=8, **kw),
            tfab.compile_graph_forward(TCfg(**cfg), ct, tcl.CiMConfig(**cim), tokens=8, **kw))


def numpy_params(cfg: dict, seed: int = 0) -> dict:
    """A parameter tree of ``init_transformer``'s structure, shapes and
    dtypes, drawn from a seeded numpy generator: normal weights scaled by
    1/sqrt(fan-in), norm scales 0.1 * normal."""
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in sorted(tree.items())}
        scale = 0.1 if name.startswith("ln") else tree.shape[-2] ** -0.5
        return (scale * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return draw(jax.eval_shape(lambda: init_transformer(jax.random.PRNGKey(0), JCfg(**cfg))))


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
    """Numpy-seeded weights of each toy config at 2 layers (``numpy_params``)
    as (JAX graph weights, port graph weights via ``params_from_jax``, port
    params, JAX params), and the 1-layer graph's share of them."""
    out = {}
    for family, kw in CFGS.items():
        cfg = dict(kw, n_layers=2)
        pn = numpy_params(cfg)
        pj = jax.tree_util.tree_map(jax.numpy.asarray, pn)
        pt = params_from_jax(pn, TCfg(**cfg), device="cpu")
        wj, wt = jfab.transformer_graph_weights(pj, JCfg(**cfg)), tfab.transformer_graph_weights(pt, TCfg(**cfg))
        out[family, 2] = (wj, wt, pt, pj)
        # the 1-layer graph's weights: layer 0 and the tail of the same init
        out[family, 1] = tuple({k: v for k, v in w.items() if not k.startswith("layer1.")} for w in (wj, wt)) + (None, None)
    return out


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(0).standard_normal((2, 4, 64)).astype(np.float32)


def _x_for(case, x_np, data=1):
    """The input of a port-only case: one 2-token sequence per data chip where
    the noisy ADC runs (the port's threefry is the CPU cost there), else all
    8 tokens."""
    return torch.from_numpy(x_np[:data, :2].copy() if case == "noisy" else x_np)


def _asdict(graph):
    return [dataclasses.asdict(nd) for nd in graph.nodes], graph.m, graph.d_in, graph.output


# ---------------------------------------------------------------------------
# plans: taxonomy, budget, report section, eligibility
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,block_only", [("smollm-135m", True), ("smollm-135m", False),
                                             ("qwen3-moe-30b-a3b", False), ("toy-moe", False)])
def test_graph_budget_and_section_equal_jax(arch, block_only):
    if arch == "toy-moe":
        cj, ct = JCfg(**MOE), TCfg(**MOE)
    else:
        cj, ct = j_get_config(arch), t_get_config(arch)
    gj = jfab.model_forward_graph(cj, 4, block_only=block_only)
    gt = tfab.model_forward_graph(ct, 4, block_only=block_only)
    assert _asdict(gt) == _asdict(gj)
    assert gt.matmuls() == gj.matmuls() and gt.sibling_names() == gj.sibling_names()
    assert [nd.name for nd in gt.weighted_nodes()] == [nd.name for nd in gj.weighted_nodes()]
    for c in (1, 2, 3):
        assert gt.collective_budget(c) == gj.collective_budget(c)
        assert gt.block_census(c) == gj.block_census(c)
        assert tfab.graph_section(gt, c) == jfab.graph_section(gj, c)
    if not block_only:
        (bj, tj), (bt, tt) = jfab.model_block_template(cj, 4), tfab.model_block_template(ct, 4)
        assert _asdict(bt) == _asdict(bj) and _asdict(tt) == _asdict(tj)
    with pytest.raises(ValueError, match="dense\\|moe"):
        tfab.model_forward_graph(t_get_config("mamba2-130m"), 4)


def test_graph_report_and_scan_section_equal_jax():
    """``sharded_fabric_report(graph=, program=)``: the graph section (with
    the scan subsection of a scanned program), the sibling-inclusive totals
    and the markdown equal the JAX package's."""
    cj, ct = _meshes(1, 2)
    prog_j = jfab.compile_graph_forward(JCfg(**dict(DENSE, n_layers=2)), cj, jcl.CiMConfig(**BP), tokens=8,
                                        scan_layers=True)
    prog_t = tfab.compile_graph_forward(TCfg(**dict(DENSE, n_layers=2)), ct, tcl.CiMConfig(**BP), tokens=8,
                                        scan_layers=True)
    rep_j = jfab.sharded_fabric_report(prog_j.placements, cj, graph=prog_j.graph, program=prog_j)
    rep_t = tfab.sharded_fabric_report(prog_t.placements, ct, graph=prog_t.graph, program=prog_t)
    assert rep_t == rep_j
    assert rep_t["graph"]["scan"] == {"n_blocks": 2, "block_census": prog_t.block_graph.block_census(2),
                                      "tail_budget": prog_t.tail_graph.collective_budget(2)}
    assert tfab.render_markdown(rep_t) == jfab.render_markdown(rep_j)
    assert "**forward graph:**" in tfab.render_markdown(rep_t)


def test_graph_eligibility_messages_equal_jax():
    """Word for word, on meshes the 8 host devices can build. The JAX
    package also reports a mesh with more chips than host devices; the port
    runs every chip on one device and has no such condition (a 4x4 mesh is
    eligible here)."""
    smollm_j, smollm_t = j_get_config("smollm-135m"), t_get_config("smollm-135m")
    for data, model, cfg_j, cfg_t in [(2, 2, smollm_j, smollm_t), (1, 4, JCfg(**DENSE), TCfg(**DENSE)),
                                      (1, 2, JCfg(**DENSE), TCfg(**DENSE)), (2, 4, JCfg(**DENSE), TCfg(**DENSE))]:
        cj, ct = _meshes(data, model)
        gj, sj = jfab.shard_forward_graph(cfg_j, cj, tokens=8, block_only=True)
        gt, st = tfab.shard_forward_graph(cfg_t, ct, tokens=8, block_only=True)
        assert tfab.graph_eligibility(gt, st, ct) == jfab.graph_eligibility(gj, sj, cj)
    cm = _meshes(2, 2)[1]
    probs = tfab.graph_eligibility(*tfab.shard_forward_graph(smollm_t, cm, tokens=8, block_only=True), cm)
    assert probs and all("do not divide the model axis (2)" in p for p in probs)
    cj, ct = _meshes(1, 2)
    gj, sj = jfab.shard_forward_graph(JCfg(**DENSE), cj, tokens=8)
    gt, st = tfab.shard_forward_graph(TCfg(**DENSE), ct, tokens=8)
    assert tfab.graph_eligibility(gt, st[:-1], ct) == jfab.graph_eligibility(gj, sj[:-1], cj)
    assert tfab.graph_eligibility(gt, st[::-1], ct) == jfab.graph_eligibility(gj, sj[::-1], cj)
    other = _meshes(2, 1)
    assert (tfab.graph_eligibility(gt, tfab.shard_forward_graph(TCfg(**DENSE), other[1], tokens=8)[1], ct)
            == jfab.graph_eligibility(gj, jfab.shard_forward_graph(JCfg(**DENSE), other[0], tokens=8)[1], cj))
    empty = tfab.ForwardGraph(nodes=(), m=1, d_in=4, output="x")
    assert tfab.graph_eligibility(empty, [], ct) == ["empty graph"]
    big = tfab.ChipMeshConfig(data=4, model=4, fabric=tfab.FabricConfig(mode="hybrid", n_arrays=256))
    big_cfg = dataclasses.replace(t_get_config("smollm-135m"), n_heads=8, n_kv_heads=4, head_dim=72)
    assert tfab.graph_eligibility(*tfab.shard_forward_graph(big_cfg, big, tokens=16, block_only=True), big) == []


def test_compile_graph_forward_errors_equal_jax(model_weights, x_np):
    cj, ct = _meshes()
    errors = []
    for pkg, cfg_cls, cim_cls, cm in ((jfab, JCfg, jcl.CiMConfig, cj), (tfab, TCfg, tcl.CiMConfig, ct)):
        msgs = []
        for kwargs in (dict(backend="nope"), dict(cim=cim_cls(mode="exact", ste=False)),
                       dict(cim=cim_cls(mode="bitplane", rows=16, ste=True)), dict(scan_layers=True, block_only=True)):
            with pytest.raises(ValueError) as e:
                pkg.compile_graph_forward(cfg_cls(**DENSE), cm, **{"cim": cim_cls(**BP), **kwargs})
            msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            graph = pkg.model_forward_graph(cfg_cls(**DENSE), 8)
            pkg.compile_graph_forward(graph, cm, cim_cls(**BP), scan_layers=True)
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            pkg.compile_graph_forward(cfg_cls(**dict(DENSE, qkv_bias=True)), cm, cim_cls(**BP))
            pkg.transformer_graph_weights({}, cfg_cls(**dict(DENSE, qkv_bias=True)))
        msgs.append(str(e.value))
        errors.append(msgs)
    assert errors[1] == errors[0]
    # the port's call-time shape checks
    prog = tfab.compile_graph_forward(TCfg(**DENSE), ct, tcl.CiMConfig(**BP), tokens=8)
    ws = model_weights["dense", 1][1]
    x = torch.from_numpy(x_np)
    with pytest.raises(ValueError, match="missing graph weights"):
        prog(x, {k: v for k, v in ws.items() if k != "ln_f"})
    with pytest.raises(ValueError, match="expects weights"):
        prog(x, {**ws, "unembed": ws["unembed"][:32]})
    with pytest.raises(ValueError, match="input features"):
        prog(torch.zeros(2, 4, 32), ws)
    with pytest.raises(ValueError, match="batch, seq, d"):
        prog(x.reshape(8, 64), ws)


def test_random_weights_and_example_input_equal_jax():
    """The scan form's stacked draws equal JAX's; the unrolled form's are
    the same draws, unstacked."""
    pj, pt = _programs("moe", 2, 1, BP, n_layers=2, scan_layers=True)
    wj, wt = pj.random_weights(jax.random.PRNGKey(1)), pt.random_weights(prng.PRNGKey(1))
    assert sorted(wt) == sorted(wj) and pt.weight_shapes() == pj.weight_shapes()
    for name in wj:
        np.testing.assert_array_equal(wt[name].numpy(), np.asarray(wj[name]))
    np.testing.assert_array_equal(pt.example_input(prng.PRNGKey(0)).numpy(),
                                  np.asarray(pj.example_input(jax.random.PRNGKey(0))))
    assert (pt.m, pt.d_in, pt.n_out, pt.n_layers) == (pj.m, pj.d_in, pj.n_out, pj.n_layers)
    _, unrolled = _programs("moe", 2, 1, BP, n_layers=2)
    flat = unrolled.random_weights(prng.PRNGKey(1))
    assert unrolled.weight_shapes() == {k: tuple(v.shape) for k, v in flat.items()}
    assert all(torch.equal(flat[k], v) for k, v in tfab.unstack_block_weights(wt, 2).items())


def test_mixing_helpers_match_jax():
    """Each shared mixing helper against the JAX package's, on the same
    float32 inputs: within a few ulp of the output's scale (1e-6 of
    max|y|; a float32 ulp is 1.2e-7 relative, and the attention's largest
    difference was 7.2e-7 on outputs up to ~3, on elements near zero where
    the p·v sum cancels). The ops differ by torch's exp / rsqrt / sigmoid
    against XLA's; the count of elements that differ at all is printed by
    the assertion message."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 8, 4 * 16)).astype(np.float32) * 3
    k = rng.standard_normal((2, 8, 2 * 16)).astype(np.float32) * 3
    v = rng.standard_normal((2, 8, 2 * 16)).astype(np.float32)
    h = rng.standard_normal((2, 8, 64)).astype(np.float32) * 4
    scale = 0.1 * rng.standard_normal(64).astype(np.float32)
    router = rng.standard_normal((2, 8, 8)).astype(np.float32) * 2
    t = torch.from_numpy
    sumsq_j = jax.numpy.sum(h * h, axis=-1, keepdims=True)
    cases = {
        "attention": (jgraph._attention_mix(q, k, v, 4, 2, 16), tgraph._attention_mix(t(q), t(k), t(v), 4, 2, 16)),
        "norm": (jgraph._norm_apply(h, scale, 1e-5, jax.numpy.float32(64), sumsq_j),
                 tgraph._norm_apply(t(h), t(scale), 1e-5, torch.tensor(64.0), torch.sum(t(h) * t(h), -1, keepdim=True))),
        "silu_gate": (jgraph._silu_gate(h, q), tgraph._silu_gate(t(h), t(q))),
        "expert0_prob": (jgraph._expert0_prob(router), tgraph._expert0_prob(t(router))),
    }
    for name, (yj, yt) in cases.items():
        yj = np.asarray(yj)
        n_diff = int((yt.numpy() != yj).sum())
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-6 * np.abs(yj).max(),
                                   err_msg=f"{name}: {n_diff} of {yj.size} elements differ")
    # the causal mask: the first query sees only the first key
    out = tgraph._attention_mix(t(q), t(k), t(v), 4, 2, 16)
    torch.testing.assert_close(out[:, 0, :16], t(v)[:, 0, :16], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the fused graph against the JAX program, and against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,data,model,case", [
    ("dense", 1, 1, "bitplane"), ("dense", 1, 1, "noisy"), ("dense", 1, 1, "fake_quant"),
    ("moe", 1, 1, "fake_quant"), ("dense", 2, 2, "fake_quant"), ("moe", 1, 2, "fake_quant"),
])
def test_fused_graph_matches_the_jax_program(family, data, model, case, model_weights, x_np):
    """The port's fused graph against JAX's jitted ``GraphProgram`` on
    ``init_transformer`` weights: logits within ``LOGIT_RTOL`` of max|logit|
    (libm differences in the mixing ops), equal conversion and comparison
    counts, the collective census equal to the JAX jaxpr's and to the
    budget; and on a ``model = 1`` mesh ``torch.equal`` to the port's own
    per-node loop."""
    pj, pt = _programs(family, data, model, CIMS[case])
    assert pj.backend == pt.backend == "shard_map"
    wj, wt, *_ = model_weights[family, 1]
    seed = SEEDS[case]
    jkey, tkey = (jax.random.PRNGKey(seed), prng.PRNGKey(seed)) if seed is not None else (None, None)
    yj, sj = pj(x_np, wj, key=jkey, return_stats=True)
    yj = np.asarray(yj)
    x = torch.from_numpy(x_np)
    yt, st = pt(x, wt, key=tkey, return_stats=True)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=LOGIT_RTOL * np.abs(yj).max())
    assert (int(st.conversions), float(st.comparisons)) == (int(sj.conversions), float(sj.comparisons))
    if case == "noisy":  # the census and the loop each run a forward: covered noiselessly
        return
    counts = pt.collective_counts(device="cpu")
    assert counts == pt.collective_budget() == pj.collective_budget()
    assert counts == pj.collective_counts()
    y_loop, s_loop = tfab.per_node_forward(x, wt, pt.graph, pt.placements, pt.chip_mesh, pt.cim, key=tkey,
                                           return_stats=True)
    assert torch.equal(yt, y_loop)
    assert int(s_loop.conversions) == int(st.conversions)


def _loops_and_codes(pj, pt, wj, wt, x_np, monkeypatch, jit=False):
    """Both packages' per-node loops on the same input, with the input of
    every matmul node recorded: (JAX logits, port logits, activation codes
    compared, codes that differ), the codes quantized at the CiM's
    ``a_bits`` as each package's fabric quantizes them."""
    seen = {"jax": [], "port": []}

    def recorder(module, tag):
        real = module.execute_sharded_matmul

        def record(x, *args, **kwargs):
            seen[tag].append(x)
            return real(x, *args, **kwargs)
        monkeypatch.setattr(module, "execute_sharded_matmul", record)

    recorder(jgraph, "jax")
    recorder(tgraph, "port")
    if jit:  # the boundaries leave the trace as outputs, next to the logits
        def loop(x, w):
            seen["jax"].clear()
            y = jgraph.per_node_forward(x, w, pj.graph, pj.placements, pj.chip_mesh, pj.cim)
            return y, list(seen["jax"])
        yj, hs = jax.jit(loop)(x_np, wj)
        seen["jax"] = hs
    else:
        yj = jgraph.per_node_forward(x_np, wj, pj.graph, pj.placements, pj.chip_mesh, pj.cim)
    yt = tgraph.per_node_forward(torch.from_numpy(x_np), wt, pt.graph, pt.placements, pt.chip_mesh, pt.cim)
    assert len(seen["jax"]) == len(seen["port"]) == len(pt.graph.matmul_nodes)
    bits = pt.cim.a_bits
    n_codes = n_diff = 0
    for hj, ht in zip(seen["jax"], seen["port"]):
        cj, _ = jcl.quantize_symmetric(np.asarray(hj), bits, True)
        ct, _ = tcl.quantize_symmetric(ht, bits, True)
        n_codes += cj.size
        n_diff += int((ct.numpy() != np.asarray(cj)).sum())
    return np.asarray(yj), yt, n_codes, n_diff


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_quantization_codes_at_every_boundary_equal_jax(family, model_weights, x_np, monkeypatch):
    """Both packages' per-node loops (8-bit ``fake_quant``, 1x1), with the
    input of every matmul node recorded: the activation codes each package
    quantizes there are counted against each other. The libm differences
    upstream may flip a code where a value sits on a rounding boundary; at
    most 2 of the codes may differ (0 differed on these inputs), and the
    logits stay within ``LOGIT_RTOL``."""
    pj, pt = _programs(family, 1, 1, FQ)
    wj, wt, *_ = model_weights[family, 1]
    yj, yt, n_codes, n_diff = _loops_and_codes(pj, pt, wj, wt, x_np, monkeypatch)
    assert n_diff <= 2, f"{n_diff} of {n_codes} activation codes differ"
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=LOGIT_RTOL * np.abs(yj).max())


def test_ragged_batch_fallback_records_as_jax(model_weights):
    """A batch the data axis does not divide: ``auto`` falls back to the
    per-node loop with the ``ragged_batch`` record the JAX package writes
    (``fake_quant``, whose JAX loop runs eagerly in a second), an explicit
    ``shard_map`` raises; an ineligible program records its reason."""
    pj, pt = _programs("dense", 2, 1, FQ)
    wj, wt, *_ = model_weights["dense", 1]
    x3 = np.random.default_rng(2).standard_normal((3, 2, 64)).astype(np.float32)
    with jtrace.tracing() as trj, jmetrics.collecting() as rj:
        yj = np.asarray(pj(x3, wj))
    with ttrace.tracing() as trt, tmetrics.collecting() as rt:
        yt = pt(torch.from_numpy(x3), wt)
    assert [e["attrs"] for e in trt.events if e["name"] == "fabric.fallback"] == \
        [e["attrs"] for e in trj.events if e["name"] == "fabric.fallback"]
    assert rt.counter("fabric_fallback_total").value(reason="ragged_batch") == 1.0
    assert rt.snapshot() == rj.snapshot()
    assert torch.equal(yt, tfab.per_node_forward(torch.from_numpy(x3), wt, pt.graph, pt.placements, pt.chip_mesh,
                                                 pt.cim))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=LOGIT_RTOL * np.abs(yj).max())
    assert not pt.fused_available(torch.from_numpy(x3))
    strict = tfab.compile_graph_forward(TCfg(**DENSE), pt.chip_mesh, pt.cim, tokens=8, backend="shard_map")
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        strict(torch.from_numpy(x3), wt)
    # an ineligible program (smollm's 9/3 heads on a 2-wide model axis)
    prog = tfab.compile_graph_forward(t_get_config("smollm-135m"), tfab.ChipMeshConfig(model=2, fabric=pt.chip_mesh.fabric),
                                      pt.cim, tokens=4, block_only=True)
    assert prog.backend == "sequential" and prog.problems
    with pytest.raises(ValueError, match="fused graph program unavailable"):
        tfab.compile_graph_forward(t_get_config("smollm-135m"), prog.chip_mesh, pt.cim, tokens=4, block_only=True,
                                   backend="shard_map")


def test_weight_adapters_equal_jax_and_round_trip(model_weights):
    for family in CFGS:
        cfg_j, cfg_t = JCfg(**dict(CFGS[family], n_layers=2)), TCfg(**dict(CFGS[family], n_layers=2))
        wj, wt, params, pj = model_weights[family, 2]
        assert sorted(wt) == sorted(wj)
        for name in wj:
            np.testing.assert_array_equal(wt[name].numpy(), np.asarray(wj[name]))
        sj, st = jfab.stack_block_weights(pj, cfg_j), tfab.stack_block_weights(params, cfg_t)
        assert sorted(st) == sorted(sj)
        for name in sj:
            np.testing.assert_array_equal(st[name].numpy(), np.asarray(sj[name]))
        un = tfab.unstack_block_weights(st, 2)
        assert sorted(un) == sorted(wt) and all(torch.equal(un[k], wt[k]) for k in wt)
        assert all(torch.equal(a, b) for a, b in zip(tgraph._stack_layer_weights(wt, 2).values(), st.values()))
        blk_j = jfab.transformer_graph_weights(pj, cfg_j, block_only=True)
        blk_t = tfab.transformer_graph_weights(params, cfg_t, block_only=True)
        assert sorted(blk_t) == sorted(blk_j)
        for name in blk_j:
            np.testing.assert_array_equal(blk_t[name].numpy(), np.asarray(blk_j[name]))
    with pytest.raises(ValueError, match="no transformer graph"):
        tfab.transformer_graph_weights({}, t_get_config("mamba2-130m"))


def test_measure_forward_on_a_graph_program_keys_equal_jax(model_weights, x_np):
    pj, pt = _programs("dense", 1, 2, FQ)
    wj, wt, *_ = model_weights["dense", 1]
    mj = jfab.measure_forward(pj, x=x_np, weights=wj, iters=1, per_layer_backend="sequential")
    mt = tfab.measure_forward(pt, x=torch.from_numpy(x_np), weights=wt, iters=1, per_layer_backend="sequential",
                              device="cpu")
    assert sorted(mt) == sorted(mj)
    assert mt["backend"] == "shard_map" and mt["n_layers"] == 8 and mt["mesh"] == "1x2"
    assert mt["fused_s"] > 0 and mt["local_s"] > 0 and mt["per_layer_s"] > 0
    for key in ("modeled_link_s", "modeled_serial_latency_s", "modeled_overlapped_latency_s"):
        assert mt[key] == mj[key]


def test_full_smollm_graph_plans_as_the_smoke_runs_it():
    """The graphs the card runs (``chip_smoke.py`` ``[graph]``): smollm-135m
    whole at tokens 256 on 1x3 (211 matmul nodes, fused; 1x1 plans the same
    graph), a block of it on 2x2 sequential for its 9/3 heads;
    qwen3-moe-30b-a3b cut to 8 layers (65 nodes), whose block fuses on
    1x4."""
    fb = tfab.FabricConfig(mode="hybrid", n_arrays=256)
    cim = tcl.CiMConfig(mode="fake_quant", ste=False)
    smollm = t_get_config("smollm-135m")
    prog = tfab.compile_graph_forward(smollm, tfab.ChipMeshConfig(model=3, fabric=fb), cim, tokens=256)
    assert prog.backend == "shard_map" and prog.n_layers == 211 and not prog.problems
    prog = tfab.compile_graph_forward(smollm, tfab.ChipMeshConfig(data=2, model=2, fabric=fb), cim, tokens=256,
                                      block_only=True)
    assert prog.backend == "sequential" and "heads 9/3 (q/kv) do not divide the model axis (2)" in prog.problems[0]
    moe = dataclasses.replace(t_get_config("qwen3-moe-30b-a3b"), n_layers=8)
    assert len(tfab.model_forward_graph(moe, 256).matmul_nodes) == 65
    prog = tfab.compile_graph_forward(moe, tfab.ChipMeshConfig(model=4, fabric=fb), cim, tokens=256, block_only=True)
    assert prog.backend == "shard_map" and prog.n_layers == 8
