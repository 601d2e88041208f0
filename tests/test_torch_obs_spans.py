"""The port's spans on the serve path, on the CPU at reduced size: their
nesting through ``parent``, one ``serve.decode_step`` a step, two
``cim.quantize`` spans a CiM linear whose ``bytes`` add up to the
benchmark's count, outputs unchanged by tracing, and nothing recorded when
tracing is off."""

from __future__ import annotations

import json
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bench, traffic, work
from portbench.tests.tiny import reduced_run
from repro_torch.launch.serve import ServeSettings, serve_batch
from repro_torch.obs import trace as obs_trace

ROOT = Path(__file__).resolve().parents[1]
CALL = traffic.Call(0, 2, 8, 4)  # batch 2, prompt 8, 4 tokens: a prefill and 3 decode steps
LAYERS = ("layer.attention", "layer.mlp", "layer.mamba2")


def _run(name: str) -> dict:
    run = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["run"]
    return reduced_run(run, "bfloat16")


@pytest.fixture(scope="module", params=["smollm-135m", "zamba2-7b"])
def served(request):
    """The reduced model served twice on the CPU, tracing off then on:
    (run, untraced output, traced output, span records, bounds in ns)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = _run(request.param)
        cfg = bench.port_config(run)
        st = ServeSettings(batch=CALL.batch, prompt_len=CALL.prompt_len, gen_len=CALL.gen_len, seed=3)
        off = serve_batch(cfg, st, device="cpu")
        t0 = time.time_ns()
        with obs_trace.tracing() as tr:
            on = serve_batch(cfg, st, device="cpu")
        t1 = time.time_ns()
    finally:
        torch.set_num_threads(n)
    return run, off, on, tr.spans, (t0, t1)


def _chain(rec, by_id) -> list:
    names = []
    while rec is not None:
        names.append(rec["name"])
        rec = by_id.get(rec["parent"])
    return names


def test_tracing_leaves_tokens_and_logits_bit_identical(served):
    _, off, on, _, _ = served
    assert np.array_equal(off["generated"], on["generated"])
    assert torch.equal(off["logits"], on["logits"])


def test_records_carry_ids_parents_and_the_shared_clock(served):
    _, _, _, spans, (t0, t1) = served
    ids = [sp["id"] for sp in spans]
    assert len(set(ids)) == len(ids)
    by_id = dict(zip(ids, spans))
    for sp in spans:
        assert isinstance(sp["start_ns"], int) and t0 <= sp["start_ns"] <= sp["end_ns"] <= t1
        assert sp["duration_s"] >= 0
        if sp["parent"] is not None:  # a child lies in its parent and ends first
            up = by_id[sp["parent"]]
            assert up["start_ns"] <= sp["start_ns"] and sp["end_ns"] <= up["end_ns"]
    assert {sp["name"] for sp in spans if sp["parent"] is None} == {"serve.prefill", "serve.decode"}


def test_spans_nest_from_quantization_to_the_decode_loop(served):
    _, _, _, spans, _ = served
    by_id = {sp["id"]: sp for sp in spans}
    steps = [sp for sp in spans if sp["name"] == "serve.decode_step"]
    assert [sp["attrs"]["step"] for sp in steps] == list(range(CALL.gen_len - 1))
    assert {by_id[sp["parent"]]["name"] for sp in steps} == {"serve.decode"}
    chains = Counter(tuple(_chain(sp, by_id)) for sp in spans if sp["name"].startswith("cim."))
    for chain in chains:
        assert chain[0] in ("cim.quantize", "cim.matmul") and chain[1] in LAYERS, chain
        assert chain[2:] in (("serve.prefill",), ("serve.decode_step", "serve.decode")), chain
    unembed = [tuple(_chain(sp, by_id)) for sp in spans if sp["name"] == "layer.unembed"]
    assert unembed == [("layer.unembed", "serve.prefill")] + [
        ("layer.unembed", "serve.decode_step", "serve.decode")] * (CALL.gen_len - 1)


def test_layer_spans_per_forward(served):
    run, _, _, spans, _ = served
    count = Counter((sp["name"], sp["attrs"].get("layer")) for sp in spans if sp["name"] in LAYERS)
    forwards = CALL.gen_len
    if run["family"] == "dense":
        want = {(kind, i) for kind in ("layer.attention", "layer.mlp") for i in range(run["n_layers"])}
    else:
        groups = run["n_layers"] // run["share_period"]
        want = {("layer.mamba2", i) for i in range(run["n_layers"])} | {
            (kind, j) for kind in ("layer.attention", "layer.mlp") for j in range(groups)}
    assert set(count) == want and set(count.values()) == {forwards}


def test_two_quantize_spans_per_linear_and_their_bytes(served):
    run, _, _, spans, _ = served
    quant = [sp for sp in spans if sp["name"] == "cim.quantize"]
    matmul = [sp for sp in spans if sp["name"] == "cim.matmul"]
    lins = work.cim_linears(run, CALL)
    assert len(matmul) == len(lins) and len(quant) == 2 * len(lins)
    assert [sp["attrs"]["operand"] for sp in quant] == ["x", "w"] * len(lins)
    shapes = Counter((sp["attrs"]["m"], sp["attrs"]["k"], sp["attrs"]["n"]) for sp in matmul)
    assert shapes == Counter(tuple(lin) for lin in lins)
    # the activation in the compute dtype (bf16), the weight in float32
    assert sum(sp["attrs"]["bytes"] for sp in quant) == sum(2 * lin.m * lin.k + 4 * lin.k * lin.n for lin in lins)


def test_disabled_span_is_the_shared_noop_and_records_nothing():
    with obs_trace.tracing() as tr:
        pass
    assert not obs_trace.enabled()
    sp = obs_trace.span("cim.quantize", operand="x")
    assert sp is obs_trace.span("layer.mlp") and sp is obs_trace._NULL_SPAN
    with sp as inner:
        inner.set(bytes=1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serve_batch(bench.port_config(_run("smollm-135m")), ServeSettings(batch=1, prompt_len=4, gen_len=2),
                    device="cpu")
    finally:
        torch.set_num_threads(n)
    assert tr.spans == [] and tr.events == []


def test_parent_is_the_enclosing_span_of_the_same_tracer():
    with obs_trace.tracing() as outer:
        with obs_trace.span("a"):
            with obs_trace.tracing() as inner:
                with obs_trace.span("b"):
                    with obs_trace.span("c"):
                        pass
    o = {sp["name"]: sp for sp in outer.spans}
    i = {sp["name"]: sp for sp in inner.spans}
    assert set(o) == {"a", "b", "c"} and set(i) == {"b", "c"}
    assert o["a"]["parent"] is None and o["b"]["parent"] == o["a"]["id"] and o["c"]["parent"] == o["b"]["id"]
    # "a" is not the inner tracer's: there "b" is a root
    assert i["b"]["parent"] is None and i["c"]["parent"] == i["b"]["id"] == o["b"]["id"]
