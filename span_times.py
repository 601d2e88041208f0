#!/usr/bin/env python3
"""Device time of a benchmark cell's traced calls by the program span that
launched it.

    python3 span_times.py --workload <cell> --seed <n> [--calls N]

Run from the root of a checkout, on the card. It sets the cell up from the
benchmark's files (``BENCHMARK.json``, ``portbench/``: configuration,
weights and prompts from the seed, one warm call per prompt length), then
serves the mix's ``trace_calls`` calls (or ``N``) under
``repro_torch.obs`` tracing and a ``torch.profiler`` run that records
device activity only. The profiler keeps, for each device operation, the
CUDA runtime or driver call that started it (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, a memcpy or memset call) under the same
correlation id; the innermost program span open at that call's host time
is the operation's span. Span records and profiler events share the host's
real-time clock (``repro_torch.obs.trace.now_ns``), so no offset is taken.

It prints the device seconds by span with each span's largest kernels, the
CiM spans by their enclosing layer, the checks of the attribution
(operations without a launch record, K1 launches outside ``cim.matmul``,
the share of device time under ``serve.prefill`` / ``serve.decode``), and
last one JSON line: the table, ``quant_ms`` and ``quant_gb`` (device ms
launched in ``cim.quantize`` spans and GB of float operands they read, per
forward), ``decode_step_p90_ms`` (the 90th percentile of the host
durations of ``serve.decode_step`` spans, profiler on), busy and window
seconds, and the card. It needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
OUTSIDE = -1  # an operation launched while no span was open


def profile_events(prof) -> tuple:
    """``(ops, launches)`` of a finished ``torch.profiler.profile``: ``ops``
    the ``(name, start_ns, end_ns, correlation id)`` of every device
    activity, ``launches`` a dict from a correlation id to the host start
    (ns) of the earliest runtime or driver call that carries it."""
    from torch.autograd import DeviceType

    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns(), e.correlation_id()))
        else:
            c, t = e.correlation_id(), e.start_ns()
            if c and t < launches.get(c, t + 1):
                launches[c] = t
    return ops, launches


class Attribution(NamedTuple):
    span: list  # per operation: the index of its span, OUTSIDE, or None without a launch record
    parent: list  # per span: the index of the span it lies in, or OUTSIDE


def attribute(ops, launches: dict, spans) -> Attribution:
    """Each operation's span: the innermost of ``spans`` (dicts with integer
    ``start_ns`` and ``end_ns``, recorded on one thread, so nested or apart)
    open at the host time of its launch (``launches[correlation id]``, see
    :func:`profile_events`), and each span's enclosing span."""
    order = sorted(range(len(spans)), key=lambda k: (spans[k]["start_ns"], -spans[k]["end_ns"]))
    timed = sorted((launches[op[3]], i) for i, op in enumerate(ops) if op[3] in launches)
    span_of = [None] * len(ops)
    parent = [OUTSIDE] * len(spans)
    stack, j = [], 0

    def close(t):  # spans that ended before t
        while stack and spans[stack[-1]]["end_ns"] < t:
            stack.pop()

    def open_until(t):
        nonlocal j
        while j < len(order) and spans[order[j]]["start_ns"] <= t:
            k = order[j]
            close(spans[k]["start_ns"] + 1)  # a span that ends where this one starts lies before it
            parent[k] = stack[-1] if stack else OUTSIDE
            stack.append(k)
            j += 1

    for t, i in timed:
        open_until(t)
        close(t)  # a span's own end still holds a launch
        span_of[i] = stack[-1] if stack else OUTSIDE
    open_until(float("inf"))
    return Attribution(span_of, parent)


def seconds_by_span(ops, att: Attribution, spans) -> dict:
    """Device seconds of the operations by the name of their span, then by
    their own name: ``{span: {operation: seconds}}``, with ``(outside every
    span)`` and ``(no launch record)`` for the rest."""
    out: dict = defaultdict(lambda: defaultdict(float))
    for (name, s, e, _), k in zip(ops, att.span):
        span = "(no launch record)" if k is None else "(outside every span)" if k == OUTSIDE else spans[k]["name"]
        out[span][name] += (e - s) / 1e9
    return {span: dict(by_op) for span, by_op in out.items()}


def under(att: Attribution, spans, roots) -> list:
    """Per span: whether it is, or lies in, a span named in ``roots``."""
    out = [False] * len(spans)
    for k in sorted(range(len(spans)), key=lambda k: spans[k]["start_ns"]):  # a parent opens before its children
        up = att.parent[k]
        out[k] = spans[k]["name"] in roots or (up != OUTSIDE and out[up])
    return out


def span_numbers(ops, att: Attribution, spans, forwards: int) -> dict:
    """The per-layer numbers the spans give, over ``forwards``: ``quant_ms``
    and ``quant_gb`` (device ms launched in ``cim.quantize`` spans, and the
    ``bytes`` those spans read, in GB), ``decode_step_p90_ms`` (the 90th
    percentile, linear between order statistics, of the host durations of
    the ``serve.decode_step`` spans; None with fewer than two)."""
    quant = {k for k, sp in enumerate(spans) if sp["name"] == "cim.quantize"}
    steps = [(sp["end_ns"] - sp["start_ns"]) / 1e6 for sp in spans if sp["name"] == "serve.decode_step"]
    return {
        "quant_ms": sum(e - s for (_, s, e, _), k in zip(ops, att.span) if k in quant) / 1e6 / forwards,
        "quant_gb": sum(spans[k]["attrs"]["bytes"] for k in quant) / 1e9 / forwards,
        "decode_step_p90_ms": statistics.quantiles(steps, n=10, method="inclusive")[-1] if len(steps) > 1 else None,
    }


def report(ops, launches: dict, spans, forwards: int, log=print) -> dict:
    """Log the device time by span and the attribution's checks; return the
    summary of the JSON line."""
    att = attribute(ops, launches, spans)
    table = seconds_by_span(ops, att, spans)
    total = sum(e - s for _, s, e, _ in ops) / 1e9
    by_span = sorted(((sum(by_op.values()), name) for name, by_op in table.items()), reverse=True)
    log(f"device seconds by span ({len(ops)} operations, {len(spans)} spans, {total:.6f} s):")
    for sec, name in by_span:
        log(f"  {name:<24} {sec:12.6f} s  {100 * sec / total if total else 0.0:7.3f}%")
        for op, op_s in sorted(table[name].items(), key=lambda kv: -kv[1])[:3]:
            log(f"      {op_s:12.6f} s  {op[:100]}")
    placed = [(n, (e - s) / 1e9, k) for (n, s, e, _), k in zip(ops, att.span) if k is not None and k != OUTSIDE]
    in_layer: dict = defaultdict(float)
    for _, sec, k in placed:
        if spans[k]["name"].startswith("cim.") and att.parent[k] != OUTSIDE:
            in_layer[f"{spans[k]['name']} in {spans[att.parent[k]]['name']}"] += sec
    log("CiM spans by enclosing span: " + ", ".join(f"{key} {sec:.6f} s" for key, sec in sorted(in_layer.items())))
    served = under(att, spans, ("serve.prefill", "serve.decode"))
    k1 = [k for (n, _, _, _), k in zip(ops, att.span) if "cim_fq_kernel" in n]
    k1_in = sum(1 for k in k1 if k is not None and k != OUTSIDE and spans[k]["name"] == "cim.matmul")
    unrecorded = sum((e - s) / 1e9 for (_, s, e, _), k in zip(ops, att.span) if k is None)
    served_s = sum(sec for _, sec, k in placed if served[k])
    log(f"attribution: {att.span.count(None)} of {len(ops)} operations without a launch record ({unrecorded:.6f} s); "
        f"K1 launches in cim.matmul {k1_in} of {len(k1)}; device time under serve.prefill or serve.decode "
        f"{100 * served_s / total if total else 0.0:.4f}%")
    return {"device_s_by_span": {name: sec for sec, name in by_span}, "device_s": total,
            "unrecorded_s": unrecorded, "k1_launches": len(k1), "k1_in_cim_matmul": k1_in,
            "served_pct": 100 * served_s / total if total else 0.0, **span_numbers(ops, att, spans, forwards)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=None, help="calls to trace (default: the mix's trace_calls)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_times: CUDA is not available; this script runs on a GPU only", file=sys.stderr)
        return 1
    for p in (HERE / "src", HERE):
        sys.path.insert(0, str(p))
    from torch.profiler import ProfilerActivity, profile

    from portbench import bench, trace, traffic, weights, work
    from repro_torch.launch.serve import ServeSettings, serve_batch
    from repro_torch.obs import trace as obs_trace

    def log(msg):
        print(f"[span_times] {msg}", file=sys.stderr, flush=True)

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = bench.Spec(HERE)
    cell = spec.workload(args.workload)
    run, mix = spec.config(cell["config"])["run"], spec.traffic(cell["traffic"])
    dev = torch.device("cuda")
    n_calls = args.calls or mix["trace_calls"]
    with torch.inference_mode():
        cfg = bench.port_config(run)
        params = weights.make_params(run, traffic.sub_seed(args.seed, 0), dev)
        calls = [traffic.call(mix, i) for i in range(n_calls)]
        prompts = [traffic.prompts(c, args.seed, run["vocab"], dev) for c in calls]

        def serve(c, pr):
            st = ServeSettings(batch=c.batch, prompt_len=c.prompt_len, gen_len=c.gen_len)
            return serve_batch(cfg, st, prompts=pr, device=dev, params=params)

        for c, pr in list(zip(calls, prompts))[: traffic.cycle(mix)]:  # warm every prompt length
            serve(c, pr)
        torch.cuda.synchronize()
        with obs_trace.tracing() as tr, profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()  # as the benchmark's traced run: the profiler is recording before t0
            t0 = time.time_ns()
            for c, pr in zip(calls, prompts):
                serve(c, pr)
            torch.cuda.synchronize()
            t1 = time.time_ns()
    ops, launches = profile_events(prof)
    forwards = sum(c.gen_len for c in calls)
    out = report(ops, launches, tr.spans, forwards, log)
    quant = sum(sp["attrs"]["bytes"] for sp in tr.spans if sp["name"] == "cim.quantize")
    act = getattr(torch, run["compute_dtype"]).itemsize
    want = sum(lin.m * lin.k * act + lin.k * lin.n * 4 for c in calls for lin in work.cim_linears(run, c))
    log(f"quantizer bytes: spans {quant}, work count {want}")
    out.update(workload=args.workload, seed=args.seed, calls=n_calls, forwards=forwards,
               busy_s=trace.busy_seconds([(s, e) for _, s, e, _ in ops], t0, t1), window_s=(t1 - t0) / 1e9,
               card=torch.cuda.get_device_name(dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
