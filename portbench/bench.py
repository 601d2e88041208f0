"""The benchmark's run of one workload: set-up, the measured window, the
traced calls, the check against the reference, and the result line.

Everything a workload needs is found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic mix
(``portbench/traffic/<traffic>.json``), each metric's reader
(``portbench/metrics/<metric>.py``) and its limits
(``portbench/limits/<workload>.json``). Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import check, trace, traffic, weights

__all__ = ["Spec", "load_metric", "run_cell", "port_config", "CallResult"]


class Spec:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return traffic.load(self.root / "portbench" / "traffic" / f"{name}.json")

    def metrics(self, workload: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries reported in ``workload``."""
        return [m for m in self.data[kind] if workload in m.get("workloads", [workload])]


def load_metric(root, name: str):
    """The reader module of metric ``name``: ``portbench/metrics/<name>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(run: dict):
    """The program's ``ModelConfig`` of a configuration's ``run`` group."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.cim_linear import CiMConfig

    fields = {k: v for k, v in run.items() if k != "cim"}
    return ModelConfig(**fields, cim=CiMConfig(**run["cim"]))


@dataclasses.dataclass
class CallResult:
    call: traffic.Call
    wall_s: float  # host clock around the whole serve_batch call
    prefill_s: float
    decode_s: float
    generated: np.ndarray  # (batch, gen_len) served tokens
    logits: torch.Tensor  # (batch, V) the logits the call returned, kept on the device in their own values


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class _Runner:
    def __init__(self, spec: Spec, workload: str, seed: int, device: str):
        self.cell = spec.workload(workload)
        self.run = spec.config(self.cell["config"])["run"]
        self.mix = spec.traffic(self.cell["traffic"])
        self.seed = seed
        self.device = torch.device(device)
        self.spans: list = []  # (name, start_ns, end_ns, call index) on the host's real-time clock

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        from repro_torch.launch.serve import ServeSettings, serve_batch

        t0 = time.perf_counter()
        self.cfg = port_config(self.run)
        self.params = weights.make_params(self.run, traffic.sub_seed(self.seed, 0), self.device)
        self.sync()
        t1 = time.perf_counter()
        warm = traffic.Call(0, self.mix["batch"], 0, min(self.mix["gen_len"], 2))
        for s in sorted(set(self.mix["prompt_lens"])):
            c = warm._replace(prompt_len=s)
            pr = traffic.prompts(c, self.seed, self.run["vocab"], self.device, stream=1)
            serve_batch(self.cfg, ServeSettings(batch=c.batch, prompt_len=s, gen_len=c.gen_len),
                        prompts=pr, device=self.device, params=self.params)
        self.sync()
        _log(f"set-up steps: weights {t1 - t0:.3f} s, warm calls {time.perf_counter() - t1:.3f} s")

    def serve(self, index: int) -> CallResult:
        from repro_torch.launch.serve import ServeSettings, serve_batch

        c = traffic.call(self.mix, index)
        t0 = time.time_ns()
        pr = traffic.prompts(c, self.seed, self.run["vocab"], self.device)
        t1 = time.time_ns()
        start = time.perf_counter()
        out = serve_batch(self.cfg, ServeSettings(batch=c.batch, prompt_len=c.prompt_len, gen_len=c.gen_len),
                          prompts=pr, device=self.device, params=self.params)
        wall = time.perf_counter() - start
        t2 = time.time_ns()
        # kept on the device, no wait: the program's logits are values of its compute dtype
        logits = out["logits"][:, -1, : self.run["vocab"]].to(getattr(torch, self.run["compute_dtype"]))
        self.spans += [("bench.prompts", t0, t1, index), ("bench.call", t1, t2, index)]
        return CallResult(c, wall, out["prefill_s"], out["decode_s"], np.asarray(out["generated"]), logits)

    def window(self, seconds: float) -> list:
        """Whole cycles of the mix, until ``seconds`` have passed."""
        calls, start = [], time.perf_counter()
        while not calls or time.perf_counter() - start < seconds:
            for _ in range(traffic.cycle(self.mix)):
                calls.append(self.serve(len(calls)))
        self.window_s = time.perf_counter() - start
        return calls

    def traced(self, first: int) -> tuple:
        """``trace_calls`` more calls under the profiler: (calls, DeviceTrace,
        breakdown)."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.obs import trace as obs_trace

        offset = time.time_ns() - time.perf_counter_ns()
        self.spans = []
        calls = []
        with obs_trace.tracing() as tr, profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.sync()
            t0 = time.time_ns()
            for i in range(self.mix["trace_calls"]):
                calls.append(self.serve(first + i))
            self.sync()
            t1 = time.time_ns()
        events = trace.device_events(prof)
        dt = trace.reduce_events(events, t0, t1)
        spans = list(self.spans)
        call_of = {}
        for name, s, e, idx in self.spans:
            if name == "bench.call":
                call_of[idx] = (s, e)
        for sp in tr.spans:
            s = int(sp["t_s"] * 1e9) + offset
            e = s + int(sp["duration_s"] * 1e9)
            idx = next((i for i, (a, b) in call_of.items() if a <= s <= b), None)
            spans.append((sp["name"], s, e, idx))
        breakdown = {"device_ops": trace.top_ops(dt.by_name), "idle_gaps": trace.label_gaps(dt.gaps, spans)}
        _log(f"traced {len(calls)} calls: {len(events)} device events, {dt.launches} kernels, "
             f"busy {dt.busy_s:.6f} s of {dt.window_s:.6f} s")
        return calls, dt, breakdown

    def checked(self, calls: list) -> list:
        """The calls to check, drawn from the seed: one with the longest
        prompt, then ``check_calls - 1`` others."""
        rng = np.random.default_rng(traffic.sub_seed(self.seed, 2))
        longest = max(c.call.prompt_len for c in calls)
        first = [i for i, c in enumerate(calls) if c.call.prompt_len == longest]
        pick = [first[int(rng.integers(len(first)))]]
        rest = [i for i in range(len(calls)) if i != pick[0]]
        k = min(self.mix["check_calls"] - 1, len(rest))
        pick += [rest[i] for i in rng.choice(len(rest), size=k, replace=False)] if k > 0 else []
        return [calls[i] for i in pick]

    def compare(self, c: CallResult, control: bool = False) -> dict:
        pr = traffic.prompts(c.call, self.seed, self.run["vocab"], self.device)
        served = torch.as_tensor(c.generated, device=self.device)
        n = check.follow(self.run, self.params, pr, served, c.logits.float(), control=control)
        n.update(index=c.call.index, prompt_len=c.call.prompt_len)
        return n


def _card(device) -> dict:
    import subprocess

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    limit = None
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        limit = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "power_limit_w": limit}


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of ``workload``: the result line's dict, ``check`` last."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = Spec(root)
    r = _Runner(spec, workload, seed, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)
    _log(f"{workload}: process start to set-up {time.perf_counter() - t_start:.3f} s (imports, CUDA)")
    with torch.inference_mode():
        if r.device.type == "cuda":
            torch.cuda.init()
            _log(f"CUDA context by {time.perf_counter() - t_start:.3f} s")
        r.setup()
    setup_s = time.perf_counter() - t_start
    _log(f"{workload}: set-up {setup_s:.3f} s, weights {weights.n_bytes(r.params) / 1e9:.3f} GB")

    with torch.inference_mode():
        calls = r.window(seconds)
        profiled, dt, breakdown = r.traced(len(calls)) if traced else ([], None, None)
    _log(f"window {r.window_s:.3f} s, {len(calls)} calls, {sum(c.wall_s for c in calls):.3f} s in calls: "
         f"{[round(c.wall_s, 4) for c in calls]}")
    device_rec = _card(r.device)
    if r.device.type == "cuda":
        device_rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(r.device))
    if dt is not None:
        device_rec.update(busy_s=dt.busy_s, window_s=dt.window_s)

    rec = SimpleNamespace(run=r.run, mix=r.mix, calls=calls, profiled=profiled, trace=dt,
                          setup_s=setup_s, window_s=r.window_s)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics(workload, kind):
        value = load_metric(root, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t0 = time.perf_counter()
    numbers = [r.compare(c) for c in r.checked(calls + profiled)]
    for n in numbers:
        _log(f"checked call {n['index']} (prompt {n['prompt_len']}): gap {n['gap']!r}, logit_err {n['logit_err']!r}, "
             f"token_mismatch {n['token_mismatch']!r}, requests with a gap "
             f"{int((n['row_gap'] > 0).sum())} of {n['row_gap'].numel()}, median logit_err {float(n['row_err'].median())!r}")
    correct, failed, shown = check.judge(numbers, check.limits(root, workload))
    _log(f"check of {len(numbers)} calls in {time.perf_counter() - t0:.3f} s")
    out = {"correct": correct, "attempted": sum(c.call.batch for c in calls + profiled), "failed": failed,
           "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = shown
    return out
