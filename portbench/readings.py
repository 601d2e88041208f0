"""Readings that the limits of ``portbench/limits/<workload>.json`` are set
from: for each seed, the program's numbers and the control's, at the
workload's own sizes, in one process.

    python3 portbench/readings.py --workload <name> --seeds 11 12 13 [--control 1] [--out FILE]

Each seed makes its own weights, serves the calls that a run's check would
pick from one cycle of the mix (one with the longest prompt first), and
compares them with the reference; with ``--control 1`` the control (the
reference one precision below the configuration's) is read at the same
positions. Both sides' numbers go through the run's own judgement
(``check.judge``) with the workload's limits, where it has any: the line
gives ``correct`` of the program's calls and ``control_correct`` of the
control's. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from portbench import bench, check, traffic

    if not torch.cuda.is_available():
        print("[readings] no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = bench.Spec(ROOT)
    lim = check.limits(ROOT, args.workload)
    for seed in args.seeds:
        r = bench._Runner(spec, args.workload, seed, "cuda")
        t0 = time.perf_counter()
        with torch.inference_mode():
            r.setup()
            calls = [r.serve(i) for i in range(traffic.cycle(r.mix))]
        t1 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "setup_and_cycle_s": t1 - t0,
                "call_wall_s": [c.wall_s for c in calls], "calls": []}
        numbers = []
        for c in r.checked(calls):
            t2 = time.perf_counter()
            n = r.compare(c, control=bool(args.control))
            torch.cuda.synchronize()
            numbers.append(n)
            shown = {k: v for k, v in n.items() if not k.startswith("row_") and k != "control"}
            shown.update(reference_s=time.perf_counter() - t2,
                         rows_gap_pos=int((n["row_gap"] > 0).sum()), rows=int(n["row_gap"].numel()),
                         row_err_median=float(n["row_err"].median()), row_gap_median=float(n["row_gap"].median()))
            if "control" in n:
                shown.update({f"control_{k}": v for k, v in n["control"].items() if not k.startswith("row_")})
            line["calls"].append(shown)
        if lim:
            line["correct"], line["failed"], line["check"] = check.judge(numbers, lim)
            if args.control:
                line["control_correct"], line["control_failed"], line["control_check"] = check.judge(
                    [n["control"] for n in numbers], lim)
        line["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del r
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
