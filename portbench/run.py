"""The port's benchmark: one run of one workload on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It serves the workload's traffic with
``repro_torch.launch.serve.serve_batch`` for ``--seconds`` seconds (whole
cycles of the mix), checks what was served against the plain reference in
``portbench/reference``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the workload's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and ``check`` (each number compared, with
its limit). It exits non-zero, printing no result, without a card, with
fewer cards than the workload asks for, or where JAX or the JAX package was
loaded. The port builds its kernels once, into ``build/repro_torch_kernels/``
of the checkout; later runs there load them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` by default) whose top-level name is one
    of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    import torch

    from portbench import bench

    spec = bench.Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[portbench] {args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = bench.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] the run loaded {bad}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    for name, (value, limit) in out["check"].items():
        print(f"[portbench] check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
