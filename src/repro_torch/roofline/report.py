"""Render the roofline tables from cached dry-run JSON (counterpart of
``repro.roofline.report``).

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/torch_dryrun]

A one-process step counts no collectives (``roofline.analysis``), so the
JAX package's ``t_collective`` and top-collective columns, its
``collective_schedule`` and its most collective-bound cells have no
counterpart.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

__all__ = ["load", "next_lever", "roofline_table", "summary", "main"]


def _fmt_t(s) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.1f}ms"
    return f"{s * 1e6:.0f}us"


def load(dir_: Path, mesh: str):
    recs = []
    for f in sorted(dir_.glob(f"*__{mesh}.json")):
        r = json.loads(f.read_text())
        recs.append(r)
    return recs


def next_lever(rec) -> str:
    """One sentence: what would move the dominant term down on the H100."""
    rf = rec["roofline"]
    arch, shape, b = rec["arch"], rec["shape"], rf["bottleneck"]
    is_ssm = arch.startswith(("mamba", "zamba"))
    if b == "memory":
        if "decode" in shape or "long" in shape:
            return "int8 KV cache + int8 weight dots (int8_dot) cut the dominant cache/weight reads from HBM"
        if is_ssm:
            return "fuse the SSD chunk pipeline into a CUDA kernel so decay/state tiles stay in shared memory"
        if "prefill" in shape:
            return "the flash-attention CUDA kernel (attn_impl=\"flash\") keeps score tiles in shared memory"
        return "fuse the elementwise chains (quantization, norms, casts) into CUDA kernels; quantize each weight once a step"
    return "raise arithmetic intensity: larger per-device batch or wider TP sharding of heads"


def roofline_table(recs) -> str:
    hdr = (
        "| arch | shape | t_compute | t_memory | bottleneck | "
        "mem/dev | MODEL/HLO flops | roofline frac | what would move the dominant term |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in recs:
        if r.get("status") != "ok":
            rows.append(
                f"| {r['arch']} | {r['shape']} | FAIL | | | | | | {r.get('error','')[:40]} |"
            )
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(rf['t_compute'])} | "
            f"{_fmt_t(rf['t_memory'])} | "
            f"{rf['bottleneck']} | {r['memory']['bytes']/2**30:.2f}GiB | "
            f"{rf['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{next_lever(r)} |"
        )
    return hdr + "\n".join(rows) + "\n"


def summary(recs) -> dict:
    """The worst roofline fractions."""
    ok = [r for r in recs if r.get("status") == "ok"]
    worst = sorted(ok, key=lambda r: r["roofline_fraction"])[:5]
    return {
        "n_ok": len(ok),
        "n_fail": len(recs) - len(ok),
        "worst_fraction": [(r["arch"], r["shape"], round(r["roofline_fraction"], 4)) for r in worst],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/torch_dryrun")
    ap.add_argument("--mesh", default="singlepod")
    args = ap.parse_args()
    recs = load(Path(args.dir), args.mesh)
    print(roofline_table(recs))
    print(json.dumps(summary(recs), indent=2))


if __name__ == "__main__":
    main()
