"""Perf hillclimb: re-plan and re-count named variants of the three
chosen cells on the single-pod production mesh against one H100
(counterpart of ``repro.launch.hillclimb``). Baselines live in
``results/torch_dryrun``. Nothing is allocated on any device.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--variant NAME]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs.registry import for_shape, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.launch.dryrun import resident_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell, count_step
from repro_torch.roofline.analysis import roofline

__all__ = ["VARIANTS", "run_variant", "main"]

OUT = Path("results/torch_hillclimb")


def _cfg(arch, shape, **over):
    cfg = for_shape(get_config(arch), SHAPES[shape])
    return dataclasses.replace(cfg, **over) if over else cfg


# variant name -> (arch, shape, cfg overrides)
VARIANTS = {
    # Cell A: llama3-405b train_4k — memory-bound (mixed-precision materialization)
    "A_llama405b_train/opt_mixed_precision": ("llama3-405b", "train_4k", {}),
    # A3: smaller attention KV chunk — fewer bytes per materialized score tile
    "A_llama405b_train/opt_chunk512": (
        "llama3-405b",
        "train_4k",
        {"attn_chunk": 512},
    ),
    # Cell B: qwen3-moe train_4k — collective-bound (dispatch elimination)
    "B_qwen3moe_train/opt_dense_moe": (
        "qwen3-moe-30b-a3b",
        "train_4k",
        {"moe_impl": "dense"},
    ),
    # B2: dense MoE on the runner-up (moonshot)
    "B_moonshot_train/opt_dense_moe": (
        "moonshot-v1-16b-a3b",
        "train_4k",
        {"moe_impl": "dense"},
    ),
    # Cell C: command-r-plus decode_32k — memory-bound serving
    # C1: int8 weight/activation dots (the paper's low-precision product-sums)
    "C_commandr_decode/opt_int8_weights": (
        "command-r-plus-104b",
        "decode_32k",
        {"cim": CiMConfig(mode="int8_dot", ste=False)},
    ),
    # C2: + int8 KV cache
    "C_commandr_decode/opt_int8_weights_kv": (
        "command-r-plus-104b",
        "decode_32k",
        {"cim": CiMConfig(mode="int8_dot", ste=False), "kv_quant_int8": True},
    ),
    # C2b: int8 KV cache alone (ablation)
    "C_commandr_decode/opt_int8_kv_only": (
        "command-r-plus-104b",
        "decode_32k",
        {"kv_quant_int8": True},
    ),
}


def run_variant(name: str, force: bool = False, out: Path = OUT):
    """Plan and count one variant on the single-pod production mesh."""
    arch, shape_name, over = VARIANTS[name]
    out_file = out / (name.replace("/", "__") + ".json")
    if out_file.exists() and not force:
        rec = json.loads(out_file.read_text())
        if rec.get("status") == "ok":
            print(f"[cache] {name}")
            return rec
    t0 = time.time()
    rec = {"variant": name, "arch": arch, "shape": shape_name}
    try:
        mesh = make_production_mesh()
        cell = build_cell(arch, shape_name, mesh, cfg_override=_cfg(arch, shape_name, **over))
        resident = resident_bytes(cell, mesh)
        rep = roofline(arch, SHAPES[shape_name], cell.cfg, count_step(cell), mesh.size, {"bytes": resident})
        rec.update(
            status="ok",
            count_s=round(time.time() - t0, 1),
            memory={"bytes": resident},
            roofline=rep.to_dict(),
            roofline_fraction=rep.roofline_fraction,
        )
        print(
            f"[ok] {name}: t=(c {rep.t_compute:.2f} | m {rep.t_memory:.2f}) s, mem/dev {resident/2**30:.2f} GiB, "
            f"bottleneck={rep.bottleneck}, frac={rep.roofline_fraction:.4f}"
        )
    except Exception as e:  # noqa: BLE001
        rec.update(status="fail", error=str(e), traceback=traceback.format_exc()[-3000:])
        print(f"[FAIL] {name}: {e}")
    out.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def main():
    ap = argparse.ArgumentParser(description="Re-plan and re-count the hillclimb variants against one H100 "
                                             "(allocates nothing on any device).")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    names = [args.variant] if args.variant else list(VARIANTS)
    for n in names:
        run_variant(n, force=args.force)


if __name__ == "__main__":
    main()
