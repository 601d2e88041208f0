"""Dry-run planner: plan every (arch × shape) cell on the production meshes
(or a ``--mesh DxM`` plan such as ``1x1``, one H100), count its step and
record resident bytes and the roofline against one H100 (counterpart of
``repro.launch.dryrun``, which lowers and compiles each cell with XLA).

Nothing is allocated on any device and no XLA flag is set: the params,
optimizer state, caches and inputs are shape-only stand-ins
(``launch.steps``), the resident bytes per device come exactly from the
plan's shard shapes (``launch.shardings.shard_shape``), and the roofline's
FLOPs and bytes come from ``roofline.op_stats`` over the cell's step run
once on fake tensors.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k [--mesh 1x1]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/torch_dryrun]

Results are cached per (arch, shape, mesh) in JSON; re-runs skip green cells.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import SHAPES, valid_cells
from repro_torch.launch import shardings as shmod
from repro_torch.launch.mesh import make_chip_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell, count_step
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import roofline
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["resident_bytes", "run_cell", "main"]

DEFAULT_OUT = Path("results/torch_dryrun")


def resident_bytes(cell, mesh) -> int:
    """Bytes one device holds of the cell's arguments (weights, optimizer
    state, caches, batch) under the plan: each leaf's shard shape times its
    item size."""
    sizes = tree_map(
        lambda t, spec: math.prod(shmod.shard_shape(mesh, t.shape, spec)) * t.element_size(),
        cell.args, cell.in_shardings,
    )
    return sum(tree_leaves(sizes))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, force=False, mesh=None):
    """Plan and count one cell; ``mesh`` (a mesh object) replaces the
    production mesh and names the record by its shape (``1x1``)."""
    if mesh is None:
        mesh_tag = "multipod" if multi_pod else "singlepod"
    else:
        mesh_tag = "x".join(str(v) for v in mesh.shape.values())
    out_file = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out_file.exists() and not force:
        rec = json.loads(out_file.read_text())
        if rec.get("status") == "ok":
            print(f"[cache] {arch} × {shape_name} × {mesh_tag}: ok")
            return rec

    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    try:
        # scope fallback recording to THIS cell
        with shmod.record_fallbacks() as cell_fallbacks:
            mesh = mesh or make_production_mesh(multi_pod=multi_pod)
            n_dev = mesh.size
            cell = build_cell(arch, shape_name, mesh)
        t_build = time.time() - t0
        resident = resident_bytes(cell, mesh)
        stats = count_step(cell)
        t_count = time.time() - t0 - t_build
        mem_stats = {"bytes": resident, "fits_one_h100": resident <= hw.HBM_BYTES}
        rep = roofline(arch, SHAPES[shape_name], cell.cfg, stats, n_dev, mem_stats)
        rec.update(
            status="ok",
            n_devices=n_dev,
            build_s=round(t_build, 1),
            count_s=round(t_count, 1),
            memory=mem_stats,
            fallbacks=list(cell_fallbacks),
            roofline=rep.to_dict(),
            roofline_fraction=rep.roofline_fraction,
            kernels=stats.kernels,
            n_ops=stats.n_ops,
        )
        print(
            f"[ok] {arch} × {shape_name} × {mesh_tag}: "
            f"count {t_count:.0f}s, mem/dev {resident/2**30:.2f} GiB "
            f"(fits one H100: {'yes' if mem_stats['fits_one_h100'] else 'no'}), "
            f"t=(c {rep.t_compute * 1e3:.2f} | m {rep.t_memory * 1e3:.2f}) ms, bottleneck={rep.bottleneck}, "
            f"MODEL/HLO={rep.useful_ratio:.2f}"
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {arch} × {shape_name} × {mesh_tag}: {e}")

    out_dir.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def _mesh_arg(text: str):
    data, model = (int(v) for v in text.lower().split("x"))
    return make_chip_mesh(data, model)


def main():
    ap = argparse.ArgumentParser(
        description="Plan and count (arch × shape) cells against one H100. Allocates nothing on any "
                    "device and sets no XLA flag: stand-ins are shape-only and the step runs on fake tensors."
    )
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None, type=_mesh_arg,
                    help="a (data, model) plan DxM instead of the production mesh, e.g. 1x1 (one H100)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()
    out_dir = Path(args.out)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = []
    if args.all:
        for arch, cfg in ARCHS.items():
            for shp in valid_cells(cfg):
                cells.append((arch, shp))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    n_ok = n_fail = 0
    for multi in meshes:
        for arch, shp in cells:
            rec = run_cell(arch, shp, multi, out_dir, force=args.force, mesh=args.mesh)
            if rec.get("status") == "ok":
                n_ok += 1
            else:
                n_fail += 1
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
