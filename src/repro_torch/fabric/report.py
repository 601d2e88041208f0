"""Per-layer and end-to-end fabric rollups (area / energy / latency / EMA).

Rendered alongside ``roofline.report``'s tables: one row per mapped layer,
then chip-level totals and the paper's headline chip-level ratios —
digitization area vs the dedicated 40 nm SAR (~25x) and Flash (~51x) ADCs
(Table I), and the iso-area throughput comparison against a conventional-ADC
fabric of equal footprint.

The PyTorch counterpart of ``repro.fabric.report``: the same dicts and the
same markdown, for one chip (:func:`fabric_report`) and for a chip mesh
(:func:`sharded_fabric_report`, with the fused program's validation and
the forward graph's section, :func:`graph_section`), and the autotuner's
section (``fabric.autotune.autotune_section``) in :func:`render_markdown`.

  PYTHONPATH=src python -m repro_torch.fabric.report --arch smollm-135m --mode hybrid
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch.core.energy_area import area_um2, energy_pj
from repro_torch.fabric.mapper import LayerPlacement
from repro_torch.fabric.pipeline import (
    conversion_cycles,
    fabric_throughput,
    iso_area_comparison,
    overlapped_mesh_latency,
)
from repro_torch.fabric.topology import EMA_PJ_PER_BIT, ChipMeshConfig, FabricConfig

__all__ = ["fabric_report", "sharded_fabric_report", "graph_section", "render_markdown"]


def graph_section(graph, model_axis: int, program=None) -> dict:
    """The report's ``graph`` section for a ``ForwardGraph``: node-op
    census, the sibling branches the chain rollup undercounted, and the
    documented collective budget. ONE schema, shared by
    ``sharded_fabric_report(..., graph=...)`` and the serve rollup.

    ``program`` (a ``fabric.graph.GraphProgram``) attaches a ``scan``
    subsection when it was compiled with ``scan_layers=True``: the scan
    trip count, the per-block collective census and the out-of-scan tail's
    budget — ``census × n_blocks + tail`` sums to the section's
    ``collective_budget`` (the link traffic is identical; only trace and
    compile cost change).

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import graph_section, model_forward_graph
        >>> g = model_forward_graph(get_config("smollm-135m"), 4, block_only=True)
        >>> sec = graph_section(g, 2)
        >>> sec["n_matmuls"], sec["collective_budget"]["all_gather"]
        (7, 1)
    """
    ops: dict = {}
    for nd in graph.nodes:
        ops[nd.op] = ops.get(nd.op, 0) + 1
    sec = {
        "n_nodes": len(graph.nodes),
        "ops": ops,
        "n_matmuls": len(graph.matmul_nodes),
        "siblings": graph.sibling_names(),
        "collective_budget": graph.collective_budget(model_axis),
    }
    if program is not None and getattr(program, "scan_layers", False):
        sec["scan"] = {
            "n_blocks": program.n_blocks,
            "block_census": program.block_graph.block_census(model_axis),
            "tail_budget": program.tail_graph.collective_budget(model_axis),
        }
    return sec


def _layer_row(
    p: LayerPlacement,
    fabric: FabricConfig,
    rate_per_compute: float,
    model_resident: bool,
) -> dict:
    cycles = conversion_cycles(p, rate_per_compute)
    e_conv = energy_pj(
        fabric.adc_style,
        fabric.adc_bits,
        vdd=fabric.vdd,
        flash_bits=fabric.flash_bits,
        flash_share=fabric.n_cim_per_group,
    )
    # steady-state EMA per forward pass: activations always stream; weights
    # re-fetch unless the WHOLE model stays resident — a layer that fits by
    # itself is still evicted when later layers overwrite its arrays
    ema_bits = p.activation_bits + (0 if model_resident else p.weight_load_bits)
    return {
        **p.stats(),
        "latency_cycles": cycles,
        "latency_s": cycles / fabric.freq_hz,
        "digitization_energy_pj": p.conversions * e_conv,
        "ema_bits_per_pass": ema_bits,
        "ema_energy_pj": ema_bits * EMA_PJ_PER_BIT,
    }


def _chip_sections(fabric: FabricConfig, tp: dict, n_conversions: int) -> dict:
    """Placement-independent report sections: chip + paper ratios + iso-area."""
    sections = {
        "chip": {
            "mode": fabric.mode,
            "n_arrays": fabric.resolved_n_arrays(),
            "n_compute_arrays": fabric.n_compute_arrays,
            "chip_area_mm2": fabric.chip_area_um2() / 1e6,
            "chip_adc_area_mm2": fabric.chip_adc_area_um2() / 1e6,
            "weight_capacity_bits": fabric.weight_capacity_bits(),
            **tp,
        }
    }
    if not fabric.mode.startswith("conventional"):
        n_arr = fabric.resolved_n_arrays()
        sections["paper_ratios"] = {
            # chip-level digitization-area ratios vs dedicated 40nm ADCs
            "adc_area_ratio_vs_sar": (n_arr * area_um2("sar", fabric.adc_bits))
            / fabric.chip_adc_area_um2(),
            "adc_area_ratio_vs_flash": (n_arr * area_um2("flash", fabric.adc_bits))
            / fabric.chip_adc_area_um2(),
        }
        sections["iso_area"] = iso_area_comparison(fabric, n_conversions)
    return sections


def fabric_report(
    placements: List[LayerPlacement],
    fabric: FabricConfig,
    n_conversions: int = 96,
) -> dict:
    """Roll a list of layer placements up into the chip-level report.

    Example::

        >>> from repro_torch.fabric import FabricConfig, fabric_report, map_matmul
        >>> fb = FabricConfig(mode="hybrid", n_arrays=60)
        >>> rep = fabric_report([map_matmul("l", 1, 64, 64, fb)], fb)
        >>> sorted(rep)
        ['chip', 'iso_area', 'layers', 'paper_ratios', 'totals']
    """
    tp = fabric_throughput(fabric, n_conversions)
    rate_per_compute = (
        tp["group_conversions_per_cycle"] / fabric.compute_arrays_per_group
    )
    total_tiles = sum(p.n_weight_tiles for p in placements)
    model_resident = total_tiles <= fabric.n_compute_arrays
    layers = [
        _layer_row(p, fabric, rate_per_compute, model_resident) for p in placements
    ]
    totals = {
        "tiles": total_tiles,
        "model_resident": model_resident,
        "conversions": sum(r["conversions"] for r in layers),
        "latency_cycles": sum(r["latency_cycles"] for r in layers),
        "latency_s": sum(r["latency_s"] for r in layers),
        "digitization_energy_pj": sum(r["digitization_energy_pj"] for r in layers),
        "ema_bits_per_pass": sum(r["ema_bits_per_pass"] for r in layers),
        "ema_energy_pj": sum(r["ema_energy_pj"] for r in layers),
        "weight_program_bits": sum(r["weight_load_bits"] for r in layers),
    }
    return {
        **_chip_sections(fabric, tp, n_conversions),
        "layers": layers,
        "totals": totals,
    }


def sharded_fabric_report(
    sharded: list,
    chip_mesh: ChipMeshConfig,
    n_conversions: int = 96,
    measured: Optional[dict] = None,
    graph=None,
    program=None,
) -> dict:
    """Mesh-level rollup of :class:`~repro_torch.fabric.shard.ShardedPlacement`\\ s.

    Layer rows keep the single-chip columns — ``conversions``, digitization
    energy, and on-chip ``ema_bits_per_pass`` are mesh totals (summed over
    active chips); ``latency_cycles`` is the per-chip critical path (chips
    run in parallel) — and add the mesh's new cost columns:
    ``crosschip_bits_per_pass`` (ring reduce-scatter traffic combining the
    K-parallel partial sums), its link energy, and its link latency.
    Residency is per chip: each model-axis chip only has to hold its own
    K-shard.

    ``measured`` (a ``fabric.program.measure_forward`` dict) attaches the
    fused program's measured-vs-modeled link-latency validation as a
    ``program_validation`` section.

    ``graph`` (a ``fabric.mapper.ForwardGraph`` whose matmul nodes produced
    ``sharded``) attaches a ``graph`` section — node taxonomy, the sibling
    branches the chain rollup undercounted, and the documented collective
    budget (:func:`graph_section`). ``program`` additionally threads a
    scanned ``GraphProgram``'s per-block census into the section; the
    budget totals are identical scan or unroll.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, shard_model, sharded_fabric_report
        >>> cm = ChipMeshConfig(model=4, fabric=FabricConfig(mode="hybrid", n_arrays=60))
        >>> sps = shard_model(get_config("smollm-135m"), cm, tokens=4, block_only=True)
        >>> rep = sharded_fabric_report(sps, cm)
        >>> rep["mesh"]["n_chips"], rep["totals"]["crosschip_bits_per_pass"] > 0
        (4, True)
    """
    fabric = chip_mesh.fabric
    tp = fabric_throughput(fabric, n_conversions)
    rate_per_compute = tp["group_conversions_per_cycle"] / fabric.compute_arrays_per_group
    # residency is per chip: every chip must hold its shard of EVERY layer
    chip_tiles = sum(sp.chip.n_weight_tiles for sp in sharded)
    mesh_resident = chip_tiles <= fabric.n_compute_arrays

    layers = []
    for sp in sharded:
        base = _layer_row(sp.chip, fabric, rate_per_compute, mesh_resident)
        active = sp.n_chips_active
        layers.append(
            {
                **base,
                "layer": sp.name,
                "m": sp.m,
                "k": sp.k,
                "n": sp.n,
                "k_splits": sp.k_splits,
                "d_splits": sp.d_splits,
                "chips_active": active,
                # mesh totals (chips run the same shard cost in parallel)
                "conversions": base["conversions"] * active,
                "digitization_energy_pj": base["digitization_energy_pj"] * active,
                "weight_load_bits": base["weight_load_bits"] * active,
                "ema_bits_per_pass": base["ema_bits_per_pass"] * active,
                "ema_energy_pj": base["ema_energy_pj"] * active,
                "crosschip_bits_per_pass": sp.crosschip_bits_per_pass,
                "crosschip_energy_pj": sp.crosschip_energy_pj,
                "crosschip_latency_s": sp.crosschip_latency_s,
                "latency_total_s": base["latency_s"] + sp.crosschip_latency_s,
            }
        )
    totals = {
        "tiles_per_chip": chip_tiles,
        "model_resident": mesh_resident,
        "conversions": sum(r["conversions"] for r in layers),
        "latency_cycles": sum(r["latency_cycles"] for r in layers),
        "latency_s": sum(r["latency_total_s"] for r in layers),
        "digitization_energy_pj": sum(r["digitization_energy_pj"] for r in layers),
        "ema_bits_per_pass": sum(r["ema_bits_per_pass"] for r in layers),
        "ema_energy_pj": sum(r["ema_energy_pj"] for r in layers),
        "weight_program_bits": sum(r["weight_load_bits"] for r in layers),
        "crosschip_bits_per_pass": sum(r["crosschip_bits_per_pass"] for r in layers),
        "crosschip_energy_pj": sum(r["crosschip_energy_pj"] for r in layers),
        "crosschip_latency_s": sum(r["crosschip_latency_s"] for r in layers),
    }
    # double-buffered rounds: layer i's reduce-scatter overlaps layer i+1's
    # conversion schedule (fabric.pipeline.overlap_rounds)
    overlap = overlapped_mesh_latency(sharded, n_conversions)
    totals["latency_s_overlapped"] = overlap["overlapped_latency_s"]
    totals["crosschip_latency_hidden_s"] = overlap["hidden_link_s"]
    totals["link_hidden_fraction"] = overlap["link_hidden_fraction"]
    report = {
        "mesh": {
            "shape": {"data": chip_mesh.data, "model": chip_mesh.model},
            "n_chips": chip_mesh.n_chips,
            "total_area_mm2": chip_mesh.total_area_um2() / 1e6,
            "total_weight_capacity_bits": chip_mesh.total_weight_capacity_bits(),
            "link_bits_per_s": chip_mesh.link_bits_per_s,
            "link_pj_per_bit": chip_mesh.link_pj_per_bit,
            "psum_bits": chip_mesh.psum_bits,
            "fallbacks": [f for sp in sharded for f in sp.fallbacks],
        },
        **_chip_sections(fabric, tp, n_conversions),
        "layers": layers,
        "totals": totals,
    }
    if graph is not None:
        report["graph"] = graph_section(graph, chip_mesh.model, program=program)
    if measured is not None:
        report["program_validation"] = measured
    return report


def render_markdown(report: dict, max_layers: Optional[int] = 24) -> str:
    """Markdown tables in the roofline.report house style.

    Handles both single-chip (``fabric_report``) and mesh
    (``sharded_fabric_report``) reports; mesh reports gain a header line and
    split / cross-chip-traffic columns.

    Example::

        >>> from repro_torch.fabric import FabricConfig, fabric_report, map_matmul, render_markdown
        >>> fb = FabricConfig(mode="hybrid", n_arrays=60)
        >>> md = render_markdown(fabric_report([map_matmul("l", 1, 64, 64, fb)], fb))
        >>> md.splitlines()[0].startswith("### fabric: hybrid — 60 arrays")
        True
    """
    mesh = report.get("mesh")
    chip = report["chip"]
    out = [
        f"### fabric: {chip['mode']} — {chip['n_arrays']} arrays "
        f"({chip['n_compute_arrays']} compute), {chip['chip_area_mm2']:.3f} mm^2 "
        f"(ADC {chip['chip_adc_area_mm2']:.4f} mm^2), "
        f"{chip['chip_conversions_per_s']:.3g} conv/s"
        + (" per chip" if mesh else ""),
    ]
    if mesh:
        out.append(
            f"**mesh:** {mesh['shape']['data']}x{mesh['shape']['model']} "
            f"(data x model) = {mesh['n_chips']} chips, "
            f"{mesh['total_area_mm2']:.3f} mm^2 total, links "
            f"{mesh['link_bits_per_s']/1e9:.3g} Gbit/s @ "
            f"{mesh['link_pj_per_bit']:.3g} pJ/bit"
            + (f", {len(mesh['fallbacks'])} sharding fallback(s)"
               if mesh["fallbacks"] else "")
        )
    xcol = " KxD split | xchip/pass (bits) |" if mesh else ""
    out += [
        "",
        "| layer | MxKxN | tiles | rounds | resident | conv | lat (cyc) | "
        f"E_dig (pJ) | EMA/pass (bits) |{xcol}",
        "|---|---|---|---|---|---|---|---|---|" + ("---|---|" if mesh else ""),
    ]
    layers = report["layers"]
    shown = layers if max_layers is None else layers[:max_layers]
    for r in shown:
        xcell = (
            f" {r['k_splits']}x{r['d_splits']} | {r['crosschip_bits_per_pass']:.3g} |"
            if mesh
            else ""
        )
        out.append(
            f"| {r['layer']} | {r['m']}x{r['k']}x{r['n']} | {r['tiles']} | "
            f"{r['rounds']} | {'y' if r['resident'] else 'n'} | {r['conversions']:.3g} | "
            f"{r['latency_cycles']:.3g} | {r['digitization_energy_pj']:.3g} | "
            f"{r['ema_bits_per_pass']:.3g} |" + xcell
        )
    if max_layers is not None and len(layers) > max_layers:
        out.append(
            f"| ... {len(layers) - max_layers} more layers ... | | | | | | | | |"
            + (" | |" if mesh else "")
        )
    t = report["totals"]
    tiles_key = "tiles_per_chip" if mesh else "tiles"
    out += [
        "",
        f"**totals:** {t[tiles_key]} tiles{' per chip' if mesh else ''} "
        f"({'model-resident' if t['model_resident'] else 'rounds needed'}), "
        f"{t['conversions']:.3g} conversions, {t['latency_s']*1e3:.3g} ms, "
        f"{t['digitization_energy_pj']/1e6:.3g} uJ digitization, "
        f"{t['ema_energy_pj']/1e6:.3g} uJ on-chip external-memory"
        + (
            f", {t['crosschip_bits_per_pass']:.3g} bits / "
            f"{t['crosschip_energy_pj']/1e6:.3g} uJ cross-chip reduce-scatter"
            + (
                f", {t['latency_s_overlapped']*1e3:.3g} ms with double-buffered "
                f"round overlap ({t.get('link_hidden_fraction', 0.0)*100:.0f}% of "
                f"link time hidden)"
                if "latency_s_overlapped" in t
                else ""
            )
            if mesh
            else ""
        ),
    ]
    if "graph" in report:
        g = report["graph"]
        ops = ", ".join(f"{v} {k}" for k, v in sorted(g["ops"].items()))
        budget = g["collective_budget"]
        kinds = sorted({s.split(".")[-1] for s in g["siblings"]})
        out += [
            "",
            f"**forward graph:** {g['n_nodes']} nodes ({ops}); "
            f"{len(g['siblings'])} sibling branch(es)"
            + (f" ({'/'.join(kinds)})" if kinds else "")
            + " costed — the chain rollup skipped them; collective budget "
            f"{budget['reduce_scatter']} reduce-scatter + "
            f"{budget['all_gather']} all-gather, {budget['pmax']} "
            f"re-quantization boundaries"
            + (
                f"; scanned: block traced once, {g['scan']['n_blocks']} "
                "lax.scan iterations (census × n_blocks + tail == budget)"
                if "scan" in g
                else ""
            ),
        ]
    if "program_validation" in report:
        pv = report["program_validation"]
        ratio = pv.get("measured_over_modeled")
        meas = pv.get("measured_collective_s")
        line = (
            f"**fused program** ({pv.get('n_layers', '?')} layers, "
            f"{pv.get('backend', '?')}): "
        )
        if pv.get("fused_s") is not None:
            line += (
                f"forward {pv['fused_s']*1e3:.3g} ms wall vs per-layer loop "
                f"{pv['per_layer_s']*1e3:.3g} ms "
                f"({pv.get('fused_speedup_vs_per_layer', 0.0):.2f}x); "
            )
        line += (
            f"collectives measured "
            f"{'n/a' if meas is None else f'{meas*1e3:.3g} ms wall'} vs modeled "
            f"link {pv.get('modeled_link_s', 0.0)*1e3:.3g} ms fabric-time"
            + (f" (calibration ratio {ratio:.3g})" if ratio is not None else "")
        )
        out += ["", line]
    if "autotune" in report:
        at = report["autotune"]
        line = (
            f"**autotune:** mesh {at['mesh']}, buckets "
            f"{'/'.join(str(b) for b in at['buckets'])}; expected "
            f"{at['expected_latency_s']*1e3:.3g} ms/request vs baseline "
            f"{at['baseline_latency_s']*1e3:.3g} ms "
            f"({at['speedup_vs_baseline']:.2f}x, {at['searched']} plans searched)"
        )
        cachest = at.get("cache")
        if cachest:
            line += (
                f"; cache {cachest['hits']} hit(s) / {cachest['misses']} "
                f"miss(es), {cachest['pad_waste_rows']} pad row(s), "
                f"{cachest['compiles']} compile(s)"
            )
        out += ["", line]
    if "paper_ratios" in report:
        pr = report["paper_ratios"]
        iso = report["iso_area"]
        out += [
            "",
            f"**paper ratios (chip level):** ADC area vs dedicated SAR "
            f"{pr['adc_area_ratio_vs_sar']:.1f}x, vs dedicated Flash "
            f"{pr['adc_area_ratio_vs_flash']:.1f}x (paper: ~25x / ~51x)",
            f"**iso-area vs {iso['conventional']['mode']}:** "
            f"{iso['array_count_ratio']:.2f}x arrays, "
            f"{iso['throughput_ratio']:.2f}x chip throughput "
            f"({iso['in_memory']['chip_conversions_per_cycle']:.2f} vs "
            f"{iso['conventional']['chip_conversions_per_cycle']:.2f} conv/cycle)",
        ]
    return "\n".join(out)


def main():
    from repro_torch.configs.registry import get_config
    from repro_torch.fabric.mapper import map_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--mode", default="hybrid", choices=("pair_sar", "flash", "hybrid"))
    ap.add_argument("--arrays", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=1)
    ap.add_argument("--block-only", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    fabric = FabricConfig(mode=args.mode, n_arrays=args.arrays)
    placements = map_model(
        get_config(args.arch), fabric, tokens=args.tokens, block_only=args.block_only
    )
    report = fabric_report(placements, fabric)
    if args.json:
        print(json.dumps(report, indent=2, default=float))
    else:
        print(render_markdown(report))


if __name__ == "__main__":
    main()
