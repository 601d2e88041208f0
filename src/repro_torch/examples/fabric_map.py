"""Map a smollm-135m attention+MLP block onto a hybrid CiM fabric, on the
port (counterpart of the JAX package's ``examples/fabric_map.py``).

  1. place the block's seven linears onto a hybrid (Fig. 3) fabric of
     collaborating 16x32 arrays;
  2. print the area / energy / latency / EMA rollup, with the paper's
     chip-level ADC area ratios (~25x vs dedicated SAR, ~51x vs Flash) and
     the iso-area throughput comparison against a conventional-ADC fabric;
  3. execute the mapped q_proj / gate_proj placements and check them against
     the unmapped ``cim_linear`` op: bit for bit in ``bitplane`` mode, within
     1e-4 in ``fake_quant`` (the CiM fake-quant kernel per column tile);
  4. shard the block across chip meshes (``fabric.shard``): the 1x1-mesh
     sharded run, under both backend names, equals the unsharded executor
     bit for bit, and the 2x2 rollup reduce-scatters over its links while a
     single chip has none;
  5. compile the block's forward chain (q -> o -> gate -> down) into one fused
     program (``fabric.compile_forward``), equal to the per-layer loop bit
     for bit, and report the measured-vs-modeled link time.

``--graph`` runs the full-transformer-block graph instead
(``fabric.compile_graph_forward``): ``init_transformer`` weights through the
fused graph against the per-node reference on 1x1 (bit for bit) and 2x2,
the collective census against its budget, the mesh rollup, and the scan
form over stacked layer weights, equal to the unrolled program with noisy
keys.

Runs on the card unless ``--device cpu``; every check raises on failure:

  PYTHONPATH=src python -m repro_torch.examples.fabric_map [--graph] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.core.cim_linear import CiMConfig, cim_linear
from repro_torch.device import resolve_device, synchronize
from repro_torch.fabric import (
    ChipMeshConfig,
    FabricConfig,
    compile_forward,
    compile_graph_forward,
    execute_linear,
    execute_matmul,
    execute_sharded_matmul,
    fabric_report,
    map_model,
    measure_forward,
    per_layer_forward,
    per_node_forward,
    render_markdown,
    resolve_backend,
    shard_model,
    sharded_fabric_report,
    stack_block_weights,
    transformer_graph_weights,
)
from repro_torch.models.transformer import init_transformer

__all__ = ["main", "graph_demo"]


def main(device="cuda") -> dict:
    """The chip-level checks on ``device``; returns what they measured."""
    device = resolve_device(device)
    cfg = get_config("smollm-135m")
    fabric = FabricConfig(mode="hybrid", rows=16, cols=32, adc_bits=5, n_arrays=252)
    placements = map_model(cfg, fabric, tokens=4, block_only=True)
    report = fabric_report(placements, fabric)
    print(render_markdown(report))

    ratios = report["paper_ratios"]
    iso = report["iso_area"]
    assert ratios["adc_area_ratio_vs_sar"] > 24, ratios
    assert ratios["adc_area_ratio_vs_flash"] > 50, ratios
    assert iso["throughput_ratio"] >= 1.0, iso

    # --- mapped vs unmapped numerics on real block shapes -------------------
    d, ff = cfg.d_model, cfg.d_ff
    key = prng.PRNGKey(0, device)
    x = prng.normal(key, (4, d))
    w_q = prng.normal(prng.fold_in(key, 1), (d, cfg.n_heads * cfg.head_dim))
    w_gate = prng.normal(prng.fold_in(key, 2), (d, ff))

    cim_bp = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
    for name, w in (("q_proj", w_q), ("gate_proj", w_gate)):
        exact = torch.equal(execute_linear(x, w, fabric=fabric, cim=cim_bp), cim_linear(x, w, cfg=cim_bp))
        print(f"[bitplane]   mapped {name} == unmapped cim_linear: {exact}")
        assert exact, f"{name}: mapped bitplane output diverged"

    cim_fq = CiMConfig(mode="fake_quant", a_bits=8, w_bits=8, adc_bits=5, rows=16, ste=False)
    y_map = execute_linear(x, w_q, fabric=fabric, cim=cim_fq)
    err = float((y_map - cim_linear(x, w_q, cfg=cim_fq)).abs().max())
    print(f"[fake_quant] mapped q_proj vs unmapped (the fake-quant kernel path on {device.type}): maxerr={err:.2e}")
    assert err < 1e-4, err

    # --- multi-chip sharding ------------------------------------------------
    cm1 = ChipMeshConfig(fabric=fabric)
    y_un = execute_matmul(x, w_q, fabric, cim_bp)
    for backend in ("auto", "shard_map"):
        exact = torch.equal(execute_sharded_matmul(x, w_q, cm1, cim_bp, backend=backend), y_un)
        print(f"[shard]      1x1-mesh sharded q_proj ({backend} backend) == unsharded execute: {exact}")
        assert exact, f"1x1-mesh sharded bitplane output diverged ({backend})"

    cm4 = ChipMeshConfig(data=2, model=2, fabric=fabric)
    sps4 = shard_model(cfg, cm4, tokens=4, block_only=True)
    print(f"[shard]      2x2 mesh auto backend: {resolve_backend(sps4[0], 'auto')} (every chip on one {device.type} device)")
    rep4 = sharded_fabric_report(sps4, cm4)
    print()
    print(render_markdown(rep4))
    t = rep4["totals"]
    assert t["crosschip_bits_per_pass"] > 0, "2x2 mesh should reduce-scatter"
    rep1 = sharded_fabric_report(shard_model(cfg, cm1, tokens=4, block_only=True), cm1)
    assert rep1["totals"]["crosschip_bits_per_pass"] == 0, "1 chip has no links"
    assert t["tiles_per_chip"] < rep1["totals"]["tiles_per_chip"], "K-split shrinks per-chip load"

    # --- the fused forward chain (fabric.program) ---------------------------
    prog = compile_forward(cfg, cm1, cim=cim_bp, tokens=4, block_only=True)
    print(f"\n[program]    block forward chain: {[sp.name for sp in prog.placements]} ({prog.backend})")
    xc = prng.normal(prng.PRNGKey(3, device), (prog.m, prog.placements[0].k))
    wsc = prog.random_weights(prng.PRNGKey(4, device))
    y_fused = prog(xc, wsc)
    exact = torch.equal(y_fused, per_layer_forward(xc, wsc, prog.placements, cm1, cim_bp, backend="sequential"))
    print(f"[program]    fused 1x1 forward == per-layer loop: {exact}")
    assert exact, "fused forward diverged from the per-layer loop"
    if prog.backend == "shard_map":
        counts = prog.collective_counts(xc, wsc)
        print(f"[program]    collectives in the whole forward: {counts}")
        assert counts["all_gather"] <= 1, "fused forward must gather at most once"
    meas = measure_forward(prog, x=xc, weights=wsc, iters=1, per_layer_backend="sequential", device=device)
    print(
        f"[program]    fused {meas.get('fused_s', float('nan'))*1e3:.3g} ms vs "
        f"per-layer loop {meas['per_layer_s']*1e3:.3g} ms host; modeled link "
        f"{meas['modeled_link_s']*1e3:.3g} ms"
    )
    print("\nfabric_map: all chip-level checks passed.")
    return {"fake_quant_err": err, "fused_s": meas.get("fused_s"), "per_layer_s": meas["per_layer_s"]}


def graph_demo(device="cuda") -> dict:
    """Full transformer block on the fabric with ``init_transformer``
    weights: fused graph forward vs the per-node reference, collective
    census vs budget, the mesh rollup, and the scan form."""
    device = resolve_device(device)
    # a graph-eligible dense config: every K tile-aligns with the mesh and
    # q/kv heads divide the model axis, so the fused program runs on 2x2
    cfg = ModelConfig(
        name="graph-demo", family="dense", n_layers=2, d_model=64, vocab=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, pad_vocab_multiple=16,
        param_dtype="float32", compute_dtype="float32",
    )
    fabric = FabricConfig(mode="pair_sar", rows=16, cols=32, n_arrays=8)
    cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
    params = init_transformer(torch.Generator(device=device).manual_seed(0), cfg)
    weights = transformer_graph_weights(params, cfg)
    x = prng.normal(prng.PRNGKey(1, device), (2, 4, cfg.d_model))

    out = {}
    for data, model in ((1, 1), (2, 2)):
        cm = ChipMeshConfig(data=data, model=model, fabric=fabric)
        prog = compile_graph_forward(cfg, cm, cim, tokens=8)
        print(f"[graph]      {data}x{model}: {len(prog.graph.nodes)} nodes "
              f"({len(prog.placements)} matmuls) on {prog.backend}")
        y = prog(x, weights)
        y_ref = per_node_forward(x, weights, prog.graph, prog.placements, cm, cim)
        maxdiff = float((y - y_ref).abs().max())
        print(f"[graph]      fused logits vs per-node reference: maxdiff {maxdiff:.3g}")
        if (data, model) == (1, 1):
            assert maxdiff == 0.0, "1x1 fused graph must be bit-exact"
        else:
            assert maxdiff < 1e-4, maxdiff
        if prog.backend == "shard_map":
            counts, budget = prog.collective_counts(x, weights), prog.collective_budget()
            print(f"[graph]      collectives {counts} == budget: {counts == budget}")
            assert counts == budget, (counts, budget)
        out[f"{data}x{model}"] = maxdiff
        if (data, model) == (2, 2):
            print()
            print(render_markdown(sharded_fabric_report(prog.placements, cm, graph=prog.graph)))

    # --- scan over layers: the block runs once per layer ---------------------
    cm1 = ChipMeshConfig(fabric=fabric)
    key = prng.PRNGKey(5, device)
    unrolled = compile_graph_forward(cfg, cm1, cim, tokens=8)
    scanned = compile_graph_forward(cfg, cm1, cim, tokens=8, scan_layers=True)
    runs = {}
    for prog, ws, tag in ((unrolled, weights, "unrolled"), (scanned, stack_block_weights(params, cfg), "scanned")):
        synchronize(device)
        t0 = time.perf_counter()
        runs[tag] = prog(x, ws, key=key)
        synchronize(device)
        print(f"[scan]       {tag}: first call {time.perf_counter() - t0:.2f} s host")
    exact = torch.equal(runs["unrolled"], runs["scanned"])
    print(f"[scan]       scanned ({scanned.n_blocks} block iterations) == unrolled logits, noisy keys included: {exact}")
    assert exact, "scan-over-layers diverged from the unrolled program"
    rep = sharded_fabric_report(scanned.placements, cm1, graph=scanned.graph, program=scanned)
    assert rep["graph"]["scan"]["n_blocks"] == cfg.n_layers
    print("\nfabric_map --graph: full-block fused forward checks passed.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", action="store_true",
                    help="the full-transformer-block fused graph forward with init_transformer weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    (graph_demo if args.graph else main)(args.device)
