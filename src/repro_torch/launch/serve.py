"""Batched serving of the PyTorch port (counterpart of
``repro.launch.serve``): one batched prefill, then lock-step greedy decode,
for every registered arch (dense and MoE transformers, the Mamba2 stack and
the Zamba2 hybrid).

Supports the paper's CiM-quantized inference modes: with ``--cim fake_quant``
every linear runs the CiM fake-quant CUDA kernel (but the MoE router, and
the experts of ``moe_impl="dense"``, which are plain products as in the JAX
package); with ``--cim bitplane`` every
linear is the faithful bit-plane simulation with the noiseless
memory-immersed SAR ADC (``core.cim_linear``, plain PyTorch as in the JAX
package). With ``attn_impl="flash"`` every prefill layer runs the
flash-attention CUDA kernel.

With ``--fabric {pair_sar,flash,hybrid}`` the model is also mapped onto a
CiM fabric (``repro_torch.fabric``) before serving — one chip, or a
``(data, model)`` chip mesh with ``--fabric-chips 4|16`` (2x2, 4x4) or
``--fabric-mesh DxM``, every chip on the one device: the batching log line
carries the per-request fabric cost, one bit-plane matmul runs through the
sharded executor on the resolved backend (``--fabric-backend``) as a
validation pass, and the rollup's markdown follows. ``--fabric-program``
also runs a fused forward against its reference loop and reports its
measured-vs-modeled link time: the full transformer-block graph
(``fabric.compile_graph_forward``: one block, or the whole model in the scan
form with ``--fabric-scan``) on the ``dense`` and ``moe`` families, the
residual chain of one block (``fabric.compile_forward``) on ``mamba`` and
``hybrid``. ``--fabric-autotune`` picks the mesh and batch buckets from the
graph cost model for a ragged request mix (``fabric.autotune``) and serves
one ragged batch through the bucketed program cache against the per-node
reference. ``--obs-log``, ``--obs-metrics`` and ``--obs-metrics-out``
stream ``repro_torch.obs`` events to JSONL and print (or write) the
Prometheus exposition, as the JAX serve CLI does.

CLI::

    python -m repro_torch.launch.serve --arch smollm-135m --cim fake_quant
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --reduced --cim fake_quant
    python -m repro_torch.launch.serve --arch mamba2-130m --cim fake_quant
    python -m repro_torch.launch.serve --arch smollm-135m --cim bitplane
    python -m repro_torch.launch.serve --arch smollm-135m --fabric hybrid --fabric-arrays 60
    python -m repro_torch.launch.serve --arch smollm-135m --cim fake_quant --fabric hybrid \\
        --fabric-chips 4 --fabric-backend shard_map
    python -m repro_torch.launch.serve --arch smollm-135m --cim fake_quant --fabric hybrid \\
        --fabric-mesh 1x3 --fabric-program [--fabric-scan] [--fabric-autotune]
    python -m repro_torch.launch.serve --arch mamba2-130m --fabric hybrid --fabric-mesh 1x2 --fabric-program
    python -m repro_torch.launch.serve --arch smollm-135m --reduced --obs-metrics --obs-log events.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "ServeSettings", "serve_batch", "compiled_model", "parse_fabric_mesh", "fabric_rollup", "validation_matmul",
]


@functools.lru_cache(maxsize=8)
def compiled_model(cfg: ModelConfig, seed: int, device: str = "cuda"):
    """Build ``cfg`` on ``device`` and initialize it from a ``torch.Generator``
    seeded with ``seed``, once per ``(cfg, seed, device)``, so repeated
    ``serve_batch`` calls reuse the weights. Returns ``(model, params)``."""
    model = build_model(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model, model.init(gen)


def parse_fabric_mesh(spec: str) -> tuple:
    """Parse a ``--fabric-mesh`` ``DxM`` spec (e.g. ``2x4``) into
    ``(data, model)``; both axes must be >= 1.

    Example::

        >>> parse_fabric_mesh("2x4")
        (2, 4)
    """
    parts = spec.lower().replace(" ", "").split("x")
    if len(parts) != 2:
        raise ValueError(f"--fabric-mesh wants DxM (e.g. 2x4), got {spec!r}")
    try:
        data, model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"--fabric-mesh wants integer axes, got {spec!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    return data, model


def validation_matmul(fabric, device="cuda", chip_mesh=None, backend: str = "sequential") -> torch.Tensor:
    """The fabric validation pass of ``serve --fabric``: a
    ``(2·data, model·rows) @ (model·rows, cols)`` matmul of
    ``normal(PRNGKey(0))`` and ``normal(fold_in(PRNGKey(0), 1))`` draws
    through the sharded bit-plane executor (4/4 bits, the fabric's ADC and
    rows) on ``backend``, on ``device``; the JAX package's validation matmul
    bit for bit. ``chip_mesh`` defaults to one chip of ``fabric``."""
    from repro_torch.core import prng
    from repro_torch.fabric import ChipMeshConfig, execute_sharded_matmul, map_matmul, shard_placement

    device = resolve_device(device)
    cm = chip_mesh if chip_mesh is not None else ChipMeshConfig(fabric=fabric)
    m, k, n = 2 * cm.data, cm.model * fabric.rows, fabric.cols
    key = prng.PRNGKey(0, device)
    x = prng.normal(key, (m, k))
    w = prng.normal(prng.fold_in(key, 1), (k, n))
    cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=fabric.adc_bits, rows=fabric.rows, ste=False)
    sp = shard_placement(map_matmul("smoke", m, k, n, fabric), cm)
    return execute_sharded_matmul(x, w, cm, cim, sharded=sp, backend=backend)


def _program_validation(cfg: ModelConfig, chip_mesh, tokens: int, backend: str, device: torch.device,
                        scan: bool, rollup: dict) -> dict:
    """``serve --fabric-program``: a fused forward (bit-plane, 4/4 bits)
    against its reference loop, and ``measure_forward``'s
    measured-vs-modeled link time. On the ``dense`` and ``moe`` families the
    full transformer-block graph (one block, or with ``scan`` the whole model
    in the scan form; its ``graph`` section goes into ``rollup``) on
    ``(tokens, 1, d)`` embeddings; on the others the residual chain of one
    block. Prints one line and returns ``measure_forward``'s dict, with the
    fused forward's largest difference from the loop as
    ``max_abs_diff_vs_per_layer``."""
    from repro_torch.core import prng
    from repro_torch.fabric import measure_forward

    fb = chip_mesh.fabric
    val_cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=fb.adc_bits, rows=fb.rows, ste=False)
    if cfg.family in ("dense", "moe"):
        from repro_torch.fabric import compile_graph_forward, graph_section

        # --fabric-scan validates the FULL model in the scan form; otherwise one block
        prog = compile_graph_forward(cfg, chip_mesh, cim=val_cim, backend=backend, tokens=tokens,
                                     block_only=not scan, scan_layers=scan)
        xp = prng.normal(prng.PRNGKey(2, device), (tokens, 1, prog.d_in))
        rollup["graph"] = graph_section(prog.graph, chip_mesh.model, program=prog)
        if scan:
            desc = f"graph: scanned {prog.n_blocks}-block model ({len(prog.placements)} matmuls, block traced once)"
        else:
            desc = f"graph: {len(prog.graph.nodes)}-node block ({len(prog.placements)} matmuls)"
        ref_name = "per-node loop"
    else:
        from repro_torch.fabric import compile_forward

        prog = compile_forward(cfg, chip_mesh, cim=val_cim, backend=backend, tokens=tokens, block_only=True)
        xp = prog.example_input(prng.PRNGKey(2, device))
        desc = f"chain: {prog.n_layers}-layer block"
        ref_name = "per-layer loop"
    wsp = prog.random_weights(prng.PRNGKey(3, device))
    maxdiff = float((prog(xp, wsp) - prog.reference_forward(xp, wsp, backend="sequential")).abs().max())
    # reference baseline on the sequential loop: the auto-fallback path, and
    # cheap enough to keep serving startup interactive
    measured = measure_forward(prog, x=xp, weights=wsp, iters=1, per_layer_backend="sequential", per_layer_iters=1)
    measured["max_abs_diff_vs_per_layer"] = maxdiff
    mc = measured.get("measured_collective_s")
    print(
        f"[serve] fused {desc} on {prog.backend}"
        + (f" (fallback: {'; '.join(prog.problems)})" if prog.problems else "")
        + f", maxdiff {maxdiff:.2e} vs {ref_name}; collectives "
        + (f"{mc*1e3:.3g} ms wall" if mc is not None else "n/a")
        + f" vs modeled link {measured['modeled_link_s']*1e3:.3g} ms"
    )
    return measured


def _autotune_validation(cfg: ModelConfig, fabric, batch: int, mesh: tuple, scan: bool, device: torch.device) -> dict:
    """``serve --fabric-autotune``: pick the mesh and batch buckets for a
    ragged request mix (every batch size 1..``batch``, uniform) from the
    graph cost model, then serve one ragged batch (one the plan's data axis
    does not divide, when there is one) through the bucketed program cache
    (bit-plane, 4/4 bits) against the per-node reference. Prints one line
    and returns the rollup's ``autotune`` section."""
    from repro_torch.core import prng
    from repro_torch.fabric import (
        BucketedGraphCache,
        ChipMeshConfig,
        autotune_plan,
        autotune_section,
        request_histogram,
    )

    at_cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=fabric.adc_bits, rows=fabric.rows, ste=False)
    hist = request_histogram(range(1, batch + 1))
    plan = autotune_plan(cfg, hist, mesh[0] * mesh[1], fabric, cim=at_cim, default_mesh=mesh)
    plan_cm = ChipMeshConfig(data=plan.data, model=plan.model, fabric=fabric)
    cache = BucketedGraphCache(cfg, plan_cm, at_cim, buckets=plan.buckets, block_only=not scan, scan_layers=scan)
    b_val = next((b for b in range(batch, 0, -1) if b % plan.data), batch)
    prog = cache.program_for(cache.bucket_for(b_val))
    w_at = prog.random_weights(prng.PRNGKey(3, device))
    x_at = prng.normal(prng.PRNGKey(2, device), (b_val, 1, prog.d_in))
    at_diff = float((cache(x_at, w_at) - prog.reference_forward(x_at, w_at)).abs().max())
    print(
        f"[serve] autotune: mesh {plan.data}x{plan.model}, buckets "
        f"{list(plan.buckets)} ({plan.searched} plans searched); "
        f"expected {plan.expected_latency_s*1e3:.3g} ms/request vs "
        f"baseline {plan.baseline_latency_s*1e3:.3g} ms; ragged "
        f"B={b_val} via bucketed fused path, maxdiff {at_diff:.2e} "
        f"vs per-node reference"
    )
    return autotune_section(plan, cache)


def fabric_rollup(
    cfg: ModelConfig,
    fabric,
    tokens: int,
    device="cuda",
    mesh: tuple = (1, 1),
    backend: str = "auto",
    program: bool = False,
    scan: bool = False,
    autotune: bool = False,
) -> dict:
    """Map ``cfg`` onto the fabric for one batched forward pass of
    ``tokens`` tokens and roll it up: one chip's ``fabric_report``, or the
    ``(data, model)`` ``mesh``'s ``sharded_fabric_report``. Then resolve the
    execution backend against the real placements (one layer with a
    replication fallback keeps the whole pass sequential, and an explicit
    ``shard_map`` fails on it), run the validation pass
    (:func:`validation_matmul`) on it and record it as ``exec_backend``.
    ``program`` adds the fused forward's validation (``program_validation``,
    and on ``dense`` / ``moe`` the ``graph`` section; ``scan`` runs the
    whole model in the scan form), ``autotune`` the autotuner's plan and
    bucketed batch (``autotune``)."""
    from repro_torch.fabric import (
        ChipMeshConfig,
        fabric_report,
        map_matmul,
        map_model,
        resolve_backend,
        shard_model,
        shard_placement,
        sharded_fabric_report,
    )

    device = resolve_device(device)
    cm = ChipMeshConfig(data=mesh[0], model=mesh[1], fabric=fabric)
    if cm.n_chips > 1:
        sps = shard_model(cfg, cm, tokens=tokens)
        rollup = sharded_fabric_report(sps, cm)
    else:
        sps = []
        rollup = fabric_report(map_model(cfg, fabric, tokens=tokens), fabric)
    smoke = shard_placement(map_matmul("smoke", 2 * cm.data, cm.model * fabric.rows, fabric.cols, fabric), cm)
    resolved = {resolve_backend(p, backend) for p in sps or [smoke]}
    exec_backend = "sequential" if "sequential" in resolved else "shard_map"
    validation_matmul(fabric, device, chip_mesh=cm, backend=exec_backend)
    rollup["exec_backend"] = exec_backend
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"[serve] fabric exec backend: {exec_backend} ({n_dev} {device.type} device(s) for {cm.n_chips} chip(s))")
    if program:
        rollup["program_validation"] = _program_validation(cfg, cm, tokens, backend, device, scan, rollup)
    if autotune:
        rollup["autotune"] = _autotune_validation(cfg, fabric, tokens, mesh, scan, device)
    return rollup


@dataclasses.dataclass
class ServeSettings:
    batch: int = 4
    prompt_len: int = 32
    gen_len: int = 32
    seed: int = 0
    greedy: bool = True


def serve_batch(
    cfg: ModelConfig,
    st: ServeSettings,
    prompts: Optional[np.ndarray] = None,
    device="cuda",
    params: Optional[dict] = None,
    fabric_rollup: Optional[dict] = None,
):
    """Serve one static batch on ``device``: returns a dict with tokens and
    timing (``prompts``, ``generated``, ``prefill_s``, ``decode_s``,
    ``decode_tok_s``) and the last decode step's ``logits`` (B, 1, V).

    ``params`` are the weights to serve (``models.weights.params_from_jax``
    converts the JAX package's); by default the seeded random init of
    :func:`compiled_model`.

    ``fabric_rollup`` (a ``fabric_report`` dict for ONE forward pass) turns
    the batching log line into a per-request cost model: estimated CiM
    latency / energy / EMA per request are printed with the batch and
    returned as ``out["fabric"]``. With ``repro_torch.obs`` metrics
    collection active the line is the per-request observability summary,
    read back from the live registry."""
    device = resolve_device(device)
    if params is None:
        model, params = compiled_model(cfg, st.seed, str(device))
    else:
        model = build_model(cfg, device)
    rng = np.random.default_rng(st.seed)
    if prompts is None:
        prompts = rng.integers(0, cfg.vocab, (st.batch, st.prompt_len)).astype(np.int32)
    b, s = prompts.shape
    total = s + st.gen_len

    with torch.inference_mode():
        synchronize(device)
        t0 = time.time()
        with obs_trace.span("serve.prefill", batch=b, prompt_len=s):
            cache = model.make_cache(b, total)
            logits, cache = model.prefill(params, torch.as_tensor(prompts, device=device), cache)
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            synchronize(device)
        t_prefill = time.time() - t0

        out_tokens = [next_tok]
        t0 = time.time()
        with obs_trace.span("serve.decode", batch=b, gen_len=st.gen_len):
            for i in range(st.gen_len - 1):
                with obs_trace.span("serve.decode_step", step=i):
                    logits, cache = model.decode_step(params, next_tok, s + i, cache)
                    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                    out_tokens.append(next_tok)
            synchronize(device)
        t_decode = time.time() - t0

    obs_metrics.inc("serve_requests_total", b, help="Requests served (batch slots).")
    obs_metrics.observe("serve_prefill_seconds", t_prefill, help="Batched prefill wall time.")
    obs_metrics.observe("serve_decode_seconds", t_decode, help="Batched decode wall time.")

    out = {
        "prompts": prompts,
        "generated": torch.stack(out_tokens, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": b * (st.gen_len - 1) / max(t_decode, 1e-9),
        "logits": logits,
    }
    if fabric_rollup is not None:
        out["fabric"] = _fabric_request_cost(fabric_rollup, b, s, st.gen_len, total)
    return out


def _fabric_request_cost(rollup: dict, b: int, s: int, gen_len: int, total: int) -> dict:
    """The per-request fabric cost of one served batch (the JAX package's
    ``serve_batch`` fabric dict), printed as the batching log line."""
    t = rollup["totals"]
    # the rollup maps one batched forward pass (tokens = batch); prefill runs
    # s token positions, decode gen_len - 1 more, so a request costs
    # (s + gen_len - 1) passes shared across the b requests of the batch
    passes = (s + gen_len - 1) / b
    xchip_bits = t.get("crosschip_bits_per_pass", 0)
    latency_s = t.get("latency_s_overlapped", t["latency_s"])
    fab = {
        "latency_s_per_request": latency_s * passes,
        "energy_uj_per_request": (
            t["digitization_energy_pj"] + t["ema_energy_pj"] + t.get("crosschip_energy_pj", 0.0)
        ) * passes / 1e6,
        "onchip_ema_bits_per_request": t["ema_bits_per_pass"] * passes,
        "crosschip_bits_per_request": xchip_bits * passes,
        "model_resident": t["model_resident"],
        "n_chips": rollup.get("mesh", {}).get("n_chips", 1),
        "exec_backend": rollup.get("exec_backend", "n/a"),
    }
    if obs_metrics.active():
        # the per-request observability summary line: live counters from the
        # registry (fed by the fabric layers + the validation pass) replace
        # the static cost-model printout
        obs_metrics.inc(
            "fabric_ema_bits_total", fab["onchip_ema_bits_per_request"] * b,
            help="On-chip external-memory-access bits for requests served.",
        )
        fused = obs_metrics.get_value("fabric_requests_total", path="fused")
        fell = obs_metrics.get_value("fabric_requests_total", path="fallback")
        conv = obs_metrics.get_value("fabric_conversions_total")
        bits = obs_metrics.get_value("fabric_link_bits_total")
        modeled = obs_metrics.get_value("fabric_modeled_link_seconds")
        measured = obs_metrics.get_value("fabric_measured_collective_seconds")
        calib = obs_metrics.get_value("fabric_link_clock_calibration")
        obs_trace.event(
            "serve.request_summary", batch=b, total_tokens=total,
            fused_requests=fused, fallback_requests=fell,
            conversions=conv, link_bits=bits,
            modeled_link_s=modeled, measured_collective_s=measured,
            link_clock_calibration=calib,
        )
        print(
            f"[serve] obs batch {b}x{total} tok on {fab['n_chips']} chip(s) "
            f"[{fab['exec_backend']}]: fused {fused:.0f} / fallback "
            f"{fell:.0f} requests; {conv:.3g} conversions, "
            f"{bits:.3g} link bits; link modeled {modeled:.3g} s vs "
            f"measured {measured:.3g} s "
            f"(link_clock_calibration {calib:.3g}); est. "
            f"{fab['latency_s_per_request']*1e3:.3g} ms, "
            f"{fab['energy_uj_per_request']:.3g} uJ per request"
        )
    else:
        print(
            f"[serve] batch {b}x{total} tok on {fab['n_chips']} chip(s) "
            f"[{fab['exec_backend']}]: est. "
            f"{fab['latency_s_per_request']*1e3:.3g} ms, "
            f"{fab['energy_uj_per_request']:.3g} uJ per request "
            f"(on-chip EMA {fab['onchip_ema_bits_per_request']:.3g} bits, "
            f"cross-chip {fab['crosschip_bits_per_request']:.3g} bits, "
            f"{'resident' if fab['model_resident'] else 'reloading'})"
        )
    return fab


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cim", default=None, choices=[None, "fake_quant", "bitplane"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--fabric", default=None, choices=[None, "pair_sar", "flash", "hybrid"],
        help="also map the model onto a CiM fabric (one chip or a chip mesh) and print the "
        "area/energy/latency/EMA rollup (repro_torch.fabric)",
    )
    ap.add_argument("--fabric-arrays", type=int, default=256)
    ap.add_argument(
        "--fabric-chips", type=int, default=1, choices=[1, 4, 16],
        help="square-mesh sugar for --fabric-mesh (1 -> 1x1, 4 -> 2x2, 16 -> 4x4; repro_torch.fabric.shard)",
    )
    ap.add_argument(
        "--fabric-mesh", default=None, metavar="DxM",
        help="explicit (data x model) chip mesh, e.g. 2x4; overrides the --fabric-chips sugar "
        "(passing both is an error)",
    )
    ap.add_argument(
        "--fabric-backend", default="auto", choices=["auto", "sequential", "shard_map"],
        help="chip execution backend of the validation pass, as the JAX package resolves it: "
        "sequential, shard_map, or auto (shard_map on a mesh without replication fallbacks; "
        "repro_torch.fabric.resolve_backend); every chip runs on the one device, in one chip loop",
    )
    ap.add_argument(
        "--fabric-program", action="store_true",
        help="run a fused forward as a validation pass and report measured-vs-modeled link latency: the "
        "full transformer-block graph (repro_torch.fabric.compile_graph_forward, one block) on dense and moe, "
        "one block's residual chain (repro_torch.fabric.compile_forward) on mamba and hybrid",
    )
    ap.add_argument(
        "--fabric-scan", action="store_true",
        help="run the --fabric-program graph validation pass in the scan form (scan_layers=True): the FULL "
        "model's repeated block over weights stacked on a layer axis (dense/moe families only)",
    )
    ap.add_argument(
        "--fabric-autotune", action="store_true",
        help="pick the (data x model) mesh and batch-bucket boundaries from the graph cost model "
        "(repro_torch.fabric.autotune) for a synthetic ragged request mix, then validate a ragged batch "
        "through the bucketed fused-program cache against the per-node reference",
    )
    ap.add_argument(
        "--obs-log", default=None, metavar="PATH",
        help="stream repro_torch.obs spans/events (fabric fallbacks, serve prefill/decode, request "
        "summaries) to PATH as JSONL",
    )
    ap.add_argument(
        "--obs-metrics", action="store_true",
        help="collect repro_torch.obs metrics for the whole run: the batching log becomes the per-request "
        "obs summary line and the Prometheus text exposition prints at exit",
    )
    ap.add_argument(
        "--obs-metrics-out", default=None, metavar="PATH",
        help="write the Prometheus exposition to PATH instead of stdout (implies --obs-metrics)",
    )
    args = ap.parse_args(argv)

    with contextlib.ExitStack() as stack:
        if args.obs_log:
            stack.enter_context(obs_trace.tracing(jsonl=args.obs_log))
        reg = None
        if args.obs_metrics or args.obs_metrics_out:
            reg = stack.enter_context(obs_metrics.collecting())
        out = _serve_main(args, ap)
        if args.obs_log:
            print(f"[serve] obs JSONL event log: {args.obs_log}")
        if reg is not None:
            if args.obs_metrics_out:
                from repro_torch.obs.sinks import write_prometheus

                write_prometheus(reg, args.obs_metrics_out)
                print(f"[serve] obs metrics exposition: {args.obs_metrics_out}")
            else:
                print("\n[serve] obs metrics exposition:")
                print(reg.prometheus_text(), end="")
    return out


def _serve_main(args, ap):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.cim:
        cfg = dataclasses.replace(cfg, cim=CiMConfig(mode=args.cim, ste=False))
    st = ServeSettings(
        batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len, seed=args.seed
    )
    # the JAX serve CLI's argument checks, in its order
    if (args.fabric_chips > 1 or args.fabric_mesh or args.fabric_program or args.fabric_autotune) and not args.fabric:
        ap.error("--fabric-chips/--fabric-mesh/--fabric-program/--fabric-autotune require --fabric")
    if args.fabric_autotune and cfg.family not in ("dense", "moe"):
        ap.error(f"--fabric-autotune needs a matmul-graph family (dense/moe); {args.arch} is {cfg.family!r}")
    if args.fabric_scan and not args.fabric_program:
        ap.error("--fabric-scan requires --fabric-program")
    if args.fabric_scan and cfg.family not in ("dense", "moe"):
        ap.error(f"--fabric-scan needs a matmul-graph family (dense/moe); {args.arch} is {cfg.family!r}")
    if args.fabric_mesh and args.fabric_chips > 1:
        ap.error("pass either --fabric-mesh or the --fabric-chips sugar, not both")
    if args.fabric_mesh:
        try:
            mesh = parse_fabric_mesh(args.fabric_mesh)
        except ValueError as e:
            ap.error(str(e))
    else:
        side = {1: 1, 4: 2, 16: 4}[args.fabric_chips]
        mesh = (side, side)

    rollup = None
    if args.fabric:
        from repro_torch.fabric import FabricConfig

        # map (and shard) BEFORE serving so the batching log line carries the
        # per-request fabric cost; one mapped pass covers the lock-step batch
        # (tokens = batch), which is what lets the mesh's data axis split work
        fabric = FabricConfig(mode=args.fabric, n_arrays=args.fabric_arrays)
        rollup = fabric_rollup(
            cfg, fabric, st.batch, args.device, mesh=mesh, backend=args.fabric_backend,
            program=args.fabric_program, scan=args.fabric_scan, autotune=args.fabric_autotune,
        )
    out = serve_batch(cfg, st, device=args.device, fabric_rollup=rollup)
    print(
        f"[serve] {args.arch} on {args.device}: prefill {out['prefill_s']*1e3:.1f} ms, "
        f"decode {out['decode_tok_s']:.1f} tok/s "
        f"(batch {st.batch}, +{st.gen_len} tokens)"
    )
    print("[serve] sample generation:", out["generated"][0][:16].tolist())
    if rollup is not None:
        from repro_torch.fabric import render_markdown

        print()
        print(render_markdown(rollup))
    return out

if __name__ == "__main__":
    main()
