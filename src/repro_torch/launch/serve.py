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

With ``--fabric {pair_sar,flash,hybrid}`` the model is also mapped onto one
chip's CiM fabric (``repro_torch.fabric``) before serving: the batching log
line carries the per-request fabric cost, one bit-plane matmul runs through
the fabric executor as a validation pass, and the rollup's markdown follows.

CLI::

    python -m repro_torch.launch.serve --arch smollm-135m --cim fake_quant
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --reduced --cim fake_quant
    python -m repro_torch.launch.serve --arch mamba2-130m --cim fake_quant
    python -m repro_torch.launch.serve --arch smollm-135m --cim bitplane
    python -m repro_torch.launch.serve --arch smollm-135m --fabric hybrid --fabric-arrays 60

Meshes of more than one chip (``--fabric-chips 4|16``, ``--fabric-mesh``,
``--fabric-backend shard_map``), ``--fabric-program``, ``--fabric-scan``,
``--fabric-autotune`` and the ``--obs-*`` options of the JAX serve CLI wait
for their ports (ROADMAP.md, port queues A6-A9) and are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.device import resolve_device
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


def validation_matmul(fabric, device="cuda") -> torch.Tensor:
    """The fabric validation pass of ``serve --fabric`` on one chip: a
    (2, rows) @ (rows, cols) matmul of ``normal(PRNGKey(0))`` and
    ``normal(fold_in(PRNGKey(0), 1))`` draws through the bit-plane fabric
    executor (4/4 bits, the fabric's ADC and rows) on ``device``. On one chip
    the JAX package's sharded executor is this matmul bit for bit."""
    from repro_torch.core import prng
    from repro_torch.fabric import execute_matmul, map_matmul

    device = resolve_device(device)
    m, k, n = 2, fabric.rows, fabric.cols
    key = prng.PRNGKey(0, device)
    x = prng.normal(key, (m, k))
    w = prng.normal(prng.fold_in(key, 1), (k, n))
    cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=fabric.adc_bits, rows=fabric.rows, ste=False)
    return execute_matmul(x, w, fabric, cim, placement=map_matmul("smoke", m, k, n, fabric, cim=cim))


def fabric_rollup(cfg: ModelConfig, fabric, tokens: int, device="cuda") -> dict:
    """Map ``cfg`` onto one chip's ``fabric`` for one batched forward pass
    of ``tokens`` tokens and roll it up (``fabric_report``), run the
    validation pass (:func:`validation_matmul`) and record the execution
    backend: on one chip it is the sequential chip loop, as the JAX
    package's ``auto`` resolves it."""
    from repro_torch.fabric import fabric_report, map_model

    rollup = fabric_report(map_model(cfg, fabric, tokens=tokens), fabric)
    validation_matmul(fabric, device)
    rollup["exec_backend"] = "sequential"
    n_dev = torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1
    print(f"[serve] fabric exec backend: sequential ({n_dev} {resolve_device(device).type} device(s) for 1 chip(s))")
    return rollup


@dataclasses.dataclass
class ServeSettings:
    batch: int = 4
    prompt_len: int = 32
    gen_len: int = 32
    seed: int = 0
    greedy: bool = True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        _sync(device)
        t0 = time.time()
        with obs_trace.span("serve.prefill", batch=b, prompt_len=s):
            cache = model.make_cache(b, total)
            logits, cache = model.prefill(params, torch.as_tensor(prompts, device=device), cache)
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            _sync(device)
        t_prefill = time.time() - t0

        out_tokens = [next_tok]
        t0 = time.time()
        with obs_trace.span("serve.decode", batch=b, gen_len=st.gen_len):
            for i in range(st.gen_len - 1):
                logits, cache = model.decode_step(params, next_tok, s + i, cache)
                next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                out_tokens.append(next_tok)
            _sync(device)
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
        # registry replace the static cost-model printout. The one-chip port
        # writes the conversions (fabric executor) and EMA bits (here); the
        # JAX line's fused/fallback and link counters wait for their
        # producers (ROADMAP.md, port queues A6-A8)
        obs_metrics.inc(
            "fabric_ema_bits_total", fab["onchip_ema_bits_per_request"] * b,
            help="On-chip external-memory-access bits for requests served.",
        )
        conv = obs_metrics.get_value("fabric_conversions_total")
        obs_trace.event("serve.request_summary", batch=b, total_tokens=total, conversions=conv)
        print(
            f"[serve] obs batch {b}x{total} tok on {fab['n_chips']} chip(s) "
            f"[{fab['exec_backend']}]: {conv:.3g} conversions; est. "
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
        help="also map the model onto one chip's CiM fabric and print the "
        "area/energy/latency/EMA rollup (repro_torch.fabric)",
    )
    ap.add_argument("--fabric-arrays", type=int, default=256)
    ap.add_argument(
        "--fabric-chips", type=int, default=1, choices=[1, 4, 16],
        help="chips of the fabric mesh; the port runs 1 (4 and 16 wait for ROADMAP.md A6)",
    )
    ap.add_argument(
        "--fabric-mesh", default=None, metavar="DxM",
        help="explicit (data x model) chip mesh; the port runs 1x1 (larger meshes wait for ROADMAP.md A6)",
    )
    ap.add_argument(
        "--fabric-backend", default="auto", choices=["auto", "sequential", "shard_map"],
        help="chip execution backend of the validation pass: on one chip auto "
        "is sequential (shard_map waits for ROADMAP.md A6)",
    )
    for flag, queue in (("--fabric-program", "A7"), ("--fabric-scan", "A7"), ("--fabric-autotune", "A8")):
        ap.add_argument(flag, action="store_true", help=f"waits for ROADMAP.md {queue}")
    args = ap.parse_args(argv)
    mesh = (1, 1)
    if args.fabric_mesh:
        try:
            mesh = parse_fabric_mesh(args.fabric_mesh)
        except ValueError as e:
            ap.error(str(e))
    unported = [
        name for name, given in (
            (f"--fabric-chips {args.fabric_chips}", args.fabric_chips > 1),
            (f"--fabric-mesh {args.fabric_mesh}", mesh != (1, 1)),
            ("--fabric-backend shard_map", args.fabric_backend == "shard_map"),
            ("--fabric-program", args.fabric_program),
            ("--fabric-scan", args.fabric_scan),
            ("--fabric-autotune", args.fabric_autotune),
        ) if given
    ]
    if unported:
        ap.error(
            f"{', '.join(unported)}: the port serves one chip; meshes, the fused program "
            "and graph and the autotuner wait for their ports (ROADMAP.md, port queues A6-A9)"
        )

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.cim:
        cfg = dataclasses.replace(cfg, cim=CiMConfig(mode=args.cim, ste=False))
    st = ServeSettings(
        batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len, seed=args.seed
    )
    rollup = None
    if args.fabric:
        from repro_torch.fabric import FabricConfig

        # map BEFORE serving so the batching log line carries the per-request
        # fabric cost; one mapped pass covers the lock-step batch (tokens = batch)
        fabric = FabricConfig(mode=args.fabric, n_arrays=args.fabric_arrays)
        rollup = fabric_rollup(cfg, fabric, st.batch, args.device)
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


if __name__ == "__main__":
    main()
