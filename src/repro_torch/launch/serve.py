"""Batched serving of the PyTorch port (counterpart of
``repro.launch.serve``): one batched prefill, then lock-step greedy decode.

Supports the paper's CiM-quantized inference modes: with ``--cim fake_quant``
every linear runs the CiM fake-quant CUDA kernel; with ``--cim bitplane`` every
linear is the faithful bit-plane simulation with the noiseless
memory-immersed SAR ADC (``core.cim_linear``, plain PyTorch as in the JAX
package). With ``attn_impl="flash"`` every prefill layer runs the
flash-attention CUDA kernel.

CLI::

    python -m repro_torch.launch.serve --arch smollm-135m --cim fake_quant
    python -m repro_torch.launch.serve --arch smollm-135m --cim bitplane

The ``--fabric*`` and ``--obs-*`` options of the JAX serve CLI are not ported
yet (ROADMAP.md, port queue A).
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

__all__ = ["ServeSettings", "serve_batch", "compiled_model"]


@functools.lru_cache(maxsize=8)
def compiled_model(cfg: ModelConfig, seed: int, device: str = "cuda"):
    """Build ``cfg`` on ``device`` and initialize it from a ``torch.Generator``
    seeded with ``seed``, once per ``(cfg, seed, device)``, so repeated
    ``serve_batch`` calls reuse the weights. Returns ``(model, params)``."""
    model = build_model(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model, model.init(gen)


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
):
    """Serve one static batch on ``device``: returns a dict with tokens and
    timing (``prompts``, ``generated``, ``prefill_s``, ``decode_s``,
    ``decode_tok_s``) and the last decode step's ``logits`` (B, 1, V).

    ``params`` are the weights to serve (``models.weights.params_from_jax``
    converts the JAX package's); by default the seeded random init of
    :func:`compiled_model`."""
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

    return {
        "prompts": prompts,
        "generated": torch.stack(out_tokens, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": b * (st.gen_len - 1) / max(t_decode, 1e-9),
        "logits": logits,
    }


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.cim:
        cfg = dataclasses.replace(cfg, cim=CiMConfig(mode=args.cim, ste=False))
    st = ServeSettings(
        batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len, seed=args.seed
    )
    out = serve_batch(cfg, st, device=args.device)
    print(
        f"[serve] {args.arch} on {args.device}: prefill {out['prefill_s']*1e3:.1f} ms, "
        f"decode {out['decode_tok_s']:.1f} tok/s "
        f"(batch {st.batch}, +{st.gen_len} tokens)"
    )
    print("[serve] sample generation:", out["generated"][0][:16].tolist())


if __name__ == "__main__":
    main()
