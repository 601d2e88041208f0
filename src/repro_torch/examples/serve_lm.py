"""Batched serving on the port (counterpart of the JAX package's
``examples/serve_lm.py``): prefill and lock-step greedy decode over a request
batch of a 4-layer smollm-family model (d 128, d_ff 384) with seeded random
weights, optionally with CiM-quantized inference: ``--cim`` runs every linear
through the CiM fake-quant kernel (rows 64, 8-bit ADC).

Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--cim] [--batch 4] [--gen-len 24] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.device import resolve_device
from repro_torch.launch.serve import ServeSettings, serve_batch

__all__ = ["main", "run", "example_config"]


def example_config(cim: bool = False):
    """The served model: smollm-135m reduced to 4 layers, d 128, d_ff 384;
    with ``cim``, fake-quant linears at rows 64 with an 8-bit ADC."""
    cfg = reduced(ARCHS["smollm-135m"], n_layers=4, d_model=128, d_ff=384)
    if cim:
        cfg = dataclasses.replace(
            cfg, cim=CiMConfig(mode="fake_quant", adc_bits=8, rows=64, ste=False)
        )
    return cfg


def run(cim: bool = False, batch: int = 4, gen_len: int = 24, device="cuda") -> dict:
    """Serve one batch of 32-token prompts on ``device``; returns
    ``serve_batch``'s dict. ``batch`` and ``gen_len`` default to the JAX
    script's."""
    device = resolve_device(device)
    out = serve_batch(example_config(cim), ServeSettings(batch=batch, prompt_len=32, gen_len=gen_len),
                      device=device)
    mode = "CiM fake-quant" if cim else "exact"
    print(f"[{mode}] prefill {out['prefill_s']*1e3:.0f} ms, "
          f"decode {out['decode_tok_s']:.1f} tok/s")
    for i, row in enumerate(out["generated"][:2]):
        print(f"  request {i}: {row[:12].tolist()} ...")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cim", action="store_true", help="CiM fake-quant inference")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(cim=args.cim, batch=args.batch, gen_len=args.gen_len, device=args.device)


if __name__ == "__main__":
    main()
