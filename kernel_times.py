#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the GPU: K1 (CiM fake-quant
matmul) at one layer's seven linears, prefill (M 1024) and decode (M 4); K2
(flash attention) at the serve shape; K3 (bit-plane CiM matmul) at one layer's
seven linears, prefill and decode, at the ops defaults (rows 128, 8-bit ADC,
8/8 bits) and at the chip geometry (rows 16, 5-bit ADC, 4/4 bits); K4 (ideal
ADC) on 1024 x 1024 values.

    python3 kernel_times.py [--root DIR] [--label NAME] [--only k1,k2,k3,k4]

``DIR`` (default: this script's directory) is the root of a checkout of this
repository whose ``src/repro_torch`` has the wrappers
``cim_matmul_fq(x, w, rows=, step=)``, ``flash_attention(q, k, v,
sm_scale=)``, ``cim_matmul_bp(x, w, rows=, adc_bits=, a_bits=, w_bits=)`` and
``adc_quant(v, bits=)``, as every tree of the port since its second slice
has. The inputs come from fixed seeds, so two checkouts timed in turns in one
process each (``--root old``, ``--root .``, ``--root .``, ``--root old``) see
the same inputs on the same card. Each
time is printed twice: the device's time with the launches queued behind a
sleep (``chip_smoke.time_ms``), and the time of the calls as the host paces
them, wrapper included. ``--only`` times a subset of the kernels (default:
all four). The last line is one JSON object of the numbers. It needs a CUDA
device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
LAYER_LINEARS = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536), (576, 1536), (1536, 576)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="root of the checkout whose kernels are timed")
    ap.add_argument("--label", default=None, help="name printed with every line (default: the root)")
    ap.add_argument("--only", default="k1,k2,k3,k4", help="comma-separated kernels to time (default: all)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= {"k1", "k2", "k3", "k4"}:
        ap.error(f"--only takes k1, k2, k3, k4; got {args.only}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available; this script runs on a GPU only", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    label = args.label or str(root)
    sys.path.insert(0, str(HERE))
    from chip_smoke import time_ms

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.adc_quant import adc_quant
    from repro_torch.kernels.cim_matmul import cim_matmul_bp, cim_matmul_fq
    from repro_torch.kernels.flash_attention import flash_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build()
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {"label": label, "card": card}
    if "k1" in only:
        time_k1(res, label, gen, cim_matmul_fq, time_ms)
    if "k2" in only:
        time_k2(res, label, gen, flash_attention, time_ms)
    if "k3" in only:
        time_k3(res, label, gen, cim_matmul_bp, time_ms)
    if "k4" in only:
        v = torch.rand((1024, 1024), generator=gen, device="cuda")
        run = lambda: adc_quant(v, bits=5)  # noqa: E731
        res["k4_device_ms"], res["k4_paced_ms"] = time_ms(run), time_ms(run, queued=False)
        print(f"[{label}] K4 1024 x 1024, 5 bits: device {res['k4_device_ms']:.5f} ms, "
              f"host-paced {res['k4_paced_ms']:.5f} ms")
    print(card)
    print(json.dumps(res))
    return 0


def time_k1(res, label, gen, cim_matmul_fq, time_ms):
    import torch

    step = 10922.5  # the default CiMConfig: rows 16, 5-bit ADC, 8/8-bit signed operands
    res["k1"] = {}
    for m in (1024, 4):
        for k, n in sorted(set(LAYER_LINEARS)):
            x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
            run = lambda: cim_matmul_fq(x, w, rows=16, step=step)  # noqa: E731
            dev, paced = time_ms(run), time_ms(run, queued=False)
            res["k1"][f"M{m} K{k} N{n}"] = {"device_ms": dev, "paced_ms": paced}
            print(f"[{label}] K1 M{m} K{k} N{n}: device {dev:.4f} ms, host-paced {paced:.4f} ms")
    for m, name in ((1024, "prefill"), (4, "decode")):
        for key in ("device_ms", "paced_ms"):
            res[f"k1_{name}_layer_{key}"] = sum(res["k1"][f"M{m} K{k} N{n}"][key] for k, n in LAYER_LINEARS)
        print(f"[{label}] K1 one {name} layer (7 linears, M {m}): device {res[f'k1_{name}_layer_device_ms']:.4f} ms, "
              f"host-paced {res[f'k1_{name}_layer_paced_ms']:.4f} ms")


def time_k2(res, label, gen, flash_attention, time_ms):
    import torch

    b, h, kv, s, hd = 4, 9, 3, 256, 64
    q = torch.randn((b, h, s, hd), generator=gen, device="cuda") * hd ** -0.5
    k = torch.randn((b, kv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, kv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
    run = lambda: flash_attention(q, k, v, sm_scale=1.0)  # noqa: E731
    res["k2_device_ms"], res["k2_paced_ms"] = time_ms(run), time_ms(run, queued=False)
    print(f"[{label}] K2 B{b} H{h} KV{kv} S{s} hd{hd} (q f32, k/v bf16): device {res['k2_device_ms']:.4f} ms, "
          f"host-paced {res['k2_paced_ms']:.4f} ms")


def time_k3(res, label, gen, cim_matmul_bp, time_ms):
    import torch

    res["k3"] = {}
    for geo, rows, adc, bits in (("defaults", 128, 8, 8), ("chip", 16, 5, 4)):
        for m in (1024, 4):
            for k, n in sorted(set(LAYER_LINEARS)):
                kp = -(-k // rows) * rows  # K padded to whole tiles, as the op pads it
                x = torch.randint(0, 1 << bits, (m, kp), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
                w = torch.randint(0, 1 << bits, (kp, n), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
                run = lambda: cim_matmul_bp(x, w, rows=rows, adc_bits=adc, a_bits=bits, w_bits=bits)  # noqa: E731
                dev, paced = time_ms(run), time_ms(run, queued=False)
                res["k3"][f"{geo} M{m} K{kp} N{n}"] = {"device_ms": dev, "paced_ms": paced}
                print(f"[{label}] K3 {geo} M{m} K{kp} N{n}: device {dev:.4f} ms, host-paced {paced:.4f} ms")
            name = "prefill" if m == 1024 else "decode"
            for key in ("device_ms", "paced_ms"):
                res[f"k3_{geo}_{name}_layer_{key}"] = sum(
                    res["k3"][f"{geo} M{m} K{-(-k // rows) * rows} N{n}"][key] for k, n in LAYER_LINEARS)
            print(f"[{label}] K3 one {name} layer ({geo}, 7 linears, M {m}): "
                  f"device {res[f'k3_{geo}_{name}_layer_device_ms']:.4f} ms, "
                  f"host-paced {res[f'k3_{geo}_{name}_layer_paced_ms']:.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
