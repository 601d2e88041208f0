#!/usr/bin/env python3
"""Time the serve path's two kernels of one checkout on the GPU: K1 (CiM
fake-quant matmul) at one layer's seven linears, prefill (M 1024) and decode
(M 4), and K2 (flash attention) at the serve shape.

    python3 kernel_times.py [--root DIR] [--label NAME]

``DIR`` (default: this script's directory) is the root of a checkout of this
repository whose ``src/repro_torch`` has the wrappers
``cim_matmul_fq(x, w, rows=, step=)`` and ``flash_attention(q, k, v,
sm_scale=)``, as every tree of the port has. The inputs come from fixed seeds,
so two checkouts timed in turns in one process each (``--root old``, ``--root
.``, ``--root .``, ``--root old``) see the same inputs on the same card. Each
time is printed twice: the device's time with the launches queued behind a
sleep (``chip_smoke.time_ms``), and the time of the calls as the host paces
them, wrapper included. The last line is one JSON object of the
numbers. It needs a CUDA device and imports nothing of JAX.
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
    args = ap.parse_args()
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
    from repro_torch.kernels.cim_matmul import cim_matmul_fq
    from repro_torch.kernels.flash_attention import flash_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build()
    gen = torch.Generator(device="cuda").manual_seed(11)
    step = 10922.5  # the default CiMConfig: rows 16, 5-bit ADC, 8/8-bit signed operands
    res = {"label": label, "card": card, "k1": {}}
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
    b, h, kv, s, hd = 4, 9, 3, 256, 64
    q = torch.randn((b, h, s, hd), generator=gen, device="cuda") * hd ** -0.5
    k = torch.randn((b, kv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, kv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
    run = lambda: flash_attention(q, k, v, sm_scale=1.0)  # noqa: E731
    res["k2_device_ms"], res["k2_paced_ms"] = time_ms(run), time_ms(run, queued=False)
    print(f"[{label}] K2 B{b} H{h} KV{kv} S{s} hd{hd} (q f32, k/v bf16): device {res['k2_device_ms']:.4f} ms, "
          f"host-paced {res['k2_paced_ms']:.4f} ms")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
