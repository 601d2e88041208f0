#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's ``nvidia-smi`` name and power limit;
2. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the build seconds;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes and some edge shapes. K1 (CiM fake-quant
   matmul) must be bit-exact on integer inputs; K2 (flash attention) must
   agree within 2e-2 max-abs in bf16 and 1e-5 in float32, with the plain
   version and with the fp32 oracle. Each kernel's median time, its plain
   version's time, its bound at H100 peaks and, for K2, the time of
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the
   port never calls) are printed;
4. serve phase: ``serve_batch`` on smollm-135m at full width (30 layers,
   d 576, vocab 49152, bf16) with ``fake_quant`` CiM linears and flash
   prefill, batch 4, prompt 256, 16 generated tokens, random weights from a
   seeded generator, after one short warm-up call. Each kernel's launch
   count is zeroed just before the measured call and read just after: K1
   must launch >= 30*7*16 times, K2 exactly 30 times; logits must be finite
   and tokens in [0, vocab);
5. profile: the same serve call under ``torch.profiler`` for the device's
   busy time and the kernels that take the most of it;
6. agreement: the reduced smollm-135m (float32) on the card against the same
   weights on the CPU (plain versions), prefill and decode logits within
   1e-3 of max|logit|;
7. one JSON line of every kernel with its launches, times and bound, the
   card's line again, and the final ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM3 bytes/s, int8 tensor ops/s,
# bf16 tensor FLOP/s, float32 (non-tensor) FLOP/s.
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# K1 shapes of one layer's seven linears (K, N): q, k, v, o, gate, up, down.
LAYER_LINEARS = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536), (576, 1536), (1536, 576)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, batches: int = 7, iters: int = 20) -> float:
    """Median over ``batches`` of the mean time of ``iters`` launches
    (CUDA events), after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(n_bytes: float, ops: float, rate: float):
    """(bound ms, 'bytes' or 'operations'): the larger of bytes over the HBM
    rate and operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase_k1(torch, cmm, ref):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rand8 = lambda *shape: torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    max_err = 0.0
    # edge shapes: ragged M/N, rows 64 / adc 6, rows 10 (tiles padded to whole words)
    for m, k, n, rows, adc in [(77, 112, 45, 16, 5), (130, 192, 70, 64, 6), (33, 40, 17, 10, 5)]:
        step = ref.fake_quant_step(rows, adc, 8, 8, True, True)
        x, w = rand8(m, k), rand8(k, n)
        y, y_plain = cmm.cim_matmul_fq(x, w, rows=rows, step=step), cmm.cim_matmul_fq_plain(x, w, rows=rows, step=step)
        if not torch.equal(y, y_plain):
            raise AssertionError(f"K1 differs from its plain version at M{m} K{k} N{n} rows {rows}")
    step = ref.fake_quant_step(16, 5, 8, 8, True, True)  # the default CiMConfig
    per_shape = {}
    for m in (1024, 4):
        for k, n in sorted(set(LAYER_LINEARS)):
            x, w = rand8(m, k), rand8(k, n)
            run = lambda: cmm.cim_matmul_fq(x, w, rows=16, step=step)
            plain = lambda: cmm.cim_matmul_fq_plain(x, w, rows=16, step=step)
            y, y_plain = run(), plain()
            y_ref = ref.cim_matmul_ref(x.float(), w.float(), rows=16, adc_bits=5)
            err = max(float((y - y_plain).abs().max()), float((y - y_ref).abs().max()))
            if not torch.equal(y, y_plain):
                raise AssertionError(f"K1 is not bit-exact to its plain version at M{m} K{k} N{n}: {err}")
            max_err = max(max_err, err)
            n_bytes = m * k + k * n + 4 * m * n  # int8 operands in, float32 out
            b_ms, b_by = bound(n_bytes, 2 * m * k * n, INT8_OPS)
            per_shape[(m, k, n)] = (time_ms(run), time_ms(plain), b_ms, n_bytes / HBM_BPS * 1e3,
                                    2 * m * k * n / INT8_OPS * 1e3)
            ms, pms = per_shape[(m, k, n)][:2]
            print(f"[k1] M{m} K{k} N{n}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}), bit-exact")
    # the JSON entry: one prefill layer's seven linears at M = 1024
    layer = [per_shape[(1024, k, n)] for k, n in LAYER_LINEARS]
    t_bytes, t_ops = sum(s[3] for s in layer), sum(s[4] for s in layer)
    entry = {
        "name": "cim_matmul_fq",
        "route": "cuda",
        "source": "src/repro_torch/csrc/cim_matmul_fq.cu",
        "replaces": "src/repro/kernels/cim_matmul.py:37",
        "launches": None,
        "max_abs_err": max_err,
        "ms": sum(s[0] for s in layer),
        "plain_ms": sum(s[1] for s in layer),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    print(f"[k1] one prefill layer (7 linears, M 1024): kernel {entry['ms']:.4f} ms, "
          f"plain {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.5f} ms ({entry['bound_by']})")
    return entry


def kernel_phase_k2(torch, fa, ref):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    randn = lambda *shape, dt=torch.float32: torch.randn(shape, generator=gen, device="cuda").to(dt)
    max_err = 0.0

    def check(q, k, v, tol, pos=None, causal=True, sm_scale=None, rows=None):
        nonlocal max_err
        o = fa.flash_attention(q, k, v, pos, causal=causal, sm_scale=sm_scale)
        o_plain = fa.flash_attention_plain(q, k, v, pos, causal=causal, sm_scale=sm_scale)
        qr = q if rows is None else rows
        o_ref = ref.flash_attention_ref(qr, k, v, causal=causal, sm_scale=sm_scale)
        if rows is not None:
            o_ref = o_ref[:, :, pos.long()]
        assert o.dtype == q.dtype and o.shape == q.shape
        e_plain = float((o.float() - o_plain.float()).abs().max())
        e_ref = float((o.float() - o_ref.float()).abs().max())
        if not (e_plain <= tol and e_ref <= tol):
            raise AssertionError(
                f"K2 q{tuple(q.shape)} {q.dtype}/{k.dtype}: max-abs {e_plain:.3g} vs plain, "
                f"{e_ref:.3g} vs fp32 reference, tolerance {tol}"
            )
        max_err = max(max_err, e_plain, e_ref)
        print(f"[k2] q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}/{k.dtype} causal={causal}: "
              f"max-abs {e_plain:.3g} vs plain, {e_ref:.3g} vs fp32 reference (tol {tol})")

    b, h, kv, s, hd = 4, 9, 3, 256, 64
    # the serving path: q pre-scaled in float32, k/v bf16, sm_scale 1
    q_main = randn(b, h, s, hd) * hd ** -0.5
    k_main, v_main = randn(b, kv, s, hd, dt=torch.bfloat16), randn(b, kv, s, hd, dt=torch.bfloat16)
    check(q_main, k_main, v_main, 1e-5, sm_scale=1.0)
    check(randn(b, h, s, hd, dt=torch.bfloat16), k_main, v_main, 2e-2)
    check(randn(b, h, s, hd), randn(b, kv, s, hd), randn(b, kv, s, hd), 1e-5)
    # absolute q positions: a query shard against the full K/V
    q_full, k32, v32 = randn(b, h, s, hd), randn(b, kv, s, hd), randn(b, kv, s, hd)
    pos = torch.arange(128, 256, dtype=torch.int32, device="cuda")
    check(q_full[:, :, 128:].contiguous(), k32, v32, 1e-5, pos=pos, rows=q_full)
    # the JAX package's test shapes, and a head dim the kernel pads (80 -> 128)
    for bb, hh, kk, sq, sk, d, causal in [(2, 4, 2, 256, 256, 64, True), (1, 8, 8, 128, 384, 32, True),
                                           (2, 4, 1, 256, 256, 64, False), (1, 2, 2, 512, 512, 128, True),
                                           (1, 4, 2, 128, 128, 80, True)]:
        check(randn(bb, hh, sq, d), randn(bb, kk, sk, d), randn(bb, kk, sk, d), 1e-5, causal=causal)

    run = lambda: fa.flash_attention(q_main, k_main, v_main, sm_scale=1.0)
    plain = lambda: fa.flash_attention_plain(q_main, k_main, v_main, sm_scale=1.0)
    q_lib = q_main.to(torch.bfloat16)
    try:
        F.scaled_dot_product_attention(q_lib, k_main, v_main, is_causal=True, scale=1.0, enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(q_lib, k_main, v_main, is_causal=True, scale=1.0, enable_gqa=True)
    except TypeError:  # a torch without enable_gqa: expand the KV heads outside the timing
        k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k_main, v_main))
        lib = lambda: F.scaled_dot_product_attention(q_lib, k_rep, v_rep, is_causal=True, scale=1.0)
    pairs = b * h * s * (s + 1) // 2  # causal (query, key) pairs this input needs
    n_bytes = q_main.numel() * 4 + 2 * k_main.numel() * 2 + q_main.numel() * 4
    b_ms, b_by = bound(n_bytes, 4 * hd * pairs, FP32_FLOPS)  # q and the output are float32
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": None,
        "max_abs_err": max_err,
        "ms": time_ms(run),
        "plain_ms": time_ms(plain),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lib),
    }
    print(f"[k2] serving shape B{b} H{h} KV{kv} S{s} hd{hd} (q f32, k/v bf16): kernel {entry['ms']:.4f} ms, "
          f"plain {entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
          f"scaled_dot_product_attention (bf16) {entry['library_ms']:.4f} ms")
    return entry


def serve_phase(torch, cmm, fa):
    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.launch.serve import ServeSettings, serve_batch

    cfg = dataclasses.replace(
        get_config("smollm-135m"), cim=CiMConfig(mode="fake_quant", ste=False), attn_impl="flash"
    )
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.compute_dtype) == (30, 576, 49152, "bfloat16")
    st = ServeSettings(batch=4, prompt_len=256, gen_len=16, seed=0)
    # warm-up (weights initialized, allocator and libraries loaded), not counted
    serve_batch(cfg, dataclasses.replace(st, gen_len=2), device="cuda")
    cmm.launches = 0
    fa.launches = 0
    out = serve_batch(cfg, st, device="cuda")
    launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches}
    k1_min = cfg.n_layers * 7 * st.gen_len
    if launches["cim_matmul_fq"] < k1_min or launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"serve launches {launches}: want K1 >= {k1_min}, K2 == {cfg.n_layers}")
    gen = out["generated"]
    if gen.shape != (st.batch, st.gen_len) or gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"generated tokens out of range or shape: {gen.shape}, [{gen.min()}, {gen.max()}]")
    logits = out["logits"][..., : cfg.vocab]
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("serve logits are not finite")
    print(f"[serve] smollm-135m full width, fake_quant + flash, batch {st.batch}, prompt {st.prompt_len}, "
          f"gen {st.gen_len}: prefill {out['prefill_s']:.4f} s "
          f"({st.batch * st.prompt_len / out['prefill_s']:.1f} tok/s), decode {out['decode_s']:.4f} s "
          f"({out['decode_tok_s']:.1f} tok/s); launches {launches}")
    print(f"[serve] sample generation: {gen[0].tolist()}")
    return launches, cfg, st, out


def profile_phase(torch, cfg, st, out):
    """Where the serve time goes: the same serve call again under
    ``torch.profiler``; device busy time (sum of kernel times) against the
    unprofiled call's wall time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve_batch

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_out = serve_batch(cfg, st, device="cuda")
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    wall_s = out["prefill_s"] + out["decode_s"]
    if busy_s == 0:
        print("[profile] the profiler recorded no device time: busy share not measured")
        return
    print(f"[profile] serve call: device busy {busy_s:.4f} s of {wall_s:.4f} s wall unprofiled "
          f"({100 * busy_s / wall_s:.1f}% busy); profiled wall "
          f"{prof_out['prefill_s'] + prof_out['decode_s']:.4f} s; {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def agreement_phase(torch):
    """Reduced smollm-135m in float32: the card (kernels) against the CPU
    (plain versions) on the same weights."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.models import build_model

    cfg = dataclasses.replace(
        reduced(get_config("smollm-135m")), cim=CiMConfig(mode="fake_quant", ste=False), attn_impl="flash"
    )
    m_cpu, m_gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(3))
    p_gpu = {k: ({k2: v2.cuda() for k2, v2 in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=torch.Generator().manual_seed(4))
    c_cpu, c_gpu = m_cpu.make_cache(2, 131), m_gpu.make_cache(2, 131)
    worst = 0.0
    with torch.inference_mode():
        l_cpu, c_cpu = m_cpu.prefill(p_cpu, tokens, c_cpu)
        l_gpu, c_gpu = m_gpu.prefill(p_gpu, tokens.cuda(), c_gpu)
        for i in range(4):
            err = float((l_gpu.cpu() - l_cpu).abs().max() / l_cpu.abs().max())
            worst = max(worst, err)
            if err > 1e-3:
                raise AssertionError(f"reduced model: card vs CPU logits differ by {err:.3g} of max at step {i}")
            if i == 3:
                break
            tok = l_cpu[:, -1].argmax(-1).to(torch.int32)
            l_cpu, c_cpu = m_cpu.decode_step(p_cpu, tok, 128 + i, c_cpu)
            l_gpu, c_gpu = m_gpu.decode_step(p_gpu, tok.cuda(), 128 + i, c_gpu)
    print(f"[agree] reduced smollm-135m f32, fake_quant + flash: card vs CPU logits within {worst:.3g} "
          f"of max|logit| (tol 1e-3), prefill + 3 decode steps")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on a GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import cim_matmul as cmm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    paths = build.build()
    print(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f} s into {build.build_dir()}")
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    k1 = kernel_phase_k1(torch, cmm, ref)
    k2 = kernel_phase_k2(torch, fa, ref)
    launches, cfg, st, out = serve_phase(torch, cmm, fa)
    profile_phase(torch, cfg, st, out)
    k1["launches"], k2["launches"] = launches["cim_matmul_fq"], launches["flash_attention"]
    agreement_phase(torch)

    print(json.dumps({"kernels": [k1, k2]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
