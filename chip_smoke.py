#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's ``nvidia-smi`` name and power limit;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build seconds;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes and some edge shapes. K1 (CiM fake-quant
   matmul) must be bit-exact on integer inputs; K2 (flash attention) must
   agree within 2e-2 max-abs in bf16 and 1e-5 in float32, with the plain
   version and with the fp32 oracle; K3 (bit-plane CiM matmul) and K4 (ideal
   ADC) must be bit-exact (``torch.equal``), and K3 at the chip geometry
   (rows 16, 5-bit ADC, 4/4 bits) must equal the integer matmul less half
   the plane weight of every saturated plane pair (a 5-bit code cannot hold
   a full 16-row count). K1's edge shapes include M 1, 8 and 65 around its
   cluster split (M <= 64), a tile count the split does not divide,
   saturating operands and rows 256; K2 runs every case with float32 and
   with bf16 k/v, which pick its CUDA-core and its tensor-core kernel; K3's
   edge shapes run both of its epilogues (FAST; INT, the IEEE divide, at
   rows 64 with a 5-bit ADC, rows 10 and rows 24, and with int64 sums at
   8/8 bits with a 24-bit ADC), both k-steps, M 1, M 65 and its cluster split at M 4, and
   saturating operands (every plane dot = rows) at the ops defaults and the
   chip geometry; K4 runs 2-D tiles and flat lengths that are not a multiple
   of 4 from starts 4, 8 and 12 bytes past a 16-byte boundary. K2 also
   runs the MoE and hybrid serves' prefill shapes (hd 128 with GQA 8, hd
   112), and is timed at all three families' served prefill shapes. Each
   kernel's median device time (launches queued behind a device sleep, so
   the host's launch rate is not timed), its plain version's time, its
   bound at H100 peaks (for K3 the function's, and the bound of the
   algorithm that digitizes every plane pair beside it) and, for K2, the
   times of
   ``torch.nn.functional.scaled_dot_product_attention`` in float32 (the same
   function) and in bf16 (yardsticks the port never calls) are printed; K3
   per prefill layer (7 linears, M 1024) and per decode layer (M 4) at the
   ops defaults and at the chip geometry;
4. serve phase: ``serve_batch`` on smollm-135m at full width (30 layers,
   d 576, vocab 49152, bf16) with ``fake_quant`` CiM linears and flash
   prefill, batch 4, prompt 256, 16 generated tokens, random weights from a
   seeded generator, after one short warm-up call. Each kernel's launch
   count is zeroed just before the measured call and read just after: K1
   must launch exactly 30*7*16 times, K2 exactly 30 times; logits must be
   finite and tokens in [0, vocab);
5. profile: the same serve call under ``torch.profiler`` for the device's
   busy time and the kernels that take the most of it;
6. agreement: the reduced smollm-135m (float32) on the card against the same
   weights on the CPU (plain versions), prefill and decode logits within
   1e-3 of max|logit|;
7. ops phase: the kernel ops a user calls, ``cim_matmul_op(mode="bitplane")``
   on one full-width layer's seven linears (M 256) and ``adc_quant_op`` on
   1 M analog values, with the counts zeroed before and read after: K3 and
   K4 must each launch; the ops' results (all seven linears and the ADC
   tile), and 4096 per-column quantization scales, equal the CPU's bit for
   bit;
8. bit-plane serve: ``serve_batch`` on smollm-135m at full width with
   ``bitplane`` CiM linears (the noiseless memory-immersed SAR ADC, plain
   PyTorch as in the JAX package) and flash prefill, batch 2, prompt 128
   (the flash prefill takes whole 128-query blocks), 4 generated tokens;
   K2 must launch 30 times; prefill s, decode tokens/s and peak device
   memory; then one ``cim_matmul(mode="bitplane")`` at the gate shape held
   to the integer matmul times the scales, and one gate linear at the
   prefill's M under ``torch.profiler``;
9. bit-plane agreement: phase 6 with ``bitplane`` linears;
10. ``[prng]``: the threefry PRNG (``repro_torch.core.prng``, plain PyTorch)
    on the card equal to the CPU (``torch.equal``): keys of seeds 0 and
    2^31 - 1, ``split`` into 2 and 7, ``fold_in`` over 4096 row ids, and
    ``bits``, ``uniform`` (default and custom bounds) and ``normal`` over 2^20
    draws; and both equal to golden ``jax.random`` draws recorded with jax
    0.9.0 (the card's machine has no JAX);
11. ``[fabric]``: smollm-135m at full width on one chip's fabric (hybrid,
    256 arrays): ``map_model`` + ``fabric_report`` of the whole model at
    tokens 4; ``execute_matmul(fake_quant)`` on one layer's seven linears at
    M 1024, with the K1 count zeroed before and read after: one launch per
    32-column tile (162), each output ``torch.equal`` to ``cim_matmul``'s on
    the card, the layer's device time beside ``cim_matmul``'s (7 launches);
    the noisy bit-plane ``execute_matmul`` (4/4 bits, rows 16, 5-bit SAR,
    comparator sigma 0.02, mismatch 0.01, ``PRNGKey(0)``) on q_proj and
    gate_proj at M 16, outputs and stats equal to the CPU's; noisy
    ``convert`` in all five modes on 2^20 values and ``measure_transfer``
    with a mismatch key (its DNL and INL) equal to the CPU's;
12. ``[serve-fabric]``: phase 4's serve with the one-chip fabric rollup of
    ``serve --fabric hybrid`` (its validation matmul runs first and prints
    the ``sequential`` backend); K1 and K2 must launch, and the per-request
    ``fabric`` dict must be present and finite;
13. ``[shard]``: smollm-135m at full width on chip meshes, every chip of a
    mesh on the card (hybrid, 256 arrays a chip): ``shard_model`` +
    ``sharded_fabric_report`` of the whole model at tokens 4 on 1x1, 1x4,
    2x2 and 4x4, held to the analytic plan (no fallback, cross-chip bits
    (model - 1) M N 24, the one-chip conversion count);
    ``execute_sharded_matmul(fake_quant)`` on one layer's seven linears at
    M 1024, the K1 count zeroed before and read after each run: 1x1 (7
    launches, each output ``torch.equal`` to ``cim_matmul``'s and
    ``execute_matmul``'s), and 1x4 and 2x2 under the ``sequential`` and
    ``shard_map`` backends (exactly 7 x chips launches; the backends
    ``torch.equal``; within atol 1e-4, rtol 1e-5 of 1x1), each layer's
    device busy time beside ``cim_matmul``'s; the noisy bit-plane executor
    on q_proj at M 16 on 1x4 and 2x2, its first two column tiles equal to
    the same call on those 64 columns on the card and on the CPU (outputs
    and stats);
14. ``[program]``: ``compile_forward`` of smollm-135m's whole residual
    chain (121 linears) at full width, tokens 4, fake_quant, on 1x1 and
    1x4: K1 exactly 121 x chips launches, the collective census (one
    ``all_gather``, a ``reduce_scatter`` and a ``pmax`` a linear, two
    ``psum``), the fused forward ``torch.equal`` to the per-layer loop on
    1x1 and within atol 1e-5, rtol 1e-6 of it on 1x4; ``measure_forward``'s
    fused, collectives-stripped and per-layer seconds;
15. ``[serve-shard]``: ``serve.main`` on smollm-135m with ``--fabric hybrid
    --fabric-chips 4 --fabric-backend shard_map`` and on mamba2-130m with
    ``--fabric-mesh 1x2 --fabric-program`` (fake_quant, batch 4, prompt 256,
    16 tokens): backend ``shard_map``, prefill s, decode tokens/s;
16. ``[graph]``: the fused full-block graph (``compile_graph_forward``,
    fake_quant, weights ``random_weights`` scaled by 1/sqrt(K)):
    smollm-135m whole (211 matmul nodes) at batch 4 x seq 64 on 1x1 and
    1x3, K1 exactly 211 x chips launches, the collective census equal to
    the budget, equal bit for bit to the per-node loop; the scan form on 1x3 equal bit for
    bit to the unrolled form; ``measure_forward``'s fused,
    collectives-stripped and per-node seconds; qwen3-moe-30b-a3b cut to 8
    layers (65 nodes) on 1x4, 260 launches, equal to its loop; smollm on 2x2 resolving to
    ``sequential`` with its head-divisibility reason; the reduced smollm's
    noisy bit-plane graph (comparator sigma 0.02) on the card within
    ``GRAPH_TOL`` of the same program on the CPU;
17. ``[autotune]``: the autotuner's plan for smollm-135m on 3 chips
    (request batches 1..8) equal to the recorded ``SMOLLM_PLAN_3``; its
    ``BucketedGraphCache`` on every batch 1..8 (seq 64), each held to the
    per-node reference on its real rows bit for bit, the hit, miss and
    pad-waste counters as the code gives them; then a cache with the coarse
    buckets (2, 4, 8) on the same batches, so that five of them are
    zero-padded, each held bit for bit to the unpadded per-node reference,
    its pad-waste counter equal to the 8 pad rows;
18. ``[serve-graph]``: ``serve.main`` on smollm-135m with ``--fabric
    hybrid --fabric-mesh 1x3`` and ``--fabric-program``, ``--fabric-program
    --fabric-scan`` and ``--fabric-autotune`` (fake_quant, batch 4, prompt
    256, 16 tokens; the validation passes bit-plane): K1 exactly 3,360, K2 0;
19. ``[serve-moe]``: qwen3-moe-30b-a3b at full width (d 2048, 32/4 heads
    of 128, 128 experts top 8, d_ff_expert 768, vocab 151936), 8 of its 48
    layers, bf16 compute, fake_quant + flash, seeded random weights in the
    JAX init's dtypes; one set of weights served with ``moe_impl="dense"``
    (batch 4, prompt 256, 16 tokens) and ``"scatter"`` (4 tokens). K1 must
    launch exactly 32 (dense) or 3,104 (scatter) times a forward, K2 8
    times at prefill; prefill s, decode tokens/s, peak device memory, and a
    profile of the dense call;
20. ``[serve-mamba]``: mamba2-130m at full width and depth (24 layers, d
    768, 24 SSM heads of 64, state 128), fake_quant, batch 4, prompt 512
    (two SSD chunks), 16 tokens: K1 exactly 144 a forward, no K2; profiled;
21. ``[serve-hybrid]``: zamba2-7b at full width (d 3584, 112 SSM heads,
    state 64, shared block 32 heads of 112, d_ff 14336), 13 of its 81
    layers (two groups of 6 and one tail layer), fake_quant + flash, batch
    4, prompt 512, 16 tokens: K1 exactly 92 a forward, K2 2; profiled;
22. ``[train]``: ``launch.train.train`` on smollm-135m at full width (30
    layers, d 576, vocab 49152), bf16 compute, remat full, AdamW,
    fake_quant + STE with an 8-bit ADC (rows 16, 8/8 bits; the default
    5-bit ADC's gradients overflow at this depth), batch 4 x seq 1024, lr
    3e-4, warmup 2, 8 steps under ``torch.use_deterministic_algorithms``:
    K1 exactly 420 launches a step (7 x 30 forward, 7 x 30 again in the
    remat recompute), K2 0, counted alone per step; losses finite, the
    trained params' loss on the first step's batch more than 0.05 below the
    first step's loss and on an unseen batch no higher than the initial
    params'; peak device memory; a ``stop_at=4`` run resumed from its
    checkpoint to step 8 with the uninterrupted run's losses bit for bit;
    then steady step seconds and tokens/s with deterministic algorithms off
    and on in turn, and one step profiled (device busy share);
23. ``[mnist]``: the paper's MLP (256-128-64-10) trained on the card for 4
    epochs in float (accuracy > 0.93) and with QAT (fake_quant 4/4 bits,
    rows 16, 5-bit: K1 exactly 3 launches a step), evaluated at the chip
    geometry (bitplane 4/4 bits, rows 16, 5-bit; ``sar`` = ``sar_asym``,
    within 0.05 of float; 2048 images) and at Fig. 7c's clocks (10 ... 100
    MHz) and Fig. 7d's supplies (1.0 ... 0.6 V) on 512 images (10 MHz above
    100 MHz by > 0.1); the same params on the CPU give the card's accuracy
    noiseless (512 images) and at 10 MHz (64 images), the largest logit
    difference printed;
24. ``[example]``: the walkthroughs of ``repro_torch.examples`` on the
    card: ``fabric_map`` (main and ``--graph``, its own asserts);
    ``quickstart`` and ``cim_design_space`` at the JAX scripts' sizes (5
    epochs; 1024 images at 10 MHz, 512 noiseless; every accuracy in [0, 1],
    float above 0.9, no kernel launched); ``serve_lm`` exact and ``--cim``
    (4 layers, d 128, batch 4, prompt 32, 24 tokens; with ``--cim`` K1
    exactly 672 launches at rows 64 with an 8-bit ADC, recorded for phase
    25; tokens in range); ``train_lm``'s own config (6.8M parameters) for
    its 200 steps in a fresh checkpoint directory under ``build/``, removed
    after (finite losses, the mean of the last 10 more than 0.5 below the
    mean of the first 10, no restart); each script's host seconds
    (``[time]``);
25. ``[k1-served]``: K1 against its plain version (``torch.equal``) at
    every (M, K, N) that phases 4, 13-21, 22, 23 and 24 gave it (the training
    shapes M 4096 and the QAT M 128 among them), recorded as they ran:
    each linear at its full M (prefill batch x prompt, decode batch, an
    expert's capacity, a chip's block), on random int8 operands; the plain
    version runs in row blocks, as rows are independent at a fixed step.
    The shapes named for the new families (N 24, K 7168, expert M 8 and
    80), for the mesh (a 2x2 chip's M 512 K 288, the 1x4 unembed's K 144
    N 49152) and for the graph (a 1x3 chip's M 256 K 192 N 576, the
    qwen3-moe router's K 512 N 128 on 1x4), for training (M 4096 K 576
    N 1536; the MLP's M 128 K 256 N 128) and for ``serve_lm --cim`` (rows
    64, 8-bit ADC, M 128 K 384 N 128) must be among them;
26. ``[agree-moe]`` (both ``moe_impl``), ``[agree-mamba]``,
    ``[agree-hybrid]``: phase 6 on the reduced float32 configs, with the
    routed experts compared first (a differing choice is printed as a
    routing flip with its probability margin);
27. ``[agree-train]``: one training step of each reduced float32 family
    (smollm-135m with fake_quant + STE, qwen3-moe with both ``moe_impl``s,
    mamba2-130m, zamba2-7b), card against CPU on the same weights and
    batch: the loss within 1e-3 of itself, every gradient leaf within 1e-3
    of its max, the AdamW update on the same gradients within 1e-6 of
    max|p|;
28. ``[dryrun]``: ``hw.HBM_BYTES`` against the card's memory; the
    ``[train]`` cell planned on 1x1 (``launch.steps.build_cell``) and its
    step counted by ``roofline.op_stats`` on fake CPU tensors and on the card
    with real tensors: dot FLOPs and K1's counted work equal, K1's launches
    equal to its counted calls, the plan's resident bytes equal to the real
    arguments'; the step timed (median of 3) beside the counted roofline
    (``t_compute``, ``t_memory``, model FLOPs over step time x peak); an
    ``int8_dot`` decode of smollm-135m at batch 4 counted the same way, the
    card's count equal to the fake tensors' (each product at 32 padded rows);
    then smollm-135m ``train_4k`` and qwen3-moe ``decode_32k`` through
    ``launch.dryrun.run_cell`` and hillclimb's
    ``C_commandr_decode/opt_int8_weights`` on fake tensors (host seconds
    each; records under ``build/dryrun/``);
29. ``[int8]``: ``cim_matmul(mode="int8_dot")`` on the card bit for bit
    equal to the CPU at the 7 linears of a smollm-135m layer, M 1024 and M 4
    (the padded path); ``[serve-int8]``: smollm-135m with ``int8_dot`` and
    the int8 KV cache, flash prefill, batch 4, prompt 256, 16 tokens (K1 0,
    K2 30); ``[agree-int8]``: phase 6 with ``int8_dot`` and the int8 KV
    cache;
30. the host seconds each group of phases took (``[time]``), one JSON line
    of every kernel with its launches (from phase 4; per path in
    ``launches_by_path``, ``train``, ``mnist-qat``, ``dryrun train step``,
    ``serve-int8`` and ``example serve_lm --cim`` among them), times and
    bound (K2's also at the qwen3-moe and zamba2-7b prefill shapes, under
    ``served_shapes``), the card's line again,
    and the final ``{"ok": true, ...}`` line.

Every number printed stands after the card's name and power limit (phase 1,
repeated before the last line). It imports nothing of JAX or of the JAX
package ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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

SLEEP_CYCLES = 1 << 25  # ~17 ms of device sleep ahead of each timed batch

# The autotuner's plan for smollm-135m on 3 chips (hybrid, 256 arrays a chip),
# request batches 1..8, fake_quant: host arithmetic, the same on every machine
# (the JAX package's plan; tests/test_torch_autotune.py holds the CPU to it).
SMOLLM_PLAN_3 = {"data": 1, "model": 3, "buckets": (1, 2, 3, 4, 5, 6, 7, 8),
                 "expected_latency_s": 5.012692991999999, "baseline_latency_s": 8.911454207999983, "searched": 5}
# Buckets that pad five of the request batches 1..8 (8 rows in all).
COARSE_BUCKETS = (2, 4, 8)
# K1 shapes of one layer's seven linears (K, N): q, k, v, o, gate, up, down.
LAYER_LINEARS = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536), (576, 1536), (1536, 576)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, batches: int = 7, iters: int = 20, queued: bool = True) -> float:
    """Median over ``batches`` of the mean time of ``iters`` launches (CUDA
    events), after a warm-up. ``queued``: each batch is enqueued behind a
    ~17 ms sleep of the device, so the events time the device's work back to
    back and not the host's launch rate (a kernel of a few microseconds is
    otherwise timed by its Python wrapper). ``queued=False`` times the calls
    as the host paces them, wrapper included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
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


def device_busy(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: (device busy ms, the sum
    of its kernels' times; {kernel name: (ms, launches)}). Where the host
    paces a call (many small launches), CUDA events time the host, and only
    this reads the device's own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_name = {e.key: (e.self_device_time_total / 1e3, e.count) for e in kernels}
    return sum(ms for ms, _ in by_name.values()), by_name


def k3_bound(m: int, k: int, n: int, rows: int, adc: int, bits: int):
    """(bytes ms, function operations ms, algorithm operations ms) of one K3
    call on uint8 patterns (M, K) and (K, N), float32 out, K counted without
    the zero rows that pad its last tile. Where rows is a
    power of two 2^r and adc >= r, a pair's count is its plane dot except at
    d = rows (read as rows - rows / 2^adc), so the function is the integer
    matmul less (rows / 2^adc) FX FW per tile, FX and FW the signed 8-bit
    values of the AND of a tile's patterns: one int8 product per (m, k, n)
    and per (m, tile, n) on the tensor cores, and the ANDs and one
    multiply-add per output on the CUDA cores. Elsewhere the function is
    the algorithm. The algorithm, as the TPU kernel runs it: bits^2 plane
    dots per (m, k, n) on the int8 tensor cores and one fp32 multiply-add per
    conversion (bits^2 per (m, tile, n)) on the CUDA cores. Two pipes that
    run at once: the larger term."""
    t = -(-k // rows)
    t_bytes = (m * k + k * n + 4 * m * n) / HBM_BPS * 1e3
    t_alg = max(2 * bits * bits * m * k * n / INT8_OPS, 2 * bits * bits * m * t * n / FP32_FLOPS) * 1e3
    r = rows.bit_length() - 1
    if rows != 1 << r or adc < r:
        return t_bytes, t_alg, t_alg
    t_fn = max(2 * (m * k * n + m * t * n) / INT8_OPS, (m * k + k * n + 2 * m * n) / FP32_FLOPS) * 1e3
    return t_bytes, t_fn, t_alg


def saturation_deficit(torch, x_pat, w_pat, rows: int, bits: int):
    """At rows 16 with a 5-bit ADC every plane count d digitizes to d, except
    d = rows (code 2^5 does not exist), which comes back half a count short.
    Returns, per output, half the signed weight of every (tile, plane pair)
    with all ``rows`` bits set on both sides (signed ``bits``-bit operands):
    (M, N) float32, exact."""
    def side(p):  # (outputs, T): the plane weights of each tile's all-ones planes
        p = p.to(torch.int32).reshape(p.shape[0], -1, rows)
        wsum = torch.zeros(p.shape[:2], dtype=torch.float32, device=p.device)
        for b in range(bits):
            wsum += ((p >> b) & 1).all(dim=-1).float() * (-(2.0 ** b) if b == bits - 1 else 2.0 ** b)
        return wsum
    return 0.5 * (side(x_pat) @ side(w_pat.t()).t())


def kernel_phase_k1(torch, cmm, ref):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rand8 = lambda *shape: torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    max_err = 0.0

    def saturating(m, k, n):  # rows of x and columns of w all -128 or all 127: |q| = 24 every tile
        x = torch.where(torch.arange(m, device="cuda")[:, None] % 2 == 0, -128, 127).expand(m, k)
        w = torch.where(torch.arange(n, device="cuda")[None, :] % 3 == 0, 127, -128).expand(k, n)
        return x.to(torch.int8).contiguous(), w.to(torch.int8).contiguous()

    # edge shapes: ragged M/N, rows 64 / adc 6, rows 10 (tiles padded to 16 rows); M 1, 8 and 65
    # around the cluster split (M <= 64); 37 tiles, a count the split of 8 does not divide;
    # saturating operands at K 256, so the thresholds' ends are reached (float32 sum exact);
    # rows 256, whose tile dots reach 2^22 (the kernel's wide path)
    for m, k, n, rows, adc, sat in [(77, 112, 45, 16, 5, False), (130, 192, 70, 64, 6, False),
                                    (40, 1024, 48, 256, 8, False),
                                    (33, 40, 17, 10, 5, False), (1, 576, 192, 16, 5, False),
                                    (8, 576, 576, 16, 5, False), (65, 576, 192, 16, 5, False),
                                    (4, 16 * 37, 576, 16, 5, False), (64, 256, 96, 16, 5, True)]:
        step = ref.fake_quant_step(rows, adc, 8, 8, True, True)
        x, w = saturating(m, k, n) if sat else (rand8(m, k), rand8(k, n))
        run = lambda: cmm.cim_matmul_fq(x, w, rows=rows, step=step)
        y, y_plain = run(), cmm.cim_matmul_fq_plain(x, w, rows=rows, step=step)
        if not torch.equal(y, y_plain):
            raise AssertionError(f"K1 differs from its plain version at M{m} K{k} N{n} rows {rows}")
        if sat and float(y.abs().max()) != 24 * (k // rows) * step:
            raise AssertionError(f"K1 saturating operands at K{k} did not reach the table's ends")
        split = cmm.fq_cluster_size(m, k // rows)
        print(f"[k1] edge M{m} K{k} N{n} rows {rows} adc {adc}{' saturating' if sat else ''}: kernel "
              f"{time_ms(run):.4f} ms, cluster split {'ran, ' + str(split) + ' CTAs' if split > 1 else 'not used'}, "
              f"bit-exact")
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
            # the tile dots on the int8 tensor cores and one fp32 multiply-add per
            # (output, tile) conversion on the CUDA cores: two pipes at once, so the larger
            t_ops = max(2 * m * k * n / INT8_OPS, 2 * m * n * (k // 16) / FP32_FLOPS) * 1e3
            t_bytes = n_bytes / HBM_BPS * 1e3
            per_shape[(m, k, n)] = (time_ms(run), time_ms(plain), t_bytes, t_ops)
            ms, pms = per_shape[(m, k, n)][:2]
            split = cmm.fq_cluster_size(m, k // 16)
            print(f"[k1] M{m} K{k} N{n}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {max(t_bytes, t_ops):.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}), "
                  f"cluster split {'ran, ' + str(split) + ' CTAs' if split > 1 else 'not used'}, bit-exact")
    # the JSON entry: one prefill layer's seven linears at M 1024, and one decode layer's at M 4
    layer = [per_shape[(1024, k, n)] for k, n in LAYER_LINEARS]
    t_bytes, t_ops = sum(s[2] for s in layer), sum(s[3] for s in layer)
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
        "decode_ms": sum(per_shape[(4, k, n)][0] for k, n in LAYER_LINEARS),
    }
    print(f"[k1] one prefill layer (7 linears, M 1024): kernel {entry['ms']:.4f} ms, "
          f"plain {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}); "
          f"one decode layer (7 linears, M 4): kernel {entry['decode_ms']:.4f} ms")
    return entry


@contextlib.contextmanager
def k1_recorder(cmm, shapes: dict, path: str):
    """While open, every K1 launch adds ``path`` to ``shapes[(M, K, N, rows,
    step)]``: the shapes a serve path gives the kernel, as they run."""
    real = cmm._launch

    def record(x, w, rows, step):
        shapes.setdefault((x.shape[0], x.shape[1], w.shape[1], rows, step), set()).add(path)
        return real(x, w, rows, step)

    cmm._launch = record
    try:
        yield
    finally:
        cmm._launch = real


def k1_served_phase(torch, cmm, shapes: dict) -> float:
    """K1 against its plain version, ``torch.equal``, at every shape the
    serve paths gave it (``k1_recorder``), at the full M, on random int8
    operands. The plain version runs in row blocks whose (rows, T, N)
    partial dots stay under 1 GiB: rows are independent at a fixed step.
    Returns the largest |kernel - plain|."""
    from repro_torch.kernels.ref import fake_quant_step

    gen = torch.Generator(device="cuda").manual_seed(11)
    max_err = 0.0
    for (m, k, n, rows, step), paths in sorted(shapes.items()):
        x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        run = lambda: cmm.cim_matmul_fq(x, w, rows=rows, step=step)  # noqa: E731
        y = run()
        block = max(1, (1 << 28) // ((k // rows) * n))
        y_plain = torch.cat([cmm.cim_matmul_fq_plain(x[i:i + block], w, rows=rows, step=step)
                             for i in range(0, m, block)])
        max_err = max(max_err, float((y - y_plain).abs().max()))
        if not torch.equal(y, y_plain):
            raise AssertionError(f"K1 differs from its plain version at the served shape M{m} K{k} N{n} "
                                 f"rows {rows} ({', '.join(sorted(paths))})")
        split = cmm.fq_cluster_size(m, k // rows)
        print(f"[k1-served] M{m} K{k} N{n} rows {rows} ({', '.join(sorted(paths))}): kernel "
              f"{time_ms(run, batches=3, iters=5):.4f} ms, cluster split "
              f"{'ran, ' + str(split) + ' CTAs' if split > 1 else 'not used'}, bit-exact to the plain version "
              f"in {-(-m // block)} row blocks")
    served = {(m, k, n) for m, k, n, *_ in shapes}
    named = {"N 24": any(n == 24 for _, _, n in served), "K 7168": any(k == 7168 for _, k, _ in served),
             "expert M 80": any(m == 80 for m, _, _ in served), "expert M 8": any(m == 8 for m, _, _ in served),
             "shard M 512 K 288": (512, 288, 576) in served, "program K 144 N 49152": (4, 144, 49152) in served,
             "graph 1x3 M 256 K 192": (256, 192, 576) in served, "graph router K 512 N 128": (256, 512, 128) in served,
             "train M 4096 K 576 N 1536": (4096, 576, 1536) in served, "mnist M 128 K 256 N 128": (128, 256, 128) in served,
             "serve_lm --cim rows 64 adc 8 M 128 K 384 N 128": (128, 384, 128, 64, fake_quant_step(64, 8, 8, 8, True, True))
             in shapes}
    if not all(named.values()):
        raise AssertionError(f"the serve paths gave K1 none of {[s for s, ok in named.items() if not ok]}")
    print(f"[k1-served] {len(shapes)} served shapes, among them {', '.join(named)}: all bit-exact "
          f"(max-abs {max_err})")
    return max_err


def kernel_phase_k2(torch, fa, ref):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    randn = lambda *shape, dt=torch.float32: torch.randn(shape, generator=gen, device="cuda").to(dt)
    bf16 = torch.bfloat16
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
        print(f"[k2] {fa.kernel_variant(k.dtype)} q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}/{k.dtype} "
              f"causal={causal}{'' if pos is None else ' (query shard)'}: max-abs {e_plain:.3g} vs plain, "
              f"{e_ref:.3g} vs fp32 reference (tol {tol})")

    b, h, kv, s, hd = 4, 9, 3, 256, 64
    # the serving path: q pre-scaled in float32, k/v bf16, sm_scale 1
    q_main = randn(b, h, s, hd) * hd ** -0.5
    k_main, v_main = randn(b, kv, s, hd, dt=bf16), randn(b, kv, s, hd, dt=bf16)
    check(q_main, k_main, v_main, 1e-5, sm_scale=1.0)
    check(randn(b, h, s, hd, dt=bf16), k_main, v_main, 2e-2)
    check(randn(b, h, s, hd), randn(b, kv, s, hd), randn(b, kv, s, hd), 1e-5)
    # absolute q positions: a query shard against the full K/V, with float32 and bf16 k/v
    q_full = randn(b, h, s, hd)
    pos = torch.arange(128, 256, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, bf16):
        k_s, v_s = randn(b, kv, s, hd, dt=dt), randn(b, kv, s, hd, dt=dt)
        check(q_full[:, :, 128:].contiguous(), k_s, v_s, 1e-5, pos=pos, rows=q_full)
    # the JAX package's test shapes (Sq 128 with Sk 384, non-causal, head_dim 32 and 128),
    # a head dim the kernel pads (80 -> 128), GQA ratios 1, 2, 4 and 8; float32 and bf16 k/v
    # and the MoE and hybrid serves' prefill shapes: qwen3-moe's hd 128 with GQA 8 (32 / 4 heads),
    # zamba2-7b's shared block at hd 112 (padded to 128), 32 / 32 heads
    for bb, hh, kk, sq, sk, d, causal in [(2, 4, 2, 256, 256, 64, True), (1, 8, 8, 128, 384, 32, True),
                                           (2, 4, 1, 256, 256, 64, False), (1, 2, 2, 512, 512, 128, True),
                                           (1, 4, 2, 128, 128, 80, True), (1, 8, 1, 256, 256, 64, True),
                                           (4, 32, 4, 256, 256, 128, True), (4, 32, 32, 512, 512, 112, True)]:
        for dt in (torch.float32, bf16):
            check(randn(bb, hh, sq, d), randn(bb, kk, sk, d, dt=dt), randn(bb, kk, sk, d, dt=dt), 1e-5, causal=causal)

    def sdpa(qx, kx, vx):  # one library call on the same inputs (a yardstick the port never calls)
        try:
            F.scaled_dot_product_attention(qx, kx, vx, is_causal=True, scale=1.0, enable_gqa=True)
            return lambda: F.scaled_dot_product_attention(qx, kx, vx, is_causal=True, scale=1.0, enable_gqa=True)
        except TypeError:  # a torch without enable_gqa: expand the KV heads outside the timing
            k_rep, v_rep = (t.repeat_interleave(qx.shape[1] // kx.shape[1], dim=1) for t in (kx, vx))
            return lambda: F.scaled_dot_product_attention(qx, k_rep, v_rep, is_causal=True, scale=1.0)

    def timed(q, k, v):
        """Kernel, plain version, bound and SDPA (float32 and bf16) at one serving shape."""
        bb, hh, ss, d = q.shape
        pairs = bb * hh * ss * (ss + 1) // 2  # causal (query, key) pairs this input needs
        n_bytes = q.numel() * 4 + 2 * k.numel() * 2 + q.numel() * 4
        # float32 accuracy on the bf16 tensor cores: three passes for q.k^T, three for p.v
        b_ms, b_by = bound(n_bytes, 6 * 2 * d * pairs, BF16_FLOPS)
        return {"ms": time_ms(lambda: fa.flash_attention(q, k, v, sm_scale=1.0)),
                "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, sm_scale=1.0)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(sdpa(q, k.float(), v.float())),  # the same function: k/v upcast outside
                "library_bf16_ms": time_ms(sdpa(q.to(bf16), k, v))}

    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": None,
        "max_abs_err": max_err,
        **timed(q_main, k_main, v_main),
    }
    # the other families' served prefill shapes: qwen3-moe (hd 128, GQA 8), zamba2-7b's shared
    # block (hd 112, padded to 128 inside the kernel); q pre-scaled float32, k/v bf16, as served
    entry["served_shapes"] = {}
    for fam, (bb, hh, kk, ss, d) in (("qwen3-moe", (4, 32, 4, 256, 128)), ("zamba2-7b", (4, 32, 32, 512, 112))):
        shape = f"{fam} B{bb} H{hh} KV{kk} S{ss} hd{d}"
        entry["served_shapes"][shape] = timed(randn(bb, hh, ss, d) * d ** -0.5,
                                              randn(bb, kk, ss, d, dt=bf16), randn(bb, kk, ss, d, dt=bf16))
    for shape, t in (("smollm-135m B4 H9 KV3 S256 hd64", entry), *entry["served_shapes"].items()):
        print(f"[k2] serving shape {shape} (q f32, k/v bf16, {fa.kernel_variant(bf16)}): "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
              f"scaled_dot_product_attention float32 {t['library_ms']:.4f} ms, bf16 {t['library_bf16_ms']:.4f} ms")
    return entry


def kernel_phase_k3(torch, cmm):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    max_err = 0.0
    pats = lambda shape, bits: torch.randint(0, 1 << bits, shape, generator=gen, device="cuda",
                                             dtype=torch.int32).to(torch.uint8)
    # edge shapes: ragged M/N; rows 64 with a 5-bit ADC (lossy, INT epilogue); rows 10 (tiles
    # padded to 16, INT); rows 128 and 32 (k-steps of 32); a_bits != w_bits;
    # unsigned activations; rows 24 with a 20-bit ADC (INT, one plane a side);
    # 8/8 bits with a 24-bit ADC (int64 sums); M 1 (one m16 fragment), M 65 (a second M block of
    # one row) and M 4 at K 1536 (the cluster split over 8 CTAs); then saturating operands, every
    # plane dot = rows, at the ops defaults and the chip geometry
    ones = lambda shape, v: torch.full(shape, v, dtype=torch.uint8, device="cuda")
    for m, k, n, rows, adc, ab, wb, a_signed, sat in [
        (77, 112, 45, 16, 5, 8, 8, True, None), (130, 192, 70, 64, 5, 8, 8, True, None),
        (33, 40, 17, 10, 5, 8, 8, True, None), (65, 256, 70, 128, 8, 8, 8, True, None),
        (20, 96, 33, 32, 6, 3, 5, True, None), (50, 128, 40, 16, 5, 4, 4, False, None),
        (8, 48, 12, 24, 20, 1, 1, False, None), (6, 64, 10, 16, 24, 8, 8, True, None),
        (1, 576, 192, 16, 5, 4, 4, True, None), (65, 640, 192, 128, 8, 8, 8, True, None),
        (4, 1536, 576, 128, 8, 8, 8, True, None),
        (64, 256, 96, 128, 8, 8, 8, True, (255, 127)), (33, 64, 40, 16, 5, 4, 4, True, (15, 15)),
    ]:
        kw = dict(rows=rows, adc_bits=adc, a_bits=ab, w_bits=wb, a_signed=a_signed)
        x, w = (ones((m, k), sat[0]), ones((k, n), sat[1])) if sat else (pats((m, k), ab), pats((k, n), wb))
        y, y_plain = cmm.cim_matmul_bp(x, w, **kw), cmm.cim_matmul_bp_plain(x, w, **kw)
        max_err = max(max_err, float((y - y_plain).abs().max()))
        if not torch.equal(y, y_plain):
            raise AssertionError(f"K3 differs from its plain version at M{m} K{k} N{n} {kw}")
        if sat and rows == 16 and not torch.equal(y, torch.full_like(y, 15.5 * (k // rows))):
            raise AssertionError(f"K3 saturating operands at the chip geometry: {float(y[0, 0])}")
        print(f"[k3] edge M{m} K{k} N{n} rows {rows} adc {adc} {ab}/{wb} bits{' unsigned x' if not a_signed else ''}"
              f"{' saturating' if sat else ''}: {'FAST' if cmm.bp_fast(rows, adc, ab, wb, k // rows) else 'INT'}"
              f" epilogue, cluster split {cmm.bp_cluster_size(m, n, k // rows)}, bit-exact")

    def quantized(m, k, n, bits):  # the ops' operands: patterns of symmetric-quantized normals
        from repro_torch.core.cim_linear import quantize_symmetric
        from repro_torch.kernels.ops import _bit_patterns

        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        x_int, _ = quantize_symmetric(x, bits, True)
        w_int, _ = quantize_symmetric(w, bits, True, per_axis=-1)
        return _bit_patterns(x_int, bits, True), _bit_patterns(w_int, bits, True), x_int, w_int

    per_shape, saturated = {}, 0
    for label, rows, adc, bits in (("defaults", 128, 8, 8), ("chip", 16, 5, 4)):
        kw = dict(rows=rows, adc_bits=adc, a_bits=bits, w_bits=bits)
        for m in (1024, 4):
            for k, n in sorted(set(LAYER_LINEARS)):
                x, w, x_int, w_int = quantized(m, k, n, bits)
                kp = -(-k // rows) * rows  # K zero-padded to whole tiles, as the op pads it
                x, w = F.pad(x, (0, kp - k)).contiguous(), F.pad(w, (0, 0, 0, kp - k)).contiguous()
                run = lambda: cmm.cim_matmul_bp(x, w, **kw)
                plain = lambda: cmm.cim_matmul_bp_plain(x, w, **kw)
                y, y_plain = run(), plain()
                max_err = max(max_err, float((y - y_plain).abs().max()))
                if not torch.equal(y, y_plain):
                    raise AssertionError(f"K3 is not bit-exact to its plain version at M{m} K{k} N{n} ({label})")
                note = "bit-exact"
                if label == "chip":
                    deficit = saturation_deficit(torch, x, w, rows, bits)
                    saturated += int((deficit != 0).sum())
                    if not torch.equal(y, x_int @ w_int - deficit):
                        raise AssertionError(f"K3 at the chip geometry is not the integer matmul at M{m} K{k} N{n}")
                    note += ", = integer matmul"
                t_bytes, t_ops, t_alg = k3_bound(m, k, n, rows, adc, bits)
                plain_ms = time_ms(plain, batches=3, iters=3) if m == 1024 else None
                per_shape[(label, m, k, n)] = (time_ms(run), plain_ms, t_bytes, t_ops, t_alg)
                ms = per_shape[(label, m, k, n)][0]
                print(f"[k3] {label} (rows {rows}, adc {adc}, {bits}/{bits} bits) M{m} K{k} N{n}: kernel {ms:.4f} ms, "
                      + (f"plain {plain_ms:.4f} ms, " if plain_ms is not None else "")
                      + f"bound {max(t_bytes, t_ops):.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}), "
                      f"algorithm bound {max(t_bytes, t_alg):.5f} ms, "
                      f"cluster split {cmm.bp_cluster_size(m, n, kp // rows)}, {note}")
    print(f"[k3] chip geometry: {saturated} outputs held a saturated plane pair (16-row count read as 15.5)")
    layers = {}
    for label in ("defaults", "chip"):
        for m in (1024, 4):
            layer = [per_shape[(label, m, k, n)] for k, n in LAYER_LINEARS]
            t_bytes, t_ops, t_alg = (sum(s[i] for s in layer) for i in (2, 3, 4))
            layers[(label, m)] = (sum(s[0] for s in layer), max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                                  None if m == 4 else sum(s[1] for s in layer), max(t_bytes, t_alg))
            ms, b_ms, b_by, pms, a_ms = layers[(label, m)]
            print(f"[k3] one {'prefill' if m == 1024 else 'decode'} layer (7 linears, M {m}, {label}): kernel {ms:.4f} ms, "
                  + (f"plain {pms:.4f} ms, " if pms is not None else "") + f"bound {b_ms:.5f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.1f}% of it; algorithm bound {a_ms:.5f} ms, {100 * a_ms / ms:.1f}% of it")
    entry = {
        "name": "cim_matmul_bp",
        "route": "cuda",
        "source": "src/repro_torch/csrc/cim_matmul_bp.cu",
        "replaces": "src/repro/kernels/cim_matmul.py:56",
        "launches": None,
        "max_abs_err": max_err,
        "ms": layers[("defaults", 1024)][0],
        "plain_ms": layers[("defaults", 1024)][3],
        "bound_ms": layers[("defaults", 1024)][1],
        "bound_by": layers[("defaults", 1024)][2],
        "library_ms": None,
        "algorithm_bound_ms": layers[("defaults", 1024)][4],
        "decode_ms": layers[("defaults", 4)][0],
        "chip_ms": layers[("chip", 1024)][0],
        "chip_plain_ms": layers[("chip", 1024)][3],
        "chip_bound_ms": layers[("chip", 1024)][1],
        "chip_bound_by": layers[("chip", 1024)][2],
        "chip_algorithm_bound_ms": layers[("chip", 1024)][4],
        "chip_decode_ms": layers[("chip", 4)][0],
    }
    return entry


def kernel_phase_k4(torch, aq):
    gen = torch.Generator(device="cuda").manual_seed(6)
    max_err = 0.0
    flat = torch.rand((1024 * 1024 + 7,), generator=gen, device="cuda") * 1.4 - 0.2  # under- and over-range too
    # 2-D tiles; then lengths that are not a multiple of 4 and starts 4, 8, 12 bytes past a
    # 16-byte boundary (the kernel's scalar head and tail around its float4 body)
    cases = [(flat[:7 * 130].view(7, 130), "(7, 130)"), (flat[:31].view(1, 31), "(1, 31)"),
             (flat[:1024 * 1024].view(1024, 1024), "(1024, 1024)")]
    cases += [(flat[lo:lo + n], f"flat[{lo}:{lo + n}]") for lo, n in ((1, 1024 * 1024 + 3), (2, 9), (3, 1), (1, 2), (0, 7), (3, 6))]
    for v, name in cases:
        for bits in (3, 5, 8):
            for vdd in (1.0, 0.8):
                out, out_plain = aq.adc_quant(v, bits=bits, vdd=vdd), aq.adc_quant_plain(v, bits=bits, vdd=vdd)
                max_err = max(max_err, float((out - out_plain).abs().max()))
                if not torch.equal(out, out_plain):
                    raise AssertionError(f"K4 differs from its plain version at {name}, bits {bits}, vdd {vdd}")
    print(f"[k4] {', '.join(name for _, name in cases)} (start offsets {sorted({v.data_ptr() % 16 for v, _ in cases})} "
          f"bytes mod 16) x bits 3, 5, 8 x vdd 1.0, 0.8: bit-exact")
    v = cases[2][0]
    run = lambda: aq.adc_quant(v, bits=5, vdd=1.0)
    plain = lambda: aq.adc_quant_plain(v, bits=5, vdd=1.0)
    b_ms, b_by = bound(8 * v.numel(), 5 * v.numel(), FP32_FLOPS)  # float32 in and out
    entry = {
        "name": "adc_quant",
        "route": "cuda",
        "source": "src/repro_torch/csrc/adc_quant.cu",
        "replaces": "src/repro/kernels/cim_matmul.py:175",
        "launches": None,
        "max_abs_err": max_err,
        "ms": time_ms(run),
        "plain_ms": time_ms(plain),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    print(f"[k4] 1024 x 1024 (1 M elements), 5 bits: kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by})")
    return entry


def ops_phase(torch, cmm, aq):
    """The kernel ops a user calls, counts zeroed just before and read just
    after: the bit-plane CiM op on one full-width layer's seven linears and
    the ideal-ADC op on a 1 M-element tile. Each result equals the CPU's."""
    from repro_torch.core.cim_linear import quantize_symmetric
    from repro_torch.kernels import adc_quant_op, cim_matmul_op

    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = torch.randn((256, 1536), generator=gen, device="cuda")  # batch 2 x prompt 128
    ws = {kn: torch.randn(kn, generator=gen, device="cuda") / kn[0] ** 0.5 for kn in set(LAYER_LINEARS)}
    v = torch.rand((1024, 1024), generator=gen, device="cuda")
    cmm.bp_launches = 0
    aq.launches = 0
    ys = [cim_matmul_op(xs[:, :k], ws[(k, n)], mode="bitplane") for k, n in LAYER_LINEARS]
    v_hat = adc_quant_op(v, bits=5)
    torch.cuda.synchronize()
    launches = {"cim_matmul_bp": cmm.bp_launches, "adc_quant": aq.launches}
    if launches["cim_matmul_bp"] < len(LAYER_LINEARS) or launches["adc_quant"] < 1:
        raise AssertionError(f"ops launches {launches}: want K3 >= {len(LAYER_LINEARS)}, K4 >= 1")
    for (k, n), y in zip(LAYER_LINEARS, ys):  # each linear again on the CPU (plain version)
        if not torch.equal(y.cpu(), cim_matmul_op(xs[:, :k].cpu(), ws[(k, n)].cpu(), mode="bitplane")):
            raise AssertionError(f"cim_matmul_op(mode='bitplane') at M 256 K{k} N{n} differs from the CPU's")
    if not torch.equal(v_hat.cpu(), adc_quant_op(v.cpu(), bits=5)):
        raise AssertionError("adc_quant_op on the card differs from the CPU's")
    # the per-column scales divide absmax by qmax: a true divide on the card
    # too (a reciprocal multiply would part from the CPU on ~4% of columns)
    w_wide = torch.randn((64, 4096), generator=gen, device="cuda")
    scale = quantize_symmetric(w_wide, 8, True, per_axis=-1)[1]
    if not torch.equal(scale.cpu(), quantize_symmetric(w_wide.cpu(), 8, True, per_axis=-1)[1]):
        raise AssertionError("quantization scales differ between the card and the CPU")
    print(f"[ops] cim_matmul_op(mode='bitplane') on 7 linears (M 256, ops defaults) and adc_quant_op "
          f"(1024 x 1024): launches {launches}; all 7 linears, the ADC tile and 4096 column scales equal "
          f"the CPU's bit for bit")
    return launches


def serve_bp_phase(torch, cmm, fa, aq):
    """Full-width smollm-135m with bit-plane CiM linears, then one bit-plane
    matmul at the gate shape held to the integer matmul times the scales."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig, cim_matmul, quantize_symmetric
    from repro_torch.kernels.ops import _bit_patterns
    from repro_torch.launch.serve import ServeSettings, serve_batch

    cim = CiMConfig(mode="bitplane", ste=False)
    cfg = dataclasses.replace(get_config("smollm-135m"), cim=cim, attn_impl="flash")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.compute_dtype) == (30, 576, 49152, "bfloat16")
    st = ServeSettings(batch=2, prompt_len=128, gen_len=4, seed=0)
    torch.cuda.reset_peak_memory_stats()
    cmm.launches = cmm.bp_launches = fa.launches = aq.launches = 0
    out = serve_batch(cfg, st, device="cuda")
    launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches,
                "cim_matmul_bp": cmm.bp_launches, "adc_quant": aq.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"cim_matmul_fq": 0, "flash_attention": cfg.n_layers, "cim_matmul_bp": 0, "adc_quant": 0}:
        raise AssertionError(f"bitplane serve launches {launches}: want K2 == {cfg.n_layers}, no other kernel")
    gen = out["generated"]
    if gen.shape != (st.batch, st.gen_len) or gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"generated tokens out of range or shape: {gen.shape}, [{gen.min()}, {gen.max()}]")
    if not bool(torch.isfinite(out["logits"][..., : cfg.vocab]).all()):
        raise AssertionError("bitplane serve logits are not finite")
    print(f"[serve-bp] smollm-135m full width, bitplane (rows 16, 5-bit SAR, 8/8 bits) + flash, batch {st.batch}, "
          f"prompt {st.prompt_len}, gen {st.gen_len}: prefill {out['prefill_s']:.4f} s "
          f"({st.batch * st.prompt_len / out['prefill_s']:.1f} tok/s), decode {out['decode_s']:.4f} s "
          f"({out['decode_tok_s']:.2f} tok/s), peak device memory {peak_gb:.2f} GB; launches {launches}")
    print(f"[serve-bp] sample generation: {gen[0].tolist()}")

    g = torch.Generator(device="cuda").manual_seed(8)
    m, k, n = 32, 576, 1536
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    y, stats = cim_matmul(x, w, cim, return_stats=True)
    x_int, sx = quantize_symmetric(x, cim.a_bits, cim.a_signed)
    w_int, sw = quantize_symmetric(w, cim.w_bits, cim.w_signed, per_axis=-1)
    deficit = saturation_deficit(torch, _bit_patterns(x_int, 8, True), _bit_patterns(w_int, 8, True), cim.rows, 8)
    want = (x_int @ w_int - deficit) * sx * sw
    conversions = cim.a_bits * cim.w_bits * m * (k // cim.rows) * n
    if not (torch.equal(y, want) and int(stats.conversions) == conversions
            and int(stats.comparisons) == cim.adc_bits * conversions):
        raise AssertionError(f"bitplane matmul at M{m} K{k} N{n}: max-abs {float((y - want).abs().max()):.3g} "
                             f"from the integer matmul times the scales; stats {stats}")
    print(f"[serve-bp] cim_matmul(bitplane) M{m} K{k} N{n}: equals (x_int @ w_int) * sx * sw bit for bit "
          f"({int((deficit != 0).sum())} outputs with a saturated plane pair); {conversions} conversions, "
          f"{int(stats.comparisons)} comparisons")
    profile_bitplane_linear(torch, cim)
    return out, peak_gb


def profile_bitplane_linear(torch, cim):
    """Where the bit-plane serve's time goes: one gate linear at the prefill's
    M (batch 2 x prompt 128) under ``torch.profiler``; device busy time
    against the call's wall time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cim_linear import cim_matmul

    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((256, 576), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((576, 1536), generator=g, device="cuda") / 24
    cim_matmul(x, w, cim)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    cim_matmul(x, w, cim)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cim_matmul(x, w, cim)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    if busy_s == 0:
        print("[serve-bp] the profiler recorded no device time: busy share not measured")
        return
    print(f"[serve-bp] profile of one gate linear (M 256, K 576, N 1536, bf16 in): device busy {busy_s:.4f} s "
          f"of {wall_s:.4f} s wall unprofiled ({100 * busy_s / wall_s:.1f}% busy); "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[serve-bp]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


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
    launches, out, _ = serve_measured(torch, cmm, fa, "serve", cfg, st, None, 7 * cfg.n_layers, cfg.n_layers)
    return launches, cfg, st, out


def profile_phase(torch, cfg, st, out, tag="profile", params=None):
    """Where the serve time goes: the same serve call again under
    ``torch.profiler``; device busy time (sum of kernel times) against the
    unprofiled call's wall time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve_batch

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_out = serve_batch(cfg, st, device="cuda", params=params)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    wall_s = out["prefill_s"] + out["decode_s"]
    if busy_s == 0:
        print(f"[{tag}] the profiler recorded no device time: busy share not measured")
        return
    print(f"[{tag}] serve call: device busy {busy_s:.4f} s of {wall_s:.4f} s wall unprofiled "
          f"({100 * busy_s / wall_s:.1f}% busy); profiled wall "
          f"{prof_out['prefill_s'] + prof_out['decode_s']:.4f} s; {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    for name, key in (("K1", "cim_fq_kernel"), ("K2", "flash_")):
        mine = [e for e in kernels if key in e.key]
        print(f"[{tag}] {name} ({key}*): {sum(dev_us(e) for e in mine) / 1e3:.3f} ms device, "
              f"{sum(e.count for e in mine)} launches")


# Golden draws of jax.random (jax 0.9.0, jax_threefry_partitionable=True), for
# the card's machine, which has no JAX: key data, uint32 bits, float32 bit
# patterns, and sums over whole draws (int64, exact).
JAX_GOLDEN = {
    "split(PRNGKey(0), 2)": [[1797259609, 2579123966], [928981903, 3453687069]],
    "fold_in(PRNGKey(0), 5)": [1524306142, 1887795613],
    "bits(PRNGKey(0), (4,))": [4070199207, 4202968722, 1427181096, 2012915765],
    "uniform(PRNGKey(0), (4,))": [1064475214, 1064993846, 1051337244, 1055913296],
    "normal(PRNGKey(0), (8,))": [0x3FCFB2BD, 0x40019DF0, 0xBEDE0017, 0xBDA10222,
                                 0x3E34512C, 0xBF78DAD7, 0xBEFD97CC, 0x3EFD1F31],
    "sum of normal(PRNGKey(2**31-1), (2**20,)) bit patterns": 2235555874062106,
    "sum of fold_in(PRNGKey(0), arange(4096)) words": 17389970515104,
}

LAYER_NAMES = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]


def prng_phase(torch):
    """The threefry PRNG (``repro_torch.core.prng``, plain PyTorch) on the card
    against the CPU, ``torch.equal``, and both against golden draws of
    ``jax.random``."""
    from repro_torch.core import prng

    n = 1 << 20
    draws = {
        "PRNGKey(0)": lambda d: prng.PRNGKey(0, d),
        "PRNGKey(2**31-1)": lambda d: prng.PRNGKey(2**31 - 1, d),
        "split(PRNGKey(0), 2)": lambda d: prng.split(prng.PRNGKey(0, d), 2),
        "split(PRNGKey(0), 7)": lambda d: prng.split(prng.PRNGKey(0, d), 7),
        "fold_in(PRNGKey(0), arange(4096))": lambda d: prng.fold_in(
            prng.PRNGKey(0, d), torch.arange(4096, device=d, dtype=torch.int32)),
        "bits(PRNGKey(0), (2**20,))": lambda d: prng.bits(prng.PRNGKey(0, d), (n,)),
        "uniform(PRNGKey(0), (2**20,))": lambda d: prng.uniform(prng.PRNGKey(0, d), (n,)),
        "uniform(PRNGKey(1), (2**20,), -0.5, 0.7)": lambda d: prng.uniform(prng.PRNGKey(1, d), (n,), -0.5, 0.7),
        "normal(PRNGKey(2**31-1), (2**20,))": lambda d: prng.normal(prng.PRNGKey(2**31 - 1, d), (n,)),
    }
    got = {}
    for name, fn in draws.items():
        card, cpu = fn("cuda"), fn("cpu")
        if not (card.is_cuda and torch.equal(card.cpu(), cpu)):
            raise AssertionError(f"prng {name}: the card's draw differs from the CPU's")
        got[name] = cpu
    f32_bits = lambda t: t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key0 = prng.PRNGKey(0)
    mine = {
        "split(PRNGKey(0), 2)": got["split(PRNGKey(0), 2)"].tolist(),
        "fold_in(PRNGKey(0), 5)": prng.fold_in(key0, 5).tolist(),
        "bits(PRNGKey(0), (4,))": got["bits(PRNGKey(0), (2**20,))"][:4].tolist(),
        "uniform(PRNGKey(0), (4,))": f32_bits(prng.uniform(key0, (4,))).tolist(),
        "normal(PRNGKey(0), (8,))": f32_bits(prng.normal(key0, (8,))).tolist(),
        "sum of normal(PRNGKey(2**31-1), (2**20,)) bit patterns":
            int(f32_bits(got["normal(PRNGKey(2**31-1), (2**20,))"]).sum()),
        "sum of fold_in(PRNGKey(0), arange(4096)) words": int(got["fold_in(PRNGKey(0), arange(4096))"].sum()),
    }
    for name, want in JAX_GOLDEN.items():
        if mine[name] != want:
            raise AssertionError(f"prng {name}: {mine[name]} is not jax.random's {want}")
    key = prng.PRNGKey(0, "cuda")
    draw = lambda: prng.normal(key, (n,))  # noqa: E731
    ms = time_ms(draw, batches=3, iters=5)
    busy_ms, by_name = device_busy(torch, draw)
    print(f"[prng] {len(draws)} draws (keys, split 2 and 7, fold_in over 4096 rows, bits, uniform and normal "
          f"over 2^20) equal on the card and the CPU; {len(JAX_GOLDEN)} golden jax.random draws matched; "
          f"normal over 2^20 on the card (plain PyTorch): {ms:.3f} ms a call by CUDA events, device busy "
          f"{busy_ms:.3f} ms over {sum(c for _, c in by_name.values())} kernel launches")


def prng_share(torch, prng, call):
    """How much of ``call``'s time its normal draws take: ``call`` as it
    runs, against ``call`` replaying the draws recorded from one run of it
    (the same data, walk and outputs, without the threefry and erf_inv).
    Returns (host ms, replayed host ms, device busy ms, replayed device busy
    ms); host times are the better of two synchronized runs."""
    real = prng.normal_at
    drawn = []

    def record(key, index):
        drawn.append(real(key, index))
        return drawn[-1]

    def replay():
        it = iter(drawn)
        prng.normal_at = lambda key, index: next(it)
        try:
            return call()
        finally:
            prng.normal_at = real

    prng.normal_at = record
    try:
        want = call()
    finally:
        prng.normal_at = real
    if not torch.equal(replay(), want):
        raise AssertionError("prng_share: the replayed draws gave another result")

    def host_ms(fn):
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    return host_ms(call), host_ms(replay), device_busy(torch, call)[0], device_busy(torch, replay)[0]


def fabric_phase(torch, cmm):
    """The one-chip fabric on smollm-135m at full width: the whole model's
    map and rollup, one layer's seven linears through ``execute_matmul``
    (``fake_quant``, one K1 launch per 32-column tile, each output equal to
    ``cim_matmul``'s), the noisy bit-plane executor and the noisy ADC on the
    card equal to the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.adc import ADCConfig, convert, dnl_inl, measure_transfer
    from repro_torch.core.cim_linear import CiMConfig, cim_matmul
    from repro_torch.fabric import FabricConfig, execute_matmul, fabric_report, map_matmul, map_model

    cfg = get_config("smollm-135m")
    fb = FabricConfig(mode="hybrid", n_arrays=256)
    t0 = time.time()
    rep = fabric_report(map_model(cfg, fb, tokens=4), fb)
    t = rep["totals"]
    if len(rep["layers"]) != cfg.n_layers * 7 + 1 or not all(
            isinstance(v, bool) or (v >= 0 and v < float("inf")) for v in t.values()):
        raise AssertionError(f"fabric report of smollm-135m: {len(rep['layers'])} layers, totals {t}")
    print(f"[fabric] map_model + fabric_report, smollm-135m full width, hybrid, {fb.resolved_n_arrays()} arrays, "
          f"tokens 4 ({time.time() - t0:.2f} s host): {t['tiles']} tiles, {t['conversions']:.6g} conversions, "
          f"latency {t['latency_s'] * 1e3:.6g} ms, digitization {t['digitization_energy_pj'] / 1e6:.6g} uJ, "
          f"EMA {t['ema_energy_pj'] / 1e6:.6g} uJ per pass, "
          f"{'model-resident' if t['model_resident'] else 'reloading'}")

    # one layer's seven linears through the fabric executor, fake_quant (K1 per column tile)
    cim = CiMConfig(mode="fake_quant", ste=False)
    gen = torch.Generator(device="cuda").manual_seed(10)
    m = 1024
    layer = []
    for name, (k, n) in zip(LAYER_NAMES, LAYER_LINEARS):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        layer.append((name, x, w, map_matmul(name, m, k, n, fb, cim=cim)))
    tiles = sum(p.n_tiles for *_, p in layer)
    run_fabric = lambda: [execute_matmul(x, w, fb, cim, placement=p) for _, x, w, p in layer]  # noqa: E731
    run_direct = lambda: [cim_matmul(x, w, cim) for _, x, w, _ in layer]  # noqa: E731
    cmm.launches = 0
    ys = run_fabric()
    torch.cuda.synchronize()
    fabric_launches = cmm.launches
    if fabric_launches != tiles:
        raise AssertionError(f"execute_matmul(fake_quant) on one layer: {fabric_launches} K1 launches, want {tiles}")
    for (name, x, w, p), y, y_direct in zip(layer, ys, run_direct()):
        if not torch.equal(y, y_direct):
            raise AssertionError(f"execute_matmul(fake_quant) {name} differs from cim_matmul on the card: "
                                 f"max-abs {float((y - y_direct).abs().max()):.3g}")
        # the same tiles on the CPU: K1's plain version on the fabric path's own operands
        y_cpu = execute_matmul(x.cpu(), w.cpu(), fb, cim, placement=p)
        if not torch.equal(y.cpu(), y_cpu):
            raise AssertionError(f"execute_matmul(fake_quant) {name} on the card differs from the CPU's "
                                 f"(K1's plain version per tile): max-abs {float((y.cpu() - y_cpu).abs().max()):.3g}")
    ms_fabric, ms_direct = time_ms(run_fabric, iters=5), time_ms(run_direct, iters=5)
    (busy_fabric, by_fabric), (busy_direct, by_direct) = device_busy(torch, run_fabric), device_busy(torch, run_direct)
    k1_ms = lambda by: sum(ms for name, (ms, _) in by.items() if "cim_fq_kernel" in name)  # noqa: E731
    print(f"[fabric] execute_matmul(fake_quant) on one layer's 7 linears (M {m}): {fabric_launches} K1 launches "
          f"(one per 32-column tile), each output equal bit for bit (tolerance 0) to cim_matmul's on the card and to the same tiles through K1's plain version on the CPU. Per layer, fabric against "
          f"cim_matmul (7 K1 launches): {ms_fabric:.4f} against {ms_direct:.4f} ms by CUDA events (host-paced "
          f"where the host launches slower than the device runs); device busy {busy_fabric:.4f} against "
          f"{busy_direct:.4f} ms over {sum(c for _, c in by_fabric.values())} against "
          f"{sum(c for _, c in by_direct.values())} kernel launches, of which K1 {k1_ms(by_fabric):.4f} against "
          f"{k1_ms(by_direct):.4f} ms")

    # the noisy bit-plane executor and the noisy ADC: the card against the CPU
    bp = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, rows=16, adc_bits=5,
                   comparator_sigma=0.02, ref_mismatch_sigma=0.01, ste=False)
    quiet = dataclasses.replace(bp, comparator_sigma=0.0, ref_mismatch_sigma=0.0)
    key = prng.PRNGKey(0)
    for name, (k, n) in (("q_proj", LAYER_LINEARS[0]), ("gate_proj", LAYER_LINEARS[4])):
        x = torch.randn((16, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        t0 = time.time()
        y, st = execute_matmul(x, w, fb, bp, key=key.cuda(), return_stats=True)
        torch.cuda.synchronize()
        t_card = time.time() - t0
        t0 = time.time()
        y_cpu, st_cpu = execute_matmul(x.cpu(), w.cpu(), fb, bp, key=key, return_stats=True)
        t_cpu = time.time() - t0
        if not (torch.equal(y.cpu(), y_cpu) and torch.equal(st.conversions.cpu(), st_cpu.conversions)
                and torch.equal(st.comparisons.cpu(), st_cpu.comparisons)):
            raise AssertionError(f"noisy bit-plane execute_matmul {name}: the card differs from the CPU")
        moved = int((y != execute_matmul(x, w, fb, quiet)).sum())
        print(f"[fabric] noisy bitplane execute_matmul {name} (M 16, K {k}, N {n}; 4/4 bits, rows 16, 5-bit SAR, "
              f"comparator sigma 0.02, mismatch 0.01, PRNGKey(0)): outputs and stats ({int(st.conversions)} "
              f"conversions, {int(st.comparisons)} comparisons) equal the CPU's; noise moved {moved} of "
              f"{y.numel()} outputs; {t_card:.2f} s on the card, {t_cpu:.2f} s on the CPU (host clock)")
        if name == "q_proj":
            ms, ms_replay, busy, busy_replay = prng_share(
                torch, prng, lambda: execute_matmul(x, w, fb, bp, key=key.cuda()))
            print(f"[fabric] PRNG share of noisy q_proj on the card: {ms:.1f} ms host clock against {ms_replay:.1f} "
                  f"ms with its normal draws replayed (PRNG {100 * (1 - ms_replay / ms):.1f}%); device busy "
                  f"{busy:.1f} against {busy_replay:.1f} ms (PRNG {100 * (1 - busy_replay / busy):.1f}%)")
    v = torch.rand((1 << 20,), generator=gen, device="cuda")
    for mode in ("sar", "sar_asym", "flash", "hybrid", "ideal"):
        ac = ADCConfig(mode=mode, comparator_sigma=0.01, ref_mismatch_sigma=0.02)
        card, cpu = convert(v, ac, key=prng.PRNGKey(5, "cuda")), convert(v.cpu(), ac, key=prng.PRNGKey(5))
        if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
            raise AssertionError(f"noisy convert({mode}) on 2^20 values: the card differs from the CPU")
    ac = ADCConfig(bits=5, comparator_sigma=0.002, ref_mismatch_sigma=0.05)
    (ramp, codes), (ramp_c, codes_c) = (measure_transfer(ac, key=prng.PRNGKey(3), device=d) for d in ("cuda", "cpu"))
    (dnl, inl), (dnl_c, inl_c) = dnl_inl(ramp, codes, ac), dnl_inl(ramp_c, codes_c, ac)
    import numpy as np

    if not (np.array_equal(codes, codes_c) and np.array_equal(dnl, dnl_c, equal_nan=True)
            and np.array_equal(inl, inl_c, equal_nan=True)):
        raise AssertionError("measure_transfer with a mismatch key: the card's DNL/INL differ from the CPU's")
    print(f"[fabric] noisy convert in all 5 modes (2^20 values, comparator sigma 0.01, mismatch 0.02): codes, "
          f"comparisons and cycles equal the CPU's; measure_transfer with a mismatch key (8192 points): DNL "
          f"max {np.nanmax(np.abs(dnl)):.4f} LSB, INL max {np.nanmax(np.abs(inl)):.4f} LSB, equal the CPU's")
    return {"ms": ms_fabric, "direct_ms": ms_direct, "busy_ms": busy_fabric, "direct_busy_ms": busy_direct,
            "k1_ms": k1_ms(by_fabric), "direct_k1_ms": k1_ms(by_direct), "launches": fabric_launches}


def serve_fabric_phase(torch, cmm, fa):
    """``serve_batch`` with the one-chip fabric rollup (serve ``--fabric
    hybrid``): the validation matmul, then the fake_quant + flash serve of
    phase 4 with the per-request fabric cost."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.fabric import FabricConfig
    from repro_torch.launch.serve import ServeSettings, fabric_rollup, serve_batch

    cfg = dataclasses.replace(
        get_config("smollm-135m"), cim=CiMConfig(mode="fake_quant", ste=False), attn_impl="flash"
    )
    st = ServeSettings(batch=4, prompt_len=256, gen_len=16, seed=0)
    cmm.launches = 0
    fa.launches = 0
    rollup = fabric_rollup(cfg, FabricConfig(mode="hybrid", n_arrays=256), st.batch, device="cuda")
    out = serve_batch(cfg, st, device="cuda", fabric_rollup=rollup)
    launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches}
    if launches["cim_matmul_fq"] < cfg.n_layers * 7 * st.gen_len or launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"serve --fabric launches {launches}")
    fab = out.get("fabric")
    numbers = [v for v in (fab or {}).values() if not isinstance(v, (bool, str))]
    if (fab is None or fab["exec_backend"] != "sequential" or fab["n_chips"] != 1
            or not all(0 <= v < float("inf") for v in numbers)):
        raise AssertionError(f"serve --fabric: fabric dict {fab}")
    print(f"[serve-fabric] smollm-135m full width, fake_quant + flash, batch {st.batch}, prompt {st.prompt_len}, "
          f"gen {st.gen_len}, fabric hybrid 256 arrays: prefill {out['prefill_s']:.4f} s, decode "
          f"{out['decode_tok_s']:.1f} tok/s; launches {launches}; fabric {fab}")
    return launches


MESHES = ((1, 4), (2, 2))  # the multi-chip meshes the [shard] phase runs, (data, model)


def close(a, b, atol: float, rtol: float) -> bool:
    """``|a - b| <= atol + rtol |b|`` everywhere (numpy's ``allclose``)."""
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def shard_phase(torch, cmm):
    """The multi-chip fabric on smollm-135m at full width, every chip on the
    card: the whole model's mesh plans and rollups; one layer's seven
    linears through ``execute_sharded_matmul(fake_quant)`` (one K1 launch
    per chip block) on 1x1 and, under both backends, on 1x4 and 2x2; the
    noisy bit-plane executor on q_proj on 1x4 and 2x2, its first two column
    tiles equal to the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.cim_linear import CiMConfig, cim_matmul
    from repro_torch.fabric import (
        ChipMeshConfig, FabricConfig, execute_matmul, execute_sharded_matmul, fabric_report, map_matmul, map_model,
        shard_model, shard_placement, sharded_fabric_report,
    )

    cfg = get_config("smollm-135m")
    fb = FabricConfig(mode="hybrid", n_arrays=256)
    t0 = time.time()
    one = fabric_report(map_model(cfg, fb, tokens=4), fb)["totals"]
    for d, m in ((1, 1), (1, 4), (2, 2), (4, 4)):
        cm = ChipMeshConfig(data=d, model=m, fabric=fb)
        sps = shard_model(cfg, cm, tokens=4)
        rep = sharded_fabric_report(sps, cm)
        t = rep["totals"]
        # the plan is host arithmetic: held to the analytic numbers (every K
        # of smollm is 36 or 96 tiles and M 4, so nothing falls back)
        bad = [sp.name for sp in sps if (sp.k_splits, sp.d_splits) != (m, d) or sp.fallbacks
               or sp.crosschip_bits_per_pass != (m - 1) * sp.m * sp.n * cm.psum_bits]
        if bad or len(sps) != cfg.n_layers * 7 + 1 or t["conversions"] != one["conversions"] or not all(
                isinstance(v, bool) or 0 <= v < float("inf") for v in t.values()):
            raise AssertionError(f"[shard] smollm-135m on {d}x{m}: layers {bad[:3]} off the analytic plan, totals {t}")
        print(f"[shard] shard_model + sharded_fabric_report, smollm-135m full width on {d}x{m}, tokens 4: "
              f"{t['tiles_per_chip']} tiles per chip, {t['conversions']:.6g} conversions (the one-chip count), "
              f"{t['crosschip_bits_per_pass']:.6g} cross-chip bits per pass (= sum (model-1) M N 24), latency "
              f"{t['latency_s'] * 1e3:.6g} ms, {t['latency_s_overlapped'] * 1e3:.6g} ms overlapped")
    print(f"[shard] the four plans and rollups took {time.time() - t0:.2f} s host")

    cim = CiMConfig(mode="fake_quant", ste=False)
    gen = torch.Generator(device="cuda").manual_seed(12)
    m_rows = 1024
    layer = []
    for name, (k, n) in zip(LAYER_NAMES, LAYER_LINEARS):
        x = torch.randn((m_rows, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        layer.append((name, x, w, map_matmul(name, m_rows, k, n, fb, cim=cim)))

    def runner(cm, backend):
        plans = [shard_placement(p, cm) for *_, p in layer]
        return lambda: [execute_sharded_matmul(x, w, cm, cim, sharded=sp, backend=backend)
                        for (_, x, w, _), sp in zip(layer, plans)]

    def counted(run):
        cmm.launches = 0
        ys = run()
        torch.cuda.synchronize()
        return ys, cmm.launches

    k1_ms = lambda by: sum(ms for key, (ms, _) in by.items() if "cim_fq_kernel" in key)  # noqa: E731
    run_direct = lambda: [cim_matmul(x, w, cim) for _, x, w, _ in layer]  # noqa: E731
    busy_direct, by_direct = device_busy(torch, run_direct)
    one_chip = ChipMeshConfig(fabric=fb)
    y1, launches = counted(runner(one_chip, "auto"))
    if launches != 7:
        raise AssertionError(f"[shard] 1x1 layer: {launches} K1 launches, want 7")
    for (name, x, w, p), y, y_direct in zip(layer, y1, run_direct()):
        if not (torch.equal(y, y_direct) and torch.equal(y, execute_matmul(x, w, fb, cim, placement=p))):
            raise AssertionError(f"[shard] 1x1 {name}: execute_sharded_matmul differs from cim_matmul / execute_matmul")
    busy, by = device_busy(torch, runner(one_chip, "auto"))
    times = {"1x1": {"busy_ms": busy, "k1_ms": k1_ms(by), "launches": launches}}
    print(f"[shard] execute_sharded_matmul(fake_quant) on one layer's 7 linears (M {m_rows}), 1x1 (sequential): "
          f"7 K1 launches, each output equal bit for bit to cim_matmul's and execute_matmul's on the card; device busy "
          f"{busy:.4f} ms (K1 {k1_ms(by):.4f}) against cim_matmul's {busy_direct:.4f} ms (K1 {k1_ms(by_direct):.4f}, "
          f"7 launches)")
    for d, m in MESHES:
        cm = ChipMeshConfig(data=d, model=m, fabric=fb)
        outs = {}
        for backend in ("sequential", "shard_map"):
            ys, launches = counted(runner(cm, backend))
            if launches != 7 * d * m:
                raise AssertionError(f"[shard] {d}x{m} {backend}: {launches} K1 launches, want {7 * d * m}")
            busy, by = device_busy(torch, runner(cm, backend))
            times[f"{d}x{m} {backend}"] = {"busy_ms": busy, "k1_ms": k1_ms(by), "launches": launches}
            outs[backend] = ys
        for (name, *_), ys, ym, y in zip(layer, outs["sequential"], outs["shard_map"], y1):
            if not torch.equal(ys, ym):
                raise AssertionError(f"[shard] {d}x{m} {name}: the two backends differ")
            if not close(ym, y, 1e-4, 1e-5):
                raise AssertionError(f"[shard] {d}x{m} {name}: {float((ym - y).abs().max()):.3g} off the 1x1 result")
        worst = max(float((ym - y).abs().max()) for ym, y in zip(outs["shard_map"], y1))
        print(f"[shard] {d}x{m}: {7 * d * m} K1 launches on each backend (7 linears x {d * m} chips), the backends "
              f"equal bit for bit, within {worst:.3g} max-abs of 1x1 (atol 1e-4, rtol 1e-5); device busy sequential "
              f"{times[f'{d}x{m} sequential']['busy_ms']:.4f} ms (K1 {times[f'{d}x{m} sequential']['k1_ms']:.4f}), "
              f"shard_map {times[f'{d}x{m} shard_map']['busy_ms']:.4f} ms (K1 {times[f'{d}x{m} shard_map']['k1_ms']:.4f}) "
              f"against cim_matmul's {busy_direct:.4f} ms")

    bp = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, rows=16, adc_bits=5,
                   comparator_sigma=0.02, ref_mismatch_sigma=0.01, ste=False)
    k, n = LAYER_LINEARS[0]
    x = torch.randn((16, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    key = prng.PRNGKey(0)
    cols = 64  # the CPU holds the first two column tiles: its threefry is ~10x the card's host time here
    for d, m in MESHES:
        cm = ChipMeshConfig(data=d, model=m, fabric=fb)
        t0 = time.time()
        y = execute_sharded_matmul(x, w, cm, bp, key=key.cuda())
        torch.cuda.synchronize()
        t_card = time.time() - t0
        # column tiles draw from fold_in(key, tile) and columns quantize on their
        # own, so the call on the first 64 columns is the full call's first 64
        y_sub, st = execute_sharded_matmul(x, w[:, :cols], cm, bp, key=key.cuda(), return_stats=True)
        t0 = time.time()
        y_cpu, st_cpu = execute_sharded_matmul(x.cpu(), w[:, :cols].cpu(), cm, bp, key=key, return_stats=True)
        t_cpu = time.time() - t0
        if not (torch.equal(y[:, :cols], y_sub) and torch.equal(y_sub.cpu(), y_cpu)
                and torch.equal(st.conversions.cpu(), st_cpu.conversions)
                and torch.equal(st.comparisons.cpu(), st_cpu.comparisons)):
            raise AssertionError(f"[shard] noisy bitplane q_proj on {d}x{m}: the card differs from the CPU")
        print(f"[shard] noisy bitplane execute_sharded_matmul q_proj on {d}x{m} (M 16, K {k}, N {n}; 4/4 bits, "
              f"rows 16, 5-bit SAR, comparator sigma 0.02, mismatch 0.01, PRNGKey(0), shard_map): {t_card:.2f} s on "
              f"the card (host clock); its first {cols} columns equal the same call on those columns, on the card "
              f"and on the CPU ({t_cpu:.2f} s), outputs and stats ({int(st.conversions)} conversions)")
    return {"direct_busy_ms": busy_direct, "direct_k1_ms": k1_ms(by_direct), **times}


def program_phase(torch, cmm):
    """The fused forward over smollm-135m's whole residual chain (121
    linears: q, o, gate, down per layer and the unembed) at full width,
    tokens 4, fake_quant, on 1x1 and 1x4: K1 ``121 x chips`` launches, the
    collective census, equality with the per-layer loop, and
    ``measure_forward``'s times."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.fabric import ChipMeshConfig, FabricConfig, compile_forward, measure_forward
    from repro_torch.fabric.collectives import census

    cfg = get_config("smollm-135m")
    fb = FabricConfig(mode="hybrid", n_arrays=256)
    cim = CiMConfig(mode="fake_quant", ste=False)
    out = {}
    x = ws = None
    for d, m in ((1, 1), (1, 4)):
        cm = ChipMeshConfig(data=d, model=m, fabric=fb)
        t0 = time.time()
        prog = compile_forward(cfg, cm, cim, tokens=4)
        t_plan = time.time() - t0
        if prog.backend != "shard_map" or prog.n_layers != cfg.n_layers * 4 + 1:
            raise AssertionError(f"[program] {d}x{m}: backend {prog.backend}, {prog.n_layers} layers, {prog.problems}")
        if x is None:
            x = prog.example_input(prng.PRNGKey(0, "cuda"))
            # unit-variance weights over K keep the 121-deep chain finite
            ws = [w / w.shape[0] ** 0.5 for w in prog.random_weights(prng.PRNGKey(1, "cuda"))]
        cmm.launches = 0
        with census() as counts:
            y = prog(x, ws)
        torch.cuda.synchronize()
        launches = cmm.launches
        want = {"all_gather": int(m > 1), "reduce_scatter": prog.n_layers if m > 1 else 0, "psum": 2,
                "pmax": prog.n_layers, "ppermute": 0, "all_to_all": 0}
        if launches != prog.n_layers * d * m or counts != want:
            raise AssertionError(f"[program] {d}x{m}: {launches} K1 launches (want {prog.n_layers * d * m}), "
                                 f"census {counts} (want {want})")
        y_loop = prog.reference_forward(x, ws)
        if not bool(torch.isfinite(y).all()) or y.shape != (4, cfg.padded_vocab):
            raise AssertionError(f"[program] {d}x{m}: output {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
        exact = torch.equal(y, y_loop)
        if not (exact if m == 1 else close(y, y_loop, 1e-5, 1e-6)):
            raise AssertionError(f"[program] {d}x{m}: fused differs from the per-layer loop by "
                                 f"{float((y - y_loop).abs().max()):.3g}")
        meas = measure_forward(prog, x=x, weights=ws, iters=3, per_layer_backend="sequential", per_layer_iters=2)
        out[f"{d}x{m}"] = {"launches": launches, "census": counts, **{
            key: meas[key] for key in ("fused_s", "local_s", "per_layer_s", "measured_collective_s",
                                       "modeled_link_s", "link_clock_calibration")}}
        calib = meas["link_clock_calibration"]
        print(f"[program] compile_forward, smollm-135m full width on {d}x{m}, tokens 4, fake_quant ({t_plan:.2f} s "
              f"host to plan): {prog.n_layers} linears, {launches} K1 launches (= {prog.n_layers} x {d * m} chips), "
              f"census {counts}; fused {'equal bit for bit to' if exact else 'within atol 1e-5, rtol 1e-6 of'} the "
              f"per-layer loop; fused {meas['fused_s'] * 1e3:.3f} ms, collectives stripped "
              f"{meas['local_s'] * 1e3:.3f} ms, per-layer loop {meas['per_layer_s'] * 1e3:.3f} ms (host clock, "
              f"synchronized, best of 3 and 2); modeled link {meas['modeled_link_s'] * 1e3:.6g} ms, "
              f"link_clock_calibration {'n/a' if calib is None else f'{calib:.6g}'}")
    return out


def serve_shard_phase(torch, cmm, fa):
    """``serve`` on a chip mesh through its CLI: smollm-135m on 4 chips (2x2)
    with the ``shard_map`` backend, and mamba2-130m on 1x2 with the fused
    chain program. K1 is held to the model's count (7 linears a smollm layer,
    6 a mamba2 layer, for each of the 16 forwards: the fabric's validation
    matmul and chain run ``bitplane``, the plain per-plane path), K2 to 0
    (the CLI's blocked attention)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    runs = {}
    for tag, arch, per_layer, argv in (
        ("smollm-135m 2x2", "smollm-135m", 7, ["--fabric-chips", "4", "--fabric-backend", "shard_map"]),
        ("mamba2-130m 1x2", "mamba2-130m", 6, ["--fabric-mesh", "1x2", "--fabric-program"]),
    ):
        gen_len = 16
        cmm.launches = fa.launches = 0
        out = serve.main(["--arch", arch, "--cim", "fake_quant", "--fabric", "hybrid", *argv,
                          "--batch", "4", "--prompt-len", "256", "--gen-len", str(gen_len)])
        launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches}
        want = {"cim_matmul_fq": per_layer * get_config(arch).n_layers * gen_len, "flash_attention": 0}
        fab = out["fabric"]
        numbers = [v for v in fab.values() if not isinstance(v, (bool, str))]
        gen = out["generated"]
        if (fab["exec_backend"] != "shard_map" or not all(0 <= v < float("inf") for v in numbers)
                or launches != want or gen.shape != (4, gen_len)
                or not bool(torch.isfinite(out["logits"]).all())):
            raise AssertionError(f"[serve-shard] {tag}: fabric {fab}, launches {launches} (want {want}), "
                                 f"tokens {gen.shape}")
        runs[tag] = launches
        print(f"[serve-shard] {tag}, fake_quant, batch 4, prompt 256, gen 16: backend {fab['exec_backend']}, "
              f"prefill {out['prefill_s']:.4f} s, decode {out['decode_tok_s']:.2f} tok/s; launches {launches}; "
              f"fabric {fab}")
    return runs


GRAPH_TOL = 1e-6  # the card's graph against the CPU's (torch's CUDA exp/rsqrt/sigmoid): of max|logit|


def _graph_weights(prog, key):
    """``random_weights`` with each matmul weight scaled by 1/sqrt(K), so a
    whole model's residual stream stays in range; norm scales as drawn."""
    return {name: w / w.shape[-2] ** 0.5 if w.dim() >= 2 else w for name, w in prog.random_weights(key).items()}


def graph_phase(torch, cmm):
    """The fused full-block graph (``fabric.compile_graph_forward``) at full
    width, fake_quant: smollm-135m whole (211 matmul nodes) at batch 4 x seq
    64 on 1x1 and 1x3, unrolled and scanned; qwen3-moe-30b-a3b cut to 8
    layers (65 nodes) on 1x4; smollm on 2x2, sequential for its 9/3 heads;
    the noisy bit-plane graph of the reduced smollm config on the card
    against the CPU; ``measure_forward``. K1 launches exactly ``nodes x
    chips`` a forward, the census is the budget, the fused graph equals its
    per-node loop and the scan form the unrolled one."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import prng
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.fabric import ChipMeshConfig, FabricConfig, compile_graph_forward, measure_forward
    from repro_torch.fabric.collectives import census
    from repro_torch.fabric.graph import _stack_layer_weights

    fb = FabricConfig(mode="hybrid", n_arrays=256)
    cim = CiMConfig(mode="fake_quant", ste=False)
    out = {}

    def fused(tag, prog, x, ws, want_nodes):
        d, m = prog.chip_mesh.data, prog.chip_mesh.model
        if prog.backend != "shard_map" or prog.n_layers != want_nodes:
            raise AssertionError(f"[graph] {tag}: backend {prog.backend}, {prog.n_layers} nodes, {prog.problems}")
        cmm.launches = 0
        with census() as counts:
            y = prog(x, ws)
        torch.cuda.synchronize()
        launches = cmm.launches
        if launches != want_nodes * d * m or counts != prog.collective_budget():
            raise AssertionError(f"[graph] {tag}: {launches} K1 launches (want {want_nodes * d * m}), census "
                                 f"{counts} (want {prog.collective_budget()})")
        if not bool(torch.isfinite(y).all()) or tuple(y.shape) != (*x.shape[:2], prog.n_out):
            raise AssertionError(f"[graph] {tag}: output {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
        return y, launches, counts

    def held(tag, y, y_ref, exact):
        diff = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max())
        if not (torch.equal(y, y_ref) if exact else diff <= GRAPH_TOL * scale):
            raise AssertionError(f"[graph] {tag}: {diff:.3g} off the reference (max|y| {scale:.3g})")
        return diff, scale

    smollm = get_config("smollm-135m")
    x = prng.normal(prng.PRNGKey(0, "cuda"), (4, 64, smollm.d_model))
    ws = None
    for d, m in ((1, 1), (1, 3)):
        t0 = time.time()
        prog = compile_graph_forward(smollm, ChipMeshConfig(data=d, model=m, fabric=fb), cim, tokens=256)
        t_plan = time.time() - t0
        if ws is None:
            ws = _graph_weights(prog, prng.PRNGKey(1, "cuda"))
        y, launches, counts = fused(f"smollm {d}x{m}", prog, x, ws, 211)
        held(f"smollm {d}x{m} vs per-node loop", y, prog.reference_forward(x, ws), exact=True)
        entry = {"launches": launches, "census": counts}
        line = (f"[graph] smollm-135m whole (211 matmul nodes, full width), batch 4 x seq 64, fake_quant, {d}x{m} "
                f"({t_plan:.2f} s host to plan): {launches} K1 launches (= 211 x {d * m} chips), census {counts}; "
                f"equal bit for bit to the per-node loop")
        if m == 3:
            scan = compile_graph_forward(smollm, prog.chip_mesh, cim, tokens=256, scan_layers=True)
            y_scan, scan_launches, scan_counts = fused("smollm 1x3 scanned", scan, x,
                                                       _stack_layer_weights(ws, smollm.n_layers), 211)
            if not torch.equal(y_scan, y):
                raise AssertionError("[graph] smollm 1x3: the scan form differs from the unrolled form")
            meas = measure_forward(prog, x=x, weights=ws, iters=3, per_layer_backend="sequential", per_layer_iters=2)
            entry.update(scan_launches=scan_launches, **{k: meas[k] for k in (
                "fused_s", "local_s", "per_layer_s", "measured_collective_s", "modeled_link_s",
                "link_clock_calibration")})
            calib = meas["link_clock_calibration"]
            line += (f"; the scan form ({scan_launches} K1 launches, census {scan_counts}) equal bit for bit to the "
                     f"unrolled form; fused {meas['fused_s'] * 1e3:.3f} ms, collectives stripped "
                     f"{meas['local_s'] * 1e3:.3f} ms, per-node loop {meas['per_layer_s'] * 1e3:.3f} ms (host clock, "
                     f"synchronized, best of 3 and 2); modeled link {meas['modeled_link_s'] * 1e3:.6g} ms, "
                     f"link_clock_calibration {'n/a' if calib is None else f'{calib:.6g}'}")
        out[f"smollm {d}x{m}"] = entry
        print(line)
    two = compile_graph_forward(smollm, ChipMeshConfig(data=2, model=2, fabric=fb), cim, tokens=256)
    if two.backend != "sequential" or "heads 9/3 (q/kv) do not divide the model axis (2)" not in two.problems[0]:
        raise AssertionError(f"[graph] smollm 2x2: backend {two.backend}, problems {two.problems[:1]}")
    print(f"[graph] smollm-135m on 2x2 resolves to sequential: {two.problems[0]}")

    moe = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=8)
    prog = compile_graph_forward(moe, ChipMeshConfig(model=4, fabric=fb), cim, tokens=256)
    xm = prng.normal(prng.PRNGKey(0, "cuda"), (4, 64, moe.d_model))
    wm = _graph_weights(prog, prng.PRNGKey(1, "cuda"))
    y, launches, counts = fused("qwen3-moe 1x4", prog, xm, wm, 65)
    held("qwen3-moe 1x4 vs per-node loop", y, prog.reference_forward(xm, wm), exact=True)
    out["qwen3-moe 1x4"] = {"launches": launches, "census": counts}
    print(f"[graph] qwen3-moe-30b-a3b, 8 of 48 layers (65 matmul nodes: q, k, v, o, router, expert0's three, "
          f"unembed), batch 4 x seq 64, fake_quant, 1x4: {launches} K1 launches (= 65 x 4 chips), census {counts}; "
          f"equal bit for bit to the per-node loop")
    del wm

    small = reduced(smollm)
    noisy = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, rows=16, adc_bits=5, comparator_sigma=0.02, ste=False)
    prog = compile_graph_forward(small, ChipMeshConfig(fabric=fb), noisy, tokens=8)
    xs = prng.normal(prng.PRNGKey(2), (2, 4, small.d_model))
    wsm = prog.random_weights(prng.PRNGKey(3))
    key = prng.PRNGKey(4)
    t0 = time.time()
    y_card = prog(xs.cuda(), {k: v.cuda() for k, v in wsm.items()}, key=key)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    y_cpu = prog(xs, wsm, key=key)
    t_cpu = time.time() - t0
    diff, scale = held("reduced noisy 1x1 card vs CPU", y_card.cpu(), y_cpu, exact=False)
    out["reduced noisy"] = {"card_s": t_card, "cpu_s": t_cpu, "max_abs_diff_vs_cpu": diff}
    print(f"[graph] reduced smollm-135m ({small.n_layers} layers, d {small.d_model}), noisy bitplane (4/4 bits, rows "
          f"16, 5-bit SAR, comparator sigma 0.02, PRNGKey(4)), batch 2 x seq 4, 1x1: {t_card:.2f} s on the card, "
          f"{t_cpu:.2f} s on the CPU, within {diff:.3g} of the CPU (max|y| {scale:.3g}; tolerance {GRAPH_TOL} of it)")
    return out


def autotune_phase(torch, cmm):
    """The autotuner's plan for smollm-135m on 3 chips (request batches 1..8),
    held to the recorded dict; then its ``BucketedGraphCache`` in fake_quant
    on every batch 1..8 (seq 64), each held to the per-node reference on its
    real rows (``torch.equal``), with the hit, miss and pad-waste
    counters; then the same with ``COARSE_BUCKETS``, which pad five of the
    batches."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.fabric import BucketedGraphCache, ChipMeshConfig, FabricConfig, autotune_plan, request_histogram
    from repro_torch.obs import metrics

    cfg = get_config("smollm-135m")
    fb = FabricConfig(mode="hybrid", n_arrays=256)
    cim = CiMConfig(mode="fake_quant", ste=False)
    t0 = time.time()
    plan = autotune_plan(cfg, request_histogram(range(1, 9)), 3, fb, cim=cim)
    t_plan = time.time() - t0
    if dataclasses.asdict(plan) != SMOLLM_PLAN_3:
        raise AssertionError(f"[autotune] plan {dataclasses.asdict(plan)} != {SMOLLM_PLAN_3}")
    cache = BucketedGraphCache(cfg, ChipMeshConfig(data=plan.data, model=plan.model, fabric=fb), cim,
                               buckets=plan.buckets, seq=64)
    ws = _graph_weights(cache.program_for(plan.buckets[-1]), prng.PRNGKey(1, "cuda"))
    launches = 0
    with metrics.collecting() as reg:
        for b in range(1, 9):
            x = prng.normal(prng.PRNGKey(10 + b, "cuda"), (b, 64, cfg.d_model))
            cmm.launches = 0
            y = cache(x, ws)
            torch.cuda.synchronize()
            launches += cmm.launches
            if cmm.launches != 211 * plan.data * plan.model:
                raise AssertionError(f"[autotune] batch {b}: {cmm.launches} K1 launches")
            y_ref = cache.program_for(cache.bucket_for(b)).reference_forward(x, ws)
            if not torch.equal(y, y_ref) or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"[autotune] batch {b}: {float((y - y_ref).abs().max()):.3g} off the per-node "
                                     f"reference")
        counters = {name: reg.counter(name).value() for name in (
            "fabric_bucket_hits_total", "fabric_bucket_misses_total", "fabric_pad_waste_rows_total")}
    stats = cache.stats()
    pad = sum(cache.bucket_for(b) - b for b in range(1, 9))
    if (stats["hits"], stats["misses"], stats["pad_waste_rows"]) != (8, 0, pad) or counters != {
            "fabric_bucket_hits_total": 8.0, "fabric_bucket_misses_total": 0.0, "fabric_pad_waste_rows_total": pad}:
        raise AssertionError(f"[autotune] counters {counters}, stats {stats}")
    print(f"[autotune] autotune_plan, smollm-135m on 3 chips, request batches 1..8, fake_quant ({t_plan:.2f} s host): "
          f"{dataclasses.asdict(plan)}, the recorded plan; BucketedGraphCache on {plan.data}x{plan.model}, seq 64, "
          f"batches 1..8: {launches} K1 launches (211 x {plan.data * plan.model} chips a batch), each batch equal bit "
          f"for bit to the per-node reference on its real rows; counters {counters}; stats {stats}")
    # The plan's buckets fit every batch exactly; coarse buckets pad all but
    # three of them, so the pad rows, their mask and the rescaled stats run.
    coarse = BucketedGraphCache(cfg, ChipMeshConfig(data=plan.data, model=plan.model, fabric=fb), cim,
                                buckets=COARSE_BUCKETS, seq=64)
    padded = 0
    with metrics.collecting() as reg:
        for b in range(1, 9):
            x = prng.normal(prng.PRNGKey(20 + b, "cuda"), (b, 64, cfg.d_model))
            cmm.launches = 0
            y = coarse(x, ws)
            torch.cuda.synchronize()
            padded += cmm.launches
            if cmm.launches != 211 * plan.data * plan.model:
                raise AssertionError(f"[autotune] coarse batch {b}: {cmm.launches} K1 launches")
            y_ref = coarse.program_for(coarse.bucket_for(b)).reference_forward(x, ws)
            if y.shape != y_ref.shape or not torch.equal(y, y_ref) or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"[autotune] coarse batch {b} (bucket {coarse.bucket_for(b)}): "
                                     f"{float((y - y_ref).abs().max()):.3g} off the unpadded per-node reference")
        coarse_counters = {name: reg.counter(name).value() for name in (
            "fabric_bucket_hits_total", "fabric_bucket_misses_total", "fabric_pad_waste_rows_total")}
    coarse_stats = coarse.stats()
    coarse_pad = sum(coarse.bucket_for(b) - b for b in range(1, 9))
    if coarse_pad <= 0 or (coarse_stats["hits"], coarse_stats["misses"], coarse_stats["pad_waste_rows"]) != (
            8, 0, coarse_pad) or coarse_counters != {"fabric_bucket_hits_total": 8.0, "fabric_bucket_misses_total": 0.0,
                                                     "fabric_pad_waste_rows_total": coarse_pad}:
        raise AssertionError(f"[autotune] coarse buckets: counters {coarse_counters}, stats {coarse_stats}")
    print(f"[autotune] BucketedGraphCache on {plan.data}x{plan.model} with buckets {COARSE_BUCKETS}, seq 64, batches "
          f"1..8: {padded} K1 launches, each padded batch equal bit for bit to the unpadded per-node reference; "
          f"{coarse_pad} pad rows; counters {coarse_counters}; stats {coarse_stats}")
    return {"launches": launches + padded, "plan": dataclasses.asdict(plan), "stats": stats,
            "coarse_stats": coarse_stats}


def serve_graph_phase(torch, cmm, fa):
    """``serve`` with the fused graph through its CLI: smollm-135m on 1x3 with
    ``--fabric-program`` (one block), ``--fabric-program --fabric-scan`` (the
    whole model in the scan form) and ``--fabric-autotune``. The validation
    passes run ``bitplane`` (the plain per-plane path), so K1 is held to the
    model's count (7 linears x 30 layers x 16 forwards) and K2 to 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    runs = {}
    for tag, flags in (("program", ["--fabric-program"]), ("scan", ["--fabric-program", "--fabric-scan"]),
                       ("autotune", ["--fabric-autotune"])):
        gen_len = 16
        cmm.launches = fa.launches = 0
        t0 = time.time()
        out = serve.main(["--arch", "smollm-135m", "--cim", "fake_quant", "--fabric", "hybrid", "--fabric-mesh", "1x3",
                          *flags, "--batch", "4", "--prompt-len", "256", "--gen-len", str(gen_len)])
        took = time.time() - t0
        launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches}
        want = {"cim_matmul_fq": 7 * get_config("smollm-135m").n_layers * gen_len, "flash_attention": 0}
        fab = out["fabric"]
        numbers = [v for v in fab.values() if not isinstance(v, (bool, str))]
        if (launches != want or not all(0 <= v < float("inf") for v in numbers)
                or out["generated"].shape != (4, gen_len) or not bool(torch.isfinite(out["logits"]).all())):
            raise AssertionError(f"[serve-graph] {tag}: fabric {fab}, launches {launches} (want {want})")
        runs[tag] = launches
        print(f"[serve-graph] smollm-135m 1x3 {' '.join(flags)}, fake_quant, batch 4, prompt 256, gen 16: "
              f"{took:.2f} s in all, prefill {out['prefill_s']:.4f} s, decode {out['decode_tok_s']:.2f} tok/s; "
              f"launches {launches}")
    return runs


def _to(tree, device):
    return {k: _to(v, device) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(device)


def agreement_phase(torch, mode="fake_quant", arch="smollm-135m", tag="agree", **over):
    """The reduced ``arch`` in float32 with ``mode`` CiM linears and flash
    prefill: the card (kernels) against the CPU (plain versions) on the same
    weights, prefill and 3 decode steps. For an MoE arch the routed experts
    are compared first: a choice that differs is printed as a routing flip,
    with its token and the probability margin at the k-th place."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.models import build_model
    from repro_torch.models import moe

    cfg = dataclasses.replace(
        reduced(get_config(arch)), cim=CiMConfig(mode=mode, ste=False), attn_impl="flash", **over
    )
    m_cpu, m_gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(3))
    p_gpu = _to(p_cpu, "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=torch.Generator().manual_seed(4))
    c_cpu, c_gpu = m_cpu.make_cache(2, 131), m_gpu.make_cache(2, 131)
    routes = {"cpu": [], "cuda": []}
    real_route = moe.route

    def record(router, xt, k):
        out = real_route(router, xt, k)
        routes[xt.device.type].append(tuple(t.cpu() for t in out))
        return out

    worst, flips = 0.0, 0
    moe.route = record
    try:
        with torch.inference_mode():
            l_cpu, c_cpu = m_cpu.prefill(p_cpu, tokens, c_cpu)
            l_gpu, c_gpu = m_gpu.prefill(p_gpu, tokens.cuda(), c_gpu)
            for i in range(4):
                for call, ((probs, _, idx), (_, _, idx_gpu)) in enumerate(zip(routes["cpu"], routes["cuda"])):
                    for t in (idx != idx_gpu).any(-1).nonzero()[:, 0].tolist():
                        ranked = probs[t].sort(descending=True).values
                        margin = float(ranked[cfg.top_k - 1] - ranked[cfg.top_k])
                        flips += 1
                        print(f"[{tag}] routing flip at step {i}, router call {call}, token {t}: card "
                              f"{idx_gpu[t].tolist()}, CPU {idx[t].tolist()}, probability margin {margin:.3g}")
                routes["cpu"].clear()
                routes["cuda"].clear()
                err = float((l_gpu.cpu() - l_cpu).abs().max() / l_cpu.abs().max())
                worst = max(worst, err)
                if err > 1e-3:
                    raise AssertionError(f"reduced {arch}: card vs CPU logits differ by {err:.3g} of max at step {i}")
                if i == 3:
                    break
                tok = l_cpu[:, -1].argmax(-1).to(torch.int32)
                l_cpu, c_cpu = m_cpu.decode_step(p_cpu, tok, 128 + i, c_cpu)
                l_gpu, c_gpu = m_gpu.decode_step(p_gpu, tok.cuda(), 128 + i, c_gpu)
    finally:
        moe.route = real_route
    routed = f", {flips} routing flips (moe_impl {cfg.moe_impl})" if cfg.n_experts else ""
    print(f"[{tag}] reduced {arch} f32, {mode} + flash: card vs CPU logits within {worst:.3g} "
          f"of max|logit| (tol 1e-3), prefill + 3 decode steps{routed}")


def serve_measured(torch, cmm, fa, tag, cfg, st, params, k1_per_forward, k2):
    """One ``serve_batch`` of ``cfg`` on the card with ``params`` (None: the
    seeded weights of ``compiled_model``): the K1 and K2 counts zeroed just
    before and read just after, held to the counts the code gives
    (``k1_per_forward`` for each of the ``gen_len`` forwards, the prefill
    and ``gen_len - 1`` decode steps; ``k2`` at prefill); tokens in range
    and logits finite. Returns (launches, out, peak device GB)."""
    from repro_torch.launch.serve import serve_batch

    torch.cuda.reset_peak_memory_stats()
    cmm.launches = fa.launches = 0
    out = serve_batch(cfg, st, device="cuda", params=params)
    launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"cim_matmul_fq": k1_per_forward * st.gen_len, "flash_attention": k2}
    if launches != want:
        raise AssertionError(f"[{tag}] {cfg.name} launches {launches}, want {want}")
    gen = out["generated"]
    if gen.shape != (st.batch, st.gen_len) or gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"[{tag}] generated tokens out of range or shape: {gen.shape}, [{gen.min()}, {gen.max()}]")
    if not bool(torch.isfinite(out["logits"][..., : cfg.vocab]).all()):
        raise AssertionError(f"[{tag}] {cfg.name} logits are not finite")
    impl = f", moe_impl {cfg.moe_impl}" if cfg.n_experts else ""
    print(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, fake_quant{' + flash' if k2 else ''}{impl}, batch {st.batch}, "
          f"prompt {st.prompt_len}, gen {st.gen_len}: prefill {out['prefill_s']:.4f} s "
          f"({st.batch * st.prompt_len / out['prefill_s']:.1f} tok/s), decode {out['decode_s']:.4f} s "
          f"({out['decode_tok_s']:.2f} tok/s), peak device memory {peak_gb:.2f} GB; launches {launches} "
          f"(= {k1_per_forward} K1 per forward x {st.gen_len} forwards, {k2} K2)")
    print(f"[{tag}] sample generation: {gen[0].tolist()}")
    return launches, out, peak_gb


def init_on_card(torch, tag, cfg):
    """``cfg``'s seeded random weights on the card; prints their size."""
    from repro_torch.models import build_model

    t0 = time.time()
    params = build_model(cfg, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    leaves = []
    walk = lambda t: [walk(v) for v in t.values()] if isinstance(t, dict) else leaves.append(t)  # noqa: E731
    walk(params)
    n = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    print(f"[{tag}] {cfg.name}: {n / 1e9:.3f} G parameters, {gb:.2f} GB on the card (the JAX init's dtypes: "
          f"fan-scaled weights float32), initialized in {time.time() - t0:.1f} s")
    return params


def serve_moe_phase(torch, cmm, fa):
    """qwen3-moe-30b-a3b at full width, 8 of its 48 layers, bf16, fake_quant +
    flash: one set of weights served with ``moe_impl="dense"`` (the config's
    default; the experts are plain products, K1 runs attention's 4 linears)
    and with ``"scatter"`` (capacity dispatch, each expert's 3 linears on K1)."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.launch.serve import ServeSettings, serve_batch

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=8,
                              cim=CiMConfig(mode="fake_quant", ste=False), attn_impl="flash")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_experts, cfg.top_k, cfg.d_ff_expert,
            cfg.vocab, cfg.moe_impl, cfg.compute_dtype) == (2048, 32, 4, 128, 128, 8, 768, 151936, "dense", "bfloat16")
    params = init_on_card(torch, "serve-moe", cfg)
    st = ServeSettings(batch=4, prompt_len=256, gen_len=16, seed=0)
    serve_batch(cfg, dataclasses.replace(st, gen_len=2), device="cuda", params=params)  # warm-up
    dense = serve_measured(torch, cmm, fa, "serve-moe", cfg, st, params, 4 * cfg.n_layers, cfg.n_layers)
    profile_phase(torch, cfg, st, dense[1], tag="serve-moe", params=params)
    scfg = dataclasses.replace(cfg, moe_impl="scatter")
    sst = dataclasses.replace(st, gen_len=4)
    serve_batch(scfg, dataclasses.replace(sst, gen_len=2), device="cuda", params=params)  # warm-up
    scatter = serve_measured(torch, cmm, fa, "serve-moe", scfg, sst, params,
                             (4 + 3 * cfg.n_experts) * cfg.n_layers, cfg.n_layers)
    del params
    torch.cuda.empty_cache()
    return {"dense": dense[0], "scatter": scatter[0]}


def serve_mamba_phase(torch, cmm, fa):
    """mamba2-130m at full width and depth, bf16, fake_quant: six K1 linears
    a layer, no attention. Prompt 512 is two SSD chunks, so the state carry
    between chunks runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.launch.serve import ServeSettings, serve_batch

    cfg = dataclasses.replace(get_config("mamba2-130m"), cim=CiMConfig(mode="fake_quant", ste=False))
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk,
            cfg.tie_embeddings, cfg.compute_dtype) == (24, 768, 1536, 24, 64, 128, 256, True, "bfloat16")
    params = init_on_card(torch, "serve-mamba", cfg)
    st = ServeSettings(batch=4, prompt_len=512, gen_len=16, seed=0)
    serve_batch(cfg, dataclasses.replace(st, gen_len=2), device="cuda", params=params)  # warm-up
    launches, out, _ = serve_measured(torch, cmm, fa, "serve-mamba", cfg, st, params, 6 * cfg.n_layers, 0)
    profile_phase(torch, cfg, st, out, tag="serve-mamba", params=params)
    return launches


def serve_hybrid_phase(torch, cmm, fa):
    """zamba2-7b at full width, 13 of its 81 layers (two groups of 6, each
    followed by the shared block with its own KV cache, and one tail layer),
    bf16, fake_quant + flash."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.launch.serve import ServeSettings, serve_batch

    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=13,
                              cim=CiMConfig(mode="fake_quant", ste=False), attn_impl="flash")
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.share_period, cfg.compute_dtype) == (3584, 7168, 112, 64, 32, 32, 112, 14336, 6, "bfloat16")
    params = init_on_card(torch, "serve-hybrid", cfg)
    st = ServeSettings(batch=4, prompt_len=512, gen_len=16, seed=0)
    serve_batch(cfg, dataclasses.replace(st, gen_len=2), device="cuda", params=params)  # warm-up
    groups = cfg.n_layers // cfg.share_period
    launches, out, _ = serve_measured(torch, cmm, fa, "serve-hybrid", cfg, st, params,
                                      6 * cfg.n_layers + 7 * groups, groups)
    profile_phase(torch, cfg, st, out, tag="serve-hybrid", params=params)
    del params
    torch.cuda.empty_cache()
    return launches


# [train]'s learning gate: the trained params' loss on the first step's batch must fall
# below the first step's loss by more than this. It is above the spread of the 8 steps'
# losses on their own batches (0.0236) and well below the measured drop (10.9126 ->
# 10.7402 on an NVIDIA H100 80GB HBM3 at 700 W).
LEARN_MARGIN = 0.05


def _counted(torch, fn, cmm, fa, counts: list):
    """``fn`` (a train step) wrapped so that each call is counted alone: K1
    and K2 set to 0 just before it, read just after it into ``counts``."""

    def counted(*a, **k):
        cmm.launches = fa.launches = 0
        out = fn(*a, **k)
        torch.cuda.synchronize()
        counts.append((cmm.launches, fa.launches))
        return out

    return counted


def train_phase(torch, cmm, fa):
    """``launch.train.train`` on smollm-135m at full width (30 layers, d 576,
    vocab 49152), bf16 compute, remat full, AdamW, fake_quant + STE (QAT;
    rows 16, 8/8 bits, an 8-bit ADC: with the default 5-bit ADC most tile
    sums round to zero, the blocks' outputs vanish, and the gradients grow
    ~10x a layer through the norms of the unchanged residual stream, in the
    JAX package too, past float32 at 30 layers),
    batch 4 x seq 1024 (two loss chunks of 512), lr 3e-4, warmup 2, 8 steps,
    under ``torch.use_deterministic_algorithms``. K1 launches per step,
    counted alone: 7 linears x 30 layers in the forward pass, and the same
    again when remat recomputes each layer in the backward pass (the STE's
    backward is a float product), so 420; K2 none (blocked attention).
    The losses must be finite, the trained params' loss on the first step's
    batch more than ``LEARN_MARGIN`` below the first step's loss (each step
    trains on a new batch; 8 steps at lr 3e-4 move the loss on unseen
    batches by less than the batches differ), and their loss on an unseen
    batch no higher than the initial params'. Then the drill: ``stop_at=4``,
    resume from the checkpoint to step 8; the losses must equal the
    uninterrupted run's. Then steady steps timed with deterministic
    algorithms off and on in turn, and one step profiled (device busy
    share)."""
    import shutil
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("smollm-135m"), cim=CiMConfig(mode="fake_quant", adc_bits=8))
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.compute_dtype, cfg.remat, cfg.optimizer, cfg.loss_chunk,
            cfg.attn_impl, cfg.cim.ste, cfg.cim.rows) == (30, 576, 49152, "bfloat16", "full", "adamw", 512, "blocked",
                                                          True, 16)
    work = ROOT / "build" / "train_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    st = train_mod.TrainSettings(steps=8, batch=4, seq=1024, lr=3e-4, warmup=2, ckpt_dir=str(work / "full"),
                                 ckpt_every=1000, log_every=1, seed=0)
    per_step = []
    real_build = train_mod.build_step

    def counting_build(model, settings):
        opt_init, step_fn = real_build(model, settings)
        return opt_init, _counted(torch, step_fn, cmm, fa, per_step)

    det = torch.are_deterministic_algorithms_enabled()
    train_mod.build_step = counting_build
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.reset_peak_memory_stats()
            full = train_mod.train(cfg, st, device="cuda")
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            st_b = dataclasses.replace(st, ckpt_dir=str(work / "drill"), ckpt_every=4)
            first = train_mod.train(cfg, st_b, device="cuda", stop_at=4)
            second = train_mod.train(cfg, st_b, device="cuda")
    finally:
        train_mod.build_step = real_build
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(work, ignore_errors=True)  # ~1 GB of checkpoints
    nondet = sorted({str(w.message).split(".")[0] for w in caught if "deterministic" in str(w.message)})
    losses = full["losses"]
    model = build_model(cfg, "cuda")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=st.seq, global_batch=st.batch, seed=st.seed)
    init = model.init(torch.Generator(device="cuda").manual_seed(st.seed))
    fixed = {}  # loss of the initial and the trained params on step 0's batch and on an unseen one
    with torch.no_grad():
        for step in (0, st.steps):
            b = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch(step).items()}
            fixed[step] = (float(model.loss_fn(init, b)[0]), float(model.loss_fn(full["params"], b)[0]))
    del init
    # Each step's loss is on a new batch, and 8 steps at lr 3e-4 move the loss on unseen
    # batches by less than the batches differ, so the gate is the trained params' loss on
    # the batch of the first step: it must fall by more than LEARN_MARGIN below the first
    # step's loss (more than the spread of the 8 steps' losses), and the loss on the unseen
    # batch of step 8 must not rise.
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[train] losses {losses}: not finite")
    if not fixed[0][1] < losses[0] - LEARN_MARGIN or not fixed[st.steps][1] <= fixed[st.steps][0]:
        raise AssertionError(f"[train] on step 0's batch {fixed[0]} against the first loss {losses[0]} "
                             f"(margin {LEARN_MARGIN}), on the unseen batch {fixed[st.steps]}: not learning")
    want = (7 * cfg.n_layers * 2, 0)
    if any(c != want for c in per_step):
        raise AssertionError(f"[train] K1/K2 launches per step {per_step}, want {want} every step")
    resumed = first["losses"] + second["losses"]
    if nondet:
        # an op without a deterministic CUDA form ran: hold the resumed run to 1e-6 of the loss
        ok = all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(resumed, losses)) and len(resumed) == len(losses)
    else:
        ok = resumed == losses
    if not ok:
        raise AssertionError(f"[train] resumed losses {resumed} differ from the uninterrupted {losses}")
    steady = statistics.median(full["step_s"][1:])
    tokens = st.batch * st.seq
    print(f"[train] smollm-135m full width, fake_quant (8-bit ADC) + STE, remat full, AdamW, batch {st.batch} x seq {st.seq}, "
          f"8 steps: losses {[round(v, 4) for v in losses]}; step s {[round(v, 4) for v in full['step_s']]}; "
          f"median of steps 1-7 {steady:.4f} s in this counted, deterministic run, first step {full['step_s'][0]:.4f} s; "
          f"peak device memory {peak_gb:.2f} GB; launches per step {per_step[0]} (K1 = 7 x 30 forward + 7 x 30 "
          f"remat recompute, K2 0) over all {len(per_step)} steps run")
    print(f"[train] loss on step 0's batch: {fixed[0][0]:.4f} initial, {fixed[0][1]:.4f} after 8 steps (gate: below "
          f"the first step's {losses[0]:.4f} less {LEARN_MARGIN}; the 8 losses spread {max(losses) - min(losses):.4f}); "
          f"on the unseen batch of step {st.steps}: {fixed[st.steps][0]:.4f} initial, {fixed[st.steps][1]:.4f} after "
          f"(gate: no rise); last training loss {losses[-1]:.4f} vs first {losses[0]:.4f}")
    print(f"[train] drill: stop_at 4, resumed to 8: losses {'equal bit for bit' if resumed == losses else 'within 1e-6'} "
          f"(deterministic algorithms on; ops without a deterministic CUDA form: {nondet or 'none'})")

    # The step time and tokens/s come from steps outside the counted run, which adds a
    # synchronize a step and runs with deterministic algorithms on: steady steps on one
    # batch, deterministic algorithms off and on in turn (after a warm-up step of each).
    opt_init, step_fn = real_build(model, st)
    params = full["params"]
    opt_state = opt_init(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch(8).items()}
    steady_s = {False: [], True: []}
    try:
        for i, det_on in enumerate((False, True) * 4):
            torch.use_deterministic_algorithms(det_on, warn_only=True)
            torch.cuda.synchronize()
            t0 = time.time()
            params, opt_state, _ = step_fn(params, opt_state, batch, 8)
            torch.cuda.synchronize()
            if i >= 2:  # the first of each mode is its warm-up
                steady_s[det_on].append(time.time() - t0)
    finally:
        torch.use_deterministic_algorithms(det)
    wall = statistics.median(steady_s[False])
    det_wall = statistics.median(steady_s[True])
    print(f"[train] steady steps: {wall:.4f} s median ({tokens / wall:.1f} tokens/s) with deterministic algorithms "
          f"off, {det_wall:.4f} s median with them on (on/off {det_wall / wall:.3f}); "
          f"off {[round(v, 4) for v in steady_s[False]]}, on {[round(v, 4) for v in steady_s[True]]}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, opt_state, _ = step_fn(params, opt_state, batch, 8)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    k1_ms = sum(e.self_device_time_total for e in kernels if "cim_fq_kernel" in e.key) / 1e3
    if busy == 0:
        print("[train] the profiler recorded no device time: busy share not measured")
    else:
        print(f"[train] one step: {wall:.4f} s wall unprofiled (the steady median), device busy {busy:.4f} s ({100 * busy / wall:.1f}% "
              f"busy), {sum(e.count for e in kernels)} kernel launches, K1 {k1_ms:.3f} ms")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
            print(f"[train]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    del params, opt_state, full, first, second
    torch.cuda.empty_cache()
    return {"cim_matmul_fq": sum(c for c, _ in per_step[:st.steps]), "flash_attention": 0}


def dryrun_phase(torch, cmm, fa):
    """The ``[train]`` cell planned and counted (``launch.steps``,
    ``roofline.op_stats``): smollm-135m full width, fake_quant + STE with an
    8-bit ADC, remat, AdamW, batch 4 x seq 1024, on a 1x1 plan. Its step is
    counted once on fake CPU tensors and once on the card with real tensors
    under the same counter: the dot FLOPs and K1's counted work must be
    equal, and the plan's resident bytes must equal the bytes of the real
    params, AdamW state, batch and step. The step is timed on the card
    (median of 3 after a warm-up, host clock, deterministic algorithms off)
    beside the counted roofline. Then three production cells are planned
    and counted on fake tensors (host seconds each). Returns K1's and K2's
    launches in the counted card step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_cell, count_step, materialize
    from repro_torch.roofline import hw, op_stats
    from repro_torch.roofline.analysis import roofline
    from repro_torch.tree import tree_leaves

    total = torch.cuda.get_device_properties(0).total_memory
    if not 0.95 * hw.HBM_BYTES <= total <= 1.1 * hw.HBM_BYTES:
        raise AssertionError(f"[dryrun] the card has {total} bytes of memory; hw.HBM_BYTES is {hw.HBM_BYTES}")
    print(f"[dryrun] hw: {hw.NAME} datasheet peaks: {hw.PEAK_FLOPS_BF16:.4g} bf16 FLOP/s, {hw.HBM_BW:.4g} HBM B/s, "
          f"HBM_BYTES {hw.HBM_BYTES} (the card reports {total} bytes)")
    cfg = dataclasses.replace(get_config("smollm-135m"), cim=CiMConfig(mode="fake_quant", adc_bits=8))
    shape = ShapeConfig("smoke_train", 1024, 4, "train")
    SHAPES[shape.name] = shape
    mesh = make_local_mesh()
    try:
        t0 = time.time()
        cell = build_cell("smollm-135m", shape.name, mesh, cfg_override=cfg)
        fake = count_step(cell)
        t_fake = time.time() - t0
        resident = dryrun.resident_bytes(cell, mesh)
        card_cell = build_cell("smollm-135m", shape.name, mesh, cfg_override=cfg, device="cuda")
        args = materialize(card_cell, "cuda", seed=0)
    finally:
        del SHAPES[shape.name]
    real_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(args[:3])) + card_cell.args[3].element_size()
    if real_bytes != resident:
        raise AssertionError(f"[dryrun] resident bytes {resident} of the plan, {real_bytes} of the real arguments")
    steps = []
    for _ in range(4):  # a warm-up, then 3 timed steps
        torch.cuda.synchronize()
        t0 = time.time()
        card_cell.fn(*args)
        torch.cuda.synchronize()
        steps.append(time.time() - t0)
    step_s = statistics.median(steps[1:])
    cmm.launches = fa.launches = 0
    with op_stats.count_ops() as counter:
        card_cell.fn(*args)
        torch.cuda.synchronize()
    launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches}
    card = counter.stats
    del args
    torch.cuda.empty_cache()
    if card.dot_flops != fake.dot_flops or card.kernels.get("cim_matmul_fq") != fake.kernels.get("cim_matmul_fq"):
        raise AssertionError(f"[dryrun] the card's count (dot FLOPs {card.dot_flops}, K1 {card.kernels}) differs from "
                             f"the fake tensors' ({fake.dot_flops}, {fake.kernels})")
    if launches["cim_matmul_fq"] != fake.kernels["cim_matmul_fq"]["calls"]:
        raise AssertionError(f"[dryrun] K1 launched {launches} times in the counted step, counted {fake.kernels}")
    rep = roofline("smollm-135m", shape, cfg, fake, 1, {"bytes": resident})
    mfu = rep.model_flops / (step_s * hw.PEAK_FLOPS_BF16)
    print(f"[dryrun] [train] cell (smollm-135m full width, fake_quant 8-bit ADC + STE, remat, AdamW, batch 4 x seq 1024, "
          f"1x1): counted on fake tensors in {t_fake:.1f} s host; dot FLOPs {fake.dot_flops:.6g} (card {card.dot_flops:.6g}, "
          f"equal), K1 {fake.kernels['cim_matmul_fq']} (card equal, {launches['cim_matmul_fq']} launches), op bytes "
          f"{fake.op_bytes:.6g} fake / {card.op_bytes:.6g} card, {fake.n_ops} aten ops; resident {resident} bytes "
          f"= the real arguments' ({resident / 2**30:.3f} GiB, fits one H100: {'yes' if resident <= hw.HBM_BYTES else 'no'})")
    print(f"[dryrun] roofline: t_compute {rep.t_compute * 1e3:.3f} ms, t_memory {rep.t_memory * 1e3:.3f} ms "
          f"(eager op bytes), bottleneck {rep.bottleneck}, MODEL/counted FLOPs {rep.useful_ratio:.3f}; measured step "
          f"{step_s:.4f} s (median of {[round(v, 4) for v in steps[1:]]}, warm-up {steps[0]:.4f} s); model FLOPs "
          f"{rep.model_flops:.6g} / (step x peak bf16) = {mfu:.5f}; counted FLOPs / step = "
          f"{fake.dot_flops / step_s / 1e12:.2f} TFLOP/s")
    # an int8_dot decode at batch 4: the card pads each product's 4 rows to
    # 32, and the fake tensors' count reports that padded work
    icfg = dataclasses.replace(get_config("smollm-135m"), cim=CiMConfig(mode="int8_dot", ste=False))
    ishape = ShapeConfig("smoke_decode", 256, 4, "decode")
    SHAPES[ishape.name] = ishape
    try:
        ifake = count_step(build_cell("smollm-135m", ishape.name, mesh, cfg_override=icfg))
        icell = build_cell("smollm-135m", ishape.name, mesh, cfg_override=icfg, device="cuda")
        iargs = materialize(icell, "cuda", seed=0)
    finally:
        del SHAPES[ishape.name]
    with op_stats.count_ops() as icounter:
        icell.fn(*iargs)
        torch.cuda.synchronize()
    del iargs
    icard, mm = icounter.stats, ifake.kernels["int8_mm"]
    d, q, kv = icfg.d_model, icfg.n_heads * icfg.head_dim, icfg.n_kv_heads * icfg.head_dim
    kn = d * q + 2 * d * kv + q * d + 3 * d * icfg.d_ff  # the 7 products of a layer
    if icard.dot_flops != ifake.dot_flops or icard.kernels != ifake.kernels:
        raise AssertionError(f"[dryrun] int8_dot decode: the card's count (dot FLOPs {icard.dot_flops}, "
                             f"{icard.kernels}) differs from the fake tensors' ({ifake.dot_flops}, {ifake.kernels})")
    if mm["calls"] != 7 * icfg.n_layers or mm["dot_flops"] != 2.0 * 32 * kn * icfg.n_layers:
        raise AssertionError(f"[dryrun] int8_dot decode: int8_mm counted {mm}, want 210 calls on 32 rows each")
    print(f"[dryrun] int8_dot decode cell (smollm-135m full width, batch 4, cache 256, 1x1): dot FLOPs "
          f"{ifake.dot_flops:.6g} fake = card, int8_mm {mm} (210 products on 32 padded rows) fake = card")
    out = ROOT / "build" / "dryrun"
    for arch, shape_name in (("smollm-135m", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k")):
        t0 = time.time()
        rec = dryrun.run_cell(arch, shape_name, False, out / "torch_dryrun", force=True)
        if rec["status"] != "ok":
            raise AssertionError(f"[dryrun] {arch} {shape_name}: {rec.get('error')}")
        print(f"[dryrun] {arch} {shape_name} singlepod: {time.time() - t0:.1f} s host")
    t0 = time.time()
    rec = hillclimb.run_variant("C_commandr_decode/opt_int8_weights", force=True, out=out / "torch_hillclimb")
    if rec["status"] != "ok":
        raise AssertionError(f"[dryrun] hillclimb C1: {rec.get('error')}")
    print(f"[dryrun] C_commandr_decode/opt_int8_weights: {time.time() - t0:.1f} s host")
    return launches


def int8_phase(torch):
    """``cim_matmul(mode="int8_dot")`` on the card against the CPU at the
    smollm-135m serving shapes (bf16 activations, float32 weights; M 1024 a
    prefill, M 4 a decode step, which the CUDA int8 product takes padded
    with zero rows), and at the reduced configs' shapes (K, N 64 and 128)
    for M 1 to 65 and 1000: bit for bit. Device ms per layer (7 linears)."""
    from repro_torch.core import cim_linear as cl

    cfg = cl.CiMConfig(mode="int8_dot", ste=False)
    gen = torch.Generator().manual_seed(7)
    for m in (1, 2, 4, 16, 17, 24, 33, 64, 65, 1000):
        for k, n in ((64, 64), (64, 16), (128, 64), (64, 256), (576, 192), (1536, 576)):
            x = torch.randn((m, k), generator=gen)
            w = torch.randn((k, n), generator=gen)
            if not torch.equal(cl.cim_matmul(x.cuda(), w.cuda(), cfg).cpu(), cl.cim_matmul(x, w, cfg)):
                raise AssertionError(f"[int8] M{m} K{k} N{n}: card differs from the CPU")
    per_layer = {}
    for m in (1024, 4):
        ms = 0.0
        for k, n in LAYER_LINEARS:
            x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
            w = torch.randn((k, n), generator=gen) / math.sqrt(k)
            y_cpu = cl.cim_matmul(x, w, cfg)
            xg, wg = x.cuda(), w.cuda()
            y = cl.cim_matmul(xg, wg, cfg)
            if not torch.equal(y.cpu(), y_cpu):
                raise AssertionError(f"[int8] M{m} K{k} N{n}: card differs from the CPU by "
                                     f"{float((y.cpu().float() - y_cpu.float()).abs().max())}")
            ms += time_ms(lambda: cl.cim_matmul(xg, wg, cfg))
        per_layer[m] = ms
    print(f"[int8] int8_dot (torch._int_mm, s8 x s8 -> s32) bit-exact card vs CPU at the 7 linears of a smollm layer, "
          f"M 1024 and M 4 (padded to {cl._int8_rows(4)} rows), and the reduced shapes at M 1..65 and 1000; device ms per layer "
          f"with quantization: "
          f"{per_layer[1024]:.4f} (M 1024), {per_layer[4]:.4f} (M 4)")


def serve_int8_phase(torch, cmm, fa):
    """smollm-135m at full width with ``int8_dot`` linears and the int8 KV
    cache, flash prefill, batch 4, prompt 256, 16 tokens: K1 none, K2 30."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.launch.serve import ServeSettings, serve_batch

    cfg = dataclasses.replace(get_config("smollm-135m"), cim=CiMConfig(mode="int8_dot", ste=False),
                              attn_impl="flash", kv_quant_int8=True)
    st = ServeSettings(batch=4, prompt_len=256, gen_len=16, seed=0)
    serve_batch(cfg, dataclasses.replace(st, gen_len=2), device="cuda")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    cmm.launches = fa.launches = 0
    out = serve_batch(cfg, st, device="cuda")
    launches = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches}
    if launches != {"cim_matmul_fq": 0, "flash_attention": cfg.n_layers}:
        raise AssertionError(f"[serve-int8] launches {launches}, want K1 0 and K2 {cfg.n_layers}")
    gen = out["generated"]
    if gen.shape != (st.batch, st.gen_len) or gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"[serve-int8] generated tokens out of range or shape: {gen.shape}")
    if not bool(torch.isfinite(out["logits"][..., : cfg.vocab]).all()):
        raise AssertionError("[serve-int8] logits are not finite")
    print(f"[serve-int8] smollm-135m, 30 layers, int8_dot + int8 KV cache + flash, batch 4, prompt 256, gen 16: "
          f"prefill {out['prefill_s']:.4f} s, decode {out['decode_s']:.4f} s ({out['decode_tok_s']:.2f} tok/s), "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches}")
    return launches


# ``[example]``'s learning gate on train_lm's 200 steps: the mean of the last 10 losses
# must fall below the mean of the first 10 by more than this. It is 20x the spread of
# the first 10 (0.0222) and well below the measured fall (9.0639 -> 7.7050 on an
# NVIDIA H100 80GB HBM3 at 700 W); 60 steps moved the loss by 0.0064 only.
TRAIN_LM_MARGIN = 0.5


def example_phase(torch, cmm, fa, aq, served: dict) -> dict:
    """``repro_torch.examples`` on the card, each through its ``run`` at the
    JAX script's sizes: ``fabric_map`` (main and ``--graph``, its own
    asserts); ``quickstart`` and ``cim_design_space`` (every accuracy in
    [0, 1], the float MLP's above 0.9; their bit-plane evaluation is plain
    PyTorch, so no kernel launches); ``serve_lm`` exact (no launch) and
    ``--cim`` (K1 exactly 4 layers x 7 linears x 24 forwards, K2 0; its K1
    shapes, rows 64 with an 8-bit ADC, recorded in ``served`` for
    ``[k1-served]``), tokens in range; ``train_lm`` (200 steps) in a fresh
    checkpoint directory under ``build/``, removed after (finite losses,
    the mean of the last 10 more than ``TRAIN_LM_MARGIN`` below the mean of
    the first 10, no ``[ft] failure``: a restart on the card is a fault).
    Every count is set to 0 just before a script and read just after. Each
    script's lines are printed tagged ``[example]`` and its host seconds on
    a ``[time]`` line. Returns each script's launches."""
    import io
    import shutil
    import tempfile

    from repro_torch.examples import cim_design_space, fabric_map, quickstart, serve_lm, train_lm

    took, launches = {}, {}

    def echo(tag, fn, *args, keep=lambda line: True, **kw):
        buf = io.StringIO()
        cmm.launches = fa.launches = cmm.bp_launches = aq.launches = 0
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            res = fn(*args, **kw)
        torch.cuda.synchronize()
        took[tag] = round(time.time() - t0, 1)
        launches[tag] = {"cim_matmul_fq": cmm.launches, "flash_attention": fa.launches,
                         "cim_matmul_bp": cmm.bp_launches, "adc_quant": aq.launches}
        for line in buf.getvalue().splitlines():
            if keep(line):
                print(f"[example] {line}")
        return res, buf.getvalue()

    def no_launch(tag):
        if any(launches[tag].values()):
            raise AssertionError(f"[example] {tag} launched {launches[tag]}, want no kernel")

    checks = lambda line: line.startswith("[") or "checks passed" in line  # noqa: E731
    echo("fabric_map", fabric_map.main, "cuda", keep=checks)
    echo("fabric_map --graph", fabric_map.graph_demo, "cuda", keep=checks)
    for tag, script in (("quickstart", quickstart), ("cim_design_space", cim_design_space)):
        res, _ = echo(tag, script.run, device="cuda")
        accs = [res["float_acc"], *res["acc"].values()]
        if not (all(0.0 <= a <= 1.0 for a in accs) and res["float_acc"] > 0.9):
            raise AssertionError(f"[example] {tag}: accuracies {accs}, want each in [0, 1] and float above 0.9")
        no_launch(tag)
    for cim in (False, True):
        tag = "serve_lm --cim" if cim else "serve_lm"
        cfg = serve_lm.example_config(cim)
        with k1_recorder(cmm, served, f"example {tag}") if cim else contextlib.nullcontext():
            out, _ = echo(tag, serve_lm.run, cim=cim, device="cuda")
        gen = out["generated"]
        if gen.shape != (4, 24) or gen.min() < 0 or gen.max() >= cfg.vocab:
            raise AssertionError(f"[example] {tag}: generated tokens out of range or shape {gen.shape}")
        want = {"cim_matmul_fq": cfg.n_layers * 7 * 24 if cim else 0, "flash_attention": 0,
                "cim_matmul_bp": 0, "adc_quant": 0}
        if launches[tag] != want:
            raise AssertionError(f"[example] {tag}: launches {launches[tag]}, want {want}")
        print(f"[example] {tag}: launches {launches[tag]}"
              f"{' (= 4 layers x 7 linears x 24 forwards)' if cim else ''}")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="example_ckpt_", dir=ROOT / "build")
    try:
        out, text = echo("train_lm", train_lm.run, ckpt_dir=ckpt_dir, device="cuda")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)  # the run's checkpoints, ~80 MB a step kept
    losses = out["losses"]
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    if "[ft] failure" in text or len(losses) != 200 or not all(math.isfinite(v) for v in losses) \
            or not last < first - TRAIN_LM_MARGIN:
        raise AssertionError(f"[example] train_lm: {len(losses)} losses, mean of the first 10 {first}, of the "
                             f"last 10 {last} (margin {TRAIN_LM_MARGIN}), restarted: {'[ft] failure' in text}")
    no_launch("train_lm")
    print(f"[example] train_lm: 200 steps, mean loss of the first 10 {first:.4f} (spread "
          f"{max(losses[:10]) - min(losses[:10]):.4f}), of the last 10 {last:.4f} (spread "
          f"{max(losses[-10:]) - min(losses[-10:]):.4f}), gate: a fall of more than {TRAIN_LM_MARGIN}; "
          f"no restart, no kernel launched")
    print(f"[time] examples, host seconds by script: {took}")
    return launches


def _grads_close(tag, what, got: dict, want: dict, rel: float) -> float:
    """Largest |got - want| over the leaves, in units of each leaf's max|want|;
    raises above ``rel``."""
    worst = 0.0
    for key, w in want.items():
        g = got[key].detach().cpu().float()
        w = w.detach().float()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, err)
        if err > rel:
            raise AssertionError(f"[{tag}] {what} {key}: card vs CPU {err:.3g} of max (tol {rel})")
    return worst


def agreement_train_phase(torch):
    """One training step of each reduced float32 family, card against CPU on
    the same weights and batch: the loss (tol 1e-3 of itself), every
    gradient leaf (1e-3 of its max|g|, as ``[agree]``'s logits), and the
    AdamW update applied to the CPU's gradients on both devices (1e-6 of
    max|p|: the same float32 arithmetic, ``pow`` aside). Each device's own
    full step is printed beside it, in units of lr (a sign flip of a tiny
    gradient moves a first Adam step by 2 lr)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import leaves_with_path, path_key

    flat = lambda tree: {path_key(p): v for p, v in leaves_with_path(tree)}  # noqa: E731
    lr = 1e-3
    for arch, over in (("smollm-135m", {"cim": CiMConfig(mode="fake_quant")}),
                       ("qwen3-moe-30b-a3b", {"moe_impl": "dense"}), ("qwen3-moe-30b-a3b", {"moe_impl": "scatter"}),
                       ("mamba2-130m", {}), ("zamba2-7b", {})):
        cfg = dataclasses.replace(reduced(get_config(arch)), **over)
        m_cpu, m_gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
        p_cpu = m_cpu.init(torch.Generator().manual_seed(3))
        p_gpu = _to(p_cpu, "cuda")
        b = {k: torch.from_numpy(v) for k, v in TokenPipeline(cfg.vocab, 64, 2, seed=5).batch(0).items()}
        (l_cpu, _), g_cpu = value_and_grad(m_cpu.loss_fn, p_cpu, b)
        (l_gpu, _), g_gpu = value_and_grad(m_gpu.loss_fn, p_gpu, _to(b, "cuda"))
        tag = "agree-train"
        name = f"{arch}{' ' + cfg.moe_impl if cfg.n_experts else ''}{' fake_quant+STE' if cfg.cim else ''}"
        loss_err = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        if loss_err > 1e-3:
            raise AssertionError(f"[{tag}] {name}: loss card {float(l_gpu)} vs CPU {float(l_cpu)}")
        g_err = _grads_close(tag, f"{name} grad", flat(g_gpu), flat(g_cpu), 1e-3)
        new_cpu, _, _ = adamw_update(g_cpu, adamw_init(p_cpu), p_cpu, lr)
        new_gpu, _, _ = adamw_update(_to(g_cpu, "cuda"), adamw_init(p_gpu), p_gpu, lr)
        scale = max(float(v.abs().max()) for v in flat(new_cpu).values())
        u_err = max(float((flat(new_gpu)[k].cpu() - v).abs().max()) for k, v in flat(new_cpu).items()) / scale
        if u_err > 1e-6:
            raise AssertionError(f"[{tag}] {name}: AdamW update card vs CPU {u_err:.3g} of max|p|")
        own_gpu, _, _ = adamw_update(g_gpu, adamw_init(p_gpu), p_gpu, lr)
        own = max(float((flat(own_gpu)[k].cpu() - v).abs().max()) for k, v in flat(new_cpu).items()) / lr
        print(f"[{tag}] reduced {name} f32: loss {float(l_cpu):.6f}, card vs CPU {loss_err:.3g} of it (tol 1e-3); "
              f"{len(flat(g_cpu))} gradient leaves within {g_err:.3g} of their max (tol 1e-3); AdamW update on the "
              f"same gradients within {u_err:.3g} of max|p| (tol 1e-6); each device's own step apart by at most "
              f"{own:.3g} lr")


def mnist_phase(torch, cmm, fa):
    """The paper's MNIST experiment on the card at full width (256-128-64-10):
    float training (4 epochs, accuracy > 0.93), QAT training through K1
    (fake_quant 4/4 bits, rows 16, 5-bit: exactly 3 K1 launches a step), the
    chip-geometry evaluation (bitplane, sar and sar_asym equal, within 0.05
    of float) and the Fig. 7c/7d sweeps (10 MHz beats 100 MHz by > 0.1),
    then the same params on the CPU: equal accuracy at the chip geometry and
    at 10 MHz."""
    from repro_torch.core.cim_linear import CiMConfig
    from repro_torch.core.noise import AnalogEnv
    from repro_torch.train import mnist_mlp as mm

    t0 = time.time()
    params, acc_f = mm.train_mlp(epochs=4, device="cuda")
    t_float = time.time() - t0
    if not acc_f > 0.93:
        raise AssertionError(f"[mnist] float accuracy {acc_f} <= 0.93")
    qat = CiMConfig(mode="fake_quant", a_bits=4, w_bits=4, adc_bits=5, rows=16, a_signed=False)
    per_step = []
    real = mm.sgd_step
    mm.sgd_step = _counted(torch, real, cmm, fa, per_step)
    try:
        t0 = time.time()
        _, acc_q = mm.train_mlp(epochs=4, qat_cim=qat, device="cuda")
        t_qat = time.time() - t0
    finally:
        mm.sgd_step = real
    if any(c != (3, 0) for c in per_step) or len(per_step) != 4 * 64:
        raise AssertionError(f"[mnist] QAT launches per step {sorted(set(per_step))} over {len(per_step)} steps, "
                             f"want (3, 0) in 256 steps")
    print(f"[mnist] 256-128-64-10, 4 epochs of 64 steps: float accuracy {acc_f:.4f} ({t_float:.2f} s); QAT "
          f"(fake_quant 4/4 bits, rows 16, 5-bit, STE) accuracy {acc_q:.4f} ({t_qat:.2f} s), K1 exactly 3 launches "
          f"a step over {len(per_step)} steps, K2 0")
    chip = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, a_signed=False, ste=False)
    t0 = time.time()
    acc_sar = mm.evaluate(params, chip, n_eval=2048)
    acc_asym = mm.evaluate(params, dataclasses.replace(chip, search="sar_asym"), n_eval=2048)
    if not (acc_sar >= acc_f - 0.05 and acc_sar == acc_asym):
        raise AssertionError(f"[mnist] chip geometry: sar {acc_sar}, sar_asym {acc_asym}, float {acc_f}")
    freq = {f: mm.evaluate(params, chip, AnalogEnv(freq_hz=f * 1e6), n_eval=512) for f in (10, 25, 50, 75, 100)}
    vdd = {v: mm.evaluate(params, chip, AnalogEnv(vdd=v), n_eval=512) for v in (1.0, 0.9, 0.8, 0.7, 0.6)}
    if not freq[10] > freq[100] + 0.1:
        raise AssertionError(f"[mnist] Fig. 7c: 10 MHz {freq[10]} does not beat 100 MHz {freq[100]} by 0.1")
    print(f"[mnist] chip geometry (bitplane 4/4 bits, rows 16, 5-bit), 2048 images: sar {acc_sar:.4f}, sar_asym "
          f"{acc_asym:.4f} (float {acc_f:.4f}); Fig. 7c (MHz: accuracy, 512 images) {freq}; Fig. 7d (VDD: "
          f"accuracy) {vdd}; {time.time() - t0:.2f} s")
    for env, n_eval in ((None, 512), (AnalogEnv(freq_hz=10e6), 64)):
        t0 = time.time()
        l_gpu, y = mm._eval_logits(params, chip, env, n_eval, 0, "cuda")
        l_cpu, _ = mm._eval_logits(params, chip, env, n_eval, 0, "cpu")
        acc_gpu = float(torch.mean((torch.argmax(l_gpu, -1) == y).float()))
        acc_cpu = float(torch.mean((torch.argmax(l_cpu, -1) == y.cpu()).float()))
        diff = float((l_gpu.cpu() - l_cpu).abs().max())
        where = "10 MHz" if env else "noiseless"
        if acc_gpu != acc_cpu:
            raise AssertionError(f"[mnist] {where}: card accuracy {acc_gpu} != CPU {acc_cpu}")
        print(f"[mnist] card vs CPU, chip geometry {where}, {n_eval} images: accuracy {acc_gpu:.4f} on both, largest "
              f"logit difference {diff:.3g} (max|logit| {float(l_cpu.abs().max()):.3g}); {time.time() - t0:.2f} s")
    return {"cim_matmul_fq": sum(c for c, _ in per_step), "flash_attention": 0}


def main() -> int:
    # cuBLAS needs a fixed workspace for deterministic results ([train]'s drill);
    # it must be set before the first cuBLAS call of the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on a GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import adc_quant as aq
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

    took, last = {}, [time.time()]

    def stamp(phases: str) -> None:  # seconds since the previous stamp, by phase
        took[phases] = round(time.time() - last[0], 1)
        last[0] = time.time()

    t0 = time.time()
    paths = build.build()
    print(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f} s into {build.build_dir()}")
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    stamp("build")

    k1 = kernel_phase_k1(torch, cmm, ref)
    k2 = kernel_phase_k2(torch, fa, ref)
    k3 = kernel_phase_k3(torch, cmm)
    k4 = kernel_phase_k4(torch, aq)
    stamp("k1-k4")
    served = {}  # the K1 shapes of the serve paths, checked in [k1-served]
    with k1_recorder(cmm, served, "serve"):
        launches, cfg, st, out = serve_phase(torch, cmm, fa)
    profile_phase(torch, cfg, st, out)
    k1["launches"], k2["launches"] = launches["cim_matmul_fq"], launches["flash_attention"]
    agreement_phase(torch)
    stamp("serve, profile, agree")
    ops_launches = ops_phase(torch, cmm, aq)
    k3["launches"], k4["launches"] = ops_launches["cim_matmul_bp"], ops_launches["adc_quant"]
    serve_bp_phase(torch, cmm, fa, aq)
    agreement_phase(torch, mode="bitplane", tag="agree-bp")
    stamp("ops, serve-bp, agree-bp")
    prng_phase(torch)
    fabric = fabric_phase(torch, cmm)
    k1["fabric_layer"] = fabric
    serve_fabric_phase(torch, cmm, fa)
    stamp("prng, fabric, serve-fabric")
    with k1_recorder(cmm, served, "shard"):
        shard = shard_phase(torch, cmm)
    stamp("shard")
    with k1_recorder(cmm, served, "program"):
        program = program_phase(torch, cmm)
    stamp("program")
    with k1_recorder(cmm, served, "serve-shard"):
        serve_shard_launches = serve_shard_phase(torch, cmm, fa)
    stamp("serve-shard")
    with k1_recorder(cmm, served, "graph"):
        graph = graph_phase(torch, cmm)
    stamp("graph")
    with k1_recorder(cmm, served, "autotune"):
        autotune = autotune_phase(torch, cmm)
    stamp("autotune")
    with k1_recorder(cmm, served, "serve-graph"):
        serve_graph_launches = serve_graph_phase(torch, cmm, fa)
    stamp("serve-graph")
    k1["shard_layer"], k1["program"], k1["graph"], k1["autotune"] = shard, program, graph, autotune
    with k1_recorder(cmm, served, "serve-moe"):
        moe_launches = serve_moe_phase(torch, cmm, fa)
    with k1_recorder(cmm, served, "serve-mamba"):
        mamba_launches = serve_mamba_phase(torch, cmm, fa)
    with k1_recorder(cmm, served, "serve-hybrid"):
        hybrid_launches = serve_hybrid_phase(torch, cmm, fa)
    stamp("serve-moe, serve-mamba, serve-hybrid")
    with k1_recorder(cmm, served, "train"):
        train_launches = train_phase(torch, cmm, fa)
    stamp("train")
    with k1_recorder(cmm, served, "mnist-qat"):
        mnist_launches = mnist_phase(torch, cmm, fa)
    stamp("mnist")
    example_launches = example_phase(torch, cmm, fa, aq, served)
    stamp("example")
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_served_phase(torch, cmm, served))
    stamp("k1-served")
    for impl in ("dense", "scatter"):
        agreement_phase(torch, arch="qwen3-moe-30b-a3b", tag="agree-moe", moe_impl=impl)
    agreement_phase(torch, arch="mamba2-130m", tag="agree-mamba")
    agreement_phase(torch, arch="zamba2-7b", tag="agree-hybrid")
    stamp("agree-moe, agree-mamba, agree-hybrid")
    agreement_train_phase(torch)
    stamp("agree-train")
    dryrun_launches = dryrun_phase(torch, cmm, fa)
    stamp("dryrun")
    int8_phase(torch)
    serve_int8_launches = serve_int8_phase(torch, cmm, fa)
    agreement_phase(torch, mode="int8_dot", tag="agree-int8", kv_quant_int8=True)
    stamp("int8, serve-int8, agree-int8")
    print(f"[time] host seconds by phase: {took}; {sum(took.values()):.1f} s in all")
    paths = {"serve": launches, "serve-moe dense": moe_launches["dense"],
             "serve-moe scatter": moe_launches["scatter"], "serve-mamba": mamba_launches,
             "serve-hybrid": hybrid_launches,
             "shard": {"cim_matmul_fq": sum(v["launches"] for v in shard.values() if isinstance(v, dict)),
                       "flash_attention": 0},
             "program": {"cim_matmul_fq": sum(v["launches"] for v in program.values()), "flash_attention": 0},
             **{f"serve-shard {tag}": counts for tag, counts in serve_shard_launches.items()},
             **{f"graph {tag}": {"cim_matmul_fq": v["launches"], "flash_attention": 0}
                for tag, v in graph.items() if "launches" in v},
             "graph smollm 1x3 scanned": {"cim_matmul_fq": graph["smollm 1x3"]["scan_launches"], "flash_attention": 0},
             "autotune": {"cim_matmul_fq": autotune["launches"], "flash_attention": 0},
             **{f"serve-graph {tag}": counts for tag, counts in serve_graph_launches.items()},
             "train": train_launches, "mnist-qat": mnist_launches, "dryrun train step": dryrun_launches,
             "serve-int8": serve_int8_launches,
             **{f"example {tag}": counts for tag, counts in example_launches.items()}}
    for entry, name in ((k1, "cim_matmul_fq"), (k2, "flash_attention")):
        entry["launches_by_path"] = {path: counts[name] for path, counts in paths.items()}

    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
