"""The yardstick's arithmetic against hand counts: K1's and K2's bounds,
one model forward's linears, the SSD, the idle union with overlapping
kernels, and the roofline and MFU readers on a synthetic record."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import peaks, readers, trace, work
from portbench.traffic import Call

ROOT = Path(__file__).resolve().parents[2]
SMOLLM = json.loads((ROOT / "portbench" / "configs" / "smollm-135m.json").read_text())["run"]
ZAMBA = json.loads((ROOT / "portbench" / "configs" / "zamba2-7b.json").read_text())["run"]


def test_k1_bound_by_hand():
    # M 4096, K 576, N 1536: 2*M*K*N int8 ops against 8-bit operands and a bf16 output
    ops = 2 * 4096 * 576 * 1536
    n_bytes = 4096 * 576 + 576 * 1536 + 2 * 4096 * 1536
    want = max(ops / 1979e12, n_bytes / 3.35e12)
    assert work.k1_seconds(SMOLLM, work.Linear(4096, 576, 1536)) == pytest.approx(want, rel=1e-12)
    # decode: M 128 against the weights of a 3584 x 7168 projection is bound by its bytes
    lin = work.Linear(128, 3584, 7168)
    assert work.k1_seconds(ZAMBA, lin) == pytest.approx((128 * 3584 + 3584 * 7168 + 2 * 128 * 7168) / 3.35e12)


def test_k2_bound_by_hand():
    # B 4, H 32, KV 32, S 4096, hd 112 (not the kernel's padded 128): causal pairs S(S+1)/2
    flops = 4 * 4 * 32 * (4096 * 4097 // 2) * 112
    n_bytes = (2 * 4 * 4096 * 32 * 112 + 2 * 4 * 4096 * 32 * 112) * 2
    assert work.attention_seconds(ZAMBA, 4, 32, 32, 4096, 112) == pytest.approx(
        max(flops / 989.4e12, n_bytes / 3.35e12), rel=1e-12)
    assert work.attention_calls(ZAMBA, Call(0, 4, 4096, 1)) == [(4, 32, 32, 4096, 112)] * 2
    assert work.attention_calls(SMOLLM, Call(0, 32, 1024, 1)) == [(32, 9, 3, 1024, 64)] * 30


def test_one_forward_by_hand():
    lins = work.cim_linears(SMOLLM, Call(0, 2, 8, 1))
    assert len(lins) == 7 * 30 and {lin.m for lin in lins} == {16}
    per_layer = 576 * 576 * 2 + 576 * 192 * 2 + 576 * 1536 * 2 + 1536 * 576
    assert sum(lin.k * lin.n for lin in lins) == 30 * per_layer
    z = work.cim_linears(ZAMBA, Call(0, 1, 1, 1))
    mamba = 3584 * 7168 * 2 + 3584 * 64 * 2 + 3584 * 112 + 7168 * 3584
    shared = 3584 * 3584 * 4 + 3584 * 14336 * 3
    assert len(z) == 6 * 13 + 7 * 2 and sum(lin.k * lin.n for lin in z) == 13 * mamba + 2 * shared
    # a call of 3 tokens: one prefill forward and two decode steps of `batch` rows
    assert [f for f in work.forwards(Call(0, 4, 16, 3))] == [(64, 16), (4, 1), (4, 1)]


def test_ssd_flops_by_hand():
    q, h, p, n = 128, 112, 64, 64
    per_chunk = 2 * q * q * n + 2 * q * q * h * p + 4 * q * h * p * n
    want = 13 * (3 * 1 * per_chunk + 3 * 2 * 4 * h * p * n)
    assert work.ssd_flops(ZAMBA, Call(0, 3, 128, 3)) == want
    assert work.ssd_flops(SMOLLM, Call(0, 3, 128, 3)) == 0


def test_idle_union_counts_overlap_once():
    events = [("k1", 100, 300), ("k2", 200, 400), ("k3", 250, 260), ("Memcpy DtoH", 500, 600), ("k1", 900, 1100)]
    dt = trace.reduce_events(events, 0, 1000)
    assert dt.busy_s == pytest.approx(500e-9)  # [100, 400], [500, 600] and [900, 1000]: k1 clipped at the window
    assert dt.window_s == pytest.approx(1e-6)
    assert dt.launches == 4 and dt.by_name["k1"][0] == 2
    assert dt.gaps[0] == (600, 900)
    assert sorted(dt.gaps) == [(0, 100), (400, 500), (600, 900)]
    spans = [("bench.call", 50, 950, 0), ("serve.prefill", 50, 450, 0)]
    assert trace.label_gaps(dt.gaps, spans)[0] == ["bench.call (call 0)", 3e-7]
    assert trace.label_gaps(dt.gaps, spans)[2] == ["serve.prefill (call 0)", 1e-7]
    assert trace.top_ops(dt.by_name, 2) == [["k1", pytest.approx(4e-7)], ["k2", pytest.approx(2e-7)]]


def _record(run, call, kernels):
    c = SimpleNamespace(call=call, wall_s=0.5, prefill_s=0.4, decode_s=0.1)
    dt = trace.reduce_events(kernels, 0, 10**9)
    return SimpleNamespace(run=run, calls=[c, c], profiled=[c], trace=dt, window_s=1.25, setup_s=3.0)


def test_roofline_and_mfu_readers_on_synthetic_events():
    call = Call(0, 2, 256, 1)
    k1_ns = 2_000_000
    rec = _record(SMOLLM, call, [("void (anonymous namespace)::cim_fq_kernel<2, false>(signed char const*, int)", 0, k1_ns),
                                 ("void (anonymous namespace)::flash_tc_kernel<float, 64, 3>(float const*)", k1_ns, k1_ns + 500_000),
                                 ("elementwise", 3_000_000, 3_100_000)])
    bound = sum(work.k1_seconds(SMOLLM, lin) for lin in work.cim_linears(SMOLLM, call))
    assert readers.k1_roofline(rec) == pytest.approx(100 * bound / 2e-3)
    k2 = 30 * work.attention_seconds(SMOLLM, 2, 9, 3, 256, 64)
    assert readers.k2_roofline(rec) == pytest.approx(100 * k2 / 5e-4)
    assert readers.idle_pct(rec) == pytest.approx(100 * (1 - 2.6e-3))
    assert readers.launches_per_forward(rec) == 3
    assert readers.tokens_per_s(rec, "prompt") == pytest.approx(2 * 2 * 256 / 1.0)
    ideal = 2 * work.model_ideal_seconds(SMOLLM, call)
    assert readers.mfu_pct(rec) == pytest.approx(100 * ideal / 1.25)
    int8 = sum(2 * lin.m * lin.k * lin.n for lin in work.cim_linears(SMOLLM, call))
    bf16 = work.attention_flops(SMOLLM, call) + work.unembed_flops(SMOLLM, call)
    assert work.model_ideal_seconds(SMOLLM, call) == pytest.approx(int8 / peaks.PEAK_INT8_OPS + bf16 / peaks.PEAK_BF16_FLOPS)
    empty = _record(SMOLLM, call, [("elementwise", 0, 10)])
    assert readers.k1_roofline(empty) is None and readers.k2_roofline(empty) is None


def test_decode_step_reader():
    call = Call(0, 128, 128, 128)
    c = SimpleNamespace(call=call, wall_s=10.0, prefill_s=1.0, decode_s=8.89)
    rec = SimpleNamespace(calls=[c, c])
    assert readers.decode_step_ms(rec) == pytest.approx(1e3 * 8.89 / 127)
    assert readers.tokens_per_s(rec, "generated") == pytest.approx(128 * 128 / 10.0)
