"""``span_times.py`` on synthetic profiles: each device operation goes to the
innermost span open at its launch, operations launched outside every span
or with no launch record are counted as such, and the per-layer numbers
are the ones worked out by hand."""

from __future__ import annotations

import pytest

import span_times as T


def _span(name, s, e, **attrs):
    return {"name": name, "start_ns": s, "end_ns": e, "attrs": attrs}


SPANS = [_span("serve.decode", 10, 900), _span("serve.decode_step", 15, 880, step=0), _span("layer.mamba2", 20, 400),
         _span("cim.quantize", 30, 60, operand="x", bytes=3 * 10**9), _span("cim.matmul", 70, 90),
         _span("layer.unembed", 500, 600)]
LAUNCHES = {1: 40, 2: 80, 3: 200, 4: 550, 5: 950, 6: 60}
OPS = [("abs", 100, 110, 1), ("void cim_fq_kernel<2>", 110, 150, 2), ("add", 210, 220, 3), ("gemv", 600, 700, 4),
       ("late", 1600, 1610, 5), ("no record", 1700, 1750, 7), ("amax", 160, 190, 6)]


def test_launch_attribution_takes_the_innermost_span():
    att = T.attribute(OPS, LAUNCHES, SPANS)
    assert att.span == [3, 4, 2, 5, T.OUTSIDE, None, 3]  # a launch at a span's own end is still in it
    assert att.parent == [T.OUTSIDE, 0, 1, 2, 2, 1]
    assert T.seconds_by_span(OPS, att, SPANS) == {
        "cim.quantize": {"abs": pytest.approx(1e-8), "amax": pytest.approx(3e-8)},
        "cim.matmul": {"void cim_fq_kernel<2>": pytest.approx(4e-8)}, "layer.mamba2": {"add": pytest.approx(1e-8)},
        "layer.unembed": {"gemv": pytest.approx(1e-7)}, "(outside every span)": {"late": pytest.approx(1e-8)},
        "(no launch record)": {"no record": pytest.approx(5e-8)}}
    assert T.under(att, SPANS, ("serve.decode",)) == [True] * 6
    # a span opened where another ends lies beside it, not in it
    att = T.attribute([("k", 0, 1, 1), ("k", 0, 1, 2)], {1: 15, 2: 25},
                      [_span("a", 0, 30), _span("b", 10, 20), _span("c", 20, 30)])
    assert att.span == [1, 2] and att.parent == [T.OUTSIDE, 0, 0]


def test_span_numbers_and_report_by_hand():
    spans = SPANS + [_span("serve.decode_step", 1000 + 10**7 * i, 1000 + 10**7 * i + d, step=i + 1)
                     for i, d in enumerate((2_000_000, 7_000_000))]
    att = T.attribute(OPS, LAUNCHES, spans)
    n = T.span_numbers(OPS, att, spans, forwards=4)
    assert n["quant_ms"] == pytest.approx(40e-6 / 4) and n["quant_gb"] == pytest.approx(3.0 / 4)
    # the 90th percentile of 0.000865, 2 and 7 ms, linear between order statistics: 2 + 0.8 * (7 - 2)
    assert n["decode_step_p90_ms"] == pytest.approx(6.0)
    lines = []
    out = T.report(OPS, LAUNCHES, spans, 4, lines.append)
    assert out["device_s"] == pytest.approx(2.5e-7) and out["unrecorded_s"] == pytest.approx(5e-8)
    assert sum(out["device_s_by_span"].values()) == pytest.approx(out["device_s"])
    assert (out["k1_launches"], out["k1_in_cim_matmul"]) == (1, 1)
    assert out["served_pct"] == pytest.approx(100 * 1.9e-7 / 2.5e-7)
    assert lines[0].startswith("device seconds by span (7 operations, 8 spans")
    bare = SPANS[:1]
    assert T.span_numbers(OPS, T.attribute(OPS, LAUNCHES, bare), bare, 4) == {
        "quant_ms": 0.0, "quant_gb": 0.0, "decode_step_p90_ms": None}
