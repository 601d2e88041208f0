"""The work a served call needs, counted from the configuration and the
call's shapes alone. The benchmark never reads the program's own counters,
so this yardstick stays the same whatever implements the work.

Each mechanism has a function of its own. Shapes are the model's, unpadded:
attention at the model's head size, the reduction of a CiM linear at K.
"""

from __future__ import annotations

from typing import NamedTuple

from portbench import peaks

__all__ = [
    "Linear", "cim_linears", "k1_seconds", "attention_seconds", "attention_calls",
    "ssd_flops", "unembed_flops", "model_ideal_seconds", "forwards",
]


class Linear(NamedTuple):
    m: int
    k: int
    n: int


def _dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[name]


def _layer_linears(run: dict, m: int) -> list:
    """CiM linears of one forward over ``m`` token rows, in the order the
    model runs them (dense: 7 a layer; hybrid: 5 in-projections and the
    out-projection of each Mamba2 layer, 7 for each shared-block application)."""
    d = run["d_model"]
    attn = []
    if run.get("n_heads"):
        h, kv, hd, f = run["n_heads"], run["n_kv_heads"], run["head_dim"], run["d_ff"]
        attn = [Linear(m, d, h * hd), Linear(m, d, kv * hd), Linear(m, d, kv * hd), Linear(m, h * hd, d),
                Linear(m, d, f), Linear(m, d, f), Linear(m, f, d)]
    if run["family"] == "dense":
        return attn * run["n_layers"]
    if run["family"] == "hybrid":
        di = run["ssm_expand"] * d
        heads = di // run["ssm_headdim"]
        n = run["ssm_state"]
        mamba = [Linear(m, d, di), Linear(m, d, di), Linear(m, d, n), Linear(m, d, n), Linear(m, d, heads),
                 Linear(m, di, d)]
        groups = run["n_layers"] // run["share_period"]
        return mamba * run["n_layers"] + attn * groups
    raise ValueError(f"no work count for family {run['family']!r}")


def forwards(call) -> list:
    """(rows, positions) of each forward of a served call: the prefill over
    batch x prompt, then one step of ``batch`` rows per further token."""
    return [(call.batch * call.prompt_len, call.prompt_len)] + [(call.batch, 1)] * (call.gen_len - 1)


def cim_linears(run: dict, call) -> list:
    """Every CiM linear of a served call."""
    return [lin for rows, _ in forwards(call) for lin in _layer_linears(run, rows)]


def k1_seconds(run: dict, lin: Linear) -> float:
    """The least time of one CiM linear on the card: the larger of its
    2·M·K·N int8 operations at the int8 peak and its bytes (operands at
    ``a_bits`` / ``w_bits``, the output in the compute dtype) at HBM speed."""
    cim = run["cim"]
    ops = 2.0 * lin.m * lin.k * lin.n
    n_bytes = (lin.m * lin.k * cim["a_bits"] + lin.k * lin.n * cim["w_bits"]) / 8 \
        + lin.m * lin.n * _dtype_bytes(run["compute_dtype"])
    return max(ops / peaks.PEAK_INT8_OPS, n_bytes / peaks.HBM_BYTES_PER_S)


def _causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_calls(run: dict, call) -> list:
    """(batch, heads, kv_heads, seq, head_dim) of each prefill attention of a
    call: one per attention layer (dense) or shared-block application
    (hybrid). Decode steps attend through the cache in plain PyTorch."""
    if not run.get("n_heads"):
        return []
    n = run["n_layers"] if run["family"] == "dense" else run["n_layers"] // run["share_period"]
    return [(call.batch, run["n_heads"], run["n_kv_heads"], call.prompt_len, run["head_dim"])] * n


def attention_seconds(run: dict, b: int, h: int, kv: int, s: int, hd: int) -> float:
    """The least time of one causal prefill attention: 4·hd FLOPs per
    (query, key) pair at or below the diagonal at the bf16 peak, or q, k, v
    and o read or written once in the compute dtype, whichever is longer."""
    flops = 4.0 * b * h * _causal_pairs(s) * hd
    n_bytes = (2 * b * s * h * hd + 2 * b * s * kv * hd) * _dtype_bytes(run["compute_dtype"])
    return max(flops / peaks.PEAK_BF16_FLOPS, n_bytes / peaks.HBM_BYTES_PER_S)


def attention_flops(run: dict, call) -> float:
    """Attention FLOPs of a call: the prefill's causal pairs and, per decode
    step, each row's query against every cached key before it."""
    if not run.get("n_heads"):
        return 0.0
    apps = run["n_layers"] if run["family"] == "dense" else run["n_layers"] // run["share_period"]
    h, hd = run["n_heads"], run["head_dim"]
    keys = _causal_pairs(call.prompt_len) + sum(call.prompt_len + i + 1 for i in range(call.gen_len - 1))
    return 4.0 * call.batch * h * hd * keys * apps


def ssd_flops(run: dict, call) -> float:
    """Mamba2 SSD FLOPs of a call. Prefill over chunks of Q = min(chunk,
    prompt) positions, per chunk and batch row (H heads of P, state N):
    C·Bᵀ 2Q²N, the intra-chunk mix 2Q²HP, the chunk state 2QHPN, the
    inter-chunk output 2QHPN. A decode step per row: the state update 2HPN
    and the output 2HPN. The depthwise conv and the gates are not counted."""
    if run["family"] != "hybrid":
        return 0.0
    di = run["ssm_expand"] * run["d_model"]
    p, n = run["ssm_headdim"], run["ssm_state"]
    h = di // p
    q = min(run["ssm_chunk"], call.prompt_len)
    chunks = -(-call.prompt_len // q)
    per_chunk = 2 * q * q * n + 2 * q * q * h * p + 4 * q * h * p * n
    prefill = call.batch * chunks * per_chunk
    decode = call.batch * (call.gen_len - 1) * 4 * h * p * n
    return float(run["n_layers"] * (prefill + decode))


def unembed_flops(run: dict, call) -> float:
    """The logits of each row's last position of every forward (the
    program's prefill reads only the last position)."""
    return 2.0 * call.batch * call.gen_len * run["d_model"] * run["vocab"]


def model_ideal_seconds(run: dict, call) -> float:
    """A call's model FLOPs, each at the peak of its own arithmetic: CiM
    linears at the int8 peak, attention, SSD and the unembedding at the bf16
    peak. A step's share of the chip's peak is this over its wall time."""
    int8 = sum(2.0 * lin.m * lin.k * lin.n for lin in cim_linears(run, call))
    bf16 = attention_flops(run, call) + ssd_flops(run, call) + unembed_flops(run, call)
    return int8 / peaks.PEAK_INT8_OPS + bf16 / peaks.PEAK_BF16_FLOPS
