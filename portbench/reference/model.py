"""The served models in plain PyTorch: float32 arithmetic, TF32 off, no
kernels, no import of the program.

A frozen copy of the served path's arithmetic in ``src/repro_torch``
(``models/layers.py``, ``transformer.py``, ``mamba2.py``, ``zamba2.py`` and
``launch/serve.py``'s prefill-then-decode loop) for the ``dense`` and
``hybrid`` families. Every value the configuration holds in its compute
dtype is rounded to the reference's activation precision (``rnd``), at the
same points; everything else is float32. The CiM linears are
:class:`~portbench.reference.fakequant.FakeQuantLinear`; prefill attention is
a plain softmax over each batch row (the program runs its flash kernel).

The reference follows the program's calls: one prefill over the whole
batch, then one step per served token, teacher-forced with the tokens
served. The activation's quantization scale is taken per call over the
whole batch, so a single forward over prompt and tokens would be another
quantization, and another model. It keeps its own caches and states, and
works out again every scale and code.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.fakequant import FakeQuantLinear

__all__ = ["Reference", "rounder", "scale_rounder"]

_NEG = -1e30
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def scale_rounder(precision: str):
    """Rounding of the activation's quantization scale: to ``precision``,
    but float32 under float8, whose range cannot hold a small activation's
    scale (float8 practice keeps scales in float32)."""
    return rounder("float32" if precision.startswith("float8") else precision)


def rounder(precision: str):
    """Rounding to ``precision`` of float32 values, kept in float32."""
    if precision == "float32":
        return lambda t: t
    if precision == "bfloat16":
        return lambda t: t.to(torch.bfloat16).float()
    if precision == "float8_e4m3fn":  # saturating, as fp8 kernels cast
        return lambda t: torch.clamp(t, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    raise ValueError(f"no rounding to {precision!r}")


def _rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


class Reference:
    """One served batch of ``run`` (the configuration's ``run`` group) over
    ``params`` (the same tensors the program serves), at ``precision``."""

    def __init__(self, run: dict, params: dict, precision: str = "bfloat16"):
        self.run = run
        self.rnd = rounder(precision)
        self.rnd_scale = scale_rounder(precision)
        self.p = params
        if run["cim"]["mode"] == "exact":  # plain products: the tests' check of decode against a full forward
            self.lin = lambda x, w, rnd, _: rnd(x @ rnd(w.float()))
        else:
            self.lin = FakeQuantLinear(run["cim"])
        self.dev = params["embed"]["tok"].device
        self.eps = run["norm_eps"]

    # -- primitives ---------------------------------------------------------

    def dense(self, x, w):
        return self.lin(x, w, self.rnd, self.rnd_scale)

    def rms_norm(self, x, scale):
        r = self.rnd
        var = (torch.einsum("...d,...d->...", x, x) / x.shape[-1])[..., None]
        inv = r(torch.rsqrt(var + self.eps))
        return r(r(x * inv) * r(1.0 + r(scale.float())))

    def rope(self, x, positions):
        hd = x.shape[-1]
        freqs = torch.tensor(_rope_freqs(hd, self.run["rope_theta"]), dtype=torch.float32, device=x.device)
        ang = positions.float()[..., None] * freqs
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return self.rnd(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1))

    def silu(self, x):
        return self.rnd(F.silu(x))

    def embed(self, ids):
        return self.rnd(self.p["embed"]["tok"][ids.long()].float())

    def logits(self, h):
        """(B, V) logits of the last position of ``h`` (B, S, D)."""
        e = self.p["embed"]
        w = e["tok"].T if self.run["tie_embeddings"] else e["unembed"]
        return self.rnd(h[:, -1, :] @ self.rnd(w.float()))

    # -- attention ------------------------------------------------------------

    def _qkv(self, p, x, positions):
        b, s, _ = x.shape
        h, kv, hd = self.run["n_heads"], self.run["n_kv_heads"], self.run["head_dim"]
        q = self.dense(x, p["wq"]).reshape(b, s, h, hd)
        k = self.dense(x, p["wk"]).reshape(b, s, kv, hd)
        v = self.dense(x, p["wv"]).reshape(b, s, kv, hd)
        return self.rope(q, positions), self.rope(k, positions), v

    def attention(self, p, x, cache):
        """Causal prefill attention; fills ``cache`` (float32, full length)."""
        b, s, _ = x.shape
        h, kv, hd = self.run["n_heads"], self.run["n_kv_heads"], self.run["head_dim"]
        g = h // kv
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        q, k, v = self._qkv(p, x, positions)
        q = q.reshape(b, s, kv, g, hd) / np.sqrt(hd)
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        out = torch.empty((b, s, kv, g, hd), device=x.device)
        for i in range(b):  # one batch row at a time: (H, S, S) scores
            sc = torch.einsum("qkgd,ckd->kgqc", q[i], k[i])
            sc = torch.where(causal, sc, torch.full_like(sc, _NEG))
            out[i] = torch.einsum("kgqc,ckd->qkgd", torch.softmax(sc, dim=-1), v[i])
        cache["k"][:, :s], cache["v"][:, :s] = k, v
        cache["pos"][:s] = positions
        return self.dense(self.rnd(out).reshape(b, s, h * hd), p["wo"])

    def decode_attention(self, p, x, pos, cache):
        b = x.shape[0]
        h, kv, hd = self.run["n_heads"], self.run["n_kv_heads"], self.run["head_dim"]
        g = h // kv
        q, k, v = self._qkv(p, x, torch.tensor([pos], dtype=torch.int32, device=x.device))
        cache["k"][:, pos:pos + 1], cache["v"][:, pos:pos + 1] = k, v
        cache["pos"][pos] = pos
        cpos = cache["pos"]
        vmask = ((cpos <= pos) & (cpos >= 0))[None, None, None, None, :]
        qh = q.reshape(b, 1, kv, g, hd) / np.sqrt(hd)
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, cache["k"])
        s = torch.where(vmask, s, torch.full_like(s, _NEG))
        m = s.amax(dim=-1, keepdim=True)
        pattn = torch.exp(s - m) * vmask.float()
        out = torch.einsum("bqkgc,bckd->bqkgd", pattn, cache["v"])
        out = out / torch.clamp(pattn.sum(-1)[..., None], min=1e-30)
        return self.dense(self.rnd(out).reshape(b, 1, h * hd), p["wo"])

    def mlp(self, p, x):
        gate = self.dense(x, p["w_gate"])
        up = self.dense(x, p["w_up"])
        return self.dense(self.rnd(self.silu(gate) * up), p["w_down"])

    def attn_cache(self, n, b, total):
        kv, hd = self.run["n_kv_heads"], self.run["head_dim"]
        z = lambda: torch.zeros((b, total, kv, hd), device=self.dev)  # noqa: E731
        return [{"k": z(), "v": z(), "pos": torch.full((total,), -1, dtype=torch.int32, device=self.dev)}
                for _ in range(n)]

    # -- Mamba2 ---------------------------------------------------------------

    def _conv(self, x, w, bias):
        r = self.rnd
        width, s = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, width - 1, 0))
        y = r(xp[:, 0:s, :] * w[0])
        for i in range(1, width):
            y = r(y + r(xp[:, i:i + s, :] * w[i]))
        return r(y + bias)

    def mamba(self, p, x, state):
        """Chunked SSD over the prompt from a zero state; fills ``state``."""
        r, run = self.rnd, self.run
        bsz, s_orig, _ = x.shape
        d = run["d_model"]
        di, ph, n = run["ssm_expand"] * d, run["ssm_headdim"], run["ssm_state"]
        h = di // ph
        q = min(run["ssm_chunk"], s_orig)
        pad = (-s_orig) % q
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        s = s_orig + pad
        nc = s // q
        seq_mask = (torch.arange(s, device=x.device) < s_orig).float()
        z = self.dense(x, p["in_z"])
        xs = self.dense(x, p["in_x"])
        b_ = self.dense(x, p["in_b"])
        c_ = self.dense(x, p["in_c"])
        dt = self.dense(x, p["in_dt"])
        xs_raw, b_raw, c_raw = xs, b_, c_
        cw = lambda t: r(t.float())  # noqa: E731
        xs = self.silu(self._conv(xs, cw(p["conv_x"]), cw(p["conv_x_bias"])))
        b_ = self.silu(self._conv(b_, cw(p["conv_b"]), cw(p["conv_b_bias"])))
        c_ = self.silu(self._conv(c_, cw(p["conv_c"]), cw(p["conv_c_bias"])))
        xs = xs.reshape(bsz, s, h, ph)

        dt = torch.logaddexp(dt + p["dt_bias"], torch.zeros_like(dt))
        dt = dt * seq_mask[None, :, None]
        a = -torch.exp(p["A_log"])
        da = dt * a
        xf = xs.reshape(bsz, nc, q, h, ph)
        bf = b_.reshape(bsz, nc, q, n)
        cf = c_.reshape(bsz, nc, q, n)
        dtc = dt.reshape(bsz, nc, q, h)
        da_cs = torch.cumsum(da.reshape(bsz, nc, q, h), dim=2)
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        y = torch.empty((bsz, nc, q, h, ph), device=x.device)
        for i in range(bsz):  # one batch row at a time: (NC, Q, Q, H) decays
            att = torch.einsum("cqn,ckn->cqk", cf[i], bf[i])
            seg = da_cs[i, :, :, None, :] - da_cs[i, :, None, :, :]
            decay = torch.exp(torch.where(causal[None, :, :, None], seg, -torch.inf))
            y[i] = torch.einsum("cqkh,ckhp->cqhp", att[..., None] * decay * dtc[i, :, None, :, :], xf[i])
            del seg, decay
        decay_out = torch.exp(da_cs[:, :, -1:, :] - da_cs)
        sterm = torch.einsum("bckn,bckh,bckhp->bchpn", bf, dtc * decay_out, xf)
        chunk_decay = torch.exp(da_cs[:, :, -1, :])
        s_prev = torch.zeros((bsz, h, ph, n), device=x.device)
        s_prevs = []
        for c in range(nc):
            s_prevs.append(s_prev)
            s_prev = s_prev * chunk_decay[:, c, :, None, None] + sterm[:, c]
        s_last, s_prevs = s_prev, torch.stack(s_prevs, dim=1)
        y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cf, s_prevs, torch.exp(da_cs))
        y = (y + y_off).reshape(bsz, s, h, ph)
        y = y + p["D"][None, None, :, None] * xs
        y = r(y.reshape(bsz, s, di))[:, :s_orig]
        y = self.rms_norm(r(y * self.silu(z[:, :s_orig])), p["norm"])
        out = self.dense(y, p["out_proj"])
        w1 = run["ssm_conv_width"] - 1

        def tail(t):
            return F.pad(t[:, :s_orig], (0, 0, max(0, w1 - s_orig), 0))[:, -w1:, :]

        state["ssm"] = s_last
        for name, t in (("conv_x", xs_raw), ("conv_b", b_raw), ("conv_c", c_raw)):
            state[name] = tail(t)
        return out

    def mamba_step(self, p, x, state):
        """One token through the state recurrence; updates ``state``."""
        r, run = self.rnd, self.run
        bsz = x.shape[0]
        di, ph = run["ssm_expand"] * run["d_model"], run["ssm_headdim"]
        h = di // ph
        x0 = x[:, 0, :]
        z = self.dense(x0, p["in_z"])
        xs = self.dense(x0, p["in_x"])
        b_ = self.dense(x0, p["in_b"])
        c_ = self.dense(x0, p["in_c"])
        dt = self.dense(x0, p["in_dt"])

        def conv_step(name, new):
            win = torch.cat([state[name], new[:, None, :]], dim=1)
            out = F.silu(torch.einsum("bwc,wc->bc", win, p[name].float()) + r(p[name + "_bias"].float()))
            state[name] = win[:, 1:, :]
            return out

        xs_c = conv_step("conv_x", xs).reshape(bsz, h, ph)
        b_c = conv_step("conv_b", b_)
        c_c = conv_step("conv_c", c_)
        dt = torch.logaddexp(dt + p["dt_bias"], torch.zeros_like(dt))
        da = torch.exp(dt * -torch.exp(p["A_log"]))
        s_new = state["ssm"] * da[:, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xs_c, b_c)
        state["ssm"] = s_new
        y = torch.einsum("bhpn,bn->bhp", s_new, c_c) + p["D"][None, :, None] * xs_c
        y = r(y.reshape(bsz, 1, di))
        y = self.rms_norm(r(y * self.silu(z[:, None, :])), p["norm"])
        return self.dense(y, p["out_proj"])

    # -- whole models ---------------------------------------------------------

    def _schedule(self):
        run = self.run
        if run["family"] == "dense":
            for i in range(run["n_layers"]):
                yield "block", i
            return
        period = run["share_period"]
        g = run["n_layers"] // period
        for j in range(g):
            for i in range(j * period, (j + 1) * period):
                yield "mamba", i
            yield "shared", j
        for i in range(g * period, run["n_layers"]):
            yield "mamba", i

    def _layer(self, tree, i):
        return {k: (self._layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}

    def _block(self, lp, ln1, ln2, x, cache, pos):
        hn = self.rms_norm(x, ln1)
        if pos is None:
            a = self.attention(lp["attn"], hn, cache)
        else:
            a = self.decode_attention(lp["attn"], hn, pos, cache)
        x = self.rnd(x + a)
        return self.rnd(x + self.mlp(lp["mlp"], self.rms_norm(x, ln2)))

    def _walk(self, x, pos=None):
        p = self.p
        for kind, i in self._schedule():
            if kind == "block":
                lp = self._layer({"attn": p["attn"], "mlp": p["mlp"]}, i)
                x = self._block(lp, p["ln1"][i], p["ln2"][i], x, self.caches[i], pos)
            elif kind == "shared":
                sh = p["shared"]
                x = self._block(sh, sh["ln1"], sh["ln2"], x, self.caches[i], pos)
            else:
                hn = self.rms_norm(x, p["mamba_ln"][i])
                lp = self._layer(p["mamba"], i)
                y = self.mamba(lp, hn, self.states[i]) if pos is None else self.mamba_step(lp, hn, self.states[i])
                x = self.rnd(x + y)
        return self.rms_norm(x, p["ln_f"])

    def prefill(self, prompts: torch.Tensor, gen_len: int) -> torch.Tensor:
        """The prompts (B, S) through the model; returns the (B, V) logits
        of the last position and keeps the caches for ``gen_len - 1`` steps."""
        b, s = prompts.shape
        run = self.run
        n_attn = run["n_layers"] if run["family"] == "dense" else run["n_layers"] // run["share_period"]
        self.caches = self.attn_cache(n_attn, b, s + gen_len) if run.get("n_heads") else []
        self.states = [{} for _ in range(run["n_layers"])] if run["family"] == "hybrid" else []
        self.pos = s
        return self.logits(self._walk(self.embed(prompts)))

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step on the served tokens (B,); returns (B, V) logits."""
        x = self.embed(tokens[:, None])
        out = self.logits(self._walk(x, pos=self.pos))
        self.pos += 1
        return out
