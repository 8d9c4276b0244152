"""Chunked linear attention, the Mamba2 (SSD) block and the RWKV-6 block
on PyTorch (a port of the reference's ``repro/models/linear_attn.py``).

Both architectures are instances of one recurrence
    S_t = Diag(w_t) S_{t-1} + k_t^T v_t,     y_t = q_t S_t (+ diag terms)
with different decay shapes (Mamba2: a scalar per head; RWKV-6:
data-dependent per key channel). Prefill uses the chunkwise parallel form
(an intra-chunk attention matrix and an inter-chunk state carry), a
Python loop over chunks; decode is the O(1) recurrent step on a
[dk, dv] state.

The reference computes all of it in plain ``jnp`` (no Pallas kernel), so
the products here are ``torch.einsum`` / ``torch.matmul``. Its float path
is kept as it is, the chunk's ``exp(-logp)`` included (no "stable"
rewrite), and so is its dtype path: where the reference multiplies an f32
activation by a bf16 weight, JAX promotes the product to f32, so the
port takes an exact f32 copy of the weight (``_f32mm``); elementwise bf16
steps round as the reference's jaxpr does (``layers.silu``,
``layers.sigmoid``, ``softplus`` as ``logaddexp(x, 0)``, the causal
convolution's sum in its order and dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers
from repro_torch.utils.meshctx import constrain, on_shards

Params = Dict[str, torch.Tensor]


def _f32mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as JAX promotes it: an f32 operand makes it an f32 GEMM
    (the bf16 one upcast, exactly); two bf16 operands stay bf16."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as its jaxpr runs it,
    max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# Core chunked recurrence
# ---------------------------------------------------------------------------

# Instrumentation: while LOGP_MAX is a list, chunked_linear_attention
# appends to it each chunk's largest |logp| (the within-chunk cumulative
# log decay), as a detached device scalar (no host sync, nothing saved
# for autograd). exp(-logp) scales the chunk's keys, and f32 overflows
# past e^88.7.
LOGP_MAX: Optional[list] = None


def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, log_w: torch.Tensor, *,
                             u: Optional[torch.Tensor] = None,
                             s0: Optional[torch.Tensor] = None,
                             chunk: int = 64
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise parallel linear attention.

    q, k:   [B, T, H, dk] (any float dtype; each chunk is taken in f32)
    v:      [B, T, H, dv]
    log_w:  [B, T, H, dk] log decay (<= 0), applied to the key dim
    u:      optional f32[H, dk] RWKV "bonus" for the current token; if
            given, the recurrence reads S_{t-1} (strict causality) and adds
            (q_t . (u*k_t)) v_t; otherwise reads S_t (inclusive, Mamba).
    s0:     optional initial state f32[B, H, dk, dv]
    Returns (y f32[B, T, H, dv], final state f32[B, H, dk, dv]).

    Inputs are sliced per chunk from the [B, T, H, *] layout, so a
    broadcast (expanded) input is materialised one chunk at a time. Under
    a mesh it runs on each shard's own batch rows and heads."""
    heads, state = {0: 0, 2: 2}, {0: 0, 2: 1}
    return on_shards(
        lambda q_, k_, v_, w_, u_, s_: _chunked_linear_attention(
            q_, k_, v_, w_, u_, s_, chunk), q, (q, k, v, log_w, u, s0),
        (heads,) * 4 + (None if u is None else {2: 0},
                        None if s0 is None else state), (heads, state))


def _chunked_linear_attention(q, k, v, log_w, u, s0, chunk):
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    assert t % c == 0, (t, c)
    n = t // c
    dev = q.device

    strict = u is not None
    mask = torch.ones((c, c), dtype=torch.bool, device=dev).tril(
        -1 if strict else 0)
    s = (torch.zeros((b, h, dk, dv), device=dev) if s0 is None else s0)
    ys = []
    for j in range(n):
        def sl(a):
            return a[:, j * c:(j + 1) * c].float().transpose(1, 2)
        qi, ki, vi, wi = sl(q), sl(k), sl(v), sl(log_w)      # [B, H, c, *]
        logp = torch.cumsum(wi, dim=2)              # inclusive cumulative
        if LOGP_MAX is not None:
            LOGP_MAX.append(logp.detach().abs().amax())
        p_end = logp[:, :, -1:, :]                  # [B, H, 1, dk]
        # query-side decay: inclusive (mamba) or exclusive (rwkv strict)
        q_dec = logp - wi if strict else logp
        qt = qi * torch.exp(q_dec)
        kt = ki * torch.exp(-logp)
        a = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
        a = torch.where(mask, a, 0.0)
        y = torch.einsum("bhqk,bhkv->bhqv", a, vi)
        y = y + torch.einsum("bhqd,bhdv->bhqv", qt, s)
        if strict:
            diag = torch.einsum("bhtd,bhtd->bht", qi, ki * u[None, :, None, :])
            y = y + diag[..., None] * vi
        k_for_state = ki * torch.exp(p_end - logp)
        s = s * torch.exp(p_end).transpose(2, 3) + torch.einsum(
            "bhtd,bhtv->bhdv", k_for_state, vi)
        ys.append(y.transpose(1, 2))                # [B, c, H, dv]
    return torch.cat(ys, dim=1), s


def linear_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_w: torch.Tensor, s: torch.Tensor, *,
                          u: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) decode step. q/k/log_w: [B, H, dk]; v: [B, H, dv];
    s: [B, H, dk, dv]. Returns (y [B, H, dv], new state). Under a mesh it
    runs on each shard's own batch rows and heads."""
    heads = {0: 0, 1: 1}
    return on_shards(
        lambda q_, k_, v_, w_, s_, u_: _linear_attention_step(
            q_, k_, v_, w_, s_, u_), q, (q, k, v, log_w, s, u),
        (heads,) * 5 + (None if u is None else {1: 0},), (heads, heads))


def _linear_attention_step(q, k, v, log_w, s, u):
    kv = torch.einsum("bhd,bhv->bhdv", k, v)
    if u is not None:
        read = s + u[None, :, :, None] * kv
    else:
        read = s * torch.exp(log_w)[..., None] + kv
    y = torch.einsum("bhd,bhdv->bhv", q, read)
    s_new = s * torch.exp(log_w)[..., None] + kv
    return y, s_new


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mamba2Dims:
    d_model: int
    d_inner: int
    num_heads: int
    d_state: int
    conv_width: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.num_heads


def mamba2_params_shape(dims: Mamba2Dims):
    d, di, hs, dk = dims.d_model, dims.d_inner, dims.num_heads, dims.d_state
    return {
        "in_proj": (d, 2 * di + 2 * dk + hs),   # z, x, B, C, dt
        "conv_w": (dims.conv_width, di + 2 * dk),
        "dt_bias": (hs,),
        "a_log": (hs,),
        "d_skip": (hs,),
        "norm_scale": (di,),
        "out_proj": (di, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, T, C], w: [W, C]. The taps add in
    the reference's order (Python's ``sum`` from tap 0), each product and
    partial sum rounded to the inputs' dtype. Under a mesh it runs on
    each shard's own batch rows and channels (the whole sequence)."""
    rows = {0: 0, 2: 2}
    return on_shards(_causal_conv_local, x, (x, w), (rows, {2: 1}), rows)


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    width = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out


def _split(proj: torch.Tensor, dims: Mamba2Dims):
    """in_proj's output -> (z, x, B, C, dt) along the last axis."""
    di, dk = dims.d_inner, dims.d_state
    return torch.split(proj, [di, di, dk, dk, dims.num_heads], dim=-1)


def mamba2_block(params: Params, x: torch.Tensor, dims: Mamba2Dims, *,
                 chunk: int = 64) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. x: [B, T, d] -> [B, T, d]."""
    b, t, _ = x.shape
    di, hs, dk = dims.d_inner, dims.num_heads, dims.d_state
    hd = dims.head_dim
    z, xin, bmat, cmat, dt = _split(
        x @ constrain(params["in_proj"], None, None), dims)
    xbc = _causal_conv(torch.cat([xin, bmat, cmat], -1), params["conv_w"])
    xbc = layers.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [di, dk, dk], dim=-1)

    dt = softplus(dt.float() + params["dt_bias"].float())       # [B, T, H]
    log_w = -torch.exp(params["a_log"].float()) * dt            # [B, T, H]
    v = (xin.reshape(b, t, hs, hd).float() * dt[..., None]).to(x.dtype)
    q = cmat[:, :, None, :].expand(b, t, hs, dk)
    k = bmat[:, :, None, :].expand(b, t, hs, dk)
    lw = log_w[..., None].expand(b, t, hs, dk)

    y, _ = chunked_linear_attention(q, k, v, lw, chunk=chunk)
    y = y + params["d_skip"].float()[None, None, :, None] * \
        xin.reshape(b, t, hs, hd).float()
    y = layers.merge_heads(y)
    y = y * layers.silu(z.float())
    y = layers.rmsnorm(y, params["norm_scale"])
    return _f32mm(y, constrain(params["out_proj"], None, None)).to(x.dtype)


def mamba2_decode(params: Params, x: torch.Tensor,
                  state: Dict[str, torch.Tensor], dims: Mamba2Dims
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B, 1, d]; state: {"ssm": f32[B, H, dk, hd],
    "conv": f32[B, W-1, di+2dk]}. The f32 conv state promotes the new
    column, so the convolution and all after it, up to ``out_proj``, run
    in f32 (and ``v`` is not rounded to bf16), as in the reference.
    Returns (out [B, 1, d] in x's dtype, new state)."""
    b = x.shape[0]
    di, hs, dk = dims.d_inner, dims.num_heads, dims.d_state
    hd = dims.head_dim
    z, xin, bmat, cmat, dt = _split(x[:, 0] @ params["in_proj"], dims)
    xbc_in = torch.cat([xin, bmat, cmat], -1)                    # [B, C]
    conv_buf = torch.cat([state["conv"], xbc_in[:, None, :]], dim=1)
    w = params["conv_w"]
    xbc = conv_buf[:, 0, :] * w[0][None, :]
    for i in range(1, w.shape[0]):
        xbc = xbc + conv_buf[:, i, :] * w[i][None, :]
    xbc = layers.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [di, dk, dk], dim=-1)

    dt = softplus(dt.float() + params["dt_bias"].float())       # [B, H]
    log_w = -torch.exp(params["a_log"].float()) * dt
    v = xin.reshape(b, hs, hd).float() * dt[..., None]
    q = cmat[:, None, :].expand(b, hs, dk).float()
    k = bmat[:, None, :].expand(b, hs, dk).float()
    lw = log_w[..., None].expand(b, hs, dk)
    y, s_new = linear_attention_step(q, k, v, lw, state["ssm"])
    y = y + params["d_skip"].float()[None, :, None] * \
        xin.reshape(b, hs, hd).float()
    y = layers.merge_heads(y) * layers.silu(z.float())
    y = layers.rmsnorm(y, params["norm_scale"])
    out = _pinned(_f32mm(y, params["out_proj"]).to(x.dtype))[:, None, :]
    return out, {"ssm": s_new, "conv": conv_buf[:, 1:, :]}


# ---------------------------------------------------------------------------
# RWKV-6 block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RWKV6Dims:
    d_model: int
    num_heads: int
    d_ff: int
    decay_rank: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def rwkv6_params_shape(dims: RWKV6Dims):
    d, r = dims.d_model, dims.decay_rank
    return {
        # time-mix
        "mu_r": (d,), "mu_k": (d,), "mu_v": (d,), "mu_w": (d,), "mu_g": (d,),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
        "w0": (d,), "w_lora_a": (d, r), "w_lora_b": (r, d),
        "bonus_u": (dims.num_heads, dims.head_dim),
        "ln_x_scale": (d,),
        "wo": (d, d),
        # channel-mix
        "mu_ck": (d,), "mu_cr": (d,),
        "ck": (d, dims.d_ff), "cv": (dims.d_ff, d), "cr": (d, d),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x_{t-1} (zeros / supplied carry for t=0). x: [B, T, d]."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddecay(params: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel log decay (low-rank, <= 0), f32."""
    lora = _f32mm(torch.tanh(_f32mm(xw, params["w_lora_a"])),
                  params["w_lora_b"])
    return -torch.exp(params["w0"].float() + lora.float())


def _pinned(out: torch.Tensor) -> torch.Tensor:
    """A mixer's output pinned to [B@dp, ..] (the reference leaves it to
    GSPMD): its product with a split weight is a partial sum, which
    DTensor would otherwise reduce-scatter onto the sequence dim, where
    the next block's products would flatten two split dims into one, or
    leave partial where the residual add cannot take it."""
    return constrain(out, "dp", *(None,) * (out.ndim - 1))


def rwkv6_time_mix(params: Params, x: torch.Tensor, dims: RWKV6Dims, *,
                   chunk: int = 64) -> torch.Tensor:
    h, hd = dims.num_heads, dims.head_dim
    xs = _token_shift(x)

    def mix(mu):
        return x + (xs - x) * params[mu][None, None, :]

    r = layers.split_heads(mix("mu_r") @ constrain(params["wr"], None, "tp"),
                           h, hd)
    k = layers.split_heads(mix("mu_k") @ constrain(params["wk"], None, "tp"),
                           h, hd)
    v = layers.split_heads(mix("mu_v") @ constrain(params["wv"], None, "tp"),
                           h, hd)
    g = layers.silu(mix("mu_g") @ constrain(params["wg"], None, "tp"))
    log_w = layers.split_heads(_ddecay(params, mix("mu_w")), h, hd)

    y, _ = chunked_linear_attention(
        r, k, v, log_w, u=params["bonus_u"].float(), chunk=chunk)
    y = layers.merge_heads(y)
    y = layers.rmsnorm(y, params["ln_x_scale"])
    return _pinned(_f32mm(y * g, constrain(params["wo"], "tp", None)
                          ).to(x.dtype))


def rwkv6_channel_mix(params: Params, x: torch.Tensor) -> torch.Tensor:
    xs = _token_shift(x)
    xk = x + (xs - x) * params["mu_ck"][None, None, :]
    xr = x + (xs - x) * params["mu_cr"][None, None, :]
    kk = torch.relu(xk @ constrain(params["ck"], None, "tp")).square()
    return _pinned((layers.sigmoid(xr @ constrain(params["cr"], None, "tp"))
                    * (kk @ constrain(params["cv"], "tp", None))).to(x.dtype))


def rwkv6_time_mix_step(params: Params, x: torch.Tensor,
                        state: Dict[str, torch.Tensor], dims: RWKV6Dims
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step. x: [B, d]; state: {"shift": [B, d], "wkv": [B,H,hd,hd]}.
    The new shift is x itself, in x's dtype: after an f32 zero state the
    next step's mixes run in bf16, as in the reference."""
    h, hd = dims.num_heads, dims.head_dim
    xs = state["shift"]

    def mix(mu):       # f32 while the shift state is (the first step)
        return x + (xs - x) * params[mu][None, :]

    r = layers.split_heads(_f32mm(mix("mu_r"), params["wr"]), h, hd)
    k = layers.split_heads(_f32mm(mix("mu_k"), params["wk"]), h, hd)
    v = layers.split_heads(_f32mm(mix("mu_v"), params["wv"]), h, hd)
    g = layers.silu(_f32mm(mix("mu_g"), params["wg"]))
    log_w = layers.split_heads(_ddecay(params, mix("mu_w")), h, hd)
    y, s_new = linear_attention_step(
        r.float(), k.float(), v.float(), log_w, state["wkv"],
        u=params["bonus_u"].float())
    y = layers.rmsnorm(layers.merge_heads(y), params["ln_x_scale"])
    out = _pinned(_f32mm(y * g, params["wo"]).to(x.dtype))
    return out, {"shift": x, "wkv": s_new}


def rwkv6_channel_mix_step(params: Params, x: torch.Tensor,
                           state: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    xs = state["shift"]
    xk = x + (xs - x) * params["mu_ck"][None, :]
    xr = x + (xs - x) * params["mu_cr"][None, :]
    kk = torch.relu(_f32mm(xk, params["ck"])).square()
    out = _pinned((layers.sigmoid(_f32mm(xr, params["cr"]))
                   * _f32mm(kk, params["cv"])).to(x.dtype))
    return out, {"shift": x}
