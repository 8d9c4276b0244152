"""Transformer layers on PyTorch (a port of the reference's
``repro/models/layers.py``): norms, RoPE, GQA attention (chunked
flash-style prefill and training, with the reference's memory-lean
backward, and KV-cache decode), cross-attention, the SwiGLU / GELU MLP,
the embedding, the output projection and the cross-entropy.

Pure functions over parameter dicts. The reference computes attention
and the MLPs in plain ``jnp`` (no Pallas kernel), so the products here
are ``torch.matmul`` / ``torch.einsum``. The reference computes in bf16,
and this module follows its rounding step for step:

- an elementwise bf16 op goes as the reference's jaxpr goes (``silu`` is
  ``logistic`` then ``mul``, ``gelu`` the tanh form with bf16 constants),
  each step rounded to bf16, not through ``F.silu`` / ``F.gelu``;
- a product the reference asks for with ``preferred_element_type=f32``
  takes f32 copies of its bf16 operands (exact) and returns f32;
- the query is scaled in its own dtype before the product, and the
  probabilities are cast to the query's dtype before the PV product.

What is left between the two packages is the summation order of the
products (a bf16 ulp here and there), the last ulp of ``exp``, ``tanh``,
``rsqrt``, ``cos`` and ``sin``, and, against the reference's compiled
``lax.scan``, XLA keeping some bf16 sums in f32; the tests state the
tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import reduce
from repro_torch.utils.meshctx import (cached_constant, constrain,
                                       current_mesh, gather_seq, is_dtensor,
                                       on_shards, spec_of)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().sum(-1, keepdim=True) / x.shape[-1]
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    xf = x.float()
    n = x.shape[-1]
    mu = xf.sum(-1, keepdim=True) / n
    var = (xf - mu).square().sum(-1, keepdim=True) / n
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, params: Optional[Params]
               ) -> torch.Tensor:
    if kind == "nonparam_ln":
        return nonparam_layernorm(x)
    return rmsnorm(x, params["scale"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@cached_constant()
def _frequencies(head_dim: int, theta: float, device: torch.device
                 ) -> torch.Tensor:
    """rope_frequencies in f32 on ``device``, made once per (width, theta,
    device): a decode step would otherwise copy them to the card in
    every layer."""
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [B, S, H, Dh], positions: [B, S] or [S]. Rotates the two HALVES
    of each head (not interleaved pairs), in f32."""
    freqs = _frequencies(x.shape[-1], float(theta), x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs          # [B, S, Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    num_heads: int
    num_kv_heads: int
    head_dim: int


def attn_params_shape(d_model: int, dims: AttnDims):
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    return {
        "wq": (d_model, h * dh),
        "wk": (d_model, kv * dh),
        "wv": (d_model, kv * dh),
        "wo": (h * dh, d_model),
    }


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, Hkv, Dh] -> [B, S, Hkv*groups, Dh]: the ``groups`` copies of
    a KV head sit next to each other, so query head h reads KV head
    h // groups (on a mesh too, its kv heads split evenly or not at
    all)."""
    if groups == 1:
        return k
    heads = {0: 0, 2: 2}     # under a mesh: each shard repeats its own heads
    return on_shards(lambda t: t.repeat_interleave(groups, dim=2), k, (k,),
                     (heads,), heads)


def split_heads(y: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """[B, .., h * dh] -> [B, .., h, dh]. Under a mesh the feature dim is
    first pinned to what the heads allow, [B@dp, .., h*dh@tp] where tp
    divides h and [B@dp, ..] where it does not: a reshape cannot split a
    sharded dim unevenly (smollm's 15 heads over a model axis of 16)."""
    lead = tuple(y.shape[:-1])
    logical = ("dp",) + (None,) * (len(lead) - 1)
    mesh = current_mesh()
    if mesh is not None:
        heads = spec_of(mesh, lead + (h, dh), logical + ("tp", None))[-2]
        y = constrain(y, *logical, "tp" if heads is not None else None)
    return y.reshape(*lead, h, dh)


def merge_heads(y: torch.Tensor) -> torch.Tensor:
    """[B, .., h, dh] -> [B, .., h * dh], under a mesh pinned as
    ``split_heads`` pins its input, so that the gradient coming back (split
    over the feature dim by the next product) is regathered where the
    heads do not divide before the reshape's backward splits it."""
    lead, h, dh = tuple(y.shape[:-2]), y.shape[-2], y.shape[-1]
    out = y.reshape(*lead, h * dh)
    mesh = current_mesh()
    if mesh is None:
        return out
    logical = ("dp",) + (None,) * (len(lead) - 1)
    heads = spec_of(mesh, lead + (h, dh), logical + ("tp", None))[-2]
    return constrain(out, *logical, "tp" if heads is not None else None)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (a tensor op with
    it then rounds once, as the reference's product in that dtype)."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _flash_fwd_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int, chunk: int,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-style attention: a loop over KV chunks of ``chunk`` with a
    running (max, denominator, accumulator), so memory is O(Sq * chunk),
    not O(Sq * Skv). The last chunk is padded and masked. Fully masked
    rows give 0. Returns (out [B, Sq, H, Dh] in q's dtype, lse [B, H, Sq]
    f32).

    q: [B, Sq, H, Dh]; k/v: [B, Skv, H, Dh] (kv heads already repeated);
    q_offset: absolute position of q[0] (causal masking);
    kv_valid_len: optional [B] valid kv prefix length (cache decode)."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    dev = q.device
    scale = _in_dtype(float(np.float32(1.0 / np.sqrt(dh))), q.dtype)
    qf = (q * scale).float()
    ckv = min(chunk, skv)
    pad = (-skv) % ckv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nkv = (skv + pad) // ckv
    q_pos = q_offset + torch.arange(sq, device=dev)
    inf = float("inf")

    m = torch.full((b, h, sq), -inf, device=dev)
    l = torch.zeros((b, h, sq), device=dev)
    acc = torch.zeros((b, h, sq, dh), device=dev)
    for j in range(nkv):
        kc = k[:, j * ckv:(j + 1) * ckv].float()
        vc = v[:, j * ckv:(j + 1) * ckv]
        kv_pos = j * ckv + torch.arange(ckv, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc)
        mask = (kv_pos[None, :] > q_pos[:, None] if causal else
                torch.zeros((sq, ckv), dtype=torch.bool, device=dev))
        invalid = kv_pos >= skv
        if kv_valid_len is not None:
            invalid = invalid[None, :] | (kv_pos[None, :]
                                          >= kv_valid_len[:, None])
            mask = mask[None, None] | invalid[:, None, None, :]
        else:
            mask = (mask | invalid[None, :])[None, None]
        s = s.masked_fill(mask, -inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None]).masked_fill(mask, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vc.float())
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)
    lse = torch.where(torch.isfinite(m), m + torch.log(l_safe), -inf)
    return out, lse


def _flash_bwd_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                    causal: bool, q_offset: int, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``_flash_bwd``: per KV chunk, the probabilities are
    recomputed from the saved log-sum-exp, never stored. Unlike the
    forward, the scores are ``(q . k) * scale`` in f32 from the UNSCALED
    q (scale in f32); rows whose ``lse`` is -inf get p = 0. ``p`` is
    rounded to q's dtype for dv, ``ds = p (dp - rowsum(dout * out))
    scale`` for dq and dk; dq accumulates in f32 over the chunks, and the
    padded columns of dk / dv are cut. Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    dev = q.device
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    ckv = min(chunk, skv)
    pad = (-skv) % ckv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nkv = (skv + pad) // ckv
    q_pos = q_offset + torch.arange(sq, device=dev)
    qf, dof = q.float(), dout.float()
    d_row = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
    dq = torch.zeros((b, sq, h, dh), device=dev)
    dks, dvs = [], []
    for j in range(nkv):
        kc = k[:, j * ckv:(j + 1) * ckv].float()
        vc = v[:, j * ckv:(j + 1) * ckv].float()
        kv_pos = j * ckv + torch.arange(ckv, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        mask = (kv_pos[None, :] > q_pos[:, None] if causal else
                torch.zeros((sq, ckv), dtype=torch.bool, device=dev))
        mask = (mask | (kv_pos >= skv)[None, :])[None, None]
        p = torch.exp(s - lse_safe[..., None]).masked_fill(mask, 0.0)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(),
                                dof))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vc)
        ds = (p * (dp - d_row[..., None]) * scale).to(q.dtype).float()
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    dk = torch.cat(dks, dim=1)[:, :skv]
    dv = torch.cat(dvs, dim=1)[:, :skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: the forward is
    ``_flash_fwd_core`` (its value unchanged), saving q, k, v, the output
    and the log-sum-exp; the backward is ``_flash_bwd_core``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, chunk):
        out, lse = _flash_fwd_core(q, k, v, causal, q_offset, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return _flash_bwd_core(q, k, v, out, lse, dout, *ctx.args) + (
            None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    chunk: int = 512) -> torch.Tensor:
    """Flash-style attention with a memory-lean backward (train /
    prefill): q [B, Sq, H, Dh], k / v [B, Skv, H, Dh] (kv heads already
    repeated) -> [B, Sq, H, Dh] in q's dtype."""
    return _FlashAttention.apply(q, k, v, causal, q_offset, chunk)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      chunk: int = 512,
                      kv_valid_len: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The reference's ``chunked_attention``: with ``kv_valid_len`` its
    decode path (the forward core alone), without it ``flash_attention``
    (the same forward, and a backward). Under a mesh it runs on each
    shard's own batch rows and heads."""
    heads = {0: 0, 2: 2}
    if kv_valid_len is None:
        return on_shards(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, causal, q_offset,
                                               chunk),
            q, (q, k, v), (heads,) * 3, heads)
    return on_shards(
        lambda q_, k_, v_, n_: _flash_fwd_core(q_, k_, v_, causal, q_offset,
                                               chunk, n_)[0],
        q, (q, k, v, kv_valid_len), (heads,) * 3 + ({0: 0},), heads)


def gqa_attention(params: Params, x: torch.Tensor, dims: AttnDims, *,
                  positions: Optional[torch.Tensor] = None,
                  causal: bool = True, rope_theta: float = 1e4,
                  chunk: int = 512, use_rope: bool = True) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill)."""
    s = x.shape[1]
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    x = gather_seq(x)
    # ZeRO-3: storage is fsdp-sharded; the (small) weights are gathered for
    # compute so that activations keep their batch sharding.
    wq = constrain(params["wq"], None, "tp")
    wk = constrain(params["wk"], None, "tp")
    wv = constrain(params["wv"], None, "tp")
    q = constrain(split_heads(x @ wq, h, dh), "dp", None, "tp", None)
    k = constrain(split_heads(x @ wk, kv, dh), "dp", None, "tp", None)
    v = constrain(split_heads(x @ wv, kv, dh), "dp", None, "tp", None)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    out = chunked_attention(q, k, v, causal=causal, chunk=chunk)
    wo = constrain(params["wo"], "tp", None)
    return constrain(merge_heads(out) @ wo, "dp", "sp", None)


def gqa_decode(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int, dims: AttnDims, *,
               rope_theta: float = 1e4, chunk: int = 2048,
               use_rope: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with a KV cache.

    x: [B, 1, d]; cache_k/v: [B, S_max, Hkv, Dh]; pos: the current length,
    a Python int (the host owns it: a device scalar as an index would sync
    every token). Writes this token's K/V into the caches IN PLACE at
    ``pos`` and returns (out [B, 1, d], cache_k, cache_v). Attention runs
    over the whole S_max under a mask, as the reference's does, so a step
    costs O(S_max) whatever ``pos`` is."""
    b, s_max = x.shape[0], cache_k.shape[1]
    if not 0 <= pos < s_max:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{s_max} slots")
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    wq = constrain(params["wq"], None, "tp")
    wk = constrain(params["wk"], None, "tp")
    wv = constrain(params["wv"], None, "tp")
    q = split_heads(x @ wq, h, dh)
    k = split_heads(x @ wk, kv, dh)
    v = split_heads(x @ wv, kv, dh)
    if use_rope:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, rope_theta)
        k = apply_rope(k, posv, rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    kk = _repeat_kv(cache_k, h // kv)
    vv = _repeat_kv(cache_v, h // kv)
    valid = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    out = chunked_attention(q, kk, vv, causal=False, chunk=chunk,
                            kv_valid_len=valid)
    wo = constrain(params["wo"], "tp", None)
    return merge_heads(out) @ wo, cache_k, cache_v


def cross_attention(params: Params, x: torch.Tensor, enc: torch.Tensor,
                    dims: AttnDims, chunk: int = 512) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper). x: [B,S,d], enc: [B,T,d];
    non-causal over all T (the last KV chunk padded and masked)."""
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    x, enc = gather_seq(x), gather_seq(enc)
    q = split_heads(x @ constrain(params["wq"], None, "tp"), h, dh)
    k = split_heads(enc @ constrain(params["wk"], None, "tp"), kv, dh)
    v = split_heads(enc @ constrain(params["wv"], None, "tp"), kv, dh)
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    out = chunked_attention(q, k, v, causal=False, chunk=chunk)
    out = merge_heads(out) @ constrain(params["wo"], "tp", None)
    # Pinned like the self-attention's output (the reference leaves this
    # one to GSPMD): unpinned, its gradient arrives split over batch and
    # sequence, and the weight gradient's product would flatten the two.
    return constrain(out, "dp", "sp", None)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params_shape(d_model: int, d_ff: int, kind: str = "swiglu"):
    if kind == "gelu":
        return {"wi": (d_model, d_ff), "wo": (d_ff, d_model)}
    return {"wi": (d_model, d_ff), "wg": (d_model, d_ff),
            "wo": (d_ff, d_model)}


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``) as XLA expands it: neg, exp,
    add, divide, each step rounded to x's dtype."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as its jaxpr runs it: logistic, then a multiply,
    each step rounded to x's dtype."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) as its jaxpr runs it: the constants
    0.044715 and sqrt(2/pi) rounded to x's dtype (0.044677734375 and
    0.796875 in bf16), each step rounded to x's dtype. Not torch's default
    exact-erf GELU."""
    c1 = _in_dtype(0.044715, x.dtype)
    c2 = _in_dtype(float(np.sqrt(2 / np.pi)), x.dtype)
    return x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def swiglu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = gather_seq(x)
    if "wg" not in params:  # 2-matrix GELU MLP (starcoder2, whisper)
        wi = constrain(params["wi"], None, "tp")
        wo = constrain(params["wo"], "tp", None)
        hidden = gelu(constrain(x @ wi, "dp", None, "tp"))
        return constrain(hidden @ wo, "dp", None, None)
    wi = constrain(params["wi"], None, "tp")
    wg = constrain(params["wg"], None, "tp")
    wo = constrain(params["wo"], "tp", None)
    gate = silu(constrain(x @ wg, "dp", None, "tp"))
    hidden = constrain(x @ wi, "dp", None, "tp") * gate
    return constrain(hidden @ wo, "dp", "sp", None)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table``'s rows by ``tokens``; the table's gradient sums repeated
    tokens in a fixed order (``reduce.gather_rows``). A DTensor table is
    gathered over its vocab dim first (as every weight is before use)
    and each shard looks up its own tokens; its gradient is then a sum
    over the shards that split the tokens."""
    if not is_dtensor(table):
        return reduce.gather_rows(table, tokens)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    table = table.redistribute(mesh, [
        p if p.is_shard() and p.dim == 1 else Replicate()
        for p in table.placements])
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    tok_pl = [p if p.is_shard() and p.dim == 0 else Replicate()
              for p in tokens.placements]
    out_pl, grad_pl = [], []
    for kp, tp in zip(tok_pl, table.placements):
        if kp.is_shard() and tp.is_shard():
            raise ValueError("one mesh axis splits both the tokens and the "
                             "embedding width")
        out_pl.append(kp if kp.is_shard() else
                      Shard(tokens.ndim) if tp.is_shard() else Replicate())
        grad_pl.append(Partial() if kp.is_shard() else tp)
    return local_map(lambda tok, tab: reduce.gather_rows(tab, tok),
                     out_placements=out_pl,
                     in_placements=(tok_pl, table.placements),
                     in_grad_placements=(tok_pl, grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, table)


def logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied/untied output projection. x: [B,S,d], table: [V,d] -> [B,S,V]
    in the promoted dtype of the two, as ``jnp.einsum`` promotes."""
    dt = torch.promote_types(x.dtype, table.dtype)
    return torch.einsum("bsd,vd->bsv", x.to(dt), table.to(dt))


def cross_entropy(logits_: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross-entropy. logits: [B, S, V] (taken in f32), labels:
    int [B, S]."""
    lz = torch.log_softmax(logits_.float(), dim=-1)
    return -lz.gather(-1, labels[..., None].long())[..., 0].mean()
