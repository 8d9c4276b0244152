"""Model blocks and their stacks (a port of the reference's
``repro/models/transformer.py``): the attention-family block (pre-norm
GQA attention, whisper's cross-attention, then a SwiGLU / GELU MLP or the
MoE FFN), the RWKV-6 block (time-mix, channel-mix) and the Mamba2 block,
each for a full sequence and for one decode token; the dense, RWKV and
zamba (Mamba2 groups around one shared attention block) stacks.

Block parameters keep the reference's stacked leading layer axis, so
block ``l`` is ``layer(blocks, l)``; a stack is a Python loop over that
axis. With ``remat`` a stack recomputes each body in the backward pass
instead of keeping its activations (``torch.utils.checkpoint``, at the
reference's ``jax.checkpoint`` boundaries: a layer; a zamba group).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, linear_attn, moe as moe_lib
from repro_torch.utils import meshctx
from repro_torch.utils.meshctx import constrain

Params = Dict[str, Any]


def attn_dims(cfg: ArchConfig) -> layers.AttnDims:
    return layers.AttnDims(num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads,
                           head_dim=cfg.resolved_head_dim)


def mamba_dims(cfg: ArchConfig) -> linear_attn.Mamba2Dims:
    return linear_attn.Mamba2Dims(
        d_model=cfg.d_model, d_inner=2 * cfg.d_model,
        num_heads=(2 * cfg.d_model) // 64, d_state=cfg.ssm_state)


def rwkv_dims(cfg: ArchConfig) -> linear_attn.RWKV6Dims:
    return linear_attn.RWKV6Dims(d_model=cfg.d_model,
                                 num_heads=cfg.num_heads, d_ff=cfg.d_ff)


def _norm(cfg: ArchConfig, p: Optional[Params], x: torch.Tensor
          ) -> torch.Tensor:
    return layers.apply_norm(cfg.norm, x, p)


def _cast(p: Params, dtype: torch.dtype) -> Params:
    """Block parameters in the compute dtype (stored f32, or bf16 for
    kimi), every leaf: the RWKV and Mamba2 decay, bonus and norm leaves
    too, which the blocks read back in f32 from their bf16 values."""
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in p.items()}


def layer(blocks: Params, l: int) -> Params:
    """Block ``l``'s parameters: a view of each stacked leaf at ``l``."""
    return {k: layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in blocks.items()}


def remat_call(fn: Callable, remat: bool, *args):
    """``fn(*args)``; with ``remat`` under ``checkpoint(use_reentrant=
    False)``, so the backward pass recomputes ``fn``'s activations. The
    recompute runs with ``linear_attn.LOGP_MAX`` off (the hook records a
    chunk once, in the real forward) and under the mesh context of the
    forward (the backward may run on the autograd engine's own thread,
    which does not see this thread's ``meshctx``)."""
    if not remat:
        return fn(*args)
    calls = []
    mesh_state = meshctx.current_state()

    def body(*a):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a)
        hook, linear_attn.LOGP_MAX = linear_attn.LOGP_MAX, None
        try:
            with meshctx.use_mesh(*mesh_state):
                return fn(*a)
        finally:
            linear_attn.LOGP_MAX = hook

    return checkpoint(body, *args, use_reentrant=False)


def attn_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None,
               enc: Optional[torch.Tensor] = None, causal: bool = True,
               chunk: int = 512
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block over a full sequence; with ``enc`` [B, T, d] (whisper's
    decoder) a cross-attention over it follows the self-attention. Every
    parameter, the MoE's included, is cast to x's dtype first."""
    p = _cast(p, x.dtype)
    use_rope = cfg.rope_theta > 0
    h = x + layers.gqa_attention(
        p["attn"], _norm(cfg, p.get("attn_norm"), x), attn_dims(cfg),
        positions=positions, causal=causal, rope_theta=cfg.rope_theta or 1e4,
        chunk=chunk, use_rope=use_rope)
    if enc is not None:
        h = h + layers.cross_attention(
            p["cross"], _norm(cfg, p.get("cross_norm"), h), enc,
            attn_dims(cfg), chunk=chunk)
    metrics: Dict[str, torch.Tensor] = {}
    hn = _norm(cfg, p.get("mlp_norm"), h)
    if cfg.num_experts:
        out, metrics = moe_lib.moe_ffn(
            p["moe"], hn, experts_per_token=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor)
        h = h + out
    else:
        h = h + layers.swiglu_mlp(p["mlp"], hn)
    return h, metrics


def attn_block_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], pos: int, *,
                      enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block for one token, its K/V written into ``cache`` in place at
    ``pos``; with ``enc_kv`` (the encoder's K and V, [B, T, Hkv, Dh]
    each: whisper's cross cache) a cross-attention over them follows.
    Every parameter but the MoE's is cast to x's dtype (as the
    reference's decode does), so the experts' products run in f32."""
    p = dict(p, **_cast({k: v for k, v in p.items() if k != "moe"}, x.dtype))
    use_rope = cfg.rope_theta > 0
    a, ck, cv = layers.gqa_decode(
        p["attn"], _norm(cfg, p.get("attn_norm"), x), cache["k"], cache["v"],
        pos, attn_dims(cfg), rope_theta=cfg.rope_theta or 1e4,
        use_rope=use_rope)
    h = x + a
    new_cache = dict(cache, k=ck, v=cv)
    if enc_kv is not None:
        dims = attn_dims(cfg)
        q = layers.split_heads(_norm(cfg, p.get("cross_norm"), h)
                               @ p["cross"]["wq"], dims.num_heads,
                               dims.head_dim)
        groups = dims.num_heads // dims.num_kv_heads
        kk = layers._repeat_kv(enc_kv[0], groups)
        vv = layers._repeat_kv(enc_kv[1], groups)
        o = layers.chunked_attention(q, kk, vv, causal=False)
        h = h + layers.merge_heads(o) \
            @ p["cross"]["wo"]
    hn = _norm(cfg, p.get("mlp_norm"), h)
    if cfg.num_experts:
        out, _ = moe_lib.moe_ffn(p["moe"], hn,
                                 experts_per_token=cfg.experts_per_token,
                                 capacity_factor=cfg.capacity_factor)
        h = h + out
    else:
        h = h + layers.swiglu_mlp(p["mlp"], hn)
    return h, new_cache


def dense_stack(cfg: ArchConfig, blocks: Params, x: torch.Tensor, *,
                causal: bool = True, remat: bool = False, chunk: int = 512
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention-family stack (dense/moe/vlm) over the stacked ``blocks``
    (``cfg.num_layers`` of them). Metrics (the MoE's drop fraction and aux
    loss) are averaged over the layers."""
    def body(p, h):
        h, m = attn_block(cfg, p, h, causal=causal, chunk=chunk)
        return constrain(h, "dp", "sp", None), m

    per_layer = []
    for l in range(cfg.num_layers):
        x, m = remat_call(body, remat, layer(blocks, l), x)
        per_layer.append(m)
    metrics = {k: torch.stack([m[k] for m in per_layer]).sum()
               / len(per_layer) for k in per_layer[0]}
    return x, metrics


# ---------------------------------------------------------------------------
# RWKV6 block
# ---------------------------------------------------------------------------

def rwkv_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               chunk: int = 64) -> torch.Tensor:
    p = _cast(p, x.dtype)
    dims = rwkv_dims(cfg)
    h = x + linear_attn.rwkv6_time_mix(
        p["time_mix"], _norm(cfg, p.get("attn_norm"), x), dims, chunk=chunk)
    h = h + linear_attn.rwkv6_channel_mix(
        p["channel_mix"], _norm(cfg, p.get("mlp_norm"), h))
    return h


def rwkv_block_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through one RWKV block. cache: {"att_shift", "ffn_shift":
    [B, d], "wkv": f32[B, H, hd, hd]}; returns (h, the new state), whose
    shifts are the normed inputs in x's dtype."""
    p = _cast(p, x.dtype)
    dims = rwkv_dims(cfg)
    xn = _norm(cfg, p.get("attn_norm"), x)[:, 0]
    a, tm_state = linear_attn.rwkv6_time_mix_step(
        p["time_mix"], xn, {"shift": cache["att_shift"],
                            "wkv": cache["wkv"]}, dims)
    h = x + a[:, None, :]
    hn = _norm(cfg, p.get("mlp_norm"), h)[:, 0]
    c, cm_state = linear_attn.rwkv6_channel_mix_step(
        p["channel_mix"], hn, {"shift": cache["ffn_shift"]})
    h = h + c[:, None, :]
    return h, {"att_shift": tm_state["shift"], "wkv": tm_state["wkv"],
               "ffn_shift": cm_state["shift"]}


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# ---------------------------------------------------------------------------

def mamba_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                chunk: int = 64) -> torch.Tensor:
    p = _cast(p, x.dtype)
    return x + linear_attn.mamba2_block(
        p["mamba"], _norm(cfg, p.get("attn_norm"), x), mamba_dims(cfg),
        chunk=chunk)


def mamba_block_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                       cache: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = _cast(p, x.dtype)
    out, st = linear_attn.mamba2_decode(
        p["mamba"], _norm(cfg, p.get("attn_norm"), x), cache, mamba_dims(cfg))
    return x + out, st


def rwkv_stack(cfg: ArchConfig, blocks: Params, x: torch.Tensor, *,
               remat: bool = False, chunk: int = 64) -> torch.Tensor:
    def body(p, h):
        return constrain(rwkv_block(cfg, p, h, chunk=chunk), "dp", None, None)

    for l in range(cfg.num_layers):
        x = remat_call(body, remat, layer(blocks, l), x)
    return x


def zamba_stack(cfg: ArchConfig, params: Params, x: torch.Tensor, *,
                remat: bool = False, chunk: int = 64,
                attn_chunk: int = 512) -> torch.Tensor:
    """Mamba2 backbone with one SHARED attention block every attn_every
    layers. Layout: groups of (attn_every Mamba blocks, then the shared
    attention block), params["groups"] stacked [G, g, ...]; then a tail
    of the leftover Mamba blocks, params["tail"] (absent when g divides
    the depth). With ``remat`` each group (its Mamba blocks and the
    shared block) and each tail block is one recomputed body."""
    g = cfg.attn_every

    def group_body(group, shared, h):
        for l in range(g):
            h = constrain(mamba_block(cfg, layer(group, l), h, chunk=chunk),
                          "dp", None, None)
        h = attn_block(cfg, shared, h, causal=True, chunk=attn_chunk)[0]
        return constrain(h, "dp", None, None)

    def tail_body(p, h):
        return constrain(mamba_block(cfg, p, h, chunk=chunk),
                         "dp", None, None)

    for gi in range(cfg.num_layers // g):
        x = remat_call(group_body, remat, layer(params["groups"], gi),
                       params["shared_attn"], x)
    tail = params.get("tail")
    if tail:
        for l in range(cfg.num_layers % g):
            x = remat_call(tail_body, remat, layer(tail, l), x)
    return x
