"""The attention-family block and its stack (a port of the reference's
``repro/models/transformer.py`` for the dense, VLM-backbone and MoE
families): pre-norm GQA attention, then a SwiGLU / GELU MLP or the MoE
FFN.

Block parameters keep the reference's stacked leading layer axis, so
block ``l`` is ``layer(blocks, l)``; the stack is a Python loop over that
axis (serving needs no scan and no rematerialisation).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, moe as moe_lib

Params = Dict[str, Any]


def attn_dims(cfg: ArchConfig) -> layers.AttnDims:
    return layers.AttnDims(num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads,
                           head_dim=cfg.resolved_head_dim)


def _norm(cfg: ArchConfig, p: Optional[Params], x: torch.Tensor
          ) -> torch.Tensor:
    return layers.apply_norm(cfg.norm, x, p)


def _cast(p: Params, dtype: torch.dtype) -> Params:
    """Block parameters in the compute dtype (stored f32, or bf16 for
    kimi)."""
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in p.items()}


def layer(blocks: Params, l: int) -> Params:
    """Block ``l``'s parameters: a view of each stacked leaf at ``l``."""
    return {k: layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in blocks.items()}


def attn_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None, causal: bool = True,
               chunk: int = 512
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block over a full sequence. Every parameter, the MoE's
    included, is cast to x's dtype first."""
    p = _cast(p, x.dtype)
    use_rope = cfg.rope_theta > 0
    h = x + layers.gqa_attention(
        p["attn"], _norm(cfg, p.get("attn_norm"), x), attn_dims(cfg),
        positions=positions, causal=causal, rope_theta=cfg.rope_theta or 1e4,
        chunk=chunk, use_rope=use_rope)
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
                      cache: Dict[str, torch.Tensor], pos: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block for one token, its K/V written into ``cache`` in place at
    ``pos``. Every parameter but the MoE's is cast to x's dtype (as the
    reference's decode does), so the experts' products run in f32."""
    p = dict(p, **_cast({k: v for k, v in p.items() if k != "moe"}, x.dtype))
    use_rope = cfg.rope_theta > 0
    a, ck, cv = layers.gqa_decode(
        p["attn"], _norm(cfg, p.get("attn_norm"), x), cache["k"], cache["v"],
        pos, attn_dims(cfg), rope_theta=cfg.rope_theta or 1e4,
        use_rope=use_rope)
    h = x + a
    new_cache = dict(cache, k=ck, v=cv)
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
                causal: bool = True, chunk: int = 512
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention-family stack (dense/moe/vlm) over the stacked ``blocks``
    (``cfg.num_layers`` of them). Metrics (the MoE's drop fraction and aux
    loss) are averaged over the layers."""
    per_layer = []
    for l in range(cfg.num_layers):
        x, m = attn_block(cfg, layer(blocks, l), x, causal=causal,
                          chunk=chunk)
        per_layer.append(m)
    metrics = {k: torch.stack([m[k] for m in per_layer]).sum()
               / len(per_layer) for k in per_layer[0]}
    return x, metrics
