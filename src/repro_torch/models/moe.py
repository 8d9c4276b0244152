"""Mixture-of-Experts FFN with sort-based token dispatch (a port of the
reference's ``repro/models/moe.py`` on one device).

top-k routing -> stable sort by expert -> capacity rank within expert ->
gather to [G, E, C, D] -> batched expert GEMM -> gather back and a
weighted sum. All shapes are static; pairs past an expert's capacity are
dropped, and the drop fraction is returned. The reference dispatches in
one group per data-parallel shard of its mesh; the port has no LM mesh
yet, so G = 1 (the reference's ``_dp_groups`` without a mesh).

Ties break as the reference's: ``lax.top_k`` over the gates takes the
lower expert first (a stable descending sort here; ``torch.topk`` makes
no such promise), the dispatch sort is stable and ``searchsorted`` takes
its left side.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import reduce
from repro_torch.models.layers import silu

Params = Dict[str, torch.Tensor]


def moe_params_shape(d_model: int, d_ff: int, num_experts: int):
    return {
        "router": (d_model, num_experts),
        "wi": (num_experts, d_model, d_ff),
        "wg": (num_experts, d_model, d_ff),
        "wo": (num_experts, d_ff, d_model),
    }


def capacity(tokens_per_group: int, num_experts: int, experts_per_token: int,
             capacity_factor: float) -> int:
    c = int(np.ceil(tokens_per_group * experts_per_token * capacity_factor
                    / num_experts))
    return max(8, -(-c // 8) * 8)


def _expert_product(x: torch.Tensor, w: torch.Tensor, eq: str
                    ) -> torch.Tensor:
    """``jnp.einsum`` of two operands in their promoted dtype: bf16 with
    bf16 stays bf16 (the forward casts the experts to bf16), bf16 with f32
    runs in f32 (decode keeps them as stored)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(dt), w.to(dt))


def moe_ffn(params: Params, x: torch.Tensor, *, experts_per_token: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (out [B, S, D] in x's dtype, {"moe_drop_frac",
    "moe_aux_loss"} as f32 scalars). The capacity follows the tokens in
    the call, so a prefill and a decode of the same tokens can drop
    differently."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    k = experts_per_token
    g, tg = 1, t
    cap = capacity(tg, e, k, capacity_factor)
    dev = x.device

    xg = x.reshape(g, tg, d)
    logits = xg.float() @ params["router"].float()           # [G, Tg, E]
    z = torch.exp(logits - logits.amax(-1, keepdim=True))
    gates = z / z.sum(-1, keepdim=True)      # jax.nn.softmax's divide
    topw, tope = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, tope = topw[..., :k], tope[..., :k]                # [G, Tg, K]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    # Flatten (token, choice) pairs per group; rank within expert.
    flat_e = tope.reshape(g, tg * k)
    flat_t = torch.arange(tg, device=dev).repeat_interleave(k)[None].expand(
        g, tg * k)
    se, order = torch.sort(flat_e, dim=1, stable=True)
    st_ = torch.gather(flat_t, 1, order)
    pos = torch.arange(tg * k, device=dev)[None].expand(g, tg * k)
    expert_start = torch.searchsorted(
        se, torch.arange(e, device=dev)[None].expand(g, e).contiguous())
    rank = pos - torch.gather(expert_start, 1, se)
    keep = rank < cap
    drop_frac = 1.0 - keep.float().mean()

    # Dispatch: slot (expert, rank) <- token index + 1 (0 = empty). A
    # dropped pair goes to the extra slot e * cap, which is then cut off
    # (the reference's out-of-bounds write with mode="drop").
    slot_idx = torch.where(keep, se * cap + rank.clamp(0, cap - 1), e * cap)
    slot_tok = torch.zeros((g, e * cap + 1), dtype=torch.long, device=dev)
    slot_tok.scatter_(1, slot_idx, st_ + 1)
    slot_tok = slot_tok[:, :e * cap]

    # The token rows by slot (row 0 of each group is zeros). A token sits
    # in up to k slots, so the gradient of its row is a sum: gather_rows
    # adds it in a fixed order (no float atomics on the card).
    xg_pad = torch.cat([torch.zeros_like(xg[:, :1]), xg], dim=1)
    rows = slot_tok + (tg + 1) * torch.arange(g, device=dev)[:, None]
    gathered = reduce.gather_rows(xg_pad.reshape(g * (tg + 1), d), rows
                                  ).reshape(g, e, cap, d)

    gate = silu(_expert_product(gathered, params["wg"], "gecd,edf->gecf"))
    hidden = _expert_product(gathered, params["wi"], "gecd,edf->gecf") * gate
    expert_out = _expert_product(hidden, params["wo"], "gecf,efd->gecd"
                                 ).to(x.dtype)

    # Combine by gather: each (token, choice) pair reads its slot (the
    # extra zero row for a dropped pair) and the weighted sum is f32.
    inv_order = torch.argsort(order, dim=1)
    slot_pair = torch.gather(slot_idx, 1, inv_order)
    eo_flat = torch.cat([expert_out.reshape(g, e * cap, d),
                         torch.zeros_like(expert_out[:, 0, :1])], dim=1)
    picked = torch.gather(eo_flat, 1, slot_pair[..., None].expand(
        g, tg * k, d)).reshape(g, tg, k, d).float()
    out = (picked * topw[..., None]).sum(dim=2).reshape(b, s, d)

    me = gates.sum(dim=(0, 1)) / t
    ce_ = torch.bincount(flat_e.reshape(-1), minlength=e).float() / (t * k)
    aux_loss = e * torch.sum(me * ce_)
    return out.to(x.dtype), {"moe_drop_frac": drop_frac,
                             "moe_aux_loss": aux_loss}
