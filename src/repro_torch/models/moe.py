"""Mixture-of-Experts FFN with sort-based token dispatch (a port of the
reference's ``repro/models/moe.py`` on one device).

top-k routing -> stable sort by expert -> capacity rank within expert ->
gather to [G, E, C, D] -> batched expert GEMM -> gather back and a
weighted sum. All shapes are static; pairs past an expert's capacity are
dropped, and the drop fraction is returned. Without a mesh the tokens
form one group (G = 1); under one, one group per data-parallel shard
(the reference's ``_dp_groups``), each routed on its own shard.

Ties break as the reference's: ``lax.top_k`` over the gates takes the
lower expert first (a stable descending sort here; ``torch.topk`` makes
no such promise), the dispatch sort is stable and ``searchsorted`` takes
its left side.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import reduce
from repro_torch.models.layers import silu
from repro_torch.utils import meshctx
from repro_torch.utils.meshctx import constrain

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


def _dp_size() -> int:
    """The data-parallel size of the active mesh (pod x data), 1 without
    one."""
    mesh = meshctx.current_mesh()
    if mesh is None:
        return 1
    names = meshctx.axis_names(mesh)
    dp = 1
    for ax in ("pod", "data"):
        if ax in names:
            dp *= meshctx.axis_size(mesh, ax)
    return dp


def _dp_groups(total_tokens: int) -> int:
    """Dispatch group count: one group per data-parallel shard when the
    tokens split into groups of at least 8, else 1 (and 1 without a
    mesh). The reference's grouping over dp x tp made its combine
    replicate under GSPMD; it dispatches over dp only, and so does this."""
    dp = _dp_size()
    if dp > 1 and total_tokens % dp == 0 and total_tokens // dp >= 8:
        return dp
    return 1


def _route(xg: torch.Tensor, router: torch.Tensor, k: int, cap: int):
    """Routing and dispatch of each group on its own: top-k gates, the
    stable sort by expert, capacity ranks, the dispatch gather. xg [G,
    Tg, D], router [D, E] -> (gathered [G, E, C, D], slot_pair [G, Tg*K]
    (each pair's slot; E*C for a dropped one), topw [G, Tg, K], gates [G,
    Tg, E], keep bool [G, Tg*K], counts int [G, E] (pairs per expert)).
    Every output is per group, so under a mesh it runs on each shard's
    own groups."""
    g, tg, d = xg.shape
    e = router.shape[1]
    dev = xg.device
    logits = xg.float() @ router.float()                     # [G, Tg, E]
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
    slot_pair = torch.gather(slot_idx, 1, torch.argsort(order, dim=1))
    counts = torch.zeros((g, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    return gathered, slot_pair, topw, gates, keep, counts


def _combine(expert_out: torch.Tensor, slot_pair: torch.Tensor,
             topw: torch.Tensor) -> torch.Tensor:
    """Combine by gather: each (token, choice) pair reads its slot (the
    extra zero row for a dropped pair); the weighted sum is f32. ->
    [G, Tg, D]."""
    g, e, cap, d = expert_out.shape
    tg, k = topw.shape[1], topw.shape[2]
    eo_flat = torch.cat([expert_out.reshape(g, e * cap, d),
                         torch.zeros_like(expert_out[:, 0, :1])], dim=1)
    picked = torch.gather(eo_flat, 1, slot_pair[..., None].expand(
        g, tg * k, d)).reshape(g, tg, k, d).float()
    return (picked * topw[..., None]).sum(dim=2)


def moe_ffn(params: Params, x: torch.Tensor, *, experts_per_token: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (out [B, S, D] in x's dtype, {"moe_drop_frac",
    "moe_aux_loss"} as f32 scalars). The capacity follows the tokens in
    the call, so a prefill and a decode of the same tokens can drop
    differently. Under a mesh the tokens dispatch in one group per
    data-parallel shard (``_dp_groups``), routed on each shard's own
    groups; the experts' dim is split over tp between the reference's
    two all-to-all boundaries."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    k = experts_per_token
    g = _dp_groups(t)
    tg = t // g
    cap = capacity(tg, e, k, capacity_factor)

    tok_axis = "dp"
    xg = constrain(meshctx.gather_seq(x).reshape(g, tg, d),
                   tok_axis, None, None)
    # routing and combine run on each shard's own groups; the router and
    # the group dim's split are all they read
    groups = {0: 0}
    gathered, slot_pair, topw, gates, keep, counts = meshctx.on_shards(
        functools.partial(_route, k=k, cap=cap), xg, (xg, params["router"]),
        (groups, {}), (groups,) * 6)
    drop_frac = 1.0 - keep.float().mean()

    # [G@tok, E, C, D] -> [G@dp, E@tp, C, D]: the EP all-to-all boundary.
    gathered = constrain(gathered, "dp", "tp", None, None)
    wg_ = constrain(params["wg"], "tp", None, None)
    wi_ = constrain(params["wi"], "tp", None, None)
    wo_ = constrain(params["wo"], "tp", None, None)
    gate = silu(_expert_product(gathered, wg_, "gecd,edf->gecf"))
    hidden = _expert_product(gathered, wi_, "gecd,edf->gecf") * gate
    # Combine boundary: back to token-major sharding, in x's dtype.
    expert_out = constrain(
        _expert_product(hidden, wo_, "gecf,efd->gecd").to(x.dtype),
        tok_axis, None, None, None)
    out = meshctx.on_shards(_combine, expert_out,
                            (expert_out, slot_pair, topw), (groups,) * 3,
                            groups)
    out = constrain(out, tok_axis, None, None).reshape(b, s, d)
    # Pinned like the MLP's output (the reference leaves this to GSPMD), so
    # that the residual stream's gradient, split over sequence under sp,
    # is gathered before the reshape's backward flattens it.
    out = constrain(out, "dp", "sp", None)

    me = gates.sum(dim=(0, 1)) / t
    ce_ = counts.sum(0).float() / (t * k)
    aux_loss = e * torch.sum(me * ce_)
    return out.to(x.dtype), {"moe_drop_frac": drop_frac,
                             "moe_aux_loss": aux_loss}
