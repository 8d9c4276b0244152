"""Model zoo: ArchConfig -> parameter trees, init, and the serving entry
points (forward, prefill, the KV cache and one decode step), a port of
the reference's ``repro/models/model_zoo.py`` for the attention families
(dense, VLM backbone, MoE).

Parameters are nested dicts of tensors with the reference's names and
its stacked leading layer axis, so the reference's tree carries across
leaf for leaf (``repro_torch.convert.lm_params``). Storage is f32, bf16
for kimi; the blocks compute in bf16, the logits in f32.

Not ported here: the ``ssm`` (rwkv6), ``hybrid`` (zamba2) and ``audio``
(whisper) families, which raise NotImplementedError (ROADMAP Queue 1
item 4.2), and training (``loss_fn``, ``chunked_ce_loss``; item 4.3).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, moe as moe_lib, transformer

Params = Dict[str, Any]
PORTED_FAMILIES = ("dense", "moe", "vlm")
COMPUTE = torch.bfloat16


def _ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"PyTorch yet (ROADMAP Queue 1 item 4.2)")


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def _norm_shape(cfg: ArchConfig):
    return None if cfg.norm == "nonparam_ln" else {"scale": (cfg.d_model,)}


def _attn_block_shapes(cfg: ArchConfig):
    d = cfg.d_model
    s: Dict[str, Any] = {}
    if _norm_shape(cfg):
        s["attn_norm"] = _norm_shape(cfg)
        s["mlp_norm"] = _norm_shape(cfg)
    s["attn"] = layers.attn_params_shape(d, transformer.attn_dims(cfg))
    if cfg.num_experts:
        s["moe"] = moe_lib.moe_params_shape(d, cfg.moe_d_ff or cfg.d_ff,
                                            cfg.num_experts)
    else:
        s["mlp"] = layers.mlp_params_shape(d, cfg.d_ff, cfg.mlp)
    return s


def _stack(shapes, n: int):
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Nested dict of shape tuples for the full model."""
    _ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict[str, Any] = {"embed": (v, d)}
    if not cfg.tie_embeddings:
        tree["out_head"] = (v, d)
    if _norm_shape(cfg):
        tree["final_norm"] = _norm_shape(cfg)
    tree["blocks"] = _stack(_attn_block_shapes(cfg), cfg.num_layers)
    if cfg.family == "vlm":
        tree["connector"] = (cfg.frontend_dim, d)
    return tree


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.name.startswith("kimi") else torch.float32


def leaves(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict in sorted key order, the order
    in which the reference flattens its trees."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


# Constant-initialised leaves by name (the reference's _SPECIAL_INIT);
# ``mu_*`` leaves are 0.5; every other leaf is normal * init_scale.
_SPECIAL_INIT = {"a_log": 0.0, "dt_bias": -2.0, "d_skip": 1.0, "w0": 0.0,
                 "bonus_u": 0.5, "scale": 1.0, "ln_x_scale": 1.0,
                 "norm_scale": 1.0}


def init_params(cfg: ArchConfig, seed: int = 0, init_scale: float = 0.02,
                device="cuda") -> Params:
    """Random parameters on ``device``, drawn leaf by leaf (in the
    reference's flatten order) from one ``torch.Generator`` seeded with
    ``seed``. The reference draws through ``jax.random.fold_in``, which
    the port cannot reproduce: the values differ, their law and the
    constant leaves do not. Carry the reference's own tree across with
    ``convert.lm_params`` to compare the two."""
    dt = param_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Params = {}
    for path, shape in leaves(param_shapes(cfg)):
        name = path[-1]
        if name in _SPECIAL_INIT:
            arr = torch.full(shape, _SPECIAL_INIT[name], device=device)
        elif name.startswith("mu_"):
            arr = torch.full(shape, 0.5, device=device)
        else:
            arr = torch.randn(shape, generator=gen, device=device
                              ).mul_(init_scale)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = arr.to(dt)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _out_table(cfg: ArchConfig, params: Params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["out_head"]


def _embed_inputs(cfg: ArchConfig, params: Params,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x [B, S, d] bf16, loss weights or None). The VLM's patches go
    through the connector and take the sequence's first P positions
    (weight 0); the text's last P tokens drop off."""
    x = layers.embed(batch["tokens"], params["embed"]).to(COMPUTE)
    weights = None
    if cfg.family == "vlm":
        patches = batch["patches"].to(COMPUTE)                # [B, P, Dv]
        proj = patches @ params["connector"].to(COMPUTE)
        p = proj.shape[1]
        x = torch.cat([proj, x[:, : x.shape[1] - p]], dim=1)
        weights = torch.cat(
            [torch.zeros((x.shape[0], p), device=x.device),
             torch.ones((x.shape[0], x.shape[1] - p), device=x.device)],
            dim=1)
    return x, weights


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, chunk: int = 512
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                       Dict[str, torch.Tensor]]:
    """Full causal forward -> (hidden [B, S, d] bf16, loss weights,
    metrics). ``batch`` holds "tokens" [B, S] (and "patches" [B, P, Dv]
    for a VLM) on the parameters' device."""
    _ported(cfg)
    x, weights = _embed_inputs(cfg, params, batch)
    x, metrics = transformer.dense_stack(cfg, params["blocks"], x,
                                         causal=True, chunk=chunk)
    x = layers.apply_norm(cfg.norm, x, params.get("final_norm"))
    return x, weights, metrics


def _f32_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[B, d] x [V, d] -> [B, V], both in f32."""
    return x.float() @ table.float().T


def prefill(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, chunk: int = 512) -> torch.Tensor:
    """Prefill forward; returns the last position's logits [B, V] f32."""
    x, _, _ = forward(cfg, params, batch, chunk=chunk)
    return _f32_logits(x[:, -1, :], _out_table(cfg, params))


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

def make_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    """A zeroed bf16 KV cache {"k", "v"}: [L, B, max_seq, Hkv, Dh] each."""
    _ported(cfg)
    dims = transformer.attn_dims(cfg)
    kv = (cfg.num_layers, batch, max_seq, dims.num_kv_heads, dims.head_dim)
    return {"k": torch.zeros(kv, dtype=COMPUTE, device=device),
            "v": torch.zeros(kv, dtype=COMPUTE, device=device)}


def decode_step(cfg: ArchConfig, params: Params,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token serve step. tokens: [B, 1]; pos: the current length, a
    Python int. Writes the token's K/V into ``cache`` in place (the
    reference returns a new cache; under jit with donation it writes in
    place too) and returns (logits [B, V] f32, cache)."""
    _ported(cfg)
    x = layers.embed(tokens, params["embed"]).to(COMPUTE)
    for l in range(cfg.num_layers):
        x, _ = transformer.attn_block_decode(
            cfg, transformer.layer(params["blocks"], l), x,
            {"k": cache["k"][l], "v": cache["v"][l]}, pos)
    x = layers.apply_norm(cfg.norm, x, params.get("final_norm"))
    return _f32_logits(x[:, 0], _out_table(cfg, params)), cache
