"""Model zoo: ArchConfig -> parameter trees, init, and the serving entry
points (forward, prefill, the decode cache and one decode step), a port
of the reference's ``repro/models/model_zoo.py`` for all six families:

  dense / vlm-backbone / moe : pre-norm GQA attention + SwiGLU-or-MoE FFN
  ssm (rwkv6)                : time-mix + channel-mix
  hybrid (zamba2)            : Mamba2 backbone, one SHARED attention block
                               applied after every `attn_every` Mamba layers
  audio (whisper)            : enc-dec, sinusoidal positions, cross-attn

Parameters are nested dicts of tensors with the reference's names and
its stacked leading layer axis, so the reference's tree carries across
leaf for leaf (``repro_torch.convert.lm_params``). Storage is f32, bf16
for kimi; the blocks compute in bf16, the logits in f32.

Training: ``loss_fn`` (``chunked_ce_loss`` over sequence chunks, plus
0.01 x the MoE's aux loss) over ``forward(remat=True)``. The dry run's
stand-ins: ``abstract_params`` and ``input_specs`` give every tree's
shapes and dtypes as ``meta`` tensors (nothing allocated).

Under a mesh (``utils.meshctx.use_mesh``) the parameters and inputs are
DTensors and ``constrain`` pins activations at the reference's places;
the CE chunk's vocab-sharded logits then pick each label on the shard
that holds it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, linear_attn, moe as moe_lib
from repro_torch.models import transformer
from repro_torch.utils.meshctx import (cached_constant, constrain, gather_seq,
                                      is_dtensor)

Params = Dict[str, Any]
COMPUTE = torch.bfloat16


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def _norm_shape(cfg: ArchConfig):
    return None if cfg.norm == "nonparam_ln" else {"scale": (cfg.d_model,)}


def _attn_block_shapes(cfg: ArchConfig, cross: bool = False):
    d = cfg.d_model
    s: Dict[str, Any] = {}
    if _norm_shape(cfg):
        s["attn_norm"] = _norm_shape(cfg)
        s["mlp_norm"] = _norm_shape(cfg)
    s["attn"] = layers.attn_params_shape(d, transformer.attn_dims(cfg))
    if cross:
        if _norm_shape(cfg):
            s["cross_norm"] = _norm_shape(cfg)
        s["cross"] = layers.attn_params_shape(d, transformer.attn_dims(cfg))
    if cfg.num_experts:
        s["moe"] = moe_lib.moe_params_shape(d, cfg.moe_d_ff or cfg.d_ff,
                                            cfg.num_experts)
    else:
        s["mlp"] = layers.mlp_params_shape(d, cfg.d_ff, cfg.mlp)
    return s


def _rwkv_block_shapes(cfg: ArchConfig):
    dims = transformer.rwkv_dims(cfg)
    shapes = linear_attn.rwkv6_params_shape(dims)
    cm = ("mu_ck", "mu_cr", "ck", "cv", "cr")
    return {"attn_norm": _norm_shape(cfg), "mlp_norm": _norm_shape(cfg),
            "time_mix": {k: v for k, v in shapes.items() if k not in cm},
            "channel_mix": {k: shapes[k] for k in cm}}


def _mamba_block_shapes(cfg: ArchConfig):
    return {"attn_norm": _norm_shape(cfg), "mamba":
            linear_attn.mamba2_params_shape(transformer.mamba_dims(cfg))}


def _stack(shapes, n: int):
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items() if v is not None}


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Nested dict of shape tuples for the full model."""
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict[str, Any] = {"embed": (v, d)}
    if not cfg.tie_embeddings:
        tree["out_head"] = (v, d)
    if _norm_shape(cfg):
        tree["final_norm"] = _norm_shape(cfg)
    if cfg.family in ("dense", "moe", "vlm"):
        tree["blocks"] = _stack(_attn_block_shapes(cfg), cfg.num_layers)
        if cfg.family == "vlm":
            tree["connector"] = (cfg.frontend_dim, d)
    elif cfg.family == "ssm":
        tree["blocks"] = _stack(_rwkv_block_shapes(cfg), cfg.num_layers)
    elif cfg.family == "hybrid":
        g = cfg.attn_every
        n_groups, tail = divmod(cfg.num_layers, g)
        tree["groups"] = _stack(_stack(_mamba_block_shapes(cfg), g),
                                n_groups)
        if tail:
            tree["tail"] = _stack(_mamba_block_shapes(cfg), tail)
        tree["shared_attn"] = _attn_block_shapes(cfg)
    elif cfg.family == "audio":
        tree["blocks"] = _stack(_attn_block_shapes(cfg, cross=True),
                                cfg.num_layers)
        tree["encoder"] = {
            "blocks": _stack(_attn_block_shapes(cfg), cfg.encoder_layers),
            "in_proj": (cfg.frontend_dim, d)}
        if _norm_shape(cfg):
            tree["encoder"]["final_norm"] = _norm_shape(cfg)
    else:
        raise ValueError(cfg.family)
    return tree


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.name.startswith("kimi") else torch.float32


def _tree_of(shapes, leaf):
    return {k: _tree_of(v, leaf) if isinstance(v, dict) else leaf(v)
            for k, v in shapes.items()}


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree as ``meta`` tensors: its shapes and dtypes,
    nothing allocated (the dry run's stand-in)."""
    dt = param_dtype(cfg)
    return _tree_of(param_shapes(cfg), lambda s: torch.empty(
        s, dtype=dt, device="meta"))


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


def _sinusoidal(s: int, d: int) -> np.ndarray:
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)],
                          axis=1).astype(np.float32)


@cached_constant(maxsize=16)
def _positions(s: int, d: int, dtype: torch.dtype, device: torch.device
               ) -> torch.Tensor:
    """_sinusoidal(s, d) in ``dtype`` on ``device``, made once: a decode
    step would otherwise copy it to the card every token."""
    return torch.as_tensor(_sinusoidal(s, d), device=device).to(dtype)


def _add_positions(x: torch.Tensor, s: int) -> torch.Tensor:
    """x + the first ``s`` sinusoidal positions, rounded to x's dtype."""
    return x + _positions(s, x.shape[-1], x.dtype, x.device)


def encode_audio(cfg: ArchConfig, params: Params,
                 frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B, F, Df] -> [B, F, d]
    bf16: the input projection, sinusoidal positions, non-causal blocks,
    the final norm."""
    enc_p = params["encoder"]
    x = frames.to(COMPUTE) @ enc_p["in_proj"].to(COMPUTE)
    x = _add_positions(x, x.shape[1])
    for l in range(cfg.encoder_layers):
        x, _ = transformer.attn_block(cfg, transformer.layer(
            enc_p["blocks"], l), x, causal=False)
    return layers.apply_norm(cfg.norm, x, enc_p.get("final_norm"))


def _embed_inputs(cfg: ArchConfig, params: Params,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """(x [B, S, d] bf16, loss weights or None, encoder output or None).
    The VLM's patches go through the connector and take the sequence's
    first P positions (weight 0); the text's last P tokens drop off. The
    audio family's "frames" go through ``encode_audio``."""
    x = constrain(layers.embed(batch["tokens"], params["embed"]).to(COMPUTE),
                  "dp", "sp", None)
    weights = enc = None
    if cfg.family == "vlm":
        patches = batch["patches"].to(COMPUTE)                # [B, P, Dv]
        proj = patches @ params["connector"].to(COMPUTE)
        p = proj.shape[1]
        x = torch.cat([proj, x[:, : x.shape[1] - p]], dim=1)
        weights = torch.cat(
            [torch.zeros((x.shape[0], p), device=x.device),
             torch.ones((x.shape[0], x.shape[1] - p), device=x.device)],
            dim=1)
    elif cfg.family == "audio":
        enc = encode_audio(cfg, params, batch["frames"])
    return x, weights, enc


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, chunk: int = 512
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                       Dict[str, torch.Tensor]]:
    """Full causal forward -> (hidden [B, S, d] bf16, loss weights,
    metrics). ``batch`` holds "tokens" [B, S] (and "patches" [B, P, Dv]
    for a VLM, "frames" [B, F, Df] for audio) on the parameters' device.
    ``chunk`` is the attention's KV chunk; the linear attention's is 64
    (the sequence a multiple of it, or shorter). ``remat`` recomputes each
    layer's activations in the backward pass (the value is the same, bit
    for bit); whisper's encoder is not rematerialised, as in the
    reference."""
    x, weights, enc = _embed_inputs(cfg, params, batch)
    metrics: Dict[str, torch.Tensor] = {}
    if cfg.family in ("dense", "moe", "vlm"):
        x, metrics = transformer.dense_stack(cfg, params["blocks"], x,
                                             causal=True, remat=remat,
                                             chunk=chunk)
    elif cfg.family == "ssm":
        if cfg.rope_theta == 0:
            x = _add_positions(x, x.shape[1])
        x = transformer.rwkv_stack(cfg, params["blocks"], x, remat=remat)
    elif cfg.family == "hybrid":
        x = transformer.zamba_stack(cfg, params, x, remat=remat,
                                    attn_chunk=chunk)
    elif cfg.family == "audio":
        x = _add_positions(x, x.shape[1])

        def body(p, h):
            return transformer.attn_block(cfg, p, h, enc=enc, causal=True,
                                          chunk=chunk)[0]
        for l in range(cfg.num_layers):
            x = transformer.remat_call(
                body, remat, transformer.layer(params["blocks"], l), x)
    else:
        raise ValueError(cfg.family)
    x = layers.apply_norm(cfg.norm, x, params.get("final_norm"))
    return x, weights, metrics


def _vocab_axes(logits) -> list:
    """The mesh dims of more than one rank that split a DTensor's last
    (vocab) dim; none for a plain tensor."""
    if not is_dtensor(logits):
        return []
    mesh = logits.device_mesh
    return [i for i, p in enumerate(logits.placements)
            if p.is_shard() and p.dim == logits.ndim - 1 and mesh.size(i) > 1]


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim. With the vocab split over ranks it is
    the max, then the sum of exp(logits - max) over the shards (a partial
    sum) and its log: torch.logsumexp itself would gather the whole
    vocab on every rank."""
    if not _vocab_axes(logits):
        return torch.logsumexp(logits, dim=-1)
    # each reduction pinned to [B@dp, c]: left to DTensor, the partial sum
    # is reduce-scattered onto the batch dim and the gradient follows it.
    # The max is a constant shift (the gradient is the softmax either way).
    m = constrain(logits.detach().amax(dim=-1), "dp", None)
    total = constrain(torch.exp(logits - m[..., None]).sum(dim=-1), "dp", None)
    return torch.log(total) + m


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., label]: [B, c, V], [B, c] -> [B, c]. On a DTensor
    whose vocab dim is split, each shard picks the labels that fall in
    its slice (0 elsewhere) and the shards' picks are summed."""
    if not is_dtensor(logits):
        return logits.gather(-1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    vocab_axes = [i for i, p in enumerate(logits.placements)
                  if p.is_shard() and p.dim == 2]
    coord = mesh.get_coordinate()
    row = [p if p.is_shard() and p.dim == 0 else Replicate()
           for p in logits.placements]
    out = [Partial() if i in vocab_axes else row[i]
           for i in range(mesh.ndim)]

    def pick(local, lab):
        width = local.shape[-1]
        shard = 0
        for i in vocab_axes:           # major to minor, the mesh's order
            shard = shard * mesh.size(i) + coord[i]
        idx = lab.long() - shard * width
        inside = (idx >= 0) & (idx < width)
        got = local.gather(-1, idx.clamp(0, width - 1)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    return local_map(pick, out_placements=out,
                     in_placements=(logits.placements, tuple(row)),
                     device_mesh=mesh, redistribute_inputs=True)(
                         logits, labels)


def _ce_chunk(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """One chunk's weighted NLL sum: x [B, c, d] bf16 against the bf16
    table [V, d] as an f32 product (exact f32 copies; the reference's
    ``preferred_element_type=f32``), logits [B, c, V] f32, pinned to
    (dp, None, tp) under a mesh."""
    logits = constrain(x.float() @ table.float().T, "dp", None, "tp")
    lse = _logsumexp(logits)
    gold = _gold(logits, labels)
    return ((lse - gold) * weights).sum()


def chunked_ce_loss(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    chunk: int = 512) -> torch.Tensor:
    """Mean weighted cross-entropy without holding [B, S, V]: a loop over
    sequence chunks of ``chunk`` (the last padded with weight 0), the
    table cast to x's dtype once, each chunk's logits in f32. Under
    autograd each chunk is recomputed in the backward pass, so only one
    chunk's logits live at a time. x: [B, S, d], table: [V, d], labels:
    int [B, S], weights: f32 [B, S] or None (all 1)."""
    x = gather_seq(x)
    b, s, _ = x.shape
    c = min(chunk, s)
    pad = (-s) % c
    if weights is None:
        weights = torch.ones((b, s), device=x.device)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    # one cast, out of the loop; under a mesh the vocab split over tp, as
    # the logits are pinned (the reference lets GSPMD move the table so)
    table_c = constrain(table.to(x.dtype), "tp", None)
    tot = cnt = torch.zeros((), device=x.device)
    for i in range(0, s + pad, c):
        xi, li, wi = x[:, i:i + c], labels[:, i:i + c], weights[:, i:i + c]
        tot = tot + transformer.remat_call(
            _ce_chunk, torch.is_grad_enabled(), xi, table_c, li, wi)
        cnt = cnt + wi.sum()
    return tot / cnt.clamp_min(1.0)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): the chunked cross-entropy of ``forward``'s hidden
    states against ``batch["labels"]`` (a VLM's patch positions weigh 0),
    plus 0.01 x the MoE's aux loss; metrics are the model's, and
    "ce_loss" is that sum, as the reference names it."""
    x, weights, metrics = forward(cfg, params, batch, remat=remat,
                                  chunk=chunk)
    loss = chunked_ce_loss(x, _out_table(cfg, params), batch["labels"],
                           weights)
    if "moe_aux_loss" in metrics:
        loss = loss + 0.01 * metrics["moe_aux_loss"]
    metrics["ce_loss"] = loss
    return loss, metrics


def _f32_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[B, d] x [V, d] -> [B, V], both in f32."""
    return x.float() @ table.float().T


def prefill(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, chunk: int = 512) -> torch.Tensor:
    """Prefill forward; returns the last position's logits [B, V] f32."""
    x, _, _ = forward(cfg, params, batch, remat=False, chunk=chunk)
    return _f32_logits(x[:, -1, :], _out_table(cfg, params))


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

def make_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda"
               ) -> Dict[str, Any]:
    """A zeroed decode cache, the reference's tree:

    - dense / moe / vlm: bf16 K/V {"k", "v"} [L, B, max_seq, Hkv, Dh];
    - audio: those and the cross cache {"ck", "cv"} [L, B, frontend_len,
      Hkv, Dh] (zeros: the caller fills it with the encoder's K/V);
    - ssm: f32 {"att_shift", "ffn_shift"} [L, B, d] and "wkv"
      [L, B, H, hd, hd] (the shifts come back bf16 from a step);
    - hybrid: f32 {"groups": {"ssm" [G, g, B, H, d_state, hd], "conv"
      [G, g, B, W-1, d_inner + 2 d_state]}}, bf16 "shared_k" / "shared_v"
      [G, B, max_seq, Hkv, Dh] (one K/V per application of the shared
      block), and "tail" like "groups" without G when g leaves one."""
    dims = transformer.attn_dims(cfg)

    def mk(shape, dtype=COMPUTE):
        return torch.zeros(shape, dtype=dtype, device=device)

    f32 = torch.float32
    n = cfg.num_layers
    kv = (n, batch, max_seq, dims.num_kv_heads, dims.head_dim)
    if cfg.family in ("dense", "moe", "vlm"):
        return {"k": mk(kv), "v": mk(kv)}
    if cfg.family == "audio":
        ckv = (n, batch, cfg.frontend_len, dims.num_kv_heads, dims.head_dim)
        return {"k": mk(kv), "v": mk(kv), "ck": mk(ckv), "cv": mk(ckv)}
    if cfg.family == "ssm":
        rd = transformer.rwkv_dims(cfg)
        return {"att_shift": mk((n, batch, cfg.d_model), f32),
                "ffn_shift": mk((n, batch, cfg.d_model), f32),
                "wkv": mk((n, batch, rd.num_heads, rd.head_dim,
                           rd.head_dim), f32)}
    if cfg.family == "hybrid":
        md = transformer.mamba_dims(cfg)
        g = cfg.attn_every
        n_groups, tail = divmod(n, g)
        conv_c = md.d_inner + 2 * md.d_state

        def mamba_state(*lead):
            return {"ssm": mk(lead + (batch, md.num_heads, md.d_state,
                                      md.head_dim), f32),
                    "conv": mk(lead + (batch, md.conv_width - 1, conv_c),
                               f32)}
        shared = (n_groups, batch, max_seq, dims.num_kv_heads, dims.head_dim)
        cache = {"groups": mamba_state(n_groups, g),
                 "shared_k": mk(shared), "shared_v": mk(shared)}
        if tail:
            cache["tail"] = mamba_state(tail)
        return cache
    raise ValueError(cfg.family)


def _mamba_decode_into(cfg: ArchConfig, blocks: Params, x: torch.Tensor,
                       state: Dict[str, torch.Tensor], n: int
                       ) -> torch.Tensor:
    """``n`` Mamba blocks for one token, each block's new state written
    into ``state``'s [n, ...] tensors in place."""
    for l in range(n):
        x, st = transformer.mamba_block_decode(
            cfg, transformer.layer(blocks, l), x,
            {"ssm": state["ssm"][l], "conv": state["conv"][l]})
        state["ssm"][l] = st["ssm"]
        state["conv"][l] = st["conv"]
    return x


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token serve step. tokens: [B, 1]; pos: the current length, a
    Python int. Returns (logits [B, V] f32, the new cache).

    Every state whose dtype a step keeps is written into ``cache`` in
    place (the reference returns a new cache; under jit with donation it
    writes in place too): the K/V at ``pos``, the RWKV ``wkv`` and the
    Mamba states. The RWKV shifts are new tensors: a step returns them in
    the compute dtype, bf16, whatever the cache held (f32 zeros from
    ``make_cache``), as the reference's does. The audio family adds the
    sinusoidal position 0's encoding at every step, as the reference
    does."""
    x = layers.embed(tokens, params["embed"]).to(COMPUTE)
    n = cfg.num_layers
    layer = transformer.layer
    new_cache = cache
    if cfg.family in ("dense", "moe", "vlm"):
        for l in range(n):
            x, _ = transformer.attn_block_decode(
                cfg, layer(params["blocks"], l), x,
                {"k": cache["k"][l], "v": cache["v"][l]}, pos)
    elif cfg.family == "audio":
        x = _add_positions(x, 1)
        for l in range(n):
            x, _ = transformer.attn_block_decode(
                cfg, layer(params["blocks"], l), x,
                {"k": cache["k"][l], "v": cache["v"][l]}, pos,
                enc_kv=(cache["ck"][l], cache["cv"][l]))
    elif cfg.family == "ssm":
        att, ffn = [], []
        for l in range(n):
            x, st = transformer.rwkv_block_decode(
                cfg, layer(params["blocks"], l), x,
                {"att_shift": cache["att_shift"][l],
                 "ffn_shift": cache["ffn_shift"][l],
                 "wkv": cache["wkv"][l]})
            cache["wkv"][l] = st["wkv"]
            att.append(st["att_shift"])
            ffn.append(st["ffn_shift"])
        new_cache = dict(cache, att_shift=torch.stack(att),
                         ffn_shift=torch.stack(ffn))
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        for gi in range(n // cfg.attn_every):
            x = _mamba_decode_into(
                cfg, layer(params["groups"], gi), x,
                layer(cache["groups"], gi), cfg.attn_every)
            x, _ = transformer.attn_block_decode(
                cfg, shared, x, {"k": cache["shared_k"][gi],
                                 "v": cache["shared_v"][gi]}, pos)
        if "tail" in params:
            x = _mamba_decode_into(cfg, params["tail"], x, cache["tail"],
                                   n % cfg.attn_every)
    else:
        raise ValueError(cfg.family)
    x = layers.apply_norm(cfg.norm, x, params.get("final_norm"))
    return _f32_logits(x[:, 0], _out_table(cfg, params)), new_cache


# ---------------------------------------------------------------------------
# input_specs (dry-run stand-ins, nothing allocated)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, seq_len: int, global_batch: int,
                kind: str) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of a shape cell, the
    reference's tree: train / prefill {"batch": {"tokens" i32[B, S]
    (train: "labels" too), a VLM's "patches" / audio's "frames" bf16[B,
    frontend_len, frontend_dim]}}; decode {"tokens" i32[B, 1], "cache"
    (``make_cache``'s tree), "pos" i32[]}."""
    b, s = global_batch, seq_len

    def tok(shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": tok((b, s))}
        if kind == "train":
            batch["labels"] = tok((b, s))
        if cfg.family in ("vlm", "audio"):
            batch["patches" if cfg.family == "vlm" else "frames"] = \
                torch.empty((b, cfg.frontend_len, cfg.frontend_dim),
                            dtype=COMPUTE, device="meta")
        return {"batch": batch}
    if kind == "decode":
        return {"tokens": tok((b, 1)),
                "cache": make_cache(cfg, b, s, device="meta"),
                "pos": tok(())}
    raise ValueError(kind)
