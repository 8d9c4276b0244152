"""The step factories (a port of the reference's ``repro/train/step.py``):
the train step (the loss and its gradients, the optional int8
error-feedback roundtrip, a clip by the global norm, then the schedule
and the optimizer's update), the prefill step and the one-token serve
step the dry run traces.

Parameters and optimizer state are the port's nested dicts of tensors;
``train_step`` is functional (it returns new trees) and makes no host
sync: its metrics stay device scalars until a caller reads them. Under
a mesh (``utils.meshctx.use_mesh``) the trees hold DTensors and each
step runs in ``meshctx.step_scope()``, where the plain tensors the model
builds count as replicated.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, grad_compress,
                               schedule as sched_lib)
from repro_torch.optim.tree import tree_leaves, tree_map, unzip
from repro_torch.utils import meshctx

Tree = Any


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted key order) of each leaf's sum
    of squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def make_optimizer(name: str) -> Tuple[Callable, Callable]:
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)


def optimizer_for(cfg: ArchConfig) -> str:
    """Adafactor for the 1T MoE (kimi: f32 Adam moments are too large),
    AdamW otherwise."""
    return "adafactor" if cfg.name.startswith("kimi") else "adamw"


def grads_of(cfg: ArchConfig, params: Tree, batch: Dict[str, torch.Tensor],
             *, remat: bool = True, attn_chunk: int = 512
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Tree]:
    """(loss, metrics, gradients) of ``model_zoo.loss_fn`` at ``params``
    (tensors that need no grad: the step takes detached leaves of
    them), the gradients a tree like ``params``; loss and metrics
    detached."""
    names = [path for path, _ in model_zoo.leaves(params)]
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = [leaf for _, leaf in model_zoo.leaves(live)]
    with torch.enable_grad():
        loss, metrics = model_zoo.loss_fn(cfg, live, batch, remat=remat,
                                          chunk=attn_chunk)
        grads = torch.autograd.grad(loss, leaves)
    tree: Dict[str, Any] = {}
    for path, g in zip(names, grads):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree


def make_train_step(cfg: ArchConfig, *, optimizer: Optional[str] = None,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, clip_norm: float = 1.0,
                    compress_grads: bool = False, remat: bool = True,
                    attn_chunk: int = 512) -> Tuple[Callable, Callable]:
    """Returns (init_opt_state, train_step);
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with the model's metrics and "loss", "grad_norm" (before
    the clip) and "lr"."""
    opt_init, opt_update = make_optimizer(optimizer or optimizer_for(cfg))

    def init_opt_state(params: Tree) -> Tree:
        state = opt_init(params)
        if compress_grads:
            state = dict(state, ef=tree_map(
                lambda p: torch.zeros(p.shape, device=p.device), params))
        return state

    def train_step(params: Tree, opt_state: Tree,
                   batch: Dict[str, torch.Tensor]):
        with meshctx.step_scope():
            return _step(params, opt_state, batch)

    def _step(params: Tree, opt_state: Tree,
              batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = grads_of(cfg, params, batch, remat=remat,
                                        attn_chunk=attn_chunk)
        if compress_grads:
            def comp(g, e):
                gf = g.float() + e
                sent = grad_compress.compress_roundtrip(gf)
                return sent.to(g.dtype), gf - sent
            grads, new_ef = unzip(tree_map(comp, grads, opt_state["ef"]), 2)
            opt_state = dict(opt_state, ef=new_ef)

        gnorm = global_norm(grads)
        scale = (clip_norm / gnorm.clamp_min(1e-9)).clamp_max(1.0)
        grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
        lr = sched_lib.warmup_cosine(opt_state["step"], peak_lr=peak_lr,
                                     warmup_steps=warmup_steps,
                                     total_steps=total_steps)
        core = {k: v for k, v in opt_state.items() if k != "ef"}
        params, core = opt_update(grads, core, params, lr)
        if compress_grads:
            core = dict(core, ef=opt_state["ef"])
        return params, core, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return init_opt_state, train_step


def make_prefill_step(cfg: ArchConfig, attn_chunk: int = 512) -> Callable:
    """``prefill_step(params, batch)`` -> the last position's logits."""
    def prefill_step(params: Tree, batch: Dict[str, torch.Tensor]):
        with meshctx.step_scope():
            return model_zoo.prefill(cfg, params, batch, chunk=attn_chunk)
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """``serve_step(params, cache, tokens, pos)`` -> (logits, cache): one
    decode token (``pos`` a Python int, as ``model_zoo.decode_step``
    takes it)."""
    def serve_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                   pos: int):
        with meshctx.step_scope():
            return model_zoo.decode_step(cfg, params, cache, tokens, pos)
    return serve_step
