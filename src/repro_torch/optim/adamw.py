"""AdamW and Adafactor on PyTorch (a port of the reference's
``repro/optim/adamw.py``), pure functions over the port's nested-dict
trees: ``*_init(params)`` makes the state, ``*_update(grads, state,
params, lr)`` returns (new params, new state). ``step`` is an int32
tensor on the parameters' device, so an update makes no host sync. The
arithmetic is the reference's, operation for operation, in f32."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, unzip

Tree = Any


def _step0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params: Tree, cfg: AdamWConfig = AdamWConfig()) -> Tree:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step0(params)}


def adamw_update(grads: Tree, state: Tree, params: Tree, lr: torch.Tensor,
                 cfg: AdamWConfig = AdamWConfig()) -> Tuple[Tree, Tree]:
    """One AdamW step with bias correction and decoupled weight decay;
    ``lr`` an f32 scalar tensor."""
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(g, m, v, p):
        gf = g.float()
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    p_new, m_new, v_new = unzip(
        tree_map(upd, grads, state["m"], state["v"], params), 3)
    return p_new, {"m": m_new, "v": v_new, "step": step}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), simplified: a factored v for leaves of
# two or more axes, a bf16 first moment, RMS clipping. The state of a
# [.., R, C] leaf is v_row [.., R] and v_col [.., C].
# ---------------------------------------------------------------------------

class AdafactorConfig(NamedTuple):
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    momentum: float = 0.9
    moment_dtype: torch.dtype = torch.bfloat16


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Tree,
                   cfg: AdafactorConfig = AdafactorConfig()) -> Tree:
    def init_leaf(p):
        shape, dev = tuple(p.shape), p.device
        m = torch.zeros(shape, dtype=cfg.moment_dtype, device=dev)
        if _factored(shape):
            return {"v_row": torch.zeros(shape[:-1], device=dev),
                    "v_col": torch.zeros(shape[:-2] + shape[-1:],
                                         device=dev),
                    "m": m}
        return {"v": torch.zeros(shape, device=dev), "m": m}

    return {"leaves": tree_map(init_leaf, params), "step": _step0(params)}


def adafactor_update(grads: Tree, state: Tree, params: Tree,
                     lr: torch.Tensor,
                     cfg: AdafactorConfig = AdafactorConfig()
                     ) -> Tuple[Tree, Tree]:
    step = state["step"] + 1
    beta = cfg.decay

    def upd(g, p, s):
        gf = g.float()
        g2 = gf * gf + cfg.eps
        if _factored(p.shape):
            v_row = beta * s["v_row"] + (1 - beta) * g2.mean(-1)
            v_col = beta * s["v_col"] + (1 - beta) * g2.mean(-2)
            row_mean = v_row.mean(-1, keepdim=True)
            r = v_row / row_mean.clamp_min(cfg.eps)
            update = gf / (torch.sqrt(r)[..., None]
                           * torch.sqrt(v_col)[..., None, :])
            new_s = {"v_row": v_row, "v_col": v_col}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            update = gf / torch.sqrt(v)
            new_s = {"v": v}
        rms = torch.sqrt(torch.mean(update * update))
        update = update / (rms / cfg.clip_threshold).clamp_min(1.0)
        m = cfg.momentum * s["m"].float() + (1 - cfg.momentum) * update
        new_s["m"] = m.to(cfg.moment_dtype)
        p_new = p.float() - lr * (m + cfg.weight_decay * p.float())
        return p_new.to(p.dtype), new_s

    # The state's leaves are dicts, so walk the parameters' tree.
    p_new, s_new = unzip(_map_params(upd, grads, params, state["leaves"]), 2)
    return p_new, {"leaves": s_new, "step": step}


def _map_params(fn, grads: Tree, params: Tree, states: Tree) -> Tree:
    """``fn(g, p, s)`` at each parameter leaf, where ``s`` is the state
    dict that sits at that leaf's place in ``states``."""
    if isinstance(params, dict):
        return {k: _map_params(fn, grads[k], v, states[k])
                for k, v in params.items()}
    return fn(grads, params, states)
