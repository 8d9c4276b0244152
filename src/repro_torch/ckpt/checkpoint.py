"""Fault-tolerant checkpoints (a port of the reference's
``repro/ckpt/checkpoint.py``), in its layout:

    <dir>/step_<N:08d>/arrays.npz    the tree's leaves, by key
                      /meta.msgpack  step, keys, dtypes, shardings, extra
    <dir>/step_<N:08d>.done          commit marker

A save writes into a temporary directory, renames it into place and then
writes the marker, so a crash mid-save never leaves a committed step
half written; ``keep`` retention deletes only committed steps older than
the newest ``keep``. Leaves are named as the reference's
``tree_flatten_with_path`` names them (sorted dict keys and tuple
indices, joined by "/"), and a bf16 leaf is stored by its bits as the
reference's numpy writes it (a 2-byte void), so files cross between the
two packages (tests/test_torch_train.py says which way). ``meta``'s
``shardings`` is ``{}``: one device places nothing (the placement record
waits for the multi-device tooling, ROADMAP Queue 1 item 4.5).
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import msgpack_lite

Tree = Any
_BF16_BITS = np.dtype("V2")


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs: dict keys sorted, tuple / list items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(like: Tree, leaves: Dict[str, Any], prefix: str = "") -> Tree:
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, key(k)) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, key(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf on the host; a bf16 tensor as its bits in a 2-byte void."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Tree,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """Commit ``tree`` (nested dicts / tuples of tensors or arrays) as
    step ``step``; returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        leaves = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: _to_numpy(v) for k, v in leaves})
        meta = {"step": int(step), "keys": [k for k, _ in leaves],
                "dtypes": [_dtype_name(v) for _, v in leaves],
                "shardings": {}, "extra": extra or {}}
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(msgpack_lite.packb(meta))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(final + ".done", "w") as f:      # the commit marker
            f.write("ok")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _committed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".done"):
            if os.path.exists(os.path.join(directory, name) + ".done"):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _gc(directory: str, keep: int) -> None:
    steps = _committed_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        path = os.path.join(directory, f"step_{s:08d}")
        shutil.rmtree(path, ignore_errors=True)
        try:
            os.remove(path + ".done")
        except OSError:
            pass


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _leaf(arr: np.ndarray, dtype_name: str, like: torch.Tensor, key: str
          ) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: saved shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    arr = np.array(arr)              # a contiguous copy, 0-d kept 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(directory: str, like: Tree, step: Optional[int] = None
            ) -> Tuple[Tree, Dict[str, Any]]:
    """(the tree saved at ``step``, newest committed by default, in the
    structure, dtypes and devices of ``like``'s tensors; the meta)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = msgpack_lite.unpackb(f.read())
    dtypes = dict(zip(meta["keys"], meta["dtypes"]))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = {k: _leaf(z[k], dtypes[k], v, k) for k, v in _flatten(like)}
    return _unflatten(like, leaves), meta
