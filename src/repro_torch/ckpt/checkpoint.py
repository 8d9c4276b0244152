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
two packages (tests/test_torch_train.py says which way).

Elastic resharding, as the reference's: a DTensor leaf is saved
de-sharded (``full_tensor()``), and ``meta["shardings"]`` records its
placement per key in the reference's form, {"spec", "mesh_axes",
"mesh_shape"}, the spec one entry per dim (None, an axis name, or a list
of names). ``restore(shardings=)`` places each leaf again: by a tree of
``dist.sharding.NamedSharding`` (mesh, spec) pairs, or, given a
``DeviceMesh``, by each saved spec re-derived for that mesh
(``_respec``: axes it lacks, or whose size no longer divides the dim,
replicate). Each package reads the other's record. In a world of
several ranks every rank takes part in the save (the de-sharding is a
collective) and rank 0 writes.
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


def _flatten(tree: Tree, prefix: str = "", is_leaf=None
             ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs: dict keys sorted, tuple / list items by index
    (``is_leaf`` names objects that are leaves whatever their type)."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else k, is_leaf)
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
    if _is_dtensor(leaf):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return str(np.asarray(leaf).dtype)


def _is_dtensor(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _sharding_meta(leaf) -> Optional[Dict[str, Any]]:
    """The reference's record of where a DTensor leaf lived."""
    if not _is_dtensor(leaf):
        return None
    mesh = leaf.device_mesh
    names = list(mesh.mesh_dim_names)
    spec: List[Any] = [[] for _ in range(leaf.ndim)]
    for name, p in zip(names, leaf.placements):
        if p.is_shard():
            spec[p.dim].append(name)
    return {"spec": [None if not e else e[0] if len(e) == 1 else e
                     for e in spec],
            "mesh_axes": names,
            "mesh_shape": [int(mesh.size(i)) for i in range(mesh.ndim)]}


def _to_numpy(leaf) -> np.ndarray:
    """A leaf on the host (a DTensor whole); a bf16 tensor as its bits in
    a 2-byte void."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Tree,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """Commit ``tree`` (nested dicts / tuples of tensors or arrays) as
    step ``step``; returns the step's directory."""
    leaves = _flatten(tree)
    arrays = {k: _to_numpy(v) for k, v in leaves}   # every rank: collectives
    shardings = {k: m for k, m in ((k, _sharding_meta(v)) for k, v in leaves)
                 if m is not None}
    final = os.path.join(directory, f"step_{step:08d}")
    rank, world = _rank_world()
    if rank != 0:
        _barrier(world)
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"step": int(step), "keys": [k for k, _ in leaves],
                "dtypes": [_dtype_name(v) for _, v in leaves],
                "shardings": shardings, "extra": extra or {}}
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
    _barrier(world)
    return final


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(world: int) -> None:
    """Every rank waits for rank 0's commit (nothing in a world of 1)."""
    if world > 1:
        import torch.distributed as dist
        dist.barrier()


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


def _leaf(arr: np.ndarray, dtype_name: str, like: torch.Tensor, key: str,
          placed=None) -> torch.Tensor:
    """The saved array as a tensor of ``like``'s dtype: on ``like``'s
    device, or, with ``placed`` = (mesh, spec), a DTensor placed so (a
    DTensor ``like`` without one keeps its own placement)."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: saved shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    arr = np.array(arr)              # a contiguous copy, 0-d kept 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    from torch.distributed.tensor import distribute_tensor
    if placed is not None:
        from repro_torch.dist.sharding import placements
        mesh, spec = placed
        return distribute_tensor(t.to(device=mesh.device_type,
                                      dtype=like.dtype), mesh,
                                 placements(mesh, spec))
    if _is_dtensor(like):
        return distribute_tensor(t.to(device=like.device_mesh.device_type,
                                      dtype=like.dtype),
                                 like.device_mesh, like.placements)
    return t.to(device=like.device, dtype=like.dtype)


def _respec(saved: Dict[str, Any], mesh, shape) -> Tuple[Any, ...]:
    """The spec recorded at save time re-derived for ``mesh`` (maybe
    another shape): axes the mesh lacks, or whose size no longer divides
    the dim, drop out (``dist.sharding.spec_for``, the rule shared with
    placement)."""
    from repro_torch.dist.sharding import spec_for
    spec = saved.get("spec", [])
    logical = [tuple(e) if isinstance(e, list) else e for e in spec]
    logical += [None] * (len(shape) - len(logical))
    return spec_for(mesh, shape, logical)


def restore(directory: str, like: Tree, step: Optional[int] = None,
            shardings: Optional[Any] = None
            ) -> Tuple[Tree, Dict[str, Any]]:
    """(the tree saved at ``step``, newest committed by default, in the
    structure and dtypes of ``like``'s tensors; the meta). Each leaf goes
    to its ``like``'s device (a DTensor ``like``: its mesh and
    placements), unless ``shardings`` places it (elastic restore):

      * a tree of ``dist.sharding.NamedSharding`` (mesh, spec) matching
        ``like`` leaf for leaf; or
      * a ``DeviceMesh``: each leaf's spec recorded at save time,
        re-derived for this mesh (``_respec``; the (4, 2) -> (2, 4)
        reshard), a leaf saved without one replicated."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = msgpack_lite.unpackb(f.read())
    dtypes = dict(zip(meta["keys"], meta["dtypes"]))
    saved = meta.get("shardings") or {}
    like_leaves = _flatten(like)
    if shardings is None:
        placed = {k: None for k, _ in like_leaves}
    elif hasattr(shardings, "mesh_dim_names"):
        placed = {k: (shardings, _respec(saved.get(k, {}), shardings,
                                         tuple(v.shape)))
                  for k, v in like_leaves}
    else:
        placed = {k: (sh.mesh, sh.spec) for k, sh in _flatten(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = {k: _leaf(z[k], dtypes[k], v, k, placed[k])
                  for k, v in like_leaves}
    return _unflatten(like, leaves), meta
