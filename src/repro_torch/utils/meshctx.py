"""Activation-sharding context (a port of the reference's
``repro/utils/meshctx.py``): model code calls ``constrain(x, ...logical
axes...)``; while a mesh is active (set by the launcher or the dry run
with ``use_mesh``) a DTensor is redistributed to the placements those
axes name, otherwise ``x`` comes back untouched (one device).

The reference pins activations to [batch@dp, ...] so that the weights,
not full-batch activations, are what moves between devices; the
constraints sit at the same places here, as DTensor redistributions.

Logical axis vocabulary: "dp" (data, or pod x data), "tp" (model), "dpt"
(every axis: a fully sharded token dim), "sp" (the model axis, only
while sequence parallelism is on), None. A name the mesh lacks
resolves to None.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch._guards import detect_fake_mode

_state = threading.local()

Resolved = Union[None, str, Tuple[str, ...]]


def current_mesh():
    """The mesh ``use_mesh`` made active in this thread, or None."""
    return getattr(_state, "mesh", None)


def current_state() -> Tuple[object, bool]:
    """(the active mesh, whether sequence parallelism is on): what
    ``use_mesh(*state)`` restores on another thread, such as the autograd
    engine's, where a rematerialised forward runs."""
    return current_mesh(), getattr(_state, "sp", False)


@contextlib.contextmanager
def use_mesh(mesh, sp: bool = False):
    """Make ``mesh`` (a ``DeviceMesh``, or None for none) the active mesh
    of this thread, with sequence parallelism on or off, until the block
    ends."""
    prev = current_mesh()
    prev_sp = getattr(_state, "sp", False)
    _state.mesh = mesh
    _state.sp = sp
    try:
        yield
    finally:
        _state.mesh = prev
        _state.sp = prev_sp


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of anything with
    ``axis_names`` (a ``SearchMesh``, a stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` on ``mesh``."""
    names = axis_names(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return int(mesh.size(names.index(name)))
    return int(mesh.shape[name])


def _resolve(mesh, axis: Optional[str]) -> Resolved:
    names = axis_names(mesh)
    if axis is None:
        return None
    if axis == "dp":
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if axes else None
    if axis == "tp":
        return "model" if "model" in names else None
    if axis == "dpt":  # every mesh axis (fully-sharded token dim)
        axes = tuple(a for a in ("pod", "data", "model") if a in names)
        return axes if axes else None
    if axis == "sp":   # sequence parallelism: model axis iff enabled
        if getattr(_state, "sp", False) and "model" in names:
            return "model"
        return None
    return axis if axis in names else None


def spec_of(mesh, shape: Sequence[int],
            logical: Sequence[Optional[str]]) -> Tuple[Resolved, ...]:
    """The reference's per-dim rule: an axis stays iff the dim divides
    by its size (a size-1 axis stays, unlike ``dist.sharding.spec_for``,
    which also needs size > 1)."""
    spec = []
    for dim, ax in zip(shape, logical):
        r = _resolve(mesh, ax)
        if r is None:
            spec.append(None)
            continue
        size = 1
        for a in (r if isinstance(r, tuple) else (r,)):
            size *= axis_size(mesh, a)
        spec.append(r if (size > 0 and dim % size == 0) else None)
    return tuple(spec)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. A plain tensor answers without an
    import: the one-device path of every model asks this."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to the placements ``logical`` names on the
    active mesh; ``x`` itself when no mesh is active, when ``x`` is not a
    DTensor, or when its rank is not the number of logical axes."""
    mesh = current_mesh()
    if mesh is None or len(logical) != x.ndim or not is_dtensor(x):
        return x
    from repro_torch.dist.sharding import placements
    return x.redistribute(mesh, placements(
        mesh, spec_of(mesh, x.shape, logical)))


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """Under sequence parallelism the residual stream [B, S, ..] is split
    over S as well as B; a projection first gathers it to [B@dp, ..]
    (Megatron-SP's entering all-gather, the move GSPMD makes for the
    reference's (dp, None, tp) constraint on the product), so no product
    flattens two split dims into one. Without "sp" on, ``x`` itself."""
    if not getattr(_state, "sp", False):
        return x
    return constrain(x, "dp", *(None,) * (x.ndim - 1))


Layout = Optional[Dict[int, int]]


def on_shards(fn: Callable, lead: torch.Tensor, args: Sequence,
              layouts: Sequence[Layout], out_layouts):
    """``fn(*args)``, on each shard's own pieces when ``lead`` is a
    DTensor (``local_map``). ``fn`` must treat the split dims of
    ``lead`` independently (batch rows, heads). ``layouts[i]`` maps
    ``lead``'s dims to ``args[i]``'s ({0: 0, 2: 1}: lead's dim 2 is
    the argument's dim 1; None for an argument that is not a tensor);
    each argument is redistributed to the split of ``lead`` that its
    layout carries, replicated on the other mesh dims, and the outputs
    come back split by ``out_layouts`` (one layout, or a tuple of them
    for a tuple of outputs). Off a mesh, ``fn(*args)``."""
    if not is_dtensor(lead):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    split = [p if p.is_shard() else Replicate() for p in lead.placements]

    def placed(layout):
        if layout is None:
            return None
        return tuple(Shard(layout[p.dim]) if p.is_shard() and p.dim in layout
                     else Replicate() for p in split)
    many = isinstance(out_layouts, tuple)
    # a single output's placements are a list (a tuple means one per output)
    out_pl = (tuple(placed(o) for o in out_layouts) if many
              else list(placed(out_layouts)))
    mesh = lead.device_mesh
    args = [DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            else a for a in args]
    return local_map(fn, out_placements=out_pl,
                     in_placements=tuple(placed(l) for l in layouts),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def cached_constant(maxsize: Optional[int] = None):
    """``functools.lru_cache`` for functions that make constant tensors
    (RoPE frequencies, sinusoidal positions). Under a fake tensor mode
    (the dry run) the function runs uncached: a fake tensor belongs to
    the mode that made it and cannot be reused under another. A fake mode
    is looked for only while a dispatch mode is active."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if (torch._C._len_torch_dispatch_stack()
                    and detect_fake_mode() is not None):
                return fn(*args)
            return cached(*args)
        call.cache_clear = cached.cache_clear
        return call
    return wrap


def step_scope():
    """The context a sharded step runs in: under an active mesh, DTensor's
    ``implicit_replication`` (the plain tensors a model builds, such as
    positions, masks and zero states, count as replicated); without one,
    nothing."""
    if current_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()
