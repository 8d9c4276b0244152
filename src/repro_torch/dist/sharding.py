"""Placement rules on a mesh (a port of the reference's
``repro/dist/sharding.py``), in two halves.

The LM half: per-leaf ``PartitionSpec`` rules for parameter trees
(``param_spec``, ``param_shardings``), optimizer state
(``opt_shardings``: AdamW's ``m`` / ``v``, Adafactor's factored
moments, the error-feedback ``ef`` buffer), input batches
(``batch_shardings``) and decode caches (``cache_shardings``). A spec is
the reference's ``PartitionSpec`` as a plain tuple with one entry per
tensor dim: None, an axis name, or a tuple of names. "tp" resolves to
the ``"model"`` axis, "dp" to ``("pod", "data")``, whichever of those
the mesh has, and every rule is divisibility-checked per dim: an axis
of size 1, or one that does not divide the dim, drops out (replication),
so the (1, 1) host mesh and odd sizes never raise. The rules read only
axis names and sizes, so they take a ``DeviceMesh``, a ``SearchMesh`` or
any object with ``axis_names`` and a ``shape`` dict alike.
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``
and ``distribute`` places a tree by them.

Weight layout convention (the matmuls in ``models/layers.py``): input
projections [.., d_in, d_out] put d_in over dp (FSDP) and d_out over tp
(column-parallel); output projections [.., d_out, d_in] (wo / out_proj /
cv) put the contracted dim over tp (row-parallel) and the other over dp;
leading stacked axes (layers, experts) are never sharded; vectors,
norm scales, per-head scalars, depthwise convs and the router replicate.

The index half: ``place_index`` for an IVF index,
an HNSW graph and a mutable view of either, ``refresh_placed_view``, the
row padding of a flat database (``database_shards``), and the slot rule
of the multi-host pool (``slot_sharding``, ``constrain_slots``).

The sharded dim (a bucket's cap, a graph's or a database's rows) is
padded up to a multiple of the shard count first; padded slots keep the
index's own padding contract (vecs 0, ids -1, sqnorm +inf), so they
never surface in a top-k. Shard s holds the contiguous block
``[s * m, (s + 1) * m)`` of the padded dim (m = padded / S), as its own
contiguous tensor on ``mesh.devices[s]``, so shard order is row order.

On a serve mesh (``("hosts", "model")``) the index stays GLOBAL: every
placement rule names only ``"model"``, so host group h reads shard s
from ``mesh.devices[h * S + s]`` (``host_index``). Where two host groups
name the same device they share the same tensors: on one card the store
is held once, whatever the number of host groups.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM
from repro_torch.index.hnsw import HNSWIndex
from repro_torch.index.ivf import IVFIndex
from repro_torch.launch.mesh import HOSTS_AXIS, SHARD_AXIS, SearchMesh
from repro_torch.utils import meshctx

# Bucket-store arrays whose cap dim (axis 1) is split across shards, with
# their pad values. bucket_sizes [nlist] is NOT here: it replicates, so
# the probe step's ndis counts true bucket populations.
_CAP_SHARDED_NAMES = {"bucket_vecs": 0, "bucket_ids": PAD_ID,
                      "bucket_sqnorm": PAD_SQNORM}
# HNSW graph arrays whose node dim (axis 0) is split across shards.
# entry / route_ids replicate: routing and the frontier bookkeeping stay
# on the lead device, only vector and adjacency rows live on their shard.
_ROW_SHARDED_NAMES = {"vectors": 0, "neighbors": PAD_ID,
                      "sqnorm": PAD_SQNORM}


def shard_count(mesh: SearchMesh, axis: str = SHARD_AXIS) -> int:
    """Size of ``axis`` on ``mesh`` (1 when the mesh lacks the axis)."""
    return int(mesh.shape[axis]) if axis in mesh.axis_names else 1


def shard_devices(mesh: SearchMesh) -> Tuple[torch.device, ...]:
    """The devices of host group 0's shards, in shard order."""
    if tuple(mesh.axis_names) not in ((SHARD_AXIS,),
                                      (HOSTS_AXIS, SHARD_AXIS)):
        raise ValueError(
            f"placement on a mesh with axes {mesh.axis_names}: a search "
            f"mesh is ('{SHARD_AXIS}',) and a serve mesh "
            f"('{HOSTS_AXIS}', '{SHARD_AXIS}')")
    return mesh.host(0).devices


def _blocks(t: torch.Tensor, dim: int, devices, value) -> List[torch.Tensor]:
    """``t`` padded with ``value`` along ``dim`` to a multiple of
    len(devices), split into contiguous blocks, block s on devices[s].
    Only the blocks that reach past the end are padded (a copy); the
    others are views, copied only to another device or to make them
    contiguous."""
    s = len(devices)
    n = t.shape[dim]
    m = -(-n // s)
    out = []
    for j, dev in enumerate(devices):
        lo = min(j * m, n)
        hi = min(lo + m, n)
        part = t.narrow(dim, lo, hi - lo)
        if hi - lo < m:
            shape = list(t.shape)
            shape[dim] = m - (hi - lo)
            part = torch.cat([part, t.new_full(shape, value)], dim)
        out.append(part.to(dev).contiguous())
    return out


def database_shards(x: torch.Tensor, mesh: SearchMesh,
                    value=0.0) -> List[torch.Tensor]:
    """Row-shard an [N, ...] database over the ``"model"`` axis: N padded
    with ``value`` to a multiple of S, shard s = rows [s*N/S, (s+1)*N/S)
    on ``mesh.devices[s]``. The sharded flat search pads vectors with 0
    and their sqnorm with +inf."""
    return _blocks(x, 0, shard_devices(mesh), value)


@dataclasses.dataclass
class PlacedIVFIndex:
    """An IVF index placed on a mesh: each bucket's cap dim split over
    the shards, the small tables replicated on the lead device.

    Reads like an ``IVFIndex`` where the engine, ``Darth`` and the server
    read one (``device``, ``nlist``, ``cap``, ``dim``, ``num_vectors``,
    ``quantized``, ``hot_map``); the store itself is only reachable per
    shard, through ``dist.collectives.make_sharded_probe_step``. On a
    serve mesh, ``host_views[h]`` is host group h's placement
    (``host_index``)."""
    mesh: SearchMesh
    centroids: torch.Tensor                  # f32[nlist, D], lead
    bucket_vecs: Tuple[torch.Tensor, ...]    # S x [nlist, cap/S, D]
    bucket_ids: Tuple[torch.Tensor, ...]     # S x i32[nlist, cap/S]
    bucket_sqnorm: Tuple[torch.Tensor, ...]  # S x f32[nlist, cap/S]
    bucket_sizes: torch.Tensor               # i32[nlist], lead
    scale: torch.Tensor                      # f32[D], lead
    offset: torch.Tensor                     # f32[D], lead
    hot_map: Optional[torch.Tensor] = None   # i32[nlist], lead
    host_views: Tuple[Any, ...] = dataclasses.field(
        default=(), repr=False, compare=False)

    @property
    def quantized(self) -> bool:
        return self.bucket_vecs[0].dtype == torch.int8

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        """The padded cap: the sum of the shards' slices."""
        return sum(v.shape[1] for v in self.bucket_vecs)

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def num_vectors(self) -> int:
        return int(self.bucket_sizes.sum())

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def num_shards(self) -> int:
        return len(self.bucket_vecs)


@dataclasses.dataclass
class PlacedHNSWIndex:
    """An HNSW graph placed on a mesh: vectors, sqnorm and neighbors split
    on the node dim (N padded to a multiple of S), the entry, the routing
    sample and the SQ8 tables on the lead device. The routing sample's
    vectors (as f32) and sqnorm are gathered once here, so the sharded
    init routes with no cross-shard gather.

    Reads like an ``HNSWIndex`` where the engine, ``Darth`` and the
    server read one (``device``, ``num_vectors`` = the padded N,
    ``degree``, ``quantized``); the rows are only reachable per shard,
    through ``dist.collectives.make_sharded_beam_step``."""
    mesh: SearchMesh
    vectors: Tuple[torch.Tensor, ...]    # S x f32|int8[N_pad/S, D]
    sqnorm: Tuple[torch.Tensor, ...]     # S x f32[N_pad/S]
    neighbors: Tuple[torch.Tensor, ...]  # S x i32[N_pad/S, M]
    entry: torch.Tensor                  # i32[], lead
    route_ids: torch.Tensor              # i32[R], lead
    route_vecs: torch.Tensor             # f32[R, D], lead
    route_sqnorm: torch.Tensor           # f32[R], lead
    scale: Optional[torch.Tensor] = None   # f32[D], lead
    offset: Optional[torch.Tensor] = None  # f32[D], lead
    host_views: Tuple[Any, ...] = dataclasses.field(
        default=(), repr=False, compare=False)

    @property
    def quantized(self) -> bool:
        return self.vectors[0].dtype == torch.int8

    @property
    def rows(self) -> int:
        """Rows a shard holds (N_pad / S)."""
        return self.vectors[0].shape[0]

    @property
    def num_vectors(self) -> int:
        return sum(v.shape[0] for v in self.vectors)

    @property
    def degree(self) -> int:
        return self.neighbors[0].shape[1]

    @property
    def dim(self) -> int:
        return self.route_vecs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.route_ids.device

    @property
    def num_shards(self) -> int:
        return len(self.vectors)


def _is_view(index) -> bool:
    """A ``mutate.MutableIndexView`` (base + delta ring)."""
    return hasattr(index, "base") and hasattr(index, "delta")


def _to(obj, dev):
    """A dataclass of tensors (a delta ring) with every tensor on dev."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _with_host_views(placed, mesh: SearchMesh, sharded):
    """On a serve mesh with several host groups: ``placed`` (host group
    0's) with one placement per group, each tensor moved to that group's
    devices (``.to`` returns the tensor itself where the device is the
    same, so groups that share devices share the tensors)."""
    if mesh.num_hosts == 1:
        return placed
    views = []
    for sub in mesh.host_meshes():
        kw = {"mesh": sub}
        for f in dataclasses.fields(placed):
            v = getattr(placed, f.name)
            if f.name in sharded:
                kw[f.name] = tuple(t.to(d) for t, d in zip(v, sub.devices))
            elif isinstance(v, torch.Tensor):
                kw[f.name] = v.to(sub.lead)
        views.append(dataclasses.replace(placed, **kw))
    return dataclasses.replace(placed, host_views=tuple(views))


def _place_ivf(index: IVFIndex, mesh: SearchMesh) -> PlacedIVFIndex:
    devices = shard_devices(mesh)
    lead = devices[0]
    store = {name: tuple(_blocks(getattr(index, name), 1, devices, value))
             for name, value in _CAP_SHARDED_NAMES.items()}

    def rep(t):
        return None if t is None else t.to(lead)
    placed = PlacedIVFIndex(
        mesh=mesh, centroids=rep(index.centroids),
        bucket_sizes=rep(index.bucket_sizes), scale=rep(index.scale),
        offset=rep(index.offset), hot_map=rep(index.hot_map), **store)
    return _with_host_views(placed, mesh, _CAP_SHARDED_NAMES)


def _place_hnsw(index: HNSWIndex, mesh: SearchMesh) -> PlacedHNSWIndex:
    devices = shard_devices(mesh)
    lead = devices[0]
    rows = {name: tuple(_blocks(getattr(index, name), 0, devices, value))
            for name, value in _ROW_SHARDED_NAMES.items()}
    rids = index.route_ids.long()

    def rep(t):
        return None if t is None else t.to(lead)
    placed = PlacedHNSWIndex(
        mesh=mesh, entry=rep(index.entry), route_ids=rep(index.route_ids),
        route_vecs=rep(index.vectors[rids].float()),
        route_sqnorm=rep(index.sqnorm[rids]), scale=rep(index.scale),
        offset=rep(index.offset), **rows)
    return _with_host_views(placed, mesh, _ROW_SHARDED_NAMES)


def place_index(index, mesh: SearchMesh):
    """Place an index on ``mesh`` for the sharded search collectives
    (``dist.collectives``):

      * IVF (``make_sharded_probe_step``): every bucket's row block
        [cap, D] is padded on the cap dim to a multiple of S (vecs 0, ids
        -1, sqnorm +inf) and split into S contiguous [nlist, cap/S, .]
        tensors, shard s on ``mesh.devices[s]``, so each shard scans its
        slice of every probed bucket and only [B, k] candidate lists
        cross shards. ``centroids``, ``bucket_sizes``, the SQ8 tables and
        ``hot_map`` are copied to the lead device.
      * HNSW (``make_sharded_beam_step``): vectors [N, D], sqnorm [N] and
        neighbors [N, M] are padded on the node dim (vecs 0, sqnorm +inf,
        neighbor ids -1) and split into S contiguous row blocks, so each
        shard owns rows ``[s * N_pad/S, (s + 1) * N_pad/S)`` and only
        [B, M] frontiers cross shards a step. The entry, the routing
        sample (its ids, and its f32 vectors and sqnorm gathered once
        here) and the SQ8 tables go to the lead device. An SQ8 graph
        (int8 vectors) is placed by the same rules.
      * A mutable view (``mutate.MutableIndexView``): the base is placed
        by the rules above; the delta ring stays whole on the lead
        device (the reference replicates it, so the delta scan needs no
        cross-shard step). Tombstones need nothing of their own: they
        live in the base arrays as pad slots and travel with them.

    On a 1-shard mesh the store is the index's own (padded only if
    needed). On a serve mesh the index stays global (module docstring):
    the placement carries each host group's view (``host_index``)."""
    if _is_view(index):
        return dataclasses.replace(
            index, base=place_index(index.base, mesh),
            delta=_to(index.delta, shard_devices(mesh)[0]))
    if isinstance(index, IVFIndex):
        return _place_ivf(index, mesh)
    if isinstance(index, HNSWIndex):
        return _place_hnsw(index, mesh)
    raise TypeError(f"place_index takes an IVFIndex, an HNSWIndex or a "
                    f"mutable view of either, got {type(index).__name__}")


def refresh_placed_view(view, mesh: SearchMesh, *, base=None,
                        delta=None):
    """Re-place ONLY the changed component of a placed mutable view.

    ``base`` (when given, an UNPLACED index) is placed by the
    ``place_index`` rules; ``delta`` (when given) goes whole to the lead
    device. A component passed as None keeps its placement untouched,
    so a delta write moves only the ring. The launcher's online
    compaction pushes the result as a contents-only engine swap."""
    if not _is_view(view):
        raise TypeError(f"refresh_placed_view needs a MutableIndexView, "
                        f"got {type(view).__name__}")
    return dataclasses.replace(
        view, base=view.base if base is None else place_index(base, mesh),
        delta=(view.delta if delta is None
               else _to(delta, shard_devices(mesh)[0])))


def host_index(index, h: int):
    """Host group h's view of an index placed on a serve mesh: its shards
    on ``mesh.devices[h * S:(h + 1) * S]`` and its small tables (and a
    mutable view's delta ring) on that group's lead device. Host group 0
    of a placement without host views is the placement itself."""
    if _is_view(index):
        base = host_index(index.base, h)
        return dataclasses.replace(index, base=base,
                                   delta=_to(index.delta, base.device))
    views = getattr(index, "host_views", ())
    if views:
        return views[h]
    if h:
        raise ValueError(f"host group {h}: the index was not placed on a "
                         f"serve mesh with that many host groups")
    return index


def slot_sharding(mesh: Optional[SearchMesh], num_slots: int
                  ) -> Tuple[slice, ...]:
    """Which slot rows each host group owns: contiguous slices of B/H
    rows over the ``"hosts"`` axis. Falls back to one slice of every
    slot (the reference's replication) when the mesh has no hosts axis
    or H does not divide num_slots."""
    hosts = 1 if mesh is None else mesh.num_hosts
    if hosts <= 1 or num_slots % hosts:
        return (slice(0, num_slots),)
    m = num_slots // hosts
    return tuple(slice(h * m, (h + 1) * m) for h in range(hosts))


def constrain_slots(tree, mesh: SearchMesh, num_slots: int) -> List[Any]:
    """Split a tree of per-slot tensors (a tensor, a tuple or a dataclass
    of them) by ``slot_sharding``: one tree per host group, each leaf
    whose leading dim is num_slots cut to the group's rows and moved to
    the group's lead device; other leaves are kept. Without a usable
    hosts axis this is one tree on the lead device."""
    groups = slot_sharding(mesh, num_slots)
    leads = ([mesh.lead] if len(groups) == 1
             else [sub.lead for sub in mesh.host_meshes()])

    def cut(x, sl, dev):
        if isinstance(x, torch.Tensor):
            if x.ndim >= 1 and x.shape[0] == num_slots:
                return x[sl].to(dev)
            return x
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: cut(getattr(x, f.name), sl, dev)
                for f in dataclasses.fields(x)})
        if isinstance(x, tuple):
            return tuple(cut(v, sl, dev) for v in x)
        return x
    return [cut(tree, sl, dev) for sl, dev in zip(groups, leads)]


# ---------------------------------------------------------------------------
# LM placement: specs for parameters, optimizer state, batches and caches
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]


class NamedSharding(NamedTuple):
    """A (mesh, spec) pair: where one leaf lives (the counterpart of
    ``jax.sharding.NamedSharding``). ``placements(mesh, spec)`` gives its
    DTensor placements on a ``DeviceMesh``."""
    mesh: Any
    spec: Spec


# Row-parallel (output) projections: the first of the trailing two dims
# is the contracted one.
_OUT_PROJ_NAMES = frozenset({"wo", "out_proj", "cv"})

# Always replicated whatever the shape: per-channel gains, SSM / RWKV
# per-head scalars, depthwise conv stencils, the router's table.
_REPLICATED_NAMES = frozenset({
    "scale", "ln_x_scale", "norm_scale", "w0", "dt_bias", "a_log",
    "d_skip", "bonus_u", "conv_w", "router",
})

_KV_CACHE_NAMES = frozenset({"k", "v", "ck", "cv", "shared_k", "shared_v"})


def _resolve_logical(mesh, logical) -> Optional[Tuple[str, ...]]:
    """A logical axis name (or a tuple of mesh axis names) -> the tuple
    of mesh axes present on this mesh, or None."""
    names = meshctx.axis_names(mesh)
    if logical is None:
        return None
    if isinstance(logical, (tuple, list)):
        axes = tuple(a for a in logical if a in names)
        return axes or None
    if logical == "dp":
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes or None
    if logical == "tp":
        return ("model",) if "model" in names else None
    # "hosts" (the serve mesh) and any concrete axis name resolve to
    # themselves when the mesh has them.
    return (logical,) if logical in names else None


def spec_for(mesh, shape: Sequence[int],
             logical: Sequence[Any]) -> Spec:
    """Divisibility-checked spec from per-dim logical axes: an entry
    keeps its axes iff their product is > 1 and divides the dim."""
    entries = []
    for dim, ax in zip(shape, logical):
        axes = _resolve_logical(mesh, ax)
        if axes is None:
            entries.append(None)
            continue
        size = 1
        for a in axes:
            size *= meshctx.axis_size(mesh, a)
        if size > 1 and dim % size == 0:
            entries.append(axes[0] if len(axes) == 1 else axes)
        else:
            entries.append(None)
    return tuple(entries)


def replicated(mesh) -> NamedSharding:
    """Fully replicated (the empty spec)."""
    return NamedSharding(mesh, ())


def _param_logical(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes of one parameter leaf, by its name and rank."""
    if ndim < 2 or name in _REPLICATED_NAMES or name.startswith("mu_"):
        return (None,) * ndim
    trailing = ("tp", "dp") if name in _OUT_PROJ_NAMES else ("dp", "tp")
    return (None,) * (ndim - 2) + trailing


def param_spec(name: str, shape: Sequence[int], mesh) -> Spec:
    """The spec of one named parameter (``_param_logical``)."""
    return spec_for(mesh, shape, _param_logical(name, len(shape)))


def _map_named(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a tree of nested dicts, ``name`` the leaf's
    own key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    return fn(name, tree)


def param_shardings(tree, mesh):
    """A ``NamedSharding`` per leaf of ``tree`` (tensors, meta tensors or
    anything with a ``shape``), by ``param_spec``."""
    return _map_named(lambda name, leaf: NamedSharding(
        mesh, param_spec(name, tuple(leaf.shape), mesh)), tree)


def _padded_spec(sharding: NamedSharding, ndim: int) -> Spec:
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _factored_shardings(p_sharding: NamedSharding, state_leaf: dict,
                        mesh) -> dict:
    """Shardings of one Adafactor per-leaf dict ({v_row, v_col, m} for a
    factored leaf, {v, m} otherwise), derived from the parameter's spec
    so the moments stay with their parameter's shards: v_row / v_col
    drop one reduced dim each, and that dim's entry."""
    out = {}
    for key, arr in state_leaf.items():
        spec = _padded_spec(p_sharding, arr.ndim + 1)   # the param's rank
        if key == "v_row":      # param [.., R, C] -> [.., R]
            out[key] = NamedSharding(mesh, spec[:-1])
        elif key == "v_col":    # param [.., R, C] -> [.., C]
            out[key] = NamedSharding(mesh, spec[:-2] + spec[-1:])
        else:                   # "m", "v": the parameter's shape
            out[key] = p_sharding
    return out


def _map_up_to(fn, structure, tree):
    """``fn(s, t)`` at each leaf ``s`` of ``structure`` with the subtree
    ``t`` at the same place in ``tree``."""
    if isinstance(structure, dict):
        return {k: _map_up_to(fn, v, tree[k]) for k, v in structure.items()}
    return fn(structure, tree)


def opt_shardings(opt_state: dict, params, mesh) -> dict:
    """Shardings of an optimizer state, leaf for leaf with
    ``param_shardings(params, mesh)``: AdamW's {"m", "v", "step"},
    Adafactor's {"leaves": per parameter {v_row, v_col, m} or {v, m},
    "step"}, and the error-feedback buffer "ef" (the parameters'
    structure); "step" and any other bookkeeping replicate."""
    p_sh = param_shardings(params, mesh)
    rep = replicated(mesh)
    out = {}
    for key, sub in opt_state.items():
        if key == "leaves":
            out[key] = _map_up_to(
                lambda s, d: _factored_shardings(s, d, mesh), p_sh, sub)
        elif key in ("m", "v", "ef"):
            out[key] = _map_up_to(lambda s, _: s, p_sh, sub)
        else:
            out[key] = _map_named(lambda _n, _l: rep, sub)
    return out


def batch_shardings(batch, mesh, kind: str = "train"):
    """Input batches split their leading (global batch) dim over dp; the
    other dims replicate (sequence sharding is an activation matter,
    meshctx's "sp"). ``kind`` train / prefill / decode share the rule;
    "serve" splits the slot dim over the "hosts" axis only."""
    lead = "hosts" if kind == "serve" else "dp"
    return _map_named(lambda _n, x: NamedSharding(mesh, spec_for(
        mesh, tuple(x.shape), (lead,) + (None,) * (len(x.shape) - 1))),
        batch)


def cache_shardings(cache, mesh):
    """Decode caches: the batch dim over dp, the kv-head dim of attention
    caches over tp. The batch dim sits past the stacked layer axes: at 2
    under the hybrid "groups" subtree ([n_groups, group, batch, ..]), at
    1 everywhere else."""
    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        ndim = len(tree.shape)
        bdim = 2 if "groups" in keys[:-1] else 1
        logical = [None] * ndim
        if ndim > bdim:
            logical[bdim] = "dp"
        if keys and keys[-1] in _KV_CACHE_NAMES and ndim >= 5:
            logical[-2] = "tp"
        return NamedSharding(mesh, spec_for(mesh, tuple(tree.shape),
                                            logical))
    return walk(cache, ())


def placements(mesh, spec: Sequence[Any]) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim i is
    ``Shard(d)`` where spec entry d names it, ``Replicate()`` otherwise.
    Several mesh axes on one tensor dim split it major to minor in the
    mesh's own order (the only order plain ``Shard`` placements can
    express; another order raises)."""
    from torch.distributed.tensor import Replicate, Shard
    names = meshctx.axis_names(mesh)
    where = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of the "
                             f"mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"mesh axis {a!r} shards dims {where[a]} "
                                 f"and {dim} of spec {tuple(spec)}")
            where[a] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def gather(tree):
    """Each DTensor of a tree of nested dicts as the whole tensor
    (``full_tensor()``: a collective in a world of several ranks; on a
    replicated one-rank mesh the local tensor itself); other leaves
    kept."""
    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    return _map_named(lambda _n, t: whole(t), tree)


def distribute(tree, shardings):
    """Each tensor of ``tree`` placed by the ``NamedSharding`` at its
    place in ``shardings`` (``distribute_tensor``: a DTensor whose shards
    are cut from the whole tensor)."""
    from torch.distributed.tensor import distribute_tensor
    return _map_up_to(lambda sh, t: distribute_tensor(
        t, sh.mesh, placements(sh.mesh, _padded_spec(sh, t.ndim))),
        shardings, tree)
