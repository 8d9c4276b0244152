"""Index placement on a search mesh (a port of the index part of
``repro.dist.sharding``): ``place_index`` for an IVF index and the row
padding of a flat database (``database_shards``).

The sharded dim (a bucket's cap, a database's rows) is padded up to a
multiple of the shard count first; padded slots keep the index's own
padding contract (vecs 0, ids -1, sqnorm +inf), so they never surface in
a top-k. Shard s holds the contiguous block ``[s * m, (s + 1) * m)`` of
the padded dim (m = padded / S), as its own contiguous tensor on
``mesh.devices[s]``, so shard order is row order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM
from repro_torch.index.ivf import IVFIndex
from repro_torch.launch.mesh import SHARD_AXIS, SearchMesh

# Bucket-store arrays whose cap dim (axis 1) is split across shards, with
# their pad values. bucket_sizes [nlist] is NOT here: it replicates, so
# the probe step's ndis counts true bucket populations.
_CAP_SHARDED_NAMES = {"bucket_vecs": 0, "bucket_ids": PAD_ID,
                      "bucket_sqnorm": PAD_SQNORM}


def shard_count(mesh: SearchMesh, axis: str = SHARD_AXIS) -> int:
    """Size of ``axis`` on ``mesh`` (1 when the mesh lacks the axis)."""
    return int(mesh.shape[axis]) if axis in mesh.axis_names else 1


def _shard_devices(mesh: SearchMesh) -> Tuple[torch.device, ...]:
    if tuple(mesh.axis_names) != (SHARD_AXIS,):
        raise NotImplementedError(
            f"placement on a mesh with axes {mesh.axis_names}: only the "
            f"1-D ('{SHARD_AXIS}',) search mesh is ported (a 'hosts' axis "
            f"is ROADMAP Queue 1 item 3, slice 3.4)")
    return mesh.devices


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
    return _blocks(x, 0, _shard_devices(mesh), value)


@dataclasses.dataclass
class PlacedIVFIndex:
    """An IVF index placed on a search mesh: each bucket's cap dim split
    over the shards, the small tables replicated on the lead device.

    Reads like an ``IVFIndex`` where the engine, ``Darth`` and the server
    read one (``device``, ``nlist``, ``cap``, ``dim``, ``num_vectors``,
    ``quantized``, ``hot_map``); the store itself is only reachable per
    shard, through ``dist.collectives.make_sharded_probe_step``."""
    mesh: SearchMesh
    centroids: torch.Tensor                  # f32[nlist, D], lead
    bucket_vecs: Tuple[torch.Tensor, ...]    # S x [nlist, cap/S, D]
    bucket_ids: Tuple[torch.Tensor, ...]     # S x i32[nlist, cap/S]
    bucket_sqnorm: Tuple[torch.Tensor, ...]  # S x f32[nlist, cap/S]
    bucket_sizes: torch.Tensor               # i32[nlist], lead
    scale: torch.Tensor                      # f32[D], lead
    offset: torch.Tensor                     # f32[D], lead
    hot_map: Optional[torch.Tensor] = None   # i32[nlist], lead

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


def place_index(index, mesh: SearchMesh) -> PlacedIVFIndex:
    """Place an IVF index on ``mesh`` for the sharded probe step: every
    bucket's row block [cap, D] is padded on the cap dim to a multiple of
    S (vecs 0, ids -1, sqnorm +inf) and split into S contiguous
    [nlist, cap/S, .] tensors, shard s on ``mesh.devices[s]``, so each
    shard scans its slice of every probed bucket and only [B, k]
    candidate lists cross shards. ``centroids``, ``bucket_sizes``, the
    SQ8 tables and ``hot_map`` are copied to the lead device. On a
    1-shard mesh the store is the index's own (padded only if needed).

    A mutable view (ROADMAP Queue 1 item 3, slice 3.4) and an HNSW graph
    (slice 3.3) are not ported yet and raise."""
    if not isinstance(index, IVFIndex):
        kind = type(index).__name__
        piece = ("3.4 (a mutable view under a mesh)"
                 if hasattr(index, "base") and hasattr(index, "delta")
                 else "3.3 (the sharded HNSW graph)"
                 if hasattr(index, "neighbors") else None)
        if piece is None:
            raise TypeError(f"place_index takes an IVFIndex, got {kind}")
        raise NotImplementedError(
            f"place_index({kind}): not ported yet, ROADMAP Queue 1 item 3, "
            f"slice {piece}")
    devices = _shard_devices(mesh)
    lead = mesh.lead
    store = {name: _blocks(getattr(index, name), 1, devices, value)
             for name, value in _CAP_SHARDED_NAMES.items()}

    def rep(t):
        return None if t is None else t.to(lead)
    return PlacedIVFIndex(
        mesh=mesh, centroids=rep(index.centroids),
        bucket_vecs=tuple(store["bucket_vecs"]),
        bucket_ids=tuple(store["bucket_ids"]),
        bucket_sqnorm=tuple(store["bucket_sqnorm"]),
        bucket_sizes=rep(index.bucket_sizes), scale=rep(index.scale),
        offset=rep(index.offset), hot_map=rep(index.hot_map))
