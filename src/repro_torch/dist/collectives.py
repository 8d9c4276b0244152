"""Cross-shard search collectives (a port of ``repro.dist.collectives``).

The reference runs each of these as one ``shard_map`` program over a
mesh; the port runs one controller that launches each shard's kernel on
its own device in turn, then brings the per-shard candidates to the lead
device and merges them. Only [B, k] candidate lists cross shards, as in
the reference, whatever N and cap are.

  * ``merge_topk``: the candidate merge (also the mutable engine's fold
    of the delta ring's top-k into the base engine's).
  * ``make_sharded_flat_search`` / ``sharded_flat_search``: exact flat
    k-NN over a row-sharded [N, D] database; each shard runs the fused
    ``l2_topk`` kernel on its rows (the reference's call site
    ``dist/collectives.py:104``).
  * ``make_sharded_ivf_init`` and ``make_sharded_probe_step``: the IVF
    search over a cap-sharded bucket store (``dist.place_index``); each
    shard scans its slice of every probed bucket with the fused
    ``bucket_probe`` kernel (the reference's call site ``:323``).

Both searches equal their single-device versions (``flat.search``,
``ivf.probe_step``) on any shard count: shard order is row (cap) order,
each shard's list is in (distance, row) order, and the merge is a stable
sort, so ties resolve to the lower row as they do on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM, pad_dists, pad_ids
from repro_torch.dist.sharding import (PlacedIVFIndex, database_shards,
                                       shard_count)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import SearchMesh


def merge_topk(cand_d: torch.Tensor, cand_i: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge [B, M] candidate (dist, id) lists to the best k per row,
    ascending, the lower column first on a tie (``lax.top_k``'s order:
    a stable sort, never a bare ``torch.topk``). +inf candidates (pads,
    tombstones) are masked back to id -1."""
    d, pos = torch.sort(cand_d, dim=1, stable=True)
    d = d[:, :k]
    i = torch.gather(cand_i, 1, pos[:, :k])
    return d, torch.where(torch.isfinite(d), i, PAD_ID)


def make_sharded_flat_search(mesh: SearchMesh, k: int, chunk: int = 1024
                             ) -> Callable[..., Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Exact flat k-NN over a database row-sharded on the mesh.

    Returns fn(q [B, D], x [N, D]) -> (dist [B, k] ascending, i32 idx
    [B, k]) on the lead device, equal to ``index.flat.search`` on any
    shard count. The squared norms are computed once over the whole x (as
    ``flat.search`` computes them), then padded (+inf) and split with the
    rows, so each shard sees the bits ``flat.search`` sees. Queries go in
    chunks of ``chunk`` rows, as in ``flat.search``."""
    def search(q, x) -> Tuple[torch.Tensor, torch.Tensor]:
        lead = mesh.lead
        q = torch.as_tensor(q, device=lead)
        x = torch.as_tensor(x, device=lead)
        xsq = (x.float() ** 2).sum(1)
        xs = database_shards(x, mesh)
        sqs = database_shards(xsq, mesh, PAD_SQNORM)
        rows = xs[0].shape[0]
        outs = []
        for lo in range(0, q.shape[0], chunk):
            qc = q[lo:lo + chunk]
            cand_d, cand_i = [], []
            for s, dev in enumerate(mesh.devices):
                d, i = ops.l2_topk(qc.to(dev), xs[s], k=k, x_sqnorm=sqs[s])
                i = torch.where(torch.isfinite(d) & (i >= 0), i + s * rows,
                                PAD_ID)
                cand_d.append(d.to(lead))
                cand_i.append(i.to(lead))
            outs.append(merge_topk(torch.cat(cand_d, 1),
                                   torch.cat(cand_i, 1), k))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    return search


def sharded_flat_search(q, x, k: int, mesh: SearchMesh
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot form of ``make_sharded_flat_search(mesh, k)(q, x)``."""
    return make_sharded_flat_search(mesh, k)(q, x)


def make_sharded_ivf_init(mesh: SearchMesh) -> Callable[..., Any]:
    """IVF search-state init over a placed index. Without a hosts axis
    (the only mesh ported) the reference's sharded init is
    ``ivf.init_state`` itself: the centroids and the state live on the
    lead device."""
    from repro_torch.index import ivf as ivf_lib

    def init(index: PlacedIVFIndex, q: torch.Tensor, *, k: int,
             nprobe: int):
        return ivf_lib.init_state(index, q.to(index.device), k=k,
                                  nprobe=nprobe)
    return init


def make_sharded_probe_step(mesh: SearchMesh) -> Callable[[Any, Any], Any]:
    """One IVF probe step over a cap-sharded bucket store.

    Returns step(index, state) -> state, the drop-in for
    ``index.ivf.probe_step`` when ``index`` was placed with
    ``dist.place_index(index, mesh)``. Each shard scans its slice of the
    probed bucket with ``ops.bucket_probe_slots`` (read by slot from its
    local store, with an empty running list and the incoming k-th
    distance); the candidates are merged in the order [running, shard 0,
    ..., shard S-1]. Insert counts are summed over the shards BEFORE the
    clamp at k, and ndis counts the replicated full bucket sizes, so
    every counter equals the single-device step's. With a cold tier
    (``hot_map``), a cold bucket is skipped as the single-device step
    skips it. The step adds no device-to-host sync."""
    nshards = shard_count(mesh)

    def probe_step(index: PlacedIVFIndex, s):
        if not isinstance(index, PlacedIVFIndex) or index.mesh != mesh:
            raise ValueError(
                "the sharded probe step needs the index placed on its mesh: "
                "dist.place_index(index, mesh)")
        lead = index.device
        b, k = s.topk_d.shape
        nprobe = s.probe_order.shape[1]
        pos = s.probe_pos.clamp_max(nprobe - 1)
        bucket = torch.gather(s.probe_order, 1, pos[:, None].long())[:, 0]
        sizes = index.bucket_sizes[bucket.long()]   # full per-bucket sizes
        if index.hot_map is not None:
            slot = index.hot_map[bucket.long()]
            scan = s.active & (slot >= 0)
            slot = slot.clamp_min(0)
        else:
            slot, scan = bucket, s.active
        if index.quantized:
            q_eff = s.q * index.scale[None, :]
            bias = s.qsq - 2.0 * (s.q @ index.offset)[:, None]
        else:
            q_eff, bias = s.q, s.qsq
        kth = s.topk_d[:, -1:]
        cand_d, cand_i = [s.topk_d], [s.topk_i]
        cnt = torch.zeros((b,), dtype=torch.int32, device=lead)
        for j in range(nshards):
            dev = index.bucket_vecs[j].device
            d, i, c = ops.bucket_probe_slots(
                q_eff.to(dev).contiguous(), index.bucket_vecs[j],
                index.bucket_sqnorm[j], index.bucket_ids[j],
                slot.to(dev).contiguous(), scan.to(dev),
                bias.to(dev).contiguous(), kth.to(dev).contiguous(),
                pad_dists((b, k), dev), pad_ids((b, k), dev))
            cand_d.append(d.to(lead))
            cand_i.append(torch.where(torch.isfinite(d), i, PAD_ID).to(lead))
            cnt = cnt + c.to(lead)
        new_d, new_i = merge_topk(torch.cat(cand_d, 1), torch.cat(cand_i, 1),
                                  k)
        inserts = cnt.clamp_max(k)
        zero = torch.zeros_like(sizes)
        done_probes = s.probe_pos + s.active.to(torch.int32)
        keep = s.active[:, None]
        return dataclasses.replace(
            s, probe_pos=done_probes,
            topk_d=torch.where(keep, new_d, s.topk_d),
            topk_i=torch.where(keep, new_i, s.topk_i),
            active=s.active & (done_probes < nprobe),
            ndis=s.ndis + torch.where(scan, sizes, zero),
            ninserts=s.ninserts + torch.where(scan, inserts, zero))

    return probe_step
