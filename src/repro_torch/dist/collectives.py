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
  * ``make_sharded_hnsw_init`` and ``make_sharded_beam_step``: the HNSW
    beam search over a row-sharded graph; each shard resolves the
    neighbours it owns, and only [B, M] frontiers cross shards.

Every search equals its single-device version (``flat.search``,
``ivf.probe_step``, ``hnsw.beam_step``) on any shard count: shard order
is row (cap) order, each shard's list is in (distance, row) order, and
the merge is a stable sort, so ties resolve to the lower row as they do
on one device.

A step made for a serve mesh (``("hosts", "model")``) takes the index
placed on that mesh or any host group's view of it
(``sharding.host_index``), and runs on that view's devices: the server
steps host group h's slots against host group h's view.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.padding import (PAD_DIST, PAD_ID, PAD_SQNORM,
                                      pad_dists, pad_ids)
from repro_torch.dist.sharding import (PlacedHNSWIndex, PlacedIVFIndex,
                                       shard_devices, database_shards,
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
    devices = shard_devices(mesh)

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
            for s, dev in enumerate(devices):
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


def _check_placed(index, mesh: SearchMesh, cls, what: str) -> None:
    """``index`` must be a ``cls`` placed on ``mesh`` or on one of its
    host groups' sub-meshes."""
    if (not isinstance(index, cls) or (index.mesh != mesh and index.mesh
                                       not in mesh.host_meshes())):
        raise ValueError(f"the sharded {what} needs the index placed on "
                         f"its mesh: dist.place_index(index, mesh)")


def make_sharded_ivf_init(mesh: SearchMesh) -> Callable[..., Any]:
    """IVF search-state init over a placed index: ``ivf.init_state``
    itself, on the lead device of the index's host group (the centroids
    and the state live there)."""
    from repro_torch.index import ivf as ivf_lib

    def init(index: PlacedIVFIndex, q: torch.Tensor, *, k: int,
             nprobe: int):
        _check_placed(index, mesh, PlacedIVFIndex, "IVF init")
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
        _check_placed(index, mesh, PlacedIVFIndex, "probe step")
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


def make_sharded_hnsw_init(mesh: SearchMesh) -> Callable[..., Any]:
    """HNSW search-state init over a placed graph: ``hnsw.init_state``'s
    routing scan over the routing sample that ``place_index`` gathered
    to the lead device, then the visited structure split on its node
    (bitmap) or slot (hashed filter) dim: a tuple of S column blocks,
    block s on shard s's device, with the entry marked in its owner's
    block. Returns init(index, q, *, ef, visited_width=0) -> state. A
    hashed width S does not divide raises (pick a power of two)."""
    from repro_torch.index import hnsw as hnsw_lib
    nshards = shard_count(mesh)

    def init(index: PlacedHNSWIndex, q: torch.Tensor, *, ef: int,
             visited_width: int = 0):
        _check_placed(index, mesh, PlacedHNSWIndex, "HNSW init")
        q = q.to(index.device)
        q_eff, qb, e, ed = hnsw_lib.route(index, q, index.route_vecs,
                                          index.route_sqnorm)
        width = index.num_vectors
        mark = e
        if visited_width:
            width = hnsw_lib.check_visited_width(visited_width, width)
            mark = hnsw_lib.hash_slot(e, width)
        if width % nshards:
            raise ValueError(
                f"visited width {width} not divisible by {nshards} shards; "
                f"pick a power-of-two visited_width that the shard count "
                f"divides")
        cols = width // nshards
        blocks = []
        for j, vec in enumerate(index.vectors):
            mk = mark.to(vec.device).long() - j * cols
            own = (mk >= 0) & (mk < cols)
            blk = torch.zeros((q.shape[0], cols), dtype=torch.bool,
                              device=vec.device)
            blk.view(torch.uint8).scatter_(
                1, mk.clamp(0, cols - 1)[:, None], own[:, None].to(
                    torch.uint8))
            blocks.append(blk)
        return hnsw_lib.start_state(q_eff, qb, e, ed, tuple(blocks), ef=ef,
                                    nroute=index.route_ids.shape[0])
    return init


def make_sharded_beam_step(mesh: SearchMesh) -> Callable[..., Any]:
    """One HNSW beam expansion over a row-sharded graph.

    Returns step(index, state, *, k) -> state, the drop-in for
    ``index.hnsw.beam_step`` when ``index`` was placed with
    ``dist.place_index(index, mesh)`` and the state came from
    ``make_sharded_hnsw_init``. Frontier selection and the merge are the
    single-device step's own code (``hnsw.select_expand`` and
    ``hnsw.merge_expand``, on the lead device), so the two steps cannot
    drift apart. The expansion moves:

      1. the shard that owns each query's selected node supplies its
         adjacency row: the [B, M] global neighbour ids;
      2. each shard resolves the neighbours it owns against its own
         visited block and rows, and masks the rest to +inf. It gathers
         [B, M, D] with its local row 0 in place of the neighbours it
         does not own, so its product has the shape of ``beam_step``'s
         ``bmm``, and its distances equal the single-device step's bit
         for bit;
      3. a positional min over the shards (each neighbour is finite on
         its one owner at most) restores the single-device [B, M]
         layout, so the ef top-k breaks ties exactly like ``beam_step``.

    With a hashed filter [B, W] (W < N_pad) membership lives at the hash
    slot's owner instead: it reads before it writes, as the
    single-device step does, so collisions skip the same nodes. Top-k,
    ndis, ninserts and nstep equal ``beam_step``'s on any shard count.
    The reference's ``pin_merge`` has no counterpart: the merge always
    runs on the lead device of the index's host group, which is what
    pinning buys there. The step adds no device-to-host sync."""
    from repro_torch.index import hnsw as hnsw_lib
    nshards = shard_count(mesh)

    def beam_step(index: PlacedHNSWIndex, s, *, k: int):
        _check_placed(index, mesh, PlacedHNSWIndex, "beam step")
        lead = index.device
        rows = index.rows
        blocks = s.visited if isinstance(s.visited, tuple) else ()
        width = sum(v.shape[1] for v in blocks)
        if len(blocks) != nshards or width % nshards:
            raise ValueError(
                f"the visited structure has {len(blocks)} blocks of "
                f"width {width} for {nshards} shards; start the search "
                f"with make_sharded_hnsw_init")
        hashed = width < index.num_vectors
        cols = width // nshards
        sel_id_safe, act, cand_exp = hnsw_lib.select_expand(s)

        # 1. the owner of each selected node supplies its adjacency row
        nbrs = pad_ids((s.cand_d.shape[0], index.degree), lead)
        for j, nbr_loc in enumerate(index.neighbors):
            sel = sel_id_safe.to(nbr_loc.device).long() - j * rows
            own = (sel >= 0) & (sel < rows)
            row = nbr_loc[sel.clamp(0, rows - 1)]
            nbrs = torch.where(own.to(lead)[:, None], row.to(lead), nbrs)
        valid = (nbrs >= 0) & act[:, None]
        nbrs_safe = nbrs.clamp_min(0).long()
        mark = hnsw_lib.hash_slot(nbrs_safe, width).long() if hashed \
            else nbrs_safe

        # 2. each shard: its visited block, then its owned distances
        seen = torch.zeros_like(valid)
        dist = None
        for j, vec_loc in enumerate(index.vectors):
            dev = vec_loc.device
            vd = valid.to(dev)
            mk = mark.to(dev) - j * cols
            own_mark = (mk >= 0) & (mk < cols)
            mloc = torch.where(own_mark, mk, 0)
            vis = s.visited[j]
            hit = vis.gather(1, mloc) & own_mark
            vis.view(torch.uint8).scatter_reduce_(
                1, mloc, (own_mark & vd).to(torch.uint8), "amax")
            seen = seen | hit.to(lead)
            nb = nbrs_safe.to(dev) - j * rows
            owned = vd & (nb >= 0) & (nb < rows)
            loc = torch.where(owned, nb, 0)
            vecs = vec_loc[loc].float()                       # [B, M, D]
            dots = torch.bmm(vecs, s.q.to(dev)[:, :, None])[:, :, 0]
            d = index.sqnorm[j][loc] - 2.0 * dots + s.qsq.to(dev)
            d = torch.where(owned, d, PAD_DIST).to(lead)
            # 3. positional min over the shards
            dist = d if dist is None else torch.minimum(dist, d)
        new = valid & ~seen
        dist = torch.where(new, torch.clamp_min(dist, 0.0), PAD_DIST)
        return hnsw_lib.merge_expand(s, cand_exp, act, nbrs, dist,
                                     s.visited, k=k)

    return beam_step
