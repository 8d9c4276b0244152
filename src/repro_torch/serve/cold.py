"""Cold bucket tier: rarely-probed IVF buckets spill to host memory.

The third residency tier: the device bucket store holds only
``hot_slots`` bucket rows — the host keeps the canonical copy of EVERY
bucket's payload (CPU tensors), so the device store is a cache and
"eviction" is pure ``hot_map`` bookkeeping, never a device→host copy.
``IVFIndex.hot_map`` is the indirection ``index.ivf.probe_step`` resolves
bucket ids through: a probe whose bucket is not resident is SKIPPED — the
probe cursor advances, the scan contributes no candidates, ndis stays
honest — so a cold hit never stalls the chunk.

``ColdTier.on_boundary`` is the prefetcher, shaped for
``DarthServer.serve(.., on_boundary=tier.on_boundary)``: at every chunk
boundary it reads the in-flight pool state (``server.chunk_state``),
walks each active slot's REMAINING probe order ``lookahead`` probes
ahead, stages the demanded cold buckets into the least-demanded device
slots and retargets the pool with ``set_engine(contents_only=True)``.
With ``lookahead >= steps_per_sync`` a bucket demanded by the NEXT chunk
is staged one boundary ahead of its probe turn; buckets that still slip
through skip (``darth_cold_miss_total``) rather than block.

Staging writes IN PLACE into the device store, which the tier owns
(``split_index`` and ``plan`` allocate it; nothing else holds its
tensors), where the reference's functional ``.at[slot].set`` builds a
new store. A functional update in eager PyTorch would clone the whole
store (0.78 GB at 256 slots of the 1M-row cell) for every staged
bucket; the in-place copy moves one bucket's payload. It is safe
because every write is queued on the stream the chunks run on, after
the previous chunk's reads, and the hook runs at a boundary the host
has already synchronised on. The engine is still retargeted
(contents-only, with the new ``hot_map``), so the server's protocol is
the reference's. One consequence: an engine built on an earlier view of
this store sees the staged payloads under its own, older ``hot_map``;
after a serve with the prefetcher, search through ``tier.store`` (or the
server's retargeted engine). Each boundary's staging time (host to
device, the stream synchronised before the clock stops) is kept in
``stage_seconds``.

Under a mesh the device store is a ``dist.PlacedIVFIndex``: each bucket
slot's cap rows are split over S shards (``dist.place_index``). The
tier learns the placement from the store it is given (``ColdTier(index,
placed_store)``, or ``tier.store = dist.place_index(tier.store, mesh)``)
or, at the first boundary, from the index the server serves (bare, or
as a mutable view's base). From then on it keeps its host copy padded to
the placed cap (vecs 0, ids ``PAD_ID``, sqnorm ``PAD_SQNORM``, the
placement's own pad), so staging bucket ``bk`` into slot ``sl`` writes
rows ``[j * cap/S, (j + 1) * cap/S)`` of the host payload into slot
``sl`` of shard j: S slice copies per array, no device-to-host copy, no
re-placement. On a serve mesh every host group's view
(``dist.sharding.host_index``) is refreshed; groups that share a device
share its tensors, so each distinct tensor is written once. ``hot_map``
lives on each view's lead device. ``plan`` returns a store placed on the
same mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM
from repro_torch.dist.sharding import PlacedIVFIndex, place_index
from repro_torch.index import ivf as ivf_lib

_STORE = ("bucket_vecs", "bucket_ids", "bucket_sqnorm")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _num_slots(store) -> int:
    vecs = store.bucket_vecs
    return (vecs[0] if isinstance(store, PlacedIVFIndex) else vecs).shape[0]


def split_index(index: ivf_lib.IVFIndex, hot_buckets: np.ndarray
                ) -> ivf_lib.IVFIndex:
    """Device view holding only ``hot_buckets``' payload rows.

    ``hot_buckets`` (i32[nslots], unique bucket ids) occupy slots
    0..nslots-1 in build order; every other bucket maps to -1 in
    ``hot_map``. Centroids and ``bucket_sizes`` stay full [nlist] —
    probe ranking and the ndis accounting are residency-independent.
    The payload rows are gathered on the index's device into new
    tensors.
    """
    hot = np.asarray(hot_buckets, np.int32).reshape(-1)
    if hot.size != np.unique(hot).size:
        raise ValueError("hot_buckets must be unique bucket ids")
    hot_map = np.full((index.nlist,), -1, np.int32)
    hot_map[hot] = np.arange(hot.size, dtype=np.int32)
    sel = torch.as_tensor(hot, device=index.device).long()
    return dataclasses.replace(
        index, bucket_vecs=index.bucket_vecs[sel],
        bucket_ids=index.bucket_ids[sel],
        bucket_sqnorm=index.bucket_sqnorm[sel],
        hot_map=torch.as_tensor(hot_map, device=index.device))


class ColdTier:
    """Host-canonical bucket store + device-slot cache manager.

    Build with :func:`make_cold_tier` (which picks the initial resident
    set and produces the device store), keep the returned ``tier``
    alive for the serve's duration, and pass ``tier.on_boundary`` to
    ``DarthServer.serve``. The tier owns the authoritative ``hot_map``;
    the server's engine index is refreshed (contents-only: slot count
    and shapes never change).
    """

    def __init__(self, index: ivf_lib.IVFIndex, store: ivf_lib.IVFIndex,
                 *, lookahead: int = 4, staging: int = 8,
                 metrics=None) -> None:
        self.host_vecs = index.bucket_vecs.cpu()
        self.host_ids = index.bucket_ids.cpu()
        self.host_sqn = index.bucket_sqnorm.cpu()
        self.store = store
        hot_map = _host(store.hot_map)
        self.hot_map = hot_map.copy()
        nslots = _num_slots(store)
        self.slot_bucket = np.full((nslots,), -1, np.int32)
        resident = np.where(hot_map >= 0)[0]
        self.slot_bucket[hot_map[resident]] = resident
        self.lookahead = int(lookahead)
        # Only the trailing `staging` slots are evictable. The seeded
        # set stays PINNED: the boundary hook sees demand from the
        # in-flight slots only, and queries admitted at the very next
        # refill are invisible to it — evicting "undemanded" pinned
        # buckets would strip exactly what the next admission wave's
        # first probes need (the window the plan()/popularity seed
        # exists to cover).
        self.pinned = np.zeros((nslots,), bool)
        self.pinned[:max(nslots - int(staging), 0)] = True
        self.metrics = metrics
        self.prefetches = 0
        self.evictions = 0
        self.misses = 0
        self.stage_seconds: List[float] = []

    @property
    def store(self):
        """The device store: an ``IVFIndex``, or a ``PlacedIVFIndex``
        when the tier serves under a mesh."""
        return self._store

    @store.setter
    def store(self, store) -> None:
        if isinstance(store, PlacedIVFIndex):
            self._pad_host(store.cap)
        self._store = store

    def _pad_host(self, cap: int) -> None:
        """Pad the host copy's cap dim to a placement's padded ``cap``
        with the placement's pad (once; a no-op when it is as long)."""
        extra = cap - self.host_vecs.shape[1]
        if extra <= 0:
            return
        nlist, _, dim = self.host_vecs.shape
        self.host_vecs = torch.cat(
            [self.host_vecs, self.host_vecs.new_zeros((nlist, extra, dim))],
            1)
        self.host_ids = torch.cat(
            [self.host_ids, self.host_ids.new_full((nlist, extra), PAD_ID)],
            1)
        self.host_sqn = torch.cat(
            [self.host_sqn,
             self.host_sqn.new_full((nlist, extra), PAD_SQNORM)], 1)

    # -- demand planning ----------------------------------------------

    def plan(self, queries: np.ndarray, *, nprobe: int,
             first: int = 4) -> ivf_lib.IVFIndex:
        """Re-seed the resident set from a known query workload.

        The boundary prefetcher covers every probe a query makes AFTER
        its first chunk (by then the slot's probe order is visible and
        lookahead stages ahead of the cursor), but a query's FIRST
        ``steps_per_sync`` probes run before any boundary has seen it —
        a cold bucket there is skipped for good. When the workload is
        known up front (the batch serve API), ranking every query's
        centroids and seeding residency by early-probe demand closes
        exactly that window: buckets scored by how many queries want
        them within their first ``first`` probes (earlier probes weigh
        more). Returns the new device store (new tensors), placed on the
        current store's mesh when it is placed; build the serving engine
        from it."""
        dev = self.store.device
        q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        qsq = (q * q).sum(1, keepdim=True)
        order, _ = ivf_lib.rank_centroids(self.store.centroids, q, qsq,
                                          min(nprobe, self.store.nlist))
        order = _host(order)
        score = np.zeros((self.store.nlist,), np.float64)
        depth = min(first, order.shape[1])
        for j in range(depth):
            np.add.at(score, order[:, j], float(depth - j))
        # Tail tie-break: keep the populated-bucket prior for slots the
        # workload's early probes leave unclaimed.
        sizes = _host(self.store.bucket_sizes)
        score += sizes / max(float(sizes.sum()), 1.0)
        nslots = self.slot_bucket.size
        hot = np.argsort(-score, kind="stable")[:nslots].astype(np.int32)
        hot_map = np.full((self.store.nlist,), -1, np.int32)
        hot_map[hot] = np.arange(nslots, dtype=np.int32)
        self.hot_map = hot_map
        self.slot_bucket = hot.copy()
        sel = torch.as_tensor(hot).long()
        if isinstance(self.store, PlacedIVFIndex):
            # The host rows, already padded to the placed cap, go to their
            # shards by the placement's own rules (one copy per block).
            placed = self.store
            self.store = place_index(ivf_lib.IVFIndex(
                centroids=placed.centroids,
                bucket_vecs=self.host_vecs[sel],
                bucket_ids=self.host_ids[sel],
                bucket_sqnorm=self.host_sqn[sel],
                bucket_sizes=placed.bucket_sizes, scale=placed.scale,
                offset=placed.offset, hot_map=torch.as_tensor(hot_map)),
                placed.mesh)
            return self.store
        self.store = dataclasses.replace(
            self.store,
            bucket_vecs=self.host_vecs[sel].to(dev),
            bucket_ids=self.host_ids[sel].to(dev),
            bucket_sqnorm=self.host_sqn[sel].to(dev),
            hot_map=torch.as_tensor(hot_map, device=dev))
        return self.store

    def _demand(self, server) -> Optional[Dict[int, int]]:
        """bucket id -> probes-until-needed (min over active slots),
        from the server's boundary-exposed pool state; None when no
        probe bookkeeping is in flight (between serves / right after a
        swap / non-IVF engine)."""
        s = server.chunk_state
        while s is not None and not hasattr(s, "probe_order"):
            s = getattr(s, "inner", None)
        if s is None:
            return None
        order = _host(s.probe_order)
        pos = _host(s.probe_pos)
        active = _host(s.active)
        nprobe = order.shape[1]
        want: Dict[int, int] = {}
        for row in np.where(active)[0]:
            lo = int(pos[row])
            ahead = order[row, lo:min(lo + self.lookahead, nprobe)]
            for j, bk in enumerate(np.asarray(ahead, np.int64)):
                bk = int(bk)
                if bk >= 0 and want.get(bk, self.lookahead + 1) > j:
                    want[bk] = j
        return want

    # -- the boundary hook --------------------------------------------

    def on_boundary(self, server) -> None:
        """Stage upcoming cold buckets; evict slots nothing will probe."""
        self._adopt(server)
        want = self._demand(server)
        if not want:
            return
        missing = sorted(
            (bk for bk in want if self.hot_map[bk] < 0),
            key=want.get)
        if not missing:
            return
        # A demanded-but-cold bucket closer than the chunk length will
        # be probed before the staged copy can matter: an honest miss.
        near = sum(1 for bk in missing
                   if want[bk] < getattr(server, "steps_per_sync", 1))
        # Victims: unpinned (staging-ring) slots whose bucket no active
        # slot will probe inside the lookahead window.
        victims = [sl for sl in range(self.slot_bucket.size)
                   if not self.pinned[sl]
                   and int(self.slot_bucket[sl]) not in want]
        loads = list(zip(missing, victims))
        if not loads:
            self._count(near, 0, 0)
            return
        t0 = time.perf_counter()
        targets = self._targets()
        host = {"bucket_vecs": self.host_vecs, "bucket_ids": self.host_ids,
                "bucket_sqnorm": self.host_sqn}
        evicted = 0
        for bk, sl in loads:
            old = int(self.slot_bucket[sl])
            if old >= 0:
                self.hot_map[old] = -1
                evicted += 1
            # Host payload is canonical — staging is device-write only.
            for name, t, lo, hi in targets:
                t[sl].copy_(host[name][bk, lo:hi])
            self.hot_map[bk] = sl
            self.slot_bucket[sl] = bk
        for dev in {t.device for _, t, _, _ in targets}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.stage_seconds.append(time.perf_counter() - t0)
        self.store = self._with_hot_map(self.store)
        self._retarget(server)
        self._count(near, len(loads), evicted)

    def _adopt(self, server) -> None:
        """Take the placement the server serves (bare, or a mutable
        view's base) as the tier's store, when the caller placed the
        store after building the tier."""
        idx = server.engine.index
        idx = getattr(idx, "base", idx)
        if (isinstance(idx, PlacedIVFIndex) and idx is not self.store
                and idx.hot_map is not None
                and idx.nlist == self.store.nlist
                and _num_slots(idx) == self.slot_bucket.size):
            self.store = idx

    def _targets(self):
        """(array name, device tensor, lo, hi): every distinct store
        tensor staging writes, with the host cap rows it receives."""
        st = self.store
        if not isinstance(st, PlacedIVFIndex):
            return [(name, getattr(st, name), 0, st.cap) for name in _STORE]
        out, seen = [], set()
        for view in (st,) + tuple(st.host_views):
            for name in _STORE:
                lo = 0
                for t in getattr(view, name):
                    key = (t.device, t.data_ptr())
                    if key not in seen:
                        seen.add(key)
                        out.append((name, t, lo, lo + t.shape[1]))
                    lo += t.shape[1]
        return out

    def _with_hot_map(self, store):
        """``store`` (and each host view) around the tier's current
        ``hot_map``, one copy on each distinct lead device."""
        maps = {}

        def on(dev):
            if dev not in maps:
                maps[dev] = torch.as_tensor(self.hot_map, device=dev)
            return maps[dev]
        kw = {"hot_map": on(store.device)}
        if getattr(store, "host_views", ()):
            kw["host_views"] = tuple(
                dataclasses.replace(v, hot_map=on(v.device))
                for v in store.host_views)
        return dataclasses.replace(store, **kw)

    def _retarget(self, server) -> None:
        """Contents-only engine refresh around the new store view."""
        engine = server.engine
        idx = engine.index
        if hasattr(idx, "base"):      # MutableIndexView: swap the base
            idx = dataclasses.replace(idx, base=self.store)
        else:
            idx = self.store
        server.set_engine(engine._replace(index=idx), contents_only=True)

    def _count(self, near: int, staged: int, evicted: int) -> None:
        self.misses += near
        self.prefetches += staged
        self.evictions += evicted
        if self.metrics is None:
            return
        if near:
            self.metrics.counter("darth_cold_miss_total").inc(near)
        if staged:
            self.metrics.counter("darth_cold_prefetch_total").inc(staged)
        if evicted:
            self.metrics.counter("darth_cold_evictions_total").inc(evicted)


def make_cold_tier(index: ivf_lib.IVFIndex, *, hot_slots: int,
                   lookahead: int = 4, staging: int = 8,
                   metrics=None) -> ColdTier:
    """Split ``index`` into a ``hot_slots``-bucket device store plus a
    host cold tier, initially keeping the most populated buckets
    resident (population is the best probe-popularity prior available
    at split time; ``plan`` sharpens the seed from a known workload and
    the boundary prefetcher's ``staging``-slot ring tracks live demand).
    """
    if not 0 < hot_slots <= index.nlist:
        raise ValueError(
            f"hot_slots must be in (0, nlist={index.nlist}], "
            f"got {hot_slots}")
    sizes = _host(index.bucket_sizes)
    hot = np.argsort(-sizes, kind="stable")[:hot_slots].astype(np.int32)
    store = split_index(index, hot)
    return ColdTier(index, store, lookahead=lookahead,
                    staging=min(staging, hot_slots), metrics=metrics)


__all__ = ["ColdTier", "make_cold_tier", "split_index"]
