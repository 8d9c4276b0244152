"""MutableIndex: host-side orchestrator for a streaming mutable index (a
port of ``repro.mutate.index``).

Wraps a built IVF or HNSW index with a delta ring (mutate.delta) and
tombstone bookkeeping, exposing insert / delete / compact plus a
``view()`` the mutable Engine carries as its ``.index``. Global ids are
assigned monotonically (base ids first, inserts continue from max(base
id) + 1) and never reused, so results, replay buffers and ground truth
stay comparable across mutations AND compactions. The ring and every
rebuilt base live on the base index's device.

Tombstones follow the repo-wide pad convention on the device — a deleted
slot keeps sqnorm +inf / ids -1, so it can never enter a top-k — while a
host-side set tracks which ids are dead for compaction and ground-truth
recomputation.

Snapshot isolation. The reference gets it from JAX's functional
updates; here every mutation builds NEW tensors (clones of the few
arrays it changes; ``bucket_vecs`` and ``vectors`` are shared, never
copied) and replaces ``self.base`` / ``self.delta``. A compaction job
holds the begin-time base, and a server may still hold an older view:
neither ever sees a write.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM
from repro_torch.index import hnsw as hnsw_lib
from repro_torch.index import ivf as ivf_lib
from repro_torch.mutate import compact as compact_lib
from repro_torch.mutate import delta as delta_lib
from repro_torch.mutate.engine import MutableIndexView


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _pad_idx(vals) -> np.ndarray:
    """Pad an index vector to a round length with -1 (the rows that every
    masking function below drops), as the reference pads its
    fixed-shape scatters."""
    vals = np.asarray(vals, np.int64).reshape(-1)
    out = np.full((_round_up(max(vals.size, 1), 64),), PAD_ID, np.int32)
    out[:vals.size] = vals
    return out


class CompactionJob:
    """One in-flight background compaction: a shadow base rebuilt
    incrementally off the serve path (the double-buffer's back buffer).

    ``deleted_since`` records ids deleted after begin so
    swap_compaction() can re-tombstone them in the finished shadow;
    ``folded_ids`` is the delta snapshot baked into the shadow — the swap
    frees exactly those ring slots, while inserts admitted mid-rebuild
    stay live in the ring (served from the delta until the next
    compaction)."""

    def __init__(self, gen, folded_ids: np.ndarray):
        self._gen = gen
        self.folded_ids = frozenset(
            int(i) for i in np.asarray(folded_ids).reshape(-1))
        self.deleted_since: set = set()
        self.ticks = 0
        self.done = False
        self.shadow: Any = None

    def tick(self) -> bool:
        """Run one bounded unit of rebuild work; returns True once the
        shadow is complete and ready for swap_compaction()."""
        if not self.done:
            try:
                next(self._gen)
                self.ticks += 1
            except StopIteration as stop:
                self.shadow = stop.value
                self.done = True
        return self.done


def _mask_ivf_slots(index: ivf_lib.IVFIndex, b_idx,
                    s_idx) -> ivf_lib.IVFIndex:
    """A new index with bucket slots tombstoned (ids -1 / sqnorm +inf)
    and the live-population counters decremented; padded entries
    (bucket -1) are dropped. A bucket named n times falls by n (a
    scatter-add, as ``.at[b].add(-1)``): ``probe_step`` advances ndis by
    these sizes. The given index is never written."""
    dev = index.device
    b = torch.as_tensor(b_idx, device=dev).long()
    s = torch.as_tensor(s_idx, device=dev).long()
    keep = (b >= 0) & (b < index.nlist)
    b, s = b[keep], s[keep]
    ids = index.bucket_ids.clone()
    sqn = index.bucket_sqnorm.clone()
    ids[b, s] = PAD_ID
    sqn[b, s] = PAD_SQNORM
    # -1 per tombstoned slot is a decrement count, not a pad
    sizes = index.bucket_sizes.clone().index_add_(  # padlint: ok
        0, b, torch.full_like(b, -1, dtype=index.bucket_sizes.dtype))
    return dataclasses.replace(index, bucket_ids=ids, bucket_sqnorm=sqn,
                               bucket_sizes=sizes)


def _mask_hnsw_rows(index: hnsw_lib.HNSWIndex, rows) -> hnsw_lib.HNSWIndex:
    """A new index with graph rows tombstoned: sqnorm +inf makes every
    distance to the row +inf, so it can never enter a frontier or result
    set (the row stays allocated — id = row is an invariant). Rows -1
    are dropped; the given index is never written."""
    r = torch.as_tensor(rows, device=index.device).long()
    r = r[(r >= 0) & (r < index.num_vectors)]
    sqn = index.sqnorm.clone()
    sqn[r] = PAD_SQNORM
    return dataclasses.replace(index, sqnorm=sqn)


class MutableIndex:
    """Streaming mutable ANN index = base + delta ring + tombstones."""

    def __init__(self, base: Any, *, capacity: int = 1024):
        self.base = base
        self.capacity = int(capacity)
        self.kind = "ivf" if hasattr(base, "centroids") else "hnsw"
        self.delta = delta_lib.make_delta(self.capacity, self.dim,
                                          device=base.device)
        # Mutation epoch: bumped by every insert/delete/compact. The
        # drift monitor stamps replay entries with it so observations
        # served against an older live set never contaminate a drift
        # check (their recall gap is irreducible by a predictor refit).
        self.version = 0
        # Epoch-memoized live-ground-truth cache (live_ground_truth).
        self._gt_version = -1
        self._gt_cache: dict = {}
        self._cursor = 0
        self._live_delta = 0
        self._deleted: set = set()
        self._delta_slot: dict = {}   # live delta id -> ring slot
        self._slot_id: dict = {}      # ring slot -> id (live or dead)
        self._job: Optional[CompactionJob] = None
        # optional obs.MetricsRegistry (attach_metrics): compaction
        # begin/tick/swap land in its event log
        self.metrics = None
        # wall seconds of the last compaction's units (assign / pack for
        # IVF, repair / link for HNSW), filled while it runs
        self.compaction_seconds: dict = {}
        if self.kind == "ivf":
            bi = base.bucket_ids.cpu().numpy()
            self._next_id = int(bi.max()) + 1 if (bi >= 0).any() else 0
            self._reindex_ivf()
        else:
            self._next_id = int(base.num_vectors)

    def attach_metrics(self, registry) -> None:
        """Attach an obs.MetricsRegistry: compaction begin/tick/swap land
        in its event log from then on (None detaches)."""
        self.metrics = registry

    # -- introspection -----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def dim(self) -> int:
        """Vector dimensionality of the wrapped base index."""
        return (self.base.dim if self.kind == "ivf"
                else self.base.vectors.shape[1])

    @property
    def num_live(self) -> int:
        """Live vectors: every id ever issued minus the tombstones (ring
        placement never overwrites a live slot)."""
        return self._next_id - len(self._deleted)

    @property
    def num_delta(self) -> int:
        """Live entries currently in the delta ring (not yet folded)."""
        return self._live_delta

    @property
    def deleted_ids(self) -> np.ndarray:
        """Tombstoned global ids, as an int64 array (unordered)."""
        return np.fromiter(self._deleted, np.int64,
                           count=len(self._deleted))

    def view(self) -> MutableIndexView:
        """Snapshot (base + delta) for engine construction."""
        return MutableIndexView(base=self.base, delta=self.delta)

    # -- mutations ---------------------------------------------------------
    def insert(self, vecs: np.ndarray) -> np.ndarray:
        """Append vectors to the delta ring; returns their global ids."""
        vecs = np.asarray(vecs, np.float32).reshape(-1, self.dim)
        m = vecs.shape[0]
        if m == 0:
            return np.zeros((0,), np.int64)
        if self._live_delta + m > self.capacity:
            raise RuntimeError(
                f"delta tier full ({self._live_delta} live + {m} new > "
                f"capacity {self.capacity}); call compact() first")
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._next_id += m
        # Ring placement over FREE slots only (empty or tombstoned),
        # scanning from the cursor: interleaved deletes leave dead slots
        # behind the cursor, and a blind cursor walk could land on a
        # LIVE slot and silently drop its vector.
        live_slots = np.zeros((self.capacity,), bool)
        occupied = np.fromiter(self._delta_slot.values(), np.int64,
                               count=len(self._delta_slot))
        live_slots[occupied] = True
        order = (self._cursor + np.arange(self.capacity)) % self.capacity
        slots = order[~live_slots[order]][:m]
        self._cursor = int((slots[-1] + 1) % self.capacity)
        for s, i in zip(slots, ids):
            old = self._slot_id.get(int(s))
            if old is not None:            # ring reuse of a dead slot
                self._delta_slot.pop(old, None)
            self._slot_id[int(s)] = int(i)
            self._delta_slot[int(i)] = int(s)
        self.delta = delta_lib.write(self.delta, slots, vecs, ids)
        self._live_delta += m
        self.version += 1
        return ids

    def delete(self, ids: Iterable[int]) -> int:
        """Tombstone ids (unknown / already-deleted ids are no-ops).
        Returns the number of ids actually deleted."""
        delta_slots: List[int] = []
        ivf_b: List[int] = []
        ivf_s: List[int] = []
        hnsw_rows: List[int] = []
        newly: List[int] = []
        count = 0
        for i in np.unique(np.asarray(list(ids), np.int64)):
            i = int(i)
            if i < 0 or i >= self._next_id or i in self._deleted:
                continue
            slot = self._delta_slot.pop(i, None)
            if slot is not None:
                delta_slots.append(slot)
                self._live_delta -= 1
            elif self.kind == "ivf":
                if i >= self._bucket_of.shape[0] or self._bucket_of[i] < 0:
                    continue               # folded id moved by compaction?
                ivf_b.append(int(self._bucket_of[i]))
                ivf_s.append(int(self._slot_of[i]))
                self._bucket_of[i] = PAD_ID
                self._slot_of[i] = PAD_ID
            else:
                hnsw_rows.append(i)
            self._deleted.add(i)
            newly.append(i)
            count += 1

        if delta_slots:
            self.delta = delta_lib.tombstone(self.delta,
                                             _pad_idx(delta_slots))
        if ivf_b:
            self.base = _mask_ivf_slots(self.base, _pad_idx(ivf_b),
                                        _pad_idx(ivf_s))
        if hnsw_rows:
            self.base = _mask_hnsw_rows(self.base, _pad_idx(hnsw_rows))
        if count:
            # a running background rebuild read the begin-time snapshot;
            # these deletes must be re-applied to its shadow at swap
            if self._job is not None:
                self._job.deleted_since.update(newly)
            self.version += 1
        return count

    def apply(self, events) -> None:
        """Apply a data.vectors.mutation_stream schedule in order."""
        for ev in events:
            if ev.kind == "insert":
                self.insert(ev.vecs)
            elif ev.kind == "delete":
                self.delete(ev.ids)
            else:
                raise ValueError(f"unknown mutation kind {ev.kind!r}")

    # -- live-set extraction -----------------------------------------------
    def _live_tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids i64[L], vecs f32[L, D]) of every live vector, base then
        delta, on the index's device (row-major order of the live
        slots, as the reference's boolean masks)."""
        if self.kind == "ivf":
            live = self.base.bucket_ids >= 0
            vecs = self.base.bucket_vecs[live].float()
            ids = self.base.bucket_ids[live].long()
        else:
            rows = torch.nonzero(torch.isfinite(self.base.sqnorm))[:, 0]
            vecs = self.base.vectors[rows].float()
            ids = rows.long()
        if self.base.quantized:
            vecs = vecs * self.base.scale + self.base.offset
        d_live = self.delta.ids >= 0
        return (torch.cat([ids, self.delta.ids[d_live].long()]),
                torch.cat([vecs, self.delta.vecs[d_live]]))

    def _delta_live(self) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.delta.ids.cpu().numpy()
        live = ids >= 0
        return (ids[live].astype(np.int64),
                self.delta.vecs.cpu().numpy()[live])

    def live_vectors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids i64[L], vecs f32[L, D]) of every live vector, base +
        delta — the ground-truth universe for drift checks and refits.
        SQ8 bases give dequantized vectors (what search measures)."""
        ids, vecs = self._live_tensors()
        return ids.cpu().numpy(), vecs.cpu().numpy()

    def live_ground_truth(self, q: np.ndarray, k: int, *,
                          mesh=None) -> np.ndarray:
        """Exact top-k over the live base+delta set as GLOBAL ids
        (i32[B, k] numpy, -1 when fewer than k live vectors), scanned
        with l2_topk on the index's device. The one definition of "fresh
        ground truth under mutation" shared by the drift monitor, the
        launcher and chip_smoke. With ``mesh``, the scan row-shards over
        it (``training.ground_truth``); the ids are the same.

        Memoized on the mutation epoch: consecutive calls over an
        unchanged live set reuse one scan; any insert / delete / compact
        bumps ``version`` and drops the cache."""
        from repro_torch.core import training as training_lib

        q = np.asarray(q, np.float32)
        if self._gt_version != self.version:
            self._gt_cache.clear()
            self._gt_version = self.version
        key = (int(k), q.shape, hash(q.tobytes()))
        hit = self._gt_cache.get(key)
        if hit is not None:
            return hit

        live_ids, live_vecs = self._live_tensors()
        _, rows = training_lib.ground_truth(
            torch.as_tensor(q, device=self.device), live_vecs, k, mesh=mesh)
        rows = rows.to(self.device)
        out = torch.where(rows >= 0, live_ids[rows.clamp_min(0).long()],
                          PAD_ID).to(torch.int32).cpu().numpy()
        self._gt_cache[key] = out
        return out

    # -- compaction --------------------------------------------------------
    @property
    def compacting(self) -> bool:
        """True while a background compaction job is in flight."""
        return self._job is not None

    @property
    def compaction_ticks(self) -> int:
        """Ticks the in-flight compaction job has consumed (0 if none)."""
        return self._job.ticks if self._job is not None else 0

    def begin_compaction(self, *, cap_round: int = 8,
                         ef_construction: int = 64, alpha: float = 1.2,
                         chunk: int = 1024, seed: int = 0
                         ) -> CompactionJob:
        """Start a background compaction: snapshot the live delta and the
        current base, and return the job whose tick() advances an
        incremental shadow rebuild (compact.compact_*_steps) without ever
        touching the active view. Mutations stay legal while the job
        runs: inserts land in the ring (NOT folded — they survive the
        swap live in the delta), deletes mask the active view and are
        recorded for re-application to the shadow. Call
        swap_compaction() once tick() returns True."""
        if self._job is not None:
            raise RuntimeError("compaction already in progress")
        d_ids, d_vecs = self._delta_live()
        self.compaction_seconds = {}
        if self.kind == "ivf":
            gen = compact_lib.compact_ivf_steps(
                self.base, d_ids, d_vecs, cap_round=cap_round,
                metrics=self.metrics, seconds=self.compaction_seconds)
        else:
            gen = compact_lib.compact_hnsw_steps(
                self.base, d_ids, d_vecs, self._next_id,
                ef_construction=ef_construction, alpha=alpha,
                chunk=chunk, seed=seed, metrics=self.metrics,
                seconds=self.compaction_seconds)
        self._job = CompactionJob(gen, d_ids)
        if self.metrics is not None:
            self.metrics.event("compact_begin", version=int(self.version),
                               folded=len(self._job.folded_ids))
        return self._job

    def compact_tick(self) -> bool:
        """Advance the background rebuild by one bounded work unit;
        returns True once the shadow is ready to swap."""
        if self._job is None:
            raise RuntimeError("no compaction in progress")
        done = self._job.tick()
        if self.metrics is not None:
            self.metrics.event("compact_tick", tick=self._job.ticks,
                               done=done)
        return done

    def swap_compaction(self) -> None:
        """Install the finished shadow as the new base — the host half of
        the atomic hot-swap (the server applies the matching engine swap
        at a drained chunk boundary via request_swap). Re-applies
        mid-rebuild deletes as shadow tombstones, frees the folded ring
        slots (mid-rebuild inserts stay live in the ring), and bumps the
        mutation epoch."""
        job = self._job
        if job is None:
            raise RuntimeError("no compaction in progress")
        if not job.done:
            raise RuntimeError(
                "compaction not finished: tick() until it returns True")
        shadow = job.shadow
        # 1) mid-rebuild deletes: the shadow folded the begin-time live
        #    set, so anything deleted since must be re-tombstoned there
        #    (ids inserted after begin were never folded — no-ops here).
        late = np.fromiter(sorted(job.deleted_since), np.int64,
                           count=len(job.deleted_since))
        if late.size:
            if self.kind == "ivf":
                bi = shadow.bucket_ids.cpu().numpy()
                b, s = np.nonzero((bi >= 0) & np.isin(bi, late))
                if b.size:
                    shadow = _mask_ivf_slots(shadow, _pad_idx(b),
                                             _pad_idx(s))
            else:
                rows = late[late < int(shadow.num_vectors)]
                if rows.size:
                    shadow = _mask_hnsw_rows(shadow, _pad_idx(rows))
        self.base = shadow
        # 2) free the folded ring slots — their vectors now live in the
        #    base. Slots freed by a mid-rebuild delete are already gone
        #    from _delta_slot; ids inserted mid-rebuild keep theirs.
        slots = [self._delta_slot.pop(i) for i in sorted(job.folded_ids)
                 if i in self._delta_slot]
        if slots:
            self.delta = delta_lib.tombstone(self.delta, _pad_idx(slots))
            self._live_delta -= len(slots)
        if not self._delta_slot:
            # ring fully drained (no mid-rebuild inserts): reset to the
            # pristine state the synchronous compact() always produced
            self.delta = delta_lib.make_delta(self.capacity, self.dim,
                                              device=self.device)
            self._cursor = 0
            self._live_delta = 0
            self._slot_id.clear()
        if self.kind == "ivf":
            self._reindex_ivf()
        ticks = job.ticks
        self._job = None
        self.version += 1
        if self.metrics is not None:
            self.metrics.event("compact_swap", version=int(self.version),
                               ticks=ticks)
            self.metrics.counter(
                "darth_compactions_total",
                "background compactions swapped in").inc()

    def _reindex_ivf(self) -> None:
        """Rebuild the id -> (bucket, slot) delete maps from the base
        (slots masked at swap time carry id -1 and stay unmapped)."""
        bi = self.base.bucket_ids.cpu().numpy()
        self._bucket_of = np.full((self._next_id,), PAD_ID, np.int32)
        self._slot_of = np.full((self._next_id,), PAD_ID, np.int32)
        b, s = np.nonzero(bi >= 0)
        self._bucket_of[bi[b, s]] = b
        self._slot_of[bi[b, s]] = s

    def compact(self, *, cap_round: int = 8, ef_construction: int = 64,
                alpha: float = 1.2, chunk: int = 1024,
                seed: int = 0) -> None:
        """Fold the delta into the base and empty the ring. The base
        object is REPLACED (shapes may grow); rebuild engines/views from
        ``self.base`` / ``self.view()`` afterwards. Synchronous
        convenience: begin_compaction + drain every tick +
        swap_compaction — the exact code path the background rebuild
        takes, in one call."""
        self.begin_compaction(cap_round=cap_round,
                              ef_construction=ef_construction,
                              alpha=alpha, chunk=chunk, seed=seed)
        while not self.compact_tick():
            pass
        self.swap_compaction()
