"""Compaction: fold the delta tier back into the base index (a port of
``repro.mutate.compact``).

The LSM minor-compaction analogue. Global ids are STABLE across
compaction — surviving base vectors and folded delta vectors keep the ids
they were assigned at build/insert time, so replay buffers, ground truth
and served results stay comparable across the fold.

IVF: delta vectors are re-spilled onto the EXISTING centroids with
``kmeans.assign`` (the l2_topk kernel at k = 1, on the index's device),
tombstoned slots are dropped, and the bucket store is re-packed with
``ivf.pack_buckets_steps``, regrowing cap to the new max bucket size. SQ8
storage quantizes the folded delta with the base's frozen scale/offset
and counts the clipped values.

HNSW: the id = row invariant is preserved by growing the node dim to
cover every id ever issued — deleted/overwritten ids become inert rows
(sqnorm +inf, neighbours -1, unreachable by construction). Live delta
vectors land at their id rows and are linked with ``hnsw.insert_nodes``;
rows that pointed at a deleted node splice in that node's own neighbour
list before re-pruning, so the deleted node's "highway" role is repaired
rather than severed. The distance work runs on the index's device, the
edge bookkeeping in numpy, and the randomness is numpy's, drawn in the
reference's order: on integer data the shadow equals the reference's.

Both folds are INCREMENTAL generators (``compact_ivf_steps``,
``compact_hnsw_steps``) with a ``yield`` wherever the reference has one:
every yield is a tick boundary and the work between two is one bounded
unit (an assign / pack / repair / link chunk). The synchronous
``compact_ivf`` / ``compact_hnsw`` drain the generator — one code path,
so background and stop-the-world compaction give identical shadows. The
generators read the input index ONCE, before their first yield; deletes
REPLACE the active base object (``MutableIndex.delete`` never writes in
place), so the begin-time snapshot never changes under the rebuild.

Given a dict, ``seconds`` receives the wall time of the snapshot reads
("read"), of the IVF fold's "assign", "pack" and "upload" (the shadow to
the device) units and of the HNSW fold's "repair" and "link" units: the
time spent inside the generator, not between ticks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM
from repro_torch.index import hnsw as hnsw_lib
from repro_torch.index import ivf as ivf_lib
from repro_torch.index import kmeans as kmeans_lib


def drain(gen):
    """Run an incremental-compaction generator to completion and return
    its final value (the rebuilt base index)."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def _timed(gen, seconds: Optional[Dict[str, float]], key: str):
    """Re-yield ``gen``'s ticks, adding the time spent inside it to
    ``seconds[key]``; returns its value."""
    while True:
        t0 = time.perf_counter()
        try:
            next(gen)
        except StopIteration as stop:
            _add(seconds, key, t0)
            return stop.value
        _add(seconds, key, t0)
        yield


def _add(seconds: Optional[Dict[str, float]], key: str, t0: float) -> None:
    if seconds is not None:
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


def _sq8_clipped(metrics, nclip: int) -> None:
    if nclip and metrics is not None:
        metrics.counter(
            "darth_sq8_clipped_total",
            "SQ8 values clamped to the frozen base range during "
            "delta re-quantization").inc(nclip)


def compact_ivf(index: ivf_lib.IVFIndex, delta_ids: np.ndarray,
                delta_vecs: np.ndarray, *, cap_round: int = 8,
                metrics=None, seconds=None) -> ivf_lib.IVFIndex:
    """Fold live delta entries into the bucket store; drop tombstones.
    (Synchronous: drains compact_ivf_steps in one call.)"""
    return drain(compact_ivf_steps(index, delta_ids, delta_vecs,
                                   cap_round=cap_round, metrics=metrics,
                                   seconds=seconds))


def compact_ivf_steps(index: ivf_lib.IVFIndex, delta_ids: np.ndarray,
                      delta_vecs: np.ndarray, *, cap_round: int = 8,
                      assign_chunk: int = 4096, pack_chunk: int = 64,
                      metrics=None, seconds=None):
    """Incremental IVF fold: snapshot reads, chunked delta re-spill,
    chunked bucket re-pack; yields between bounded units and returns the
    shadow IVFIndex (on the input's device) via StopIteration.value."""
    t0 = time.perf_counter()
    dev = index.device
    cents = index.centroids
    bv = index.bucket_vecs.cpu().numpy()
    bi = index.bucket_ids.cpu().numpy()
    _add(seconds, "read", t0)
    yield
    live = bi >= 0
    base_store = bv[live]                     # [L, D] stored dtype
    base_ids = bi[live].astype(np.int32)
    # live entries keep their bucket assignment (their centroid did not
    # move); the bucket row of each live slot is its assignment
    base_assign = np.broadcast_to(
        np.arange(bi.shape[0], dtype=np.int32)[:, None], bi.shape)[live]
    del bv
    yield

    scale = index.scale.cpu().numpy()
    offset = index.offset.cpu().numpy()
    delta_vecs = np.asarray(delta_vecs, np.float32).reshape(-1, index.dim)
    delta_ids = np.asarray(delta_ids, np.int32).reshape(-1)
    delta_assign = np.zeros((delta_ids.size,), np.int32)
    for lo in range(0, delta_ids.size, assign_chunk):   # re-spill
        t0 = time.perf_counter()
        hi = min(delta_ids.size, lo + assign_chunk)
        delta_assign[lo:hi] = kmeans_lib.assign(
            torch.as_tensor(delta_vecs[lo:hi], device=dev),
            cents).cpu().numpy()
        _add(seconds, "assign", t0)
        yield

    if index.quantized:
        base_deq = base_store.astype(np.float32) * scale + offset
        # The delta is quantized against the FROZEN base range so codes
        # stay comparable; an OOD drift burst can exceed it. The clamp is
        # correct but lossy — it is counted, not silent.
        delta_store, delta_deq, nclip = ivf_lib.quantize_sq8(
            delta_vecs, scale, offset)
        _sq8_clipped(metrics, nclip)
    else:
        base_deq = base_store
        delta_store, delta_deq = delta_vecs, delta_vecs

    x_store = np.concatenate([base_store, delta_store], axis=0)
    x_deq = np.concatenate([base_deq, delta_deq], axis=0)
    ids = np.concatenate([base_ids, delta_ids])
    assign = np.concatenate([base_assign, delta_assign]).astype(np.int64)
    yield
    bucket_vecs, bucket_ids, bucket_sqnorm, sizes = yield from _timed(
        ivf_lib.pack_buckets_steps(x_store, x_deq, ids, assign,
                                   index.nlist, cap_round=cap_round,
                                   chunk=pack_chunk), seconds, "pack")

    t0 = time.perf_counter()

    def t(v):
        return torch.as_tensor(v, device=dev)
    shadow = ivf_lib.IVFIndex(
        centroids=index.centroids,
        bucket_vecs=t(bucket_vecs),
        bucket_ids=t(bucket_ids),
        bucket_sqnorm=t(bucket_sqnorm),
        bucket_sizes=t(sizes),
        scale=index.scale,
        offset=index.offset,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _add(seconds, "upload", t0)
    return shadow


def compact_hnsw(index: hnsw_lib.HNSWIndex, delta_ids: np.ndarray,
                 delta_vecs: np.ndarray, next_id: int, *,
                 ef_construction: int = 64, alpha: float = 1.2,
                 chunk: int = 1024, seed: int = 0,
                 metrics=None, seconds=None) -> hnsw_lib.HNSWIndex:
    """Grow the graph to ``next_id`` rows, repair deletions, link delta.
    (Synchronous: drains compact_hnsw_steps in one call.)"""
    return drain(compact_hnsw_steps(index, delta_ids, delta_vecs, next_id,
                                    ef_construction=ef_construction,
                                    alpha=alpha, chunk=chunk, seed=seed,
                                    metrics=metrics, seconds=seconds))


def compact_hnsw_steps(index: hnsw_lib.HNSWIndex, delta_ids: np.ndarray,
                       delta_vecs: np.ndarray, next_id: int, *,
                       ef_construction: int = 64, alpha: float = 1.2,
                       chunk: int = 1024, seed: int = 0,
                       repair_chunk: int = 256, metrics=None, seconds=None):
    """Incremental HNSW fold: snapshot reads, chunked deletion repair,
    chunked incremental linking; yields between bounded units and returns
    the shadow HNSWIndex (on the input's device) via StopIteration.value.

    SQ8-resident graphs dequantize at entry (pruning geometry runs in
    f32) and re-quantize at exit against the FROZEN base range, so the
    rebuilt view stays int8-resident; delta clips are counted as the IVF
    fold's are."""
    t0 = time.perf_counter()
    dev = index.device
    x = index.vectors.cpu().numpy()
    if index.quantized:
        x = (x.astype(np.float32) * index.scale.cpu().numpy()
             + index.offset.cpu().numpy())
    sq = index.sqnorm.cpu().numpy()
    nbr = index.neighbors.cpu().numpy()
    _add(seconds, "read", t0)
    yield
    n_old, d = x.shape
    m = nbr.shape[1]
    alpha2 = float(alpha) ** 2

    n_new = max(int(next_id), n_old)
    x2 = np.zeros((n_new, d), np.float32)
    sq2 = np.full((n_new,), PAD_SQNORM, np.float32)
    nbr2 = np.full((n_new, m), PAD_ID, np.int32)
    x2[:n_old] = x
    sq2[:n_old] = sq
    nbr2[:n_old] = nbr
    del x

    delta_ids = np.asarray(delta_ids, np.int64).reshape(-1)
    delta_vecs = np.asarray(delta_vecs, np.float32).reshape(-1, d)
    x2[delta_ids] = delta_vecs
    sq2[delta_ids] = (delta_vecs ** 2).sum(axis=1)
    x2t = torch.as_tensor(x2, device=dev)
    yield

    # 1) deletion repair: rows pointing at a dead node splice in that
    #    node's neighbours (minus dead) and re-prune; dead rows go inert.
    dead = ~np.isfinite(sq2[:n_old])
    dead_rows = np.nonzero(dead)[0]
    if dead_rows.size:
        dead_mask = np.zeros((n_new,), bool)
        dead_mask[dead_rows] = True
        ref = (nbr2 >= 0) & dead_mask[np.maximum(nbr2, 0)]
        affected = np.nonzero(ref.any(axis=1))[0]
        affected = affected[~dead_mask[affected]]
        # chunked: merged lists are m + m*m wide and the re-prune's
        # pairwise block is quadratic in that width
        for lo in range(0, affected.size, repair_chunk):
            t0 = time.perf_counter()
            aff = affected[lo:lo + repair_chunk]
            own = np.where(ref[aff], PAD_ID, nbr2[aff])
            # dead targets' own out-edges, flattened per affected row
            spliced = np.where(ref[aff, :, None],
                               nbr2[np.maximum(nbr2[aff], 0)],
                               PAD_ID).reshape(aff.size, -1)
            merged = np.concatenate([own, spliced], axis=1)
            merged = np.where(
                (merged >= 0) & ~dead_mask[np.maximum(merged, 0)],
                merged, PAD_ID)
            merged = hnsw_lib._dedup_rows_vec(merged)
            nbr2[aff] = hnsw_lib._prune_rows(
                x2t, torch.as_tensor(aff, device=dev),
                torch.as_tensor(merged, device=dev), m,
                alpha2).cpu().numpy()
            _add(seconds, "repair", t0)
            yield
        nbr2[dead_rows] = PAD_ID

    # 2) routing sample / entry over LIVE, LINKED nodes only (new rows
    #    are not linked yet, so they cannot seed the link searches).
    rng = np.random.default_rng(seed)
    old_live = np.nonzero(np.isfinite(sq2[:n_old]))[0]
    if old_live.size == 0:
        raise ValueError("compaction needs at least one live base node "
                         "to seed incremental linking")
    r = int(min(8192, max(64, n_new // 64)))
    route_link = rng.choice(old_live, size=min(r, old_live.size),
                            replace=False).astype(np.int32)
    entry_link = int(old_live[np.argmin(
        ((x2[old_live] - x2[old_live].mean(0)) ** 2).sum(1))])
    yield

    grown = hnsw_lib.HNSWIndex(
        vectors=x2t, sqnorm=torch.as_tensor(sq2, device=dev),
        neighbors=torch.as_tensor(nbr2, device=dev),
        entry=torch.tensor(entry_link, dtype=torch.int32, device=dev),
        route_ids=torch.as_tensor(route_link, device=dev))
    grown = yield from _timed(hnsw_lib.insert_nodes_steps(
        grown, delta_ids, ef_construction=ef_construction,
        alpha=alpha, chunk=chunk), seconds, "link")

    # 3) final routing sample drawn over ALL live nodes (incl. new ones,
    #    now linked) so routing covers the folded distribution.
    live = np.nonzero(np.isfinite(sq2))[0]
    route_ids = rng.choice(live, size=min(r, live.size),
                           replace=False).astype(np.int32)
    entry = int(live[np.argmin(((x2[live] - x2[live].mean(0)) ** 2).sum(1))])
    grown = dataclasses.replace(
        grown, entry=torch.tensor(entry, dtype=torch.int32, device=dev),
        route_ids=torch.as_tensor(route_ids, device=dev))
    if not index.quantized:
        return grown
    # Re-quantize at exit against the frozen base range: base rows
    # round-trip exactly; only delta rows can clip (counted). sqnorm is
    # recomputed on the DEQUANTIZED codes so served distances match what
    # the quantized search measures.
    scale = index.scale.cpu().numpy()
    offset = index.offset.cpu().numpy()
    codes, deq, _ = ivf_lib.quantize_sq8(x2, scale, offset)
    nclip = (ivf_lib.quantize_sq8(delta_vecs, scale, offset)[2]
             if delta_ids.size else 0)
    _sq8_clipped(metrics, nclip)
    sq_q = np.full((n_new,), PAD_SQNORM, np.float32)
    sq_q[live] = (deq[live] ** 2).sum(axis=1)
    return dataclasses.replace(
        grown, vectors=torch.as_tensor(codes, device=dev),
        sqnorm=torch.as_tensor(sq_q, device=dev),
        scale=index.scale, offset=index.offset)
