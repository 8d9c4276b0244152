"""Fixed-degree navigable graph (HNSW's base layer) + batched beam search.

The port of the reference's ``index/hnsw.py``, in plain PyTorch on the
device where the index lies (the reference reaches no Pallas kernel on
this path: its beam step is plain XLA):

  * graph      = int32[N, M] adjacency (padded with -1), built in batches:
                 beam-search candidates -> RobustPrune (alpha-CNG, the
                 Vamana rule) -> reverse-edge merge -> re-prune. A
                 routing sample's dense scan stands in for HNSW's upper
                 layers.
  * frontier   = the best ``ef`` candidates per query, ascending, with an
                 expanded mask; result set = the first k of the frontier.
  * visited    = per-query bitmap [B, N], or a hashed filter [B, W]; on
                 a sharded graph (``search_sharded``) a tuple of S
                 column blocks, block s on shard s's device.
  * one step   = expand the closest unexpanded candidate of every active
                 query: gather M neighbours, mask the visited, batched
                 distance, merge. ``ndis`` advances by the *new* distance
                 computations.

Ties break as ``lax.top_k`` and ``argmin`` do in the reference: the lower
column first (a stable sort, torch's first-occurrence argmin), so on data
where every distance is exact the port's steps equal the reference's.
``beam_step`` updates the state's visited structure in place (copying a
[B, N] bitmap every step would cost more than the step): a state is
consumed by the step that advances it.

The build's randomness is numpy's, drawn in the reference's order, and
its edge bookkeeping (``_dedup_rows_vec``, ``_reverse_edges``) is the
reference's numpy; the distance work (candidate searches, pairwise
distances, sorts, RobustPrune) runs on the index's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.padding import PAD_DIST, PAD_ID, pad_dists, pad_ids


@dataclasses.dataclass
class HNSWIndex:
    vectors: torch.Tensor    # f32|int8[N, D] (SQ8-resident when int8)
    sqnorm: torch.Tensor     # f32[N], of the DEQUANTIZED vectors when SQ8
    neighbors: torch.Tensor  # i32[N, M] (-1 pad)
    entry: torch.Tensor      # i32[] medoid entry point
    route_ids: torch.Tensor  # i32[R] routing sample (upper-layer stand-in)
    # SQ8 affine dequant (x_hat = scale * x8 + offset, per dim); None for
    # f32 storage.
    scale: Optional[torch.Tensor] = None    # f32[D]
    offset: Optional[torch.Tensor] = None   # f32[D]

    @property
    def quantized(self) -> bool:
        return self.vectors.dtype == torch.int8

    @property
    def num_vectors(self) -> int:
        return self.vectors.shape[0]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def asym_query(index: HNSWIndex, qf: torch.Tensor, qsq: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SQ8 asymmetric query transform (identity for f32 storage):
    ``||x_hat - q||^2 = ||x_hat||^2 - 2 (q*scale).x8 + (||q||^2 -
    2 q.offset)``, so the state carries ``(q*scale, qsq - 2 q.offset)``
    and every dot product serves int8 codes cast to f32."""
    if not index.quantized:
        return qf, qsq
    q_eff = qf * index.scale[None, :]
    bias = qsq - 2.0 * (qf @ index.offset)[:, None]
    return q_eff, bias


def hash_slot(ids: torch.Tensor, width: int) -> torch.Tensor:
    """Fibonacci-hash node ids into [0, width); width a power of two.

    The reference's uint32 product ``ids * 2654435761`` (wrapping) and its
    top log2(width) bits, computed in int64: the low 32 bits of the
    int64 product are the uint32 product whatever the wrap."""
    log2w = int(width).bit_length() - 1
    h = ((ids.long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    return (h >> (32 - log2w)).to(torch.int32)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _pairwise_sq(v: torch.Tensor) -> torch.Tensor:
    """v: [B, C, D] -> [B, C, C] squared L2 among candidates."""
    sq = (v ** 2).sum(2)
    dots = torch.bmm(v, v.transpose(1, 2))
    return torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2.0 * dots, 0.0)


def _robust_prune(cand_i: torch.Tensor, cand_d: torch.Tensor,
                  pd: torch.Tensor, m: int, alpha: float = 1.2
                  ) -> torch.Tensor:
    """Vectorized Vamana RobustPrune, m steps over the batch.

    cand_i: i32[B, C] candidate ids sorted by distance to owner (-1 invalid)
    cand_d: f32[B, C] distances to owner
    pd:     f32[B, C, C] pairwise distances among candidates
    Returns i32[B, m] selected neighbors (-1 pad).
    """
    b, c = cand_i.shape
    dev = cand_i.device
    alive = cand_i >= 0
    out = pad_ids((b, m), dev)
    col = torch.arange(c, device=dev)
    # The reference multiplies in f32 (a weak Python float times f32).
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    for t in range(m):
        # First alive candidate (they are distance-sorted).
        pick = torch.where(alive, col[None, :], c + 1).argmin(1)   # [B]
        has = alive.gather(1, pick[:, None])[:, 0]
        pick_id = cand_i.gather(1, pick[:, None])[:, 0]
        out[:, t] = torch.where(has, pick_id, PAD_ID)
        # Kill candidates dominated by the pick: alpha*d(pick,c) <= d(u,c).
        pd_pick = pd.gather(1, pick[:, None, None].expand(b, 1, c))[:, 0, :]
        dominated = alpha_t * pd_pick <= cand_d
        alive = alive & ~dominated & (col[None, :] != pick[:, None])
        alive = alive & has[:, None]
    return out


def _dedup_rows_vec(ids: np.ndarray) -> np.ndarray:
    """Vectorized per-row dedup: keeps first occurrence, others -> -1."""
    order = np.argsort(ids, axis=1, kind="stable")
    s = np.take_along_axis(ids, order, axis=1)
    dup = np.zeros_like(s, dtype=bool)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    mask = np.zeros_like(dup)
    np.put_along_axis(mask, order, dup, axis=1)
    out = ids.copy()
    out[mask] = PAD_ID
    return out


def _reverse_edges(fwd: np.ndarray, slots: int) -> np.ndarray:
    """Collect up to `slots` reverse proposals per node from forward edges."""
    n, m = fwd.shape
    src = np.repeat(np.arange(n, dtype=np.int32), m)
    dst = fwd.reshape(-1)
    ok = (dst >= 0) & (dst != src)
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    grp_start = np.r_[True, dst[1:] != dst[:-1]] if len(dst) else np.zeros(0, bool)
    pos = (np.arange(len(dst))
           - np.maximum.accumulate(np.where(grp_start, np.arange(len(dst)), 0)))
    rev = np.full((n, slots), PAD_ID, np.int32)
    keep = pos < slots
    rev[dst[keep], pos[keep]] = src[keep]
    return rev


def _sorted_prune(x: torch.Tensor, cand_i: torch.Tensor, dist: torch.Tensor,
                  m: int, alpha2: float) -> torch.Tensor:
    """Stable distance sort of candidate lists (+inf entries become -1),
    then RobustPrune to m: the shared tail of both prunes."""
    d_s, order = torch.sort(dist, dim=1, stable=True)
    ci_s = torch.where(d_s < PAD_DIST, cand_i.gather(1, order), PAD_ID)
    pd = _pairwise_sq(x[ci_s.clamp_min(0).long()])
    return _robust_prune(ci_s, d_s, pd, m, alpha2)


def _prune_rows(x: torch.Tensor, owners: torch.Tensor, merged: torch.Tensor,
                m: int, alpha2: float) -> torch.Tensor:
    """Distance-sort + alpha-prune candidate lists for `owners` rows.

    owners: i64[B] node ids; merged: i32[B, C] candidate ids (-1 invalid,
    self-edges dropped). Returns i32[B, m]."""
    vi = x[merged.clamp_min(0).long()]
    du = ((vi - x[owners][:, None, :]) ** 2).sum(2)
    du = torch.where((merged >= 0) & (merged != owners[:, None]), du,
                     PAD_DIST)
    return _sorted_prune(x, merged, du, m, alpha2)


def _pool_prune(x: torch.Tensor, owners: torch.Tensor, cand_d: torch.Tensor,
                cand_i: torch.Tensor, m: int, alpha2: float) -> torch.Tensor:
    """Forward edges from a beam-search candidate pool (the owners'
    ef-wide frontier): drop self and invalid entries, distance-sort,
    RobustPrune to m. owners: i64[B] node ids; returns i32[B, m]."""
    cd = torch.where((cand_i == owners[:, None]) | (cand_i < 0), PAD_DIST,
                     cand_d)
    return _sorted_prune(x, cand_i, cd, m, alpha2)


def _prune_merged(x: torch.Tensor, merged: np.ndarray, m: int, alpha2: float,
                  chunk: int) -> np.ndarray:
    """Distance-sort + alpha-prune candidate lists to degree m (chunked)."""
    n = x.shape[0]
    out = np.zeros((n, m), np.int32)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        owners = torch.arange(lo, hi, device=x.device)
        rows = torch.as_tensor(merged[lo:hi], device=x.device)
        out[lo:hi] = _prune_rows(x, owners, rows, m, alpha2).cpu().numpy()
    return out


def build(x: np.ndarray, m: int = 16, *, ef_construction: int = 64,
          passes: int = 2, alpha: float = 1.2, chunk: int = 1024,
          seed: int = 0, device="cuda",
          seconds: Optional[Dict[str, float]] = None) -> HNSWIndex:
    """Vamana-style batch build on ``device`` (see module docstring).

    Random-init graph, then `passes` rounds: for each node batch of
    ``chunk`` rows, beam-search the current graph for the node itself
    (ef_construction frontier = candidate pool), RobustPrune to m forward
    edges, then merge reverse proposals and re-prune. `alpha` is applied
    as alpha^2 in squared-L2 space. The graph does not depend on
    ``chunk``, which bounds the [chunk, N] visited bitmap of a search.
    Given a dict, ``seconds`` receives the wall time of the candidate
    searches ("search"), the prunes ("prune") and the reverse-edge merge
    ("merge")."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    xt = torch.as_tensor(x, device=device)
    sq = (xt ** 2).sum(1)
    rng = np.random.default_rng(seed)
    alpha2 = float(alpha) ** 2
    split = {"search": 0.0, "prune": 0.0, "merge": 0.0}

    neighbors = rng.integers(0, n, size=(n, m), dtype=np.int64).astype(np.int32)
    neighbors = _dedup_rows_vec(neighbors)
    entry = torch.tensor(int(np.argmin(((x - x.mean(0)) ** 2).sum(1))),
                         dtype=torch.int32, device=device)
    # Routing sample = upper-layer stand-in (uniform, like HNSW level draws).
    r = int(min(8192, max(64, n // 64)))
    route_ids = torch.as_tensor(
        rng.choice(n, size=min(r, n), replace=False).astype(np.int32),
        device=device)
    efc = max(ef_construction, 2 * m)

    for _ in range(passes):
        idx = HNSWIndex(vectors=xt, sqnorm=sq,
                        neighbors=torch.as_tensor(neighbors, device=device),
                        entry=entry, route_ids=route_ids)
        fwd = np.zeros((n, m), np.int32)
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            t0 = time.perf_counter()
            _, _, s = search(idx, xt[lo:hi], k=m, ef=efc, max_steps=4 * efc)
            t1 = time.perf_counter()
            owners = torch.arange(lo, hi, device=xt.device)
            fwd[lo:hi] = _pool_prune(xt, owners, s.cand_d, s.cand_i, m,
                                     alpha2).cpu().numpy()
            del s
            split["search"] += t1 - t0
            split["prune"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        rev = _reverse_edges(fwd, m)
        # Union with the previous graph: keeps the long "highway" edges the
        # frontier-only candidate pool cannot see.
        merged = _dedup_rows_vec(np.concatenate([fwd, rev, neighbors], axis=1))
        t1 = time.perf_counter()
        neighbors = _prune_merged(xt, merged, m, alpha2, chunk)
        split["merge"] += t1 - t0
        split["prune"] += time.perf_counter() - t1

    if seconds is not None:
        seconds.update(split)
    return HNSWIndex(vectors=xt, sqnorm=sq,
                     neighbors=torch.as_tensor(neighbors, device=device),
                     entry=entry, route_ids=route_ids)


def insert_nodes(index: HNSWIndex, rows: np.ndarray, *,
                 ef_construction: int = 64, alpha: float = 1.2,
                 chunk: int = 1024) -> HNSWIndex:
    """Incrementally link already-appended rows (streaming compaction).

    ``rows`` must already be present in vectors/sqnorm (their neighbour
    rows are overwritten); entry/route_ids must reference nodes that are
    live and linked, since they seed the candidate searches. Per chunk:
    beam-search the CURRENT graph for each new vector (its
    ef_construction frontier is the candidate pool, as in the batch
    build), RobustPrune to m forward edges, then merge the reverse
    proposals into each target's list and re-prune — the reverse-edge
    repair that makes new nodes reachable. (Synchronous wrapper: drains
    insert_nodes_steps in one call.)"""
    gen = insert_nodes_steps(index, rows, ef_construction=ef_construction,
                             alpha=alpha, chunk=chunk)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def insert_nodes_steps(index: HNSWIndex, rows: np.ndarray, *,
                       ef_construction: int = 64, alpha: float = 1.2,
                       chunk: int = 1024):
    """Generator form of insert_nodes: yields after each linked chunk (one
    bounded unit of work — a background compaction's tick boundary) and
    returns the updated index via StopIteration.value. The searches and
    prunes run on the index's device; the adjacency is kept in numpy
    between chunks, as in ``build``. The graph must hold f32 vectors
    (compaction dequantizes an SQ8 graph before it links)."""
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return index
    if index.quantized:
        raise ValueError("insert_nodes links f32 graphs; dequantize an "
                         "SQ8 graph first (as compaction does)")
    dev = index.device
    xv = index.vectors
    nbr = index.neighbors.cpu().numpy().copy()
    n, m = nbr.shape
    alpha2 = float(alpha) ** 2
    efc = max(ef_construction, 2 * m)

    for lo in range(0, rows.size, chunk):
        sel = rows[lo:lo + chunk]
        sel_t = torch.as_tensor(sel, device=dev)
        cur = dataclasses.replace(
            index, neighbors=torch.as_tensor(nbr, device=dev))
        _, _, s = search(cur, xv[sel_t], k=m, ef=efc, max_steps=4 * efc)
        fwd = _pool_prune(xv, sel_t, s.cand_d, s.cand_i, m,
                          alpha2).cpu().numpy()
        del s
        nbr[sel] = fwd
        # Reverse-edge repair: every forward target merges the new node
        # into its own list and re-prunes to degree m.
        fwd_full = np.full((n, m), PAD_ID, np.int32)
        fwd_full[sel] = fwd
        rev = _reverse_edges(fwd_full, m)
        targets = np.nonzero((rev >= 0).any(axis=1))[0]
        if targets.size:
            merged = _dedup_rows_vec(
                np.concatenate([nbr[targets], rev[targets]], axis=1))
            nbr[targets] = _prune_rows(
                xv, torch.as_tensor(targets, device=dev),
                torch.as_tensor(merged, device=dev), m,
                alpha2).cpu().numpy()
        yield

    return dataclasses.replace(index,
                               neighbors=torch.as_tensor(nbr, device=dev))


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HNSWSearchState:
    q: torch.Tensor         # f32[B, D] effective query (q*scale when SQ8)
    qsq: torch.Tensor       # f32[B, 1] effective bias (see asym_query)
    cand_d: torch.Tensor    # f32[B, ef] ascending (frontier + results)
    cand_i: torch.Tensor    # i32[B, ef]
    cand_exp: torch.Tensor  # bool[B, ef]
    visited: Any            # bool[B, N] exact bitmap, or [B, W] hashed
    #                         filter when W < N (see hash_slot); on a
    #                         sharded graph a tuple of S column blocks
    first_nn: torch.Tensor  # f32[B]
    active: torch.Tensor    # bool[B]
    ndis: torch.Tensor      # i32[B]
    ninserts: torch.Tensor  # i32[B]
    nstep: torch.Tensor     # i32[B]

    def topk(self, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cand_d[:, :k], self.cand_i[:, :k]


def check_visited_width(width: int, n: int) -> int:
    """A hashed filter's width: a power of two in [2, n)."""
    w = int(width)
    if w < 2 or w & (w - 1) or w >= n:
        raise ValueError(
            f"visited_width must be a power of two in [2, N) "
            f"(got {w} for N={n})")
    return w


def route(index, q: torch.Tensor, route_vecs: torch.Tensor,
          route_sqnorm: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Upper-layer stand-in: one dense f32 scan of the routing sample
    (its vectors [R, D] as f32 and their sqnorm [R]) picks a per-query
    base-layer entry, the lowest routing column on a tie. Returns the
    effective query and bias (``asym_query``), the entry ids i32[B] and
    their clamped squared distances f32[B]."""
    qf = q.float()
    qsq = (qf ** 2).sum(1, keepdim=True)
    q_eff, qb = asym_query(index, qf, qsq)
    rd = route_sqnorm[None, :] - 2.0 * q_eff @ route_vecs.T + qb  # [B, R]
    r_best = rd.argmin(1)
    e = index.route_ids[r_best]                                 # [B]
    ed = torch.clamp_min(rd.gather(1, r_best[:, None])[:, 0], 0.0)
    return q_eff, qb, e, ed


def start_state(q_eff: torch.Tensor, qb: torch.Tensor, e: torch.Tensor,
                ed: torch.Tensor, visited, *, ef: int,
                nroute: int) -> HNSWSearchState:
    """The state after routing: the entry alone in the frontier, marked
    in ``visited`` by the caller. The routing scan computes R distances
    per query, so ndis starts at R, as in the reference."""
    b, dev = q_eff.shape[0], q_eff.device
    cand_d = pad_dists((b, ef), dev)
    cand_d[:, 0] = ed
    cand_i = pad_ids((b, ef), dev)
    cand_i[:, 0] = e
    return HNSWSearchState(
        q=q_eff, qsq=qb, cand_d=cand_d, cand_i=cand_i,
        cand_exp=torch.zeros((b, ef), dtype=torch.bool, device=dev),
        visited=visited, first_nn=torch.sqrt(ed),
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        ndis=torch.full((b,), nroute, dtype=torch.int32, device=dev),
        ninserts=torch.ones((b,), dtype=torch.int32, device=dev),
        nstep=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


def init_state(index: HNSWIndex, q: torch.Tensor, *, ef: int,
               visited_width: int = 0) -> HNSWSearchState:
    """Start-of-search state. ``visited_width=0`` keeps the exact
    [B, N] visited bitmap; a power-of-two width < N switches to the
    hashed visited filter (a colliding NEW node is treated as seen)."""
    b, n, dev = q.shape[0], index.num_vectors, index.device
    rids = index.route_ids.long()
    q_eff, qb, e, ed = route(index, q, index.vectors[rids].float(),
                             index.sqnorm[rids])
    rows = torch.arange(b, device=dev)
    if visited_width:
        w = check_visited_width(visited_width, n)
        visited = torch.zeros((b, w), dtype=torch.bool, device=dev)
        visited[rows, hash_slot(e, w).long()] = True
    else:
        visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
        visited[rows, e.long()] = True
    return start_state(q_eff, qb, e, ed, visited, ef=ef,
                       nroute=index.route_ids.shape[0])


def select_expand(s: HNSWSearchState
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick each query's closest unexpanded candidate (first column on a
    tie). Returns (sel_id_safe i32[B], act bool[B], cand_exp bool[B, ef])."""
    unexp_d = torch.where(s.cand_exp | (s.cand_i < 0), PAD_DIST, s.cand_d)
    sel = unexp_d.argmin(1)                                   # [B]
    sel_d = unexp_d.gather(1, sel[:, None])[:, 0]
    # Natural termination: no unexpanded candidate among the best ef.
    act = s.active & torch.isfinite(sel_d)
    sel_id = s.cand_i.gather(1, sel[:, None])[:, 0]
    col = torch.arange(s.cand_d.shape[1], device=sel.device)
    cand_exp = s.cand_exp | ((col[None, :] == sel[:, None]) & act[:, None])
    return sel_id.clamp_min(0), act, cand_exp


def frontier_topk(cand_d: torch.Tensor, cand_i: torch.Tensor,
                  cand_e: torch.Tensor, ef: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the best ef of the concatenated [B, ef + M] frontier, lower
    column first on a tie (``lax.top_k``'s order)."""
    vals, pos = torch.sort(cand_d, dim=1, stable=True)
    pos = pos[:, :ef]
    return vals[:, :ef], cand_i.gather(1, pos), cand_e.gather(1, pos)


def merge_expand(s: HNSWSearchState, cand_exp: torch.Tensor,
                 act: torch.Tensor, nbrs: torch.Tensor, dist: torch.Tensor,
                 visited: torch.Tensor, *, k: int) -> HNSWSearchState:
    """Merge one expansion's [B, M] candidates into the frontier and
    advance the counters. ``dist`` carries +inf for masked (invalid /
    already-seen) slots, so the finite count IS the number of new
    distance computations; tombstones (sqnorm +inf) count as none."""
    b, ef = s.cand_d.shape
    old_kth = s.cand_d[:, k - 1]
    cand_d = torch.cat([s.cand_d, dist], 1)
    cand_i = torch.cat([s.cand_i, nbrs], 1)
    cand_e = torch.cat([cand_exp, torch.zeros_like(nbrs, dtype=torch.bool)],
                       1)
    new_d, new_i, new_e = frontier_topk(cand_d, cand_i, cand_e, ef)

    ndis_inc = torch.isfinite(dist).sum(1, dtype=torch.int32)
    inserts = (dist < old_kth[:, None]).sum(1, dtype=torch.int32).clamp_max(k)
    zero = torch.zeros_like(ndis_inc)
    keep = act[:, None]
    return dataclasses.replace(
        s,
        cand_d=torch.where(keep, new_d, s.cand_d),
        cand_i=torch.where(keep, new_i, s.cand_i),
        cand_exp=torch.where(keep, new_e, cand_exp),
        visited=visited,
        active=act,
        ndis=s.ndis + torch.where(act, ndis_inc, zero),
        ninserts=s.ninserts + torch.where(act, inserts, zero),
        nstep=s.nstep + act.to(torch.int32),
    )


def beam_step(index: HNSWIndex, s: HNSWSearchState, *,
              k: int) -> HNSWSearchState:
    """Expand the closest unexpanded candidate of every active query.
    Marks the new neighbours in ``s.visited`` in place."""
    sel_id_safe, act, cand_exp = select_expand(s)

    nbrs = index.neighbors[sel_id_safe.long()]               # [B, M]
    valid = (nbrs >= 0) & act[:, None]
    nbrs_safe = nbrs.clamp_min(0).long()
    if s.visited.shape[1] < index.num_vectors:
        # Hashed visited filter: a colliding NEW node reads as seen.
        mark = hash_slot(nbrs_safe, s.visited.shape[1]).long()
    else:
        mark = nbrs_safe
    # Read before writing: two new neighbours that collide in the hashed
    # filter both count as new, as in the reference.
    seen = s.visited.gather(1, mark)
    new = valid & ~seen
    # OR-scatter of the valid marks (an invalid slot adds 0 at its mark):
    # a plain indexed write with duplicate indices would keep an
    # arbitrary one of them.
    s.visited.view(torch.uint8).scatter_reduce_(
        1, mark, valid.to(torch.uint8), "amax")

    vecs = index.vectors[nbrs_safe].float()                  # [B, M, D]
    dots = torch.bmm(vecs, s.q[:, :, None])[:, :, 0]
    dist = index.sqnorm[nbrs_safe] - 2.0 * dots + s.qsq
    dist = torch.where(new, torch.clamp_min(dist, 0.0), PAD_DIST)
    return merge_expand(s, cand_exp, act, nbrs, dist, s.visited, k=k)


def _drive(step, index: HNSWIndex, s: HNSWSearchState, k: int, limit: int
           ) -> Tuple[torch.Tensor, torch.Tensor, HNSWSearchState]:
    """Run a beam step to natural termination (or the step limit)."""
    t = 0
    while t < limit and bool(s.active.any()):
        s = step(index, s, k=k)
        t += 1
    d, i = s.topk(k)
    return d, i, s


def search(index: HNSWIndex, q: torch.Tensor, *, k: int, ef: int,
           max_steps: int = 0, visited_width: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor, HNSWSearchState]:
    """Plain HNSW search to natural termination."""
    return _drive(beam_step, index,
                  init_state(index, q, ef=ef, visited_width=visited_width),
                  k, max_steps or index.num_vectors)


def search_sharded(index, q: torch.Tensor, *, k: int, ef: int, mesh,
                   max_steps: int = 0, visited_width: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, HNSWSearchState]:
    """Plain HNSW search through the sharded beam step: ``index`` must be
    placed with ``dist.place_index(index, mesh)`` (vectors, sqnorm and
    neighbors split on the node dim over the ``"model"`` axis; the
    visited structure, exact bitmap or hashed filter, splits the same
    way). Equals ``search`` (ids, distances, ndis, ninserts, nstep) on
    any shard count; the step limit defaults to the padded N."""
    from repro_torch.dist import collectives  # dist imports this module

    init = collectives.make_sharded_hnsw_init(mesh)
    return _drive(collectives.make_sharded_beam_step(mesh), index,
                  init(index, q, ef=ef, visited_width=visited_width),
                  k, max_steps or index.num_vectors)
