"""IVF index with a step-wise probe API (the shape DARTH drives).

Bucket-major padded storage ``[nlist, cap, D]``: every probe step reads one
bucket per active query through the fused ``bucket_probe`` kernel, which
gathers the bucket itself from the store.

The probe loop exposes exactly the counters DARTH's features need:
``ndis`` advances by the *true* bucket population (padding excluded),
``probe_pos`` is the probe number, ``first_nn`` is the distance to the
nearest centroid (paper §3.3.2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM, pad_dists, pad_ids
from repro_torch.index import kmeans as kmeans_lib
from repro_torch.kernels import ops


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor      # f32[nlist, D]
    bucket_vecs: torch.Tensor    # f32|int8[nlist, cap, D] (zero padded)
    bucket_ids: torch.Tensor     # i32[nlist, cap] (-1 padding)
    bucket_sqnorm: torch.Tensor  # f32[nlist, cap] (+inf padding), of the
    #                              DEQUANTIZED vectors when SQ8
    bucket_sizes: torch.Tensor   # i32[nlist]
    # SQ8 affine dequant (x_hat = scale * x8 + offset, per dim); identity
    # (ones/zeros) for f32 storage.
    scale: torch.Tensor          # f32[D]
    offset: torch.Tensor         # f32[D]
    # The reference's cold-tier indirection; this port does not serve a
    # cold tier yet, and init_state / probe_step raise when it is set.
    hot_map: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.bucket_vecs.dtype == torch.int8

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.bucket_vecs.shape[1]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def num_vectors(self) -> int:
        return int(self.bucket_sizes.sum())


def quantize_sq8(x: np.ndarray, scale: np.ndarray, offset: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-dim affine SQ8: returns (int8 codes, dequantized f32,
    clipped-value count). Values outside the range are clamped to it."""
    raw = np.round((x - offset) / scale)
    nclipped = int(np.count_nonzero((raw < -127.0) | (raw > 127.0)))
    x8 = np.clip(raw, -127, 127).astype(np.int8)
    return x8, x8.astype(np.float32) * scale + offset, nclipped


def pack_buckets(x_store: np.ndarray, x_deq: np.ndarray, ids: np.ndarray,
                 assign: np.ndarray, nlist: int, *, cap_round: int = 8
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bucket-major padded layout from precomputed assignments.

    cap = max bucket size rounded up to cap_round; padded slots carry
    vecs 0 / ids -1 / sqnorm +inf. Returns (bucket_vecs, bucket_ids,
    bucket_sqnorm, sizes)."""
    gen = pack_buckets_steps(x_store, x_deq, ids, assign, nlist,
                             cap_round=cap_round)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def pack_buckets_steps(x_store: np.ndarray, x_deq: np.ndarray,
                       ids: np.ndarray, assign: np.ndarray, nlist: int, *,
                       cap_round: int = 8, chunk: int = 64):
    """Incremental pack_buckets: yields after each ``chunk`` of buckets and
    returns (bucket_vecs, bucket_ids, bucket_sqnorm, sizes) via
    StopIteration.value."""
    d = x_store.shape[1]
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=nlist)
    cap = int(max(8, -(-int(max(sizes.max(), 1)) // cap_round) * cap_round))
    bucket_vecs = np.zeros((nlist, cap, d), x_store.dtype)
    bucket_ids = np.full((nlist, cap), PAD_ID, np.int32)
    bucket_sqnorm = np.full((nlist, cap), PAD_SQNORM, np.float32)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for c0 in range(0, nlist, chunk):
        for c in range(c0, min(nlist, c0 + chunk)):
            sz = int(sizes[c])
            sel = order[starts[c]:starts[c] + sz]
            bucket_vecs[c, :sz] = x_store[sel]
            bucket_ids[c, :sz] = ids[sel]
            bucket_sqnorm[c, :sz] = (x_deq[sel] ** 2).sum(axis=1)
        yield
    return bucket_vecs, bucket_ids, bucket_sqnorm, sizes.astype(np.int32)


def build(x: np.ndarray, nlist: int, *, iters: int = 15, seed: int = 0,
          cap_round: int = 8, quantize: bool = False,
          device="cuda") -> IVFIndex:
    """Cluster on ``device`` + bucket-major layout. cap = max bucket size
    rounded up. quantize=True stores per-dim affine int8 codes, with
    bucket_sqnorm of the dequantized vectors."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    xt = torch.as_tensor(x, device=device)
    cents = kmeans_lib.kmeans(xt, nlist, iters=iters, seed=seed)
    a = kmeans_lib.assign(xt, cents).cpu().numpy()
    del xt

    if quantize:
        lo = x.min(axis=0)
        hi = x.max(axis=0)
        scale = np.maximum((hi - lo) / 254.0, 1e-12).astype(np.float32)
        offset = ((hi + lo) / 2.0).astype(np.float32)
        x_store, x_deq, _ = quantize_sq8(x, scale, offset)
    else:
        scale = np.ones((d,), np.float32)
        offset = np.zeros((d,), np.float32)
        x_store = x
        x_deq = x

    bucket_vecs, bucket_ids, bucket_sqnorm, sizes = pack_buckets(
        x_store, x_deq, np.arange(n, dtype=np.int32), a, nlist,
        cap_round=cap_round)

    def t(v):
        return torch.as_tensor(v, device=device)
    return IVFIndex(centroids=cents, bucket_vecs=t(bucket_vecs),
                    bucket_ids=t(bucket_ids), bucket_sqnorm=t(bucket_sqnorm),
                    bucket_sizes=t(sizes), scale=t(scale), offset=t(offset))


@dataclasses.dataclass
class IVFSearchState:
    q: torch.Tensor            # f32[B, D]
    qsq: torch.Tensor          # f32[B, 1]
    probe_order: torch.Tensor  # i32[B, nprobe] ranked centroids
    first_nn: torch.Tensor     # f32[B] distance to nearest centroid
    probe_pos: torch.Tensor    # i32[B] next probe
    topk_d: torch.Tensor       # f32[B, K] ascending (inf = empty)
    topk_i: torch.Tensor       # i32[B, K] (-1 = empty)
    active: torch.Tensor       # bool[B]
    ndis: torch.Tensor         # i32[B] true distance calcs so far
    ninserts: torch.Tensor     # i32[B] result-set updates so far


def _no_cold_tier(index: IVFIndex) -> None:
    if index.hot_map is not None:
        raise NotImplementedError(
            "IVFIndex.hot_map (the cold bucket tier) is not ported yet")


def rank_centroids(centroids: torch.Tensor, qf: torch.Tensor,
                   qsq: torch.Tensor, nprobe: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nprobe closest centroids per query (lowest index first on a
    tie, as lax.top_k) and the first-NN distance feature."""
    cd = (centroids ** 2).sum(1)[None, :] - 2.0 * (qf @ centroids.T)
    vals, order = torch.sort(cd, dim=1, stable=True)
    first_nn = torch.sqrt(torch.clamp_min(vals[:, 0] + qsq[:, 0], 0.0))
    return order[:, :nprobe].to(torch.int32).contiguous(), first_nn


def fresh_state(qf: torch.Tensor, qsq: torch.Tensor, order: torch.Tensor,
                first_nn: torch.Tensor, k: int) -> IVFSearchState:
    """Assemble the start-of-search state around a ranked probe order."""
    b, dev = qf.shape[0], qf.device
    return IVFSearchState(
        q=qf, qsq=qsq, probe_order=order, first_nn=first_nn,
        probe_pos=torch.zeros((b,), dtype=torch.int32, device=dev),
        topk_d=pad_dists((b, k), dev),
        topk_i=pad_ids((b, k), dev),
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        ndis=torch.zeros((b,), dtype=torch.int32, device=dev),
        ninserts=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


def init_state(index: IVFIndex, q: torch.Tensor, *, k: int,
               nprobe: int) -> IVFSearchState:
    _no_cold_tier(index)
    qf = q.float().contiguous()
    qsq = (qf ** 2).sum(1, keepdim=True)
    order, first_nn = rank_centroids(index.centroids, qf, qsq, nprobe)
    return fresh_state(qf, qsq, order, first_nn, k)


def probe_step(index: IVFIndex, s: IVFSearchState) -> IVFSearchState:
    """Scan one bucket per active query; merge the top-k; bump counters.

    Inactive queries keep their state and read no bucket."""
    _no_cold_tier(index)
    k = s.topk_d.shape[1]
    nprobe = s.probe_order.shape[1]
    pos = s.probe_pos.clamp_max(nprobe - 1)
    bucket = torch.gather(s.probe_order, 1, pos[:, None].long())[:, 0]
    sizes = index.bucket_sizes[bucket.long()]   # full per-bucket sizes

    if index.quantized:
        # asymmetric SQ8 via the kernel's bias term:
        # ||x_hat - q||^2 = sqn - 2[(q*scale).x8 + q.offset] + ||q||^2
        q_eff = s.q * index.scale[None, :]
        bias = s.qsq - 2.0 * (s.q @ index.offset)[:, None]
    else:
        q_eff = s.q
        bias = s.qsq
    new_d, new_i, cnt = ops.bucket_probe_slots(
        q_eff.contiguous(), index.bucket_vecs, index.bucket_sqnorm,
        index.bucket_ids, bucket.contiguous(), s.active, bias.contiguous(),
        s.topk_d[:, -1:].contiguous(), s.topk_d, s.topk_i)
    inserts = cnt.clamp_max(k)   # the kernel's count is unclipped
    zero = torch.zeros_like(sizes)
    done_probes = s.probe_pos + s.active.to(torch.int32)
    return IVFSearchState(
        q=s.q, qsq=s.qsq, probe_order=s.probe_order, first_nn=s.first_nn,
        probe_pos=done_probes,
        topk_d=new_d, topk_i=new_i,
        active=s.active & (done_probes < nprobe),
        ndis=s.ndis + torch.where(s.active, sizes, zero),
        ninserts=s.ninserts + torch.where(s.active, inserts, zero),
    )


def search(index: IVFIndex, q: torch.Tensor, *, k: int, nprobe: int
           ) -> Tuple[torch.Tensor, torch.Tensor, IVFSearchState]:
    """Plain (no early termination) IVF search: scan all nprobe buckets."""
    s = init_state(index, q, k=k, nprobe=nprobe)
    while bool(s.active.any()):
        s = probe_step(index, s)
    return s.topk_d, s.topk_i, s
