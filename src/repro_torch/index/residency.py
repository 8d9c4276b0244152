"""Compact index residency: SQ8 views, f32 re-rank, byte accounting.

The port of the reference's ``index/residency.py``:

  * device memory holds the SQ8 view of the vector payload — per-dim
    affine int8 codes (4x smaller than f32) searched with asymmetric
    distances (f32 query vs dequantized codes), which both engines and
    the ``bucket_probe`` kernel serve;
  * host memory holds the exact f32 vectors (`RerankStore`) used to
    re-rank the final over-provisioned top-k;
  * `resident_bytes` is the byte accounting of an index view.

Conversion is host-side numpy, as in the reference: `quantize_ivf` /
`quantize_hnsw` copy the payload to the host, derive the per-dim range
from the live rows and return a same-shape index whose payload is int8,
on the device the input index lies on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.padding import PAD_DIST, PAD_ID, PAD_SQNORM
from repro_torch.index import hnsw as hnsw_lib
from repro_torch.index import ivf as ivf_lib

AnyIndex = Union[ivf_lib.IVFIndex, hnsw_lib.HNSWIndex]


def sq8_range(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dim affine SQ8 range of ``x`` [L, D]: (scale, offset) such
    that the observed min/max map to the int8 code range [-127, 127]."""
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    scale = np.maximum((hi - lo) / 254.0, 1e-12).astype(np.float32)
    offset = ((hi + lo) / 2.0).astype(np.float32)
    return scale, offset


def quantize_ivf(index: ivf_lib.IVFIndex) -> ivf_lib.IVFIndex:
    """SQ8-resident view of an f32 IVF index (bucket layout, ids and
    sizes unchanged; bucket_sqnorm recomputed on the dequantized codes
    so served distances match what the quantized search measures)."""
    if index.quantized:
        return index
    bv = index.bucket_vecs.cpu().numpy().astype(np.float32, copy=False)
    bi = index.bucket_ids.cpu().numpy()
    live = bi >= 0
    scale, offset = sq8_range(bv[live])
    codes_live, deq_live, _ = ivf_lib.quantize_sq8(bv[live], scale, offset)
    codes = np.zeros(bv.shape, np.int8)
    codes[live] = codes_live
    sqn = np.full(bi.shape, PAD_SQNORM, np.float32)
    sqn[live] = (deq_live ** 2).sum(axis=1)

    def t(v):
        return torch.as_tensor(v, device=index.device)
    return dataclasses.replace(
        index, bucket_vecs=t(codes), bucket_sqnorm=t(sqn),
        scale=t(scale), offset=t(offset))


def quantize_hnsw(index: hnsw_lib.HNSWIndex) -> hnsw_lib.HNSWIndex:
    """SQ8-resident view of an f32 HNSW graph (adjacency, entry and
    routing sample unchanged; dead rows keep sqnorm +inf)."""
    if index.quantized:
        return index
    x = index.vectors.cpu().numpy().astype(np.float32, copy=False)
    sq = index.sqnorm.cpu().numpy()
    live = np.isfinite(sq)
    scale, offset = sq8_range(x[live] if live.any() else x)
    codes, deq, _ = ivf_lib.quantize_sq8(x, scale, offset)
    sqn = np.where(live, (deq ** 2).sum(axis=1),
                   PAD_SQNORM).astype(np.float32)

    def t(v):
        return torch.as_tensor(v, device=index.device)
    return dataclasses.replace(
        index, vectors=t(codes), sqnorm=t(sqn),
        scale=t(scale), offset=t(offset))


def resident_bytes(index: AnyIndex) -> Dict[str, int]:
    """Per-array device-resident bytes of an index view, plus "total":
    ``prod(shape) * itemsize`` of every tensor field, as the reference
    counts them. A placed index's sharded field (a tuple of per-shard
    tensors) counts as the sum of its shards, as the reference counts a
    sharded global array."""
    out: Dict[str, int] = {}
    total = 0
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        parts = v if isinstance(v, tuple) else (v,)
        if not parts or not all(isinstance(t, torch.Tensor) for t in parts):
            continue
        nbytes = sum(int(np.prod(tuple(t.shape))) * t.element_size()
                     for t in parts)
        out[f.name] = nbytes
        total += nbytes
    out["total"] = total
    return out


@dataclasses.dataclass
class RerankStore:
    """Host-memory exact f32 vectors for final-top-k re-ranking.

    Row index == global vector id (the id space both engines report).
    The store never ships to the device: candidates come back from the
    SQ8 search over-provisioned (k' = margin * k), the store re-ranks
    them exactly and returns the final k."""

    vectors: np.ndarray   # f32[N, D]

    def __post_init__(self):
        self.vectors = np.asarray(self.vectors, np.float32)

    def rerank(self, q: np.ndarray, ids: np.ndarray, k: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact squared-L2 re-rank of candidate ``ids`` for query
        ``q``; returns (dist f32[k], ids i32[k]) ascending with the
        repo's pad convention (+inf / -1) for missing candidates.
        ``k=0`` keeps the candidate count."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        k = int(k) or ids.size
        valid = (ids >= 0) & (ids < self.vectors.shape[0])
        v = self.vectors[np.clip(ids, 0, self.vectors.shape[0] - 1)]
        q = np.asarray(q, np.float32).reshape(-1)
        d = ((v - q[None, :]) ** 2).sum(axis=1).astype(np.float32)
        d = np.where(valid, d, PAD_DIST)
        order = np.argsort(d, kind="stable")[:k]
        out_d = np.full((k,), PAD_DIST, np.float32)
        out_i = np.full((k,), PAD_ID, np.int32)
        out_d[:order.size] = d[order]
        out_i[:order.size] = np.where(np.isfinite(d[order]), ids[order],
                                      PAD_ID).astype(np.int32)
        return out_d, out_i

    def reranker(self, k: int):
        """Bind ``k``: returns the (q, ids) -> (d, i) callable shape
        DarthServer's ``rerank=`` hook expects."""
        return lambda q, ids: self.rerank(q, ids, k)
