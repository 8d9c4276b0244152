"""Public kernel entry points: dispatch by the tensor's device.

A CUDA tensor launches the Hopper kernel (``kernels.cuda``) or the call
raises; a CPU tensor takes the plain PyTorch version (``kernels.ref``).
There is no fallback between them. The signatures, padding and bias
contract follow ``repro.kernels.ops``:

* ``l2_topk`` adds ``bias`` (default ``||q||^2``) after the kernel, clamps
  at 0 and returns +inf wherever the id is -1;
* ``gbdt_predict`` adds the ensemble's ``base``;
* ``bucket_probe`` returns the unclipped insert count.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.padding import PAD_DIST
from repro_torch.gbdt.model import GBDTParams
from repro_torch.kernels import cuda, ref


def l2_topk(q: torch.Tensor, x: torch.Tensor, *, k: int,
            x_sqnorm: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k nearest (squared L2): (f32[B, k] ascending, i32[B, k]);
    slots with no candidate hold (+inf, -1).

    ``bias`` [B, 1] is added to the kernel's ``x_sqnorm - 2 q.x``; it
    defaults to ``||q||^2``. The SQ8 asymmetric form passes ``q*scale`` as
    ``q``, int8 codes as ``x``, the dequantized sqnorms and
    ``bias = ||q||^2 - 2 q.offset``."""
    qf = q.float()
    if x_sqnorm is None:
        x_sqnorm = (x.float() ** 2).sum(1)
    if bias is None:
        bias = (qf ** 2).sum(1, keepdim=True)
    if q.is_cuda:
        d, i = cuda.l2_topk(qf.contiguous(), x.contiguous(),
                            x_sqnorm.float().contiguous(), k)
    else:
        d, i = ref.l2_topk_ref(qf, x, x_sqnorm, k)
    d = d + bias
    return torch.where(i >= 0, torch.clamp_min(d, 0.0), PAD_DIST), i


def gbdt_predict(params: GBDTParams, x: torch.Tensor) -> torch.Tensor:
    """Batched ensemble inference. x: f32[B, F] -> f32[B]."""
    if x.is_cuda:
        out = cuda.gbdt_predict(x.float().contiguous(), params.feat,
                                params.thresh, params.leaf)
    else:
        out = ref.gbdt_predict_ref(x.float(), params.feat, params.thresh,
                                   params.leaf)
    return params.base + out


def bucket_probe(q, vecs, sqn, ids, bias, kth, run_d, run_i):
    """Fused probe over pre-gathered buckets vecs [B, C, D]:
    dist = sqn - 2 q.vecs + bias (clamped, +inf where ids < 0) merged into
    the running top-k. Returns (dist [B, K], ids [B, K], i32[B] count of
    bucket distances strictly below kth [B, 1])."""
    if q.is_cuda:
        return cuda.bucket_probe(q, vecs, sqn, ids, bias, kth, run_d, run_i)
    return ref.bucket_probe_ref(q, vecs, sqn, ids, bias, kth, run_d, run_i)


def bucket_probe_slots(q, store_vecs, store_sqn, store_ids, slot, active,
                       bias, kth, run_d, run_i):
    """``bucket_probe`` where query b reads bucket ``slot[b]`` of the whole
    store [S, C, D]; an inactive query keeps its top-k and counts 0."""
    if q.is_cuda:
        return cuda.bucket_probe_slots(q, store_vecs, store_sqn, store_ids,
                                       slot, active, bias, kth, run_d, run_i)
    return ref.bucket_probe_slots_ref(q, store_vecs, store_sqn, store_ids,
                                      slot, active, bias, kth, run_d, run_i)


def bucket_topk(q, vecs, sqn, ids, run_d, run_i):
    """Fused IVF probe step with bias ``||q||^2`` and kth = run_d[:, -1]."""
    bias = (q.float() ** 2).sum(1, keepdim=True)
    d, i, _ = bucket_probe(q, vecs, sqn, ids, bias, run_d[:, -1:].contiguous(),
                           run_d, run_i)
    return d, i
