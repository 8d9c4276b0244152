"""Int8 gradient compression with error feedback (a port of the
reference's ``repro/optim/grad_compress.py``): blockwise symmetric int8
quantization (256 values a block, scale max|x| / 127 + 1e-12; round half
to even, as ``jnp.round``), the roundtrip the wire carries, and
``compressed_grad_mean``, the data-parallel mean of compressed gradients
over named axes of a ``DeviceMesh`` (the reference's ``shard_map`` psum,
as functional all-reduces). ``train.step`` uses the roundtrip with error
feedback on one device."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.optim.tree import tree_map, unzip

BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: (q int8 [nblocks, BLOCK], scale f32
    [nblocks, 1]); the flattened x is padded with zeros to whole blocks."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                size: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:size].reshape(shape)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize (what the wire carries), f32."""
    q, s = _quantize(x)
    return _dequantize(q, s, x.shape, x.numel())


def compressed_grad_mean(grads: Any, error: Optional[Any], mesh,
                         axis_names: Sequence[str]) -> Tuple[Any, Any]:
    """Each rank's local gradients -> (their mean over the ``axis_names``
    dims of ``mesh``, in each leaf's dtype; the new error state, f32):
    per leaf, error feedback first (g in f32 + the carried error), then
    the int8 roundtrip, whose error is carried to the next step; the
    roundtrips are summed over each named mesh dim in turn
    (``_functional_collectives.all_reduce`` over ``(mesh, dim)``) and
    divided by the product of their sizes. ``error`` None means zeros."""
    import torch.distributed._functional_collectives as funcol
    names = tuple(mesh.mesh_dim_names)
    dims = [names.index(ax) for ax in axis_names]
    n = 1
    for d in dims:
        n *= mesh.size(d)
    if error is None:
        error = tree_map(torch.zeros_like, grads)

    def one(g, e):
        gf = g.float() + e
        sent = compress_roundtrip(gf)
        total = sent
        for d in dims:
            total = funcol.all_reduce(total, "sum", (mesh, d))
        return (total / n).to(g.dtype), gf - sent

    return unzip(tree_map(one, grads, error), 2)
