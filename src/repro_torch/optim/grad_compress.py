"""Int8 gradient compression with error feedback (a port of the
reference's ``repro/optim/grad_compress.py``): blockwise symmetric int8
quantization (256 values a block, scale max|x| / 127 + 1e-12; round half
to even, as ``jnp.round``) and the roundtrip the wire carries. The
reference's ``compressed_grad_mean`` (a ``shard_map`` psum over the
data-parallel axes) waits for the multi-device tooling (ROADMAP Queue 1
item 4.5); ``train.step`` uses the roundtrip with error feedback on one
device."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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
