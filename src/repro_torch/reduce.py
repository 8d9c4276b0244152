"""Sums by index that repeat bit for bit on the card.

``index_add_`` on a CUDA tensor adds floats with atomics, in whatever
order the threads arrive, so the same inputs can give sums that differ
in their last bits from one call to the next. The GBDT fit's histograms
and leaves, the Lloyd step's sums and the gradients of gathered rows
(the LM's embedding and MoE dispatch, ``gather_rows``) go through
``index_sum`` instead.

On the card it rounds every value to a 64-bit integer fixed point whose
scale leaves room for the largest possible sum, adds the integers (exact,
so the order does not matter) and converts back. Each value is rounded
to a multiple of 2^-62 times the bound, far below float32's precision,
so the result is the exact sum rounded to float32 but for rare ties.
On the CPU it is ``index_add_`` itself, which adds in row order, so the
port's CPU results (held equal to the reference's) keep every bit.
"""
from __future__ import annotations

import torch


def index_sum(index: torch.Tensor, values: torch.Tensor,
              size: int) -> torch.Tensor:
    """``zeros(size, ...).index_add_(0, index, values)`` for float32
    values, in a fixed order on the card (fixed-point sums) and in row
    order on the CPU."""
    if values.is_cuda:
        return fixed_point_index_sum(index, values, size)
    out = values.new_zeros((size,) + tuple(values.shape[1:]))
    return out.index_add_(0, index, values)


def fixed_point_index_sum(index: torch.Tensor, values: torch.Tensor,
                          size: int) -> torch.Tensor:
    """Rows of ``values`` summed into ``size`` rows by ``index`` through
    int64 fixed point, on any device. No host sync: the scale is a device
    scalar. With 2^e > rows * max|v|, the scale 2^(62 - e) keeps every
    partial sum below 2^62 in magnitude."""
    v = values.double()
    shape = (size,) + tuple(values.shape[1:])
    if v.numel() == 0:
        return values.new_zeros(shape)
    _, e = torch.frexp(v.abs().amax() * v.shape[0])
    scale = torch.ldexp(torch.ones((), dtype=torch.float64,
                                   device=v.device), 62 - e)
    fixed = torch.round(v * scale).to(torch.int64)
    acc = torch.zeros(shape, dtype=torch.int64,
                      device=v.device).index_add_(0, index, fixed)
    return (acc.double() / scale).to(values.dtype)


class _GatherRows(torch.autograd.Function):
    """``src[index]`` whose backward sums the rows that share an index
    through ``index_sum``: a fixed order on the card, row order on the
    CPU. (``torch.gather``'s backward is a ``scatter_add``, float atomics
    on the card wherever an index repeats; ``F.embedding``'s order is its
    kernel's to choose.)"""

    @staticmethod
    def forward(ctx, src, index):
        ctx.save_for_backward(index)
        ctx.rows = src.shape[0]
        return src[index]

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        flat = index.reshape(-1)
        rows = grad.reshape((flat.shape[0],) + tuple(grad.shape[index.dim():]))
        return index_sum(flat, rows, ctx.rows), None


def gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows of ``src`` by ``index`` (any shape of integers): ``src[index]``,
    [*index.shape, *src.shape[1:]]. Its gradient repeats bit for bit on
    the card (``_GatherRows``)."""
    return _GatherRows.apply(src, index)
