"""Per-device op accounting for the dry run: the counterpart of the
reference's ``repro/utils/hlo.py``.

The reference parses the post-SPMD HLO text of a compiled program:
FLOPs of every dot, HBM bytes of every top-level instruction and the
result bytes of every collective, each weighted by the trip counts of
the while loops around it. PyTorch has no HLO, and no HLO text is parsed
here. Instead ``OpCount``, one ``TorchDispatchMode``, counts the ops a
traced program runs on one rank, as they run:

- flops: FlopCounterMode's formulas (``torch.utils.flop_counter``), per
  op, on the local shards' shapes;
- bytes: each op's tensor inputs read once and its outputs written once,
  skipping what moves no data (views, metadata, allocations, waits: the
  counterparts of the reference's parameter, constant, tuple,
  get-tuple-element, bitcast and reshape);
- collectives: the result bytes of each ``_c10d_functional`` collective,
  under the reference's ``COLLECTIVES`` names (all_reduce -> all-reduce,
  all_gather_into_tensor -> all-gather, reduce_scatter_tensor ->
  reduce-scatter, all_to_all_single -> all-to-all).

A loop is counted by running it: an op inside a 5-trip loop is counted 5
times, which is what the reference's trip-count weighting approximates.
A DTensor op is let through (``NotImplemented``) and counted as the
local ops DTensor runs for it. DTensor's sharding propagation runs each
new (op, placements) once on global shapes, under the active fake mode
on some torch versions; those ops are not the program's, and
``in_propagation`` tells them apart by the call stack (``OpCount``
skips them, and so does the dry run's ``MemTracker``).
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op name (its overload packet's last part) -> the
# reference's HLO collective name.
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# Ops that move no data: allocations, metadata and waits.
_NO_BYTES = frozenset({
    "empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
    "device", "layout", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_to_copy_meta",
})


_PROPAGATION_FILE = os.path.join("distributed", "tensor", "_sharding_prop.py")


def in_propagation() -> bool:
    """Whether the op being dispatched runs inside DTensor's sharding
    propagation (its ``_sharding_prop`` module is on the call stack)."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        frame = frame.f_back
    return False


def _bytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


class OpCount(TorchDispatchMode):
    """Counts the flops, bytes and collective bytes of every op run on
    this rank while the mode is active (module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.num_collectives = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func.namespace == "prim":       # metadata (.device): no work
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not in_propagation():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        if packet in self._formulas:
            self.flops += float(self._formulas[packet](*args, **kwargs,
                                                       out_val=out))
        kind = (_COLLECTIVE_OPS.get(name)
                if func.namespace in ("_c10d_functional",
                                      "_c10d_functional_autograd") else None)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if kind is not None:
            self.collectives[kind] += float(sum(_bytes(t) for t in outs))
            self.num_collectives += 1
        if func.is_view or name in _NO_BYTES:
            return
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.bytes += float(sum(_bytes(t) for t in ins + outs))

    def result(self) -> Dict[str, float]:
        """The reference's ``hlo.analyze`` keys: "flops", "hbm_bytes",
        each collective's bytes, "num_ops" (collectives) and "total"."""
        out = dict(self.collectives)
        out["num_ops"] = self.num_collectives
        out["total"] = sum(self.collectives.values())
        out["flops"] = self.flops
        out["hbm_bytes"] = self.bytes
        return out


@contextlib.contextmanager
def cached_planning():
    """While the block runs, DTensor plans each redistribution and
    propagates each (op, placements) once and reuses the result, as it
    does in an eager run: under a fake mode it takes itself to be
    compiling and redoes both at every op."""
    from torch.distributed.tensor import _dispatch, _redistribute
    tracing = [(m, m._are_we_tracing) for m in (_dispatch, _redistribute)
               if hasattr(m, "_are_we_tracing")]
    for m, _ in tracing:
        m._are_we_tracing = lambda: False
    try:
        yield
    finally:
        for m, fn in tracing:
            m._are_we_tracing = fn
