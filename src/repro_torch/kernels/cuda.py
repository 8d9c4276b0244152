"""ctypes wrappers of the Hopper kernels in ``csrc/``.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch returned a CUDA error, and adds one
to its entry in ``LAUNCHES``. Nothing else touches the counts, so a run
that reads them shows which kernels it went through.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}
MAX_K = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bucket_probe": ("bucket_probe_launch",
                     [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _P]),
    "l2_topk": ("l2_topk_launch",
                [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "gbdt_predict": ("gbdt_predict_launch",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}
_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    if name not in _FNS:
        symbol, argtypes = _SIGNATURES[name]
        f = getattr(_build.load(name), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[name] = f
    return _FNS[name]


def _need(t, what: str, device: torch.device, dtypes, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {list(dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernels' range [1, {MAX_K}]")


def _cuda_device(t) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors")
    return t.device


def l2_topk(q: torch.Tensor, x: torch.Tensor, x_sqnorm: torch.Tensor,
            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest of ``x_sqnorm - 2 q.x`` per row (see ref.l2_topk_ref).
    q f32[B, D]; x [N, D] f32/bf16/int8; x_sqnorm f32[N]."""
    dev = _cuda_device(q)
    b, d = q.shape
    n = x.shape[0]
    _check_k(k)
    _need(q, "q", dev, (torch.float32,), (b, d))
    _need(x, "x", dev, tuple(_DTYPE_CODE), (n, d))
    _need(x_sqnorm, "x_sqnorm", dev, (torch.float32,), (n,))
    if n < 1:
        raise ValueError("l2_topk: empty database")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    # Split the database over grid.y until ~2 blocks per SM are in flight.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qblocks = -(-b // 64)
    tiles = -(-n // 128)
    nsplit = max(1, min(tiles, -(-2 * sms // qblocks)))
    nsplit = -(-tiles // -(-tiles // nsplit))  # drop empty ranges
    part_d = part_i = None
    if nsplit > 1:
        part_d = torch.empty((nsplit, b, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((nsplit, b, k), dtype=torch.int32, device=dev)
    _launch("l2_topk", dev, q.data_ptr(), x.data_ptr(), _DTYPE_CODE[x.dtype],
            x_sqnorm.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            part_d.data_ptr() if part_d is not None else None,
            part_i.data_ptr() if part_i is not None else None,
            b, n, d, k, nsplit)
    return out_d, out_i


def _bucket(q, vecs, sqn, ids, slot, active, bias, kth, run_d, run_i):
    dev = _cuda_device(q)
    b, d = q.shape
    c = vecs.shape[1]
    k = run_d.shape[1]
    _check_k(k)
    rows = vecs.shape[0]
    _need(q, "q", dev, (torch.float32,), (b, d))
    _need(vecs, "vecs", dev, tuple(_DTYPE_CODE), (rows, c, d))
    _need(sqn, "sqn", dev, (torch.float32,), (rows, c))
    _need(ids, "ids", dev, (torch.int32,), (rows, c))
    _need(bias, "bias", dev, (torch.float32,), (b, 1))
    _need(kth, "kth", dev, (torch.float32,), (b, 1))
    _need(run_d, "run_d", dev, (torch.float32,), (b, k))
    _need(run_i, "run_i", dev, (torch.int32,), (b, k))
    if slot is not None:
        _need(slot, "slot", dev, (torch.int32,), (b,))
        _need(active, "active", dev, (torch.bool,), (b,))
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_c = torch.empty((b,), dtype=torch.int32, device=dev)
    vec_path = int(d * vecs.element_size() % 16 == 0
                   and vecs.data_ptr() % 16 == 0)
    _launch("bucket_probe", dev, q.data_ptr(), vecs.data_ptr(),
            _DTYPE_CODE[vecs.dtype], sqn.data_ptr(), ids.data_ptr(),
            slot.data_ptr() if slot is not None else None,
            active.data_ptr() if active is not None else None,
            bias.data_ptr(), kth.data_ptr(), run_d.data_ptr(),
            run_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            out_c.data_ptr(), b, c, d, k, vec_path)
    return out_d, out_i, out_c


def bucket_probe(q, vecs, sqn, ids, bias, kth, run_d, run_i):
    """Pre-gathered entry point (see ref.bucket_probe_ref): vecs [B, C, D]."""
    if vecs.shape[0] != q.shape[0]:
        raise ValueError(f"vecs holds {vecs.shape[0]} buckets for "
                         f"{q.shape[0]} queries")
    return _bucket(q, vecs, sqn, ids, None, None, bias, kth, run_d, run_i)


def bucket_probe_slots(q, store_vecs, store_sqn, store_ids,
                       slot: torch.Tensor, active: torch.Tensor,
                       bias, kth, run_d, run_i):
    """Store entry point (see ref.bucket_probe_slots_ref): query b reads
    bucket slot[b] of store_vecs [S, C, D]; inactive queries read none.
    Slots must lie in [0, S): the kernel does not check them."""
    return _bucket(q, store_vecs, store_sqn, store_ids, slot, active, bias,
                   kth, run_d, run_i)


def gbdt_predict(x: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                 leaf: torch.Tensor) -> torch.Tensor:
    """Leaf sum over the ensemble (see ref.gbdt_predict_ref); feature
    indices must be < F (RecallPredictor checks once)."""
    dev = _cuda_device(x)
    b, f = x.shape
    t, n_int = feat.shape
    depth = (n_int + 1).bit_length() - 1
    if n_int != 2**depth - 1:
        raise ValueError(f"feat has {n_int} internal nodes, not 2^d - 1")
    _need(x, "x", dev, (torch.float32,), (b, f))
    _need(feat, "feat", dev, (torch.int32,), (t, n_int))
    _need(thresh, "thresh", dev, (torch.float32,), (t, n_int))
    _need(leaf, "leaf", dev, (torch.float32,), (t, n_int + 1))
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    _launch("gbdt_predict", dev, x.data_ptr(), feat.data_ptr(),
            thresh.data_ptr(), leaf.data_ptr(), out.data_ptr(), b, f, t,
            depth)
    return out
