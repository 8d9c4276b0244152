"""Carry the JAX reference's objects across, as numpy arrays.

The reference hands its arrays over with ``np.asarray`` (nothing here
imports it); these functions turn them into the port's objects on a
given device, so the two packages can be given the same index, the same
predictor, the same LM weights and the same optimizer state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.predictor import RecallPredictor
from repro_torch.core.training import TrainedDarth
from repro_torch.gbdt.model import GBDTParams, from_state_dict
from repro_torch.index.hnsw import HNSWIndex
from repro_torch.index.ivf import IVFIndex
from repro_torch.models import model_zoo

_IVF_DTYPES = {
    "centroids": (np.float32,),
    "bucket_vecs": (np.float32, np.int8),
    "bucket_ids": (np.int32,),
    "bucket_sqnorm": (np.float32,),
    "bucket_sizes": (np.int32,),
    "scale": (np.float32,),
    "offset": (np.float32,),
    "hot_map": (np.int32,),
}
_HNSW_DTYPES = {
    "vectors": (np.float32, np.int8),
    "sqnorm": (np.float32,),
    "neighbors": (np.int32,),
    "entry": (np.int32,),
    "route_ids": (np.int32,),
    "scale": (np.float32,),
    "offset": (np.float32,),
}


def fields_as_numpy(obj: Any) -> Dict[str, np.ndarray]:
    """The set fields of one of the reference's dataclasses (an index), as
    numpy arrays by name: what the index loaders below take."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _tensors(arrays: Mapping[str, Any], dtypes: Mapping[str, tuple],
             optional: tuple, what: str, device) -> Dict[str, torch.Tensor]:
    """The named arrays as tensors on ``device``, each dtype checked; an
    ``optional`` field may be missing or None."""
    fields = {}
    for name, allowed in dtypes.items():
        v = arrays.get(name)
        if v is None:
            if name not in optional:
                raise KeyError(f"{what} array {name!r} missing")
            continue
        v = np.asarray(v)
        if v.dtype not in [np.dtype(t) for t in allowed]:
            raise TypeError(f"{name}: dtype {v.dtype} not in {allowed}")
        fields[name] = torch.as_tensor(np.array(v), device=device)
    return fields


def ivf_index_from_numpy(arrays: Mapping[str, Any], device="cuda"
                         ) -> IVFIndex:
    """An IVFIndex from the reference's fields (``dataclasses.asdict`` of
    ``repro.index.ivf.IVFIndex`` after ``np.asarray``). dtypes are kept:
    f32 or int8 (SQ8) codes, int32 ids and sizes."""
    return IVFIndex(**_tensors(arrays, _IVF_DTYPES, ("hot_map",), "IVF index",
                               device))


def hnsw_index_from_numpy(arrays: Mapping[str, Any], device="cuda"
                          ) -> HNSWIndex:
    """An HNSWIndex from the reference's fields (``repro.index.hnsw.
    HNSWIndex`` after ``np.asarray``): f32 or int8 (SQ8) vectors, int32
    adjacency, entry and routing sample. ``scale``/``offset`` are None for
    f32 vectors and required for int8 codes."""
    fields = _tensors(arrays, _HNSW_DTYPES, ("scale", "offset"), "HNSW index",
                      device)
    if fields["vectors"].dtype == torch.int8 and (
            "scale" not in fields or "offset" not in fields):
        raise KeyError("HNSW index: int8 vectors need scale and offset")
    return HNSWIndex(**fields)


def gbdt_params_from_numpy(state_dict: Mapping[str, Any], device="cuda"
                           ) -> GBDTParams:
    """GBDTParams from ``repro.gbdt.to_state_dict`` (same keys, dtypes)."""
    return from_state_dict(dict(state_dict), device=device)


def trained_from_numpy(state_dict: Mapping[str, Any],
                       dists_rt: Dict[float, float], device="cuda"
                       ) -> TrainedDarth:
    """A TrainedDarth around the reference's fitted predictor and its
    dists_Rt table, ready for ``Darth(trained=...)``."""
    return TrainedDarth(
        predictor=RecallPredictor(gbdt_params_from_numpy(state_dict, device)),
        dists_rt={float(k): float(v) for k, v in dists_rt.items()},
        metrics={}, train_seconds=0.0, num_samples=0)


def _lm_leaf(v, want: torch.dtype, name: str) -> torch.Tensor:
    """One LM leaf as a CPU tensor. A bf16 array from the reference has
    ml_dtypes' ``bfloat16`` dtype, which ``torch.from_numpy`` refuses: it
    is taken by its bits (an int16 view), so nothing here needs
    ml_dtypes."""
    v = np.ascontiguousarray(v)
    if v.dtype.name == "bfloat16":
        t = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    elif v.dtype == np.float32:
        t = torch.from_numpy(v.copy())
    else:
        raise TypeError(f"{name}: dtype {v.dtype}, expected f32 or bf16")
    if t.dtype != want:
        raise TypeError(f"{name}: dtype {t.dtype}, the model stores {want}")
    return t


def lm_params(tree: Mapping[str, Any], cfg, device="cuda"
              ) -> Dict[str, Any]:
    """The reference's LM parameter tree (nested dicts of numpy arrays:
    ``jax.tree.map(np.asarray, params)``) as the port's, on ``device``,
    under the same names. Every leaf's shape is checked against
    ``model_zoo.param_shapes(cfg)`` and its dtype against
    ``param_dtype(cfg)``; a missing, extra or misshapen leaf raises."""
    shapes = dict(model_zoo.leaves(model_zoo.param_shapes(cfg)))
    got = dict(model_zoo.leaves(tree))
    missing = sorted(set(shapes) - set(got))
    extra = sorted(set(got) - set(shapes))
    if missing or extra:
        raise KeyError(f"LM parameters: missing {missing}, extra {extra}")
    want = model_zoo.param_dtype(cfg)
    out: Dict[str, Any] = {}
    for path, shape in shapes.items():
        name = "/".join(path)
        if tuple(np.shape(got[path])) != tuple(shape):
            raise ValueError(f"{name}: shape {np.shape(got[path])}, "
                             f"expected {shape}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _lm_leaf(got[path], want, name).to(device)
    return out


_OPT_DTYPES = {np.dtype(np.float32): torch.float32,
               np.dtype(np.int32): torch.int32}


def _opt_leaf(v, like: torch.Tensor, name: str) -> torch.Tensor:
    v = np.array(v)                  # a contiguous copy, 0-d kept 0-d
    if tuple(v.shape) != tuple(like.shape):
        raise ValueError(f"{name}: shape {v.shape}, expected "
                         f"{tuple(like.shape)}")
    if v.dtype.name == "bfloat16":            # by its bits, as _lm_leaf
        t = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    elif v.dtype in _OPT_DTYPES:
        t = torch.from_numpy(v)
    else:
        raise TypeError(f"{name}: dtype {v.dtype}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the port keeps "
                        f"{like.dtype}")
    return t.to(like.device)


def opt_state(tree: Mapping[str, Any], like: Mapping[str, Any],
              path: str = "") -> Dict[str, Any]:
    """The reference's optimizer state (``jax.tree.map(np.asarray,
    state)``: AdamW's ``m`` / ``v`` / ``step``, Adafactor's ``leaves`` /
    ``step``, and ``ef`` with compressed gradients) as the port's, on
    ``like``'s devices. ``like`` is the port's state of the same
    optimizer (``make_train_step(...)[0](params)``): every key, shape
    and dtype must match it; a missing or extra key raises."""
    if set(tree) != set(like):
        raise KeyError(f"optimizer state {path or '/'}: keys "
                       f"{sorted(tree)}, expected {sorted(like)}")
    out: Dict[str, Any] = {}
    for k, want in like.items():
        name = f"{path}/{k}" if path else k
        out[k] = (opt_state(tree[k], want, name) if isinstance(want, dict)
                  else _opt_leaf(tree[k], want, name))
    return out
