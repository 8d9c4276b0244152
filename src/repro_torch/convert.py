"""Carry the JAX reference's objects across, as numpy arrays.

The reference hands its arrays over with ``np.asarray`` (nothing here
imports it); these functions turn them into the port's objects on a
given device, so the two packages can be given the same index and the
same predictor.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.predictor import RecallPredictor
from repro_torch.core.training import TrainedDarth
from repro_torch.gbdt.model import GBDTParams, from_state_dict
from repro_torch.index.ivf import IVFIndex

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


def ivf_index_from_numpy(arrays: Mapping[str, Any], device="cuda"
                         ) -> IVFIndex:
    """An IVFIndex from the reference's fields (``dataclasses.asdict`` of
    ``repro.index.ivf.IVFIndex`` after ``np.asarray``). dtypes are kept:
    f32 or int8 (SQ8) codes, int32 ids and sizes."""
    fields = {}
    for name, dtypes in _IVF_DTYPES.items():
        v = arrays.get(name)
        if v is None:
            if name != "hot_map":
                raise KeyError(f"IVF index array {name!r} missing")
            continue
        v = np.asarray(v)
        if v.dtype not in [np.dtype(t) for t in dtypes]:
            raise TypeError(f"{name}: dtype {v.dtype} not in {dtypes}")
        fields[name] = torch.as_tensor(np.array(v), device=device)
    return IVFIndex(**fields)


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
