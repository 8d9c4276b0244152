"""Training-data generation + recall-predictor fitting (paper §3.1.3, §4.1).

The training queries run through the engine in batches and every engine
step logs (features, true recall, ndis, valid), the port of the
reference's ``lax.scan`` log: one engine step = one probe. The log stays
on the device during a batch and is copied to the host once per batch.

Byproducts used elsewhere (all free, as the paper notes):
  * dists_Rt per target  -> heuristic ipi/mpi,
  * per-query oracle termination points.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engines as engines_lib
from repro_torch.core import features as features_lib
from repro_torch.core import intervals as intervals_lib
from repro_torch.core.predictor import RecallPredictor, regression_metrics
from repro_torch.gbdt import train as gbdt_train
from repro_torch.index import flat


class TrainLog(NamedTuple):
    features: np.ndarray  # f32[T, B, 11]
    recall: np.ndarray    # f32[T, B]
    ndis: np.ndarray      # i32[T, B]
    valid: np.ndarray     # bool[T, B] (query was active going into step)
    gen_seconds: float


def ground_truth(q: torch.Tensor, x: torch.Tensor, k: int, mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN ground truth (the fused l2_topk kernel on the card).

    With a mesh, the database rows are sharded over its "model" axis and
    each shard runs l2_topk on its slice
    (``dist.collectives.sharded_flat_search``); the result is the same."""
    if mesh is not None:
        from repro_torch.dist import collectives
        return collectives.sharded_flat_search(q, x, k, mesh)
    return flat.search(q, x, k)


def generate_observations(engine: engines_lib.Engine, q: torch.Tensor,
                          gt_i: torch.Tensor, batch: int = 256) -> TrainLog:
    """Run training queries through the engine, logging every step."""
    t0 = time.time()
    n = q.shape[0]
    outs = []
    for lo in range(0, n, batch):
        qb = q[lo:lo + batch]
        gb = gt_i[lo:lo + batch]
        if qb.shape[0] < batch:  # pad the tail batch to one batch shape
            pad = batch - qb.shape[0]
            qb = torch.cat([qb, qb.new_zeros((pad, qb.shape[1]))])
            gb = torch.cat([gb, gb.new_full((pad, gb.shape[1]), -2)])
        outs.append(_scan_log(engine, qb, gb))
    logs = [np.concatenate([o[j] for o in outs], axis=1)[:, :n]
            for j in range(4)]
    return TrainLog(*logs, time.time() - t0)


def _scan_log(engine: engines_lib.Engine, q: torch.Tensor,
              gt_i: torch.Tensor):
    t_max = engine.max_steps
    b = q.shape[0]
    dev = q.device
    feats = torch.empty((t_max, b, features_lib.NUM_FEATURES),
                        dtype=torch.float32, device=dev)
    rec = torch.empty((t_max, b), dtype=torch.float32, device=dev)
    nd = torch.empty((t_max, b), dtype=torch.int32, device=dev)
    valid = torch.empty((t_max, b), dtype=torch.bool, device=dev)
    inner = engine.init(engine.index, q)
    for t in range(t_max):
        valid[t] = inner.active
        inner = engine.step(engine.index, inner)
        feats[t] = features_lib.extract(
            engine.nstep(inner), inner.ndis, inner.ninserts, inner.first_nn,
            engine.topk_d(inner))
        rec[t] = flat.recall_at_k(engine.topk_i(inner), gt_i)
        nd[t] = inner.ndis
    return (feats.cpu().numpy(), rec.cpu().numpy(), nd.cpu().numpy(),
            valid.cpu().numpy())


class TrainedDarth(NamedTuple):
    predictor: RecallPredictor
    dists_rt: Dict[float, float]       # target recall -> mean oracle dists
    metrics: dict                      # fit metrics on held-out split
    train_seconds: float
    num_samples: int


def fit_predictor(log: TrainLog, *,
                  cfg: gbdt_train.GBDTConfig = gbdt_train.GBDTConfig(),
                  targets: Sequence[float] = (0.8, 0.85, 0.9, 0.95, 0.99),
                  max_samples: int = 2_000_000, holdout: float = 0.1,
                  seed: int = 0, device="cuda") -> TrainedDarth:
    """Fit the GBDT recall predictor from step logs on ``device``."""
    t0 = time.time()
    mask = log.valid.reshape(-1)
    x = log.features.reshape(-1, features_lib.NUM_FEATURES)[mask]
    y = log.recall.reshape(-1)[mask]
    rng = np.random.default_rng(seed)
    if x.shape[0] > max_samples:
        sel = rng.choice(x.shape[0], max_samples, replace=False)
        x, y = x[sel], y[sel]
    n_hold = max(1, int(holdout * x.shape[0]))
    perm = rng.permutation(x.shape[0])
    x, y = x[perm], y[perm]
    x_tr, y_tr = x[n_hold:], y[n_hold:]
    x_ho, y_ho = x[:n_hold], y[:n_hold]

    params = gbdt_train.fit(x_tr, y_tr, cfg, device=device)
    pred = RecallPredictor(params=params)
    m = regression_metrics(
        pred(torch.as_tensor(x_ho, device=device)).cpu().numpy(), y_ho)

    dists_rt = {
        float(rt): float(np.mean(intervals_lib.dists_to_target(
            log.recall, log.ndis, log.valid, rt)))
        for rt in targets
    }
    return TrainedDarth(predictor=pred, dists_rt=dists_rt, metrics=m,
                        train_seconds=time.time() - t0,
                        num_samples=int(x_tr.shape[0]))
