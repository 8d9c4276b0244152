"""Deterministic, shardable, restartable token stream (a port of the
reference's ``repro/data/synthetic.py``).

The batch of a step is a pure function of (seed, step, shard_id): it is
drawn on the host by ``np.random.default_rng([seed, step, shard_id])``,
so a restart replays the exact stream from the integer step alone, each
data-parallel shard draws only its rows, and no step needs the ones
before it. The CPU and the card get the same batch. The reference draws
through threefry ``fold_in``, which the port cannot reproduce: the law
is the same (``_zipf_logits``, identical, under a softmax), the tokens
are not.

The stream is a Zipf-ish law over the vocabulary with labels shifted by
one: enough structure for a loss to fall in a short training run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0


def _zipf_logits(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    return np.log(1.0 / ranks)


def _cdf(vocab: int) -> np.ndarray:
    """The cumulative law of softmax(_zipf_logits), f64, last entry 1."""
    p = np.exp(_zipf_logits(vocab) - _zipf_logits(vocab).max())
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return cdf


class TokenPipeline:
    """``get_batch(step)`` -> {"tokens", "labels"}: int32 [local_batch,
    seq_len] on ``device``, labels the tokens shifted by one."""

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {cfg.num_shards} shards")
        self.cfg = cfg
        self.device = device
        self.local_batch = cfg.global_batch // cfg.num_shards
        self._cdf = _cdf(cfg.vocab_size)

    def sample(self, step: int) -> np.ndarray:
        """The step's tokens on the host, int32 [local_batch, seq_len + 1]:
        an inverse-CDF draw from the step's own generator."""
        c = self.cfg
        rng = np.random.default_rng([c.seed, int(step), c.shard_id])
        u = rng.random((self.local_batch, c.seq_len + 1))
        return np.searchsorted(self._cdf, u, side="right").astype(np.int32)

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        toks = torch.from_numpy(self.sample(step)).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state_dict(self, step: int) -> Dict[str, int]:
        return {"step": int(step), "seed": self.cfg.seed,
                "num_shards": self.cfg.num_shards,
                "shard_id": self.cfg.shard_id}
