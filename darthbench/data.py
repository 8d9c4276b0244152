"""The collection, the learn set and query streams, made on the device.

A configuration's collection is one deployment's data set, as SIFT1M is
one: its mixture, base rows and learn set are drawn from the
configuration's own ``data.seed``, so every run builds and fits the same
deployment. The queries are drawn from the run's seed (``traffic``).

The structure is that of the port's ``data/vectors.py`` (``make_dataset``:
a clustered Gaussian mixture whose learn set is 20 % noise-perturbed and
10 % drawn from unseen modes; ``noisy_queries``: Gaussian noise with
sigma = sqrt(pct * ||q|| / D), the paper's harder workloads), rewritten
in plain PyTorch on a ``torch.Generator`` of the device so that a later
change to the program cannot move it, and so that a million rows are made
in a few large calls instead of on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

_MASK63 = (1 << 63) - 1
BLOCK = 1 << 18          # rows drawn per call: bounds the temporaries


def derive(seed: int, stream: int) -> int:
    """A seed for one named stream of a run (set-up, traffic, warm-up...),
    so that streams do not overlap; any whole-number run seed works."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB) & _MASK63


def generator(device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, stream))
    return g


@dataclasses.dataclass
class Collection:
    base: torch.Tensor       # f32[N, D] on the device
    learn: torch.Tensor      # f32[L, D] the fit's learn queries
    centers: torch.Tensor    # f32[C, D] the mixture's modes
    cfg: Dict[str, Any]      # the configuration's "data" block


def mixture(g: torch.Generator, centers: torch.Tensor, n: int,
            std: float) -> torch.Tensor:
    """n points of the mixture: a uniform mode plus N(0, std^2) noise."""
    dev, d = centers.device, centers.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, BLOCK):
        m = min(BLOCK, n - lo)
        pick = torch.randint(0, centers.shape[0], (m,), generator=g,
                             device=dev)
        out[lo:lo + m] = centers[pick] + torch.randn(
            (m, d), generator=g, device=dev) * std
    return out


def unseen_modes(g: torch.Generator, n: int, d: int, center_scale: float,
                 std: float, device) -> torch.Tensor:
    """n points each around a fresh mode of the same family (the learn
    set's "far" rows)."""
    c = torch.randn((n, d), generator=g, device=device) * center_scale
    return c + torch.randn((n, d), generator=g, device=device) * std


def add_noise(g: torch.Generator, q: torch.Tensor,
              pct: torch.Tensor) -> torch.Tensor:
    """The paper's noisy queries: sigma = sqrt(pct * ||q|| / D) per row."""
    norms = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    sigma = torch.sqrt(pct[:, None] * norms / q.shape[1])
    return q + torch.randn(q.shape, generator=g, device=q.device) * sigma


def make_collection(cfg: Dict[str, Any], device) -> Collection:
    """The collection and the learn set of a configuration's ``data``
    block: ``seed``, ``n``, ``dim``, ``clusters``, ``cluster_std``,
    ``center_scale``, ``learn``, ``learn_noisy_share``,
    ``learn_far_share``, ``learn_noise_pct`` [lo, hi]."""
    g = generator(device, int(cfg["seed"]), 0)
    d, std = int(cfg["dim"]), float(cfg["cluster_std"])
    centers = torch.randn((int(cfg["clusters"]), d), generator=g,
                          device=device) * float(cfg["center_scale"])
    base = mixture(g, centers, int(cfg["n"]), std)
    num_learn = int(cfg["learn"])
    learn = mixture(g, centers, num_learn, std)
    n_noisy = int(num_learn * float(cfg["learn_noisy_share"]))
    n_far = int(num_learn * float(cfg["learn_far_share"]))
    perm = torch.randperm(num_learn, generator=g, device=device)
    noisy, far = perm[:n_noisy], perm[n_noisy:n_noisy + n_far]
    lo, hi = (float(v) for v in cfg["learn_noise_pct"])
    pct = lo + (hi - lo) * torch.rand((n_noisy,), generator=g, device=device)
    learn[noisy] = add_noise(g, learn[noisy], pct)
    learn[far] = unseen_modes(g, n_far, d, float(cfg["center_scale"]), std,
                              device)
    return Collection(base=base, learn=learn, centers=centers, cfg=cfg)
