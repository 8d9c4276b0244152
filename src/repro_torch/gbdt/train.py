"""Histogram-based gradient-boosted decision trees in PyTorch.

The recall predictor's trainer, as in ``repro.gbdt.train``:

  * quantile binning (host-side numpy, once) -> int32 bin matrix,
  * level-wise tree growth: every level is one scatter-add histogram
    (``index_add_``) + one vectorized split search over
    [nodes, features, bins],
  * squared loss, shrinkage, L2 leaf regularization, min-child-weight,
  * a Python loop over trees on the tensors' device.

``index_add_`` on the card adds in no fixed order, so histogram sums may
differ from the reference's in the last bits and a near-tie split may go
the other way; the fit is held to the reference's held-out error, not to
its trees.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.gbdt.model import GBDTParams


class GBDTConfig(NamedTuple):
    num_trees: int = 100
    depth: int = 6
    learning_rate: float = 0.1
    num_bins: int = 64
    l2: float = 1.0
    min_child_weight: float = 20.0


def compute_bin_edges(x: np.ndarray, num_bins: int) -> np.ndarray:
    """Per-feature quantile bin edges. Returns float32[F, num_bins - 1]."""
    qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
    edges = np.quantile(np.asarray(x, np.float64), qs, axis=0).T  # [F, B-1]
    # Strictly increasing edges keep searchsorted semantics clean; nudge ties.
    eps = 1e-12 + 1e-9 * np.abs(edges)
    edges = np.maximum.accumulate(edges + np.cumsum(np.zeros_like(edges), axis=1), axis=1)
    for j in range(1, edges.shape[1]):
        edges[:, j] = np.maximum(edges[:, j], edges[:, j - 1] + eps[:, j])
    return edges.astype(np.float32)


def bin_data(x: torch.Tensor, edges: torch.Tensor,
             chunk: int = 1 << 18) -> torch.Tensor:
    """bin = #edges strictly below x; int32[n, F] in [0, num_bins-1]."""
    return torch.cat([
        (x[lo:lo + chunk, :, None] > edges[None]).sum(2).to(torch.int32)
        for lo in range(0, x.shape[0], chunk)])


def _grow_tree(xb: torch.Tensor, grad: torch.Tensor, w: torch.Tensor,
               depth: int, num_bins: int, l2: float, min_child_weight: float,
               learning_rate: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Grow one level-wise tree. Returns (feat, thr_bin, leaf,
    sample_leaf_val): feat i32[2**depth - 1] (-1 = degenerate, all left),
    thr_bin i32[2**depth - 1] (left iff bin <= thr_bin), leaf
    f32[2**depth], and this tree's contribution per training sample."""
    n, f_dim = xb.shape
    dev = xb.device
    xb_l = xb.long()
    feat_nodes, thr_nodes = [], []
    node_pos = torch.zeros((n,), dtype=torch.long, device=dev)
    f_range = torch.arange(f_dim, device=dev)
    bin_range = torch.arange(num_bins, device=dev)

    gw = grad * w
    gw_rep = gw[:, None].expand(n, f_dim).reshape(-1)
    w_rep = w[:, None].expand(n, f_dim).reshape(-1)
    for d in range(depth):
        n_nodes = 2 ** d
        seg = (node_pos[:, None] * (f_dim * num_bins)
               + f_range[None, :] * num_bins + xb_l).reshape(-1)
        nseg = n_nodes * f_dim * num_bins
        shape = (n_nodes, f_dim, num_bins)
        hist_g = torch.zeros(nseg, device=dev).index_add_(0, seg, gw_rep)
        hist_w = torch.zeros(nseg, device=dev).index_add_(0, seg, w_rep)

        gl = torch.cumsum(hist_g.reshape(shape), 2)
        wl = torch.cumsum(hist_w.reshape(shape), 2)
        g_tot = gl[:, :, -1:]
        w_tot = wl[:, :, -1:]
        gr = g_tot - gl
        wr = w_tot - wl
        parent = (g_tot ** 2) / (w_tot + l2)
        gain = gl ** 2 / (wl + l2) + gr ** 2 / (wr + l2) - parent
        valid = (wl >= min_child_weight) & (wr >= min_child_weight)
        valid = valid & (bin_range[None, None, :] < num_bins - 1)
        gain = torch.where(valid, gain, float("-inf"))

        flat = gain.reshape(n_nodes, f_dim * num_bins)
        best = torch.argmax(flat, 1)          # first maximum, as jnp.argmax
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        feat_d = (best // num_bins).to(torch.int32)
        bin_d = (best % num_bins).to(torch.int32)
        degenerate = ~torch.isfinite(best_gain) | (best_gain <= 0.0)
        feat_d = torch.where(degenerate, -1, feat_d)
        feat_nodes.append(feat_d)
        thr_nodes.append(bin_d)

        f_sel = feat_d[node_pos]
        t_sel = bin_d[node_pos]
        x_sel = torch.gather(xb, 1, f_sel.clamp_min(0).long()[:, None])[:, 0]
        go_right = (x_sel > t_sel) & (f_sel >= 0)
        node_pos = 2 * node_pos + go_right.long()

    n_leaf = 2 ** depth
    leaf_g = torch.zeros(n_leaf, device=dev).index_add_(0, node_pos, gw)
    leaf_w = torch.zeros(n_leaf, device=dev).index_add_(0, node_pos, w)
    leaf = -learning_rate * leaf_g / (leaf_w + l2)
    return (torch.cat(feat_nodes), torch.cat(thr_nodes), leaf,
            leaf[node_pos])


def _bins_to_raw_thresholds(feat: torch.Tensor, thr_bin: torch.Tensor,
                            edges: torch.Tensor) -> torch.Tensor:
    """Map bin-space thresholds to raw space: left iff x <= edges[f, b]."""
    f = feat.clamp_min(0).long()
    raw = edges[f, thr_bin.clamp_max(edges.shape[1] - 1).long()]
    return torch.where(feat < 0, float("inf"), raw)


def fit(x: np.ndarray, y: np.ndarray, cfg: GBDTConfig = GBDTConfig(),
        sample_weight: Optional[np.ndarray] = None,
        device="cuda") -> GBDTParams:
    """Fit a GBDT regressor: host-side binning, boosting on ``device``."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    edges = torch.as_tensor(compute_bin_edges(x, cfg.num_bins), device=device)
    xb = bin_data(torch.as_tensor(x, device=device), edges)
    yt = torch.as_tensor(y, device=device)
    w = torch.ones((x.shape[0],), dtype=torch.float32, device=device)
    if sample_weight is not None:
        w = w * torch.as_tensor(np.asarray(sample_weight, np.float32),
                                device=device)
    base = yt.mean()
    pred = base.expand(x.shape[0]).clone()
    feats, thrs, leaves = [], [], []
    for _ in range(cfg.num_trees):
        feat, thr, leaf, sample_val = _grow_tree(
            xb, pred - yt, w, cfg.depth, cfg.num_bins, cfg.l2,
            cfg.min_child_weight, cfg.learning_rate)
        pred = pred + sample_val
        feats.append(feat)
        thrs.append(_bins_to_raw_thresholds(feat, thr, edges))
        leaves.append(leaf)
    return GBDTParams(feat=torch.stack(feats), thresh=torch.stack(thrs),
                      leaf=torch.stack(leaves), base=base)
