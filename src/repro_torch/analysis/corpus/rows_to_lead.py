"""Known-bad: a sharded step that brings every shard's rows to the lead
device and merges there, so its transfers grow with N (pass
cross-shard-bytes)."""
import torch

from repro_torch.analysis.registry import SIZES, Built

EXPECT_PASS = "cross-shard-bytes"
SHARDS = 2


def _build(size, device):
    n, d = SIZES[size]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n, d), generator=gen).to(device)
    blocks = list(torch.chunk(x, SHARDS))
    q = torch.randn((8, d), generator=gen).to(device)

    def step():
        rows = torch.cat([b.to(device) for b in blocks])
        return torch.topk(torch.cdist(q, rows), 10, largest=False)
    return Built(steps={"step": step})


def build_bad(device):
    return _build("small", device)


def build_bad_large(device):
    return _build("large", device)
