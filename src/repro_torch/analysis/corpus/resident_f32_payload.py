"""Known-bad: an entry that claims the SQ8-resident format but keeps its
N-scaled payload in f32 (pass resident-dtype)."""
import torch

from repro_torch.analysis.registry import SIZES, Built

EXPECT_PASS = "resident-dtype"


def _build(size, device):
    n, d = SIZES[size]
    codes = torch.randn((n, d), dtype=torch.float32, device=device)
    return Built(payloads={"codes": codes})


def build_bad(device):
    return _build("small", device)


def build_bad_large(device):
    return _build("large", device)
