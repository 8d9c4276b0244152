"""Known-bad: a pad slot written with a raw -1 literal, not
``core.padding.pad_ids`` (pass pad-convention)."""
import torch

EXPECT_PASS = "pad-convention"


def build_bad(device):
    ids = torch.full((4, 8), -1, dtype=torch.int32, device=device)
    return ids
