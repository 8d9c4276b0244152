"""Known-bad: a step that reads a device value on the host with
``.item()`` (pass host-sync)."""
import torch

from repro_torch.analysis.registry import Built

EXPECT_PASS = "host-sync"


def build_bad(device):
    x = torch.arange(64, dtype=torch.float32, device=device)

    def step():
        live = int(x.gt(10).sum().item())
        return x[:live]
    return Built(steps={"step": step})
