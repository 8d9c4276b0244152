"""Gate runner: the pad lint over the tree, then the runtime passes over
every registered entry point.

``run_gate(device)`` is the programmatic entry (a test runs it in
process on the CPU; ``chip_smoke.py`` phase 11 on the card);
``python -m repro_torch.analysis --gate`` wraps it with exit codes.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis import audits, padlint
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import SIZES, entry_points

#: the src root, derived from this file (src/repro_torch/analysis/).
SRC_ROOT = audits.SRC_ROOT


def build_recorded(build, size: str, device):
    """``build(size, device)`` under a recorder that maps each storage to
    the call that made it: (Built, recorder)."""
    return audits.record(lambda: build(size, device), device=device,
                         track_creation=True)


def run_built(name: str, small, large, rec_small, rec_large, *,
              resident_sq8: bool = False) -> List[Finding]:
    """The passes over one entry's two builds."""
    out: List[Finding] = list(small.findings) + list(large.findings)
    for tag, unplaced, placed in small.placements:
        out += audits.replicated_store(name, tag, unplaced, placed,
                                       rec_small)
    if resident_sq8:
        out += audits.resident_dtype(name, small.payloads, large.payloads,
                                     SIZES["small"][1], rec_small, rec_large)
    for tag, step in small.steps.items():
        if tag not in large.steps:
            continue
        _, a = audits.record(step, device=rec_small.device)
        _, b = audits.record(large.steps[tag], device=rec_large.device)
        out += audits.cross_shard_bytes(f"{name}:{tag}", a, b)
    return out


def run_entry(ep, device="cuda") -> List[Finding]:
    """Every runtime pass over one registered entry point."""
    if ep.check is not None:
        return list(ep.check(device))
    small, rec_s = build_recorded(ep.build, "small", device)
    large, rec_l = build_recorded(ep.build, "large", device)
    return run_built(ep.name, small, large, rec_s, rec_l,
                     resident_sq8=ep.resident_sq8)


def run_gate(device="cuda", *, tree_only: bool = False) -> List[Finding]:
    """The full gate: the source-tree lint, then every entry point on
    ``device``. ``tree_only`` runs the lint alone (it imports no torch
    state and touches no device)."""
    findings = padlint.lint_tree(SRC_ROOT)
    if tree_only:
        return findings
    device = audits.one_device(device)
    for ep in entry_points():
        findings.extend(run_entry(ep, device))
    return findings
