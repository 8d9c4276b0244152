"""repro_torch.analysis — the port's static gate (a port of
``repro.analysis``, the reference's "shardlint").

The reference reads the jaxprs and compiled HLO of its jitted entry
points; eager PyTorch has neither, so the port keeps the gate's
structure (findings with a file:line anchor, a registry of entry points
built small on a given device, a runner, a CLI with a known-bad corpus)
and checks the invariant behind each reference pass by running the
REAL code under a recorder (``audits.Recorder``, a TorchFunctionMode):

  pad-convention     raw -1 / inf pad literals outside
                     repro_torch.core.padding (AST; reference pass 5)
  resident-dtype     the SQ8-resident entries keep every N-scaled
                     [..., D] payload int8 on the device, and
                     residency.resident_bytes counts it so (pass 6,
                     resident-bytes)
  host-sync          host syncs per serve chunk, by call site, within
                     the measured limits, and no kernel build after the
                     first chunk (in place of pass 4, retrace-hazard:
                     eager PyTorch has no retrace; a host sync is what
                     stalls its chunk)
  cross-shard-bytes  a sharded step transfers the same bytes whatever
                     the database size: merges move [B, k], never index
                     rows (pass 3, collective-n-independence)
  replicated-store   a placed index (and each host group's view) holds
                     no more bytes than the unplaced index plus its pad
                     rows: a placement that copies the store to every
                     shard fails (pass 1, replicated-constant)

Reference pass 2, unpartitionable-topk (a TopK fed by an all-gather
GSPMD inserted), has no counterpart: the port has no GSPMD, and its
merge is placed explicitly, on the lead device of the index's host
group (``dist.collectives``). What that pass protected, that the merge
never gathers index rows, is what cross-shard-bytes checks.

Run ``python -m repro_torch.analysis --gate --selftest --device cpu`` on
the CPU; ``chip_smoke.py`` phase 11 runs the gate on the card.
"""
from repro_torch.analysis.findings import Finding, format_findings

__all__ = ["Finding", "format_findings"]
