"""CLI: ``python -m repro_torch.analysis --gate [--selftest] [--json PATH]
[--device cuda|cpu]``.

Runs the gate on the named device (the card unless asked for the CPU, as
the port's other entry points) and exits non-zero on any finding.
``--selftest`` also runs the known-bad corpus
(``repro_torch.analysis.corpus``) and fails unless every module's pass
fires with a file:line anchor inside that module, so a pass regression
cannot silently turn the gate green. There is no device-count flag: a
``SearchMesh`` puts every shard on the one device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import pkgutil
import sys
from typing import List


def _detect(mod, path: str, device) -> list:
    """Run the pass ``mod.EXPECT_PASS`` over the corpus module."""
    from repro_torch.analysis import audits, padlint, runner
    from repro_torch.analysis.registry import SIZES
    name = f"corpus/{os.path.basename(path)}"
    kind = mod.EXPECT_PASS
    if kind == "pad-convention":
        with open(path) as f:
            return padlint.lint_source(
                os.path.relpath(path, os.path.dirname(audits.SRC_ROOT)),
                f.read())
    if kind in ("resident-dtype", "cross-shard-bytes"):
        small, rec_s = runner.build_recorded(
            lambda size, dev: mod.build_bad(dev), "small", device)
        large, rec_l = runner.build_recorded(
            lambda size, dev: mod.build_bad_large(dev), "large", device)
        if kind == "resident-dtype":
            return audits.resident_dtype(name, small.payloads,
                                         large.payloads, SIZES["small"][1],
                                         rec_s, rec_l)
        out = []
        for tag, step in small.steps.items():
            _, a = audits.record(step, device)
            _, b = audits.record(large.steps[tag], device)
            out += audits.cross_shard_bytes(f"{name}:{tag}", a, b)
        return out
    if kind == "host-sync":
        built = mod.build_bad(device)
        out = []
        for tag, step in built.steps.items():
            _, rec = audits.record(step, device)
            out += audits.host_syncs(f"{name}:{tag}", rec, {})
        return out
    if kind == "replicated-store":
        built, rec = runner.build_recorded(
            lambda size, dev: mod.build_bad(dev), "small", device)
        out = []
        for tag, unplaced, placed in built.placements:
            out += audits.replicated_store(name, tag, unplaced, placed, rec)
        return out
    raise ValueError(f"{name}: unknown pass {kind!r}")


def run_selftest(device="cuda") -> List[str]:
    """Run each corpus module's pass and demand it fires with a
    file:line finding inside the module's own file. Returns error
    strings (empty = all detected)."""
    from repro_torch.analysis import audits, corpus
    device = audits.one_device(device)
    errors: List[str] = []
    names = [m.name for m in pkgutil.iter_modules(corpus.__path__)
             if not m.name.startswith("_")]
    if not names:
        return [f"no corpus modules under {corpus.__path__[0]}"]
    for name in sorted(names):
        mod = importlib.import_module(f"{corpus.__name__}.{name}")
        path = os.path.abspath(mod.__file__)
        found = _detect(mod, path, device)
        located = [f for f in found
                   if f.file and os.path.basename(f.file) == f"{name}.py"
                   and f.line]
        if not found:
            errors.append(f"{name}: {mod.EXPECT_PASS} did NOT fire on the "
                          f"known-bad program")
        elif not located:
            errors.append(f"{name}: {mod.EXPECT_PASS} fired but without a "
                          f"file:line anchor into the program")
        else:
            print(f"selftest ok: {name} -> {located[0].location()}")
    return errors


def main(argv=None) -> int:
    """Parse args, run the gate and/or the selftest."""
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static gate: pad lint, SQ8 residency, "
                    "host syncs, cross-shard bytes, placed bytes")
    p.add_argument("--gate", action="store_true",
                   help="run every pass over the registered entry points")
    p.add_argument("--selftest", action="store_true",
                   help="require the known-bad corpus to be detected")
    p.add_argument("--device", default="cuda",
                   help="where the entry points run (default: cuda)")
    p.add_argument("--json", metavar="PATH",
                   help="also write findings + selftest errors as JSON")
    args = p.parse_args(argv)
    if not (args.gate or args.selftest):
        p.error("nothing to do: pass --gate and/or --selftest")

    from repro_torch.analysis.findings import format_findings
    from repro_torch.analysis.runner import run_gate

    findings = run_gate(args.device) if args.gate else []
    selftest_errors = run_selftest(args.device) if args.selftest else []

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"findings": [x.to_dict() for x in findings],
                       "selftest_errors": selftest_errors}, f, indent=2)

    if findings:
        print(format_findings(findings))
    for e in selftest_errors:
        print(f"selftest FAIL: {e}")
    ok = not findings and not selftest_errors
    if args.gate:
        print(f"gate: {len(findings)} finding(s)")
    if ok:
        print("analysis gate: OK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
