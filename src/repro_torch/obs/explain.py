"""Termination explainability: reconstruct one query's story.

``explain()`` folds a query's spans — admission, scheduling events it
crossed (hedges, steals, hot-swaps, compaction), the per-step
predicted-recall trajectory and the terminal reason — into a short
human-readable narrative, answering the question coarse aggregates
cannot: "why did query 714 terminate at step 12 with predicted recall
0.91?".

CLI::

    python -m repro_torch.obs.explain TRACE.jsonl --qid 714
    python -m repro_torch.obs.explain TRACE.jsonl --summary
    python -m repro_torch.obs.explain TRACE.jsonl            # worst query

Input is the JSONL trace a ``Tracer(path=...)`` appends per serve call
(the last serve in the file by default; ``--serve N`` selects another).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.obs import stats as stats_lib
from repro_torch.obs import trace as trace_lib

_SERVER_EVENT_KINDS = ("swap_staged", "swap_applied", "compact_begin",
                       "compact_tick", "compact_swap", "drift", "recal")


def _as_dicts(spans: Sequence) -> List[Dict]:
    return [s.to_dict() if hasattr(s, "to_dict") else dict(s)
            for s in spans]


def _sparkline(traj: Sequence[float]) -> str:
    """Unicode mini-plot of a recall trajectory (pre-prediction steps
    render as '.')."""
    blocks = "▁▂▃▄▅▆▇█"
    out = []
    for v in traj:
        if v < 0:
            out.append(".")
        else:
            out.append(blocks[min(int(v * len(blocks)), len(blocks) - 1)])
    return "".join(out)


def query_story(spans: Sequence, qid: int) -> Dict:
    """Structured story for one query: its spans split into admission /
    events / terminal, plus the server-level events that overlapped its
    flight window. Raises KeyError when the trace holds no terminal
    span for ``qid`` (an un-traced or unknown query)."""
    spans = _as_dicts(spans)
    mine = [s for s in spans if s.get("qid") == qid]
    term = next((s for s in mine if s.get("kind") == "terminal"), None)
    if term is None:
        raise KeyError(f"query {qid}: no terminal span in trace "
                       f"({len(mine)} event spans)")
    admit = [s for s in mine if s.get("kind") == "admit"]
    events = [s for s in mine if s.get("kind") not in ("terminal",)]
    lo = min((s["step"] for s in admit), default=0)
    hi = term.get("step", lo)
    crossed = [s for s in spans
               if s.get("qid", -1) < 0
               and s.get("kind") in _SERVER_EVENT_KINDS
               and lo <= s.get("step", -1) <= hi]
    return {"qid": qid, "terminal": term, "admissions": admit,
            "events": events, "crossed": crossed}


def explain(trace: Union[str, Sequence], qid: Optional[int] = None,
            serve: Optional[int] = None) -> str:
    """Human-readable story for one query (default: the worst-served
    query — lowest final predicted recall among terminals). ``trace``
    is a JSONL path or an in-memory span sequence."""
    spans = (trace_lib.load_trace(trace, serve=serve)
             if isinstance(trace, str) else _as_dicts(trace))
    terms = [s for s in spans if s.get("kind") == "terminal"
             and s.get("qid", -1) >= 0]
    if not terms:
        return "trace holds no terminal spans (nothing was served?)"
    if qid is None:
        served = [t for t in terms if t.get("r_pred") is not None]
        pick = min(served or terms,
                   key=lambda t: t.get("r_pred", float("inf")))
        qid = pick["qid"]
    story = query_story(spans, qid)
    term = story["terminal"]
    reason = term.get("reason", "?")
    lines = [f"query {qid}: {reason}"]

    for s in story["admissions"]:
        tgt = s.get("target", float("nan"))
        eff = s.get("effective_target", tgt)
        what = "hedge duplicate" if s.get("hedge") else "admitted"
        boost = (f" (boosted to {eff:.2f})"
                 if eff is not None and tgt is not None and eff > tgt
                 else "")
        lines.append(
            f"  step {s['step']:>4}: {what} on host {s['host']} "
            f"slot {s.get('slot', '?')} epoch {s['epoch']}, declared "
            f"target {tgt:.2f}{boost}"
            + (f" [tier {s['tier']}]" if s.get("tier") else ""))
    for s in story["events"]:
        if s["kind"] in ("admit",):
            continue
        lines.append(f"  step {s['step']:>4}: {s['kind']}"
                     + (f" ({s.get('cause')})" if s.get("cause") else ""))
    for s in story["crossed"]:
        lines.append(f"  step {s['step']:>4}: [server] {s['kind']} "
                     f"(epoch {s['epoch']})")

    traj = term.get("trajectory") or []
    if traj:
        fired = sum(1 for i in range(1, len(traj))
                    if traj[i] != traj[i - 1]) + (1 if traj[0] >= 0 else 0)
        # A query that outlived the ring keeps only the newest cap
        # steps — a leading "…" marks the overwritten prefix so the
        # sparkline is never mistaken for the query's full life.
        trunc = "…" if term.get("trajectory_truncated") else ""
        total = term.get("step", 0) - term.get("admit_step", 0)
        label = (f"last {len(traj)} of {total} steps" if trunc
                 else f"{len(traj)} steps")
        lines.append(
            f"  trajectory ({label}, predictor fired on "
            f"{term.get('npred', fired)} of them): {trunc}{_sparkline(traj)}")
    rp = term.get("r_pred")
    eff = term.get("effective_target", term.get("target"))
    if reason == "interval_met" and rp is not None and eff is not None:
        lines.append(
            f"  step {term['step']:>4}: predicted recall {rp:.3f} "
            f"crossed the effective target {eff:.2f} -> early stop "
            f"(interval #{term.get('npred', '?')} fired, "
            f"ndis={term.get('ndis', '?')})")
    elif rp is not None:
        lines.append(
            f"  step {term['step']:>4}: terminal predicted recall "
            f"{rp:.3f}"
            + (f" vs target {eff:.2f}" if eff is not None else "")
            + f" (reason: {reason}, ndis={term.get('ndis', '?')})")
    else:
        lines.append(f"  closed without holding a slot (reason: {reason})")
    if term.get("upgraded"):
        lines.append("  result was UPGRADED by a deeper hedge duplicate")
    if term.get("degraded"):
        lines.append("  target was DEGRADED at admission (overload)")
    return "\n".join(lines)


def summary(trace: Union[str, Sequence],
            serve: Optional[int] = None) -> str:
    """One-paragraph rollup: terminal-reason counts + final predicted
    recall and service-step percentiles through the shared helper."""
    spans = (trace_lib.load_trace(trace, serve=serve)
             if isinstance(trace, str) else _as_dicts(trace))
    terms = [s for s in spans if s.get("kind") == "terminal"
             and s.get("qid", -1) >= 0]
    by_reason: Dict[str, int] = {}
    for t in terms:
        by_reason[t.get("reason", "?")] = by_reason.get(
            t.get("reason", "?"), 0) + 1
    rp = [t["r_pred"] for t in terms if t.get("r_pred") is not None]
    svc = [t["step"] - t["admit_step"] for t in terms
           if t.get("admit_step") is not None]
    lines = [f"{len(terms)} queries, "
             + ", ".join(f"{k}={v}" for k, v in sorted(by_reason.items()))]
    if rp:
        lines.append(f"final predicted recall p50/p99 "
                     f"{stats_lib.p50(rp):.3f}/{stats_lib.p01(rp):.3f} "
                     f"(p99 = worst 1%)")
    if svc:
        lines.append(f"service steps p50/p99 "
                     f"{stats_lib.p50(svc):.0f}/{stats_lib.p99(svc):.0f}")
    nevents = sum(1 for s in spans if s.get("kind") != "terminal")
    lines.append(f"{nevents} event spans "
                 f"({sum(1 for s in spans if s.get('qid', -1) < 0)} "
                 f"server-level)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point (``python -m repro_torch.obs.explain``)."""
    ap = argparse.ArgumentParser(
        description="Reconstruct a query's story from a serve trace")
    ap.add_argument("trace", help="JSONL trace file (Tracer path=...)")
    ap.add_argument("--qid", type=int, default=None,
                    help="query id to explain (default: worst final "
                         "predicted recall)")
    ap.add_argument("--serve", type=int, default=None,
                    help="serve call to read (default: last in file)")
    ap.add_argument("--summary", action="store_true",
                    help="print the whole serve's rollup instead")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(args.trace, serve=args.serve))
    else:
        print(explain(args.trace, qid=args.qid, serve=args.serve))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
