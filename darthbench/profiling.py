"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady part of the window, the kernel calls made in it, and what the
device and the host did.

The profiler starts and stops at serve-call or chunk boundaries, where
the server has just fetched its ``active`` mask (a sync), so the device
holds no work from before the start and none is left running at the stop.
On the card, the first session of a process recorded only the last few
milliseconds of a stretch of seconds, and a session after an earlier one
can lose its first device records; so set-up opens and closes one
throwaway session (``prime``), and the stretch's session opens with
``PAD`` spin kernels that the reduction leaves out (the on-chip smoke
script's ``profiled`` helper does the same); the traced window starts
where the last of them ends.

While the stretch is open, ``kernels.ops.bucket_probe_slots`` and
``ops.gbdt_predict`` are wrapped (the call sites reach them as module
attributes), and each wrapper keeps what the call's least time needs:
the slot and active tensors of a probe (no copy: the server makes new
ones each step), the shape of a prediction. Outside the traced run
nothing is wrapped and no hook is passed to the server.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

PAD = 512
END_MARK = "darthbench.stretch_end"
KERNELS = {"bucket_probe": re.compile(r"probe_(tile|merge)_kernel"),
           "gbdt_predict": re.compile(r"gbdt_predict_kernel")}
TOP = 10


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]            # device seconds by kernel family
    kernel_launches: Dict[str, int]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Recorder:
    """Wraps the two kernel entry points while the stretch is open."""

    def __init__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        self._orig = {"bucket_probe_slots": ops.bucket_probe_slots,
                      "gbdt_predict": ops.gbdt_predict}
        self.probe: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.probe_store: Optional[Tuple[torch.Tensor, torch.Tensor,
                                         int]] = None
        self.gbdt: List[Tuple[int, int, int, int]] = []

    def install(self) -> None:
        probe, gbdt = self._orig["bucket_probe_slots"], self._orig[
            "gbdt_predict"]

        def bucket_probe_slots(q, store_vecs, store_sqn, store_ids, slot,
                               active, bias, kth, run_d, run_i):
            if self.probe_store is None:
                self.probe_store = (store_vecs, store_ids, run_d.shape[1])
            self.probe.append((slot, active))
            return probe(q, store_vecs, store_sqn, store_ids, slot, active,
                         bias, kth, run_d, run_i)

        def gbdt_predict(params, x):
            self.gbdt.append((x.shape[0], x.shape[1], params.feat.shape[0],
                              params.depth))
            return gbdt(params, x)

        self._ops.bucket_probe_slots = bucket_probe_slots
        self._ops.gbdt_predict = gbdt_predict

    def remove(self) -> None:
        for name, fn in self._orig.items():
            setattr(self._ops, name, fn)


def prime(device) -> None:
    """One throwaway profiler session over ``PAD`` spin kernels."""
    from torch.profiler import ProfilerActivity, profile
    if torch.device(device).type != "cuda":
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(device)


class Stretch:
    """Opens the profiler at ``start_at`` seconds into the window and
    closes it at the first boundary past ``start_at + length``."""

    def __init__(self, start_at: float, length: float, device):
        self.start_at, self.stop_at = start_at, start_at + length
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.prof = None
        self.recorder: Optional[Recorder] = None
        self.done = False

    def poll(self, elapsed: float) -> None:
        """Called at boundaries with the seconds since the window opened."""
        if self.done:
            return
        if self.prof is None and elapsed >= self.start_at:
            self._start()
        elif self.prof is not None and elapsed >= self.stop_at:
            self._stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.cuda:
            for _ in range(PAD):
                torch.cuda._sleep(1)
        self.recorder = Recorder()
        self.recorder.install()

    def _stop(self) -> None:
        self.recorder.remove()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        with torch.profiler.record_function(END_MARK):
            pass
        self.prof.stop()
        self.done = True

    def close(self) -> None:
        """Stop a stretch the window ended inside."""
        if self.prof is not None and not self.done:
            self._stop()

    def summary(self) -> Optional[Summary]:
        if self.prof is None:
            return None
        return reduce(self.prof.events())


def _short(name: str) -> str:
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)
    return name[:100]


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type)


def reduce(events) -> Optional[Summary]:
    """Busy and idle time, kernel time by family, the heaviest device ops
    and the idle gaps by what the host was doing, from profiler events."""
    dev = [e for e in events if _is_device(e)]
    if not dev:
        return None
    spins = [e for e in dev if "spin_kernel" in e.name]
    dev = [e for e in dev if "spin_kernel" not in e.name]
    host = [e for e in events if not _is_device(e)]
    marks = [e for e in host if e.name == END_MARK]
    w0 = max((e.time_range.end for e in spins),
             default=min(e.time_range.start for e in dev))
    w1 = (marks[0].time_range.start if marks
          else max(e.time_range.end for e in dev))
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev)
    spans = [(a, b) for a, b in spans if b > a]
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, cur = [], w0
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))

    kernel_s = {k: 0.0 for k in KERNELS}
    launches = {k: 0 for k in KERNELS}
    by_op: Dict[str, float] = {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        for fam, pat in KERNELS.items():
            if pat.search(e.name):
                kernel_s[fam] += us / 1e6
                launches[fam] += 1
        key = _short(e.name)
        by_op[key] = by_op.get(key, 0.0) + us / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
                   kernel_s=kernel_s, kernel_launches=launches,
                   device_ops=ops, idle_gaps=label_gaps(gaps, host))


def label_gaps(gaps: List[Tuple[float, float]], host) -> List[Tuple[str,
                                                                    float]]:
    """Idle seconds by the innermost host event open at each gap's middle
    (on the thread that launched most work), summed by label."""
    if not gaps:
        return []
    threads: Dict[int, int] = {}
    for e in host:
        threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get) if threads else None
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in host if e.thread == main and e.name != END_MARK)
    starts = [s for s, _, _ in evs]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    out: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for m, width in mids:
        hi = bisect.bisect_right(starts, m)
        while j < hi:
            stack.append(evs[j])
            j += 1
        stack = [s for s in stack if s[1] >= m]
        label = (min(stack, key=lambda s: s[1] - s[0])[2] if stack
                 else "host outside any op")
        out[label] = out.get(label, 0.0) + width / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])[:TOP]

