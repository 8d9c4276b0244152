"""DARTH serving engine: slot pool + batch compaction, split into per-host
loops and one device loop (the port of the reference's
``serve/engine.py``).

On a GPU, as on any SIMD/SPMD device, a lone early-terminated query
inside a fixed batch saves nothing — the batch keeps stepping.
Compaction converts DARTH's per-query termination into throughput:
terminated queries leave their slot, queued queries are spliced in
(state surgery via a per-slot ``torch.where``), and the engine keeps
every slot busy.

Every query carries its own declared recall target (mixed-target batches
are native — per-slot R_t, per-slot adaptive intervals).

Multi-host topology (hosts > 1): the slot pool is partitioned into
contiguous per-host slices, each owned by a `_HostSlots` loop that runs
admission, refill splicing and slot compaction against ONLY its slice —
no cross-host coordination, no global scheduler. The device loop steps
the whole pool as one batch. On one process this is SIMULATED
multi-host: N host loops over slot slices of one device batch. Because
per-slot search state never crosses slots (the engine steps, the
predictor and the interval updates are all per-slot), a query's
(topk_d, topk_i, ndis, ninserts) is independent of which host served it.

The device loop has no ``jit``: a chunk calls
``darth_search.make_darth_body``'s body ``steps_per_sync`` times with no
host sync inside, and the one sync is the ``active`` fetch at the chunk
boundary. The reference's "compiles at most once" becomes "one shape per
``serve()`` call": every chunk input is ``[num_slots, ...]`` for the
whole call, free slots are initialised from zero queries and masked,
and the batch never shrinks to the occupied slots.

Sharded serving: with ``mesh`` (a ``launch.mesh.SearchMesh``) the
engine is a sharded one (``engines.sharded_ivf_engine`` or
``sharded_hnsw_engine``, bare or under ``mutable_engine``) over an index
placed on that mesh (``dist.place_index``); each step scans every shard
and merges on the lead device. On a serve mesh with a ``"hosts"`` axis
of H groups that divide the slots (``dist.sharding.slot_sharding``),
host group h's contiguous slot slice is stepped on that group's devices
against its view of the global index (``dist.sharding.host_index``),
and its per-slot state stays there between chunks; a chunk makes one
``active`` fetch per distinct device. Per-slot state never crosses
slots, so a query's result does not depend on which host group served
it. Otherwise the server runs on the device of its engine's index.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import darth_search, engines as engines_lib
from repro_torch.core.intervals import IntervalParams
from repro_torch.core.predictor import RecallPredictor
from repro_torch.dist import sharding as sharding_lib
from repro_torch.obs import stats as obs_stats
from repro_torch.obs import trace as obs_trace

PyTree = Any


@dataclasses.dataclass
class _ObsArrays:
    """Per-boundary device fetches the tracer needs at harvest, sliced
    per host by harvest_host: DARTH's early-stop mask and predictor
    call counts (termination-reason attribution) plus the trajectory
    ring with the engine-step count its columns are relative to
    (traj_base — the step count when the ring's chunk state was last
    rebuilt from scratch). All fetched at the SAME sync boundary the
    server already pays for the active mask: tracing adds no device
    round-trips."""
    early: Optional[np.ndarray] = None     # bool[nloc]
    npred: Optional[np.ndarray] = None     # i32[nloc]
    traj: Optional[np.ndarray] = None      # f32[nloc, traj_cap]
    traj_base: int = 0


def _select_slots(mask: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Per-slot tree select over dataclasses and tuples of tensors: where
    mask[b], take `new`, else `old`. Leaves without a leading slot dim
    (and non-tensor leaves, such as DarthState.steps) are kept from
    `old`."""
    b = mask.shape[0]
    if isinstance(old, torch.Tensor):
        if old.ndim >= 1 and old.shape[0] == b:
            m = mask.to(old.device).reshape((b,) + (1,) * (old.ndim - 1))
            return torch.where(m, new, old)
        return old
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{
            f.name: _select_slots(mask, getattr(new, f.name),
                                  getattr(old, f.name))
            for f in dataclasses.fields(old)})
    if isinstance(old, tuple):
        return tuple(_select_slots(mask, n, o) for n, o in zip(new, old))
    return old


def _cat_slots(parts: List[PyTree]) -> PyTree:
    """Join per-group trees along the slot dim, on the first group's
    device (leaves without a slot dim are taken from the first)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        if first.ndim >= 1:
            return torch.cat([p.to(first.device) for p in parts])
        return first
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _cat_slots([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(_cat_slots(list(v)) for v in zip(*parts))
    return first


def _fetch(parts: List[torch.Tensor]) -> np.ndarray:
    """Per-group device tensors joined on the host in group order, with
    one device-to-host copy per distinct device."""
    if len(parts) == 1:
        return parts[0].cpu().numpy()
    by_dev: Dict[torch.device, List[int]] = {}
    for j, p in enumerate(parts):
        by_dev.setdefault(p.device, []).append(j)
    out: List[Optional[np.ndarray]] = [None] * len(parts)
    for js in by_dev.values():
        host = torch.cat([parts[j] for j in js]).cpu().numpy()
        lo = 0
        for j in js:
            out[j] = host[lo:lo + parts[j].shape[0]]
            lo += parts[j].shape[0]
    return np.concatenate(out)


@dataclasses.dataclass
class HostStats:
    """One host loop's counters (ServeStats aggregates these).

    Admission accounting is exhaustive: every query striped to a host
    is admitted (then completed or truncated), explicitly shed
    (shed_ids), or abandoned (its host died, or the step budget ran out
    before it left the queue) — nothing is silently dropped."""
    host: int = 0
    admitted: int = 0            # queries that ever got a slot
    completed: int = 0
    slot_steps: int = 0
    refills: int = 0
    truncated: int = 0           # admitted, harvested with a partial top-k
    ndis_harvested: int = 0      # sum of harvested slots' ndis counters
    killed: bool = False         # fault injection: host died mid-serve
    abandoned: int = 0           # queued on this host, never admitted
    # difficulty-aware admission (serve.difficulty; all zero/empty when
    # the server runs untiered)
    shed: int = 0                # refused at admission (overload="shed")
    degraded: int = 0            # served at the lowered degrade_target
    hedged: int = 0              # hedge duplicates launched
    hedge_upgrades: int = 0      # results replaced by a deeper hedge
    hedge_epoch_dropped: int = 0  # hedges dropped at harvest because a
    #                               hot-swap landed between the primary's
    #                               harvest and the hedge's (the two ran
    #                               against different index versions)
    stolen: int = 0              # queries stolen INTO this host (rebalance)
    shed_ids: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeStats:
    """Aggregate serve() outcome across all host loops."""
    completed: int = 0
    slot_steps: int = 0          # engine steps x slots (cost proxy)
    engine_steps: int = 0
    refills: int = 0
    truncated: int = 0           # in-flight queries harvested with a
    #                              partial top-k when max_engine_steps hit
    #                              (or their host was killed)
    ndis_harvested: int = 0      # sum of per-query ndis at harvest
    hosts: List[HostStats] = dataclasses.field(default_factory=list)
    # difficulty-aware admission totals (sums of the HostStats fields;
    # all zero when the server runs untiered)
    shed: int = 0
    degraded: int = 0
    hedged: int = 0
    hedge_upgrades: int = 0
    hedge_epoch_dropped: int = 0
    # hot-swaps (request_swap) applied at drained chunk boundaries
    # during this serve call
    swaps: int = 0
    # per-tier SLO metrics (serve.difficulty.TierStats, keyed "easy" /
    # "hard"); empty dict when the server runs untiered
    tiers: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # wall-clock percentiles over the per-chunk device round-trips
    # (run_chunk dispatch + the sync-boundary fetch), milliseconds;
    # NaN before any chunk ran
    chunk_ms_p50: float = float("nan")
    chunk_ms_p99: float = float("nan")


class _HostSlots:
    """One host's slice [lo, hi) of the slot pool.

    Owns admission, refill and harvest bookkeeping for its slots and ITS
    OWN query queue(s): every decision reads only the host's slice of
    the device state, so N of these run with no cross-host coordination
    — the only global synchronization in multi-host serving is the
    collectives inside the engine step itself. (Rebalance work stealing
    is driven by the server between chunk boundaries and only moves
    queue entries — never in-flight slot state.)

    With a difficulty TierConfig (serve.difficulty), admission becomes
    tier-aware: the tail `hard_frac` of the host's slots is reserved
    for hard-tier queries (work-conserving — either tier spills into
    the other's free slots once its own queue drains), hard queries are
    served at a boosted effective target, overload is degraded or shed
    at construction instead of queueing unboundedly, and idle hard
    slots can run hedged duplicates. With tiers=None every tier branch
    is inert and scheduling is the original single-FIFO behavior."""

    def __init__(self, host: int, lo: int, hi: int, queue: List[int],
                 queries: np.ndarray, r_targets: np.ndarray,
                 interval_for_target, results: List, *,
                 tiers=None, is_hard: Optional[np.ndarray] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 epoch: int = 0, collect_samples: bool = False):
        self.host = host
        self.lo, self.hi = lo, hi
        self.queries = queries
        self.r_targets = r_targets
        self.interval_for_target = interval_for_target
        self.results = results
        self.tracer = tracer
        self.collect_samples = collect_samples
        nloc = hi - lo
        self.slot_query = np.full((nloc,), -1, np.int64)
        self.rt = np.zeros((nloc,), np.float32)
        self.ipi = np.zeros((nloc,), np.float32)
        self.mpi = np.zeros((nloc,), np.float32)
        self.alive = True
        self.stats = HostStats(host=host)

        self.tiers = tiers
        self.is_hard = is_hard
        self.admit_step = np.zeros((nloc,), np.int64)
        self.slot_hedge = np.zeros((nloc,), bool)
        # engine/predictor version each slot was admitted under
        # (DarthServer.engine_epoch at fill time) and the version each
        # stored result was computed against — a hedge may only upgrade
        # a result from its own epoch (no cross-version merges)
        self.slot_epoch = np.zeros((nloc,), np.int64)
        self.result_epoch: Dict[int, int] = {}
        self.hedge_winner: set = set()   # qids whose result came from a
        #                                  hedge while the primary ran
        # harvest-time SLO samples: (hard, r_pred, latency, truncated)
        self.samples: List[Tuple[bool, float, int, bool]] = []
        self.degraded_ids: List[int] = []
        self._degraded: set = set()
        if tiers is None:
            self.queue_easy: List[int] = list(queue)
            self.queue_hard: List[int] = []
            self.easy_slots = nloc
            return

        # hard-tier slot partition: local slots [easy_slots, nloc)
        self.easy_slots = nloc - int(round(tiers.hard_slot_fraction * nloc))

        # admission control: bound the queue, degrade or shed overflow
        queue = list(queue)
        if tiers.max_queue is not None and len(queue) > tiers.max_queue:
            if tiers.overload == "shed":
                excess = len(queue) - tiers.max_queue
                # shed from the arrival tail, hard tier first (priority:
                # the expensive queries are refused before cheap ones)
                tail = ([q for q in reversed(queue) if is_hard[q]]
                        + [q for q in reversed(queue) if not is_hard[q]])
                drop = set(tail[:excess])
                self.stats.shed_ids = [q for q in queue if q in drop]
                self.stats.shed = len(self.stats.shed_ids)
                queue = [q for q in queue if q not in drop]
                if tracer is not None:
                    for qid in self.stats.shed_ids:
                        tracer.terminal(
                            qid, "shed", host=host, step=0, epoch=epoch,
                            target=float(self.r_targets[qid]),
                            tier=self._tier_of(qid))
            else:                           # degrade-to-lower-target
                for qid in queue[tiers.max_queue:]:
                    if tiers.degrade_target < self.r_targets[qid]:
                        declared = float(self.r_targets[qid])
                        self.r_targets[qid] = tiers.degrade_target
                        self.stats.degraded += 1
                        self.degraded_ids.append(qid)
                        self._degraded.add(qid)
                        if tracer is not None:
                            tracer.event(
                                "degrade", qid=qid, host=host, step=0,
                                epoch=epoch, declared=declared,
                                degraded_to=float(tiers.degrade_target))
        self.queue_easy = [q for q in queue if not is_hard[q]]
        self.queue_hard = [q for q in queue if is_hard[q]]

    @property
    def occupied(self) -> np.ndarray:
        """bool[nloc]: slots currently holding an in-flight query."""
        return self.slot_query >= 0

    @property
    def pending(self) -> int:
        """Queued-but-unadmitted query count (both tiers)."""
        return len(self.queue_easy) + len(self.queue_hard)

    def _tier_of(self, qid: int) -> Optional[str]:
        """Difficulty-tier label for trace spans (None when untiered)."""
        if self.tiers is None or self.is_hard is None:
            return None
        return "hard" if self.is_hard[qid] else "easy"

    def _target_for(self, qid: int) -> float:
        """Effective recall target: declared (possibly degraded at
        admission control), plus the hard-tier boost — clipped to 0.99
        and never below the declared target."""
        rt = float(self.r_targets[qid])
        if (self.tiers is not None and self.is_hard[qid]
                and self.tiers.boost > 0.0):
            rt = max(rt, min(rt + self.tiers.boost, 0.99))
        return rt

    def fill(self, free: np.ndarray, step: int = 0, epoch: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Admit queued queries into the local `free` slots; updates the
        host's rt/ipi/mpi slices in place and returns (mask bool[nloc],
        qb f32[nloc, D]) for the splice — mask all-False when nothing
        was admitted.

        Tiered admission fills each partition from its own queue first
        (easy slots from the easy FIFO, reserved hard slots from the
        hard FIFO), then spills the leftover free slots to the other
        tier's queue so no slot idles while any query waits. With idle
        hard slots and nothing queued, hedging (TierConfig.hedge)
        launches duplicates of the oldest in-flight hard queries at a
        hedge_boost-raised target. `step` is the current engine-step
        count, recorded per slot for the latency percentiles; `epoch`
        is the server's engine_epoch, stamped per slot so harvest can
        refuse to merge results computed against different index /
        predictor versions (hot-swap mid-flight)."""
        nloc = self.hi - self.lo
        qb = np.zeros((nloc, self.queries.shape[1]), np.float32)
        mask = np.zeros((nloc,), bool)
        free = [int(s) for s in free]
        pairs: List[Tuple[int, int]] = []       # (slot, qid)
        if self.tiers is None:
            ids = [self.queue_easy.pop(0)
                   for _ in range(min(len(free), len(self.queue_easy)))]
            pairs = list(zip(free, ids))
        else:
            free_easy = [s for s in free if s < self.easy_slots]
            free_hard = [s for s in free if s >= self.easy_slots]
            for slots, own, other in ((free_easy, self.queue_easy,
                                       self.queue_hard),
                                      (free_hard, self.queue_hard,
                                       self.queue_easy)):
                for s in list(slots):
                    q = own or other            # own tier first, then spill
                    if not q:
                        break
                    pairs.append((s, q.pop(0)))
                    slots.remove(s)
            hedges = (self._plan_hedges(free_hard, len(pairs))
                      if self.tiers.hedge else [])
        if not pairs and not (self.tiers is not None and self.tiers.hedge
                              and hedges):
            return mask, qb
        rt2 = self.rt.copy()
        for s, qid in pairs:
            mask[s] = True
            qb[s] = self.queries[qid]
            rt2[s] = self._target_for(qid)
            self.slot_query[s] = qid
            self.slot_hedge[s] = False
            self.admit_step[s] = step
            self.slot_epoch[s] = epoch
            if self.tracer is not None:
                self.tracer.event(
                    "admit", qid=qid, host=self.host, step=step,
                    epoch=epoch, slot=int(self.lo + s),
                    target=float(self.r_targets[qid]),
                    effective_target=float(rt2[s]),
                    tier=self._tier_of(qid), refill=step > 0)
        if self.tiers is not None and self.tiers.hedge:
            for s, qid in hedges:
                mask[s] = True
                qb[s] = self.queries[qid]
                rt2[s] = max(self._target_for(qid),
                             min(self._target_for(qid)
                                 + self.tiers.hedge_boost, 0.99))
                self.slot_query[s] = qid
                self.slot_hedge[s] = True
                self.admit_step[s] = step
                self.slot_epoch[s] = epoch
                self.stats.hedged += 1
                if self.tracer is not None:
                    self.tracer.event(
                        "admit", qid=qid, host=self.host, step=step,
                        epoch=epoch, slot=int(self.lo + s),
                        target=float(self.r_targets[qid]),
                        effective_target=float(rt2[s]),
                        tier=self._tier_of(qid), hedge=True)
        ip = self.interval_for_target(rt2)
        ipi2 = np.broadcast_to(np.asarray(ip.ipi, np.float32), (nloc,))
        mpi2 = np.broadcast_to(np.asarray(ip.mpi, np.float32), (nloc,))
        self.ipi = np.where(mask, ipi2, self.ipi)
        self.mpi = np.where(mask, mpi2, self.mpi)
        self.rt = np.where(mask, rt2, self.rt)
        self.stats.admitted += len(pairs)
        return mask, qb

    def _plan_hedges(self, free_hard: List[int], admitted: int
                     ) -> List[Tuple[int, int]]:
        """Hedge targets for leftover free hard slots: the oldest
        in-flight hard-tier primaries without a hedge yet. Only fires
        when the queues are fully drained (idle capacity, per the
        TierConfig.hedge contract)."""
        if admitted or self.pending or not free_hard:
            return []
        occ = self.occupied & ~self.slot_hedge
        hedged_qids = set(self.slot_query[self.slot_hedge
                                          & self.occupied].tolist())
        cands = [(int(self.admit_step[s]), int(self.slot_query[s]))
                 for s in np.nonzero(occ)[0]
                 if self.is_hard[self.slot_query[s]]
                 and int(self.slot_query[s]) not in hedged_qids]
        cands.sort()
        return list(zip(free_hard, [qid for _, qid in cands]))

    def _terminal_attrs(self, s: int, qid: int, ndis: np.ndarray,
                        r_pred: Optional[np.ndarray],
                        obs: Optional[_ObsArrays], step: int) -> Dict:
        """Terminal-span payload for local slot ``s`` holding ``qid``:
        targets, tier, counters and the drained trajectory window."""
        attrs: Dict[str, Any] = {
            "target": float(self.r_targets[qid]),
            "effective_target": float(self.rt[s]),
            "admit_step": int(self.admit_step[s]),
            "ndis": int(ndis[s]),
            "slot": int(self.lo + s),
        }
        tier = self._tier_of(qid)
        if tier is not None:
            attrs["tier"] = tier
        if qid in self._degraded:
            attrs["degraded"] = True
        if bool(self.slot_hedge[s]):
            attrs["hedge"] = True
        if r_pred is not None:
            attrs["r_pred"] = float(r_pred[s])
        if obs is not None:
            if obs.npred is not None:
                attrs["npred"] = int(obs.npred[s])
            if obs.traj is not None:
                traj, trunc = obs_trace.traj_window(
                    obs.traj[s], int(self.admit_step[s]), step,
                    obs.traj_base)
                attrs["trajectory"] = traj
                if trunc:
                    attrs["trajectory_truncated"] = True
        return attrs

    def harvest(self, mask: np.ndarray, topk_d: np.ndarray,
                topk_i: np.ndarray, ndis: np.ndarray, *,
                truncated: bool = False, step: int = 0,
                r_pred: Optional[np.ndarray] = None,
                reason: Optional[str] = None,
                obs: Optional[_ObsArrays] = None) -> int:
        """Pull the masked local slots' top-k into results; free the
        slots. The array arguments are the host's SLICE [nloc, ..] of
        the device state. Raises if a slot's query already has a result
        — every admitted query must be returned exactly once. The one
        sanctioned exception is a hedge duplicate (TierConfig.hedge):
        its primary already returned, so a naturally-completed hedge
        UPGRADES the stored result (deeper search at a raised target)
        and a truncated hedge is dropped — either way the query still
        has exactly one result. An upgrade additionally requires the
        hedge's admission epoch to match the stored result's epoch: a
        hot-swap between the primary's harvest and the hedge's means
        the pair searched two different index versions, and replacing
        one with the other would attribute a single hedge_winner to two
        versions — such a hedge is dropped (hedge_epoch_dropped)."""
        count = 0
        trunc_reason = reason or "budget_truncated"
        for s in np.nonzero(mask)[0]:
            qid = int(self.slot_query[s])
            if self.results[qid] is not None:
                # the qid already returned: only legitimate for a hedge
                # pair — the hedge arriving second upgrades (unless
                # truncated or from a different epoch), a primary whose
                # hedge won just frees
                if self.slot_hedge[s]:
                    if not truncated:
                        if (int(self.slot_epoch[s])
                                == self.result_epoch.get(qid)):
                            self.results[qid] = (topk_d[s], topk_i[s])
                            self.result_epoch[qid] = int(self.slot_epoch[s])
                            self.stats.ndis_harvested += int(ndis[s])
                            self.stats.hedge_upgrades += 1
                            if self.tracer is not None:
                                self.tracer.upgrade_terminal(
                                    qid, step=step,
                                    **self._terminal_attrs(
                                        s, qid, ndis, r_pred, obs, step))
                        else:
                            self.stats.hedge_epoch_dropped += 1
                            if self.tracer is not None:
                                self.tracer.event(
                                    "hedge_drop", qid=qid, host=self.host,
                                    step=step,
                                    epoch=int(self.slot_epoch[s]),
                                    cause="epoch")
                    elif self.tracer is not None:
                        self.tracer.event(
                            "hedge_drop", qid=qid, host=self.host,
                            step=step, epoch=int(self.slot_epoch[s]),
                            cause="truncated")
                    self.slot_query[s] = -1
                    self.slot_hedge[s] = False
                    continue
                if qid in self.hedge_winner:
                    self.hedge_winner.discard(qid)
                    self.slot_query[s] = -1
                    if self.tracer is not None:
                        self.tracer.event(
                            "hedge_primary_freed", qid=qid,
                            host=self.host, step=step,
                            epoch=int(self.slot_epoch[s]))
                    continue
                raise RuntimeError(
                    f"host {self.host}: query {qid} harvested twice")
            if self.slot_hedge[s] and truncated:
                # truncated hedge whose primary is still in flight: drop
                # it — the primary (admitted earlier, so deeper) is
                # harvested in this same truncation sweep
                self.slot_query[s] = -1
                self.slot_hedge[s] = False
                if self.tracer is not None:
                    self.tracer.event(
                        "hedge_drop", qid=qid, host=self.host, step=step,
                        epoch=int(self.slot_epoch[s]), cause="truncated")
                continue
            self.results[qid] = (topk_d[s], topk_i[s])
            self.result_epoch[qid] = int(self.slot_epoch[s])
            self.stats.ndis_harvested += int(ndis[s])
            if self.tracer is not None:
                if truncated:
                    term_reason = trunc_reason
                elif obs is not None and obs.early is not None:
                    term_reason = ("interval_met" if bool(obs.early[s])
                                   else "engine_exhausted")
                else:
                    term_reason = "interval_met"
                self.tracer.terminal(
                    qid, term_reason, host=self.host, step=step,
                    epoch=int(self.slot_epoch[s]),
                    **self._terminal_attrs(s, qid, ndis, r_pred, obs,
                                           step))
            if self.slot_hedge[s]:
                # hedge finished before (or with) its primary: its
                # deeper result wins; the primary frees via hedge_winner
                self.hedge_winner.add(qid)
                self.stats.hedge_upgrades += 1
            if self.tiers is not None or self.collect_samples:
                self.samples.append((
                    bool(self.is_hard[qid])
                    if self.is_hard is not None else False,
                    float(r_pred[s]) if r_pred is not None else float("nan"),
                    int(step - self.admit_step[s]), truncated))
            self.slot_query[s] = -1
            self.slot_hedge[s] = False
            count += 1
        if truncated:
            self.stats.truncated += count
        else:
            self.stats.completed += count
        return count

    def kill(self, *, step: int = 0, epoch: int = 0) -> None:
        """Fault injection: this host's slot slice dies. Its queue is
        abandoned (those queries stay None — they were never admitted,
        so there is no state to harvest); the caller harvests the
        in-flight slots first so every ADMITTED query still returns.
        Each abandoned queue entry gets a terminal trace span (reason
        ``abandoned``, cause ``host_killed``)."""
        self.alive = False
        self.stats.killed = True
        self.stats.abandoned = self.pending
        if self.tracer is not None:
            for qid in self.queue_easy + self.queue_hard:
                self.tracer.terminal(
                    qid, "abandoned", host=self.host, step=step,
                    epoch=epoch, cause="host_killed",
                    target=float(self.r_targets[qid]),
                    tier=self._tier_of(qid))
        self.queue_easy = []
        self.queue_hard = []


def _finalize_tiers(hostslots: List[_HostSlots], is_hard: np.ndarray
                    ) -> Dict[str, Any]:
    """Fold the host loops' SLO samples into per-tier TierStats.

    recall_p99 is the 1st percentile of harvest-time predicted recall
    (the recall the worst 1% of the tier got); latency percentiles are
    over engine steps from admission to harvest. Shed/degraded counts
    are attributed to tiers via their recorded query ids; hedges only
    ever duplicate hard-tier queries, so they land on the hard tier."""
    from repro_torch.serve.difficulty import TierStats

    out: Dict[str, Any] = {}
    for name, hard in (("easy", False), ("hard", True)):
        ts = TierStats()
        ts.count = int(np.sum(is_hard == hard))
        rp: List[float] = []
        lat: List[int] = []
        for hl in hostslots:
            for h, r, steps, trunc in hl.samples:
                if h != hard:
                    continue
                if trunc:
                    ts.truncated += 1
                else:
                    ts.completed += 1
                if np.isfinite(r):
                    rp.append(r)
                lat.append(steps)
            ts.shed += sum(1 for q in hl.stats.shed_ids
                           if bool(is_hard[q]) == hard)
            ts.degraded += sum(1 for q in hl.degraded_ids
                               if bool(is_hard[q]) == hard)
            if hard:
                ts.hedged += hl.stats.hedged
                ts.hedge_upgrades += hl.stats.hedge_upgrades
        if rp:
            ts.recall_p50 = obs_stats.p50(rp)
            ts.recall_p99 = obs_stats.p01(rp)
        if lat:
            ts.latency_p50 = obs_stats.p50(lat)
            ts.latency_p99 = obs_stats.p99(lat)
        out[name] = ts
    return out


class DarthServer:
    """Continuous-batching declarative-recall search server.

    Queries stream through a fixed pool of device slots: each slot runs
    one query's darth_search at that query's own declared recall target,
    early-terminated slots are harvested and re-spliced at chunk (sync)
    boundaries, and each chunk steps all slots as one batch on the
    engine's device. See the module docstring for the multi-host
    topology and serve.difficulty for the optional difficulty-tier
    scheduling layer (`tiers`)."""

    def __init__(self, engine: engines_lib.Engine,
                 predictor: RecallPredictor,
                 interval_for_target,        # fn: r_t array -> IntervalParams
                 num_slots: int = 64, steps_per_sync: int = 4,
                 mesh=None, hosts: int = 1, tiers=None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 metrics=None, rerank=None):
        from repro_torch.obs import metrics as obs_metrics
        if mesh is not None:
            from repro_torch.launch.mesh import SearchMesh
            if not isinstance(mesh, SearchMesh):
                raise NotImplementedError(
                    f"DarthServer(mesh=...) takes a launch.mesh.SearchMesh, "
                    f"got {type(mesh).__name__}: no other mesh is ported "
                    f"(sharding, ROADMAP item 8)")
            placed = getattr(engine.index, "base", engine.index)
            if getattr(placed, "mesh", None) != mesh:
                raise ValueError(
                    "DarthServer(mesh=...): the engine's index is not placed "
                    "on this mesh; serve dist.place_index(index, mesh) "
                    "through a sharded engine")
        self.mesh = mesh
        # Host groups of the slot dim: one slice per group of a serve
        # mesh's "hosts" axis, or one slice of every slot.
        self._slot_groups = sharding_lib.slot_sharding(mesh, num_slots)
        self.engine = engine
        # Optional exact re-rank hook (index.residency.RerankStore.rerank
        # or compatible (q, ids) -> (d, i) callable), applied to every
        # completed result after the serve loop: the engine searches the
        # compact SQ8-resident index at an over-provisioned k and the
        # hook restores exact f32 distances/order for the final top-k.
        self.rerank = rerank
        self.predictor = predictor
        self.interval_for_target = interval_for_target
        self.num_slots = num_slots
        self.steps_per_sync = steps_per_sync
        if hosts < 1 or num_slots % hosts:
            raise ValueError(
                f"num_slots {num_slots} must split evenly over "
                f"{hosts} hosts")
        self.hosts = hosts
        # Difficulty-aware admission/scheduling policy
        # (serve.difficulty.TierConfig); None serves every query
        # identically (the original scheduling).
        self.tiers = tiers
        # Engine/predictor version counter: bumped by every hot-swap
        # (set_engine / set_predictor, direct or via request_swap).
        # Slots are stamped with it at admission so harvest can
        # attribute every result to exactly one version.
        self.engine_epoch = 0
        # Staged request_swap payload, applied at the next drained chunk
        # boundary (or immediately when not serving).
        self._pending_swap: Optional[Tuple] = None
        self._serving = False
        # Observability (repro_torch.obs): a Tracer makes the chunks
        # carry the per-slot predicted-recall trajectory ring (a
        # [slots, traj_cap] tensor on the device) and the host loops
        # emit lifecycle spans; a MetricsRegistry aggregates
        # counters/histograms per serve call. Both optional, zero cost
        # when None.
        self.tracer = tracer
        self.metrics = obs_metrics.serve_metrics(metrics)
        # engine-step count at the most recent chunk boundary of the
        # serve in progress — lets on_boundary hooks stamp the trace
        # events they emit
        self.boundary_step = 0
        # In-flight pool (one (state, ring) per host group) at the most
        # recent chunk boundary (None outside serve / right after a
        # swap); chunk_state exposes its search state to on_boundary
        # hooks that plan ahead of the engine.
        self._chunk_pool = None

        self._build_chunks()
        self._bind_groups()

    @property
    def chunk_state(self):
        """The pool's search state at the most recent chunk boundary, all
        slots (host groups joined on the lead device), or None. Device
        tensors; hooks fetch the small fields they need."""
        if self._chunk_pool is None:
            return None
        return _cat_slots([st for st, _ in self._chunk_pool])

    def _bind_groups(self) -> None:
        """Each host group's view of the engine's index (called from
        __init__ and after every engine swap)."""
        if len(self._slot_groups) == 1:
            self._group_index = [self.engine.index]
        else:
            self._group_index = [
                sharding_lib.host_index(self.engine.index, h)
                for h in range(len(self._slot_groups))]

    def _build_chunks(self) -> None:
        """(Re)bind the chunk functions to the current engine and
        predictor (called from __init__ and from the hot-swap paths).
        There is nothing to compile: this only captures the engine
        WITHOUT its index — the index is passed to every chunk, so a
        contents_only engine swap, which keeps these bindings, still
        serves the new index — and the predictor."""
        eng = self.engine._replace(index=None)
        pred = self.predictor
        steps_per_sync = self.steps_per_sync
        traj_cap = None if self.tracer is None else self.tracer.traj_cap

        def run_chunk(index, st: darth_search.DarthState,
                      traj: Optional[torch.Tensor], r_t: torch.Tensor,
                      ipi: torch.Tensor, mpi: torch.Tensor):
            """steps_per_sync Algorithm-1 steps of the whole pool, no host
            sync; with a tracer, each step also records every slot's
            r_pred into the ring (in place, at a host-known column)."""
            body = darth_search.make_darth_body(
                eng._replace(index=index), pred,
                IntervalParams(ipi=ipi, mpi=mpi), r_t)
            for _ in range(steps_per_sync):
                st = body(st)
                if traj is not None:
                    obs_trace.traj_record(traj, st.steps, st.r_pred)
            return st, traj

        def init_chunk(index, q: torch.Tensor, ipi: torch.Tensor,
                       mpi: torch.Tensor):
            # Pass the REAL per-slot mpi through: init only reads ipi,
            # but IntervalParams(mpi=ipi) would lie to any later reader.
            st = darth_search.init_darth_state(
                eng._replace(index=index), q,
                IntervalParams(ipi=ipi, mpi=mpi))
            traj = (None if traj_cap is None else
                    obs_trace.traj_init(q.shape[0], traj_cap, q.device))
            return st, traj

        self._run_chunk = run_chunk
        self._init_chunk = init_chunk

    # -- hot swap (streaming mutations / drift recalibration) --------------
    def set_predictor(self, predictor: RecallPredictor) -> None:
        """Swap a refit recall predictor into the running server (the
        drift monitor's hot-swap path). Rebinds the chunks and bumps
        engine_epoch — in-flight slots keep their admission stamp, so a
        hedge pair spanning the swap can never merge."""
        self.predictor = predictor
        self.engine_epoch += 1
        self._build_chunks()

    def set_engine(self, engine: engines_lib.Engine, *,
                   contents_only: bool = False) -> None:
        """Swap an updated engine in.

        contents_only=True asserts that ONLY the index contents changed
        (same engine family and constructor params — k, nprobe/ef, ...):
        the existing chunk bindings are kept, because the index crosses
        them as an argument. The flag is explicit because
        name/k/max_steps cannot distinguish e.g. two hnsw engines with
        different ef but an identical explicit max_steps — defaulting to
        reuse would silently keep serving with the old params. The
        default rebinds. A swap that REPLACES the index object mid-serve
        must go through request_swap, which drains the pool first.
        Bumps engine_epoch either way."""
        if contents_only and (engine.name != self.engine.name
                              or engine.k != self.engine.k
                              or engine.max_steps != self.engine.max_steps):
            raise ValueError(
                f"contents_only swap changed the engine protocol: "
                f"{self.engine.name}/k={self.engine.k}/"
                f"max_steps={self.engine.max_steps} -> {engine.name}/"
                f"k={engine.k}/max_steps={engine.max_steps}")
        self.engine = engine
        self.engine_epoch += 1
        if not contents_only:
            self._build_chunks()
        self._bind_groups()

    def request_swap(self, engine: Optional[engines_lib.Engine] = None,
                     predictor: Optional[RecallPredictor] = None, *,
                     contents_only: bool = True) -> None:
        """Stage an engine and/or predictor hot-swap for the next SAFE
        chunk boundary. While the swap is pending the server stops
        admitting new queries and lets in-flight slots drain against
        their admission-epoch view (the pool KEEPS STEPPING — this is a
        drain, not a pause); once no slot is occupied the swap applies
        atomically between two chunks and admissions resume against the
        new view, rebuilt state and all. Outside serve() the swap
        applies immediately."""
        if engine is None and predictor is None:
            raise ValueError("request_swap needs an engine, a predictor "
                             "or both")
        if self._pending_swap is not None:
            raise RuntimeError("a hot-swap is already pending")
        self._pending_swap = (engine, predictor, contents_only)
        if not self._serving:
            self._apply_pending_swap()

    @property
    def swap_pending(self) -> bool:
        """True while a request_swap is staged but not yet applied."""
        return self._pending_swap is not None

    def _apply_pending_swap(self) -> None:
        """Apply the staged swap (only at a drained boundary, or when
        not serving)."""
        engine, predictor, contents_only = self._pending_swap
        self._pending_swap = None
        if engine is not None:
            self.set_engine(engine, contents_only=contents_only)
        if predictor is not None:
            self.set_predictor(predictor)

    # -- device placement ---------------------------------------------------
    def _put(self, arr: np.ndarray) -> List[torch.Tensor]:
        """Per-chunk input [num_slots, ...] onto each host group's device,
        cut to the group's slots: one copy per group."""
        if len(self._slot_groups) == 1:
            return [torch.tensor(np.asarray(arr),
                                 device=self.engine.index.device)]
        return sharding_lib.constrain_slots(torch.tensor(np.asarray(arr)),
                                            self.mesh, self.num_slots)

    def _init_pool(self, q, ipi, mpi) -> List[Tuple]:
        """init_chunk per host group, on its view of the index."""
        return [self._init_chunk(index, *parts) for index, parts in
                zip(self._group_index, zip(q, ipi, mpi))]

    @staticmethod
    def _deactivate(pool: List[Tuple], occupied: List[torch.Tensor]
                    ) -> List[Tuple]:
        return [(dataclasses.replace(st, inner=engines_lib.set_active(
            st.inner, st.inner.active & occ)), traj)
            for (st, traj), occ in zip(pool, occupied)]

    def serve(self, queries: np.ndarray, r_targets: np.ndarray,
              max_engine_steps: int = 100_000,
              kill_hosts: Optional[Dict[int, int]] = None,
              on_boundary=None,
              ) -> Tuple[List[Optional[Tuple[np.ndarray, np.ndarray]]],
                         ServeStats]:
        """Process all queries; returns per-query (dists, ids) + stats.

        `kill_hosts` is fault injection for the multi-host topology:
        {host_id: engine_step} kills that host's slot slice at the first
        sync boundary past the given engine step — slots that finished
        at that boundary count completed, in-flight slots are harvested
        (partial top-k, counted as truncated) so every admitted query
        still returns exactly once, and its remaining queue is
        abandoned (those results stay None).

        `on_boundary(server)` is invoked once per chunk boundary,
        between harvest and refill — the hook where a caller can stage
        a hot-swap (request_swap). It runs on the host while the device
        idles at the sync point."""
        from repro_torch.core import api as api_lib

        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2:
            raise ValueError(
                f"queries must be [N, D], got shape {queries.shape}")
        r_targets = np.asarray(r_targets, np.float32)
        if r_targets.shape != (queries.shape[0],):
            raise ValueError(
                f"r_targets shape {r_targets.shape} does not match the "
                f"{queries.shape[0]} queries: the server needs one "
                f"declared recall target per query")
        r_targets = api_lib.validate_targets(r_targets, queries.shape[0])
        self._serving = True
        try:
            return self._serve(queries, r_targets, max_engine_steps,
                               kill_hosts or {}, on_boundary)
        finally:
            self._serving = False
            self._chunk_pool = None

    def _serve(self, queries: np.ndarray, r_targets: np.ndarray,
               max_engine_steps: int, kill_hosts: Dict[int, int],
               on_boundary=None,
               ) -> Tuple[List[Optional[Tuple[np.ndarray, np.ndarray]]],
                          ServeStats]:
        import time

        tr = self.tracer
        mets = self.metrics
        if tr is not None:
            tr.begin()

        # a swap left pending by a previous serve call (budget ran out
        # mid-drain): the pool is empty now, apply before admitting
        if self._pending_swap is not None:
            self._apply_pending_swap()

        n, d = queries.shape
        b = self.num_slots
        sph = b // self.hosts
        stats = ServeStats()
        results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * n

        # Difficulty classification at admission: one host-side routing
        # scan over the whole batch (serve.difficulty), before any query
        # touches a slot. r_targets is copied because admission control
        # may degrade targets in place.
        is_hard = None
        if self.tiers is not None:
            from repro_torch.serve import difficulty as difficulty_lib
            scores = difficulty_lib.difficulty_scores(self.engine.index,
                                                      queries)
            is_hard = difficulty_lib.assign_tiers(scores, self.tiers)
            r_targets = r_targets.copy()

        # Striped query partition: host h owns queries h, h+H, h+2H, ...
        # (hosts == 1 degrades to the single-controller FIFO). Each host
        # loop owns slots [h*sph, (h+1)*sph) and only ever touches them.
        hostslots = [
            _HostSlots(h, h * sph, (h + 1) * sph,
                       list(range(h, n, self.hosts)), queries, r_targets,
                       self.interval_for_target, results,
                       tiers=self.tiers, is_hard=is_hard, tracer=tr,
                       epoch=self.engine_epoch,
                       collect_samples=mets is not None)
            for h in range(self.hosts)]
        stats.hosts = [hl.stats for hl in hostslots]
        chunk_ms: List[float] = []

        def gather_inputs():
            rt = np.concatenate([hl.rt for hl in hostslots])
            ipi = np.concatenate([hl.ipi for hl in hostslots])
            mpi = np.concatenate([hl.mpi for hl in hostslots])
            return rt, ipi, mpi

        def occupied_global():
            return np.concatenate([hl.occupied for hl in hostslots])

        def state_slices():
            """Host-side copies of the per-slot device outputs every host
            loop harvests from (one transfer, then pure local slicing).
            r_pred (the predictor's recall estimate at harvest) is only
            fetched when the tier SLO stats, metrics, or tracer need it;
            the tracer additionally drains the early mask, predictor
            counts, and the trajectory ring AT THIS SAME boundary — no
            extra sync points."""
            sts = [st for st, _ in pool]
            topk_d = _fetch([self.engine.topk_d(st.inner) for st in sts])
            topk_i = _fetch([self.engine.topk_i(st.inner) for st in sts])
            ndis = _fetch([st.inner.ndis for st in sts])
            need_rp = (self.tiers is not None or tr is not None
                       or mets is not None)
            r_pred = _fetch([st.r_pred for st in sts]) if need_rp else None
            obs = None
            if tr is not None:
                obs = _ObsArrays(early=_fetch([st.early for st in sts]),
                                 npred=_fetch([st.npred for st in sts]),
                                 traj=_fetch([traj for _, traj in pool]),
                                 traj_base=traj_base)
            return topk_d, topk_i, ndis, r_pred, obs

        def harvest_host(hl: _HostSlots, mask_local: np.ndarray,
                         arrays, *, truncated: bool = False,
                         reason: Optional[str] = None) -> int:
            topk_d, topk_i, ndis, r_pred, obs = arrays
            sl = slice(hl.lo, hl.hi)
            obs_loc = None
            if obs is not None:
                obs_loc = _ObsArrays(
                    early=obs.early[sl], npred=obs.npred[sl],
                    traj=obs.traj[sl], traj_base=obs.traj_base)
            return hl.harvest(mask_local, topk_d[sl], topk_i[sl], ndis[sl],
                              truncated=truncated,
                              step=stats.engine_steps,
                              r_pred=None if r_pred is None else r_pred[sl],
                              reason=reason, obs=obs_loc)

        # initial fill: every host admits into all of its slots
        fills = [hl.fill(np.arange(sph), step=0, epoch=self.engine_epoch)
                 for hl in hostslots]
        qb = np.concatenate([f[1] for f in fills])
        # The per-slot inputs live on the device between refills: they
        # change only when a refill admits queries.
        rt_dev, ipi_dev, mpi_dev = (self._put(a) for a in gather_inputs())
        traj_base = 0          # engine_steps at the ring's last rebuild
        # the pool: one (search state, trajectory ring) per host group
        pool = self._init_pool(self._put(qb), ipi_dev, mpi_dev)
        # slots with no query: deactivate
        occupied = occupied_global()
        pool = self._deactivate(pool, self._put(occupied))

        while True:
            t0 = time.perf_counter()
            pool = [self._run_chunk(index, st, traj, *inputs)
                    for index, (st, traj), inputs in zip(
                        self._group_index, pool,
                        zip(rt_dev, ipi_dev, mpi_dev))]
            stats.engine_steps += self.steps_per_sync
            for hl in hostslots:
                hl.stats.slot_steps += (self.steps_per_sync
                                        * int(hl.occupied.sum()))
            # fault injection: kill the named hosts at this sync boundary
            dying = [hl for hl in hostslots
                     if hl.alive and hl.host in kill_hosts
                     and stats.engine_steps >= kill_hosts[hl.host]]
            active = _fetch([st.inner.active for st, _ in pool])
            # chunk wall time: dispatch + the sync-boundary fetch that
            # forces the device round-trip
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            finished = occupied & ~active
            arrays = (state_slices()
                      if finished.any() or dying else None)
            changed = False
            for hl in dying:
                # slots that finished at this very boundary hold a full
                # top-k: they completed, only the still-running slots
                # are truncated — then harvest those too, so no
                # admitted query is dropped
                sl = slice(hl.lo, hl.hi)
                fin_local = hl.occupied & ~active[sl]
                if fin_local.any():
                    harvest_host(hl, fin_local, arrays)
                if hl.occupied.any():
                    harvest_host(hl, hl.occupied, arrays, truncated=True,
                                 reason="host_killed")
                hl.kill(step=stats.engine_steps, epoch=self.engine_epoch)
                changed = True
            if finished.any():
                for hl in hostslots:
                    if not hl.alive:
                        continue
                    sl = slice(hl.lo, hl.hi)
                    fin_local = hl.occupied & ~active[sl]
                    if fin_local.any():
                        harvest_host(hl, fin_local, arrays)
                        changed = True
            # chunk boundary: the on_boundary hook, then the
            # drained atomic swap — the pool is retargeted only when NO
            # slot is in flight, so every admitted query runs start to
            # finish against one index version (its admission epoch)
            self.boundary_step = stats.engine_steps
            self._chunk_pool = pool
            if on_boundary is not None:
                swap_was_pending = self._pending_swap is not None
                on_boundary(self)
                if (tr is not None and not swap_was_pending
                        and self._pending_swap is not None):
                    tr.event("swap_staged", step=stats.engine_steps,
                             epoch=self.engine_epoch)
            if (self._pending_swap is not None
                    and not any(hl.occupied.any() for hl in hostslots)):
                self._apply_pending_swap()
                stats.swaps += 1
                if tr is not None:
                    tr.event("swap_applied", step=stats.engine_steps,
                             epoch=self.engine_epoch)
                # chunk state was built against the OLD index (shapes
                # may differ — e.g. HNSW visited rows grow with the
                # graph); force a full init rebuild at the refill
                pool = None
                self._chunk_pool = None
                changed = False
                occupied = occupied_global()
            # per-host refill — unless the step budget is already
            # exhausted: a query spliced in now would run zero steps
            # and be harvested below as init-state junk (ids -1)
            # instead of staying None in the queue. (Without tiering a
            # host only has free slots right after a harvest, so this is
            # a no-op scan on boundaries where nothing finished; with
            # rebalance/hedging enabled idle capacity can also appear
            # between harvests, so the refill runs every boundary.)
            # While a swap is pending, admissions pause: already-running
            # slots drain against their pinned epoch, new queries wait
            # for the new index.
            if (stats.engine_steps < max_engine_steps
                    and self._pending_swap is None):
                if self.tiers is not None and self.tiers.rebalance:
                    self._rebalance(hostslots, step=stats.engine_steps)
                hedging = self.tiers is not None and self.tiers.hedge
                mask = np.zeros((b,), bool)
                qb2 = np.zeros((b, d), np.float32)
                for hl in hostslots:
                    if not hl.alive or not (hl.pending or hedging):
                        continue
                    free = np.nonzero(~hl.occupied)[0]
                    if free.size == 0:
                        continue
                    m_loc, q_loc = hl.fill(free, step=stats.engine_steps,
                                           epoch=self.engine_epoch)
                    if m_loc.any():
                        hl.stats.refills += 1
                        mask[hl.lo:hl.hi] = m_loc
                        qb2[hl.lo:hl.hi] = q_loc
                if mask.any():
                    rt_dev, ipi_dev, mpi_dev = (self._put(a)
                                                for a in gather_inputs())
                    fresh = self._init_pool(self._put(qb2), ipi_dev,
                                            mpi_dev)
                    # after a drained swap pool is None (old chunk state
                    # discarded): the pool is empty, so the fresh init
                    # IS the chunk state — no splice needed. fresh is
                    # (state, ring) and the splice selects both per slot
                    # (a spliced slot's ring row resets to NO_PREDICTION,
                    # clearing the previous occupant's trajectory); on a
                    # full rebuild the ring's column origin moves to the
                    # current step (traj_base) since state.steps restarts
                    # at 0.
                    if pool is None:
                        pool = fresh
                        traj_base = stats.engine_steps
                    else:
                        pool = [_select_slots(m, new, old) for m, new, old
                                in zip(self._put(mask), fresh, pool)]
                    changed = True
            if pool is None:
                # a swap drained the pool and the refill admitted
                # nothing (budget exhausted, or the only pending
                # queries sit on dead hosts): there is no chunk state
                # left to step — exit; unadmitted queries stay None
                break
            if changed:
                # deactivate empty (and dead-host) slots
                occupied = occupied_global()
                pool = self._deactivate(pool, self._put(occupied))
            if (not occupied.any()
                    and not any(hl.pending for hl in hostslots)):
                break
            if stats.engine_steps >= max_engine_steps:
                # Step budget exhausted: the occupied slots still hold a
                # valid partial top-k — harvest it instead of silently
                # dropping those queries (their results[qid] would stay
                # None). Queries never admitted from the queue remain
                # None: they have no state to harvest.
                if occupied.any():
                    arrays = state_slices()
                    for hl in hostslots:
                        if hl.occupied.any():
                            harvest_host(hl, hl.occupied, arrays,
                                         truncated=True)
                break

        for hl in hostslots:
            if hl.alive:
                hl.stats.abandoned = hl.pending
                if tr is not None:
                    # queued to the end (step budget ran out before
                    # admission): close them out so the trace ledger
                    # stays exhaustive — served ∪ shed ∪ abandoned
                    for qid in hl.queue_easy + hl.queue_hard:
                        tr.terminal(
                            qid, "abandoned", host=hl.host,
                            step=stats.engine_steps,
                            epoch=self.engine_epoch, cause="budget",
                            target=float(hl.r_targets[qid]),
                            tier=hl._tier_of(qid))
            stats.completed += hl.stats.completed
            stats.slot_steps += hl.stats.slot_steps
            stats.refills += hl.stats.refills
            stats.truncated += hl.stats.truncated
            stats.ndis_harvested += hl.stats.ndis_harvested
            stats.shed += hl.stats.shed
            stats.degraded += hl.stats.degraded
            stats.hedged += hl.stats.hedged
            stats.hedge_upgrades += hl.stats.hedge_upgrades
            stats.hedge_epoch_dropped += hl.stats.hedge_epoch_dropped
        stats.chunk_ms_p50 = obs_stats.p50(chunk_ms)
        stats.chunk_ms_p99 = obs_stats.p99(chunk_ms)
        if self.tiers is not None:
            stats.tiers = _finalize_tiers(hostslots, is_hard)
        if mets is not None:
            self._export_metrics(mets, stats, hostslots, chunk_ms)
        if tr is not None:
            tr.finish()
        if self.rerank is not None:
            for qid, r in enumerate(results):
                if r is not None:
                    results[qid] = self.rerank(
                        np.asarray(queries[qid], np.float32), r[1])
        return results, stats

    def _export_metrics(self, mets, stats: ServeStats,
                        hostslots: List[_HostSlots],
                        chunk_ms: List[float]) -> None:
        """Fold one serve call's outcome into the metrics registry:
        query counts by terminal outcome, scheduling counters labelled
        per host, and the latency / recall / service-step histograms."""
        qt = mets.counter("darth_queries_total")
        abandoned = sum(h.abandoned for h in stats.hosts)
        for v, outcome in ((stats.completed, "completed"),
                           (stats.truncated, "truncated"),
                           (stats.shed, "shed"),
                           (abandoned, "abandoned")):
            if v:
                qt.inc(v, outcome=outcome)
        for hl in hostslots:
            host = str(hl.host)
            if hl.stats.refills:
                mets.counter("darth_refills_total").inc(
                    hl.stats.refills, host=host)
            if hl.stats.hedged:
                mets.counter("darth_hedges_total").inc(
                    hl.stats.hedged, host=host)
            if hl.stats.stolen:
                mets.counter("darth_steals_total").inc(
                    hl.stats.stolen, host=host)
        if stats.swaps:
            mets.counter("darth_swaps_total").inc(stats.swaps)
        lat_h = mets.histogram("darth_chunk_latency_ms")
        for v in chunk_ms:
            lat_h.observe(v)
        rec_h = mets.histogram("darth_harvest_recall")
        steps_h = mets.histogram("darth_service_steps")
        for hl in hostslots:
            for _, r, steps, _ in hl.samples:
                if np.isfinite(r):
                    rec_h.observe(r)
                steps_h.observe(steps)
        mets.gauge("darth_engine_epoch").set(self.engine_epoch)

    def _rebalance(self, hostslots: List[_HostSlots],
                   step: int = 0) -> None:
        """Queue-level work stealing at a refill boundary.

        Hosts with free slots and a drained queue steal queued queries
        from the most-backlogged live host's arrival tail, hard tier
        first (the expensive queries are moved toward idle capacity).
        Only queue entries move — never in-flight slot state — so a
        stolen query's RESULT is unchanged (per-slot search state is
        slot-local); only which host serves it changes. Deterministic:
        thieves iterate in host order and the donor is the max-pending
        live host, ties to the lowest host id. Stealing stops once the
        donor can admit its whole backlog into its own free slots."""
        live = [hl for hl in hostslots if hl.alive]
        for thief in live:
            if thief.pending:
                continue
            spare = int((~thief.occupied).sum())
            while spare > 0:
                donor = max(live,
                            key=lambda hl: (hl.pending, -hl.host))
                if (donor is thief
                        or donor.pending <= int((~donor.occupied).sum())):
                    break
                src = donor.queue_hard or donor.queue_easy
                qid = src.pop()
                dst = (thief.queue_hard
                       if thief.is_hard is not None and thief.is_hard[qid]
                       else thief.queue_easy)
                dst.append(qid)
                thief.stats.stolen += 1
                spare -= 1
                if self.tracer is not None:
                    self.tracer.event(
                        "steal", qid=qid, host=thief.host, step=step,
                        epoch=self.engine_epoch, donor=donor.host)
