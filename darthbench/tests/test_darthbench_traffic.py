"""The one traffic generator: stratified per-query parameters, the
open-loop schedule, and latency measured from each request's due time."""
import types

import numpy as np
import pytest
import torch

from darthbench import bench, data, traffic

DATA = {"seed": 0, "n": 500, "dim": 8, "clusters": 6, "cluster_std": 1.0,
        "center_scale": 4.0, "learn": 40, "learn_noisy_share": 0.2,
        "learn_far_share": 0.1, "learn_noise_pct": [0.5, 8.0]}


def test_the_data_set_is_the_configurations_and_big_seeds_work():
    a = data.make_collection(DATA, "cpu")
    b = data.make_collection(DATA, "cpu")
    c = data.make_collection(dict(DATA, seed=1), "cpu")
    assert torch.equal(a.base, b.base) and torch.equal(a.learn, b.learn)
    assert not torch.equal(a.base, c.base)
    assert a.base.shape == (500, 8) and a.learn.shape == (40, 8)
    s = traffic.make_stream({"shares": {"clean": 1.0}, "targets": [0.9]}, a,
                            2**31 + 977, 50)
    assert s.host.shape == (50, 8)


def test_each_seed_draws_new_queries_in_the_same_stated_shares():
    mix = {"shares": {"clean": 0.5, "noisy": 0.5},
           "noise_pct": [0.5, 8.0], "targets": [0.8, 0.9, 0.95]}
    coll = data.make_collection(DATA, "cpu")
    s1 = traffic.make_stream(mix, coll, 11, 120)
    s2 = traffic.make_stream(mix, coll, 12, 120)
    again = traffic.make_stream(mix, coll, 11, 120)
    assert np.array_equal(s1.host, again.host)
    assert np.array_equal(s1.targets, again.targets)
    rows1 = {tuple(r) for r in s1.host.tolist()}
    rows2 = {tuple(r) for r in s2.host.tolist()}
    assert not rows1 & rows2
    for s in (s1, s2):
        assert sorted(np.unique(s.targets, return_counts=True)[1]) == [40] * 3
        kinds, counts = np.unique(s.kinds, return_counts=True)
        assert dict(zip(kinds, counts)) == {"clean": 60, "noisy": 60}
    assert np.array_equal(s1.host, s1.queries.numpy())


def test_noise_is_stratified_over_the_stated_range():
    mix = {"shares": {"noisy": 1.0}, "noise_pct": [0.5, 8.0],
           "targets": [0.9]}
    coll = data.make_collection(DATA, "cpu")
    clean = traffic.make_stream(dict(mix, shares={"clean": 1.0}), coll, 3,
                                400)
    noisy = traffic.make_stream(mix, coll, 3, 400)
    # the same draw of modes and spreads, then noise of sigma^2 = pct *
    # ||q|| / D per row: its mean square over the rows follows the mean pct
    move = ((noisy.queries - clean.queries) ** 2).sum(1)
    norms = torch.linalg.vector_norm(clean.queries, dim=1)
    assert float((move / norms).mean()) == pytest.approx(4.25, rel=0.1)


def test_open_schedule_rate_bounds_and_shuffled_gaps():
    mix = {"rate_qps": 500.0}
    a = traffic.arrivals(mix, 1, 4.0)
    b = traffic.arrivals(mix, 2, 4.0)
    for t in (a, b):
        assert np.all(np.diff(t) >= 0) and t[0] == 0 and t[-1] < 4.0
        assert abs(t.size - 2000) < 200
    # every gap is one of the same exponential quantiles, in another order
    m = int(np.ceil(1.5 * 500.0 * 4.0)) + 64
    q = -np.log1p(-(np.arange(m) + 0.5) / m)
    for t in (a, b):
        g = np.diff(t) * 500.0
        j = np.clip(np.searchsorted(q, g), 1, m - 1)
        near = np.minimum(np.abs(q[j] - g), np.abs(q[j - 1] - g))
        assert near.max() < 1e-9
    assert not np.array_equal(a[:100], b[:100])


class _SleepyServer:
    """Answers every query after a fixed wait."""

    def __init__(self, wait):
        self.wait, self.calls = wait, []

    def serve(self, queries, targets, max_engine_steps, on_boundary=None):
        import time
        time.sleep(self.wait)
        self.calls.append(len(queries))
        stats = types.SimpleNamespace(completed=len(queries), truncated=0)
        return [(np.zeros(1), np.zeros(1, int))] * len(queries), stats


def test_open_loop_latency_runs_from_the_due_time():
    due = np.array([0.0, 0.01, 0.02, 0.2, 0.21])
    server = _SleepyServer(0.05)
    run = bench.Run(cell={}, config={"server": {"max_engine_steps": 10}},
                    traffic={"kind": "open"}, seed=0, seconds=0.3,
                    traced=False, num_slots=4)
    stream = traffic.Stream(queries=torch.zeros(5, 2), host=np.zeros((5, 2)),
                            targets=np.full(5, 0.9, np.float32),
                            kinds=np.array(["clean"] * 5), due=due)
    system = bench.System(coll=None, built=None, darth=None, server=server,
                          stream=stream)
    bench.window(run, system)
    assert sum(server.calls) == 5 and run.attempted == 5
    ends = np.concatenate([[c.end] * c.n for c in run.calls])
    assert np.allclose(run.latencies_ms, (ends - due) * 1e3)
    # the first request waits for its own call; the second arrives while
    # the first call runs and so waits for it and then for its own
    assert run.latencies_ms[1] > 50.0 + 40.0 - 5.0
    assert run.latencies_ms[0] == pytest.approx(50.0, abs=15.0)
