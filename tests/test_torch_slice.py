"""The port alone, end to end: ivf.build (or hnsw.build) -> Darth.fit ->
Darth.search.

Each declared target in {0.8, 0.9, 0.95} is met within 0.03, the
reference's conformance tolerance (tests/test_recall_conformance.py),
with fewer distance calculations than the exhaustive plain search.
"""
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores, and
# torch's default pool (a thread per core in every worker) oversubscribes
# them, which made these tests many times slower there.
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import api, engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.index import flat, hnsw, ivf  # noqa: E402

TOL = 0.03


def _dataset():
    return vectors.make_dataset(n=4000, d=16, num_learn=1000, num_queries=256,
                                clusters=128, center_scale=1.5, seed=0)


@pytest.fixture(scope="module")
def fitted():
    ds = _dataset()
    index = ivf.build(ds.base, nlist=32, seed=0, device="cpu")
    darth = api.Darth(
        make_engine=lambda **kw: engines.ivf_engine(index, **kw),
        engine=engines.ivf_engine(index, k=10, nprobe=32))
    trained = darth.fit(ds.learn, ds.base)
    assert set(darth.fit_seconds) == {"ground_truth", "observations", "gbdt"}
    assert np.isfinite(trained.metrics["mse"])
    q = torch.as_tensor(ds.queries)
    _, gt = flat.search(q, torch.as_tensor(ds.base), 10)
    _, ids, plain = darth.search_plain(q)
    assert float(flat.recall_at_k(ids, gt).mean()) == 1.0  # exhaustive
    return darth, q, gt, float(plain.ndis.float().mean())


def _assert_target_met(darth, q, gt, plain_ndis, target):
    d, ids, st = darth.search(q, target)
    assert d.shape == ids.shape == (q.shape[0], 10)
    assert torch.isfinite(d).all() and (ids >= 0).all()
    recall = float(flat.recall_at_k(ids, gt).mean())
    assert recall >= target - TOL, (target, recall)
    assert float(st.inner.ndis.float().mean()) < plain_ndis
    assert st.early.any() and (st.npred > 0).any()


@pytest.mark.parametrize("target", [0.8, 0.9, 0.95])
def test_declared_target_met(fitted, target):
    _assert_target_met(*fitted, target)


@pytest.fixture(scope="module")
def fitted_hnsw():
    """The reference's HNSW build defaults (m 16, ef_construction 64, two
    passes); ef 96 takes plain search's recall near 1."""
    ds = _dataset()
    index = hnsw.build(ds.base, m=16, ef_construction=64, passes=2, seed=0,
                       device="cpu")
    darth = api.Darth(
        make_engine=lambda **kw: engines.hnsw_engine(index, **kw),
        engine=engines.hnsw_engine(index, k=10, ef=96, max_steps=200))
    darth.fit(ds.learn, ds.base)
    q = torch.as_tensor(ds.queries)
    _, gt = flat.search(q, torch.as_tensor(ds.base), 10)
    _, ids, plain = darth.search_plain(q)
    assert float(flat.recall_at_k(ids, gt).mean()) >= 0.99
    assert not plain.active.any()  # natural termination within the limit
    return darth, q, gt, float(plain.ndis.float().mean())


@pytest.mark.parametrize("target", [0.8, 0.9, 0.95])
def test_hnsw_declared_target_met(fitted_hnsw, target):
    _assert_target_met(*fitted_hnsw, target)
