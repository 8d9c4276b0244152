"""The port's residency module against the JAX reference's.

The SQ8 conversions are host numpy on both sides, so codes, scale,
offset and sqnorms must be equal bit for bit, and so must the byte
accounting and the host re-rank (pads included). Served through the
slot pool at an over-provisioned k with the f32 re-rank hook (the
reference's shipped residency path), the port returns the reference's
final ids.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engines as ref_engines  # noqa: E402
from repro.index import hnsw as ref_hnsw  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro.index import residency as ref_res  # noqa: E402
from repro.serve import DarthServer as RefServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.index import residency  # noqa: E402
from repro_torch.serve import DarthServer  # noqa: E402

from test_torch_serve import K, NLIST, SLOTS, SPS, carried  # noqa: E402,F401


@pytest.fixture(scope="module")
def float_ds():
    return vectors.make_dataset(n=3000, d=24, num_learn=64, num_queries=32,
                                clusters=16, cluster_std=1.2, seed=3)


@pytest.fixture(scope="module")
def ivf_pair(float_ds):
    ref_index = ref_ivf.build(float_ds.base, nlist=16, seed=0)
    return ref_index, convert.ivf_index_from_numpy(
        convert.fields_as_numpy(ref_index), "cpu")


@pytest.fixture(scope="module")
def hnsw_pair(float_ds):
    ref_index = ref_hnsw.build(float_ds.base, m=8, passes=1,
                               ef_construction=32, seed=0)
    # one tombstoned row: dead rows keep sqnorm +inf and stay out of the
    # range
    ref_index = dataclasses.replace(
        ref_index, sqnorm=ref_index.sqnorm.at[5].set(jnp.inf))
    return ref_index, convert.hnsw_index_from_numpy(
        convert.fields_as_numpy(ref_index), "cpu")


def assert_fields_equal(ref_index, index):
    ref_fields = convert.fields_as_numpy(ref_index)
    fields = {f.name: getattr(index, f.name).numpy()
              for f in dataclasses.fields(index)
              if getattr(index, f.name) is not None}
    assert sorted(fields) == sorted(ref_fields)
    for name, want in ref_fields.items():
        assert fields[name].dtype == want.dtype, name
        np.testing.assert_array_equal(fields[name], want, err_msg=name)


def test_sq8_range_equals_reference(float_ds):
    for x in (float_ds.base, float_ds.base[:7], np.ones((4, 3), np.float32)):
        for a, b in zip(residency.sq8_range(x), ref_res.sq8_range(x)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_quantize_equals_reference_bit_for_bit(kind, ivf_pair, hnsw_pair):
    ref_index, index = ivf_pair if kind == "ivf" else hnsw_pair
    quantize = residency.quantize_ivf if kind == "ivf" \
        else residency.quantize_hnsw
    ref_quantize = ref_res.quantize_ivf if kind == "ivf" \
        else ref_res.quantize_hnsw
    sq8, ref_sq8 = quantize(index), ref_quantize(ref_index)
    assert sq8.quantized and not index.quantized
    assert sq8.device == index.device
    assert_fields_equal(ref_sq8, sq8)
    assert quantize(sq8) is sq8                 # already SQ8: unchanged


@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_resident_bytes_equal_reference(kind, ivf_pair, hnsw_pair):
    ref_index, index = ivf_pair if kind == "ivf" else hnsw_pair
    quantize = residency.quantize_ivf if kind == "ivf" \
        else residency.quantize_hnsw
    ref_quantize = ref_res.quantize_ivf if kind == "ivf" \
        else ref_res.quantize_hnsw
    for view, ref_view in ((index, ref_index),
                           (quantize(index), ref_quantize(ref_index))):
        assert residency.resident_bytes(view) == \
            ref_res.resident_bytes(ref_view)
    f32, sq8 = (residency.resident_bytes(v)["total"]
                for v in (index, quantize(index)))
    assert f32 / sq8 > 2.0


@pytest.mark.parametrize("ids,k", [
    ([5, -1, 17, 9_000_000, 3], 5),     # a pad and a bogus id
    ([5, -1, 17, 9_000_000, 3], 8),     # k beyond the candidates
    ([12, 12, 40, 7], 0),               # a duplicate; k = 0 keeps all
    (list(range(0, 3000, 97)), 10)])
def test_rerank_equals_reference(float_ds, ids, k):
    ref_store = ref_res.RerankStore(float_ds.base)
    store = residency.RerankStore(float_ds.base)
    for q in float_ds.queries[:4]:
        got = store.rerank(q, np.asarray(ids), k)
        want = ref_store.rerank(q, np.asarray(ids), k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        hook = store.reranker(k)(q, np.asarray(ids))
        np.testing.assert_array_equal(hook[1], want[1])


def test_sq8_rerank_serve_equals_reference(carried):
    """The shipped residency path: the SQ8 view of the carried index
    served at k' = 4k with the f32 re-rank hook returning the final k."""
    ref_d, port_d, _, q, rts = carried
    ref_sq8 = ref_res.quantize_ivf(ref_d.engine.index)
    sq8 = residency.quantize_ivf(port_d.engine.index)
    # the base vectors, in id order, from the f32 buckets
    base = np.zeros((int(sq8.bucket_ids.max()) + 1, q.shape[1]), np.float32)
    ids = port_d.engine.index.bucket_ids.numpy()
    base[ids[ids >= 0]] = port_d.engine.index.bucket_vecs.numpy()[ids >= 0]
    out = []
    for srv_cls, eng, d, store in (
            (RefServer, ref_engines.ivf_engine(ref_sq8, k=4 * K,
                                               nprobe=NLIST), ref_d,
             ref_res.RerankStore(base)),
            (DarthServer, engines.ivf_engine(sq8, k=4 * K, nprobe=NLIST),
             port_d, residency.RerankStore(base))):
        srv = srv_cls(eng, d.trained.predictor, d.interval_for_target,
                      num_slots=SLOTS, steps_per_sync=SPS, hosts=2,
                      rerank=store.reranker(K))
        out.append(srv.serve(q, rts))
    (res_r, st_r), (res_p, st_p) = out
    assert st_p.completed == st_r.completed == q.shape[0]
    assert st_p.ndis_harvested == st_r.ndis_harvested
    for a, b in zip(res_r, res_p):
        assert b[1].shape == (K,)
        np.testing.assert_array_equal(b[1], a[1])
        np.testing.assert_array_equal(b[0], a[0])
