"""``reduce.index_sum``: the sums by index that the GBDT fit and k-means
take, fixed-point (order-free) on the card and ``index_add_`` on the CPU.

The card's path is ``fixed_point_index_sum``, which runs on any device, so
its arithmetic is checked here: the same bits whatever the order of the
rows, and the exact sum rounded to float32."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.reduce import fixed_point_index_sum, index_sum  # noqa: E402


def _rows(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    v = torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 40, shape[0]))
    return v, idx


@pytest.mark.parametrize("shape,scale", [((50_000,), 1.0), ((20_000, 6), 1e3),
                                         ((3_000, 4), 1e-20)])
def test_fixed_point_sum_is_order_free_and_exact(shape, scale):
    v, idx = _rows(shape, seed=len(shape), scale=scale)
    got = fixed_point_index_sum(idx, v, 40)
    perm = torch.randperm(shape[0], generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, fixed_point_index_sum(idx[perm], v[perm], 40))
    exact = torch.zeros((40,) + shape[1:], dtype=torch.float64).index_add_(
        0, idx, v.double())
    # the exact sum rounded to float32, to one ulp (a rounding tie may go
    # either way after the fixed-point step)
    ulp = torch.finfo(torch.float32).eps * exact.abs().float()
    assert ((got.double() - exact).abs() <= ulp.double() + 1e-45).all()
    assert got.dtype == torch.float32 and got.shape == (40,) + shape[1:]


def test_fixed_point_sum_of_nothing_and_of_zeros():
    idx = torch.zeros((0,), dtype=torch.long)
    assert torch.equal(fixed_point_index_sum(idx, torch.zeros((0, 3)), 5),
                       torch.zeros((5, 3)))
    idx = torch.tensor([0, 2, 2])
    assert torch.equal(fixed_point_index_sum(idx, torch.zeros(3), 4),
                       torch.zeros(4))


def test_index_sum_on_the_cpu_is_index_add():
    """On the CPU the port's sums stay ``index_add_`` in row order, bit
    for bit, so the fit keeps the reference's trees there."""
    v, idx = _rows((20_000, 3), seed=5)
    want = torch.zeros((40, 3)).index_add_(0, idx, v)
    assert torch.equal(index_sum(idx, v, 40), want)
