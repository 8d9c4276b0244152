"""The port's optimizers (``repro_torch.optim``) against the JAX
reference on the CPU: ports of tests/test_optim.py, and parity on
identical inputs.

Measured here: ``compress_roundtrip`` is bit-equal to the reference run
op by op (``jax.disable_jit``); jitted, XLA turns the division by 127
into a product with its reciprocal and moves a scale by an ulp. AdamW
is bit-equal to the eager reference but where the bias correction's
``b ** t`` comes out an ulp apart (XLA's ``pow`` against torch's, e.g.
0.95 ** 6), which moves a parameter by at most ADAMW_ULPS; under
``jax.jit`` XLA fuses the update and moves some elements by up to 38
ulps (p - lr * delta near cancellation), as far as the reference's own
eager run lies from its jitted one. So each is held to the reference's
eager run within ADAMW_ULPS, and to its jitted run within the
reference's own eager-vs-jit gap plus ADAMW_ULPS. Adafactor's means and
the schedule's cosine come out up to 3 ulps from the reference's (XLA's
reduction order, its ``cos``): held within 4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import grad_compress as ref_gc  # noqa: E402
from repro.optim import schedule as ref_sched  # noqa: E402
from repro_torch.optim import (AdamWConfig, adafactor_init,  # noqa: E402
                               adafactor_update, adamw_init, adamw_update,
                               grad_compress, schedule)

SHAPES = {"w": (3, 5, 7), "b": (7,), "c": (1, 9), "e": (16, 8)}
ADAMW_ULPS = 2
ADAFACTOR_ULPS = 4
SCHEDULE_ULPS = 4


def ulps(a, b) -> np.ndarray:
    """Elementwise distance in f32 ulps (same-sign values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def to_ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def grads(rng):
    """Gradients of every scale from 1e-6 to 10, one per leaf."""
    return {k: (rng.normal(size=s) * 10 ** rng.uniform(-6, 1)
                ).astype(np.float32) for k, s in SHAPES.items()}


# ---------------------------------------------------------------------------
# ports of tests/test_optim.py
# ---------------------------------------------------------------------------

def _quad_problem():
    target = {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]]),
              "b": torch.tensor([0.1, -0.3])}

    def loss(p):
        return (torch.sum((p["w"] - target["w"]) ** 2)
                + torch.sum((p["b"] - target["b"]) ** 2))
    return loss, {k: torch.zeros_like(v) for k, v in target.items()}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_minimize_quadratic(opt):
    loss, p = _quad_problem()
    init, update = ((adamw_init, adamw_update) if opt == "adamw"
                    else (adafactor_init, adafactor_update))
    state = init(p)
    l0 = float(loss(p))
    for _ in range(200):
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        g = dict(zip(live, torch.autograd.grad(loss(live), list(
            live.values()))))
        p, state = update(g, state, p, torch.tensor(0.05))
    assert float(loss(p)) < 0.05 * l0
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 200


def test_adamw_weight_decay_shrinks():
    p = {"w": torch.ones(4) * 10.0}
    cfg = AdamWConfig(weight_decay=0.1)
    p2, _ = adamw_update({"w": torch.zeros(4)}, adamw_init(p, cfg), p,
                         torch.tensor(0.1), cfg)
    assert float(p2["w"][0]) < 10.0


@settings(deadline=None, max_examples=20)
@given(n=st.integers(5, 2000), scale=st.floats(1e-4, 1e3))
def test_int8_compression_error_bounded(n, scale):
    """Per element, |x - roundtrip(x)| <= s / 2 (half a quantization step,
    s = the block's scale) + 4 f32 ulps of the block's largest |x|: the
    rounding of x / s and of q * s. (The reference's test allows
    blockmax / 254 + 1e-6, which f32 rounding alone exceeds at scale ~1e3;
    ROADMAP "Reference caveats".)"""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * scale).astype(np.float32)
    y = grad_compress.compress_roundtrip(torch.from_numpy(x)).numpy()
    _, s = grad_compress._quantize(torch.from_numpy(x))
    blocks = np.pad(np.abs(x), (0, (-n) % grad_compress.BLOCK)).reshape(
        -1, grad_compress.BLOCK)
    per = lambda a: np.repeat(a, grad_compress.BLOCK)[:n]  # noqa: E731
    bound = per(s.numpy()[:, 0].astype(np.float64)) / 2 + \
        per(blocks.max(1).astype(np.float64)) * 2.0 ** -22
    err = np.abs(x.astype(np.float64) - y.astype(np.float64))
    assert (err <= bound).all()


def test_error_feedback_telescopes():
    """sum of sent values + final error == sum of true grads: the
    compression never loses mass over time."""
    rng = np.random.default_rng(0)
    true = [torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))
            for _ in range(10)]
    e = torch.zeros(300)
    sent_total = torch.zeros(300)
    for g in true:
        gf = g + e
        sent = grad_compress.compress_roundtrip(gf)
        e = gf - sent
        sent_total = sent_total + sent
    np.testing.assert_allclose((sent_total + e).numpy(),
                               sum(true).numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# parity on identical inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr_kind", ["scalar", "schedule"])
def test_adamw_bit_equal_to_the_reference(lr_kind):
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    rj, re, pp = to_ref(p0), to_ref(p0), to_port(p0)
    sj, se, sp = (ref_adamw.adamw_init(rj), ref_adamw.adamw_init(re),
                  adamw_init(pp))
    jitted = jax.jit(ref_adamw.adamw_update)
    for i in range(6):
        g = grads(rng)
        if lr_kind == "scalar":
            lr = np.float32(1e-3 * (i + 1))
            lj, lp = jnp.asarray(lr), torch.tensor(lr)
        else:
            lj = ref_sched.warmup_cosine(se["step"], peak_lr=1e-2,
                                         warmup_steps=2, total_steps=5)
            lp = schedule.warmup_cosine(sp["step"], peak_lr=1e-2,
                                        warmup_steps=2, total_steps=5)
            lp = torch.tensor(np.asarray(lj))   # the same lr on both
        rj, sj = jitted(to_ref(g), sj, rj, lj)
        with jax.disable_jit():
            re, se = ref_adamw.adamw_update(to_ref(g), se, re, lj)
        pp, sp = adamw_update(to_port(g), sp, pp, lp)
        assert sp["step"].dtype == torch.int32
        assert int(sp["step"]) == int(se["step"]) == i + 1
        for name, jt, et, pt in (("params", rj, re, pp),
                                 ("m", sj["m"], se["m"], sp["m"]),
                                 ("v", sj["v"], se["v"], sp["v"])):
            for k in SHAPES:
                assert ulps(et[k], pt[k]).max() <= ADAMW_ULPS, (name, k, i)
                gap = ulps(jt[k], et[k])        # the reference's own
                assert (ulps(jt[k], pt[k]) <= gap + ADAMW_ULPS).all(), \
                    (name, k, i)


def test_adafactor_matches_the_reference():
    """Factored ([3, 5, 7], [16, 8]) and unfactored ([7], [1, 9]) leaves,
    RMS clipping, the bf16 first moment: within ADAFACTOR_ULPS of the
    reference, jitted and eager; the bf16 moment within one bf16 ulp."""
    rng = np.random.default_rng(1)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    rp, pp = to_ref(p0), to_port(p0)
    rs, ps = ref_adamw.adafactor_init(rp), adafactor_init(pp)
    assert set(ps["leaves"]["w"]) == {"v_row", "v_col", "m"}
    assert set(ps["leaves"]["c"]) == {"v", "m"}
    assert ps["leaves"]["w"]["m"].dtype == torch.bfloat16
    jitted = jax.jit(ref_adamw.adafactor_update)
    for i in range(5):
        g = grads(rng)
        lr = np.float32(1e-2)
        with jax.disable_jit():
            re, _ = ref_adamw.adafactor_update(to_ref(g), rs, rp,
                                               jnp.asarray(lr))
        rp, rs = jitted(to_ref(g), rs, rp, jnp.asarray(lr))
        pp, ps = adafactor_update(to_port(g), ps, pp, torch.tensor(lr))
        for k in SHAPES:
            assert ulps(rp[k], pp[k]).max() <= ADAFACTOR_ULPS, (k, i)
            assert ulps(re[k], pp[k]).max() <= ADAFACTOR_ULPS, (k, i)
            for name, want in rs["leaves"][k].items():
                got = ps["leaves"][k][name]
                if name == "m":
                    np.testing.assert_allclose(as_np(got), as_np(want),
                                               rtol=2.0 ** -7, atol=0)
                else:
                    assert ulps(want, got).max() <= ADAFACTOR_ULPS, \
                        (k, name, i)
    assert int(ps["step"]) == 5


@pytest.mark.parametrize("warmup,total", [(100, 250), (0, 10), (5, 5)])
def test_schedule_matches_the_reference(warmup, total):
    steps = np.arange(0, 300, dtype=np.int32)
    want = ref_sched.warmup_cosine(jnp.asarray(steps), peak_lr=3e-4,
                                   warmup_steps=warmup, total_steps=total)
    got = schedule.warmup_cosine(torch.from_numpy(steps), peak_lr=3e-4,
                                 warmup_steps=warmup, total_steps=total)
    assert got.dtype == torch.float32
    assert ulps(want, got).max() <= SCHEDULE_ULPS
    const = schedule.constant(torch.tensor(7, dtype=torch.int32),
                              peak_lr=3e-4)
    assert const.dtype == torch.float32
    np.testing.assert_array_equal(as_np(const), as_np(ref_sched.constant(
        jnp.asarray(7, jnp.int32), peak_lr=3e-4)))


@pytest.mark.parametrize("n,scale", [(5, 1e-4), (256, 1.0), (1000, 100.0),
                                     (2000, 1e3)])
def test_compress_roundtrip_bit_equal(n, scale):
    """Blockwise int8 with round half to even (``jnp.round`` and
    ``torch.round`` alike): the int8 codes, scales and roundtrip equal the
    eager reference's bit for bit, on values that put some x / s on a
    .5; the jitted reference's within its own gap to its eager run (one
    ulp of a scale)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * scale).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 127.0]            # ties against the block max
    with jax.disable_jit():
        qj, sj = ref_gc._quantize(jnp.asarray(x))
        want = np.asarray(ref_gc.compress_roundtrip(jnp.asarray(x)))
    qp, sp = grad_compress._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    got = grad_compress.compress_roundtrip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(jax.jit(ref_gc.compress_roundtrip)(jnp.asarray(x)))
    assert (ulps(jitted, got) <= ulps(jitted, want)).all()
    assert ulps(jitted, want).max() <= 1
