"""The port's chunked linear attention, Mamba2 and RWKV-6 functions
(``repro_torch.models.linear_attn``) against the JAX reference's
(``repro.models.linear_attn``), on the CPU at small widths.

Both packages get the same seeded numpy inputs, in the same dtypes.
Tolerances, as measured here (the worst of these cases, then a margin):

- Elementwise steps are EQUAL bit for bit: ``sigmoid`` over every bf16
  value and the causal convolution, summed in the reference's order;
  ``softplus`` (``logaddexp(x, 0)``) is within one f32 ulp (the last ulp
  of exp and log1p).
- The chunked recurrence and the decode step are f32 einsums: the port's
  summation order differs from XLA's, so they agree to a few f32 ulps of
  the largest term (measured <= 4.4e-7 relative; rtol 1e-5 below). The
  chunked form against a loop of steps: the reference's own bound, 1e-4.
- A whole block (bf16 GEMMs around the f32 recurrence) is EQUAL bit for
  bit (the Mamba2 block and decode, the channel-mix, both decode steps)
  or one bf16 ulp off in an element (the time-mix: the recurrence's sum
  order moves a rounding); rtol 2^-7 of the largest term below.
"""
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import linear_attn as ref_la  # noqa: E402
from repro_torch.models import layers, linear_attn as la  # noqa: E402

BF16_ULP = 2.0 ** -7
F32_RTOL = 1e-5


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def both(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, torch.as_tensor(as_np(j)).to(getattr(torch, dtype))


def close(port, ref, rtol=F32_RTOL, atol=0.0, what=""):
    """|port - ref| <= atol + rtol * max|ref| (relative to the largest
    term: the einsums' sums make small entries the difference of big
    ones)."""
    p, r = as_np(port), as_np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    assert np.isfinite(p).all() and np.isfinite(r).all()
    err = float(np.abs(p - r).max()) if p.size else 0.0
    assert err <= atol + rtol * float(np.abs(r).max()), (what, err)


def params(shapes, rng, scale=0.2, dtype="bfloat16"):
    """Seeded parameters of ``shapes`` for both packages: the constant
    leaves as the reference's init sets them (a_log 0, dt_bias -2, d_skip
    1, w0 0, bonus_u 0.5, the scales 1, mu_* 0.5), others normal."""
    const = {"a_log": 0.0, "dt_bias": -2.0, "d_skip": 1.0, "w0": 0.0,
             "bonus_u": 0.5, "ln_x_scale": 1.0, "norm_scale": 1.0}
    pj, pt = {}, {}
    for name, shape in shapes.items():
        if name in const or name.startswith("mu_"):
            val = np.full(shape, const.get(name, 0.5))
        else:
            val = rng.normal(size=shape) * scale
        pj[name], pt[name] = both(val, dtype)
    return pj, pt


# ---------------------------------------------------------------------------
# elementwise steps
# ---------------------------------------------------------------------------

def test_sigmoid_and_softplus_equal_reference():
    """sigmoid as lax.logistic, bit for bit over every finite bf16 value
    (subnormals flushed, as XLA does); softplus as logaddexp(x, 0) in
    f32 over [-104, 88], within the last ulp of exp and log1p."""
    bits = np.arange(1 << 16, dtype=np.uint16).view(np.int16)
    x = torch.from_numpy(bits).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    assert torch.set_flush_denormal(True)
    try:
        got = layers.sigmoid(x)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(got), as_np(jax.nn.sigmoid(xj)))
    finally:
        torch.set_flush_denormal(False)
    xs = np.concatenate([np.linspace(-60, 60, 4001), [0.0, 19.99, 20.01,
                                                     88.0, -104.0]])
    sj, st = both(xs)
    got = la.softplus(st)
    # one f32 ulp apart at most (measured): the last ulp of exp and log1p
    np.testing.assert_allclose(as_np(got), as_np(jax.nn.softplus(sj)),
                               rtol=2.0 ** -22, atol=0)
    assert torch.isnan(la.softplus(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_causal_conv_equals_reference(dtype):
    """Tap 0 first, each product and partial sum in the inputs' dtype:
    equal bit for bit."""
    rng = np.random.default_rng(0)
    xj, xt = both(rng.normal(size=(2, 9, 12)), dtype)
    wj, wt = both(rng.normal(size=(4, 12)), dtype)
    got = la._causal_conv(xt, wt)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(as_np(got), as_np(ref_la._causal_conv(
        xj, wj)))


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

# (strict (RWKV's u), with s0, T, chunk): T equal to the chunk, several
# chunks, shorter than the chunk (one chunk of T).
CHUNK_CASES = [(True, False, 16, 16), (True, True, 48, 16),
               (False, False, 48, 16), (False, True, 16, 16),
               (True, True, 10, 64), (False, False, 64, 8)]


def _recurrence_inputs(rng, b, t, h, dk, dv, in_dtype="float32"):
    q = both(rng.normal(size=(b, t, h, dk)), in_dtype)
    k = both(rng.normal(size=(b, t, h, dk)), in_dtype)
    v = both(rng.normal(size=(b, t, h, dv)), in_dtype)
    lw = both(-np.exp(rng.normal(size=(b, t, h, dk)) * 0.5 - 1.0))
    return q, k, v, lw


@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
def test_chunked_linear_attention_equals_reference(case):
    strict, with_s0, t, chunk = CHUNK_CASES[case]
    rng = np.random.default_rng(case)
    b, h, dk, dv = 2, 3, 8, 4
    (qj, qt), (kj, kt), (vj, vt), (wj, wt) = _recurrence_inputs(
        rng, b, t, h, dk, dv, "bfloat16" if case % 2 else "float32")
    uj, ut = both(rng.normal(size=(h, dk)))
    sj, st = both(rng.normal(size=(b, h, dk, dv)) * 0.3)
    kw_j = dict(u=uj if strict else None, s0=sj if with_s0 else None,
                chunk=chunk)
    kw_t = dict(u=ut if strict else None, s0=st if with_s0 else None,
                chunk=chunk)
    yj, fj = ref_la.chunked_linear_attention(qj, kj, vj, wj, **kw_j)
    yt, ft = la.chunked_linear_attention(qt, kt, vt, wt, **kw_t)
    assert yt.dtype == ft.dtype == torch.float32
    close(yt, yj, what="y")
    close(ft, fj, what="final state")


def test_chunked_linear_attention_keeps_the_chunk_assert():
    z = torch.zeros(1, 12, 1, 2)
    with pytest.raises(AssertionError):
        la.chunked_linear_attention(z, z, z, z, chunk=8)


def test_chunked_linear_attention_records_logp_when_asked():
    """LOGP_MAX collects each chunk's largest |logp| (the chunk's summed
    log decay, since log_w <= 0), as device scalars."""
    lw = -torch.ones(1, 16, 1, 2)
    z = torch.zeros(1, 16, 1, 2)
    la.LOGP_MAX = []
    try:
        la.chunked_linear_attention(z, z, z, lw, chunk=8)
        assert [float(m) for m in la.LOGP_MAX] == [8.0, 8.0]
    finally:
        la.LOGP_MAX = None
    la.chunked_linear_attention(z, z, z, lw, chunk=8)
    assert la.LOGP_MAX is None


@pytest.mark.parametrize("strict", [True, False])
def test_linear_attention_step_equals_reference(strict):
    rng = np.random.default_rng(7)
    b, h, dk, dv = 3, 2, 8, 4
    qj, qt = both(rng.normal(size=(b, h, dk)))
    kj, kt = both(rng.normal(size=(b, h, dk)))
    vj, vt = both(rng.normal(size=(b, h, dv)))
    wj, wt = both(-np.exp(rng.normal(size=(b, h, dk))))
    sj, st = both(rng.normal(size=(b, h, dk, dv)))
    uj, ut = both(rng.normal(size=(h, dk)))
    yj, nj = ref_la.linear_attention_step(qj, kj, vj, wj, sj,
                                          u=uj if strict else None)
    yt, nt = la.linear_attention_step(qt, kt, vt, wt, st,
                                      u=ut if strict else None)
    close(yt, yj, what="y")
    close(nt, nj, what="state")


@pytest.mark.parametrize("strict,chunk", [(True, 8), (False, 6)])
def test_chunked_equals_a_loop_of_steps(strict, chunk):
    """The reference's test_rwkv / test_mamba_chunked_vs_step_equivalence
    on the port: the chunked form against the recurrence one token at a
    time, from a non-zero state, within the reference's 1e-4."""
    rng = np.random.default_rng(0 if strict else 1)
    b, t, h, dk, dv = 2, 24, 3, 8, 8
    q = torch.as_tensor(rng.normal(size=(b, t, h, dk)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(b, t, h, dk)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(b, t, h, dv)), dtype=torch.float32)
    lw = torch.as_tensor(-np.abs(rng.normal(size=(b, t, h, dk))) * 0.1,
                         dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(h, dk)), dtype=torch.float32) \
        if strict else None
    s0 = torch.as_tensor(rng.normal(size=(b, h, dk, dv)) * 0.1,
                         dtype=torch.float32)
    y_par, s_par = la.chunked_linear_attention(q, k, v, lw, u=u, s0=s0,
                                               chunk=chunk)
    s, ys = s0, []
    for i in range(t):
        y, s = la.linear_attention_step(q[:, i], k[:, i], v[:, i], lw[:, i],
                                        s, u=u)
        ys.append(y)
    torch.testing.assert_close(y_par, torch.stack(ys, 1), rtol=0, atol=1e-4)
    torch.testing.assert_close(s_par, s, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

MAMBA = la.Mamba2Dims(d_model=16, d_inner=32, num_heads=4, d_state=8)


def _ref_mamba_dims():
    return ref_la.Mamba2Dims(**{k: getattr(MAMBA, k) for k in (
        "d_model", "d_inner", "num_heads", "d_state", "conv_width")})


def test_mamba2_block_and_decode_equal_reference():
    """mamba2_block over 32 tokens (two chunks of 16) on bf16 params and
    input, then mamba2_decode steps from a non-zero f32 state: the decode
    runs its convolution and what follows in f32 (the f32 conv state
    promotes the new column), the block in bf16."""
    assert la.mamba2_params_shape(MAMBA) == ref_la.mamba2_params_shape(
        _ref_mamba_dims())
    rng = np.random.default_rng(3)
    pj, pt = params(la.mamba2_params_shape(MAMBA), rng)
    xj, xt = both(rng.normal(size=(2, 32, 16)), "bfloat16")
    got = la.mamba2_block(pt, xt, MAMBA, chunk=16)
    assert got.dtype == torch.bfloat16
    close(got, ref_la.mamba2_block(pj, xj, _ref_mamba_dims(), chunk=16),
          rtol=BF16_ULP, what="mamba2_block")

    hs, hd, c = MAMBA.num_heads, MAMBA.head_dim, MAMBA.d_inner + 16
    sj, st = both(rng.normal(size=(2, hs, 8, hd)) * 0.3)
    cj, ct = both(rng.normal(size=(2, 3, c)) * 0.3)
    state_j, state_t = {"ssm": sj, "conv": cj}, {"ssm": st, "conv": ct}
    for i in range(3):
        oj, state_j = ref_la.mamba2_decode(pj, xj[:, i:i + 1], state_j,
                                           _ref_mamba_dims())
        ot, state_t = la.mamba2_decode(pt, xt[:, i:i + 1], state_t, MAMBA)
        assert ot.dtype == torch.bfloat16 and ot.shape == (2, 1, 16)
        close(ot, oj, rtol=BF16_ULP, what=f"decode out {i}")
        for name in ("ssm", "conv"):
            assert state_t[name].dtype == torch.float32
            close(state_t[name], state_j[name], what=f"{name} {i}")


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

RWKV = la.RWKV6Dims(d_model=32, num_heads=4, d_ff=48, decay_rank=8)


def _ref_rwkv_dims():
    return ref_la.RWKV6Dims(d_model=32, num_heads=4, d_ff=48, decay_rank=8)


def test_rwkv6_time_and_channel_mix_equal_reference():
    assert la.rwkv6_params_shape(RWKV) == ref_la.rwkv6_params_shape(
        _ref_rwkv_dims())
    rng = np.random.default_rng(4)
    pj, pt = params(la.rwkv6_params_shape(RWKV), rng)
    xj, xt = both(rng.normal(size=(2, 24, 32)), "bfloat16")
    np.testing.assert_array_equal(as_np(la._token_shift(xt)),
                                  as_np(ref_la._token_shift(xj)))
    got = la.rwkv6_time_mix(pt, xt, RWKV, chunk=8)
    assert got.dtype == torch.bfloat16
    close(got, ref_la.rwkv6_time_mix(pj, xj, _ref_rwkv_dims(), chunk=8),
          rtol=BF16_ULP, what="time_mix")
    got = la.rwkv6_channel_mix(pt, xt)
    assert got.dtype == torch.bfloat16
    close(got, ref_la.rwkv6_channel_mix(pj, xj), rtol=BF16_ULP,
          what="channel_mix")
    close(la._ddecay(pt, xt), ref_la._ddecay(pj, xj), rtol=BF16_ULP,
          what="ddecay")


@pytest.mark.parametrize("shift", ["float32", "bfloat16"])
def test_rwkv6_steps_equal_reference(shift):
    """The decode steps from an f32 shift state (make_cache's zeros: the
    mixes, and so every product, run in f32) and from a bf16 one (every
    later step: they run in bf16). The new shift is the bf16 input."""
    rng = np.random.default_rng(5)
    pj, pt = params(la.rwkv6_params_shape(RWKV), rng)
    xj, xt = both(rng.normal(size=(3, 32)), "bfloat16")
    hj, ht = both(rng.normal(size=(3, 32)), shift)
    sj, st = both(rng.normal(size=(3, 4, 8, 8)) * 0.3)
    oj, nj = ref_la.rwkv6_time_mix_step(pj, xj, {"shift": hj, "wkv": sj},
                                        _ref_rwkv_dims())
    ot, nt = la.rwkv6_time_mix_step(pt, xt, {"shift": ht, "wkv": st}, RWKV)
    assert ot.dtype == torch.bfloat16 and nt["shift"].dtype == torch.bfloat16
    close(ot, oj, rtol=BF16_ULP, what="time_mix_step")
    close(nt["wkv"], nj["wkv"], what="wkv")
    assert nt["shift"] is xt
    oj, _ = ref_la.rwkv6_channel_mix_step(pj, xj, {"shift": hj})
    ot, nt = la.rwkv6_channel_mix_step(pt, xt, {"shift": ht})
    assert ot.dtype == torch.bfloat16 and nt["shift"] is xt
    close(ot, oj, rtol=BF16_ULP, what="channel_mix_step")
