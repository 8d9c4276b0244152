"""The port's LM serving path (``repro_torch.configs``, ``repro_torch.
models``) against the JAX reference, on the CPU at small widths.

Both packages get the same seeded numpy inputs and the same weights: the
reference's ``init_params`` tree carried across with
``repro_torch.convert.lm_params``. Tolerances, as measured here:

- Eagerly, every layer function is EQUAL to the reference's, bit for bit
  (norms, RoPE, attention, the MLPs, a whole block at most 8 bf16 ulps
  from it), because the port rounds each bf16 step as the reference's
  jaxpr does. The tests allow one bf16 ulp (2^-7 relative) per function
  and state more where a function is composed.
- ``forward``, ``prefill`` and ``decode_step`` run the reference's
  ``lax.scan``, which XLA compiles: it keeps some bf16 intermediates in
  f32 (a block's residual sum feeds its norm unrounded), so the port's
  hidden states (|h| <= ~4) differ by up to two bf16 ulps there, 2^-5
  (atol 2^-4 below), and the logits by up to 0.0043 (atol 0.01).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import layers, model_zoo, transformer  # noqa: E402
from tests.conftest import small_config  # noqa: E402

DENSE = ("smollm-360m", "olmo-1b", "starcoder2-3b", "glm4-9b",
         "internvl2-26b")
BF16_ULP = 2.0 ** -7            # one bf16 ulp, relative
HIDDEN_ATOL = 2.0 ** -4          # compiled scan vs eager rounding, |h| <= 4
LOGIT_ATOL = 0.01


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(port, ref, rtol=BF16_ULP, atol=0.0, what=""):
    np.testing.assert_allclose(as_np(port), as_np(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, torch.as_tensor(as_np(j)).to(getattr(torch, dtype))


def port_config(ref_cfg) -> configs.ArchConfig:
    return configs.ArchConfig(**dataclasses.asdict(ref_cfg))


def carried(arch: str, seed: int = 0):
    """(reference cfg, port cfg, reference params, port params) of the
    small config of ``arch``; the port's are the reference's, carried."""
    rcfg = small_config(ref_configs.get_config(arch))
    cfg = port_config(rcfg)
    rp = ref_zoo.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, convert.lm_params(jax.tree.map(np.asarray, rp),
                                            cfg, "cpu")


def batches(cfg, b, s, seed=0):
    """The same seeded batch for both packages (tokens; a VLM's patches)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(
        toks)}
    if cfg.family == "vlm":
        ref["patches"], port["patches"] = both(rng.normal(
            size=(b, cfg.frontend_len, cfg.frontend_dim)), "bfloat16")
    return ref, port


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ALL_ARCHS)
def test_config_equals_reference_field_by_field(arch):
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.scaled(num_layers=3) == port_config(ref.scaled(num_layers=3))
    for name, cell in ref_configs.SHAPES.items():
        assert configs.runnable(port, configs.SHAPES[name]) == \
            ref_configs.runnable(ref, cell)


def test_registry_and_shapes_equal_reference():
    assert configs.ALL_ARCHS == ref_configs.ALL_ARCHS
    assert configs.list_configs() == ref_configs.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norms_equal_reference(dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.normal(size=(3, 5, 64)) * 3 + 1, dtype)
    sj, st = both(rng.normal(size=(64,)), dtype)
    tol = BF16_ULP if dtype == "bfloat16" else 1e-6
    close(layers.rmsnorm(xt, st), ref_layers.rmsnorm(xj, sj), rtol=tol)
    close(layers.nonparam_layernorm(xt), ref_layers.nonparam_layernorm(xj),
          rtol=tol, atol=1e-6)
    close(layers.apply_norm("nonparam_ln", xt, None),
          ref_layers.apply_norm("nonparam_ln", xj, None), rtol=tol, atol=1e-6)
    close(layers.apply_norm("rmsnorm", xt, {"scale": st}),
          ref_layers.apply_norm("rmsnorm", xj, {"scale": sj}), rtol=tol)
    assert layers.rmsnorm(xt, st).dtype == xt.dtype


@pytest.mark.parametrize("dtype,dh,theta,pos2d", [
    ("bfloat16", 16, 1e4, False), ("bfloat16", 64, 1e4, True),
    ("float32", 128, 1e6, True), ("float32", 16, 1e4, False)])
def test_rope_equals_reference(dtype, dh, theta, pos2d):
    """RoPE rotates the two halves of each head, in f32, from numpy's f64
    frequencies; 1-D positions broadcast over the batch."""
    rng = np.random.default_rng(dh)
    xj, xt = both(rng.normal(size=(2, 9, 3, dh)), dtype)
    pos = (rng.integers(0, 5000, (2, 9)) if pos2d else np.arange(9) + 17
           ).astype(np.int32)
    np.testing.assert_array_equal(layers.rope_frequencies(dh, theta),
                                  ref_layers.rope_frequencies(dh, theta))
    got = layers.apply_rope(xt, torch.as_tensor(pos), theta)
    close(got, ref_layers.apply_rope(xj, jnp.asarray(pos), theta),
          rtol=BF16_ULP if dtype == "bfloat16" else 1e-5, atol=1e-6)
    assert got.dtype == xt.dtype


def test_repeat_kv_puts_copies_of_a_head_side_by_side():
    k = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    for groups in (1, 2, 3):
        got = layers._repeat_kv(torch.as_tensor(k), groups).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref_layers._repeat_kv(jnp.asarray(k), groups)))
        # query head h reads kv head h // groups
        for h in range(4 * groups):
            np.testing.assert_array_equal(got[:, :, h], k[:, :, h // groups])


# (causal, sq, skv, chunk, q_offset, valid lengths or None)
ATTN_CASES = [
    (True, 16, 16, 8, 0, None),        # chunk divides S
    (True, 13, 13, 5, 0, None),        # S not a multiple of chunk: pad
    (False, 7, 11, 4, 0, None),        # non-causal, ragged last chunk
    (True, 4, 12, 512, 8, None),       # q_offset: the last 4 of 12
    (False, 1, 12, 2048, 0, (5, 12)),  # decode: kv_valid_len
    (False, 3, 10, 4, 0, (0, 7)),      # a fully masked row gives 0
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_chunked_attention_equals_reference(case, dtype):
    causal, sq, skv, chunk, off, valid = ATTN_CASES[case]
    rng = np.random.default_rng(case)
    qj, qt = both(rng.normal(size=(2, sq, 4, 16)), dtype)
    kj, kt = both(rng.normal(size=(2, skv, 4, 16)), dtype)
    vj, vt = both(rng.normal(size=(2, skv, 4, 16)), dtype)
    kw = dict(causal=causal, q_offset=off, chunk=chunk)
    want = ref_layers.chunked_attention(
        qj, kj, vj, kv_valid_len=None if valid is None else jnp.asarray(
            valid, jnp.int32), **kw)
    got = layers.chunked_attention(
        qt, kt, vt, kv_valid_len=None if valid is None else torch.tensor(
            valid, dtype=torch.int32), **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    close(got, want, rtol=BF16_ULP if dtype == "bfloat16" else 1e-5,
          atol=1e-6)
    if valid is None:   # the flash forward's lse, against the reference's
        _, lse_r = ref_layers._flash_fwd_core(qj, kj, vj, causal, off, chunk)
        _, lse_p = layers._flash_fwd_core(qt, kt, vt, causal, off, chunk)
        close(lse_p, lse_r, rtol=1e-5, atol=1e-5)
    elif 0 in valid:
        assert not got[list(valid).index(0)].any()


@pytest.mark.parametrize("h,kv,dh", [(4, 2, 16), (4, 4, 8), (6, 2, 16)])
def test_gqa_attention_and_decode_equal_reference(h, kv, dh):
    rng = np.random.default_rng(h * kv)
    d, b, s, s_max = 32, 2, 6, 8
    dims = layers.AttnDims(h, kv, dh)
    shapes = layers.attn_params_shape(d, dims)
    assert shapes == ref_layers.attn_params_shape(
        d, ref_layers.AttnDims(h, kv, dh))
    pj, pt = {}, {}
    for name, shape in shapes.items():
        pj[name], pt[name] = both(rng.normal(size=shape) * 0.2, "bfloat16")
    xj, xt = both(rng.normal(size=(b, s, d)), "bfloat16")
    close(layers.gqa_attention(pt, xt, dims, chunk=4),
          ref_layers.gqa_attention(pj, xj, ref_layers.AttnDims(h, kv, dh),
                                   chunk=4), what="gqa_attention")
    ck = np.zeros((b, s_max, kv, dh), np.float32)
    ckj, ckt = both(ck, "bfloat16")
    cvj, cvt = both(ck, "bfloat16")
    for pos in range(s):
        oj, ckj, cvj = ref_layers.gqa_decode(
            pj, xj[:, pos:pos + 1], ckj, cvj, jnp.asarray(pos, jnp.int32),
            ref_layers.AttnDims(h, kv, dh))
        ot, ckt2, cvt2 = layers.gqa_decode(pt, xt[:, pos:pos + 1], ckt, cvt,
                                           pos, dims)
        assert ckt2 is ckt and cvt2 is cvt          # written in place
        close(ot, oj, what=f"gqa_decode out at {pos}")
        close(ckt, ckj, what=f"cache k at {pos}")
        close(cvt, cvj, what=f"cache v at {pos}")
    with pytest.raises(ValueError):
        layers.gqa_decode(pt, xt[:, :1], ckt, cvt, s_max, dims)


def test_silu_and_gelu_bit_equal_over_every_bf16_value():
    """The bf16 SiLU and GELU step as the reference's jaxprs do: equal
    bit for bit over every finite bf16 value. XLA flushes subnormals, so
    torch does too for the comparison."""
    bits = np.arange(1 << 16, dtype=np.uint16).view(np.int16)
    x = torch.from_numpy(bits).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    assert torch.set_flush_denormal(True)
    try:
        pairs = ((layers.silu(x), jax.nn.silu(xj)),
                 (layers.gelu(x), jax.nn.gelu(xj)))
        for got, want in pairs:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(as_np(got), as_np(want))
    finally:
        torch.set_flush_denormal(False)
    # not torch's own: F.gelu's default erf form is another function
    g = layers.gelu(torch.tensor([1.0]))
    assert abs(float(g) - float(torch.nn.functional.gelu(
        torch.tensor([1.0])))) > 1e-4


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_equals_reference(kind):
    rng = np.random.default_rng(len(kind))
    shapes = layers.mlp_params_shape(32, 48, kind)
    assert shapes == ref_layers.mlp_params_shape(32, 48, kind)
    pj, pt = {}, {}
    for name, shape in shapes.items():
        pj[name], pt[name] = both(rng.normal(size=shape) * 0.3, "bfloat16")
    xj, xt = both(rng.normal(size=(2, 5, 32)), "bfloat16")
    close(layers.swiglu_mlp(pt, xt), ref_layers.swiglu_mlp(pj, xj))


def test_embed_and_logits_equal_reference():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    e = layers.embed(torch.as_tensor(toks), torch.as_tensor(table))
    np.testing.assert_array_equal(e.numpy(), np.asarray(
        ref_layers.embed(jnp.asarray(toks), jnp.asarray(table))))
    xj, xt = both(rng.normal(size=(2, 7, 16)), "bfloat16")
    got = layers.logits(xt, torch.as_tensor(table))
    assert got.dtype == torch.float32
    close(got, ref_layers.logits(xj, jnp.asarray(table)), rtol=1e-5,
          atol=1e-5)


# ---------------------------------------------------------------------------
# transformer, model_zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_attn_block_equals_reference(arch):
    """One block, eagerly on both sides: at most 8 bf16 ulps apart (the
    measured worst over three seeds and these configs), on the same
    cast parameters and input."""
    rcfg, cfg, rp, pp = carried(arch)
    xj, xt = both(np.random.default_rng(1).normal(size=(2, 11, 64)),
                  "bfloat16")
    for l in range(cfg.num_layers):
        want, _ = ref_transformer.attn_block(
            rcfg, jax.tree.map(lambda a: a[l], rp["blocks"]), xj, chunk=4)
        got, m = transformer.attn_block(cfg, transformer.layer(
            pp["blocks"], l), xt, chunk=4)
        close(got, want, rtol=8 * BF16_ULP, atol=1e-6, what=f"layer {l}")
        assert m == {}
    assert transformer.attn_dims(cfg) == layers.AttnDims(
        rcfg.num_heads, rcfg.num_kv_heads, rcfg.resolved_head_dim)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_equal_reference(arch):
    """smollm (tied), olmo (non-parametric LayerNorm), starcoder2 (GELU,
    untied), glm4, internvl2 (the connector and its loss weights)."""
    rcfg, cfg, rp, pp = carried(arch)
    rb, pb = batches(cfg, 2, 24)
    xj, wj, mj = ref_zoo.forward(rcfg, rp, rb, remat=False, chunk=8)
    xt, wt, mt = model_zoo.forward(cfg, pp, pb, chunk=8)
    assert xt.dtype == torch.bfloat16 and xt.shape == tuple(xj.shape)
    close(xt, xj, rtol=0, atol=HIDDEN_ATOL)
    assert mt == {} and mj == {}
    if cfg.family == "vlm":
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        assert float(wt[:, :cfg.frontend_len].sum()) == 0.0
    else:
        assert wt is None and wj is None
    got = model_zoo.prefill(cfg, pp, pb, chunk=8)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
    close(got, ref_zoo.prefill(rcfg, rp, rb, chunk=8), rtol=0,
          atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_equal_reference(arch):
    """A sequence of decode_steps from an empty cache: logits each step,
    and the bf16 cache, against the reference's."""
    rcfg, cfg, rp, pp = carried(arch)
    b, s, s_max = 2, 6, 8
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)
                                              ).astype(np.int32)
    cj = ref_zoo.make_cache(rcfg, b, s_max)
    ct = model_zoo.make_cache(cfg, b, s_max, device="cpu")
    for t in range(s):
        lj, cj = ref_zoo.decode_step(rcfg, rp, cj,
                                     jnp.asarray(toks[:, t:t + 1]),
                                     jnp.asarray(t, jnp.int32))
        lt, ct = model_zoo.decode_step(cfg, pp, ct,
                                       torch.as_tensor(toks[:, t:t + 1]), t)
        close(lt, lj, rtol=0, atol=LOGIT_ATOL, what=f"logits at {t}")
    for name in ("k", "v"):
        close(ct[name], cj[name], rtol=0, atol=HIDDEN_ATOL, what=name)
        assert not ct[name][:, :, s:].any()       # untouched past pos


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b",
                                  "internvl2-26b", "kimi-k2-1t-a32b"])
def test_make_cache_shapes_and_dtypes(arch):
    rcfg = small_config(ref_configs.get_config(arch))
    cfg = port_config(rcfg)
    want = ref_zoo.make_cache(rcfg, 3, 20)
    got = model_zoo.make_cache(cfg, 3, 20, device="cpu")
    assert set(got) == set(want) == {"k", "v"}
    for name in got:
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert got[name].dtype == torch.bfloat16
        assert want[name].dtype == jnp.bfloat16
        assert not got[name].any()


@pytest.mark.parametrize("arch", ref_configs.ALL_ARCHS)
def test_param_shapes_and_dtype_equal_reference(arch):
    """Every ported family's full-size tree has the reference's shapes
    (nothing is allocated); the others raise, naming the ROADMAP item."""
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    if port.family not in model_zoo.PORTED_FAMILIES:
        for fn in (lambda: model_zoo.param_shapes(port),
                   lambda: model_zoo.make_cache(port, 1, 4, device="cpu"),
                   lambda: model_zoo.forward(port, {}, {}),
                   lambda: model_zoo.decode_step(port, {}, {}, None, 0),
                   lambda: model_zoo.init_params(port, device="cpu")):
            with pytest.raises(NotImplementedError, match="4.2"):
                fn()
        return
    want = ref_zoo.param_shapes(ref)
    flat_want = {tuple(k.key for k in path): s for path, s in
                 jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert dict(model_zoo.leaves(model_zoo.param_shapes(port))) == flat_want
    assert str(model_zoo.param_dtype(port)).split(".")[-1] == \
        np.dtype(ref_zoo.param_dtype(ref)).name


def test_init_params_law_and_constants():
    """The port draws its own weights (the reference's fold_in stream
    cannot be reproduced): the same tree, dtypes and constant leaves, and
    normal * init_scale elsewhere, repeatable by seed."""
    for arch in ("olmo-1b", "smollm-360m", "kimi-k2-1t-a32b"):
        rcfg = small_config(ref_configs.get_config(arch))
        cfg = port_config(rcfg)
        p = model_zoo.init_params(cfg, seed=3, device="cpu")
        ref = jax.tree.map(np.asarray, ref_zoo.init_params(
            rcfg, jax.random.PRNGKey(3)))
        for (path, got), (_, want) in zip(model_zoo.leaves(p),
                                          model_zoo.leaves(ref)):
            assert tuple(got.shape) == want.shape, path
            assert got.dtype == model_zoo.param_dtype(cfg), path
            if path[-1] == "scale":
                assert bool((got == 1).all()) and (want == 1).all()
            else:
                assert abs(float(got.float().std()) - 0.02) < 0.004, path
        again = model_zoo.init_params(cfg, seed=3, device="cpu")
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            model_zoo.leaves(p), model_zoo.leaves(again)))
        assert sum(a.numel() for _, a in model_zoo.leaves(p)) == sum(
            a.size for _, a in model_zoo.leaves(ref))


def test_lm_params_checks_every_leaf():
    rcfg, cfg, rp, _ = carried("starcoder2-3b")
    tree = jax.tree.map(np.asarray, rp)
    missing = dict(tree)
    del missing["out_head"]
    with pytest.raises(KeyError, match="out_head"):
        convert.lm_params(missing, cfg, "cpu")
    with pytest.raises(KeyError, match="extra"):
        convert.lm_params(dict(tree, spare=np.zeros(3, np.float32)), cfg,
                          "cpu")
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params(dict(tree, embed=tree["embed"][:-1]), cfg, "cpu")
    with pytest.raises(TypeError):
        convert.lm_params(dict(tree, embed=tree["embed"].astype(np.float64)),
                          cfg, "cpu")
    # kimi's leaves are bf16 (ml_dtypes' dtype), carried by their bits
    kcfg = small_config(ref_configs.get_config("kimi-k2-1t-a32b"))
    kp = jax.tree.map(np.asarray, ref_zoo.init_params(kcfg,
                                                      jax.random.PRNGKey(0)))
    got = convert.lm_params(kp, port_config(kcfg), "cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  kp["embed"].astype(np.float32))
    with pytest.raises(TypeError, match="bfloat16"):   # kimi stores bf16
        convert.lm_params(jax.tree.map(lambda a: a.astype(np.float32), kp),
                          port_config(kcfg), "cpu")


def test_prefill_and_decode_agree_within_the_reference_bound():
    """The reference's own consistency check (tests/test_models.py), on
    the port alone: decode logits at position s-1 against a full
    forward's, atol 0.15, rtol 0.05, top-1 equal."""
    cfg = port_config(small_config(ref_configs.get_config("glm4-9b")))
    params = model_zoo.init_params(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)), dtype=torch.int32)
    full = model_zoo.prefill(cfg, params, {"tokens": toks})
    cache = model_zoo.make_cache(cfg, 2, 16, device="cpu")
    for t in range(12):
        logits, cache = model_zoo.decode_step(cfg, params, cache,
                                              toks[:, t:t + 1], t)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=0.15,
                               rtol=0.05)
    assert torch.equal(logits.argmax(-1), full.argmax(-1))
