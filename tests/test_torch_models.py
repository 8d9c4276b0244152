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
- The RWKV-6 (``ssm``), zamba2 (``hybrid``) and whisper (``audio``)
  families, at the same tolerances: their blocks (tests/test_torch_linear_
  attn.py for the mixers) are equal or a bf16 ulp or two apart eagerly;
  end to end the hidden states differ by up to 2^-5, the logits by up to
  0.0042, and the f32 decode states by up to 0.0082 of their largest
  term (STATE_REL below).
"""
import dataclasses
import functools

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
    """The same seeded batch for both packages (tokens; a VLM's patches,
    whisper's stub frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(
        toks)}
    if cfg.family in ("vlm", "audio"):
        key = "patches" if cfg.family == "vlm" else "frames"
        ref[key], port[key] = both(rng.normal(
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
    """Every family's full-size tree has the reference's shapes (nothing
    is allocated): the stacked blocks, zamba2's [G, g] groups, tail and
    shared block, whisper's encoder."""
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
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


# ---------------------------------------------------------------------------
# the ssm (rwkv6), hybrid (zamba2) and audio (whisper) families
# ---------------------------------------------------------------------------

# small_config's widths; zamba2's 5 layers at attn_every 2 make two groups
# and a tail of one, and its 4-layer variant has no tail.
FAMILIES = {"rwkv6-3b": {}, "zamba2-1.2b": {},
            "zamba2-1.2b/no-tail": {"num_layers": 4}, "whisper-base": {}}
FAMILY_ARCHS = ("rwkv6-3b", "zamba2-1.2b", "whisper-base")
# The f32 decode states against the reference's compiled decode_step,
# relative to their largest term: XLA keeps bf16 values in f32 where they
# feed an f32 state (the in_proj column entering the Mamba2 conv state,
# the normed input in the RWKV's first-step mixes), so the states differ
# by a few bf16 ulps (measured <= 0.0082 after five steps). Eagerly, a
# block's states agree to f32 rounding (measured <= 1.2e-7; 1e-6 below).
STATE_REL = 2.0 ** -6


@functools.lru_cache(maxsize=None)
def family(name: str):
    """carried() for a FAMILIES entry, made once per test process (the
    reference's init takes seconds); nothing here writes to the trees."""
    rcfg = small_config(ref_configs.get_config(name.split("/")[0]))
    if FAMILIES[name]:
        rcfg = rcfg.scaled(**FAMILIES[name])
    cfg = port_config(rcfg)
    rp = ref_zoo.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, rp, convert.lm_params(jax.tree.map(np.asarray, rp),
                                            cfg, "cpu")


@functools.lru_cache(maxsize=None)
def ref_decode(rcfg):
    """The reference's decode_step under jit (compiled once per cache
    tree: the RWKV cache's shifts change dtype after the first step)."""
    return jax.jit(functools.partial(ref_zoo.decode_step, rcfg))


def tree_close(port, ref, what="", rel=STATE_REL):
    """Two decode caches: the same tree, shapes and dtypes; bf16 leaves
    within HIDDEN_ATOL, f32 states within ``rel`` of their largest
    term."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), what
        for k in ref:
            tree_close(port[k], ref[k], f"{what}/{k}", rel)
        return
    assert tuple(port.shape) == tuple(ref.shape), what
    assert str(port.dtype).split(".")[-1] == np.dtype(ref.dtype).name, what
    if port.dtype == torch.bfloat16:
        close(port, ref, rtol=0, atol=HIDDEN_ATOL, what=what)
    else:
        scale = float(np.abs(as_np(ref)).max()) or 1.0
        close(port, ref, rtol=0, atol=rel * scale, what=what)


def cross_cache(cfg, params, enc):
    """whisper's cross cache filled from the encoder output, layer by
    layer: (enc @ bf16(cross.w{k,v}[l])).reshape(B, T, Hkv, Dh), in
    whichever package ``enc`` and ``params`` come from."""
    dims = transformer.attn_dims(cfg)
    cross = params["blocks"]["cross"]
    out = []
    for name in ("wk", "wv"):
        w = cross[name]
        if isinstance(enc, torch.Tensor):
            out.append(torch.stack([
                (enc @ w[l].to(torch.bfloat16)).reshape(
                    enc.shape[0], enc.shape[1], dims.num_kv_heads,
                    dims.head_dim) for l in range(cfg.num_layers)]))
        else:
            out.append(jnp.stack([
                (enc @ w[l].astype(jnp.bfloat16)).reshape(
                    enc.shape[0], enc.shape[1], dims.num_kv_heads,
                    dims.head_dim) for l in range(cfg.num_layers)]))
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_blocks_equal_reference(arch):
    """Each family's blocks eagerly on both sides, on the same cast
    parameters and input: rwkv_block and rwkv_block_decode (from f32 and
    from bf16 shifts), mamba_block and mamba_block_decode, whisper's
    attn_block(enc=) and attn_block_decode(enc_kv=); at most two bf16
    ulps apart (measured; rtol 4 ulps)."""
    rcfg, cfg, rp, pp = family(arch)
    rng = np.random.default_rng(11)
    xj, xt = both(rng.normal(size=(2, 16, 64)), "bfloat16")
    one_j, one_t = xj[:, :1], xt[:, :1]
    tol = dict(rtol=4 * BF16_ULP, atol=1e-6)
    if cfg.family == "ssm":
        rd = transformer.rwkv_dims(cfg)
        for l in range(cfg.num_layers):
            pj = jax.tree.map(lambda a: a[l], rp["blocks"])
            pt = transformer.layer(pp["blocks"], l)
            close(transformer.rwkv_block(cfg, pt, xt, chunk=8),
                  ref_transformer.rwkv_block(rcfg, pj, xj, chunk=8),
                  what=f"rwkv_block {l}", **tol)
            for shift in ("float32", "bfloat16"):
                sa = both(rng.normal(size=(2, 64)), shift)
                sf = both(rng.normal(size=(2, 64)), shift)
                wkv = both(rng.normal(size=(2, rd.num_heads, rd.head_dim,
                                            rd.head_dim)) * 0.2, "float32")
                hj, cj = ref_transformer.rwkv_block_decode(
                    rcfg, pj, one_j, {"att_shift": sa[0], "ffn_shift": sf[0],
                                      "wkv": wkv[0]})
                ht, ct = transformer.rwkv_block_decode(
                    cfg, pt, one_t, {"att_shift": sa[1], "ffn_shift": sf[1],
                                     "wkv": wkv[1]})
                close(ht, hj, what=f"rwkv_block_decode {l} {shift}", **tol)
                assert ct["att_shift"].dtype == torch.bfloat16
                tree_close(ct, cj, f"rwkv state {l} {shift}", 1e-6)
    elif cfg.family == "hybrid":
        md = transformer.mamba_dims(cfg)
        pj = jax.tree.map(lambda a: a[1][0], rp["groups"])
        pt = transformer.layer(transformer.layer(pp["groups"], 1), 0)
        close(transformer.mamba_block(cfg, pt, xt, chunk=8),
              ref_transformer.mamba_block(rcfg, pj, xj, chunk=8),
              what="mamba_block", **tol)
        ssm = both(rng.normal(size=(2, md.num_heads, md.d_state,
                                    md.head_dim)) * 0.2, "float32")
        conv = both(rng.normal(size=(2, md.conv_width - 1,
                                     md.d_inner + 2 * md.d_state)) * 0.2,
                    "float32")
        hj, cj = ref_transformer.mamba_block_decode(
            rcfg, pj, one_j, {"ssm": ssm[0], "conv": conv[0]})
        ht, ct = transformer.mamba_block_decode(
            cfg, pt, one_t, {"ssm": ssm[1], "conv": conv[1]})
        close(ht, hj, what="mamba_block_decode", **tol)
        tree_close(ct, cj, "mamba state", 1e-6)
    else:
        dims = transformer.attn_dims(cfg)
        ej, et = both(rng.normal(size=(2, 8, 64)), "bfloat16")
        kv = [both(rng.normal(size=(2, 8, dims.num_kv_heads,
                                    dims.head_dim)), "bfloat16")
              for _ in range(4)]
        for l in range(cfg.num_layers):
            pj = jax.tree.map(lambda a: a[l], rp["blocks"])
            pt = transformer.layer(pp["blocks"], l)
            hj, _ = ref_transformer.attn_block(rcfg, pj, xj, enc=ej, chunk=4)
            ht, _ = transformer.attn_block(cfg, pt, xt, enc=et, chunk=4)
            close(ht, hj, what=f"attn_block(enc=) {l}", **tol)
            hj, _ = ref_transformer.attn_block_decode(
                rcfg, pj, one_j, {"k": kv[0][0], "v": kv[1][0]},
                jnp.asarray(3, jnp.int32), enc_kv=(kv[2][0], kv[3][0]))
            ht, _ = transformer.attn_block_decode(
                cfg, pt, one_t, {"k": kv[0][1].clone(), "v": kv[1][1].clone()},
                3, enc_kv=(kv[2][1], kv[3][1]))
            close(ht, hj, what=f"attn_block_decode(enc_kv=) {l}", **tol)


def test_encode_audio_and_cross_attention_equal_reference():
    """cross_attention over a ragged encoder length (10 frames, KV chunk
    4: the last chunk padded and masked), and whisper's encoder (the
    frames' projection, sinusoidal positions, non-causal blocks, the
    final norm) on the small config's 8 frames."""
    rng = np.random.default_rng(12)
    dims = layers.AttnDims(4, 2, 16)
    shapes = layers.attn_params_shape(64, dims)
    pj, pt = {}, {}
    for name, shape in shapes.items():
        pj[name], pt[name] = both(rng.normal(size=shape) * 0.2, "bfloat16")
    xj, xt = both(rng.normal(size=(2, 5, 64)), "bfloat16")
    ej, et = both(rng.normal(size=(2, 10, 64)), "bfloat16")
    got = layers.cross_attention(pt, xt, et, dims, chunk=4)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, 64)
    close(got, ref_layers.cross_attention(
        pj, xj, ej, ref_layers.AttnDims(4, 2, 16), chunk=4),
        what="cross_attention")
    np.testing.assert_array_equal(model_zoo._sinusoidal(7, 64),
                                  ref_zoo._sinusoidal(7, 64))
    rcfg, cfg, rp, pp = family("whisper-base")
    rb, pb = batches(cfg, 2, 4)
    got = model_zoo.encode_audio(cfg, pp, pb["frames"])
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (2, cfg.frontend_len, cfg.d_model)
    close(got, ref_zoo.encode_audio(rcfg, rp, rb["frames"]), rtol=0,
          atol=HIDDEN_ATOL, what="encode_audio")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_and_prefill_equal_reference(name):
    """rwkv6 (the chunked recurrence over 16 tokens), zamba2 with and
    without a tail, whisper (the encoder on stub frames, cross-attention
    in every decoder block)."""
    rcfg, cfg, rp, pp = family(name)
    rb, pb = batches(cfg, 2, 16)
    xj, wj, mj = ref_zoo.forward(rcfg, rp, rb, remat=False, chunk=8)
    xt, wt, mt = model_zoo.forward(cfg, pp, pb, chunk=8)
    assert xt.dtype == torch.bfloat16 and xt.shape == tuple(xj.shape)
    close(xt, xj, rtol=0, atol=HIDDEN_ATOL, what="hidden")
    assert wt is None and wj is None and mt == {} and mj == {}
    got = model_zoo.prefill(cfg, pp, pb, chunk=8)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
    close(got, ref_zoo.prefill(rcfg, rp, rb, chunk=8), rtol=0,
          atol=LOGIT_ATOL, what="prefill logits")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_decode_steps_equal_reference(name):
    """make_cache's tree, shapes and dtypes; then five decode_steps from
    it: logits each step, and after the first step and the last the
    cache against the reference's. After one step the RWKV shifts are
    bf16, as the reference's are (its f32 zeros promoted the first step's
    mixes to f32; a bf16 state keeps the next in bf16)."""
    rcfg, cfg, rp, pp = family(name)
    b, steps, s_max = 2, 5, 8
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, steps)
                                              ).astype(np.int32)
    cj = ref_zoo.make_cache(rcfg, b, s_max)
    ct = model_zoo.make_cache(cfg, b, s_max, device="cpu")
    tree_close(ct, cj, "empty cache")
    assert not any(a.any() for _, a in model_zoo.leaves(ct))
    step = ref_decode(rcfg)
    for t in range(steps):
        lj, cj = step(rp, cj, jnp.asarray(toks[:, t:t + 1]),
                      jnp.asarray(t, jnp.int32))
        lt, ct = model_zoo.decode_step(cfg, pp, ct,
                                       torch.as_tensor(toks[:, t:t + 1]), t)
        close(lt, lj, rtol=0, atol=LOGIT_ATOL, what=f"logits at {t}")
        if t in (0, steps - 1):
            tree_close(ct, cj, f"cache after step {t}")
    if cfg.family == "ssm":
        assert {k: v.dtype for k, v in ct.items()} == {
            "att_shift": torch.bfloat16, "ffn_shift": torch.bfloat16,
            "wkv": torch.float32}


def test_whisper_decode_on_a_filled_cross_cache():
    """The cross cache filled from each package's own encoder output:
    decode_steps against the reference's on its filled cache, and the
    port's decode at position 0 against a 1-token prefill on the same
    frames (where the decode's position-0 encoding is the prefill's)."""
    rcfg, cfg, rp, pp = family("whisper-base")
    rb, pb = batches(cfg, 2, 4, seed=5)
    ckj, cvj = cross_cache(cfg, rp, ref_zoo.encode_audio(
        rcfg, rp, rb["frames"]))
    ckt, cvt = cross_cache(cfg, pp, model_zoo.encode_audio(
        cfg, pp, pb["frames"]))
    close(ckt, ckj, rtol=0, atol=HIDDEN_ATOL, what="ck")
    cj = dict(ref_zoo.make_cache(rcfg, 2, 6), ck=ckj, cv=cvj)
    ct = dict(model_zoo.make_cache(cfg, 2, 6, device="cpu"), ck=ckt, cv=cvt)
    step = ref_decode(rcfg)
    toks = np.asarray(rb["tokens"])
    for t in range(4):
        lj, cj = step(rp, cj, jnp.asarray(toks[:, t:t + 1]),
                      jnp.asarray(t, jnp.int32))
        lt, ct = model_zoo.decode_step(cfg, pp, ct,
                                       torch.as_tensor(toks[:, t:t + 1]), t)
        close(lt, lj, rtol=0, atol=LOGIT_ATOL, what=f"logits at {t}")
        if t == 0:
            one = model_zoo.prefill(cfg, pp, {"tokens": pb["tokens"][:, :1],
                                              "frames": pb["frames"]})
            close(lt, one, rtol=0, atol=LOGIT_ATOL, what="vs prefill")
            assert torch.equal(lt.argmax(-1), one.argmax(-1))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_family_prefill_and_decode_agree_within_the_reference_bound(arch):
    """The reference's consistency check on the port alone, for the
    recurrent families: decode logits at position s-1 against the
    prefill's, atol 0.15, rtol 0.05, top-1 equal."""
    cfg = port_config(small_config(ref_configs.get_config(arch)))
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


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_params_families_law_and_constants(arch):
    """The port's own init for the new trees: the reference's leaves and
    dtypes, its constants (a_log 0, dt_bias -2, d_skip 1, w0 0, bonus_u
    0.5, mu_* 0.5, every scale 1), normal * 0.02 elsewhere."""
    rcfg, cfg, rp, _ = family(arch)
    ref = dict(model_zoo.leaves(jax.tree.map(np.asarray, rp)))
    got = dict(model_zoo.leaves(model_zoo.init_params(cfg, seed=3,
                                                      device="cpu")))
    assert set(got) == set(ref)
    for path, a in got.items():
        want = ref[path]
        assert tuple(a.shape) == want.shape and a.dtype == torch.float32
        name = path[-1]
        if name in model_zoo._SPECIAL_INIT or name.startswith("mu_"):
            np.testing.assert_array_equal(a.numpy(), want, err_msg=str(path))
        elif a.numel() >= 256:
            assert abs(float(a.std()) - 0.02) < 0.004, path


def test_lm_params_over_groups_tail_and_encoder():
    """lm_params walks zamba2's [G, g] groups, its tail and shared block,
    and whisper's encoder: each carried leaf equal to the reference's; a
    tree without the tail its config needs, or with one it does not,
    raises."""
    for name in ("zamba2-1.2b", "whisper-base"):
        _, cfg, rp, pp = family(name)
        for path, a in model_zoo.leaves(jax.tree.map(np.asarray, rp)):
            node = pp
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), a)
    _, cfg, rp, _ = family("zamba2-1.2b")
    tree = jax.tree.map(np.asarray, rp)
    assert tree["groups"]["mamba"]["in_proj"].ndim == 4      # [G, g, ...]
    no_tail = {k: v for k, v in tree.items() if k != "tail"}
    with pytest.raises(KeyError, match="tail"):
        convert.lm_params(no_tail, cfg, "cpu")
    _, cfg4, _, _ = family("zamba2-1.2b/no-tail")
    assert "tail" not in model_zoo.param_shapes(cfg4)
    with pytest.raises(KeyError, match="tail"):
        convert.lm_params(tree, cfg4, "cpu")
    _, wcfg, wp, _ = family("whisper-base")
    wtree = jax.tree.map(np.asarray, wp)
    enc = dict(wtree["encoder"])
    del enc["in_proj"]
    with pytest.raises(KeyError, match="in_proj"):
        convert.lm_params(dict(wtree, encoder=enc), wcfg, "cpu")


def _decode_prefill_gaps(rcfg, b, s=64):
    """At ``rcfg``'s depth, each package's own decode against its own
    prefill at position s-1, on the same weights and tokens: (the
    reference's largest error, the port's, the reference's rows with
    top-1 equal, the port's)."""
    cfg = port_config(rcfg)
    rp = ref_zoo.init_params(rcfg, jax.random.PRNGKey(0))
    pp = convert.lm_params(jax.tree.map(np.asarray, rp), cfg, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)
                                              ).astype(np.int32)
    full_r = as_np(ref_zoo.prefill(rcfg, rp, {"tokens": jnp.asarray(toks)}))
    full_p = as_np(model_zoo.prefill(cfg, pp,
                                     {"tokens": torch.as_tensor(toks)}))
    step, cj = ref_decode(rcfg), ref_zoo.make_cache(rcfg, b, s)
    ct = model_zoo.make_cache(cfg, b, s, device="cpu")
    for t in range(s):
        lj, cj = step(rp, cj, jnp.asarray(toks[:, t:t + 1]),
                      jnp.asarray(t, jnp.int32))
        lt, ct = model_zoo.decode_step(cfg, pp, ct,
                                       torch.as_tensor(toks[:, t:t + 1]), t)
    lj, lt = as_np(lj), as_np(lt)
    gaps = (float(np.abs(lj - full_r).max()), float(np.abs(lt - full_p).max()),
            int((lj.argmax(-1) == full_r.argmax(-1)).sum()),
            int((lt.argmax(-1) == full_p.argmax(-1)).sum()))
    print(f"{rcfg.name} at {rcfg.num_layers} layers, d_model "
          f"{rcfg.d_model}, B {b}: decode vs prefill, reference "
          f"{gaps[0]:.4f} (top-1 {gaps[2]} / {b}), port {gaps[1]:.4f} "
          f"(top-1 {gaps[3]} / {b})")
    return gaps


# The port's decode-vs-prefill gap at full depth against the reference's
# own: within DEPTH_GAP_RATIO of it. Measured (d_model 256): rwkv6 at 32
# layers 0.132 against the reference's 0.180, zamba2 at 38 layers 0.0745
# against 0.0757.
DEPTH_GAP_RATIO = 1.25


def test_rwkv_decode_prefill_gap_at_depth_is_the_references():
    """rwkv6 at its 32 layers (d_model 256): the port's decode lies no
    further from its prefill than DEPTH_GAP_RATIO times the reference's
    own gap. At this depth the reference's own decode misses the
    reference's bound of its prefill (atol 0.15, rtol 0.05: measured
    0.180), which is why chip_smoke.py's phase 13 gates the recurrent
    families' decode below full depth and prints it at full depth."""
    rcfg = ref_configs.get_config("rwkv6-3b").scaled(
        d_model=256, num_heads=4, num_kv_heads=4, d_ff=896, vocab_size=4096,
        num_layers=32)
    ref_gap, port_gap, _, _ = _decode_prefill_gaps(rcfg, 2)
    assert port_gap <= DEPTH_GAP_RATIO * ref_gap


def test_zamba_decode_prefill_gap_at_depth_is_the_references():
    """zamba2 at its 38 Mamba2 blocks (6 groups of 6 around the shared
    attention block, a tail of 2; d_model 256, d_inner 512, 8 Mamba heads,
    d_state 64) on 8 rows: the port's decode lies no further from its
    prefill than DEPTH_GAP_RATIO times the reference's own gap. The
    decode runs its convolution and what follows up to ``out_proj`` in
    f32 where the prefill runs bf16, in both packages; at this depth the
    reference's own decode is within the numeric bound (measured 0.0757)
    but its top-1 token differs from its prefill's in 2 of the 8 rows,
    so the reference's check (top-1 equal) fails there too."""
    rcfg = ref_configs.get_config("zamba2-1.2b").scaled(
        d_model=256, num_heads=4, num_kv_heads=4, d_ff=1024, vocab_size=4096)
    assert (rcfg.num_layers, rcfg.attn_every, rcfg.ssm_state) == (38, 6, 64)
    ref_gap, port_gap, _, _ = _decode_prefill_gaps(rcfg, 8)
    assert port_gap <= DEPTH_GAP_RATIO * ref_gap
