"""The port's training gradients against the JAX reference, on the CPU at
the reference's small shapes: ``flash_attention``'s backward (a
``torch.autograd.Function``), the losses (``cross_entropy``,
``chunked_ce_loss``, ``loss_fn``) and the gradients of all six LM
families, ``remat``, and the serving path left as it was.

Tolerances. ``flash_attention`` in f32 is within 1e-5 of the reference's
``jax.grad`` (measured 1.2e-6) and 1e-4 of a naive softmax attention;
in bf16 it is bit-equal to the reference's. A family's gradients run
through bf16 blocks, so they are compared leaf by leaf relative to the
leaf's largest value, beside a control measured in the same test: the
gap between the reference's own gradients run op by op
(``jax.disable_jit``) and jitted (XLA keeps some bf16 sums in f32). The
port's gap to either is held within CONTROL_FACTOR x that control
(measured: 0.84-1.37x of it; the controls 0.0098-0.064) and under
GRAD_REL_CAP; the loss likewise against the same control of the loss
(measured: equal to the eager loss within 1e-6 but for zamba2, 4.3e-5
off with a control of 3.8e-4), or within LOSS_ATOL.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import layers, linear_attn, model_zoo  # noqa: E402
from tests.conftest import small_config  # noqa: E402

FAMILY_ARCHS = ("smollm-360m", "internvl2-26b", "qwen3-moe-30b-a3b",
                "rwkv6-3b", "zamba2-1.2b", "whisper-base")
CONTROL_FACTOR = 2.0
GRAD_REL_CAP = 0.08
LOSS_ATOL = 1e-5


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def carried(arch: str):
    """(reference cfg, port cfg, reference params, port params) of the
    small config of ``arch``; the port's are the reference's, carried."""
    rcfg = small_config(ref_configs.get_config(arch))
    cfg = configs.ArchConfig(**dataclasses.asdict(rcfg))
    rp = ref_zoo.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, rp, convert.lm_params(jax.tree.map(np.asarray, rp),
                                            cfg, "cpu")


def batches(cfg, b=2, s=16, seed=0):
    """The same seeded training batch for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ref = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    port = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    if cfg.family in ("vlm", "audio"):
        key = "patches" if cfg.family == "vlm" else "frames"
        a = jnp.asarray(rng.normal(size=(b, cfg.frontend_len,
                                         cfg.frontend_dim)),
                        jnp.float32).astype(jnp.bfloat16)
        ref[key], port[key] = a, torch.as_tensor(as_np(a)).bfloat16()
    return ref, port


def port_grads(cfg, params, batch, **kw):
    """(loss, metrics, {path: grad}) of the port's loss_fn."""
    live = {path: p.detach().clone().requires_grad_(True)
            for path, p in model_zoo.leaves(params)}
    tree: dict = {}
    for path, p in live.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = p
    loss, metrics = model_zoo.loss_fn(cfg, tree, batch, **kw)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), metrics, dict(zip(live, grads))


def ref_leaves(tree):
    return {tuple(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel_err(a, b) -> float:
    a, b = as_np(a), as_np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _naive(q, k, v, causal=True):
    d = q.shape[-1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal:
        s = q.shape[1]
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                            -float("inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)


@pytest.mark.parametrize("causal,chunk,skv", [(True, 16, 40), (False, 16, 40),
                                              (True, 64, 40), (False, 7, 33)])
def test_flash_attention_grads_match_reference_and_naive(causal, chunk, skv):
    """tests/test_models.py:143's shapes (B 2, S 40, H 2, Dh 8; KV chunks of
    16, the last padded), causal or not, a chunk longer than the sequence
    and a ragged one: the port's gradients within 1e-5 of the
    reference's ``jax.grad`` and 1e-4 of a naive attention's."""
    rng = np.random.default_rng(0)
    b, sq, h, d = 2, 40 if causal else 24, 2, 8
    if causal:
        skv = sq
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, skv, h, d)).astype(np.float32)
            for _ in range(2))
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(ref_layers.flash_attention(
        *a, causal, 0, chunk))), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    torch.sin(layers.flash_attention(tq, tk, tv, causal, 0, chunk)
              ).sum().backward()
    nq, nk, nv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    torch.sin(_naive(nq, nk, nv, causal)).sum().backward()
    for name, got, ref, naive in zip("qkv", (tq.grad, tk.grad, tv.grad),
                                     want, (nq.grad, nk.grad, nv.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_flash_attention_bf16_grads_equal_reference_and_forward_unchanged():
    """In bf16 (the model's dtype) the port's backward is the reference's
    step for step: dq, dk, dv bit-equal; the Function's forward value is
    the forward core's, bit for bit."""
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(rng.normal(size=(2, 40, 2, 8)), jnp.float32
                           ).astype(jnp.bfloat16) for _ in range(3))
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(ref_layers.flash_attention(
        *a, True, 0, 16).astype(jnp.float32))), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(as_np(a)).bfloat16().requires_grad_(True)
                  for a in (q, k, v))
    out = layers.flash_attention(tq, tk, tv, True, 0, 16)
    torch.sin(out.float()).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(got), as_np(ref))
    core, _ = layers._flash_fwd_core(tq.detach(), tk.detach(), tv.detach(),
                                     True, 0, 16)
    assert torch.equal(out.detach(), core)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_direct_and_reference():
    """tests/test_models.py:168: chunks of 7 over S 24 (the last padded)
    against ``cross_entropy`` of the whole [B, S, V] (1e-4), and the
    value and both gradients against the reference's (1e-5 relative)."""
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 24, 16, 50
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    tx, tt = (torch.tensor(a, requires_grad=True) for a in (x, table))
    tl = torch.as_tensor(labels)
    chunked = model_zoo.chunked_ce_loss(tx, tt, tl, chunk=7)
    direct = layers.cross_entropy(torch.einsum("bsd,vd->bsv", tx.detach(),
                                               tt.detach()), tl)
    assert abs(float(chunked) - float(direct)) < 1e-4
    ref_direct = ref_layers.cross_entropy(
        jnp.einsum("bsd,vd->bsv", jnp.asarray(x), jnp.asarray(table)),
        jnp.asarray(labels))
    assert abs(float(direct) - float(ref_direct)) < 1e-5
    val, (gx, gt) = jax.value_and_grad(
        lambda a, t: ref_zoo.chunked_ce_loss(a, t, jnp.asarray(labels),
                                             chunk=7), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    assert abs(float(chunked) - float(val)) < 1e-5
    chunked.backward()
    assert rel_err(tx.grad, gx) < 1e-5 and rel_err(tt.grad, gt) < 1e-5


def test_chunked_ce_weights_and_bf16_match_reference():
    """Loss weights (a VLM's patch positions weigh 0) and bf16 hidden
    states against an f32 table cast once to bf16: the value within 1e-5
    of the reference's, its gradients within a bf16 ulp of theirs."""
    rng = np.random.default_rng(2)
    b, s, d, v = 2, 20, 32, 64
    xj = jnp.asarray(rng.normal(size=(b, s, d)), jnp.float32).astype(
        jnp.bfloat16)
    table = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    w = (rng.random((b, s)) > 0.3).astype(np.float32)
    val, (gx, gt) = jax.value_and_grad(
        lambda a, t: ref_zoo.chunked_ce_loss(a, t, jnp.asarray(labels),
                                             jnp.asarray(w), chunk=8),
        argnums=(0, 1))(xj, jnp.asarray(table))
    tx = torch.tensor(as_np(xj)).bfloat16().requires_grad_(True)
    tt = torch.tensor(table, requires_grad=True)
    got = model_zoo.chunked_ce_loss(tx, tt, torch.as_tensor(labels),
                                    torch.as_tensor(w), chunk=8)
    assert abs(float(got) - float(val)) < 1e-5
    got.backward()
    assert tx.grad.dtype == torch.bfloat16 and tt.grad.dtype == torch.float32
    assert rel_err(tx.grad, gx) <= 2.0 ** -7
    assert rel_err(tt.grad, gt) <= 2.0 ** -7


# ---------------------------------------------------------------------------
# loss_fn and the gradients of each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_loss_and_grads_match_reference(arch):
    rcfg, cfg, rp, pp = carried(arch)
    rb, pb = batches(cfg)

    def lf(p):
        return ref_zoo.loss_fn(rcfg, p, rb, chunk=8)
    (lj, mj), gj = jax.jit(jax.value_and_grad(lf, has_aux=True))(rp)
    with jax.disable_jit():
        (le, _), ge = jax.value_and_grad(lf, has_aux=True)(rp)
    lt, mt, gt = port_grads(cfg, pp, pb, chunk=8)

    loss_bound = max(CONTROL_FACTOR * abs(float(le) - float(lj)), LOSS_ATOL)
    assert abs(float(lt) - float(le)) <= loss_bound, (lt, le, lj)
    assert abs(float(lt) - float(lj)) <= loss_bound, (lt, le, lj)
    assert set(mt) == set(mj)
    for k in mj:
        if k != "ce_loss":
            assert abs(float(mt[k]) - float(mj[k])) <= 1e-5, k
    gj, ge = ref_leaves(gj), ref_leaves(ge)
    assert set(gt) == set(gj)
    port_jit = {k: rel_err(gt[k], gj[k]) for k in gj}
    port_eager = {k: rel_err(gt[k], ge[k]) for k in gj}
    control = {k: rel_err(ge[k], gj[k]) for k in gj}
    worst = {"port_vs_jit": max(port_jit.values()),
             "port_vs_eager": max(port_eager.values()),
             "control_eager_vs_jit": max(control.values())}
    print(f"{arch}: loss {float(lt):.7f} (jit {float(lj):.7f}, eager "
          f"{float(le):.7f}); {worst}")
    bound = min(CONTROL_FACTOR * worst["control_eager_vs_jit"], GRAD_REL_CAP)
    assert worst["port_vs_jit"] <= bound, (worst, port_jit)
    assert worst["port_vs_eager"] <= bound, (worst, port_eager)
    for k, g in gt.items():
        assert g.dtype == pp_dtype(pp, k) and torch.isfinite(g).all(), k


def pp_dtype(params, path):
    node = params
    for k in path:
        node = node[k]
    return node.dtype


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_on_and_off_equal_bit_for_bit(arch):
    """``remat`` recomputes each layer's (a zamba group's) activations in
    the backward pass: the hidden states, the loss and every gradient are
    the same bits with it on and off."""
    _, cfg, _, pp = carried(arch)
    _, pb = batches(cfg, seed=3)
    on = model_zoo.forward(cfg, pp, pb, remat=True, chunk=8)[0]
    off = model_zoo.forward(cfg, pp, pb, remat=False, chunk=8)[0]
    assert torch.equal(on, off)
    l_on, _, g_on = port_grads(cfg, pp, pb, remat=True, chunk=8)
    l_off, _, g_off = port_grads(cfg, pp, pb, remat=False, chunk=8)
    assert torch.equal(l_on, l_off)
    for k in g_on:
        assert torch.equal(g_on[k], g_off[k]), k


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-1.2b",
                                  "whisper-base"])
def test_prefill_logits_unchanged(arch, monkeypatch):
    """The serving path is untouched: ``prefill`` through the
    Function equals, bit for bit, ``prefill`` with ``flash_attention``
    replaced by the bare forward core (the path before the backward
    existed)."""
    _, cfg, _, pp = carried(arch)
    _, pb = batches(cfg, seed=4)
    with torch.no_grad():
        via_function = model_zoo.prefill(cfg, pp, pb, chunk=8)
    monkeypatch.setattr(layers, "flash_attention",
                        lambda q, k, v, c, o, ch: layers._flash_fwd_core(
                            q, k, v, c, o, ch)[0])
    with torch.no_grad():
        bare = model_zoo.prefill(cfg, pp, pb, chunk=8)
    assert torch.equal(via_function, bare)


def test_logp_hook_records_each_chunk_once_under_remat():
    """``linear_attn.LOGP_MAX`` gets one detached scalar per chunk of a
    real forward; the backward's recompute (remat) adds none."""
    _, cfg, _, pp = carried("rwkv6-3b")
    _, pb = batches(cfg, s=128, seed=5)
    counts = {}
    for remat in (False, True):
        linear_attn.LOGP_MAX = []
        try:
            port_grads(cfg, pp, pb, remat=remat)
            counts[remat] = list(linear_attn.LOGP_MAX)
        finally:
            linear_attn.LOGP_MAX = None
    assert len(counts[True]) == len(counts[False]) == cfg.num_layers * 2
    assert all(not t.requires_grad for t in counts[True])
    assert [float(t) for t in counts[True]] == \
        [float(t) for t in counts[False]]


def test_ssm_chunk_logp_and_gradients_finite():
    """rwkv6 at the small config's shapes over 4 chunks of 64: the
    largest |logp| (exp(-logp) scales a chunk's keys; f32 overflows past
    88.7) and the largest gradient of each chunk's inputs, printed (-s);
    every value finite."""
    rng = np.random.default_rng(6)
    b, t, h, dk = 2, 256, 4, 16
    q, k, v = (torch.tensor(rng.normal(size=(b, t, h, dk)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    lw = torch.tensor(-np.exp(rng.normal(size=(b, t, h, dk)) * 0.5 - 0.5),
                      dtype=torch.float32, requires_grad=True)
    u = torch.full((h, dk), 0.5)
    linear_attn.LOGP_MAX = []
    try:
        y, s = linear_attn.chunked_linear_attention(q, k, v, lw, u=u,
                                                    chunk=64)
        logp = [float(x) for x in linear_attn.LOGP_MAX]
    finally:
        linear_attn.LOGP_MAX = None
    (y.square().sum() + s.square().sum()).backward()
    per_chunk = []
    for j in range(t // 64):
        rows = slice(j * 64, (j + 1) * 64)
        per_chunk.append(max(float(a.grad[:, rows].abs().max())
                             for a in (q, k, v, lw)))
    print(f"rwkv6 chunks: largest |logp| {logp}; largest gradient "
          f"{per_chunk}")
    assert len(logp) == 4 and max(logp) < 88.7
    assert all(np.isfinite(per_chunk))
