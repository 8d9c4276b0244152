"""The port's MoE FFN and the MoE family (qwen3-moe, kimi with its bf16
parameters) against the JAX reference, on the CPU at small widths.

``moe_ffn`` gets the same inputs on both sides: in forward mode (bf16
experts, bf16 tokens) and in decode mode (f32 experts, bf16 tokens, so
the expert products run in f32, as the reference's decode leaves them).
The routing, the capacity drops and the dispatch are then equal; the
output agrees to one bf16 ulp, the aux loss to 1e-6. Capacity drops are
forced (every token prefers one expert) and gates are tied (a zero
router: ``lax.top_k`` takes the lower expert first, as the port's stable
sort does).

Through ``forward`` / ``prefill`` / ``decode_step`` the dense family's
tolerances hold (``tests/test_torch_models.py``), with one allowance: a
token whose k-th and (k+1)-th gates lie within float rounding may take
another expert in one package (the reference's compiled scan rounds
otherwise; seed 1 of qwen3-moe at this size does, 0.156 off in that
token's hidden state). So at most two token rows of a batch may exceed
the hidden-state tolerance, and the logits agree to 0.05 (0.0314 where a
decode step routed so, 0.0043 otherwise).
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
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import model_zoo, moe  # noqa: E402
from tests.conftest import small_config  # noqa: E402

BF16_ULP = 2.0 ** -7
HIDDEN_ATOL = 2.0 ** -4
MOE_LOGIT_ATOL = 0.05
FLIPPED_ROWS = 2


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def both(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, torch.as_tensor(as_np(j)).to(getattr(torch, dtype))


def moe_inputs(seed, d=32, f=24, e=8, b=3, s=10, expert_dtype="bfloat16",
               router=None, x_mean=0.0):
    rng = np.random.default_rng(seed)
    shapes = moe.moe_params_shape(d, f, e)
    pj, pt = {}, {}
    for name, shape in shapes.items():
        w = rng.normal(size=shape) * 0.2
        if name == "router" and router is not None:
            w = router(w)
        pj[name], pt[name] = both(w, expert_dtype)
    xj, xt = both(rng.normal(size=(b, s, d)) + x_mean, "bfloat16")
    return pj, pt, xj, xt


def compare_moe(pj, pt, xj, xt, k):
    want, mj = ref_moe.moe_ffn(pj, xj, experts_per_token=k)
    got, mt = moe.moe_ffn(pt, xt, experts_per_token=k)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=BF16_ULP,
                               atol=1e-6)
    assert float(mt["moe_drop_frac"]) == float(mj["moe_drop_frac"])
    np.testing.assert_allclose(float(mt["moe_aux_loss"]),
                               float(mj["moe_aux_loss"]), rtol=1e-6)
    return float(mt["moe_drop_frac"])


def test_moe_shapes_and_capacity_equal_reference():
    assert moe.moe_params_shape(48, 40, 6) == ref_moe.moe_params_shape(
        48, 40, 6)
    for tokens in (1, 4, 16, 100, 2048, 4096):
        for e, k in ((4, 2), (128, 8), (384, 8)):
            for cf in (1.0, 1.25, 2.0):
                assert moe.capacity(tokens, e, k, cf) == ref_moe.capacity(
                    tokens, e, k, cf)


@pytest.mark.parametrize("expert_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_ffn_equals_reference(seed, expert_dtype):
    """Forward mode (bf16 experts) and decode mode (f32 experts)."""
    pj, pt, xj, xt = moe_inputs(seed, expert_dtype=expert_dtype)
    compare_moe(pj, pt, xj, xt, k=2)


def test_moe_ffn_forced_capacity_drops_equal_reference():
    """Every token prefers expert 0 (tokens of mean 1 against a router
    column of mean 1): its slots fill at the capacity and the overflow is
    dropped, the same pairs on both sides."""
    def to_expert_0(w):
        w = w.copy()
        w[:, 0] += 1.0
        return w
    pj, pt, xj, xt = moe_inputs(2, b=4, s=16, router=to_expert_0,
                                x_mean=1.0)
    drop = compare_moe(pj, pt, xj, xt, k=2)
    # 64 tokens x 2 choices, capacity 24 per expert: expert 0 drops 40
    assert moe.capacity(64, 8, 2, 1.25) == 24
    assert drop > 0.25


def test_moe_ffn_tied_gates_take_the_lower_expert():
    """A zero router ties every gate: both pick experts 0 and 1 for every
    token (lax.top_k's order), so the capacity of each overflows."""
    pj, pt, xj, xt = moe_inputs(3, router=np.zeros_like)
    drop = compare_moe(pj, pt, xj, xt, k=2)
    cap = moe.capacity(30, 8, 2, 1.25)                # 16
    assert drop == pytest.approx(1 - 2 * cap / 60)    # experts 0 and 1


def carried_moe(arch, seed):
    rcfg = small_config(ref_configs.get_config(arch))
    cfg = configs.ArchConfig(**dataclasses.asdict(rcfg))
    rp = ref_zoo.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, convert.lm_params(jax.tree.map(np.asarray, rp),
                                            cfg, "cpu")


def rows_off(got, want, atol):
    """Token rows [.., d] of two hidden states that differ beyond atol."""
    return int((np.abs(as_np(got) - as_np(want)) > atol).any(-1).sum())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_moe_family_forward_prefill_decode_equal_reference(arch, seed):
    rcfg, cfg, rp, pp = carried_moe(arch, seed)
    assert pp["embed"].dtype == model_zoo.param_dtype(cfg)
    assert (pp["embed"].dtype == torch.bfloat16) == arch.startswith("kimi")
    b, s = 2, 16
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}

    xj, _, mj = ref_zoo.forward(rcfg, rp, rb, remat=False, chunk=8)
    xt, _, mt = model_zoo.forward(cfg, pp, pb, chunk=8)
    assert rows_off(xt, xj, HIDDEN_ATOL) <= FLIPPED_ROWS
    assert set(mt) == set(mj) == {"moe_drop_frac", "moe_aux_loss"}
    np.testing.assert_allclose(float(mt["moe_drop_frac"]),
                               float(mj["moe_drop_frac"]), atol=1 / (
                                   b * s * cfg.experts_per_token))
    np.testing.assert_allclose(float(mt["moe_aux_loss"]),
                               float(mj["moe_aux_loss"]), rtol=1e-2)
    np.testing.assert_allclose(
        as_np(model_zoo.prefill(cfg, pp, pb, chunk=8)),
        np.asarray(ref_zoo.prefill(rcfg, rp, rb, chunk=8)), rtol=0,
        atol=MOE_LOGIT_ATOL)

    cj = ref_zoo.make_cache(rcfg, b, 8)
    ct = model_zoo.make_cache(cfg, b, 8, device="cpu")
    for t in range(6):
        lj, cj = ref_zoo.decode_step(rcfg, rp, cj,
                                     jnp.asarray(toks[:, t:t + 1]),
                                     jnp.asarray(t, jnp.int32))
        lt, ct = model_zoo.decode_step(cfg, pp, ct,
                                       torch.as_tensor(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=MOE_LOGIT_ATOL, err_msg=f"step {t}")
