"""The port's training loop on the CPU against the JAX reference: the
train step (``repro_torch.train.step``), the token stream
(``repro_torch.data.synthetic``), checkpoints (``repro_torch.ckpt``),
the loop and its restart contract (tests/test_train_loop.py's), the
launcher's ``reduced``, the example, and the optimizer state carried
across (``convert.opt_state``).

Train-step parity runs both packages for five steps from the same
parameters (``convert.lm_params``) on the same batches. The parameters
after a step are not compared elementwise (Adam's first steps move each
weight by about lr * sign(g), so a gradient near 0 can flip between two
float paths); the gradients are (tests/test_torch_grads.py), the
optimizers alone on identical inputs are (tests/test_torch_optim.py),
and here the loss, the gradient norm and the learning rate of every
step: measured within 1.8e-4 (loss), 1.3e-3 relative (norm) and one ulp
(lr), held to LOSS_ATOL, NORM_RTOL and LR_ULPS.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro import ckpt as ref_ckpt  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.launch import train as ref_launch  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import ckpt, configs, convert  # noqa: E402
from repro_torch.ckpt import msgpack_lite  # noqa: E402
from repro_torch.data.synthetic import (PipelineConfig,  # noqa: E402
                                        TokenPipeline, _zipf_logits)
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.train import (SimulatedFailure, make_train_step,  # noqa
                               optimizer_for, train)
from tests.conftest import small_config  # noqa: E402

CFG = configs.ArchConfig(**dataclasses.asdict(small_config(
    ref_configs.get_config("smollm-360m"))))
KW = dict(global_batch=4, seq_len=32, peak_lr=1e-3, log_every=1,
          device="cpu")
LOSS_ATOL = 1e-3
NORM_RTOL = 5e-3
LR_ULPS = 2


def carried(arch):
    rcfg = small_config(ref_configs.get_config(arch))
    cfg = configs.ArchConfig(**dataclasses.asdict(rcfg))
    rp = ref_zoo.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, rp, convert.lm_params(jax.tree.map(np.asarray, rp),
                                            cfg, "cpu")


def leaves_equal(a, b):
    la, lb = dict(model_zoo.leaves(a)), dict(model_zoo.leaves(b))
    assert set(la) == set(lb)
    return all(torch.equal(la[k], lb[k]) for k in la)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "olmo-1b"])
def test_train_step_reduces_loss(arch):
    """tests/test_models.py:51: a repeated batch, a short warmup: the loss
    falls by more than 0.5 in 8 steps."""
    _, cfg, _, params = carried(arch)
    init_opt, train_step = make_train_step(cfg, peak_lr=3e-3,
                                           warmup_steps=2, total_steps=50)
    opt_state = init_opt(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (4, 32)), dtype=torch.int32),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (4, 32)), dtype=torch.int32)}
    losses = []
    for _ in range(8):
        params, opt_state, m = train_step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


@pytest.mark.parametrize("arch,compress", [
    ("smollm-360m", False), ("smollm-360m", True),
    ("qwen3-moe-30b-a3b", False), ("kimi-k2-1t-a32b", True)])
def test_train_step_metrics_match_reference(arch, compress):
    """Five steps of both packages from the same parameters on the same
    batches (AdamW; Adafactor and bf16 parameters for kimi; the int8
    error-feedback roundtrip with ``compress``): the loss, gradient norm
    and learning rate of every step, the metrics' names, the state's
    tree and dtypes."""
    rcfg, cfg, rp, pp = carried(arch)
    ri, rs = ref_step.make_train_step(rcfg, peak_lr=3e-3, warmup_steps=2,
                                      total_steps=50, compress_grads=compress)
    pi, ps = make_train_step(cfg, peak_lr=3e-3, warmup_steps=2,
                             total_steps=50, compress_grads=compress)
    assert optimizer_for(cfg) == ref_step.optimizer_for(rcfg)
    rs = jax.jit(rs)
    ro, po = ri(rp), pi(pp)
    rng = np.random.default_rng(0)
    for i in range(5):
        toks, labels = (rng.integers(0, cfg.vocab_size, (4, 32)).astype(
            np.int32) for _ in range(2))
        rp, ro, rm = rs(rp, ro, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)})
        pp, po, pm = ps(pp, po, {"tokens": torch.as_tensor(toks),
                                 "labels": torch.as_tensor(labels)})
        assert set(pm) == set(rm)
        assert all(v.device.type == "cpu" and v.dim() == 0
                   for v in pm.values())
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= LOSS_ATOL, i
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=NORM_RTOL)
        a = np.float32(rm["lr"]).view(np.int32).astype(np.int64)
        b = np.float32(pm["lr"]).view(np.int32).astype(np.int64)
        assert abs(int(a - b)) <= LR_ULPS, (float(rm["lr"]), float(pm["lr"]))
    ref_state = jax.tree.map(np.asarray, ro)
    carried_state = convert.opt_state(ref_state, po)     # checks the tree
    assert int(carried_state["step"]) == int(po["step"]) == 5
    for path, leaf in model_zoo.leaves(po):
        assert leaf.dtype == carried_state_leaf(carried_state, path).dtype


def carried_state_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_opt_state_carries_reference_state_exactly():
    """``convert.opt_state`` takes the reference's AdamW state (m, v,
    step, ef) and Adafactor's (bf16 moments by their bits) leaf for leaf;
    a missing key or a wrong shape raises."""
    for arch, opt in (("olmo-1b", "adamw"), ("kimi-k2-1t-a32b",
                                             "adafactor")):
        rcfg, cfg, rp, pp = carried(arch)
        ri, _ = ref_step.make_train_step(rcfg, optimizer=opt,
                                         compress_grads=True)
        pi, _ = make_train_step(cfg, optimizer=opt, compress_grads=True)
        rng = np.random.default_rng(0)
        ro = jax.tree.map(lambda a: np.asarray(a) + np.asarray(
            rng.normal(size=a.shape), a.dtype) if a.ndim else np.asarray(a),
            ri(rp))
        got = convert.opt_state(ro, pi(pp))
        for (path, want), (path2, leaf) in zip(
                sorted(ref_state_leaves(ro).items()),
                sorted(model_zoo.leaves(got))):
            assert path == path2
            np.testing.assert_array_equal(
                leaf.float().numpy(), np.asarray(jnp.asarray(want).astype(
                    jnp.float32)))
        bad = dict(ro)
        del bad["step"]
        with pytest.raises(KeyError):
            convert.opt_state(bad, pi(pp))


def ref_state_leaves(tree):
    return {tuple(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------

def test_pipeline_restart_exact():
    """tests/test_train_loop.py::test_pipeline_restart_exact, and the
    stream's batch as a pure function of (seed, step, shard)."""
    cfg = PipelineConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)
    p1, p2 = TokenPipeline(cfg, "cpu"), TokenPipeline(cfg, "cpu")
    for s in range(3):
        p1.get_batch(s)
    b1, b2 = p1.get_batch(57), p2.get_batch(57)   # skip-ahead
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].dtype == torch.int32 and b1["tokens"].shape == (4, 16)
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert not torch.equal(p1.get_batch(58)["tokens"], b1["tokens"])
    other = TokenPipeline(dataclasses.replace(cfg, seed=4), "cpu")
    assert not torch.equal(other.get_batch(57)["tokens"], b1["tokens"])
    shards = [TokenPipeline(PipelineConfig(
        vocab_size=128, seq_len=16, global_batch=4, seed=3, num_shards=2,
        shard_id=i), "cpu").get_batch(5)["tokens"] for i in (0, 1)]
    assert shards[0].shape == (2, 16) and shards[1].shape == (2, 16)
    assert not torch.equal(shards[0], shards[1])
    ref = ref_synthetic.TokenPipeline(ref_synthetic.PipelineConfig(
        vocab_size=128, seq_len=16, global_batch=4, seed=3))
    assert p1.state_dict(9) == ref.state_dict(9)
    with pytest.raises(ValueError):
        TokenPipeline(PipelineConfig(vocab_size=8, seq_len=4,
                                     global_batch=3, num_shards=2), "cpu")


def test_stream_law_matches_reference():
    """The same law as the reference's stream: ``_zipf_logits`` equal bit
    for bit, and over ~260,000 tokens each, the frequency of each of the
    8 likeliest tokens and of the tail within 5 standard errors of
    softmax(_zipf_logits), for both packages' streams."""
    vocab = 512
    np.testing.assert_array_equal(_zipf_logits(vocab),
                                  ref_synthetic._zipf_logits(vocab))
    p = np.exp(_zipf_logits(vocab))
    p /= p.sum()
    cfg = dict(vocab_size=vocab, seq_len=255, global_batch=64, seed=0)
    port = TokenPipeline(PipelineConfig(**cfg), "cpu")
    ref = ref_synthetic.TokenPipeline(ref_synthetic.PipelineConfig(**cfg))
    draws = {"port": np.concatenate([port.sample(s).ravel()
                                     for s in range(16)]),
             "reference": np.concatenate([np.asarray(
                 ref.get_batch(s)["tokens"]).ravel() for s in range(16)])}
    for name, toks in draws.items():
        n = toks.size
        counts = np.bincount(toks, minlength=vocab)
        want = np.concatenate([p[:8], [p[8:].sum()]])
        got = np.concatenate([counts[:8], [counts[8:].sum()]]) / n
        se = np.sqrt(want * (1 - want) / n)
        assert (np.abs(got - want) <= 5 * se).all(), (name, got, want)
        assert toks.min() >= 0 and toks.max() < vocab


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

META_CASES = [
    {"step": 7, "keys": ["0/embed", "1/m/blocks/attn/wq"],
     "dtypes": ["float32", "bfloat16", "int32"], "shardings": {},
     "extra": {"next_step": 8, "pipeline": {"step": 8, "seed": 0,
                                            "num_shards": 1, "shard_id": 0}}},
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
     2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
     -2 ** 31 - 1, -2 ** 63],
    [0.0, -1.5, 1e-300, float("inf"), 3.141592653589793, True, False, None],
    ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "ünï"],
    {"list": list(range(15)), "list16": list(range(16)),
     "long": list(range(70000)),
     "map": {f"k{i}": i for i in range(15)},
     "map16": {f"k{i}": [i, {"x": None}] for i in range(16)}},
]


@pytest.mark.parametrize("case", range(len(META_CASES)))
def test_msgpack_codec_matches_msgpack(case):
    obj = META_CASES[case]
    data = msgpack_lite.packb(obj)
    assert data == msgpack.packb(obj)
    assert msgpack_lite.unpackb(data) == msgpack.unpackb(data) == obj
    single = msgpack.packb(obj, use_single_float=True)   # 32-bit floats
    assert msgpack_lite.unpackb(single) == msgpack.unpackb(single)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(data[:-1] if len(data) > 1 else b"\xdc")
    with pytest.raises(TypeError):
        msgpack_lite.packb({"x": object()})


def test_checkpoint_atomicity_and_retention(tmp_path):
    """tests/test_train_loop.py::test_checkpoint_atomicity_and_retention."""
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.latest_step(d) == 5
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                   if n.startswith("step_") and not n.endswith(".done"))
    assert steps == [4, 5]
    os.makedirs(os.path.join(d, ".tmp_ckpt_zzz"), exist_ok=True)
    assert ckpt.latest_step(d) == 5
    # an uncommitted step (no .done marker) is never picked up
    os.makedirs(os.path.join(d, "step_00000009"))
    assert ckpt.latest_step(d) == 5
    # a save that fails mid-way leaves no temporary directory behind
    with pytest.raises(TypeError):
        ckpt.save(d, 6, tree, extra={"bad": object()})
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_ckpt_")
                and n != ".tmp_ckpt_zzz"]
    assert ckpt.latest_step(d) == 5


def test_checkpoint_restore_structure_and_bits(tmp_path):
    """tests/test_train_loop.py::test_checkpoint_restore_structure, and a
    (params, state) tuple with f32, bf16 and int32 leaves back bit for
    bit, the meta's msgpack readable by ``msgpack``."""
    d = str(tmp_path / "ck2")
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 4)).astype(np.float32))
    ckpt.save(d, 7, {"w": w, "step": torch.tensor(7)})
    restored, meta = ckpt.restore(d, {"w": torch.empty(4, 4),
                                      "step": torch.empty((),
                                                          dtype=torch.int64)})
    assert torch.equal(restored["w"], w) and int(restored["step"]) == 7
    assert meta["step"] == 7 and meta["shardings"] == {}
    tree = ({"embed": torch.randn(5, 3),
             "blocks": {"w": torch.randn(2, 3).bfloat16()}},
            {"step": torch.tensor(3, dtype=torch.int32)})
    path = ckpt.save(d, 9, tree, extra={"next_step": 9})
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = msgpack.unpackb(f.read())
    assert meta["keys"] == ["0/blocks/w", "0/embed", "1/step"]
    assert meta["dtypes"] == ["bfloat16", "float32", "int32"]
    like = ({"embed": torch.zeros(5, 3),
             "blocks": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}},
            {"step": torch.zeros((), dtype=torch.int32)})
    back, meta = ckpt.restore(d, like)
    assert meta["extra"] == {"next_step": 9}
    for (_, a), (_, b) in zip(model_zoo.leaves(dict(enumerate(back))),
                              model_zoo.leaves(dict(enumerate(tree)))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        ckpt.restore(d, ({"embed": torch.zeros(4, 3), "blocks": {
            "w": torch.zeros(2, 3, dtype=torch.bfloat16)}}, like[1]))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), like)


def test_checkpoints_cross_between_packages(tmp_path):
    """Which package reads the other's files. The port reads the
    reference's checkpoint of a (params, AdamW state) tree, f32, int32 and
    bf16 leaves, bit for bit. The reference reads the port's f32 and
    int32 leaves bit for bit; a bf16 leaf it cannot read back, from the
    port's file as from its own (``astype`` from numpy's 2-byte void:
    "No cast function available"). The files hold the same keys, dtypes
    and bytes."""
    rcfg, cfg, rp, pp = carried("smollm-360m")
    ri, _ = ref_step.make_train_step(rcfg)
    pi, _ = make_train_step(cfg)
    rtree = (rp, ri(rp))
    ref_ckpt.save(str(tmp_path / "ref"), 3, rtree, extra={"next_step": 3})
    ptree, meta = ckpt.restore(str(tmp_path / "ref"), (pp, pi(pp)))
    assert meta["extra"]["next_step"] == 3
    flat_r = ref_state_leaves({"p": rtree[0], "s": rtree[1]})
    flat_p = dict(model_zoo.leaves({"p": ptree[0], "s": ptree[1]}))
    assert set(flat_r) == set(flat_p)
    for k, v in flat_r.items():
        np.testing.assert_array_equal(flat_p[k].numpy(), np.asarray(v))
    # the port's file, read by the reference
    ckpt.save(str(tmp_path / "port"), 3, ptree, extra={"next_step": 3})
    back, rmeta = ref_ckpt.restore(str(tmp_path / "port"), rtree)
    assert rmeta["keys"] == meta["keys"] and rmeta["dtypes"] == meta["dtypes"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    zr = np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz")
    zp = np.load(tmp_path / "port" / "step_00000003" / "arrays.npz")
    assert sorted(zr.files) == sorted(zp.files)
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype and zr[k].tobytes() == \
            zp[k].tobytes(), k
    # bf16 leaves: the port reads the reference's; the reference reads
    # neither file back
    bf = {"w": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)}
    ref_ckpt.save(str(tmp_path / "bf"), 1, bf)
    got, _ = ckpt.restore(str(tmp_path / "bf"),
                          {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert got["w"].tolist() == [1.5, -2.25, 3.0]
    ckpt.save(str(tmp_path / "bf_port"), 1, got)
    for d in ("bf", "bf_port"):
        with pytest.raises(ValueError, match="No cast function"):
            ref_ckpt.restore(str(tmp_path / d), bf)


# ---------------------------------------------------------------------------
# the loop and its restart contract
# ---------------------------------------------------------------------------

def test_checkpoint_restart_bit_exact(tmp_path):
    """tests/test_train_loop.py::test_checkpoint_restart_bit_exact, held
    to the bit: the restarted run's losses and final parameters equal the
    uninterrupted run's exactly."""
    d1, d2 = str(tmp_path / "uninterrupted"), str(tmp_path / "interrupted")
    ref = train(CFG, steps=8, ckpt_dir=d1, ckpt_every=4, **KW)
    with pytest.raises(SimulatedFailure):
        train(CFG, steps=8, ckpt_dir=d2, ckpt_every=4, fail_at=6, **KW)
    assert ckpt.latest_step(d2) == 4
    res = train(CFG, steps=8, ckpt_dir=d2, ckpt_every=4, **KW)
    assert [m["step"] for m in res["history"]] == [4, 5, 6, 7]
    ref_by_step = {m["step"]: m for m in ref["history"]}
    for m in res["history"]:
        assert m == ref_by_step[m["step"]], m["step"]
    assert leaves_equal(ref["params"], res["params"])
    assert leaves_equal(ref["opt_state"], res["opt_state"])


def test_failure_injection_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "2")
    with pytest.raises(SimulatedFailure, match="step 2"):
        train(CFG, steps=4, ckpt_dir=str(tmp_path / "env"), ckpt_every=1,
              **KW)
    assert ckpt.latest_step(str(tmp_path / "env")) == 2


def test_loop_logs_walls_and_saves_each_step_once(tmp_path):
    """``on_log`` gets every logged row with its wall; the final save is
    skipped where the last step's save wrote the same step, and made
    where it did not."""
    rows = []
    out = train(CFG, steps=4, ckpt_dir=str(tmp_path / "a"), ckpt_every=2,
                on_log=lambda m, w: rows.append((m, w)), **KW)
    assert [m for m, _ in rows] == out["history"]
    assert [w for _, w in rows] == out["walls"]
    assert [m["step"] for m in out["history"]] == [0, 1, 2, 3]
    assert all(w > 0 for w in out["walls"])
    assert [c["step"] for c in out["checkpoints"]] == [2, 4]
    assert all(c["bytes"] > 0 and c["seconds"] >= 0
               for c in out["checkpoints"])
    out = train(CFG, steps=3, ckpt_dir=str(tmp_path / "b"), ckpt_every=2,
                **KW)
    assert [c["step"] for c in out["checkpoints"]] == [2, 3]
    assert out["start_step"] == 0


def test_restore_structure_of_the_loop(tmp_path):
    """A loop's checkpoint restores into (params, state) of the same trees,
    with the pipeline's state in ``extra``."""
    d = str(tmp_path / "loop")
    out = train(CFG, steps=2, ckpt_dir=d, ckpt_every=0, **KW)
    assert ckpt.latest_step(d) is None
    out = train(CFG, steps=2, ckpt_dir=d, ckpt_every=2, **KW)
    like = (model_zoo.init_params(CFG, 1, device="cpu"),
            make_train_step(CFG)[0](model_zoo.init_params(CFG, 1,
                                                          device="cpu")))
    (params, state), meta = ckpt.restore(d, like)
    assert meta["extra"] == {"next_step": 2, "pipeline": {
        "step": 2, "seed": 0, "num_shards": 1, "shard_id": 0}}
    assert leaves_equal(params, out["params"])
    assert int(state["step"]) == 2


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ALL_ARCHS)
def test_reduced_equals_reference(arch):
    for scale in (0.05, 0.1, 0.25, 0.5, 1.0):
        want = ref_launch.reduced(ref_configs.get_config(arch), scale)
        got = launch.reduced(configs.get_config(arch), scale)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), scale


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "launch")
    args = ["--arch", "smollm-360m", "--scale", "0.1", "--global-batch",
            "2", "--seq-len", "32", "--ckpt-dir", d, "--ckpt-every", "2",
            "--device", "cpu"]
    first = launch.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] smollm-360m scale=0.1 on cpu" in out
    assert "step     0 loss=" in out and "step     2 loss=" in out
    assert out.rstrip().endswith("[train] done")
    assert [r["step"] for r in first["steps"]] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in first["steps"])
    assert [c["step"] for c in first["checkpoints"]] == [2, 3]
    assert all(c["bytes"] > 0 for c in first["checkpoints"])
    assert first["peak_bytes"] is None
    second = launch.main(args + ["--steps", "5"])
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert second["start_step"] == 3
    assert [r["step"] for r in second["steps"]] == [3, 4]
    straight = launch.main([a if a != d else str(tmp_path / "straight")
                            for a in args] + ["--steps", "5"])
    assert [r["loss"] for r in straight["steps"][3:]] == \
        [r["loss"] for r in second["steps"]]
    assert leaves_equal(straight["params"], second["params"])


def test_example_trains_and_loss_falls(tmp_path, capsys):
    """``examples/train_lm.py``'s config and its "loss should fall" check
    at a few steps (its default is 120)."""
    cfg, batch, seq = train_lm.example_config()
    ref = small_ref_example()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (batch, seq) == (8, 128)
    out = train_lm.main(["--steps", "12", "--ckpt-dir", str(tmp_path / "ex"),
                         "--ckpt-every", "6", "--device", "cpu"])
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert ckpt.latest_step(str(tmp_path / "ex")) == 12
    assert "checkpoints in" in capsys.readouterr().out


def small_ref_example():
    """The reference example's default config (examples/train_lm.py)."""
    return ref_configs.get_config("smollm-360m").scaled(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, d_ff=688,
        vocab_size=4096, head_dim=64)
