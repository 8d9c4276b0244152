"""The LM's multi-device tooling in real worlds of several ranks (gloo on
the CPU), each in a child process so that no test worker keeps a
default process group:

- ``compressed_grad_mean`` at world 4, on a ("data",) mesh and a
  ("pod", "data") mesh, against the reference's under ``jax.vmap``
  with the same axis names: error state bit-equal, the mean within a
  4-term sum's rounding;
- a checkpoint saved on a (4, 2) mesh and restored on (2, 4), world 8
  (``tests/test_elastic_multidevice.py``'s scenario), by a tree of
  shardings and by the mesh alone; each package reads the other's
  placement record;
- a 2-layer train step at width 64 on a (2, 2) mesh against the same
  step on one device;
- the launcher on the host mesh against the plain loop, bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import msgpack  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro import ckpt as ref_ckpt  # noqa: E402
from repro.ckpt import checkpoint as ref_checkpoint  # noqa: E402
from repro.optim import grad_compress as ref_gc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
torch.set_num_threads(1)

JOB, OUT, WORLD = sys.argv[1], sys.argv[2], int(sys.argv[3])


def grads_for(rank, step):
    rng = np.random.default_rng([7, rank, step])
    return {"a": rng.normal(size=(300,)).astype(np.float32),
            "b": {"w": (rng.normal(size=(17, 40)) * 3).astype(np.float32),
                  "h": rng.normal(size=(5,)).astype(np.float32)}}


def to_torch(tree, bf16=("h",)):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v).to(
        torch.bfloat16 if k in bf16 else torch.float32) for k, v in tree.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v.float().numpy()
    return out


def cgm(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim.grad_compress import compressed_grad_mean
    res = {}
    for name, shape, axes in (("data", (4,), ("data",)),
                              ("pod_data", (2, 2), ("pod", "data"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        err = None
        for step in (0, 1):
            mean, err = compressed_grad_mean(
                to_torch(grads_for(rank, step)), err, mesh, axes)
            for k, v in flat(mean).items():
                res[f"{name}/{step}/mean/{k}"] = v
            for k, v in flat(err).items():
                res[f"{name}/{step}/err/{k}"] = v
            assert mean["b"]["h"].dtype == torch.bfloat16
    np.savez(os.path.join(OUT, f"cgm_{rank}.npz"), **res)


def elastic(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch import ckpt
    from repro_torch.dist.sharding import NamedSharding
    mesh_a = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    w = torch.arange(64.0).reshape(8, 8)
    w_a = distribute_tensor(w, mesh_a, [Shard(0), Shard(1)]) * 1.5 + 1.0
    ckpt.save(os.path.join(OUT, "port"), 1, {"w": w_a})
    mesh_b = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    like = {"w": torch.empty(8, 8)}
    by_tree, _ = ckpt.restore(os.path.join(OUT, "port"), like, shardings={
        "w": NamedSharding(mesh_b, ("data", "model"))})
    by_mesh, meta = ckpt.restore(os.path.join(OUT, "port"), like,
                                 shardings=mesh_b)
    from_ref, ref_meta = ckpt.restore(os.path.join(OUT, "ref"), like,
                                      shardings=mesh_b)
    expect = (torch.arange(64.0).reshape(8, 8) * 1.5 + 1.0) * 1.5 + 1.0
    out = {}
    for tag, t in (("tree", by_tree["w"]), ("mesh", by_mesh["w"]),
                   ("ref", from_ref["w"])):
        stepped = (t * 1.5 + 1.0).full_tensor()
        want = expect if tag != "ref" else torch.arange(64.0).reshape(8, 8)
        got = stepped if tag != "ref" else t.full_tensor()
        out[tag] = {"values": bool(torch.equal(got, want)),
                    "placements": [repr(p) for p in t.placements],
                    "mesh": list(t.device_mesh.shape),
                    "local": list(t.to_local().shape)}
    out["saved_meta"] = meta["shardings"]
    out["ref_meta"] = ref_meta["shardings"]
    if rank == 0:
        with open(os.path.join(OUT, "elastic.json"), "w") as f:
            json.dump(out, f)


def small_cfg():
    from repro_torch import configs
    return configs.get_config("smollm-360m").scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16)


def train(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.synthetic import PipelineConfig, TokenPipeline
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.train import step as step_lib
    from repro_torch.utils import meshctx
    cfg = small_cfg()
    batch = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                         seq_len=64, global_batch=4),
                          device="cpu").get_batch(0)
    init, step = step_lib.make_train_step(cfg, peak_lr=1e-3)
    params = model_zoo.init_params(cfg, 0, device="cpu")
    opt = init(params)
    _, m1, g1 = step_lib.grads_of(cfg, params, batch)
    p1, _, s1 = step(params, opt, batch)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pd = sh.distribute(params, sh.param_shardings(params, mesh))
    od = sh.distribute(opt, sh.opt_shardings(opt, params, mesh))
    bd = sh.distribute(batch, sh.batch_shardings(batch, mesh))
    with meshctx.use_mesh(mesh, sp=True):
        with meshctx.step_scope():
            _, m2, g2 = step_lib.grads_of(cfg, pd, bd)
        p2, o2, s2 = step(pd, od, bd)
    whole = {k: v.full_tensor() for k, v in s2.items()}
    g2 = {"/".join(k): v.full_tensor() for k, v in model_zoo.leaves(g2)}
    g1 = {"/".join(k): v for k, v in model_zoo.leaves(g1)}
    placements = {"/".join(k): [repr(p) for p in v.placements]
                  for k, v in model_zoo.leaves(p2)}
    if rank == 0:
        res = {"loss": [float(s1["loss"]), float(whole["loss"])],
               "grad_norm": [float(s1["grad_norm"]),
                             float(whole["grad_norm"])],
               "grad_rel": {k: float((g2[k] - g1[k]).abs().max())
                            / float(g1[k].abs().max()) for k in g1},
               "step_equal": int(o2["step"].full_tensor()) == 1,
               "placements": placements}
        with open(os.path.join(OUT, "train.json"), "w") as f:
            json.dump(res, f)


def host(rank):
    import tempfile
    from repro_torch import configs
    from repro_torch.launch import train as launch
    from repro_torch.models import model_zoo
    from repro_torch.train import loop
    cfg = launch.reduced(configs.get_config("smollm-360m"), 0.1)
    d = tempfile.mkdtemp(dir=OUT)
    plain = loop.train(cfg, steps=4, global_batch=4, seq_len=32,
                       ckpt_dir=d + "/plain", ckpt_every=2, peak_lr=1e-3,
                       log_every=1, device="cpu")
    args = ["--arch", "smollm-360m", "--steps", "4", "--global-batch", "4",
            "--seq-len", "32", "--ckpt-every", "2", "--scale", "0.1",
            "--device", "cpu"]
    mesh = launch.main(args + ["--ckpt-dir", d + "/mesh"])
    resumed = launch.main(args[:3] + ["6"] + args[4:]
                          + ["--ckpt-dir", d + "/mesh"])
    pl = dict(model_zoo.leaves(plain["params"]))
    ml = dict(model_zoo.leaves(mesh["params"]))
    res = {"mesh": mesh["mesh"],
           "losses": [[m["loss"] for m in plain["history"]],
                      [m["loss"] for m in mesh["steps"]]],
           "params_equal": all(torch.equal(pl[k], ml[k])
                               for k in pl),
           "plain": all(type(v) is torch.Tensor for v in ml.values()),
           "resumed_from": resumed["start_step"],
           "group_closed": not dist.is_initialized()}
    with open(os.path.join(OUT, "host.json"), "w") as f:
        json.dump(res, f)


def run(rank):
    if WORLD > 1:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(OUT, "store"), WORLD),
            rank=rank, world_size=WORLD)
    try:
        {"cgm": cgm, "elastic": elastic, "train": train, "host": host}[JOB](
            rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    if WORLD == 1:
        run(0)
    else:
        mp.start_processes(run, nprocs=WORLD, start_method="fork")
'''


def run_world(tmp_path, job, world):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), job, str(tmp_path),
                          str(world)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


def _grads(rank, step):
    rng = np.random.default_rng([7, rank, step])
    return {"a": rng.normal(size=(300,)).astype(np.float32),
            "b": {"w": (rng.normal(size=(17, 40)) * 3).astype(np.float32),
                  "h": rng.normal(size=(5,)).astype(np.float32)}}


def _ref_leaves(g):
    """The reference's inputs: "h" in bf16, as the port's worker has it."""
    return {"a": jnp.asarray(g["a"]), "b": {
        "w": jnp.asarray(g["b"]["w"]),
        "h": jnp.asarray(g["b"]["h"]).astype(jnp.bfloat16)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v, dtype=np.float32)})
    return out


def test_compressed_grad_mean_matches_the_reference_under_vmap(tmp_path):
    """World 4: error feedback, the int8 roundtrip, a sum over the named
    mesh dims and a division by their size, two steps (the second
    carries the first's error). The error state is bit-equal; the mean
    lies within 4 f32 ulps of the 4-term sum of |roundtrips| / 4 (gloo
    and XLA add the terms in their own orders), plus one bf16 ulp of the
    mean for the bf16 leaf, which rounds the f32 mean."""
    run_world(tmp_path, "cgm", 4)
    got = [dict(np.load(tmp_path / f"cgm_{r}.npz")) for r in range(4)]
    eps = float(np.finfo(np.float32).eps)
    for name, shape, axes in (("data", (4,), ("data",)),
                              ("pod_data", (2, 2), ("pod", "data"))):
        def f(g, e):
            return ref_gc.compressed_grad_mean(g, e, axes)
        fn = jax.vmap(f, axis_name=axes[-1])
        if len(axes) == 2:
            fn = jax.vmap(fn, axis_name=axes[0])
        err = None
        for step in (0, 1):
            per_rank = [_ref_leaves(_grads(r, step)) for r in range(4)]
            stacked = jax.tree.map(
                lambda *xs: jnp.stack(xs).reshape(shape + xs[0].shape),
                *per_rank)
            if err is None:
                e_in = jax.tree.map(jnp.zeros_like, stacked)
            else:
                e_in = err
            mean, err = fn(stacked, e_in)
            sent = jax.tree.map(
                lambda g, e: jax.vmap(ref_gc.compress_roundtrip)(
                    (g.astype(jnp.float32) + e).reshape((4,) + g.shape[
                        len(shape):])), stacked, e_in)
            mean_f, err_f, sent_f = _flat(mean), _flat(err), _flat(sent)
            for r in range(4):
                idx = np.unravel_index(r, shape)
                for k in mean_f:
                    want_e = err_f[k][idx]
                    have_e = got[r][f"{name}/{step}/err/{k}"]
                    assert np.array_equal(have_e, want_e), (name, step, k)
                    want = mean_f[k][idx]
                    have = got[r][f"{name}/{step}/mean/{k}"]
                    tol = 4 * eps * np.abs(sent_f[k]).sum(0) / 4
                    if k == "b/h":
                        tol = tol + np.abs(want) * 2.0 ** -8
                    assert np.all(np.abs(have - want) <= tol), (
                        name, step, k, np.abs(have - want).max())


def test_elastic_restore_across_meshes_and_packages(tmp_path):
    """World 8 (tests/test_elastic_multidevice.py's scenario): w on a
    (4, 2) mesh, one step, saved; restored onto (2, 4) by a tree of
    shardings and by the mesh alone (each saved spec re-derived), one
    more step: the values and the placements asked for. The reference
    reads the port's placement record, and the port the reference's."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    w = jax.device_put(jnp.arange(64.0, dtype=jnp.float32).reshape(8, 8),
                       jax.sharding.NamedSharding(mesh, P("data", "model")))
    ref_ckpt.save(str(tmp_path / "ref"), 1, {"w": w})
    run_world(tmp_path, "elastic", 8)
    res = json.loads((tmp_path / "elastic.json").read_text())
    for tag in ("tree", "mesh", "ref"):
        assert res[tag]["values"], (tag, res)
        assert res[tag]["placements"] == ["Shard(dim=0)", "Shard(dim=1)"], res
        assert res[tag]["mesh"] == [2, 4] and res[tag]["local"] == [4, 2]
    record = {"spec": ["data", "model"], "mesh_axes": ["data", "model"]}
    assert res["saved_meta"]["w"] == dict(record, mesh_shape=[4, 2])
    assert res["ref_meta"]["w"] == dict(record, mesh_shape=[1, 1])
    # the reference reads the port's checkpoint and its placement record
    path = tmp_path / "port" / "step_00000001"
    meta = msgpack.unpackb((path / "meta.msgpack").read_bytes())
    assert meta["shardings"] == res["saved_meta"]
    back = ref_checkpoint._respec(meta["shardings"]["w"],
                            AbstractMesh((2, 4), ("data", "model")), (8, 8))
    assert back.spec == P("data", "model")
    odd = ref_checkpoint._respec(meta["shardings"]["w"],
                           AbstractMesh((3, 4), ("data", "model")), (8, 8))
    assert odd.spec == P(None, "model")
    values, _ = ref_ckpt.restore(str(tmp_path / "port"), {
        "w": jax.ShapeDtypeStruct((8, 8), jnp.float32)})
    assert np.array_equal(np.asarray(values["w"]),
                          np.arange(64.0).reshape(8, 8) * 1.5 + 1.0)
    assert ml_dtypes is not None


def test_sharded_train_step_equals_one_device(tmp_path):
    """A 2-layer train step at width 64 (smollm's family, B 4 x S 64) on
    a (2, 2) mesh with sequence parallelism, against the same step on one
    device: the sharded products add their bf16 partial sums in another
    order, so the loss and the gradient norm agree to bf16's rounding
    (2^-8 of their size) and every gradient leaf within 0.03 of its
    largest value (the card-vs-CPU gate of the same bf16 model, phase 14
    (b)); the optimizer state's step is 1 and every parameter stays a
    DTensor on the mesh."""
    run_world(tmp_path, "train", 4)
    res = json.loads((tmp_path / "train.json").read_text())
    (l1, l2), (n1, n2) = res["loss"], res["grad_norm"]
    assert abs(l1 - l2) <= 2.0 ** -8 * abs(l1), res["loss"]
    assert abs(n1 - n2) <= 2.0 ** -8 * abs(n1), res["grad_norm"]
    assert max(res["grad_rel"].values()) <= 0.03, res["grad_rel"]
    assert res["step_equal"]
    # wq [layers, d_in, d_out]: d_in over data (FSDP), d_out over model
    assert res["placements"]["blocks/attn/wq"] == [
        "Shard(dim=1)", "Shard(dim=2)"]
    print(json.dumps({k: res[k] for k in ("loss", "grad_norm")}),
          max(res["grad_rel"].values()))


def test_launcher_on_the_host_mesh_equals_the_plain_loop(tmp_path):
    """The launcher opens a world of one rank (gloo), runs on the (1, 1)
    host mesh and closes the world; its losses and final parameters equal
    the loop's without a mesh bit for bit, and it resumes from its own
    checkpoint."""
    run_world(tmp_path, "host", 1)
    res = json.loads((tmp_path / "host.json").read_text())
    assert res["mesh"] == "mesh(1, 1) axes=('data', 'model')"
    assert res["losses"][0] == res["losses"][1]
    assert res["params_equal"] and res["plain"]
    assert res["resumed_from"] == 4
    assert res["group_closed"]
