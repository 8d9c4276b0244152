"""The port stands alone: it imports neither JAX nor the ``repro``
package (nor ``msgpack``, which the card's machine lacks), and its entry
points default to the card."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any import of these now raises
sys.modules["repro"] = None
sys.modules["msgpack"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.") or m == "msgpack"]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
    for module in ("optim.adamw", "optim.schedule", "optim.grad_compress",
                   "train.step", "train.loop", "ckpt.checkpoint",
                   "ckpt.msgpack_lite", "data.synthetic", "launch.train",
                   "examples.train_lm", "utils", "utils.meshctx",
                   "utils.opcount", "launch.dryrun", "launch.mesh",
                   "dist.sharding"):
        assert f"repro_torch.{module}" in out.stdout, module


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default is usable")
    from repro_torch import convert
    from repro_torch.index import hnsw, ivf
    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    with pytest.raises((AssertionError, RuntimeError)):
        ivf.build(x, nlist=4)
    ivf.build(x, nlist=4, device="cpu")  # the CPU when asked for
    with pytest.raises((AssertionError, RuntimeError)):
        hnsw.build(x, m=4, ef_construction=8, passes=1)
    graph = hnsw.build(x, m=4, ef_construction=8, passes=1, device="cpu")
    arrays = {name: getattr(graph, name).numpy() for name in
              ("vectors", "sqnorm", "neighbors", "entry", "route_ids")}
    with pytest.raises((AssertionError, RuntimeError)):
        convert.hnsw_index_from_numpy(arrays)
    assert convert.hnsw_index_from_numpy(arrays, "cpu").device.type == "cpu"
    # the LM: its weights, its cache and the RAG example
    from repro_torch.examples import rag_serve
    from repro_torch.models import model_zoo
    cfg = rag_serve.example_config().scaled(num_layers=1)
    with pytest.raises((AssertionError, RuntimeError)):
        model_zoo.init_params(cfg)
    params = model_zoo.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    with pytest.raises((AssertionError, RuntimeError)):
        model_zoo.make_cache(cfg, 1, 4)
    assert model_zoo.make_cache(cfg, 1, 4, device="cpu")["k"].device.type \
        == "cpu"
    with pytest.raises((AssertionError, RuntimeError)):
        rag_serve.main(n_docs=16, n_req=2)
    # training: the token stream, the loop, the launcher
    from repro_torch.data.synthetic import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train import train
    stream = PipelineConfig(vocab_size=8, seq_len=4, global_batch=2)
    with pytest.raises((AssertionError, RuntimeError)):
        TokenPipeline(stream).get_batch(0)
    assert TokenPipeline(stream, "cpu").get_batch(0)["tokens"].device.type \
        == "cpu"
    with pytest.raises((AssertionError, RuntimeError)):
        train(cfg, steps=1, global_batch=2, seq_len=4,
              ckpt_dir=str(tmp_path / "loop"), ckpt_every=0)
    with pytest.raises((AssertionError, RuntimeError)):
        launch_train.main(["--arch", "smollm-360m", "--steps", "1",
                           "--ckpt-dir", str(tmp_path / "launch")])
