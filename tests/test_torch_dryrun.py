"""The port's dry run (``repro_torch.launch.dryrun``) on fake worlds, in
child processes (each opens its own default process group):

- one small cell for each family (dense, vlm, moe, ssm, hybrid, audio),
  at 2 layers (the hybrid 3: one group and a tail) and d_model 64, for
  train, prefill and decode, on fake (2, 2) and (2, 2, 2) worlds: each
  traces to ``ok``, and its argument bytes equal what the placements
  imply leaf by leaf (each dim divided by the sizes of the mesh axes its
  spec entry names);
- ``utils.opcount`` counts a loop by running it: one all-reduce and an
  all-gather in a 5-trip loop count 1x and 5x (the reference's
  ``test_collective_parser_weights_loops``).
"""
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeCell, runnable  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"dense": "smollm-360m", "vlm": "internvl2-26b",
            "moe": "qwen3-moe-30b-a3b", "ssm": "rwkv6-3b",
            "hybrid": "zamba2-1.2b", "audio": "whisper-base"}
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 8
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def small(cfg):
    over = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                d_ff=128, vocab_size=256, head_dim=16)
    if cfg.family == "moe":
        over.update(num_experts=4, experts_per_token=2, moe_d_ff=64)
    if cfg.family == "ssm":
        over.update(num_kv_heads=4, ssm_state=16)
    if cfg.family == "hybrid":
        over.update(num_layers=3, attn_every=2, ssm_state=16, num_kv_heads=4)
    if cfg.family == "audio":
        over.update(encoder_layers=1, frontend_len=8, frontend_dim=32)
    if cfg.family == "vlm":
        over.update(frontend_len=4, frontend_dim=32)
    return cfg.scaled(**over)


_CELLS = r'''
import json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.configs.base import ShapeCell, runnable
from repro_torch.launch import dryrun
sys.path.insert(0, sys.argv[3])
from test_torch_dryrun import FAMILIES, KINDS, SEQ, BATCH, small
sizes = tuple(json.loads(sys.argv[1]))
axes = tuple(json.loads(sys.argv[2]))
n = 1
for s in sizes:
    n *= s
dryrun.open_fake_world(n)
mesh = init_device_mesh("cpu", sizes, mesh_dim_names=axes)
for fam, arch in FAMILIES.items():
    cfg = small(configs.get_config(arch))
    for kind in KINDS:
        cell = ShapeCell("small", SEQ, BATCH, kind)
        if not runnable(cfg, cell)[0]:
            continue
        rec = dict(dryrun.trace(cfg, cell, mesh), family=fam, kind=kind,
                   status="ok")
        print(json.dumps(rec), flush=True)
'''

_LOOP = r'''
import json
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun
from repro_torch.utils import opcount
dryrun.open_fake_world(4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
a = torch.ones(8, 8)
counter = opcount.OpCount()
with counter:
    x = funcol.all_reduce(a, "sum", (mesh, 0)).wait()
    for _ in range(5):
        x = funcol.all_gather_tensor(x[:2], 0, (mesh, 0)).wait()
        x = x @ a
print(json.dumps(counter.result()))
'''


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def records():
    """{mesh: {(family, kind): record}}, one child process per mesh,
    traced on first use."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            sizes, axes = MESHES[mesh]
            rows = _run(_CELLS, json.dumps(sizes), json.dumps(axes),
                        os.path.dirname(os.path.abspath(__file__)))
            cache[mesh] = {(r["family"], r["kind"]): r for r in rows}
        return cache[mesh]
    return get


def _bytes(tree, shardings, sizes):
    """Bytes one device holds of ``tree`` placed by ``shardings``: each dim
    divided by the sizes of the mesh axes its spec entry names."""
    if isinstance(tree, dict):
        return sum(_bytes(tree[k], shardings[k], sizes) for k in tree)
    n = tree.element_size()
    spec = tuple(shardings.spec) + (None,) * (tree.ndim - len(shardings.spec))
    for dim, entry in zip(tree.shape, spec):
        div = 1
        for a in (() if entry is None else
                  entry if isinstance(entry, tuple) else (entry,)):
            div *= sizes[a]
        assert dim % div == 0
        n *= dim // div
    return n


def expected_argument_bytes(cfg, kind, mesh):
    sizes, axes = MESHES[mesh]
    stand_in = types.SimpleNamespace(axis_names=axes,
                                     shape=dict(zip(axes, sizes)))
    shape = dict(zip(axes, sizes))
    params = model_zoo.abstract_params(cfg)
    total = _bytes(params, sh.param_shardings(params, stand_in), shape)
    specs = model_zoo.input_specs(cfg, SEQ, BATCH, kind)
    if kind == "train":
        init, _ = step_lib.make_train_step(cfg)
        opt = init(params)
        total += _bytes(opt, sh.opt_shardings(opt, params, stand_in), shape)
    if kind in ("train", "prefill"):
        total += _bytes(specs["batch"], sh.batch_shardings(
            specs["batch"], stand_in, kind), shape)
    else:
        total += _bytes(specs["cache"], sh.cache_shardings(
            specs["cache"], stand_in), shape)
        total += _bytes({"t": specs["tokens"]}, sh.batch_shardings(
            {"t": specs["tokens"]}, stand_in, "decode"), shape)
    return total


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_small_cells_trace_ok_on_fake_worlds(records, mesh, family):
    cfg = small(configs.get_config(FAMILIES[family]))
    got = records(mesh)
    sizes, _ = MESHES[mesh]
    for kind in KINDS:
        if not runnable(cfg, ShapeCell("small", SEQ, BATCH, kind))[0]:
            continue
        rec = got[(family, kind)]
        assert rec["status"] == "ok"
        assert rec["num_devices"] == 2 ** len(sizes)
        mem = rec["memory"]
        assert mem["argument_bytes"] == expected_argument_bytes(
            cfg, kind, mesh), (kind, mem)
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert mem["output_bytes"] > 0 and rec["hlo_flops"] > 0
        assert rec["hlo_bytes"] > 0 and rec["trace_seconds"] >= 0
        assert rec["collectives"]["total"] > 0    # weights gathered, at least


def test_opcount_weights_loops():
    """One all-reduce (8 x 8 f32 = 256 bytes, counted once) and an
    all-gather of a 2 x 8 f32 slice over 4 ranks (256 bytes of result)
    inside a 5-trip loop (counted 5 times); 6 collectives in all."""
    out = _run(_LOOP)[0]
    assert out["all-reduce"] == 8 * 8 * 4
    assert out["all-gather"] == 8 * 8 * 4 * 5
    assert out["reduce-scatter"] == out["all-to-all"] == 0
    assert out["num_ops"] == 6
    assert out["total"] == 8 * 8 * 4 * 6
    assert out["flops"] == 5 * 2 * 8 * 8 * 8   # the five 8 x 8 x 8 products
