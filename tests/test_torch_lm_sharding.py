"""The LM half of the port's sharding rules and its activation-sharding
context, held against the reference's pure rules on a
``jax.sharding.AbstractMesh`` (no devices: the reference's mesh paths
fail under this jax, its rules do not).

For every registered architecture, every leaf of its parameters, its
AdamW / Adafactor state with the error-feedback buffer, its train /
prefill / decode inputs and its decode cache, at meshes (1, 1),
(16, 16), (2, 16, 16) and (4, 2): the port's spec equals the
reference's ``PartitionSpec`` entry for entry. The port's rules read
only axis names and sizes, so here they take a stand-in mesh; no
process group is opened.
"""
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding as RefSharding  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.dist import sharding as ref_sh  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro.utils import meshctx as ref_meshctx  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from repro_torch.utils import meshctx  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}


def port_mesh(name):
    sizes, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


def ref_mesh(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes)


def ref_specs(tree):
    """{path: spec tuple} of a reference tree of NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefSharding))[0]
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            tuple(leaf.spec) for path, leaf in leaves}


def port_specs(tree, path=()):
    """{path: spec} of a port tree of NamedShardings."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_specs(v, path + (str(k),)))
        return out
    assert isinstance(tree, sh.NamedSharding), type(tree)
    return {path: tuple(tree.spec)}


def assert_same(port_tree, ref_tree):
    want, got = ref_specs(ref_tree), port_specs(port_tree)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])
    return len(want)


ARCHS = ref_configs.ALL_ARCHS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    got = sh.param_shardings(model_zoo.abstract_params(
        configs.get_config(arch)), port_mesh(mesh))
    want = ref_sh.param_shardings(ref_zoo.abstract_params(
        ref_configs.get_config(arch)), ref_mesh(mesh))
    assert assert_same(got, want) > 5
    if mesh == "1x1":      # size-1 axes drop out: every leaf replicates
        assert all(e is None for spec in port_specs(got).values()
                   for e in spec)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_the_reference(arch, optimizer):
    """AdamW's m / v / step or Adafactor's factored leaves, each with the
    error-feedback buffer ``ef``, on every mesh."""
    cfg = configs.get_config(arch)
    params = model_zoo.abstract_params(cfg)
    init, _ = step_lib.make_train_step(cfg, optimizer=optimizer,
                                       compress_grads=True)
    state = init(params)
    ref_cfg = ref_configs.get_config(arch)
    ref_params = ref_zoo.abstract_params(ref_cfg)
    ref_init, _ = ref_step.make_train_step(ref_cfg, optimizer=optimizer,
                                           compress_grads=True)
    ref_state = jax.eval_shape(ref_init, ref_params)
    assert set(state) == set(ref_state) == (
        {"m", "v", "step", "ef"} if optimizer == "adamw"
        else {"leaves", "step", "ef"})
    for mesh in MESHES:
        assert_same(sh.opt_shardings(state, params, port_mesh(mesh)),
                    ref_sh.opt_shardings(ref_state, ref_params,
                                         ref_mesh(mesh)))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape):
    """Each cell's inputs (train / prefill batches, decode tokens) and
    decode caches (every family's tree, the hybrid's "groups" batch dim
    at 2, kv heads on tp)."""
    cell = SHAPES[shape]
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    specs = model_zoo.input_specs(cfg, cell.seq_len, cell.global_batch,
                                  cell.kind)
    ref = ref_zoo.input_specs(ref_cfg, cell.seq_len, cell.global_batch,
                              cell.kind)
    for mesh in MESHES:
        pm, rm = port_mesh(mesh), ref_mesh(mesh)
        if cell.kind == "decode":
            assert_same(sh.cache_shardings(specs["cache"], pm),
                        ref_sh.cache_shardings(ref["cache"], rm))
            got = sh.batch_shardings(specs["tokens"], pm, "decode")
            want = ref_sh.batch_shardings(ref["tokens"], rm, "decode")
            assert tuple(got.spec) == tuple(want.spec)
        else:
            assert_same(sh.batch_shardings(specs["batch"], pm, cell.kind),
                        ref_sh.batch_shardings(ref["batch"], rm, cell.kind))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_size_and_divisibility(mesh):
    """An axis stays iff its size is > 1 and divides the dim; a tuple of
    axes multiplies; absent axes drop; the host mesh replicates."""
    pm, rm = port_mesh(mesh), ref_mesh(mesh)
    cases = [((8, 8), ("dp", "tp")), ((3, 7), ("dp", "tp")),
             ((32, 6), ("dp", "tp")), ((64, 4), (("pod", "data"), None)),
             ((64, 4), (("data", "model"), None)), ((12,), ("hosts",)),
             ((2, 512), (None, "dp")), ((48, 16), ("model", "data")),
             ((1, 1), ("dp", "tp"))]
    for shape, logical in cases:
        got = sh.spec_for(pm, shape, logical)
        assert got == tuple(ref_sh.spec_for(rm, shape, logical)), \
            (shape, logical)
    assert sh.replicated(pm).spec == tuple(ref_sh.replicated(rm).spec) == ()


def test_param_spec_names():
    """Output projections put the contracted dim on tp; replicated names,
    ``mu_*`` and vectors replicate; leading stacked axes stay whole."""
    m = port_mesh("16x16")
    assert sh.param_spec("wq", (32, 960, 960), m) == (None, "data", "model")
    assert sh.param_spec("wo", (32, 960, 960), m) == (None, "model", "data")
    assert sh.param_spec("router", (960, 64), m) == (None, None)
    assert sh.param_spec("mu_r", (2560, 2560), m) == (None, None)
    assert sh.param_spec("scale", (960,), m) == (None,)
    assert sh.param_spec("wi", (8, 17, 32), m) == (None, None, "model")


# ---------------------------------------------------------------------------
# meshctx: the activation constraints (tests/test_utils.py:13-35)
# ---------------------------------------------------------------------------

def test_constrain_noop_without_mesh():
    x = torch.ones((4, 8))
    assert meshctx.current_mesh() is None
    assert meshctx.constrain(x, "dp", None) is x      # literally untouched
    assert meshctx.gather_seq(x) is x


def test_constrain_noop_off_dtensors_and_rank_mismatch():
    """With a mesh active, a plain tensor, or a rank that is not the
    number of logical axes, comes back untouched."""
    x = torch.ones((4, 8))
    with meshctx.use_mesh(port_mesh("4x2"), sp=True):
        assert meshctx.constrain(x, "dp", "tp") is x
        assert meshctx.constrain(x, "dp") is x
        assert meshctx.constrain(x, "dp", None, None) is x
    assert meshctx.current_mesh() is None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_constrain_rule_is_the_references(mesh):
    """The reference's per-dim rule (its ``_resolve``, then keep an axis
    iff the dim divides by its size: a size-1 axis stays, unlike
    ``spec_for``), on odd and even dims, with sp on and off."""
    pm, rm = port_mesh(mesh), ref_mesh(mesh)
    logicals = ("dp", "tp", "dpt", "sp", None, "data", "hosts")
    for sp in (False, True):
        with meshctx.use_mesh(pm, sp=sp), ref_meshctx.use_mesh(rm, sp=sp):
            for ax in logicals:
                assert meshctx._resolve(pm, ax) == ref_meshctx._resolve(rm, ax)
            for shape in ((3, 7), (8, 8), (16, 4096, 960), (256, 6, 2),
                          (512, 32, 64)):
                for la in logicals:
                    for lb in logicals:
                        logical = (la, lb) + (None,) * (len(shape) - 2)
                        want = []
                        for dim, ax in zip(shape, logical):
                            r = ref_meshctx._resolve(rm, ax)
                            axes = r if isinstance(r, tuple) else (r,)
                            size = 1
                            for a in axes if r is not None else ():
                                size *= rm.shape[a]
                            want.append(r if r is not None
                                        and dim % size == 0 else None)
                        assert meshctx.spec_of(pm, shape, logical) == \
                            tuple(want), (shape, logical, sp)


def test_constrain_divisibility_degrades():
    """On the (1, 1) host mesh every size-1 axis divides (it stays, and
    splits nothing); on 16 x 16 an odd dim replicates."""
    with meshctx.use_mesh(port_mesh("1x1")):
        assert meshctx.spec_of(port_mesh("1x1"), (3, 7), ("dp", "tp")) == (
            ("data",), "model")
    m = port_mesh("16x16")
    assert meshctx.spec_of(m, (3, 7), ("dp", "tp")) == (None, None)
    assert meshctx.spec_of(m, (32, 48), ("dp", "tp")) == (("data",), "model")


def test_sp_axis_gated_and_dpt():
    m = port_mesh("1x1")
    with meshctx.use_mesh(m, sp=False):
        assert meshctx._resolve(m, "sp") is None
    with meshctx.use_mesh(m, sp=True):
        assert meshctx._resolve(m, "sp") == "model"
    assert meshctx._resolve(m, "dpt") == ("data", "model")
    assert meshctx._resolve(port_mesh("2x16x16"), "dpt") == (
        "pod", "data", "model")
    assert meshctx._resolve(port_mesh("2x16x16"), "dp") == ("pod", "data")


def test_placements_of_specs():
    """A spec's DTensor placements: Shard(d) on each mesh dim a spec
    entry names, Replicate elsewhere; several axes on one dim in the
    mesh's order, another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = port_mesh("2x16x16")
    assert sh.placements(m, (None, "data", "model")) == (
        Replicate(), Shard(1), Shard(2))
    assert sh.placements(m, (("pod", "data"), None)) == (
        Shard(0), Shard(0), Replicate())
    assert sh.placements(m, ()) == (Replicate(),) * 3
    assert sh.placements(m, [["pod", "model"], None]) == (
        Shard(0), Replicate(), Shard(0))
    with pytest.raises(ValueError):
        sh.placements(m, (("data", "pod"), None))
    with pytest.raises(ValueError):
        sh.placements(m, ("data", "data"))
