"""Meshes (a port of ``repro.launch.mesh``): the LM's production and
host meshes, and the search and serve meshes of the sharded index.

The LM's meshes (``make_production_mesh``, ``make_host_mesh``) are
``torch.distributed`` ``DeviceMesh`` objects with the reference's shapes
and axis names, one rank per device. They are functions: importing this
module touches no process group. They use the process group that
stands, whose world must hold exactly the mesh's devices: a launcher on
one card makes a world of 1; the dry run makes a world of 256 or 512
fake ranks (``torch.distributed``'s "fake" backend), the production
mesh's size, as the reference's dry run forces 512 placeholder devices.

The reference searches as one program over a ``jax.sharding.Mesh``;
the port's search runs one controller that steps every shard in turn. A
``SearchMesh`` is therefore only names and devices: the ``"model"`` axis, whose shards
split an index's rows (``dist.sharding.place_index``), an optional
``"hosts"`` axis in front of it, whose host groups split the slot pool
(``dist.sharding.slot_sharding``), and one ``torch.device`` per (host
group, shard), in row-major order. Shards may share a device:
``make_search_mesh(4, "cuda:0")`` puts four shards on one card, as the
reference's forced host device count puts several devices on one CPU.

Building a search mesh touches no device state beyond counting the
cards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

SHARD_AXIS = "model"
HOSTS_AXIS = "hosts"


@dataclasses.dataclass(frozen=True)
class SearchMesh:
    """Axis names, their sizes and one device per (host group, shard).

    ``make_search_mesh`` gives the 1-D ``("model",)`` mesh the sharded
    search runs on; ``make_serve_mesh`` the 2-D ``("hosts", "model")``
    mesh of the multi-host slot pool, whose host group h holds the
    devices ``[h * S, (h + 1) * S)`` (``host(h)``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        count = 1
        for size in self.sizes:
            count *= size
        if count != len(self.devices) or count < 1:
            raise ValueError(f"mesh of sizes {self.sizes} needs {count} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        """Size per axis name, in axis order (as ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def lead(self) -> torch.device:
        """Where replicated tables, search state and merges live (host
        group 0's, on a serve mesh)."""
        return self.devices[0]

    @property
    def num_hosts(self) -> int:
        """Size of the ``"hosts"`` axis (1 when the mesh lacks it)."""
        return self.shape.get(HOSTS_AXIS, 1)

    def host(self, h: int) -> "SearchMesh":
        """Host group h's 1-D ``("model",)`` sub-mesh: its S devices,
        shard order. A mesh without a hosts axis is its own group 0."""
        if not 0 <= h < self.num_hosts:
            raise ValueError(f"host group {h} of {self.num_hosts}")
        if HOSTS_AXIS not in self.axis_names:
            return self
        s = len(self.devices) // self.num_hosts
        return SearchMesh((SHARD_AXIS,), (s,),
                          self.devices[h * s:(h + 1) * s])

    def host_meshes(self) -> Tuple["SearchMesh", ...]:
        return tuple(self.host(h) for h in range(self.num_hosts))


PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                 device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the standing process group,
    whose world size must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs a process group of {size} "
                         f"ranks; none is initialised")
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a {shape} mesh needs a world of {size} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16 x 16 = 256 devices a pod, ("data", "model"); 2 pods = 512 when
    ``multi_pod``, ("pod", "data", "model")."""
    if multi_pod:
        return _device_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return _device_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)


def make_host_mesh(device_type="cuda"):
    """A one-device mesh with the production axis names, (1, 1)."""
    return _device_mesh((1, 1), PRODUCTION_AXES, device_type)


def make_search_mesh(num_shards: int = 0, device="cuda") -> SearchMesh:
    """1-D ``("model",)`` mesh for sharded ANN search.

    ``device="cuda"`` with no index spreads the shards over the visible
    cards, one each; ``num_shards`` 0 means all of them, and asking for
    more shards than cards raises. A single named device (``"cuda:0"``,
    ``"cpu"``) holds every shard; ``num_shards`` 0 then means one."""
    dev = torch.device(device)
    if num_shards < 0:
        raise ValueError(f"num_shards must be >= 0, got {num_shards}")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if dev.index is None:
            n = num_shards or count
            if count < n or n < 1:
                raise ValueError(
                    f"--shards {n or 'all'} needs {n or 1} CUDA devices but "
                    f"only {count} visible; name one device (e.g. "
                    f"--device cuda:0) to put every shard on it")
            return SearchMesh((SHARD_AXIS,), (n,),
                              tuple(torch.device("cuda", i)
                                    for i in range(n)))
        if dev.index >= count:
            raise ValueError(f"{dev} is not visible ({count} CUDA devices)")
    n = num_shards or 1
    return SearchMesh((SHARD_AXIS,), (n,), (dev,) * n)


def device_capacity(device="cuda") -> float:
    """How many shards ``device`` can hold: the visible cards for
    ``"cuda"`` (one shard each), any number for a named device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.device_count()
    return float("inf")


def make_serve_mesh(hosts: int = 1, shards: int = 0,
                    device="cuda") -> SearchMesh:
    """2-D ``("hosts", "model")`` mesh for the multi-host slot pool.

    The ``"model"`` axis shards the index as on ``make_search_mesh``; the
    ``"hosts"`` axis splits the slot dim, so host group h's devices step
    only the slot slice its host loop owns. The H x S devices lie in
    row-major order. ``device="cuda"`` puts one (host group, shard) on
    each card; ``shards`` 0 means all the cards a host group can have,
    and asking for more than the visible cards raises. A named device
    (``"cuda:0"``, ``"cpu"``) holds every one; ``shards`` 0 then means
    one."""
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if shards < 0:
        raise ValueError(f"shards must be >= 0, got {shards}")
    cap = device_capacity(device)
    n = shards or (max(int(cap) // hosts, 1) if cap < float("inf") else 1)
    flat = make_search_mesh(hosts * n, device)
    return SearchMesh((HOSTS_AXIS, SHARD_AXIS), (hosts, n), flat.devices)


def describe(mesh) -> str:
    """The mesh's sizes and axis names (the reference's line), and for a
    ``SearchMesh`` the devices it lives on."""
    if hasattr(mesh, "mesh_dim_names"):
        return f"mesh{tuple(mesh.shape)} axes={tuple(mesh.mesh_dim_names)}"
    devs = sorted({str(d) for d in mesh.devices})
    return (f"mesh{tuple(mesh.sizes)} axes={mesh.axis_names} on "
            f"{','.join(devs)}")
