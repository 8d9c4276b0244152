"""Search and serve meshes: which devices hold the shards of a sharded
index, and which host group steps which slots (a port of the mesh part
of ``repro.launch.mesh``).

The reference runs one program over a ``jax.sharding.Mesh``; the port
runs one controller that steps every shard in turn. A ``SearchMesh`` is
therefore only names and devices: the ``"model"`` axis, whose shards
split an index's rows (``dist.sharding.place_index``), an optional
``"hosts"`` axis in front of it, whose host groups split the slot pool
(``dist.sharding.slot_sharding``), and one ``torch.device`` per (host
group, shard), in row-major order. Shards may share a device:
``make_search_mesh(4, "cuda:0")`` puts four shards on one card, as the
reference's forced host device count puts several devices on one CPU.

Building a mesh touches no device state beyond counting the cards.
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


def describe(mesh: SearchMesh) -> str:
    devs = sorted({str(d) for d in mesh.devices})
    return (f"mesh{tuple(mesh.sizes)} axes={mesh.axis_names} on "
            f"{','.join(devs)}")
