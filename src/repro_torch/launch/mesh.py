"""Search meshes: which devices hold the shards of a sharded index (a port
of the search part of ``repro.launch.mesh``).

The reference runs one program over a ``jax.sharding.Mesh``; the port
runs one controller that steps every shard in turn. A ``SearchMesh`` is
therefore only names and devices: the ``"model"`` axis, whose shards
split an index's rows (``dist.sharding.place_index``), and one
``torch.device`` per shard, in shard order. Shards may share a device:
``make_search_mesh(4, "cuda:0")`` puts four shards on one card, as the
reference's forced host device count puts several devices on one CPU.

Building a mesh touches no device state beyond counting the cards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

SHARD_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class SearchMesh:
    """Axis names, their sizes and one device per shard.

    ``make_search_mesh`` gives the 1-D ``("model",)`` mesh the sharded
    search runs on; a mesh with a ``"hosts"`` axis (the multi-host
    serve) is not ported yet, and the code that takes a mesh refuses
    one."""
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
        """Where replicated tables, search state and merges live."""
        return self.devices[0]


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


def make_serve_mesh(hosts: int = 1, shards: int = 0,
                    device="cuda") -> SearchMesh:
    """Mesh for the slot-pool server. With one host it is the search mesh
    (a hosts axis of size 1 splits nothing); the ``("hosts", "model")``
    mesh that splits the slot dim over host groups is ROADMAP Queue 1
    item 3, slice 3.4, and raises."""
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if hosts > 1:
        raise NotImplementedError(
            f"a serve mesh over {hosts} hosts (the slot dim split over a "
            f"'hosts' axis) is not ported yet: ROADMAP Queue 1 item 3, "
            f"slice 3.4")
    return make_search_mesh(shards, device)


def describe(mesh: SearchMesh) -> str:
    devs = sorted({str(d) for d in mesh.devices})
    return (f"mesh{tuple(mesh.sizes)} axes={mesh.axis_names} on "
            f"{','.join(devs)}")
