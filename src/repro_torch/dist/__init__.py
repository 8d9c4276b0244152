"""repro_torch.dist — index placement on a search or serve mesh
(``sharding``) and the cross-shard search collectives (``collectives``),
a port of ``repro.dist``'s search part: the sharded flat search, the
sharded IVF probe step and the sharded HNSW beam step, a mutable view
under a mesh (``refresh_placed_view``) and the slot rule of the serve
mesh's ``"hosts"`` axis (``slot_sharding``, ``constrain_slots``,
``host_index``). The model-parameter rules belong to the LM stack."""
from repro_torch.dist import collectives, sharding
from repro_torch.dist.collectives import (make_sharded_beam_step,
                                          make_sharded_flat_search,
                                          make_sharded_hnsw_init,
                                          make_sharded_probe_step,
                                          merge_topk)
from repro_torch.dist.sharding import place_index, refresh_placed_view

__all__ = ["collectives", "sharding", "make_sharded_beam_step",
           "make_sharded_flat_search", "make_sharded_hnsw_init",
           "make_sharded_probe_step", "merge_topk", "place_index",
           "refresh_placed_view"]
