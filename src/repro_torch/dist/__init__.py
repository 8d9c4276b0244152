"""repro_torch.dist — index placement on a search mesh (``sharding``) and
the cross-shard search collectives (``collectives``), a port of
``repro.dist``'s search part: the sharded flat search and the sharded
IVF probe step. The sharded HNSW beam step and the hosts axis
(``slot_sharding``, ``constrain_slots``, ``refresh_placed_view``) are
ROADMAP Queue 1 item 3, slices 3.3 and 3.4; the model-parameter rules
belong to the LM stack."""
from repro_torch.dist import collectives, sharding
from repro_torch.dist.collectives import (make_sharded_flat_search,
                                          make_sharded_probe_step,
                                          merge_topk)
from repro_torch.dist.sharding import place_index

__all__ = ["collectives", "sharding", "make_sharded_flat_search",
           "make_sharded_probe_step", "merge_topk", "place_index"]
