"""repro_torch.dist — cross-shard search collectives (a port of
``repro.dist``). Only the candidate merge is ported so far; the sharded
flat, probe and beam steps and index placement are ROADMAP Queue 1
item 8."""
from repro_torch.dist import collectives
from repro_torch.dist.collectives import merge_topk

__all__ = ["collectives", "merge_topk"]
