"""Index kind "hnsw": the port's graph (``index/hnsw.py`` build, the batched
beam step) behind ``core.engines.hnsw_engine``.

Keys of the configuration's ``index`` block: ``m``, ``ef_construction``,
``passes``, ``alpha``, ``build_chunk`` (rows searched at once in the
build: its [chunk, N] visited bitmap; the graph does not depend on it),
``ef``, ``max_steps``. The engine keeps the exact [slots, N] visited
bitmap.
"""
from __future__ import annotations

from typing import Any, Dict


def build(cfg: Dict[str, Any], base, *, k: int, seed: int,
          device) -> Dict[str, Any]:
    from repro_torch.core import engines
    from repro_torch.index import hnsw

    split: Dict[str, float] = {}
    index = hnsw.build(base.cpu().numpy(), int(cfg["m"]),
                       ef_construction=int(cfg["ef_construction"]),
                       passes=int(cfg["passes"]), alpha=float(cfg["alpha"]),
                       chunk=int(cfg["build_chunk"]), seed=seed,
                       device=device, seconds=split)
    engine_kw = {"k": k, "ef": int(cfg["ef"]),
                 "max_steps": int(cfg["max_steps"])}

    def make_engine(**kw):
        return engines.hnsw_engine(index, **kw)

    return {"index": index, "make_engine": make_engine,
            "engine_kw": engine_kw,
            "info": {"build_split_s": split,
                     "visited_bytes_per_slot": index.num_vectors}}
