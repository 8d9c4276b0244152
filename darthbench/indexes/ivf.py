"""Index kind "ivf": the port's IVF index (``index/ivf.py`` build, k-means
in ``index/kmeans.py``) behind ``core.engines.ivf_engine``.

Keys of the configuration's ``index`` block: ``nlist``, ``iters``,
``nprobe``, ``store`` ("f32": the only store whose distances the
check holds exact).
"""
from __future__ import annotations

from typing import Any, Dict


def build(cfg: Dict[str, Any], base, *, k: int, seed: int,
          device) -> Dict[str, Any]:
    from repro_torch.core import engines
    from repro_torch.index import ivf

    if cfg.get("store", "f32") != "f32":
        raise ValueError(f"ivf store {cfg['store']!r}: only f32 is built")
    index = ivf.build(base.cpu().numpy(), int(cfg["nlist"]),
                      iters=int(cfg["iters"]), seed=seed % (1 << 31),
                      device=device)
    engine_kw = {"k": k, "nprobe": int(cfg["nprobe"])}

    def make_engine(**kw):
        return engines.ivf_engine(index, **kw)

    return {"index": index, "make_engine": make_engine,
            "engine_kw": engine_kw,
            "info": {"cap": index.cap, "nlist": index.nlist,
                     "store_bytes": index.bucket_vecs.numel()
                     * index.bucket_vecs.element_size()}}
