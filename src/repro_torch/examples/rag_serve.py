"""RAG-style serving: the LM plane and the DARTH retrieval plane composed
(a port of the reference's ``examples/rag_serve.py``, its end-to-end
example).

A smollm-family LM embeds documents and requests (mean-pooled hidden
states); DARTH builds and fits an IVF index on those embeddings; the
``DarthServer`` serves each request at its own declared recall, traced,
and the run replays the worst-served request's termination story
(``repro_torch.obs.explain``); then the LM decodes a few tokens through
its KV cache, conditioned on the top retrieved document. The LM is a
random init (the point is the composed serving path), the example's own
two-layer width unless ``cfg`` names another.

Run on the card, or on the CPU with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.rag_serve [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import api, engines
from repro_torch.index import flat, ivf
from repro_torch.models import model_zoo
from repro_torch.obs import Tracer
from repro_torch.obs.explain import explain
from repro_torch.serve import DarthServer

# The example's LM: smollm-360m's family at a toy width.
EXAMPLE_WIDTHS = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=512, head_dim=16)
DOC_LEN = 24          # tokens a document or request
EMBED_CHUNK = 512     # documents a forward
NLIST, K, LEARN, SLOTS = 64, 5, 512, 32
TARGETS = (0.80, 0.95)  # even requests declare the first, odd the second
PROMPT_EACH, NEW_TOKENS = 8, 6


def example_config() -> ArchConfig:
    return configs.get_config("smollm-360m").scaled(**EXAMPLE_WIDTHS)


def embed_texts(cfg: ArchConfig, params, tokens: torch.Tensor,
                chunk: int = EMBED_CHUNK) -> np.ndarray:
    """Mean-pooled hidden states as retrieval embeddings, f32 [n, d]. The
    mean is the reference's over bf16 states: an f32 sum over the
    sequence, divided by its length, rounded to bf16."""
    out = []
    for lo in range(0, tokens.shape[0], chunk):
        x, _, _ = model_zoo.forward(cfg, params,
                                    {"tokens": tokens[lo:lo + chunk]},
                                    remat=False)
        mean = (x.float().sum(1) / x.shape[1]).to(x.dtype)
        out.append(mean.float().cpu().numpy())
    return np.concatenate(out)


def serve(darth: api.Darth, req_emb: np.ndarray, r_targets: np.ndarray,
          tracer: Optional[Tracer] = None):
    """The DarthServer over the fitted Darth: (results, stats)."""
    server = DarthServer(darth.engine, darth.trained.predictor,
                         darth.interval_for_target, num_slots=SLOTS,
                         tracer=tracer)
    return server.serve(req_emb, r_targets)


def generate(cfg: ArchConfig, params, prompt: torch.Tensor,
             new_tokens: int = NEW_TOKENS
             ) -> Tuple[List[int], torch.Tensor]:
    """Greedy decode through the KV cache: ``prompt`` [1, P] goes in token
    by token, then ``new_tokens`` argmax tokens come out. Returns (their
    ids, the logits each was chosen from [new_tokens, 1, V])."""
    p = prompt.shape[1]
    cache = model_zoo.make_cache(cfg, 1, p + 8, device=prompt.device)
    for t in range(p):
        logits, cache = model_zoo.decode_step(cfg, params, cache,
                                              prompt[:, t:t + 1], t)
    gen, chosen_from = [], []
    tok = logits.argmax(-1)[:, None]
    for t in range(new_tokens):
        gen.append(int(tok[0, 0]))
        chosen_from.append(logits)
        logits, cache = model_zoo.decode_step(cfg, params, cache, tok, p + t)
        tok = logits.argmax(-1)[:, None]
    return gen, torch.stack(chosen_from)


def main(*, cfg: Optional[ArchConfig] = None, n_docs: int = 8_000,
         n_req: int = 64, device="cuda") -> Dict[str, Any]:
    """Embed -> build and fit -> serve at declared recall -> decode, with
    the reference's defaults and flow; prints as the reference does and
    returns what it printed with the index, the Darth and the
    embeddings."""
    rng = np.random.default_rng(0)
    cfg = cfg or example_config()
    params = model_zoo.init_params(cfg, seed=0, device=device)

    # --- Retrieval plane: corpus of "documents" = embedded token strings.
    doc_tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (n_docs, DOC_LEN)),
        dtype=torch.int32, device=device)
    print("embedding corpus ...")
    t0 = time.time()
    corpus = embed_texts(cfg, params, doc_tokens)
    embed_s = time.time() - t0

    t0 = time.time()
    index = ivf.build(corpus, nlist=NLIST, seed=0, device=device)
    darth = api.Darth(
        make_engine=lambda **kw: engines.ivf_engine(index, **kw),
        engine=engines.ivf_engine(index, k=K, nprobe=NLIST))
    learn_q = corpus[rng.choice(n_docs, LEARN, replace=False)] \
        + rng.normal(size=(LEARN, corpus.shape[1])).astype(np.float32) * 0.05
    darth.fit(learn_q, corpus)
    fit_s = time.time() - t0
    print(f"retrieval fit: mse={darth.trained.metrics['mse']:.5f}")

    # --- Serve: mixed per-request recall targets through the engine.
    req_tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (n_req, DOC_LEN)),
        dtype=torch.int32, device=device)
    req_emb = embed_texts(cfg, params, req_tokens)
    r_targets = np.where(np.arange(n_req) % 2 == 0, TARGETS[0], TARGETS[1]
                         ).astype(np.float32)

    tracer = Tracer(label="rag")            # in-memory trace of the serve
    t0 = time.time()
    results, stats = serve(darth, req_emb, r_targets, tracer)
    serve_s = time.time() - t0
    print(f"served {stats.completed} requests in {serve_s:.1f}s "
          f"({stats.engine_steps} engine steps, {stats.refills} refills)")

    # --- Explain one request: the worst-served query's full story.
    print("\nwhy did the worst request terminate? (repro_torch.obs.explain)")
    for line in explain(tracer.last_spans).splitlines():
        print("  " + line)
    print()

    # recall check vs exact
    _, gt_i = flat.search(req_emb, corpus, K, device=device)
    ids = torch.as_tensor(np.stack([r[1] for r in results]), device=device)
    rec = flat.recall_at_k(ids, gt_i).cpu().numpy()
    recall = {TARGETS[0]: float(rec[::2].mean()),
              TARGETS[1]: float(rec[1::2].mean())}
    print(f"recall: target-0.80 reqs {recall[0.80]:.3f}, "
          f"target-0.95 reqs {recall[0.95]:.3f}")

    # --- Decode a few tokens conditioned on the top doc (toy generation).
    top_doc = int(results[0][1][0])
    prompt = torch.cat([doc_tokens[top_doc][None, :PROMPT_EACH],
                        req_tokens[:1, :PROMPT_EACH]], dim=1)
    t0 = time.time()
    gen, _ = generate(cfg, params, prompt)
    decode_s = time.time() - t0
    print("generated token ids (toy):", gen)
    print("\nRAG path: embed -> declarative-recall retrieve -> decode  OK")
    return {"recall": recall, "generated": gen, "results": results,
            "stats": stats, "corpus": corpus, "req_emb": req_emb,
            "learn_q": learn_q, "index": index, "darth": darth,
            "seconds": {"embed": embed_s, "fit": fit_s, "serve": serve_s,
                        "decode": decode_s}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the LM, the index, the fit and the serve "
                         "run (default: the card)")
    main(device=ap.parse_args().device)
