"""The port's RAG example (``python -m repro_torch.examples.rag_serve``)
against the reference's flow (``examples/rag_serve.py``), on the CPU at a
reduced corpus (1,024 documents against the example's 8,000).

- The embeddings (mean-pooled bf16 hidden states of the example's
  two-layer LM, on the reference's weights carried across) equal the
  reference's to within 2^-6 absolute (measured: 0.0059): the compiled
  scan keeps some sums in f32, so a hidden state may be two bf16 ulps
  off (``tests/test_torch_models.py``), and the mean is rounded to bf16
  again.
- On the reference's own index, predictor and request embeddings carried
  across, the port's ``DarthServer`` serves every request the ids the
  reference's serves, and the same counters.
- ``rag_serve.main`` meets each declared target within 0.03 with its
  own LM, index and fit, over 256 requests: the example's 64 give a mean
  recall@5 per target whose standard error (~0.04) exceeds 0.03.
- The greedy tokens equal the reference's at every step where the
  reference's top-1 logit leads its second by more than the logit
  tolerance of the decode path (0.01); after a closer step the two may
  fork.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import gbdt as ref_gbdt  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro.serve import DarthServer as RefServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, engines  # noqa: E402
from repro_torch.examples import rag_serve  # noqa: E402

N_DOCS, N_REQ, GATE_REQ = 1024, 64, 256
EMBED_ATOL = 2.0 ** -6
LOGIT_ATOL = 0.01
TOL = 0.03


def ref_greedy(cfg, params, prompt, new_tokens):
    """The reference example's decode loop; also each step's logits."""
    p = prompt.shape[1]
    cache = ref_zoo.make_cache(cfg, 1, p + 8)
    for t in range(p):
        logits, cache = ref_zoo.decode_step(cfg, params, cache,
                                            prompt[:, t:t + 1],
                                            jnp.asarray(t, jnp.int32))
    gen, chosen_from = [], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for t in range(new_tokens):
        gen.append(int(tok[0, 0]))
        chosen_from.append(np.asarray(logits))
        logits, cache = ref_zoo.decode_step(cfg, params, cache, tok,
                                            jnp.asarray(p + t, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return gen, np.stack(chosen_from)


@pytest.fixture(scope="module")
def reference():
    """The reference example's flow at N_DOCS documents: its LM, corpus,
    index, fitted Darth, served requests and greedy tokens."""
    cfg = ref_configs.get_config("smollm-360m").scaled(
        **rag_serve.EXAMPLE_WIDTHS)
    params = ref_zoo.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def embed_texts(tokens):
        x, _, _ = ref_zoo.forward(cfg, params, {"tokens": tokens},
                                  remat=False)
        return np.asarray(x.mean(axis=1), np.float32)

    doc_tokens = jnp.asarray(
        rng.integers(0, cfg.vocab_size, (N_DOCS, rag_serve.DOC_LEN)),
        jnp.int32)
    corpus = np.concatenate([embed_texts(doc_tokens[i:i + 512])
                             for i in range(0, N_DOCS, 512)])
    index = ref_ivf.build(corpus, nlist=rag_serve.NLIST, seed=0)
    darth = ref_api.Darth(
        make_engine=lambda **kw: ref_engines.ivf_engine(index, **kw),
        engine=ref_engines.ivf_engine(index, k=rag_serve.K,
                                      nprobe=rag_serve.NLIST))
    learn_q = corpus[rng.choice(N_DOCS, rag_serve.LEARN, replace=False)] \
        + rng.normal(size=(rag_serve.LEARN, corpus.shape[1])
                     ).astype(np.float32) * 0.05
    darth.fit(jnp.asarray(learn_q), jnp.asarray(corpus))
    req_tokens = jnp.asarray(
        rng.integers(0, cfg.vocab_size, (N_REQ, rag_serve.DOC_LEN)),
        jnp.int32)
    req_emb = embed_texts(req_tokens)
    r_targets = np.where(np.arange(N_REQ) % 2 == 0, 0.8, 0.95
                         ).astype(np.float32)
    results, stats = RefServer(
        darth.engine, darth.trained.predictor, darth.interval_for_target,
        num_slots=rag_serve.SLOTS).serve(req_emb, r_targets)
    top_doc = int(results[0][1][0])
    prompt = jnp.concatenate([doc_tokens[top_doc][None, :8],
                              req_tokens[:1, :8]], axis=1)
    gen, logits = ref_greedy(cfg, params, prompt, rag_serve.NEW_TOKENS)
    return {"cfg": cfg, "params": params, "doc_tokens": doc_tokens,
            "corpus": corpus, "index": index, "darth": darth,
            "req_emb": req_emb, "r_targets": r_targets, "results": results,
            "stats": stats, "prompt": prompt, "gen": gen, "logits": logits}


@pytest.fixture(scope="module")
def port_lm(reference):
    """The example's LM config (equal to the reference's field by field)
    and the reference's weights carried across."""
    cfg = rag_serve.example_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(reference["cfg"])
    return cfg, convert.lm_params(jax.tree.map(np.asarray,
                                               reference["params"]),
                                  cfg, "cpu")


def test_embeddings_equal_reference(reference, port_lm):
    cfg, params = port_lm
    got = rag_serve.embed_texts(cfg, params, torch.as_tensor(
        np.asarray(reference["doc_tokens"])))
    assert got.dtype == np.float32 and got.shape == reference["corpus"].shape
    np.testing.assert_allclose(got, reference["corpus"], rtol=0,
                               atol=EMBED_ATOL)


def test_serve_equal_per_request_on_the_carried_index(reference):
    """The reference's index, predictor and request embeddings through the
    port's serve: the same ids for every request, and the same counters."""
    index = convert.ivf_index_from_numpy(
        convert.fields_as_numpy(reference["index"]), "cpu")
    trained = reference["darth"].trained
    darth = api.Darth(
        make_engine=None,
        engine=engines.ivf_engine(index, k=rag_serve.K,
                                  nprobe=rag_serve.NLIST),
        trained=convert.trained_from_numpy(
            ref_gbdt.to_state_dict(trained.predictor.params),
            trained.dists_rt, "cpu"))
    results, stats = rag_serve.serve(darth, reference["req_emb"],
                                     reference["r_targets"])
    assert len(results) == N_REQ
    for qid, ((d_p, i_p), (d_r, i_r)) in enumerate(zip(
            results, reference["results"])):
        np.testing.assert_array_equal(i_p, np.asarray(i_r), err_msg=qid)
        np.testing.assert_allclose(d_p, np.asarray(d_r), rtol=1e-5,
                                   atol=1e-5)
    for name in ("completed", "engine_steps", "slot_steps", "refills",
                 "ndis_harvested"):
        assert getattr(stats, name) == getattr(reference["stats"], name), \
            name


def test_main_meets_every_target(capsys):
    out = rag_serve.main(n_docs=N_DOCS, n_req=GATE_REQ, device="cpu")
    printed = capsys.readouterr().out
    for target, rec in out["recall"].items():
        assert rec >= target - TOL, (target, rec)
    assert out["stats"].completed == GATE_REQ
    assert out["corpus"].shape == (N_DOCS, 64)
    assert len(out["generated"]) == rag_serve.NEW_TOKENS
    assert "why did the worst request terminate?" in printed
    assert "RAG path: embed -> declarative-recall retrieve -> decode  OK" \
        in printed


def test_generation_equals_reference_where_the_margin_is_clear(reference,
                                                                port_lm):
    cfg, params = port_lm
    gen, logits = rag_serve.generate(
        cfg, params, torch.as_tensor(np.asarray(reference["prompt"])))
    ref_logits = reference["logits"]
    assert logits.shape == ref_logits.shape
    for step, (mine, theirs) in enumerate(zip(gen, reference["gen"])):
        np.testing.assert_allclose(logits[step].numpy(), ref_logits[step],
                                   rtol=0, atol=LOGIT_ATOL)
        top2 = np.sort(ref_logits[step][0])[-2:]
        if top2[1] - top2[0] <= LOGIT_ATOL:
            break                      # a near tie: the two may fork here
        assert mine == theirs, step
