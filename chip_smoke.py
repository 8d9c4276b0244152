#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # full size: N=1M, D=128, nlist=1024

Phases, each fatal on failure:

1. device:    the card's name and power limit; f32 matmuls in full f32;
              every kernel built from ``src/repro_torch/kernels/csrc`` (one
              nvcc per source, all at once).
2. main path: DARTH-on-IVF as a user runs it, on a SIFT1M-shaped synthetic
              collection: ``ivf.build`` -> ``Darth.fit`` -> ``search_plain``
              -> ``Darth.search`` at 0.80 / 0.90 / 0.95. The kernels' launch
              counts are zeroed just before and read just after; each kernel
              must have run. Each mean recall@10 (against exact ground truth)
              must reach its target - 0.03. Then one fit batch's step log
              is timed, and run again under torch.profiler for the
              device's busy time by kernel (its idle share). [repeat]:
              ``ivf.build`` a second time and the GBDT fit
              (``training.fit_predictor``) a second time on phase 2's own
              step log; centroids, store and trees must be bit-equal to
              the first (both times printed).
3. kernels:   each kernel against its plain PyTorch version on the main
              path's own tensors and shapes (f32, and int8 codes for both
              distance kernels), with times of the kernel, the plain version
              and, for l2_topk, one PyTorch call computing the same function.
              l2_topk is timed at its three shapes (the fit's ground truth,
              k-means assignment, int8 codes) and at the HNSW path's
              (its fit's ground truth over HNSW_N rows), each with the
              profiler's
              device time per kernel, and must be bit-equal to its plain
              version on SIFT-range integer data (0..255, D = 128).
              bucket_probe is also timed where the main path runs it: the
              first step of Darth.search (1000 queries) and a whole fit
              batch (256 queries through every probe rank), each beside
              its byte bound. gbdt_predict is timed on 256 logged rows,
              Darth.search's features after its first step (1000 rows)
              and the fit's hold-out (~200,000 rows): event, profiler
              device and host enqueue time per call, beside an empty
              kernel's time; two calls must be bit-equal.
4. hnsw path: DARTH-on-HNSW as a user runs it, on the first
              ``HNSW_N`` rows (750,000) of the same collection:
              ``hnsw.build`` (the reference's defaults: m 16,
              ef_construction 64, two passes, alpha 1.2) -> ``Darth.fit``
              (on the first 4,000 learn queries, 2,000 past 230 s of
              the script: a CUT line) ->
              ``search_plain`` -> ``Darth.search`` at 0.80 / 0.90 / 0.95,
              with ``hnsw_engine(k=10, ef=384, max_steps=1200)`` (the
              reference's benchmark setting). The counts are zeroed just
              before the build and read just after the last search;
              l2_topk (the fit's ground truth) and gbdt_predict (the
              predictor) must each have run, and each mean recall@10 must
              reach its target - 0.03. A line flagged ``FLAG`` says so
              when no query was ever due for a prediction (``npred`` 0 at
              every target), beside each target's interval. Then one fit
              batch's step log is timed and profiled, as in phase 2.
5. serve:     the DarthServer slot pool as the launcher serves
              (``SERVE_SLOTS`` 64 slots, ``SERVE_SPS`` 4 steps a chunk; the
              test queries, each with a target drawn from 0.80 / 0.90 /
              0.95 by ``default_rng(0)``), three runs at full width: IVF
              f32 (phase 2's index and Darth) with hosts 1 and 4, untraced
              and traced (a ``Tracer`` and a ``MetricsRegistry``), all equal
              per query and equal to ``darth_search`` with per-query
              intervals in batches of the pool's shape; IVF SQ8 with the f32
              re-rank (``quantize_ivf`` of phase 2's index, its own
              ``Darth.fit`` on the first 2,560 learn queries, served at
              k' = 40 through ``RerankStore.reranker(10)``, once,
              untraced: CUT lines);
              HNSW (phase 4's graph and Darth, traced). The counts are zeroed just before the first
              serve and read after the last (the SQ8 fit included); each
              kernel must have run. Every run completes all queries; each
              mean recall@10 per target must reach target - 0.03 (HNSW:
              min(target, plain recall) - 0.03); every traced query has
              exactly one terminal span and the metrics' completed count
              equals the server's. A ``[serve] FLAG`` line says so when no
              served HNSW query was due for a prediction.
6. mutate:    the streaming mutable index as the launcher runs it
              (``--mutations 0.2,0.1 --drift 0.3``: ``mutation_stream``
              with 200,000 inserts and 100,000 deletes at full size, a
              delta ring of 200,064 rows), on phase 2's index and Darth:
              empty-delta parity (``mutable_engine`` equals
              ``Darth.search`` per query), the burst served through the
              DarthServer as in phase 5 (recall@10 against
              ``live_ground_truth`` >= target - 0.03, no deleted id,
              inserted vectors found at rank 0), the drift check and a
              forced refit (``RecalibrationMonitor.recalibrate`` on 2,560
              learn queries, hot-swapped), a synchronous ``compact()``
              (then the wrapper equals ``ivf_engine`` over the compacted
              base per query), and the online path on a fresh
              ``MutableIndex`` (one event per chunk boundary, background
              compaction ticks, a drained swap: ``swaps == 1``). Then
              phase 4's graph with a 1 % / 0.5 % burst: ``Darth.search``
              (recall >= min(target, plain recall) - 0.03), ``compact()``
              (``insert_nodes`` timed) and post-compaction parity. The
              counts are zeroed at its start and read after its last
              search; each kernel must have run. The cuts are printed as
              ``[mutate] CUT`` lines. ``l2_topk`` is then held against its
              plain version and timed at the delta scan's shapes (64 and
              1000 queries against the ring captured halfway through the
              online stream).
7. competitors: the paper's Fig 10 / Fig 11 / §4.1.5 setup
              (``benchmarks/paper_tables.py:160-205,336-364``) on phase
              2's index and Darth: validation queries ``learn[:512]``, the
              LAET / Baseline step log on ``learn[512:1536]``, ground truth
              at k = 10 and at K' = 100 (NRS) through l2_topk. DARTH,
              Baseline (``budget_search`` at the mean ``dists_to_target``),
              REM (nprobe grid 4..192, then ``plain_search`` at the mapped
              nprobe) and LAET (n0 2, ``tune_laet`` with 6 steps) at each
              target: ``metrics.summarize`` (recall, RQUT, RDE, NRS, P99,
              worst 1 %), mean ndis and host q/s; the noise sweep at 0.90
              (``noisy_queries`` at 0 / 1 / 4 / 10 / 20 %, seed 7) beside
              the plain ceiling; model selection on phase 2's fit log
              (200,000 rows, 10 % hold-out: GBDT, random forest, decision
              tree, linear; MSE and R^2). Fatal: 1000 results per method,
              DARTH equal per query to phase 2's ``Darth.search``, REM's
              mapping not falling with the target, l2_topk at k = 100
              against its plain version, every kernel launched. A
              competitor missing a target is printed, not fatal.
8. cold:      the cold bucket tier on phase 2's index and Darth, served
              as phase 5 serves: 1024 resident slots in ``plan`` order
              must give phase 5's IVF f32 ids and ndis per query; on the
              256 most populated buckets ``plain_search`` at nprobe =
              nlist must return the top-10 of the resident rows and count
              exactly them; then 256 resident buckets (lookahead 4,
              staging 8) in three modes (static, ``plan``, ``plan`` with
              ``on_boundary``) on all test queries and on the drifted
              slice (rank-1 bucket outside the 256 most populated), each
              with recall per target, ndis, prefetches, evictions,
              misses, staging ms per boundary, wall and resident bytes.
              Fatal: every query completes and the tier's counters equal
              the ``darth_cold_*`` metrics. A ``[cold] FLAG`` line (not
              fatal) says when plan + prefetch recalls less than static.
              With ``--cold-repeat`` phase 8 runs twice and prints whether
              its serves repeat (not fatal). [cold-shard]: the plan +
              prefetch serve again, traced, on one device (its counters
              equal to the row above), then with the tier's store placed
              at 2 and 4 shards on cuda:0 and on the 2 x 2 serve mesh, the
              tier staging into every shard: 0 queries may differ in ids,
              ndis, npred or terminal reason, and the prefetch, eviction
              and miss counts must be equal; staging ms per boundary
              (mean, max) beside phase 8's. Past COLD_SHARD_CUT_AT s of the
              script only 2 shards run (a CUT line). Then bucket_probe on
              shard 0 of the 4-shard staged store against its plain
              version.
9. sharded:   the sharded IVF path on phase 2's index and Darth at 1, 2,
              4 and 7 shards, all on cuda:0 (7 divides neither the cap
              nor N, so both pad): ``dist.place_index`` (seconds, bytes
              per shard, each placement freed before the next), the
              sharded flat search at the fit shape (learn x N), equal to
              ``flat.search`` in ids and distances; ``ivf.search_sharded``
              on the test queries, equal to ``ivf.search`` in ids,
              distances, ndis, ninserts and probe_pos; ``Darth.search``
              through ``sharded_ivf_engine`` with phase 2's predictor at
              each target, every decision equal to phase 2's; at 4 shards
              the DarthServer over the mesh as phase 5 serves, equal per
              query to phase 5's hosts-1 IVF f32 run; at 2 shards
              ``Darth.fit(mesh=)`` on 512 learn queries, its step log and
              trees equal to an unsharded fit's (its ground-truth seconds
              beside phase 2's). HNSW: phase 4's graph placed
              at the same counts (750,000 rows pad to 750,001 at 7),
              ``hnsw.search_sharded`` on the first 256 test queries
              (128 past 700 s of the script; a cut, printed) equal to
              ``hnsw.search``, exact and with a 2^18-wide hashed filter
              (7 shards must raise); at 2 shards
              ``Darth.search`` through ``sharded_hnsw_engine`` equal to
              phase 4's Darth and ``Darth.fit(mesh=)`` equal to an
              unsharded fit. A mutable view: a new ``MutableIndex``
              over phase 2's index with a 1 % / 0.5 % burst, placed at 2
              and 7 shards, ``Darth.search`` through
              ``mutable_engine(sharded_ivf_engine)`` equal to the
              unsharded mutable engine with 0 deleted ids, before and
              after ``compact()`` + ``refresh_placed_view``. The hosts
              axis: ``DarthServer`` on ``make_serve_mesh(2, 2)`` with
              hosts 2, phase 5's IVF f32 stream (64 and 128 slots) equal
              to phase 5's hosts-1 run, and the 256 HNSW queries equal
              to a single-device serve. The counts are zeroed after the
              IVF single-device references and read after the last
              check, less the single-device references run between;
              each kernel must have run. Then l2_topk and bucket_probe
              on shard 0's slice at 2, 4 and 7 shards, and l2_topk on
              shard 0 of the sharded HNSW fit's ground truth, against
              their plain versions and timed beside their bounds.
10. quickstart: ``repro_torch.examples.quickstart.main()`` at its own
              size (30,000 x 32, nlist 128), which prints its table; each
              target's recall must reach target - 0.03 and every kernel
              must have run.
11. audit:    the port's static gate (``repro_torch.analysis``) on the
              card: ``run_gate("cuda")`` with zero findings (every
              kernel must have run in it), the known-bad corpus detected,
              and the serving loop's host syncs on the card (by the
              recorder and by ``torch.cuda.set_sync_debug_mode``) equal to
              the CPU's per call site and in total, with no nvcc after the
              first chunk; then each kernel at the gate's shapes against
              its plain version.
12. lm:       the LM serving path (``repro_torch.models``). [lm]:
              smollm-360m at its registered width from ``init_params``
              on the card: a prefill of 8 x 2048 seeded tokens (wall,
              tokens/s), a 64-token prompt through ``decode_step`` then
              64 greedy tokens at S_max 128 (ms a token), the decode's
              logits at position 63 within the reference's own bound of
              the prefill's (atol 0.15, rtol 0.05, top-1 equal), and the
              card against the CPU path on the same weights (2 x 32;
              the same bound, top-1 equal). [lm-moe]: qwen3-moe-30b-a3b at full width, 4 of 48 layers
              (a CUT line; 2 past 900 s of the script): prefill 4 x 512
              (drop fraction, aux loss), 16 decode tokens, the card
              against the CPU path at 1 layer. [rag]:
              ``repro_torch.examples.rag_serve.main`` with the LM at
              smollm-360m's width and the example's own sizes (8,000
              documents, nlist 64, 64 requests at 0.80 / 0.95, k 5); the
              counts are zeroed just before and read just after, every
              kernel must have run, and each target's recall must reach
              target - 0.03 against ground truth from the plain version;
              then each kernel at the path's shapes (D = 960) against its
              plain version.
13. lm families: the recurrent and encoder-decoder LM families
              (``repro_torch.models.linear_attn``, the RWKV / zamba /
              whisper stacks) at their registered widths and depths from
              ``init_params`` on the card. [lm-ssm] rwkv6-3b and
              [lm-hybrid] zamba2-1.2b: a prefill of 8 x 2048 seeded tokens
              (wall, tokens/s, finite logits; the largest |logp| of any
              chunk read in an untimed prefill of its own), a 64-token
              prompt through ``decode_step`` then 32 greedy tokens at
              S_max 128 (ms a token, the cache's dtypes after the first
              step), and the decode's logits at position 63 against the
              prefill's (a FLAG line outside the reference's bound, which
              the reference's own decode misses at these depths). Gated
              at full width and a reduced depth (rwkv6 2 layers, zamba2
              7: one group and a tail of 1): the same decode-vs-prefill
              check (the reference's bound, atol 0.15, rtol 0.05, top-1
              equal), the card against the CPU path on the same weights
              (B 1 x S 64) with the model computing in f32 (logits within
              FAM_F32_BOUND, its TF32 control outside it; as shipped,
              bf16, printed beside its TF32 control), and the chunked
              linear attention alone
              on the card against the CPU at one layer's shapes (B 1 x
              2048; within 1e-4 of its largest value, its TF32 control
              printed beside it, a FLAG line if that is within too).
              Past 1000 s of the script they run 8 of 32 and 13 of 38
              layers (CUT lines).
              [lm-audio] whisper-base: ``encode_audio`` on 8 x 1500
              seeded frames, the cross cache filled from the encoder,
              ``prefill`` on the frames and 448 decoder tokens, the
              decode at position 0 against a 1-token prefill (the
              reference's bound, top-1 equal), 32 greedy decode tokens at
              S_max 448, and the card against the CPU path at full depth
              (B 1, 1500 frames, S 32) as for the recurrent models. The
              kernels' counts are zeroed before the phase and read after
              (no kernel of the repo runs on these paths).
14. lm train: LM training (``repro_torch.launch.train``, ``train``,
              ``optim``, ``ckpt``; no kernel of the repo runs on it), the
              counts zeroed before and read after. (a) ``launch.train.
              main`` with smollm-360m at its registered width and depth
              (32 layers, d_model 960, vocab 49152), AdamW, remat on,
              global batch 8 x 2048 of the token stream, 4 steps (2 past
              1050 s of the script: a CUT line) and one checkpoint at the
              end: each step's wall, loss and grad norm (all finite), the
              steady tokens/s, peak bytes, the checkpoint's seconds and
              bytes, and the checkpoint restored equal to the saved trees
              bit for bit. (b) at the same width and 2 layers, B 2 x S
              128: every gradient leaf on the card against the port's CPU
              path (relative to the leaf's largest value), as shipped
              (bf16) and with the model computing in f32, and
              ``flash_attention``'s backward alone, each within its
              limit beside a TF32 control; half the batch and the f32
              run's TF32 control must fail their gates. (c) the
              example's config (4 layers, d_model 256, vocab 4096, B 8 x
              S 128): 8 steps straight against a failure at step 6 and a
              resume from step 4's checkpoint; the losses and the final
              parameters and optimizer state equal bit for bit.
15. mesh:     the LM's multi-device tooling (``launch.mesh``,
              ``utils.meshctx``, ``dist.sharding``, ``ckpt``'s placement
              record, ``launch.dryrun``; no kernel of the repo runs on
              it), the counts zeroed before and read after, each part
              after the one before. (a) the launcher's mesh path
              (``launch.train.world_of_one``, ``launch_mesh``:
              the host mesh, (1, 1) in a world of one NCCL rank;
              ``train.loop.train(mesh=)``) at 14 (c)'s config and
              schedule: its losses,
              parameters and optimizer state equal 14 (c)'s uninterrupted
              run bit for bit. (b) 14 (a)'s checkpoint restored through
              ``restore(shardings=<the host mesh>)``: every leaf a DTensor
              on the mesh, bit-equal to the saved file (past 1050 s of
              the script the parameters alone: a CUT line). (c) ``python -m
              repro_torch.launch.dryrun --arch smollm-360m --shape
              train_4k`` in a child process: a fake world of 256 ranks,
              the 16 x 16 production mesh, the whole train step traced
              at full width (32 layers, batch 256 x 4096) under
              FakeTensorMode; its record is printed, and its status must
              be "ok" and its argument bytes what the placements imply.

Bounds. A kernel's ``bound_ms`` is the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its operations
over the card's peak for their type. l2_topk owes its 2*B*N*D flops to
f32 accuracy, so its operations are counted as three TF32 passes at 495
TFLOP/s for f32 codes, and three bf16 passes at 989 TFLOP/s for bf16 or
int8 codes (exact in bf16; an f32 query split in three bf16 parts carries
f32's 24 bits). Beside it, ``f32_core_bound_ms`` counts the same flops
once at 67 TFLOP/s (f32 on the CUDA cores), the figure earlier runs used.
gbdt_predict's ``bound_ms`` counts its bytes (the ensemble once, B x 11
x 4 in, B x 4 out) and operations (B x T x (depth + 1) at 67 TFLOP/s);
both lie far below what limits it. Beside them, ``lookup_figure_ms`` = B x T x (2 depth + 1) / (32 x 132 x
1.98e9) s: every node record, feature and leaf served from shared memory
at 32 lookups per clock on each of 132 SMs at the 1,980 MHz boost clock,
the figure to read device time against at large B; at small B it is the
empty kernel's time (``launch_floor_ms`` by events, and
``launch_floor_device_ms`` by the profiler).

It imports nothing of JAX or of the ``repro`` package. Output: JSON lines
of each path's results and of per-kernel results (``launches`` summed
over the paths, ``launches_by_path`` split: ivf, hnsw, serve, mutate,
competitors, cold, cold_shard, sharded, quickstart, audit, rag,
lm_families, train, mesh), each
phase's wall time, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Full
results also go to ``results/chip_smoke.json``. Without a CUDA card, or
without the repository around it, it exits non-zero and prints no result.
"""
import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12        # H100 SXM dense TF32 tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
# Shared-memory lookups: 32 per clock per SM, 132 SMs, 1,980 MHz boost
# (H100 SXM data sheet).
SMEM_LOOKUPS_PER_S = 32 * 132 * 1.98e9
PROFILER_PAD = 512              # spin kernels that open a profiled session
TARGETS = (0.80, 0.90, 0.95)
TOL = 0.03
# Rows of the collection the HNSW phase indexes. At ef 384 the graph's
# plain recall@10 on this collection falls with N: 0.9631 at 500,000,
# 0.9253 at 750,000 and 0.8938 at 1M (NVIDIA H100, tools/hnsw_recall_sweep.py;
# PERF.md section 4), so 1M fails the 0.95 target's gate of 0.92 and
# 750,000 is the largest of these that meets it.
HNSW_N = 750_000
# The HNSW Darth.fit runs on the first HNSW_FIT_LEARN of the 10,000 learn
# queries (a CUT line): all of them took 133.9 s on an NVIDIA H100
# (PERF.md section 5); the time pays for phase 14. Past HNSW_SLOW_AT s of
# the script when phase 4 begins (a slow host: phases 1-3 end near 180 s
# on a normal one) it runs on HNSW_FIT_LEARN_SLOW (2,000 saved 23 s of
# the fit on the H100). On this cell no query has been due for a
# prediction (npred 0: the routing scan's R = 8192 comes first), and
# while npred stays 0 the searches return the plain search's results,
# whatever the fit's size.
HNSW_FIT_LEARN, HNSW_FIT_LEARN_SLOW, HNSW_SLOW_AT = 4_000, 2_000, 230.0


def hnsw_fit_cut(n_learn):
    return (f"the HNSW Darth.fit uses the first {n_learn:,} of the 10,000 "
            f"learn queries (all 10,000 took 133.9 s; the time pays for "
            f"phase 14, LM training)")
# The launcher's serving settings (src/repro/launch/serve.py:80 and the
# server's defaults): slots in the pool, engine steps between syncs.
SERVE_SLOTS, SERVE_SPS = 64, 4
# The launcher's mutation workload (src/repro/launch/serve.py:93-114,
# 412-418: --mutations 0.2,0.1 --drift 0.3, four steps, seed 1) on the
# IVF cell, and the HNSW cell's cut burst.
MUTATE_INS, MUTATE_DEL, MUTATE_DRIFT = 0.2, 0.1, 0.3
HNSW_MUTATE_INS, HNSW_MUTATE_DEL = 0.01, 0.005
MUTATE_REFIT_LEARN = 2560
# The paper's competitor setup (benchmarks/paper_tables.py:160-205, Fig 10
# and Fig 11): REM's nprobe grid, LAET's fixed prefix and multiplier
# search depth, the hardness sweep's noise levels (sigma^2 = pct * ||q||)
# and its target; the evaluation's wide ground truth K' (benchmarks/
# common.py:56) for NRS.
REM_GRID = (4, 8, 16, 32, 64, 96, 128, 192)
LAET_N0, LAET_STEPS = 2, 6
NOISE_PCTS, NOISE_TARGET = (0.0, 1.0, 4.0, 10.0, 20.0), 0.90
WIDE_K = 100
METHODS = ("darth", "baseline", "rem", "laet")
# The cold tier as an operator runs it when the bucket store does not fit
# the card: 256 of the 1024 buckets resident, a staging ring of 8 slots,
# lookahead 4 (src/repro/serve/cold.py defaults), plan over the first 4
# probes.
COLD_SLOTS, COLD_LOOKAHEAD, COLD_STAGING, COLD_FIRST = 256, 4, 8, 4
# The sharded path: shard counts, all on cuda:0 (7 divides neither the
# cap of 5832 = 2^3 * 3^6 nor N, so both pad); the learn queries of the
# Darth.fit(mesh=) check (a whole fit's step log would repeat phase 2's).
SHARD_COUNTS = (1, 2, 4, 7)
SHARD_FIT_LEARN = 512
# Phase 9's HNSW checks run on phase 4's graph over its first
# SHARD_HNSW_Q test queries (a cut for the script's time), over
# SHARD_HNSW_Q_SLOW past SHARD_SLOW_AT s of the script when they begin,
# after phase 9's IVF checks (a slow host: 625-670 s on the H100's
# hosts measured; 128 saved ~14 s); the hashed filter is 2^18 wide (a
# power of two that 1, 2 and 4 shards divide and 7 does not); the
# mutable view is placed at 2 and 7 shards; the hosts mesh is 2 x 2.
SHARD_HNSW_Q, SHARD_HNSW_Q_SLOW, SHARD_SLOW_AT = 256, 128, 700.0
SHARD_HASH_W = 1 << 18
SHARD_HASH_COUNTS = (1, 2, 4)
SHARD_MUT_COUNTS = (2, 7)
# Phase 8's [cold-shard] check: the plan + prefetch serve at these shard
# counts on cuda:0 and on the 2 x 2 serve mesh; past COLD_SHARD_CUT_AT
# seconds of the script it runs at 2 shards only (a CUT line says so).
COLD_SHARD_COUNTS = (2, 4)
COLD_SHARD_CUT_AT = 800.0
# Phase 12, the LM serving path: smollm-360m and qwen3-moe-30b-a3b at
# their registered widths. [lm]: prefill (batch, sequence); decode (prompt
# tokens, greedy tokens, S_max); the card against the CPU path (batch,
# sequence). The decode must agree with the prefill, and the card's logits
# with the CPU's, within the reference's own bound between two float paths
# of one model (tests/test_models.py::test_prefill_decode_consistency);
# the errors print beside the CPU tests' tolerances at 2 layers
# (tests/test_torch_models.py). [lm-moe]: the depth is cut to MOE_LAYERS of
# 48 (MOE_LAYERS_CUT past MOE_CUT_AT s of the script); prefill (batch,
# sequence), decode tokens, and the card against the CPU path at 1 layer
# (batch, sequence) within tests/test_torch_moe.py's tolerances (logits
# 0.05; at most MOE_FLIPPED_ROWS token rows of hidden state beyond 2^-4).
LM_ARCH, MOE_ARCH = "smollm-360m", "qwen3-moe-30b-a3b"
LM_PREFILL, LM_DECODE, LM_VS_CPU = (8, 2048), (64, 64, 128), (2, 32)
LM_CONSISTENCY = {"atol": 0.15, "rtol": 0.05}
LM_HIDDEN_ATOL, LM_LOGIT_ATOL, MOE_LOGIT_ATOL = 2.0 ** -4, 0.01, 0.05
MOE_FLIPPED_ROWS = 2
MOE_LAYERS, MOE_LAYERS_CUT, MOE_CUT_AT = 4, 2, 900.0
MOE_PREFILL, MOE_DECODE, MOE_VS_CPU = (4, 512), 16, (1, 16)
# [rag]: the example serves 64 requests, 32 a target, whose mean recall@5
# has a standard error near 0.04 (per-request recall moves in steps of
# 0.2), above the 0.03 tolerance: one draw can miss by chance. So the
# recall gate runs on RAG_GATE_REQUESTS requests of the same path (the
# first 64 of them are the example's own, and must be served alike); the
# example's own run prints its recall and standard error, and a FLAG line
# where it falls below target - TOL.
RAG_GATE_REQUESTS = 1024
# Phase 13, the remaining LM families at their registered widths and
# depths: prefill (batch, sequence; 2048 is a multiple of the linear
# attention's chunk of 64), decode (prompt tokens, greedy tokens, S_max);
# past FAM_CUT_AT s of the script the recurrent stacks run FAM_CUT_LAYERS
# (rwkv6: 8 of 32; zamba2: two groups of 6 and a tail of 1). At 32-38
# layers the reference's OWN decode misses its bound of its prefill on
# the CPU (rwkv6 by the error, zamba2 by top-1;
# tests/test_torch_models.py::test_*_gap_at_depth_is_the_references), so
# there the decode-vs-prefill check prints (a FLAG line outside the
# bound), and the gates run at full width and FAM_GATE_LAYERS: the
# decode against prefill (the reference's bound, top-1 equal), the card
# against the CPU path (batch, sequence) with the model computing in f32,
# logits within FAM_F32_BOUND, its TF32 control (TF32 matmuls allowed: a
# card path of lower precision) outside it, and the chunked linear
# attention alone within FAM_LA_REL of its largest value (sound ~1e-6,
# the TF32 control ~5e-4). As shipped (bf16) the card-vs-CPU logits are
# printed beside their TF32 control, not gated: bf16 rounding sets that
# gap, and over seeded draws the sound reading and the control overlap
# (zamba2 at 7 layers; tools/lm_gate_seeds.py, PERF.md section 7).
# Whisper: B AUDIO_BATCH x the
# registered 1500 frames, its published decoder context of 448 tokens
# for the prefill and the decode's S_max, AUDIO_DECODE greedy tokens, its
# decode at position 0 within the reference's bound of a 1-token prefill,
# and the card within FAM_VS_CPU_BOUND of the CPU at full depth on
# AUDIO_VS_CPU (batch, decoder tokens).
SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH = "rwkv6-3b", "zamba2-1.2b", "whisper-base"
FAM_PREFILL, FAM_DECODE = (8, 2048), (64, 32, 128)
FAM_VS_CPU = (1, 64)
FAM_GATE_LAYERS = {SSM_ARCH: 2, HYBRID_ARCH: 7}
FAM_CUT_LAYERS = {SSM_ARCH: 8, HYBRID_ARCH: 13}
FAM_CUT_AT = 1000.0
FAM_VS_CPU_BOUND = {"atol": 0.052, "rtol": 0.0}
# Over 8 seeded draws at the gate depths on an NVIDIA H100 (700 W;
# tools/lm_gate_seeds.py), computing in f32 the card-vs-CPU logits read
# 8.8e-6 to 2.35e-5 and their TF32 control 5.07e-3 to 6.85e-3 (logits
# up to 5.1): FAM_F32_BOUND lies 12x above the one and 17x below the
# other. As shipped (bf16) they read 0.034-0.055 and their controls
# 0.042-0.061, overlapping.
FAM_F32_BOUND = {"atol": 3e-4, "rtol": 0.0}
FAM_LA_REL = 1e-4
AUDIO_BATCH, AUDIO_TOKENS, AUDIO_DECODE = 8, 448, 32
AUDIO_VS_CPU = (1, 32)
# Phase 14, LM training through the launcher (repro_torch.launch.train)
# at smollm-360m's registered width and depth: AdamW, remat on, global
# batch TRAIN_BATCH x TRAIN_SEQ, TRAIN_STEPS steps and one checkpoint at
# the end (TRAIN_STEPS_CUT steps past TRAIN_CUT_AT s of the script: a CUT
# line). The card's gradients against the port's CPU path at the same
# width and TRAIN_VS_CPU_LAYERS layers on TRAIN_VS_CPU (batch, sequence)
# of the token stream: each leaf's largest error relative to its largest
# value, within TRAIN_GRAD_REL as shipped and TRAIN_F32_GRAD_REL with the
# model computing in f32, and flash_attention's backward alone at that
# shape within TRAIN_FLASH_REL, each beside a TF32 control. The
# restart: the example's config (4 layers, d_model 256, vocab 4096, B 8 x
# S 128), TRAIN_RESTART_STEPS straight against a failure at step
# TRAIN_FAIL_AT and a resume from the checkpoint of TRAIN_CKPT_EVERY:
# losses and final parameters equal bit for bit.
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 4
TRAIN_STEPS_CUT, TRAIN_CUT_AT = 2, 1050.0
TRAIN_VS_CPU_LAYERS, TRAIN_VS_CPU = 2, (2, 128)
# On an NVIDIA H100 (700 W), as shipped (bf16) the worst leaf (wq) reads
# 0.0134 and its TF32 control 0.0110: bf16 rounding sets the gap, so
# TRAIN_GRAD_REL (2.2x above the sound reading; the CPU's reference lies
# 0.0129 from its jitted run at the small config, test_torch_grads.py)
# sees no precision fault, only a wrong gradient: half the batch left out
# reads 1.20. The same model computing in f32 reads 3.3e-6 sound and
# 1.9e-3 with TF32: TRAIN_F32_GRAD_REL lies 15x above the one and 38x
# below the other. flash_attention's backward alone: 5.4e-7 sound, at
# least 2.9e-4 with TF32, and TRAIN_FLASH_REL lies 18x above the one and
# 29x below the other.
TRAIN_GRAD_REL = 0.03
TRAIN_F32_GRAD_REL = 5e-5
TRAIN_FLASH_REL = 1e-5
TRAIN_RESTART_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 8, 6, 4
# Phase 15, the LM's multi-device tooling: the dry run of MESH_DRYRUN
# (smollm-360m's train_4k at full width) on a fake 16 x 16 world, in a
# child process given MESH_DRYRUN_TIMEOUT seconds.
MESH_DRYRUN = ("smollm-360m", "train_4k")
MESH_DRYRUN_TIMEOUT = 600
# Past MESH_CUT_AT s of the script, 15 (b) restores 14 (a)'s parameters
# alone, not its AdamW state (two thirds of the 4.34 GB): a CUT line.
MESH_CUT_AT = 1050.0
# Phase 15 is paid for by phase 5's SQ8 path (NVIDIA H100, PERF.md
# section 5): its Darth.fit runs on the first SQ8_FIT_LEARN learn
# queries (all 10,000 took 90.1 s), and its stream is served once,
# untraced (the traced second run took 16.5-22.1 s). Tracing stays held
# to the untraced serve on the IVF f32 runs at hosts 1 and 4.
SQ8_FIT_LEARN = 2560
SQ8_CUTS = (
    f"the IVF SQ8 Darth.fit uses the first {SQ8_FIT_LEARN:,} of the 10,000 "
    f"learn queries (all 10,000 took 90.1 s; the time pays for phase 15)",
    "the IVF SQ8 + re-rank stream is served once, untraced (its traced "
    "second run, 16.5-22.1 s, pays for phase 15); tracing stays held to "
    "the untraced serve on the IVF f32 runs at hosts 1 and 4")
def shard_cuts(nq):
    return (f"the sharded HNSW checks use the first {nq} of the 1,000 test "
            f"queries (each runs the 750,000-row graph at ef 384 to natural "
            f"termination, at four shard counts, exact and hashed)",
            "the hosts-mesh HNSW serve uses those queries and their phase 5 "
            "targets, against a single-device serve of the same queries")
MUTATE_CUTS = (
    "the IVF refit uses the first 2,560 learn queries, not 10,000 (the "
    "full refit would repeat phase 2's ~53 s step log)",
    "the IVF refit is forced whatever the drift verdict (the launcher "
    "refits only on drift), so Darth.fit(ids=) and the hot swap run",
    "the HNSW burst is 1 % inserts / 0.5 % deletes of the 750,000-row "
    "graph, not 20 % / 10 % (linking 150,000 nodes at a host-bound "
    "~2-3 ms a beam step would take minutes)")


T_START = time.time()


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events, after
    one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, keep_spin=False):
    """(wall s, {kernel: device ms}, {kernel: launches}) of one fn() under
    torch.profiler, the wall time taken in the same run, the device time
    and launch count as recorded. The dicts are empty where the profiler
    recorded no device time.

    A session loses its first few device records once the process has run
    earlier sessions (none in a fresh process; up to every launch of a
    short session after the main path), so each session opens with
    PROFILER_PAD empty spin kernels, left out of the result (kept with
    keep_spin, for the time of an empty kernel), before fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by, counts = {}, {}
    for e in prof.key_averages():  # the device's own events only
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if ("CUDA" in str(e.device_type) and us > 0
                and (keep_spin or "spin_kernel" not in e.key)):
            by[e.key] = us / 1e3
            counts[e.key] = e.count
    return wall, by, counts


def kernels_ms(by, counts, word, per_call=1):
    """Device ms per call of each kernel whose name holds ``word``, by
    short name (probe_tile_kernel and probe_merge_kernel for "probe",
    l2_topk_kernel and l2_merge_kernel for "l2_"): its mean time over the
    launches the profiler recorded, times its launches per call, so that a
    launch the profiler missed (see profiled) does not read as time saved."""
    out = {}
    for key, ms in by.items():
        m = re.search(rf"(\w*{word}\w*_kernel)", key)
        if m:
            out[m.group(1)] = (out.get(m.group(1), 0.0)
                               + ms / counts[key] * per_call)
    return out


def topk_agreement(d_k, i_k, d_r, i_r, tol):
    """(max |d_k - d_r|, share of equal ids, ok). Ids may differ only
    where the distances at that rank lie within tol."""
    import torch
    err = (d_k - d_r).abs()
    finite = torch.isfinite(d_r)
    same_inf = ~finite & torch.isinf(d_k)
    max_err = float(err[finite].max()) if finite.any() else 0.0
    dist_ok = bool(((err <= tol) & finite | same_inf).all())
    diff = i_k != i_r
    ids_ok = bool((err[diff] <= tol).all()) if diff.any() else True
    return max_err, float((~diff).float().mean()), dist_ok and ids_ok


def step_log_trace(engine, ql, gt_l):
    """One fit batch's step log (``ql`` queries x the engine's max_steps,
    as Darth.fit runs it): wall without the profiler, then wall and device
    time by kernel of one run under it, whose ratio is the device's idle
    share (the profiler's own cost included). Returns (trace, device ms by
    kernel), or (None, {}) if the profiler recorded no device time."""
    import torch
    from repro_torch.core import training
    torch.cuda.synchronize()
    t0 = time.time()
    training.generate_observations(engine, ql, gt_l)
    torch.cuda.synchronize()
    trace = {"wall_s": time.time() - t0}
    pwall, by, _ = profiled(lambda: training.generate_observations(
        engine, ql, gt_l))
    if not by:
        return None, by
    busy = sum(by.values()) / 1e3
    trace.update({
        "profiled_wall_s": pwall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / pwall,
        "top_kernels_ms": dict(sorted(by.items(), key=lambda kv: -kv[1])
                               [:6])})
    return trace, by


def hnsw_path(base, learn, q):
    """Phase 4: DARTH-on-HNSW through the port's entry points over
    ``base``. Returns (results, launches by kernel on this path,
    failures, and the fitted Darth with its exact ground truth and plain
    recall for phase 5)."""
    import torch
    from repro_torch.core import api, engines
    from repro_torch.index import flat, hnsw
    from repro_torch.kernels import cuda
    out = {}
    nq = q.shape[0]
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.time()
    split = {}
    # 8192 rows a batch: the build's [chunk, N] visited bitmap takes 6 GB
    # at N = 750,000 (the graph does not depend on the chunk).
    index = hnsw.build(base, m=16, ef_construction=64, passes=2,
                       alpha=1.2, seed=0, chunk=8192, device="cuda",
                       seconds=split)
    torch.cuda.synchronize()
    out["build_s"] = time.time() - t0
    out["build_split_s"] = split
    deg = (index.neighbors >= 0).sum(1).float()
    out["degree_mean"] = float(deg.mean())
    print(f"[hnsw] hnsw.build n={index.num_vectors} m={index.degree} "
          f"R={index.route_ids.shape[0]} mean degree {out['degree_mean']:.2f}"
          f" ({out['build_s']:.1f}s) split "
          + " ".join(f"{k}={v:.1f}s" for k, v in split.items()), flush=True)
    darth = api.Darth(
        make_engine=lambda **kw: engines.hnsw_engine(index, **kw),
        engine=engines.hnsw_engine(index, k=10, ef=384, max_steps=1200))
    t0 = time.time()
    trained = darth.fit(learn, base)
    out["fit_s"] = time.time() - t0
    out["fit_split_s"] = dict(darth.fit_seconds)
    out["predictor"] = dict(trained.metrics, samples=trained.num_samples)
    print(f"[hnsw] Darth.fit learn={learn.shape[0]} {out['fit_s']:.1f}s split "
          + " ".join(f"{k}={v:.1f}s" for k, v in darth.fit_seconds.items())
          + f" mse={trained.metrics['mse']:.5f}", flush=True)
    torch.cuda.synchronize()
    t0 = time.time()
    _, plain_i, plain = darth.search_plain(q)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    results = {}
    for rt in TARGETS:
        t0 = time.time()
        _, ids, st = darth.search(q, rt)
        torch.cuda.synchronize()
        results[rt] = (ids, st, time.time() - t0)
    launches = dict(cuda.LAUNCHES)
    print(f"[hnsw] launches {launches}", flush=True)

    _, gt = flat.search(q, index.vectors, 10)
    plain_ndis = float(plain.ndis.float().mean())
    nroute = index.route_ids.shape[0]
    out["plain"] = {
        "recall": float(flat.recall_at_k(plain_i, gt).mean()),
        "ndis": plain_ndis, "qps": nq / plain_s,
        "steps": int(plain.nstep.max()), "route_ndis": nroute}
    print(f"[hnsw] plain  recall={out['plain']['recall']:.4f} "
          f"ndis={plain_ndis:.0f} (R={nroute}) qps={out['plain']['qps']:.0f} "
          f"steps={out['plain']['steps']}", flush=True)
    fitted = {"darth": darth, "gt": gt, "plain_recall": out["plain"]["recall"]}
    failures = []
    out["targets"] = {}
    for rt, (ids, st, secs) in results.items():
        rec = float(flat.recall_at_k(ids, gt).mean())
        nd = float(st.inner.ndis.float().mean())
        params = darth.interval_params(rt)
        row = {"recall": rec, "ndis": nd, "speedup_ndis": plain_ndis / nd,
               "qps": nq / secs, "npred": float(st.npred.float().mean()),
               "steps": st.steps, "ipi": float(params.ipi),
               "mpi": float(params.mpi)}
        out["targets"][str(rt)] = row
        print(f"[hnsw] target {rt:.2f} recall={rec:.4f} ndis={nd:.0f} "
              f"speedup={row['speedup_ndis']:.2f}x qps={row['qps']:.0f} "
              f"npred={row['npred']:.2f} steps={st.steps} "
              f"ipi={row['ipi']:.0f} mpi={row['mpi']:.0f}", flush=True)
        if rec < rt - TOL:
            failures.append(f"hnsw recall {rec:.4f} below target {rt} - "
                            f"{TOL}")
    if all(r["npred"] == 0 for r in out["targets"].values()):
        # Not fatal: the search still meets every target as plain search
        # does, but no DARTH-on-HNSW decision was made on the card.
        out["flag"] = (
            f"npred is 0 at every target: no query was due for a "
            f"prediction; a plain search adds {plain_ndis - nroute:.0f} "
            f"distances after the routing scan's R = {nroute}, and the "
            f"smallest first interval is "
            f"{min(r['ipi'] for r in out['targets'].values()):.0f}")
        print(f"[hnsw] FLAG: {out['flag']}", flush=True)
    for name in ("l2_topk", "gbdt_predict"):
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the hnsw path")
    if failures:
        return out, launches, failures, fitted

    ql = torch.as_tensor(learn[:256], device="cuda")
    _, gt_l = flat.search(ql, index.vectors, 10)
    trace, _ = step_log_trace(darth.engine, ql, gt_l)
    if trace is None:
        return out, launches, ["torch.profiler recorded no device time"], \
            fitted
    out["step_log_batch"] = trace
    print(f"[hnsw] one fit batch's step log: {trace}", flush=True)
    return out, launches, [], fitted


def probe_bound(index, slots, active, k=10):
    """The least time of bucket_probe_slots calls over ``index``'s store,
    one call per row of slots [R, B] (summed over rows), with its live
    rows and distinct buckets; and, for comparison, the bytes' time if
    every query read its bucket from device memory itself.

    Bytes a call must move: each distinct bucket that an active query
    reads, once (every id, and the codes and sqnorm of its live rows:
    pads carry id -1 and distance +inf whatever their codes), and each
    active query's own inputs and running top-k in and out. Queries of
    one call that share a bucket find it in L2 after the first read."""
    import torch
    cap, code_bytes = index.cap, index.bucket_vecs.element_size()
    dd = index.bucket_vecs.shape[2]
    nrows = index.bucket_ids.shape[0]   # buckets in the store (cold: S)
    live_per_bucket = (index.bucket_ids >= 0).sum(1).double()
    slots = slots.reshape(-1, slots.shape[-1]).long()
    rows = float(active.sum())
    read = torch.zeros(slots.shape[0], nrows + 1,
                       dtype=torch.double, device=slots.device)
    read.scatter_(1, slots.masked_fill(~active, nrows), 1.0)
    read = read[:, :nrows]
    live = read @ live_per_bucket
    own = 4.0 * rows * (dd + 3) + 16.0 * rows * k
    byts = 4.0 * cap * read.sum(1) + live * (dd * code_bytes + 4.0) + own
    live_q = (live_per_bucket[slots] * active).sum(1)
    byts_q = 4.0 * rows * cap + live_q * (dd * code_bytes + 4.0) + own
    t_b, t_f = byts / HBM_BYTES_PER_S, 2.0 * live_q * dd / F32_FLOP_PER_S
    return {"bound_ms": 1e3 * float(torch.maximum(t_b, t_f).sum()),
            "bound_by": "bytes" if bool((t_b >= t_f).all())
            else "operations",
            "live_rows": int(live.sum()), "buckets": int(read.sum()),
            "live_rows_per_query_sum": int(live_q.sum()),
            "bound_per_query_reads_ms":
                1e3 * float((byts_q / HBM_BYTES_PER_S).sum())}


def l2_bound_of(b, n, dd, code_bytes, kk, f32_codes=True):
    """Both bounds of one l2_topk call of b queries against n rows of
    width dd, as the module docstring states."""
    flop = 2.0 * b * n * dd
    t_b = (4.0 * (b * dd + n) + n * dd * code_bytes
           + 8.0 * b * kk) / HBM_BYTES_PER_S
    t_ops = 3 * flop / (TF32_FLOP_PER_S if f32_codes else BF16_FLOP_PER_S)
    return {"bound_ms": 1e3 * max(t_ops, t_b),
            "bound_by": "operations" if t_ops > t_b else "bytes",
            "f32_core_bound_ms": 1e3 * max(flop / F32_FLOP_PER_S, t_b)}


def serve_row(results, stats, wall, tracer=None):
    """One serve run's numbers: wall time, host-side q/s and ServeStats'
    counters; with a tracer, also mean npred, the early-stop share and
    the slot-steps a server without compaction would take (the queries in
    arrival order in fixed batches of SERVE_SLOTS, each batch occupying
    its slots until its slowest query ends; a query's life is its
    admission-to-harvest steps in this run, a multiple of SERVE_SPS)."""
    row = {"wall_s": wall, "qps_host": stats.completed / wall,
           "completed": stats.completed, "returned": sum(
               r is not None for r in results),
           "engine_steps": stats.engine_steps,
           "slot_steps": stats.slot_steps, "refills": stats.refills,
           "truncated": stats.truncated,
           "ndis_harvested": stats.ndis_harvested,
           "ndis_mean": stats.ndis_harvested / max(stats.completed, 1),
           "chunk_ms_p50": stats.chunk_ms_p50,
           "chunk_ms_p99": stats.chunk_ms_p99}
    if tracer is not None:
        terms = tracer.terminals()
        life = [terms[i].step - terms[i].attrs["admit_step"]
                for i in sorted(terms)]
        row["no_compaction_slot_steps"] = sum(
            len(life[lo:lo + SERVE_SLOTS]) * max(life[lo:lo + SERVE_SLOTS])
            for lo in range(0, len(life), SERVE_SLOTS))
        row["npred_mean"] = sum(t.attrs.get("npred", 0)
                                for t in terms.values()) / len(terms)
        row["early_share"] = sum(t.attrs["reason"] == "interval_met"
                                 for t in terms.values()) / len(terms)
    return row


def serve_recall(results, gt, r_targets):
    """Mean recall@10 of the served ids per declared target."""
    import numpy as np
    import torch
    from repro_torch.index import flat
    ids = torch.as_tensor(np.stack([r[1] for r in results]),
                          device=gt.device)
    rec = flat.recall_at_k(ids, gt).cpu().numpy()
    masks = {t: r_targets == np.float32(t) for t in TARGETS}
    return {str(t): float(rec[m].mean()) if m.any() else None
            for t, m in masks.items()}


def same_results(a, b):
    """Count of queries whose (dists, ids) differ between two serves."""
    import numpy as np
    return sum(not (np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]))
               for x, y in zip(a, b))


def shape_row_l2(case, qq, xx, sq, kk, launches_n, reps, plain_reps=1):
    """l2_topk at one shape: event time over ``reps`` calls, its plain
    version's, one PyTorch computation of the same function (x_sqnorm -
    2 q.x by addmm and its k smallest by topk; int8 codes widened to f32
    outside the timing), both bounds and the profiler's device ms per
    kernel ({} when the profiler recorded none)."""
    import torch
    from repro_torch.kernels import cuda, ref
    xf = xx.float()
    row = {"case": case, "shape": f"q[{qq.shape[0]},{qq.shape[1]}] "
           f"x[{xx.shape[0]},{xx.shape[1]}] {xx.dtype} k={kk}",
           "launches": launches_n,
           "ms": cuda_ms(lambda: cuda.l2_topk(qq, xx, sq, kk), reps),
           "plain_ms": cuda_ms(lambda: ref.l2_topk_ref(qq, xx, sq, kk),
                               plain_reps),
           "library_ms": cuda_ms(lambda: torch.topk(torch.addmm(
               sq, qq, xf.T, alpha=-2), kk, largest=False), plain_reps)}
    del xf
    row.update(l2_bound_of(qq.shape[0], xx.shape[0], xx.shape[1],
                           xx.element_size(), kk, xx.dtype == torch.float32))
    _, by, counts = profiled(lambda: [cuda.l2_topk(qq, xx, sq, kk)
                                      for _ in range(reps)])
    row["kernels_ms"] = kernels_ms(by, counts, "l2_")
    row["profiled_launches"] = {k: counts[k] for k in by if "l2_" in k}
    row["profiled_calls"] = reps
    row["device_ms"] = sum(row["kernels_ms"].values())
    return row


def shape_row_gbdt(case, xx, p, launches_n, reps=200):
    """gbdt_predict at one shape against its plain version: max error,
    event time, plain time, both bounds (as phase 3 counts them) and the
    profiler's device ms per call."""
    from repro_torch.kernels import cuda, ref
    gargs = (xx.contiguous(), p.feat, p.thresh, p.leaf)
    err = float((cuda.gbdt_predict(*gargs)
                 - ref.gbdt_predict_ref(*gargs)).abs().max())
    nt, nint = p.feat.shape
    b, nf = xx.shape
    t_b = (4.0 * (2 * nt * nint + nt * (nint + 1)) + 4.0 * b * (nf + 1)
           ) / HBM_BYTES_PER_S
    t_f = float(b) * nt * (p.depth + 1) / F32_FLOP_PER_S
    row = {"case": case, "shape": f"x[{b},{nf}] trees={nt} depth={p.depth}",
           "B": b, "launches": launches_n, "max_abs_err": err,
           "ms": cuda_ms(lambda: cuda.gbdt_predict(*gargs), reps),
           "plain_ms": cuda_ms(lambda: ref.gbdt_predict_ref(*gargs), 5),
           "bound_ms": 1e3 * max(t_b, t_f),
           "bound_by": "bytes" if t_b >= t_f else "operations",
           "lookup_figure_ms": 1e3 * b * nt * (2 * p.depth + 1)
           / SMEM_LOOKUPS_PER_S}
    _, by, counts = profiled(lambda: [cuda.gbdt_predict(*gargs)
                                      for _ in range(reps)])
    row["kernels_ms"] = kernels_ms(by, counts, "gbdt")
    row["profiled_launches"] = {k: counts[k] for k in by if "gbdt" in k}
    row["profiled_calls"] = reps
    row["device_ms"] = sum(row["kernels_ms"].values())
    return row


def shape_row_probe(case, store, args, tol, launches_n, reps=50):
    """bucket_probe_slots on ``args`` (its own argument tuple, over
    ``store``) against its plain version, timed beside its bound and the
    profiler's device ms. Returns (row, agrees)."""
    import torch
    from repro_torch.kernels import cuda, ref
    got = cuda.bucket_probe_slots(*args)
    want = ref.bucket_probe_slots_ref(*args)
    err, agree, ok = topk_agreement(got[0], got[1], want[0], want[1], tol)
    cnt = int((got[2] - want[2]).abs().max())
    slot, act, k = args[4], args[5], args[8].shape[1]
    row = {"case": case, "B": int(slot.shape[0]), "active": int(act.sum()),
           "k": k, "max_abs_err": err, "id_agreement": agree,
           "count_max_diff": cnt, "tol": tol, "launches": launches_n,
           "ms": cuda_ms(lambda: cuda.bucket_probe_slots(*args), reps),
           "plain_ms": cuda_ms(lambda: ref.bucket_probe_slots_ref(*args), 5)}
    row.update(probe_bound(store, slot, act, k))
    torch.cuda.synchronize()
    _, by, counts = profiled(lambda: [cuda.bucket_probe_slots(*args)
                                      for _ in range(reps)])
    row["kernels_ms"] = kernels_ms(by, counts, "probe")
    row["device_ms"] = sum(row["kernels_ms"].values())
    return row, ok and cnt <= 2


def serve_kernel_shapes(ds, index, sq8, darth, launches):
    """bucket_probe and gbdt_predict at the serve path's own shapes, each
    against its plain version on the same inputs and timed beside it with
    its bound: one chunk step of the pool (SERVE_SLOTS queries at probe
    rank 1, every fourth slot free) over the f32 store at k = 10 and over
    the SQ8 codes at k' = 40, and the predictor on that step's feature
    rows. (l2_topk runs on this path only in the SQ8 fit's ground truth,
    phase 3's fit shape.) Returns ({kernel: [shape rows]}, failures)."""
    import torch
    from repro_torch.core import darth_search
    from repro_torch.index import ivf
    qs = torch.as_tensor(ds.queries[:SERVE_SLOTS], device=index.device)
    free = torch.arange(SERVE_SLOTS, device=index.device) % 4 == 3
    shapes = {"bucket_probe": [], "gbdt_predict": []}
    failures = []
    for case, idx, k in (("serve chunk step, f32 store", index, 10),
                         ("serve chunk step, SQ8 codes, k'=40", sq8, 40)):
        st = ivf.probe_step(idx, ivf.init_state(idx, qs, k=k,
                                                 nprobe=idx.nlist))
        act = st.active & ~free
        # probe_step's own arguments: the asymmetric SQ8 query and bias
        if idx.quantized:
            q_eff = (st.q * idx.scale[None, :]).contiguous()
            bias = (st.qsq - 2.0 * (st.q @ idx.offset)[:, None]).contiguous()
        else:
            q_eff, bias = st.q, st.qsq
        slot = st.probe_order[:, 1].contiguous()
        args = (q_eff, idx.bucket_vecs, idx.bucket_sqnorm, idx.bucket_ids,
                slot, act, bias, st.topk_d[:, -1:].contiguous(), st.topk_d,
                st.topk_i)
        tol = 1e-3 + 1e-5 * float(torch.nan_to_num(idx.bucket_sqnorm,
                                                    posinf=0).max())
        row, ok = shape_row_probe(case, idx, args, tol,
                                  launches["bucket_probe"])
        shapes["bucket_probe"].append(row)
        print(f"[serve] bucket_probe {row}", flush=True)
        if not ok:
            failures.append(f"bucket_probe disagrees with plain at {case}")
        if idx is index:
            feats = darth_search._features(darth.engine, st).contiguous()
    row = shape_row_gbdt("serve chunk step, the pool's feature rows", feats,
                         darth.trained.predictor.params,
                         launches["gbdt_predict"])
    shapes["gbdt_predict"].append(row)
    print(f"[serve] gbdt_predict {row}", flush=True)
    if row["max_abs_err"] > 1e-5:
        failures.append(f"gbdt_predict disagrees with plain at the serve "
                        f"shape: {row['max_abs_err']}")
    return shapes, failures


def serve_path(ds, index, darth, gt, hnsw_fitted, card):
    """Phase 5: the DarthServer slot pool, as the launcher serves
    (src/repro/launch/serve.py:80,216-217,247-250): 64 slots, 4 steps a
    chunk, the test queries with targets drawn from 0.80 / 0.90 / 0.95.
    Three runs at full width: IVF f32 (phase 2's index and Darth; hosts 1
    and 4, untraced and traced, held to each other and to darth_search),
    IVF SQ8 with the f32 re-rank (quantize_ivf of phase 2's index, its
    own fit, k' = 40), and HNSW (phase 4's graph and Darth). Returns
    (results, launches by kernel on this path, failures, {run: (results,
    tracer)}, the targets drawn)."""
    import numpy as np
    import torch
    from repro_torch.core import api, darth_search, engines
    from repro_torch.index import residency
    from repro_torch.kernels import cuda
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serve import DarthServer
    nq = ds.queries.shape[0]
    r_targets = np.random.default_rng(0).choice(
        list(TARGETS), nq).astype(np.float32)
    out = {"card": card, "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
           "queries": nq, "runs": {}}
    failures = []
    served = {}

    def serve(name, engine, d, *, hosts=1, traced=False, metrics=False,
              rerank=None):
        tracer = Tracer() if traced else None
        reg = MetricsRegistry() if metrics else None
        srv = DarthServer(engine, d.trained.predictor, d.interval_for_target,
                          num_slots=SERVE_SLOTS, steps_per_sync=SERVE_SPS,
                          hosts=hosts, tracer=tracer, metrics=reg,
                          rerank=rerank)
        torch.cuda.synchronize()
        t0 = time.time()
        results, stats = srv.serve(ds.queries, r_targets)
        torch.cuda.synchronize()
        row = serve_row(results, stats, time.time() - t0, tracer)
        row.update(hosts=hosts, traced=traced)
        if stats.completed != nq or row["returned"] != nq:
            failures.append(f"serve {name}: {stats.completed} of {nq} "
                            f"completed, {row['returned']} returned")
        if reg is not None:
            row["metrics_completed"] = reg.counter(
                "darth_queries_total").value(outcome="completed")
            if row["metrics_completed"] != stats.completed:
                failures.append(f"serve {name}: metrics count "
                                f"{row['metrics_completed']} completed")
        if tracer is not None:
            spans = [sp for sp in tracer.last_spans if sp.kind == "terminal"]
            if sorted(sp.qid for sp in spans) != list(range(nq)):
                failures.append(f"serve {name}: terminal spans are not one "
                                f"per query")
        out["runs"][name] = row
        served[name] = (results, tracer)
        print(f"[serve] {name} {row}", flush=True)
        return results

    torch.cuda.synchronize()
    cuda.reset_launches()
    # 1. IVF f32
    for name, kw in (("ivf_f32_hosts1", {}), ("ivf_f32_hosts4", {"hosts": 4}),
                     ("ivf_f32_hosts1_traced", {"traced": True,
                                                "metrics": True}),
                     ("ivf_f32_hosts4_traced", {"hosts": 4, "traced": True})):
        serve(name, darth.engine, darth, **kw)
    # 2. IVF SQ8 with the f32 re-rank: its own fit, served at k' = 4k
    t0 = time.time()
    sq8 = residency.quantize_ivf(index)
    torch.cuda.synchronize()
    out["sq8"] = {"quantize_s": time.time() - t0,
                  "resident_bytes_f32": residency.resident_bytes(index),
                  "resident_bytes_sq8": residency.resident_bytes(sq8)}
    print(f"[serve] resident bytes f32 "
          f"{out['sq8']['resident_bytes_f32']['total']} sq8 "
          f"{out['sq8']['resident_bytes_sq8']['total']}", flush=True)
    d8 = api.Darth(make_engine=lambda **kw: engines.ivf_engine(sq8, **kw),
                   engine=engines.ivf_engine(sq8, k=10, nprobe=index.nlist))
    for line in SQ8_CUTS:
        print(f"[serve] CUT: {line}", flush=True)
    out["cuts"] = SQ8_CUTS
    t0 = time.time()
    trained = d8.fit(ds.learn[:SQ8_FIT_LEARN], ds.base)
    out["sq8"].update(fit_s=time.time() - t0, fit_split_s=d8.fit_seconds,
                      predictor=dict(trained.metrics,
                                     samples=trained.num_samples))
    print(f"[serve] SQ8 Darth.fit {out['sq8']['fit_s']:.1f}s split "
          + " ".join(f"{k}={v:.1f}s" for k, v in d8.fit_seconds.items()),
          flush=True)
    rerank = residency.RerankStore(ds.base).reranker(10)
    eng40 = engines.ivf_engine(sq8, k=40, nprobe=index.nlist)
    serve("ivf_sq8_rerank", eng40, d8, rerank=rerank)
    # 3. HNSW
    hd = hnsw_fitted["darth"]
    serve("hnsw_traced", hd.engine, hd, traced=True)
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    print(f"[serve] launches {launches}", flush=True)
    for name in launches:
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the serve "
                            f"path")
    if failures:
        return out, launches, failures, served, r_targets

    # Checks after the counted run: recall gates, runs held to each other,
    # the IVF f32 runs to darth_search with per-query intervals.
    gates = {}
    for name, (results, _) in served.items():
        rec = serve_recall(results, hnsw_fitted["gt"] if name.startswith(
            "hnsw") else gt, r_targets)
        out["runs"][name]["recall"] = rec
        for t in TARGETS:
            gate = (min(t, hnsw_fitted["plain_recall"]) if
                    name.startswith("hnsw") else t) - TOL
            gates[f"{name} {t}"] = gate
            if rec[str(t)] < gate:
                failures.append(f"serve {name}: recall {rec[str(t)]:.4f} at "
                                f"target {t} below {gate:.4f}")
    ivf_runs = [n for n in served if n.startswith("ivf_f32")]
    for name in ivf_runs[1:]:
        diff = same_results(served[ivf_runs[0]][0], served[name][0])
        if diff:
            failures.append(f"serve {name}: {diff} queries differ from "
                            f"{ivf_runs[0]}")
    # darth_search in batches of SERVE_SLOTS queries (the last padded with
    # its own queries), so every device call has the server's shapes.
    eng, pred = darth.engine, darth.trained.predictor
    q_all = torch.as_tensor(ds.queries, device=index.device)
    ids_ds, ndis_ds = [], []
    for lo in range(0, nq, SERVE_SLOTS):
        sel = np.resize(np.arange(lo, min(lo + SERVE_SLOTS, nq)), SERVE_SLOTS)
        rt = r_targets[sel]
        st = darth_search.darth_search(eng, q_all[torch.as_tensor(sel)], rt,
                                       pred, darth.interval_for_target(rt))
        keep = min(SERVE_SLOTS, nq - lo)
        ids_ds.append(eng.topk_i(st.inner)[:keep].cpu().numpy())
        ndis_ds.append(st.inner.ndis[:keep].cpu().numpy())
    ids_ds, ndis_ds = np.concatenate(ids_ds), np.concatenate(ndis_ds)
    ds_check = {"ids_differ": sum(
        not np.array_equal(r[1], ids_ds[i])
        for i, r in enumerate(served["ivf_f32_hosts1"][0]))}
    for name in ("ivf_f32_hosts1_traced", "ivf_f32_hosts4_traced"):
        terms = served[name][1].terminals()
        ds_check[f"{name}_ndis_differ"] = sum(
            terms[i].attrs["ndis"] != ndis_ds[i] for i in range(nq))
    ds_check["ndis_harvested_equal"] = all(
        out["runs"][n]["ndis_harvested"] == int(ndis_ds.sum())
        for n in ivf_runs)
    out["darth_search_check"] = ds_check
    if any(v for k, v in ds_check.items() if k.endswith("differ")) or \
            not ds_check["ndis_harvested_equal"]:
        failures.append(f"serve ivf_f32 differs from darth_search: "
                        f"{ds_check}")
    shapes, errors = serve_kernel_shapes(ds, index, sq8, darth, launches)
    out["kernel_shapes"] = shapes
    failures += errors
    h = out["runs"]["hnsw_traced"]
    if h["npred_mean"] == 0:
        out["flag"] = ("npred is 0 for every served HNSW query: no query "
                       "was due for a prediction (as in phase 4)")
        print(f"[serve] FLAG: {out['flag']}", flush=True)
    for name, row in out["runs"].items():
        print(f"[serve] {name}: recall {row.get('recall')} wall "
              f"{row['wall_s']:.2f}s q/s {row['qps_host']:.0f} slot_steps "
              f"{row['slot_steps']} (no compaction "
              f"{row.get('no_compaction_slot_steps')}) npred "
              f"{row.get('npred_mean')} early {row.get('early_share')}",
              flush=True)
    return out, launches, failures, served, r_targets


def darth_row(out_ids, st, secs, gt, nq):
    """One Darth.search run's numbers: recall@10 against ``gt``, mean ndis
    and npred, early-stop share, wall and q/s."""
    from repro_torch.index import flat
    return {"recall": float(flat.recall_at_k(out_ids, gt).mean()),
            "ndis": float(st.inner.ndis.float().mean()),
            "npred": float(st.npred.float().mean()),
            "early_share": float(st.early.float().mean()),
            "steps": st.steps, "wall_s": secs, "qps": nq / secs}


def same_decisions(a, b):
    """Queries whose ids, ndis, ninserts, r_pred, npred or early differ
    between two Darth.search outputs (ids, state)."""
    (ia, sa), (ib, sb) = a, b
    diff = ((ia != ib).any(1) | (sa.inner.ndis != sb.inner.ndis)
            | (sa.inner.ninserts != sb.inner.ninserts)
            | (sa.r_pred != sb.r_pred) | (sa.npred != sb.npred)
            | (sa.early != sb.early))
    return int(diff.sum())


def timed_search(darth, q, rt):
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    _, ids, st = darth.search(q, rt)
    torch.cuda.synchronize()
    return ids, st, time.time() - t0


def mutate_path(ds, index, darth, hnsw_fitted, card):
    """Phase 6: the streaming mutable index as the launcher runs it
    (src/repro/launch/serve.py:183-208,251-443). IVF at full width on
    phase 2's index and Darth: empty-delta parity, the 20 % / 10 % burst
    served through DarthServer, drift check and a forced refit hot-swapped
    in, a synchronous compaction, and the online path (one event per chunk
    boundary, background compaction ticks, a drained swap mid-serve).
    HNSW on phase 4's graph and Darth with a 1 % / 0.5 % burst: search,
    compaction, parity. Returns (results, launches by kernel on this path,
    failures, the delta ring captured mid-stream for the kernel rows)."""
    import numpy as np
    import torch
    from repro_torch import mutate
    from repro_torch.core import api, engines
    from repro_torch.data import vectors
    from repro_torch.index import flat, residency
    from repro_torch.kernels import cuda
    from repro_torch.obs import Tracer
    from repro_torch.serve import DarthServer
    dev = index.device
    nq = ds.queries.shape[0]
    n = ds.base.shape[0]
    q = torch.as_tensor(ds.queries, device=dev)
    r_targets = np.random.default_rng(0).choice(
        list(TARGETS), nq).astype(np.float32)
    kw = dict(k=10, nprobe=index.nlist)
    cap = max(10, -(-int(round(MUTATE_INS * n)) // 128) * 128)
    out = {"card": card, "ivf": {"delta_capacity": cap, "steps": {}},
           "hnsw": {}, "cuts": MUTATE_CUTS}
    failures = []
    for line in MUTATE_CUTS:
        print(f"[mutate] CUT: {line}", flush=True)
    frozen = {name: getattr(index, name).clone() for name in
              ("bucket_ids", "bucket_sqnorm", "bucket_sizes")}

    def check_recall(name, row, gate_of):
        for t in TARGETS:
            rec = row["recall"][str(t)]
            if rec < gate_of(t):
                failures.append(f"mutate {name}: recall {rec:.4f} at "
                                f"target {t} below {gate_of(t):.4f}")

    def serve(name, srv, mut, on_boundary=None, reps=1):
        """Serve the test queries (repeated ``reps`` times) through srv
        (traced: npred and the early-stop share come from the terminal
        spans). A run whose index changes under it (on_boundary) is
        checked for completion only: a result may then hold an id
        deleted later."""
        qs = np.tile(ds.queries, (reps, 1))
        torch.cuda.synchronize()
        t0 = time.time()
        results, stats = srv.serve(qs, np.tile(r_targets, reps),
                                   on_boundary=on_boundary)
        torch.cuda.synchronize()
        row = serve_row(results, stats, time.time() - t0, srv.tracer)
        row["swaps"] = stats.swaps
        out["ivf"]["steps"][name] = row
        if stats.completed != len(qs) or row["returned"] != len(qs):
            failures.append(f"mutate {name}: {stats.completed} of "
                            f"{len(qs)} completed")
            return row, results
        if on_boundary is not None:
            print(f"[mutate] ivf {name} {row}", flush=True)
            return row, results
        ids = np.stack([r[1] for r in results])
        dead = set(mut.deleted_ids.tolist())
        row["deleted_returned"] = len(set(ids.ravel().tolist()) & dead)
        if row["deleted_returned"]:
            failures.append(f"mutate {name}: {row['deleted_returned']} "
                            f"deleted ids returned")
        gt = torch.as_tensor(mut.live_ground_truth(ds.queries, 10),
                             device=dev)
        rec = flat.recall_at_k(torch.as_tensor(ids, device=dev),
                               gt).cpu().numpy()
        row["recall"] = {str(t): float(rec[r_targets == np.float32(t)].mean())
                         for t in TARGETS}
        print(f"[mutate] ivf {name} {row}", flush=True)
        check_recall(f"ivf {name}", row, lambda t: t - TOL)
        return row, results

    torch.cuda.synchronize()
    cuda.reset_launches()
    # -- IVF 1. empty-delta parity --------------------------------------------
    mut = mutate.MutableIndex(index, capacity=cap)

    def make_engine(**k2):
        return engines.mutable_engine(engines.ivf_engine(mut.base, **k2),
                                      mut.delta)
    mdarth = api.Darth(make_engine=make_engine, engine=make_engine(**kw),
                       trained=darth.trained)
    parity = {}
    for rt in TARGETS:
        a = timed_search(darth, q, rt)
        b = timed_search(mdarth, q, rt)
        parity[str(rt)] = same_decisions(a[:2], b[:2])
    out["ivf"]["empty_delta_differ"] = parity
    print(f"[mutate] ivf empty-delta parity: queries differing {parity}",
          flush=True)
    if any(parity.values()):
        failures.append(f"mutate ivf: empty-delta wrapper differs from "
                        f"Darth.search: {parity}")
    out["ivf"]["resident_bytes_base"] = residency.resident_bytes(
        index)["total"]
    out["ivf"]["resident_bytes_delta"] = residency.resident_bytes(
        mut.delta)["total"]

    # -- IVF 2. the burst --------------------------------------------------------
    events = vectors.mutation_stream(ds, MUTATE_INS, MUTATE_DEL,
                                     drift=MUTATE_DRIFT, steps=4, seed=1)
    t0 = time.time()
    mut.apply(events)
    torch.cuda.synchronize()
    out["ivf"]["apply_s"] = time.time() - t0
    out["ivf"]["after_burst"] = {"delta_live": mut.num_delta,
                                 "tombstones": int(len(mut.deleted_ids)),
                                 "live": mut.num_live}
    print(f"[mutate] ivf burst applied in {out['ivf']['apply_s']:.1f}s: "
          f"{out['ivf']['after_burst']}", flush=True)
    mdarth.engine = make_engine(**kw)
    server = DarthServer(mdarth.engine, mdarth.trained.predictor,
                         mdarth.interval_for_target, num_slots=SERVE_SLOTS,
                         steps_per_sync=SERVE_SPS, tracer=Tracer())
    row, results = serve("post-burst", server, mut)
    # chunk boundaries a pass of the test queries crosses while the pool
    # is full: each query holds a slot for slot_steps / completed steps
    per_pass = (row["slot_steps"] / SERVE_SPS) / SERVE_SLOTS
    # inserted vectors as queries: each finds itself at rank 0
    own = np.array(sorted(mut._delta_slot))[::max(1, mut.num_delta // 64)][:64]
    own_q = mut.delta.vecs[[mut._delta_slot[i] for i in own]]
    _, own_ids, _ = mdarth.search(own_q, 0.95)
    own_hit = int((own_ids[:, 0].cpu().numpy() == own).sum())
    out["ivf"]["inserted_self_rank0"] = own_hit
    print(f"[mutate] ivf inserted vectors found at rank 0: {own_hit} of "
          f"{own.size}", flush=True)
    if own_hit != own.size:
        failures.append(f"mutate ivf: {own.size - own_hit} inserted vectors "
                        f"not found at rank 0")

    # -- IVF 3. drift check and a forced refit ----------------------------------
    monitor = mutate.RecalibrationMonitor(mut, mdarth, targets=TARGETS)
    monitor.observe(ds.queries, r_targets,
                    np.stack([r[1] for r in results]))
    rep = monitor.drift()
    out["ivf"]["drift"] = {"achieved": {str(k): v for k, v in
                                        rep.achieved.items()},
                           "worst_gap": rep.worst_gap,
                           "drifted": rep.drifted,
                           "num_queries": rep.num_queries}
    print(f"[mutate] ivf drift check: {out['ivf']['drift']} (refit forced "
          f"whatever the verdict)", flush=True)
    t0 = time.time()
    trained = monitor.recalibrate(ds.learn[:MUTATE_REFIT_LEARN],
                                  server=server)
    torch.cuda.synchronize()
    out["ivf"]["refit_s"] = time.time() - t0
    out["ivf"]["refit_split_s"] = dict(monitor.refit_seconds)
    out["ivf"]["refit_predictor"] = dict(trained.metrics,
                                         samples=trained.num_samples)
    print(f"[mutate] ivf refit {out['ivf']['refit_s']:.1f}s split "
          f"{monitor.refit_seconds}", flush=True)
    if server.predictor is not trained.predictor:
        failures.append("mutate ivf: the refit predictor was not swapped in")
    serve("post-recalibration", server, mut)

    # -- IVF 4. synchronous compaction --------------------------------------------
    torch.cuda.synchronize()
    t0 = time.time()
    mut.compact()
    torch.cuda.synchronize()
    out["ivf"]["compact_s"] = time.time() - t0
    out["ivf"]["compact_split_s"] = dict(mut.compaction_seconds)
    out["ivf"]["compacted_cap"] = mut.base.cap
    print(f"[mutate] ivf compaction {out['ivf']['compact_s']:.1f}s split "
          f"{mut.compaction_seconds} cap {index.cap} -> {mut.base.cap}",
          flush=True)
    mdarth.engine = make_engine(**kw)
    server.set_engine(mdarth.engine, contents_only=True)
    serve("post-compaction", server, mut)
    plain = api.Darth(make_engine=None,
                      engine=engines.ivf_engine(mut.base, **kw),
                      trained=mdarth.trained)
    parity = {str(rt): same_decisions(timed_search(plain, q, rt)[:2],
                                      timed_search(mdarth, q, rt)[:2])
              for rt in TARGETS}
    out["ivf"]["post_compaction_differ"] = parity
    print(f"[mutate] ivf post-compaction wrapper vs ivf_engine: queries "
          f"differing {parity}", flush=True)
    if any(parity.values()):
        failures.append(f"mutate ivf: post-compaction wrapper differs: "
                        f"{parity}")
    out["ivf"]["resident_bytes_compacted"] = residency.resident_bytes(
        mut.base)["total"]
    del server, monitor, plain, mut

    # -- IVF 5. the online path ------------------------------------------------------
    if not all(torch.equal(getattr(index, k), v) for k, v in frozen.items()):
        failures.append("mutate ivf: phase 2's index changed")
    mut = mutate.MutableIndex(index, capacity=cap)
    mdarth.engine = make_engine(**kw)
    events = list(vectors.mutation_stream(ds, MUTATE_INS, MUTATE_DEL,
                                          drift=MUTATE_DRIFT, steps=4,
                                          seed=1))
    n_ins = sum(e.vecs.shape[0] for e in events if e.kind == "insert")
    # Ticks of compact_ivf_steps: two snapshot reads, one per 4096-row
    # assign chunk, the concatenation, one per 64-bucket pack chunk; the
    # tick that finds it done and the drain take a chunk each.
    ticks = 2 + -(-n_ins // 4096) + 1 + -(-index.nlist // 64)
    need = len(events) + 1 + ticks + 1 + 2
    # the smallest R whose stream outlasts the swap by a pass
    reps = int(np.ceil(need / per_pass)) + 1
    out["ivf"]["online"] = {"events": len(events), "expected_ticks": ticks,
                            "boundaries_needed": need,
                            "boundaries_per_pass": per_pass, "R": reps}
    print(f"[mutate] ivf online: {len(events)} events + begin + {ticks} "
          f"ticks + done + drain = {need} boundaries; {per_pass:.1f} "
          f"boundaries a pass -> the test queries repeated R = {reps} "
          f"times", flush=True)
    if reps > 8:
        failures.append(f"mutate ivf online: R = {reps} > 8")
        return out, dict(cuda.LAUNCHES), failures, None
    server = DarthServer(mdarth.engine, mdarth.trained.predictor,
                         mdarth.interval_for_target, num_slots=SERVE_SLOTS,
                         steps_per_sync=SERVE_SPS, tracer=Tracer())
    state = {"swapped": False, "ticks": 0, "inserts": 0, "ring": None,
             "boundary": 0, "swap_at": None}

    def on_boundary(srv):
        state["boundary"] += 1
        if srv.swap_pending or state["swapped"]:
            return
        if events:
            ev = events.pop(0)
            mut.apply([ev])
            if ev.kind == "insert":
                state["inserts"] += 1
                if state["inserts"] == 2:    # half the stream: the ring
                    state["ring"] = mut.delta  # the kernel rows time
            mdarth.engine = mutate.refresh_view(
                srv.engine, base=mut.base if ev.kind == "delete" else None,
                delta=mut.delta)
            srv.set_engine(mdarth.engine, contents_only=True)
        elif not mut.compacting:
            mut.begin_compaction()
        elif mut.compact_tick():
            state["ticks"] = mut.compaction_ticks
            mut.swap_compaction()
            mdarth.engine = make_engine(**kw)
            srv.request_swap(mdarth.engine, contents_only=True)
            state["swapped"] = True
            state["swap_at"] = state["boundary"]

    row, _ = serve("online", server, mut, on_boundary=on_boundary,
                   reps=reps)
    row.update(ticks=state["ticks"], swap_at_boundary=state["swap_at"],
               boundaries=state["boundary"])
    print(f"[mutate] ivf online: swaps {row['swaps']} after "
          f"{state['ticks']} ticks at boundary {state['swap_at']} of "
          f"{state['boundary']}", flush=True)
    if row["swaps"] != 1 or not state["swapped"]:
        failures.append(f"mutate ivf online: {row['swaps']} swaps")
    if state["ticks"] != ticks:
        failures.append(f"mutate ivf online: {state['ticks']} ticks, "
                        f"expected {ticks}")
    serve("post-swap", server, mut)
    ring = state["ring"]
    del server, mut

    # -- HNSW, cut ----------------------------------------------------------------------
    hd = hnsw_fitted["darth"]
    graph = hd.engine.index
    hn = graph.num_vectors
    hds = vectors.VectorDataset(base=ds.base[:hn], learn=ds.learn,
                                queries=ds.queries, name="hnsw")
    hcap = max(10, -(-int(round(HNSW_MUTATE_INS * hn)) // 128) * 128)
    hkw = dict(k=10, ef=384, max_steps=1200)
    hmut = mutate.MutableIndex(graph, capacity=hcap)
    hmut.apply(vectors.mutation_stream(hds, HNSW_MUTATE_INS,
                                       HNSW_MUTATE_DEL, drift=MUTATE_DRIFT,
                                       steps=4, seed=1))

    def hmake(**k2):
        return engines.mutable_engine(engines.hnsw_engine(hmut.base, **k2),
                                      hmut.delta)
    hmd = api.Darth(make_engine=hmake, engine=hmake(**hkw),
                    trained=hd.trained)
    h = out["hnsw"]
    h.update(delta_capacity=hcap, delta_live=hmut.num_delta,
             tombstones=int(len(hmut.deleted_ids)), live=hmut.num_live)
    gt = torch.as_tensor(hmut.live_ground_truth(ds.queries, 10), device=dev)
    _, pi, _ = hmd.search_plain(q)
    h["plain_recall"] = float(flat.recall_at_k(pi, gt).mean())
    h["targets"] = {}
    hdead = set(hmut.deleted_ids.tolist())
    for rt in TARGETS:
        ids, st, secs = timed_search(hmd, q, rt)
        row = darth_row(ids, st, secs, gt, nq)
        row["deleted_returned"] = len(set(ids.cpu().numpy().ravel().tolist())
                                      & hdead)
        h["targets"][str(rt)] = row
        print(f"[mutate] hnsw target {rt} {row}", flush=True)
        gate = min(rt, h["plain_recall"]) - TOL
        if row["recall"] < gate:
            failures.append(f"mutate hnsw: recall {row['recall']:.4f} at "
                            f"target {rt} below {gate:.4f}")
        if row["deleted_returned"]:
            failures.append("mutate hnsw: deleted ids returned")
    if all(r["npred"] == 0 for r in h["targets"].values()):
        h["flag"] = ("npred is 0 at every target: no query was due for a "
                     "prediction (as in phase 4)")
        print(f"[mutate] FLAG: {h['flag']}", flush=True)
    torch.cuda.synchronize()
    t0 = time.time()
    hmut.compact()
    torch.cuda.synchronize()
    h["compact_s"] = time.time() - t0
    h["compact_split_s"] = dict(hmut.compaction_seconds)
    print(f"[mutate] hnsw compaction {h['compact_s']:.1f}s split "
          f"{hmut.compaction_seconds} (link = insert_nodes of "
          f"{h['delta_live']} rows)", flush=True)
    hmd.engine = hmake(**hkw)
    hplain = api.Darth(make_engine=None,
                       engine=engines.hnsw_engine(hmut.base, **hkw),
                       trained=hd.trained)
    parity = {str(rt): same_decisions(timed_search(hplain, q, rt)[:2],
                                      timed_search(hmd, q, rt)[:2])
              for rt in TARGETS}
    h["post_compaction_differ"] = parity
    gt = torch.as_tensor(hmut.live_ground_truth(ds.queries, 10), device=dev)
    _, pi, _ = hplain.search_plain(q)
    h["compacted_plain_recall"] = float(flat.recall_at_k(pi, gt).mean())
    print(f"[mutate] hnsw post-compaction wrapper vs hnsw_engine: queries "
          f"differing {parity}; compacted plain recall "
          f"{h['compacted_plain_recall']:.4f}", flush=True)
    if any(parity.values()):
        failures.append(f"mutate hnsw: post-compaction wrapper differs: "
                        f"{parity}")
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    print(f"[mutate] launches {launches}", flush=True)
    for name in launches:
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the mutate "
                            f"path")
    return out, launches, failures, ring


def delta_scan_shapes(ds, ring, launches):
    """l2_topk at the delta scan's shapes (mutate/delta.py's call): a
    chunk's 64 refills and the 1000 test queries against the ring captured
    halfway through the online stream, empty slots at +inf. Each row: the
    kernel against its plain version (max error, id agreement), event,
    plain, addmm + topk and profiler device time, beside its bound (all
    rows read, as the kernel reads them; ``bound_live_ms`` counts only the
    live rows)."""
    import torch
    from repro_torch.kernels import cuda, ref
    rows, failures = [], []
    xsq = ring.sqnorm
    live = int(torch.isfinite(xsq).sum())
    tol = 1e-3 + 1e-5 * float(xsq[torch.isfinite(xsq)].max())
    for case, nq in (("delta scan, a chunk's 64 refills", SERVE_SLOTS),
                     ("delta scan, 1000 test queries", 1000)):
        qq = torch.as_tensor(ds.queries[:nq], device=ring.device)
        d_k, i_k = cuda.l2_topk(qq, ring.vecs, xsq, 10)
        d_r, i_r = ref.l2_topk_ref(qq, ring.vecs, xsq, 10)
        err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, tol)
        inf_entered = int((i_k >= 0).logical_and(
            ~torch.isfinite(xsq[i_k.clamp_min(0).long()])).sum())
        row = shape_row_l2(case, qq, ring.vecs, xsq, 10, launches["l2_topk"],
                           20, plain_reps=2)
        row.update(ring_rows=ring.capacity, live_rows=live,
                   inf_rows=ring.capacity - live, max_abs_err=err,
                   id_agreement=agree, tol=tol,
                   inf_rows_entered=inf_entered,
                   bound_live_ms=l2_bound_of(nq, live, ring.dim, 4,
                                             10)["bound_ms"])
        if "l2_topk_kernel" not in row["kernels_ms"]:
            failures.append(f"torch.profiler recorded no l2_topk kernel at "
                            f"the delta scan: {case}")
        rows.append(row)
        print(f"[mutate] l2_topk {row}", flush=True)
        if not ok or inf_entered:
            failures.append(f"l2_topk disagrees with plain at the {case}")
    return rows, failures


def competitors_path(ds, index, darth, results, tol, card):
    """Phase 7: the paper's competitors against DARTH on phase 2's IVF cell
    (benchmarks/paper_tables.py:160-205 and Fig 11, as that file runs them):
    validation queries learn[:512], the LAET / Baseline step log from
    learn[512:1536], ground truth at k = 10 and the wide ground truth at
    K' = 100 through l2_topk. DARTH, Baseline (budget_search at the mean
    dists_to_target), REM (the nprobe grid, then plain_search at the mapped
    nprobe) and LAET (n0 = 2, tune_laet with 6 steps) at each target, each
    summarized by core.metrics; the noise sweep at 0.90; the §4.1.5 model
    selection on phase 2's fit log. Returns (results, launches by kernel on
    this path, failures, {kernel: [shape rows]})."""
    import numpy as np
    import torch
    from repro_torch import gbdt
    from repro_torch.core import (baselines, darth_search, engines,
                                  features, intervals, metrics, training)
    from repro_torch.core.predictor import regression_metrics
    from repro_torch.data import vectors
    from repro_torch.index import flat
    from repro_torch.kernels import cuda, ops, ref
    dev = index.device
    xb = torch.as_tensor(ds.base, device=dev)
    q = torch.as_tensor(ds.queries, device=dev)
    nq = q.shape[0]
    eng = darth.engine
    out = {"card": card, "targets": {}, "noise": [], "model_selection": []}
    failures = []
    torch.cuda.synchronize()
    cuda.reset_launches()
    t_start = time.time()
    q_val = torch.as_tensor(ds.learn[:512], device=dev)
    _, gt_val = flat.search(q_val, xb, 10)
    q_tr = torch.as_tensor(ds.learn[512:1536], device=dev)
    _, gt_tr = flat.search(q_tr, xb, 10)
    t0 = time.time()
    log = training.generate_observations(eng, q_tr, gt_tr, batch=512)
    out["step_log_s"] = time.time() - t0
    gt_d, gt_i = flat.search(q, xb, 10)
    _, gtw_i = flat.search(q, xb, WIDE_K)
    truth = [t.cpu().numpy() for t in (gt_d, gt_i, gtw_i)]
    out["wide_gt_shape"] = list(gtw_i.shape)

    t0 = time.time()
    rem = baselines.fit_rem(
        lambda p: engines.ivf_engine(index, k=10, nprobe=p), q_val, gt_val,
        REM_GRID, TARGETS)
    out["rem"] = {"fit_s": time.time() - t0,
                  "sweep": {str(p): r for p, r in rem.sweep.items()},
                  "mapping": {str(t): p for t, p in rem.mapping.items()}}
    t0 = time.time()
    laet = baselines.fit_laet(log, n0=LAET_N0, device=dev)
    out["laet"] = {"fit_s": time.time() - t0}
    t0 = time.time()
    laet = baselines.tune_laet(laet, eng, q_val, gt_val, TARGETS,
                               steps=LAET_STEPS)
    out["laet"].update(tune_s=time.time() - t0, multipliers={
        str(t): m for t, m in laet.multipliers.items()})
    drt = {rt: float(np.mean(intervals.dists_to_target(
        log.recall, log.ndis, log.valid, rt))) for rt in TARGETS}
    out["baseline_budget"] = {str(t): v for t, v in drt.items()}
    print(f"[compete] step log {out['step_log_s']:.1f}s REM {out['rem']} "
          f"LAET {out['laet']} Baseline budgets {out['baseline_budget']}",
          flush=True)

    def run(method, qq, rt):
        """(dists, ids, ndis, host wall s) of one method at one target."""
        torch.cuda.synchronize()
        t0 = time.time()
        e = eng
        if method == "darth":
            inner = darth.search(qq, rt)[2].inner
        elif method == "baseline":
            inner = darth_search.budget_search(eng, qq, drt[rt])
        elif method == "rem":
            e = engines.ivf_engine(index, k=10, nprobe=rem.mapping[rt])
            inner = darth_search.plain_search(e, qq)
        else:
            inner = baselines.laet_search(laet, eng, qq,
                                          laet.multipliers[rt])
        dd, ii = e.topk_d(inner), e.topk_i(inner)
        torch.cuda.synchronize()
        return dd, ii, inner.ndis, time.time() - t0

    for rt in TARGETS:
        rows = {}
        for m in METHODS:
            dd, ii, nd, wall = run(m, q, rt)
            if tuple(ii.shape) != (nq, 10):
                failures.append(f"compete {m} at {rt}: {tuple(ii.shape)} "
                                f"results")
                continue
            row = metrics.summarize(dd.cpu().numpy(), ii.cpu().numpy(),
                                    *truth, rt)
            row.update(ndis=float(nd.float().mean()), wall_s=wall,
                       qps_host=nq / wall)
            if m == "darth":
                ids2, st2 = results[rt][:2]
                row["differ_from_phase2"] = int(
                    ((ii != ids2).any(1) | (nd != st2.inner.ndis)).sum())
                if row["differ_from_phase2"]:
                    failures.append(f"compete darth at {rt}: "
                                    f"{row['differ_from_phase2']} queries "
                                    f"differ from phase 2's Darth.search")
            rows[m] = row
            print(f"[compete] target {rt:.2f} {m:8s} {row}", flush=True)
        out["targets"][str(rt)] = rows
    maps = [rem.mapping[t] for t in TARGETS]
    if maps != sorted(maps):
        failures.append(f"compete: REM's mapping falls as the target rises: "
                        f"{out['rem']['mapping']}")

    for noise in NOISE_PCTS:
        qn = torch.as_tensor(vectors.noisy_queries(ds.queries, noise, seed=7),
                             device=dev)
        _, gt_n = flat.search(qn, xb, 10)
        plain = darth_search.plain_search(eng, qn)
        row = {"noise_pct": noise, "ceiling": float(flat.recall_at_k(
            eng.topk_i(plain), gt_n).mean())}
        for m in METHODS:
            _, ii, nd, _ = run(m, qn, NOISE_TARGET)
            row[m] = float(flat.recall_at_k(ii, gt_n).mean())
            row[f"{m}_ndis"] = float(nd.float().mean())
        out["noise"].append(row)
        print(f"[compete] noise {row}", flush=True)

    # §4.1.5 model selection (benchmarks/paper_tables.py:336-364)
    flog = darth._last_log
    mask = flog.valid.reshape(-1)
    xf = flog.features.reshape(-1, features.NUM_FEATURES)[mask]
    y = flog.recall.reshape(-1)[mask]
    sel = np.random.default_rng(0).choice(
        xf.shape[0], min(200_000, xf.shape[0]), replace=False)
    xf, y = xf[sel], y[sel]
    n_hold = int(0.1 * len(y))
    xtr, ytr, yho = xf[n_hold:], y[n_hold:], y[:n_hold]
    xho = torch.as_tensor(xf[:n_hold], device=dev)
    fitted = {}
    for name, fit in (
            ("gbdt", lambda: gbdt.fit(xtr, ytr, gbdt.GBDTConfig(
                num_trees=100, depth=6), device=dev)),
            ("random_forest", lambda: gbdt.fit_random_forest(
                xtr[:60_000], ytr[:60_000], num_trees=40, depth=6,
                device=dev)),
            ("decision_tree", lambda: gbdt.fit_decision_tree(
                xtr, ytr, depth=8, device=dev)),
            ("linear", lambda: gbdt.fit_linear(xtr, ytr, device=dev))):
        torch.cuda.synchronize()
        t0 = time.time()
        p = fitted[name] = fit()
        pred = (p.predict(xho) if name == "linear"
                else ops.gbdt_predict(p, xho))
        torch.cuda.synchronize()
        m = regression_metrics(pred.cpu().numpy(), yho)
        row = {"model": name, "mse": m["mse"], "r2": m["r2"],
               "fit_s": time.time() - t0, "train_rows": int(
                   min(60_000, len(ytr)) if name == "random_forest"
                   else len(ytr)), "holdout_rows": n_hold}
        out["model_selection"].append(row)
        print(f"[compete] model {row}", flush=True)
    torch.cuda.synchronize()
    out["wall_s"] = time.time() - t_start
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    print(f"[compete] launches {launches}", flush=True)
    for name, nl in launches.items():
        if nl < 1:
            failures.append(f"kernel {name} was not launched on the "
                            f"competitors path")

    # After the counted run: l2_topk at the wide ground truth's k against
    # its plain version, then the new shapes timed.
    xsq = (xb ** 2).sum(1)
    d_k, i_k = cuda.l2_topk(q, xb, xsq, WIDE_K)
    d_r, i_r = ref.l2_topk_ref(q, xb, xsq, WIDE_K)
    err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, tol)
    if not ok:
        failures.append(f"l2_topk at k={WIDE_K} disagrees with plain: "
                        f"max err {err}, id agreement {agree}")
    del d_r, i_r
    row = shape_row_l2(f"wide ground truth K'={WIDE_K}, f32", q, xb, xsq,
                       WIDE_K, launches["l2_topk"], 5)
    row.update(max_abs_err=err, id_agreement=agree, tol=tol)
    shapes = {"l2_topk": [row]}
    print(f"[compete] l2_topk {row}", flush=True)
    s_val = eng.init(eng.index, q_val)
    s_q = eng.init(eng.index, q)
    for _ in range(LAET_N0):
        s_val, s_q = eng.step(eng.index, s_val), eng.step(eng.index, s_q)
    gb = launches["gbdt_predict"]
    shapes["gbdt_predict"] = [
        shape_row_gbdt("random forest hold-out", xho, fitted["random_forest"],
                       gb),
        shape_row_gbdt("decision tree hold-out", xho, fitted["decision_tree"],
                       gb),
        shape_row_gbdt(f"LAET, {q_val.shape[0]} validation rows",
                       darth_search._features(eng, s_val), laet.params, gb),
        shape_row_gbdt(f"LAET, {nq} test rows", darth_search._features(
            eng, s_q), laet.params, gb)]
    for row in shapes["gbdt_predict"]:
        print(f"[compete] gbdt_predict {row}", flush=True)
        if row["max_abs_err"] > 1e-5:
            failures.append(f"gbdt_predict disagrees with plain at "
                            f"{row['case']}: {row['max_abs_err']}")
    return out, launches, failures, shapes


def cold_path(ds, index, darth, gt, served, r_targets, tol, card):
    """Phase 8: the cold bucket tier on phase 2's IVF cell and Darth,
    served as phase 5 serves (64 slots, 4 steps a chunk, phase 5's
    targets): full residency in plan order against phase 5's IVF f32 run
    per query; skip honesty on a 256-bucket store (plain_search at
    nprobe = nlist returns the top-10 of the resident rows and counts
    exactly them); then 256 resident buckets (lookahead 4, staging 8)
    in three modes (static, plan, plan + on_boundary) on all test
    queries and on the drifted slice (rank-1 bucket outside the 256 most
    populated). Returns (results, launches by kernel on this path,
    failures, {kernel: [shape rows]})."""
    import numpy as np
    import torch
    from repro_torch.core import darth_search, engines
    from repro_torch.index import flat, ivf, residency
    from repro_torch.kernels import cuda
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serve import DarthServer, cold
    dev = index.device
    nq = ds.queries.shape[0]
    q = torch.as_tensor(ds.queries, device=dev)
    nlist = index.nlist
    # a quarter of the buckets resident: COLD_SLOTS of 1024 at full size,
    # fewer on a smaller index (all resident would leave no drifted slice)
    hot = min(COLD_SLOTS, nlist // 4)
    pred, iv = darth.trained.predictor, darth.interval_for_target
    out = {"card": card, "hot_slots": hot, "lookahead": COLD_LOOKAHEAD,
           "staging": COLD_STAGING, "serves": {}}
    failures = []

    def server(store, **kw):
        return DarthServer(engines.ivf_engine(store, k=10, nprobe=nlist),
                           pred, iv, num_slots=SERVE_SLOTS,
                           steps_per_sync=SERVE_SPS, **kw)

    torch.cuda.synchronize()
    cuda.reset_launches()
    t_start = time.time()
    # 1. full residency, in plan order: phase 5's IVF f32 run per query
    t0 = time.time()
    tier = cold.make_cold_tier(index, hot_slots=nlist)
    store = tier.plan(ds.queries, nprobe=nlist, first=COLD_FIRST)
    torch.cuda.synchronize()
    out["full_tier_s"] = time.time() - t0
    tracer = Tracer()
    res, stats = server(store, tracer=tracer).serve(
        ds.queries, r_targets, on_boundary=tier.on_boundary)
    ref_res, ref_tracer = served["ivf_f32_hosts1_traced"]
    terms, ref_terms = tracer.terminals(), ref_tracer.terminals()
    parity = {
        "completed": stats.completed,
        "ids_differ": sum(not np.array_equal(a[1], b[1])
                          for a, b in zip(res, ref_res)),
        "ndis_differ": sum(terms[i].attrs["ndis"] != ref_terms[i].attrs["ndis"]
                           for i in range(nq)),
        "slot_order_is_plan": bool((tier.slot_bucket
                                    != np.arange(nlist)).any())}
    out["full_residency"] = parity
    print(f"[cold] full residency ({nlist} slots, plan order) vs phase 5: "
          f"{parity}", flush=True)
    if parity["ids_differ"] or parity["ndis_differ"] or \
            stats.completed != nq:
        failures.append(f"cold: full residency differs from phase 5's IVF "
                        f"f32 run: {parity}")
    del tier, store, res, tracer

    # 2. skip honesty on the 256 most populated buckets
    tier = cold.make_cold_tier(index, hot_slots=hot)
    inner = darth_search.plain_search(
        engines.ivf_engine(tier.store, k=10, nprobe=nlist), q)
    sizes = index.bucket_sizes.cpu().numpy()
    resident = int(sizes[tier.slot_bucket].sum())
    rows = tier.store.bucket_ids[tier.store.bucket_ids >= 0].long()
    fd, fi = flat.search(q, torch.as_tensor(ds.base, device=dev)[rows], 10)
    err, agree, ok = topk_agreement(inner.topk_d, inner.topk_i, fd,
                                    rows[fi.long()].to(torch.int32), tol)
    skip = {"resident_rows": resident, "rows_checked": int(rows.shape[0]),
            "ndis_equal_resident": bool((inner.ndis == resident).all()),
            "max_abs_err": err, "id_agreement": agree, "tol": tol}
    out["skip_honesty"] = skip
    print(f"[cold] skip honesty ({hot} slots, nprobe {nlist}) "
          f"{skip}", flush=True)
    if not ok or not skip["ndis_equal_resident"]:
        failures.append(f"cold: skip honesty failed: {skip}")
    del tier, inner, rows, fd, fi

    # 3. 256 resident buckets, three modes, two query sets
    order, _ = ivf.rank_centroids(index.centroids, q,
                                  (q * q).sum(1, keepdim=True), 1)
    top = set(np.argsort(-sizes, kind="stable")[:hot].tolist())
    drifted = np.asarray([i for i, b in enumerate(order[:, 0].tolist())
                          if b not in top], np.int64)
    out["drifted_queries"] = int(drifted.size)
    for set_name, sel in (("all", np.arange(nq)), ("drifted", drifted)):
        if sel.size == 0:
            failures.append("cold: the drifted slice is empty")
            continue
        qs, rts = ds.queries[sel], r_targets[sel]
        gt_s = gt[torch.as_tensor(sel, device=dev)]
        for mode in ("static", "plan", "plan_prefetch"):
            reg = MetricsRegistry()
            t0 = time.time()
            tier = cold.make_cold_tier(index, hot_slots=hot,
                                       lookahead=COLD_LOOKAHEAD,
                                       staging=COLD_STAGING, metrics=reg)
            store = (tier.store if mode == "static" else
                     tier.plan(qs, nprobe=nlist, first=COLD_FIRST))
            torch.cuda.synchronize()
            tier_s = time.time() - t0
            srv = server(store, metrics=reg)
            t0 = time.time()
            res, stats = srv.serve(qs, rts, on_boundary=(
                tier.on_boundary if mode == "plan_prefetch" else None))
            torch.cuda.synchronize()
            row = serve_row(res, stats, time.time() - t0)
            ids = torch.as_tensor(np.stack([r[1] for r in res]), device=dev)
            stage = [1e3 * v for v in tier.stage_seconds]
            row.update(
                queries=int(sel.size), tier_s=tier_s,
                recall=serve_recall(res, gt_s, rts),
                recall_mean=float(flat.recall_at_k(ids, gt_s).mean()),
                prefetches=tier.prefetches, evictions=tier.evictions,
                misses=tier.misses, staged_boundaries=len(stage),
                stage_ms_mean=float(np.mean(stage)) if stage else None,
                stage_ms_max=max(stage) if stage else None,
                stage_ms_total=float(sum(stage)),
                resident_bytes=residency.resident_bytes(
                    tier.store)["total"],
                metrics={fam: reg.counter(f"darth_cold_{fam}_total").value()
                         for fam in ("prefetch", "evictions", "miss")})
            name = f"{set_name}_{mode}"
            out["serves"][name] = row
            print(f"[cold] {name} {row}", flush=True)
            if stats.completed != sel.size or row["returned"] != sel.size:
                failures.append(f"cold {name}: {stats.completed} of "
                                f"{sel.size} completed")
            if row["metrics"] != {"prefetch": tier.prefetches,
                                  "evictions": tier.evictions,
                                  "miss": tier.misses}:
                failures.append(f"cold {name}: the darth_cold_* metrics "
                                f"{row['metrics']} differ from the tier's "
                                f"counters")
        static = out["serves"][f"{set_name}_static"]["recall_mean"]
        full = out["serves"][f"{set_name}_plan_prefetch"]["recall_mean"]
        if full < static:
            flag = (f"{set_name}: plan + prefetch recall {full:.4f} is "
                    f"below static's {static:.4f}")
            out.setdefault("flags", []).append(flag)
            print(f"[cold] FLAG: {flag}", flush=True)
    torch.cuda.synchronize()
    out["full_store_bytes"] = residency.resident_bytes(index)["total"]
    out["wall_s"] = time.time() - t_start
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    print(f"[cold] launches {launches}", flush=True)
    for name, nl in launches.items():
        if nl < 1:
            failures.append(f"kernel {name} was not launched on the cold "
                            f"path")

    # bucket_probe at the cold serve's chunk shape over the last 256-slot
    # store: the pool's queries at their first probe, every fourth slot
    # free, cold buckets masked out as probe_step masks them.
    st = ivf.init_state(tier.store, q[:SERVE_SLOTS], k=10, nprobe=nlist)
    slot = tier.store.hot_map[st.probe_order[:, 0].long()]
    free = torch.arange(SERVE_SLOTS, device=dev) % 4 == 3
    act = (slot >= 0) & ~free
    slot = slot.clamp_min(0).contiguous()
    args = (st.q, tier.store.bucket_vecs, tier.store.bucket_sqnorm,
            tier.store.bucket_ids, slot, act, st.qsq,
            st.topk_d[:, -1:].contiguous(), st.topk_d, st.topk_i)
    row, ok = shape_row_probe(f"cold serve chunk step, {hot}-slot "
                              f"store", tier.store, args, tol,
                              launches["bucket_probe"])
    print(f"[cold] bucket_probe {row}", flush=True)
    if not ok:
        failures.append("bucket_probe disagrees with plain at the cold "
                        "chunk shape")
    return out, launches, failures, {"bucket_probe": [row]}


def cold_shard_path(ds, index, darth, r_targets, phase8, tol, card):
    """Phase 8's [cold-shard] check: phase 8's plan + prefetch serve (all
    test queries, COLD_SLOTS of nlist buckets resident, lookahead 4,
    staging 8, SERVE_SLOTS slots, SERVE_SPS steps a chunk) with the
    tier's store placed at COLD_SHARD_COUNTS shards on cuda:0 and on the
    2 x 2 serve mesh (one host loop, as phase 8 serves), the tier staging
    into every shard's slice. A traced single-device run of the same
    mode (its counters equal to phase 8's row) is the per-query
    reference: every run must serve 0 queries that differ in ids,
    ``ndis``, ``npred`` or terminal reason, with equal prefetch, eviction
    and miss counts. The counts are zeroed after the reference and read
    after the last run; then bucket_probe on shard 0 of the last
    4-shard staged store at the cold chunk's shape, against its plain
    version. Returns (results, launches by kernel, failures, {kernel:
    [shape rows]})."""
    import types

    import numpy as np
    import torch
    from repro_torch import dist
    from repro_torch.core import engines
    from repro_torch.core.padding import pad_dists, pad_ids
    from repro_torch.dist import sharding
    from repro_torch.index import ivf
    from repro_torch.kernels import cuda
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.obs import Tracer
    from repro_torch.serve import DarthServer, cold
    dev = index.device
    nlist = index.nlist
    hot = min(COLD_SLOTS, nlist // 4)
    counts = COLD_SHARD_COUNTS
    out = {"card": card, "hot_slots": hot, "runs": {}}
    failures = []
    if time.time() - T_START > COLD_SHARD_CUT_AT:
        counts = counts[:1]
        out["cut"] = (f"[cold-shard] at {counts[0]} shards only: the script "
                      f"passed {COLD_SHARD_CUT_AT:.0f} s before phase 8's "
                      f"sharded check")
        print(f"[cold-shard] CUT {out['cut']}", flush=True)
    t_start = time.time()

    def serve(name, mesh=None):
        tier = cold.make_cold_tier(index, hot_slots=hot,
                                   lookahead=COLD_LOOKAHEAD,
                                   staging=COLD_STAGING)
        store = tier.plan(ds.queries, nprobe=nlist, first=COLD_FIRST)
        torch.cuda.synchronize()
        t0 = time.time()
        if mesh is None:
            eng = engines.ivf_engine(store, k=10, nprobe=nlist)
        else:
            store = dist.place_index(store, mesh)
            eng = engines.sharded_ivf_engine(store, mesh, k=10,
                                             nprobe=nlist)
        torch.cuda.synchronize()
        place_s = time.time() - t0
        tracer = Tracer()
        srv = DarthServer(eng, darth.trained.predictor,
                          darth.interval_for_target, num_slots=SERVE_SLOTS,
                          steps_per_sync=SERVE_SPS, tracer=tracer, mesh=mesh)
        t0 = time.time()
        res, stats = srv.serve(ds.queries, r_targets,
                               on_boundary=tier.on_boundary)
        torch.cuda.synchronize()
        row = serve_row(res, stats, time.time() - t0, tracer)
        stage = [1e3 * v for v in tier.stage_seconds]
        row.update(
            mesh=None if mesh is None else mesh_lib.describe(mesh),
            groups=len(srv._group_index), place_s=place_s,
            prefetches=tier.prefetches, evictions=tier.evictions,
            misses=tier.misses, staged_boundaries=len(stage),
            stage_ms_mean=float(np.mean(stage)) if stage else None,
            stage_ms_max=max(stage) if stage else None,
            placed_store=isinstance(tier.store, sharding.PlacedIVFIndex))
        return res, tracer.terminals(), row, tier

    ref_res, ref_terms, ref_row, _ = serve("single_device")
    keys = ("prefetches", "evictions", "misses", "engine_steps",
            "ndis_harvested", "refills", "completed")
    ref_row["equal_to_phase8"] = {k: ref_row[k] == phase8[k] for k in keys}
    out["runs"]["single_device"] = ref_row
    print(f"[cold-shard] single_device {ref_row}", flush=True)
    if not all(ref_row["equal_to_phase8"].values()):
        failures.append(f"cold-shard: the traced single-device run differs "
                        f"from phase 8's: {ref_row['equal_to_phase8']}")
    torch.cuda.synchronize()
    cuda.reset_launches()
    meshes = [(f"{s}_shards", mesh_lib.make_search_mesh(s, dev))
              for s in counts]
    meshes.append(("mesh_2x2", mesh_lib.make_serve_mesh(2, 2, dev)))
    tier = None
    for name, mesh in meshes:
        res, terms, row, tier_run = serve(name, mesh)
        if name == f"{counts[-1]}_shards":
            tier = tier_run
        row["differ"] = {
            "ids": sum(not np.array_equal(a[1], b[1])
                       for a, b in zip(res, ref_res)),
            "ndis": sum(terms[i].attrs["ndis"] != ref_terms[i].attrs["ndis"]
                        for i in ref_terms),
            "decisions": sum(
                (terms[i].attrs.get("npred"), terms[i].attrs["reason"])
                != (ref_terms[i].attrs.get("npred"),
                    ref_terms[i].attrs["reason"]) for i in ref_terms),
            "counts": [k for k in ("prefetches", "evictions", "misses")
                       if row[k] != ref_row[k]]}
        row["phase8_stage_ms"] = [phase8["stage_ms_mean"],
                                  phase8["stage_ms_max"]]
        out["runs"][name] = row
        print(f"[cold-shard] {name} {row}", flush=True)
        if any(row["differ"].values()) or not row["placed_store"] or \
                row["completed"] != len(ref_res):
            failures.append(f"cold-shard {name} differs from the "
                            f"single-device serve: {row['differ']}")
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    print(f"[cold-shard] launches {launches}", flush=True)
    # the served path's kernels (its centroid ranking is no l2_topk call)
    for name in ("bucket_probe", "gbdt_predict"):
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the "
                            f"sharded cold path")
    out["wall_s"] = time.time() - t_start
    if failures:
        return out, launches, failures, {}

    # bucket_probe on shard 0 of the last staged placed store, at the cold
    # chunk's shape (the pool's queries at their first probe, every fourth
    # slot free, cold buckets masked out as the sharded step masks them).
    store = tier.store
    q = torch.as_tensor(ds.queries[:SERVE_SLOTS], device=dev)
    st = ivf.init_state(store, q, k=10, nprobe=nlist)
    slot = store.hot_map[st.probe_order[:, 0].long()]
    free = torch.arange(SERVE_SLOTS, device=dev) % 4 == 3
    act = (slot >= 0) & ~free
    slot = slot.clamp_min(0).to(torch.int32).contiguous()
    shard = types.SimpleNamespace(cap=store.bucket_vecs[0].shape[1],
                                  bucket_vecs=store.bucket_vecs[0],
                                  bucket_ids=store.bucket_ids[0])
    args = (st.q, store.bucket_vecs[0], store.bucket_sqnorm[0],
            store.bucket_ids[0], slot, act, st.qsq,
            st.topk_d[:, -1:].contiguous(),
            pad_dists((SERVE_SLOTS, 10), dev),
            pad_ids((SERVE_SLOTS, 10), dev))
    case = (f"sharded cold chunk step, shard 0 of {counts[-1]}, "
            f"{hot}-slot store")
    row, ok = shape_row_probe(case, shard, args, tol,
                              launches["bucket_probe"])
    row["shape"] = (f"B={SERVE_SLOTS} store[{hot},{shard.cap},"
                    f"{index.dim}] f32 k=10")
    print(f"[cold-shard] bucket_probe {row}", flush=True)
    if not ok:
        failures.append(f"bucket_probe disagrees with plain at {case}")
    out["wall_s"] = time.time() - t_start
    return out, launches, failures, {"bucket_probe": [row]}


def audit_path(card, device="cuda"):
    """Phase 11: the port's static gate on the card. ``run_gate("cuda")``
    (the pad lint over the tree, then every registered entry point at its
    small and large sizes on this card) must give zero findings, the
    known-bad corpus must be detected (``run_selftest``), and the serving
    loop's host syncs, counted by the recorder and by PyTorch under
    ``torch.cuda.set_sync_debug_mode("warn")``, must equal the CPU's per
    call site and in total, with no kernel build after the first chunk.
    The counts are zeroed before the gate and read after it; then
    l2_topk, bucket_probe and gbdt_predict at the gate's own shapes (its
    int8 l2_topk and SQ8 bucket_probe entries, its predictor on a chunk
    of 8 slots), against their plain versions. Returns (results,
    launches by kernel, failures, {kernel: [shape rows]})."""
    import torch
    from repro_torch.analysis import manifest, runner
    from repro_torch.analysis.__main__ import run_selftest
    from repro_torch.analysis.findings import format_findings
    from repro_torch.core.padding import pad_dists, pad_ids
    from repro_torch.kernels import cuda, ref
    from repro_torch.analysis.audits import one_device
    dev = one_device(device)
    out = {"card": card}
    failures = []
    t_start = time.time()
    torch.cuda.synchronize()
    cuda.reset_launches()
    findings = runner.run_gate(dev)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    out.update(gate_s=time.time() - t_start, findings=len(findings),
               launches=launches)
    print(f"[audit] gate: {len(findings)} finding(s) in "
          f"{out['gate_s']:.1f}s, launches {launches}", flush=True)
    if findings:
        print(format_findings(findings), flush=True)
        failures.append(f"audit: {len(findings)} finding(s)")
    t0 = time.time()
    errors = run_selftest(dev)
    out.update(selftest_s=time.time() - t0, selftest_errors=errors)
    if errors:
        failures.append(f"audit: selftest {errors}")
    t0 = time.time()
    cpu = manifest.sync_loop_counts("cpu")
    card_counts = manifest.sync_loop_counts(dev, sync_debug=True)
    out["sync_s"] = time.time() - t0
    out["syncs"] = {}
    for name, row in cpu.items():
        got = card_counts[name]
        cmp = {"cpu_total": row["total"], "card_total": got["total"],
               "card_debug_total": got["debug_total"],
               "chunks": [row["chunks"], got["chunks"]],
               "sites_equal": row["sites"] == got["sites"]
               == got["debug_sites"] == manifest.SYNC_LIMITS[name],
               "nvcc_after_first_chunk": got["nvcc_after_first_chunk"],
               "sites": got["debug_sites"]}
        out["syncs"][name] = cmp
        print(f"[audit] syncs {name} {cmp}", flush=True)
        if not (cmp["sites_equal"] and row["total"] == got["total"]
                == got["debug_total"]) or got["nvcc_after_first_chunk"]:
            failures.append(f"audit: the card's host syncs differ from the "
                            f"CPU's in {name}: {cmp}")
    for name, n in launches.items():
        if n < 1:
            failures.append(f"kernel {name} was not launched by the gate")

    # Each kernel at the gate's shapes, against its plain version.
    shapes = {}
    n, d = manifest.SIZES["small"]
    index = manifest._make_ivf(n, d, dev, sq8=True)
    q = manifest._queries(d, dev)
    codes = index.bucket_vecs.reshape(-1, d)
    keep = index.bucket_ids.reshape(-1) >= 0
    codes, sqn = codes[keep].contiguous(), index.bucket_sqnorm.reshape(-1)[
        keep].contiguous()
    qe = (q * index.scale).contiguous()
    d_k, i_k = cuda.l2_topk(qe, codes, sqn, 10)
    d_r, i_r = ref.l2_topk_ref(qe, codes, sqn, 10)
    ltol = 1e-3 + 1e-5 * float(sqn.max())
    err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, ltol)
    row = shape_row_l2("gate entry kernels/l2_topk, int8 codes", qe, codes,
                       sqn, 10, launches["l2_topk"], 20)
    row.update(max_abs_err=err, id_agreement=agree, tol=ltol)
    shapes["l2_topk"] = [row]
    print(f"[audit] l2_topk {row}", flush=True)
    if not ok:
        failures.append("l2_topk disagrees with plain at the gate's shape")
    b = q.shape[0]
    slot = torch.arange(b, device=dev, dtype=torch.int32)
    args = (qe, index.bucket_vecs, index.bucket_sqnorm, index.bucket_ids,
            slot, torch.ones((b,), dtype=torch.bool, device=dev),
            (q * q).sum(1, keepdim=True), pad_dists((b, 1), dev),
            pad_dists((b, 10), dev), pad_ids((b, 10), dev))
    row, ok = shape_row_probe("gate entry kernels/bucket_probe, SQ8 store",
                              index, args, ltol, launches["bucket_probe"])
    shapes["bucket_probe"] = [row]
    print(f"[audit] bucket_probe {row}", flush=True)
    if not ok:
        failures.append("bucket_probe disagrees with plain at the gate's "
                        "shape")
    p = manifest._predictor(dev).params
    feats = torch.rand((b, 11), generator=torch.Generator().manual_seed(0)
                       ).to(dev)
    row = shape_row_gbdt("gate serve chunk, 8 slots", feats, p,
                         launches["gbdt_predict"])
    shapes["gbdt_predict"] = [row]
    print(f"[audit] gbdt_predict {row}", flush=True)
    if row["max_abs_err"] > 1e-5:
        failures.append("gbdt_predict disagrees with plain at the gate's "
                        "shape")
    out["wall_s"] = time.time() - t_start
    print(f"[audit] phase 11 took {out['wall_s']:.1f}s", flush=True)
    return out, launches, failures, shapes


def sharded_path(ds, index, darth, results, served, r_targets, gt, tol,
                 card, hnsw_fitted):
    """Phase 9: the sharded IVF path on phase 2's index and Darth, for
    each shard count in SHARD_COUNTS with every shard on cuda:0 (the
    one-controller mesh): place_index (seconds, resident bytes per
    shard); the sharded flat search at the fit shape (the learn queries
    x the collection), ids and distances equal to flat.search's;
    ivf.search_sharded on the test queries, ids and counters equal to
    ivf.search's; Darth.search through sharded_ivf_engine with phase 2's
    predictor at each target, every decision equal to phase 2's. At 4
    shards the DarthServer over the mesh, equal per query to phase 5's
    hosts-1 IVF f32 run; at 2 shards Darth.fit(mesh=) on SHARD_FIT_LEARN
    learn queries, its step log and trees equal to an unsharded fit's.
    Each placement is freed before the next. Then the sharded HNSW graph
    (``shard_hnsw``), a mutable view under a mesh (``shard_mutable``)
    and the serve mesh's hosts axis (``shard_hosts``). The counts are
    zeroed after the IVF single-device references and read after the
    last check, less the launches of the single-device references run
    in between; then l2_topk and bucket_probe are held against their
    plain versions on shard 0's slice at each shard count above 1, and
    l2_topk on shard 0 of the sharded HNSW fit's ground truth. Returns
    (results, launches by kernel on this path, failures, {kernel: [shape
    rows]})."""
    import types

    import numpy as np
    import torch
    from repro_torch import dist
    from repro_torch.core import api, engines
    from repro_torch.core.padding import PAD_SQNORM, pad_dists, pad_ids
    from repro_torch.dist import collectives, sharding
    from repro_torch.index import flat, ivf
    from repro_torch.kernels import cuda, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import DarthServer
    dev = index.device
    nq, nlist = ds.queries.shape[0], index.nlist
    q = torch.as_tensor(ds.queries, device=dev)
    ql = torch.as_tensor(ds.learn, device=dev)
    xb = torch.as_tensor(ds.base, device=dev)
    out = {"card": card, "device": str(dev), "shards": {},
           "phase2_ground_truth_s": darth.fit_seconds["ground_truth"]}
    failures = []
    t_start = time.time()
    # single-device references, outside the counted run
    torch.cuda.synchronize()
    t0 = time.time()
    ref_fd, ref_fi = flat.search(ql, xb, 10)
    torch.cuda.synchronize()
    out["flat_search_s"] = time.time() - t0
    _, _, single = ivf.search(index, q, k=10, nprobe=nlist)
    sub = ds.learn[:SHARD_FIT_LEARN]
    d_plain = api.Darth(make_engine=None, engine=darth.engine)
    d_plain.fit(sub, ds.base)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t_drive = time.time()
    for nshards in SHARD_COUNTS:
        before = dict(cuda.LAUNCHES)
        mesh = mesh_lib.make_search_mesh(nshards, dev)
        row = {"mesh": mesh_lib.describe(mesh)}
        torch.cuda.synchronize()
        t0 = time.time()
        placed = dist.place_index(index, mesh)
        torch.cuda.synchronize()
        row["place_s"] = time.time() - t0
        row["cap"] = placed.cap
        row["shard_bytes"] = [
            sum(t[j].numel() * t[j].element_size()
                for t in (placed.bucket_vecs, placed.bucket_ids,
                          placed.bucket_sqnorm)) for j in range(nshards)]
        t0 = time.time()
        fd, fi = collectives.sharded_flat_search(ql, xb, 10, mesh)
        torch.cuda.synchronize()
        row["flat"] = {"s": time.time() - t0,
                       "ids_differ": int((fi != ref_fi).any(1).sum()),
                       "dists_equal": torch.equal(fd, ref_fd)}
        del fd, fi
        t0 = time.time()
        _, _, st = ivf.search_sharded(placed, q, k=10, nprobe=nlist,
                                      mesh=mesh)
        torch.cuda.synchronize()
        row["search_sharded"] = {"s": time.time() - t0, "differ": int((
            (st.topk_i != single.topk_i).any(1)
            | (st.topk_d != single.topk_d).any(1)
            | (st.ndis != single.ndis) | (st.ninserts != single.ninserts)
            | (st.probe_pos != single.probe_pos)).sum())}
        sd = api.Darth(make_engine=None, trained=darth.trained,
                       engine=engines.sharded_ivf_engine(
                           placed, mesh, k=10, nprobe=nlist))
        row["darth"] = {}
        for rt in TARGETS:
            ids, st, secs = timed_search(sd, q, rt)
            r = darth_row(ids, st, secs, gt, nq)
            r["differ_from_phase2"] = same_decisions((ids, st),
                                                     results[rt][:2])
            row["darth"][str(rt)] = r
        if nshards == 4:
            srv = DarthServer(sd.engine, darth.trained.predictor,
                              darth.interval_for_target,
                              num_slots=SERVE_SLOTS,
                              steps_per_sync=SERVE_SPS, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.time()
            res, stats = srv.serve(ds.queries, r_targets)
            torch.cuda.synchronize()
            row["serve"] = serve_row(res, stats, time.time() - t0)
            row["serve"]["recall"] = serve_recall(res, gt, r_targets)
            row["serve"]["differ_from_phase5"] = same_results(served, res)
            del srv, res
        if nshards == 2:
            fitted = api.Darth(make_engine=None, engine=sd.engine)
            t0 = time.time()
            fitted.fit(sub, ds.base, mesh=mesh)
            pa, pb = fitted.trained.predictor.params, \
                d_plain.trained.predictor.params
            row["fit"] = {
                "learn": SHARD_FIT_LEARN, "s": time.time() - t0,
                "split_s": fitted.fit_seconds,
                "unsharded_split_s": d_plain.fit_seconds,
                "log_equal": all(np.array_equal(
                    getattr(fitted._last_log, f),
                    getattr(d_plain._last_log, f))
                    for f in ("features", "recall", "ndis", "valid")),
                "trees_equal": all(torch.equal(getattr(pa, f),
                                               getattr(pb, f))
                                   for f in ("feat", "thresh", "leaf",
                                             "base"))}
            del fitted, pa, pb
        row["launches"] = {k: cuda.LAUNCHES[k] - before[k]
                           for k in cuda.LAUNCHES}
        del placed, sd, st, ids
        torch.cuda.empty_cache()
        out["shards"][str(nshards)] = row
        print(f"[shard] {nshards} shards {row}", flush=True)
        bad = []
        if row["flat"]["ids_differ"] or not row["flat"]["dists_equal"]:
            bad.append(f"flat search {row['flat']}")
        if row["search_sharded"]["differ"]:
            bad.append(f"search_sharded {row['search_sharded']}")
        for rt, r in row["darth"].items():
            if r["differ_from_phase2"]:
                bad.append(f"Darth.search at {rt}: "
                           f"{r['differ_from_phase2']} queries")
        if "serve" in row and (row["serve"]["differ_from_phase5"]
                               or row["serve"]["completed"] != nq):
            bad.append(f"served {row['serve']}")
        if "fit" in row and not (row["fit"]["log_equal"]
                                 and row["fit"]["trees_equal"]):
            bad.append(f"Darth.fit(mesh=) {row['fit']}")
        if bad:
            failures.append(f"sharded path, {nshards} shards, differs from "
                            f"the single-device path: " + "; ".join(bad))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()   # the IVF part
    excluded = {name: 0 for name in cuda.LAUNCHES}

    def reference(fn, *args, **kwargs):
        """A single-device reference run, left out of the path's counts."""
        before = dict(cuda.LAUNCHES)
        res = fn(*args, **kwargs)
        for name in excluded:
            excluded[name] += cuda.LAUNCHES[name] - before[name]
        return res

    hnsw_q = (SHARD_HNSW_Q if time.time() - T_START <= SHARD_SLOW_AT
              else SHARD_HNSW_Q_SLOW)
    out["cuts"] = shard_cuts(hnsw_q)
    for line in out["cuts"]:
        print(f"[shard] CUT: {line}", flush=True)
    hd = hnsw_fitted["darth"]
    for name, part in (
            ("hnsw", lambda: shard_hnsw(ds, hd, reference, hnsw_q)),
            ("mutable", lambda: shard_mutable(ds, index, darth, reference)),
            ("hosts", lambda: shard_hosts(ds, index, darth, hd, served,
                                          r_targets, reference, hnsw_q))):
        t0 = time.time()
        row, bad = part()
        row["wall_s"] = time.time() - t0
        out[name] = row
        failures += bad
        print(f"[shard] {name} took {row['wall_s']:.1f}s", flush=True)
    launches = {name: cuda.LAUNCHES[name] - excluded[name]
                for name in cuda.LAUNCHES}
    out["drive_s"] = time.time() - t_drive
    out["launches"] = launches
    out["reference_launches"] = excluded
    print(f"[shard] launches_by_path['sharded'] {launches} (single-device "
          f"references left out: {excluded}); IVF part's peak bytes "
          f"{out['peak_bytes']}", flush=True)
    for name in launches:
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the sharded "
                            f"path")
    if failures:
        return out, launches, failures, {}

    # Each kernel at the new shapes, against its plain version: l2_topk on
    # shard 0's rows at the fit shape (1024 learn queries, as phase 3),
    # bucket_probe on shard 0's store at the rank-1 fit shape (256 learn
    # queries on their second bucket, an empty running list and the
    # incoming k-th, as the sharded step passes them).
    shapes = {"l2_topk": [], "bucket_probe": []}
    qg = ql[:1024]
    xsq = (xb ** 2).sum(1)
    s0 = ivf.init_state(index, ql[:256], k=10, nprobe=nlist)
    s1 = ivf.probe_step(index, s0)
    slot = s1.probe_order[:, 1].contiguous()
    act = torch.ones_like(s1.active)
    kth = s1.topk_d[:, -1:].contiguous()
    for nshards in SHARD_COUNTS[1:]:
        mesh = mesh_lib.make_search_mesh(nshards, dev)
        row_launch = out["shards"][str(nshards)]["launches"]
        xs = sharding.database_shards(xb, mesh)
        sqs = sharding.database_shards(xsq, mesh, PAD_SQNORM)
        case = f"sharded fit ground truth, shard 0 of {nshards}"
        d_k, i_k = cuda.l2_topk(qg, xs[0], sqs[0], 10)
        d_r, i_r = ref.l2_topk_ref(qg, xs[0], sqs[0], 10)
        ltol = 1e-3 + 1e-5 * float(xsq.max())
        err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, ltol)
        row = shape_row_l2(case, qg, xs[0], sqs[0], 10,
                           row_launch["l2_topk"], 5)
        row.update(max_abs_err=err, id_agreement=agree, tol=ltol)
        shapes["l2_topk"].append(row)
        print(f"[shard] l2_topk {row}", flush=True)
        if not ok:
            failures.append(f"l2_topk disagrees with plain at {case}")
        del xs, sqs, d_k, i_k, d_r, i_r
        placed = dist.place_index(index, mesh)
        store = types.SimpleNamespace(
            cap=placed.bucket_vecs[0].shape[1],
            bucket_vecs=placed.bucket_vecs[0],
            bucket_ids=placed.bucket_ids[0])
        pargs = (s1.q, placed.bucket_vecs[0], placed.bucket_sqnorm[0],
                 placed.bucket_ids[0], slot, act, s1.qsq, kth,
                 pad_dists((256, 10), dev), pad_ids((256, 10), dev))
        case = f"sharded rank-1 fit shape, shard 0 of {nshards}"
        row, ok = shape_row_probe(case, store, pargs, tol,
                                  row_launch["bucket_probe"])
        row["shape"] = (f"B=256 store[{nlist},{store.cap},"
                        f"{index.dim}] f32 k=10")
        shapes["bucket_probe"].append(row)
        print(f"[shard] bucket_probe {row}", flush=True)
        if not ok:
            failures.append(f"bucket_probe disagrees with plain at {case}")
        del placed, store, pargs
        torch.cuda.empty_cache()
    # l2_topk on shard 0 of the sharded HNSW fit's ground truth (2
    # shards of the graph's rows, SHARD_FIT_LEARN learn queries)
    mesh = mesh_lib.make_search_mesh(2, dev)
    xh = xb[:hd.engine.index.num_vectors]
    xs = sharding.database_shards(xh, mesh)
    sqs = sharding.database_shards((xh ** 2).sum(1), mesh, PAD_SQNORM)
    qf = ql[:SHARD_FIT_LEARN]
    case = "sharded HNSW fit ground truth, shard 0 of 2"
    d_k, i_k = cuda.l2_topk(qf, xs[0], sqs[0], 10)
    d_r, i_r = ref.l2_topk_ref(qf, xs[0], sqs[0], 10)
    ltol = 1e-3 + 1e-5 * float(sqs[0].max())
    err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, ltol)
    row = shape_row_l2(case, qf, xs[0], sqs[0], 10,
                       out["hnsw"]["fit"]["launches"]["l2_topk"], 5)
    row.update(max_abs_err=err, id_agreement=agree, tol=ltol)
    shapes["l2_topk"].append(row)
    print(f"[shard] l2_topk {row}", flush=True)
    if not ok:
        failures.append(f"l2_topk disagrees with plain at {case}")
    del xs, sqs, d_k, i_k, d_r, i_r
    torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t_start
    return out, launches, failures, shapes

def differ_hnsw(a, b):
    """Queries whose ids, distances, ndis, ninserts or nstep differ
    between two HNSW searches (d, i, state)."""
    (da, ia, sa), (db, ib, sb) = a, b
    return int(((ia != ib).any(1) | (da != db).any(1)
                | (sa.ndis != sb.ndis) | (sa.ninserts != sb.ninserts)
                | (sa.nstep != sb.nstep)).sum())


def shard_hnsw(ds, hd, reference, hnsw_q):
    """Phase 9, HNSW: phase 4's graph placed at each of SHARD_COUNTS on
    cuda:0 (750,000 rows pad to 750,001 at 7 shards), with place
    seconds, bytes a shard and the peak memory of each count;
    hnsw.search_sharded on the first ``hnsw_q`` test queries against
    hnsw.search, exact and (at SHARD_HASH_COUNTS) with the hashed
    filter SHARD_HASH_W wide, every id, distance and counter equal; at
    7 shards the hashed filter must raise. At 2 shards Darth.search
    through sharded_hnsw_engine with phase 4's predictor, every
    decision equal to phase 4's Darth on the same queries, and
    Darth.fit(mesh=) on SHARD_FIT_LEARN learn queries, its step log and
    trees equal to an unsharded fit's. Returns (row, failures)."""
    import numpy as np
    import torch
    from repro_torch import dist
    from repro_torch.core import api, engines
    from repro_torch.index import hnsw
    from repro_torch.kernels import cuda
    from repro_torch.launch import mesh as mesh_lib
    graph = hd.engine.index
    dev = graph.device
    n = graph.num_vectors
    qh = torch.as_tensor(ds.queries[:hnsw_q], device=dev)
    kw = dict(k=10, ef=384)
    failures = []
    single = reference(hnsw.search, graph, qh, **kw)
    hashed = reference(hnsw.search, graph, qh, visited_width=SHARD_HASH_W,
                       **kw)
    ref_darth = {rt: reference(timed_search, hd, qh, rt) for rt in TARGETS}
    sub = ds.learn[:SHARD_FIT_LEARN]
    d_plain = api.Darth(make_engine=None, engine=hd.engine)
    reference(d_plain.fit, sub, ds.base[:n])
    out = {"rows": n, "queries": hnsw_q, "shards": {}}
    for nshards in SHARD_COUNTS:
        before = dict(cuda.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh = mesh_lib.make_search_mesh(nshards, dev)
        t0 = time.time()
        placed = dist.place_index(graph, mesh)
        torch.cuda.synchronize()
        row = {"place_s": time.time() - t0, "rows": placed.num_vectors,
               "shard_bytes": [sum(t[j].numel() * t[j].element_size()
                                   for t in (placed.vectors, placed.sqnorm,
                                             placed.neighbors))
                               for j in range(nshards)]}
        t0 = time.time()
        got = hnsw.search_sharded(placed, qh, mesh=mesh, **kw)
        torch.cuda.synchronize()
        row["search_sharded"] = {"s": time.time() - t0,
                                 "differ": differ_hnsw(got, single)}
        del got
        if nshards in SHARD_HASH_COUNTS:
            t0 = time.time()
            got = hnsw.search_sharded(placed, qh, mesh=mesh,
                                      visited_width=SHARD_HASH_W, **kw)
            torch.cuda.synchronize()
            row["hashed"] = {"s": time.time() - t0,
                             "differ": differ_hnsw(got, hashed)}
            del got
        else:
            try:
                hnsw.search_sharded(placed, qh, mesh=mesh,
                                    visited_width=SHARD_HASH_W, **kw)
                row["hashed"] = {"raised": False}
            except ValueError:
                row["hashed"] = {"raised": True}
        if nshards == 2:
            sd = api.Darth(make_engine=None, trained=hd.trained,
                           engine=engines.sharded_hnsw_engine(
                               placed, mesh, max_steps=1200, **kw))
            row["darth"] = {}
            for rt in TARGETS:
                ids, st, secs = timed_search(sd, qh, rt)
                row["darth"][str(rt)] = {
                    "wall_s": secs, "qps": hnsw_q / secs,
                    "npred": float(st.npred.float().mean()),
                    "differ_from_phase4": same_decisions(
                        (ids, st), ref_darth[rt][:2])}
            fit_before = dict(cuda.LAUNCHES)
            fitted = api.Darth(make_engine=None, engine=sd.engine)
            t0 = time.time()
            fitted.fit(sub, ds.base[:n], mesh=mesh)
            pa, pb = (fitted.trained.predictor.params,
                      d_plain.trained.predictor.params)
            row["fit"] = {
                "learn": SHARD_FIT_LEARN, "s": time.time() - t0,
                "split_s": fitted.fit_seconds,
                "unsharded_split_s": d_plain.fit_seconds,
                "launches": {k: cuda.LAUNCHES[k] - fit_before[k]
                             for k in cuda.LAUNCHES},
                "log_equal": all(np.array_equal(
                    getattr(fitted._last_log, f),
                    getattr(d_plain._last_log, f))
                    for f in ("features", "recall", "ndis", "valid")),
                "trees_equal": all(torch.equal(getattr(pa, f),
                                               getattr(pb, f))
                                   for f in ("feat", "thresh", "leaf",
                                             "base"))}
            out["fit"] = row["fit"]
            del sd, fitted, pa, pb
        torch.cuda.synchronize()
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        row["launches"] = {k: cuda.LAUNCHES[k] - before[k]
                           for k in cuda.LAUNCHES}
        del placed
        torch.cuda.empty_cache()
        out["shards"][str(nshards)] = row
        print(f"[shard] hnsw {nshards} shards {row}", flush=True)
        bad = []
        if row["search_sharded"]["differ"]:
            bad.append(f"search_sharded {row['search_sharded']}")
        if row["hashed"].get("differ") or row["hashed"].get("raised") is \
                False:
            bad.append(f"hashed filter {row['hashed']}")
        for rt, r in row.get("darth", {}).items():
            if r["differ_from_phase4"]:
                bad.append(f"Darth.search at {rt}: "
                           f"{r['differ_from_phase4']} queries")
        if "fit" in row and not (row["fit"]["log_equal"]
                                 and row["fit"]["trees_equal"]):
            bad.append(f"Darth.fit(mesh=) {row['fit']}")
        if bad:
            failures.append(f"sharded HNSW, {nshards} shards, differs from "
                            f"the single-device path: " + "; ".join(bad))
    if "fit" not in out:
        failures.append("sharded HNSW: Darth.fit(mesh=) did not run")
    return out, failures


def shard_mutable(ds, index, darth, reference):
    """Phase 9, a mutable view under a mesh: a new MutableIndex over phase
    2's index with phase 6's HNSW-sized burst (HNSW_MUTATE_INS /
    HNSW_MUTATE_DEL of N, drift MUTATE_DRIFT, drawn as phase 6 draws),
    the view placed at each of SHARD_MUT_COUNTS on cuda:0. Darth.search
    with phase 2's predictor through mutable_engine(sharded_ivf_engine)
    equals the unsharded mutable engine's per query at each target and
    returns no deleted id; then compact(), refresh_placed_view(base=,
    delta=), and the same again. Phase 2's index must be unchanged.
    Returns (row, failures)."""
    import torch
    from repro_torch import dist, mutate
    from repro_torch.core import api, engines
    from repro_torch.data import vectors
    from repro_torch.launch import mesh as mesh_lib
    dev = index.device
    n = ds.base.shape[0]
    q = torch.as_tensor(ds.queries, device=dev)
    kw = dict(k=10, nprobe=index.nlist)
    frozen = {name: getattr(index, name).clone() for name in
              ("bucket_ids", "bucket_sqnorm", "bucket_sizes")}
    cap = max(10, -(-int(round(HNSW_MUTATE_INS * n)) // 128) * 128)
    mut = mutate.MutableIndex(index, capacity=cap)
    t0 = time.time()
    mut.apply(vectors.mutation_stream(ds, HNSW_MUTATE_INS, HNSW_MUTATE_DEL,
                                      drift=MUTATE_DRIFT, steps=4, seed=1))
    torch.cuda.synchronize()
    out = {"delta_capacity": cap, "apply_s": time.time() - t0,
           "delta_live": mut.num_delta,
           "tombstones": int(len(mut.deleted_ids)), "steps": {}}
    failures = []
    meshes = {s: mesh_lib.make_search_mesh(s, dev) for s in SHARD_MUT_COUNTS}
    views = {}

    def darth_over(base, delta, mesh=None):
        eng = (engines.ivf_engine(base, **kw) if mesh is None
               else engines.sharded_ivf_engine(base, mesh, **kw))
        return api.Darth(make_engine=None, trained=darth.trained,
                         engine=engines.mutable_engine(eng, delta))

    def check(step):
        dead = torch.as_tensor(mut.deleted_ids, device=dev)
        single = darth_over(mut.base, mut.delta)
        want = {rt: reference(timed_search, single, q, rt) for rt in TARGETS}
        rows = {}
        for s, mesh in meshes.items():
            sd = darth_over(views[s].base, views[s].delta, mesh)
            assert sd.engine.name == "ivf-sharded+delta"
            r = {}
            for rt in TARGETS:
                ids, st, secs = timed_search(sd, q, rt)
                r[str(rt)] = {
                    "wall_s": secs, "qps": q.shape[0] / secs,
                    "differ": same_decisions((ids, st), want[rt][:2]),
                    "deleted_returned": int(torch.isin(ids, dead).sum())}
                if r[str(rt)]["differ"] or r[str(rt)]["deleted_returned"]:
                    failures.append(f"mutable view {step}, {s} shards, "
                                    f"target {rt}: {r[str(rt)]}")
            rows[str(s)] = r
        out["steps"][step] = rows
        print(f"[shard] mutable {step} {rows}", flush=True)

    for s, mesh in meshes.items():
        torch.cuda.synchronize()
        t0 = time.time()
        views[s] = dist.place_index(mut.view(), mesh)
        torch.cuda.synchronize()
        out[f"place_s_{s}"] = time.time() - t0
    check("after_burst")
    t0 = time.time()
    mut.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.time() - t0
    for s, mesh in meshes.items():
        t0 = time.time()
        views[s] = dist.refresh_placed_view(views[s], mesh, base=mut.base,
                                            delta=mut.delta)
        torch.cuda.synchronize()
        out[f"refresh_s_{s}"] = time.time() - t0
    check("after_compaction")
    out["phase2_index_unchanged"] = all(
        torch.equal(getattr(index, name), t) for name, t in frozen.items())
    if not out["phase2_index_unchanged"]:
        failures.append("mutable view: phase 2's index changed")
    del views, mut
    torch.cuda.empty_cache()
    return out, failures


def shard_hosts(ds, index, darth, hd, served, r_targets, reference,
                hnsw_q):
    """Phase 9, the serve mesh's hosts axis: DarthServer on
    make_serve_mesh(2, 2, cuda:0) with hosts 2 over phase 2's index
    placed on that mesh, serving phase 5's IVF f32 stream (its queries
    and targets) twice: with the launcher's SERVE_SLOTS slots split over
    the two host groups, and with SERVE_SLOTS slots in each group (each
    group then steps phase 5's batch shape); both equal per query to
    phase 5's hosts-1 run. Then the first ``hnsw_q`` queries on phase
    4's graph at hosts 2 x 2 shards (SERVE_SLOTS a group), equal to a
    single-device serve of the same queries at SERVE_SLOTS slots.
    Returns (row, failures)."""
    import torch
    from repro_torch import dist
    from repro_torch.core import engines
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import DarthServer
    dev = index.device
    nq = ds.queries.shape[0]
    mesh = mesh_lib.make_serve_mesh(2, 2, dev)
    out = {"mesh": mesh_lib.describe(mesh), "runs": {}}
    failures = []

    def serve(name, engine, d, queries, rts, want, slots, **kw):
        srv = DarthServer(engine, d.trained.predictor, d.interval_for_target,
                          num_slots=slots, steps_per_sync=SERVE_SPS, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        res, stats = srv.serve(queries, rts)
        torch.cuda.synchronize()
        row = serve_row(res, stats, time.time() - t0)
        row.update(slots=slots, groups=len(srv._group_index))
        if want is not None:
            row["differ"] = same_results(want, res)
            if row["differ"] or row["completed"] != len(queries):
                failures.append(f"hosts mesh {name}: {row}")
        out["runs"][name] = row
        print(f"[shard] hosts {name} {row}", flush=True)
        return res

    t0 = time.time()
    placed = dist.place_index(index, mesh)
    torch.cuda.synchronize()
    out["place_s"] = time.time() - t0
    out["shared_store"] = all(a is b for v in placed.host_views for a, b in
                              zip(v.bucket_vecs, placed.bucket_vecs))
    if not out["shared_store"]:
        failures.append("hosts mesh: the host groups copied the store")
    eng = engines.sharded_ivf_engine(placed, mesh, k=10, nprobe=index.nlist)
    for slots in (SERVE_SLOTS, 2 * SERVE_SLOTS):
        serve(f"ivf_f32_{slots}_slots", eng, darth, ds.queries, r_targets,
              served, slots, mesh=mesh, hosts=2)
    del placed, eng
    graph = hd.engine.index
    qh, rh = ds.queries[:hnsw_q], r_targets[:hnsw_q]
    single = reference(serve, "hnsw_single_device", hd.engine, hd, qh, rh,
                       None, SERVE_SLOTS)
    placed = dist.place_index(graph, mesh)
    eng = engines.sharded_hnsw_engine(placed, mesh, k=10, ef=384,
                                      max_steps=1200)
    serve("hnsw", eng, hd, qh, rh, single, 2 * SERVE_SLOTS, mesh=mesh,
          hosts=2)
    del placed, eng
    torch.cuda.empty_cache()
    out["queries"] = {"ivf": nq, "hnsw": hnsw_q}
    return out, failures


def quickstart_path(card):
    """Phase 10: ``repro_torch.examples.quickstart.main()`` at its own size
    (30,000 x 32, nlist 128, 2,000 learn and 256 test queries, targets
    0.80-0.99), which prints its table. Every target's recall must reach
    target - TOL and every kernel must run. Returns (results, launches by
    kernel, failures)."""
    import torch
    from repro_torch.examples import quickstart
    from repro_torch.kernels import cuda
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.time()
    res = quickstart.main()
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    out = {"card": card, "wall_s": time.time() - t0, "launches": launches,
           "plain": res["plain"],
           "targets": {str(t): r for t, r in res["targets"].items()}}
    print(f"[quickstart] {out}", flush=True)
    failures = [f"quickstart: recall {r['recall']:.4f} below target {t} - "
                f"{TOL}" for t, r in res["targets"].items()
                if r["recall"] < t - TOL]
    failures += [f"kernel {name} was not launched by the quickstart"
                 for name, n in launches.items() if n < 1]
    return out, launches, failures


def _tree_to(tree, device):
    """A parameter tree's copy on ``device``."""
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _sliced(tree, n):
    """The first n layers of a parameter tree's stacked blocks (views)."""
    return {k: (_sliced(v, n) if isinstance(v, dict) else v[:n])
            for k, v in tree.items()}


def _lm_sizes(params):
    from repro_torch.models import model_zoo
    leaves = [a for _, a in model_zoo.leaves(params)]
    return {"params": sum(a.numel() for a in leaves),
            "bytes": sum(a.numel() * a.element_size() for a in leaves)}


def _max_err(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def _timed_prefill(cfg, params, batch, warm=None):
    """``prefill`` on ``batch``, after a warm-up on ``warm`` where given:
    (its last logits, {batch, seq, wall_s, tokens_per_s, peak_bytes,
    finite})."""
    import torch
    from repro_torch.models import model_zoo
    if warm is not None:
        model_zoo.prefill(cfg, params, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    last = model_zoo.prefill(cfg, params, batch)
    torch.cuda.synchronize()
    wall = time.time() - t0
    b, s = batch["tokens"].shape
    return last, {"batch": b, "seq": s, "wall_s": wall,
                  "tokens_per_s": b * s / wall,
                  "peak_bytes": torch.cuda.max_memory_allocated(),
                  "finite": bool(torch.isfinite(last).all())}


def _cache_dtypes(cache):
    from repro_torch.models import model_zoo
    return {"/".join(path): str(a.dtype).split(".")[-1]
            for path, a in model_zoo.leaves(cache)}


def _consistency(logits, reference, bound, top1=True):
    """Two logit tensors of one model, [rows, vocab] (the decode's against
    prefill's, or the card's against the CPU's): the largest error,
    whether every logit lies within ``bound`` of the reference's (atol /
    rtol), and in how many rows the top-1 tokens are equal. ``ok`` needs
    every logit within the bound and, with ``top1`` (the reference's
    decode-vs-prefill check), the top-1 token equal in every row."""
    import torch
    a, b = logits.float().cpu(), reference.float().cpu()
    within = bool(torch.allclose(a, b, **bound))
    rows = int((a.argmax(-1) == b.argmax(-1)).sum())
    return {"max_abs_err": _max_err(a, b), "bound": bound,
            "within_bound": within, "top1_equal_rows": rows,
            "rows": a.shape[0],
            "ok": within and (rows == a.shape[0] or not top1)}


def _decode_check(cfg, params, batch, n_prompt, cache):
    """The first ``n_prompt`` tokens of ``batch`` through ``decode_step``
    from ``cache``, and the last step's logits against ``prefill``'s on
    the same tokens (``_consistency`` at the reference's bound): (the
    logits, the cache, {consistency, prompt_ms_per_token,
    cache_dtypes_after_step})."""
    import torch
    from repro_torch.models import model_zoo
    toks = batch["tokens"]
    torch.cuda.synchronize()
    t0 = time.time()
    for t in range(n_prompt):
        logits, cache = model_zoo.decode_step(cfg, params, cache,
                                              toks[:, t:t + 1], t)
        if t == 0:
            dtypes = _cache_dtypes(cache)
    torch.cuda.synchronize()
    prompt_ms = 1e3 * (time.time() - t0) / n_prompt
    head = {k: (v[:, :n_prompt] if k == "tokens" else v)
            for k, v in batch.items()}
    check = dict(_consistency(logits, model_zoo.prefill(cfg, params, head),
                              LM_CONSISTENCY),
                 layers=cfg.num_layers, position=n_prompt - 1)
    return logits, cache, {"consistency": check,
                           "prompt_ms_per_token": prompt_ms,
                           "cache_dtypes_after_step": dtypes}


def _serve_lm(tag, cfg, params, batch, decode, cache=None, warm=None):
    """The serving check of phases 12 and 13 on one model: the timed
    ``prefill`` of ``batch`` (``_timed_prefill``); with ``decode`` =
    (n_prompt, n_new, s_max), its first n_prompt tokens through
    ``decode_step`` from ``cache`` (an empty one of s_max where None)
    against prefill's on them (``_decode_check``), then n_new greedy
    tokens (ms a token).
    Returns (results: prefill, consistency, decode, cache dtypes after
    step 0; failures: non-finite logits). The caller gates
    ``consistency``."""
    import torch
    from repro_torch.models import model_zoo
    n_prompt, n_new, s_max = decode
    b = batch["tokens"].shape[0]
    if cache is None:
        cache = model_zoo.make_cache(cfg, b, s_max, device="cuda")
    last, prefill = _timed_prefill(cfg, params, batch, warm)
    if not prefill["finite"]:
        return {"prefill": prefill}, [f"{tag}: prefill gave non-finite "
                                      f"logits"]
    del last
    logits, cache, check = _decode_check(cfg, params, batch, n_prompt, cache)
    tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.time()
    for t in range(n_new):
        logits, cache = model_zoo.decode_step(cfg, params, cache, tok,
                                              n_prompt + t)
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    steps = {"batch": b, "s_max": s_max,
              "prompt_ms_per_token": check.pop("prompt_ms_per_token"),
              "greedy_ms_per_token": 1e3 * (time.time() - t0) / n_new,
              "finite": bool(torch.isfinite(logits).all())}
    out = dict(check, prefill=prefill, decode=steps)
    return out, ([] if steps["finite"]
                 else [f"{tag}: decode gave non-finite logits"])


def _vs_cpu(cfg, params, batch, bound, tf32_control=False):
    """The card against the port's CPU path on the same weights and
    batch: the hidden state (``forward``) and the last logits
    (``prefill``), the logits held to ``bound`` (``_consistency``; the
    top-1 rows are printed, not gated: bf16 rounding on two devices may
    swap a near tie). With ``tf32_control``, the card's prefill once more
    with TF32 matmuls allowed (a card path of lower precision than the
    sound one; the setting is restored): its reading under the same
    bound."""
    import torch
    from repro_torch.models import model_zoo
    on_card = model_zoo.forward(cfg, params, batch, remat=False)[0]
    logits_card = model_zoo.prefill(cfg, params, batch)
    control = None
    if tf32_control:
        with _tf32():
            control = model_zoo.prefill(cfg, params, batch)
    t0 = time.time()
    cpu_params = _tree_to(params, "cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    on_cpu = model_zoo.forward(cfg, cpu_params, cpu_batch,
                                remat=False)[0]
    logits_cpu = model_zoo.prefill(cfg, cpu_params, cpu_batch)
    out = dict(_consistency(logits_card, logits_cpu, bound, top1=False),
               layers=cfg.num_layers, batch=batch["tokens"].shape[0],
               seq=batch["tokens"].shape[1], cpu_s=time.time() - t0,
               hidden_max_abs_err=_max_err(on_card, on_cpu),
               hidden_atol_cpu_tests=LM_HIDDEN_ATOL,
               logits_atol_cpu_tests=LM_LOGIT_ATOL)
    if control is not None:
        out["tf32_control"] = _consistency(control, logits_cpu, bound,
                                           top1=False)
    return out


def _vs_cpu_f32(cfg, params, batch, bound):
    """The card against the port's CPU path on the same weights and batch
    with the model computing in f32 (``_compute_f32``): the last logits
    (``prefill``) held to ``bound``, and the card's prefill once more with
    TF32 matmuls allowed (the control), which must lie outside it: a
    bound the control meets could not see a precision fault."""
    from repro_torch.models import model_zoo
    with _compute_f32():
        card = model_zoo.prefill(cfg, params, batch)
        with _tf32():
            control = model_zoo.prefill(cfg, params, batch)
        cpu = model_zoo.prefill(cfg, _tree_to(params, "cpu"),
                                {k: v.cpu() for k, v in batch.items()})
    out = dict(_consistency(card, cpu, bound, top1=False),
               layers=cfg.num_layers, batch=batch["tokens"].shape[0],
               seq=batch["tokens"].shape[1],
               logits_max_abs=float(cpu.abs().max()),
               tf32_control=_consistency(control, cpu, bound, top1=False))
    out["ok"] = out["ok"] and not out["tf32_control"]["within_bound"]
    return out


@contextlib.contextmanager
def _tf32():
    """TF32 matmuls allowed inside, restored to off after: the control
    that the card-vs-CPU checks of the f32 paths should see."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def _compute_f32():
    """The LM computes in f32 inside (``model_zoo.COMPUTE``, which every
    block follows), in bf16 again after: the same model without bf16's
    rounding, so that card against CPU sees the f32 products' precision."""
    import torch
    from repro_torch.models import model_zoo
    was, model_zoo.COMPUTE = model_zoo.COMPUTE, torch.float32
    try:
        yield
    finally:
        model_zoo.COMPUTE = was


def _linear_attn_vs_cpu(cfg, seq):
    """``chunked_linear_attention`` alone, on the card and on the CPU, on
    the same seeded f32 inputs at one layer of ``cfg``'s shapes (B 1 x
    ``seq``). rwkv6: H heads of 64 with per-channel decays, strict, with
    the bonus ``u`` at its init 0.5; zamba2: the Mamba heads, keys of
    d_state broadcast over them, one decay per head, inclusive. Decays
    are drawn so a chunk's |logp| reaches the model's own range. The
    logits cannot see the recurrence's f32 einsums (bf16 rounding sets
    their gap); this can: the largest error relative to the output's
    largest value, sound and with TF32 matmuls allowed (the control)."""
    import torch
    from repro_torch.models import linear_attn, transformer
    gen = torch.Generator().manual_seed(1)

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    if cfg.family == "ssm":
        h = cfg.num_heads
        dk = dv = cfg.d_model // h
        q, k, v = normal(1, seq, h, dk), normal(1, seq, h, dk), normal(
            1, seq, h, dv)
        log_w = -torch.exp(normal(1, seq, h, dk) * 0.5 - 0.5)
        kw = {"u": torch.full((h, dk), 0.5)}
    else:
        dims = transformer.mamba_dims(cfg)
        h, dk, dv = dims.num_heads, dims.d_state, dims.head_dim
        q = normal(1, seq, 1, dk).expand(1, seq, h, dk)
        k = normal(1, seq, 1, dk).expand(1, seq, h, dk)
        v = normal(1, seq, h, dv)
        log_w = -linear_attn.softplus(normal(1, seq, h, 1) - 2.0).expand(
            1, seq, h, dk)
        kw = {}

    def run(device):
        on = [a.to(device) for a in (q, k, v, log_w)]
        y, s = linear_attn.chunked_linear_attention(
            *on, **{n: a.to(device) for n, a in kw.items()})
        return torch.cat([y.flatten(), s.flatten()]).cpu()

    want = run("cpu")
    got = run("cuda")
    with _tf32():
        control = run("cuda")
    scale = float(want.abs().max())
    return {"batch": 1, "seq": seq, "heads": h, "dk": dk, "dv": dv,
            "rel_err": _max_err(got, want) / scale,
            "tf32_control_rel_err": _max_err(control, want) / scale,
            "rel_limit": FAM_LA_REL}


def _lm_init(cfg):
    """``cfg``'s parameters from ``init_params(seed=0)`` on the card, and
    their count, bytes and init seconds."""
    import torch
    from repro_torch.models import model_zoo
    t0 = time.time()
    params = model_zoo.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    return params, dict(_lm_sizes(params), init_s=time.time() - t0)


def _seeded_tokens(cfg, shape, gen):
    import torch
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         dtype=torch.int32).cuda()


def lm_dense(card):
    """Phase 12, [lm]: smollm-360m at its registered width (32 layers,
    d_model 960, 15 / 5 heads, head_dim 64, d_ff 2560, vocab 49152, tied)
    from ``init_params(seed=0)`` on the card, through ``_serve_lm``:
    prefill on LM_PREFILL seeded tokens, a LM_DECODE[0]-token prompt
    through ``decode_step`` then LM_DECODE[1] greedy tokens at S_max
    LM_DECODE[2], the decode's logits at the prompt's last position
    against prefill's on the same tokens (the reference's consistency
    bound, top-1 equal), and the card against the port's CPU path on the
    same weights at LM_VS_CPU (the same bound). Returns (results,
    failures)."""
    import torch
    from repro_torch import configs
    cfg = configs.get_config(LM_ARCH)
    params, sizes = _lm_init(cfg)
    b, s = LM_PREFILL
    toks = _seeded_tokens(cfg, (b, s), torch.Generator().manual_seed(0))
    served, failures = _serve_lm("lm", cfg, params, {"tokens": toks},
                                 LM_DECODE, warm={"tokens": toks[:1, :128]})
    out = dict({"card": card}, **sizes, **served)
    if not failures and not out["consistency"]["ok"]:
        failures.append(f"lm: decode logits at position {LM_DECODE[0] - 1} "
                        f"outside the reference's bound of prefill's: "
                        f"{out['consistency']}")
    vb, vs = LM_VS_CPU
    out["vs_cpu"] = _vs_cpu(cfg, params, {"tokens": toks[:vb, :vs]},
                            LM_CONSISTENCY)
    if not out["vs_cpu"]["ok"]:
        failures.append(f"lm: the card's logits outside the reference's "
                        f"bound of the CPU's: {out['vs_cpu']}")
    del params
    torch.cuda.empty_cache()
    print(f"[lm] {cfg.name} {out}", flush=True)
    return out, failures


def lm_moe(card, layers):
    """Phase 12, [lm-moe]: qwen3-moe-30b-a3b at its registered width (d_model
    2048, 32 / 4 heads, head_dim 128, 128 experts top-8, expert d_ff 768,
    vocab 151936) with its depth cut to ``layers`` of 48: prefill on
    MOE_PREFILL seeded tokens (drop fraction and aux loss from
    ``forward``), MOE_DECODE tokens through ``decode_step`` from an empty
    cache, and the card against the CPU path at 1 layer on MOE_VS_CPU.
    Returns (results, failures)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo
    full = configs.get_config(MOE_ARCH)
    cfg = full.scaled(num_layers=layers)
    params, sizes = _lm_init(cfg)
    out, failures = dict({"card": card, "layers": layers}, **sizes), []
    print(f"[lm-moe] CUT {cfg.name}: {layers} of {full.num_layers} layers "
          f"at full width ({out['params'] / 1e9:.2f} B parameters, "
          f"{out['bytes'] / 1e9:.1f} GB in f32; all 48 would need "
          f"~{out['bytes'] / layers * full.num_layers / 1e9:.0f} GB, more "
          f"than the card holds)", flush=True)
    b, s = MOE_PREFILL
    toks = _seeded_tokens(cfg, (b, s), torch.Generator().manual_seed(1))
    last, out["prefill"] = _timed_prefill(cfg, params, {"tokens": toks},
                                          warm={"tokens": toks[:1, :64]})
    _, _, metrics = model_zoo.forward(cfg, params, {"tokens": toks},
                                       remat=False)
    out["prefill"].update(moe_drop_frac=float(metrics["moe_drop_frac"]),
                          moe_aux_loss=float(metrics["moe_aux_loss"]))
    cache = model_zoo.make_cache(cfg, b, MOE_DECODE, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    for t in range(MOE_DECODE):
        logits, cache = model_zoo.decode_step(cfg, params, cache,
                                              toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    first = model_zoo.prefill(cfg, params, {"tokens": toks[:, :MOE_DECODE]})
    out["decode"] = {"batch": b, "tokens": MOE_DECODE, "s_max": MOE_DECODE,
                     "ms_per_token": 1e3 * (time.time() - t0) / MOE_DECODE,
                     "finite": bool(torch.isfinite(logits).all()),
                     "vs_prefill_max_abs_err": _max_err(logits, first)}
    if not (out["prefill"]["finite"] and out["decode"]["finite"]):
        failures.append(f"lm-moe: non-finite logits {out}")
    del cache, last, first

    vb, vs = MOE_VS_CPU
    one = full.scaled(num_layers=1)
    p1 = dict(params, blocks=_sliced(params["blocks"], 1))
    small = toks[:vb, :vs]
    on_card = model_zoo.forward(one, p1, {"tokens": small},
                                remat=False)[0]
    logits_card = model_zoo.prefill(one, p1, {"tokens": small})
    t0 = time.time()
    cpu_params = _tree_to(p1, "cpu")
    del params, p1
    torch.cuda.empty_cache()
    on_cpu = model_zoo.forward(one, cpu_params, {"tokens": small.cpu()},
                               remat=False)[0]
    logits_cpu = model_zoo.prefill(one, cpu_params, {"tokens": small.cpu()})
    rows_off = int(((on_card.float().cpu() - on_cpu.float()).abs()
                    > LM_HIDDEN_ATOL).any(-1).sum())
    out["vs_cpu"] = {
        "layers": 1, "batch": vb, "seq": vs, "cpu_s": time.time() - t0,
        "hidden_max_abs_err": _max_err(on_card, on_cpu),
        "hidden_rows_beyond_atol": rows_off, "hidden_atol": LM_HIDDEN_ATOL,
        "logits_max_abs_err": _max_err(logits_card, logits_cpu),
        "logits_atol": MOE_LOGIT_ATOL}
    if (rows_off > MOE_FLIPPED_ROWS
            or out["vs_cpu"]["logits_max_abs_err"] > MOE_LOGIT_ATOL):
        failures.append(f"lm-moe: the card outside the CPU tests' "
                        f"tolerances of the CPU: {out['vs_cpu']}")
    del cpu_params
    print(f"[lm-moe] {cfg.name} {out}", flush=True)
    return out, failures


def rag_kernel_shapes(res, launches):
    """l2_topk, bucket_probe and gbdt_predict at the RAG path's own shapes
    (D = the LM's width), each against its plain version on the same
    inputs and timed beside its bound: l2_topk at the k-means assignment
    (the corpus x the centroids, k = 1), the fit's ground truth (the learn
    queries x the corpus, k = K) and the recall check's (the requests x
    the corpus); bucket_probe at the serve's first chunk step (SLOTS
    requests at probe rank 1) and at a fit batch's (256 learn queries);
    gbdt_predict on that chunk's feature rows and on the fit's hold-out.
    Returns ({kernel: [shape rows]}, failures)."""
    import torch
    from repro_torch.core import darth_search
    from repro_torch.examples import rag_serve
    from repro_torch.index import ivf
    from repro_torch.kernels import cuda, ref
    index, darth = res["index"], res["darth"]
    x = torch.as_tensor(res["corpus"], device="cuda")
    xsq = (x * x).sum(1)
    # Phase 3's tolerance, held at D <= 128, scaled by the depth of the
    # sum: the kernel's split-TF32 products accumulate in the tensor cores,
    # whose f32 accumulate truncates, so its error grows with the number
    # of mma steps (3 a k-step of 8), linearly in D.
    tol = 1e-3 + 1e-5 * float(xsq.max()) * max(1.0, x.shape[1] / 128)
    cents = index.centroids
    shapes = {"l2_topk": [], "bucket_probe": [], "gbdt_predict": []}
    failures = []
    for case, qq, xx, sq, kk in (
            ("rag k-means assignment", x, cents, (cents * cents).sum(1), 1),
            ("rag fit ground truth", torch.as_tensor(
                res["learn_q"], device="cuda"), x, xsq, rag_serve.K),
            ("rag recall check ground truth", torch.as_tensor(
                res["req_emb"], device="cuda"), x, xsq, rag_serve.K)):
        d_k, i_k = cuda.l2_topk(qq, xx, sq, kk)
        d_r, i_r = ref.l2_topk_ref(qq, xx, sq, kk)
        err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, tol)
        row = shape_row_l2(case, qq, xx, sq, kk, launches["l2_topk"], 20,
                           plain_reps=5)
        row.update(max_abs_err=err, id_agreement=agree, tol=tol)
        shapes["l2_topk"].append(row)
        print(f"[rag] l2_topk {row}", flush=True)
        if not ok:
            failures.append(f"l2_topk disagrees with plain at {case}")
    for case, qs in (("rag serve chunk step", res["req_emb"][
            :rag_serve.SLOTS]), ("rag fit batch", res["learn_q"][:256])):
        qt = torch.as_tensor(qs, device="cuda")
        st = ivf.probe_step(index, ivf.init_state(
            index, qt, k=rag_serve.K, nprobe=index.nlist))
        args = (st.q, index.bucket_vecs, index.bucket_sqnorm,
                index.bucket_ids, st.probe_order[:, 1].contiguous(),
                st.active, st.qsq, st.topk_d[:, -1:].contiguous(),
                st.topk_d, st.topk_i)
        btol = 1e-3 + 1e-5 * float(torch.nan_to_num(
            index.bucket_sqnorm, posinf=0).max())
        row, ok = shape_row_probe(case, index, args, btol,
                                  launches["bucket_probe"])
        shapes["bucket_probe"].append(row)
        print(f"[rag] bucket_probe {row}", flush=True)
        if not ok:
            failures.append(f"bucket_probe disagrees with plain at {case}")
        if case == "rag serve chunk step":
            feats = darth_search._features(darth.engine, st).contiguous()
    log = darth._last_log
    nf = log.features.shape[-1]
    valid = log.features.reshape(-1, nf)[log.valid.reshape(-1)]
    hold = torch.as_tensor(valid[:max(1, int(0.1 * valid.shape[0]))],
                           device="cuda")
    for case, xx in (("rag serve chunk, the pool's feature rows", feats),
                     ("rag fit hold-out", hold)):
        row = shape_row_gbdt(case, xx, darth.trained.predictor.params,
                             launches["gbdt_predict"])
        shapes["gbdt_predict"].append(row)
        print(f"[rag] gbdt_predict {row}", flush=True)
        if row["max_abs_err"] > 1e-5:
            failures.append(f"gbdt_predict disagrees with plain at {case}: "
                            f"{row['max_abs_err']}")
    return shapes, failures


def _rag_recall(res):
    """Per target: (mean recall@K of the served ids against exact ground
    truth from the PLAIN version, so the kernel does not check itself, and
    its standard error over the target's requests)."""
    import numpy as np
    import torch
    from repro_torch.examples import rag_serve
    from repro_torch.index import flat
    from repro_torch.kernels import ref
    q = torch.as_tensor(res["req_emb"], device="cuda")
    x = torch.as_tensor(res["corpus"], device="cuda")
    _, gt = ref.l2_topk_ref(q, x, (x * x).sum(1), rag_serve.K)
    ids = torch.as_tensor(np.stack([r[1] for r in res["results"]]),
                          device="cuda")
    rec = flat.recall_at_k(ids, gt).cpu().numpy()
    return {str(t): (float(rec[i::2].mean()), float(
        rec[i::2].std() / np.sqrt(rec[i::2].size)))
        for i, t in enumerate(rag_serve.TARGETS)}


def rag_path(card):
    """Phase 12, [rag]: ``repro_torch.examples.rag_serve.main`` with the
    LM at smollm-360m's registered width and everything else at the
    example's own sizes (8,000 documents x 24 tokens, nlist 64, 512 learn
    queries, 64 requests at 0.80 / 0.95, k 5, 32 slots). The counts are
    zeroed just before and read just after; every kernel must have run.
    Then the same path with RAG_GATE_REQUESTS requests: its first 64 must
    be served as the example's own, and each target's mean recall must
    reach target - TOL against exact ground truth from the plain version.
    Then each kernel at the path's own shapes. Returns (results, launches
    by kernel, failures, {kernel: [shape rows]})."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.examples import rag_serve
    from repro_torch.kernels import cuda
    cfg = configs.get_config(LM_ARCH)
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.time()
    res = rag_serve.main(cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    out = {"card": card, "wall_s": time.time() - t0, "launches": launches,
           "seconds": res["seconds"], "generated": res["generated"],
           "stats": {k: getattr(res["stats"], k) for k in (
               "completed", "engine_steps", "refills", "ndis_harvested")},
           "dim": int(res["corpus"].shape[1]), "nlist": res["index"].nlist,
           "cap": res["index"].cap,
           "recall_printed": {str(t): r for t, r in res["recall"].items()},
           "recall_vs_plain_gt": _rag_recall(res)}
    failures = [f"kernel {name} was not launched by the RAG path"
                for name, n in launches.items() if n < 1]
    print(f"[rag] {out}", flush=True)
    for t, (r, se) in out["recall_vs_plain_gt"].items():
        if r < float(t) - TOL:
            print(f"[rag] FLAG: the example's 64 requests reach recall "
                  f"{r:.4f} at target {t}, below target - {TOL}, with a "
                  f"standard error of {se:.4f} (the gate below serves "
                  f"{RAG_GATE_REQUESTS} requests)", flush=True)

    t0 = time.time()
    big = rag_serve.main(cfg=cfg, n_req=RAG_GATE_REQUESTS, device="cuda")
    torch.cuda.synchronize()
    n = len(res["results"])
    gate = {"requests": RAG_GATE_REQUESTS, "wall_s": time.time() - t0,
            "recall_vs_plain_gt": _rag_recall(big),
            "first_requests_differ": sum(
                not np.array_equal(a[1], b[1])
                for a, b in zip(res["results"], big["results"][:n]))}
    out["gate"] = gate
    print(f"[rag] gate {gate}", flush=True)
    if gate["first_requests_differ"]:
        failures.append(f"rag: {gate['first_requests_differ']} of the first "
                        f"{n} requests served otherwise in the larger run")
    for t, (r, _) in gate["recall_vs_plain_gt"].items():
        if r < float(t) - TOL:
            failures.append(f"rag: recall {r:.4f} over {RAG_GATE_REQUESTS} "
                            f"requests below target {t} - {TOL}")
    del big
    shapes, more = rag_kernel_shapes(res, launches)
    return out, launches, failures + more, shapes


def lm_phase(card):
    """Phase 12: [lm], [lm-moe] and [rag]. Past MOE_CUT_AT seconds of the
    script [lm-moe] runs MOE_LAYERS_CUT layers (a CUT line says so).
    Returns (results, rag launches by kernel, failures, {kernel: [shape
    rows]})."""
    import torch
    t_start = time.time()
    out = {"matmul_settings": {
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}}
    print(f"[lm] matmul settings {out['matmul_settings']}", flush=True)
    out["lm"], failures = lm_dense(card)
    layers = MOE_LAYERS
    if t_start - T_START > MOE_CUT_AT:
        layers = MOE_LAYERS_CUT
        print(f"[lm-moe] CUT to {layers} layers: the script had run "
              f"{t_start - T_START:.0f} s of its 1200 s when phase 12 began "
              f"(past {MOE_CUT_AT:.0f} s)", flush=True)
    out["lm_moe"], more = lm_moe(card, layers)
    failures += more
    out["rag"], launches, more, shapes = rag_path(card)
    failures += more
    out["wall_s"] = time.time() - t_start
    print(f"[lm] phase 12 took {out['wall_s']:.1f}s", flush=True)
    return out, launches, failures, shapes


def _family_slice(params, cfg):
    """The parameters of ``cfg``'s depth (an RWKV or zamba config scaled
    down from the one ``params`` was made for), as views: the first
    layers of the blocks, or the first groups and tail layers."""
    if cfg.family == "ssm":
        return dict(params, blocks=_sliced(params["blocks"], cfg.num_layers))
    n_groups, tail = divmod(cfg.num_layers, cfg.attn_every)
    out = {k: v for k, v in params.items() if k != "tail"}
    out["groups"] = _sliced(params["groups"], n_groups)
    if tail:
        out["tail"] = _sliced(params["tail"], tail)
    return out


def _max_logp(cfg, params, batch):
    """The largest |logp| (a chunk's summed log-decay) of any chunk of the
    linear attention in one ``prefill`` of ``batch``, and the number of
    chunks: read in a run of its own, outside the timed prefill."""
    import torch
    from repro_torch.models import linear_attn, model_zoo
    linear_attn.LOGP_MAX = []
    try:
        model_zoo.prefill(cfg, params, batch)
        return (float(torch.stack(linear_attn.LOGP_MAX).max()),
                len(linear_attn.LOGP_MAX))
    finally:
        linear_attn.LOGP_MAX = None


def lm_recurrent(card, arch, tag, cut):
    """Phase 13, [lm-ssm] / [lm-hybrid]: ``arch`` at its registered width
    and depth (``cut``: the first FAM_CUT_LAYERS of them, with a CUT
    line) from ``init_params(seed=0)`` on the card, through ``_serve_lm``: prefill on
    FAM_PREFILL seeded tokens (wall, tokens/s; the largest |logp| of any
    chunk read in a prefill of its own), a FAM_DECODE[0]-token prompt
    through ``decode_step`` then FAM_DECODE[1] greedy tokens at S_max
    FAM_DECODE[2]. At this depth the decode's logits at the prompt's last
    position against prefill's are printed, with a FLAG line outside the
    reference's bound: there the reference's own decode misses it too
    (tests/test_torch_models.py::test_*_decode_prefill_gap_at_depth_is_
    the_references). The gates run at full width and
    FAM_GATE_LAYERS[arch] layers: the decode against prefill on the same
    prompt (the reference's bound, top-1 equal), the card against the
    port's CPU path on the same weights on FAM_VS_CPU with the model
    computing in f32 (``_vs_cpu_f32``: logits within FAM_F32_BOUND, the
    TF32 control outside it; as shipped, bf16, printed beside its own
    TF32 control), and the chunked linear
    attention alone on the card against the CPU within FAM_LA_REL
    (``_linear_attn_vs_cpu``; a FLAG line where its TF32 control lies
    within it too). Returns (results, failures)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo
    full = configs.get_config(arch)
    cfg = full.scaled(num_layers=FAM_CUT_LAYERS[arch]) if cut else full
    # The cut model is the full init's first layers, so the gates below
    # see the same weights whether the phase was cut or not.
    params, sizes = _lm_init(full)
    if cut:
        params = _family_slice(params, cfg)
        sizes.update(_lm_sizes(params))
    out = dict({"card": card, "layers": cfg.num_layers,
                "d_model": cfg.d_model}, **sizes)
    if cut:
        print(f"[{tag}] CUT {arch}: {cfg.num_layers} of {full.num_layers} "
              f"layers at full width: the script had run past "
              f"{FAM_CUT_AT:.0f} s of its 1200 s", flush=True)
    print(f"[{tag}] {arch}: {out['params']:,} parameters, "
          f"{out['bytes'] / 1e9:.2f} GB in f32", flush=True)
    toks = _seeded_tokens(cfg, FAM_PREFILL, torch.Generator().manual_seed(0))
    served, failures = _serve_lm(tag, cfg, params, {"tokens": toks},
                                 FAM_DECODE, warm={"tokens": toks[:1, :64]})
    out.update(served)
    if failures:
        return out, failures
    out["prefill"]["max_abs_logp"], out["prefill"]["chunks"] = _max_logp(
        cfg, params, {"tokens": toks})
    out["cache_dtypes_empty"] = _cache_dtypes(model_zoo.make_cache(
        cfg, 1, 1, device="cuda"))
    print(f"[{tag}] prefill {out['prefill']}", flush=True)
    depth = out["consistency"]
    if not depth["ok"]:
        print(f"[{tag}] FLAG: at {cfg.num_layers} layers the decode's "
              f"logits at position {depth['position']} lie "
              f"{depth['max_abs_err']:.4f} from prefill's, top-1 equal in "
              f"{depth['top1_equal_rows']} of {depth['rows']} rows: outside "
              f"the reference's bound, as the reference's own decode is at "
              f"this depth on the CPU; gated at {FAM_GATE_LAYERS[arch]} "
              f"layers below", flush=True)

    # The gates, at full width and FAM_GATE_LAYERS[arch] layers.
    small_cfg = full.scaled(num_layers=FAM_GATE_LAYERS[arch])
    sp = _family_slice(params, small_cfg)
    prompt = {"tokens": toks[:, :FAM_DECODE[0]]}
    _, _, gate = _decode_check(small_cfg, sp, prompt, FAM_DECODE[0],
                               model_zoo.make_cache(small_cfg, FAM_PREFILL[0],
                                                    FAM_DECODE[2],
                                                    device="cuda"))
    out["consistency_gate"] = gate = gate["consistency"]
    if not gate["ok"]:
        failures.append(f"{tag}: decode logits at position "
                        f"{gate['position']} outside the reference's bound "
                        f"of prefill's at {small_cfg.num_layers} layers: "
                        f"{gate}")
    vb, vs = FAM_VS_CPU
    head = {"tokens": toks[:vb, :vs]}
    out["vs_cpu"] = v = _vs_cpu(small_cfg, sp, head, FAM_VS_CPU_BOUND,
                                tf32_control=True)
    print(f"[{tag}] vs_cpu as shipped (bf16; printed, not gated): logits "
          f"{v['max_abs_err']:.4f} from the CPU's, TF32 control "
          f"{v['tf32_control']['max_abs_err']:.4f}", flush=True)
    out["vs_cpu_f32"] = v = _vs_cpu_f32(small_cfg, sp, head, FAM_F32_BOUND)
    print(f"[{tag}] vs_cpu computing in f32 (gated): logits "
          f"{v['max_abs_err']:.3e} from the CPU's, TF32 control "
          f"{v['tf32_control']['max_abs_err']:.3e}, limit "
          f"{FAM_F32_BOUND['atol']}", flush=True)
    if not v["ok"]:
        failures.append(f"{tag}: computing in f32, the card's logits lie "
                        f"outside {FAM_F32_BOUND} of the CPU's, or their "
                        f"TF32 control inside it: {v}")
    out["linear_attn_vs_cpu"] = la = _linear_attn_vs_cpu(cfg, FAM_PREFILL[1])
    if la["rel_err"] > FAM_LA_REL:
        failures.append(f"{tag}: the card's chunked linear attention lies "
                        f"outside {FAM_LA_REL} (relative) of the CPU's: {la}")
    if la["tf32_control_rel_err"] <= FAM_LA_REL:
        print(f"[{tag}] FLAG: the TF32 control of the chunked linear "
              f"attention lies within {FAM_LA_REL} of the CPU's: {la}",
              flush=True)
    del params, sp
    torch.cuda.empty_cache()
    print(f"[{tag}] {arch} {out}", flush=True)
    return out, failures


def lm_audio(card):
    """Phase 13, [lm-audio]: whisper-base at its registered width and depth
    (6 encoder and 6 decoder layers, d_model 512, 8 heads, GELU MLP, vocab
    51865, 1500 frames of 512) from ``init_params(seed=0)`` on the card:
    ``encode_audio`` on AUDIO_BATCH x 1500 seeded stub frames (timed after
    a warm-up prefill); the cross cache filled from the encoder output,
    layer by layer ((enc @ bf16(cross.wk[l])) as [B, T, Hkv, Dh], and wv);
    then ``_serve_lm``: ``prefill`` on the frames and AUDIO_TOKENS decoder
    tokens, the decode at position 0 from the filled cache against a
    1-token prefill on the same frames (the reference adds position 0's
    encoding at every decode step, so only position 0 compares; the
    reference's bound, top-1 equal), and AUDIO_DECODE greedy tokens at
    S_max AUDIO_TOKENS; and the card against the CPU path at full depth
    on AUDIO_VS_CPU (FAM_VS_CPU_BOUND; a TF32 control beside it).
    Returns (results, failures)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo, transformer
    cfg = configs.get_config(AUDIO_ARCH)
    tag = "lm-audio"
    params, sizes = _lm_init(cfg)
    out = dict({"card": card}, **sizes)
    print(f"[{tag}] {AUDIO_ARCH}: {out['params']:,} parameters, "
          f"{out['bytes'] / 1e9:.3f} GB in f32", flush=True)
    gen = torch.Generator().manual_seed(0)
    b, s, nf = AUDIO_BATCH, AUDIO_TOKENS, cfg.frontend_len
    toks = _seeded_tokens(cfg, (b, s), gen)
    frames = torch.randn((b, nf, cfg.frontend_dim), generator=gen
                         ).to(torch.bfloat16).cuda()
    model_zoo.prefill(cfg, params, {"tokens": toks[:1, :8],
                                    "frames": frames[:1]})   # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    enc = model_zoo.encode_audio(cfg, params, frames)
    torch.cuda.synchronize()
    enc_s = time.time() - t0
    out["encode"] = {"batch": b, "frames": nf, "wall_s": enc_s,
                     "frames_per_s": b * nf / enc_s,
                     "finite": bool(torch.isfinite(enc).all())}
    if not out["encode"]["finite"]:
        return out, [f"{tag}: non-finite encoder output"]
    dims = transformer.attn_dims(cfg)
    cache = model_zoo.make_cache(cfg, b, s, device="cuda")
    for name, w in (("ck", "wk"), ("cv", "wv")):
        for l in range(cfg.num_layers):
            cache[name][l] = (enc @ params["blocks"]["cross"][w][l].to(
                torch.bfloat16)).reshape(b, nf, dims.num_kv_heads,
                                         dims.head_dim)
    del enc
    served, failures = _serve_lm(tag, cfg, params,
                                 {"tokens": toks, "frames": frames},
                                 (1, AUDIO_DECODE, s), cache=cache)
    out.update(served)
    out["prefill"]["frames"] = nf
    print(f"[{tag}] encode {out['encode']} prefill {out['prefill']}",
          flush=True)
    if failures:
        return out, failures
    if not out["consistency"]["ok"]:
        failures.append(f"{tag}: decode logits at position 0 outside the "
                        f"reference's bound of a 1-token prefill's: "
                        f"{out['consistency']}")
    vb, vs = AUDIO_VS_CPU
    out["vs_cpu"] = dict(_vs_cpu(cfg, params, {"tokens": toks[:vb, :vs],
                                               "frames": frames[:vb]},
                                 FAM_VS_CPU_BOUND, tf32_control=True),
                         encoder_layers=cfg.encoder_layers, frames=nf)
    if not out["vs_cpu"]["ok"]:
        failures.append(f"{tag}: the card's logits outside "
                        f"{FAM_VS_CPU_BOUND} of the CPU's: {out['vs_cpu']}")
    del params
    torch.cuda.empty_cache()
    print(f"[{tag}] {AUDIO_ARCH} {out}", flush=True)
    return out, failures


def lm_families_phase(card):
    """Phase 13: [lm-ssm], [lm-hybrid] and [lm-audio], one model at a
    time (each freed before the next). Past FAM_CUT_AT seconds of the
    script the recurrent stacks run FAM_CUT_LAYERS. The kernels' counts
    are zeroed before and read after. Returns (results, launches by
    kernel, failures)."""
    import torch
    from repro_torch.kernels import cuda
    t_start = time.time()
    cut = t_start - T_START > FAM_CUT_AT
    torch.cuda.synchronize()
    cuda.reset_launches()
    out, failures = {"cut": cut}, []
    for key, arch, tag in (("ssm", SSM_ARCH, "lm-ssm"),
                           ("hybrid", HYBRID_ARCH, "lm-hybrid")):
        out[key], more = lm_recurrent(card, arch, tag, cut)
        failures += more
        torch.cuda.empty_cache()
    out["audio"], more = lm_audio(card)
    failures += more
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    out["wall_s"] = time.time() - t_start
    print(f"[lm-families] launches {launches}; phase 13 took "
          f"{out['wall_s']:.1f}s", flush=True)
    return out, launches, failures


def _leaves_equal(a, b):
    """Two trees of tensors hold the same leaves, dtypes and bits."""
    import torch
    from repro_torch.models import model_zoo
    la, lb = dict(model_zoo.leaves(a)), dict(model_zoo.leaves(b))
    return set(la) == set(lb) and all(
        la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]) for k in la)


def _train_launcher(work, steps):
    """14 (a): ``repro_torch.launch.train.main`` at smollm-360m's full
    width and depth on the card, then the checkpoint it wrote restored
    into its own trees and held to the saved bits."""
    import torch
    from repro_torch import ckpt
    from repro_torch.launch import train as launch
    ck_dir = os.path.join(work, "launch")
    args = ["--arch", TRAIN_ARCH, "--scale", "1.0", "--global-batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--steps",
            str(steps), "--ckpt-every", str(steps), "--ckpt-dir", ck_dir,
            "--device", "cuda"]
    t0 = time.time()
    res = launch.main(args)
    wall = time.time() - t0
    cfg, rows = res["config"], res["steps"]
    steady = [r["wall_s"] for r in rows[1:]]
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": _lm_sizes(res["params"])["params"],
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "optimizer": "adamw",
           "remat": True, "argv": args, "wall_s": wall,
           "steps": [{k: r[k] for k in ("step", "loss", "grad_norm", "lr",
                                        "wall_s")} for r in rows],
           "first_step_s": rows[0]["wall_s"],
           "steady_step_s": sum(steady) / len(steady) if steady else None,
           "peak_bytes": res["peak_bytes"]}
    if steady:
        out["tokens_per_s_steady"] = TRAIN_BATCH * TRAIN_SEQ / \
            out["steady_step_s"]
    failures = [f"train: step {r['step']} {k} is not finite ({r[k]})"
                for r in rows for k in ("loss", "grad_norm")
                if not math.isfinite(r[k])]
    if len(res["checkpoints"]) != 1 or len(rows) != steps:
        failures.append(f"train: {len(rows)} steps and "
                        f"{len(res['checkpoints'])} checkpoints, expected "
                        f"{steps} and 1")
        return out, failures
    saved = res["checkpoints"][0]
    torch.cuda.synchronize()
    t0 = time.time()
    (params, state), meta = ckpt.restore(ck_dir, (res["params"],
                                                  res["opt_state"]))
    torch.cuda.synchronize()
    out["checkpoint"] = {
        "step": saved["step"], "save_s": saved["seconds"],
        "bytes": saved["bytes"], "restore_s": time.time() - t0,
        "next_step": meta["extra"]["next_step"],
        "restored_bits_equal": _leaves_equal(params, res["params"])
        and _leaves_equal(state, res["opt_state"])}
    if not out["checkpoint"]["restored_bits_equal"]:
        failures.append("train: the restored checkpoint differs from the "
                        "saved trees")
    del res, params, state
    torch.cuda.empty_cache()
    return out, failures


def _rel_by_leaf(got, want):
    """{leaf: largest |got - want| / largest |want|}, on the host."""
    from repro_torch.models import model_zoo
    g, w = dict(model_zoo.leaves(got)), dict(model_zoo.leaves(want))
    return {"/".join(k): float((g[k].float().cpu() - w[k].float()).abs()
                               .max()) / max(float(w[k].float().abs().max()),
                                             1e-30) for k in w}


def _train_vs_cpu():
    """14 (b): the gradients of loss_fn on the card against the port's
    CPU path, same weights (smollm-360m's width, TRAIN_VS_CPU_LAYERS
    layers) and batch (the token stream's step 0), per leaf relative to
    its largest value: as shipped (bf16), beside a TF32 control and a
    control on half the batch that the gate must fail; the same model
    computing in f32, beside a TF32 control that its gate must fail; then
    flash_attention's backward alone at that batch's attention shape."""
    import torch
    from repro_torch import configs
    from repro_torch.data.synthetic import PipelineConfig, TokenPipeline
    from repro_torch.models import layers, model_zoo
    from repro_torch.train import step
    b, s = TRAIN_VS_CPU
    cfg = configs.get_config(TRAIN_ARCH).scaled(
        num_layers=TRAIN_VS_CPU_LAYERS)
    cpu = model_zoo.init_params(cfg, seed=0, device="cpu")
    card = _tree_to(cpu, "cuda")
    batch = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b), "cpu"
    ).get_batch(0)
    on = {k: v.cuda() for k, v in batch.items()}
    loss_card, _, g_card = step.grads_of(cfg, card, on)
    with _tf32():
        loss_ctl, _, g_ctl = step.grads_of(cfg, card, on)
    _, _, g_half = step.grads_of(cfg, card, {k: v[:b // 2]
                                             for k, v in on.items()})
    t0 = time.time()
    loss_cpu, _, g_cpu = step.grads_of(cfg, cpu, batch)
    cpu_s = time.time() - t0
    sound, control = _rel_by_leaf(g_card, g_cpu), _rel_by_leaf(g_ctl, g_cpu)
    half = max(_rel_by_leaf(g_half, g_cpu).values())
    del g_card, g_ctl, g_cpu, g_half
    with _compute_f32():
        _, _, f_card = step.grads_of(cfg, card, on)
        with _tf32():
            _, _, f_ctl = step.grads_of(cfg, card, on)
        _, _, f_cpu = step.grads_of(cfg, cpu, batch)
    f_sound, f_control = _rel_by_leaf(f_card, f_cpu), _rel_by_leaf(f_ctl,
                                                                   f_cpu)
    del card, f_card, f_ctl, f_cpu
    worst = max(sound, key=sound.get)
    out = {"layers": cfg.num_layers, "batch": b, "seq": s, "cpu_s": cpu_s,
           "loss": {"card": float(loss_card), "cpu": float(loss_cpu),
                    "tf32_control": float(loss_ctl)},
           "grad_rel_by_leaf": sound, "worst_leaf": worst,
           "grad_rel": sound[worst],
           "tf32_control_grad_rel": max(control.values()),
           "tf32_control_by_leaf": control,
           "half_batch_control_grad_rel": half, "limit": TRAIN_GRAD_REL,
           "f32": {"grad_rel": max(f_sound.values()),
                   "tf32_control_grad_rel": max(f_control.values()),
                   "grad_rel_by_leaf": f_sound,
                   "tf32_control_by_leaf": f_control,
                   "limit": TRAIN_F32_GRAD_REL}}
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(2)
    q, k, v, dout = (torch.randn((b, s, h, dh), generator=gen)
                     for _ in range(4))

    def flash_grads(device):
        ins = [a.to(device).requires_grad_(True) for a in (q, k, v)]
        o = layers.flash_attention(*ins, True, 0, 512)
        return [g.cpu() for g in torch.autograd.grad(o, ins,
                                                     dout.to(device))]

    want, got = flash_grads("cpu"), flash_grads("cuda")
    with _tf32():
        ctl = flash_grads("cuda")
    rel = [float((a - c).abs().max()) / float(c.abs().max())
           for a, c in zip(got, want)]
    rel_ctl = [float((a - c).abs().max()) / float(c.abs().max())
               for a, c in zip(ctl, want)]
    out["flash_backward"] = {"shape": [b, s, h, dh], "rel_dq_dk_dv": rel,
                             "tf32_control_rel": rel_ctl,
                             "limit": TRAIN_FLASH_REL}
    failures = []
    if not sound[worst] <= TRAIN_GRAD_REL:
        failures.append(f"train: gradient {worst} on the card lies "
                        f"{sound[worst]:.4g} from the CPU's (limit "
                        f"{TRAIN_GRAD_REL})")
    if not half > TRAIN_GRAD_REL:
        failures.append(f"train: the gradients of half the batch pass the "
                        f"gate ({half:.4g}, limit {TRAIN_GRAD_REL})")
    f_worst = out["f32"]["grad_rel"]
    if not f_worst <= TRAIN_F32_GRAD_REL:
        failures.append(f"train: the f32 model's gradients on the card lie "
                        f"{f_worst:.4g} from the CPU's (limit "
                        f"{TRAIN_F32_GRAD_REL})")
    if not out["f32"]["tf32_control_grad_rel"] > TRAIN_F32_GRAD_REL:
        failures.append("train: the f32 gradients' gate cannot see TF32 "
                        f"({out['f32']['tf32_control_grad_rel']:.4g})")
    if not max(rel) <= TRAIN_FLASH_REL:
        failures.append(f"train: flash_attention's backward on the card "
                        f"lies {max(rel):.3g} from the CPU's (limit "
                        f"{TRAIN_FLASH_REL})")
    return out, failures


def _train_restart(work):
    """14 (c): the example's config on the card, TRAIN_RESTART_STEPS
    straight, against a SimulatedFailure at TRAIN_FAIL_AT and a resume
    from the last checkpoint: equal losses and final trees, bit for
    bit."""
    from repro_torch.examples import train_lm
    from repro_torch.train import SimulatedFailure, train
    cfg, b, s = train_lm.example_config()
    kw = dict(steps=TRAIN_RESTART_STEPS, global_batch=b, seq_len=s,
              ckpt_every=TRAIN_CKPT_EVERY, peak_lr=1e-3, log_every=1,
              device="cuda")
    t0 = time.time()
    straight = train(cfg, ckpt_dir=os.path.join(work, "straight"), **kw)
    raised = False
    try:
        train(cfg, ckpt_dir=os.path.join(work, "broken"),
              fail_at=TRAIN_FAIL_AT, **kw)
    except SimulatedFailure:
        raised = True
    resumed = train(cfg, ckpt_dir=os.path.join(work, "broken"), **kw)
    ref = {m["step"]: m for m in straight["history"]}
    out = {"layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": b, "seq": s,
           "steps": TRAIN_RESTART_STEPS, "fail_at": TRAIN_FAIL_AT,
           "failure_raised": raised,
           "resumed_steps": [m["step"] for m in resumed["history"]],
           "losses": [m["loss"] for m in straight["history"]],
           "losses_equal": all(m == ref[m["step"]]
                               for m in resumed["history"]),
           "params_equal": _leaves_equal(straight["params"],
                                         resumed["params"]),
           "opt_state_equal": _leaves_equal(straight["opt_state"],
                                            resumed["opt_state"]),
           "wall_s": time.time() - t0}
    want = list(range(TRAIN_CKPT_EVERY, TRAIN_RESTART_STEPS))
    ok = (raised and out["resumed_steps"] == want and out["losses_equal"]
          and out["params_equal"] and out["opt_state_equal"])
    return out, ([] if ok else [f"train: the restart on the card is not "
                                f"bit-exact: {out}"]), straight


def train_phase(card, work):
    """Phase 14: LM training on the card, (a) the launcher at full width,
    (b) the card against the CPU, (c) the restart. Past TRAIN_CUT_AT
    seconds of the script (a) runs TRAIN_STEPS_CUT steps (a CUT line).
    The kernels' counts are zeroed before and read after. ``work`` holds
    the checkpoints (phase 15 restores (a)'s). Returns (results, launches
    by kernel, failures, (c)'s uninterrupted run)."""
    import torch
    from repro_torch.kernels import cuda
    t_start = time.time()
    steps = TRAIN_STEPS
    if t_start - T_START > TRAIN_CUT_AT:
        steps = TRAIN_STEPS_CUT
        print(f"[lm-train] CUT to {steps} steps: the script had run "
              f"{t_start - T_START:.0f} s of its 1200 s when phase 14 began "
              f"(past {TRAIN_CUT_AT:.0f} s)", flush=True)
    torch.cuda.synchronize()
    cuda.reset_launches()
    out, failures = {"steps_run": steps}, []
    out["launcher"], more = _train_launcher(work, steps)
    failures += more
    print(f"[lm-train] launcher {out['launcher']}", flush=True)
    out["vs_cpu"], more = _train_vs_cpu()
    failures += more
    print(f"[lm-train] vs_cpu {out['vs_cpu']}", flush=True)
    out["restart"], more, straight = _train_restart(work)
    failures += more
    print(f"[lm-train] restart {out['restart']}", flush=True)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    out["wall_s"] = time.time() - t_start
    print(f"[lm-train] launches {launches}; phase 14 took "
          f"{out['wall_s']:.1f}s", flush=True)
    return out, launches, failures, straight


def _bits_equal(saved, tensor) -> bool:
    """A saved array and a tensor hold the same dtype, shape and bits."""
    import numpy as np
    got = tensor.detach().cpu().numpy()
    return (got.dtype == saved.dtype and got.shape == saved.shape
            and np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                               np.ascontiguousarray(saved).view(np.uint8)))


def _mesh_launcher(work, straight):
    """15 (a): the launcher's mesh path (``launch.train.world_of_one``, a
    world of one NCCL rank; ``launch_mesh``, the host mesh;
    ``train.loop.train(mesh=)``; the trees gathered whole) at phase 14
    (c)'s config and schedule, against (c)'s uninterrupted run: losses,
    parameters and optimizer state bit for bit."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.examples import train_lm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch
    from repro_torch.train import train
    cfg, b, s = train_lm.example_config()
    t0 = time.time()
    with launch.world_of_one("cuda"):
        mesh = launch.launch_mesh(torch.device("cuda"))
        res = train(cfg, steps=TRAIN_RESTART_STEPS, global_batch=b,
                    seq_len=s, ckpt_dir=os.path.join(work, "mesh"),
                    ckpt_every=TRAIN_CKPT_EVERY, peak_lr=1e-3, log_every=1,
                    device="cuda", mesh=mesh)
        params, opt_state = sh.gather(res["params"]), sh.gather(
            res["opt_state"])
        torch.cuda.synchronize()
    losses = [m["loss"] for m in res["history"]]
    want = [m["loss"] for m in straight["history"]]
    out = {"mesh": mesh_lib.describe(mesh), "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": b, "seq": s,
           "steps": len(losses), "wall_s": time.time() - t0,
           "step_walls_s": res["walls"],
           "plain_step_walls_s": straight["walls"], "losses": losses,
           "losses_equal": losses == want,
           "params_equal": _leaves_equal(params, straight["params"]),
           "opt_state_equal": _leaves_equal(opt_state,
                                            straight["opt_state"])}
    ok = out["losses_equal"] and out["params_equal"] and \
        out["opt_state_equal"] and out["mesh"].startswith("mesh(1, 1)")
    return out, ([] if ok else [f"mesh: the launcher on the host mesh "
                                f"differs from the plain run: {out}"])


def _mesh_restore(work, cut):
    """15 (b): phase 14 (a)'s checkpoint restored through
    ``restore(shardings=<the host mesh>)`` (each saved spec re-derived for
    it), every leaf held to the saved file's bits; with ``cut`` the
    parameters alone."""
    import numpy as np
    import torch
    from repro_torch import ckpt, configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch
    from repro_torch.models import model_zoo
    from repro_torch.train import step as step_lib
    ck_dir = os.path.join(work, "launch")
    cfg = configs.get_config(TRAIN_ARCH)
    like = model_zoo.abstract_params(cfg)
    like = (like, step_lib.make_train_step(cfg)[0](like))
    out = {"cut": cut}
    with launch.world_of_one("cuda"):
        mesh = mesh_lib.make_host_mesh("cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        trees, meta = ckpt.restore(ck_dir, {"0": like[0]} if cut else like,
                                   shardings=mesh)
        torch.cuda.synchronize()
        out["restore_s"] = time.time() - t0
        step = meta["step"]
        trees = [trees["0"]] if cut else list(trees)
        leaves = [(f"{i}/" + "/".join(k), v) for i, tree in
                  enumerate(trees) for k, v in model_zoo.leaves(tree)]
        with np.load(os.path.join(ck_dir, f"step_{step:08d}",
                                  "arrays.npz")) as z:
            equal = [_bits_equal(z[k], v.full_tensor()) for k, v in leaves]
        out.update(mesh=mesh_lib.describe(mesh), step=step,
                   leaves=len(leaves), bits_equal=all(equal),
                   saved_placements=len(meta["shardings"]),
                   placements=sorted({str(v.placements)
                                      for _, v in leaves}))
        del trees, leaves
    torch.cuda.empty_cache()
    ok = out["bits_equal"] and (
        out["leaves"] < out["saved_placements"] if cut
        else out["leaves"] == out["saved_placements"])
    return out, ([] if ok else [f"mesh: the host-mesh restore differs from "
                                f"the saved trees: {out}"])


def _dryrun_argument_bytes(arch, shape):
    """What the placements imply one device holds of the dry run's inputs
    (parameters, AdamW state, batch) on the 16 x 16 mesh: each dim divided
    by the sizes of the mesh axes its spec entry names."""
    import types
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.train import step as step_lib
    sizes = {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=sizes)

    def local(tree, shard):
        if isinstance(tree, dict):
            return sum(local(tree[k], shard[k]) for k in tree)
        n = tree.element_size()
        spec = tuple(shard.spec) + (None,) * (tree.ndim - len(shard.spec))
        for dim, entry in zip(tree.shape, spec):
            div = 1
            for a in (() if entry is None else entry
                      if isinstance(entry, tuple) else (entry,)):
                div *= sizes[a]
            n *= dim // div
        return n
    cfg, cell = configs.get_config(arch), SHAPES[shape]
    params = model_zoo.abstract_params(cfg)
    opt = step_lib.make_train_step(cfg)[0](params)
    batch = model_zoo.input_specs(cfg, cell.seq_len, cell.global_batch,
                                  "train")["batch"]
    return (local(params, sh.param_shardings(params, mesh))
            + local(opt, sh.opt_shardings(opt, params, mesh))
            + local(batch, sh.batch_shardings(batch, mesh)))


def _start_dryrun(work):
    """15 (c), started: ``python -m repro_torch.launch.dryrun`` for
    MESH_DRYRUN at full width on a fake 16 x 16 world, in a child process
    (a process has one default process group), after (a) and (b) have
    ended: their walls see no tracing beside them. Returns (process,
    argv, out path, start time)."""
    arch, shape = MESH_DRYRUN
    path = os.path.join(work, "dryrun.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", path]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, path, time.time()


def _mesh_dryrun(started):
    """15 (c), finished: the dry run's record, ``status`` "ok" and
    argument bytes equal to the placements' arithmetic."""
    proc, cmd, path, t0 = started
    try:
        _, stderr = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    arch, shape = MESH_DRYRUN
    out = {"argv": cmd[1:], "rc": proc.returncode,
           "wall_s": time.time() - t0}
    if not os.path.exists(path):
        return out, [f"mesh: the dry run wrote no record (rc "
                     f"{proc.returncode}): {stderr[-2000:]}"]
    with open(path) as f:
        rec = json.load(f)[0]
    rec.pop("trace", None)
    out["record"] = rec
    out["argument_bytes_expected"] = _dryrun_argument_bytes(arch, shape)
    ok = (proc.returncode == 0 and rec.get("status") == "ok"
          and rec["memory"]["argument_bytes"]
          == out["argument_bytes_expected"])
    return out, ([] if ok else [f"mesh: the dry run's record is not ok: "
                                f"rc {proc.returncode}, {rec}"])


def mesh_phase(card, work, straight):
    """Phase 15: the LM's multi-device tooling on the card, (a) the
    launcher on the host mesh against phase 14 (c), (b) phase 14 (a)'s
    checkpoint restored onto the host mesh, (c) the dry run at full width
    on a fake 16 x 16 world (a child process, started when (b) has
    ended). The kernels' counts are zeroed before and read after (none
    runs here). Returns (results, launches by kernel, failures)."""
    import torch
    from repro_torch.kernels import cuda
    t_start = time.time()
    cut = t_start - T_START > MESH_CUT_AT
    if cut:
        print(f"[mesh] CUT: 15 (b) restores the parameters alone: the "
              f"script had run {t_start - T_START:.0f} s of its 1200 s when "
              f"phase 15 began (past {MESH_CUT_AT:.0f} s)", flush=True)
    torch.cuda.synchronize()
    cuda.reset_launches()
    out, failures = {"card": card}, []
    for name, fn in (("launcher", lambda: _mesh_launcher(work, straight)),
                     ("restore", lambda: _mesh_restore(work, cut)),
                     ("dryrun", lambda: _mesh_dryrun(_start_dryrun(work)))):
        out[name], more = fn()
        failures += more
        print(f"[mesh] {name} {json.dumps(out[name], default=float)}",
              flush=True)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    out["launches"] = launches
    out["wall_s"] = time.time() - t_start
    print(f"[mesh] launches {launches}; phase 15 took {out['wall_s']:.1f}s",
          flush=True)
    return out, launches, failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--learn", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--cold-repeat", action="store_true",
                    help="run phase 8 a second time and print whether its "
                         "serves repeat (not fatal)")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.core import api, darth_search, engines, training
        from repro_torch.data import vectors
        from repro_torch.index import flat, ivf
        from repro_torch.kernels import _build, cuda, ref
    except ImportError as e:
        return fail(f"the repro_torch package is not beside this script: {e}")
    if "jax" in sys.modules or "repro" in sys.modules:
        return fail("the port pulled in jax or the reference package")

    # -- 1. device ------------------------------------------------------------
    walls = {}
    t_phase = [T_START]

    def phase_done(name):
        """Host wall seconds since the previous phase ended."""
        now = time.time()
        walls[name] = now - t_phase[0]
        t_phase[0] = now

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    if torch.get_float32_matmul_precision() != "highest":
        return fail("float32 matmul precision is not 'highest'")
    if torch.backends.cuda.matmul.allow_tf32:
        return fail("TF32 matmuls are enabled")
    t0 = time.time()
    _build.build()
    print(f"[device] kernels built in {time.time() - t0:.1f}s", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    phase_done("1 device")
    # -- 2. main path ---------------------------------------------------------
    t0 = time.time()
    ds = vectors.make_dataset(n=args.n, d=args.dim, num_learn=args.learn,
                              num_queries=args.queries, clusters=args.nlist,
                              seed=0)
    print(f"[main] dataset n={args.n} d={args.dim} learn={args.learn} "
          f"queries={args.queries} ({time.time() - t0:.1f}s)", flush=True)
    main = {}
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.time()
    index = ivf.build(ds.base, nlist=args.nlist, seed=0)
    torch.cuda.synchronize()
    main["build_s"] = time.time() - t0
    l2_build = cuda.LAUNCHES["l2_topk"]
    print(f"[main] ivf.build nlist={index.nlist} cap={index.cap} "
          f"({main['build_s']:.1f}s)", flush=True)
    darth = api.Darth(
        make_engine=lambda **kw: engines.ivf_engine(index, **kw),
        engine=engines.ivf_engine(index, k=10, nprobe=args.nlist))
    t0 = time.time()
    trained = darth.fit(ds.learn, ds.base)
    main["fit_s"] = time.time() - t0
    l2_fit = cuda.LAUNCHES["l2_topk"] - l2_build
    gbdt_fit = cuda.LAUNCHES["gbdt_predict"]
    main["fit_split_s"] = dict(darth.fit_seconds)
    main["predictor"] = dict(trained.metrics, samples=trained.num_samples)
    print(f"[main] Darth.fit {main['fit_s']:.1f}s split "
          + " ".join(f"{k}={v:.1f}s" for k, v in darth.fit_seconds.items())
          + f" mse={trained.metrics['mse']:.5f}", flush=True)
    q = torch.as_tensor(ds.queries, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    _, plain_i, plain = darth.search_plain(q)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    results = {}
    for rt in TARGETS:
        t0 = time.time()
        _, ids, st = darth.search(q, rt)
        torch.cuda.synchronize()
        results[rt] = (ids, st, time.time() - t0)
    launches = dict(cuda.LAUNCHES)
    l2_by_phase = {"build": l2_build, "fit": l2_fit,
                   "search": launches["l2_topk"] - l2_build - l2_fit}
    main["l2_topk_launches"] = l2_by_phase
    main["gbdt_predict_launches"] = {
        "fit": gbdt_fit, "search": launches["gbdt_predict"] - gbdt_fit}
    print(f"[main] launches {launches} l2_topk by phase {l2_by_phase} "
          f"gbdt_predict by phase {main['gbdt_predict_launches']}",
          flush=True)

    xb = torch.as_tensor(ds.base, device=dev)
    _, gt = flat.search(q, xb, 10)
    plain_ndis = float(plain.ndis.float().mean())
    main["plain"] = {
        "recall": float(flat.recall_at_k(plain_i, gt).mean()),
        "ndis": plain_ndis, "qps": args.queries / plain_s}
    print(f"[main] plain  recall={main['plain']['recall']:.4f} "
          f"ndis={plain_ndis:.0f} qps={main['plain']['qps']:.0f}")
    failures = []
    main["targets"] = {}
    for rt, (ids, st, secs) in results.items():
        rec = float(flat.recall_at_k(ids, gt).mean())
        nd = float(st.inner.ndis.float().mean())
        row = {"recall": rec, "ndis": nd, "speedup_ndis": plain_ndis / nd,
               "qps": args.queries / secs,
               "npred": float(st.npred.float().mean()), "steps": st.steps}
        main["targets"][str(rt)] = row
        print(f"[main] target {rt:.2f} recall={rec:.4f} ndis={nd:.0f} "
              f"speedup={row['speedup_ndis']:.2f}x qps={row['qps']:.0f} "
              f"npred={row['npred']:.2f} steps={st.steps}", flush=True)
        if rec < rt - TOL:
            failures.append(f"recall {rec:.4f} below target {rt} - {TOL}")
    for name in _build.KERNELS:
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the main path")
    if failures:
        return fail("; ".join(failures))

    # Where one fit batch's step log (256 learn queries x nprobe steps, as
    # Darth.fit runs it) spends its time.
    ql = torch.as_tensor(ds.learn[:256], device=dev)
    _, gt_l = flat.search(ql, xb, 10)
    trace, by = step_log_trace(darth.engine, ql, gt_l)
    if trace is None:
        return fail("torch.profiler recorded no device time")
    trace["bucket_probe_s"] = sum(ms for key, ms in by.items()
                                  if "probe" in key) / 1e3
    main["step_log_batch"] = trace
    print(f"[trace] one fit batch's step log: {trace}", flush=True)

    # [repeat] The card's build and fit repeat bit for bit: ivf.build a
    # second time, and the GBDT fit a second time on phase 2's own log.
    t_rep = time.time()
    torch.cuda.synchronize()
    t0 = time.time()
    index2 = ivf.build(ds.base, nlist=args.nlist, seed=0)
    torch.cuda.synchronize()
    build2_s = time.time() - t0
    t0 = time.time()
    trained2 = training.fit_predictor(darth._last_log, device=dev)
    torch.cuda.synchronize()
    gbdt2_s = time.time() - t0
    p1, p2 = trained.predictor.params, trained2.predictor.params
    repeat = {
        "build_s": [main["build_s"], build2_s],
        "gbdt_s": [main["fit_split_s"]["gbdt"], gbdt2_s],
        "centroids_equal": torch.equal(index.centroids, index2.centroids),
        "store_equal": all(torch.equal(getattr(index, f), getattr(index2, f))
                           for f in ("bucket_vecs", "bucket_ids",
                                     "bucket_sqnorm", "bucket_sizes")),
        "trees_equal": all(torch.equal(getattr(p1, f), getattr(p2, f))
                           for f in ("feat", "thresh", "leaf", "base")),
        "dists_rt_equal": trained.dists_rt == trained2.dists_rt}
    del index2, trained2, p2
    repeat["wall_s"] = time.time() - t_rep
    main["repeat"] = repeat
    print(f"[repeat] {repeat}", flush=True)
    if not all(v for k, v in repeat.items() if k.endswith("_equal")):
        return fail(f"the card's build or fit did not repeat: {repeat}")

    phase_done("2 main path")
    # -- 3. kernels against their plain versions --------------------------------
    kernels = []
    gen = torch.Generator(device="cpu").manual_seed(0)

    # l2_topk at the main path's two shapes and on int8 codes: the fit's
    # ground truth (one query chunk x the database, k = 10), k-means
    # assignment (a 65536-row chunk x the centroids, k = 1) and SQ8 codes.
    x = xb
    xsq = (x ** 2).sum(1)
    tol = 1e-3 + 1e-5 * float(xsq.max())
    lo, hi = x.min(0).values, x.max(0).values
    scale = torch.clamp_min((hi - lo) / 254.0, 1e-12)
    offset = (hi + lo) / 2.0
    x8 = torch.clamp(torch.round((x - offset) / scale), -127, 127).to(
        torch.int8)
    qg = torch.as_tensor(ds.learn[:1024], device=dev)
    cents = index.centroids
    l2_cases = [
        ("fit ground truth, f32", qg, x, xsq, 10, l2_by_phase["fit"], 5),
        ("k-means assignment, f32", x[:65536], cents, (cents ** 2).sum(1), 1,
         l2_by_phase["build"], 20),
        ("int8 codes", (qg * scale).contiguous(), x8,
         ((x8.float() * scale + offset) ** 2).sum(1), 10, 0, 5),
        # Its launches are the HNSW path's, counted in phase 4.
        ("HNSW fit ground truth, f32", qg, x[:HNSW_N], xsq[:HNSW_N], 10, 0,
         5)]

    l2_shapes, checks = [], []
    for case, qq, xx, sq, kk, nl, reps in l2_cases:
        d_k, i_k = cuda.l2_topk(qq, xx, sq, kk)
        torch.cuda.synchronize()
        d_r, i_r = ref.l2_topk_ref(qq, xx, sq, kk)
        err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, tol)
        checks.append({"case": case, "max_abs_err": err,
                       "id_agreement": agree, "tol": tol})
        if not ok:
            return fail(f"l2_topk disagrees with plain: {checks}")
        del d_r, i_r
        row = shape_row_l2(case, qq, xx, sq, kk, nl, reps)
        if "l2_topk_kernel" not in row["kernels_ms"]:
            return fail(f"torch.profiler recorded no l2_topk kernel at "
                        f"{case}")
        l2_shapes.append(row)
        print(f"[kernels] l2_topk {row}", flush=True)
    # On SIFT-range integers every product and partial sum is exact in the
    # kernel's split TF32, so it must equal the plain version bit for bit.
    gen_i = torch.Generator(device=dev).manual_seed(0)
    qi = torch.randint(0, 256, (1024, x.shape[1]), generator=gen_i,
                       device=dev).float()
    xi = torch.randint(0, 256, tuple(x.shape), generator=gen_i,
                       device=dev).float()
    mid = xi.shape[0] // 2
    xi[mid:mid + 10] = xi[17]        # ties: the lowest row first
    qi[0] = xi[17]
    xisq = (xi ** 2).sum(1)
    for kk in (1, 10, 64):
        d_k, i_k = cuda.l2_topk(qi, xi, xisq, kk)
        d_r, i_r = ref.l2_topk_ref(qi, xi, xisq, kk)
        if not (torch.equal(d_k, d_r) and torch.equal(i_k, i_r)):
            return fail(f"l2_topk is not bit-equal to plain on integer data "
                        f"(k={kk}, max err {float((d_k - d_r).abs().max())})")
    checks.append({"case": f"SIFT-range integers 0..255 q[1024,{x.shape[1]}]"
                           f" x[{x.shape[0]},{x.shape[1]}] k=1/10/64",
                   "bit_equal": True})
    del qi, xi, xisq, d_k, i_k, d_r, i_r
    top = l2_shapes[0]
    kernels.append({
        "name": "l2_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk.py:35",
        "launches": launches["l2_topk"],
        "max_abs_err": max(c.get("max_abs_err", 0.0) for c in checks),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "f32_core_bound_ms": top["f32_core_bound_ms"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "shapes": l2_shapes, "checks": checks})
    del x8

    # bucket_probe: the first probe of a 256-query fit batch, read from the
    # whole bucket store (f32 and SQ8 int8), plus the pre-gathered entry.
    ql = torch.as_tensor(ds.learn[:256], device=dev)
    s0 = ivf.init_state(index, ql, k=10, nprobe=args.nlist)
    s1 = ivf.probe_step(index, s0)   # a filled running top-k
    slot = s1.probe_order[:, 1].contiguous()
    act = torch.ones_like(s1.active)
    kth = s1.topk_d[:, -1:].contiguous()
    store = (index.bucket_vecs, index.bucket_sqnorm, index.bucket_ids)
    pargs = (s1.q, *store, slot, act, s1.qsq, kth, s1.topk_d, s1.topk_i)
    got = cuda.bucket_probe_slots(*pargs)
    torch.cuda.synchronize()
    want = ref.bucket_probe_slots_ref(*pargs)
    btol = 1e-3 + 1e-5 * float(torch.nan_to_num(index.bucket_sqnorm,
                                                 posinf=0).max())
    errb, agreeb, okb = topk_agreement(got[0], got[1], want[0], want[1], btol)
    cnt_diff = int((got[2] - want[2]).abs().max())
    bchecks = [{"case": "f32 store B=256", "max_abs_err": errb,
                "id_agreement": agreeb, "count_max_diff": cnt_diff,
                "tol": btol}]
    sl = slot.long()
    pre = (s1.q, index.bucket_vecs[sl].contiguous(),
           index.bucket_sqnorm[sl].contiguous(),
           index.bucket_ids[sl].contiguous(), s1.qsq, kth, s1.topk_d,
           s1.topk_i)
    gp = cuda.bucket_probe(*pre)
    wp = ref.bucket_probe_ref(*pre)
    errp, agreep, okp = topk_agreement(gp[0], gp[1], wp[0], wp[1], btol)
    bchecks.append({"case": "f32 pre-gathered B=256", "max_abs_err": errp,
                    "id_agreement": agreep, "tol": btol})
    v8 = torch.clamp(torch.round((index.bucket_vecs - offset) / scale),
                     -127, 127).to(torch.int8)
    bias8 = s1.qsq - 2.0 * (s1.q @ offset)[:, None]
    qe = (s1.q * scale).contiguous()
    sq8 = torch.where(index.bucket_ids >= 0,
                      ((v8.float() * scale + offset) ** 2).sum(2),
                      float("inf"))
    a8 = (qe, v8, sq8, index.bucket_ids, slot, act, bias8, kth, s1.topk_d,
          s1.topk_i)
    g8, w8 = cuda.bucket_probe_slots(*a8), ref.bucket_probe_slots_ref(*a8)
    err8b, agree8b, ok8b = topk_agreement(g8[0], g8[1], w8[0], w8[1], btol)
    bchecks.append({"case": "int8 store B=256", "max_abs_err": err8b,
                    "id_agreement": agree8b, "tol": btol})
    if not (okb and okp and ok8b) or cnt_diff > 2:
        return fail(f"bucket_probe disagrees with plain: {bchecks}")
    cap, dd = index.cap, index.bucket_vecs.shape[2]
    pb = probe_bound(index, slot, act)
    rows = int(act.sum())
    ms = cuda_ms(lambda: cuda.bucket_probe_slots(*pargs), 50)
    plain_ms = cuda_ms(lambda: ref.bucket_probe_slots_ref(*pargs), 5)
    print(f"[kernels] bucket_probe rank-1 B={rows} ms={ms:.4f} {pb}",
          flush=True)

    # Where the main path runs it: (a) Darth.search's first step, 1000 test
    # queries on their nearest bucket with an empty running top-k; (b) one
    # fit batch, 256 learn queries through all nprobe ranks in turn, the
    # running top-k carried from the kernel's own output.
    sa = ivf.init_state(index, q, k=10, nprobe=args.nlist)
    slot_a = sa.probe_order[:, 0].contiguous()
    act_a = torch.ones_like(sa.active)
    aargs = (sa.q, *store, slot_a, act_a, sa.qsq,
             sa.topk_d[:, -1:].contiguous(), sa.topk_d, sa.topk_i)
    ga = cuda.bucket_probe_slots(*aargs)
    wa = ref.bucket_probe_slots_ref(*aargs)
    erra, agreea, oka = topk_agreement(ga[0], ga[1], wa[0], wa[1], btol)
    cnt_a = int((ga[2] - wa[2]).abs().max())
    bchecks.append({"case": "f32 store B=1000 rank 0", "max_abs_err": erra,
                    "id_agreement": agreea, "count_max_diff": cnt_a,
                    "tol": btol})
    del wa
    pb_a = probe_bound(index, slot_a, act_a)
    ms_a = cuda_ms(lambda: cuda.bucket_probe_slots(*aargs), 20)
    print(f"[kernels] bucket_probe rank-0 B={q.shape[0]} ms={ms_a:.4f} "
          f"{pb_a}", flush=True)

    slots_b = s0.probe_order.t().contiguous()   # [nprobe, 256]

    def fit_sweep(timed):
        rd, ri = s0.topk_d, s0.topk_i
        evs = []
        for r in range(slots_b.shape[0]):
            kth_r = rd[:, -1:].contiguous()
            if timed:
                evs.append((torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)))
                evs[-1][0].record()
            rd, ri, _ = cuda.bucket_probe_slots(
                s0.q, *store, slots_b[r], act, s0.qsq, kth_r, rd, ri)
            if timed:
                evs[-1][1].record()
        torch.cuda.synchronize()
        return rd, ri, sum(e0.elapsed_time(e1) for e0, e1 in evs)

    rd, ri, _ = fit_sweep(False)
    ms_b = fit_sweep(True)[2]
    pb_b = probe_bound(index, slots_b, act)
    # After every rank the carried top-k is the exact top-10 of the batch.
    gd, gi = flat.search(s0.q, x, 10)
    errs, agrees, oks = topk_agreement(rd, ri, gd, gi, btol)
    bchecks.append({"case": f"f32 fit sweep B=256 x {slots_b.shape[0]} "
                            "ranks vs exact top-10",
                    "max_abs_err": errs, "id_agreement": agrees,
                    "tol": btol})
    if not (oka and oks) or cnt_a > 2:
        return fail(f"bucket_probe disagrees with plain: {bchecks}")
    print(f"[kernels] bucket_probe fit sweep B=256 x {slots_b.shape[0]} "
          f"ms={ms_b:.4f} {pb_b}", flush=True)
    shapes = [
        dict({"case": "rank 1, fit batch", "B": rows, "ms": ms}, **pb),
        dict({"case": "rank 0, Darth.search first step",
              "B": int(q.shape[0]), "ms": ms_a}, **pb_a),
        dict({"case": f"fit batch, ranks 0..{slots_b.shape[0] - 1} summed",
              "B": rows, "launches": int(slots_b.shape[0]), "ms": ms_b},
             **pb_b)]
    # The same three under the profiler: device ms of the call's kernels,
    # per call (summed over the sweep's calls). "ms" times whole calls with
    # CUDA events, so in the sweep, where a call waits for the host between
    # its launches, it also holds the device's idle time.
    nprobe = int(slots_b.shape[0])
    for row, fn, calls, per_call in (
            (shapes[0], lambda: cuda.bucket_probe_slots(*pargs), 20, 1),
            (shapes[1], lambda: cuda.bucket_probe_slots(*aargs), 20, 1),
            (shapes[2], lambda: fit_sweep(False), 1, nprobe)):
        _, by, counts = profiled(lambda: [fn() for _ in range(calls)])
        row["kernels_ms"] = kernels_ms(by, counts, "probe", per_call)
        if not row["kernels_ms"]:
            return fail(f"torch.profiler recorded no probe kernel: {by}")
        row["device_ms"] = sum(row["kernels_ms"].values())
    print(f"[kernels] bucket_probe shapes {shapes}", flush=True)
    kernels.append({
        "name": "bucket_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bucket_probe.cu",
        "replaces": "src/repro/kernels/bucket_topk.py:36",
        "launches": launches["bucket_probe"],
        "max_abs_err": max(errb, errp, err8b, erra, errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": pb["bound_ms"],
        "bound_by": pb["bound_by"], "library_ms": None,
        "shape": f"B={rows} store[{index.nlist},{cap},{dd}] f32 k=10 "
                 f"live_rows={pb['live_rows']}",
        "shapes": shapes, "checks": bchecks})
    del v8, sq8

    # gbdt_predict where the main path runs it: 256 logged feature rows
    # (the shape of earlier runs), Darth.search's features after its first
    # step (all 1000 queries: each search step predicts for every row and
    # masks by due) and the fit's hold-out (10% of at most 2M logged
    # samples, as Darth.fit passes them to fit_predictor).
    p = trained.predictor.params
    log = darth._last_log
    nt = p.feat.shape[0]
    nf = log.features.shape[-1]
    pick = torch.randint(0, log.features.shape[0], (256,), generator=gen)
    feats = torch.as_tensor(
        log.features[pick.numpy(), torch.arange(256).numpy()], device=dev)
    eng = darth.engine
    first = eng.step(eng.index, eng.init(eng.index, q))
    f_search = darth_search._features(eng, first).float().contiguous()
    valid = log.features.reshape(-1, nf)[log.valid.reshape(-1)]
    n_hold = max(1, int(0.1 * min(valid.shape[0], 2_000_000)))
    f_hold = torch.as_tensor(valid[:n_hold], device=dev)
    del valid
    # An empty kernel's time in this call: the floor under any launch.
    floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), 200)
    _, by, counts = profiled(
        lambda: [torch.cuda._sleep(0) for _ in range(200)], keep_spin=True)
    spin = [k for k in by if "spin_kernel" in k]
    if not spin:
        return fail(f"torch.profiler recorded no spin kernel: {by}")
    floor_dev = by[spin[0]] / counts[spin[0]]
    # The launch plan, where the wrapper reports one (an older tree of the
    # port, timed with this script for comparison, does not).
    plan = getattr(cuda, "gbdt_plan", None)
    gshapes = []
    for case, xx, nl, reps in (
            ("256 logged rows", feats, 0, 200),
            ("Darth.search first step", f_search, launches["gbdt_predict"]
             - gbdt_fit, 200),
            ("fit hold-out", f_hold, gbdt_fit, 50)):
        gargs = (xx, p.feat, p.thresh, p.leaf)
        got = cuda.gbdt_predict(*gargs)
        again = cuda.gbdt_predict(*gargs)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            return fail(f"gbdt_predict is not deterministic ({case})")
        row = shape_row_gbdt(case, xx, p, nl, reps)
        if row["max_abs_err"] > 1e-5:
            return fail(f"gbdt_predict disagrees with plain ({case}): "
                        f"{row['max_abs_err']}")
        if "gbdt_predict_kernel" not in row["kernels_ms"]:
            return fail(f"torch.profiler recorded no gbdt_predict kernel "
                        f"({case})")
        row.update(bit_equal=True, launch_floor_ms=floor_ms,
                   launch_floor_device_ms=floor_dev,
                   plan=plan(xx.shape[0], nf, nt, p.depth) if plan else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            cuda.gbdt_predict(*gargs)
        row["host_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        gshapes.append(row)
        print(f"[kernels] gbdt_predict {row}", flush=True)
    top = gshapes[0]
    kernels.append({
        "name": "gbdt_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbdt_predict.cu",
        "replaces": "src/repro/kernels/gbdt_predict.py:24",
        "launches": launches["gbdt_predict"],
        "max_abs_err": max(r["max_abs_err"] for r in gshapes),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "shape": top["shape"], "shapes": gshapes})

    phase_done("3 kernels")
    # -- 4. hnsw path ----------------------------------------------------------
    n_learn = (HNSW_FIT_LEARN if time.time() - T_START <= HNSW_SLOW_AT
               else HNSW_FIT_LEARN_SLOW)
    print(f"[hnsw] CUT: {hnsw_fit_cut(n_learn)}", flush=True)
    hnsw_out, hnsw_launches, failures, hnsw_fitted = hnsw_path(
        ds.base[:HNSW_N], ds.learn[:n_learn], q)
    hnsw_out["cuts"] = [hnsw_fit_cut(n_learn)]
    if failures:
        return fail("; ".join(failures))
    l2_shapes[-1]["launches"] = hnsw_launches["l2_topk"]

    phase_done("4 hnsw")
    # -- 5. serve path -----------------------------------------------------------
    serve_out, serve_launches, failures, served, serve_targets = serve_path(
        ds, index, darth, gt, hnsw_fitted, card)
    if failures:
        return fail("; ".join(failures))

    phase_done("5 serve")
    # -- 6. mutate path ------------------------------------------------------------
    t0 = time.time()
    mutate_out, mutate_launches, failures, ring = mutate_path(
        ds, index, darth, hnsw_fitted, card)
    if failures:
        return fail("; ".join(failures))
    if ring is None:
        return fail("mutate: the online stream never held two insert events")
    delta_rows, failures = delta_scan_shapes(ds, ring, mutate_launches)
    if failures:
        return fail("; ".join(failures))
    mutate_out["wall_s"] = time.time() - t0
    print(f"[mutate] phase 6 took {mutate_out['wall_s']:.1f}s", flush=True)

    phase_done("6 mutate")
    # -- 7. competitors -------------------------------------------------------------
    compete_out, compete_launches, failures, compete_shapes = \
        competitors_path(ds, index, darth, results, tol, card)
    if failures:
        return fail("; ".join(failures))
    print(f"[compete] phase 7 took {compete_out['wall_s']:.1f}s", flush=True)

    phase_done("7 competitors")
    # -- 8. cold tier ------------------------------------------------------------------
    cold_out, cold_launches, failures, cold_shapes = cold_path(
        ds, index, darth, gt, served, serve_targets, btol, card)
    if failures:
        return fail("; ".join(failures))
    print(f"[cold] phase 8 took {cold_out['wall_s']:.1f}s", flush=True)
    if args.cold_repeat:
        again, _, failures, _ = cold_path(ds, index, darth, gt, served,
                                          serve_targets, btol, card)
        if failures:
            return fail("; ".join(failures))
        keys = ("recall_mean", "ndis_mean", "prefetches", "evictions",
                "misses", "engine_steps")
        cold_out["repeat"] = {
            name: {key: [row[key], again["serves"][name][key]]
                   for key in keys}
            for name, row in cold_out["serves"].items()}
        cold_out["repeat_equal"] = all(
            a == b for row in cold_out["repeat"].values()
            for a, b in row.values())
        print(f"[cold] repeat in this call: equal "
              f"{cold_out['repeat_equal']} {cold_out['repeat']}", flush=True)
    cshard_out, cshard_launches, failures, cshard_shapes = cold_shard_path(
        ds, index, darth, serve_targets, cold_out["serves"][
            "all_plan_prefetch"], btol, card)
    if failures:
        return fail("; ".join(failures))
    print(f"[cold-shard] took {cshard_out['wall_s']:.1f}s", flush=True)
    served_h1 = served["ivf_f32_hosts1"][0]
    del served
    phase_done("8 cold")
    # -- 9. sharded path ----------------------------------------------------
    shard_out, shard_launches, failures, shard_shapes = sharded_path(
        ds, index, darth, results, served_h1, serve_targets, gt, btol, card,
        hnsw_fitted)
    if failures:
        return fail("; ".join(failures))
    print(f"[shard] phase 9 took {shard_out['wall_s']:.1f}s", flush=True)
    del served_h1
    phase_done("9 sharded")
    # -- 10. quickstart -----------------------------------------------------
    quick_out, quick_launches, failures = quickstart_path(card)
    if failures:
        return fail("; ".join(failures))
    phase_done("10 quickstart")
    # -- 11. audit ----------------------------------------------------------
    audit_out, audit_launches, failures, audit_shapes = audit_path(card)
    if failures:
        return fail("; ".join(failures))
    phase_done("11 audit")
    # -- 12. the LM serving path and the RAG example -------------------------
    lm_out, rag_launches, failures, rag_shapes = lm_phase(card)
    if failures:
        return fail("; ".join(failures))
    phase_done("12 lm")
    # -- 13. the remaining LM families ----------------------------------------
    fam_out, fam_launches, failures = lm_families_phase(card)
    if failures:
        return fail("; ".join(failures))
    phase_done("13 lm families")
    # -- 14. LM training, 15. the LM's multi-device tooling ---------------------
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train_out, train_launches, failures, straight = train_phase(card,
                                                                    work)
        if failures:
            return fail("; ".join(failures))
        phase_done("14 lm train")
        mesh_out, mesh_launches, failures = mesh_phase(card, work, straight)
        if failures:
            return fail("; ".join(failures))
        phase_done("15 mesh")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[main] phase wall s {walls}", flush=True)

    extra_shapes = {name: [] for name in _build.KERNELS}
    for shapes in (serve_out["kernel_shapes"], {"l2_topk": delta_rows},
                   compete_shapes, cold_shapes, cshard_shapes, shard_shapes,
                   audit_shapes, rag_shapes):
        for name, rows in shapes.items():
            extra_shapes[name] += rows
    for row in kernels:
        extra = extra_shapes[row["name"]]
        row["shapes"] += extra
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [sh["max_abs_err"] for sh in extra])
        by_path = {"ivf": launches[row["name"]],
                   "hnsw": hnsw_launches[row["name"]],
                   "serve": serve_launches[row["name"]],
                   "mutate": mutate_launches[row["name"]],
                   "competitors": compete_launches[row["name"]],
                   "cold": cold_launches[row["name"]],
                   "cold_shard": cshard_launches[row["name"]],
                   "sharded": shard_launches[row["name"]],
                   "quickstart": quick_launches[row["name"]],
                   "audit": audit_launches[row["name"]],
                   "rag": rag_launches[row["name"]],
                   "lm_families": fam_launches[row["name"]],
                   "train": train_launches[row["name"]],
                   "mesh": mesh_launches[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    kname = torch.cuda.get_device_name(0)
    out = {"card": card, "kind": kname, "torch": torch.__version__,
           "args": vars(args), "phase_wall_s": walls,
           "main_path": main, "hnsw_path": hnsw_out,
           "serve_path": serve_out, "mutate_path": mutate_out,
           "competitors_path": compete_out, "cold_path": cold_out,
           "cold_shard_path": cshard_out, "sharded_path": shard_out,
           "quickstart_path": quick_out, "audit_path": audit_out,
           "lm_path": lm_out, "lm_families_path": fam_out,
           "train_path": train_out, "mesh_path": mesh_out,
           "kernels": kernels, "launches": launches,
           "hnsw_launches": hnsw_launches, "serve_launches": serve_launches,
           "mutate_launches": mutate_launches,
           "competitors_launches": compete_launches,
           "cold_launches": cold_launches,
           "cold_shard_launches": cshard_launches,
           "sharded_launches": shard_launches,
           "quickstart_launches": quick_launches,
           "audit_launches": audit_launches, "rag_launches": rag_launches,
           "lm_families_launches": fam_launches,
           "train_launches": train_launches,
           "mesh_launches": mesh_launches}
    os.makedirs(os.path.join(HERE, "results"), exist_ok=True)
    with open(os.path.join(HERE, "results", "chip_smoke.json"), "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({"main_path": main}, default=float))
    print(json.dumps({"hnsw_path": hnsw_out}, default=float))
    print(json.dumps({"serve_path": serve_out}, default=float))
    print(json.dumps({"mutate_path": mutate_out}, default=float))
    print(json.dumps({"competitors_path": compete_out}, default=float))
    print(json.dumps({"cold_path": cold_out}, default=float))
    print(json.dumps({"cold_shard_path": cshard_out}, default=float))
    print(json.dumps({"sharded_path": shard_out}, default=float))
    print(json.dumps({"quickstart_path": quick_out}, default=float))
    print(json.dumps({"audit_path": audit_out}, default=float))
    print(json.dumps({"lm_path": lm_out}, default=float))
    print(json.dumps({"lm_families_path": fam_out}, default=float))
    print(json.dumps({"train_path": train_out}, default=float))
    print(json.dumps({"mesh_path": mesh_out}, default=float))
    print(json.dumps({"kernels": kernels}, default=float))
    print(f"[main] chip_smoke.py took {time.time() - T_START:.1f}s",
          flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kname,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
