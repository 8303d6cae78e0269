#!/usr/bin/env python3
"""Drive the PyTorch port's search paths once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, in order; any failure exits nonzero:

1. Device: require CUDA, print the card's name and power limit, turn TF32
   off, build the seven kernel libraries from ``velesdb_tpu_torch/csrc``
   (the twelve hand-written kernels: #2 on f32 rows, #3 and #6 are modes of
   #2b's source, #5 and #1 epilogues of #7's; one ``nvcc`` per source, all
   at once) and print the ptxas registers and spills of every
   instantiation, the five float epilogues' beside #1's int32 one.
2. Kernels vs their plain torch versions, bit for bit (``torch.equal``),
   except the five on the tensor cores, held on every launch, here and on
   their main paths, to a stated tolerance through one checker
   (``bucket_kernel.ranked_error``), the worst error printed as a share of
   it: ``dense_bucket_tc`` (#2b, half rows) to ``half_scan_tolerance``
   (``|err| <= 2 D_pad 2^-24 A + 2 ulp``, A the winner's sum of |q_d c_d|:
   the half products are exact in fp32, only the order of the sums
   differs), ``hl_bucket`` (#3, split-bf16) to ``split_scan_tolerance``
   (``order_bound(3 D_pad, 3 D_pad) A + 2 ulp`` over its three products,
   ``order_bound(n, m) = 8 (2 sqrt(n) + sqrt(m)) 2^-24``, a probabilistic
   bound), ``dense_bucket`` (#2, f32 rows split in the kernel) to
   ``f32_scan_tolerance`` (``(3.1 2^-16 + order_bound(3 D_pad, 2 D_pad)) A
   + 2 ulp``), ``sq8_bucket`` (#6, the words unpacked in the kernel, the
   queries split exactly into three bf16 parts) to ``sq8_scan_tolerance``
   (``|scale| order_bound(3 D_pad, 2 D_pad) A`` + 2 ulp of each epilogue
   rounding), ``fused_topk`` (#8, f32 rows split as they are scored) to
   ``fused_topk_tolerance`` (the split's ``3.1 2^-16 A`` and the order's
   ``order_bound(3 D_pad, 2 D_pad) A``, scaled by the metric, + 2 ulp), each
   id equal to the plain one where the plain gap at its rank exceeds twice
   the tolerance:
   ``sq8pd_bucket`` (#1, the int32 epilogue of #7's int8 tensor-core kernel
   since slice 10) at the slice shape (B_pad 256, N 1,048,576, D_pad 128,
   chunk 8192), at B 1 and B 16, and at ragged shapes (B 13 -> 16, D 100 ->
   128, N 131,072, 15% invalid + 15% masked, three metrics), timed at B_pad
   256 and 16 against its bound (int8 products, 2 epilogue operations a
   score, the rows, ``ptile`` and ``gm``), and it must beat its first (dp4a)
   design (``FIRST_INT8_MS``) and the library yardstick; the
   four slice-2 kernels and the four slice-3 kernels (``dense_bucket`` #2 on
   f32 rows and #2b on f16 and bf16 rows, ``fused_topk`` #8 on all three,
   ``hl_bucket`` #3,
   ``sq8_bucket`` #6) at the same ragged shapes here, and at their slice
   shapes and B 1 / B 16 in the phases below, on their collections' state;
   the slice-4 probe kernel ``ivf_probe`` (#10) on f32 rows and SQ8 words at
   B 13, nprobe 5, L 136, D 100, three metrics, with dead slots and
   all-dead partitions (as past ``c_real``).
3. Slice 1, SIFT-1M class: 1,000,000 x 128 euclidean FULL, clustered data
   (seed 42, 10K held-out queries), payloads ``{"cat": i % 8}``, through
   ``Database`` -> ``Collection.search_batch`` / ``search`` / a filtered
   search / close + reopen. The launch counters are zeroed just before each
   main path and must show its kernel ran on every search; every launch of
   that run is then held against the plain version on its own arguments, bit
   for bit. Recall@10 >= 0.99 against a float64 oracle on the unpadded corpus.
   Then the same collection at k = 300, past the assist cores' guard:
   ``bucket-f32`` on the f32 rows (#2), b 256 and b 16, every launch within
   ``f32_scan_tolerance``, recall@300 against the float64 oracle within
   0.005 of the same searches with #2's plain version patched in.
4. Slice 1, 100K x 768D cosine (streamed scan): recall@10 >= 0.999. Then
   slice 3 on the same data: the public op ``fused_topk`` (#8) at B 256,
   f32 cosine, k 10 and k 100, against the float64 oracle (recall@10 and
   @100 >= 0.999, score error <= 1e-4), timed against its first (fp32-core)
   design (``FIRST_FUSED_MS``) and ``torch.topk(q @ c.T)``; and
   ``100k-768d-f16``, the data as F16 (D >= 512: ``streamed-scan`` on the
   half corpus), recall@10 >= 0.999 against the float64 oracle of the
   function it computes (f16 queries on the f16 rows), recall against the
   f32 data's oracle printed.
5. Slice 2, ``sift1m-sq8``: the SIFT data as SQ8 (``sq8-int8``, kernel #7),
   auto-rerank behind the storage recall gate: recall@10 >= 0.95 after the
   rerank, the raw coarse pass's recall printed, no filtered-out id, same
   ids after close + reopen; #7 (on the int8 tensor cores since slice 9)
   timed at B_pad 256 and 16 against its bound, and it must beat its first
   (dp4a) design (``FIRST_INT8_MS``) and the library yardstick. Slice 3:
   ``sift1m-sq8-staged``, the collection
   reopened with ``_SQ8I_MAX_DIM[0] = 128``: block-packed words,
   ``sq8-bucket`` (#6) behind the same gate, the same checks, #6 held
   within its tolerance at B 1, 16 and 256 and timed against its first
   (fp32-core) design (``FIRST_SQ8_MS``) and the library yardstick, which it
   must beat; and
   ``sift1m-bf16``, the SIFT data as BF16: ``bucket-f32`` (#2b) on every
   search, recall@10 >= 0.99 against the float64 oracle of the function the
   kernel computes (``bf16(2q) . bf16(c) - |c|^2``), recall against the f32
   data's oracle printed, filter and reopen as for sift1m. #2b is timed at b
   256 and b 16 and must beat #2's f32-core design on the same bf16 rows
   (``FIRST_DENSE_MS``, PERF.md) and the library yardstick. Then the
   public op ``bucket_topk`` on the f32 SIFT rows, b 256 / 16 / 1: #2 on f32
   rows, every launch within its tolerance, recall@10 >= 0.99; #2 is timed
   at B_pad 256 against its first design (``FIRST_F32_DENSE_MS``) and the
   library yardstick, which it must beat.
6. Slice 2, ``glove100-binary``: 1,183,514 x 100 cosine BINARY
   (ann-benchmarks glove-100-angular scale), padded to 1,310,720 rows, served
   by ``hamming-mxu`` (#5, timed at B_pad 256 and 16, held like #7 to beat
   its first design and the library); reopened with
   ``VELESDB_HAMMING_MXU_MAX_BYTES=0``
   it is served by ``hamming-bucket`` (#4). For both, the raw coarse pass is
   held against an exact Hamming oracle on the card: returned distances
   exact, the distance profile equal on >= 0.99 of positions (the bucket
   collision envelope). Recall after the rerank is printed, with no floor:
   sign sketches of this synthetic data are weak, a property of the method.
7. Slice 2, ``100k-binary``: 100,000 x 100 cosine BINARY, below
   ``BUCKET_MIN_ROWS``, served by ``hamming-topk`` (#9): the raw pass equals
   the exact oracle's ids and distances. #9 (split across the card since
   slice 10) is held bit for bit at B 1, 16 and 256, k 10 and 320 (the raw
   pass's oversample 32 x k 10, which ``search_batch`` asks for), timed at B
   256 with k 10 and 320 and at B 16 and B 1 with k 10, beside the library
   yardstick at both k (``|q| + |c| - 2 torch._int_mm`` on the unpacked
   bits, then ``torch.topk``), and it must beat its first design
   (``FIRST_TOPK_MS``) and the library at both k.
8. Slice 2, ``offset-full-assist``: 262,144 x 128 euclidean FULL, the
   clustered data + 100 per coordinate. ``sq8pd_build`` refuses it
   (penalty / step over its int32 budget), so ``int8-assist`` (#7) serves.
   This path exists for corpora with large norms and needs no full scale.
   Recall@10 >= 0.99. Slice 3: ``offset-full-hl``, the same collection
   reopened with ``_SQ8I_MAX_DIM[0] = 128``: ``split-bf16`` (#3) serves,
   every launch within ``split_scan_tolerance``; recall@10 at b=256 within
   0.01 of the same search through #3's plain version, and printed beside
   the same scan's on the data without the offset. #3 is timed at B_pad 256
   (and 16) on the sift1m rows' split against its first (fp32-core) design
   (``FIRST_HL_MS``) and the library yardstick.
5d. Slice 4, ``sift1m-ivf``: the sift1m collection pinned with
   ``index_kind = "ivf"`` (spill 2, 3,906 k-means clusters, L 1,032, about
   2.2 GiB of f32 partitions), its build stages timed. The counters are
   zeroed before the main path; every unmasked ``search_batch`` at b = 16 and
   b = 64 and ``search`` must launch #10 (its probe schedule and the scan that
   reads each probed partition tile once for the queries that probe it), and
   every launch is held against the plain version bit for bit. Recall@10 >= 0.95 at ef 128 over 256
   queries searched 16 at a time, and at b = 256 (the plain probing path);
   the default profile's served ef (after ``downshift_ef``) and the
   calibrated recall per ef printed; the 1/8 ``cat`` filter (plain masked
   path) returns no filtered-out id; close + reopen restores the index from
   ``ivf.npz`` with no k-means run and the same ids; then 1,000 rows
   upserted after the build are found through the delta with no rebuild,
   and the unfiltered searches after them still launch #10 (the stale
   slots dead in a copy of its state), recall@10 >= 0.95 at b = 16.
   ``sift1m-sq8-ivf``: the sift1m-sq8 collection pinned to IVF (SQ8 words,
   #10's quant branch) behind the auto-rerank: recall@10 >= 0.90 after the
   rerank, no filtered-out id, the same ids after reopen. #10 is timed at b
   16 and b 64 on both storages against its bound, its plain version and
   the plain ``ivf_search_impl`` on the same queries (the path the port
   would serve without it); its bound counts each probed partition once.
5f. Slice 4, ``hard1m-ivf``: 1,000,000 x 128 euclidean FULL from the same
   generator with 24 clusters (seed 43), where IVF's recall@10 at ef 128
   sits just above the balanced bar: >= 0.95 pinned, at b = 16 over 256
   queries, every launch held bit for bit. Then under ``auto``, for the
   fast, balanced and accurate profiles and balanced at ef 64, every
   call's plan must be what the calibration and the planner's costs ask
   for (the honesty gate, the downshift) and must launch #10 exactly when
   it is IVF; an IVF plan returns the pinned run's ids at its ef, an exact
   one reaches the profile's bar.
9. Slice 6, the four kernel experiments of ``benchmarks/`` as ported in
   ``velesdb_tpu_torch/experiments/``, run in process at their scripts'
   widths and sizes: ``exp_sq8i_v2`` (1,000,000 x 128, b 256: #7 and its
   epilogues v2, v2h, v3, #1 on the script's per-dimension shadow, the
   reranked engines), ``exp_hamming_mxu`` (1,200,000 x 100, b 256: #4, #5
   at chunk 2,048 and 8,192, #1 on the bit rows, the reranked engines, the
   two agreement lines), ``exp_topk`` (1,000,000 x 128, b 256, pchunk
   2,048: the exact scans, #2, #2b, #8) and ``exp_gather_kernel`` (R 8,192
   of 1,000,000 x 128, group 16: #11 at depth 1 and 2 beside ``q @
   corpus[idx].T``), once, as the main path: every launch is recorded and
   then held against its plain version on its own arguments, bit for bit,
   #2 (f32 and bf16 rows) and #8 within their tolerances; the timing
   protocol is cut, batches x samples 64 x 3 -> 8 x 2 (``exp_sq8i_v2``,
   ``exp_hamming_mxu``) and 16 x 3 -> 4 x 2 (``exp_topk``), to bound the
   outputs kept for the holds (recorded outputs also keep the allocator
   from reusing memory, so the variants' lines are not times to quote).
   A second, unrecorded run at the scripts' own protocol was cut in slice 16
   to keep the script within its 1,200-second limit (phase 14 came in).
   No width or row count is cut. The counts of each experiment's first run
   must show every one of the ten Pallas functions'
   counterparts launched, and each is timed at the script's shape against
   its bound, its plain version and a library yardstick (``torch._int_mm``
   with the variant's epilogue and the bucket ``amax``; ``q @ rows.T``;
   ``q @ corpus[idx].T`` over distinct id sets for #11). #11 is also
   timed at the graph beam's rows a step at b 256 (R 262,144, each launch
   held bit for bit), on CUDA events and by its device time a call
   (``torch.profiler``; the kernels line carries the device time, since the
   events time the host's enqueue at R 8,192), with the GB/s of the gathered
   rows; each depth must beat its first design's recorded time
   (``FIRST_GATHER_MS``) and the library. The scripts' own
   recall and agreement lines are checked: v1 = v0, the reranked engines at
   recall@10 >= 0.95, #5's distances equal #4's, the exact scans and #8 at
   1.0.
10. The graph engine, ``sift1m-graph``: the sift1m data as a ``graph``
   collection (``graph_phase``: #10 as the beam's SQ8 entry scan, held bit
   for bit).
11. Text and hybrid search, ``hybrid`` (``hybrid_phase``):
   ``benchmarks/exp_hybrid.py``'s data recipe (seed 42, 64 centers,
   payloads ``{"text": "topic topic w1 w2", "price": U(1, 100)}``; each
   query's text its cluster's topic word),
   filter ``price < 50``, k 10, ``vector_weight`` 0.5, fetch 20, through
   ``Collection.hybrid_search_batch`` on ``hybrid-1m-128d`` (1,000,000 x 128
   cosine FULL: the device-fused form, #1 as the vector branch),
   ``hybrid-100k-768d`` (the reference's config #4: ``streamed-scan``) and
   ``hybrid-sq8-262k`` (SQ8, b 16: the host-fused form, #7 and the host
   rerank). Checks: every device-fused or host-fused call launches #1 or #7
   and each launch equals its plain version; the device RRF equals ``fusion.weighted_rrf`` over the two branch lists read
   back; the card's BM25 equals the same blocks scored on the CPU bit for
   bit; no row with price >= 50; overlap@10 >= 0.95 against a host fusion
   of a float64-oracle vector top-20 with the same BM25 list. Then, on
   hybrid-1m-128d: ``search_batch_with_filters`` (256 queries, 8 filters) =
   8 filtered ``search_batch`` calls, ``multi_query_search`` = the host
   fusion under four strategies, a cache hit and its invalidation, 10,000
   TTL rows gone after ``expire_rows`` and never returned, after ``vacuum``
   the ids of the search before the TTL rows (scores within 1e-6) and
   recall@10 >= 0.95 (the pd core's recall on this recipe, printed, is
   below the 0.99 it reaches on sift1m; the reference's pd core returns the
   same ids on it, ``tests/test_torch_brute.py``); and exact hamming / jaccard at
   100,000 x 128 equal to a host oracle, ties to the lowest slot.
   Host-clock times (p50 / p99, the
   device path, host share; ``text_search_batch`` at b 256) come before the
   phase's profiles (busy, idle share, the top six device operations).
12. VelesQL and the knowledge graph (``velesql_kg_phase``, run inside phase
   11 on its collections before the SQ8 one is deleted).
   ``velesql-1m-128d`` (``hybrid-1m-128d``) through ``Database.query``, one
   query a call: (a) ``vector NEAR $v LIMIT 10``, (b) the same ``AND price
   < 50``, (c) (b) ``AND text MATCH`` the query's topic, (d) ``NEAR_FUSED
   [$v, $w] USING FUSION rrf(k = 60)``, (e) ``text MATCH`` alone, (f)
   ``SELECT text, COUNT(*), AVG(price) ... WHERE price < 2 GROUP BY text
   ORDER BY n DESC``. (a) to (e) equal the direct ``Collection`` calls
   (``search``, ``search_batch`` with the filter, ``hybrid_search`` at k 32
   with half the fused score, ``multi_query_search`` at k 5, ``text_search``:
   the same ids, scores within 1e-6), (f) a host count over the payloads;
   (a) to (c) each launch #1 and every launch equals its plain version bit
   for bit; EXPLAIN names the vector engine. (a) and (b) on
   ``hybrid-sq8-262k`` launch #7 (held bit for bit) and equal ``search``
   after the host rerank. ``kg-amazon0302-262k``: the SQ8 collection's
   262,144 rows as nodes, ``KG_EDGES`` (1,234,877, SNAP amazon0302's edge
   count) seeded ``also_bought`` edges (out-degrees Poisson(4.7) made to
   sum to it, destinations 80% in the source's cluster); ``traverse`` to
   depth 3 from 16 starts equals a host numpy BFS; a MATCH of 1..2 hops
   with ``similarity(b, $v) > 0.5 ORDER BY s DESC LIMIT 10`` equals a
   float64 host oracle over the reachable set (paths counted);
   ``Database.match_query`` equals ``execute_match``; after flush, close
   and reopen ``edges.npz`` gives the same rows; then 100 nodes are
   deleted and their edges are gone. Host-clock p50 / p99 over 30 calls
   (beside the direct call's p50), parse-cache hit and miss, the graph's
   build, edge load, save / load, traverse and MATCH p50 and the 100
   deletes come first; one profile of (a) and (c) (busy, idle share) last.
13. The serving surfaces, ``serve-1m-128d`` (``serve_phase``, run at the end
   of phase 11, after its ``db.close()``): phase 11's hybrid-1m-128d
   directory (after its TTL rows and ``vacuum``) reopened through the REST
   server's ``make_server`` on the default device, with
   ``VELESDB_BATCH_WINDOW_MS`` = 2. A burst of 26 mixed requests at the
   freshly reopened collection, every lazy build still ahead (the device
   refresh, BM25, the columns), equals the same calls made directly on
   ``httpd.app.db`` afterwards. Then a child process that uses only the
   standard library sends 1,024 held-out single-query ``/search`` requests
   (k 10) from 256 threads, 4 each on one warmed persistent connection, once
   through the micro-batcher (window 2 ms) and once with the window at 0:
   every answer 200 and equal to the direct ``search_batch`` (ids; scores
   within 1e-6; near-tie swaps counted), the batcher coalescing (``batches <
   requests``), recall@10 >= 0.95 against the float64 oracle. ``/search/batch``
   (b 256, 16), ``/query`` (NEAR, and with ``price < 50``) and
   ``/search/hybrid`` equal ``search_batch``, ``Database.query`` and
   ``hybrid_search``; ``GET /collections/{n}`` reports a CUDA device;
   ``/metrics`` holds ``http_requests_total`` and the ``microbatch_*``
   gauges. Every #1 launch of these steps equals its plain version bit for
   bit. ``python -m velesdb_tpu_torch.cli`` create / import (10,000 rows) /
   query / migrate and ``python -m velesdb_tpu_torch.server`` run as child
   processes on their default device (CUDA, checked) and answer as the
   in-process search does. Host-clock numbers (HTTP ``/search`` p50 / p99 and
   the request rate at both windows against the direct ``search``;
   ``/search/batch`` p50 at b 256 and 16 against ``search_batch``; the JSON
   encode share; the reopen and the first hybrid request) come before the
   phase's one profile: a coalesced dispatch's busy time and idle share.
14. Multi-device search, ``velesdb_tpu_torch.parallel`` on
   ``torch.distributed`` (``tools/sharded_phase.py:sharded_phase``, which
   also runs alone), run right after phase 2, while the card is nearly
   empty (its world of 4 shares the card with this process) and before any
   profile: (a) ``make_mesh()`` starts a world of 1 over NCCL in
   this process; ``ShardedBruteForce`` on one north-star shard, 6,291,456 x
   128 euclidean FULL (``make_clustered``, seed 42: the reference's shard of
   50M rows over 8 chips), the assist mode (#7) at b 256 and 16, every #7
   launch held bit for bit, ids and values equal to the single-card
   ``sq8i_rerank_topk`` on the same arrays, recall@10 >= 0.99 against the
   float64 oracle, p50 over 40 calls beside the single-card call's; (b) the
   streamed mode on 100k-768d's shape and the SQ8 mode on sift1m's, equal to
   the single-card ``streamed_topk`` / ``sq8_streamed_topk``; (c)
   ``ShardedIvfIndex`` and ``ShardedGraphIndex`` at world 1 on sift1m's rows,
   b 16 over 256 queries at ef 128, recall@10 >= 0.95, every #10 launch of
   the graph's entry scans held bit for bit, build times printed; (d) a world
   of 4 ranks over gloo sharing the card (partials gathered through the
   host), each reading its 1,572,864 rows from one memory-mapped ``.npy``:
   the streamed mode's ids (k 300) equal world 1's, the assist's recall@10 >=
   0.99 and the graphs' >= 0.95, every rank's #7 and #10 launches held bit
   for bit in the rank; world 4's times are printed, not claimed. (a)'s
   rows are made on the host while ``nvcc`` builds; (d) starts after (c)
   and is waited for after phase 3's host-bound ingest, before phase 3
   times anything on the card.
Each configuration ends with its timing (CUDA events): QPS at b=256 and
b=16 (median of 30 calls after warm-up) for ``search_batch`` and for the
device path alone, the host share, then the profiler last: the device's
busy time per call and its top kernels. Each kernel is timed at its slice
shape against its plain version and its bound: the larger of its bytes over
3.35 TB/s and its operations over their peak (int8 at 1,979 TOPS, bf16 and
f16 at 989 TFLOP/s, fp32 at 67 TFLOP/s, popcount at 16 per SM per clock),
for this run's inputs; the tensor-core kernels (#2, #3, #6, #8) also print
the fp32 rate of their first designs, and the int8 ones (#5, #7, #12, #14
hm: int8 products plus each epilogue's fp32 operations) the dp4a issue rate
of theirs, and must beat the first designs' recorded times and the library
yardstick (#1, #12 v5 and #14 hme too: int8 products plus 2 operations a
score). Where a product and a bucket max
compute the function (#1, #2, #2b, #3, #5, #6, #7), the kernel is timed
against that library yardstick (``torch.mm``, ``torch._int_mm``, then the
epilogue and ``amax`` over the ``[B, N/chunk, chunk/128, 128]`` view), its
``library_ms``; ``fused_topk`` against ``torch.topk(q @ c.T)``; #10 on f32
partitions against ``index_select`` of the probed partitions, one
``torch.bmm`` and the affine (SQ8: none).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 10
TIMED_CALLS = 30
DEVICE = "cuda"
SIFT_N, SIFT_D, HELD_OUT = 1_000_000, 128, 10_000  # bench.py:9, :561
C768_N, C768_D = 100_000, 768  # bench.py:7
GLOVE_N, GLOVE_D = 1_183_514, 100  # glove-100-angular; benchmarks/exp_hamming_mxu.py
B100K_N = 100_000
OFFSET_N = 262_144
RAGGED_N, RAGGED_B, RAGGED_D = 131_072, 13, 100
RAGGED_PROBES, RAGGED_L = 5, 136
IVF_UPSERTS = 1000
HARD_BLOBS = 24  # hard1m-ivf: recall@10 at ef 128 near the balanced bar of 0.95
CHUNK = 8192
KERNELS = ("sq8pd_bucket", "sq8i_bucket", "hamming_mxu_bucket", "hamming_bucket",
           "hamming_topk", "dense_bucket", "dense_bucket_tc", "hl_bucket", "sq8_bucket",
           "fused_topk", "ivf_probe", "row_gather")
# The kernel libraries, one per csrc/ source: #2 on f32 rows (dense_bucket),
# #3 (hl_bucket) and #6 (sq8_bucket) are modes of dense_bucket_tc.cu, #5
# (hamming_mxu_bucket) and #1 (sq8pd_bucket) epilogues of sq8i_bucket.cu.
LIBS = tuple(name for name in KERNELS
             if name not in ("dense_bucket", "hl_bucket", "sq8_bucket", "hamming_mxu_bucket",
                             "sq8pd_bucket"))
# The experiments' timing protocol, cut to keep phase 9 near two minutes with
# every launch held against its plain version: the scripts' 64 batches x 3
# samples (exp_sq8i_v2, exp_hamming_mxu) and 16 x 3 (exp_topk) become these.
EXP_ITERS, EXP_SAMPLES = 8, 2
EXP_TOPK_ITERS, EXP_TOPK_SAMPLES = 4, 2
# Published H100 SXM peaks (NVIDIA data sheet, dense rates, 700 W).
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1.979e15
PEAK_F32 = 67e12
PEAK_TC16 = 989e12  # bf16 / f16 tensor cores, dense
# bound_ms takes the peak of the products the kernel does: bf16/f16 at the
# tensor-core rate (#2b; three split products a term for #2 on f32 rows, #3,
# #6 and #8), int8 at the int8 tensor-core rate (#5, #7, #12) plus each
# epilogue's fp32 operations. The fp32 rate or the dp4a issue rate of the
# first designs is printed beside.
F32_CORES = "at the fp32 CUDA-core rate of the first design"
DP4A_FIRST = "at the dp4a issue rate of the first design"
CARD = ""  # "name, power limit" from nvidia-smi, appended to every number
# The tensor-core kernels against their tolerances: #2b (half_scan_tolerance),
# #2 on f32 rows (f32_scan_tolerance), #3 (split_scan_tolerance), #6
# (sq8_scan_tolerance), #8 (fused_topk_tolerance).
TOL_SEEN = {name: {"checks": 0, "worst": 0.0, "max_tol": 0.0}
            for name in ("dense_bucket_tc", "dense_bucket", "hl_bucket", "sq8_bucket",
                         "fused_topk")}
# #10's times in its first design, one block per (query, probe, 128-row tile)
# (PERF.md, row #10; NVIDIA H100 80GB HBM3, 700 W)
FIRST_PROBE_MS = {"f32 b=16": 0.3428, "f32 b=64": 1.4801, "sq8 b=16": 0.1701, "sq8 b=64": 0.6196}
# #2's times on the sift1m bf16 rows (B_pad 256 and 16, N 1,048,576, D_pad
# 128) before half rows moved to the tensor cores (PERF.md, row #2; NVIDIA
# H100 80GB HBM3, 700 W)
FIRST_DENSE_MS = {256: 5.0662, 16: 1.0573}
# #3's time at B_pad 256, N 1,048,576, D_pad 128 on the fp32 CUDA cores, and
# #8's at B 256, N 100,000, D 768, f32 cosine, k 10 and 100, before both moved
# to the tensor cores (PERF.md, rows #3 and #8; NVIDIA H100 80GB HBM3, 700 W)
FIRST_HL_MS = 10.7803
FIRST_FUSED_MS = {10: 5.9295, 100: 5.9832}
# #2 on the f32 SIFT rows and #6 on the sift1m-sq8 words at B_pad 256,
# N 1,048,576, D_pad 128 in their first (fp32-core) designs, before both moved
# to the tensor cores (PERF.md, rows #2 and #6; NVIDIA H100 80GB HBM3, 700 W)
FIRST_F32_DENSE_MS = 5.6524
FIRST_SQ8_MS = 12.4232
# #7, #12 (v1 is #7's entry at the experiment's shape) and #5, #14 hm at their
# slice shapes in their first (dp4a) design, before they moved to the int8
# tensor cores (PERF.md, rows #5, #7, #12, #14; NVIDIA H100 80GB HBM3, 700 W);
# #1 at B_pad 256, N 1,048,576, D_pad 128, and as #12 v5 and #14 hme, the
# same kernel at the experiments' shapes, in its first (dp4a) design
# (PERF.md rows #1, #12, #14; chip_smoke.py runs of slices 5 and 6 on an
# NVIDIA H100 80GB HBM3, 700 W)
FIRST_INT8_MS = {"sq8i_bucket": 1.1773, "sq8i_bucket_v1": 1.1634, "sq8i_v2_bucket": 1.1634,
                 "sq8i_v2h_bucket": 1.1891, "sq8i_v3_bucket": 1.1051,
                 "hamming_mxu_bucket": 1.1130, "hamming_mxu_bucket_hm": 0.9876,
                 "sq8pd_bucket": 0.8844, "sq8pd_bucket_v5": 0.8804, "sq8pd_bucket_hme": 0.9796}
# #9 at B 256, N 106,496, W 4 in its first design (one block a query, an
# in-order walk), at k 10 and at the raw pass's k 320 (PERF.md row #9 and
# section 5: chip_smoke.py runs of slices 5 and 3 on an NVIDIA H100 80GB
# HBM3, 700 W)
FIRST_TOPK_MS = {10: 0.5733, 320: 0.5741}
# #11's device time a launch (torch.profiler) in its first design (16-byte
# cp.async, 64 rows a block) at R 8,192 and 262,144 of 1,000,000 x 128, group
# 16, the fastest of four runs of tools/int8_tc_timing.py --gather on that
# design's checkout (PERF.md row #11; NVIDIA H100 80GB HBM3, 700 W). Its CUDA
# events time at R 8,192, 0.0345 / 0.0252 ms, is the host's enqueue.
FIRST_GATHER_MS = {("row_gather", 8192): 0.0108, ("row_gather_db", 8192): 0.0090,
                   ("row_gather", 262_144): 0.0862, ("row_gather_db", 262_144): 0.0865}
GATHER_BEAM_R, GATHER_BEAM_SETS = 262_144, 8  # the beam's rows a step at b 256
TOPK_M = 320  # 100k-binary's raw pass: the storage gate's oversample 32 x k 10
# Phase 11: benchmarks/exp_hybrid.py at its knobs HYBRID_N / HYBRID_D
# (hybrid-1m-128d), at its defaults (hybrid-100k-768d, the reference's config
# #4), and as SQ8 cut to 262,144 rows (its host f32 rerank takes ~72 ms a
# b 256 call at 1M, PERF.md section 5); exact hamming / jaccard at SET_N x 128.
HYB_N, HYB_D = 1_000_000, 128
HYB768_N, HYB768_D = 100_000, 768
HYB_SQ8_N = 262_144
HYB_QUERIES = 8_192
SET_N = 100_000
HYB_FILTER = {"type": "lt", "field": "price", "value": 50.0}
# phase 12: kg-amazon0302-262k takes SNAP amazon0302's edge count (262,111
# nodes, 1,234,877 edges) over hybrid-sq8-262k's 262,144 rows
KG_EDGES = 1_234_877
KG_MEAN_DEGREE = 4.7
VQL_CALLS = 30  # host-clock calls a timed VelesQL query
# phase 13, serve-1m-128d: 256 client threads x 4 single-query /search requests
# over the held-out queries qv[SERVE_Q0:SERVE_Q0 + 1024] (no earlier phase reads
# them), the micro-batcher's window; the entry points' directory
SERVE_THREADS, SERVE_PER_THREAD = 256, 4
SERVE_Q0 = 4096
SERVE_WINDOW_MS = "2"
CLI_ROWS = 10_000
HTTP_TIMEOUT = 120
# exp_hybrid.py's VOCAB, copied: this script imports nothing from benchmarks/
HYB_VOCAB = [
    "coffee", "espresso", "latte", "grinder", "roast", "bean", "cup",
    "laptop", "keyboard", "screen", "battery", "charger", "dock",
    "guitar", "amp", "pedal", "string", "pickup", "tuner",
    "jacket", "boot", "scarf", "glove", "wool", "zipper",
    "novel", "poem", "essay", "author", "chapter", "plot",
]
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


def phase(name: str) -> None:
    print(f"-- {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def make_clustered(rng, n, d, n_clusters=64):
    """Clustered Gaussians: the reference benchmark's data model (bench.py:41).
    Fewer clusters make each one a larger blob that k-means cuts into more
    partitions, so a query's neighbours spread over more of them."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, n)
    return centers[assign] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def oracle_topk(torch, corpus64, queries, metric, k, mask=None, chunk=131072):
    """float64 exact top-k on the card: ``(scores [B, k], ids [B, k])`` with
    euclidean scores as distances (ascending) and cosine as similarities."""
    q = torch.as_tensor(queries, device=corpus64.device).double()
    if metric == "cosine":
        q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-300)
    qq = (q * q).sum(1, keepdim=True)
    best_v = best_i = None
    for c0 in range(0, corpus64.shape[0], chunk):
        c = corpus64[c0 : c0 + chunk]
        dots = q @ c.T
        if metric == "euclidean":
            s = -(qq + (c * c).sum(1)[None, :] - 2.0 * dots)
        else:
            s = dots
        if mask is not None:
            s = torch.where(mask[None, c0 : c0 + chunk], s, -torch.inf)
        v, i = torch.topk(s, k, dim=1)
        if best_v is None:
            best_v, best_i = v, i + c0
        else:
            best_v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            best_i = torch.gather(torch.cat([best_i, i + c0], 1), 1, pos)
    if metric == "euclidean":
        best_v = torch.sqrt((-best_v).clamp_min(0.0))
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def oracle_ids(torch, rows64, q64, k, pen64=None, scale64=None, mask=None, chunk=131072):
    """float64 exact top-k ids of ``s = (q . rows) * scale - pen``, maximized:
    the oracle of the function a kernel computes, on its own rounded
    operands."""
    best_v = best_i = None
    for c0 in range(0, rows64.shape[0], chunk):
        s = q64 @ rows64[c0 : c0 + chunk].T
        if scale64 is not None:
            s = s * scale64[None, c0 : c0 + chunk]
        if pen64 is not None:
            s = s - pen64[None, c0 : c0 + chunk]
        if mask is not None:
            s = torch.where(mask[None, c0 : c0 + chunk], s, -torch.inf)
        v, i = torch.topk(s, k, dim=1)
        if best_v is None:
            best_v, best_i = v, i + c0
        else:
            best_v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            best_i = torch.gather(torch.cat([best_i, i + c0], 1), 1, pos)
    return best_i.cpu().numpy()


def ids_recall(results, o_ids) -> float:
    """recall@k of hydrated results against oracle ids."""
    hits = sum(len({h.id for h in row} & set(oi.tolist())) for row, oi in zip(results, o_ids))
    return hits / (len(results) * o_ids.shape[1])


def score_results(results, o_vals, o_ids, rtol):
    """recall@k of hydrated results against the oracle, and the worst
    relative score error on shared ids (checked against ``rtol`` unless it
    is None)."""
    hits, worst = 0, 0.0
    for row, ov, oi in zip(results, o_vals, o_ids):
        truth = {int(i): float(v) for i, v in zip(oi, ov)}
        for hit in row:
            if hit.id in truth:
                hits += 1
                ref = truth[hit.id]
                worst = max(worst, abs(hit.score - ref) / max(abs(ref), 1e-12))
    recall = hits / (len(results) * o_ids.shape[1])
    if rtol is not None:
        check(worst <= rtol, f"score error {worst:.3e} above rtol {rtol}")
    return recall


def time_calls(torch, fn, batches):
    """Per-call milliseconds of ``fn(batch)`` measured with CUDA events."""
    fn(batches[0])  # warm-up
    torch.cuda.synchronize()
    out = []
    for b in batches[1:]:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(b)
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def time_kernel(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_profile(torch, fn, batches, top=3):
    """Device time per call (kernels and copies on the card) from
    torch.profiler, and the ``top`` kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            fn(b)
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(per_name.values()) / 1e3 / len(batches)
    best = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return busy, [(name, us / 1e3 / len(batches)) for name, us in best]


def report_qps(torch, label, search, queries, b):
    """Median per-call time of ``search`` over consecutive query batches;
    returns it with the batches for a later profile."""
    n_calls = min(TIMED_CALLS + 1, queries.shape[0] // b)
    batches = [queries[i * b : (i + 1) * b] for i in range(n_calls)]
    ms = time_calls(torch, search, batches)
    med = statistics.median(ms)
    p99 = float(np.percentile(ms, 99))
    say(
        f"{label} b={b}: {b / med * 1e3:.1f} QPS (median of {len(ms)} calls, "
        f"p50 {med:.4f} ms, p99 {p99:.4f} ms)"
    )
    return med, batches


def report_busy(torch, label, search, batches, med, calls=8):
    busy, top = device_profile(torch, search, batches[1 : 1 + calls])
    if busy <= 0.0:
        print(f"{label}: device busy not measured (no device events)", flush=True)
        return
    say(
        f"{label}: device busy {busy:.4f} ms/call, idle share {1.0 - busy / med:.3f} "
        f"(torch.profiler over {calls} calls, against the unprofiled median)"
    )
    for name, t in top:
        say(f"    {t:.4f} ms/call  {name[:100]}")


def max_err(got, ref) -> float:
    """Largest |difference| of two equal-shaped outputs (0 where equal,
    infinities included)."""
    same = got == ref
    if bool(same.all()):
        return 0.0
    return float((got.double() - ref.double()).abs()[~same].max())


def measure(torch, name, search, device_label, device_fn, queries, sizes=(256, 16)):
    """QPS at each batch size (b=256 and b=16 unless told) of ``search`` and
    of the device path alone, the host share, then the device's busy time
    from the profiler."""
    out = {}
    label = f"{name} search_batch"
    for lbl, fn in ((label, search), (device_label, device_fn)):
        for b in sizes:
            out[lbl, b] = (fn, *report_qps(torch, lbl, fn, queries, b))
    for b in sizes:
        host = 1.0 - out[device_label, b][1] / out[label, b][1]
        say(f"{label} b={b}: host share {host:.3f} (1 - device path / search_batch)")
    for b in sizes:
        fn, med, batches = out[label, b]
        report_busy(torch, f"{label} b={b}", fn, batches, med)


def hold(label, got, ref) -> float:
    """Check a kernel's outputs equal its plain version's, bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(max_err(g, r) for g, r in zip(got, ref))
    for g, r in zip(got, ref):
        check(g.shape == r.shape, f"{label}: shape {tuple(g.shape)} != {tuple(r.shape)}")
        check(bool((g == r).all()) and g.dtype == r.dtype,
              f"{label}: kernel != plain version (max |err| {err})")
    print(f"kernel == plain, bit for bit: {label}", flush=True)
    return err


def hold_within(kernel, label, result) -> float:
    """Check a tensor-core kernel's outputs against its plain version within
    its tolerance, from the checker's ``(worst, max_tol, max_abs)``; prints
    the worst error as a share of the tolerance and returns the largest
    |err|."""
    worst, max_tol, max_abs = result
    check(worst <= 1.0, f"{label}: kernel outside the tolerance ({worst:.4f} of it)")
    seen = TOL_SEEN[kernel]
    seen["checks"] += 1
    seen["worst"] = max(seen["worst"], worst)
    seen["max_tol"] = max(seen["max_tol"], max_tol)
    print(f"kernel within tolerance (worst {worst:.4f} of it, max |err| {max_abs:.3e}, largest "
          f"bound {max_tol:.3e}): {label}", flush=True)
    return max_abs


def hold_tc(label, q, rows, cc, chunk, out) -> float:
    """#2b's ``(gm, gi)`` within ``half_scan_tolerance``."""
    from velesdb_tpu_torch.ops import bucket_kernel as bk

    return hold_within("dense_bucket_tc", label, bk.half_scan_error(q, rows, cc, chunk, *out))


def hold_f32(label, q, rows, cc, chunk, out) -> float:
    """#2's ``(gm, gi)`` on f32 rows within ``f32_scan_tolerance``."""
    from velesdb_tpu_torch.ops import bucket_kernel as bk

    return hold_within("dense_bucket", label, bk.f32_scan_error(q, rows, cc, chunk, *out))


def hold_sq8(label, q, words, scale, minv, pen, qsum, chunk, out) -> float:
    """#6's ``(gm, gi)`` within ``sq8_scan_tolerance``."""
    from velesdb_tpu_torch.ops import bucket_kernel as bk

    return hold_within("sq8_bucket", label,
                       bk.sq8_scan_error(q, words, scale, minv, pen, qsum, chunk, *out))


def hold_hl(label, qhi, qlo, hi, lo, cc, chunk, out) -> float:
    """#3's ``(gm, gi)`` within ``split_scan_tolerance``."""
    from velesdb_tpu_torch.ops import bucket_kernel as bk

    return hold_within("hl_bucket", label,
                       bk.split_scan_error(qhi, qlo, hi, lo, cc, chunk, *out))


def hold_fused(label, q, rows, valid, aux, qq, k, metric, out) -> float:
    """#8's ``(vals, idx)`` within ``fused_topk_tolerance``."""
    from velesdb_tpu_torch.ops import pallas_kernels as pk

    return hold_within("fused_topk", label,
                       pk.fused_topk_error(q, rows, valid, aux, qq, k, metric, *out))


def tolerance_summary(kernel, what) -> None:
    seen = TOL_SEEN[kernel]
    say(f"{kernel}: every launch checked so far ({seen['checks']}) against {what}; the largest "
        f"bound {seen['max_tol']:.3e}, the largest error {seen['worst']:.4f} of its bound")


def bucket_max(s, chunk):
    """The bucket max of a ``[B, N]`` score tile: the library yardstick's
    last step."""
    b, n = s.shape
    return s.view(b, n // chunk, chunk // 128, 128).amax(dim=2)


MM_F32 = {"how": "not run"}  # which form of the half product mm_f32 timed


def mm_f32(torch, a, b):
    """A half product with fp32 output: ``torch.mm(..., out_dtype=float32)``
    where this torch has it, else the half output upcast."""
    try:
        out = torch.mm(a, b, out_dtype=torch.float32)
        MM_F32["how"] = "torch.mm(out_dtype=float32)"
    except (TypeError, RuntimeError, NotImplementedError):
        out = torch.mm(a, b).float()
        MM_F32["how"] = "torch.mm in the half type, upcast to f32"
    return out


class MainPath:
    """One main path's launch record: every launch counter is zeroed on
    entry, the kernel wrapper named by ``(module, attr)`` is wrapped to keep
    each launch's arguments and outputs, and :meth:`launched` checks that a
    step launched the kernel. On exit the wrapper is restored."""

    def __init__(self, counters, module, attr, counter):
        self.counters, self.module, self.attr, self.counter = counters, module, attr, counter
        self.calls = []
        self.seen = 0

    def __enter__(self):
        self.kernel = getattr(self.module, self.attr)

        def recorded(*args, **kwargs):
            out = self.kernel(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        setattr(self.module, self.attr, recorded)
        for launches in self.counters:
            for key in launches:
                launches[key] = 0
        return self

    def launches(self) -> int:
        return next(c[self.counter] for c in self.counters if self.counter in c)

    def launched(self, what: str) -> None:
        now = self.launches()
        check(now > self.seen, f"{what} did not launch the {self.counter} kernel")
        self.seen = now

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.kernel)

    def hold_all(self, plain, describe, holder=None) -> float:
        """Every recorded launch against the plain version on its own
        arguments (bit for bit, or by ``holder(label, *args, out)``);
        returns the largest |err|."""
        check(len(self.calls) == self.launches(),
              f"{len(self.calls)} recorded calls for {self.launches()} launches")
        err = 0.0
        for args, kwargs, out in self.calls:
            label = f"main-path launch, {describe(*args, **kwargs)}"
            if holder is None:
                err = max(err, hold(label, out, plain(*args, **kwargs)))
            else:
                err = max(err, holder(label, *args, *kwargs.values(), out))
        self.calls.clear()
        return err


def expected_ef(calib: dict, ef: int, bar: float, margin: float = 0.005) -> int:
    """The ef a profile's search is served at: the smallest calibrated ef
    below ``ef`` whose recall clears ``bar + margin``, else ``ef`` (the
    planner's downshift rule, restated to check it)."""
    for e in sorted(e for e in calib if e < ef):
        if calib[e] >= bar + margin:
            return e
    return ef


def bound(ops_ms: float, bytes_: float) -> tuple[float, str]:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over their peak rates (``ops_ms``)."""
    bytes_ms = bytes_ / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_beats(name, ms, first_ms, lib_ms, first="the first (fp32-core) design",
                shape="B_pad 256") -> None:
    """Print a redesigned kernel's time beside its first design's recorded
    time and the library yardstick, and fail unless it beats both."""
    say(f"{name} {shape}: {first} {first_ms:.4f} ms (recorded, {first_ms / ms:.2f}x), "
        f"library yardstick {lib_ms:.4f} ms ({lib_ms / ms:.2f}x)")
    check(ms < first_ms and ms < lib_ms,
          f"{name} {shape}: {ms:.4f} ms, not faster than its first design ({first_ms:.4f}) "
          f"and the library ({lib_ms:.4f})")


def check_faster(name, ms, n, first_ms, lib_ms, ms16, bytes_of) -> None:
    """A mode of the tensor-core scan moved from the fp32 CUDA cores (#2 on
    f32 rows, #6) at B_pad 256 (and 16), N ``n``, D_pad 128: print its bound,
    three bf16 products at 989 TFLOP/s against ``bytes_of(B_pad)``, its share
    of it, and fail unless it beats its first design's recorded time and the
    library yardstick."""
    for b, t in ((256, ms), (16, ms16)):
        ops_ms = 6 * b * n * 128 / PEAK_TC16 * 1e3
        bytes_ms = bytes_of(b) / PEAK_BYTES * 1e3
        least = max(ops_ms, bytes_ms)
        say(f"{name} B_pad {b}, N {n}, D_pad 128: kernel {t:.4f} ms; bound {least:.4f} ms "
            f"(three bf16 products {ops_ms:.4f} ms at 989 TFLOP/s, bytes {bytes_ms:.4f} ms): "
            f"{least / t:.4f} of it")
    check_beats(name, ms, first_ms, lib_ms)


def int8_ops_ms(b, n, d_pad, epi_ops) -> float:
    """The int8 scans' operations at their peaks: the products at the int8
    tensor-core rate, ``epi_ops`` fp32 operations a score at the fp32 rate."""
    return (2 * b * n * d_pad / PEAK_INT8 + epi_ops * b * n / PEAK_F32) * 1e3


def check_int8(name, ms, n, lib_ms, ms16, epi_ops, bytes_of) -> None:
    """A scan moved from dp4a onto the int8 tensor cores (#7, #5, #1) at
    B_pad 256 and 16, N ``n``, D_pad 128: print its bound against
    ``bytes_of(B_pad)`` and its share of it, and fail unless it beats its
    first design's recorded time and the library yardstick. The epilogue's
    operations count at the fp32 rate (#1's are int32: the table of peaks
    has no separate int32 rate)."""
    for b, t in ((256, ms), (16, ms16)):
        ops_ms = int8_ops_ms(b, n, 128, epi_ops)
        least, by = bound(ops_ms, bytes_of(b))
        say(f"{name} B_pad {b}, N {n}, D_pad 128: kernel {t:.4f} ms; bound {least:.4f} ms "
            f"({by}; int8 products + {epi_ops} epilogue operations a score {ops_ms:.4f} ms, "
            f"bytes {bytes_of(b) / PEAK_BYTES * 1e3:.4f} ms): {least / t:.4f} of it")
    check_beats(name, ms, FIRST_INT8_MS[name], lib_ms, first="the first (dp4a) design")


class Recorder:
    """Every launch of several kernel wrappers while inside: the wrappers,
    named by ``(module, attr)``, are wrapped to keep each call's arguments
    and outputs; :meth:`take` hands them over and forgets them."""

    def __init__(self, targets):
        self.targets, self.calls, self.saved = targets, {}, {}

    def __enter__(self):
        for module, attr in self.targets:
            kernel = getattr(module, attr)
            self.saved[module, attr] = kernel
            self.calls[attr] = []

            def recorded(*args, _kernel=kernel, _calls=self.calls[attr], **kwargs):
                out = _kernel(*args, **kwargs)
                _calls.append((args, kwargs, out))
                return out

            setattr(module, attr, recorded)
        return self

    def take(self, attr):
        calls = list(self.calls[attr])
        self.calls[attr].clear()
        return calls

    def __exit__(self, *exc):
        for (module, attr), kernel in self.saved.items():
            setattr(module, attr, kernel)


def time_cycle(torch, fn, args_list):
    """Milliseconds a call of ``fn(*args)`` over ``args_list`` taken in turn
    (distinct inputs each call, as the experiments time), CUDA events."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for args in args_list:
        fn(*args)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / len(args_list)


def gather_phase(torch, first, held, rows, kernel_row) -> None:
    """#11 at both depths, timed at the experiment's shape (R 8,192 of
    1,000,000 x 128, group 16, the id sets of its held run) and at the graph
    beam's rows a step at b 256 (R 262,144, fresh id sets, each launch held
    bit for bit): CUDA events over back-to-back calls (the host's enqueue
    included), then the device time a call from torch.profiler (each
    kernel's mean over the launches the trace kept), beside the
    library yardstick q @ corpus[idx.long()].T on both clocks. Each depth's
    device time at both shapes must beat its first design's
    (``FIRST_GATHER_MS``) and the library's."""
    from velesdb_tpu_torch.experiments import kernels as xk

    calls = first["exp_gather_kernel", "row_gather"]
    (q, corpus, _), kw = calls[0]
    group = kw.get("group", 16)
    n, d = corpus.shape
    sets_8k = [(a[2],) for a, _ in calls[1:]] or [(calls[0][0][2],)]
    rng = np.random.default_rng(1)
    sets_256k = [(torch.from_numpy(rng.integers(0, n, GATHER_BEAM_R, dtype=np.int32)).to(
        q.device),) for _ in range(GATHER_BEAM_SETS)]

    def lib(ix):
        return q @ corpus[ix.long()].T

    def device_ms(fn, sets):
        """Device ms a call from torch.profiler over ``sets``, and the
        launches the trace kept of the call's most frequent kernel: the sum,
        over the kernels the trace holds at least once every other call, of
        each one's mean time. Late in this script the profiler can drop
        events, so the mean over the launches it kept stands for all."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for args in sets:
                    fn(*args)
                torch.cuda.synchronize()
            per = {}
            for e in prof.events():
                if str(e.device_type).endswith("CUDA"):
                    per.setdefault(e.name, []).append(e.time_range.elapsed_us())
            kept = [t for t in per.values() if len(t) >= len(sets) // 2]
            if kept:
                return sum(sum(t) / len(t) for t in kept) / 1e3, max(map(len, kept))
        fail(f"#11: three profiled passes of {len(sets)} calls kept under half of every kernel")

    for sets in (sets_8k, sets_256k):
        r = sets[0][0].shape[0]
        # what this run's data needs: each distinct row once, the ids, the
        # queries and the scores
        bytes_ = (int(torch.unique(sets[0][0]).numel()) * d * 4 + r * 4 + 8 * d * 4
                  + 8 * r * 4)
        ops_ms = 2 * 8 * r * d / PEAK_F32 * 1e3
        lib_ev, (lib_dev, _) = time_cycle(torch, lib, sets), device_ms(lib, sets)
        for name, stages in (("row_gather", 1), ("row_gather_db", 2)):
            def fn(ix, s=stages):
                return xk.row_gather_scores(q, corpus, ix, group=group, stages=s)

            if r == GATHER_BEAM_R:
                for ix, in sets[:2]:
                    hold(f"{name} R {r}", fn(ix), xk.row_gather_scores_ref(q, corpus, ix))
            ev, (dev_ms, traced) = time_cycle(torch, fn, sets), device_ms(fn, sets)
            if r != GATHER_BEAM_R:  # the experiment's shape: the kernels line's row
                kernel_row(name, "row_gather.cu", rows[name][3], dev_ms,
                           time_cycle(torch, lambda ix: xk.row_gather_scores_ref(q, corpus, ix),
                                      sets[:8]),
                           ops_ms, bytes_, held["exp_gather_kernel", name], library_ms=lib_dev)
            b_ms, b_by = bound(ops_ms, bytes_)
            say(f"{name} R {r}, D {d}, group {group}: device {dev_ms:.4f} ms a call (torch.profiler, "
                f"{traced} of {len(sets)} launches in the trace), "
                f"{r * d * 4 / dev_ms / 1e6:.1f} GB/s of gathered rows, bound {b_ms:.4f} ms "
                f"({b_by}; {b_ms / dev_ms:.4f} of it); CUDA events {ev:.4f} ms a call; library "
                f"device {lib_dev:.4f} ms ({r * d * 4 / lib_dev / 1e6:.1f} GB/s), events "
                f"{lib_ev:.4f} ms")
            check_beats(name, dev_ms, FIRST_GATHER_MS[name, r], lib_dev,
                        first="the first (16-byte cp.async) design", shape=f"R {r}")
    say(f"#11 at R {sets_8k[0][0].shape[0]} ({len(sets_8k)} distinct id sets of the held run) "
        f"and R {GATHER_BEAM_R} ({GATHER_BEAM_SETS} fresh sets), D {d}, N {n}, group {group}: "
        "kernel ms in the kernels line is the profiler's device time a launch (CUDA events over "
        "back-to-back calls time the host's enqueue); library yardstick q @ corpus[idx.long()].T "
        "(its device time)")


def experiments_phase(torch, counters, kernel_row, launches, errs, dp4a_rate) -> None:
    """Phase 9: the four ported experiments at their scripts' sizes, in
    process, with every launch recorded and then held against its plain
    version (#2 on f32 and bf16 rows and #8 within their tolerances); the
    counts of each experiment's run; each kernel of #11-#14
    timed at the script's shape beside its bound, plain version and library
    yardstick."""
    from velesdb_tpu_torch.experiments import exp_gather_kernel, exp_hamming_mxu, exp_sq8i_v2
    from velesdb_tpu_torch.experiments import exp_topk
    from velesdb_tpu_torch.experiments import kernels as xk
    from velesdb_tpu_torch.ops import bucket_kernel as bk
    from velesdb_tpu_torch.ops import pallas_kernels as pk

    targets = ((bk, "sq8i_bucket_gm"), (bk, "sq8pd_bucket_gm"), (bk, "hamming_mxu_gm"),
               (bk, "hamming_bucket_gm"), (bk, "dense_bucket_gm"), (pk, "fused_topk_scan"),
               (xk, "sq8i_v2_bucket_gm"), (xk, "row_gather_scores"))
    plain = {
        "sq8i_bucket_gm": bk.sq8i_bucket_ref, "sq8pd_bucket_gm": bk.sq8pd_bucket_gm_ref,
        "hamming_mxu_gm": bk.hamming_mxu_ref, "hamming_bucket_gm": bk.hamming_bucket_ref,
        "dense_bucket_gm": bk.dense_bucket_ref, "fused_topk_scan": pk.fused_topk_ref,
        "sq8i_v2_bucket_gm": xk.sq8i_v2_bucket_ref,
        "row_gather_scores": lambda q, corpus, idx, **_: xk.row_gather_scores_ref(q, corpus, idx),
    }
    held, first = {}, {}

    def describe(attr, args, kwargs):
        shapes = ", ".join(f"{tuple(a.shape)} {str(a.dtype)[6:]}" for a in args
                           if isinstance(a, torch.Tensor))
        extra = [a for a in args if not isinstance(a, torch.Tensor)] + list(kwargs.values())
        return f"{attr} {shapes} {extra}"

    def hold_run(rec, exp):
        """Hold every recorded launch of one experiment's run against the
        plain version on its own arguments; keep the first call of each
        function for timing."""
        for _, attr in targets:
            for args, kwargs, out in rec.take(attr):
                label = f"{exp} main-path launch, {describe(attr, args, kwargs)}"
                if attr == "dense_bucket_gm":
                    f32 = args[1].dtype == torch.float32
                    err = (hold_f32 if f32 else hold_tc)(label, *args, out)
                    key = attr if f32 else "dense_bucket_tc"
                elif attr == "fused_topk_scan":
                    err = hold_fused(label, *args, *kwargs.values(), out)
                    key = attr
                else:
                    err = hold(label, out, plain[attr](*args, **kwargs))
                    key = attr
                if attr == "sq8i_v2_bucket_gm":
                    key = f"sq8i_{args[5]}_bucket"
                elif attr == "row_gather_scores":
                    key = "row_gather" if kwargs.get("stages", 1) == 1 else "row_gather_db"
                held[exp, key] = max(held.get((exp, key), 0.0), err)
                first.setdefault((exp, key), []).append((args, kwargs))

    def experiments():
        """The four runs, each ``(name, results)`` as it ends, cut to
        ``EXP_*`` batches and samples: every launch is held."""
        exp_sq8i_v2.ITERS, exp_sq8i_v2.SAMPLES = EXP_ITERS, EXP_SAMPLES
        exp_hamming_mxu.ITERS, exp_hamming_mxu.SAMPLES = EXP_ITERS, EXP_SAMPLES
        topk_argv = ["--variants", ",".join(exp_topk.PORTED), "--iters", str(EXP_TOPK_ITERS),
                     "--samples", str(EXP_TOPK_SAMPLES)]
        for exp, run in (("exp_sq8i_v2", lambda: exp_sq8i_v2.main([])),
                         ("exp_hamming_mxu", lambda: exp_hamming_mxu.main([])),
                         ("exp_topk", lambda: exp_topk.main(topk_argv)),
                         ("exp_gather_kernel", lambda: exp_gather_kernel.main([]))):
            yield exp, run()

    # the main path: every launch recorded (its outputs kept until held, so
    # the allocator cannot reuse them: this run's times are not the answer)
    runs, counts = {}, {}
    with Recorder(targets) as rec:
        for launch_counts in counters:
            for key in launch_counts:
                launch_counts[key] = 0
        before = {key: 0 for c in counters for key in c}
        t0 = time.perf_counter()
        for exp, out in experiments():
            torch.cuda.synchronize()
            runs[exp] = out
            counts[exp] = {key: n - before[key] for c in counters for key, n in c.items()
                           if n > before[key]}
            before = {key: n for c in counters for key, n in c.items()}
            say(f"{exp} (held run): {time.perf_counter() - t0:.2f} s; launches "
                + ", ".join(f"{k} {n}" for k, n in counts[exp].items()))
            hold_run(rec, exp)
            t0 = time.perf_counter()
    print("experiments: every launch above held against its plain version", flush=True)

    # what comes out is right: the scripts' own agreement and recall lines
    r = {k: v["recall"] for k, v in runs["exp_sq8i_v2"]["results"].items()}
    check(r["v1"] == r["v0"], f"exp_sq8i_v2: v1 recall {r['v1']} != v0's {r['v0']} (one function)")
    check(abs(r["v2"] - r["v0"]) <= 0.01, f"exp_sq8i_v2: v2 recall {r['v2']} far from v0's")
    check(min(r["a16"], r["a16v2"], r["a16v5"], r["a32v5"]) >= 0.95,
          f"exp_sq8i_v2: a reranked engine under 0.95 recall@10: {r}")
    agree = runs["exp_hamming_mxu"]["agreement"]
    check(agree["hm"]["max_abs_dist"] == 0.0, f"exp_hamming_mxu: #5 and #4 disagree: {agree}")
    hr = {k: v["recall"] for k, v in runs["exp_hamming_mxu"]["results"].items()}
    check(hr["h0r"] == hr["hmr"], f"exp_hamming_mxu: h0r and hmr recall differ: {hr}")
    tr = {k: v["recall"] for k, v in runs["exp_topk"]["results"].items()}
    check(tr["scan_exact"] == tr["scan_approx"] == tr["pallas"] == 1.0,
          f"exp_topk: an exact variant missed: {tr}")
    check(tr["bucket"] == tr["bucket_approx"] >= 0.95, f"exp_topk: bucket recall {tr}")
    gr = runs["exp_gather_kernel"]["results"]
    for name in ("row-gather", "row-gather double-buffered"):
        check(gr[name]["max_abs_err_vs_baseline"] <= 1e-3,
              f"exp_gather_kernel: {name} far from q @ corpus[idx].T: {gr[name]}")
    print("experiments: results (the held run) " + json.dumps(runs), flush=True)

    # every one of the ten Pallas functions' counterparts ran in its run
    rows = {  # row -> (experiment, counter, source, replaced function)
        "sq8i_bucket_v1": ("exp_sq8i_v2", "sq8i_bucket_gm", "sq8i_bucket.cu",
                           "benchmarks/exp_sq8i_v2.py:77"),
        "sq8i_v2_bucket": ("exp_sq8i_v2", "sq8i_v2_bucket", "sq8i_bucket.cu",
                           "benchmarks/exp_sq8i_v2.py:92"),
        "sq8i_v2h_bucket": ("exp_sq8i_v2", "sq8i_v2h_bucket", "sq8i_bucket.cu",
                            "benchmarks/exp_sq8i_v2.py:108"),
        "sq8i_v3_bucket": ("exp_sq8i_v2", "sq8i_v3_bucket", "sq8i_bucket.cu",
                           "benchmarks/exp_sq8i_v2.py:126"),
        "sq8pd_bucket_v5": ("exp_sq8i_v2", "sq8pd_bucket_gm", "sq8i_bucket.cu",
                            "benchmarks/exp_sq8i_v2.py:144"),
        "dense_bucket_exp_topk": ("exp_topk", "dense_bucket_gm", "dense_bucket_tc.cu",
                                  "benchmarks/exp_topk.py:193"),
        "dense_bucket_tc_exp_topk": ("exp_topk", "dense_bucket_tc", "dense_bucket_tc.cu",
                                     "benchmarks/exp_topk.py:193"),
        "hamming_mxu_bucket_hm": ("exp_hamming_mxu", "hamming_mxu_gm", "sq8i_bucket.cu",
                                  "benchmarks/exp_hamming_mxu.py:66"),
        "sq8pd_bucket_hme": ("exp_hamming_mxu", "sq8pd_bucket_gm", "sq8i_bucket.cu",
                             "benchmarks/exp_hamming_mxu.py:125"),
        "row_gather": ("exp_gather_kernel", "row_gather", "row_gather.cu",
                       "benchmarks/exp_gather_kernel.py:103"),
        "row_gather_db": ("exp_gather_kernel", "row_gather_db", "row_gather.cu",
                          "benchmarks/exp_gather_kernel.py:155"),
    }
    for name, (exp, counter, _, _) in rows.items():
        check(counts[exp].get(counter, 0) > 0, f"{exp} did not launch {counter} ({name})")
        launches[name] = counts[exp][counter]
    print("experiments: each of the ten Pallas functions' counterparts launched in its run: "
          + ", ".join(f"{n} {launches[n]}" for n in rows), flush=True)

    def call_of(exp, key, pick=lambda args, kwargs: True):
        return next((a, k) for a, k in first[exp, key] if pick(a, k))

    # #12 at B_pad 256, N 1,048,576, D_pad 128, chunk 8192
    (qi, rows8, scale, am, pen, sqi, invqs, chunk), _ = call_of("exp_sq8i_v2", "sq8i_bucket_gm")
    b_pad, d_pad = qi.shape
    n = rows8.shape[0]
    nb = n // chunk * 128
    base_bytes = b_pad * d_pad + n * d_pad + 8 * b_pad * nb
    dp4a = (DP4A_FIRST, b_pad * n * d_pad / 4, dp4a_rate)
    args7 = (qi, rows8, scale, am, pen, sqi, invqs, chunk)
    ms = time_kernel(torch, lambda: bk.sq8i_bucket_gm(*args7))
    lib = time_kernel(torch, lambda: bucket_max(
        torch._int_mm(qi, rows8.T).float() * scale + sqi[:, None] * am - invqs[:, None] * pen,
        chunk))
    kernel_row("sq8i_bucket_v1", "sq8i_bucket.cu", rows["sq8i_bucket_v1"][3], ms,
               time_kernel(torch, lambda: bk.sq8i_bucket_ref(*args7), iters=5),
               int8_ops_ms(b_pad, n, d_pad, 6), base_bytes + 12 * n + 8 * b_pad,
               0.0, library_ms=lib, other=dp4a)
    check_beats("sq8i_bucket_v1", ms, FIRST_INT8_MS["sq8i_bucket_v1"], lib,
                first="the first (dp4a) design")
    for variant in ("v2", "v2h", "v3"):
        name = f"sq8i_{variant}_bucket"
        (qi, rows8, aux, qaux, chunk, _), _ = call_of("exp_sq8i_v2", name)
        vargs = (qi, rows8, aux, qaux, chunk, variant)
        if variant == "v3":
            ops_ms, extra = int8_ops_ms(b_pad, n, d_pad, 0), 0

            def lib(qi=qi, rows8=rows8, chunk=chunk):
                return bucket_max(torch._int_mm(qi, rows8.T), chunk)
        else:
            item = aux.element_size()
            ops_ms = int8_ops_ms(b_pad, n, d_pad, 5)
            extra = 3 * item * n + 2 * item * b_pad
            if variant == "v2":
                def lib(qi=qi, rows8=rows8, aux=aux, qaux=qaux, chunk=chunk):
                    corr = qaux[:, 1:2] * aux[1] + qaux[:, 2:3] * aux[2]
                    dot = torch._int_mm(qi, rows8.T).float()
                    return bucket_max(dot * aux[0] + corr, chunk)
            else:
                def lib(qi=qi, rows8=rows8, aux=aux, qaux=qaux, chunk=chunk):
                    corr = qaux[:, 1:2] * aux[1] + qaux[:, 2:3] * aux[2]
                    dot = torch._int_mm(qi, rows8.T).to(torch.bfloat16)
                    return bucket_max(dot * aux[0] + corr, chunk)
        ms = time_kernel(torch, lambda: xk.sq8i_v2_bucket_gm(*vargs))
        lib_ms = time_kernel(torch, lib)
        kernel_row(name, "sq8i_bucket.cu", rows[name][3], ms,
                   time_kernel(torch, lambda: xk.sq8i_v2_bucket_ref(*vargs), iters=5),
                   ops_ms, base_bytes + extra, held["exp_sq8i_v2", name], library_ms=lib_ms,
                   other=dp4a)
        check_beats(name, ms, FIRST_INT8_MS[name], lib_ms, first="the first (dp4a) design")
    say("#12 library yardsticks: torch._int_mm(qi, rows8.T), the variant's epilogue (v2h in "
        "bf16 tensors), then the bucket amax; the bounds count the int8 products at 1,979 "
        "TOPS and 6 (v1), 5 (v2, v2h: v2h rounds each fp32 result to bf16) or no (v3) "
        "epilogue operations a (query, row) at the fp32 rate")

    def pd_row(name, exp, pick):
        (qi, rows_pd, ptile, chunk), _ = call_of(exp, "sq8pd_bucket_gm", pick)
        b_pad, d_pad = qi.shape
        n = rows_pd.shape[0]
        ms = time_kernel(torch, lambda: bk.sq8pd_bucket_gm(qi, rows_pd, ptile, chunk))
        lib = time_kernel(torch, lambda: bucket_max(torch._int_mm(qi, rows_pd.T) * 64 + ptile,
                                                    chunk))
        kernel_row(name, "sq8i_bucket.cu", rows[name][3], ms,
                   time_kernel(torch, lambda: bk.sq8pd_bucket_gm_ref(qi, rows_pd, ptile, chunk),
                               iters=5),
                   int8_ops_ms(b_pad, n, d_pad, 2),
                   qi.numel() + rows_pd.numel() + 4 * n + 4 * b_pad * n // chunk * 128,
                   held[exp, "sq8pd_bucket_gm"], library_ms=lib,
                   other=(DP4A_FIRST, b_pad * n * d_pad / 4, dp4a_rate))
        check_beats(name, ms, FIRST_INT8_MS[name], lib, first="the first (dp4a) design")
        return n, chunk

    pd_row("sq8pd_bucket_v5", "exp_sq8i_v2", lambda a, k: a[0].shape[0] >= 256)
    n_h, c_h = pd_row("sq8pd_bucket_hme", "exp_hamming_mxu",
                      lambda a, k: a[3] == 2048 and a[0].shape[0] >= 256)
    say(f"#1 at the experiments' shapes: _k_v5 on the per-dimension shadow (N 1,048,576, chunk "
        f"8192), _k_hme on the bit rows (N {n_h}, chunk {c_h}); bound: int8 products + 2 "
        "epilogue operations a score at the fp32 rate; library yardstick torch._int_mm * 64 + "
        "ptile, then the bucket amax")

    (qi, bits, aux, chunk), _ = call_of("exp_hamming_mxu", "hamming_mxu_gm",
                                        lambda a, k: a[3] == 2048 and a[0].shape[0] >= 256)
    b_pad, d_pad = qi.shape
    n = bits.shape[0]
    ms = time_kernel(torch, lambda: bk.hamming_mxu_gm(qi, bits, aux, chunk))
    lib = time_kernel(torch, lambda: bucket_max(torch._int_mm(qi, bits.T) - aux, chunk))
    kernel_row("hamming_mxu_bucket_hm", "sq8i_bucket.cu", rows["hamming_mxu_bucket_hm"][3], ms,
               time_kernel(torch, lambda: bk.hamming_mxu_ref(qi, bits, aux, chunk), iters=5),
               int8_ops_ms(b_pad, n, d_pad, 1),
               qi.numel() + bits.numel() + 4 * n + 8 * b_pad * n // chunk * 128,
               held["exp_hamming_mxu", "hamming_mxu_gm"], library_ms=lib,
               other=(DP4A_FIRST, b_pad * n * d_pad / 4, dp4a_rate))
    check_beats("hamming_mxu_bucket_hm", ms, FIRST_INT8_MS["hamming_mxu_bucket_hm"], lib,
                first="the first (dp4a) design")

    for name, key in (("dense_bucket_exp_topk", "dense_bucket_gm"),
                      ("dense_bucket_tc_exp_topk", "dense_bucket_tc")):
        (q2, corp, cc, chunk), _ = call_of("exp_topk", key, lambda a, k: a[0].shape[0] >= 256)
        b_pad, d = q2.shape
        n = corp.shape[0]
        half = corp.dtype != torch.float32
        # the products on the tensor cores: one a term on half rows, three
        # (hi.qhi, lo.qhi, hi.qlo) on f32 rows; and the - cc
        ops = (2 if half else 6) * b_pad * n * d + b_pad * n
        plain_fn = (lambda: bk.half_scan_tolerance(q2, corp, cc, chunk)) if half else (
            lambda: bk.dense_bucket_ref(q2, corp, cc, chunk))
        lib = (lambda: bucket_max(mm_f32(torch, q2, corp.T) - cc, chunk)) if half else (
            lambda: bucket_max(q2 @ corp.T - cc, chunk))
        kernel_row(name, rows[name][2], rows[name][3],
                   time_kernel(torch, lambda: bk.dense_bucket_gm(q2, corp, cc, chunk)),
                   time_kernel(torch, plain_fn, iters=2), ops / PEAK_TC16 * 1e3,
                   q2.numel() * q2.element_size() + corp.numel() * corp.element_size() + 4 * n
                   + 8 * b_pad * n // chunk * 128,
                   held["exp_topk", key], library_ms=time_kernel(torch, lib),
                   other=None if half else (F32_CORES, 2 * b_pad * n * d + b_pad * n, PEAK_F32))
    say("#13 at exp_topk's shape (B 256, N 1,048,576, D 128, pchunk 2048): #2 on the f32 rows "
        "(three bf16 products a term on the tensor cores), #2b on the bf16 rows, both on the "
        f"doubled queries; library yardstick q @ rows.T (bf16: {MM_F32['how']}) - |c|^2, then "
        "the bucket amax")

    gather_phase(torch, first, held, rows, kernel_row)
    for name in rows:
        errs[name] = held.get((rows[name][0], rows[name][1]), errs.get(name, 0.0))


def graph_phase(torch, dev, counters, launches, errs, sift_oi, of_i) -> None:
    """Phase 10, ``sift1m-graph``: the phase 3 data (made again from its
    seed: phase 5c frees it) through ``Database`` ->
    ``create_collection(index_kind="graph")`` with ``GraphParams.auto``
    (degree 64, knn_k 32, build_nprobe 32, entry_probes 64, entry_points 96,
    expand_width 16), #10 as the beam's SQ8 entry scan."""
    from velesdb_tpu_torch import Database
    import velesdb_tpu_torch.index.graph_index as gmod
    import velesdb_tpu_torch.index.ivf as ivf_mod
    from velesdb_tpu_torch.index.params import GraphParams
    from velesdb_tpu_torch.ops import ivf_kernel as ik

    t_phase = time.perf_counter()
    sift_all = make_clustered(np.random.default_rng(42), SIFT_N + HELD_OUT, SIFT_D)
    sift, sift_q = sift_all[:SIFT_N], sift_all[SIFT_N:]
    filt = {"type": "eq", "field": "cat", "value": 3}
    tmp = tempfile.mkdtemp(prefix="velesdb_chip_graph_")
    try:
        t0 = time.perf_counter()
        db = Database.open(tmp, device=DEVICE)
        col = db.create_collection("sift1m_graph", SIFT_D, metric="euclidean", index_kind="graph")
        col.upsert_bulk(range(SIFT_N), sift, [{"cat": i % 8} for i in range(SIFT_N)])
        col.refresh_device()
        torch.cuda.synchronize()
        say(f"sift1m-graph ingest + device refresh: {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        prof = {}
        t0 = time.perf_counter()
        check(col._ensure_ann(force=True, profile=prof), "sift1m-graph: no graph built")
        gi, eiv = col.ann, col.ann._entry_ivf
        say(f"sift1m-graph build {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in prof.items()))
        say(f"sift1m-graph build peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        want = GraphParams.auto(SIFT_D, SIFT_N)
        check(gi.params == want, f"sift1m-graph params {gi.params} are not auto's {want}")
        check(eiv is not None and eiv.storage == "sq8" and gi._route_cents is not None,
              "sift1m-graph: no SQ8 entry IVF or router")
        say(f"sift1m-graph index: n_pad {gi.n_pad}, degree {gi._adj.shape[1]}, router "
            f"{gi._route_cents.shape[0]} partitions; entry IVF {eiv.c_real} partitions "
            f"({eiv.c} padded), L {eiv.part_len}, probes {gi.params.entry_probes}, dispatch "
            f"cap {gi._dispatch_cap()}")
        calib = {e: col.planner.engine_recall("graph", e) for e in (16, 32, 64, 128, 256)}
        print("sift1m-graph calibrated recall per ef: " + ", ".join(
            f"ef {e} {r:.4f}" for e, r in calib.items()), flush=True)

        def probe_desc(q, qsum, probe, rows, aux):
            return (f"ivf_probe sq8 B {q.shape[0]}, nprobe {probe.shape[1]}, L {rows.shape[1]}, "
                    f"D_pad {q.shape[1]} (graph entry)")

        res = {}
        with MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
            for ef in (128, 64, 256):
                res[ef] = []
                for i in range(0, 256, 16):
                    res[ef] += col.search_batch(sift_q[i:i + 16], k=K, ef=ef)
                    run.launched(f"search_batch b=16 ef={ef} (queries {i}-{i + 15})")
            r256 = col.search_batch(sift_q[:256], k=K, ef=128)
            run.launched("search_batch b=256 ef=128")
            r1 = col.search(sift_q[300], k=K, ef=128)
            run.launched("search")
            check(all(c[0][2].shape[1] == gi.params.entry_probes for c in run.calls),
                  "sift1m-graph: #10 did not probe entry_probes partitions")
        launches["ivf_probe"] += run.launches()
        n_launch = run.launches()
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(ik.ivf_probe_ref, probe_desc))
        say(f"sift1m-graph: {n_launch} launches of #10 on the main path, each equal to its "
            f"plain version bit for bit")
        # the b = 16 searches again with #10's plain version patched in
        kernel = ik.ivf_probe_scores
        ik.ivf_probe_scores = lambda q, qsum, probe, rows, aux, sched=None: ik.ivf_probe_ref(
            q, qsum, probe, rows, aux)
        try:
            plain16 = []
            for i in range(0, 256, 16):
                plain16 += col.search_batch(sift_q[i:i + 16], k=K, ef=128)
        finally:
            ik.ivf_probe_scores = kernel
        check([[h.id for h in r] for r in plain16] == [[h.id for h in r] for r in res[128]],
              "sift1m-graph: the b=16 searches through #10's plain version returned other ids")
        rec = {ef: ids_recall(rows, sift_oi[:256]) for ef, rows in res.items()}
        print(f"sift1m-graph recall@10 vs float64 oracle, b=16 over 256 queries: ef 64 "
              f"{rec[64]:.4f}, ef 128 {rec[128]:.4f}, ef 256 {rec[256]:.4f}; b=256 ef 128 "
              f"{ids_recall(r256, sift_oi[:256]):.4f}, search "
              f"{ids_recall([r1], sift_oi[300:301]):.4f}; the b=16 searches through #10's "
              f"plain version: identical ids", flush=True)
        check(rec[128] >= 0.95, f"sift1m-graph recall@10 b=16 ef=128 = {rec[128]:.4f} < 0.95")

        # filters: the starvation guards (an ef bump, capped at the beam's
        # 512, with the entry IVF; exact past 512 without it; exact at no
        # passing row) and the masked entry scan
        mask = col._filter_mask(filt)
        plan10 = col._plan_search(sift_q[:16], K, mask, ef=128)
        plan100 = col._plan_search(sift_q[:16], 100, mask, ef=128)
        none = col._plan_search(sift_q[:16], K, col._filter_mask(
            {"type": "eq", "field": "cat", "value": 99}), ef=128)
        check(plan10[:3] == ("graph", 40, 480) and plan100[:3] == ("graph", 128, 512)
              and none[0] == "exact",
              f"sift1m-graph guard plans {plan10}, {plan100}, {none}")
        saved, gi._entry_ivf = gi._entry_ivf, None
        try:
            plain_guard = (col._plan_search(sift_q[:16], K, mask, ef=128),
                           col._plan_search(sift_q[:16], 100, mask, ef=128))
            routed = col.search_batch(sift_q[:16], k=K, ef=128, filter=filt)
        finally:
            gi._entry_ivf = saved
        check(plain_guard[0][:3] == ("graph", 40, 480) and plain_guard[1][0] == "exact",
              f"sift1m-graph guard plans without the entry IVF {plain_guard}")
        before = ik.LAUNCHES["ivf_probe"]
        f16 = []
        for i in range(0, 256, 16):
            f16 += col.search_batch(sift_q[i:i + 16], k=K, ef=128, filter=filt)
        f100 = col.search_batch(sift_q[:16], k=100, ef=128, filter=filt)
        check(ik.LAUNCHES["ivf_probe"] == before, "a filtered graph search launched #10")
        bad = [h.id for rows in (f16, f100, routed) for r in rows for h in r
               if h.id % 8 != 3 or h.payload != {"cat": 3}]
        check(not bad, f"sift1m-graph filtered search returned filtered-out ids {bad[:5]}")
        hits = [len(r) for r in f100]
        print(f"sift1m-graph filtered (cat 1/8): recall@10 b=16 ef 128 (served at ef "
              f"{plan10[2]}) {ids_recall(f16, of_i[:256]):.4f}, k=100 served at ef "
              f"{plan100[2]} with {min(hits)}-{max(hits)} hits a query; routed entries (entry "
              f"IVF set aside, ef {plain_guard[0][2]}) recall@10 "
              f"{ids_recall(routed, of_i[:16]):.4f}; no filtered-out id; the no-entry-IVF "
              f"guard sends k=100 to exact, an empty filter to exact", flush=True)

        # timing: search_batch p50, the device path, busy, idle share, top kernels
        measure(torch, "sift1m-graph ef=128", lambda b: col.search_batch(b, k=K, ef=128),
                "sift1m-graph device path ef=128 (no hydrate)",
                lambda b: col._search_device(b, K, None, ef=128)[1].cpu(), sift_q, (256, 16))
        # #10 at the entry shape, and the beam's gather-and-score step alone
        corpus = gi._corpus
        for b in (16, 256):
            qt = torch.from_numpy(sift_q[:b]).to(dev)
            args = ik.probe_operands(qt, eiv._centroids, eiv._cent_sq, eiv._parts,
                                     nprobe=gi.params.entry_probes, metric=gi.metric)[:3]
            q, qsum, probe = args
            aux = eiv._kernel_state()[0]
            out = ik.ivf_probe_scores(q, qsum, probe, eiv._parts, aux)
            errs["ivf_probe"] = max(errs["ivf_probe"], hold(
                f"ivf_probe sq8 B {b}, nprobe {probe.shape[1]}, L {eiv.part_len} (graph entry)",
                out, ik.ivf_probe_ref(q, qsum, probe, eiv._parts, aux)))
            ms = time_kernel(torch, lambda: ik.ivf_probe_scores(q, qsum, probe, eiv._parts, aux))
            plain = time_kernel(torch, lambda: ik.ivf_probe_ref(q, qsum, probe, eiv._parts, aux),
                                iters=2)
            L, width = eiv.part_len, eiv._parts.shape[2]
            uniq = int(torch.unique(probe).numel())
            slots = b * probe.shape[1] * L
            bytes_ = uniq * L * (4 * width + 12) + 4 * (q.numel() + b + probe.numel() + slots)
            ops = 2 * slots * q.shape[1] + 4 * slots
            b_ms, b_by = bound(ops / PEAK_F32 * 1e3, bytes_)
            say(f"ivf_probe graph entry b={b} (nprobe {probe.shape[1]}, L {L}, D_pad "
                f"{q.shape[1]}, {uniq} unique partitions of {probe.numel()} probes): kernel "
                f"{ms:.4f} ms, plain torch {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{b_ms / ms:.4f} of it); library yardstick: none (SQ8 words)")
            busy, top = device_profile(
                torch, lambda _: ik.ivf_probe_scores(q, qsum, probe, eiv._parts, aux), [0] * 10)
            split = (f"device {busy:.4f} ms a call (torch.profiler): " + ", ".join(
                f"{name[:40]} {t:.4f} ms" for name, t in top)) if busy > 0.0 else (
                "the schedule / scan split not measured (no device events in the profile)")
            say(f"ivf_probe graph entry b={b}: {probe.numel()} probes, the schedule "
                f"{'from probe_runs' if probe.numel() > ik.SCHED_RANK_MAX else 'ranked on the card'}"
                f"; {split}")
            ew, deg = gi.params.expand_width, gi._adj.shape[1]
            g = torch.Generator(device="cpu").manual_seed(b)
            bids = torch.randint(0, SIFT_N, (b, ew), generator=g).to(dev)
            nbrs = gi._adj[bids].reshape(b, ew * deg).long()
            qn = qt.float()

            def step():
                return torch.bmm(corpus[nbrs], qn[:, :, None])[:, :, 0]

            gms = time_kernel(torch, step)
            rows = b * ew * deg
            g_bytes = rows * (SIFT_D * 4 + 8) + qn.numel() * 4 + rows * 4
            say(f"sift1m-graph beam gather-and-score step b={b} x ew {ew} x degree {deg} = "
                f"{rows} per-query rows of {SIFT_D} f32: {gms:.4f} ms (corpus[ids] gather + "
                f"bmm), bytes bound {g_bytes / PEAK_BYTES * 1e3:.4f} ms "
                f"({g_bytes / PEAK_BYTES * 1e3 / gms:.4f} of it); "
                f"{max(2, -(-128 // ew))} steps a search at ef 128")
            del out

        # close + reopen: ann.npz and .entry.npz restore with no k-means run
        ids_before = [[h.id for h in r] for r in res[128][:64]]
        db.close()
        db = Database.open(tmp, device=DEVICE)
        col = db.get_collection("sift1m_graph")
        col.index_kind = "graph"
        km_calls, builds = [], []
        km, build = ivf_mod.kmeans, gmod.GraphIndex.build
        ivf_mod.kmeans = lambda *a, **kw: km_calls.append(1) or km(*a, **kw)
        gmod.GraphIndex.build = lambda *a, **kw: builds.append(1) or build(*a, **kw)
        try:
            t0 = time.perf_counter()
            with MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
                re16 = []
                for i in range(0, 64, 16):
                    re16 += col.search_batch(sift_q[i:i + 16], k=K, ef=128)
                    run.launched(f"reopened search_batch b=16 (queries {i}-{i + 15})")
            say(f"sift1m-graph reopen: load, entry-IVF reassembly, calibration and 4 searches "
                f"{time.perf_counter() - t0:.2f} s")
        finally:
            ivf_mod.kmeans, gmod.GraphIndex.build = km, build
        launches["ivf_probe"] += run.launches()
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(ik.ivf_probe_ref, probe_desc))
        check(not km_calls and not builds, "sift1m-graph reopen ran k-means or a build")
        check([[h.id for h in r] for r in re16] == ids_before,
              "reopened sift1m-graph returned other ids")
        print("sift1m-graph close + reopen: restored from ann.npz and ann.npz.entry.npz with no "
              "k-means run and no build; same ids for 64 queries", flush=True)

        # upserts after the build: found through the graph delta, which
        # leaves the unmasked searches on #10 (the stale slots dead in a
        # copy of its state); the b=16 path timed before and after, with the
        # graph's own share apart
        b16 = [sift_q[i:i + 16] for i in range(0, 16 * (TIMED_CALLS + 1), 16)]

        def med16(fn):
            return statistics.median(time_calls(torch, fn, b16))

        t_pre = med16(lambda b: col._search_device(b, K, None, ef=128)[1].cpu())
        new = sift_q[1000:1000 + IVF_UPSERTS] + 0.01
        col.upsert_bulk(range(SIFT_N, SIFT_N + IVF_UPSERTS), new, [{"cat": 8}] * IVF_UPSERTS)
        with MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
            found = col.search_batch(new[:64], k=K, ef=128)
            run.launched("search_batch b=64 after the upserts")
            u16 = []
            for i in range(0, 256, 16):
                u16 += col.search_batch(sift_q[i:i + 16], k=K, ef=128)
                run.launched(f"search_batch b=16 after the upserts (queries {i}-{i + 15})")
            u256 = col.search_batch(sift_q[:256], k=K, ef=128)
            run.launched("search_batch b=256 after the upserts")
        launches["ivf_probe"] += run.launches()
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(ik.ivf_probe_ref, probe_desc))
        check(not col.ann.dirty, "sift1m-graph upserts marked the graph dirty")
        check([r[0].id for r in found] == list(range(SIFT_N, SIFT_N + 64)),
              "sift1m-graph upserted rows not found through the delta")
        ru = ids_recall(u16, sift_oi[:256])
        check(ru >= 0.95, f"sift1m-graph recall@10 b=16 after the upserts = {ru:.4f} < 0.95")
        print(f"sift1m-graph: {IVF_UPSERTS} rows upserted after the build found through the "
              f"delta ({len(col._stale['graph'])} stale slots, searched exactly beside the "
              f"graph, which leaves them out: #10 on every unmasked search, the slots dead in "
              f"its state); recall@10 ef=128 b=16 {ru:.4f}, b=256 "
              f"{ids_recall(u256, sift_oi[:256]):.4f}", flush=True)
        gi = col.ann
        stale = np.fromiter(col._stale["graph"], np.int64)
        t_dev = med16(lambda b: col._search_device(b, K, None, ef=128)[1].cpu())
        t_idx = med16(lambda b: gi.search(b, K, ef=128)[1].cpu())
        t_ex = med16(lambda b: gi.search(b, K, ef=128, exclude=stale)[1].cpu())
        say(f"sift1m-graph b=16 ef=128, median ms of {TIMED_CALLS} calls (CUDA events): the "
            f"reopened collection's device path before the upserts {t_pre:.4f}, after "
            f"{t_dev:.4f}; GraphIndex.search alone {t_idx:.4f}, with the delta's "
            f"{len(stale)} slots as exclude {t_ex:.4f}")
        measure(torch, "sift1m-graph after the upserts ef=128",
                lambda b: col.search_batch(b, k=K, ef=128),
                "sift1m-graph after the upserts device path ef=128 (no hydrate)",
                lambda b: col._search_device(b, K, None, ef=128)[1].cpu(), sift_q, (256, 16))
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"phase 10 sift1m-graph: {time.perf_counter() - t_phase:.1f} s")


def hybrid_data(n, d, n_queries):
    """``benchmarks/exp_hybrid.py``'s recipe: seed 42, 64 centers x 2.0,
    noise 0.7, payloads ``{"text": "topic topic w1 w2", "price": U(1, 100)}``
    over ``HYB_VOCAB``; each query a center plus noise, its text the
    center's topic word. Returns ``(corpus, payloads, queries, texts)``."""
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, 64, n)
    corpus = centers[assign] + 0.7 * rng.standard_normal((n, d)).astype(np.float32)
    words = np.array(HYB_VOCAB)
    topic = words[assign % len(HYB_VOCAB)]
    payloads = []
    for i in range(n):
        extra = " ".join(words[rng.integers(0, len(words), 2)])
        payloads.append({"text": f"{topic[i]} {topic[i]} {extra}",
                         "price": float(rng.uniform(1, 100))})
    qa = rng.integers(0, 64, n_queries)
    queries = centers[qa] + 0.7 * rng.standard_normal((n_queries, d)).astype(np.float32)
    return corpus, payloads, queries, [str(words[a % len(words)]) for a in qa]


def same_fused(got, want, tol=1e-6) -> bool:
    """A device-fused row against a host fusion ``[(id, score)]``: the same
    ids in the same order, except where the host's scores tie within
    ``tol`` (f32 on the card, f64 on the host)."""
    want = [(vid, s) for vid, s in want if s > 0]
    if [h.id for h in got] == [vid for vid, _ in want]:
        return True
    if len(got) != len(want):
        return False
    for h, (vid, s) in zip(got, want):
        if abs(h.score - s) > tol:
            return False
    kth = want[-1][1]
    loose = {vid for vid, s in want if s <= kth + tol} | {h.id for h in got if h.score <= kth + tol}
    return {h.id for h in got} - loose == {vid for vid, _ in want} - loose


def hybrid_phase(torch, dev, counters, launches, errs) -> None:
    """Phase 11, ``hybrid``: text and hybrid search through ``Database`` ->
    ``Collection`` on three configurations of ``benchmarks/exp_hybrid.py``,
    then the rest of the collection's surface and exact hamming / jaccard.
    Host-clock times are taken before any profile of the phase."""
    from velesdb_tpu_torch import Database
    from velesdb_tpu_torch import collection as cm
    from velesdb_tpu_torch.fusion import FusionStrategy, weighted_rrf
    from velesdb_tpu_torch.ops import bucket_kernel as bk
    from velesdb_tpu_torch.ops.topk import pad_mask
    from velesdb_tpu_torch.text.bm25 import Bm25Index

    t_phase = time.perf_counter()
    k, fetch, w = K, 2 * K, 0.5
    cells = {}  # name -> (col, queries, texts, device path, sizes)
    tmp = tempfile.mkdtemp(prefix="velesdb_chip_hybrid_")
    db = Database.open(tmp, device=DEVICE)
    fused_calls = []  # device fusions: the device-fused form served the call
    rrf = cm.rrf_fuse_topk
    cm.rrf_fuse_topk = lambda *a, **kw: fused_calls.append(1) or rrf(*a, **kw)
    try:
        def build(name, n, d, mode, n_queries):
            t0 = time.perf_counter()
            corpus, payloads, qv, qt = hybrid_data(n, d, n_queries)
            t1 = time.perf_counter()
            col = db.create_collection(name, d, metric="cosine", storage_mode=mode)
            for s in range(0, n, 50_000):
                col.upsert_bulk(range(s, min(s + 50_000, n)), corpus[s : s + 50_000],
                                payloads[s : s + 50_000])
            t2 = time.perf_counter()
            col.refresh_device()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            col._ensure_text()
            col.text_index.refresh(n)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            raw = col._raw_filter_mask(HYB_FILTER)
            t5 = time.perf_counter()
            say(f"{name} set-up: data {t1 - t0:.2f} s, ingest {t2 - t1:.2f} s, device refresh "
                f"{t3 - t2:.2f} s, BM25 build {t4 - t3:.2f} s ({len(col.text_index)} docs, "
                f"{col.text_index._block_docs.shape[0]} blocks, n_pad {col.text_index.n_pad}), "
                f"columns {t5 - t4:.2f} s; serve_engine(fetch {fetch}) "
                f"{col._brute.serve_engine(fetch)!r}")
            return corpus, payloads, qv, qt, col, raw

        def branch_lists(col, qv, qt, raw):
            """The two branches of the device-fused form read back, as host
            lists."""
            mask = pad_mask(raw, col._brute.n_pad, dev)
            v_vals, v_idx = col._brute.search(qv, fetch, mask=mask)
            t_vals, t_idx = col.text_index.search_batch(list(qt), fetch, col.vectors.used_slots,
                                                        mask=raw)
            ids, _ = col.vectors.occupancy()
            v_vals, v_idx = v_vals.cpu().numpy(), v_idx.cpu().numpy()
            vec = [[(int(ids[s]), float(v)) for v, s in zip(vr, ir) if s >= 0]
                   for vr, ir in zip(v_vals, v_idx)]
            txt = [[(int(ids[s]), float(v)) for v, s in zip(vr, ir) if s >= 0 and v > 0]
                   for vr, ir in zip(t_vals, t_idx)]
            return vec, txt

        def oracle_overlap(name, col, corpus64, qv, qt, raw, got):
            """Overlap@10 against a host fusion of a float64-oracle vector
            top-20 (the filter applied) with the same BM25 list."""
            keep = torch.from_numpy(np.asarray(raw, bool)).to(dev)
            ov, oi = oracle_topk(torch, corpus64, qv, "cosine", fetch, mask=keep)
            t_vals, t_idx = col.text_index.search_batch(list(qt), fetch, col.vectors.used_slots,
                                                        mask=raw)
            ids, _ = col.vectors.occupancy()
            over = []
            for i, row in enumerate(got):
                vec = [(int(s), float(v)) for v, s in zip(ov[i], oi[i])]
                txt = [(int(ids[s]), float(v)) for v, s in zip(t_vals[i], t_idx[i])
                       if s >= 0 and v > 0]
                want = {vid for vid, _ in weighted_rrf(vec, txt, k, vector_weight=w)}
                over.append(len({h.id for h in row} & want) / k)
            o = float(np.mean(over))
            print(f"{name} overlap@10 vs the host fusion of a float64-oracle vector top-20 "
                  f"with the same BM25 list: {o:.4f}", flush=True)
            check(o >= 0.95, f"{name} overlap@10 {o:.4f} < 0.95")

        def cpu_bm25_equal(name, col, qt, raw):
            """Check 4: the BM25 branch on the card against the same blocks
            scored on the CPU, bit for bit."""
            ti = col.text_index
            cpu = Bm25Index("cpu")
            cpu.load_state({"block_docs": ti._block_docs.cpu(),
                            "block_scores": ti._block_scores.cpu(), "vocab": ti._vocab,
                            "term_blocks": ti._term_blocks, "n_pad": ti.n_pad})
            used = col.vectors.used_slots
            for m in (None, raw):
                cv, cs = ti.search_batch_dev(list(qt), fetch, used, mask=m)
                hv, hs = cpu.search_batch_dev(list(qt), fetch, used, mask=m)
                check(torch.equal(cs.cpu(), hs) and torch.equal(cv.cpu().view(torch.int32),
                                                                hv.view(torch.int32)),
                      f"{name}: the card's BM25 scores differ from the CPU's")
            print(f"{name}: BM25 on the card equals the CPU's bit for bit ({len(qt)} queries, "
                  f"with and without the filter)", flush=True)

        def rrf_check(name, col, qv, qt, raw, res16):
            """Check 3 at b 16: the device RRF against the host fusion of
            the two branch lists read back."""
            vec, txt = branch_lists(col, qv[:16], qt[:16], raw)
            bad = [i for i in range(16)
                   if not same_fused(res16[i], weighted_rrf(vec[i], txt[i], k, vector_weight=w))]
            check(not bad, f"{name}: device RRF differs from fusion.weighted_rrf on rows {bad}")
            print(f"{name}: device RRF = fusion.weighted_rrf over the branch lists read back "
                  f"at b=16", flush=True)

        def no_pricey(name, rows):
            bad = [h.id for row in rows for h in row if h.payload["price"] >= 50.0]
            check(not bad, f"{name}: price >= 50 returned: {bad[:5]}")

        # -- hybrid-1m-128d: the vector branch is int8-assist-pd (#1) --------
        name = "hybrid-1m-128d"
        corpus, payloads, qv, qt, col, raw = build(name, HYB_N, HYB_D, "full", HYB_QUERIES)
        del payloads
        check(col._brute.serve_engine(fetch) == "int8-assist-pd",
              f"{name}: serve_engine {col._brute.serve_engine(fetch)!r}")
        fused_calls.clear()
        with MainPath(counters, bk, "sq8pd_bucket_gm", "sq8pd_bucket_gm") as run:
            res256 = col.hybrid_search_batch(qv[:256], qt[:256], k=k, vector_weight=w,
                                             filter=HYB_FILTER)
            run.launched(f"{name} hybrid_search_batch b=256")
            res16 = col.hybrid_search_batch(qv[:16], qt[:16], k=k, vector_weight=w,
                                            filter=HYB_FILTER)
            run.launched(f"{name} hybrid_search_batch b=16")
            one = col.hybrid_search(qv[300], qt[300], k=k, vector_weight=w)
            run.launched(f"{name} hybrid_search")
        check(len(fused_calls) == 3,
              f"{name}: the device-fused form served {len(fused_calls)} of 3 calls")
        launches["sq8pd_bucket"] += run.launches()
        errs["sq8pd_bucket"] = max(errs["sq8pd_bucket"], run.hold_all(
            lambda qi, rows, pt, ch: bk.sq8pd_bucket_gm_ref(qi, rows, pt, ch),
            lambda qi, rows, pt, ch: (f"sq8pd_bucket B_pad {qi.shape[0]}, N {rows.shape[0]}, "
                                      f"D_pad {rows.shape[1]}, chunk {ch} ({name})")))
        print(f"{name}: {run.launches()} #1 launches on the hybrid main path, each equal to "
              f"its plain version", flush=True)
        check(len(one) == k, f"{name}: hybrid_search returned {len(one)} hits")
        no_pricey(name, res256 + res16)
        rrf_check(name, col, qv, qt, raw, res16)
        cpu_bm25_equal(name, col, qt[:16], raw)
        corpus64 = unit64(torch, corpus, dev)
        oracle_overlap(name, col, corpus64, qv[:256], qt[:256], raw, res256)
        cells[name] = (col, qv, qt, raw, (256, 16))

        # -- hybrid-100k-768d: the reference's config #4, streamed-scan -------
        name = "hybrid-100k-768d"
        c768, _, qv768, qt768, col768, raw768 = build(name, HYB768_N, HYB768_D, "full",
                                                      HYB_QUERIES)
        check(col768._brute.serve_engine(fetch) == "streamed-scan",
              f"{name}: serve_engine {col768._brute.serve_engine(fetch)!r}")
        fused_calls.clear()
        r768 = col768.hybrid_search_batch(qv768[:256], qt768[:256], k=k, vector_weight=w,
                                          filter=HYB_FILTER)
        r768_16 = col768.hybrid_search_batch(qv768[:16], qt768[:16], k=k, vector_weight=w,
                                             filter=HYB_FILTER)
        check(len(fused_calls) == 2,
              f"{name}: the device-fused form served {len(fused_calls)} of 2 calls")
        no_pricey(name, r768 + r768_16)
        rrf_check(name, col768, qv768, qt768, raw768, r768_16)
        cpu_bm25_equal(name, col768, qt768[:16], raw768)
        oracle_overlap(name, col768, unit64(torch, c768, dev), qv768[:256],
                       qt768[:256], raw768, r768)
        del c768
        cells[name] = (col768, qv768, qt768, raw768, (256, 16))

        # -- hybrid-sq8-262k: host-fused, the vector branch sq8-int8 (#7) -----
        name = "hybrid-sq8-262k"
        csq, _, qsq, tsq, colsq, rawsq = build(name, HYB_SQ8_N, HYB_D, "sq8", HYB_QUERIES)
        check(colsq._brute.serve_engine(fetch * 4) == "sq8-int8",
              f"{name}: serve_engine {colsq._brute.serve_engine(fetch * 4)!r}")
        fused_calls.clear()
        with MainPath(counters, bk, "sq8i_bucket_gm", "sq8i_bucket_gm") as run:
            t0 = time.perf_counter()
            rsq = colsq.hybrid_search_batch(qsq[:16], tsq[:16], k=k, vector_weight=w,
                                            filter=HYB_FILTER)
            say(f"{name} first hybrid_search_batch b=16 (with the storage gate): "
                f"{time.perf_counter() - t0:.2f} s, oversample {colsq._rerank_oversample}")
            run.launched(f"{name} hybrid_search_batch b=16")
            rsq2 = colsq.hybrid_search_batch(qsq[16:32], tsq[16:32], k=k, vector_weight=w,
                                             filter=HYB_FILTER)
            run.launched(f"{name} hybrid_search_batch b=16 (second)")
        check(not fused_calls, f"{name}: the device-fused form served a quantized collection")
        launches["sq8i_bucket"] += run.launches()
        errs["sq8i_bucket"] = max(errs["sq8i_bucket"], run.hold_all(
            bk.sq8i_bucket_ref,
            lambda qi, rows, *rest: (f"sq8i_bucket B_pad {qi.shape[0]}, N {rows.shape[0]}, "
                                     f"D_pad {rows.shape[1]}, chunk {rest[-1]} ({name})")))
        print(f"{name}: {run.launches()} #7 launches on the hybrid main path, each equal to "
              f"its plain version", flush=True)
        no_pricey(name, rsq + rsq2)
        oracle_overlap(name, colsq, unit64(torch, csq, dev), qsq[:32], tsq[:32],
                       rawsq, rsq + rsq2)
        del csq
        cells[name] = (colsq, qsq, tsq, rawsq, (16,))

        # -- host-clock times, before any profile of this phase ---------------
        timed = {}
        for name, (c, q, t, raw, sizes) in cells.items():
            idx = np.arange(q.shape[0])

            def e2e(ix, c=c, q=q, t=t):
                return c.hybrid_search_batch(q[ix], [t[i] for i in ix], k=k, vector_weight=w,
                                             filter=HYB_FILTER)

            if c._hybrid_fused_ok:
                def device(ix, c=c, q=q, t=t, raw=raw):
                    got = c._hybrid_device(q[ix], [t[i] for i in ix], k, fetch, raw, w_vec=w,
                                           w_txt=1 - w)
                    return got[1].cpu()
                path = "device-fused: #1 or the streamed scan, BM25, RRF; one readback"
            else:
                mask = pad_mask(raw, c._brute.n_pad, "cpu")
                m = max(k, int(round(c._rerank_oversample * fetch)))

                def device(ix, c=c, q=q, t=t, raw=raw, mask=mask, m=m):
                    v = c._search_device(q[ix], m, mask)[1].cpu()
                    c.text_index.search_batch_dev([t[i] for i in ix], fetch,
                                                  c.vectors.used_slots, mask=raw)[1].cpu()
                    return v
                path = (f"host-fused: #7 coarse pass at {m} a query, BM25, both read back, "
                        f"then the host f32 rerank and weighted_rrf")
            for b in sizes:
                med, batches = report_qps(torch, f"{name} hybrid_search_batch", e2e, idx, b)
                dmed, _ = report_qps(torch, f"{name} device path", device, idx, b)
                say(f"{name} b={b}: host share {1.0 - dmed / med:.3f} (1 - device path / "
                    f"hybrid_search_batch); device path = {path}")
                timed[name, b] = (e2e, med, batches)
        col_t = cells["hybrid-1m-128d"]
        tidx = np.arange(HYB_QUERIES)
        tmed, _ = report_qps(torch, "hybrid-1m-128d text_search_batch",
                             lambda ix: col_t[0].text_search_batch([col_t[2][i] for i in ix], k=k),
                             tidx, 256)
        print("(host-clock times above precede this phase's profiles; earlier phases' "
              "torch.profiler sessions still precede them)", flush=True)

        # -- profiles: busy, idle share, the top device operations -----------
        for (name, b), (fn, med, batches) in timed.items():
            busy, top = device_profile(torch, fn, batches[1:9], top=6)
            if busy <= 0.0:
                print(f"{name} b={b}: device busy not measured (no device events)", flush=True)
                continue
            say(f"{name} hybrid_search_batch b={b}: device busy {busy:.4f} ms/call, idle share "
                f"{1.0 - busy / med:.3f} (torch.profiler over 8 calls)")
            for op, t in top:
                say(f"    {t:.4f} ms/call  {op[:100]}")
        del cells["hybrid-100k-768d"], cells["hybrid-sq8-262k"]
        db.delete_collection("hybrid-100k-768d")
        del col768
        # phase 12 runs on this phase's 1M and SQ8 collections, then deletes
        # the SQ8 one
        phase("12. velesql-kg")
        t_phase += velesql_kg_phase(torch, dev, counters, launches, errs, db, col, qv, qt,
                                    colsq, qsq)
        del colsq

        # -- the rest of the collection's surface on hybrid-1m-128d ----------
        name = "hybrid-1m-128d"
        t0 = time.perf_counter()
        like = col.like_mask("%espresso%")
        say(f"{name}: trigram build at the first like_mask {time.perf_counter() - t0:.2f} s "
            f"({int(like.sum())} rows match %espresso%)")
        q256 = qv[:256]
        filters = [{"type": "lt", "field": "price", "value": 12.5 * (1 + i % 8)}
                   for i in range(256)]
        got = col.search_batch_with_filters(q256, k=k, filters=filters)
        for j in range(8):
            ix = list(range(j, 256, 8))
            want = col.search_batch(q256[ix], k=k, filter=filters[j])
            check(all([(h.id, h.score) for h in got[i]] == [(h.id, h.score) for h in row]
                      for i, row in zip(ix, want)),
                  f"{name}: search_batch_with_filters differs from filter group {j}")
            check(all(h.payload["price"] < filters[j]["value"] for i in ix for h in got[i]),
                  f"{name}: a per-query filter let a row through")
        print(f"{name}: search_batch_with_filters (256 queries, 8 filters) = 8 filtered "
              f"search_batch calls", flush=True)
        lists = col.search_batch(qv[:4], 2 * k)
        lists = [[(h.id, h.score) for h in row] for row in lists]
        for strategy, weights in (("rrf", None), ("average", None), ("maximum", None),
                                  ("weighted_average", [1.0, 0.5, 2.0, 1.0])):
            got = col.multi_query_search(qv[:4], k=k, strategy=strategy, weights=weights)
            want = FusionStrategy.parse(strategy).fuse(lists, k, weights=weights)
            check([(h.id, h.score) for h in got] == want,
                  f"{name}: multi_query_search {strategy} differs from the host fusion")
        print(f"{name}: multi_query_search rrf / average / maximum / weighted_average = the "
              f"host fusion of the per-query lists", flush=True)
        col.enable_result_cache()
        first = col.search(qv[400], k=k)
        again = col.search(qv[400], k=k)
        stats = col.cache_stats()
        check(again == first and stats["hits"] == 1 and stats["misses"] == 1,
              f"{name}: the repeated search was no cache hit ({stats})")
        ov, oi = oracle_topk(torch, corpus64, q256, "cosine", k + 1)
        oi = oi[:, :k]
        before = col.search_batch(q256, k=k)
        rec0 = ids_recall(before, oi)
        print(f"{name} search_batch k={k} (the pd core at m=16): recall@10 {rec0:.4f}; the "
              f"oracle's median relative gap between the 10th and 11th scores "
              f"{float(np.median((ov[:, k - 1] - ov[:, k]) / ov[:, k - 1])):.3e}", flush=True)
        n_ttl = 10_000
        ttl_vecs = -corpus[:n_ttl]  # new directions: each row its own nearest
        t0 = time.perf_counter()
        col.upsert_bulk(range(HYB_N, HYB_N + n_ttl), ttl_vecs,
                        [{"text": "ephemeral", "price": 1.0}] * n_ttl, ttl=3600.0)
        check(col.cache_stats()["size"] == 0, f"{name}: the upsert left the cache filled")
        hits = col.search_batch(ttl_vecs[:256], k=1)
        found = np.mean([row[0].id == HYB_N + i for i, row in enumerate(hits)])
        say(f"{name}: {n_ttl} rows upserted with a TTL, found before expiry "
            f"{found:.4f} (top-1 of their own vectors), {time.perf_counter() - t0:.2f} s")
        check(found >= 0.99, f"{name}: TTL rows found {found:.4f} before expiry")
        t0 = time.perf_counter()
        gone = col.expire_rows(now=time.time() + 3601.0)
        say(f"{name}: expire_rows removed {gone} rows in {time.perf_counter() - t0:.2f} s")
        check(gone == n_ttl and col.count() == HYB_N, f"{name}: expire_rows removed {gone}")
        after = col.search_batch(ttl_vecs[:256], k=k) + [col.search(ttl_vecs[0], k=k)]
        check(not [h.id for row in after for h in row if h.id >= HYB_N],
              f"{name}: an expired id was returned")
        t0 = time.perf_counter()
        report = col.vacuum()
        t_vac = time.perf_counter() - t0
        check(report["reclaimed_slots"] == n_ttl and report["fragmentation"] == 0.0,
              f"{name}: vacuum report {report}")
        res = col.search_batch(q256, k=k)
        torch.cuda.synchronize()
        say(f"{name}: vacuum {t_vac:.2f} s (reclaimed {report['reclaimed_slots']}), then the "
            f"first search_batch with the device refresh {time.perf_counter() - t0 - t_vac:.2f} s")
        check(col._brute.serve_engine(k) == "int8-assist-pd", f"{name}: core after vacuum")
        rec = ids_recall(res, oi)
        print(f"{name} after vacuum: recall@10 vs float64 oracle over the survivors {rec:.4f} "
              f"(before the TTL rows {rec0:.4f})", flush=True)
        # The survivors keep their slots, so the search must not move: the
        # same ids, scores within 1e-6, as before the TTL rows. The pd core's
        # recall@10 on this recipe sits below the 0.99 it reaches on sift1m
        # (its m = 16 candidates lose near-ties: the 10th-11th gap printed
        # above); the reference's pd core returns the same ids on it
        # (tests/test_torch_brute.py, 262,144 rows), so it is held to the
        # BALANCED bar.
        check(all([h.id for h in a] == [h.id for h in b]
                  and all(abs(h.score - g.score) <= 1e-6 for h, g in zip(a, b))
                  for a, b in zip(res, before)),
              f"{name}: the search after vacuum differs from the search before the TTL rows")
        check(rec >= 0.95, f"{name}: recall@10 after vacuum {rec:.4f} < 0.95")
        # phase 13 serves this directory: the float64 oracle of its held-out
        # queries over the survivors, before the corpus goes
        n_serve = SERVE_THREADS * SERVE_PER_THREAD
        serve_oi = oracle_topk(torch, corpus64, qv[SERVE_Q0 : SERVE_Q0 + n_serve], "cosine",
                               k)[1]
        del corpus, corpus64, col, cells

        # -- exact hamming and jaccard at 100,000 x 128 ----------------------
        x = make_clustered(np.random.default_rng(7), SET_N + 64, 128)
        xs, xq = x[:SET_N], x[SET_N:]
        cb = (xs > 0.5).astype(np.float32)
        qa = (xq > 0.5).astype(np.float32)
        inter = qa @ cb.T
        na, nb = qa.sum(1, keepdims=True), cb.sum(1)[None, :]
        for metric in ("hamming", "jaccard"):
            c = db.create_collection(f"set_{metric}", 128, metric=metric)
            c.upsert_bulk(range(SET_N), xs)
            check(c.info()["serve_engine"] == "fused-xla", f"{metric}: serve_engine")
            got = c.search_batch(xq, k=k)
            if metric == "hamming":
                s = (na + nb - np.float32(2.0) * inter).astype(np.float32)
                order = np.argsort(s, axis=1, kind="stable")[:, :k]
            else:
                union = na + nb - inter
                s = np.where(union > 0, inter / np.maximum(union, 1e-9), 1.0).astype(np.float32)
                order = np.argsort(-s, axis=1, kind="stable")[:, :k]
            check(all([h.id for h in row] == order[i].tolist()
                      and [h.score for h in row] == [float(v) for v in s[i, order[i]]]
                      for i, row in enumerate(got)),
                  f"{metric}: ids or scores differ from the host exact oracle")
            ties = int(sum(len(set(s[i, order[i]].tolist())) < k for i in range(len(xq))))
            print(f"exact {metric} at {SET_N:,} x 128 (fused-xla): {len(xq)} queries, ids and "
                  f"scores equal a host exact oracle's, ties to the lowest slot ({ties} rows "
                  f"with tied scores in their top 10)", flush=True)
            db.delete_collection(f"set_{metric}")
        db.close()
        cm.rrf_fuse_topk = rrf
        torch.cuda.empty_cache()

        # -- 13. the serving surfaces on this phase's directory ----------------
        phase("13. serve")
        t_phase += serve_phase(torch, counters, launches, errs, tmp, qv, qt, serve_oi)
    finally:
        cm.rrf_fuse_topk = rrf
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"phase 11 hybrid: {time.perf_counter() - t_phase:.1f} s")


def kg_edges(n, d):
    """``kg-amazon0302-262k``'s edges over ``hybrid_data``'s rows: out-degrees
    Poisson(KG_MEAN_DEGREE), made to sum to exactly KG_EDGES; each
    destination in the source's cluster with probability 0.8, else uniform.
    Returns ``(src, dst)``, sorted by source."""
    rng0 = np.random.default_rng(42)
    rng0.standard_normal((64, d))  # hybrid_data's draws up to its assignment
    assign = rng0.integers(0, 64, n)
    rng = np.random.default_rng(302)
    deg = rng.poisson(KG_MEAN_DEGREE, n)
    diff = KG_EDGES - int(deg.sum())
    if diff > 0:
        np.add.at(deg, rng.integers(0, n, diff), 1)
    elif diff < 0:
        np.subtract.at(deg, rng.choice(np.repeat(np.arange(n), deg), -diff, replace=False), 1)
    src = np.repeat(np.arange(n), deg)
    members = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    c = assign[src]
    local = members[starts[c] + (rng.random(src.size) * counts[c]).astype(np.int64)]
    dst = np.where(rng.random(src.size) < 0.8, local, rng.integers(0, n, src.size))
    return src, dst, np.concatenate([[0], np.cumsum(deg)])


def host_bfs(indptr, nbr, start, depth):
    """``{(node, depth)}`` of a breadth-first search over CSR arrays."""
    seen = {int(start): 0}
    frontier = np.array([start], np.int64)
    for level in range(1, depth + 1):
        if frontier.size == 0:
            break
        nxt = np.unique(np.concatenate([nbr[indptr[f]:indptr[f + 1]] for f in frontier]))
        fresh = np.array([x for x in nxt.tolist() if x not in seen], np.int64)
        for x in fresh.tolist():
            seen[x] = level
        frontier = fresh
    return set(seen.items())


def p50_p99(fn, calls):
    """Host-clock milliseconds of ``fn(i)`` for ``i`` in ``calls`` (each
    call reads its result back): ``(p50, p99)``."""
    ms = []
    for i in calls:
        t0 = time.perf_counter()
        fn(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def velesql_kg_phase(torch, dev, counters, launches, errs, db, col, qv, qt, colsq, qsq) -> float:
    """Phase 12, VelesQL and the knowledge graph, on phase 11's collections:
    ``velesql-1m-128d`` (``hybrid-1m-128d``) and ``kg-amazon0302-262k``
    (``hybrid-sq8-262k``'s rows as nodes). Deletes the SQ8 collection at
    its end; returns the phase's seconds."""
    from velesdb_tpu_torch import Database
    from velesdb_tpu_torch.graph import EdgeStore
    from velesdb_tpu_torch.ops import bucket_kernel as bk
    from velesdb_tpu_torch.velesql import parse

    t_phase = time.perf_counter()
    k = K
    big, sq8 = f'"{col.name}"', f'"{colsq.name}"'
    sql = {
        "a": f"SELECT * FROM {big} WHERE vector NEAR $v LIMIT 10",
        "b": f"SELECT * FROM {big} WHERE vector NEAR $v AND price < 50 LIMIT 10",
        "c": f"SELECT * FROM {big} WHERE vector NEAR $v AND price < 50 AND text MATCH $t LIMIT 10",
        "d": f"SELECT * FROM {big} WHERE vector NEAR_FUSED [$v, $w] USING FUSION rrf(k = 60) "
             f"LIMIT 10",
        "e": f"SELECT * FROM {big} WHERE text MATCH $t LIMIT 10",
        "f": f"SELECT text, COUNT(*) AS n, AVG(price) AS p FROM {big} WHERE price < 2 "
             f"GROUP BY text ORDER BY n DESC",
    }
    params = lambda i: {"v": qv[i], "w": qv[i + 1], "t": qt[i]}  # noqa: E731

    def same(rows, hits, scale=1.0, tol=1e-6):
        return ([r["id"] for r in rows] == [h.id for h in hits]
                and all(abs(r["score"] - scale * h.score) <= tol for r, h in zip(rows, hits)))

    # the direct Collection call each of (a) to (e) must equal
    direct = {
        "a": lambda i: col.search(qv[i], k=k),
        "b": lambda i: col.search_batch([qv[i]], k, filter=HYB_FILTER)[0],
        # the executor fuses a 64-deep fetch with both RRF weights 1:
        # hybrid_search at k 32 fetches 64 and weighs 0.5, half the score
        "c": lambda i: col.hybrid_search(qv[i], qt[i], k=32, vector_weight=0.5,
                                         filter=HYB_FILTER)[:k],
        # NEAR_FUSED fetches 10 a vector and fuses to 10; multi_query_search
        # at k 5 fetches the same 10 and keeps the first 5 of one fusion
        "d": lambda i: col.multi_query_search([qv[i], qv[i + 1]], k=5),
        "e": lambda i: col.text_search(qt[i], k=k),
    }
    scale = {"c": 2.0}

    # -- velesql-1m-128d: each of (a) to (c) on #1, every launch held ----------
    name = "velesql-1m-128d"
    check(col._brute.serve_engine(k) == "int8-assist-pd", f"{name}: serve_engine")
    got = {}
    with MainPath(counters, bk, "sq8pd_bucket_gm", "sq8pd_bucket_gm") as run:
        for q in "abcdef":
            got[q] = [db.query(sql[q], params(i)) for i in range(4)]
            if q in "abc":
                run.launched(f"{name} ({q}) through Database.query")
    launches["sq8pd_bucket"] += run.launches()
    errs["sq8pd_bucket"] = max(errs["sq8pd_bucket"], run.hold_all(
        lambda qi, rows, pt, ch: bk.sq8pd_bucket_gm_ref(qi, rows, pt, ch),
        lambda qi, rows, pt, ch: (f"sq8pd_bucket B_pad {qi.shape[0]}, N {rows.shape[0]}, "
                                  f"D_pad {rows.shape[1]}, chunk {ch} ({name})")))
    print(f"{name}: {run.launches()} #1 launches over (a)-(f), 4 queries each, every one "
          f"equal to its plain version", flush=True)
    for q in "abcde":
        for i, rows in enumerate(got[q]):
            check(len(rows) == k, f"{name} ({q}): {len(rows)} rows")
            want = direct[q](i)
            rows = rows[: len(want)]
            check(same(rows, want, scale.get(q, 1.0)),
                  f"{name} ({q}) query {i}: rows differ from the direct Collection call")
            check(q not in "bc" or all(r["payload"]["price"] < 50 for r in rows),
                  f"{name} ({q}): the filter let a row through")
    print(f"{name}: (a)-(e) through Database.query equal search, search_batch with the "
          f"filter, hybrid_search, multi_query_search and text_search (ids; scores within "
          f"1e-6)", flush=True)
    groups = {}
    for vid in range(col.count()):
        p = col.payloads.retrieve(vid)
        if p["price"] < 2:
            groups.setdefault(p["text"], []).append(p["price"])
    want = sorted(({"text": t, "n": len(v), "p": sum(v) / len(v)} for t, v in groups.items()),
                  key=lambda r: -r["n"])
    check(all(r == got["f"][0][j] for j, r in enumerate(want)) and len(want) == len(got["f"][0]),
          f"{name} (f): GROUP BY differs from the host count over the payloads")
    print(f"{name} (f): {len(want)} groups over {sum(r['n'] for r in want)} rows equal the "
          f"host count over the payloads", flush=True)
    plan = db.explain_query(sql["c"]).render()
    check("VectorSearch" in plan and "engine=" in plan and "TextSearch" in plan,
          f"{name}: EXPLAIN names no vector engine:\n{plan}")
    print(f"{name} EXPLAIN (c):\n{plan}", flush=True)

    # -- the SQ8 collection: NEAR on #7, then the host rerank -------------------
    sq8_sql = {"a": f"SELECT * FROM {sq8} WHERE vector NEAR $v LIMIT 10",
               "b": f"SELECT * FROM {sq8} WHERE vector NEAR $v AND price < 50 LIMIT 10"}
    with MainPath(counters, bk, "sq8i_bucket_gm", "sq8i_bucket_gm") as run:
        sq_rows = {}
        for q in "ab":
            sq_rows[q] = [db.query(sq8_sql[q], {"v": qsq[i]}) for i in range(4)]
            run.launched(f"{colsq.name} ({q}) through Database.query")
    n_sq8 = run.launches()
    launches["sq8i_bucket"] += n_sq8
    errs["sq8i_bucket"] = max(errs["sq8i_bucket"], run.hold_all(
        bk.sq8i_bucket_ref,
        lambda qi, rows, *rest: (f"sq8i_bucket B_pad {qi.shape[0]}, N {rows.shape[0]}, "
                                 f"D_pad {rows.shape[1]}, chunk {rest[-1]} ({colsq.name})")))
    for i in range(4):
        check(same(sq_rows["a"][i], colsq.search(qsq[i], k=k)),
              f"{colsq.name} (a): rows differ from search")
        check(same(sq_rows["b"][i], colsq.search_batch([qsq[i]], k, filter=HYB_FILTER)[0]),
              f"{colsq.name} (b): rows differ from search_batch with the filter")
    print(f"{colsq.name}: (a) and (b) through Database.query launch #7 ({n_sq8} "
          f"launches, each equal to its plain version) and equal search after the rerank",
          flush=True)

    # -- host-clock times, before any profile of this phase --------------------
    calls = range(VQL_CALLS)
    for q in "abcdef":
        p50, p99 = p50_p99(lambda i: db.query(sql[q], params(i)), calls)
        line = f"{name} ({q}) Database.query: p50 {p50:.3f} ms, p99 {p99:.3f} ms"
        if q in direct:
            d50, _ = p50_p99(direct[q], calls)
            line += (f"; the direct Collection call p50 {d50:.3f} ms (parser and executor "
                     f"{p50 - d50:.3f} ms)")
        say(line + f" over {VQL_CALLS} calls, one query a call")
    for q in "ab":
        p50, p99 = p50_p99(lambda i: db.query(sq8_sql[q], {"v": qsq[i]}), calls)
        d50, _ = p50_p99(lambda i: colsq.search(qsq[i], k=k) if q == "a" else
                         colsq.search_batch([qsq[i]], k, filter=HYB_FILTER), calls)
        say(f"{colsq.name} ({q}) Database.query: p50 {p50:.3f} ms, p99 {p99:.3f} ms; direct "
            f"p50 {d50:.3f} ms over {VQL_CALLS} calls")
    n_parse = 2000
    t0 = time.perf_counter()
    for _ in range(n_parse):
        parse(sql["c"])
    miss = (time.perf_counter() - t0) / n_parse * 1e3
    t0 = time.perf_counter()
    for _ in range(n_parse):
        db.query_cache.parse(sql["c"])
    hit = (time.perf_counter() - t0) / n_parse * 1e3
    say(f"VelesQL parse of (c): cache miss (the parser) {miss:.4f} ms, cache hit {hit:.4f} ms "
        f"(mean of {n_parse})")

    # -- kg-amazon0302-262k -----------------------------------------------------
    name = "kg-amazon0302-262k"
    n = colsq.count()
    t0 = time.perf_counter()
    graph = colsq.ensure_graph()
    say(f"{name}: ensure_graph over {n:,} payloads {time.perf_counter() - t0:.2f} s")
    src, dst, indptr = kg_edges(n, HYB_D)
    t0 = time.perf_counter()
    for s, t in zip(src.tolist(), dst.tolist()):
        colsq.add_edge(s, t, "also_bought")
    say(f"{name}: add_edge x {src.size:,} (SNAP amazon0302's edge count, mean out-degree "
        f"{src.size / n:.4f}) {time.perf_counter() - t0:.2f} s")
    check(len(graph.edges) == KG_EDGES, f"{name}: {len(graph.edges)} edges")
    rng = np.random.default_rng(12)
    starts = rng.integers(0, n, 32)
    for s in starts[:16].tolist():
        got_t = {(node, depth) for node, depth, _ in colsq.traverse(s, max_depth=3)}
        check(got_t == host_bfs(indptr, dst, s, 3),
              f"{name}: traverse from {s} differs from the host BFS")
    print(f"{name}: traverse to depth 3 from 16 starts = a host numpy BFS over the same "
          f"edge arrays", flush=True)
    texts = {vid: p["text"] for vid, p in colsq.payloads.payloads.items()}
    vecs = colsq.vectors
    match = ("MATCH (a {text: $t})-[:also_bought*1..2]->(b) WHERE similarity(b, $v) > 0.5 "
             "RETURN b.id AS id, similarity(b, $v) AS s ORDER BY s DESC LIMIT 10")

    def match_oracle(s0):
        t = texts[s0]
        paths = {}
        for a in (vid for vid, tx in texts.items() if tx == t):
            for x in dst[indptr[a]:indptr[a + 1]].tolist():
                paths[x] = paths.get(x, 0) + 1
                for y in dst[indptr[x]:indptr[x + 1]].tolist():
                    paths[y] = paths.get(y, 0) + 1
        ids = sorted(paths)
        v64 = vecs.retrieve(s0).astype(np.float64)
        m64 = np.stack([vecs.retrieve(b) for b in ids]).astype(np.float64)
        s64 = m64 @ v64 / (np.linalg.norm(m64, axis=1) * np.linalg.norm(v64))
        rows = sorted(((b, s) for b, s in zip(ids, s64.tolist()) if s > 0.5),
                      key=lambda r: -r[1])
        return [r for r in rows for _ in range(paths[r[0]])][:k], dict(zip(ids, s64.tolist()))

    s0 = int(starts[0])
    mp = {"t": texts[s0], "v": vecs.retrieve(s0)}
    rows = colsq.execute_match(match, mp)
    want, s64 = match_oracle(s0)
    check(len(rows) == len(want) == k, f"{name}: MATCH {len(rows)} rows, oracle {len(want)}")
    check(all(abs(r["s"] - s64[r["id"]]) <= 1e-5 and s64[r["id"]] > 0.5 - 1e-5
              and (r["id"] == w[0] or abs(r["s"] - w[1]) <= 1e-5)
              for r, w in zip(rows, want)),
          f"{name}: MATCH rows differ from the float64 host oracle:\n{rows}\n{want}")
    check(db.match_query(colsq.name, match, mp) == rows,
          f"{name}: Database.match_query differs from execute_match")
    print(f"{name}: MATCH 1..2 hops from {sum(t == mp['t'] for t in texts.values())} starts "
          f"with similarity > 0.5 = the float64 host oracle over the reachable set; "
          f"Database.match_query = execute_match", flush=True)
    p50, p99 = p50_p99(lambda i: colsq.traverse(int(starts[i]), max_depth=3), range(32))
    say(f"{name}: traverse depth 3 p50 {p50:.3f} ms, p99 {p99:.3f} ms over 32 starts")
    p50, p99 = p50_p99(lambda i: colsq.execute_match(match, {"t": texts[int(starts[i])],
                                                             "v": vecs.retrieve(int(starts[i]))}),
                       range(VQL_CALLS))
    say(f"{name}: MATCH p50 {p50:.3f} ms, p99 {p99:.3f} ms over {VQL_CALLS} calls")

    # -- flush, close, reopen: the same rows from edges.npz --------------------
    scratch = os.path.join(db.path, "edges_timing.npz")
    t0 = time.perf_counter()
    graph.edges.save(scratch)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    EdgeStore.load(scratch)
    t_load = time.perf_counter() - t0
    say(f"{name}: edges.npz save {t_save:.2f} s ({os.path.getsize(scratch) / 2**20:.1f} MiB), "
        f"load {t_load:.2f} s")
    os.remove(scratch)
    reach = {s: colsq.traverse(s, max_depth=3) for s in starts[:4].tolist()}
    sq_name = colsq.name
    t0 = time.perf_counter()
    colsq.flush()
    colsq.close()
    db._collections.pop(sq_name)  # closed: the reopened copy below owns the files
    db2 = Database(db.path, device=DEVICE)
    col2 = db2.get_collection(sq_name)
    col2.ensure_graph()
    say(f"{name}: flush + close + reopen + ensure_graph {time.perf_counter() - t0:.2f} s")
    check(col2.execute_match(match, mp) == rows, f"{name}: MATCH after reopen differs")
    check(all(col2.traverse(s, max_depth=3) == r for s, r in reach.items()),
          f"{name}: traverse after reopen differs")
    print(f"{name}: after flush, close and reopen, edges.npz gives the same MATCH rows and "
          f"traversals", flush=True)

    # -- delete 100 nodes with edges -------------------------------------------
    gone = rng.choice(n, 100, replace=False)
    touch = np.isin(src, gone) | np.isin(dst, gone)
    walk = [0.0]
    remove = col2.graph.edges.remove_node_edges

    def timed_remove(node, _remove=remove):
        t = time.perf_counter()
        out = _remove(node)
        walk[0] += time.perf_counter() - t
        return out

    col2.graph.edges.remove_node_edges = timed_remove
    t0 = time.perf_counter()
    for vid in gone.tolist():
        col2.delete(vid)
    t_del = time.perf_counter() - t0
    del col2.graph.edges.remove_node_edges
    check(len(col2.graph.edges) == KG_EDGES - int(touch.sum())
          and all(col2.degree(int(v), "out") + col2.degree(int(v), "in") == 0 for v in gone),
          f"{name}: deleting 100 nodes left {len(col2.graph.edges)} edges")
    say(f"{name}: delete of 100 nodes ({int(touch.sum())} edges) {t_del * 1e3:.1f} ms, "
        f"remove_node_edges {walk[0] * 1e3:.1f} ms of it")
    db2.delete_collection(sq_name)

    # -- profiles last: busy and idle share of (a) and (c) ---------------------
    for q in "ac":
        p50, _ = p50_p99(lambda i: db.query(sql[q], params(i)), range(8, 8 + VQL_CALLS))
        busy, top = device_profile(torch, lambda i: db.query(sql[q], params(i)),
                                   list(range(40, 48)), top=4)
        if busy <= 0.0:
            print(f"velesql-1m-128d ({q}): device busy not measured (no device events)",
                  flush=True)
            continue
        say(f"velesql-1m-128d ({q}) Database.query: device busy {busy:.4f} ms/call, idle share "
            f"{1.0 - busy / p50:.3f} against its p50 {p50:.3f} ms (torch.profiler over 8 calls)")
        for op, t in top:
            say(f"    {t:.4f} ms/call  {op[:100]}")
    seconds = time.perf_counter() - t_phase
    say(f"phase 12 velesql-kg: {seconds:.1f} s")
    return seconds


# phase 13's load client, written beside the data and run in a child process:
# the standard library only, one persistent connection a thread, every
# connection opened and warmed before the timed window
SEARCH_CLIENT = r'''
import http.client, json, sys, threading, time

host, port, path, qfile, n_threads, per, k, out = sys.argv[1:9]
port, n_threads, per, k = int(port), int(n_threads), int(per), int(k)
with open(qfile) as f:
    bodies = [json.dumps({"vector": q, "k": k}).encode() for q in json.load(f)]
results, errors = [None] * (n_threads * per), []
go = threading.Barrier(n_threads + 1)


def worker(t, conn):
    go.wait(timeout=300)
    try:
        for j in range(per):
            i = t * per + j
            t0 = time.perf_counter()
            conn.request("POST", path, body=bodies[i],
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            results[i] = (resp.status, time.perf_counter() - t0, data.decode())
    except Exception as e:
        errors.append(f"thread {t}: {e!r}")
    finally:
        conn.close()


# connect and warm one connection at a time: the server's listen backlog is 5,
# and connects faster than its accept loop would wait on dropped SYNs (a
# 1 s retransmit each); a round trip per connection proves it accepted
t_warm = time.perf_counter()
conns = []
for t in range(n_threads):
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("GET", "/health")
    resp = conn.getresponse()
    resp.read()
    if resp.status != 200:
        errors.append(f"connection {t} warm-up answered {resp.status}")
    conns.append(conn)
t_warm = time.perf_counter() - t_warm
threads = [threading.Thread(target=worker, args=(t, conns[t])) for t in range(n_threads)]
for t in threads:
    t.start()
go.wait(timeout=300)
t0 = time.perf_counter()
for t in threads:
    t.join(timeout=300)
wall = time.perf_counter() - t0
with open(out, "w") as f:
    json.dump({"warm_s": t_warm, "wall_s": wall, "errors": errors,
               "alive": sum(t.is_alive() for t in threads), "results": results}, f)
'''


def tie_agree(got, want, tol=1e-6):
    """``got`` against ``want``, two ranked ``[(id, score)]`` lists: None if
    they disagree, 0 if the ids are equal (scores within ``tol``), 1 for a
    near-tie swap: the scores agree position by position and ids differ only
    inside runs of scores within ``tol`` of each other (the last run may
    reach past k)."""
    if len(got) != len(want) or any(abs(g[1] - w[1]) > tol for g, w in zip(got, want)):
        return None
    if [g[0] for g in got] == [w[0] for w in want]:
        return 0
    start = 0
    for end in range(1, len(want) + 1):
        if end == len(want) or abs(want[end][1] - want[end - 1][1]) > tol:
            if end != len(want) and ({g[0] for g in got[start:end]}
                                     != {w[0] for w in want[start:end]}):
                return None
            start = end
    return 1


def pairs(rows):
    """``[(id, score)]`` of hits, hydrated or decoded from JSON."""
    return [(int(h["id"]), float(h["score"])) for h in rows]


def serve_phase(torch, counters, launches, errs, tmp, qv, qt, o_ids) -> float:
    """Phase 13, ``serve-1m-128d``: phase 11's hybrid-1m-128d directory
    (1,000,000 x 128 cosine FULL, after its TTL rows and ``vacuum``) reopened
    through ``make_server`` on the default device, driven over HTTP; then the
    CLI and the server as child processes on a 10,000-row directory.
    ``o_ids`` are the float64 oracle's top-10 ids of the 1,024 held-out
    queries ``qv[SERVE_Q0:]``. Host-clock numbers come before the phase's one
    profile; returns the phase's seconds."""
    import http.client
    import socket
    import threading

    from velesdb_tpu_torch import Database
    from velesdb_tpu_torch.ops import bucket_kernel as bk
    from velesdb_tpu_torch.server.app import _json_default, make_server

    t_phase = time.perf_counter()
    name, cname, k = "serve-1m-128d", "hybrid-1m-128d", K
    n_req = SERVE_THREADS * SERVE_PER_THREAD
    Q, T = qv[SERVE_Q0 : SERVE_Q0 + n_req], qt[SERVE_Q0 : SERVE_Q0 + n_req]
    here = os.path.dirname(os.path.abspath(__file__))
    table = f'"{cname}"'
    sql = {"a": f"SELECT * FROM {table} WHERE vector NEAR $v LIMIT 10",
           "b": f"SELECT * FROM {table} WHERE vector NEAR $v AND price < 50 LIMIT 10"}
    route = f"/collections/{cname}"
    n_swaps = {}

    def held(run, what):
        """Every recorded #1 launch against its plain version, bit for bit
        (one summary line, not a line a launch)."""
        def quiet(label, qi, rows, pt, ch, out):
            ref = bk.sq8pd_bucket_gm_ref(qi, rows, pt, ch)
            check(out.shape == ref.shape and out.dtype == ref.dtype and torch.equal(out, ref),
                  f"{label}: kernel != plain version (max |err| {max_err(out, ref)})")
            return 0.0

        n = run.launches()
        launches["sq8pd_bucket"] += n
        errs["sq8pd_bucket"] = max(errs["sq8pd_bucket"], run.hold_all(
            None, lambda qi, rows, pt, ch: (f"sq8pd_bucket B_pad {qi.shape[0]}, "
                                            f"N {rows.shape[0]} ({name} {what})"), quiet))
        print(f"{name} {what}: {n} #1 launches, each equal to its plain version bit for bit",
              flush=True)

    def agree(got, want, what):
        """Each returned row against its direct call's (ids; scores within
        1e-6); near-tie swaps are counted under ``what`` and printed."""
        check(len(got) == len(want), f"{name} {what}: {len(got)} rows, {len(want)} expected")
        for i, (g, w) in enumerate(zip(got, want)):
            r = tie_agree(pairs(g), pairs(w))
            check(r is not None, f"{name} {what} row {i}: {pairs(g)} != {pairs(w)}")
            n_swaps[what] = n_swaps.get(what, 0) + r

    def request(conn, method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        raw = resp.read()
        out = (json.loads(raw) if "json" in (resp.getheader("Content-Type") or "")
               else raw.decode())
        return resp.status, out

    def ok(got, what):
        status, body = got
        check(status == 200, f"{name} {what}: HTTP {status}: {str(body)[:300]}")
        return body

    old_window = os.environ.get("VELESDB_BATCH_WINDOW_MS")
    os.environ["VELESDB_BATCH_WINDOW_MS"] = SERVE_WINDOW_MS
    t0 = time.perf_counter()
    httpd = make_server(tmp, host="127.0.0.1", port=0)
    t_reopen = time.perf_counter() - t0
    if old_window is None:
        del os.environ["VELESDB_BATCH_WINDOW_MS"]
    else:
        os.environ["VELESDB_BATCH_WINDOW_MS"] = old_window
    app = httpd.app
    host, port = httpd.server_address[:2]
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    opened = []
    try:
        col = app.db.get_collection(cname)
        info = col.info()
        check(info["device"].startswith("cuda") and info["count"] == HYB_N,
              f"{name}: reopened collection {info}")
        check(app.batch_window_ms == float(SERVE_WINDOW_MS), f"{name}: window {app.batch_window_ms}")
        say(f"{name}: make_server reopened {cname} ({info['count']:,} rows, device "
            f"{info['device']}; the payload log's replay and the vector store) in "
            f"{t_reopen:.2f} s; batch window {app.batch_window_ms} ms, listen backlog "
            f"{httpd.request_queue_size}")

        # -- a mixed burst at the freshly reopened collection ----------------
        # every lazy build is still ahead: the device refresh (rows and the pd
        # shadow), the BM25 index and its blocks, the column store
        fq = {"type": "lt", "field": "price", "value": 50.0}
        jobs = ([("search", i, "POST", f"{route}/search", {"vector": Q[i].tolist(), "k": k})
                 for i in range(8)]
                + [("batch", j, "POST", f"{route}/search/batch",
                    {"vectors": Q[16 * j : 16 * j + 16].tolist(), "k": k}) for j in range(2)]
                + [(f"query {q}", i, "POST", "/query",
                    {"query": sql[q], "params": {"v": Q[i].tolist()}})
                   for q in "ab" for i in range(4)]
                + [("hybrid", i, "POST", f"{route}/search/hybrid",
                    {"vector": Q[i].tolist(), "query": T[i], "k": k}) for i in range(4)]
                + [("text", i, "POST", f"{route}/search/text", {"query": T[i], "k": k})
                   for i in range(2)]
                + [("filtered", i, "POST", f"{route}/search",
                    {"vector": Q[i].tolist(), "k": k, "filter": fq}) for i in range(2)])
        burst, seconds = {}, {}
        gate = threading.Barrier(len(jobs))

        def fire(job, conn):
            kind, i, method, path, body = job
            try:
                gate.wait(timeout=HTTP_TIMEOUT)
                t = time.perf_counter()
                burst[kind, i] = request(conn, method, path, body)
                seconds[kind, i] = time.perf_counter() - t
            except Exception as e:  # reported by the check below
                burst[kind, i] = (0, repr(e))
            finally:
                conn.close()

        # connected and warmed one at a time (the listen backlog is 5), then
        # fired at once
        conns = []
        for _ in jobs:
            conns.append(http.client.HTTPConnection(host, port, timeout=HTTP_TIMEOUT))
            ok(request(conns[-1], "GET", "/health"), "warm-up")
        with MainPath(counters, bk, "sq8pd_bucket_gm", "sq8pd_bucket_gm") as run:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=fire, args=(job, c)) for job, c in zip(jobs, conns)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            t_burst = time.perf_counter() - t0
            check(not any(t.is_alive() for t in threads), f"{name}: the burst did not finish")
            run.launched(f"{name} burst")
        held(run, "mixed burst at the reopened collection")
        rows = {key: ok(got, f"burst {key}") for key, got in burst.items()}
        say(f"{name}: a burst of {len(jobs)} mixed requests (/search through the batcher, "
            f"/search/batch, /query NEAR with and without the filter, /search/hybrid, "
            f"/search/text, filtered /search) at the reopened collection: {t_burst:.2f} s; "
            f"the first /search/hybrid answered in "
            f"{min(seconds['hybrid', i] for i in range(4)):.2f} s (the BM25 build inside), "
            f"the first /search in {min(seconds['search', i] for i in range(8)):.2f} s (the "
            f"device refresh inside)")
        direct = {
            "search": lambda i: col.search_batch(Q[:8], k)[i],
            "batch": lambda j: col.search_batch(Q[16 * j : 16 * j + 16], k),
            "query a": lambda i: app.db.query(sql["a"], {"v": Q[i]}),
            "query b": lambda i: app.db.query(sql["b"], {"v": Q[i]}),
            "hybrid": lambda i: col.hybrid_search(Q[i], T[i], k=k),
            "text": lambda i: col.text_search(T[i], k=k),
            "filtered": lambda i: col.search_batch([Q[i]], k, filter=fq)[0],
        }
        for (kind, i), body in sorted(rows.items()):
            got = body["rows"] if kind.startswith("query") else body["results"]
            want = direct[kind](i)
            if kind == "batch":
                agree(got, want, f"burst {kind}")
            else:
                agree([got], [want], f"burst {kind}")
            if kind in ("query b", "filtered"):
                check(all(h["payload"]["price"] < 50 for h in got),
                      f"{name} burst {kind}: the filter let a row through")
        print(f"{name}: every burst answer equals its direct call on httpd.app.db (ids; "
              f"scores within 1e-6; near-tie swaps {sum(n_swaps.values())})", flush=True)
        t0 = time.perf_counter()
        col._device_dirty = True
        col.refresh_device()
        torch.cuda.synchronize()
        say(f"{name}: the device refresh alone (rows and the pd shadow, rebuilt again to "
            f"time it) {time.perf_counter() - t0:.2f} s; serve_engine "
            f"{col._brute.serve_engine(k)!r}")
        check(col._brute.serve_engine(k) == "int8-assist-pd", f"{name}: serve engine")

        # -- 1,024 single-query /search requests from 256 client threads -------
        qfile = os.path.join(tmp, "serve_queries.json")
        with open(qfile, "w") as f:
            json.dump(Q.tolist(), f)
        client = os.path.join(tmp, "serve_client.py")
        with open(client, "w") as f:
            f.write(SEARCH_CLIENT)
        want = [row for s in range(0, n_req, 256) for row in col.search_batch(Q[s : s + 256], k)]

        def coalesced(window):
            app.batch_window_ms = window
            out = os.path.join(tmp, f"serve_client_{window}.json")
            bt = app._batchers.get(cname)
            before = (bt.batches, bt.coalesced) if bt is not None else (0, 0)
            with MainPath(counters, bk, "sq8pd_bucket_gm", "sq8pd_bucket_gm") as run:
                proc = subprocess.run(
                    [sys.executable, client, host, str(port), f"{route}/search", qfile,
                     str(SERVE_THREADS), str(SERVE_PER_THREAD), str(k), out],
                    capture_output=True, text=True, timeout=600)
                run.launched(f"{name} /search at window {window} ms")
            check(proc.returncode == 0,
                  f"{name} client (window {window}): rc {proc.returncode} {proc.stderr[-2000:]}")
            with open(out) as f:
                rep = json.load(f)
            check(not rep["errors"] and not rep["alive"],
                  f"{name} client (window {window}): {rep['errors'][:5]}")
            statuses = [r[0] for r in rep["results"]]
            check(all(s == 200 for s in statuses),
                  f"{name} window {window}: statuses {sorted(set(statuses))}: "
                  f"{[r[2][:200] for r in rep['results'] if r[0] != 200][:3]}")
            got = [json.loads(r[2])["results"] for r in rep["results"]]
            agree(got, want, f"/search window {window}")
            ids = np.array([[h["id"] for h in row] for row in got])
            recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, o_ids)]))
            check(recall >= 0.95, f"{name} window {window}: recall@10 {recall:.4f} < 0.95")
            bt = app._batchers.get(cname)
            after = (bt.batches, bt.coalesced) if bt is not None else (0, 0)
            lat = np.array([r[1] for r in rep["results"]]) * 1e3
            held(run, f"/search at window {window} ms")
            return rep, lat, recall, after[0] - before[0], after[1] - before[1]

        rep2, lat2, rec2, batches2, coal2 = coalesced(float(SERVE_WINDOW_MS))
        check(0 < batches2 < n_req, f"{name}: {batches2} batcher dispatches for {n_req} requests")
        rep0, lat0, rec0, batches0, _ = coalesced(0.0)
        check(batches0 == 0, f"{name}: the batcher served {batches0} dispatches at window 0")
        app.batch_window_ms = float(SERVE_WINDOW_MS)
        print(f"{name}: {n_req} /search answers at window 2 ms and at 0 equal the direct "
              f"search_batch on httpd.app.db (ids; scores within 1e-6; near-tie swaps "
              f"{n_swaps.get('/search window 2.0', 0)} and {n_swaps.get('/search window 0.0', 0)}"
              f"); recall@10 vs the float64 oracle {rec2:.4f} / {rec0:.4f}", flush=True)

        # -- the other routes against their direct calls -----------------------
        conn = http.client.HTTPConnection(host, port, timeout=HTTP_TIMEOUT)
        opened.append(conn)
        with MainPath(counters, bk, "sq8pd_bucket_gm", "sq8pd_bucket_gm") as run:
            for b, s in ((256, 0), (16, 256)):
                got = ok(request(conn, "POST", f"{route}/search/batch",
                                 {"vectors": Q[s : s + b].tolist(), "k": k}), f"batch {b}")
                agree(got["results"], col.search_batch(Q[s : s + b], k), f"/search/batch b {b}")
                run.launched(f"{name} /search/batch b={b}")
            for q in "ab":
                for i in range(4):
                    got = ok(request(conn, "POST", "/query",
                                     {"query": sql[q], "params": {"v": Q[i].tolist()}}),
                             f"query {q}")
                    agree([got["rows"]], [app.db.query(sql[q], {"v": Q[i]})], f"/query {q}")
                run.launched(f"{name} /query ({q})")
            for i in range(4):
                got = ok(request(conn, "POST", f"{route}/search/hybrid",
                                 {"vector": Q[i].tolist(), "query": T[i], "k": k}), "hybrid")
                agree([got["results"]], [col.hybrid_search(Q[i], T[i], k=k)], "/search/hybrid")
            run.launched(f"{name} /search/hybrid")
        held(run, "/search/batch, /query, /search/hybrid")
        ginfo = ok(request(conn, "GET", route), "info")
        check(ginfo["device"].startswith("cuda") and ginfo["count"] == HYB_N
              and ginfo["serve_engine"] == "int8-assist-pd", f"{name}: info {ginfo}")
        got = ok(request(conn, "GET", f"{route}/index"), "index")
        check(got["index_kind"] == "auto" and got["graph_built"] is False, f"{name}: {got}")
        prom = ok(request(conn, "GET", "/metrics"), "metrics")
        check("velesdb_http_requests_total" in prom and "velesdb_microbatch_batches" in prom
              and "velesdb_microbatch_coalesced" in prom, f"{name}: /metrics lacks a gauge")
        ok(request(conn, "GET", "/health"), "health")
        print(f"{name}: /search/batch (b 256, 16), /query (NEAR, NEAR + price < 50), "
              f"/search/hybrid equal search_batch, Database.query and hybrid_search; "
              f"{route} reports {ginfo['device']}; /metrics holds "
              f"http_requests_total and the microbatch gauges", flush=True)

        # -- the entry points as child processes, on a small directory ---------
        t0 = time.perf_counter()
        small, small2 = os.path.join(tmp, "cli_db"), os.path.join(tmp, "cli_db2")
        jsonl = os.path.join(tmp, "cli.jsonl")
        xs = np.random.default_rng(13).standard_normal((CLI_ROWS, HYB_D)).astype(np.float32)
        with open(jsonl, "w") as f:
            for i in range(CLI_ROWS):
                f.write(json.dumps({"id": i, "vector": xs[i].tolist(), "payload": {"n": i}})
                        + "\n")

        def cli(path, *argv):
            return [sys.executable, "-m", "velesdb_tpu_torch.cli", "--path", path, *argv]

        def run_cli(argv):
            proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0, f"{name}: {' '.join(argv[2:5])}: rc "
                                        f"{proc.returncode} {proc.stderr[-2000:]}")
            return proc.stdout

        made = json.loads(run_cli(cli(small, "create", "c", "--dim", str(HYB_D))))
        check(made["device"].startswith("cuda"), f"{name}: the CLI's create on {made['device']}")
        check(f"imported {CLI_ROWS} points" in run_cli(cli(small, "import", "c", jsonl)),
              f"{name}: the CLI's import")
        mig = subprocess.Popen(cli(small2, "migrate", "--source", "jsonl", "--location", jsonl,
                                   "--collection", "m", "--dim", str(HYB_D)),
                               cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        opened.append(mig)
        rows_cli = json.loads(run_cli(cli(small, "query", "SELECT * FROM c WHERE vector NEAR "
                                          "$v LIMIT 10", "--params",
                                          json.dumps({"v": xs[17].tolist()}), "--json")))
        m_out, m_err = mig.communicate(timeout=300)
        check(mig.returncode == 0, f"{name}: the CLI's migrate: rc {mig.returncode} {m_err[-2000:]}")
        report = json.loads(m_out.strip().splitlines()[-1])
        check(report["migrated"] == CLI_ROWS and report["failed"] == 0,
              f"{name}: the CLI's migrate: {report}")
        db_small = Database.open(small)
        mine = db_small.get_collection("c").search(xs[17], k=k)
        db_small.close()
        check(tie_agree(pairs(rows_cli), pairs(mine)) is not None and rows_cli[0]["id"] == 17,
              f"{name}: the CLI's NEAR query differs from the in-process search")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free = s.getsockname()[1]
        srv = subprocess.Popen([sys.executable, "-m", "velesdb_tpu_torch.server", small,
                                "--host", "127.0.0.1", "--port", str(free)],
                               cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        opened.append(srv)
        deadline = time.time() + 180
        up = None
        while up is None and time.time() < deadline and srv.poll() is None:
            try:
                c2 = http.client.HTTPConnection("127.0.0.1", free, timeout=5)
                up = request(c2, "GET", "/health")
                c2.close()
            except OSError:
                time.sleep(0.2)
        check(up is not None and up[0] == 200,
              f"{name}: python -m velesdb_tpu_torch.server did not answer /health "
              f"(rc {srv.poll()})")
        c2 = http.client.HTTPConnection("127.0.0.1", free, timeout=HTTP_TIMEOUT)
        sinfo = ok(request(c2, "GET", "/collections/c"), "child server info")
        sres = ok(request(c2, "POST", "/collections/c/search",
                          {"vector": xs[17].tolist(), "k": k}), "child server /search")
        c2.close()
        check(sinfo["device"].startswith("cuda") and sinfo["count"] == CLI_ROWS,
              f"{name}: the child server's collection {sinfo}")
        check(tie_agree(pairs(sres["results"]), pairs(mine)) is not None,
              f"{name}: the child server's /search differs from the in-process search")
        say(f"{name}: python -m velesdb_tpu_torch.cli create / import ({CLI_ROWS:,} rows) / "
            f"query / migrate and python -m velesdb_tpu_torch.server, each a child process "
            f"on the default device ({made['device']}, {sinfo['device']}): the same ids as "
            f"in-process, {time.perf_counter() - t0:.2f} s")

        # -- numbers, before the phase's profile --------------------------------
        d50, d99 = p50_p99(lambda i: col.search(Q[i], k=k), range(100))
        for window, lat, rep, rec in ((0.0, lat0, rep0, rec0),
                                      (float(SERVE_WINDOW_MS), lat2, rep2, rec2)):
            say(f"{name} HTTP /search, {SERVE_THREADS} client threads x {SERVE_PER_THREAD}, "
                f"window {window} ms: p50 {np.percentile(lat, 50):.3f} ms, p99 "
                f"{np.percentile(lat, 99):.3f} ms; {n_req / rep['wall_s']:.1f} requests/s "
                f"({n_req} in {rep['wall_s']:.3f} s wall; connections opened and warmed in "
                f"{rep['warm_s']:.2f} s before)")
        say(f"{name} window {SERVE_WINDOW_MS} ms: {batches2} batcher dispatches for {n_req} "
            f"requests, mean coalesced batch {n_req / batches2:.1f} ({coal2} requests in shared "
            f"dispatches); direct col.search p50 {d50:.3f} ms, p99 {d99:.3f} ms (100 calls, "
            f"one thread)")
        for b, s in ((256, 0), (16, 256)):
            body = {"vectors": Q[s : s + b].tolist(), "k": k}
            h50, h99 = p50_p99(lambda i: ok(request(conn, "POST", f"{route}/search/batch",
                                                    body), "batch"), range(TIMED_CALLS))
            b50, _ = p50_p99(lambda i: col.search_batch(Q[s : s + b], k), range(TIMED_CALLS))
            res = col.search_batch(Q[s : s + b], k)
            enc, _ = p50_p99(lambda i: json.dumps(
                {"results": [[dict(h) for h in row] for row in res]},
                default=_json_default).encode(), range(10))
            raw = json.dumps(body).encode()
            dec, _ = p50_p99(lambda i: json.loads(raw), range(10))
            say(f"{name} HTTP /search/batch b={b}: p50 {h50:.3f} ms (p99 {h99:.3f}), direct "
                f"search_batch p50 {b50:.3f} ms; the response's JSON encode {enc:.3f} ms "
                f"(share {enc / h50:.3f}), the request's JSON decode {dec:.3f} ms "
                f"({TIMED_CALLS} calls, one connection)")
        one = col.search(Q[0], k=k)
        enc1, _ = p50_p99(lambda i: json.dumps({"results": [dict(h) for h in one]},
                                                default=_json_default).encode(), range(50))
        say(f"{name} HTTP /search: the response's JSON encode {enc1:.4f} ms (share "
            f"{enc1 / np.percentile(lat0, 50):.2e} of the window-0 p50, "
            f"{enc1 / np.percentile(lat2, 50):.2e} of the window-2 p50)")

        # -- one profile of a coalesced dispatch ---------------------------------
        b_pad = 1 << max(3, (max(round(n_req / batches2), 1) - 1).bit_length())
        batches = [Q[(i * b_pad) % n_req : (i * b_pad) % n_req + b_pad] for i in range(9)]
        p50, _ = p50_p99(lambda i: col.search_batch(batches[i], k), range(1, 9))
        busy, top = device_profile(torch, lambda qb: col.search_batch(qb, k), batches[1:9],
                                   top=4)
        if busy <= 0.0:
            print(f"{name}: device busy not measured (no device events)", flush=True)
        else:
            say(f"{name} coalesced dispatch (search_batch at the padded b {b_pad}): device "
                f"busy {busy:.4f} ms/call, idle share {1.0 - busy / p50:.3f} against its p50 "
                f"{p50:.3f} ms (torch.profiler over 8 calls)")
            for op, t in top:
                say(f"    {t:.4f} ms/call  {op[:100]}")
    finally:
        for child in opened:
            if isinstance(child, subprocess.Popen):
                if child.poll() is None:
                    child.terminate()
                    try:
                        child.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        child.kill()
                        child.wait(timeout=30)
            else:
                child.close()
        httpd.shutdown()
        httpd.server_close()
        for bt in app._batchers.values():
            bt.stop()
        app.db.close()
        serving.join(timeout=60)
    seconds = time.perf_counter() - t_phase
    say(f"phase 13 serve: {seconds:.1f} s")
    return seconds


def unit64(torch, x, dev):
    """The rows of ``x`` in float64 on ``dev``, normalized: the cosine
    oracle's corpus (``oracle_topk`` normalizes only the queries)."""
    x64 = torch.from_numpy(x).to(dev).double()
    return x64 / x64.norm(dim=1, keepdim=True).clamp_min(1e-300)


def main() -> None:
    global CARD
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "velesdb_tpu_torch")):
        fail("velesdb_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")

    # -- 1. device -----------------------------------------------------------
    phase("1. device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD = smi.strip()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    from velesdb_tpu_torch import Database
    import velesdb_tpu_torch.index.brute as brute_mod
    from velesdb_tpu_torch.index.brute import _affine_fold, pad_rows
    import velesdb_tpu_torch.index.ivf as ivf_mod
    from velesdb_tpu_torch.index.params import SearchQuality
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk
    from velesdb_tpu_torch.ops import ivf_kernel as ik
    from velesdb_tpu_torch.ops import pallas_kernels as pk
    from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize
    from velesdb_tpu_torch.ops.quantization import (
        binary_quantize,
        binary_unpack,
        sq8_pack_blocked,
        sq8_quantize,
        sq8_unpack_blocked,
    )

    F = torch.nn.functional

    from velesdb_tpu_torch.experiments import kernels as xk

    counters = (bk.LAUNCHES, pk.LAUNCHES, ik.LAUNCHES, xk.LAUNCHES)
    from velesdb_tpu_torch.tools import sharded_phase

    # phase 14's north-star shard (~20 s of numpy) is made while nvcc builds
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    north_star = pool.submit(make_clustered, np.random.default_rng(42),
                             sharded_phase.NS_ROWS + sharded_phase.NS_QUERIES, sharded_phase.NS_D)
    pool.shutdown(wait=False)
    t0 = time.perf_counter()
    _cuda.build_all(LIBS)
    say(f"build {len(LIBS)} kernel libraries ({len(KERNELS)} kernels) in parallel: "
        f"{time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{n} nvcc {_cuda.BUILD_SECONDS[n]:.2f} s" for n in LIBS))
    for name in LIBS:
        log = _cuda.BUILD_LOG.get(name, "").splitlines()
        lines = [ln.strip() for ln in log if ("Used" in ln and "registers" in ln) or "spill" in ln]
        # ptxas's note, once per wgmma, that it fenced the accumulators
        # before other instructions touch them
        notes = sum("C7519" in ln for ln in log)
        print(f"ptxas {name}: " + " | ".join(lines)
              + (f" | {notes} wgmma accumulator fences inserted (C7519)" if notes else ""),
              flush=True)

    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # Derived issue ceilings, not profiled: 64 dp4a and 16 popc per SM per
    # clock (compute capability 9.0 arithmetic throughput) at the max SM clock.
    dp4a_rate = 64 * n_sm * sm_mhz * 1e6
    popc_rate = 16 * n_sm * sm_mhz * 1e6
    record = {}  # kernel name -> JSON row

    def kernel_row(name, source, replaces, ms, plain_ms, ops_ms, bytes_, err, issue=None,
                   library_ms=None, other=None):
        b_ms, b_by = bound(ops_ms, bytes_)
        record[name] = {
            "name": name, "route": "cuda", "source": f"velesdb_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        }
        extra = ""
        if issue is not None:
            what, count, rate = issue
            extra = (f"; {what} issue {count / (ms * 1e-3) / 1e12:.4f} T/s = "
                     f"{count / (ms * 1e-3) / rate:.4f} of the derived ceiling "
                     f"{rate / 1e12:.4f} T/s")
        if other is not None:  # (what, ops, peak): the same work at another peak rate
            what, ops, peak = other
            extra += f"; {what} {bound(ops / peak * 1e3, bytes_)[0]:.4f} ms"
        lib = ("no single PyTorch call computes this function, so library_ms is null"
               if library_ms is None else f"library call {library_ms:.4f} ms")
        say(f"{name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {b_ms / ms:.4f} of it){extra}; {lib}")

    rng = np.random.default_rng(42)
    sift_all = make_clustered(rng, SIFT_N + HELD_OUT, SIFT_D)
    sift, sift_q = sift_all[:SIFT_N], sift_all[SIFT_N:]
    sift_pad = pad_rows(SIFT_N)

    # -- 2. kernels vs plain versions, bit for bit ---------------------------
    phase("2. kernels vs plain versions")

    def shadow(x, metric, valid):
        xt = torch.from_numpy(x).to(dev)
        if metric == "cosine":
            xt = xt / xt.norm(dim=1, keepdim=True)
        pd = bk.sq8pd_build(xt, torch.from_numpy(valid).to(dev), x.shape[1], metric)
        check(pd is not None, f"sq8pd_build refused the {metric} shadow")
        return pd

    def gm_case(label, queries, pd, n, chunk, mask=None):
        rows_pd, pen_int, _, sdim, _, qu = pd
        ptile = bk.sq8pd_ptile(pen_int, chunk)
        if mask is not None:
            ptile = torch.where(mask, ptile, -64 * bk._pd_invalid_pen(queries.shape[1]))
        qi, b_pad = bk._sq8pd_quantize_queries(
            torch.from_numpy(queries).to(dev), sdim, qu, rows_pd.shape[1]
        )
        gm = bk.sq8pd_bucket_gm(qi, rows_pd, ptile, chunk)
        torch.cuda.synchronize()
        check(gm.shape == (b_pad, n // chunk * 128), f"{label}: gm shape {tuple(gm.shape)}")
        err = hold(label, gm, bk.sq8pd_bucket_gm_ref(qi, rows_pd, ptile, chunk))
        return qi, rows_pd, ptile, err

    slice_shape = f"B_pad 256, N {sift_pad}, D_pad 128, chunk {CHUNK}"
    sift_pd = shadow(np.pad(sift, ((0, sift_pad - SIFT_N), (0, 0))), "euclidean",
                     np.arange(sift_pad) < SIFT_N)
    # the kernel has one build per query tile (128, 16, 8): the batch sizes
    # of the main path (256, 16, 1) reach all three at the slice's N
    errs = {name: 0.0 for name in KERNELS}
    for b in (1, 16):
        qi16, *_, err = gm_case(
            f"sq8pd_bucket B {b}, N {sift_pad}, D_pad 128, chunk {CHUNK}, euclidean",
            sift_q[:b], sift_pd, sift_pad, CHUNK,
        )
        errs["sq8pd_bucket"] = max(errs["sq8pd_bucket"], err)
    qi, rows_pd, ptile, err = gm_case(
        f"sq8pd_bucket {slice_shape}, euclidean", sift_q[:256], sift_pd, sift_pad, CHUNK,
    )
    errs["sq8pd_bucket"] = max(errs["sq8pd_bucket"], err)
    ragged = make_clustered(np.random.default_rng(7), RAGGED_N + RAGGED_B, RAGGED_D)
    r_valid = np.random.default_rng(8).random(RAGGED_N) >= 0.15
    r_mask = torch.from_numpy(np.random.default_rng(9).random(RAGGED_N) >= 0.15).to(dev)
    r_keep = torch.from_numpy(r_valid).to(dev) & r_mask
    for metric in ("euclidean", "cosine", "dot_product"):
        pd = shadow(ragged[:RAGGED_N], metric, r_valid)
        _, _, _, err = gm_case(
            f"sq8pd_bucket B {RAGGED_B}, N {RAGGED_N}, D {RAGGED_D}, chunk {CHUNK}, "
            f"15% invalid + 15% masked, {metric}",
            ragged[RAGGED_N:], pd, RAGGED_N, CHUNK, mask=r_mask,
        )
        errs["sq8pd_bucket"] = max(errs["sq8pd_bucket"], err)

    kernel_ms = time_kernel(torch, lambda: bk.sq8pd_bucket_gm(qi, rows_pd, ptile, CHUNK))
    ms16 = time_kernel(torch, lambda: bk.sq8pd_bucket_gm(qi16, rows_pd, ptile, CHUNK))
    plain_ms = time_kernel(torch, lambda: bk.sq8pd_bucket_gm_ref(qi, rows_pd, ptile, CHUNK))
    lib_ms = time_kernel(torch, lambda: bucket_max(
        torch._int_mm(qi, rows_pd.T) * 64 + ptile, CHUNK))
    b_pad, d_pad = qi.shape

    def pd_bytes(b):  # the queries, rows and ptile read once, gm written once
        return b * d_pad + rows_pd.numel() + 4 * ptile.numel() + 4 * b * sift_pad // CHUNK * 128

    kernel_row(
        "sq8pd_bucket", "sq8i_bucket.cu", "velesdb_tpu/ops/bucket_kernel.py:695",
        kernel_ms, plain_ms, int8_ops_ms(b_pad, sift_pad, d_pad, 2), pd_bytes(b_pad),
        errs["sq8pd_bucket"], library_ms=lib_ms,
        other=(DP4A_FIRST, b_pad * sift_pad * d_pad / 4, dp4a_rate),
    )
    say("sq8pd_bucket library yardstick: torch._int_mm(qi, rows.T) * 64 + ptile, then the "
        "bucket amax")
    check_int8("sq8pd_bucket", kernel_ms, sift_pad, lib_ms, ms16, 2, pd_bytes)
    del sift_pd, qi, qi16, rows_pd, ptile
    torch.cuda.empty_cache()

    # the slice-2 kernels at the ragged shapes: 15% invalid + 15% masked rows
    rx = torch.from_numpy(ragged).to(dev)
    rq = rx[RAGGED_N:]
    for metric in ("euclidean", "cosine", "dot_product"):
        m = DistanceMetric.parse(metric)
        sq = sq8_quantize(rx[:RAGGED_N])
        scale, minv, pen, _ = _affine_fold(sq, r_keep, m)
        rows8 = bk.sq8_int8_rows(sq.codes)
        qi8, _, sqi, invqs, _ = bk._sq8i_quantize_queries(rq, m, rows8.shape[1])
        args = (qi8, rows8, scale, 128.0 * scale + minv, pen, sqi, invqs, CHUNK)
        out = bk.sq8i_bucket_gm(*args)
        torch.cuda.synchronize()
        errs["sq8i_bucket"] = max(errs["sq8i_bucket"], hold(
            f"sq8i_bucket B {RAGGED_B}, N {RAGGED_N}, D {RAGGED_D}, chunk {CHUNK}, "
            f"15% invalid + 15% masked, {metric}", out, bk.sq8i_bucket_ref(*args)))
    bits = bk.hamming_bits_rows(rx[:RAGGED_N], RAGGED_D)
    csum = bits.to(torch.int32).sum(dim=1)
    aux = torch.where(r_keep, csum, csum + bk._HAM_BIG).to(torch.int32)
    qbits = torch.nn.functional.pad((rq >= 0).to(torch.int8), (0, bits.shape[1] - RAGGED_D))
    qi2 = torch.nn.functional.pad(2 * qbits, (0, 0, 0, 3))
    out = bk.hamming_mxu_gm(qi2, bits, aux, CHUNK)
    torch.cuda.synchronize()
    errs["hamming_mxu_bucket"] = hold(
        f"hamming_mxu_bucket B {RAGGED_B}, N {RAGGED_N}, D {RAGGED_D}, chunk {CHUNK}, "
        f"15% invalid + 15% masked", out, bk.hamming_mxu_ref(qi2, bits, aux, CHUNK))
    packed_r = binary_quantize(rx[:RAGGED_N])
    qp = torch.nn.functional.pad(binary_quantize(rq), (0, 0, 0, 3))
    pen0 = torch.where(r_keep, 0.0, torch.inf)
    out = bk.hamming_bucket_gm(qp, packed_r, pen0, bk.HAMMING_CHUNK)
    torch.cuda.synchronize()
    errs["hamming_bucket"] = hold(
        f"hamming_bucket B {RAGGED_B}, N {RAGGED_N}, W 4, chunk {bk.HAMMING_CHUNK}, "
        f"15% invalid + 15% masked", out,
        bk.hamming_bucket_ref(qp, packed_r, pen0, bk.HAMMING_CHUNK))
    out = pk.hamming_topk(binary_quantize(rq), packed_r, r_keep, K)
    torch.cuda.synchronize()
    errs["hamming_topk"] = hold(
        f"hamming_topk B {RAGGED_B}, N {RAGGED_N}, W 4, k {K}, 15% invalid + 15% masked",
        out, pk.hamming_topk_ref(binary_quantize(rq), packed_r, r_keep, K))
    # the slice-3 kernels at the ragged shapes, each on the operands its
    # wrapper prepares: cosine normalized, euclidean queries doubled
    ragged = f"B {RAGGED_B}, N {RAGGED_N}, D {RAGGED_D}, 15% invalid + 15% masked"
    floats = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
    for metric in ("euclidean", "cosine", "dot_product"):
        m = DistanceMetric.parse(metric)
        rows, q = rx[:RAGGED_N], rq
        if m is DistanceMetric.COSINE:
            rows, q = normalize(rows), normalize(q)
        q2 = 2.0 * q if m is DistanceMetric.EUCLIDEAN else q
        base = (rows * rows).sum(1) if m is DistanceMetric.EUCLIDEAN else torch.zeros_like(rows[:, 0])
        cc = torch.where(r_keep, base, torch.inf)
        qp2 = F.pad(q2, (0, 128 - RAGGED_D, 0, 3))
        rp = F.pad(rows, (0, 128 - RAGGED_D))
        for dname, dt in floats.items():
            args = (qp2.to(dt), rp.to(dt).contiguous(), cc, CHUNK)
            out = bk.dense_bucket_gm(*args)
            torch.cuda.synchronize()
            if dt == torch.float32:
                errs["dense_bucket"] = max(errs["dense_bucket"], hold_f32(
                    f"dense_bucket {ragged}, chunk {CHUNK}, {dname}, {metric}", *args, out))
            else:
                errs["dense_bucket_tc"] = max(errs["dense_bucket_tc"], hold_tc(
                    f"dense_bucket_tc {ragged}, chunk {CHUNK}, {dname}, {metric}", *args, out))
            qf = F.pad(q, (0, 128 - RAGGED_D)).contiguous()
            rf = rp.to(dt).contiguous()
            cn = (rf.float() ** 2).sum(1)
            aux = (torch.where(cn > 1e-30, torch.rsqrt(cn.clamp_min(1e-30)), 0.0)
                   if m is DistanceMetric.COSINE else cn)
            args = (qf, rf, r_keep, aux, (qf * qf).sum(1), K, metric)
            out = pk.fused_topk_scan(*args)
            torch.cuda.synchronize()
            errs["fused_topk"] = max(errs["fused_topk"], hold_fused(
                f"fused_topk {ragged}, k {K}, {dname}, {metric}", *args, out))
        args = (*bk.split_f32_rows(qp2), *bk.split_f32_rows(rp), cc, CHUNK)
        out = bk.hl_bucket_gm(*args)
        torch.cuda.synchronize()
        errs["hl_bucket"] = max(errs["hl_bucket"], hold_hl(
            f"hl_bucket {ragged}, chunk {CHUNK}, {metric}", *args, out))
        sq = sq8_quantize(rx[:RAGGED_N])
        scale, minv, pen, _ = _affine_fold(sq, r_keep, m)
        q6 = F.pad(q2, (0, 0, 0, 3))
        args = (q6, sq8_pack_blocked(sq.codes), scale, minv, pen, q6.sum(1), CHUNK)
        out = bk.sq8_bucket_gm(*args)
        torch.cuda.synchronize()
        errs["sq8_bucket"] = max(errs["sq8_bucket"], hold_sq8(
            f"sq8_bucket {ragged} (W 25), chunk {CHUNK}, {metric}", *args, out))
        # #10: the ragged rows cut into partitions of 136 slots, the last 40
        # all dead (as past c_real), each probe drawn over every partition
        n_parts = RAGGED_N // RAGGED_L
        keep = r_keep[: n_parts * RAGGED_L].clone()
        keep[-40 * RAGGED_L:] = False
        probe = torch.from_numpy(np.random.default_rng(10).integers(
            0, n_parts, (RAGGED_B, RAGGED_PROBES)).astype(np.int32)).to(dev)
        probe[:, 0] = n_parts - 1
        rows = rows[: n_parts * RAGGED_L]
        psq = (rows * rows).sum(1)
        inv = torch.rsqrt(psq) if m is DistanceMetric.COSINE else torch.ones_like(psq)
        pen = torch.where(keep, psq if m is DistanceMetric.EUCLIDEAN else 0.0, torch.inf)
        sq = sq8_quantize(rx[: n_parts * RAGGED_L])
        words = sq8_pack_blocked(torch.where(keep[:, None], sq.codes, 0))
        fold = inv if m is DistanceMetric.COSINE else torch.ones_like(psq)
        for sname, parts, mul, add, qp in (
            ("f32", torch.where(keep[:, None], rows, 0.0), inv, torch.zeros_like(psq), q2),
            ("sq8", words, sq.scale * fold, sq.minv * fold, q2),
        ):
            width = parts.shape[1]
            qk = F.pad(qp, (0, (4 * width if sname == "sq8" else width) - RAGGED_D))
            qsum = qk.sum(1)
            if sname == "sq8":
                qk = qk.to(torch.bfloat16).float()
            aux = torch.stack([t.reshape(n_parts, RAGGED_L) for t in (mul, add, pen)], 1)
            args = (qk.contiguous(), qsum, probe,
                    parts.reshape(n_parts, RAGGED_L, width).contiguous(), aux.contiguous())
            out = ik.ivf_probe_scores(*args)
            torch.cuda.synchronize()
            check(bool(torch.isneginf(out).any()), "ivf_probe: no dead slot reached")
            errs["ivf_probe"] = max(errs["ivf_probe"], hold(
                f"ivf_probe {sname} B {RAGGED_B}, nprobe {RAGGED_PROBES}, L {RAGGED_L}, "
                f"D {RAGGED_D}, 15% dead slots + 40 dead partitions, {metric}", out,
                ik.ivf_probe_ref(*args)))
    del rx, rq, bits, aux, qbits, qi2, packed_r, qp, pen0, out, sq, rows8, args, rows, rp, rf
    torch.cuda.empty_cache()

    # -- 14. multi-device search on torch.distributed: here, while the card
    # is nearly empty (its world of 4 shares the card with this process) and
    # before any profile (host-clock numbers read clean)
    launches = {"sq8i_bucket": 0, "ivf_probe": 0}
    phase("14. sharded")
    finish_sharded = sharded_phase.sharded_phase(
        sys.modules[__name__], counters, launches, errs, north_star=north_star.result(),
        sift=(sift, sift_q))
    del north_star

    tmp = tempfile.mkdtemp(prefix="velesdb_chip_smoke_")
    try:
        # -- 3. slice 1: SIFT-1M class through Database / Collection --------
        phase("3. sift1m FULL")
        t0 = time.perf_counter()
        db = Database.open(tmp, device=DEVICE)
        col = db.create_collection("sift1m", SIFT_D, metric="euclidean")
        payloads = [{"cat": i % 8} for i in range(SIFT_N)]
        col.upsert_bulk(range(SIFT_N), sift, payloads)
        say(f"sift1m ingest with payloads: {time.perf_counter() - t0:.2f} s (beside phase 14's "
            f"world of 4)")
        t0 = time.perf_counter()
        col.refresh_device()
        torch.cuda.synchronize()
        say(f"sift1m device refresh (upload + pd shadow + ptile): {time.perf_counter() - t0:.2f} s")
        # phase 14's world of 4 ran beside this host-bound ingest; it ends
        # before anything here is timed on the card
        finish_sharded()
        check(col.info()["serve_engine"] == "int8-assist-pd",
              f"serve_engine {col.info()['serve_engine']!r}, expected 'int8-assist-pd'")

        with MainPath(counters, bk, "sq8pd_bucket_gm", "sq8pd_bucket_gm") as run:
            res256 = col.search_batch(sift_q[:256], k=K)
            run.launched("search_batch b=256")
            res16 = col.search_batch(sift_q[256:272], k=K)
            run.launched("search_batch b=16")
            one = col.search(sift_q[300], k=K)
            run.launched("search")
            filt = {"type": "eq", "field": "cat", "value": 3}
            resf = col.search_batch(sift_q[:256], k=K, filter=filt)
            run.launched("filtered search_batch")
        launches["sq8pd_bucket"] = run.launches()
        errs["sq8pd_bucket"] = max(errs["sq8pd_bucket"], run.hold_all(
            lambda qi, rows, pt, ch: bk.sq8pd_bucket_gm_ref(qi, rows, pt, ch),
            lambda qi, rows, pt, ch: (f"sq8pd_bucket B_pad {qi.shape[0]}, N {rows.shape[0]}, "
                                      f"D_pad {rows.shape[1]}, chunk {ch}")))

        corpus64 = torch.from_numpy(sift).to(dev).double()
        o_v, o_i = oracle_topk(torch, corpus64, sift_q[:301], "euclidean", K)
        rec256 = score_results(res256, o_v[:256], o_i[:256], 1e-4)
        rec16 = score_results(res16, o_v[256:272], o_i[256:272], 1e-4)
        rec1 = score_results([one], o_v[300:301], o_i[300:301], 1e-4)
        cat_mask = torch.from_numpy(np.arange(SIFT_N) % 8 == 3).to(dev)
        of_v, of_i = oracle_topk(torch, corpus64, sift_q[:256], "euclidean", K, cat_mask)
        recf = score_results(resf, of_v, of_i, 1e-4)
        bad = [h.id for row in resf for h in row if h.id % 8 != 3 or h.payload != {"cat": 3}]
        check(not bad, f"filtered search returned filtered-out ids {bad[:5]}")
        print(
            f"sift1m recall@10 vs float64 oracle: b=256 {rec256:.4f}, b=16 {rec16:.4f}, "
            f"search {rec1:.4f}, filtered b=256 {recf:.4f}",
            flush=True,
        )
        for name, r in (("b=256", rec256), ("b=16", rec16)):
            check(r >= 0.99, f"sift1m recall@10 {name} = {r:.4f} < 0.99")
        # one query and the 1/8-selective filter: sanity floors, not targets
        check(rec1 >= 0.9, f"sift1m single-query recall@10 = {rec1:.4f}")
        check(recf >= 0.9, f"sift1m filtered recall@10 = {recf:.4f}")
        ids_before = [[h.id for h in row] for row in res256]
        db.close()
        db = Database.open(tmp, device=DEVICE)
        col = db.get_collection("sift1m")
        check(col.count() == SIFT_N, f"reopened count {col.count()}")
        res_re = col.search_batch(sift_q[:256], k=K)
        ids_after = [[h.id for h in row] for row in res_re]
        check(
            all(set(a) == set(b) for a, b in zip(ids_before, ids_after)),
            "reopened collection returned other ids",
        )
        check(res_re[0][0].payload == {"cat": res_re[0][0].id % 8}, "payload lost on reopen")
        print("sift1m close + reopen: same ids for all 256 queries", flush=True)

        # -- 3b. sift1m at k = 300, past the assist cores' guard ----------
        # (m = 256 < k) and inside the collision guard (k <= 0.02 * 16,384
        # buckets + 1): bucket-f32 on the f32 rows, #2's f32 mode
        phase("3b. sift1m FULL at k = 300 (bucket-f32)")
        k300 = 300
        check(col._brute.serve_engine(k300) == "bucket-f32",
              f"sift1m serve_engine(300) {col._brute.serve_engine(k300)!r}, expected 'bucket-f32'")
        with MainPath(counters, bk, "dense_bucket_gm", "dense_bucket_gm") as run:
            k256 = col.search_batch(sift_q[:256], k=k300)
            run.launched("search_batch b=256 k=300")
            k16 = col.search_batch(sift_q[256:272], k=k300)
            run.launched("search_batch b=16 k=300")
        launches["dense_bucket"] = launches.get("dense_bucket", 0) + run.launches()
        errs["dense_bucket"] = max(errs["dense_bucket"], run.hold_all(
            None,
            lambda q, rows, cc, ch: (f"dense_bucket k=300 search B_pad {q.shape[0]}, "
                                     f"N {rows.shape[0]}, D_pad {rows.shape[1]}, chunk {ch}"),
            holder=hold_f32))
        # the same searches through #2's plain version on the card
        kernel_gm = bk.dense_bucket_gm
        bk.dense_bucket_gm = bk.dense_bucket_ref
        try:
            p256 = col.search_batch(sift_q[:256], k=k300)
            p16 = col.search_batch(sift_q[256:272], k=k300)
        finally:
            bk.dense_bucket_gm = kernel_gm
        _, o300_i = oracle_topk(torch, corpus64, sift_q[:272], "euclidean", k300)
        rk = {"b=256": (ids_recall(k256, o300_i[:256]), ids_recall(p256, o300_i[:256])),
              "b=16": (ids_recall(k16, o300_i[256:]), ids_recall(p16, o300_i[256:]))}
        print("sift1m k=300 (bucket-f32, #2 on f32 rows) recall@300 vs the float64 oracle, "
              "kernel (plain version): " + ", ".join(
                  f"{name} {a:.4f} ({b:.4f})" for name, (a, b) in rk.items()), flush=True)
        for name, (a, b) in rk.items():
            check(abs(a - b) <= 0.005, f"sift1m k=300 {name}: recall@300 {a:.4f} through the "
                  f"kernel, {b:.4f} through the plain version")
        del k256, k16, p256, p16, o300_i

        # -- 4. slice 1: 100K x 768D cosine (streamed scan) -----------------
        phase("4. 100k-768d FULL")
        c768_all = make_clustered(np.random.default_rng(42), C768_N + HELD_OUT, C768_D)
        c768, c768_q = c768_all[:C768_N], c768_all[C768_N:]
        col768 = db.create_collection("c768", C768_D, metric="cosine")
        col768.upsert_bulk(range(C768_N), c768)
        r768 = col768.search_batch(c768_q[:256], k=K)
        check(col768.info()["serve_engine"] == "streamed-scan",
              f"serve_engine {col768.info()['serve_engine']!r}, expected 'streamed-scan'")
        c64 = torch.from_numpy(c768).to(dev).double()
        c64 = c64 / c64.norm(dim=1, keepdim=True)
        o_v, o_i = oracle_topk(torch, c64, c768_q[:256], "cosine", K)
        rec768 = score_results(r768, o_v, o_i, 1e-4)
        print(f"100k-768d cosine recall@10 vs float64 oracle: b=256 {rec768:.4f}", flush=True)
        check(rec768 >= 0.999, f"100k-768d recall@10 = {rec768:.4f} < 0.999")

        def device_only(c, k):
            return lambda b: c._search_device(b, k, None)[1].cpu()

        measure(torch, "sift1m", lambda b: col.search_batch(b, k=K),
                "sift1m device path (no hydrate)", device_only(col, K), sift_q)
        measure(torch, "100k-768d", lambda b: col768.search_batch(b, k=K),
                "100k-768d device path (no hydrate)", device_only(col768, K), c768_q)
        db.delete_collection("c768")

        # -- 4b. slice 3: the op fused_topk (#8), B 256 x 100K x 768 f32 cosine
        phase("4b. fused_topk op")
        ct = torch.from_numpy(c768).to(dev)
        qt = torch.from_numpy(c768_q[:256]).to(dev)
        with MainPath(counters, pk, "fused_topk_scan", "fused_topk") as run:
            fv, fi = pk.fused_topk(qt, ct, k=K, metric="cosine")
            run.launched("fused_topk k=10")
            fv100, fi100 = pk.fused_topk(qt, ct, k=100, metric="cosine")
            run.launched("fused_topk k=100")
            fv16, fi16 = pk.fused_topk(qt[:16], ct, k=K, metric="cosine")
            run.launched("fused_topk B 16")
            pk.fused_topk(qt[:1], ct, k=K, metric="cosine")
            run.launched("fused_topk B 1")
        launches["fused_topk"] = run.launches()
        errs["fused_topk"] = max(errs["fused_topk"], run.hold_all(
            None,
            lambda q, rows, valid, aux, qq, k, metric: (
                f"fused_topk B {q.shape[0]}, N {rows.shape[0]}, D_pad {q.shape[1]}, k {k}, "
                f"{rows.dtype}, {metric}"), holder=hold_fused))
        tolerance_summary("fused_topk", "fused_topk_tolerance (|err| <= f (3.1 2^-16 + 8 (2 "
                          "sqrt(3 D_pad) + sqrt(2 D_pad)) 2^-24) A + 2 ulp, A the row's sum "
                          "of |q_d x_d|)")
        o100_v, o100_i = oracle_topk(torch, c64, c768_q[:256], "cosine", 100)
        got = fi.cpu().numpy()
        r8 = np.mean([len(set(a) & set(b)) / K for a, b in zip(got, o_i)])
        r8_100 = np.mean([len(set(a) & set(b)) / 100 for a, b in zip(fi100.cpu().numpy(), o100_i)])
        same = got == o_i
        err8 = float(np.max(np.abs(fv.cpu().numpy()[same] - o_v[same]) / np.abs(o_v[same])))
        print(f"fused_topk cosine B 256 vs float64 oracle: recall@10 {r8:.4f}, recall@100 "
              f"{r8_100:.4f}, max rel err on shared ids {err8:.3e}", flush=True)
        check(r8 >= 0.999 and r8_100 >= 0.999, "fused_topk is not exact")
        check(err8 <= 1e-4, f"fused_topk score error {err8:.3e} above 1e-4")
        qn = normalize(qt)
        cn = (ct * ct).sum(1)
        aux = torch.where(cn > 1e-30, torch.rsqrt(cn.clamp_min(1e-30)), 0.0)
        ones = torch.ones(C768_N, dtype=torch.bool, device=dev)
        qq = (qn * qn).sum(1)
        fused_ms = {}
        for k in (K, 100):
            fused_ms[k] = (
                time_kernel(torch, lambda: pk.fused_topk_scan(qn, ct, ones, aux, qq, k, "cosine")),
                time_kernel(torch, lambda: pk.fused_topk_ref(qn, ct, ones, aux, qq, k, "cosine"),
                            iters=3),
                time_kernel(torch, lambda: torch.topk(qn @ ct.T, k, dim=1)),
            )
        # the function's work: the dot (2 B N D) and the fixup; the design
        # does it as three bf16 products on the tensor cores
        ops8 = 2 * 256 * C768_N * C768_D + 2 * 256 * C768_N
        bytes8 = 4 * 256 * C768_D + 4 * C768_N * C768_D + 5 * C768_N + 4 * 256 + 12 * 256 * K
        kernel_row(
            "fused_topk", "fused_topk.cu", "velesdb_tpu/ops/pallas_kernels.py:119",
            fused_ms[K][0], fused_ms[K][1], 3 * ops8 / PEAK_TC16 * 1e3, bytes8,
            errs["fused_topk"], library_ms=fused_ms[K][2], other=(F32_CORES, ops8, PEAK_F32),
        )
        say(f"fused_topk at k 100: kernel {fused_ms[100][0]:.4f} ms, plain torch "
            f"{fused_ms[100][1]:.4f} ms, library call {fused_ms[100][2]:.4f} ms (torch.topk of "
            f"q @ c.T), bound "
            f"{bound(3 * ops8 / PEAK_TC16 * 1e3, bytes8 + 12 * 256 * 90)[0]:.4f} ms")
        for k in (K, 100):
            say(f"fused_topk k {k}: {fused_ms[k][0]:.4f} ms; the first (fp32-core) design "
                f"{FIRST_FUSED_MS[k]:.4f} ms (recorded, {FIRST_FUSED_MS[k] / fused_ms[k][0]:.2f}x); "
                f"library {fused_ms[k][2]:.4f} ms ({fused_ms[k][2] / fused_ms[k][0]:.2f}x)")
            # at k 10 (the op's default) the kernel must beat both; at k 100 its
            # query tile halves (the key pools' room), the first design only
            check(fused_ms[k][0] < FIRST_FUSED_MS[k]
                  and (k != K or fused_ms[k][0] < fused_ms[k][2]),
                  f"fused_topk k {k}: {fused_ms[k][0]:.4f} ms, not faster than the first design "
                  f"({FIRST_FUSED_MS[k]:.4f})" + (f" and the library ({fused_ms[k][2]:.4f})"
                                                   if k == K else ""))
        del fv, fi, fv100, fi100, fv16, fi16, qn, cn, aux, ones, qt, ct

        # -- 4c. slice 3: 100k-768d-f16 (streamed scan on the half corpus) -----
        phase("4c. 100k-768d-f16")
        t0 = time.perf_counter()
        colf = db.create_collection("c768_f16", C768_D, metric="cosine", storage_mode="f16")
        colf.upsert_bulk(range(C768_N), c768)
        colf.refresh_device()
        torch.cuda.synchronize()
        say(f"100k-768d-f16 ingest + refresh: {time.perf_counter() - t0:.2f} s")
        idx = colf._brute
        check(colf.info()["serve_engine"] == "streamed-scan" and idx._full.dtype == torch.float16,
              f"serve_engine {colf.info()['serve_engine']!r} on {idx._full.dtype}, expected "
              f"'streamed-scan' on float16")
        rf16 = colf.search_batch(c768_q[:256], k=K)
        # the function it computes: f16(normalized q) . f16 rows / |c| (|c|^2 from f32)
        q64 = normalize(torch.from_numpy(c768_q[:256]).to(dev)).half().double()
        inv64 = 1.0 / torch.sqrt(idx._full_sqnorm[:C768_N].double())
        sf_i = oracle_ids(torch, idx._full[:C768_N].double(), q64, K, scale64=inv64)
        r_same = ids_recall(rf16, sf_i)
        r_f32 = ids_recall(rf16, o_i)
        print(f"100k-768d-f16 recall@10: {r_same:.4f} vs the float64 oracle of the function it "
              f"computes, {r_f32:.4f} vs the f32 data's", flush=True)
        check(r_same >= 0.999, f"100k-768d-f16 recall@10 = {r_same:.4f} < 0.999")
        measure(torch, "100k-768d-f16", lambda b: colf.search_batch(b, k=K),
                "100k-768d-f16 device path (no hydrate)", device_only(colf, K), c768_q)
        db.delete_collection("c768_f16")
        del c64, c768_all, c768, q64, inv64
        torch.cuda.empty_cache()

        # -- 5. slice 2: sift1m-sq8 ----------------------------------------
        phase("5. sift1m-sq8")
        t0 = time.perf_counter()
        colq = db.create_collection("sift1m_sq8", SIFT_D, metric="euclidean",
                                    storage_mode="sq8")
        colq.upsert_bulk(range(SIFT_N), sift, payloads)
        say(f"sift1m-sq8 ingest with payloads: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        colq.refresh_device()
        torch.cuda.synchronize()
        say(f"sift1m-sq8 device refresh (upload + SQ8 + int8 rows): "
            f"{time.perf_counter() - t0:.2f} s")
        check(colq.info()["serve_engine"] == "sq8-int8",
              f"serve_engine {colq.info()['serve_engine']!r}, expected 'sq8-int8'")
        idx = colq._brute
        am = 128.0 * idx._sq8_scale + idx._sq8_minv
        euclid = DistanceMetric.EUCLIDEAN
        for b in (1, 16, 256):
            qi8, _, sqi, invqs, _ = bk._sq8i_quantize_queries(
                torch.from_numpy(sift_q[:b]).to(dev), euclid, idx._sq8_rows8.shape[1])
            args = (qi8, idx._sq8_rows8, idx._sq8_scale, am, idx._sq8_pen, sqi, invqs, CHUNK)
            out = bk.sq8i_bucket_gm(*args)
            torch.cuda.synchronize()
            errs["sq8i_bucket"] = max(errs["sq8i_bucket"], hold(
                f"sq8i_bucket B {b} (B_pad {qi8.shape[0]}), N {idx.n_pad}, D_pad 128, "
                f"chunk {CHUNK}", out, bk.sq8i_bucket_ref(*args)))
            if b == 16:
                ms16 = time_kernel(torch, lambda: bk.sq8i_bucket_gm(*args))
        ms = time_kernel(torch, lambda: bk.sq8i_bucket_gm(*args))
        plain = time_kernel(torch, lambda: bk.sq8i_bucket_ref(*args), iters=5)
        lib = time_kernel(torch, lambda: bucket_max(
            torch._int_mm(qi8, idx._sq8_rows8.T).float() * idx._sq8_scale + sqi[:, None] * am
            - invqs[:, None] * idx._sq8_pen, CHUNK))
        n = idx.n_pad
        kernel_row(
            "sq8i_bucket", "sq8i_bucket.cu", "velesdb_tpu/ops/bucket_kernel.py:996", ms, plain,
            int8_ops_ms(256, n, 128, 6),
            256 * 128 + n * 128 + 3 * 4 * n + 2 * 4 * 256 + 8 * 256 * n // CHUNK * 128,
            errs["sq8i_bucket"], library_ms=lib,
            other=(DP4A_FIRST, 256 * n * 128 / 4, dp4a_rate),
        )
        say("sq8i_bucket library yardstick: torch._int_mm(qi, rows8.T), the affine epilogue, "
            "then the bucket amax")
        check_int8("sq8i_bucket", ms, n, lib, ms16, 6, lambda b: (
            b * 128 + n * 128 + 12 * n + 8 * b + 8 * b * n // CHUNK * 128))
        del out, args

        with MainPath(counters, bk, "sq8i_bucket_gm", "sq8i_bucket_gm") as run:
            t0 = time.perf_counter()
            q256 = colq.search_batch(sift_q[:256], k=K)
            say(f"sift1m-sq8 first search_batch b=256 with the storage gate: "
                f"{time.perf_counter() - t0:.2f} s (oversample {colq._rerank_oversample}, "
                f"calibrated recall {colq.info()['storage_recall']})")
            run.launched("search_batch b=256")
            q16 = colq.search_batch(sift_q[256:272], k=K)
            run.launched("search_batch b=16")
            q1 = colq.search(sift_q[300], k=K)
            run.launched("search")
            qf = colq.search_batch(sift_q[:256], k=K, filter=filt)
            run.launched("filtered search_batch")
            qraw = colq.search_batch(sift_q[:256], k=K, _raw=True)
            run.launched("raw search_batch")
        launches["sq8i_bucket"] += run.launches()
        sq8i_plain = bk.sq8i_bucket_ref
        sq8i_desc = (lambda qi, rows, *rest: f"sq8i_bucket B_pad {qi.shape[0]}, "
                     f"N {rows.shape[0]}, D_pad {rows.shape[1]}, chunk {rest[-1]}")
        errs["sq8i_bucket"] = max(errs["sq8i_bucket"], run.hold_all(sq8i_plain, sq8i_desc))
        o_v, o_i = oracle_topk(torch, corpus64, sift_q[:301], "euclidean", K)
        sift_ov, sift_oi = o_v, o_i
        r256 = score_results(q256, o_v[:256], o_i[:256], 1e-4)
        r16 = score_results(q16, o_v[256:272], o_i[256:272], 1e-4)
        r1 = score_results([q1], o_v[300:301], o_i[300:301], 1e-4)
        rraw = score_results(qraw, o_v[:256], o_i[:256], None)
        rf = score_results(qf, of_v, of_i, 1e-4)
        bad = [h.id for row in qf for h in row if h.id % 8 != 3 or h.payload != {"cat": 3}]
        check(not bad, f"sift1m-sq8 filtered search returned filtered-out ids {bad[:5]}")
        print(
            f"sift1m-sq8 recall@10 vs float64 oracle after auto-rerank (oversample "
            f"{colq._rerank_oversample}): b=256 {r256:.4f}, b=16 {r16:.4f}, search {r1:.4f}, "
            f"filtered b=256 {rf:.4f}; raw coarse pass b=256 {rraw:.4f}",
            flush=True,
        )
        for name, r in (("b=256", r256), ("b=16", r16)):
            check(r >= 0.95, f"sift1m-sq8 recall@10 {name} = {r:.4f} < 0.95")
        ids_before = [[h.id for h in row] for row in q256]
        del corpus64
        db.close()
        db = Database.open(tmp, device=DEVICE)
        colq = db.get_collection("sift1m_sq8")
        check(colq.storage_mode.value == "sq8", "storage mode lost on reopen")
        reopened = colq.search_batch(sift_q[:256], k=K)
        check(all(set(a) == set(h.id for h in b) for a, b in zip(ids_before, reopened)),
              "reopened sift1m-sq8 returned other ids")
        print("sift1m-sq8 close + reopen: same ids for all 256 queries", flush=True)
        m_sq8 = int(round(colq._rerank_oversample * K))
        measure(torch, "sift1m-sq8", lambda b: colq.search_batch(b, k=K),
                f"sift1m-sq8 device path (m={m_sq8}, no rerank)", device_only(colq, m_sq8),
                sift_q)

        # -- 5b. slice 3: sift1m-sq8-staged (block-packed words, #6) ----------
        phase("5b. sift1m-sq8-staged")
        db.close()
        brute_mod._SQ8I_MAX_DIM[0] = 128  # the reference's rule: packed words at D >= it
        try:
            db = Database.open(tmp, device=DEVICE)
            colq = db.get_collection("sift1m_sq8")
            t0 = time.perf_counter()
            colq.refresh_device()
            torch.cuda.synchronize()
            say(f"sift1m-sq8-staged device refresh (upload + SQ8 + packed words): "
                f"{time.perf_counter() - t0:.2f} s")
            idx = colq._brute
            check(idx._sq8_words is not None and idx._sq8_rows8 is None,
                  "the staged SQ8 build kept int8 rows")
            check(colq.info()["serve_engine"] == "sq8-bucket",
                  f"serve_engine {colq.info()['serve_engine']!r}, expected 'sq8-bucket'")
            n = idx.n_pad
            for b in (1, 16, 256):
                q6 = F.pad(2.0 * torch.from_numpy(sift_q[:b]).to(dev), (0, 0, 0, (-b) % 8))
                args = (q6, idx._sq8_words, idx._sq8_scale, idx._sq8_minv, idx._sq8_pen,
                        q6.sum(1), CHUNK)
                out = bk.sq8_bucket_gm(*args)
                torch.cuda.synchronize()
                errs["sq8_bucket"] = max(errs["sq8_bucket"], hold_sq8(
                    f"sq8_bucket B {b} (B_pad {q6.shape[0]}), N {n}, D_pad 128, "
                    f"chunk {CHUNK}", *args, out))
                if b == 16:
                    ms16 = time_kernel(torch, lambda: bk.sq8_bucket_gm(*args))
            ms = time_kernel(torch, lambda: bk.sq8_bucket_gm(*args))
            plain = time_kernel(torch, lambda: bk.sq8_bucket_ref(*args), iters=3)
            codes_f = sq8_unpack_blocked(idx._sq8_words).float()  # set-up, not timed
            lib = time_kernel(torch, lambda: bucket_max(
                (q6 @ codes_f.T) * idx._sq8_scale + args[5][:, None] * idx._sq8_minv
                - idx._sq8_pen, CHUNK))
            check_faster("sq8_bucket", ms, n, FIRST_SQ8_MS, lib, ms16, lambda b: (
                4 * b * 128 + n * 128 + 12 * n + 4 * b + 8 * b * n // CHUNK * 128))
            kernel_row(
                "sq8_bucket", "dense_bucket_tc.cu", "velesdb_tpu/ops/bucket_kernel.py:894", ms,
                plain, 6 * 256 * n * 128 / PEAK_TC16 * 1e3,
                4 * 256 * 128 + n * 128 + 12 * n + 4 * 256 + 8 * 256 * n // CHUNK * 128,
                errs["sq8_bucket"], other=(F32_CORES, 2 * 256 * n * 128 + 4 * 256 * n, PEAK_F32),
                library_ms=lib,
            )
            say("sq8_bucket library yardstick: fp32 q @ codes.T on the codes unpacked to f32 "
                "beforehand (4x the kernel's row bytes), the affine epilogue, the bucket amax")
            del out, args, q6, codes_f
            with MainPath(counters, bk, "sq8_bucket_gm", "sq8_bucket_gm") as run:
                t0 = time.perf_counter()
                s256 = colq.search_batch(sift_q[:256], k=K)
                say(f"sift1m-sq8-staged first search_batch b=256 with the storage gate: "
                    f"{time.perf_counter() - t0:.2f} s (oversample {colq._rerank_oversample}, "
                    f"calibrated recall {colq.info()['storage_recall']})")
                run.launched("search_batch b=256")
                s16 = colq.search_batch(sift_q[256:272], k=K)
                run.launched("search_batch b=16")
                s1 = colq.search(sift_q[300], k=K)
                run.launched("search")
                sf = colq.search_batch(sift_q[:256], k=K, filter=filt)
                run.launched("filtered search_batch")
                sraw = colq.search_batch(sift_q[:256], k=K, _raw=True)
                run.launched("raw search_batch")
            launches["sq8_bucket"] = run.launches()
            errs["sq8_bucket"] = max(errs["sq8_bucket"], run.hold_all(
                None,
                lambda q, words, *rest: (f"sq8_bucket B_pad {q.shape[0]}, N {words.shape[0]}, "
                                         f"W {words.shape[1]}, chunk {rest[-1]}"),
                holder=hold_sq8))
            tolerance_summary("sq8_bucket", "sq8_scan_tolerance (|err| <= |scale| 8 (2 sqrt(3 "
                              "D_pad) + sqrt(2 D_pad)) 2^-24 A + 2 ulp of each epilogue rounding, "
                              "A the row's sum of |q_d| code_d)")
            r256 = score_results(s256, sift_ov[:256], sift_oi[:256], 1e-4)
            r16 = score_results(s16, sift_ov[256:272], sift_oi[256:272], 1e-4)
            r1 = score_results([s1], sift_ov[300:301], sift_oi[300:301], 1e-4)
            rraw = score_results(sraw, sift_ov[:256], sift_oi[:256], None)
            rf = score_results(sf, of_v, of_i, 1e-4)
            bad = [h.id for row in sf for h in row if h.id % 8 != 3 or h.payload != {"cat": 3}]
            check(not bad, f"sift1m-sq8-staged filtered search returned filtered-out ids {bad[:5]}")
            print(
                f"sift1m-sq8-staged recall@10 vs float64 oracle after auto-rerank (oversample "
                f"{colq._rerank_oversample}): b=256 {r256:.4f}, b=16 {r16:.4f}, search {r1:.4f}, "
                f"filtered b=256 {rf:.4f}; raw coarse pass b=256 {rraw:.4f}",
                flush=True,
            )
            for name, r in (("b=256", r256), ("b=16", r16)):
                check(r >= 0.95, f"sift1m-sq8-staged recall@10 {name} = {r:.4f} < 0.95")
            ids_before = [[h.id for h in row] for row in s256]
            db.close()
            db = Database.open(tmp, device=DEVICE)
            colq = db.get_collection("sift1m_sq8")
            reopened = colq.search_batch(sift_q[:256], k=K)
            check(colq.info()["serve_engine"] == "sq8-bucket", "sq8-bucket lost on reopen")
            check(all(set(a) == set(h.id for h in b) for a, b in zip(ids_before, reopened)),
                  "reopened sift1m-sq8-staged returned other ids")
            print("sift1m-sq8-staged close + reopen: same ids for all 256 queries", flush=True)
            m_sq8 = int(round(colq._rerank_oversample * K))
            measure(torch, "sift1m-sq8-staged", lambda b: colq.search_batch(b, k=K),
                    f"sift1m-sq8-staged device path (m={m_sq8}, no rerank)",
                    device_only(colq, m_sq8), sift_q)
        finally:
            brute_mod._SQ8I_MAX_DIM[0] = 1 << 30

        # -- 5d. slice 4: sift1m-ivf and sift1m-sq8-ivf (#10) -------------------
        phase("5d. sift1m-ivf")
        db.close()
        db = Database.open(tmp, device=DEVICE)
        col = db.get_collection("sift1m")
        col.refresh_device()
        col.index_kind = "ivf"
        prof = {}
        t0 = time.perf_counter()
        col._ensure_ivf(profile=prof)
        ivf = col.ivf
        say(f"sift1m-ivf build {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in prof.items()))
        part_gib = ivf._parts.numel() * 4 / 2**30
        say(f"sift1m-ivf index: c {ivf._kmeans_c} k-means clusters, {ivf.c_real} partitions "
            f"({ivf.c} padded), L {ivf.part_len}, spill {ivf.spill}, partitions {part_gib:.3f} GiB")
        check(ivf.spill == 2 and ivf.storage == "f32", "sift1m-ivf: not the spill-2 f32 build")
        calib = {e: col.planner.engine_recall("ivf", e) for e in (16, 32, 64, 128, 256)}
        served = expected_ef(calib, 128, 0.95)
        check(col._plan_search(sift_q[:16], K, None)[2] == served,
              f"sift1m-ivf default profile not served at ef {served}")
        print("sift1m-ivf calibrated recall per ef: " + ", ".join(
            f"ef {e} {r:.4f}" for e, r in calib.items()) + f"; default profile serves ef {served}",
            flush=True)

        def probe_case(index, queries, nprobe):
            """#10's operands for ``queries`` on ``index``, as the probe op
            prepares them."""
            q, qsum, probe, _ = ik.probe_operands(torch.from_numpy(queries).to(dev),
                                                  index._centroids, index._cent_sq, index._parts,
                                                  nprobe=nprobe, metric=index.metric)
            return q, qsum, probe, index._parts, index._kernel_state()[0]

        np128 = ivf.nprobe_for(128)
        for b in (1, 16, 64):
            args = probe_case(ivf, sift_q[:b], np128)
            out = ik.ivf_probe_scores(*args)
            torch.cuda.synchronize()
            errs["ivf_probe"] = max(errs["ivf_probe"], hold(
                f"ivf_probe f32 B {b}, nprobe {np128}, L {ivf.part_len}, D 128 (sift1m-ivf)", out,
                ik.ivf_probe_ref(*args)))
        del out, args

        def probe_desc(q, qsum, probe, rows, aux):
            return (f"ivf_probe {'sq8' if rows.dtype == torch.int32 else 'f32'} B {q.shape[0]}, "
                    f"nprobe {probe.shape[1]}, L {rows.shape[1]}, D_pad {q.shape[1]}")

        with MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
            i16 = [col.search_batch(sift_q[i:i + 16], k=K, ef=128) for i in range(0, 256, 16)]
            run.launched("search_batch b=16 ef=128 (x16)")
            i64 = col.search_batch(sift_q[:64], k=K, ef=128)
            run.launched("search_batch b=64 ef=128")
            n_calls = len(run.calls)
            idef = col.search_batch(sift_q[256:272], k=K)
            run.launched("search_batch b=16 default profile")
            check(run.calls[n_calls][0][2].shape[1] == ivf.nprobe_for(served),
                  f"sift1m-ivf default profile did not probe at the downshifted ef {served}")
            i1 = col.search(sift_q[300], k=K)
            run.launched("search")
        launches["ivf_probe"] += run.launches()
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(ik.ivf_probe_ref, probe_desc))
        before = ik.LAUNCHES["ivf_probe"]
        i256 = col.search_batch(sift_q[:256], k=K, ef=128)
        ifl = col.search_batch(sift_q[:256], k=K, ef=128, filter=filt)
        check(ik.LAUNCHES["ivf_probe"] == before, "b=256 or a filtered search launched #10")
        r16 = ids_recall([r for rows in i16 for r in rows], sift_oi[:256])
        r64 = ids_recall(i64, sift_oi[:64])
        r256 = ids_recall(i256, sift_oi[:256])
        rdef = ids_recall(idef, sift_oi[256:272])
        r1 = ids_recall([i1], sift_oi[300:301])
        rf = ids_recall(ifl, of_i)
        bad = [h.id for row in ifl for h in row if h.id % 8 != 3 or h.payload != {"cat": 3}]
        check(not bad, f"sift1m-ivf filtered search returned filtered-out ids {bad[:5]}")
        cover = np128 * ivf.part_len / (ivf.spill * SIFT_N)
        print(f"sift1m-ivf recall@10 vs float64 oracle at ef 128 (nprobe {np128}, unique "
              f"coverage ~{cover:.4f} of the rows): b=16 {r16:.4f} (256 queries), b=64 "
              f"{r64:.4f}, b=256 {r256:.4f} (plain path), search {r1:.4f}; default profile "
              f"(ef {served}, nprobe {ivf.nprobe_for(served)}) b=16 {rdef:.4f}; filtered "
              f"b=256 {rf:.4f}", flush=True)
        check(r16 >= 0.95, f"sift1m-ivf recall@10 b=16 ef=128 = {r16:.4f} < 0.95")
        check(r256 >= 0.95, f"sift1m-ivf recall@10 b=256 ef=128 = {r256:.4f} < 0.95")

        def ivf_device(c):
            return lambda b: c._search_device(b, K, None, ef=128)[1].cpu()

        measure(torch, "sift1m-ivf ef=128", lambda b: col.search_batch(b, k=K, ef=128),
                "sift1m-ivf device path ef=128 (no hydrate)", ivf_device(col), sift_q, (16, 64))
        ivf_ms = {}

        def time_probe(label, index, qs):
            """#10 at ``qs``'s batch against its bound, its plain version, the
            probe op around it and the plain ``ivf_search_impl`` on the same
            queries (the same probes: one routing rule)."""
            b = qs.shape[0]
            args = probe_case(index, qs, np128)
            q, qsum, probe, rows, aux = args
            quant = rows.dtype == torch.int32
            L, width = rows.shape[1], rows.shape[2]
            ms = time_kernel(torch, lambda: ik.ivf_probe_scores(*args))
            plain = time_kernel(torch, lambda: ik.ivf_probe_ref(*args), iters=3)
            # library yardstick (f32): the probed partitions gathered with
            # index_select, one bmm against the queries, the affine; SQ8 has
            # none (the words' unpack is more computations: shifts, masks, a
            # concatenation)
            lib = None
            if not quant:
                pid = probe.reshape(-1).long()

                def library_probe():
                    blk = rows.index_select(0, pid).view(b, -1, width)
                    a = aux.index_select(0, pid).view(b, -1, 3, L)
                    dot = torch.bmm(blk, q[:, :, None]).view(b, -1, L)
                    return dot * a[:, :, 0] + qsum[:, None, None] * a[:, :, 1] - a[:, :, 2]

                lib = time_kernel(torch, library_probe)
            qt = torch.from_numpy(qs).to(dev)
            k_fetch = index.spill * K + 8
            kern = index._kernel_state()
            op_ms = time_kernel(torch, lambda: ik.ivf_probe_topk(
                qt, index._centroids, index._cent_sq, rows, *kern, k=k_fetch, nprobe=np128,
                metric=index.metric))
            parts = (rows, index._part_scale, index._part_minv) if quant else rows
            impl_ms = time_kernel(torch, lambda: ivf_mod.ivf_search_impl(
                qt, index._centroids, index._cent_sq, parts, index._part_rows, index._part_sq,
                None, k=k_fetch, nprobe=np128, metric=index.metric), iters=5)
            slots = b * np128 * L
            row_bytes = 4 * width
            small = 4 * q.numel() + 4 * b + 4 * probe.numel() + 4 * slots  # q, qsum, ids, out
            ops = 2 * slots * q.shape[1] + 4 * slots
            # the function needs each probed partition once (rows and aux),
            # however many queries probe it
            uniq = int(torch.unique(probe).numel())
            bytes_ = uniq * L * (row_bytes + 12) + small
            bytes_pairs = slots * (row_bytes + 12) + small
            b_ms, b_by = bound(ops / PEAK_F32 * 1e3, bytes_)
            ivf_ms[label] = (ms, plain, impl_ms, b_ms, b_by, bytes_, ops, lib)
            say(f"ivf_probe {label} (B {b}, nprobe {np128}, L {L}, D_pad {q.shape[1]}): kernel "
                f"{ms:.4f} ms (the first, one-block-per-probe design: {FIRST_PROBE_MS[label]} ms), "
                f"plain torch {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.4f} of "
                f"it; {uniq} unique partitions of {probe.numel()} probes, {bytes_ / 1e6:.1f} MB, "
                f"{ops:.3e} operations); read once per (query, probe), as the first design did: "
                f"{bytes_pairs / 1e6:.1f} MB, {bound(ops / PEAK_F32 * 1e3, bytes_pairs)[0]:.4f} "
                f"ms; probe op (route + kernel + select) {op_ms:.4f} ms; plain ivf_search_impl "
                f"on the same queries {impl_ms:.4f} ms; "
                + ("library yardstick: none (SQ8: the unpack of the words is more than one "
                   "computation)" if lib is None else
                   f"library yardstick (index_select, bmm, affine) {lib:.4f} ms"))

        for b in (16, 64):
            time_probe(f"f32 b={b}", ivf, sift_q[:b])

        # close + reopen: the recipe restores the index with no k-means run
        ids_before = [[h.id for h in row] for row in i64]
        db.close()
        db = Database.open(tmp, device=DEVICE)
        col = db.get_collection("sift1m")
        col.index_kind = "ivf"
        km_calls = []
        km = ivf_mod.kmeans
        ivf_mod.kmeans = lambda *a, **kw: km_calls.append(1) or km(*a, **kw)
        try:
            t0 = time.perf_counter()
            re64 = col.search_batch(sift_q[:64], k=K, ef=128)
            say(f"sift1m-ivf reopen: first search with the reassembly and calibration "
                f"{time.perf_counter() - t0:.2f} s")
        finally:
            ivf_mod.kmeans = km
        check(not km_calls, "sift1m-ivf reopen ran k-means")
        check([[h.id for h in row] for row in re64] == ids_before,
              "reopened sift1m-ivf returned other ids")
        print("sift1m-ivf close + reopen: restored from ivf.npz with no k-means run; same ids "
              "for all 64 queries", flush=True)
        # rows upserted after the build: found through the exact delta
        new = sift_q[1000:1000 + IVF_UPSERTS] + 0.01
        col.upsert_bulk(range(SIFT_N, SIFT_N + IVF_UPSERTS), new,
                        [{"cat": 8}] * IVF_UPSERTS)
        with MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
            found = col.search_batch(new[:64], k=K, ef=128)
            run.launched("search_batch b=64 ef=128 after the upserts")
            u16 = [col.search_batch(sift_q[i:i + 16], k=K, ef=128) for i in range(0, 256, 16)]
            run.launched("search_batch b=16 ef=128 after the upserts (x16)")
        launches["ivf_probe"] += run.launches()
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(ik.ivf_probe_ref, probe_desc))
        check(not col.ivf.dirty, "sift1m-ivf upserts marked the index dirty")
        check([row[0].id for row in found] == list(range(SIFT_N, SIFT_N + 64)),
              "sift1m-ivf upserted rows not found through the delta")
        ru16 = ids_recall([r for rows in u16 for r in rows], sift_oi[:256])
        check(ru16 >= 0.95, f"sift1m-ivf recall@10 b=16 after the upserts = {ru16:.4f} < 0.95")
        print(f"sift1m-ivf: {IVF_UPSERTS} rows upserted after the build found through the "
              f"delta ({len(col._stale['ivf'])} stale slots), no rebuild; unfiltered searches "
              f"stay on #10 with the stale slots dead; recall@10 b=16 ef=128 {ru16:.4f} "
              f"(against the oracle before the upserts)", flush=True)
        report_qps(torch, "sift1m-ivf ef=128 after the upserts search_batch",
                   lambda b: col.search_batch(b, k=K, ef=128), sift_q, 16)
        db.delete_collection("sift1m")
        torch.cuda.empty_cache()

        phase("5e. sift1m-sq8-ivf")
        colq = db.get_collection("sift1m_sq8")
        colq.refresh_device()
        colq.index_kind = "ivf"
        prof = {}
        t0 = time.perf_counter()
        colq._ensure_ivf(profile=prof)
        ivq = colq.ivf
        say(f"sift1m-sq8-ivf build {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in prof.items()))
        check(ivq.storage == "sq8" and ivq._parts.dtype == torch.int32, "sift1m-sq8-ivf: not SQ8")
        say(f"sift1m-sq8-ivf index: {ivq.c_real} partitions ({ivq.c} padded), L "
            f"{ivq.part_len}, words {ivq._parts.numel() * 4 / 2**30:.3f} GiB")
        for b in (1, 16, 64):
            args = probe_case(ivq, sift_q[:b], np128)
            out = ik.ivf_probe_scores(*args)
            torch.cuda.synchronize()
            errs["ivf_probe"] = max(errs["ivf_probe"], hold(
                f"ivf_probe sq8 B {b}, nprobe {np128}, L {ivq.part_len}, D_pad 128 "
                f"(sift1m-sq8-ivf)", out, ik.ivf_probe_ref(*args)))
        del out, args
        with MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
            t0 = time.perf_counter()
            v16 = colq.search_batch(sift_q[256:272], k=K, ef=128)
            say(f"sift1m-sq8-ivf first search_batch b=16 with the storage gate: "
                f"{time.perf_counter() - t0:.2f} s (oversample {colq._rerank_oversample}, "
                f"calibrated recall {colq.info()['storage_recall']})")
            run.launched("search_batch b=16 ef=128 (auto-rerank)")
            v64 = colq.search_batch(sift_q[:64], k=K, ef=128)
            run.launched("search_batch b=64 ef=128 (auto-rerank)")
            v1 = colq.search(sift_q[300], k=K)
            run.launched("search")
        launches["ivf_probe"] += run.launches()
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(ik.ivf_probe_ref, probe_desc))
        vf = colq.search_batch(sift_q[:256], k=K, ef=128, filter=filt)
        bad = [h.id for row in vf for h in row if h.id % 8 != 3 or h.payload != {"cat": 3}]
        check(not bad, f"sift1m-sq8-ivf filtered search returned filtered-out ids {bad[:5]}")
        q16, q64 = ids_recall(v16, sift_oi[256:272]), ids_recall(v64, sift_oi[:64])
        print(f"sift1m-sq8-ivf recall@10 vs float64 oracle after auto-rerank (oversample "
              f"{colq._rerank_oversample}, ef 128): b=16 {q16:.4f}, b=64 {q64:.4f}, search "
              f"{ids_recall([v1], sift_oi[300:301]):.4f}, filtered b=256 "
              f"{ids_recall(vf, of_i):.4f}", flush=True)
        check(q64 >= 0.90, f"sift1m-sq8-ivf recall@10 b=64 = {q64:.4f} < 0.90")
        ids_before = [[h.id for h in row] for row in v64]
        m_ivq = int(round(colq._rerank_oversample * K))
        measure(torch, "sift1m-sq8-ivf ef=128",
                lambda b: colq.search_batch(b, k=K, ef=128),
                f"sift1m-sq8-ivf device path ef=128 (m={m_ivq}, no rerank)",
                lambda b: colq._search_device(b, m_ivq, None, ef=128)[1].cpu(), sift_q, (16, 64))
        for b in (16, 64):
            time_probe(f"sq8 b={b}", ivq, sift_q[:b])
        db.close()
        db = Database.open(tmp, device=DEVICE)
        colq = db.get_collection("sift1m_sq8")
        colq.index_kind = "ivf"
        reopened = colq.search_batch(sift_q[:64], k=K, ef=128)
        check([[h.id for h in row] for row in reopened] == ids_before,
              "reopened sift1m-sq8-ivf returned other ids")
        print("sift1m-sq8-ivf close + reopen: same ids for all 64 queries", flush=True)
        ms, plain, impl_ms, b_ms, b_by, bytes_, ops, lib = ivf_ms["f32 b=16"]
        kernel_row("ivf_probe", "ivf_probe.cu", "velesdb_tpu/ops/ivf_kernel.py:82", ms, plain,
                   ops / PEAK_F32 * 1e3, bytes_, errs["ivf_probe"], library_ms=lib)
        db.delete_collection("sift1m_sq8")
        torch.cuda.empty_cache()

        # -- 5f. slice 4: hard1m-ivf, IVF recall near the balanced bar ---------
        phase("5f. hard1m-ivf")
        hard_all = make_clustered(np.random.default_rng(43), SIFT_N + 256, SIFT_D,
                                  n_clusters=HARD_BLOBS)
        hard, hard_q = hard_all[:SIFT_N], hard_all[SIFT_N:]
        t0 = time.perf_counter()
        colx = db.create_collection("hard1m", SIFT_D, metric="euclidean")
        colx.upsert_bulk(range(SIFT_N), hard)
        colx.refresh_device()
        colx.index_kind = "ivf"
        prof = {}
        colx._ensure_ivf(profile=prof)
        ivx = colx.ivf
        say(f"hard1m-ivf ingest, refresh and build {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in prof.items()))
        hard64 = torch.from_numpy(hard).to(dev).double()
        _, hard_oi = oracle_topk(torch, hard64, hard_q, "euclidean", K)
        del hard64
        calx = {e: colx.planner.engine_recall("ivf", e) for e in (16, 32, 64, 128, 256)}
        rx, pinned = {}, {}
        with MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
            for ef in (256, 64, 128):  # ef 128 last: the planner's EMA ends on it
                got = [r for i in range(0, 256, 16)
                       for r in colx.search_batch(hard_q[i:i + 16], k=K, ef=ef)]
                run.launched(f"pinned search_batch b=16 ef={ef} (x16)")
                rx[ef] = ids_recall(got, hard_oi)
                pinned[ef] = [[h.id for h in row] for row in got]
        launches["ivf_probe"] += run.launches()
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(ik.ivf_probe_ref, probe_desc))
        print(f"hard1m-ivf ({HARD_BLOBS} clusters, {ivx._kmeans_c} k-means clusters, "
              f"{ivx.c_real} partitions, L {ivx.part_len}, spill {ivx.spill}): recall@10 at b=16 "
              "vs the float64 oracle over 256 queries, calibrated (128 perturbed stored rows, "
              "eps-recall) beside it: " + ", ".join(
                  f"ef {e} (nprobe {ivx.nprobe_for(e)}) {rx[e]:.4f} / {calx[e]:.4f}"
                  for e in (64, 128, 256)) + "; calibrated ef 16 "
              f"{calx[16]:.4f}, ef 32 {calx[32]:.4f}", flush=True)
        check(rx[128] >= 0.95, f"hard1m-ivf recall@10 b=16 ef=128 = {rx[128]:.4f} < 0.95")
        # Unpinned, the planner picks IVF for b=16 while IVF's latency EMA
        # (fed by the pinned runs) beats exact's cost; the honesty gate holds
        # IVF to each profile's bar at its ef, and the downshift serves the
        # smallest calibrated ef that clears it. Before every call the plan
        # is checked against that rule on the calibration and the planner's
        # costs of the moment, and the call must launch #10 exactly when the
        # plan is IVF, and then return the pinned run's ids at the served ef.
        # Exact's timed calls feed its own EMA, so each case starts from the
        # EMAs the pinned runs left, where IVF is cheaper.
        colx.index_kind = "auto"
        # The pinned runs leave IVF's latency EMA (host clock, hydrate
        # included). The host sets it: on H100 machines it read 1.55-2.47 ms
        # for this code and for the one-block-per-probe #10 alike, measured
        # side by side (velesdb_tpu_torch/tools/ivf_timing.py), and
        # 4.58-5.22 ms on slower hosts, where unchanged exact cells ran as
        # much slower (PERF.md, Findings). Above exact's static cost no call
        # would reach the gate or the downshift, so each case starts with
        # IVF's EMA capped at half of that cost.
        exact_cost = colx.planner.cost_exact(SIFT_N, SIFT_D, 16)
        ema0 = {key: min(v, 0.5 * exact_cost) if key[0] == "ivf" else v
                for key, v in colx.planner._ema.items()}
        print("hard1m-ivf latency EMAs the pinned runs left (ms a batch): " + ", ".join(
            f"{key} {v / 1e6:.4f}" for key, v in colx.planner._ema.items())
              + f"; exact's static cost at b=16 {exact_cost / 1e6:.4f} ms", flush=True)
        for quality, ef in (("balanced", None), ("accurate", None), ("balanced", 64),
                            ("fast", None)):
            prof_q = SearchQuality.parse(quality)
            ask = ef or prof_q.ef
            bar = prof_q.min_recall
            gate = calx[ask] >= bar
            colx.planner._ema.clear()
            colx.planner._ema.update(ema0)
            got, served = [], []
            for i in range(0, 256, 16):
                cheaper = colx.planner.choose(
                    SIFT_N, SIFT_D, 16, have_ivf=True, ivf_nprobe=ivx.nprobe_for(ask),
                    ivf_part_len=ivx.part_len).engine == "ivf"
                want = (("ivf", ask if ef else expected_ef(calx, ask, bar)) if cheaper and gate
                        else ("exact", None))
                engine, _, served_ef, _ = colx._plan_search(hard_q[i:i + 16], K, None, ef, quality)
                plan = (engine, served_ef if engine == "ivf" else None)
                check(plan == want, f"hard1m-ivf {quality} ef {ask}: plan {plan}, the "
                      f"calibration and costs ask for {want}")
                if i == 0:
                    check(cheaper, f"hard1m-ivf {quality} ef {ask}: exact cheaper on the first "
                          "call, so the gate and the downshift were not tested")
                if ef == 64:
                    check(not gate, "hard1m-ivf: the honesty gate was not tested (calibrated "
                          f"recall at ef 64 {calx[64]:.4f} clears 0.95)")
                before = ik.LAUNCHES["ivf_probe"]
                res = colx.search_batch(hard_q[i:i + 16], k=K, ef=ef, quality=quality)
                got += res
                on_ivf = ik.LAUNCHES["ivf_probe"] > before
                check(on_ivf == (engine == "ivf"),
                      f"hard1m-ivf {quality} ef {ask}: {engine} plan, #10 launched {on_ivf}")
                if engine == "ivf" and served_ef in pinned:
                    check([[h.id for h in row] for row in res] == pinned[served_ef][i:i + 16],
                          f"hard1m-ivf {quality}: ids differ from the pinned run at ef {served_ef}")
                served.append(f"ivf at ef {served_ef}" if engine == "ivf"
                              else "exact (gate)" if cheaper else "exact (cost)")
            r = ids_recall(got, hard_oi)
            tally = ", ".join(f"{served.count(x)} {x}" for x in dict.fromkeys(served))
            print(f"hard1m-ivf auto, {quality} (bar {bar}) ef {ask}: calibrated recall "
                  f"{calx[ask]:.4f}; 16 calls of b=16 served: {tally}; recall@10 over 256 "
                  f"queries {r:.4f}" + ("" if r >= bar else " UNDER THE BAR: the calibration "
                                        "(perturbed stored rows) overstates recall here"),
                  flush=True)
            if all(x.startswith("exact") for x in served):
                check(r >= bar, f"hard1m-ivf {quality} ef {ask}: exact recall@10 {r:.4f} under "
                      f"{bar}")
        colx.index_kind = "ivf"
        report_qps(torch, "hard1m-ivf ef=128 search_batch",
                   lambda b: colx.search_batch(b, k=K, ef=128), hard_q, 16)
        db.delete_collection("hard1m")
        del hard_all, hard, hard_q
        torch.cuda.empty_cache()

        # -- 5c. slice 3: sift1m-bf16 (bucket-f32, #2) --------------------------
        phase("5c. sift1m-bf16")
        t0 = time.perf_counter()
        colh = db.create_collection("sift1m_bf16", SIFT_D, metric="euclidean",
                                    storage_mode="bf16")
        colh.upsert_bulk(range(SIFT_N), sift, payloads)
        say(f"sift1m-bf16 ingest with payloads: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        colh.refresh_device()
        torch.cuda.synchronize()
        say(f"sift1m-bf16 device refresh (upload + bf16 cast + penalty): "
            f"{time.perf_counter() - t0:.2f} s")
        check(colh.info()["serve_engine"] == "bucket-f32",
              f"serve_engine {colh.info()['serve_engine']!r}, expected 'bucket-f32'")
        idx = colh._brute
        n = idx.n_pad
        pen = idx._bucket_pen
        q2 = 2.0 * torch.from_numpy(sift_q[:256]).to(dev)  # euclidean: the wrapper's 2q
        sift_rows = F.pad(torch.from_numpy(sift).to(dev), (0, 0, 0, n - SIFT_N))
        ops2 = 2 * 256 * n * 128 + 256 * n

        def padded(b, dt):
            return F.pad(q2[:b], (0, 0, 0, (-b) % 8)).to(dt).contiguous()

        for dname, rows in (("bf16", idx._full), ("f16", sift_rows.half())):
            for b in (1, 16, 256):
                qb = padded(b, rows.dtype)
                out = bk.dense_bucket_gm(qb, rows, pen, CHUNK)
                torch.cuda.synchronize()
                errs["dense_bucket_tc"] = max(errs["dense_bucket_tc"], hold_tc(
                    f"dense_bucket_tc B {b} (B_pad {qb.shape[0]}), N {n}, D_pad 128, "
                    f"chunk {CHUNK}, {dname}", qb, rows, pen, CHUNK, out))
            for b in (256, 16):
                qb = padded(b, rows.dtype)
                ms = time_kernel(torch, lambda: bk.dense_bucket_gm(qb, rows, pen, CHUNK))
                old_ms = FIRST_DENSE_MS[b]
                lib = time_kernel(torch, lambda: bucket_max(mm_f32(torch, qb, rows.T) - pen, CHUNK))
                bytes_b = 2 * b * 128 + 2 * n * 128 + 4 * n + 8 * qb.shape[0] * n // CHUNK * 128
                ops_b = 2 * qb.shape[0] * n * 128 + qb.shape[0] * n
                b_ms = bound(ops_b / PEAK_TC16 * 1e3, bytes_b)[0]
                if b == 256 and dname == "bf16":
                    plain = time_kernel(torch, lambda: bk.dense_bucket_ref(qb, rows, pen, CHUNK),
                                        iters=3)
                    kernel_row(
                        "dense_bucket_tc", "dense_bucket_tc.cu",
                        "velesdb_tpu/ops/bucket_kernel.py:152", ms, plain, ops2 / PEAK_TC16 * 1e3,
                        bytes_b, errs["dense_bucket_tc"], library_ms=lib,
                    )
                say(f"dense_bucket_tc on {dname} rows, B_pad {qb.shape[0]}, N {n}, D_pad 128: "
                    f"kernel {ms:.4f} ms ({b_ms / ms:.4f} of its bound {b_ms:.4f} ms); #2's "
                    f"f32-core design on bf16 rows {old_ms:.4f} ms (recorded, {old_ms / ms:.2f}x); "
                    f"library yardstick {lib:.4f} ms ({lib / ms:.2f}x: {MM_F32['how']}, - cc, "
                    f"bucket amax)")
                check(ms < old_ms and ms < lib,
                      f"dense_bucket_tc {dname} B_pad {qb.shape[0]}: {ms:.4f} ms, not faster than "
                      f"#2's f32-core design ({old_ms:.4f}) and the library ({lib:.4f})")
        # #2 on the f32 SIFT rows at the slice shape, within f32_scan_tolerance
        for b in (1, 16, 256):
            qb = padded(b, torch.float32)
            out = bk.dense_bucket_gm(qb, sift_rows, pen, CHUNK)
            torch.cuda.synchronize()
            errs["dense_bucket"] = max(errs["dense_bucket"], hold_f32(
                f"dense_bucket B {b} (B_pad {qb.shape[0]}), N {n}, D_pad 128, chunk {CHUNK}, f32",
                qb, sift_rows, pen, CHUNK, out))
            if b == 16:
                ms16 = time_kernel(torch, lambda: bk.dense_bucket_gm(qb, sift_rows, pen, CHUNK))
        ms = time_kernel(torch, lambda: bk.dense_bucket_gm(qb, sift_rows, pen, CHUNK))
        plain = time_kernel(torch, lambda: bk.dense_bucket_ref(qb, sift_rows, pen, CHUNK), iters=3)
        lib = time_kernel(torch, lambda: bucket_max(qb @ sift_rows.T - pen, CHUNK))
        check_faster("dense_bucket (f32 rows)", ms, n, FIRST_F32_DENSE_MS, lib, ms16, lambda b: (
            4 * b * 128 + 4 * n * 128 + 4 * n + 8 * b * n // CHUNK * 128))
        kernel_row(
            "dense_bucket", "dense_bucket_tc.cu", "velesdb_tpu/ops/bucket_kernel.py:152", ms, plain,
            (6 * 256 * n * 128 + 256 * n) / PEAK_TC16 * 1e3,
            4 * 256 * 128 + 4 * n * 128 + 4 * n + 8 * 256 * n // CHUNK * 128,
            errs["dense_bucket"], other=(F32_CORES, ops2, PEAK_F32), library_ms=lib,
        )
        say("dense_bucket (f32 rows) library yardstick: fp32 q @ rows.T (TF32 off), - cc, the "
            "bucket amax")
        # #3 at the slice shape on the SIFT rows' (hi, lo) split
        hi, lo = bk.split_f32_rows(sift_rows)
        for b in (1, 16, 256):
            qb = F.pad(q2[:b], (0, 0, 0, (-b) % 8))
            args = (*bk.split_f32_rows(qb), hi, lo, pen, CHUNK)
            out = bk.hl_bucket_gm(*args)
            torch.cuda.synchronize()
            errs["hl_bucket"] = max(errs["hl_bucket"], hold_hl(
                f"hl_bucket B {b} (B_pad {qb.shape[0]}), N {n}, D_pad 128, chunk {CHUNK}",
                *args, out))
            if b == 16:
                ms16 = time_kernel(torch, lambda: bk.hl_bucket_gm(*args))
        ms = time_kernel(torch, lambda: bk.hl_bucket_gm(*args))
        plain = time_kernel(torch, lambda: bk.hl_bucket_ref(*args), iters=3)
        qhi, qlo = args[0], args[1]
        lib = time_kernel(torch, lambda: bucket_max(
            mm_f32(torch, qhi, hi.T) + (mm_f32(torch, qhi, lo.T) + mm_f32(torch, qlo, hi.T)) - pen,
            CHUNK))
        ops3 = 6 * 256 * n * 128 + 2 * 256 * n
        kernel_row(
            "hl_bucket", "dense_bucket_tc.cu", "velesdb_tpu/ops/bucket_kernel.py:279", ms, plain,
            ops3 / PEAK_TC16 * 1e3,
            4 * 256 * 128 + 4 * n * 128 + 4 * n + 8 * 256 * n // CHUNK * 128,
            errs["hl_bucket"], other=(F32_CORES, ops3, PEAK_F32), library_ms=lib,
        )
        bytes16 = 4 * 16 * 128 + 4 * n * 128 + 4 * n + 8 * 16 * n // CHUNK * 128
        say(f"hl_bucket library yardstick: three bf16 {MM_F32['how']} (hi.hi + (hi.lo + lo.hi)), "
            f"- cc, the bucket amax; the first (fp32-core) design {FIRST_HL_MS:.4f} ms (recorded, "
            f"{FIRST_HL_MS / ms:.2f}x); B_pad 16: {ms16:.4f} ms, bound "
            f"{bound(6 * 16 * n * 128 / PEAK_TC16 * 1e3, bytes16)[0]:.4f} ms")
        check(ms < FIRST_HL_MS and ms < lib,
              f"hl_bucket B_pad 256: {ms:.4f} ms, not faster than the first design "
              f"({FIRST_HL_MS:.4f}) and the library ({lib:.4f})")
        del out, args, qb, hi, lo, rows, qhi, qlo
        torch.cuda.empty_cache()
        with MainPath(counters, bk, "dense_bucket_gm", "dense_bucket_tc") as run:
            h256 = colh.search_batch(sift_q[:256], k=K)
            run.launched("search_batch b=256")
            h16 = colh.search_batch(sift_q[256:272], k=K)
            run.launched("search_batch b=16")
            h1 = colh.search(sift_q[300], k=K)
            run.launched("search")
            hf = colh.search_batch(sift_q[:256], k=K, filter=filt)
            run.launched("filtered search_batch")
        launches["dense_bucket_tc"] = run.launches()
        errs["dense_bucket_tc"] = max(errs["dense_bucket_tc"], run.hold_all(
            None, lambda q, rows, cc, ch: (f"dense_bucket_tc B_pad {q.shape[0]}, "
                                           f"N {rows.shape[0]}, D_pad {rows.shape[1]}, "
                                           f"chunk {ch}, {rows.dtype}"), holder=hold_tc))
        tolerance_summary("dense_bucket_tc", "|err| <= 2 D_pad 2^-24 A + 2 ulp(gm_ref) (A: the "
                          "winner's sum of |q_d c_d|)")
        # the function the kernel computes: bf16(2q) . bf16(c) - |c|^2 (f32 rows)
        rows64 = idx._full[:SIFT_N].double()
        pen64 = torch.from_numpy(sift).to(dev).double().pow(2).sum(1)
        qb64 = (2.0 * torch.from_numpy(sift_q[:301]).to(dev)).to(torch.bfloat16).double()
        sf_i = oracle_ids(torch, rows64, qb64, K, pen64=pen64)
        sff_i = oracle_ids(torch, rows64, qb64[:256], K, pen64=pen64, mask=cat_mask)
        del rows64, pen64, qb64
        rec = {
            "b=256": (ids_recall(h256, sf_i[:256]), ids_recall(h256, sift_oi[:256])),
            "b=16": (ids_recall(h16, sf_i[256:272]), ids_recall(h16, sift_oi[256:272])),
            "search": (ids_recall([h1], sf_i[300:301]), ids_recall([h1], sift_oi[300:301])),
            "filtered b=256": (ids_recall(hf, sff_i), ids_recall(hf, of_i)),
        }
        print("sift1m-bf16 recall@10 vs the float64 oracle of the function the kernel computes "
              "(vs the f32 data's oracle): " + ", ".join(
                  f"{name} {a:.4f} ({b:.4f})" for name, (a, b) in rec.items()), flush=True)
        for name in ("b=256", "b=16"):
            check(rec[name][0] >= 0.99, f"sift1m-bf16 recall@10 {name} = {rec[name][0]:.4f}")
        check(rec["search"][0] >= 0.9 and rec["filtered b=256"][0] >= 0.9,
              "sift1m-bf16 single-query or filtered recall@10 under 0.9")
        bad = [h.id for row in hf for h in row if h.id % 8 != 3 or h.payload != {"cat": 3}]
        check(not bad, f"sift1m-bf16 filtered search returned filtered-out ids {bad[:5]}")
        ids_before = [[h.id for h in row] for row in h256]
        db.close()
        db = Database.open(tmp, device=DEVICE)
        colh = db.get_collection("sift1m_bf16")
        reopened = colh.search_batch(sift_q[:256], k=K)
        check(colh.info()["serve_engine"] == "bucket-f32" and colh.storage_mode.value == "bf16",
              "bf16 bucket-f32 lost on reopen")
        check(all(set(a) == set(h.id for h in b) for a, b in zip(ids_before, reopened)),
              "reopened sift1m-bf16 returned other ids")
        print("sift1m-bf16 close + reopen: same ids for all 256 queries", flush=True)
        measure(torch, "sift1m-bf16", lambda b: colh.search_batch(b, k=K),
                "sift1m-bf16 device path (no hydrate)", device_only(colh, K), sift_q)
        db.delete_collection("sift1m_bf16")

        # #2 on f32 rows: the public op bucket_topk on the SIFT rows (padded
        # rows knocked out by the penalty), every launch within its tolerance
        qt = torch.from_numpy(sift_q[:301]).to(dev)
        with MainPath(counters, bk, "dense_bucket_gm", "dense_bucket_gm") as run:
            _, b256 = bk.bucket_topk(qt[:256], sift_rows, pen, k=K, metric="euclidean",
                                     chunk=CHUNK)
            run.launched("bucket_topk b=256 (f32 rows)")
            _, b16 = bk.bucket_topk(qt[256:272], sift_rows, pen, k=K, metric="euclidean",
                                    chunk=CHUNK)
            run.launched("bucket_topk b=16 (f32 rows)")
            _, b1 = bk.bucket_topk(qt[300:301], sift_rows, pen, k=K, metric="euclidean",
                                   chunk=CHUNK)
            run.launched("bucket_topk b=1 (f32 rows)")
        launches["dense_bucket"] = launches.get("dense_bucket", 0) + run.launches()
        errs["dense_bucket"] = max(errs["dense_bucket"], run.hold_all(
            None,
            lambda q, rows, cc, ch: (f"dense_bucket B_pad {q.shape[0]}, N {rows.shape[0]}, "
                                     f"D_pad {rows.shape[1]}, chunk {ch}, {rows.dtype}"),
            holder=hold_f32))
        tolerance_summary("dense_bucket", "f32_scan_tolerance (|err| <= (3.1 2^-16 + 8 (2 "
                          "sqrt(3 D_pad) + sqrt(2 D_pad)) 2^-24) A + 2 ulp, A the winner's sum "
                          "of |q_d c_d|)")
        got = torch.cat([b256, b16, b1]).cpu().numpy()
        want = np.concatenate([sift_oi[:256], sift_oi[256:272], sift_oi[300:301]])
        r2 = np.mean([len(set(a) & set(b)) / K for a, b in zip(got, want)])
        print(f"bucket_topk on the f32 SIFT rows (#2): recall@10 {r2:.4f} vs the float64 oracle "
              f"over 273 queries", flush=True)
        check(r2 >= 0.99, f"bucket_topk f32 recall@10 = {r2:.4f} < 0.99")
        del sift_all, sift, payloads, sift_rows, pen, qt
        torch.cuda.empty_cache()

        # -- 6. slice 2: glove100-binary -----------------------------------
        phase("6. glove100-binary")
        glove_all = make_clustered(np.random.default_rng(100), GLOVE_N + HELD_OUT, GLOVE_D)
        glove, glove_q = glove_all[:GLOVE_N], glove_all[GLOVE_N:]
        t0 = time.perf_counter()
        colb = db.create_collection("glove", GLOVE_D, metric="cosine", storage_mode="binary")
        colb.upsert_bulk(range(GLOVE_N), glove)
        colb.refresh_device()
        torch.cuda.synchronize()
        say(f"glove100-binary ingest + refresh (pack + bit shadow): "
            f"{time.perf_counter() - t0:.2f} s")
        idx = colb._brute
        check(idx.n_pad == pad_rows(GLOVE_N), f"glove N_pad {idx.n_pad}")
        check(colb.info()["serve_engine"] == "hamming-mxu",
              f"serve_engine {colb.info()['serve_engine']!r}, expected 'hamming-mxu'")
        gq = torch.from_numpy(glove_q).to(dev)
        for b in (1, 16, 256):
            qb = torch.nn.functional.pad((gq[:b] >= 0).to(torch.int8),
                                         (0, idx._ham_bits.shape[1] - GLOVE_D))
            qi2 = torch.nn.functional.pad(2 * qb, (0, 0, 0, (-b) % 8))
            out = bk.hamming_mxu_gm(qi2, idx._ham_bits, idx._ham_aux, CHUNK)
            torch.cuda.synchronize()
            errs["hamming_mxu_bucket"] = max(errs["hamming_mxu_bucket"], hold(
                f"hamming_mxu_bucket B {b} (B_pad {qi2.shape[0]}), N {idx.n_pad}, D_pad 128, "
                f"chunk {CHUNK}", out, bk.hamming_mxu_ref(qi2, idx._ham_bits, idx._ham_aux, CHUNK)))
            if b == 16:
                ms16 = time_kernel(torch, lambda: bk.hamming_mxu_gm(qi2, idx._ham_bits,
                                                                    idx._ham_aux, CHUNK))
        n = idx.n_pad
        ms = time_kernel(torch, lambda: bk.hamming_mxu_gm(qi2, idx._ham_bits, idx._ham_aux, CHUNK))
        plain = time_kernel(torch, lambda: bk.hamming_mxu_ref(qi2, idx._ham_bits, idx._ham_aux,
                                                              CHUNK), iters=5)
        lib = time_kernel(torch, lambda: bucket_max(
            torch._int_mm(qi2, idx._ham_bits.T) - idx._ham_aux, CHUNK))
        kernel_row(
            "hamming_mxu_bucket", "sq8i_bucket.cu",
            "velesdb_tpu/ops/bucket_kernel.py:494", ms, plain, int8_ops_ms(256, n, 128, 1),
            256 * 128 + n * 128 + 4 * n + 8 * 256 * n // CHUNK * 128,
            errs["hamming_mxu_bucket"], library_ms=lib,
            other=(DP4A_FIRST, 256 * n * 128 / 4, dp4a_rate),
        )
        say("hamming_mxu_bucket library yardstick: torch._int_mm(2 qbits, bits.T) - aux, then "
            "the bucket amax")
        check_int8("hamming_mxu_bucket", ms, n, lib, ms16, 1, lambda b: (
            b * 128 + n * 128 + 4 * n + 8 * b * n // CHUNK * 128))
        # packed scan (#4) at its slice shape on the same packed corpus
        qp = binary_quantize(gq[:256])
        pen0 = torch.where(idx._valid, 0.0, torch.inf)
        for b in (1, 16, 256):
            qpb = torch.nn.functional.pad(qp[:b], (0, 0, 0, (-b) % 8))
            out = bk.hamming_bucket_gm(qpb, idx._packed, pen0, bk.HAMMING_CHUNK)
            torch.cuda.synchronize()
            errs["hamming_bucket"] = max(errs["hamming_bucket"], hold(
                f"hamming_bucket B {b} (B_pad {qpb.shape[0]}), N {n}, W 4, "
                f"chunk {bk.HAMMING_CHUNK}", out,
                bk.hamming_bucket_ref(qpb, idx._packed, pen0, bk.HAMMING_CHUNK)))
        ms = time_kernel(torch, lambda: bk.hamming_bucket_gm(qpb, idx._packed, pen0,
                                                             bk.HAMMING_CHUNK))
        plain = time_kernel(torch, lambda: bk.hamming_bucket_ref(qpb, idx._packed, pen0,
                                                                 bk.HAMMING_CHUNK), iters=3)
        w = idx._packed.shape[1]
        # the same distances from the unpacked 0/1 bytes (set-up, not timed):
        # popc(q ^ c) = |q| + |c| - 2 q.c
        qsum = (qi2 // 2).to(torch.int32).sum(1)
        csum = idx._ham_bits.to(torch.int32).sum(1)
        lib = time_kernel(torch, lambda: bucket_max(
            -(qsum[:, None] + csum - torch._int_mm(qi2, idx._ham_bits.T)).float() - pen0,
            bk.HAMMING_CHUNK))
        kernel_row(
            "hamming_bucket", "hamming_bucket.cu", "velesdb_tpu/ops/bucket_kernel.py:362",
            ms, plain, 256 * n * w / popc_rate * 1e3,
            4 * 256 * w + 4 * n * w + 4 * n + 8 * 256 * n // bk.HAMMING_CHUNK * 128,
            errs["hamming_bucket"], ("popc", 256 * n * w, popc_rate), library_ms=lib,
        )
        say("hamming_bucket library yardstick: |q| + |c| - torch._int_mm(2 qbits, bits.T) on the "
            "unpacked 0/1 bytes, the penalty, then the bucket amax")
        del csum
        del out, qi2, qpb

        def hamming_profile(label, queries, device_ids, device_vals):
            """The raw coarse pass against an exact popcount oracle on the card."""
            qpk = binary_quantize(torch.from_numpy(queries).to(dev))
            exact = bk.hamming_distances(qpk, idx._packed)
            exact = torch.where(idx._valid[None, :], exact, 1 << 20)
            ids = device_ids.to(dev)
            dist = torch.round((1.0 - device_vals.to(dev)) * GLOVE_D).to(torch.int32)
            check(bool((ids >= 0).all()), f"{label}: empty results")
            check(torch.equal(torch.gather(exact, 1, ids), dist),
                  f"{label}: returned distances differ from the exact ones")
            best = torch.topk(exact, K, dim=1, largest=False).values
            agree = float((torch.sort(dist, dim=1).values == best).float().mean())
            check(agree >= 0.99, f"{label}: distance profile agrees on {agree:.4f} < 0.99")
            print(f"{label}: returned distances exact; distance profile agrees with the "
                  f"exact oracle on {agree:.4f} of positions", flush=True)

        with MainPath(counters, bk, "hamming_mxu_gm", "hamming_mxu_gm") as run:
            t0 = time.perf_counter()
            g256 = colb.search_batch(glove_q[:256], k=K)
            say(f"glove100-binary first search_batch b=256 with the storage gate: "
                f"{time.perf_counter() - t0:.2f} s (oversample {colb._rerank_oversample}, "
                f"calibrated recall {colb.info()['storage_recall']})")
            run.launched("search_batch b=256")
            colb.search_batch(glove_q[256:272], k=K)
            run.launched("search_batch b=16")
            colb.search(glove_q[300], k=K)
            run.launched("search")
            gv, gi = colb._search_device(glove_q[:256], K, None)
            run.launched("raw device pass b=256")
        launches["hamming_mxu_bucket"] = run.launches()
        errs["hamming_mxu_bucket"] = max(errs["hamming_mxu_bucket"], run.hold_all(
            bk.hamming_mxu_ref,
            lambda qi, bits, aux, ch: (f"hamming_mxu_bucket B_pad {qi.shape[0]}, "
                                       f"N {bits.shape[0]}, D_pad {bits.shape[1]}, chunk {ch}")))
        hamming_profile("glove100-binary hamming-mxu raw b=256", glove_q[:256], gi, gv)
        g64 = torch.from_numpy(glove).to(dev).double()
        g64 = g64 / g64.norm(dim=1, keepdim=True)
        o_v, o_i = oracle_topk(torch, g64, glove_q[:256], "cosine", K)
        del g64
        rg = score_results(g256, o_v, o_i, 1e-4)
        print(f"glove100-binary recall@10 vs float64 cosine oracle after auto-rerank "
              f"(oversample {colb._rerank_oversample}): b=256 {rg:.4f} (no floor)", flush=True)
        m_bin = int(round(colb._rerank_oversample * K))
        measure(torch, "glove100-binary", lambda b: colb.search_batch(b, k=K),
                f"glove100-binary device path (m={m_bin}, no rerank)",
                device_only(colb, m_bin), glove_q)

        # the same data past the bit-shadow budget: hamming-bucket
        db.close()
        os.environ["VELESDB_HAMMING_MXU_MAX_BYTES"] = "0"
        db = Database.open(tmp, device=DEVICE)
        colh = db.get_collection("glove")
        colh.refresh_device()
        idx = colh._brute
        check(idx._ham_bits is None, "bit shadow built past its budget")
        check(colh.info()["serve_engine"] == "hamming-bucket",
              f"serve_engine {colh.info()['serve_engine']!r}, expected 'hamming-bucket'")
        with MainPath(counters, bk, "hamming_bucket_gm", "hamming_bucket_gm") as run:
            hraw = colh.search_batch(glove_q[:256], k=K, _raw=True)
            run.launched("raw search_batch b=256")
            colh.search_batch(glove_q[256:272], k=K, _raw=True)
            run.launched("raw search_batch b=16")
            hv, hi = colh._search_device(glove_q[:256], K, None)
            run.launched("raw device pass b=256")
        launches["hamming_bucket"] = run.launches()
        errs["hamming_bucket"] = max(errs["hamming_bucket"], run.hold_all(
            bk.hamming_bucket_ref,
            lambda q, packed, pen, ch: (f"hamming_bucket B_pad {q.shape[0]}, "
                                        f"N {packed.shape[0]}, W {packed.shape[1]}, chunk {ch}")))
        check(len(hraw) == 256 and all(len(r) == K for r in hraw), "hamming-bucket raw rows")
        hamming_profile("glove100-binary hamming-bucket raw b=256", glove_q[:256], hi, hv)
        measure(torch, "glove100-binary hamming-bucket raw",
                lambda b: colh.search_batch(b, k=K, _raw=True),
                "glove100-binary hamming-bucket device path", device_only(colh, K), glove_q)
        del os.environ["VELESDB_HAMMING_MXU_MAX_BYTES"]
        db.delete_collection("glove")
        del glove_all, glove, gq
        torch.cuda.empty_cache()

        # -- 7. slice 2: 100k-binary (hamming-topk) -------------------------
        phase("7. 100k-binary")
        small_all = make_clustered(np.random.default_rng(101), B100K_N + HELD_OUT, GLOVE_D)
        small, small_q = small_all[:B100K_N], small_all[B100K_N:]
        cols = db.create_collection("b100k", GLOVE_D, metric="cosine", storage_mode="binary")
        cols.upsert_bulk(range(B100K_N), small)
        cols.refresh_device()
        idx = cols._brute
        check(idx.n_pad == pad_rows(B100K_N), f"100k-binary N_pad {idx.n_pad}")
        check(cols.info()["serve_engine"] == "hamming-topk",
              f"serve_engine {cols.info()['serve_engine']!r}, expected 'hamming-topk'")
        sq_pk = binary_quantize(torch.from_numpy(small_q[:256]).to(dev))
        qs9 = {b: sq_pk[:b].contiguous() for b in (1, 16, 256)}
        for b in (1, 16, 256):
            for k9 in (K, TOPK_M):
                out = pk.hamming_topk(qs9[b], idx._packed, idx._valid, k9)
                torch.cuda.synchronize()
                errs["hamming_topk"] = max(errs["hamming_topk"], hold(
                    f"hamming_topk B {b}, N {idx.n_pad}, W 4, k {k9}", out,
                    pk.hamming_topk_ref(qs9[b], idx._packed, idx._valid, k9)))
        ms9 = {(b, k9): time_kernel(torch, lambda: pk.hamming_topk(qs9[b], idx._packed,
                                                                  idx._valid, k9))
               for b, k9 in ((256, K), (256, TOPK_M), (16, K), (1, K))}
        plain = time_kernel(torch, lambda: pk.hamming_topk_ref(sq_pk, idx._packed, idx._valid,
                                                               TOPK_M), iters=5)
        n, w = idx.n_pad, idx._packed.shape[1]
        # the same distances from the unpacked 0/1 bytes (set-up, not timed)
        bits9 = binary_unpack(idx._packed, 32 * w).to(torch.int8)
        qb9 = binary_unpack(sq_pk, 32 * w).to(torch.int8)
        c9, q9 = bits9.to(torch.int32).sum(1), qb9.to(torch.int32).sum(1)
        far = torch.where(idx._valid, 0, 1 << 20).to(torch.int32)
        lib9 = {k9: time_kernel(torch, lambda: torch.topk(
            q9[:, None] + (c9 + far) - 2 * torch._int_mm(qb9, bits9.T), k9, dim=1,
            largest=False)) for k9 in (K, TOPK_M)}
        ops9 = 256 * int(idx._valid.sum()) * w / popc_rate * 1e3  # one popcount a word
        kernel_row(
            "hamming_topk", "hamming_topk.cu", "velesdb_tpu/ops/pallas_kernels.py:317",
            ms9[256, TOPK_M], plain, ops9, 4 * 256 * w + 4 * n * w + n + 12 * 256 * TOPK_M,
            errs["hamming_topk"], ("popc", 256 * B100K_N * w, popc_rate),
            library_ms=lib9[TOPK_M],
        )
        for (b, k9), t in ms9.items():
            least, by = bound(ops9 * b / 256, 4 * b * w + 4 * n * w + n + 12 * b * k9)
            say(f"hamming_topk B {b}, N {n}, W {w}, k {k9}: kernel {t:.4f} ms; bound "
                f"{least:.4f} ms ({by}): {least / t:.4f} of it"
                + (f"; first design {FIRST_TOPK_MS[k9]:.4f} ms (recorded, "
                   f"{FIRST_TOPK_MS[k9] / t:.2f}x), library {lib9[k9]:.4f} ms "
                   f"({lib9[k9] / t:.2f}x)" if b == 256 else ""))
        say("hamming_topk library yardstick: |q| + |c| - 2 torch._int_mm(qbits, bits.T) on the "
            "unpacked 0/1 bytes, invalid rows pushed past every distance, then torch.topk")
        for k9 in (K, TOPK_M):
            check(ms9[256, k9] < FIRST_TOPK_MS[k9] and ms9[256, k9] < lib9[k9],
                  f"hamming_topk B 256, k {k9}: {ms9[256, k9]:.4f} ms, not faster than its first "
                  f"design ({FIRST_TOPK_MS[k9]:.4f}) and the library ({lib9[k9]:.4f})")
        del bits9, qb9, qs9
        with MainPath(counters, brute_mod, "hamming_topk", "hamming_topk") as run:
            s256 = cols.search_batch(small_q[:256], k=K)
            run.launched("search_batch b=256")
            cols.search_batch(small_q[256:272], k=K)
            run.launched("search_batch b=16")
            cols.search(small_q[300], k=K)
            run.launched("search")
            sv, si = cols._search_device(small_q[:256], K, None)
            run.launched("raw device pass b=256")
        launches["hamming_topk"] = run.launches()
        ks9 = sorted({kw.get("k", 10) for _, kw, _ in run.calls})
        check(TOPK_M in ks9, f"100k-binary's main path launched #9 at k {ks9}, not {TOPK_M}")
        print(f"100k-binary main path: #9 launched at k {ks9}", flush=True)
        errs["hamming_topk"] = max(errs["hamming_topk"], run.hold_all(
            lambda q, packed, valid=None, k=10: pk.hamming_topk_ref(q, packed, valid, k),
            lambda q, packed, valid=None, k=10: (f"hamming_topk B {q.shape[0]}, "
                                                 f"N {packed.shape[0]}, k {k}")))
        exact = bk.hamming_distances(sq_pk, idx._packed).float()
        exact = torch.where(idx._valid[None, :], exact, torch.inf)
        o_d, o_ids = torch.sort(exact, dim=1, stable=True)
        dist = torch.round((1.0 - sv.to(dev)) * GLOVE_D)
        check(torch.equal(si.to(dev), o_ids[:, :K]) and torch.equal(dist, o_d[:, :K]),
              "100k-binary raw pass differs from the exact Hamming oracle")
        print("100k-binary hamming-topk raw b=256: ids and distances equal the exact "
              "oracle's (stable order)", flush=True)
        s64 = torch.from_numpy(small).to(dev).double()
        s64 = s64 / s64.norm(dim=1, keepdim=True)
        o_v, o_i = oracle_topk(torch, s64, small_q[:256], "cosine", K)
        rs = score_results(s256, o_v, o_i, 1e-4)
        print(f"100k-binary recall@10 vs float64 cosine oracle after auto-rerank "
              f"(oversample {cols._rerank_oversample}): b=256 {rs:.4f} (no floor)", flush=True)
        m_small = int(round(cols._rerank_oversample * K))
        measure(torch, "100k-binary", lambda b: cols.search_batch(b, k=K),
                f"100k-binary device path (m={m_small}, no rerank)",
                device_only(cols, m_small), small_q)
        del s64, exact, o_d, o_ids

        # -- 8. slice 2: offset-full-assist (int8-assist) ------------------
        phase("8. offset-full-assist")
        off_all = make_clustered(np.random.default_rng(42), OFFSET_N + HELD_OUT, SIFT_D) + 100.0
        off, off_q = off_all[:OFFSET_N], off_all[OFFSET_N:]
        colo = db.create_collection("offset", SIFT_D, metric="euclidean")
        colo.upsert_bulk(range(OFFSET_N), off)
        colo.refresh_device()
        check(colo._brute._assist_pd is None, "sq8pd_build accepted the offset corpus")
        check(colo.info()["serve_engine"] == "int8-assist",
              f"serve_engine {colo.info()['serve_engine']!r}, expected 'int8-assist'")
        with MainPath(counters, bk, "sq8i_bucket_gm", "sq8i_bucket_gm") as run:
            a256 = colo.search_batch(off_q[:256], k=K)
            run.launched("search_batch b=256")
            a16 = colo.search_batch(off_q[256:272], k=K)
            run.launched("search_batch b=16")
        launches["sq8i_bucket"] += run.launches()
        errs["sq8i_bucket"] = max(errs["sq8i_bucket"], run.hold_all(sq8i_plain, sq8i_desc))
        o64 = torch.from_numpy(off).to(dev).double()
        o_v, o_i = oracle_topk(torch, o64, off_q[:272], "euclidean", K)
        del o64
        ra = score_results(a256, o_v[:256], o_i[:256], 1e-4)
        ra16 = score_results(a16, o_v[256:272], o_i[256:272], 1e-4)
        print(f"offset-full-assist recall@10 vs float64 oracle: b=256 {ra:.4f}, "
              f"b=16 {ra16:.4f}", flush=True)
        check(ra >= 0.99, f"offset-full-assist recall@10 b=256 = {ra:.4f} < 0.99")
        measure(torch, "offset-full-assist", lambda b: colo.search_batch(b, k=K),
                "offset-full-assist device path (no hydrate)", device_only(colo, K), off_q)
        db.close()

        # -- 8b. slice 3: offset-full-hl (split-bf16, #3) ------------------------
        phase("8b. offset-full-hl")
        brute_mod._SQ8I_MAX_DIM[0] = 128  # the reference's rule: (hi, lo) at D >= it
        try:
            db = Database.open(tmp, device=DEVICE)
            colo = db.get_collection("offset")
            t0 = time.perf_counter()
            colo.refresh_device()
            torch.cuda.synchronize()
            say(f"offset-full-hl device refresh (upload + pd refusal + hi/lo split): "
                f"{time.perf_counter() - t0:.2f} s")
            idx = colo._brute
            check(idx._assist_pd is None and idx._assist is None and idx._full_hl is not None,
                  "offset-full-hl did not build the (hi, lo) shadow alone")
            check(colo.info()["serve_engine"] == "split-bf16",
                  f"serve_engine {colo.info()['serve_engine']!r}, expected 'split-bf16'")
            with MainPath(counters, bk, "hl_bucket_gm", "hl_bucket_gm") as run:
                l256 = colo.search_batch(off_q[:256], k=K)
                run.launched("search_batch b=256")
                l16 = colo.search_batch(off_q[256:272], k=K)
                run.launched("search_batch b=16")
                l1 = colo.search(off_q[256], k=K)
                run.launched("search")
            launches["hl_bucket"] = run.launches()
            errs["hl_bucket"] = max(errs["hl_bucket"], run.hold_all(
                None,
                lambda qhi, qlo, hi, lo, cc, ch: (f"hl_bucket B_pad {qhi.shape[0]}, "
                                                  f"N {hi.shape[0]}, D_pad {hi.shape[1]}, "
                                                  f"chunk {ch}"), holder=hold_hl))
            tolerance_summary("hl_bucket", "split_scan_tolerance (|err| <= 24 sqrt(3 D_pad) "
                              "2^-24 A + 2 ulp, A the winner's sum of |qhi hi| + |qhi lo| + "
                              "|qlo hi|)")
            rl = ids_recall(l256, o_i[:256])
            rl16 = ids_recall(l16, o_i[256:272])
            rl1 = ids_recall([l1], o_i[256:257])
            # the b=256 search through #3's plain version (its sums in the
            # first design's fixed order): the tensor cores' order must lose
            # no more than 0.01 of recall where 2 q.c - |c|^2 cancels
            kernel = bk.hl_bucket_gm
            bk.hl_bucket_gm = bk.hl_bucket_ref
            try:
                rlp = ids_recall(colo.search_batch(off_q[:256], k=K), o_i[:256])
            finally:
                bk.hl_bucket_gm = kernel
            check(abs(rl - rlp) <= 0.01, f"offset-full-hl recall@10 {rl:.4f} against "
                  f"{rlp:.4f} through #3's plain version")
            # the same scan on the same data without the offset, for comparison
            base_all = make_clustered(np.random.default_rng(42), OFFSET_N + HELD_OUT, SIFT_D)
            bx = torch.from_numpy(base_all[:OFFSET_N]).to(dev)
            _, bi = bk.bucket_topk_hl(torch.from_numpy(base_all[OFFSET_N:OFFSET_N + 256]).to(dev),
                                      *bk.split_f32_rows(bx), (bx * bx).sum(1), k=K,
                                      metric="euclidean", chunk=CHUNK)
            _, ob_i = oracle_topk(torch, bx.double(), base_all[OFFSET_N:OFFSET_N + 256],
                                  "euclidean", K)
            rb = np.mean([len(set(a) & set(b)) / K for a, b in zip(bi.cpu().numpy(), ob_i)])
            # the same search through #3's plain version: what the bucket
            # geometry loses with the fixed-order sums
            kernel = bk.hl_bucket_gm
            bk.hl_bucket_gm = bk.hl_bucket_ref
            try:
                _, pi = bk.bucket_topk_hl(
                    torch.from_numpy(base_all[OFFSET_N:OFFSET_N + 256]).to(dev),
                    *bk.split_f32_rows(bx), (bx * bx).sum(1), k=K, metric="euclidean", chunk=CHUNK)
            finally:
                bk.hl_bucket_gm = kernel
            rp = np.mean([len(set(a) & set(b)) / K for a, b in zip(pi.cpu().numpy(), ob_i)])
            print(f"offset-full-hl recall@10 vs float64 oracle: b=256 {rl:.4f} (through #3's "
                  f"plain version {rlp:.4f}), b=16 {rl16:.4f}, search {rl1:.4f}; the same "
                  f"split-bf16 scan on the data without the offset: b=256 {rb:.4f} (through "
                  f"#3's plain version {rp:.4f})", flush=True)
            del bx, bi, pi, base_all
            measure(torch, "offset-full-hl", lambda b: colo.search_batch(b, k=K),
                    "offset-full-hl device path (no hydrate)", device_only(colo, K), off_q)
        finally:
            brute_mod._SQ8I_MAX_DIM[0] = 1 << 30
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- 9. slice 6: the four kernel experiments (#11-#14) ---------------------
    phase("9. experiments")
    experiments_phase(torch, counters, kernel_row, launches, errs, dp4a_rate)

    # -- 10. slice 11: sift1m-graph, the graph engine with #10 as its entry --
    phase("10. sift1m-graph")
    graph_phase(torch, dev, counters, launches, errs, sift_oi, of_i)

    # -- 11. text and hybrid search, the rest of the surface ----------------
    phase("11. hybrid")
    hybrid_phase(torch, dev, counters, launches, errs)

    say(f"peak device memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, row in record.items():
        row["launches"] = launches[name]
        row["max_abs_err"] = errs[name]
    print(f"chip_smoke wall time {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": list(record.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
