"""Recall validation: quality profiles vs brute-force ground truth.

Counterpart of the reference's accuracy CI (``tests/recall_validation.rs:1-40``
— synthetic clustered data, brute-force ground truth, recall@k thresholds per
quality profile). Covers every engine: graph ANN per profile, IVF per nprobe,
quantized modes with and without rerank.

The reference's ``tests/test_recall_validation.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made (and for the oracle,
``brute_force_topk``). The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.index.graph_index import GraphIndex
from velesdb_tpu_torch.index.ivf import IvfIndex
from velesdb_tpu_torch.index.params import GraphParams, SearchQuality
from velesdb_tpu_torch.ops import DistanceMetric, StorageMode
from velesdb_tpu_torch.ops.chunked import brute_force_topk


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clustered(rng, n, d, c=48, spread=0.7):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 2.0
    a = rng.integers(0, c, n)
    return centers[a] + spread * rng.standard_normal((n, d)).astype(np.float32)


def recall_at_10(idx_rows, gt_rows):
    hits = sum(
        len(set(idx_rows[i].tolist()) & set(gt_rows[i].tolist()))
        for i in range(len(gt_rows))
    )
    return hits / (len(gt_rows) * gt_rows.shape[1])


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(7)
    n, d = 8000, 64
    corpus = clustered(rng, n, d)
    queries = clustered(rng, 128, d)
    _, gt = brute_force_topk(queries, corpus, 10, DistanceMetric.COSINE, device="cpu")
    return corpus, queries, gt


# thresholds mirror the reference's profile guarantees (BENCHMARKS.md:97-100:
# fast 92.2% / balanced 98.8% / accurate 100%), with margin for data variance
GRAPH_PROFILES = [
    (SearchQuality.FAST, 0.85),
    (SearchQuality.BALANCED, 0.93),
    (SearchQuality.ACCURATE, 0.97),
]


@pytest.mark.parametrize("quality,threshold", GRAPH_PROFILES)
def test_graph_profile_recall(dataset, quality, threshold):
    corpus, queries, gt = dataset
    idx = GraphIndex(64, DistanceMetric.COSINE, params=GraphParams.auto(64, len(corpus)), device="cpu")
    idx.build(corpus, np.ones(len(corpus), bool))
    _, rows = idx.search(queries, 10, quality=quality)
    r = recall_at_10(np.asarray(rows), gt)
    assert r >= threshold, f"{quality}: recall {r:.3f} < {threshold}"


@pytest.mark.parametrize("nprobe,threshold", [(4, 0.75), (16, 0.92), (48, 0.98)])
def test_ivf_nprobe_recall(dataset, nprobe, threshold):
    corpus, queries, gt = dataset
    idx = IvfIndex(64, DistanceMetric.COSINE, n_clusters=64, device="cpu")
    idx.build(corpus)
    _, rows = idx.search(queries, 10, nprobe=nprobe)
    r = recall_at_10(np.asarray(rows), gt)
    assert r >= threshold, f"nprobe={nprobe}: recall {r:.3f} < {threshold}"


def test_exact_recall_is_one(dataset):
    from velesdb_tpu_torch.index.brute import BruteForceIndex

    corpus, queries, gt = dataset
    idx = BruteForceIndex(64, DistanceMetric.COSINE, StorageMode.FULL, device="cpu")
    idx.rebuild(corpus, np.ones(len(corpus), bool))
    _, rows = idx.search(queries, 10)
    assert recall_at_10(np.asarray(rows), gt) >= 0.999


def test_quantized_recall_with_rerank(tmp_db_dir):
    """SQ8 ~0.5-1% recall loss (quantization.rs:1-12); rerank recovers it.
    Binary (1 bit/dim) needs realistic dimensionality — the reference quotes
    it at 768D — so this check runs at 256D with near-corpus queries."""
    rng = np.random.default_rng(11)
    n, d = 4000, 256
    corpus = clustered(rng, n, d, c=32)
    pick = rng.integers(0, n, 64)
    queries = corpus[pick] + 0.05 * rng.standard_normal((64, d)).astype(np.float32)
    _, gt = brute_force_topk(queries, corpus, 10, DistanceMetric.COSINE, device="cpu")
    db = Database.open(tmp_db_dir, device="cpu")

    sq8 = db.create_collection("sq8", dim=d, storage_mode=StorageMode.SQ8)
    sq8.upsert_bulk(range(n), corpus)
    sq8.auto_rerank = False
    rows = np.asarray([[h.id for h in r] for r in sq8.search_batch(queries, 10)])
    assert recall_at_10(rows, gt) >= 0.95  # coarse SQ8

    rer = np.asarray(
        [
            [h.id for h in r]
            for r in sq8.search_batch_with_rerank(queries, 10, oversample=4)
        ]
    )
    assert recall_at_10(rer, gt) >= 0.99  # rerank recovers

    # auto-rerank (VERDICT r2 #6): plain search() on a quantized collection
    # engages the dual-precision pass by default — same >=0.99 bar
    sq8.auto_rerank = True
    auto = np.asarray(
        [[h.id for h in r] for r in sq8.search_batch(queries, 10)]
    )
    assert recall_at_10(auto, gt) >= 0.99

    binary = db.create_collection("bin", dim=d, storage_mode=StorageMode.BINARY)
    binary.upsert_bulk(range(n), corpus)
    binary.auto_rerank = False
    coarse = np.asarray(
        [[h.id for h in r] for r in binary.search_batch(queries, 10)]
    )
    coarse_r = recall_at_10(coarse, gt)
    rer2 = np.asarray(
        [
            [h.id for h in r]
            for r in binary.search_batch_with_rerank(queries, 10, oversample=16)
        ]
    )
    rerank_r = recall_at_10(rer2, gt)
    assert rerank_r > coarse_r and rerank_r >= 0.9, (coarse_r, rerank_r)
    binary.auto_rerank = True
    auto_b = np.asarray(
        [[h.id for h in r] for r in binary.search_batch(queries, 10)]
    )
    assert recall_at_10(auto_b, gt) > coarse_r


def test_binary_hamming_serve_recall_glove_class(tmp_db_dir):
    """VERDICT r4 #2 (BASELINE config #3 class): binary storage at 100D
    angular on clustered data — the storage recall GATE must calibrate the
    Hamming-prefilter + f32-rerank serve path to >= 0.95 vs the host-f32
    oracle, widening the oversample if the sign sketch's coarse recall
    needs it."""
    rng = np.random.default_rng(23)
    n, d = 20_000, 100
    # GloVe-like LOCAL neighborhoods (~40 rows/cluster): a 100-bit sign
    # sketch separates clusters at ~6 sigma but cannot rank WITHIN a dense
    # near-tie cluster — with 64 giant clusters (~300 near-ties each) the
    # containment ceiling is an information limit of 1-bit/dim sketches,
    # not a serving bug (measured: m=320 containment 0.42 at c=64 vs 1.00
    # at c=512). Real angular corpora look like the latter.
    centers = rng.standard_normal((512, d)).astype(np.float32) * 2.0
    corpus = centers[rng.integers(0, 512, n)] + 0.7 * rng.standard_normal(
        (n, d)
    ).astype(np.float32)
    # queries share the corpus's centers (a mismatched query distribution
    # depresses prefilter recall while leaving exact recall intact)
    queries = centers[rng.integers(0, 512, 96)] + 0.7 * rng.standard_normal(
        (96, d)
    ).astype(np.float32)
    _, gt = brute_force_topk(queries, corpus, 10, DistanceMetric.COSINE, device="cpu")
    db = Database.open(tmp_db_dir, device="cpu")
    col = db.create_collection(
        "glv", dim=d, metric="cosine", storage_mode=StorageMode.BINARY
    )
    col.upsert_bulk(range(n), corpus)
    rows = np.asarray(
        [[h.id for h in r] for r in col.search_batch(queries, 10)]
    )
    r = recall_at_10(rows, gt)
    # the gate ran (n >= 4096) and its calibrated figure is recorded
    assert col._storage_gate_used == n
    assert col.planner.engine_recall("storage") is not None
    assert r >= 0.95, (
        f"binary+rerank serve recall {r:.3f} "
        f"(oversample {col._rerank_oversample})"
    )


def test_calibrate_storage_true_oracle(tmp_db_dir):
    """r3b: quantized-storage TRUE recall vs a host f32 oracle — the blind
    spot of engine calibration (whose oracle is the quantized brute path).
    At this small/sparse scale the serve path should measure >=0.95; a
    full-precision collection returns None (its serve path IS the oracle)."""
    rng = np.random.default_rng(13)
    n, d = 2000, 64
    corpus = clustered(rng, n, d, c=16)
    db = Database.open(tmp_db_dir, device="cpu")

    sq8 = db.create_collection("cal8", dim=d, storage_mode=StorageMode.SQ8)
    sq8.upsert_bulk(range(n), corpus)
    r = sq8.calibrate_storage(sample=48)
    assert r is not None and 0.9 <= r <= 1.0
    # cached by row count; a mutation invalidates
    assert sq8.calibrate_storage() == r
    assert sq8.planner.engine_recall("storage") == r
    sq8.upsert(n + 1, corpus[0])
    assert sq8._storage_recall[0] == n  # stale marker until re-probed
    r2 = sq8.calibrate_storage(sample=48)
    assert r2 is not None and sq8._storage_recall[0] == n + 1

    full = db.create_collection("calf", dim=d)
    full.upsert_bulk(range(100), corpus[:100])
    assert full.calibrate_storage() is None
