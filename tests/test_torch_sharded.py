"""The JAX package's ``tests/test_sharded.py`` on the port's
``velesdb_tpu_torch.parallel`` (each test under the reference's name), and
the port held to the reference on the same seeded inputs.

The port runs in gloo worlds of 2 and 4 ranks on the CPU, spawned once for
the module (``tools/sharded_phase.py``: a rank imports only the port), at dp
1 and 2; the reference runs in this process on ``make_mesh`` over the same
shard count (``conftest.py`` gives it 8 CPU devices). While the world of 4
runs, this process computes the reference's answers. Streamed-mode ids equal the
reference's and values agree to rtol 1e-5; SQ8 and assist ids equal the
reference's, and the shards' quantized arrays equal the reference's host
arrays bit for bit. The two ``*_lowers_at_north_star_scale`` tests have no
torch program to lower: they check the shard layout at 8 x 6,291,456 rows
(``shard_layout``, the function ``rebuild`` sizes its shard with) and
allocate nothing; ``chip_smoke.py`` phase 14 runs one such shard."""

import numpy as np
import pytest
import torch

from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops import StorageMode as JMode
from velesdb_tpu.parallel import ShardedBruteForce as JBrute
from velesdb_tpu.parallel import make_mesh as j_mesh
from velesdb_tpu.parallel import sharded_ingest_search_step as j_step
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import SQ8Vectors
from velesdb_tpu_torch.ops.streamed import sq8_streamed_topk
from velesdb_tpu_torch.parallel import make_mesh
from velesdb_tpu_torch.parallel.sharded import (
    ASSIST_CHUNK,
    _sq8_quantize_div,
    shard_layout,
)
from velesdb_tpu_torch.tools import sharded_phase

# each metric at dp 1 and 2, the two worlds alternating
MATCH_CASES = [("cosine", 1, 2), ("cosine", 2, 4), ("euclidean", 1, 4), ("euclidean", 2, 2)]


def _clustered(rng, n, d, c=32, scale=2.0, noise=0.5):
    centers = rng.standard_normal((c, d)).astype(np.float32) * scale
    return centers[rng.integers(0, c, n)] + rng.standard_normal((n, d)).astype(np.float32) * noise


def _exact(q, corpus, k, metric, mask=None):
    """float64 exact top-k ``(scores, ids)`` in the metric's orientation."""
    q, c = q.astype(np.float64), corpus.astype(np.float64)
    if metric == "cosine":
        s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
            c / np.linalg.norm(c, axis=1, keepdims=True)).T
    elif metric == "euclidean":
        s = -np.sqrt(np.maximum((q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2 * q @ c.T, 0))
    else:
        s = q @ c.T
    if mask is not None:
        s = np.where(mask[None], s, -np.inf)
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    v = np.take_along_axis(s, ids, 1)
    return (-v if metric == "euclidean" else v), ids


def _jmetric(m):
    return JMetric.parse(m)


def _inputs():
    """Every case's seeded inputs: label -> (world, job, kwargs)."""
    cases = {}
    for metric, dp, w in MATCH_CASES:
        rng = np.random.default_rng(100 + 10 * dp + w)
        cases[f"match-{metric}-dp{dp}-w{w}"] = (w, "brute", dict(
            dp=dp, dim=64, metric=metric, corpus=rng.standard_normal((1000, 64)).astype(np.float32),
            queries=rng.standard_normal((8, 64)).astype(np.float32), k=10))
    rng = np.random.default_rng(1)
    cases["masked"] = (4, "brute", dict(
        dp=1, dim=32, metric="cosine", corpus=rng.standard_normal((512, 32)).astype(np.float32),
        queries=rng.standard_normal((2, 32)).astype(np.float32), k=5, mask=rng.random(512) < 0.3))
    cases["shard_rows"] = (4, "shard_rows", dict(
        dp=1, array=np.random.default_rng(2).standard_normal((13, 4)).astype(np.float32)))
    rng = np.random.default_rng(3)
    r1, r2 = (rng.standard_normal((8, 16)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((4, 16)).astype(np.float32)
    for dp, w in ((1, 2), (2, 4)):
        # 24 rows: 12 a shard at rows 2, so the second write (8-15) crosses
        # from shard 0 into shard 1
        cases[f"ingest-dp{dp}-w{w}"] = (w, "ingest", dict(
            dp=dp, dim=16, metric="dot_product", n=24, steps=[(r1, 0), (r2, 8)], queries=q, k=5))
    rng = np.random.default_rng(4)
    cases["sq8"] = (4, "brute", dict(
        dp=2, dim=64, metric="euclidean", storage_mode="sq8",
        corpus=rng.standard_normal((1024, 64)).astype(np.float32),
        queries=rng.standard_normal((8, 64)).astype(np.float32), k=10))
    rng = np.random.default_rng(5)
    corpus = _clustered(rng, 512, 32, c=8, scale=10.0, noise=1.0)
    cases["bf16"] = (4, "brute", dict(
        dp=1, dim=32, metric="cosine", storage_mode="bf16", corpus=corpus,
        queries=corpus[rng.integers(0, 512, 4)] + 0.01 * rng.standard_normal((4, 32)).astype(
            np.float32), k=5))
    rng = np.random.default_rng(6)
    cases["sq8-masked"] = (2, "brute", dict(
        dp=1, dim=32, metric="cosine", storage_mode="sq8",
        corpus=rng.standard_normal((512, 32)).astype(np.float32),
        queries=rng.standard_normal((2, 32)).astype(np.float32), k=5,
        mask=rng.random(512) < 0.3))
    # the assist mode: 131,072 rows a shard reach the bucket guard's floor
    for label, offset in (("assist", 0.0), ("assist-offset", 100.0)):
        rng = np.random.default_rng(7)
        corpus = _clustered(rng, 2 * 131_072, 64) + np.float32(offset)
        queries = corpus[rng.integers(0, len(corpus), 16)] + 1e-3 * rng.standard_normal(
            (16, 64)).astype(np.float32)
        cases[label] = (2, "brute", dict(
            dp=1, dim=64, metric="euclidean", corpus=corpus, queries=queries, k=10,
            serves=[(16, 10), (16, 4096)]))
    rng = np.random.default_rng(8)
    cases["sq8-100k"] = (4, "brute", dict(
        dp=1, dim=64, metric="cosine", storage_mode="sq8",
        corpus=rng.standard_normal((100_000, 64)).astype(np.float32),
        queries=rng.standard_normal((16, 64)).astype(np.float32), k=10, chunk=8192))
    return cases


def _reference(label, world, kw):
    """The reference's answer on ``make_mesh(world, dp)``."""
    mesh = j_mesh(world, dp=kw["dp"])
    if label.startswith("ingest"):
        from jax.sharding import NamedSharding, PartitionSpec as P
        import jax

        step = j_step(mesh, kw["dim"], _jmetric(kw["metric"]))
        corpus = jax.device_put(np.zeros((kw["n"], kw["dim"]), np.float32),
                                NamedSharding(mesh, P("rows", None)))
        valid = jax.device_put(np.zeros(kw["n"], bool), NamedSharding(mesh, P("rows")))
        found = []
        for rows, pos in kw["steps"]:
            corpus, valid, vals, ids = step(corpus, valid, rows, np.array([pos], np.int32),
                                            kw["queries"], k=kw["k"])
            found.append((np.asarray(vals), np.asarray(ids)))
        return {"found": found, "valid": np.asarray(valid)}
    if label == "shard_rows":
        return None
    idx = JBrute(mesh, kw["dim"], _jmetric(kw["metric"]),
                 storage_mode=JMode.parse(kw.get("storage_mode", "full")))
    idx.rebuild(kw["corpus"])
    out = {"search": idx.search(kw["queries"], kw["k"], chunk=kw.get("chunk", 65536))}
    if kw.get("mask") is not None:
        out["masked"] = idx.search(kw["queries"], kw["k"], mask=kw["mask"])
    if idx._assist is not None:
        out["shadow"] = tuple(np.asarray(a) for a in idx._assist)
    elif idx._codes is not None:
        out["shadow"] = tuple(np.asarray(a) for a in (idx._codes, idx._scale, idx._minv,
                                                      idx._cnorm))
    return out


@pytest.fixture(scope="module")
def runs():
    """``label -> (inputs, the port's per-rank results, the reference's)``:
    the world of 4 starts first, the reference runs here meanwhile, then the
    world of 2."""
    cases = _inputs()
    labels = {w: [lab for lab, c in cases.items() if c[0] == w] for w in (2, 4)}
    worlds, ref = sharded_phase.run_worlds(
        {w: [(cases[lab][1], cases[lab][2]) for lab in labs] for w, labs in labels.items()},
        lambda: {lab: _reference(lab, c[0], c[2]) for lab, c in cases.items()})
    out = {}
    for w, results in worlds.items():
        for lab, per_rank in zip(labels[w], results):
            out[lab] = (cases[lab][2], per_rank, ref[lab])
    return out


def _replicated(per_rank, key="search"):
    """Every rank holds the same global answer; return rank 0's."""
    v0, i0 = per_rank[0][key]
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r[key][1], i0)
        np.testing.assert_array_equal(r[key][0], v0)
    return v0, i0


def _by_shard(per_rank, key):
    """The ranks' local arrays in row-shard order (one rank a shard)."""
    seen = {}
    for r in per_rank:
        seen.setdefault(r["shard"], r[key])
    return [seen[s] for s in sorted(seen)]


@pytest.mark.parametrize("metric,dp,world", MATCH_CASES)
def test_sharded_matches_single_device(runs, metric, dp, world):
    kw, per_rank, ref = runs[f"match-{metric}-dp{dp}-w{world}"]
    vals, gidx = _replicated(per_rank)
    assert per_rank[0]["shards"] == world // dp
    ref_v, ref_i = _exact(kw["queries"], kw["corpus"], kw["k"], metric)
    assert np.array_equal(np.sort(gidx, axis=1), np.sort(ref_i, axis=1)), (
        "sharded merge must equal the single-device exact top-k")
    np.testing.assert_allclose(vals, ref_v, rtol=1e-4, atol=1e-5)
    # the reference's sharded engine on as many shards: same ids, same order
    jv, ji = ref["search"]
    np.testing.assert_array_equal(gidx, ji)
    np.testing.assert_allclose(vals, jv, rtol=1e-5, atol=1e-6)


def test_sharded_masked_search(runs):
    kw, per_rank, ref = runs["masked"]
    _, gidx = _replicated(per_rank, "masked")
    mask = kw["mask"]
    assert mask[gidx[gidx >= 0]].all(), "masked-out rows must never surface"
    _, ref_i = _exact(kw["queries"], kw["corpus"], kw["k"], "cosine", mask=mask)
    assert np.array_equal(np.sort(gidx, axis=1), np.sort(ref_i, axis=1))
    np.testing.assert_array_equal(gidx, ref["masked"][1])


def test_shard_rows_pads_and_distributes(runs):
    kw, per_rank, _ = runs["shard_rows"]
    sharded = np.concatenate(_by_shard(per_rank, "local"))
    assert sharded.shape[0] % 4 == 0 and sharded.shape[0] == 16
    np.testing.assert_array_equal(sharded[:13], kw["array"])
    assert not sharded[13:].any()


@pytest.mark.parametrize("dp,world", [(1, 2), (2, 4)])
def test_ingest_search_step(runs, dp, world):
    kw, per_rank, ref = runs[f"ingest-dp{dp}-w{world}"]
    valid = np.concatenate(_by_shard(per_rank, "valid"))
    assert all(r["in_place"] for r in per_rank), "the step must update the shard in place"
    r = len(kw["steps"][0][0])
    host = np.vstack([rows for rows, _ in kw["steps"]])
    ref_v, ref_i = _exact(kw["queries"], host, kw["k"], "dot_product")
    assert valid[: 2 * r].all() and not valid[2 * r :].any()
    vals, idx = per_rank[0]["found"][-1]
    assert np.array_equal(np.sort(idx, axis=1), np.sort(ref_i, axis=1))
    np.testing.assert_allclose(vals, ref_v, rtol=1e-4, atol=1e-5)
    for (v, i), (jv, ji) in zip(per_rank[0]["found"], ref["found"]):
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(valid, ref["valid"])


def test_multihost_helpers_single_host():
    """The single-host case with no world started: the bootstrap is a
    no-op, one slice, contiguous segments."""
    import torch.distributed as dist

    from velesdb_tpu_torch.parallel.multihost import init_distributed, num_slices
    from velesdb_tpu_torch.parallel.multihost import segment_for_host

    assert not dist.is_initialized()
    assert init_distributed() is False  # no env config -> no-op
    assert num_slices() == 1 and not dist.is_initialized()
    segs = [segment_for_host(103, h, 4) for h in range(4)]
    assert segs[0][0] == 0 and segs[-1][1] == 103
    for (a, b), (c, d) in zip(segs, segs[1:]):
        assert b == c


def test_sharded_sq8_matches_single_device(runs):
    """The SQ8 shard mode agrees with the single-device SQ8 engine on the
    same quantization (scores and rows), and with the reference's."""
    kw, per_rank, ref = runs["sq8"]
    vals, gidx = _replicated(per_rank)
    x = torch.from_numpy(kw["corpus"])
    codes, scale, minv = _sq8_quantize_div(x)
    deq = codes.float() * scale[:, None] + minv[:, None]
    sv, si = sq8_streamed_topk(torch.from_numpy(kw["queries"]), SQ8Vectors(codes, scale, minv),
                               cnorm=(deq * deq).sum(1), k=kw["k"], metric="euclidean")
    assert np.array_equal(np.sort(gidx, axis=1), np.sort(si.numpy(), axis=1)), (
        "sharded SQ8 must equal single-device SQ8")
    np.testing.assert_allclose(np.sort(vals, axis=1), np.sort(sv.numpy(), axis=1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(gidx, ref["search"][1])
    # the shards' codes, scale, minv and norms are the reference's host arrays
    for mine, theirs in zip(zip(*(_by_shard(per_rank, "shadow"))), ref["shadow"]):
        np.testing.assert_array_equal(np.concatenate(mine), theirs)


def test_sharded_bf16_mode(runs):
    """bf16 shard mode: rows still exact enough to match the f32 top-1 on
    well-separated data."""
    kw, per_rank, ref = runs["bf16"]
    _, gidx = _replicated(per_rank)
    _, ref_i = _exact(kw["queries"], kw["corpus"], kw["k"], "cosine")
    assert np.array_equal(gidx[:, 0], ref_i[:, 0])
    np.testing.assert_array_equal(gidx[:, 0], ref["search"][1][:, 0])


def test_sharded_sq8_masked(runs):
    kw, per_rank, ref = runs["sq8-masked"]
    _, gidx = _replicated(per_rank, "masked")
    assert kw["mask"][gidx[gidx >= 0]].all(), "masked-out rows must never surface"
    np.testing.assert_array_equal(gidx, ref["masked"][1])


def _overlap(rows, ref_i):
    return np.mean([len(set(a) & set(b)) / ref_i.shape[1] for a, b in zip(rows, ref_i)])


def test_sharded_assist_matches_exact(runs):
    """The assist shard mode (the coarse int8 scan, #7's plain version here,
    then the exact f32 rerank) against the exact oracle on clustered data,
    and id for id against the reference's (its Pallas kernel in interpret
    mode) on the same shadow."""
    kw, per_rank, ref = runs["assist"]
    r0 = per_rank[0]
    assert r0["assist"] and r0["n_local"] % ASSIST_CHUNK == 0
    serves = r0["serves"]
    assert serves[0], "guard must accept this shape"
    vals, rows = _replicated(per_rank)
    assert rows.shape == (16, kw["k"]) and (rows[:, 0] >= 0).all()
    _, ref_i = _exact(kw["queries"], kw["corpus"], kw["k"], "euclidean")
    assert _overlap(rows, ref_i) >= 0.9, f"assist shard recall {_overlap(rows, ref_i)}"
    assert (rows[:, 0] == ref_i[:, 0]).mean() >= 0.9
    # guard honesty: a huge k exceeds the oversample bound -> streamed path
    assert not serves[1]
    np.testing.assert_array_equal(rows, ref["search"][1])
    # the rerank sums squared differences, where the reference expands
    # |q|^2 + |c|^2 - 2 q.c, which cancels on the planted near-duplicates
    # (0.0078 for a 0.0086 distance): values against float64 instead
    diff = kw["queries"][:, None, :].astype(np.float64) - kw["corpus"][rows].astype(np.float64)
    np.testing.assert_allclose(vals, np.sqrt((diff * diff).sum(-1)), rtol=1e-5, atol=1e-6)
    for mine, theirs in zip(zip(*(_by_shard(per_rank, "shadow"))), ref["shadow"]):
        np.testing.assert_array_equal(np.concatenate(mine), theirs)


def test_sharded_assist_offset_corpus_keeps_the_reference_shadow(runs):
    """The sharded assist keeps the reference's uncentered shadow (the port's
    single-card assist centers it, ROADMAP): on the +100 offset corpus both
    packages' coarse scans keep the same candidates and lose the same near
    neighbours. The port's rerank then ranks those candidates exactly (the
    reference's expanded form cancels at these norms), so no query finds
    fewer true neighbours than in the reference. Both recalls are printed;
    centering the sharded shadow is a later item."""
    kw, per_rank, ref = runs["assist-offset"]
    _, rows = _replicated(per_rank)
    _, ref_i = _exact(kw["queries"], kw["corpus"], kw["k"], "euclidean")
    port, theirs = _overlap(rows, ref_i), _overlap(ref["search"][1], ref_i)
    # the port's single-card assist on the same rows, its shadow centered
    from velesdb_tpu_torch.index.brute import _assist_shadow
    from velesdb_tpu_torch.ops.bucket_kernel import sq8i_rerank_topk

    x = torch.from_numpy(kw["corpus"])
    rows8, scale, minv, pen, shift = _assist_shadow(x, torch.ones(len(x), dtype=torch.bool),
                                                    DistanceMetric.EUCLIDEAN)
    _, one = sq8i_rerank_topk(torch.from_numpy(kw["queries"]), rows8, scale, minv, pen, x,
                              k=kw["k"], m=16, metric="euclidean", chunk=ASSIST_CHUNK,
                              shift=shift)
    print(f"sharded assist on the +100 offset corpus, recall@10: port {port:.4f}, "
          f"reference {theirs:.4f}; the port's single-card assist (centered shadow) "
          f"{_overlap(one.numpy(), ref_i):.4f}")
    for mine, their, truth in zip(rows, ref["search"][1], ref_i):
        assert len(set(mine) & set(truth)) >= len(set(their) & set(truth))
    assert port >= theirs


def test_sharded_sq8_lowers_at_north_star_scale():
    """The SQ8 shard at the 50M x 768 north star over 8 shards (6,291,456
    rows each): its layout, and that it fits one 80 GB card."""
    n, d = 8 * 6_291_456, 768
    lay = shard_layout(n, 8, d, "sq8")
    assert lay["n_local"] == 6_291_456 and lay["n_pad"] == n and not lay["assist"]
    assert lay["bytes"] == 6_291_456 * (768 + 12 + 1)
    assert lay["bytes"] < 80e9 / 10
    # the reference's capacity math: f32 rows 19.3 GB a shard, half rows 9.7
    assert shard_layout(n, 8, d, "full")["bytes"] == 6_291_456 * (768 * 4 + 4 + 1)
    assert shard_layout(n, 8, d, "bf16")["bytes"] == 6_291_456 * (768 * 2 + 4 + 1)


def test_sharded_assist_lowers_at_north_star_scale():
    """The assist shard at 50M x 128 over 8 shards: 6,291,456 rows a shard,
    a multiple of the 8,192-row assist chunk; f32 rows 3.22 GB and the int8
    shadow 0.81 GB (``chip_smoke.py`` phase 14 builds this shard on the
    card), and uneven totals pad each shard up to the chunk."""
    n, d = 8 * 6_291_456, 128
    lay = shard_layout(n, 8, d, "full")
    assert lay["assist"] and lay["n_local"] == 6_291_456
    assert lay["n_local"] % ASSIST_CHUNK == 0
    assert lay["bytes"] == 6_291_456 * (128 * 4 + 4 + 128 + 12 + 1)
    assert 4.0e9 < lay["bytes"] < 4.2e9
    odd = shard_layout(n + 1, 8, d, "full")
    assert odd["n_local"] == 6_291_456 + ASSIST_CHUNK and odd["n_pad"] == 8 * odd["n_local"]
    assert shard_layout(1000, 4, 600, "full")["n_local"] == 250  # D >= 512: no shadow


def test_sharded_sq8_matches_single_device_100k(runs):
    """At 25,000 rows a shard: sharded SQ8 agrees with single-device SQ8
    row for row, and with the reference's."""
    kw, per_rank, ref = runs["sq8-100k"]
    _, rows = _replicated(per_rank)
    x = torch.from_numpy(kw["corpus"])
    codes, scale, minv = _sq8_quantize_div(x)
    deq = codes.float() * scale[:, None] + minv[:, None]
    _, si = sq8_streamed_topk(torch.from_numpy(kw["queries"]), SQ8Vectors(codes, scale, minv),
                              cnorm=torch.sqrt((deq * deq).sum(1)), k=kw["k"], metric="cosine",
                              chunk=8192)
    assert np.array_equal(np.sort(rows, 1), np.sort(si.numpy(), 1))
    np.testing.assert_array_equal(rows, ref["search"][1])


def test_make_mesh_cuda_raises_without_a_card():
    """The mesh's entry points default to the card; with none there is no
    fallback: ``make_mesh()`` raises before any world starts."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(dp=1, device="cuda")
    assert not dist.is_initialized()
