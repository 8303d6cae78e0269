"""``tests/test_ivf.py`` against the port's ``IvfIndex``, on the CPU.

Each test of the reference's IVF suite that this slice covers runs here on
``velesdb_tpu_torch.index.ivf`` (the probe kernel's plain version serves the
unmasked small batches). Where a test measures recall, the reference runs
beside it on the same data and the port's recall is at least the
reference's less 0.01. The kNN-builder tests (``merge_ranked``,
``_scatter_knn``) wait for the graph port. The ``.npz`` recipe is checked
both ways: a file saved by either package loads in the other and assembles
the same partitions (rows in the same clusters on >= 0.999 of rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu
import velesdb_tpu_torch
from velesdb_tpu.index.ivf import IvfIndex as JIvf
from velesdb_tpu.ops.quantization import sq8_quantize as j_sq8
from velesdb_tpu_torch.index.ivf import IvfIndex, ivf_search_impl, kmeans
from velesdb_tpu_torch.ops.ivf_kernel import ivf_probe_topk
from velesdb_tpu_torch.ops.quantization import SQ8Vectors


def _ivf(*args, **kwargs):
    return IvfIndex(*args, device="cpu", **kwargs)


def _clustered(rng, n, d, c=32):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 3
    a = rng.integers(0, c, n)
    return centers[a] + 0.6 * rng.standard_normal((n, d)).astype(np.float32)


def _gt(queries, corpus, k, metric):
    q, x = queries.astype(np.float64), corpus.astype(np.float64)
    if metric == "euclidean":
        s = -((q[:, None, :] - x[None]) ** 2).sum(-1)
    elif metric == "cosine":
        s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
            x / np.linalg.norm(x, axis=1, keepdims=True)).T
    else:
        s = q @ x.T
    return np.argsort(-s, axis=1)[:, :k]


def _recall(rows, gt):
    rows = rows.numpy() if isinstance(rows, torch.Tensor) else np.asarray(rows)
    return np.mean([len(set(r.tolist()) & set(g.tolist())) / gt.shape[1] for r, g in zip(rows, gt)])


def _sq8(x):
    """The reference's SQ8 codes, and the same as the port's SQ8Vectors."""
    sq = j_sq8(jnp.asarray(x))
    return sq, SQ8Vectors(*(torch.from_numpy(np.array(a)) for a in sq))


def test_kmeans_converges(rng):
    x = _clustered(rng, 2000, 16, c=8)
    cents, assign = kmeans(x, 8, iters=10)
    assign = assign.numpy()
    assert len(set(assign.tolist())) == 8
    d = np.linalg.norm(x - cents.numpy()[assign], axis=1).mean()
    assert d < np.linalg.norm(x - x.mean(0), axis=1).mean() * 0.6


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_ivf_recall(rng, metric):
    n, d, k = 5000, 32, 10
    corpus = _clustered(rng, n, d)
    queries = _clustered(rng, 64, d)
    gt = _gt(queries, corpus, k, metric)
    idx = _ivf(d, metric, n_clusters=32)
    idx.build(corpus)
    ref = JIvf(d, metric, n_clusters=32)
    ref.build(corpus)
    r = _recall(idx.search(queries, k, nprobe=8)[1], gt)
    assert r >= 0.9 and r >= _recall(ref.search(queries, k, nprobe=8)[1], gt) - 0.01
    # full probe (every partition incl. splits) = exact
    assert _recall(idx.search(queries, k, nprobe=idx.c)[1], gt) >= 0.999


def test_ivf_mask_and_padding(rng):
    n, d = 1000, 16
    corpus = _clustered(rng, n, d)
    idx = _ivf(d, "cosine", n_clusters=8)
    idx.build(corpus)
    mask = np.zeros(n, bool)
    mask[[5, 17, 400]] = True
    vals, rows = idx.search(corpus[:2], 5, nprobe=8, mask=mask)
    rows = rows.numpy()
    assert set(rows[rows >= 0].tolist()) <= {5, 17, 400}
    assert (vals.numpy()[rows < 0] == -np.inf).all()


def test_ivf_valid_rows_only(rng):
    n, d = 500, 8
    corpus = _clustered(rng, n, d)
    valid = np.ones(n, bool)
    valid[::2] = False
    idx = _ivf(d, "cosine", n_clusters=4)
    idx.build(corpus, valid)
    rows = idx.search(corpus[:4], 10, nprobe=4)[1].numpy()
    assert (rows[rows >= 0] % 2 == 1).all()


def test_ivf_save_load(tmp_path, rng):
    n, d = 1000, 16
    corpus = _clustered(rng, n, d)
    idx = _ivf(d, "cosine", n_clusters=8)
    idx.build(corpus)
    path = str(tmp_path / "ivf.npz")
    idx.save(path, version=3)
    idx2 = _ivf(d, "cosine")
    assert idx2.load(path, corpus, np.ones(n, bool), version=3)
    q = corpus[:4]
    assert torch.equal(idx.search(q, 5, nprobe=8)[1], idx2.search(q, 5, nprobe=8)[1])
    assert not idx2.load(path, corpus, np.ones(n, bool), version=4)  # stale


def test_spill_assignment_lifts_recall_per_probe(rng):
    """spill=2 dominates spill=1 recall at equal nprobe, with no duplicate
    rows in results, and reaches the reference's spill=2 recall."""
    n, d, k = 20_000, 32, 10
    centers = rng.standard_normal((16, d)).astype(np.float32) * 2.0
    corpus = centers[rng.integers(0, 16, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7
    noise = rng.standard_normal((64, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 64)] + noise * 0.7
    gt = _gt(queries, corpus, k, "euclidean")

    def recall(ivf, nprobe):
        idx = np.asarray(ivf.search(queries, k, nprobe=nprobe)[1])
        for row in idx:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)
        return _recall(idx, gt)

    i1 = _ivf(d, "euclidean")
    i1.build(corpus)
    i2 = _ivf(d, "euclidean", spill=2)
    i2.build(corpus)
    r1, r2 = recall(i1, 4), recall(i2, 4)
    assert r2 >= r1, (r1, r2)
    assert r2 >= min(0.9, r1 + 0.02) or r1 > 0.97, (r1, r2)
    ref = JIvf(d, "euclidean", spill=2)
    ref.build(corpus)
    assert r2 >= recall(ref, 4) - 0.01


def test_spill_save_load_roundtrip(tmp_path, rng):
    n, d = 2000, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    ivf = _ivf(d, "cosine", spill=2)
    ivf.build(corpus)
    p = str(tmp_path / "ivf.npz")
    ivf.save(p, version=3)
    ivf2 = _ivf(d, "cosine")
    assert ivf2.load(p, corpus, np.ones(n, bool), version=3)
    assert ivf2.spill == 2
    q = corpus[:4] + 0.001
    assert torch.equal(ivf.search(q, 5, nprobe=8)[1], ivf2.search(q, 5, nprobe=8)[1])


def test_nprobe_for_coverage_calibration():
    ivf = _ivf(32, "euclidean")
    ivf.n, ivf.part_len, ivf.c = 1_000_000, 520, 5800
    np64 = ivf.nprobe_for(128)
    assert 55 <= np64 <= 75, np64
    assert ivf.nprobe_for(256) > np64 > ivf.nprobe_for(64)
    ivf.n, ivf.part_len, ivf.c = 100_000, 512, 586
    np_small = ivf.nprobe_for(128)
    assert 5 <= np_small <= 9, np_small
    ivf.spill = 2
    ivf.part_len = 1024
    assert abs(ivf.nprobe_for(128) - np_small) <= 2
    ref = JIvf(32, "euclidean", spill=2)
    ref.n, ref.part_len, ref.c = 100_000, 1024, 586
    assert all(ivf.nprobe_for(ef) == ref.nprobe_for(ef) for ef in (16, 64, 128, 256, None))


def test_sq8_storage_ivf(tmp_path, rng):
    """Quantized-storage IVF: block-packed int32 words, recall at least the
    reference's on the same codes, save/load through the centroid recipe,
    and an f32 artifact refused against an SQ8 corpus."""
    n, d, k = 20_000, 32, 10
    centers = rng.standard_normal((16, d)).astype(np.float32) * 2.0
    corpus = centers[rng.integers(0, 16, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7
    noise = rng.standard_normal((64, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 64)] + noise * 0.7
    gt = _gt(queries, corpus, k, "euclidean")
    jsq, sq = _sq8(corpus)
    ivf = _ivf(d, "euclidean", spill=2)
    ivf.build(sq)
    assert ivf.storage == "sq8"
    assert ivf._parts.dtype == torch.int32 and ivf._parts.shape[-1] == (d + 3) // 4

    def recall(ix, nprobe):
        idx = np.asarray(ix.search(queries, k, nprobe=nprobe)[1])
        for row in idx:  # spill dedup holds in sq8 storage too
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)
        return _recall(idx, gt)

    ref = JIvf(d, "euclidean", spill=2)
    ref.build(jsq)
    r = recall(ivf, 8)
    assert r >= 0.9 and r >= recall(ref, 8) - 0.01
    p = str(tmp_path / "ivf_sq8.npz")
    ivf.save(p, version=5)
    ivf2 = _ivf(d, "euclidean")
    assert ivf2.load(p, sq, np.ones(n, bool), version=5)
    assert ivf2.storage == "sq8" and ivf2.spill == 2
    q = queries[:4]
    assert torch.equal(ivf.search(q, 5, nprobe=8)[1], ivf2.search(q, 5, nprobe=8)[1])
    ivf3 = _ivf(d, "euclidean")
    ivf3.build(corpus)
    p2 = str(tmp_path / "ivf_f32.npz")
    ivf3.save(p2, version=5)
    assert not _ivf(d, "euclidean").load(p2, sq, np.ones(n, bool), version=5)


def test_sq8_collection_uses_quantized_ivf(tmp_path, rng):
    """An SQ8 collection's IVF builds from the quantized codes (no f32
    partitions) and serves through plain search."""
    db = velesdb_tpu_torch.Database(str(tmp_path), device="cpu")
    c = db.create_collection("q", dim=16, storage_mode="sq8", metric="euclidean")
    base = rng.standard_normal((3000, 16)).astype(np.float32) + 3.0
    c.upsert_bulk(range(3000), base)
    c.refresh_device()
    assert c._ensure_ivf()
    assert c.ivf.storage == "sq8"
    assert c.ivf._parts.dtype == torch.int32
    hits = c.search_batch(base[:4] + 0.001, 5)
    assert [h[0].id for h in hits] == [0, 1, 2, 3]
    db.close()


def test_exact_partition_count(rng):
    n, d, c = 6000, 16, 24
    corpus = _clustered(rng, n, d, c=8)
    idx = _ivf(d, "euclidean", n_clusters=c)
    idx.build(corpus)
    L = idx.part_len
    worst = c + n // L + 1
    assert idx.c_real < worst
    assert idx.c_real <= idx.c <= worst
    pr = idx._part_rows.numpy()
    if idx.c > idx.c_real:
        assert (pr[idx.c_real:] == -1).all()
        assert (idx._cent_sq.numpy()[idx.c_real:] >= 5e29).all()
    live = pr.reshape(-1)[pr.reshape(-1) >= 0]
    assert len(live) == n and len(set(live.tolist())) == n
    queries = _clustered(rng, 32, d, c=8)
    got = idx.search(queries, 10, nprobe=idx.c)[1]
    assert _recall(got, _gt(queries, corpus, 10, "euclidean")) >= 0.999


def test_pack_factor_tightens_slots(rng):
    n, d = 4000, 16
    corpus = _clustered(rng, n, d)
    loose = _ivf(d, "euclidean", n_clusters=16)
    loose.build(corpus)
    tight = _ivf(d, "euclidean", n_clusters=16, pack_factor=1.1)
    tight.build(corpus)
    assert tight.c * tight.part_len < loose.c * loose.part_len
    queries = _clustered(rng, 16, d)
    got = tight.search(queries, 10, nprobe=tight.c)[1]
    assert _recall(got, _gt(queries, corpus, 10, "euclidean")) >= 0.999


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("storage", ["sq8", "f32"])
def test_probe_kernel_matches_xla_path(rng, metric, storage):
    """The probe op (#10's plain version here) returns the rows the plain
    probing path returns for identical probes, both partition storages."""
    n, d, k = 8000, 32, 10
    corpus = _clustered(rng, n, d, c=8)
    queries = _clustered(rng, 8, d, c=8)
    ivf = _ivf(d, metric, n_clusters=24)
    ivf.build(_sq8(corpus)[1] if storage == "sq8" else corpus)
    q = torch.from_numpy(queries)
    kv, ki = ivf_probe_topk(q, ivf._centroids, ivf._cent_sq, ivf._parts, *ivf._kernel_state(),
                            k=k, nprobe=8, metric=metric)
    parts = (ivf._parts, ivf._part_scale, ivf._part_minv) if storage == "sq8" else ivf._parts
    xv, xi = ivf_search_impl(q, ivf._centroids, ivf._cent_sq, parts, ivf._part_rows,
                             ivf._part_sq, None, k=k, nprobe=8, metric=metric)
    for a, b in zip(ki.numpy(), xi.numpy()):
        assert len(set(a.tolist()) & set(b.tolist())) >= k - 1
    np.testing.assert_allclose(kv.numpy(), xv.numpy(), rtol=2e-2, atol=2e-2)


def test_correlated_mask_probe_pruning(rng):
    """A cluster-correlated filter: pruning the routing to partitions that
    hold masked rows re-aims the probes at the kept cluster at the same
    nprobe (without it recall reads ~selectivity)."""
    n, d, c = 40_000, 24, 16
    centers = rng.standard_normal((c, d)).astype(np.float32) * 3
    assign = rng.integers(0, c, n)
    corpus = centers[assign] + 0.5 * rng.standard_normal((n, d)).astype(np.float32)
    ivf = _ivf(d, "euclidean")
    ivf.build(corpus, np.ones(n, bool))
    mask = assign == 5
    noise = rng.standard_normal((16, d)).astype(np.float32)
    queries = centers[rng.integers(0, c, 16)] + 0.5 * noise
    idx = ivf.search(queries, 10, nprobe=8, mask=mask)[1].numpy()
    assert mask[idx[idx >= 0]].all(), "filter violated"
    ids, sub = np.arange(n)[mask], corpus[mask]
    hits = sum(len(set(ids[np.argsort(np.linalg.norm(sub - queries[b], axis=1))[:10]])
                   & set(idx[b])) / 10 for b in range(16))
    assert hits / 16 > 0.8


@pytest.mark.parametrize("storage", ["f32", "sq8"])
def test_exclude_keeps_the_probe_kernel(rng, monkeypatch, storage):
    """Rows left out with ``exclude`` (a collection's stale slots) never come
    back. A small unmasked batch stays on the probe op, with the rows' slots
    dead in a copy of its state; it returns what a mask that drops the rows
    returns on the plain path, since no partition is left empty. A large
    batch folds them into the mask."""
    import velesdb_tpu_torch.index.ivf as tivf

    n, d, k = 8000, 128, 10  # SQ8 partitions reach MIN_BLOCK_BYTES at L 512, D 128
    corpus = _clustered(rng, n, d, c=8)
    queries = corpus[rng.integers(0, n, 80)] + 0.05
    ivf = _ivf(d, "euclidean", n_clusters=24)
    ivf.build(_sq8(corpus)[1] if storage == "sq8" else corpus)
    gone = rng.choice(n, 400, replace=False)
    calls = []
    orig = tivf.ivf_probe_topk
    monkeypatch.setattr(tivf, "ivf_probe_topk",
                        lambda *a, **kw: calls.append(a[0].shape[0]) or orig(*a, **kw))
    kv, ki = ivf.search(queries[:16], k, nprobe=8, exclude=gone)
    assert calls == [16]
    keep = np.ones(n, bool)
    keep[gone] = False
    mv, mi = ivf.search(queries[:16], k, nprobe=8, mask=keep)
    assert calls == [16]
    assert not np.isin(ki.numpy(), gone).any()
    for a, b in zip(ki.numpy(), mi.numpy()):
        assert len(set(a.tolist()) & set(b.tolist())) >= k - 1
    np.testing.assert_allclose(kv.numpy(), mv.numpy(), rtol=2e-2, atol=2e-2)
    again = ivf.search(queries[:16], k, nprobe=8, exclude=gone[::-1].copy())[1]
    assert torch.equal(again, ki) and calls == [16, 16]  # the dead state is cached
    big = ivf.search(queries, k, nprobe=8, exclude=gone)[1].numpy()
    assert calls == [16, 16] and not np.isin(big, gone).any()
    assert np.array_equal(big, ivf.search(queries, k, nprobe=8, mask=keep)[1].numpy())


def _clusters_of_rows(index, n):
    """Each row's set of k-means clusters (a partition's cluster is the
    k-means centroid equal to its routing centroid)."""
    kc = np.asarray(index._kmeans_cents.cpu() if isinstance(index._kmeans_cents, torch.Tensor)
                    else index._kmeans_cents)
    rc = np.asarray(index._centroids.cpu() if isinstance(index._centroids, torch.Tensor)
                    else index._centroids)
    pr = np.asarray(index._part_rows.cpu() if isinstance(index._part_rows, torch.Tensor)
                    else index._part_rows)
    of_part = np.argmin(((rc[:, None, :] - kc[None]) ** 2).sum(-1), axis=1)
    sets = [set() for _ in range(n)]
    for p, rows in enumerate(pr[: index.c_real]):
        for r in rows[rows >= 0]:
            sets[r].add(int(of_part[p]))
    return sets


@pytest.mark.parametrize("storage", ["f32", "sq8"])
def test_npz_recipe_loads_both_ways(tmp_path, rng, storage):
    """``ivf.npz`` written by the reference assembles in the port, and the
    port's in the reference, into the same partitions."""
    n, d = 6000, 32
    corpus = _clustered(rng, n, d, c=16)
    valid = np.ones(n, bool)
    valid[::7] = False
    jsq, sq = _sq8(corpus)
    ref = JIvf(d, "euclidean", spill=2)
    ref.build(jsq if storage == "sq8" else corpus, valid)
    ref.save(str(tmp_path / "ref.npz"), version=2)
    port = _ivf(d, "euclidean")
    assert port.load(str(tmp_path / "ref.npz"), sq if storage == "sq8" else corpus, valid,
                     version=2)
    assert (port.storage, port.spill, port.part_len) == (ref.storage, 2, ref.part_len)
    np.testing.assert_array_equal(port._kmeans_cents.numpy(), np.asarray(ref._kmeans_cents))
    a, b = _clusters_of_rows(port, n), _clusters_of_rows(ref, n)
    assert np.mean([x == y for x, y in zip(a, b)]) >= 0.999
    port.save(str(tmp_path / "port.npz"), version=2)
    back = JIvf(d, "euclidean")
    assert back.load(str(tmp_path / "port.npz"), jsq if storage == "sq8" else corpus, valid,
                     version=2)
    assert back.storage == ref.storage and back.spill == 2
    c = _clusters_of_rows(back, n)
    assert np.mean([x == y for x, y in zip(a, c)]) >= 0.999


def test_reference_collection_ivf_npz_opens_in_the_port(tmp_path, rng):
    """A collection directory whose ``ivf.npz`` the reference wrote: the
    port pinned to IVF restores it without a k-means run."""
    x = _clustered(rng, 4000, 16, c=8)
    with velesdb_tpu.Database.open(str(tmp_path)) as ref_db:
        ref = ref_db.create_collection("c", 16, metric="euclidean")
        ref.upsert_bulk(range(4000), x)
        ref.index_kind = "ivf"
        want = [[h.id for h in r] for r in ref.search_batch(x[:8] + 0.01, k=5)]
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device="cpu")
    col = db.get_collection("c")
    col.index_kind = "ivf"
    import velesdb_tpu_torch.index.ivf as tivf

    calls = []
    orig = tivf.kmeans
    tivf.kmeans = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        got = [[h.id for h in r] for r in col.search_batch(x[:8] + 0.01, k=5)]
    finally:
        tivf.kmeans = orig
    assert not calls and not col.ivf.dirty
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got, want)]) >= 0.95
