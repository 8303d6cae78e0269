"""#9, the exact packed-Hamming top-k, at the edges of its split over the card.

The CUDA kernel (``velesdb_tpu_torch/csrc/hamming_topk.cu``) finds each
query's threshold T by counting, collects the rows below T in no order and
places the first ``k - lt`` rows at T in row order (from the 16 rows at T
it keeps per chunk, or by walking the chunk), one block per (chunk, 32-query
tile). ``_chunked_topk`` below is a plain-torch model of those five
steps (count -> threshold -> collect -> finish -> place) at the chunk the
kernel would use, or a given one. On tie-heavy inputs, made from a seed with
numpy, three results are held equal bit for bit:

- the JAX package's ``hamming_topk`` (its Pallas kernel in interpret mode,
  as the package's own tests run it);
- the port's plain version ``hamming_topk_ref`` (a stable sort), which the
  CUDA kernel is held to on a card (``test_torch_kernels_gpu.py``);
- the model, with the keys below T collected in a shuffled order, as the
  kernel's atomics may leave them.

The cases: every row equal; T's rows straddling chunk boundaries; a chunk
whose rows are all invalid; fewer valid rows than k; k = N; k 320 over a few
chunks; each at W 1, 4 and 24.
"""

import os
import re

import numpy as np
import pytest
import torch

import velesdb_tpu.ops.pallas_kernels as jpk
import velesdb_tpu_torch.ops.pallas_kernels as tpk
from velesdb_tpu_torch.ops import _cuda
from velesdb_tpu_torch.ops.bucket_kernel import hamming_distances

B = 5


def _source_int(name: str) -> int:
    """A ``constexpr int`` of ``csrc/hamming_topk.cu``."""
    with open(os.path.join(_cuda._CSRC, "hamming_topk.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


SEG_ROWS = _source_int("kSegRows")  # rows at T collect keeps per (query, chunk)


def _chunked_topk(q, packed, valid, k, chunk, seed=0):
    """The kernel's five steps in plain torch. Returns ``(dist f32 [B, k],
    idx int64 [B, k])`` with +inf / -1 empties."""
    b, w = q.shape
    n = packed.shape[0]
    nbins = 32 * w + 1
    n_chunks = -(-n // chunk)
    d = hamming_distances(q, packed).long()
    d = torch.where(valid[None, :], d, -1)  # invalid rows count nowhere
    dist = torch.full((b, k), torch.inf)
    idx = torch.full((b, k), -1, dtype=torch.int64)
    gen = np.random.default_rng(seed)
    for qi in range(b):
        # 1. count, chunk by chunk, summed into one histogram
        hist = torch.zeros(nbins, dtype=torch.int64)
        for c in range(n_chunks):
            dc = d[qi, c * chunk:(c + 1) * chunk]
            hist += torch.bincount(dc[dc >= 0], minlength=nbins)
        # 2. threshold
        cum = torch.cumsum(hist, 0)
        reach = torch.nonzero(cum >= k)
        t_at = int(reach[0]) if len(reach) else nbins
        lt = int(hist[:t_at].sum())
        need = k - lt if t_at < nbins else 0
        # 3. collect: keys below T in any order; per chunk the count at T and
        # the first SEG_ROWS rows at T to arrive, in any order
        keys, eq, kept = [], [], []
        for c in range(n_chunks):
            dc = d[qi, c * chunk:(c + 1) * chunk]
            rows = torch.arange(c * chunk, c * chunk + dc.shape[0])
            below = (dc >= 0) & (dc < t_at)
            keys += [(int(x) << 32) | int(r) for x, r in zip(dc[below], rows[below])]
            at = rows[dc == t_at].tolist()
            gen.shuffle(at)
            eq.append(len(at))
            kept.append(at[:SEG_ROWS])
        assert len(keys) == lt
        gen.shuffle(keys)
        # 4. finish: offsets of the rows at T, the keys sorted, empties
        off = np.concatenate([[0], np.cumsum(eq)[:-1]]).astype(int)
        for pos, key in enumerate(sorted(keys)):
            dist[qi, pos], idx[qi, pos] = float(key >> 32), key & 0xFFFFFFFF
        # 5. place: each chunk's first rows at T, in row order: the kept rows
        # ranked when they are all of them, else a walk of the chunk
        for c in range(n_chunks):
            take = min(max(need - off[c], 0), eq[c])
            if not take:
                continue
            if eq[c] <= SEG_ROWS:
                at = torch.tensor(sorted(kept[c])[:take], dtype=torch.int64)
            else:
                dc = d[qi, c * chunk:(c + 1) * chunk]
                at = torch.nonzero(dc == t_at)[:take, 0] + c * chunk
            slots = lt + off[c] + torch.arange(take)
            dist[qi, slots], idx[qi, slots] = float(t_at), at
    return dist, idx


def _case(name, w, rng):
    """``(q [B, w] int32, packed [N, w] int32, valid [N] bool, k, chunk)``:
    sign words built so that many rows tie at the threshold."""
    def words(n):
        return rng.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(np.int32)

    q = words(B)
    if name == "all_equal":  # every row the same: T = its distance, the first k rows
        n, chunk = 1000, 256
        packed = np.repeat(words(1), n, axis=0)
        return q, packed, np.ones(n, bool), 37, chunk
    if name == "straddle":  # rows at T on both sides of every chunk boundary
        n, chunk = 1300, 256
        packed = words(n)
        near = (np.arange(n) % 256 >= 250) | (np.arange(n) % 256 < 6)
        packed[near] = q[0]  # distance 0 for query 0 around each boundary
        return q, packed, np.ones(n, bool), 40, chunk
    if name == "dead_chunk":  # chunk 1 all invalid, its rows the nearest
        n, chunk = 1024, 256
        packed = words(n)
        packed[256:512] = q[1]
        valid = rng.random(n) > 0.15
        valid[256:512] = False
        return q, packed, valid, 50, chunk
    if name == "few_valid":  # fewer valid rows than k: +inf / -1 empties
        n, chunk = 700, 256
        valid = np.zeros(n, bool)
        valid[rng.choice(n, 30, replace=False)] = True
        return q, words(n), valid, 64, chunk
    if name == "k_is_n":
        n, chunk = 600, 256
        packed = np.repeat(words(8), n // 8, axis=0)  # eight distinct rows, 75 copies each
        return q, packed, rng.random(n) > 0.1, n, chunk
    assert name == "k320"  # k 320 over a few chunks, ties at T in each
    n, chunk = 1500, 256
    packed = np.repeat(words(40), -(-n // 40), axis=0)[:n]
    rng.shuffle(packed)
    return q, packed, rng.random(n) > 0.1, 320, chunk


CASES = ["all_equal", "straddle", "dead_chunk", "few_valid", "k_is_n", "k320"]


@pytest.mark.parametrize("w", [1, 4, 24])
@pytest.mark.parametrize("name", CASES)
def test_chunked_select_equals_reference_kernel(name, w):
    rng = np.random.default_rng(CASES.index(name) * 31 + w)
    q, packed, valid, k, chunk = _case(name, w, rng)
    jd, ji = jpk.hamming_topk(q.view(np.uint32), packed.view(np.uint32), valid=valid, k=k,
                              interpret=True)
    jd, ji = torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ji)).long()
    tq, tp, tv = torch.from_numpy(q), torch.from_numpy(packed), torch.from_numpy(valid)
    rd, ri = tpk.hamming_topk_ref(tq, tp, tv, k)
    assert torch.equal(rd, jd) and torch.equal(ri, ji)
    for c in {chunk, tpk._topk_chunk(B, packed.shape[0])}:
        md, mi = _chunked_topk(tq, tp, tv, k, c, seed=c)
        assert torch.equal(md, rd) and torch.equal(mi, ri)
    # the public wrapper on the CPU is the plain version
    wd, wi = tpk.hamming_topk(tq, tp, tv, k)
    assert torch.equal(wd, rd) and torch.equal(wi, ri)


def test_straddle_case_ties_across_chunks():
    """The straddle case does what its name says: query 0's rows at T lie on
    both sides of a chunk boundary, and the first k of them span chunks."""
    q, packed, valid, k, chunk = _case("straddle", 4, np.random.default_rng(4))
    d = hamming_distances(torch.from_numpy(q[:1]), torch.from_numpy(packed))[0]
    at = torch.nonzero(d == 0)[:, 0]
    assert len(at) > k
    assert len(set((at[:k] // chunk).tolist())) > 2


@pytest.mark.parametrize("b,n,chunk", [(256, 106_496, 1024), (16, 106_496, 256),
                                       (1, 4096, 256), (256, 1_000_000, 8192),
                                       (64, 1_000_000, 2048)])
def test_topk_chunk_spreads_the_work(b, n, chunk):
    """The chunk is the largest power of two from 8,192 down to 256 rows with
    512 blocks of (chunk, 32 queries), or 256."""
    assert tpk._topk_chunk(b, n) == chunk
    blocks = -(-b // 32) * -(-n // chunk)
    assert blocks >= tpk._TOPK_BLOCKS or chunk == tpk._TOPK_TILE
    if chunk < 8192:
        assert -(-b // 32) * -(-n // (2 * chunk)) < tpk._TOPK_BLOCKS


def test_scratch_stays_bounded():
    """The counters take 4 B (32 W + 5 + (2 + kSegRows) ceil(N / chunk))
    bytes (the source's ``hamming_topk_scratch_ints``): under B N / 3.5 for
    the per-chunk part at any k, since chunk >= 256."""
    per_chunk = 2 + SEG_ROWS  # a count at T, its offset, the kept rows
    for b, n, w in [(256, 106_496, 4), (1, 4096, 256), (13, 5_000_000, 24)]:
        chunk = tpk._topk_chunk(b, n)
        assert 4 * b * per_chunk * -(-n // chunk) <= b * n / 3.5 + 4 * b * per_chunk
    b, n, w, k = 256, 106_496, 4, 320
    chunk = tpk._topk_chunk(b, n)
    total = 4 * b * (32 * w + 5 + per_chunk * -(-n // chunk)) + 8 * b * k
    assert total < 2.8e6
