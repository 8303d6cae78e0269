"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked ``gpu`` and skips where ``torch.cuda`` has no
device: a CUDA kernel has no CPU mode. This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

import velesdb_tpu_torch.ops.bucket_kernel as bk
from velesdb_tpu_torch.index.brute import BruteForceIndex

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clustered(rng, n, d):
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    return centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 8192), (40, 48, 4096, 512),
                                         (256, 128, 65_536, 8192)])
def test_sq8pd_bucket_kernel_equals_plain(cuda, metric, b, d, n, chunk):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    corpus, queries = x[:n], x[n:]
    if metric == "cosine":
        corpus = corpus / corpus.norm(dim=1, keepdim=True)
    valid = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    rows_pd, pen_int, _, sdim, _, qu = bk.sq8pd_build(corpus, valid, d, metric)
    ptile = bk.sq8pd_ptile(pen_int, chunk)
    mask = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    ptile = torch.where(mask, ptile, -64 * bk._pd_invalid_pen(d))
    qi, _ = bk._sq8pd_quantize_queries(queries, sdim, qu, rows_pd.shape[1])
    before = bk.LAUNCHES["sq8pd_bucket_gm"]
    gm = bk.sq8pd_bucket_gm(qi, rows_pd, ptile, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["sq8pd_bucket_gm"] == before + 1
    assert torch.equal(gm, bk.sq8pd_bucket_gm_ref(qi, rows_pd, ptile, chunk))


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
def test_sq8pd_build_same_on_card_and_cpu(cuda, metric):
    """The shadow is a pure function of the corpus: fixed-order sums and
    true divisions make the card's build equal the CPU's bit for bit."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_clustered(rng, 20_000, 100))
    if metric == "cosine":
        x = x / x.norm(dim=1, keepdim=True)
    valid = torch.from_numpy(rng.random(20_000) > 0.15)
    on_cpu = bk.sq8pd_build(x, valid, 100, metric)
    on_card = bk.sq8pd_build(x.to(cuda), valid.to(cuda), 100, metric)
    for a, b in zip(on_cpu[:5], on_card[:5]):
        assert torch.equal(a, b.cpu())
    assert on_cpu[5] == on_card[5]


def test_sq8pd_bucket_kernel_refuses_bad_input(cuda):
    qi = torch.zeros((8, 128), dtype=torch.int8, device=cuda)
    rows = torch.zeros((1024, 128), dtype=torch.int8, device=cuda)
    ptile = torch.zeros(1024, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bk.sq8pd_bucket_gm(qi, rows, ptile, 384)
    with pytest.raises(ValueError):
        bk.sq8pd_bucket_gm(qi, rows.cpu(), ptile, 512)
    with pytest.raises(TypeError):
        bk.sq8pd_bucket_gm(qi, rows, ptile.long(), 512)


def test_pd_serve_path_launches_the_kernel(cuda):
    """The index's pd core on the card serves what the same index serves on
    the CPU through the plain version."""
    rng = np.random.default_rng(1)
    x = _clustered(rng, 131_072 + 32, 32)
    on_card = BruteForceIndex(32, "euclidean", device=cuda)
    on_cpu = BruteForceIndex(32, "euclidean", device="cpu")
    for index in (on_card, on_cpu):
        index.rebuild(x[:131_072], np.ones(131_072, bool))
        assert index.serve_engine() == "int8-assist-pd"
    before = bk.LAUNCHES["sq8pd_bucket_gm"]
    vals, ids = on_card.search(x[131_072:], 10)
    assert bk.LAUNCHES["sq8pd_bucket_gm"] == before + 1
    want_vals, want_ids = on_cpu.search(x[131_072:], 10)
    # identical shadows; the fp32 rerank may still order near-ties apart
    same = ids.cpu() == want_ids
    assert same.float().mean() >= 0.99
    torch.testing.assert_close(vals.cpu()[same], want_vals[same], rtol=1e-5, atol=1e-5)


def test_sq8pd_bucket_kernel_width_not_multiple_of_16(cuda):
    """D_pad = 132 is refused: the kernel copies rows 16 bytes at a time
    (every caller pads D to a multiple of 128), and nothing is launched."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qi = torch.randint(-127, 128, (24, 132), dtype=torch.int8, device=cuda, generator=g)
    rows = torch.randint(-127, 128, (2048, 132), dtype=torch.int8, device=cuda, generator=g)
    pen = torch.randint(0, 1 << 20, (2048,), dtype=torch.int32, device=cuda, generator=g)
    ptile = bk.sq8pd_ptile(pen, 1024)
    before = bk.LAUNCHES["sq8pd_bucket_gm"]
    with pytest.raises(ValueError):
        bk.sq8pd_bucket_gm(qi, rows, ptile, 1024)
    with pytest.raises(ValueError):  # past the int32 encoding's cap
        bk.sq8pd_bucket_gm(torch.zeros((8, 528), dtype=torch.int8, device=cuda),
                           torch.zeros((2048, 528), dtype=torch.int8, device=cuda), ptile, 1024)
    assert bk.LAUNCHES["sq8pd_bucket_gm"] == before


# (B_pad, D_pad, chunk): the query tiles 8 .. 128 of #1's int8 tensor-core
# epilogue (ragged at 24), zero-filled K steps (16, 48), the serve width (128)
# and the cap (512), one slice a bucket (chunk 128) up to 64 (8,192).
@pytest.mark.parametrize("chunk", [128, 2048, 8192])
@pytest.mark.parametrize("d_pad", [16, 48, 128, 512])
@pytest.mark.parametrize("b_pad", [8, 16, 24, 256])
def test_sq8pd_bucket_kernel_edges(cuda, b_pad, d_pad, chunk):
    """#1 on the int8 tensor cores bit for bit at its tiling's edges: 15% of
    rows and all of chunk 0 knocked out at the largest penalty the encoding
    takes, the most negative dot on a knocked-out row, and every slice of
    bucket lane 5 in chunk 1 one row (the slice bits decide)."""
    rng = np.random.default_rng(b_pad * 7 + d_pad + chunk)
    n = 2 * max(chunk, 2048)
    qi = rng.integers(-127, 128, (b_pad, d_pad)).astype(np.int8)
    rows = rng.integers(-127, 128, (n, d_pad)).astype(np.int8)
    pen = rng.integers(0, bk._PD_PEN_CAP + 1, n).astype(np.int32)
    knocked = rng.random(n) < 0.15
    knocked[:chunk] = True
    pen[knocked] = bk._pd_invalid_pen(d_pad)
    qi[0], rows[1] = 127, -127
    lane = chunk + 5 + np.arange(chunk // 128) * 128
    rows[lane], pen[lane] = rows[lane[0]], pen[lane[0]]
    qi, rows = torch.from_numpy(qi).to(cuda), torch.from_numpy(rows).to(cuda)
    ptile = bk.sq8pd_ptile(torch.from_numpy(pen).to(cuda), chunk)
    before = bk.LAUNCHES["sq8pd_bucket_gm"]
    gm = bk.sq8pd_bucket_gm(qi, rows, ptile, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["sq8pd_bucket_gm"] == before + 1
    assert gm.dtype == torch.int32 and torch.equal(gm, bk.sq8pd_bucket_gm_ref(qi, rows, ptile,
                                                                             chunk))
    assert bool((gm[:, :128] // 64 < bk._pd_empty_thresh(d_pad)).all())
    assert bool((gm[:, 128 + 5] & 63 == chunk // 128 - 1).all())


# -- slice 2: the per-row SQ8 kernel and the three Hamming kernels ----------

import velesdb_tpu_torch.ops.pallas_kernels as pk  # noqa: E402
from velesdb_tpu_torch.ops.quantization import binary_quantize, sq8_quantize  # noqa: E402


def _sq8i_inputs(cuda, rng, b, d, n, metric):
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    sq = sq8_quantize(x[:n])
    valid = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    index = BruteForceIndex(d, metric, "sq8", device=cuda)
    from velesdb_tpu_torch.index.brute import _affine_fold

    scale, minv, pen, _ = _affine_fold(sq, valid, index.metric)
    rows8 = bk.sq8_int8_rows(sq.codes)
    qi, _, sqi, invqs, _ = bk._sq8i_quantize_queries(x[n:], index.metric, rows8.shape[1])
    return qi, rows8, scale, 128.0 * scale + minv, pen, sqi, invqs


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 8192), (1, 128, 16_384, 8192),
                                         (40, 48, 4096, 512), (256, 128, 65_536, 8192)])
def test_sq8i_bucket_kernel_equals_plain(cuda, metric, b, d, n, chunk):
    args = _sq8i_inputs(cuda, np.random.default_rng(d + b), b, d, n, metric)
    before = bk.LAUNCHES["sq8i_bucket_gm"]
    gm, gi = bk.sq8i_bucket_gm(*args, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["sq8i_bucket_gm"] == before + 1
    rm, ri = bk.sq8i_bucket_ref(*args, chunk)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)


def _bits_inputs(cuda, rng, b, d, n):
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    bits = bk.hamming_bits_rows(x[:n], d)
    csum = bits.to(torch.int32).sum(dim=1)
    knocked = torch.from_numpy(rng.random(n) < 0.15).to(cuda)
    aux = torch.where(knocked, csum + bk._HAM_BIG, csum).to(torch.int32)
    qbits = torch.nn.functional.pad((x[n:] >= 0).to(torch.int8), (0, bits.shape[1] - d))
    return x, bits, aux, knocked, qbits


@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 8192), (16, 100, 16_384, 8192),
                                         (1, 256, 8192, 1024), (64, 100, 65_536, 8192)])
def test_hamming_mxu_kernel_equals_plain(cuda, b, d, n, chunk):
    _, bits, aux, _, qbits = _bits_inputs(cuda, np.random.default_rng(b), b, d, n)
    qi = torch.nn.functional.pad(2 * qbits, (0, 0, 0, (-b) % 8))
    before = bk.LAUNCHES["hamming_mxu_gm"]
    gm, gi = bk.hamming_mxu_gm(qi, bits, aux, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["hamming_mxu_gm"] == before + 1
    rm, ri = bk.hamming_mxu_ref(qi, bits, aux, chunk)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)


@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 2048), (16, 100, 16_384, 2048),
                                         (1, 768, 8192, 1024), (256, 100, 65_536, 2048)])
def test_hamming_bucket_kernel_equals_plain(cuda, b, d, n, chunk):
    x, _, _, knocked, _ = _bits_inputs(cuda, np.random.default_rng(b + 1), b, d, n)
    packed = binary_quantize(x[:n])
    q = torch.nn.functional.pad(binary_quantize(x[n:]), (0, 0, 0, (-b) % 8))
    pen = torch.where(knocked, torch.inf, 0.0)
    before = bk.LAUNCHES["hamming_bucket_gm"]
    gm, gi = bk.hamming_bucket_gm(q, packed, pen, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["hamming_bucket_gm"] == before + 1
    rm, ri = bk.hamming_bucket_ref(q, packed, pen, chunk)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)


@pytest.mark.parametrize("b,d,n,k", [(13, 100, 106_496, 10), (1, 100, 4096, 1),
                                     (16, 768, 20_000, 100), (40, 32, 3000, 64),
                                     (8, 100, 4096, 4096)])
def test_hamming_topk_kernel_equals_plain(cuda, b, d, n, k):
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    packed, q = binary_quantize(x[:n]), binary_quantize(x[n:])
    valid = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    before = pk.LAUNCHES["hamming_topk"]
    dist, idx = pk.hamming_topk(q, packed, valid, k)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["hamming_topk"] == before + 1
    rd, ri = pk.hamming_topk_ref(q, packed, valid, k)
    assert torch.equal(dist, rd) and torch.equal(idx, ri)


def _topk_words(rng, n, w):
    return torch.from_numpy(rng.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(np.int32))


def _topk_tie_case(cuda, name, b, w, rng):
    """``(q, packed, valid, k)`` of a tie-heavy #9 case on the card (the CPU
    model of the kernel's steps holds the same cases in
    ``test_torch_hamming_topk_split.py``)."""
    q = _topk_words(rng, b, w)
    if name == "all_equal":  # one row repeated: the first k rows
        n, k = 5000, 300
        packed = _topk_words(rng, 1, w).repeat(n, 1)
        valid = torch.ones(n, dtype=torch.bool)
    elif name == "straddle":  # distance 0 for query 0 around every 256-row boundary
        n, k = 4000, 100
        packed = _topk_words(rng, n, w)
        near = (torch.arange(n) % 256 >= 250) | (torch.arange(n) % 256 < 6)
        packed[near] = q[0]
        valid = torch.ones(n, dtype=torch.bool)
    elif name == "dead_chunk":  # the nearest rows all in one invalid chunk
        n, k = 4096, 50
        packed = _topk_words(rng, n, w)
        packed[256:512] = q[0]
        valid = torch.from_numpy(rng.random(n) > 0.15)
        valid[256:512] = False
    elif name == "few_valid":  # fewer valid rows than k: +inf / -1 empties
        n, k = 3000, 320
        valid = torch.zeros(n, dtype=torch.bool)
        valid[torch.from_numpy(rng.choice(n, 100, replace=False))] = True
        packed = _topk_words(rng, n, w)
    else:  # k = N over repeated rows
        n = k = 2000
        packed = _topk_words(rng, 8, w).repeat(n // 8, 1)
        valid = torch.from_numpy(rng.random(n) > 0.1)
    return q.to(cuda), packed.to(cuda), valid.to(cuda), k


@pytest.mark.parametrize("w", [1, 4, 24, 256])
@pytest.mark.parametrize("b", [1, 16, 256])
@pytest.mark.parametrize("name", ["all_equal", "straddle", "dead_chunk", "few_valid",
                                  "k_is_n"])
def test_hamming_topk_kernel_ties(cuda, name, b, w):
    """#9 split across the card, bit for bit with the stable sort on the
    tie-heavy cases, at every query-tile and word-count path."""
    q, packed, valid, k = _topk_tie_case(cuda, name, b, w, np.random.default_rng(b + w))
    before = pk.LAUNCHES["hamming_topk"]
    dist, idx = pk.hamming_topk(q, packed, valid, k)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["hamming_topk"] == before + 1
    rd, ri = pk.hamming_topk_ref(q, packed, valid, k)
    assert torch.equal(dist, rd) and torch.equal(idx, ri)


@pytest.mark.parametrize("k", [1, 10, 320, "n"])
@pytest.mark.parametrize("b", [1, 16, 256])
def test_hamming_topk_kernel_sizes(cuda, b, k):
    """#9 at the 100k-binary shape (N 106,496, W 4: the chunk of 1,024 rows
    at B 256, 256 below) and k up to N on a smaller corpus."""
    rng = np.random.default_rng(b * 3 + (0 if k == "n" else k))
    n = 4096 if k == "n" else 106_496
    k = n if k == "n" else k
    x = torch.from_numpy(_clustered(rng, n + b, 100)).to(cuda)
    packed, q = binary_quantize(x[:n]), binary_quantize(x[n:])
    valid = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    dist, idx = pk.hamming_topk(q, packed, valid, k)
    torch.cuda.synchronize()
    rd, ri = pk.hamming_topk_ref(q, packed, valid, k)
    assert torch.equal(dist, rd) and torch.equal(idx, ri)


def test_hamming_topk_kernel_owns_its_scratch(cuda):
    """#9's wrapper allocates the int32 scratch the source asks for, and the
    C entry refuses a shorter one instead of writing past it."""
    import ctypes
    import os
    import re

    from velesdb_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda._CSRC, "hamming_topk.cu")) as f:
        seg_rows = int(re.search(r"constexpr int kSegRows = (\d+);", f.read()).group(1))
    b, n, w, k = 16, 4096, 4, 10
    chunk = pk._topk_chunk(b, n)
    n_ints = pk._topk_scratch_ints(b, n, w, chunk)
    assert n_ints == b * (32 * w + 5 + (2 + seg_rows) * -(-n // chunk))
    q = torch.zeros((b, w), dtype=torch.int32, device=cuda)
    packed = torch.zeros((n, w), dtype=torch.int32, device=cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    dist = torch.empty((b, k), device=cuda)
    idx = torch.empty((b, k), dtype=torch.int64, device=cuda)
    keys = torch.empty((b, k), dtype=torch.int64, device=cuda)
    ints = torch.empty(n_ints - 1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bk._launch(pk.LAUNCHES, "hamming_topk", "hamming_topk", "hamming_topk_launch",
                   bk._P * 7 + (ctypes.c_longlong,) + bk._IIJ + (ctypes.c_int,),
                   q, packed, valid, dist, idx, keys, ints, n_ints - 1, b, n, w, k, chunk)


def test_slice2_kernels_refuse_bad_input(cuda):
    qi = torch.zeros((8, 128), dtype=torch.int8, device=cuda)
    rows = torch.zeros((1024, 128), dtype=torch.int8, device=cuda)
    f = torch.zeros(1024, device=cuda)
    fq = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):  # chunk does not divide N
        bk.sq8i_bucket_gm(qi, rows, f, f, f, fq, fq, 384)
    with pytest.raises(ValueError):  # mixed devices
        bk.sq8i_bucket_gm(qi, rows.cpu(), f, f, f, fq, fq, 512)
    with pytest.raises(TypeError):
        bk.hamming_mxu_gm(qi, rows, f, 512)  # aux must be int32
    with pytest.raises(ValueError):  # D_pad not a multiple of 16
        bk.hamming_mxu_gm(qi[:, :120].contiguous(), rows[:, :120].contiguous(),
                          torch.zeros(1024, dtype=torch.int32, device=cuda), 512)
    words = torch.zeros((1024, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        bk.hamming_bucket_gm(words[:8, ::2], words[:, ::2], f, 512)
    with pytest.raises(TypeError):  # words must be int32
        pk.hamming_topk(words[:8].float(), words)


@pytest.mark.parametrize("mode,engine,counter,n", [
    ("sq8", "sq8-int8", "sq8i_bucket_gm", 131_072),
    ("binary", "hamming-mxu", "hamming_mxu_gm", 131_072),
    ("binary", "hamming-topk", "hamming_topk", 20_000),
])
def test_quantized_serve_paths_launch_their_kernels(cuda, mode, engine, counter, n):
    """Each serve core on the card launches its kernel once per search and
    serves what the same index serves on the CPU through the plain version."""
    rng = np.random.default_rng(3)
    x = _clustered(rng, n + 16, 100)
    on_card = BruteForceIndex(100, "cosine", mode, device=cuda)
    on_cpu = BruteForceIndex(100, "cosine", mode, device="cpu")
    for index in (on_card, on_cpu):
        index.rebuild(x[:n], np.ones(n, bool))
        assert index.serve_engine() == engine
    launches = pk.LAUNCHES if counter == "hamming_topk" else bk.LAUNCHES
    before = launches[counter]
    vals, ids = on_card.search(x[n:], 10)
    assert launches[counter] == before + 1
    want_vals, want_ids = on_cpu.search(x[n:], 10)
    if mode == "binary":
        # sign bits are exact on both devices and ties break by position
        assert torch.equal(ids.cpu(), want_ids) and torch.equal(vals.cpu(), want_vals)
        return
    # the SQ8 state and query quantization sum in another order on the two
    # devices and may round apart in the last bit: values agree rank by
    # rank, and an id that clears the k-th value by more than that rounding
    # on one device is served on the other
    vals = vals.cpu()
    torch.testing.assert_close(vals, want_vals, rtol=1e-5, atol=1e-5)
    kth = want_vals[:, -1:]
    band = 1e-5 * kth.abs() + 1e-5
    for row in range(ids.shape[0]):
        got, want = set(ids.cpu()[row].tolist()), set(want_ids[row].tolist())
        assert set(want_ids[row][want_vals[row] > kth[row] + band[row]].tolist()) <= got
        assert set(ids.cpu()[row][vals[row] > kth[row] + band[row]].tolist()) <= want


def test_hamming_bucket_serve_path_launches_the_kernel(cuda, monkeypatch):
    monkeypatch.setenv("VELESDB_HAMMING_MXU_MAX_BYTES", "0")
    x = _clustered(np.random.default_rng(4), 131_072 + 16, 100)
    index = BruteForceIndex(100, "euclidean", "binary", device=cuda)
    index.rebuild(x[:131_072], np.ones(131_072, bool))
    assert index.serve_engine() == "hamming-bucket"
    before = bk.LAUNCHES["hamming_bucket_gm"]
    index.search(x[131_072:], 10)
    assert bk.LAUNCHES["hamming_bucket_gm"] == before + 1


def test_int8_assist_serve_path_launches_the_kernel(cuda):
    """A corpus offset far from the origin makes ``sq8pd_build`` refuse; the
    per-row int8 kernel then serves FULL storage."""
    x = _clustered(np.random.default_rng(6), 131_072 + 16, 128) + 100.0
    index = BruteForceIndex(128, "euclidean", device=cuda)
    index.rebuild(x[:131_072], np.ones(131_072, bool))
    assert index.serve_engine() == "int8-assist"
    before = bk.LAUNCHES["sq8i_bucket_gm"]
    index.search(x[131_072:], 10)
    assert bk.LAUNCHES["sq8i_bucket_gm"] == before + 1


# -- slice 3: the float-score kernels #2, #3, #6 and #8 ---------------------

FLOAT_DTYPES = [torch.float32, torch.float16, torch.bfloat16]


def _float_inputs(cuda, rng, b, d, n, metric):
    """Ragged inputs as a wrapper prepares them: queries normalized (cosine)
    or doubled (euclidean), padded to (B_pad, D_pad); 15% invalid rows."""
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    rows, q = x[:n], x[n:]
    if metric == "cosine":
        rows = rows / rows.norm(dim=1, keepdim=True)
        q = q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    invalid = torch.from_numpy(rng.random(n) < 0.15).to(cuda)
    base = (rows * rows).sum(1) if metric == "euclidean" else torch.zeros(n, device=cuda)
    cc = torch.where(invalid, torch.inf, base)
    d_pad = -(-d // 128) * 128
    q = torch.nn.functional.pad(q, (0, d_pad - d, 0, (-b) % 8))
    rows = torch.nn.functional.pad(rows, (0, d_pad - d))
    return q, rows, cc, ~invalid


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 8192), (1, 128, 16_384, 8192),
                                         (256, 128, 65_536, 8192), (40, 48, 4096, 512)])
def test_dense_bucket_kernel_equals_plain(cuda, dtype, metric, b, d, n, chunk):
    """f32 rows launch #2 (the f32 mode of the tensor-core scan), within
    ``f32_scan_tolerance``; f16 and bf16 rows launch #2b, within
    ``half_scan_tolerance``."""
    q, rows, cc, _ = _float_inputs(cuda, np.random.default_rng(d + b), b, d, n, metric)
    q, rows = q.to(dtype), rows.to(dtype).contiguous()
    counter = "dense_bucket_gm" if dtype == torch.float32 else "dense_bucket_tc"
    before = dict(bk.LAUNCHES)
    gm, gi = bk.dense_bucket_gm(q, rows, cc, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {**before, counter: before[counter] + 1}
    if dtype == torch.float32:
        assert bk.f32_scan_error(q, rows, cc, chunk, gm, gi)[0] <= 1.0
    else:
        assert bk.half_scan_error(q, rows, cc, chunk, gm, gi)[0] <= 1.0


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b", [1, 16, 256])
def test_dense_bucket_f32_within_tolerance(cuda, metric, b):
    """#2 on f32 rows at N 131,072, D 100 padded to 104 (a zero-filled last
    K step), B_pad 8, 16 and 256 (query tiles of 8, 16 and 128), 15%
    knocked-out rows."""
    n, chunk = 131_072, 8192
    q, rows, cc, keep = _float_inputs(cuda, np.random.default_rng(b + 31), b, 100, n, metric)
    q, rows = q[:, :104].contiguous(), rows[:, :104].contiguous()
    before = bk.LAUNCHES["dense_bucket_gm"]
    gm, gi = bk.dense_bucket_gm(q, rows, cc, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["dense_bucket_gm"] == before + 1
    assert gm.shape == gi.shape == (q.shape[0], n // chunk * 128)
    worst, _, _ = bk.f32_scan_error(q, rows, cc, chunk, gm, gi)
    assert worst <= 1.0, worst
    assert bool(keep[gi.long()][gm > -torch.inf].all())  # a finite winner is live


def test_dense_bucket_f32_at_the_width_cap(cuda):
    """D_pad 3,072, the contract's cap: two 8-query halves beside the two
    operand buffers; 40 queries run as five tiles."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(_clustered(rng, 8192 + 40, 3072)).to(cuda)
    q, rows = x[8192:].contiguous(), x[:8192].contiguous()
    cc = torch.where(torch.from_numpy(rng.random(8192) < 0.15).to(cuda), torch.inf,
                     (rows * rows).sum(1))
    q = 2.0 * q
    gm, gi = bk.dense_bucket_gm(q, rows, cc, 1024)
    torch.cuda.synchronize()
    worst, _, _ = bk.f32_scan_error(q, rows, cc, 1024, gm, gi)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b", [1, 13, 16, 256])
@pytest.mark.parametrize("d", [100, 128])
def test_dense_bucket_tc_within_tolerance(cuda, dtype, metric, b, d):
    """#2b at N 131,072 (16 chunks of 8,192), 15% knocked-out rows, B_pad 8
    .. 256 (query tiles of 8, 16 and 128, two of them at 256), D 100 padded
    to 104 (a zero-filled last K step) and 128."""
    n, chunk = 131_072, 8192
    rng = np.random.default_rng(b * 7 + d)
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    rows, q = x[:n], x[n:]
    if metric == "cosine":
        rows, q = rows / rows.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    knocked = torch.from_numpy(rng.random(n) < 0.15).to(cuda)
    base = (rows * rows).sum(1) if metric == "euclidean" else torch.zeros(n, device=cuda)
    cc = torch.where(knocked, torch.inf, base)
    d_pad = -(-d // 8) * 8
    q = torch.nn.functional.pad(q, (0, d_pad - d, 0, (-b) % 8)).to(dtype)
    rows = torch.nn.functional.pad(rows, (0, d_pad - d)).to(dtype).contiguous()
    before = bk.LAUNCHES["dense_bucket_tc"]
    gm, gi = bk.dense_bucket_gm(q, rows, cc, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["dense_bucket_tc"] == before + 1
    assert gm.shape == gi.shape == (q.shape[0], n // chunk * 128)
    worst, _, _ = bk.half_scan_error(q, rows, cc, chunk, gm, gi)
    assert worst <= 1.0, worst
    assert not bool(knocked[gi.long()][gm > -torch.inf].any())  # a finite winner is live


def test_dense_bucket_tc_wide_rows_take_smaller_query_tiles(cuda):
    """D_pad 3,072 leaves room for an 8-query tile only: 40 queries run as
    five tiles, with the same tolerance."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_clustered(rng, 8192 + 40, 3072)).to(cuda)
    q, rows = x[8192:].to(torch.bfloat16), x[:8192].to(torch.bfloat16).contiguous()
    cc = torch.zeros(8192, device=cuda)
    gm, gi = bk.dense_bucket_gm(q, rows, cc, 1024)
    torch.cuda.synchronize()
    assert bk.half_scan_error(q, rows, cc, 1024, gm, gi)[0] <= 1.0


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 8192), (256, 128, 65_536, 8192),
                                         (8, 48, 4096, 512), (200, 128, 65_536, 8192),
                                         (40, 1536, 8192, 1024)])
def test_hl_bucket_kernel_equals_plain(cuda, metric, b, d, n, chunk):
    """#3 (the split mode of the tensor-core bucket scan) within
    ``split_scan_tolerance`` of its plain version: B 13 -> 16, 40 and 200
    (query tiles of 128 with a part-filled last one), D 48 and 100 padded,
    D_pad 1,536 (the cap: 16-query tiles), 15% knocked-out rows."""
    q, rows, cc, _ = _float_inputs(cuda, np.random.default_rng(d + b + 1), b, d, n, metric)
    qhi, qlo = bk.split_f32_rows(q)
    hi, lo = bk.split_f32_rows(rows)
    before = bk.LAUNCHES["hl_bucket_gm"]
    gm, gi = bk.hl_bucket_gm(qhi, qlo, hi, lo, cc, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["hl_bucket_gm"] == before + 1
    assert gm.shape == gi.shape == (q.shape[0], n // chunk * 128)
    worst, _, _ = bk.split_scan_error(qhi, qlo, hi, lo, cc, chunk, gm, gi)
    assert worst <= 1.0, worst


def test_hl_bucket_kernel_all_rows_knocked_out(cuda):
    """Every bucket ``-inf`` on its slice-0 row, as the plain version."""
    q, rows, _, _ = _float_inputs(cuda, np.random.default_rng(3), 16, 128, 16_384, "dot_product")
    cc = torch.full((16_384,), torch.inf, device=cuda)
    args = (*bk.split_f32_rows(q), *bk.split_f32_rows(rows), cc, 8192)
    gm, gi = bk.hl_bucket_gm(*args)
    rm, ri = bk.hl_bucket_ref(*args)
    assert bool(torch.isneginf(gm).all()) and torch.equal(gi, ri)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 8192), (256, 128, 65_536, 8192),
                                         (1, 768, 8192, 1024), (256, 768, 16_384, 8192)])
def test_sq8_bucket_kernel_equals_plain(cuda, metric, b, d, n, chunk):
    """#6 (the SQ8 mode of the tensor-core scan) within ``sq8_scan_tolerance``:
    W 25 (D 100: rows not 16-byte aligned, a part-filled last K block), 32
    and 192 (D 768 at B 256: 32-query tiles)."""
    from velesdb_tpu_torch.index.brute import _affine_fold
    from velesdb_tpu_torch.ops.quantization import sq8_pack_blocked

    rng = np.random.default_rng(d + b + 2)
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    sq = sq8_quantize(x[:n])
    valid = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    index = BruteForceIndex(d, metric, "sq8", device=cuda)
    scale, minv, pen, _ = _affine_fold(sq, valid, index.metric)
    words = sq8_pack_blocked(sq.codes)
    q = x[n:] / x[n:].norm(dim=1, keepdim=True) if metric == "cosine" else x[n:]
    q = torch.nn.functional.pad(q, (0, words.shape[1] * 4 - d, 0, (-b) % 8))
    qsum = q.sum(1)
    before = bk.LAUNCHES["sq8_bucket_gm"]
    gm, gi = bk.sq8_bucket_gm(q, words, scale, minv, pen, qsum, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["sq8_bucket_gm"] == before + 1
    worst, _, _ = bk.sq8_scan_error(q, words, scale, minv, pen, qsum, chunk, gm, gi)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,k", [(13, 100, 131_072, 10), (1, 768, 5000, 1),
                                     (16, 128, 20_000, 100), (9, 64, 3000, 1024),
                                     (3, 32, 100, 50), (70, 128, 5000, 1),
                                     (20, 128, 3000, 1024), (130, 768, 9000, 10)])
def test_fused_topk_kernel_equals_plain(cuda, dtype, metric, b, d, n, k):
    """#8 within ``fused_topk_tolerance`` of its plain version on f32, f16
    and bf16 rows: B 70 and 130 (not multiples of the 64-query tile), k 1
    to 1,024 (query tiles of 64 down to 8), N not a multiple of the
    1,024-row range, 15% invalid rows."""
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(_clustered(rng, n + b, d)).to(cuda)
    q = x[n:]
    if metric == "cosine":
        q = q / q.norm(dim=1, keepdim=True)
    d_pad = -(-d // 128) * 128
    q = torch.nn.functional.pad(q, (0, d_pad - d)).contiguous()
    rows = torch.nn.functional.pad(x[:n], (0, d_pad - d)).to(dtype).contiguous()
    cn = (rows.float() ** 2).sum(1)
    aux = torch.where(cn > 1e-30, torch.rsqrt(cn.clamp_min(1e-30)), 0.0) \
        if metric == "cosine" else cn
    valid = torch.from_numpy(rng.random(n) > 0.15).to(cuda)
    qq = (q * q).sum(1)
    before = pk.LAUNCHES["fused_topk"]
    vals, idx = pk.fused_topk_scan(q, rows, valid, aux, qq, k, metric)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["fused_topk"] == before + 1
    worst, _, _ = pk.fused_topk_error(q, rows, valid, aux, qq, k, metric, vals, idx)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
def test_fused_topk_kernel_all_rows_invalid(cuda, dtype):
    """No valid row: every slot empty (-inf, id -1), as the plain version."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_clustered(rng, 3000 + 5, 128)).to(cuda)
    q, rows = x[3000:].contiguous(), x[:3000].to(dtype).contiguous()
    valid = torch.zeros(3000, dtype=torch.bool, device=cuda)
    aux, qq = (rows.float() ** 2).sum(1), (q * q).sum(1)
    vals, idx = pk.fused_topk_scan(q, rows, valid, aux, qq, 10, "euclidean")
    assert bool((idx == -1).all()) and bool(torch.isneginf(vals).all())


def test_fused_topk_kernel_slices_the_batch_to_its_scratch(cuda, monkeypatch):
    """Past ``FUSED_SCRATCH_BYTES`` the batch launches in slices of 8 queries,
    each within the tolerance of the plain version."""
    monkeypatch.setattr(pk, "FUSED_SCRATCH_BYTES", 1)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_clustered(rng, 3029, 64)).to(cuda)
    q, rows = x[3000:].contiguous(), x[:3000].contiguous()
    valid = torch.from_numpy(rng.random(3000) > 0.15).to(cuda)
    aux, qq = (rows * rows).sum(1), (q * q).sum(1)
    before = pk.LAUNCHES["fused_topk"]
    vals, idx = pk.fused_topk_scan(q, rows, valid, aux, qq, 50, "euclidean")
    torch.cuda.synchronize()
    assert pk.LAUNCHES["fused_topk"] == before + 4  # 29 queries, 8 a launch
    worst, _, _ = pk.fused_topk_error(q, rows, valid, aux, qq, 50, "euclidean", vals, idx)
    assert worst <= 1.0, worst


def test_slice3_kernels_refuse_bad_input(cuda):
    q = torch.zeros((8, 128), device=cuda)
    rows = torch.zeros((1024, 128), device=cuda)
    cc = torch.zeros(1024, device=cuda)
    with pytest.raises(TypeError):  # q and rows of different dtypes
        bk.dense_bucket_gm(q.half(), rows, cc, 512)
    with pytest.raises(ValueError):  # chunk does not divide N
        bk.dense_bucket_gm(q, rows, cc, 384)
    with pytest.raises(TypeError):  # hl takes bf16 only
        bk.hl_bucket_gm(q, q, rows, rows, cc, 512)
    words = torch.zeros((1024, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # q width must be 4 W
        bk.sq8_bucket_gm(q[:, :64].contiguous(), words, cc, cc, cc, q[:, 0].contiguous(), 512)
    valid = torch.ones(1024, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="1024"):
        pk.fused_topk_scan(q, rows, valid, cc, q[:, 0].contiguous(), 1025, "dot_product")


@pytest.mark.parametrize("mode,metric,engine,counter", [
    ("bf16", "euclidean", "bucket-f32", "dense_bucket_tc"),
    ("f16", "cosine", "bucket-f32", "dense_bucket_tc"),
    ("full", "euclidean", "split-bf16", "hl_bucket_gm"),
    ("sq8", "cosine", "sq8-bucket", "sq8_bucket_gm"),
])
def test_float_serve_paths_launch_their_kernels(cuda, monkeypatch, mode, metric, engine,
                                                counter):
    """Each slice-3 serve core on the card launches its kernel once per
    search and serves what the same index serves on the CPU through the
    plain version (split-bf16: its launch within the kernel's tolerance, and
    as close to a float64 oracle as the plain version). split-bf16 and
    sq8-bucket are reached by lowering ``_SQ8I_MAX_DIM`` (and, for
    split-bf16, an offset corpus that ``sq8pd_build`` refuses)."""
    import velesdb_tpu_torch.index.brute as brute

    monkeypatch.setattr(brute, "_SQ8I_MAX_DIM", [128])
    x = _clustered(np.random.default_rng(7), 131_072 + 16, 128)
    if engine == "split-bf16":
        x = x + 100.0
    on_card = BruteForceIndex(128, metric, mode, device=cuda)
    on_card.rebuild(x[:131_072], np.ones(131_072, bool))
    assert on_card.serve_engine() == engine
    # the same state on the CPU, so only the kernel and the query prep differ
    on_cpu = BruteForceIndex(128, metric, mode, device="cpu")
    state = {"valid": on_card._valid.cpu()}
    for key in ("full", "full_sqnorm", "bucket_pen", "full_hl", "sq8", "sq_norm", "sq8_words",
                "sq8_scale", "sq8_minv", "sq8_pen"):
        value = getattr(on_card, f"_{key}")
        if isinstance(value, tuple):  # (hi, lo) or SQ8Vectors
            moved = [t.cpu() for t in value]
            state[key] = type(value)(*moved) if hasattr(value, "_fields") else tuple(moved)
        elif value is not None:
            state[key] = value.cpu()
    on_cpu.load_state(state)
    assert on_cpu.serve_engine() == engine
    launches = []
    if engine == "split-bf16":  # keep the launch, to hold it to its tolerance
        kernel = bk.hl_bucket_gm
        monkeypatch.setattr(bk, "hl_bucket_gm",
                            lambda *a: launches.append((a, kernel(*a))) or launches[-1][1])
    before = bk.LAUNCHES[counter]
    vals, ids = on_card.search(x[131_072:], 10)
    assert bk.LAUNCHES[counter] == before + 1
    want_vals, want_ids = on_cpu.search(x[131_072:], 10)
    # the queries' norms (cosine) and |q|^2 (the euclidean restore) are summed
    # in another order on the two devices; at the offset corpus's |q|^2 near
    # 1.3e6 an fp32 ulp is 0.125, ~1e-3 of a restored distance
    same = ids.cpu() == want_ids
    if engine != "split-bf16":
        assert same.float().mean() >= 0.99
        torch.testing.assert_close(vals.cpu()[same], want_vals[same], rtol=1e-4, atol=1e-4)
        return
    # #3 on the tensor cores sums in its own order, within split_scan_tolerance
    # of the plain pass. On the offset corpus 2 q.c - |c|^2 cancels: the
    # plain version's own distances stray from the exact ones by ~0.1, so
    # the two orders swap near neighbours. Both are held to a float64
    # oracle instead: the card's recall@10 within 0.01 of the plain
    # version's, its mean distance error at most 1.5x the plain version's.
    (args, out), = [call for call in launches if call[0][0].is_cuda]  # the card's search
    assert bk.split_scan_error(*args, *out)[0] <= 1.0
    q64 = torch.from_numpy(x[131_072:]).to(cuda, torch.float64)
    c64 = torch.from_numpy(x[:131_072]).to(cuda, torch.float64)
    d2 = ((q64 * q64).sum(1)[:, None] + (c64 * c64).sum(1)[None, :] - 2.0 * q64 @ c64.T).cpu()
    exact = torch.topk(-d2, 10, dim=1).indices

    def recall(got):
        hits = sum(len(set(g.tolist()) & set(e.tolist())) for g, e in zip(got, exact))
        return hits / exact.numel()

    def dist_err(v, i):
        return float((v.double() - d2.gather(1, i).clamp_min(0.0).sqrt()).abs().mean())

    assert abs(recall(ids.cpu()) - recall(want_ids)) <= 0.01
    assert dist_err(vals.cpu(), ids.cpu()) <= 1.5 * dist_err(want_vals, want_ids)


def test_half_streamed_scan_on_the_card(cuda):
    """F16 at D >= 512 serves the streamed scan on the half corpus, chunk by
    chunk, with the same ids as the CPU."""
    x = _clustered(np.random.default_rng(8), 20_016, 768)
    on_card = BruteForceIndex(768, "cosine", "f16", device=cuda)
    on_cpu = BruteForceIndex(768, "cosine", "f16", device="cpu")
    for index in (on_card, on_cpu):
        index.rebuild(x[:20_000], np.ones(20_000, bool))
        assert index.serve_engine() == "streamed-scan"
    vals, ids = on_card.search(x[20_000:], 10)
    want_vals, want_ids = on_cpu.search(x[20_000:], 10)
    assert (ids.cpu() == want_ids).float().mean() >= 0.99
    torch.testing.assert_close(vals.cpu(), want_vals, rtol=1e-4, atol=1e-4)


# -- slice 4: the IVF probe kernel (#10) ------------------------------------

import velesdb_tpu_torch.ops.ivf_kernel as ik  # noqa: E402
from velesdb_tpu_torch.index.ivf import IvfIndex  # noqa: E402
from velesdb_tpu_torch.ops.quantization import sq8_pack_blocked  # noqa: E402


def _probe_inputs(device, rng, b, nprobe, L, d, storage, metric, n_parts=300):
    """Operands as ``ivf_probe_topk`` prepares them: 15% dead slots (pen
    +inf), the last 20 partitions all dead (past ``c_real``), probes drawn
    over every partition; SQ8 queries rounded to bf16, ``qsum`` from the
    unrounded ones."""
    x = torch.from_numpy(_clustered(rng, n_parts * L + b, d)).to(device)
    rows, q = x[: n_parts * L], x[n_parts * L:]
    live = torch.from_numpy(rng.random(n_parts * L) > 0.15).to(device)
    live[-20 * L:] = False
    if metric == "cosine":
        q = q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    if storage == "sq8":
        sq = sq8_quantize(rows)
        words = sq8_pack_blocked(torch.where(live[:, None], sq.codes, 0))
        parts = words.reshape(n_parts, L, -1)
        mul, add = sq.scale, sq.minv
        d_pad = 4 * parts.shape[2]
    else:
        parts = torch.where(live[:, None], rows, 0.0).reshape(n_parts, L, d).contiguous()
        mul, add = torch.ones(n_parts * L, device=device), torch.zeros(n_parts * L, device=device)
        d_pad = d
    psq = (rows * rows).sum(1)
    if metric == "cosine":
        inv = torch.rsqrt(psq)
        mul, add = mul * inv, add * inv if storage == "sq8" else add
    pen = torch.where(live, psq if metric == "euclidean" else 0.0, torch.inf)
    aux = torch.stack([t.reshape(n_parts, L) for t in (mul, add, pen)], dim=1).contiguous()
    q = torch.nn.functional.pad(q, (0, d_pad - d))
    qsum = q.sum(1)
    if storage == "sq8":
        q = q.to(torch.bfloat16).float()
    probe = torch.from_numpy(rng.integers(0, n_parts, (b, nprobe)).astype(np.int32)).to(device)
    return q.contiguous(), qsum, probe, parts, aux



@pytest.mark.parametrize("storage", ["f32", "sq8"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,nprobe,L,d", [(13, 5, 136, 100), (1, 68, 1032, 128),
                                          (64, 68, 1032, 128), (16, 12, 200, 768),
                                          (3, 7, 40, 13)])
def test_ivf_probe_kernel_equals_plain(cuda, storage, metric, b, nprobe, L, d):
    """Bit for bit at the ragged shape (D 100: W 25, no 16-byte loads for
    SQ8), the slice shape at b 1 (68 probes, the under-filled grid) and b 64,
    a 768-dim shape and a width not a multiple of 4 (f32 D 13)."""
    rng = np.random.default_rng(b * 1000 + L + d)
    args = _probe_inputs(cuda, rng, b, nprobe, L, d, storage, metric)
    before = ik.LAUNCHES["ivf_probe"]
    out = ik.ivf_probe_scores(*args)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["ivf_probe"] == before + 1
    want = ik.ivf_probe_ref(*args)
    assert out.shape == (b, nprobe, L)
    assert torch.equal(out, want)
    assert bool(torch.isneginf(out).any())  # dead slots reached


def test_ivf_probe_kernel_refuses_bad_input(cuda):
    q, qsum, probe, parts, aux = _probe_inputs(cuda, np.random.default_rng(1), 4, 3, 64, 32,
                                               "f32", "dot_product")
    with pytest.raises(TypeError):  # probe ids must be int32
        ik.ivf_probe_scores(q, qsum, probe.long(), parts, aux)
    with pytest.raises(TypeError):  # rows f32 or int32 words only
        ik.ivf_probe_scores(q, qsum, probe, parts.half(), aux)
    with pytest.raises(ValueError):  # aux must be [P, 3, L]
        ik.ivf_probe_scores(q, qsum, probe, parts, aux[:, :2].contiguous())
    with pytest.raises(ValueError):  # q width must match the rows
        ik.ivf_probe_scores(q[:, :16].contiguous(), qsum, probe, parts, aux)
    with pytest.raises(ValueError):  # one device
        ik.ivf_probe_scores(q, qsum, probe.cpu(), parts, aux)
    with pytest.raises(ValueError):  # contiguous
        ik.ivf_probe_scores(q, qsum, probe, parts.transpose(0, 1), aux)


@pytest.mark.parametrize("storage", ["f32", "sq8"])
def test_ivf_index_on_the_card(cuda, storage):
    """An IVF index built on the card: unmasked b <= 64 searches launch #10
    once, b = 100 and masked searches take the plain probing path; the same
    partitions on the CPU return the same ids."""
    from velesdb_tpu_torch.ops.quantization import SQ8Vectors

    rng = np.random.default_rng(3)
    x = _clustered(rng, 20_000 + 100, 128)
    base, q = x[:20_000], x[20_000:]
    src = torch.from_numpy(base).to(cuda)
    if storage == "sq8":
        src = sq8_quantize(src)
    on_card = IvfIndex(128, "euclidean", spill=2, device=cuda)
    on_card.build(src)
    before = ik.LAUNCHES["ivf_probe"]
    vals, ids = on_card.search(q[:16], 10, nprobe=8)
    assert ik.LAUNCHES["ivf_probe"] == before + 1
    on_card.search(q, 10, nprobe=8)
    on_card.search(q[:16], 10, nprobe=8, mask=np.ones(20_000, bool))
    assert ik.LAUNCHES["ivf_probe"] == before + 1
    on_cpu = IvfIndex(128, "euclidean", spill=2, device="cpu")
    for key in ("n", "c", "c_real", "part_len", "storage"):
        setattr(on_cpu, key, getattr(on_card, key))
    for key in ("centroids", "cent_sq", "parts", "part_scale", "part_minv", "part_rows",
                "part_sq"):
        value = getattr(on_card, f"_{key}")
        setattr(on_cpu, f"_{key}", None if value is None else value.cpu())
    on_cpu._kern = tuple(t.cpu() for t in on_card._kernel_state())
    on_cpu._dirty = False
    want_vals, want_ids = on_cpu.search(q[:16], 10, nprobe=8)
    assert (ids.cpu() == want_ids).float().mean() >= 0.99
    same = ids.cpu() == want_ids
    torch.testing.assert_close(vals.cpu()[same], want_vals[same], rtol=1e-4, atol=1e-4)
    if storage == "sq8":
        assert isinstance(src, SQ8Vectors) and on_card._parts.dtype == torch.int32


@pytest.mark.parametrize("storage", ["f32", "sq8"])
@pytest.mark.parametrize("b", [1, 64])
def test_ivf_probe_kernel_shared_and_invalid_probes(cuda, storage, b):
    """Bit for bit where queries share partitions: every query probes
    partition 5 (a run of ``b`` entries, cut into groups of ``PROBE_GROUP``),
    half the probes come from 12 partitions, some probe the all-dead
    partitions past ``c_real``, and two probe ids are not partitions."""
    rng = np.random.default_rng(b + 31)
    q, qsum, probe, parts, aux = _probe_inputs(cuda, rng, b, 68, 1032, 128, storage, "euclidean")
    n_parts = parts.shape[0]
    probe[:, 0] = 5
    probe[:, 1:34] = torch.from_numpy(rng.integers(0, 12, (b, 33)).astype(np.int32)).to(cuda)
    probe[:, 34] = n_parts - 1  # all dead
    probe[0, 35] = -1
    probe[-1, 36] = n_parts + 7
    before = ik.LAUNCHES["ivf_probe"]
    sched = torch.empty((3, probe.numel()), dtype=torch.int32, device=cuda)
    out = ik.ivf_probe_scores(q, qsum, probe, parts, aux, sched=sched)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["ivf_probe"] == before + 1
    assert torch.equal(out, ik.ivf_probe_ref(q, qsum, probe, parts, aux))
    assert bool(torch.isneginf(out[0, 35]).all()) and bool(torch.isneginf(out[-1, 36]).all())
    # the schedule the kernel ranked is probe_runs's, entry for entry
    want = ik.probe_runs(probe, n_parts)
    assert all(torch.equal(g, w) for g, w in zip(sched, want))
    assert int(want[2].sum()) == probe.numel() and int(want[2].max()) <= ik.PROBE_GROUP
    if b == 64:  # partition 5's run of 64 is cut into groups of PROBE_GROUP
        assert int(want[2].max()) == ik.PROBE_GROUP


def _time_ms(fn, iters=10):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wide_probe_case(cuda, storage, nprobe):
    """b 64 over 4,096 partitions of L 128, D 32: M = 64 * nprobe probes."""
    rng = np.random.default_rng(nprobe)
    return _probe_inputs(cuda, rng, 64, nprobe, 128, 32, storage, "euclidean", n_parts=4096)


@pytest.mark.parametrize("storage", ["f32", "sq8"])
@pytest.mark.parametrize("nprobe", [256, 257, 2048])
def test_ivf_probe_kernel_large_nprobe(cuda, storage, nprobe):
    """b 64 at nprobe 256 (M = 16,384 = SCHED_RANK_MAX: ranked on the card),
    257 and 2,048 (M 131,072: the schedule from probe_runs): bit for bit,
    one launch, and the schedule probe_runs's, entry for entry."""
    q, qsum, probe, parts, aux = _wide_probe_case(cuda, storage, nprobe)
    assert (probe.numel() > ik.SCHED_RANK_MAX) == (nprobe > 256)
    sched = torch.empty((3, probe.numel()), dtype=torch.int32, device=cuda)
    before = ik.LAUNCHES["ivf_probe"]
    out = ik.ivf_probe_scores(q, qsum, probe, parts, aux, sched=sched)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["ivf_probe"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(sched, ik.probe_runs(probe, parts.shape[0])))
    assert torch.equal(out, ik.ivf_probe_ref(q, qsum, probe, parts, aux))


@pytest.mark.parametrize("storage", ["f32", "sq8"])
def test_ivf_probe_schedule_cost_stays_in_bounds(cuda, storage):
    """At SCHED_RANK_MAX the ranking kernel's call costs at most twice the
    call one probe later, whose schedule probe_runs builds (~30 small
    launches); past it the time grows no faster than the probes (8x the
    probes within 16x the time), so no O(M^2) ranking runs there."""
    times = {}
    for nprobe in (256, 257, 2048):
        q, qsum, probe, parts, aux = _wide_probe_case(cuda, storage, nprobe)
        times[nprobe] = _time_ms(lambda: ik.ivf_probe_scores(q, qsum, probe, parts, aux))
        del q, qsum, probe, parts, aux
    assert times[256] <= 2.0 * times[257], times
    assert times[2048] <= 2.0 * (2048 * 64) / (257 * 64) * times[257], times


def test_probe_and_bucket_kernels_do_not_synchronize(cuda):
    """The schedule (ranked on the card, and from probe_runs past
    SCHED_RANK_MAX), both wrappers and their launches run with the host never
    waiting on the card."""
    rng = np.random.default_rng(2)
    args = _probe_inputs(cuda, rng, 16, 68, 1032, 128, "f32", "euclidean")
    wide = _probe_inputs(cuda, rng, 64, 300, 128, 32, "sq8", "euclidean", n_parts=1024)
    q, rows, cc, _ = _float_inputs(cuda, rng, 16, 128, 131_072, "euclidean")
    q, rows = q.to(torch.bfloat16), rows.to(torch.bfloat16).contiguous()
    for fn in (lambda: ik.ivf_probe_scores(*args), lambda: ik.ivf_probe_scores(*wide),
               lambda: bk.dense_bucket_gm(q, rows, cc, 8192)):
        fn()  # first call builds and binds the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# -- slice 6: the experiments' kernels, #12's epilogues and the row gather #11

import velesdb_tpu_torch.experiments.kernels as xk  # noqa: E402


def _v2_inputs(cuda, rng, b, n, dead_chunk):
    """#7's euclidean state with 15% of rows at pen = +inf (and, with
    ``dead_chunk``, the first 8,192 rows, so some buckets are all -inf), as
    the experiment packs it: ``aux [8, N]`` and ``qaux [B_pad, 8]``."""
    qi, rows8, scale, am, pen, sqi, invqs = _sq8i_inputs(cuda, rng, b, 128, n, "euclidean")
    if dead_chunk:
        pen = pen.clone()
        pen[:8192] = torch.inf
    aux = torch.zeros((8, n), device=cuda)
    aux[0], aux[1], aux[2] = scale, am, pen
    qaux = torch.zeros((qi.shape[0], 8), device=cuda)
    qaux[:, 1], qaux[:, 2] = sqi, -invqs
    return qi, rows8, aux, qaux


@pytest.mark.parametrize("variant", ["v2", "v2h", "v3"])
@pytest.mark.parametrize("b,n", [(1, 65_536), (13, 131_072), (256, 65_536)])
def test_sq8i_v2_epilogues_equal_plain(cuda, variant, b, n):
    qi, rows8, aux, qaux = _v2_inputs(cuda, np.random.default_rng(b), b, n, dead_chunk=b != 1)
    if variant == "v2h":
        aux, qaux = aux.to(torch.bfloat16), qaux.to(torch.bfloat16)
    elif variant == "v3":
        aux = qaux = None
    before = xk.LAUNCHES[f"sq8i_{variant}_bucket"]
    gm, gi = xk.sq8i_v2_bucket_gm(qi, rows8, aux, qaux, 8192, variant)
    torch.cuda.synchronize()
    assert xk.LAUNCHES[f"sq8i_{variant}_bucket"] == before + 1
    rm, ri = xk.sq8i_v2_bucket_ref(qi, rows8, aux, qaux, 8192, variant)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)
    if variant != "v3" and b != 1:
        assert bool(torch.isneginf(gm[:, :128]).all())  # the dead chunk's buckets


def test_sq8i_own_entry_unchanged_beside_the_epilogues(cuda):
    """#7's entry, instantiated from the same templated kernel as the
    epilogues, still equals its plain version at the serve shape."""
    args = _sq8i_inputs(cuda, np.random.default_rng(3), 256, 128, 131_072, "euclidean")
    gm, gi = bk.sq8i_bucket_gm(*args, 8192)
    rm, ri = bk.sq8i_bucket_ref(*args, 8192)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)


def test_sq8i_v2_refuses_bad_input(cuda):
    qi = torch.zeros((8, 128), dtype=torch.int8, device=cuda)
    rows = torch.zeros((1024, 128), dtype=torch.int8, device=cuda)
    aux = torch.zeros((8, 1024), device=cuda)
    qaux = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):
        xk.sq8i_v2_bucket_gm(qi, rows, aux, qaux, 512, "v4")
    with pytest.raises(TypeError):
        xk.sq8i_v2_bucket_gm(qi, rows, aux, qaux, 512, "v2h")
    with pytest.raises(ValueError):
        xk.sq8i_v2_bucket_gm(qi, rows, aux[:2], qaux, 512, "v2")
    with pytest.raises(ValueError):
        xk.sq8i_v2_bucket_gm(qi, rows.cpu(), None, None, 512, "v3")


def _gather_tile_rows() -> int:
    """``kTileRows`` of ``csrc/row_gather.cu``: the ids dealt to a block at a
    time."""
    import os
    import re

    from velesdb_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda._CSRC, "row_gather.cu")) as f:
        return int(re.search(r"constexpr int kTileRows = (\d+);", f.read()).group(1))


# (R, group, D): R 8,192 (the experiment's), a ragged R, R below one tile and
# one over a tile boundary ("tile-3", "tile+1", kTileRows read from the
# source), R 262,144 (the beam's rows a step at b 256: blocks walk several
# tiles), D 4, 132 (no row padding) and 960 (a GIST width), group 1 and 64
_GATHER_CASES = [(8192, 16, 128), (1000, 64, 128), (77, 7, 128), (1, 16, 128),
                 ("tile-3", 16, 128), ("tile+1", 16, 128), ("tile+1", 1, 132),
                 (262_144, 16, 128), (4096, 16, 4), (4096, 64, 4), (4096, 16, 132),
                 (3000, 64, 132), (8192, 16, 960), (5000, 1, 128), (5000, 64, 128)]


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("r,group,d", _GATHER_CASES)
def test_row_gather_equals_plain(cuda, stages, r, group, d):
    """Ragged R, tile edges, repeated ids and the last row, bit for bit
    against the fixed-order plain version."""
    if isinstance(r, str):
        r = _gather_tile_rows() + (1 if r == "tile+1" else -3)
    rng = np.random.default_rng(r + d)
    n = 100_000
    corpus = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, r, dtype=np.int32)).to(cuda)
    idx[: min(r, 3)] = n - 1
    idx[-min(r, 2):] = idx[:min(r, 2)].clone()
    counter = "row_gather" if stages == 1 else "row_gather_db"
    before = xk.LAUNCHES[counter]
    out = xk.row_gather_scores(q, corpus, idx, group=group, stages=stages)
    torch.cuda.synchronize()
    assert xk.LAUNCHES[counter] == before + 1
    assert torch.equal(out, xk.row_gather_scores_ref(q, corpus, idx))


@pytest.mark.parametrize("stages", [1, 2])
def test_row_gather_out_of_range_ids_score_nan_at_both_depths(cuda, stages):
    """Ids below 0 and at or past N, spread over several tiles and groups,
    score NaN and read nothing; the rows in range around them stay exact."""
    rng = np.random.default_rng(stages)
    n, d, r = 5000, 132, 300
    corpus = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, r, dtype=np.int32)).to(cuda)
    bad = torch.from_numpy(rng.random(r) < 0.2).to(cuda)
    bad[[0, 17, r - 1]] = True
    idx = torch.where(bad, torch.where(torch.arange(r, device=cuda) % 2 == 0, -1 - idx, n + idx),
                      idx).to(torch.int32)
    out = xk.row_gather_scores(q, corpus, idx, group=5, stages=stages)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(out), bad[None, :].expand(8, r))
    good = ~bad
    want = xk.row_gather_scores_ref(q, corpus, idx[good])
    assert torch.equal(out[:, good], want)


def test_row_gather_refuses_misaligned_corpus(cuda):
    """A corpus view off a 16-byte boundary, or not contiguous, raises before
    any launch: a bulk copy needs both ends 16-byte aligned."""
    corpus = torch.zeros(1000 * 32 + 1, device=cuda)[1:].view(1000, 32)
    assert corpus.data_ptr() % 16 == 4
    q = torch.ones((8, 32), device=cuda)
    idx = torch.arange(10, dtype=torch.int32, device=cuda)
    before = dict(xk.LAUNCHES)
    for stages in (1, 2):
        with pytest.raises(ValueError):
            xk.row_gather_scores(q, corpus, idx, stages=stages)
        with pytest.raises(ValueError):
            xk.row_gather_scores(q, torch.ones((1000, 64), device=cuda)[:, ::2], idx,
                                 stages=stages)
    with pytest.raises(ValueError):  # stages over the shared memory
        xk.row_gather_scores(torch.ones((8, 960), device=cuda),
                             torch.ones((1000, 960), device=cuda), idx, group=64, stages=2)
    assert xk.LAUNCHES == before


def test_row_gather_out_of_range_ids_score_nan(cuda):
    corpus = torch.ones((1000, 32), device=cuda)
    q = torch.ones((8, 32), device=cuda)
    idx = torch.tensor([0, 1000, -1, 999], dtype=torch.int32, device=cuda)
    out = xk.row_gather_scores(q, corpus, idx, group=2, stages=2)
    assert torch.equal(torch.isnan(out[0]).cpu(), torch.tensor([False, True, True, False]))
    assert float(out[0, 0]) == 32.0
    with pytest.raises(ValueError):
        xk.row_gather_scores(q, corpus, idx, group=65)
    with pytest.raises(ValueError):
        xk.row_gather_scores(q[:4], corpus, idx)


# -- slice 9: #7, #12's epilogues and #5 on the int8 tensor cores ---------------

# (B_pad, D_pad, chunk, N): the query-tile dispatch (NQ 8 .. 128, ragged
# tiles at 24 and 136), a zero-filled half K step (D_pad 16, 48, 112), eight
# K blocks (1,024), one slice a bucket (chunk 128), and each entry's D_pad
# cap at NQ 8 and 16 ("cap").
_INT8_TC_SHAPES = [(8, 128, 8192, 16_384), (24, 48, 128, 4096), (136, 112, 8192, 16_384),
                   (256, 16, 1024, 8192), (256, 1024, 8192, 16_384), (8, "cap", 128, 1024),
                   (16, "cap", 2048, 4096)]
_INT8_TC_CAPS = {"sq8i": bk._SQ8I_MAX_DPAD, "v2": 1024, "v2h": 1024, "v3": 1024,
                 "hamming": bk._HAM_MAX_DPAD}
_INT8_TC_TIE_LANE = 5


def _int8_tc_case(cuda, epilogue, b_pad, d_pad, chunk, n):
    """Seeded operands of one epilogue. Chunk 0 is knocked out (pen = +inf,
    #5: aux + 2^20; v3 has no penalty), and every slice of bucket lane 5 in
    chunk 1 holds one row with one set of per-row values, so they tie.
    Returns ``(kernel, plain, counter dict, key, args)``."""
    rng = np.random.default_rng(b_pad * 7 + d_pad + chunk)
    tie = chunk + _INT8_TC_TIE_LANE + np.arange(chunk // 128) * 128

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    if epilogue == "hamming":
        qi = 2 * (rng.random((b_pad, d_pad)) < 0.5).astype(np.int8)
        bits = (rng.random((n, d_pad)) < 0.5).astype(np.int8)
        knocked = rng.random(n) < 0.15
        knocked[:chunk] = True
        bits[tie], knocked[tie] = bits[tie[0]], knocked[tie[0]]
        aux = (bits.astype(np.int32).sum(1) + bk._HAM_BIG * knocked).astype(np.int32)
        return (bk.hamming_mxu_gm, bk.hamming_mxu_ref, bk.LAUNCHES, "hamming_mxu_gm",
                (dev(qi), dev(bits), dev(aux), chunk))
    qi = rng.integers(-127, 128, (b_pad, d_pad)).astype(np.int8)
    rows = rng.integers(-128, 128, (n, d_pad)).astype(np.int8)
    scale = rng.uniform(0.005, 0.02, n).astype(np.float32)
    am = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    pen = rng.uniform(0.0, 50.0, n).astype(np.float32)
    pen[rng.random(n) < 0.15] = np.inf
    pen[:chunk] = np.inf
    for v in (rows, scale, am, pen):
        v[tie] = v[tie[0]]
    invqs = rng.uniform(0.5, 2.0, b_pad).astype(np.float32)
    sqi = qi.astype(np.float32).sum(1)
    if epilogue == "sq8i":
        return (bk.sq8i_bucket_gm, bk.sq8i_bucket_ref, bk.LAUNCHES, "sq8i_bucket_gm",
                (*(dev(a) for a in (qi, rows, scale, am, pen, sqi, invqs)), chunk))
    aux = qaux = None
    if epilogue != "v3":
        dt = torch.bfloat16 if epilogue == "v2h" else torch.float32
        aux = dev(np.stack([scale, am, pen] + [np.zeros(n, np.float32)] * 5)).to(dt)
        qaux = np.zeros((b_pad, 8), np.float32)
        qaux[:, 1], qaux[:, 2] = sqi, -invqs
        qaux = dev(qaux).to(dt)
    return (xk.sq8i_v2_bucket_gm, xk.sq8i_v2_bucket_ref, xk.LAUNCHES, f"sq8i_{epilogue}_bucket",
            (dev(qi), dev(rows), aux, qaux, chunk, epilogue))


@pytest.mark.parametrize("b_pad,d_pad,chunk,n", _INT8_TC_SHAPES)
@pytest.mark.parametrize("epilogue", list(_INT8_TC_CAPS))
def test_int8_tc_edges_equal_plain(cuda, epilogue, b_pad, d_pad, chunk, n):
    """Every epilogue of the int8 tensor-core scan, bit for bit against its
    plain version at the tiling's edges; the knocked-out chunk's buckets
    return slice 0 (-inf; #5: at most 2 D_pad - 2^20), and the tied lane its
    smallest slice."""
    d_pad = _INT8_TC_CAPS[epilogue] if d_pad == "cap" else d_pad
    kernel, plain, launches, key, args = _int8_tc_case(cuda, epilogue, b_pad, d_pad, chunk, n)
    before = launches[key]
    gm, gi = kernel(*args)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    rm, ri = plain(*args)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)
    if epilogue == "hamming":
        assert bool((gm[:, :128] <= 2 * d_pad - bk._HAM_BIG).all())
    elif epilogue != "v3":
        assert bool(torch.isneginf(gm[:, :128]).all())
        slice0 = torch.arange(128, dtype=torch.int32).expand(b_pad, 128)
        assert torch.equal(gi[:, :128].cpu(), slice0)
    if chunk > 128:
        assert bool((gi[:, 128 + _INT8_TC_TIE_LANE] == chunk + _INT8_TC_TIE_LANE).all())


# -- slice 11: the graph's beam search with #10 as its SQ8 entry scan ----------

import velesdb_tpu_torch.index.graph_index as gmod  # noqa: E402
from velesdb_tpu_torch.index.params import GraphParams  # noqa: E402


def _graph_on(device, x, metric, monkeypatch, **params):
    monkeypatch.setattr(gmod.GraphIndex, "EXACT_KNN_MAX_ROWS", 4096)
    gi = gmod.GraphIndex(x.shape[1], metric, GraphParams(
        degree=32, knn_k=16, entry_probes=16, entry_points=48, expand_width=8, **params),
        device=device)
    xt = torch.from_numpy(x).to(device)
    gi.build(x, np.ones(len(x), bool), corpus_dev=xt)
    return gi


def _plain_probe(monkeypatch):
    """#10's plain version in place of the kernel, on the card."""

    def plain(q, qsum, probe, rows, aux, sched=None):
        return ik.ivf_probe_ref(q, qsum, probe, rows, aux)

    monkeypatch.setattr(ik, "ivf_probe_scores", plain)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
def test_graph_beam_kernel_entry_equals_plain(cuda, monkeypatch, metric, quantized):
    """A graph built on the card (approximate kNN, entry IVF): every
    unmasked search launches #10 once a dispatch, at b 16 and b 200; the
    same searches with #10's plain version patched in return the same ids
    and values bit for bit, and a masked search launches nothing."""
    rng = np.random.default_rng(7)
    x = _clustered(rng, 12_000 + 200, 64)
    base, q = x[:12_000], x[12_000:]
    if metric == "cosine":
        base = base / np.linalg.norm(base, axis=1, keepdims=True)
    gi = _graph_on(cuda, base, metric, monkeypatch, quantized_traversal=quantized)
    assert gi._entry_ivf is not None and gi._entry_ivf._parts.device.type == cuda.type
    got = {}
    for b in (16, 200):
        before = ik.LAUNCHES["ivf_probe"]
        got[b] = gi.search(q[:b], 10, ef=64)
        torch.cuda.synchronize()
        assert ik.LAUNCHES["ivf_probe"] == before + 1
    before = ik.LAUNCHES["ivf_probe"]
    mask = np.ones(gi.n_pad, bool)
    mask[::2] = False
    _, mids = gi.search(q[:16], 10, ef=64, mask=mask)
    assert ik.LAUNCHES["ivf_probe"] == before
    m = mids.cpu().numpy()
    assert mask[m[m >= 0]].all()
    _plain_probe(monkeypatch)
    for b in (16, 200):
        vals, ids = gi.search(q[:b], 10, ef=64)
        assert torch.equal(ids, got[b][1]) and torch.equal(vals, got[b][0])
    assert ik.LAUNCHES["ivf_probe"] == before


def test_graph_beam_on_card_matches_cpu(cuda, monkeypatch):
    """One graph, carried from the card to the CPU: the card's beam (with
    #10) and the CPU's (with #10's plain version) agree on the ids; the
    tie-stable selects keep both walks alike."""
    rng = np.random.default_rng(9)
    x = _clustered(rng, 12_000 + 32, 64)
    base, q = x[:12_000], x[12_000:]
    gi = _graph_on(cuda, base, "euclidean", monkeypatch)
    cpu = gmod.GraphIndex(64, "euclidean", gi.params, device="cpu")
    for key in ("n", "n_pad"):
        setattr(cpu, key, getattr(gi, key))
    for key in ("_corpus", "_adj", "_sqnorm", "_valid", "_seed_ids", "_route_cents",
                "_route_csq", "_route_rows"):
        setattr(cpu, key, getattr(gi, key).cpu())
    eiv = IvfIndex(64, "euclidean", device="cpu")
    for key in ("n", "c", "c_real", "part_len", "storage"):
        setattr(eiv, key, getattr(gi._entry_ivf, key))
    for key in ("_centroids", "_cent_sq", "_parts", "_part_scale", "_part_minv", "_part_rows",
                "_part_sq"):
        setattr(eiv, key, getattr(gi._entry_ivf, key).cpu())
    eiv._kern = tuple(t.cpu() for t in gi._entry_ivf._kernel_state())
    eiv._dirty = False
    cpu._entry_ivf, cpu._dirty = eiv, False
    vals, ids = gi.search(q, 10, ef=64)
    want_vals, want_ids = cpu.search(q, 10, ef=64)
    assert (ids.cpu() == want_ids).float().mean() >= 0.99
    same = ids.cpu() == want_ids
    torch.testing.assert_close(vals.cpu()[same], want_vals[same], rtol=1e-4, atol=1e-4)


def test_graph_collection_on_the_card(cuda, tmp_path):
    """``Database`` -> a ``graph`` collection on the card: #10 on every
    unmasked search, also after upserts (the delta's slots dead in its
    state), none under a filter; the upserted rows found, the same ids
    after a reopen."""
    import velesdb_tpu_torch

    rng = np.random.default_rng(11)
    x = _clustered(rng, 110_000 + 64, 32)
    base, q = x[:110_000], x[110_000:]
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device=cuda)
    col = db.create_collection("g", 32, metric="euclidean", index_kind="graph")
    col.upsert_bulk(range(110_000), base, [{"cat": i % 8} for i in range(110_000)])
    col.search_batch(q[:16], k=10, ef=128)  # build + calibrate
    assert col.ann._entry_ivf is not None and col.ann.params.entry_probes == 16
    before = ik.LAUNCHES["ivf_probe"]
    res = col.search_batch(q[:16], k=10, ef=128)
    assert ik.LAUNCHES["ivf_probe"] == before + 1
    flt = col.search_batch(q[:16], k=10, ef=128, filter={"type": "eq", "field": "cat",
                                                           "value": 3})
    assert ik.LAUNCHES["ivf_probe"] == before + 1
    assert all(h.id % 8 == 3 for r in flt for h in r)
    ids = [[h.id for h in r] for r in res]
    db.close()
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device=cuda)
    col = db.get_collection("g")
    col.index_kind = "graph"
    assert [[h.id for h in r] for r in col.search_batch(q[:16], k=10, ef=128)] == ids
    col.upsert_bulk(range(110_000, 110_016), q[:16] + 0.01)
    col.delete(ids[0][0])
    before = ik.LAUNCHES["ivf_probe"]
    hits = col.search_batch(q[:16] + 0.01, k=1, ef=128)
    assert ik.LAUNCHES["ivf_probe"] == before + 1 and len(col._stale["graph"]) == 17
    assert [r[0].id for r in hits] == list(range(110_000, 110_016))
    again = col.search_batch(q[:16], k=10, ef=128)
    assert ik.LAUNCHES["ivf_probe"] == before + 2
    assert ids[0][0] not in {h.id for r in again for h in r}
    db.close()
