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
    """D_pad = 132 takes the kernel's 4-byte load path."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qi = torch.randint(-127, 128, (24, 132), dtype=torch.int8, device=cuda, generator=g)
    rows = torch.randint(-127, 128, (2048, 132), dtype=torch.int8, device=cuda, generator=g)
    pen = torch.randint(0, 1 << 20, (2048,), dtype=torch.int32, device=cuda, generator=g)
    ptile = bk.sq8pd_ptile(pen, 1024)
    gm = bk.sq8pd_bucket_gm(qi, rows, ptile, 1024)
    torch.cuda.synchronize()
    assert torch.equal(gm, bk.sq8pd_bucket_gm_ref(qi, rows, ptile, 1024))


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
    """f32 rows launch #2, bit for bit; f16 and bf16 rows launch #2b (the
    tensor cores), within ``half_scan_tolerance``."""
    q, rows, cc, _ = _float_inputs(cuda, np.random.default_rng(d + b), b, d, n, metric)
    q, rows = q.to(dtype), rows.to(dtype).contiguous()
    counter = "dense_bucket_gm" if dtype == torch.float32 else "dense_bucket_tc"
    before = dict(bk.LAUNCHES)
    gm, gi = bk.dense_bucket_gm(q, rows, cc, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {**before, counter: before[counter] + 1}
    if dtype == torch.float32:
        rm, ri = bk.dense_bucket_ref(q, rows, cc, chunk)
        assert torch.equal(gm, rm) and torch.equal(gi, ri)
    else:
        assert bk.half_scan_error(q, rows, cc, chunk, gm, gi)[0] <= 1.0


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
                                         (8, 48, 4096, 512)])
def test_hl_bucket_kernel_equals_plain(cuda, metric, b, d, n, chunk):
    q, rows, cc, _ = _float_inputs(cuda, np.random.default_rng(d + b + 1), b, d, n, metric)
    qhi, qlo = bk.split_f32_rows(q)
    hi, lo = bk.split_f32_rows(rows)
    before = bk.LAUNCHES["hl_bucket_gm"]
    gm, gi = bk.hl_bucket_gm(qhi, qlo, hi, lo, cc, chunk)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["hl_bucket_gm"] == before + 1
    rm, ri = bk.hl_bucket_ref(qhi, qlo, hi, lo, cc, chunk)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,chunk", [(13, 100, 131_072, 8192), (256, 128, 65_536, 8192),
                                         (1, 768, 8192, 1024)])
def test_sq8_bucket_kernel_equals_plain(cuda, metric, b, d, n, chunk):
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
    rm, ri = bk.sq8_bucket_ref(q, words, scale, minv, pen, qsum, chunk)
    assert torch.equal(gm, rm) and torch.equal(gi, ri)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot_product"])
@pytest.mark.parametrize("b,d,n,k", [(13, 100, 131_072, 10), (1, 768, 5000, 1),
                                     (16, 128, 20_000, 100), (9, 64, 3000, 1024),
                                     (3, 32, 100, 50)])
def test_fused_topk_kernel_equals_plain(cuda, dtype, metric, b, d, n, k):
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
    rv, ri = pk.fused_topk_ref(q, rows, valid, aux, qq, k, metric)
    assert torch.equal(vals, rv) and torch.equal(idx, ri)


def test_fused_topk_kernel_slices_the_batch_to_its_scratch(cuda, monkeypatch):
    """Past ``FUSED_SCRATCH_BYTES`` the batch launches in slices of 8 queries,
    with the same result as one launch."""
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
    rv, ri = pk.fused_topk_ref(q, rows, valid, aux, qq, 50, "euclidean")
    assert torch.equal(vals, rv) and torch.equal(idx, ri)


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
    plain version. split-bf16 and sq8-bucket are reached by lowering
    ``_SQ8I_MAX_DIM`` (and, for split-bf16, an offset corpus that
    ``sq8pd_build`` refuses)."""
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
    before = bk.LAUNCHES[counter]
    vals, ids = on_card.search(x[131_072:], 10)
    assert bk.LAUNCHES[counter] == before + 1
    want_vals, want_ids = on_cpu.search(x[131_072:], 10)
    # the queries' norms (cosine) and |q|^2 (the euclidean restore) are summed
    # in another order on the two devices; at the offset corpus's |q|^2 near
    # 1.3e6 an fp32 ulp is 0.125, ~1e-3 of a restored distance
    same = ids.cpu() == want_ids
    assert same.float().mean() >= 0.99
    tol = 5e-3 if engine == "split-bf16" else 1e-4
    torch.testing.assert_close(vals.cpu()[same], want_vals[same], rtol=tol, atol=tol)


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


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("r,group", [(8192, 16), (1000, 64), (77, 7), (1, 16)])
def test_row_gather_equals_plain(cuda, stages, r, group):
    """R not a multiple of the kernel's 64-row tile, repeated ids and the
    last row, bit for bit against the fixed-order plain version."""
    rng = np.random.default_rng(r)
    n, d = 100_000, 128
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
