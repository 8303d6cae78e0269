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
