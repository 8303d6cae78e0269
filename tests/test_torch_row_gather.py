"""#11, the scored row gather (``csrc/row_gather.cu``), on the CPU.

- The plain version ``row_gather_scores_ref`` against the JAX experiment's
  ``kern`` and ``kern_db`` (``benchmarks/exp_gather_kernel.py``), read from
  the script with ``ast`` and run through its own ``pallas_call`` in TPU
  interpret mode, at D 132 (not a multiple of 8: no row padding) and at the
  smallest R and group the script accepts (R = G = 1). The script scores with
  one ``dot_general``, another order of the same fp32 sum, so the bound is
  ``1e-6 |ref| + D 2^-24 sum_d |q_d c_d|``, as in ``test_torch_experiments``.
- The wrapper's limits against the constants of the kernel's source, its
  shared-memory size against the source's layout, and a model of how the
  kernel deals rows to blocks (tiles of ``kTileRows`` ids, tile t to block
  t mod grid, then groups of ``group`` rows): every row exactly once.
- The wrapper refuses what the kernel does not take (a misaligned or
  non-contiguous corpus, a non-contiguous ``idx``, a bad group, a stage set
  over the shared memory) before any launch, and hands the launch its
  arguments in the entry's order.
"""

import ast
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from velesdb_tpu_torch.experiments import kernels as xk
from velesdb_tpu_torch.ops import _cuda

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                      "exp_gather_kernel.py")

with open(os.path.join(_cuda._CSRC, "row_gather.cu")) as _f:
    SOURCE = _f.read()


def _source_int(name: str) -> int:
    """A ``constexpr int`` of ``csrc/row_gather.cu``."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TILE_ROWS = _source_int("kTileRows")


def _jax_gather(name: str, q, corpus, idx, g: int):
    """``kern`` (depth 1) or ``kern_db`` (depth 2) of the script, built with
    its own grid spec and ``pallas_call`` and run in interpret mode."""
    with open(SCRIPT) as f:
        main = next(n for n in ast.parse(f.read()).body
                    if isinstance(n, ast.FunctionDef) and n.name == "main")
    call, spec = ("call", "grid_spec") if name == "kern" else ("call_db", "grid_spec_db")
    wanted = {name, call, spec}
    nodes = [n for n in main.body
             if (isinstance(n, ast.FunctionDef) and n.name in wanted)
             or (isinstance(n, ast.Assign) and any(getattr(t, "id", None) in wanted
                                                   for t in n.targets))]
    assert len(nodes) == 3
    n, d = corpus.shape
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, N=n, D=d, R=idx.shape[0], G=g,
              args=types.SimpleNamespace(interpret=False))
    with pltpu.force_tpu_interpret_mode():
        exec(compile(ast.Module(body=nodes, type_ignores=[]), SCRIPT, "exec"), ns)
        return np.asarray(ns[call](jnp.asarray(idx), jnp.asarray(q), jnp.asarray(corpus)))


@pytest.mark.parametrize("name", ["kern", "kern_db"])
@pytest.mark.parametrize("n,d,r,g", [(4096, 132, 256, 16), (512, 132, 1, 1), (512, 128, 1, 1),
                                     (300, 4, 24, 8)])
def test_plain_version_equals_jax_kernel(name, n, d, r, g):
    rng = np.random.default_rng(d + r)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    idx = rng.integers(0, n, r, dtype=np.int32)
    idx[: min(r, 3)] = n - 1  # repeated ids, the last row
    got = _jax_gather(name, q, corpus, idx, g)
    ref = xk.row_gather_scores_ref(torch.from_numpy(q), torch.from_numpy(corpus),
                                   torch.from_numpy(idx)).numpy()
    a = (np.abs(q)[:, None, :] * np.abs(corpus[idx])[None, :, :]).sum(-1)
    assert got.shape == ref.shape == (8, r)
    np.testing.assert_array_less(np.abs(got - ref), 1e-6 * np.abs(ref) + d * 2.0**-24 * a + 1e-30)


def test_wrapper_limits_match_the_source():
    assert xk._GATHER_MAX_GROUP == _source_int("kMaxGroup")
    assert xk._GATHER_SMEM_MAX == _source_int("kSmemMax") == 227 * 1024
    # two queries a thread, four threads a row: the queries split in halves
    assert _source_int("kPartsPerRow") * 2 == _source_int("kQueries") == 8
    # lanes 0 .. 31 of warp 0 issue rows lane and lane + 32 of a group
    assert _source_int("kMaxGroup") == 64 and _source_int("kThreads") >= 32


def test_smem_layout_matches_the_source():
    """The wrapper's size is the source's: 32 bytes of barriers, the ids
    rounded to 16 bytes, the queries and the stage rows at one stride."""
    assert "return d % 8 == 0 ? d + 4 : d;" in SOURCE
    assert "return ids_offset() + (4 * stages * group + 15) / 16 * 16;" in SOURCE
    assert "return q_offset(stages, group) + 4LL * row_stride(d) * (kQueries + stages * group);" \
        in SOURCE
    assert xk._gather_smem_bytes(1, 16, 128) == 32 + 64 + 4 * 132 * (8 + 16)
    assert xk._gather_smem_bytes(2, 16, 960) == 32 + 128 + 4 * 964 * (8 + 32)
    assert xk._gather_smem_bytes(2, 7, 132) == 32 + 64 + 4 * 132 * (8 + 14)


def test_row_stride_spreads_the_banks():
    """At every D up to 1,024, rows and queries start an odd number of
    16-byte units apart, so the 8 rows and 4 query chunks a warp reads at a
    step fall in distinct banks, and every row copy lands on a 16-byte
    boundary."""
    for d in range(4, 1025, 4):
        rs = (xk._gather_smem_bytes(1, 1, d) - 48) // (4 * 9)  # one stage of one row
        assert rs in (d, d + 4) and (rs // 4) % 2 == 1 and rs % 4 == 0
        assert len({(j * rs // 4) % 8 for j in range(8)}) == 8


def _dealt(r_total: int, grid: int, group: int):
    """The kernel's dealing of ids, transliterated: for each block, its
    stream length ``len`` and, group by group, the id positions it scores."""
    tiles = -(-r_total // TILE_ROWS)
    seen = []
    for b in range(grid):
        my_tiles = (tiles - 1 - b) // grid + 1
        last = b + (my_tiles - 1) * grid
        length = (my_tiles - 1) * TILE_ROWS + min(TILE_ROWS, r_total - last * TILE_ROWS)
        for g in range(-(-length // group)):
            first = g * group
            count = min(group, length - first)
            assert 1 <= count <= group
            for s in range(first, first + count):
                seen.append((b + s // TILE_ROWS * grid) * TILE_ROWS + s % TILE_ROWS)
    return seen


@pytest.mark.parametrize("r_total,grid,group", [
    (1, 1, 16), (TILE_ROWS - 3, 1, 1), (TILE_ROWS + 1, 2, 16), (8192, 512, 16), (8192, 264, 64),
    (16_384, 1024, 7), (262_144, 2112, 16), (262_145, 2112, 64), (1000, 7, 33)])
def test_every_row_dealt_once(r_total, grid, group):
    tiles = -(-r_total // TILE_ROWS)
    assert grid <= tiles  # the launch caps the grid at the tile count
    seen = _dealt(r_total, grid, group)
    assert sorted(seen) == list(range(r_total))


def _inputs(n=64, d=16, r=40, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, n, r, dtype=np.int32)))


@pytest.fixture
def no_launch(monkeypatch):
    """Route the wrapper as if its tensors lay on the card, and record the
    launches it would make instead of making them."""
    launched = []
    monkeypatch.setattr(xk, "_kernel_route", lambda *t: False)
    monkeypatch.setattr(xk, "_launch", lambda *a: launched.append(a))
    return launched


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("bad", ["corpus_misaligned", "q_misaligned", "corpus_strided",
                                 "idx_strided", "q_strided"])
def test_refuses_layout_before_launch(no_launch, bad):
    q, corpus, idx = _inputs()
    if bad == "corpus_misaligned":
        corpus = _misaligned(corpus)
        assert corpus.data_ptr() % 16 == 4
    elif bad == "q_misaligned":
        q = _misaligned(q)
    elif bad == "corpus_strided":
        corpus = torch.cat([corpus, corpus], 1)[:, ::2]
    elif bad == "idx_strided":
        idx = torch.stack([idx, idx], 1)[:, 0]
    else:
        q = q.T.contiguous().T
    with pytest.raises(ValueError):
        xk.row_gather_scores(q, corpus, idx)
    assert no_launch == []


@pytest.mark.parametrize("kwargs,err", [
    ({"group": 0}, ValueError), ({"group": 65}, ValueError), ({"stages": 3}, ValueError),
    ({"dtype": torch.float64}, TypeError), ({"idx_dtype": torch.int64}, TypeError),
    ({"d": 6}, ValueError), ({"queries": 4}, ValueError), ({"r": 0}, ValueError)])
def test_refuses_shape_before_launch(no_launch, kwargs, err):
    d = kwargs.get("d", 16)
    q, corpus, idx = _inputs(d=d, r=kwargs.get("r", 40))
    q = q[: kwargs.get("queries", 8)].to(kwargs.get("dtype", torch.float32))
    idx = idx.to(kwargs.get("idx_dtype", torch.int32))
    with pytest.raises(err):
        xk.row_gather_scores(q, corpus, idx, group=kwargs.get("group", 16),
                             stages=kwargs.get("stages", 1))
    assert no_launch == []


@pytest.mark.parametrize("stages,d", [(1, 960), (2, 960), (2, 128), (1, 2048)])
def test_refuses_stages_over_shared_memory(no_launch, stages, d):
    """The largest group whose stages fit launches; one more row raises."""
    fit = max((g for g in range(1, 65) if xk._gather_smem_bytes(stages, g, d)
               <= xk._GATHER_SMEM_MAX), default=0)
    q, corpus, idx = _inputs(d=d)
    if fit < 64:
        with pytest.raises(ValueError, match="shared memory"):
            xk.row_gather_scores(q, corpus, idx, group=fit + 1, stages=stages)
        assert no_launch == []
    if fit:
        xk.row_gather_scores(q, corpus, idx, group=fit, stages=stages)
        assert len(no_launch) == 1


@pytest.mark.parametrize("stages", [1, 2])
def test_launch_arguments_in_entry_order(no_launch, stages):
    q, corpus, idx = _inputs(n=100, d=20, r=33)
    out = xk.row_gather_scores(q, corpus, idx, group=5, stages=stages)
    (launches, counter, lib, symbol, argtypes, *args), = no_launch
    assert launches is xk.LAUNCHES and lib == "row_gather" and symbol == "row_gather_launch"
    assert counter == ("row_gather" if stages == 1 else "row_gather_db")
    assert len(argtypes) == len(args) == 9  # every argument up to the stream
    assert all(a is b for a, b in zip(args[:4], (q, corpus, idx, out)))
    assert args[4:] == [100, 20, 33, 5, stages]
    assert out.shape == (8, 33) and out.dtype == torch.float32


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("d", [4, 132])
def test_cpu_path_is_the_plain_version(stages, d):
    """CPU tensors take the plain version, repeated ids and the last row
    included; an id out of range raises there."""
    q, corpus, idx = _inputs(n=50, d=d, r=70, seed=d)
    idx[:4] = 49
    out = xk.row_gather_scores(q, corpus, idx, group=3, stages=stages)
    assert torch.equal(out, xk.row_gather_scores_ref(q, corpus, idx))
    assert torch.equal(out[:, 0], out[:, 3])
    idx[5] = 50
    with pytest.raises(IndexError):
        xk.row_gather_scores(q, corpus, idx, group=3, stages=stages)
