"""The four kernel experiments of ``benchmarks/`` against their port.

Every Pallas function defined in an experiment script (``_k_v1``, ``_k_v2``,
``_k_v2h``, ``_k_v3``, ``_k_v5`` of ``exp_sq8i_v2.py``; ``_bucket_kernel`` of
``exp_topk.py``; ``_k_hm``, ``_k_hme`` of ``exp_hamming_mxu.py``; ``kern``,
``kern_db`` of ``exp_gather_kernel.py``) is read from its script with ``ast``
and executed, with the script's own wrapper, in a namespace that holds JAX,
Pallas, the script's constants and the JAX package's helpers it imports. The
scripts are neither edited nor imported. Each ``pallas_call`` is constructed
inside ``pltpu.force_tpu_interpret_mode()`` and runs with JIT disabled, and a
stand-in for ``pl`` records its inputs and outputs; the port's plain
counterpart then runs on those same inputs (numpy, from a seed):

- exact, bit for bit: ``_k_v3`` (``sq8i_v2_bucket_ref`` v3), ``_k_v5`` and
  ``_k_hme`` (#1's ``sq8pd_bucket_gm_ref``), ``_k_hm`` (#5's
  ``hamming_mxu_ref``);
- ``_k_v1`` (#7's ``sq8i_bucket_ref``) and ``_k_v2`` (v2): each bucket
  maximum within ``1e-6 |gm| + 2^-22 A``, A the sum of the three epilogue
  terms' magnitudes at the winner (#7's rtol 1e-6, plus two ulps of A: v2
  sums the terms in another order, and XLA may contract one product into an
  FMA);
- ``_k_v2h`` (v2h): within one bf16 ulp of the winner's largest term;
- ``_bucket_kernel`` (#2 on f32 rows, #2b's plain version on bf16 rows, on
  the doubled queries): rtol 1e-5 + 1e-5, the float-bucket tests' bound;
- ``kern`` and ``kern_db`` (``row_gather_scores_ref``): ``1e-6 |ref| +
  D 2^-24 sum_d |q_d c_d|``, the other order of the same fp32 sum.

Where a bound is not zero, a bucket may name another row only if the port's
score of that row lies within the bound of the port's maximum (a near tie);
all ``-inf`` buckets must match exactly. Then each ported ``exp_*`` module runs
its ``main()`` on ``--device cpu`` at a small size and its recall lines are
checked, and the two Hamming rerank ops the experiments use are held to the
JAX package's.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.ops.bucket_kernel as tbk
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops.quantization import binary_quantize as j_binary
from velesdb_tpu.ops.quantization import sq8_quantize as j_sq8
from velesdb_tpu_torch.experiments import exp_gather_kernel, exp_hamming_mxu, exp_sq8i_v2
from velesdb_tpu_torch.experiments import exp_topk
from velesdb_tpu_torch.experiments import kernels as xk
from velesdb_tpu_torch.ops.quantization import binary_quantize as t_binary

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
CHUNK = 1024


def _script(name: str, names, scope: str = "main", **consts):
    """The named function definitions and assignments of ``benchmarks/<name>``
    (inside ``main()``, or at module level), executed in source order in a
    namespace of JAX, Pallas, ``consts`` and the JAX package's helpers the
    script imports. Returns the namespace and the list that the stand-in
    ``pl.pallas_call`` appends ``(inputs, outputs)`` to."""
    with open(os.path.join(BENCH, name)) as f:
        tree = ast.parse(f.read())
    body = tree.body
    if scope == "main":
        body = next(n for n in body if isinstance(n, ast.FunctionDef) and n.name == "main").body

    def named(node):
        if isinstance(node, ast.FunctionDef):
            return node.name in names
        return isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id in names for t in node.targets)

    calls = []

    def pallas_call(*args, **kwargs):
        run = pl.pallas_call(*args, **kwargs)

        def recorded(*inputs):
            out = run(*inputs)
            calls.append((inputs, out))
            return out

        return recorded

    stand_in = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                        if not k.startswith("__")})
    stand_in.pallas_call = pallas_call
    ns = dict(jax=jax, jnp=jnp, pl=stand_in, pltpu=pltpu, functools=functools, np=np,
              _LANES=128, _bucket_select=jbk._bucket_select, _final_select=jbk._final_select,
              _restore_euclidean=jbk._restore_euclidean, **consts)
    nodes = [n for n in body if named(n)]
    found = {n.name if isinstance(n, ast.FunctionDef) else n.targets[0].id for n in nodes}
    assert found == set(names)
    exec(compile(ast.Module(body=nodes, type_ignores=[]), name, "exec"), ns)
    return ns, calls


def _interpret(fn, *args, **kwargs):
    """``fn`` with its Pallas calls in TPU interpret mode and JIT off, so the
    recorded outputs are concrete."""
    with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
        return fn(*args, **kwargs)


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _hold(gm_j, gi_j, gm_t, gi_t, s_t, tol) -> int:
    """The JAX bucket winners ``(gm_j, gi_j)`` against the port's ``(gm_t,
    gi_t)``, with the port's full score matrix ``s_t`` and a bound ``tol``
    per bucket (0 for exact). Returns the count of near-tie id swaps."""
    gm_j, gi_j = np.asarray(gm_j, np.float64), np.asarray(gi_j).astype(np.int64)
    gm_t, gi_t = gm_t.double().numpy(), gi_t.long().numpy()
    s_t = s_t.double().numpy()
    dead = np.isneginf(gm_t)
    assert np.array_equal(dead, np.isneginf(gm_j))
    assert np.array_equal(gi_j[dead], gi_t[dead])
    live = ~dead
    err = np.abs(gm_j[live] - gm_t[live])
    assert np.all(err <= tol[live]), float(np.max(err - tol[live]))
    swap = gi_j != gi_t
    picked = np.take_along_axis(s_t, gi_j, 1)
    assert np.all(np.abs(picked[swap] - gm_t[swap]) <= tol[swap])
    return int(swap.sum())


def _sq8_state(rng, n, d, b):
    """SQ8 rows of the script's data (the JAX package's quantizer, as the
    script uses): 15% of rows and the whole last chunk knocked out (pen =
    +inf), so some buckets are all ``-inf``; and ``b`` queries."""
    corpus, queries, _ = exp_sq8i_v2.make_data(n, d, b)
    cf = jnp.pad(jnp.asarray(corpus), ((0, 0), (0, 128 - d)))
    sq = j_sq8(cf)
    rows8 = jbk.sq8_int8_rows(sq.codes)
    deq = sq.codes.astype(jnp.float32) * sq.scale[:, None] + sq.minv[:, None]
    valid = rng.random(n) >= 0.15
    valid[-CHUNK:] = False
    pen = jnp.where(jnp.asarray(valid), jnp.sum(deq * deq, axis=1), jnp.inf)
    q = jnp.pad(jnp.asarray(queries), ((0, 0), (0, 128 - d)))
    return q, rows8, sq.scale.astype(jnp.float32), sq.minv.astype(jnp.float32), pen


def _sq8_terms(qi, rows8, scale, am, pen, sqi, iq):
    """``(d*scale, sqi*am, iq*pen)`` per (query, row), the three epilogue
    terms."""
    d = tbk._int8_dot(qi, rows8).float()
    return d * scale[None, :], sqi[:, None] * am[None, :], iq[:, None] * pen[None, :]


def _at(t, gi):
    return torch.gather(t, 1, gi.long())


def _case_v1_v2(variant):
    rng = np.random.default_rng(1)
    b = 13 if variant == "v1" else 8
    q, rows8, scale, minv, pen = _sq8_state(rng, 4096, 100, b)
    ns, calls = _script("exp_sq8i_v2.py", ("_k_v1", "_k_v2", "_common_prep", "make_call"))
    kern, n_aux_q = (ns["_k_v1"], 1) if variant == "v1" else (ns["_k_v2"], 2)
    _interpret(ns["make_call"](kern, n_aux_q), q, rows8, scale, minv, pen, k=10, chunk=CHUNK)
    (inputs, (gm_j, gi_j)), = calls
    qi, r8, aux = _t(inputs[0]), _t(inputs[1]), _t(inputs[2])
    if variant == "v1":
        iq = _t(inputs[3])[:, 0]
        sqi = qi.float().sum(1)
        gm_t, gi_t = tbk.sq8i_bucket_ref(qi, r8, aux[0], aux[1], aux[2], sqi, iq, CHUNK)
        terms = _sq8_terms(qi, r8, aux[0], aux[1], aux[2], sqi, iq)
        s_t = (terms[0] + terms[1]) - terms[2]
    else:
        qaux = _t(inputs[3])
        gm_t, gi_t = xk.sq8i_v2_bucket_ref(qi, r8, aux, qaux, CHUNK, "v2")
        terms = _sq8_terms(qi, r8, aux[0], aux[1], aux[2], qaux[:, 1], qaux[:, 2])
        s_t = terms[0] + (terms[1] + terms[2])
    a = sum(_at(t.abs(), gi_t) for t in terms)
    tol = 1e-6 * gm_t.abs() + 2.0**-22 * a
    _hold(gm_j, gi_j, gm_t, gi_t, s_t, tol.double().numpy())
    assert np.isneginf(np.asarray(gm_j)).any()


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _case_v2h():
    rng = np.random.default_rng(2)
    q, rows8, scale, minv, pen = _sq8_state(rng, 4096, 100, 13)
    ns, calls = _script("exp_sq8i_v2.py", ("_k_v2h", "_common_prep", "make_call"))
    _interpret(ns["make_call"](ns["_k_v2h"], 2, aux_dtype=jnp.bfloat16), q, rows8, scale, minv,
               pen, k=10, chunk=CHUNK)
    (inputs, (gm_j, gi_j)), = calls
    qi, r8, aux, qaux = (_t(x) for x in inputs)
    gm_t, gi_t = xk.sq8i_v2_bucket_ref(qi, r8, aux, qaux, CHUNK, "v2h")
    a, qa = aux[:3].float(), qaux.float()
    d = _bf16(tbk._int8_dot(qi, r8).float())
    t1 = _bf16(d * a[0][None, :])
    corr = _bf16(qa[:, 1, None] * a[1][None, :] + qa[:, 2, None] * a[2][None, :])
    s_t = _bf16(t1 + corr)
    big = torch.maximum(_at(t1.abs(), gi_t), _at((qa[:, 1, None] * a[1][None, :]).abs(), gi_t))
    big = torch.maximum(big, _at((qa[:, 2, None] * a[2][None, :]).abs(), gi_t))
    ulp = 2.0 ** (torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)  # bf16: 8 significant bits
    _hold(gm_j, gi_j, gm_t, gi_t, s_t, ulp.double().numpy())


def _case_v3():
    rng = np.random.default_rng(3)
    q, rows8, scale, minv, pen = _sq8_state(rng, 2048, 100, 8)
    ns, calls = _script("exp_sq8i_v2.py", ("_k_v3", "_common_prep", "call_v3"))
    _interpret(ns["call_v3"], q, rows8, scale, minv, pen, k=10, chunk=CHUNK)
    (inputs, (gm_j, gi_j)), = calls
    qi, r8 = _t(inputs[0]), _t(inputs[1])
    gm_t, gi_t = xk.sq8i_v2_bucket_ref(qi, r8, None, None, CHUNK, "v3")
    np.testing.assert_array_equal(np.asarray(gm_j), gm_t.numpy())
    np.testing.assert_array_equal(np.asarray(gi_j), gi_t.numpy())


def _case_v5():
    rng = np.random.default_rng(5)
    n, d, b = 4096, 100, 13
    corpus, queries, _ = exp_sq8i_v2.make_data(n, d, b)
    cf = np.pad(corpus, ((0, 0), (0, 28)))
    mid = (cf.max(0) + cf.min(0)) * 0.5
    sdim = np.where(cf.max(0) > cf.min(0), (cf.max(0) - cf.min(0)) / 254.0, 1.0).astype(np.float32)
    rows_pd = np.clip(np.round((cf - mid) / sdim), -127, 127).astype(np.int8)
    deq = rows_pd.astype(np.float32) * sdim + mid
    qp = np.pad(queries, ((0, 0), (0, 28)))
    qu = float(np.abs(2.0 * qp * sdim).max()) / 127.0 * 1.1
    pen_int = np.round((deq * deq).sum(1) / qu).astype(np.int32)
    pen_int[rng.random(n) < 0.15] = 1 << 24
    ptile = (pen_int * -64 + (np.arange(n) % CHUNK) // 128).astype(np.int32)
    ns, calls = _script("exp_sq8i_v2.py", ("_k_v5", "make_call_v5"))
    call = ns["make_call_v5"](qu, jnp.asarray(sdim), jnp.asarray(mid.astype(np.float32)))
    _interpret(call, jnp.asarray(qp), jnp.asarray(rows_pd), jnp.asarray(ptile), k=10, chunk=CHUNK)
    (inputs, (gm_j,)), = calls
    qi, rp, pt8 = (_t(x) for x in inputs)
    want = tbk.sq8pd_bucket_gm_ref(qi, rp, pt8[0], CHUNK)
    np.testing.assert_array_equal(np.asarray(gm_j), want.numpy())


def _case_bucket():
    rng = np.random.default_rng(6)
    n, b = 4096, 13
    corpus = np.pad(exp_topk.gen_corpus(0, n, 100), ((0, 0), (0, 28)))
    q = np.pad(exp_topk.gen_corpus(99, b, 100), ((0, 0), (0, 28)))
    cn = (corpus.astype(np.float32) ** 2).sum(1)
    cn[rng.random(n) < 0.15] = np.inf
    ns, calls = _script("exp_topk.py", ("_bucket_kernel", "make_bucket"), scope="module")
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        calls.clear()
        _interpret(ns["make_bucket"](10, CHUNK), jnp.asarray(q), jnp.asarray(corpus).astype(jdt),
                   jnp.asarray(cn))
        (inputs, (gm_j, gi_j)), = calls
        qj, rows, cn8 = (_t(x) for x in inputs)
        q2 = torch.nn.functional.pad(2.0 * qj, (0, 0, 0, 3)).to(tdt)
        gm_t, gi_t = tbk.dense_bucket_gm(q2, rows, cn8[0], CHUNK)
        s_t = tbk._ordered_dot(q2, rows) - cn8[0][None, :]
        tol = 1e-5 * gm_t[:b].abs() + 1e-5
        _hold(gm_j, gi_j, gm_t[:b], gi_t[:b], s_t[:b], tol.double().numpy())


def _bits_state(rng, n, b, chunk):
    x = rng.standard_normal((n + b, 100)).astype(np.float32)
    bits = np.pad((x >= 0).astype(np.int8), ((0, 0), (0, 28)))
    csum = bits[:n].astype(np.int32).sum(1)
    aux = np.where(rng.random(n) >= 0.15, csum, csum + (1 << 20)).astype(np.int32)
    ptile = (aux * -64 + (np.arange(n) % chunk) // 128).astype(np.int32)
    return jnp.asarray(bits[n:]), jnp.asarray(bits[:n]), jnp.asarray(aux), jnp.asarray(ptile)


def _case_hm():
    qbits, bits, aux, _ = _bits_state(np.random.default_rng(7), 4096, 13, 2048)
    ns, calls = _script("exp_hamming_mxu.py", ("_k_hm", "hamming_mxu_topk"), _BIG=1 << 20)
    _interpret(ns["hamming_mxu_topk"], qbits, bits, aux, k=10, chunk=2048)
    (inputs, (gm_j, gi_j)), = calls
    qi, rb, aux8 = (_t(x) for x in inputs)
    gm_t, gi_t = tbk.hamming_mxu_ref(qi, rb, aux8[0], 2048)
    np.testing.assert_array_equal(np.asarray(gm_j), gm_t.numpy())
    np.testing.assert_array_equal(np.asarray(gi_j), gi_t.numpy())


def _case_hme():
    qbits, bits, _, ptile = _bits_state(np.random.default_rng(8), 8192, 8, 2048)
    ns, calls = _script("exp_hamming_mxu.py", ("_k_hme", "hamming_enc_topk"), _BIG=1 << 20)
    _interpret(ns["hamming_enc_topk"], qbits, bits, ptile, k=10, chunk=2048)
    (inputs, (gm_j,)), = calls
    qi, rb, pt8 = (_t(x) for x in inputs)
    want = tbk.sq8pd_bucket_gm_ref(qi, rb, pt8[0], 2048)
    np.testing.assert_array_equal(np.asarray(gm_j), want.numpy())


def _case_gather(name):
    n, d, r, g = 4096, 128, 256, 16
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    idx = rng.integers(0, n, r, dtype=np.int32)
    idx[:3] = n - 1  # repeated ids, the last row
    call_name = "call" if name == "kern" else "call_db"
    spec_name = "grid_spec" if name == "kern" else "grid_spec_db"
    with pltpu.force_tpu_interpret_mode():
        ns, _ = _script("exp_gather_kernel.py", (name, spec_name, call_name), N=n, D=d, R=r, G=g,
                        args=types.SimpleNamespace(interpret=False))
        got = np.asarray(ns[call_name](jnp.asarray(idx), jnp.asarray(q), jnp.asarray(corpus)))
    qt, ct, it = torch.from_numpy(q), torch.from_numpy(corpus), torch.from_numpy(idx)
    ref = xk.row_gather_scores_ref(qt, ct, it).numpy()
    a = (np.abs(q)[:, None, :] * np.abs(corpus[idx])[None, :, :]).sum(-1)
    np.testing.assert_array_less(np.abs(got - ref), 1e-6 * np.abs(ref) + d * 2.0**-24 * a + 1e-30)


CASES = {
    "_k_v1": lambda: _case_v1_v2("v1"),
    "_k_v2": lambda: _case_v1_v2("v2"),
    "_k_v2h": _case_v2h,
    "_k_v3": _case_v3,
    "_k_v5": _case_v5,
    "_bucket_kernel": _case_bucket,
    "_k_hm": _case_hm,
    "_k_hme": _case_hme,
    "kern": lambda: _case_gather("kern"),
    "kern_db": lambda: _case_gather("kern_db"),
}


@pytest.mark.parametrize("pallas_function", list(CASES))
def test_experiment_kernel_equals_port_plain_version(pallas_function):
    """One experiment Pallas function, run from its own script in interpret
    mode, against the port's plain counterpart on the same inputs."""
    CASES[pallas_function]()


def test_exp_sq8i_v2_main_on_cpu(monkeypatch):
    monkeypatch.setenv("EXP_N", "8192")
    monkeypatch.setenv("EXP_B", "16")
    monkeypatch.setattr(exp_sq8i_v2, "ITERS", 2)
    monkeypatch.setattr(exp_sq8i_v2, "SAMPLES", 1)
    out = exp_sq8i_v2.main(["--device", "cpu"])
    r = {k: v["recall"] for k, v in out["results"].items()}
    assert set(r) == {"v0", "v1", "v2", "v2h", "v3", "a16", "a16v2", "v5", "a16v5", "a32v5"}
    assert out["device"] == "cpu"
    assert r["v1"] == r["v0"]  # the same function on the same rows
    assert abs(r["v2"] - r["v0"]) <= 0.02 and r["v0"] >= 0.9
    assert min(r["a16"], r["a16v2"], r["a16v5"], r["a32v5"]) >= 0.95
    assert r["v3"] < r["v0"]  # no affine: a lower bound, wrong for euclidean
    assert all(v["nan"] == 0.0 and v["ms_per_batch"] > 0 for v in out["results"].values())


def test_exp_hamming_mxu_main_on_cpu(monkeypatch):
    monkeypatch.setenv("EXP_N", "20000")
    monkeypatch.setenv("EXP_B", "16")
    monkeypatch.setattr(exp_hamming_mxu, "ITERS", 2)
    monkeypatch.setattr(exp_hamming_mxu, "SAMPLES", 1)
    out = exp_hamming_mxu.main(["--device", "cpu"])
    res = out["results"]
    assert set(res) == {"h0", "hm", "hm8", "hme2", "hme8", "h0r", "hmr", "hmer"}
    # #4 and #5 compute the same distances at one chunk: the same winners
    assert out["agreement"]["hm"] == {"max_abs_dist": 0.0, "id_overlap": 1.0}
    assert res["h0r"]["recall"] == res["hmr"]["recall"] > 0.2
    assert abs(res["hmer"]["recall"] - res["hmr"]["recall"]) <= 0.05
    assert all(np.isnan(res[k]["recall"]) for k in ("h0", "hm", "hm8", "hme2", "hme8"))


def test_exp_topk_main_on_cpu():
    out = exp_topk.main(["--device", "cpu", "--n", "20000", "--d", "64", "--b", "16",
                         "--chunk", "8192", "--pchunk", "2048", "--iters", "2", "--samples", "1",
                         "--variants", ",".join(exp_topk.PORTED)])
    r = {k: v["recall"] for k, v in out["results"].items()}
    assert r["scan_exact"] == r["scan_approx"] == r["pallas"] == 1.0
    assert r["bucket"] == r["bucket_approx"] >= 0.97
    assert r["bucket_bf16"] >= 0.95
    assert out["results"]["bucket_approx"]["selection"] == "exact"
    with pytest.raises(SystemExit):
        exp_topk.main(["--device", "cpu", "--variants", "lean"])


def test_exp_gather_kernel_main_on_cpu():
    out = exp_gather_kernel.main(["--device", "cpu", "--n", "5000", "--r", "256", "--iters", "2"])
    res = out["results"]
    assert set(res) == {"baseline", "row-gather", "row-gather double-buffered"}
    for name in ("row-gather", "row-gather double-buffered"):
        assert res[name]["max_abs_err_vs_baseline"] <= 1e-4


def test_experiments_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="GPU"):
        exp_gather_kernel.main(["--n", "100", "--r", "16", "--iters", "1"])


@pytest.mark.parametrize("kind", ["packed", "bit-plane"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_hamming_rerank_ops_match_reference(kind, metric):
    """``hamming_rerank_topk`` (#4 coarse) and ``hamming_mxu_rerank_topk`` (#5
    coarse), then the exact rerank, against the JAX package's on the same
    unit rows: the same coarse candidates, so the same ids wherever the next
    exact score is more than 1e-5 away, values to rtol 1e-5 (fp32 sums in
    another order; euclidean: the reference expands |q|^2 + |c|^2 - 2 q.c)."""
    rng = np.random.default_rng(11)
    n, d, b = 8192, 100, 13
    centers = rng.standard_normal((512, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 512, n)] + 0.7 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    corpus = x
    q = corpus[rng.integers(0, n, b)] + 0.02 * rng.standard_normal((b, d)).astype(np.float32)
    pen = np.where(rng.random(n) >= 0.1, 0.0, np.inf).astype(np.float32)
    jm, m = JMetric.parse(metric), 64
    qt, ct = torch.from_numpy(q), torch.from_numpy(corpus)
    if kind == "packed":
        jv, ji = jbk.hamming_rerank_topk(jnp.asarray(q), j_binary(jnp.asarray(q)),
                                         j_binary(jnp.asarray(corpus)), jnp.asarray(pen),
                                         jnp.asarray(corpus), k=10, m=m, metric=jm, chunk=2048,
                                         interpret=True)
        tv, ti = tbk.hamming_rerank_topk(qt, t_binary(qt), t_binary(ct), torch.from_numpy(pen), ct,
                                         k=10, m=m, metric=metric)
    else:
        bits = np.pad((corpus >= 0).astype(np.int8), ((0, 0), (0, 28)))
        qb = np.pad((q >= 0).astype(np.int8), ((0, 0), (0, 28)))
        csum = bits.astype(np.int32).sum(1)
        aux = np.where(np.isfinite(pen), csum, csum + (1 << 20)).astype(np.int32)
        jv, ji = jbk.hamming_mxu_rerank_topk(jnp.asarray(q), jnp.asarray(qb), jnp.asarray(bits),
                                             jnp.asarray(aux), jnp.asarray(corpus), k=10, m=m,
                                             metric=jm, chunk=2048, interpret=True)
        tv, ti = tbk.hamming_mxu_rerank_topk(qt, torch.from_numpy(qb), torch.from_numpy(bits),
                                             torch.from_numpy(aux), ct, k=10, m=m, metric=metric,
                                             chunk=2048)
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    gap = np.abs(np.diff(jv, axis=1)) > 1e-5  # rank j is apart from rank j + 1
    apart = gap[:, :9] & np.concatenate([np.ones((b, 1), bool), gap[:, :8]], 1)
    assert np.array_equal(ti[:, :9][apart], ji[:, :9][apart])
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~np.isfinite(pen)))
