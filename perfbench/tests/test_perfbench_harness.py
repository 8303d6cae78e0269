"""The harness on the CPU: the files it finds by name, the contract of
``BENCHMARK.json``, the result line, the metric arithmetic, the trace
reduction and whole runs of every cell at a small size."""

import ast
import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import perfbench
from perfbench import data, harness, judge, roofline, trace

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# every cell the files describe, those BENCHMARK.json does not list yet too
ALL_CELLS = sorted(p.stem for p in (ROOT / "perfbench" / "workloads").glob("*.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    used = set()
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        four += w["chips"] == 4
    assert used == names and four <= max(1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    everything = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for m in everything:
        assert NAME.match(m["name"]), m["name"]
        assert m.get("better", "lower") in ("lower", "higher")
        assert "unit" not in m or UNIT.match(m["unit"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({m["name"] for m in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    spec = harness.load_spec(cell)
    assert spec.cfg["name"] == spec.cell["config"]
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert {"setup_s"} < {m["name"] for m in spec.end_to_end}
    assert spec.per_layer
    for name, limit in spec.limits.items():
        assert limit is not None and limit >= 0, name


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_every_workload_file_joins_files_that_exist(cell):
    w = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json").read_text())
    assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert (ROOT / "perfbench" / "configs" / f"{w['config']}.json").is_file()
    assert all(v is not None and v >= 0 for v in w["limits"].values())
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    op = perfbench.load("ops", traffic["op"])
    assert callable(op.make_call) and callable(op.reference) and callable(op.numbers)
    model = perfbench.load("data", cfg["data"]["model"])
    assert callable(model.make_dataset) and callable(model.make_pool)
    assert {"name", "dim", "metric"} <= set(cfg["collection"])


def test_files_are_found_by_name_and_nothing_else():
    assert perfbench.load("ops", "search_batch") is perfbench.load("ops", "search_batch")
    for kind, name in [("ops", "no_such_op"), ("data", "no_such_model"), ("metrics", "../run"),
                       ("ops", "")]:
        with pytest.raises(LookupError):
            perfbench.load(kind, name)
    with pytest.raises(harness.SpecError):
        harness.load_reader("no_such_metric")


def test_filters_read_from_the_generated_fields():
    ds = data.Dataset(torch.zeros(4, 1), np.arange(4),
                      {"price": np.array([1.0, 49.9, 50.0, 99.0]), "tag": ["a", "b", "a", "c"]})
    for t, want in [("lt", [1, 1, 0, 0]), ("lte", [1, 1, 1, 0]), ("gt", [0, 0, 0, 1]),
                    ("gte", [0, 0, 1, 1])]:
        got = data.filter_mask({"type": t, "field": "price", "value": 50.0}, ds)
        assert got.tolist() == [bool(w) for w in want], t
    assert data.filter_mask(None, ds) is None
    assert ds.payloads()[1] == {"price": 49.9, "tag": "b"}
    with pytest.raises(ValueError):
        data.filter_mask({"type": "like", "field": "tag", "value": "a%"}, ds)


def test_nothing_of_the_benchmark_imports_jax_and_the_reference_nothing_of_the_program():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "velesdb_tpu"), (path, n)
                if "reference" in path.parts:
                    assert top != "velesdb_tpu_torch", (path, n)


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "from perfbench import harness, control, sets, judge, trace\n"
            "import velesdb_tpu_torch, velesdb_tpu_torch.collection\n"
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "velesdb_tpu")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "velesdb_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.sub", object())
    assert "velesdb_tpu_torch_fake" not in harness.forbidden_modules()
    assert "jaxfake.sub" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "velesdb_tpu.x", object())
    assert "velesdb_tpu.x" in harness.forbidden_modules()


def test_exits_without_a_result_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("the check of a missing card runs where there is none")
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_exits_without_a_result_where_the_program_is_missing(tmp_path):
    (tmp_path / "perfbench").symlink_to(ROOT / "perfbench")
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, "-S", "-c",
                          "import runpy, sys; sys.argv = ['run.py', '--workload', %r, '--seed', "
                          "'1', '--seconds', '1']; sys.path.insert(0, %r); "
                          "import perfbench.harness as h; from pathlib import Path; "
                          "h.ROOT = Path(%r); sys.exit(h.main(sys.argv[1:], 0.0))"
                          % (CELLS[0], str(ROOT), str(tmp_path))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


class _Hit(dict):
    pass


def _results(ids, scores):
    return [[_Hit(id=int(i), score=float(s), payload=None) for i, s in zip(ri, rs)]
            for ri, rs in zip(ids, scores)]


def test_answers_stack_full_and_short_rows():
    a = judge.Answers(3)
    a.add(np.array([0, 1]), _results([[5, 6, 7], [8, 9, 10]], [[1, 2, 3], [4, 5, 6]]))
    a.add(np.array([2]), _results([[11]], [[7]]))
    q, ids, sc, lens = a.stacked()
    assert q.tolist() == [0, 1, 2] and lens.tolist() == [3, 3, 1]
    assert ids.tolist() == [[5, 6, 7], [8, 9, 10], [11, -1, -1]]
    assert sc[2, 0] == 7 and np.isnan(sc[2, 1:]).all()
    assert a.count == 3


class _DS:
    def __init__(self, rows, ids):
        self.rows, self.ids = rows, ids

    @property
    def n(self):
        return self.rows.shape[0]


def test_recall_over_every_answered_query_and_exact_checks():
    rows = torch.tensor([[0.0], [1.0], [2.0], [10.0]])
    b = data.ID_BASE
    ds = _DS(rows, b + np.array([3, 0, 1, 2]))  # row i is upserted as ids[i]
    cfg = {"collection": {"metric": "euclidean"}}
    op = {"op": "search_batch"}

    class Pool:
        vectors = torch.tensor([[0.0], [9.0]])

    ref = judge.Reference(rows=np.array([[0, 1], [3, 2]]), scores=None)
    a = judge.Answers(2)
    a.add(np.array([0, 1]), _results(b + np.array([[3, 0], [2, 1]]), [[0.0, 1.0], [1.0, 7.0]]))
    a.add(np.array([0]), _results(b + np.array([[3, 1]]), [[0.0, 2.0]]))  # one miss of four
    n = judge.judge(cfg, op, ds, Pool, None, ref, a)
    assert n["miss"] == pytest.approx(1 / 6) and n["_recall"] == pytest.approx(5 / 6)
    assert n["score_err"] == 0.0 and n["malformed"] == 0 and n["filtered_out"] == 0
    c = judge.Answers(2)
    c.add(np.array([0, 1]), _results(b + np.array([[3, 3], [2, 999]]), [[0.0, 0.0], [1.0, 1.0]]))
    n = judge.judge(cfg, op, ds, Pool, np.array([True, True, False, True]), ref, c)
    assert n["malformed"] == 2
    ok, rows_ = judge.verdict({"miss": 0.1, "malformed": 0, "_x": 9}, {"miss": 0.2, "malformed": 0})
    assert ok and [r[0] for r in rows_] == ["miss", "malformed"]
    assert not judge.verdict({"miss": 0.3}, {"miss": 0.2})[0]
    assert not judge.verdict({"miss": 0.0}, {})[0]


def _run(**kw):
    spec = harness.load_spec("sift1m-exact-b256")
    run = harness.Run(spec)
    for k, v in kw.items():
        setattr(run, k, v)
    return spec, run


def test_metric_arithmetic():
    calls = [0.001 * (i + 1) for i in range(100)]  # 1 .. 100 ms
    spec, run = _run(calls_s=calls, window_s=2.0, answered=25_600, setup_s=3.5, recall=0.99)
    read = harness.load_reader
    assert read("qps")(run) == pytest.approx(12_800.0)
    assert read("p95_ms")(run) == pytest.approx(np.percentile(np.arange(1, 101), 95))
    assert read("setup_s")(run) == 3.5 and read("recall_at_10")(run) == 0.99
    assert read("host_ms")(run) is None and read("idle_share")(run) is None
    run.profile = trace.Profile(busy_s=0.02, window_s=0.1, calls=10, device_ops=[], idle_gaps=[])
    assert read("host_ms")(run) == pytest.approx(50.5 - 2.0)
    assert read("idle_share")(run) == pytest.approx(80.0)
    assert read("call_p95_ms")(run) == pytest.approx(read("p95_ms")(run))
    least, bound = roofline.exact_search_least_s(256, 1_000_000, 128, 10)
    assert bound == "bytes"
    assert least == pytest.approx((1e6 * 128 + 4 * 256 * 128 + 12 * 2560) / 3.35e12)
    assert least * 1e3 == pytest.approx(0.0383, abs=1e-4)
    assert read("exact_search_roofline")(run) == pytest.approx(100 * least / 0.002)
    run.op = "hybrid_search_batch"
    assert read("exact_search_roofline")(run) is None
    assert read("text_ms")(run) is None
    run.side_s = {"text": [0.03, 0.05]}
    assert read("text_ms")(run) == pytest.approx(40.0)


def test_roofline_counts_follow_the_shapes():
    assert roofline.exact_search_ops(16, 1000, 128) == 2 * 16 * 1000 * 128
    t_ops = roofline.exact_search_ops(4096, 10**6, 128) / 1979e12
    assert roofline.exact_search_least_s(4096, 10**6, 128, 10) == (pytest.approx(t_ops), "ops")
    filt = roofline.exact_search_least_s(256, 500_000, 128, 10)[0]
    assert filt < roofline.exact_search_least_s(256, 10**6, 128, 10)[0]


def test_trace_reduction_busy_union_ops_and_gaps():
    device = [(10.0, 20.0, "k1"), (15.0, 30.0, "k2"), (50.0, 60.0, "k1")]
    host = [(0.0, 100.0, trace.CALL_LABEL), (31.0, 45.0, "aten::topk"), (62.0, 64.0, "aten::x")]
    p = trace.reduce_events(device, host, window_s=1e-4, calls=1)
    assert p.busy_s == pytest.approx(30e-6)
    assert p.device_ops[0] == ("k1", pytest.approx(20e-6))
    gaps = dict(p.idle_gaps)
    assert gaps["aten::topk"] == pytest.approx(20e-6)  # 30 .. 50
    assert gaps[trace.CALL_LABEL] == pytest.approx(50e-6)  # 0 .. 10 and 60 .. 100


class _Ev:
    def __init__(self, start, end, name, device, annotation=False):
        self.time_range = type("TR", (), {"start": start, "end": end})()
        self.name, self.is_user_annotation = name, annotation
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"


def test_labelled_regions_on_the_device_timeline_are_not_device_work():
    events = [_Ev(0, 100, trace.CALL_LABEL, False, True), _Ev(5, 95, trace.CALL_LABEL, True, True),
              _Ev(10, 20, "kernel", True), _Ev(30, 40, "span", True, True)]
    device, host = trace.split_events(events)
    assert device == [(10.0, 20.0, "kernel")]
    assert host == [(0.0, 100.0, trace.CALL_LABEL)]


def test_result_line_schema():
    spec, run = _run(calls_s=[0.01] * 10, window_s=0.1, answered=2560, setup_s=1.0, recall=1.0)
    numbers = {"malformed": 0, "filtered_out": 0, "miss": 0.0, "score_err": 1e-7, "_recall": 1.0}
    dev = {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 5}
    out = harness.result_line(spec, run, numbers, dev, trace=False)
    assert list(out)[-1] == "checks" and list(out)[:5] == ["correct", "attempted", "failed",
                                                         "metrics", "device"]
    assert set(out["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert out["metrics"]["qps"] == {"value": 25_600.0, "unit": "queries/s"}
    assert out["checks"]["miss"] == {"value": 0.0, "limit": spec.limits["miss"]}
    json.dumps(out)
    run.profile = trace.Profile(0.01, 0.1, 10, [("k", 0.01)], [("h", 0.09)])
    out = harness.result_line(spec, run, numbers, dict(dev, busy_s=0.01, window_s=0.1), trace=True)
    assert set(out["metrics"]) == {"host_ms", "call_p95_ms", "exact_search_roofline",
                                   "idle_share"}
    assert out["breakdown"] == {"device_ops": [["k", 0.01]], "idle_gaps": [["h", 0.09]]}


def small_spec(cell, rows=4096, queries=512):
    if cell in CELLS:
        spec = harness.load_spec(cell)
    else:
        w = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json").read_text())
        entry = {"name": cell, "config": w["config"], "traffic": w["traffic"], "chips": 1}
        cfg = json.loads((ROOT / "perfbench" / "configs" / f"{w['config']}.json").read_text())
        traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
        spec = harness.Spec(cell, entry, cfg, traffic, w["limits"],
                            [m for m in BENCH["end_to_end"] if "workloads" not in m], [])
    spec.cfg["rows"], spec.cfg["queries"] = rows, queries
    return spec


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(harness, "INGEST_CHUNK", 1500)


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_run_of_each_cell_is_correct(cell, traced, tmp_path, two_threads, small_chunks):
    spec = small_spec(cell)
    run, numbers, dev, loaded = harness.run_cell(spec, 2**31 + 99, 0.5, traced, time.perf_counter(),
                                                 device="cpu", workdir=str(tmp_path),
                                                 log=lambda m: None)
    out = harness.result_line(spec, run, numbers, dev, traced)
    assert out["correct"], out["checks"]
    assert loaded == [] and out["attempted"] == run.answered > 0
    assert out["attempted"] % spec.traffic["batch"] == 0
    assert run.recall == pytest.approx(1.0)
    assert ("text" in run.side_s) == (traced and spec.traffic.get("query_text") is not None)
    if traced:
        assert run.profile is not None and run.profile.calls >= 8
        # on the CPU no operation runs on a card: the roofline reads nothing
        names = {m["name"] for m in spec.per_layer}
        assert set(out["metrics"]) == names - {"exact_search_roofline"}
    else:
        assert {m["name"] for m in spec.end_to_end} == set(out["metrics"])
    assert list(tmp_path.iterdir()) == []


def test_sets_spread_and_host_probe():
    from perfbench import sets

    med, sp = sets.spread([1.0, 2.0, 3.0, 4.0, 5.0])
    q1, _, q3 = __import__("statistics").quantiles([1.0, 2.0, 3.0, 4.0, 5.0], n=4)
    assert med == 3.0 and sp == pytest.approx((q3 - q1) / 3.0)
    assert sets.spread([7.0]) == (7.0, None)
    probe = sets.HostProbe(0.01)
    time.sleep(0.2)
    got = probe.stop()
    assert got["probes"] >= 1 and 0 < got["probe_min_ms"] <= got["probe_ms"] <= got["probe_max_ms"]
