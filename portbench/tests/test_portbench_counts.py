"""Counts, readers and the manifest: the FLOP and byte counts against hand
counts at small shapes, each per-layer reader on a synthetic span tree or
profile, and ``BENCHMARK.json`` against the contract's rules and the files
it names."""
import json
import re
import types

import numpy as np
import pytest

from portbench import counts, harness, peaks, profiling

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


# -- counts -----------------------------------------------------------------

def kernel_tree_combines(n: int) -> int:
    """The scan kernel's phase loop (``lqt_scan.cu``), counted."""
    L = 0
    while (n >> (L + 1)) > 0:
        L += 1
    P = L + (L if L > 0 else 1)
    total = 0
    for p in range(P):
        down = p < L
        l = p if down else P - 1 - p
        total += (n >> (l + 1)) if down else ((n >> l) - 1) // 2
    return total


@pytest.mark.parametrize("n,want", [(1, 0), (2, 1), (3, 2), (4, 4), (5, 5),
                                    (8, 11), (9, 12)])
def test_scan_combines_hand_counts(n, want):
    # an inclusive scan of n elements needs at least n - 1 combines; the
    # tree's up and down sweeps do 2n - 2 - log2 n for n a power of two
    assert counts.scan_combines(n) == want == kernel_tree_combines(n)


def test_combine_and_bytes_hand_counts():
    # nx = 1: 9 products + 6 matrix-vector products of one multiply-add
    # (15), Gauss-Jordan 1 + 2 = 3, additions 1 + 2 + 3 + 6 = 12
    assert counts.combine_flops(1) == 30
    # nx = 2: 9 * (16 - 4) + 6 * (8 - 2) = 144, Gauss-Jordan 2 * (1 + 4 +
    # 8) = 26, additions 2 + 4 + 6 + 24 = 36
    assert counts.combine_flops(2) == 206
    # 3 elements of 2 rows, nx = 1: (A, C, J) + (b, eta) = 5 values, read
    # and written once, 8 bytes each
    assert counts.scan_bytes(3, 2, 1, 8) == 2 * 3 * 2 * 5 * 8


def test_solve_flops_hand_count():
    # nx = ny = 1, one block of one substep, one row: per substep
    # element 13, value step 2+1+(2/3+4)+4+2+1+2+1+1 = 18 2/3, recovery
    # map 2+1+2+1+(2/3+4) = 10 2/3, application 3; no in-block combines;
    # the scan of 2 elements: one combine (30); the affine prefix 2 * 5
    want = 13 + 18 + 2 / 3 + 10 + 2 / 3 + 3 + 30 + 10
    assert counts.solve_flops(1, 1, 1, 1, 1) == pytest.approx(want)
    # rows and passes multiply; linearisation adds 1 + 1 + 2 + 1 + 2 + 1
    assert counts.solve_flops(1, 1, 3, 1, 1, 2, True) == pytest.approx(
        6 * (want + 8))


def test_record_flops_hand_count():
    # nx = ny = 1, 3 substeps in blocks of 2: two blocks (2 + 1), so one
    # in-block combine (30 + 5); per substep 13 + 18 2/3 + 10 2/3 + 3; the
    # scan of 3 elements: 2 combines; the affine prefix 2 * 2 * 5
    per = 13 + 18 + 2 / 3 + 10 + 2 / 3 + 3
    want = 3 * per + 35 + 2 * 30 + 20
    assert counts.record_flops(3, 2, 1, 1) == pytest.approx(want)
    # a stacked solve is its rows' records
    assert counts.solve_flops(2, 2, 5, 1, 1) == pytest.approx(
        5 * counts.record_flops(4, 2, 1, 1))


# -- readers ----------------------------------------------------------------

def ctx(**kw):
    base = dict(config=harness.load_json(
        harness.ROOT / "configs" / "wiener-velocity.json"),
        window_s=10.0, setup_s=4.5, latencies_s=np.array([]), completed=0,
        spans=[], counters={}, profile=None, solves=[], record_lengths=[],
        ny=2, itemsize=8)
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, c):
    return harness.reader(name)(c)


def profile():
    # host ranges in us: two waves of 100 us; device: the scan 10 us, a
    # GEMM 40 us, and the device copy of a host range (dropped)
    cpu = [("portbench.wave", 0.0, 100.0), ("portbench.wave", 100.0, 200.0),
           ("portbench.step", 0.0, 60.0), ("aten::mm", 10.0, 20.0),
           ("portbench.collect", 60.0, 100.0), ("cudaMemcpyAsync", 65.0, 99.0)]
    dev = [("void lqt_scan_kernel<4, double>(ScanArgs<double>)", 30.0, 40.0),
           ("gemm", 110.0, 150.0), ("portbench.wave", 0.0, 100.0)]
    return profiling.Profile(cpu, dev)


def test_e2e_readers():
    c = ctx(latencies_s=np.arange(1, 101) / 1e3, completed=100)
    assert read("records_per_s", c) == 10.0
    assert read("record_p95_ms", c) == pytest.approx(95.05)
    assert read("trajectory_ms", c) == 100.0
    assert read("setup_s", c) == 4.5
    assert read("record_p95_ms", ctx()) is None
    assert read("trajectory_ms", ctx()) is None


def test_engine_readers():
    spans = [{"name": "engine.step", "dur_s": 0.010,
              "children": [{"name": "estimator.solve", "dur_s": 0.006}]},
             {"name": "engine.step", "dur_s": 0.020,
              "children": [{"name": "estimator.solve", "dur_s": 0.015}]}]
    assert read("engine.host_ms", ctx(spans=spans)) == pytest.approx(4.5)
    assert read("engine.host_ms", ctx()) is None
    c = ctx(counters={"gauges": {"engine.padding_waste": 0.25}})
    assert read("engine.padding_waste", c) == 25.0
    assert read("engine.padding_waste", ctx()) is None


def test_profile_busy_idle_and_breakdown():
    p = profile()
    assert p.window_s == pytest.approx(200e-6)
    assert p.busy_s == pytest.approx(50e-6)
    assert read("device_idle.batch", ctx(profile=p)) == pytest.approx(75.0)
    assert read("device_idle.long", ctx(profile=p)) == pytest.approx(75.0)
    assert p.device_seconds("lqt_scan_kernel") == pytest.approx(10e-6)
    assert [n for n, _ in p.top_ops()] == [
        "gemm", "void lqt_scan_kernel<4, double>(ScanArgs<double>)"]
    gaps = dict(p.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(150e-6)
    # gaps 0-30 (mid 15: in aten::mm), 40-110 (mid 75: the copy), 150-200
    assert gaps == pytest.approx({"portbench.step: aten::mm": 30e-6,
                                  "portbench.collect: cudaMemcpyAsync": 70e-6,
                                  "between waves": 50e-6})
    assert read("device_idle.batch", ctx()) is None


def test_roofline_and_mfu_readers():
    p = profile()
    solves = [(64, 20480, 2)]
    c = ctx(profile=p, solves=solves)
    nbytes = counts.scan_bytes(2049, 64, 4, 8)
    flops = counts.scan_combines(2049) * 64 * counts.combine_flops(4)
    bound = max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FP64_FLOPS)
    assert read("lqt_scan_roofline.batch", c) == pytest.approx(
        100 * bound / 10e-6)
    assert read("lqt_scan_roofline.long", c) == read(
        "lqt_scan_roofline.batch", c)
    # the mfu counts the completed records' own lengths, not the padded
    # solve: 3 records of 20480 and 5000 intervals in a wave of 64 rows
    lengths = [20480, 20480, 5000]
    c = ctx(profile=p, solves=solves, record_lengths=lengths)
    mfu = 100 * (counts.solve_flops(2048, 10, 2, 4, 2)
                 + counts.record_flops(5000, 10, 4, 2)) / (
        200e-6 * peaks.FP64_FLOPS)
    assert read("solve_mfu.batch", c) == pytest.approx(mfu)
    for name in ("lqt_scan_roofline.batch", "solve_mfu.long"):
        assert read(name, ctx(profile=p)) is None
    assert read("lqt_scan_roofline.batch", ctx(solves=solves)) is None
    assert read("solve_mfu.long", ctx(record_lengths=lengths)) is None


# -- the manifest -----------------------------------------------------------

def test_manifest_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            texts = [e[k] for k in ("why", "layer") if k in e]
            if section == "configs":
                texts.append(e["source"])
            for text in texts:
                assert 1 <= len(text) <= 200 and "\n" not in text
                assert "\t" not in text
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_file_is_found_by_name():
    root = harness.ROOT
    for c in BENCH["configs"]:
        path = harness.REPO / c["file"]
        assert path.is_file() and path.parent == root / "configs"
        cfg = harness.load_json(path)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (root / "reference" / f"{c['name']}.py").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (root / "traffic" / f"{w['traffic']}.json").is_file()
        check = harness.load_json(root / "workloads" / f"{w['name']}.json")
        assert check["check"]["limits"]["x_gap"] > 0
        # the cell's tiny mix for the CPU and card tests
        assert int(check["small"]["wave"]) >= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_its_layer_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = w["name"]
        mine = {m["name"] for m in harness.cell_metrics(BENCH, "end_to_end",
                                                        cell)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = harness.cell_metrics(BENCH, "per_layer", cell)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


def test_run_seconds_fit_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
