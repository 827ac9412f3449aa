"""Whole runs of each cell at a CPU test's size: the result line, the
judge against the program, the control and planted faults, discovery of
new files, and the modules a run loads."""

import json
import os
import subprocess
import sys

import pytest

from kbench import control, harness

from .conftest import FAULT_IDS, ROOT, TINY_READS, bench_copy, faults

CELLS = [w["name"] for w in harness.Bench().spec["workloads"]]


def run(cell, tiny, trace=False, bench=None):
    return harness.run_cell(cell, 3_000_000_017, 0.5, trace, device="cpu",
                            bench=bench, overrides=tiny(cell, bench),
                            log=lambda msg: None)


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct_with_the_contract_keys(cell, tiny):
    res = run(cell, tiny)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    bench = harness.Bench()
    assert set(res["metrics"]) == {
        m["name"] for m in bench.metrics_for(cell, "end_to_end")}
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell, tiny):
    res = run(cell, tiny, trace=True)
    assert list(res)[-1] == "checks" and res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    bench = harness.Bench()
    assert set(res["metrics"]) <= {
        m["name"] for m in bench.metrics_for(cell, "per_layer")}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(cell, tiny):
    checks = control.control_checks(cell, 5, "cpu", overrides=tiny(cell))
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", range(3), ids=FAULT_IDS)
def test_planted_fault_is_caught(cell, fault, tiny, monkeypatch):
    _, patch = faults(cell)[fault]
    patch(monkeypatch)
    assert run(cell, tiny)["correct"] is False


def test_pq_fault_in_find_ids_is_caught(tiny, monkeypatch):
    from kmerind_tpu_torch.index import api
    real = api.PositionIndex._find_words

    def shifted(self, *a, **kw):
        ids, *rest = real(self, *a, **kw)
        ids = ids.copy()
        ids[0, 0] += 1
        return (ids, *rest)
    monkeypatch.setattr(api.PositionIndex, "_find_words", shifted)
    res = run("rsph45x-k31-pq.build", tiny)
    assert res["correct"] is False
    assert res["checks"]["find_pair_mismatches"]["value"] > 0


#: a loop that a new mix brings: the index built in set-up, then
#: `rounds` calls of `count()` of the windows of the first `reads`
#: held-out reads
OWN_LOOP = """
import time

CHECK_CONTENTS = False
METHOD = "count"
TINY = {}


def query_sets(mix):
    return {"reads": (0, mix["reads"])}


def drive(run):
    idx = run.make_index()
    idx.build(str(run.inputs.path))
    run.idx = idx
    rows = run.rows["reads"]
    idx.count(rows)
    with run.measured() as win:
        for _ in range(run.mix["rounds"]):
            c0, t0 = time.process_time(), time.perf_counter()
            ans = idx.count(rows)
            win.calls.append((t0, time.perf_counter(), rows.shape[0]))
            win.cpu_s.append(time.process_time() - c0)
            win.answers.append(("reads", ans))
"""

#: new mixes: (mix file, its loop's source or None for a loop there is)
NEW_MIXES = {
    "existing_loop": ({"loop": "query", "batch_reads": 16,
                       "pool_batches": 2}, None),
    "own_loop": ({"loop": "tiny_rounds", "reads": 16, "rounds": 3},
                 OWN_LOOP),
}


def add_cell(spec, name, traffic):
    """A count cell `name` on mix `traffic`, reporting what the query
    cell reports."""
    spec["workloads"].append({"name": name, "config": "rsph45x-k31-count",
                              "traffic": traffic, "chips": 1,
                              "why": "a throwaway mix"})
    for m in spec["end_to_end"]:
        if "rsph45x-k31-count.query" in m.get("workloads", []):
            m["workloads"].append(name)


@pytest.mark.parametrize("case", list(NEW_MIXES))
def test_new_mix_and_metric_need_only_new_files(case, tmp_path):
    """A throwaway mix (on a loop that is there, or with a loop of its
    own) and a per-layer metric, added as new files and new
    BENCHMARK.json entries in a copy of the benchmark's data."""
    mix, loop_src = NEW_MIXES[case]
    spec = bench_copy(tmp_path)
    (tmp_path / "kbench" / "traffic" / "tiny_mix.json").write_text(
        json.dumps(mix))
    if loop_src is not None:
        (tmp_path / "kbench" / "loops" / f"{mix['loop']}.py").write_text(
            loop_src)
    (tmp_path / "kbench" / "metrics" / "calls_seen.py").write_text(
        'SOURCE = "host_clock"\nLAYER = "query"\n'
        'MOVES = "query_kmers_per_s"\n\n\n'
        'def read(obs):\n    return float(len(obs.window.calls))\n')
    add_cell(spec, "rsph45x-k31-count.tiny", "tiny_mix")
    spec["per_layer"].append({"name": "calls_seen", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "query", "moves": "query_kmers_per_s",
                              "workloads": ["rsph45x-k31-count.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(tmp_path)
    res = harness.run_cell("rsph45x-k31-count.tiny", 9, 0.3, True,
                           device="cpu", bench=bench,
                           overrides={"reads": TINY_READS},
                           log=lambda msg: None)
    assert res["correct"] is True
    assert res["metrics"]["calls_seen"]["value"] == float(
        mix.get("rounds", mix.get("pool_batches")))
    end = harness.run_cell("rsph45x-k31-count.tiny", 9, 0.3, False,
                           device="cpu", bench=bench,
                           overrides={"reads": TINY_READS},
                           log=lambda msg: None)
    assert end["correct"] is True
    assert {"query_kmers_per_s", "query_batch_p95_ms", "setup_s",
            "peak_device_gib"} == set(end["metrics"])


#: the count configuration's file-build cell, out of BENCHMARK.json while
#: its host-bound rate spreads wider than a bound may (PERF.md); the build
#: loop and the count judge's contents check keep it ready to come back
COUNT_BUILD = "rsph45x-k31-count.build"


@pytest.fixture(scope="module")
def count_build_bench(tmp_path_factory):
    """A copy of the benchmark with the count build cell added back as
    entries only: its workload, and its name in the lists of the build
    metrics."""
    root = tmp_path_factory.mktemp("count_build")
    spec = bench_copy(root)
    spec["workloads"].append({"name": COUNT_BUILD,
                              "config": "rsph45x-k31-count",
                              "traffic": "build", "chips": 1,
                              "why": "whole builds into a count index"})
    for key in ("end_to_end", "per_layer"):
        for m in spec[key]:
            if "rsph45x-k31-pq.build" in m.get("workloads", []):
                m["workloads"].append(COUNT_BUILD)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root)


@pytest.mark.parametrize("trace", [False, True], ids=["end_to_end", "traced"])
def test_count_build_cell_returns_with_entries_only(count_build_bench, tiny,
                                                    trace):
    res = run(COUNT_BUILD, tiny, trace=trace, bench=count_build_bench)
    assert res["correct"] is True
    assert {"answer_mismatches", "distinct_gap",
            "count_mismatches"} == set(res["checks"])
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in count_build_bench.metrics_for(COUNT_BUILD,
                                                             kind)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want


def test_count_build_control_is_caught(count_build_bench, tiny):
    checks = control.control_checks(COUNT_BUILD, 5, "cpu",
                                    bench=count_build_bench,
                                    overrides=tiny(COUNT_BUILD,
                                                   count_build_bench))
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("fault", range(3), ids=FAULT_IDS)
def test_count_build_planted_fault_is_caught(count_build_bench, fault, tiny,
                                             monkeypatch):
    _, patch = faults(COUNT_BUILD, count_build_bench)[fault]
    patch(monkeypatch)
    res = run(COUNT_BUILD, tiny, bench=count_build_bench)
    assert res["correct"] is False


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmerind_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kmerind_tpu.ops", sys)
    assert harness.forbidden_modules() == ["kmerind_tpu.ops"]


def _run_and_emit(bench_root, cell, reads, env=None):
    """A subprocess that runs `cell` at a CPU test's size on the
    benchmark under `bench_root` and ends as run.py does, by `emit`."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from kbench import harness, run\n"
        "res = harness.run_cell(%r, 1, 0.2, False, device='cpu', "
        "bench=harness.Bench(%r), overrides={'reads': %r}, "
        "log=lambda m: None)\n"
        "rc = run.emit(res)\n"
        "print(json.dumps(['kmerind_tpu_torch' in sys.modules]), "
        "file=sys.stderr)\n"
        "sys.exit(rc)\n" % (str(ROOT), cell, str(bench_root), reads))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)


def test_a_run_loads_no_jax_and_no_jax_package():
    out = _run_and_emit(ROOT, "rsph45x-k31-pq.build", TINY_READS)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert json.loads(out.stderr.strip().splitlines()[-1]) == [True]


def test_a_metric_that_loads_jax_leaves_no_result(tmp_path):
    """A metric reader, loaded after the window, imports a module named
    `jax` (a stub): the run prints no result and exits non-zero."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text('"""A stand-in for JAX."""\n')
    bench = tmp_path / "bench"
    spec = bench_copy(bench)
    (bench / "kbench" / "metrics" / "jax_probe.py").write_text(
        'import jax  # noqa: F401\n\nSOURCE = "host_clock"\n\n\n'
        'def read(obs):\n    return 1.0\n')
    spec["end_to_end"].append({"name": "jax_probe", "unit": "x",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["rsph45x-k31-pq.build"]})
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(stub)}
    out = _run_and_emit(bench, "rsph45x-k31-pq.build", TINY_READS,
                        env=env)
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "forbidden modules loaded: jax" in out.stderr


def test_without_a_card_run_exits_nonzero_and_prints_nothing(tmp_path):
    out = subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_tiny_run_on_the_card(cuda_device, tiny):
    for cell in CELLS:
        res = harness.run_cell(cell, 11, 0.5, False, device=cuda_device,
                               overrides=tiny(cell), log=lambda msg: None)
        assert res["correct"] is True and res["device"]["platform"] == "gpu"
