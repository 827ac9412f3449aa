"""Cells of a new index class, and of a mix with a judge of its own, added
to a copy of the benchmark with new files and new BENCHMARK.json entries
only: each runs at a CPU test's size, traced and untraced, reports the
query metrics once its name is in their lists, and its control and
planted faults come out not correct."""

import json
import textwrap

import pytest

from kbench import control, harness

from .conftest import FAULT_IDS, ROOT, bench_copy, faults

#: a loop of count() batches on an index built in set-up, each batch in
#: a range of the loop's own: any index class with a count()
SORTED_LOOP = '''
import time

CHECK_CONTENTS = False
METHOD = "count"
TINY = {"batch_reads": 32, "pool_batches": 3}
RANGE = "sorted_batch"
KWARGS = {}


def query_sets(mix):
    b = mix["batch_reads"]
    return {f"batch{i}": (i * b, (i + 1) * b)
            for i in range(mix["pool_batches"])}


def drive(run):
    pool = list(query_sets(run.mix))
    idx = run.make_index()
    idx.build(str(run.inputs.path))
    run.idx = idx
    ask = getattr(idx, METHOD)
    for name in pool:
        ask(run.rows[name], **KWARGS)
    with run.measured() as win:
        i = 0
        while i < len(pool) or not run.trace and (
                time.perf_counter() - win.start < run.seconds):
            name = pool[i % len(pool)]
            q = run.rows[name]
            c0, t0 = time.process_time(), time.perf_counter()
            with run.span(RANGE):
                ans = ask(q, **KWARGS)
            win.calls.append((t0, time.perf_counter(), q.shape[0]))
            win.cpu_s.append(time.process_time() - c0)
            win.answers.append((name, ans))
            i += 1
'''

#: the same loop asking find(with_quality=True) of a multimap
FIND_LOOP = (SORTED_LOOP.replace('METHOD = "count"', 'METHOD = "find"')
             .replace('"sorted_batch"', '"find_batch"')
             .replace("KWARGS = {}", 'KWARGS = {"with_quality": True}'))

#: a judge of find(with_quality=True) answers: every found (id, quality)
#: pair of every query row against the reference's pairs of its
#: canonical k-mer (`reference.kmers.window_pairs`); the control rounds
#: the reference's qualities to bfloat16
FIND_JUDGE = '''
import numpy as np
import torch

from kbench.judge import count as count_judge
from kbench.judge import position_quality as pq
from kbench.reference import kmers as ref

LIMITS = {"find_pair_mismatches": 0, "quality_zero_mismatches": 0,
          "quality_rel_err": 1e-4}


def collect(idx, run):
    return {"answers": list(run.window.answers)}


def wanted(inputs, sets, device):
    """{query set: (its rows, (row, id, quality) of every reference pair
    of each query row's canonical k-mer)}."""
    queries = count_judge.query_codes(inputs, sets, device)
    keep = torch.unique(torch.cat(list(queries.values())))
    wk, wid, wq = ref.window_pairs(inputs.codes, inputs.quals, inputs.k,
                                   keep, inputs.record_bytes,
                                   inputs.seq_offset, device)
    wk, order = torch.sort(wk)
    wid, wq = wid[order], wq[order]
    out = {}
    for name, q in queries.items():
        lo = torch.searchsorted(wk, q)
        n = torch.searchsorted(wk, q, right=True) - lo
        row = torch.repeat_interleave(torch.arange(q.numel(), device=device),
                                      n)
        start = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        at = torch.repeat_interleave(lo, n) + torch.arange(
            row.numel(), device=device) - start
        out[name] = (q.numel(), (row, wid[at], wq[at]))
    return out


def compare(outputs, inputs, sets, seed, device):
    want = wanted(inputs, sets, device)
    totals = {"find_pair_mismatches": 0, "quality_zero_mismatches": 0,
              "quality_rel_err": 0.0}
    for name, (ids, quals, mask) in outputs["answers"]:
        if want[name][0] >= 1 << 17:
            raise ValueError("row << 46 | id must fit an int64")
        r, c = np.nonzero(mask)
        put = lambda a: torch.from_numpy(np.asarray(a)).to(device)
        got = (put(r.astype(np.int64)), put(ids[r, c].astype(np.int64)),
               put(quals[r, c].astype(np.float64)))
        for n, v in pq.find_checks(*got, *want[name][1]):
            totals[n] = max(totals[n], v) if n == "quality_rel_err" \\
                else totals[n] + v
    return [(n, v, LIMITS[n]) for n, v in totals.items()]


def control(inputs, sets, contents, device, seed):
    answers = []
    for name, (m, (row, wid, wq)) in wanted(inputs, sets, device).items():
        n = torch.bincount(row, minlength=m)
        width = max(int(n.max()), 1)
        col = torch.arange(row.numel(), device=device) - torch.repeat_interleave(
            torch.cumsum(n, 0) - n, n)
        ids = torch.zeros((m, width), dtype=torch.int64, device=device)
        qs = torch.zeros((m, width), dtype=torch.float32, device=device)
        mask = torch.zeros((m, width), dtype=torch.bool, device=device)
        ids[row, col] = wid
        qs[row, col] = wq.to(torch.bfloat16).to(torch.float32)
        mask[row, col] = True
        answers.append((name, (ids.cpu().numpy().astype(np.uint64),
                               qs.cpu().numpy(), mask.cpu().numpy())))
    return {"answers": answers}
'''

#: a program_counter reader: the program's "count" phases a batch
COUNTER_METRIC = '''
SOURCE = "program_counter"
LAYER = "query"
MOVES = "query_kmers_per_s"


def read(obs):
    n = obs.counts.get("phases", {}).get("count")
    if not n or not obs.window.calls:
        return None
    return n / len(obs.window.calls)
'''

SORTED = "rsph45x-k31-sorted.query"
FIND = "rsph45x-k31-pq.find"
CELLS = [SORTED, FIND]


def _entries_unchanged(before: dict, after: dict):
    """Every entry of `before` is in `after` as it was, but for the cells
    appended to its `workloads`; nothing else is taken out."""
    for key, old in before.items():
        if not isinstance(old, list) or not old or \
                not isinstance(old[0], dict):
            assert after[key] == old
            continue
        new = {e["name"]: e for e in after[key]}
        for e in old:
            got = dict(new[e["name"]])
            if "workloads" in e:
                assert got["workloads"][:len(e["workloads"])] \
                    == e["workloads"]
                got["workloads"] = e["workloads"]
            assert got == e


@pytest.fixture(scope="module")
def new_bench(tmp_path_factory):
    """A copy of the benchmark with the two cells added: new files
    (a configuration, two loops, two mixes, a judge, a metric reader)
    and new entries (a configuration, two cells, and the cells appended
    to the lists of the query metrics)."""
    root = tmp_path_factory.mktemp("new_cells")
    spec = bench_copy(root)
    before = json.loads(json.dumps(spec))
    kb = root / "kbench"
    new_files = {
        "configs/rsph45x-k31-sorted.json": json.dumps({
            **json.loads((kb / "configs/rsph45x-k31-count.json")
                         .read_text()),
            "name": "rsph45x-k31-sorted", "index": "SortedCountIndex"}),
        "loops/sorted_query.py": SORTED_LOOP,
        "loops/find.py": FIND_LOOP,
        "traffic/sorted_query.json": json.dumps(
            {"loop": "sorted_query", "batch_reads": 8192,
             "pool_batches": 64}),
        "traffic/pq_find.json": json.dumps(
            {"loop": "find", "judge": "pq_find", "batch_reads": 8192,
             "pool_batches": 64}),
        "judge/pq_find.py": FIND_JUDGE,
        "metrics/count_phases_per_batch.py": COUNTER_METRIC,
    }
    for rel, text in new_files.items():
        assert not (kb / rel).exists(), rel
        (kb / rel).write_text(textwrap.dedent(text))
    spec["configs"].append({
        "name": "rsph45x-k31-sorted", "source": spec["configs"][0]["source"],
        "file": "kbench/configs/rsph45x-k31-sorted.json", "reduced": [],
        "why": "the count index's reads in a range-partitioned index"})
    for name, cfg, traffic in ((SORTED, "rsph45x-k31-sorted", "sorted_query"),
                               (FIND, "rsph45x-k31-pq", "pq_find")):
        spec["workloads"].append({"name": name, "config": cfg,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a throwaway cell"})
    for key in ("end_to_end", "per_layer"):
        for m in spec[key]:
            if "rsph45x-k31-count.query" in m.get("workloads", []):
                m["workloads"] += CELLS
    spec["per_layer"].append({
        "name": "count_phases_per_batch", "unit": "phases",
        "better": "lower", "source": "program_counter", "layer": "query",
        "moves": "query_kmers_per_s", "workloads": [SORTED]})
    _entries_unchanged(before, spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for sub in ("configs", "traffic", "loops", "metrics", "judge"):
        for f in (ROOT / "kbench" / sub).iterdir():
            if f.is_file():
                assert (kb / sub / f.name).read_bytes() == f.read_bytes()
    return harness.Bench(root)


def run(cell, bench, tiny, trace=False):
    return harness.run_cell(cell, 3_000_000_023, 0.4, trace, device="cpu",
                            bench=bench, overrides=tiny(cell, bench),
                            log=lambda msg: None)


def test_the_mix_names_the_judge(new_bench):
    assert new_bench.cell(FIND).judge.__name__ == "kbench_judge_pq_find"
    assert new_bench.cell("rsph45x-k31-pq.build").judge.__name__ \
        == "kbench_judge_position_quality"
    assert new_bench.cell(SORTED).judge.__name__ == "kbench_judge_count"


@pytest.mark.parametrize("trace", [False, True], ids=["end_to_end", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_runs_and_reports_the_query_metrics(new_bench, tiny, cell,
                                                     trace):
    res = run(cell, new_bench, tiny, trace)
    assert res["correct"] is True, res["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in new_bench.metrics_for(cell, kind)}
    if not trace:
        assert set(res["metrics"]) == want == {
            "query_kmers_per_s", "query_batch_p95_ms", "peak_device_gib",
            "setup_s"}
        return
    assert set(res["metrics"]) <= want
    assert "device_idle_pct.query" in res["metrics"]
    assert res["device"]["window_s"] > 0     # bounded by the loop's range
    if cell == SORTED:
        assert res["metrics"]["count_phases_per_batch"]["value"] == 1.0
    else:
        assert set(res["checks"]) == {"find_pair_mismatches",
                                      "quality_zero_mismatches",
                                      "quality_rel_err"}


def test_counts_hold_the_phases_and_launch_counters(new_bench, tiny,
                                                    monkeypatch):
    """The run's `Observations.counts` over the window: phases entered and
    the launch counters' change (none launch on the CPU)."""
    seen = {}
    real = harness.Observations.__init__

    def keep(self, *a, **kw):
        real(self, *a, **kw)
        seen["counts"] = self.counts
    monkeypatch.setattr(harness.Observations, "__init__", keep)
    res = run(SORTED, new_bench, tiny, trace=True)
    counts = seen["counts"]
    assert set(counts) == {"phases", "launches", "k2_payload_launches"}
    assert counts["phases"]["count"] == counts["phases"]["rows"] \
        == res["attempted"] == 3
    from kmerind_tpu_torch.ops import kernels
    assert set(counts["launches"]) == set(kernels.LAUNCHES)
    assert not any(counts["launches"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_control_is_caught(new_bench, tiny, cell):
    checks = control.control_checks(cell, 5, "cpu", bench=new_bench,
                                    overrides=tiny(cell, new_bench))
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", range(3), ids=FAULT_IDS)
def test_new_cell_planted_fault_is_caught(new_bench, tiny, cell, fault,
                                          monkeypatch):
    _, patch = faults(cell, new_bench)[fault]
    patch(monkeypatch)
    assert run(cell, new_bench, tiny)["correct"] is False


@pytest.mark.cuda
def test_new_cells_trace_device_work_on_the_card(cuda_device, new_bench,
                                                 tiny):
    for cell in CELLS:
        res = harness.run_cell(cell, 13, 0.5, True, device=cuda_device,
                               bench=new_bench, overrides=tiny(cell,
                                                               new_bench),
                               log=lambda msg: None)
        assert res["correct"] is True and res["device"]["platform"] == "gpu"
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0


@pytest.mark.cuda
def test_counts_read_the_launch_counters_on_the_card(cuda_device, tiny,
                                                      monkeypatch):
    """On the card a count batch launches the count lookup once: the
    window's launch counters say so."""
    seen = {}
    real = harness.Observations.__init__

    def keep(self, *a, **kw):
        real(self, *a, **kw)
        seen["counts"] = self.counts
    monkeypatch.setattr(harness.Observations, "__init__", keep)
    cell = "rsph45x-k31-count.query"
    res = harness.run_cell(cell, 17, 0.5, False, device=cuda_device,
                           overrides=tiny(cell), log=lambda msg: None)
    assert res["correct"] is True
    counts = seen["counts"]
    assert counts["launches"]["run_count_lookup"] == res["attempted"] \
        == counts["phases"]["count"]
