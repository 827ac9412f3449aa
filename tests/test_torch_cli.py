"""The port's tools against the JAX package's: the benchmark CLI
(kmerind_tpu_torch.bench.cli) against kmerind_tpu.bench.cli on the same
seeded FASTQ on the CPU, its checkpoint round trip, the micro-benchmarks'
op names and JSON keys, the logger and the profiler trace."""

import json
import logging

import pytest

from kmerind_tpu.bench import cli as jcli
from kmerind_tpu_torch.bench import cli, micro
from kmerind_tpu_torch.utils import logging as klog
from kmerind_tpu_torch.utils import profiling

from torch_parity import write_reads

KEYS = {"count": ("size", "count_hits", "count_total", "erased"),
        "position": ("size", "count_hits", "count_total", "find_pairs"),
        "posqual": ("size", "count_hits", "count_total", "find_pairs"),
        "debruijn": ("size", "nodes_found")}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "reads.fastq"
    write_reads(path, 200, 90, 3000, seed=11, fmt="fastq", n_rate=0.01)
    return path


CASES = [(index, []) for index in sorted(KEYS)] + [
    ("count", ["--map", "sorted"]), ("count", ["--bimolecule"])]


@pytest.mark.parametrize("index,extra", CASES,
                         ids=[" ".join([i, *e]) for i, e in CASES])
def test_cli_results_match_jax(reads, capsys, index, extra):
    args = ["-F", str(reads), "--index", index, "-S", "7", "--json", *extra]
    want = jcli.main(args + ["--cpu"])
    capsys.readouterr()
    got = cli.main(args + ["--device", "cpu", "--nparts", "3"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert {k: got[k] for k in KEYS[index]} == \
        {k: want[k] for k in KEYS[index]}
    assert got["count_hits" if index != "debruijn" else "nodes_found"] > 0


def test_cli_save_load_round_trip(reads, tmp_path, capsys):
    ck = tmp_path / "ck"
    built = cli.main(["-F", str(reads), "--device", "cpu", "--nparts", "2",
                      "--no-erase", "--save", str(ck), "-S", "5"])
    loaded = cli.main(["--load", str(ck), "-Q", str(reads), "--device",
                       "cpu", "--no-erase", "-S", "5"])
    assert "[TIME] count_k21" in capsys.readouterr().err
    assert {k: v for k, v in loaded.items() if k != "build_s"} == \
        {k: v for k, v in built.items() if k != "build_s"}


def test_micro_ops_and_keys(capsys):
    out = micro.main(["--n", "4096", "--iters", "1", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == out
    ops = [r["op"] for r in out]
    assert ops[:7] == ["extract_canonical_plain", "murmur3_32", "sort_rows",
                       "sort+unique_counts", "revcomp_packed",
                       "reverse_packed", "count_lookup_bucketed"]
    assert set(ops[7:]) <= {"fastq_parse_native"}
    for r in out:
        rate = "bytes_per_s" if r["op"] == "fastq_parse_native" \
            else "items_per_s"
        assert set(r) == {"op", "ms", rate, "device"}
        assert r["device"] == "cpu" and r["ms"] > 0 and r[rate] > 0


def test_logging_levels():
    assert klog.log.name == "kmerind_tpu_torch"
    old = klog.log.level
    try:
        for name, level in [("trace", klog.TRACE), ("debug", logging.DEBUG),
                            ("info", logging.INFO), ("fatal", klog.FATAL)]:
            klog.set_level(name)
            assert klog.log.level == level
        klog.set_level("none")
        assert not klog.log.isEnabledFor(klog.FATAL)
        with pytest.raises(KeyError):
            klog.set_level("loud")
    finally:
        klog.log.setLevel(old)


def test_profiling_trace_holds_the_annotation(tmp_path):
    import torch
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("kmer_probe_region"):
            torch.arange(1000).sum()
    text = (tmp_path / "trace.json").read_text()
    assert "kmer_probe_region" in text
    assert any(e.key == "kmer_probe_region" for e in prof.key_averages())
