"""The port's main path as a whole: the same synthetic reads go through the
JAX CountIndex (8-shard CPU mesh) and the port's CountIndex on the CPU, in
chunks, so that LSM merges and compactions happen.  Index contents
(to_dict) and count() answers must be equal; so must a port index
converted from the JAX index's runs.  Integer outputs: exact equality."""

import os
import subprocess
import sys

import numpy as np
import pytest

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index.api import CountIndex as JaxCountIndex
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu_torch.index.convert import count_index_from_runs
from kmerind_tpu_torch.io import read_file as port_read_file

from torch_parity import write_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reads_path(tmp_path_factory):
    # a 1 kb genome at ~30x: mostly duplicate rows, so the consolidated
    # store trips the automatic compaction
    path = tmp_path_factory.mktemp("torch_count") / "reads.fastq"
    write_reads(path, 260, 120, 1000, seed=11)
    return path


def _queries(spec_k, rng, reads, m=2000):
    """2k queries as strings (both strands), big ints and absent keys."""
    out = []
    for _ in range(m // 2):
        r = reads[int(rng.integers(len(reads)))]
        i = int(rng.integers(len(r) - spec_k + 1))
        out.append(r[i:i + spec_k])
    out += ["".join(rng.choice(list("ACGT"), spec_k)) for _ in range(m // 2)]
    return out


@pytest.mark.parametrize("k", [21, 16])
def test_count_index_slice_matches_jax(reads_path, k):
    """k=21: sentinel-safe unit runs (keys-only merges); k=16: full-word
    keys, flag-mode sort and weighted merges."""
    with open(reads_path) as f:
        reads = f.read().split("\n")[1::4]
    jidx = JaxCountIndex(kt.KmerSpec(k, kt.DNA), max_runs=2)
    jidx.insert_batch(jax_read_file(reads_path, kt.DNA), chunk_bases=4000)
    pidx = kp.CountIndex(kp.KmerSpec(k, kp.DNA), device="cpu", max_runs=2)
    pidx.insert_batch(port_read_file(reads_path, kp.DNA), chunk_bases=4000)
    assert pidx.timer.count("insert") == 8
    assert pidx.timer.count("merge") >= 6
    assert len(pidx.runs) == 2

    spec = pidx.spec
    rng = np.random.default_rng(k)
    strs = _queries(k, rng, reads)
    ints = [spec.to_int(spec.from_string(s)) for s in strs[:300]]
    rows = np.stack([spec.from_string(s) for s in strs[300:600]])
    for q in (strs, ints, rows):
        want = jidx.count(q)
        got = pidx.count(q)
        np.testing.assert_array_equal(got, want)
    assert (pidx.count(strs[:1000]) > 0).all()

    # exports consolidate; the 1 kb genome makes the store mostly
    # duplicates, so the automatic compaction runs (and K3 with it)
    want_dict = jidx.to_dict()
    assert pidx.size() == jidx.size() == len(want_dict)
    assert pidx.timer.count("compact") >= 1
    assert pidx.to_dict() == want_dict
    pidx.compact(1 << 14)
    assert pidx.capacity == 1 << 14
    assert pidx.to_dict() == want_dict
    np.testing.assert_array_equal(pidx.count(strs), jidx.count(strs))


@pytest.mark.parametrize("k", [81, 127, 128])
def test_count_index_wide_k_matches_jax(tmp_path, k):
    """6 key words (k = 81), 8 (k = 127, sentinel-safe: unit runs,
    keys-only merges at w = 8) and 8 full words (k = 128: flag-mode sort,
    weighted merges): contents and counts equal the JAX index's."""
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 80, 200, 1500, seed=17, n_rate=0.002)
    jidx = JaxCountIndex(kt.KmerSpec(k, kt.DNA), max_runs=2)
    jidx.insert_batch(jax_read_file(path, kt.DNA), chunk_bases=4000)
    pidx = kp.CountIndex(kp.KmerSpec(k, kp.DNA), device="cpu", max_runs=2)
    pidx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=4000)
    assert pidx.timer.count("merge") >= 2
    strs = _queries(k, np.random.default_rng(k), reads, 400)
    np.testing.assert_array_equal(pidx.count(strs), jidx.count(strs))
    assert pidx.to_dict() == jidx.to_dict()
    assert pidx.size() == jidx.size()


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_build_and_build_stream_match_jax(tmp_path, fmt):
    """build() (whole file through the parser ring) and build_stream()
    (byte blocks through the parser ring and the feeding thread, the path
    large files take) give the JAX index's contents; FASTA records span
    many lines and many blocks."""
    path = tmp_path / f"reads.{fmt}"
    write_reads(path, 60, 400, 3000, seed=13, fmt=fmt, n_rate=0.01)
    jidx = JaxCountIndex(kt.KmerSpec(21, kt.DNA))
    jidx.build(path)
    want = jidx.to_dict()
    whole = kp.CountIndex(kp.KmerSpec(21, kp.DNA), device="cpu")
    assert whole.build(path).to_dict() == want
    streamed = kp.CountIndex(kp.KmerSpec(21, kp.DNA), device="cpu",
                             max_runs=3)
    streamed.build_stream(path, block_bytes=3000)
    assert streamed.timer.count("insert") >= 8
    assert streamed.to_dict() == want


def test_convert_jax_runs(reads_path):
    """A JAX index's (8-shard) runs carried across: one port run per
    (run, shard), the LSM bound applied, identical answers."""
    jidx = JaxCountIndex(kt.KmerSpec(21, kt.DNA), max_runs=3)
    jidx.insert_batch(jax_read_file(reads_path, kt.DNA), chunk_bases=6000)
    runs = [(np.asarray(r.keys), np.asarray(r.weights), np.asarray(r.csum))
            for r in jidx.runs]
    assert sum(r[0].shape[0] for r in runs) > 3
    pidx = count_index_from_runs(runs, kp.KmerSpec(21, kp.DNA), "cpu",
                                 max_runs=3)
    assert len(pidx.runs) == 3
    with open(reads_path) as f:
        reads = f.read().split("\n")[1::4]
    strs = _queries(21, np.random.default_rng(5), reads, 600)
    np.testing.assert_array_equal(pidx.count(strs), jidx.count(strs))
    assert pidx.to_dict() == jidx.to_dict()


def test_port_import_leaves_jax_out():
    code = ("import sys, kmerind_tpu_torch, kmerind_tpu_torch.index.convert;"
            " assert 'jax' not in sys.modules, 'jax imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
