"""The port's headline bench (kmerind_tpu_torch.bench.headline) on the CPU:
every mode prints bench.py's one JSON line, and the state the e2e,
position_quality and debruijn modes build equals the JAX package's index
fed the same salted chunks.

Counts, node counters, keys and ids: exact.  Window qualities: rtol 1e-5
(the port's float32 window quality against the JAX package's)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from kmerind_tpu.debruijn.graph import DeBruijnGraph as JaxGraph
from kmerind_tpu.index.api import CountIndex as JaxCount
from kmerind_tpu.index.api import PositionQualityIndex as JaxPosQual
from kmerind_tpu.io.batch import ReadBatch as JaxReadBatch
from kmerind_tpu_torch import (CountIndex, DeBruijnGraph,
                               PositionQualityIndex)
from kmerind_tpu_torch.bench import headline
from kmerind_tpu_torch.index import store as st

SMALL = ["--device", "cpu", "--bases", "4096", "--chunks", "3",
         "--max-runs", "2", "--queries", "256", "--iters", "1"]
#: bench.py's unit per mode
UNITS = {"e2e": "kmers/s", "ingest": "kmers/s", "count_query": "queries/s",
         "multimap_find": "queries/s", "erase": "keys/s",
         "debruijn": "kmers/s", "debruijn_quality": "kmers/s",
         "position": "pairs/s", "position_quality": "pairs/s"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", sorted(UNITS))
def test_mode_prints_one_json_line(mode, capsys):
    argv = SMALL + ["--mode", mode, "--json-only", "--inner", "3"]
    assert headline.main(argv) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1 and err == ""
    res = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "compile_s",
                "baseline", "kernel_build_s", "first_run_s"):
        assert key in res, key
    assert res["unit"] == UNITS[mode]
    assert res["value"] > 0 and res["vs_baseline"] > 0
    assert res["baseline"] == "measured"
    assert res["kernel_build_s"] == 0.0


def test_pinned_baseline_is_named(capsys):
    assert headline.main(SMALL + ["--json-only", "--pinned-baseline",
                                  "1e6"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["baseline"] == "pinned"
    assert res["vs_baseline"] == pytest.approx(res["value"] / 1e6)


def test_no_gpu_without_device_cpu_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "kmerind_tpu_torch.bench.headline",
         "--bases", "4096", "--chunks", "1", "--iters", "1"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "--device cpu" in proc.stderr


def _ctx(argv):
    return headline.Context.create(headline.parse_args(SMALL + argv))


def _jax_chunks(ctx, qual=None):
    """The bench's salted chunks as JAX ReadBatches: chunk i flips the low
    bit of base 0 when i is odd."""
    b = ctx.read_batch(qual)
    for i in range(ctx.args.chunks):
        codes = b.codes.copy()
        codes[0] ^= i & 1
        yield JaxReadBatch(
            codes=codes, valid=b.valid, owned=b.owned, seg_id=b.seg_id,
            offset_in_record=b.offset_in_record, global_pos=b.global_pos,
            qual=b.qual, record_start=b.record_start, seq_index=b.seq_index,
            file_id=b.file_id, alphabet=b.alphabet)


def _jax_index(index, ctx, qual=None):
    for batch in _jax_chunks(ctx, qual):
        index.insert_batch(batch)
    return index.to_dict()


@pytest.mark.parametrize("k", [21, 16])
def test_e2e_state_equals_jax_count_index(k):
    ctx = _ctx(["--mode", "e2e", "--k", str(k)])
    res, stores = headline.e2e(ctx)
    idx = CountIndex(ctx.spec, device="cpu").adopt_runs(
        [st.stack_run_stores([s]) for s in stores])
    got = idx.to_dict()
    want = _jax_index(JaxCount(ctx.spec), ctx)
    assert got == want
    assert sum(got.values()) == 3 * headline.in_read_windows(4096, 250, k)
    assert res["unit"] == "kmers/s"


def test_debruijn_state_equals_jax_graph():
    ctx = _ctx(["--mode", "debruijn"])
    _, runs = headline.debruijn(ctx)
    g = DeBruijnGraph(ctx.spec, device="cpu").adopt_runs(
        [st.stack_stores([r]) for r in runs])
    got = {key: tuple(int(c) for c in v) for key, v in g.to_dict().items()}
    want = {key: tuple(int(c) for c in v)
            for key, v in _jax_index(JaxGraph(ctx.spec), ctx).items()}
    assert got == want


def test_position_quality_state_equals_jax_index():
    ctx = _ctx(["--mode", "position_quality"])
    _, (store, ovf) = headline.position_quality(ctx)
    assert ovf == 0
    idx = PositionQualityIndex(ctx.spec, device="cpu", canonical=True)
    idx.store = st.stack_multi_stores([store])
    got = idx.to_dict()
    want = _jax_index(JaxPosQual(ctx.spec, canonical=True), ctx,
                      ctx.qual_np())
    assert got.keys() == want.keys()
    rl = ctx.args.read_len
    for key, pairs in got.items():
        # the bench's ids are (read, offset) halves; the index's short ids
        # (record start << 16 | offset), each record rl bytes from the last
        ids = sorted((((i >> 32) * rl) << 16 | (i & 0xFFFF), q)
                     for i, q in pairs)
        assert [i for i, _ in ids] == [i for i, _ in want[key]]
        np.testing.assert_allclose([q for _, q in ids],
                                   [q for _, q in want[key]], rtol=1e-5)
