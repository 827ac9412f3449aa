"""pytest settings and helpers of the benchmark's own tests (``pytest
kbench/tests``): a cell's overrides at a CPU test's size, a copy of the
benchmark to add cells to, and the faults planted in a cell's run."""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kbench import harness  # noqa: E402

#: the reads of every cell at a CPU test's size: a 20 kbp genome
TINY_READS = {"genome_len": 20_000, "n_reads": 3_000}
#: the faults `faults` plants, in order
FAULT_IDS = ["state_unchanged", "half_left_out", "answer_altered"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on an NVIDIA GPU (skips when torch.cuda "
        "finds none)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def tiny_overrides(cell: str, bench: harness.Bench | None = None) -> dict:
    """`Bench.cell` overrides that shrink `cell` of `bench` to a CPU
    test's size: the tiny reads, and its loop's own TINY mix
    parameters."""
    bench = bench or harness.Bench()
    mix = bench.traffic(bench.workload(cell)["traffic"])
    return {"reads": TINY_READS,
            "traffic": dict(bench.loop(mix["loop"]).TINY)}


@pytest.fixture(scope="session")
def tiny():
    """`tiny_overrides`: any cell's CPU size, of the benchmark or of a
    copy."""
    return tiny_overrides


def bench_copy(root: pathlib.Path) -> dict:
    """A copy of the benchmark's data and its per-name files under
    `root`; returns its BENCHMARK.json as a dict, to be written back."""
    for sub in ("configs", "traffic", "loops", "metrics", "judge"):
        shutil.copytree(ROOT / "kbench" / sub, root / "kbench" / sub)
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _parts(out) -> list:
    """A query method's answer as a list of arrays (a tuple's, or one)."""
    return [np.array(a) for a in out] if isinstance(out, tuple) \
        else [np.array(out)]


def _answer(parts: list, like):
    return tuple(parts) if isinstance(like, tuple) else parts[0]


def _live(parts: list) -> np.ndarray:
    """Which entries of the first array are answers: where a tuple ends in
    a bool mask (find's, node_counts' found), those it marks, broadcast
    over the first array's trailing axes; else all."""
    first, last = parts[0], parts[-1]
    if len(parts) > 1 and last.dtype == bool:
        last = last.reshape(last.shape + (1,) * (first.ndim - last.ndim))
        return np.broadcast_to(last, first.shape)
    return np.ones(first.shape, bool)


def second_half_absent(out):
    """`out` with its second half of rows answered as absent: the first
    array's rows zero and, where the answer ends in a bool mask, unset."""
    parts = _parts(out)
    n = len(parts[0]) // 2
    parts[0][n:] = 0
    if len(parts) > 1 and parts[-1].dtype == bool:
        parts[-1][n:] = False
    return _answer(parts, out)


def one_number_plus_one(out):
    """`out` with one live number of its first array, the first at or after
    its middle, raised by one."""
    parts = _parts(out)
    first = parts[0]
    live = np.flatnonzero(_live(parts).reshape(-1))
    mid = first.size // 2
    at = live[np.searchsorted(live, mid) % live.size] if live.size else mid
    first.flat[at] += 1
    return _answer(parts, out)


def faults(cell: str, bench: harness.Bench | None = None) -> list:
    """(name, patch(monkeypatch)) of each fault `cell` can have, planted on
    the index class its configuration names.  A loop that builds in its
    window (its judge checks the whole contents) gets the build's faults
    for the first two: nothing inserted, half the valid bases dropped on
    their way to the device.  Otherwise they, and the third always, wrap
    the public method the loop declares (`METHOD`): the previous call's
    answer; the second half of the rows answered as absent; one number
    of one answer changed by one.  One card, so no exchange between chips
    to leave out."""
    import kmerind_tpu_torch as kt
    from kmerind_tpu_torch.index import api

    c = (bench or harness.Bench()).cell(cell)
    cls = getattr(kt, c.cfg["index"])
    method = c.loop.METHOD
    real = getattr(cls, method)
    builds = c.loop.CHECK_CONTENTS

    def wrap(mp, after):
        def wrapper(self, *a, **kw):
            return after(real(self, *a, **kw))
        mp.setattr(cls, method, wrapper)

    def unchanged(mp):
        if builds:
            mp.setattr(cls, "_insert_cols", lambda self, cols: self)
            return
        prev = {}

        def stale(out):
            before = prev.get("answer", out)
            prev["answer"] = out
            return before
        wrap(mp, stale)

    def half(mp):
        if not builds:
            wrap(mp, second_half_absent)
            return
        real_to_device = api._IndexBase._to_device

        def drop(self, cols):
            cols = dict(cols)
            v = cols["valid"].copy()
            v[:, v.shape[1] // 2:] = False
            cols["valid"] = v
            return real_to_device(self, cols)
        mp.setattr(api._IndexBase, "_to_device", drop)

    def altered(mp):
        wrap(mp, one_number_plus_one)

    return list(zip(FAULT_IDS, (unchanged, half, altered)))
