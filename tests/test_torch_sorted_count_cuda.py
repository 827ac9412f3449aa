"""The sort-based count map on the card at the scale of a benchmark chunk
and beyond, against the plain reference (``tests/plain_sorted_count.py``,
run on the card) and the same index on the CPU: more than 2^24 pending
rows (three 2^23-base chunks) sorted by the first query, `items()` in
ascending key order and `count`.  K4, which each chunk runs on its sorted
rows, on odd lengths and with all-ones rows after the valid ones (the
sorted chunk's tail when keys leave the all-ones pattern free).

Needs an NVIDIA GPU and nvcc; skips otherwise:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sorted_count_cuda.py
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import kmerind_tpu_torch as kt  # noqa: E402
from kbench import data  # noqa: E402
from kmerind_tpu_torch.ops import kernels  # noqa: E402

import plain_sorted_count as plain  # noqa: E402
from torch_parity import sorted_key_cols, words_t  # noqa: E402

pytestmark = pytest.mark.cuda

K = 31
#: 20.2 M bases of 101-bp reads: three default chunks, 14.2 M k-mers
READS = {"genome_len": 400_000, "n_reads": 200_000, "read_len": 101,
         "sub_rate": 0.005, "n_rate": 0.001}
HELD = 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


def test_sorted_count_index_past_2_24_rows(dev, tmp_path):
    r = READS
    codes = data.make_reads(r["genome_len"], r["n_reads"] + HELD, 41,
                            r["read_len"], r["sub_rate"], r["n_rate"])
    main, held = codes[:r["n_reads"]], codes[r["n_reads"]:]
    path = tmp_path / "reads.fastq"
    data.write_fastq(main, data.make_quals(main, 41), path)
    spec = kt.KmerSpec(K, kt.DNA)
    idx = {d: kt.SortedCountIndex(spec, device=d) for d in (dev, "cpu")}
    before = kernels.LAUNCHES["run_length_weights"]
    idx[dev].build(str(path))
    pending = sum(t[0].shape[1] for t in idx[dev]._pending)
    assert pending > 1 << 24 and len(idx[dev]._pending) >= 3
    assert kernels.LAUNCHES["run_length_weights"] - before \
        == len(idx[dev]._pending)
    idx["cpu"].build(str(path))

    keys, counts = plain.table(main, K, dev)
    q = plain.windows(held, K, False, dev)
    want = plain.lookup(keys, counts, plain.canonical(q, K)).cpu().numpy()
    assert (want > 0).mean() > 0.5
    for d, i in idx.items():
        got = i.count(plain.to_words(q, K))
        np.testing.assert_array_equal(got, want, err_msg=str(d))
        assert i.timer.count("sorted.flush") == 1
    got_w, got_c = idx[dev].items()
    assert torch.equal(plain.from_words(got_w, K, dev), keys)
    np.testing.assert_array_equal(got_c, counts.cpu().numpy())
    cpu_w, cpu_c = idx["cpu"].items()
    np.testing.assert_array_equal(got_w, cpu_w)
    np.testing.assert_array_equal(got_c, cpu_c)
    assert idx[dev].size() == keys.shape[0] == idx["cpu"].size()


@pytest.mark.parametrize("n,n_sentinel", [
    (4097, 0), (4097, 1), (2049, 2049), (70_001, 3001),
    (5 * 2048 + 1, 5 * 2048 - 6), ((1 << 23) + 3, 1 << 20)])
def test_run_length_weights_odd_n_and_sentinel_tail(dev, n, n_sentinel):
    """Odd lengths, so rows cross no tile evenly, with the all-ones rows of
    a sorted chunk's invalid tail, which tie with each other but lie past
    the valid count and weigh 0."""
    rng = np.random.default_rng(n + n_sentinel)
    cols = words_t(sorted_key_cols(rng, 2, n, hi_values=4,
                                   n_sentinel=n_sentinel))
    tv = torch.tensor(n - n_sentinel, dtype=torch.int32)
    want = kernels.run_length_weights_plain(cols, tv)
    got = kernels.run_length_weights(cols.to(dev), tv.to(dev)).cpu()
    assert torch.equal(got, want)
    assert int(got.sum()) == n - n_sentinel
    assert not bool(got[n - n_sentinel:].any())
