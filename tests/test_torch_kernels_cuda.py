"""The CUDA kernels against their plain versions on the card, at small and
edge-case shapes (empty runs, one row, 5 key words with 3 payloads, k up
to 512, sums that wrap), and the port's CountIndex on the card against the
same index on the CPU.  Exact equality throughout: everything is integer,
and the K2 merge keeps ties in the plain version's (stable) order.

Needs an NVIDIA GPU and nvcc; skips otherwise.  Pure PyTorch (no JAX), so
it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

import kmerind_tpu_torch as kp
from kmerind_tpu_torch.io import read_file
from kmerind_tpu_torch.ops import kernels, packing

from torch_parity import sorted_key_cols, words_t, write_reads

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.parametrize("name,k", [
    ("DNA", 1), ("DNA", 21), ("DNA", 32), ("DNA", 63), ("RNA", 16),
    ("DNA5", 11), ("RNA6", 31), ("DNA16", 9), ("DNA_IUPAC", 15),
    ("ASCII", 5), ("DNA", 512)])
@pytest.mark.parametrize("n", [1, 300, 70001])
def test_extract_canonical_kernel(dev, name, k, n):
    spec = kp.KmerSpec(k, kp.alphabets.by_name(name))
    codes = np.random.default_rng(n + k).integers(
        0, spec.alphabet.size, n).astype(np.uint8)
    t = torch.from_numpy(codes)
    before = kernels.LAUNCHES["extract_canonical"]
    w, rc = kernels.extract_canonical(t.to(dev), spec)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["extract_canonical"] == before + 1
    assert w.shape == (n, spec.nwords)
    pw, prc = packing.extract_canonical(t, spec)
    nv = max(n - k + 1, 0)
    assert torch.equal(w[:nv].cpu(), pw[:nv])
    assert torch.equal(rc[:nv].cpu(), prc[:nv])


@pytest.mark.parametrize("w,npay,na,nb", [
    (1, 0, 0, 0), (1, 1, 0, 5), (2, 0, 5, 0), (2, 3, 1, 1),
    (2, 1, 1000, 3), (3, 2, 3, 1000), (4, 0, 4096, 4096),
    (5, 3, 20001, 7777), (2, 0, 1 << 16, 8212)])
def test_merge_runs_kernel(dev, w, npay, na, nb):
    rng = np.random.default_rng(w * 100 + npay + na)
    a = words_t(sorted_key_cols(rng, w, na, n_sentinel=min(na, 3)))
    b = words_t(sorted_key_cols(rng, w, nb, n_sentinel=min(nb, 2)))
    pa = tuple(torch.from_numpy(rng.integers(-9, 9, na).astype(np.int32))
               for _ in range(npay))
    pb = tuple(torch.from_numpy(rng.integers(-9, 9, nb).astype(np.int32))
               for _ in range(npay))
    want_k, want_p = kernels.merge_runs_cols_plain(a, pa, b, pb)
    got_k, got_p = kernels.merge_runs_cols(
        a.to(dev), tuple(p.to(dev) for p in pa),
        b.to(dev), tuple(p.to(dev) for p in pb))
    torch.cuda.synchronize()
    assert torch.equal(got_k.cpu(), want_k)
    assert all(torch.equal(g.cpu(), p) for g, p in zip(got_p, want_p))


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 300_000, 5_000_001])
def test_prefix_sum_kernel(dev, n):
    x = torch.from_numpy(np.random.default_rng(n).integers(
        -(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32))
    got = kernels.prefix_sum_i32(x.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.prefix_sum_i32_plain(x))


def test_wrappers_reject_bad_input(dev):
    spec = kp.KmerSpec(21, kp.DNA)
    with pytest.raises(TypeError):
        kernels.extract_canonical(torch.zeros(10, dtype=torch.int32,
                                              device=dev), spec)
    with pytest.raises(ValueError):
        kernels.extract_canonical(torch.zeros(10, dtype=torch.uint8,
                                              device=dev),
                                  kp.KmerSpec(513, kp.DNA))
    with pytest.raises(ValueError):
        kernels.prefix_sum_i32(torch.zeros((4, 4), dtype=torch.int32,
                                           device=dev)[:, 0])
    a = torch.zeros((6, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.merge_runs_cols(a, (), a, ())


def test_count_index_cuda_matches_cpu(dev, tmp_path):
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 400, 150, 3000, seed=2, n_rate=0.002)
    spec = kp.KmerSpec(21, kp.DNA)
    idx = {}
    for d in ("cpu", dev):
        idx[d] = kp.CountIndex(spec, device=d, max_runs=2)
        idx[d].insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
    q = [r[i:i + 21] for r in reads[:50] for i in (0, 40, 129)]
    q += ["ACGT" * 5 + "A"] * 3
    np.testing.assert_array_equal(idx[dev].count(q), idx["cpu"].count(q))
    assert idx[dev].to_dict() == idx["cpu"].to_dict()
    assert idx[dev].size() == idx["cpu"].size()
    idx[dev].compact(1 << 15)
    idx["cpu"].compact(1 << 15)
    assert idx[dev].to_dict() == idx["cpu"].to_dict()
