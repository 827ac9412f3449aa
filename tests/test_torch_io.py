"""Port host IO (kmerind_tpu_torch.io) against the JAX package's: the same
synthetic FASTQ/FASTA files parse to identical ReadBatch columns, with the
native (C++ fastscan) and the numpy engines, whole-file and by block."""

import numpy as np
import pytest

import kmerind_tpu.io as jio
import kmerind_tpu_torch.io as tio
from kmerind_tpu import DNA as J_DNA, DNA16 as J_DNA16
from kmerind_tpu_torch import DNA as T_DNA, DNA16 as T_DNA16
from kmerind_tpu_torch.io import native as tnative

from torch_parity import assert_batches_equal, write_reads

ALPHAS = {"DNA": (J_DNA, T_DNA), "DNA16": (J_DNA16, T_DNA16)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_io")
    fq, fa = d / "reads.fastq", d / "reads.fasta"
    write_reads(fq, 300, 90, 5000, seed=3, fmt="fastq", n_rate=0.01)
    write_reads(fa, 40, 700, 5000, seed=4, fmt="fasta", n_rate=0.01)
    return {"fastq": fq, "fasta": fa}


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
@pytest.mark.parametrize("alpha", sorted(ALPHAS))
def test_read_file_matches_jax(corpus, engine, fmt, alpha):
    if engine == "native" and not tnative.available():
        pytest.skip("native fastscan library unavailable")
    ja, ta = ALPHAS[alpha]
    want = jio.read_file(corpus[fmt], ja, engine=engine)
    got = tio.read_file(corpus[fmt], ta, engine=engine)
    assert got.num_bases > 0
    assert_batches_equal(got, want)


@pytest.mark.parametrize("nparts", [1, 3, 7])
@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_block_reads_match_jax(corpus, fmt, nparts):
    """Block-partitioned reads (the build_stream path) agree part by part,
    and the owned bases of all parts cover the whole-file parse."""
    total = 0
    for part in range(nparts):
        if fmt == "fastq":
            want = jio.read_fastq_block(corpus[fmt], J_DNA, part, nparts)
            got = tio.read_fastq_block(corpus[fmt], T_DNA, part, nparts)
        else:
            want = jio.read_fasta_block(corpus[fmt], J_DNA, part, nparts,
                                        halo=20)
            got = tio.read_fasta_block(corpus[fmt], T_DNA, part, nparts,
                                       halo=20)
        assert_batches_equal(got, want)
        total += int(got.owned.sum())
    assert total == tio.read_file(corpus[fmt], T_DNA).num_bases


def test_chunks_and_split_at_invalid_match_jax(corpus):
    """iter_chunks (fixed-shape chunks with a k-1 halo) and the N split
    (split_records_at_invalid) give the same columns in both packages."""
    raw = np.fromfile(corpus["fastq"], np.uint8)
    want = jio.split_records_at_invalid(
        jio.read_file(corpus["fastq"], J_DNA), raw, J_DNA)
    got = tio.split_records_at_invalid(
        tio.read_file(corpus["fastq"], T_DNA), raw, T_DNA)
    assert_batches_equal(got, want)
    assert not got.valid.all()
    for g, w in zip(got.iter_chunks(5000, 20), want.iter_chunks(5000, 20),
                    strict=True):
        assert_batches_equal(g, w)
