"""Port host IO (kmerind_tpu_torch.io) against the JAX package's: the same
synthetic FASTQ/FASTA files parse to identical ReadBatch columns, with the
native (C++ fastscan) and the numpy engines, whole-file and by block."""

import numpy as np
import pytest

import kmerind_tpu.io as jio
import kmerind_tpu.io.files as jfiles
import kmerind_tpu_torch as kp
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


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_position_ids_match_jax(corpus, fmt):
    """Short and long position ids per base equal the JAX package's, on the
    whole file and on a block (absolute record starts); the multimaps'
    ids, composed from pooled record words and offsets, equal
    `ReadBatch.ids` on every base of a record and are 0 on the pads,
    chunk after chunk (the pools are reused)."""
    want = jio.read_file(corpus[fmt], J_DNA)
    got = tio.read_file(corpus[fmt], T_DNA)
    for kind in ("short", "long"):
        np.testing.assert_array_equal(got.ids(kind), want.ids(kind))
    blk = tio.read_fastq_block(corpus[fmt], T_DNA, 1, 3) if fmt == "fastq" \
        else tio.read_fasta_block(corpus[fmt], T_DNA, 1, 3, halo=20)
    jblk = jio.read_fastq_block(corpus[fmt], J_DNA, 1, 3) if fmt == "fastq" \
        else jio.read_fasta_block(corpus[fmt], J_DNA, 1, 3, halo=20)
    np.testing.assert_array_equal(blk.short_ids(), jblk.short_ids())
    np.testing.assert_array_equal(blk.long_ids(), jblk.long_ids())
    for kind in ("short", "long"):
        idx = kp.PositionIndex(kp.KmerSpec(21, T_DNA), device="cpu",
                               id_kind=kind)
        for chunk in got.iter_chunks(4000, 20):
            bases = idx._to_device(idx._marshal_chunk(chunk))
            ids = ((bases.id_hi[0].numpy().astype(np.int64) << 32)
                   | (bases.id_lo[0].numpy().astype(np.int64)
                      & 0xFFFFFFFF)).astype(np.uint64)
            rec = chunk.seg_id >= 0
            np.testing.assert_array_equal(ids[rec], chunk.ids(kind)[rec])
            assert not ids[~rec].any()
    with pytest.raises(ValueError, match="id kind"):
        got.ids("medium")


@pytest.mark.parametrize("total,nparts,chunk", [(0, 3, 5), (17, 3, 5),
                                                (100, 4, 7), (9, 1, 100)])
def test_cyclic_partition_matches_jax(total, nparts, chunk):
    for part in range(nparts):
        assert tio.cyclic_partition(total, nparts, part, chunk) == \
            jio.cyclic_partition(total, nparts, part, chunk)


def test_concat_batches_and_owned_base_count_match_jax(corpus):
    """Blocks concatenated (seg ids re-based onto the joined record table)
    equal the JAX package's, and their owned bases the whole file's."""
    parts = [(tio.read_fasta_block(corpus["fasta"], T_DNA, p, 3, halo=20),
              jio.read_fasta_block(corpus["fasta"], J_DNA, p, 3, halo=20))
             for p in range(3)]
    got = tio.concat_batches([g for g, _ in parts])
    assert_batches_equal(got, jio.concat_batches([w for _, w in parts]))
    assert tio.owned_base_count(got) == sum(
        jfiles.owned_base_count(w) for _, w in parts) == tio.read_file(
            corpus["fasta"], T_DNA).num_bases
    with pytest.raises(ValueError):
        tio.concat_batches([])


def test_drop_records_with_invalid_matches_jax(corpus):
    """Records holding an 'N' lose every base (the record table stays);
    the per-record test equals the JAX package's."""
    raw = np.fromfile(corpus["fastq"], np.uint8)
    want_batch = jio.read_file(corpus["fastq"], J_DNA)
    got_batch = tio.read_file(corpus["fastq"], T_DNA)
    bad = tio.records_with_invalid(got_batch, raw, T_DNA)
    np.testing.assert_array_equal(
        bad, jio.records_with_invalid(want_batch, raw, J_DNA))
    assert 0 < bad.sum() < bad.size
    got = tio.drop_records_with_invalid(got_batch, raw, T_DNA)
    assert_batches_equal(got, jio.drop_records_with_invalid(
        want_batch, raw, J_DNA))
    assert not np.isin(got.seg_id, np.flatnonzero(bad)).any()


@pytest.mark.parametrize("nparts", [2, 5])
def test_fasta_block_context_equals_the_header_table(corpus, nparts):
    """A block read with its record context given (as the ranks' header
    scan computes it) equals the read through the whole-file header
    table, and the JAX package's read with the same context."""
    from kmerind_tpu_torch.io.files import (block_partition,
                                            fasta_header_table, file_size)
    path = corpus["fasta"]
    headers = fasta_header_table(path)
    for part in range(nparts):
        bs, _ = block_partition(file_size(path), nparts, part)
        h = int(np.searchsorted(headers, bs, side="right")) - 1
        ctx = (h, int(headers[h]) if h >= 0 else -1)
        got = tio.read_fasta_block(path, T_DNA, part, nparts, halo=20,
                                   context=ctx)
        assert_batches_equal(got, tio.read_fasta_block(path, T_DNA, part,
                                                       nparts, halo=20))
        assert_batches_equal(got, jio.read_fasta_block(
            path, J_DNA, part, nparts, halo=20, context=ctx))
