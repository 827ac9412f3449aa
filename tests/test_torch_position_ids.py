"""The position ids an id index composes from one word a record and each
base's offset in its record (`_IndexBase._pooled_id_table`, then
`kernels.position_ids`) equal `ReadBatch.short_ids` / `long_ids` bit for
bit on every base of a record, and are 0 on the pads: both parsers, FASTQ
and multi-line FASTA, whole files and blocks that begin inside a record,
chunks with pads, 1 and 4 shards with halos, no records, file ids above
0, offsets past 16 bits and record starts past 40 bits.  Long ids rest on
`global_pos == record_start[seg_id] + offset_in_record`, pinned here for
every parser.  CPU only: the kernel is held to the plain version on the
card by `tests/test_torch_kernels_cuda.py`."""

import dataclasses

import numpy as np
import pytest
import torch

import kmerind_tpu_torch as kp
import kmerind_tpu_torch.io as tio
from kmerind_tpu_torch.io import native
from kmerind_tpu_torch.ops import kernels

from torch_parity import write_reads

KINDS = ("short", "long")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("position_ids")
    paths = {"fastq": d / "reads.fastq", "fasta": d / "reads.fasta",
             "long_fasta": d / "long.fasta"}
    write_reads(paths["fastq"], 300, 90, 5000, seed=3, n_rate=0.01)
    # 700-base records over 12 lines each: blocks begin inside records
    write_reads(paths["fasta"], 40, 700, 5000, seed=4, fmt="fasta",
                n_rate=0.01)
    # records of 70,000 bases: offsets past 65,535 (the short id's wrap)
    write_reads(paths["long_fasta"], 3, 70_000, 100_000, seed=5, fmt="fasta",
                line_width=80)
    return paths


@pytest.fixture(params=["native", "numpy"])
def engine(request, monkeypatch):
    """The parser: the native fastscan library or the numpy one (blocks
    pick theirs by `native.available`)."""
    if request.param == "native":
        if not native.available():
            pytest.skip("native fastscan library unavailable")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def _batches(corpus, engine):
    """{name: ReadBatch} of every file whole and of its blocks (a FASTA
    block's leading record starts before the block)."""
    dna = kp.DNA
    out = {}
    for name, path in corpus.items():
        out[name] = tio.read_file(path, dna, engine=engine)
    for part in range(3):
        out[f"fastq block {part}/3"] = tio.read_fastq_block(
            corpus["fastq"], dna, part, 3, file_id=2)
    for part in range(5):
        out[f"fasta block {part}/5"] = tio.read_fasta_block(
            corpus["fasta"], dna, part, 5, halo=20, file_id=3)
    assert any(b.num_records and b.seg_id[0] == 0 and
               b.offset_in_record[0] > 0 for b in out.values()), \
        "no block begins inside a record"
    return out


def _ids(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    """uint64 ids from their int32 halves."""
    return ((hi.numpy().astype(np.int64) << 32)
            | (lo.numpy().astype(np.int64) & 0xFFFFFFFF)).astype(np.uint64)


def _composed(batch, kind: str) -> np.ndarray:
    """The batch's ids as an index of `kind` composes them (p = 1)."""
    idx = kp.PositionIndex(kp.KmerSpec(21, kp.DNA), device="cpu",
                           id_kind=kind)
    table = torch.from_numpy(idx._pooled_id_table(batch).view(np.int64))
    off = torch.from_numpy(batch.offset_in_record.astype(np.int64)).to(
        kernels.ID_OFF_DTYPES[kind])
    hi, lo = kernels.position_ids(torch.from_numpy(batch.seg_id), off,
                                  table, kind)
    return _ids(hi, lo)


def _assert_ids(got: np.ndarray, batch, kind: str):
    rec = batch.seg_id >= 0
    np.testing.assert_array_equal(got[rec], batch.ids(kind)[rec])
    assert not got[~rec].any(), "a pad carries an id"


def test_every_parser_keeps_global_pos_at_record_start_plus_offset(
        corpus, engine):
    for name, b in _batches(corpus, engine).items():
        rec = b.seg_id >= 0
        want = b.record_start[b.seg_id[rec]] + \
            b.offset_in_record[rec].astype(np.uint64)
        np.testing.assert_array_equal(b.global_pos[rec], want, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_composed_ids_equal_the_batch_ids(corpus, engine, kind):
    batches = _batches(corpus, engine)
    assert batches["long_fasta"].offset_in_record.max() >= 1 << 16
    for b in batches.values():
        _assert_ids(_composed(b, kind), b, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_pads_no_records_file_ids_and_wide_record_starts(corpus,
                                                              kind):
    b = tio.read_file(corpus["fastq"], kp.DNA, file_id=255)
    assert (b.file_id == 255).all()
    chunks = list(b.iter_chunks(4000, 20))
    assert (chunks[-1].seg_id < 0).any(), "the last chunk has no pads"
    for chunk in chunks:
        _assert_ids(_composed(chunk, kind), chunk, kind)
    # record starts past 2^40 (the mask) and seq indexes past 2^24 (the
    # bits a long id shifts out)
    far = dataclasses.replace(
        b, record_start=b.record_start + np.uint64((1 << 41) + 12345),
        global_pos=b.global_pos + np.uint64((1 << 41) + 12345),
        seq_index=b.seq_index + np.uint32((1 << 24) + 7)).pad_to(
            b.num_bases + 33)
    _assert_ids(_composed(far, kind), far, kind)
    empty = tio.parse_fasta(np.zeros(0, np.uint8), kp.DNA).pad_to(50)
    assert empty.num_records == 0
    np.testing.assert_array_equal(_composed(empty, kind), np.zeros(50))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", [1, 4])
def test_marshalled_shards_carry_the_ids(corpus, kind, p):
    """`_marshal_chunk` then `_to_device`, chunk after chunk (the pools
    alternate): each shard's id halves are its bases' ids, halo included,
    and its pads' are 0; the offsets and the record words stay off
    `DeviceBases`."""
    idx = kp.PositionIndex(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p,
                           id_kind=kind)
    halo, _ = idx._chunk_halo()
    b = tio.read_file(corpus["fasta"], kp.DNA)
    for chunk in b.iter_chunks(5000, halo):
        bases = idx._to_device(idx._marshal_chunk(chunk))
        got = _ids(bases.id_hi, bases.id_lo)
        n, L = chunk.num_bases, bases.seg_id.shape[1]
        owned = -(-n // p)
        want = np.zeros((p, L), np.uint64)
        for s in range(p):
            lo = min(s * owned, n)
            ln = min(lo + owned + (halo if p > 1 else 0), n) - lo
            rec = chunk.seg_id[lo:lo + ln] >= 0
            want[s, :ln][rec] = chunk.ids(kind)[lo:lo + ln][rec]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("make", [
    lambda spec: kp.CountIndex(spec, device="cpu"),
    lambda spec: kp.DeBruijnGraph(spec, device="cpu")])
def test_indexes_without_ids_marshal_no_offsets(corpus, make):
    idx = make(kp.KmerSpec(21, kp.DNA))
    b = tio.read_file(corpus["fastq"], idx.parse_alphabet)
    cols = idx._marshal_chunk(b)
    cols = cols[0] if isinstance(cols, tuple) else cols
    assert set(cols) == {"codes", "valid", "seg_id", "owned"}
    bases = idx._to_device(cols)
    assert bases.id_hi is None and bases.id_lo is None


def test_position_ids_refuses_what_it_does_not_take():
    seg = torch.zeros(8, dtype=torch.int32)
    table = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="id kind"):
        kernels.position_ids(seg, seg, table, "medium")
    with pytest.raises(TypeError):
        kernels.position_ids(seg, seg, table, "short")
    with pytest.raises(TypeError):
        kernels.position_ids(seg, seg.to(torch.int16), table, "long")
    with pytest.raises(ValueError):
        kernels.position_ids(seg, seg[:4], table, "long")
    with pytest.raises(TypeError):
        kernels.position_ids(seg, seg, table.to(torch.int32), "long")
