"""The lex_greater and xor_rev_comp strand transforms and the packed-word
ops of ``ops/bitops.py`` against the JAX package, on the CPU.

* ``packing.extract_canonical_greater`` / ``extract_xor_rev_comp`` on
  every alphabet at k = 15, 21, 31, 63 (the valid window prefix);
* every ``bitops`` function on k-mers of every alphabet;
* ``CountIndex`` and ``PositionIndex`` built with either transform against
  the JAX indexes (the conftest's 8-device CPU mesh): to_dict() equal, and
  queries given in either orientation answered alike (the query
  transform).

Integer outputs: exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerind_tpu as kt
import kmerind_tpu.alphabets as jal
import kmerind_tpu_torch as kp
import kmerind_tpu_torch.alphabets as tal
from kmerind_tpu.index import api as japi
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu.ops import bitops as jbitops
from kmerind_tpu.ops import packing as jpacking
from kmerind_tpu.parallel.mesh import make_mesh
from kmerind_tpu_torch.io.kmer_parsers import TRANSFORMS, transform_name
from kmerind_tpu_torch.ops import bitops, packing

from torch_parity import words_np, words_t, write_reads

ALPHABETS = ["DNA", "RNA", "DNA5", "DNA6", "RNA6", "DNA16", "DNA_IUPAC",
             "ASCII"]
KS = [15, 21, 31, 63]


def _codes(alpha, k, n=800):
    rng = np.random.default_rng(k * 17 + alpha.size)
    return rng.integers(0, alpha.size, n).astype(np.uint8)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ALPHABETS)
def test_strand_transforms_match_jax(name, k):
    ja, ta = jal.by_name(name), tal.by_name(name)
    codes = _codes(ja, k)
    jspec, tspec = kt.KmerSpec(k, ja), kp.KmerSpec(k, ta)
    nv = codes.shape[0] - k + 1
    jw, jrc = jpacking.extract_canonical_greater(jnp.asarray(codes), jspec)
    tw, trc = packing.extract_canonical_greater(torch.from_numpy(codes),
                                                tspec)
    np.testing.assert_array_equal(words_np(tw)[:nv], np.asarray(jw)[:nv])
    np.testing.assert_array_equal(trc.numpy()[:nv], np.asarray(jrc)[:nv])
    jx = jpacking.extract_xor_rev_comp(jnp.asarray(codes), jspec)
    tx = packing.extract_xor_rev_comp(torch.from_numpy(codes), tspec)
    np.testing.assert_array_equal(words_np(tx)[:nv], np.asarray(jx)[:nv])
    # lex_greater is the larger strand: lex_less's other choice
    lw, lrc = packing.extract_canonical(torch.from_numpy(codes), tspec)
    pal = (lw == tw).all(dim=1)[:nv]
    assert ((trc[:nv] != lrc[:nv]) | pal).all()


def _words(spec_j, spec_t, n=300, seed=0):
    codes = np.random.default_rng(seed).integers(
        0, spec_j.alphabet.size, (n, spec_j.k)).astype(np.uint8)
    return np.stack([spec_j.pack_codes(c) for c in codes]), codes


@pytest.mark.parametrize("name", ALPHABETS)
def test_bitops_match_jax(name):
    """Every bitops function on k-mers of the alphabet at one of KS (one to
    16 words; DNA also at k = 7)."""
    ja, ta = jal.by_name(name), tal.by_name(name)
    for k in (KS[ALPHABETS.index(name) % 4],) + ((7,) if name == "DNA"
                                                  else ()):
        jspec, tspec = kt.KmerSpec(k, ja), kp.KmerSpec(k, ta)
        w, codes = _words(jspec, tspec, seed=k)
        jw, tw = jnp.asarray(w), words_t(w)
        other, _ = _words(jspec, tspec, seed=k + 1)
        other[::3] = w[::3]                   # some equal rows
        jo, to = jnp.asarray(other), words_t(other)

        def same(got, want):
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, x in zip(got, want):
                x = np.asarray(x)
                if g.dtype == torch.int32:   # uint32 words, or -1 / 0 / 1
                    g, x = words_np(g), x.astype(np.uint32)
                else:
                    g = g.numpy()
                assert g.dtype == x.dtype
                np.testing.assert_array_equal(g, x)

        same(bitops.reverse(tw, tspec), jbitops.reverse(jw, jspec))
        same(bitops.revcomp(tw, tspec), jbitops.revcomp(jw, jspec))
        for s in (1, 3, k):
            same(bitops.shift_left_chars(tw, tspec, s),
                 jbitops.shift_left_chars(jw, jspec, s))
            same(bitops.shift_right_chars(tw, tspec, s),
                 jbitops.shift_right_chars(jw, jspec, s))
        same(bitops.kmer_equal(tw, to), jbitops.kmer_equal(jw, jo))
        same(bitops.kmer_compare(tw, to), jbitops.kmer_compare(jw, jo))
        for op in ("kmer_xor", "kmer_and", "kmer_or"):
            same(getattr(bitops, op)(tw, to), getattr(jbitops, op)(jw, jo))
        same(bitops.prefix64(tw), jbitops.prefix64(jw))
        same(bitops.suffix64(tw), jbitops.suffix64(jw))
        same(bitops.infix_chars(tw, tspec, 2, k - 3),
             jbitops.infix_chars(jw, jspec, 2, k - 3))
        same(bitops.get_chars_at(tw, tspec, 1, 4),
             jbitops.get_chars_at(jw, jspec, 1, 4))
        new = codes[:, :3][::-1].copy()
        same(bitops.set_chars_at(tw, tspec, 2, torch.from_numpy(new)),
             jbitops.set_chars_at(jw, jspec, 2, jnp.asarray(new)))
        mask = np.full(w.shape[1], 0xF0F0F0F0, np.uint32)
        same(bitops.masked_equal(tw, to, words_t(mask)),
             jbitops.masked_equal(jw, jo, jnp.asarray(mask)))
    for bits in (1, 2, 4, 8, 16):
        x = np.random.default_rng(bits).integers(0, 2**32, 500,
                                                 dtype=np.uint32)
        same(bitops.char_reverse_word_swar(words_t(x), bits),
             jbitops.char_reverse_word_swar(jnp.asarray(x), bits))
    with pytest.raises(ValueError):
        bitops.char_reverse_word_swar(words_t(x), 3)


def test_transform_names():
    assert TRANSFORMS == ("single", "lex_less", "lex_greater", "xor_rev_comp")
    assert [transform_name(t) for t in (False, True, *TRANSFORMS)] == [
        "single", "lex_less", *TRANSFORMS]
    with pytest.raises(ValueError, match="unknown transform"):
        transform_name("lex_middle")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_transforms") / "reads.fastq"
    seqs = write_reads(path, 60, 90, 700, seed=12, n_rate=0.01)
    return path, seqs


@functools.lru_cache(maxsize=None)
def _jax_index(path: str, family: str, transform: str, p: int):
    cls = japi.CountIndex if family == "count" else japi.PositionIndex
    idx = cls(kt.KmerSpec(21, kt.DNA), mesh=make_mesh(p),
              canonical=transform)
    idx.insert_batch(jax_read_file(path, kt.DNA))
    jax.block_until_ready(idx.store if family != "count" else idx.runs)
    return idx, idx.to_dict()


def _revcomp(s: str) -> str:
    return "".join({"A": "T", "C": "G", "G": "C", "T": "A"}[c]
                   for c in reversed(s))


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("transform", ["lex_greater", "xor_rev_comp"])
@pytest.mark.parametrize("family", ["count", "position"])
def test_indexes_with_transforms_match_jax(reads, family, transform, p):
    path, seqs = reads
    jidx, want = _jax_index(str(path), family, transform, p)
    cls = kp.CountIndex if family == "count" else kp.PositionIndex
    idx = cls(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p,
              canonical=transform)
    assert idx.transform == transform
    idx.insert_batch(kp.io.read_file(path, kp.DNA), chunk_bases=1000)
    assert idx.to_dict() == want
    rng = np.random.default_rng(p)
    q = [seqs[i][o:o + 21] for i, o in zip(
        rng.integers(0, len(seqs), 40), rng.integers(0, 70, 40))]
    q = [s.replace("N", "A") for s in q]
    q += [_revcomp(s) for s in q[:20]]
    q += ["".join(rng.choice(list("ACGT"), 21)) for _ in range(10)]
    np.testing.assert_array_equal(idx.count(q), jidx.count(q))
    assert (idx.count(q[:40]) > 0).all()
    np.testing.assert_array_equal(idx.count(q[:20]), idx.count(q[40:60]))
    if family == "position":
        ids, mask = idx.find(q[:20])
        jids, jmask = jidx.find(q[:20])
        for i in range(20):
            assert sorted(ids[i][mask[i]]) == sorted(jids[i][jmask[i]])
