"""K-mer tensor representation.

The port's copy of ``kmerind_tpu.kmer`` (numpy only), after the reference's
``bliss::common::Kmer<K, ALPHABET, WORD_TYPE>``
(src/common/kmer.hpp:116-2050).  Where the reference stores one k-mer per
object as a little array of machine words, a *batch* of k-mers is a dense
``[n, nwords]`` tensor of 32-bit words and every operation is a vectorized
array op (device tensors hold the words as int32 bit patterns, see
``ops/keys.py``).

Layout ("char-aligned big-endian words"):

* ``bits_per_char = ceil(log2(alphabet.size))`` (2 for DNA, 3 for DNA6,
  4 for DNA16).
* ``chars_per_word = 32 // bits_per_char`` characters are packed per uint32
  word, FIRST character in the MOST significant position of the word.
* word 0 holds characters [0, cpw), word 1 holds [cpw, 2*cpw), …; the last
  word holds the remaining ``k - (nwords-1)*cpw`` characters right-aligned
  (its value is < alphabet_size**r).

This differs deliberately from the reference's contiguous bit stream with
MSB padding (kmer.hpp:78-100): char-aligned words cost up to 2 wasted bits
per word for 3-bit alphabets but make every op (compare, revcomp, decode)
a pure word-parallel operation with no cross-word bit carries.
Lexicographic k-mer order is preserved: comparing word 0 first, then
word 1, … equals comparing the character strings, exactly like the
reference's big-integer compare (kmer.hpp:790-865).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabets import Alphabet

__all__ = ["KmerSpec"]


@dataclasses.dataclass(frozen=True)
class KmerSpec:
    """Static description of a k-mer type (analog of the Kmer template args).

    The reference fixes (K, ALPHABET, WORD_TYPE) at compile time
    (kmer.hpp:116); here the spec is a hashable Python value passed to every
    function that needs the layout.
    """

    k: int
    alphabet: Alphabet

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.alphabet.bits_per_char > 32:
            raise ValueError("alphabet too wide")

    # -- derived layout ----------------------------------------------------
    @property
    def bits_per_char(self) -> int:
        return self.alphabet.bits_per_char

    @property
    def chars_per_word(self) -> int:
        return 32 // self.bits_per_char

    @property
    def nwords(self) -> int:
        return -(-self.k // self.chars_per_word)

    @property
    def last_word_chars(self) -> int:
        """Number of characters stored in the final (least significant) word."""
        return self.k - (self.nwords - 1) * self.chars_per_word

    @property
    def nbits(self) -> int:
        return self.k * self.bits_per_char

    @property
    def sentinel_safe(self) -> bool:
        """True iff no valid k-mer can equal the all-ones sentinel row
        (some word has spare bits), enabling flag-free sorts."""
        return self.nwords * 32 > self.nbits

    def word_char_counts(self) -> tuple[int, ...]:
        """Characters held by each word, word 0 first."""
        cpw = self.chars_per_word
        return tuple(
            min(cpw, self.k - w * cpw) for w in range(self.nwords)
        )

    def word_bits(self) -> tuple[int, ...]:
        """Significant bits per word, word 0 first — the last word of a
        non-multiple k is narrow (e.g. 10 bits for DNA k=21), which the
        sort exploits with a narrower comparator column."""
        return tuple(n * self.bits_per_char for n in self.word_char_counts())

    # -- host-side (numpy) scalar helpers, used by tests/tools -------------
    def pack_codes(self, codes: np.ndarray) -> np.ndarray:
        """Pack one k-mer's codes (len k) into its word array (numpy)."""
        codes = np.asarray(codes, dtype=np.uint64)
        assert codes.shape == (self.k,)
        b = self.bits_per_char
        cpw = self.chars_per_word
        words = np.zeros(self.nwords, dtype=np.uint32)
        for w, nch in enumerate(self.word_char_counts()):
            v = np.uint64(0)
            for j in range(nch):
                v = (v << np.uint64(b)) | codes[w * cpw + j]
            words[w] = np.uint32(v)
        return words

    def unpack_words(self, words: np.ndarray) -> np.ndarray:
        """Word array -> codes (len k) (numpy)."""
        words = np.asarray(words, dtype=np.uint64)
        b = self.bits_per_char
        out = np.zeros(self.k, dtype=np.uint8)
        cpw = self.chars_per_word
        mask = np.uint64((1 << b) - 1)
        for w, nch in enumerate(self.word_char_counts()):
            v = words[w]
            for j in reversed(range(nch)):
                out[w * cpw + j] = np.uint8(v & mask)
                v = v >> np.uint64(b)
        return out

    def from_string(self, s: str) -> np.ndarray:
        codes = self.alphabet.encode(s)
        if codes.shape[0] != self.k:
            raise ValueError(f"need exactly k={self.k} chars, got {codes.shape[0]}")
        return self.pack_codes(codes)

    def to_string(self, words: np.ndarray) -> str:
        """Decode a word array back to ASCII (analog of Kmer::toString,
        kmer.hpp:1151)."""
        return self.alphabet.decode(self.unpack_words(words))

    def to_int(self, words: np.ndarray) -> int:
        """Word array -> arbitrary-precision integer with the value
        sum(code[i] * size**(k-1-i)) — the reference's big-integer view."""
        codes = self.unpack_words(words)
        v = 0
        for c in codes:
            v = v * (1 << self.bits_per_char) + int(c)
        return v

    def to_ints(self, rows: np.ndarray) -> np.ndarray:
        """Vectorized `to_int` over [n, nwords] rows.

        Concatenating each word's significant bits big-endian equals the
        per-char accumulation of to_int (words are char-aligned with the
        last word right-aligned).  Returns uint64 when the key fits 64
        bits, else an object array of Python ints (k=63 DNA etc.)."""
        rows = np.asarray(rows, dtype=np.uint32).reshape(-1, self.nwords)
        wbits = self.word_bits()
        if self.nbits <= 64:
            out = np.zeros(rows.shape[0], np.uint64)
            for w in range(self.nwords):
                out = (out << np.uint64(wbits[w])) \
                    | rows[:, w].astype(np.uint64)
            return out
        out = np.zeros(rows.shape[0], object)
        cols = rows.astype(object)
        for w in range(self.nwords):
            out = (out << wbits[w]) | cols[:, w]
        return out

    def from_int(self, value: int) -> np.ndarray:
        """Inverse of `to_int`: arbitrary-precision integer -> uint32
        word row (word 0 most significant; words are char-aligned with
        the last word right-aligned, matching to_ints' big-endian
        concatenation of each word's significant bits)."""
        wbits = self.word_bits()
        out = np.zeros(self.nwords, np.uint32)
        v = int(value)
        for w in range(self.nwords - 1, -1, -1):
            out[w] = v & ((1 << wbits[w]) - 1)
            v >>= wbits[w]
        if v:
            raise ValueError(
                f"integer does not fit a k={self.k} "
                f"{self.alphabet.name} k-mer")
        return out

    def __repr__(self):
        return f"KmerSpec(k={self.k}, {self.alphabet.name})"
