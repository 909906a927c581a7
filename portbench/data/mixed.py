"""The data source ``mixed``: a frozen copy of the port's
``utils/corpus.mixed_corpus``.

Thirds of text-like prose, XML-like records and structured binary, all
drawn from ``numpy.random.default_rng(seed).bytes`` (the raw PCG64
stream) and fixed tables, so the same (nbytes, seed) gives the same bytes
on every machine. The thirds stand in for the text, XML and binary files
of the Silesia corpus, which is not in the repository. The copy is kept
here so that no change to the program can move the benchmark's inputs;
``portbench/tests/test_portbench_frozen.py`` holds it equal to the original while
the original exists.
"""
from __future__ import annotations

import numpy as np

_WORDS = (
    "the of and to in is that for it as with was on be by at this are "
    "from or an have not which but all were they their one can has more "
    "data stream block window match length distance code table header "
    "chunk buffer value offset index sort order rank scan parse commit "
    "literal symbol huffman tree deflate inflate device kernel memory "
    "thread warp batch position prefix suffix compress throughput ratio"
).split()
_PUNCT = [" ", " ", " ", " ", " ", " ", ", ", ". ", ".\n", "; "]


def _rand_u8(rng, n: int) -> np.ndarray:
    return np.frombuffer(rng.bytes(n), dtype=np.uint8)


def _text(rng, n: int) -> bytes:
    # Skewed word choice: the product of two uniform bytes favours the
    # front of the vocabulary, like word frequencies in prose.
    k = n // 4 + 16
    a = _rand_u8(rng, k).astype(np.int64)
    b = _rand_u8(rng, k).astype(np.int64)
    words = (a * b * len(_WORDS)) >> 16
    seps = _rand_u8(rng, k) % len(_PUNCT)
    out = "".join(_WORDS[w] + _PUNCT[s] for w, s in zip(words, seps))
    return out.encode()[:n]


def _xml(rng, n: int) -> bytes:
    k = n // 50 + 16
    r = _rand_u8(rng, 4 * k).reshape(k, 4).astype(np.int64)
    ids = r[:, 0] << 16 | r[:, 1] << 8 | r[:, 2]
    parts = [
        f"<row id='{i}' v='{i % 997}'><name>item-{i % 5000}</name>"
        f"<flag>{'yn'[f & 1]}</flag></row>\n"
        for i, f in zip(ids.tolist(), r[:, 3].tolist())
    ]
    return "".join(parts).encode()[:n]


def _binary(rng, n: int) -> bytes:
    # 16-byte records: u32 counter, u16 small value, 6 random bytes and a
    # 4-byte tag from a small set.
    k = n // 16 + 1
    rec = np.zeros((k, 16), dtype=np.uint8)
    rec[:, 0:4] = np.arange(k, dtype="<u4").view(np.uint8).reshape(k, 4)
    small = (_rand_u8(rng, k).astype("<u2") % 40).view(np.uint8)
    rec[:, 4:6] = small.reshape(k, 2)
    rec[:, 6:12] = _rand_u8(rng, 6 * k).reshape(k, 6)
    tags = np.frombuffer(b"ELF\x00DATATEXTBSS\x00", dtype=np.uint8).reshape(4, 4)
    rec[:, 12:16] = tags[_rand_u8(rng, k) % 4]
    return rec.tobytes()[:n]


def mixed_corpus(nbytes: int, seed=0) -> bytes:
    """`nbytes` of text-like, XML-like and binary thirds. `seed` is
    anything ``numpy.random.default_rng`` takes (an int, or a sequence of
    non-negative ints)."""
    rng = np.random.default_rng(seed)
    third = nbytes // 3
    blob = _text(rng, third) + _xml(rng, third) + _binary(rng, nbytes - 2 * third)
    return blob[:nbytes]


def make(nbytes: int, seed) -> bytes:
    """What a traffic mix with ``"data": "mixed"`` draws for one buffer."""
    return mixed_corpus(nbytes, seed)
