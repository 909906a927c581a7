"""A seeded synthetic corpus whose bytes do not depend on the machine.

Thirds of text-like prose, XML-like records and structured binary, all
drawn from ``numpy.random.default_rng(seed).bytes`` (the raw PCG64
stream) and fixed tables, so the same (nbytes, seed) gives the same bytes
on every machine with the same PCG64. Also the commit walk's seeded
synthetic inputs (``commit_walk_inputs``), which the tests and
chip_smoke.py share.
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


def mixed_corpus(nbytes: int, seed: int = 0) -> bytes:
    """`nbytes` of text-like, XML-like and binary thirds."""
    rng = np.random.default_rng(seed)
    third = nbytes // 3
    blob = _text(rng, third) + _xml(rng, third) + _binary(rng, nbytes - 2 * third)
    return blob[:nbytes]


# The commit walk's cases (ops/kernels.commit_walk), each aimed at one
# rule of the reference's sweeps; every case but "shared_row" has eight
# units, the sixth invalid.
COMMIT_CASES = ("random", "edges", "across_superrows", "span_cut",
                "dense_stops", "wide_steps", "shared_row")
_SUPERROW = 1 << 16  # bits a superrow of the sweeps (256 rows of 256)
_STOP = 257  # ops/canonical._HUGE: EOB or an invalid window, the walk stops


def commit_walk_inputs(case: str, nbits: int, seed: int = 0):
    """(step, start_bits, unit_valid, max_sup_span) of one case at nbits
    (a multiple of 65 536): step (nbits,) int32 in [1, 48] with stops,
    start_bits (U,) int32, unit_valid (U,) bool. max_sup_span is at its
    cap, nbits // 65 536, except in "span_cut", where it ends every chain
    halfway.

    random: stops at 0.2% of the bits, starts anywhere. edges: starts at
    bit 0, in the last row and on the last bit, few stops (blocks across
    superrows). across_superrows and
    span_cut: no stop at all, every start in the first superrow. dense_
    stops: a stop at 5% of the bits, four starts within one row.
    wide_steps: steps in [1, 256] (the domain's edge). shared_row: steps
    of 8 with stops at bits 96 and 400, blocks starting at 0 and 120:
    the second block's first token lies in the row of the first block's
    EOB, so the reference's least-entry rule leaves bits 120-248
    unmarked."""
    nsup = nbits // _SUPERROW
    if case == "shared_row":
        step = np.full(nbits, 8, np.int32)
        step[[96, 400]] = _STOP
        return step, np.array([0, 120], np.int32), np.ones(2, bool), nsup
    rng = np.random.default_rng([seed, nbits, COMMIT_CASES.index(case)])
    u = 8
    stop_p = {"random": 2e-3, "edges": 1e-4, "across_superrows": 0.0,
              "span_cut": 0.0, "dense_stops": 0.05, "wide_steps": 2e-3}[case]
    step = rng.integers(1, (256 if case == "wide_steps" else 48) + 1, nbits)
    step = np.where(rng.random(nbits) < stop_p, _STOP, step).astype(np.int32)
    start = rng.integers(0, nbits, u)
    valid = np.ones(u, bool)
    valid[5] = False
    span = nsup
    if case == "edges":
        start[:3] = [0, nbits - 200, nbits - 1]
    elif case in ("across_superrows", "span_cut"):
        start = rng.integers(0, _SUPERROW, u)
        start[0] = 0
        if case == "span_cut":
            span = nsup // 2
    elif case == "dense_stops":
        start[:4] = start[0] // 256 * 256 + np.array([0, 8, 40, 100])
    return step, start.astype(np.int32), valid, span
