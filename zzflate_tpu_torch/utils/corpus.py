"""A seeded synthetic corpus whose bytes do not depend on the machine.

Thirds of text-like prose, XML-like records and structured binary, all
drawn from ``numpy.random.default_rng(seed).bytes`` (the raw PCG64
stream) and fixed tables, so the same (nbytes, seed) gives the same bytes
on every machine with the same PCG64. Also the seeded synthetic inputs of
device decode's per-bit kernels (``candidate_inputs``,
``commit_walk_inputs``, ``resolve_inputs``, ``scatter_inputs``), which
the tests and chip_smoke.py share, and of the optimal parse's DP
(``optimal_dp_inputs``, ``optimal_batch_data``).
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


# The LZ tail's cases (ops/kernels.token_scatter and resolve_lz), each aimed
# at one rule of the reference's scatters or its source chase.
RESOLVE_CASES = ("chain_2e20", "full_chain", "prefix_and_stored",
                 "dist_past_start", "forward_marks")
SCATTER_CASES = ("random", "same_slot", "past_end", "prefix_and_stored")
_W = 32768  # the prefix a group carries: output positions [0, _W)


def _staged(rng, n: int):
    """Output-space arrays as device decode stages them: the 32 KiB
    prefix as self-resolved literals, two stored runs (self-resolved
    bytes), and -1 / 0 elsewhere. Returns (litval, start_mark, dist_at),
    int32, and the stored runs' slots."""
    idx = np.arange(n)
    litval = np.zeros(n, np.int32)
    start_mark = np.full(n, -1, np.int32)
    dist_at = np.zeros(n, np.int32)
    w = min(_W, n)
    litval[:w] = rng.integers(0, 256, w)
    start_mark[:w] = idx[:w]
    stored = np.zeros(n, bool)
    for lo in (n // 5, n // 3):
        stored[lo : lo + min(3000, n // 16)] = True
    litval[stored] = rng.integers(0, 256, int(stored.sum()))
    start_mark[stored] = idx[stored]
    return litval, start_mark, dist_at, stored


def resolve_inputs(case: str, n: int, seed: int = 0):
    """(litval, start_mark, dist_at) of one case, (n,) int32 each.

    chain_2e20: every position of [0, 2^20] a token of distance 1 (0 a
    literal): a chain 2^20 deep, 21 doubling rounds; -1 past it (n >
    2^20 + 1). full_chain: the same over all n positions. prefix_and_
    stored: staged prefix and stored runs, then literal and match tokens
    over the first half, some on prefix and stored slots, and -1 over the
    second half (the padding past a group's output). dist_past_start:
    matches whose distance reaches before position 0 (the first hop is
    clipped to 0). forward_marks: outside the decoders' domain
    (start_mark[j] anywhere up to 2n, not only -1 or j, and distances up
    to 1 000 anywhere), so first hops point forward and some are clipped
    to n - 1."""
    rng = np.random.default_rng([seed, n, RESOLVE_CASES.index(case)])
    idx = np.arange(n)
    litval = rng.integers(0, 256, n).astype(np.int32)
    if case in ("chain_2e20", "full_chain"):
        end = n if case == "full_chain" else (1 << 20) + 1
        start_mark = np.where(idx < end, idx, -1).astype(np.int32)
        dist_at = np.where((idx > 0) & (idx < end), 1, 0).astype(np.int32)
        return litval, start_mark, dist_at
    if case == "forward_marks":
        start_mark = np.where(rng.random(n) < 1e-4,
                              rng.integers(0, 2 * n, n), -1).astype(np.int32)
        dist_at = rng.integers(0, 1000, n).astype(np.int32)
        return litval, start_mark, dist_at
    litval, start_mark, dist_at, stored = _staged(rng, n)
    half = n // 2 if case == "prefix_and_stored" else n
    lo = min(_W, n) // 2 if case == "prefix_and_stored" else 0
    pos = lo
    while pos < half:
        if rng.random() < 0.4:
            litval[pos] = rng.integers(0, 256)
            start_mark[pos] = pos
            pos += 1
            continue
        ln = int(rng.integers(3, 259))
        far = case == "dist_past_start" and rng.random() < 0.3
        d = int(rng.integers(pos + 1, pos + 40000) if far
                else rng.integers(1, min(32768, max(pos, 1)) + 1))
        start_mark[pos] = pos
        dist_at[pos] = d
        pos += ln
    start_mark[half:] = np.where(stored[half:], start_mark[half:], -1)
    return litval, start_mark, dist_at


def scatter_inputs(case: str, nbits: int, n_out_pad: int, seed: int = 0):
    """The per-bit path's token scatter inputs of one case: the staged
    (litval, start_mark, dist_at), (n_out_pad,) int32, and (off,
    committed, islit, islen, sym, mdist) over nbits bits (off int64 from
    the offsets' cumsum, the masks bool, sym and mdist int32 as
    decode_candidates hands them).

    random: a committed token every ~10 bits, uncommitted bits holding
    junk (offsets anywhere, some past the end; symbols and distances of
    any size within int32). same_slot: pairs of committed tokens on one
    slot (two literals, two matches, a literal and a match). past_end:
    committed tokens at n_out_pad - 1, n_out_pad and beyond. prefix_and_
    stored: tokens on the staged prefix's and stored runs' slots. Every
    offset is >= 0, as the decoder's are."""
    rng = np.random.default_rng([seed, nbits, SCATTER_CASES.index(case)])
    litval, start_mark, dist_at, stored = _staged(rng, n_out_pad)
    off = rng.integers(0, 2 * n_out_pad, nbits)
    committed = rng.random(nbits) < 0.1
    islit = rng.random(nbits) < 0.55
    islen = ~islit & (rng.random(nbits) < 0.9)
    islen[rng.random(nbits) < 0.01] = True  # both kinds set: junk bits
    sym = rng.integers(-(1 << 31), 1 << 31, nbits)
    mdist = rng.integers(-(1 << 31), 1 << 31, nbits)
    tok = np.flatnonzero(committed)
    # Committed tokens: increasing offsets from the prefix's end, real
    # literals (< 256) and distances (1..32 768).
    off[tok] = _W + np.cumsum(rng.integers(1, 8, tok.size))
    sym[tok] = rng.integers(0, 256, tok.size)
    mdist[tok] = rng.integers(1, 32769, tok.size)
    if case == "same_slot":
        k = tok.size // 2
        a, b = tok[0 : k : 2], tok[1 : k : 2]
        m = min(a.size, b.size)
        off[b[:m]] = off[a[:m]]
        kind = np.arange(m) % 3
        islit[a[:m]] = islit[b[:m]] = kind != 1  # lit+lit, match+match,
        islen[a[:m]] = islen[b[:m]] = kind == 1  # lit+match
        islen[b[:m][kind == 2]], islit[b[:m][kind == 2]] = True, False
    elif case == "past_end":
        t = tok[-200:]
        off[t] = n_out_pad - 100 + np.arange(t.size)
        off[tok[:3]] = [n_out_pad - 1, n_out_pad, 2 * n_out_pad]
    elif case == "prefix_and_stored":
        t = tok[: tok.size // 2]
        slots = np.r_[np.arange(min(_W, n_out_pad)), np.flatnonzero(stored)]
        off[t] = rng.choice(slots, t.size)
    return ((litval, start_mark, dist_at),
            (off.astype(np.int64), committed, islit, islen,
             sym.astype(np.int32), mdist.astype(np.int32)))


# The candidate decode's cases (ops/kernels.decode_candidates), each aimed
# at a branch of the reference's LUT decode or of the owning unit.
CANDIDATE_CASES = ("random", "fixed_code", "incomplete_code", "eob_at_end",
                   "starts", "one_unit", "many_units")


def _random_lengths(rng, nsym: int, nleaves: int) -> np.ndarray:
    """Code lengths of a random complete prefix code of nleaves symbols
    (at most 15 bits): leaves split at random, half the time the deepest
    one, so long codes occur; the symbols drawn at random."""
    depths = [0]
    while len(depths) < nleaves:
        ok = [i for i, dd in enumerate(depths) if dd < 15]
        i = max(ok, key=depths.__getitem__) if rng.random() < 0.5 else \
            ok[int(rng.integers(len(ok)))]
        dd = depths.pop(i)
        depths += [dd + 1, dd + 1]
    lengths = np.zeros(nsym, np.int32)
    lengths[rng.choice(nsym, nleaves, replace=False)] = depths
    return lengths


def _code_rows(kind: str, rng):
    """(ll lengths, d lengths) of one unit's codes. random: complete codes
    over every symbol (litlen 286 and 287, distances 30 and 31 among
    them); fixed: BTYPE 1 (litlen 286 and 287 reachable, distance codes 30
    and 31 past its tree); incomplete: litlen 'A' = 00, EOB = 01, length 3
    = 100, and 101, 11x past the tree; distance 0 = 0, 30 = 10, 31 = 110,
    and 111 past the tree."""
    from zzflate_tpu_torch import constants as C

    if kind == "fixed":
        return C.fixed_litlen_lengths(), C.fixed_dist_lengths()
    if kind == "incomplete":
        ll = np.zeros(288, np.int32)
        ll[[65, 256, 257]] = [2, 2, 3]
        d = np.zeros(32, np.int32)
        d[[0, 30, 31]] = [1, 2, 3]
        return ll, d
    ll = _random_lengths(rng, 288, int(rng.integers(2, 289)))
    if not ll[256]:  # every litlen code holds an EOB
        k = rng.choice(np.flatnonzero(ll))
        ll[256], ll[k] = ll[k], 0
    return ll, _random_lengths(rng, 32, int(rng.integers(1, 33)))


def _plant(bits: np.ndarray, at: int, code: int, length: int) -> None:
    """Write an MSB-first canonical code into the stream, LSB first."""
    for i in range(length):
        bits[at + i] = (code >> (length - 1 - i)) & 1


def candidate_inputs(case: str, nbits: int, seed: int = 0):
    """(words, ll, d, start_bits, unit_valid) of one case at nbits (a
    multiple of 1 024): words (nbits / 32 + 2,) int32 carrying u32 bits;
    ll = (first, cnt, off, sym) as (U, 16) x3 and (U, 288) int32, d the
    same with (U, 32), the host plan's canonical rows of each unit's codes
    (zero rows for a padding unit); start_bits (U,) int32; unit_valid (U,)
    bool. The words are random bits, so most windows of a complete code
    decode to some token and most of an incomplete one fall past it.

    random: 8 units of random, fixed and incomplete codes, starts unsorted,
    one repeated, a padding unit (invalid, start 0), a valid unit past the
    end (dropped) and no start before bit 100 (unit 0 owns those bits).
    fixed_code, incomplete_code: 2 and 3 units of one code. eob_at_end:
    EOB codes planted in the last bits and on the last one, whose windows
    run into the two words past the group. starts: 16 units at bit 0, at
    nbits - 1, repeated, at nbits and past it, padding units between.
    one_unit: U = 1. many_units: U = 1 024, some padding, some past the
    end, some repeated."""
    from zzflate_tpu_torch import constants as C
    from zzflate_tpu_torch.models.inflate import CanonicalDecoder
    from zzflate_tpu_torch.models.inflate_device import _canon_desc

    rng = np.random.default_rng([seed, nbits, CANDIDATE_CASES.index(case)])
    u = {"random": 8, "fixed_code": 2, "incomplete_code": 3,
         "eob_at_end": 4, "starts": 16, "one_unit": 1,
         "many_units": 1024}[case]
    kinds = {"fixed_code": ["fixed"], "incomplete_code": ["incomplete"]}.get(
        case, ["random", "random", "fixed", "incomplete"])
    pool = [_code_rows(k, rng) for k in kinds]
    start = rng.integers(100, nbits, u)
    valid = np.ones(u, bool)
    if case == "random":
        start[5] = start[2]
        start[3], valid[3] = 0, False
        start[7] = nbits + 5
    elif case == "starts":
        start[:6] = [0, nbits - 1, nbits - 1, nbits, nbits + 12345,
                     (1 << 31) - 1]
        start[6:9] = start[9]
        start[10:13], valid[10:13] = 0, False
    elif case == "eob_at_end":
        start[0] = 0
        start[-1] = nbits - 300
    elif case == "one_unit":
        start[0] = 100
    elif case == "many_units":
        start[900:1000], valid[900:1000] = 0, False
        start[1000:1010] = nbits + rng.integers(0, 1000, 10)
        start[100:200] = start[200:300]
    which = rng.integers(0, len(pool), u)
    rows = []
    for k, tab in ((0, 288), (1, 32)):
        out = [np.zeros((u, 16), np.int32) for _ in range(3)]
        out.append(np.zeros((u, tab), np.int32))
        for j in range(u):
            if not valid[j]:
                continue  # a padding unit keeps zero rows, as staged
            for dst, src in zip(out, _canon_desc(
                    CanonicalDecoder(list(pool[which[j]][k])), tab)):
                dst[j] = src
        rows.append(tuple(out))
    bits = (rng.random(nbits + 64) < 0.5).astype(np.uint8)
    if case == "eob_at_end":
        # The last bits' owner: the highest unit started before them.
        ll_len = pool[which[-1]][0]
        code = int(C.canonical_codes(ll_len)[256])
        for at in (nbits - 40, nbits - 9, nbits - 1):
            _plant(bits, at, code, int(ll_len[256]))
    words = np.packbits(bits, bitorder="little").view("<u4").view(np.int32)
    return (words.copy(), rows[0], rows[1], start.astype(np.int32), valid)


OPTIMAL_CASES = ("random", "lengths-past-end", "lengths-257-258",
                 "absent-symbols", "all-absent", "many-sub-blocks", "zeros",
                 "periodic", "even-lengths")


def optimal_dp_inputs(case: str, n: int = 3000, seed: int = 0):
    """A batch for the optimal parse's DP, as the C DP takes a row: (data
    (4, n) uint8, mlen, mdist (4, n) int32, starts, ends (4,) int32,
    lengths (4, SB, 318) int32: each sub-block's litlen then distance code
    lengths, bounds (SB + 1,) int32). Row 0 parses [start, end), row 1 is
    a padded row (end == start), row 2 a short one, row 3 the whole row,
    partly below bounds[0]; every row holds candidates of any length and
    distance.

    random: half the positions a match of 3..258; lengths-past-end: every
    one, the last 300 of length 258 (past end - i); lengths-257-258: 0, 3,
    256, 257 and 258 only; absent-symbols, all-absent: 60% and every code
    length 0 (priced at 30 bits); many-sub-blocks: 7 of them; zeros and
    periodic: the runs a matcher finds at distance 1 and 3 over zero and
    period-3 bytes (ties between the literal and matches, and between
    classes); even-lengths: every code length 8, so most candidates
    tie."""
    rng = np.random.default_rng([seed, n, OPTIMAL_CASES.index(case)])
    b = 4
    nsb = 7 if case == "many-sub-blocks" else 3
    start, end = n // 30, n - n // 30
    data = rng.integers(0, 256, (b, n)).astype(np.uint8)
    if case == "lengths-past-end":
        mlen = rng.integers(3, 259, (b, n))
        mlen[:, -300:] = 258
    elif case == "lengths-257-258":
        mlen = rng.choice([0, 3, 256, 257, 258], (b, n))
    elif case in ("zeros", "periodic"):
        per = 1 if case == "zeros" else 3
        data = np.tile(np.arange(per, dtype=np.uint8) * 7, (b, n // per + 1))
        data = np.ascontiguousarray(data[:, :n])
        left = n - np.arange(n)
        mlen = np.where(np.arange(n) >= per, np.minimum(left, 258), 0)
        mlen = np.tile(mlen, (b, 1))
    else:
        mlen = np.where(rng.random((b, n)) < 0.5,
                        rng.integers(3, 259, (b, n)), 0)
    if case in ("zeros", "periodic"):
        mdist = np.where(mlen > 0, 1 if case == "zeros" else 3, 0)
    else:
        mdist = np.where(mlen > 0, rng.integers(1, 32769, (b, n)), 0)
    lengths = rng.integers(1, 16, (b, nsb, 318))
    zero = {"absent-symbols": 0.6, "all-absent": 1.0}.get(case, 0.0)
    lengths[rng.random((b, nsb, 318)) < zero] = 0
    if case in ("zeros", "periodic", "even-lengths"):
        lengths[:] = 8
    bounds = [start + (k * (end - start)) // nsb for k in range(nsb)] + [end]
    starts = np.array([start, start + 10, start, 0], np.int32)
    ends = np.array([end, start + 10, start + 37, n], np.int32)
    return (data, mlen.astype(np.int32), mdist.astype(np.int32), starts,
            ends, lengths.astype(np.int32), np.array(bounds, np.int32))


# Batches of the level 7-9 override: (level, analyze_chunks_batch keywords).
OPTIMAL_OVERRIDE_CASES = {
    "L7": (7, {}),
    "L8": (8, {}),
    "L9": (9, {}),
    "window-bits-9": (9, {"max_dist": 512}),
    "filtered": (9, {"strategy": 1}),
    "rle": (9, {"strategy": 3}),
    "fixed": (9, {"strategy": 4}),
}


def optimal_batch_data(chunk: int, seed: int = 0) -> bytes:
    """Input for a batch of the level 7-9 encode at `chunk`-byte chunks:
    mixed corpus, a chunk of zero bytes, a periodic one, mixed again and a
    short last chunk, so a batch of 8 rows holds padded rows too."""
    return (mixed_corpus(chunk, seed) + bytes(chunk)
            + b"abcab" * (chunk // 5) + bytes(chunk % 5)
            + mixed_corpus(chunk + 777, seed + 1))
