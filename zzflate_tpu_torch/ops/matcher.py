"""LZ77 match finding and parse commit, batched over chunks.

Port of ``zzflate_tpu/ops/matcher.py``. The JAX package runs
``find_matches`` per chunk under ``vmap``; here every array carries the
batch dimension explicitly, (B, N), one row per chunk. The algorithm is
the reference's:

- candidate lookup = two stable suffix sorts (order A by the leading
  4-byte word, order B by the full key), scored by the K-neighbour scan
  kernel;
- exact long-match extension by dense key-block ranks, at stride-32
  anchors when the key is at least 32 bytes, then a 16-byte word tail;
- interior-suffix propagation kernel;
- greedy/lazy commit by serial row sweeps (the parse kernel).

u32 words are carried as int64 values in [0, 2^32), so signed order is
unsigned order and XOR-based LCPs are unchanged.
"""
from __future__ import annotations

import torch

from zzflate_tpu_torch.constants import MAX_MATCH, MIN_MATCH, WINDOW_SIZE
from zzflate_tpu_torch.ops import kernels

_TOO_FAR = 4096  # reject len-3 matches farther than this (zlib heuristic)
_STRIDE = 32  # extension anchor stride
# Serial row sweep size of the parse; must exceed MAX_MATCH so every
# row's exit lands in the next row.
_ROW = 512


def _pack_words(data, nwords: int) -> list:
    """w[j][b, i] = BIG-endian u32 of bytes data[b, i+4j : i+4j+4] (int64),
    zero past the end. Big-endian so integer order is byte-lexicographic."""
    b, n = data.shape
    d = torch.cat(
        [data, torch.zeros((b, 4 * nwords + 4), dtype=data.dtype,
                           device=data.device)], dim=1,
    ).long()
    m = n + 4 * nwords
    base = (d[:, 0:m] << 24) | (d[:, 1:m + 1] << 16) | (d[:, 2:m + 2] << 8) \
        | d[:, 3:m + 3]
    return [base[:, 4 * j:4 * j + n] for j in range(nwords)]


def _word_lcp_bytes(x):
    """Leading equal bytes (0..4) of two u32s given their XOR (BE order)."""
    b0 = (x & 0xFF000000) == 0
    b1 = b0 & ((x & 0xFF0000) == 0)
    b2 = b1 & ((x & 0xFF00) == 0)
    b3 = b2 & ((x & 0xFF) == 0)
    return b0.int() + b1.int() + b2.int() + b3.int()


def _lcp_words(aw: list, bw: list):
    """Byte LCP (0..4*len(aw)) of two keys given as u32 word lists."""
    lcp = None
    all_eq = None
    for a, b in zip(aw, bw):
        l = _word_lcp_bytes(a ^ b)
        if lcp is None:
            lcp, all_eq = l, l == 4
        else:
            lcp = lcp + torch.where(all_eq, l, 0)
            all_eq = all_eq & (l == 4)
    return lcp


def _stable_order(keys: list):
    """Permutation sorting each row lexicographically by `keys` (int64
    u32 words, most significant first), ties in position order: LSD
    passes of a stable sort over word pairs packed as
    (hi - 2^31) * 2^32 + lo."""
    b, n = keys[0].shape
    perm = torch.arange(n, device=keys[0].device).expand(b, n)
    for p in reversed(range(0, len(keys), 2)):
        hi = keys[p]
        lo = keys[p + 1] if p + 1 < len(keys) else torch.zeros_like(hi)
        key = (hi - (1 << 31)) * (1 << 32) + lo
        _, idx = torch.sort(key.gather(1, perm), dim=1, stable=True)
        perm = perm.gather(1, idx)
    return perm


def _merge(best_pack, s_len, s_dist, spos):
    """Scatter sort-space results to position order and fold into bests.
    Candidates are packed as len << 15 | (32768 - dist): one max gives the
    (longest, then nearest) preference."""
    pack = torch.where(s_len > 0, (s_len << 15) | (WINDOW_SIZE - s_dist), 0)
    p = torch.zeros_like(best_pack).scatter_(1, spos, pack)
    return torch.maximum(best_pack, p)


def _unpack_best(best_pack):
    """(mlen, mdist) from the packed best; 0 length -> 0 distance."""
    mlen = best_pack >> 15
    mdist = WINDOW_SIZE - (best_pack & (WINDOW_SIZE - 1))
    mdist = torch.where(mlen > 0, mdist, 0)
    return mlen, mdist


def _scan_order(sw: list, spos, window_start, best_pack, k_each: int,
                lcp_cap: int, backward_only: bool = False):
    """Score K sorted neighbours of one suffix order (the scan kernel) and
    merge them into the per-position bests. Returns (best_pack, adj)."""
    adj = _lcp_words([torch.roll(v, 1, 1) for v in sw], sw)
    adj[:, 0] = 0
    s_len, s_dist = kernels.scan_candidates(
        adj.int().contiguous(), spos.int().contiguous(), window_start,
        k_each, lcp_cap, backward_only,
    )
    return _merge(best_pack, s_len, s_dist, spos), adj


def find_matches(data, valid_end, window_start, candidates: int,
                 key_words: int = 4):
    """Best match per position of every chunk.

    data: (B, N) uint8, zero-padded beyond valid_end; valid_end,
    window_start: (B,) int32 (match sources must be >= window_start).
    Returns (mlen, mdist), (B, N) int32; mlen is 0 or in [3, 258].
    """
    b, n = data.shape
    dev = data.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    key_bytes = 4 * key_words
    if key_bytes >= 16 and key_bytes % 16:
        raise ValueError(f"key_words*4 must be a multiple of 16, got {key_bytes}")
    window_start = window_start.int().contiguous()
    w = _pack_words(data, key_words)
    best_pack = torch.zeros((b, n), dtype=torch.int32, device=dev)

    # Order A: stable sort by the leading 4-byte word, so backward
    # neighbours are the most recent previous occurrences (hash-chain
    # order). The first min(key_words, 4) words ride along for exact LCPs.
    a_words = min(key_words, 4)
    _, spos_a = torch.sort(w[0], dim=1, stable=True)
    best_pack, _ = _scan_order(
        [v.gather(1, spos_a) for v in w[:a_words]], spos_a, window_start,
        best_pack, min(candidates, 8), 4 * a_words, backward_only=True,
    )

    # Order B: the full-depth suffix order, scanned both ways.
    spos_b = _stable_order(w)
    best_pack, adj_b = _scan_order(
        [v.gather(1, spos_b) for v in w], spos_b, window_start, best_pack,
        candidates, key_bytes,
    )
    mlen, mdist = _unpack_best(best_pack)

    # Dense rank of the full key prefix: a new prefix starts where the
    # adjacent LCP drops below key_bytes.
    rs = torch.cumsum((adj_b < key_bytes).int(), dim=1)
    rank_key = torch.zeros((b, n), dtype=torch.int64, device=dev).scatter_(
        1, spos_b, rs
    )
    full = mlen >= key_bytes

    # Anchor propagation is exact whenever key_bytes >= stride: a position
    # p with the next anchor a has a - p < key_bytes, so a full-key match
    # at p covers [p, a) and mlen[p] = (a - p) + mlen[a] when both share a
    # distance. Shorter keys run the extension at full width.
    use_anchors = key_bytes >= _STRIDE and n % _STRIDE == 0
    if use_anchors:
        nq = n // _STRIDE
        posx = (torch.arange(nq, device=dev) * _STRIDE)[None, :]
        fullx = full.reshape(b, nq, _STRIDE)[:, :, 0]
        distx = mdist.reshape(b, nq, _STRIDE)[:, :, 0].long()
    else:
        posx = pos.long()
        fullx = full
        distx = mdist.long()
    candx = posx - distx

    def take(arr, idx):  # jnp.take(mode="clip") per row
        return arr.gather(1, idx.clamp(0, n - 1).expand(b, -1))

    # Extend full-key matches in key_bytes-block steps via rank equality.
    alive = fullx
    ext = torch.zeros(candx.shape, dtype=torch.int64, device=dev)
    for k in range(1, -(-MAX_MATCH // key_bytes)):
        eq = take(rank_key, posx + key_bytes * k) == take(
            rank_key, candx + key_bytes * k
        )
        eq = eq & (posx + key_bytes * (k + 1) <= n)
        alive = alive & eq
        ext = ext + alive.long()

    # Tail: refine inside the first unequal key block by direct 16-byte
    # word LCPs; a round with < 16 equal bytes has found the mismatch.
    off = key_bytes * (ext + 1)
    alive_t = torch.ones(off.shape, dtype=torch.bool, device=dev)
    for _ in range(key_bytes // 16):
        tp = posx + off
        tc = candx + off
        l16 = _lcp_words([take(w[j], tp) for j in range(4)],
                         [take(w[j], tc) for j in range(4)])
        l16 = torch.where(alive_t, l16, 0)
        off = off + l16
        alive_t = alive_t & (l16 == 16)
    extlen = off.int()

    if use_anchors:
        zero = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        ext_next = torch.cat([extlen[:, 1:], zero], dim=1)
        dist_next = torch.cat([distx[:, 1:].int(), zero], dim=1)
        full_next = torch.cat([fullx[:, 1:], zero.bool()], dim=1)
        m2 = mlen.reshape(b, nq, _STRIDE)
        d2 = mdist.reshape(b, nq, _STRIDE)
        f2 = full.reshape(b, nq, _STRIDE)
        r = torch.arange(_STRIDE, dtype=torch.int32, device=dev)[None, None, :]
        prop = (_STRIDE - r) + ext_next[:, :, None]
        ok_prop = f2 & full_next[:, :, None] & (d2 == dist_next[:, :, None])
        via_anchor = torch.where(
            r == 0,
            torch.where(fullx[:, :, None], extlen[:, :, None], m2),
            torch.where(ok_prop, prop, m2),
        )
        mlen = torch.where(f2, torch.maximum(m2, via_anchor), m2).reshape(b, n)
    else:
        mlen = torch.where(full, extlen, mlen)

    # Interior-suffix propagation: a match (len, dist) at p implies
    # (len - k, dist) at p + k; candidates the scans may have missed.
    pk = torch.where(mlen > 0, (mlen << 15) | (WINDOW_SIZE - mdist), 0)
    mlen, mdist = _unpack_best(kernels.propagate_matches(pk.int().contiguous()))

    mlen = torch.minimum(
        mlen, torch.clamp(valid_end.int()[:, None] - pos, max=MAX_MATCH)
    )
    mlen = torch.where(
        (mlen >= MIN_MATCH) & ~((mlen == MIN_MATCH) & (mdist > _TOO_FAR)),
        mlen, 0,
    )
    mdist = torch.where(mlen > 0, mdist, 0)
    return mlen.int(), mdist.int()


def _lazy_take(mlen, lazy: bool, max_lazy: int, nice: int):
    """Token choice per position: match (True) or deferred to a literal."""
    has = mlen >= MIN_MATCH
    if not lazy:
        return has
    next_len = torch.cat([mlen[:, 1:], torch.zeros_like(mlen[:, :1])], dim=1)
    defer = has & (mlen < max_lazy) & (next_len > mlen) & (mlen < nice)
    return has & ~defer


def parse_commit_batch(mlen, starts, valid_ends, lazy: bool,
                       max_lazy: int = 258, nice: int = 258):
    """Greedy/lazy parse of a batch of chunks (the parse kernel).

    mlen: (B, N); starts/valid_ends: (B,). Returns (committed, take),
    (B, N) bools, with the semantics of a sequential zlib-style
    deflate_fast/deflate_slow walk (the walk depends on lengths only)."""
    take = _lazy_take(mlen, lazy, max_lazy, nice)
    step = torch.where(take, torch.clamp(mlen, min=1), 1)
    committed = commit_steps(step, starts, valid_ends)
    return committed, take & committed


def commit_steps(step, starts, valid_ends):
    """The positions that the walk next[p] = p + step[p] from each chunk's
    start commits, within [start, valid_end): (B, N) bool. step: (B, N)
    with every step in [1, 258] (the parse kernel)."""
    b, n = step.shape
    step = step.int()
    npad = -(-n // _ROW) * _ROW
    if npad != n:
        step = torch.nn.functional.pad(step, (0, npad - n), value=1)
    mark = kernels.parse_rows(step.contiguous(), starts.int().contiguous(),
                              _ROW)
    posn = torch.arange(n, device=step.device)[None, :]
    return (
        (mark[:, :n] == 1)
        & (posn >= starts[:, None])
        & (posn < valid_ends[:, None])
    )
