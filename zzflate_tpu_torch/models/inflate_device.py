"""Device decode of zlib/gzip/raw streams: the anchor walk on the card.

Port of ``zzflate_tpu/models/inflate_tpu.py``. DEFLATE decode is
bit-serial: a symbol's width is unknown until the previous symbol is
decoded. Two parallel answers live here, selected by the stream:

**Anchor-walk decode (v3 indexed streams and foreign streams).** The
encoder records the (bit, output) position of every block start and of
every ANCHOR_TOKENS-th token in its 'ZZ' FEXTRA index; for a foreign
stream the host C pre-scan (``native.scan_anchors``, or
``native.scan_members`` over every member of a gzip buffer) finds the
block starts and every FOREIGN_ANCHOR_TOKENS-th token. Each recorded position
is a LANE, and each lane decodes its token interval serially:
``ops/kernels.anchor_walk``, one CUDA thread per lane (lanes sorted by
block and padded by ``_walk_lanes``, so a warp's blocks share decode
tables), every token max-combined into one packed output-space array. No
speculation: the index says where tokens start. Lanes stop at EOB or on
an invalid window and may re-walk the head of the next interval
(identical values, harmless under max).

**Speculative per-bit decode (v2 indexes: no anchors).** A candidate
token is decoded at EVERY bit, in the block that owns it
(``ops/kernels.decode_candidates``: the reference's (U, 2^15) table
arithmetic in closed form), then the reference's serial row sweeps
(``_commit_walk``, ``ops/kernels.commit_walk``) find the true token
starts from each block's indexed start bit, and
``ops/kernels.token_scatter`` writes the committed tokens into the
output-space arrays. Legacy: the encoder
writes v3, but its index drops the anchors past ~28 MiB.

Shared machinery, whole-array torch ops on the decode device:

- **Canonical tables** from ~700-byte descriptors per block: code
  lengths by a boundary sum, symbols by offset arithmetic.
- **Parallel LZ resolution** (``ops/kernels.resolve_lz``). A running
  max finds each byte's covering token; the closed-form in-token hop
  s - d + ((i - s) mod d) collapses overlap chains, and pointer doubling
  with a convergence test (at most 40 rounds) finishes nested chains.
- **Groups.** Streams decode in groups of consecutive chunks of at most
  ``_WGROUP_OUT`` output bytes, each carrying the previous 32 KiB of
  output as a resolved prefix across the seam.
- **Device-resident output.** Bytes stay on the card; the CRC-32 (gzip)
  or Adler-32 (zlib) runs there (``ops/checksums``) and 4 bytes a group
  come back to verify.
  ``to_device=True`` returns the tensor: the data-loading path.

``device=None`` means CUDA and raises RuntimeError without a card; only
``device="cpu"`` runs the plain torch versions. The entry points return
None, for the caller's host decoder, only where the reference does: no
index, a preset dictionary, an all-stored stream, a size cap, or one
chunk or block larger than a group.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch import native
from zzflate_tpu_torch.devices import resolve_device
from zzflate_tpu_torch.models import inflate
from zzflate_tpu_torch.models.inflate import BitReader, CanonicalDecoder
from zzflate_tpu_torch.ops import checksums as cs
from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.ops.canonical import (  # noqa: F401 (the tests')
    _M32,
    _MAX_D,
    _MAX_LL,
    _bit_windows,
    _brev15,
    _build_luts,
    _canon_unit_tables,
    _d_attr,
    _decode_bits,
    _ll_attr,
    _on_device,
)
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils.profiling import maybe_stage

_R = kernels.COMMIT_ROW       # row size in bits for the commit sweeps
_RR = _R * _R                 # superrow size
# A step of _HUGE (> _R) means "EOB / invalid: stop" (ops/canonical).

_W = 32768                    # DEFLATE window: max LZ reach across groups
# Per-bit path groups (v2 indexes): body bits and output per group.
_GROUP_BITS = 1 << 22
_GROUP_BODY = (_GROUP_BITS - 16) // 8
_GROUP_OUT = 2 << 20


# Walk-path group caps (compressed body / decoded output per group).
# Module-level so tests can shrink them to force multi-group streams.
_WGROUP_BODY = 4 << 20
_WGROUP_OUT = (4 << 20) - _W

# Anchor spacing of foreign streams, in tokens. An indexed stream's is
# the format's C.ANCHOR_TOKENS; a foreign stream's anchors come from the
# host scan, so the decoder chooses: shorter lanes start every serial
# chain sooner and make more blocks of the walk for the card's SMs
# (chosen from 64, 128 and 256 on the H100: PERF.md §6).
FOREIGN_ANCHOR_TOKENS = 64


# ---------------------------------------------------------------------------
# Module constants.
# ---------------------------------------------------------------------------


_cummax = kernels.cummax


# ---------------------------------------------------------------------------
# Host: per-block canonical descriptors.
# ---------------------------------------------------------------------------


def _canon_desc(dec, nsym: int):
    """(first16, cnt16, off16, symtab) int32 arrays from a CanonicalDecoder."""
    first = np.zeros(16, np.int32)
    cnt = np.zeros(16, np.int32)
    off = np.zeros(16, np.int32)
    for ln in range(1, min(dec.max_len, 15) + 1):
        cnt[ln] = dec.counts[ln]
        first[ln] = dec.first_code[ln]
        off[ln] = dec.offsets[ln]
    symtab = np.zeros(nsym, np.int32)
    symtab[: len(dec.syms)] = dec.syms
    return first, cnt, off, symtab


class _FixedDecs:
    """Cached CanonicalDecoder pair for BTYPE=1 blocks."""

    _pair = None

    @classmethod
    def get(cls):
        if cls._pair is None:
            cls._pair = (
                CanonicalDecoder(list(C.fixed_litlen_lengths())),
                CanonicalDecoder(list(C.fixed_dist_lengths())),
            )
        return cls._pair


def _with_edge_units(ll, d):
    """The walk's unit tables (hi_mono, fsh, off, sym) as anchor_walk
    takes them, with two units appended on their device whose codes reach
    the walk's edge cases: the fixed code (litlen symbols 286 and 287
    reachable) and an incomplete code (litlen '0' = 'A', '10' = EOB, '11'
    past the tree; distance '0' = 0, '10' = 30, '110' = 31, '111' past the
    tree). For the walk's tests."""
    lit = [0] * _MAX_LL
    lit[65], lit[256] = 1, 2
    dist = [0] * _MAX_D
    dist[0], dist[30], dist[31] = 1, 2, 3
    decs = (_FixedDecs.get(), (CanonicalDecoder(lit), CanonicalDecoder(dist)))
    out = []
    for k, (tabs, nsym) in enumerate(((ll, _MAX_LL), (d, _MAX_D))):
        first, cnt, off, sym = (torch.from_numpy(np.stack(x)) for x in zip(
            *(_canon_desc(pair[k], nsym) for pair in decs)))
        rows = (*_canon_unit_tables(first, cnt, off), sym)
        out.append(tuple(torch.cat([t, r.to(t.device)])
                         for t, r in zip(tabs, rows)))
    return tuple(out)


def _plan_units(body: bytes, chunks, out_starts, out_sizes):
    """Host walk of indexed chunks: the coded chunks' block headers, each
    bounded by its chunk's end, in one native.parse_headers call; the
    stored-fallback chunks' runs (out_pos, body_byte_off, len), whose
    payload the device reads out of the uploaded words. Offsets (bit and
    output) are relative to the given body/out space.

    Returns (start_bits, out_bases, ll, d, stored_runs, unit_ranges): each
    unit's first-token bit and output base, (U,) int64; parse_headers'
    descriptor arrays; the runs, (S, 3) int32; and each chunk's [lo, hi)
    slice of the units, (nchunks, 2) int64 (empty for a stored-fallback
    chunk)."""
    stored_runs: list[tuple[int, int, int]] = []
    unit_ranges: list[tuple[int, int]] = []
    bits: list[int] = []
    ends: list[int] = []
    outs: list[int] = []
    err = None
    pos = 0
    try:
        for i, (sz, blocks, _anchors) in enumerate(chunks):
            seg0 = pos
            pos += sz
            ulo = len(bits)
            # The first block's BTYPE (IndexError: an empty segment).
            if (body[seg0 : seg0 + min(sz, 1)][0] >> 1) & 3 == 0:
                stored_runs.extend(_stored_runs(
                    body[seg0:pos], out_starts[i], out_sizes[i], seg0))
                unit_ranges.append((ulo, ulo))
                continue
            for bit_off, out_off in blocks:
                bits.append(seg0 * 8 + bit_off)
                ends.append(pos)
                outs.append(out_starts[i] + out_off)
            unit_ranges.append((ulo, len(bits)))
    except (IndexError, struct.error) as e:
        # A short segment: raised after the headers of the chunks before
        # it, which the Python parse read first.
        err = e
    with maybe_stage("decode_headers"):
        hdr_end, ll, d = native.parse_headers(body, bits, ends)
    if err is not None:
        raise err
    return (hdr_end, np.array(outs, np.int64), ll, d,
            np.array(stored_runs, np.int32).reshape(-1, 3),
            np.array(unit_ranges, np.int64).reshape(-1, 2))


def _block_units(body: bytes, blocks, byte_lo: int, out_lo: int):
    """_plan_units' arrays for scanned blocks (native.scan_anchors' rows,
    one unit a coded block), in the spaces of a group whose body starts at
    byte byte_lo and whose output starts at out_lo (position _W there).
    The headers are parsed at their absolute bits, bounded by the body."""
    coded = blocks[:, 1] != 0
    with maybe_stage("decode_headers"):
        hdr_end, ll, d = native.parse_headers(body, blocks[coded, 0],
                                              len(body))
    st = blocks[~coded & (blocks[:, 4] != 0)]
    runs = np.stack([_W + st[:, 2] - out_lo, st[:, 3] - byte_lo, st[:, 4]],
                    axis=1).astype(np.int32)
    uhi = np.cumsum(coded)
    return (hdr_end - 8 * byte_lo, _W + blocks[coded, 2] - out_lo, ll, d,
            runs, np.stack([uhi - coded, uhi], axis=1))


def _stored_runs(seg: bytes, out_base: int, out_bytes: int,
                 seg_byte0: int) -> list[tuple[int, int, int]]:
    """Walk the byte-aligned stored blocks of a fallback segment (host),
    yielding (out_pos, body_byte_off, len) run descriptors."""
    br = BitReader(seg, 0)
    runs: list[tuple[int, int, int]] = []
    done = 0
    while done < out_bytes:
        br.bits(3)
        br.align()
        p = br.bitpos >> 3
        (ln,) = struct.unpack("<H", seg[p : p + 2])
        if ln:
            runs.append((out_base + done, seg_byte0 + p + 4, ln))
        done += ln
        br.bitpos = (p + 4 + ln) << 3
    return runs


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _walk_lanes(bit, out, uid) -> np.ndarray:
    """One group's walk lanes, planned for the kernel's blocks: sorted by
    (uid, bit), each unit's run padded with invalid lanes to a multiple
    of WALK_THREADS // WALK_UNITS, so that every block of WALK_THREADS
    lanes spans at most WALK_UNITS units and finds their decode tables in
    shared memory. Neither the order nor the padding changes the walk's
    output (it combines with max). Returns (4, n) int32 rows: bit, out,
    uid, valid."""
    bit, out, uid = (np.asarray(x, np.int64) for x in (bit, out, uid))
    n = len(bit)
    if n == 0:
        return np.zeros((4, 0), np.int32)
    order = np.lexsort((bit, uid))
    bit, out, uid = bit[order], out[order], uid[order]
    starts = np.flatnonzero(np.r_[True, uid[1:] != uid[:-1]])
    counts = np.diff(np.r_[starts, n])
    align = kernels.WALK_THREADS // kernels.WALK_UNITS
    padded = -(-counts // align) * align
    base = np.r_[0, np.cumsum(padded)[:-1]]
    pos = np.repeat(base - starts, counts) + np.arange(n)
    lanes = np.zeros((4, int(padded.sum())), np.int32)
    lanes[0, pos] = bit
    lanes[1, pos] = out
    lanes[2, pos] = uid
    lanes[3, pos] = 1
    return lanes


def _lane_bucket(n: int) -> int:
    """Walk-lane padding bucket: two buckets per octave (p and 3p/4)."""
    p = _pow2(n)
    if p >= 8 and n <= 3 * p // 4:
        return 3 * p // 4
    return p


# ---------------------------------------------------------------------------
# Per-bit path (v2 indexes): candidate tokens, commit, offsets, scatter.
# ---------------------------------------------------------------------------


def _commit_walk(step, start_bits, unit_valid, max_sup_span):
    """Exact token-boundary commit via hierarchical serial sweeps
    (ops/kernels.commit_walk: the CUDA kernel csrc/commit.cu on the card,
    its plain torch version on the CPU).

    step: (nbits,) per-bit token width (_HUGE stops the walk);
    start_bits: (U,) absolute first-token bit per block. Returns the
    (nbits,) bool committed mask. nbits must be a multiple of _R*_R."""
    return kernels.commit_walk(step, start_bits, unit_valid, max_sup_span)


def _decode_all(
    words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off, d_sym,
    start_bits, out_bases, unit_valid, prefix, stored_runs,
    nbits, n_out_pad, max_sup_span, n_stored,
):
    """Per-bit decode of one group: candidate tokens at every bit
    (ops/kernels.decode_candidates) -> commit -> token scatter -> LZ
    resolve -> bytes.

    `prefix` is the previous 32 KiB of decoded output (zeros for the
    first group); it occupies output positions [0, _W) as self-resolved
    literals, so LZ distances reaching before this group's first byte
    land on real history."""
    uid, step, outlen, sym, mdist, islit, islen = kernels.decode_candidates(
        words, (ll_first, ll_cnt, ll_off, ll_sym),
        (d_first, d_cnt, d_off, d_sym), start_bits, unit_valid, nbits)
    committed = _commit_walk(step, start_bits, unit_valid, max_sup_span)
    off = _offsets(committed, uid, outlen, start_bits, out_bases, nbits)
    litval, start_mark, dist_at = _stage_out(
        prefix, stored_runs, words, n_out_pad, n_stored
    )
    kernels.token_scatter(litval, start_mark, dist_at, off, committed, islit,
                          islen, sym, mdist)
    return _resolve_lz(litval, start_mark, dist_at, n_out_pad)


def _offsets(committed, uid, outlen, start_bits, out_bases, nbits):
    """Every bit's output offset, int64 (nbits,): the block's output base
    plus the committed tokens' lengths before the bit in its block (the
    global cumsum minus the block's prefix)."""
    lens = torch.where(committed, outlen, 0)
    g = torch.cumsum(lens, 0)
    sb = start_bits.long().clamp(0, nbits - 1)
    cum0 = g[sb] - lens[sb]
    return (out_bases.long().index_select(0, uid) + (g - lens)
            - cum0.index_select(0, uid))


# ---------------------------------------------------------------------------
# Output staging, LZ resolve and the anchor walk.
# ---------------------------------------------------------------------------


def _stage_out(prefix, stored_runs, words, n_out_pad, n_stored):
    """Initial output-space arrays (int32): the 32 KiB resolved prefix
    occupies [0, _W) as self-resolved literals; stored-run bytes are read
    on the device out of the words buffer (their payload is part of the
    compressed body) via a run-id segment scan.

    stored_runs: (n_stored, 3) int32 [out_pos, body_byte_off, len]
    sorted by out_pos; padding rows have out_pos = n_out_pad, len 0."""
    dev = words.device
    litval = torch.cat([
        prefix.int(),
        torch.zeros((n_out_pad - _W,), dtype=torch.int32, device=dev),
    ])
    start_mark = torch.cat([
        torch.arange(_W, dtype=torch.int32, device=dev),
        torch.full((n_out_pad - _W,), -1, dtype=torch.int32, device=dev),
    ])
    dist_at = torch.zeros((n_out_pad,), dtype=torch.int32, device=dev)
    if n_stored:
        run_out = stored_runs[:, 0].long()
        run_src = stored_runs[:, 1].long()
        run_len = stored_runs[:, 2].long()
        idx = torch.arange(n_out_pad, device=dev)
        # .at[run_out].max(rid, mode="drop"): out-of-range rows land in a
        # trash slot past the end.
        slot = torch.where((run_out >= 0) & (run_out < n_out_pad), run_out,
                           n_out_pad)
        a = torch.full((n_out_pad + 1,), -1, dtype=torch.long, device=dev)
        a.scatter_reduce_(0, slot, torch.arange(n_stored, device=dev), "amax")
        seg = _cummax(a[:n_out_pad])
        sc = seg.clamp(0, n_stored - 1)
        within = idx - run_out[sc]
        valid = (seg >= 0) & (within < run_len[sc])
        sb = run_src[sc] + within
        nw = words.shape[0]
        byte = (words.long()[(sb >> 2).clamp(0, nw - 1)]
                >> (8 * (sb & 3))) & 0xFF
        litval = torch.where(valid, byte.int(), litval)
        start_mark = torch.where(valid, idx.int(), start_mark)
    return litval, start_mark, dist_at


def _resolve_parent(start_mark, dist_at, n_out_pad):
    """LZ source chase of the (n_out_pad,) int32 arrays: (parent, rounds),
    every position's ultimate literal source index and the doubling
    rounds taken (ops/kernels.resolve_parent: the resolve_lz kernel of
    csrc/resolve.cu on the card, its plain version on the CPU)."""
    return kernels.resolve_parent(start_mark, dist_at)


def _resolve_lz(litval, start_mark, dist_at, n_out_pad):
    """The (n_out_pad,) uint8 bytes of one group: ops/kernels.resolve_lz,
    the chase and the byte gather (one call, no host sync on the card)."""
    return kernels.resolve_lz(litval, start_mark, dist_at)


def _walk_core(
    words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off, d_sym,
    lane_bit, lane_out, lane_uid, lane_valid, prefix, stored_runs,
    n_out_pad, n_stored, t_steps,
):
    """Anchor-walk decode of one group: every lane decodes up to t_steps
    tokens serially from a known token-aligned bit position (a block
    start or an anchor). The three output-space arrays travel packed as
    dist << 9 | lit << 1 | started (dist <= 32768, lit <= 255), and the
    walk max-combines every token into them: ops/kernels.anchor_walk
    (the CUDA kernel on a card, the reference's deferred loop on the
    CPU). Returns (litval, start_mark, dist_at), int32."""
    ll = (*_canon_unit_tables(ll_first, ll_cnt, ll_off), ll_sym)
    d = (*_canon_unit_tables(d_first, d_cnt, d_off), d_sym)
    litval, start_mark, dist_at = _stage_out(
        prefix, stored_runs, words, n_out_pad, n_stored
    )
    packed = torch.where(
        start_mark >= 0, (dist_at << 9) | (litval << 1) | 1, 0
    ).int()
    kernels.anchor_walk(words, ll, d,
                        (lane_bit, lane_out, lane_uid, lane_valid),
                        packed, t_steps)
    posn = torch.arange(n_out_pad, dtype=torch.int32, device=words.device)
    litval = (packed >> 1) & 0xFF
    dist_at = packed >> 9
    start_mark = torch.where((packed & 1) == 1, posn, -1)
    return litval, start_mark, dist_at


def _walk_all(arrs: dict, prefix, crc_len: int, n_out_pad: int,
              n_stored: int, t_steps: int, with_crc: bool):
    """One group: walk, then LZ resolve, then CRC-32 of [_W, crc_len).
    Returns (out, crc or None)."""
    dev = prefix.device
    with maybe_stage("decode_walk", dev):
        litval, start_mark, dist_at = _walk_core(
            arrs["words"], arrs["ll_first"], arrs["ll_cnt"], arrs["ll_off"],
            arrs["ll_sym"], arrs["d_first"], arrs["d_cnt"], arrs["d_off"],
            arrs["d_sym"], arrs["lane_bit"], arrs["lane_out"],
            arrs["lane_uid"], arrs["lane_valid"], prefix, arrs["sr"],
            n_out_pad, n_stored, t_steps,
        )
    with maybe_stage("decode_resolve", dev):
        out = _resolve_lz(litval, start_mark, dist_at, n_out_pad)
    if not with_crc:
        return out, None
    with maybe_stage("decode_crc", dev):
        crc = cs._crc32_impl(out, crc_len, _W)
    return out, crc


# ---------------------------------------------------------------------------
# Groups, shared by the indexed and foreign entries: the partition, the
# plan, the shapes, the staging and the runner.
# ---------------------------------------------------------------------------


def _partition(body_lo, body_hi, out_lo, out_hi, body_cap: int,
               out_cap: int) -> list[tuple[int, int]]:
    """Items (chunks or blocks) in order into greedy [lo, hi) groups: an
    item opens a new group when the body from the group's first item's
    start to its own end, or the output likewise, would pass its cap. An
    item alone always makes a group."""
    body_lo, body_hi, out_lo, out_hi = (
        np.asarray(x).tolist() for x in (body_lo, body_hi, out_lo, out_hi))
    groups: list[tuple[int, int]] = []
    lo = 0
    for i in range(len(body_lo)):
        if i > lo and (body_hi[i] - body_lo[lo] > body_cap
                       or out_hi[i] - out_lo[lo] > out_cap):
            groups.append((lo, i))
            lo = i
    if lo < len(body_lo):
        groups.append((lo, len(body_lo)))
    return groups


class _Group(NamedTuple):
    """One group's plan, in its own bit and output spaces (output position
    _W is its first byte; [0, _W) holds the previous output)."""
    byte_lo: int              # its body bytes [byte_lo, byte_hi)
    byte_hi: int
    go: int                   # its output bytes
    start_bits: np.ndarray    # (U,) each unit's first-token bit
    out_bases: np.ndarray     # (U,) each unit's output base
    ll: tuple                 # native.parse_headers' descriptor arrays
    d: tuple
    sr: np.ndarray            # (S, 3) int32 stored runs
    lanes: np.ndarray | None  # _walk_lanes' (4, L) rows; None: per-bit


def _lanes(start_bits, out_bases, unit_ranges, anchors) -> np.ndarray:
    """A group's walk lanes: every unit's first token and every anchor
    ((3, A) rows bit, out, item, sorted by item), each tagged with the
    unit whose tree decodes it, found by np.searchsorted over its own
    item's units: the last whose first token is at or before it (an
    anchor before all of them, or in an item without units, is bogus:
    dropped). A crafted index may repeat a lane (an anchor on a
    block-first token): the walk max-combines the identical tokens."""
    abit, aout, aitem = anchors
    n_units = unit_ranges[:, 1] - unit_ranges[:, 0]
    uitem = np.repeat(np.arange(len(n_units)), n_units)
    ukey = (uitem << 40) | start_bits
    if (ukey[1:] >= ukey[:-1]).all():
        # Every item's units in bit order, as encoders and the scan write
        # them: one search over (item, bit) keys serves every item.
        k = np.searchsorted(ukey, (aitem << 40) | abit, side="right") - 1
    else:
        # A crafted index's block records out of order: item by item.
        k = np.full(len(abit), -1)
        cut = np.searchsorted(aitem, np.arange(len(n_units) + 1))
        for i in np.flatnonzero(n_units):
            ulo, uhi = unit_ranges[i]
            a = slice(cut[i], cut[i + 1])
            k[a] = ulo - 1 + np.searchsorted(start_bits[ulo:uhi], abit[a],
                                             side="right")
    ok = k >= 0
    ok[ok] = uitem[k[ok]] == aitem[ok]
    return _walk_lanes(np.r_[start_bits, abit[ok]],
                       np.r_[out_bases, aout[ok]],
                       np.r_[np.arange(len(start_bits)), k[ok]])


def _plan_groups(groups, body_lo, body_hi, out_lo, out_hi, units_of,
                 anchors) -> list[_Group]:
    """Every group's plan. Items i have body bytes [body_lo[i],
    body_hi[i]) and output [out_lo[i], out_hi[i]); units_of(lo, hi,
    byte_lo, byte_hi, out_lo) gives the units of items [lo, hi) in the
    group's spaces, as _plan_units does. anchors: the stream's, (3, A)
    int64 rows bit, out and item, in body and output space and sorted by
    item, or None on the per-bit path (no lanes)."""
    plans = []
    for lo, hi in groups:
        with maybe_stage("decode_units"):
            b0, b1 = int(body_lo[lo]), int(body_hi[hi - 1])
            o0 = int(out_lo[lo])
            start_bits, out_bases, ll, d, sr, unit_ranges = units_of(
                lo, hi, b0, b1, o0)
            lanes = None
            if anchors is not None:
                a_lo, a_hi = np.searchsorted(anchors[2], [lo, hi])
                lanes = _lanes(start_bits, out_bases, unit_ranges,
                               anchors[:, a_lo:a_hi]
                               - np.c_[[8 * b0, o0 - _W, lo]])
            plans.append(_Group(b0, b1, int(out_hi[hi - 1]) - o0,
                                start_bits, out_bases, ll, d, sr, lanes))
    return plans


class _Shape(NamedTuple):
    """The shapes every group of a stream is padded to."""
    n_out_pad: int
    u_pad: int
    n_stored: int
    nw: int
    l_pad: int | None   # None: the per-bit path
    t_steps: int
    nbits: int = 0      # the per-bit path's
    max_sup_span: int = 0


def _shape(plans, body_cap: int, anchor_tokens: int,
           seg_bits: int | None = None) -> _Shape:
    """The shared shapes of a stream's groups. seg_bits, the largest
    item's body in bits, selects the per-bit path, which adds nbits and
    max_sup_span."""
    multi = len(plans) > 1
    max_body = max((g.byte_hi - g.byte_lo for g in plans), default=0)
    max_go = max((g.go for g in plans), default=0)
    max_units = max((len(g.start_bits) for g in plans), default=0)
    max_stored = max((len(g.sr) for g in plans), default=0)
    n_out_pad = _pow2(_W + max(1, max_go))
    u_pad = _pow2(max(1, max_units))
    n_stored = _pow2(max_stored) if max_stored else 0
    t_steps = anchor_tokens + 2  # spacing + EOB + slack
    if seg_bits is None:
        nw = (body_cap if multi else _pow2(max(64, max_body))) // 4 + 2
        max_lanes = max((g.lanes.shape[1] for g in plans), default=0)
        return _Shape(n_out_pad, u_pad, n_stored, nw,
                      _lane_bucket(max(1, max_lanes)), t_steps)
    nbits = _GROUP_BITS if multi else max(_RR, _pow2(max_body * 8 + 16))
    return _Shape(n_out_pad, u_pad, n_stored, nbits // 32 + 2, None,
                  t_steps, nbits, min(nbits // _RR, seg_bits // _RR + 2))


_DESC = ("ll_first", "ll_cnt", "ll_off", "ll_sym",
         "d_first", "d_cnt", "d_off", "d_sym")
_LANES = ("lane_bit", "lane_out", "lane_uid", "lane_valid")


def _stage_arrays(body: bytes, g: _Group, s: _Shape) -> dict:
    """Numpy inputs of one group, its plan copied by slice into zeroed
    arrays of the shared shapes: the body as nw u32 words (carried as
    int32 bits), the units' descriptors, first-token bits, output bases
    and validity, the stored runs (padding rows at out_pos = n_out_pad,
    len 0; one zero row when no group has runs) and on the walk path the
    lanes."""
    with maybe_stage("decode_pack"):
        words = np.zeros(s.nw, "<i4")
        n = min(g.byte_hi - g.byte_lo, 4 * s.nw)
        words.view(np.uint8)[:n] = np.frombuffer(body, np.uint8)[
            g.byte_lo : g.byte_lo + n]
        a = {"words": words}
        u = len(g.start_bits)
        for name, rows in zip(_DESC, (*g.ll, *g.d)):
            a[name] = np.zeros((s.u_pad, rows.shape[1]), np.int32)
            a[name][:u] = rows
        for name, rows in (("start_bits", g.start_bits),
                           ("out_bases", g.out_bases)):
            a[name] = np.zeros(s.u_pad, np.int32)
            a[name][:u] = rows
        a["unit_valid"] = np.arange(s.u_pad) < u
        a["sr"] = np.zeros((max(1, s.n_stored), 3), np.int32)
        if s.n_stored:
            a["sr"][:, 0] = s.n_out_pad
            a["sr"][: len(g.sr)] = g.sr
        if s.l_pad is not None:
            lanes = np.zeros((4, s.l_pad), np.int32)
            lanes[:, : g.lanes.shape[1]] = g.lanes
            a.update(zip(_LANES, lanes))
        return a


def _upload(arrs: dict, dev: torch.device) -> dict:
    with maybe_stage("decode_upload", dev):
        return {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}


def _verify(kind: str, group_sums, group_out, expect: int) -> None:
    """The stream's CRC-32 or Adler-32 from its groups' values on the
    card (one copy back), combined on the host; ValueError when it is not
    the container's."""
    combine, value = ((cs.crc32_combine, 0) if kind == "crc32"
                      else (cs.adler32_combine, 1))
    with maybe_stage("decode_verify"):
        vals = torch.stack(group_sums).cpu().tolist() if group_sums else []
        for v, (_buf, go) in zip(vals, group_out):
            value = combine(value, int(v), go)
    if value != expect:
        raise ValueError(f"{kind} mismatch (device inflate)")


def _device_result(group_out, total_out: int, tail: bytes, dev):
    """to_device=True: (uint8 tensor on the decode device, length). A
    tail (an indexed member's further members) is not decoded here."""
    if tail:
        raise ValueError("to_device unsupported for multi-member gzip")
    if not group_out:
        return torch.zeros((0,), dtype=torch.uint8, device=dev), 0
    if len(group_out) == 1:
        buf, _go = group_out[0]
        return buf[_W : _W + total_out], total_out
    return torch.cat([buf[_W : _W + go] for buf, go in group_out]), total_out


def _decode_groups(body: bytes, plans, s: _Shape, dev, checksum,
                   total_out: int, tail: bytes, to_device: bool):
    """Both entries' decode of their planned groups, in order: stage,
    upload, then the walk (or on the per-bit path _decode_all) and the
    checksum of the group's output on the card, each group's last 32 KiB
    the next one's prefix. checksum: (kind, expected), kind "crc32"
    (gzip) or "adler32" (zlib), or None for no verdict (raw, or verify
    off). Then the verdict, the same on both paths, and either the
    to_device result or the fetched bytes, whose length is held to
    total_out (an indexed member's ISIZE) under a verdict, with an
    indexed member's gzip tail decoded on the host appended."""
    kind, expect = checksum or (None, None)
    prefix = torch.zeros((_W,), dtype=torch.uint8, device=dev)
    group_out: list[tuple[torch.Tensor, int]] = []  # (device buf, out bytes)
    group_sums: list[torch.Tensor] = []
    for g in plans:
        with maybe_stage("decode_plan"):
            staged = _stage_arrays(body, g, s)
        arrs = _upload(staged, dev)
        if s.l_pad is not None:
            out_dev, sum_dev = _walk_all(
                arrs, prefix, _W + g.go, s.n_out_pad, s.n_stored, s.t_steps,
                with_crc=kind == "crc32",
            )
        else:
            with maybe_stage("decode_walk", dev):
                out_dev = _decode_all(
                    arrs["words"], *(arrs[k] for k in _DESC),
                    arrs["start_bits"], arrs["out_bases"],
                    arrs["unit_valid"], prefix, arrs["sr"],
                    s.nbits, s.n_out_pad, s.max_sup_span, s.n_stored,
                )
            sum_dev = None
            if kind == "crc32":
                with maybe_stage("decode_crc", dev):
                    sum_dev = cs._crc32_impl(out_dev, _W + g.go, _W)
        if kind == "adler32":
            with maybe_stage("decode_adler", dev):
                sum_dev = cs._adler32_impl(out_dev, _W + g.go, _W)
        if kind is not None:
            group_sums.append(sum_dev)
        group_out.append((out_dev, g.go))
        # Last 32 KiB of output so far: positions [go, go+_W) of this
        # buffer (its own [0,_W) prefix covers the short-output case).
        prefix = out_dev[g.go : g.go + _W]

    if kind is not None:
        _verify(kind, group_sums, group_out, expect)
    if to_device:
        return _device_result(group_out, total_out, tail, dev)
    with maybe_stage("decode_fetch"):  # one device->host copy a group
        out = b"".join(buf[_W : _W + go].cpu().numpy().tobytes()
                       for buf, go in group_out if go)
    if kind is not None and (len(out) & _M32) != (total_out & _M32):
        raise ValueError("isize mismatch (device inflate)")
    if tail:
        out += inflate.decompress(tail, format="gzip")
    return out


# ---------------------------------------------------------------------------
# Public entry: indexed gzip.
# ---------------------------------------------------------------------------


def decompress_indexed(data: bytes, verify: bool = True,
                       to_device: bool = False, device=None):
    """Chunk-parallel decode of an indexed gzip stream on the device.

    Returns None if the stream carries no usable 'ZZ' index (the caller
    falls back). With to_device=True, returns (uint8 tensor on the
    decode device, length); the CRC is still verified on the device when
    verify=True. device=None means CUDA (RuntimeError without a card)."""
    dev = resolve_device(device)
    with maybe_stage("decode_plan"):
        with maybe_stage("decode_index"):
            parsed = containers.parse_gzip_index(data)
            if parsed is None:
                return None
            header_len, chunk_bytes, anchor_tokens, chunks = parsed
            # The indexed member's extent comes from the index itself: a valid
            # stream may append further gzip members after it (RFC 1952).
            member_len = header_len + sum(sz for sz, _b, _a in chunks) + 8
            if member_len > len(data):
                return None  # index inconsistent with buffer; fall back
            (crc_expect, isize) = struct.unpack(
                "<II", data[member_len - 8 : member_len]
            )
            tail = data[member_len:]
            if tail[:2] != b"\x1f\x8b":
                tail = b""  # trailing garbage is tolerated (gzip(1) behavior)
            nchunks = len(chunks)
            total_out = isize
            # Validate the (untrusted) index before any of it sizes a buffer:
            # a lying 'ZZ' subfield must raise ValueError.
            if not 1024 <= chunk_bytes <= (1 << 27):
                raise ValueError("ZZ index: implausible chunk_bytes")
            if isize > nchunks * chunk_bytes:
                raise ValueError(
                    "ZZ index: isize exceeds indexed chunk capacity")
            for sz, blocks, anchors in chunks:
                if sz > len(data) or len(blocks) > max(1, chunk_bytes // 1024):
                    raise ValueError("ZZ index: implausible segment record")
                if len(anchors) > max(1, chunk_bytes // 64):
                    raise ValueError("ZZ index: implausible anchor count")
                for bit_off, out_off in blocks + anchors:
                    if bit_off >= 8 * max(sz, 1) or out_off > chunk_bytes:
                        raise ValueError(
                            "ZZ index: block offsets out of range")
            # Anchor-walk decode requires the writer's spacing guarantee; an
            # absurd T from a hostile index must not size a walk.
            use_walk = 0 < anchor_tokens <= 4096

            if (total_out > (1 << 30)
                    or member_len - header_len - 8 > (1 << 30)):
                return None  # host-memory sanity cap; native fallback

            sizes = np.array([sz for sz, _b, _a in chunks], np.int64)
            cpos = np.r_[0, np.cumsum(sizes)]
            out_starts = np.arange(nchunks, dtype=np.int64) * chunk_bytes
            out_sizes = np.clip(total_out - out_starts, 0, chunk_bytes)
            body = data[header_len : member_len - 8]

            # Groups bounded by body and by chunk_bytes of output a chunk.
            if use_walk:
                body_cap = _WGROUP_BODY
                out_cap = max(_WGROUP_OUT, chunk_bytes)
            else:
                body_cap = _GROUP_BODY
                out_cap = max(_GROUP_OUT, chunk_bytes)
            if (sizes > body_cap).any():
                return None  # one chunk exceeds a group; native fallback
            groups = _partition(cpos[:-1], cpos[1:], out_starts,
                                out_starts + chunk_bytes, body_cap, out_cap)

            # Lanes past the blocks' first tokens: every index anchor,
            # in body and (chunk_bytes a chunk) output space.
            anchors = None
            if use_walk:
                n_anc = [len(a) for _sz, _b, a in chunks]
                item = np.repeat(np.arange(nchunks), n_anc)
                anc = np.array([x for _sz, _b, a in chunks for x in a],
                               np.int64).reshape(-1, 2)
                anchors = np.stack([cpos[item] * 8 + anc[:, 0],
                                    out_starts[item] + anc[:, 1], item])

        def units_of(lo, hi, byte_lo, byte_hi, out_lo):
            try:
                return _plan_units(
                    body[byte_lo:byte_hi], chunks[lo:hi],
                    (_W + out_starts[lo:hi] - out_lo).tolist(),
                    out_sizes[lo:hi].tolist())
            except (IndexError, struct.error) as e:
                # Host header parsing ran off the segment: the index lied.
                raise ValueError(f"corrupt indexed segment: {e}") from e

        plans = _plan_groups(groups, cpos[:-1], cpos[1:], out_starts,
                             out_starts + out_sizes, units_of, anchors)
        shape = _shape(plans, body_cap, anchor_tokens,
                       None if use_walk else 8 * int(sizes.max(initial=0)))

    return _decode_groups(body, plans, shape, dev,
                          ("crc32", crc_expect) if verify else None,
                          total_out, tail, to_device)


# ---------------------------------------------------------------------------
# Foreign (unindexed) streams: host anchor pre-scan -> device anchor walk.
#
# Arbitrary zlib/gzip/raw streams carry no index, so the C scanner
# (native.scan_anchors; for gzip native.scan_members, every member of the
# buffer) walks the bitstream without materializing output and records
# exactly the lane set the walk needs: every block's first token plus every
# FOREIGN_ANCHOR_TOKENS-th token's (bit, out) position. It runs on the
# host's cores: BGZF members in ranges of members, any other stream of a
# few MiB in byte ranges, each from a block start it finds, kept only where
# the chain of scans from the stream's first bit lands on that start.
# ---------------------------------------------------------------------------


def decompress_foreign(data: bytes, format: str = "gzip", verify: bool = True,
                       to_device: bool = False, device=None):
    """Device decode of a foreign (unindexed) zlib/gzip/raw stream.

    A gzip buffer decodes whole on the card: every member (RFC 1952
    members one after another, as `cat` and BGZF write them), each one's
    window empty at its start, into one output; bytes after the last
    member that do not start another are ignored. Each member's ISIZE is
    checked against its scanned length, and with verify the CRC-32 of the
    whole output against the members' CRC-32s combined. A zlib stream's
    Adler-32 is likewise computed on the card, a group at a time, and
    held to its trailer; with to_device=True as on the fetch path.

    Returns None when the stream is unsuitable (a preset dictionary,
    nothing but stored blocks, a size cap, one block larger than a group,
    or deflate data the scan finds corrupt): the caller falls back to the
    host C decoder. device=None means CUDA (RuntimeError without a
    card)."""
    dev = resolve_device(device)
    data = bytes(data)
    checksum = None
    if format == "gzip":
        body = data  # every member, in the buffer's coordinates
    elif format == "zlib":
        header_len, dictid = containers.parse_zlib_header(data)
        if dictid is not None:
            return None  # the device path has no preset-dictionary lanes
        body = data[header_len:]  # trailer located after the scan
    elif format == "raw":
        body = data
    else:
        raise ValueError(f"unknown format {format!r}")
    if len(body) > (1 << 30):
        return None

    T = FOREIGN_ANCHOR_TOKENS
    with maybe_stage("decode_scan"):
        try:
            if format == "gzip":
                members, blocks, anchors, crc = native.scan_members(data, T)
                checksum = ("crc32", crc)
            else:
                blocks, anchors, total_out, end_bit = native.scan_anchors(
                    body, T)
        except native.StreamError:
            return None  # corrupt per the scanner: let the host raise
    with maybe_stage("decode_plan"):
        if format == "gzip":
            with maybe_stage("decode_members"):
                _hdr, _body, m_end_bit, _out, out_len, _crc, isize = (
                    members.T)
                if (isize != (out_len & _M32)).any():
                    raise ValueError("isize mismatch (device inflate)")
                total_out = int(out_len.sum())
                # A block ends where the next one starts, or at its
                # member's final bit.
                member = blocks[:, 5]
                bit_ends = np.r_[blocks[1:, 0], 0]
                last = np.r_[member[1:] != member[:-1], True]
                bit_ends[last] = m_end_bit[member[last]]
                item = anchors[:, 2]
        else:
            if format == "zlib":
                # Adler-32 sits right after the final block (trailing
                # bytes beyond it are ignored, matching zlib.decompress).
                tr = header_len + (end_bit + 7) // 8
                if tr + 4 > len(data):
                    raise ValueError("truncated zlib trailer")
                checksum = ("adler32",
                            struct.unpack(">I", data[tr : tr + 4])[0])
            bit_ends = np.r_[blocks[1:, 0], end_bit]
            item = np.searchsorted(blocks[:, 0], anchors[:, 0],
                                   side="right") - 1
        if total_out > (1 << 30):
            return None
        if len(blocks) == 0 or not (blocks[:, 1] != 0).any():
            return None  # all-stored stream: the host memcpy path wins

        # Groups bounded like the indexed walk path's, bit ends floored
        # to bytes.
        out_ends = np.r_[blocks[1:, 2], total_out]
        if ((out_ends - blocks[:, 2]) > _WGROUP_OUT).any() or (
            (bit_ends - blocks[:, 0]) // 8 > _WGROUP_BODY
        ).any():
            return None  # one block exceeds a group
        groups = _partition(blocks[:, 0] // 8, bit_ends // 8, blocks[:, 2],
                            out_ends, _WGROUP_BODY, _WGROUP_OUT)
        plans = _plan_groups(
            groups, blocks[:, 0] // 8, (bit_ends + 7) // 8, blocks[:, 2],
            out_ends,
            lambda lo, hi, byte_lo, _hi, out_lo: _block_units(
                body, blocks[lo:hi], byte_lo, out_lo),
            np.vstack([anchors[:, :2].T, item]))
        shape = _shape(plans, _WGROUP_BODY, T)

    return _decode_groups(body, plans, shape, dev,
                          checksum if verify else None, total_out, b"",
                          to_device)
