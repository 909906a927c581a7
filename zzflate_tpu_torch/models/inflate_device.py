"""Device decode of zlib/gzip/raw streams: the anchor walk on the card.

Port of ``zzflate_tpu/models/inflate_tpu.py``. DEFLATE decode is
bit-serial: a symbol's width is unknown until the previous symbol is
decoded. Two parallel answers live here, selected by the stream:

**Anchor-walk decode (v3 indexed streams and foreign streams).** The
encoder records the (bit, output) position of every block start and of
every ANCHOR_TOKENS-th token in its 'ZZ' FEXTRA index; for a foreign
stream the host C pre-scan (``native.scan_anchors``) finds the block
starts and every FOREIGN_ANCHOR_TOKENS-th token. Each recorded position
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
- **Device-resident output.** Bytes stay on the card; CRC-32 runs there
  (``ops/checksums``) and 4 bytes a group come back to verify.
  ``to_device=True`` returns the tensor: the data-loading path.

``device=None`` means CUDA and raises RuntimeError without a card; only
``device="cpu"`` runs the plain torch versions. The entry points return
None, for the caller's host decoder, only where the reference does: no
index, a preset dictionary, an all-stored stream, a size cap, or one
chunk or block larger than a group.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch import native
from zzflate_tpu_torch.api import _resolve_device
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
# (chosen from 64, 128 and 256 on the H100 with utils/decode_bench.py:
# PERF.md).
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


class _Unit:
    __slots__ = ("bit", "out_base", "ll", "d")

    def __init__(self, bit, out_base, ll, d):
        self.bit = bit          # absolute bit offset into the body
        self.out_base = out_base
        self.ll = ll            # (first, cnt, off, symtab) litlen
        self.d = d              # (first, cnt, off, symtab) dist


def _units(hdr_end, out_bases, ll, d) -> list[_Unit]:
    """One _Unit a parsed block (native.parse_headers' arrays): its first
    token's bit, its output base and row views of the descriptors."""
    return [_Unit(bit, ob, tuple(a[j] for a in ll), tuple(a[j] for a in d))
            for j, (bit, ob) in enumerate(zip(hdr_end.tolist(), out_bases))]


def _plan_units(body: bytes, chunks, out_starts, out_sizes):
    """Host walk: per indexed block, its header's canonical descriptors
    (native.parse_headers, one call for all the chunks' coded blocks,
    each bounded by its chunk's end); stored segments become run
    descriptors (out_pos, body_byte_off, len), whose payload bytes the
    device reads out of the uploaded words. Offsets (bit and output) are
    relative to the given body/out space. unit_ranges[i] is the [lo, hi)
    slice of `units` from chunk i (empty for stored-fallback chunks)."""
    with maybe_stage("decode_units"):
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
            # A short segment: raised after the headers of the chunks
            # before it, which the Python parse read first.
            err = e
        with maybe_stage("decode_headers"):
            hdr_end, ll, d = native.parse_headers(body, bits, ends)
        if err is not None:
            raise err
        return _units(hdr_end, outs, ll, d), stored_runs, unit_ranges


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
# Host staging shared by the indexed and foreign entries.
# ---------------------------------------------------------------------------


def _stage_arrays(gbody: bytes, nw: int, u_pad: int, units, n_stored: int,
                  n_out_pad: int, sruns, l_pad: int | None, lanes):
    """Numpy inputs of one group, padded to the shared shapes: the body
    as nw u32 words (carried as int32 bits), the units' canonical
    descriptors, block starts, stored runs and (walk path) lanes."""
    with maybe_stage("decode_pack"):
        wbytes = gbody + b"\x00" * (nw * 4 - len(gbody))
        words = np.frombuffer(wbytes[: nw * 4], "<u4").view(np.int32)
        a = {"words": words.copy()}
        for name, width in (("ll_first", 16), ("ll_cnt", 16),
                            ("ll_off", 16), ("ll_sym", _MAX_LL),
                            ("d_first", 16), ("d_cnt", 16), ("d_off", 16),
                            ("d_sym", _MAX_D)):
            a[name] = np.zeros((u_pad, width), np.int32)
        a["start_bits"] = np.zeros(u_pad, np.int32)
        a["out_bases"] = np.zeros(u_pad, np.int32)
        a["unit_valid"] = np.zeros(u_pad, bool)
        for j, un in enumerate(units):
            (a["ll_first"][j], a["ll_cnt"][j], a["ll_off"][j],
             a["ll_sym"][j]) = un.ll
            (a["d_first"][j], a["d_cnt"][j], a["d_off"][j],
             a["d_sym"][j]) = un.d
            a["start_bits"][j] = un.bit
            a["out_bases"][j] = un.out_base
            a["unit_valid"][j] = True
        if n_stored:
            sr = np.zeros((n_stored, 3), np.int32)
            sr[:, 0] = n_out_pad  # padding rows: out of range, len 0
            for j, run in enumerate(sruns):
                sr[j] = run
        else:
            sr = np.zeros((1, 3), np.int32)
        a["sr"] = sr
        if l_pad is not None:
            for k, name in enumerate(("lane_bit", "lane_out", "lane_uid",
                                      "lane_valid")):
                a[name] = np.zeros(l_pad, np.int32)
                a[name][: lanes.shape[1]] = lanes[k]
        return a


def _upload(arrs: dict, dev: torch.device) -> dict:
    with maybe_stage("decode_upload", dev):
        return {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}


def _check_crc(group_crc, group_out, crc_expect: int) -> None:
    with maybe_stage("decode_verify"):
        crc = 0
        vals = torch.stack(group_crc).cpu().tolist() if group_crc else []
        for v, (_buf, go) in zip(vals, group_out):
            crc = cs.crc32_combine(crc, int(v), go)
    if crc != crc_expect:
        raise ValueError("crc32 mismatch (device inflate)")


def _device_result(group_out, total_out: int, tail: bytes, dev):
    """to_device=True: (uint8 tensor on the decode device, length)."""
    if tail:
        raise ValueError("to_device unsupported for multi-member gzip")
    if not group_out:
        return torch.zeros((0,), dtype=torch.uint8, device=dev), 0
    if len(group_out) == 1:
        buf, _go = group_out[0]
        return buf[_W : _W + total_out], total_out
    return torch.cat([buf[_W : _W + go] for buf, go in group_out]), total_out


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
    dev = _resolve_device(device)
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

            out_sizes = [
                min(chunk_bytes, max(0, total_out - i * chunk_bytes))
                for i in range(nchunks)
            ]
            out_starts = [i * chunk_bytes for i in range(nchunks)]
            body = data[header_len : member_len - 8]

            # Partition chunks into groups bounded by body and output.
            if use_walk:
                body_cap = _WGROUP_BODY
                out_cap = max(_WGROUP_OUT, chunk_bytes)
            else:
                body_cap = _GROUP_BODY
                out_cap = max(_GROUP_OUT, chunk_bytes)
            if any(sz > body_cap for sz, _b, _a in chunks):
                return None  # one chunk exceeds a group; native fallback
            cpos = [0]
            for sz, _b, _a in chunks:
                cpos.append(cpos[-1] + sz)
            groups: list[tuple[int, int]] = []
            lo = 0
            for i in range(nchunks):
                if (
                    cpos[i + 1] - cpos[lo] > body_cap
                    or (i + 1 - lo) * chunk_bytes > out_cap
                ) and i > lo:
                    groups.append((lo, i))
                    lo = i
            if lo < nchunks:
                groups.append((lo, nchunks))

        # Host walk of every group's block headers (tiny descriptors).
        plans = []
        max_units = 1
        max_stored = 0
        max_lanes = 1
        try:
            for glo, ghi in groups:
                g_out_lo = out_starts[glo]
                units, sruns, uranges = _plan_units(
                    body[cpos[glo] : cpos[ghi]],
                    chunks[glo:ghi],
                    [_W + out_starts[i] - g_out_lo for i in range(glo, ghi)],
                    out_sizes[glo:ghi],
                )
                # Walk lanes: every block's first token + every index
                # anchor (rebased into the group's bit/output spaces),
                # each tagged with the unit whose tree decodes it.
                lanes = None
                if use_walk:
                    parts = [np.zeros((3, 0), np.int64)]
                    for ci in range(glo, ghi):
                        ulo, uhi = uranges[ci - glo]
                        if ulo == uhi:
                            continue  # stored fallback: no token lanes
                        ubit = np.array([units[u].bit
                                         for u in range(ulo, uhi)], np.int64)
                        parts.append(np.stack([
                            ubit,
                            [units[u].out_base for u in range(ulo, uhi)],
                            np.arange(ulo, uhi)]))
                        anc = np.array(chunks[ci][2], np.int64).reshape(-1, 2)
                        abit = (cpos[ci] - cpos[glo]) * 8 + anc[:, 0]
                        k = np.searchsorted(ubit, abit, side="right") - 1
                        ok = k >= 0  # an anchor before any token: bogus
                        parts.append(np.stack([
                            abit[ok],
                            _W + out_starts[ci] - g_out_lo + anc[ok, 1],
                            ulo + k[ok]]))
                    bit, out, uid = np.concatenate(parts, axis=1)
                    # A crafted index can place an anchor exactly on a
                    # block-first token: drop duplicate (bit, out) lanes
                    # (first occurrence wins; duplicates walk the same).
                    _, first = np.unique((bit << 32) | out, return_index=True)
                    first.sort()
                    lanes = _walk_lanes(bit[first], out[first], uid[first])
                    max_lanes = max(max_lanes, lanes.shape[1])
                plans.append((glo, ghi, units, sruns, lanes))
                max_units = max(max_units, len(units))
                max_stored = max(max_stored, len(sruns))
        except (IndexError, struct.error) as e:
            # Host header parsing ran off the segment: the index lied.
            raise ValueError(f"corrupt indexed segment: {e}") from e

        # Shared shapes for every group.
        multi = len(groups) > 1
        max_body = max((cpos[hi] - cpos[lo] for lo, hi in groups), default=0)
        nbits = (
            _GROUP_BITS if multi else max(_RR, _pow2(max_body * 8 + 16))
        )
        max_go = max(
            (
                out_starts[hi - 1] + out_sizes[hi - 1] - out_starts[lo]
                for lo, hi in groups
            ),
            default=0,
        )
        n_out_pad = _pow2(_W + max(1, max_go))
        u_pad = _pow2(max_units)
        max_seg_bits = max((sz * 8 for sz, _b, _a in chunks), default=1)
        max_sup_span = min(nbits // _RR, max_seg_bits // _RR + 2)
        n_stored = _pow2(max_stored) if max_stored else 0
        if use_walk:
            nw = (body_cap if multi else _pow2(max(64, max_body))) // 4 + 2
        else:
            nw = nbits // 32 + 2
        l_pad = _lane_bucket(max_lanes) if use_walk else None
        t_steps = anchor_tokens + 2  # spacing + EOB + slack

    prefix = torch.zeros((_W,), dtype=torch.uint8, device=dev)
    group_out: list[tuple[torch.Tensor, int]] = []  # (device buf, out bytes)
    group_crc: list[torch.Tensor] = []
    for glo, ghi, units, sruns, lanes in plans:
        go = out_starts[ghi - 1] + out_sizes[ghi - 1] - out_starts[glo]
        with maybe_stage("decode_plan"):
            staged = _stage_arrays(
                body[cpos[glo] : cpos[ghi]], nw, u_pad, units, n_stored,
                n_out_pad, sruns, l_pad, lanes,
            )
        arrs = _upload(staged, dev)
        if use_walk:
            out_dev, crc_dev = _walk_all(
                arrs, prefix, _W + go, n_out_pad, n_stored, t_steps,
                with_crc=verify,
            )
        else:
            with maybe_stage("decode_walk", dev):
                out_dev = _decode_all(
                    arrs["words"], arrs["ll_first"], arrs["ll_cnt"],
                    arrs["ll_off"], arrs["ll_sym"], arrs["d_first"],
                    arrs["d_cnt"], arrs["d_off"], arrs["d_sym"],
                    arrs["start_bits"], arrs["out_bases"],
                    arrs["unit_valid"], prefix, arrs["sr"],
                    nbits, n_out_pad, max_sup_span, n_stored,
                )
            crc_dev = None
            if verify:
                with maybe_stage("decode_crc", dev):
                    crc_dev = cs._crc32_impl(out_dev, _W + go, _W)
        if verify:
            group_crc.append(crc_dev)
        group_out.append((out_dev, go))
        if (glo, ghi) != groups[-1]:
            # Last 32 KiB of output so far: positions [go, go+_W) of this
            # buffer (its own [0,_W) prefix covers the short-output case).
            prefix = out_dev[go : go + _W]

    if verify:
        _check_crc(group_crc, group_out, crc_expect)

    if to_device:
        return _device_result(group_out, total_out, tail, dev)

    with maybe_stage("decode_fetch"):
        out = b"".join(_fetch_bytes(buf, go, base=_W) for buf, go in group_out)
    if verify and (len(out) & _M32) != (isize & _M32):
        raise ValueError("isize mismatch (device inflate)")
    if tail:
        out += inflate.decompress(tail, format="gzip")
    return out


def _fetch_bytes(out_dev: torch.Tensor, total_out: int, base: int = 0) -> bytes:
    """Device->host: one copy of [base, base + total_out)."""
    if total_out == 0:
        return b""
    return out_dev[base : base + total_out].cpu().numpy().tobytes()


# ---------------------------------------------------------------------------
# Foreign (unindexed) streams: host anchor pre-scan -> device anchor walk.
#
# Arbitrary zlib/gzip/raw streams carry no index, so the C scanner
# (native.scan_anchors) walks the bitstream once without materializing
# output and records exactly the lane set the walk needs: every block's
# first token plus every FOREIGN_ANCHOR_TOKENS-th token's (bit, out)
# position.
# ---------------------------------------------------------------------------


def decompress_foreign(data: bytes, format: str = "gzip", verify: bool = True,
                       to_device: bool = False, device=None):
    """Device decode of a foreign (unindexed) zlib/gzip/raw stream.

    Returns None when the stream is unsuitable (a preset dictionary,
    nothing but stored blocks, a size cap, or one block larger than a
    group): the caller falls back to the host C decoder. The gzip CRC
    verifies on the device; the zlib Adler-32 on the host bytes (fetch
    path only). device=None means CUDA (RuntimeError without a card)."""
    dev = _resolve_device(device)
    data = bytes(data)
    tail = b""
    crc_expect = isize = adler_expect = None
    if format == "gzip":
        header_len = containers.parse_gzip_header(data)
        body = data[header_len:]
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
            blocks, anchors, total_out, end_bit = native.scan_anchors(body, T)
        except ValueError:
            return None  # corrupt per the scanner: let the host raise
    with maybe_stage("decode_plan"):
        if format == "zlib":
            # Adler-32 sits right after the final block (trailing bytes
            # beyond it are ignored, matching zlib.decompress).
            tr = header_len + (end_bit + 7) // 8
            if tr + 4 > len(data):
                raise ValueError("truncated zlib trailer")
            (adler_expect,) = struct.unpack(">I", data[tr : tr + 4])
        if format == "gzip":
            member_end = header_len + (end_bit + 7) // 8 + 8
            if member_end > len(data):
                raise ValueError("truncated gzip member")
            (crc_expect, isize) = struct.unpack(
                "<II", data[member_end - 8 : member_end]
            )
            tail = data[member_end:]
            if tail[:2] != b"\x1f\x8b":
                tail = b""  # trailing garbage tolerated (gzip(1) behavior)
            if isize != (total_out & _M32):
                raise ValueError("isize mismatch (device inflate)")
        if total_out > (1 << 30):
            return None
        nb = len(blocks)
        if nb == 0 or not (blocks[:, 1] != 0).any():
            return None  # all-stored stream: the host memcpy path wins

        # Partition blocks into groups bounded like the indexed walk path.
        out_cap = _WGROUP_OUT
        body_cap = _WGROUP_BODY
        out_ends = np.empty(nb, np.int64)
        out_ends[:-1] = blocks[1:, 2]
        out_ends[-1] = total_out
        bit_ends = np.empty(nb, np.int64)
        bit_ends[:-1] = blocks[1:, 0]
        bit_ends[-1] = end_bit
        if ((out_ends - blocks[:, 2]) > out_cap).any() or (
            (bit_ends - blocks[:, 0]) // 8 > body_cap
        ).any():
            return None  # one block exceeds a group
        groups: list[tuple[int, int]] = []  # [lo, hi) block ranges
        lo = 0
        for i in range(nb):
            if i > lo and (
                (bit_ends[i] // 8 - blocks[lo, 0] // 8) > body_cap
                or (out_ends[i] - blocks[lo, 2]) > out_cap
            ):
                groups.append((lo, i))
                lo = i
        if lo < nb:
            groups.append((lo, nb))

        # Per group: units from block headers, stored runs, lanes (the
        # indexed path's _plan_units work, under the same stage name).
        plans = []
        max_units = 1
        max_stored = 0
        max_lanes = 1
        max_body = 0
        max_go = 1
        abit = anchors[:, 0]
        for glo, ghi in groups:
            with maybe_stage("decode_units"):
                byte_lo = int(blocks[glo, 0] // 8)
                byte_hi = int((bit_ends[ghi - 1] + 7) // 8)
                out_lo = int(blocks[glo, 2])
                go = int(out_ends[ghi - 1]) - out_lo
                sruns: list[tuple[int, int, int]] = []
                ustarts: list[int] = []  # each coded block's header bit
                uouts: list[int] = []
                for bi in range(glo, ghi):
                    bit0, btype, ostart, aux0, aux1 = (
                        int(v) for v in blocks[bi])
                    if btype == 0:
                        if aux1:
                            sruns.append(
                                (_W + ostart - out_lo, aux0 - byte_lo, aux1)
                            )
                        continue
                    ustarts.append(bit0)
                    uouts.append(_W + ostart - out_lo)
                # Parse the headers at their absolute bits, then rebase.
                with maybe_stage("decode_headers"):
                    hdr_end, ll, d = native.parse_headers(body, ustarts,
                                                          len(body))
                ubit = hdr_end - 8 * byte_lo
                uout = np.array(uouts, np.int64)
                units = _units(ubit, uouts, ll, d)
                # Lanes: every coded block's first token and every anchor,
                # tagged with the unit whose block holds it.
                a_lo = np.searchsorted(abit, blocks[glo, 0], side="left")
                a_hi = np.searchsorted(abit, bit_ends[ghi - 1], side="left")
                anc = anchors[a_lo:a_hi]
                k = np.searchsorted(np.array(ustarts, np.int64), anc[:, 0],
                                    side="right") - 1
                ok = k >= 0
                lanes = _walk_lanes(
                    np.concatenate([ubit, anc[ok, 0] - 8 * byte_lo]),
                    np.concatenate([uout, _W + anc[ok, 1] - out_lo]),
                    np.concatenate([np.arange(len(units)), k[ok]]))
                plans.append((byte_lo, byte_hi, go, units, sruns, lanes))
                max_units = max(max_units, len(units))
                max_stored = max(max_stored, len(sruns))
                max_lanes = max(max_lanes, lanes.shape[1])
                max_body = max(max_body, byte_hi - byte_lo)
                max_go = max(max_go, go)

        multi = len(plans) > 1
        n_out_pad = _pow2(_W + max_go)
        u_pad = _pow2(max_units)
        n_stored = _pow2(max_stored) if max_stored else 0
        nw = (body_cap if multi else _pow2(max(64, max_body))) // 4 + 2
        l_pad = _lane_bucket(max_lanes)
        t_steps = T + 2

    with_crc = verify and format == "gzip"
    prefix = torch.zeros((_W,), dtype=torch.uint8, device=dev)
    group_out: list[tuple[torch.Tensor, int]] = []
    group_crc: list[torch.Tensor] = []
    for byte_lo, byte_hi, go, units, sruns, lanes in plans:
        with maybe_stage("decode_plan"):
            staged = _stage_arrays(
                body[byte_lo:byte_hi], nw, u_pad, units, n_stored,
                n_out_pad, sruns, l_pad, lanes,
            )
        arrs = _upload(staged, dev)
        out_dev, crc_dev = _walk_all(
            arrs, prefix, _W + go, n_out_pad, n_stored, t_steps,
            with_crc=with_crc,
        )
        if with_crc:
            group_crc.append(crc_dev)
        group_out.append((out_dev, go))
        prefix = out_dev[go : go + _W]

    if with_crc:
        _check_crc(group_crc, group_out, crc_expect)

    if to_device:
        return _device_result(group_out, total_out, tail, dev)

    with maybe_stage("decode_fetch"):
        out = b"".join(_fetch_bytes(buf, go, base=_W) for buf, go in group_out)
    if verify and format == "zlib":
        if native.adler32(out) != adler_expect:
            raise ValueError("adler32 mismatch (device inflate)")
    if tail:
        out += inflate.decompress(tail, format="gzip")
    return out
