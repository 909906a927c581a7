"""The two-phase batched DEFLATE encoder: analyze on the device, emit on
the device with host-built tables.

Port of the production half of ``zzflate_tpu/models/deflate_encoder.py``
(:44-93, :374-401, :447-551, :554-956, :1008-1011). Phase 1
(``analyze_chunks_batch``) runs the matcher, the parse and the sub-block
histograms on a (B, N) batch; the host builds per-sub-block Huffman
tables from the small histograms; phase 2 (``emit_chunks_batch``) turns
every committed token into one <= 48-bit field at a closed-form bit
offset and scatter-adds it into the chunk's word buffer.

Everything runs in torch on whatever device the inputs are on. u32
quantities are carried as int64 masked to 32 bits.
"""
from __future__ import annotations

import torch

from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch.ops import bitpack, checksums, huffman, matcher
from zzflate_tpu_torch.ops.canonical import _dist_extra_base, _len_extra_base

U32 = bitpack.U32

# ---------------------------------------------------------------------------
# Closed-form symbol math: the RFC 1951 length/distance code tables are
# power-of-two ramps, so code, base and extra follow from bit lengths.
# ---------------------------------------------------------------------------


def _bit_length(x):
    """bit_length(x) for 1 <= x < 2^24."""
    return torch.frexp(x.float()).exponent.long()


def _len_code(mlen):
    """LENGTH_TO_CODE[mlen] for mlen in [3, 258] (code 0..28)."""
    m = torch.clamp(mlen.long(), 3, C.MAX_MATCH) - 3
    bl = _bit_length(torch.clamp(m, min=1))
    hi = 4 * (bl - 2) + ((m >> torch.clamp(bl - 3, min=0)) & 3)
    return torch.where(
        mlen >= C.MAX_MATCH, 28, torch.where(m < 8, m, hi)
    ).int()


def _dist_code(mdist):
    """Distance code 0..29 for mdist in [1, 32768]."""
    n = torch.clamp(mdist.long(), min=1) - 1
    bl = _bit_length(torch.clamp(n, min=1))
    hi = 2 * (bl - 1) + ((n >> torch.clamp(bl - 2, min=0)) & 1)
    return torch.where(n < 4, n, hi).int()


# ---------------------------------------------------------------------------
# Sub-blocks and anchors.
# ---------------------------------------------------------------------------

# Each chunk is emitted as ceil(chunk/SUB_BLOCK) deflate blocks with their
# own Huffman trees; sub-blocks partition the TOKEN positions.
SUB_BLOCK = 1 << 16
_WIN = 32768

# v3 index anchors: one slot per ANCHOR_TOKENS committed tokens of each
# sub-block (a sub-block of 65536 positions holds at most 64 intervals).
_A_PB = SUB_BLOCK // C.ANCHOR_TOKENS


def sub_block_count(chunk_bytes: int) -> int:
    return max(1, chunk_bytes // SUB_BLOCK)


def sub_block_bounds(n: int) -> list[int]:
    """Static token-range boundaries [W .. n] for a (W+chunk,) buffer."""
    chunk = n - _WIN
    sb = sub_block_count(chunk)
    return [_WIN + (b * chunk) // sb for b in range(sb)] + [n]


def token_budget(chunk_bytes: int) -> int:
    """Token-slot count of the compact emit: half the position width.
    A chunk with more committed tokens goes to the full-width emit."""
    return (_WIN + chunk_bytes) // 2


def output_words_bound(chunk_bytes: int) -> int:
    """u32 buffer size: fixed-tree worst case < 9.4 bits/byte + headers
    (one dynamic header per sub-block, <= ~8 Kbit each)."""
    return (chunk_bytes * 10 + 65536 + sub_block_count(chunk_bytes) * 8192) // 32


# ---------------------------------------------------------------------------
# Phase 1.
# ---------------------------------------------------------------------------


def analyze_chunks_batch(data, starts, valid_ends, window_starts, params,
                         huffman_only: bool = False, strategy: int = 0,
                         max_dist: int = 32768, with_checksums: bool = False):
    """Match + parse + sub-block histograms on a (B, N) uint8 batch.

    strategy follows zlib.h:196-200: 2=HUFFMAN_ONLY (no matches, via
    huffman_only), 3=RLE (distance-1 matches only), 1=FILTERED (drop
    matches shorter than 5). max_dist < 32768 implements reduced
    windowBits by dropping far matches. Returns the reference's dict:
    freq_ll (B, SB, 288), freq_d (B, SB, 30), freqs (both, packed), and
    the (B, N) committed, is_match, litlen_sym, lcode, dcode, mlen, mdist,
    and at levels 7-9 mm_packed = mlen << 16 | mdist. with_checksums
    adds each row's Adler-32 and CRC-32 over [starts, valid_ends) (the
    chunk's own bytes, not its dictionary or halo prefix) as (B,) int64
    "adler" and "crc", and both packed as "cks" (B, 2) for one copy.
    """
    bch, n = data.shape
    if huffman_only:
        mlen = torch.zeros((bch, n), dtype=torch.int32, device=data.device)
        mdist = torch.zeros_like(mlen)
    else:
        mlen, mdist = matcher.find_matches(
            data, valid_ends, window_starts, params.candidates,
            key_words=params.key_words,
        )
        drop = torch.zeros_like(mlen, dtype=torch.bool)
        if strategy == 3:  # Z_RLE: only run matches at distance one
            drop = drop | (mdist != 1)
        elif strategy == 1:  # Z_FILTERED: skip short matches
            drop = drop | (mlen < 5)
        if max_dist < 32768:
            drop = drop | (mdist > max_dist)
        mlen = torch.where(drop, 0, mlen)
        mdist = torch.where(drop, 0, mdist)

    committed, take = matcher.parse_commit_batch(
        mlen, starts, valid_ends,
        lazy=params.lazy_mode, max_lazy=params.max_lazy, nice=params.nice,
    )
    is_match = take
    lcode = _len_code(mlen)
    dcode = _dist_code(mdist)
    litlen_sym = torch.where(is_match, 257 + lcode, data.int())

    bounds = sub_block_bounds(n)
    spans = list(zip(bounds[:-1], bounds[1:]))
    freq_ll = torch.stack([
        huffman.histogram(litlen_sym[:, s:e], committed[:, s:e],
                          C.NUM_LITLEN_SYMBOLS)
        for s, e in spans
    ], dim=1)
    freq_d = torch.stack([
        huffman.histogram(dcode[:, s:e], is_match[:, s:e],
                          C.NUM_DIST_SYMBOLS)
        for s, e in spans
    ], dim=1)
    out = {
        "freq_ll": freq_ll,
        "freq_d": freq_d,
        # One packed buffer, one device-to-host copy per batch:
        # [..., :288] = freq_ll, [..., 288:] = freq_d.
        "freqs": torch.cat([freq_ll, freq_d], dim=2),
        "committed": committed,
        "is_match": is_match,
        "litlen_sym": litlen_sym,
        "lcode": lcode,
        "dcode": dcode,
        "mlen": mlen,
        "mdist": mdist,
    }
    if params.optimal:
        # The host optimal-parse DP (levels 7-9) reads the candidates:
        # (mlen, mdist <= 32768) packed into one int32, one copy.
        out["mm_packed"] = (mlen << 16) | mdist
    if with_checksums:
        out["adler"] = checksums.adler32_rows(data, valid_ends, starts)
        out["crc"] = checksums.crc32_rows(data, valid_ends, starts)
        out["cks"] = torch.stack([out["adler"], out["crc"]], dim=1)
    return out


# ---------------------------------------------------------------------------
# Phase 2.
# ---------------------------------------------------------------------------


def _mask(v, b):
    return v & ((1 << b) - 1)


def _fields48(c_sym, c_lcode, c_dcode, c_ism, c_com, c_mlen, c_mdist, c_tb,
              ll_len, ll_code, d_len, d_code):
    """Each token's four fields [litlen code, len extra, dist code, dist
    extra] merged into one field of tw <= 48 bits: (lo48, hi48, tw)."""
    bch = c_sym.shape[0]
    lsym_safe = torch.clamp(c_sym.long(), 0, C.NUM_LITLEN_SYMBOLS - 1)
    dsym_safe = torch.clamp(c_dcode.long(), 0, C.NUM_DIST_SYMBOLS - 1)
    # One packed gather per tree: entry = code | len << 20.
    ll_pack = (ll_code.long() | (ll_len.long() << 20)).reshape(bch, -1)
    d_pack = (d_code.long() | (d_len.long() << 20)).reshape(bch, -1)
    tb = c_tb.long()
    e0 = ll_pack.gather(1, tb * C.NUM_LITLEN_SYMBOLS + lsym_safe)
    f0_v = e0 & 0xFFFFF
    f0_b = torch.where(c_com, e0 >> 20, 0)
    e2 = d_pack.gather(1, tb * C.NUM_DIST_SYMBOLS + dsym_safe)
    f2_v = e2 & 0xFFFFF
    f2_b = torch.where(c_ism, e2 >> 20, 0)
    lext, lbase = _len_extra_base(c_lcode)
    f1_v = (c_mlen.long() - lbase) & U32
    f1_b = torch.where(c_ism, lext, 0)
    dext, dbase = _dist_extra_base(dsym_safe)
    f3_v = (c_mdist.long() - dbase) & U32
    f3_b = torch.where(c_ism, dext, 0)

    m0_v = _mask(f0_v, f0_b) | (_mask(f1_v, f1_b) << f0_b)
    m0_b = f0_b + f1_b
    m1_v = _mask(f2_v, f2_b) | (_mask(f3_v, f3_b) << f2_b)
    m1_b = f2_b + f3_b
    lo48 = (m0_v | (m1_v << m0_b)) & U32
    hi48 = (m1_v >> (32 - m0_b)) & U32
    return lo48, hi48, m0_b + m1_b


def _pack_stream(lo48, hi48, tw, tok_pos, s_idx, t_end, bounds, hdr_vals,
                 hdr_nbits, eob_v, eob_nb, out_words):
    """Lay out [hdr_b, tokens of sub-block b, eob_b] for every sub-block
    and scatter all fields into the word buffer.

    tok_pos: (B, F) position of each token field (sub-block membership);
    s_idx(excl, cum) -> (B, SB) token-bit prefix at each sub-block start;
    t_end(excl, cum, S) -> (B, SB) token bits of each sub-block.
    Returns (words (B, out_words) int64, total_bits, sb_bits, off0)."""
    bch = lo48.shape[0]
    sb = len(bounds) - 1
    cum = torch.cumsum(tw, dim=1)
    excl = cum - tw
    hdr_nbits = hdr_nbits.long()
    hdr_tot = hdr_nbits.sum(dim=2)
    eob_b = eob_nb.long()
    S = s_idx(excl, cum)
    T = t_end(excl, cum, S)
    seg = hdr_tot + T + eob_b
    hdr_base = torch.cumsum(seg, dim=1) - seg
    total_bits = hdr_base[:, sb - 1] + seg[:, sb - 1]

    add = torch.zeros_like(excl)
    for b in range(sb):
        const_b = (hdr_base[:, b] + hdr_tot[:, b] - S[:, b])[:, None]
        add = torch.where(tok_pos >= bounds[b], const_b, add)
    off0 = excl + add

    words = torch.zeros((bch, out_words + bitpack.DROP), dtype=torch.int64,
                        device=lo48.device)
    bitpack.scatter_field48(words, off0, lo48, hi48)
    hdr_off = torch.cumsum(hdr_nbits, dim=2) - hdr_nbits + hdr_base[:, :, None]
    bitpack.scatter_fields(words, hdr_off.reshape(bch, -1),
                           hdr_vals.reshape(bch, -1), hdr_nbits.reshape(bch, -1))
    bitpack.scatter_fields(words, hdr_base + hdr_tot + T, eob_v, eob_b)
    return words[:, :out_words], total_bits, hdr_base, off0


def _anchors(is_anchor, sub_ord, tb, off0, out_excl, a_total):
    """(anc_bit, anc_out): the (bit, output) offsets of every
    ANCHOR_TOKENS-th committed token of each sub-block, -1 where unused."""
    bch = off0.shape[0]
    # Slots past the table (sub-blocks longer than SUB_BLOCK) are dropped.
    slot = torch.where(
        is_anchor, tb * _A_PB + (sub_ord // C.ANCHOR_TOKENS - 1), a_total
    ).clamp(max=a_total)
    anc = torch.full((2, bch, a_total + 1), -1, dtype=torch.int64,
                     device=off0.device)
    anc[0].scatter_(1, slot, off0)
    anc[1].scatter_(1, slot, out_excl)
    return anc[0, :, :a_total], anc[1, :, :a_total]


def _emit_compact(committed, is_match, litlen_sym, lcode, dcode, mlen, mdist,
                  ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v,
                  eob_nb, out_words, with_anchors, wc):
    """Token-compacted emit: one full-width scatter collects the committed
    positions into wc dense slots; every later pass runs at token width.
    Bit-identical to the full-width emit."""
    bch, n = committed.shape
    sb = ll_len.shape[1]
    bounds = sub_block_bounds(n)
    dev = committed.device
    pos = torch.arange(n, device=dev).expand(bch, n)

    com_i = committed.long()
    ctok = torch.cumsum(com_i, dim=1)  # inclusive committed count
    excl_tok = ctok - com_i  # dense slot of the token at p
    ntokens = ctok[:, n - 1]
    slot = torch.where(committed, excl_tok, wc).clamp(max=wc)
    tokpos = torch.full((bch, wc + 1), n, dtype=torch.int64, device=dev)
    tokpos.scatter_(1, slot, pos)
    tokpos = tokpos[:, :wc]

    # Two packed gathers instead of seven.
    pk1 = (litlen_sym.long() | (lcode.long() << 9) | (dcode.long() << 14)
           | (is_match.long() << 19) | (com_i << 20))
    pk2 = (mlen.long() << 16) | mdist.long()
    in_range = tokpos < n
    tcl = tokpos.clamp(max=n - 1)
    g1 = torch.where(in_range, pk1.gather(1, tcl), 0)
    g2 = torch.where(in_range, pk2.gather(1, tcl), 0)
    c_ism = ((g1 >> 19) & 1) == 1
    c_com = ((g1 >> 20) & 1) == 1
    c_mlen = g2 >> 16
    c_tb = torch.zeros_like(tokpos)
    for b in range(1, sb):
        c_tb = c_tb + (tokpos >= bounds[b]).long()

    lo48, hi48, tw = _fields48(
        g1 & 0x1FF, (g1 >> 9) & 0x1F, (g1 >> 14) & 0x1F, c_ism, c_com,
        c_mlen, g2 & 0xFFFF, c_tb, ll_len, ll_code, d_len, d_code,
    )

    # Slot id of the first token at/after each sub-block boundary.
    nb4 = torch.stack([excl_tok[:, bounds[b]] for b in range(sb)], dim=1)
    nb4c = nb4.clamp(0, wc)

    def s_idx(excl, cum):
        return torch.cat([excl, cum[:, -1:]], dim=1).gather(1, nb4c)

    def t_end(excl, cum, S):
        return torch.cat([S[:, 1:], cum[:, wc - 1:wc]], dim=1) - S

    words, total_bits, sb_bits, off0 = _pack_stream(
        lo48, hi48, tw, tokpos, s_idx, t_end, bounds, hdr_vals, hdr_nbits,
        eob_v, eob_nb, out_words,
    )

    outlen = torch.where(c_ism, c_mlen, torch.where(c_com, 1, 0))
    outc = torch.cumsum(outlen, dim=1)
    out_excl = outc - outlen
    sb_out = torch.cat([out_excl, outc[:, -1:]], dim=1).gather(1, nb4c)

    a_total = sb * _A_PB
    if with_anchors:
        csub = torch.zeros_like(tokpos)
        for b in range(sb):
            csub = torch.where(tokpos >= bounds[b], nb4[:, b:b + 1], csub)
        o_b = torch.arange(wc, device=dev)[None, :] - csub
        is_anchor = c_com & (o_b > 0) & (o_b % C.ANCHOR_TOKENS == 0)
        anc_bit, anc_out = _anchors(is_anchor, o_b, c_tb, off0, out_excl,
                                    a_total)
    else:
        anc_bit = torch.full((bch, a_total), -1, dtype=torch.int64, device=dev)
        anc_out = anc_bit

    # A chunk that overflowed its token budget must never ship a
    # truncated stream: poison nbits so the stored fallback wins.
    total_bits = torch.where(ntokens > wc, 1 << 30, total_bits)
    return {
        "words": words, "nbits": total_bits, "ntokens": ntokens,
        "sb_bits": sb_bits, "sb_out": sb_out,
        "anc_bit": anc_bit, "anc_out": anc_out,
    }


def _emit_full(committed, is_match, litlen_sym, lcode, dcode, mlen, mdist,
               ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v,
               eob_nb, out_words, with_anchors):
    """Full-width emit: every position carries its (possibly empty) field.
    The host sends batches whose token counts exceed the compact budget
    here."""
    bch, n = committed.shape
    sb = ll_len.shape[1]
    bounds = sub_block_bounds(n)
    dev = committed.device
    pos = torch.arange(n, device=dev).expand(bch, n)
    tb = torch.zeros_like(pos)
    for b in range(1, sb):
        tb = tb + (pos >= bounds[b]).long()

    lo48, hi48, tw = _fields48(
        litlen_sym, lcode, dcode, is_match, committed, mlen, mdist, tb,
        ll_len, ll_code, d_len, d_code,
    )

    def s_idx(excl, cum):
        return torch.stack([excl[:, bounds[b]] for b in range(sb)], dim=1)

    def t_end(excl, cum, S):
        return torch.stack(
            [cum[:, bounds[b + 1] - 1] for b in range(sb)], dim=1
        ) - S

    words, total_bits, sb_bits, off0 = _pack_stream(
        lo48, hi48, tw, pos, s_idx, t_end, bounds, hdr_vals, hdr_nbits,
        eob_v, eob_nb, out_words,
    )

    # Output offset of each sub-block's first token (a token belongs to
    # the block where it starts).
    outlen = torch.where(is_match, mlen.long(), committed.long())
    out_excl = torch.cumsum(outlen, dim=1) - outlen
    sb_out = torch.stack([out_excl[:, bounds[b]] for b in range(sb)], dim=1)

    a_total = sb * _A_PB
    if with_anchors:
        com_i = committed.long()
        ctok = torch.cumsum(com_i, dim=1) - com_i
        csub = torch.zeros_like(ctok)
        for b in range(sb):
            csub = torch.where(pos >= bounds[b], ctok[:, bounds[b]:bounds[b] + 1],
                               csub)
        o_b = ctok - csub
        is_anchor = committed & (o_b > 0) & (o_b % C.ANCHOR_TOKENS == 0)
        anc_bit, anc_out = _anchors(is_anchor, o_b, tb, off0, out_excl,
                                    a_total)
    else:
        anc_bit = torch.full((bch, a_total), -1, dtype=torch.int64, device=dev)
        anc_out = anc_bit
    return {
        "words": words, "nbits": total_bits,
        "ntokens": committed.long().sum(dim=1),
        "sb_bits": sb_bits, "sb_out": sb_out,
        "anc_bit": anc_bit, "anc_out": anc_out,
    }


def _as_i32(x):
    """int64 values in [0, 2^32) -> int32 carrying the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).int()


def emit_chunks_batch(analysis, out_words, ll_len, ll_code, d_len, d_code,
                      hdr_vals, hdr_nbits, eob_v, eob_nb,
                      keep_bits_max=None, with_anchors: bool = False,
                      token_slots: int = 0):
    """Phase 2, batched: consumes the phase-1 dict and the stacked host
    tables (ll_len/ll_code (B, SB, 288), d_len/d_code (B, SB, 30),
    hdr_vals/hdr_nbits (B, SB, huffman_host.HDR_SLOTS), eob_v/eob_nb (B, SB)).

    token_slots > 0 selects the token-compacted emit (the caller
    guarantees every chunk's token count fits). Every chunk's used words
    (ceil((nbits+3)/32), covering the sync-flush opener) are concatenated
    into one dense int32 "flat_words" buffer carrying u32 bits, with
    per-chunk "word_cnt"; chunks whose nbits exceed keep_bits_max (B,)
    contribute nothing (the stitcher stores them raw). "meta" packs
    [nbits | sb_bits | sb_out | anc_bit | anc_out] per chunk, int32."""
    a = analysis
    args = (
        a["committed"], a["is_match"], a["litlen_sym"], a["lcode"],
        a["dcode"], a["mlen"], a["mdist"],
        ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v, eob_nb,
        out_words, with_anchors,
    )
    out = _emit_compact(*args, token_slots) if token_slots else _emit_full(*args)

    words = out.pop("words")  # (B, W)
    bsz, w = words.shape
    cnt = (out["nbits"] + 3 + 31) // 32
    if keep_bits_max is not None:
        cnt = torch.where(out["nbits"] <= keep_bits_max, cnt, 0)
    off = torch.cumsum(cnt, dim=0) - cnt
    k = torch.arange(w, device=words.device)[None, :]
    tgt = torch.where(k < cnt[:, None], off[:, None] + k, bsz * w)
    flat = torch.zeros((bsz * w + 1,), dtype=torch.int64, device=words.device)
    flat.scatter_(0, tgt.reshape(-1).clamp(max=bsz * w), words.reshape(-1))
    out["flat_words"] = _as_i32(flat[: bsz * w])
    out["word_cnt"] = cnt
    out["meta"] = torch.cat(
        [out["nbits"][:, None], out["sb_bits"], out["sb_out"],
         out["anc_bit"], out["anc_out"]], dim=1,
    ).int()
    return out
