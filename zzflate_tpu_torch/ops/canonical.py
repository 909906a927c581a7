"""Canonical Huffman symbol decode over lane vectors, in torch ops.

Port of ``zzflate_tpu/models/inflate_tpu.py:281-474`` (``_build_luts``,
``_bit_windows``, ``_extract``, ``_decode_bits``, ``_brev15_dyn``,
``_canon_lane_tables``, ``_canon_symbol``, ``_decode_bits_canon``) and of
its constant tables (``_brev15``, ``_ll_attr``, ``_d_attr``), with the
length and distance tables of RFC 1951 3.2.5. u32 windows are carried as
int64 masked to 32 bits. Device decode (``models/inflate_device``) and the
plain versions of the anchor walk and the candidate decode
(``ops/kernels.anchor_walk_plain``, ``decode_candidates_plain``) decode
through it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch.constants import MAX_MATCH

_M32 = 0xFFFFFFFF
_MAX_LL = 288
_MAX_D = 32  # HDIST is 5 bits: up to 32 dist codes (30/31 invalid if used)
_HUGE = 257  # step meaning "EOB / invalid: stop"; exceeds any token's 48 bits
_LUT_BITS = 15


def _len_extra_base(lcode):
    """(extra_bits, base_length) of a length code 0..28."""
    lcode = lcode.long()
    e = torch.clamp((lcode >> 2) - 1, min=0)
    base = torch.where(lcode < 4, lcode + 3, 3 + ((4 + (lcode & 3)) << e))
    ext = torch.where((lcode < 4) | (lcode >= 28), 0, e)
    base = torch.where(lcode >= 28, MAX_MATCH, base)
    return ext, base


def _dist_extra_base(dcode):
    """(extra_bits, base_distance) of a distance code 0..29."""
    dcode = dcode.long()
    e = torch.clamp((dcode >> 1) - 1, min=0)
    base = torch.where(dcode < 4, dcode + 1, 1 + ((2 + (dcode & 1)) << e))
    ext = torch.where(dcode < 4, 0, e)
    return ext, base


def _shl32(x, n):
    """(x << n) mod 2^32 for u32 x carried in int64 and 0 <= n <= 31."""
    return (x << n) & _M32


def _extract(lo, hi, offset, n):
    """n (<=15) bits at bit `offset` (<=35) of the 64-bit window (lo, hi)."""
    o = offset.clamp(max=31)
    a = (lo >> o) | _shl32(_shl32(hi, 31 - o), 1)
    b = hi >> (offset - 32).clamp(0, 31)
    r = torch.where(offset < 32, a, b)
    return r & ((1 << n) - 1)


def _brev15_dyn(x):
    """15-bit reversal of x's low 15 bits, elementwise."""
    x = x & 0x7FFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def _canon_unit_tables(first, cnt, off):
    """Per-unit canonical decode tables, (U, 16) int32 each: the monotone
    left-aligned range boundaries (hi_mono), left-aligned first codes
    (fsh) and symbol offsets per code length. Canonical codes tile the
    window space, so a window's code length is 1 + #{L : v >= hi_mono[L]};
    the running max keeps the boundaries monotone where the descriptors
    zero lengths past the tree's longest."""
    ln_r = torch.arange(16, dtype=torch.int32, device=first.device)[None, :]
    hi = (first + cnt) << (15 - ln_r)
    hi_mono = torch.cummax(hi, dim=1).values
    fsh = first << (15 - ln_r)
    return hi_mono.int(), fsh.int(), off.int()


def _canon_lane_tables(unit_tables, uid):
    """The unit tables (hi_mono, fsh, off) gathered per lane: (lanes, 16)
    int64 each."""
    return tuple(t.long()[uid] for t in unit_tables)


def _canon_symbol(v15, hi_lane, fsh_lane, off_lane, sym_flat, uid, nsym):
    """Decode one canonical symbol per lane from the left-aligned window
    value v15: code length by boundary sum, symbol index by offset
    arithmetic, then one symbol-table lookup."""
    ln = 1 + (v15[:, None] >= hi_lane[:, 1:]).sum(1)
    valid = ln <= 15
    lnc = ln.clamp(1, 15)
    fsel = fsh_lane.gather(1, lnc[:, None])[:, 0]
    osel = off_lane.gather(1, lnc[:, None])[:, 0]
    idx = osel + ((v15 - fsel) >> (15 - lnc))
    sym = sym_flat[uid * nsym + idx.clamp(0, nsym - 1)]
    return sym, lnc, valid


def _decode_bits_canon(win_lo, win_hi, uid, llt, dt, ll_sym_flat,
                       d_sym_flat):
    """One token per window from per-lane canonical tables: (step,
    outlen, sym, mdist, islit, islen, iseob). step is the token's width
    in bits, or _HUGE at EOB or on an invalid window (a code past the
    tree, a reserved symbol, or a length with an invalid distance)."""
    hi_l, fsh_l, off_l = llt
    v = _brev15_dyn(win_lo)
    sym, nb, lvalid = _canon_symbol(
        v, hi_l, fsh_l, off_l, ll_sym_flat, uid, _MAX_LL
    )
    iseob = sym == 256
    islen0 = (sym >= 257) & (sym <= 285)
    valid = lvalid & (sym <= 285)
    lext, lbase = _len_extra_base((sym - 257).clamp(0, 28))
    lext = torch.where(islen0, lext, 0)
    mlen = lbase + _extract(win_lo, win_hi, nb, lext)
    off2 = nb + lext

    hi_d, fsh_d, off_d = dt
    w2 = _extract(win_lo, win_hi, off2, 15)
    vd = _brev15_dyn(w2)
    dsym, dnb, dv = _canon_symbol(
        vd, hi_d, fsh_d, off_d, d_sym_flat, uid, _MAX_D
    )
    dvalid = dv & (dsym < 30)
    dext, dbase = _dist_extra_base(dsym.clamp(0, 29))
    mdist = dbase + _extract(win_lo, win_hi, off2 + dnb, dext)

    invalid = ~valid | (islen0 & ~dvalid)
    width = torch.where(islen0, off2 + dnb + dext, nb)
    step = torch.where(invalid | iseob, _HUGE, width)
    islit = valid & ~iseob & ~islen0
    outlen = torch.where(
        islit, 1, torch.where(islen0 & ~invalid, mlen, 0)
    )
    return step, outlen, sym, mdist, islit, islen0 & ~invalid, iseob & valid


# ---------------------------------------------------------------------------
# The per-bit path's LUT decode (the plain version of ops/kernels.
# decode_candidates): constant tables, LUTs, bit windows, candidate tokens.
# ---------------------------------------------------------------------------


@functools.cache
def _brev15() -> np.ndarray:
    """brev15[w] = 15-bit reversal of w: the MSB-first code value whose
    LSB-first stream bits are w's low bits."""
    w = np.arange(1 << _LUT_BITS, dtype=np.uint32)
    r = np.zeros_like(w)
    for i in range(_LUT_BITS):
        r |= ((w >> i) & 1) << (_LUT_BITS - 1 - i)
    return r.astype(np.int32)


@functools.cache
def _ll_attr() -> np.ndarray:
    """Per-litlen-symbol attributes: lext(3b) | lbase<<3 (9b) |
    eob<<12 | islen<<13 | bad<<14 (RFC 1951 3.2.5)."""
    a = np.zeros(_MAX_LL, np.int32)
    a[256] = 1 << 12
    for s in range(257, 286):
        a[s] = (
            int(C.LENGTH_EXTRA[s - 257])
            | (int(C.LENGTH_BASE[s - 257]) << 3)
            | (1 << 13)
        )
    a[286] = a[287] = 1 << 14  # reserved symbols: corrupt if used
    return a


@functools.cache
def _d_attr() -> np.ndarray:
    """Per-distance-symbol attributes: dext(4b) | dbase<<4 (15b).
    Symbols 30/31 keep attr 0 (dbase 0 marks them corrupt if decoded)."""
    a = np.zeros(_MAX_D, np.int32)
    for s in range(30):
        a[s] = int(C.DIST_EXTRA[s]) | (int(C.DIST_BASE[s]) << 4)
    return a


@functools.cache
def _on_device(name: str, device: torch.device) -> torch.Tensor:
    """The per-bit path's constant tables, uploaded once per device (an
    upload from host memory would synchronise every group)."""
    return torch.from_numpy(
        {"brev15": _brev15, "ll_attr": _ll_attr, "d_attr": _d_attr}[name]()
    ).to(device)


def _build_luts(first, cnt, off, symtab, attr, nsym, sym_bits):
    """(U,16)x3 + (U,nsym) descriptors -> (U, 2^15) packed LUT.

    Entry: sym(sym_bits) | nb<<sym_bits (4b) | attr<<(sym_bits+4);
    0 = invalid window. Canonical closed form: a window's code length is
    1 + #{L : v >= hi_mono[L]} and its symbol index
    off[ln] + ((v - first[ln]<<(15-ln)) >> (15-ln))."""
    dev = first.device
    c = _on_device("brev15", dev).long()[None, :]
    first, cnt, off = first.long(), cnt.long(), off.long()
    ln_r = torch.arange(16, device=dev)
    hi_mono = torch.cummax((first + cnt) << (15 - ln_r), dim=1).values
    ln_sel = 1 + sum(
        (c >= hi_mono[:, L][:, None]).long() for L in range(1, 16)
    )
    valid = ln_sel <= 15
    lnc = ln_sel.clamp(1, 15)
    idx_sel = torch.zeros_like(lnc)
    for L in range(1, 16):
        rel = (c - (first[:, L] << (15 - L))[:, None]) >> (15 - L)
        idx_sel = torch.where(lnc == L, off[:, L][:, None] + rel, idx_sel)
    sym = symtab.long().gather(1, idx_sel.clamp(0, nsym - 1))
    if isinstance(attr, np.ndarray):
        attr = torch.from_numpy(attr).to(dev)
    a = attr.long()[sym]
    ent = sym | (lnc << sym_bits) | (a << (sym_bits + 4))
    return torch.where(valid, ent, 0)


def _bit_windows(words):
    """48+-bit windows for every bit position: for bit p = 32w + s,
    win_lo = bits p..p+31, win_hi = bits p+32..p+63 (int64 u32)."""
    w = words.long() & _M32
    s = torch.arange(32, device=w.device)[None, :]
    w0, w1, w2 = w[:-2, None], w[1:-1, None], w[2:, None]
    inv = 31 - s
    lo = (w0 >> s) | _shl32(_shl32(w1, inv), 1)
    hi = (w1 >> s) | _shl32(_shl32(w2, inv), 1)
    return lo.reshape(-1), hi.reshape(-1)


def _decode_bits(win_lo, win_hi, uid, ll_lut, d_lut):
    """Candidate token at every bit: (step, outlen, lit, mdist, islit,
    islen, iseob)."""
    lut_mask = (1 << _LUT_BITS) - 1
    flat_ll = ll_lut.reshape(-1)
    flat_d = d_lut.reshape(-1)
    base = uid << _LUT_BITS

    e = flat_ll[base + (win_lo & lut_mask)]
    sym = e & 0x3FF
    nb = (e >> 10) & 15
    a = e >> 14
    lext = a & 7
    lbase = (a >> 3) & 511
    valid = (nb > 0) & ((a & (1 << 14)) == 0)
    iseob = (a & (1 << 12)) != 0
    islen = (a & (1 << 13)) != 0
    mlen = lbase + _extract(win_lo, win_hi, nb, lext)

    off2 = nb + lext
    w2 = _extract(win_lo, win_hi, off2, _LUT_BITS)
    de = flat_d[base + w2]
    dnb = (de >> 5) & 15
    da = de >> 9
    dext = da & 15
    dbase = (da >> 4) & 32767
    dvalid = (dnb > 0) & (dbase > 0)  # dbase 0 = reserved symbol 30/31
    mdist = dbase + _extract(win_lo, win_hi, off2 + dnb, dext)

    invalid = ~valid | (islen & ~dvalid)
    width = torch.where(islen, off2 + dnb + dext, nb)
    step = torch.where(invalid | iseob, _HUGE, width)
    islit = valid & ~iseob & ~islen
    outlen = torch.where(islit, 1, torch.where(islen & ~invalid, mlen, 0))
    return step, outlen, sym, mdist, islit, islen & ~invalid, iseob & valid
