"""Device decode's candidate tokens (ops/kernels.decode_candidates,
csrc/candidates.cu) against the candidate stage of the JAX package's
models/inflate_tpu._decode_all, on the CPU.

On each seeded case of utils/corpus.candidate_inputs, at 65 536 and 131 072
bits, and on the group of a v2 test stream, the plain torch version and
``_candidates_mirror``, a numpy mirror of csrc/candidates.cu in its own
order (launch 1: each unit's clipped code-length bounds; launch 2, tile by
tile: the carry and slots of the owning unit, each thread's four bits, the
warps' shuffles and the cross-warp max; then per bit the 64-bit window,
the two closed-form table entries and the fields), equal the reference's
_build_luts, _bit_windows, owning-unit scan and _decode_bits, run eagerly,
output for output. Tolerance is zero: the decode is integer-only. Change
the kernel and its mirror together.
"""
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zzflate_tpu_torch as zt
from zzflate_tpu.models import inflate_tpu as ref
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils.corpus import (
    CANDIDATE_CASES,
    candidate_inputs,
    mixed_corpus,
)

# One intra-op thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

NBITS = (1 << 16, 1 << 17)
THREADS = kernels.CAND_THREADS
BITS = kernels.CAND_BITS
TILE = THREADS * BITS
HUGE = 257
REF_UNITS = 64  # units a reference LUT build takes at once (bounds memory)
NAMES = ("uid", "step", "outlen", "sym", "mdist", "islit", "islen")


def _reference(words, ll, d, start, valid, nbits):
    """The reference's candidate stage, eagerly: its two LUTs (row by row
    independent, so built REF_UNITS units at a time), the bit windows, the
    owning unit (inflate_tpu.py:603-608) and _decode_bits."""
    def luts(rows, attr, nsym, sym_bits):
        return jnp.concatenate([
            ref._build_luts(*(jnp.asarray(t[k:k + REF_UNITS]) for t in rows),
                            jnp.asarray(attr), nsym, sym_bits)
            for k in range(0, rows[0].shape[0], REF_UNITS)])

    ll_lut = luts(ll, ref._ll_attr(), 288, 10)
    d_lut = luts(d, ref._d_attr(), 32, 5)
    lo, hi = ref._bit_windows(jnp.asarray(words.view(np.uint32)))
    u = start.shape[0]
    uid0 = jnp.zeros((nbits,), jnp.int32).at[
        jnp.where(jnp.asarray(valid), jnp.asarray(start), nbits)
    ].max(jnp.arange(u, dtype=jnp.int32), mode="drop")
    uid = jax.lax.associative_scan(jnp.maximum, uid0)
    out = ref._decode_bits(lo, hi, uid, ll_lut, d_lut)
    return [np.asarray(x) for x in (uid,) + tuple(out[:6])]


# ---------------------------------------------------------------------------
# The numpy mirror of csrc/candidates.cu.
# ---------------------------------------------------------------------------


def _bounds(first, cnt):
    """Launch 1, one thread a (unit, table): the running max of (first +
    cnt) << (15 - L) in 64 bits, clipped to [0, 32768]."""
    h = (first.astype(np.int64) + cnt) * (1 << (15 - np.arange(16)))
    return np.clip(np.maximum.accumulate(h, axis=1), 0, 32768)


def _owning_units(start, valid, nbits):
    """Launch 2's first part, a tile of TILE bits a block: units at or
    before the tile's first bit max-ed into the carry, units inside into
    the slot at their offset; each thread's BITS slots, the warps'
    inclusive shuffles, the exclusive cross-warp max and the carry."""
    start = start.astype(np.int64)
    ok = valid & (start < nbits)
    p = np.maximum(start, 0)
    units = np.arange(start.shape[0])
    ntiles = -(-nbits // TILE)
    uid = np.zeros(ntiles * TILE, np.int64)
    for t in range(ntiles):
        b0 = t * TILE
        carry = units[ok & (p <= b0)].max(initial=0)
        slot = np.zeros(TILE, np.int64)
        inside = ok & (p > b0) & (p < b0 + TILE)
        np.maximum.at(slot, p[inside] - b0, units[inside])
        mine = np.maximum.accumulate(slot.reshape(THREADS, BITS), axis=1)
        run = np.maximum.accumulate(mine[:, -1].reshape(-1, 32), axis=1)
        before = np.concatenate([np.zeros((run.shape[0], 1), np.int64),
                                 run[:, :-1]], axis=1)
        warps = np.r_[0, np.maximum.accumulate(run[:, -1])[:-1]]
        c = np.maximum(np.maximum(carry, before), warps[:, None])
        uid[b0:b0 + TILE] = np.maximum(c.reshape(-1, 1), mine).reshape(-1)
    return uid[:nbits]


def _brev15(w):
    """__brev(w) >> 17 for w < 2^15: the 15-bit reversal."""
    r = np.zeros_like(w)
    for i in range(15):
        r |= ((w >> i) & 1) << (14 - i)
    return r


def _entry(w, hi, first, off, symtab, attr, uid, nsym):
    """The closed-form table entry: (sym, nb, attr), 0 past the tree."""
    c = _brev15(w.astype(np.int64))
    ln = 1 + (c[:, None] >= hi[uid][:, 1:]).sum(1)
    ok = ln <= 15
    L = np.minimum(ln, 15)
    sh = 15 - L
    idx = (off[uid, L].astype(np.int64)
           + ((c - first[uid, L].astype(np.int64) * (1 << sh)) >> sh))
    sym = symtab[uid, np.clip(idx, 0, nsym - 1)]
    a = attr[np.clip(sym, 0, nsym - 1)]
    return (np.where(ok, sym, 0), np.where(ok, ln, 0), np.where(ok, a, 0))


def _bits_at(win, offset, n):
    return ((win >> offset.astype(np.uint64))
            & ((np.uint64(1) << n.astype(np.uint64)) - np.uint64(1))
            ).astype(np.int64)


def _candidates_mirror(words, ll, d, start, valid, nbits, detail=False):
    """(uid, step, outlen, sym, mdist, islit, islen) as the kernel makes
    them; with detail, also a dict of its intermediate fields."""
    hi_ll = _bounds(ll[0], ll[1])
    hi_d = _bounds(d[0], d[1])
    uid = _owning_units(start, valid, nbits)
    w = words.view(np.uint32).astype(np.uint64)
    b = np.arange(nbits)
    s = (b & 31).astype(np.uint64)
    w01 = (w[(b >> 5) + 1] << np.uint64(32)) | w[b >> 5]
    w2 = w[(b >> 5) + 2]
    win = np.where(s > 0, (w01 >> s) | (w2 << ((np.uint64(64) - s)
                                                % np.uint64(64))), w01)
    ll_attr, d_attr = idv._ll_attr(), idv._d_attr()

    sym, nb, a = _entry((win & np.uint64(0x7FFF)).astype(np.int64), hi_ll,
                        ll[0], ll[2], ll[3], ll_attr, uid, 288)
    lext, lbase = a & 7, (a >> 3) & 511
    ok = (nb > 0) & ((a & (1 << 14)) == 0)
    iseob = (a & (1 << 12)) != 0
    islen = (a & (1 << 13)) != 0
    mlen = lbase + _bits_at(win, nb, lext)
    off2 = nb + lext
    dsym, dnb, da = _entry(_bits_at(win, off2, np.int64(15)), hi_d, d[0],
                           d[2], d[3], d_attr, uid, 32)
    dext, dbase = da & 15, (da >> 4) & 32767
    dok = (dnb > 0) & (dbase > 0)
    mdist = dbase + _bits_at(win, off2 + dnb, dext)
    invalid = ~ok | (islen & ~dok)
    width = np.where(islen, off2 + dnb + dext, nb)
    lit = ok & ~iseob & ~islen
    out = (uid, np.where(invalid | iseob, HUGE, width),
           np.where(lit, 1, np.where(islen & ~invalid, mlen, 0)), sym,
           mdist, lit, islen & ~invalid)
    out = tuple(x.astype(np.int32) for x in out[:5]) + out[5:]
    if not detail:
        return out
    return out, {"ln_past": nb == 0, "dsym": dsym, "dnb": dnb,
                 "iseob": iseob & ok, "len_sym": islen}


def _check(inputs, nbits):
    """Plain version (through the wrapper, on CPU tensors), mirror and
    reference equal on every output; returns the mirror's detail."""
    words, ll, d, start, valid = inputs
    t = torch.from_numpy
    got = kernels.decode_candidates(
        t(words), tuple(map(t, ll)), tuple(map(t, d)), t(start), t(valid),
        nbits)
    mirror, detail = _candidates_mirror(words, ll, d, start, valid, nbits,
                                        detail=True)
    exp = _reference(words, ll, d, start, valid, nbits)
    for name, g, m, e in zip(NAMES, got, mirror, exp):
        want = torch.bool if name.startswith("is") else torch.int32
        assert g.dtype == want and g.shape == (nbits,), name
        np.testing.assert_array_equal(g.numpy(), e, err_msg=name)
        np.testing.assert_array_equal(m, e, err_msg=name)
    return mirror, detail


# ---------------------------------------------------------------------------
# Seeded cases and a real group against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", NBITS)
@pytest.mark.parametrize("case", CANDIDATE_CASES)
def test_candidates_match_reference_on_seeded_cases(case, nbits):
    inputs = candidate_inputs(case, nbits)
    (uid, step, outlen, sym, _mdist, islit, islen), detail = _check(
        inputs, nbits)
    _words, _ll, _d, start, valid = inputs
    live = valid & (start < nbits)
    if case == "random":  # no valid start before bit 100: unit 0's bits
        assert start[live].min() >= 100 and not uid[:100].any()
    if case == "fixed_code":
        assert np.isin(sym[step == HUGE], [286, 287]).any()
    if case == "incomplete_code":
        assert detail["ln_past"].any()
        assert np.isin(detail["dsym"][detail["len_sym"]], [30, 31]).any()
        assert (detail["len_sym"] & (detail["dnb"] == 0)).any()
    if case == "eob_at_end":
        assert detail["iseob"][nbits - 1] and step[nbits - 1] == HUGE
    if case in ("starts", "many_units"):
        assert (start >= nbits).any() and (~valid).any()
    assert (uid == 0).any()
    assert islit.any() and (step == HUGE).any()
    if case != "fixed_code":
        assert islen.any() and (outlen > 1).any()


def _v2(out):
    """The same body behind a legacy v2 'ZZ' subfield (no anchors)."""
    header_len, cb, _t, chunks = containers.parse_gzip_index(out)
    sub = bytearray(struct.pack("<BBII", 2, 0, cb, len(chunks)))
    for seg_bytes, blocks, _anchors in chunks:
        sub += struct.pack("<IH", seg_bytes, len(blocks))
        for bit_off, out_off in blocks:
            sub += struct.pack("<II", bit_off, out_off)
    extra = b"ZZ" + struct.pack("<H", len(sub)) + bytes(sub)
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", len(extra)) + extra + out[header_len:])


def test_candidates_match_reference_on_a_v2_group():
    """The arrays a v2 stream's decode hands decode_candidates: many units
    at 4 KiB chunks; the decode's bytes are the input's."""
    data = mixed_corpus(60000, seed=5)
    blob = _v2(zt.compress(data, level=6, format="gzip", chunk_bytes=4096,
                           indexed=True, device="cpu"))
    seen = []
    orig = kernels.decode_candidates

    def rec(*a):
        seen.append(a)
        return orig(*a)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(kernels, "decode_candidates", rec)
        assert idv.decompress_indexed(blob, device="cpu") == data
    finally:
        mp.undo()
    assert len(seen) == 1
    words, ll, d, start, valid, nbits = seen[0]
    assert int(valid.sum()) > 10
    inputs = (words.numpy(), tuple(t.numpy() for t in ll),
              tuple(t.numpy() for t in d), start.numpy(), valid.numpy())
    _check(inputs, nbits)


# ---------------------------------------------------------------------------
# Wrapper: constants, routing, checks.
# ---------------------------------------------------------------------------


def test_candidate_constants_match_kernels_header():
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "kernels.h").read_text()
    for name in ("THREADS", "BITS"):
        m = re.search(rf"#define ZZ_CAND_{name} (\d+)", src)
        assert int(m.group(1)) == getattr(kernels, f"CAND_{name}")
    assert "candidates.cu" in kernels._SOURCES


def test_decode_all_takes_the_candidates_in_one_call(monkeypatch):
    """_decode_all calls decode_candidates once a group and none of the
    plain chain's pieces; a CPU tensor takes the plain version and counts
    no launch."""
    data = mixed_corpus(20000, seed=3)
    blob = _v2(zt.compress(data, level=6, format="gzip", chunk_bytes=4096,
                           indexed=True, device="cpu"))
    calls = []

    def forbid(*a):
        raise AssertionError("the plain chain ran outside decode_candidates")

    orig = kernels.decode_candidates_plain

    def plain(*a):
        calls.append(a)
        return orig(*a)

    for name in ("_build_luts", "_bit_windows", "_decode_bits"):
        monkeypatch.setattr(idv, name, forbid)
    monkeypatch.setattr(kernels, "decode_candidates_plain", plain)
    before = dict(kernels.launches)
    assert idv.decompress_indexed(blob, device="cpu") == data
    assert len(calls) == 1 and kernels.launches == before


class _OnCard(torch.Tensor):
    """A CPU tensor whose device says cuda: the route a card would take."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(a):
    return torch.Tensor._make_subclass(_OnCard, torch.from_numpy(a.copy()))


def test_cuda_call_without_a_card_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: without a card it
    raises, and the plain version never runs."""
    def no_plain(*a):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kernels, "decode_candidates_plain", no_plain)
    words, ll, d, start, valid = candidate_inputs("one_unit", 1 << 16)
    before = dict(kernels.launches)
    with pytest.raises((RuntimeError, AssertionError)) as err:
        kernels.decode_candidates(
            _on_card(words), tuple(map(_on_card, ll)),
            tuple(map(_on_card, d)), _on_card(start), _on_card(valid),
            1 << 16)
    assert "plain version" not in str(err.value)
    assert kernels.launches == before


def _bad_calls():
    words, ll, d, start, valid = (
        torch.from_numpy(a) if isinstance(a, np.ndarray)
        else tuple(map(torch.from_numpy, a))
        for a in candidate_inputs("one_unit", 1 << 16))
    n = 1 << 16
    call = kernels.decode_candidates
    return {
        "nbits not a multiple of 32": (
            lambda: call(words, ll, d, start, valid, n - 16), ValueError),
        "words too short": (
            lambda: call(words[:-1], ll, d, start, valid, n), ValueError),
        "2-D words": (lambda: call(words.reshape(2, -1), ll, d, start, valid,
                                   n), ValueError),
        "no units": (lambda: call(words, tuple(t[:0] for t in ll),
                                  tuple(t[:0] for t in d), start[:0],
                                  valid[:0], n), ValueError),
        "int32 unit_valid": (
            lambda: call(words, ll, d, start, valid.int(), n), TypeError),
        "short symtab": (lambda: call(words, ll[:3] + (ll[3][:, :287],), d,
                                      start, valid, n), ValueError),
        "rows of another unit count": (
            lambda: call(words, ll, tuple(torch.cat([t, t]) for t in d),
                         start, valid, n), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrapper_rejects_bad_arguments(case):
    call, exc = _bad_calls()[case]
    with pytest.raises(exc):
        call()
