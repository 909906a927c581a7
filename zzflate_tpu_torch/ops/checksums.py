"""Adler-32 and CRC-32 as data-parallel torch ops, and the host combine
math that stitches partials.

The port's own copy of ``zzflate_tpu/ops/checksums.py``. The host
combines stitch per-shard or per-group partials in order
(``utils/resume``, ``models/inflate_device``, ``parallel``). ``crc32``
and ``adler32`` run on the tensor's own device: device decode verifies
every group's CRC-32 on the card, and only 4 bytes of it come back.
``crc32_rows`` and ``adler32_rows`` give one checksum per row of a
batch, every row at once: the encode's per-chunk partials. Whole-buffer
containers use the stdlib ``zlib`` checksums, the stream layer the C
runtime's.

- CRC-32's byte update factors as A(state) ^ T[b] with A linear over
  GF(2), so the zero-init contribution of a buffer tree-combines as
  c(L||R) = A^len(R) c(L) ^ c(R), with A^(2^j) precomputed.
- Adler-32: for a segment x of length m, S(x) = sum(x) and
  W(x) = sum(x[i] * (m - i)) (mod 65521) combine as S(L||R) = S(L)+S(R),
  W(L||R) = W(L) + len(R) S(L) + W(R).

u32 values are carried as int64 masked to 32 bits: torch's uint32 lacks
shifts and comparisons on the CPU.
"""
from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

ADLER_MOD = 65521
CRC_POLY = 0xEDB88320


def _crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC_POLY if (c & 1) else 0)
        table[i] = c
    return table


CRC_TABLE = _crc_table()


def _crc_shift_matrix() -> np.ndarray:
    """GF(2) matrix of A(s) = (s>>8) ^ T[s & 0xFF] as 32 uint32 columns."""
    cols = np.zeros(32, dtype=np.uint32)
    for k in range(32):
        v = 1 << k
        cols[k] = (v >> 8) ^ int(CRC_TABLE[v & 0xFF])
    return cols


def _mat_apply(cols: np.ndarray, v: int) -> int:
    out = 0
    for k in range(32):
        if (v >> k) & 1:
            out ^= int(cols[k])
    return out


def _mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose GF(2) matrices (column form): result = a @ b."""
    out = np.zeros(32, dtype=np.uint32)
    for k in range(32):
        out[k] = _mat_apply(a, int(b[k]))
    return out


def _mat_inv(a: np.ndarray) -> np.ndarray:
    """Invert a GF(2) 32x32 matrix given as uint32 columns (Gauss-Jordan)."""
    m = [[(int(a[c]) >> r) & 1 for c in range(32)] for r in range(32)]
    inv = [[1 if r == c else 0 for c in range(32)] for r in range(32)]
    for col in range(32):
        piv = next(r for r in range(col, 32) if m[r][col])
        m[col], m[piv] = m[piv], m[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for r in range(32):
            if r != col and m[r][col]:
                m[r] = [x ^ y for x, y in zip(m[r], m[col])]
                inv[r] = [x ^ y for x, y in zip(inv[r], inv[col])]
    cols = np.zeros(32, dtype=np.uint32)
    for c in range(32):
        v = 0
        for r in range(32):
            v |= inv[r][c] << r
        cols[c] = v
    return cols


_MAX_LOG = 40  # supports lengths up to 2^40 bytes


def _pow_matrices() -> tuple[np.ndarray, np.ndarray]:
    """A^(2^j) and A^(-2^j) for j in [0, _MAX_LOG), as (J, 32) uint32."""
    fwd = np.zeros((_MAX_LOG, 32), dtype=np.uint32)
    fwd[0] = _crc_shift_matrix()
    for j in range(1, _MAX_LOG):
        fwd[j] = _mat_mul(fwd[j - 1], fwd[j - 1])
    bwd = np.zeros((_MAX_LOG, 32), dtype=np.uint32)
    bwd[0] = _mat_inv(fwd[0])
    for j in range(1, _MAX_LOG):
        bwd[j] = _mat_mul(bwd[j - 1], bwd[j - 1])
    return fwd, bwd


CRC_POW, CRC_POW_INV = _pow_matrices()


def crc32_shift(crc: int, nbytes: int) -> int:
    """Apply A^nbytes to a zero-init CRC state."""
    out = crc
    j = 0
    while nbytes:
        if nbytes & 1:
            out = _mat_apply(CRC_POW[j], out)
        nbytes >>= 1
        j += 1
    return out


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(A||B) from crc32(A), crc32(B), len(B) (zlib.h:1752 contract)."""
    return crc32_shift(crc1, len2) ^ crc2


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32(A||B) from the two adlers and len(B) (zlib.h:1716 contract).

    s1(AB) = s1(A) + s1(B) - 1;  s2(AB) = s2(A) + s2(B) + len(B)*(s1(A)-1).
    """
    m = ADLER_MOD
    rem = len2 % m
    s1a, s2a = adler1 & 0xFFFF, (adler1 >> 16) & 0xFFFF
    s1b, s2b = adler2 & 0xFFFF, (adler2 >> 16) & 0xFFFF
    s1 = (s1a + s1b - 1) % m
    s2 = (s2a + s2b + rem * (s1a - 1)) % m
    return (s2 << 16) | s1


# ---------------------------------------------------------------------------
# Device checksums (torch, on the data's device).
# ---------------------------------------------------------------------------

_BLOCK = 1024  # level-0 block of the Adler tree; keeps the partials small
_M32 = 0xFFFFFFFF


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.cache
def _byte_tables(which: str, j: int) -> np.ndarray:
    """(4, 256) int64: entry [k, b] = M(b << 8k) for M = A^(2^j) ('fwd')
    or A^(-2^j) ('inv'), so M(v) is the XOR of four lookups."""
    cols = (CRC_POW if which == "fwd" else CRC_POW_INV)[j]
    out = np.zeros((4, 256), np.int64)
    for k in range(4):
        for b in range(256):
            out[k, b] = _mat_apply(cols, b << (8 * k))
    return out


def _gf_matvec_batch(tables: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2) 32x32 matrix to a batch of u32 (int64) values.

    The reference XORs the 32 columns selected by v's bits (128
    elementwise steps); the map is linear, so it equals the XOR of its
    images of v's four bytes, looked up in the matrix's (4, 256) byte
    tables (``_byte_tables``): 4 gathers."""
    out = tables[0][v & 0xFF]
    for k in range(1, 4):
        out = out ^ tables[k][(v >> (8 * k)) & 0xFF]
    return out


@functools.cache
def _tables_on(which: str, j: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_byte_tables(which, j)).to(device)


@functools.cache
def _crc_table_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(CRC_TABLE.astype(np.int64)).to(device)


def _crc_tree(c: torch.Tensor) -> torch.Tensor:
    """Tree-combine per-byte CRC contributions along the last axis:
    c(L||R) = A^len(R) c(L) ^ c(R), with len(R) = 2^j at level j. An odd
    level prepends an all-zero segment on the left, where leading zeros
    are transparent to the zero-init contribution, so the result is the
    contribution of the whole width for any width."""
    dev = c.device
    level = 0
    while c.shape[-1] > 1:
        if c.shape[-1] % 2:
            c = torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c], dim=-1)
        c = (_gf_matvec_batch(_tables_on("fwd", level, dev), c[..., 0::2])
             ^ c[..., 1::2])
        level += 1
    return c[..., 0]


def _crc32_impl(data: torch.Tensor, length: int, start: int = 0):
    """CRC-32 of data[start:length]; data is uint8 (a power-of-two size
    keeps the tree's levels even).

    Leading zeros are transparent to the zero-init contribution (T[0]==0
    and A(0)==0); only the init fold needs the true length. The length
    and start are host integers, so the right-padding correction applies
    A^(-2^j) only for the set bits of the pad, and the init fold
    A^len(0xFFFFFFFF) is a host constant: the values are the reference's,
    which selects with a where() on every bit."""
    dev = data.device
    idx = torch.arange(data.shape[0], device=dev)
    x = torch.where((idx >= start) & (idx < length), data.long(), 0)
    c_true = _crc_tree(_crc_table_on(dev)[x])
    pad = (data.shape[0] - length) & _M32
    for j in range(_MAX_LOG):
        if (pad >> j) & 1:
            c_true = _gf_matvec_batch(_tables_on("inv", j, dev), c_true)
    init = crc32_shift(_M32, (length - start) & _M32)
    return c_true ^ (init ^ _M32)


def crc32(data: torch.Tensor, length: int | None = None, start: int = 0):
    """CRC-32 (zlib/gzip polynomial) of data[start:length] (a uint8
    tensor), on the data's device. Returns a 0-d int64 tensor there."""
    data = torch.as_tensor(data, dtype=torch.uint8)
    n = data.shape[0]
    if length is None:
        length = n
    n_pad = max(1, _ceil_pow2(n))
    if n_pad != n:
        data = torch.cat([data, data.new_zeros(n_pad - n)])
    return _crc32_impl(data, int(length), int(start))


def _adler_tree(x: torch.Tensor, block: int):
    """S/W partials of (..., n_pad) int64 bytes, n_pad a multiple of
    block, tree-combined along the last axis. At each level pairs of
    equal-length segments merge; odd levels append an implicit all-zero
    segment, so the effective padded length `seg` grows past n_pad and
    the caller's right-padding correction uses it. Returns (S, W_pad,
    seg), S and W mod 65521."""
    m = ADLER_MOD
    x = x.reshape(x.shape[:-1] + (-1, block))
    weights = block - torch.arange(block, device=x.device)
    s = x.sum(-1) % m
    w = (x * weights).sum(-1) % m
    seg = block
    while s.shape[-1] > 1:
        if s.shape[-1] % 2:
            zero = s.new_zeros(s.shape[:-1] + (1,))
            s = torch.cat([s, zero], dim=-1)
            w = torch.cat([w, zero], dim=-1)
        sl, sr = s[..., 0::2], s[..., 1::2]
        wl, wr = w[..., 0::2], w[..., 1::2]
        w = (wl + (((seg % m) * sl) % m) + wr) % m
        s = (sl + sr) % m
        seg *= 2
    return s[..., 0], w[..., 0], seg


def _adler_finish(s_total, w_pad, seg: int, length, start):
    """Adler-32 from the tree's partials: right-padding correction
    (padded zero bytes inflate every weight by seg - length, so W_true =
    W_pad - pad*S mod m) and the n term. length and start are host ints
    or (B,) int64 tensors."""
    m = ADLER_MOD
    pad = ((seg - length) & _M32) % m
    w_true = (w_pad + ((m - pad) % m) * s_total % m) % m
    n_mod = ((length - start) & _M32) % m
    s1 = (1 + s_total) % m
    s2 = (n_mod + w_true) % m
    return (s2 << 16) | s1


def _adler32_impl(data: torch.Tensor, length: int, start: int = 0,
                  block: int = _BLOCK):
    """Adler-32 of data[start:length]; data is uint8, a multiple of block.

    Leading zeros are transparent to the S/W partials (x=0 contributes
    nothing, and W's weight (length - i) equals the in-chunk weight), so
    only the final n term needs the true chunk length."""
    assert data.shape[0] % block == 0
    idx = torch.arange(data.shape[0], device=data.device)
    x = torch.where((idx >= start) & (idx < length), data.long(), 0)
    s_total, w_pad, seg = _adler_tree(x, block)
    return _adler_finish(s_total, w_pad, seg, length, start)


def adler32(data: torch.Tensor, length: int | None = None, start: int = 0):
    """Adler-32 of data[start:length] (a uint8 tensor), on the data's
    device. Returns a 0-d int64 tensor there."""
    data = torch.as_tensor(data, dtype=torch.uint8)
    n = data.shape[0]
    if length is None:
        length = n
    n_pad = max(_BLOCK, -(-n // _BLOCK) * _BLOCK)
    if n_pad != n:
        data = torch.cat([data, data.new_zeros(n_pad - n)])
    return _adler32_impl(data, int(length), int(start))


# ---------------------------------------------------------------------------
# Per-row partials: one checksum per row of a (B, N) batch, every row at
# once (the reference's _adler32_impl/_crc32_impl under jax.vmap).
# ---------------------------------------------------------------------------


def _row_window(data: torch.Tensor, ends, starts):
    """(B, N) uint8 and per-row [start, end) -> int64 bytes with the rest
    zeroed, and the bounds as (B,) int64 on the data's device."""
    dev = data.device
    ends = torch.as_tensor(ends, device=dev).long()
    starts = torch.as_tensor(starts, device=dev).long()
    idx = torch.arange(data.shape[1], device=dev)[None, :]
    keep = (idx >= starts[:, None]) & (idx < ends[:, None])
    return torch.where(keep, data.long(), 0), ends, starts


@functools.cache
def _short_init_on(device: torch.device) -> torch.Tensor:
    """(5,) int64: for a range of L < 4 bytes, what its init fold
    A^L(0xFFFFFFFF) differs by from the zero-init contribution of 0xFF
    in its first L bytes (crc32(b"\xff" * L) ^ 0xFFFFFFFF); 0 for L >= 4,
    where the two are equal."""
    vals = [zlib.crc32(b"\xff" * k) ^ _M32 for k in range(4)] + [0]
    return torch.tensor(vals, dtype=torch.int64, device=device)


def crc32_rows(data: torch.Tensor, ends, starts) -> torch.Tensor:
    """CRC-32 of data[b, starts[b]:ends[b]] for every row b of a (B, N)
    uint8 tensor (0 <= start <= end <= N; any N), on the data's device.
    Returns (B,) int64 holding u32 values; an empty range gives 0.

    Each row is shifted so its range ends at the last column: the tree's
    zero padding is all on the left, where it is transparent, so no row
    needs the reference's per-bit right-padding correction. The init
    0xFFFFFFFF contributes A^len(0xFFFFFFFF), which equals 0xFF XORed
    into the range's first 4 bytes (for len >= 4; shorter ranges take a
    constant from a table): no per-bit init fold either."""
    bch, n = data.shape
    if n == 0:
        data = data.new_zeros((bch, 1))
        n = 1
    x, ends, starts = _row_window(data, ends, starts)
    idx = torch.arange(n, device=x.device)[None, :]
    head = torch.minimum(starts + 4, ends)[:, None]
    x = torch.where((idx >= starts[:, None]) & (idx < head), x ^ 0xFF, x)
    src = idx - (n - ends)[:, None]
    x = torch.where(src >= 0, x.gather(1, src.clamp(min=0)), 0)
    c = _crc_tree(_crc_table_on(x.device)[x])
    short = _short_init_on(x.device)[(ends - starts).clamp(max=4)]
    return c ^ short ^ _M32


def adler32_rows(data: torch.Tensor, ends, starts) -> torch.Tensor:
    """Adler-32 of data[b, starts[b]:ends[b]] for every row b of a (B, N)
    uint8 tensor (0 <= start <= end <= N), on the data's device. Returns
    (B,) int64 holding u32 values; an empty range gives 1."""
    bch, n = data.shape
    n_pad = max(_BLOCK, -(-n // _BLOCK) * _BLOCK)
    if n_pad != n:
        data = torch.cat([data, data.new_zeros((bch, n_pad - n))], dim=1)
    x, ends, starts = _row_window(data, ends, starts)
    s_total, w_pad, seg = _adler_tree(x, _BLOCK)
    return _adler_finish(s_total, w_pad, seg, ends, starts)
