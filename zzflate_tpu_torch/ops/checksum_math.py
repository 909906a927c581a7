"""Host math of Adler-32 and CRC-32: the CRC byte table, the GF(2) shift
matrices A^(2^j) and their byte tables, and the zlib combine contracts.

Shared by ``ops/checksums`` (the public entries, which re-export the
combines) and ``ops/kernels`` (the plain versions and the tables the
CUDA kernels read), so neither imports the other's device code.

CRC-32's byte update factors as A(state) ^ T[b] with A linear over GF(2),
so the zero-init contribution of a buffer combines as
c(L||R) = A^len(R) c(L) ^ c(R), with A^(2^j) precomputed.
"""
from __future__ import annotations

import functools

import numpy as np

ADLER_MOD = 65521
CRC_POLY = 0xEDB88320
_M32 = 0xFFFFFFFF


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


_MAX_LOG = 40  # supports lengths up to 2^40 bytes


def _pow_matrices() -> np.ndarray:
    """A^(2^j) for j in [0, _MAX_LOG), as (J, 32) uint32."""
    fwd = np.zeros((_MAX_LOG, 32), dtype=np.uint32)
    fwd[0] = _crc_shift_matrix()
    for j in range(1, _MAX_LOG):
        fwd[j] = _mat_mul(fwd[j - 1], fwd[j - 1])
    return fwd


CRC_POW = _pow_matrices()


@functools.cache
def byte_tables(j: int) -> np.ndarray:
    """(4, 256) int64: entry [k, b] = A^(2^j)(b << 8k), so A^(2^j)(v) is
    the XOR of the entries of v's four bytes."""
    cols = CRC_POW[j].astype(np.int64)
    b = np.arange(256, dtype=np.int64)
    out = np.zeros((4, 256), np.int64)
    for k in range(4):
        for i in range(8):
            out[k] ^= np.where((b >> i) & 1, cols[8 * k + i], 0)
    return out


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
