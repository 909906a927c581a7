"""The port's CRC-32 and Adler-32 over row ranges against the JAX package.

``_crc_mirror`` and ``_adler_mirror`` are scalar numpy mirrors of
``zzflate_tpu_torch/csrc/checksum.cu``, in its order: segments of
CKS_SEG bytes a thread, right-aligned to the range's end, staged with
the range mask and CRC's init fold; the per-thread table CRC (or Adler
sums); the warp's shuffle levels and the block's; the second launch's
per-row combine and finish. Change the kernel and its mirror together.
The mirrors and the plain versions (``ops/kernels.crc32_rows_plain``,
``adler32_rows_plain``, which the CPU path runs) are held to the
reference's ``_crc32_impl``/``_adler32_impl``, to their ``jax.vmap``
form, and to stdlib ``zlib``, exactly. The kernels themselves are held
to the plain versions on a card (tests/test_torch_cuda.py,
chip_smoke.py).

The reference's CRC graph compiles ~20 s a shape on the CPU, so it runs
at one padded shape and one vmapped (B, N), the shapes
tests/test_torch_inflate_device.py and tests/test_torch_parallel.py
compile too; every other case is held to zlib, which the reference
equals.
"""
import re
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zzflate_tpu.ops import checksums as rcs
from zzflate_tpu_torch.ops import checksum_math, kernels
from zzflate_tpu_torch.ops import checksums as cs

# The test processes share the CPU; one thread apiece keeps the suite
# inside its time limit (see tests/test_torch_kernels.py).
torch.set_num_threads(1)

SEG, THREADS = kernels.CKS_SEG, kernels.CKS_THREADS
BLOCK = kernels.CKS_BLOCK_BYTES
WARPS = THREADS // 32
LOG_SEG, LOG_WARPS, LOG_BLOCK = 6, 3, 14
MOD = 65521
T = checksum_math.CRC_TABLE.astype(np.int64)
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The mirrors.
# ---------------------------------------------------------------------------


def _shift(v, j):
    """A^(2^j) v by the four byte-table lookups of shift_pow2."""
    t = checksum_math.byte_tables(j)
    return (t[0][v & 0xFF] ^ t[1][(v >> 8) & 0xFF] ^ t[2][(v >> 16) & 0xFF]
            ^ t[3][(v >> 24) & 0xFF])


def _bounds(data, ends, starts):
    """Per-row bounds and nblk as the wrapper sizes the grid."""
    b, n = data.shape
    if isinstance(ends, int):
        span = ends - starts
        ends, starts = np.full(b, ends), np.full(b, starts)
    else:
        span = n
    nblk = max(1, -(-span // BLOCK))
    return np.asarray(ends, np.int64), np.asarray(starts, np.int64), nblk


def _stage(row, vlo, start, end, fold):
    """One block's (THREADS, SEG) staged bytes: zero outside [start, end),
    0xFF XORed into the range's first four bytes with fold."""
    p = vlo + np.arange(BLOCK)
    live = (p >= start) & (p < end)
    x = np.zeros(BLOCK, np.int64)
    x[live] = row[p[live]]
    if fold:
        x = np.where(live & (p < start + 4), x ^ 0xFF, x)
    return x.reshape(THREADS, SEG)


def _shfl_up(c, d):
    """__shfl_up_sync over each warp of the last axis."""
    lane = np.arange(c.shape[-1]) % 32
    idx = np.arange(c.shape[-1])
    src = np.where(lane >= d, idx - d, idx)
    return c[..., src]


def _block_combine(c, log_len):
    """crc_block_combine: the (THREADS,) contributions, thread t's the
    2^log_len bytes left of thread t + 1's, to the block's."""
    lane = np.arange(THREADS) % 32
    for j in range(5):
        sel = ((lane + 1) & ((2 << j) - 1)) == 0
        c = np.where(sel, _shift(_shfl_up(c, 1 << j), log_len + j) ^ c, c)
    w = c[31::32]
    idx = np.arange(WARPS)
    for j in range(LOG_WARPS):
        sel = ((idx + 1) & ((2 << j) - 1)) == 0
        left = w[np.where(idx >= 1 << j, idx - (1 << j), idx)]
        w = np.where(sel, _shift(left, log_len + 5 + j) ^ w, w)
    return int(w[WARPS - 1])


def _crc_mirror(data, ends, starts):
    ends, starts, nblk = _bounds(data, ends, starts)
    out = []
    for r, row in enumerate(data):
        start, end = int(starts[r]), int(ends[r])
        part = []
        for b in range(nblk):  # launch 1
            vlo = end - (nblk - b) * BLOCK
            if vlo + BLOCK <= start:
                part.append(0)
                continue
            x = _stage(row, vlo, start, end, fold=True)
            c = np.zeros(THREADS, np.int64)
            for k in range(SEG):
                c = T[(c ^ x[:, k]) & 0xFF] ^ (c >> 8)
            part.append(_block_combine(c, LOG_SEG))
        log_per = 0  # launch 2
        while THREADS << log_per < nblk:
            log_per += 1
        per, lead = 1 << log_per, (THREADS << log_per) - nblk
        part = np.array(part, np.int64)
        c = np.zeros(THREADS, np.int64)
        for k in range(per):
            v = np.arange(THREADS) * per + k - lead
            x = np.where(v >= 0, part[np.maximum(v, 0)], 0)
            c = _shift(c, LOG_BLOCK) ^ x
        c = _block_combine(c, LOG_BLOCK + log_per)
        fix = 0
        if end - start < 4:
            fix = M32
            for _ in range(end - start):
                fix = int(T[(fix ^ 0xFF) & 0xFF]) ^ (fix >> 8)
        out.append(c ^ fix ^ M32)
    return out


def _adler_mirror(data, ends, starts):
    ends, starts, nblk = _bounds(data, ends, starts)
    weights = SEG - np.arange(SEG)
    out = []
    for r, row in enumerate(data):
        start, end = int(starts[r]), int(ends[r])
        ps, pw = [], []
        for b in range(nblk):  # launch 1
            vlo = end - (nblk - b) * BLOCK
            if vlo + BLOCK <= start:
                ps.append(0)
                pw.append(0)
                continue
            x = _stage(row, vlo, start, end, fold=False)
            s, w = x.sum(1), (x * weights).sum(1)
            assert s.max() < MOD and w.max() < 1 << 20
            gap = (end - (vlo + (np.arange(THREADS) + 1) * SEG)) % MOD
            assert (w + gap * s).max() < 1 << 31
            w = (w + gap * s) % MOD
            ws, ww = s.reshape(WARPS, 32).sum(1), w.reshape(WARPS, 32).sum(1)
            ps.append(int(ws.sum()) % MOD)
            pw.append(int(ww.sum()) % MOD)
        s, w = sum(ps), sum(pw)  # launch 2
        out.append((((end - start) % MOD + w % MOD) % MOD) << 16
                   | (1 + s % MOD) % MOD)
    return out


# ---------------------------------------------------------------------------
# Inputs.
# ---------------------------------------------------------------------------


def _hostile(width, seed):
    """Seeded (B, width) rows and ranges: empty ranges (at 0, inside, at
    N), lengths 1-4 at odd offsets, start > 0 with end < N, a whole row, a
    range across a block edge and one block long exactly."""
    rng = np.random.default_rng(seed)
    n = width
    cases = [(0, 0), (n // 2, n // 2), (n, n), (0, n), (1, n - 1),
             (3, 4), (3, 5), (7, 10), (n - 4, n), (n - 1, n),
             (5, min(n, 5 + BLOCK)), (max(0, n - BLOCK - 3), n - 2)]
    for _ in range(4):
        lo, hi = sorted(int(v) for v in rng.integers(0, n + 1, 2))
        cases.append((lo, hi))
    cases = [(min(max(lo, 0), n), min(max(hi, lo, 0), n)) for lo, hi in cases]
    data = rng.integers(0, 256, (len(cases), n), np.uint8)
    data[1, : n // 3] = 0xFF  # the fold's own byte value
    starts = np.array([c[0] for c in cases], np.int64)
    ends = np.array([c[1] for c in cases], np.int64)
    return data, ends, starts


def _zlib(fn, data, ends, starts):
    return [fn(data[r, starts[r] : ends[r]].tobytes())
            for r in range(len(data))]


def _plain(fn, data, ends, starts):
    return fn(torch.from_numpy(data), torch.from_numpy(ends),
              torch.from_numpy(starts)).tolist()


# ---------------------------------------------------------------------------
# Against the reference (one padded shape, one vmapped shape).
# ---------------------------------------------------------------------------

# The padded shape of tests/test_torch_inflate_device.py's reference CRC.
REF_PAD = 1 << 17
REF_CASES = [(0, 0), (5, 5), (REF_PAD, REF_PAD), (3, 4), (3, 5), (3, 6),
             (3, 7), (0, REF_PAD), (1, REF_PAD - 1), (100, 70000),
             (40000, 40000 + 2 * BLOCK + 17)]


@pytest.fixture(scope="module")
def ref_buf():
    return np.random.default_rng(11).integers(0, 256, REF_PAD, np.uint8)


@pytest.mark.parametrize("kind", ["crc", "adler"])
def test_mirror_and_plain_equal_reference_impl(kind, ref_buf):
    """The reference's _crc32_impl/_adler32_impl on one padded buffer
    equal zlib, the mirror, the plain version and the port's one-row
    entries, on every range."""
    ref = rcs._crc32_impl if kind == "crc" else rcs._adler32_impl
    mirror = _crc_mirror if kind == "crc" else _adler_mirror
    port = cs._crc32_impl if kind == "crc" else cs._adler32_impl
    zfn = zlib.crc32 if kind == "crc" else zlib.adler32
    jd = jnp.asarray(ref_buf)
    t = torch.from_numpy(ref_buf)
    for start, end in REF_CASES:
        exp = int(ref(jd, jnp.int32(end), jnp.int32(start)))
        assert exp == zfn(ref_buf[start:end].tobytes()), (start, end)
        assert mirror(ref_buf[None], end, start) == [exp], (start, end)
        got = port(t, end, start)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == exp, (start, end)


# The vmapped shape of tests/test_torch_parallel.py's reference partials.
VMAP_WIDTH = 32768 + (1 << 18)


def test_mirror_and_plain_equal_vmapped_reference():
    """The reference's vmapped _crc32_impl and _adler32_impl (the
    encoder's per-chunk partials) on six hostile rows."""
    data, ends, starts = _hostile(VMAP_WIDTH, 5)
    data, ends, starts = data[:6], ends[:6], starts[:6]
    jd = jnp.asarray(data)
    je = jnp.asarray(ends.astype(np.int32))
    js = jnp.asarray(starts.astype(np.int32))
    ref_crc = np.asarray(jax.vmap(
        lambda d, e, s: rcs._crc32_impl(d, e, s))(jd, je, js)).tolist()
    ref_adler = np.asarray(jax.vmap(
        lambda d, e, s: rcs._adler32_impl(d, e, s))(jd, je, js)).tolist()
    assert ref_crc == _zlib(zlib.crc32, data, ends, starts)
    assert ref_adler == _zlib(zlib.adler32, data, ends, starts)
    assert _crc_mirror(data, ends, starts) == ref_crc
    assert _adler_mirror(data, ends, starts) == ref_adler
    assert _plain(kernels.crc32_rows_plain, data, ends, starts) == ref_crc
    assert _plain(kernels.adler32_rows_plain, data, ends, starts) == ref_adler


# ---------------------------------------------------------------------------
# Against zlib: hostile batches, odd widths, long rows.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 5, 37197, 2 * BLOCK + 1])
def test_mirrors_and_plain_versions_equal_zlib(width):
    data, ends, starts = _hostile(width, width)
    for mirror, fn, zfn in ((_crc_mirror, cs.crc32_rows, zlib.crc32),
                            (_adler_mirror, cs.adler32_rows, zlib.adler32)):
        want = _zlib(zfn, data, ends, starts)
        assert mirror(data, ends, starts) == want
        got = fn(torch.from_numpy(data), torch.from_numpy(ends),
                 torch.from_numpy(starts))
        assert got.dtype == torch.int64 and got.shape == (len(data),)
        assert got.tolist() == want


def test_empty_rows_and_batches():
    for n in (0, 3):
        data = np.zeros((2, n), np.uint8)
        z = np.zeros(2, np.int64)
        assert _crc_mirror(data, z, z) == [0, 0]
        assert _adler_mirror(data, z, z) == [1, 1]
        assert _plain(cs.crc32_rows, data, z, z) == [0, 0]
        assert _plain(cs.adler32_rows, data, z, z) == [1, 1]
    empty = torch.zeros((0, 7), dtype=torch.uint8)
    none = torch.zeros(0, dtype=torch.int64)
    assert cs.crc32_rows(empty, none, none).shape == (0,)
    assert cs.adler32_rows(empty, none, none).shape == (0,)


def test_long_row_takes_several_partials_a_thread():
    """A row past THREADS blocks (4 MiB): the second launch's threads
    each combine several block partials before the tree."""
    n = THREADS * BLOCK + 3 * BLOCK + 5
    row = np.random.default_rng(9).integers(0, 256, (1, n), np.uint8)
    for start, end in ((0, n), (7, n - 2)):
        want = zlib.crc32(row[0, start:end].tobytes())
        assert _crc_mirror(row, end, start) == [want]
        got = cs._crc32_impl(torch.from_numpy(row[0]), end, start)
        assert int(got) == want
        want = zlib.adler32(row[0, start:end].tobytes())
        assert _adler_mirror(row, end, start) == [want]
        assert int(cs.adler32(torch.from_numpy(row[0]), end, start)) == want


def test_one_range_for_every_row():
    """Two ints for ends and starts: every row takes the same range, the
    grid covers just it."""
    data, _, _ = _hostile(3000, 4)
    ends, starts = np.full(len(data), 2500), np.full(len(data), 17)
    for mirror, fn, zfn in ((_crc_mirror, kernels.crc32_rows, zlib.crc32),
                            (_adler_mirror, kernels.adler32_rows,
                             zlib.adler32)):
        want = _zlib(zfn, data, ends, starts)
        assert mirror(data, 2500, 17) == want
        assert fn(torch.from_numpy(data), 2500, 17).tolist() == want


def test_byte_tables_are_the_shift_matrices():
    rng = np.random.default_rng(2)
    for j in (0, 6, 13, 14, 31):
        for v in rng.integers(0, 1 << 32, 20):
            assert int(_shift(np.int64(v), j)) == checksum_math._mat_apply(
                checksum_math.CRC_POW[j], int(v))


# ---------------------------------------------------------------------------
# The wrappers.
# ---------------------------------------------------------------------------


def test_launch_shape_matches_kernels_header():
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "kernels.h").read_text()
    defs = dict(re.findall(r"#define (ZZ_CKS_\w+) (\d+)\n", src))
    assert defs == {"ZZ_CKS_SEG": str(SEG), "ZZ_CKS_THREADS": str(THREADS)}
    assert "(ZZ_CKS_SEG * ZZ_CKS_THREADS)" in src
    assert BLOCK == 1 << LOG_BLOCK and SEG == 1 << LOG_SEG
    assert WARPS == 1 << LOG_WARPS
    assert "checksum.cu" in kernels._SOURCES


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card, as a CUDA tensor does."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("call", [
    lambda t: kernels.crc32_rows(t, 5, 1),
    lambda t: kernels.adler32_rows(t, torch.tensor([5, 6]),
                                   torch.tensor([0, 1])),
    lambda t: cs.crc32_rows(t, torch.tensor([5, 6]), torch.tensor([0, 1])),
    lambda t: cs.adler32_rows(t, 5, 0),
    lambda t: cs.crc32(t[0]),
    lambda t: cs._crc32_impl(t[0], 6, 2),
    lambda t: cs.adler32(t[0]),
    lambda t: cs._adler32_impl(t[0], 6, 2),
], ids=["crc32_rows", "adler32_rows", "cs.crc32_rows", "cs.adler32_rows",
        "crc32", "_crc32_impl", "adler32", "_adler32_impl"])
def test_cuda_call_without_a_card_raises(call, monkeypatch):
    """A CUDA tensor goes to the kernel or raises: without a card it
    raises, and the plain version never runs."""
    def no_plain(*a):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kernels, "crc32_rows_plain", no_plain)
    monkeypatch.setattr(kernels, "adler32_rows_plain", no_plain)
    t = torch.Tensor._make_subclass(
        _OnCard, torch.arange(16, dtype=torch.uint8).reshape(2, 8))
    before = dict(kernels.launches)
    with pytest.raises((RuntimeError, AssertionError)) as err:
        call(t)
    assert "plain version" not in str(err.value)
    assert kernels.launches == before


@pytest.mark.parametrize("call, exc", [
    (lambda: kernels.crc32_rows(torch.zeros((2, 8)), 1, 0), TypeError),
    (lambda: kernels.crc32_rows(torch.zeros(8, dtype=torch.uint8), 1, 0),
     ValueError),
    (lambda: kernels.adler32_rows(
        torch.zeros((8, 2), dtype=torch.uint8).t(), 1, 0), ValueError),
    (lambda: kernels.crc32_rows(torch.zeros((2, 8), dtype=torch.uint8), 9, 0),
     ValueError),
    (lambda: kernels.adler32_rows(torch.zeros((2, 8), dtype=torch.uint8),
                                  3, 4), ValueError),
    (lambda: kernels.crc32_rows(torch.zeros((2, 8), dtype=torch.uint8),
                                torch.zeros(3, dtype=torch.int32),
                                torch.zeros(3, dtype=torch.int32)),
     ValueError),
], ids=["dtype", "ndim", "contiguity", "end-past-row", "start-past-end",
        "bounds-shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(call, exc):
    with pytest.raises(exc):
        call()
