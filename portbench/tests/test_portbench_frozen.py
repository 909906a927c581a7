"""The benchmark's frozen copies equal the originals they were copied
from, while those exist: the corpus (``zzflate_tpu_torch.utils.corpus``),
the level table (``zzflate_tpu_torch.config``) and the bytes and
operations arithmetic (``chip_smoke.py``, ``utils/lz_tail_bench.py``).
An original that a later change deletes skips its comparison; the copy
stays as it is."""
import importlib

import pytest
import torch

from portbench import bounds
from portbench.data import mixed


def _original(name: str):
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError:
        pytest.skip(f"{name} is gone; the frozen copy stands alone")


@pytest.mark.parametrize("nbytes", [0, 1, 2, 3, 100, 4097, 65536 + 7])
@pytest.mark.parametrize("seed", [0, 5, [2**40 + 3, 1]])
def test_corpus_equals_original(nbytes, seed):
    orig = _original("zzflate_tpu_torch.utils.corpus")
    assert mixed.make(nbytes, seed) == orig.mixed_corpus(nbytes, seed)


def test_level_candidates_equal_config():
    config = _original("zzflate_tpu_torch.config")
    assert bounds.LEVEL_CANDIDATES == {
        lv: p.candidates for lv, p in config.LEVELS.items()}
    assert bounds.WINDOW == 32768


def test_peaks_and_constants_equal_originals():
    cs = _original("chip_smoke")
    lz = _original("zzflate_tpu_torch.utils.lz_tail_bench")
    for mod in (cs, lz):
        assert bounds.HBM_BYTES_PER_S == mod.HBM_BYTES_PER_S
        assert bounds.INT_OPS_PER_S == mod.INT_OPS_PER_S
    assert (bounds.WALK_OPS_LITERAL, bounds.WALK_OPS_MATCH) == (
        cs.WALK_OPS_LITERAL, cs.WALK_OPS_MATCH)
    assert (bounds.COMMIT_OPS_BIT, bounds.COMMIT_OPS_MARK) == (
        cs.COMMIT_OPS_BIT, cs.COMMIT_OPS_MARK)
    assert bounds.CKS_OPS_PER_BYTE == cs.CKS_OPS_PER_BYTE
    assert (bounds.CAND_BYTES_BIT, bounds.CAND_OPS_BIT,
            bounds.CAND_OPS_ENTRY) == (lz.CAND_BYTES_BIT, lz.CAND_OPS_BIT,
                                       lz.CAND_OPS_ENTRY)


def _least(work):
    return bounds.least_ms(*work)


@pytest.mark.parametrize("rows,n,k,back", [(1, 4096, 8, True),
                                           (3, 5000, 16, False),
                                           (2, 294912, 32, False)])
def test_scan_and_propagate_equal_chip_smoke(rows, n, k, back):
    cs = _original("chip_smoke")
    adj = torch.zeros((rows, n), dtype=torch.int32)
    ws = torch.zeros((rows,), dtype=torch.int32)
    got = cs.bound(None, "scan_candidates", (adj, adj, ws, k, 0, back))
    assert (_least(bounds.scan_work(rows, n, k, back)) == got[:2])
    got = cs.bound(None, "propagate_matches", (adj,))
    assert _least(bounds.propagate_work(rows, n)) == got[:2]


def test_parse_equals_chip_smoke():
    cs = _original("chip_smoke")
    from zzflate_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(3)
    rows, n = 3, 4 * 512
    step = torch.randint(1, 20, (rows, n), generator=g, dtype=torch.int32)
    starts = torch.tensor([0, 7, 300], dtype=torch.int32)
    committed = int(kernels.parse_rows(step, starts, 512).sum().item())
    got = cs.bound(kernels, "parse_rows", (step, starts, 512))
    assert _least(bounds.parse_work(rows, n, committed)) == got[:2]


def test_walk_commit_checksum_equal_chip_smoke():
    cs = _original("chip_smoke")
    g = torch.Generator().manual_seed(4)
    words = torch.zeros(64, dtype=torch.int32)
    words[:40] = 7
    tabs = [torch.zeros(9, dtype=torch.int32) for _ in range(3)]
    lanes = [torch.tensor([1, 0, 2, 5], dtype=torch.int32)] * 4
    packed0 = torch.zeros(100, dtype=torch.int64)
    after = packed0.clone()
    after[:30] = 1
    after[10:14] = 1 | (5 << 9)
    got = cs.walk_bound((words, tabs[:2], tabs[2:], lanes, packed0, 9), after)
    table_bytes = sum(t.numel() * 4 for t in tabs + lanes)
    work = bounds.walk_work(40 * 4, 30, table_bytes, 26, 4)
    assert _least(work) == (got["bound_ms"], got["bound_by"])

    step = torch.randint(1, 48, (4096,), generator=g, dtype=torch.int32)
    start = torch.tensor([0, 9], dtype=torch.int32)
    valid = torch.tensor([True, True])
    mark = torch.randint(0, 2, (4096,), generator=g, dtype=torch.uint8)

    class _K:
        COMMIT_ROW = 256

    got = cs.commit_bound(_K, (step, start, valid, 1), mark)
    work = bounds.commit_work(4096, 2, int(mark.sum()))
    assert _least(work) == (got["bound_ms"], got["bound_by"])

    data = torch.zeros((3, 1000), dtype=torch.uint8)
    for name in ("crc32_rows", "adler32_rows"):
        got = cs.cks_bound(name, data, 900, 100)
        assert _least(bounds.checksum_work(name, 3 * 800, 3, False)) == got[:2]
        ends = torch.tensor([900, 1000, 10], dtype=torch.int32)
        starts = torch.tensor([100, 0, 10], dtype=torch.int32)
        got = cs.cks_bound(name, data, ends, starts)
        assert _least(bounds.checksum_work(name, 1800, 3)) == got[:2]


def test_decode_kernels_equal_lz_tail_bench():
    lz = _original("zzflate_tpu_torch.utils.lz_tail_bench")
    for nbits, units in [(1 << 16, 3), (1 << 22, 7)]:
        got = lz.candidates_bound(nbits, units)
        assert _least(bounds.candidates_work(nbits, units)) == (
            got["bound_ms"], got["bound_by"])
    got = lz.resolve_bound(4096, 11)
    assert _least(bounds.resolve_work(4096))[0] == got["bound_ms"]

    g = torch.Generator().manual_seed(5)
    nbits, n = 2048, 1500
    off = torch.randint(-10, n + 10, (nbits,), generator=g)
    committed = torch.rand(nbits, generator=g) < 0.3
    islit = torch.rand(nbits, generator=g) < 0.5
    islen = ~islit & (torch.rand(nbits, generator=g) < 0.8)
    args = (torch.zeros(n), None, None, off, committed, islit, islen)
    got = lz.scatter_bound(args)
    lit, ln = committed & islit, committed & islen
    tok = lit | ln
    kept = tok & (off >= 0) & (off < n)
    work = bounds.scatter_work(nbits, int(committed.sum()), int(tok.sum()),
                               int(lit.sum()), int(ln.sum()), int(kept.sum()))
    assert _least(work)[0] == got["bound_ms"]


def test_cell_level_bounds_from_shapes():
    """The encoder's bound over 8 MiB at L6 is two batches of the per-batch
    bound that PERF's kernel table gives (72.2 us); the decoder's counts
    each body bit and output byte once."""
    fam = bounds.encode_families(6, 8 << 20, 262144)
    assert set(fam) == {"scan", "propagate", "parse"}
    assert sum(fam.values()) == pytest.approx(2 * 0.0722, rel=1e-2)
    fam = bounds.decode_families(8 * 1000, 4000)
    assert fam["resolve"] == 4000 * 13 / bounds.HBM_BYTES_PER_S * 1e3
    assert fam["candidates"] == 8000 * 22 / bounds.HBM_BYTES_PER_S * 1e3
