"""The port on a CUDA card: kernels against their plain versions, and
compress() and device decode on the card against the CPU path, byte for
byte.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither jax nor the JAX package, so it also runs on a machine
without them (tests/conftest.py does import jax; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance is zero: the codec is integer-only and deterministic.
"""
import gzip
import hashlib
import json
import os
import socket
import struct
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest
import torch

import zzflate_tpu_torch as zt
from zzflate_tpu_torch import encode_policy, native
from zzflate_tpu_torch.config import LEVELS
from zzflate_tpu_torch.encode_pipeline import build_chunk_batch
from zzflate_tpu_torch.models import deflate_encoder as enc
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.ops import huffman_host, kernels
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils import lz_tail_bench as tail
from zzflate_tpu_torch.utils.corpus import (
    CANDIDATE_CASES,
    COMMIT_CASES,
    OPTIMAL_CASES,
    OPTIMAL_OVERRIDE_CASES,
    RESOLVE_CASES,
    SCATTER_CASES,
    candidate_inputs,
    commit_walk_inputs,
    mixed_corpus,
    optimal_batch_data,
    optimal_dp_inputs,
    resolve_inputs,
    scatter_inputs,
)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).cuda()


@pytest.mark.parametrize("n", [1000, 12345, 40000])
def test_kernels_match_plain_versions(n):
    _card()
    rng = np.random.default_rng(n)
    b = 3
    adj = _t(rng.integers(0, 65, (b, n)))
    spos = _t(np.stack([rng.permutation(n) for _ in range(b)]))
    ws = _t(rng.integers(0, n // 2, b))
    for k_each, cap, back in ((16, 64, False), (8, 16, True), (1, 16, False)):
        got = kernels.scan_candidates(adj, spos, ws, k_each, cap, back)
        exp = kernels.scan_candidates_plain(adj, spos, ws, k_each, cap, back)
        for g, e in zip(got, exp):
            assert torch.equal(g, e)
    # Lengths up to 400 exercise the 512-wide propagation window.
    mlen = np.where(rng.random((b, n)) < 0.4, rng.integers(3, 401, (b, n)), 0)
    packed = _t(np.where(mlen > 0,
                         (mlen << 15) | (32768 - rng.integers(1, 32769, (b, n))),
                         0))
    assert torch.equal(kernels.propagate_matches(packed),
                       kernels.propagate_matches_plain(packed))
    npad = -(-n // 512) * 512
    step = _t(np.where(rng.random((b, npad)) < 0.3,
                       rng.integers(3, 259, (b, npad)), 1))
    starts = _t(rng.integers(0, npad, b))
    before = kernels.launches["parse_rows"]
    assert torch.equal(kernels.parse_rows(step, starts, 512),
                       kernels.parse_rows_plain(step, starts, 512))
    assert kernels.launches["parse_rows"] == before + 1


def _scan_input(rng, b, n, ws_kind="mid", adj_kind="random", cap=64):
    lo = -cap if adj_kind == "negative" else 0
    adj = (np.full((b, n), cap) if adj_kind == "cap"
           else rng.integers(lo, cap + 8, (b, n)))
    spos = np.stack([rng.permutation(n) for _ in range(b)])
    ws = {"zero": np.zeros(b), "mid": rng.integers(0, n, b),
          "past": np.full(b, n + 7)}[ws_kind]
    return _t(adj), _t(spos), _t(ws)


def _scan_exact(adj, spos, ws, k_each, cap, back):
    before = kernels.launches["scan_candidates"]
    got = kernels.scan_candidates(adj, spos, ws, k_each, cap, back)
    torch.cuda.synchronize()
    assert kernels.launches["scan_candidates"] == before + 1
    exp = kernels.scan_candidates_plain(adj, spos, ws, k_each, cap, back)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.parametrize("backward_only", [False, True],
                         ids=["both", "backward"])
@pytest.mark.parametrize("k_each", [4, 6, 8, 12, 16, 1, 5, 20, 24, 32, 64])
def test_scan_every_k_matches_plain(k_each, backward_only):
    """The compile-time-K instances (4, 6, 8, 12, 16) and the runtime-K
    one (1, 5, 64, and 20, 24, 32: levels 7, 8, 9); n odd (4-byte copies)
    and n a multiple of 4 but not of the tile (16-byte copies, a ragged
    last tile)."""
    _card()
    rng = np.random.default_rng(k_each * 2 + int(backward_only))
    for n in (12345, 40000):
        cap = (16, 32, 64)[n % 3]
        _scan_exact(*_scan_input(rng, 3, n, cap=cap), k_each, cap,
                    backward_only)


# name: (B, n, window_start, adj)
SCAN_CASES = {
    "n-below-2k": (2, 20, "mid", "random"),
    "batch-1": (1, 5000, "mid", "random"),
    "window-start-0": (3, 9000, "zero", "random"),
    "window-start-past-row": (3, 9000, "past", "random"),
    "long-ties-at-cap": (2, 9000, "zero", "cap"),
    "negative-lcp": (2, 9000, "mid", "negative"),
    "main-path-shape": (16, 294912, "mid", "random"),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_edge_cases_match_plain(case):
    _card()
    b, n, ws_kind, adj_kind = SCAN_CASES[case]
    rng = np.random.default_rng(list(SCAN_CASES).index(case))
    inputs = _scan_input(rng, b, n, ws_kind, adj_kind)
    for k_each, cap, back in ((16, 64, False), (8, 16, True), (4, 16, False),
                              (64, 32, False)):
        _scan_exact(*inputs, k_each, cap, back)


def test_scan_misaligned_view_matches_plain():
    """Contiguous rows that start 4 bytes past a 16-byte boundary take the
    4-byte copies and stores."""
    _card()
    rng = np.random.default_rng(11)
    b, n = 2, 4096
    views = []
    for t in _scan_input(rng, b, n)[:2]:
        flat = torch.empty(b * n + 1, dtype=torch.int32, device="cuda")
        v = flat[1:].view(b, n)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16
        views.append(v)
    ws = _t(rng.integers(0, n, b))
    _scan_exact(*views, ws, 16, 64, False)


def _pack(length, dist):
    return (np.asarray(length, np.int64) << 15) | (32768 - np.asarray(dist))


# name: (B, n, lengths), as in test_torch_kernels.py (random lengths reach
# 400 here), plus the main path's shape. Tiles are 4096 positions (8 blocks
# of 512).
PROP_CASES = {
    "n-below-512": (2, 300, "random"),
    "n-512": (1, 512, "random"),
    "tile-minus-1": (2, 4095, "random"),
    "tile-plus-1-rows-differ": (3, 4097, "random"),
    "n-mod-4-is-1": (2, 5001, "random"),
    "all-zero": (2, 1500, "zero"),
    "all-match": (2, 1500, "all"),
    "lengths-1-2": (2, 1500, "short"),
    "ties": (2, 1500, "ties"),
    "window-edge": (2, 1300, "edge"),
    "lengths-to-65535": (2, 9000, "long"),
    "main-path-shape": (16, 294912, "random"),
}


def _prop_case(name):
    b, n, kind = PROP_CASES[name]
    rng = np.random.default_rng(list(PROP_CASES).index(name))
    if kind == "zero":
        return np.zeros((b, n), np.int32)
    if kind == "edge":
        # 514 reaches 511 on as length 3 (kept); 515 would reach 512 on.
        pk = np.zeros((b, n), np.int64)
        pk[0, 100] = _pack(514, 7)
        pk[1, 100] = _pack(515, 9)
        pk[0, 700] = _pack(3, 5)
        return pk.astype(np.int32)
    lo, hi, density = {"random": (3, 401, 0.4), "all": (3, 259, 1.0),
                       "short": (1, 5, 0.6), "ties": (3, 7, 0.7),
                       "long": (3, 65536, 0.05)}[kind]
    length = rng.integers(lo, hi, (b, n))
    if kind == "long":
        length[:, :3] = [65535, 65535, 259]
        length[:, n // 2] = 65535
    keep = rng.random((b, n)) < density
    keep[:, :3] |= kind == "long"
    dist = rng.integers(1, 32769, (b, n))
    return np.where(keep, _pack(length, dist), 0).astype(np.int32)


def _prop_exact(pk):
    before = kernels.launches["propagate_matches"]
    got = kernels.propagate_matches(pk)
    torch.cuda.synchronize()
    assert kernels.launches["propagate_matches"] == before + 1
    assert torch.equal(got, kernels.propagate_matches_plain(pk))
    return got


@pytest.mark.parametrize("case", list(PROP_CASES))
def test_propagate_edge_cases_match_plain(case):
    _card()
    got = _prop_exact(_t(_prop_case(case)))
    if case == "window-edge":
        assert got[0, 100 + 511].item() == _pack(3, 7)
        assert got[1, 100 + 512].item() == 0


def test_propagate_misaligned_view_matches_plain():
    """Contiguous rows that start 4 bytes past a 16-byte boundary take the
    4-byte loads and stores."""
    _card()
    b, n = 2, 9000
    flat = torch.empty(b * n + 1, dtype=torch.int32, device="cuda")
    pk = flat[1:].view(b, n)
    pk.copy_(_t(_prop_case("lengths-to-65535")))
    assert pk.is_contiguous() and pk.data_ptr() % 16
    _prop_exact(pk)


# name: (B, rows per chunk, starts, steps), as in test_torch_kernels.py,
# plus enough 32-row segments for two passes of the marks kernel's map
# staging (32 segment maps a pass).
PARSE_CASES = {
    "start-0": (2, 5, [0, 0], "mixed"),
    "row-boundary": (2, 6, [3 * 512, 512], "mixed"),
    "later-segment-mid-row": (2, 40, [33 * 512 + 300, 39 * 512 + 7], "mixed"),
    "rows-not-multiple-of-32": (2, 37, [100, 31 * 512 + 511], "mixed"),
    "batch-1": (1, 9, [777], "mixed"),
    "all-literal": (2, 5, [5, 0], "literal"),
    "all-258": (2, 5, [0, 1000], "max"),
    "negative-start": (2, 5, [-5, -600], "mixed"),
    "start-past-end": (2, 5, [5 * 512, 5 * 512 + 9], "mixed"),
    "many-segments": (3, 1100, [3 * 512 + 5, 40 * 512 + 400, 1099 * 512],
                      "mixed"),
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parse_rows_edge_cases_match_plain(case):
    _card()
    b, rows, starts, kind = PARSE_CASES[case]
    rng = np.random.default_rng(list(PARSE_CASES).index(case))
    shape = (b, rows * 512)
    if kind == "literal":
        step = np.ones(shape)
    elif kind == "max":
        step = np.full(shape, 258)
    else:
        step = np.where(rng.random(shape) < 0.3,
                        rng.integers(3, 259, shape), 1)
    step, starts = _t(step), _t(starts)
    got = kernels.parse_rows(step, starts, 512)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.parse_rows_plain(step, starts, 512))


@pytest.mark.parametrize("row", [384, 1024])
def test_parse_rows_other_row_widths_match_plain(row):
    """Parts of 48 positions (fewer than a step's reach) and, at 1024,
    both kernels above 48 KB of shared memory."""
    _card()
    rng = np.random.default_rng(row)
    shape = (2, 70 * row)
    step = _t(np.where(rng.random(shape) < 0.3, rng.integers(3, 259, shape),
                       1))
    starts = _t([row * 40 + 100, 5])
    got = kernels.parse_rows(step, starts, row)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.parse_rows_plain(step, starts, row))


def test_parse_rows_rejects_misaligned_step():
    _card()
    flat = torch.ones(2 * 512 + 1, dtype=torch.int32, device="cuda")
    step = flat[1:].view(2, 512)
    with pytest.raises(ValueError):
        kernels.parse_rows(step, _t([0, 0]), 512)


DATA = mixed_corpus(20000, 31)
CASES = {
    "gzip": dict(format="gzip"),
    "raw": dict(format="raw"),
    "dictionary": dict(dictionary=mixed_corpus(6000, 32)[-5000:]),
    "window-bits-9": dict(window_bits=9),
    "filtered": dict(strategy=1),
    "huffman-only": dict(strategy=2),
    "rle": dict(strategy=3),
    "fixed": dict(strategy=4),
    "indexed": dict(format="gzip", indexed=True),
    "seekable": dict(format="gzip", indexed=True, seekable=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("level", [1, 6, 7, 9], ids=["L1", "L6", "L7", "L9"])
def test_compress_on_card_equals_cpu_path(level, case):
    _card()
    kw = CASES[case]
    gpu = zt.compress(DATA, level=level, chunk_bytes=4096, **kw)
    cpu = zt.compress(DATA, level=level, chunk_bytes=4096, device="cpu", **kw)
    assert gpu == cpu


@pytest.mark.parametrize("level, fmt", [(6, "zlib"), (9, "gzip")])
def test_card_output_decodes_with_port_decompress(level, fmt):
    """The card's bytes decode with the port's own host decoder, as with
    stdlib zlib, and an indexed L9 stream reads back by range."""
    _card()
    out = zt.compress(DATA, level=level, format=fmt, chunk_bytes=4096)
    assert zt.decompress(out, format=fmt) == DATA
    assert zlib.decompress(out, wbits=31 if fmt == "gzip" else 15) == DATA
    idx = zt.compress(DATA, level=level, format="gzip", chunk_bytes=4096,
                      indexed=True, seekable=True)
    assert zt.decompress_range(idx, 5000, 7000) == DATA[5000:12000]


def test_full_width_emit_on_card_equals_cpu_path():
    """Incompressible 64 KiB chunks exceed the compact token budget, so
    the batch takes the full-width emit."""
    _card()
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes() + DATA
    gpu = zt.compress(data, level=6, chunk_bytes=1 << 16, format="gzip",
                      indexed=True)
    cpu = zt.compress(data, level=6, chunk_bytes=1 << 16, format="gzip",
                      indexed=True, device="cpu")
    assert gpu == cpu
    assert zlib.decompress(gpu, wbits=31) == data


def test_stream_on_card_equals_cpu_path():
    """The scripted stream (every flush mode, a Z_BLOCK that leaves the
    stream mid-byte, set_params(level=9)) gives the CPU path's bytes on
    every call and the reference's digest, through all three kernels."""
    _card()
    import chip_smoke
    from zzflate_tpu_torch import stream

    data = mixed_corpus(chip_smoke.REF_INPUT_BYTES, chip_smoke.REF_INPUT_SEED)
    kw = dict(level=6, format="gzip", chunk_bytes=4096)
    comp = stream.Compressor(**kw)
    assert comp._device.type == "cuda"
    kernels.reset_launches()
    gpu = chip_smoke.stream_script(comp, data, 4096)
    assert all(kernels.launches[k] > 0 for k in (
        "scan_candidates", "propagate_matches", "parse_rows")), \
        kernels.launches
    cpu = chip_smoke.stream_script(stream.Compressor(device="cpu", **kw),
                                   data, 4096)
    assert gpu == cpu
    assert hashlib.sha256(b"".join(gpu)).hexdigest() == \
        chip_smoke.REF_SHA256_STREAM_4K


def test_facades_and_resume_on_card_equal_cpu_path(tmp_path):
    _card()
    from zzflate_tpu_torch import gzip_compat, zlib_compat
    from zzflate_tpu_torch.utils import resume

    def co_run(**kw):
        co = zlib_compat.compressobj(6, wbits=31, **kw)
        return [co.compress(DATA[:7000]), co.flush(zlib_compat.Z_BLOCK),
                co.compress(DATA[7000:]), co.flush()]

    assert co_run() == co_run(device="cpu")
    assert zlib_compat.compress(DATA, 1) == zlib_compat.compress(
        DATA, 1, device="cpu")
    assert gzip_compat.compress(DATA, 6, mtime=0, engine="device") == \
        gzip_compat.compress(DATA, 6, mtime=0, engine="device", device="cpu")
    for dev in ("cuda", "cpu"):
        resume.compress_to_dir(DATA, str(tmp_path / dev), shard_bytes=8192,
                               chunk_bytes=4096, device=dev)
    assert resume.assemble(str(tmp_path / "cuda")) == \
        resume.assemble(str(tmp_path / "cpu"))


# ---------------------------------------------------------------------------
# Device decode: the anchor walk and decompress(engine="device").
# ---------------------------------------------------------------------------


def _walk_inputs(blob, dev):
    """Every group's anchor_walk arguments, as decompress_indexed on `dev`
    hands them to the kernel wrapper (the wrapper runs as it is)."""
    seen = []
    orig = kernels.anchor_walk

    def rec(words, ll, d, lanes, packed, t_steps):
        seen.append((words, ll, d, lanes, packed.clone(), t_steps))
        return orig(words, ll, d, lanes, packed, t_steps)

    kernels.anchor_walk = rec
    try:
        idv.decompress_indexed(blob, device=dev)
    finally:
        kernels.anchor_walk = orig
    return seen


def _walk_exact(words, ll, d, lanes, packed, t_steps):
    before = kernels.launches["anchor_walk"]
    got = kernels.anchor_walk(words, ll, d, lanes, packed.clone(), t_steps)
    torch.cuda.synchronize()
    assert kernels.launches["anchor_walk"] == before + 1
    exp = kernels.anchor_walk_plain(words, ll, d, lanes, packed.clone(),
                                    t_steps)
    assert torch.equal(got, exp)
    assert not torch.equal(got, packed)


def test_anchor_walk_matches_plain_on_real_inputs():
    _card()
    blob = zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                       indexed=True)
    calls = _walk_inputs(blob, "cuda")
    assert calls and calls[0][0].is_cuda
    for args in calls:
        _walk_exact(*args)


@pytest.mark.parametrize("seed", [0, 1])
def test_anchor_walk_matches_plain_on_seeded_inputs(seed):
    """Real tables, seeded words (half real code, half random: invalid
    windows), lanes at random bits, some past the output's end, some with
    a unit id out of range, some invalid."""
    _card()
    blob = zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                       indexed=True)
    words, ll, d, lanes, packed, t_steps = _walk_inputs(blob, "cuda")[0]
    rng = np.random.default_rng(seed)
    nw = words.shape[0]
    n = 2000
    w = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    w[: nw // 2] = words.cpu().numpy()[: nw // 2]
    npad = packed.shape[0]
    u = ll[0].shape[0]
    lanes = (
        _t(rng.integers(0, 32 * nw, n)),
        _t(np.where(rng.random(n) < 0.2, rng.integers(npad - 50, npad + 500, n),
                    rng.integers(0, npad, n))),
        _t(rng.integers(-2, u + 3, n)),
        _t(rng.random(n) < 0.9),
    )
    _walk_exact(_t(w), ll, d, lanes, packed, t_steps)


def test_anchor_walk_matches_plain_on_foreign_and_shuffled_lanes():
    """Every group of a stdlib gzip stream at FOREIGN_ANCHOR_TOKENS, its
    lanes as planned and shuffled (blocks spanning more units than their
    tables hold: those lanes take the ladder)."""
    _card()
    seen = []
    orig = kernels.anchor_walk

    def rec(words, ll, d, lanes, packed, t_steps):
        seen.append((words, ll, d, lanes, packed.clone(), t_steps))
        return orig(words, ll, d, lanes, packed, t_steps)

    kernels.anchor_walk = rec
    try:
        assert idv.decompress_foreign(gzip.compress(DATA, 6, mtime=0),
                                      format="gzip") == DATA
    finally:
        kernels.anchor_walk = orig
    assert seen and seen[0][5] == idv.FOREIGN_ANCHOR_TOKENS + 2
    for words, ll, d, lanes, packed, t_steps in seen:
        _walk_exact(words, ll, d, lanes, packed, t_steps)
        perm = torch.randperm(lanes[0].shape[0],
                              generator=torch.Generator().manual_seed(0))
        shuffled = tuple(t[perm.cuda()].contiguous() for t in lanes)
        _walk_exact(words, ll, d, shuffled, packed, t_steps)


def test_anchor_walk_matches_plain_on_hostile_trees():
    """The real tables plus the fixed code (litlen 286/287) and an
    incomplete code (windows past the tree, distances 30 and 31), seeded
    words, and lanes at random bits, a fifth of them past the body."""
    _card()
    blob = zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                       indexed=True)
    words, ll, d, lanes, packed, t_steps = _walk_inputs(blob, "cuda")[0]
    ll, d = idv._with_edge_units(ll, d)
    rng = np.random.default_rng(7)
    nw = words.shape[0]
    w = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    w[: nw // 2] = words.cpu().numpy()[: nw // 2]
    n = 3000
    u = ll[0].shape[0]
    far = rng.random(n) < 0.2
    lanes = (
        _t(np.where(far, rng.integers(32 * nw - 40, 32 * nw + 4000, n),
                    rng.integers(0, 32 * nw, n))),
        _t(rng.integers(0, packed.shape[0], n)),
        _t(np.where(rng.random(n) < 0.6, rng.integers(u - 2, u, n),
                    rng.integers(-2, u + 3, n))),
        _t(rng.random(n) < 0.9),
    )
    _walk_exact(_t(w), ll, d, lanes, packed, t_steps)


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


def _raw(data):
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


DECODE_CASES = {
    "indexed": ("gzip", lambda: zt.compress(
        DATA, level=6, format="gzip", chunk_bytes=4096, indexed=True)),
    "indexed-multi-group": ("gzip", lambda: zt.compress(
        DATA, level=6, format="gzip", chunk_bytes=4096, indexed=True)),
    "v2": ("gzip", lambda: _v2(zt.compress(
        DATA, level=6, format="gzip", chunk_bytes=4096, indexed=True))),
    "zlib": ("zlib", lambda: zlib.compress(DATA, 6)),
    "gzip": ("gzip", lambda: gzip.compress(DATA, 6, mtime=0)),
    "raw": ("raw", lambda: _raw(DATA)),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_device_decode_on_card_equals_cpu_path(case, monkeypatch):
    _card()
    fmt, make = DECODE_CASES[case]
    if case == "indexed-multi-group":  # groups of two 4 KiB chunks
        monkeypatch.setattr(idv, "_WGROUP_OUT", 8192)
    blob = make()
    kernels.reset_launches()
    gpu = zt.decompress(blob, format=fmt, engine="device")
    walked = kernels.launches["anchor_walk"]
    cpu = zt.decompress(blob, format=fmt, engine="device", device="cpu")
    assert gpu == cpu == DATA
    assert walked == (0 if case == "v2" else
                      (3 if case == "indexed-multi-group" else 1))
    if fmt == "raw":
        return  # no checksum to catch a flipped byte
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(ValueError):
        zt.decompress(bytes(bad), format=fmt, engine="device")


def test_device_decode_to_device_returns_a_cuda_tensor():
    _card()
    blob = zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                       indexed=True)
    arr, n = idv.decompress_indexed(blob, to_device=True)
    assert arr.is_cuda and arr.dtype == torch.uint8 and n == len(DATA)
    assert torch.equal(arr, torch.frombuffer(bytearray(DATA),
                                             dtype=torch.uint8).cuda())
    arr, n = idv.decompress_foreign(gzip.compress(DATA, 6), format="gzip",
                                    to_device=True)
    assert arr.is_cuda and bytes(arr.cpu().numpy()) == DATA


def test_bgzf_decodes_whole_to_the_card():
    """An 8 MiB BGZF file (129 members of at most 0xff00 input bytes, each
    with its BC subfield, and the 28-byte end marker) decodes to_device on
    the card to gzip.decompress's bytes, every member in one plan; with
    the middle member's CRC-32 flipped it raises."""
    _card()
    data = mixed_corpus(8 << 20, 24)
    members = []
    for o in range(0, len(data), 0xFF00):
        piece = data[o:o + 0xFF00]
        c = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
        body = c.compress(piece) + c.flush()
        members.append(b"\x1f\x8b\x08\x04" + bytes(4) + b"\x00\xff"
                       + struct.pack("<H2sHH", 6, b"BC", 2, len(body) + 25)
                       + body + struct.pack("<II", zlib.crc32(piece),
                                            len(piece)))
    members.append(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"))
    blob = b"".join(members)
    assert len(members) == 130 and gzip.decompress(blob) == data
    kernels.reset_launches()
    arr, n = idv.decompress_foreign(blob, format="gzip", to_device=True)
    assert arr.is_cuda and n == len(data)
    assert bytes(arr.cpu().numpy()) == data
    assert kernels.launches["anchor_walk"] == 3  # groups span members
    off = sum(len(m) for m in members[:65]) - 8
    bad = bytearray(blob)
    bad[off] ^= 0x01
    with pytest.raises(ValueError, match="crc32 mismatch"):
        idv.decompress_foreign(bytes(bad), format="gzip", to_device=True)


def test_zlib_l1_decodes_to_the_card_with_its_adler_there():
    """A 16 MiB zlib stream at level 1, as numcodecs' Zlib() writes Zarr
    chunks, decodes to_device on the card to the input, its Adler-32
    computed there by adler32_rows once a group (no CRC); with the
    trailer's Adler-32 flipped it raises on both paths."""
    _card()
    data = mixed_corpus(16 << 20, 26)
    blob = zlib.compress(data, 1)
    kernels.reset_launches()
    arr, n = idv.decompress_foreign(blob, format="zlib", to_device=True)
    assert arr.is_cuda and n == len(data)
    assert torch.equal(arr, torch.frombuffer(bytearray(data),
                                             dtype=torch.uint8).cuda())
    groups = kernels.launches["anchor_walk"]
    assert groups >= 4 and kernels.launches["adler32_rows"] == groups
    assert kernels.launches["crc32_rows"] == 0
    bad = blob[:-4] + bytes(b ^ 0xFF for b in blob[-4:])
    for to_device in (True, False):
        with pytest.raises(ValueError, match="adler32 mismatch"):
            idv.decompress_foreign(bad, format="zlib", to_device=to_device)


# ---------------------------------------------------------------------------
# commit_walk: the per-bit path's kernel (csrc/commit.cu).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [2 << 16, 4 << 16, 1 << 22],
                         ids=["2RR", "4RR", "group"])
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_walk_matches_plain_on_synthetic_cases(case, nbits):
    """The kernel equals its plain version exactly on every seeded case,
    at the tests' two sizes and at a decode group's 4 194 304 bits, from
    an int32 step and from _decode_bits' int64 one."""
    _card()
    step, start, valid, span = commit_walk_inputs(case, nbits)
    st, sb = _t(step), _t(start)
    uv = torch.from_numpy(valid).cuda()
    exp = kernels.commit_walk_plain(st, sb, uv, span)
    before = kernels.launches["commit_walk"]
    for s in (st, st.long()):
        got = kernels.commit_walk(s, sb, uv, span)
        assert got.dtype == torch.bool and got.is_cuda
        assert torch.equal(got, exp)
    assert kernels.launches["commit_walk"] == before + 2


def test_commit_walk_on_a_misaligned_step_and_int32_valid():
    """A step view off 16-byte alignment is copied once; unit_valid may
    be int32."""
    _card()
    step, start, valid, span = commit_walk_inputs("edges", 2 << 16)
    st = _t(np.r_[0, step])[1:]
    assert st.data_ptr() % 16
    exp = kernels.commit_walk_plain(st, _t(start),
                                    torch.from_numpy(valid).cuda(), span)
    got = kernels.commit_walk(st, _t(start), _t(valid), span)
    assert torch.equal(got, exp)


def test_v2_decode_on_card_runs_the_commit_kernel(monkeypatch):
    """The per-bit path (a v2 index) launches commit_walk once a group
    and equals the CPU path."""
    _card()
    blob = _v2(zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                           indexed=True))
    calls = []
    orig = idv._commit_walk

    def rec(*a):
        calls.append(a)
        return orig(*a)

    monkeypatch.setattr(idv, "_commit_walk", rec)
    kernels.reset_launches()
    assert idv.decompress_indexed(blob) == DATA
    torch.cuda.synchronize()
    assert kernels.launches["commit_walk"] == len(calls) >= 1
    assert kernels.launches["anchor_walk"] == 0
    for a in calls:
        assert torch.equal(kernels.commit_walk(*a),
                           kernels.commit_walk_plain(*a))


# ---------------------------------------------------------------------------
# decode_candidates: the per-bit path's candidate tokens (csrc/candidates.cu).
# ---------------------------------------------------------------------------


def _candidate_args(inputs, nbits):
    words, ll, d, start, valid = inputs
    c = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return (c(words), tuple(map(c, ll)), tuple(map(c, d)), c(start),
            c(valid), nbits)


@pytest.mark.parametrize("nbits", [1 << 16, 1 << 17, 1 << 22],
                         ids=["64K", "128K", "group"])
@pytest.mark.parametrize("case", CANDIDATE_CASES)
def test_decode_candidates_matches_plain_on_seeded_cases(case, nbits):
    """Every output equals the plain version's at every bit, at the CPU
    tests' two sizes and a decode group's 4 194 304 bits; one counted
    launch a call."""
    _card()
    args = _candidate_args(candidate_inputs(case, nbits), nbits)
    before = kernels.launches["decode_candidates"]
    assert tail.check_candidates(kernels, args) == 0
    assert kernels.launches["decode_candidates"] == before + 1


def _v2_candidate_calls(blob, want):
    """Every decode_candidates call of one device decode of a v2 stream
    on the card, whose bytes must be `want`; the launches counted."""
    calls: dict = {}
    kernels.reset_launches()
    undo = tail.recorder(kernels, calls)
    try:
        assert idv.decompress_indexed(blob) == want
    finally:
        undo()
    torch.cuda.synchronize()
    got = calls["decode_candidates"]
    assert kernels.launches["decode_candidates"] == len(got) >= 1
    assert kernels.launches["anchor_walk"] == 0
    return got


def test_decode_candidates_on_a_v2_decode(monkeypatch):
    """A v2 stream decodes on the card through decode_candidates, once a
    group (two groups here), each call equal to the plain version; one
    _decode_all makes at most 100 device launches (the plain chain alone
    made ~440)."""
    _card()
    monkeypatch.setattr(idv, "_GROUP_OUT", 1 << 15)  # 8 chunks a group
    data = mixed_corpus(60000, seed=5)
    blob = _v2(zt.compress(data, level=6, format="gzip", chunk_bytes=4096,
                           indexed=True))
    seen = []
    orig = idv._decode_all

    def rec(*a):
        seen.append(a)
        return orig(*a)

    monkeypatch.setattr(idv, "_decode_all", rec)
    calls = _v2_candidate_calls(blob, data)
    assert len(calls) == len(seen) >= 2
    for a in calls:
        assert tail.check_candidates(kernels, a) == 0
    split = tail.stage_split(torch, idv, kernels, seen[0])
    assert split["candidates_launches"] == 2
    assert split["launches"] <= 100


def test_decode_candidates_at_4k_chunks():
    """Hundreds of units a group: 2 MiB at 4 KiB chunks as a v2 stream."""
    _card()
    data = mixed_corpus(2 << 20, seed=11)
    blob = _v2(zt.compress(data, level=6, format="gzip", chunk_bytes=4096,
                           indexed=True))
    calls = _v2_candidate_calls(blob, data)
    assert max(int(a[4].sum()) for a in calls) >= 200
    for a in calls:
        assert tail.check_candidates(kernels, a) == 0


# ---------------------------------------------------------------------------
# token_scatter and resolve_lz: device decode's LZ tail (csrc/resolve.cu).
# ---------------------------------------------------------------------------


def _cuda(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in arrays)


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_lz_matches_plain_on_seeded_cases(case):
    """Bytes, parents and the doubling rounds equal the plain version's
    (the 2^20 chain takes 21 rounds); each call is one counted launch."""
    _card()
    args = _cuda(resolve_inputs(case, 1 << 21))
    before = kernels.launches["resolve_lz"]
    out = kernels.resolve_lz(*args)
    assert out.dtype == torch.uint8 and out.is_cuda
    err, rounds, e_rounds = tail.check_resolve(kernels, args)
    assert err == 0 and rounds == e_rounds
    if case == "chain_2e20":
        assert rounds == 21
    assert torch.equal(out, kernels.resolve_lz_plain(*args))
    assert kernels.launches["resolve_lz"] == before + 3


@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * (1 << 22) + 5])
def test_resolve_lz_on_ragged_sizes(n):
    """A part tile, and more tiles than one carry chunk of 1 024."""
    _card()
    args = _cuda(resolve_inputs("prefix_and_stored", n))
    err, rounds, e_rounds = tail.check_resolve(kernels, args)
    assert err == 0 and rounds == e_rounds


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_token_scatter_matches_plain_on_seeded_cases(case):
    """From the decoder's arrays (off int64, sym and mdist int32), from
    all int32 and from all int64 ones."""
    _card()
    base, ins = scatter_inputs(case, 1 << 20, 1 << 19)
    args = _cuda(base + ins)
    assert args[7].dtype == args[8].dtype == torch.int32
    before = kernels.launches["token_scatter"]
    assert tail.check_scatter(kernels, args) == 0
    narrow = args[:3] + (args[3].int(),) + args[4:]
    assert tail.check_scatter(kernels, narrow) == 0
    wide = args[:7] + (args[7].long(), args[8].long())
    assert tail.check_scatter(kernels, wide) == 0
    assert kernels.launches["token_scatter"] == before + 3


@pytest.mark.parametrize("case", ["v2", "indexed"])
def test_lz_tail_kernels_on_real_groups(case):
    """Every group's token_scatter (the per-bit path only) and resolve_lz
    launch once and equal their plain versions."""
    _card()
    blob = zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                       indexed=True)
    if case == "v2":
        blob = _v2(blob)
    calls: dict = {}
    kernels.reset_launches()
    undo = tail.recorder(kernels, calls)
    try:
        assert idv.decompress_indexed(blob) == DATA
    finally:
        undo()
    groups = len(calls["resolve_lz"])
    assert groups >= 1
    assert kernels.launches["resolve_lz"] == groups
    assert kernels.launches["token_scatter"] == (groups if case == "v2"
                                                 else 0)
    for a in calls.get("token_scatter", []):
        assert tail.check_scatter(kernels, a) == 0
    for a in calls["resolve_lz"]:
        assert tail.check_resolve(kernels, a)[0] == 0


def test_decode_all_and_the_walk_resolve_make_no_host_sync(monkeypatch):
    """Under set_sync_debug_mode("error") a synchronising call raises."""
    _card()
    blob = zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                       indexed=True)
    seen, calls = [], {}
    orig = idv._decode_all

    def rec(*a):
        seen.append(a)
        return orig(*a)

    monkeypatch.setattr(idv, "_decode_all", rec)
    assert idv.decompress_indexed(_v2(blob)) == DATA
    tail.no_sync(torch, lambda: orig(*seen[0]))
    undo = tail.recorder(kernels, calls)
    try:
        assert idv.decompress_indexed(blob) == DATA
    finally:
        undo()
    a = calls["resolve_lz"][0]
    tail.no_sync(torch, lambda: idv._resolve_lz(*a, a[0].shape[0]))


# ---------------------------------------------------------------------------
# parallel: compress_sharded over a device list, the per-chunk partials
# and compress_multihost across processes.
# ---------------------------------------------------------------------------

MAIN = ("scan_candidates", "propagate_matches", "parse_rows")


def _all_launched(fn):
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in MAIN), kernels.launches
    return out


@pytest.mark.parametrize("layout", ["make_mesh", "cuda0-twice"])
@pytest.mark.parametrize("level, fmt, extra", [
    (6, "gzip", {}), (1, "zlib", {"mem_level": 1}), (9, "raw", {}),
    (6, "gzip", {"indexed": True, "seekable": True}),
], ids=["L6-gzip", "L1-zlib-batches", "L9-raw", "L6-indexed-seekable"])
def test_sharded_on_card_equals_one_card(layout, level, fmt, extra):
    """32 KiB chunks (mem_level=1: one row per device and batch, several
    batches): the mesh's bytes are the one card's."""
    _card()
    from zzflate_tpu_torch.parallel import compress_sharded, make_mesh

    mesh = make_mesh() if layout == "make_mesh" else ["cuda:0", "cuda:0"]
    data = mixed_corpus(6 * 32768 + 77, 21)
    got = _all_launched(lambda: compress_sharded(
        data, level=level, format=fmt, mesh=mesh, chunk_bytes=32768,
        **extra))
    assert got == zt.compress(data, level=level, format=fmt,
                              chunk_bytes=32768, **extra)
    if fmt == "gzip":
        assert gzip.decompress(got) == data
        assert int.from_bytes(got[-8:-4], "little") == zlib.crc32(data)


def test_row_partials_on_card_equal_cpu():
    _card()
    from zzflate_tpu_torch.config import LEVELS
    from zzflate_tpu_torch.encode_pipeline import build_chunk_batch
    from zzflate_tpu_torch.models import deflate_encoder
    from zzflate_tpu_torch.ops import checksums as cs

    rng = np.random.default_rng(3)
    for width in (32768 + (1 << 18), 37197):
        rows = rng.integers(0, 256, (5, width), np.uint8)
        starts = np.array([32768, 32768, 0, 100, 7], np.int64)
        ends = np.array([width, 33000, width, 100, width - 5], np.int64)
        args = (torch.from_numpy(rows), torch.from_numpy(ends),
                torch.from_numpy(starts))
        for fn in (cs.adler32_rows, cs.crc32_rows):
            cpu = fn(*args)
            gpu = fn(*(a.cuda() for a in args))
            assert gpu.is_cuda and torch.equal(gpu.cpu(), cpu)
    data = mixed_corpus(3 * 4096 + 99, 22)
    buf, vends, wstarts, n = build_chunk_batch(data, 4096, b"dict" * 900)
    batch = [torch.as_tensor(a) for a in
             (buf, np.full(n, 32768, np.int32), vends, wstarts)]
    cpu = deflate_encoder.analyze_chunks_batch(*batch, LEVELS[6],
                                               with_checksums=True)
    gpu = deflate_encoder.analyze_chunks_batch(
        *(t.cuda() for t in batch), LEVELS[6], with_checksums=True)
    assert torch.equal(gpu["cks"].cpu(), cpu["cks"])
    assert cpu["cks"][:, 1].tolist() == [
        zlib.crc32(data[i * 4096 : (i + 1) * 4096]) for i in range(n)]


# ---------------------------------------------------------------------------
# crc32_rows and adler32_rows (csrc/checksum.cu): device decode's group
# CRC and the encode's per-chunk partials.
# ---------------------------------------------------------------------------

CKS = ("crc32_rows", "adler32_rows")


def _cks_exact(data, ends, starts):
    """Both checksum kernels equal their plain versions and zlib on one
    input, one launch each."""
    host = data.cpu().numpy()
    b = host.shape[0]
    if isinstance(ends, int):
        e, s = [ends] * b, [starts] * b
    else:
        e, s = ends.cpu().tolist(), starts.cpu().tolist()
    for name, zfn in zip(CKS, (zlib.crc32, zlib.adler32)):
        before = kernels.launches[name]
        got = getattr(kernels, name)(data, ends, starts)
        assert got.is_cuda and got.dtype == torch.int64 and got.shape == (b,)
        assert kernels.launches[name] == before + 1
        exp = getattr(kernels, f"{name}_plain")(data, ends, starts)
        want = [zfn(host[r, s[r] : e[r]].tobytes()) for r in range(b)]
        assert got.tolist() == exp.tolist() == want, name


@pytest.mark.parametrize("width", [1, 37197, 4 * 16384 + 3])
def test_checksum_kernels_equal_plain_and_zlib_on_hostile_rows(width):
    """Empty ranges at 0, inside and at N, lengths 1-4, start > 0 with
    end < N, ranges across a block's edge, odd widths; by (B,) bounds
    (int64 and int32) and by one range every row shares."""
    _card()
    rng = np.random.default_rng(width)
    n, blk = width, kernels.CKS_BLOCK_BYTES
    cases = [(0, 0), (n // 2, n // 2), (n, n), (0, n), (1, n - 1), (3, 4),
             (3, 5), (7, 10), (n - 4, n), (n - 1, n), (5, 5 + blk),
             (n - blk - 3, n - 2)]
    cases += [tuple(sorted(rng.integers(0, n + 1, 2).tolist()))
              for _ in range(4)]
    cases = [(min(max(lo, 0), n), min(max(hi, lo, 0), n)) for lo, hi in cases]
    data = rng.integers(0, 256, (len(cases), n), np.uint8)
    data[1, : n // 3] = 0xFF
    t = torch.from_numpy(data).cuda()
    ends = torch.tensor([c[1] for c in cases], device="cuda")
    starts = torch.tensor([c[0] for c in cases], device="cuda",
                          dtype=torch.int32)
    _cks_exact(t, ends, starts)
    _cks_exact(t, n, n // 3)
    _cks_exact(t[:1], 0, 0)


def test_checksum_kernels_on_a_long_row():
    """A row of more than CKS_THREADS blocks: the second launch's threads
    each combine several block partials."""
    _card()
    n = (kernels.CKS_THREADS + 3) * kernels.CKS_BLOCK_BYTES + 5
    g = torch.Generator(device="cuda").manual_seed(3)
    row = torch.randint(0, 256, (1, n), generator=g, device="cuda",
                        dtype=torch.uint8)
    _cks_exact(row, n, 0)
    _cks_exact(row, n - 2, 7)


@pytest.mark.parametrize("case", ["indexed", "gzip", "gzip-to-device"])
def test_device_decode_checks_every_group_with_the_crc_kernel(case,
                                                              monkeypatch):
    """Every group's CRC runs through crc32_rows (an indexed stream in
    groups of 8 KiB: several; a foreign one in one group, since its
    blocks are longer), and the kernel equals the plain version and zlib
    on each."""
    _card()
    from zzflate_tpu_torch.ops import checksums as cs

    if case == "indexed":
        monkeypatch.setattr(idv, "_WGROUP_OUT", 8192)
    calls = []
    orig = cs._crc32_impl

    def rec(buf, length, start=0):
        calls.append((buf, int(length), int(start)))
        return orig(buf, length, start)

    monkeypatch.setattr(cs, "_crc32_impl", rec)
    kernels.reset_launches()
    if case == "indexed":
        blob = zt.compress(DATA, level=6, format="gzip", chunk_bytes=4096,
                           indexed=True)
        assert zt.decompress(blob, format="gzip", engine="device") == DATA
    elif case == "gzip":
        blob = gzip.compress(DATA, 6, mtime=0)
        assert zt.decompress(blob, format="gzip", engine="device") == DATA
    else:
        arr, n = idv.decompress_foreign(gzip.compress(DATA, 6, mtime=0),
                                        format="gzip", to_device=True)
        assert arr.is_cuda and bytes(arr[:n].cpu().numpy()) == DATA
    torch.cuda.synchronize()
    assert len(calls) >= (2 if case == "indexed" else 1)
    assert kernels.launches["crc32_rows"] == len(calls)
    for buf, end, start in calls:
        assert buf.is_cuda
        _cks_exact(buf[None], end, start)


def test_sharded_encode_partials_go_through_the_checksum_kernels(
        monkeypatch):
    """compress_sharded's per-chunk partials: every batch launches both
    kernels once, each equal to its plain version and zlib, and the
    trailer CRC combined from them is zlib's."""
    _card()
    from zzflate_tpu_torch.ops import checksums as cs
    from zzflate_tpu_torch.parallel import compress_sharded

    calls = []
    for name in CKS:
        def rec(data, ends, starts, orig=getattr(cs, name)):
            calls.append((data, ends, starts))
            return orig(data, ends, starts)

        monkeypatch.setattr(cs, name, rec)
    data = mixed_corpus(6 * 32768 + 77, 21)
    kernels.reset_launches()
    got = compress_sharded(data, level=6, format="gzip",
                           mesh=["cuda:0", "cuda:0"], chunk_bytes=32768,
                           mem_level=1)
    torch.cuda.synchronize()
    assert kernels.launches["crc32_rows"] == kernels.launches["adler32_rows"]
    assert kernels.launches["crc32_rows"] == len(calls) // 2 > 1
    assert gzip.decompress(got) == data
    assert int.from_bytes(got[-8:-4], "little") == zlib.crc32(data)
    for rows, ends, starts in calls[::2]:
        _cks_exact(rows, ends, starts)


# One process of a 2-process run on the card(s): its chunk-aligned range
# of mixed_corpus(nbytes, 2) through compress_multihost on its own card
# (device=None), counts reset just before; prints its launches.
MH_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.parallel import multihost
from zzflate_tpu_torch.utils.corpus import mixed_corpus
port, n, rank, nbytes, out = sys.argv[1:]
n, rank, chunk = int(n), int(rank), 1 << 18
data = mixed_corpus(int(nbytes), 2)
per = -(-len(data) // chunk)
lo, hi = (min(per * r // n * chunk, len(data)) for r in (rank, rank + 1))
multihost.initialize(f"tcp://127.0.0.1:{port}", n, rank)
kernels.reset_launches()
blob = multihost.compress_multihost(data[lo:hi], level=6, format="gzip",
                                    chunk_bytes=chunk)
torch.cuda.synchronize()
if rank == 0:
    with open(out, "wb") as f:
        f.write(blob)
torch.distributed.destroy_process_group()
print(json.dumps(dict(kernels.launches)))
"""


def test_multihost_two_processes_on_card_equal_one_process(tmp_path):
    """Two processes on this box's card(s) over gloo: root's bytes are
    one process's, and every process launched all three matcher kernels
    and both checksum kernels (its partials)."""
    _card()
    kernels.build()  # once here, not in each worker
    nbytes, out = 4 << 20, tmp_path / "out.gz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MH_WORKER, str(port), "2", str(r),
         str(nbytes), str(out)],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    runs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=300)
            runs.append((p.returncode, o, e[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _, _ in runs), runs
    data = mixed_corpus(nbytes, 2)
    blob = out.read_bytes()
    assert blob == zt.compress(data, level=6, format="gzip")
    assert gzip.decompress(blob) == data
    for _, o, _ in runs:
        launched = json.loads(o.strip().splitlines()[-1])
        assert all(launched[k] > 0 for k in MAIN + CKS), launched


# ---------------------------------------------------------------------------
# The level 7-9 optimal parse: optimal_dp and the card's override.
# ---------------------------------------------------------------------------


def _c_dp_rows(choice, args):
    """Each row's choice walked as the C DP walks its own, beside the C
    DP's (committed, take, sel_len)."""
    import chip_smoke

    data, mlen, mdist, starts, ends, lengths, bounds = args
    for j in range(data.shape[0]):
        got = chip_smoke.dp_walk(choice[j], int(starts[j]), int(ends[j]))
        exp = native.optimal_parse(
            data[j], mlen[j], mdist[j], starts[j], ends[j],
            lengths[j, :, :288], lengths[j, :, 288:], bounds)
        yield j, got, exp


@pytest.mark.parametrize("n", [3000, 300000])
@pytest.mark.parametrize("case", OPTIMAL_CASES)
def test_optimal_dp_matches_the_c_dp(case, n):
    """Padded, short and whole rows, ties, absent symbols and lengths past
    a row's end: the kernel's choices walk to the C DP's tokens, and every
    position outside a row's range reads 0. One counted launch a call."""
    _card()
    args = optimal_dp_inputs(case, n=n)
    before = kernels.launches["optimal_dp"]
    choice = kernels.optimal_dp(
        torch.from_numpy(args[0]).cuda(), *_cuda(args[1:])).cpu().numpy()
    assert kernels.launches["optimal_dp"] == before + 1
    for j, got, exp in _c_dp_rows(choice, args):
        assert not choice[j, : max(args[3][j], 0)].any()
        assert not choice[j, args[4][j]:].any()
        for g, e, name in zip(got, exp, ("committed", "take", "sel_len")):
            np.testing.assert_array_equal(g, e, err_msg=f"row {j} {name}")


@pytest.mark.parametrize("chunk", [4096, 1 << 18])
@pytest.mark.parametrize("case", list(OPTIMAL_OVERRIDE_CASES))
def test_optimal_override_on_card_equals_cpu_path(case, chunk):
    """From one analysis on the card of a batch with a zero chunk, a
    periodic one, a short last one and padded rows, the pipeline's entry
    (encode_policy.optimal_parse) runs the card's override, one optimal_dp
    launch, and gives the CPU path's (the C DP on the same matches)
    arrays, re-planned plans and largest token count."""
    _card()
    level, kw = OPTIMAL_OVERRIDE_CASES[case]
    fixed_only = kw.get("strategy") == 4
    rows_n = 8
    buf, vends, wstarts, nchunks = build_chunk_batch(
        optimal_batch_data(chunk), chunk, None)
    pad = rows_n - nchunks
    buf = np.concatenate([buf, np.zeros((pad, buf.shape[1]), np.uint8)])
    vends = np.concatenate([vends, np.full(pad, 32768, np.int32)])
    wstarts = np.concatenate([wstarts, np.full(pad, 32768, np.int32)])
    starts = np.full(rows_n, 32768, np.int32)
    rows = [torch.as_tensor(a).cuda() for a in (buf, starts, vends, wstarts)]
    ana = enc.analyze_chunks_batch(*rows, LEVELS[level], **kw)
    freqs = ana["freqs"].cpu().numpy()

    def pass1():
        return huffman_host.build_batch_plans(
            freqs[..., :288], freqs[..., 288:],
            [int(j == nchunks - 1) for j in range(rows_n)], fixed_only=fixed_only)
    ctx = types.SimpleNamespace(nchunks=nchunks, fixed_only=fixed_only,
                                stream_final=True)
    host = {k: v.cpu() for k, v in ana.items()}
    exp_plans = pass1()
    exp, exp_ntok = encode_policy.optimal_override(
        ctx, exp_plans, host, host["mm_packed"].numpy(), buf, vends, 0)
    before = kernels.launches["optimal_dp"]
    plans = pass1()
    got, ntok = encode_policy.optimal_parse(
        ctx, plans, ana, tuple(rows[:3]), 0)
    assert kernels.launches["optimal_dp"] == before + 1
    assert ntok == exp_ntok
    for k, e in exp.items():
        assert got[k].is_cuda and got[k].dtype == e.dtype, k
        assert torch.equal(got[k].cpu(), e), k
    for p, e in zip(plans, exp_plans):
        for k in e:
            if k == "groups":
                assert p[k] == e[k]
            else:
                np.testing.assert_array_equal(p[k], e[k], err_msg=k)


def test_compress_l9_on_card_runs_the_dp():
    """compress(level=9) on the card gives the CPU path's bytes and the
    reference's digest, through optimal_dp."""
    import chip_smoke

    _card()
    ref_in = mixed_corpus(chip_smoke.REF_INPUT_BYTES,
                          chip_smoke.REF_INPUT_SEED)
    before = kernels.launches["optimal_dp"]
    out = zt.compress(ref_in, level=9, chunk_bytes=4096)
    assert kernels.launches["optimal_dp"] > before
    assert out == zt.compress(ref_in, level=9, chunk_bytes=4096,
                              device="cpu")
    assert hashlib.sha256(out).hexdigest() == chip_smoke.REF_SHA256_L9_4K
    assert zlib.decompress(out) == ref_in
