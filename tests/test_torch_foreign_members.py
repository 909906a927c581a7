"""Device decode of gzip files of many members, through
``inflate_device.decompress_foreign(..., format="gzip")`` on the CPU:
BGZF files (SAMv1 §4.1: members of at most 0xff00 input bytes, each with
a ``BC`` FEXTRA subfield holding BSIZE, and a 28-byte empty member at the
end), ``cat``-ed stdlib members at several levels with an all-stored one
among them, headers with every optional field, and a file that is only
the BGZF end marker.

The walk groups are shrunk so that groups span members. The plain
reference is the standard library's ``gzip.decompress``; the member scan
is held to ``native.scan_anchors`` run on each member's body alone."""
import gzip
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import zzflate_tpu_torch as zt
from zzflate_tpu_torch import native
from zzflate_tpu_torch.models import inflate
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.ops.checksum_math import crc32_combine
from zzflate_tpu_torch.utils import profiling
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# One thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

GROUP_OUT = 1 << 17  # two BGZF members a group
GROUP_BODY = 1 << 16
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BGZF_BLOCK = 0xFF00  # input bytes a BGZF member holds at most


def _bgzf(data: bytes, level: int = 6, block: int = BGZF_BLOCK,
          before: bytes = b"", plain: tuple = ()) -> bytes:
    """data as bgzip writes it: raw deflate members of `block` input
    bytes, each header with FEXTRA's BC subfield (BSIZE = member length -
    1) after the subfields `before`, then the end marker. The members
    numbered in `plain` carry `before` alone."""
    out = []
    for k, o in enumerate(range(0, len(data), block)):
        piece = data[o:o + block]
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
        body = c.compress(piece) + c.flush()
        extra = before
        if k not in plain:
            extra += struct.pack("<BBHH", 66, 67, 2,
                                 len(body) + len(before) + 25)
        out.append(b"\x1f\x8b\x08\x04" + bytes(4) + b"\x00\xff"
                   + struct.pack("<H", len(extra)) + extra
                   + body + struct.pack("<II", zlib.crc32(piece),
                                        len(piece)))
    return b"".join(out) + BGZF_EOF


def _flagged(data: bytes) -> bytes:
    """A member with FEXTRA, FNAME, FCOMMENT and FHCRC set."""
    head = (b"\x1f\x8b\x08\x1e" + bytes(4) + b"\x00\x03"
            + struct.pack("<H", 8) + b"XY\x04\x00abcd"
            + b"shard.vcf\x00" + b"a comment\x00")
    head += struct.pack("<H", zlib.crc32(head) & 0xFFFF)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return (head + c.compress(data) + c.flush()
            + struct.pack("<II", zlib.crc32(data), len(data)))


def _cat(data: bytes) -> bytes:
    """Stdlib members at L1, L6, L0 (all stored) and L9, one after
    another."""
    cuts = np.linspace(0, len(data), 5).astype(int)
    return b"".join(gzip.compress(data[a:b], lvl, mtime=0)
                    for (a, b), lvl in zip(zip(cuts[:-1], cuts[1:]),
                                           (1, 6, 0, 9)))


DATA = mixed_corpus(300000, 24)
SMALL = mixed_corpus(60000, 25)
FILES = {
    "bgzf": lambda: _bgzf(DATA),
    "cat": lambda: _cat(DATA),
    "flags": lambda: _flagged(SMALL[:30000]) + _flagged(SMALL[30000:]),
    "eof_only": lambda: BGZF_EOF,
}


@pytest.fixture
def groups(monkeypatch):
    """Shrinks the walk groups; yields the list of each walk's output
    length, one entry a group."""
    monkeypatch.setattr(idv, "_WGROUP_OUT", GROUP_OUT)
    monkeypatch.setattr(idv, "_WGROUP_BODY", GROUP_BODY)
    seen = []
    orig = idv._walk_all

    def walk_all(arrs, prefix, crc_len, *args, **kw):
        seen.append(crc_len - idv._W)
        return orig(arrs, prefix, crc_len, *args, **kw)

    monkeypatch.setattr(idv, "_walk_all", walk_all)
    return seen


def _decode(blob: bytes, to_device: bool = True, **kw):
    res = idv.decompress_foreign(blob, format="gzip", to_device=to_device,
                                 device="cpu", **kw)
    if to_device:
        t, n = res
        assert t.dtype == torch.uint8 and t.numel() == n
        return bytes(t.numpy())
    return res


def _trailers(blob: bytes) -> list[int]:
    """The byte offset of every member's trailer."""
    members, _b, _a, _crc = native.scan_members(blob, 64)
    return [int(e + 7) // 8 for e in members[:, 2]]


@pytest.mark.parametrize("to_device", [True, False], ids=["tensor", "bytes"])
@pytest.mark.parametrize("name", list(FILES))
def test_members_decode_to_stdlib_bytes(groups, name, to_device):
    blob = FILES[name]()
    want = gzip.decompress(blob)
    assert _decode(blob, to_device) == want
    members = native.scan_members(blob, 64)[0]
    if name == "bgzf":
        assert len(members) == -(-len(DATA) // BGZF_BLOCK) + 1
    if name in ("bgzf", "cat"):  # a member starts inside some group
        ends = np.cumsum(groups)
        starts = ends - groups
        assert len(groups) >= 2 and ends[-1] == len(want)
        inside = (starts < members[:, 3, None]) & (members[:, 3, None] < ends)
        assert inside.any()


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("field", ["crc32", "isize"])
def test_wrong_trailer_in_any_member_raises(groups, field, where):
    """A flipped CRC-32 fails the device CRC's verdict; a wrong ISIZE
    fails before any group is walked."""
    blob = bytearray(_cat(SMALL))
    tr = _trailers(bytes(blob))
    k = {"first": 0, "middle": len(tr) // 2, "last": len(tr) - 1}[where]
    off = tr[k] + (0 if field == "crc32" else 4)
    blob[off] ^= 0x01
    with pytest.raises(ValueError, match=f"{field} mismatch"):
        _decode(bytes(blob))
    assert bool(groups) == (field == "crc32")
    with pytest.raises(ValueError):
        zt.decompress(bytes(blob), format="gzip", engine="device",
                      device="cpu")


def test_truncated_last_member_raises(groups):
    blob = _cat(SMALL)
    with pytest.raises(ValueError, match="truncated gzip member"):
        _decode(blob[:-3])  # into the last trailer
    cut = blob[:_trailers(blob)[-1] - 40]  # into the last body
    assert _decode(cut, to_device=False) is None  # the scan declines
    with pytest.raises((EOFError, zlib.error)):
        gzip.decompress(cut)
    with pytest.raises(ValueError):  # and the host decoder raises
        zt.decompress(cut, format="gzip", engine="device", device="cpu")


def test_distance_before_its_member_raises(groups):
    """A member whose deflate data reaches back into the member before it
    (a preset dictionary, which gzip has not): zlib raises, and so does
    the device route, the window being empty at each member's start."""
    a, b = SMALL[:20000], SMALL[20000:40000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=a)
    body = c.compress(b) + c.flush()
    blob = (gzip.compress(a, 6, mtime=0) + gzip.compress(b"", 6, mtime=0)[:10]
            + body + struct.pack("<II", zlib.crc32(b), len(b)))
    with pytest.raises(zlib.error):
        gzip.decompress(blob)
    assert _decode(blob, to_device=False) is None
    with pytest.raises(ValueError, match="distance too far back"):
        zt.decompress(blob, format="gzip", engine="device", device="cpu")


@pytest.mark.parametrize("junk", [b"trailing junk", bytes(7), b"\x1f"])
def test_trailing_bytes_after_the_last_member_are_ignored(groups, junk):
    blob = _cat(SMALL)
    assert _decode(blob + junk) == SMALL


def test_no_member_is_decoded_on_the_host(groups, monkeypatch):
    def host(*_a, **_k):
        raise AssertionError("host decode")

    monkeypatch.setattr(inflate, "decompress", host)
    monkeypatch.setattr(native, "inflate_raw", host)
    blob = _cat(SMALL) + _bgzf(SMALL)
    assert zt.decompress(blob, format="gzip", engine="device",
                         device="cpu") == SMALL + SMALL


def test_decode_members_span(groups):
    """decode_scan (the C pass over every member) once before the plan;
    decode_members once, inside decode_plan, with no device named."""
    names = []
    with profiling.collect() as timer:
        orig = timer.stage

        def stage(name, device=None):
            names.append((name, device))
            return orig(name, device)

        timer.stage = stage
        assert _decode(_bgzf(SMALL)) == SMALL
    opened = [nm for nm, _d in names]
    assert opened.count("decode_scan") == opened.count("decode_members") == 1
    assert all(d is None for nm, d in names if nm == "decode_members")
    assert opened.index("decode_scan") < opened.index("decode_plan") < (
        opened.index("decode_members")) < opened.index("decode_units")
    assert {"decode_scan", "decode_members"} <= set(timer.as_ms())


@pytest.mark.parametrize("name", ["bgzf", "cat", "flags"])
def test_member_scan_equals_scan_of_each_body(name):
    """scan_members, member by member, gives the blocks, anchors, output
    length and end bit that scan_anchors gives on the member's body
    alone, moved to the buffer's bits, bytes and output; its CRC is the
    trailers' CRC-32s combined, which is the whole output's."""
    blob = FILES[name]()
    members, blocks, anchors, crc = native.scan_members(blob, 64)
    assert crc == zlib.crc32(gzip.decompress(blob))
    want_crc = 0
    for m, (hdr, body, end_bit, out, out_len, mcrc, isize) in enumerate(
            members):
        nxt = members[m + 1, 0] if m + 1 < len(members) else len(blob)
        assert body == hdr + idv.containers.parse_gzip_header(blob[hdr:])
        b, a, total, end = native.scan_anchors(blob[body:nxt], 64)
        assert (total, end + 8 * body) == (out_len, end_bit)
        assert blob[(end_bit + 7) // 8:][:8] == struct.pack("<II", mcrc,
                                                            isize)
        mine = blocks[blocks[:, 5] == m]
        b[:, 0] += 8 * body
        b[:, 2] += out
        b[b[:, 1] == 0, 3] += body
        np.testing.assert_array_equal(mine[:, :5], b)
        first = np.searchsorted(blocks[:, 5], m)
        in_m = (anchors[:, 2] >= first) & (anchors[:, 2] < first + len(b))
        np.testing.assert_array_equal(anchors[in_m, :2],
                                      a + [8 * body, out])
        want_crc = crc32_combine(want_crc, int(mcrc), int(out_len))
    assert crc == want_crc
    assert members[0, 3] == 0 and (
        members[1:, 3] == members[:-1, 3] + members[:-1, 4]).all()


# The ranged scan of BGZF members (native.scan_members with threads > 1)
# against the serial pass (threads=1), on files that BSIZE splits and on
# files it must leave to the serial pass or, with threads given, to the
# byte-ranged scan of the members' blocks.
TINY = mixed_corpus(30000, 26)
SPLIT_FILES = {  # name: (file, the passes with threads)
    "bgzf_2": (lambda: _bgzf(TINY[:3000]), ["ranges"]),
    "bgzf_3": (lambda: _bgzf(TINY[:8000], block=4096), ["ranges"]),
    "bgzf_7": (lambda: _bgzf(TINY[:24576], block=4096), ["ranges"]),
    "bgzf_64": (lambda: _bgzf(TINY[:25200], block=400), ["ranges"]),
    "bgzf_200": (lambda: _bgzf(SMALL[:59700], block=300), ["ranges"]),
    "short_last": (lambda: _bgzf(TINY[:4096 * 5 + 17], block=4096),
                   ["ranges"]),
    "other_subfield_first": (
        lambda: _bgzf(TINY, block=4096, before=b"XY\x03\x00abc"),
        ["ranges"]),
    "eof_only": (lambda: BGZF_EOF, ["serial"]),
    "middle_without_bc": (
        lambda: _bgzf(TINY, block=4096, before=b"XY\x00\x00", plain=(3,)),
        ["byte ranges"]),
    "cat": (lambda: _cat(TINY), ["byte ranges"]),
}


@pytest.fixture
def paths(monkeypatch):
    """Yields the list of the member scan's passes as they run: "ranges"
    (agreed), "ranges declined", "byte ranges" (the byte-ranged scan of
    the members' blocks), "byte ranges declined" or "serial"."""
    seen = []
    ranged, serial = native._scan_ranges, native._scan_serial
    byte_ranged = native._scan_gzip_ranges

    def scan_ranges(*a):
        got = ranged(*a)
        seen.append("ranges" if got is not None else "ranges declined")
        return got

    def scan_gzip_ranges(*a):
        got = byte_ranged(*a)
        seen.append("byte ranges" if got is not None
                    else "byte ranges declined")
        return got

    def scan_serial(*a):
        seen.append("serial")
        return serial(*a)

    monkeypatch.setattr(native, "_scan_ranges", scan_ranges)
    monkeypatch.setattr(native, "_scan_gzip_ranges", scan_gzip_ranges)
    monkeypatch.setattr(native, "_scan_serial", scan_serial)
    return seen


@pytest.mark.parametrize("threads", [2, 3, 7])
@pytest.mark.parametrize("name", list(SPLIT_FILES))
def test_ranged_member_scan_equals_serial_scan(paths, name, threads):
    blob, passes = SPLIT_FILES[name][0](), SPLIT_FILES[name][1]
    want = native.scan_members(blob, 64, threads=1)
    assert paths == ["serial"]
    paths.clear()
    got = native.scan_members(blob, 64, threads=threads)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] == zlib.crc32(gzip.decompress(blob))
    assert paths == passes
    if name.startswith("bgzf_"):
        assert len(want[0]) == int(name[5:])
    if name == "short_last":
        assert want[0][-2, 4] == 17


def test_ranged_member_scan_with_more_threads_than_cores():
    """64 threads take 200 ranges of one member from the shared counter, on
    however many cores the host has, twenty times: every answer is the
    serial pass's."""
    blob = SPLIT_FILES["bgzf_200"][0]()
    want = native.scan_members(blob, 64, threads=1)
    for _ in range(20):
        got = native.scan_members(blob, 64, threads=64)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


def _member_at(blob: bytes, k: int) -> int:
    return int(native.scan_members(blob, 64, threads=1)[0][k, 0])


def _btype3(blob: bytes, k: int) -> bytes:
    """Member k's first block made BTYPE 3 (invalid)."""
    b = bytearray(blob)
    b[_member_at(blob, k) + 18] = 0x07
    return bytes(b)


def _bsize(blob: bytes, k: int, delta: int) -> bytes:
    b = bytearray(blob)
    at = _member_at(blob, k) + 16
    struct.pack_into("<H", b, at, struct.unpack_from("<H", b, at)[0] + delta)
    return bytes(b)


BAD = _bgzf(TINY[:28000], block=4096)  # 7 data members and the marker
BAD_FILES = {  # name: (file, the passes with threads)
    "corrupt_first": (lambda: _btype3(BAD, 0),
                      ["ranges declined", "serial"]),
    "corrupt_middle": (lambda: _btype3(BAD, 3),
                       ["ranges declined", "serial"]),
    "corrupt_last": (lambda: _btype3(BAD, 6),
                     ["ranges declined", "serial"]),
    "bsize_too_small": (lambda: _bsize(BAD, 3, -1),
                        ["ranges declined", "serial"]),
    "bsize_too_large": (lambda: _bsize(BAD, 3, +1),
                        ["ranges declined", "serial"]),
    "cut_trailer": (lambda: BAD[:-len(BGZF_EOF) - 3],
                    ["ranges declined", "serial"]),
    "trailing_junk": (lambda: BAD + b"trailing junk", ["ranges"]),
    "trailing_magic": (lambda: BAD + b"\x1f\x8b\x08",
                       ["byte ranges declined", "serial"]),
}


def _outcome(blob: bytes):
    try:
        return _decode(blob, to_device=False)
    except Exception as e:  # noqa: BLE001 (the type and words compared)
        return type(e), str(e)


@pytest.mark.parametrize("threads", [2, 3, 7])
@pytest.mark.parametrize("name", list(BAD_FILES))
def test_ranged_member_scan_gives_the_serial_verdict(monkeypatch, paths,
                                                     name, threads):
    """A corrupt member in the first, a middle or the last range, a BSIZE
    one off, a cut trailer, trailing bytes: decompress_foreign gives with
    threads the bytes, the None or the exception it gives with the serial
    pass, a disagreement rerunning the serial pass (after the byte-ranged
    scan, where a bad header stops the hop)."""
    blob, passes = BAD_FILES[name][0](), BAD_FILES[name][1]
    scan = native.scan_members
    for r in (1, threads):
        monkeypatch.setattr(native, "scan_members",
                            lambda d, T, r=r: scan(d, T, threads=r))
        paths.clear()
        got = _outcome(blob)
        if r == 1:
            want = got
            assert paths == ["serial"]
    assert got == want
    assert paths == passes
    if name.startswith("corrupt"):
        assert want is None  # the scan's StreamError: the host decides
    elif name == "cut_trailer":
        assert want == (ValueError, "truncated gzip member")
    elif name == "trailing_magic":
        assert want == (ValueError, "gzip member 8: bad header")
    else:
        assert want == gzip.decompress(BAD)


@pytest.mark.parametrize("name", ["bgzf", "stdlib"])
def test_decode_scan_split_span(monkeypatch, name):
    """decode_scan_split, inside decode_scan, for a BGZF file of enough
    members on a host of four cores; not for a one-member stdlib file."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda _pid: set(range(4)))
    data = TINY[:20000]
    blob = (_bgzf(data, block=1024) if name == "bgzf"
            else gzip.compress(data, 6, mtime=0))
    names = []
    with profiling.collect() as timer:
        orig = timer.stage

        def stage(nm, device=None):
            names.append(nm)
            return orig(nm, device)

        timer.stage = stage
        assert _decode(blob) == data
    ms = timer.as_ms()
    if name == "stdlib":
        assert "decode_scan_split" not in names and "decode_scan" in ms
        return
    assert 20 // native.SPLIT_MIN_MEMBERS >= 2
    assert names.count("decode_scan_split") == 1
    assert names.index("decode_scan") < names.index("decode_scan_split") < (
        names.index("decode_plan"))
    assert 0 < ms["decode_scan_split"] <= ms["decode_scan"]
