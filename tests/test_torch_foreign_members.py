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


def _bgzf(data: bytes, level: int = 6) -> bytes:
    """data as bgzip writes it: raw deflate members of BGZF_BLOCK input
    bytes, each header with FEXTRA's BC subfield (BSIZE = member length -
    1), then the end marker."""
    out = []
    for o in range(0, len(data), BGZF_BLOCK):
        piece = data[o:o + BGZF_BLOCK]
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
        body = c.compress(piece) + c.flush()
        out.append(b"\x1f\x8b\x08\x04" + bytes(4) + b"\x00\xff"
                   + struct.pack("<HBBHH", 6, 66, 67, 2, len(body) + 25)
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
