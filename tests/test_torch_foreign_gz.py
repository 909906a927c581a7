"""Device decode of ordinary .gz members, as GNU gzip, zlib and Python's
gzip module write them (FNAME set, no index), through
``inflate_device.decompress_foreign(..., to_device=True)`` on the CPU.

The walk groups are shrunk so that each member chains at least three of
them, each group's 32 KiB prefix cut from the one before. The plain
reference is the standard library's ``gzip.decompress``."""
import gzip
import io
import struct

import pytest
import torch

from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.utils import profiling
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# One thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

NBYTES = 300000  # zlib -6 writes 5 blocks of 24-112 KB output here
GROUP_OUT = 1 << 17  # > the largest block's output: 3 groups a member
GROUP_BODY = 1 << 16


def _member(data: bytes, name: str = "shard-00000") -> bytes:
    bio = io.BytesIO()
    with gzip.GzipFile(filename=name, mode="wb", compresslevel=6,
                       fileobj=bio, mtime=0) as f:
        f.write(data)
    return bio.getvalue()


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


def _decode(blob: bytes, **kw):
    return idv.decompress_foreign(blob, format="gzip", to_device=True,
                                  device="cpu", **kw)


@pytest.mark.parametrize("seed", [3, 2**40 + 11])
def test_member_decodes_to_stdlib_bytes(groups, seed):
    data = mixed_corpus(NBYTES, seed)
    blob = _member(data)
    assert blob[3] & 0x08  # FNAME
    assert gzip.decompress(blob) == data
    t, n = _decode(blob)
    assert len(groups) >= 3 and sum(groups) == n == len(data)
    assert t.dtype == torch.uint8 and t.numel() == n
    assert bytes(t.numpy()) == data


@pytest.mark.parametrize("field", ["crc32", "isize"])
def test_wrong_trailer_raises(groups, field):
    """A flipped CRC-32 fails the device CRC's verdict; a wrong ISIZE fails
    before any group is walked."""
    blob = _member(mixed_corpus(NBYTES, 5))
    crc, isize = struct.unpack("<II", blob[-8:])
    if field == "crc32":
        crc ^= 0xFFFFFFFF
    else:
        isize += 1
    bad = blob[:-8] + struct.pack("<II", crc, isize)
    with pytest.raises(ValueError, match=f"{field} mismatch"):
        _decode(bad)
    assert len(groups) == (3 if field == "crc32" else 0)


def test_decode_units_spans_each_group(groups):
    """decode_scan runs once before the plan; decode_units once a group,
    inside decode_plan, with no device named; decode_pack once a group."""
    names = []
    with profiling.collect() as timer:
        orig = timer.stage

        def stage(name, device=None):
            names.append((name, device))
            return orig(name, device)

        timer.stage = stage
        t, n = _decode(_member(mixed_corpus(NBYTES, 9)))
    assert n == NBYTES and len(groups) >= 3
    opened = [nm for nm, _d in names]
    assert opened.count("decode_scan") == 1
    assert opened.count("decode_units") == len(groups)
    assert opened.count("decode_pack") == len(groups)
    assert all(d is None for nm, d in names if nm == "decode_units")
    assert opened.index("decode_scan") < opened.index("decode_plan") < (
        opened.index("decode_units"))
    assert {"decode_units", "decode_scan", "decode_pack"} <= set(
        timer.as_ms())
