"""Device decode of zlib streams (RFC 1950) through
``inflate_device.decompress_foreign(..., format="zlib")`` on the CPU, with
the Adler-32 computed on the decode device a group at a time, combined on
the host and held to the trailer on both the to_device and the fetch
path.

The walk groups are shrunk so that each stream chains at least three of
them. The bytes are held to the standard library's ``zlib.decompress``
and to the reference's fetch path; the verdicts to ``zlib``'s."""
import functools
import struct
import zlib

import pytest
import torch

import zzflate_tpu_torch as zt
from zzflate_tpu.models import inflate_tpu as ref
from zzflate_tpu_torch import native
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.ops import checksums as cs
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# One thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

NBYTES = 300000  # zlib -1 writes blocks of 20-125 KB output here
GROUP_OUT = 1 << 17  # > the largest block's output: 3-4 groups a stream
GROUP_BODY = 1 << 16
DATA = mixed_corpus(NBYTES, 26)

SOURCES = {
    "zlib1": lambda: zlib.compress(DATA, 1),
    "zlib6": lambda: zlib.compress(DATA, 6),
    "zlib9": lambda: zlib.compress(DATA, 9),
    "port1": lambda: zt.compress(DATA, level=1, format="zlib", device="cpu"),
}


@functools.lru_cache(maxsize=None)
def _blob(name: str) -> bytes:
    blob = SOURCES[name]()
    assert zlib.decompress(blob) == DATA
    return blob


def _flipped(blob: bytes) -> bytes:
    (adler,) = struct.unpack(">I", blob[-4:])
    return blob[:-4] + struct.pack(">I", adler ^ 0xFFFFFFFF)


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


def _decode(blob: bytes, to_device: bool, **kw) -> bytes:
    res = idv.decompress_foreign(blob, format="zlib", to_device=to_device,
                                 device="cpu", **kw)
    assert res is not None
    if not to_device:
        return res
    t, n = res
    assert t.dtype == torch.uint8 and t.numel() == n
    return bytes(t.numpy())


@pytest.mark.parametrize("to_device", [True, False], ids=["card", "fetch"])
@pytest.mark.parametrize("name", list(SOURCES))
def test_stream_decodes_to_stdlib_and_reference_bytes(groups, name,
                                                      to_device):
    blob = _blob(name)
    got = _decode(blob, to_device)
    assert len(groups) >= 3 and sum(groups) == NBYTES
    assert got == zlib.decompress(blob) == ref.decompress_foreign(
        blob, format="zlib") == DATA


@pytest.mark.parametrize("to_device", [True, False], ids=["card", "fetch"])
def test_flipped_adler_raises_after_the_walk(groups, to_device):
    """Every group is walked and checksummed; then the combined Adler-32
    fails the trailer's, as zlib's own check does."""
    bad = _flipped(_blob("zlib1"))
    with pytest.raises(zlib.error):
        zlib.decompress(bad)
    with pytest.raises(ValueError,
                       match=r"^adler32 mismatch \(device inflate\)$"):
        _decode(bad, to_device)
    assert len(groups) >= 3


@pytest.mark.parametrize("to_device", [True, False], ids=["card", "fetch"])
def test_verify_off_accepts_a_flipped_adler(groups, to_device):
    assert _decode(_flipped(_blob("zlib1")), to_device,
                   verify=False) == DATA


def test_group_adlers_combine_to_the_trailer(groups, monkeypatch):
    """One Adler-32 a group, each over exactly that group's output on the
    decode device, and no host pass over the output: their combine is the
    stream's."""
    vals = []
    orig = cs._adler32_impl

    def adler(data, length, start=0):
        v = orig(data, length, start)
        vals.append((bytes(data[start:length].numpy()), int(v)))
        return v

    def no_host_pass(*_a, **_k):
        raise AssertionError("a host Adler-32 pass over the output")

    monkeypatch.setattr(cs, "_adler32_impl", adler)
    monkeypatch.setattr(native, "adler32", no_host_pass)
    blob = _blob("zlib1")
    assert _decode(blob, False) == DATA
    assert len(vals) == len(groups) >= 3
    assert b"".join(piece for piece, _v in vals) == DATA
    value = 1
    for piece, v in vals:
        assert v == zlib.adler32(piece)
        value = cs.adler32_combine(value, v, len(piece))
    assert value == struct.unpack(">I", blob[-4:])[0] == zlib.adler32(DATA)


@pytest.mark.parametrize("to_device", [True, False], ids=["card", "fetch"])
def test_empty_stream_decodes_to_nothing(to_device):
    """Only a final fixed block's EOB: one group of no output, whose
    Adler-32 is 1."""
    blob = zlib.compress(b"", 1)
    assert _decode(blob, to_device) == b""
    with pytest.raises(ValueError, match="adler32 mismatch"):
        _decode(_flipped(blob), to_device)


@pytest.mark.parametrize("to_device", [True, False], ids=["card", "fetch"])
def test_cut_trailer_raises(to_device):
    blob = _blob("zlib6")
    with pytest.raises(ValueError, match="truncated zlib trailer"):
        _decode(blob[:-1], to_device)


@pytest.mark.parametrize("to_device", [True, False], ids=["card", "fetch"])
def test_bytes_after_the_trailer_are_ignored(to_device):
    blob = _blob("zlib6") + b"trailing junk"
    assert zlib.decompressobj().decompress(blob) == DATA
    assert _decode(blob, to_device) == DATA


def test_preset_dictionary_declines():
    zdict = DATA[:4096]
    c = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY,
                         zdict=zdict)
    blob = c.compress(DATA) + c.flush()
    for to_device in (True, False):
        assert idv.decompress_foreign(blob, format="zlib",
                                      to_device=to_device,
                                      device="cpu") is None
