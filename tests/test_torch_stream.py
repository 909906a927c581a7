"""zzflate_tpu_torch.stream, and the pipeline's streaming modes, against
zzflate_tpu on the CPU.

Every Compressor step (each compress/flush/set_params return value and
the sub-byte tail after it) must equal the reference's, and every
Decompressor call must give the reference's output, state and error
class. Tolerance is zero: the codec is integer-only and deterministic.
The reference takes the C optimal parse at level 9 only when its C
library is built (otherwise the lazy parse, without a word), so the
level-9 cases assert that library first. 4 KiB chunks and few distinct
(level, chunk) pairs keep the reference's compiles few.
"""
import gzip
import hashlib
import zlib

import numpy as np
import pytest
import torch

from zzflate_tpu import native as jax_native
from zzflate_tpu import stream as ref_stream
from zzflate_tpu.api import _encode_segments as ref_encode_segments
from zzflate_tpu.config import CodecConfig as RefConfig
from zzflate_tpu_torch import stream
from zzflate_tpu_torch.config import CodecConfig
from zzflate_tpu_torch.encode_pipeline import encode_segments
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)

CHUNK = 4096
CPU = torch.device("cpu")
DATA = mixed_corpus(20000, 31)
DICT = mixed_corpus(6000, 32)[-5000:]
# Five chunks; the last one and a half are incompressible, so the stored
# fallback's final and non-final rules both show.
NOISE = np.random.default_rng(5).integers(0, 256, 6000, np.uint8).tobytes()
PIPE_DATA = DATA[:14000] + NOISE


def _join_bits(segments, close: bool) -> bytes:
    """Concatenate (bytes, nbits) segments at bit granularity; close=True
    appends a final empty fixed block (BFINAL 1, BTYPE 01, EOB)."""
    acc, pos = 0, 0
    for seg, nbits in segments:
        acc |= (int.from_bytes(seg, "little") & ((1 << nbits) - 1)) << pos
        pos += nbits
    if close:
        acc |= 0b011 << pos
        pos += 10
    return acc.to_bytes((pos + 7) // 8, "little")


@pytest.mark.parametrize(
    "stream_final, frame",
    [(False, True), (True, False), (False, False)],
    ids=["open", "unframed", "unframed-open"],
)
@pytest.mark.parametrize("level", [1, 6, 9], ids=["L1", "L6", "L9"])
def test_encode_segments_streaming_modes_equal_reference(level, stream_final,
                                                         frame):
    if level == 9:
        assert jax_native.lib() is not None
    exp = ref_encode_segments(
        PIPE_DATA, RefConfig(level=level, chunk_bytes=CHUNK), None,
        stream_final=stream_final, frame=frame,
    )
    got = encode_segments(
        PIPE_DATA, CodecConfig(level=level, chunk_bytes=CHUNK), None, CPU,
        stream_final=stream_final, frame=frame,
    )
    assert got["segments"] == exp["segments"]
    assert got["blocks"] == exp["blocks"]
    assert got["anchors"] == exp["anchors"]
    segs = got["segments"]
    if frame:
        # The last chunk (noise) fell back to a non-final stored block;
        # the closing block appended here ends the stream exactly.
        assert segs[-1][0] == 0x00
        blob = b"".join(segs) + b"\x03\x00"
    else:
        assert all(isinstance(s, tuple) for s in segs)
        blob = _join_bits(segs, close=not stream_final)
    d = zlib.decompressobj(-15)
    assert d.decompress(blob) == PIPE_DATA
    assert d.eof and not d.unused_data


def test_encode_segments_open_empty_equals_reference():
    """An empty non-final run is one empty chunk: its stored fallback
    (00 00 00 ff ff) beats the Huffman block."""
    exp = ref_encode_segments(b"", RefConfig(level=6, chunk_bytes=CHUNK),
                              None, stream_final=False)
    got = encode_segments(b"", CodecConfig(level=6, chunk_bytes=CHUNK),
                          None, CPU, stream_final=False)
    assert got["segments"] == exp["segments"] == [b"\x00\x00\x00\xff\xff"]


# ---------------------------------------------------------------------------
# Compressor, step for step.
# ---------------------------------------------------------------------------

S, F, B, N, X = (stream.Z_SYNC_FLUSH, stream.Z_FULL_FLUSH, stream.Z_BLOCK,
                 stream.Z_NO_FLUSH, stream.Z_FINISH)


def _c(lo, hi):
    return ("compress", DATA[lo:hi])


# name: (Compressor keywords, steps). A step is ("compress", bytes),
# ("flush", mode), ("params", keywords) or ("copy", steps of the clone).
SCRIPTS = {
    "every-mode": (dict(level=6), [
        _c(0, 5000), ("flush", S), _c(5000, 6001), ("flush", B),
        # A chunk fills while mid-byte: unframed join, then realign.
        _c(6001, 12000), ("flush", F), ("flush", S), ("flush", N),
        _c(12000, 12500), ("flush", B), ("flush", B), _c(12500, 13000),
        ("flush", X),
    ]),
    "block-then-sync": (dict(level=6, format="raw"), [
        _c(0, 2301), ("flush", B), ("flush", S), _c(2301, 4000),
        ("flush", B), _c(4000, 9000), ("flush", B), ("flush", X),
    ]),
    "set-params": (dict(level=6, format="gzip"), [
        _c(0, 3000), ("flush", B), ("params", dict(level=9)),
        _c(3000, 11000), ("params", dict(level=1, strategy=1)),
        _c(11000, 15000), ("flush", B), ("params", dict(level=0)),
        _c(15000, 16000), ("flush", X),
    ]),
    "level-0": (dict(level=0), [
        _c(0, 5000), ("flush", B), _c(5000, 9000), ("flush", S),
        ("flush", F), _c(9000, 9500), ("flush", X),
    ]),
    "dictionary": (dict(level=6, dictionary=DICT), [
        _c(0, 3000), ("flush", S), _c(3000, 7000), ("flush", B),
        ("flush", X),
    ]),
    "raw-dictionary-level-1": (dict(level=1, format="raw", dictionary=DICT), [
        _c(0, 6000), ("flush", B), _c(6000, 9000), ("flush", X),
    ]),
    "gzip-mtime": (dict(level=1, format="gzip", mtime=1234567890), [
        _c(0, 5000), ("flush", F), _c(5000, 9000), ("flush", X),
    ]),
    "copy": (dict(level=6), [
        _c(0, 5000), _c(5000, 6001), ("flush", B),
        ("copy", [_c(9000, 14000), ("flush", S), ("flush", X)]),
        _c(6001, 9000), ("flush", X),
    ]),
    "empty-finish": (dict(level=6, format="gzip"), [("flush", X)]),
    "empty-flushes": (dict(level=6), [
        ("flush", S), ("flush", B), ("flush", F), ("flush", X),
    ]),
    "native": (dict(level=6, engine="native"), [
        _c(0, 5000), ("flush", S), _c(5000, 6001), ("flush", B),
        _c(6001, 12000), ("flush", X),
    ]),
}


# Scripts whose Z_BLOCK leaves the stream mid-byte on this data.
MID_BYTE = {"every-mode", "block-then-sync", "set-params", "dictionary",
            "raw-dictionary-level-1", "copy", "native"}


def _drive(comp, steps, log):
    """Apply steps; log every returned value and the tail after it."""
    for kind, arg in steps:
        if kind == "compress":
            out = comp.compress(arg)
        elif kind == "flush":
            out = comp.flush(arg)
        elif kind == "params":
            out = comp.set_params(**arg)
        else:
            clone = comp.copy()
            log.append(("copy",))
            _drive(clone, arg, log)
            log.append(("original",))
            continue
        log.append((kind, out, comp._tail_n, comp._tail_v))
    return log


def _port(kw):
    # The native engine takes the pipeline at a Z_BLOCK, on this device.
    return stream.Compressor(**dict(kw, chunk_bytes=CHUNK, device="cpu"))


def _ref(kw):
    kw = dict(kw, chunk_bytes=CHUNK)
    kw.setdefault("engine", "tpu")
    return ref_stream.Compressor(**kw)


def _decode(blob, kw):
    fmt = kw.get("format", "zlib")
    wbits = {"zlib": 15, "gzip": 31, "raw": -15}[fmt]
    d = (zlib.decompressobj(wbits, zdict=kw["dictionary"])
         if "dictionary" in kw else zlib.decompressobj(wbits))
    return d.decompress(blob) + d.flush()


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_compressor_steps_equal_reference(name):
    kw, steps = SCRIPTS[name]
    if name == "set-params":
        assert jax_native.lib() is not None
    got = _drive(_port(kw), steps, [])
    exp = _drive(_ref(kw), steps, [])
    assert got == exp
    # The mid-byte state the Z_BLOCK cases exist for does occur.
    if name in MID_BYTE:
        assert any(entry[2] for entry in got if len(entry) == 4)
    # The original stream (after the clone's part) decodes.
    if name == "copy":
        orig = got[got.index(("original",)) + 1 :]
        head = [e[1] for e in got[: got.index(("copy",))]]
        blob = b"".join(head + [e[1] for e in orig])
        assert _decode(blob, kw) == DATA[:9000]
    else:
        blob = b"".join(e[1] for e in got)
        fed = b"".join(arg for kind, arg in steps if kind == "compress")
        assert _decode(blob, kw) == fed


def test_stream_script_digest():
    """chip_smoke.py holds the card's stream to REF_SHA256_STREAM_4K; the
    reference's Compressor gives that digest, step for step equal to the
    port's CPU path."""
    import chip_smoke

    assert jax_native.lib() is not None
    data = mixed_corpus(chip_smoke.REF_INPUT_BYTES, chip_smoke.REF_INPUT_SEED)
    kw = dict(level=6, format="gzip", chunk_bytes=CHUNK)
    exp = chip_smoke.stream_script(ref_stream.Compressor(**kw), data, CHUNK)
    got = chip_smoke.stream_script(stream.Compressor(device="cpu", **kw),
                                   data, CHUNK)
    assert got == exp
    blob = b"".join(got)
    assert gzip.decompress(blob) == data
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.REF_SHA256_STREAM_4K


def test_compressor_refuses_like_reference():
    for mod, engine in ((stream, "native"), (ref_stream, "native")):
        with pytest.raises(ValueError):
            mod.Compressor(format="gzip", dictionary=b"x", engine=engine)
        with pytest.raises(ValueError):
            mod.Compressor(engine="gpu")
        c = mod.Compressor(engine=engine)
        c.flush(X)
        with pytest.raises(ValueError):
            c.compress(b"x")
        with pytest.raises(ValueError):
            c.flush(X)
        with pytest.raises(ValueError):
            mod.Compressor(engine=engine).flush(9)


def test_compressor_device_defaults_to_cuda():
    """engine="device" (the default) needs a card unless device="cpu";
    it never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError):
        stream.Compressor()
    with pytest.raises(RuntimeError):
        stream.Compressor(level=0, engine="device")
    # The native engine needs none, until Z_BLOCK asks for the pipeline.
    c = stream.Compressor(engine="native")
    c.compress(DATA[:3000])
    with pytest.raises(RuntimeError):
        c.flush(B)


# ---------------------------------------------------------------------------
# Decompressor, call for call.
# ---------------------------------------------------------------------------

def _zlib_blob(data, level=6, wbits=15, zdict=None):
    c = (zlib.compressobj(level, zlib.DEFLATED, wbits, zdict=zdict)
         if zdict is not None else zlib.compressobj(level, zlib.DEFLATED, wbits))
    return c.compress(data) + c.flush()


ZBLOB = _zlib_blob(DATA)
GZ2 = gzip.compress(DATA[:7000], mtime=0) + gzip.compress(DATA[7000:], mtime=0)
CORRUPT = bytearray(ZBLOB)
CORRUPT[30] ^= 0xFF

# name: (Decompressor keywords, stream, piece sizes (cycled), max_length)
DECODE_CASES = {
    "zlib-pieces": (dict(), ZBLOB, [1, 7, 333, 4096], 0),
    "zlib-whole-max-length": (dict(), ZBLOB, [len(ZBLOB)], 1000),
    "unused-data": (dict(), ZBLOB + b"TRAILING", [977, 5000], 0),
    "gzip-two-members": (dict(format="gzip"), GZ2, [1, 500, 3001], 0),
    "gzip-member-then-garbage": (dict(format="gzip"),
                                 GZ2 + b"\x1f", [4096], 0),
    "gzip-fextra-fname": (dict(format="gzip"),
                          b"\x1f\x8b\x08\x0c\x00\x00\x00\x00\x00\xff"
                          b"\x03\x00abcname\x00"
                          + gzip.compress(DATA[:3000], mtime=0)[10:],
                          [1, 2, 3], 0),
    "raw-dictionary": (dict(format="raw", dictionary=DICT),
                       _zlib_blob(DATA[:8000], wbits=-15, zdict=DICT),
                       [2000], 0),
    "zlib-dictionary": (dict(dictionary=DICT),
                        _zlib_blob(DATA[:8000], zdict=DICT), [3, 4000], 0),
    "zlib-missing-dictionary": (dict(), _zlib_blob(DATA[:8000], zdict=DICT),
                                [4000], 0),
    "zlib-wrong-dictionary": (dict(dictionary=DICT[::-1]),
                              _zlib_blob(DATA[:8000], zdict=DICT), [4000], 0),
    "truncated": (dict(), ZBLOB[:-9], [4096], 0),
    "truncated-in-trailer": (dict(format="gzip"),
                             gzip.compress(DATA, mtime=0)[:-3], [5000], 0),
    "corrupt": (dict(), bytes(CORRUPT), [4096], 0),
    "bad-gzip-magic": (dict(format="gzip"), b"\x1f\x8cxxxxxxxxxxxx", [16], 0),
    "bad-adler": (dict(), ZBLOB[:-1] + bytes([ZBLOB[-1] ^ 1]), [9000], 0),
}


def _feed(mod, kw, blob, pieces, max_length):
    """Every call's output (or error class name), then the end state."""
    d = mod.Decompressor(**kw)
    log = []
    off, k = 0, 0
    try:
        while off < len(blob):
            n = pieces[k % len(pieces)]
            log.append(d.decompress(blob[off : off + n], max_length))
            off += n
            k += 1
        if max_length:
            while True:  # drain what max_length held back
                out = d.decompress(b"", max_length)
                log.append(out)
                if not out:
                    break
        log.append(d.flush())
    except ValueError as e:
        log.append(type(e).__name__)
    return log, d.eof, d.unused_data, d.unconsumed_tail


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decompressor_equals_reference(case):
    kw, blob, pieces, max_length = DECODE_CASES[case]
    got = _feed(stream, kw, blob, pieces, max_length)
    exp = _feed(ref_stream, kw, blob, pieces, max_length)
    assert got == exp
    if case in ("zlib-pieces", "unused-data", "zlib-whole-max-length"):
        assert b"".join(x for x in got[0] if isinstance(x, bytes)) == DATA
        assert got[1]
    if case.startswith(("corrupt", "bad-", "zlib-missing", "zlib-wrong")):
        assert got[0][-1] == "ValueError"


def test_decompressor_copy_diverges_like_reference():
    outs = []
    for mod in (stream, ref_stream):
        d = mod.Decompressor()
        first = d.decompress(ZBLOB[: len(ZBLOB) // 2])
        d2 = d.copy()
        rest = d.decompress(ZBLOB[len(ZBLOB) // 2 :])
        rest2 = d2.decompress(ZBLOB[len(ZBLOB) // 2 :] + b"tail")
        assert first + rest == first + rest2 == DATA
        outs.append((first, rest, rest2, d.eof, d2.eof, d2.unused_data))
    assert outs[0] == outs[1]
