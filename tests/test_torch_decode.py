"""Host decode and the host C engine of zzflate_tpu_torch, against stdlib
zlib and zzflate_tpu.

decompress() must decode every stream of tests/test_inflate_oracle.py's
cases to what stdlib zlib and zzflate_tpu.decompress give, and raise
ValueError where the reference does. decompress_range() and
compress(engine="native") must give the reference's bytes. The plain
Python decoder (the port's oracle) must agree with the C decoder, and
the C runtime must be the port's own build, with no fallback when it
cannot be built. Tolerance is zero.
"""
import gzip
import io
import zlib

import numpy as np
import pytest
import torch

import zzflate_tpu as zf
import zzflate_tpu_torch as zt
from zzflate_tpu_torch import native
from zzflate_tpu_torch.models import inflate
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)


def _corpus(n=30000, seed=3):
    """tests/test_inflate_oracle.py's corpus: text, random bytes, zeros."""
    rng = np.random.default_rng(seed)
    text = (b"<item key='v'>some text body</item>\n" * 2000)[: n // 2]
    rnd = rng.integers(0, 256, size=n // 4, dtype=np.uint8).tobytes()
    zeros = b"\x00" * (n - len(text) - len(rnd))
    return text + rnd + zeros


_DICT = b"common preamble text " * 100


def _stream(name):
    """(blob, format, dictionary, expected output or None for an error)."""
    if name.startswith("zlib-L"):
        data = _corpus()
        return zlib.compress(data, int(name[6:])), "zlib", None, data
    if name.startswith("strategy-"):
        strategy = int(name[9:])
        data = _corpus(seed=strategy + 10)
        c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, strategy)
        return c.compress(data) + c.flush(), "zlib", None, data
    if name == "gzip-module":
        data = _corpus(seed=5)
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb", filename="name.txt") as f:
            f.write(data)
        return buf.getvalue(), "gzip", None, data
    if name == "raw":
        data = _corpus(seed=6)
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        return c.compress(data) + c.flush(), "raw", None, data
    if name == "sync-flush":
        d1, d2 = _corpus(seed=7), _corpus(seed=8)
        c = zlib.compressobj(6)
        blob = c.compress(d1) + c.flush(zlib.Z_FULL_FLUSH) + c.compress(d2) \
            + c.flush()
        return blob, "zlib", None, d1 + d2
    data = b"common preamble text with a twist " * 50
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY,
                         zdict=_DICT)
    blob = c.compress(data) + c.flush()
    if name == "dictionary":
        return blob, "zlib", _DICT, data
    if name == "dictionary-missing":
        return blob, "zlib", None, None
    if name == "corrupt-trailer":
        bad = bytearray(zlib.compress(_corpus(seed=11), 6))
        bad[-1] ^= 0xFF
        return bytes(bad), "zlib", None, None
    assert name == "bad-nlen"
    return bytes([0x01, 0x05, 0x00, 0x00, 0x00]) + b"hello", "raw", None, None


STREAMS = ([f"zlib-L{lv}" for lv in range(10)]
           + [f"strategy-{s}" for s in range(5)]
           + ["gzip-module", "raw", "sync-flush", "dictionary",
              "dictionary-missing", "corrupt-trailer", "bad-nlen"])


def _stdlib(blob, fmt, dictionary):
    wbits = {"zlib": 15, "gzip": 31, "raw": -15}[fmt]
    d = (zlib.decompressobj(wbits, zdict=dictionary) if dictionary
         else zlib.decompressobj(wbits))
    out = d.decompress(blob) + d.flush()
    if not d.eof:
        raise zlib.error("incomplete stream")
    return out


@pytest.mark.parametrize("name", STREAMS)
def test_decompress_equals_stdlib_and_reference(name):
    blob, fmt, dictionary, data = _stream(name)
    if data is None:
        with pytest.raises(zlib.error):
            _stdlib(blob, fmt, dictionary)
        with pytest.raises(ValueError):
            zf.decompress(blob, format=fmt, dictionary=dictionary)
        with pytest.raises(ValueError):
            zt.decompress(blob, format=fmt, dictionary=dictionary)
        return
    got = zt.decompress(blob, format=fmt, dictionary=dictionary)
    assert got == data
    assert got == _stdlib(blob, fmt, dictionary)
    assert got == zf.decompress(blob, format=fmt, dictionary=dictionary)


def _raw_start(blob, fmt):
    if fmt == "zlib":
        return containers.parse_zlib_header(blob)[0] * 8
    if fmt == "gzip":
        return containers.parse_gzip_header(blob) * 8
    return 0


@pytest.mark.parametrize(
    "name", [s for s in STREAMS if s not in ("dictionary-missing",
                                             "corrupt-trailer")])
def test_python_decoder_equals_c_decoder(name):
    """The plain Python decoder, the port's oracle, against the C one:
    the same output and end bit, or both raise ValueError."""
    blob, fmt, dictionary, data = _stream(name)
    bit = _raw_start(blob, fmt)
    if data is None:
        with pytest.raises(ValueError):
            native.inflate_raw(blob, b"", bit)
        with pytest.raises(ValueError):
            inflate.inflate_raw(blob, b"", bit)
        return
    exp = native.inflate_raw(blob, dictionary or b"", bit)
    assert inflate.inflate_raw(blob, dictionary or b"", bit) == exp
    assert exp[0] == data
    out, end, bfinal, more = inflate.inflate_blocks(blob, dictionary or b"",
                                                    bit)
    assert (out, end, bfinal, more) == (data, exp[1], True, False)
    assert native.inflate_stream(blob, dictionary or b"", bit) == (
        data, exp[1], True, False)


def test_decoders_on_a_cut_stream():
    """A stream cut inside a block: the incremental decoders stop at the
    last complete block and ask for more; the one-shot ones raise."""
    c = zlib.compressobj(6)
    blob = c.compress(_corpus(seed=7)) + c.flush(zlib.Z_FULL_FLUSH) \
        + c.compress(_corpus(seed=8)) + c.flush()
    cut = blob[: len(blob) - 200]
    out_c, bit_c, fin_c, more_c = native.inflate_stream(cut, b"", 16)
    assert (fin_c, more_c) == (False, True)
    assert inflate.inflate_blocks(cut, b"", 16) == (out_c, bit_c, False, True)
    assert _corpus(seed=7) == out_c[: len(_corpus(seed=7))]
    with pytest.raises(ValueError):
        zt.decompress(cut)


INDEXED = mixed_corpus(20000, 31)
RANGES = [(0, 10), (5000, 7000), (4095, 2), (8192, 4096), (19990, 10),
          (0, 20000), (12345, 0)]


@pytest.fixture(scope="module")
def indexed_streams():
    return {
        "plain": zt.compress(INDEXED, format="gzip", chunk_bytes=4096,
                             device="cpu"),
        "indexed": zt.compress(INDEXED, format="gzip", chunk_bytes=4096,
                               indexed=True, device="cpu"),
        "seekable": zt.compress(INDEXED, format="gzip", chunk_bytes=4096,
                                indexed=True, seekable=True, device="cpu"),
    }


@pytest.mark.parametrize("kind", ["plain", "indexed", "seekable"])
def test_decompress_range_equals_reference(indexed_streams, kind):
    blob = indexed_streams[kind]
    assert (containers.parse_gzip_index(blob) is None) == (kind == "plain")
    assert zt.decompress(blob, format="gzip") == INDEXED
    for off, ln in RANGES:
        got = zt.decompress_range(blob, off, ln)
        assert got == INDEXED[off : off + ln]
        assert got == zf.decompress_range(blob, off, ln)
    for off, ln in ((19990, 11), (-1, 5)):
        with pytest.raises(ValueError):
            zt.decompress_range(blob, off, ln)
        with pytest.raises(ValueError):
            zf.decompress_range(blob, off, ln)


def test_index_parsers_equal_reference(indexed_streams):
    from zzflate_tpu.utils import containers as ref

    for blob in indexed_streams.values():
        assert containers.parse_gzip_index(blob) == ref.parse_gzip_index(blob)
        assert containers.gzip_index_flags(blob) == ref.gzip_index_flags(blob)
        assert containers.parse_gzip_header(blob) == \
            ref.parse_gzip_header(blob)
    z = zlib.compress(b"abc")
    assert containers.parse_zlib_header(z) == ref.parse_zlib_header(z)


NATIVE = mixed_corpus(60000, 36)
NATIVE_CASES = {
    **{f"L{lv}": dict(level=lv) for lv in range(10)},
    **{f"strategy-{s}": dict(strategy=s) for s in range(5)},
    "dictionary": dict(dictionary=mixed_corpus(6000, 32)[-5000:]),
    "window-bits-9": dict(window_bits=9),
    "gzip": dict(format="gzip"),
}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_engine_equals_reference(case):
    kw = NATIVE_CASES[case]
    exp = zf.compress(NATIVE, engine="native", **kw)
    # No device argument: the host engine never asks for a card.
    got = zt.compress(NATIVE, engine="native", **kw)
    assert got == exp
    assert zt.decompress(got, format=kw.get("format", "zlib"),
                         dictionary=kw.get("dictionary")) == NATIVE


def test_native_engine_chunked_equals_reference():
    """2.5 MiB: three 1 MiB chunks on the thread pool, joined by
    sync-flush framing."""
    data = mixed_corpus(5 << 19, 37)
    exp = zf.compress(data, level=6, format="gzip", engine="native")
    got = zt.compress(data, level=6, format="gzip", engine="native")
    assert got == exp
    assert zlib.decompress(got, wbits=31) == data
    assert got == zt.compress(data, level=6, format="gzip", engine="native",
                              chunk_bytes=1 << 20)


def test_native_engine_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        zt.compress(b"abc", format="gzip", indexed=True, engine="native")
    with pytest.raises(ValueError):
        zt.compress(b"abc", engine="tpu")


def test_c_runtime_is_the_ports_own_build():
    path = native.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "zzflate_tpu_torch"
    assert native.lib()._name == str(native.build())
    assert path.exists()


def test_c_runtime_build_failure_raises(monkeypatch, tmp_path):
    """No compiler on PATH and an empty build directory: loading raises
    RuntimeError; nothing falls back."""
    monkeypatch.setattr(native, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError):
        native.lib()
    with pytest.raises(RuntimeError):
        zt.decompress(zlib.compress(b"abc"))
    with pytest.raises(RuntimeError):
        zt.compress(b"abc", engine="native")
