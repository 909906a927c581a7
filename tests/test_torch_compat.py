"""The port's zlib_compat, gzip_compat, utils/resume and CLI against
zzflate_tpu's and the stdlib, on the CPU.

Outputs must equal the reference's byte for byte (tolerance zero: the
codec is integer-only and deterministic) and decode with stdlib zlib and
gzip. The facades' one-shot and compressobj paths run at the default
256 KiB chunk (they take no chunk size), at level 6 and 0 only, the
pairs the reference's own facade tests compile.
"""
import ast
import gzip as std_gzip
import io
import json
import os
import pathlib
import struct
import time
import zlib

import numpy as np
import pytest
import torch

import zzflate_tpu as zf
import zzflate_tpu.gzip_compat as ref_gz
import zzflate_tpu.zlib_compat as ref_zc
from zzflate_tpu.utils import resume as ref_resume
import zzflate_tpu_torch as zt
from zzflate_tpu_torch import cli, native
from zzflate_tpu_torch import gzip_compat as gz
from zzflate_tpu_torch import zlib_compat as zc
from zzflate_tpu_torch.utils import resume
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = mixed_corpus(60000, 41)
NOISE = np.random.default_rng(6).integers(0, 256, 30000, np.uint8).tobytes()


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")


# ---------------------------------------------------------------------------
# zlib_compat
# ---------------------------------------------------------------------------

def test_zlib_constants_equal_reference():
    names = [n for n in dir(ref_zc) if n.isupper() and "VERSION" not in n]
    assert len(names) > 15
    assert {n: getattr(zc, n) for n in names} == \
        {n: getattr(ref_zc, n) for n in names}
    assert zc.error is ref_zc.error is zlib.error


@pytest.mark.parametrize("wbits", [0, 8, 9, 15, 16, -8, -9, -15, -16, 24, 25,
                                   31, 32, 40, 41, 47, 48])
def test_parse_wbits_equals_reference(wbits):
    def parse(mod):
        try:
            return mod._parse_wbits(wbits)
        except zlib.error as e:
            return str(e)

    assert parse(zc) == parse(ref_zc)


@pytest.mark.parametrize("wbits", [15, -15, 31])
@pytest.mark.parametrize("level", [6, 0, -1], ids=["L6", "L0", "default"])
def test_zlib_compress_equals_reference(level, wbits):
    got = zc.compress(DATA, level, wbits=wbits, device="cpu")
    assert got == ref_zc.compress(DATA, level, wbits=wbits)
    assert zlib.decompress(got, wbits) == DATA
    assert zc.decompress(got, wbits) == DATA
    if wbits > 0:
        assert zc.decompress(got, wbits=47) == DATA  # auto-detect


@pytest.mark.parametrize("level", [1, 6, 9])
def test_zlib_compress_native_engine_equals_reference(level):
    got = zc.compress(DATA + NOISE, level, wbits=31, engine="native")
    assert got == ref_zc.compress(DATA + NOISE, level, wbits=31,
                                  engine="native")
    assert zlib.decompress(got, 31) == DATA + NOISE


def test_zlib_decompress_errors_like_reference():
    blob = bytearray(zlib.compress(DATA, 6))
    blob[30] ^= 0xFF
    for mod in (zc, ref_zc):
        with pytest.raises(zlib.error):
            mod.decompress(bytes(blob))
        with pytest.raises(zlib.error):
            mod.compress(b"x", 6, wbits=0)
        with pytest.raises(zlib.error):
            mod.compress(b"x", 10)
        with pytest.raises(zlib.error):
            mod.compressobj(6, method=9)
    stdlib = zlib.compress(DATA, 9)
    assert zc.decompress(stdlib) == ref_zc.decompress(stdlib) == DATA


def _compressobj_run(mod, **kw):
    """compressobj through SYNC, PARTIAL, FULL, BLOCK and a copy that
    diverges; every return value, in order."""
    kw = dict(kw, **({"device": "cpu"} if mod is zc else {}))
    co = mod.compressobj(6, mod.DEFLATED, 31 if "zdict" not in kw else 15,
                         **kw)
    outs = [co.compress(DATA[:20000]), co.flush(mod.Z_SYNC_FLUSH),
            co.compress(DATA[20000:30001]), co.flush(mod.Z_PARTIAL_FLUSH),
            co.compress(DATA[30001:31000]), co.flush(mod.Z_BLOCK)]
    c2 = co.copy()
    outs += [co.compress(DATA[31000:45000]), co.flush(mod.Z_FULL_FLUSH),
             co.compress(DATA[45000:]), co.flush()]
    outs += [c2.compress(NOISE[:5000]), c2.flush(mod.Z_FINISH)]
    return outs


@pytest.mark.parametrize("zdict", [None, DATA[-4096:]], ids=["plain", "zdict"])
def test_compressobj_equals_reference(zdict):
    kw = {} if zdict is None else {"zdict": zdict}
    got = _compressobj_run(zc, **kw)
    assert got == _compressobj_run(ref_zc, **kw)
    main, clone = b"".join(got[:10]), b"".join(got[:6] + got[10:])
    if zdict is None:
        assert std_gzip.decompress(main) == DATA
        assert std_gzip.decompress(clone) == DATA[:31000] + NOISE[:5000]
    else:
        d = zlib.decompressobj(zdict=zdict)
        assert d.decompress(main) + d.flush() == DATA


@pytest.mark.parametrize("wbits", [15, 31, 47, -15])
def test_decompressobj_equals_reference(wbits):
    fmt_wbits = {47: 31}.get(wbits, wbits)
    blob = zlib.compressobj(6, zlib.DEFLATED, fmt_wbits)
    blob = blob.compress(DATA) + blob.flush() + b"TRAILING"

    def run(mod):
        do = mod.decompressobj(wbits)
        assert not do.eof and do.unused_data == b"" and do.flush() == b""
        outs = [do.decompress(blob[:977]), do.decompress(blob[977:5000], 100)]
        d2 = do.copy()
        outs += [do.decompress(blob[5000:]), do.flush(), do.eof,
                 do.unused_data, do.unconsumed_tail,
                 d2.decompress(b""), d2.decompress(blob[5000:]), d2.eof]
        return outs

    got = run(zc)
    assert got == run(ref_zc)
    assert b"".join(got[:4]) == DATA


def test_decompressobj_zdict_and_errors_like_reference():
    zdict = DATA[:4096]
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY,
                         zdict)
    blob = c.compress(DATA[4096:30000]) + c.flush()
    for mod in (zc, ref_zc):
        do = mod.decompressobj(zdict=zdict)
        assert do.decompress(blob) + do.flush() == DATA[4096:30000]
        with pytest.raises(zlib.error):
            mod.decompressobj().decompress(blob)  # needs the dictionary
        bad = bytearray(blob)
        bad[40] ^= 0x55
        with pytest.raises(zlib.error):
            mod.decompressobj(zdict=zdict).decompress(bytes(bad))


def test_checksums_are_the_c_runtime():
    """adler32/crc32 are the port's C functions (no stdlib fallback), and
    agree with stdlib and the reference on seeds and buffer types."""
    assert zc.adler32 is native.adler32 and zc.crc32 is native.crc32
    for buf in (b"", b"abc", DATA, bytearray(NOISE), memoryview(DATA)):
        for seed in (None, 0, 1, 0xDEADBEEF):
            for fn in ("adler32", "crc32"):
                args = (buf,) if seed is None else (buf, seed)
                want = getattr(zlib, fn)(*args)
                assert getattr(zc, fn)(*args) == want
                assert getattr(ref_zc, fn)(*args) == want


def test_facades_default_to_the_card(tmp_path):
    _no_card()
    with pytest.raises(RuntimeError):
        zc.compress(DATA)
    with pytest.raises(RuntimeError):
        zc.compressobj()
    with pytest.raises(RuntimeError):
        gz.compress(DATA, engine="device")
    # A refused device leaves no file behind.
    with pytest.raises(RuntimeError):
        gz.open(tmp_path / "x.gz", "wb", engine="device")
    assert not (tmp_path / "x.gz").exists()


# ---------------------------------------------------------------------------
# gzip_compat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "level, engine", [(1, "native"), (6, "native"), (9, "native"),
                      (6, "device"), (0, "device")],
)
def test_gzip_compress_equals_reference(level, engine):
    data = DATA + NOISE
    kw = {"device": "cpu"} if engine == "device" else {}
    got = gz.compress(data, level, mtime=5, engine=engine, **kw)
    exp = ref_gz.compress(data, level, mtime=5,
                          engine={"device": "tpu"}.get(engine, engine))
    assert got == exp
    assert std_gzip.decompress(got) == data
    assert gz.decompress(got) == data


def test_gzip_mtime_none_is_now():
    t0 = int(time.time())
    b = gz.compress(b"x", mtime=None)
    assert t0 <= struct.unpack("<I", b[4:8])[0] <= t0 + 5
    assert std_gzip.decompress(b) == b"x"


@pytest.mark.parametrize("blob", [
    std_gzip.compress(DATA, mtime=0)[:-5],
    b"\x1f\x8bnot really a gzip stream at all....",
    std_gzip.compress(DATA[:1000], mtime=0)[:-8] + b"\x00" * 8,
], ids=["truncated", "garbage", "bad-crc"])
def test_gzip_decompress_errors_like_reference(blob):
    for mod in (gz, ref_gz):
        with pytest.raises(mod.BadGzipFile):
            mod.decompress(blob)
    assert issubclass(gz.BadGzipFile, OSError)


@pytest.mark.parametrize("engine", ["native", "device"])
def test_gzipfile_write_equals_reference(tmp_path, engine):
    """1 MiB-style writes in pieces, a flush() between them; the file
    bytes equal the reference's and stdlib reads them."""
    data = DATA + NOISE
    paths = []
    for mod, eng, kw in ((gz, engine, {"device": "cpu"}),
                         (ref_gz, {"device": "tpu"}.get(engine, engine), {})):
        p = tmp_path / f"{mod.__name__}.gz"
        with mod.GzipFile(p, "wb", compresslevel=6, mtime=0, engine=eng,
                          **kw) as f:
            for i in range(0, len(data), 30001):
                assert f.write(data[i : i + 30001]) == len(data[i : i + 30001])
                if i == 30001:
                    f.flush()
        paths.append(p.read_bytes())
    assert paths[0] == paths[1]
    with std_gzip.open(tmp_path / f"{gz.__name__}.gz", "rb") as f:
        assert f.read() == data


def test_gzipfile_read_and_text_mode(tmp_path):
    p = tmp_path / "m.gz"
    p.write_bytes(std_gzip.compress(DATA[:7000]) + std_gzip.compress(DATA[7000:]))
    for mod in (gz, ref_gz):
        with mod.open(p, "rb") as f:
            got = bytearray()
            while piece := f.read(12345):
                got += piece
        assert bytes(got) == DATA
        assert f.closed
    q = tmp_path / "t.gz"
    with gz.open(q, "wt", encoding="utf-8") as f:
        f.write("line one\nline two\n")
    with std_gzip.open(q, "rt", encoding="utf-8") as f:
        assert f.read() == "line one\nline two\n"
    with gz.open(q, "rt", encoding="utf-8") as f:
        assert f.read() == "line one\nline two\n"
    with gz.GzipFile(fileobj=io.BytesIO(b""), mode="rb") as g:
        assert g.read() == b""
    with pytest.raises(ValueError):
        gz.open(q, "rb", encoding="utf-8")
    with pytest.raises(gz.BadGzipFile):
        with gz.GzipFile(fileobj=io.BytesIO(std_gzip.compress(DATA)[:-3]),
                         mode="rb") as g:
            g.read()
    with pytest.raises(OSError):
        gz.GzipFile(fileobj=io.BytesIO(), mode="rb").write(b"x")


# ---------------------------------------------------------------------------
# utils/resume
# ---------------------------------------------------------------------------

def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_resume_equals_reference_and_recovers(tmp_path):
    data = DATA[:20000] + NOISE[:3000]
    kw = dict(shard_bytes=8192, level=6, chunk_bytes=4096)
    mine, ref = tmp_path / "port", tmp_path / "ref"
    m = resume.compress_to_dir(data, str(mine), device="cpu", **kw)
    assert m == ref_resume.compress_to_dir(data, str(ref), **kw)
    assert _files(mine) == _files(ref)
    assert resume.missing_shards(str(mine)) == []
    # Lose a shard: only it is encoded again, to the same bytes.
    lost = mine / "shard_000001.seg"
    kept = lost.read_bytes()
    lost.unlink()
    assert resume.missing_shards(str(mine)) == [1]
    resume.compress_to_dir(data, str(mine), device="cpu", **kw)
    assert lost.read_bytes() == kept
    for fmt, dec in (("gzip", lambda b: zlib.decompress(b, 31)),
                     ("zlib", zlib.decompress),
                     ("raw", lambda b: zlib.decompress(b, -15))):
        blob = resume.assemble(str(mine), format=fmt)
        assert blob == ref_resume.assemble(str(ref), format=fmt)
        assert dec(blob) == data
    assert resume.missing_shards(str(tmp_path / "none")) == []


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_compress_decompress_range(tmp_path, capsys):
    data = DATA[:20000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    out = tmp_path / "out.gz"
    assert cli.main(["--device", "cpu", "compress", str(src), "-o", str(out),
                     "-l", "6", "--chunk-bytes", "4096", "--seekable"]) == 0
    line = json.loads(capsys.readouterr().err)
    assert line["op"] == "compress" and line["bytes_in"] == len(data)
    blob = out.read_bytes()
    assert blob == zf.compress(data, level=6, chunk_bytes=4096, indexed=True,
                               seekable=True, format="gzip")
    back = tmp_path / "back.bin"
    assert cli.main(["decompress", str(out), "-o", str(back)]) == 0
    assert back.read_bytes() == data
    part = tmp_path / "part.bin"
    assert cli.main(["range", str(out), "5000", "7000", "-o", str(part)]) == 0
    assert part.read_bytes() == data[5000:12000]
    nat = tmp_path / "nat.z"
    assert cli.main(["compress", str(src), "-o", str(nat), "-f", "zlib",
                     "--engine", "native", "-l", "9"]) == 0
    assert nat.read_bytes() == zf.compress(data, level=9, engine="native")
    capsys.readouterr()


@pytest.mark.parametrize("fmt", ["gzip", "zlib"])
def test_cli_decompress_engine_device(tmp_path, capsys, fmt):
    """decompress --engine device on --device cpu gives the reference
    CLI's bytes: an indexed gzip stream (the port's compress) and a
    foreign zlib stream (stdlib), beside the reference's own engines."""
    from zzflate_tpu import cli as ref_cli

    data = DATA[:40000]
    src = tmp_path / f"in.{fmt}"
    if fmt == "gzip":
        src.write_bytes(zt.compress(data, level=6, format="gzip",
                                    chunk_bytes=4096, indexed=True,
                                    device="cpu"))
        ref_engine = "native"  # its engine="tpu" would compile its CRC
    else:
        src.write_bytes(zlib.compress(data, 6))
        ref_engine = "tpu"
    out = tmp_path / "out.bin"
    assert cli.main(["--device", "cpu", "decompress", "-f", fmt, "--engine",
                     "device", str(src), "-o", str(out)]) == 0
    line = json.loads(capsys.readouterr().err)
    assert line["op"] == "decompress" and line["bytes_out"] == len(data)
    exp = tmp_path / "exp.bin"
    assert ref_cli.main(["decompress", "-f", fmt, "--engine", ref_engine,
                         str(src), "-o", str(exp)]) == 0
    capsys.readouterr()
    assert out.read_bytes() == exp.read_bytes() == data


def test_cli_bench_on_files(tmp_path, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(DATA[:20000])
    assert cli.main(["--device", "cpu", "bench", str(src), "--chunk-bytes",
                     "4096", "--reps", "1", "-l", "1"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu" and report["bytes_in"] == 20000
    assert report["bytes_out"] == len(zf.compress(
        DATA[:20000], level=1, format="gzip", chunk_bytes=4096))


def test_cli_defaults_to_the_card_and_stands_alone(tmp_path):
    """The CLI imports neither the reference's bench.py nor jax, and its
    default device is CUDA."""
    tree = ast.parse((ROOT / "zzflate_tpu_torch" / "cli.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert "bench" not in names
    assert not any(n.split(".")[0] in ("jax", "zzflate_tpu") for n in names)
    with pytest.raises(SystemExit):
        cli.main(["decompress", "x", "--engine", "tpu"])
    _no_card()
    src = tmp_path / "in.bin"
    src.write_bytes(b"abc")
    with pytest.raises(RuntimeError):
        cli.main(["compress", str(src), "-o", str(tmp_path / "o")])
    z = tmp_path / "in.z"
    z.write_bytes(zlib.compress(b"abc" * 100))
    with pytest.raises(RuntimeError):
        cli.main(["decompress", str(z), "-f", "zlib", "--engine", "device",
                  "-o", str(tmp_path / "o")])
