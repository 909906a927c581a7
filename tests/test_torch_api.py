"""zzflate_tpu_torch.compress(device="cpu") against zzflate_tpu.compress.

Every case must give byte-identical output (tolerance zero: the codec is
integer-only and deterministic) that also decodes with stdlib zlib. Plus
the package's rules: no JAX or reference import anywhere in the port or
in chip_smoke.py, and no path to the reference's C library; CUDA by
default. Levels 7-9 are in tests/test_torch_optimal.py.
"""
import ast
import hashlib
import pathlib
import zlib

import pytest
import torch

import zzflate_tpu as zf
import zzflate_tpu_torch as zt
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHUNK = 4096
DATA = mixed_corpus(20000, 31)
DICT = mixed_corpus(6000, 32)[-5000:]

CASES = {
    "zlib": dict(),
    "gzip": dict(format="gzip"),
    "raw": dict(format="raw"),
    "dictionary": dict(dictionary=DICT),
    "window-bits-9": dict(window_bits=9),
    "filtered": dict(strategy=1),
    "huffman-only": dict(strategy=2),
    "rle": dict(strategy=3),
    "fixed": dict(strategy=4),
    "indexed": dict(format="gzip", indexed=True),
    "seekable": dict(format="gzip", indexed=True, seekable=True),
}


def _decode(out, kw):
    fmt = kw.get("format", "zlib")
    if fmt == "raw":
        return zlib.decompress(out, wbits=-15)
    if fmt == "gzip":
        return zlib.decompress(out, wbits=31)
    d = zlib.decompressobj(zdict=kw["dictionary"]) if "dictionary" in kw \
        else zlib.decompressobj()
    return d.decompress(out) + d.flush()


def _same_bytes(data, level, chunk_bytes=CHUNK, **kw):
    exp = zf.compress(data, level=level, chunk_bytes=chunk_bytes, **kw)
    got = zt.compress(data, level=level, chunk_bytes=chunk_bytes,
                      device="cpu", **kw)
    assert got == exp
    assert _decode(got, kw) == data
    return got


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("level", [1, 6], ids=["L1", "L6"])
def test_compress_equals_reference(level, case):
    _same_bytes(DATA, level, **CASES[case])


@pytest.mark.parametrize(
    "data",
    [b"", b"x", mixed_corpus(70000, 33)],
    ids=["empty", "one-byte", "70000"],
)
@pytest.mark.parametrize("level", [1, 6], ids=["L1", "L6"])
def test_corner_inputs_equal_reference(level, data):
    _same_bytes(data, level)


@pytest.mark.parametrize(
    "case", ["zlib", "indexed"],
)
@pytest.mark.parametrize("level", [2, 3, 4, 5], ids=["L2", "L3", "L4", "L5"])
def test_middle_levels_equal_reference(level, case):
    """L2 and L5 scan at K=6 and K=12, L4-5 sort on 8 key words."""
    _same_bytes(DATA, level, **CASES[case])


@pytest.mark.parametrize("mem_level", [1, 2])
def test_multi_batch_equals_reference(mem_level):
    """mem_level 1 and 2 cut 70000 bytes at 4 KiB chunks into 3 and 2
    device batches."""
    _same_bytes(mixed_corpus(70000, 33), 6, mem_level=mem_level)


def test_level0_and_default_chunk_equal_reference():
    """Level 0 (stored) and one run at the default 256 KiB chunk, whose
    four sub-blocks per chunk are the main path's layout."""
    _same_bytes(DATA, 0)
    _same_bytes(mixed_corpus(300000, 34), 6, chunk_bytes=1 << 18,
                format="gzip", indexed=True)


def test_reference_digest():
    """chip_smoke.py holds the card's bytes to REF_SHA256_L6_4K; this is
    the JAX reference's digest of that same input."""
    import chip_smoke

    ref_in = mixed_corpus(chip_smoke.REF_INPUT_BYTES,
                          chip_smoke.REF_INPUT_SEED)
    out = _same_bytes(ref_in, 6)
    assert hashlib.sha256(out).hexdigest() == chip_smoke.REF_SHA256_L6_4K


def test_reference_digest_l9():
    """chip_smoke.py holds the card's bytes to REF_SHA256_L9_4K; this is
    the JAX reference's digest of that input at level 9, taken with the
    reference's C library built (without it the reference keeps the lazy
    parse)."""
    import chip_smoke
    from zzflate_tpu import native as jax_native

    assert jax_native.lib() is not None
    ref_in = mixed_corpus(chip_smoke.REF_INPUT_BYTES,
                          chip_smoke.REF_INPUT_SEED)
    out = _same_bytes(ref_in, 9)
    assert hashlib.sha256(out).hexdigest() == chip_smoke.REF_SHA256_L9_4K


@pytest.mark.parametrize("kind", ["adler", "crc"])
def test_checksum_combines_match_stdlib(kind):
    from zzflate_tpu_torch.utils import containers

    parts = [mixed_corpus(n, 40 + n)[:n] for n in (0, 1, 5000, 70000)]
    fn, combine = {
        "adler": (zlib.adler32, containers.combine_adler),
        "crc": (zlib.crc32, containers.combine_crc),
    }[kind]
    assert combine([(fn(p), len(p)) for p in parts]) == fn(b"".join(parts))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "zzflate_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "zzflate_tpu")
    ]
    assert not bad
    # Nor does any source name the reference's C library or its directory.
    sources = files + sorted((ROOT / "zzflate_tpu_torch").rglob("*.c"))
    named = [str(f.relative_to(ROOT)) for f in sources
             if "zzflate_tpu/native" in f.read_text()
             or "_libzzflate" in f.read_text()]
    assert not named


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError):
        zt.compress(b"x")
