"""Public one-shot API: compress, compress_bound, decompress and
decompress_range.

Port of ``zzflate_tpu/api.py``. Bytes in, bytes out, with the
reference's level, format, dictionary, window_bits, mem_level, strategy,
engine and indexed/seekable options. Container checksums use the stdlib
``zlib`` functions: they are host framing, not compression.

Device rule: ``compress(device=None)`` and ``decompress(engine="device",
device=None)`` mean CUDA and raise RuntimeError when no GPU is present;
only an explicit ``device="cpu"`` runs the plain torch versions of the
kernels on the CPU. ``engine="native"`` (decompress's default) runs on
the host, in the port's C runtime.
"""
from __future__ import annotations

import struct
import zlib as _zlib

import torch

from zzflate_tpu_torch import config as cfg_mod
from zzflate_tpu_torch import native
from zzflate_tpu_torch.config import CodecConfig
from zzflate_tpu_torch.devices import resolve_device
from zzflate_tpu_torch.encode_pipeline import encode_segments
from zzflate_tpu_torch.models import inflate, inflate_device
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils.profiling import maybe_stage


def compress_bound(n: int, format: str = "zlib") -> int:
    """Worst-case compressed size (stored fallback bound), zlib.h:760 shape."""
    overhead = {"raw": 0, "zlib": 2 + 4 + 4, "gzip": 10 + 8}[format]
    return n + 5 * (n // 65535 + 1) + 2 + overhead


def _check_options(config: CodecConfig, dictionary, indexed: bool,
                   seekable: bool) -> None:
    """The option checks of every one-shot device encode."""
    if dictionary is not None and config.format == "gzip":
        raise ValueError("gzip streams cannot carry a preset dictionary")
    if indexed and config.format != "gzip":
        raise ValueError("indexed output requires format='gzip'")
    if seekable and not indexed:
        raise ValueError("seekable output requires indexed=True")
    if indexed and config.level == 0:
        raise ValueError("indexed output requires level >= 1")


def _stream_checksums(enc: dict, n: int, chunk_bytes: int) -> tuple[int, int]:
    """The Adler-32 and CRC-32 of n bytes, combined in chunk order from
    encode_segments(with_checksums=True)'s per-chunk partials."""
    nchunks = max(1, -(-n // chunk_bytes))
    lens = [min(chunk_bytes, n - i * chunk_bytes) for i in range(nchunks)]
    return (containers.combine_adler(list(zip(enc["adler"], lens))),
            containers.combine_crc(list(zip(enc["crc"], lens))))


def _host_check(fn, data: bytes) -> int:
    """fn(data), a container checksum pass over the input on the host."""
    with maybe_stage("frame_checksum"):
        return fn(data)


def _frame(data: bytes, config: CodecConfig, dictionary, payload: bytes,
           index: dict | None = None, seekable: bool = False,
           cks: tuple[int, int] | None = None) -> bytes:
    """Wrap a raw deflate payload of `data` in config.format's container.
    index: encode_segments' result, for an indexed gzip header. cks: the
    stream's (Adler-32, CRC-32) from the devices' partials; None reads
    them from `data` here."""
    if config.format == "raw":
        return payload
    if config.format == "zlib":
        dictid = _zlib.adler32(dictionary) if dictionary is not None else None
        adler = cks[0] if cks is not None else _host_check(_zlib.adler32,
                                                           data)
        return (
            containers.zlib_header(config.level, dictid, config.window_bits)
            + payload
            + containers.zlib_trailer(adler)
        )
    if index is not None:
        hdr = containers.gzip_header_indexed(
            config.chunk_bytes,
            list(zip((len(s) for s in index["segments"]), index["blocks"],
                     index["anchors"])),
            flags=containers.ZZ_FLAG_SEEKABLE if seekable else 0,
        )
    else:
        hdr = containers.gzip_header()
    crc = cks[1] if cks is not None else _host_check(_zlib.crc32, data)
    return hdr + payload + containers.gzip_trailer(crc, len(data))


def _compress_on(data: bytes, config: CodecConfig, dictionary,
                 devices: list, indexed: bool = False, seekable: bool = False,
                 card_checksums: bool = False) -> bytes:
    """The device engine of a one-shot compress over `devices` (one
    device, or a mesh: encode_segments), framed. card_checksums takes the
    trailer from the devices' per-chunk partials instead of a host pass
    over `data`."""
    index = cks = enc = None
    if config.level != 0:
        enc = encode_segments(
            data, config, dictionary, devices, with_anchors=indexed,
            halo=not seekable, with_checksums=card_checksums,
        )
    with maybe_stage("frame"):
        if enc is None:
            payload = containers.stored_segment(data, final=True)
        else:
            payload = b"".join(enc["segments"])
            if card_checksums:
                cks = _stream_checksums(enc, len(data), config.chunk_bytes)
            if indexed:
                index = enc
            else:
                # Whole-stream stored fallback: per-chunk sync-flush
                # framing adds ~5 bytes/chunk, so incompressible inputs
                # could otherwise exceed compress_bound. Indexed streams
                # keep their per-chunk layout.
                stored_whole = containers.stored_segment(data, final=True)
                if len(stored_whole) < len(payload):
                    payload = stored_whole
        return _frame(data, config, dictionary, payload, index, seekable,
                      cks)


def compress(
    data: bytes,
    level: int = 6,
    format: str = "zlib",
    dictionary: bytes | None = None,
    chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
    strategy: int = cfg_mod.STRATEGY_DEFAULT,
    indexed: bool = False,
    window_bits: int = 15,
    mem_level: int = 8,
    seekable: bool = False,
    device: str | torch.device | None = None,
    engine: str = "device",
) -> bytes:
    """One-shot compress to a zlib/gzip/raw stream (decodable by zlib).

    indexed=True (gzip only) adds a 'ZZ' FEXTRA subfield with the
    per-chunk compressed sizes, block and anchor offsets; seekable=True
    (requires indexed) also resets the LZ window at every chunk boundary
    so any chunk decodes from its own segment. window_bits 8..15 bounds
    match distances to 2^window_bits. Levels 7-9 re-parse each chunk
    with the C shortest-bit-path DP over the device's matches.

    engine="device" (default) runs the pipeline on `device`;
    engine="native" runs the host C encoder in chunks of at least 1 MiB
    on a thread pool, never touches the card (`device` is unused) and
    does not write indexed streams.
    """
    data = bytes(data)
    config = CodecConfig(
        level=level, format=format, chunk_bytes=chunk_bytes,
        strategy=strategy, window_bits=window_bits, mem_level=mem_level,
    )
    _check_options(config, dictionary, indexed, seekable)
    if engine not in ("device", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "device":
        return _compress_on(data, config, dictionary,
                            [resolve_device(device)], indexed, seekable)
    if indexed:
        raise ValueError("indexed output requires engine='device'")
    if level == 0:
        payload = containers.stored_segment(data, final=True)
    else:
        # Output bytes depend only on (data, parameters), never on the
        # machine's core count (deflate_raw_mt's contract).
        payload = native.deflate_raw_mt(
            data, level=level, dictionary=dictionary or b"",
            max_dist=min(32768, 1 << config.window_bits), final=True,
            strategy=strategy, chunk_bytes=max(chunk_bytes, 1 << 20),
        )
        # Whole-stream stored fallback keeps the compress_bound contract.
        stored_whole = containers.stored_segment(data, final=True)
        if len(stored_whole) < len(payload):
            payload = stored_whole
    return _frame(data, config, dictionary, payload)


def decompress(data: bytes, format: str = "zlib",
               dictionary: bytes | None = None, engine: str = "native",
               device: str | torch.device | None = None) -> bytes:
    """One-shot decode of a zlib/gzip/raw stream, checksums verified;
    ValueError on a bad stream.

    engine="native" (default) decodes on the host with the C decoder
    (`device` is unused). engine="device" decodes on `device` through
    the anchor walk (models/inflate_device): an indexed gzip stream
    first, then any stream without a preset dictionary after the host
    pre-scan, which for a gzip file without an index covers every
    member, so a multi-member or BGZF file decodes whole on the card;
    the host decoder takes only the streams the device path declines (no
    index and a dictionary, all-stored, size caps, one block larger than
    a group, corrupt deflate data) and the members after an indexed one.
    On the card a gzip stream's CRC-32 and a zlib stream's Adler-32 are
    computed there and held to the trailer, as they are with
    to_device=True. device=None means CUDA and raises RuntimeError
    without a card."""
    data = bytes(data)
    if engine not in ("device", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "device":
        dev = resolve_device(device)
        if format == "gzip":
            out = inflate_device.decompress_indexed(data, device=dev)
            if out is not None:
                return out
        if dictionary is None:
            out = inflate_device.decompress_foreign(data, format=format,
                                                    device=dev)
            if out is not None:
                return out
    return inflate.decompress(data, format=format, dictionary=dictionary)


def decompress_range(data: bytes, offset: int, length: int) -> bytes:
    """Read [offset, offset+length) of an indexed gzip stream without
    decoding the whole member.

    Seekable streams decode only the chunks covering the range;
    halo-encoded indexed streams decode the chunks up to the range's
    end. Unindexed streams are decoded whole and sliced. Checksums are
    not verified on partial reads (the gzip CRC covers the whole
    member); use decompress() for a verified full read."""
    data = bytes(data)
    if offset < 0 or length < 0:
        raise ValueError("offset/length must be non-negative")
    parsed = containers.parse_gzip_index(data)
    if parsed is None:
        out = inflate.decompress(data, format="gzip")
        if offset + length > len(out):
            raise ValueError("range beyond the decoded stream")
        return out[offset : offset + length]
    header_len, chunk_bytes, _anchor_tokens, chunks = parsed
    member_len = header_len + sum(sz for sz, _b, _a in chunks) + 8
    if member_len > len(data):
        raise ValueError("indexed stream shorter than its index")
    (isize,) = struct.unpack("<I", data[member_len - 4 : member_len])
    if offset + length > isize:
        raise ValueError("range beyond the decoded stream")
    if length == 0:
        return b""
    flags = containers.gzip_index_flags(data) or 0
    seekable = bool(flags & containers.ZZ_FLAG_SEEKABLE)

    c0 = offset // chunk_bytes
    c1 = min(len(chunks), -(-(offset + length) // chunk_bytes))
    lo = c0 if seekable else 0
    starts = []
    cpos = header_len
    for sz, _b, _a in chunks:
        starts.append(cpos)
        cpos += sz
    window = b""
    parts: list[bytes] = []
    for ci in range(lo, c1):
        seg = data[starts[ci] : starts[ci] + chunks[ci][0]]
        expect = min(chunk_bytes, isize - ci * chunk_bytes)
        out, _bit, _fin, _more = native.inflate_stream(
            seg, window=window, out_cap_hint=expect + 16
        )
        if len(out) != expect:
            raise ValueError("indexed segment decoded to the wrong size")
        if not seekable:
            # The encode halo is the last 32 KiB of all prior data, which
            # spans several chunks when chunk_bytes < 32 KiB.
            window = (window + out)[-32768:]
        if ci >= c0:
            parts.append(out)
    blob = b"".join(parts)
    rel = offset - c0 * chunk_bytes
    return blob[rel : rel + length]
