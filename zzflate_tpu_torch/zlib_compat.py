"""Drop-in facade with the stdlib ``zlib`` module's surface.

Port of ``zzflate_tpu/zlib_compat.py``: ``import
zzflate_tpu_torch.zlib_compat as zlib`` keeps zlib-module code working,
with the port's pipeline underneath. The one-shot and streaming entry
points, flush constants, checksums and ``compressobj``/``decompressobj``
objects mirror the stdlib names and semantics. wbits follows
zlib.h:551-580: 9..15 zlib container, negative raw deflate, +16 gzip, +32
on decompress auto-detects zlib or gzip.

Extensions over the stdlib signatures: ``engine`` ("device", the
default, or "native", the host C encoder) and ``device`` (None means
CUDA and raises RuntimeError without a card; "cpu" takes the plain torch
path).
"""
from __future__ import annotations

import zlib as _zlib

from zzflate_tpu_torch import api as _api
from zzflate_tpu_torch import config as _cfg
from zzflate_tpu_torch import stream as _stream
from zzflate_tpu_torch.native import adler32, crc32  # noqa: F401  (the C runtime)

# Constants (stdlib names).
MAX_WBITS = 15
DEFLATED = 8
DEF_MEM_LEVEL = 8
DEF_BUF_SIZE = 16384
Z_NO_FLUSH = _stream.Z_NO_FLUSH
Z_PARTIAL_FLUSH = 1
Z_SYNC_FLUSH = _stream.Z_SYNC_FLUSH
Z_FULL_FLUSH = _stream.Z_FULL_FLUSH
Z_FINISH = _stream.Z_FINISH
Z_BLOCK = _stream.Z_BLOCK
Z_NO_COMPRESSION = 0
Z_BEST_SPEED = 1
Z_BEST_COMPRESSION = 9
Z_DEFAULT_COMPRESSION = -1
Z_DEFAULT_STRATEGY = _cfg.STRATEGY_DEFAULT
Z_FILTERED = _cfg.STRATEGY_FILTERED
Z_HUFFMAN_ONLY = _cfg.STRATEGY_HUFFMAN_ONLY
Z_RLE = _cfg.STRATEGY_RLE
Z_FIXED = _cfg.STRATEGY_FIXED

error = _zlib.error

ZLIB_VERSION = "1.2.13-zzflate-tpu-torch"
ZLIB_RUNTIME_VERSION = ZLIB_VERSION


def _parse_wbits(wbits: int):
    """-> (format, window_bits, auto_detect), zlib.h:551-580."""
    if -15 <= wbits <= -9:
        return "raw", -wbits, False
    if 9 <= wbits <= 15:
        return "zlib", wbits, False
    if 25 <= wbits <= 31:
        return "gzip", wbits - 16, False
    if 41 <= wbits <= 47:  # +32: auto-detect zlib or gzip on decompress
        return "zlib", wbits - 32, True
    raise error(f"invalid wbits {wbits}")


def _level(level: int) -> int:
    if level == Z_DEFAULT_COMPRESSION:
        return 6
    if not 0 <= level <= 9:
        raise error(f"invalid compression level {level}")
    return level


def compress(data, /, level: int = Z_DEFAULT_COMPRESSION,
             wbits: int = MAX_WBITS, engine: str = "device",
             device=None) -> bytes:
    fmt, wb, _ = _parse_wbits(wbits)
    return _api.compress(
        bytes(data), level=_level(level), format=fmt, window_bits=wb,
        engine=engine, device=device,
    )


def decompress(data, /, wbits: int = MAX_WBITS, bufsize: int = DEF_BUF_SIZE
               ) -> bytes:
    fmt, _, auto = _parse_wbits(wbits)
    data = bytes(data)
    if auto and data[:2] == b"\x1f\x8b":
        fmt = "gzip"
    try:
        return _api.decompress(data, format=fmt)
    except ValueError as e:
        raise error(str(e)) from e


def compressobj(level: int = Z_DEFAULT_COMPRESSION, method: int = DEFLATED,
                wbits: int = MAX_WBITS, memLevel: int = DEF_MEM_LEVEL,
                strategy: int = Z_DEFAULT_STRATEGY, zdict: bytes | None = None,
                engine: str = "device", device=None):
    if method != DEFLATED:
        raise error(f"unsupported method {method}")
    # As in the reference, the stream's window stays 32 KiB whatever
    # wbits' window size: only its container is read here.
    fmt, _wb, _ = _parse_wbits(wbits)
    return _CompressObj(
        _stream.Compressor(
            level=_level(level), format=fmt, dictionary=zdict,
            strategy=strategy, mem_level=memLevel, engine=engine,
            device=device,
        )
    )


def decompressobj(wbits: int = MAX_WBITS, zdict: bytes | None = None):
    fmt, _wb, auto = _parse_wbits(wbits)
    return _DecompressObj(fmt, zdict, auto)


class _CompressObj:
    """stdlib-shaped compressobj: compress()/flush(mode)/copy()."""

    def __init__(self, comp: _stream.Compressor):
        self._c = comp

    def compress(self, data) -> bytes:
        return self._c.compress(bytes(data))

    def flush(self, mode: int = Z_FINISH) -> bytes:
        if mode == Z_PARTIAL_FLUSH:
            mode = Z_SYNC_FLUSH  # zlib treats these near-identically
        return self._c.flush(mode)

    def copy(self):
        o = _CompressObj.__new__(_CompressObj)
        o._c = self._c.copy()
        return o


class _DecompressObj:
    """stdlib-shaped decompressobj over the incremental inflate."""

    def __init__(self, fmt: str, zdict: bytes | None, auto: bool):
        self._fmt = fmt
        self._zdict = zdict
        self._auto = auto
        self._d: _stream.Decompressor | None = None

    def _ensure(self, first: bytes) -> _stream.Decompressor:
        if self._d is None:
            fmt = self._fmt
            if self._auto and first[:2] == b"\x1f\x8b":
                fmt = "gzip"
            self._d = _stream.Decompressor(format=fmt, dictionary=self._zdict)
        return self._d

    def decompress(self, data, max_length: int = 0) -> bytes:
        d = self._ensure(bytes(data))
        try:
            return d.decompress(bytes(data), max_length=max_length)
        except ValueError as e:
            raise error(str(e)) from e

    def flush(self, length: int = 0) -> bytes:
        if self._d is None:
            return b""
        return self._d.flush(length)

    @property
    def eof(self) -> bool:
        return self._d.eof if self._d is not None else False

    @property
    def unused_data(self) -> bytes:
        return self._d.unused_data if self._d is not None else b""

    @property
    def unconsumed_tail(self) -> bytes:
        return self._d.unconsumed_tail if self._d is not None else b""

    def copy(self):
        o = _DecompressObj.__new__(_DecompressObj)
        o._fmt, o._zdict, o._auto = self._fmt, self._zdict, self._auto
        o._d = self._d.copy() if self._d is not None else None
        return o
