"""Drop-in facade with the stdlib ``gzip`` module's surface.

Port of ``zzflate_tpu/gzip_compat.py``: ``import
zzflate_tpu_torch.gzip_compat as gzip`` keeps gzip-module code working
with this codec underneath: ``compress``/``decompress``, ``open`` and a
file object ``GzipFile`` (read and write modes) on the streaming layer
(``stream.Compressor``/``stream.Decompressor``). Multi-member streams
decode across members (RFC 1952), as stdlib's do.

engine="native" (the default here, as in the reference) runs the host C
encoder; engine="device" runs the pipeline on `device` (None means CUDA
and raises RuntimeError without a card; "cpu" takes the plain torch
path). Decoding runs the port's C decoder.
"""
from __future__ import annotations

import builtins
import io
import time

from zzflate_tpu_torch import stream as _stream

__all__ = [
    "BadGzipFile", "GzipFile", "open", "compress", "decompress",
]


class BadGzipFile(OSError):
    """Mirror of gzip.BadGzipFile."""


def _mtime_field(mtime) -> int:
    """stdlib contract: None -> the current time, else the given seconds."""
    if mtime is None:
        return int(time.time())
    return int(mtime)


def compress(data, compresslevel: int = 9, *, mtime=None,
             engine: str = "native", device=None) -> bytes:
    c = _stream.Compressor(
        level=compresslevel, format="gzip", engine=engine,
        mtime=_mtime_field(mtime), device=device,
    )
    return c.compress(bytes(data)) + c.flush(_stream.Z_FINISH)


def decompress(data) -> bytes:
    d = _stream.Decompressor(format="gzip")
    try:
        out = d.decompress(bytes(data))
        out += d.flush()
    except ValueError as e:
        raise BadGzipFile(str(e)) from e
    if not d.eof:
        raise BadGzipFile("compressed stream ended prematurely")
    return out


class GzipFile(io.RawIOBase):
    """File object over a gzip stream (a subset of gzip.GzipFile).

    Supports 'rb' (incremental decode by stream.Decompressor) and
    'wb'/'ab'/'xb' (incremental encode by stream.Compressor).
    """

    def __init__(self, filename=None, mode: str | None = None,
                 compresslevel: int = 9, fileobj=None, mtime=None,
                 engine: str = "native", device=None):
        mode = mode or "rb"
        if "t" in mode or "U" in mode:
            raise ValueError(f"Invalid mode: {mode!r}")
        if "b" not in mode:
            mode += "b"
        # The encoder is made before the file is opened, so a refused
        # device leaves no file behind.
        reading = "r" in mode
        if not reading:
            self._comp = _stream.Compressor(
                level=compresslevel, format="gzip", engine=engine,
                mtime=_mtime_field(mtime), device=device,
            )
        self._own_fp = fileobj is None
        if fileobj is None:
            if filename is None:
                raise ValueError("either filename or fileobj required")
            fileobj = builtins.open(filename, mode)
        self._fp = fileobj
        self.name = filename or getattr(fileobj, "name", "")
        self._reading = reading
        self._closed = False
        if reading:
            self._dec = _stream.Decompressor(format="gzip")
            self._pending = bytearray()
            self._eof = False
            self._any_input = False

    # -- write side ---------------------------------------------------------

    def write(self, data) -> int:
        if self._reading:
            raise OSError("write() on read-only GzipFile")
        if self._closed:
            raise ValueError("I/O operation on closed file")
        self._fp.write(self._comp.compress(bytes(data)))
        return len(data)

    def flush(self) -> None:
        if not self._reading and not self._closed:
            self._fp.write(self._comp.flush(_stream.Z_SYNC_FLUSH))
            self._fp.flush()

    # -- read side ----------------------------------------------------------

    def _fill(self, want: int) -> None:
        while not self._eof and len(self._pending) < want:
            raw = self._fp.read(65536)
            try:
                if raw:
                    self._any_input = True
                    self._pending += self._dec.decompress(raw)
                else:
                    if not self._any_input:
                        # A zero-byte file is end of stream before any
                        # member (stdlib returns b''), not a truncation.
                        self._eof = True
                        break
                    self._pending += self._dec.flush()
                    if not self._dec.eof:
                        raise BadGzipFile(
                            "compressed stream ended prematurely"
                        )
                    self._eof = True
            except ValueError as e:
                raise BadGzipFile(str(e)) from e

    def read(self, size: int = -1) -> bytes:
        if not self._reading:
            raise OSError("read() on write-only GzipFile")
        if size is None or size < 0:
            self._fill(1 << 62)
            out = bytes(self._pending)
            self._pending.clear()
            return out
        self._fill(size)
        out = bytes(self._pending[:size])
        del self._pending[:size]
        return out

    def readable(self) -> bool:
        return self._reading

    def writable(self) -> bool:
        return not self._reading

    def close(self) -> None:
        if self._closed:
            return
        try:
            if not self._reading:
                self._fp.write(self._comp.flush(_stream.Z_FINISH))
        finally:
            self._closed = True
            if self._own_fp:
                self._fp.close()
        super().close()


def open(filename, mode: str = "rb", compresslevel: int = 9,
         encoding=None, errors=None, newline=None, engine: str = "native",
         device=None):
    """gzip.open subset: binary modes give a GzipFile; text modes wrap it
    in a TextIOWrapper (the stdlib contract)."""
    if "t" in mode:
        binary = GzipFile(
            filename, mode.replace("t", "b"), compresslevel, engine=engine,
            device=device,
        )
        return io.TextIOWrapper(binary, encoding, errors, newline)
    if encoding or errors or newline:
        raise ValueError("encoding args invalid for binary mode")
    return GzipFile(filename, mode, compresslevel, engine=engine,
                    device=device)
