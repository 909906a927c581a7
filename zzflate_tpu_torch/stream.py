"""Streaming compress/decompress with zlib's flush modes.

Port of ``zzflate_tpu/stream.py``. Mirrors the deflate(strm, flush)
contract (zlib.h:250):

- Z_NO_FLUSH buffers input and encodes each chunk as soon as it fills;
- Z_SYNC_FLUSH closes the current block and byte-aligns with an empty
  stored block (00 00 FF FF after alignment);
- Z_FULL_FLUSH also resets the window, so decoding can restart there;
- Z_BLOCK completes the pending blocks and stops at the block boundary,
  possibly mid-byte (zlib.h:170-173);
- Z_FINISH closes the stream (BFINAL block and container trailer).

Every chunk goes through the encode pipeline (engine="device": the card
by default, or the plain torch path with device="cpu") or the host C
encoder (engine="native"). Decoding runs the C streaming decoder. All
state is host bytes and integers, so ``copy`` is a field copy.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from zzflate_tpu_torch import config as cfg_mod
from zzflate_tpu_torch import native
from zzflate_tpu_torch.config import CodecConfig
from zzflate_tpu_torch.devices import resolve_device
from zzflate_tpu_torch.encode_pipeline import encode_segments
from zzflate_tpu_torch.utils import containers

Z_NO_FLUSH = 0
Z_SYNC_FLUSH = 2
Z_FULL_FLUSH = 3
Z_FINISH = 4
Z_BLOCK = 5

_WINDOW = 32768


class Compressor:
    """Incremental deflate encoder producing zlib/gzip/raw output.

    engine="device" runs each chunk on `device` (None means CUDA and
    raises RuntimeError without a card; "cpu" takes the plain torch
    path). engine="native" runs the host C encoder, which has no
    unframed mode: input flushed by Z_BLOCK, or while its sub-byte tail
    is pending, goes through the pipeline on `device`, resolved then, as
    in the reference's stream."""

    def __init__(
        self,
        level: int = 6,
        format: str = "zlib",
        dictionary: bytes | None = None,
        chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
        strategy: int = cfg_mod.STRATEGY_DEFAULT,
        mem_level: int = 8,
        engine: str = "device",
        mtime: int = 0,
        device=None,
    ):
        self.config = CodecConfig(
            level=level, format=format, chunk_bytes=chunk_bytes,
            strategy=strategy, mem_level=mem_level,
        )
        self._mtime = mtime
        if dictionary is not None and format == "gzip":
            raise ValueError("gzip streams cannot carry a preset dictionary")
        if engine not in ("device", "native"):
            raise ValueError(f"unknown engine {engine!r}")
        self._engine = engine
        self._device_arg = device
        self._device = resolve_device(device) if engine == "device" else None
        self._dictionary = dictionary
        self._window: bytes = (dictionary or b"")[-_WINDOW:]
        self._buf = bytearray()
        self._header_sent = False
        self._finished = False
        self._isize = 0
        self._adler = native.adler32(b"")
        self._crc = native.crc32(b"")
        # Sub-byte output state after a Z_BLOCK flush: the stream ends at
        # a block boundary mid-byte; _tail_n bits (LSB-first, in _tail_v's
        # low bits) are held back until later output realigns it.
        self._tail_v = 0
        self._tail_n = 0

    # -- internals ---------------------------------------------------------

    def _header(self) -> bytes:
        fmt = self.config.format
        if fmt == "raw":
            return b""
        if fmt == "zlib":
            dictid = (
                native.adler32(self._dictionary)
                if self._dictionary is not None
                else None
            )
            return containers.zlib_header(self.config.level, dictid)
        return containers.gzip_header(self._mtime)

    def _encode(self, payload: bytes, final: bool) -> bytes:
        """Encode `payload` as sync-flush-framed segments with the current
        window as halo; updates the window."""
        if self.config.level == 0:
            out = containers.stored_segment(payload, final=final)
        elif self._engine == "native":
            # The C encoder frames like the pipeline (a sync-flush empty
            # stored block when not final), so it drops in here.
            out = native.deflate_raw(
                payload, level=self.config.level,
                dictionary=self._window,
                max_dist=min(_WINDOW, 1 << self.config.window_bits),
                final=final, strategy=self.config.strategy,
            )
        else:
            out = b"".join(encode_segments(
                payload, self.config, self._window or None, [self._device],
                stream_final=final,
            )["segments"])
        self._window = (self._window + payload)[-_WINDOW:]
        return out

    # -- sub-byte emission (Z_BLOCK) ---------------------------------------

    def _emit_bits(self, payload: bytes, nbits: int) -> bytes:
        """Append nbits (LSB-first in payload's bytes, possibly ending
        mid-byte) through the sub-byte tail; returns the bytes now whole."""
        t = self._tail_n
        if t == 0 and nbits % 8 == 0:
            return payload
        arr = np.frombuffer(payload, np.uint8).astype(np.uint16)
        if t:
            joined = np.empty(len(arr) + 1, np.uint8)
            joined[0] = self._tail_v
            joined[1:] = (arr >> (8 - t)).astype(np.uint8)
            joined[:-1] |= ((arr << t) & 0xFF).astype(np.uint8)
        else:
            joined = arr.astype(np.uint8)
        total = t + nbits
        nfull = total // 8
        self._tail_n = total % 8
        self._tail_v = (
            int(joined[nfull]) & ((1 << self._tail_n) - 1)
            if self._tail_n
            else 0
        )
        return joined[:nfull].tobytes()

    def _sync_frame_bits(self) -> bytes:
        """Empty stored block at the current bit position: 3-bit header,
        zero pad to the byte boundary, then 00 00 FF FF. Realigns the
        stream (the tail becomes 0)."""
        out = self._emit_bits(b"\x00", 3)
        pad = (8 - self._tail_n) % 8
        if pad:
            out += self._emit_bits(b"\x00", pad)
        return out + containers.SYNC_FLUSH_MARKER

    def _encode_raw(self, payload: bytes, final: bool) -> bytes:
        """Bit-granular emission: encode payload's chunks unframed (no
        sync markers, no byte alignment between blocks: the Z_BLOCK
        contract) and join them through the tail."""
        if self.config.level == 0:
            # Stored blocks need byte alignment: realign first.
            out = self._sync_frame_bits() if self._tail_n else b""
            out += containers.stored_segment(payload, final=final)
            self._window = (self._window + payload)[-_WINDOW:]
            return out
        # The C encoder has no unframed mode: every engine takes the
        # pipeline here (as the reference's stream does).
        dev = self._device or resolve_device(self._device_arg)
        out = bytearray()
        for seg, nbits in encode_segments(
            payload, self.config, self._window or None, [dev],
            stream_final=final, frame=False,
        )["segments"]:
            out += self._emit_bits(seg, nbits)
        if final and self._tail_n:
            out += self._emit_bits(b"\x00", (8 - self._tail_n) % 8)
        self._window = (self._window + payload)[-_WINDOW:]
        return bytes(out)

    # -- public API ----------------------------------------------------------

    def compress(self, data: bytes) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        data = bytes(data)
        self._isize += len(data)
        self._adler = native.adler32(data, self._adler)
        self._crc = native.crc32(data, self._crc)
        self._buf += data
        out = bytearray()
        if not self._header_sent:
            out += self._header()
            self._header_sent = True
        cb = self.config.chunk_bytes
        while len(self._buf) >= cb:
            chunk = bytes(self._buf[:cb])
            del self._buf[:cb]
            if self._tail_n:
                # Mid-byte after a Z_BLOCK flush: join this chunk at bit
                # granularity, then realign with a sync frame so later
                # chunks take the byte-aligned path again.
                out += self._encode_raw(chunk, final=False)
                out += self._sync_frame_bits()
            else:
                out += self._encode(chunk, final=False)
        return bytes(out)

    def set_params(
        self, level: int | None = None, strategy: int | None = None
    ) -> bytes:
        """Re-tune compression mid-stream (deflateParams, zlib.h:705):
        pending input is flushed with the old parameters at a sync-flush
        point, and later input uses the new ones."""
        out = self.flush(Z_SYNC_FLUSH)
        changes = {}
        if level is not None:
            changes["level"] = level
        if strategy is not None:
            changes["strategy"] = strategy
        # replace keeps every field not named (window_bits among them).
        self.config = dataclasses.replace(self.config, **changes)
        return out

    def copy(self) -> "Compressor":
        """Independent clone of the whole encoder state (deflateCopy,
        zlib.h:630)."""
        c = object.__new__(Compressor)
        c.__dict__.update(self.__dict__)
        c._buf = bytearray(self._buf)
        return c

    def flush(self, mode: int = Z_SYNC_FLUSH) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        out = bytearray()
        if not self._header_sent:
            out += self._header()
            self._header_sent = True
        pending = bytes(self._buf)
        self._buf.clear()
        if mode == Z_FINISH:
            if self._tail_n:
                out += self._encode_raw(pending, final=True)
            else:
                out += self._encode(pending, final=True)
            fmt = self.config.format
            if fmt == "zlib":
                out += containers.zlib_trailer(self._adler)
            elif fmt == "gzip":
                out += containers.gzip_trailer(self._crc, self._isize)
            self._finished = True
        elif mode in (Z_SYNC_FLUSH, Z_FULL_FLUSH):
            if self._tail_n:
                if pending:
                    out += self._encode_raw(pending, final=False)
                out += self._sync_frame_bits()
            else:
                out += self._encode(pending, final=False)
            if mode == Z_FULL_FLUSH:
                self._window = b""  # decoding may restart here
        elif mode == Z_BLOCK:
            # Complete the pending blocks and stop at the block boundary:
            # no empty stored block, no byte alignment.
            if pending:
                out += self._encode_raw(pending, final=False)
        elif mode == Z_NO_FLUSH:
            self._buf += pending
        else:
            raise ValueError(f"unknown flush mode {mode}")
        return bytes(out)


class Decompressor:
    """Incremental inflate: the inflate(strm) state machine (zlib.h:400).

    Output comes as soon as complete deflate blocks are available;
    completed blocks are never decoded again, only the trailing partial
    block is retried. Corruption raises ValueError at the first bad
    block; truncated input buffers. Mirrors zlib.decompressobj: `eof`,
    `unused_data`, `unconsumed_tail`, decompress(data, max_length),
    flush(). gzip streams decode across members (RFC 1952). Blocks are
    decoded by the port's C runtime (``native.inflate_stream``).
    """

    def __init__(self, format: str = "zlib", dictionary: bytes | None = None):
        self.format = format
        self.dictionary = dictionary
        self._buf = bytearray()  # unconsumed input
        self._bit = 0  # bit offset into _buf (deflate body state)
        self._out = bytearray()  # decoded, not yet returned
        self._state = "body" if format == "raw" else "header"
        self._window = (
            (dictionary or b"")[-_WINDOW:] if format == "raw" else b""
        )
        self._check = 1 if format == "zlib" else 0  # running adler/crc
        self._mlen = 0  # member output length
        self.eof = False
        self.unused_data = b""
        self.unconsumed_tail = b""  # always consumed; kept for API parity

    # -- state steps (each returns True if it made progress) ---------------

    def _step_header(self) -> bool:
        buf = self._buf
        if self.format == "zlib":
            if len(buf) < 2 or ((buf[1] & 0x20) and len(buf) < 6):
                return False  # header (or its DICTID) not yet complete
            hdr_len, dictid = containers.parse_zlib_header(bytes(buf[:6]))
            if dictid is not None:
                if self.dictionary is None:
                    raise ValueError("stream requires a preset dictionary")
                if native.adler32(self.dictionary) != dictid:
                    raise ValueError("dictionary id mismatch")
                self._window = self.dictionary[-_WINDOW:]
            del buf[:hdr_len]
        else:  # gzip
            pos = self._try_gzip_header(bytes(buf))
            if pos is None:
                return False
            del buf[:pos]
        self._bit = 0
        self._state = "body"
        return True

    @staticmethod
    def _try_gzip_header(b: bytes) -> int | None:
        """Header length, or None if more bytes are needed. Raises on a
        malformed header (truncation is not corruption)."""
        if len(b) < 10:
            return None
        if b[0] != 0x1F or b[1] != 0x8B:
            raise ValueError("bad gzip magic")
        if b[2] != 8:
            raise ValueError(f"unsupported gzip method {b[2]}")
        flg = b[3]
        pos = 10
        if flg & 0x04:  # FEXTRA
            if pos + 2 > len(b):
                return None
            xlen = struct.unpack("<H", b[pos : pos + 2])[0]
            pos += 2 + xlen
            if pos > len(b):
                return None
        if flg & 0x08:  # FNAME
            i = b.find(0, pos)
            if i < 0:
                return None
            pos = i + 1
        if flg & 0x10:  # FCOMMENT
            i = b.find(0, pos)
            if i < 0:
                return None
            pos = i + 1
        if flg & 0x02:  # FHCRC
            pos += 2
            if pos > len(b):
                return None
        return pos

    def _step_body(self) -> bool:
        out, end_bit, bfinal, _again = native.inflate_stream(
            bytes(self._buf), self._window, self._bit
        )
        if out:
            self._window = (self._window + out)[-_WINDOW:]
            self._mlen += len(out)
            if self.format == "zlib":
                self._check = native.adler32(out, self._check)
            elif self.format == "gzip":
                self._check = native.crc32(out, self._check)
            self._out += out
        if bfinal:
            drop = (end_bit + 7) >> 3  # the trailer is byte-aligned
            self._bit = 0
            if self.format == "raw":
                self._state = "end"
                self.eof = True
            else:
                self._state = "trailer"
        else:
            drop = end_bit >> 3
            self._bit = end_bit & 7
        del self._buf[:drop]
        if self._state == "end":
            self.unused_data += bytes(self._buf)
            self._buf.clear()
        return bool(out) or bfinal

    def _step_trailer(self) -> bool:
        if self.format == "zlib":
            if len(self._buf) < 4:
                return False
            (adler,) = struct.unpack(">I", bytes(self._buf[:4]))
            if adler != (self._check & 0xFFFFFFFF):
                raise ValueError("adler32 mismatch")
            del self._buf[:4]
            self.eof = True
            self._state = "end"
            self.unused_data += bytes(self._buf)
            self._buf.clear()
            return True
        # gzip
        if len(self._buf) < 8:
            return False
        crc, isize = struct.unpack("<II", bytes(self._buf[:8]))
        if crc != (self._check & 0xFFFFFFFF):
            raise ValueError("crc32 mismatch")
        if isize != (self._mlen & 0xFFFFFFFF):
            raise ValueError("isize mismatch")
        del self._buf[:8]
        self.eof = True  # a complete member has been decoded
        self._state = "maybe_member"
        return True

    def _step_maybe_member(self) -> bool:
        if not self._buf:
            return False
        if len(self._buf) == 1 and self._buf[0] == 0x1F:
            return False  # could be the start of another member
        if self._buf[:2] == b"\x1f\x8b":
            # Another member: reset the per-member state and go on.
            self.eof = False
            self._check = 0
            self._mlen = 0
            self._window = b""
            self._state = "header"
            return True
        self.unused_data += bytes(self._buf)
        self._buf.clear()
        self._state = "end"
        return True

    def _run(self) -> None:
        steps = {
            "header": self._step_header,
            "body": self._step_body,
            "trailer": self._step_trailer,
            "maybe_member": self._step_maybe_member,
        }
        while self._state != "end" and steps[self._state]():
            pass

    # -- public API ----------------------------------------------------------

    def copy(self) -> "Decompressor":
        """Independent clone of the inflate state (inflateCopy,
        zlib.h:820)."""
        d = object.__new__(Decompressor)
        d.__dict__.update(self.__dict__)
        d._buf = bytearray(self._buf)
        d._out = bytearray(self._out)
        return d

    def decompress(self, data: bytes = b"", max_length: int = 0) -> bytes:
        if self._state == "end" and data:
            self.unused_data += bytes(data)
            data = b""
        self._buf += data
        self._run()
        if max_length and len(self._out) > max_length:
            out = bytes(self._out[:max_length])
            del self._out[:max_length]
            return out
        out = bytes(self._out)
        self._out.clear()
        return out

    def flush(self, length: int = 0) -> bytes:
        out = self.decompress(b"")
        if length:
            return out[:length]
        return out
