"""The plain reference that decides ``correct``.

It takes nothing from the program. The encoders' answers are read back by
the C library's inflate in Python's standard ``zlib`` module (an
implementation independent of the port), with the container parsed by
its own file, ``portbench/formats/<format>.py``, found by the
configuration's ``format``, and compared with the buffers the benchmark
made. The decoders' answers are compared byte for byte with those buffers
(``generator.DeviceDecodeTraffic``).
"""
from __future__ import annotations

import zlib


def inflate_raw(body: bytes, window_bits: int) -> tuple[bytes, bytes]:
    """(decoded bytes, what follows the final block); ValueError when the
    deflate data is invalid, reaches past 2^window_bits or never ends."""
    d = zlib.decompressobj(-window_bits)
    try:
        out = d.decompress(body)
    except zlib.error as e:
        raise ValueError(f"deflate data: {e}") from e
    if not d.eof:
        raise ValueError("deflate data has no final block")
    return out, d.unused_data
