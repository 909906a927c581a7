"""The checksum kernels (``ops/kernels.crc32_rows``/``adler32_rows``,
``csrc/checksum.cu``) timed for one checkout of the port.

Seeded inputs on the card, the shapes the port hands the kernels: one
4 MiB device-decode group (a (1, 4 MiB + 32 KiB) buffer, the range from
32 KiB), the encode's (16, 294 912) partials batch (ranges from 32 KiB to
each row's end), a 64 MiB + 5 B row, and a 1 000-byte row (one block:
the floor of a call's two launches). Each call is checked against the
plain version and zlib, then timed with CUDA events (median of 15, the L2
flushed before each), and printed as one JSON line with the bytes bound
(3.35 TB/s). Run it for two checkouts in turn to compare them on one
card:

    python zzflate_tpu_torch/utils/checksum_bench.py --root OTHER_CHECKOUT

``--root`` imports the package from that checkout's root (default: the
one holding this file). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import zlib

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
REPS = 15


def _inputs(torch):
    g = torch.Generator(device="cuda").manual_seed(0)

    def rows(b, n):
        return torch.randint(0, 256, (b, n), generator=g, device="cuda",
                             dtype=torch.uint8)

    w = 32768
    group = rows(1, (4 << 20) + w)
    batch = rows(16, w + (1 << 18))
    ends = torch.full((16,), w + (1 << 18), dtype=torch.int32, device="cuda")
    ends[-1] = w + 12345  # a short last chunk
    starts = torch.full((16,), w, dtype=torch.int32, device="cuda")
    yield "decode group (1, 4 MiB + 32 KiB)", group, (4 << 20) + w, w
    yield "partials batch (16, 294912)", batch, ends, starts
    yield "row of 64 MiB + 5 B", rows(1, (64 << 20) + 5), (64 << 20) + 5, 0
    yield "row of 1000 B (one block)", rows(1, 1000), 1000, 0


def _ms(torch, fn) -> float:
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for s, e in ev:
        flush.max()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("checksum_bench: no CUDA device", file=sys.stderr)
        return 2
    from zzflate_tpu_torch.ops import kernels

    for label, data, ends, starts in _inputs(torch):
        host = data.cpu().numpy()
        b = host.shape[0]
        e = [ends] * b if isinstance(ends, int) else ends.tolist()
        s = [starts] * b if isinstance(starts, int) else starts.tolist()
        nbytes = sum(e[r] - s[r] for r in range(b))
        for name, zfn in (("crc32_rows", zlib.crc32),
                          ("adler32_rows", zlib.adler32)):
            kfn = getattr(kernels, name)
            want = [zfn(host[r, s[r] : e[r]].tobytes()) for r in range(b)]
            got = kfn(data, ends, starts).tolist()
            plain = getattr(kernels, f"{name}_plain")(data, ends,
                                                     starts).tolist()
            if got != want or plain != want:
                raise AssertionError(f"{name} on {label}: kernel, plain and "
                                     "zlib differ")
            ms = _ms(torch, lambda: kfn(data, ends, starts))
            bound_ms = (nbytes + 16 * b) / HBM_BYTES_PER_S * 1e3
            print(json.dumps({
                "root": os.path.abspath(args.root), "kernel": name,
                "input": label, "range_bytes": nbytes, "ms": ms,
                "bound_ms": bound_ms, "share": bound_ms / ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
