"""Device decode of indexed and foreign streams, timed for one checkout
of the port.

Decodes the seeded 8 MiB corpus (``utils/corpus.mixed_corpus``, seed 0)
as the checkout's own indexed L6 gzip (256 KiB chunks) and as stdlib
zlib, gzip and raw at level 6, and the 64 MiB corpus (seed 1)
as stdlib gzip to a CUDA tensor, each with ``engine="device"``, and
prints one JSON line per stream and anchor spacing: the device MB/s
(median of REPS calls, output bytes per second of host wall time), the
host C decoder's on the same bytes, the stages of one more call
(``decode_scan``, ``decode_plan``, ``decode_walk``, ...), and each walk
launch's lanes and device time (CUDA events, median of 15, the L2
flushed before each). Run it for two checkouts in turn to compare them
on one card:

    python zzflate_tpu_torch/utils/decode_bench.py --root OTHER_CHECKOUT
    python zzflate_tpu_torch/utils/decode_bench.py --spacing 64 128 256

``--root`` imports the package from that checkout's root (default: the
one holding this file); ``--spacing`` sets the decoder's
FOREIGN_ANCHOR_TOKENS for each run in turn (default: the checkout's own
spacing). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import sys
import time
import zlib

REPS = 5
SMALL = 8 << 20
BIG = 64 << 20


def _streams(corpus, zt):
    data = corpus.mixed_corpus(SMALL, seed=0)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    yield "indexed", "gzip", data, zt.compress(
        data, level=6, format="gzip", chunk_bytes=1 << 18, indexed=True)
    yield "zlib", "zlib", data, zlib.compress(data, 6)
    yield "gzip", "gzip", data, gzip.compress(data, 6, mtime=0)
    yield "raw", "raw", data, co.compress(data) + co.flush()
    big = corpus.mixed_corpus(BIG, seed=1)
    yield "64 MiB gzip, to_device", "gzip", big, gzip.compress(big, 6,
                                                               mtime=0)


def _walk_ms(torch, kernels, calls) -> list[float]:
    """Median device time of each captured walk launch."""
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    out = []
    for words, ll, d, lanes, packed, t_steps in calls:
        scratch = packed.clone()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(15)]
        for s, e in ev:
            flush.max()
            s.record()
            kernels.anchor_walk(words, ll, d, lanes, scratch, t_steps)
            e.record()
        torch.cuda.synchronize()
        out.append(statistics.median(s.elapsed_time(e) for s, e in ev))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--spacing", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device", file=sys.stderr)
        return 2
    import zzflate_tpu_torch as zt
    from zzflate_tpu_torch import constants as C
    from zzflate_tpu_torch.models import inflate_device as idv
    from zzflate_tpu_torch.ops import kernels
    from zzflate_tpu_torch.utils import corpus, profiling

    if args.spacing and not hasattr(idv, "FOREIGN_ANCHOR_TOKENS"):
        print("decode_bench: this checkout has no FOREIGN_ANCHOR_TOKENS",
              file=sys.stderr)
        return 2
    own = getattr(idv, "FOREIGN_ANCHOR_TOKENS", C.ANCHOR_TOKENS)
    for name, fmt, data, blob in _streams(corpus, zt):
        mb = len(data) / 1e6
        to_device = len(data) > SMALL
        want = (torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
                if to_device else data)

        def run():
            if not to_device:
                return zt.decompress(blob, format=fmt, engine="device")
            arr, n = idv.decompress_foreign(blob, format=fmt, to_device=True)
            torch.cuda.synchronize()
            return arr[:n]

        def same(got):
            return torch.equal(got, want) if to_device else got == want

        host = []
        for _ in range(REPS + 1):  # the first loads the C library
            t0 = time.perf_counter()
            if zt.decompress(blob, format=fmt) != data:
                raise AssertionError(f"{name}: host decode differs")
            host.append(time.perf_counter() - t0)
        host_s = statistics.median(host[1:])
        for spacing in args.spacing or [own]:
            if args.spacing:
                idv.FOREIGN_ANCHOR_TOKENS = spacing
            calls = []
            orig = kernels.anchor_walk

            def rec(*a):
                calls.append((*a[:4], a[4].clone(), a[5]))
                return orig(*a)

            kernels.anchor_walk = rec
            try:
                if not same(run()):  # warm-up, and the launches to time
                    raise AssertionError(f"{name}: device decode differs")
            finally:
                kernels.anchor_walk = orig
            secs = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                if not same(run()):
                    raise AssertionError(f"{name}: device decode differs")
                secs.append(time.perf_counter() - t0)
            with profiling.collect() as st:
                run()
            launch_ms = _walk_ms(torch, kernels, calls)
            print(json.dumps({
                "root": os.path.abspath(args.root), "stream": name,
                "spacing": spacing, "MBps": mb / statistics.median(secs),
                "MBps_min_max": [mb / max(secs), mb / min(secs)],
                "host_MBps": mb / host_s,
                "stages_ms": st.as_ms(),
                "lanes": [int((c[3][3] != 0).sum().item()) for c in calls],
                "walk_launch_ms": launch_ms, "walk_ms": sum(launch_ms)}),
                flush=True)
        if args.spacing:
            idv.FOREIGN_ANCHOR_TOKENS = own
    return 0


if __name__ == "__main__":
    sys.exit(main())
