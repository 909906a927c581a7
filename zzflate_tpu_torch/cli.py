"""Command-line interface: compress, decompress, range and bench.

Port of ``zzflate_tpu/cli.py``. Each command prints one JSON line of
metrics (bytes in and out, ratio, seconds, MB/s): on stderr for the
commands that write data to stdout, on stdout for bench.

Usage:
  python -m zzflate_tpu_torch [--device cuda|cpu] compress [-l LEVEL]
      [-f zlib|gzip|raw] [--engine device|native] [-o OUT] IN
  python -m zzflate_tpu_torch [--device cuda|cpu] decompress
      [-f zlib|gzip|raw] [--engine native|device] [-o OUT] IN
  python -m zzflate_tpu_torch range IN OFFSET LENGTH [-o OUT]
  python -m zzflate_tpu_torch [--device cuda|cpu] bench [-l LEVEL] [FILES...]

--device defaults to CUDA and fails without a card; --device cpu runs
the plain torch path. Decoding runs on the host (the C decoder) unless
--engine device asks for the card's anchor walk.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import zlib as _zlib

BENCH_BYTES = 8 << 20  # bench's corpus when no files are given


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str | None, blob: bytes) -> None:
    if path is None or path == "-":
        sys.stdout.buffer.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)


def _cmd_compress(args) -> int:
    import zzflate_tpu_torch as zt

    data = _read(args.input)
    t0 = time.perf_counter()
    out = zt.compress(
        data, level=args.level, format=args.format,
        chunk_bytes=args.chunk_bytes, strategy=args.strategy,
        indexed=args.indexed or args.seekable, mem_level=args.mem_level,
        engine=args.engine, seekable=args.seekable, device=args.device,
    )
    dt = time.perf_counter() - t0
    _write(args.output, out)
    print(
        json.dumps(
            {
                "op": "compress",
                "bytes_in": len(data),
                "bytes_out": len(out),
                "ratio": round(len(data) / max(1, len(out)), 4),
                "level": args.level,
                "format": args.format,
                "seconds": round(dt, 4),
                "MBps": round(len(data) / 1e6 / max(dt, 1e-9), 2),
            }
        ),
        file=sys.stderr,
    )
    return 0


def _cmd_decompress(args) -> int:
    import zzflate_tpu_torch as zt

    data = _read(args.input)
    t0 = time.perf_counter()
    out = zt.decompress(data, format=args.format, engine=args.engine,
                        device=args.device)
    dt = time.perf_counter() - t0
    _write(args.output, out)
    print(
        json.dumps(
            {
                "op": "decompress",
                "bytes_in": len(data),
                "bytes_out": len(out),
                "format": args.format,
                "seconds": round(dt, 4),
                "MBps": round(len(out) / 1e6 / max(dt, 1e-9), 2),
            }
        ),
        file=sys.stderr,
    )
    return 0


def _cmd_range(args) -> int:
    import zzflate_tpu_torch as zt

    data = _read(args.input)
    t0 = time.perf_counter()
    out = zt.decompress_range(data, args.offset, args.length)
    dt = time.perf_counter() - t0
    _write(args.output, out)
    print(
        json.dumps(
            {
                "op": "range",
                "offset": args.offset,
                "length": args.length,
                "bytes_out": len(out),
                "seconds": round(dt, 4),
            }
        ),
        file=sys.stderr,
    )
    return 0


def _cmd_bench(args) -> int:
    import torch

    import zzflate_tpu_torch as zt
    from zzflate_tpu_torch.devices import resolve_device

    dev = resolve_device(args.device)
    if args.files:
        data = b"".join(_read(p) for p in args.files)
    else:
        from zzflate_tpu_torch.utils.corpus import mixed_corpus

        data = mixed_corpus(BENCH_BYTES)
    mb = len(data) / 1e6

    t0 = time.perf_counter()
    zref = _zlib.compress(data, args.level)
    zlib_dt = time.perf_counter() - t0

    def run():
        return zt.compress(data, level=args.level, format="gzip",
                           chunk_bytes=args.chunk_bytes, device=dev)

    out = run()  # warm-up: first-call allocations and the kernel build
    if _zlib.decompress(out, wbits=31) != data:
        raise RuntimeError("bench: output does not decode to the input")
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    back = zt.decompress(out, format="gzip")
    dec_dt = time.perf_counter() - t0
    if back != data:
        raise RuntimeError("bench: decompress does not give the input")

    cuda = dev.type == "cuda"
    report = {
        "op": "bench",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "level": args.level,
        "chunk_bytes": args.chunk_bytes,
        "bytes_in": len(data),
        "bytes_out": len(out),
        "ratio": round(len(data) / len(out), 4),
        "zlib_bytes_out": len(zref),
        "zlib_ratio": round(len(data) / len(zref), 4),
        "encode_MBps": round(mb / min(times), 2),
        "encode_times_s": [round(t, 3) for t in times],
        "zlib_encode_MBps": round(mb / zlib_dt, 2),
        "decode_MBps": round(mb / dec_dt, 2),
    }
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zzflate_tpu_torch")
    p.add_argument(
        "--device", default=None, choices=["cuda", "cpu"],
        help="where the encode pipeline and device decode run (default: "
        "CUDA, which fails without a card; cpu runs the plain torch path)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress")
    pc.add_argument("input")
    pc.add_argument("-o", "--output", default=None)
    pc.add_argument("-l", "--level", type=int, default=6)
    pc.add_argument("-f", "--format", default="gzip",
                    choices=["zlib", "gzip", "raw"])
    pc.add_argument("--chunk-bytes", type=int, default=1 << 18)
    pc.add_argument("--strategy", type=int, default=0,
                    help="0=default 1=filtered 2=huffman-only 3=rle 4=fixed")
    pc.add_argument("--indexed", action="store_true",
                    help="gzip with a 'ZZ' chunk index")
    pc.add_argument("--engine", default="device", choices=("device", "native"),
                    help="the encode pipeline (default) or the host C encoder")
    pc.add_argument("--mem-level", type=int, default=8, dest="mem_level",
                    help="1..9 device-memory budget (zlib memLevel shape)")
    pc.add_argument("--seekable", action="store_true",
                    help="indexed gzip with per-chunk window resets "
                         "(random-access reads via the range command)")
    pc.set_defaults(fn=_cmd_compress)

    pd = sub.add_parser("decompress")
    pd.add_argument("input")
    pd.add_argument("-o", "--output", default=None)
    pd.add_argument("-f", "--format", default="gzip",
                    choices=["zlib", "gzip", "raw"])
    pd.add_argument("--engine", default="native", choices=["native", "device"],
                    help="the host C decoder (default) or the device "
                         "anchor walk on --device")
    pd.set_defaults(fn=_cmd_decompress)

    pr = sub.add_parser("range", help="random-access read from an "
                        "indexed gzip stream (see compress --seekable)")
    pr.add_argument("input")
    pr.add_argument("offset", type=int)
    pr.add_argument("length", type=int)
    pr.add_argument("-o", "--output", default=None)
    pr.set_defaults(fn=_cmd_range)

    pb = sub.add_parser("bench")
    pb.add_argument("files", nargs="*")
    pb.add_argument("-l", "--level", type=int, default=6)
    pb.add_argument("--chunk-bytes", type=int, default=1 << 18)
    pb.add_argument("--reps", type=int, default=3)
    pb.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
