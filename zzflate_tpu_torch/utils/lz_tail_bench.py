"""Device decode's LZ tail (``ops/kernels.token_scatter`` and
``resolve_lz``, ``csrc/resolve.cu``) on one checkout of the port: checked
against the plain versions, then timed.

On the card: the seeded cases of ``utils/corpus.resolve_inputs`` and
``scatter_inputs`` at a group's size (4 194 304 positions and bits); the
per-bit path's group, a 1 MiB v2 index of the seeded 8 MiB corpus's
prefix (one 4 194 304-bit group), with its ``_decode_all`` arguments and
the arguments of its token_scatter and resolve_lz calls; and the walk
path's groups of the 8 MiB corpus as the port's indexed L6 gzip. Each
kernel is held exactly against its plain version; then timed with CUDA
events (median of 15, the L2 flushed before each) beside its bytes bound
(3.35 TB/s), the plain version and, for token_scatter, the three torch
``scatter_reduce_("amax")`` calls it replaced, each also timed alone with
the trash slot and with the uncommitted bits filtered out. One
``_decode_all`` is traced (device time by kernel, launches) and run under
``torch.cuda.set_sync_debug_mode("error")``. Prints JSON lines:

    python zzflate_tpu_torch/utils/lz_tail_bench.py [--root OTHER_CHECKOUT]

``--root`` imports the package from that checkout's root (default: the
one holding this file). Needs a CUDA device. ``chip_smoke.py`` phase 6
uses the helpers here.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import struct
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
GROUP = 1 << 22  # positions of a group's output space, bits of its body
V2_BYTES = 1 << 20


def to_v2(blob: bytes, containers) -> bytes:
    """The same body behind a legacy v2 'ZZ' subfield (no anchors): the
    per-bit path."""
    header_len, cb, _t, chunks = containers.parse_gzip_index(blob)
    sub = bytearray(struct.pack("<BBII", 2, 0, cb, len(chunks)))
    for seg_bytes, blocks, _anchors in chunks:
        sub += struct.pack("<IH", seg_bytes, len(blocks))
        for bit_off, out_off in blocks:
            sub += struct.pack("<II", bit_off, out_off)
    extra = b"ZZ" + struct.pack("<H", len(sub)) + bytes(sub)
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", len(extra)) + extra + blob[header_len:])


def recorder(kernels, calls: dict, ends: bool = False):
    """Install wrappers on kernels.token_scatter and resolve_lz that keep
    each call's arguments (token_scatter's three arrays cloned before it
    updates them) in calls[name], or with ends only the first and the
    last call's; returns the function that removes them."""
    orig = {k: getattr(kernels, k) for k in ("token_scatter", "resolve_lz")}

    def keep(name, args):
        got = calls.setdefault(name, [])
        if ends and len(got) == 2:
            got[1] = args
        else:
            got.append(args)

    def scatter(*a):
        keep("token_scatter", tuple(t.clone() for t in a[:3]) + a[3:])
        return orig["token_scatter"](*a)

    def resolve(*a):
        keep("resolve_lz", a)
        return orig["resolve_lz"](*a)

    kernels.token_scatter, kernels.resolve_lz = scatter, resolve

    def undo():
        for k, fn in orig.items():
            setattr(kernels, k, fn)
    return undo


def max_err(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def check_scatter(kernels, args) -> int:
    """token_scatter against its plain version on clones of one call's
    arrays: the largest difference of the three (0 = exact)."""
    got = kernels.token_scatter(*(t.clone() for t in args[:3]), *args[3:])
    exp = kernels.token_scatter_plain(*(t.clone() for t in args[:3]),
                                      *args[3:])
    return max(max_err(g, e) for g, e in zip(got, exp))


def check_resolve(kernels, args):
    """resolve_lz and resolve_parent against their plain versions: (the
    largest difference of bytes and parents, the kernel's rounds read
    from the card, the plain version's)."""
    litval, start_mark, dist_at = args
    err = max_err(kernels.resolve_lz(*args),
                  kernels.resolve_lz_plain(*args))
    parent, rounds = kernels.resolve_parent(start_mark, dist_at)
    e_parent, e_rounds = kernels.resolve_parent_plain(start_mark, dist_at)
    err = max(err, max_err(parent, e_parent))
    rounds = int(rounds)
    if rounds != e_rounds:
        err = max(err, 1)
    return err, rounds, e_rounds


def scatter_bound(args) -> dict:
    """Least time of one token_scatter call, from this call's data: the
    committed mask read once (1 B a bit); at the committed bits their two
    kind flags; at the committed tokens the offset (8 B) and the literal
    or distance (8 B each kind set); at the tokens kept (offset in range)
    the three int32 entries read and written. Beside it, the six arrays
    read whole as _decode_bits hands them (27 B a bit)."""
    off, committed, islit, islen = args[3:7]
    n = args[0].shape[0]
    nbits = off.shape[0]
    com = int(committed.sum().item())
    lit = committed & islit
    ln = committed & islen
    tok = lit | ln
    kept = tok & (off >= 0) & (off < n)
    ntok = int(tok.sum().item())
    nbytes = (nbits + 2 * com + 8 * ntok + 8 * int(lit.sum().item())
              + 8 * int(ln.sum().item()) + 24 * int(kept.sum().item()))
    t = nbytes / HBM_BYTES_PER_S * 1e3
    whole = nbits * 27 + int(kept.sum().item()) * 24
    return {"bound_ms": t, "bound_by": "bytes", "bound_bytes": nbytes,
            "whole_read_ms": whole / HBM_BYTES_PER_S * 1e3, "nbits": nbits,
            "committed": com, "tokens": ntok,
            "tokens_kept": int(kept.sum().item())}


def resolve_bound(n: int, rounds: int) -> dict:
    """One pass: start_mark, dist_at and litval read once (12 B a
    position), the bytes written once (1 B). Each doubling round moves
    about 12 B a position more (the parents read, gathered and written)."""
    one = n * 13 / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": one, "bound_by": "bytes", "n": n, "rounds": rounds,
            "with_rounds_ms": one + rounds * n * 12 / HBM_BYTES_PER_S * 1e3}


def scatter_study(torch, timer, args) -> dict:
    """The three torch scatter_reduce_("amax") calls token_scatter
    replaced, as the port made them (every bit, the dropped ones aimed at
    a trash slot past the end), each timed alone, then on the committed
    tokens in range only (filtered outside the timed call). Their sum is
    the library yardstick of token_scatter (one PyTorch call a field)."""
    litval, start_mark, dist_at, off, committed, islit, islen, sym, mdist = \
        args
    n = litval.shape[0]
    off, sym, mdist = off.long(), sym.long(), mdist.long()
    com_tok = committed & (islit | islen)
    keep = com_tok & (off >= 0) & (off < n)
    tgt = torch.where(keep, off, n)
    fields = {"litval": (litval, torch.where(islit, sym, 0)),
              "start_mark": (start_mark, torch.where(com_tok, off, -1)),
              "dist_at": (dist_at, torch.where(islen, mdist, 0))}
    out = {"trash_slot_hits": int((tgt == n).sum().item())}
    bufs = {}
    for name, (base, vals) in fields.items():
        buf = torch.cat([base.long(), base.new_zeros(1).long()])
        bufs[name] = (buf, vals)
        out[f"{name}_ms"] = timer.kernel_ms(
            lambda: buf.scatter_reduce_(0, tgt, vals, "amax"))
        kt, kv = tgt[keep], vals[keep]
        out[f"{name}_filtered_ms"] = timer.kernel_ms(
            lambda: buf.scatter_reduce_(0, kt, kv, "amax"))

    def three():
        for buf, vals in bufs.values():
            buf.scatter_reduce_(0, tgt, vals, "amax")

    out["library_ms"] = timer.kernel_ms(three)
    return out


def tail_report(torch, kernels, timer, label: str, scatter_args=None,
                resolve_args=None, log=print) -> dict:
    """One real group: each kernel given held against its plain version
    (exact, else AssertionError), timed, bounded; printed and returned."""
    rep = {"group": label}
    if scatter_args is not None:
        err = check_scatter(kernels, scatter_args)
        if err:
            raise AssertionError(f"token_scatter {label}: kernel != plain")
        work = [t.clone() for t in scatter_args[:3]]
        ms = timer.kernel_ms(
            lambda: kernels.token_scatter(*work, *scatter_args[3:]))
        plain = timer.wall_ms(lambda: kernels.token_scatter_plain(
            *work, *scatter_args[3:]), reps=1)
        b = scatter_bound(scatter_args)
        study = scatter_study(torch, timer, scatter_args)
        rep["token_scatter"] = {**b, "ms": ms, "share": b["bound_ms"] / ms,
                                "plain_ms": plain, **study}
        log(f"  token_scatter {label}: {b['nbits']} bits, {b['committed']} "
            f"committed, {b['tokens']} tokens ({b['tokens_kept']} in "
            f"range): kernel {ms:.4f} ms, bound {b['bound_ms'] * 1e3:.2f} us "
            f"(bytes of this data; {b['whole_read_ms'] * 1e3:.2f} us reading "
            f"the six arrays whole), share {b['bound_ms'] / ms:.4f}; plain "
            f"{plain:.3f} ms; the replaced scatter_reduce_ calls: "
            + ", ".join(f"{k} {study[k + '_ms']:.4f} ms (filtered "
                        f"{study[k + '_filtered_ms']:.4f})"
                        for k in ("litval", "start_mark", "dist_at"))
            + f", all three {study['library_ms']:.4f} ms, "
            f"{study['trash_slot_hits']} bits at the trash slot; equal")
    if resolve_args is not None:
        err, rounds, e_rounds = check_resolve(kernels, resolve_args)
        if err:
            raise AssertionError(f"resolve_lz {label}: kernel != plain "
                                 f"(rounds {rounds} vs {e_rounds})")
        ms = timer.kernel_ms(lambda: kernels.resolve_lz(*resolve_args))
        plain = timer.wall_ms(
            lambda: kernels.resolve_lz_plain(*resolve_args), reps=1)
        n = resolve_args[0].shape[0]
        b = resolve_bound(n, rounds)
        rep["resolve_lz"] = {**b, "ms": ms, "share": b["bound_ms"] / ms,
                             "plain_ms": plain}
        log(f"  resolve_lz {label}: {n} positions, {rounds} doubling rounds: "
            f"kernel {ms:.4f} ms, bound {b['bound_ms'] * 1e3:.2f} us one pass "
            f"(share {b['bound_ms'] / ms:.4f}), "
            f"{b['with_rounds_ms'] * 1e3:.2f} us with the rounds; plain "
            f"{plain:.3f} ms (a host sync a round); equal, rounds equal")
    return rep


def seeded_checks(torch, kernels, corpus, n: int = GROUP) -> dict:
    """Both kernels against their plain versions on the seeded cases at
    a group's size: the largest difference and each resolve's rounds."""
    err, rounds = 0, {}
    for case in corpus.RESOLVE_CASES:
        args = tuple(torch.from_numpy(a).cuda()
                     for a in corpus.resolve_inputs(case, n))
        e, r, _ = check_resolve(kernels, args)
        err, rounds[case] = max(err, e), r
    for case in corpus.SCATTER_CASES:
        base, ins = corpus.scatter_inputs(case, n, n)
        args = tuple(torch.from_numpy(a).cuda() for a in base + ins)
        err = max(err, check_scatter(kernels, args))
    return {"max_abs_err": err, "rounds": rounds,
            "cases": len(corpus.RESOLVE_CASES) + len(corpus.SCATTER_CASES)}


def device_split(torch, profiling, fn, logdir: str, log=print) -> dict:
    """One call of fn under the profiler: its device launches and device
    time, split into the commit kernels, token_scatter, resolve_lz's and
    the rest (None when the profile holds no device records)."""
    with profiling.trace(logdir) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")]
    if not ev:
        return {"launches": 0, "device_ms": None}
    top = sorted(ev, key=lambda e: -e.self_device_time_total)
    for e in top[:8] + [e for e in top[8:] if "scatter" in e.key]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    parts = {"commit": "commit_", "scatter": "token_scatter",
             "resolve": "resolve_"}
    out = {"launches": sum(e.count for e in ev),
           "device_ms": sum(e.self_device_time_total for e in ev) / 1e3}
    for name, key in parts.items():
        out[f"{name}_ms"] = sum(e.self_device_time_total for e in ev
                                if key in e.key) / 1e3
        out[f"{name}_launches"] = sum(e.count for e in ev if key in e.key)
    out["rest_ms"] = out["device_ms"] - sum(out[f"{p}_ms"] for p in parts)
    return out


def no_sync(torch, fn) -> None:
    """Run fn with synchronising CUDA calls raising (after a warm call)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("lz_tail_bench: no CUDA device", file=sys.stderr)
        return 2
    import zzflate_tpu_torch as zt
    from zzflate_tpu_torch.models import inflate_device as idv
    from zzflate_tpu_torch.ops import kernels
    from zzflate_tpu_torch.utils import containers, corpus, profiling

    logdir = os.path.join(os.path.abspath(args.root), "chiprun_out",
                          "traces")
    t0 = time.perf_counter()
    kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for part in kernels.build_log.split("== ")[1:]:
        if part.startswith("resolve.cu"):
            for line in part.splitlines()[1:]:
                if "registers" in line or "spill" in line or "entry" in line:
                    print(f"  ptxas {line.strip()}")
    timer = profiling.DeviceTimer()
    seeded = seeded_checks(torch, kernels, corpus)
    print(json.dumps({"seeded": seeded}), flush=True)
    if seeded["max_abs_err"]:
        raise AssertionError("seeded cases: kernel != plain")

    data = corpus.mixed_corpus(8 << 20, seed=0)
    pre = data[:V2_BYTES]
    v2 = to_v2(zt.compress(pre, level=6, format="gzip", chunk_bytes=1 << 18,
                           indexed=True), containers)
    calls: dict = {}
    all_args: list = []
    orig_all = idv._decode_all

    def rec_all(*a):
        all_args.append(a)
        return orig_all(*a)

    undo = recorder(kernels, calls)
    idv._decode_all = rec_all
    try:
        if idv.decompress_indexed(v2) != pre:
            raise AssertionError("v2: device decode differs")
    finally:
        idv._decode_all = orig_all
        undo()
    rep = tail_report(torch, kernels, timer, "v2 group 0",
                      calls["token_scatter"][0], calls["resolve_lz"][0])
    print(json.dumps(rep), flush=True)
    split = device_split(torch, profiling,
                         lambda: idv._decode_all(*all_args[0]), logdir)
    no_sync(torch, lambda: idv._decode_all(*all_args[0]))
    secs = []
    for _ in range(3):
        t1 = time.perf_counter()
        idv._decode_all(*all_args[0])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    split["wall_ms"] = statistics.median(secs) * 1e3
    print(json.dumps({"_decode_all v2 group 0": split,
                      "host_syncs": "none"}), flush=True)
    secs = []
    for _ in range(4):
        t1 = time.perf_counter()
        idv.decompress_indexed(v2)
        secs.append(time.perf_counter() - t1)
    print(json.dumps({"v2 1 MiB MBps": len(pre) / 1e6
                      / statistics.median(secs[1:])}), flush=True)

    indexed = zt.compress(data, level=6, format="gzip", chunk_bytes=1 << 18,
                          indexed=True)
    calls = {}
    undo = recorder(kernels, calls)
    try:
        if zt.decompress(indexed, format="gzip", engine="device") != data:
            raise AssertionError("indexed: device decode differs")
    finally:
        undo()
    for k, a in enumerate(calls["resolve_lz"]):
        print(json.dumps(tail_report(torch, kernels, timer,
                                     f"indexed group {k}", None, a)),
              flush=True)
    no_sync(torch, lambda: idv._resolve_lz(*calls["resolve_lz"][0],
                                           calls["resolve_lz"][0][0].shape[0]))
    secs = []
    for _ in range(4):
        t1 = time.perf_counter()
        zt.decompress(indexed, format="gzip", engine="device")
        secs.append(time.perf_counter() - t1)
    with profiling.collect() as st:
        zt.decompress(indexed, format="gzip", engine="device")
    print(json.dumps({"indexed 8 MiB MBps": len(data) / 1e6
                      / statistics.median(secs[1:]),
                      "stages_ms": st.as_ms()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
