"""Device decode's per-bit kernels after the commit walk's
(``ops/kernels.decode_candidates``, ``csrc/candidates.cu``; ``token_scatter``
and ``resolve_lz``, ``csrc/resolve.cu``) on one checkout of the port:
checked against the plain versions, then timed; and one per-bit group's
``_decode_all`` split by stage.

On the card: the seeded cases of ``utils/corpus.candidate_inputs``,
``resolve_inputs`` and ``scatter_inputs`` at a group's size (4 194 304
bits and positions); the per-bit path's group, a 1 MiB v2 index of the
seeded 8 MiB corpus's prefix (one 4 194 304-bit group), with its
``_decode_all`` arguments and the arguments of its kernel calls; and the
walk path's groups of the 8 MiB corpus as the port's indexed L6 gzip. Each
kernel is held exactly against its plain version; then timed with CUDA
events (median of 15, the L2 flushed before each) beside its bound (3.35
TB/s; 16.7e12 integer op/s), the plain version and, for token_scatter, the
three torch ``scatter_reduce_("amax")`` calls it replaced, each also timed
alone with the trash slot and with the uncommitted bits filtered out. One
``_decode_all`` is traced whole (device time by kernel, launches), split
by stage (``stage_split``: the candidates, the commit, the offsets,
``_stage_out``, the scatter and the resolve, as ``_decode_all`` calls
them) and run under ``torch.cuda.set_sync_debug_mode("error")``. Prints
JSON lines:

    python zzflate_tpu_torch/utils/lz_tail_bench.py [--root OTHER_CHECKOUT]

``--root`` imports the package from that checkout's root (default: the
one holding this file), so a parent checkout is checked and timed by this
file in the same call. Needs a CUDA device. ``chip_smoke.py`` phase 6 uses
the helpers here.
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
# H100 SXM 32-bit integer rate: 132 SMs x 64 integer lanes x 1.98 GHz.
INT_OPS_PER_S = 132 * 64 * 1.98e9
GROUP = 1 << 22  # positions of a group's output space, bits of its body
V2_BYTES = 1 << 20
# decode_candidates' bytes a bit: uid, step, outlen, sym and mdist written
# as int32, islit and islen as bytes (the words, 4 B for 32 bits, and the
# units' rows are read once from memory and are left out).
CAND_BYTES_BIT = 22
# The 32-bit integer operations the function needs, in the reference's
# table form (each valid unit's two 2^15-entry tables built once, then one
# lookup a table a bit), not the compare ladder csrc/candidates.cu spends
# to evaluate a table entry per bit. A bit: the 64-bit window (word index
# and shift 2, two funnel shifts 2: 4), the owning unit's running max (1),
# the litlen lookup's index (2), its fields and flags (12), the length's
# extract (4), the distance window's offset and extract (3), its lookup's
# index (2), fields and flags (9) and extract (5), and the outputs (17):
# 59. A table entry: its symbol, length and attribute composed and stored
# (4). Loads are not counted.
CAND_OPS_BIT = 59
CAND_OPS_ENTRY = 4


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
    """Install wrappers on kernels.token_scatter, resolve_lz and
    decode_candidates that keep each call's arguments (token_scatter's
    three arrays cloned before it updates them) in calls[name], or with
    ends only the first and the last call's; returns the function that
    removes them."""
    names = ("token_scatter", "resolve_lz", "decode_candidates")
    orig = {k: getattr(kernels, k) for k in names}

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

    def candidates(*a):
        keep("decode_candidates", a)
        return orig["decode_candidates"](*a)

    kernels.token_scatter, kernels.resolve_lz = scatter, resolve
    kernels.decode_candidates = candidates

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
    or distance (4 B each kind set); at the tokens kept (offset in range)
    the three int32 entries read and written. Beside it, the six arrays
    read whole as the decode hands them (19 B a bit)."""
    off, committed, islit, islen = args[3:7]
    n = args[0].shape[0]
    nbits = off.shape[0]
    com = int(committed.sum().item())
    lit = committed & islit
    ln = committed & islen
    tok = lit | ln
    kept = tok & (off >= 0) & (off < n)
    ntok = int(tok.sum().item())
    nbytes = (nbits + 2 * com + 8 * ntok + 4 * int(lit.sum().item())
              + 4 * int(ln.sum().item()) + 24 * int(kept.sum().item()))
    t = nbytes / HBM_BYTES_PER_S * 1e3
    whole = nbits * 19 + int(kept.sum().item()) * 24
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


def check_candidates(kernels, args) -> int:
    """decode_candidates against its plain version on one call's
    arguments: the largest difference of the seven outputs (0 = exact)."""
    got = kernels.decode_candidates(*args)
    exp = kernels.decode_candidates_plain(*args)
    return max(max_err(g, e) for g, e in zip(got, exp))


def candidates_bound(nbits: int, units: int) -> dict:
    """Least time of one decode_candidates call over nbits bits and units
    valid units: the larger of its outputs' bytes over the memory rate and
    the operations the function needs over the integer rate
    (CAND_BYTES_BIT; CAND_OPS_BIT a bit, CAND_OPS_ENTRY a table entry)."""
    t_bytes = nbits * CAND_BYTES_BIT / HBM_BYTES_PER_S * 1e3
    ops = nbits * CAND_OPS_BIT + units * 2 * (1 << 15) * CAND_OPS_ENTRY
    t_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "nbits": nbits}


def candidates_report(kernels, timer, args, label: str, log=print) -> dict:
    """One real decode_candidates call: held exactly against its plain
    version, timed (kernel and plain), bounded; printed and returned."""
    if check_candidates(kernels, args):
        raise AssertionError(f"decode_candidates {label}: kernel != plain")
    ms = timer.kernel_ms(lambda: kernels.decode_candidates(*args))
    plain = timer.wall_ms(lambda: kernels.decode_candidates_plain(*args),
                          reps=1)
    units = int(args[4].sum().item())
    b = candidates_bound(args[-1], units)
    log(f"  decode_candidates {label}: {b['nbits']} bits, {units} units: "
        f"kernel {ms:.4f} ms, bound {b['bound_ms'] * 1e3:.2f} us "
        f"({b['bound_by']}; bytes {b['bytes_ms'] * 1e3:.2f} us, ops "
        f"{b['ops_ms'] * 1e3:.2f} us), share {b['bound_ms'] / ms:.4f}; "
        f"plain {plain:.3f} ms; equal")
    return {**b, "group": label, "units": units, "ms": ms,
            "share": b["bound_ms"] / ms, "plain_ms": plain}


def candidate_checks(torch, kernels, corpus, sizes=(GROUP,)) -> dict:
    """decode_candidates against its plain version on every seeded case
    at each size: the largest difference and the inputs checked."""
    err, n = 0, 0
    for case in corpus.CANDIDATE_CASES:
        for nbits in sizes:
            words, ll, d, start, valid = corpus.candidate_inputs(case, nbits)
            c = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
            args = (c(words), tuple(map(c, ll)), tuple(map(c, d)), c(start),
                    c(valid), nbits)
            err = max(err, check_candidates(kernels, args))
            n += 1
    return {"max_abs_err": err, "inputs": n}


def _is_device(e) -> bool:
    """A kernel, copy or fill on the card, not the profiler's own spans on
    the device timeline (its step, and the record_function ranges)."""
    return (str(e.device_type).endswith("CUDA")
            and not e.key.startswith(("ProfilerStep", "stage:")))


def _profiled(torch, fn, logdir=None, raw=False) -> list:
    """The device events of one fn() call as (key, count, device us)
    averages; with raw, every event of the call as (name, on the device,
    start us, duration us), host ranges included. Profiled as the second
    of two steps of one profiler: CUPTI can miss the first launches of a
    session, so the first step only warms it up. Its Chrome trace goes to
    logdir when one is given. Plain tuples: no profiler object outlives
    the session."""
    from torch.profiler import ProfilerActivity, profile, schedule

    events: list = []

    def ready(prof):  # the profiler drops the step's events after this
        if raw:
            events.extend((e.name, str(e.device_type).endswith("CUDA"),
                           e.time_range.start, e.time_range.elapsed_us())
                          for e in prof.events())
        else:
            events.extend((e.key, e.count, e.self_device_time_total)
                          for e in prof.key_averages() if _is_device(e))
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace_{os.getpid()}_{time.time_ns()}.json.gz"))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return events


# _decode_all's stages, in its order: (name, "kernels" or "idv", the
# function it calls).
STAGES = (("candidates", "kernels", "decode_candidates"),
          ("commit", "idv", "_commit_walk"), ("offsets", "idv", "_offsets"),
          ("stage_out", "idv", "_stage_out"),
          ("token_scatter", "kernels", "token_scatter"),
          ("resolve_lz", "idv", "_resolve_lz"))


def stage_split(torch, idv, kernels, args) -> dict:
    """One group's _decode_all(*args) by stage: each function of STAGES is
    wrapped, while the call runs, in a record_function range that ends
    with a synchronise, and the call is profiled as one step (after a warm
    one, which a max-scatter repeats harmlessly); each device event goes
    to the stage whose range it starts in. Returns {"stages": {name:
    {launches, device_ms}}, "candidates_launches", "candidates_ms",
    "launches", "device_ms"} (every device_ms None when the profile holds
    no device records)."""
    mods = {"kernels": kernels, "idv": idv}
    orig = {(mod, fn): getattr(mods[mod], fn) for _n, mod, fn in STAGES}

    def staged(name, fn):
        def run(*a, **kw):
            with torch.profiler.record_function(f"stage:{name}"):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return run

    for name, mod, fn in STAGES:
        setattr(mods[mod], fn, staged(name, orig[(mod, fn)]))
    try:
        events = _profiled(torch, lambda: idv._decode_all(*args), raw=True)
    finally:
        for (mod, fn), f in orig.items():
            setattr(mods[mod], fn, f)
    starts = sorted((t, name[len("stage:"):])
                    for name, on_card, t, _us in events
                    if name.startswith("stage:") and not on_card)
    rows = {name: {"launches": 0, "device_ms": 0.0} for name, _m, _f in STAGES}
    device = [(t, us) for name, on_card, t, us in events if on_card
              and not name.startswith(("ProfilerStep", "stage:"))]
    for t0, us in device:
        owner = starts[0][1]
        for t, name in starts:
            if t <= t0:
                owner = name
        rows[owner]["launches"] += 1
        rows[owner]["device_ms"] += us / 1e3
    if not device:
        for row in rows.values():
            row["device_ms"] = None
    return {"stages": rows,
            "candidates_launches": rows["candidates"]["launches"],
            "candidates_ms": rows["candidates"]["device_ms"],
            "launches": sum(r["launches"] for r in rows.values()),
            "device_ms": (sum(r["device_ms"] for r in rows.values())
                          if device else None)}


def device_split(torch, fn, logdir: str, log=print) -> dict:
    """One call of fn under the profiler (_profiled): its device launches
    and device time, split into the candidate kernels, the commit kernels,
    token_scatter, resolve_lz's and the rest (None when the profile holds
    no device records)."""
    ev = _profiled(torch, fn, logdir)
    if not ev:
        return {"launches": 0, "device_ms": None}
    top = sorted(ev, key=lambda e: -e[2])
    for key, count, us in top[:8] + [e for e in top[8:] if "scatter" in e[0]]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    parts = {"candidates": ("candidates_kernel", "unit_bounds_kernel"),
             "commit": ("commit_",), "scatter": ("token_scatter",),
             "resolve": ("resolve_",)}
    out = {"launches": sum(count for _k, count, _us in ev),
           "device_ms": sum(us for _k, _c, us in ev) / 1e3}
    for name, keys in parts.items():
        mine = [e for e in ev if any(k in e[0] for k in keys)]
        out[f"{name}_ms"] = sum(us for _k, _c, us in mine) / 1e3
        out[f"{name}_launches"] = sum(count for _k, count, _us in mine)
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
    cand = candidate_checks(torch, kernels, corpus)
    print(json.dumps({"seeded_candidates": cand}), flush=True)
    if cand["max_abs_err"]:
        raise AssertionError("decode_candidates: kernel != plain")

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
    rep["decode_candidates"] = candidates_report(
        kernels, timer, calls["decode_candidates"][0], "v2 group 0")
    print(json.dumps(rep), flush=True)
    print(json.dumps({"_decode_all v2 group 0 by stage": stage_split(
        torch, idv, kernels, all_args[0])}), flush=True)
    split = device_split(torch, lambda: idv._decode_all(*all_args[0]),
                         logdir)
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
