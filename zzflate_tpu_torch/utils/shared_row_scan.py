"""Count the reference's shared-row case in the port's indexed streams.

    python3 -m zzflate_tpu_torch.utils.shared_row_scan [--bytes N]
        [--levels 1 6] [--device cpu]

The per-bit path's commit walk keeps one entry a 256-bit row, the least
(the reference's rule, pinned by tests/test_torch_commit_walk.py::
test_shared_row_keeps_the_reference_least_entry_rule). When a block's
first token lies in the row of the previous block's EOB, inside one
group, that row is walked from the previous block's entry only, so the
block's tokens in it are never marked and the decode fails its CRC.

For each level this compresses utils/corpus.mixed_corpus(N) (8 MiB by
default) with the port's encoder as indexed gzip in 256 KiB chunks,
finds every block's header and EOB with the host C scan
(native.scan_anchors) and the header parse, partitions the chunks into
the per-bit path's groups as models/inflate_device.decompress_indexed
does, and prints one JSON line: the Huffman blocks by type, the pairs
of consecutive Huffman blocks in one group, and the pairs whose second
block's first token shares a row with the first block's EOB, by the
second block's type. The device defaults to the card, as compress's.
"""
from __future__ import annotations

import argparse
import json

from zzflate_tpu_torch import api, native
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.models.inflate import (
    _FIXED_LL,
    BitReader,
    _read_dynamic_tables,
)
from zzflate_tpu_torch.utils import containers, corpus

CHUNK = 1 << 18


def _eob_bits(dec) -> int:
    """The code length of symbol 256 (EOB) in a canonical decoder."""
    k = dec.syms.index(256)
    for ln in range(1, dec.max_len + 1):
        if dec.offsets[ln] <= k < dec.offsets[ln] + dec.counts[ln]:
            return ln
    raise ValueError("no EOB code")


def _groups(sizes: list[int], chunk: int) -> list[tuple[int, int]]:
    """The per-bit path's chunk groups (decompress_indexed's partition
    with its body and output caps)."""
    body_cap = idv._GROUP_BODY
    out_cap = max(idv._GROUP_OUT, chunk)
    groups, lo, acc = [], 0, 0
    for i, sz in enumerate(sizes):
        if (acc + sz > body_cap or (i + 1 - lo) * chunk > out_cap) and i > lo:
            groups.append((lo, i))
            lo, acc = i, 0
        acc += sz
    groups.append((lo, len(sizes)))
    return groups


def scan(blob: bytes) -> dict:
    header_len, chunk, _total, chunks = containers.parse_gzip_index(blob)
    body = blob[header_len:-8]
    blocks, _anchors, _out, end_bit = native.scan_anchors(body, 1 << 30)
    starts = [int(b) for b in blocks[:, 0]] + [int(end_bit)]
    sizes = [sz for sz, _b, _a in chunks]
    cpos = [0]
    for sz in sizes:
        cpos.append(cpos[-1] + sz)
    group_of, group_bit0 = [], []
    for g, (lo, hi) in enumerate(_groups(sizes, chunk)):
        group_of += [g] * (hi - lo)
        group_bit0 += [8 * cpos[lo]] * (hi - lo)

    def chunk_of(bit: int) -> int:
        return max(i for i in range(len(sizes)) if 8 * cpos[i] <= bit)

    units = []  # (btype, first token bit, EOB bit, group, group's bit 0)
    for k, (start, btype) in enumerate(zip(starts, blocks[:, 1])):
        if btype not in (1, 2):
            continue
        br = BitReader(body, start + 3)
        ll = _FIXED_LL if btype == 1 else _read_dynamic_tables(br)[0]
        c = chunk_of(start)
        units.append((int(btype), br.bitpos, starts[k + 1] - _eob_bits(ll),
                      group_of[c], group_bit0[c]))
    indexed = sum(len(b) for sz, b, _a in chunks)
    if indexed != len(units):
        raise AssertionError(f"index lists {indexed} blocks, scan {len(units)}")
    pairs = shared = 0
    shared_by_type = {"fixed": 0, "dynamic": 0}
    for (_t0, _f0, eob, g0, base), (t1, first, _e1, g1, _b1) in zip(
            units, units[1:]):
        if g0 != g1:
            continue
        pairs += 1
        if (eob - base) // idv._R == (first - base) // idv._R:
            shared += 1
            shared_by_type["fixed" if t1 == 1 else "dynamic"] += 1
    return {"blocks_fixed": sum(u[0] == 1 for u in units),
            "blocks_dynamic": sum(u[0] == 2 for u in units),
            "groups": len(set(group_of)), "pairs_in_a_group": pairs,
            "shared_row_pairs": shared, "shared_by_next_type": shared_by_type}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bytes", type=int, default=8 << 20)
    ap.add_argument("--levels", type=int, nargs="+", default=[1, 6])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    data = corpus.mixed_corpus(args.bytes, seed=0)
    for level in args.levels:
        blob = api.compress(data, level=level, format="gzip",
                            chunk_bytes=CHUNK, indexed=True,
                            device=args.device)
        print(json.dumps({"level": level, "bytes": args.bytes,
                          "stream_bytes": len(blob), **scan(blob)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
