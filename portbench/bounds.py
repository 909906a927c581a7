"""The yardstick of the kernels' roofline shares: the H100's peaks and the
bytes and integer operations each kernel's work needs.

Frozen copies of the port's own arithmetic, kept here so that no change to
the program can move them: ``chip_smoke.bound`` (scan, propagate, parse),
``walk_bound`` with ``WALK_OPS_*``, ``commit_bound`` with ``COMMIT_OPS_*``,
``cks_bound`` with ``CKS_OPS_PER_BYTE``, and ``utils/lz_tail_bench``'s
``candidates_bound`` (``CAND_*``), ``scatter_bound`` and ``resolve_bound``.
``portbench/tests/test_portbench_frozen.py`` holds each equal to its
original while the original exists.

The originals count some terms from a launch's own arguments (tokens
committed, marks set). The cell-level functions at the end count from the
shapes the cell hands the program instead: rows and positions by level
for the encoder, compressed bits and output bytes for the decoder, so a
redesigned kernel is held to the same work. A term those shapes do not
give is left out, which keeps every bound a lower one; each such term is
named where it is dropped.

The least time of a kernel is the larger of its bytes over HBM_BYTES_PER_S
and its operations over INT_OPS_PER_S. Every input byte is counted read
once and every output byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM 32-bit integer rate: the compare, select, min and add work of
# the bounds runs on the integer pipe, 64 lanes per SM (not the 128 fp32
# lanes, nor an FMA counted twice): 132 SMs x 64 lanes x 1.98 GHz.
INT_OPS_PER_S = 132 * 64 * 1.98e9  # 16.7e12 op/s

WINDOW = 32768  # the halo each encoder row carries before its chunk
PARSE_ROW = 512  # the parse's serial row (ops/matcher._ROW)
# Candidates scanned per position by level (config.LEVELS[l].candidates);
# order A scans min(K, 8) backward only, order B K both ways.
LEVEL_CANDIDATES = {1: 4, 2: 6, 3: 8, 4: 8, 5: 12, 6: 16, 7: 20, 8: 24,
                    9: 32}
ORDER_A_MAX = 8

# Integer operations of the walk's step (chip_smoke.WALK_OPS_*).
WALK_OPS_LITERAL = 30
WALK_OPS_MATCH = 63
# The commit walk: P1 and P2a a bit, P3 a committed token.
COMMIT_OPS_BIT = 7
COMMIT_OPS_MARK = 4
# decode_candidates: 22 B of outputs a bit; 59 operations a bit and 4 a
# table entry in the reference's table form.
CAND_BYTES_BIT = 22
CAND_OPS_BIT = 59
CAND_OPS_ENTRY = 4
CAND_TABLE = 1 << 15  # entries of each of a unit's two tables
# The checksums' operations a byte.
CKS_OPS_PER_BYTE = {"crc32_rows": 4, "adler32_rows": 2}
RESOLVE_BYTES = 13  # start_mark, dist_at, litval read (12 B), the byte written


def least_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations", whichever bounds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# -- One launch's work, as the originals count it: (bytes, operations). ----

def scan_work(rows: int, positions: int, k_each: int,
              backward_only: bool) -> tuple[int, int]:
    """scan_candidates over (rows, positions): the LCP, position and result
    arrays (16 B an element) and the rows' window starts; 3 operations per
    element and neighbour-direction (running LCP min, range test, packed
    max)."""
    elems = rows * positions
    return (elems * 16 + rows * 4,
            elems * k_each * (1 if backward_only else 2) * 3)


def propagate_work(rows: int, positions: int) -> tuple[int, int]:
    """propagate_matches: 8 B an element, 5 operations (sliding max, gate)."""
    elems = rows * positions
    return elems * 8, elems * 5


def parse_work(rows: int, positions: int, committed: int = 0
               ) -> tuple[int, int]:
    """parse_rows over the step padded to whole rows of PARSE_ROW: 8 B an
    element and the starts; 4 operations a position and a committed token,
    and 4 a row."""
    npad = -(-positions // PARSE_ROW) * PARSE_ROW
    elems = rows * npad
    return (elems * 8 + rows * 4,
            (elems + committed) * 4 + rows * (npad // PARSE_ROW) * 4)


def walk_work(body_bytes: int, changed: int, table_bytes: int, literals: int,
              matches: int) -> tuple[int, int]:
    """anchor_walk: the body read once, each changed packed entry read and
    written (8 B), the unit tables and lanes; the step's operations by
    token kind."""
    return (body_bytes + changed * 8 + table_bytes,
            literals * WALK_OPS_LITERAL + matches * WALK_OPS_MATCH)


def commit_work(nbits: int, starts: int = 0, marks: int = 0
                ) -> tuple[int, int]:
    """commit_walk: the step read as int32 and the mark written (5 B a
    bit), the starts and flags (5 B each); COMMIT_OPS_* a bit and mark."""
    return (nbits * 5 + starts * 5,
            nbits * COMMIT_OPS_BIT + marks * COMMIT_OPS_MARK)


def candidates_work(nbits: int, units: int = 0) -> tuple[int, int]:
    """decode_candidates: its outputs' bytes; the table form's operations."""
    return (nbits * CAND_BYTES_BIT,
            nbits * CAND_OPS_BIT + units * 2 * CAND_TABLE * CAND_OPS_ENTRY)


def scatter_work(nbits: int, committed: int = 0, tokens: int = 0,
                 literals: int = 0, lengths: int = 0, kept: int = 0
                 ) -> tuple[int, int]:
    """token_scatter: the mask (1 B a bit); at the committed bits their two
    flags; at the tokens the offset (8 B) and the literal or distance (4 B
    each kind); the three int32 entries of each kept token read and
    written."""
    return (nbits + 2 * committed + 8 * tokens + 4 * literals + 4 * lengths
            + 24 * kept, 0)


def resolve_work(n: int) -> tuple[int, int]:
    """resolve_lz as one pass over n output positions."""
    return n * RESOLVE_BYTES, 0


def checksum_work(name: str, nbytes: int, rows: int,
                  tensor_bounds: bool = True) -> tuple[int, int]:
    """crc32_rows / adler32_rows: each byte of the ranges read once, the
    row bounds (when they are tensors) and 8 B a row written."""
    moved = (16 if tensor_bounds else 8) * rows
    return nbytes + moved, nbytes * CKS_OPS_PER_BYTE[name]


# -- A cell's calls, from the shapes it hands the program. ----------------

def encode_families(level: int, nbytes: int, chunk_bytes: int
                    ) -> dict[str, float]:
    """Least milliseconds of each matcher kernel over one one-shot or
    streamed encode of nbytes, each launch bounded alone: ceil(nbytes /
    chunk_bytes) rows of WINDOW + chunk_bytes positions (padded batch rows
    are not counted). The parse's committed tokens are data, not shape,
    and are left out."""
    rows = max(1, -(-nbytes // chunk_bytes))
    positions = WINDOW + chunk_bytes
    k = LEVEL_CANDIDATES[max(1, level)]
    a = least_ms(*scan_work(rows, positions, min(k, ORDER_A_MAX), True))[0]
    b = least_ms(*scan_work(rows, positions, k, False))[0]
    return {"scan": a + b,
            "propagate": least_ms(*propagate_work(rows, positions))[0],
            "parse": least_ms(*parse_work(rows, positions))[0]}


def decode_families(body_bits: int, out_bytes: int) -> dict[str, float]:
    """Least milliseconds of each per-bit path kernel over one decode of a
    member whose deflate body holds body_bits bits and decodes to
    out_bytes: the candidates and the commit walk over every body bit (the
    units' tables, the starts and the marks left out), the scatter's mask
    (its tokens left out), the resolve as one pass over the output, and
    the CRC over the output as one row (the groups' row bounds, 16 B
    each, left out)."""
    return {"candidates": least_ms(*candidates_work(body_bits))[0],
            "commit": least_ms(*commit_work(body_bits))[0],
            "scatter": least_ms(*scatter_work(body_bits))[0],
            "resolve": least_ms(*resolve_work(out_bytes))[0],
            "crc": least_ms(*checksum_work("crc32_rows", out_bytes, 1))[0]}
