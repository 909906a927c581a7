"""Device decode's commit walk (ops/kernels.commit_walk, csrc/commit.cu)
against the JAX package's models/inflate_tpu._commit_walk, on the CPU.

On each seeded case of utils/corpus.commit_walk_inputs, at two nbits,
the plain torch version and ``_commit_mirror``, a numpy mirror of
csrc/commit.cu in its own order (per superrow the staged step codes, P1
row by row in reverse, P2a row by row, the first row's and the starts'
exits; the units' superrow chains; per superrow the entries' row walks
with the least entry a row, and the row marks), equal the reference
array for array. Tolerance is zero: the walk is integer-only. Change
the kernel and its mirror together.

The reference's least-entry rule (a row walks from its least entry
only) is kept on purpose and pinned here: the port must equal the
reference.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zzflate_tpu.models import inflate_tpu as ref
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.utils.corpus import COMMIT_CASES, commit_walk_inputs

# One intra-op thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

R = kernels.COMMIT_ROW
RR = R * R
SINK = 0xFFFF  # the kernel's exit code for "the walk stops"
NBITS = (2 * RR, 4 * RR)

_ref_walk = jax.jit(ref._commit_walk, static_argnums=3)


def _reference(step, start, valid, span):
    return np.asarray(_ref_walk(jnp.asarray(step), jnp.asarray(start),
                                jnp.asarray(valid), span))


def _plain(step, start, valid, span):
    return kernels.commit_walk_plain(
        torch.from_numpy(step), torch.from_numpy(start),
        torch.from_numpy(valid), span).numpy()


# ---------------------------------------------------------------------------
# The numpy mirror of csrc/commit.cu.
# ---------------------------------------------------------------------------


def _codes(step):
    """stage_steps: a step in [1, R] is itself; anything else is 0, a stop."""
    s = step.astype(np.int64).reshape(R, R)
    return np.where((s >= 1) & (s <= R), s, 0)


def _row_exits(codes, last_sup):
    """P1, one thread a row: each row's codes become exit codes in
    reverse (a next-row offset, or SINK); the card's last row has none."""
    a = codes.copy()
    rows = np.arange(R)
    last_row = np.zeros(R, bool)
    last_row[R - 1] = last_sup
    for j in range(R - 1, -1, -1):
        s = a[:, j]
        land = j + s
        inside = a[rows, np.minimum(land, R - 1)]
        a[:, j] = np.where(s == 0, SINK, np.where(
            land < R, inside, np.where(last_row, SINK, land - R)))
    return a


def _commit_mirror(step, start, valid, span):
    nbits = step.shape[0]
    nsup = nbits // RR
    start = start.astype(np.int64)
    u = start.shape[0]
    ok = valid.astype(bool) & (start >= 0) & (start < nbits)

    def absolute(code, sup):
        return np.where(code == SINK, nbits, (sup + 1) * RR + code)

    # Launch 1 (rows): P1, P2a, the first row's and the starts' exits.
    sup_exit = np.zeros(nsup * R, np.int64)
    start_exit = np.zeros(u, np.int64)
    for sup in range(nsup):
        a = _row_exits(_codes(step[sup * RR:(sup + 1) * RR]), sup == nsup - 1)
        for j in range(R - 2, -1, -1):
            x = a[j]
            a[j] = np.where(x != SINK, a[j + 1][np.minimum(x, R - 1)], x)
        sup_exit[sup * R:(sup + 1) * R] = absolute(a[0], sup)
        here = ok & (start // RR == sup)
        off = start[here] - sup * RR
        start_exit[here] = absolute(a[off // R, off % R], sup)

    # Launch 2 (chain): P2b, one thread a unit.
    ents = np.full((max(span, 0), u), nbits, np.int64)
    e = np.where(ok, start, nbits)
    for k in range(span):
        ents[k] = e
        at = np.minimum(e // RR * R + e % RR, nsup * R - 1)
        e = np.where(e < nbits, start_exit if k == 0 else sup_exit[at], nbits)

    # Launch 3 (marks): P1 again, P2c's entry walks, P3's row walks.
    mark = np.zeros(nbits, bool)
    for sup in range(nsup):
        codes = _codes(step[sup * RR:(sup + 1) * RR])
        a = _row_exits(codes, sup == nsup - 1)
        rent = np.full(R, R)
        for v in range(u):
            k = sup - start[v] // RR
            if not ok[v] or not 0 <= k < span or ents[k, v] >= nbits:
                continue
            r, c = (ents[k, v] - sup * RR) // R, ents[k, v] % R
            while True:
                rent[r] = min(rent[r], c)
                x = a[r, c]
                if x == SINK or r == R - 1:
                    break
                r, c = r + 1, x
        for r in range(R):
            c = rent[r]
            while c < R:
                s = codes[r, c]
                mark[sup * RR + r * R + c] = True
                if s == 0:
                    break
                c += s
    return mark


# ---------------------------------------------------------------------------
# Plain version and mirror against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", NBITS, ids=["2RR", "4RR"])
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_plain_and_mirror_equal_reference(case, nbits):
    step, start, valid, span = commit_walk_inputs(case, nbits)
    exp = _reference(step, start, valid, span)
    np.testing.assert_array_equal(_plain(step, start, valid, span), exp)
    np.testing.assert_array_equal(_commit_mirror(step, start, valid, span),
                                  exp)
    # On CPU tensors the wrapper is the plain version.
    got = kernels.commit_walk(torch.from_numpy(step), torch.from_numpy(start),
                              torch.from_numpy(valid), span)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), exp)
    assert exp.sum() > 10


def test_cases_reach_what_they_aim_at():
    """The cases exercise what their names say: blocks across superrows,
    a start on the last bit, a chain cut by max_sup_span, an invalid
    unit's start left alone."""
    nbits = 4 * RR
    step, start, valid, span = commit_walk_inputs("across_superrows", nbits)
    full = _reference(step, start, valid, span)
    assert span == nbits // RR and full[3 * RR:].any()
    step, start, valid, span = commit_walk_inputs("span_cut", nbits)
    cut = _reference(step, start, valid, span)
    assert span == 2 and cut[:2 * RR].any() and not cut[2 * RR:].any()
    step, start, valid, span = commit_walk_inputs("edges", nbits)
    edges = _reference(step, start, valid, span)
    assert list(start[:3]) == [0, nbits - 200, nbits - 1]
    assert edges[0] and edges[nbits - 256:].any()
    step, start, valid, span = commit_walk_inputs("random", nbits)
    assert not valid[5] and not _reference(step, start, valid, span)[start[5]]
    valid[5] = True
    assert _reference(step, start, valid, span)[start[5]]


def test_int32_and_int64_inputs_agree():
    """_decode_bits hands in an int64 step; unit_valid may be int32."""
    step, start, valid, span = commit_walk_inputs("random", 2 * RR)
    exp = _plain(step, start, valid, span)
    got = kernels.commit_walk(torch.from_numpy(step).long(),
                              torch.from_numpy(start).long(),
                              torch.from_numpy(valid.astype(np.int32)), span)
    np.testing.assert_array_equal(got.numpy(), exp)


# ---------------------------------------------------------------------------
# The reference's shared-row rule, pinned.
# ---------------------------------------------------------------------------


def test_shared_row_keeps_the_reference_least_entry_rule():
    """Block 1 starts at bit 120, in the row of block 0's EOB (bit 96).
    The row keeps only its least entry, bit 0, whose walk stops at the
    EOB: bits 120-248 are never marked, in the reference and the port
    alike. Block 1's chain still enters the next row."""
    step, start, valid, span = commit_walk_inputs("shared_row", 2 * RR)
    assert list(start) == [0, 120] and span == 2
    exp = _reference(step, start, valid, span)
    for got in (_plain(step, start, valid, span),
                _commit_mirror(step, start, valid, span)):
        np.testing.assert_array_equal(got, exp)
    marked = np.nonzero(exp)[0]
    np.testing.assert_array_equal(
        marked, np.r_[np.arange(0, 97, 8), np.arange(256, 401, 8)])
    assert not exp[120:249].any()


# ---------------------------------------------------------------------------
# Outside the domain (csrc/kernels.h).
# ---------------------------------------------------------------------------


def test_plain_follows_the_reference_on_a_zero_step():
    """A step of 0 lies outside the domain: the plain version follows the
    reference, whose row sweep then lands on bit 0; the kernel (and its
    mirror) stops the walk there instead."""
    step, start, valid, span = commit_walk_inputs("random", 2 * RR)
    step[990], step[1000] = 10, 0
    start[0] = 990
    exp = _reference(step, start, valid, span)
    np.testing.assert_array_equal(_plain(step, start, valid, span), exp)
    mirror = _commit_mirror(step, start, valid, span)
    assert exp[0] and not mirror[0]
    assert (mirror != exp).any()


def test_starts_outside_the_group():
    """A valid start at or past nbits adds nothing in every version; a
    negative one makes the plain version raise (the kernel ignores it)."""
    step, start, valid, span = commit_walk_inputs("random", 2 * RR)
    exp = _reference(step, start, valid, span)
    past = start.copy()
    past[0] = 2 * RR
    valid_past = valid.copy()
    valid_past[0] = True
    base = valid.copy()
    base[0] = False
    want = _reference(step, start, base, span)
    for got in (_reference(step, past, valid_past, span),
                _plain(step, past, valid_past, span),
                _commit_mirror(step, past, valid_past, span)):
        np.testing.assert_array_equal(got, want)
    neg = start.copy()
    neg[0] = -5
    with pytest.raises(RuntimeError):
        _plain(step, neg, valid_past, span)
    np.testing.assert_array_equal(
        _commit_mirror(step, neg, valid_past, span), want)


# ---------------------------------------------------------------------------
# The wrapper.
# ---------------------------------------------------------------------------


def test_commit_constants_match_kernels_header():
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "kernels.h").read_text()
    defs = dict(re.findall(r"#define (ZZ_COMMIT_\w+) (\d+)\n", src))
    assert defs == {"ZZ_COMMIT_ROW": str(kernels.COMMIT_ROW)}
    assert "commit.cu" in kernels._SOURCES
    assert idv._R == kernels.COMMIT_ROW and idv._RR == RR


def test_decode_path_goes_through_the_wrapper(monkeypatch):
    seen = []

    def rec(*a):
        seen.append(a)
        return "marks"

    monkeypatch.setattr(kernels, "commit_walk", rec)
    args = (torch.zeros(RR, dtype=torch.long),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool),
            1)
    assert idv._commit_walk(*args) == "marks"
    assert len(seen) == 1 and seen[0][3] == 1


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card, as a CUDA tensor does."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_call_without_a_card_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: without a card it
    raises, and the plain version never runs."""
    def no_plain(*a):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kernels, "commit_walk_plain", no_plain)
    step, start, valid, span = commit_walk_inputs("random", RR)
    on = [torch.Tensor._make_subclass(_OnCard, torch.from_numpy(x))
          for x in (step, start, valid)]
    before = dict(kernels.launches)
    with pytest.raises((RuntimeError, AssertionError)) as err:
        kernels.commit_walk(*on, span)
    assert "plain version" not in str(err.value)
    assert kernels.launches == before


@pytest.mark.parametrize("args, exc", [
    ((torch.zeros(RR + 256, dtype=torch.int32), torch.zeros(1),
      torch.ones(1, dtype=torch.bool), 1), ValueError),
    ((torch.zeros((2, RR), dtype=torch.int32), torch.zeros(1),
      torch.ones(1, dtype=torch.bool), 1), ValueError),
    ((torch.zeros(RR, dtype=torch.int32), torch.zeros(2),
      torch.ones(3, dtype=torch.bool), 1), ValueError),
    ((torch.zeros(RR, dtype=torch.int32), torch.zeros(1),
      torch.ones(1, dtype=torch.bool), -1), ValueError),
], ids=["nbits", "ndim", "units", "span"])
def test_wrapper_rejects_what_the_kernel_does_not_take(args, exc):
    with pytest.raises(exc):
        kernels.commit_walk(*args)
