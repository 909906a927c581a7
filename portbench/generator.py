"""The one general traffic generator.

A traffic mix is a data file of parameters, ``portbench/traffic/<mix>.json``.
Its ``kind`` names how a call reaches the program: a file
``portbench/kinds/<kind>.py`` with a ``Traffic`` class built on the bases
here, the kernel families its calls run, and a ``control()`` for
``correct``. Its ``data`` names the source of its buffers:
``portbench/data/<source>.py``; the configuration's ``format`` names the
container the reference reads, ``portbench/formats/<format>.py``. Each is
found by name, so a mix of an existing kind on existing data is data
alone, and a new kind, data source, format or kernel family joins by
adding files.

Every mix has ``buffer_bytes`` (the uncompressed bytes of one call) and
``pool`` (distinct buffers, made in set-up from the seed and used in turn,
call by call); a kind reads further keys of its own.

What kinds share is here: the pool and the call; for encoders, every
answer of the window judged by the plain reference as one stream of its
buffer; for decoders onto the card, every answer compared with its
buffer on the card and a sample of them on the host.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from portbench import bounds, trace


class Traffic:
    """One cell's inputs and calls. A kind sets FAMILIES (kernel family:
    kernel names on the device timeline, each family bounded by
    bound_ms) and defines run, keep, check and bound_ms."""

    FAMILIES: dict[str, tuple[str, ...]] = {}

    def __init__(self, mix: dict, codec: dict, seed: int, device, data, fmt):
        self.mix = mix
        self.codec = codec
        self.seed = seed
        self.device = torch.device(device)
        self.data = data  # make(nbytes, seed) of the mix's data source
        self.fmt = fmt  # the container's module in portbench/formats
        self.pool: list[bytes] = []
        self.reset()

    def setup(self) -> None:
        """Make the pool from the seed."""
        n = int(self.mix["buffer_bytes"])
        self.pool = [self.data(n, [self.seed % (1 << 64), j])
                     for j in range(int(self.mix["pool"]))]

    def warm(self) -> None:
        """One call on every buffer of the pool; the answers are dropped."""
        for j in range(len(self.pool)):
            self.run(j)
        self.sync()
        self.reset()

    def reset(self) -> None:
        """Forget every answer kept so far."""
        self.calls = 0

    def compress_args(self) -> dict:
        c = self.codec
        return {"level": c["level"], "format": c["format"],
                "chunk_bytes": c["chunk_bytes"], "strategy": c["strategy"],
                "window_bits": c["window_bits"], "mem_level": c["mem_level"]}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, i: int) -> tuple[int, int]:
        """Call i of the window, on buffer i mod pool; keeps its answer and
        returns (bytes handed in, bytes handed back)."""
        j = i % len(self.pool)
        out = self.run(j)
        self.calls += 1
        return self.keep(j, out)

    def run(self, j: int):
        """One call of the program on buffer j; returns its answer."""
        raise NotImplementedError

    def keep(self, j: int, out) -> tuple[int, int]:
        raise NotImplementedError

    def check(self, failed: int) -> dict[str, tuple[int, int]]:
        """Each number compared, with its limit, once the window has
        closed: {name: (value, limit)}."""
        raise NotImplementedError

    def bound_ms(self, i: int) -> dict[str, float]:
        """Least milliseconds of each kernel family in call i."""
        raise NotImplementedError


class EncodeTraffic(Traffic):
    """Calls that hand back one stream of their buffer in the
    configuration's format. Every answer of the window is judged; one
    equal to an answer already judged takes its verdict."""

    FAMILIES = trace.ENCODE_FAMILIES

    def reset(self) -> None:
        super().reset()
        self.answers: list[tuple[int, bytes]] = []

    def keep(self, j: int, out: bytes) -> tuple[int, int]:
        self.answers.append((j, out))
        return len(self.pool[j]), len(out)

    def check(self, failed: int) -> dict[str, tuple[int, int]]:
        good: dict[int, list[bytes]] = {}
        wrong: dict[int, list[bytes]] = {}
        bad = 0
        for j, out in self.answers:
            if any(out == g for g in good.get(j, ())):
                continue
            if any(out == b for b in wrong.get(j, ())):
                bad += 1
                continue
            if self.fmt.fault(out, self.pool[j],
                              self.codec["window_bits"]) is None:
                good.setdefault(j, []).append(out)
            else:
                wrong.setdefault(j, []).append(out)
                bad += 1
        return {"failed_calls": (failed, 0), "bad_outputs": (bad, 0)}

    def bound_ms(self, i: int) -> dict[str, float]:
        j = i % len(self.pool)
        return bounds.encode_families(self.codec["level"], len(self.pool[j]),
                                      self.codec["chunk_bytes"])


class DeviceDecodeTraffic(Traffic):
    """Calls that leave (uint8 tensor, length) on the card. Every answer
    is compared whole with its buffer on the card, with no host sync in
    the window; ``check_sample`` answers, drawn from the seed, are kept
    and compared again on the host once the window has closed. A kind
    defines in_bytes(j), the bytes a call on buffer j hands in."""

    FAMILIES = trace.DECODE_FAMILIES

    def setup(self) -> None:
        super().setup()
        self.refs = [torch.from_numpy(np.frombuffer(b, np.uint8).copy())
                     .to(self.device) for b in self.pool]

    def reset(self) -> None:
        super().reset()
        self.sample: list = []
        self.bad_len = 0
        self.bad_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self._rng = random.Random(self.seed)

    def in_bytes(self, j: int) -> int:
        raise NotImplementedError

    def keep(self, j: int, res) -> tuple[int, int]:
        t, n = res
        ref = self.refs[j]
        if n != ref.numel() or t.numel() < n:
            self.bad_len += 1
        else:
            self.bad_dev += (t[:n] != ref).any()
        k = int(self.mix["check_sample"])  # a reservoir sample
        if len(self.sample) < k:
            self.sample.append((j, res))
        else:
            r = self._rng.randrange(self.calls)
            if r < k:
                self.sample[r] = (j, res)
        return self.in_bytes(j), n

    def check(self, failed: int) -> dict[str, tuple[int, int]]:
        sampled = 0
        for j, (t, n) in self.sample:
            got = t[:n].cpu().numpy().tobytes() if n <= t.numel() else None
            sampled += got != self.pool[j]
        bad = self.bad_len + int(self.bad_dev.item())
        self.sample = []
        return {"failed_calls": (failed, 0), "bad_outputs": (bad, 0),
                "bad_sampled": (sampled, 0)}
