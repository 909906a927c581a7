"""Kind ``decode_foreign``: one ``models.inflate_device.decompress_foreign(
blob, format="gzip", to_device=True)`` a call, ``verify`` left on,
synchronised, of an ordinary gzip member: set-up writes each buffer with
Python's ``gzip`` module (zlib at the configuration's level, windowBits
-15, memLevel 8, FNAME set, mtime 0, no index), as GNU gzip and data
pipelines write .gz files, and checks that ``gzip.decompress`` reads it
back. That is the function ``api.decompress(engine="device")`` reaches
for such a member. A member it declines (None) is a failed call, never a
host decode. Also reads ``check_sample`` (generator.DeviceDecodeTraffic);
the answers, the sample and ``bad_crc_accepted`` are compared as in
``kinds/decode.py``."""
import contextlib
import gzip
import io

from portbench import bounds, generator, trace
from portbench.kinds import decode


def member(buf: bytes, level: int, name: str) -> bytes:
    """One gzip member of buf as the standard library writes a .gz file."""
    bio = io.BytesIO()
    with gzip.GzipFile(filename=name, mode="wb", compresslevel=level,
                       fileobj=bio, mtime=0) as f:
        f.write(buf)
    return bio.getvalue()


class Traffic(decode.Traffic):
    # The foreign path: the anchor walk, the LZ resolve and the CRC; no
    # candidates, commit or scatter kernel runs on it.
    FAMILIES = {"walk": ("anchor_walk_kernel",),
                "resolve": trace.DECODE_FAMILIES["resolve"],
                "crc": trace.DECODE_FAMILIES["crc"]}

    def setup(self) -> None:
        c = self.codec
        if (c["format"], c["window_bits"], c["mem_level"],
                c["strategy"]) != ("gzip", 15, 8, 0):
            raise ValueError("Python's gzip module writes gzip members at "
                             "windowBits 15, memLevel 8, default strategy")
        generator.DeviceDecodeTraffic.setup(self)  # the pool, on the card
        self.blobs = [member(buf, c["level"], f"shard-{j:05d}.jsonl")
                      for j, buf in enumerate(self.pool)]
        for blob, buf in zip(self.blobs, self.pool):
            if gzip.decompress(blob) != buf:
                raise RuntimeError("gzip does not read its member back")

    def _decode(self, blob: bytes):
        from zzflate_tpu_torch.models import inflate_device

        res = inflate_device.decompress_foreign(
            blob, format="gzip", to_device=True, device=self.device)
        if res is None:
            raise RuntimeError("decompress_foreign declined the member")
        self.sync()
        return res

    def bound_ms(self, i: int) -> dict[str, float]:
        """The walk reads the member's deflate body once; the walk's
        tokens (bounds.walk_work's literals and matches) and its unit
        tables and lanes are data, not shapes of the cell, and are left
        out. The resolve and the CRC as bounds.decode_families counts
        them, over the output."""
        j = i % len(self.pool)
        body = self.fmt.body_bytes(self.blobs[j])
        n = len(self.pool[j])
        return {"walk": bounds.least_ms(*bounds.walk_work(body, 0, 0, 0,
                                                          0))[0],
                "resolve": bounds.least_ms(*bounds.resolve_work(n))[0],
                "crc": bounds.least_ms(*bounds.checksum_work(
                    "crc32_rows", n, 1))[0]}


@contextlib.contextmanager
def control(fmt):
    """The control: the decoder with verify=False, the program's own path
    without the CRC verdict."""
    from zzflate_tpu_torch.models import inflate_device

    orig = inflate_device.decompress_foreign
    inflate_device.decompress_foreign = (
        lambda blob, **kw: orig(blob, **dict(kw, verify=False)))
    try:
        yield
    finally:
        inflate_device.decompress_foreign = orig
