"""Kind ``decode_zlib``: one ``models.inflate_device.decompress_foreign(
blob, format="zlib", to_device=True)`` a call, ``verify`` left on,
synchronised, of a zlib stream (RFC 1950): set-up writes each buffer with
``zlib.compress(buf, level)``, as numcodecs' ``Zlib`` codec writes a
Zarr chunk (windowBits 15, memLevel 8, default strategy), and checks that
``zlib.decompress`` reads it back. That is the function
``api.decompress(engine="device")`` reaches for such a stream. A stream
it declines (None) is a failed call, never a host decode. Also reads
``check_sample`` (generator.DeviceDecodeTraffic); the answers and the
sample are compared as in ``kinds/decode.py``, and
``bad_adler_accepted`` flips the trailer's Adler-32."""
import struct
import zlib

from portbench import bounds, generator, trace
from portbench.kinds import decode_foreign


class Traffic(decode_foreign.Traffic):
    # The foreign path over a zlib stream: the anchor walk, the LZ resolve
    # and the Adler-32 on the card; no CRC runs on it.
    FAMILIES = {"walk": ("anchor_walk_kernel",),
                "resolve": trace.DECODE_FAMILIES["resolve"],
                "adler": ("adler_blocks_kernel", "adler_rows_kernel")}

    def setup(self) -> None:
        c = self.codec
        if (c["format"], c["window_bits"], c["mem_level"],
                c["strategy"]) != ("zlib", 15, 8, 0):
            raise ValueError("zlib.compress writes zlib streams at "
                             "windowBits 15, memLevel 8, default strategy")
        generator.DeviceDecodeTraffic.setup(self)  # the pool, on the card
        self.blobs = [zlib.compress(buf, c["level"]) for buf in self.pool]
        for blob, buf in zip(self.blobs, self.pool):
            if zlib.decompress(blob) != buf:
                raise RuntimeError("zlib does not read its stream back")

    def _decode(self, blob: bytes):
        from zzflate_tpu_torch.models import inflate_device

        res = inflate_device.decompress_foreign(
            blob, format="zlib", to_device=True, device=self.device)
        if res is None:
            raise RuntimeError("decompress_foreign declined the stream")
        self.sync()
        return res

    def bound_ms(self, i: int) -> dict[str, float]:
        """As kinds/decode_foreign.py's, with the Adler-32 over the
        output as one row in place of the CRC-32 (the groups' row bounds
        left out)."""
        j = i % len(self.pool)
        body = self.fmt.body_bytes(self.blobs[j])
        n = len(self.pool[j])
        return {"walk": bounds.least_ms(*bounds.walk_work(body, 0, 0, 0,
                                                          0))[0],
                "resolve": bounds.least_ms(*bounds.resolve_work(n))[0],
                "adler": bounds.least_ms(*bounds.checksum_work(
                    "adler32_rows", n, 1))[0]}

    def check(self, failed: int) -> dict[str, tuple[int, int]]:
        """Also bad_adler_accepted: 1 when the decoder accepts the pool's
        first stream with its trailer Adler-32 XORed with 0xFFFFFFFF, 0
        when it raises ValueError."""
        checks = generator.DeviceDecodeTraffic.check(self, failed)
        blob = self.blobs[0]
        (adler,) = struct.unpack(">I", blob[-4:])
        bad = blob[:-4] + struct.pack(">I", adler ^ 0xFFFFFFFF)
        try:
            self._decode(bad)
            checks["bad_adler_accepted"] = (1, 0)
        except ValueError:
            checks["bad_adler_accepted"] = (0, 0)
        return checks


control = decode_foreign.control
