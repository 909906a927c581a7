"""Kind ``decode``: one ``models.inflate_device.decompress_indexed(blob,
to_device=True)`` a call, ``verify`` left on, synchronised, of an indexed
gzip member that set-up writes from each buffer with
``compress(..., indexed=True)`` at the configuration's settings. Also
reads ``check_sample`` (generator.DeviceDecodeTraffic)."""
import contextlib
import struct

from portbench import bounds, generator


class Traffic(generator.DeviceDecodeTraffic):
    def setup(self) -> None:
        import zzflate_tpu_torch as zt

        if self.codec["format"] != "gzip":
            raise ValueError("indexed members are gzip")
        super().setup()
        self.blobs = [zt.compress(buf, indexed=True, device=self.device,
                                  **self.compress_args())
                      for buf in self.pool]

    def _decode(self, blob: bytes):
        from zzflate_tpu_torch.models import inflate_device

        res = inflate_device.decompress_indexed(blob, to_device=True,
                                                device=self.device)
        if res is None:
            raise RuntimeError("decompress_indexed declined the member")
        self.sync()
        return res

    def run(self, j: int):
        return self._decode(self.blobs[j])

    def in_bytes(self, j: int) -> int:
        return len(self.blobs[j])

    def bound_ms(self, i: int) -> dict[str, float]:
        j = i % len(self.pool)
        body = self.fmt.body_bytes(self.blobs[j])
        return bounds.decode_families(8 * body, len(self.pool[j]))

    def check(self, failed: int) -> dict[str, tuple[int, int]]:
        """Also bad_crc_accepted: 1 when the decoder accepts the pool's
        first member with its trailer CRC-32 altered, 0 when it raises
        ValueError."""
        checks = super().check(failed)
        blob = self.blobs[0]
        (crc,) = struct.unpack("<I", blob[-8:-4])
        bad = blob[:-8] + struct.pack("<I", crc ^ 0xFFFFFFFF) + blob[-4:]
        try:
            self._decode(bad)
            checks["bad_crc_accepted"] = (1, 0)
        except ValueError:
            checks["bad_crc_accepted"] = (0, 0)
        return checks


@contextlib.contextmanager
def control(fmt):
    """The control: the decoder with verify=False, the program's own path
    without the CRC verdict."""
    from zzflate_tpu_torch.models import inflate_device

    orig = inflate_device.decompress_indexed
    inflate_device.decompress_indexed = (
        lambda blob, **kw: orig(blob, **dict(kw, verify=False)))
    try:
        yield
    finally:
        inflate_device.decompress_indexed = orig
