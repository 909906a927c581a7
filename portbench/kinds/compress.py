"""Kind ``compress``: one ``zzflate_tpu_torch.compress`` of a whole buffer a
call, at the configuration's settings."""
import contextlib

from portbench import generator


class Traffic(generator.EncodeTraffic):
    def run(self, j: int) -> bytes:
        import zzflate_tpu_torch as zt

        return zt.compress(self.pool[j], device=self.device,
                           **self.compress_args())


@contextlib.contextmanager
def control(fmt):
    """The control: every answer with its trailer's checksum zeroed, what
    a change that skipped the host checksum pass would write."""
    import zzflate_tpu_torch as zt

    orig = zt.compress
    zt.compress = lambda data, **kw: fmt.zero_check(orig(data, **kw))
    try:
        yield
    finally:
        zt.compress = orig
