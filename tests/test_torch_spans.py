"""The program's host-only stage spans on the CPU: which of them each path
records and with no device, how they nest, that they change no output
byte, and how stages reach torch.profiler with a collector and without
one. Spans are taken as the benchmark's trace takes them: by a wrapper on
the active collector's ``stage`` method."""
import contextlib
import functools
import gzip
import io
import threading
import time
import zlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import zzflate_tpu_torch as zt
from zzflate_tpu_torch.models import inflate_device
from zzflate_tpu_torch.parallel import compress_sharded
from zzflate_tpu_torch.utils import profiling
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# One thread apiece: the test processes share the CPU (ROADMAP §3).
torch.set_num_threads(1)

CHUNK = 4096
DATA = mixed_corpus(5 * CHUNK + 300, 21)  # six chunks, the last short
ENCODE = ("frame", "frame_checksum", "plan_upload", "host_plan_blocks",
          "host_plan_lengths", "host_plan_header")
DECODE = ("decode_index", "decode_units", "decode_headers", "decode_pack",
          "decode_verify")
FOREIGN = ("decode_scan", "decode_members", "decode_units", "decode_headers",
           "decode_pack", "decode_verify")
ZLIB = ("decode_scan", "decode_units", "decode_headers", "decode_pack",
        "decode_verify")
# Each nested span and the spans it may lie in: at levels 7-9 the optimal
# parse re-plans its chunks inside its own stage.
PARENTS = {
    "frame_checksum": ("frame",),
    "host_plan_blocks": ("host_plan", "optimal_parse"),
    "host_plan_lengths": ("host_plan", "optimal_parse"),
    "host_plan_header": ("host_plan", "optimal_parse"),
    "decode_index": ("decode_plan",),
    "decode_members": ("decode_plan",),
    "decode_units": ("decode_plan",),
    "decode_headers": ("decode_units",),
    "decode_pack": ("decode_plan",),
}


@functools.lru_cache(maxsize=None)
def _indexed_blob() -> bytes:
    return zt.compress(DATA, format="gzip", indexed=True, chunk_bytes=CHUNK,
                       device="cpu")


@functools.lru_cache(maxsize=None)
def _foreign_blob() -> bytes:
    """A member as Python's gzip module writes it: FNAME set, no index."""
    bio = io.BytesIO()
    with gzip.GzipFile(filename="shard-00000", mode="wb", compresslevel=6,
                       fileobj=bio, mtime=0) as f:
        f.write(DATA)
    return bio.getvalue()


def _compress(fmt: str, level: int):
    return lambda: zt.compress(DATA, level=level, format=fmt,
                               chunk_bytes=CHUNK, device="cpu")


def _decode(verify: bool):
    return lambda: inflate_device.decompress_indexed(
        _indexed_blob(), verify=verify, device="cpu")


def _foreign_decode():
    return inflate_device.decompress_foreign(_foreign_blob(), format="gzip",
                                             device="cpu")


def _zlib_foreign_decode(verify: bool = True):
    return inflate_device.decompress_foreign(zlib.compress(DATA, 1),
                                             format="zlib", verify=verify,
                                             device="cpu")


PATHS = {
    "gzip6": (_compress("gzip", 6), ENCODE),
    "zlib6": (_compress("zlib", 6), ENCODE),
    "gzip9": (_compress("gzip", 9), ENCODE),
    "indexed_decode": (_decode(True), DECODE),
    "foreign_decode": (_foreign_decode, FOREIGN),
    "zlib_foreign_decode": (_zlib_foreign_decode, ZLIB),
}


@contextlib.contextmanager
def _recorded(make=None):
    """Activate a collector whose stages are also appended to the yielded
    list as (name, device, start, end, thread). make(original stage) gives
    the context each stage opens; None keeps the collector's own."""
    spans = []
    with profiling.collect() as timer:
        opened = (make or (lambda orig: orig))(timer.stage)

        @contextlib.contextmanager
        def stage(name, device=None):
            t0 = time.perf_counter()
            with opened(name, device):
                yield
            spans.append((name, device, t0, time.perf_counter(),
                          threading.get_ident()))

        timer.stage = stage
        yield spans


@pytest.fixture(scope="module", params=list(PATHS))
def traced_path(request):
    """A path's name, its output under a collector and the spans it
    recorded."""
    call, _want = PATHS[request.param]
    with _recorded() as spans:
        out = call()
    return request.param, out, spans


def test_path_records_its_spans_without_a_device(traced_path):
    name, _out, spans = traced_path
    got = {s[0]: s[1] for s in spans}
    for span in PATHS[name][1]:
        assert span in got, (name, span, sorted(got))
        assert all(s[1] is None for s in spans if s[0] == span), span


def test_spans_nest_in_their_parents(traced_path):
    name, _out, spans = traced_path
    nested = [s for s in spans if s[0] in PARENTS]
    assert nested, name
    for inner, _d, a, b, th in nested:
        assert any(n in PARENTS[inner] and t == th and a0 <= a and b <= b0
                   for n, _d0, a0, b0, t in spans), (name, inner)


def test_spans_change_no_output(traced_path):
    name, out, _spans = traced_path
    assert PATHS[name][0]() == out
    if name.endswith("_decode"):
        assert out == DATA
    else:
        unpack = gzip.decompress if name.startswith("gzip") else (
            zlib.decompress)
        assert unpack(out) == DATA


def test_card_partials_skip_the_host_checksum():
    """compress_sharded takes the trailer from the devices' partials: the
    framing runs, the host checksum pass does not."""
    with _recorded() as spans:
        out = compress_sharded(DATA, mesh=["cpu"] * 2, chunk_bytes=CHUNK)
    names = {s[0] for s in spans}
    assert "frame" in names and "frame_checksum" not in names
    assert zlib.decompress(out) == DATA


def test_decode_without_verify_has_no_verdict():
    with _recorded() as spans:
        out = _decode(False)()
    names = {s[0] for s in spans}
    assert out == DATA
    assert "decode_verify" not in names
    assert {"decode_index", "decode_units", "decode_pack"} <= names


def test_zlib_decode_checks_its_adler_on_the_decode_device():
    """A zlib stream's Adler-32: decode_adler once a group, naming the
    decode device, then one decode_verify after the last of them; no CRC
    stage. With verify off, neither."""
    with _recorded() as spans:
        out = _zlib_foreign_decode()
    assert out == DATA
    names = [s[0] for s in spans]
    adler = [s for s in spans if s[0] == "decode_adler"]
    assert len(adler) == names.count("decode_units") >= 1
    assert all(s[1] == torch.device("cpu") for s in adler)
    assert names.count("decode_verify") == 1 and "decode_crc" not in names
    (verify,) = [s for s in spans if s[0] == "decode_verify"]
    assert max(s[3] for s in adler) <= verify[2]
    with _recorded() as spans:
        out = _zlib_foreign_decode(verify=False)
    names = {s[0] for s in spans}
    assert out == DATA and "decode_units" in names
    assert not names & {"decode_adler", "decode_verify", "decode_crc"}


def test_maybe_stage_off_is_one_shared_null_context():
    a = profiling.maybe_stage("host_plan")
    b = profiling.maybe_stage("frame", torch.device("cpu"))
    assert a is b
    with a, b:  # reentrant
        pass


def _profiled_stage_ranges(call, make=None, collector=True):
    """The "stage:" range names of a profile of call(), and the stages the
    collector opened (None without a collector)."""
    with contextlib.ExitStack() as stack:
        spans = stack.enter_context(_recorded(make)) if collector else None
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        call()
    ranges = [e.name for e in prof.events()
              if e.name.startswith(profiling.STAGE_PREFIX)]
    return ranges, spans


def test_stages_reach_a_profiler_without_a_collector():
    ranges, _ = _profiled_stage_ranges(PATHS["gzip6"][0], collector=False)
    assert {"stage:host_plan", "stage:frame"} <= set(ranges)
    assert profiling.maybe_stage("frame") is profiling.maybe_stage("x")


@pytest.mark.parametrize("hooked", [False, True],
                         ids=["collector", "benchmark_hook"])
def test_one_profiler_range_a_stage(hooked):
    """With a collector, each stage the profiled (main) thread opens gives
    one range: the collector's own, or, with the collector's stage
    replaced by a bare range as the benchmark's profiled calls do, that
    range alone."""
    make = None
    if hooked:
        make = lambda _orig: lambda name, device=None: (  # noqa: E731
            torch.profiler.record_function(profiling.STAGE_PREFIX + name))
    main = threading.get_ident()
    ranges, spans = _profiled_stage_ranges(PATHS["gzip6"][0], make)
    opened = sorted(profiling.STAGE_PREFIX + s[0] for s in spans
                    if s[4] == main)
    assert sorted(ranges) == opened
    assert "stage:frame_checksum" in opened
