"""The configuration zlib1 and its cells zlib1.compress-8m and
zlib1.decode-zlib-64m at small sizes on the CPU (the harness's look for a
card skipped): the zlib container's faults are each named; the program
comes out correct, and the controls do not; both cells resolve with every
metric they list, and a traced run reads the decode cell's Adler-32
stage."""
import json
import zlib

import pytest

from portbench import harness
from portbench.formats import zlib as zfmt
from zzflate_tpu_torch.models import inflate_device

COMPRESS = "zlib1.compress-8m"
DECODE = "zlib1.decode-zlib-64m"
SMALL = {COMPRESS: {"traffic": {"buffer_bytes": 40000, "pool": 2},
                    "codec": {"chunk_bytes": 4096}},
         DECODE: {"traffic": {"buffer_bytes": 65536, "pool": 2,
                              "check_sample": 4}}}
DATA = bytes(range(256)) * 64 + b"zarr chunk " * 500


def _run(cell, traced=False):
    return harness.run_cell(cell, 2**31 + 26, 0.0, traced, device="cpu",
                            overrides=SMALL[cell])


def _with_header(blob: bytes, cmf: int, flg: int) -> bytes:
    return bytes([cmf, flg]) + blob[2:]


def _fcheck(cmf: int, flg: int) -> int:
    flg &= 0xE0
    return flg | (31 - (cmf << 8 | flg) % 31) % 31


FAULTS = {
    "zeroed_adler": (lambda b: zfmt.zero_check(b), "Adler-32"),
    "bad_fcheck": (lambda b: _with_header(b, b[0], b[1] ^ 0x01), "FCHECK"),
    "fdict_set": (lambda b: _with_header(b, b[0], _fcheck(b[0], b[1] | 0x20)),
                  "FDICT"),
    "cinfo_past_window": (lambda b: _with_header(b, 0x88, _fcheck(0x88, b[1])),
                          "CINFO"),
    "extra_bytes": (lambda b: b + b"\x00", "bytes after the deflate data"),
    "wrong_data": (lambda b: zlib.compress(DATA[:-1], 1)[:-4] + b[-4:],
                   "other bytes"),
}


def test_format_passes_a_good_stream():
    for level in (0, 1, 6, 9):
        blob = zlib.compress(DATA, level)
        assert zfmt.fault(blob, DATA, 15) is None
        assert zfmt.body_bytes(blob) == len(blob) - 6
    # FLEVEL is informative only: a level-1 stream with FLEVEL 3 passes.
    blob = zlib.compress(DATA, 1)
    assert zfmt.fault(_with_header(blob, blob[0], _fcheck(blob[0], 0xC0)),
                      DATA, 15) is None


@pytest.mark.parametrize("fault", list(FAULTS))
def test_format_names_each_fault(fault):
    plant, words = FAULTS[fault]
    blob = plant(zlib.compress(DATA, 1))
    why = zfmt.fault(blob, DATA, 15)
    assert why is not None and words in why, why


def test_decode_cell_is_correct_and_its_control_is_not():
    """bad_adler_accepted 0: the trailer's Adler-32 flipped raises on the
    to_device path; under the control (verify=False) it is accepted."""
    res = _run(DECODE)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"failed_calls", "bad_outputs",
                                  "bad_sampled", "bad_adler_accepted"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"decode_MBps", "setup_s"}
    cell = harness.resolve(DECODE)
    with cell["kind"].control(cell["format"]):
        res = _run(DECODE)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_adler_accepted"]["value"] == 1
    assert res["checks"]["failed_calls"]["value"] == 0


def test_decode_setup_writes_zlib_streams_and_bounds_three_families():
    cell = harness.resolve(DECODE)
    traffic = harness.make_traffic(cell, 2**40 + 26, "cpu", SMALL[DECODE])
    traffic.setup()
    for blob, buf in zip(traffic.blobs, traffic.pool):
        assert blob == zlib.compress(buf, 1)
        assert zfmt.fault(blob, buf, 15) is None
    bound = traffic.bound_ms(1)
    assert set(bound) == set(traffic.FAMILIES) == {"walk", "resolve",
                                                   "adler"}
    n = len(traffic.pool[1])
    assert bound["adler"] == (n + 16) / 3.35e12 * 1e3
    assert bound["walk"] == zfmt.body_bytes(traffic.blobs[1]) / 3.35e12 * 1e3


def test_declined_stream_is_a_failed_call(monkeypatch):
    traffic = harness.make_traffic(harness.resolve(DECODE), 5, "cpu",
                                   SMALL[DECODE])
    traffic.setup()
    monkeypatch.setattr(inflate_device, "decompress_foreign",
                        lambda blob, **kw: None)
    w = harness.Window(traffic)
    w.call()
    assert w.failed == 1 and "declined" in w.first_error


def test_compress_cell_is_correct_and_its_control_is_not():
    """The control zeroes every answer's Adler-32: each is a bad output."""
    res = _run(COMPRESS)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"encode_MBps", "size_ratio", "setup_s"}
    cell = harness.resolve(COMPRESS)
    with cell["kind"].control(cell["format"]):
        res = _run(COMPRESS)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_outputs"]["value"] == res["attempted"] > 0
    assert res["checks"]["failed_calls"]["value"] == 0


def test_both_cells_resolve_with_every_metric_they_list():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for name, fmt, e2e in ((COMPRESS, "zlib", {"encode_MBps", "size_ratio",
                                               "setup_s"}),
                           (DECODE, "zlib", {"decode_MBps", "setup_s"})):
        cell = harness.resolve(name)
        assert cell["config"]["codec"]["format"] == fmt
        assert cell["config"]["codec"]["level"] == 1
        assert cell["cell"]["chips"] == 1
        assert {m["name"] for m, _r in cell["end_to_end"]} == e2e
        listed = {m["name"] for m in spec["per_layer"]
                  if name in m.get("workloads", ())}
        assert {m["name"] for m, _r in cell["per_layer"]} == listed
    gzip6 = {m["name"] for m in spec["per_layer"]
             if "gzip6.compress-8m" in m.get("workloads", ())}
    assert {m["name"] for m, _r in harness.resolve(COMPRESS)["per_layer"]} \
        == gzip6
    assert "decode_adler.ms_per_MiB" in {
        m["name"] for m, _r in harness.resolve(DECODE)["per_layer"]}


def test_traced_decode_reads_the_adler_stage():
    """The traced run's stage metrics: decode_adler and decode_verify read
    from the program's spans (device metrics need a card)."""
    res = _run(DECODE, traced=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("decode_adler.ms_per_MiB", "decode_verify.ms_per_MiB",
                 "decode_scan.ms_per_MiB", "decode_walk.ms_per_MiB",
                 "decode_plan.ms_per_MiB", "decode_upload.ms_per_MiB"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms/MiB", name


def test_traced_compress_reads_every_stage_gzip6_reads():
    res = _run(COMPRESS, traced=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("analyze.ms_per_MiB", "emit.ms_per_MiB",
                 "host_plan.ms_per_MiB", "host_plan.blocks_ms_per_MiB",
                 "host_plan.lengths_ms_per_MiB",
                 "host_plan.header_ms_per_MiB", "facade.frame_ms_per_MiB",
                 "facade.host_checksum_ms_per_MiB",
                 "pipeline.plan_upload_ms_per_MiB",
                 "pipeline.batch_stitch_ms_per_MiB"):
        assert m[name]["value"] > 0, name


def test_the_adler_reader_is_silent_without_its_stage():
    """A program that computes no Adler-32 on the card gives the new
    metric nothing to read: the line leaves it out."""
    read = harness.load_module(harness.ROOT, "metrics",
                               "decode_adler.ms_per_MiB").read
    rec = {"stages": {"in_mib": 1.0, "out_mib": 2.0,
                      "stages_ms": {"decode_walk": 3.0}, "self_ms": 0.0}}
    assert read(rec) is None
    rec["stages"]["stages_ms"]["decode_adler"] = 0.5
    assert read(rec) == 0.25
