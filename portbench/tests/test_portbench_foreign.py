"""The cell zlib-gzip6.decode-foreign-64m at a small size on the CPU (the
harness's look for a card skipped): the program comes out correct; the
control, each fault planted where the answer is made, and a member the
device path declines do not; and the kind bounds exactly the kernel
families of the foreign path."""
import gzip

import pytest
import torch

from portbench import harness
from zzflate_tpu_torch.models import inflate_device

CELL = "zlib-gzip6.decode-foreign-64m"
SMALL = {"traffic": {"buffer_bytes": 40000, "pool": 2, "check_sample": 4}}


def _run():
    return harness.run_cell(CELL, 2**31 + 77, 0.0, False, device="cpu",
                            overrides=SMALL)


def test_program_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"failed_calls", "bad_outputs",
                                  "bad_sampled", "bad_crc_accepted"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"decode_MBps", "setup_s"}


def test_control_is_not_correct():
    """verify=False: the member with its trailer CRC-32 flipped is
    accepted."""
    cell = harness.resolve(CELL)
    with cell["kind"].control(cell["format"]):
        res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_crc_accepted"]["value"] == 1
    assert res["checks"]["failed_calls"]["value"] == 0


@pytest.mark.parametrize("fault", ["altered", "half", "nothing"])
def test_fault_is_not_correct(monkeypatch, fault):
    orig = inflate_device.decompress_foreign

    def decode(blob, **kw):
        t, n = orig(blob, **kw)
        t = t.clone()
        if fault == "altered":
            t[n // 2] ^= 0x10
        elif fault == "half":
            t[n // 2:] = 0
        else:
            t = torch.zeros_like(t)
        return t, n

    monkeypatch.setattr(inflate_device, "decompress_foreign", decode)
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_outputs"]["value"] == res["attempted"]


def test_declined_member_is_a_failed_call(monkeypatch):
    """The device path's None is never decoded on the host: the call
    raises, which the window counts as a failed call."""
    traffic = harness.make_traffic(harness.resolve(CELL), 5, "cpu", SMALL)
    traffic.setup()
    monkeypatch.setattr(inflate_device, "decompress_foreign",
                        lambda blob, **kw: None)
    w = harness.Window(traffic)
    w.call()
    assert w.failed == 1 and "declined" in w.first_error


def test_setup_writes_stdlib_members_and_bounds_three_families():
    cell = harness.resolve(CELL)
    traffic = harness.make_traffic(cell, 2**40 + 3, "cpu", SMALL)
    traffic.setup()
    for j, (blob, buf) in enumerate(zip(traffic.blobs, traffic.pool)):
        assert blob[3] == 0x08  # FNAME alone
        name = blob[10:blob.index(b"\0", 10)]
        assert name == f"shard-{j:05d}.jsonl".encode()
        assert blob[4:8] == bytes(4)  # mtime 0
        assert gzip.decompress(blob) == buf
    bound = traffic.bound_ms(1)
    assert set(bound) == set(traffic.FAMILIES) == {"walk", "resolve", "crc"}
    assert all(ms > 0 for ms in bound.values())
    body = cell["format"].body_bytes(traffic.blobs[1])
    assert bound["walk"] == body / 3.35e12 * 1e3
