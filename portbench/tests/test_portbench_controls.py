"""`correct` comes out false for the control and for each fault a cell can
have, planted in the program under a run at a small size on the CPU (the
harness's look for a card skipped): an answer altered where it is made,
half of a call's input left out, and a call that hands back nothing of
its work. The program as it is comes out correct."""
import pytest
import torch

import zzflate_tpu_torch as zt
from portbench import harness
from zzflate_tpu_torch.models import inflate_device

SMALL = {"traffic": {"buffer_bytes": 40000, "pool": 2, "check_sample": 4},
         "codec": {"chunk_bytes": 4096}}
CELLS = {"gzip6.compress-8m": SMALL, "gzip9.compress-8m": SMALL,
         "gzip6.decode-64m": SMALL}


def _run(workload):
    return harness.run_cell(workload, 2**31 + 77, 0.0, False, device="cpu",
                            overrides=CELLS[workload])


def _flip(b: bytes) -> bytes:
    i = len(b) // 2
    return b[:i] + bytes([b[i] ^ 0x10]) + b[i + 1:]


def _encode_faults(monkeypatch, fault):
    orig = zt.compress

    def compress(data, **kw):
        if fault == "altered":
            return _flip(orig(data, **kw))
        if fault == "half":
            return orig(data[:len(data) // 2], **kw)
        return orig(b"", **kw)  # nothing of the call's work

    monkeypatch.setattr(zt, "compress", compress)


def _decode_faults(monkeypatch, fault):
    orig = inflate_device.decompress_indexed

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

    monkeypatch.setattr(inflate_device, "decompress_indexed", decode)


PLANT = {"gzip6.compress-8m": _encode_faults,
         "gzip9.compress-8m": _encode_faults,
         "gzip6.decode-64m": _decode_faults}


@pytest.mark.parametrize("workload", list(CELLS))
def test_program_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("workload", list(CELLS))
def test_control_is_not_correct(workload):
    """The control, planted by the kind's control(): the trailer's
    checksum zeroed (encoders), verify off (the decoder, held to reject a
    member whose CRC-32 is wrong)."""
    cell = harness.resolve(workload)
    with cell["kind"].control(cell["format"]):
        res = _run(workload)
    assert not res["correct"], res["checks"]
    key = "bad_crc_accepted" if "decode" in workload else "bad_outputs"
    assert res["checks"][key]["value"] >= 1
    assert res["checks"]["failed_calls"]["value"] == 0


@pytest.mark.parametrize("fault", ["altered", "half", "nothing"])
@pytest.mark.parametrize("workload", list(CELLS))
def test_fault_is_not_correct(monkeypatch, workload, fault):
    PLANT[workload](monkeypatch, fault)
    res = _run(workload)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_outputs"]["value"] == res["attempted"]
