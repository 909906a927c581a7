"""The cells bgzf6.decode-bgzf-64m and gzip6.decode-8m-walk at a small size
on the CPU (the harness's look for a card skipped): the program comes out
correct; the control and an altered output do not; set-up writes BGZF
members as SAMv1 §4.1 has them, and indexes that keep their anchors."""
import struct

import pytest

from portbench import harness
from portbench.kinds import decode
from zzflate_tpu_torch.models import inflate_device

BGZF = "bgzf6.decode-bgzf-64m"
WALK = "gzip6.decode-8m-walk"
# Three BGZF data members (the middle one altered by bad_crc_accepted);
# four 4 KiB chunks of an indexed shard.
SMALL = {BGZF: {"traffic": {"buffer_bytes": 150000, "pool": 2,
                            "check_sample": 4}},
         WALK: {"traffic": {"buffer_bytes": 16384, "pool": 1,
                            "check_sample": 1},
                "codec": {"chunk_bytes": 4096}}}
ENTRY = {BGZF: "decompress_foreign", WALK: "decompress_indexed"}


def _run(cell):
    return harness.run_cell(cell, 2**31 + 91, 0.0, False, device="cpu",
                            overrides=SMALL[cell])


@pytest.mark.parametrize("cell", [BGZF, WALK])
def test_program_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"failed_calls", "bad_outputs",
                                  "bad_sampled", "bad_crc_accepted"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"decode_MBps", "setup_s"}


@pytest.mark.parametrize("cell", [BGZF, WALK])
def test_control_is_not_correct(cell):
    """verify=False: the file with a trailer CRC-32 flipped is accepted."""
    c = harness.resolve(cell)
    with c["kind"].control(c["format"]):
        res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_crc_accepted"]["value"] == 1
    assert res["checks"]["failed_calls"]["value"] == 0


@pytest.mark.parametrize("cell", [BGZF, WALK])
def test_altered_output_is_not_correct(monkeypatch, cell):
    orig = getattr(inflate_device, ENTRY[cell])

    def decode(blob, **kw):
        t, n = orig(blob, **kw)
        t = t.clone()
        t[n // 2] ^= 0x10
        return t, n

    monkeypatch.setattr(inflate_device, ENTRY[cell], decode)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_outputs"]["value"] == res["attempted"]


def test_setup_writes_bgzf_members():
    """Each member holds at most 0xff00 input bytes, its BC subfield's
    BSIZE is its length - 1, and the file ends with the end marker; the
    kind flips the middle data member's CRC-32 and bounds three
    families, the walk over the members' bodies."""
    cell = harness.resolve(BGZF)
    traffic = harness.make_traffic(cell, 2**40 + 5, "cpu", SMALL[BGZF])
    traffic.setup()
    eof = cell["kind"].EOF
    for blob, buf in zip(traffic.blobs, traffic.pool):
        assert blob.endswith(eof) and len(eof) == 28
        pos, n_in, bodies = 0, 0, 0
        while pos < len(blob):
            assert blob[pos:pos + 4] == b"\x1f\x8b\x08\x04"
            assert blob[pos + 4:pos + 10] == b"\x00" * 5 + b"\xff"
            xlen, si, slen, bsize = struct.unpack_from("<H2sHH", blob,
                                                       pos + 10)
            assert (xlen, si, slen) == (6, b"BC", 2)
            end = pos + bsize + 1
            assert end - pos <= 1 << 16
            (isize,) = struct.unpack_from("<I", blob, end - 4)
            assert isize <= 0xFF00
            n_in += isize
            bodies += end - pos - 26
            pos = end
        assert pos == len(blob) and n_in == len(buf) == 150000
    assert len(traffic.members[0]) == 4  # three data members, the marker
    bound = traffic.bound_ms(1)
    assert set(bound) == set(traffic.FAMILIES) == {"walk", "resolve", "crc"}
    assert bound["walk"] == bodies / 3.35e12 * 1e3


def test_walk_setup_requires_anchors_in_every_index():
    """The kind's parse of the ZZ subfield reads the port's anchor spacing
    from every shard, and set-up refuses a shard whose index dropped its
    anchors (T = 0), on which the per-bit path would run. At the cell's
    8 MiB the check runs in every set-up on the card: an 8 MiB encode on
    the CPU takes ~2 GB."""
    cell = harness.resolve(WALK)
    traffic = harness.make_traffic(cell, 2**33 + 1, "cpu", SMALL[WALK])
    traffic.setup()
    anchor_tokens = cell["kind"].anchor_tokens
    assert [anchor_tokens(b) for b in traffic.blobs] == [1024]
    assert set(traffic.bound_ms(0)) == {"walk", "resolve", "crc"}
    assert anchor_tokens(b"\x1f\x8b\x08\x00" + bytes(14)) == 0
    blob = bytearray(traffic.blobs[0])
    t_at = 12 + blob[12:].index(b"ZZ") + 14
    assert blob[t_at:t_at + 2] == (1024).to_bytes(2, "little")
    blob[t_at:t_at + 2] = bytes(2)
    assert anchor_tokens(bytes(blob)) == 0
    orig = decode.Traffic.setup

    def setup(self):
        orig(self)
        self.blobs = [bytes(blob)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode.Traffic, "setup", setup)
        with pytest.raises(RuntimeError, match="without anchors"):
            traffic.setup()


def test_parent_style_decline_is_a_failed_call(monkeypatch):
    """A decoder that raises on a multi-member file fails every call of
    the window; the window goes on."""
    traffic = harness.make_traffic(harness.resolve(BGZF), 5, "cpu",
                                   SMALL[BGZF])
    traffic.setup()

    def refuse(blob, **kw):
        raise ValueError("to_device unsupported for multi-member gzip")

    monkeypatch.setattr(inflate_device, "decompress_foreign", refuse)
    w = harness.Window(traffic)
    w.call()
    w.call()
    assert w.failed == 2 and "multi-member" in w.first_error
