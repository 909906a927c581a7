"""decode_scan.split_pct: the share of the foreign gzip decode's member scan
that ran in ranges of members on the host's threads, in percent: 100 x the
program's stage decode_scan_split (the ranged scan of BGZF members, nested
in decode_scan) over its stage decode_scan. 0 where every scan ran in one
pass; nothing where the scan did not run, or where the program has no
ranged scan (no ``native.bgzf_starts``)."""


def read(rec):
    st = rec.get("stages")
    if not st or not st["stages_ms"].get("decode_scan"):
        return None
    from zzflate_tpu_torch import native

    if not hasattr(native, "bgzf_starts"):
        return None
    ms = st["stages_ms"]
    return 100.0 * ms.get("decode_scan_split", 0.0) / ms["decode_scan"]
