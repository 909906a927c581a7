"""decode_scan.stream_split_pct: the share of the foreign decode's scan that
ran in byte ranges of one deflate stream on the host's threads, in percent:
100 x the program's stage decode_scan_stream_split (the ranged scan of a
stream's or a gzip file's blocks, nested in decode_scan) over its stage
decode_scan. 0 where every scan ran in one pass; nothing where the scan did
not run, or where the program has no byte-ranged scan (no
``native._scan_stream_ranges``)."""


def read(rec):
    st = rec.get("stages")
    if not st or not st["stages_ms"].get("decode_scan"):
        return None
    from zzflate_tpu_torch import native

    if not hasattr(native, "_scan_stream_ranges"):
        return None
    ms = st["stages_ms"]
    return 100.0 * ms.get("decode_scan_stream_split", 0.0) / ms["decode_scan"]
