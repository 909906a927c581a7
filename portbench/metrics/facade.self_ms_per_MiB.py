"""facade.self_ms_per_MiB: milliseconds per MiB of input of the calls (the
benchmark's span around each) that none of the program's stages covers:
the API, framing, host checksums and pipeline glue."""


def read(rec):
    st = rec.get("stages")
    return st["self_ms"] / st["in_mib"] if st and st["in_mib"] else None
