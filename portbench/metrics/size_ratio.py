"""size_ratio: compressed bytes over input bytes, over every call in the
window."""


def read(rec):
    n_in = sum(c[2] for c in rec["calls"])
    return sum(c[3] for c in rec["calls"]) / n_in if n_in else None
