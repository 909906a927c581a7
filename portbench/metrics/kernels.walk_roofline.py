"""kernels.walk_roofline: percent of the device time of the walk family
(anchor_walk_kernel) that its least time from the cell's shapes fills (the
kind's bound_ms); None when no walk ran."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["family_ms"].get("walk"):
        return None
    return 100.0 * p["family_bound_ms"]["walk"] / p["family_ms"]["walk"]
