"""setup_s: seconds from the process start to the window's start (loading,
building, the inputs, the warm-up)."""


def read(rec):
    return rec["setup_s"]
