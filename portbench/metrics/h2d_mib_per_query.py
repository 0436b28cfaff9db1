"""Scan: host-to-device copy bytes in the device trace, a completed statement
(nothing where the trace gives no copy's size)."""


def read(r):
    done = r.done()
    if r.trace is None or r.trace.h2d_bytes is None or not done:
        return None
    return r.trace.h2d_bytes / 2 ** 20 / len(done)
