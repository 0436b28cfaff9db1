"""Kernels: the sum of every kernel wrapper's `launches` counter over the
traced span, a completed statement."""


def read(r):
    done = r.done()
    if not done:
        return None
    return r.launches / len(done)
