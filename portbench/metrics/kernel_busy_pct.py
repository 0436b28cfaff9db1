"""Kernels: the time the port's own kernels (the __global__ functions of
trino_tpu_torch/csrc) ran, as a share of the time the device was busy.
Nothing where none of them ran in the traced window."""


def read(r):
    if r.trace is None:
        return None
    busy, own = r.trace.busy_s(), r.trace.busy_of(r.kernel_names)
    if busy <= 0 or own <= 0:
        return None
    return 100.0 * own / busy
