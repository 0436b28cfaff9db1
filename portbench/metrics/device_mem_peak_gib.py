"""torch.cuda.max_memory_allocated() from the window's open (after
reset_peak_memory_stats) until its last statement ended, in GiB."""


def read(r):
    return r.memory_peak_bytes / 2 ** 30
