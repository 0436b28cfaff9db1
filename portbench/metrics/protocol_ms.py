"""Front door: (sum of client latencies - sum of the engine's wall_s) over
the statements completed in the window, a statement."""


def read(r):
    m = r.matched()
    if not m:
        return None
    return sum(s.latency_s - wall for s, wall in m) / len(m) * 1e3
