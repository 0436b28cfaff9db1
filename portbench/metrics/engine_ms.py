"""Engine: the mean QueryCompletedEvent.wall_s of the statements completed
in the window."""


def read(r):
    m = r.matched()
    if not m:
        return None
    return sum(wall for _, wall in m) / len(m) * 1e3
