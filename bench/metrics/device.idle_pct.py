"""device.idle_pct: the share of the profiled window in which no kernel,
copy or set ran on the device: 1 - (the union of their intervals) / (the
window from the first step's start to the last activity's end)."""


def read(record):
    busy, window = record.get("busy_s"), record.get("window_s")
    if not window or not busy:
        return None
    return 100.0 * (1.0 - busy / window)
