"""comm.link_pct: the row exchange's share of its roofline: the program's
counter ``comm.fetch_bytes`` a sync (the bytes a rank posts to send plus
those it receives, both directions) over the device time a sync inside
``comm.fetch.wait`` (the transfer), at NVLink's frozen 900e9 B/s, both
directions together; the slowest rank's."""
from harness.spans import per_step_ms

# NVIDIA H100 SXM data sheet: NVLink bytes/s per card, both directions
PEAK_NVLINK_BYTES_PER_S = 900e9


def read(record):
    shares = []
    for r in record.get("ranks") or []:
        wait_ms = per_step_ms(r, "comm.fetch.wait", "named_syncs")
        moved = (r.get("counters") or {}).get("comm.fetch_bytes")
        if not wait_ms or not moved:
            continue
        per_sync = moved / r["named_syncs"]
        shares.append(100.0 * per_sync / (wait_ms / 1e3)
                      / PEAK_NVLINK_BYTES_PER_S)
    return min(shares) if shares else None
