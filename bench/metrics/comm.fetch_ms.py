"""comm.fetch_ms: device time a sync inside ``comm.fetch`` (the rows a
mesh's rank fetches for the sync's mixing: the sends, the receives and any
staging), inclusive, over the named syncs of the traced cycles with the
program's spans on; the slowest rank's."""
from harness.spans import per_step_ms


def read(record):
    got = [per_step_ms(r, "comm.fetch", "named_syncs")
           for r in record.get("ranks") or []]
    got = [ms for ms in got if ms is not None]
    return max(got) if got else None
