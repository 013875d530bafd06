"""sparq_dist.sent_rows_pct: the share of compressed rows that were sent
(triggered), from the program's counters ``sparq.rows_sent`` over
``sparq.rows_compressed`` in the named cycle."""
from harness.spans import share_pct


def read(record):
    return share_pct(record, "sparq.rows_sent", "sparq.rows_compressed")
