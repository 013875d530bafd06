"""moe.drop_pct: the share of routed choices dropped past their expert's
capacity, from the program's counters ``moe.dropped`` over
``moe.choices`` (each forward routing once) in the named cycle."""
from harness.spans import share_pct


def read(record):
    return share_pct(record, "moe.dropped", "moe.choices")
