"""moe.route_ms: device time a step inside ``moe.route`` (the router's
logits, top-k, the queue positions' scan and the slot tables, in the
forward and the recompute), inclusive, over the named cycle's steps."""
from harness.spans import per_step_ms


def read(record):
    return per_step_ms(record, "moe.route", "named_steps")
