"""sparq_dist.local_step_ms: device time a step inside
``sparq.local_step`` (the optimizer's in-place update of every node's row),
over the named cycle's steps."""
from harness.spans import per_step_ms


def read(record):
    return per_step_ms(record, "sparq.local_step", "named_steps")
