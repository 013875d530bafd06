"""model.fwd_bwd_ms: device time a step inside ``sparq.fwd_bwd`` (the
gradient buffer's zeroing and every node's forward and backward,
checkpointed recompute included), inclusive, over the named cycle's steps."""
from harness.spans import per_step_ms


def read(record):
    return per_step_ms(record, "sparq.fwd_bwd", "named_steps")
