"""moe.layer_ms: device time a step inside ``moe.layer`` (every MoE
layer's forward and its checkpointed recompute: routing, experts, shared
experts, combine), inclusive, over the named cycle's steps."""
from harness.spans import per_step_ms


def read(record):
    return per_step_ms(record, "moe.layer", "named_steps")
