"""step.launches_per_step: device kernels per step over the profiled
steps (copies and sets left out): every kernel of the train step, the
models' forward and backward per node, the local step, the sync's chunked
passes, SignTopK."""


def read(record):
    steps = record.get("profiled_steps")
    if not steps or not record.get("kernels"):
        return None
    return len(record["kernels"]) / steps
