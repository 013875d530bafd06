"""sparq_dist.mix_ms: device time a sync inside ``sparq.sync.mix`` (the
x_hat update and the mixing over column chunks, the rows it fetches
included), inclusive, over the named cycle's syncs."""
from harness.spans import per_step_ms


def read(record):
    return per_step_ms(record, "sparq.sync.mix", "named_syncs")
