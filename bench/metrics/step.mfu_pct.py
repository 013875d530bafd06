"""step.mfu_pct: the frozen model FLOPs of the profiled steps over their
host wall time, as a share of the card's bf16 peak. Nothing when the
profile holds no device kernel (a run without a card)."""
from harness.yardstick import PEAK_BF16_FLOPS


def read(record):
    steps, window = record.get("profiled_steps"), record.get("window_s")
    if not steps or not window or not record.get("kernels"):
        return None
    flops = record["flops_per_token"] * record["tokens_per_step"] * steps
    return 100.0 * flops / window / PEAK_BF16_FLOPS
