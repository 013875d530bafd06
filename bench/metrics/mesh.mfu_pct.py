"""mesh.mfu_pct: ``step.mfu_pct``'s share over every rank: the frozen model
FLOPs of all nodes' profiled steps over their host wall time (the slowest
rank's), as a share of the cards' bf16 peak together. Nothing when the
profile holds no device kernel (a run without a card)."""
from harness.yardstick import PEAK_BF16_FLOPS


def read(record):
    ranks = record.get("ranks") or []
    if not ranks or not all(r.get("kernels") for r in ranks):
        return None
    steps = ranks[0]["profiled_steps"]
    window = max(r["window_s"] for r in ranks)
    flops = record["flops_per_token"] * record["tokens_per_step"] * steps
    return 100.0 * flops / window / (len(ranks) * PEAK_BF16_FLOPS)
