"""sign_topk_roofline: SignTopK's share of its bandwidth roofline, the
frozen bytes of one launch over the whole ensemble at HBM3's peak, over
the kernel's mean device time per launch in the profile."""
from harness.yardstick import PEAK_HBM_BYTES_PER_S, sign_topk_bytes


def read(record):
    times = [ns for name, ns in record.get("kernels") or []
             if "sign_topk" in name]
    if not times:
        return None
    bound_s = sign_topk_bytes(record["sign_topk_tiles"]) / PEAK_HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(times) / len(times) / 1e9)
