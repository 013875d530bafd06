"""The frozen yardsticks: the chip's peaks and SignTopK's bytes per tile
(a configuration's model FLOPs per token are its family's,
``bench/references/<name>.py``). A change to the program changes none of
these; the per-layer shares divide by them.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# SignTopK in ensemble mode on float32 tiles: each 1024-element tile read
# once and its q written once (4 B each), and one float32 scale per tile
# written: the program's kernels/sign_topk.work_bytes(1, float32, False)
SIGN_TOPK_BYTES_PER_TILE = 1024 * 4 * 2 + 4


def sign_topk_bytes(n_tiles: int) -> int:
    return n_tiles * SIGN_TOPK_BYTES_PER_TILE
