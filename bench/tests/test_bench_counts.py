"""The frozen counts equal the hand counts: model FLOPs per token and
SignTopK's bytes per tile."""
import torch
from conftest import ROOT

from harness import sizes as layout
from harness import spec, yardstick


def sizes(config):
    return layout.of(spec.load_json(
        ROOT / "bench" / "configs" / f"{config}.json"))


def test_deepseek_moe_at_depth_two():
    s = sizes("dsmoe16b-d2n4")
    parts = s.active_matmul_params()
    # head 2048 x 102400; dense layer: attention 4 x 2048^2 and SwiGLU of
    # 10944; MoE layer: attention, router 2048 x 64, 6 routed and 2 shared
    # experts of 1408
    assert parts == {"head": 209_715_200, "seg0": 84_017_152,
                     "seg1": 86_114_304}
    assert sum(parts.values()) == 379_846_656
    assert s.flops_per_token(512) == 2_304_245_760
    assert s.flops_per_token(128) == 2_285_371_392


def test_stablelm():
    s = sizes("stablelm1.6b-n2")
    parts = s.active_matmul_params()
    assert parts == {"head": 205_520_896, "seg0": 24 * 51_380_224}
    assert sum(parts.values()) == 1_438_646_272
    assert s.flops_per_token(512) == 8_933_867_520


def test_sign_topk_bytes_are_the_programs():
    from repro_torch.kernels.sign_topk import work_bytes
    assert yardstick.SIGN_TOPK_BYTES_PER_TILE == 8196
    for tiles in (1, 7_692, 4_262_952):
        assert yardstick.sign_topk_bytes(tiles) == work_bytes(
            tiles, torch.float32, False)
