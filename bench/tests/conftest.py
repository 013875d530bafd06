"""The benchmark's own tests: run them from the root of the checkout with
``PYTHONPATH=src python -m pytest -q bench/tests`` (the card's with ``-m
cuda`` on a machine that has one)."""
import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# sizes a test run on the CPU can hold, every other key as the cell has it
TINY = {"moe": dict(hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=32, n_routed_experts=4,
                    n_shared_experts=1, num_experts_per_tok=2,
                    num_attention_heads=2, num_key_value_heads=2,
                    vocab_size=128),
        "dense": dict(hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, vocab_size=128)}
# larger, still a test run's: the control's float8 products need longer
# contractions than TINY's to stand out of bfloat16's rounding
SMALL = {"moe": dict(hidden_size=256, intermediate_size=512,
                     moe_intermediate_size=128, n_routed_experts=8,
                     n_shared_experts=1, num_experts_per_tok=2,
                     num_attention_heads=4, num_key_value_heads=4,
                     vocab_size=512),
         "dense": dict(hidden_size=256, intermediate_size=512,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=4, vocab_size=512)}


def tiny_cell(name: str, compute_dtype: str = "bfloat16", sizes=TINY,
              seq_len: int = 32):
    """Cell ``name`` at a test run's size: its configuration's widths,
    depth and vocabulary cut (``TINY`` or ``SMALL``), 2 x ``seq_len``
    tokens a node."""
    from harness import spec
    c = spec.cell(name, ROOT)
    cfg = copy.deepcopy(c.config)
    cfg.update(sizes["moe" if "n_routed_experts" in cfg else "dense"])
    cfg["port"]["set"]["compute_dtype"] = compute_dtype
    w = dict(c.workload, batch_per_node=2, seq_len=seq_len)
    return dataclasses.replace(c, config=cfg, workload=w)


@pytest.fixture
def float32_scores(monkeypatch):
    """The program's attention scores in float32 (bfloat16 by default),
    so that a float32 program can be held to the reference tightly."""
    import torch

    from repro_torch.models import attention
    defaults = list(attention.chunked_attention.__defaults__)
    defaults[-1] = torch.float32
    monkeypatch.setattr(attention.chunked_attention, "__defaults__",
                        tuple(defaults))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
