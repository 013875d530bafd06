"""Bit accounting for compressed decentralized messages (counterpart of
``repro/core/bits.py``; the formulas are the reference's, copied).

Conventions:
* Uncompressed float = 32 bits.
* Top-k index = ceil(log2(d)) bits per selected coordinate.
* Sign = 1 bit per coordinate + one 32-bit scale per tensor.
* QSGD with s levels = 32-bit norm + per coordinate 1 sign bit +
  ceil(log2(s+1)) level bits.
* A node that does not trigger sends a 1-bit flag; one that triggers sends
  flag + payload.

Accumulation: the reference runs with 64-bit floats off, so its bit totals
are float32 scalars with a Kahan compensation term (``bits.py:37-55``). The
port keeps exactly that, so totals agree with the reference's.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

FLOAT_BITS = 32.0
FLAG_BITS = 1.0


def acc_init(device: Union[str, torch.device] = "cpu"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, compensation) float32 scalar pair on ``device``."""
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def acc_add(total: torch.Tensor, comp: torch.Tensor, inc: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kahan-compensated add: returns the updated (total, compensation)."""
    inc = torch.as_tensor(inc, device=total.device).to(total.dtype)
    y = inc - comp
    t = total + y
    return t, (t - total) - y


def dense_bits(d: int) -> float:
    return FLOAT_BITS * d


def topk_index_bits(d: int, k: int) -> float:
    return k * math.ceil(math.log2(max(d, 2)))


def topk_bits(d: int, k: int) -> float:
    """k fp32 values + k indices."""
    return k * FLOAT_BITS + topk_index_bits(d, k)


def sign_bits(d: int) -> float:
    """1 bit/coordinate + one fp32 scale."""
    return d + FLOAT_BITS


def signtopk_bits(d: int, k: int) -> float:
    """k sign bits + k indices + one fp32 scale."""
    return k + topk_index_bits(d, k) + FLOAT_BITS


def qsgd_bits(d: int, s: int) -> float:
    return FLOAT_BITS + d * (1 + math.ceil(math.log2(s + 1)))


def message_bits(payload_bits: float, triggered: bool) -> float:
    """Bits actually sent by one node to ONE neighbor at a sync index."""
    return FLAG_BITS + (payload_bits if triggered else 0.0)
