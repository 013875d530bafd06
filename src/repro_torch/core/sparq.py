"""Primitives that both SPARQ engines share (counterpart of
``repro/core/sparq.py:56-74``): the event trigger, the consensus mixing and
the bit accounting. The dense (n, d) reference engine itself is not ported
yet (ROADMAP.md, "The reference engine").
"""
from __future__ import annotations

import torch

from repro_torch.core import bits as bits_mod


def trigger_mask(sq_dist: torch.Tensor, c_t, eta) -> torch.Tensor:
    """Line 7 event trigger: ||x^{t+1/2} - x_hat||^2 > c_t eta_t^2, per node
    (all float32)."""
    return sq_dist > c_t * eta * eta


def gossip_mix(W: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Line 15 consensus term sum_j w_ij x_hat_j - x_hat_i, contracting the
    leading node axis of ``x_hat``."""
    return torch.tensordot(W, x_hat, dims=1) - x_hat


def sync_message_bits(trig: torch.Tensor, deg: torch.Tensor,
                      payload_bits: float) -> torch.Tensor:
    """Bits all nodes send at one sync index: flag + trig * payload to each
    of deg_i neighbors, summed in float32 as the reference does."""
    msg = bits_mod.FLAG_BITS + trig.to(torch.float32) * payload_bits
    return torch.sum(msg * deg)
