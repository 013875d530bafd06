"""Static bit-accounting oracle, R10 (counterpart of the R10 half of
``repro/analysis/comm_lint.py``).

The paper's headline result is a number of bits, so the engines' charging
(``core/bits.py`` and ``sync_message_bits``) is a measured claim that can
drift from what a run sends. The expected bits of a trajectory follow from
the plan's degrees, the payload, the flag and the faults' ``deg_eff``: sync
round ``r`` happens at step ``t = (r + 1) H - 1`` and the fault masks are
pure functions of ``(seed, t, r)``, so the whole charge sequence is
recomputed here in numpy, sharing only ``FLAG_BITS`` with the engines. R10
holds a short trace of the port's reference engine to that, and every
registry compressor's ``bits(d)`` to a payload formula written out anew.

The reference's R11 (uncharged collectives) reads the compiled XLA module;
the port has none (``rules.RULES["R11"]``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.rules import Finding, finding
from repro_torch.core import bits as bits_mod
from repro_torch.core.compression import (QSGD, BlockTopFrac, Compressor,
                                          Identity, QsTopK, RandK, Sign,
                                          SignTopK, TopFrac, TopK)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.topology import GossipPlan

# --------------------------------------------------------------- payload oracle
#
# Each registry operator's message size, written out against core/bits.py's
# conventions rather than by calling its helpers, so that a drifted formula
# cannot certify itself.

_F = 32.0  # fp32 value / scale / norm / seed


def _idx_bits(d: int, k: int) -> float:
    return k * math.ceil(math.log2(max(d, 2)))


# the kernel's tile width, a literal (not imported from repro_torch.kernels)
# so that a drifted runtime constant cannot certify itself
_KERNEL_BLOCK = 1024


def derive_payload_bits(comp: Compressor, d: int) -> Optional[float]:
    """Closed-form payload bits of one compressed d-vector, or None for a
    compressor outside the registry (nothing to hold it to)."""
    d = int(d)
    if isinstance(comp, BlockTopFrac):        # before TopFrac: subclass
        B = _KERNEL_BLOCK
        k_b = max(1, min(B, math.ceil(comp.frac * B)))
        nb = -(-d // B)                       # padded tile count
        # per tile: k_b signs + k_b tile-local indices + f32 scale
        return nb * (k_b + _idx_bits(B, k_b) + _F)
    if isinstance(comp, TopFrac):             # before SignTopK: subclass
        k = max(1, math.ceil(comp.frac * d))
        return k + _idx_bits(d, k) + _F       # k signs + k indices + scale
    if isinstance(comp, SignTopK):
        k = min(comp.k, d)
        return k + _idx_bits(d, k) + _F
    if isinstance(comp, QsTopK):
        k = min(comp.k, d)
        return _idx_bits(d, k) + _F + k * (1 + math.ceil(math.log2(comp.s + 1)))
    if isinstance(comp, TopK):
        k = min(comp.k, d)
        return k * _F + _idx_bits(d, k)       # k values + k indices
    if isinstance(comp, RandK):
        return _F * min(comp.k, d) + _F       # k values + shared 32b seed
    if isinstance(comp, Sign):
        return d + _F                         # d sign bits + scale
    if isinstance(comp, QSGD):
        return _F + d * (1 + math.ceil(math.log2(comp.s + 1)))
    if isinstance(comp, Identity):
        return _F * d
    return None


# ----------------------------------------------------------- trajectory oracle

def _round_degrees(plan: GossipPlan, faults: Optional[FaultPlan], H: int,
                   rounds: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(deg, live)``, each ``(rounds, n)``: what the engines charge at each
    sync round, the active round's degrees, repaired through the ``(seed,
    t, r)`` masks when a fault plan is live. The reference vmaps
    ``FaultPlan.apply`` over the rounds; here it is a loop of the port's
    ``apply``, which builds each round's masks on the host."""
    ridx = np.arange(int(rounds))
    if faults is None:
        deg = np.asarray(plan.degrees, np.float64)[ridx % plan.R]
        return deg, np.ones((len(ridx), plan.n), bool)
    deg = np.zeros((len(ridx), plan.n), np.float64)
    live = np.zeros((len(ridx), plan.n), bool)
    for r in ridx:
        _w, deg_r, live_r = faults.apply(
            torch.from_numpy(plan.ws[r % plan.R]), (r + 1) * int(H) - 1, r)
        deg[r], live[r] = deg_r.numpy(), live_r.numpy()
    return deg, live


def expected_trace(plan: GossipPlan, faults: Optional[FaultPlan], H: int,
                   payload_bits: float, T: int) -> Dict[str, float]:
    """Expected ``(bits, sync_rounds, triggers)`` of a T-step trajectory
    that always triggers (zero threshold, nonzero residuals): every live
    node triggers at every sync round and is charged ``deg * (FLAG + trig *
    payload)``, the ``sync_message_bits`` formula offline."""
    rounds = T // int(H)
    deg, live = _round_degrees(plan, faults, int(H), rounds)
    total = float(np.sum(deg * (bits_mod.FLAG_BITS
                                + live.astype(np.float64) * payload_bits)))
    return {"bits": total, "sync_rounds": rounds,
            "triggers": int(live.sum())}


def bits_interval(plan: GossipPlan, faults: Optional[FaultPlan], H: int,
                  payload_bits: float, sync_rounds: int, trigger_events: int
                  ) -> Tuple[float, float]:
    """``[lo, hi]`` of the bits a trace with the realized ``(sync_rounds,
    trigger_events)`` must have charged: the flags exactly (every node pays
    FLAG per live link every sync round), the payloads bounded by spreading
    the trigger events over the smallest and largest live per-node degree
    of the rounds run. A static fault-free uniform-degree plan gives a
    point."""
    deg, live = _round_degrees(plan, faults, int(H), int(sync_rounds))
    flag_total = bits_mod.FLAG_BITS * float(deg.sum())
    deg_min = float(deg[live].min()) if live.any() else 0.0
    deg_max = float(deg[live].max()) if live.any() else 0.0
    k = float(trigger_events) * float(payload_bits)
    return flag_total + k * deg_min, flag_total + k * deg_max


# ------------------------------------------------------------------------- R10

def registry_probes() -> List[Compressor]:
    """One operator of each registry entry, as the reference probes them
    (``comm_lint.py:176-180``)."""
    return [Identity(), TopK(k=10), RandK(k=10), Sign(), QSGD(s=16),
            SignTopK(k=10), QsTopK(k=10, s=16), TopFrac(frac=0.25),
            BlockTopFrac(frac=0.1)]


def lint_bits_oracle(*, program: str, n: int = 8, d: int = 256, T: int = 12,
                     device: Union[str, torch.device, None] = "cuda"
                     ) -> Tuple[List[Finding], Dict[str, Any]]:
    """R10: a short trace of the reference engine on ``device``, on a clean
    and a faulty fixture, must charge exactly the closed-form bits (the
    trace is short enough for the Kahan-compensated float32 total to be
    exact); and every registry compressor's ``bits(d)`` must equal its
    derived payload."""
    from repro_torch.core.compression import _REGISTRY
    from repro_torch.core.faults import DropoutWindow
    from repro_torch.core.prng import PRNGKey
    from repro_torch.core.schedule import fixed
    from repro_torch.core.sparq import SparqConfig, run_scan
    from repro_torch.core.topology import make_topology
    from repro_torch.core.triggers import zero
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out: List[Finding] = []
    meta: Dict[str, Any] = {"fixtures": {}, "payload_checks": 0}

    probes = registry_probes()
    assert len(probes) == len(_REGISTRY)
    for comp in probes:
        for dd in (64, 1024, 65536):
            want = derive_payload_bits(comp, dd)
            got = float(comp.bits(dd))
            meta["payload_checks"] += 1
            if want is None or abs(got - want) > 0.5:
                out.append(finding(
                    "R10", f"payload drift for {comp.name!r} at d={dd}: "
                           f"runtime bits(d) = {got:.1f}, derived formula = "
                           f"{want}", program))

    # short traces that always trigger: distinct per-node x0 and a constant
    # gradient keep every residual nonzero
    ring = make_topology("ring", n)
    comp = SignTopK(k=10)
    fixtures = {
        "clean": None,
        "faulty": FaultPlan(link_drop=0.3, stragglers=(1,),
                            straggler_frac=0.5,
                            dropout=(DropoutWindow(2, 4, 8),), seed=0),
    }
    x0 = torch.from_numpy(
        np.arange(n * d, dtype=np.float32).reshape(n, d) / (n * d) + 0.1
    ).to(dev)
    for name, faults in fixtures.items():
        cfg = SparqConfig(topology=ring, compressor=comp, threshold=zero(),
                          lr=fixed(0.05), H=2, gamma=0.2, faults=faults)
        st = run_scan(cfg, lambda x, t, key: torch.ones_like(x), x0, T,
                      PRNGKey(0))
        want = expected_trace(cfg.resolved_plan(),
                              faults if faults and not faults.is_null else None,
                              cfg.H, float(comp.bits(d)), T)
        got = {"bits": float(st.bits), "sync_rounds": int(st.sync_rounds),
               "triggers": int(st.triggers)}
        meta["fixtures"][name] = {"oracle": want, "trace": got}
        for key in ("sync_rounds", "triggers"):
            if got[key] != want[key]:
                out.append(finding(
                    "R10", f"{name} fixture: traced {key} = {got[key]} != "
                           f"oracle {want[key]}", program))
        if abs(got["bits"] - want["bits"]) > 1e-6 * max(want["bits"], 1.0):
            out.append(finding(
                "R10", f"{name} fixture: traced bits = {got['bits']:.1f} != "
                       f"closed-form oracle {want['bits']:.1f} (plan degrees "
                       f"x (flag + trig * payload) over {want['sync_rounds']} "
                       f"rounds)", program))
    return out, meta


def _leaf_sizes(tree: Any) -> List[int]:
    """Element counts of a tree's leaves: shape tuples (``param_shapes``)
    or tensors."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaf_sizes(tree[k])]
    if hasattr(tree, "shape"):
        return [math.prod(tree.shape) or 1]
    if isinstance(tree, (tuple, list)) and all(isinstance(v, int)
                                               for v in tree):
        return [math.prod(tree) or 1]
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in _leaf_sizes(v)]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def lint_dist_payload(comp: Compressor, pshape: Any, payload_bits: float,
                      *, program: str) -> List[Finding]:
    """R10, the flat-buffer engine's leg: the payload it charges per
    triggered node per sync must equal the closed form over the flat model
    dimension ``d = sum(leaf sizes)`` (the engine compresses the raveled
    buffer as one vector: one global top-k, or one kernel launch), not the
    per-leaf sum."""
    d = sum(_leaf_sizes(pshape))
    want = derive_payload_bits(comp, d)
    if want is None:
        return []   # a custom operator: nothing to derive it from
    out: List[Finding] = []
    if abs(payload_bits - want) > 0.5:
        out.append(finding(
            "R10", f"dist payload drift: engine charges {payload_bits:.1f} "
                   f"bits/node/sync, flat-buffer derivation at d={d} gives "
                   f"{want:.1f}", program))
    return out
