"""The comparison that decides ``correct``: the program's readings of its
first steps against the plain reference's, each number against the limit
its workload file sets.

Numbers (per node i and leaf l; a leaf is one tensor of the parameter
tree, a stacked segment's all layers together):

* ``loss_gap``: the largest relative gap of a step's mean loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it, |p - r| / max(r_il, median_l r_il);
* ``grad_err``: the median leaf's distance between the first gradients
  at the leaf's fixed sample coordinates, ||p - r|| / ||r|| (the worst
  node's median);
* ``change_gap``, ``change_err``: the same two for x - x^0 after the
  compared steps (SignTopK's selection at the boundary flips between two
  sound runs, so a leaf's own distance swings; its median does not);
* ``xhat_gap``, ``xhat_err``: the same two for x_hat after them;
* ``mix_gap``: the worst leaf's distance between what the first sync's
  mixing did to x and gamma (W - I) x_hat of its new x_hat, W and gamma
  the plain engine's, beyond one float32 spacing of x a coordinate, over
  max(|want_il|, median_l |want_il|) (a side's own step held to the rule:
  the program's x_hat is compared apart). Nodes start alike, so most of
  the term lies under x's spacing; where a tile's selection splits
  between nodes it does not, and a mixing left out reads about 1;
* ``bits_gap``: the relative gap of the bits sent;
* ``trigger_gap``: the difference of the trigger counts (exact).

The change, x_hat and mixing numbers leave out a leaf whose reference gradient is
under a thousandth of the median leaf's: such a leaf moves by round-off
alone.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Optional, Tuple

NAMES = ("loss_gap", "grad_gap", "grad_err", "change_gap", "change_err",
         "xhat_gap", "xhat_err", "mix_gap", "bits_gap", "trigger_gap")
QUIET = 1e-3          # a leaf's reference gradient under this share of the
                      # median leaf's: moved by round-off alone


def _worst(gaps: List[List[float]], ref: List[List[float]],
           keep: Optional[List[List[bool]]] = None) -> float:
    """The worst node and leaf of ``gaps[i][j] / max(ref[i][j], median_j
    ref[i][j])``."""
    worst = 0.0
    for i, (g_row, r_row) in enumerate(zip(gaps, ref, strict=True)):
        med = statistics.median(r_row)
        for j, (g, r) in enumerate(zip(g_row, r_row, strict=True)):
            if keep is not None and not keep[i][j]:
                continue
            gap = g / max(r, med, 1e-30)
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def _leaf_gap(prog: List[List[float]], ref: List[List[float]],
              keep: Optional[List[List[bool]]] = None) -> float:
    gaps = [[abs(p - r) for p, r in zip(p_row, r_row, strict=True)]
            for p_row, r_row in zip(prog, ref, strict=True)]
    return _worst(gaps, ref, keep)


def _distances(prog: List[List[Any]], ref: List[List[Any]]
               ) -> Tuple[List[List[float]], List[List[float]]]:
    """Per node and leaf: ||p - r|| and ||r|| over the sampled values."""
    dist = [[float((p - r).norm()) for p, r in zip(pn, rn, strict=True)]
            for pn, rn in zip(prog, ref, strict=True)]
    norm = [[float(r.norm()) for r in rn] for rn in ref]
    return dist, norm


def _median_err(prog, ref, keep=None) -> float:
    """The worst node's median over its leaves of ||p - r|| / ||r|| on the
    sampled values."""
    dist, norm = _distances(prog, ref)
    worst = 0.0
    for i, (dn, nn) in enumerate(zip(dist, norm, strict=True)):
        errs = [d / max(n, 1e-30) for j, (d, n) in enumerate(zip(dn, nn))
                if keep is None or keep[i][j]]
        med = statistics.median(errs)
        worst = max(worst, med if math.isfinite(med) else math.inf)
    return worst


def numbers(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The compared numbers of two readings (see the module doc)."""
    g = ref["grad0"]
    keep = [[x >= QUIET * statistics.median(row) for x in row] for row in g]
    loss = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
               for p, r in zip(prog["losses"], ref["losses"], strict=True))
    return {
        "loss_gap": loss,
        "grad_gap": _leaf_gap(prog["grad0"], g),
        "grad_err": _median_err(prog["grad0_s"], ref["grad0_s"]),
        "change_gap": _leaf_gap(prog["change"], ref["change"], keep),
        "change_err": _median_err(prog["change_s"], ref["change_s"], keep),
        "xhat_gap": _leaf_gap(prog["xhat"], ref["xhat"], keep),
        "xhat_err": _median_err(prog["xhat_s"], ref["xhat_s"], keep),
        "mix_gap": _worst(prog["mix"], prog["mix_norm"], keep),
        "bits_gap": abs(prog["bits"] - ref["bits"]) / max(ref["bits"], 1.0),
        "trigger_gap": float(abs(prog["triggers"] - ref["triggers"])),
    }


def per_leaf(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """Each leaf's norm gap and sampled distance, per node, for the
    readings tool: ``{key: {"gap": [[...]], "err": [[...]]}}``."""
    out = {}
    for key in ("grad0", "change", "xhat"):
        dist, norm = _distances(prog[key + "_s"], ref[key + "_s"])
        out[key] = {
            "gap": [[abs(p - r) / max(r, 1e-30) for p, r in zip(pn, rn)]
                    for pn, rn in zip(prog[key], ref[key])],
            "err": [[d / max(n, 1e-30) for d, n in zip(dn, nn)]
                    for dn, nn in zip(dist, norm)]}
    return out


def judge(values: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, Dict[str, Dict[str, Optional[float]]]]:
    """``(correct, checks)``: every number at or under its limit. A number
    whose limit the workload file gives as ``null`` is printed and not
    compared (a cell in which it separates no fault from sound runs); a
    number the file leaves out fails."""
    checks = {k: {"value": values[k], "limit": limits.get(k, math.nan)}
              for k in NAMES}
    ok = all(v["value"] <= v["limit"] for v in checks.values()
             if v["limit"] is not None)
    return ok, checks
