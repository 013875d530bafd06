"""Rule catalog of the port's audits (counterpart of
``repro/analysis/rules.py``).

The catalog keeps every id of the reference's catalog with its severity, so
a finding diffs against the reference's by ``(rule_id, severity)``. Each
rule says how it stands in the port (``Rule.port``):

* **ported** — R6-R10 lint the algorithm's configuration, which the port
  shares with the reference (:mod:`repro_torch.analysis.contracts`,
  :mod:`repro_torch.analysis.comm_lint`); K1 and K3 certify the
  hand-written CUDA kernels and K4 tags the flat engine's dense mixing
  work (:mod:`repro_torch.analysis.kernel_lint`).
* **not applicable** — the rest read what only JAX makes: compiled XLA
  programs and their aliasing, jaxprs, traces, Pallas lowering flags, JAX
  source and GSPMD's partitioning. The port runs eager PyTorch and
  launches its kernels through ``ctypes``; none of those objects exists.

Suppressions are explicit: a ``{rule_id: reason}`` mapping (or
``{rule_id: {"match": substring, "reason": ...}}``) marks matching findings
``suppressed``; they stay in the report and stop failing it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Mapping, Optional, Union

ERROR = "error"
WARNING = "warning"
INFO = "info"

PORTED = "ported"
_XLA = "not applicable: reads the compiled XLA module, which the port has not"
_JAXPR = "not applicable: reads jaxprs and JAX's trace cache"
_SOURCE = "not applicable: lints JAX source (traced code, jit arguments)"
_GSPMD = "not applicable: reads GSPMD's partitioned HLO"


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    title: str
    severity: str
    contract: str
    port: str = PORTED     # ported, or why it does not apply


RULES: Dict[str, Rule] = {r.rule_id: r for r in (
    Rule("R1", "donation-audit", ERROR,
         "every donated parameter is output-aliased in the compiled module",
         _XLA + " (torch updates the train state in place)"),
    Rule("R2", "dtype-lint", ERROR,
         "no f64 ops outside core/bits.py, no carry dtype drift, no "
         "weak-typed scalar leaks in the traced signature", _JAXPR),
    Rule("R3", "retrace-gate", ERROR,
         "exactly one trace per (config, shape)",
         _JAXPR + " (eager PyTorch does not trace)"),
    Rule("R4", "hidden-transfer-lint", ERROR,
         "no host callbacks or device->host copies inside a scanned while "
         "body", _XLA + " (the port's engines are host loops by design)"),
    Rule("R5", "interpret-leak", ERROR,
         "use_kernel=True lowers compiled, not interpret-mode Pallas",
         "not applicable: CUDA tensors always launch the compiled kernel "
         "and there is no interpret mode (repro_torch.kernels)"),
    Rule("R6", "mixing-matrix-contract", ERROR,
         "every gossip round is symmetric, doubly stochastic and "
         "non-negative, delta_eff > 0, and fault-repaired supports stay "
         "doubly stochastic for sampled (seed, round) draws"),
    Rule("R7", "omega-certificate", ERROR,
         "each compressor's contraction certificate omega(d) in (0, 1] is "
         "not refuted empirically, and the resolved gamma is checked "
         "against the Lemma-6 bound gamma*(delta, beta, omega) at the true "
         "model d (above-bound gamma is a warning)"),
    Rule("R8", "trigger-schedule-contract", ERROR,
         "the trigger threshold satisfies c_t = o(t) (Theorem 1), H >= 1; "
         "a zero threshold is noted as the CHOCO-SGD reduction"),
    Rule("R9", "config-combination", WARNING,
         "cross-field combinations that are individually valid but jointly "
         "lossy are acknowledged (kernel + faults dense mix, stochastic "
         "compressor without an explicit seed, ...)"),
    Rule("R10", "bits-oracle", ERROR,
         "closed-form expected bits (degrees x (flag + trigger * payload), "
         "fault deg_eff) match the engines' accounting on a short trace, "
         "and registry bits(d) formulas re-derive"),
    Rule("R11", "uncharged-collective", ERROR,
         "every node-axis communication op in the dist lowering is charged "
         "by the gossip bits model",
         _XLA + " (the port's exchanges are explicit NodeComm calls)"),
    Rule("K1", "grid-coverage", ERROR,
         "every __global__ kernel and extern \"C\" launch entry of "
         "kernels/csrc is registered to a probe with a _launch_config; on "
         "the card every tile of every probe shape is written, the guard "
         "tile past the view is left alone, and the output equals the "
         "plain version"),
    Rule("K2", "lowering-flag-hygiene", ERROR,
         "interpret=/lowering= thread from config, never a literal",
         "not applicable: the port has no interpret or lowering flag; the "
         "tensor's device picks the kernel (repro_torch.kernels)"),
    Rule("K3", "on-chip-budget", ERROR,
         "a kernel's static shared memory (closed form from its source) "
         "fits the 48 KiB static limit and its registers fit "
         "__launch_bounds__; on the card cudaFuncGetAttributes agrees, the "
         "occupancy reaches the source's kMinBlocks, and a spill to local "
         "memory is a warning"),
    Rule("K4", "dense-gossip-materialization", WARNING,
         "dense (n, n) mixing-matrix materializations reachable from the "
         "dist step are tagged with the O(n^2) scale ceiling"),
    Rule("P1", "sharding-spec-drift", ERROR,
         "every entry parameter's HLO sharding matches the declared spec",
         _GSPMD + " (the port places its rows and blocks itself)"),
    Rule("P2", "unexplained-reshard", ERROR,
         "every non-gossip-axis collective is explained by the layout",
         _GSPMD),
    Rule("P3", "hbm-watermark", ERROR,
         "the compiled module's peak-HBM watermark stays under budget",
         _XLA + " (memory_analysis(); the port reads "
                "torch.cuda.max_memory_allocated on the run itself)"),
    Rule("P4", "serve-partition-audit", ERROR,
         "serve prefill/decode pass P1-P3 plus the serve layout contract",
         _GSPMD),
    Rule("S1", "prng-key-lineage", ERROR,
         "key linearity of jax.random draws at the source level", _SOURCE),
    Rule("S2", "host-trace-boundary", ERROR,
         "traced-reachable code makes no host round trips", _SOURCE),
    Rule("S3", "static-arg-hygiene", ERROR,
         "static jit args are hashable, no mutable defaults", _SOURCE),
    Rule("S4", "donation-source", ERROR,
         "donate_argnums indices exist and are read", _SOURCE),
    Rule("S5", "docs-cli-drift", ERROR,
         "launch/* flags documented in README; the README rule table "
         "bijects with the catalog",
         "not applicable: the reference's audit reads README's rule table "
         "and the reference's launch flags"),
    Rule("S6", "dead-seam", WARNING,
         "every registry entry is reachable in the JAX call graph",
         _SOURCE),
)}


@dataclasses.dataclass
class Finding:
    rule_id: str
    severity: str
    message: str
    location: str = ""
    suppressed: bool = False
    suppression_reason: str = ""

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def finding(rule_id: str, message: str, location: str = "",
            severity: Optional[str] = None) -> Finding:
    """A finding for a ported rule (severity defaults to the rule's)."""
    rule = RULES[rule_id]
    if rule.port != PORTED:
        raise ValueError(f"rule {rule_id} is not ported: {rule.port}")
    return Finding(rule_id=rule_id, severity=severity or rule.severity,
                   message=message, location=location)


Suppression = Union[str, Mapping[str, str]]


def apply_suppressions(findings: Iterable[Finding],
                       suppressions: Mapping[str, Suppression]
                       ) -> List[Finding]:
    """Mark findings matching a suppression entry; returns the same
    findings. ``suppressions`` maps rule_id to a reason (every finding of
    the rule) or to ``{"match": substring, "reason": ...}`` (findings whose
    message or location holds the substring)."""
    out = []
    for f in findings:
        sup = suppressions.get(f.rule_id)
        if sup is not None:
            if isinstance(sup, str):
                f.suppressed, f.suppression_reason = True, sup
            else:
                needle = sup.get("match", "")
                if needle in f.message or needle in f.location:
                    f.suppressed = True
                    f.suppression_reason = sup.get(
                        "reason", f"matched {needle!r}")
        out.append(f)
    return out


@dataclasses.dataclass
class Report:
    """One audited program's findings plus identifying metadata."""

    program: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def extend(self, more: Iterable[Finding]) -> "Report":
        self.findings.extend(more)
        return self

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == ERROR and not f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.errors

    def counts(self) -> Dict[str, int]:
        c = {"errors": 0, "warnings": 0, "info": 0, "suppressed": 0}
        for f in self.findings:
            if f.suppressed:
                c["suppressed"] += 1
            elif f.severity == ERROR:
                c["errors"] += 1
            elif f.severity == WARNING:
                c["warnings"] += 1
            else:
                c["info"] += 1
        return c

    def to_dict(self) -> Dict[str, object]:
        return {"program": self.program, "meta": self.meta,
                "counts": self.counts(),
                "findings": [f.to_dict() for f in self.findings]}


def render_report(reports: Iterable[Report],
                  suppressions: Mapping[str, Suppression],
                  extra: Optional[Dict[str, object]] = None
                  ) -> Dict[str, object]:
    """The report document: the rule catalog with each rule's standing in
    the port, and the per-program findings."""
    reports = list(reports)
    totals = {"errors": 0, "warnings": 0, "info": 0, "suppressed": 0}
    for r in reports:
        for k, v in r.counts().items():
            totals[k] += v
    doc: Dict[str, object] = {
        "schema_version": 4,
        "rules": {rid: {"title": r.title, "severity": r.severity,
                        "contract": r.contract, "port": r.port}
                  for rid, r in RULES.items()},
        "suppressions": {k: (v if isinstance(v, str) else dict(v))
                         for k, v in suppressions.items()},
        "summary": totals,
        "ok": totals["errors"] == 0,
        "programs": [r.to_dict() for r in reports],
    }
    if extra:
        doc.update(extra)
    return doc


def default_suppressions() -> Dict[str, Suppression]:
    """The sanctioned suppressions: none (``rules.py:368``)."""
    return {}


def dump_report(doc: Dict[str, object], path: str) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
