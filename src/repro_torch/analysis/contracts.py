"""Theory-contract lint (R6-R9) of the port's configurations (counterpart of
``repro/analysis/contracts.py``).

SPARQ-SGD's guarantees (Theorems 1-2) hold only under explicit assumptions:
symmetric doubly stochastic connected mixing, an omega-contraction
compressor, gamma <= gamma*(delta, omega) (Lemma 6), and a c_t = o(t)
trigger schedule. This pass lints a ``SparqConfig`` of the reference engine
(:mod:`repro_torch.core.sparq`) or a ``DistSparqConfig`` of the flat-buffer
engine (:mod:`repro_torch.dist.sparq_dist`) against them without training,
and finds what the reference finds on the same configuration.

One severity split: a gamma above the Lemma-6 bound is a warning (it voids
the stated rate, not the run), while a refuted omega certificate or a mixing
round that is not doubly stochastic is an error (the algorithm run is then
not the one analyzed).

``device`` is where the omega certificate draws (:func:`omega_certificate`);
it defaults to ``cuda``, as every entry point of the port does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.rules import (ERROR, INFO, WARNING, Finding, Report,
                                        apply_suppressions,
                                        default_suppressions, finding)
from repro_torch.core.compression import (Compressor, Identity,
                                          OmegaCertificate, omega_certificate)
from repro_torch.core.faults import FaultPlan, resolve_faults
from repro_torch.core.topology import GossipPlan, Topology
from repro_torch.core.triggers import ThresholdSchedule

Device = Union[str, torch.device, None]

# fault-repaired rounds are float32; the doubly stochastic checks take a
# looser tolerance than the float64 plan constructors get
_FAULT_ATOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Contract:
    """The engine-independent view of one configuration: the quantities the
    theory constrains, built by :func:`resolve_contract`."""

    plan: GossipPlan
    compressor: Compressor
    threshold: ThresholdSchedule
    H: int
    gamma: Optional[float]          # None when gamma resolution failed
    gamma_error: str                # the resolution error message, if any
    faults: Optional[FaultPlan]     # active (non-null) fault plan or None
    d: int                          # true model dimension
    use_kernel: bool = False
    seed: Optional[int] = None      # dist compressor seed; None for core
    variant: str = ""               # dist mixing variant; "" for core


def resolve_contract(cfg: Any, d: int, *, n: Optional[int] = None
                     ) -> Contract:
    """A ``SparqConfig`` or ``DistSparqConfig`` as a :class:`Contract`.
    ``d`` is the true model dimension; ``n``, the resolved ensemble size, is
    needed for a ``DistSparqConfig`` (``train_step.n_nodes``)."""
    from repro_torch.core.sparq import SparqConfig
    from repro_torch.dist.sparq_dist import DistSparqConfig

    if isinstance(cfg, SparqConfig):
        plan = cfg.resolved_plan()
        gamma, err = None, ""
        try:
            gamma = cfg.resolved_gamma(d)
        except ValueError as e:
            err = str(e)
        return Contract(plan=plan, compressor=cfg.compressor,
                        threshold=cfg.threshold, H=int(cfg.H), gamma=gamma,
                        gamma_error=err, faults=resolve_faults(cfg.faults),
                        d=int(d))
    if isinstance(cfg, DistSparqConfig):
        if n is None:
            raise ValueError(
                "resolve_contract(DistSparqConfig) needs n= (the resolved "
                "ensemble size build_sparq exposes as train_step.n_nodes)")
        plan = cfg.resolved_plan(n)
        gamma, err = None, ""
        try:
            gamma = cfg.resolved_gamma(plan, d)
        except ValueError as e:
            err = str(e)
        return Contract(plan=plan, compressor=cfg.resolved_compressor(),
                        threshold=cfg.threshold, H=int(cfg.H), gamma=gamma,
                        gamma_error=err, faults=resolve_faults(cfg.faults),
                        d=int(d), use_kernel=bool(cfg.use_kernel),
                        seed=int(cfg.seed), variant=str(cfg.variant))
    raise TypeError(f"resolve_contract: unsupported config {type(cfg)!r}")


# ------------------------------------------------------------------------- R6

def lint_mixing(con: Contract, *, program: str,
                sample_rounds: int = 4) -> List[Finding]:
    """R6: every plan round symmetric doubly stochastic, delta_eff > 0, and
    the fault-repaired rounds (``FaultPlan.apply`` at sync round r, step
    ``t = (r + 1) H - 1``) still doubly stochastic."""
    out: List[Finding] = []
    plan = con.plan
    for r in range(plan.R):
        try:
            plan.round_topology(r).validate(require_connected=False)
        except ValueError as e:
            out.append(finding("R6", f"round {r}: {e}", program))
    if not plan.delta_eff > 0.0:
        out.append(finding(
            "R6", f"plan {plan.name!r} is disconnected in expectation: "
                  f"delta_eff = {plan.delta_eff:.3e} <= 0 (the round-averaged "
                  f"graph must be connected for consensus to form)", program))
    if con.faults is not None:
        rounds = sorted({0, 1, plan.R, 2 * plan.R + 1})[:sample_rounds]
        for r in rounds:
            t = (r + 1) * con.H - 1
            w_eff, _deg, _live = con.faults.apply(
                torch.from_numpy(plan.ws[r % plan.R]), t, r)
            try:
                Topology(w=w_eff.numpy().astype(np.float64),
                         name=f"{plan.name}+faults[r={r}]").validate(
                    atol=_FAULT_ATOL, require_connected=False)
            except ValueError as e:
                out.append(finding(
                    "R6", f"fault-repaired round r={r} (t={t}, seed="
                          f"{con.faults.seed}): {e}", program))
    return out


# ------------------------------------------------------------------------- R7

def lint_omega_gamma(con: Contract, *, program: str, device: Device = "cuda"
                     ) -> Tuple[List[Finding], Optional[OmegaCertificate]]:
    """R7: the compressor's certificate omega(d) holds up on its draws, and
    the resolved gamma respects the Lemma-6 bound gamma*(delta_eff, beta,
    omega) at the true d (above the bound is a warning)."""
    out: List[Finding] = []
    cert = omega_certificate(con.compressor, con.d, device=device)
    if cert.refuted:
        out.append(finding(
            "R7", f"omega certificate REFUTED for {cert.name!r}: declared "
                  f"omega({cert.d_test}) = "
                  f"{con.compressor.omega(cert.d_test):.4g} but observed "
                  f"E||x-C(x)||^2/||x||^2 = {cert.worst_ratio:.4g} > bound "
                  f"{cert.bound:.4g}: the operator is not the contraction "
                  f"the convergence proof assumes", program))
    if con.gamma is None:
        out.append(finding(
            "R7", f"gamma resolution failed: {con.gamma_error}", program))
        return out, cert
    gamma = con.gamma
    if not 0.0 < gamma <= 1.0:
        out.append(finding(
            "R7", f"gamma = {gamma:.4g} outside (0, 1]: the consensus step "
                  f"x + gamma (W - I) x_hat leaves the convex hull", program))
        return out, cert
    # the 1e-3 omega floor both engines' gamma* resolution applies
    bound = con.plan.gamma_star(max(cert.omega, 1e-3))
    if gamma > bound * (1.0 + 1e-9):
        out.append(finding(
            "R7", f"gamma = {gamma:.4g} exceeds the Lemma-6 bound gamma* = "
                  f"{bound:.4g} at d = {con.d} (omega = {cert.omega:.4g}, "
                  f"{cert.kind}/{cert.qualifier}, delta_eff = "
                  f"{con.plan.delta_eff:.4g}): the stated convergence rate "
                  f"does not apply at this consensus step size",
            program, severity=WARNING))
    return out, cert


# ------------------------------------------------------------------------- R8

# geometric step grid for the o(t) check: c_t/t must keep decaying over the
# last doublings (a 0.5 %-per-doubling floor admits t^(1-eps) for eps >=
# about 0.01 and any bounded schedule, and rejects linear growth)
_T_GRID = [2 ** k for k in range(4, 24)]
_DECAY_FLOOR = 0.995


def lint_schedule(con: Contract, *, program: str) -> List[Finding]:
    """R8: c_t >= 0, c_t = o(t) (Theorem 1 uses c_t <= c0 t^(1-eps)), H >=
    1; a zero threshold is the CHOCO-SGD / Qsparse-local-SGD reduction
    (noted)."""
    out: List[Finding] = []
    if con.H < 1:
        out.append(finding(
            "R8", f"H = {con.H} < 1: the sync gap must be a positive step "
                  f"count", program))
    thr = con.threshold
    c = np.asarray([float(thr(torch.tensor(t, dtype=torch.float32)))
                    for t in _T_GRID], np.float64)
    name = getattr(thr, "name", repr(thr))
    if np.any(c < 0.0):
        out.append(finding(
            "R8", f"threshold {name!r} goes negative (min "
                  f"{c.min():.4g}): c_t must be >= 0", program))
        return out
    if np.all(c == 0.0):
        msg = (f"zero threshold: every sync round triggers; this is the "
               f"CHOCO-SGD reduction" if con.H == 1 else
               f"zero threshold with H = {con.H}: compressed local SGD "
               f"(Qsparse-local-SGD reduction), no event-triggered savings")
        out.append(finding("R8", msg, program, severity=INFO))
        return out
    ratios = c / np.asarray(_T_GRID, np.float64)
    # the decay averaged over the grid's last 3 doublings
    if ratios[-1] > (_DECAY_FLOOR ** 3) * ratios[-4]:
        out.append(finding(
            "R8", f"threshold {name!r} violates c_t = o(t): c_t/t is not "
                  f"decaying at large t (c/t = {ratios[-4]:.4g} at t = "
                  f"{_T_GRID[-4]} vs {ratios[-1]:.4g} at t = {_T_GRID[-1]}); "
                  f"Theorem 1 needs c_t <= c0 t^(1-eps)", program))
    return out


# ------------------------------------------------------------------------- R9

def lint_combination(con: Contract, *, program: str) -> List[Finding]:
    """R9: combinations that are valid field by field but lossy or silent
    together, recorded so they are a decision and not a surprise."""
    out: List[Finding] = []
    if con.faults is not None and con.variant in ("ring", "shift"):
        out.append(finding(
            "R9", f"variant={con.variant!r} with an active fault plan: the "
                  f"repaired per-round W is not circulant, so the row-roll "
                  f"mixing is off and gossip runs the dense product", program))
    if con.use_kernel and con.faults is not None:
        out.append(finding(
            "R9", "use_kernel=True with an active fault plan: the blockwise "
                  "SignTopK CUDA kernel still compresses, but the mixing "
                  "runs the dense product over the repaired W: the row-roll "
                  "mixing's savings do not apply to faulty rounds", program))
    if not con.compressor.deterministic and con.seed == 0:
        out.append(finding(
            "R9", f"stochastic compressor {con.compressor.name!r} with the "
                  f"default seed=0: distinct runs share the compression "
                  f"stream; set an explicit seed per run", program))
    if con.faults is not None and con.faults.straggler_frac >= 1.0:
        out.append(finding(
            "R9", f"straggler_frac = {con.faults.straggler_frac}: nodes "
                  f"{con.faults.stragglers} never take a local step (they "
                  f"only gossip)", program))
    if isinstance(con.compressor, Identity):
        if not any(float(con.threshold(t)) for t in (0, 1)):
            out.append(finding(
                "R9", "identity compressor with a zero threshold: this is "
                      "vanilla decentralized SGD (nothing event-triggered "
                      "or compressed is exercised)", program, severity=INFO))
    return out


# ------------------------------------------------------------------- assembly

def lint_contracts(cfg: Any, d: int, *, n: Optional[int] = None,
                   program: str = "contracts", device: Device = "cuda"
                   ) -> Tuple[List[Finding], dict]:
    """R6-R9 over one config: ``(findings, meta)``, meta holding the
    resolved quantities (gamma, gamma*, the omega certificate, the plan's
    spectral data)."""
    con = resolve_contract(cfg, d, n=n)
    findings = lint_mixing(con, program=program)
    f7, cert = lint_omega_gamma(con, program=program, device=device)
    findings += f7
    findings += lint_schedule(con, program=program)
    findings += lint_combination(con, program=program)
    meta = {
        "plan": con.plan.name, "rounds": con.plan.R, "n": con.plan.n,
        "d": con.d, "H": con.H,
        "delta_eff": float(con.plan.delta_eff),
        "beta_max": float(con.plan.beta_max),
        "gamma": con.gamma,
        "gamma_star": float(con.plan.gamma_star(max(cert.omega, 1e-3))),
        "omega_certificate": cert.to_dict(),
        "threshold": getattr(con.threshold, "name", ""),
        "faults": con.faults is not None,
    }
    return findings, meta


def contract_status(cfg: Any, d: int, *, n: Optional[int] = None,
                    bits: Optional[float] = None,
                    sync_rounds: Optional[int] = None,
                    trigger_events: Optional[int] = None,
                    device: Device = "cuda") -> dict:
    """A row's contract verdict: ``{"contract_status": ..., "bits_oracle":
    {...} | None}``, the status ``"ok"``, ``"warn(R..)"``, ``"error(R..)"``
    or ``"bits-mismatch"``. With the row's ``(bits, sync_rounds,
    trigger_events)`` the closed-form interval of
    :func:`comm_lint.bits_interval` must contain the charged bits."""
    from repro_torch.analysis import comm_lint

    findings, _meta = lint_contracts(cfg, d, n=n, program="bench-row",
                                     device=device)
    oracle = None
    if None not in (bits, sync_rounds, trigger_events):
        con = resolve_contract(cfg, d, n=n)
        if not con.use_kernel:
            lo, hi = comm_lint.bits_interval(
                con.plan, con.faults, con.H, float(con.compressor.bits(d)),
                int(sync_rounds), int(trigger_events))
            oracle = {"lo": lo, "hi": hi, "bits": float(bits)}
            if not lo * (1.0 - 1e-6) <= float(bits) <= hi * (1.0 + 1e-6):
                return {"contract_status": "bits-mismatch",
                        "bits_oracle": oracle}
    errs = sorted({f.rule_id for f in findings if f.severity == ERROR})
    warns = sorted({f.rule_id for f in findings if f.severity == WARNING})
    if errs:
        status = "error(" + ",".join(errs) + ")"
    elif warns:
        status = "warn(" + ",".join(warns) + ")"
    else:
        status = "ok"
    return {"contract_status": status, "bits_oracle": oracle}


def run_contract_lint(cfg: Any, *, d: int, n: Optional[int] = None,
                      program: str = "", device: Device = "cuda") -> dict:
    """The ``--lint`` leg of the train entry: R6-R9 over the config, each
    finding printed as ``[lint Rx/SEVERITY] ...``; returns ``{"errors": n,
    "findings": [...]}``. The reference's R11 leg reads the compiled XLA
    module and has no counterpart here."""
    findings, _meta = lint_contracts(cfg, d, n=n, program=program,
                                     device=device)
    apply_suppressions(findings, default_suppressions())
    errors = [f for f in findings
              if f.severity == ERROR and not f.suppressed]
    for f in findings:
        tag = "suppressed" if f.suppressed else f.severity.upper()
        print(f"  [lint {f.rule_id}/{tag}] {f.message}", flush=True)
    return {"errors": len(errors),
            "findings": [f.to_dict() for f in findings]}


def committed_configs() -> Sequence[Tuple[str, Any, int]]:
    """The representative configurations the reference certifies
    (``contracts.py:356``), built from the port's classes: the experiment
    suites' construction at their quick shapes."""
    from repro_torch.core.compression import Sign, SignTopK, TopFrac
    from repro_torch.core.faults import DropoutWindow
    from repro_torch.core.schedule import decaying
    from repro_torch.core.sparq import SparqConfig, squarm_config
    from repro_torch.core.topology import make_topology
    from repro_torch.core.triggers import piecewise, zero

    n, d = 12, 2048
    ring = make_topology("ring", n)
    c0 = 30.0 * d
    piece = piecewise(c0, c0, every=64, until=512)
    return [
        ("convex/sparq_signtopk",
         SparqConfig(topology=ring, compressor=SignTopK(k=10), threshold=piece,
                     lr=decaying(1.0, 100.0), H=5), d),
        ("convex/choco_sign",
         SparqConfig(topology=ring, compressor=Sign(), threshold=zero(),
                     lr=decaying(1.0, 100.0), H=1), d),
        ("momentum/squarm",
         squarm_config(ring, SignTopK(k=10), decaying(1.0, 100.0), H=5,
                       threshold=piece, beta=0.9), d),
        ("topology/dyn_matchings",
         SparqConfig(plan=GossipPlan.matchings(n, rounds=8, seed=0),
                     compressor=SignTopK(k=10), threshold=piece,
                     lr=decaying(1.0, 100.0), H=5), d),
        ("faults/drop30",
         SparqConfig(topology=ring, compressor=TopFrac(frac=0.25),
                     threshold=piece, lr=decaying(1.0, 100.0), H=5,
                     gamma=0.3,
                     faults=FaultPlan(link_drop=0.3, stragglers=(1,),
                                      straggler_frac=0.5,
                                      dropout=(DropoutWindow(2, 40, 80),))), d),
    ]


def audit_contracts(device: Device = "cuda") -> List[Report]:
    """One report per :func:`committed_configs` entry, named
    ``contracts/<name>``."""
    reports: List[Report] = []
    for name, cfg, d in committed_configs():
        program = f"contracts/{name}"
        report = Report(program=program)
        findings, meta = lint_contracts(cfg, d, program=program,
                                        device=device)
        report.extend(findings)
        report.meta.update(meta)
        reports.append(report)
    return reports
