"""The port's contract and bits audits (``repro_torch.analysis.contracts``,
``comm_lint``, ``rules``) against the reference's (``repro.analysis``).

Every case of ``tests/test_contracts.py``'s R6-R10 is built in both packages
from the same numbers. What must agree:

* the findings as a multiset of ``(rule_id, severity)``; the messages speak
  of each package's own machinery (the CUDA kernel, the dense mix) and are
  not compared;
* ``meta``: integers and strings exactly, floats within ``META_RTOL =
  1e-9`` relative (both packages take the spectra in float64 numpy), except
  the omega certificate's ``worst_ratio`` and ``bound``, which are float32
  sums in another order: within ``CERT_RTOL = 1e-6``
  (``tests/test_torch_omega.py``);
* ``contract_status``, ``bits_interval`` and the bits oracle's fixtures:
  exactly (float64 sums of the same float32 degrees and payloads).

Draws follow the session's threefry layout in both packages; the R10
fixtures' integers are pinned in the partitionable one. The six experiment
suites' rows run at their quick configurations over ``SUITE_STEPS`` steps
(the engines' runners cut short, one run instead of warm-up and timed): the
columns depend on the configuration and the realized bits, rounds and
triggers, which the reference's ``contract_status`` is handed as they are."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import comm_lint as jcl  # noqa: E402
from repro.analysis import contracts as jcon  # noqa: E402
from repro.analysis import rules as jrules  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import sparq as jsparq  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro_torch.analysis import comm_lint as tcl  # noqa: E402
from repro_torch.analysis import contracts as tcon  # noqa: E402
from repro_torch.analysis import rules as trules  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import sparq as tsparq  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core import triggers as ttrig  # noqa: E402
from repro_torch.launch import (ablation_bits, convex_bits,  # noqa: E402
                                faults_bits, momentum_bits, nonconvex_bits,
                                suite_io, topology_bits)

META_RTOL, CERT_RTOL = 1e-9, 1e-6
SUITE_STEPS = 10


@pytest.fixture(autouse=True)
def same_layout():
    """The port draws in the layout JAX is set to."""
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield


def _pkg(port: bool) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        port=port, topo=ttopo if port else jtopo,
        comp=tcomp if port else jcomp, trig=ttrig if port else jtrig,
        faults=tfaults if port else jfaults, con=tcon if port else jcon,
        cl=tcl if port else jcl, sparq=tsparq if port else jsparq,
        sched=tsched if port else jsched)


PKGS = (_pkg(True), _pkg(False))


def _lying_topk(P):
    class _Lying(P.comp.TopK):
        """Claims near-lossless contraction while keeping k entries."""

        def omega(self, d: int) -> float:
            return 0.9
    return dataclasses.dataclass(frozen=True)(_Lying)(k=1)


def _bad_ring() -> np.ndarray:
    bad = ttopo.make_topology("ring", 8).w.copy()
    bad[0, 0] -= 0.2    # breaks the stochasticity of row 0
    return bad


# (rule leg, the Contract fields that differ from the clean ring's)
CASES = {
    "r6_substochastic": ("mixing", lambda P: dict(
        plan=P.topo.GossipPlan(ws=_bad_ring()[None], name="broken"))),
    "r6_disconnected": ("mixing", lambda P: dict(
        plan=P.topo.GossipPlan(ws=np.eye(8)[None], name="isolated"))),
    "r6_clean": ("mixing", lambda P: {}),
    "r6_faulty_repair": ("mixing", lambda P: dict(
        faults=P.faults.FaultPlan(link_drop=0.4, seed=3))),
    "r6_faulty_plan": ("mixing", lambda P: dict(
        plan=P.topo.GossipPlan.matchings(8, rounds=4, seed=2), H=3,
        faults=P.faults.FaultPlan(link_drop=0.3, stragglers=(1,),
                                  straggler_frac=0.5, seed=5,
                                  dropout=(P.faults.DropoutWindow(2, 0, 9),)
                                  ))),
    "r7_refuted": ("omega", lambda P: dict(compressor=_lying_topk(P))),
    "r7_gamma_above_bound": ("omega", lambda P: dict(gamma=0.9)),
    "r7_gamma_outside": ("omega", lambda P: dict(gamma=1.5)),
    "r7_gamma_failed": ("omega", lambda P: dict(
        gamma=None, gamma_error="no gamma* for omega=0")),
    "r7_clean": ("omega", lambda P: dict(gamma=1e-6)),
    "r7_block_at_main_d": ("omega", lambda P: dict(
        compressor=P.comp.BlockTopFrac(frac=0.1), d=619_570_176,
        gamma=0.3)),
    "r8_linear": ("schedule", lambda P: dict(
        threshold=P.trig.ThresholdSchedule(lambda t: 1.0 * t, "linear"))),
    "r8_negative": ("schedule", lambda P: dict(
        threshold=P.trig.ThresholdSchedule(lambda t: -1.0 + 0.0 * t,
                                           "neg"))),
    "r8_nonpositive_gap": ("schedule", lambda P: dict(H=0)),
    "r8_zero_choco": ("schedule", lambda P: dict(threshold=P.trig.zero(),
                                                 H=1)),
    "r8_zero_qsparse": ("schedule", lambda P: dict(threshold=P.trig.zero(),
                                                   H=4)),
    "r8_piecewise": ("schedule", lambda P: dict(
        threshold=P.trig.piecewise(2.0, 1.0, every=64, until=512))),
    "r8_poly": ("schedule", lambda P: dict(threshold=P.trig.poly(3.0, 0.5))),
    "r9_ring_faults": ("combination", lambda P: dict(
        variant="ring", faults=P.faults.FaultPlan(link_drop=0.2, seed=1))),
    "r9_kernel_faults": ("combination", lambda P: dict(
        use_kernel=True, faults=P.faults.FaultPlan(link_drop=0.2, seed=1))),
    "r9_stochastic_seed0": ("combination", lambda P: dict(
        compressor=P.comp.RandK(k=4), seed=0)),
    "r9_all_stragglers": ("combination", lambda P: dict(
        faults=P.faults.FaultPlan(stragglers=(0,), straggler_frac=1.0,
                                  seed=1))),
    "r9_vanilla": ("combination", lambda P: dict(
        compressor=P.comp.Identity(), threshold=P.trig.zero())),
    "r9_clean": ("combination", lambda P: {}),
}


def contract(P, **kw):
    base = dict(plan=P.topo.GossipPlan.from_topology(
        P.topo.make_topology("ring", 8)), compressor=P.comp.SignTopK(k=4),
        threshold=P.trig.zero(), H=1, gamma=1e-6, gamma_error="",
        faults=None, d=64)
    base.update(kw)
    return P.con.Contract(**base)


def run_leg(P, leg, con):
    if leg == "mixing":
        return P.con.lint_mixing(con, program="t"), None
    if leg == "omega":
        kw = {"device": "cpu"} if P.port else {}
        return P.con.lint_omega_gamma(con, program="t", **kw)
    if leg == "schedule":
        return P.con.lint_schedule(con, program="t"), None
    return P.con.lint_combination(con, program="t"), None


def ids(findings):
    return sorted((f.rule_id, f.severity) for f in findings)


def assert_meta_equal(got, want, path="meta"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            rtol = CERT_RTOL if k in ("worst_ratio", "bound") else META_RTOL
            if isinstance(want[k], float) and not isinstance(want[k], bool):
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           atol=0, err_msg=f"{path}.{k}")
            else:
                assert_meta_equal(got[k], want[k], f"{path}.{k}")
    else:
        assert got == want, path


@pytest.mark.parametrize("case", list(CASES))
def test_rule_cases_equal_reference(case):
    leg, fields = CASES[case]
    (tf, tcert), (jf, jcert) = (run_leg(P, leg, contract(P, **fields(P)))
                                for P in PKGS)
    assert ids(tf) == ids(jf)
    assert all(f.location == "t" for f in tf)
    if leg == "omega":
        assert_meta_equal(tcert.to_dict(), jcert.to_dict())
    if case.endswith("clean") or case in ("r6_faulty_repair",
                                          "r6_faulty_plan", "r8_piecewise",
                                          "r8_poly"):
        assert tf == []


def test_rule_cases_fire():
    """The broken fixtures fire (the equality above would pass if neither
    package found anything)."""
    fired = {case for case in CASES if not case.endswith("clean") and
             run_leg(PKGS[0], CASES[case][0],
                     contract(PKGS[0], **CASES[case][1](PKGS[0])))[0]}
    assert fired == set(CASES) - {"r6_clean", "r7_clean", "r9_clean",
                                  "r6_faulty_repair", "r6_faulty_plan",
                                  "r8_piecewise", "r8_poly"}


def _linear_cfg(P):
    return P.sparq.SparqConfig(
        topology=P.topo.make_topology("ring", 8),
        compressor=P.comp.SignTopK(k=4),
        threshold=P.trig.ThresholdSchedule(lambda t: 2.0 * t, "lin"),
        lr=P.sched.decaying(1.0, 100.0), H=5)


def _lint(P, cfg, d, **kw):
    if P.port:
        kw["device"] = "cpu"
    return P.con.lint_contracts(cfg, d, program="t", **kw)


def test_lint_contracts_meta_equal_reference():
    (tf, tm), (jf, jm) = (_lint(P, _linear_cfg(P), 64) for P in PKGS)
    assert ids(tf) == ids(jf) and ("R8", "error") in ids(tf)
    assert_meta_equal(tm, jm)
    assert tm["d"] == 64 and tm["omega_certificate"] is not None


EXPECTED = {"convex/sparq_signtopk": [], "convex/choco_sign": [("R8", "info")],
            "momentum/squarm": [], "topology/dyn_matchings": [],
            "faults/drop30": [("R7", "warning")]}


def test_committed_configs_equal_reference():
    port, ref = tcon.committed_configs(), jcon.committed_configs()
    assert [n for n, _, _ in port] == [n for n, _, _ in ref] == list(EXPECTED)
    for (name, tcfg, d), (_, jcfg, jd) in zip(port, ref, strict=True):
        assert d == jd
        (tf, tm), (jf, jm) = _lint(PKGS[0], tcfg, d), _lint(PKGS[1], jcfg, d)
        assert ids(tf) == ids(jf) == EXPECTED[name], name
        assert_meta_equal(tm, jm)
    drop = next(cfg for n, cfg, _ in port if n == "faults/drop30")
    _, meta = _lint(PKGS[0], drop, 2048)
    assert meta["gamma_star"] == pytest.approx(0.00127298, rel=1e-5)


def test_audit_contracts_reports():
    reports = tcon.audit_contracts(device="cpu")
    assert [r.program for r in reports] == [f"contracts/{n}"
                                           for n in EXPECTED]
    assert all(r.ok for r in reports)


# ------------------------------------------------------ status and interval

def _fixture_run(P, faults, T=8, d=128):
    cfg = P.sparq.SparqConfig(
        topology=P.topo.make_topology("ring", 8),
        compressor=P.comp.SignTopK(k=6), threshold=P.trig.zero(),
        lr=P.sched.fixed(0.05), H=2, faults=faults)
    x0 = np.arange(8 * d, dtype=np.float32).reshape(8, d) / (8 * d) + 0.1
    if P.port:
        st = tsparq.run_scan(cfg, lambda x, t, k: torch.ones_like(x),
                             torch.from_numpy(x0), T, prng.PRNGKey(0))
    else:
        st = jsparq.run_scan(cfg, lambda x, t, k: jnp.ones_like(x),
                             jnp.asarray(x0), T, jax.random.PRNGKey(0))
    return cfg, d, float(st.bits), int(st.sync_rounds), int(st.triggers)


def _faults(P):
    return P.faults.FaultPlan(link_drop=0.3, stragglers=(1,),
                              straggler_frac=0.5, seed=0,
                              dropout=(P.faults.DropoutWindow(2, 2, 6),))


@pytest.mark.parametrize("row", ["clean", "faulty", "mismatched"])
def test_contract_status_and_interval_equal_reference(row):
    out = []
    for P in PKGS:
        cfg, d, bits, rounds, trig = _fixture_run(
            P, _faults(P) if row == "faulty" else None)
        if row == "mismatched":
            bits *= 3.0
        kw = {"device": "cpu"} if P.port else {}
        status = P.con.contract_status(cfg, d, bits=bits, sync_rounds=rounds,
                                       trigger_events=trig, **kw)
        faults = P.faults.resolve_faults(cfg.faults)
        interval = P.cl.bits_interval(cfg.resolved_plan(), faults, cfg.H,
                                      float(cfg.compressor.bits(d)), rounds,
                                      trig)
        out.append((bits, rounds, trig, status, interval))
    assert out[0] == out[1]
    status, (lo, hi) = out[0][3], out[0][4]
    want = "bits-mismatch" if row == "mismatched" else "ok"
    assert status["contract_status"] == want
    assert (lo == hi) == (row != "faulty")


@pytest.mark.parametrize("faulty", [False, True])
def test_expected_trace_equals_reference(faulty):
    traces = [P.cl.expected_trace(
        P.topo.GossipPlan.matchings(8, rounds=8, seed=1),
        _faults(P) if faulty else None, 2, 123.0, 20) for P in PKGS]
    assert traces[0] == traces[1]


def test_bits_oracle_equals_reference():
    tout, tmeta = tcl.lint_bits_oracle(program="t", device="cpu")
    jout, jmeta = jcl.lint_bits_oracle(program="t")
    assert tout == [] and jout == []
    assert tmeta == jmeta and tmeta["payload_checks"] == 27


@pytest.fixture
def partitionable():
    with prng.threefry_partitionable(True):
        yield


def test_bits_oracle_fixtures_in_the_partitionable_layout(partitionable):
    out, meta = tcl.lint_bits_oracle(program="t", device="cpu")
    assert out == []
    for name, want in (("clean", (11808.0, 6, 48)),
                       ("faulty", (8364.0, 6, 46))):
        fx = meta["fixtures"][name]
        for side in ("trace", "oracle"):
            assert tuple(fx[side][k] for k in ("bits", "sync_rounds",
                                               "triggers")) == want


def _reference_comp(comp):
    return jcomp.make_compressor(comp.name, **{
        f.name: getattr(comp, f.name) for f in dataclasses.fields(comp)
        if f.init and f.name != "name"})


@pytest.mark.parametrize("name", sorted(jcomp._REGISTRY))
def test_payload_derivation_equals_reference(name):
    tp = next(c for c in tcl.registry_probes() if c.name == name)
    jp = _reference_comp(tp)
    for d in (1, 64, 1000, 619_570_176):
        assert tcl.derive_payload_bits(tp, d) == jcl.derive_payload_bits(jp, d)
        assert tcl.derive_payload_bits(tp, d) == pytest.approx(
            tp.bits(d), abs=0.5)


def test_dist_payload_drift_fires():
    pshape = {"w": (32,), "b": (8,)}
    comp = tcomp.SignTopK(k=10)
    want = tcl.derive_payload_bits(comp, 40)
    assert want != sum(tcl.derive_payload_bits(comp, d) for d in (32, 8))
    jshape = {k: jax.ShapeDtypeStruct(v, jnp.float32)
              for k, v in pshape.items()}
    for bits in (want, want + 17.0):
        got = tcl.lint_dist_payload(comp, pshape, bits, program="t")
        ref = jcl.lint_dist_payload(jcomp.SignTopK(k=10), jshape, bits,
                                    program="t")
        assert ids(got) == ids(ref)
    assert ids(got) == [("R10", "error")] and "drift" in got[0].message
    assert tcl.lint_dist_payload(comp, {"w": torch.zeros(40)}, want,
                                 program="t") == []


def test_run_contract_lint_counts_and_prints(capsys):
    cfgs = [_linear_cfg(P) for P in PKGS]
    port = tcon.run_contract_lint(cfgs[0], d=64, program="t", device="cpu")
    ref = jcon.run_contract_lint(cfgs[1], d=64, program="t")
    assert port["errors"] == ref["errors"] == 1
    assert sorted((f["rule_id"], f["severity"]) for f in port["findings"]) \
        == sorted((f["rule_id"], f["severity"]) for f in ref["findings"])
    assert "[lint R8/ERROR]" in capsys.readouterr().out


def test_suppressions_mark_but_keep_findings():
    out = tcl.lint_dist_payload(tcomp.Sign(), {"w": (8,)}, 1.0, program="t")
    blanket = trules.apply_suppressions(out, {"R10": "accepted"})
    assert all(f.suppressed for f in blanket)
    assert trules.Report("p", blanket).ok
    out2 = tcl.lint_dist_payload(tcomp.Sign(), {"w": (8,)}, 1.0, program="t")
    miss = trules.apply_suppressions(out2, {"R10": {"match": "no-such"}})
    assert not any(f.suppressed for f in miss)
    assert not trules.Report("p", miss).ok


def test_catalog_keeps_every_reference_rule():
    assert list(trules.RULES) == list(jrules.RULES)
    for rid, rule in trules.RULES.items():
        assert rule.severity == jrules.RULES[rid].severity, rid
        assert rule.port, rid
    ported = {r for r, rule in trules.RULES.items()
              if rule.port == trules.PORTED}
    assert ported == {"R6", "R7", "R8", "R9", "R10", "K1", "K3", "K4"}
    assert trules.RULES["K4"].port == trules.PORTED
    with pytest.raises(ValueError, match="not ported"):
        trules.finding("R11", "x")
    doc = trules.render_report([trules.Report("p")],
                               trules.default_suppressions())
    assert doc["ok"] and doc["rules"]["R1"]["port"].startswith(
        "not applicable")


# ------------------------------------------------------------- the suites

def _reference_config(cfg):
    """The reference's SparqConfig with the port config's contract fields
    (its threshold evaluates the port's schedule)."""
    thr, faults = cfg.threshold, cfg.faults
    return jsparq.SparqConfig(
        topology=None if cfg.topology is None else jtopo.Topology(
            w=cfg.topology.w, name=cfg.topology.name),
        plan=None if cfg.plan is None else jtopo.GossipPlan(
            ws=cfg.plan.ws, name=cfg.plan.name),
        compressor=_reference_comp(cfg.compressor),
        threshold=jtrig.ThresholdSchedule(
            lambda t: jnp.float32(float(thr(float(t)))), thr.name),
        H=cfg.H, gamma=cfg.gamma,
        faults=None if faults is None else jfaults.FaultPlan(
            link_drop=faults.link_drop, stragglers=faults.stragglers,
            straggler_frac=faults.straggler_frac, seed=faults.seed,
            dropout=tuple(jfaults.DropoutWindow(w.node, w.start, w.end)
                          for w in faults.dropout)))


SUITES = {"convex": convex_bits, "faults": faults_bits,
          "topology": topology_bits, "nonconvex": nonconvex_bits,
          "momentum": momentum_bits, "ablation": ablation_bits}


@pytest.mark.parametrize("suite", list(SUITES))
def test_suite_rows_carry_the_reference_contract_columns(suite, monkeypatch):
    make_runner, columns = teng.make_runner, suite_io.contract_columns
    seen = []

    def short_runner(step_fn, T, *, record_every=0, **kw):
        return make_runner(step_fn, min(T, SUITE_STEPS),
                           record_every=min(record_every, SUITE_STEPS), **kw)

    def one_run(runner, make_state, key, T):
        return (*runner(make_state(), key), 1.0, None)

    def keep(cfg, d, row, rounds):
        out = columns(cfg, d, row, rounds)
        seen.append((cfg, d, dict(row), rounds, out))
        return out
    monkeypatch.setattr(teng, "make_runner", short_runner)
    monkeypatch.setattr(teng, "timed_run", one_run)
    monkeypatch.setattr(suite_io, "contract_columns", keep)
    torch.set_num_threads(1)
    rows = SUITES[suite].run_bench(quick=True, device="cpu")
    assert [r["name"] for r in rows] == [s[2]["name"] for s in seen]
    for row, (cfg, d, raw, rounds, out) in zip(rows, seen, strict=True):
        assert {k: row[k] for k in out} == out
        if cfg is None:
            assert out == {"contract_status": "n/a", "bits_oracle": None}
            continue
        want = jcon.contract_status(
            _reference_config(cfg), d, bits=raw["bits"],
            sync_rounds=int(raw[rounds]),
            trigger_events=int(raw["trigger_events"]))
        assert out == want, row["name"]
        assert out["contract_status"] in ("ok", "warn(R7)")
