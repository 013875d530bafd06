"""CLI of the port's audits: ``python -m repro_torch.analysis``.

    PYTHONPATH=src python -m repro_torch.analysis --contracts --kernels \\
        --device cpu

``--contracts`` lints the committed configurations against the theory
contracts (R6-R9, ``contracts.committed_configs``) and runs the bits oracle
(R10) on its two fixtures; ``--kernels`` runs K1 and K3 over
``kernels/csrc`` (the source legs on any device; on ``cuda`` also the card
legs, which build the kernels). With neither flag both run. Findings print
one per line; ``--out`` writes the report as JSON. Exit status 0 iff no
unsuppressed error.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.rules import (Report, apply_suppressions,
                                        default_suppressions, dump_report,
                                        render_report)


def audit_kernels(device) -> Report:
    """K1 and K3 over ``kernels/csrc``; the card legs when ``device`` is a
    CUDA device."""
    from repro_torch.analysis import kernel_lint

    report = Report(program="kernels/csrc")
    f, m = kernel_lint.lint_registry(program=report.program)
    report.extend(f)
    report.meta["registry"] = m
    f, m = kernel_lint.lint_budget(program=report.program)
    report.extend(f)
    report.meta["closed_form"] = m
    if device.type == "cuda":
        from repro_torch import kernels
        kernels.build()
        f, m = kernel_lint.lint_coverage_card(device, program=report.program)
        report.extend(f)
        report.meta["coverage"] = m
        f, m = kernel_lint.lint_budget_card(program=report.program)
        report.extend(f)
        report.meta["attributes"] = m
    else:
        report.meta["card_legs"] = f"not run on {device}"
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--contracts", action="store_true",
                    help="R6-R9 over the committed configurations and the "
                         "R10 bits oracle")
    ap.add_argument("--kernels", action="store_true",
                    help="K1 (grid coverage) and K3 (on-chip budget) over "
                         "kernels/csrc; the card legs on cuda")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--out", default="",
                    help="write the report as JSON here (not under results/ "
                         "and not ANALYSIS.json)")
    args = ap.parse_args(argv)
    if args.out:
        parts = os.path.normpath(args.out).split(os.sep)
        if "results" in parts[:-1] or parts[-1] == "ANALYSIS.json":
            raise SystemExit(f"--out {args.out!r}: results/ and "
                             f"ANALYSIS.json belong to the reference's "
                             f"artifacts")
    both = not (args.contracts or args.kernels)
    dev = resolve_device(args.device)

    reports: List[Report] = []
    if args.kernels or both:
        print("[analysis] auditing the CUDA kernels (K1, K3)", flush=True)
        reports.append(audit_kernels(dev))
    if args.contracts or both:
        from repro_torch.analysis import comm_lint, contracts
        print("[analysis] certifying committed configs (R6-R9) and the "
              "bits oracle (R10)", flush=True)
        reports.extend(contracts.audit_contracts(device=dev))
        oracle = Report(program="comm/bits_oracle")
        f10, m10 = comm_lint.lint_bits_oracle(program=oracle.program,
                                              device=dev)
        oracle.extend(f10)
        oracle.meta.update(m10)
        reports.append(oracle)

    suppressions = default_suppressions()
    for r in reports:
        apply_suppressions(r.findings, suppressions)
    doc = render_report(reports, suppressions,
                        extra={"device": str(dev), "argv": vars(args)})
    for r in reports:
        c = r.counts()
        print(f"[analysis] {r.program}: {c['errors']} error(s), "
              f"{c['warnings']} warning(s), {c['suppressed']} suppressed",
              flush=True)
        for f in r.findings:
            tag = "suppressed" if f.suppressed else f.severity.upper()
            print(f"  [{f.rule_id}/{tag}] {f.message}"
                  + (f"  ({f.location})" if f.location else ""), flush=True)
    if args.out:
        dump_report(doc, args.out)
        print(f"[analysis] wrote {args.out}", flush=True)
    ok = bool(doc["ok"])
    print(f"[analysis] {'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
