"""repro_torch.analysis: the audits of the port (counterpart of
``repro.analysis``).

The theory contracts R6-R9 and the bits oracle R10 lint any ``SparqConfig``
or ``DistSparqConfig`` of the port without training it; K1 and K3 certify
the hand-written CUDA kernels of ``kernels/csrc``. The reference's rules
that read XLA programs, jaxprs, JAX source or GSPMD have no object to read
here; :data:`rules.RULES` says why for each. Run it as

    PYTHONPATH=src python -m repro_torch.analysis --contracts --kernels

(``--device cpu`` without a card), or through ``train --lint``.
"""
from repro_torch.analysis.rules import (ERROR, INFO, RULES, WARNING,
                                        Finding, Report, Rule,
                                        apply_suppressions,
                                        default_suppressions, dump_report,
                                        finding, render_report)

__all__ = ["ERROR", "INFO", "WARNING", "RULES", "Rule", "Finding", "Report",
           "finding", "apply_suppressions", "default_suppressions",
           "render_report", "dump_report"]
