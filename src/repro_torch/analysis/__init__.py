"""The comm audit of the multi-process programs (port of
``repro/analysis``).

``repro_torch.analysis.trace`` records what a program does on this rank
(the counterpart of ``repro.analysis.hlo``: the port runs eagerly and has
no HLO); ``repro_torch.analysis.contracts`` is the declarative
CommContract auditor; ``repro_torch.analysis.programs`` runs every
multi-process program under the recorder and audits it. CLI front-end:
``python -m repro_torch.launch.audit``.
"""
from repro_torch.analysis.contracts import (
    AuditReport, CollectiveRule, CommContract, RuleResult, audit_trace,
    format_report_table,
)
from repro_torch.analysis.trace import (
    COLLECTIVE_KINDS, COLLECTIVE_WIRE_FACTOR, Collective, CommRecorder,
    Trace, group_axes, storage_ptrs,
)

__all__ = [
    "AuditReport", "CollectiveRule", "CommContract", "RuleResult",
    "audit_trace", "format_report_table",
    "COLLECTIVE_KINDS", "COLLECTIVE_WIRE_FACTOR", "Collective",
    "CommRecorder", "Trace", "group_axes", "storage_ptrs",
]
