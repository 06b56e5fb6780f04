"""Declarative communication contracts over what a program did (port of
``repro/analysis/contracts.py``).

A :class:`CommContract` states, for ONE program of the port, what it may
do on the wire and in memory on one rank; pass its recorded
:class:`~repro_torch.analysis.trace.Trace` to :func:`audit_trace` and get
back an :class:`AuditReport` with every violation. The reference's audits,
as it writes them, over the recorder's records instead of HLO text:

1. **Collective whitelist**: every collective must match exactly one
   :class:`CollectiveRule` by (kind, spanned mesh axes); the group's
   global ranks are classified onto the row-major process mesh
   (``trace.group_axes``), so a gradient gather over the ``data`` axis
   and a table exchange over the ``model`` axis are told apart. Anything
   unmatched is a stray: the "no cross-partition traffic" claim, checked
   on what ran. A collective on a group of one rank moves no bytes and is
   ignored; one whose group was not found is a violation, never a skip,
   and ``min_recorded`` keeps a recorder that saw nothing from passing.
2. **Count bounds**: each rule's matches must fall in ``[min_count,
   max_count]``.
3. **Byte budget**: a rule with ``expected_bytes`` compares the summed
   wire bytes of its matches with the closed form, within ``tol``.
4. **Replication audit**: no op output (views included) may have a shape
   ending with a forbidden suffix (the full table's ``(V, d)``), contain
   a forbidden dimension, or, for float32, end with a forbidden f32
   suffix (the int8 table's fp32 image): the static form of "table memory
   ∝ 1/S", here of what was allocated.
5. **In-place audit** (the counterpart of the reference's donation audit,
   which has no eager meaning): each tensor ``min_in_place`` names (the
   rank's parameters, the table's row block among them, and its Adam
   moments) must keep its storage (``untyped_storage().data_ptr()``)
   across the program, so no second copy of the table block outlives the
   step. The contract has no ``min_donated``: nothing in the port is
   donated, and a count of it would be made up.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.trace import Collective, Trace, group_axes


@dataclasses.dataclass(frozen=True)
class CollectiveRule:
    """One whitelisted collective family: ``kind`` spanning exactly the
    mesh ``axes``, with count bounds and an optional closed-form wire
    byte budget (summed over every match)."""

    kind: str                      # e.g. "reduce-scatter"
    axes: Tuple[str, ...]          # spanned mesh axes, e.g. ("model",)
    min_count: int = 1
    max_count: int = 1
    expected_bytes: Optional[float] = None
    tol: float = 0.02              # relative tolerance on expected_bytes
    note: str = ""

    @property
    def label(self) -> str:
        return f"{self.kind}@{'+'.join(self.axes) or 'none'}"


@dataclasses.dataclass(frozen=True)
class CommContract:
    """The full communication and memory contract of one program on one
    rank."""

    name: str
    mesh_axes: Tuple[Tuple[str, int], ...]   # row-major (name, size)
    rules: Tuple[CollectiveRule, ...] = ()
    # replication audit: shape SUFFIXES that must never be an op's output
    # (e.g. ((V, d), (S*rows, d))) and single dims that must not appear
    forbidden_suffixes: Tuple[Tuple[int, ...], ...] = ()
    forbidden_dims: Tuple[int, ...] = ()
    # suffixes forbidden ONLY for float32 outputs: the int8 table's
    # contract, where the same-shaped int8 code stack should exist
    forbidden_f32_suffixes: Tuple[Tuple[int, ...], ...] = ()
    # in-place audit: the tensors (trace.in_place names) whose storage the
    # program must keep
    min_in_place: Tuple[str, ...] = ()
    # at least this many collectives recorded, those on one-rank groups
    # included: on a one-rank mesh every collective is degenerate, and
    # this keeps a recorder that sees nothing from passing
    min_recorded: int = 0
    # rules this mesh cannot hold, by name (on a one-rank mesh the rank's
    # block is the whole table): reported, never passed silently
    refused: Tuple[str, ...] = ()
    notes: str = ""


@dataclasses.dataclass
class RuleResult:
    """One rule's observed matches."""

    rule: CollectiveRule
    count: float = 0.0
    wire_bytes: float = 0.0

    def as_row(self) -> Dict[str, object]:
        return {
            "rule": self.rule.label,
            "count": self.count,
            "wire_bytes": self.wire_bytes,
            "expected_bytes": self.rule.expected_bytes,
        }


@dataclasses.dataclass
class AuditReport:
    """Everything :func:`audit_trace` measured, plus the violations."""

    program: str
    contract: CommContract
    violations: List[str] = dataclasses.field(default_factory=list)
    rule_results: List[RuleResult] = dataclasses.field(default_factory=list)
    stray: List[Collective] = dataclasses.field(default_factory=list)
    n_in_place: int = 0
    # every collective recorded, one-rank groups included: (kind, ranks)
    # -> [count, wire bytes]
    recorded: Dict[Tuple[str, Tuple[int, ...]], List[float]] = \
        dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_row(self) -> Dict[str, object]:
        """JSON-friendly summary (one ``comm_audit`` benchmark row): the
        reference's keys, with ``in_place`` / ``min_in_place`` where it
        has ``aliased`` / ``donor`` / ``min_donated``, the rules this mesh
        refused and every collective recorded."""
        return {
            "program": self.program,
            "ok": self.ok,
            "violations": list(self.violations),
            "rules": [r.as_row() for r in self.rule_results],
            "wire_bytes": sum(r.wire_bytes for r in self.rule_results),
            "expected_bytes": sum(
                r.rule.expected_bytes or 0.0 for r in self.rule_results),
            "in_place": self.n_in_place,
            "min_in_place": len(self.contract.min_in_place),
            "refused": list(self.contract.refused),
            "recorded": [{"kind": kind, "ranks": list(ranks or ()),
                          "count": n, "wire_bytes": b}
                         for (kind, ranks), (n, b) in self.recorded.items()],
        }


def _audit_collectives(trace: Trace, contract: CommContract,
                       report: AuditReport) -> None:
    results = [RuleResult(rule) for rule in contract.rules]
    for c in trace.collectives:
        seen = report.recorded.setdefault((c.kind, c.ranks), [0, 0.0])
        seen[0] += 1
        seen[1] += c.wire_bytes
        if c.ranks is None:
            report.stray.append(c)
            report.violations.append(
                f"collective with no process group found: {c.kind} — "
                f"{c.line[:120]}")
            continue
        if len(c.ranks) <= 1:
            # a group of one rank: a degenerate collective moving no
            # bytes (e.g. an exchange on a 1-wide axis) — not traffic
            continue
        axes = group_axes(c.ranks, contract.mesh_axes)
        for res in results:
            if res.rule.kind == c.kind and set(res.rule.axes) == axes:
                res.count += 1
                res.wire_bytes += c.wire_bytes
                break
        else:
            report.stray.append(c)
            report.violations.append(
                f"stray collective: {c.kind} over axes "
                f"{sorted(axes)} — {c.line[:120]}")
    for res in results:
        rule = res.rule
        if not rule.min_count <= res.count <= rule.max_count:
            report.violations.append(
                f"{rule.label}: count {res.count:g} outside "
                f"[{rule.min_count}, {rule.max_count}]"
                + (f" ({rule.note})" if rule.note else ""))
        if rule.expected_bytes is not None and res.count:
            err = abs(res.wire_bytes - rule.expected_bytes)
            if err > rule.tol * rule.expected_bytes:
                report.violations.append(
                    f"{rule.label}: wire bytes {res.wire_bytes:.0f} vs "
                    f"closed-form {rule.expected_bytes:.0f} "
                    f"(tol {rule.tol:.0%})"
                    + (f" ({rule.note})" if rule.note else ""))
    report.rule_results = results
    if len(trace.collectives) < contract.min_recorded:
        report.violations.append(
            f"{len(trace.collectives)} collectives recorded, fewer than "
            f"{contract.min_recorded}: the recorder saw nothing")


def _audit_replication(trace: Trace, contract: CommContract,
                       report: AuditReport) -> None:
    if not (contract.forbidden_suffixes or contract.forbidden_dims
            or contract.forbidden_f32_suffixes):
        return

    def suffix_match(dims, suffixes):
        return any(len(dims) >= len(suf) and dims[-len(suf):] == suf
                   for suf in suffixes)

    flagged = 0
    for (op, dtype, dims), count in trace.outputs.items():
        bad = (suffix_match(dims, contract.forbidden_suffixes)
               or any(d in contract.forbidden_dims for d in dims)
               or (dtype == torch.float32 and suffix_match(
                   dims, contract.forbidden_f32_suffixes)))
        if bad:
            flagged += 1
            if flagged <= 5:       # cap the noise, keep the count
                report.violations.append(
                    f"replicated buffer {dims} {dtype}: {op} x{count}")
    if flagged > 5:
        report.violations.append(
            f"... {flagged - 5} more forbidden-shape outputs")


def _audit_in_place(trace: Trace, contract: CommContract,
                    report: AuditReport) -> None:
    held = 0
    for name in contract.min_in_place:
        ptrs = trace.in_place.get(name)
        if ptrs is None:
            report.violations.append(
                f"in-place audit: {name} was not watched")
        elif ptrs[0] != ptrs[1]:
            report.violations.append(
                f"not updated in place: {name} has new storage after the "
                f"program (a second copy outlived it)")
        else:
            held += 1
    report.n_in_place = held


def audit_trace(trace: Trace, contract: CommContract,
                program: Optional[str] = None) -> AuditReport:
    """Run every audit of ``contract`` against one rank's recorded
    ``trace``."""
    report = AuditReport(program=program or contract.name,
                         contract=contract)
    _audit_collectives(trace, contract, report)
    _audit_replication(trace, contract, report)
    _audit_in_place(trace, contract, report)
    return report


def format_report_table(reports: List[AuditReport]) -> str:
    """Fixed-width per-program contract table (the CLI's output)."""
    headers = ("program", "collectives (count, wire KiB / expected)",
               "in place", "status")
    rows: List[Tuple[str, str, str, str]] = []
    for rep in reports:
        cells = []
        for res in rep.rule_results:
            if not res.count and res.rule.min_count == 0:
                continue
            exp = (f"/{res.rule.expected_bytes / 1024:.1f}"
                   if res.rule.expected_bytes is not None else "")
            cells.append(f"{res.rule.label} x{res.count:g} "
                         f"{res.wire_bytes / 1024:.1f}{exp}")
        in_place = f"{rep.n_in_place}"
        if rep.contract.min_in_place:
            in_place += f" (of {len(rep.contract.min_in_place)})"
        status = "OK" if rep.ok else f"FAIL ({len(rep.violations)})"
        rows.append((rep.program, "; ".join(cells) or "none", in_place,
                     status))
    widths = [max(len(headers[i]), *(len(r[i]) for r in rows)) if rows
              else len(headers[i]) for i in range(4)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(c.ljust(w) for c, w in zip(row, widths))
              for row in rows]
    for rep in reports:
        for v in rep.violations:
            lines.append(f"  !! {rep.program}: {v}")
        for r in rep.contract.refused:
            lines.append(f"  -- {rep.program}: refused on this mesh: {r}")
    return "\n".join(lines)
