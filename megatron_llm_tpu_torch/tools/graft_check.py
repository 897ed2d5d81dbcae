#!/usr/bin/env python
"""graft-check: the port's static-analysis gate (port of
tools/graft_check.py). Three passes over the port's package, one exit
code:

  python -m megatron_llm_tpu_torch.tools.graft_check lint
  python -m megatron_llm_tpu_torch.tools.graft_check audit
  python -m megatron_llm_tpu_torch.tools.graft_check costs
  python -m megatron_llm_tpu_torch.tools.graft_check all --json out.json
  python -m megatron_llm_tpu_torch.tools.graft_check verdict \
      [--bench-artifact run.json --bench-baseline pinned.json]

- `lint` runs the `ast` linter (analysis/lint.py, rules GR001, GR002 and
  GR004-GR007; GR003 has no torch form) over the package and its tools
  and diffs the findings against analysis/lint_baseline.json. New
  findings fail, and so do stale baseline keys (the code they excused is
  gone). `--list-keys` prints each new finding's key for the baseline;
  every entry needs a justification (the loader rejects an empty one).
- `audit` runs every registered contract's reference target once on the
  CPU (analysis/audit.py; gloo ranks for the tp2, dp2 and dp2tp2 rows)
  and checks collectives, host syncs, float64 and variant budgets
  against the declarations, and the markers against the registry.
- `costs` diffs the audit's FLOPs per (contract, mesh tag) against
  analysis/cost_baseline.json: more than 1.25x the baseline fails, and
  so do missing keys (new audited rows) and stale keys (rows gone).
  `--update-costs --justify "..."` rewrites the baseline with the
  current counts, stamping the justification on every entry that moved.
  Under `all` the costs pass reuses the audit's report.
- `verdict` runs the three gates and folds them, with the bench headline
  of the artifact files named by `--bench-artifact` (this run) and
  `--bench-baseline` (the pinned run) when given, in the JAX tool's JSON
  format, into one object: every gate named, every failure a reason,
  `"verdict": "GO" | "NO-GO"`. An artifact without a baseline is
  recorded, not gated; a headline drop past BENCH_HEADLINE_MAX_DROP is
  NO-GO.

Runs on the CPU in well under 90 s. Exit codes: 0 clean, 1 findings or
violations, 2 usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ANALYSIS = os.path.join(_REPO, "megatron_llm_tpu_torch", "analysis")
BASELINE = os.path.join(_ANALYSIS, "lint_baseline.json")
COST_BASELINE = os.path.join(_ANALYSIS, "cost_baseline.json")

# regression tolerances: the counted FLOPs of a reference run are
# deterministic, so the bar is tight (far below the silent 2x the gate
# exists to catch); the port has no CPU temp-bytes figure to diff
COST_FLOPS_MAX_RATIO = 1.25

# verdict's bench-headline gate: the artifact's headline value may drop at
# most this fraction against the pinned baseline artifact
BENCH_HEADLINE_MAX_DROP = 0.05


def run_lint(list_keys: bool = False) -> dict:
    from megatron_llm_tpu_torch.analysis import lint

    findings = lint.lint_paths(lint.default_paths(_REPO), _REPO)
    baseline = lint.load_baseline(BASELINE)
    new, accepted, stale = lint.apply_baseline(findings, baseline)

    for f in new:
        print(f"LINT {f.rule} {f.path}:{f.line}:{f.col} [{f.qualname}] "
              f"{f.message}")
        if list_keys:
            print(f"  key: {f.key}")
    for k in stale:
        print(f"LINT STALE baseline key (code gone — remove the entry): "
              f"{k}")
    ok = not new and not stale
    print(f"lint: {len(findings)} findings, {len(accepted)} baselined, "
          f"{len(new)} new, {len(stale)} stale baseline keys -> "
          f"{'OK' if ok else 'FAIL'}")
    return {
        "ok": ok,
        "total": len(findings),
        "baselined": len(accepted),
        "new": [f.to_dict() for f in new],
        "stale_baseline_keys": stale,
        "baseline": os.path.relpath(BASELINE, _REPO),
    }


def run_audit() -> dict:
    from megatron_llm_tpu_torch.analysis.audit import audit_repo

    report = audit_repo(_REPO)
    for t in report["targets"]:
        status = "ok" if t["ok"] else "FAIL"
        print(f"AUDIT {t['contract']} [{t['mesh']}] {status} "
              f"collectives={t['facts'].get('collectives')} "
              f"flops={t['facts'].get('flops')}")
        for f in t["failures"]:
            print(f"  FAIL: {f}")
    for p in report["marker_problems"]:
        print(f"AUDIT MARKER: {p}")
    print(f"audit: {len(report['targets'])} targets over mesh shapes "
          f"{report['mesh_tags']}, {len(report['entry_points_audited'])} "
          f"entry points, markers "
          f"{'consistent' if not report['marker_problems'] else 'BROKEN'} "
          f"-> {'OK' if report['ok'] else 'FAIL'}")
    return report


def _cost_rows(audit_report: dict) -> dict:
    """One {key: {"flops"}} row per (contract, mesh tag) from the audit's
    targets. Instrumented twin rows (int8, telemetry, cost-registry
    engines) are left out: the parity checks hold them to the plain rows,
    and one row an entry point is what a regression diff needs."""
    rows = {}
    for t in audit_report.get("targets", []):
        facts = t.get("facts", {})
        if any(facts.get(f) for f in ("quantized", "telemetry", "costs")):
            continue
        if "flops" not in facts:
            continue
        key = f"{t['contract']}[{t['mesh']}]"
        if key not in rows:  # the first (plain) row wins
            rows[key] = {"flops": int(facts["flops"])}
    return rows


def load_cost_baseline(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    out = {}
    for e in raw.get("entries", []):
        if not str(e.get("justification", "")).strip():
            raise ValueError(
                f"cost baseline entry {e.get('key')!r} has no "
                f"justification — every pinned cost needs one "
                f"(when/why this number is what it is)")
        out[e["key"]] = e
    return out


def run_costs(audit_report=None, baseline_path: str = COST_BASELINE,
              update: bool = False, justify: str = "") -> dict:
    """Pass 3: diff the audit's per-contract FLOPs against the
    checked-in baseline (module docstring)."""
    if audit_report is None:
        audit_report = run_audit()
    rows = _cost_rows(audit_report)
    if update:
        if not justify.strip():
            print("costs: --update-costs requires --justify TEXT "
                  "(why the pinned numbers moved)")
            return {"ok": False, "error": "missing --justify"}
        old = {}
        if os.path.exists(baseline_path):
            old = load_cost_baseline(baseline_path)
        entries = []
        for key in sorted(rows):
            prev = old.get(key)
            unchanged = (prev is not None
                         and prev.get("flops") == rows[key]["flops"])
            entries.append({
                "key": key, **rows[key],
                "justification": prev["justification"] if unchanged
                else justify.strip(),
            })
        with open(baseline_path, "w", encoding="utf-8") as fh:
            json.dump({
                "_comment": [
                    "graft-check cost baseline of the port: the FLOPs of",
                    "each (contract, mesh tag) reference run of the audit,",
                    "counted by telemetry/costs.py's modes and the kernel",
                    "wrappers. `graft_check costs` fails on flops >",
                    f"{COST_FLOPS_MAX_RATIO}x the baseline, on MISSING",
                    "keys (new audited rows) and on STALE keys (rows",
                    "gone). Update: `python -m",
                    "megatron_llm_tpu_torch.tools.graft_check costs",
                    "--update-costs --justify '<why the numbers moved>'`.",
                ],
                "entries": entries,
            }, fh, indent=1, sort_keys=False)
            fh.write("\n")
        print(f"costs: baseline updated -> {baseline_path} "
              f"({len(entries)} entries)")
        return {"ok": True, "updated": len(entries),
                "baseline": os.path.relpath(baseline_path, _REPO)}

    try:
        baseline = load_cost_baseline(baseline_path)
    except FileNotFoundError:
        print(f"costs: no baseline at {baseline_path} — create it with "
              f"--update-costs --justify '...'")
        return {"ok": False, "error": "missing baseline",
                "rows": rows}
    regressions, improved, missing = [], [], []
    for key in sorted(rows):
        row = rows[key]
        base = baseline.get(key)
        if base is None:
            missing.append(key)
            continue
        for field, ratio in (("flops", COST_FLOPS_MAX_RATIO),):
            now, then = row.get(field), base.get(field)
            if not isinstance(now, int) or not isinstance(then, int) \
                    or then <= 0:
                continue
            if now > then * ratio:
                regressions.append(
                    f"{key}: {field} {then} -> {now} "
                    f"({now / then:.2f}x > the {ratio}x gate) — a "
                    f"compile-cost regression in this entry point; "
                    f"fix it, or re-baseline WITH justification")
            elif now * ratio < then:
                improved.append(
                    f"{key}: {field} {then} -> {now} (improved — "
                    f"refresh the baseline to pin the win)")
    stale = sorted(set(baseline) - set(rows))
    for r in regressions:
        print(f"COSTS REGRESSION {r}")
    for k in missing:
        print(f"COSTS MISSING baseline key {k} (new audited row — add "
              f"it via --update-costs --justify '...')")
    for k in stale:
        print(f"COSTS STALE baseline key {k} (audited row gone — "
              f"refresh the baseline)")
    for n in improved:
        print(f"COSTS NOTE {n}")
    ok = not regressions and not missing and not stale
    print(f"costs: {len(rows)} audited rows vs {len(baseline)} "
          f"baselined, {len(regressions)} regressions, {len(missing)} "
          f"missing, {len(stale)} stale -> {'OK' if ok else 'FAIL'}")
    return {
        "ok": ok,
        "rows": rows,
        "regressions": regressions,
        "missing_keys": missing,
        "stale_keys": stale,
        "improved": improved,
        "flops_max_ratio": COST_FLOPS_MAX_RATIO,
        "baseline": os.path.relpath(baseline_path, _REPO),
    }


def _bench_diff(artifact_path, baseline_path):
    """The bench half of the verdict: echo this run's headline, and
    when a pinned baseline artifact rides along, gate the headline
    value (tok/s/chip) against BENCH_HEADLINE_MAX_DROP. Returns None
    when no artifact was supplied (the gate simply isn't armed —
    compile-cost diffs already cover every jitted entry point)."""
    if not artifact_path:
        return None
    with open(artifact_path, "r", encoding="utf-8") as fh:
        art = json.load(fh)
    out = {
        "headline_value": art.get("value"),
        "unit": art.get("unit"),
        "vs_paper_baseline": art.get("vs_baseline"),
        "artifact": artifact_path,
        "max_drop": BENCH_HEADLINE_MAX_DROP,
    }
    # the self-driving fleet's acceptance headlines ride the artifact
    # under extra.serving.autonomy — when present, the
    # zero-failed-request bar and the bitwise-resubmit pin become
    # their own gate (absent on legacy artifacts -> unarmed)
    auto = ((art.get("extra") or {}).get("serving") or {}).get(
        "autonomy")
    if auto is not None:
        failed = auto.get("failed_requests")
        bitwise = auto.get("bitwise_resubmits_match")
        out["autonomy"] = {
            "failed_requests": failed,
            "bitwise_resubmits_match": bitwise,
            "recovery_s": auto.get("recovery_s"),
            "convergence_tok_s_ratio": auto.get(
                "convergence_tok_s_ratio"),
            "ok": failed == 0 and bool(bitwise),
        }
    if not baseline_path:
        out |= {"ok": None,
                "note": "no --bench-baseline: headline recorded, "
                        "gate not armed"}
        return out
    with open(baseline_path, "r", encoding="utf-8") as fh:
        base = json.load(fh)
    now, then = art.get("value"), base.get("value")
    if not isinstance(now, (int, float)) \
            or not isinstance(then, (int, float)) or then <= 0:
        out |= {"ok": False,
                "note": f"unreadable headline values "
                        f"(now={now!r}, baseline={then!r})"}
        return out
    ratio = now / then
    out |= {
        "baseline_value": then,
        "baseline_artifact": baseline_path,
        "headline_ratio": round(ratio, 4),
        "ok": ratio >= 1.0 - BENCH_HEADLINE_MAX_DROP,
    }
    return out


def build_verdict(report, bench=None) -> dict:
    """Fold the gate sections (and the optional bench diff) into the
    ONE go/no-go object: every gate named with its
    boolean, every failure compressed to a reason string a human (or
    the next automation layer) can act on without re-running the
    passes. Pure function over already-computed reports — tested
    directly, no audit run needed."""
    gates, reasons = {}, []
    lint = report.get("lint")
    if lint is not None:
        gates["lint"] = bool(lint["ok"])
        if lint["new"]:
            reasons.append(f"lint: {len(lint['new'])} new finding(s) "
                           f"vs baseline")
        if lint.get("stale_baseline_keys"):
            reasons.append(f"lint: {len(lint['stale_baseline_keys'])} "
                           f"stale baseline key(s)")
    audit = report.get("audit")
    if audit is not None:
        gates["audit"] = bool(audit["ok"])
        bad = [t for t in audit.get("targets", []) if not t["ok"]]
        if bad:
            reasons.append(
                "audit: contract failure(s) in "
                + ", ".join(f"{t['contract']}[{t['mesh']}]"
                            for t in bad[:5]))
        if audit.get("marker_problems"):
            reasons.append(f"audit: {len(audit['marker_problems'])} "
                           f"marker problem(s)")
    costs = report.get("costs")
    if costs is not None:
        gates["costs"] = bool(costs["ok"])
        for field in ("regressions", "missing_keys", "stale_keys"):
            if costs.get(field):
                reasons.append(
                    f"costs: {len(costs[field])} {field} "
                    f"(first: {costs[field][0]})"[:200])
    if bench is not None:
        # ok=None (artifact without baseline) is informational, not a
        # gate — only an ARMED bench diff can veto
        if bench.get("ok") is not None:
            gates["bench_headline"] = bool(bench["ok"])
            if not bench["ok"]:
                reasons.append(
                    f"bench: headline {bench.get('headline_value')} vs "
                    f"baseline {bench.get('baseline_value')} "
                    f"(ratio {bench.get('headline_ratio')}, floor "
                    f"{1.0 - BENCH_HEADLINE_MAX_DROP})")
        auto = bench.get("autonomy")
        if auto is not None:
            # the chaos-convergence headlines gate on their own: a run
            # that failed requests (or whose resubmits were not
            # bitwise) is a NO-GO regardless of tok/s
            gates["bench_autonomy"] = bool(auto["ok"])
            if not auto["ok"]:
                reasons.append(
                    f"autonomy: {auto.get('failed_requests')} failed "
                    f"request(s), bitwise_resubmits_match="
                    f"{auto.get('bitwise_resubmits_match')} (the "
                    f"zero-failed-request convergence bar)")
    ok = all(gates.values())
    return {
        "verdict": "GO" if ok else "NO-GO",
        "ok": ok,
        "gates": gates,
        "reasons": reasons,
        "bench": bench,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graft_check",
        description="the port's capture-discipline lint and "
                    "compile-contract audit gate")
    ap.add_argument("command",
                    choices=("lint", "audit", "costs", "all", "verdict"))
    ap.add_argument("--json", metavar="PATH",
                    help="write the full machine-readable report here")
    ap.add_argument("--list-keys", action="store_true",
                    help="print baseline keys for new lint findings")
    ap.add_argument("--cost-baseline", metavar="PATH",
                    default=COST_BASELINE,
                    help="cost baseline to diff against "
                         "(default: megatron_llm_tpu_torch/analysis/"
                         "cost_baseline.json)")
    ap.add_argument("--update-costs", action="store_true",
                    help="rewrite the cost baseline with the current "
                         "audit measurements (requires --justify)")
    ap.add_argument("--justify", default="",
                    help="justification stamped on updated cost-"
                         "baseline entries")
    ap.add_argument("--bench-artifact", metavar="PATH", default=None,
                    help="verdict only: this run's bench JSON (the JAX "
                         "tool's format) — headline echoed into the "
                         "verdict")
    ap.add_argument("--bench-baseline", metavar="PATH", default=None,
                    help="verdict only: the pinned prior bench JSON — "
                         "arms the headline-regression gate")
    args = ap.parse_args(argv)

    report = {}
    audit_report = None
    if args.command in ("lint", "all", "verdict"):
        report["lint"] = run_lint(list_keys=args.list_keys)
    if args.command in ("audit", "costs", "all", "verdict"):
        # ONE audit run feeds the audit, the cost diff AND verdict
        audit_report = run_audit()
    if args.command in ("audit", "all", "verdict"):
        report["audit"] = audit_report
    if args.command in ("costs", "all", "verdict"):
        report["costs"] = run_costs(
            audit_report, baseline_path=args.cost_baseline,
            update=args.update_costs, justify=args.justify)

    if args.command == "verdict":
        verdict = build_verdict(
            report, bench=_bench_diff(args.bench_artifact,
                                      args.bench_baseline))
        report["verdict"] = verdict
        ok = verdict["ok"]
        for r in verdict["reasons"]:
            print(f"VERDICT REASON: {r}")
        print(f"verdict: gates "
              + " ".join(f"{k}={'OK' if v else 'FAIL'}"
                         for k, v in verdict["gates"].items())
              + f" -> {verdict['verdict']}")
    else:
        ok = all(section["ok"] for section in report.values())
    report["ok"] = ok
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    print(f"graft-check: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
