"""graft-check pass 1: an `ast` linter of the port's capture and sync
discipline (port of analysis/lint.py). Pure `ast`, no torch import.

The JAX rules guard traced code; their torch forms guard captured code
(a function handed to `inference/graph_capture.CapturedFn`, whose CUDA
graph freezes what the capture saw) and the per-round and per-step hot
paths:

- GR001 captured-host-sync    `.item()`, `.tolist()`, `.cpu()`,
                              `.numpy()`, or `float()` / `int()` /
                              `bool()` of a non-constant inside captured
                              code: on the card a sync inside a capture
                              breaks it (and an uncaptured run stalls).
- GR002 capture-in-loop       `CapturedFn`, `torch.cuda.graph` or
                              `torch.cuda.CUDAGraph` built inside a loop
                              body or a comprehension: a fresh graph and
                              pool per iteration.
- GR003 unhashable-static     no torch form: nothing in torch hashes a
                              function's static arguments into a cache
                              key (the port keys its runners by tuples it
                              builds itself), so the rule has nothing to
                              guard.
- GR004 host-entropy          `time.*`, `random.*` or `np.random.*`
                              inside captured code: evaluated once, at
                              capture, and frozen into the graph.
- GR005 unordered-iteration   iterating a set to build a list or dict
                              (a `for` over it, a list or dict
                              comprehension, `list()`, `tuple()`,
                              `enumerate()` or `dict.fromkeys()` of it)
                              in code whose order every
                              rank must share: `parallel/`,
                              `optimizer/` and the checkpoint's leaf
                              order (`training/checkpointing.py`). Set
                              order is hash-seed dependent.
- GR006 hot-loop-host-sync    GR001's syncs, plus
                              `torch.cuda.synchronize` and an event's
                              `.synchronize()`, inside HOT_PATHS (the
                              engine's round, the trainer's step, the
                              telemetry emit sites): every one is a
                              device stall a round; the deliberate ones
                              carry a baseline justification.
- GR007 unregistered-capture  a capture site (`CapturedFn`,
                              `torch.cuda.graph`, `torch.cuda.CUDAGraph`)
                              in the package with no
                              `# graft-contract: <name>` comment on its
                              line or the three above: an executable the
                              contract registry cannot count.

Accepted findings live in `lint_baseline.json` next to this file, one
justification a key. Keys carry no line numbers
(`rule:path:qualname:detail#ordinal`), so moving code does not churn
the baseline; a baseline key no finding matches is stale and fails.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "Finding",
    "RULES",
    "NO_TORCH_FORM",
    "HOT_PATHS",
    "ORDERED_PATHS",
    "lint_source",
    "lint_paths",
    "default_paths",
    "load_baseline",
    "apply_baseline",
]

RULES: Dict[str, str] = {
    "GR001": "captured-host-sync",
    "GR002": "capture-in-loop",
    "GR004": "host-entropy-in-capture",
    "GR005": "unordered-iteration",
    "GR006": "hot-loop-host-sync",
    "GR007": "unregistered-capture",
}
# JAX rules with no torch form, and why (module doc)
NO_TORCH_FORM: Dict[str, str] = {
    "GR003": "unhashable-static: torch hashes no static arguments into a "
             "cache key; the port keys its runners by tuples it builds",
}

_PKG = "megatron_llm_tpu_torch/"

# GR006 scope: the functions whose per-call latency is the product (one
# scheduler round, one optimizer step) and the telemetry emit sites they
# call, by repo-relative path (the JAX list's, at the port's paths)
HOT_PATHS: Dict[str, Set[str]] = {
    _PKG + "inference/engine.py": {
        "DecodeEngine.step",
        "DecodeEngine._step_inner",
        "DecodeEngine._decode_round",
        "DecodeEngine._mixed_round",
        "DecodeEngine._spec_round",
        "DecodeEngine._book_token",
        "DecodeEngine._admit",
        "DecodeEngine._retire",
        "DecodeEngine._request_cost",
        "DecodeEngine._note_dispatch",
        "DecodeEngine._sentinel_observe",
    },
    _PKG + "training/trainer.py": {
        "Trainer.train_step",
        "Trainer.train",
    },
    _PKG + "telemetry/trace.py": {
        "SpanTracer.span",
        "SpanTracer.instant",
        "SpanTracer.complete",
        "SpanTracer.set_context",
        "SpanTracer._push",
        "SpanTracer._ts",
        "SpanTracer._tid",
        "_Span.__enter__",
        "_Span.__exit__",
    },
    _PKG + "telemetry/recorder.py": {
        "FlightRecorder.record",
        "FlightRecorder.note_counters",
    },
    _PKG + "telemetry/prometheus.py": {
        "Histogram.observe",
    },
    _PKG + "telemetry/goodput.py": {
        "GoodputLedger.note",
        "GoodputLedger.wall_s",
    },
    _PKG + "telemetry/costs.py": {
        "CostRegistry.record",
        "CostRecord.modeled_seconds",
    },
    _PKG + "telemetry/sentinel.py": {
        "PerfSentinel.observe",
        "RobustWindow.push",
        "RobustWindow.threshold",
    },
}

# GR005 scope: modules whose iteration order every rank must share
ORDERED_PATHS: Tuple[str, ...] = (
    _PKG + "parallel/",
    _PKG + "optimizer/",
    _PKG + "training/checkpointing.py",
)

_CAPTURE_CALLS = {"CapturedFn", "graph_capture.CapturedFn",
                  "torch.cuda.graph", "torch.cuda.CUDAGraph",
                  "cuda.graph", "cuda.CUDAGraph"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_CONTRACT_MARK = "graft-contract:"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative
    line: int
    col: int
    qualname: str
    detail: str
    message: str
    ordinal: int = 0

    @property
    def key(self) -> str:
        return (f"{self.rule}:{self.path}:{self.qualname}:"
                f"{self.detail}#{self.ordinal}")

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "name": RULES[self.rule], "path": self.path,
            "line": self.line, "col": self.col, "qualname": self.qualname,
            "detail": self.detail, "message": self.message, "key": self.key,
        }


def _attr_chain(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for Attribute(Name) chains; None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_capture_call(call: ast.Call) -> bool:
    return _attr_chain(call.func) in _CAPTURE_CALLS


def _is_captured_fn_call(call: ast.Call) -> bool:
    chain = _attr_chain(call.func)
    return chain is not None and chain.rsplit(".", 1)[-1] == "CapturedFn"


def _partial_target(node: ast.AST) -> ast.AST:
    """`functools.partial(f, ...)` -> f (nested partials unwrapped)."""
    while isinstance(node, ast.Call) and _attr_chain(node.func) in (
            "partial", "functools.partial") and node.args:
        node = node.args[0]
    return node


class _ModuleIndex:
    """Which function defs are captured code: the first argument of a
    `CapturedFn(...)` call (possibly under `functools.partial`) that
    names a def in scope (`f`, or `type(self).f` / `self.f` / `Cls.f`
    for a method of the enclosing class), and one step of parameter
    flow: a function whose parameter reaches that argument (directly or
    through a local `functools.partial` of it) marks the defs its
    callers pass in that position."""

    def __init__(self, tree: ast.Module):
        self.captured_ids: Set[int] = set()
        defs: Dict[str, List[ast.AST]] = {}
        parent: Dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parent[id(child)] = node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)

        def enclosing(node, kinds):
            n = parent.get(id(node))
            while n is not None and not isinstance(n, kinds):
                n = parent.get(id(n))
            return n

        def mark(target: ast.AST, site: ast.AST) -> Optional[str]:
            """Mark the def `target` names; returns a parameter name when
            `target` is one of the enclosing function's parameters."""
            target = _partial_target(target)
            if isinstance(target, ast.Name):
                fn = enclosing(site, (ast.FunctionDef, ast.AsyncFunctionDef))
                if fn is not None and target.id in {
                        a.arg for a in fn.args.args + fn.args.kwonlyargs}:
                    return target.id
                for d in defs.get(target.id, []):
                    self.captured_ids.add(id(d))
                return None
            if isinstance(target, ast.Attribute):
                cls = enclosing(site, (ast.ClassDef,))
                for d in defs.get(target.attr, []):
                    if cls is None or parent.get(id(d)) is cls:
                        self.captured_ids.add(id(d))
            return None

        # local `x = functools.partial(param, ...)` bindings a function
        # hands to CapturedFn
        flows: Dict[int, Tuple[ast.AST, int]] = {}  # fn id -> (fn, arg pos)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and _is_captured_fn_call(node)
                    and node.args):
                continue
            arg = node.args[0]
            fn = enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            if isinstance(arg, ast.Name) and fn is not None:
                for stmt in ast.walk(fn):
                    if isinstance(stmt, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id == arg.id
                            for t in stmt.targets):
                        arg = stmt.value
                        break
            param = mark(arg, node)
            if param is not None:
                names = [a.arg for a in fn.args.args]
                flows[id(fn)] = (fn, names.index(param))
        for fn, pos in flows.values():
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                if chain is None or chain.rsplit(".", 1)[-1] != fn.name:
                    continue
                # a method called through self: the parameter list
                # starts with self
                i = pos - 1 if isinstance(node.func, ast.Attribute) else pos
                if 0 <= i < len(node.args):
                    mark(node.args[i], node)


def _is_set(node: ast.AST) -> bool:
    """A set display, set comprehension, or set() / frozenset() call."""
    return isinstance(node, (ast.Set, ast.SetComp)) or (
        isinstance(node, ast.Call)
        and _attr_chain(node.func) in ("set", "frozenset"))


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, *, package_scope: bool):
        self.path = path
        self.lines = source.splitlines()
        self.package_scope = package_scope  # GR007 applies
        self.ordered = path.startswith(ORDERED_PATHS)  # GR005 applies
        self.findings: List[Finding] = []
        self._counts: Dict[Tuple[str, str, str], int] = {}
        self._scope: List[str] = []
        self._captured_depth = 0
        self._loop_depth = 0
        self._hot = HOT_PATHS.get(path, set())
        self._hot_depth = 0
        self._index: Optional[_ModuleIndex] = None

    def _qual(self) -> str:
        return ".".join(self._scope) or "<module>"

    def _emit(self, rule: str, node: ast.AST, detail: str, message: str):
        ckey = (rule, self._qual(), detail)
        n = self._counts.get(ckey, 0)
        self._counts[ckey] = n + 1
        self.findings.append(Finding(
            rule=rule, path=self.path, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), qualname=self._qual(),
            detail=detail, message=message, ordinal=n))

    def _marked(self, node: ast.AST) -> bool:
        line = getattr(node, "lineno", 0)
        return any(_CONTRACT_MARK in ln
                   for ln in self.lines[max(0, line - 4):line])

    def run(self, tree: ast.Module):
        self._index = _ModuleIndex(tree)
        self.visit(tree)
        return self.findings

    def _visit_scope(self, node, name: str, captured: bool, hot: bool):
        self._scope.append(name)
        self._captured_depth += captured
        self._hot_depth += hot
        # a nested def's body is not the enclosing loop's body
        loops, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = loops
        self._hot_depth -= hot
        self._captured_depth -= captured
        self._scope.pop()

    def visit_FunctionDef(self, node):
        qual = ".".join(self._scope + [node.name])
        self._visit_scope(node, node.name,
                          id(node) in self._index.captured_ids,
                          qual in self._hot)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._visit_scope(node, node.name, False, False)

    def visit_Lambda(self, node):
        self._visit_scope(node, "<lambda>", False, False)

    def visit_For(self, node):
        self._check_iter_order(node.iter)
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_While(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def _visit_comprehension(self, node, builds: bool):
        if builds:
            for gen in node.generators:
                self._check_iter_order(gen.iter)
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_ListComp(self, node):
        self._visit_comprehension(node, True)

    def visit_DictComp(self, node):
        self._visit_comprehension(node, True)

    def visit_SetComp(self, node):
        self._visit_comprehension(node, False)

    def visit_GeneratorExp(self, node):
        self._visit_comprehension(node, False)

    # -- rules -------------------------------------------------------------

    def _check_iter_order(self, it: ast.AST):
        """GR005: a set iterated to build a list or dict in ordered
        code."""
        if self.ordered and _is_set(it):
            self._emit(
                "GR005", it, "set-iteration",
                "a set's iteration order is hash-seed dependent: the list "
                "or dict it builds can differ between ranks that must "
                "agree on it (bucket, leaf and group order) — sort it or "
                "iterate a tuple or dict")

    def _sync(self, node: ast.Call) -> Optional[str]:
        """The GR001 sync this call is, if any."""
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS and not node.args:
            return f".{node.func.attr}()"
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") \
                and node.args and not isinstance(node.args[0], ast.Constant):
            return f"{node.func.id}()"
        return None

    def visit_Call(self, node: ast.Call):
        chain = _attr_chain(node.func)
        capture = _is_capture_call(node)
        if capture and self._loop_depth:
            self._emit(
                "GR002", node, "capture-in-loop",
                f"{chain} built inside a loop: a fresh graph and memory "
                "pool per iteration, each a capture's cost — build the "
                "runner once and replay it (the engine keys its runners "
                "by bucket)")
        if capture and self.package_scope and not self._marked(node):
            self._emit(
                "GR007", node, "unmarked-capture",
                f"{chain} site outside the compile-contract registry: "
                "record its variants (analysis/contracts.py) and mark the "
                "site with `# graft-contract: <name>`, or baseline it with "
                "a justification")
        if self.ordered and chain in ("list", "tuple", "enumerate",
                                      "dict.fromkeys") \
                and node.args and _is_set(node.args[0]):
            # a list, tuple or dict built straight from a set
            self._check_iter_order(node.args[0])
        sync = self._sync(node)
        if self._captured_depth:
            if sync:
                self._emit(
                    "GR001", node, sync,
                    f"{sync} inside captured code reads the card on the "
                    "host: on the card the capture fails (or an uncaptured "
                    "run stalls a round) — keep the value on the card")
            if chain and chain.startswith(("time.", "random.", "np.random.",
                                           "numpy.random.")):
                self._emit(
                    "GR004", node, chain,
                    f"{chain} inside captured code runs once, at capture, "
                    "and is frozen into the graph — pass it in as a static "
                    "input buffer")
        if self._hot_depth:
            if sync:
                self._emit(
                    "GR006", node, sync,
                    f"{sync} in a hot loop is a device-to-host read a round "
                    "when its operand is a tensor — batch it, gate it on "
                    "need, or move it off the round path")
            if chain == "torch.cuda.synchronize" or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "synchronize"):
                self._emit(
                    "GR006", node, "synchronize",
                    "synchronize in a hot loop serialises host and card — "
                    "the round's dispatch exists to overlap them")
        self.generic_visit(node)


def lint_source(source: str, path: str, *, package_scope: bool = False
                ) -> List[Finding]:
    tree = ast.parse(source, filename=path)
    return _Linter(path, source, package_scope=package_scope).run(tree)


def default_paths(root: str) -> List[str]:
    """The lint surface: the port's package, its tools among them. The
    analysis package itself is left out: its reference runs are its
    measuring apparatus, not entry points."""
    out: List[str] = []
    pkg = os.path.join(root, "megatron_llm_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "analysis"))
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return out


def lint_paths(paths: List[str], root: str) -> List[Finding]:
    findings: List[Finding] = []
    for p in paths:
        rel = os.path.relpath(p, root).replace(os.sep, "/")
        with open(p, "r", encoding="utf-8") as fh:
            src = fh.read()
        findings.extend(lint_source(src, rel,
                                    package_scope=rel.startswith(_PKG)))
    return findings


# -- baseline ---------------------------------------------------------------


def load_baseline(path: str) -> Dict[str, str]:
    """key -> justification. A missing file is an empty baseline; an
    entry without a justification raises."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data["entries"] if isinstance(data, dict) else data
    out = {}
    for e in entries:
        if not str(e.get("justification", "")).strip():
            raise ValueError(
                f"baseline entry {e.get('key')!r} has no justification — "
                "every accepted finding must say why it is accepted")
        out[e["key"]] = e["justification"]
    return out


def apply_baseline(findings: List[Finding], baseline: Dict[str, str]
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (new, accepted, stale baseline keys)."""
    seen = set()
    new, accepted = [], []
    for f in findings:
        if f.key in baseline:
            accepted.append(f)
            seen.add(f.key)
        else:
            new.append(f)
    return new, accepted, sorted(set(baseline) - seen)
