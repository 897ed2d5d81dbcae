"""PyTorch port, the static-analysis gate (analysis/ and
tools/graft_check.py) on the CPU:

- each lint rule with a torch form (GR001, GR002, GR004-GR007) fires on
  exactly the marked lines of a bad fixture and stays quiet on a good
  one; GR003 is recorded as having none;
- the baseline: an empty justification raises; findings split into new,
  accepted and stale;
- the contract registry driven through one sequence of
  `record_variant`, `release_variant`, owners and budgets beside the
  JAX package's registry: equal counts after every call, the same calls
  raising `ContractViolation`, owners' buckets gone with them, mint
  listeners fired once a new variant;
- a CPU engine that mints one round past its config's budget raises at
  mint time; the cost registry's pending inventory comes from the mint
  listener;
- the audit fails on an injected collective, a float64 op and a host
  sync, and the marker check on a marker naming no contract;
- `graft_check all` exits 0 on the tree; `costs` exits 1 on an injected
  2x FLOPs; `verdict` folds the gates and a bench headline;
- the overlap gauges read the step's GradOverlap counts.
"""

import json
import os
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.analysis import audit, contracts, lint
from megatron_llm_tpu_torch.analysis.overlap import grad_overlap_report
from megatron_llm_tpu_torch.tools import graft_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "megatron_llm_tpu_torch/"


# ---------------------------------------------------------------------------
# lint rules: bad fixtures fire on exactly the lines marked "# BAD"
# ---------------------------------------------------------------------------

GR001_BAD = '''
import functools
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

def _round(x, *, n):
    y = x * 2
    a = y.item()  # BAD
    b = float(y.sum())  # BAD
    c = y.tolist()  # BAD
    d = y.cpu().numpy()  # BAD BAD
    e = int(3)
    return y

class Engine:
    def _capture(self, step, args):
        fn = functools.partial(step, n=1)
        # graft-contract: engine.decode_scan
        return CapturedFn(fn, args)

    def _step_fn(self):
        return self._capture(_round, {})
'''
GR001_GOOD = '''
import functools
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

def _round(x, *, n):
    return (x * 2).sum()

def host(y):
    return y.item(), float(y)

class Engine:
    def _capture(self, step, args):
        fn = functools.partial(step, n=1)
        # graft-contract: engine.decode_scan
        return CapturedFn(fn, args)

    def _step_fn(self):
        return self._capture(_round, {})
'''
GR002_BAD = '''
import torch
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

def build(fns):
    out = []
    for f in fns:
        # graft-contract: generate.tokens
        out.append(CapturedFn(f, {}))  # BAD
    graphs = [torch.cuda.CUDAGraph() for _ in range(3)]  # BAD, also GR007
    return out, graphs
'''
GR002_GOOD = '''
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

def build(f):
    # graft-contract: generate.tokens
    runner = CapturedFn(f, {})
    return [runner for _ in range(3)]
'''
GR004_BAD = '''
import random
import time
import numpy as np
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

class Loop:
    def _step(self):
        t = time.time()  # BAD
        r = random.random()  # BAD
        n = np.random.rand()  # BAD
        return t + r + n

    def __init__(self):
        # graft-contract: generate.tokens
        self.step = CapturedFn(type(self)._step, {})
'''
GR004_GOOD = '''
import time
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

class Loop:
    def _step(self):
        return self.t

    def run(self):
        t0 = time.time()
        self.step()
        return time.time() - t0

    def __init__(self):
        # graft-contract: generate.tokens
        self.step = CapturedFn(type(self)._step, {})
'''
GR005_BAD = '''
def buckets(leaves, names):
    out = [n for n in set(names)]  # BAD
    order = {k: i for i, k in enumerate({1, 2, 3})}  # BAD
    for x in frozenset(leaves):  # BAD
        out.append(x)
    keys = list(set(names)) + list(dict.fromkeys({n for n in names}))  # BAD BAD
    return out, order, keys
'''
GR005_GOOD = '''
def buckets(leaves, names):
    out = [n for n in sorted(set(names))]
    seen = {n for n in set(names)}
    for x in tuple(leaves):
        out.append(x)
    return out, seen
'''
GR006_BAD = '''
import torch

class DecodeEngine:
    def _decode_round(self, out, ev):
        toks = out.cpu().numpy()  # BAD BAD
        torch.cuda.synchronize()  # BAD
        ev.synchronize()  # BAD
        n = int(out[0])  # BAD
        return toks, n

    def admit_later(self, out):
        return out.item()
'''
GR006_GOOD = '''
class DecodeEngine:
    def _decode_round(self, out):
        self.pending.append(out)
        return len(self.pending) + int(3)

    def collect(self):
        return [p.cpu() for p in self.pending]
'''
GR007_BAD = '''
import torch
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

def make(f):
    runner = CapturedFn(f, {})  # BAD
    g = torch.cuda.CUDAGraph()  # BAD
    with torch.cuda.graph(g):  # BAD
        f()
    return runner
'''
GR007_GOOD = '''
import torch
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn

def make(f):
    # graft-contract: generate.tokens
    runner = CapturedFn(f, {})
    return runner
'''

RULE_FIXTURES = {
    "GR001": (GR001_BAD, GR001_GOOD, PKG + "inference/fixture.py"),
    "GR002": (GR002_BAD, GR002_GOOD, PKG + "inference/fixture.py"),
    "GR004": (GR004_BAD, GR004_GOOD, PKG + "inference/fixture.py"),
    "GR005": (GR005_BAD, GR005_GOOD, PKG + "parallel/fixture.py"),
    "GR006": (GR006_BAD, GR006_GOOD, PKG + "inference/engine.py"),
    "GR007": (GR007_BAD, GR007_GOOD, PKG + "inference/fixture.py"),
}


def _marked_lines(src):
    """{line: count} of the "# BAD" marks (a mark may note another rule
    the line also breaks: "# BAD, also GR007")."""
    out = {}
    for i, line in enumerate(src.splitlines(), 1):
        if "# BAD" in line:
            out[i] = line.count("BAD")
    return out


@pytest.mark.parametrize("rule", sorted(RULE_FIXTURES))
def test_rule_fires_on_exactly_the_marked_lines(rule):
    bad, good, path = RULE_FIXTURES[rule]
    fired = {}
    for f in lint.lint_source(bad, path, package_scope=True):
        if f.rule == rule:
            fired[f.line] = fired.get(f.line, 0) + 1
    assert fired == _marked_lines(bad), fired
    quiet = [f for f in lint.lint_source(good, path, package_scope=True)
             if f.rule == rule]
    assert quiet == [], quiet


def test_ordered_iteration_is_only_checked_where_ranks_agree():
    """GR005 applies in parallel/, optimizer/ and the checkpoint module,
    nowhere else."""
    for path, n in ((PKG + "optimizer/x.py", 5),
                    (PKG + "training/checkpointing.py", 5),
                    (PKG + "inference/x.py", 0)):
        found = [f for f in lint.lint_source(GR005_BAD, path,
                                             package_scope=True)
                 if f.rule == "GR005"]
        assert len(found) == n, path


def test_gr003_has_no_torch_form_and_says_why():
    assert "GR003" not in lint.RULES
    assert "GR003" in lint.NO_TORCH_FORM and lint.NO_TORCH_FORM["GR003"]
    assert sorted(lint.RULES) == ["GR001", "GR002", "GR004", "GR005",
                                  "GR006", "GR007"]


def test_keys_carry_no_line_numbers():
    a = lint.lint_source(GR007_BAD, PKG + "x.py", package_scope=True)
    b = lint.lint_source("\n\n\n" + GR007_BAD, PKG + "x.py",
                         package_scope=True)
    assert [f.key for f in a] == [f.key for f in b]
    assert [f.line + 3 for f in a] == [f.line for f in b]


def test_baseline_split_and_justifications(tmp_path):
    findings = lint.lint_source(GR007_BAD, PKG + "x.py", package_scope=True)
    keys = [f.key for f in findings]
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"entries": [
        {"key": keys[0], "justification": "deliberate"},
        {"key": "GR007:gone.py:f:unmarked-capture#0",
         "justification": "the code it excused is gone"}]}))
    new, accepted, stale = lint.apply_baseline(findings,
                                               lint.load_baseline(str(p)))
    assert [f.key for f in accepted] == keys[:1]
    assert [f.key for f in new] == keys[1:]
    assert stale == ["GR007:gone.py:f:unmarked-capture#0"]
    p.write_text(json.dumps({"entries": [{"key": keys[0],
                                          "justification": " "}]}))
    with pytest.raises(ValueError, match="no justification"):
        lint.load_baseline(str(p))
    assert lint.load_baseline(str(tmp_path / "missing.json")) == {}


def test_the_tree_lints_clean_against_its_baseline():
    findings = lint.lint_paths(lint.default_paths(REPO), REPO)
    base = lint.load_baseline(graft_check.BASELINE)
    new, accepted, stale = lint.apply_baseline(findings, base)
    assert new == [] and stale == [], ([f.key for f in new], stale)
    assert len(accepted) == len(base) > 0


# ---------------------------------------------------------------------------
# the registry, beside the JAX package's
# ---------------------------------------------------------------------------


class _Owner:
    pass


def test_registry_matches_the_jax_registry_call_for_call():
    from megatron_llm_tpu.analysis import contracts as jax_contracts

    regs = (contracts, jax_contracts)
    for reg in regs:
        reg.register_contract(reg.CompileContract("audit.test_a",
                                                  max_variants=3))
        reg.register_contract(reg.CompileContract("audit.test_b"))
    minted = {reg: [] for reg in regs}
    listeners = {reg: (lambda n, k, o, _r=reg: minted[_r].append((n, k)))
                 for reg in regs}
    for reg in regs:
        reg.add_mint_listener(listeners[reg])
    owners = [_Owner(), _Owner()]
    # (op, contract, key, owner index or None for the global bucket,
    # call-site budget)
    script = [
        ("record", "audit.test_a", 1, 0, None),
        ("record", "audit.test_a", 1, 0, None),  # a known key: no mint
        ("record", "audit.test_a", 2, 0, None),
        ("record", "audit.test_a", 3, 0, 2),  # past the call-site budget
        ("record", "audit.test_a", 3, 0, None),
        ("record", "audit.test_a", 4, 0, None),  # past max_variants 3
        ("release", "audit.test_a", 2, 0, None),
        ("record", "audit.test_a", 4, 0, None),
        ("record", "audit.test_a", 1, 1, None),  # another owner's bucket
        ("record", "audit.test_a", 5, None, None),  # the global bucket
        ("release", "audit.test_a", 9, 0, None),  # not there
    ] + [("record", "audit.test_b", i, 0, None) for i in range(40)]
    raised = []
    for op, name, key, who, budget in script:
        outcomes = []
        for reg in regs:
            owner = None if who is None else owners[who]
            try:
                if op == "record":
                    got = reg.record_variant(name, key, owner=owner,
                                             budget=budget)
                else:
                    got = reg.release_variant(name, key, owner=owner)
            except reg.ContractViolation:
                got = "violation"
                raised.append((reg.__name__, op, key))
            outcomes.append((got, reg.variant_count(name, owners[0]),
                             reg.variant_count(name, owners[1]),
                             reg.variant_count(name),
                             reg.total_live_variants(name),
                             sorted(reg.variants(name, owners[0]))))
        assert outcomes[0] == outcomes[1], (op, name, key, outcomes)
    # the same two calls raised in both
    assert sorted(k for _, _, k in raised) == [3, 3, 4, 4]
    assert contracts.variant_count("audit.test_a", owners[0]) == 3
    assert minted[contracts] == minted[jax_contracts]
    # an owner's bucket goes with it
    ref = weakref.ref(owners[0])
    del owners[0], owner
    assert ref() is None
    for reg in regs:
        assert reg.total_live_variants("audit.test_a") == 2
        reg.remove_mint_listener(listeners[reg])
    assert issubclass(contracts.ContractViolation, AssertionError)


def test_registry_rejects_unknown_collectives_and_names():
    with pytest.raises(ValueError, match="unknown collective"):
        contracts.CompileContract("x", collectives={"tp2": {"all-sum"}})
    with pytest.raises(KeyError, match="no compile contract"):
        contracts.record_variant("audit.never_registered", 1)
    assert set(contracts.TORCH_COLLECTIVES.values()) <= set(
        contracts.COLLECTIVE_OPS)


# ---------------------------------------------------------------------------
# the engine's mints
# ---------------------------------------------------------------------------


def _engine(**kw):
    from megatron_llm_tpu_torch.inference.engine import DecodeEngine

    model, params = audit._tiny_model()
    return DecodeEngine(model, params, slots=2, page_size=16,
                        max_context=64, vocab_size=256, **kw)


def test_engine_past_its_bucket_budget_raises_at_mint_time():
    eng = _engine(step_horizon=2, prefill_chunk_tokens=8)
    assert eng._variant_budget("engine.decode_scan") == 4  # {1, 2} x 2
    for h in (1, 2):
        for g in (True, False):
            eng._step_fn(h, g)
    assert contracts.variant_count("engine.decode_scan", owner=eng) == 4
    with pytest.raises(contracts.ContractViolation, match="budget of 4"):
        eng._step_fn(4, True)  # a horizon no bucket of this engine has
    assert (4, True) not in eng._step_fns
    # the warm-up captures exactly the config's buckets
    eng2 = _engine(step_horizon=8, prefill_chunk_tokens=16, spec_decode_k=2)
    with torch.inference_mode():
        eng2._warmup_scoped()
    for name in ("engine.decode_scan", "engine.mixed_step",
                 "engine.spec_verify"):
        assert contracts.variant_count(name, owner=eng2) == \
            eng2._variant_budget(name)
    assert contracts.variant_count("engine.page_copy", owner=eng2) == 1


def test_cost_registry_inventory_comes_from_the_mint_listener():
    eng = _engine(step_horizon=2, prefill_chunk_tokens=8,
                  cost_registry=True, chip_spec="h100")
    eng._step_fn(2, True)
    pending = {(r["contract"], r["key"]) for r in eng.costs.rows()
               if r.get("pending")}
    assert ("engine.decode_scan", repr((2, True))) in pending
    # another engine's mint is not this registry's
    other = _engine(step_horizon=2, prefill_chunk_tokens=8)
    other._step_fn(1, False)
    assert ("engine.decode_scan", repr((1, False))) not in {
        (r["contract"], r["key"]) for r in eng.costs.rows()}
    eng.costs.detach()
    assert eng.costs._listener is None


# ---------------------------------------------------------------------------
# the audit and the gate
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_audit_fails_on_an_injected_collective(one_rank_group):
    def target(x):
        dist.all_reduce(x)
        return x

    res, _ = audit.audit_run("ops.flash_attention", "single", target,
                             torch.ones(2))
    assert not res.ok and res.facts["collectives"] == ["all-reduce"]
    assert "collective inventory mismatch" in res.failures[0]


@pytest.mark.parametrize("inject,what", [
    (lambda x: x.double(), "float64 ops"),
    (lambda x: torch.ones(2, dtype=torch.float64) + x, "float64 ops"),
    (lambda x: x.sum().item(), "host syncs"),
    (lambda x: float(x.sum()), "host syncs"),
    (lambda x: x.cpu().numpy(), "host syncs"),
])
def test_audit_fails_on_an_f64_op_and_a_host_sync(inject, what):
    res, _ = audit.audit_run("ops.flash_attention", "single", inject,
                             torch.ones(2))
    assert not res.ok and what in " ".join(res.failures), res.failures
    clean, _ = audit.audit_run("ops.flash_attention", "single",
                               lambda x: x * 2, torch.ones(2))
    assert clean.ok, clean.failures


def test_audit_marker_check_fails_on_a_broken_marker(tmp_path):
    pkg = tmp_path / "megatron_llm_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text("# graft-contract: engine.no_such_round\n"
                                "x = 1\n"
                                "# graft-contract: generate.tokens\n")
    problems = audit.check_contract_markers(str(tmp_path))
    assert len(problems) == 1 and "engine.no_such_round" in problems[0]
    assert audit.check_contract_markers(REPO) == []


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """`graft_check all` on the tree, once: (exit code, report)."""
    out = tmp_path_factory.mktemp("gate") / "report.json"
    rc = graft_check.main(["all", "--json", str(out)])
    return rc, json.loads(out.read_text())


def test_graft_check_all_exits_0_on_the_tree(gate):
    rc, report = gate
    assert rc == 0 and report["ok"], [
        (t["contract"], t["mesh"], t["failures"])
        for t in report["audit"]["targets"] if not t["ok"]]
    audit_rep = report["audit"]
    assert {"single", "tp2", "dp2", "dp2tp2", "dp2+zero1",
            "dp2+zero1-quant", "dp2+zero1+overlap", "dp2tp2+zero1"} <= \
        set(audit_rep["mesh_tags"])
    by = {(t["contract"], t["mesh"]): t["facts"]
          for t in audit_rep["targets"]}
    assert by[("train.step", "dp2+zero1")]["collectives"] == [
        "all-gather", "all-reduce", "reduce-scatter"]
    assert by[("train.step", "dp2+zero1-quant")]["collectives"] == [
        "all-gather", "all-reduce", "all-to-all"]
    assert by[("train.step", "tp2")]["collectives"] == ["all-reduce"]
    over = by[("train.step", "dp2+zero1+overlap")]
    assert over["reduce_scatters_in_backward"] >= \
        over["overlap_plan"]["groups"] - 1 >= 1
    assert by[("train.step", "dp2+zero1")]["reduce_scatters_in_backward"] \
        == 0
    for key in ("engine.decode_scan", "engine.mixed_step", "train.step",
                "generate.tokens"):
        assert by[(key, "single")]["flops"] > 0, key
    assert report["lint"]["new"] == [] and report["costs"]["ok"]


def _report_without_audit(monkeypatch, gate):
    monkeypatch.setattr(graft_check, "run_audit",
                        lambda: json.loads(json.dumps(gate[1]["audit"])))


def test_costs_fail_on_a_doubled_flops(gate, tmp_path, monkeypatch):
    _report_without_audit(monkeypatch, gate)
    rows = graft_check._cost_rows(gate[1]["audit"])
    base = json.loads(open(graft_check.COST_BASELINE).read())
    assert {e["key"] for e in base["entries"]} == set(rows)
    # the tree's FLOPs doubled against its baseline: half the baseline
    for e in base["entries"]:
        e["flops"] //= 2
    p = tmp_path / "halved.json"
    p.write_text(json.dumps(base))
    assert graft_check.main(["costs", "--cost-baseline", str(p)]) == 1
    res = graft_check.run_costs(gate[1]["audit"], baseline_path=str(p))
    assert not res["ok"] and any(
        "train.step[dp2]: flops" in r for r in res["regressions"])
    # a missing and a stale key fail too
    base["entries"] = base["entries"][1:] + [
        {"key": "gone[single]", "flops": 1, "justification": "gone"}]
    p.write_text(json.dumps(base))
    res = graft_check.run_costs(gate[1]["audit"], baseline_path=str(p))
    assert res["missing_keys"] and res["stale_keys"] == ["gone[single]"]
    assert graft_check.main(["costs"]) == 0


def test_cost_baseline_update_needs_a_justification(gate, tmp_path):
    p = tmp_path / "b.json"
    res = graft_check.run_costs(gate[1]["audit"], baseline_path=str(p),
                                update=True, justify="")
    assert not res["ok"] and not p.exists()
    res = graft_check.run_costs(gate[1]["audit"], baseline_path=str(p),
                                update=True, justify="pinned")
    assert res["ok"] and graft_check.run_costs(
        gate[1]["audit"], baseline_path=str(p))["ok"]


def test_verdict_folds_the_gates_and_the_bench_headline(gate, tmp_path,
                                                        monkeypatch):
    _report_without_audit(monkeypatch, gate)
    art, base = tmp_path / "run.json", tmp_path / "pinned.json"
    art.write_text(json.dumps({"value": 90.0, "unit": "tok/s"}))
    base.write_text(json.dumps({"value": 100.0, "unit": "tok/s"}))
    out = tmp_path / "v.json"
    rc = graft_check.main(["verdict", "--bench-artifact", str(art),
                           "--bench-baseline", str(base), "--json",
                           str(out)])
    v = json.loads(out.read_text())["verdict"]
    assert rc == 1 and v["verdict"] == "NO-GO"
    assert v["gates"] == {"lint": True, "audit": True, "costs": True,
                          "bench_headline": False}
    art.write_text(json.dumps({"value": 99.0, "unit": "tok/s"}))
    assert graft_check.main(["verdict", "--bench-artifact", str(art),
                             "--bench-baseline", str(base)]) == 0
    v = graft_check.build_verdict(gate[1], bench=graft_check._bench_diff(
        str(art), None))
    assert v["verdict"] == "GO" and v["bench"]["ok"] is None


# ---------------------------------------------------------------------------
# the overlap gauges
# ---------------------------------------------------------------------------


def test_overlap_gauges_read_the_steps_grad_overlap():
    def step():
        pass

    assert grad_overlap_report(step).to_dict() == {"async_pairs": 0,
                                                   "max_in_flight": 0}
    step.overlap_gauges = lambda: (3, 5)
    rep = grad_overlap_report(step)
    assert (rep.async_pairs, rep.max_in_flight) == (3, 5)


def test_grad_overlap_counts_groups_issued_inside_the_backward():
    """GradOverlap's hooks count a group issued while another group's
    backward still runs, and the most works in flight."""
    from megatron_llm_tpu_torch.optimizer import zero1

    g = zero1.GradOverlap.__new__(zero1.GradOverlap)
    g.plan = type("P", (), {"groups": [(0, 1), (1, 2), (2, 3)],
                            "layer_axes": [0]})()
    g.sharded, g.group_of = [0], {0: 0, 1: 1, 2: 2}
    g.reset()
    issued = []
    g._issue_group = lambda gi, grads=None: (
        issued.append(gi), g.count.__setitem__(gi, -1),
        g.pending.append((gi, None, [])),
        setattr(g, "max_in_flight", max(g.max_in_flight, len(g.pending))))
    for layer in (2, 1, 0):  # the backward's order
        g.hook(0, layer, torch.zeros(1))
    assert issued == [2, 1, 0]
    assert g.pairs == 2 and g.max_in_flight == 3
    assert np.isscalar(g.from_hooks) and g.from_hooks == 3
