"""graft-check pass 2: the compile-contract audit (port of
analysis/audit.py).

Every contract (analysis/contracts.py) claims what its entry point does
when it runs: how many executables traffic may mint, which collectives
it issues on each mesh shape, that it reads nothing back on the host,
that no float64 enters it. The JAX audit lowers each entry point and
reads the compiled artifact. Torch has no artifact on the CPU, so the
port runs each contract's reference target once, on the CPU, at a tiny
fp32 config (2 layers, hidden 64), under a recorder that sees:

- the collectives: every `torch.distributed` call the target makes
  (`parallel/mesh.py`'s and any other), named by
  `contracts.TORCH_COLLECTIVES`, against the contract's inventory for
  the mesh tag;
- host syncs, standing for JAX's host callbacks: `aten._local_scalar_dense`
  (`.item()`, `float()`, `int()`, `bool()` of a tensor) and
  `Tensor.cpu()`, `.numpy()`, `.tolist()` called inside the target;
- float64: any aten op with a float64 output;
- FLOPs: `telemetry/costs.py`'s counting modes plus the kernel wrappers'
  own counts, the numbers `graft_check costs` diffs;
- the live variants of the contract, against its budget.

Mesh tags are run in gloo ranks (`utils/virtual_mesh.spawn_cpu_group`):
tp2, dp2 and dp2tp2 (with `+zero1`, `+zero1-quant`, `+overlap`,
`+telemetry`, `+costs`); "single" in this process. Reference targets:

- the engine's three captured round kinds through its own runners
  (`_step_fn`, `_mixed_fn`, `_spec_fn`, on their idle rounds) and its
  page copy, export and import, on four engines: fp, int8 pools with
  int8 weights, telemetry on and the cost registry on
  (`_check_telemetry_parity` holds the last two to the first: the same
  collectives, no host sync, the same FLOPs);
- `ops.weight_quant`, `generate.tokens` (without early termination, the
  one host read the loop makes between steps), `ops.flash_attention`
  (the plain version: the kernel needs the card), `realm.chunk_topk`
  (the exact search, whose result comes back to the host as numpy: the
  contract allows that one read);
- `train.step` at every tag above.

Cross-checks, as in JAX: `_check_zero1_state_bytes` (a rank's Adam
moments under ZeRO-1 at most 1/dp of the replicated ones, plus the
replicated residue), `_check_overlap_schedule` (under
`--overlap_grad_reduce` the reduce-scatters are issued between the
backward's layer groups, where the eager path issues them all after the
backward, and the wire bytes are the eager plan's),
`_check_telemetry_parity`.

Not run: `train.pipeline_step`, `api.pp_score`, `api.pp_decode`
(stage-sharded, held by the pipeline suites), `train.eval_step`,
`generate.beam`, `engine.prefill_bucket` (uncaptured in the port); the
engine at tp2 (held by tests/test_torch_tp_serving.py); their budgets
and markers are still checked. `tmp_bytes_budget` has no CPU artifact
in torch: it is checked on the card only, through the engine's
graph-pool bytes (`CostRegistry.note_temp`).

The module imports torch lazily: importing it costs nothing.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from megatron_llm_tpu_torch.analysis.contracts import (
    TORCH_COLLECTIVES,
    all_contracts,
    get_contract,
    record_variant,
    total_live_variants,
)

__all__ = [
    "MESH_TAGS",
    "TargetResult",
    "Recorder",
    "audit_run",
    "audit_repo",
    "check_contract_markers",
]

# mesh tag -> (dp, tp); a suffix selects the specialisation, the prefix
# the layout
MESH_TAGS: Dict[str, Tuple[int, int]] = {
    "single": (1, 1),
    "tp2": (1, 2),
    "dp2": (2, 1),
    "dp2tp2": (2, 2),
}
TRAIN_TAGS_2 = ("tp2", "dp2", "dp2+telemetry", "dp2+costs", "dp2+zero1",
                "dp2+zero1-quant", "dp2+zero1+overlap")
TRAIN_TAGS_4 = ("dp2tp2", "dp2tp2+zero1")
TEMP_BYTES = ("checked on the card only: the engine's graph-pool bytes "
              "(CostRegistry.note_temp)")
RANK_TIMEOUT_S = 300.0


def _mesh_shape_for_tag(tag: str) -> Tuple[int, int]:
    return MESH_TAGS[tag.split("+", 1)[0]]


@dataclass
class TargetResult:
    """One (contract, mesh tag) verdict."""

    contract: str
    mesh_tag: str
    ok: bool = True
    failures: List[str] = field(default_factory=list)
    facts: Dict[str, Any] = field(default_factory=dict)

    def fail(self, msg: str):
        self.ok = False
        self.failures.append(msg)

    def to_dict(self) -> dict:
        return {"contract": self.contract, "mesh": self.mesh_tag,
                "ok": self.ok, "failures": self.failures,
                "facts": self.facts}


class Recorder:
    """What a target does while the recorder is open: `collectives`
    (JAX names, in issue order), `host_syncs` (what read the card on the
    host), `f64` (aten ops with a float64 output), `flops`, and
    `events` (collectives and the markers `mark` adds, in order)."""

    def __init__(self):
        self.collectives: List[str] = []
        self.host_syncs: List[str] = []
        self.f64: List[str] = []
        self.events: List[str] = []
        self.flops = 0.0
        self.bytes = 0.0

    def mark(self, what: str) -> None:
        self.events.append(what)

    @contextlib.contextmanager
    def __call__(self):
        import torch
        import torch.distributed as dist
        from torch.utils._python_dispatch import TorchDispatchMode

        from megatron_llm_tpu_torch.telemetry import costs

        rec = self
        patched = []

        def wrap_dist(name, kind):
            orig = getattr(dist, name)

            def call(*a, **kw):
                rec.collectives.append(kind)
                rec.events.append(kind)
                return orig(*a, **kw)

            setattr(dist, name, call)
            patched.append((dist, name, orig))

        for name, kind in TORCH_COLLECTIVES.items():
            if hasattr(dist, name):
                wrap_dist(name, kind)

        def wrap_read(name):
            orig = getattr(torch.Tensor, name)

            def call(self, *a, **kw):
                rec.host_syncs.append(f"Tensor.{name}")
                return orig(self, *a, **kw)

            setattr(torch.Tensor, name, call)
            patched.append((torch.Tensor, name, orig))

        for name in ("cpu", "numpy", "tolist"):
            wrap_read(name)

        class Watch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func.overloadpacket.__name__)
                if name == "_local_scalar_dense":
                    rec.host_syncs.append("aten._local_scalar_dense")
                out = func(*args, **(kwargs or {}))
                outs = out if isinstance(out, (tuple, list)) else (out,)
                if any(isinstance(o, torch.Tensor)
                       and o.dtype == torch.float64 for o in outs):
                    rec.f64.append(f"aten.{name}")
                return out

        # FLOPs and bytes as the cost registry counts them (Watch runs
        # each op through it)
        count = costs.Counting(all_threads=True)
        try:
            with count, Watch():
                yield self
        finally:
            for obj, name, orig in reversed(patched):
                setattr(obj, name, orig)
            self.flops, self.bytes = count.flops, count.nbytes


def audit_run(name: str, mesh_tag: str, fn, *args, **kwargs):
    """Run `fn(*args, **kwargs)` once under a `Recorder` and check what
    it did against contract `name` at `mesh_tag`. Returns (the result,
    fn's return value)."""
    contract = get_contract(name)
    res = TargetResult(contract=name, mesh_tag=mesh_tag)
    rec = Recorder()
    with rec():
        out = fn(*args, **kwargs)
    check_facts(res, rec)
    return res, out


def check_facts(res: TargetResult, rec: Recorder) -> TargetResult:
    """The contract's checks of one recorded run."""
    contract = get_contract(res.contract)
    found = sorted(set(rec.collectives))
    res.facts["collectives"] = found
    res.facts["collective_counts"] = {
        k: rec.collectives.count(k) for k in found}
    if contract.collectives is not None:
        if res.mesh_tag not in contract.collectives:
            res.fail(f"mesh tag {res.mesh_tag!r} not declared in the "
                     f"contract's collective inventory (declared: "
                     f"{sorted(contract.collectives)})")
        else:
            declared = sorted(contract.collectives[res.mesh_tag])
            if found != declared:
                res.fail(f"collective inventory mismatch on "
                         f"{res.mesh_tag}: the run issued {found}, the "
                         f"contract declares {declared}: update the "
                         f"declaration only with the change that "
                         f"justifies it")
    res.facts["host_callbacks"] = sorted(set(rec.host_syncs))
    if rec.host_syncs and not contract.allow_host_callbacks:
        res.fail(f"host syncs inside the target: "
                 f"{sorted(set(rec.host_syncs))} (each reads the card "
                 f"on the host: a stall, and a failed capture on the "
                 f"card)")
    res.facts["f64"] = bool(rec.f64)
    if rec.f64 and not contract.allow_f64:
        res.fail(f"float64 ops inside the target: {sorted(set(rec.f64))} "
                 f"(an accidental promotion: numpy defaults, Python "
                 f"floats made tensors)")
    res.facts["flops"] = int(rec.flops)
    res.facts["bytes_accessed"] = int(rec.bytes)
    res.facts["temp_bytes"] = TEMP_BYTES
    res.facts["live_variants"] = total_live_variants(res.contract)
    return res


def _check_budget(res: TargetResult, live: int, budget: int) -> None:
    contract = get_contract(res.contract)
    res.facts["owner_variants"] = live
    res.facts["owner_budget"] = budget
    if live > budget:
        res.fail(f"{live} live variants over the owner's budget {budget}")
    if contract.max_variants is not None \
            and budget > contract.max_variants:
        res.fail(f"the config's budget {budget} exceeds the declared "
                 f"max_variants {contract.max_variants}: the engine's "
                 f"bucket math and the declaration disagree")


# ---------------------------------------------------------------------------
# reference targets
# ---------------------------------------------------------------------------


def _tiny_model(**over):
    import torch

    from megatron_llm_tpu_torch.config import tiny_config
    from megatron_llm_tpu_torch.models import LlamaModel

    cfg = tiny_config(compute_dtype=torch.float32, use_decode_attn=False,
                      **over)
    model = LlamaModel(cfg, device="cpu")
    return model, model.init(seed=0)


def _engine_targets(eng) -> list:
    """(contract, runner, args) of every captured round kind the engine
    can mint, each on its idle round."""
    from megatron_llm_tpu_torch.inference.engine import (
        _page_copy,
        _page_export,
        _page_import,
    )
    import torch

    w = eng.spec_decode_k + 1
    null = torch.zeros(1, dtype=torch.long)
    out = [("engine.decode_scan", eng._step_fn(1, True),
            eng._null_scan_args(1)),
           ("engine.mixed_step", eng._mixed_fn(
               eng.prefill_chunk_tokens, True),
            eng._null_mixed_args(eng.prefill_chunk_tokens)),
           ("engine.spec_verify", eng._spec_fn(w, True),
            eng._null_spec_args(w))]
    rows = []
    out += [("engine.page_copy", lambda: _page_copy(eng._pools, 0, 0), {}),
            ("engine.page_export",
             lambda: rows.append(_page_export(eng._pools, null)), {}),
            ("engine.page_import",
             lambda: _page_import(eng._pools, null, rows[-1]), {})]
    return out


def _audit_engine() -> List[TargetResult]:
    """The engine's rounds and page functions on a plain fp engine, an
    int8 one (int8 pools, int8 decode weights), a telemetry-on one and a
    cost-registry one, all at "single"; the live variants of each round
    kind against the engine's config-derived budget."""
    import tempfile

    import torch

    from megatron_llm_tpu_torch.analysis.contracts import variant_count
    from megatron_llm_tpu_torch.inference.engine import DecodeEngine

    model, params = _tiny_model()
    common = dict(slots=2, page_size=16, max_context=64, step_horizon=8,
                  prefill_chunk_tokens=16, spec_decode_k=2, vocab_size=256)
    engines = [
        ({}, DecodeEngine(model, params, **common)),
        ({"quantized": True}, DecodeEngine(model, params, kv_dtype="int8",
                                           quantize_weights=True, **common)),
        ({"telemetry": True}, DecodeEngine(
            model, params, trace_dir=tempfile.mkdtemp(prefix="graft_audit_"),
            **common)),
        ({"costs": True}, DecodeEngine(model, params, cost_registry=True,
                                       chip_spec="h100", **common)),
    ]
    results = []
    for tags, eng in engines:
        for name, runner, args in _engine_targets(eng):
            with torch.inference_mode():
                if tags.get("telemetry"):
                    with eng.tracer.span("audit_run", contract=name):
                        res, _ = audit_run(name, "single", runner, **args)
                    eng.recorder.record("audit_run", contract=name)
                else:
                    res, _ = audit_run(name, "single", runner, **args)
            res.facts.update(tags)
            if name in ("engine.decode_scan", "engine.mixed_step",
                        "engine.spec_verify"):
                _check_budget(res, variant_count(name, owner=eng),
                              eng._variant_budget(name))
                # the full bucket space fits the declaration
                _check_budget(res, 0, eng._variant_budget(name))
            if tags.get("costs"):
                res.facts["cost_records"] = eng.costs.captures
                if not eng.costs.captures:
                    res.fail("the cost-registry engine ran its rounds but "
                             "the registry counted nothing: the mint "
                             "listener or the engine's capture is broken")
            results.append(res)
    return results


def _audit_single_ops() -> List[TargetResult]:
    import numpy as np
    import torch

    from megatron_llm_tpu_torch.data.realm_index import MIPSIndex
    from megatron_llm_tpu_torch.inference.generation import generate_tokens
    from megatron_llm_tpu_torch.ops.flash_attention import flash_attention
    from megatron_llm_tpu_torch.ops.quantization import (
        quantize_decode_layers,
    )

    model, params = _tiny_model()
    out = []
    with torch.inference_mode():
        dec = model.prepare_decode_params(params)
        out.append(audit_run("ops.weight_quant", "single",
                             quantize_decode_layers, dec["layers"])[0])
        tokens = torch.zeros((1, 16), dtype=torch.long)
        out.append(audit_run(
            "generate.tokens", "single", generate_tokens, model, params,
            tokens, torch.tensor([8]), 8, top_k=1, vocab_size=256,
            termination_id=None)[0])
    q = torch.zeros((1, 32, 2, 2, 16))
    kv = torch.zeros((1, 32, 2, 16))
    out.append(audit_run("ops.flash_attention", "single", flash_attention,
                         q, kv, kv, causal=True)[0])
    index = MIPSIndex(16, device="cpu")
    rs = np.random.RandomState(0)
    index.add_rows(np.arange(40), rs.standard_normal((40, 16)))
    out.append(audit_run("realm.chunk_topk", "single",
                         index.search_mips_index,
                         rs.standard_normal((3, 16)), 5)[0])
    return out


def _train_config(num_layers: int = 2):
    """The one tiny config the train-step rows run (4 layers for the
    overlap row: its groups need a boundary to issue between)."""
    import torch

    from megatron_llm_tpu_torch.config import tiny_config

    return tiny_config(
        num_layers=num_layers, hidden_size=64, num_attention_heads=4,
        num_attention_heads_kv=4, ffn_hidden_size=128, seq_length=32,
        max_position_embeddings=32, padded_vocab_size=128,
        compute_dtype=torch.float32)


def _opt_bytes(opt_state) -> int:
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves

    return sum(x.numel() * x.element_size()
               for tree in (opt_state.m, opt_state.v) if tree is not None
               for x in tree_leaves(tree))


def _train_row(tag: str) -> dict:
    """One train-step row in this process (a rank, or "single" alone):
    the step built as the trainer builds it, run once on a seeded batch
    under the recorder. Returns the row's facts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
    from megatron_llm_tpu_torch.models import LlamaModel
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
    from megatron_llm_tpu_torch.parallel.mesh import (
        destroy_parallel,
        get_context,
        initialize_parallel,
    )
    from megatron_llm_tpu_torch.training.train_step import make_train_step
    from megatron_llm_tpu_torch.training.trainer import (
        get_batch,
        init_rank_state,
    )

    dp, tp = _mesh_shape_for_tag(tag)
    zero1, quant = "+zero1" in tag, "-quant" in tag
    overlap = "+overlap" in tag
    cfg = _train_config(4 if overlap else 2)
    model = LlamaModel(cfg, device="cpu")
    num_micro = 2 if overlap else 1
    tcfg = TrainConfig(micro_batch_size=2,
                       global_batch_size=2 * dp * num_micro, lr=1e-4)
    pcfg = ParallelConfig(num_microbatches=num_micro, data_parallel_size=dp,
                          tensor_parallel_size=tp,
                          use_distributed_optimizer=zero1,
                          quantized_grad_reduce=quant,
                          overlap_grad_reduce=overlap,
                          grad_rs_bucket_mb=0.05 if overlap else 4.0)
    if dp * tp > 1:
        initialize_parallel(dp=dp, tp=tp, device="cpu")
    try:
        ctx = get_context()
        full = model.init(seed=0)
        _, params, opt_state = init_rank_state(
            ctx if ctx is not None and ctx.world_size > 1 else None,
            cfg, full, tcfg, pcfg, "cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        record_variant("train.step", ("audit", tag))
        step = make_train_step(model, tcfg, pcfg)
        rs = np.random.RandomState(1 + (ctx.dp_rank if ctx else 0))
        text = rs.randint(0, 128, (num_micro, 2, cfg.seq_length + 1))
        batch = get_batch(text, device="cpu")
        rec = Recorder()
        registry = None
        with rec():
            if "+costs" in tag:
                from megatron_llm_tpu_torch.telemetry.costs import (
                    CostRegistry,
                )

                registry = CostRegistry()
                registry.capture("train.step", ("audit", tag), lambda: step(
                    params, opt_state, batch, 1e-4, 0.0), all_threads=True)
            elif "+telemetry" in tag:
                from megatron_llm_tpu_torch.telemetry import (
                    FlightRecorder,
                    SpanTracer,
                )

                tracer, flight = SpanTracer(enabled=True), FlightRecorder(64)
                tracer.set_context(step=0)
                with tracer.span("train-step"):
                    step(params, opt_state, batch, 1e-4, 0.0)
                flight.record("step", step=0, loss=0.0)
            else:
                _mark_backward_ends(rec, lambda: step(
                    params, opt_state, batch, 1e-4, 0.0))
        res = check_facts(TargetResult("train.step", tag), rec)
        res.facts["events"] = rec.events
        res.facts["opt_state_bytes"] = _opt_bytes(opt_state)
        if overlap:
            from megatron_llm_tpu_torch.analysis.overlap import (
                grad_overlap_report,
            )

            res.facts["overlap"] = grad_overlap_report(step).to_dict()
        if registry is not None:
            rec_ = registry.record("train.step", ("audit", tag))
            res.facts["costs"] = True
            res.facts["cost_records"] = registry.captures
            if rec_ is None or not rec_.flops:
                res.fail("+costs row: the CostRegistry counted no FLOPs "
                         "for the train step (the path the trainer's "
                         "--device_cost_registry rides is broken)")
        if "+telemetry" in tag:
            res.facts["telemetry"] = True
        return res.to_dict()
    finally:
        if dist.is_initialized() and dp * tp > 1:
            destroy_parallel()


def _mark_backward_ends(rec: Recorder, run):
    """`run()` with a "backward-end" event in `rec` after each autograd
    backward returns (the overlap schedule's reference points)."""
    import torch

    orig = torch.autograd.backward

    def backward(*a, **kw):
        out = orig(*a, **kw)
        rec.mark("backward-end")
        return out

    torch.autograd.backward = backward
    try:
        return run()
    finally:
        torch.autograd.backward = orig


def train_rows(tags) -> list:
    """A rank's rows, one tag after another (spawn_cpu_group's target)."""
    return [_train_row(tag) for tag in tags]


def _audit_train_steps(spawn: bool = True) -> List[TargetResult]:
    from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

    rows = [_train_row("single")]
    if spawn:
        for n, tags in ((2, TRAIN_TAGS_2), (4, TRAIN_TAGS_4)):
            ranks = spawn_cpu_group(n, train_rows, tags,
                                    timeout_s=RANK_TIMEOUT_S)
            for i, tag in enumerate(tags):
                row = dict(ranks[0][i])
                kinds = [r[i]["facts"]["collectives"] for r in ranks]
                if any(k != kinds[0] for k in kinds):
                    row["ok"] = False
                    row["failures"] = row["failures"] + [
                        f"ranks issued different collectives: {kinds}"]
                rows.append(row)
    out = []
    for row in rows:
        res = TargetResult(row["contract"], row["mesh"], row["ok"],
                           list(row["failures"]), dict(row["facts"]))
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# cross-checks
# ---------------------------------------------------------------------------


def _check_zero1_state_bytes(results: List[TargetResult]) -> None:
    """A rank's Adam moments under ZeRO-1 are at most 1/dp of the
    replicated ones, plus the replicated residue (10% slack), read from
    the same rows' optimizer state."""
    by_tag = {r.mesh_tag: r for r in results if r.contract == "train.step"}
    for base_tag, z_tag in (("dp2", "dp2+zero1"),
                            ("dp2tp2", "dp2tp2+zero1")):
        base, z = by_tag.get(base_tag), by_tag.get(z_tag)
        if base is None or z is None:
            continue
        dp, _ = _mesh_shape_for_tag(z_tag)
        rep, mine = base.facts["opt_state_bytes"], z.facts["opt_state_bytes"]
        expected = rep * (1 - 1.0 / dp)
        z.facts["opt_state_saving_bytes"] = rep - mine
        z.facts["opt_state_expected_saving_bytes"] = int(expected)
        if rep - mine < 0.9 * expected:
            z.fail(f"a rank's optimizer state is not ~1/dp: ZeRO-1 "
                   f"{mine} bytes against replicated {rep} saves "
                   f"{rep - mine}, expected >= {int(0.9 * expected)}")


def _check_overlap_schedule(results: List[TargetResult]) -> None:
    """Under --overlap_grad_reduce the reduce-scatters are issued inside
    the backward, between its layer groups, where the eager path issues
    them all after the backward: in the overlap row at least groups - 1
    reduce-scatters precede the last backward's end and the measured
    pairs match; in the eager row none does. The overlap plan moves the
    eager plan's gradient bytes."""
    from megatron_llm_tpu_torch.models import LlamaModel
    from megatron_llm_tpu_torch.optimizer import zero1

    by_tag = {r.mesh_tag: r for r in results if r.contract == "train.step"}
    row, eager = by_tag.get("dp2+zero1+overlap"), by_tag.get("dp2+zero1")
    if row is None:
        return
    cfg = _train_config(4)
    tmpl = LlamaModel(cfg, device="cpu").abstract_params()
    plan = zero1.build_overlap_plan(cfg, tmpl, 2, 0.05)
    eager_plan = zero1.build_zero1_plan(cfg, tmpl, 2, 0.05)
    groups = len(plan.groups)

    def before_last_backward(r):
        ev = r.facts.get("events", [])
        if "backward-end" not in ev:
            return None
        cut = len(ev) - 1 - ev[::-1].index("backward-end")
        return ev[:cut].count("reduce-scatter")

    early = before_last_backward(row)
    row.facts["overlap_plan"] = {
        "groups": groups,
        "comm_bytes": plan.comm_bytes_per_reduce(False),
        "eager_comm_bytes": eager_plan.comm_bytes_per_reduce(False)}
    row.facts["reduce_scatters_in_backward"] = early
    if plan.comm_bytes_per_reduce(False) != \
            eager_plan.comm_bytes_per_reduce(False):
        row.fail("the overlap plan changed the gradient wire bytes: "
                 f"{plan.comm_bytes_per_reduce(False)} against the eager "
                 f"plan's {eager_plan.comm_bytes_per_reduce(False)}")
    if groups < 2:
        row.fail(f"the overlap row's plan has {groups} layer group: no "
                 f"boundary to issue between")
    if early is None or early < groups - 1:
        row.fail(f"{early} reduce-scatters issued inside the backward, "
                 f"fewer than the {groups - 1} group boundaries: the "
                 f"backward-interleaved issue collapsed into a "
                 f"post-backward clump")
    pairs = row.facts.get("overlap", {}).get("async_pairs", 0)
    if pairs < groups - 1:
        row.fail(f"the measured overlap pairs {pairs} < {groups - 1}")
    if eager is not None:
        late = before_last_backward(eager)
        eager.facts["reduce_scatters_in_backward"] = late
        if late:
            eager.fail(f"the eager ZeRO-1 row issued {late} "
                       f"reduce-scatters inside the backward")


def _check_telemetry_parity(results: List[TargetResult]) -> None:
    """Telemetry-on and cost-registry-on runs issue what the plain run
    issues: the same collectives and counts, no host sync, the same
    float64 verdict and the same FLOPs."""
    base: Dict[str, TargetResult] = {}
    for r in results:
        if r.contract.startswith("engine.") and not any(
                r.facts.get(k) for k in ("telemetry", "costs", "quantized")):
            base.setdefault(r.contract, r)
    pairs = [(r, base.get(r.contract)) for r in results
             if r.contract.startswith("engine.")
             and (r.facts.get("telemetry") or r.facts.get("costs"))]
    by_tag = {r.mesh_tag: r for r in results if r.contract == "train.step"}
    for tag, r in by_tag.items():
        for suffix in ("+telemetry", "+costs"):
            if tag.endswith(suffix):
                pairs.append((r, by_tag.get(tag[:-len(suffix)])))
    for r, b in pairs:
        what = "cost-registry-on" if r.facts.get("costs") \
            else "telemetry-on"
        if b is None:
            r.fail(f"no plain twin row to hold the {what} run to")
            continue
        for fact in ("collectives", "collective_counts", "f64", "flops"):
            if r.facts.get(fact) != b.facts.get(fact):
                r.fail(f"{what} {fact} {r.facts.get(fact)} != plain "
                       f"{b.facts.get(fact)} ({b.mesh_tag}): the "
                       f"instrumentation changed what the target does")
        if r.facts.get("host_callbacks"):
            r.fail(f"{what} run read the card on the host: "
                   f"{r.facts['host_callbacks']}")


# ---------------------------------------------------------------------------
# markers and the report
# ---------------------------------------------------------------------------


def check_contract_markers(root: str) -> List[str]:
    """Every `# graft-contract: <name>` marker in the port's package must
    name a registered contract. Every module of the package that
    declares contracts is imported first, so the registered set does not
    depend on which targets ran. Returns the problems (empty: all
    consistent)."""
    import importlib

    from megatron_llm_tpu_torch.analysis.lint import _CONTRACT_MARK

    problems, marked, declaring = [], [], []
    pkg = os.path.join(root, "megatron_llm_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "analysis"))
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            p = os.path.join(dirpath, f)
            declares = False
            with open(p, "r", encoding="utf-8") as fh:
                for lineno, line in enumerate(fh, 1):
                    if "register_contract(" in line \
                            or "compile_contract(" in line:
                        declares = True
                    if _CONTRACT_MARK in line:
                        marked.append((p, lineno, line))
            if declares:
                mod = os.path.relpath(p, root)[:-len(".py")].replace(
                    os.sep, ".")
                declaring.append(mod[:-len(".__init__")]
                                 if mod.endswith(".__init__") else mod)
    for mod in declaring:
        try:
            importlib.import_module(mod)
        except Exception as e:  # noqa: BLE001: reported, not raised
            problems.append(f"{mod}: declares contracts but failed to "
                            f"import: {e!r}")
    registered = set(all_contracts())
    for p, lineno, line in marked:
        name = line.split(_CONTRACT_MARK, 1)[1].strip()
        name = name.split()[0] if name else ""
        if name not in registered:
            problems.append(f"{os.path.relpath(p, root)}:{lineno}: marker "
                            f"names unregistered contract {name!r}")
    return problems


def audit_repo(root: str, spawn: bool = True) -> dict:
    """Run every reference target, the cross-checks and the marker
    check; returns the JSON-able report. `spawn=False` leaves out the
    rows that need gloo ranks."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results: List[TargetResult] = []
        results.extend(_audit_engine())
        results.extend(_audit_train_steps(spawn))
        _check_zero1_state_bytes(results)
        _check_overlap_schedule(results)
        _check_telemetry_parity(results)
        results.extend(_audit_single_ops())
    finally:
        torch.set_num_threads(threads)
    for r in results:
        r.facts.pop("events", None)
    marker_problems = check_contract_markers(root)
    return {
        "ok": all(r.ok for r in results) and not marker_problems,
        "targets": [r.to_dict() for r in results],
        "entry_points_audited": sorted({r.contract for r in results}),
        "mesh_tags": sorted({r.mesh_tag for r in results}),
        "marker_problems": marker_problems,
        "contracts_registered": sorted(all_contracts()),
        "budgets": {name: c.max_variants
                    for name, c in sorted(all_contracts().items())},
        "note": "run at the tiny reference configs on the CPU; "
                "tmp_bytes_budget is " + TEMP_BYTES,
    }
