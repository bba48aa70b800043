"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``): the named checks on hand-built steps,
one test for each case of ``tests/test_analysis.py``; the lint's findings
on the same sources; the seeded mutations of the real 1F1B schedule, each
flipping exactly its own check, with the reference's verdicts on the same
tiny config beside them; and the matrix runner's Adam column."""
import ast
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import lint as jlint
from repro_torch.analysis import (
    CheckResult,
    DtypePolicy,
    check_dtype_policy,
    check_no_dot_outside_cond,
    check_scan_body_constant_in_microbatches,
    check_stash_bound,
    iter_eqns,
    leading_dims_of,
    n_eqns,
    record_step,
    vocab_dot_counts,
)
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import runner
from repro_torch.engine import schedules

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; these
    small shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the checks on small hand-built steps: a tick loop that marks its scopes
# as the schedules do (engine/schedules.py's TICK_HOOK)
# ---------------------------------------------------------------------------


def _tick(t, k, K=2, phase="forward"):
    schedules.TICK_HOOK(t, k, K, phase)


def _end(K=2):
    schedules.TICK_HOOK(None, None, K, None)


def _scanned_head(vocab, gated):
    """A stand-in for a tick body over 2 stages: a vocab-sized matmul on the
    last stage only (gated) or on every stage."""

    def f(xs):
        w = torch.ones(4, vocab)
        total = torch.zeros(())
        for t in range(xs.shape[0]):
            for k in range(2):
                _tick(t, k)
                total = total + xs[t].sum()  # every stage's own work
                if not gated or k == 1:
                    total = total + (xs[t] @ w).sum()
        _end()
        return total

    return f


def test_iter_eqns_sees_tick_scopes_and_the_last_stage():
    _, rec = record_step(_scanned_head(17, gated=True), torch.ones(3, 2, 4))
    scopes = {s for _op, s in iter_eqns(rec) if s is not None}
    assert any(s.stage is not None for s in scopes)
    assert any(s.last for s in scopes) and any(not s.last for s in scopes)
    # the walker sees every operation, some inside and some outside the ticks
    assert n_eqns(rec) > sum(1 for _op, s in iter_eqns(rec) if s is not None) > 0


def test_vocab_dot_counts_distinguishes_gating():
    _, gated = record_step(_scanned_head(17, True), torch.ones(3, 2, 4))
    _, ungated = record_step(_scanned_head(17, False), torch.ones(3, 2, 4))
    counts = vocab_dot_counts(gated, 17)
    assert counts["outside_cond"] == 0 and counts["inside_cond"] == 3
    assert vocab_dot_counts(ungated, 17)["outside_cond"] >= 1
    assert check_no_dot_outside_cond(gated, 17).passed
    assert not check_no_dot_outside_cond(ungated, 17).passed
    # require_gated: a step with no vocab matmul at all must fail, not pass
    _, empty = record_step(lambda x: x * 2, torch.ones(3))
    assert not check_no_dot_outside_cond(empty, 17, require_gated=True).passed
    assert check_no_dot_outside_cond(empty, 17, require_gated=False).passed


def _ticks_of(m, grow):
    """M ticks of the same body; ``grow`` also keeps an (M, 4, 4) buffer."""

    def f(x):
        held = torch.cat([x] * m) * 2.0 if grow else None
        c = torch.zeros(())
        for t in range(m):
            _tick(t, 0, K=1)
            c = c + x.sum()
        _end(K=1)
        return c, held

    _, rec = record_step(f, torch.ones(4, 4), held=(), track_memory=True)
    return rec


def test_scan_body_constant_check_and_growth_mode():
    const = {m: _ticks_of(m, grow=False) for m in (2, 8)}
    assert check_scan_body_constant_in_microbatches(const).passed
    grow = {m: _ticks_of(m, grow=True) for m in (2, 8)}
    assert not check_scan_body_constant_in_microbatches(grow).passed
    assert check_scan_body_constant_in_microbatches(grow, expect_const_bytes=False).passed
    # growth mode is non-vacuous: a constant buffer fails it
    assert not check_scan_body_constant_in_microbatches(const, expect_const_bytes=False).passed


def test_stash_bound_on_hand_built_buffers():
    K, act = 3, (2, 8, 4)  # bound 5

    def prog(slots):
        return record_step(lambda: torch.ones((slots,) + act) * 2.0)[1]

    ok = prog(2 * K - 1)
    assert check_stash_bound(ok, K, act).passed
    assert set(leading_dims_of(ok, act)) == {2 * K - 1}
    assert not check_stash_bound(prog(2 * K + 2), K, act).passed
    # a step with no stash at all is measuring the wrong thing: fail
    assert not check_stash_bound(record_step(lambda x: x + 1, torch.ones(4))[1], K, act).passed


def test_dtype_policy_passes_f32_and_flags_injected_f64_leaf():
    _, clean = record_step(lambda x: (x * 2).sum(), torch.ones(4))
    assert check_dtype_policy(clean.float_dtypes).passed
    _, leaky = record_step(
        lambda x: (x.to(torch.float64) * 2).float().sum(), torch.ones(4))
    res = check_dtype_policy(leaky.float_dtypes)
    assert not res.passed and "float64" in res.detail
    # ONLY the dtype check flips: the same step passes the structural check
    assert check_no_dot_outside_cond(leaky, 17, require_gated=False).passed


def test_dtype_policy_state_dtype_gate():
    pol = DtypePolicy(allowed_float=("float32", "bfloat16"), state_dtype="float32")
    state = {"w": torch.ones(4, dtype=torch.bfloat16)}
    _, rec = record_step(lambda x: x.sum(), state["w"])
    res = check_dtype_policy(rec.float_dtypes, state, pol)
    assert not res.passed and "state dtype" in res.detail
    # intermediates may be bf16 under the same policy
    _, mixed = record_step(lambda x: (x.to(torch.bfloat16) * 2).float().sum(), torch.ones(4))
    assert check_dtype_policy(mixed.float_dtypes, {"w": torch.ones(4)}, pol).passed


# ---------------------------------------------------------------------------
# AST lint: the reference's rules, the same findings
# ---------------------------------------------------------------------------


def _reference_test_sources():
    """The source snippets of the reference's lint test
    (``tests/test_analysis.py``), read from its string constants."""
    tree = ast.parse(open(os.path.join(ROOT, "tests", "test_analysis.py")).read())
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and "\ndef " in n.value]


def _findings(lint_source, src, path="<string>"):
    return sorted((f.rule, f.line) for f in lint_source(src, path))


def test_lint_flags_each_rule_and_respects_waivers_as_the_reference_does():
    sources = _reference_test_sources()
    assert len(sources) >= 4  # the three lint snippets and the mutation script
    rules = set()
    for src in sources:
        got, want = _findings(tlint.lint_source, src), _findings(jlint.lint_source, src)
        assert got == want, (src[:200], got, want)
        rules |= {r for r, _ in got}
    assert rules == {tlint.RULE_F64, tlint.RULE_SCAN_NP, tlint.RULE_SCAN_IF}
    assert (tlint.RULE_F64, tlint.RULE_SCAN_NP, tlint.RULE_SCAN_IF) == \
        (jlint.RULE_F64, jlint.RULE_SCAN_NP, jlint.RULE_SCAN_IF)


def test_lint_gives_the_reference_findings_on_every_reference_source_file():
    """Every file of ``src/repro`` through both packages' ``lint_source``:
    the (rule, line) findings are equal."""
    seen = 0
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "src", "repro")):
        for fname in sorted(files):
            if fname.endswith(".py"):
                src = open(os.path.join(dirpath, fname)).read()
                assert _findings(tlint.lint_source, src) == _findings(jlint.lint_source, src), fname
                seen += 1
    assert seen > 50


def test_repo_lint_clean():
    res = tlint.check_repo_lint()
    assert res.passed, res.detail
    assert tlint.repo_root().endswith(os.path.join("src", "repro_torch"))


# ---------------------------------------------------------------------------
# seeded mutations of the REAL 1F1B schedule, beside the reference's
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
sys.path.insert(0, "src")
import json
import jax, jax.numpy as jnp
from repro.configs.base import ModelConfig, AttentionConfig, BlockSpec
from repro.engine.spmd import stack_stage_params
import repro.engine.schedules as schedules
from repro.launch.topology import Topology
from repro.models import init_model
from repro.analysis import check_no_dot_outside_cond, check_stash_bound

cfg = ModelConfig(num_layers=2, d_model=16, d_ff=24, vocab_size=96, max_seq_len=32,
                  attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=8),
                  pattern=(BlockSpec("attn","dense"),), scan_layers=False)
K, M, S, V = 2, 2, 8, 96
mesh = Topology(stages=K, data=1).make_mesh()
shapes = jax.eval_shape(lambda k: init_model(k, cfg), jax.random.PRNGKey(0))
stacked_s, shared_s = jax.eval_shape(lambda p: stack_stage_params(p, cfg, K), shapes)

def run_checks():
    gf = schedules.make_schedule_grad(cfg, mesh, K, M, schedule="1f1b")
    tok = jax.ShapeDtypeStruct((M, 1, S), jnp.int32)
    jx = jax.make_jaxpr(gf)(stacked_s, shared_s, {"tokens": tok, "labels": tok})
    return {"vocab": check_no_dot_outside_cond(jx, V, require_gated=True).to_json(),
            "stash": check_stash_bound(jx, K, (1, S, cfg.d_model)).to_json()}

res = {"baseline": run_checks()}
orig_cond = jax.lax.cond
jax.lax.cond = lambda pred, tf, ff, *ops: tf(*ops)
try:
    res["ungated"] = run_checks()
finally:
    jax.lax.cond = orig_cond
orig_slots = schedules.stash_slots
schedules.stash_slots = lambda k: 2 * k + 3
try:
    res["wide_stash"] = run_checks()
finally:
    schedules.stash_slots = orig_slots
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference_verdicts():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def _mutation(name):
    """The port's counterparts of the reference's seeded mutations."""
    if name == "ungated":  # the vocab head on every stage
        inner, schedules.seeds_from_head = schedules.seeds_from_head, lambda k, K: True
        try:
            yield
        finally:
            schedules.seeds_from_head = inner
    elif name == "wide_stash":  # the input stash past its 2K-1 slots
        inner, schedules.stash_slots = schedules.stash_slots, lambda k: 2 * k + 3
        try:
            yield
        finally:
            schedules.stash_slots = inner
    elif name == "f64_leaf":  # a float64 leaf in the last stage's loss
        inner = schedules.cross_entropy
        schedules.cross_entropy = lambda logits, labels: inner(
            logits.to(torch.float64), labels).float()
        try:
            yield
        finally:
            schedules.cross_entropy = inner
    else:
        yield


def _port_checks(name):
    """The 1F1B gradient of the runner's tiny config, recorded on the CPU
    under one mutation, and its three checks."""
    from repro_torch.engine.spmd import stack_stage_params
    from repro_torch.models.model import Transformer, param_leaves

    cfg, K, M, S = runner._tiny_model_cfg(), 2, 2, 8
    stacked, shared = stack_stage_params(param_leaves(Transformer(cfg, device="cpu", seed=0)),
                                         cfg, K)
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (M, 1, S)))
    with _mutation(name):
        gf = schedules.make_schedule_grad(cfg, K, M, "1f1b")
        with torch.no_grad():
            stacked = {k: v.detach() for k, v in stacked.items()}
            shared = {k: v.detach() for k, v in shared.items()}
        _, rec = record_step(gf, stacked, shared, {"tokens": tok, "labels": tok})
    return {"vocab": check_no_dot_outside_cond(rec, cfg.vocab_size, require_gated=True),
            "stash": check_stash_bound(rec, K, (1, S, cfg.d_model)),
            "dtype": check_dtype_policy(rec.float_dtypes, {**stacked, **shared})}


def test_seeded_mutations_flip_exactly_their_check():
    flips = {"baseline": set(), "ungated": {"vocab"}, "wide_stash": {"stash"},
             "f64_leaf": {"dtype"}}
    for name, want in flips.items():
        res = _port_checks(name)
        assert all(isinstance(r, CheckResult) for r in res.values())
        failed = {k for k, r in res.items() if not r.passed}
        assert failed == want, (name, {k: r.to_json() for k, r in res.items()})
    assert _port_checks("ungated")["vocab"].data["outside_cond"] >= 1
    assert 2 * 2 + 3 in _port_checks("wide_stash")["stash"].data["slot_counts"]
    assert "float64" in _port_checks("f64_leaf")["dtype"].detail


@pytest.mark.parametrize("name", ["baseline", "ungated", "wide_stash"])
def test_vocab_and_stash_verdicts_and_bound_equal_the_reference(reference_verdicts, name):
    ref, port = reference_verdicts[name], _port_checks(name)
    assert port["vocab"].passed == ref["vocab"]["passed"], (port["vocab"], ref["vocab"])
    assert port["stash"].passed == ref["stash"]["passed"], (port["stash"], ref["stash"])
    assert port["stash"].data["bound"] == ref["stash"]["data"]["bound"]
    # the widest stacked buffer is the stash in both (the reference's jaxpr
    # also holds per-device (1, ...) slices of its stage-sharded buffers)
    assert max(port["stash"].data["slot_counts"]) == max(ref["stash"]["data"]["slot_counts"])


# ---------------------------------------------------------------------------
# the matrix runner end to end (one-process checks, one optimizer column)
# ---------------------------------------------------------------------------


def test_runner_smoke_matrix_adam_column(tmp_path, capsys):
    out_path = str(tmp_path / "report.json")
    rc = runner.main(["--matrix", "smoke", "--optimizers", "adam", "--no-hlo",
                      "--device", "cpu", "--out", out_path])
    assert rc == 0, capsys.readouterr().out[-3000:]
    report = json.loads(open(out_path).read())
    assert report["passed"], report
    # 2 schedules x 2 sync modes x 1 optimizer x 2 topologies
    assert len(report["cells"]) == 8, [c["checks"] for c in report["cells"]]
    assert len(report["scaling"]) == 4
    assert len(report["precision"]) == 6 and len(report["data_async"]) == 8
    assert report["lint"]["passed"], report["lint"]
    for cell in report["cells"]:
        names = {c["name"] for c in cell["checks"]}
        assert "dtype_policy" in names and "no_dot_outside_cond" in names
        assert "collective_axes" not in names  # --no-hlo: no ranks
        if cell["schedule"] == "1f1b":
            assert "stash_bound" in names
    kern = [c for c in report["precision"] if c["use_kernels"]]
    assert all("kernel_in_scan" in {c["name"] for c in p["checks"]} for p in kern)


def test_runner_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner.main(["--optimizers", "adam", "--no-hlo"])
