"""The port's SPMD pipeline (stage-stacked layout, fill-drain and 1F1B tick
schedules, per-stage delay FIFO) against the JAX reference: the stacked
layout and its metadata, the delay FIFO, the schedules' gradients and
memory, and the engine's loss curves against the reference's ``SpmdEngine``
on four forced host devices (run in a subprocess, as the reference's own
tests run it)."""
import contextlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.engine.spmd import stack_stage_params as jstack
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.optim.base import Optimizer as JOptimizer
from repro.pipeline.delay import stage_delayed_optimizer as jstage_delayed_optimizer
from repro.pipeline.partition import stage_context_for_stacked as jctx_for_stacked
from repro_torch.checkpoint.convert import (
    params_from_numpy,
    stacked_from_numpy,
    stacked_to_numpy,
)
from repro_torch.configs import OptimizerConfig
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.data import batches
from repro_torch.engine import LoopConfig, SimEngine, SpmdEngine, run_loop
from repro_torch.engine.schedules import (
    SCHEDULE_INVARIANTS,
    ScheduleStats,
    make_schedule_grad,
    schedule_activation_bytes,
)
from repro_torch.engine.spmd import stack_stage_params, unstack_stage_params
from repro_torch.launch import train
from repro_torch.models import Transformer, param_leaves
from repro_torch.optim.base import Optimizer
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.delay import delayed_optimizer, stage_delayed_optimizer
from repro_torch.pipeline.partition import stage_context_for_stacked

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's own engine-test model (tests/test_engine.py:32)
_SHAPE = dict(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
              scan_layers=False)
JCFG = JModelConfig(attention=JAttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                    pattern=(JBlockSpec("attn", "dense"),), **_SHAPE)
TCFG = ModelConfig(attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                   pattern=(BlockSpec("attn", "dense"),), **_SHAPE)
K, M, STEPS = 4, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; torch's
    intra-op threads then fight the other workers for the cores, and these
    small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # numpy's BLAS pool too: its idle threads spin on the cores the others need
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    return jinit_model(jax.random.PRNGKey(0), JCFG)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked_pair(ref_params, stages=K):
    return stacked_from_numpy(_np_tree(jstack(ref_params, JCFG, stages)), "cpu")


def test_stacking_and_numpy_carry_over_match_the_reference_exactly(ref_params):
    jtree = _np_tree(jstack(ref_params, JCFG, K))
    stacked, shared = stacked_from_numpy(jtree, "cpu")
    # the carry-over round-trips exactly
    back = stacked_to_numpy(stacked, shared)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)] == \
        [tuple(x.shape) for x in list(stacked.values()) + list(shared.values())]
    # the port's own stacking of the per-layer model gives the same tensors
    model = params_from_numpy(_np_tree(ref_params), TCFG, "cpu")
    s2, h2 = stack_stage_params(param_leaves(model), TCFG, K)
    assert list(s2) == list(stacked) and list(h2) == list(shared)
    for k in stacked:
        assert torch.equal(s2[k], stacked[k]), k
    # and unstacking gives the per-layer model back, in leaf order
    flat = unstack_stage_params(stacked, shared)
    leaves = param_leaves(model)
    assert list(flat) == list(leaves)
    for k, p in leaves.items():
        assert torch.equal(flat[k], p.detach()), k


@pytest.mark.parametrize("stages,layers", [(4, 8), (8, 32)])
def test_stacked_stage_context_matches_the_reference(stages, layers):
    """Leaf order decides which tensor gets which delay and refresh period:
    delays, repeats, FIFO specs, stage-aware refresh periods (both
    allocations) and delay scales, element for element."""
    jcfg, tcfg = JCFG.replace(num_layers=layers), TCFG.replace(num_layers=layers)
    shapes = jax.eval_shape(lambda k: jinit_model(k, jcfg), jax.random.PRNGKey(0))
    jst, jsh = jax.eval_shape(lambda p: jstack(p, jcfg, stages), shapes)
    want = jctx_for_stacked(jst, jsh, stages)
    st, sh = stack_stage_params(param_leaves(Transformer(tcfg, "meta", seed=None)), tcfg, stages)
    got = stage_context_for_stacked(st, sh, stages)
    assert got.delays == want.delays and got.repeats == want.repeats
    assert got.delay_specs() == want.delay_specs()
    for reversed_allocation in (False, True):
        assert got.refresh_freqs(10, reversed_allocation) == \
            want.refresh_freqs(10, reversed_allocation)
    flat = {k: torch.zeros(1).expand(v.shape) for k, v in {**st, **sh}.items()}
    jscales = jax.tree_util.tree_leaves(want.delay_scales((jst, jsh)))
    for a, b in zip(got.delay_scales(flat), jscales):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_stage_delayed_optimizer_gives_exact_pipedream_delays():
    """tests/test_engine.py:101 on the port: stage k applies the gradient
    of exactly tau_k = K-1-k steps ago (zeros before), the same as per-slice
    FIFOs and as the reference's diagonal read."""
    n = 3
    # the FIFOs reuse a popped slot once the inner update returns: copy out
    identity = Optimizer(init=lambda p: {},
                         update=lambda g, s, p, t, inplace=False: (
                             {k: v.clone() for k, v in g.items()}, s))
    jidentity = JOptimizer(init=lambda p: {}, update=lambda g, s, p, t, aux=None: (g, s))
    params = {"0/w": torch.zeros(K, n), "1/embed": torch.zeros(n), "1/lm_head": torch.zeros(n)}
    specs = ["stage", K - 1, 0]
    opt = stage_delayed_optimizer(identity, specs, K)
    state = opt.init(params)
    per_slice = delayed_optimizer(identity, [K - 1 - k for k in range(K)] + [K - 1, 0])
    ps_params = {**{f"s{k}": torch.zeros(n) for k in range(K)},
                 "embed": torch.zeros(n), "lm_head": torch.zeros(n)}
    ps_state = per_slice.init(ps_params)
    jopt = jstage_delayed_optimizer(jidentity, specs, K)
    jp = (jnp.zeros((K, n)), {"embed": jnp.zeros(n), "lm_head": jnp.zeros(n)})
    jstate = jopt.init(jp)
    for t in range(8):
        g = torch.stack([torch.full((n,), 100.0 * t + k) for k in range(K)])
        ge, gh = torch.full((n,), 100.0 * t - 1), torch.full((n,), 100.0 * t - 2)
        upd, state = opt.update({"0/w": g, "1/embed": ge, "1/lm_head": gh}, state, params, t)
        ps_upd, ps_state = per_slice.update(
            {**{f"s{k}": g[k] for k in range(K)}, "embed": ge, "lm_head": gh},
            ps_state, ps_params, t)
        (ju, jsh), jstate = jopt.update(
            (jnp.asarray(g.numpy()), {"embed": jnp.asarray(ge.numpy()),
                                     "lm_head": jnp.asarray(gh.numpy())}),
            jstate, jp, jnp.int32(t))
        for k in range(K):
            tau = K - 1 - k
            want = 100.0 * (t - tau) + k if t >= tau else 0.0
            assert torch.equal(upd["0/w"][k], torch.full((n,), want)), (t, k)
            assert torch.equal(upd["0/w"][k], ps_upd[f"s{k}"])
        np.testing.assert_array_equal(upd["0/w"].numpy(), np.asarray(ju))
        np.testing.assert_array_equal(upd["1/embed"].numpy(), np.asarray(jsh["embed"]))
        np.testing.assert_array_equal(upd["1/lm_head"].numpy(), np.asarray(jsh["lm_head"]))
    # a deferred data reduction deepens only the weight queues: the gradient
    # delays stay the pipeline's while each weight ring is E slots deeper
    E = 2
    reads_aux = Optimizer(init=lambda p: {},
                          update=lambda g, s, p, t, aux=None, inplace=False: (
                              {k: v.clone() for k, v in g.items()}, s))
    deeper = stage_delayed_optimizer(reads_aux, specs, K, store_params=True,
                                     extra_param_delay=E)
    plain = stage_delayed_optimizer(reads_aux, specs, K, store_params=True)
    ds, ps = deeper.init(params), plain.init(params)
    assert [q is None for q in ds["grad_q"]] == [q is None for q in ps["grad_q"]]
    for dq, pq in zip(ds["grad_q"], ps["grad_q"]):
        assert dq is None or dq.shape == pq.shape
    for dq, pq, s in zip(ds["param_q"], ps["param_q"], specs):
        depth = K - 1 if s == "stage" else s
        assert dq.shape[0] == depth + E and (pq is None if depth == 0
                                             else pq.shape[0] == depth)
    for t in range(8):
        g = {"0/w": torch.full((K, n), 1.0 + t), "1/embed": torch.full((n,), 2.0 + t),
             "1/lm_head": torch.full((n,), 3.0 + t)}
        du, ds = deeper.update(g, ds, params, t)
        pu, ps = plain.update(g, ps, params, t)
        for k in g:
            assert torch.equal(du[k], pu[k]), (t, k)


def _batch(seed=0, mb=2, S=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, JCFG.vocab_size, size=(M * mb, S + 1))
    return toks[:, :-1], toks[:, 1:]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_schedule_gradients_match_value_and_grad(ref_params, schedule, use_kernels):
    """The synchronous pipeline gradient of either schedule, unstacked, is
    jax.value_and_grad of the reference's whole-model loss."""
    tok, lab = _batch()
    (jloss, _), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        ref_params, JCFG, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    stacked, shared = _stacked_pair(ref_params)
    cfg = TCFG.replace(use_kernels=use_kernels)
    grad_fn = make_schedule_grad(cfg, K, M, schedule)
    batch = {"tokens": torch.from_numpy(tok).long().reshape(M, -1, tok.shape[1]),
             "labels": torch.from_numpy(lab).long().reshape(M, -1, lab.shape[1])}
    loss, (gs, gsh) = grad_fn(stacked, shared, batch)
    assert abs(float(loss) - float(jloss)) < 1e-5 * abs(float(jloss))
    got = unstack_stage_params(gs, gsh)
    want = {k: v for k, v in zip(got, jax.tree_util.tree_leaves(jgrads))}
    assert len(want) == len(jax.tree_util.tree_leaves(jgrads))
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _rel(got[k].numpy(), want[k]) < 1e-5, (k, _rel(got[k].numpy(), want[k]))


def test_1f1b_stash_is_bounded_and_constant_in_microbatches(ref_params):
    """SCHEDULE_INVARIANTS in torch terms: 1F1B's stash has 2K - 1 slots,
    the activations a stage keeps across ticks are the same at M = 4 and
    M = 8 (and what schedule_activation_bytes says), and autograd keeps
    nothing across ticks; fill-drain's grow with M."""
    stacked, shared = _stacked_pair(ref_params)
    seen = {}
    for schedule in ("fill_drain", "1f1b"):
        for m in (4, 8):
            stats = ScheduleStats()
            rng = np.random.RandomState(m)
            toks = torch.from_numpy(rng.randint(0, 64, size=(m, 1, 17))).long()
            batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
            make_schedule_grad(TCFG, K, m, schedule, stats)(stacked, shared, batch)
            assert stats.held_bytes == schedule_activation_bytes(TCFG, K, m, 1, 16, schedule)
            seen[schedule, m] = stats
    for m in (4, 8):
        assert seen["1f1b", m].stash_slots == 2 * K - 1
        assert max(seen["1f1b", m].saved_bytes) == 0
    assert SCHEDULE_INVARIANTS["1f1b"]["const_float_bytes_in_M"]
    assert seen["1f1b", 4].held_bytes == seen["1f1b", 8].held_bytes
    assert not SCHEDULE_INVARIANTS["fill_drain"]["const_float_bytes_in_M"]
    assert seen["fill_drain", 8].held_bytes > seen["fill_drain", 4].held_bytes
    assert max(seen["fill_drain", 8].saved_bytes) > max(seen["fill_drain", 4].saved_bytes) > 0


REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
import jax, json
from repro.configs.base import ModelConfig, AttentionConfig, BlockSpec, OptimizerConfig
from repro.data import batches
from repro.engine import LoopConfig, SpmdEngine, run_loop
from repro.launch.mesh import make_mesh_compat
from repro.models import init_model

cfg = ModelConfig(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
                  attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                  pattern=(BlockSpec("attn","dense"),), scan_layers=False)
K, M, steps = 4, 4, int(sys.argv[1])
params = init_model(jax.random.PRNGKey(0), cfg)
mesh = make_mesh_compat((K, 1), ("stage", "data"))
res = {}
for name, ocfg, kw in json.loads(sys.argv[2]):
    eng = SpmdEngine(cfg, OptimizerConfig(total_steps=steps, **ocfg), num_stages=K,
                     num_microbatches=M, mesh=mesh, **kw)
    _, res[name] = run_loop(eng, batches(cfg, M * 2, 16, seed=0), LoopConfig(steps=steps),
                            state=eng.init_state(params=params))
print(json.dumps(res))
"""

ADAM = {"name": "adam", "learning_rate": 1e-3, "schedule": "constant"}
ROTATION = {"name": "basis_rotation", "learning_rate": 3e-3, "rotation_freq": 5,
            "stage_aware": True, "schedule": "constant"}
RUNS = [
    ("async_fill_drain_adam", ADAM, {"schedule": "fill_drain"}),
    ("async_1f1b_adam", ADAM, {"schedule": "1f1b"}),
    ("sync_1f1b_rotation_kernels", ROTATION,
     {"schedule": "1f1b", "async_grads": False, "use_kernels": True}),
]


def _port_curve(ref_params, ocfg, **kw):
    eng = SpmdEngine(TCFG, OptimizerConfig(total_steps=STEPS, **ocfg), num_stages=K,
                     num_microbatches=M, device="cpu", **kw)
    state = eng.init_state(_stacked_pair(ref_params))
    _, losses, _ = run_loop(eng, batches(TCFG, M * 2, 16, seed=0, device="cpu"),
                            LoopConfig(steps=STEPS), state=state)
    return losses


def test_spmd_engine_tracks_the_reference_engine(ref_params):
    """The slice as a whole: the port's SpmdEngine against the reference's on
    four host devices, from the same weights on the same stream. Adam within
    1e-4; basis rotation (QR refreshes) within the reference's own 2e-3 on
    the first two losses and 5e-2 on all (tests/test_engine.py:437-438).
    Then the reference's own checks on the port (tests/test_engine.py:
    335-358): sync SPMD equals the one-stage simulation, async fill-drain
    equals async 1F1B, and staleness moves the curve."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # the reference compiles in its own process while the port runs here
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, str(STEPS), json.dumps(RUNS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    try:
        got = {name: _port_curve(ref_params, ocfg, **kw) for name, ocfg, kw in RUNS}
        sync_fd = _port_curve(ref_params, ADAM, schedule="fill_drain", async_grads=False)
        sync_1f1b = _port_curve(ref_params, ADAM, schedule="1f1b", async_grads=False)
        model = params_from_numpy(_np_tree(ref_params), TCFG, "cpu")
        sim = SimEngine(model, build_optimizer(OptimizerConfig(total_steps=STEPS, **ADAM),
                                               param_leaves(model), TCFG, num_stages=1))
        _, sim_losses, _ = run_loop(sim, batches(TCFG, M * 2, 16, seed=0, device="cpu"),
                                    LoopConfig(steps=STEPS))
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for name, ocfg, _ in RUNS:
        diffs = [abs(a - b) for a, b in zip(got[name], want[name])]
        assert len(diffs) == STEPS, (name, got[name], want[name])
        first2, every = (1e-4, 1e-4) if ocfg is ADAM else (2e-3, 5e-2)
        assert max(diffs[:2]) < first2 and max(diffs) < every, (name, got[name], want[name])

    def maxdiff(a, b):
        return max(abs(x - y) for x, y in zip(a, b))

    assert maxdiff(sim_losses, sync_fd) < 2e-3 and maxdiff(sim_losses, sync_1f1b) < 2e-3
    assert maxdiff(got["async_fill_drain_adam"], got["async_1f1b_adam"]) < 2e-3
    assert maxdiff(sync_1f1b, got["async_1f1b_adam"]) > 1e-4


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b"])
def test_train_main_spmd_backend_on_cpu(monkeypatch, schedule):
    """The launcher's spmd path at smoke size, with the kernels' plain
    versions: every kernel wrapper is handed contiguous float32 tensors, and
    is called as often per step as the launch counts on the card expect
    (B1 M*L for fill-drain, 2*M*L for 1F1B; B2, B3 M*L; B4 four grouped
    products holding six products per rotated leaf kind, B5 one grouped call
    holding every kind, each batched over the stacked layers)."""
    from repro_torch.kernels import adam_step, flash, ops

    calls = {}

    def check(name, tensors):
        for x in tensors:
            if isinstance(x, torch.Tensor):
                assert x.dtype == torch.float32 and x.is_contiguous(), name

    def strict(name, fn):
        def wrapped(*tensors, **kw):
            check(name, tensors)
            calls[name] = calls.get(name, 0) + 1
            return fn(*tensors, **kw)
        return wrapped

    def strict_grouped(fn):
        def wrapped(As, Bs, **kw):
            check("matmul_grouped", (*As, *Bs))
            calls["matmul_grouped"] = calls.get("matmul_grouped", 0) + 1
            calls["products"] = calls.get("products", 0) + len(As)
            return fn(As, Bs, **kw)
        return wrapped

    def strict_adam(fn):
        def wrapped(gs, ms, vs, *scalars, **kw):
            check("adam_scale_grouped", (*gs, *ms, *vs))
            calls["adam_scale_grouped"] = calls.get("adam_scale_grouped", 0) + 1
            calls.setdefault("adam_leaves", []).append(len(gs))
            return fn(gs, ms, vs, *scalars, **kw)
        return wrapped

    for mod, name in ((flash, "flash_fwd"), (flash, "flash_bwd_dq"), (flash, "flash_bwd_dkv")):
        monkeypatch.setattr(mod, name, strict(name, getattr(mod, name)))
    monkeypatch.setattr(ops, "matmul_grouped", strict_grouped(ops.matmul_grouped))
    monkeypatch.setattr(adam_step, "adam_scale_grouped",
                        strict_adam(adam_step.adam_scale_grouped))
    steps, stages, layers = 3, 2, 2
    res = train.main(["--smoke", "--backend", "spmd", "--schedule", schedule, "--stages",
                      str(stages), "--steps", str(steps), "--batch", "4", "--seq", "16",
                      "--use-kernels", "--log-every", "0", "--device", "cpu"])
    assert len(res["losses"]) == steps and all(np.isfinite(res["losses"]))
    ml = stages * layers  # M = K microbatches by default
    assert calls == {"flash_fwd": (2 if schedule == "1f1b" else 1) * ml * steps,
                     "flash_bwd_dq": ml * steps, "flash_bwd_dkv": ml * steps,
                     "matmul_grouped": 4 * steps, "products": 6 * 6 * steps,
                     "adam_scale_grouped": steps, "adam_leaves": [6] * steps}
