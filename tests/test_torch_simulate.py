"""The sim backend's other staleness modes against the JAX reference:
PipeMare weight prediction (plain and rotated optimizer state), the
no-stash two-version gradient, both modes' loss curves through the engine,
and the held-out ``eval_batches`` stream."""
import contextlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.data import batches as jbatches
from repro.data.synthetic import eval_batches as jeval_batches
from repro.engine import LoopConfig as JLoopConfig
from repro.engine import SimEngine as JSimEngine
from repro.engine import run_loop as jrun_loop
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.optim.base import make_schedule as jmake_schedule
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro.pipeline.partition import delay_tree as jdelay_tree
from repro.pipeline.simulate import make_two_version_loss as jmake_two_version_loss
from repro.pipeline.simulate import predict_weights as jpredict_weights
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import OptimizerConfig
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.data import batches, eval_batches
from repro_torch.engine import LoopConfig, SimEngine, run_loop
from repro_torch.models import loss_fn, param_leaves
from repro_torch.optim.base import make_schedule
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.partition import delay_tree
from repro_torch.pipeline.simulate import (
    make_two_version_loss,
    predict_weights,
    run_sim_training,
)

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

# the reference's own simulate-test model (tests/test_simulate.py:21)
_SHAPE = dict(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
              scan_layers=False)
JCFG = JModelConfig(attention=JAttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                    pattern=(JBlockSpec("attn", "dense"),), **_SHAPE)
TCFG = ModelConfig(attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                   pattern=(BlockSpec("attn", "dense"),), **_SHAPE)


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _orthonormal(rng, n):
    return np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# per leaf: (path, shape, delay, rotation sides); paths in leaf order
LEAVES = [("a", (6, 8), 3, "UV"), ("b", (8,), 2, ""), ("c", (5, 7), 0, "UV"),
          ("d", (4, 9), 1, "U"), ("e", (9, 4), 2, "V")]


@pytest.mark.parametrize("rotated", [False, True], ids=["adam_state", "rotated_state"])
@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "delay_wrapped"])
def test_predict_weights_matches_reference(rotated, wrapped):
    """tests/test_simulate.py:41 and :51 on the port, fed the same numpy
    inputs: plain Adam state ({m, v} trees), and basis-rotation state with
    bilateral, one-sided and unrotated leaves (m rotated into the eigenbasis,
    divided by sqrt(v), rotated back), with and without the delay wrapper
    around it; tau = 0 leaves stay put."""
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s, _, _ in LEAVES}
    m = {k: rng.randn(*s).astype(np.float32) for k, s, _, _ in LEAVES}
    v = {k: (rng.rand(*s) + 0.1).astype(np.float32) for k, s, _, _ in LEAVES}
    delays = {k: d for k, _, d, _ in LEAVES}
    if rotated:
        leaves = []
        for k, s, _, sides in LEAVES:
            st = {"m": m[k], "v": v[k]}
            if "U" in sides:
                st["U"] = _orthonormal(rng, s[0])
            if "V" in sides:
                st["V"] = _orthonormal(rng, s[1])
            leaves.append(st)
        jstate = {"leaves": [{n: jnp.asarray(x) for n, x in st.items()} for st in leaves]}
        tstate = {"leaves": [{n: _t(x) for n, x in st.items()} for st in leaves]}
    else:
        jstate = {"m": {k: jnp.asarray(x) for k, x in m.items()},
                  "v": {k: jnp.asarray(x) for k, x in v.items()}}
        tstate = {"m": {k: _t(x) for k, x in m.items()}, "v": {k: _t(x) for k, x in v.items()}}
    if wrapped:
        jstate = {"inner": jstate, "grad_q": []}
        tstate = {"inner": tstate, "grad_q": [], "head": 3}
    lr = 0.0123
    want = jpredict_weights({k: jnp.asarray(x) for k, x in params.items()}, jstate, delays, lr)
    tparams = {k: _t(x) for k, x in params.items()}
    got = predict_weights(tparams, tstate, delays, lr)
    assert list(got) == list(params)
    for k, p in got.items():
        if delays[k] == 0:
            assert torch.equal(p, tparams[k])
        assert p.dtype == torch.float32
        assert _rel(p.numpy(), want[k]) < 1e-6, k
        assert _rel(p.numpy(), params[k]) > 1e-4 or delays[k] == 0, k


def test_two_version_gradients_match_reference(ref_params):
    """tests/test_simulate.py:79 on the port: with one weight version the
    gradient is the plain one; with the stale forward version (0.9 x the
    weights) it is a different, deliberately inconsistent gradient, equal
    to the reference's leaf for leaf (activations from the stale version,
    each block linearised at the current one)."""
    batch = next(jbatches(JCFG, 2, 16, seed=0))
    jbatch = {"tokens": batch["tokens"], "labels": batch["labels"]}
    tbatch = {k: torch.from_numpy(np.array(v)).long() for k, v in jbatch.items()}
    older = jax.tree.map(lambda x: x * 0.9, ref_params)
    loss2w = jmake_two_version_loss(JCFG)
    want_mix = jax.grad(loss2w)(ref_params, older, jbatch)
    want_loss = float(loss2w(ref_params, older, jbatch))

    model = params_from_numpy(jax.tree.map(np.asarray, ref_params), TCFG, "cpu")
    params = param_leaves(model)
    stale = {k: torch.from_numpy(np.array(w)) for k, w in
             zip(params, jax.tree_util.tree_leaves(older))}
    tloss2w = make_two_version_loss(model)
    loss = tloss2w(stale, tbatch)
    got_mix = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - want_loss) < 1e-5 * abs(want_loss)
    jleaves = jax.tree_util.tree_leaves(want_mix)
    assert len(got_mix) == len(jleaves)
    for k, g, w in zip(params, got_mix, jleaves):
        assert _rel(g.numpy(), w) < 1e-5, (k, _rel(g.numpy(), w))

    same = torch.autograd.grad(tloss2w(dict(params), tbatch), list(params.values()))
    plain = torch.autograd.grad(loss_fn(model, tbatch)[0], list(params.values()))
    assert max(float((a - b).abs().max()) for a, b in zip(same, plain)) < 1e-5
    assert max(float((a - b).abs().max()) for a, b in zip(got_mix, plain)) > 1e-4
    (_, _), jplain = jax.value_and_grad(jloss_fn, has_aux=True)(ref_params, JCFG, jbatch)
    for g, w in zip(plain, jax.tree_util.tree_leaves(jplain)):
        assert _rel(g.numpy(), w) < 1e-5


MODES = {"no_stash": {"no_stash": True}, "weight_prediction": {"weight_prediction": True}}
# unilateral rotation: every gram is full rank at this size. A bilateral
# refresh's rank-deficient QR makes the reference alone move its curve by up
# to 0.15 when its weights are perturbed by 1e-7 (relative), so no two
# implementations could be held to it here.
OPTS = {"adam": ({"name": "adam", "learning_rate": 1e-3}, (1e-4, 1e-4)),
        "basis_rotation": ({"name": "basis_rotation", "rotation_freq": 3,
                            "rotation_geometry": "unilateral"}, (2e-3, 5e-2))}


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_staleness_modes_track_the_reference_engine(ref_params, mode, opt):
    """tests/test_engine.py:80 on the port, against the reference's SimEngine
    in the same mode: 4 stages (delays 3..0), 8 steps from the same weights
    on the same stream, the cosine schedule driving the prediction. Adam
    within 1e-4; basis rotation (refreshes at 0, 3, 6) within the
    reference's 2e-3 / 5e-2 for two implementations of the step. The
    no-stash window keeps max delay + 1 snapshots, copies of the weights."""
    steps, K = 8, 4
    ocfg, (first2, every) = OPTS[opt]
    kw = MODES[mode]
    jocfg = JOptimizerConfig(total_steps=steps, **ocfg)
    jeng = JSimEngine(JCFG, jbuild_optimizer(jocfg, ref_params, JCFG, num_stages=K),
                      delays_tree=jdelay_tree(ref_params, JCFG, K),
                      schedule=jmake_schedule(jocfg.schedule, jocfg.learning_rate, steps,
                                              jocfg.warmup_frac), **kw)
    _, want = jrun_loop(jeng, jbatches(JCFG, 4, 16, seed=0), JLoopConfig(steps=steps),
                        state=jeng.init_state(params=ref_params))

    model = params_from_numpy(jax.tree.map(np.asarray, ref_params), TCFG, "cpu")
    params = param_leaves(model)
    tocfg = OptimizerConfig(total_steps=steps, **ocfg)
    teng = SimEngine(model, build_optimizer(tocfg, params, TCFG, num_stages=K, use_kernels=True),
                     delays_tree=delay_tree(params, TCFG, K),
                     schedule=make_schedule(tocfg.schedule, tocfg.learning_rate, steps,
                                            tocfg.warmup_frac), **kw)
    state, got, _ = run_loop(teng, batches(TCFG, 4, 16, seed=0, device="cpu"),
                             LoopConfig(steps=steps))
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(got) == steps and max(diffs[:2]) < first2 and max(diffs) < every, (got, want)
    if mode == "no_stash":
        assert len(state.history) == K
        for k, p in state.params.items():
            assert torch.equal(state.history[-1][k], p)
            assert state.history[-1][k].data_ptr() != p.data_ptr()


def test_run_sim_training_smoke_paths(ref_params):
    """tests/test_simulate.py:96 on the port: each mode runs 10 finite steps."""
    cfg_params = jax.tree.map(np.asarray, ref_params)
    sched = make_schedule("cosine", 1e-3, 10, 0.1)
    for kw in ({}, {"weight_prediction": True, "schedule": sched}, {"no_stash": True}):
        model = params_from_numpy(cfg_params, TCFG, "cpu")
        params = param_leaves(model)
        if kw.get("weight_prediction"):
            kw = {**kw, "delays_tree": delay_tree(params, TCFG, 4)}
        opt = build_optimizer(OptimizerConfig(name="adam", learning_rate=1e-3, total_steps=10),
                              params, TCFG, num_stages=4)
        out_params, _, losses = run_sim_training(
            model, opt, batches(TCFG, 4, 16, seed=0, device="cpu"), steps=10, **kw)
        assert len(losses) == 10 and all(np.isfinite(losses))
        assert out_params == params


def test_eval_batches_equal_the_reference_bitwise():
    got = eval_batches(TCFG, 3, 16, 4, device="cpu")
    want = jeval_batches(JCFG, 3, 16, 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
