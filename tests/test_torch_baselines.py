"""The paper's baseline optimizers on the port against the JAX reference, fed
identical inputs drawn from a seed: per-step updates and states of adasgd,
nesterov, nesterov_pp, pipedream_lr, delay_compensation, muon and scion, on
per-layer and stage-stacked leaves; both delay wrappers' weight queues
(``store_params``); the factory; and the sim trainer's loss curve for every
baseline against the reference's ``run_sim_training``.

Tolerances: the elementwise optimizers within the reference's own rtol 1e-5
(tests/test_optim.py). Muon and scion orthogonalise by five quintic
Newton-Schulz steps, which multiply the smallest singular directions (and
float32 summation-order differences with them) by up to ~3.4 a step, so
they are held to 1e-4 of the largest entry (max-norm relative error).
"""
import contextlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs.catalog import get_config as jget_config
from repro.data.synthetic import batches as jbatches
from repro.models.model import init_model as jinit_model
from repro.optim.adam import adasgd as jadasgd
from repro.optim.adam import nesterov_adam as jnesterov_adam
from repro.optim import base as jbase
from repro.optim import delay_aware as jdelay_aware
from repro.optim import muon as jmuon
from repro.optim import scion as jscion
from repro.optim.base import Optimizer as JOptimizer
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro.pipeline import delay as jdelay
from repro.pipeline.simulate import run_sim_training as jrun_sim_training
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.convert import opt_state_to_numpy, params_from_numpy
from repro_torch.configs import OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.data import batches
from repro_torch.engine.spmd import opt_leaves, stack_stage_params
from repro_torch.models import Transformer, param_leaves
from repro_torch.optim.adam import adam as tadam_plain
from repro_torch.optim.adam import adasgd as tadasgd
from repro_torch.optim.adam import nesterov_adam as tnesterov_adam
from repro_torch.optim import base as tbase
from repro_torch.optim import delay_aware as tdelay_aware
from repro_torch.optim import muon as tmuon
from repro_torch.optim import scion as tscion
from repro_torch.optim.base import Optimizer
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline import delay as tdelay
from repro_torch.pipeline.partition import stage_context_for_stacked
from repro_torch.pipeline.simulate import run_sim_training

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

NAMES = ["adasgd", "nesterov", "nesterov_pp", "pipedream_lr", "delay_compensation", "muon",
         "scion"]
ELEMENTWISE = set(NAMES[:5])
DC_LAMBDA = 10.0  # large enough that the compensation term shows above roundoff


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


def _sched(mod):
    return mod.make_schedule("cosine", 1e-3, 8, 0.012)


def _pair_of(name, jdelays, tdelays):
    """(reference optimizer, port optimizer) of one baseline."""
    js, ts = _sched(jbase), _sched(tbase)
    if name == "adasgd":
        return jadasgd(js), tadasgd(ts)
    if name == "nesterov":
        return jnesterov_adam(js), tnesterov_adam(ts)
    if name == "nesterov_pp":
        return jdelay_aware.nesterov_pp(js, jdelays), tdelay_aware.nesterov_pp(ts, tdelays)
    if name == "pipedream_lr":
        return jdelay_aware.pipedream_lr(js, jdelays), tdelay_aware.pipedream_lr(ts, tdelays)
    if name == "delay_compensation":
        return (jdelay_aware.delay_compensation(js, DC_LAMBDA),
                tdelay_aware.delay_compensation(ts, DC_LAMBDA))
    if name == "muon":
        return jmuon.muon(js), tmuon.muon(ts)
    return jscion.scion(js), tscion.scion(ts)


def _assert_matches(name, got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if name in ELEMENTWISE:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10, err_msg=str(what))
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err < 1e-4, (what, err)


def _flat_pair(tree):
    """A reference tree as (jax tree, the port's {path: tensor}, treedef)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in flat]
    return (jax.tree.map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(x)) for k, (_, x) in zip(paths, flat)}, treedef)


def _sim_tree(rng):
    """Per-layer leaves: two rotated matrices (one wide, one tall, so that
    Newton-Schulz runs transposed on one), a norm vector, an embedding and
    a head (both left to Adam or the sign LMO)."""
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"blocks": ({"mixer": {"w_q": f(24, 40)}, "mlp": {"w_down": f(40, 24)},
                        "norm1": {"scale": f(24)}},),
            "embed": {"embedding": f(30, 24)}, "lm_head": {"w": f(24, 30)}}


def _stacked_tree(rng, K=2, per=3):
    """The SPMD layout: stage-stacked (K, per, ...) leaves beside shared ones."""
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"0": {"mixer": {"w_q": f(K, per, 24, 40)}, "norm1": {"scale": f(K, per, 24)}},
            "1": {"embed": {"embedding": f(30, 24)}, "lm_head": {"w": f(24, 30)}}}


def _delays(jtree, tparams, stacked_K=0):
    """Per-leaf total delays: ints, or per-stage (K, 1, ..., 1) arrays over
    stacked leaves, as each package's StageContext.delay_scales gives them."""
    jd, td = [], []
    for i, (k, p) in enumerate(tparams.items()):
        if stacked_K and k.startswith("0/"):
            taus = np.arange(stacked_K - 1, -1, -1, dtype=np.float32).reshape(
                (stacked_K,) + (1,) * (p.ndim - 1))
            jd.append(jnp.asarray(taus))
            td.append(torch.from_numpy(taus))
        else:
            jd.append(3 - i % 4)
            td.append(3 - i % 4)
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jtree), jd), td


def _run_pair(name, tree, stacked_K=0, steps=5, seed=1):
    """Both optimizers on the same gradients (and, for delay compensation,
    the same stale weights); the weights move by each package's own
    updates. Checks every update and every state leaf after every step."""
    rng = np.random.RandomState(seed)
    jp, tp, treedef = _flat_pair(tree)
    jd, td = _delays(jp, tp, stacked_K)
    jo, to = _pair_of(name, jd, td)
    js, ts = jo.init(jp), to.init(tp)
    for t in range(steps):
        g = [(rng.randn(*x.shape) * 0.1).astype(np.float32) for x in tp.values()]
        jg = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in g])
        tg = {k: torch.from_numpy(x.copy()) for k, x in zip(tp, g)}
        jaux = taux = None
        if name == "delay_compensation":
            stale = [np.asarray(x) - (rng.randn(*x.shape) * 0.1).astype(np.float32)
                     for x in jax.tree_util.tree_leaves(jp)]
            jaux = {"stale_params": jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(x) for x in stale])}
            taux = {"stale_params": {k: torch.from_numpy(x) for k, x in zip(tp, stale)}}
        # the reference's adam-family updates take no aux
        ju, js = (jo.update(jg, js, jp, jnp.int32(t)) if jaux is None
                  else jo.update(jg, js, jp, jnp.int32(t), aux=jaux))
        tu, ts = to.update(tg, ts, tp, t, aux=taux)
        for k, u in zip(tp, jax.tree_util.tree_leaves(ju)):
            _assert_matches(name, tu[k].numpy(), u, (t, "update", k))
        jleaves = jax.tree_util.tree_leaves(js)
        tleaves = ckpt.tree_leaves(opt_state_to_numpy(ts))
        assert len(jleaves) == len(tleaves)
        for i, (a, b) in enumerate(zip(tleaves, jleaves)):
            _assert_matches(name, a, b, (t, "state", i))
        jp = jbase.apply_updates(jp, ju)
        tbase.apply_updates(tp, tu)
    return ju, tu


@pytest.mark.parametrize("name", NAMES)
def test_per_step_updates_and_states_match_the_reference(name):
    """Five steps on per-layer leaves; adasgd's v is one scalar, muon keeps
    a zero v on its rotated leaves, scion keeps m alone."""
    _run_pair(name, _sim_tree(np.random.RandomState(0)))


def test_delay_compensation_moves_the_update():
    """The compensation term is engaged: with stale weights the update
    differs from Adam's on the same gradients beyond the tolerance."""
    rng = np.random.RandomState(0)
    _, tp, _ = _flat_pair(_sim_tree(rng))
    g = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) for k, p in
         tp.items()}
    stale = {k: p - 0.1 for k, p in tp.items()}
    dc = tdelay_aware.delay_compensation(_sched(tbase), DC_LAMBDA)
    plain = tadam_plain(_sched(tbase))
    u_dc, _ = dc.update(g, dc.init(tp), tp, 0, aux={"stale_params": stale})
    u_plain, _ = plain.update(g, plain.init(tp), tp, 0)
    u_none, _ = dc.update(g, dc.init(tp), tp, 0)
    for k in tp:
        assert not torch.allclose(u_dc[k], u_plain[k], rtol=1e-3)
        assert torch.equal(u_none[k], u_plain[k])


@pytest.mark.parametrize("name", ["pipedream_lr", "nesterov_pp", "muon", "scion"])
def test_stage_stacked_leaves_match_the_reference(name):
    """The SPMD layout: per-stage (K, 1, ..., 1) delay factors over stacked
    leaves (pipedream_lr's discount and nesterov_pp's horizon differ per
    stage slice), and Newton-Schulz batched over the (K, per) leading axes."""
    _run_pair(name, _stacked_tree(np.random.RandomState(2)), stacked_K=2)


@pytest.mark.parametrize("name", ["pipedream_lr", "nesterov_pp"])
def test_factors_built_from_meta_shapes_follow_the_leaves(name):
    """The SPMD engine builds its optimizer from weightless meta-device
    leaves: the per-stage factors come out on the host and are copied to
    the device of the leaves they multiply at their first use. Against the
    same optimizer built from the real leaves."""
    cfg = tget_config("paper_95m", smoke=True).replace(scan_layers=False)
    K = 2
    meta = opt_leaves(*stack_stage_params(param_leaves(Transformer(cfg, "meta", seed=None)),
                                          cfg, K))
    real = opt_leaves(*stack_stage_params(param_leaves(Transformer(cfg, "cpu", seed=0)), cfg, K))
    ocfg = OptimizerConfig(name=name, total_steps=8)
    built = []
    for leaves in (meta, real):
        st, sh = ({k[2:]: v for k, v in leaves.items() if k[0] == c} for c in "01")
        ctx = stage_context_for_stacked(st, sh, K)
        assert any(isinstance(d, torch.Tensor) and d.device.type == "cpu"
                   for d in ctx.delay_scales(leaves))
        built.append(build_optimizer(ocfg, leaves, cfg, num_stages=K, apply_delay=False,
                                     stage_context=ctx))
    g = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(3)) * 0.01
         for k, p in real.items()}
    (u_meta, _), (u_real, _) = (o.update(g, o.init(real), real, 2) for o in built)
    for k in real:
        assert torch.equal(u_meta[k], u_real[k]), k


def test_newton_schulz_matches_the_reference_and_orthogonalises():
    """Wide, tall and batched inputs; with polish steps past the quintic
    five the singular values contract to 1."""
    rng = np.random.RandomState(4)
    for shape in ((16, 40), (40, 16), (2, 3, 24, 24)):
        G = rng.randn(*shape).astype(np.float32)
        for steps in (5, 12):
            got = tmuon.newton_schulz_orthogonalize(torch.from_numpy(G), steps).numpy()
            want = np.asarray(jmuon.newton_schulz_orthogonalize(jnp.asarray(G), steps))
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-4, (shape, steps)
        s = np.linalg.svd(tmuon.newton_schulz_orthogonalize(torch.from_numpy(G), 12).numpy(),
                          compute_uv=False)
        assert np.abs(s - 1).max() < 1e-2, (shape, s)


# ---------------------------------------------------------------------------
# the delay wrappers' weight queues
# ---------------------------------------------------------------------------


def _stale_probe():
    """An optimizer whose update is the stale weights it was handed."""
    return (Optimizer(init=lambda p: {},
                      update=lambda g, s, p, t, aux=None, inplace=False: (
                          {k: v.clone() for k, v in aux["stale_params"].items()}, s)),
            JOptimizer(init=lambda p: {},
                       update=lambda g, s, p, t, aux=None: (aux["stale_params"], s)))


def _assert_rings_unroll_to(state, jstate):
    """Both ring kinds, unrolled to logical order (row r is slot (head + r)
    % d), equal the reference's queues."""
    assert sorted(k for k in state if k != "head") == sorted(jstate)
    for name in ("grad_q", "param_q"):
        assert len(state[name]) == len(jstate[name])
        for q, b in zip(state[name], jstate[name]):
            assert (q is None) == (b is None)
            if q is not None:
                got = torch.roll(q, -(state["head"] % q.shape[0]), 0)
                np.testing.assert_array_equal(got.numpy(), np.asarray(b))


def test_delayed_optimizer_queues_stale_weights_like_the_reference():
    """The per-leaf wrapper with store_params: leaf i with delay d sees
    w_{t-d}, the initial weights during warm-up (t < d), and the live
    weights at d = 0; the parameter rings unroll to the reference's queues
    after every step; the weights change in place between steps, as the
    engines change them."""
    delays = [3, 1, 0]
    probe, jprobe = _stale_probe()
    opt = tdelay.delayed_optimizer(probe, delays, store_params=True)
    jopt = jdelay.delayed_optimizer(jprobe, delays, store_params=True)
    params = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(2)}
    state, jstate = None, None
    for t in range(7):
        with torch.no_grad():
            for i, p in enumerate(params.values()):
                p.fill_(10.0 * t + i)  # w_t, written in place
        jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
        if t == 0:  # the rings warm-start with w_0
            state, jstate = opt.init(params), jopt.init(jparams)
        grads = {k: torch.full(v.shape, -1.0) for k, v in params.items()}
        upd, state = opt.update(grads, state, params, t)
        ju, jstate = jopt.update({k: jnp.asarray(v.numpy()) for k, v in grads.items()},
                                 jstate, jparams, jnp.int32(t))
        for i, (k, d) in enumerate(zip(params, delays)):
            seen = 10.0 * (t - d) + i if t >= d else float(i)  # warm-up: w_0 = i
            assert torch.equal(upd[k], torch.full(params[k].shape, seen)), (t, k)
            np.testing.assert_array_equal(upd[k].numpy(), np.asarray(ju[k]))
        assert sorted(jstate) == ["grad_q", "inner", "param_q"]
        _assert_rings_unroll_to(state, jstate)


def test_stage_delayed_optimizer_reads_each_stages_own_stale_weights():
    """The stage wrapper with store_params: stage k of a stacked leaf sees
    its own slice of w_{t-tau_k} (tau_k = K-1-k; the initial weights during
    warm-up), the last stage the live weights; shared leaves with an int
    delay as in the per-leaf wrapper. Equal to the reference's diagonal
    read, and its queues, at every step."""
    K, n = 4, 3
    probe, jprobe = _stale_probe()
    specs = ["stage", K - 1, 0]
    opt = tdelay.stage_delayed_optimizer(probe, specs, K, store_params=True)
    jopt = jdelay.stage_delayed_optimizer(jprobe, specs, K, store_params=True)
    params = {"0/w": torch.zeros(K, n), "1/embed": torch.zeros(n), "1/lm_head": torch.zeros(n)}
    jp = lambda: (jnp.asarray(params["0/w"].numpy()),  # noqa: E731
                  {"embed": jnp.asarray(params["1/embed"].numpy()),
                   "lm_head": jnp.asarray(params["1/lm_head"].numpy())})
    for t in range(8):
        with torch.no_grad():
            for k in range(K):
                params["0/w"][k].fill_(100.0 * t + k)
            params["1/embed"].fill_(100.0 * t - 1)
            params["1/lm_head"].fill_(100.0 * t - 2)
        if t == 0:  # the rings warm-start with w_0
            state, jstate = opt.init(params), jopt.init(jp())
        grads = {k: torch.ones_like(v) for k, v in params.items()}
        upd, state = opt.update(grads, state, params, t)
        (jw, jsh), jstate = jopt.update(
            (jnp.ones((K, n)), {"embed": jnp.ones(n), "lm_head": jnp.ones(n)}),
            jstate, jp(), jnp.int32(t))
        for k in range(K):
            tau = K - 1 - k
            want = 100.0 * (t - tau) + k if t >= tau else float(k)  # warm-up: w_0
            assert torch.equal(upd["0/w"][k], torch.full((n,), want)), (t, k)
        emb = 100.0 * (t - (K - 1)) - 1 if t >= K - 1 else -1.0
        assert torch.equal(upd["1/embed"], torch.full((n,), emb)), t
        assert torch.equal(upd["1/lm_head"], params["1/lm_head"]), t
        np.testing.assert_array_equal(upd["0/w"].numpy(), np.asarray(jw))
        np.testing.assert_array_equal(upd["1/embed"].numpy(), np.asarray(jsh["embed"]))
        np.testing.assert_array_equal(upd["1/lm_head"].numpy(), np.asarray(jsh["lm_head"]))
        _assert_rings_unroll_to(state, jstate)
    # under a deferred data reduction of E steps, stage k reads w_{t-(tau_k+E)}
    # (the last stage too), as the reference's deeper weight queues give
    E = 1
    opt = tdelay.stage_delayed_optimizer(probe, specs, K, store_params=True,
                                         extra_param_delay=E)
    jopt = jdelay.stage_delayed_optimizer(jprobe, specs, K, store_params=True,
                                          extra_param_delay=E)
    for t in range(8):
        with torch.no_grad():
            for k in range(K):
                params["0/w"][k].fill_(100.0 * t + k)
            params["1/embed"].fill_(100.0 * t - 1)
            params["1/lm_head"].fill_(100.0 * t - 2)
        if t == 0:
            state, jstate = opt.init(params), jopt.init(jp())
        grads = {k: torch.ones_like(v) for k, v in params.items()}
        upd, state = opt.update(grads, state, params, t)
        (jw, jsh), jstate = jopt.update(
            (jnp.ones((K, n)), {"embed": jnp.ones(n), "lm_head": jnp.ones(n)}),
            jstate, jp(), jnp.int32(t))
        for k in range(K):
            tau = K - 1 - k + E
            want = 100.0 * (t - tau) + k if t >= tau else float(k)
            assert torch.equal(upd["0/w"][k], torch.full((n,), want)), (t, k)
        np.testing.assert_array_equal(upd["0/w"].numpy(), np.asarray(jw))
        np.testing.assert_array_equal(upd["1/embed"].numpy(), np.asarray(jsh["embed"]))
        np.testing.assert_array_equal(upd["1/lm_head"].numpy(), np.asarray(jsh["lm_head"]))
        _assert_rings_unroll_to(state, jstate)


def test_factory_builds_every_reference_name_with_its_state_layout():
    """Every name of the reference's factory, with the reference's state
    layout (the same leaves in the same order); the sim wrapper queues the
    stale weights for delay compensation only. (An unknown name's
    ValueError: tests/test_torch_optim.py.)"""
    cj = jget_config("paper_95m", smoke=True).replace(scan_layers=False)
    ct = tget_config("paper_95m", smoke=True).replace(scan_layers=False)
    jparams = jinit_model(jax.random.PRNGKey(0), cj)
    params = param_leaves(params_from_numpy(jax.tree.map(np.asarray, jparams), ct, "cpu"))
    for name in ["adam", "adamw", "pipedream", "basis_rotation"] + NAMES:
        state = build_optimizer(OptimizerConfig(name=name), params, ct, num_stages=2).init(params)
        jstate = jbuild_optimizer(JOptimizerConfig(name=name), jparams, cj,
                                  num_stages=2).init(jparams)
        mine = opt_state_to_numpy(state)
        assert ("param_q" in state) == (name == "delay_compensation"), name
        assert sorted(mine) == sorted(jstate), name
        a, b = ckpt.tree_leaves(mine), jax.tree_util.tree_leaves(jstate)
        assert [x.shape for x in a] == [np.shape(x) for x in b], name


# ---------------------------------------------------------------------------
# the sim trainer, end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_sim_trainer_tracks_the_reference_for_every_baseline(name):
    """The smoke paper_95m model, 2 stages, 6 steps from shared weights on
    the same stream, through each package's run_sim_training: the
    elementwise baselines within 1e-4 (float32 roundoff, as Adam), muon and
    scion within 1e-4 on the first two losses and 1e-3 on all."""
    steps, K, B, S = 6, 2, 4, 32
    cj = jget_config("paper_95m", smoke=True).replace(scan_layers=False)
    ct = tget_config("paper_95m", smoke=True).replace(scan_layers=False)
    jparams = jinit_model(jax.random.PRNGKey(0), cj)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), ct, "cpu")
    jopt = jbuild_optimizer(JOptimizerConfig(name=name, total_steps=steps), jparams, cj,
                            num_stages=K)
    _, _, want = jrun_sim_training(cj, jopt, jbatches(cj, B, S, seed=0), steps, params=jparams)
    topt = build_optimizer(OptimizerConfig(name=name, total_steps=steps), param_leaves(model),
                           ct, num_stages=K)
    _, _, got = run_sim_training(model, topt, batches(ct, B, S, seed=0, device="cpu"), steps)
    diffs = [abs(a - b) for a, b in zip(got, want)]
    first2, every = (1e-4, 1e-4) if name in ELEMENTWISE else (1e-4, 1e-3)
    assert len(got) == steps and max(diffs[:2]) < first2 and max(diffs) < every, (got, want)
    assert got[-1] != got[0]
