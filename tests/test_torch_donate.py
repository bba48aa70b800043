"""The port of the reference's donated step: optimizer state updated in its
own tensors.

The reference jits ``SpmdEngine``'s step with ``donate_argnums=(0, 1, 2)``
behind ``donate="auto"`` (``repro/engine/spmd.py``, pinned by
``tests/test_donation.py``). The port asks each optimizer for it with
``update(..., inplace=True)``: the sim engine always, ``SpmdEngine`` when
``donate`` holds. The in-place and copying updates must agree bitwise
(losses, parameters and every state tensor), the in-place one must keep
every tensor's storage across steps (refresh steps included), and the
copying SPMD step must leave the state it was given as it was.

The file imports neither JAX nor the reference package, so its ``cuda``
case runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_donate.py
"""
from itertools import islice

import contextlib
import numpy as np
import pytest
import torch

from repro_torch.analysis import state_leaves
from repro_torch.configs import OptimizerConfig, get_config
from repro_torch.core.basis_rotation import basis_rotation_adam
from repro_torch.data import batches
from repro_torch.engine import SimEngine, SpmdEngine
from repro_torch.kernels import adam_step, ops
from repro_torch.models import init_model, param_leaves
from repro_torch.models.model import loss_fn
from repro_torch.optim.base import apply_updates, clip_by_global_norm, make_schedule
from repro_torch.optim.factory import build_optimizer

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

# the reference factory's optimizer names (repro/optim/factory.py)
OPTIMIZERS = ("adam", "adamw", "pipedream", "adasgd", "nesterov", "nesterov_pp",
              "pipedream_lr", "delay_compensation", "muon", "scion", "basis_rotation")
K, B, S = 2, 4, 32
STEPS = 4  # basis rotation refreshes at steps 0 and 2 (rotation_freq 2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Bitwise comparisons on the CPU need one intra-op thread: with more,
    torch's reductions may split differently from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # numpy's BLAS pool too: its idle threads spin on the cores the others need
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _ocfg(name):
    return OptimizerConfig(name=name, total_steps=STEPS, rotation_freq=2,
                           weight_decay=0.01 if name == "adamw" else 0.0)


def _batches(cfg, device):
    return list(islice(batches(cfg, B, S, seed=0, device=device), STEPS))


def _storage(tree):
    return {k: x.data_ptr() for k, x in state_leaves(tree).items()}


def _assert_trees_equal(got, want):
    got, want = state_leaves(got), state_leaves(want)
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _copying_sim_run(cfg, ocfg, device):
    """The sim step with the optimizer's functional update: new gradients
    from clipping, a new state every step (the reference's sim step)."""
    model = init_model(cfg, seed=0, device=device)
    params = param_leaves(model)
    opt = build_optimizer(ocfg, params, cfg, num_stages=K, use_kernels=True)
    state, losses = opt.init(params), []
    for t, batch in enumerate(_batches(cfg, device)):
        loss, _ = loss_fn(model, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads = clip_by_global_norm(grads, 1.0)
        with torch.no_grad():
            updates, state = opt.update(grads, state, params, t)
            apply_updates(params, updates)
        losses.append(loss.item())
    return losses, params, state


def _in_place_sim_run(cfg, ocfg, device):
    """``SimEngine``, which updates the optimizer state in place; checks
    after every step that the state is the same object and that every
    parameter and state tensor kept its storage."""
    model = init_model(cfg, seed=0, device=device)
    params = param_leaves(model)
    engine = SimEngine(model, build_optimizer(ocfg, params, cfg, num_stages=K,
                                              use_kernels=True), grad_clip=1.0)
    state, losses = engine.init_state(), []
    where = _storage((state.params, state.opt_state))
    for t, batch in enumerate(_batches(cfg, device)):
        opt_state = state.opt_state
        state, loss, _ = engine.step(state, batch, t)
        assert state.opt_state is opt_state
        assert _storage((state.params, state.opt_state)) == where, t
        losses.append(loss.item())
    return losses, state.params, state.opt_state


def _check_sim(name, device):
    cfg = get_config("paper_95m", smoke=True).replace(scan_layers=False)
    want_losses, want_params, want_state = _copying_sim_run(cfg, _ocfg(name), device)
    losses, params, state = _in_place_sim_run(cfg, _ocfg(name), device)
    assert losses == want_losses
    _assert_trees_equal(params, want_params)
    _assert_trees_equal(state, want_state)


def _spmd_run(cfg, ocfg, donate, device):
    """``SpmdEngine`` under the 1F1B schedule. Donating: every parameter and
    state tensor keeps its storage. Copying: the state handed to each step
    is left as it was."""
    engine = SpmdEngine(cfg, ocfg, K, schedule="1f1b", use_kernels=True, device=device,
                        seed=0, donate=donate)
    assert engine.donate is donate
    state, losses = engine.init_state(), []
    where = _storage((state.params, state.opt_state))
    for t, batch in enumerate(_batches(cfg, device)):
        before = {k: x.clone() for k, x in state_leaves((state.params, state.opt_state)).items()}
        head = state.opt_state["head"]
        new, loss, _ = engine.step(state, batch, t)
        if donate:
            assert new.opt_state is state.opt_state
            assert _storage((new.params, new.opt_state)) == where, t
        else:
            _assert_trees_equal((state.params, state.opt_state), before)
            assert state.opt_state["head"] == head
        state = new
        losses.append(loss.item())
    return losses, state


def _check_spmd(name, device):
    cfg = get_config("paper_95m", smoke=True).replace(scan_layers=False)
    want_losses, want = _spmd_run(cfg, _ocfg(name), False, device)
    losses, got = _spmd_run(cfg, _ocfg(name), True, device)
    assert losses == want_losses
    _assert_trees_equal((got.params, got.opt_state), (want.params, want.opt_state))
    assert got.opt_state["head"] == want.opt_state["head"] == STEPS


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_sim_in_place_step_is_bitwise_the_copying_step_and_keeps_storage(name):
    """The sim engine's in-place step against the functional update of the
    same optimizer, delay FIFO included, over 4 steps with 2 refreshes."""
    _check_sim(name, "cpu")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_spmd_donated_step_is_bitwise_the_copying_step_and_keeps_storage(name):
    """``SpmdEngine(donate=True)`` against ``donate=False`` from the same
    seed and batches; ``donate=False`` leaves each step's input state,
    parameters included, untouched."""
    _check_spmd(name, "cpu")


@pytest.mark.parametrize("device,want", [("cpu", False), ("cuda", True)])
def test_donate_auto_resolves_per_device(device, want):
    """tests/test_donation.py::test_donate_auto_resolves_per_platform on the
    port: ``"auto"`` donates on a CUDA device and not on the CPU, and an
    explicit value wins. Building the engine touches no device."""
    cfg = get_config("paper_95m", smoke=True).replace(scan_layers=False)
    ocfg = OptimizerConfig(name="adam")
    assert SpmdEngine(cfg, ocfg, K, device=device).donate is want
    for donate in (True, False):
        assert SpmdEngine(cfg, ocfg, K, device=device, donate=donate).donate is donate


STACKED = {"a/mlp/w_up": (4, 2, 16, 40), "a/mixer/w_q": (4, 2, 24, 24),
           "a/norm1/scale": (4, 2, 16), "embed/embedding": (30, 16), "w_o": (20, 12)}
TUPLE_FREQS = [(1, 2, 3, 4), (2, 3, 2, 1), 3, 3, 2]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("source", ["2nd", "1st"])
@pytest.mark.parametrize("geometry", ["bilateral", "unilateral"])
def test_per_stage_refresh_in_place_is_bitwise_the_copying_one(use_kernels, source, geometry):
    """Basis rotation with per-stage periods over a stacked leaf's stage
    axis, so that some steps refresh only some stages (the branch that
    writes the refreshed rows into U, V, L, R): in place and copying agree
    bitwise over 7 steps, and in place every state tensor keeps its
    storage."""
    rng = np.random.RandomState(3)
    params = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in STACKED.items()}
    opt = basis_rotation_adam(make_schedule("cosine", 1e-3, 8, 0.012), source=source,
                              geometry=geometry, freq=TUPLE_FREQS, weight_decay=0.01,
                              use_kernels=use_kernels)
    got, want = opt.init(params), opt.init(params)
    where = _storage(got)
    for t in range(7):
        grads = {k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
                 for k, s in STACKED.items()}
        before = {k: x.clone() for k, x in state_leaves(want).items()}
        wu, new_want = opt.update(grads, want, params, t)
        _assert_trees_equal(want, before)  # the copying update leaves its input alone
        want = new_want
        gu, new_got = opt.update(grads, got, params, t, inplace=True)
        assert new_got is got and _storage(got) == where, t
        _assert_trees_equal(gu, wu)
        _assert_trees_equal(got, want)


def test_adam_scale_grouped_in_place_writes_v_prime_over_v():
    """B5's in-place entry (the kernel's ``v_out`` is ``v``) on the CPU: its
    plain version with ``out=v`` gives bitwise the copying entry's step and
    v', in v's own tensors. The grouped wrapper refuses in place on a v
    that is not contiguous float32, where v' would land in a copy."""
    rng = np.random.RandomState(0)
    shapes = [(24, 40), (3, 8, 8), (5,)]
    gs, ms, vs = ([torch.from_numpy(rng.randn(*s).astype(np.float32) * 1e-3) for s in shapes]
                  for _ in range(3))
    vs = [v.abs() for v in vs]
    scalars = (0.999, 1e-8, 1 - 0.9 ** 3, 1 - 0.999 ** 3)
    want_steps, want_vs = adam_step.adam_scale_grouped(gs, ms, vs, *scalars)
    mine = [v.clone() for v in vs]
    steps, v_news = ops.adam_scale_grouped(gs, ms, mine, *scalars, inplace=True)
    assert all(a is b for a, b in zip(v_news, mine))
    for s, w, v, wv in zip(steps, want_steps, mine, want_vs):
        assert torch.equal(s, w) and torch.equal(v, wv)
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.adam_scale_grouped(gs[:1], ms[:1], [vs[0].t()], *scalars, inplace=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["sim", "spmd"])
@pytest.mark.parametrize("name", ["adam", "delay_compensation", "basis_rotation"])
def test_in_place_step_is_bitwise_the_copying_step_on_card(cuda, backend, name):
    """The same equalities on the card, where the rotation products and the
    rotated Adam step run in B4 and B5 (B5 through its in-place entry on
    the in-place side) and the SPMD path's attention in B1-B3."""
    (_check_sim if backend == "sim" else _check_spmd)(name, cuda)
