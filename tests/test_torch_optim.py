"""The port's optimizer stack against the JAX reference, fed identical
gradient sequences: basis-rotation Adam (kernel and plain paths), Adam,
the delay FIFO, schedules, the rotation layout and the stage partition.

Where basis rotation can be held tightly and where it cannot: a refresh
takes QR of (gram @ basis). When the gram is well conditioned, Q is unique
(signs fixed by diag(R) >= 0) and both packages agree to float32 roundoff.
The bilateral rotation of a non-square matrix always has one rank-deficient
gram (G^T G of a 16x64 gradient has rank 16 and size 64); the Q columns
past the rank are fixed by roundoff alone, differ between LAPACK builds,
and Adam's normalisation turns the near-zero rotated entries there into
O(1) steps. That part is compared on the subspace the data determines;
whole trajectories are compared at the reference's own QR-chaos tolerance
in ``test_torch_sim.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.catalog import get_config as jget_config
from repro.core import basis_rotation as jbr
from repro.core import layout as jlayout
from repro.core import rotation as jrot
from repro.models.model import init_model as jinit_model
from repro.optim.adam import adam as jadam
from repro.optim import base as jbase
from repro.pipeline import delay as jdelay
from repro.pipeline import partition as jpart
from repro_torch.configs import OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.core import basis_rotation as tbr
from repro_torch.core import layout as tlayout
from repro_torch.core import rotation as trot
from repro_torch.models import Transformer, param_leaves
from repro_torch.optim.adam import adam as tadam
from repro_torch.optim import base as tbase
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline import delay as tdelay
from repro_torch.pipeline import partition as tpart


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; torch's
    intra-op threads then fight the other workers for the cores, and these
    small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _well_conditioned(rng, shape, scale=0.1):
    """A gradient whose singular values lie in [1, 2] * scale."""
    m, n = shape
    r = min(m, n)
    A = np.linalg.qr(rng.randn(m, r))[0]
    B = np.linalg.qr(rng.randn(n, r))[0]
    return (scale * (A * rng.uniform(1, 2, r)) @ B.T).astype(np.float32)


class Pair:
    """One parameter tree, as the reference's nested dict and as the port's
    ordered {path: tensor} dict."""

    def __init__(self, tree):
        self.tree = tree
        flat, self.treedef = jax.tree_util.tree_flatten_with_path(tree)
        self.paths = [jlayout.path_str(p) for p, _ in flat]
        self.jax = jax.tree.map(jnp.asarray, tree)
        self.torch = {k: torch.from_numpy(x.copy()) for k, (_, x) in zip(self.paths, flat)}

    def grads(self, leaves):
        return (jax.tree_util.tree_unflatten(self.treedef, [jnp.asarray(g) for g in leaves]),
                {k: torch.from_numpy(g.copy()) for k, g in zip(self.paths, leaves)})


def _tree(rng, w_shapes):
    return {
        "blocks": ({"mixer": {"w_q": rng.randn(*w_shapes[0]).astype(np.float32)},
                    "mlp": {"w_up": rng.randn(*w_shapes[1]).astype(np.float32)},
                    "norm1": {"scale": rng.randn(16).astype(np.float32)}},),
        "embed": {"embedding": rng.randn(30, 16).astype(np.float32)},
    }


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _run(geometry, use_kernels, w_shapes, steps, seed=0):
    """Feed both optimizers the same gradients; yield per-step results."""
    rng = np.random.RandomState(seed)
    pair = Pair(_tree(rng, w_shapes))
    kw = dict(freq=3, geometry=geometry, use_kernels=use_kernels)
    jo = jbr.basis_rotation_adam(jbase.make_schedule("cosine", 1e-3, 8, 0.012), **kw)
    to = tbr.basis_rotation_adam(tbase.make_schedule("cosine", 1e-3, 8, 0.012), **kw)
    js, ts = jo.init(pair.jax), to.init(pair.torch)
    for t in range(steps):
        leaves = [_well_conditioned(rng, x.shape) if x.ndim == 2 else
                  (rng.randn(*x.shape) * 0.1).astype(np.float32)
                  for x in jax.tree_util.tree_leaves(pair.tree)]
        gj, gt = pair.grads(leaves)
        ju, js = jo.update(gj, js, pair.jax, jnp.int32(t))
        tu, ts = to.update(gt, ts, pair.torch, t)
        yield t, pair, leaves, jax.tree_util.tree_leaves(ju), tu, js, ts


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bilateral_rotation_tracks_reference_on_well_conditioned_grams(use_kernels):
    """Square leaves, two refreshes (steps 0 and 3): every update and every
    state entry within 1e-5 of the reference, normwise."""
    for t, pair, _, ju, tu, js, ts in _run("bilateral", use_kernels, [(24, 24), (32, 32)], 7):
        for k, uj in zip(pair.paths, ju):
            assert _rel(tu[k].numpy(), np.asarray(uj)) < 1e-5, (t, k)
        for sj, st in zip(js["leaves"], ts["leaves"]):
            assert set(sj) == set(st)
            for name in sj:
                assert _rel(st[name].numpy(), np.asarray(sj[name])) < 1e-5, (t, name)
                # every state tensor is a kernel operand on the card, and the
                # kernels take contiguous operands only
                assert st[name].is_contiguous(), (t, name)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_unilateral_rotation_tracks_reference_on_non_square_leaves(use_kernels):
    """Unilateral rotation takes the smaller side's gram, full rank here."""
    for t, pair, _, ju, tu, _, _ in _run("unilateral", use_kernels, [(16, 40), (64, 16)], 7):
        for k, uj in zip(pair.paths, ju):
            assert _rel(tu[k].numpy(), np.asarray(uj)) < 1e-5, (t, k)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bilateral_rank_deficient_side_agrees_on_the_determined_subspace(use_kernels):
    """16x64 leaf, through the first refresh period: U (full-rank gram) and
    the first 16 columns of V agree; the update agrees once projected on the
    first gradient's row space, where the rotated entries are data, not
    roundoff."""
    for t, pair, leaves, ju, tu, js, ts in _run("bilateral", use_kernels, [(24, 24), (16, 64)], 3):
        i = pair.paths.index("blocks/0/mlp/w_up")
        if t == 0:
            Vt = np.linalg.svd(leaves[i], full_matrices=False)[2]
            P = Vt.T @ Vt
        sj, st = js["leaves"][i], ts["leaves"][i]
        assert _rel(st["U"].numpy(), np.asarray(sj["U"])) < 1e-5
        assert np.abs(st["V"].numpy()[:, :16] - np.asarray(sj["V"])[:, :16]).max() < 5e-4
        uj, ut = np.asarray(ju[i]), tu["blocks/0/mlp/w_up"].numpy()
        assert _rel(ut @ P, uj @ P) < 2e-4, t


def _per_leaf_kernel_update(schedule, freqs, geometry, weight_decay, grads, state, params,
                            step, beta1=0.9, beta2=0.999, eps=1e-8, source="2nd"):
    """The kernel branch rotating each leaf with launches of its own, leaf by
    leaf: the order the grouped branch must reproduce exactly."""
    from repro_torch.kernels import ops as kops

    layout = tlayout.build_layout(params, geometry)
    lr = schedule(step)
    bc1, bc2 = tbase.bias_correction(beta1, step), tbase.bias_correction(beta2, step)
    new_leaves, updates = [], {}
    for (k, g), st, plan, f in zip(grads.items(), state["leaves"], layout, freqs):
        g = g.float()
        m = beta1 * st["m"] + (1 - beta1) * g
        nst = dict(st)
        nst["m"] = m
        if plan.rotate:
            U, V, L, R = tbr._refresh_ops(
                g, m, (st.get("U"), st.get("V"), st.get("L"), st.get("R")),
                f, step, source, beta2)
            g_rot = kops.two_sided_rotate(g, U, V, transpose=True)
            m_rot = kops.two_sided_rotate(m, U, V, transpose=True)
            step_rot, v = kops.adam_scale(g_rot, m_rot, st["v"], beta2, eps, bc1, bc2)
            upd = -lr * kops.two_sided_rotate(step_rot, U, V, transpose=False)
            for name, val in (("U", U), ("V", V), ("L", L), ("R", R)):
                if val is not None:
                    nst[name] = val
        else:
            v = beta2 * st["v"] + (1 - beta2) * torch.square(g)
            upd = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        nst["v"] = v
        updates[k] = upd
        new_leaves.append(nst)
    if weight_decay:
        for k, p in params.items():
            if p.ndim >= 2:
                updates[k] = updates[k] - lr * weight_decay * p.detach().float()
    return updates, {"leaves": new_leaves}


# stage-stacked (K=2, 3 layers) leaves beside plain ones; per-leaf refresh
# periods: a tuple per stage for the stacked rotated leaves
STACKED = {"a/mlp/w_up": (2, 3, 16, 40), "a/mixer/w_q": (2, 3, 24, 24),
           "a/norm1/scale": (2, 3, 16), "embed/embedding": (30, 16), "w_o": (20, 12)}
TUPLE_FREQS = [(1, 4), (2, 3), 3, 3, 2]


@pytest.mark.parametrize("geometry", ["bilateral", "unilateral"])
@pytest.mark.parametrize("freq,weight_decay", [(3, 0.0), (TUPLE_FREQS, 0.01)])
def test_grouped_kernel_branch_is_bitwise_the_per_leaf_branch(geometry, freq, weight_decay):
    """Seven steps across several refreshes (all stages at once with an int
    period; stages on their own periods with tuples): the kernel branch,
    which rotates every leaf in four grouped products, gives bitwise the
    updates and state of rotating leaf by leaf, in the same leaf order."""
    rng = np.random.RandomState(10)
    params = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in STACKED.items()}
    schedule = tbase.make_schedule("cosine", 1e-3, 8, 0.012)
    opt = tbr.basis_rotation_adam(schedule, freq=freq, geometry=geometry,
                                  weight_decay=weight_decay, use_kernels=True)
    freqs = [freq] * len(params) if isinstance(freq, int) else freq
    got = want = opt.init(params)
    for t in range(7):
        grads = {k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
                 for k, s in STACKED.items()}
        gu, got = opt.update(grads, got, params, t)
        wu, want = _per_leaf_kernel_update(schedule, freqs, geometry, weight_decay, grads,
                                           want, params, t)
        assert list(gu) == list(wu) == list(params)
        for k in params:
            assert torch.equal(gu[k], wu[k]), (t, k)
        for sg, sw in zip(got["leaves"], want["leaves"]):
            assert list(sg) == list(sw)
            for name in sg:
                assert torch.equal(sg[name], sw[name]), (t, name)


def test_grouped_kernel_branch_tracks_reference_at_smoke_config():
    """The paper_95m smoke model's leaves (2 layers, every rotated leaf
    non-square), unilateral so every gram is full rank: the kernel branch
    against the reference's kernel path through two refreshes. Every state
    entry within 1e-5 at every step, normwise, and every update from step 1
    on. At step 0, v = (1 - b2) g~^2, so each rotated step entry is
    g~ / |g~|, a sign, which the few entries with |g~| at roundoff level flip
    between any two implementations (1e-3 normwise, also with the port's
    plain branch)."""
    cfg = jget_config("paper_95m", smoke=True).replace(scan_layers=False)
    pair = Pair(jax.tree.map(np.asarray, jinit_model(jax.random.PRNGKey(0), cfg)))
    rng = np.random.RandomState(11)
    kw = dict(freq=3, geometry="unilateral", use_kernels=True)
    jo = jbr.basis_rotation_adam(jbase.make_schedule("cosine", 1e-3, 8, 0.012), **kw)
    to = tbr.basis_rotation_adam(tbase.make_schedule("cosine", 1e-3, 8, 0.012), **kw)
    j_update = jax.jit(jo.update)  # traces the interpret-mode kernels once, not per call
    js, ts = jo.init(pair.jax), to.init(pair.torch)
    for t in range(4):
        leaves = [_well_conditioned(rng, x.shape) if x.ndim == 2 else
                  (rng.randn(*x.shape) * 0.1).astype(np.float32)
                  for x in jax.tree_util.tree_leaves(pair.tree)]
        gj, gt = pair.grads(leaves)
        ju, js = j_update(gj, js, pair.jax, jnp.int32(t))
        tu, ts = to.update(gt, ts, pair.torch, t)
        for sj, st in zip(js["leaves"], ts["leaves"]):
            assert set(sj) == set(st)
            for name in sj:
                assert _rel(st[name].numpy(), np.asarray(sj[name])) < 1e-5, (t, name)
        if t:
            for k, uj in zip(pair.paths, jax.tree_util.tree_leaves(ju)):
                assert _rel(tu[k].numpy(), np.asarray(uj)) < 1e-5, (t, k)


def test_adam_matches_reference_to_float32_rounding():
    rng = np.random.RandomState(3)
    pair = Pair(_tree(rng, [(8, 8), (8, 12)]))
    jo = jadam(jbase.make_schedule("cosine", 1e-3, 20, 0.1), weight_decay=0.01)
    to = tadam(tbase.make_schedule("cosine", 1e-3, 20, 0.1), weight_decay=0.01)
    js, ts = jo.init(pair.jax), to.init(pair.torch)
    for t in range(5):
        gj, gt = pair.grads([rng.randn(*x.shape).astype(np.float32)
                             for x in jax.tree_util.tree_leaves(pair.tree)])
        ju, js = jo.update(gj, js, pair.jax, jnp.int32(t))
        tu, ts = to.update(gt, ts, pair.torch, t)
        for k, uj in zip(pair.paths, jax.tree_util.tree_leaves(ju)):
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(uj), rtol=1e-6, atol=1e-12)


def test_delay_fifo_pops_the_reference_sequence():
    """An inner optimizer that returns its gradients shows exactly what the
    FIFO hands on: zeros while it fills, then the gradient from tau steps
    ago, leaf by leaf."""
    rng = np.random.RandomState(4)
    pair = Pair(_tree(rng, [(4, 4), (4, 6)]))
    delays = [3, 0, 2, 1]

    def ident(make_copy):
        return lambda params: None, lambda g, s, p, t, aux=None: (make_copy(g), s)

    jo = jdelay.delayed_optimizer(jbase.Optimizer(*ident(lambda g: g)), delays)
    to = tdelay.delayed_optimizer(
        tbase.Optimizer(*ident(lambda g: {k: v.clone() for k, v in g.items()})), delays)
    js, ts = jo.init(pair.jax), to.init(pair.torch)
    for t in range(7):
        gj, gt = pair.grads([rng.randn(*x.shape).astype(np.float32)
                             for x in jax.tree_util.tree_leaves(pair.tree)])
        ju, js = jo.update(gj, js, pair.jax, t)
        tu, ts = to.update(gt, ts, pair.torch, t)
        for k, uj in zip(pair.paths, jax.tree_util.tree_leaves(ju)):
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(uj))


def test_delayed_adam_matches_reference():
    rng = np.random.RandomState(5)
    pair = Pair(_tree(rng, [(8, 8), (8, 12)]))
    delays = [2, 0, 1, 3]
    jo = jdelay.delayed_optimizer(jadam(jbase.constant_schedule(1e-3)), delays)
    to = tdelay.delayed_optimizer(tadam(tbase.constant_schedule(1e-3)), delays)
    js, ts = jo.init(pair.jax), to.init(pair.torch)
    for t in range(6):
        gj, gt = pair.grads([rng.randn(*x.shape).astype(np.float32)
                             for x in jax.tree_util.tree_leaves(pair.tree)])
        ju, js = jo.update(gj, js, pair.jax, jnp.int32(t))
        tu, ts = to.update(gt, ts, pair.torch, t)
        for k, uj in zip(pair.paths, jax.tree_util.tree_leaves(ju)):
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(uj), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name,lr,total,warm", [("cosine", 1e-3, 300, 0.012),
                                                ("cosine", 3e-4, 12, 0.012),
                                                ("constant", 1e-3, 10, 0.0)])
def test_schedules_and_bias_corrections_match_reference(name, lr, total, warm):
    js, ts = jbase.make_schedule(name, lr, total, warm), tbase.make_schedule(name, lr, total, warm)
    for step in [0, 1, 2, 3, 5, 8, 11, 12, 150, 299, 400]:
        s = jnp.int32(step)
        np.testing.assert_allclose(ts(step), float(js(s)), rtol=1e-6)
        for beta in (0.9, 0.999):
            np.testing.assert_allclose(tbase.bias_correction(beta, step),
                                       float(jbase.bias_correction(beta, s)), rtol=1e-6)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.RandomState(6)
    pair = Pair(_tree(rng, [(8, 8), (8, 12)]))
    for max_norm in (0.5, 1e6):
        want = jax.tree_util.tree_leaves(jbase.clip_by_global_norm(pair.jax, max_norm))
        got = tbase.clip_by_global_norm(pair.torch, max_norm)
        for k, w in zip(pair.paths, want):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-6)


def test_power_qr_matches_reference():
    rng = np.random.RandomState(7)
    G = np.stack([_well_conditioned(rng, (20, 20), 1.0) for _ in range(3)])
    A = G @ np.swapaxes(G, -1, -2)
    Q = np.linalg.qr(rng.randn(3, 20, 20))[0].astype(np.float32)
    got = trot.power_qr(torch.from_numpy(A), torch.from_numpy(Q)).numpy()
    want = np.asarray(jrot.power_qr(jnp.asarray(A), jnp.asarray(Q)))
    assert _rel(got, want) < 1e-5
    # the sign convention: R = Q'^T (A Q) has a non-negative diagonal
    R = np.swapaxes(got, -1, -2) @ (A @ Q)
    assert np.all(np.diagonal(R, axis1=-2, axis2=-1) > 0)


@pytest.mark.parametrize("stage_aware", [False, True])
def test_layout_delays_and_refresh_periods_match_reference_at_paper_95m(stage_aware):
    cj = jget_config("paper_95m").replace(scan_layers=False)
    ct = tget_config("paper_95m").replace(scan_layers=False)
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    params = param_leaves(Transformer(ct, device="meta", seed=None))
    jplan = jlayout.build_layout(shapes, "bilateral")
    tplan = tlayout.build_layout(params, "bilateral")
    assert [(p.path, p.shape, p.rotate, p.left, p.right) for p in jplan] == \
        [(p.path, p.shape, p.rotate, p.left, p.right) for p in tplan]
    assert sum(p.rotate for p in tplan) == 192  # 32 layers x 6 projections
    assert tpart.leaf_delays(params, ct, 8) == jpart.leaf_delays(shapes, cj, 8)
    jctx = jpart.stage_context_for_tree(shapes, cj, 8)
    tctx = tpart.stage_context_for_tree(params, ct, 8)
    assert tctx.delay_specs() == jctx.delay_specs()
    if stage_aware:
        assert tctx.refresh_freqs(10) == jctx.refresh_freqs(10)
        assert tctx.refresh_freqs(10, True) == jctx.refresh_freqs(10, True)


def test_build_optimizer_wraps_the_delay_fifo_and_refuses_unknown_names():
    ct = tget_config("paper_95m", smoke=True).replace(scan_layers=False)
    params = param_leaves(Transformer(ct, device="cpu", seed=0))
    opt = build_optimizer(OptimizerConfig(), params, ct, num_stages=2)
    state = opt.init(params)
    depths = [0 if q is None else q.shape[0] for q in state["grad_q"]]
    assert depths == tpart.leaf_delays(params, ct, 2)
    assert "leaves" in state["inner"]
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer(OptimizerConfig(name="sgd"), params, ct, num_stages=2)
