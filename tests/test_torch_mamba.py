"""The Mamba mixer (``models/mamba.py``) and jamba_v0_1_52b in the port
against the JAX reference: ``mamba_train`` with its gradients at two widths,
the chunked scan against the reference's at S = 2048, decode and its cache
(mixer and whole model, against the reference and the training forward),
jamba's leaves and rotation plan, short sim runs with Adam and basis
rotation, the spmd backend's refusal, and the Mamba leaves with their
optimizer state crossing between the packages."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.catalog import get_config as jget_config
from repro.core.layout import build_layout as jbuild_layout
from repro.core.layout import path_str as jpath_str
from repro.data.synthetic import batches as jbatches
from repro.models import mamba as jmb
from repro.models.model import forward_decode as jforward_decode
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro.pipeline.partition import leaf_delays as jleaf_delays
from repro.pipeline.partition import leaf_stages as jleaf_stages
from repro.pipeline.simulate import run_sim_training as jrun_sim_training
from repro_torch.checkpoint.convert import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.configs import OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import SSMConfig
from repro_torch.core.layout import build_layout
from repro_torch.data import batches
from repro_torch.engine import LoopConfig, SimEngine, run_loop
from repro_torch.launch import train
from repro_torch.models import (
    Transformer,
    forward_decode,
    forward_train,
    init_cache,
    param_leaves,
)
from repro_torch.models import mamba as tmb
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.partition import delay_tree, leaf_delays, leaf_stages

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ARCH = "jamba_v0_1_52b"
B, S = 2, 16
# two implementations of a step with Adam differ by float32 roundoff
ADAM_TOL = 1e-4
# basis rotation: (first two losses, every loss), the reference's tolerance
# for two implementations of its step (tests/test_engine.py:437-438)
ROTATION_TOLS = (2e-3, 5e-2)
# the reference's Mamba train/decode consistency tolerance (tests/test_models.py:74-81)
CONSISTENCY_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; these
    small shapes gain nothing from torch's intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # numpy's BLAS pool too: its idle threads spin on the cores the others need
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, seed):
    """Reference weights with noise on every 1-D leaf (conv_b, D, dt_bias,
    the norms), so that each reaches the output with values of its own."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (x + 0.2 * rng.randn(*x.shape)).astype(x.dtype) if x.ndim == 1 else x,
        _np_tree(tree))


def _configs(smoke=True, **kw):
    return (jget_config(ARCH, smoke).replace(scan_layers=False, **kw),
            tget_config(ARCH, smoke).replace(scan_layers=False, **kw))


def _value_and_vjp(fn, args, ct):
    """fn(*args) and its vector-Jacobian product with ``ct``, compiled once
    (the reference's scan runs op by op ten times slower)."""
    def both(args, ct):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(ct)

    return jax.jit(both)(args, ct)


def _mixer(d_model, scfg, seed):
    tree = _perturbed(jmb.init_mamba(jax.random.PRNGKey(seed), d_model, JSSMConfig(**scfg),
                                     jnp.float32), seed)
    return tree, {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


WIDTHS = {  # (d_model, SSMConfig fields)
    "d32_n8": (32, dict(kind="mamba", d_state=8, d_conv=4, expand=2)),
    "d48_n16_dt5": (48, dict(kind="mamba", d_state=16, d_conv=3, expand=2, dt_rank=5)),
}


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mamba_train_output_and_gradients_match_reference(width):
    """``mamba_train`` on the same weights and input, float32: the output
    within 1e-5 (the loop over time and the reference's tree multiply in
    other orders), and the gradients of a random projection of it with
    respect to the input and every leaf within 1e-4 of their largest entry."""
    d_model, scfg = WIDTHS[width]
    tree, w = _mixer(d_model, scfg, seed=0)
    rng = np.random.RandomState(1)
    u = rng.randn(B, S, d_model).astype(np.float32)
    ct = rng.randn(B, S, d_model).astype(np.float32)
    jcfg = JSSMConfig(**scfg)
    want, (g_params, g_u) = _value_and_vjp(lambda p, x: jmb.mamba_train(p, x, jcfg),
                                           (jax.tree.map(jnp.asarray, tree), jnp.asarray(u)),
                                           jnp.asarray(ct))
    x = torch.from_numpy(u).requires_grad_()
    for v in w.values():
        v.requires_grad_()
    got = tmb.mamba_train(w, x, SSMConfig(**scfg))
    grads = torch.autograd.grad(got, [x, *w.values()], torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, gt, gj in zip(["input", *w], grads, [g_u, *(g_params[k] for k in w)]):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(gj).max()), err_msg=name)


@pytest.mark.parametrize("chunk", [1024, 256])
def test_chunked_scan_matches_reference_at_2048(monkeypatch, chunk):
    """``_ssm_scan_chunked`` at S = 2048 with d_inner 4 and d_state 2: two
    chunks of the default ``SSM_CHUNK`` and eight of 256 (set in both
    packages), the boundary state carried between them and each chunk
    recomputed in the backward. Output and the gradients to dA, dBx and C
    within 1e-4 of the reference's, and equal to the unchunked loop's."""
    for mod in (jmb, tmb):
        monkeypatch.setattr(mod, "SSM_CHUNK", chunk)
    rng = np.random.RandomState(2)
    shape = (1, 2048, 4, 2)
    dA = np.exp(-rng.uniform(0.01, 0.5, size=shape)).astype(np.float32)
    dBx = (0.1 * rng.randn(*shape)).astype(np.float32)
    C = rng.randn(1, 2048, 2).astype(np.float32)
    ct = rng.randn(1, 2048, 4).astype(np.float32)
    want, want_g = _value_and_vjp(jmb._ssm_scan_chunked,
                                  tuple(jnp.asarray(a) for a in (dA, dBx, C)), jnp.asarray(ct))

    def run():
        ins = [torch.from_numpy(a).requires_grad_() for a in (dA, dBx, C)]
        y = tmb._ssm_scan_chunked(*ins)
        return y.detach().numpy(), torch.autograd.grad(y, ins, torch.from_numpy(ct))

    got, got_g = run()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    for name, gt, gj in zip(("dA", "dBx", "C"), got_g, want_g):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(gj).max()), err_msg=name)
    monkeypatch.setattr(tmb, "SSM_CHUNK", 1 << 20)
    whole, whole_g = run()
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)
    for gt, gw in zip(got_g, whole_g):
        np.testing.assert_allclose(gt.numpy(), gw.numpy(), rtol=1e-5, atol=1e-5)


def test_mamba_decode_and_cache_match_reference():
    """Six decode steps from the zeroed cache: every output and both cache
    tensors within 1e-5 of the reference's, with its dtypes (the
    convolution's last inputs in the compute dtype, the SSM state float32)."""
    d_model, scfg = WIDTHS["d32_n8"]
    tree, w = _mixer(d_model, scfg, seed=3)
    jcfg, tcfg = JSSMConfig(**scfg), SSMConfig(**scfg)
    u = np.random.RandomState(4).randn(B, 6, d_model).astype(np.float32)
    jcache = jmb.init_mamba_cache(B, d_model, jcfg, jnp.float32)
    tcache = tmb.init_mamba_cache(B, d_model, tcfg, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(jmb.mamba_decode, static_argnums=3)
    for t in range(u.shape[1]):
        jy, jcache = step(params, jnp.asarray(u[:, t: t + 1]), jcache, jcfg)
        ty, tcache = tmb.mamba_decode(w, torch.from_numpy(u[:, t: t + 1]), tcache, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        for k in jcache:
            assert tcache[k].dtype == torch.float32
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {t} cache {k}")


def test_jamba_decode_matches_reference_and_training_forward():
    """The reduced jamba (a Mamba block with a MoE MLP, then an attention
    block) in float32 at capacity factor 8, where training drops no token
    either: teacher-forced decode against the reference's within 2e-5 and
    against the port's own forward_train within the reference's Mamba
    tolerance, 1e-3."""
    high = dict(capacity_factor=8.0)
    cj, ct = _configs(dtype="float32")
    cj = cj.replace(moe=dataclasses.replace(cj.moe, **high))
    ct = ct.replace(moe=dataclasses.replace(ct.moe, **high))
    tree = _perturbed(jinit_model(jax.random.PRNGKey(5), cj), 5)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    toks = np.random.RandomState(6).randint(0, ct.vocab_size, size=(B, 10))
    jcache, want = jinit_cache(cj, B, 10), []
    step = jax.jit(jforward_decode, static_argnums=1)
    for t in range(10):
        lg, jcache = step(params, cj, jnp.asarray(toks[:, t: t + 1]), jcache, jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache, got = init_cache(ct, B, 10, device="cpu"), []
        assert [sorted(c) for c in cache] == [["conv", "ssm"], ["k", "v"]]
        for t in range(10):
            lg, cache = forward_decode(model, tt[:, t: t + 1], cache, t)
            got.append(lg[:, 0])
        full, _ = forward_train(model, tt)
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, full.numpy(), rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full_width_8_layers"])
def test_jamba_leaf_paths_order_shapes_and_rotation_plan_match_reference(smoke):
    """Paths, shapes and tree_flatten order of every leaf, the rotation plan
    of each, and each leaf's stage and delay (2 and 8 stages); at full width
    one superblock of 8 layers on the meta device. ``A_log``, ``dt_bias``
    and ``conv_b`` are excluded by name, ``conv_w`` (d_conv 4 rows) is under
    ``min_dim``, ``D`` is 1-D; the projections rotate."""
    cj, ct = _configs(smoke, **({} if smoke else {"num_layers": 8}))
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    port = param_leaves(Transformer(ct, device="meta", seed=None))
    assert [(k, tuple(p.shape)) for k, p in port.items()] == \
        [(jpath_str(p), tuple(x.shape)) for p, x in flat]
    for geometry in ("bilateral", "unilateral"):
        want = [dataclasses.astuple(p) for p in jbuild_layout(shapes, geometry)]
        assert [dataclasses.astuple(p) for p in build_layout(port, geometry)] == want
    for stages in (2, 8):
        assert leaf_stages(port, ct, stages) == jleaf_stages(shapes, cj, stages)
        assert leaf_delays(port, ct, stages) == jleaf_delays(shapes, cj, stages)
    plan = {p.path: p for p in build_layout(port, "bilateral")}
    mixer = {p.rsplit("/", 1)[1]: plan[p].rotate for p in plan
             if p.startswith("blocks/0/mixer/")}
    assert mixer == {"A_log": False, "D": False, "conv_b": False, "conv_w": False,
                     "dt_bias": False, "dt_proj": True, "in_proj": True, "out_proj": True,
                     "x_proj": True}
    if not smoke:
        assert plan["blocks/0/mixer/in_proj"].shape == (4096, 16384)
        assert plan["blocks/0/mixer/x_proj"].shape == (8192, 288)
        assert plan["blocks/0/mixer/dt_proj"].shape == (256, 8192)
        assert plan["blocks/0/mixer/conv_w"].shape == (4, 8192)


def _sim_losses(**ocfg):
    """3 steps of both packages' sim backends on 2 stages, float32, from the
    same weights and stream: (port's, reference's)."""
    steps, K = 3, 2
    cj, ct = _configs(dtype="float32")
    tree = _np_tree(jinit_model(jax.random.PRNGKey(0), cj))
    params = jax.tree.map(jnp.asarray, tree)
    jopt = jbuild_optimizer(JOptimizerConfig(total_steps=steps, **ocfg), params, cj,
                            num_stages=K)
    _, _, want = jrun_sim_training(cj, jopt, jbatches(cj, 4, 16, seed=0), steps, params=params)
    model = params_from_numpy(tree, ct, "cpu")
    leaves = param_leaves(model)
    opt = build_optimizer(OptimizerConfig(total_steps=steps, **ocfg), leaves, ct,
                          num_stages=K, use_kernels=True)
    engine = SimEngine(model, opt, delays_tree=delay_tree(leaves, ct, K))
    _, got, _ = run_loop(engine, batches(ct, 4, 16, seed=0, device="cpu"),
                         LoopConfig(steps=steps))
    assert len(got) == steps and all(np.isfinite(got)), (got, want)
    return got, want


@pytest.mark.parametrize("optimizer", ["adam", "basis_rotation"])
def test_jamba_sim_runs_track_the_reference(optimizer):
    """The reduced jamba on both packages' sim backends, Adam and basis
    rotation (refreshes at steps 0 and 2, B4 and B5 through their plain
    versions), within the tolerances of two implementations of the step."""
    if optimizer == "adam":
        got, want = _sim_losses(name="adam")
        assert max(abs(a - b) for a, b in zip(got, want)) < ADAM_TOL, (got, want)
    else:
        got, want = _sim_losses(name="basis_rotation", rotation_freq=2)
        diffs = [abs(a - b) for a, b in zip(got, want)]
        assert max(diffs[:2]) < ROTATION_TOLS[0] and max(diffs) < ROTATION_TOLS[1], \
            (got, want)


def test_jamba_is_refused_on_spmd_by_name():
    """Jamba mixes Mamba and attention blocks, which the reference's SPMD
    runtime cannot stack: the launcher refuses it naming the config and the
    block kinds; the sim backend builds it."""
    base = ["--arch", ARCH, "--smoke", "--stages", "2", "--device", "cpu"]
    with pytest.raises(SystemExit, match=r"jamba_v0_1_52b_smoke: a pattern of mixed block "
                                         r"kinds \(attn/dense, mamba/moe\)"):
        train.build(train.parse_args(base + ["--backend", "spmd"]))
    engine, _, _ = train.build(train.parse_args(base))
    assert sum(b.spec.mixer == "mamba" for b in engine.model.blocks) == 1


def test_mamba_leaves_and_their_optimizer_state_round_trip_exactly():
    """The Mamba leaves (the float32 A_log, dt_bias and D among them) cross
    between the packages bit for bit, and so does basis rotation's state
    over them: the rotated projections' bases and grams, the moments of
    the unrotated ones."""
    cj, ct = _configs(dtype="float32")
    tree = _perturbed(jinit_model(jax.random.PRNGKey(7), cj), 7)
    model = params_from_numpy(tree, ct, "cpu")
    back = params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    leaves = param_leaves(model)
    opt = build_optimizer(OptimizerConfig(name="basis_rotation"), leaves, ct, num_stages=2)
    state = opt.init(leaves)
    i = list(leaves).index("blocks/0/mixer/in_proj")
    d, di = ct.d_model, 2 * ct.ssm.expand * ct.d_model
    inner = state["inner"]["leaves"][i]
    assert tuple(inner["U"].shape) == (d, d) and tuple(inner["V"].shape) == (di, di)
    gen = torch.Generator().manual_seed(0)
    for st in state["inner"]["leaves"]:
        for v in st.values():
            v.copy_(torch.randn(v.shape, generator=gen))
    restored = opt_state_from_numpy(opt_state_to_numpy(state), opt.init(leaves))
    for a, b in zip(restored["inner"]["leaves"], state["inner"]["leaves"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
