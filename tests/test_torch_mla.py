"""MLA attention (``models/attention.py``'s ``mla_*``) and deepseek_v2_236b
in the port against the JAX reference: ``mla_train`` with and without query
compression and its gradients, the absorbed ``mla_decode`` and its latent
caches (mixer and whole model, against the reference and the training
forward), deepseek's leaves and rotation plan, a short sim run with basis
rotation, a 1F1B run with Adam against the reference's ``SpmdEngine``, and
the MLA leaves with their optimizer state crossing between the packages."""
import contextlib
import dataclasses
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
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.catalog import get_config as jget_config
from repro.core.layout import build_layout as jbuild_layout
from repro.core.layout import path_str as jpath_str
from repro.data.synthetic import batches as jbatches
from repro.engine.spmd import stack_stage_params as jstack
from repro.models import attention as jattn
from repro.models.model import forward_decode as jforward_decode
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro.pipeline.simulate import run_sim_training as jrun_sim_training
from repro_torch.checkpoint.convert import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
    stacked_from_numpy,
    stacked_to_numpy,
)
from repro_torch.configs import OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import AttentionConfig
from repro_torch.core.layout import build_layout
from repro_torch.data import batches
from repro_torch.engine import LoopConfig, SimEngine, SpmdEngine, run_loop
from repro_torch.models import (
    Transformer,
    forward_decode,
    forward_train,
    init_cache,
    param_leaves,
)
from repro_torch.models import attention as tattn
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.partition import delay_tree

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek_v2_236b"
B, S, D_MODEL = 2, 16, 64
# two implementations of a step with Adam differ by float32 roundoff
ADAM_TOL = 1e-4
# basis rotation: (first two losses, every loss), the reference's tolerance
# for two implementations of its step (tests/test_engine.py:437-438)
ROTATION_TOLS = (2e-3, 5e-2)
# the reference's MLA train/decode consistency tolerance (tests/test_models.py:35, :63-71)
CONSISTENCY_TOL = 2e-4
MLA = dict(kind="mla", num_heads=4, num_kv_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16)


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
    """Reference weights with noise on every 1-D leaf (the latent and query
    norms, the block norms), so that each reaches the output with values of
    its own."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (x + 0.2 * rng.randn(*x.shape)).astype(x.dtype) if x.ndim == 1 else x,
        _np_tree(tree))


def _configs(smoke=True, **kw):
    return (jget_config(ARCH, smoke).replace(scan_layers=False, **kw),
            tget_config(ARCH, smoke).replace(scan_layers=False, **kw))


def _mixer(q_lora_rank, seed):
    jcfg = JAttentionConfig(q_lora_rank=q_lora_rank, **MLA)
    tree = _perturbed(jattn.init_attention(jax.random.PRNGKey(seed), D_MODEL, jcfg,
                                           jnp.float32), seed)
    return jcfg, AttentionConfig(q_lora_rank=q_lora_rank, **MLA), tree, {
        k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("q_lora_rank", [48, 0], ids=["q_lora_48", "no_q_lora"])
def test_mla_train_output_and_gradients_match_reference(q_lora_rank):
    """``mla_train`` on the same weights and input, float32, with query
    compression (``q_a``, ``q_a_norm``, ``q_b``) and without (``w_q``): the
    output within 1e-5 and the gradients of a random projection of it with
    respect to the input and every leaf within 1e-4 of their largest entry."""
    jcfg, tcfg, tree, w = _mixer(q_lora_rank, seed=0)
    assert sorted(w) == sorted(tree) and ("q_a" in w) == (q_lora_rank > 0)
    rng = np.random.RandomState(1)
    x = rng.randn(B, S, D_MODEL).astype(np.float32)
    ct = rng.randn(B, S, D_MODEL).astype(np.float32)

    def both(p, x, ct):
        y, vjp = jax.vjp(lambda p, x: jattn.mla_train(p, x, jcfg), p, x)
        return y, vjp(ct)

    want, (g_params, g_x) = jax.jit(both)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                         jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    for v in w.values():
        v.requires_grad_()
    got = tattn.mla_train(w, xt, tcfg)
    grads = torch.autograd.grad(got, [xt, *w.values()], torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, gt, gj in zip(["input", *w], grads, [g_x, *(g_params[k] for k in w)]):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(gj).max()), err_msg=name)


def test_mla_decode_and_latent_cache_match_reference():
    """Six absorbed decode steps from the zeroed caches: every output and the
    latent and roped-key caches within 1e-5 of the reference's; the caches
    written in place."""
    jcfg, tcfg, tree, w = _mixer(48, seed=2)
    x = np.random.RandomState(3).randn(B, 6, D_MODEL).astype(np.float32)
    jcache = jattn.init_mla_cache(B, 6, jcfg, jnp.float32)
    tcache = tattn.init_mla_cache(B, 6, tcfg, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    latent = tcache["latent"]
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(jattn.mla_decode, static_argnums=4)
    for t in range(6):
        jy, jcache = step(params, jnp.asarray(x[:, t: t + 1]), jcache, jnp.int32(t), jcfg)
        ty, tcache = tattn.mla_decode(w, torch.from_numpy(x[:, t: t + 1]), tcache, t, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        for k in jcache:
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {t} cache {k}")
    assert tcache["latent"] is latent


def test_deepseek_decode_matches_reference_and_training_forward():
    """The reduced deepseek (two MLA blocks with MoE MLPs, a shared expert)
    in float32 at capacity factor 8, where training drops no token either:
    teacher-forced decode against the reference's within 2e-5 and against
    the port's own forward_train within the reference's MLA tolerance,
    2e-4."""
    high = dict(capacity_factor=8.0)
    cj, ct = _configs(dtype="float32")
    cj = cj.replace(moe=dataclasses.replace(cj.moe, **high))
    ct = ct.replace(moe=dataclasses.replace(ct.moe, **high))
    tree = _perturbed(jinit_model(jax.random.PRNGKey(4), cj), 4)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    toks = np.random.RandomState(5).randint(0, ct.vocab_size, size=(B, 10))
    jcache, want = jinit_cache(cj, B, 10), []
    step = jax.jit(jforward_decode, static_argnums=1)
    for t in range(10):
        lg, jcache = step(params, cj, jnp.asarray(toks[:, t: t + 1]), jcache, jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache, got = init_cache(ct, B, 10, device="cpu"), []
        assert [sorted(c) for c in cache] == [["k_rope", "latent"]] * 2
        for t in range(10):
            lg, cache = forward_decode(model, tt[:, t: t + 1], cache, t)
            got.append(lg[:, 0])
        full, _ = forward_train(model, tt)
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, full.numpy(), rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full_width_1_layer"])
def test_deepseek_leaf_paths_order_shapes_and_rotation_plan_match_reference(smoke):
    """Paths, shapes and tree_flatten order of every leaf and the rotation
    plan of each; at full width one of the 60 layers on the meta device
    (5.02 G parameters). The MLA projections rotate, their norms do not;
    the (160, 5120, 1536) expert stacks rotate as 160 matrices."""
    cj, ct = _configs(smoke, **({} if smoke else {"num_layers": 1}))
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    port = param_leaves(Transformer(ct, device="meta", seed=None))
    assert [(k, tuple(p.shape)) for k, p in port.items()] == \
        [(jpath_str(p), tuple(x.shape)) for p, x in flat]
    for geometry in ("bilateral", "unilateral"):
        want = [dataclasses.astuple(p) for p in jbuild_layout(shapes, geometry)]
        assert [dataclasses.astuple(p) for p in build_layout(port, geometry)] == want
    plan = {p.path: p for p in build_layout(port, "bilateral")}
    mixer = {p.rsplit("/", 1)[1]: plan[p].rotate for p in plan
             if p.startswith("blocks/0/mixer/")}
    assert mixer == {"kv_a": True, "kv_a_norm": False, "kv_b": True, "q_a": True,
                     "q_a_norm": False, "q_b": True, "w_o": True}
    if not smoke:
        assert plan["blocks/0/mixer/q_b"].shape == (1536, 128 * 192)
        assert plan["blocks/0/mixer/kv_b"].shape == (512, 128 * 256)
        assert plan["blocks/0/mlp/w_up_e"].shape == (160, 5120, 1536)
        assert sum(p.numel() for p in port.values()) == 5_020_697_600


def test_deepseek_sim_run_with_basis_rotation_tracks_the_reference():
    """The reduced deepseek on both packages' sim backends, 2 stages, 3
    steps, basis rotation refreshing at steps 0 and 2 (B4 and B5 through
    their plain versions, MLA's projections and the expert stacks rotated),
    within the tolerances of two implementations of the step."""
    steps, K = 3, 2
    ocfg = dict(name="basis_rotation", rotation_freq=2)
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
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(got) == steps and all(np.isfinite(got)), (got, want)
    assert max(diffs[:2]) < ROTATION_TOLS[0] and max(diffs) < ROTATION_TOLS[1], (got, want)


REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
sys.path.insert(0, "src")
import jax, json
from repro.configs.base import OptimizerConfig
from repro.configs.catalog import get_config
from repro.data import batches
from repro.engine import LoopConfig, SpmdEngine, run_loop
from repro.launch.mesh import make_mesh_compat
from repro.models import init_model

cfg = get_config("deepseek_v2_236b", smoke=True).replace(scan_layers=False, dtype="float32")
steps, K = int(sys.argv[1]), 2
params = init_model(jax.random.PRNGKey(0), cfg)
mesh = make_mesh_compat((K, 1), ("stage", "data"))
print("ready", flush=True)
eng = SpmdEngine(cfg, OptimizerConfig(total_steps=steps, **json.loads(sys.argv[2])),
                 num_stages=K, num_microbatches=K, mesh=mesh, schedule="1f1b")
_, losses = run_loop(eng, batches(cfg, 4, 16, seed=0), LoopConfig(steps=steps),
                     state=eng.init_state(params=params))
print(json.dumps(losses))
"""


def test_deepseek_1f1b_with_adam_tracks_the_reference_engine():
    """The reduced deepseek on 2 stages under 1F1B with Adam, float32, 3
    steps: the port's ``SpmdEngine`` (MLA inside ``stage_apply``, the
    stacked (K, per, E, d, f) expert stacks) against the reference's on two
    forced host devices, in a subprocess that compiles while the port runs.
    Both stage applies drop the MoE's aux, as in the reference."""
    steps = 3
    adam = {"name": "adam", "learning_rate": 1e-3, "schedule": "constant"}
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, str(steps),
                             json.dumps(adam)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        cj, ct = _configs(dtype="float32")
        tree = _np_tree(jinit_model(jax.random.PRNGKey(0), cj))
        pair = stacked_from_numpy(_np_tree(jstack(jax.tree.map(jnp.asarray, tree), cj, 2)),
                                  "cpu")
        assert tuple(pair[0]["mixer/kv_b"].shape) == (2, 1, 32, 4 * 32)
        eng = SpmdEngine(ct, OptimizerConfig(total_steps=steps, **adam), num_stages=2,
                         num_microbatches=2, schedule="1f1b", use_kernels=True, device="cpu")
        _, got, _ = run_loop(eng, batches(ct, 4, 16, seed=0, device="cpu"),
                             LoopConfig(steps=steps),
                             state=eng.init_state(tuple(dict(d) for d in pair)))
        assert proc.stdout.readline().strip() == "ready"
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    assert len(got) == steps and all(np.isfinite(got)), (got, want)
    assert max(abs(a - b) for a, b in zip(got, want)) < ADAM_TOL, (got, want)


def test_mla_leaves_and_their_optimizer_state_round_trip_exactly():
    """The MLA leaves cross between the packages bit for bit, per layer and
    stage-stacked, and so does basis rotation's state over them (kv_b's
    bases (r, r) and (H (dn + dv), H (dn + dv)))."""
    cj, ct = _configs(dtype="float32")
    tree = _perturbed(jinit_model(jax.random.PRNGKey(6), cj), 6)
    model = params_from_numpy(tree, ct, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(model)),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jtree = _np_tree(jstack(jax.tree.map(jnp.asarray, tree), cj, 2))
    for a, b in zip(jax.tree_util.tree_leaves(stacked_to_numpy(*stacked_from_numpy(jtree,
                                                                                   "cpu"))),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    leaves = param_leaves(model)
    opt = build_optimizer(OptimizerConfig(name="basis_rotation"), leaves, ct, num_stages=2)
    state = opt.init(leaves)
    inner = state["inner"]["leaves"][list(leaves).index("blocks/0/mixer/kv_b")]
    assert tuple(inner["U"].shape) == (32, 32) and tuple(inner["V"].shape) == (128, 128)
    gen = torch.Generator().manual_seed(0)
    for st in state["inner"]["leaves"]:
        for v in st.values():
            v.copy_(torch.randn(v.shape, generator=gen))
    restored = opt_state_from_numpy(opt_state_to_numpy(state), opt.init(leaves))
    for a, b in zip(restored["inner"]["leaves"], state["inner"]["leaves"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
