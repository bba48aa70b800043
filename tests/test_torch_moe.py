"""The MoE MLP (``models/moe.py``) and mixtral_8x22b in the port against
the JAX reference: ``apply_moe`` with its outputs, auxiliary loss and
gradients (tokens overflowing their experts' capacity included), exact
routing, mixtral's leaf paths and rotation plan, a short sim run, the SPMD
fill-drain and 1F1B schedules against the reference's ``SpmdEngine`` (both
dropping the auxiliary loss), and decode."""
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

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.catalog import get_config as jget_config
from repro.core.layout import build_layout as jbuild_layout
from repro.core.layout import path_str as jpath_str
from repro.data.synthetic import batches as jbatches
from repro.engine.spmd import stack_stage_params as jstack
from repro.models import moe as jmoe
from repro.models.model import forward_decode as jforward_decode
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
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
from repro_torch.configs import MoEConfig, OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.core.layout import build_layout
from repro_torch.data import batches
from repro_torch.engine import LoopConfig, SimEngine, SpmdEngine, run_loop
from repro_torch.launch import serve_decode, train
from repro_torch.models import (
    Transformer,
    forward_decode,
    forward_train,
    init_cache,
    loss_fn,
    param_leaves,
)
from repro_torch.models import moe
from repro_torch.models.transformer import template_block
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.partition import delay_tree

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mixtral_8x22b"
# two implementations of a step with Adam differ by float32 roundoff
# (tests/test_torch_xlstm.py's tolerance)
ADAM_TOL = 1e-4
# basis rotation: (first two losses, every loss), the reference's tolerance
# for two implementations of its step (tests/test_engine.py:437-438)
ROTATION_TOLS = (2e-3, 5e-2)
CONSISTENCY_TOL = 1e-3  # the reference's MoE decode tolerance (tests/test_models.py:106-113)


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


def _configs(smoke=True, **kw):
    return (jget_config(ARCH, smoke).replace(scan_layers=False, **kw),
            tget_config(ARCH, smoke).replace(scan_layers=False, **kw))


def _moe_inputs(cfg_kw, act="swiglu", seed=0, B=2, S=24, D=32, F=48):
    """The reference's MoE weights (numpy) and a numpy input (B, S, D)."""
    jcfg = JMoEConfig(**cfg_kw)
    w = _np_tree(jmoe.init_moe(jax.random.PRNGKey(seed), D, F, jcfg, act, jnp.float32))
    x = np.random.RandomState(seed + 1).randn(B, S, D).astype(np.float32)
    return jcfg, MoEConfig(**cfg_kw), w, x


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _routing(wt, xt, cfg):
    """(tokens whose every top-k expert was full, routing mask) as
    ``apply_moe`` computes them, per group."""
    B, S, D = xt.shape
    g = moe._group_size(B * S, cfg.group_size)
    logits = xt.reshape(-1, g, D) @ wt["router"]
    _, mask = moe._top_k_gates(logits, cfg.top_k)
    pos = torch.cumsum(mask, dim=1) * mask - 1.0
    fits = (pos < moe.moe_capacity(g, cfg)) & (mask > 0)
    return ~fits.any(dim=-1), mask


CASES = {
    # the reference's defaults: GShard groups of the whole batch
    "default": (dict(num_experts=4, top_k=2), "swiglu"),
    # tokens overflow (capacity 4 a group of 24), groups of 24 out of 48
    "overflow": (dict(num_experts=4, top_k=2, capacity_factor=0.25, group_size=24), "swiglu"),
    # a shared GELU expert beside the routed ones, 3 of 6 experts
    "shared": (dict(num_experts=6, top_k=3, num_shared=1, aux_loss_coef=0.05), "gelu"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference_with_aux_and_gradients(case):
    """Output within 1e-5, aux within 1e-6, and the gradients of a random
    projection of the output plus the aux with respect to the input and
    every weight within 1e-4 relative of their largest entry. With a small
    capacity factor tokens overflow: a token whose experts were all full
    comes out as a zero row."""
    kw, act = CASES[case]
    jcfg, tcfg, w, x = _moe_inputs(kw, act)
    ct = np.random.RandomState(7).randn(*x.shape).astype(np.float32)

    def jobj(params, xx):
        y, aux = jmoe.apply_moe(params, xx, jcfg)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (y_j, aux_j)), (gw_j, gx_j) = jax.value_and_grad(jobj, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x))
    wt = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in _flat(w).items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y_t, aux_t = moe.apply_moe(wt, xt, tcfg)
    obj = (y_t * torch.from_numpy(ct)).sum() + aux_t
    grads = torch.autograd.grad(obj, [xt, *wt.values()])
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    assert abs(aux_t.item() - float(aux_j)) < 1e-6 and aux_t.item() > 0
    want = {"x": np.asarray(gx_j), **{k: np.asarray(v) for k, v in _flat(gw_j).items()}}
    for name, got in zip(["x", *wt], grads):
        g = want[name]
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-7, err_msg=name)
    dropped, _ = _routing({k: v.detach() for k, v in wt.items()}, xt.detach(), tcfg)
    if case == "overflow":
        assert 0 < int(dropped.sum()) < dropped.numel()
        rows = y_t.detach().reshape(-1, x.shape[-1])[dropped.reshape(-1)]
        assert torch.count_nonzero(rows) == 0
    elif case == "default":
        assert not dropped.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_masks_and_gates_equal_the_reference(seed):
    """The top-k mask equals the reference's exactly and the renormalised
    gates within 1e-6, over 64 groups of 48 tokens and 8 experts, top 2;
    the capacity and the group size as the reference computes them."""
    logits = np.random.RandomState(seed).randn(64, 48, 8).astype(np.float32) * 2.0
    gates_j, mask_j = jax.vmap(lambda lg: jmoe._top_k_gates(lg, 2))(jnp.asarray(logits))
    gates_t, mask_t = moe._top_k_gates(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(gates_t.numpy(), np.asarray(gates_j), rtol=1e-6, atol=1e-6)
    for T, target in ((48, 4096), (2048, 4096), (8192, 4096), (96, 40), (97, 40)):
        assert moe._group_size(T, target) == jmoe._group_size(T, target)
    for tokens, kw in ((2048, dict(num_experts=8, top_k=2)),
                       (3, dict(num_experts=8, top_k=2)),
                       (100, dict(num_experts=4, top_k=1, capacity_factor=0.5))):
        assert moe.moe_capacity(tokens, MoEConfig(**kw)) == \
            jmoe.moe_capacity(tokens, JMoEConfig(**kw))


@pytest.mark.parametrize("smoke", [True, False])
def test_mixtral_config_leaf_paths_order_and_rotation_plan_match_reference(smoke):
    """The config field for field (MoE included); every leaf's path, shape
    and tree_flatten order, and the rotation plan: the expert stacks
    ``(E, d, d_ff)`` are rotated as E matrices; the router (d, E) only
    where both its sides are at least 8 wide (the full config's 8
    experts), as in the reference. The full config on the meta device, two
    of its 56 layers deep."""
    ref, port = jget_config(ARCH, smoke), tget_config(ARCH, smoke)
    for f in dataclasses.fields(port):
        r, p = getattr(ref, f.name), getattr(port, f.name)
        if f.name in ("attention", "moe"):
            assert {g.name: getattr(r, g.name) for g in dataclasses.fields(p)} == \
                dataclasses.asdict(p), f.name
        elif f.name == "pattern":
            assert [(s.mixer, s.mlp) for s in r] == [(s.mixer, s.mlp) for s in p]
        else:
            assert r == p, (f.name, r, p)
    assert {g.name for g in dataclasses.fields(JMoEConfig)} == \
        {g.name for g in dataclasses.fields(MoEConfig)}
    cj, ct = _configs(smoke, **({} if smoke else {"num_layers": 2}))
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = param_leaves(Transformer(ct, device="meta", seed=None))
    assert [(k, tuple(p.shape)) for k, p in leaves.items()] == \
        [(jpath_str(p), tuple(x.shape)) for p, x in flat]
    for geometry in ("bilateral", "unilateral"):
        want = [dataclasses.astuple(p) for p in jbuild_layout(shapes, geometry)]
        assert [dataclasses.astuple(p) for p in build_layout(leaves, geometry)] == want
    plan = {p.path: p for p in build_layout(leaves, "bilateral")}
    E, d, f = ct.moe.num_experts, ct.d_model, ct.moe.d_ff_expert
    assert plan["blocks/0/mlp/w_gate_e"].shape == (E, d, f)
    assert plan["blocks/0/mlp/w_down_e"].shape == (E, f, d)
    assert all(plan[f"blocks/0/mlp/{n}"].rotate for n in ("w_gate_e", "w_up_e", "w_down_e"))
    assert plan["blocks/0/mlp/router"].rotate == (not smoke)


def test_mixtral_loss_and_gradients_match_the_reference():
    """float32 compute at the reduced config: the loss (cross-entropy plus
    the load-balance aux) within 1e-5, the aux within 1e-6, every gradient
    leaf (router and expert stacks included) within 1e-4 relative."""
    cj, ct = _configs(dtype="float32")
    tree = _np_tree(jinit_model(jax.random.PRNGKey(0), cj))
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    batch = next(jbatches(cj, 2, 32, seed=0))
    (loss_j, met_j), grads_j = jax.value_and_grad(jloss_fn, has_aux=True)(params, cj, batch)
    bt = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()}
    loss_t, met_t = loss_fn(model, bt)
    leaves = param_leaves(model)
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    assert abs(met_t["aux"].item() - float(met_j["aux"])) < 1e-6 and met_t["aux"].item() > 0
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    assert [jpath_str(p) for p, _ in flat] == list(leaves)
    for (p, gj), gt in zip(flat, grads_t):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(gj).max()) + 1e-7,
                                   err_msg=jpath_str(p))


def _sim_losses(**ocfg):
    """3 steps of both packages' sim backends on 2 stages, float32, the aux
    in the loss, from the same weights and stream: (port's, reference's)."""
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


def test_mixtral_sim_run_tracks_the_reference():
    """Adam: the port's ``SimEngine`` against the reference's
    ``run_sim_training`` (``_sim_losses``)."""
    got, want = _sim_losses(name="adam")
    assert max(abs(a - b) for a, b in zip(got, want)) < ADAM_TOL, (got, want)


def test_mixtral_sim_run_with_basis_rotation_tracks_the_reference():
    """Basis rotation with refreshes at steps 0 and 2, the (E, d, f) expert
    stacks and the router rotated, B4 and B5 through their plain versions:
    the port's ``SimEngine`` against the reference's ``run_sim_training``."""
    got, want = _sim_losses(name="basis_rotation", rotation_freq=2)
    diffs = [abs(a - b) for a, b in zip(got, want)]
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

cfg = get_config("mixtral_8x22b", smoke=True).replace(scan_layers=False, dtype="float32")
steps, K = int(sys.argv[1]), 2
params = init_model(jax.random.PRNGKey(0), cfg)
mesh = make_mesh_compat((K, 1), ("stage", "data"))
print("ready", flush=True)
res = {}
for name, ocfg, kw in json.loads(sys.argv[2]):
    eng = SpmdEngine(cfg, OptimizerConfig(total_steps=steps, **ocfg), num_stages=K,
                     num_microbatches=K, mesh=mesh, **kw)
    _, res[name] = run_loop(eng, batches(cfg, 4, 16, seed=0), LoopConfig(steps=steps),
                            state=eng.init_state(params=params))
print(json.dumps(res))
"""
SPMD_STEPS = 3
ADAM = {"name": "adam", "learning_rate": 1e-3, "schedule": "constant"}
# refreshes at steps 0 and 2: the rotated expert stacks' bases and grams
ROTATION = {"name": "basis_rotation", "learning_rate": 1e-3, "rotation_freq": 2}
SPMD_RUNS = [
    ("1f1b_kernels", ADAM, {"schedule": "1f1b", "use_kernels": True}),
    ("fill_drain", ADAM, {"schedule": "fill_drain"}),
    ("1f1b_rotation", ROTATION, {"schedule": "1f1b", "use_kernels": True}),
]
SPMD_TOLS = {"adam": (ADAM_TOL, ADAM_TOL), "basis_rotation": ROTATION_TOLS}


def test_mixtral_spmd_schedules_track_the_reference_engine():
    """mixtral's reduced config on 2 stages, float32, 3 steps: the port's
    ``SpmdEngine`` under 1F1B (attention through the flash kernels' plain
    versions) and fill-drain with Adam, and 1F1B with basis rotation
    (refreshes at steps 0 and 2, the kernels' plain versions), over the
    stacked (K, per, E, d, f) expert stacks, against the reference's on two
    forced host devices (a subprocess that compiles while the port runs).
    Both stage applies drop the aux: the first SPMD loss is the mean of the
    microbatches' cross-entropies without it (each microbatch routes as
    its own GShard group, as in the reference)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, str(SPMD_STEPS),
                             json.dumps(SPMD_RUNS)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        cj, ct = _configs(dtype="float32")
        tree = _np_tree(jinit_model(jax.random.PRNGKey(0), cj))
        pair = stacked_from_numpy(_np_tree(jstack(jax.tree.map(jnp.asarray, tree), cj, 2)),
                                  "cpu")
        assert tuple(pair[0]["mlp/w_gate_e"].shape) == (2, 1, 4, 256, 64)
        got = {}
        for name, ocfg, kw in SPMD_RUNS:
            eng = SpmdEngine(ct, OptimizerConfig(total_steps=SPMD_STEPS, **ocfg), num_stages=2,
                             num_microbatches=2, device="cpu", **kw)
            _, got[name], _ = run_loop(eng, batches(ct, 4, 16, seed=0, device="cpu"),
                                       LoopConfig(steps=SPMD_STEPS),
                                       state=eng.init_state(tuple(dict(d) for d in pair)))
        model = params_from_numpy(tree, ct, "cpu")
        batch = next(batches(ct, 4, 16, seed=0, device="cpu"))
        with torch.no_grad():
            per_mb = [loss_fn(model, {k: v[2 * m: 2 * m + 2] for k, v in batch.items()})[1]
                      for m in range(2)]
        ce = sum(met["ce"].item() for met in per_mb) / 2
        aux = sum(met["aux"].item() for met in per_mb) / 2
        assert proc.stdout.readline().strip() == "ready"
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for name, ocfg, _ in SPMD_RUNS:
        assert len(got[name]) == SPMD_STEPS and all(np.isfinite(got[name])), name
        first2, every = SPMD_TOLS[ocfg["name"]]
        diffs = [abs(a - b) for a, b in zip(got[name], want[name])]
        assert max(diffs[:2]) < first2 and max(diffs) < every, (name, got[name], want[name])
        # the aux is dropped: the first loss is the cross-entropy alone
        assert abs(got[name][0] - ce) < 1e-5 and aux > 1e-3, (name, got[name][0], ce, aux)


def test_stage_apply_drops_the_aux_of_moe_blocks():
    """The SPMD stage apply returns the blocks' output alone: the block's
    own forward returns the aux beside it."""
    _, ct = _configs(dtype="float32")
    model = Transformer(ct, device="cpu", seed=0)
    from repro_torch.models import stage_apply

    x = torch.randn(2, 8, ct.d_model, generator=torch.Generator().manual_seed(0))
    w = {k.split("/", 2)[2]: p.detach()[None] for k, p in param_leaves(model).items()
         if k.startswith("blocks/0/")}
    with torch.no_grad():
        y = stage_apply(template_block(ct), w, x)
        y0, aux = model.blocks[0](x)
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    assert aux.item() > 0


def test_mixtral_decode_matches_reference_and_training_at_high_capacity():
    """Teacher-forced decode (the sliding window's ring included) at
    capacity factor 8, where training drops no token either, as the
    reference tests it: against the reference's decode within 2e-5 and the
    port's own forward_train within the reference's 1e-3. The launcher's
    decode runs mixtral's own bf16 config."""
    cj, ct = _configs(dtype="float32")
    high = dict(capacity_factor=8.0)
    cj = cj.replace(moe=dataclasses.replace(cj.moe, **high),
                    attention=dataclasses.replace(cj.attention, window=5))
    ct = ct.replace(moe=dataclasses.replace(ct.moe, **high),
                    attention=dataclasses.replace(ct.attention, window=5))
    tree = _np_tree(jinit_model(jax.random.PRNGKey(3), cj))
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    B, S = 2, 10
    toks = np.random.RandomState(4).randint(0, ct.vocab_size, size=(B, S))
    cache = jinit_cache(cj, B, S)
    want = []
    for t in range(S):
        lg, cache = jforward_decode(params, cj, jnp.asarray(toks[:, t: t + 1]), cache,
                                    jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache_t = init_cache(ct, B, S, device="cpu")
        got = []
        for t in range(S):
            lg, cache_t = forward_decode(model, tt[:, t: t + 1], cache_t, t)
            got.append(lg[:, 0])
        full, _ = forward_train(model, tt)
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, full.numpy(), rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    out = serve_decode.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "3", "--gen-len", "3"])
    assert out["model"].cfg.compute_dtype == torch.bfloat16
    assert tuple(out["generated"].shape) == (2, 3)


def test_moe_leaves_and_their_optimizer_state_round_trip_exactly():
    """The router and the expert stacks cross between the packages bit for
    bit, per layer and stage-stacked, and so does basis rotation's state
    over them (bases of the (E, d, f) stacks: (E, d, d) and (E, f, f))."""
    cj, ct = _configs(dtype="float32")
    tree = _np_tree(jinit_model(jax.random.PRNGKey(1), cj))
    model = params_from_numpy(tree, ct, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(model)),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jtree = _np_tree(jstack(jax.tree.map(jnp.asarray, tree), cj, 2))
    stacked, shared = stacked_from_numpy(jtree, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(stacked_to_numpy(stacked, shared)),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    leaves = param_leaves(model)
    opt = build_optimizer(OptimizerConfig(name="basis_rotation"), leaves, ct, num_stages=2)
    state = opt.init(leaves)
    i = list(leaves).index("blocks/0/mlp/w_up_e")
    inner = state["inner"]["leaves"][i]
    assert tuple(inner["U"].shape) == (4, 256, 256) and tuple(inner["V"].shape) == (4, 64, 64)
    gen = torch.Generator().manual_seed(0)
    for st in state["inner"]["leaves"]:
        for v in st.values():
            v.copy_(torch.randn(v.shape, generator=gen))
    back = opt_state_from_numpy(opt_state_to_numpy(state), opt.init(leaves))
    for a, b in zip(back["inner"]["leaves"], state["inner"]["leaves"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_launcher_trains_mixtral_on_both_backends_with_the_kernel_calls(monkeypatch):
    """The launcher's sim and 1F1B paths with --use-kernels on the CPU: per
    step four grouped B4 calls holding six products per rotated leaf (sim:
    the expert stacks as problems of batch E = 4; 1F1B: batched over the
    stacked layers and experts) and one grouped B5 call."""
    from repro_torch.kernels import adam_step, ops

    calls = {"mm": [], "adam": [], "batches": set()}

    def mm(As, Bs, **kw):
        calls["mm"].append(len(As))
        calls["batches"] |= {a.shape[0] if a.ndim == 3 else 1 for a in As}
        return real_mm(As, Bs, **kw)

    def adam(gs, *args, **kw):
        calls["adam"].append(len(gs))
        return real_adam(gs, *args, **kw)

    real_mm, real_adam = ops.matmul_grouped, adam_step.adam_scale_grouped
    monkeypatch.setattr(ops, "matmul_grouped", mm)
    monkeypatch.setattr(adam_step, "adam_scale_grouped", adam)
    base = ["--arch", ARCH, "--smoke", "--stages", "2", "--steps", "2", "--batch", "4",
            "--seq", "16", "--use-kernels", "--log-every", "0", "--device", "cpu"]
    res = train.main(base)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    # 2 layers x (w_q, w_k, w_v, w_o, w_gate_e, w_up_e, w_down_e) = 14 rotated leaves
    assert calls["mm"] == [2 * 14, 2 * 14, 14, 14] * 2 and calls["adam"] == [14] * 2
    assert calls["batches"] == {1, 4}
    calls.update(mm=[], adam=[], batches=set())
    res = train.main(base + ["--backend", "spmd", "--schedule", "1f1b"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert calls["mm"] == [2 * 7, 2 * 7, 7, 7] * 2 and calls["adam"] == [7] * 2
    assert calls["batches"] == {2, 2 * 4}
