"""The xLSTM family (xlstm_1_3b: mLSTM and sLSTM blocks in a mixed pattern,
their recurrent decode) in the port against the JAX reference: the mixers
and their decode caches, the query-blocked mLSTM, the smoke model's loss and
every gradient leaf, train/decode consistency, leaf paths and rotation
plans (at smoke size and at the full-width 8-layer cut), launcher sim runs
from shared weights, the spmd backend's refusal of mixed patterns, a
checkpoint crossing between the packages, and the kernels' calls per step.
The mixers and B4 at the xLSTM path's shapes on the card are in
``tests/test_torch_cuda.py``."""
import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs.base import PRECISION_POLICIES as JPRECISION_POLICIES
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.catalog import get_config as jget_config
from repro.core.layout import build_layout as jbuild_layout
from repro.core.layout import path_str as jpath_str
from repro.data.synthetic import batches as jbatches
from repro.engine import LoopConfig as JLoopConfig
from repro.engine import SimEngine as JSimEngine
from repro.engine import run_loop as jrun_loop
from repro.launch import train as jtrain
from repro.models import xlstm as jxl
from repro.models.model import forward_decode as jforward_decode
from repro.models.model import forward_train as jforward_train
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro.pipeline.partition import leaf_delays as jleaf_delays
from repro.pipeline.partition import leaf_stages as jleaf_stages
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.convert import copy_params_from_numpy, params_from_numpy
from repro_torch.configs import ARCH_IDS, OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import BlockSpec, ModelConfig, SSMConfig
from repro_torch.core.layout import build_layout
from repro_torch.engine import SimEngine, run_loop
from repro_torch.launch import serve_decode, train
from repro_torch.models import (
    Transformer,
    forward_decode,
    forward_train,
    init_cache,
    loss_fn,
    param_leaves,
)
from repro_torch.models import xlstm as txl
from repro_torch.models.transformer import template_block
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.partition import leaf_delays, leaf_stages

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

SCFG = dict(kind="mlstm", num_heads=4, proj_factor=2.0)
D_MODEL, B, S = 64, 2, 16
# two implementations of one training step (tests/test_engine.py:437-438):
# Adam differs by float32 roundoff, basis rotation by its QR refreshes
TOLS = {"adam": (1e-4, 1e-4), "basis_rotation": (2e-3, 5e-2)}
# the reference's train/decode consistency tolerance (tests/test_models.py:83-89)
CONSISTENCY_TOL = 1e-3


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, seed):
    """Reference weights with noise on every 1-D leaf (gate biases, skip
    scales, output and block norms), so that each reaches the output with
    values of its own."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (x + 0.2 * rng.randn(*x.shape)).astype(x.dtype) if x.ndim == 1 else x,
        _np_tree(tree))


def _torch_dict(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _mixer_weights(kind, seed=0):
    init = jxl.init_mlstm if kind == "mlstm" else jxl.init_slstm
    tree = _perturbed(init(jax.random.PRNGKey(seed), D_MODEL, JSSMConfig(**SCFG), jnp.float32),
                      seed)
    return tree, _torch_dict(tree)


def _inputs(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _configs(smoke=True, **kw):
    return (jget_config("xlstm_1_3b", smoke).replace(scan_layers=False, **kw),
            tget_config("xlstm_1_3b", smoke).replace(scan_layers=False, **kw))


# ---------------------------------------------------------------------------
# configs and leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ref, port = jget_config("xlstm_1_3b", smoke), tget_config("xlstm_1_3b", smoke)
    names = {f.name for f in dataclasses.fields(ref)} & {f.name for f in dataclasses.fields(port)}
    for n in sorted(names - {"attention", "ssm", "pattern"}):
        assert getattr(ref, n) == getattr(port, n), n
    assert dataclasses.asdict(ref.ssm) == dataclasses.asdict(port.ssm)
    assert dataclasses.asdict(ref.attention).items() >= dataclasses.asdict(port.attention).items()
    assert [(s.mixer, s.mlp) for s in ref.pattern] == [(s.mixer, s.mlp) for s in port.pattern]
    assert "xlstm_1_3b" in ARCH_IDS
    assert port.compute_dtype == torch.bfloat16 and port.params_dtype == torch.float32


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full_width_8_layers"])
def test_leaf_paths_order_shapes_and_rotation_plan_match_reference(smoke):
    """Paths, shapes and tree_flatten order of every leaf, the rotation plan
    of each, and each leaf's pipeline stage and delay (sim layout, 2 and 8
    stages). At full width, cut to one superblock of 8 layers (the chip's
    cut): 39 rotated leaves, the 3-D w_r among them, and the gate
    projections w_i, w_f (4096 x 4) under min_dim."""
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
    plan = build_layout(port, "bilateral")
    assert not any(p.rotate for p in plan if p.path.rsplit("/", 1)[-1] in (
        "b_i", "b_f", "w_i", "w_f", "bias", "skip_scale", "out_norm", "scale"))
    if not smoke:
        rotated = {}
        for p in plan:
            if p.rotate:
                rotated.setdefault(p.path.split("/", 2)[2], set()).add(p.shape)
        assert sum(p.rotate for p in plan) == 39
        assert rotated == {
            "mixer/up_proj": {(2048, 8192)}, "mixer/w_q": {(4096, 4096)},
            "mixer/w_k": {(4096, 4096)}, "mixer/w_v": {(4096, 4096)},
            "mixer/down_proj": {(4096, 2048)}, "mixer/w_x": {(2048, 8192)},
            "mixer/w_r": {(4, 512, 2048)}, "mixer/ff_up": {(2048, 2662)},
            "mixer/ff_down": {(2662, 2048)}}
        assert sum(p.numel() for p in port.values()) == 766_689_336


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_train_matches_reference(kind):
    """mlstm_train and slstm_train on the same weights and input, float32:
    within 1e-5 (the sLSTM's input product runs once before its loop)."""
    tree, w = _mixer_weights(kind)
    u = _inputs((B, S, D_MODEL))
    jfn, tfn = ((jxl.mlstm_train, txl.mlstm_train) if kind == "mlstm"
                else (jxl.slstm_train, txl.slstm_train))
    want = np.asarray(jfn(jax.tree.map(jnp.asarray, tree), jnp.asarray(u), JSSMConfig(**SCFG)))
    got = tfn(w, torch.from_numpy(u), SSMConfig(**SCFG))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_decode_and_cache_match_reference(kind):
    """Six decode steps from the zeroed cache: every output and every cache
    tensor within 1e-5 of the reference's, with the cache dtypes of the
    reference (sLSTM's h in the compute dtype, the rest float32)."""
    tree, w = _mixer_weights(kind, seed=2)
    jcfg, tcfg = JSSMConfig(**SCFG), SSMConfig(**SCFG)
    u = _inputs((B, 6, D_MODEL), seed=3)
    if kind == "mlstm":
        jcache = jxl.init_mlstm_cache(B, D_MODEL, jcfg, jnp.float32)
        tcache = txl.init_mlstm_cache(B, D_MODEL, tcfg, "cpu")
        jfn, tfn = jxl.mlstm_decode, txl.mlstm_decode
    else:
        jcache = jxl.init_slstm_cache(B, D_MODEL, jcfg, jnp.float32)
        tcache = txl.init_slstm_cache(B, D_MODEL, tcfg, torch.float32, "cpu")
        jfn, tfn = jxl.slstm_decode, txl.slstm_decode
    assert sorted(jcache) == sorted(tcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(jcache[k]))
    params = jax.tree.map(jnp.asarray, tree)
    for t in range(u.shape[1]):
        jy, jcache = jfn(params, jnp.asarray(u[:, t: t + 1]), jcache, jcfg)
        ty, tcache = tfn(w, torch.from_numpy(u[:, t: t + 1]), tcache, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        for k in jcache:
            assert tcache[k].dtype == torch.float32
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {t} cache {k}")


def test_query_blocked_mlstm_equals_dense_and_reference(monkeypatch):
    """Thresholds cut as in tests/test_models.py:145-157: 4 query blocks of
    8. The blocked form equals the dense one (1e-4), output and input
    gradient, and the reference's blocked form (1e-5)."""
    tree, w = _mixer_weights("mlstm", seed=4)
    u = _inputs((B, 32, D_MODEL), seed=5)
    cfg = SSMConfig(**SCFG)
    for mod in (jxl, txl):
        monkeypatch.setattr(mod, "MLSTM_CHUNK_THRESHOLD", 8)
        monkeypatch.setattr(mod, "MLSTM_QUERY_BLOCK", 8)
    want = np.asarray(jxl.mlstm_train(jax.tree.map(jnp.asarray, tree), jnp.asarray(u),
                                      JSSMConfig(**SCFG)))

    def run():
        x = torch.from_numpy(u).requires_grad_()
        y = txl.mlstm_train(w, x, cfg)
        (g,) = torch.autograd.grad(y.square().sum(), x)
        return y.detach().numpy(), g.numpy()

    blocked, g_blocked = run()
    monkeypatch.setattr(txl, "MLSTM_CHUNK_THRESHOLD", 10_000)
    dense, g_dense = run()
    np.testing.assert_allclose(blocked, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(blocked, dense, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_blocked, g_dense, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_loss_and_every_gradient_leaf_match_value_and_grad():
    """The smoke xlstm_1_3b (an mLSTM and an sLSTM block) in float32 compute,
    1-D leaves perturbed: the loss within 1e-5 and every gradient leaf within
    rtol 1e-4, atol 1e-4 of its largest entry."""
    cj, ct = _configs(dtype="float32")
    tree = _perturbed(jinit_model(jax.random.PRNGKey(0), cj), 0)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    batch = next(jbatches(cj, 2, 32, seed=0))
    (loss_j, _), grads_j = jax.value_and_grad(jloss_fn, has_aux=True)(params, cj, batch)
    bt = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()}
    loss_t, _ = loss_fn(model, bt)
    leaves = param_leaves(model)
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    assert [jpath_str(p) for p, _ in flat] == list(leaves)
    for (p, gj), gt in zip(flat, grads_t):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(gj).max()) + 1e-7,
                                   err_msg=jpath_str(p))


def test_train_decode_consistency_and_decode_against_reference():
    """The reference's xLSTM consistency model (tests/test_models.py:83-89:
    d_model 64, an mLSTM and an sLSTM block, vocab 97, batch 2, 16 tokens):
    the port's decoded logits against its own forward_train within the
    reference's 1e-3, and against the reference's decode within 1e-5."""
    shape = dict(num_layers=2, d_model=64, d_ff=0, vocab_size=97, scan_layers=False)
    cj = JModelConfig(ssm=JSSMConfig(**SCFG),
                      pattern=(JBlockSpec("mlstm", "none"), JBlockSpec("slstm", "none")), **shape)
    ct = ModelConfig(ssm=SSMConfig(**SCFG),
                     pattern=(BlockSpec("mlstm", "none"), BlockSpec("slstm", "none")), **shape)
    tree = _perturbed(jinit_model(jax.random.PRNGKey(0), cj), 6)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    toks = np.random.RandomState(7).randint(0, 97, size=(B, S))
    jcache, want = jinit_cache(cj, B, S), []
    for t in range(S):
        lg, jcache = jforward_decode(params, cj, jnp.asarray(toks[:, t: t + 1]), jcache,
                                     jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache, got = init_cache(ct, B, S, device="cpu"), []
        assert [sorted(c) for c in cache] == [["C", "m", "n"], ["c", "h", "m", "n"]]
        for t in range(S):
            lg, cache = forward_decode(model, tt[:, t: t + 1], cache, t)
            got.append(lg[:, 0])
        got = torch.stack(got, 1).numpy()
        full, _ = forward_train(model, tt)
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, full.numpy(), rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


def test_bf16_compute_matches_reference():
    """The smoke config in its own compute dtype (bfloat16 on float32
    masters): training logits within bf16 tolerance of the reference's.
    Both round to bf16 at each product, in orders that differ, and the
    sLSTM carries its bf16 h through the recurrence."""
    cj, ct = _configs()
    assert ct.compute_dtype == torch.bfloat16
    tree = _perturbed(jinit_model(jax.random.PRNGKey(0), cj), 8)
    model = params_from_numpy(tree, ct, "cpu")
    toks = np.random.RandomState(9).randint(0, ct.vocab_size, size=(B, 16))
    want, _ = jforward_train(jax.tree.map(jnp.asarray, tree), cj, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = forward_train(model, torch.from_numpy(toks.astype(np.int64)))
    assert got.dtype == torch.float32  # logits_fp32
    # logits of magnitude up to ~4: measured 2.6e-2 apart (bf16 against float32
    # compute: 8.9e-2); the tolerance of tests/test_torch_catalog.py's bf16 test
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=4e-2)


def test_serve_decode_prefill_matches_training_forward():
    """The serving loop on the CPU in float32 compute: the logits decoded at
    the prompt's positions equal forward_train's within the consistency
    tolerance; the launcher serves the config's own bf16."""
    cfg = tget_config("xlstm_1_3b", smoke=True).replace(dtype="float32")
    res = serve_decode.serve(cfg, batch=3, prompt_len=6, gen_len=5, device=torch.device("cpu"))
    with torch.no_grad():
        full, _ = forward_train(res["model"], res["prompt"])
    np.testing.assert_allclose(res["prompt_logits"].numpy(), full.numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    assert tuple(res["generated"].shape) == (3, 5) and res["tokens_per_s"] > 0
    out = serve_decode.main(["--arch", "xlstm_1_3b", "--smoke", "--device", "cpu", "--batch",
                             "2", "--prompt-len", "3", "--gen-len", "3"])
    assert out["model"].cfg.compute_dtype == torch.bfloat16
    assert tuple(out["generated"].shape) == (2, 3)


# ---------------------------------------------------------------------------
# the launcher, the optimizer's kernels, checkpoints
# ---------------------------------------------------------------------------


LAUNCH = ["--arch", "xlstm_1_3b", "--smoke", "--stages", "2", "--steps", "6", "--batch", "4",
          "--seq", "32", "--log-every", "0"]


@pytest.mark.parametrize("optimizer", ["adam", "basis_rotation"])
def test_launcher_sim_runs_track_the_reference_launcher(tmp_path, optimizer):
    """Both launchers' sim trainers (2 stages, 6 steps) from the reference
    launcher's weights on the same stream: the reference's through its own
    main (XLA path), the port's built by its launcher, weights carried over,
    through the kernels' plain versions. Losses within the tolerances of two
    implementations of the step."""
    out = str(tmp_path / "ref.json")
    jtrain.main(LAUNCH + ["--optimizer", optimizer, "--out", out])
    with open(out) as f:
        want = json.load(f)["losses"]
    cj = JPRECISION_POLICIES["f32"].apply(
        jget_config("xlstm_1_3b", smoke=True).replace(scan_layers=False))
    tree = _np_tree(jinit_model(jax.random.PRNGKey(0), cj))
    engine, data, loop_cfg = train.build(train.parse_args(
        LAUNCH + ["--optimizer", optimizer, "--use-kernels", "--device", "cpu"]))
    copy_params_from_numpy(param_leaves(engine.model), tree)
    _, got, _ = run_loop(engine, data, loop_cfg)
    first2, every = TOLS[optimizer]
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(got) == len(want) == 6 and all(np.isfinite(got)), (got, want)
    assert max(diffs[:2]) < first2 and max(diffs) < every, (got, want)


def test_spmd_backend_refuses_mixed_patterns():
    """The reference's SPMD runtime stacks whole layer trees and applies
    cfg.pattern[0] to every layer, so a mixed pattern is refused before
    any work, naming why; the sim backend takes it."""
    args = ["--arch", "xlstm_1_3b", "--smoke", "--backend", "spmd", "--device", "cpu"]
    with pytest.raises(SystemExit, match="homogeneous stacks only"):
        train.build(train.parse_args(args))
    with pytest.raises(ValueError, match="mixed block kinds .*mlstm/none, slstm/none"):
        template_block(tget_config("xlstm_1_3b", smoke=True))
    homogeneous = tget_config("xlstm_1_3b", smoke=True).replace(
        pattern=(BlockSpec("mlstm", "none"),))
    assert template_block(homogeneous).spec == BlockSpec("mlstm", "none")


def test_optimizer_kernel_calls_per_step_on_cpu(monkeypatch):
    """The sim path's basis rotation with --use-kernels on the smoke config:
    per step four grouped B4 calls holding six products per rotated leaf
    (nine: up_proj, w_q, w_k, w_v, down_proj, w_x, the 3-D w_r, ff_up,
    ff_down) and one grouped B5 call over the nine, as on the card; w_r goes
    in as one problem of batch 4 (its heads)."""
    from repro_torch.kernels import adam_step, ops

    calls = {"mm": [], "adam": [], "batches": set()}

    def mm(As, Bs, **kw):
        calls["mm"].append(len(As))
        calls["batches"] |= {tuple(a.shape[:-2]) for a in As}
        return real_mm(As, Bs, **kw)

    def adam(gs, *args):
        calls["adam"].append(len(gs))
        return real_adam(gs, *args)

    real_mm, real_adam = ops.matmul_grouped, adam_step.adam_scale_grouped
    monkeypatch.setattr(ops, "matmul_grouped", mm)
    monkeypatch.setattr(adam_step, "adam_scale_grouped", adam)
    steps = 2
    res = train.main(["--arch", "xlstm_1_3b", "--smoke", "--stages", "2", "--steps", str(steps),
                      "--batch", "2", "--seq", "16", "--use-kernels", "--log-every", "0",
                      "--device", "cpu"])
    assert len(res["losses"]) == steps and all(np.isfinite(res["losses"]))
    assert calls["mm"] == [2 * 9, 2 * 9, 9, 9] * steps
    assert calls["adam"] == [9] * steps
    assert calls["batches"] == {(1,), (4,)}


def test_checkpoint_crosses_between_the_packages(tmp_path):
    """The reference trains the smoke xlstm_1_3b 3 steps (2 stages, basis
    rotation refreshing every 2) and saves; the port loads it into its sim
    engine and saves it again: the same manifest, byte for byte, and every
    leaf bitwise, the 3-D w_r with its (4, 64, 64) and (4, 256, 256) bases
    and the 1-D gate biases with their moments among them."""
    cj, ct = _configs(dtype="float32")
    ocfg = {"name": "basis_rotation", "learning_rate": 1e-3, "rotation_freq": 2}
    params = jinit_model(jax.random.PRNGKey(0), cj)
    jeng = JSimEngine(cj, jbuild_optimizer(JOptimizerConfig(total_steps=6, **ocfg), params, cj,
                                           num_stages=2))
    state, _ = jrun_loop(jeng, jbatches(cj, 2, 16, seed=0), JLoopConfig(steps=3),
                         state=jeng.init_state(params=params))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jsave_checkpoint(ref_dir, jeng.checkpoint_tree(state), step=3, meta={})

    model = params_from_numpy(_np_tree(params), ct, "cpu")
    teng = SimEngine(model, build_optimizer(OptimizerConfig(total_steps=6, **ocfg),
                                            param_leaves(model), ct, num_stages=2,
                                            use_kernels=True))
    tree, step, meta = ckpt.load_checkpoint(ref_dir)
    loaded = teng.load_state(tree)
    w_r = list(param_leaves(model)).index("blocks/1/mixer/w_r")
    st = loaded.opt_state["inner"]["leaves"][w_r]
    assert tuple(st["U"].shape) == (4, 64, 64) and tuple(st["V"].shape) == (4, 256, 256)
    teng.save_checkpoint(port_dir, loaded, step=step, meta=meta)
    with open(os.path.join(ref_dir, "manifest.json")) as f, \
            open(os.path.join(port_dir, "manifest.json")) as g:
        assert f.read() == g.read()
    a, b = jload_checkpoint(ref_dir)[0], jload_checkpoint(port_dir)[0]
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
