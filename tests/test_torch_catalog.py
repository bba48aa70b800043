"""The dense public architectures (qwen3_0_6b, qwen1_5_0_5b, stablelm_1_6b,
phi4_mini_3_8b and its sliding-window variant) in the port against the JAX
reference: configs, leaf paths and rotation plans, loss and gradients with
qk_norm and qkv_bias, the KV-cache decode path (full and ring-buffer
caches), weight carry-over, and short sim and SPMD 1F1B runs of qwen3's
reduced config at head dim 128 against the reference's engines."""
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
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.catalog import get_config as jget_config
from repro.core.layout import build_layout as jbuild_layout
from repro.core.layout import path_str as jpath_str
from repro.data.synthetic import batches as jbatches
from repro.engine.spmd import stack_stage_params as jstack
from repro.models.model import forward_decode as jforward_decode
from repro.models.model import forward_train as jforward_train
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro_torch.checkpoint.convert import (
    params_from_numpy,
    params_to_numpy,
    stacked_from_numpy,
    stacked_to_numpy,
)
from repro_torch.configs import ARCH_IDS, OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
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
from repro_torch.optim.factory import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3_0_6b", "qwen1_5_0_5b", "stablelm_1_6b", "phi4_mini_3_8b",
         "phi4_mini_3_8b_swa"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; torch's
    intra-op threads then fight the other workers for the cores, and these
    small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _fields_equal(ref, port, where):
    """Every field the port's dataclass keeps equals the reference's."""
    names = {f.name for f in dataclasses.fields(ref)} & {f.name for f in dataclasses.fields(port)}
    for n in sorted(names):
        r, p = getattr(ref, n), getattr(port, n)
        if n == "attention":
            _fields_equal(r, p, f"{where}.attention")
        elif n == "pattern":
            assert [(s.mixer, s.mlp) for s in r] == [(s.mixer, s.mlp) for s in p], where
        else:
            assert r == p, (where, n, r, p)


def _configs(arch, smoke=True, **kw):
    return (jget_config(arch, smoke).replace(scan_layers=False, **kw),
            tget_config(arch, smoke).replace(scan_layers=False, **kw))


def _perturbed_tree(cj, seed=0):
    """Reference weights with every 1-D leaf (norm scales and biases, the
    zero-initialised qkv biases and the unit qk norms) drawn at random, so
    that the biases and norms reach the loss with weights of their own."""
    tree = _np_tree(jinit_model(jax.random.PRNGKey(seed), cj))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (1.0 + 0.2 * rng.randn(*x.shape)).astype(x.dtype) if x.ndim == 1 else x, tree)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, smoke):
    ref, port = jget_config(arch, smoke), tget_config(arch, smoke)
    _fields_equal(ref, port, arch)
    assert port.compute_dtype == torch.bfloat16 and port.params_dtype == torch.float32


def test_catalog_ids_and_refusals():
    assert ARCH_IDS == ["stablelm_1_6b", "qwen3_0_6b", "qwen1_5_0_5b", "phi4_mini_3_8b",
                        "xlstm_1_3b"]
    assert tget_config("phi4-mini-3-8b-swa").attention.window == 8192
    assert tget_config("qwen3_0_6b_swa", smoke=True).name == "qwen3_0_6b_smoke"
    with pytest.raises(ValueError, match="sliding-window"):
        tget_config("qwen3_0_6b_swa")
    with pytest.raises(ValueError, match="unknown"):
        tget_config("gpt5")
    for arch, needs in (("mixtral_8x22b", "MoE"), ("deepseek_v2_236b", "MLA"),
                        ("jamba_v0_1_52b", "Mamba"), ("llava_next_34b", "vision"),
                        ("musicgen_large", "audio")):
        with pytest.raises(NotImplementedError, match=needs):
            tget_config(arch)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            train.build(train.parse_args(["--arch", arch, "--smoke", "--device", "cpu"]))


@pytest.mark.parametrize("arch,smoke", [(a, True) for a in ARCHS] + [("qwen3_0_6b", False)])
def test_leaf_paths_order_shapes_and_rotation_plan_match_reference(arch, smoke):
    """Paths, shapes and tree_flatten order of every leaf, and the rotation
    plan of each (the biases and qk norms are not rotated). At full
    qwen3_0_6b width: 196 rotated matrices, w_q 1024 x 2048, w_o 2048 x
    1024, w_gate and w_up 1024 x 3072, w_down 3072 x 1024."""
    cj, ct = _configs(arch, smoke)
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    port = param_leaves(Transformer(ct, device="meta", seed=None))
    assert [(k, tuple(p.shape)) for k, p in port.items()] == \
        [(jpath_str(p), tuple(x.shape)) for p, x in flat]
    for geometry in ("bilateral", "unilateral"):
        want = [dataclasses.astuple(p) for p in jbuild_layout(shapes, geometry)]
        assert [dataclasses.astuple(p) for p in build_layout(port, geometry)] == want
    plan = build_layout(port, "bilateral")
    for name in ("b_q", "b_k", "b_v", "q_norm", "k_norm"):
        assert not any(p.rotate for p in plan if p.path.endswith(name))
    if not smoke:
        rotated = {p.path.split("/", 2)[2]: p.shape for p in plan if p.rotate}
        assert sum(p.rotate for p in plan) == 196
        assert rotated == {"mixer/w_q": (1024, 2048), "mixer/w_k": (1024, 1024),
                           "mixer/w_v": (1024, 1024), "mixer/w_o": (2048, 1024),
                           "mlp/w_gate": (1024, 3072), "mlp/w_up": (1024, 3072),
                           "mlp/w_down": (3072, 1024)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_value_and_grad(arch):
    """float32 compute at the reduced config, 1-D leaves drawn at random:
    the loss within 1e-5 and every gradient leaf within 1e-4 relative of
    its largest entry, as tests/test_torch_model.py holds the paper model."""
    cj, ct = _configs(arch, dtype="float32")
    tree = _perturbed_tree(cj)
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


def test_new_leaves_round_trip_exactly_per_layer_and_stacked():
    cj, ct = _configs("qwen3_0_6b", dtype="float32")
    cj = cj.replace(attention=dataclasses.replace(cj.attention, qkv_bias=True))
    ct = ct.replace(attention=dataclasses.replace(ct.attention, qkv_bias=True))
    tree = _perturbed_tree(cj, seed=1)
    model = params_from_numpy(tree, ct, "cpu")
    assert {"blocks/1/mixer/b_q", "blocks/1/mixer/q_norm"} <= set(param_leaves(model))
    back = params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jtree = _np_tree(jstack(jax.tree.map(jnp.asarray, tree), cj, 2))
    stacked, shared = stacked_from_numpy(jtree, "cpu")
    assert tuple(stacked["mixer/b_q"].shape) == (2, 1, 4 * 32)
    assert tuple(stacked["mixer/k_norm"].shape) == (2, 1, 32)
    for a, b in zip(jax.tree_util.tree_leaves(stacked_to_numpy(stacked, shared)),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_qwen3_launcher_1f1b_launch_counts_on_cpu(monkeypatch, precision):
    """The launcher's 1F1B path for qwen3_0_6b's reduced config at smoke size,
    with the kernels' plain versions: per step B1 2*M*L calls and B2, B3 M*L
    in the policy's dtype; B4 four grouped calls holding six products per
    rotated leaf kind (seven: w_q, w_k, w_v, w_o, w_gate, w_up, w_down,
    each batched over the stacked layers) and B5 one grouped call holding
    the seven, as on the card (chip_smoke.py's catalog_1f1b)."""
    from repro_torch.kernels import adam_step, flash, ops

    calls = {}

    def counted(name, fn, key=None):
        def wrapped(*args, **kw):
            if name.startswith("flash"):
                calls.setdefault(name, set()).add(args[0].dtype)
            calls[name + "_n"] = calls.get(name + "_n", 0) + 1
            if key:
                calls.setdefault(key, []).append(len(args[0]))
            return fn(*args, **kw)
        return wrapped

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(flash, name, counted(name, getattr(flash, name)))
    monkeypatch.setattr(ops, "matmul_grouped", counted("mm", ops.matmul_grouped, "products"))
    monkeypatch.setattr(adam_step, "adam_scale_grouped",
                        counted("adam", adam_step.adam_scale_grouped, "leaves"))
    steps, K, L = 2, 2, 2
    res = train.main(["--arch", "qwen3_0_6b", "--smoke", "--backend", "spmd", "--schedule",
                      "1f1b", "--stages", str(K), "--steps", str(steps), "--batch", "4",
                      "--seq", "16", "--use-kernels", "--log-every", "0", "--device", "cpu",
                      "--precision", precision])
    assert len(res["losses"]) == steps and all(np.isfinite(res["losses"]))
    dt = {torch.float32} if precision == "f32" else {torch.bfloat16}
    ml = K * L
    assert calls == {"flash_fwd": dt, "flash_fwd_n": 2 * ml * steps,
                     "flash_bwd_dq": dt, "flash_bwd_dq_n": ml * steps,
                     "flash_bwd_dkv": dt, "flash_bwd_dkv_n": ml * steps,
                     "mm_n": 4 * steps, "products": [2 * 7, 2 * 7, 7, 7] * steps,
                     "adam_n": steps, "leaves": [7] * steps}


# the reference's decode consistency models (tests/test_models.py:44, :54)
DECODE_CASES = {
    "qk_norm_qkv_bias_gqa": dict(num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True,
                                 qkv_bias=True),
    "window_6": dict(num_heads=4, num_kv_heads=4, head_dim=16, window=6),
}
DB, DS, DV = 2, 12, 97


def _decode_all(model, toks):
    cache = init_cache(model.cfg, DB, DS, device="cpu")
    outs = []
    for t in range(DS):
        lg, cache = forward_decode(model, toks[:, t: t + 1], cache, t)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_reference_and_own_training_forward(case):
    """Teacher-forced decode over 12 tokens: the ring buffer of 6 slots
    wraps twice. The port's logits against the reference's decode (same
    weights, 1-D leaves at random) within 2e-5, and against the port's own
    forward_train within the reference's consistency tolerance, 2e-4."""
    shape = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=DV, scan_layers=False)
    cj = JModelConfig(attention=JAttentionConfig(**DECODE_CASES[case]),
                      pattern=(JBlockSpec("attn", "dense"),), **shape)
    ct = ModelConfig(attention=AttentionConfig(**DECODE_CASES[case]),
                     pattern=(BlockSpec("attn", "dense"),), **shape)
    tree = _perturbed_tree(cj, seed=2)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    toks = np.random.RandomState(3).randint(0, DV, size=(DB, DS))
    cache = jinit_cache(cj, DB, DS)
    want = []
    for t in range(DS):
        lg, cache = jforward_decode(params, cj, jnp.asarray(toks[:, t: t + 1]), cache,
                                    jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        got = _decode_all(model, tt)
        full, _ = forward_train(model, tt)
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-4, atol=2e-4)


def test_bf16_catalog_dtype_matches_reference():
    """qwen3_0_6b's reduced config in its own compute dtype (bfloat16 on
    float32 masters): training logits and decoded logits within bf16
    tolerance of the reference's. Both round to bf16 at each product, in
    orders that differ."""
    cj, ct = _configs("qwen3_0_6b")
    assert ct.compute_dtype == torch.bfloat16
    tree = _perturbed_tree(cj, seed=4)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    toks = np.random.RandomState(5).randint(0, ct.vocab_size, size=(DB, 8))
    tt = torch.from_numpy(toks.astype(np.int64))
    want, _ = jforward_train(params, cj, jnp.asarray(toks))
    cache = jinit_cache(cj, DB, 8)
    jdec = []
    for t in range(8):
        lg, cache = jforward_decode(params, cj, jnp.asarray(toks[:, t: t + 1]), cache,
                                    jnp.int32(t))
        jdec.append(np.asarray(lg[:, 0]))
    with torch.no_grad():
        got, _ = forward_train(model, tt)
        cache_t = init_cache(ct, DB, 8, device="cpu")
        assert all(c["k"].dtype == torch.bfloat16 for c in cache_t)
        dec = []
        for t in range(8):
            lg, cache_t = forward_decode(model, tt[:, t: t + 1], cache_t, t)
            dec.append(lg[:, 0])
    assert got.dtype == torch.float32  # logits_fp32
    # logits of magnitude up to ~4: measured 2.8e-2 apart (bf16 against float32
    # compute: 5.1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=4e-2)
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), np.stack(jdec, 1), rtol=0,
                               atol=4e-2)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen1_5_0_5b"])
def test_serve_decode_prefill_matches_training_forward(arch):
    """The serving loop on the CPU in float32 compute: the logits it decodes
    at the prompt's positions equal forward_train's on the prompt within the
    reference's consistency tolerance (2e-4), and it generates gen_len tokens
    a sequence; the launcher runs the catalog's own bf16 config."""
    cfg = tget_config(arch, smoke=True).replace(dtype="float32")
    res = serve_decode.serve(cfg, batch=3, prompt_len=6, gen_len=5, device=torch.device("cpu"))
    with torch.no_grad():
        full, _ = forward_train(res["model"], res["prompt"])
    np.testing.assert_allclose(res["prompt_logits"].numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
    assert tuple(res["generated"].shape) == (3, 5) and res["tokens_per_s"] > 0
    out = serve_decode.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "3", "--gen-len", "3"])
    assert out["model"].cfg.compute_dtype == torch.bfloat16
    assert tuple(out["generated"].shape) == (2, 3)


REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
sys.path.insert(0, "src")
import dataclasses, jax, json
from repro.configs.base import OptimizerConfig
from repro.configs.catalog import get_config
from repro.data import batches
from repro.engine import LoopConfig, SimEngine, SpmdEngine, run_loop
from repro.launch.mesh import make_mesh_compat
from repro.models import init_model
from repro.optim.factory import build_optimizer

cfg = get_config("qwen3_0_6b", smoke=True)
cfg = cfg.replace(scan_layers=False, dtype="float32",
                  attention=dataclasses.replace(cfg.attention, head_dim=128))
steps, K = int(sys.argv[1]), 2
ocfg = OptimizerConfig(total_steps=steps, **json.loads(sys.argv[2]))
params = init_model(jax.random.PRNGKey(0), cfg)
print("ready", flush=True)
sim = SimEngine(cfg, build_optimizer(ocfg, params, cfg, num_stages=K))
_, sim_losses = run_loop(sim, batches(cfg, 4, 16, seed=0), LoopConfig(steps=steps),
                         state=sim.init_state(params=params))
eng = SpmdEngine(cfg, ocfg, num_stages=K, num_microbatches=K, schedule="1f1b",
                 mesh=make_mesh_compat((K, 1), ("stage", "data")), use_kernels=True)
_, spmd_losses = run_loop(eng, batches(cfg, 4, 16, seed=0), LoopConfig(steps=steps),
                          state=eng.init_state(params=params))
print(json.dumps({"sim": sim_losses, "spmd_1f1b": spmd_losses}))
"""
RUN_STEPS = 4
RUN_OPT = {"name": "adam", "learning_rate": 1e-3, "schedule": "constant"}


def test_qwen3_head_dim_128_runs_track_the_reference_engines():
    """qwen3_0_6b's reduced config at head dim 128 (qk_norm, GQA 4/2,
    SwiGLU), float32: 4 steps of the sim backend (2 stages) and of the
    SPMD 1F1B schedule with the flash kernels' plain versions against the
    reference's engines (its SPMD engine on two forced host devices, in a
    subprocess that starts first and compiles while the port runs here).
    Adam differs by float32 roundoff: 1e-4."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, str(RUN_STEPS),
                             json.dumps(RUN_OPT)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        cj, ct = _configs("qwen3_0_6b", dtype="float32")
        cj = cj.replace(attention=dataclasses.replace(cj.attention, head_dim=128))
        ct = ct.replace(attention=dataclasses.replace(ct.attention, head_dim=128))
        tree = _np_tree(jinit_model(jax.random.PRNGKey(0), cj))
        ocfg = OptimizerConfig(total_steps=RUN_STEPS, **RUN_OPT)
        model = params_from_numpy(tree, ct, "cpu")
        sim = SimEngine(model, build_optimizer(ocfg, param_leaves(model), ct, num_stages=2))
        _, sim_losses, _ = run_loop(sim, batches(ct, 4, 16, seed=0, device="cpu"),
                                    LoopConfig(steps=RUN_STEPS))
        eng = SpmdEngine(ct, ocfg, num_stages=2, num_microbatches=2, schedule="1f1b",
                         use_kernels=True, device="cpu")
        pair = stacked_from_numpy(_np_tree(jstack(jax.tree.map(jnp.asarray, tree), cj, 2)),
                                  "cpu")
        _, spmd_losses, _ = run_loop(eng, batches(ct, 4, 16, seed=0, device="cpu"),
                                     LoopConfig(steps=RUN_STEPS), state=eng.init_state(pair))
        assert proc.stdout.readline().strip() == "ready"
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for name, got in (("sim", sim_losses), ("spmd_1f1b", spmd_losses)):
        assert len(got) == RUN_STEPS and all(np.isfinite(got)), (name, got)
        assert max(abs(a - b) for a, b in zip(got, want[name])) < 1e-4, (name, got, want[name])
