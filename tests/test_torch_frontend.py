"""The modality frontends in the port against the JAX reference:
llava_next_34b (a projected vision prefix before the text, logits over the
text only) and musicgen_large (four codebooks summed at the input and
predicted by one head each). Configs, leaf paths and rotation plans, the
synthetic batches with their prefix and codebooks, loss and gradients,
short sim runs against the reference's ``run_sim_training``, musicgen's
decode, and the refusals where the reference is wrong."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.catalog import get_config as jget_config
from repro.core.layout import build_layout as jbuild_layout
from repro.core.layout import path_str as jpath_str
from repro.data.synthetic import batches as jbatches
from repro.models.model import forward_decode as jforward_decode
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro.pipeline.simulate import run_sim_training as jrun_sim_training
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.core.layout import build_layout
from repro_torch.data import batches, sharded_batches
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
from repro_torch.pipeline.partition import delay_tree

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ARCHS = ["llava_next_34b", "musicgen_large"]
# two implementations of the sim step with Adam differ by float32 roundoff
# (tests/test_torch_xlstm.py's tolerance)
ADAM_TOL = 1e-4
# basis rotation: (first two losses, every loss), the reference's tolerance
# for two implementations of its step (tests/test_engine.py:437-438)
ROTATION_TOLS = (2e-3, 5e-2)
# the reference's train/decode consistency tolerance (tests/test_models.py:35)
CONSISTENCY_TOL = 2e-4


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


def _configs(arch, smoke=True, **kw):
    return (jget_config(arch, smoke).replace(scan_layers=False, **kw),
            tget_config(arch, smoke).replace(scan_layers=False, **kw))


def _perturbed_tree(cj, seed=0):
    """Reference weights with every 1-D leaf (norm scales and biases) drawn
    at random, so that they reach the loss with weights of their own."""
    tree = _np_tree(jinit_model(jax.random.PRNGKey(seed), cj))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (1.0 + 0.2 * rng.randn(*x.shape)).astype(x.dtype) if x.ndim == 1 else x, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64 if k != "frontend"
                                                       else np.float32))
            for k, v in batch.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch, smoke):
    ref, port = jget_config(arch, smoke), tget_config(arch, smoke)
    ours = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        if f.name not in ours:
            continue
        r, p = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "attention":
            assert dataclasses.astuple(r) == dataclasses.astuple(p), (arch, f.name)
        elif f.name == "pattern":
            assert [(s.mixer, s.mlp) for s in r] == [(s.mixer, s.mlp) for s in p]
        else:
            assert r == p, (arch, f.name, r, p)
    for name in ("frontend", "frontend_tokens", "frontend_dim", "num_codebooks"):
        assert name in ours
    assert port.compute_dtype == torch.bfloat16 and port.params_dtype == torch.float32


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_paths_order_shapes_and_rotation_plan_match_reference(arch, smoke):
    """Paths, shapes and tree_flatten order of every leaf and the rotation
    plan of each (the full configs on the meta device): the embedding (K, V,
    d) with codebooks, the head (d, K V), ``frontend_proj`` only where the
    prefix has a width, none of them rotated."""
    cj, ct = _configs(arch, smoke)
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    port = param_leaves(Transformer(ct, device="meta", seed=None))
    assert [(k, tuple(p.shape)) for k, p in port.items()] == \
        [(jpath_str(p), tuple(x.shape)) for p, x in flat]
    for geometry in ("bilateral", "unilateral"):
        want = [dataclasses.astuple(p) for p in jbuild_layout(shapes, geometry)]
        assert [dataclasses.astuple(p) for p in build_layout(port, geometry)] == want
    plan = {p.path: p for p in build_layout(port, "bilateral")}
    d, V, K = ct.d_model, ct.vocab_size, ct.num_codebooks
    assert tuple(port["embed/embedding"].shape) == ((K, V, d) if K > 1 else (V, d))
    assert tuple(port["lm_head"].shape) == (d, K * V)
    has_proj = bool(ct.frontend_dim)
    assert ("frontend_proj" in port) == has_proj
    if has_proj:
        assert tuple(port["frontend_proj"].shape) == (ct.frontend_dim, d)
    assert not any(plan[k].rotate for k in ("embed/embedding", "lm_head", "frontend_proj")
                   if k in plan)
    if not smoke:
        rotated = {k.split("/", 2)[2]: p.shape for k, p in plan.items()
                   if p.rotate and k.startswith("blocks/0/")}
        f = ct.d_ff
        want = {"mixer/w_q": (d, ct.attention.q_dim), "mixer/w_o": (ct.attention.q_dim, d),
                "mixer/w_k": (d, ct.attention.num_kv_heads * ct.attention.head_dim),
                "mixer/w_v": (d, ct.attention.num_kv_heads * ct.attention.head_dim),
                "mlp/w_up": (d, f), "mlp/w_down": (f, d)}
        if ct.mlp_act == "swiglu":
            want["mlp/w_gate"] = (d, f)
        assert rotated == want
        assert sum(p.rotate for p in plan.values()) == len(want) * ct.num_layers


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_are_bit_identical_with_prefix_and_codebooks(arch, smoke):
    """Tokens and labels (B, S) or (B, S, K), the K codebooks drawn in turn
    from the one stream, and the prefix (B, P, frontend_dim) from its own
    RandomState(seed + 7): bit for bit the reference's, three batches deep;
    each host's shard is its rows of every key."""
    cj, ct = _configs(arch, smoke)
    vocab = min(cj.vocab_size, 512)  # the full vocabularies' streams are slower, not different
    cj, ct = cj.replace(vocab_size=vocab), ct.replace(vocab_size=vocab)
    ref = jbatches(cj, 2, 8, seed=3)
    port = batches(ct, 2, 8, seed=3, device="cpu")
    shards = [sharded_batches(ct, 2, 8, 2, h, seed=3, device="cpu") for h in range(2)]
    want_keys = {"tokens", "labels"} | ({"frontend"} if ct.frontend_tokens else set())
    for _ in range(3):
        rb, pb = next(ref), next(port)
        assert set(pb) == set(rb) == want_keys
        for k in rb:
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]), err_msg=k)
        assert pb["tokens"].dtype == torch.int64
        if ct.num_codebooks > 1:
            assert tuple(pb["tokens"].shape) == (2, 8, ct.num_codebooks)
        if "frontend" in pb:
            assert pb["frontend"].dtype == torch.float32
            assert tuple(pb["frontend"].shape) == (2, ct.frontend_tokens,
                                                  ct.frontend_dim or ct.d_model)
        for h, it in enumerate(shards):
            sb = next(it)
            assert set(sb) == want_keys
            for k in sb:
                torch.testing.assert_close(sb[k], pb[k][h: h + 1], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_the_reference(arch):
    """float32 compute at the reduced config, 1-D leaves drawn at random,
    the reference's batch with its prefix: the loss within 1e-5 and every
    gradient leaf (frontend_proj, the codebook embedding and head included)
    within 1e-4 relative of its largest entry."""
    cj, ct = _configs(arch, dtype="float32")
    tree = _perturbed_tree(cj)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    batch = next(jbatches(cj, 2, 16, seed=0))
    assert ("frontend" in batch) and (batch["tokens"].ndim == (3 if ct.num_codebooks > 1 else 2))
    (loss_j, _), grads_j = jax.value_and_grad(jloss_fn, has_aux=True)(params, cj, batch)
    loss_t, metrics = loss_fn(model, _torch_batch(batch))
    leaves = param_leaves(model)
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    assert float(metrics["aux"]) == 0.0
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    assert [jpath_str(p) for p, _ in flat] == list(leaves)
    for (p, gj), gt in zip(flat, grads_t):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0, jpath_str(p)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(gj).max()) + 1e-7,
                                   err_msg=jpath_str(p))


def test_logits_cover_the_text_and_the_prefix_changes_them():
    """llava's logits are (B, S, V) over the S text positions after a
    prefix of P; the prefix reaches them. musicgen's are (B, S, K, V)."""
    _, ct = _configs("llava_next_34b", dtype="float32")
    model = Transformer(ct, device="cpu", seed=0)
    b = next(batches(ct, 2, 8, seed=0, device="cpu"))
    with torch.no_grad():
        logits, _ = forward_train(model, b["tokens"], b["frontend"])
        other, _ = forward_train(model, b["tokens"], b["frontend"] * 3.0)
    assert tuple(logits.shape) == (2, 8, ct.vocab_size)
    assert (logits - other).abs().max() > 1e-4
    _, ct = _configs("musicgen_large", dtype="float32")
    model = Transformer(ct, device="cpu", seed=0)
    b = next(batches(ct, 2, 8, seed=0, device="cpu"))
    with torch.no_grad():
        logits, _ = forward_train(model, b["tokens"], b["frontend"])
    assert tuple(logits.shape) == (2, 8, ct.num_codebooks, ct.vocab_size)


def _sim_losses(arch, **ocfg):
    """3 steps of both packages' sim backends on 2 stages, float32, from the
    same weights and stream (prefix and codebooks included): (port's,
    reference's)."""
    steps, K = 3, 2
    cj, ct = _configs(arch, dtype="float32")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_sim_runs_track_the_reference(arch):
    """Adam: the port's ``SimEngine`` against the reference's
    ``run_sim_training`` (``_sim_losses``)."""
    got, want = _sim_losses(arch, name="adam")
    assert max(abs(a - b) for a, b in zip(got, want)) < ADAM_TOL, (got, want)


def test_llava_sim_run_with_basis_rotation_tracks_the_reference():
    """Basis rotation with refreshes at steps 0 and 2, ``frontend_proj``
    rotated beside the blocks' leaves, B4 and B5 through their plain
    versions: the port's ``SimEngine`` against the reference's
    ``run_sim_training``."""
    got, want = _sim_losses("llava_next_34b", name="basis_rotation", rotation_freq=2)
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert max(diffs[:2]) < ROTATION_TOLS[0] and max(diffs) < ROTATION_TOLS[1], (got, want)


def test_musicgen_decode_matches_reference_and_training_forward():
    """Teacher-forced decode of (B, 1, K) tokens: (B, 1, K, V) logits
    against the reference's decode within 2e-5, and against the port's own
    forward_train (no prefix) within the consistency tolerance."""
    cj, ct = _configs("musicgen_large", dtype="float32")
    tree = _perturbed_tree(cj, seed=2)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tree, ct, "cpu")
    B, S, Kc = 2, 6, ct.num_codebooks
    toks = np.random.RandomState(3).randint(0, ct.vocab_size, size=(B, S, Kc))
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
            assert tuple(lg.shape) == (B, 1, Kc, ct.vocab_size)
            got.append(lg[:, 0])
        full, _ = forward_train(model, tt)
    got = torch.stack(got, 1)
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=CONSISTENCY_TOL,
                               atol=CONSISTENCY_TOL)


def test_weights_round_trip_exactly():
    """The (K, V, d) embedding, the (d, K V) head and frontend_proj cross
    between the packages bit for bit."""
    for arch in ARCHS:
        cj, ct = _configs(arch)
        tree = _perturbed_tree(cj, seed=1)
        back = params_to_numpy(params_from_numpy(tree, ct, "cpu"))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_spmd_and_no_stash_refusals_name_the_reference(arch):
    """On the spmd backend the reference's engine drops the prefix and
    misreads codebook batches, so the launcher (and the engine) refuse both
    configs by name; the sim backend's --no-stash drops the prefix in the
    reference's two-version loss, so it is refused where there is one."""
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--stages", "2"]
    with pytest.raises(SystemExit, match=r"spmd backend.*repro/engine/spmd.py:419-428"):
        train.build(train.parse_args(base + ["--backend", "spmd"]))
    _, ct = _configs(arch)
    with pytest.raises(ValueError, match="frontend config"):
        SpmdEngine(ct, OptimizerConfig(), num_stages=2, device="cpu")
    with pytest.raises(SystemExit, match=r"--no-stash.*repro/pipeline/simulate.py:126-135"):
        train.build(train.parse_args(base + ["--no-stash"]))
    # musicgen's full config has no prefix: its --no-stash is not refused
    args = train.parse_args(["--arch", "musicgen_large", "--no-stash", "--device", "cpu"])
    train._refuse_unported(args, tget_config("musicgen_large"))


def test_launcher_trains_both_on_the_sim_backend_and_decode_refuses_codebooks():
    """Both frontends train through the launcher on the sim backend; the
    serving launcher, which refused several codebooks until they were
    ported, now decodes musicgen's four a step in its own bf16."""
    for arch in ARCHS:
        res = train.main(["--arch", arch, "--smoke", "--stages", "2", "--steps", "2",
                          "--batch", "2", "--seq", "8", "--use-kernels", "--log-every", "0",
                          "--device", "cpu"])
        assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    out = serve_decode.main(["--arch", "musicgen_large", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "3", "--gen-len", "3"])
    assert out["model"].cfg.compute_dtype == torch.bfloat16
    assert tuple(out["generated"].shape) == (2, 3, 4)


def test_serve_decode_generates_every_codebook_as_the_reference_loop_does():
    """Greedy codebook decode (examples/serve_decode.py:35-53): musicgen's
    reduced config in float32, the reference's weights carried across.
    ``serve`` teacher-forces a (B, P, K) prompt and then takes the argmax
    over the last axis of the (B, 1, K, V) logits for every codebook at
    once; the reference's ``forward_decode`` loop, run here on the same
    prompt, generates the same (B, gen_len, K) tokens, and the prompt's
    logits agree within 2e-5."""
    cj, ct = _configs("musicgen_large", dtype="float32")
    tree = _perturbed_tree(cj, seed=4)
    params = jax.tree.map(jnp.asarray, tree)
    B, P, G, Kc = 2, 4, 6, ct.num_codebooks
    res = serve_decode.serve(ct, B, P, G, torch.device("cpu"),
                             model=params_from_numpy(tree, ct, "cpu"))
    prompt = jnp.asarray(res["prompt"].numpy())
    assert prompt.shape == (B, P, Kc)
    step = jax.jit(jforward_decode, static_argnums=1)
    cache, logits = jinit_cache(cj, B, P + G), []
    for t in range(P):
        lg, cache = step(params, cj, prompt[:, t][:, None], cache, jnp.int32(t))
        logits.append(np.asarray(lg[:, 0]))
    tok = jnp.argmax(lg[:, -1], axis=-1).reshape(B, 1, Kc)
    out = [tok]
    for t in range(P, P + G - 1):
        lg, cache = step(params, cj, tok, cache, jnp.int32(t))
        tok = jnp.argmax(lg[:, -1], axis=-1).reshape(B, 1, Kc)
        out.append(tok)
    want = np.asarray(jnp.concatenate(out, axis=1))
    np.testing.assert_allclose(res["prompt_logits"].numpy(), np.stack(logits, 1), rtol=2e-5,
                               atol=2e-5)
    assert tuple(res["generated"].shape) == (B, G, Kc)
    np.testing.assert_array_equal(res["generated"].numpy(), want)
