"""The long-sequence and stacked model paths of the port against the JAX
reference: query-chunked GQA and MLA attention (thresholds lowered to 8, as
the reference's own test lowers them), the chunked cross-entropy and its
tail chunk, the stacked ``scan_layers=True`` parameters (forward, decode, a
basis-rotation train step of the dry run's ``make_train_step``), both remat
policies, the conversion between the stacked and per-layer layouts, and
the grouped optimizer kernels' plain versions over stacked leaves. The same
numpy-seeded weights and inputs go through both packages
(``checkpoint/convert.py``)."""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models import attention as jattn
from repro.models.model import forward_decode as jforward_decode
from repro.models.model import forward_train as jforward_train
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro_torch.checkpoint.convert import (
    flatten_tree,
    params_from_numpy,
    params_to_numpy,
    stack_layers,
    unflatten_tree,
    unstack_layers,
)
from repro_torch.configs import OptimizerConfig
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.launch.dryrun import make_train_step
from repro_torch.models import (
    Transformer,
    forward_decode,
    forward_train,
    init_cache,
    loss_fn,
    param_leaves,
    use_config,
)
from repro_torch.models import attention as tattn
from repro_torch.optim.factory import build_optimizer

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

B, S, V = 2, 32, 97
CHUNK_TOL = 2e-4  # the reference's chunked-vs-dense attention tolerance (tests/test_models.py:127)
CE_TOL = 1e-5  # its chunked-CE loss and gradient tolerance (tests/test_models.py:227, :232)
STACK_TOL = 2e-5  # its stacked-vs-per-layer forward tolerance (tests/test_models.py:211)
# basis rotation: (first two losses) of two implementations of its step, the
# reference's tolerance (tests/test_engine.py:437-438)
ROTATION_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; these
    small shapes gain nothing from torch's intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, seed=3):
    """Reference weights with noise on every 1-D leaf (norms, biases), so
    that each reaches the output with values of its own."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(a.dtype) if a.ndim <= 2 and (
            a.ndim == 1 or a.shape[0] <= 4) else a, _np(tree))


def _pair(**kw):
    """(reference, port) configs of one small dense model."""
    base = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=V, max_seq_len=64)
    base.update(kw)
    att = base.pop("attention", dict(num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True))
    pattern = base.pop("pattern", ("attn", "dense"),)
    jcfg = JModelConfig(attention=JAttentionConfig(**att),
                        pattern=(JBlockSpec(*pattern),), **base)
    tcfg = ModelConfig(attention=AttentionConfig(**att), pattern=(BlockSpec(*pattern),), **base)
    return jcfg, tcfg


def _tokens(seed=1, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, V, size=shape)


def _grads(model, batch):
    params = param_leaves(model)
    loss, _ = loss_fn(model, batch)
    gs = torch.autograd.grad(loss, list(params.values()))
    return float(loss), {k: g.numpy() for k, g in zip(params, gs)}


# ---------------------------------------------------------------------------
# Query-chunked attention
# ---------------------------------------------------------------------------


def _lower_thresholds(monkeypatch):
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 8)
        monkeypatch.setattr(mod, "QUERY_BLOCK", 8)


MIXERS = {
    "gqa": dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    "gqa_window": dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16, window=12),
    "mla": dict(kind="mla", num_heads=4, num_kv_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=24),
}


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_chunked_attention_matches_reference_and_dense(monkeypatch, mixer):
    """Above the (lowered) threshold both packages stream queries in blocks
    of 8: the port's chunked output and its input gradient and every weight
    gradient equal the reference's chunked ones and the port's own dense
    path within 2e-4."""
    kw = MIXERS[mixer]
    jc, tc = JAttentionConfig(**kw), AttentionConfig(**kw)
    jp = _perturbed(jattn.init_attention(jax.random.PRNGKey(0), 64, jc, jnp.float32))
    x = np.random.RandomState(2).randn(B, S, 64).astype(np.float32)
    ct = np.random.RandomState(4).randn(B, S, 64).astype(np.float32)
    jfn = jattn.mla_train if mixer == "mla" else jattn.gqa_train
    tfn = tattn.mla_train if mixer == "mla" else tattn.gqa_train

    def port(w):
        wt = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
        xt = torch.tensor(x, requires_grad=True)
        out = tfn(wt, xt, tc)
        (out * torch.from_numpy(ct)).sum().backward()
        return out.detach().numpy(), xt.grad.numpy(), {k: v.grad.numpy() for k, v in wt.items()}

    dense = port(jp)
    _lower_thresholds(monkeypatch)
    chunked = port(jp)
    @jax.jit
    def ref(p, xx, c):
        out, vjp = jax.vjp(lambda pp, xv: jfn(pp, xv, jc), p, xx)
        return out, vjp(c)

    out_j, (gw_j, gx_j) = ref(jp, jnp.asarray(x), jnp.asarray(ct))
    for want in ((np.asarray(out_j), np.asarray(gx_j), _np(gw_j)), dense):
        np.testing.assert_allclose(chunked[0], want[0], rtol=CHUNK_TOL, atol=CHUNK_TOL)
        np.testing.assert_allclose(chunked[1], want[1], rtol=CHUNK_TOL, atol=CHUNK_TOL)
        for k in chunked[2]:
            np.testing.assert_allclose(chunked[2][k], want[2][k], rtol=CHUNK_TOL,
                                       atol=CHUNK_TOL, err_msg=k)


def test_chunked_attention_keeps_no_scores_for_the_backward(monkeypatch):
    """The chunked forward saves no scores for the backward (each block's
    are recomputed there), where the dense call saves its (B, H, S, S)
    probabilities: no tensor that autograd saves has S keys on its last
    axis."""
    tc = AttentionConfig(**MIXERS["gqa"])
    w = {k: torch.tensor(v, requires_grad=True) for k, v in _np(jattn.init_attention(
        jax.random.PRNGKey(0), 64, JAttentionConfig(**MIXERS["gqa"]), jnp.float32)).items()}
    x = torch.randn(B, S, 64, requires_grad=True)

    def saved_shapes(fn):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
            fn()
        return shapes

    dense = saved_shapes(lambda: tattn.gqa_train(w, x, tc))
    assert any(len(s) >= 4 and s[-1] == S for s in dense)
    _lower_thresholds(monkeypatch)
    chunked = saved_shapes(lambda: tattn.gqa_train(w, x, tc))
    assert not any(len(s) >= 4 and s[-1] == S for s in chunked), chunked


def test_kernels_keep_the_flash_path_above_the_threshold(monkeypatch):
    """With ``use_kernels`` GQA takes B1-B3 (here their plain versions on the
    CPU) at every length, as the reference does: one flash call, no blocks."""
    from repro_torch.kernels import flash

    calls = []
    real = flash.flash_attention
    monkeypatch.setattr(flash, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    _lower_thresholds(monkeypatch)
    tc = AttentionConfig(**MIXERS["gqa"])
    w = {k: torch.from_numpy(v) for k, v in _np(jattn.init_attention(
        jax.random.PRNGKey(0), 64, JAttentionConfig(**MIXERS["gqa"]), jnp.float32)).items()}
    x = torch.randn(B, S, 64)
    got = tattn.gqa_train(w, x, tc, use_kernels=True)
    assert calls == [(B, 4, S, 16)]
    np.testing.assert_allclose(got.numpy(), tattn.gqa_train(w, x, tc).numpy(),
                               rtol=CHUNK_TOL, atol=CHUNK_TOL)


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [16, 24])
def test_chunked_ce_matches_reference(chunk):
    """``loss_fn`` with ``loss_chunk`` (24 leaves a tail of 16 of 64) equals
    the reference's chunked loss within 1e-5, and every gradient leaf too;
    the port's chunked and unchunked losses agree as closely."""
    jc, tc = _pair(num_layers=2, scan_layers=False, attention=dict(
        num_heads=4, num_kv_heads=4, head_dim=16))
    jp = _np(jinit_model(jax.random.PRNGKey(0), jc))
    toks = _tokens(shape=(2, 64))
    labels = toks.copy()
    labels[:, :5] = -100
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jc.replace(loss_chunk=chunk), b), has_aux=True))(jp, jbatch)
    model = params_from_numpy(jp, tc.replace(loss_chunk=chunk), "cpu")
    lt, gt = _grads(model, tbatch)
    assert abs(lt - float(lj)) < CE_TOL
    gj = flatten_tree(_np(gj))
    assert max(float(np.max(np.abs(gt[k] - gj[k]))) for k in gt) < CE_TOL
    l0, g0 = _grads(use_config(model, tc), tbatch)
    assert abs(lt - l0) < CE_TOL
    assert max(float(np.max(np.abs(gt[k] - g0[k]))) for k in gt) < CE_TOL


def test_chunked_ce_forms_no_full_logits():
    """No (B, S, V) tensor is formed by the chunked loss: the largest output
    over the vocabulary, forward and backward, is one chunk's logits."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tc = _pair(num_layers=2, scan_layers=False, loss_chunk=16)
    model = Transformer(tc, device="cpu", seed=0)
    toks = torch.from_numpy(_tokens(shape=(2, 64)))
    biggest = []

    class Largest(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.ndim >= 3 and t.shape[-1] == V:
                    biggest.append(t.numel())
            return out

    with Largest():
        loss, _ = loss_fn(model, {"tokens": toks, "labels": toks})
        loss.backward()
    assert max(biggest) == 2 * 16 * V  # one chunk's logits, never the whole sequence's


# ---------------------------------------------------------------------------
# Stacked parameters
# ---------------------------------------------------------------------------


def _stacked_pair(arch=None, **kw):
    if arch is None:
        jc, tc = _pair(**kw)
    else:
        from repro.configs.catalog import get_config as jget_config
        from repro_torch.configs import get_config as tget_config

        jc = jget_config(arch, True).replace(dtype="float32", **kw)
        tc = tget_config(arch, True).replace(dtype="float32", **kw)
    jp = _perturbed(jinit_model(jax.random.PRNGKey(0), jc))
    return jc, tc, jp, params_from_numpy(jp, tc, "cpu")


def _two_superblocks(arch):
    if arch is None:
        return dict(num_layers=6)
    from repro_torch.configs import get_config as tget_config

    return dict(num_layers=2 * len(tget_config(arch, True).pattern))


@pytest.mark.parametrize("arch", [None, "deepseek_v2_236b", "xlstm_1_3b"])
def test_stacked_forward_matches_reference_and_per_layer(arch):
    """The stacked model (one leaf per pattern position over the
    superblocks, each superblock under remat) gives the reference's stacked
    forward within 2e-5, and the per-layer model holding the same weights
    (``unstack_layers``) gives the same logits."""
    jc, tc, jp, model = _stacked_pair(arch, **_two_superblocks(arch))
    assert tc.scan_layers and model.cfg.num_superblocks > 1
    toks = _tokens()
    lj, _ = jax.jit(lambda p, t: jforward_train(p, jc, t))(jp, jnp.asarray(toks))
    lt, _ = forward_train(model, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=STACK_TOL,
                               atol=STACK_TOL)
    flat = unflatten_tree(unstack_layers(flatten_tree(jp), tc))
    per_layer = params_from_numpy(flat, tc.replace(scan_layers=False), "cpu")
    lf, _ = forward_train(per_layer, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.detach().numpy(), lf.detach().numpy(), rtol=STACK_TOL,
                               atol=STACK_TOL)


def test_layouts_convert_and_draw_alike():
    """``stack_layers`` and ``unstack_layers`` are inverses leaf for leaf;
    the port's stacked tree has the reference's stacked paths, order and
    shapes; and one seed draws the same weights in both layouts."""
    jc, tc = _pair(num_layers=4, pattern=("attn", "dense"))
    jflat = flatten_tree(_np(jinit_model(jax.random.PRNGKey(0), jc)))
    shapes = {k: tuple(p.shape) for k, p in param_leaves(Transformer(tc, "meta", None)).items()}
    assert list(shapes) == list(jflat) and shapes == {k: v.shape for k, v in jflat.items()}
    per_layer = unstack_layers(jflat, tc)
    back = stack_layers(per_layer, tc)
    assert list(back) == list(jflat)
    assert all(np.array_equal(back[k], jflat[k]) for k in jflat)
    stacked = Transformer(tc, "cpu", seed=5)
    flat = Transformer(tc.replace(scan_layers=False), "cpu", seed=5)
    want = stack_layers({k: v.detach() for k, v in param_leaves(flat).items()}, tc)
    got = param_leaves(stacked)
    assert all(torch.equal(got[k], want[k]) for k in want)
    np.testing.assert_array_equal(
        flatten_tree(params_to_numpy(stacked))["blocks/0/mixer/w_q"],
        got["blocks/0/mixer/w_q"].detach().numpy())


@pytest.mark.parametrize("arch", [None, "jamba_v0_1_52b"])
def test_stacked_decode_matches_reference(arch):
    """Decoding a sequence token by token on the stacked cache (one per
    pattern position, stacked over the superblocks: the attention caches
    written in place, the Mamba states copied into their slots) gives the
    reference's stacked decode's logits within 2e-5."""
    jc, tc, jp, model = _stacked_pair(arch, **_two_superblocks(arch))
    jdecode = jax.jit(lambda p, t, c, pos: jforward_decode(p, jc, t, c, pos))
    steps = 6
    toks = _tokens(shape=(B, steps))
    jcache = jinit_cache(jc, B, steps)
    tcache = init_cache(tc, B, steps, device="cpu")
    assert len(tcache) == len(tc.pattern) and all(
        v.shape[0] == tc.num_superblocks for c in tcache for v in c.values())
    with torch.no_grad():
        for t in range(steps):
            lj, jcache = jdecode(jp, jnp.asarray(toks[:, t: t + 1]), jcache, jnp.int32(t))
            lt, tcache = forward_decode(model, torch.from_numpy(toks[:, t: t + 1]), tcache, t)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=STACK_TOL,
                                       atol=STACK_TOL, err_msg=f"position {t}")


def _reference_make_train_step():
    """The reference's ``make_train_step``. Its module asks for 512 host
    devices when imported, so the backend is started first (with its one
    CPU device) and the environment is restored after the import."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import make_train_step as jmake_train_step
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jmake_train_step


def test_stacked_train_step_matches_reference():
    """Two basis-rotation steps of the dry run's ``make_train_step`` on a
    stacked model (second-moment source, bilateral, a refresh at step 0):
    the first loss equals the reference's ``make_train_step``'s within
    1e-5 and the second, after the update, within the rotation tolerance
    (the refreshed bases of rank-deficient grams differ in their null
    spaces between implementations)."""
    jmake = _reference_make_train_step()
    jc, tc, jp, model = _stacked_pair(num_layers=4)
    ocfg = dict(name="basis_rotation", learning_rate=1e-3, rotation_source="2nd",
                rotation_geometry="bilateral", rotation_freq=10, total_steps=100)
    jopt = jbuild_optimizer(JOptimizerConfig(**ocfg), jp, jc, num_stages=1, apply_delay=False)
    topt = build_optimizer(OptimizerConfig(**ocfg), param_leaves(model), tc, num_stages=1,
                           apply_delay=False)
    jstep = jax.jit(jmake(jc, jopt))
    tstep = make_train_step(tc, topt)
    jparams, jstate = jp, jopt.init(jp)
    tstate = topt.init(param_leaves(model))
    for step in range(2):
        toks = _tokens(seed=10 + step)
        jparams, jstate, lj = jstep(jparams, jstate, {"tokens": jnp.asarray(toks),
                                                      "labels": jnp.asarray(toks)},
                                    jnp.int32(step))
        model, tstate, lt = tstep(model, tstate, {"tokens": torch.from_numpy(toks),
                                                  "labels": torch.from_numpy(toks)}, step)
        assert abs(float(lt) - float(lj)) < (CE_TOL if step == 0 else ROTATION_TOL)


def test_remat_policies_agree():
    """``remat_policy`` "full" and "dots" give the same loss and gradients as
    each other and as the per-layer model (no remat); "dots" keeps the
    blocks' matrix products, so its backward recomputes fewer of them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tc, jp, _ = _stacked_pair(num_layers=4)
    toks = torch.from_numpy(_tokens())
    batch = {"tokens": toks, "labels": toks}
    flat = unflatten_tree(unstack_layers(flatten_tree(jp), tc))
    l_ref, g_ref = _grads(params_from_numpy(flat, tc.replace(scan_layers=False), "cpu"), batch)
    g_ref = stack_layers(g_ref, tc)

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    mms, results = {}, {}
    for policy in ("full", "dots"):
        model = params_from_numpy(jp, tc.replace(remat_policy=policy), "cpu")
        CountMM.n = 0
        with CountMM():
            results[policy] = _grads(model, batch)
        mms[policy] = CountMM.n
    assert mms["dots"] < mms["full"]
    for policy, (loss, grads) in results.items():
        assert abs(loss - results["full"][0]) == 0.0, policy
        assert abs(loss - l_ref) < 1e-6
        for k in grads:
            np.testing.assert_array_equal(grads[k], results["full"][1][k], err_msg=k)
            np.testing.assert_allclose(grads[k], g_ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_grouped_kernels_take_stacked_leaves_whole(monkeypatch):
    """With ``use_kernels`` the optimizer's step over a stacked model makes
    four grouped B4 calls, each stacked leaf one batched problem (its L
    superblocks' matrices), and one grouped B5 call over the rotated
    leaves: no per-layer loop. On the CPU its steps agree with the
    leaf-by-leaf ones to float32 roundoff."""
    from repro_torch.kernels import adam_step, ops

    calls = {"mm": [], "adam": []}

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name].append([tuple(a.shape) for a in args[0]])
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "matmul_grouped", counted("mm", ops.matmul_grouped))
    monkeypatch.setattr(adam_step, "adam_scale_grouped",
                        counted("adam", adam_step.adam_scale_grouped))
    _, tc, jp, _ = _stacked_pair(num_layers=4)
    toks = torch.from_numpy(_tokens())
    batch = {"tokens": toks, "labels": toks}
    after = {}
    for kernels in (True, False):
        model = params_from_numpy(jp, tc, "cpu")
        opt = build_optimizer(OptimizerConfig(name="basis_rotation"), param_leaves(model), tc,
                              num_stages=1, apply_delay=False, use_kernels=kernels)
        step = make_train_step(tc, opt)
        state = opt.init(param_leaves(model))
        for t in range(2):
            model, state, _ = step(model, state, batch, t)
        after[kernels] = {k: v.detach().clone() for k, v in param_leaves(model).items()}
    L = tc.num_superblocks
    rotated = 7  # w_q, w_k, w_v, w_o, w_gate, w_up, w_down: each (L, m, n)
    assert len(calls["mm"]) == 4 * 2 and len(calls["adam"]) == 2
    assert [len(c) for c in calls["mm"][:4]] == [2 * rotated, 2 * rotated, rotated, rotated]
    assert all(s[0] == L and len(s) == 3 for c in calls["mm"] for s in c)
    assert [len(c) for c in calls["adam"]] == [rotated, rotated]
    for k in after[True]:
        np.testing.assert_allclose(after[True][k].numpy(), after[False][k].numpy(),
                                   rtol=0, atol=2e-6, err_msg=k)
