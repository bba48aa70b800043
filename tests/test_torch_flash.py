"""The port's flash attention (B1-B3) against the JAX reference.

On the CPU the kernel wrappers take their plain PyTorch versions, joined by
the port's ``torch.autograd.Function``. They are held to the reference's
Pallas kernels (interpret mode) and its ``ref.flash_attention_ref`` on the
same numpy inputs, over ``tests/test_kernels.py``'s sweeps and with its
tolerances. ``tests/test_torch_cuda.py`` holds the CUDA kernels to the
plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash import _flash_forward
from repro.models.attention import gqa_train as jgqa_train
from repro.models.attention import init_attention
from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import Attention, gqa_train

# forward, tests/test_kernels.py:87; backward, :137-142; GQA parity, :209-224
FWD_RTOL, FWD_ATOL = 2e-3, 2e-4
BWD_RTOL, BWD_ATOL = 2e-3, 1e-4
GQA_RTOL, GQA_ATOL = 5e-3, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; torch's
    intra-op threads then fight the other workers for the cores, and these
    small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("window", [None, 100, 32])
@pytest.mark.parametrize("S,bq,bk", [(256, 64, 64), (128, 128, 32)])
def test_flash_forward_matches_reference_sweep(window, S, bq, bk):
    q, k, v = _qkv((2, 3, S, 64), seed=S + (window or 0))
    before = tflash.flash_fwd.launches
    got = tops.attention(_t(q), _t(k), _t(v), window=window).detach().numpy()
    assert tflash.flash_fwd.launches == before  # the CPU takes the plain version
    want_kernel = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 window=window, block_q=bq, block_k=bk)
    want_ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        window=window)
    _close(got, want_kernel, FWD_RTOL, FWD_ATOL, "vs Pallas kernel")
    _close(got, want_ref, FWD_RTOL, FWD_ATOL, "vs ref.py")
    port_ref = tref.flash_attention_ref(_t(q), _t(k), _t(v), window=window)
    _close(got, port_ref, FWD_RTOL, FWD_ATOL, "vs the port's ref.py")


@pytest.mark.parametrize("window,S,bq,bk,vs_kernels", [
    (None, 256, 64, 64, False),
    (32, 256, 64, 64, True),  # whole tiles masked by the window
    (100, 128, 128, 32, False),
    (None, 200, 128, 128, True),  # S no multiple of the reference's blocks
    (16, 100, 128, 32, True),  # both
])
def test_flash_backward_matches_jax_grad(window, S, bq, bk, vs_kernels):
    """dQ, dK, dV through the port's autograd.Function against jax.grad of
    the reference's XLA oracle, and of its custom-vjp Pallas kernels
    (interpret mode, a few seconds a case) where their masking differs:
    fully-masked tiles, and lengths that do not divide the blocks."""
    q, k, v = _qkv((1, 2, S, 32), seed=7 * S + (window or 0))
    do = np.random.RandomState(3).randn(1, 2, S, 32).astype(np.float32)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tflash.flash_attention(tq, tk, tv, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), grad_outputs=_t(do))

    def jgrads(fwd):
        return jax.grad(lambda a, b, c: jnp.sum(fwd(a, b, c) * jnp.asarray(do)),
                        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    oracle = jgrads(lambda a, b, c: jref.flash_attention_ref(a, b, c, window=window))
    _close(out.detach(), jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), window=window),
           FWD_RTOL, FWD_ATOL, "forward")
    for g, wr, name in zip(got, oracle, ("dq", "dk", "dv")):
        _close(g, wr, BWD_RTOL, BWD_ATOL, f"{name} vs ref.py")
    if vs_kernels:
        kernel = jgrads(lambda a, b, c: jops.attention(a, b, c, window=window,
                                                       block_q=bq, block_k=bk))
        for g, wk, name in zip(got, kernel, ("dq", "dk", "dv")):
            _close(g, wk, BWD_RTOL, BWD_ATOL, f"{name} vs Pallas kernels")


# plain B1-B3 on bf16 inputs against the reference's kernels on the same
# bf16 inputs (tests/test_torch_precision.py)
BF16_FWD_TOL, BF16_BWD_TOL = 3e-2, 6e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,S", [(None, 128), (32, 128), (24, 100)])
def test_flash_at_head_dim_128_matches_pallas_kernels(window, S, dtype):
    """Head dim 128 (qwen3_0_6b, phi4_mini_3_8b): O and dQ, dK, dV through
    the port's autograd.Function (the plain B1-B3 on the CPU) against the
    reference's custom-vjp Pallas kernels in interpret mode on the same
    inputs: causal, windowed, and a length that fills no block. float32 at
    the reference's tolerances, bf16 at the bf16 ones."""
    rng = np.random.RandomState(S + (window or 0))
    xs = [rng.randn(1, 2, S, 128).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(x).astype(dtype) for x in xs]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    q, k, v = (x.requires_grad_(True) for x in tx[:3])
    out = tflash.flash_attention(q, k, v, window=window)
    got = torch.autograd.grad(out, (q, k, v), tx[3])

    def fwd(a, b, c):
        return jops.attention(a, b, c, window=window, block_q=64, block_k=64)

    want = jax.grad(lambda a, b, c: jnp.sum(fwd(a, b, c).astype(jnp.float32)
                                            * jx[3].astype(jnp.float32)),
                    argnums=(0, 1, 2))(*jx[:3])
    f32 = dtype == "float32"
    fwd_tol = (FWD_RTOL, FWD_ATOL) if f32 else (BF16_FWD_TOL, BF16_FWD_TOL)
    bwd_tol = (BWD_RTOL, BWD_ATOL) if f32 else (BF16_BWD_TOL, BF16_BWD_TOL)
    assert out.dtype == getattr(torch, dtype)
    _close(out.detach().float(), np.asarray(fwd(*jx[:3]), np.float32), *fwd_tol, "O")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == out.dtype, name
        _close(g.float(), np.asarray(w, np.float32), *bwd_tol, name)


# the card's gate for the bf16 entry points against their plain versions
# (tests/test_torch_cuda.py): |err| <= 1e-2 + 1e-2 |want|
BF16_TOL = 1e-2
# tests/test_torch_cuda.py's bf16 cases and DH128_CASES; (16, 256, 128) is
# qwen3_0_6b's path shape
BF16_CARD_CASES = [((6, 256, 64), None), ((6, 256, 64), 32), ((4, 200, 32), 100),
                   ((2, 100, 16), 16), ((3, 130, 64), None), ((1, 64, 32), 1),
                   ((6, 48, 64), None), ((2, 272, 32), None), ((16, 256, 128), None),
                   ((4, 200, 128), 100), ((2, 130, 128), None), ((3, 48, 128), 16),
                   ((1, 272, 128), None)]


@pytest.mark.parametrize("shape,window", BF16_CARD_CASES)
def test_flash_bf16_backward_rounding_of_p_and_ds_stays_within_the_card_gate(shape, window):
    """On bf16 inputs the plain B2 and B3 round P and dS to bf16 before their
    products, as the kernels do (bf16 x bf16 wgmma). That moves dQ, dK and
    dV by less than the card's gate against the same backward with P and dS
    kept in float32."""
    rng = np.random.RandomState(shape[1] + (window or 0))
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
                   for _ in range(4))
    o, L = tflash.flash_fwd(q, k, v, window=window)
    D = (do.float() * o.float()).sum(-1)
    got = (tflash.flash_bwd_dq(q, k, v, do, L, D, window=window),
           *tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    S, dh = shape[1:]
    scale = tflash._scale(dh)
    mask = tflash.visible_mask(S, S, True, window, "cpu")
    p = torch.where(mask, torch.exp(qf @ kf.mT * scale - L[..., None]), torch.zeros(()))
    ds = p * (dof @ vf.mT - D[..., None])
    want = ((ds @ kf) * scale, (ds.mT @ qf) * scale, p.mT @ dof)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), w.bfloat16().float(), rtol=BF16_TOL,
                                   atol=BF16_TOL, msg=name)


def test_flash_fully_masked_rows_are_zero_with_the_sentinel():
    """tests/test_kernels.py:166 on the port: a window of 8 and keys masked
    past seq_len = 100 of 128 rows leave rows >= 107 seeing no key. Their O
    is exactly 0 and their L the -1e30 sentinel; O and L match the
    reference's forward everywhere."""
    S, window, Sp, dh = 100, 8, 128, 16
    q, k, v = _qkv((1, 1, S, dh), seed=11)
    pad = ((0, 0), (0, Sp - S), (0, 0))
    qf, kf, vf = (np.pad(x.reshape(1, S, dh), pad) for x in (q, k, v))
    o, L = tflash.flash_fwd(_t(qf), _t(kf), _t(vf), window=window, seq_len=S)
    jo, jL = _flash_forward((True, window, 128, 128, S, True),
                            jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf))
    first_dead = S - 1 + window
    assert float(o[:, first_dead:].abs().max()) == 0.0
    assert bool((L[:, first_dead:] <= -1e29).all())
    assert float(L[0, first_dead - 1]) > -1e29
    assert float(o[:, first_dead - 1].abs().max()) > 0.0
    _close(o, jo, FWD_RTOL, FWD_ATOL, "O")
    _close(L, jL, FWD_RTOL, FWD_ATOL, "L")


@pytest.mark.parametrize("window,S,dtype,block", [
    pytest.param(None, 200, "float32", 128, id="None"),
    pytest.param(24, 200, "float32", 128, id="24"),
    # bf16 one row past one and two of the bf16 kernel's 64-row tiles, against
    # the reference's kernel on the same bf16 inputs in 64-row blocks
    pytest.param(None, 65, "bfloat16", 64, id="None-65-bf16"),
    pytest.param(8, 129, "bfloat16", 64, id="8-129-bf16"),
])
def test_flash_logsumexp_matches_reference_forward(window, S, dtype, block):
    """B1's plain version (the CPU's flash_fwd) against the reference's
    Pallas forward in interpret mode on a length that fills no block: L at
    the float32 tolerances (the bf16 inputs are upcast, as the reference
    upcasts them), O at the float32 or the bf16 ones."""
    dh = 64
    q, k, v = _qkv((4, S, dh), seed=5)
    Sp = -(-S // block) * block
    pad = ((0, 0), (0, Sp - S), (0, 0))
    jo, jL = _flash_forward((True, window, block, block, S, True),
                            *(jnp.asarray(np.pad(x, pad)).astype(dtype) for x in (q, k, v)))
    o, L = tflash.flash_fwd(*(_t(x).to(getattr(torch, dtype)) for x in (q, k, v)),
                            window=window)
    assert o.dtype == getattr(torch, dtype) and L.dtype == torch.float32
    _close(L, np.asarray(jL)[:, :S], FWD_RTOL, FWD_ATOL)
    o_tol = (FWD_RTOL, FWD_ATOL) if dtype == "float32" else (BF16_FWD_TOL, BF16_FWD_TOL)
    _close(o.float(), np.asarray(jo, np.float32)[:, :S], *o_tol)


@pytest.mark.parametrize("window", [None, 24])
def test_gqa_train_with_kernels_matches_reference(window):
    """gqa_train(use_kernels=True), grouped KV heads (kv_groups 2) and a
    length that is no tile multiple: values, and gradients for every weight
    and the input, against the reference's kernel path."""
    jcfg = JAttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16, window=window)
    tcfg = AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16, window=window)
    d_model, B, S = 32, 2, 48
    params = init_attention(jax.random.PRNGKey(0), d_model, jcfg, jnp.float32)
    x = np.random.RandomState(7).randn(B, S, d_model).astype(np.float32)

    attn = Attention(d_model, tcfg, torch.float32, "cpu", generator=None)
    with torch.no_grad():
        for name, p in attn.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    tx = _t(x, True)
    w = dict(attn.named_parameters())
    out = gqa_train(w, tx, tcfg, use_kernels=True)
    want = jgqa_train(params, jnp.asarray(x), jcfg, use_kernels=True)
    _close(out.detach(), want, GQA_RTOL, GQA_ATOL, "output")
    dense = gqa_train(w, tx, tcfg, use_kernels=False)
    _close(out.detach(), dense.detach(), GQA_RTOL, GQA_ATOL, "port dense path")

    names = [n for n, _ in attn.named_parameters()]
    got = torch.autograd.grad((out ** 2).sum(), [p for _, p in attn.named_parameters()] + [tx])
    gp, gx = jax.grad(lambda p, x: jnp.sum(jgqa_train(p, x, jcfg, use_kernels=True) ** 2),
                      argnums=(0, 1))(params, jnp.asarray(x))
    for name, g in zip(names, got):
        _close(g, gp[name], GQA_RTOL, GQA_ATOL, name)
    _close(got[-1], gx, GQA_RTOL, GQA_ATOL, "x")

