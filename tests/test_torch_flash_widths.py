"""B1-B3 at head widths the kernels are not built for (``kernels/flash.py``:
``flash_attention`` zero-pads to the next of ``HEAD_DIMS`` at the scale of
the true width) against the JAX reference, whose Pallas kernels take any
width. On the CPU the padded path runs through the plain versions; it is
held to the reference's ``flash_attention`` in interpret mode (64-row
blocks) with ``tests/test_kernels.py``'s tolerances (float32 :87 and
:137-142, bf16 :98 and :163), and on a card the kernels to the same path
on the CPU. The reference is imported inside its tests, so that the
``cuda`` test runs on a card's host, which has no JAX."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash as tflash

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

FWD_TOL = {"float32": (2e-3, 2e-4), "bfloat16": (3e-2, 3e-2)}
BWD_TOL = {"float32": (2e-3, 1e-4), "bfloat16": (6e-2, 6e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _inputs(S, dh, dtype, seed):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(1, 2, S, dh).astype(np.float32) for _ in range(4)]
    return xs, [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


def test_padded_width_is_the_next_built_width():
    assert [tflash.padded_width(d) for d in (1, 8, 16, 17, 32, 48, 64, 65, 96, 128)] == [
        16, 16, 16, 32, 32, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="head dim 160"):
        tflash.padded_width(160)
    x = torch.zeros(1, 1, 8, 192)
    with pytest.raises(ValueError, match="head dim 192"):
        tflash.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,S,window", [(48, 100, None), (96, 130, 24)])
def test_padded_widths_match_pallas_kernels(dh, S, window, dtype):
    """O and dQ, dK, dV at dh 48 and 96 through the padded path against the
    reference's Pallas kernels at the true width; outputs and gradients
    keep the true width and the input dtype."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    xs, tx = _inputs(S, dh, dtype, seed=dh + S)
    jx = [jnp.asarray(x).astype(dtype) for x in xs]
    q, k, v = (x.clone().requires_grad_(True) for x in tx[:3])
    out = tflash.flash_attention(q, k, v, window=window)
    got = torch.autograd.grad(out, (q, k, v), tx[3])

    def fwd(a, b, c):
        return jops.attention(a, b, c, window=window, block_q=64, block_k=64)

    want = jax.grad(lambda a, b, c: jnp.sum(fwd(a, b, c).astype(jnp.float32)
                                            * jx[3].astype(jnp.float32)),
                    argnums=(0, 1, 2))(*jx[:3])
    assert out.shape == (1, 2, S, dh) and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(fwd(*jx[:3]), np.float32), *FWD_TOL[dtype])
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == (1, 2, S, dh) and g.dtype == out.dtype, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   *BWD_TOL[dtype], err_msg=name)


def test_padding_uses_the_true_width_scale_and_zero_columns():
    """The wrappers take the true width's scale: the padded forward's O is
    the unpadded plain version's in its first dh columns and zero after,
    and L is the same."""
    _, (q, k, v, _) = _inputs(40, 48, "float32", seed=3)
    flat = [x.reshape(2, 40, 48) for x in (q, k, v)]
    o, L = tflash.flash_fwd_plain(*flat, window=16)
    padded = [torch.nn.functional.pad(x, (0, 16)) for x in flat]
    op, Lp = tflash.flash_fwd(*padded, window=16, scale=tflash._scale(48))
    torch.testing.assert_close(op[..., :48], o, rtol=1e-6, atol=1e-6)
    assert torch.equal(op[..., 48:], torch.zeros_like(op[..., 48:]))
    torch.testing.assert_close(Lp, L, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(tflash.flash_fwd(*padded, window=16)[1], L)  # dh 64's scale


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [48, 96])
def test_padded_widths_on_card_match_the_cpu(cuda, dh, dtype):
    """The kernels at the padded width, on the card, against the same padded
    path through the plain versions on the CPU: O and the gradients within
    the card's gates of tests/test_torch_cuda.py."""
    _, tx = _inputs(256, dh, dtype, seed=dh)
    f32 = dtype == "float32"
    tols = [(2e-3, 2e-4) if f32 else (1e-2, 1e-2)] + [(2e-3, 1e-4) if f32 else (1e-2, 1e-2)] * 3
    outs = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (x.to(dev).requires_grad_(True) for x in tx[:3])
        out = tflash.flash_attention(q, k, v)
        outs.append([out, *torch.autograd.grad(out, (q, k, v), tx[3].to(dev))])
    for a, b, (rtol, atol) in zip(*outs, tols):
        assert a.shape == b.shape == (1, 2, 256, dh) and a.dtype == b.dtype
        torch.testing.assert_close(a.detach().cpu().float(), b.detach().float(), rtol=rtol,
                                   atol=atol)
