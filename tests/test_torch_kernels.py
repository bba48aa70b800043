"""The port's kernel modules against the JAX reference kernels.

On the CPU the wrappers take their plain PyTorch versions; these are held
to the reference's Pallas kernels (interpret mode) and its ``ref.py``
oracles on the same numpy inputs, with ``tests/test_kernels.py``'s shapes
and tolerances. ``tests/test_torch_cuda.py`` holds the CUDA kernels to the
plain versions on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import adam_step as tadam
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# rotation parity, tests/test_kernels.py:41: float32 products summed in
# another order (blocked BLAS here, Pallas tiles there)
ROT_RTOL, ROT_ATOL = 2e-3, 1e-4
# fused Adam parity, tests/test_kernels.py:51
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; torch's
    intra-op threads then fight the other workers for the cores, and these
    small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize(
    "shape", [(128, 128, 128), (256, 384, 128), (64, 256, 64), (100, 50, 70), (17, 33, 65)]
)
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True)])
def test_matmul_matches_pallas_matmul(shape, trans_a, trans_b):
    M, K, N = shape
    rng = np.random.RandomState(0)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    a_in = a.T.copy() if trans_a else a
    b_in = b.T.copy() if trans_b else b
    before = tmm.matmul.launches
    got = tmm.matmul(_t(a_in), _t(b_in), trans_a=trans_a, trans_b=trans_b).numpy()
    assert tmm.matmul.launches == before  # CPU tensors never count a launch
    want = np.asarray(jops.pallas_matmul(_j(a), _j(b)))
    np.testing.assert_allclose(got, want, rtol=ROT_RTOL, atol=ROT_ATOL)
    np.testing.assert_allclose(got, np.asarray(jref.matmul_ref(_j(a), _j(b))),
                               rtol=ROT_RTOL, atol=ROT_ATOL)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
@pytest.mark.parametrize("sides", ["bi", "left", "right"])
def test_two_sided_rotate_matches_reference(batch, sides):
    m, n = 48, 32
    rng = np.random.RandomState(1)
    x = rng.randn(*batch, m, n).astype(np.float32)
    U = np.linalg.qr(rng.randn(*batch, m, m))[0].astype(np.float32) if sides != "right" else None
    V = np.linalg.qr(rng.randn(*batch, n, n))[0].astype(np.float32) if sides != "left" else None
    for transpose in (True, False):
        got = tops.two_sided_rotate(_t(x), _t(U), _t(V), transpose=transpose).numpy()
        want = np.asarray(jops.two_sided_rotate(_j(x), _j(U), _j(V), transpose=transpose))
        np.testing.assert_allclose(got, want, rtol=ROT_RTOL, atol=ROT_ATOL)
        oracle = np.asarray(jref.two_sided_rotate_ref(_j(x), _j(U), _j(V), transpose))
        np.testing.assert_allclose(got, oracle, rtol=ROT_RTOL, atol=ROT_ATOL)
        port_oracle = tref.two_sided_rotate_ref(_t(x), _t(U), _t(V), transpose).numpy()
        np.testing.assert_allclose(got, port_oracle, rtol=ROT_RTOL, atol=ROT_ATOL)


def _adam_inputs(shape, seed, v_floor):
    rng = np.random.RandomState(seed)
    g = rng.randn(*shape).astype(np.float32)
    m = rng.randn(*shape).astype(np.float32)
    v = (np.abs(rng.randn(*shape)) + v_floor).astype(np.float32)
    return g, m, v


@pytest.mark.parametrize("shape", [(64, 64), (3, 100, 70), (2, 2, 40, 24)])
def test_adam_scale_matches_reference(shape):
    g, m, v = _adam_inputs(shape, 2, 0.1)
    scal = (0.999, 1e-8, 0.5, 0.25)
    s, vn = tops.adam_scale(_t(g), _t(m), _t(v), *scal)
    s_k, vn_k = jops.adam_scale(_j(g), _j(m), _j(v), *scal)
    s_r, vn_r = jref.fused_adam_scale_ref(_j(g), _j(m), _j(v), *scal)
    for got, want in ((s, s_k), (vn, vn_k), (s, s_r), (vn, vn_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ADAM_RTOL, atol=ADAM_ATOL)


@pytest.mark.parametrize("shape", [(64, 64), (100, 70), (17, 33)])
def test_adam_scale_plain_follows_the_kernel_arithmetic(shape):
    """Near v = 0 (the first step) the step is (m/bc1)/(sqrt(v'/bc2) + eps)
    with v' tiny, the case an rsqrt formulation gets wrong. The plain
    version forms (1 - b2) in float32 as the Pallas kernel does, so it
    agrees with the kernel to a few ulps even there."""
    g, m, v = _adam_inputs(shape, 3, 1e-4)
    v[:2] = 0.0
    scal = (0.999, 1e-8, 0.9, 0.1)
    s, vn = tadam.adam_scale_plain(_t(g), _t(m), _t(v), *scal)
    s_k, vn_k = jops.adam_scale(_j(g), _j(m), _j(v), *scal)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), rtol=ADAM_RTOL, atol=ADAM_ATOL)
    np.testing.assert_allclose(vn.numpy(), np.asarray(vn_k), rtol=ADAM_RTOL, atol=ADAM_ATOL)
