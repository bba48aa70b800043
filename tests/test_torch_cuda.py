"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a GPU and ``nvcc`` and skips without them. The file
imports neither JAX nor the reference package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import adam_step as tadam
from repro_torch.kernels import matmul as tmm

# tests/test_kernels.py's tolerances: rotation parity (:41), fused Adam (:51)
ROT_RTOL, ROT_ATOL = 2e-3, 1e-4
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 384, 384, 1536), (1, 100, 70, 50), (3, 17, 33, 65)])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_matmul_kernel_matches_plain_on_card(cuda, shape, trans_a, trans_b):
    batch, M, K, N = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((batch, K, M) if trans_a else (batch, M, K), device=cuda, generator=gen)
    b = torch.randn((batch, N, K) if trans_b else (batch, K, N), device=cuda, generator=gen)
    a = a / K ** 0.5
    before = tmm.matmul.launches
    got = tmm.matmul(a, b, trans_a=trans_a, trans_b=trans_b)
    assert tmm.matmul.launches == before + 1
    want = tmm.matmul_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    torch.testing.assert_close(got, want, rtol=ROT_RTOL, atol=ROT_ATOL)


@pytest.mark.cuda
def test_matmul_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.randn(64, 32, device=cuda)
    with pytest.raises(ValueError):
        tmm.matmul(a.mT, a)  # not contiguous
    with pytest.raises(TypeError):
        tmm.matmul(a.double(), a.double().mT.contiguous())
    with pytest.raises(ValueError):
        tmm.matmul(a, a)  # contraction mismatch


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(384, 1536), (97, 33)])
def test_adam_kernel_matches_plain_on_card(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    g, m = (torch.randn(shape, device=cuda, generator=gen) for _ in range(2))
    v = torch.randn(shape, device=cuda, generator=gen).abs()
    v[0] = 0.0
    before = tadam.adam_scale.launches
    s, vn = tadam.adam_scale(g, m, v, 0.999, 1e-8, 0.5, 0.25)
    assert tadam.adam_scale.launches == before + 1
    s_p, vn_p = tadam.adam_scale_plain(g, m, v, 0.999, 1e-8, 0.5, 0.25)
    torch.testing.assert_close(s, s_p, rtol=ADAM_RTOL, atol=ADAM_ATOL)
    torch.testing.assert_close(vn, vn_p, rtol=ADAM_RTOL, atol=ADAM_ATOL)
