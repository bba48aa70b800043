"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a GPU and ``nvcc`` and skips without them. The file
imports neither JAX nor the reference package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import adam_step as tadam
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import matmul as tmm

# tests/test_kernels.py's tolerances: rotation parity (:41), fused Adam (:51),
# flash forward (:87) and backward (:137-142)
ROT_RTOL, ROT_ATOL = 2e-3, 1e-4
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6
FWD_RTOL, FWD_ATOL = 2e-3, 2e-4
BWD_RTOL, BWD_ATOL = 2e-3, 1e-4


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
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_matmul_grouped_kernel_matches_plain_on_card(cuda, trans_a, trans_b):
    """One launch over problems of mixed shapes: a path shape, ragged edges,
    batched and 2-D operands, and rows that are not 16-byte aligned."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    As, Bs = [], []
    for batch, M, K, N in [(1, 384, 384, 1536), (1, 100, 70, 50), (3, 17, 33, 65),
                           (2, 130, 257, 129), (None, 64, 32, 48)]:
        lead = (batch,) if batch else ()
        a = torch.randn(lead + ((K, M) if trans_a else (M, K)), device=cuda, generator=gen)
        As.append(a / K ** 0.5)
        Bs.append(torch.randn(lead + ((N, K) if trans_b else (K, N)), device=cuda,
                              generator=gen))
    before = tmm.matmul.launches
    got = tmm.matmul_grouped(As, Bs, trans_a=trans_a, trans_b=trans_b)
    assert tmm.matmul.launches == before + 1
    want = tmm.matmul_grouped_plain(As, Bs, trans_a=trans_a, trans_b=trans_b)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=ROT_RTOL, atol=ROT_ATOL)
    again = tmm.matmul_grouped(As[::-1], Bs[::-1], trans_a=trans_a, trans_b=trans_b)
    for g, a in zip(got, again[::-1]):  # a product does not depend on its group
        assert torch.equal(g, a)


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


def _heads(cuda, shape, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, device=cuda, generator=gen) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", [((6, 256, 64), None), ((6, 256, 64), 32),
                                          ((4, 200, 32), 100), ((2, 100, 16), 16),
                                          ((3, 130, 64), None), ((1, 64, 32), 1),
                                          ((6, 48, 64), None), ((2, 272, 32), None)])
def test_flash_kernels_match_plain_on_card(cuda, shape, window):
    """B1, B2 and B3 against their plain versions: the training shape,
    windows that leave whole tiles masked, lengths that are no tile
    multiple, and ranges that give a block's 8 warps uneven numbers of
    16-row steps (3 steps at S = 48, 17 at S = 272)."""
    q, k, v, do = _heads(cuda, shape, seed=shape[1] + (window or 0))
    before = (tflash.flash_fwd.launches, tflash.flash_bwd_dq.launches,
              tflash.flash_bwd_dkv.launches)
    o, L = tflash.flash_fwd(q, k, v, window=window)
    o_p, L_p = tflash.flash_fwd_plain(q, k, v, window=window)
    torch.testing.assert_close(o, o_p, rtol=FWD_RTOL, atol=FWD_ATOL)
    torch.testing.assert_close(L, L_p, rtol=FWD_RTOL, atol=FWD_ATOL)
    D = (do * o).sum(-1)
    dq = tflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
    dk, dv = tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
    torch.testing.assert_close(dq, tflash.flash_bwd_dq_plain(q, k, v, do, L, D, window=window),
                               rtol=BWD_RTOL, atol=BWD_ATOL)
    dk_p, dv_p = tflash.flash_bwd_dkv_plain(q, k, v, do, L, D, window=window)
    torch.testing.assert_close(dk, dk_p, rtol=BWD_RTOL, atol=BWD_ATOL)
    torch.testing.assert_close(dv, dv_p, rtol=BWD_RTOL, atol=BWD_ATOL)
    assert (tflash.flash_fwd.launches, tflash.flash_bwd_dq.launches,
            tflash.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    # the grids the launches recorded: one block per 16 rows of each head
    blocks = shape[0] * -(-shape[1] // 16)
    assert tflash.launched_blocks() == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", [((6, 256, 64), None), ((2, 200, 32), 100),
                                          ((6, 256, 64), 32), ((3, 130, 64), None),
                                          ((2, 100, 16), 16)])
def test_flash_forward_is_bitwise_repeatable_on_card(cuda, shape, window):
    """B1, B2 and B3 merge their warps' partial sums in a fixed order and use
    no atomics: two runs of each give the same bits."""
    q, k, v, do = _heads(cuda, shape, seed=5)
    o1, L1 = tflash.flash_fwd(q, k, v, window=window)
    o2, L2 = tflash.flash_fwd(q, k, v, window=window)
    assert torch.equal(o1, o2) and torch.equal(L1, L2)
    D = (do * o1).sum(-1)
    dq1 = tflash.flash_bwd_dq(q, k, v, do, L1, D, window=window)
    dq2 = tflash.flash_bwd_dq(q, k, v, do, L1, D, window=window)
    dk1, dv1 = tflash.flash_bwd_dkv(q, k, v, do, L1, D, window=window)
    dk2, dv2 = tflash.flash_bwd_dkv(q, k, v, do, L1, D, window=window)
    assert torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
def test_flash_fully_masked_rows_on_card(cuda):
    """Keys past seq_len masked and a window of 8: rows >= 107 see no key,
    so their O is exactly 0 and their L the -1e30 sentinel."""
    q, k, v, _ = _heads(cuda, (1, 128, 16), seed=3)
    o, L = tflash.flash_fwd(q, k, v, window=8, seq_len=100)
    o_p, L_p = tflash.flash_fwd_plain(q, k, v, window=8, seq_len=100)
    assert float(o[:, 107:].abs().max()) == 0.0
    assert bool((L[:, 107:] <= -1e29).all())
    torch.testing.assert_close(o, o_p, rtol=FWD_RTOL, atol=FWD_ATOL)
    torch.testing.assert_close(L, L_p, rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.cuda
def test_flash_attention_gradients_match_plain_on_card(cuda):
    q, k, v, do = _heads(cuda, (1, 6, 256, 64), seed=9)
    grads = []
    for x in (q, k, v):
        x.requires_grad_(True)
    for fn in (tflash.flash_attention, tflash.flash_attention):
        out = fn(q, k, v)
        grads.append(torch.autograd.grad(out, (q, k, v), do))
    plain = [x.detach().cpu().requires_grad_(True) for x in (q, k, v)]
    out_cpu = tflash.flash_attention(*plain)  # the plain versions, on the CPU
    want = torch.autograd.grad(out_cpu, plain, do.cpu())
    for got, w in zip(grads[0], want):
        torch.testing.assert_close(got.cpu(), w, rtol=BWD_RTOL, atol=BWD_ATOL)
    for a, b in zip(grads[0], grads[1]):  # no atomics: bitwise repeatable
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(2, 64, 48, device=cuda)  # head dim 48 has no kernel
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_fwd(x, x, x)
    y = torch.randn(2, 64, 64, device=cuda)
    with pytest.raises(TypeError):
        tflash.flash_fwd(y.double(), y.double(), y.double())
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_fwd(y.mT, y.mT, y.mT)
