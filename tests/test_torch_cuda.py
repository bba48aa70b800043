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
# B1-B3 on bfloat16 inputs against their plain versions on the same inputs:
# O, dQ, dK and dV each rounded to bf16 once (2^-8 relative), L float32
BF16_TOL = 1e-2
BF16_L_TOL = 1e-5


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


def _adam_group(cuda, shapes, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    gs, ms, vs = [], [], []
    for shape in shapes:
        gs.append(torch.randn(shape, device=cuda, generator=gen))
        ms.append(torch.randn(shape, device=cuda, generator=gen))
        v = torch.randn(shape, device=cuda, generator=gen).abs()
        if v.numel():
            v.view(-1)[:7] = 0.0
        vs.append(v)
    return gs, ms, vs


@pytest.mark.cuda
def test_adam_grouped_kernel_matches_plain_and_groups_of_one_on_card(cuda):
    """One launch over aligned leaves beside a leaf whose g starts 4 bytes
    past a 16-byte boundary, a leaf of 97 x 33 (n % 4 == 1), a batched leaf
    and empty leaves: within the tolerances of the plain version, and
    bitwise equal to each leaf launched alone."""
    shapes = [(384, 1536), (384, 384), (97, 33), (0, 16), (8, 4, 40, 24), (5,), (0,)]
    gs, ms, vs = _adam_group(cuda, shapes, 5)
    off = torch.empty(gs[1].numel() + 1, device=cuda)
    off[1:] = gs[1].reshape(-1)
    gs[1] = off[1:].view(shapes[1])
    assert gs[1].data_ptr() % 16 == 4
    scal = (0.999, 1e-8, 0.5, 0.25)
    before = tadam.adam_scale.launches
    steps, v_news = tadam.adam_scale_grouped(gs, ms, vs, *scal)
    assert tadam.adam_scale.launches == before + 1
    for g, m, v, s, vn in zip(gs, ms, vs, steps, v_news):
        s_p, vn_p = tadam.adam_scale_plain(g, m, v, *scal)
        torch.testing.assert_close(s, s_p, rtol=ADAM_RTOL, atol=ADAM_ATOL)
        torch.testing.assert_close(vn, vn_p, rtol=ADAM_RTOL, atol=ADAM_ATOL)
        s_one, vn_one = tadam.adam_scale(g, m, v, *scal)
        assert torch.equal(s, s_one) and torch.equal(vn, vn_one)
        assert s.data_ptr() % 16 == 0 and vn.data_ptr() % 16 == 0


@pytest.mark.cuda
def test_adam_grouped_in_place_entry_writes_v_prime_over_v_on_card(cuda):
    """The in-place entry (the kernel's v_out is v) on the same ragged group:
    one launch, v' in each v's own storage, step and v' bitwise equal to
    the copying entry's."""
    shapes = [(384, 1536), (384, 384), (97, 33), (0, 16), (8, 4, 40, 24), (5,), (0,)]
    gs, ms, vs = _adam_group(cuda, shapes, 5)
    scal = (0.999, 1e-8, 0.5, 0.25)
    want_steps, want_vs = tadam.adam_scale_grouped(gs, ms, vs, *scal)
    mine = [v.clone() for v in vs]
    ptrs = [v.data_ptr() for v in mine]
    before = tadam.adam_scale.launches
    steps, v_news = tadam.adam_scale_grouped(gs, ms, mine, *scal, inplace=True)
    assert tadam.adam_scale.launches == before + 1
    assert all(a is b for a, b in zip(v_news, mine)) and [v.data_ptr() for v in mine] == ptrs
    for s, w, v, wv in zip(steps, want_steps, mine, want_vs):
        assert torch.equal(s, w) and torch.equal(v, wv)


@pytest.mark.cuda
def test_adam_grouped_kernel_splits_past_max_leaves_on_card(cuda):
    """A group of 2 * MAX_LEAVES + 3 leaves takes three launches; a group
    whose leaves are all empty takes none."""
    shapes = [(3 + i % 5, 4 + i % 3) for i in range(2 * tadam.MAX_LEAVES + 3)]
    gs, ms, vs = _adam_group(cuda, shapes, 6)
    before = tadam.adam_scale.launches
    steps, v_news = tadam.adam_scale_grouped(gs, ms, vs, 0.999, 1e-8, 0.9, 0.1)
    assert tadam.adam_scale.launches == before + 3
    for g, m, v, s, vn in zip(gs, ms, vs, steps, v_news):
        s_p, vn_p = tadam.adam_scale_plain(g, m, v, 0.999, 1e-8, 0.9, 0.1)
        torch.testing.assert_close(s, s_p, rtol=ADAM_RTOL, atol=ADAM_ATOL)
        torch.testing.assert_close(vn, vn_p, rtol=ADAM_RTOL, atol=ADAM_ATOL)
    empty = [torch.empty(0, 4, device=cuda)] * 3
    out = tadam.adam_scale_grouped(empty, empty, empty, 0.999, 1e-8, 0.9, 0.1)
    assert tadam.adam_scale.launches == before + 3
    assert [x.shape for x in out[0] + out[1]] == [(0, 4)] * 6
    assert tadam.adam_scale_grouped([], [], [], 0.999, 1e-8, 0.9, 0.1) == ([], [])


@pytest.mark.cuda
def test_adam_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.randn(64, 32, device=cuda)
    scal = (0.999, 1e-8, 0.5, 0.25)
    with pytest.raises(TypeError):
        tadam.adam_scale_grouped([a, a.double()], [a, a.double()], [a, a.double()], *scal)
    with pytest.raises(ValueError):
        tadam.adam_scale_grouped([a, a.mT], [a, a.mT], [a, a.mT], *scal)  # not contiguous
    with pytest.raises(ValueError):
        tadam.adam_scale_grouped([a, a.cpu()], [a, a.cpu()], [a, a.cpu()], *scal)
    with pytest.raises(ValueError):
        tadam.adam_scale(a, a, a[:32], *scal)  # shapes differ


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
    multiple, and ranges that give an mma.sync block's 8 warps uneven
    numbers of 16-row steps (3 steps at S = 48, 17 at S = 272)."""
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
    # the grids the launches recorded: as _f32_fwd_blocks and _f32_bwd_blocks say
    assert tflash.launched_blocks() == {"flash_fwd": _f32_fwd_blocks(shape),
                                        "flash_bwd_dq": _f32_bwd_blocks(shape),
                                        "flash_bwd_dkv": _f32_bwd_blocks(shape)}


def _f32_fwd_blocks(shape):
    """The float32 B1's grid: a cluster per 64 rows of each head, of four
    blocks at head dim 64 and two at 128 (flash_fwd_f32.cu); a block per 16
    rows at 16 and 32 (flash_fwd.cu)."""
    BH, S, dh = shape
    return {64: 4, 128: 2}[dh] * BH * -(-S // 64) if dh >= 64 else BH * -(-S // 16)


def _f32_bwd_blocks(shape):
    """The float32 B2's and B3's grid: at head dim 128 a cluster of two
    blocks per 64 rows of each head, each block computing one of the two
    score products (flash_bwd_f32.cu); a block per 16 rows at 16, 32 and
    64 (flash_bwd.cu)."""
    BH, S, dh = shape
    return 2 * BH * -(-S // 64) if dh == 128 else BH * -(-S // 16)


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


def _launch_counts():
    return tuple((f.launches, f.launches_bf16) for f in (
        tflash.flash_fwd, tflash.flash_bwd_dq, tflash.flash_bwd_dkv))


# the wgmma kernels (the bf16 B1, B2 and B3; the float32 B1 at head dims 64
# and 128) at the edges of their 64-row tiles: one tile, one
# row past it, a row short of two (also with a window of 1: each row sees
# itself), a row past two, ranges of 3 and 5 tiles, a window of 8 inside one
# tile and a ragged windowed length, at dh 64 and 128; and, for B1, keys past
# seq_len that leave rows seeing no key (window 8 from seq_len 100: rows >=
# 107; seq_len 0: every row)
TILE_CASES = [((2, S, dh), w, None) for dh in (64, 128)
              for S, w in ((64, None), (65, None), (127, None), (129, None), (192, 8),
                           (320, None), (256, 8), (200, 100), (127, 1))]
TILE_CASES += [((2, S, dh), w, n) for dh in (64, 128) for S, w, n in ((129, 8, 100),
                                                                     (65, None, 0))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,seq_len",
                         [(shape, w, None) for shape, w in (
                             ((6, 256, 64), None), ((6, 256, 64), 32), ((4, 200, 32), 100),
                             ((2, 100, 16), 16), ((3, 130, 64), None), ((1, 64, 32), 1),
                             ((6, 48, 64), None), ((2, 272, 32), None))]
                         + TILE_CASES)
def test_flash_bf16_kernels_match_plain_on_card(cuda, shape, window, seq_len):
    """B1, B2 and B3's bfloat16 entry points against their plain versions on
    the same bf16 inputs, over the float32 kernels' cases and the edges of
    the bf16 kernels' 64-row tiles: O, dQ, dK and dV come back in bf16
    within 1e-2, L in float32 within 1e-5, and each launch counts as a bf16
    launch. B1 (flash_fwd_bf16.cu), B2 and B3 (flash_bwd_bf16.cu), all on
    wgmma, launch a block per 64 rows of a head. With seq_len, rows that see
    no key give O = 0 and L = -1e30, and only B1 runs (the backward sees
    every key)."""
    q, k, v, do = (x.to(torch.bfloat16) for x in _heads(cuda, shape, seed=shape[1] + 1))
    before = _launch_counts()
    o, L = tflash.flash_fwd(q, k, v, window=window, seq_len=seq_len)
    o_p, L_p = tflash.flash_fwd_plain(q, k, v, window=window, seq_len=seq_len)
    assert o.dtype == torch.bfloat16 and L.dtype == torch.float32
    torch.testing.assert_close(o, o_p, rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(L, L_p, rtol=BF16_L_TOL, atol=BF16_L_TOL)
    if seq_len is not None:
        S = shape[1]
        dead = ~tflash.visible_mask(S, seq_len, True, window, cuda).any(-1)
        assert bool(dead.any())
        assert float(o[:, dead].abs().max()) == 0.0 and bool((L[:, dead] <= -1e29).all())
        assert _launch_counts()[0] == (before[0][0], before[0][1] + 1)
        assert tflash.launched_blocks()["flash_fwd"] == _bf16_blocks(shape)["flash_fwd"]
        return
    D = (do.float() * o.float()).sum(-1)
    dq = tflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
    dk, dv = tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
    dk_p, dv_p = tflash.flash_bwd_dkv_plain(q, k, v, do, L, D, window=window)
    for got, want in ((dq, tflash.flash_bwd_dq_plain(q, k, v, do, L, D, window=window)),
                      (dk, dk_p), (dv, dv_p)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    assert _launch_counts() == tuple((n32, n16 + 1) for n32, n16 in before)
    assert tflash.launched_blocks() == _bf16_blocks(shape)


def _bf16_blocks(shape):
    """The grids of the bf16 entry points: B1, B2 and B3 a block per 64 rows
    of each head."""
    BH, S = shape[:2]
    return dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), BH * -(-S // 64))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,seq_len", TILE_CASES)
def test_flash_f32_forward_at_its_64_row_tile_edges_on_card(cuda, shape, window, seq_len):
    """The float32 B1 at head dims 64 and 128 (3xTF32 on wgmma,
    flash_fwd_f32.cu) at the edges of its 64-row tiles, the bf16 kernels'
    cases: O and L within the reference's tolerances of the plain version,
    two runs bitwise equal, a cluster of blocks per 64 rows; with
    seq_len, rows that see no key give O = 0 and L = -1e30. B2 and B3, fed
    its L, match their plain versions."""
    q, k, v, do = _heads(cuda, shape, seed=shape[1] + 2)
    before = _launch_counts()
    o, L = tflash.flash_fwd(q, k, v, window=window, seq_len=seq_len)
    o2, L2 = tflash.flash_fwd(q, k, v, window=window, seq_len=seq_len)
    assert torch.equal(o, o2) and torch.equal(L, L2)
    assert _launch_counts()[0] == (before[0][0] + 2, before[0][1])
    assert tflash.launched_blocks()["flash_fwd"] == _f32_fwd_blocks(shape)
    o_p, L_p = tflash.flash_fwd_plain(q, k, v, window=window, seq_len=seq_len)
    torch.testing.assert_close(o, o_p, rtol=FWD_RTOL, atol=FWD_ATOL)
    torch.testing.assert_close(L, L_p, rtol=FWD_RTOL, atol=FWD_ATOL)
    if seq_len is not None:
        S = shape[1]
        dead = ~tflash.visible_mask(S, seq_len, True, window, cuda).any(-1)
        assert bool(dead.any())
        assert float(o[:, dead].abs().max()) == 0.0 and bool((L[:, dead] <= -1e29).all())
        return
    D = (do * o).sum(-1)
    dk, dv = tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
    dk_p, dv_p = tflash.flash_bwd_dkv_plain(q, k, v, do, L, D, window=window)
    for got, want in ((tflash.flash_bwd_dq(q, k, v, do, L, D, window=window),
                       tflash.flash_bwd_dq_plain(q, k, v, do, L, D, window=window)),
                      (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(got, want, rtol=BWD_RTOL, atol=BWD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", [(shape, w) for shape, w, n in TILE_CASES if n is None])
def test_flash_f32_backward_at_its_64_row_tile_edges_on_card(cuda, shape, window):
    """The float32 B2 and B3 at the edges of 64-row tiles, fed the plain
    forward's L, at head dim 128 (3xTF32 on wgmma, flash_bwd_f32.cu) and 64
    (mma.sync, flash_bwd.cu): dQ, dK and dV within the reference's
    tolerances of the plain versions, two runs bitwise equal, one float32
    launch each a run, the grids of _f32_bwd_blocks."""
    q, k, v, do = _heads(cuda, shape, seed=shape[1] + 4)
    o, L = tflash.flash_fwd_plain(q, k, v, window=window)
    D = (do * o).sum(-1)
    before = _launch_counts()
    dq = tflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
    dk, dv = tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
    dq2 = tflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
    dk2, dv2 = tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
    assert _launch_counts()[1:] == tuple((n32 + 2, n16) for n32, n16 in before[1:])
    assert tflash.launched_blocks()["flash_bwd_dq"] == _f32_bwd_blocks(shape)
    assert tflash.launched_blocks()["flash_bwd_dkv"] == _f32_bwd_blocks(shape)
    dk_p, dv_p = tflash.flash_bwd_dkv_plain(q, k, v, do, L, D, window=window)
    for got, again, want in ((dq, dq2, tflash.flash_bwd_dq_plain(q, k, v, do, L, D,
                                                                  window=window)),
                             (dk, dk2, dk_p), (dv, dv2, dv_p)):
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=BWD_RTOL, atol=BWD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", [((6, 256, 64), None), ((2, 200, 32), 100),
                                          ((2, 100, 16), 16), ((2, 320, 128), None),
                                          ((2, 129, 64), 8)])
def test_flash_bf16_kernels_are_bitwise_repeatable_on_card(cuda, shape, window):
    q, k, v, do = (x.to(torch.bfloat16) for x in _heads(cuda, shape, seed=6))
    o1, L1 = tflash.flash_fwd(q, k, v, window=window)
    o2, L2 = tflash.flash_fwd(q, k, v, window=window)
    assert torch.equal(o1, o2) and torch.equal(L1, L2)
    D = (do.float() * o1.float()).sum(-1)
    dq1 = tflash.flash_bwd_dq(q, k, v, do, L1, D, window=window)
    dq2 = tflash.flash_bwd_dq(q, k, v, do, L1, D, window=window)
    dk1, dv1 = tflash.flash_bwd_dkv(q, k, v, do, L1, D, window=window)
    dk2, dv2 = tflash.flash_bwd_dkv(q, k, v, do, L1, D, window=window)
    assert torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
def test_flash_attention_bf16_gradients_match_plain_on_card(cuda):
    """The autograd function on bf16 heads: bf16 gradients within 1e-2 of
    the plain versions' on the CPU, from the same bf16 inputs."""
    q, k, v, do = (x.to(torch.bfloat16) for x in _heads(cuda, (1, 6, 256, 64), seed=10))
    for x in (q, k, v):
        x.requires_grad_(True)
    got = torch.autograd.grad(tflash.flash_attention(q, k, v), (q, k, v), do)
    plain = [x.detach().cpu().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tflash.flash_attention(*plain), plain, do.cpu())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        torch.testing.assert_close(g.cpu(), w, rtol=BF16_TOL, atol=BF16_TOL)


# head dim 128: the qwen3_0_6b path shape (16 heads after GQA repetition, S 256)
# and windowed, ragged and uneven-range cases
DH128_CASES = [((16, 256, 128), None), ((4, 200, 128), 100), ((2, 130, 128), None),
               ((3, 48, 128), 16), ((1, 272, 128), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window", DH128_CASES)
def test_flash_kernels_at_head_dim_128_match_plain_on_card(cuda, shape, window, dtype):
    """B1, B2 and B3 at head dim 128, both entry points, against their plain
    versions (float32 at the reference's tolerances, bf16 at 1e-2 with L at
    1e-5); two runs repeat bitwise; the float32 B1, B2 and B3 launch a
    cluster of two blocks per 64 rows, the bf16 B1, B2 and B3 a block per 64
    rows."""
    q, k, v, do = (x.to(dtype) for x in _heads(cuda, shape, seed=shape[1] + 3))
    f32 = dtype == torch.float32
    fwd_tol = (FWD_RTOL, FWD_ATOL) if f32 else (BF16_TOL, BF16_TOL)
    l_tol = (FWD_RTOL, FWD_ATOL) if f32 else (BF16_L_TOL, BF16_L_TOL)
    bwd_tol = (BWD_RTOL, BWD_ATOL) if f32 else (BF16_TOL, BF16_TOL)
    o, L = tflash.flash_fwd(q, k, v, window=window)
    o_p, L_p = tflash.flash_fwd_plain(q, k, v, window=window)
    torch.testing.assert_close(o, o_p, rtol=fwd_tol[0], atol=fwd_tol[1])
    torch.testing.assert_close(L, L_p, rtol=l_tol[0], atol=l_tol[1])
    D = (do.float() * o.float()).sum(-1)
    dq = tflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
    dk, dv = tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
    assert tflash.launched_blocks() == (
        {"flash_fwd": _f32_fwd_blocks(shape), "flash_bwd_dq": _f32_bwd_blocks(shape),
         "flash_bwd_dkv": _f32_bwd_blocks(shape)} if f32 else _bf16_blocks(shape))
    dk_p, dv_p = tflash.flash_bwd_dkv_plain(q, k, v, do, L, D, window=window)
    for got, want in ((dq, tflash.flash_bwd_dq_plain(q, k, v, do, L, D, window=window)),
                      (dk, dk_p), (dv, dv_p)):
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=bwd_tol[0], atol=bwd_tol[1])
    o2, L2 = tflash.flash_fwd(q, k, v, window=window)
    dq2 = tflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
    dk2, dv2 = tflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
    for a, b in ((o, o2), (L, L2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernels_refuse_mixed_dtypes(cuda):
    y = torch.randn(2, 64, 64, device=cuda)
    b = y.to(torch.bfloat16)
    with pytest.raises(TypeError):
        tflash.flash_fwd(b, y, y)  # heads of two dtypes
    o, L = tflash.flash_fwd(b, b, b)
    with pytest.raises(TypeError):
        tflash.flash_bwd_dq(b, b, b, b, L.to(torch.bfloat16), L)  # row statistics in bf16
    with pytest.raises(TypeError):
        tflash.flash_bwd_dkv(b, b, b, y, L, L)


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


def _xlstm_mixer(kind):
    """An mLSTM or sLSTM mixer of width 64 (4 heads) from a seed, its 1-D
    leaves drawn at random, as a ``{name: tensor}`` dict on the CPU."""
    from repro_torch.configs.base import SSMConfig
    from repro_torch.models import xlstm as txl

    cfg = SSMConfig(kind="mlstm", num_heads=4, proj_factor=2.0)
    gen = torch.Generator().manual_seed(0)
    cls = txl.MLSTM if kind == "mlstm" else txl.SLSTM
    w = {k: p.detach() for k, p in cls(64, cfg, torch.float32, "cpu", gen).named_parameters()}
    for k, p in w.items():
        if p.ndim == 1:
            p += 0.2 * torch.randn(p.shape, generator=gen)
    return w, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_mixer_on_card_matches_cpu(cuda, kind):
    """The xLSTM mixer's training form and six decode steps on the card
    against the CPU, float32, within 1e-4."""
    from repro_torch.models import xlstm as txl

    w, cfg = _xlstm_mixer(kind)
    wc = {k: v.to(cuda) for k, v in w.items()}
    u = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(1))
    fn = txl.mlstm_train if kind == "mlstm" else txl.slstm_train
    torch.testing.assert_close(fn(wc, u.to(cuda), cfg).cpu(), fn(w, u, cfg),
                               rtol=1e-4, atol=1e-4)
    if kind == "mlstm":
        caches = [txl.init_mlstm_cache(2, 64, cfg, d) for d in ("cpu", cuda)]
        dec = txl.mlstm_decode
    else:
        caches = [txl.init_slstm_cache(2, 64, cfg, torch.float32, d) for d in ("cpu", cuda)]
        dec = txl.slstm_decode
    for t in range(6):
        y, caches[0] = dec(w, u[:, t: t + 1], caches[0], cfg)
        yc, caches[1] = dec(wc, u[:, t: t + 1].to(cuda), caches[1], cfg)
        torch.testing.assert_close(yc.cpu(), y, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_rotation_products_on_full_width_xlstm_leaves_match_cpu(cuda):
    """B4's grouped products on the card against the CPU's plain versions
    on full-width sLSTM leaves with orthogonal bases, both directions:
    ff_up and ff_down with a side of 2662 (rows not 16-byte aligned) and the
    3-D w_r, one problem of batch 4; two launches a direction."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    shapes = [(2048, 2662), (2662, 2048), (4, 512, 2048)]

    def basis(batch, n):
        return torch.linalg.qr(torch.randn(batch + (n, n), generator=gen))[0]

    xs = [torch.randn(s, generator=gen) for s in shapes]
    Us = [basis(s[:-2], s[-2]) for s in shapes]
    Vs = [basis(s[:-2], s[-1]) for s in shapes]
    for transpose in (True, False):
        want = ops.two_sided_rotate_grouped(xs, Us, Vs, transpose=transpose)
        before = tmm.matmul.launches
        got = ops.two_sided_rotate_grouped([x.to(cuda) for x in xs], [u.to(cuda) for u in Us],
                                           [v.to(cuda) for v in Vs], transpose=transpose)
        assert tmm.matmul.launches == before + 2
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=ROT_RTOL, atol=ROT_ATOL)


def _path_operands(cuda, problems, seed):
    """Random operands on the card for (batch, M, K, N, trans_a, trans_b)
    problems, A scaled by 1/sqrt(K) so that outputs are O(1)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    As, Bs = [], []
    for b, M, K, N, ta, tb in problems:
        As.append(torch.randn((b, K, M) if ta else (b, M, K), device=cuda, generator=gen)
                  / K ** 0.5)
        Bs.append(torch.randn((b, N, K) if tb else (b, K, N), device=cuda, generator=gen))
    return As, Bs


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(7168, 20480), (20480, 7168), (2048, 8192), (8192, 2048)])
def test_rotation_products_at_the_frontend_paths_widest_leaves_on_card(cuda, m, n):
    """B4 at llava_next_34b's MLP leaves (7168 x 20480 and its transpose:
    the contraction reaches K = 20480) and musicgen_large's (2048 x 8192):
    the four products a rotated leaf takes (U^T G, G V, U S, S V^T), each
    its own grouped launch as on the sim path, against the plain version
    on the card within the rotation parity tolerance."""
    for i, (problems, ta, tb) in enumerate((
            ([(1, m, m, n, True, False)], True, False), ([(1, m, n, n, False, False)], False,
                                                         False),
            ([(1, m, m, n, False, False)], False, False), ([(1, m, n, n, False, True)], False,
                                                           True))):
        As, Bs = _path_operands(cuda, problems, seed=i)
        before = tmm.matmul.launches
        got = tmm.matmul_grouped(As, Bs, trans_a=ta, trans_b=tb)
        assert tmm.matmul.launches == before + 1
        want = tmm.matmul_grouped_plain(As, Bs, trans_a=ta, trans_b=tb)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=ROT_RTOL, atol=ROT_ATOL)
        del As, Bs, got, want
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_rotation_products_on_batched_expert_stacks_match_cpu(cuda):
    """B4's grouped products on expert stacks (E, d, f) with orthogonal
    bases, as the sim path (batch E) and the SPMD path ((K, per, E, ...)
    stacked: batch K per E) give them, both directions, against the CPU's
    plain versions; two launches a direction."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    shapes = [(8, 256, 640), (8, 640, 256), (2, 1, 4, 256, 640)]

    def basis(batch, n):
        return torch.linalg.qr(torch.randn(batch + (n, n), generator=gen))[0]

    xs = [torch.randn(s, generator=gen) for s in shapes]
    Us = [basis(s[:-2], s[-2]) for s in shapes]
    Vs = [basis(s[:-2], s[-1]) for s in shapes]
    for transpose in (True, False):
        want = ops.two_sided_rotate_grouped(xs, Us, Vs, transpose=transpose)
        before = tmm.matmul.launches
        got = ops.two_sided_rotate_grouped([x.to(cuda) for x in xs], [u.to(cuda) for u in Us],
                                           [v.to(cuda) for v in Vs], transpose=transpose)
        assert tmm.matmul.launches == before + 2
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g.cpu(), w, rtol=ROT_RTOL, atol=ROT_ATOL)


@pytest.mark.cuda
def test_adam_grouped_at_llava_leaves_on_card(cuda):
    """B5's grouped in-place launch over one llava_next_34b layer's seven
    rotated leaves (558 M floats: the 7168 x 20480 MLP leaves beside the
    attention's) against its plain version on the card."""
    shapes = [(7168, 1024), (7168, 7168), (7168, 7168), (7168, 1024), (20480, 7168),
              (7168, 20480), (7168, 20480)]
    gen = torch.Generator(device=cuda).manual_seed(3)
    gs = [torch.randn(s, device=cuda, generator=gen) * 1e-3 for s in shapes]
    ms = [torch.randn(s, device=cuda, generator=gen) * 1e-3 for s in shapes]
    vs = [torch.rand(s, device=cuda, generator=gen) * 1e-6 + 1e-8 for s in shapes]
    scalars = (0.999, 1e-8, 1 - 0.9 ** 4, 1 - 0.999 ** 4)
    want = [tadam.adam_scale_plain(g, m, v, *scalars) for g, m, v in zip(gs, ms, vs)]
    before = tadam.adam_scale.launches
    steps, v_new = tadam.adam_scale_grouped(gs, ms, vs, *scalars, inplace=True)
    assert tadam.adam_scale.launches == before + 1
    assert all(a is b for a, b in zip(v_new, vs))
    for s, v, (s_w, v_w) in zip(steps, v_new, want):
        torch.testing.assert_close(s, s_w, rtol=ADAM_RTOL, atol=ADAM_ATOL)
        torch.testing.assert_close(v, v_w, rtol=ADAM_RTOL, atol=ADAM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_on_card_matches_cpu(cuda, capacity_factor):
    """The MoE MLP (routing, capacity, dispatch and combine einsums, aux
    loss) and its gradients on the card against the CPU, float32, within
    1e-4; at a capacity factor of 0.25 tokens overflow."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe

    cfg = MoEConfig(num_experts=8, top_k=2, num_shared=1, capacity_factor=capacity_factor,
                    group_size=96)
    gen = torch.Generator().manual_seed(0)
    layer = moe.MoE(128, 256, cfg, "swiglu", torch.float32, "cpu", gen)
    w = {k.replace(".", "/"): p.detach() for k, p in layer.named_parameters()}
    x = torch.randn((4, 48, 128), generator=gen)
    outs = []
    for dev in ("cpu", cuda):
        wd = {k: v.to(dev).requires_grad_() for k, v in w.items()}
        xd = x.to(dev).requires_grad_()
        y, aux = moe.apply_moe(wd, xd, cfg)
        grads = torch.autograd.grad(y.square().mean() + aux, [xd, *wd.values()])
        outs.append([y.detach().cpu(), aux.detach().cpu()] + [g.cpu() for g in grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
