"""The port's kernel modules against the JAX reference kernels.

On the CPU the wrappers take their plain PyTorch versions; these are held
to the reference's Pallas kernels (interpret mode) and its ``ref.py``
oracles on the same numpy inputs, with ``tests/test_kernels.py``'s shapes
and tolerances. ``tests/test_torch_cuda.py`` holds the CUDA kernels to the
plain versions on the card.
"""
import contextlib
import bisect

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

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

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
    # numpy's BLAS pool too: its idle threads spin on the cores the others need
    with threadpool_limits(limits=1, user_api="blas"):
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


# (batch or None for 2-D operands, M, K, N): a group of mixed, ragged shapes
GROUP = [(None, 128, 128, 128), (2, 64, 256, 64), (None, 100, 50, 70), (3, 17, 33, 65),
         (None, 256, 384, 128)]


@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True)])
def test_matmul_grouped_is_the_plain_loop_and_matches_pallas_matmul(trans_a, trans_b):
    rng = np.random.RandomState(8)
    As, Bs, plain = [], [], []
    for batch, M, K, N in GROUP:
        lead = () if batch is None else (batch,)
        a = rng.randn(*lead, M, K).astype(np.float32)
        b = rng.randn(*lead, K, N).astype(np.float32)
        As.append(_t(np.swapaxes(a, -1, -2) if trans_a else a))
        Bs.append(_t(np.swapaxes(b, -1, -2) if trans_b else b))
        plain.append((a.reshape(-1, M, K), b.reshape(-1, K, N)))
    before = tmm.matmul.launches
    got = tmm.matmul_grouped(As, Bs, trans_a=trans_a, trans_b=trans_b)
    assert tmm.matmul.launches == before  # CPU tensors never count a launch
    for out, a, b, (a3, b3) in zip(got, As, Bs, plain):
        assert torch.equal(out, tmm.matmul_plain(a, b, trans_a=trans_a, trans_b=trans_b))
        want = np.stack([np.asarray(jops.pallas_matmul(_j(x), _j(y))) for x, y in zip(a3, b3)])
        np.testing.assert_allclose(out.numpy().reshape(want.shape), want,
                                   rtol=ROT_RTOL, atol=ROT_ATOL)


def _tile_owner(dims, order, start, tile):
    """(problem, batch entry, first row, first column) of block ``tile``,
    found as ``csrc/matmul.cu`` finds it: the last prefix-sum entry at or
    below the block, then batch entry, tile row and tile column."""
    slot = bisect.bisect_right(start, tile) - 1
    batch, M, N, _ = dims[order[slot]]
    tiles_n = -(-N // tmm.TILE_N)
    b, rem = divmod(tile - start[slot], -(-M // tmm.TILE_M) * tiles_n)
    return order[slot], b, (rem // tiles_n) * tmm.TILE_M, (rem % tiles_n) * tmm.TILE_N


def _path_group_dims():
    """(batch, M, N, K) of the sim path's first grouped launch at paper_95m:
    U^T G and U^T M over all 192 rotated leaves."""
    from repro_torch.configs import get_config
    from repro_torch.core.layout import build_layout
    from repro_torch.models import Transformer, param_leaves

    cfg = get_config("paper_95m").replace(scan_layers=False)
    plans = build_layout(param_leaves(Transformer(cfg, device="meta", seed=None)), "bilateral")
    return [(1, p.shape[0], p.shape[1], p.shape[0]) for p in plans if p.rotate] * 2


@pytest.mark.parametrize("dims", [
    [(1, 100, 70, 50), (3, 17, 65, 33), (2, 300, 129, 7), (1, 128, 128, 128), (4, 257, 1, 1000)],
    [(32, 384, 1536, 384)] * 3 + [(32, 1536, 384, 1536)],
    "sim_path",
])
def test_tile_table_gives_every_output_tile_exactly_once(dims):
    """The launch's schedule, walked as the kernel walks it: block t maps to
    (problem, batch entry, tile row, tile column), and every output tile of
    every problem belongs to exactly one block. Longest K first."""
    dims = _path_group_dims() if dims == "sim_path" else dims
    order, start = tmm.tile_table(dims)
    assert sorted(order) == list(range(len(dims)))
    assert [dims[i][3] for i in order] == sorted((d[3] for d in dims), reverse=True)
    owners = [_tile_owner(dims, order, start, t) for t in range(start[-1])]
    want = {(p, b, m0, n0) for p, (batch, M, N, _) in enumerate(dims) for b in range(batch)
            for m0 in range(0, M, tmm.TILE_M) for n0 in range(0, N, tmm.TILE_N)}
    assert len(owners) == len(want) and set(owners) == want
    if len(dims) == 384:
        assert start[-1] == 6912  # 32 layers x 2 x (4 x 9 + 36 + 36) tiles of 128 x 128


@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True)])
def test_launch_tables_hold_each_problem_once_in_schedule_order(trans_a, trans_b):
    """The tables the kernel receives: one launch per 512 problems, each
    problem's pointers and sizes in ``tile_table``'s order, and 16-byte
    loads only for an operand that starts aligned with rows of a multiple
    of 4 floats."""
    rng = np.random.RandomState(12)
    dims = [tuple(int(x) for x in (rng.randint(1, 4), *rng.randint(1, 300, 3)))
            for _ in range(1100)]
    ptrs = [(16 * int(rng.randint(1, 1 << 20)) + 4 * int(rng.randint(0, 2)),
             16 * int(rng.randint(1, 1 << 20)) + 4 * int(rng.randint(0, 2)), 16 * i)
            for i in range(len(dims))]
    tables = tmm.launch_tables(ptrs, dims, trans_a, trans_b)
    assert [len(p) for p, _, _ in tables] == [512, 512, 76]
    for n, (p, meta, tiles) in enumerate(tables):
        part = dims[512 * n:512 * (n + 1)]
        order, start = tmm.tile_table(part)
        assert p.dtype == np.int64 and meta.dtype == np.int32 and tiles.dtype == np.int32
        assert list(tiles) == start
        for row, i in enumerate(order):
            batch, M, N, K = part[i]
            a, b, c = ptrs[512 * n + i]
            a_vec = a % 16 == 0 and (M if trans_a else K) % 4 == 0
            b_vec = b % 16 == 0 and (K if trans_b else N) % 4 == 0
            assert list(p[row]) == [a, b, c]
            assert list(meta[row]) == [M, N, K, batch, a_vec + 2 * b_vec]


@pytest.mark.parametrize("transpose", [True, False])
def test_two_sided_rotate_grouped_is_per_leaf_bitwise(transpose):
    """Bilateral and unilateral leaves, with batch dims, in one group: each
    leaf gets exactly the products a rotation of its own would make, in the
    same order, and the result matches the reference oracle."""
    rng = np.random.RandomState(9)
    leaves = [((3,), 48, 32, "bi"), ((), 24, 40, "left"), ((2, 2), 16, 24, "right"),
              ((), 32, 32, "bi")]
    xs, Us, Vs = [], [], []
    for batch, m, n, sides in leaves:
        xs.append(rng.randn(*batch, m, n).astype(np.float32))
        Us.append(np.linalg.qr(rng.randn(*batch, m, m))[0].astype(np.float32)
                  if sides != "right" else None)
        Vs.append(np.linalg.qr(rng.randn(*batch, n, n))[0].astype(np.float32)
                  if sides != "left" else None)
    got = tops.two_sided_rotate_grouped([_t(x) for x in xs], [_t(U) for U in Us],
                                        [_t(V) for V in Vs], transpose=transpose)
    for out, x, U, V in zip(got, xs, Us, Vs):
        m, n = x.shape[-2:]
        y = _t(x).reshape(-1, m, n)
        if U is not None:
            y = tmm.matmul_plain(_t(U).reshape(-1, m, m), y, trans_a=transpose)
        if V is not None:
            y = tmm.matmul_plain(y, _t(V).reshape(-1, n, n), trans_b=not transpose)
        assert out.shape == x.shape and torch.equal(out, y.reshape(x.shape))
        oracle = np.asarray(jref.two_sided_rotate_ref(_j(x), _j(U), _j(V), transpose))
        np.testing.assert_allclose(out.numpy(), oracle, rtol=ROT_RTOL, atol=ROT_ATOL)


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


# a ragged group: 2-D, stacked 4-D, odd-sized, 1-D and empty leaves
ADAM_GROUP = [(64, 64), (2, 3, 16, 24), (17, 33), (0, 8), (7,), (3, 0, 5), (40, 24)]


@pytest.mark.parametrize("shapes", [ADAM_GROUP, ADAM_GROUP[:1], []])
def test_adam_scale_grouped_is_the_plain_loop_and_matches_reference(shapes):
    """On the CPU the grouped wrapper is the loop of the plain version,
    bitwise, leaf by leaf; each leaf with elements also matches the Pallas
    kernel (interpret mode), within test_adam_scale_matches_reference's
    tolerance."""
    leaves = [_adam_inputs(shape, 20 + i, 1e-3) for i, shape in enumerate(shapes)]
    scal = (0.999, 1e-8, 0.5, 0.25)
    gs, ms, vs = ([_t(leaf[j]) for leaf in leaves] for j in range(3))
    steps, v_news = tadam.adam_scale_grouped(gs, ms, vs, *scal)
    assert len(steps) == len(v_news) == len(shapes)
    for (g, m, v), s, vn in zip(leaves, steps, v_news):
        s_p, vn_p = tadam.adam_scale_plain(_t(g), _t(m), _t(v), *scal)
        assert s.shape == vn.shape == g.shape
        assert torch.equal(s, s_p) and torch.equal(vn, vn_p)
        if g.size:
            s_k, vn_k = jops.adam_scale(_j(g), _j(m), _j(v), *scal)
            np.testing.assert_allclose(s.numpy(), np.asarray(s_k), rtol=ADAM_RTOL,
                                       atol=ADAM_ATOL)
            np.testing.assert_allclose(vn.numpy(), np.asarray(vn_k), rtol=ADAM_RTOL,
                                       atol=ADAM_ATOL)
    via_ops = tops.adam_scale_grouped(gs, ms, vs, *scal)
    assert all(torch.equal(a, b) for a, b in zip(via_ops[0] + via_ops[1], steps + v_news))


def _chunk_owner(start, chunk):
    """The leaf the kernel's binary search gives chunk ``chunk``."""
    lo, hi = 0, len(start) - 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if start[mid] <= chunk:
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("numels", [
    [147456] * 128 + [589824] * 64,  # the sim path's 192 leaves
    [4718592] * 4 + [18874368] * 2,  # the SPMD path's 6 stacked leaves
    [0, 5, 0, 4096, 1023, 1, 0],  # ragged, empty leaves at both ends
    [3 * 2 ** 31 + 5, 12],  # a leaf past 2^31 elements
    list(range(0, 2 * tadam.MAX_LEAVES + 3, 1)),  # three launches
])
def test_adam_launch_tables_cover_every_element_once(numels):
    """Without a card: the launch tables split the group at MAX_LEAVES,
    keep the leaves in order with 64-bit counts, and give every element of
    every leaf to exactly one chunk, as the kernel's search reads them."""
    rng = np.random.RandomState(5)
    ptrs = [tuple(int(x) for x in 16 * rng.randint(1, 2 ** 40, size=5)) for _ in numels]
    tables = tadam.launch_tables(ptrs, numels)
    assert len(tables) == -(-len(numels) // tadam.MAX_LEAVES)
    seen = []
    for p, n, vec, start, chunk in tables:
        assert p.dtype == n.dtype == np.int64 and vec.dtype == start.dtype == np.int32
        assert len(p) == len(n) == len(vec) == len(start) - 1 <= tadam.MAX_LEAVES
        assert chunk == tadam.chunk_size(int(n.sum()))
        assert chunk % (4 * tadam.THREADS) == 0
        assert tadam.CHUNK_MIN <= chunk <= tadam.CHUNK_MAX
        assert start[0] == 0 and all(np.diff(start) == -(-n // chunk))
        owners = [_chunk_owner(start, c) for c in range(start[-1])]
        for i, count in enumerate(n):  # leaf i's chunks are its own, in order, and cover it
            mine = [c for c, o in enumerate(owners) if o == i]
            assert mine == list(range(start[i], start[i + 1]))
            assert len(mine) * chunk >= count > (len(mine) - 1) * chunk
        seen += [tuple(int(x) for x in row) for row in p]
    assert seen == ptrs
    assert [int(x) for t in tables for x in t[1]] == list(numels)


def test_adam_launch_table_flags_need_aligned_pointers_and_whole_vectors():
    base = 1 << 20
    ptrs = [(base,) * 5, (base,) * 5, (base,) * 4 + (base + 4,), (base + 8,) + (base,) * 4,
            (base,) * 5]
    numels = [4096, 4098, 4096, 4096, 0]
    (_, _, vec, start, chunk), = tadam.launch_tables(ptrs, numels)
    assert vec.tolist() == [1, 0, 0, 0, 1]
    assert chunk == tadam.CHUNK_MIN and start.tolist() == [0, 4, 9, 13, 17, 17]
    assert tadam.chunk_size(56_623_104) == tadam.CHUNK_MAX  # a paper_95m step's elements
    assert tadam.chunk_size(384 * 384) == tadam.CHUNK_MIN  # one 384 x 384 leaf: 144 blocks
