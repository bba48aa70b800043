"""The bf16_compute precision policy on the port's SPMD backend, against the
JAX reference: the policy layer (as tests/test_precision.py:22-47 holds the
reference's), the flash kernels' plain versions on bfloat16 inputs against
the reference's Pallas kernels (interpret mode) and its float32 oracle, both
schedules' bf16 loss curves and bf16 checkpoints against the reference's
``SpmdEngine(precision="bf16")`` on two forced host devices (one
subprocess), and the dtype check with the reference's two mutations
(tests/test_precision.py:108-173).

Measured gaps to the reference on the CPU (Adam, 4 steps): fill-drain
1.55e-3 on every loss, 1F1B 1.55e-3 on the first and 2.0e-3 at most, the
checkpoint continuations 2.8e-3 and 2.1e-4 (held to 1e-2 on the first loss
and 3e-2 on every loss). ``bf16_operand_split_errors`` measures the two
float32-accurate splits of a float32 operand against a bf16 one: 2xTF32
3.9e-8, three bf16 pieces 0.0 (relative, at its default seed).
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PRECISION_POLICIES as JPRECISION_POLICIES
from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.engine.spmd import stack_stage_params as jstack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.model import init_model as jinit_model
from repro_torch.analysis import (
    BF16_COMPUTE_POLICY,
    check_dtype_policy,
    record_float_dtypes,
    state_leaves,
)
from repro_torch.checkpoint.ckpt import load_checkpoint
from repro_torch.checkpoint.convert import stacked_from_numpy
from repro_torch.configs import OptimizerConfig
from repro_torch.configs.base import (
    PRECISION_POLICIES,
    AttentionConfig,
    BlockSpec,
    ModelConfig,
    PrecisionPolicy,
)
from repro_torch.data import batches
from repro_torch.engine import LoopConfig, SpmdEngine, resume_if_present, run_loop
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.model import cast_params

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHAPE = dict(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
              scan_layers=False)
JCFG = JModelConfig(attention=JAttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                    pattern=(JBlockSpec("attn", "dense"),), **_SHAPE)
TCFG = ModelConfig(attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                   pattern=(BlockSpec("attn", "dense"),), **_SHAPE)
K, M, STEPS, CUT, MB, S = 2, 2, 4, 2, 2, 16
ADAM = {"name": "adam", "learning_rate": 1e-3, "schedule": "constant"}
# two implementations of a bf16 step round at other places: losses held to
# 1e-2 on the first step and 3e-2 on every step
FIRST_TOL, ALL_TOL = 1e-2, 3e-2
# the reference's bf16 flash tolerances against its float32 oracle:
# forward tests/test_kernels.py:100, backward :162
BF16_FWD_TOL, BF16_BWD_TOL = 3e-2, 6e-2


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


@pytest.fixture(scope="module")
def ref_params():
    return jinit_model(jax.random.PRNGKey(0), JCFG)


def _stacked_pair(ref_params):
    return stacked_from_numpy(jax.tree.map(np.asarray, jstack(ref_params, JCFG, K)), "cpu")


# ---------------------------------------------------------------------------
# the policy layer
# ---------------------------------------------------------------------------


def test_precision_policy_registry_and_apply():
    assert set(PRECISION_POLICIES) == set(JPRECISION_POLICIES) == {"f32", "bf16"}
    for key, pol in PRECISION_POLICIES.items():
        ref = JPRECISION_POLICIES[key]
        assert (pol.name, pol.dtype, pol.param_dtype, pol.logits_fp32) == \
            (ref.name, ref.dtype, ref.param_dtype, ref.logits_fp32)
    f32, bf16 = PRECISION_POLICIES["f32"], PRECISION_POLICIES["bf16"]
    assert f32.name == "f32" and bf16.name == "bf16_compute"
    out = bf16.apply(ModelConfig())
    assert out.dtype == "bfloat16" and out.param_dtype == "float32" and out.logits_fp32
    assert out.compute_dtype == torch.bfloat16 and out.params_dtype == torch.float32
    back = f32.apply(out)
    assert back.dtype == "float32" and back.param_dtype == "float32"


def test_precision_policy_is_declarative():
    cfg = ModelConfig(num_layers=7, d_model=40, use_kernels=True)
    out = PRECISION_POLICIES["bf16"].apply(cfg)
    assert (out.num_layers, out.d_model, out.use_kernels) == (7, 40, True)
    out = PrecisionPolicy(name="x", dtype="bfloat16", param_dtype="bfloat16",
                          logits_fp32=False).apply(cfg)
    assert out.param_dtype == "bfloat16" and out.logits_fp32 is False


def test_cast_params_casts_floating_leaves_and_returns_float32_gradients():
    w = torch.randn(3, 4, requires_grad=True)
    idx = torch.arange(3)
    out = cast_params({"w": w, "idx": idx}, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["idx"] is idx
    assert cast_params({"w": w}, torch.float32)["w"] is w  # f32 policy: no copy
    (g,) = torch.autograd.grad(out["w"].float().sum(), w)
    assert g.dtype == torch.float32 and torch.equal(g, torch.ones_like(w))


# ---------------------------------------------------------------------------
# B1-B3's plain versions on bfloat16 inputs
# ---------------------------------------------------------------------------


def _bf16_pair(x):
    """One bf16 tensor for each package, from the same float32 numpy array."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def test_flash_forward_plain_takes_bf16_as_the_reference_kernel_does():
    """tests/test_kernels.py:90 on the port: O in bf16, within 3e-2 of the
    float32 oracle and of the reference's Pallas kernel on the same bf16
    inputs; L stays float32."""
    rng = np.random.RandomState(0)
    (jq, q), (jk, k), (jv, v) = (_bf16_pair(rng.randn(1, 2, 128, 64).astype(np.float32))
                                 for _ in range(3))
    got = tops.attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want_kernel = jops.attention(jq, jk, jv, block_q=64, block_k=64)
    assert want_kernel.dtype == jnp.bfloat16
    want_ref = jref.flash_attention_ref(jq, jk, jv)
    got32 = got.float().numpy()
    for want in (np.asarray(want_kernel, np.float32), np.asarray(want_ref, np.float32),
                 tref.flash_attention_ref(q, k, v).numpy()):
        np.testing.assert_allclose(got32, want, rtol=BF16_FWD_TOL, atol=BF16_FWD_TOL)
    o, L = tflash.flash_fwd(q.reshape(2, 128, 64), k.reshape(2, 128, 64),
                            v.reshape(2, 128, 64))
    assert o.dtype == torch.bfloat16 and L.dtype == torch.float32


def test_flash_backward_plain_takes_bf16_as_the_reference_kernels_do():
    """tests/test_kernels.py:145 on the port (S = 200, window 24): dQ, dK and
    dV in bf16, within 6e-2 of the float32 oracle's gradients and of the
    reference's Pallas kernels' on the same bf16 inputs."""
    rng = np.random.RandomState(1)
    xs = [rng.randn(1, 2, 200, 32).astype(np.float32) for _ in range(4)]
    (jq, q), (jk, k), (jv, v), (jdo, do) = (_bf16_pair(x) for x in xs)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(tops.attention(q, k, v, window=24), (q, k, v), do)

    def grads(fwd, q, k, v, do):
        return jax.grad(lambda q, k, v: jnp.sum(fwd(q, k, v) * do), argnums=(0, 1, 2))(q, k, v)

    want_kernel = grads(lambda q, k, v: jops.attention(q, k, v, window=24), jq, jk, jv, jdo)
    up = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    want_ref = grads(lambda q, k, v: jref.flash_attention_ref(q, k, v, window=24), *up,
                     jnp.asarray(xs[3]))
    for g, wk, wr, name in zip(got, want_kernel, want_ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and wk.dtype == jnp.bfloat16, name
        for want in (np.asarray(wk, np.float32), np.asarray(wr)):
            np.testing.assert_allclose(g.float().numpy(), want, rtol=BF16_BWD_TOL,
                                       atol=BF16_BWD_TOL, err_msg=name)


def _tf32(x):
    """float32 -> TF32 (10 mantissa bits), round to nearest, ties away: cvt.rna.tf32.f32."""
    b = x.astype(np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16(x):
    """float32 -> bfloat16, round to nearest even."""
    b = x.astype(np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def bf16_operand_split_errors(seed=0, n=256):
    """Relative error, against float64, of a float32 P (softmax weights, as
    B1's P V and B3's P^T dO see them) times a bf16 V, for the two splits of
    P that keep it float32-accurate on tensor cores: 2xTF32 (P = big + small
    in TF32; the kernels' choice) and three bf16 pieces (P = hi + mid + lo).
    Products and sums are exact here (float64), so this is the error of the
    splits alone. Returns {split: relative Frobenius error}."""
    rng = np.random.RandomState(seed)
    s = rng.randn(n, n)
    p = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
    v = _bf16(rng.randn(n, 64).astype(np.float32)).astype(np.float64)
    exact = p.astype(np.float64) @ v
    big = _tf32(p)
    tf32x2 = big.astype(np.float64) + _tf32(p - big).astype(np.float64)
    hi = _bf16(p)
    mid = _bf16(p - hi)
    bf16x3 = hi.astype(np.float64) + mid + _bf16(p - hi - mid)
    return {name: float(np.linalg.norm(a @ v - exact) / np.linalg.norm(exact))
            for name, a in (("2xtf32", tf32x2), ("3xbf16", bf16x3))}


def test_bf16_operand_splits_keep_float32_accuracy():
    """P keeps its float32 accuracy under both splits (2^-22 and 2^-24 per
    element at most); rounding P to bf16 alone is over 1e2 times further off."""
    errs = bf16_operand_split_errors()
    assert errs["2xtf32"] < 1e-6 and errs["3xbf16"] < 1e-6, errs
    rng = np.random.RandomState(0)
    s = rng.randn(256, 256)
    p = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
    one_bf16 = np.linalg.norm(_bf16(p).astype(np.float64) - p) / np.linalg.norm(p)
    assert one_bf16 > 1e2 * max(errs["2xtf32"], errs["3xbf16"]), (one_bf16, errs)


# ---------------------------------------------------------------------------
# the SPMD engine in bf16 against the reference's, and the dtype check
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
sys.path.insert(0, "src")
import jax, json
from repro.configs.base import ModelConfig, AttentionConfig, BlockSpec, OptimizerConfig
from repro.data import batches
from repro.engine import LoopConfig, SpmdEngine, run_loop
from repro.engine.loop import resume_if_present
from repro.launch.mesh import make_mesh_compat
from repro.models import init_model

cfg = ModelConfig(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
                  attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                  pattern=(BlockSpec("attn","dense"),), scan_layers=False)
root, steps, cut, K, M, mb, S = sys.argv[1], *map(int, sys.argv[2:8])
ocfg = OptimizerConfig(total_steps=steps, **json.loads(sys.argv[8]))
params = init_model(jax.random.PRNGKey(0), cfg)
mesh = make_mesh_compat((K, 1), ("stage", "data"))
engines = {s: SpmdEngine(cfg, ocfg, num_stages=K, num_microbatches=M, mesh=mesh, schedule=s,
                         precision="bf16") for s in ("fill_drain", "1f1b")}

def run(eng, n, ckpt_dir=None, resume=None):
    data = batches(cfg, M * mb, S, seed=0)
    state, start = resume_if_present(eng, eng.init_state(params=params), resume, data)
    return run_loop(eng, data, LoopConfig(steps=n, ckpt_dir=ckpt_dir), state=state,
                    start_step=start)[1]

out = {s: run(e, steps) for s, e in engines.items()}
out["precision"] = {s: e.precision for s, e in engines.items()}
run(engines["1f1b"], cut, ckpt_dir=os.path.join(root, "ref"))
out["ref_continues_ref"] = run(engines["1f1b"], steps, resume=os.path.join(root, "ref"))
print("ready", flush=True)
sys.stdin.readline()  # the port has written its checkpoint
out["ref_continues_port"] = run(engines["1f1b"], steps, resume=os.path.join(root, "port"))
print(json.dumps(out))
"""


def _port_engine(schedule):
    return SpmdEngine(TCFG, OptimizerConfig(total_steps=STEPS, **ADAM), num_stages=K,
                      num_microbatches=M, schedule=schedule, device="cpu", precision="bf16")


def _port_run(engine, pair, n, ckpt_dir=None, resume=None):
    data = batches(TCFG, M * MB, S, seed=0, device="cpu")
    state, start = resume_if_present(engine, engine.init_state(pair), resume, data)
    return run_loop(engine, data, LoopConfig(steps=n, ckpt_dir=ckpt_dir), state=state,
                    start_step=start)[1]


def _close(got, want):
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(got) == len(want) and diffs[0] < FIRST_TOL and max(diffs) < ALL_TOL, (got, want)


def _meta(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_bf16_spmd_engine_and_checkpoints_track_the_reference(tmp_path, ref_params):
    """Both schedules in bf16 (dense attention, 2 stages, 2 microbatches, 4
    Adam steps) against the reference's ``SpmdEngine(precision="bf16")``
    from the same weights on the same stream; then a bf16 1F1B checkpoint
    at step 2 from each package, continued by the other. Both manifests say
    ``"precision": "bf16_compute"`` and are equal; masters and optimizer
    state stay float32."""
    root = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    args = [root, STEPS, CUT, K, M, MB, S, json.dumps(ADAM)]
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, *map(str, args)],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                                text=True, cwd=ROOT, env=env)
        try:
            pair = _stacked_pair(ref_params)
            engines = {s: _port_engine(s) for s in ("fill_drain", "1f1b")}
            got = {s: _port_run(e, pair, STEPS) for s, e in engines.items()}
            one = engines["1f1b"]
            _port_run(one, pair, CUT, ckpt_dir=os.path.join(root, "port"))
            port_from_port = _port_run(one, pair, STEPS, resume=os.path.join(root, "port"))
            state = one.load_state(load_checkpoint(os.path.join(root, "port"))[0])
            assert proc.stdout.readline().strip() == "ready"
            port_from_ref = _port_run(one, pair, STEPS, resume=os.path.join(root, "ref"))
            proc.stdin.write("go\n")
            proc.stdin.flush()
            stdout, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        err.seek(0)
        assert proc.returncode == 0, err.read()[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for schedule, engine in engines.items():
        assert engine.precision == want["precision"][schedule] == "bf16_compute"
        assert engine.cfg.dtype == "bfloat16" and engine.cfg.param_dtype == "float32"
        _close(got[schedule], want[schedule])
    ref_m, port_m = _meta(os.path.join(root, "ref")), _meta(os.path.join(root, "port"))
    assert port_m["meta"]["precision"] == ref_m["meta"]["precision"] == "bf16_compute"
    assert port_m == ref_m
    assert all(x.dtype == torch.float32 for x in state_leaves((state.params, state.opt_state))
               .values() if x.is_floating_point())
    _close(port_from_ref, want["ref_continues_ref"])
    _close(port_from_port, want["ref_continues_port"])
    assert len(port_from_ref) == STEPS - CUT


def _dtype_check(ref_params, schedule, *, unapplied=False, bf16_masters=False):
    """One engine step under ``record_float_dtypes``, then the policy check
    on what the step computed and on the state it read and wrote."""
    engine = SpmdEngine(TCFG, OptimizerConfig(total_steps=STEPS, **ADAM), num_stages=K,
                        num_microbatches=M, schedule=schedule, use_kernels=True,
                        device="cpu", precision=None if unapplied else "bf16")
    state = engine.init_state(_stacked_pair(ref_params))
    if bf16_masters:
        state.params = tuple(cast_params(p, torch.bfloat16) for p in state.params)
    batch = next(batches(TCFG, M * MB, S, seed=0, device="cpu"))
    (state, loss, _), seen = record_float_dtypes(engine.step, state, batch, 0)
    assert np.isfinite(float(loss))
    return check_dtype_policy(seen, state_leaves((state.params, state.opt_state)),
                              BF16_COMPUTE_POLICY)


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b"])
def test_dtype_check_passes_the_bf16_step(ref_params, schedule):
    """The healthy bf16 step, through the flash kernels' plain versions:
    bfloat16 and float32 intermediates only, bfloat16 present, masters and
    optimizer state float32."""
    res = _dtype_check(ref_params, schedule)
    assert res.passed, res.to_json()
    assert set(res.data["float_dtypes"]) == {"float32", "bfloat16"}


def test_dtype_check_flags_both_mutations(ref_params):
    """tests/test_precision.py's mutations on the port: the policy never
    applied (no bfloat16 anywhere: vacuous) and bfloat16 masters (the state
    dtype clause)."""
    res = _dtype_check(ref_params, "fill_drain", unapplied=True)
    assert not res.passed and "appears nowhere" in res.detail, res.to_json()
    res = _dtype_check(ref_params, "fill_drain", bf16_masters=True)
    assert not res.passed and "state dtype" in res.detail, res.to_json()
