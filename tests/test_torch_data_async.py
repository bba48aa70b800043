"""The asynchronous data axis of the port against the JAX reference: the
stage contexts and FIFOs that carry the data delay, the sim backend's
deeper FIFO, the SPMD engine's data replicas and deferred-reduction FIFO
(against the reference's ``SpmdEngine`` on four forced host devices, in one
subprocess shared by the engine tests), the sharded data iterators, the
topology and the launcher's flags and metadata."""
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

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.catalog import get_config as jget_config
from repro.data import synthetic as jdata
from repro.engine import LoopConfig as JLoopConfig
from repro.engine import SimEngine as JSimEngine
from repro.engine import run_loop as jrun_loop
from repro.engine.spmd import stack_stage_params as jstack
from repro.launch import topology as jtopology
from repro.launch import train as jtrain
from repro.models.model import init_model as jinit_model
from repro.optim.base import Optimizer as JOptimizer
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro.pipeline import delay as jdelay
from repro.pipeline.partition import stage_context_for_stacked as jctx_stacked
from repro.pipeline.partition import stage_context_for_tree as jctx_tree
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.convert import (
    params_from_numpy,
    stacked_from_numpy,
    stacked_to_numpy,
    stage_shard_axes,
)
from repro_torch.configs import OptimizerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.data import synthetic as tdata
from repro_torch.engine import LoopConfig, SimEngine, SpmdEngine, run_loop
from repro_torch.engine.spmd import stack_stage_params
from repro_torch.launch import topology as ttopology
from repro_torch.launch import train
from repro_torch.models import Transformer, param_leaves
from repro_torch.optim.base import Optimizer
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline import delay as tdelay
from repro_torch.pipeline.partition import stage_context_for_stacked, stage_context_for_tree

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's own data-async model (tests/test_data_async.py:49)
_SHAPE = dict(num_layers=2, d_model=16, d_ff=24, vocab_size=96, max_seq_len=32,
              scan_layers=False)
JTINY = JModelConfig(attention=JAttentionConfig(num_heads=2, num_kv_heads=2, head_dim=8), **_SHAPE)
TTINY = ModelConfig(attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=8), **_SHAPE)
# the reference's engine run (tests/test_data_async.py:278-279): 2 stages, 2
# microbatches of 2 rows, one row per data replica
K, M, B, S, STEPS, D, CUT = 2, 2, 4, 8, 5, 2, 2
ADAM = {"name": "adam", "total_steps": 20}
# the reference's tolerances between its async engine and a hand-rolled FIFO
# (tests/test_data_async.py:331-338)
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel workers share the cores; exact comparisons need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # numpy's BLAS pool too: its idle threads spin on the cores the others need
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# optimizer layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["tree", "stacked"])
def test_stage_contexts_with_a_data_delay_match_the_reference(layout):
    """D = 2 on 4 stages of 8 layers: the delays and FIFO specs stay the
    pipeline's; delay scales and stage-aware refresh periods (both
    allocations) read tau + D, element for element as the reference's."""
    stages, dd = 4, 2
    jcfg, tcfg = JTINY.replace(num_layers=8), TTINY.replace(num_layers=8)
    jparams = jax.eval_shape(lambda k: jinit_model(k, jcfg), jax.random.PRNGKey(0))
    tparams = param_leaves(Transformer(tcfg, "meta", seed=None))
    if layout == "tree":
        want = jctx_tree(jparams, jcfg, stages, data_delay=dd)
        got = stage_context_for_tree(tparams, tcfg, stages, data_delay=dd)
        jleaves, tleaves = jparams, tparams
    else:
        jleaves = jax.eval_shape(lambda p: jstack(p, jcfg, stages), jparams)
        st, sh = stack_stage_params(tparams, tcfg, stages)
        want = jctx_stacked(*jleaves, stages, data_delay=dd)
        got = stage_context_for_stacked(st, sh, stages, data_delay=dd)
        tleaves = {**{f"0/{k}": v for k, v in st.items()}, **{f"1/{k}": v for k, v in sh.items()}}
    assert got.data_delay == want.data_delay == dd
    assert got.delays == want.delays and tuple(got.repeats) == tuple(want.repeats)
    assert got.delay_specs() == want.delay_specs()
    for reversed_allocation in (False, True):
        assert got.refresh_freqs(10, reversed_allocation) == \
            want.refresh_freqs(10, reversed_allocation)
    flat = {k: torch.zeros(1).expand(v.shape) for k, v in tleaves.items()}
    jscales = jax.tree_util.tree_leaves(want.delay_scales(jleaves))
    scales = got.delay_scales(flat)
    assert len(scales) == len(jscales)
    for a, b in zip(scales, jscales):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_optimizer_sim_data_delay_deepens_the_grad_fifo():
    """tests/test_data_async.py:173 on the port: every leaf's FIFO is D
    deeper; one stage still wraps when D > 0; D = 0 on one stage is the bare
    optimizer. Depths equal the reference's."""
    jparams = jinit_model(jax.random.PRNGKey(0), JTINY)
    tparams = param_leaves(Transformer(TTINY, "meta", seed=None))

    def depths(dd, stages):
        opt = build_optimizer(OptimizerConfig(**ADAM), tparams, TTINY, num_stages=stages,
                              data_delay=dd)
        jopt = jbuild_optimizer(JOptimizerConfig(**ADAM), jparams, JTINY, num_stages=stages,
                                data_delay=dd)
        got = [0 if q is None else int(q.shape[0]) for q in opt.init(tparams)["grad_q"]]
        want = [0 if q is None else int(q.shape[0]) for q in jopt.init(jparams)["grad_q"]]
        assert got == want, (dd, stages)
        return got

    base = [int(d) for d in stage_context_for_tree(tparams, TTINY, 2).delay_specs()]
    assert depths(0, 2) == base
    assert depths(2, 2) == [d + 2 for d in base]
    assert depths(2, 1) == [2] * len(base)
    bare = build_optimizer(OptimizerConfig(**ADAM), tparams, TTINY, num_stages=1)
    assert "grad_q" not in bare.init(tparams)


@pytest.mark.parametrize("E", [1, 2])
def test_stage_fifo_extra_param_delay_gives_the_reference_snapshots(E):
    """K = 3 over 6 steps, a stacked leaf and shared leaves of delays K-1 and
    0: the gradient each stage applies keeps pipeline depth, the weights it
    reads are w_{t-(tau+E)} (w_0 during warm-up), both equal to the
    reference's, and the rings unroll to the reference's queues."""
    K3, n = 3, 2
    seen, jseen = [], []

    def probe_update(g, s, p, t, aux=None, inplace=False):
        seen.append(({k: v.clone() for k, v in g.items()},
                     {k: v.clone() for k, v in aux["stale_params"].items()}))
        return {k: torch.zeros_like(v) for k, v in g.items()}, s

    def jprobe_update(g, s, p, t, aux=None):
        jseen.append((g, aux["stale_params"]))
        return jax.tree.map(jnp.zeros_like, g), s

    specs = ["stage", K3 - 1, 0]
    opt = tdelay.stage_delayed_optimizer(Optimizer(lambda p: {}, probe_update), specs, K3,
                                         store_params=True, extra_param_delay=E)
    jopt = jdelay.stage_delayed_optimizer(JOptimizer(lambda p: {}, jprobe_update), specs, K3,
                                          store_params=True, extra_param_delay=E)
    params = {"0/w": torch.zeros(K3, n), "1/embed": torch.zeros(n), "1/lm_head": torch.zeros(n)}

    def jp():
        return (jnp.asarray(params["0/w"].numpy()),
                {"embed": jnp.asarray(params["1/embed"].numpy()),
                 "lm_head": jnp.asarray(params["1/lm_head"].numpy())})

    for t in range(6):
        with torch.no_grad():
            for k in range(K3):
                params["0/w"][k].fill_(100.0 * t + k)
            params["1/embed"].fill_(100.0 * t - 1)
            params["1/lm_head"].fill_(100.0 * t - 2)
        if t == 0:
            state, jstate = opt.init(params), jopt.init(jp())
        g = {"0/w": torch.stack([torch.full((n,), 10.0 * t + k) for k in range(K3)]),
             "1/embed": torch.full((n,), 10.0 * t - 1), "1/lm_head": torch.full((n,), 10.0 * t - 2)}
        _, state = opt.update(g, state, params, t)
        _, jstate = jopt.update((jnp.asarray(g["0/w"].numpy()),
                                 {"embed": jnp.asarray(g["1/embed"].numpy()),
                                  "lm_head": jnp.asarray(g["1/lm_head"].numpy())}),
                                jstate, jp(), jnp.int32(t))
        grads, stale = seen[-1]
        (jg, jgsh), (jw, jwsh) = jseen[-1]
        for k in range(K3):
            tau = K3 - 1 - k
            want_g = 10.0 * (t - tau) + k if t >= tau else 0.0
            want_w = 100.0 * (t - tau - E) + k if t >= tau + E else float(k)
            assert torch.equal(grads["0/w"][k], torch.full((n,), want_g)), (t, k)
            assert torch.equal(stale["0/w"][k], torch.full((n,), want_w)), (t, k)
        np.testing.assert_array_equal(grads["0/w"].numpy(), np.asarray(jg))
        np.testing.assert_array_equal(stale["0/w"].numpy(), np.asarray(jw))
        for name in ("embed", "lm_head"):
            np.testing.assert_array_equal(grads["1/" + name].numpy(), np.asarray(jgsh[name]))
            np.testing.assert_array_equal(stale["1/" + name].numpy(), np.asarray(jwsh[name]))
        # the rings in logical order (row r is slot (head + r) % d) are the
        # reference's queues
        for qname in ("grad_q", "param_q"):
            for q, b in zip(state[qname], jstate[qname]):
                assert (q is None) == (b is None)
                if q is not None:
                    got = torch.roll(q, -(state["head"] % q.shape[0]), 0)
                    np.testing.assert_array_equal(got.numpy(), np.asarray(b))
    assert [q.shape[0] for q in state["param_q"]] == [K3 - 1 + E, K3 - 1 + E, E]


# ---------------------------------------------------------------------------
# sim engine
# ---------------------------------------------------------------------------


SIM_ARGS = ["--smoke", "--stages", "2", "--batch", "2", "--seq", "16", "--log-every", "0"]


def _meta(path):
    with open(path) as f:
        out = json.load(f)
    out.pop("losses")
    return out


def test_sim_data_delay_zero_is_bitwise_no_flag(tmp_path):
    """--data-async --data-delay 0 on the sim backend is the step without
    the flags, bit for bit; the metrics file carries the reference's keys
    with the reference's values (the port adds its own timings and
    ``device``), with and without a data delay."""
    port = SIM_ARGS + ["--steps", "3", "--use-kernels", "--device", "cpu"]
    plain = train.main(port)["losses"]
    assert train.main(port + ["--data-async", "--data-delay", "0"])["losses"] == plain
    for extra in ([], ["--data-async", "--data-delay", "2"]):
        args = SIM_ARGS + ["--steps", "1", "--optimizer", "adam"] + extra
        train.main(args + ["--device", "cpu", "--out", str(tmp_path / "p.json")])
        jtrain.main(args + ["--out", str(tmp_path / "r.json")])
        want, got = _meta(tmp_path / "r.json"), _meta(tmp_path / "p.json")
        assert {"topology", "data_async", "data_delay"} <= set(want)
        assert {k: got.get(k, "missing") for k in want} == want, extra


@pytest.mark.parametrize("geometry", [None, "unilateral"])
def test_sim_data_delay_two_tracks_the_reference(geometry):
    """The launcher's sim construction (build_optimizer with data_delay=2,
    the pipeline-only delays for the engine) on the paper_95m smoke config,
    2 stages, 12 steps, from shared weights on the same stream. Adam within
    1e-4; basis rotation unilateral (full-rank grams) within the reference's
    tolerance for two implementations (tests/test_engine.py:437-438)."""
    steps, B2, S2 = 12, 4, 32
    if geometry is None:
        ocfg = {"name": "adam", "learning_rate": 1e-3, "total_steps": steps}
    else:
        ocfg = {"name": "basis_rotation", "rotation_geometry": geometry, "total_steps": steps}
    cj = jget_config("paper_95m", smoke=True).replace(scan_layers=False)
    ct = tget_config("paper_95m", smoke=True).replace(scan_layers=False)
    params = jinit_model(jax.random.PRNGKey(0), cj)
    jopt = jbuild_optimizer(JOptimizerConfig(**ocfg), params, cj, num_stages=2, data_delay=2)
    _, want = jrun_loop(JSimEngine(cj, jopt, grad_clip=1.0), jdata.batches(cj, B2, S2, seed=0),
                        JLoopConfig(steps=steps), state=None)
    model = params_from_numpy(jax.tree.map(np.asarray, params), ct, "cpu")
    leaves = param_leaves(model)
    opt = build_optimizer(OptimizerConfig(**ocfg), leaves, ct, num_stages=2, data_delay=2,
                          use_kernels=True)
    _, got, _ = run_loop(SimEngine(model, opt), tdata.batches(ct, B2, S2, seed=0, device="cpu"),
                         LoopConfig(steps=steps))
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(diffs) == steps
    if geometry is None:
        assert max(diffs) < 1e-4, (got, want)
    else:
        assert max(diffs[:2]) < 2e-3 and max(diffs) < 5e-2, (got, want)


# ---------------------------------------------------------------------------
# SPMD engine against the reference's, one subprocess for every case
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import sys
sys.path.insert(0, "src")
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import AttentionConfig, ModelConfig, OptimizerConfig
from repro.engine.spmd import SpmdEngine
from repro.launch import train
from repro.launch.topology import Topology
from repro.models.model import init_model

out = sys.argv[1]
K, M, STEPS, D, CUT = (int(x) for x in sys.argv[2:7])
cfg = ModelConfig(num_layers=2, d_model=16, d_ff=24, vocab_size=96, max_seq_len=32,
                  scan_layers=False,
                  attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=8))
ocfg = OptimizerConfig(**json.loads(sys.argv[7]))
data = np.load(os.path.join(out, "batches.npz"))
bs = [{"tokens": jnp.asarray(data["tokens"][t]), "labels": jnp.asarray(data["labels"][t])}
      for t in range(STEPS)]
params = init_model(jax.random.PRNGKey(0), cfg)
losses, arrays = {}, {}

def run(name, engine, ckpt_at=0):
    st = engine.init_state(params=params)
    ls = []
    for t in range(STEPS):
        st, loss, _ = engine.step(st, bs[t], t)
        ls.append(float(loss))
        if t + 1 == ckpt_at:
            engine.save_checkpoint(os.path.join(out, name), st, step=t + 1)
    losses[name] = ls
    for i, x in enumerate(jax.tree.leaves(st.params)):
        arrays[f"{name}/{i}"] = np.asarray(x)

topo = Topology(stages=K, data=2)
for sched in ("fill_drain", "1f1b"):
    run(f"sync_{sched}", SpmdEngine(cfg, ocfg, K, M, schedule=sched, topology=topo,
                                    donate=False))
    run(f"async_{sched}", SpmdEngine(cfg, ocfg, K, M, schedule=sched, topology=topo,
                                     donate=False, data_async=True, data_delay=D),
        ckpt_at=CUT if sched == "1f1b" else 0)
run("pods_fill_drain", SpmdEngine(cfg, ocfg, K, M, schedule="fill_drain",
                                  topology=Topology(stages=K, data=1, pods=2), donate=False))
np.savez(os.path.join(out, "params.npz"), **arrays)
# the launcher's metrics metadata on the spmd backend
train.main(["--smoke", "--backend", "spmd", "--stages", "2", "--data-par", "2",
            "--data-async", "--steps", "1", "--batch", "4", "--seq", "8", "--log-every", "0",
            "--out", os.path.join(out, "meta.json")])
print(json.dumps(losses))
"""


class _Reference:
    """The reference's runs in a subprocess started once for the module;
    ``result()`` waits for them, so the port's runs overlap them."""

    def __init__(self, root: str):
        self.root = root
        rng = np.random.RandomState(7)
        toks = rng.randint(0, JTINY.vocab_size, size=(STEPS, B, S)).astype(np.int32)
        self.batches = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
        np.savez(os.path.join(root, "batches.npz"), **self.batches)
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        self.err = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE_SCRIPT, root, *map(str, (K, M, STEPS, D, CUT)),
             json.dumps(ADAM)],
            stdout=subprocess.PIPE, stderr=self.err, text=True, cwd=ROOT, env=env)
        self._result = None

    def result(self):
        if self._result is None:
            stdout, _ = self.proc.communicate(timeout=900)
            self.err.seek(0)
            assert self.proc.returncode == 0, self.err.read()[-4000:]
            params = np.load(os.path.join(self.root, "params.npz"))
            self._result = (json.loads(stdout.strip().splitlines()[-1]), params)
        return self._result

    def params(self, name):
        _, arrays = self.result()
        n = sum(1 for k in arrays.files if k.startswith(name + "/"))
        return [arrays[f"{name}/{i}"] for i in range(n)]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self.err.close()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Started with the module's first test, so that the tests before the
    engine's run beside it."""
    ref = _Reference(str(tmp_path_factory.mktemp("data_async_ref")))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def start_pair():
    jparams = jinit_model(jax.random.PRNGKey(0), JTINY)
    return stacked_from_numpy(jax.tree.map(np.asarray, jstack(jparams, JTINY, K)), "cpu")


def _engine(schedule="1f1b", topology=None, **kw):
    topology = topology or ttopology.Topology(stages=K, data=2)
    return SpmdEngine(TTINY, OptimizerConfig(**ADAM), K, M, schedule=schedule,
                      topology=topology, device="cpu", **kw)


def _batch(reference, t):
    return {k: torch.from_numpy(v[t]).long() for k, v in reference.batches.items()}


def _run(engine, reference, pair, t0=0, state=None, stop=STEPS):
    state = engine.init_state(pair) if state is None else state
    losses = []
    for t in range(t0, stop):
        state, loss, _ = engine.step(state, _batch(reference, t), t)
        losses.append(float(loss))
    return state, losses


def _leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(stacked_to_numpy(*state.params))]


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b"])
def test_spmd_data_axis_tracks_the_reference_engine(reference, start_pair, schedule):
    """Topology (stages 2, data 2): the synchronous data axis and the
    deferred reduction (D = 2) against the reference's engine within its own
    tolerances; data_delay=0 under data_async is the port's synchronous
    step, bit for bit."""
    sync_state, sync = _run(_engine(schedule), reference, start_pair)
    d0_state, d0 = _run(_engine(schedule, data_async=True, data_delay=0), reference, start_pair)
    async_state, got = _run(_engine(schedule, data_async=True, data_delay=D), reference,
                            start_pair)
    assert d0 == sync and d0_state.data_fifo is None
    for a, b in zip(_leaves(d0_state), _leaves(sync_state)):
        np.testing.assert_array_equal(a, b)
    losses, _ = reference.result()
    for name, ls, state in ((f"sync_{schedule}", sync, sync_state),
                            (f"async_{schedule}", got, async_state)):
        np.testing.assert_allclose(ls, losses[name], **LOSS_TOL, err_msg=name)
        want = reference.params(name)
        assert len(want) == len(_leaves(state))
        for a, b in zip(_leaves(state), want):
            np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=name)
    # the deferred reduction moved the curve; the first D steps applied zeros
    assert got != sync and len(async_state.data_fifo) == D


def test_spmd_pods_topology_tracks_the_reference_engine(reference, start_pair):
    """(pods 2, stages 2, data 1), synchronous: two replicas, pod-major, on
    the host-assembled stream's rows, within the reference's tolerances."""
    topo = ttopology.Topology(stages=K, data=1, pods=2)
    state, got = _run(_engine("fill_drain", topo), reference, start_pair)
    losses, _ = reference.result()
    np.testing.assert_allclose(got, losses["pods_fill_drain"], **LOSS_TOL)
    for a, b in zip(_leaves(state), reference.params("pods_fill_drain")):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_spmd_async_resume_is_bitwise_with_its_fifo(tmp_path, reference, start_pair):
    """A mid-run sharded checkpoint of the 1F1B async engine (D = 2, cut at
    step 2) resumes bitwise, FIFO included; the donated step equals the
    copying one bitwise; the manifest's spec and shard axes are the
    reference's, whose checkpoint the port continues within the reference's
    tolerances."""
    engine = _engine(data_async=True, data_delay=D)
    full_state, full = _run(engine, reference, start_pair)
    cut_state, first = _run(engine, reference, start_pair, stop=CUT)
    path = str(tmp_path / "port")
    engine.save_checkpoint(path, cut_state, step=CUT)
    tree, step, meta = ckpt.load_checkpoint(path)
    assert step == CUT and meta["topology"] == "2x2" and len(tree) == 3
    resumed_state = engine.load_state(tree)
    for (gs, gsh), (hs, hsh) in zip(resumed_state.data_fifo, cut_state.data_fifo):
        for k in gs:
            assert torch.equal(gs[k], hs[k]), k
        for k in gsh:
            assert torch.equal(gsh[k], hsh[k]), k
    resumed_state, rest = _run(engine, reference, start_pair, t0=CUT, state=resumed_state)
    assert first + rest == full
    for a, b in zip(_leaves(resumed_state), _leaves(full_state)):
        np.testing.assert_array_equal(a, b)
    donated_state, donated = _run(_engine(data_async=True, data_delay=D, donate=True),
                                  reference, start_pair)
    assert donated == full
    for a, b in zip(_leaves(donated_state), _leaves(full_state)):
        np.testing.assert_array_equal(a, b)
    # the FIFO's stacked gradients shard on axis 0, its shared ones go whole
    axes = stage_shard_axes(*cut_state.params, cut_state.opt_state,
                            data_fifo=cut_state.data_fifo)
    n_params = len(cut_state.params[0]) + len(cut_state.params[1])
    assert axes[-D * n_params:] == ([0] * len(cut_state.params[0])
                                    + [None] * len(cut_state.params[1])) * D
    losses, _ = reference.result()
    ref_path = os.path.join(reference.root, "async_1f1b")
    with open(os.path.join(path, "manifest.json")) as f:
        mine = json.load(f)
    with open(os.path.join(ref_path, "manifest.json")) as f:
        theirs = json.load(f)
    for key in ("format", "spec", "num_leaves", "num_shards", "shard_axes", "step"):
        assert mine[key] == theirs[key], key
    ref_tree, ref_step, ref_meta = ckpt.load_checkpoint(ref_path)
    assert ref_step == CUT and ref_meta["topology"] == "2x2"
    _, continued = _run(engine, reference, start_pair, t0=CUT,
                        state=engine.load_state(ref_tree))
    np.testing.assert_allclose(continued, losses["async_1f1b"][CUT:], **LOSS_TOL)


def test_spmd_fifo_of_the_wrong_depth_raises_and_a_sync_checkpoint_warm_starts(start_pair):
    """The reference's load rules: a FIFO of another depth than data_delay
    raises; a synchronous 2-tuple warm-starts with a zero FIFO."""
    engine = _engine(data_async=True, data_delay=D)
    tree = engine.checkpoint_tree(engine.init_state(start_pair))
    assert len(tree) == 3 and len(tree[2]) == D
    deeper = _engine(data_async=True, data_delay=D + 1)
    with pytest.raises(ValueError, match="FIFO depth"):
        deeper.load_state(tree)
    warm = deeper.load_state(tree[:2])
    assert len(warm.data_fifo) == D + 1
    assert all(float(g.abs().sum()) == 0 for gs, gsh in warm.data_fifo
               for g in (*gs.values(), *gsh.values()))
    # a synchronous engine's checkpoint is the reference's 2-tuple
    assert len(_engine().checkpoint_tree(_engine().init_state(start_pair))) == 2


def test_spmd_launcher_meta_matches_the_reference(tmp_path, reference):
    """The spmd launcher with --data-par 2 --data-async: the reference's
    metrics metadata keys and values (topology 2x2, data_delay 1)."""
    out = str(tmp_path / "meta.json")
    res = train.main(["--smoke", "--backend", "spmd", "--stages", "2", "--data-par", "2",
                      "--data-async", "--steps", "1", "--batch", "4", "--seq", "8",
                      "--log-every", "0", "--out", out, "--device", "cpu"])
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
    reference.result()
    want, got = _meta(os.path.join(reference.root, "meta.json")), _meta(out)
    assert {"topology", "data_async", "data_delay"} <= set(want)
    assert {k: got.get(k, "missing") for k in want} == want
    assert got["topology"] == "2x2" and got["data_delay"] == 1


# ---------------------------------------------------------------------------
# data, topology, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hosts", [2, 4])
def test_sharded_batches_match_the_reference_and_partition_batches(hosts):
    """Each host's shard equals the reference's, and the shards
    concatenated equal batches() bit for bit."""
    Bh, Sh, vocab = 8, 16, 96
    cfg_j = JTINY.replace(vocab_size=vocab)
    cfg_t = TTINY.replace(vocab_size=vocab)
    whole = tdata.batches(cfg_t, Bh, Sh, seed=3, device="cpu")
    shards = [tdata.sharded_batches(cfg_t, Bh, Sh, hosts, h, seed=3, device="cpu")
              for h in range(hosts)]
    jshards = [jdata.sharded_batches(cfg_j, Bh, Sh, hosts, h, seed=3) for h in range(hosts)]
    for _ in range(2):
        want = next(whole)
        got = [next(it) for it in shards]
        for g, j in zip(got, (next(it) for it in jshards)):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(j[k]))
        for k in ("tokens", "labels"):
            assert torch.equal(torch.cat([g[k] for g in got]), want[k])
    with pytest.raises(ValueError, match="divide"):
        next(tdata.sharded_batches(cfg_t, 6, Sh, 4, 0, device="cpu"))


@pytest.mark.parametrize("shape", [(2, 2, 1), (4, 1, 1), (2, 1, 2), (2, 2, 2), (8, 0, 1)])
def test_topology_matches_the_reference(shape):
    """The launcher's topology for --stages/--data-par/--pods (one card
    holds every position, so --data-par 0 is one replica a pod) against
    the reference's from_device_count on that many devices: axes, shape,
    data shards and the description. Replica r's rows are the r-th block
    of each microbatch, pod-major."""
    stages, data, pods = shape
    t = ttopology.Topology(stages=stages, data=max(data, 1), pods=pods)
    j = jtopology.Topology.from_device_count(stages, pods=pods, data=data,
                                             device_count=pods * stages * max(data, 1))
    for attr in ("stages", "data", "pods", "shape", "data_shards"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.describe() == j.describe()
    mb = 2 * t.data_shards
    rows = [t.replica_rows(r, mb) for r in range(t.data_shards)]
    assert rows == [(2 * r, 2 * r + 2) for r in range(t.data_shards)]
    with pytest.raises(ValueError):
        t.replica_rows(0, mb + 1) if t.data_shards > 1 else t.replica_rows(1, mb)
    with pytest.raises(ValueError, match=">= 1"):
        ttopology.Topology(stages=stages, data=0, pods=pods)


@pytest.mark.parametrize("backend", ["sim", "spmd"])
@pytest.mark.parametrize("argv", [["--data-delay", "1"],
                                  ["--data-async", "--data-delay", "-1"],
                                  ["--data-async", "--sync"]])
def test_train_data_async_flag_validation_matches_the_reference(backend, argv):
    """tests/test_data_async.py:250-262 on both backends: the port exits
    with the reference's message, before any work."""
    argv = argv + ["--smoke", "--steps", "1", "--backend", backend]
    with pytest.raises(SystemExit) as want:
        jtrain.main(argv)
    with pytest.raises(SystemExit) as got:
        train.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and str(got.value)
