"""Checkpoint and resume: the port's checkpoints against the JAX reference's
(one on-disk format: either package loads and continues the other's, for
the sim and the stage-sharded SPMD layouts), bitwise resume of the port's
own runs, and the save discipline (async writes, writer failures,
interrupted saves, same-step re-saves)."""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.data import batches as jbatches
from repro.engine import LoopConfig as JLoopConfig
from repro.engine import SimEngine as JSimEngine
from repro.engine import run_loop as jrun_loop
from repro.engine.loop import resume_if_present as jresume_if_present
from repro.engine.spmd import stack_stage_params as jstack
from repro.models.model import init_model as jinit_model
from repro.optim.factory import build_optimizer as jbuild_optimizer
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.convert import params_from_numpy, stacked_from_numpy
from repro_torch.configs import OptimizerConfig
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.data import batches
from repro_torch.engine import LoopConfig, SimEngine, SpmdEngine, resume_if_present, run_loop
from repro_torch.models import param_leaves
from repro_torch.optim.factory import build_optimizer

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's own engine-test model (tests/test_engine.py:32)
_SHAPE = dict(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
              scan_layers=False)
JCFG = JModelConfig(attention=JAttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                    pattern=(JBlockSpec("attn", "dense"),), **_SHAPE)
TCFG = ModelConfig(attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                   pattern=(BlockSpec("attn", "dense"),), **_SHAPE)
STEPS, B, S = 6, 4, 16
ADAM = {"name": "adam", "learning_rate": 1e-3}
ROTATION = {"name": "basis_rotation", "learning_rate": 1e-3, "rotation_freq": 2}
# losses of two implementations of one step (tests/test_engine.py:437-438):
# Adam differs by float32 roundoff, basis rotation by the QR refreshes
TOLS = {"adam": (1e-4, 1e-4), "basis_rotation": (2e-3, 5e-2)}


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


@pytest.fixture(scope="module")
def ref_params():
    return jinit_model(jax.random.PRNGKey(0), JCFG)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _leaves(path):
    return jax.tree_util.tree_leaves(ckpt.load_checkpoint(path)[0])


def _assert_close_curves(got, want, optimizer):
    first2, every = TOLS[optimizer]
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(got) == len(want) and max(diffs[:2]) < first2 and max(diffs) < every, (got, want)


class Pair:
    """The reference's sim engine and the port's from the same weights and
    optimizer config, each reused across runs (one compile for the
    reference's)."""

    def __init__(self, ref_params, ocfg, stages):
        self.ref_params = ref_params
        self.jeng = JSimEngine(JCFG, jbuild_optimizer(JOptimizerConfig(total_steps=STEPS, **ocfg),
                                                      ref_params, JCFG, num_stages=stages))
        self.model = params_from_numpy(_np_tree(ref_params), TCFG, "cpu")
        self.teng = SimEngine(self.model, build_optimizer(
            OptimizerConfig(total_steps=STEPS, **ocfg), param_leaves(self.model), TCFG,
            num_stages=stages, use_kernels=True))

    def ref_run(self, steps, ckpt_dir=None, resume=None):
        """Reference losses of steps [start, steps), from its initial weights
        or resumed from ``resume``; checkpoints at ``steps`` into ``ckpt_dir``."""
        data = jbatches(JCFG, B, S, seed=0)
        state, start = jresume_if_present(self.jeng, self.jeng.init_state(params=self.ref_params),
                                          resume, data)
        _, losses = jrun_loop(self.jeng, data, JLoopConfig(steps=steps, ckpt_dir=ckpt_dir),
                              state=state, start_step=start)
        return losses

    def port_run(self, steps, ckpt_dir=None, resume=None):
        with torch.no_grad():
            for p, w in zip(param_leaves(self.model).values(),
                            jax.tree_util.tree_leaves(self.ref_params)):
                p.copy_(torch.from_numpy(np.array(w)))
        data = batches(TCFG, B, S, seed=0, device="cpu")
        state, start = resume_if_present(self.teng, None, resume, data)
        _, losses, _ = run_loop(self.teng, data, LoopConfig(steps=steps, ckpt_dir=ckpt_dir),
                                state=state, start_step=start)
        return losses


def test_sim_checkpoint_round_trips_bitwise_through_both_packages(tmp_path, ref_params):
    """The reference trains 3 steps (2 stages, basis rotation) and saves;
    the port loads that file into its engine and saves it from there; the
    reference loads the port's file: the same manifest, byte for byte, and
    every leaf bitwise the original, with its dtype."""
    pair = Pair(ref_params, ROTATION, stages=2)
    data = jbatches(JCFG, B, S, seed=0)
    state, _ = jrun_loop(pair.jeng, data, JLoopConfig(steps=3),
                         state=pair.jeng.init_state(params=ref_params))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jsave_checkpoint(ref_dir, pair.jeng.checkpoint_tree(state), step=3, meta={"note": "ref"})

    tree, step, meta = ckpt.load_checkpoint(ref_dir)
    pair.teng.save_checkpoint(port_dir, pair.teng.load_state(tree), step=step, meta=meta)

    with open(os.path.join(ref_dir, "manifest.json")) as f, \
            open(os.path.join(port_dir, "manifest.json")) as g:
        assert f.read() == g.read()
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir)) == \
        ["arrays-00000003.npz", "manifest.json"]
    (a, b) = (jload_checkpoint(d) for d in (ref_dir, port_dir))
    assert a[1:] == b[1:] == (3, {"note": "ref"})
    assert jax.tree.structure(a[0]) == jax.tree.structure(b[0])
    for x, y in zip(jax.tree_util.tree_leaves(a[0]), jax.tree_util.tree_leaves(b[0])):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_mid_warmup_checkpoint_unrolls_the_ring_into_the_reference_layout(tmp_path, ref_params):
    """4 stages (delays 3..0) after 2 steps: the port's rings have head 2,
    so its depth-3 queues start mid-ring. Its checkpoint has the reference's
    spec, leaf count and leaf order, each leaf within float32 roundoff of
    the reference's own checkpoint after the same steps (Adam: no QR), the
    queues' rows oldest first; and the reference, loading and re-saving
    it, hands the port back every leaf bitwise."""
    pair = Pair(ref_params, ADAM, stages=4)
    ref_dir, port_dir, back_dir = (str(tmp_path / n) for n in ("ref", "port", "back"))
    pair.ref_run(2, ckpt_dir=ref_dir)
    pair.port_run(2, ckpt_dir=port_dir)

    want, got = _manifest(ref_dir), _manifest(port_dir)
    assert got == want
    queues = got["spec"]["children"][1]["children"]["grad_q"]["children"]
    assert {q["__kind__"] for q in queues} == {"leaf", "none"}
    for x, y in zip(_leaves(port_dir), _leaves(ref_dir)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert np.linalg.norm(x - y) <= 1e-5 * max(np.linalg.norm(y), 1e-6)

    tree, step, meta = jload_checkpoint(port_dir)
    pair.jeng.save_checkpoint(back_dir, pair.jeng.load_state(tree), step=step, meta=meta)
    for x, y in zip(_leaves(back_dir), _leaves(port_dir)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ocfg", [ADAM, ROTATION], ids=["adam", "basis_rotation"])
def test_each_package_continues_the_others_sim_checkpoint(tmp_path, ref_params, ocfg):
    """4 stages, checkpoints at step 3 of 6 (rotation refreshes at 0, 2, 4):
    from the reference's checkpoint and from the port's, both packages
    continue through steps 3-5 on the fast-forwarded stream, within the
    tolerances for two implementations of the step."""
    pair = Pair(ref_params, ocfg, stages=4)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    pair.ref_run(3, ckpt_dir=ref_dir)
    pair.port_run(3, ckpt_dir=port_dir)
    for d in (ref_dir, port_dir):
        _assert_close_curves(pair.port_run(STEPS, resume=d), pair.ref_run(STEPS, resume=d),
                             ocfg["name"])


def _port_spmd_engine(ocfg):
    return SpmdEngine(TCFG, OptimizerConfig(total_steps=STEPS, **ocfg), num_stages=4,
                      num_microbatches=4, schedule="1f1b", use_kernels=True, device="cpu")


def _sim_engine(ocfg, stages=4):
    model = params_from_numpy(_np_tree(jinit_model(jax.random.PRNGKey(0), JCFG)), TCFG, "cpu")
    opt = build_optimizer(OptimizerConfig(total_steps=STEPS, **ocfg), param_leaves(model),
                          TCFG, num_stages=stages, use_kernels=True)
    return SimEngine(model, opt)


@pytest.mark.parametrize("backend", ["sim", "spmd_1f1b"])
def test_interrupted_run_resumes_bitwise_with_merged_metrics(tmp_path, backend):
    """tests/test_engine.py:201 on the port: interrupt at step 3 of 6,
    resume (which fast-forwards the stream), and the losses equal the
    uninterrupted run's exactly; the metrics file holds the whole series."""
    ckpt_dir, out = str(tmp_path / "ckpt"), str(tmp_path / "m.json")

    def make():
        return _port_spmd_engine(ROTATION) if backend == "spmd_1f1b" else _sim_engine(ROTATION)

    def data():
        return batches(TCFG, 8, S, seed=0, device="cpu")

    _, first, _ = run_loop(make(), data(), LoopConfig(steps=3, ckpt_dir=ckpt_dir, ckpt_every=3,
                                                      out_path=out, out_meta={"arch": "t"}))
    assert json.loads(open(out).read())["steps_done"] == 3
    engine, stream = make(), data()
    state, start = resume_if_present(engine, None, ckpt_dir, stream)
    assert start == 3
    _, rest, timings = run_loop(engine, stream, LoopConfig(steps=STEPS, out_path=out,
                                                           out_meta={"arch": "t"}),
                                state=state, start_step=start)
    assert len(rest) == len(timings.step_s) == 3
    m = json.loads(open(out).read())
    assert m["steps_done"] == STEPS and m["start_step"] == 0 and m["arch"] == "t"
    assert m["losses"] == first + rest
    _, full, _ = run_loop(make(), data(), LoopConfig(steps=STEPS))
    assert first + rest == full  # exact, not approximate


def test_async_writes_equal_inline_writes_and_never_alias_live_tensors(tmp_path, monkeypatch):
    """tests/test_engine.py:245 on the port, made strict: the background
    writer is held back until the loop has taken every step, so each
    checkpoint it then writes must hold its own step's values. A snapshot
    that aliased the parameters or rings the steps update in place would
    write the last step's values under every step."""
    real_save = ckpt.save_checkpoint
    gate = threading.Event()
    saved = {}

    def held_save(path, tree, step=0, meta=None):
        assert gate.wait(timeout=120)
        saved[mode][step] = [np.array(x) for x in ckpt.tree_leaves(tree)]
        real_save(path, tree, step=step, meta=meta)

    monkeypatch.setattr(ckpt, "save_checkpoint", held_save)
    outs = {}
    for mode in (True, False):
        saved[mode] = {}
        engine = _sim_engine(ADAM)
        job = engine.checkpoint_job

        def opening_job(path, state, step=0, meta=None, job=job):
            if step == 5:  # the final checkpoint: every step has run
                gate.set()
            return job(path, state, step=step, meta=meta)

        engine.checkpoint_job = opening_job
        if mode:
            gate.clear()
        else:
            gate.set()
        ckpt_dir, out = str(tmp_path / f"ckpt_{mode}"), str(tmp_path / f"m_{mode}.json")
        _, losses, timings = run_loop(
            engine, batches(TCFG, B, S, seed=0, device="cpu"),
            LoopConfig(steps=5, log_every=2, ckpt_dir=ckpt_dir, ckpt_every=2, out_path=out,
                       async_io=mode))
        assert len(timings.ckpt_s) == len(timings.write_s) == 3
        m = json.loads(open(out).read())
        outs[mode] = (losses, m["losses"], m["steps_done"], _leaves(ckpt_dir))
    assert outs[True][:3] == outs[False][:3]
    for x, y in zip(outs[True][3], outs[False][3]):
        np.testing.assert_array_equal(x, y)
    assert sorted(saved[True]) == sorted(saved[False]) == [2, 4, 5]
    for step in (2, 4, 5):
        for x, y in zip(saved[True][step], saved[False][step]):
            np.testing.assert_array_equal(x, y)
    # the snapshots differ from step to step: the parameters did move
    assert not np.array_equal(saved[True][2][0], saved[True][5][0])


def test_async_writer_failure_raises_on_loop_thread(tmp_path):
    """tests/test_engine.py:277 on the port: a failed background write fails
    the run."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file where a directory must go")
    with pytest.raises(OSError):
        run_loop(_sim_engine(ADAM, stages=1), batches(TCFG, B, S, seed=0, device="cpu"),
                 LoopConfig(steps=3, log_every=1, out_path=str(blocker / "m.json")))


def test_a_checkpoint_of_another_model_is_refused(tmp_path):
    """Restoring copies into the live tensors after checking the tree: a
    checkpoint of a 4-layer model does not load into a 2-layer engine."""
    ckpt_dir = str(tmp_path / "ckpt")
    run_loop(_sim_engine(ADAM), batches(TCFG, B, S, seed=0, device="cpu"),
             LoopConfig(steps=1, ckpt_dir=ckpt_dir))
    small = params_from_numpy(_np_tree(jinit_model(jax.random.PRNGKey(0),
                                                   JCFG.replace(num_layers=2))),
                              TCFG.replace(num_layers=2), "cpu")
    engine = SimEngine(small, build_optimizer(OptimizerConfig(**ADAM), param_leaves(small),
                                              TCFG.replace(num_layers=2), num_stages=4))
    with pytest.raises(ValueError, match="parameter trees differ"):
        resume_if_present(engine, None, ckpt_dir)


def _boom_savez(n_ok, partial):
    """np.savez that fails on its (n_ok + 1)-th call, leaving garbage bytes."""
    real = np.savez
    calls = {"n": 0}

    def savez(file, **kw):
        calls["n"] += 1
        if calls["n"] > n_ok:
            if partial:
                with open(file, "wb") as f:
                    f.write(b"\x00partial-garbage")
            raise RuntimeError("simulated crash during array write")
        return real(file, **kw)

    return savez


def test_interrupted_gathered_save_keeps_previous(tmp_path, monkeypatch):
    """tests/test_infra.py:261 on the port: a crash while writing the
    arrays, or while serialising the manifest, leaves the previous
    checkpoint loadable."""
    path = str(tmp_path / "ckpt")
    tree1 = {"w": np.arange(4.0, dtype=np.float32), "b": np.ones((2, 2), np.float32)}
    ckpt.save_checkpoint(path, tree1, step=1, meta={"note": "good"})
    monkeypatch.setattr(np, "savez", _boom_savez(0, partial=True))
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_checkpoint(path, {"w": tree1["w"] + 9, "b": tree1["b"] * 0}, step=2)
    monkeypatch.undo()
    tree, step, meta = ckpt.load_checkpoint(path)
    assert step == 1 and meta["note"] == "good"
    np.testing.assert_array_equal(tree["w"], np.arange(4.0))

    def dump_boom(obj, f, **kw):
        f.write('{"spec": "trunc')
        raise RuntimeError("simulated crash during manifest write")

    monkeypatch.setattr(json, "dump", dump_boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_checkpoint(path, tree1, step=3)
    monkeypatch.undo()
    tree, step, _ = ckpt.load_checkpoint(path)
    assert step == 1
    np.testing.assert_array_equal(tree["b"], np.ones((2, 2)))


def test_interrupted_sharded_save_keeps_previous(tmp_path, monkeypatch):
    """tests/test_infra.py:427 on the port: a crash while writing any shard
    file, or before the manifest lands, leaves the previous sharded
    checkpoint loadable; the next good save collects the strays."""
    path = str(tmp_path / "ckpt")
    tree1 = {"w": np.arange(8.0, dtype=np.float32).reshape(4, 2), "b": np.ones(3, np.float32)}
    axes = [None, 0]  # leaf order: b, w
    ckpt.save_sharded_checkpoint(path, tree1, 4, axes, step=1, meta={"note": "good"})
    monkeypatch.setattr(np, "savez", _boom_savez(2, partial=True))
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_sharded_checkpoint(path, {"w": np.zeros((4, 2)), "b": np.zeros(3)}, 4, axes,
                                     step=2)
    monkeypatch.undo()
    tree, step, meta = ckpt.load_checkpoint(path)
    assert step == 1 and meta["note"] == "good"
    np.testing.assert_array_equal(tree["w"], np.arange(8.0).reshape(4, 2))

    real_replace = os.replace

    def replace_boom(src, dst):
        if dst.endswith("manifest.json"):
            raise RuntimeError("simulated crash before manifest commit")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", replace_boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_sharded_checkpoint(path, {"w": np.zeros((4, 2)), "b": np.zeros(3)}, 4, axes,
                                     step=2)
    monkeypatch.undo()
    tree, step, _ = ckpt.load_checkpoint(path)
    assert step == 1
    np.testing.assert_array_equal(tree["b"], np.ones(3))

    ckpt.save_sharded_checkpoint(path, {"w": np.zeros((4, 2)), "b": np.zeros(3)}, 4, axes,
                                 step=3)
    assert sorted(os.listdir(path)) == [
        f"arrays-00000003-shard{s:05d}-of-00004.npz" for s in range(4)] + ["manifest.json"]
    with pytest.raises(ValueError, match="not divisible"):
        ckpt.save_sharded_checkpoint(path, {"w": np.zeros((3, 2))}, 2, [0])


def test_same_step_sharded_resave_never_overwrites(tmp_path, monkeypatch):
    """tests/test_infra.py:384 on the port: re-saving a step picks fresh
    generation-suffixed names, so a crash mid-save leaves the old shard set
    whole; a good re-save commits the new names and collects the old."""
    path = str(tmp_path / "ckpt")
    ckpt.save_sharded_checkpoint(path, {"w": np.zeros((2, 2))}, 2, [0], step=5,
                                 meta={"run": "old"})
    old_files = {n for n in os.listdir(path) if n.endswith(".npz")}
    monkeypatch.setattr(np, "savez", _boom_savez(1, partial=False))
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_sharded_checkpoint(path, {"w": np.ones((2, 2))}, 2, [0], step=5,
                                     meta={"run": "new"})
    monkeypatch.undo()
    assert old_files <= set(os.listdir(path))
    tree, step, meta = ckpt.load_checkpoint(path)
    assert step == 5 and meta["run"] == "old"
    np.testing.assert_array_equal(tree["w"], np.zeros((2, 2)))

    ckpt.save_sharded_checkpoint(path, {"w": np.ones((2, 2))}, 2, [0], step=5,
                                 meta={"run": "new"})
    tree, _, meta = ckpt.load_checkpoint(path)
    assert meta["run"] == "new"
    np.testing.assert_array_equal(tree["w"], np.ones((2, 2)))
    assert not (old_files & set(os.listdir(path)))
    # the crashed re-save left generation 1 half written: the good one is 2
    assert _manifest(path)["shard_files"] == [
        f"arrays-00000005-shard{s:05d}-of-00002-g2.npz" for s in range(2)]


REF_SPMD_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
import jax, json, numpy as np
from repro.checkpoint import load_checkpoint
from repro.configs.base import ModelConfig, AttentionConfig, BlockSpec, OptimizerConfig
from repro.data import batches
from repro.engine import LoopConfig, SpmdEngine, run_loop
from repro.engine.loop import resume_if_present
from repro.launch.mesh import make_mesh_compat
from repro.models import init_model

cfg = ModelConfig(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
                  attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                  pattern=(BlockSpec("attn","dense"),), scan_layers=False)
root, steps, cut = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
K = M = 4
params = init_model(jax.random.PRNGKey(0), cfg)
eng = SpmdEngine(cfg, OptimizerConfig(total_steps=steps, **json.loads(sys.argv[4])), num_stages=K,
                 num_microbatches=M, mesh=make_mesh_compat((K, 1), ("stage", "data")),
                 schedule="1f1b")

def run(n, ckpt_dir=None, resume=None):
    data = batches(cfg, M * 2, 16, seed=0)
    state, start = resume_if_present(eng, eng.init_state(params=params), resume, data)
    return run_loop(eng, data, LoopConfig(steps=n, ckpt_dir=ckpt_dir), state=state,
                    start_step=start)[1]

run(cut, ckpt_dir=os.path.join(root, "ref"))
out = {"ref_continues_ref": run(steps, resume=os.path.join(root, "ref"))}
print("ready", flush=True)
sys.stdin.readline()  # the port has written its checkpoint and its re-save of ours
a = load_checkpoint(os.path.join(root, "ref"))
b = load_checkpoint(os.path.join(root, "resaved"))
la, lb = jax.tree_util.tree_leaves(a[0]), jax.tree_util.tree_leaves(b[0])
out["resave_structure"] = jax.tree.structure(a[0]) == jax.tree.structure(b[0])
out["resave_bitwise"] = len(la) == len(lb) and all(
    np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(la, lb))
out["resave_step_meta"] = a[1:] == b[1:]
out["ref_continues_port"] = run(steps, resume=os.path.join(root, "port"))
print(json.dumps(out))
"""

# unilateral: full-rank grams, so that the continuations can be held to the
# tolerances (bilateral refreshes here move the reference's own curve by
# several 1e-2 under roundoff-sized perturbations)
SPMD_ROTATION = {"name": "basis_rotation", "rotation_freq": 2, "stage_aware": True,
                 "rotation_geometry": "unilateral"}


def test_spmd_sharded_checkpoint_crosses_between_the_packages(tmp_path, ref_params):
    """The stage-sharded layout (4 stages, 1F1B, stage-aware basis rotation,
    checkpoint at step 2 of 6), with the reference's SpmdEngine on four
    forced host devices in one subprocess: the port's own checkpoint has
    the reference's manifest (spec, shard files and the per-leaf shard axes
    the reference reads off its shardings); the port re-saves the
    reference's checkpoint with a manifest equal byte for byte, and the
    reference loads that back bitwise; each package continues from each
    checkpoint within the tolerances for two implementations."""
    root = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    cut = 2
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", REF_SPMD_SCRIPT, root, str(STEPS), str(cut),
             json.dumps(SPMD_ROTATION)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT,
            env=env)
        try:
            engine = _port_spmd_engine(SPMD_ROTATION)
            pair = stacked_from_numpy(_np_tree(jstack(ref_params, JCFG, 4)), "cpu")

            def port_run(n, ckpt_dir=None, resume=None):
                data = batches(TCFG, 8, S, seed=0, device="cpu")
                state, start = resume_if_present(engine, engine.init_state(pair), resume, data)
                return run_loop(engine, data, LoopConfig(steps=n, ckpt_dir=ckpt_dir),
                                state=state, start_step=start)[1]

            port_run(cut, ckpt_dir=os.path.join(root, "port"))
            port_from_port = port_run(STEPS, resume=os.path.join(root, "port"))
            assert proc.stdout.readline().strip() == "ready"
            port_from_ref = port_run(STEPS, resume=os.path.join(root, "ref"))
            tree, step, meta = ckpt.load_checkpoint(os.path.join(root, "ref"))
            engine.save_checkpoint(os.path.join(root, "resaved"), engine.load_state(tree),
                                   step=step, meta=meta)
            proc.stdin.write("go\n")
            proc.stdin.flush()
            stdout, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        err.seek(0)
        assert proc.returncode == 0, err.read()[-3000:]
    got = json.loads(stdout.strip().splitlines()[-1])

    ref_m, port_m = _manifest(os.path.join(root, "ref")), _manifest(os.path.join(root, "port"))
    assert port_m == ref_m
    assert ref_m["format"] == "sharded" and ref_m["num_shards"] == 4
    assert {0, 1, None} == set(ref_m["shard_axes"])
    with open(os.path.join(root, "ref", "manifest.json")) as f, \
            open(os.path.join(root, "resaved", "manifest.json")) as g:
        assert f.read() == g.read()
    for x, y in zip(_leaves(os.path.join(root, "port")), _leaves(os.path.join(root, "ref"))):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert got["resave_structure"] and got["resave_bitwise"] and got["resave_step_meta"]
    _assert_close_curves(port_from_ref, got["ref_continues_ref"], "basis_rotation")
    _assert_close_curves(port_from_port, got["ref_continues_port"], "basis_rotation")
    assert len(port_from_ref) == STEPS - cut
