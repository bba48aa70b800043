"""Checkpoints of the baselines' states in the reference's on-disk format:
adasgd's scalar ``v``, scion's ``{"m"}`` and delay compensation's weight
queues ``param_q`` beside ``grad_q``. Each package continues the other's
gathered sim checkpoint in process; the stage-sharded SPMD checkpoint of
delay compensation crosses in both directions with the reference's
``SpmdEngine`` on four forced host devices in one subprocess."""
import contextlib
import json
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

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
STEPS, CUT, B, S = 6, 3, 4, 16
# losses of two implementations of one step: the elementwise states differ by
# float32 roundoff, as Adam's do; scion's sign LMO flips where the momentum
# is within roundoff of zero
TOLS = {"adasgd": (1e-4, 1e-4), "delay_compensation": (1e-4, 1e-4), "scion": (1e-4, 1e-3)}


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


def _assert_close_curves(got, want, name):
    first2, every = TOLS[name]
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(got) == len(want) and max(diffs[:2]) < first2 and max(diffs) < every, (got, want)


@pytest.mark.parametrize("name", ["adasgd", "scion", "delay_compensation"])
def test_each_package_continues_the_others_sim_checkpoint(tmp_path, ref_params, name):
    """4 stages (delays 3..0), checkpoint at step 3 of 6, so that the rings'
    head is away from 0: both checkpoints have the same manifest and leaf
    shapes, each leaf within float32 roundoff of the other's, and from
    either checkpoint both packages continue through steps 3-5 within the
    tolerances for two implementations of the step."""
    ocfg = {"name": name, "learning_rate": 1e-3, "total_steps": STEPS}
    jeng = JSimEngine(JCFG, jbuild_optimizer(JOptimizerConfig(**ocfg), ref_params, JCFG,
                                             num_stages=4))
    model = params_from_numpy(_np_tree(ref_params), TCFG, "cpu")
    teng = SimEngine(model, build_optimizer(OptimizerConfig(**ocfg), param_leaves(model), TCFG,
                                            num_stages=4))

    def ref_run(steps, ckpt_dir=None, resume=None):
        data = jbatches(JCFG, B, S, seed=0)
        state, start = jresume_if_present(jeng, jeng.init_state(params=ref_params), resume,
                                          data)
        return jrun_loop(jeng, data, JLoopConfig(steps=steps, ckpt_dir=ckpt_dir), state=state,
                         start_step=start)[1]

    def port_run(steps, ckpt_dir=None, resume=None):
        with torch.no_grad():
            for p, w in zip(param_leaves(model).values(), jax.tree_util.tree_leaves(ref_params)):
                p.copy_(torch.from_numpy(np.array(w)))
        data = batches(TCFG, B, S, seed=0, device="cpu")
        state, start = resume_if_present(teng, None, resume, data)
        return run_loop(teng, data, LoopConfig(steps=steps, ckpt_dir=ckpt_dir), state=state,
                        start_step=start)[1]

    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_run(CUT, ckpt_dir=ref_dir)
    port_run(CUT, ckpt_dir=port_dir)
    assert _manifest(port_dir)["spec"] == _manifest(ref_dir)["spec"]
    opt_keys = _manifest(ref_dir)["spec"]["children"][1]["keys"]
    assert opt_keys == (["grad_q", "inner", "param_q"] if name == "delay_compensation"
                        else ["grad_q", "inner"])
    for x, y in zip(_leaves(port_dir), _leaves(ref_dir)):
        assert x.shape == y.shape and x.dtype == y.dtype
        tol = 1e-5 if name != "scion" else 1e-4
        assert np.linalg.norm(x - y) <= tol * max(np.linalg.norm(y), 1e-6)
    for d in (ref_dir, port_dir):
        _assert_close_curves(port_run(STEPS, resume=d), ref_run(STEPS, resume=d), name)


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

SPMD_DC = {"name": "delay_compensation", "learning_rate": 3e-3}


def test_spmd_sharded_delay_compensation_checkpoint_crosses_between_the_packages(
        tmp_path, ref_params):
    """4 stages, 1F1B, checkpoint at step 2 of 6 (the stage rings' head away
    from 0): the port's own sharded checkpoint has the reference's manifest,
    the weight queues on the stage axis the gradient queues have; the port
    re-saves the reference's checkpoint with a manifest equal byte for
    byte, which the reference loads back bitwise; each package continues
    from each checkpoint within Adam's 1e-4."""
    root = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    cut = 2
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", REF_SPMD_SCRIPT, root, str(STEPS), str(cut),
             json.dumps(SPMD_DC)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT,
            env=env)
        try:
            engine = SpmdEngine(TCFG, OptimizerConfig(total_steps=STEPS, **SPMD_DC),
                                num_stages=4, num_microbatches=4, schedule="1f1b",
                                use_kernels=True, device="cpu")
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
    opt_spec = ref_m["spec"]["children"][1]
    assert opt_spec["keys"] == ["grad_q", "inner", "param_q"]
    assert ref_m["format"] == "sharded" and ref_m["num_shards"] == 4
    with open(os.path.join(root, "ref", "manifest.json")) as f, \
            open(os.path.join(root, "resaved", "manifest.json")) as g:
        assert f.read() == g.read()
    for x, y in zip(_leaves(os.path.join(root, "port")), _leaves(os.path.join(root, "ref"))):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert got["resave_structure"] and got["resave_bitwise"] and got["resave_step_meta"]
    _assert_close_curves(port_from_ref, got["ref_continues_ref"], "delay_compensation")
    _assert_close_curves(port_from_port, got["ref_continues_port"], "delay_compensation")
    assert len(port_from_ref) == STEPS - cut
