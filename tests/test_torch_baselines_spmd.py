"""The baselines on the port's SPMD engine (stage-stacked leaves, 1F1B, the
per-stage delay FIFO) against the reference's ``SpmdEngine`` on four forced
host devices, run in one subprocess as the reference's own tests run it:
delay compensation (the stage weight queues), pipedream_lr (per-stage
factors built from meta shapes) and muon (Newton-Schulz batched over the
stacked layers)."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.engine.spmd import stack_stage_params as jstack
from repro.models.model import init_model as jinit_model
from repro_torch.checkpoint.convert import stacked_from_numpy
from repro_torch.configs import OptimizerConfig
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.data import batches
from repro_torch.engine import LoopConfig, SpmdEngine, run_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's own engine-test model (tests/test_engine.py:32)
_SHAPE = dict(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
              scan_layers=False)
JCFG = JModelConfig(attention=JAttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                    pattern=(JBlockSpec("attn", "dense"),), **_SHAPE)
TCFG = ModelConfig(attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                   pattern=(BlockSpec("attn", "dense"),), **_SHAPE)
K, M, STEPS = 4, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; torch's
    intra-op threads then fight the other workers for the cores, and these
    small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
import jax, json
from repro.configs.base import ModelConfig, AttentionConfig, BlockSpec, OptimizerConfig
from repro.data import batches
from repro.engine import LoopConfig, SpmdEngine, run_loop
from repro.launch.mesh import make_mesh_compat
from repro.models import init_model

cfg = ModelConfig(num_layers=4, d_model=32, d_ff=64, vocab_size=64, max_seq_len=64,
                  attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
                  pattern=(BlockSpec("attn","dense"),), scan_layers=False)
K, M, steps = 4, 4, int(sys.argv[1])
params = init_model(jax.random.PRNGKey(0), cfg)
mesh = make_mesh_compat((K, 1), ("stage", "data"))
res = {}
for name in json.loads(sys.argv[2]):
    eng = SpmdEngine(cfg, OptimizerConfig(name=name, learning_rate=3e-3, total_steps=steps),
                     num_stages=K, num_microbatches=M, mesh=mesh, schedule="1f1b")
    _, res[name] = run_loop(eng, batches(cfg, M * 2, 16, seed=0), LoopConfig(steps=steps),
                            state=eng.init_state(params=params))
print(json.dumps(res))
"""

NAMES = ["delay_compensation", "pipedream_lr", "muon"]


def test_spmd_engine_tracks_the_reference_for_the_baselines():
    """From the same weights on the same stream, 1F1B over 4 stages with the
    delay FIFO; the port routes attention through the kernels' plain
    versions. delay_compensation and pipedream_lr within Adam's 1e-4; muon
    within 1e-4 on the first two losses and 1e-3 on all."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # the reference compiles in its own process while the port runs here
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, str(STEPS),
                             json.dumps(NAMES)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    try:
        pair = stacked_from_numpy(jax.tree.map(np.asarray, jstack(
            jinit_model(jax.random.PRNGKey(0), JCFG), JCFG, K)), "cpu")
        got = {}
        for name in NAMES:
            eng = SpmdEngine(TCFG, OptimizerConfig(name=name, learning_rate=3e-3,
                                                   total_steps=STEPS),
                             num_stages=K, num_microbatches=M, schedule="1f1b",
                             use_kernels=True, device="cpu")
            state = eng.init_state(pair)
            if name == "delay_compensation":  # one weight ring per queued leaf
                assert [q is None for q in state.opt_state["param_q"]] == \
                    [q is None for q in state.opt_state["grad_q"]]
            _, got[name], _ = run_loop(eng, batches(TCFG, M * 2, 16, seed=0, device="cpu"),
                                       LoopConfig(steps=STEPS), state=state)
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for name in NAMES:
        diffs = [abs(a - b) for a, b in zip(got[name], want[name])]
        first2, every = (1e-4, 1e-3) if name == "muon" else (1e-4, 1e-4)
        assert len(diffs) == STEPS, (name, got[name], want[name])
        assert max(diffs[:2]) < first2 and max(diffs) < every, (name, got[name], want[name])
    # the baselines differ from one another: each branch ran
    assert len({tuple(v) for v in got.values()}) == len(NAMES)
