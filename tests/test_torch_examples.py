"""The port's four examples (``examples/*_torch.py``) on the CPU against the
reference's: the quickstart's curves within the smoke tolerances, the
stage-aware delay -> period table, the end-to-end driver with its
checkpoint, and the serving example's first logits."""
import contextlib
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.models import param_leaves

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _example(name):
    """An example script as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart():
    """Both packages' quickstart modules and the reference's weights."""
    ref, port = _example("quickstart"), _example("quickstart_torch")
    params = ref.init_model(jax.random.PRNGKey(0), ref.CFG)
    tree = jax.tree.map(np.asarray, params)
    return ref, port, params, param_leaves(params_from_numpy(tree, port.CFG, "cpu"))


@pytest.mark.parametrize("name", ["adam", "basis_rotation"])
def test_quickstart_tracks_the_reference(quickstart, name):
    """6 steps of the 8-stage simulation from the reference's weights on the
    same stream: Adam within 1e-4, basis rotation within 2e-3 on the first
    two steps and 5e-2 on all (the repo's smoke tolerances)."""
    from repro.optim.factory import build_optimizer as jbuild_optimizer

    ref, port, params, leaves = quickstart
    steps = 6
    ocfg = ref.OptimizerConfig(name=name, learning_rate=3e-3, total_steps=steps,
                               rotation_freq=10)
    opt = jbuild_optimizer(ocfg, params, ref.CFG, num_stages=ref.STAGES)
    _, _, want = ref.run_sim_training(ref.CFG, opt, ref.batches(ref.CFG, 8, 32, seed=0),
                                      steps=steps, params=params)
    got = port.train(name, leaves, steps, "cpu")
    assert port.STAGES == ref.STAGES and port.STEPS == ref.STEPS
    diffs = [abs(a - b) for a, b in zip(got, want)]
    assert len(got) == steps
    if name == "adam":
        assert max(diffs) < 1e-4, (got, want)
    else:
        assert max(diffs[:2]) < 2e-3 and max(diffs) < 5e-2, (got, want)


def test_stage_aware_delay_periods_equal_the_reference(quickstart):
    from repro.core.stage_aware import freqs_for_delays
    from repro.pipeline.partition import leaf_delays

    ref_ex, port = _example("stage_aware_rotation"), _example("stage_aware_rotation_torch")
    _, _, params, leaves = quickstart
    delays = leaf_delays(params, ref_ex.CFG, ref_ex.STAGES)
    want = sorted(set(zip(delays, freqs_for_delays(delays, ref_ex.STAGES, 10))))
    assert port.delay_periods(leaves) == want
    assert len(want) == port.STAGES


def test_train_async_pipeline_quick_run_writes_its_checkpoint(tmp_path):
    ckpt, out = tmp_path / "ckpt", tmp_path / "metrics.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_async_pipeline_torch.py"),
         "--quick", "--steps", "3", "--device", "cpu", "--ckpt-dir", str(ckpt),
         "--out", str(out)], capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert (ckpt / "manifest.json").exists()
    assert json.loads((ckpt / "manifest.json").read_text())["step"] == 3
    metrics = json.loads(out.read_text())
    assert metrics["steps_done"] == 3 and all(np.isfinite(metrics["losses"]))


def test_serve_decode_first_logits_match_the_reference():
    """The serving example on the reference's weights of its default arch
    (mixtral_8x22b's smoke config, float32 compute): the logits of the
    prompt's first token within 2e-4 of the reference's forward_decode."""
    from repro.configs import get_config as jget_config
    from repro.models import forward_decode as jforward_decode
    from repro.models import init_cache as jinit_cache
    from repro.models import init_model as jinit_model
    from repro_torch.configs import get_config

    ex = _example("serve_decode_torch")
    arch = "mixtral_8x22b"
    cj = jget_config(arch, smoke=True).replace(dtype="float32", scan_layers=False)
    ct = get_config(arch, smoke=True).replace(dtype="float32", scan_layers=False)
    params = jinit_model(jax.random.PRNGKey(0), cj)
    model = params_from_numpy(jax.tree.map(np.asarray, params), ct, "cpu")
    res = ex.decode(ct, batch=2, prompt_len=3, gen_len=2, device="cpu", model=model)
    first = np.asarray(res["prompt"][:, :1])
    want, _ = jforward_decode(params, cj, jnp.asarray(first), jinit_cache(cj, 2, 5), jnp.int32(0))
    np.testing.assert_allclose(res["prompt_logits"][:, 0].numpy(), np.asarray(want)[:, 0],
                               rtol=2e-4, atol=2e-4)
    assert res["generated"].shape == (2, 2)
