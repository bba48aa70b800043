"""The port's dry run on the meta device (``launch/dryrun.py``,
``launch/dryrun_pipeline.py``, ``launch/roofline.py``) and the input shapes
against the JAX reference: ``INPUT_SHAPES``, ``shapes_for`` and
``supports_long_context`` for every id, ``param_counts`` and ``model_flops``
for every arch and shape (the reference's side from ``jax.eval_shape``,
which allocates nothing), the trace's FLOPs against the matrix products
counted by hand, the CLI in a subprocess, the ``long_500k`` skip rows, the
refused ``model``-axis flags and the pipeline dry run at a small grid."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs.catalog import ARCH_IDS as JARCH_IDS
from repro.configs.catalog import get_config as jget_config
from repro.configs.catalog import shapes_for as jshapes_for
from repro.models.model import init_model as jinit_model
from repro_torch.configs import INPUT_SHAPES, get_config, shapes_for
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun_pipeline import dryrun_pipeline
from repro_torch.launch.roofline import (
    HBM_BW,
    ICI_BW,
    PEAK_FLOPS,
    card_peaks,
    roofline_from_trace,
)
from repro_torch.models import Transformer, param_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = JARCH_IDS + ["paper_95m", "paper_1b", "paper_3b", "phi4_mini_3_8b_swa"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_dryrun():
    """The reference's dry-run module. It asks for 512 host devices when
    imported, so the backend is started first (with its one CPU device) and
    the environment is restored after the import."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def test_input_shapes_and_long_context_policy_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JINPUT_SHAPES.items()}
    for arch in IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert cfg.supports_long_context() == jcfg.supports_long_context(), arch
        assert [s.name for s in shapes_for(cfg)] == [s.name for s in jshapes_for(jcfg)], arch


@pytest.mark.parametrize("arch", IDS)
def test_param_counts_and_model_flops_match_reference(arch):
    """Total and active parameters of the port's stacked meta model equal the
    reference's counts over ``jax.eval_shape`` of its stacked tree, and so
    does ``model_flops`` at every input shape."""
    jd = _reference_dryrun()
    jcfg, cfg = jget_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: jinit_model(k, jcfg), jax.random.PRNGKey(0))
    want = jd.param_counts(shapes, jcfg)
    got = dryrun.param_counts(param_leaves(Transformer(cfg, device="meta", seed=None)), cfg)
    assert got == want
    for name in INPUT_SHAPES:
        assert dryrun.model_flops(cfg, INPUT_SHAPES[name], got[1]) == jd.model_flops(
            jcfg, JINPUT_SHAPES[name], want[1])
    assert dryrun.rotation_strategy(arch) == jd.rotation_strategy(arch)


def _hand_config():
    return ModelConfig(num_layers=3, d_model=64, d_ff=96, vocab_size=97, max_seq_len=64,
                       attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
                       pattern=(BlockSpec("attn", "dense"),))


def _forward_flops(cfg, B, S, head_rows):
    """The matrix products of one forward, counted by hand: per layer the q,
    k, v and o projections, QK^T and PV over every (query, key) pair, the
    SwiGLU MLP's three products; then the head over ``head_rows`` positions."""
    d, H, Hkv, dh, f = (cfg.d_model, cfg.attention.num_heads, cfg.attention.num_kv_heads,
                        cfg.attention.head_dim, cfg.d_ff)
    proj = 2 * B * S * d * (H * dh + 2 * Hkv * dh + H * dh)
    attn = 2 * (2 * B * H * S * S * dh)
    mlp = 3 * 2 * B * S * d * f
    return cfg.num_layers * (proj + attn + mlp) + 2 * B * head_rows * d * cfg.vocab_size


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_trace_flops_equal_the_products_counted_by_hand(monkeypatch, mode):
    """A prefill traces one forward, the head on the last position only. A
    train step with Adam (no products in the optimizer) traces the forward,
    the stacked blocks' forward once more (remat) and a backward of two
    products for each forward one. The recompute stops once the last
    tensor its backward saved is back (``torch.utils.checkpoint``'s early
    stop), so each block's last product, the MLP's ``w_down``, whose output
    nothing saves, is not recomputed."""
    cfg = _hand_config()
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    B, S = 2, 32
    shape = INPUT_SHAPES["prefill_32k" if mode == "prefill" else "train_4k"]
    row = dryrun.dryrun_one("hand", shape.name, optimizer="adam", verbose=False, batch=B,
                            seq=S)
    if mode == "prefill":
        want = _forward_flops(cfg, B, S, head_rows=1)
    else:
        full = _forward_flops(cfg, B, S, head_rows=S)
        blocks = full - 2 * B * S * cfg.d_model * cfg.vocab_size
        w_down = 2 * B * S * cfg.d_ff * cfg.d_model
        want = 3 * full + blocks - cfg.num_layers * w_down
    assert row["status"] == "ok" and row["flops"] == want
    assert row["hbm_bytes"] > 0 and row["peak_bytes_per_device"] > row["argument_bytes"]


def test_cli_row_for_one_arch_and_shape():
    """The reference's system test, on the port: one (arch, shape) through
    the CLI in a subprocess, without a card."""
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "qwen1_5_0_5b", "--shape", "decode_32k"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["status"] == "ok"
    assert row["flops"] > 0 and row["bottleneck"] in ("compute", "memory", "collective")
    assert row["mesh"] == {"data": 16, "model": 1} and row["batch"] == 128 // 16
    assert row["fits"] == (row["peak_bytes_per_device"] <= row["card_bytes"])


def test_long_500k_skip_rows_match_reference():
    """Full-attention architectures skip ``long_500k`` with the reference's
    row and reason; the others run it."""
    for arch in JARCH_IDS:
        if jget_config(arch).supports_long_context():
            continue
        row = dryrun.dryrun_one(arch, "long_500k", verbose=False)
        assert row == {"arch": arch, "shape": "long_500k", "multi_pod": False,
                       "status": "skipped", "reason": "full attention (DESIGN.md §6)"}
    row = dryrun.dryrun_one("xlstm_1_3b", "long_500k", verbose=False, extrapolate=False)
    assert row["status"] == "ok" and row["flops"] == 0.0 and row["batch"] == 1


@pytest.mark.parametrize("flag", ["--grad-rs", "--seq-shard"])
def test_model_axis_flags_are_refused_by_name(flag):
    with pytest.raises(SystemExit, match=flag):
        dryrun.main(["--arch", "qwen3_0_6b", "--shape", "train_4k", flag])


def test_sweep_records_an_error_and_goes_on(monkeypatch, capsys):
    """A row that raises is recorded with its error, and the sweep goes on."""
    real = dryrun.dryrun_one

    def flaky(arch, shape, *a, **kw):
        if shape == "train_4k":
            raise RuntimeError("boom")
        return real(arch, shape, *a, **{**kw, "extrapolate": False})

    monkeypatch.setattr(dryrun, "dryrun_one", flaky)
    monkeypatch.setattr(dryrun, "ARCH_IDS", ["qwen1_5_0_5b"])
    rows = dryrun.main(["--all", "--no-extrap"])
    assert [r["status"] for r in rows] == ["error", "ok", "ok", "skipped"]
    assert rows[0]["error"] == "RuntimeError: boom"


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b"])
def test_pipeline_dryrun_small_grid(schedule):
    """``dryrun_pipeline`` at 2 stages and 2 microbatches: a row of the
    reference's kind, each rank's sends the schedule's activations (stage
    0) or gradients (stage 1), M x rows x S x d_model bf16 values."""
    row = dryrun_pipeline(stages=2, microbatches=2, schedule=schedule)
    assert row["kind"] == "pipeline_dryrun" and row["status"] == "ok"
    assert row["schedule"] == schedule and row["mesh"] == "2x16" and row["processes"] == 32
    d = get_config("paper_95m").d_model
    assert [r["sent_bytes"] for r in row["ranks"]] == [2 * 2 * 512 * d * 2] * 2
    assert all(r["peak_bytes"] > r["argument_bytes"] > 0 for r in row["ranks"])
    assert row["collectives"]["all-reduce"] > row["reduce_bytes"] > 0


def test_roofline_terms_and_card_peaks():
    rf = roofline_from_trace(2 * PEAK_FLOPS, HBM_BW, {"all-reduce": int(ICI_BW)})
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (2.0, 1.0, 1.0)
    assert rf.bottleneck == "compute" and rf.step_time_s == 2.0
    assert card_peaks("NVIDIA H100 80GB HBM3")[0] == "SXM"
    assert card_peaks("NVIDIA H100 PCIe")[0] == "PCIe"
    assert card_peaks("NVIDIA H100 NVL")[0] == "NVL"
