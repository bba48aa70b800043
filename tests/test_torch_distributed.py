"""The port's multi-process scale-out against the reference: the process grid
and its environment contract, the topology's process maps, the
process-local batches, the sharded checkpointer's ownership protocol, and
real 2-process gloo runs on the CPU through ``repro_torch.launch.spawn``.

The spawned runs use the smoke config of the reference's own multi-process
tests (``tests/test_distributed.py`` ``TRAIN_ARGS``) with ``--device cpu``.
Every process and the in-process single-process run use one torch thread,
so the stage-split runs can be compared with the single-process one to
1e-6 (they have been bit for bit) and the resumed run bit for bit. Each
subprocess has its own timeout.
"""
import contextlib
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.configs.catalog import get_config as jget_config
from repro.data.synthetic import process_local_batches as jprocess_local_batches
from repro.launch import distributed as jdist
from repro.launch.topology import Topology as JTopology
from repro_torch.checkpoint.ckpt import load_checkpoint, save_sharded_checkpoint
from repro_torch.configs import OptimizerConfig, get_config
from repro_torch.core.stage_aware import StageContext
from repro_torch.data import batches, process_local_batches
from repro_torch.engine import spmd as tspmd
from repro_torch.engine.spmd import SpmdEngine
from repro_torch.launch import devices, distributed, spawn, train
from repro_torch.launch.topology import Topology
from repro_torch.optim.base import Optimizer
from repro_torch.pipeline.delay import stage_delayed_optimizer

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's multi-process smoke run (tests/test_distributed.py:237-239)
TRAIN_ARGS = ("--backend spmd --smoke --arch paper_95m --optimizer adam "
              "--batch 4 --seq 32 --lr 1e-3 --log-every 2 --steps 8 "
              "--ckpt-every 4 --device cpu")
STAGE_SPLIT_TOL = 1e-6  # 2-process stage split against one process (seen: 0)
SPAWN_TIMEOUT = 240  # seconds a spawned run may take; the subprocess gets 30 more


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Bitwise comparisons need one torch thread (several are not
    repeatable on the CPU); the spawned processes get OMP_NUM_THREADS=1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # numpy's BLAS pool too: its idle threads spin on the cores the others need
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _spawn(extra, train_args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.spawn", "--timeout", str(SPAWN_TIMEOUT),
           *extra, "--", *train_args.split()]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=SPAWN_TIMEOUT + 30)


def _losses(path):
    with open(path) as f:
        return json.load(f)["losses"]


# -- ProcessGrid / env contract ----------------------------------------------

@pytest.mark.parametrize("args", [(), (4, 3, "h:1"), (2, 1, "127.0.0.1:9"), (0, 0), (2, 2, "h:1"),
                                  (1, 1), (1, -1)])
def test_process_grid_matches_the_reference(args):
    """Same coordinates, the same ``distributed`` flag and description, and
    the same ValueError ("process_index out of range") where the reference
    refuses."""
    try:
        want = jdist.ProcessGrid(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            distributed.ProcessGrid(*args)
        return
    got = distributed.ProcessGrid(*args)
    assert (got.num_processes, got.process_index, got.coordinator, got.distributed,
            got.describe()) == (want.num_processes, want.process_index, want.coordinator,
                                want.distributed, want.describe())


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_COORDINATOR": "127.0.0.1:9", "REPRO_NUM_PROCESSES": "2", "REPRO_PROCESS_ID": "1"},
    {"REPRO_NUM_PROCESSES": "2"},
    {"REPRO_COORDINATOR": "h:1", "REPRO_PROCESS_ID": "0"},
])
def test_distributed_env_contract_matches_the_reference(env):
    """The env names are the reference's; None outside a launch, the grid
    inside one, and RuntimeError on a partial contract."""
    assert (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
            distributed.ENV_PROCESS_ID) == (jdist.ENV_COORDINATOR, jdist.ENV_NUM_PROCESSES,
                                            jdist.ENV_PROCESS_ID)
    try:
        want = jdist.distributed_env(env=dict(env))
    except RuntimeError:
        with pytest.raises(RuntimeError, match="partial multi-controller env"):
            distributed.distributed_env(env=dict(env))
        return
    got = distributed.distributed_env(env=dict(env))
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.num_processes, got.process_index, got.coordinator) == (
            want.num_processes, want.process_index, want.coordinator)


def test_single_process_helpers_and_init_without_a_launch():
    """Outside a multi-process launch every helper gives the one-process
    answer, and a 2-process grid without a coordinator is refused as the
    reference's ``init_distributed`` refuses it."""
    assert distributed.init_distributed(distributed.ProcessGrid()) == distributed.ProcessGrid()
    assert (distributed.process_count(), distributed.process_index(), distributed.is_main()) == (
        1, 0, True)
    distributed.barrier("never-waits")
    assert distributed.barrier_waits() == []
    with pytest.raises(ValueError, match="needs a coordinator"):
        distributed.init_distributed(distributed.ProcessGrid(2, 0))
    with pytest.raises(ValueError, match="needs a coordinator"):
        jdist.init_distributed(jdist.ProcessGrid(2, 0))
    assert distributed.split_address("tcp://localhost:29500") == ("localhost", 29500)


def test_transport_choice_follows_the_layout(monkeypatch):
    """gloo on the CPU, host-staged gloo for ranks that share a card, NCCL
    with a card per rank; NCCL asked for where it cannot run is refused,
    and no other transport may be asked for."""
    cpu = torch.device("cpu")
    assert devices.choose_transport(cpu, 2)[:2] == ("gloo", False)
    with pytest.raises(ValueError, match="card per rank"):
        devices.choose_transport(cpu, 2, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card = torch.device("cuda", 0)
    assert devices.choose_transport(card, 2)[:2] == ("gloo", True)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        devices.choose_transport(card, 2, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert devices.choose_transport(card, 4)[:2] == ("nccl", False)
    assert devices.choose_transport(card, 4, "nccl")[:2] == ("nccl", False)
    with pytest.raises(ValueError, match="unknown transport"):
        devices.choose_transport(card, 4, "gloo")
    assert devices.rank_device("cpu", 3) == cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        devices.rank_device("cuda", 0)


def test_spawn_worker_env_and_manifest_step(tmp_path):
    env = spawn.worker_env(2, 1, "127.0.0.1:5")
    assert env[distributed.ENV_NUM_PROCESSES] == "2" and env[distributed.ENV_PROCESS_ID] == "1"
    assert env[distributed.ENV_COORDINATOR] == "127.0.0.1:5"
    assert env["PYTHONPATH"].startswith(os.path.join(ROOT, "src"))
    assert spawn.manifest_step(str(tmp_path)) is None
    (tmp_path / "manifest.json").write_text(json.dumps({"step": 7}))
    assert spawn.manifest_step(str(tmp_path)) == 7
    args = spawn.parse_args(["--procs", "2", "--kill-pod-at", "4", "--", "--steps", "8"])
    assert (args.procs, args.kill_pod_at, args.train_args) == (2, 4, ["--steps", "8"])


# -- Topology's process maps ----------------------------------------------------

def _dims(topo):
    return topo.stages, topo.data, topo.pods


LAYOUTS = [((2, 1, 2), 2), ((2, 1, 1), 2), ((2, 4, 1), 4), ((2, 2, 1), 2), ((4, 1, 1), 2),
           ((2, 2, 2), 4), ((2, 2, 2), 2), ((8, 1, 1), 2), ((8, 1, 2), 2), ((2, 3, 1), 3),
           ((2, 3, 1), 2)]


@pytest.mark.parametrize("shape,procs", LAYOUTS)
def test_process_maps_match_the_reference(shape, procs):
    """(stages, data, pods) over ``procs`` processes: the same local device
    counts, coordinates, data-shard ranges (or the same refusal), shard
    owners, axes and replica groups as the reference's ``Topology``; and
    the port's slabs partition the grid wherever the data shards are
    contiguous."""
    stages, data, pods = shape
    t, j = Topology(stages, data, pods), JTopology(stages, data, pods)
    assert (t.shape, t.axis_names, t.data_axes, t.num_devices, t.data_shards) == (
        j.shape, j.axis_names, j.data_axes, j.num_devices, j.data_shards)
    for axes in (t.data_axes, ("stage",)):
        assert t.replica_groups(axes) == j.replica_groups(axes)
    try:
        want = j.local_device_count(procs)
    except ValueError:
        with pytest.raises(ValueError, match="do not split"):
            t.local_device_count(procs)
        return
    assert t.local_device_count(procs) == want
    assert t.shard_owners(procs) == j.shard_owners(procs)
    contiguous = True
    for p in range(procs):
        np.testing.assert_array_equal(t._process_coords(procs, p), j._process_coords(procs, p))
        try:
            want = j.process_data_shards(procs, p)
        except ValueError:
            contiguous = False
            with pytest.raises(ValueError, match="non-contiguous"):
                t.process_data_shards(procs, p)
            continue
        assert t.process_data_shards(procs, p) == want
        assert t.process_slab(procs, p).data_shards == want
    if contiguous:
        distributed.assert_process_slabs(t, procs)
    local = t.local_device_count(procs)
    assert _dims(Topology.from_process_grid(stages, procs, local, pods=pods)) == \
        _dims(JTopology.from_process_grid(stages, procs, local, pods=pods))


def test_from_device_count_fills_the_data_axis_as_the_reference_does():
    for args in [(2, 1, 0, 8), (4, 2, 0, 16), (2, 1, 3, 6)]:
        stages, pods, data, n = args
        assert _dims(Topology.from_device_count(stages, pods, data, n)) == \
            _dims(JTopology.from_device_count(stages, pods, data, n))
    with pytest.raises(ValueError, match="not divisible"):
        Topology.from_device_count(3, device_count=8)


# -- process-local batches ------------------------------------------------------

@pytest.mark.parametrize("shards,parts", [(2, [(0, 1), (1, 2)]), (4, [(0, 2), (2, 4)]),
                                          (4, [(0, 1), (1, 3), (3, 4)]), (1, [(0, 1)])])
def test_process_local_batches_match_the_reference_and_stack_into_the_stream(shards, parts):
    """Each process's slice equals the reference's bit for bit, and the
    slices stacked over a partition of the shards are the single-process
    microbatched stream."""
    M, B, S = 2, 16, 8
    cfg, jcfg = get_config("paper_95m", smoke=True), jget_config("paper_95m", smoke=True)
    whole = batches(cfg, B, S, seed=3, device="cpu")
    mine = [process_local_batches(cfg, B, S, M, shards, lo, hi, seed=3, device="cpu")
            for lo, hi in parts]
    ref = [jprocess_local_batches(jcfg, B, S, M, shards, lo, hi, seed=3) for lo, hi in parts]
    w = B // M // shards
    for _ in range(2):
        got = [next(it) for it in mine]
        for g, r in zip(got, (next(it) for it in ref)):
            for k in g:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
        full = next(whole)
        for k, v in full.items():
            stacked = torch.cat([g[k].reshape(M, -1, w, S) for g in got], dim=1)
            assert torch.equal(stacked.reshape(v.shape), v)


# -- the sharded checkpointer's ownership protocol ------------------------------

def _tree():
    return {"b": np.arange(3, dtype=np.float32),
            "w": np.arange(8, dtype=np.float32).reshape(2, 4)}


def test_non_main_process_writes_only_its_shard(tmp_path):
    path = str(tmp_path / "ckpt")
    save_sharded_checkpoint(path, _tree(), 2, [None, 0], step=3, owned_shards=[1],
                            write_manifest=False)
    assert sorted(os.listdir(path)) == ["arrays-00000003-shard00001-of-00002.npz"]


def test_two_owners_commit_one_checkpoint_that_the_reference_loads(tmp_path):
    """Two 'processes' (threads at a real barrier): each writes only its
    shard, one commits the manifest, and both packages load the tree."""
    path = str(tmp_path / "ckpt")
    bar = threading.Barrier(2, timeout=60)
    errs, names = [], []

    def save(owned, manifest):
        try:
            save_sharded_checkpoint(path, _tree(), 2, [None, 0], step=3, owned_shards=owned,
                                    write_manifest=manifest,
                                    barrier=lambda name: (names.append(name), bar.wait()))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    t = threading.Thread(target=save, args=([1], False))
    t.start()
    save([0], True)
    t.join()
    assert not errs, errs
    for tree, step, _ in (load_checkpoint(path), jload_checkpoint(path)):
        assert step == 3
        for k, v in _tree().items():
            np.testing.assert_array_equal(np.asarray(tree[k]), v)
    assert sorted(set(names)) == ["ckpt-3-g0-commit", "ckpt-3-g0-named", "ckpt-3-g0-shards"]


def test_gc_collects_only_owned_files(tmp_path):
    path = str(tmp_path / "ckpt")
    os.makedirs(path)
    stale_mine = "arrays-00000001-shard00000-of-00002.npz"
    stale_peer = "arrays-00000001-shard00001-of-00002.npz"
    for n in (stale_mine, stale_peer):
        np.savez(os.path.join(path, n), x=np.zeros(1))
    save_sharded_checkpoint(path, _tree(), 2, [None, 0], step=2, owned_shards=[0])
    names = set(os.listdir(path))
    assert stale_mine not in names and stale_peer in names


def test_barriers_run_in_the_reference_order(tmp_path):
    calls = []
    save_sharded_checkpoint(str(tmp_path / "c"), _tree(), 2, [None, 0], step=7,
                            owned_shards=[0, 1], barrier=calls.append)
    assert calls == ["ckpt-7-g0-named", "ckpt-7-g0-shards", "ckpt-7-g0-commit"]


# -- a slab keeps its global stage indices --------------------------------------

def test_a_slab_reads_the_delays_of_its_global_stages():
    """Rank 1 of a 2-process 8-stage run holds stages 4-7: its FIFO hands
    each of them the gradient of tau_k = 7 - k steps ago (3, 2, 1, 0), the
    single-process stages 4-7's slices bit for bit, and its context keeps
    their delays and the whole layout's refresh periods. A slab numbered
    from stage 0 would read rank 0's delays (7, 6, 5, 4) and fails."""
    K, k0 = 8, 4
    ident = Optimizer(lambda p: None,
                      lambda g, s, p, t, aux=None, inplace=False: ({k: v.clone()
                                                                    for k, v in g.items()}, s))
    whole = stage_delayed_optimizer(ident, ["stage"], K)
    slab = stage_delayed_optimizer(ident, ["stage"], K, stage_offset=k0)
    from_zero = stage_delayed_optimizer(ident, ["stage"], K)
    p_whole, p_slab = {"w": torch.zeros(K, 2)}, {"w": torch.zeros(K - k0, 2)}
    sw, ss, sz = whole.init(p_whole), slab.init(p_slab), from_zero.init(p_slab)
    wrong = False
    for t in range(12):
        g = (100.0 * (t + 1) + torch.arange(K, dtype=torch.float32))[:, None].repeat(1, 2)
        uw, sw = whole.update({"w": g}, sw, p_whole, t)
        us, ss = slab.update({"w": g[k0:]}, ss, p_slab, t)
        uz, sz = from_zero.update({"w": g[k0:]}, sz, p_slab, t)
        assert torch.equal(us["w"], uw["w"][k0:]), t
        for j in range(K - k0):
            tau = K - 1 - (k0 + j)
            want = 0.0 if t < tau else 100.0 * (t - tau + 1) + k0 + j
            assert us["w"][j, 0].item() == want
        wrong |= not torch.equal(uz["w"], uw["w"][k0:])
    assert wrong
    full = StageContext(num_stages=K, delays=(tuple(K - 1 - k for k in range(K)), 7, 0),
                        repeats=(2, 1, 1))
    part = full.slab(k0, K)
    assert part.delays[0] == (3, 2, 1, 0) and part.delay_specs() == ["stage", 7, 0]
    freqs = full.refresh_freqs(10)
    assert part.refresh_freqs(10) == [freqs[0][k0:], freqs[1], freqs[2]]


def _rank_local_clip(K, split):
    """``clip_by_global_norm`` as if each of two processes clipped its slab
    (stages [0, split) or [split, K), plus the shared leaves) by its own
    norm; the shared leaves take process 0's scale."""
    def clip(grads, max_norm, inplace=True, norm=None):
        scales = []
        for lo, hi in ((0, split), (split, K)):
            sq = sum(torch.sum(torch.square(g[lo:hi])) if k.startswith("0/")
                     else torch.sum(torch.square(g)) for k, g in grads.items())
            scales.append(torch.clamp(max_norm / torch.clamp(torch.sqrt(sq), min=1e-9), max=1.0))
        for k, g in grads.items():
            if k.startswith("0/"):
                g[:split].mul_(scales[0])
                g[split:].mul_(scales[1])
            else:
                g.mul_(scales[0])
        return grads

    return clip


def test_a_clip_by_rank_local_norms_would_fail(tmp_path, monkeypatch, stage_split_runs):
    """The smoke run's gradients are clipped (norm above 1 at step 0), the
    2-process stage split matches the single-process losses, and a clip by
    each process's own norm moves them past that tolerance."""
    args = train.parse_args((TRAIN_ARGS + " --stages 2").split())
    engine, data, _ = train.build(args)
    state = engine.init_state()
    batch = engine._shape_batch(next(data))
    _, (gs, gsh) = engine.grad_fn(*state.params, batch)
    norms = [torch.sqrt(sum(torch.sum(g * g) for g in {**gs, **gsh}.values()))]
    assert norms[0] > 1.0  # clip_by_global_norm(1.0) scales this step
    single, two = stage_split_runs["fill_drain"]
    assert max(abs(a - b) for a, b in zip(single, two)) <= STAGE_SPLIT_TOL
    monkeypatch.setattr(tspmd, "clip_by_global_norm", _rank_local_clip(2, 1))
    local = train.main((TRAIN_ARGS + " --stages 2 --log-every 0").split())["losses"]
    assert max(abs(a - b) for a, b in zip(single, local)) > 100 * STAGE_SPLIT_TOL


# -- real 2-process runs through spawn ------------------------------------------

@pytest.fixture(scope="module")
def stage_split_runs(tmp_path_factory):
    """schedule -> (single-process losses, 2-process stage-split losses)."""
    out = {}
    for schedule in ("fill_drain", "1f1b"):
        d = tmp_path_factory.mktemp(schedule)
        args = f"{TRAIN_ARGS} --stages 2 --schedule {schedule}"
        single = train.main((args + f" --out {d / 'one.json'}").split())["losses"]
        res = _spawn(["--procs", "2"], f"{args} --out {d / 'two.json'}")
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
        out[schedule] = (single, _losses(d / "two.json"))
    return out


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b"])
def test_stage_split_over_two_processes_gives_the_single_process_losses(
        stage_split_runs, schedule):
    single, two = stage_split_runs[schedule]
    assert len(two) == len(single) == 8
    assert max(abs(a - b) for a, b in zip(single, two)) <= STAGE_SPLIT_TOL, (single, two)


def test_two_process_run_resumes_bitwise_after_losing_a_process(tmp_path, stage_split_runs):
    """Process 1 is killed once the step-4 checkpoint commits; the same
    2-process topology resumes, and the merged series is the uninterrupted
    2-process run's bit for bit. The checkpoint, one file a stage, loads in
    the reference's ``load_checkpoint`` as in the port's."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "res.json"
    run = f"{TRAIN_ARGS} --stages 2 --ckpt-dir {ckpt} --out {out}"
    res = _spawn(["--procs", "2", "--kill-pod-at", "4", "--grace", "8", "--resume-procs", "2",
                  "--resume-with", run], run)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "resumed from" in res.stdout
    m = json.loads(out.read_text())
    assert m["steps_done"] == 8 and m["start_step"] == 0
    assert m["losses"] == stage_split_runs["fill_drain"][1]
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["num_shards"] == 2 and manifest["meta"]["num_processes"] == 2
    mine, step, _ = load_checkpoint(str(ckpt))
    ref, jstep, _ = jload_checkpoint(str(ckpt))
    assert step == jstep == 8
    from repro_torch.checkpoint.ckpt import tree_leaves

    ref_leaves = [np.asarray(x) for x in __import__("jax").tree_util.tree_leaves(ref)]
    assert len(ref_leaves) == len(tree_leaves(mine))
    for a, b in zip(tree_leaves(mine), ref_leaves):
        np.testing.assert_array_equal(a, b)


def test_pods_over_two_processes_resume_elastically_on_one(tmp_path):
    """A (pods=2, stages=2) run over 2 processes loses a process after the
    step-4 checkpoint and resumes as ONE process on (stages=2): the series
    is continuous over all 8 steps and keeps learning (the reference's
    conditions, tests/test_distributed.py:315-320)."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "m.json"
    phase1 = f"{TRAIN_ARGS} --stages 2 --pods 2 --data-par 1 --ckpt-dir {ckpt} --out {out}"
    phase2 = f"{TRAIN_ARGS} --stages 2 --ckpt-dir {ckpt} --out {out}"
    res = _spawn(["--procs", "2", "--kill-pod-at", "4", "--grace", "8", "--resume-procs", "1",
                  "--resume-with", phase2], phase1)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "resumed from" in res.stdout
    m = json.loads(out.read_text())
    assert m["start_step"] == 0 and m["steps_done"] == 8
    losses = m["losses"]
    assert len(losses) == 8 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 1.0, losses
    assert abs(losses[4] - losses[3]) < 0.5, losses


_GATHER = """
import sys, torch
torch.set_num_threads(1)
from repro_torch.configs import OptimizerConfig, get_config
from repro_torch.engine.spmd import SpmdEngine
from repro_torch.launch import distributed
grid = distributed.init_distributed(device=torch.device("cpu"))
cfg = get_config("paper_95m", smoke=True).replace(scan_layers=False, num_layers=4)
engine = SpmdEngine(cfg, OptimizerConfig(name="adam"), num_stages=4, device="cpu")
state = engine.init_state()
assert {tuple(v.shape)[0] for v in state.params[0].values()} == {2}  # its slab of stages
whole = engine.canonical_params(state)
if grid.process_index == 0:
    torch.save(whole, sys.argv[1])
else:
    assert whole is None
distributed.shutdown()
"""


def test_canonical_params_gather_the_slabs_to_the_main_process(tmp_path):
    """Two processes each hold two of four stages; ``canonical_params``
    sends the second's slab to the main process, whose per-layer model is
    the single-process engine's bit for bit."""
    script, out = tmp_path / "gather.py", tmp_path / "whole.pt"
    script.write_text(_GATHER)
    port = spawn.free_port()
    procs = [subprocess.Popen([sys.executable, str(script), str(out)],
                              env=dict(spawn.worker_env(2, i, f"127.0.0.1:{port}"),
                                       OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=SPAWN_TIMEOUT)
        assert p.returncode == 0, err[-3000:]
    cfg = get_config("paper_95m", smoke=True).replace(scan_layers=False, num_layers=4)
    engine = SpmdEngine(cfg, OptimizerConfig(name="adam"), num_stages=4, device="cpu")
    want = engine.canonical_params(engine.init_state())
    got = torch.load(out)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_stages_and_data_replicas_split_over_four_processes(tmp_path):
    """(stages=2, data=4) over 4 processes: each holds one stage and two of
    the four data replicas, so the stacked gradients sum over a group of two
    processes and the shared ones over all four. The losses are the
    single-process run's within 1e-5: the four replicas' mean is summed in
    another order (seen: 4.8e-7 after 4 steps)."""
    args = ("--backend spmd --smoke --arch paper_95m --optimizer adam --batch 16 --seq 32 "
            "--log-every 0 --steps 4 --device cpu --stages 2 --data-par 4 --schedule 1f1b")
    single = train.main(args.split())["losses"]
    res = _spawn(["--procs", "4"], f"{args} --out {tmp_path / 'four.json'}")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    four = _losses(tmp_path / "four.json")
    assert len(four) == 4 and max(abs(a - b) for a, b in zip(single, four)) <= 1e-5, (single, four)
