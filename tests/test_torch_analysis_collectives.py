"""The port's collective audit (``repro_torch.analysis.collectives``)
against the reference's (``repro.analysis.hlo``): the declared groupings
and the checks' verdicts on the same hand-built groups and pairs
(``tests/test_analysis_hlo.py``), then the audit of real gloo runs, one
rank per device position started through the port's launcher: the
pipeline's exchanges along the stage axis, the data reduction present in a
synchronous step and deferred out of an asynchronous one, with the losses
and the checkpoint of one process, and the donated step's storages."""
import contextlib
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import hlo as jhlo
from repro.launch.topology import Topology as JTopology
from repro_torch.analysis import collectives as tcol
from repro_torch.analysis import runner
from repro_torch.launch.topology import Topology

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


# (stages, data, pods): 1pod, 2pod, 2data, and the reference's production
# grid (data 16, stage 16)
SHAPES = {"1pod": (2, 1, 1), "2pod": (2, 1, 2), "2data": (2, 2, 1), "stage16_data16": (16, 16, 1)}


@pytest.mark.parametrize("label", list(SHAPES))
def test_declared_groupings_equal_the_reference(label):
    stages, data, pods = SHAPES[label]
    got = tcol.declared_groupings(Topology(stages=stages, data=data, pods=pods))
    want = jhlo.declared_groupings(JTopology(stages=stages, data=data, pods=pods))
    assert got == want
    assert len(got) == (7 if pods > 1 else 3)


def _instrs(mod, spec):
    """The same hand-built instruction list in one package's type."""
    out = []
    for kind, groups in spec:
        if kind == "ar":
            out.append(mod.CollectiveInstr(op="all-reduce", out_bytes=128,
                                           replica_groups=groups, line="fixture"))
        else:
            out.append(mod.CollectiveInstr(op="collective-permute", out_bytes=128,
                                           source_target_pairs=groups, line="fixture"))
    return out


# tests/test_analysis_hlo.py:139-190, case by case: (topology, instrs)
AXES_CASES = {
    "declared": ((2, 2, 1), [("ar", ((0, 2), (1, 3))), ("ar", ((0, 1), (2, 3))),
                             ("ar", ((0, 1, 2, 3),)), ("ar", ()),
                             ("ar", ((0,), (1,), (2,), (3,))), ("cp", ((0, 2), (1, 3)))]),
    "diagonal": ((2, 2, 1), [("ar", ((0, 3), (1, 2)))]),
    "data_permute": ((2, 2, 1), [("cp", ((0, 1),))]),
    "cross_pod_permute": ((2, 1, 2), [("cp", ((0, 2),))]),
    "stage_permute_2pod": ((2, 1, 2), [("cp", ((0, 1), (2, 3)))]),
}


@pytest.mark.parametrize("case", list(AXES_CASES))
def test_check_collective_axes_gives_the_reference_verdicts(case):
    (stages, data, pods), spec = AXES_CASES[case]
    got = tcol.check_collective_axes(_instrs(tcol, spec), Topology(stages, data, pods))
    want = jhlo.check_collective_axes(_instrs(jhlo, spec), JTopology(stages, data, pods))
    assert got.passed == want.passed, (got, want)
    assert got.data == want.data
    assert got.passed == (case in ("declared", "stage_permute_2pod"))


DATA_CASES = {
    "sharded_present": ((2, 2, 1), "data", False),
    "sharded_missing": ((2, 2, 1), ((0, 2), (1, 3)), False),
    "solo_absent": ((2, 1, 1), None, False),
    "solo_singletons": ((2, 1, 1), ((0,), (1,)), False),
    "pods_present": ((2, 1, 2), "data_axes", False),
    "pods_absent": ((2, 1, 2), None, False),
    "pods_deferred_absent": ((2, 1, 2), None, True),
    "pods_deferred_present": ((2, 1, 2), "data_axes", True),
}


@pytest.mark.parametrize("case", list(DATA_CASES))
def test_check_data_reduction_gives_the_reference_verdicts(case):
    (stages, data, pods), groups, deferred = DATA_CASES[case]
    verdicts = []
    for mod, topo_cls in ((tcol, Topology), (jhlo, JTopology)):
        topo = topo_cls(stages=stages, data=data, pods=pods)
        g = (topo.replica_groups(("data",)) if groups == "data" else
             topo.replica_groups(topo.data_axes) if groups == "data_axes" else groups)
        instrs = [] if g is None else _instrs(mod, [("ar", g)])
        res = mod.check_data_reduction(instrs, topo, deferred=deferred)
        verdicts.append((res.passed, res.data))
    assert verdicts[0] == verdicts[1]


# ---------------------------------------------------------------------------
# real gloo runs, one rank per device position
# ---------------------------------------------------------------------------

PIPE_CELL = {"schedule": "1f1b", "sync": "async", "optimizer": "basis_rotation",
             "data_async": False}
DATA_CELLS = [{"schedule": "1f1b", "sync": "async", "optimizer": "adam", "data_async": da}
              for da in (False, True)]


@pytest.fixture(scope="module")
def pipeline_ranks():
    """Two ranks, one stage each (1pod: K 2, data 1)."""
    return runner.run_ranks("1pod", [PIPE_CELL], "cpu")


@pytest.fixture(scope="module")
def data_ranks():
    """Two ranks, one data shard each (stages 1, data 2), a synchronous and
    an asynchronous data axis."""
    return runner.run_ranks("1stage2data", DATA_CELLS, "cpu")


def _one_process_losses(topo_label, cell):
    """The same cell's losses with every rank's work in this process."""
    engine = runner._engine(cell["schedule"], cell["optimizer"], topo_label,
                            torch.device("cpu"), async_grads=cell["sync"] == "async",
                            data_async=cell["data_async"])
    state, batch, losses = engine.init_state(), runner._batch(engine.topology, runner._M, "cpu"), []
    for t in range(runner._DATA_DELAY + 2 if cell["data_async"] else 1):
        state, loss, _ = engine.step(state, batch, t)
        losses.append(float(loss))
    return losses


def test_two_rank_pipeline_exchanges_move_along_the_stage_axis(pipeline_ranks):
    topo = Topology(stages=2)
    key = runner.cell_key(PIPE_CELL)
    records = {r: v[key]["records"] for r, v in pipeline_ranks.items()}
    instrs = tcol.instructions(records, topo)
    permutes = [i for i in instrs if i.op == "collective-permute"]
    sums = [i for i in instrs if i.op == "all-reduce"]
    assert permutes and all(i.source_target_pairs for i in permutes)
    res = tcol.check_collective_axes(instrs, topo)
    assert res.passed, res.detail
    # the loss and the shared gradients, each rank's part, summed over the world
    world = ((0, 1),)
    assert sums and all(i.replica_groups == world for i in sums)
    assert sums[0].out_bytes == 4 * (1 + sum(
        p.numel() for p in runner._engine("1f1b", "adam", "1pod", "cpu").init_state()
        .params[1].values()))
    assert tcol.check_data_reduction(instrs, topo).passed  # one data shard: none
    stats = tcol.collective_stats(instrs)
    assert stats.count_by_op == {"collective-permute": len(permutes), "all-reduce": len(sums)}
    for r in pipeline_ranks.values():
        assert tcol.check_donation(r[key]["before"], r[key]["after"]).passed
    assert pipeline_ranks[1][key]["losses"] == _one_process_losses("1pod", PIPE_CELL)


def test_data_reduction_present_in_sync_step_and_deferred_in_async(data_ranks):
    topo = Topology(stages=1, data=2)
    sync, deferred = (runner.collective_checks(data_ranks, "1stage2data", c) for c in DATA_CELLS)
    assert all(r.passed for r in sync), [r.to_json() for r in sync]
    assert all(r.passed for r in deferred), [r.to_json() for r in deferred]
    by = {r.name: r for r in deferred}
    assert by["data_reduction"].data == {"present": False, "required": False,
                                         "deferred": True, "data_axes": ["data"]}
    assert by["async_data_reduction"].data["in_step"] == 0
    assert by["async_data_reduction"].data["in_reduce"] >= 2  # the loss's and the gradients'
    assert {r.name: r for r in sync}["data_reduction"].data["present"]
    # the sync step, recorded whole, has its data sums in the step
    key = runner.cell_key(DATA_CELLS[0])
    step = tcol.instructions({r: v[key]["records"] for r, v in data_ranks.items()}, topo, "step")
    assert tcol.check_data_reduction(step, topo).passed


@pytest.mark.parametrize("cell", DATA_CELLS, ids=["sync_data", "async_data"])
def test_two_rank_data_axis_losses_equal_one_process_bit_for_bit(data_ranks, cell):
    """Each rank's losses equal one process's that runs both replicas: the
    deferred reduction (issued without waiting, waited for D steps later)
    changes no bit, as before it left the step (checked against the tree
    before that change in PR 32, and since by this test)."""
    want = _one_process_losses("1stage2data", cell)
    for r in data_ranks.values():
        assert r[runner.cell_key(cell)]["losses"] == want


@pytest.mark.parametrize("donate", [True, False])
def test_check_donation_on_a_donated_step(donate):
    from repro_torch.engine.spmd import SpmdEngine

    engine = SpmdEngine(runner._tiny_model_cfg(), runner._opt_cfg("basis_rotation"),
                        num_stages=2, num_microbatches=2, schedule="1f1b", device="cpu",
                        donate=donate)
    first = engine.init_state()
    before = tcol.storage_ptrs(first)
    state, _, _ = engine.step(first, runner._batch(engine.topology, 2, "cpu"), 0)
    res = tcol.check_donation(before, tcol.storage_ptrs(state))
    assert res.passed == donate, res.to_json()
    assert res.data["expected"] == len(before) > 0
    if not donate:
        assert any(p.startswith("params/") for p in res.data["missing"])


def test_rank_positions_follow_the_process_slabs():
    assert tcol.rank_positions(Topology(stages=2, data=2), 4) == {0: 0, 1: 1, 2: 2, 3: 3}
    assert tcol.rank_positions(Topology(stages=2, pods=2), 4) == {0: 0, 1: 1, 2: 2, 3: 3}
    with pytest.raises(ValueError, match="one rank per device position"):
        tcol.rank_positions(Topology(stages=2, data=2), 2)
    assert os.path.basename(tcol.__file__) == "collectives.py"


def test_deferred_reduction_checkpoint_matches_one_process(tmp_path):
    """Two ranks of the launcher (stages 1, data 2, D 2) checkpoint at a step
    whose FIFO holds sums in flight: the checkpoint waits for them, and its
    arrays (parameters, optimizer state, the FIFO) and the losses equal one
    process's that runs both replicas, bit for bit."""
    args = ["--backend", "spmd", "--smoke", "--stages", "1", "--data-par", "2", "--data-async",
            "--data-delay", "2", "--steps", "3", "--batch", "4", "--seq", "16",
            "--optimizer", "basis_rotation", "--ckpt-every", "3", "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    runs = {"ranks": [sys.executable, "-m", "repro_torch.launch.spawn", "--procs", "2",
                      "--timeout", "300", "--"],
            "one": [sys.executable, "-m", "repro_torch.launch.train"]}
    got = {}
    for name, cmd in runs.items():
        ck, out = tmp_path / name, tmp_path / f"{name}.json"
        proc = subprocess.run(cmd + args + ["--ckpt-dir", str(ck), "--out", str(out)],
                              capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        (npz,) = glob.glob(str(ck / "**" / "*.npz"), recursive=True)
        got[name] = (json.loads(out.read_text())["losses"], dict(np.load(npz)))
    (la, a), (lb, b) = got["ranks"], got["one"]
    assert la == lb and a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
