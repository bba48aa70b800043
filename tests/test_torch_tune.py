"""The port's kernel autotuner (``repro_torch.tune``): the reference's cache
contract (``tests/test_tune.py``'s cases: round trip, atomic merge, missing,
corrupt and foreign files, the memo), a cache of the port's own that never
reads or writes the reference's file or schema, the Hopper cost model
(candidates are the launch shapes the kernels take; a geometry over the
card's limits is refused), B5's wrapper reading a cached chunk, and the
CLI. The ``cuda`` tests (skipped without a card) hold B5 bitwise across
every candidate chunk and check that a measured plan feeds the next
launch. The reference is imported inside its tests, so that the file runs
on a card's host, which has no JAX."""
import ast
import json
import pathlib

import pytest
import torch

from repro_torch import tune
from repro_torch.kernels import adam_step
from repro_torch.tune import cache as tcache
from repro_torch.tune import cost_model as cm
from repro_torch.tune.__main__ import main as tune_main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_memo(monkeypatch, tmp_path):
    # the lookup memo is process-global, and no test reads a real home's cache
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    tcache.clear_memo()
    yield
    tcache.clear_memo()


# ---------------------------------------------------------------------------
# cache: round trip, tolerance, atomic merge
# ---------------------------------------------------------------------------


def test_cache_round_trip(tmp_path):
    p = str(tmp_path / "tune.json")
    plan = {"chunk": 4096, "backend": "measured"}
    tcache.save_entries({tcache.make_key("adam_scale", (56623104,), "float32",
                                         "cuda-sm90"): plan}, p)
    assert tcache.lookup("adam_scale", (56623104,), "float32", "cuda-sm90", p) == plan
    # different shape / dtype / platform / kernel: all misses
    assert tcache.lookup("adam_scale", (1024,), "float32", "cuda-sm90", p) is None
    assert tcache.lookup("adam_scale", (56623104,), "bfloat16", "cuda-sm90", p) is None
    assert tcache.lookup("adam_scale", (56623104,), "float32", "cuda-sm80", p) is None
    assert tcache.lookup("matmul", (56623104,), "float32", "cuda-sm90", p) is None


def test_cache_merge_preserves_other_keys(tmp_path):
    p = str(tmp_path / "tune.json")
    k1 = tcache.make_key("adam_scale", (4096,), "float32", "cuda-sm90")
    k2 = tcache.make_key("matmul", (64, 64, 64), "float32", "cuda-sm90")
    tcache.save_entries({k1: {"chunk": 1024}}, p)
    tcache.save_entries({k2: {"block_m": 128}}, p)
    assert set(tcache.load_cache(p)) == {k1, k2}
    # last writer wins per key
    tcache.save_entries({k1: {"chunk": 2048}}, p)
    assert tcache.load_cache(p)[k1] == {"chunk": 2048}
    assert not list(tmp_path.glob("*.tune.tmp"))  # committed by os.replace


def test_cache_missing_and_corrupt_files_are_empty(tmp_path):
    assert tcache.load_cache(str(tmp_path / "nope.json")) == {}
    bad = tmp_path / "bad.json"
    bad.write_text("{truncated")
    assert tcache.load_cache(str(bad)) == {}
    assert tcache.lookup("adam_scale", (4096,), "float32", "cuda-sm90", str(bad)) is None
    # a corrupt file is also recoverable: the next write replaces it
    tcache.save_entries({"adam_scale|8|float32|cpu": {"chunk": 1024}}, str(bad))
    assert tcache.load_cache(str(bad)) == {"adam_scale|8|float32|cpu": {"chunk": 1024}}


def test_cache_foreign_schema_and_junk_entries_ignored(tmp_path):
    p = tmp_path / "old.json"
    p.write_text(json.dumps({"schema": "repro-torch-tune/v0",
                             "entries": {"adam_scale|4096|float32|cpu": {"chunk": 999}}}))
    # stale layout: every key under it is untrusted
    assert tcache.load_cache(str(p)) == {}
    # current schema but junk values: non-dict entries dropped on read
    p.write_text(json.dumps({"schema": tcache.SCHEMA,
                             "entries": {"good|1|float32|cpu": {"chunk": 1024}, "junk": 17}}))
    assert tcache.load_cache(str(p)) == {"good|1|float32|cpu": {"chunk": 1024}}


def test_save_entries_invalidates_memo(tmp_path):
    p = str(tmp_path / "tune.json")
    key = tcache.make_key("adam_scale", (64,), "float32", "cpu")
    assert tcache.lookup("adam_scale", (64,), "float32", "cpu", p) is None
    tcache.save_entries({key: {"chunk": 2048}}, p)
    # without clear_memo inside save_entries this would still be None
    assert tcache.lookup("adam_scale", (64,), "float32", "cpu", p)["chunk"] == 2048


def test_the_reference_cache_is_foreign_and_left_untouched(tmp_path, monkeypatch):
    """The two packages keep apart: other variables, paths and schemas. A
    file the reference wrote reads as empty in the port, and the port's
    writes to its default file leave the reference's default file as it
    was, byte for byte."""
    from repro.tune import cache as jcache

    assert tcache.SCHEMA != jcache.SCHEMA and tcache._ENV_VAR != jcache._ENV_VAR
    assert tcache.cache_path() != jcache.cache_path()
    jkey = jcache.make_key("adam_scale", (1024, 1024), "float32", "tpu")
    ref_file = jcache.save_entries({jkey: {"block_r": 256, "block_c": 512}})
    before = pathlib.Path(ref_file).read_bytes()
    assert tcache.load_cache(ref_file) == {}
    assert tcache.lookup("adam_scale", (1024, 1024), "float32", "tpu", ref_file) is None
    mine = tcache.save_entries({tcache.make_key("adam_scale", (4096,), "float32",
                                                "cuda-sm90"): {"chunk": 1024}})
    assert mine != ref_file and pathlib.Path(ref_file).read_bytes() == before
    assert jcache.load_cache() == {jkey: {"block_r": 256, "block_c": 512}}
    # the variables each name their own package's file
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "shared.json"))
    assert tcache.cache_path() == mine
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port.json"))
    assert tcache.cache_path() == str(tmp_path / "port.json")


def test_platform_names_the_card_capability(monkeypatch):
    assert tune.platform_name(torch.device("cpu")) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tune.platform_name() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    assert tune.platform_name() == tune.platform_name(torch.device("cuda", 0)) == "cuda-sm90"


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def test_candidates_are_the_launch_shapes_the_kernels_take():
    from repro.tune.cost_model import candidate_blocks as jcandidate_blocks

    for size in (4, 100, 256, 1000):
        assert cm.candidate_blocks(size) == jcandidate_blocks(size)
    assert cm.adam_chunks() == list(adam_step.CHUNKS) == [1024, 2048, 4096, 8192]
    assert cm._pow2_range(adam_step.CHUNK_MIN, adam_step.CHUNK_MAX) == list(adam_step.CHUNKS)
    assert all(c % (4 * adam_step.THREADS) == 0 for c in adam_step.CHUNKS)
    assert adam_step.chunk_size(10) in adam_step.CHUNKS
    assert adam_step.chunk_size(56_623_104) in adam_step.CHUNKS


@pytest.mark.parametrize("elements", [1, 4096, 1_000_000, 56_623_104, 1_146_617_856])
def test_cost_model_picks_a_chunk_the_kernel_takes(elements):
    plan = cm.best_adam_plan(elements)
    assert plan["chunk"] in adam_step.CHUNKS and plan["backend"] == "cost_model"
    costs = {c: cm.adam_plan_cost(elements, c) for c in adam_step.CHUNKS}
    assert plan["cost_s"] == min(costs.values()) < float("inf")
    assert plan["cost_s"] >= 20.0 * elements / cm.HBM_BW + cm.LAUNCH_S
    # ties go to the larger chunk
    assert plan["chunk"] == max(c for c, v in costs.items() if v == plan["cost_s"])


def test_adam_cost_by_hand():
    """6,912 blocks of 8,192 at paper_95m's launch: B5 holds three blocks on
    an SM (80 registers x 256 threads), so 18 waves of which the last is
    part full."""
    E, per_wave = 56_623_104, 132 * 3
    assert cm.resident_blocks(cm.adam_geometry()) == 3
    waves = (E // 8192) / per_wave
    want = 20.0 * E / cm.HBM_BW * 18 / waves + cm.LAUNCH_S
    assert cm.adam_plan_cost(E, 8192) == pytest.approx(want, rel=1e-12)


def test_every_built_geometry_fits_the_card():
    """B1-B3 at every (head width, dtype) the kernels are built for, B4 and
    B5: shared memory, registers and threads within the card's limits;
    the grids are those ``launched_blocks`` records at the path shapes."""
    for kernel in cm.FLASH_KERNELS:
        for dh in cm.FLASH_HEAD_DIMS:
            for dtype in ("float32", "bfloat16"):
                g = cm.flash_geometry(kernel, dh, dtype)
                assert cm.fits(g) and cm.resident_blocks(g) >= 1, (kernel, dh, dtype, g)
                assert g["smem_bytes"] <= cm.SMEM_PER_BLOCK
    assert cm.fits(cm.matmul_geometry()) and cm.fits(cm.adam_geometry())
    assert cm.matmul_geometry()["smem_bytes"] == 4 * 4 * 2 * 128 * 36  # 4 stages, K-major
    # csrc/flash_fwd_f32.cu and flash_bwd_f32.cu: their constexpr BYTES
    assert cm.flash_geometry("flash_fwd", 128)["smem_bytes"] == 1024 + 65536 + 131072 + 72
    assert cm.flash_geometry("flash_bwd_dkv", 128)["smem_bytes"] == 214592
    grids = {(6, 256, 64, "float32"): (96, 96, 96), (16, 256, 128, "float32"): (128, 128, 128),
             (6, 256, 64, "bfloat16"): (24, 24, 24), (16, 256, 128, "bfloat16"): (64, 64, 64)}
    for (BH, S, dh, dtype), want in grids.items():
        plan = cm.best_flash_plan(S, dh, batch_heads=BH, dtype=dtype)
        assert tuple(plan[k]["blocks"] for k in cm.FLASH_KERNELS) == want


def test_cost_model_refuses_a_geometry_over_the_limits():
    g = cm.matmul_geometry(stages=7)
    assert g["smem_bytes"] > 232_448 and not cm.fits(g)
    assert cm.matmul_plan_cost(384, 384, 384, g) == float("inf")
    fat = {**cm.flash_geometry("flash_fwd", 64), "smem_bytes": 232_449}
    assert cm.flash_kernel_cost("flash_fwd", 256, 64, geom=fat) == float("inf")
    with pytest.raises(ValueError, match="does not fit"):
        cm.best_flash_plan(256, 128, registers={"flash_bwd_dkv": 256})
    with pytest.raises(ValueError, match="does not fit"):
        cm.best_matmul_plan(384, 384, 384, registers=257)
    # 256 threads at 255 registers fit (65,280 of 65,536); 288 threads do not
    assert not cm.fits({"threads": 288, "smem_bytes": 0, "registers": 255})
    # a width outside the built ones is costed at its padded width
    assert cm.best_flash_plan(256, 96)["head_dim"] == 128


# ---------------------------------------------------------------------------
# the consumer: B5's chunk
# ---------------------------------------------------------------------------


def test_planned_chunk_reads_the_cache_and_keeps_its_rule_on_a_miss(tmp_path, monkeypatch):
    """``planned_chunk`` (what a CUDA launch asks) takes a cached chunk for
    its elements and platform, keeps ``chunk_size``'s rule on a miss, and
    raises on a cached chunk the kernel does not take, naming the key and
    the file. The tables then cut the launch at that chunk."""
    p = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(p))
    cpu = torch.device("cpu")
    E = 56_623_104
    assert adam_step.planned_chunk(E, cpu) == adam_step.chunk_size(E) == 8192
    tcache.save_entries({tcache.make_key("adam_scale", (E,), "float32", "cpu"): {"chunk": 2048}})
    assert adam_step.planned_chunk(E, cpu) == 2048
    assert adam_step.planned_chunk(E + 4, cpu) == adam_step.chunk_size(E + 4)
    (_, _, _, start, chunk), = adam_step.launch_tables(
        [(16, 32, 48, 64, 80)], [E], lambda e: adam_step.planned_chunk(e, cpu))
    assert chunk == 2048 and start.tolist() == [0, E // 2048]
    tcache.save_entries({tcache.make_key("adam_scale", (E,), "float32", "cpu"): {"chunk": 3000}})
    with pytest.raises(ValueError, match=r"adam_scale\|56623104\|float32\|cpu.*tune.json"):
        adam_step.planned_chunk(E, cpu)
    tcache.save_entries({tcache.make_key("adam_scale", (E,), "float32", "cpu"): {"rows": 8}})
    with pytest.raises(ValueError, match="chunk None"):
        adam_step.planned_chunk(E, cpu)


def test_tuners_use_the_cost_model_off_the_card(tmp_path):
    p = str(tmp_path / "tune.json")
    assert tune.platform_name() == "cpu"
    plan = tune.tune_adam_scale(1024 * 1024, path=p)
    assert plan["backend"] == "cost_model" and plan["chunk"] in adam_step.CHUNKS
    assert tune.kernel_plan("adam_scale", (1024 * 1024,), path=p) == plan
    leaves = [(384, 384), (384, 1536)]
    assert tune.tune_adam_scale(384 * 384 + 384 * 1536, shapes=leaves, path=p, write=False)
    with pytest.raises(ValueError, match="do not hold"):
        tune.tune_adam_scale(5, shapes=leaves, path=p)
    flash = tune.tune_flash(256, 64, batch_heads=6, path=p)
    assert flash["flash_fwd"]["blocks"] == 96 and tune.kernel_plan("flash", (256, 64), path=p)
    mm = tune.tune_matmul(384, 1536, 384, path=p, write=False)
    assert mm["block_m"] == 128 and tune.kernel_plan("matmul", (384, 1536, 384), path=p) is None
    from repro_torch.tune import measure

    with pytest.raises(RuntimeError, match="CUDA card"):
        measure.best_adam_chunk_measured([(64,)])
    with pytest.raises(RuntimeError, match="CUDA card"):
        measure.measure_matmul_plan(64, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA card"):
        measure.measure_flash_plan(64, 64)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_cost_model_show_and_no_card(tmp_path, capsys):
    """``--cost-model`` tunes the main path's shapes without a card;
    ``--show`` prints what it wrote; with no card and no ``--cost-model``
    the CLI exits naming the missing card and writes nothing."""
    p = str(tmp_path / "tune.json")
    assert tune_main(["--cost-model", "--cache", p]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    kinds = [(x["kernel"], x["dtype"]) for x in lines]
    assert kinds[:4] == [("adam_scale", "float32"), ("flash", "float32"),
                         ("flash", "bfloat16"), ("flash", "float32")]
    assert lines[0]["shape"] == [56_623_104]  # paper_95m's grouped launch
    assert {tuple(x["shape"]) for x in lines if x["kernel"] == "matmul"} >= {(384, 384, 384)}
    assert all(x["plan"]["backend"] == "cost_model" for x in lines)
    assert tune_main(["--show", "--cache", p]) == 0
    shown = capsys.readouterr().out
    assert f"{len(lines)} entries" in shown and "adam_scale|56623104|float32|cpu" in shown
    q = str(tmp_path / "other.json")
    assert tune_main(["--cost-model", "--cache", q, "--adam", "64x32", "--flash", "128x48",
                      "--dtype", "bfloat16", "--matmul", "64x32x16"]) == 0
    assert set(tcache.load_cache(q)) == {"adam_scale|2048|float32|cpu",
                                         "flash|128x48|bfloat16|cpu",
                                         "matmul|64x32x16|float32|cpu"}
    for argv in ([], ["--measure"], ["--adam", "64x32"]):
        with pytest.raises(SystemExit, match="no CUDA card"):
            tune_main(["--cache", str(tmp_path / "none.json"), *argv])
    assert not (tmp_path / "none.json").exists()
    with pytest.raises(SystemExit, match="--matmul wants 3"):
        tune_main(["--cost-model", "--cache", q, "--matmul", "64x32"])


def test_tune_package_imports_no_jax():
    for path in pathlib.Path(tune.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(n.split(".")[0] in ("jax", "repro") for n in names), path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


RAGGED = [(384, 1536), (384, 384), (97, 33), (0, 16), (8, 4, 40, 24), (5,), (1536, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [RAGGED, [(2048, 2048)] * 3])
def test_every_chunk_gives_the_default_chunks_bits_on_card(cuda, shapes):
    from repro_torch.tune.measure import ADAM_SCALARS, _adam_leaves

    gs, ms, vs = _adam_leaves(shapes)
    want = adam_step.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS)
    for chunk in adam_step.CHUNKS:
        before = adam_step.adam_scale.launches
        got = adam_step.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS, chunk=chunk)
        assert adam_step.adam_scale.launches == before + 1
        assert adam_step.adam_scale.chunks == [chunk]
        for x, y in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(x, y)), chunk
    with pytest.raises(ValueError, match="chunk 3072"):
        adam_step.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS, chunk=3072)


@pytest.mark.cuda
def test_measured_plan_feeds_the_next_launch_on_card(cuda, tmp_path, monkeypatch):
    """The measured tuner times every chunk on the card and writes the
    winner; the next launch over those elements reads it."""
    from repro_torch.tune.measure import ADAM_SCALARS, _adam_leaves

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    shapes = [(1024, 1024)] * 4
    plan = tune.tune_adam_scale(4 * 1024 * 1024, shapes=shapes, iters=3, warmup=1)
    assert plan["backend"] == "measured" and plan["bitwise_equal"]
    assert set(plan["candidates_us"]) == {str(c) for c in adam_step.CHUNKS}
    assert plan["us"] == min(plan["candidates_us"].values())
    key = tune.make_key("adam_scale", (4 * 1024 * 1024,), "float32", tune.platform_name())
    assert tcache.load_cache()[key]["chunk"] == plan["chunk"]
    gs, ms, vs = _adam_leaves(shapes, seed=1)
    adam_step.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS)
    assert adam_step.adam_scale.chunks == [plan["chunk"]]
