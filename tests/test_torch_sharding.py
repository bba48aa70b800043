"""The port's sharding rules (``repro_torch.sharding``) against the JAX
reference's (``repro.sharding.rules``, pure functions of paths and shapes).

Every parameter leaf of every catalog config, built at full size on the
``meta`` device (nothing is allocated), gets the reference's spec on both
production meshes, and so does every leaf of basis rotation's optimizer
state in both its variants (the reference's side from a reference-form
tree of ``jax.ShapeDtypeStruct`` built from the port's meta shapes). At
smoke size the port's leaf paths and shapes equal those of the reference's
``jax.eval_shape(init_model)``. The delay rings, the decode caches, the
reference's own rule cases (``tests/test_infra.py``), ``shard_shape`` and
``sharded_bytes`` by hand counts, and a dry-run row's ``sharded`` bytes
against the sum over the reference's specs."""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.catalog import ARCH_IDS as JARCH_IDS
from repro.configs.catalog import get_config as jget_config
from repro.core.layout import path_str as jpath_str
from repro.models import init_model as jinit_model
from repro.sharding import rules as jrules
from repro_torch import sharding
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, OptimizerConfig, get_config
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.launch import dryrun
from repro_torch.models import Transformer, init_cache, param_leaves
from repro_torch.optim.factory import build_optimizer
from repro_torch.sharding.rules import (
    generic_activation_pspec,
    opt_state_pspecs,
    param_pspec,
    params_pspecs,
    rotation_state_pspec,
    shard_shape,
    sharded_bytes,
    tokens_pspec,
)

MESHES = {
    "single_pod": {"data": 16, "model": 16},
    "multi_pod": {"pod": 2, "data": 16, "model": 16},
}
MESH = MESHES["single_pod"]
VARIANTS = (("2nd", "bilateral"), ("1st", "unilateral"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta_params(cfg):
    return param_leaves(Transformer(cfg, device="meta", seed=None))


def _sds(x):
    return jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32)


def _nest(flat):
    """The reference's form of a ``{path: leaf}`` dict: nested dicts, and
    lists where the keys are indices, so that ``jax.tree_util`` flattens it
    in the dict's (tree) order."""
    root = {}
    for path, leaf in flat.items():
        node, parts = root, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[k] for k in sorted(node, key=int)]
        return node

    return fix(root)


def _rotation_state(cfg, params, variant):
    src, geom = variant
    opt = build_optimizer(OptimizerConfig(name="basis_rotation", rotation_source=src,
                                          rotation_geometry=geom, total_steps=10),
                          params, cfg, num_stages=1, apply_delay=False)
    return opt.init(params)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_specs_match_reference(arch, mesh_name):
    """Every parameter leaf of the full config on meta: the port's spec is
    the reference's ``param_pspec``; basis rotation's state (both the
    paper's default and the unilateral first-moment variant) agrees leaf
    for leaf with the reference's ``opt_state_pspecs``, and shards
    something."""
    mesh = MESHES[mesh_name]
    cfg = get_config(arch)
    params = _meta_params(cfg)
    specs = params_pspecs(params, mesh)
    assert list(specs) == list(params)
    for path, x in params.items():
        assert specs[path] == tuple(jrules.param_pspec(path, tuple(x.shape), mesh)), path
    assert any(any(a is not None for a in s) for s in specs.values()), arch
    jparams = _nest({k: _sds(x) for k, x in params.items()})
    for variant in VARIANTS:
        state = _rotation_state(cfg, params, variant)
        got = opt_state_pspecs(state, params, mesh)
        jstate = {"leaves": [{k: _sds(v) for k, v in leaf.items()} for leaf in state["leaves"]]}
        want = jrules.opt_state_pspecs(jstate, jparams, mesh)
        assert len(got["leaves"]) == len(want["leaves"]) == len(params)
        for path, g, w, leaf in zip(params, got["leaves"], want["leaves"], state["leaves"]):
            assert set(g) == set(w) == set(leaf), (variant, path)
            for k in g:
                assert g[k] == tuple(w[k]), (variant, path, k)
                assert len(g[k]) <= leaf[k].ndim
                shard_shape(leaf[k].shape, g[k], mesh)  # every sharded dim divides


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_leaf_paths_and_shapes_match_reference_eval_shape(arch):
    """The paths the rules read: the port's parameters at smoke size, their
    reference paths and shapes in their order, equal the reference's
    ``jax.eval_shape(init_model)`` leaves, stacked superblocks included."""
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda k: jinit_model(k, jcfg), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = [(jpath_str(p), tuple(x.shape)) for p, x in flat]
    assert [(k, tuple(x.shape)) for k, x in _meta_params(cfg).items()] == want


def test_param_pspec_rules():
    """``tests/test_infra.py``'s cases of the reference, on the port."""
    assert param_pspec("embed/embedding", (64000, 7168), MESH) == ("model", "data")
    assert param_pspec("lm_head", (7168, 64000), MESH) == ("data", "model")
    assert param_pspec("blocks/0/mixer/w_q", (60, 7168, 7168), MESH) == (None, "data", "model")
    assert param_pspec("blocks/0/mixer/w_o", (7168, 7168), MESH) == ("model", "data")
    # expert parallel when experts divide the axis
    assert param_pspec("blocks/0/mlp/w_gate_e", (160, 5120, 1536), MESH) == ("model", "data",
                                                                              None)
    # hidden-dim fallback when they don't (mixtral: 8 experts, 16-way axis)
    assert param_pspec("blocks/0/mlp/w_gate_e", (8, 6144, 16384), MESH) == (None, "data",
                                                                             "model")
    assert param_pspec("blocks/0/mlp/w_down_e", (8, 16384, 6144), MESH) == (None, "model",
                                                                             "data")
    # non-divisible dims degrade to None, norms replicated
    assert param_pspec("blocks/0/mixer/w_q", (100, 50), MESH) == (None, None)
    assert param_pspec("blocks/0/norm1/scale", (7168,), MESH) == (None,)


def test_opt_state_pspecs_structure():
    """Every state leaf of a small config gets a spec of at most its rank
    (``tests/test_infra.py``'s case), in the state's own structure."""
    cfg = ModelConfig(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
                      attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
                      pattern=(BlockSpec("attn", "dense"),))
    params = _meta_params(cfg)
    opt = build_optimizer(OptimizerConfig(name="basis_rotation", total_steps=10), params, cfg,
                          num_stages=1, apply_delay=False)
    state = opt.init(params)
    specs = opt_state_pspecs(state, params, MESH)
    assert len(specs["leaves"]) == len(state["leaves"]) == len(params)
    for leaf, spec in zip(state["leaves"], specs["leaves"]):
        assert set(spec) == set(leaf)
        for k, x in leaf.items():
            assert isinstance(spec[k], tuple) and len(spec[k]) <= x.ndim
    assert rotation_state_pspec("step", ("data", "model"), (64, 64), MESH) == ()


def test_token_and_activation_specs():
    assert tokens_pspec(256, MESH) == ("data", None)  # P(("data",), None)'s tuple
    assert tokens_pspec(7, MESH) == (None, None)  # indivisible
    ms3 = MESHES["multi_pod"]
    assert tokens_pspec(256, ms3) == (("pod", "data"), None)
    for batch in (256, 7, 32):
        for mesh in MESHES.values():
            for extra in (1, 2):
                assert tokens_pspec(batch, mesh, extra) == tuple(
                    jrules.tokens_pspec(batch, mesh, extra))
    spec = generic_activation_pspec((128, 8, 32768, 128), MESH, batch_dim=0)
    assert spec[0] == "data" and "model" in spec
    for shape, bd in (((128, 8, 32768, 128), 0), ((24, 256, 8, 4096, 64), 1), ((7, 3), 0)):
        for mesh in MESHES.values():
            assert generic_activation_pspec(shape, mesh, bd) == tuple(
                jrules.generic_activation_pspec(shape, mesh, bd))


@pytest.mark.parametrize("store_params", [False, True])
def test_delay_ring_specs_match_reference_queues(store_params):
    """The port's delay rings (one tensor of depth d a leaf, with a head
    beside them) take the reference's queue specs: the parameter's spec
    behind a leading None, None where a leaf has no ring; the head is a
    scalar. The inner Adam's m/v trees follow the parameters."""
    cfg = get_config("qwen3_0_6b", smoke=True).replace(scan_layers=False)
    params = _meta_params(cfg)
    name = "delay_compensation" if store_params else "adam"
    opt = build_optimizer(OptimizerConfig(name=name, total_steps=10), params, cfg,
                          num_stages=4, apply_delay=True)
    state = opt.init(params)
    assert ("param_q" in state) == store_params
    specs = opt_state_pspecs(state, params, MESH)
    jparams = _nest({k: _sds(x) for k, x in params.items()})
    jstate = {k: v for k, v in state.items() if k != "head"}
    jstate = jax.tree.map(lambda x: _sds(x) if isinstance(x, torch.Tensor) else x, jstate,
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    jstate["inner"] = {"m": jparams, "v": jparams}
    want = jrules.opt_state_pspecs(jstate, jparams, MESH)
    assert specs["head"] == ()
    for key in ("grad_q", "param_q") if store_params else ("grad_q",):
        assert len(specs[key]) == len(params)
        assert any(s is None for s in specs[key]) and any(s is not None for s in specs[key])
        assert specs[key] == [None if w is None else tuple(w) for w in want[key]]
    for k in ("m", "v"):
        assert list(specs["inner"][k]) == list(params)
        assert specs["inner"][k] == {p: tuple(jrules.param_pspec(p, tuple(x.shape), MESH))
                                     for p, x in params.items()}


@pytest.mark.parametrize("stacked", [True, False])
def test_cache_specs_match_reference(stacked):
    """A decode cache (GQA, MLA, Mamba and xLSTM states, stacked over the
    superblocks or per layer) gets the reference's specs, in its
    structure."""
    for arch in ("qwen3_0_6b", "jamba_v0_1_52b", "deepseek_v2_236b", "xlstm_1_3b"):
        cfg = get_config(arch, smoke=True).replace(scan_layers=stacked)
        cache = init_cache(cfg, 32, 64, device="meta")
        got = sharding.cache_pspecs(cache, MESH, stacked=stacked)
        want = jrules.cache_pspecs(jax.tree.map(_sds, cache), MESH, stacked=stacked)
        assert isinstance(got, tuple) and len(got) == len(cache)
        for g, w, c in zip(got, want, cache):
            assert set(g) == set(w) == set(c), arch
            assert {k: tuple(v) for k, v in w.items()} == g, arch


def test_shard_shape_and_sharded_bytes_by_hand():
    """One device's block and bytes under a spec, counted by hand."""
    ms3 = MESHES["multi_pod"]
    assert shard_shape((60, 7168, 7168), (None, "data", "model"), MESH) == (60, 448, 448)
    assert shard_shape((256, 4096), (("pod", "data"), None), ms3) == (8, 4096)
    assert shard_shape((7, 3), (), MESH) == (7, 3)
    assert shard_shape((), (), MESH) == ()
    assert shard_shape((32, 64), ("pod", "model"), MESH) == (32, 4)  # no pod axis: 1
    with pytest.raises(ValueError):
        shard_shape((100, 64), ("model", None), MESH)
    with pytest.raises(ValueError):
        shard_shape((64,), (None, None), MESH)
    tree = {"w": torch.empty(64, 32, device="meta"),
            "b": [torch.empty(32, dtype=torch.bfloat16, device="meta"), None],
            "s": torch.empty((), device="meta"), "n": 3}
    specs = {"w": ("model", "data"), "b": [("data",), None], "s": (), "n": ()}
    # w: (4, 2) floats; b: 2 bf16; s: one float; n holds no tensor
    assert sharded_bytes(tree, specs, MESH) == 4 * 8 + 2 * 2 + 4
    assert sharded_bytes(tree, specs, {}) == 4 * 64 * 32 + 2 * 32 + 4


def _ref_bytes(shapes_specs, mesh):
    """Sum over (shape, itemsize, reference spec) of one device's bytes."""
    total = 0
    for shape, size, spec in shapes_specs:
        n = math.prod(shape)
        for axes in spec:
            if axes is not None:
                n //= math.prod(mesh[a] for a in (axes if isinstance(axes, tuple) else (axes,)))
        total += n * size
    return total


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("qwen3_0_6b", "train_4k", False),
    ("mixtral_8x22b", "train_4k", True),
    ("qwen1_5_0_5b", "decode_32k", False),
])
def test_dryrun_sharded_bytes_equal_the_reference_specs(arch, shape_name, multi_pod):
    """A dry-run row's ``sharded`` bytes equal the sum over the reference's
    specs of the same arguments: parameters, basis rotation's state at the
    row's strategy, and the global batch (train) or the decode token and
    cache."""
    row = dryrun.dryrun_one(arch, shape_name, multi_pod, verbose=False, extrapolate=False)
    mesh = row["reference_mesh"]
    assert row["sharded"]["mesh"] == mesh == {**dryrun.grid(multi_pod), "model": 16}
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    params = _meta_params(cfg)
    items = [(tuple(x.shape), x.element_size(), jrules.param_pspec(k, tuple(x.shape), mesh))
             for k, x in params.items()]
    assert row["sharded"]["params_bytes"] == _ref_bytes(items, mesh)
    B = shape.global_batch
    if shape.mode == "train":
        state = _rotation_state(cfg, params, dryrun.rotation_strategy(arch))
        jstate = {"leaves": [{k: _sds(v) for k, v in leaf.items()} for leaf in state["leaves"]]}
        specs = jrules.opt_state_pspecs(jstate, _nest({k: _sds(x) for k, x in params.items()}),
                                        mesh)
        items = [(tuple(v.shape), 4, specs["leaves"][i][k])
                 for i, leaf in enumerate(state["leaves"]) for k, v in leaf.items()]
        assert row["sharded"]["opt_state_bytes"] == _ref_bytes(items, mesh) > 0
        tok = (B, shape.seq_len)
        spec = jrules.tokens_pspec(B, mesh, extra_dims=1)
        assert row["sharded"]["input_bytes"] == _ref_bytes([(tok, 8, spec)] * 2, mesh)
    else:
        cache = init_cache(cfg, B, shape.seq_len, device="meta")
        specs = jrules.cache_pspecs(jax.tree.map(_sds, cache), mesh, stacked=cfg.scan_layers)
        items = [(tuple(x.shape), x.element_size(), specs[i][k])
                 for i, c in enumerate(cache) for k, x in c.items()]
        assert row["sharded"]["opt_state_bytes"] == 0
        assert row["sharded"]["input_bytes"] == _ref_bytes(items, mesh) + 8 * B
    s = row["sharded"]
    assert s["total_bytes"] == s["params_bytes"] + s["opt_state_bytes"] + s["input_bytes"]


def test_dryrun_refuses_model_axis_flags_with_the_runtime_reason():
    """``--grad-rs`` and ``--seq-shard`` exit by name: the rules are ported,
    the tensor-parallel runtime is not."""
    for flag in dryrun.SHARDING_FLAGS:
        with pytest.raises(SystemExit, match="no tensor-parallel runtime") as e:
            dryrun.main(["--arch", "qwen3_0_6b", "--shape", "train_4k", flag])
        assert flag in str(e.value)


def test_sharding_package_imports_no_jax():
    import ast
    import pathlib

    import repro_torch.sharding as pkg

    for path in pathlib.Path(pkg.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(n.split(".")[0] in ("jax", "repro") for n in names), path
    assert JARCH_IDS == ARCH_IDS
