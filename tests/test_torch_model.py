"""The port's dense model against the JAX reference: leaf paths and order,
weight conversion, and the loss and every gradient leaf at the smoke config
in float32 from shared weights and the same batch."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.catalog import get_config as jget_config
from repro.core.layout import path_str as jpath_str
from repro.data.synthetic import batches as jbatches
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.models import Transformer, cross_entropy, loss_fn, param_leaves

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only saves time
    def threadpool_limits(**_):
        return contextlib.nullcontext()


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



def _configs(arch="paper_95m", smoke=True, **kw):
    cj = jget_config(arch, smoke).replace(scan_layers=False, **kw)
    ct = tget_config(arch, smoke).replace(scan_layers=False, **kw)
    return cj, ct


@pytest.fixture(scope="module")
def shared_smoke():
    """Reference weights at paper_95m's smoke config, carried into the port."""
    cj, ct = _configs()
    params = jinit_model(jax.random.PRNGKey(0), cj)
    tree = jax.tree.map(np.asarray, params)
    return cj, ct, params, tree, params_from_numpy(tree, ct, "cpu")


@pytest.mark.parametrize("arch,smoke,layers", [("paper_95m", False, None),
                                               ("paper_95m", True, 12)])
def test_leaf_paths_order_and_shapes_match_tree_flatten(arch, smoke, layers):
    """12 layers puts blocks/10 after blocks/9, where a plain string sort of
    the paths would put it after blocks/1."""
    kw = {} if layers is None else {"num_layers": layers}
    cj, ct = _configs(arch, smoke, **kw)
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = [(jpath_str(p), tuple(x.shape)) for p, x in flat]
    port = Transformer(ct, device="meta", seed=None)
    got = [(k, tuple(p.shape)) for k, p in param_leaves(port).items()]
    assert got == want


def test_weights_round_trip_exactly(shared_smoke):
    _, ct, _, tree, model = shared_smoke
    back = params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    again = params_from_numpy(back, ct, "cpu")
    for (k, p), q in zip(param_leaves(model).items(), param_leaves(again).values()):
        assert torch.equal(p, q), k


def test_params_from_numpy_refuses_a_different_tree(shared_smoke):
    _, ct, _, tree, _ = shared_smoke
    bad = dict(tree)
    bad.pop("pos_emb")
    with pytest.raises(ValueError):
        params_from_numpy(bad, ct, "cpu")


def test_loss_and_every_gradient_leaf_match_value_and_grad(shared_smoke):
    cj, _, params, _, model = shared_smoke
    batch = next(jbatches(cj, 2, 32, seed=0))
    (loss_j, _), grads_j = jax.value_and_grad(jloss_fn, has_aux=True)(params, cj, batch)
    bt = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()}
    loss_t, metrics = loss_fn(model, bt)
    leaves = param_leaves(model)
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    # float32 sums taken in another order by XLA and by PyTorch: the
    # measured gap is ~1e-6 of each leaf's largest entry
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    assert metrics["ce"].item() == loss_t.item()
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    assert [jpath_str(p) for p, _ in flat] == list(leaves)
    for (p, gj), gt in zip(flat, grads_t):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-5 * np.abs(gj).max(), err_msg=jpath_str(p))


def test_cross_entropy_ignores_masked_labels():
    from repro.models.model import cross_entropy as jce

    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, size=(2, 5))
    labels[0, :3] = -100
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_unported_model_options_raise():
    """No model option is refused as unported any more: stacked parameters
    (one leaf per pattern position over the superblocks), the chunked
    cross-entropy, MLA attention and the Mamba mixer build; an unknown
    mixer or remat policy is refused as unknown."""
    _, ct = _configs()
    stacked = param_leaves(Transformer(ct.replace(scan_layers=True), device="meta"))
    per_layer = param_leaves(Transformer(ct, device="meta"))
    assert stacked["blocks/0/mixer/w_q"].shape == (ct.num_superblocks,) + tuple(
        per_layer["blocks/0/mixer/w_q"].shape)
    assert sum(p.numel() for p in stacked.values()) == sum(
        p.numel() for p in per_layer.values())
    assert param_leaves(Transformer(ct.replace(loss_chunk=64), device="meta")).keys() == (
        per_layer.keys())
    with pytest.raises(ValueError, match="remat_policy"):
        Transformer(ct.replace(remat_policy="offload"), device="meta")
    from repro_torch.configs.base import BlockSpec, SSMConfig

    mla = dataclasses.replace(ct.attention, kind="mla")
    model = Transformer(ct.replace(attention=mla, scan_layers=False), device="meta")
    assert "blocks/0/mixer/kv_b" in param_leaves(model)
    model = Transformer(ct.replace(pattern=(BlockSpec("mamba", "dense"),), ssm=SSMConfig(),
                                   scan_layers=False), device="meta")
    assert "blocks/0/mixer/A_log" in param_leaves(model)
    with pytest.raises(ValueError, match="unknown block"):
        Transformer(ct.replace(pattern=(BlockSpec("rwkv", "dense"),), scan_layers=False),
                    device="meta")
