"""The port's configs and synthetic data against the JAX reference."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.catalog import get_config as jget_config
from repro.data import synthetic as jdata
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as tget_config
from repro_torch.data import synthetic as tdata


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs these files beside others in parallel workers; torch's
    intra-op threads then fight the other workers for the cores, and these
    small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _shared_fields(a, b):
    names = {f.name for f in dataclasses.fields(a)} & {f.name for f in dataclasses.fields(b)}
    return {n: (getattr(a, n), getattr(b, n)) for n in sorted(names)}


def _assert_same(ref, port, where):
    """Every field the port kept equals the reference's, recursively."""
    for name, (r, p) in _shared_fields(ref, port).items():
        if name == "attention":
            _assert_same(r, p, f"{where}.attention")
        elif name == "pattern":
            assert [(s.mixer, s.mlp) for s in r] == [(s.mixer, s.mlp) for s in p], where
        else:
            assert r == p, (where, name, r, p)


@pytest.mark.parametrize("cls", ["OptimizerConfig", "AttentionConfig", "BlockSpec", "ModelConfig"])
def test_config_defaults_match_reference(cls):
    ref, port = getattr(jbase, cls)(), getattr(tbase, cls)()
    if cls == "OptimizerConfig":  # ported whole
        assert {f.name for f in dataclasses.fields(ref)} == {f.name for f in dataclasses.fields(port)}
    _assert_same(ref, port, cls)


@pytest.mark.parametrize("arch", ["paper_95m", "paper_1b", "paper_3b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_paper_configs_match_reference(arch, smoke):
    ref, port = jget_config(arch, smoke), tget_config(arch, smoke)
    _assert_same(ref, port, arch)
    assert port.compute_dtype == torch.float32 and port.params_dtype == torch.float32


def test_unported_architecture_raises():
    for arch in ("mixtral_8x22b", "deepseek_v2_236b", "jamba_v0_1_52b", "llava_next_34b",
                 "musicgen_large"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tget_config(arch)


@pytest.mark.parametrize("vocab,seed", [(2048, 0), (50304, 3)])
def test_synthetic_stream_is_bit_identical(vocab, seed):
    ref, port = jdata.SyntheticLM(vocab, seed), tdata.SyntheticLM(vocab, seed)
    for _ in range(2):
        np.testing.assert_array_equal(ref.sample(3, 16), port.sample(3, 16))


def test_batches_match_reference_as_int64_tensors():
    cfg_j, cfg_t = jget_config("paper_95m", True), tget_config("paper_95m", True)
    it_j = jdata.batches(cfg_j, 4, 24, seed=5)
    it_t = tdata.batches(cfg_t, 4, 24, seed=5, device="cpu")
    for _ in range(3):
        bj, bt = next(it_j), next(it_t)
        assert set(bt) == {"tokens", "labels"}
        for k in ("tokens", "labels"):
            assert bt[k].dtype == torch.int64 and bt[k].device.type == "cpu"
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
