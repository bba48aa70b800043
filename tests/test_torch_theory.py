"""``core/theory.py``, ``stage_aware.budget`` and ``layout.rotated_fraction``
on the port against the JAX reference, fed the same numpy inputs drawn from
a seed; the Cauchy estimator of ||H||_{1,1} checked statistically against
the exact norm of a matrix whose estimator is consistent."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.catalog import get_config as jget_config
from repro.core import layout as jlayout
from repro.core import stage_aware as jstage_aware
from repro.core import theory as jtheory
from repro.models.model import init_model as jinit_model
from repro_torch.configs import get_config as tget_config
from repro_torch.core import layout as tlayout
from repro_torch.core import stage_aware as tstage_aware
from repro_torch.core import theory as ttheory
from repro_torch.models import Transformer, param_leaves


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("sides", ["none", "U", "V", "UV"])
def test_norm_11_and_rotated_hessian_match_the_reference(sides):
    """H = kron(A, B) (Theorem 3.1's structure) rotated on either side, both
    or neither: the rotated Hessian and its (1,1)-norm."""
    rng = np.random.RandomState(0)
    m, n = 4, 3
    A, B = rng.randn(n, n), rng.randn(m, m)
    H = np.kron(A @ A.T, B @ B.T).astype(np.float32)
    U = np.linalg.qr(rng.randn(m, m))[0].astype(np.float32) if "U" in sides else None
    V = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32) if "V" in sides else None
    as_t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    as_j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    got = ttheory.rotated_hessian(torch.from_numpy(H), as_t(U), as_t(V))
    want = jtheory.rotated_hessian(jnp.asarray(H), as_j(U), as_j(V))
    assert _rel(got.numpy(), want) < 1e-5
    assert abs(float(ttheory.norm_11(got)) - float(jtheory.norm_11(want))) <= \
        1e-5 * float(jtheory.norm_11(want))


def test_effective_delay_and_its_stage_form_match_the_reference():
    rng = np.random.RandomState(1)
    for K in (2, 4, 8):
        c_sq = rng.rand(K).astype(np.float32)
        taus = np.arange(K - 1, -1, -1).astype(np.int32)
        got = float(ttheory.effective_delay(torch.from_numpy(c_sq), torch.from_numpy(taus)))
        want = float(jtheory.effective_delay(jnp.asarray(c_sq), jnp.asarray(taus)))
        assert abs(got - want) <= 1e-6 * max(want, 1.0)
        assert ttheory.stage_effective_delay(list(c_sq), K) == pytest.approx(
            jtheory.stage_effective_delay(list(c_sq), K), rel=1e-6)
    # no smoothness mass: 0, not a division by zero
    assert float(ttheory.effective_delay(torch.zeros(3), torch.ones(3))) == 0.0


def test_estimate_norm_11_is_consistent_on_a_rank_one_hessian():
    """For H = u u^T, v^T H v = (u . v)^2 with u . v ~ Cauchy(0, ||u||_1), so
    the median of |v^T H v| is exactly ||u||_1^2 = ||H||_{1,1}. With 4096
    draws the sample median's relative standard error is ~5%: the estimate
    must lie within 15% (three of them). The same generator seed repeats the
    estimate exactly, and it scales with H."""
    rng = np.random.RandomState(2)
    u = rng.randn(12).astype(np.float32)
    H = torch.from_numpy(np.outer(u, u))
    exact = float(ttheory.norm_11(H))
    assert exact == pytest.approx(float(np.abs(u).sum()) ** 2, rel=1e-5)
    est = float(ttheory.estimate_norm_11(lambda v: H @ v, 12, torch.Generator().manual_seed(0),
                                         4096))
    assert abs(est - exact) < 0.15 * exact, (est, exact)
    again = float(ttheory.estimate_norm_11(lambda v: H @ v, 12,
                                           torch.Generator().manual_seed(0), 4096))
    assert again == est
    scaled = float(ttheory.estimate_norm_11(lambda v: 3.0 * (H @ v), 12,
                                            torch.Generator().manual_seed(0), 4096))
    assert scaled == pytest.approx(3.0 * est, rel=1e-5)
    # the reference's estimator on the same matrix lands in the same band
    ref = float(jtheory.estimate_norm_11(lambda v: jnp.asarray(H.numpy()) @ v, 12,
                                         jax.random.PRNGKey(0), 4096))
    assert abs(ref - exact) < 0.15 * exact, (ref, exact)


def test_estimate_norm_11_takes_the_median_of_an_even_count_as_jnp_does():
    """With an even number of samples the median is the mean of the two
    middle ones (jnp.median), not the lower one (torch.median)."""
    draws = {}

    def hvp(v):
        draws.setdefault("v", []).append(v)
        return v

    est = float(ttheory.estimate_norm_11(hvp, 5, torch.Generator().manual_seed(1), 4))
    samples = np.array([float(torch.dot(v, v)) for v in draws["v"]])
    assert est == pytest.approx(float(np.median(samples)), rel=1e-6)
    assert est == pytest.approx(float(jnp.median(jnp.asarray(samples))), rel=1e-6)


def test_model_hvp_matches_the_reference():
    """Hessian-vector products of a small two-layer loss over flattened
    parameters, forward over reverse on both sides."""
    rng = np.random.RandomState(3)
    w1, w2, x = (rng.randn(*s).astype(np.float32) for s in ((5, 4), (4, 3), (6, 5)))
    v = rng.randn(w1.size + w2.size).astype(np.float32)

    def jloss(p):
        return jnp.sum(jnp.tanh(jnp.tanh(x @ p["w1"]) @ p["w2"]) ** 2)

    def tloss(p):
        return torch.sum(torch.tanh(torch.tanh(torch.from_numpy(x) @ p["w1"]) @ p["w2"]) ** 2)

    def split(flat):
        return {"w1": flat[:w1.size].reshape(w1.shape), "w2": flat[w1.size:].reshape(w2.shape)}

    want = jtheory.model_hvp(jloss, {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
                             lambda t: jnp.concatenate([t["w1"].ravel(), t["w2"].ravel()]),
                             split)(jnp.asarray(v))
    got = ttheory.model_hvp(tloss, {"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2)},
                            lambda t: torch.cat([t["w1"].reshape(-1), t["w2"].reshape(-1)]),
                            split)(torch.from_numpy(v))
    assert _rel(got.numpy(), want) < 1e-5


def test_budget_and_rotated_fraction_match_the_reference():
    """The refresh budget of stage-aware periods (finite ones only) and the
    rotation layout's parameter coverage at paper_95m."""
    freqs = tstage_aware.freqs_for_delays(list(range(7, -1, -1)), 8, 10)
    assert freqs == jstage_aware.freqs_for_delays(list(range(7, -1, -1)), 8, 10)
    for steps in (100, 1000):
        assert tstage_aware.budget(freqs, steps) == jstage_aware.budget(freqs, steps)
        assert tstage_aware.budget(freqs + [tstage_aware.NEVER], steps) == \
            tstage_aware.budget(freqs, steps)
    cj = jget_config("paper_95m").replace(scan_layers=False)
    ct = tget_config("paper_95m").replace(scan_layers=False)
    shapes = jax.eval_shape(lambda k: jinit_model(k, cj), jax.random.PRNGKey(0))
    params = param_leaves(Transformer(ct, device="meta", seed=None))
    got = tlayout.rotated_fraction(params, tlayout.build_layout(params, "bilateral"))
    want = jlayout.rotated_fraction(shapes, jlayout.build_layout(shapes, "bilateral"))
    assert got == want and 0.0 < got < 1.0
