"""The port's quadratic ``ProblemSpec`` against the JAX package's, on the
same leaves carried across with ``interop.spec_from_numpy``, and the port's
own ``quadratic_spec`` against the construction's invariants."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import spec as jspec  # noqa: E402
from repro_torch import device as dev_lib  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data import spec as tspec  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def fp32_cancellation(p):
    """Absolute error of the JAX package's float32 F(x) − F*: a few ulps of
    |F*|, the size of both terms."""
    return 8 * float(np.spacing(np.float32(abs(float(p.consts["f_star"])))))


def port_spec(p):
    return interop.spec_from_numpy(
        jax.tree.map(np.asarray, p.data), jax.tree.map(np.asarray, p.consts),
        np.asarray(p.x0), np.asarray(p.x_star), device="cpu")


@pytest.fixture(params=[0.0, 0.5], ids=["shared", "spread"])
def specs(request):
    p = jspec.quadratic_spec(
        jax.random.PRNGKey(3), num_clients=8, dim=16, mu=0.1, beta=1.0,
        zeta=2.0, curvature_spread=request.param)
    return p, port_spec(p)


def _points(p, n=3):
    rng = np.random.default_rng(7)
    x_star = np.asarray(p.x_star)
    return [(x_star + rng.standard_normal(x_star.shape)).astype(np.float32)
            for _ in range(n)]


def test_constants_carry_across(specs):
    p, tp = specs
    assert (tp.num_clients, tp.dim) == (p.num_clients, p.dim)
    for k in ("mu", "beta", "zeta", "zeta_f", "sigma", "sigma_f"):
        assert tp.consts[k] == float(p.consts[k])
    # F* is recomputed in float64; the JAX value is its float32 rounding
    np.testing.assert_allclose(tp.f_star, float(p.consts["f_star"]),
                               rtol=RTOL, atol=ATOL)
    assert tp.kappa() == pytest.approx(p.kappa())


def test_deterministic_oracles_match_jax(specs):
    p, tp = specs
    gen = dev_lib.generator(torch.device("cpu"), 0)
    key = jax.random.PRNGKey(0)
    for x in _points(p):
        tx = torch.from_numpy(x)
        for i in range(p.num_clients):
            np.testing.assert_allclose(
                tp.grad_oracle(tx, i, gen).numpy(),
                np.asarray(p.grad_oracle(jnp.asarray(x), i, key)),
                rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(
                float(tp.client_loss(tx, i)),
                float(p.client_loss(jnp.asarray(x), i)), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(
                tp.value_oracle(tx, i, torch.randn(4)).numpy(),
                float(p.value_oracle(jnp.asarray(x), i, key)),
                rtol=RTOL, atol=ATOL)
        # the batched oracle is the per-client one, row by row
        ids = torch.tensor([5, 0, 3])
        np.testing.assert_allclose(
            tp.grad_oracle(tx, ids, gen, 3).numpy(),
            np.stack([tp.grad_oracle(tx, int(i), gen).numpy() for i in ids]),
            rtol=0, atol=0)
        np.testing.assert_allclose(
            float(tp.global_loss(tx)), float(p.global_loss(jnp.asarray(x))),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            float(tp.suboptimality(tx)),
            float(p.suboptimality(jnp.asarray(x))), rtol=RTOL,
            atol=fp32_cancellation(p))
        assert tp.delta(tx) == pytest.approx(p.delta(jnp.asarray(x)),
                                             rel=RTOL,
                                             abs=fp32_cancellation(p))
        assert tp.dist_sq(tx) == pytest.approx(p.dist_sq(jnp.asarray(x)),
                                               rel=RTOL, abs=ATOL)


def test_losses_reduce_in_float64(specs):
    _, tp = specs
    x = tp.x_star.clone()
    assert tp.global_loss(x).dtype == torch.float64
    assert tp.client_loss(x, torch.arange(3)).dtype == torch.float64
    assert float(tp.suboptimality(tp.x_star)) == 0.0


def test_gradient_noise_is_sigma_over_root_d():
    tp = tspec.quadratic_spec(dev_lib.generator(torch.device("cpu"), 1),
                              num_clients=4, dim=4096, sigma=2.0,
                              device="cpu")
    gen = dev_lib.generator(torch.device("cpu"), 2)
    x = tp.x0
    diff = tp.grad_oracle(x, 1, gen, 1) - tp.grad_oracle(x, 1, gen, 1)
    # two independent draws: the difference has variance 2σ²/D per entry
    assert float(diff.std()) == pytest.approx(2.0 * (2.0 / 4096) ** 0.5,
                                               rel=0.05)
    # averaging k draws divides the noise variance by k
    avg = tp.grad_oracle(x, 1, gen, 16) - tp.grad_oracle(x, 1, gen, 16)
    assert float(avg.std()) == pytest.approx(
        2.0 * (2.0 / 4096 / 16) ** 0.5, rel=0.05)


@pytest.mark.parametrize("spread", [0.0, 0.5])
def test_port_quadratic_spec_invariants(spread):
    n, d, zeta, init_scale = 6, 32, 1.5, 5.0
    tp = tspec.quadratic_spec(
        dev_lib.generator(torch.device("cpu"), 11), num_clients=n, dim=d,
        mu=0.1, beta=1.0, zeta=zeta, curvature_spread=spread, device="cpu")
    a_i, a_bar = tp.data["a_i"], tp.data["a_bar"]
    b, b_bar = tp.data["b"], tp.data["b_bar"]
    u = (b - b_bar[None]) / zeta
    assert torch.allclose(u.sum(0), torch.zeros(d), atol=1e-5)
    assert float(torch.linalg.vector_norm(u, dim=1).max()) == pytest.approx(
        1.0, rel=1e-5)
    assert torch.allclose(a_i.mean(0), a_bar, rtol=1e-6)
    eigs = torch.linspace(0.1, 1.0, d)
    if spread == 0:
        assert a_i.stride(0) == 0 and torch.equal(a_i[2], eigs)
    else:
        assert float((a_i / eigs).min()) >= 0.2 - 1e-6
    assert torch.equal(tp.x_star, b_bar / a_bar)
    assert tp.f_star == float(tp.global_loss(tp.x_star))
    assert tp.dist_sq(tp.x0) == pytest.approx(init_scale**2, rel=1e-5)
    # the global objective is the mean of the client objectives (to the
    # float32 rounding of the stored b_i and a_i)
    x = tp.x0
    np.testing.assert_allclose(float(tp.client_loss(x, torch.arange(n)).mean()),
                               float(tp.global_loss(x)), rtol=1e-6)
    if spread == 0:
        # ζ is exact: ∇F_i − ∇F = −ζ·u_i at any x
        gen = dev_lib.generator(torch.device("cpu"), 0)
        g_i = tp.grad_oracle(x, torch.arange(n), gen)
        g = a_bar * x - b_bar
        torch.testing.assert_close(g_i - g, -zeta * u, rtol=1e-4, atol=1e-5)


def test_port_quadratic_spec_is_seeded():
    def build(seed):
        return tspec.quadratic_spec(dev_lib.generator(torch.device("cpu"),
                                                      seed), device="cpu")
    a, b, c = build(4), build(4), build(5)
    assert torch.equal(a.x0, b.x0) and torch.equal(a.data["b"], b.data["b"])
    assert not torch.equal(a.x0, c.x0)
