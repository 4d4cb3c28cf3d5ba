"""Round-by-round parity of the port's algorithms with the JAX package.

N = 8 clients, D = 16, σ = σ_F = 0 and full participation, so a round is
deterministic up to the order of the client sums (the two frameworks draw
different client permutations). Both sides start from the JAX init state,
carried across with ``interop.state_from_numpy``, and run on their own.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import algorithms as JA  # noqa: E402
from repro.data import spec as jspec  # noqa: E402
from repro_torch import device as dev_lib  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import algorithms as TA  # noqa: E402
from repro_torch.core.algorithms import base  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ROUNDS = 25
CPU = torch.device("cpu")


def port_spec(p):
    return interop.spec_from_numpy(
        jax.tree.map(np.asarray, p.data), jax.tree.map(np.asarray, p.consts),
        np.asarray(p.x0), np.asarray(p.x_star), device="cpu")


def _fields(state):
    """The numpy fields of a JAX state that ``state_from_numpy`` takes."""
    out = dict(x=state.x, eta=state.eta, r=state.r)
    if hasattr(state, "tracker"):
        out.update(avg=state.tracker.avg, wprime=state.tracker.wprime)
    if hasattr(state, "v"):
        out["v"] = state.v
    return {k: np.asarray(v) for k, v in out.items()}


METHODS = {
    "sgd": lambda A, mu: A.SGD(eta=0.3, k=8, mu_avg=mu),
    "sgd_last": lambda A, mu: A.SGD(eta=0.3, k=8, mu_avg=mu,
                                    output_mode="last"),
    "fedavg": lambda A, mu: A.FedAvg.from_k(16, eta=0.3),
    "fedavg_server_lr": lambda A, mu: A.FedAvg.from_k(9, eta=0.2,
                                                      server_lr=0.7),
    "asg": lambda A, mu: A.NesterovSGD(eta=0.2, mu=mu, beta=1.0, k=8),
}


@pytest.mark.parametrize("spread", [0.0, 0.5], ids=["shared", "spread"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_round_by_round_parity(method, spread):
    p = jspec.quadratic_spec(
        jax.random.PRNGKey(0), num_clients=8, dim=16, mu=0.1, beta=1.0,
        zeta=2.0, curvature_spread=spread)
    tp = port_spec(p)
    mu = float(p.mu)
    ja, ta = METHODS[method](JA, mu), METHODS[method](TA, mu)
    j_state = ja.init(p, p.x0)
    t_state = interop.state_from_numpy(ta, _fields(j_state), device="cpu")
    j_round = jax.jit(lambda spec, st, k: ja.round(spec, st, k))
    keys = jax.random.split(jax.random.PRNGKey(1), ROUNDS)
    for r in range(ROUNDS):
        j_state = j_round(p, j_state, keys[r])
        t_state = ta.round(tp, t_state, dev_lib.generator(CPU, 1, r))
        want, got = _fields(j_state), t_state
        assert got.r == int(want["r"]) and got.eta == float(want["eta"])
        np.testing.assert_allclose(got.x.numpy(), want["x"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"x, round {r}")
        if "avg" in want:
            np.testing.assert_allclose(
                got.tracker.avg.numpy(), want["avg"], rtol=RTOL, atol=ATOL,
                err_msg=f"tracker avg, round {r}")
            assert got.tracker.wprime == pytest.approx(float(want["wprime"]),
                                                       rel=RTOL)
        if "v" in want:
            np.testing.assert_allclose(got.v.numpy(), want["v"], rtol=RTOL,
                                       atol=ATOL, err_msg=f"v, round {r}")
        np.testing.assert_allclose(ta.output(got).numpy(),
                                   np.asarray(ja.output(j_state)),
                                   rtol=RTOL, atol=ATOL)


def test_state_from_numpy_builds_each_state():
    x = np.arange(4, dtype=np.float32)
    sgd = interop.state_from_numpy(
        TA.SGD(), dict(x=x, eta=0.5, r=3, avg=x + 1, wprime=2.5),
        device="cpu")
    assert sgd.r == 3 and sgd.eta == 0.5 and sgd.tracker.wprime == 2.5
    assert torch.equal(sgd.tracker.avg, torch.from_numpy(x + 1))
    asg = interop.state_from_numpy(TA.NesterovSGD(),
                                   dict(x=x, eta=0.1, r=0, v=-x), device="cpu")
    assert torch.equal(asg.v, torch.from_numpy(-x))
    fa = interop.state_from_numpy(TA.FedAvg(), dict(x=x, eta=0.1, r=0),
                                  device="cpu")
    assert torch.equal(fa.x, torch.from_numpy(x)) and fa._fields == (
        "x", "eta", "r")


@pytest.mark.parametrize("n,s", [(8, 8), (8, 3), (1, 1), (50, 7)])
def test_sample_clients_draws_without_replacement(n, s):
    gen = dev_lib.generator(CPU, 0)
    seen = set()
    for _ in range(20):
        ids = base.sample_clients(gen, n, s)
        assert ids.shape == (s,) and ids.dtype == torch.int64
        assert len(set(ids.tolist())) == s
        assert 0 <= int(ids.min()) and int(ids.max()) < n
        seen.update(ids.tolist())
    assert len(seen) == n or s < n  # every client turns up under S = N


@pytest.mark.parametrize("n,s", [(8, 0), (8, 9), (8, -1), (0, 0)])
def test_sample_clients_rejects_bad_s(n, s):
    with pytest.raises(ValueError, match="without replacement"):
        base.sample_clients(dev_lib.generator(CPU, 0), n, s)


def test_value_k_matches_jax_at_zero_value_noise():
    p = jspec.quadratic_spec(jax.random.PRNGKey(2), num_clients=8, dim=16,
                             zeta=1.0)
    tp = port_spec(p)
    ids = np.array([3, 1, 6], np.int32)
    x = np.array(p.x0)
    want = JA.value_k(p, p.x0, jax.numpy.asarray(ids), jax.random.PRNGKey(0),
                      4)
    got = base.value_k(tp, torch.from_numpy(x), torch.from_numpy(ids).long(),
                       dev_lib.generator(CPU, 0), 4)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(float(want), rel=RTOL)


def test_fused_server_step_folds_eta_into_the_operands():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(32, dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((5, 32), dtype=np.float32))
    ci = torch.from_numpy(rng.standard_normal((5, 32), dtype=np.float32))
    cm = torch.from_numpy(rng.standard_normal(32, dtype=np.float32))
    torch.testing.assert_close(base.fused_server_step(x, g, 0.3),
                               x - 0.3 * g.mean(0))
    torch.testing.assert_close(
        base.fused_server_step(x, g, 0.3, c_i=ci, c_mean=cm),
        x - 0.3 * ((g - ci).mean(0) + cm))


def test_flat_params_only():
    x = torch.zeros(2, 3)
    with pytest.raises(TypeError, match="flat"):
        base.client_mean(x, torch.zeros(4, 2, 3))
    with pytest.raises(TypeError, match="flat"):
        base.fused_server_step(x, torch.zeros(4, 2, 3), 0.1)
    with pytest.raises(TypeError, match="state protocol"):
        base.audit_state(object())
