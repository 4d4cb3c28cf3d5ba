"""The port's round loop and FedChain against the JAX package, at the sizes
of ``examples/quickstart.py`` (N = 8, D = 16, ζ = 2, R = 60, K = 32).

At σ = σ_F = 0 the runs are deterministic up to the order of the client sums,
and are held to ``rtol=1e-5, atol=1e-6`` on ``x_hat`` and ``history``, with
identical stage switches and selection decisions.

The JAX package records its history as a float32 F(x̂) − F*, whose two terms
are about |F*| = 54 here (a float32 ulp of 3.8e-6), so its history carries
rounding of ~1e-5 that no tolerance of 1e-6 can hold. The history reference
is therefore the JAX run's own trajectory (its scan body stepped round by
round, which reproduces its ``x_hat``) evaluated in float64, as the port
evaluates its own. The JAX float32 history is held to that reference within
its cancellation error.

With noise (quickstart's σ = 0.5, σ_F = 0.05) the two frameworks draw
different numbers, so the check is on the mean final suboptimality over 8
seeds, which must lie within a factor of 2 (``BAND``) of the JAX package's
own 8-seed mean. ``python tests/test_torch_chain.py`` prints the measurement
behind that band: the spread of 8-seed means between disjoint seed sets of
each framework.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import algorithms as JA  # noqa: E402
from repro.core import chain as jchain  # noqa: E402
from repro.core import runner as jrunner  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.data import spec as jspec  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import algorithms as TA  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
from repro_torch.core import runner as trunner  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ROUNDS, K = 60, 32
BAND = 2.0


def quickstart(sigma=0.0, sigma_f=0.0):
    p = jspec.quadratic_spec(
        jax.random.PRNGKey(0), num_clients=8, dim=16, mu=0.1, beta=1.0,
        zeta=2.0, sigma=sigma, sigma_f=sigma_f)
    tp = interop.spec_from_numpy(
        jax.tree.map(np.asarray, p.data), jax.tree.map(np.asarray, p.consts),
        np.asarray(p.x0), np.asarray(p.x_star), device="cpu")
    return p, tp


def methods(A, mu):
    return {
        "fedavg": A.FedAvg.from_k(K, eta=0.3),
        "sgd": A.SGD(eta=0.3, k=K, mu_avg=mu),
        "asg": A.NesterovSGD(eta=0.2, mu=mu, beta=1.0, k=K),
    }


def suboptimality64(p, x):
    """F(x) − F* of a JAX spec in float64, as the port computes it."""
    a, b = (np.asarray(p.data[k], np.float64) for k in ("a_bar", "b_bar"))

    def f(v):
        v = np.asarray(v, np.float64)
        return 0.5 * np.sum(a * v * v) - np.sum(b * v)

    return f(x) - f(p.x_star)


def fp32_cancellation(p):
    return 8 * float(np.spacing(np.float32(abs(float(p.consts["f_star"])))))


def jax_run_trajectory(algo, p, rounds, key):
    """``repro.core.runner.run``'s rounds, stepped one at a time: the final
    state and the float64 suboptimality of x̂ after each round."""
    keys = jax.random.split(key, rounds)
    state = algo.init(p, p.x0)
    base_eta = state.eta
    step = jax.jit(lambda spec, st, k: algo.round(spec, st, k))
    history = []
    for r in range(rounds):
        state = step(p, state._replace(eta=base_eta * jnp.float32(1.0)),
                     keys[r])._replace(eta=base_eta)
        history.append(suboptimality64(p, algo.output(state)))
    return state, np.asarray(history)


def jax_chain_trajectory(ch, p, rounds, key):
    """``repro.core.chain.Chain.run``'s scan body stepped one round at a
    time: x̂, the float64 suboptimality of each round's point, and the
    selection flags."""
    sched = ch._schedule(rounds)
    ops = ch._round_ops(p)
    body = jax.jit(ch._plain_scan_body(ops, p, jrunner.f_star_operand(p)))
    keys_r, keys_s = ch._derive_keys(sched, key)
    eta = ch.eta_schedule(rounds)
    states, anchor = ch.init_states(p, p.x0), p.x0
    history, kept = [], []
    for t in range(len(sched.stage_id)):
        xs = (keys_r[t], keys_s[t], jnp.int32(sched.stage_id[t]),
              jnp.int32(sched.kind[t]), jnp.int32(sched.hmode[t]), eta[t])
        (states, anchor), (_, flag) = body((states, anchor), xs)
        point = (anchor if sched.kind[t] == 1
                 else ops.output(int(sched.stage_id[t]), states))
        history.append(suboptimality64(p, point))
        kept.append(bool(flag))
    x_hat = ch.stages[-1].output(states[-1])
    return x_hat, np.asarray(history), [kept[i] for i in sched.sel_indices]


@pytest.mark.parametrize("name", ["fedavg", "sgd", "asg"])
def test_runner_matches_jax(name):
    p, tp = quickstart()
    ja = methods(JA, float(p.mu))[name]
    ta = methods(TA, float(p.mu))[name]
    key = jax.random.PRNGKey(1)
    j_res = jrunner.run(ja, p, p.x0, ROUNDS, key)
    j_state, j_hist = jax_run_trajectory(ja, p, ROUNDS, key)
    # the stepped reference is the JAX run itself
    np.testing.assert_allclose(np.asarray(ja.output(j_state)),
                               np.asarray(j_res.x_hat), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(j_res.history), j_hist, rtol=0,
                               atol=fp32_cancellation(p))

    t_res = trunner.run(ta, tp, tp.x0, ROUNDS, 1, device="cpu")
    assert t_res.history.dtype == torch.float64
    assert t_res.history.shape == (ROUNDS,)
    np.testing.assert_allclose(t_res.x_hat.numpy(), np.asarray(j_res.x_hat),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_res.history.numpy(), j_hist, rtol=RTOL,
                               atol=ATOL)
    assert t_res.state.r == ROUNDS


CHAINS = {
    # the three handoff modes: a costed selection round (anchor), an inline
    # selection, and an unconditional take
    "anchor": dict(),
    "select": dict(selection_costs_round=False),
    "take": dict(select_between_stages=False),
}


@pytest.mark.parametrize("handoff", sorted(CHAINS))
@pytest.mark.parametrize("glob", ["sgd", "asg"])
def test_chain_matches_jax(glob, handoff):
    p, tp = quickstart()
    jm, tm = methods(JA, float(p.mu)), methods(TA, float(p.mu))
    kw = dict(selection_k=K, **CHAINS[handoff])
    jch = jchain.fedchain(jm["fedavg"], jm[glob], **kw)
    tch = tchain.fedchain(tm["fedavg"], tm[glob], **kw)
    key = jax.random.PRNGKey(1)
    j_res = jch.run(p, p.x0, ROUNDS, key)
    j_xhat, j_hist, j_kept = jax_chain_trajectory(jch, p, ROUNDS, key)
    np.testing.assert_allclose(np.asarray(j_xhat), np.asarray(j_res.x_hat),
                               rtol=RTOL, atol=ATOL)
    assert j_kept == j_res.selected_initial
    np.testing.assert_allclose(np.asarray(j_res.history), j_hist, rtol=0,
                               atol=fp32_cancellation(p))

    t_res = tch.run(tp, tp.x0, ROUNDS, 1, device="cpu")
    assert t_res.switch_rounds == j_res.switch_rounds
    assert t_res.selected_initial == j_res.selected_initial
    assert t_res.history.shape == j_res.history.shape
    np.testing.assert_allclose(t_res.x_hat.numpy(), np.asarray(j_res.x_hat),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_res.history.numpy(), j_hist, rtol=RTOL,
                               atol=ATOL)


def test_selection_keeps_the_better_point():
    """A chain whose local stage makes things worse must keep x0."""
    p, tp = quickstart()
    jm, tm = methods(JA, float(p.mu)), methods(TA, float(p.mu))
    bad = dict(eta=-0.05)  # ascent: the local stage moves away from x*
    jch = jchain.fedchain(JA.FedAvg.from_k(K, **bad), jm["sgd"], selection_k=K)
    tch = tchain.fedchain(TA.FedAvg.from_k(K, **bad), tm["sgd"], selection_k=K)
    j_res = jch.run(p, p.x0, 20, jax.random.PRNGKey(1))
    t_res = tch.run(tp, tp.x0, 20, 1, device="cpu")
    assert j_res.selected_initial == t_res.selected_initial == [True]


def _final_subs(p, tp, glob, seeds):
    jm, tm = methods(JA, float(p.mu)), methods(TA, float(p.mu))
    jch = jchain.fedchain(jm["fedavg"], jm[glob], selection_k=K)
    tch = tchain.fedchain(tm["fedavg"], tm[glob], selection_k=K)
    j = [suboptimality64(p, jch.run(p, p.x0, ROUNDS,
                                    jax.random.PRNGKey(s)).x_hat)
         for s in seeds]
    t = [float(tp.suboptimality(tch.run(tp, tp.x0, ROUNDS, s,
                                        device="cpu").x_hat))
         for s in seeds]
    return np.asarray(j), np.asarray(t)


@pytest.mark.parametrize("glob", ["sgd", "asg"])
def test_noisy_chain_mean_within_band_of_jax(glob):
    p, tp = quickstart(sigma=0.5, sigma_f=0.05)
    j, t = _final_subs(p, tp, glob, range(8))
    assert np.all(np.isfinite(t)) and np.all(t > 0)
    ratio = t.mean() / j.mean()
    assert 1 / BAND <= ratio <= BAND, (glob, t.mean(), j.mean())


def test_theory_is_the_jax_package_copy():
    mu, beta = 0.1, 1.0
    c_args = dict(delta=7.0, d=5.0, mu=mu, beta=beta, zeta=1.0, sigma=0.2,
                  n=8, s=8, k=K)
    jc, tc = jtheory.Constants(**c_args), ttheory.Constants(**c_args)
    assert tc.kappa == jc.kappa
    for table in ("TABLE1", "TABLE2", "TABLE4"):
        jt, tt = getattr(jtheory, table), getattr(ttheory, table)
        assert sorted(jt) == sorted(tt)
        for name in jt:
            for r in (1, 10, ROUNDS, 1000):
                assert tt[name](tc, r) == jt[name](jc, r), (table, name, r)
    for fn in ("lower_bound_strongly_convex", "lower_bound_convex",
               "lower_bound_pl"):
        assert getattr(ttheory, fn)(tc, ROUNDS) == getattr(jtheory, fn)(
            jc, ROUNDS)


if __name__ == "__main__":
    # The measurement behind BAND: 8-seed means of the final suboptimality
    # over 8 disjoint seed sets of each framework.
    p, tp = quickstart(sigma=0.5, sigma_f=0.05)
    for glob in ("sgd", "asg"):
        j, t = _final_subs(p, tp, glob, range(64))
        jm, tm8 = j.reshape(8, 8).mean(1), t.reshape(8, 8).mean(1)
        print(f"fedavg->{glob}: jax 8-seed means {np.array2string(jm)}; "
              f"max/min {jm.max() / jm.min():.3f}")
        print(f"fedavg->{glob}: port 8-seed means {np.array2string(tm8)}; "
              f"max/min {tm8.max() / tm8.min():.3f}")
        print(f"fedavg->{glob}: port 8-seed mean / jax 64-seed mean "
              f"{np.array2string(tm8 / j.mean())}; 64-seed ratio "
              f"{t.mean() / j.mean():.3f}")
