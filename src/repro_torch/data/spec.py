"""Problem specifications on PyTorch: the strongly convex federated quadratic.

A ``ProblemSpec`` holds a problem as tensors on one device (``data``, the
deterministic start ``x0`` and the optimum ``x_star``) plus the paper's
constants (``consts``: μ, β, ζ, ζ_F, σ, σ_F, F*) as Python floats. This
slice ports the ``quadratic`` family of ``repro.data.spec``:

    F_i(x) = ½·Σ a_i·x² − Σ b_i·x,    F = meanᵢ F_i = ½·Σ ā·x² − Σ b̄·x.

Oracles take a client index or a ``[S]`` index tensor; the batch of clients
is a leading dimension written out, where JAX had ``vmap``. The stochastic
oracles add ``σ/√D·noise`` (gradients) and ``σ_F·noise`` (values)
unconditionally, so σ = 0 runs are deterministic.

Losses are reduced in float64: the operands are cast to float64 and summed
there, and F* is a float64 scalar. At full width (D = 2²²) F* is about
−5·10⁶, where a float32 ulp is 0.5 while the suboptimality a run reports is
orders of magnitude below Δ; a float32 ``F(x) − F*`` would be rounding.
At the CPU tests' sizes this is the JAX package's function to its tolerance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import device as dev_lib
from repro_torch.core import tree_math as tm

CONST_KEYS = ("mu", "beta", "zeta", "zeta_f", "sigma", "sigma_f", "f_star")


def _rows(table, i):
    """Rows ``i`` of a per-client table. A table built with ``expand`` (all
    clients share the row) broadcasts its one row instead of gathering."""
    if table.stride(0) == 0:
        row = table[0]
        return row if isinstance(i, int) else row.expand(len(i), -1)
    return table[i]


def quadratic_loss64(a, b, x):
    """½·Σ a·x² − Σ b·x over the last axis, in float64."""
    x64 = x.double()
    return (0.5 * torch.sum(a.double() * x64 * x64, dim=-1)
            - torch.sum(b.double() * x64, dim=-1))


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A federated quadratic as tensors on one device.

    ``data``: ``a_i`` [N, D] client curvatures (an ``expand`` view when all
    clients share the curvature), ``a_bar`` [D], ``b`` [N, D], ``b_bar`` [D].
    ``consts``: the paper's constants; ``f_star`` is F(x*) in float64.
    """

    num_clients: int
    dim: int
    data: dict
    consts: dict
    x0: torch.Tensor
    x_star: torch.Tensor
    name: str = "quadratic"

    @property
    def device(self) -> torch.device:
        return self.x0.device

    # -- oracle surface ----------------------------------------------------
    def grad_oracle(self, x, i, gen, k: int = 1):
        """The average of ``k`` stochastic gradients of client(s) ``i`` at x
        (``x`` is [D], or one row per client).

        Each query adds its own draw of ``σ/√D·noise``; the k draws are
        summed one at a time, so no [S, k, D] tensor is made.
        """
        d = self.data
        g = _rows(d["a_i"], i) * x - _rows(d["b"], i)
        noise = torch.zeros_like(g)
        buf = torch.empty_like(g)
        for _ in range(k):
            noise += torch.randn(g.shape, generator=gen, out=buf)
        return g + (self.sigma / math.sqrt(self.dim)) * (noise / k)

    def value_oracle(self, x, i, noise):
        """Stochastic values F_i(x) + σ_F·n of client(s) ``i``, one per
        standard-normal draw in ``noise`` (shape ``[*i.shape, K]``): the
        draws are data, so several points can be scored on the same ones."""
        return self.client_loss(x, i).unsqueeze(-1) + self.sigma_f * noise

    def client_loss(self, x, i):
        d = self.data
        return quadratic_loss64(_rows(d["a_i"], i), _rows(d["b"], i), x)

    def global_loss(self, x):
        d = self.data
        return quadratic_loss64(d["a_bar"], d["b_bar"], x)

    # -- constants ---------------------------------------------------------
    @property
    def mu(self):
        return self.consts["mu"]

    @property
    def beta(self):
        return self.consts["beta"]

    @property
    def zeta(self):
        return self.consts["zeta"]

    @property
    def zeta_f(self):
        return self.consts["zeta_f"]

    @property
    def sigma(self):
        return self.consts["sigma"]

    @property
    def sigma_f(self):
        return self.consts["sigma_f"]

    @property
    def f_star(self):
        return self.consts["f_star"]

    def kappa(self):
        mu = self.mu
        return self.beta / mu if mu > 0 else float("inf")

    def suboptimality(self, params):
        """F(x) − F* as a float64 0-d tensor."""
        return self.global_loss(params) - self.f_star

    def delta(self, x0):
        """Initial suboptimality gap Δ (Assumption B.9)."""
        return float(self.suboptimality(x0))

    def dist_sq(self, x0):
        """Initial distance D² (Assumption B.10)."""
        return float(tm.tree_sq_norm(x0 - self.x_star))


def make_quadratic(data, *, mu, beta, zeta, zeta_f, sigma, sigma_f, x0,
                   x_star, name="quadratic") -> ProblemSpec:
    """A quadratic ``ProblemSpec`` from its tensors; F* = F(x*) in float64."""
    f_star = float(quadratic_loss64(data["a_bar"], data["b_bar"], x_star))
    consts = dict(mu=float(mu), beta=float(beta), zeta=float(zeta),
                  zeta_f=float(zeta_f), sigma=float(sigma),
                  sigma_f=float(sigma_f), f_star=f_star)
    n, d = data["b"].shape
    return ProblemSpec(num_clients=int(n), dim=int(d), data=data,
                       consts=consts, x0=x0, x_star=x_star, name=name)


def _spread_directions(gen, num_clients, dim, device):
    """Directions u_i with Σ u_i = 0 and max ||u_i|| = 1."""
    u = torch.randn((num_clients, dim), generator=gen, device=device)
    u = u - torch.mean(u, dim=0, keepdim=True)
    norms = torch.linalg.vector_norm(u, dim=1)
    return u / torch.clamp(torch.max(norms), min=1e-12)


def quadratic_spec(
    generator: Optional[torch.Generator] = None,
    *,
    num_clients: int = 8,
    dim: int = 16,
    mu: float = 0.1,
    beta: float = 1.0,
    zeta: float = 0.0,
    sigma: float = 0.0,
    sigma_f: float = 0.0,
    init_scale: float = 5.0,
    curvature_spread: float = 0.0,
    name: str = "quadratic",
    device=None,
) -> ProblemSpec:
    """Strongly convex federated quadratic with exact ζ (spec.py's
    ``quadratic_spec``): A = diag(eigs evenly in [μ, β]) shared by all
    clients, b_i = b̄ + ζ·u_i with Σu_i = 0 and max||u_i|| = 1, optionally
    spread client curvatures a_i = eigs·clip(1 + s·d_i, 0.2, 2).

    ``generator`` (on ``device``) draws b̄, the u_i, the curvature spread and
    the direction of x0, in that order; ``None`` seeds stream 0.
    """
    dev = dev_lib.resolve(device)
    gen = dev_lib.generator(dev, 0) if generator is None else generator
    if gen.device.type != dev.type:
        raise ValueError(f"generator lives on {gen.device}, the problem "
                         f"on {dev}")
    eigs = torch.linspace(mu, beta, dim, device=dev)
    b_bar = torch.randn((dim,), generator=gen, device=dev)
    u = _spread_directions(gen, num_clients, dim, dev)
    b = b_bar[None, :] + zeta * u
    del u

    if curvature_spread > 0:
        d_i = _spread_directions(gen, num_clients, dim, dev)
        a_i = eigs[None, :] * torch.clamp(1.0 + curvature_spread * d_i,
                                          0.2, 2.0)
        a_bar = torch.mean(a_i, dim=0)
    else:
        a_i = eigs[None, :].expand(num_clients, dim)
        a_bar = eigs

    x_star = b_bar / a_bar
    x0_dir = torch.randn((dim,), generator=gen, device=dev)
    x0 = x_star + init_scale * x0_dir / torch.linalg.vector_norm(x0_dir)

    x_star_norm = float(torch.linalg.vector_norm(x_star))
    zeta_f = zeta * (init_scale + x_star_norm)
    zeta_eff = zeta
    if curvature_spread > 0:
        radius = init_scale + x_star_norm
        spread_norm = float(torch.max(torch.linalg.vector_norm(
            a_i - a_bar[None], dim=1)))
        zeta_eff = zeta + spread_norm * radius

    return make_quadratic(
        dict(a_i=a_i, a_bar=a_bar, b=b, b_bar=b_bar),
        mu=mu, beta=beta, zeta=zeta_eff, zeta_f=zeta_f, sigma=sigma,
        sigma_f=sigma_f, x0=x0, x_star=x_star, name=name)
