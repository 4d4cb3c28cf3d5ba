"""The port's aggregation kernels: plain versions against the JAX package's
refs and Pallas kernels (interpret mode) on the CPU, and the CUDA kernels
against the plain versions on the card (marked ``cuda``; skipped without
one).

The JAX side is imported by a fixture, so that the card's tests also run
where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_aggregate.py
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.aggregate import aggregate as tagg  # noqa: E402
from repro_torch.kernels.aggregate import ops as tops  # noqa: E402
from repro_torch.kernels.aggregate import ref as tref  # noqa: E402

# the shapes and tolerances of tests/test_kernels.py
SHAPES = [(1, 128), (4, 1000), (8, 4096), (16, 257)]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(s, d, seed):
    rng = np.random.default_rng(seed)
    x, c = rng.standard_normal((2, d), dtype=np.float32)
    g, ci = rng.standard_normal((2, s, d), dtype=np.float32)
    w = rng.standard_normal(s).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum()
    return x, g, ci, c, w


@pytest.fixture(scope="module")
def jx():
    """The JAX package's aggregation refs and Pallas kernels."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.aggregate import aggregate, ref

    return types.SimpleNamespace(
        agg=aggregate, ref=ref, jnp=jnp,
        array=lambda a, dtype: jnp.asarray(a).astype(jnp.dtype(dtype)))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPE[dtype])


def _np(t):
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,d", SHAPES)
def test_chain_aggregate_ref_matches_jax(jx, s, d, dtype):
    x, g, ci, c, w = _inputs(s, d, s * 1000 + d)
    out = tref.chain_aggregate_ref(*(_torch(a, dtype) for a in (x, g, ci, c)),
                                   lr=0.37, weights=torch.from_numpy(w))
    ops = [jx.array(a, dtype) for a in (x, g, ci, c)]
    ref = jx.ref.chain_aggregate_ref(*ops, lr=0.37, weights=jx.jnp.asarray(w))
    pallas = jx.agg.chain_aggregate(*ops, jx.jnp.asarray(w), lr=0.37,
                                    interpret=True, block_d=256)
    assert out.dtype == TORCH_DTYPE[dtype]
    tol = TOL[dtype]
    for want in (ref, pallas):
        np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 128), (4, 1000), (8, 4096), (16, 257),
                                   (3, 5, 7)])
def test_mean_over_clients_ref_matches_jax(jx, shape, dtype):
    t = np.random.default_rng(sum(shape)).standard_normal(
        shape, dtype=np.float32)
    out = tref.mean_over_clients_ref(_torch(t, dtype))
    ref = jx.ref.mean_over_clients_ref(jx.array(t, dtype))
    pallas = jx.agg.mean_over_clients(jx.array(t, dtype), interpret=True,
                                      block_d=64)
    assert out.dtype == TORCH_DTYPE[dtype] and out.shape == shape[1:]
    tol = TOL[dtype]
    for want in (ref, pallas):
        np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


def test_chain_aggregate_ref_uniform_weights(jx):
    x, g, ci, c, _ = _inputs(4, 300, 0)
    tx = [torch.from_numpy(a) for a in (x, g, ci, c)]
    out = tref.chain_aggregate_ref(*tx, lr=0.1)
    want = jx.ref.chain_aggregate_ref(
        *(jx.jnp.asarray(a) for a in (x, g, ci, c)), lr=0.1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # explicit uniform weights through ops give the ref's default exactly
    uniform = torch.full((4,), 0.25, dtype=torch.float32)
    np.testing.assert_allclose(
        tops.chain_aggregate(*tx, uniform, lr=0.1).numpy(), out.numpy(),
        rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, g, ci, c, w = _inputs(4, 300, 1)
    tx = [torch.from_numpy(a) for a in (x, g, ci, c)]
    before = dict(tagg.LAUNCHES)
    out = tops.chain_aggregate(*tx, torch.from_numpy(w), lr=0.5)
    want = tref.chain_aggregate_ref(*tx, lr=0.5, weights=torch.from_numpy(w))
    assert torch.equal(out, want)
    assert torch.equal(tops.mean_over_clients(tx[1]),
                       tref.mean_over_clients_ref(tx[1]))
    assert dict(tagg.LAUNCHES) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    x, g, ci, c, w = _inputs(2, 64, 2)
    tx = [torch.from_numpy(a) for a in (x, g, ci, c)]
    with pytest.raises(ValueError, match="CUDA"):
        tagg.chain_aggregate(*tx, torch.from_numpy(w), lr=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tagg.mean_over_clients(tx[1])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc refuses' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    assert "aggregate" in _build.sources()
    with pytest.raises(RuntimeError, match="fake nvcc refuses"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


# ---- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,d", SHAPES)
def test_chain_aggregate_kernel_matches_plain_on_card(cuda, s, d, dtype):
    x, g, ci, c, w = _inputs(s, d, s * 1000 + d)
    tx = [_torch(a, dtype, cuda) for a in (x, g, ci, c)]
    tw = torch.from_numpy(w).to(cuda)
    before = tagg.LAUNCHES["chain_aggregate"]
    out = tops.chain_aggregate(*tx, tw, lr=0.37)
    torch.cuda.synchronize()
    assert tagg.LAUNCHES["chain_aggregate"] == before + 1
    want = tref.chain_aggregate_ref(*tx, lr=0.37, weights=tw)
    assert out.dtype == TORCH_DTYPE[dtype]
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 128), (4, 1000), (8, 4096), (16, 257),
                                   (3, 5, 7)])
def test_mean_over_clients_kernel_matches_plain_on_card(cuda, shape, dtype):
    t = np.random.default_rng(sum(shape)).standard_normal(
        shape, dtype=np.float32)
    tt = _torch(t, dtype, cuda)
    before = tagg.LAUNCHES["mean_over_clients"]
    out = tops.mean_over_clients(tt)
    torch.cuda.synchronize()
    assert tagg.LAUNCHES["mean_over_clients"] == before + 1
    assert out.shape == shape[1:]
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(tref.mean_over_clients_ref(tt)),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_operands_on_card(cuda):
    x = torch.zeros(64, device=cuda)
    g = torch.zeros(4, 64, device=cuda)
    w = torch.full((4,), 0.25, device=cuda)
    with pytest.raises(TypeError):
        tagg.chain_aggregate(x.double(), g.double(), g.double(), x.double(),
                             w, lr=1.0)
    with pytest.raises(ValueError):
        tagg.chain_aggregate(x, g.t().contiguous().t(), g, x, w, lr=1.0)
    with pytest.raises(ValueError):
        tagg.chain_aggregate(x, g, g, x, w[:3], lr=1.0)
    with pytest.raises(ValueError):
        tagg.mean_over_clients(g.t())
