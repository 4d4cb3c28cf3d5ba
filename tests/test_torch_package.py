"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``
or ``chip_smoke.py``, and no entry point runs on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import device as dev_lib  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import algorithms as TA  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
from repro_torch.core import runner as trunner  # noqa: E402
from repro_torch.data import spec as tspec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tspec.quadratic_spec()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.spec_from_numpy(
            dict(a_i=np.ones((2, 3)), a_bar=np.ones(3), b=np.ones((2, 3)),
                 b_bar=np.ones(3)),
            dict(mu=0.1, beta=1.0, zeta=0.0, zeta_f=0.0, sigma=0.0,
                 sigma_f=0.0), np.zeros(3), np.ones(3))
    p = tspec.quadratic_spec(device="cpu")
    algo = TA.SGD(k=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trunner.run(algo, p, p.x0, 2, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchain.fedchain(TA.FedAvg(), algo).run(p, p.x0, 4, 0)
    # asked for the CPU, the same calls run
    assert trunner.run(algo, p, p.x0, 2, 0, device="cpu").history.shape == (2,)


def test_run_device_must_be_the_problems():
    p = tspec.quadratic_spec(device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        dev_lib.check_same("meta", p.device)


def test_named_streams_are_reproducible_and_distinct():
    cpu = torch.device("cpu")

    def draw(*tags):
        return torch.randn(8, generator=dev_lib.generator(cpu, *tags))

    assert torch.equal(draw(3, 1, 2), draw(3, 1, 2))
    assert not torch.equal(draw(3, 1, 2), draw(3, 2, 1))
    assert not torch.equal(draw(3, 1), draw(3, 1, 0))


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(SMOKE.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # hides any card from torch
    for cwd, script in ((ROOT, SMOKE), (tmp_path, lone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0, (cwd, res.stdout)
        assert '"ok": true' not in res.stdout
