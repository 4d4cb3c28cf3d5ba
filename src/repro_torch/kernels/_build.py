"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled, at first use, into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<stem>-<hash>.so <source>

The libraries go to ``build/repro_torch/`` at the repository root. ``<hash>``
covers the source, the headers beside it and the flags, so a library is
reused until one of them changes. All sources that need a build are compiled
at once, one ``nvcc`` each. A failed build raises with nvcc's output. The
build reads only the sources in the repository; it includes no PyTorch
header.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def sources() -> dict:
    """stem -> path of every CUDA source of the package."""
    return {p.stem: p for p in sorted(_PKG.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _library_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(src.parent.glob("*.cu*")):
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Build every source whose library is missing; returns, per stem,
    ``{"library", "cached", "seconds"}``."""
    report, jobs = {}, []
    for stem, src in sources().items():
        lib = _library_path(src)
        report[stem] = {"library": str(lib), "cached": lib.is_file(),
                        "seconds": 0.0}
        if not lib.is_file():
            jobs.append((stem, src, lib))
    if not jobs:
        return report
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for stem, src, lib in jobs:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((stem, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for stem, lib, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        report[stem]["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build wins or loses whole
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return report


def load(stem: str) -> ctypes.CDLL:
    """The library of source ``stem``, built first if needed."""
    return ctypes.CDLL(build()[stem]["library"])
