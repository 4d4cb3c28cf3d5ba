"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card, checks the
card's chain against the CPU path on a small problem, then runs the main
path at full width: FedChain (FedAvg→SGD and FedAvg→ASG, Algorithm 1) on the
federated quadratic with N = 64 clients and D = 2²², 60 rounds each, counting
the kernels' launches. Every phase prints one JSON line; any failure ends
the run with a non-zero exit. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from repro_torch import device as dev_lib  # noqa: E402
from repro_torch.core import algorithms as A  # noqa: E402
from repro_torch.core import chain  # noqa: E402
from repro_torch.data import spec as spec_lib  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.aggregate import aggregate, ref  # noqa: E402

# H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the tensor
# cores, both at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

PATH_S, PATH_D = 64, 1 << 22  # the main path's clients and width
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
KERNEL_SHAPES = [(PATH_S, PATH_D, torch.float32), (4, 1000, torch.float32),
                 (16, 257, torch.float32), (1, 128, torch.float32),
                 (PATH_S, PATH_D, torch.bfloat16), (8, 1000, torch.bfloat16),
                 (16, 257, torch.bfloat16)]
SOURCE = "src/repro_torch/kernels/aggregate/csrc/aggregate.cu"
REPLACES = {"chain_aggregate": "src/repro/kernels/aggregate/aggregate.py:36",
            "mean_over_clients": "src/repro/kernels/aggregate/aggregate.py:143"}


def emit(**fields):
    print(json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps=20, warmup=3):
    """Median over ``reps`` launches of CUDA-event time, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(nbytes, ops):
    """Least time in ms for the work on this card, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def operands(s, d, dtype, gen, dev):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    w = torch.softmax(torch.randn(s, generator=gen, device=dev), 0)
    return dict(x=rnd(d), g=rnd(s, d), c_i=rnd(s, d), c=rnd(d), w=w)


def check_kernels(dev, smi):
    """Each kernel against its plain version at every shape; times at the
    path shape. Returns the per-kernel records of the final kernels line."""
    gen = dev_lib.generator(dev, 0)
    records = {}
    for s, d, dtype in KERNEL_SHAPES:
        op = operands(s, d, dtype, gen, dev)
        runs = {
            "chain_aggregate": (
                lambda: aggregate.chain_aggregate(
                    op["x"], op["g"], op["c_i"], op["c"], op["w"], lr=0.37),
                lambda: ref.chain_aggregate_ref(
                    op["x"], op["g"], op["c_i"], op["c"], lr=0.37,
                    weights=op["w"]),
                None,
                ((2 * s + 3) * d * op["x"].element_size() + 4 * s,
                 3 * s * d + 2 * d)),
            "mean_over_clients": (
                lambda: aggregate.mean_over_clients(op["g"]),
                lambda: ref.mean_over_clients_ref(op["g"]),
                lambda: op["g"].float().mean(0),
                ((s + 1) * d * op["g"].element_size(), s * d + d)),
        }
        for name, (kernel, plain, library, work) in runs.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            max_abs = float(err.max())
            max_rel = float((err / want.float().abs().clamp_min(1e-30)).max())
            tol = TOL[dtype]
            ok = bool((err <= tol + tol * want.float().abs()).all())
            emit(phase="kernel_check", kernel=name, s=s, d=d,
                 dtype=str(dtype).removeprefix("torch."), max_abs_err=max_abs,
                 max_rel_err=max_rel, rtol=tol, atol=tol, ok=ok)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at S={s}, D={d}, {dtype}")
            if (s, d, dtype) != (PATH_S, PATH_D, torch.float32):
                continue
            bound_ms, bound_by = bound(*work)
            rec = dict(name=name, route="cuda", source=SOURCE,
                       replaces=REPLACES[name], launches=0,
                       max_abs_err=max_abs, ms=median_ms(kernel),
                       plain_ms=median_ms(plain),
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None if library is None
                       else median_ms(library))
            records[name] = rec
            emit(phase="kernel_time", kernel=name, s=s, d=d, dtype="float32",
                 ms=rec["ms"], plain_ms=rec["plain_ms"],
                 library_ms=rec["library_ms"], bound_ms=bound_ms,
                 bound_by=bound_by, share_of_bound=bound_ms / rec["ms"],
                 card=smi)
        del op
    return records


def methods(mu, beta):
    k = 32
    return (A.FedAvg.from_k(k, eta=0.5), A.SGD(eta=0.5, k=k, mu_avg=mu),
            A.NesterovSGD(eta=0.3, mu=mu, beta=beta, k=k))


def check_small_against_cpu(dev):
    """The card's chain against the CPU path (the one the CPU tests hold to
    the JAX package) on the same small problem at σ = σ_F = 0."""
    cuda_p = spec_lib.quadratic_spec(
        dev_lib.generator(dev, 5), num_clients=8, dim=4096, zeta=2.0,
        device=dev)
    cpu_p = spec_lib.make_quadratic(
        {k: v.cpu() for k, v in cuda_p.data.items()},
        **{k: v for k, v in cuda_p.consts.items() if k != "f_star"},
        x0=cuda_p.x0.cpu(), x_star=cuda_p.x_star.cpu())
    fa, sgd, asg = methods(cuda_p.mu, cuda_p.beta)
    for glob in (sgd, asg):
        ch = chain.fedchain(fa, glob, selection_k=32)
        got = ch.run(cuda_p, cuda_p.x0, 20, 1, device=dev)
        want = ch.run(cpu_p, cpu_p.x0, 20, 1, device="cpu")
        x_err = float((got.x_hat.cpu() - want.x_hat).abs().max())
        h_err = float((got.history.cpu() - want.history).abs().max())
        ok = (got.selected_initial == want.selected_initial
              and got.switch_rounds == want.switch_rounds
              and torch.allclose(got.x_hat.cpu(), want.x_hat, rtol=1e-5,
                                 atol=1e-6)
              and torch.allclose(got.history.cpu(), want.history, rtol=1e-5,
                                 atol=1e-6))
        emit(phase="small_chain_vs_cpu", chain=ch.name, n=8, d=4096,
             rounds=20, x_hat_max_abs_err=x_err, history_max_abs_err=h_err,
             selected_initial=got.selected_initial, rtol=1e-5, atol=1e-6,
             ok=ok)
        if not ok:
            raise AssertionError(f"{ch.name}: the card disagrees with the CPU")


def main_path(dev, smi):
    """FedChain at full width; returns the kernels' launch counts."""
    t0 = time.perf_counter()
    p = spec_lib.quadratic_spec(
        dev_lib.generator(dev, 0), num_clients=PATH_S, dim=PATH_D, mu=0.1,
        beta=1.0, zeta=1.0, sigma=0.2, sigma_f=0.05, device=dev)
    torch.cuda.synchronize()
    delta = p.delta(p.x0)
    emit(phase="problem", n=p.num_clients, d=p.dim, delta=delta,
         f_star=p.f_star, kappa=p.kappa(),
         build_s=time.perf_counter() - t0)
    fa, sgd, asg = methods(p.mu, p.beta)
    rounds = 60
    chains = [chain.fedchain(fa, glob, selection_k=32) for glob in (sgd, asg)]
    torch.cuda.reset_peak_memory_stats()
    aggregate.LAUNCHES.clear()
    per_chain = []
    for ch in chains:
        before = dict(aggregate.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ch.run(p, p.x0, rounds, 1, device=dev)
        final = float(p.suboptimality(res.x_hat))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0)
                    for k, v in aggregate.LAUNCHES.items()}
        per_chain.append((ch, launches))
        emit(phase="main_path", chain=ch.name, n=p.num_clients, d=p.dim,
             rounds=rounds, budgets=ch.budgets(rounds), delta=delta,
             final_suboptimality=final,
             history_last=float(res.history[-1]),
             switch_rounds=res.switch_rounds,
             selected_initial=res.selected_initial,
             wall_s=wall, wall_ms_per_round=wall / rounds * 1e3,
             launches=launches, card=smi)
        if not (math.isfinite(final) and final < delta):
            raise AssertionError(f"{ch.name}: final suboptimality {final} "
                                 f"is not finite and below Δ = {delta}")
        if not bool(torch.isfinite(res.history).all()):
            raise AssertionError(f"{ch.name}: non-finite history")
    total = dict(aggregate.LAUNCHES)
    emit(phase="main_path_memory",
         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    # a FedAvg or ASG round averages through mean_over_clients once, an SGD
    # round steps through chain_aggregate once
    need = {"chain_aggregate": 0, "mean_over_clients": 0}
    for ch, launches in per_chain:
        for stage, budget in zip(ch.stages, ch.budgets(rounds)):
            kernel = ("chain_aggregate" if isinstance(stage, A.SGD)
                      else "mean_over_clients")
            need[kernel] += budget
    for kernel, n in need.items():
        if total.get(kernel, 0) < max(n, 1):
            raise AssertionError(f"{kernel} launched {total.get(kernel, 0)} "
                                 f"times on the main path, expected >= {n}")
    return total, p, chains


def profile_rounds(p, chains, dev):
    """Device time by kernel over a 6-round run of each chain at full width
    (3 FedAvg rounds, the selection round, 2 global rounds), and the share
    of the profiled wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ch in chains:
            ch.run(p, p.x0, 6, 2, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    emit(phase="profile", rounds=12, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms,
         top=[dict(kernel=e.key[:90], calls=e.count,
                   ms=e.self_device_time_total / 1e3,
                   share=e.self_device_time_total / 1e3 / busy_ms)
              for e in kernels[:10]])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    report = _build.build()
    emit(phase="build", seconds=time.perf_counter() - t0, sources=report)

    records = check_kernels(dev, smi)
    check_small_against_cpu(dev)
    launches, p, chains = main_path(dev, smi)
    profile_rounds(p, chains, dev)
    del p
    for kernel, rec in records.items():
        rec["launches"] = launches.get(kernel, 0)
    print(json.dumps({"kernels": [records[k] for k in
                                  ("chain_aggregate", "mean_over_clients")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
