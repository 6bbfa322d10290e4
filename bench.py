"""Throughput of the main RHS paths: DOF * RK-stage / s on one GPU.

Configs (BENCH_CONFIG, default all four, in one process):
  euler_hex      — N=3 3D periodic Euler hex, K=32^3, line-sparse flux
                   differencing (reference dg3D_euler_hex.jl).
  euler_hex_n4   — N=4 3D Euler hex at matched DOF (K=24^3).
  cns_cavity     — 2D CNS lid-driven cavity, N=3 tri, K=2*128^2,
                   composed affine operators + dense flux differencing +
                   the compiled roll exchange
                   (reference dg2D_CNS_cavity_optimized.jl).
  cns_cavity_3d  — 3D CNS cavity, N=3 collocated hex, K=16^3, composed
                   affine operators + line-sparse flux differencing.

Each config times BENCH_STEPS fixed-dt LSRK45 steps (5 RHS each) inside
one jit call, BENCH_REPS times after a warm-up call, and reports the
median rate with best and spread.  DOF counts conservative unknowns
(Nf x Np x K).  f32 throughout.  BENCH_N / BENCH_K1D override the size
of a single selected config.

Prints one JSON line naming the JAX device and the card (name and power
limit from nvidia-smi).  Refuses to run without a GPU: a CPU rate is not
a device measurement.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from esdg_cns_tpu.presets import (
    euler_hex_3d,
    lid_driven_cavity,
    lid_driven_cavity_3d,
)
from esdg_cns_tpu.solvers import make_cns_rhs_affine, make_euler_rhs
from esdg_cns_tpu.timestepping import lsrk45
from esdg_cns_tpu.utils.compile_cache import enable_compile_cache
from esdg_cns_tpu.utils.device_info import card_lines, jax_device


def _time_steps(rhs, q0, steps, reps):
    """Per-repeat wall times (s) of `steps` LSRK45 steps in one jit call,
    after one compile + warm-up call; also returns the final state."""
    dt = jnp.asarray(1e-6, q0.dtype)  # timing run; stability not at issue

    @jax.jit
    def run(q):
        return lsrk45(rhs, q, dt, steps)[0]

    q0 = jax.device_put(q0)
    qf = jax.block_until_ready(run(q0))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        qf = jax.block_until_ready(run(q0))
        times.append(time.perf_counter() - t0)
    return times, qf


def _result(metric, times, qf, dof, steps):
    ts = sorted(times)
    mid = len(ts) // 2
    median = ts[mid] if len(ts) % 2 else 0.5 * (ts[mid - 1] + ts[mid])
    stages = 5 * steps
    return {
        "metric": metric,
        "unit": "DOF*stage/s",
        "value": dof * stages / median,
        "best": dof * stages / ts[0],
        "spread_pct": 100.0 * (ts[-1] - ts[0]) / median,
        "reps": len(ts),
        "median_elapsed_s": median,
        "s_per_step": median / steps,
        "dof": dof,
        "steps": steps,
        "finite": bool(jnp.isfinite(qf).all()),
        "dtype": str(qf.dtype),
        "shape": list(qf.shape),
    }


def bench_euler_hex(n=3, k1d=32, steps=240, reps=7):
    """3D periodic Euler hex, line-sparse flux differencing."""
    disc, q0 = euler_hex_3d(n=n, k1d=k1d, dtype=jnp.float32)
    rhs = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                         compute_rhstest=False)
    times, qf = _time_steps(rhs, q0, steps, reps)
    metric = "dof_rk_stage_per_s" if n == 3 else f"dof_rk_stage_per_s_n{n}"
    return _result(metric, times, qf, 5 * disc.np_ * disc.num_elements,
                   steps)


def bench_euler_hex_n4(n=4, k1d=24, steps=240, reps=7):
    """N=4 hex Euler at matched DOF (K=24^3)."""
    return bench_euler_hex(n=n, k1d=k1d, steps=steps, reps=reps)


def bench_cns_cavity(n=3, k1d=128, steps=240, reps=7):
    """2D CNS lid-driven cavity (Re=1000, Ma=0.3, isothermal walls),
    N=3 tri, composed affine operators, dense flux differencing."""
    disc, q0, bc, p = lid_driven_cavity(n=n, k1d=k1d, dtype=jnp.float32)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        flux_diff_impl="xla", compute_rhstest=False,
    )
    times, qf = _time_steps(rhs, q0, steps, reps)
    return _result("cns_dof_rk_stage_per_s", times, qf,
                   4 * disc.np_ * disc.num_elements, steps)


def bench_cns_cavity_3d(n=3, k1d=16, steps=240, reps=7):
    """3D CNS cavity, N=3 collocated hex, composed affine operators,
    line-sparse flux differencing."""
    disc, q0, bc, p = lid_driven_cavity_3d(n=n, k1d=k1d, dtype=jnp.float32)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        flux_diff_impl="lines", compute_rhstest=False,
    )
    times, qf = _time_steps(rhs, q0, steps, reps)
    return _result("cns3d_dof_rk_stage_per_s", times, qf,
                   5 * disc.np_ * disc.num_elements, steps)


RUNNERS = {
    "euler_hex": bench_euler_hex,
    "euler_hex_n4": bench_euler_hex_n4,
    "cns_cavity": bench_cns_cavity,
    "cns_cavity_3d": bench_cns_cavity_3d,
}


def main():
    enable_compile_cache()
    device = jax_device()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {device}")
    config = os.environ.get("BENCH_CONFIG", "all")
    names = list(RUNNERS) if config == "all" else [config]
    kw = {"steps": int(os.environ.get("BENCH_STEPS", 240)),
          "reps": int(os.environ.get("BENCH_REPS", 7))}
    if config != "all":
        for key in ("n", "k1d"):
            if f"BENCH_{key.upper()}" in os.environ:
                kw[key] = int(os.environ[f"BENCH_{key.upper()}"])
    results = {name: RUNNERS[name](**kw) for name in names}
    bad = [name for name, r in results.items() if not r["finite"]]
    print(json.dumps({"device": device, "card": card_lines(),
                      "results": results}))
    if bad:
        sys.exit(f"non-finite state after the timed steps: {bad}")


if __name__ == "__main__":
    main()
