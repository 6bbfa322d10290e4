"""Entropy acceptance: df64 (emulated f64) RHS on the N=3 hex config.

The reference attains machine-zero `rhstest` in native Float64
(dg2D_euler_tri.jl:177-183).  The f32 RHS carries genuine flux-level
roundoff (the diagnostic itself is exonerated by the compensated
study); this driver evaluates the RHS in double-float arithmetic:

    python examples/entropy_residual_df64.py

It prints the f32 residual, the df64 residual, and the measured df64
cost multiple.  Acceptance: |rhstest_df64| <= 1e-10 with dissipation
off.  A backend that breaks the error-free transformations makes the
df64 builder raise; native float64 (JAX_ENABLE_X64=1) is then the
check.
"""

import os
import sys
import time

os.environ.setdefault("JAX_ENABLE_X64", "0")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common  # noqa: F401  (repo path + compile cache)

import jax
import jax.numpy as jnp

from esdg_cns_tpu.presets import euler_hex_3d
from esdg_cns_tpu.solvers.euler_df64 import make_euler_rhs_df64
from esdg_cns_tpu.utils.df64 import verify_eft


def main():
    n = int(os.environ.get("DF64_N", 3))
    k1d = int(os.environ.get("DF64_K1D", 16))   # K=4096: the round-2
    # f32 residual-study config (1.3M quadrature points)
    platform = jax.devices()[0].platform
    print(f"platform: {platform}")

    # EFT exactness on this backend/compiler (raises if FMA contraction
    # or reassociation breaks the double-float arithmetic)
    print(f"verify_eft: {verify_eft():.2e}")

    disc, q0, host = euler_hex_3d(n=n, k1d=k1d, dtype=jnp.float32,
                                  return_host=True)
    npts = disc.nq * disc.num_elements
    print(f"N={n}, K={disc.num_elements} ({npts/1e6:.2f}M quad points)")

    # --- f32 production RHS residual (the number to beat) ---
    from esdg_cns_tpu.solvers import make_euler_rhs

    rhs_f32 = make_euler_rhs(disc, dissipation=False,
                             flux_diff_impl="lines",
                             rhstest_mode="compensated")
    reps = int(os.environ.get("DF64_TIMING_REPS", 20))

    def time_rhs(fn):
        """ms per RHS with `reps` applications amortized inside ONE jit
        (so per-call dispatch latency does not dominate)."""

        @jax.jit
        def loop(q):
            def body(carry, _):
                dq, _aux = fn(carry)
                # chain the state so applications cannot be elided
                return carry + 1e-30 * dq, None

            out, _ = jax.lax.scan(body, q, None, length=reps)
            return out

        loop(q0).block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            loop(q0).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best / reps

    f32_fn = jax.jit(lambda q: rhs_f32(q)[1]["rhstest"])
    rt_f32 = float(f32_fn(q0))
    t_f32 = time_rhs(rhs_f32)
    print(f"f32 rhstest (compensated diag): {rt_f32:+.3e}   "
          f"[{t_f32*1e3:.2f} ms/RHS]")

    # --- df64 RHS residual ---
    rhs_df64 = make_euler_rhs_df64(disc, host, dissipation=False)
    rt_df = float(jax.jit(
        lambda q: rhs_df64(q)[1]["rhstest"])(q0))
    rhs_df64_notest = make_euler_rhs_df64(disc, host, dissipation=False,
                                          compute_rhstest=False)
    t_df = time_rhs(rhs_df64_notest)
    print(f"df64 rhstest:                   {rt_df:+.3e}   "
          f"[{t_df*1e3:.2f} ms/RHS]")
    print(f"cost multiple: {t_df/t_f32:.1f}x")
    ok = abs(rt_df) <= 1e-10
    print(f"acceptance |rhstest| <= 1e-10: {'PASS' if ok else 'FAIL'}")


if __name__ == "__main__":
    main()
