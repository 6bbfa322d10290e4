"""Measure the f32 entropy residual vs rhstest accumulation mode.

The ES-DG scheme is exactly entropy-conservative (dissipation off) in
exact arithmetic; in f32 the reported residual mixes (a) the genuine
entropy defect of the f32-computed RHS with (b) the diagnostic
reduction's own accumulation roundoff.  This driver separates them:
'compensated' (double-float Dot2, utils.compensated) removes (b)
entirely, so its reading IS (a).  It also times the RHS with the
diagnostic off/native/compensated to bound the knob's cost.

Reference analogue: the rhstest printout of dg3D_euler_hex.jl:214-226
(Float64 throughout, so (b) never mattered there).

    python examples/entropy_residual_study.py
"""

import os
import sys
import time

os.environ.setdefault("JAX_ENABLE_X64", "0")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common  # noqa: F401  (repo path + compile cache)

import jax
import jax.numpy as jnp
import numpy as np

from esdg_cns_tpu.presets import euler_hex_3d
from esdg_cns_tpu.solvers import make_euler_rhs


def make_rhs(disc, **kw):
    return make_euler_rhs(disc, flux_diff_impl="lines", **kw)


def main():
    n = int(os.environ.get("STUDY_N", 3))
    k1d = int(os.environ.get("STUDY_K1D", 16))
    steps = int(os.environ.get("STUDY_STEPS", 20))
    platform = jax.devices()[0].platform

    disc, q0 = euler_hex_3d(n=n, k1d=k1d, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    q = q0 + 0.05 * jnp.asarray(
        rng.standard_normal(q0.shape), jnp.float32
    ) * jnp.asarray([1.0, 0.1, 0.1, 0.1, 1.0])[:, None, None]
    q = jax.device_put(q)
    npts = disc.nq * disc.num_elements
    print(f"platform={platform} N={n} K={disc.num_elements} "
          f"quad points={npts:.3g}")

    # --- residual readings (dissipation off => exact-arithmetic zero) ---
    for mode in ("native", "compensated"):
        rhs = make_rhs(
            disc, dissipation=False, compute_rhstest=True, rhstest_mode=mode
        )
        _, aux = jax.jit(rhs)(q)
        print(f"rhstest[{mode:>11s}] = {float(aux['rhstest']):+.3e}")

    # --- cost of the diagnostic knob on the stepping loop ---
    def timed(tag, rhs):
        @jax.jit
        def run(qin):
            def body(c, _):
                dq, aux = rhs(c)
                return c + jnp.float32(1e-9) * dq, aux.get("rhstest", 0.0)

            qf, rts = jax.lax.scan(body, qin, None, length=steps)
            return qf, rts

        out = run(q)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(q))
            best = min(best, time.perf_counter() - t0)
        print(f"rhs loop [{tag:>11s}]: {best / steps * 1e3:.3f} ms/stage")
        return best

    base = timed("off", make_rhs(
        disc, dissipation=False, compute_rhstest=False))
    for mode in ("native", "compensated"):
        t = timed(mode, make_rhs(
            disc, dissipation=False, compute_rhstest=True,
            rhstest_mode=mode))
        print(f"  overhead vs diagnostic-off: {100 * (t / base - 1):+.1f}%")


if __name__ == "__main__":
    main()
