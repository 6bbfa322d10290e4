"""Whole-trajectory sensitivities: d(functional)/d(Reynolds) by
reverse-mode AD through the time loop.

The reference uses ForwardDiff only for per-step implicit Jacobians
(implicit_euler_2D.jl); differentiating THROUGH a solve is not
expressible there.  Here the full CNS cavity RHS (wall BCs, BR1
viscous terms) under `lax.scan` time stepping is reverse-differentiable
end-to-end; `jax.checkpoint` rematerializes the RHS to bound memory on
long horizons (the gradient is bit-compatible; pinned by
tests/test_cns.py::test_grad_through_solver_re_sensitivity).

    EXAMPLES_CPU=1 EXAMPLES_X64=1 python examples/sensitivity_re.py

Env: N (2), K1D (4), STEPS (20), DT (5e-4), RE (1000).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from common import env_float, env_int

import jax
import jax.numpy as jnp

from esdg_cns_tpu.presets import lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs
from esdg_cns_tpu.timestepping import lsrk45


def main():
    n, k1d = env_int("N", 2), env_int("K1D", 4)
    steps, dt = env_int("STEPS", 20), env_float("DT", 5e-4)
    re0 = env_float("RE", 1000.0)
    disc, q0, bc, p = lid_driven_cavity(n=n, k1d=k1d)

    def kinetic_energy_after(re):
        rhs = jax.checkpoint(make_cns_rhs(
            disc, mu=1.0 / re, pr=p["pr"], re=re, bc=bc,
            inviscid_dissipation=True, viscous_dissipation=True,
            compute_rhstest=False))
        qf, _ = lsrk45(rhs, q0, dt, steps)
        uq = jnp.einsum("ij,fjk->fik", disc.vq, qf,
                        precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(disc.wjq * 0.5 * (uq[1] ** 2 + uq[2] ** 2) / uq[0])

    val, grad = jax.jit(jax.value_and_grad(kinetic_energy_after))(re0)
    f = jax.jit(kinetic_energy_after)
    fd = (float(f(re0 + 1.0)) - float(f(re0 - 1.0))) / 2.0
    print(f"J(Re={re0:g}) = {float(val):.6e}")
    print(f"dJ/dRe  AD = {float(grad):.6e}")
    print(f"dJ/dRe  FD = {fd:.6e}   rel diff = "
          f"{abs(float(grad) - fd) / abs(fd):.2e}")


if __name__ == "__main__":
    main()
