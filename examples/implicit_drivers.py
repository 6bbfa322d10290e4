"""Implicit midpoint + Newton-Krylov drivers for 2D Burgers and Euler,
tracking the entropy per step.

Parity workloads: reference implicit_burgers_2D.jl and
implicit_euler_2D.jl (their sparse ForwardDiff Jacobian + direct solve
is replaced by matrix-free jvp + GMRES, same capability).
"""

import os

from common import env_float, env_int

import jax
import jax.numpy as jnp
import numpy as np

from esdg_cns_tpu.core import build_discretization, ref_tri
from esdg_cns_tpu.mesh import uniform_tri_mesh
from esdg_cns_tpu.physics import entropy_fun, primitive_to_conservative
from esdg_cns_tpu.solvers import make_euler_rhs
from esdg_cns_tpu.solvers.burgers import make_burgers_rhs
from esdg_cns_tpu.timestepping.implicit import implicit_midpoint


def main():
    which = os.environ.get("EQUATION", "burgers")
    n, k1d = env_int("N", 2), env_int("K1D", 4)
    steps = env_int("STEPS", 10)
    dt = env_float("DT", 0.02)

    vx, vy, etov = uniform_tri_mesh(k1d)
    disc = build_discretization(ref_tri(n), (vx, vy), etov, periodic_axes=(0, 1))

    if which == "burgers":
        rhs = make_burgers_rhs(disc, dissipation=False)
        q0 = 0.5 * jnp.sin(jnp.pi * disc.x[0])[None]

        def entropy(q):
            qq = jnp.einsum("ij,fjk->fik", disc.vq, q,
                            precision=jax.lax.Precision.HIGHEST)
            return float(jnp.sum(disc.wjq[None] * qq * qq) / 2)
    else:
        base = make_euler_rhs(disc, dissipation=True, compute_rhstest=False)
        rhs = lambda q, t=0.0: (base(q, t)[0], {})
        rng = np.random.default_rng(0)
        sh = (disc.np_, disc.num_elements)
        q0 = primitive_to_conservative(
            jnp.asarray(2 + 0.1 * rng.random(sh)),
            jnp.asarray(0.2 * rng.standard_normal((2, *sh))),
            jnp.asarray(2 + 0.1 * rng.random(sh)),
        )

        def entropy(q):
            s = entropy_fun(jnp.einsum("ij,fjk->fik", disc.vq, q,
                                       precision=jax.lax.Precision.HIGHEST))
            return float(jnp.sum(disc.wjq * s))

    qf, aux = jax.jit(lambda q: implicit_midpoint(rhs, q, dt, steps))(q0)
    print(f"{which}: N={n} K={disc.num_elements} dt={dt} steps={steps}")
    print(f"newton iters per step: {np.asarray(aux['newton_iters'])}")
    print(f"entropy {entropy(q0):.10f} -> {entropy(qf):.10f}")


if __name__ == "__main__":
    main()
