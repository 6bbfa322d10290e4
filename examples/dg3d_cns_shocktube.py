"""3D compressible Navier-Stokes: Becker viscous shocktube extended in
y and z (periodic in y/z, Dirichlet in x) on a collocated hex mesh,
adaptive DOPRI45.

Capability beyond the reference (which stops at 2D CNS); construction
mirrors examples/CompressibleNS/dg2D_CNS_modalESDG.jl with the
dimension-generic K(v) blocks of physics/viscous.py.
"""

from common import env_float, env_int

import jax
import jax.numpy as jnp
import numpy as np

from esdg_cns_tpu.presets import becker_shocktube_3d
from esdg_cns_tpu.solvers import make_cns_rhs
from esdg_cns_tpu.timestepping import dopri45


def main():
    n, k1d = env_int("N", 2), env_int("K1D", 16)
    t_end = env_float("T", 0.1)
    disc, q0, bc, shock = becker_shocktube_3d(n=n, k1d=k1d)
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    cn = (n + 1) * (n + 2) * 3 / 2
    dt0 = 2.0 / (cn * k1d * k1d)
    qf, stats = jax.jit(lambda q: dopri45(rhs, q, t_end, dt0))(q0)

    uq = np.asarray(jnp.einsum("ij,fjk->fik", disc.vq, qf,
                               precision=jax.lax.Precision.HIGHEST))
    u1d = shock.conservative(np.asarray(disc.xq[0]).ravel(), t_end)
    z = 0 * u1d[0]
    uex = np.stack([u1d[0], u1d[1], z, z, u1d[2]]).reshape(uq.shape)
    w = np.asarray(disc.wjq)
    l2 = sum(
        np.sqrt(np.sum(w * (uq[f] - uex[f]) ** 2))
        / max(np.sqrt(np.sum(w * uex[f] ** 2)), 1e-300)
        for f in (0, 1, 4)
    )
    print(f"N={n}, K={disc.num_elements}, T={t_end}: L2 error = {l2:.6e}, "
          f"steps accepted/rejected = {int(stats['n_accepted'])}/"
          f"{int(stats['n_rejected'])}")


if __name__ == "__main__":
    main()
