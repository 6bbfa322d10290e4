"""1D compressible Navier-Stokes: Becker viscous shocktube with exact
traveling-wave solution, SSPRK33, relative L1/L2/Linf errors.

Parity workload: reference examples/CompressibleNS/dg1D_CNS_modalESDG.jl.
"""

from common import env_float, env_int

import jax
import jax.numpy as jnp
import numpy as np

from esdg_cns_tpu.presets import becker_shocktube_1d
from esdg_cns_tpu.solvers import make_cns_rhs
from esdg_cns_tpu.timestepping import ssprk33


def main():
    n, k = env_int("N", 4), env_int("K", 128)
    t_end = env_float("T", 0.1)
    disc, q0, bc, shock = becker_shocktube_1d(n=n, k=k)
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    cn = (n + 1) * (n + 2) / 2
    dt = 2.0 / (cn * k * k)
    ns = int(np.ceil(t_end / dt))
    qf, _ = jax.jit(lambda q: ssprk33(rhs, q, t_end / ns, ns))(q0)

    uq = jnp.einsum("ij,fjk->fik", disc.vq, qf,
                    precision=jax.lax.Precision.HIGHEST)
    uex = shock.conservative(np.asarray(disc.xq[0]), t_end)
    w = np.asarray(disc.wjq)
    uq = np.asarray(uq)
    l1 = sum(np.sum(w * np.abs(uq[f] - uex[f])) / np.sum(w * np.abs(uex[f]))
             for f in range(3))
    l2 = sum(np.sqrt(np.sum(w * (uq[f] - uex[f]) ** 2))
             / np.sqrt(np.sum(w * uex[f] ** 2)) for f in range(3))
    linf = sum(np.abs(uq[f] - uex[f]).max() / np.abs(uex[f]).max()
               for f in range(3))
    print(f"N={n}, K={k}, T={t_end}")
    print(f"L1 error is {l1:.6e}")
    print(f"L2 error is {l2:.6e}")
    print(f"Linf error is {linf:.6e}")


if __name__ == "__main__":
    main()
