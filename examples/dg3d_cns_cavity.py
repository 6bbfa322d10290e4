"""3D compressible Navier-Stokes lid-driven cavity (Ma=0.3) on a
collocated hex mesh: lid at z=1 moving in +x, adiabatic / isothermal /
slip walls, adaptive DOPRI45 with entropy diagnostics.

Capability beyond the reference (which stops at the 2D cavity,
examples/CompressibleNS/dg2D_CNS_cavity_optimized.jl): the
dimension-generic wall-BC hooks (solvers/boundary.py) and viscous K(v)
blocks (physics/viscous.py) compose the same way in 3D.
"""

import os

from common import env_float, env_int

import jax
import numpy as np

from esdg_cns_tpu.presets import lid_driven_cavity_3d
from esdg_cns_tpu.solvers import make_cns_rhs
from esdg_cns_tpu.timestepping import dopri45


def main():
    n, k1d = env_int("N", 2), env_int("K1D", 8)
    bctype = os.environ.get("BCTYPE", "isothermal")
    re = env_float("RE", 100.0)
    t_end = env_float("T", 0.5)
    disc, q0, bc, p = lid_driven_cavity_3d(n=n, k1d=k1d, bctype=bctype, re=re)
    impl = os.environ.get("IMPL", "generic")  # generic|affine
    kw = dict(mu=p["mu"], pr=p["pr"], re=re, bc=bc,
              inviscid_dissipation=True, viscous_dissipation=True)
    if impl == "generic":
        rhs = make_cns_rhs(disc, **kw)
    else:
        # the production path: composed affine operators + line-sparse
        # flux differencing
        from esdg_cns_tpu.solvers import make_cns_rhs_affine

        rhs = make_cns_rhs_affine(disc, **kw)
    cn = (n + 1) * (n + 2) * 3 / 2
    dt0 = min(0.5 * (2.0 / k1d) / cn, 2.0 / (cn * k1d * k1d))
    qf, stats = jax.jit(
        lambda q: dopri45(rhs, q, t_end, dt0, err_tol=env_float("ERRTOL", 1e-5))
    )(q0)

    vel = np.asarray(qf[1:4] / qf[0])
    print(f"BCTYPE={bctype} N={n} K={disc.num_elements} Re={re} T={t_end}")
    print(f"steps accepted/rejected: {int(stats['n_accepted'])}/"
          f"{int(stats['n_rejected'])}, final dt = {float(stats['dt']):.3e}")
    print(f"rhstest = {float(stats['rhstest']):.6e}, "
          f"rhstest_visc = {float(stats['rhstest_visc']):.6e}")
    print(f"max speed = {np.sqrt((vel**2).sum(0)).max():.4f}")


if __name__ == "__main__":
    main()
