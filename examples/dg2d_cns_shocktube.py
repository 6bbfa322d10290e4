"""2D compressible Navier-Stokes: Becker viscous shocktube extended in y
(periodic in y, Dirichlet in x), adaptive DOPRI45.

Parity workload: reference examples/CompressibleNS/dg2D_CNS_modalESDG.jl
(N=2, T=0.2, mu=0.01, M_0=3, inviscid dissipation on).  Errors follow
the reference's composite relative L1/Linf over (rho, rhou, E)
(dg2D_CNS_modalESDG.jl:765-774), evaluated at quadrature points with
wJq weights instead of the reference's J-weighted nodal sums.

Env: N, K1D, T; SWEEP="32,64,128" runs a K1D refinement sweep and,
with OUT=<path>, writes the error table as JSON.
"""

import json
import os

from common import env_float, env_int

import jax
import jax.numpy as jnp
import numpy as np

from esdg_cns_tpu.presets import becker_shocktube_2d
from esdg_cns_tpu.solvers import make_cns_rhs
from esdg_cns_tpu.timestepping import dopri45


def run_one(n, k1d, t_end):
    disc, q0, bc, shock = becker_shocktube_2d(n=n, k1d=k1d)
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    cn = (n + 1) * (n + 2) / 2
    dt0 = 2.0 / (cn * k1d * k1d)
    qf, stats = jax.jit(lambda q: dopri45(rhs, q, t_end, dt0))(q0)
    if bool(stats["stalled"]) or int(stats["n_accepted"]) == 0:
        # the entropy projection loses positivity when the mu-wide
        # Becker profile is under-resolved (log/exp chains on negative
        # projected density/beta -> NaN; same envelope as the
        # reference's exp/log entropy projection).  The adaptive
        # stepper detects the non-finite error estimate and bails.
        raise SystemExit(
            f"stepper stalled at t={float(stats['t']):.3e} "
            f"(accepted {int(stats['n_accepted'])}, rejected "
            f"{int(stats['n_rejected'])}): the shock width mu="
            f"{shock.mu} is under-resolved at K1D={k1d}; raise K1D "
            f"(default 32) or mu")

    uq = np.asarray(jnp.einsum("ij,fjk->fik", disc.vq, qf,
                               precision=jax.lax.Precision.HIGHEST))
    u1d = shock.conservative(np.asarray(disc.xq[0]).ravel(), t_end)
    uex = np.stack([u1d[0], u1d[1], 0 * u1d[0], u1d[2]]).reshape(uq.shape)
    w = np.asarray(disc.wjq)
    l2 = sum(
        np.sqrt(np.sum(w * (uq[f] - uex[f]) ** 2))
        / max(np.sqrt(np.sum(w * uex[f] ** 2)), 1e-300)
        for f in (0, 1, 3)
    )
    # composite relative L1/Linf, reference dg2D_CNS_modalESDG.jl:765-774
    l1 = sum(np.sum(w * np.abs(uq[f] - uex[f])) / np.sum(w * np.abs(uex[f]))
             for f in (0, 1, 3))
    linf = sum(np.abs(uq[f] - uex[f]).max() / np.abs(uq[f]).max()
               for f in (0, 1, 3))
    print(f"N={n}, K={disc.num_elements}, T={t_end}: L1 = {l1:.6e}, "
          f"L2 = {l2:.6e}, Linf = {linf:.6e}, "
          f"steps accepted/rejected = {int(stats['n_accepted'])}/"
          f"{int(stats['n_rejected'])}")
    return {"k1d": k1d, "num_elements": disc.num_elements,
            "l1": float(l1), "l2": float(l2), "linf": float(linf),
            "n_accepted": int(stats["n_accepted"]),
            "n_rejected": int(stats["n_rejected"])}


def main():
    n, t_end = env_int("N", 2), env_float("T", 0.2)
    sweep = os.environ.get("SWEEP", "")
    if not sweep:
        run_one(n, env_int("K1D", 32), t_end)
        return
    rows = [run_one(n, int(s), t_end) for s in sweep.split(",")]
    out = os.environ.get("OUT", "")
    if out:
        with open(out, "w") as f:
            json.dump({"driver": "examples/dg2d_cns_shocktube.py",
                       "reference": "dg2D_CNS_modalESDG.jl (N=2, T=0.2, "
                                    "mu=0.01, M_0=3, inviscid_dissp only)",
                       "n": n, "t_end": t_end, "backend": jax.default_backend(),
                       "dtype": "float64" if jax.config.jax_enable_x64
                                else "float32",
                       "rows": rows}, f, indent=1)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
