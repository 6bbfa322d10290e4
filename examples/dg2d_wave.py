"""First-order acoustic wave system on periodic tri or quad meshes.

Parity workloads: reference examples/dg2D_wave_tri.jl and
dg2D_wave_quad.jl.  Prints the discrete energy before/after (decaying
with the penalty flux, conserved with tau=0).
"""

import os

from common import env_float, env_int

import jax
import jax.numpy as jnp

from esdg_cns_tpu.config import SimConfig, build_problem
from esdg_cns_tpu.solvers import make_wave_rhs
from esdg_cns_tpu.timestepping import lsrk45


def main():
    cfg = SimConfig(
        equation="wave", elem_type=os.environ.get("ELEM", "tri"),
        n=env_int("N", 3), k1d=env_int("K1D", 8),
        cfl=env_float("CFL", 0.3), t_end=env_float("T", 0.7),
    )
    disc, _ = build_problem(cfg)
    tau = env_float("TAU", 0.5)
    rhs = make_wave_rhs(disc, tau=tau)
    p0 = jnp.sin(jnp.pi * disc.x[0]) * jnp.sin(jnp.pi * disc.x[1])
    q0 = jnp.concatenate([p0[None], jnp.zeros((2, *p0.shape))], axis=0)
    dt = cfg.estimate_dt()
    ns = max(int(cfg.t_end / dt), 1)
    qf, _ = jax.jit(lambda q: lsrk45(rhs, q, cfg.t_end / ns, ns))(q0)

    def energy(q):
        qq = jnp.einsum("ij,fjk->fik", disc.vq, q,
                        precision=jax.lax.Precision.HIGHEST)
        return float(jnp.sum(disc.wjq[None] * qq * qq) / 2)

    print(f"{cfg.elem_type} N={cfg.n} K={disc.num_elements} tau={tau}: "
          f"energy {energy(q0):.8f} -> {energy(qf):.8f}")


if __name__ == "__main__":
    main()
