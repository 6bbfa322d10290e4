"""3D Taylor-Green vortex (compressible CNS) on a periodic hex mesh.

Beyond-reference physics demo (the reference has no 3D CNS workload;
its CNS drivers are 1D/2D shocktubes and the 2D cavity): the classic
transition-to-turbulence benchmark exercises the full 3D viscous path
(line-sparse flux differencing + BR1 viscous terms) on a real flow with
known qualitative physics, and its conservation structure gives exact
internal oracles on a periodic domain:

  * total mass / momentum / energy are conserved by the scheme
    (telescoping surface terms) -> drift is pure roundoff;
  * kinetic energy decays monotonically, the loss appearing as
    internal energy (implied by E conservation);
  * the dissipation rate eps(t*) = -dKE/dt* rises to a single peak
    (vortex stretching steepens gradients until viscosity wins) and
    then decays;
  * rhstest <= 0 every step (entropy stability).

Nondimensionalization on the period-2 box [-1,1]^3: velocity scale
U0 = 1, length scale Lc = 1/pi (unit wavenumber), time scale
tc = Lc/U0, so mu = U0*Lc/Re = 1/(pi*Re) and t* = t*pi is the
convective time reported by the incompressible TGV literature.
Ma = U0/c0 sets p0 = 1/(gamma*Ma^2).

Usage: python examples/dg3d_cns_tgv.py   [N=3 K1D=8 RE=400 MA=0.1
       T=12 (in tc units) CFL=0.5 OUT=results/tgv.json]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from common import env_float, env_int

import jax
import jax.numpy as jnp
import numpy as np

if os.environ.get("PLATFORM"):
    jax.config.update("jax_platforms", os.environ["PLATFORM"])

from esdg_cns_tpu.core import build_discretization, ref_hex
from esdg_cns_tpu.mesh import uniform_hex_mesh
from esdg_cns_tpu.physics.euler import primitive_to_conservative
from esdg_cns_tpu.solvers import make_cns_rhs_affine
from esdg_cns_tpu.timestepping import lsrk45

GAMMA = 1.4


def tgv_state(x, y, z, ma):
    """Conservative TGV initial condition on the period-2 box."""
    px, py, pz = np.pi * x, np.pi * y, np.pi * z
    rho = np.ones_like(x)
    u = np.sin(px) * np.cos(py) * np.cos(pz)
    v = -np.cos(px) * np.sin(py) * np.cos(pz)
    w = np.zeros_like(x)
    p0 = 1.0 / (GAMMA * ma * ma)
    p = p0 + (np.cos(2 * px) + np.cos(2 * py)) * (np.cos(2 * pz) + 2.0) / 16.0
    return rho, np.stack([u, v, w]), p


def main():
    n, k1d = env_int("N", 3), env_int("K1D", 8)
    re, ma = env_float("RE", 400.0), env_float("MA", 0.1)
    t_end_star = env_float("T", 12.0)
    cfl = env_float("CFL", 0.5)
    out = os.environ.get("OUT", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "results",
        "tgv.json"))

    vx, vy, vz, etov = uniform_hex_mesh(k1d)
    disc = build_discretization(ref_hex(n), (vx, vy, vz), etov,
                                periodic_axes=(0, 1, 2),
                                grid_shape=(k1d, k1d, k1d))
    rho, vel, p = tgv_state(*[np.asarray(c) for c in disc.x], ma)
    f = lambda a: jnp.asarray(a, dtype=disc.wq.dtype)
    q0 = primitive_to_conservative(f(rho), f(vel), f(p))

    mu = 1.0 / (np.pi * re)           # U0 * Lc / Re with Lc = 1/pi
    rhs = make_cns_rhs_affine(
        disc, mu=mu, pr=0.71, re=1.0 / mu, gamma=GAMMA,
        inviscid_dissipation=True,
        viscous_dissipation=True,
    )

    # acoustic CFL (c0 = 1/Ma) + parabolic limit
    cn = (n + 1) * (n + 2) * 3 / 2
    h = 2.0 / k1d
    dt = cfl * min(h / (cn * (1.0 + 1.0 / ma)),
                   h * h / (mu * cn * cn))
    t_end = t_end_star / np.pi        # tc = 1/pi
    spc = env_int("STEPS_PER_CHUNK", 50)
    n_chunks = int(np.ceil(t_end / (dt * spc)))
    dt = t_end / (n_chunks * spc)

    hp = jax.lax.Precision.HIGHEST

    def observables(q):
        qq = jnp.einsum("ij,fjk->fik", disc.vq, q, precision=hp)
        w = disc.wjq
        tot = jnp.stack([jnp.sum(w * qq[i]) for i in range(5)])
        ke = jnp.sum(w * 0.5 * jnp.sum(qq[1:4] ** 2, axis=0) / qq[0])
        return tot, ke

    @jax.jit
    def chunk(q, t0):
        qf, aux = lsrk45(rhs, q, dt, spc, t0=t0)
        tot, ke = observables(qf)
        return qf, tot, ke, aux["rhstest"], aux["rhstest_visc"]

    vol = 8.0
    tot0, ke0 = jax.jit(observables)(q0)
    tot0 = np.asarray(tot0)
    print(f"TGV N={n} K={disc.num_elements} Re={re:g} Ma={ma:g} "
          f"dt={dt:.3e} chunks={n_chunks}x{spc} "
          f"DOF={5 * disc.np_ * disc.num_elements}", flush=True)

    q, t = q0, 0.0
    hist = {"t_star": [0.0], "ke": [float(ke0) / vol],
            "rhstest_max": [], "rhstest_visc_min": []}
    drift = np.zeros(5)
    wall0 = time.time()
    for c in range(n_chunks):
        q, tot, ke, rt, rtv = chunk(q, t)
        t += dt * spc
        hist["t_star"].append(t * np.pi)
        hist["ke"].append(float(ke) / vol)
        hist["rhstest_max"].append(float(jnp.max(rt)))
        hist["rhstest_visc_min"].append(float(jnp.min(rtv)))
        drift = np.maximum(drift, np.abs(np.asarray(tot) - tot0))
        if not np.isfinite(hist["ke"][-1]):
            raise SystemExit(f"non-finite KE at chunk {c} — underresolved")
        if c % max(1, n_chunks // 10) == 0:
            print(f"  t*={hist['t_star'][-1]:6.2f} Ek={hist['ke'][-1]:.6f} "
                  f"rhstest_max={hist['rhstest_max'][-1]:.2e}", flush=True)
    wall = time.time() - wall0

    ts = np.asarray(hist["t_star"])
    ke_h = np.asarray(hist["ke"])
    # dissipation at chunk midpoints, in convective units
    eps = -(ke_h[1:] - ke_h[:-1]) / (ts[1:] - ts[:-1])
    t_mid = 0.5 * (ts[1:] + ts[:-1])
    ipk = int(np.argmax(eps))
    # conservation drift relative to the natural scale of each invariant
    scale = np.maximum(np.abs(tot0), np.abs(tot0[4]))
    rel_drift = (drift / scale).tolist()

    payload = {
        "config": {"n": n, "k1d": k1d, "re": re, "ma": ma, "mu": mu,
                   "t_end_star": t_end_star, "cfl": cfl, "dt": dt,
                   "steps": n_chunks * spc,
                   "dof": 5 * disc.np_ * disc.num_elements,
                   "backend": jax.default_backend()},
        "t_star": ts.tolist(),
        "ke": ke_h.tolist(),
        "eps_t_star": t_mid.tolist(),
        "eps": eps.tolist(),
        "peak": {"t_star": float(t_mid[ipk]), "eps": float(eps[ipk])},
        "ke_monotone_decay": bool(np.all(np.diff(ke_h) < 0)),
        "conservation_rel_drift": rel_drift,
        "rhstest_max": float(np.max(hist["rhstest_max"])),
        "rhstest_visc_min": float(np.min(hist["rhstest_visc_min"])),
        "wall_s": wall,
    }
    if abs(re - 1600.0) < 1e-9:
        # quantitative external anchor: the workshop/van-Rees 512^3 DNS
        # dissipation peak (physics/tgv_benchmarks.py)
        from esdg_cns_tpu.physics.tgv_benchmarks import compare_re1600

        payload["re1600_anchor"] = compare_re1600(
            payload["peak"]["eps"], payload["peak"]["t_star"],
            dof_1d=(n + 1) * k1d)
        a = payload["re1600_anchor"]
        print(f"Re=1600 DNS anchor: eps dev {a['eps_rel_dev']*100:.1f}% "
              f"(tol {a['eps_rel_tol']*100:.0f}%) "
              f"{'PASS' if a['eps_pass'] else 'FAIL'}; "
              f"t* dev {a['t_star_abs_dev']:.2f} "
              f"(tol {a['t_star_abs_tol']:.2f}) "
              f"{'PASS' if a['t_star_pass'] else 'FAIL'}")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(payload, fh, indent=2)
    print(f"Ek0={ke_h[0]:.6f} -> Ek(T)={ke_h[-1]:.6f}  "
          f"monotone={payload['ke_monotone_decay']}")
    print(f"peak dissipation eps={payload['peak']['eps']:.3e} at "
          f"t*={payload['peak']['t_star']:.2f}")
    print(f"conservation rel drift (rho,m,E): {rel_drift}")
    print(f"rhstest_max={payload['rhstest_max']:.3e} (entropy stability)"
          f"  wall={wall:.1f}s -> {out}")


if __name__ == "__main__":
    main()
