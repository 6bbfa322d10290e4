"""Verification harnesses (reference SURVEY.md 3.5).

``wall_bc_convergence_study`` reproduces the reference's wall-BC
convergence sweep (dg2D_CNS_convergence_test.jl:836-1089): for each
(N, K1D, inviscid/viscous dissipation, Re) cell, solve the cavity with
the regularized lid profile vlid = (1 + cos(pi x))/2 to time T and
measure the boundary-weighted L2 mismatch of the velocity trace against
the lid/wall data.

``make_mms_source`` / ``make_mms_rhs`` / ``mms_convergence_study`` add a
method-of-manufactured-solutions harness (beyond the reference, whose
exact-solution anchors are the 1D-profile Becker shock and the
boundary-trace cavity error): pick ANY smooth space-time-periodic state
u(x, t), derive the exact compressible-NS source S = du/dt + div F(u)
- div sigma(u) by nested forward-mode AD through the same euler_flux /
v_ufun / viscous_flux_* functions the solver uses, and measure interior
L2 convergence of the full multi-dimensional viscous operator.
"""

from __future__ import annotations

import itertools
import json
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .presets import lid_driven_cavity
from .solvers import make_cns_rhs
from .timestepping import dopri45


def becker_shocktube_errors(n: int, k: int, t_end: float = 0.1,
                            err_tol: float = 1e-7):
    """L1/L2/Linf Becker-shocktube errors at the reference driver's
    configuration and norm conventions.

    Solves the Mach-3 viscous shocktube (presets.becker_shocktube_1d,
    defaults = dg1D_CNS_modalESDG.jl:83-103) to ``t_end`` with adaptive
    DOPRI45 and evaluates the summed per-field relative errors against
    the closed-form traveling wave, using the reference's
    normalizations (:497-512): L1 and L2 are divided by the NUMERICAL
    solution's norm, Linf by the exact solution's.

    Returns {"l1", "l2", "linf", "n_accepted"}.
    """
    from .presets import becker_shocktube_1d

    disc, q0, bc, shock = becker_shocktube_1d(n=n, k=k)
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    cn = (n + 1) * (n + 2) / 2
    dt0 = min(0.5 * (4.0 / k) / cn, 2.0 / (cn * k * k))
    qf, stats = jax.jit(
        lambda q: dopri45(rhs, q, t_end, dt0, err_tol=err_tol))(q0)

    uq = np.asarray(jnp.einsum("ij,fjk->fik", disc.vq, qf,
                               precision=jax.lax.Precision.HIGHEST))
    uex = np.stack(shock.conservative(np.asarray(disc.xq[0]), t_end))
    w = np.asarray(disc.wjq)[None]
    l1 = float(sum(np.sum(w[0] * np.abs(uq[f] - uex[f]))
                   / np.sum(w[0] * np.abs(uq[f])) for f in range(3)))
    l2 = float(sum(np.sqrt(np.sum(w[0] * (uq[f] - uex[f]) ** 2))
                   / np.sqrt(np.sum(w[0] * uq[f] ** 2)) for f in range(3)))
    linf = float(sum(np.abs(uq[f] - uex[f]).max()
                     / np.abs(uex[f]).max() for f in range(3)))
    return {"l1": l1, "l2": l2, "linf": linf,
            "n_accepted": int(stats["n_accepted"])}


def regularized_lid(x):
    """vlid = (1 + cos(pi x)) / 2 (dg2D_CNS_convergence_test.jl:75)."""
    return (1.0 + np.cos(np.pi * np.asarray(x))) / 2.0


def boundary_velocity_error(disc, q, lid_mask, wall_mask, lid_profile):
    """Weighted boundary L2 mismatch of (u, v) vs lid/wall data
    (dg2D_CNS_convergence_test.jl:1070-1082)."""
    # HIGHEST: a reduced-precision f32 matmul (TF32 on the GPU, ~1e-3
    # relative) would floor this convergence observable
    qf = jnp.einsum("ij,fjk->fik", disc.vf, q,
                    precision=jax.lax.Precision.HIGHEST)
    u = qf[1] / qf[0]
    v = qf[2] / qf[0]
    w = disc.wf[:, None] * disc.sj
    err = (
        jnp.sum(w * jnp.where(lid_mask, (u - lid_profile) ** 2 + v**2, 0.0))
        + jnp.sum(w * jnp.where(wall_mask, u**2 + v**2, 0.0))
    )
    norm = jnp.sum(w * jnp.where(lid_mask, lid_profile**2, 0.0))
    return jnp.sqrt(err / norm)


def wall_bc_reynolds_ensemble(
    n: int = 2,
    k1d: int = 8,
    bctype: str = "adiabatic",
    reynolds: Sequence[float] = (50.0, 100.0, 200.0, 400.0),
    dissipation: tuple = (True, True),
    t_end: float = 0.1,
    err_tol: float = 1e-5,
    mesh=None,
    axis: str = "e",
):
    """The Re axis of the convergence sweep as ONE vmapped (optionally
    device-sharded) program: every Reynolds member shares the mesh and
    operators, differs only in the traced viscosity, and runs
    concurrently — the data-parallel replacement for the reference's
    serial nested loop (dg2D_CNS_convergence_test.jl:840-852).

    Returns an array of boundary L2 errors, one per Reynolds number.
    """
    from .parallel.ensemble import ensemble

    disc, q0, bc, p = lid_driven_cavity(
        n=n, k1d=k1d, bctype=bctype, lid_profile=regularized_lid
    )
    lid_mask = bc.regions[0].mask
    wall_mask = bc.regions[1].mask
    prof = jnp.asarray(regularized_lid(np.asarray(disc.xf[0])),
                       dtype=disc.wq.dtype)
    cn = (n + 1) * (n + 2) / 2
    dt0 = min(0.25 * (2.0 / k1d) / cn, 2.0 / (cn * k1d**2))
    inv_d, visc_d = dissipation

    def single(re):
        rhs = make_cns_rhs(
            disc, mu=1.0 / re, pr=p["pr"], re=re, bc=bc,
            inviscid_dissipation=inv_d, viscous_dissipation=visc_d,
            compute_rhstest=False,
        )
        qf, _ = dopri45(rhs, q0, t_end, dt0, err_tol=err_tol)
        return boundary_velocity_error(disc, qf, lid_mask, wall_mask, prof)

    run = ensemble(single, mesh=mesh, axis=axis)
    return run(jnp.asarray(reynolds, dtype=disc.wq.dtype))


def wall_bc_convergence_study(
    orders: Sequence[int] = (1, 2, 3, 4),
    k1d: int = 32,
    bctype: str = "adiabatic",
    bctypes: Sequence[str] | None = None,
    reynolds: Sequence[float] = (100.0,),
    dissipation_cases: Sequence[tuple] = ((False, False), (True, True)),
    t_end: float = 1.0,
    err_tol: float = 1e-5,
    output_path: str | None = None,
    verbose: bool = False,
):
    """Nested sweep N x bctype x (inviscid_dissp, viscous_dissp) x Re
    (the reference's full grid, dg2D_CNS_convergence_test.jl:848-852).

    Returns a dict mapping (n, re, bctype, inv_d, visc_d) -> boundary
    L2 error.  The Reynolds number rides as a TRACED argument of one
    jitted program per (n, bctype, dissipation) cell, so sweeping Re
    costs no recompilation (the reference rebuilds everything per cell).
    """
    import time

    bctypes = (bctype,) if bctypes is None else tuple(bctypes)
    results = {}
    for n, bt in itertools.product(orders, bctypes):
        disc, q0, bc, p = lid_driven_cavity(
            n=n, k1d=k1d, bctype=bt, lid_profile=regularized_lid
        )
        lid_mask = bc.regions[0].mask
        wall_mask = bc.regions[1].mask
        prof = jnp.asarray(regularized_lid(np.asarray(disc.xf[0])),
                           dtype=disc.wq.dtype)
        cn = (n + 1) * (n + 2) / 2
        dt0 = min(0.25 * (2.0 / k1d) / cn, 2.0 / (cn * k1d**2))

        for inv_d, visc_d in dissipation_cases:
            def solve(q, re, inv_d=inv_d, visc_d=visc_d):
                rhs = make_cns_rhs(
                    disc, mu=1.0 / re, pr=p["pr"], re=re, bc=bc,
                    inviscid_dissipation=inv_d,
                    viscous_dissipation=visc_d,
                    compute_rhstest=False,
                )
                qf, stats = dopri45(rhs, q, t_end, dt0, err_tol=err_tol)
                err = boundary_velocity_error(
                    disc, qf, lid_mask, wall_mask, prof
                )
                return err, stats["n_accepted"], stats["n_rejected"]

            solve_j = jax.jit(solve)
            for re in reynolds:
                t0 = time.time()
                err, n_acc, n_rej = solve_j(
                    q0, jnp.asarray(re, disc.wq.dtype)
                )
                err = float(err)
                results[(n, float(re), bt, inv_d, visc_d)] = err
                if verbose:
                    print(
                        f"N={n} {bt} Re={re:g} dissp=({inv_d},{visc_d}): "
                        f"err={err:.6e} steps={int(n_acc)}/{int(n_rej)} "
                        f"[{time.time() - t0:.0f}s]",
                        flush=True,
                    )

    if output_path:
        with open(output_path, "w") as f:
            json.dump(
                [{"n": k[0], "re": k[1], "bctype": k[2],
                  "inviscid_dissp": k[3], "viscous_dissp": k[4],
                  "boundary_l2_error": v}
                 for k, v in results.items()],
                f, indent=2,
            )
    return results


# ---------------------------------------------------------------------------
# Method of manufactured solutions (MMS)
# ---------------------------------------------------------------------------


def make_mms_source(u_fun, dim: int, *, mu: float = 0.0, lam=None,
                    pr: float = 0.71, gamma: float = 1.4):
    """Exact source for a manufactured compressible-NS solution.

    ``u_fun(*coords, t) -> [Nfields]`` is any smooth conservative state
    written with scalar-broadcastable jnp ops.  Returns
    ``source(coords, t) -> [Nfields, ...]`` with ``coords`` stacked
    ``[dim, ...]``, computing pointwise by nested forward-mode AD

        S = du/dt + div F(u) - div sigma(u),

    where F is the exact Euler flux and sigma the viscous flux assembled
    through the SAME v_ufun / viscous_flux_{1,2,3}d compositions the
    discrete RHS uses, so du/dt = RHS(u) + S holds exactly for the
    continuous operator the scheme discretizes.
    """
    from .physics import euler as _eu
    from .physics import viscous as _vis

    def s_point(c, t):
        u_of = lambda cc, tt: u_fun(*[cc[d] for d in range(dim)], tt)
        s = jax.jacfwd(lambda tt: u_of(c, tt))(t)

        def stacked_flux(cc):
            return jnp.stack(_eu.euler_flux(u_of(cc, t), gamma))

        jf = jax.jacfwd(stacked_flux)(c)              # [dim, nf, dim]
        s = s + sum(jf[d, :, d] for d in range(dim))

        if mu != 0.0:
            def stacked_sigma(cc):
                v_of = lambda c2: _eu.v_ufun(u_of(c2, t), gamma)
                v = v_of(cc)
                gv = jax.jacfwd(v_of)(cc)             # [nf, dim]
                if dim == 1:
                    sig = (_vis.viscous_flux_1d(v, gv[:, 0], mu, lam,
                                                pr, gamma),)
                elif dim == 2:
                    sig = _vis.viscous_flux_2d(v, gv[:, 0], gv[:, 1], mu,
                                               lam, pr, gamma)
                else:
                    sig = _vis.viscous_flux_3d(v, gv[:, 0], gv[:, 1],
                                               gv[:, 2], mu, lam, pr, gamma)
                return jnp.stack(sig)                 # [dim, nf]

            js = jax.jacfwd(stacked_sigma)(c)         # [dim, nf, dim]
            s = s - sum(js[d, :, d] for d in range(dim))
        return s

    def source(coords, t):
        flat = coords.reshape(dim, -1).T              # [P, dim]
        sp = jax.vmap(lambda c: s_point(c, t))(flat)  # [P, nf]
        return sp.T.reshape((sp.shape[1],) + coords.shape[1:])

    return source


def make_mms_rhs(disc, rhs, source):
    """Wrap ``rhs(q, t) -> (dq, aux)`` with the L2-projected source.

    For affine elements the per-element Jacobian cancels between the
    weighted mass inverse and the source quadrature, so the nodal source
    contribution is exactly ``Pq @ S(xq)``.  On curved meshes the
    Jacobian varies over the element and the projection is the
    per-element wJq-weighted one: ``(Vq' W_J Vq)^{-1} Vq' W_J S`` with
    ``W_J = diag(wq * J_k)`` — precomputed once as a [K, Np, Nq]
    projector stack.
    """
    hp = jax.lax.Precision.HIGHEST
    xq = jnp.stack(disc.xq)
    if disc.geo.shape[1] == 1:
        def project(s):
            return jnp.einsum("ij,fjk->fik", disc.pq, s, precision=hp)
    else:
        m = jnp.einsum("qi,qk,qj->kij", disc.vq, disc.wjq, disc.vq,
                       precision=hp)
        vtw = jnp.einsum("qi,qk->kiq", disc.vq, disc.wjq, precision=hp)
        proj = jnp.linalg.solve(m, vtw)               # [K, Np, Nq]

        def project(s):
            return jnp.einsum("kiq,fqk->fik", proj, s, precision=hp)

    def rhs_mms(q, t):
        dq, aux = rhs(q, t)
        dq = dq + project(source(xq, t))
        return dq, aux

    return rhs_mms


def mms_solution_1d(x, t, gamma: float = 1.4):
    """A smooth space-periodic (period 2) manufactured 1D CNS state."""
    rho = 1.0 + 0.2 * jnp.sin(jnp.pi * (x - 0.4 * t))
    u = 0.25 + 0.1 * jnp.sin(jnp.pi * x) * jnp.cos(t)
    p = 1.0 + 0.1 * jnp.cos(jnp.pi * x) * jnp.cos(2.0 * t)
    e = p / (gamma - 1.0) + 0.5 * rho * u * u
    return jnp.stack([rho, rho * u, e])


def mms_solution_2d(x, y, t, gamma: float = 1.4):
    """A smooth space-periodic (period 2) manufactured 2D CNS state."""
    rho = 1.0 + 0.2 * jnp.sin(jnp.pi * (x - 0.5 * t)) \
        * jnp.sin(jnp.pi * (y - 0.3 * t))
    u = 0.25 + 0.1 * jnp.sin(jnp.pi * x) * jnp.cos(jnp.pi * y) * jnp.cos(t)
    v = -0.15 + 0.1 * jnp.cos(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.cos(t)
    p = 1.0 + 0.1 * jnp.cos(jnp.pi * (x - y)) * jnp.cos(2.0 * t)
    e = p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v)
    return jnp.stack([rho, rho * u, rho * v, e])


def mms_solution_3d(x, y, z, t, gamma: float = 1.4):
    """A smooth space-periodic (period 2) manufactured 3D CNS state."""
    rho = 1.0 + 0.2 * jnp.sin(jnp.pi * (x - 0.4 * t)) \
        * jnp.sin(jnp.pi * (y - 0.2 * t)) * jnp.sin(jnp.pi * z)
    u = 0.25 + 0.1 * jnp.sin(jnp.pi * x) * jnp.cos(jnp.pi * y) \
        * jnp.cos(jnp.pi * z) * jnp.cos(t)
    v = -0.15 + 0.1 * jnp.cos(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.cos(t)
    w = 0.1 * jnp.cos(jnp.pi * x) * jnp.sin(jnp.pi * z) * jnp.sin(t)
    p = 1.0 + 0.1 * jnp.cos(jnp.pi * (x - y + z)) * jnp.cos(2.0 * t)
    e = p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v + w * w)
    return jnp.stack([rho, rho * u, rho * v, rho * w, e])


def boundary_preserving_warp(*cs, alpha: float = 0.1):
    """Polynomial mesh warp c -> c + alpha * prod(c^2 - 1): vanishes on
    the whole boundary of [-1, 1]^dim, so periodic face identification
    stays exact while every interior element becomes genuinely curved
    (same family as the curved free-stream test, tests/test_euler_rhs)."""
    d = alpha * np.prod([(c - 1.0) * (c + 1.0) for c in cs], axis=0)
    return tuple(c + d for c in cs)


def mms_l2_error(disc, q, u_fun, t):
    """Relative quadrature-weighted L2 error over all fields."""
    qq = jnp.einsum("ij,fjk->fik", disc.vq, q,
                    precision=jax.lax.Precision.HIGHEST)
    ue = u_fun(*disc.xq, t)
    err = jnp.sum(disc.wjq * jnp.sum((qq - ue) ** 2, axis=0))
    norm = jnp.sum(disc.wjq * jnp.sum(ue**2, axis=0))
    return jnp.sqrt(err / norm)


def mms_convergence_study(
    orders: Sequence[int] = (2, 3),
    k1ds: Sequence[int] = (2, 4, 8),
    *,
    mu: float = 0.05,
    pr: float = 0.71,
    gamma: float = 1.4,
    t_end: float = 0.1,
    cfl: float = 0.25,
    u_fun=None,
    elem: str = "tri",
    curved_map=None,
    dissipation: tuple = (True, True),
    output_path: str | None = None,
    verbose: bool = False,
):
    """Interior L2 convergence of the full CNS operator on periodic
    line (``elem='line'``), tri (``elem='tri'``), quad
    (``elem='quad'``) or 3D hex (``elem='hex'``) meshes against a
    manufactured solution.  ``curved_map`` (e.g.
    ``boundary_preserving_warp``) warps the mesh, exercising the
    variable-geofac volume/BR1 paths and the wJq-weighted source
    projection.  Returns
    {n: {"k1d": [...], "error": [...], "rates": [...]}}.
    """
    import time

    from .core import build_discretization, ref_hex, ref_line, ref_quad, ref_tri
    from .mesh import (uniform_hex_mesh, uniform_line_mesh,
                       uniform_quad_mesh, uniform_tri_mesh)

    dim = {"hex": 3, "line": 1}.get(elem, 2)
    if u_fun is None:
        u_fun = {1: mms_solution_1d, 2: mms_solution_2d,
                 3: mms_solution_3d}[dim]
    source = make_mms_source(u_fun, dim, mu=mu, pr=pr, gamma=gamma)
    inv_d, visc_d = dissipation
    results = {}
    for n in orders:
        cn = ((n + 1) * (n + 2) * 3 / 2 if dim == 3
              else (n + 1) * (n + 2) / 2)
        errors = []
        for k1d in k1ds:
            if elem == "hex":
                vx, vy, vz, etov = uniform_hex_mesh(k1d)
                ref, verts = ref_hex(n), (vx, vy, vz)
            elif elem == "line":
                vx, etov = uniform_line_mesh(k1d)
                ref, verts = ref_line(n), (vx,)
            elif elem == "quad":
                vx, vy, etov = uniform_quad_mesh(k1d)
                ref, verts = ref_quad(n), (vx, vy)
            else:
                vx, vy, etov = uniform_tri_mesh(k1d)
                ref, verts = ref_tri(n), (vx, vy)
            disc = build_discretization(ref, verts, etov,
                                        periodic_axes=tuple(range(dim)),
                                        curved_map=curved_map)
            h = 2.0 / k1d
            dt = cfl * min(h / cn, h * h / (max(mu, 1e-30) * cn * cn))
            num_steps = max(1, int(np.ceil(t_end / dt)))
            dt = t_end / num_steps
            rhs = make_cns_rhs(
                disc, mu=mu, pr=pr, gamma=gamma,
                inviscid_dissipation=inv_d, viscous_dissipation=visc_d,
                compute_rhstest=False,
            )
            rhs_mms = make_mms_rhs(disc, rhs, source)
            q0 = u_fun(*[jnp.asarray(c) for c in disc.x], 0.0)

            from .timestepping import lsrk45

            t0 = time.time()
            solve = jax.jit(
                lambda q, r=rhs_mms, dt=dt, ns=num_steps:
                lsrk45(r, q, dt, ns)[0]
            )
            qf = solve(q0)
            err = float(mms_l2_error(disc, qf, u_fun, t_end))
            errors.append(err)
            if verbose:
                print(f"MMS N={n} K1D={k1d}: err={err:.6e} "
                      f"steps={num_steps} [{time.time() - t0:.1f}s]",
                      flush=True)
        rates = [float(np.log2(errors[i - 1] / errors[i]))
                 for i in range(1, len(errors))]
        results[n] = {"k1d": list(k1ds), "error": errors, "rates": rates}

    if output_path:
        with open(output_path, "w") as f:
            json.dump({str(k): v for k, v in results.items()}, f, indent=2)
    return results
