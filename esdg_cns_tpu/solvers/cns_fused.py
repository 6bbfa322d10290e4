"""Affine-mesh optimized CNS RHS: composed-operator formulation.

The integrated CNS RHS (solvers.cns.make_cns_rhs) applies ~20 tiny
per-stage operator GEMMs ([Np~10, Nq~12] matrices against [4, ., K]
states), so it is bound by memory traffic and launch count, not FLOPs.

On AFFINE meshes the geometric factors and 1/J are per-element
scalars, so they commute with every reference-element operator and the
whole viscous chain can be composed at setup time:

  * entropy-variable traces   Vf Pq v          -> rows of Vh Pq (free:
    they are the face block of the entropy projection),
  * quadrature gradient       Vq (D_r Pq v)    -> (Vq D_r Pq) v,
  * gradient jump correction  Vq L jump        -> (Vq L) jump,
  * projected quadrature vars Vq Pq v          -> (Vq Pq) v,
  * stress traces             Vf Pq sigma      -> (Vf Pq) sigma,
  * stress divergence         sum_x D_r Pq (geo sigma_x)
                                               -> (D_r Pq) g_r.

All per-stage front-end operators applied to v(U) at quadrature are
stacked into ONE [Nh + (2+dim) Nq, Nq] GEMM, and the two LIFT
applications (inviscid surface flux; viscous jump + penalty) ride one
batched GEMM.  Semantics identical to make_cns_rhs (same physics
calls, same BC hooks, same merged 2-exchange structure) — tested for
equality to roundoff; this is purely an operator-algebra re-association
(reference counterpart: none — dg2D_CNS_cavity_optimized.jl:447-849
optimizes by preallocating Julia buffers instead).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..core.discretization import Discretization
from ..physics import euler as phys
from ..physics.viscous import viscous_flux_nd
from .boundary import WallBC
from .dg_ops import _apply


def make_cns_rhs_affine(
    disc: Discretization,
    *,
    mu: float,
    lam: Optional[float] = None,
    pr: float = 0.71,
    gamma: float = phys.GAMMA,
    bc: Optional[WallBC] = None,
    inviscid_dissipation: bool = False,
    viscous_dissipation: bool = False,
    re: Optional[float] = None,
    flux_diff_impl: str = "auto",
    compute_rhstest: bool = True,
    rhstest_mode: str = "native",
    gather_fn=None,
    psum_axis: Optional[str] = None,
):
    """Composed-operator CNS RHS for affine meshes (tri/quad/hex).

    Same contract as solvers.cns.make_cns_rhs; requires disc.affine.
    The inviscid volume stage is the stacked front-end GEMM followed by
    the ``flux_diff_impl`` flux differencing ('auto': line-sparse on
    collocated quad/hex, dense all-pairs otherwise).
    """
    if not disc.affine:
        raise ValueError("make_cns_rhs_affine requires an affine mesh")
    from ..utils.compensated import (require_exact_mode,
                                     weighted_entropy_residual)
    from ._shared import (
        adiabatic_mask,
        inviscid_surface,
        neighbor_traction,
        resolve_flux_diff,
        viscous_penalty_rows,
    )

    require_exact_mode(rhstest_mode)
    dim = disc.dim
    nq = disc.nq
    nh = disc.nh
    re = (1.0 / mu) if re is None else re

    fd = resolve_flux_diff(disc, flux_diff_impl)
    adiab = adiabatic_mask(disc, bc)
    gather = disc.gather_traces if gather_fn is None else gather_fn

    # ---- composed operators (setup time, HIGHEST-precision products) ----
    mm = lambda a, b: jnp.einsum("ij,jk->ik", a, b,
                                 precision=jax.lax.Precision.HIGHEST)
    vqpq = mm(disc.vq, disc.pq)                      # [Nq, Nq]
    vqlift = mm(disc.vq, disc.lift)                  # [Nq, Nfq]
    drpq = [mm(di, disc.pq) for di in disc.d]        # dim x [Np, Nq]
    vqdrpq = [mm(disc.vq, dp) for dp in drpq]        # dim x [Nq, Nq]
    # one front-end operator on v(U) at quadrature:
    #   rows [0:Nh)         -> Vh Pq (entropy projection; faces = traces)
    #   rows [Nh : Nh+Nq)   -> Vq Pq (projected entropy vars at quad)
    #   rows [Nh+(1+r)Nq:.) -> Vq D_r Pq (projected reference gradients)
    front = jnp.concatenate([disc.vhp, vqpq, *vqdrpq], axis=0)
    drpq_stack = jnp.stack(drpq)                     # [dim, Np, Nq]

    # affine: per-element scalars
    inv_j = disc.inv_jac[:1]                         # [1, K]
    geo = disc.geo                                   # [dim*dim, 1, K]

    def front_end(q):
        uq = _apply(disc.vq, q)
        vu_q = phys.v_ufun(uq, gamma)
        fr = _apply(front, vu_q)                     # [Nf, Nh+(1+dim)Nq, K]
        vuh = fr[:, :nh]
        vuq = fr[:, nh:nh + nq]
        vqd = [fr[:, nh + (1 + r) * nq: nh + (2 + r) * nq]
               for r in range(dim)]
        uh = phys.u_vfun(vuh, gamma)
        vuf = vuh[:, nq:]                            # = (Vf Pq) v: traces

        beta = phys.betafun(uh, gamma)
        qh = jnp.concatenate(
            [uh[0][None], uh[1:-1] / uh[0], beta[None]], axis=0
        )
        qlog = jnp.stack([jnp.log(qh[0]), jnp.log(qh[-1])])
        ph_qf = _apply(disc.ph, fd(qh, qlog, disc.q_skew, disc.geo, gamma))
        return (qh[:, nq:, :], uh[:, nq:, :], qlog[:, nq:, :], vuf,
                vuq, vqd, ph_qf)

    def rhs(q, t=0.0):
        # ---- entropy projection + volume flux differencing ----
        qm, uf, qm_log, vuf, vuq, vqd, ph_qf = front_end(q)

        # ---- ONE merged exchange (inviscid + entropy traces) + surface --
        flux, vup = inviscid_surface(
            disc, gather, qm, uf, qm_log,
            gamma=gamma, dissipation=inviscid_dissipation,
            bc_inviscid=bc.inviscid if bc is not None else None,
            entropy_extras=True, t=t,
        )

        # ---- viscous gradient BC traces ----
        if bc is not None:
            vup = bc.entropy_vars(disc, vuf, vup, t)
        dv = vup - vuf
        half_jumps = jnp.stack(
            [0.5 * dv * disc.nxj[x][None] for x in range(dim)]
        )                                            # [dim, Nf, Nfq, K]
        grad_surf = _apply(vqlift, half_jumps)       # [dim, Nf, Nq, K]
        grad_q = [
            (sum(geo[r * dim + x] * vqd[r] for r in range(dim))
             + grad_surf[x]) * inv_j
            for x in range(dim)
        ]

        sigma = viscous_flux_nd(vuq, grad_q, mu, lam, pr, gamma)

        rhstest_visc = sum(
            weighted_entropy_residual(disc.wjq, g, s, rhstest_mode)
            for g, s in zip(grad_q, sigma)
        )
        if psum_axis is not None:
            rhstest_visc = jax.lax.psum(rhstest_visc, psum_axis)

        # ---- ONE batched CONTRACTED stress exchange (Nf rows).  Only
        # the normal contraction t = sum_x s_x nxj_x ever reaches the
        # jump term, and conforming faces carry negated normals, so
        # exchanging t instead of the dim*Nf component traces both
        # shrinks the payload and drops the post-gather contraction
        # (comm-avoiding; the reference exchanges all components,
        # dg2D_CNS_cavity_optimized.jl:780-816). ----
        s_f_all = _apply(disc.vhp[nq:], jnp.stack(sigma))  # [dim,Nf,Nfq,K]
        t_f = sum(s_f_all[x] * disc.nxj[x][None] for x in range(dim))
        t_ex = gather(t_f)
        t_pn = neighbor_traction(disc, bc, t_f, t_ex, t)

        # ---- viscous divergence (composed) + both LIFTs in one GEMM ----
        g_r = jnp.stack([
            sum(geo[r * dim + x] * sigma[x] for x in range(dim))
            for r in range(dim)
        ])                                           # [dim, Nf, Nq, K]
        div = jnp.einsum("rij,rfjk->fik", drpq_stack, g_r,
                         precision=jax.lax.Precision.HIGHEST)

        jump_n = 0.5 * (t_pn - t_f)
        lift_in = [flux, jump_n]
        if viscous_dissipation:
            # like the reference (cavity_optimized:840-846), the lifted
            # penalty is added AFTER the 1/J scaling of dg_div
            lift_in.append(
                viscous_penalty_rows(disc, bc, adiab, vuf, vup, dv, re))

        lifted = _apply(disc.lift, jnp.stack(lift_in))
        dq_i = -(ph_qf + lifted[0]) * inv_j[None]
        dq_v = (div + lifted[1]) * inv_j[None]
        if viscous_dissipation:
            dq_v = dq_v + lifted[2]

        dq = dq_i + dq_v
        aux = {"rhstest_visc": rhstest_visc}
        if compute_rhstest:
            rt = weighted_entropy_residual(
                disc.wjq, vuq, _apply(disc.vq, dq), rhstest_mode
            )
            rtv = weighted_entropy_residual(
                disc.wjq, vuq, _apply(disc.vq, dq_v), rhstest_mode
            )
            if psum_axis is not None:
                rt = jax.lax.psum(rt, psum_axis)
                rtv = jax.lax.psum(rtv, psum_axis)
            aux["rhstest"] = rt
            aux["rhstest_visc_total"] = rtv + rhstest_visc
        return dq, aux

    return rhs
