"""Entropy-stable modal DG semi-discretization of compressible Euler.

The canonical ES-DG RHS (reference call stack SURVEY.md 3.2 / rhs in
dg2D_euler_tri.jl:130-186, hex variant dg3D_euler_hex.jl:167-222):

  1. entropy projection  U -> V at quadrature -> project -> U at
     hybridized points,
  2. flux variables (rho, u, beta) + precomputed logs,
  3. face traces + neighbor gather (the only cross-element dependence),
  4. optional Lax-Friedrichs dissipation,
  5. EC surface flux + LIFT,
  6. volume flux differencing (hot kernel),
  7. scale by -1/J; entropy-balance diagnostic rhstest.

Everything is one jittable pure function of the stacked conservative
state Q [Nf, Np, K]; the Discretization pytree is a closed-over
argument.  All operator applications are einsums; all pointwise maps
are fused elementwise ops; the gather is a single XLA gather; there is
no scatter anywhere.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..core.discretization import Discretization
from ..physics import euler as phys

Array = jnp.ndarray


# single source of the HIGHEST-precision operator apply (a reduced-
# precision f32 matmul, e.g. TF32 on the GPU, has ~1e-3 relative error
# and destroys the discrete SBP identities the entropy balance relies on)
from .dg_ops import _apply  # noqa: E402


def entropy_projection(disc: Discretization, q: Array, gamma: float):
    """U at solution nodes -> (VU at quad, U at hybridized points).

    Reference dg2D_euler_tri.jl:138-140.  For collocated quad/hex
    elements VhP = [I; Ef], so u_vfun(v_ufun(U)) is the identity on the
    volume block — only the face extrapolation needs the (transcendental-
    heavy) inverse map, matching the reference's collocated shortcut
    Uh = [Q; u_vfun(Ef v_ufun(Q))] (dg3D_euler_hex.jl:176-178).
    """
    if disc.line_ops is not None:  # collocated quad/hex
        vu = phys.v_ufun(q, gamma)
        uf = phys.u_vfun(_apply(disc.vhp[disc.nq:], vu), gamma)
        return vu, jnp.concatenate([q, uf], axis=1)
    uq = _apply(disc.vq, q)
    vu = phys.v_ufun(uq, gamma)
    vuh = _apply(disc.vhp, vu)
    uh = phys.u_vfun(vuh, gamma)
    return vu, uh


def make_euler_rhs(
    disc: Discretization,
    *,
    gamma: float = phys.GAMMA,
    dissipation: bool = True,
    bc_fun: Optional[Callable] = None,
    flux_diff_impl: str = "xla",
    compute_rhstest: bool = True,
    rhstest_mode: str = "native",
    gather_fn: Optional[Callable] = None,
    psum_axis: Optional[str] = None,
):
    """Build the jittable ES-DG Euler RHS.

    Args:
      disc: discretization pytree.
      dissipation: add local Lax-Friedrichs interface dissipation
        (entropy-stable); without it the scheme is entropy-conservative.
      bc_fun: optional boundary hook
        ``bc_fun(disc, qm, qp, uf, up, t) -> (qp, up)`` applied to the
        gathered neighbor traces (flux-variable and conservative ghost
        states; WallBC.inviscid has this signature).  Periodicity is
        already baked into mapP.
      flux_diff_impl: 'xla' (dense all-pairs), 'lines' (tensor-product
        sparse, collocated quad/hex; also 'lines_perm' / 'lines_rot'
        layouts) or 'auto' ('lines' where it applies).
      rhstest_mode: accumulation accuracy of the entropy-balance
        diagnostic — 'native', 'compensated' (double-float Dot2 for f32
        states) or 'f64' (utils.compensated).
      gather_fn: override for the neighbor-trace gather (the shard_map
        halo-exchange path passes HaloExchange.gather here).
      psum_axis: mesh axis over which diagnostics are all-reduced when
        running inside shard_map.

    Returns rhs(q) -> (dq/dt [Nf, Np, K], aux dict with 'rhstest').
    """
    from ..utils.compensated import require_exact_mode
    from ._shared import inviscid_surface, resolve_flux_diff

    require_exact_mode(rhstest_mode)
    nq = disc.nq
    fd = resolve_flux_diff(disc, flux_diff_impl)
    gather = disc.gather_traces if gather_fn is None else gather_fn

    def rhs(q: Array, t: float = 0.0):
        vu, uh = entropy_projection(disc, q, gamma)
        beta = phys.betafun(uh, gamma)
        qh = jnp.concatenate(
            [uh[0][None], uh[1:-1] / uh[0], beta[None]], axis=0
        )
        qlog = jnp.stack([jnp.log(qh[0]), jnp.log(qh[-1])])

        # --- face traces + one batched neighbor exchange ---
        flux, _ = inviscid_surface(
            disc, gather, qh[:, nq:, :], uh[:, nq:, :], qlog[:, nq:, :],
            gamma=gamma, dissipation=dissipation, bc_inviscid=bc_fun, t=t,
        )
        rhs_surf = _apply(disc.lift, flux)

        # --- volume flux differencing ---
        qf = fd(qh, qlog, disc.q_skew, disc.geo, gamma)
        rhs_q = -(_apply(disc.ph, qf) + rhs_surf) * disc.inv_jac[None]

        aux = {}
        if compute_rhstest:
            from ..utils.compensated import weighted_entropy_residual

            rt = weighted_entropy_residual(
                disc.wjq, vu, _apply(disc.vq, rhs_q), rhstest_mode
            )
            if psum_axis is not None:
                rt = jax.lax.psum(rt, psum_axis)
            aux["rhstest"] = rt
        return rhs_q, aux

    return rhs


def l2_error(disc: Discretization, q: Array, q_exact_at_quad: Array) -> Array:
    """Quadrature L2 error against exact nodal values at quad points."""
    dq = _apply(disc.vq, q) - q_exact_at_quad
    return jnp.sqrt(jnp.sum(disc.wjq[None] * dq * dq))
