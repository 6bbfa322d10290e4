"""Building blocks shared by the Euler / CNS RHS builders.

make_euler_rhs (euler.py), make_cns_rhs / make_viscous_rhs (cns.py)
and make_cns_rhs_affine (cns_fused.py) assemble the same sub-stages —
flux-differencing dispatch, the merged neighbor exchange + EC surface
flux + LF dissipation, adiabatic-region masks and the viscous
interface penalty rows.  They live here once so a change cannot
silently de-synchronize paths that the tests assert are equal to
roundoff (tests/test_cns_fused.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..physics import euler as phys


def resolve_flux_diff(disc, flux_diff_impl: str):
    """Select the volume flux-differencing kernel.

    Returns fd(qh, qlog, q_skew, geo, gamma) -> QF [Nf, Nh, K].
    Impls: 'auto' | 'xla' | 'lines' | 'lines_perm' | 'lines_rot'.
    """
    from ..ops.flux_differencing import flux_differencing_xla

    nq = disc.nq
    if flux_diff_impl == "auto":
        flux_diff_impl = "lines" if disc.line_ops is not None else "xla"
    if flux_diff_impl in ("lines", "lines_perm", "lines_rot"):
        from ..ops.tensor_product_fd import (
            flux_differencing_lines,
            flux_differencing_lines_perm,
            flux_differencing_lines_rot,
        )

        if disc.line_ops is None:
            raise ValueError("'lines' requires a collocated quad/hex mesh")
        impl = {"lines": flux_differencing_lines,
                "lines_perm": flux_differencing_lines_perm,
                "lines_rot": flux_differencing_lines_rot}[flux_diff_impl]

        def fd(qh, qlog, q_skew, geo, gamma):
            del q_skew  # the Kronecker structure replaces the dense ops
            return impl(
                qh, qlog, geo, gamma,
                elem_type=disc.elem_type, line_ops=disc.line_ops, nq=nq,
            )

        return fd
    if flux_diff_impl == "xla":
        return flux_differencing_xla
    raise ValueError(f"unknown flux_diff_impl: {flux_diff_impl!r}")


def adiabatic_mask(disc, bc):
    """bool [Nfq, K] marking adiabatic-wall regions (None without bc).

    Pure jnp (no host round-trip): the masks may be traced shard_map
    arguments when the BC bundle rides the explicit halo path."""
    if bc is None:
        return None
    am = jnp.zeros(bc.bmask.shape, dtype=bool)
    for r in bc.regions:
        if r.kind == "adiabatic":
            am = jnp.logical_or(am, r.mask)
    return am


def flux_to_conservative(q, gamma):
    """(rho, u_1..d, beta) flux-variable rows -> conservative rows
    (rho, m_1..d, E) with p = rho / (2 beta), dimension-generic."""
    rho, beta = q[0], q[q.shape[0] - 1]
    vel = [q[1 + d] for d in range(q.shape[0] - 2)]
    e = rho / (2.0 * beta * (gamma - 1.0)) + 0.5 * rho * sum(
        v * v for v in vel
    )
    return jnp.concatenate(
        [rho[None]] + [(rho * v)[None] for v in vel] + [e[None]], axis=0
    )


_LOG2 = 0.6931471805599453


def entropy_vars_from_flux(qp, qp_log, gamma):
    """Entropy variables v(U) rebuilt from flux-variable traces
    (rho, u_1..d, beta) and their precomputed logs — comm-avoiding:
    the CNS exchanges no longer carry the projected entropy traces
    (4-of-10 payload rows in 2D); both face sides rebuild v from the
    same exchanged payload with ~13 cheap elementwise ops and NO
    transcendentals (log p = log rho - log beta - log 2):

      s   = -(gamma-1) log rho - log beta - log 2
      v1  = gamma - s - (gamma-1) beta |u|^2
      v_d = 2 (gamma-1) beta u_d
      ve  = -2 (gamma-1) beta

    v(U(v)) = v exactly (inverse maps), so the rebuilt value matches
    the projected trace the neighbor would have sent up to an
    ulp-level round-trip error — the same accepted tradeoff as the
    conservative recompute in inviscid_surface (docs/design.md).
    """
    dim = qp.shape[0] - 2
    gm1 = gamma - 1.0
    beta = qp[dim + 1]
    vel = [qp[1 + d] for d in range(dim)]
    s = -gm1 * qp_log[0] - qp_log[1] - _LOG2
    tb = (2.0 * gm1) * beta
    v1 = (gamma - s) - (0.5 * tb) * sum(v * v for v in vel)
    return jnp.stack([v1] + [tb * v for v in vel] + [-tb])


def inviscid_surface(disc, gather, qm, uf, qm_log, *, gamma, dissipation,
                     bc_inviscid=None, extra_parts=(),
                     entropy_extras=False, t=0.0):
    """Merged neighbor exchange + EC surface flux + LF dissipation.

    One batched exchange carries the flux-variable traces qm, the
    precomputed logs, and any caller extras (the CNS paths append the
    entropy-variable traces so the viscous gradient rides the same
    exchange — SURVEY.md 3.3 compression of the reference's 3
    exchanges).  Comm-avoiding layout: the conservative traces and the
    LF wavespeed never cross the interconnect — both sides recompute
    them pointwise from the exchanged flux variables (the wavespeed's
    normal momentum uses the LOCAL normal; conforming faces carry
    exactly negated normals, and negation/|.| are exact in IEEE, so
    the value is preserved to setup roundoff).

    Returns (flux [Nf, Nfq, K] ready for LIFT, extras_nbr) where
    extras_nbr is the gathered counterpart of extra_parts concatenated
    along the field axis (empty array slice if none given).
    """
    dim = disc.dim
    nf = qm.shape[0]
    # the neighbor logs are consumed only by the extras rebuild and by
    # the no-BC EC flux; with a BC hook and no extras they would be
    # dead exchange payload (ghost states force a log recompute anyway)
    ship_logs = entropy_extras or bc_inviscid is None
    parts = [qm] + ([qm_log] if ship_logs else [])
    n_inv = nf + (2 if ship_logs else 0)
    parts.extend(extra_parts)
    nbr = gather(jnp.concatenate(parts, axis=0))
    qp = nbr[:nf]
    qp_log = nbr[nf:nf + 2] if ship_logs else None
    # pre-BC neighbor entropy variables (BC hooks are applied to the
    # rebuilt traces by the caller, exactly as for exchanged ones)
    extras = (entropy_vars_from_flux(qp, qp_log, gamma)
              if entropy_extras else None)
    up = flux_to_conservative(qp, gamma) if (dissipation
                                             or bc_inviscid is not None) \
        else None

    if bc_inviscid is not None:
        qp, up = bc_inviscid(disc, qm, qp, uf, up, t)
        # ghost states may change rho/beta; recompute the ghost logs
        fs = phys.ec_flux(qm, qp, qm_log, None, gamma=gamma)
    else:
        fs = phys.ec_flux(qm, qp, qm_log, qp_log, gamma=gamma)
    flux = sum(f * n[None] for f, n in zip(fs, disc.nxj))
    if dissipation:
        def lam(u):
            rhoun = sum(u[1 + d] * disc.nxj[d] for d in range(dim))
            return phys.wavespeed(u[0], rhoun * disc.inv_sj, u[-1], gamma)

        lfc = 0.25 * jnp.maximum(lam(uf), lam(up)) * disc.sj
        flux = flux - lfc[None] * (up - uf)
    return flux, (extras if entropy_extras else nbr[n_inv:])


def neighbor_traction(disc, bc, t_f, t_ex, t=0.0):
    """Neighbor normal traction along the LOCAL normal from the
    contracted stress exchange (t_ex = gather of t_f = sum_x s_f[x]
    nxj[x]).  Interior conforming faces carry exactly negated normals,
    so the neighbor value reads -t_ex; SELF-MAPPED faces (non-periodic
    boundary, gather returns t_f itself) would flip sign under that
    rule, so they take the natural t_pn = t_f (zero jump — the
    pre-contraction semantics, where the per-component self-gather
    gave sigma_p == sigma_m).  BC regions then override their faces
    (WallBC.stress_normal applies the same base rule)."""
    if bc is not None:
        return bc.stress_normal(disc, t_f, t_ex, t)
    return jnp.where(disc.bmask[None], t_f, -t_ex)


def viscous_penalty_rows(disc, bc, adiab_mask, vuf, vup, dv, re):
    """Interface penalty tau = -1/(Re v_last) rows (stacked [Nf, Nfq, K];
    reference dg2D_CNS_cavity_optimized.jl:817-840, with the special
    adiabatic-wall energy row via bc.penalty_energy_rows)."""
    dim = disc.dim
    tau = -1.0 / (re * vuf[dim + 1])
    rows = [jnp.zeros_like(dv[0])]
    for d in range(dim):
        rows.append(tau * dv[1 + d])
    if bc is not None and adiab_mask is not None:
        rows.append(bc.penalty_energy_rows(vuf, vup, dv, tau, adiab_mask))
    else:
        rows.append(tau * dv[dim + 1])
    return jnp.stack(rows)
