"""Volume flux differencing: QF_i = sum_j 2 A_ij . F(q_i, q_j).

This is the hot loop of every entropy-stable RHS (reference
dense_hadamard_sum dg2D_euler_tri.jl:88-126, sparse_hadamard_sum
dg3D_euler_hex.jl:122-164, flux_differencing!
dg2D_CNS_cavity_optimized.jl:326-347).

Design: instead of the reference's per-element scalar loops with
skew-symmetry halving and scatter accumulation, we compute the all-pairs
two-point fluxes as broadcast elementwise ops over [Nh, Nh, K] and
contract against the (element-scaled) skew operators.  Recompute
replaces scatter; the zero face-face block of the skew operators makes
those pairs contribute exactly zero, so no index gymnastics are needed
for correctness.  This is the path for modal (simplex) elements and the
plain reference the line-sparse path (tensor_product_fd) is tested
against.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..physics.euler import ec_flux


def flux_differencing_xla(qh, qlog, q_skew, geo, gamma, flux_fn=None):
    """All-pairs flux differencing via XLA broadcasting.

    Args:
      qh:    [Nf, Nh, K] flux variables (rho, u_1..d, beta) at hybridized
             points.
      qlog:  [2, Nh, K] precomputed (log rho, log beta).
      q_skew: tuple of dim [Nh, Nh] skew-symmetric hybridized operators.
      geo:   [dim*dim, Ng, K] geometric factors at hybridized points;
             Ng = 1 for affine elements, Ng = Nh for curved (uses the
             pointwise average (geo_i + geo_j)/2, reference
             dg3D_euler_hex.jl:146).
      gamma: ratio of specific heats.

    Returns QF: [Nf, Nh, K] with QF[f,i,k] = sum_j 2 A^d_ij F^d_f(q_i,q_j),
    where A^d = sum_r geo[r,d] * q_skew[r].
    """
    dim = len(q_skew)
    nh = qh.shape[1]
    flux_fn = ec_flux if flux_fn is None else flux_fn

    qi = qh[:, :, None, :]      # [Nf, Nh, 1, K]
    qj = qh[:, None, :, :]      # [Nf, 1, Nh, K]
    li = qlog[:, :, None, :] if qlog is not None else None
    lj = qlog[:, None, :, :] if qlog is not None else None
    fluxes = flux_fn(qi, qj, li, lj, gamma)  # dim x [Nf, Nh, Nh, K]

    curved = geo.shape[1] != 1
    qf = None
    for rdir in range(dim):
        a = q_skew[rdir][None, :, :, None]                # [1, Nh, Nh, 1]
        for xdir in range(dim):
            g = geo[rdir * dim + xdir]                    # [Ng, K]
            if curved:
                gavg = 0.5 * (g[:, None, :] + g[None, :, :])  # [Nh, Nh, K]
                contrib = jnp.sum(a * gavg[None] * fluxes[xdir], axis=2)
            else:
                contrib = jnp.sum(a * fluxes[xdir], axis=2) * g[None]
            qf = contrib if qf is None else qf + contrib
    return 2.0 * qf
