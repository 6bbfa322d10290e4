"""First-order DG building blocks: strong-form gradient and divergence
with central (BR1) interface corrections.

Parity: reference dg_grad!/dg_div! (dg2D_CNS_cavity_optimized.jl:548-611)
and the nodal-DG volume/surface pattern of the advection/wave drivers
(dg1D_advec.jl:64-78, dg2D_advec_tri.jl, dg3D_advec_hex.jl:45-61).

All functions operate on stacked fields [..., Np, K] and return the same
layout; interface values are trace arrays [..., Nfq, K].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.discretization import Discretization


def _apply(mat, x):
    # HIGHEST: without it an f32 matmul may run in reduced precision
    # (TF32 on the GPU, ~3 digits), which visibly pollutes the entropy
    # balance; the operators are small so full f32 is cheap
    return jnp.einsum("ij,...jk->...ik", mat, x,
                      precision=jax.lax.Precision.HIGHEST)


def physical_derivatives(disc: Discretization, u):
    """Strong-form physical derivatives (times J): tuple over x-dirs of
    sum_r geo[r*dim+x] * (D_r u), shape like u."""
    dim = disc.dim
    du_ref = [_apply(d, u) for d in disc.d]
    out = []
    for xdir in range(dim):
        acc = None
        for rdir in range(dim):
            g = disc.geo_nodal[rdir * dim + xdir]  # [Ngn, K]
            term = g * du_ref[rdir]
            acc = term if acc is None else acc + term
        out.append(acc)
    return tuple(out)


def dg_grad(disc: Discretization, u, uf, up):
    """BR1 gradient: strong volume derivative + 1/2 LIFT of the jump.

    Args:
      u: [..., Np, K] nodal field; uf: trace [..., Nfq, K]; up: neighbor
        (or ghost) trace.
    Returns tuple over x-dirs of [..., Np, K].
    """
    vol = physical_derivatives(disc, u)
    out = []
    for xdir in range(disc.dim):
        surf = _apply(disc.lift, 0.5 * (up - uf) * disc.nxj[xdir])
        out.append((vol[xdir] + surf) * disc.inv_jac)
    return tuple(out)


def dg_div(disc: Discretization, flux_vols, flux_fs, flux_ps):
    """BR1 divergence of a vector field given per-direction components.

    Args:
      flux_vols: tuple over x-dirs of [..., Np, K].
      flux_fs / flux_ps: tuples of own/neighbor traces [..., Nfq, K].
    """
    acc = None
    jump_n = None
    for xdir in range(disc.dim):
        d = physical_derivatives(disc, flux_vols[xdir])[xdir]
        acc = d if acc is None else acc + d
        jn = 0.5 * (flux_ps[xdir] - flux_fs[xdir]) * disc.nxj[xdir]
        jump_n = jn if jump_n is None else jump_n + jn
    return (acc + _apply(disc.lift, jump_n)) * disc.inv_jac


def dg_div_contracted(disc: Discretization, flux_vols, jump_n):
    """dg_div with the interface jump already normal-contracted
    (jump_n [..., Nfq, K]) — the comm-avoiding stress-exchange form
    where only sum_x flux_x nxj_x crosses the exchange."""
    acc = None
    for xdir in range(disc.dim):
        d = physical_derivatives(disc, flux_vols[xdir])[xdir]
        acc = d if acc is None else acc + d
    return (acc + _apply(disc.lift, jump_n)) * disc.inv_jac
