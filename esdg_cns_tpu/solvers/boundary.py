"""Entropy-stable wall boundary conditions via ghost states.

The reference imposes BCs by mutating the gathered neighbor traces at
precomputed boundary index sets (init_BC_funs,
dg2D_CNS_cavity_optimized.jl:135-265).  Equivalent here: boolean
region masks [Nfq, K] and ghost states blended in with jnp.where — no
scatter, fully vectorized, jit-stable.

``Region`` and ``WallBC`` are JAX pytrees: every array field (masks,
normals, wall-velocity profiles) is a leaf, so the whole BC bundle
shards along the element axis exactly like the state — this is what
lets wall-BC problems run on the explicit shard_map halo path
(parallel/sharding.py) as well as under pjit.  Construct with
``make_wall_bc`` (host-side coverage check).

Three hooks, applied at the reference's three interface stages:
  * inviscid: mirror-velocity ghost on the (rho, u, beta) traces
    (impose_BCs_inviscid!, :157-176);
  * entropy variables: adiabatic / isothermal no-slip and reflective
    ghosts on the BR1 gradient traces (impose_BCs_entropyvars!,
    :178-216);
  * stress: ghost viscous stresses encoding zero heat flux / wall work
    (impose_BCs_stress!, :218-262).

Wall kinds: 'adiabatic' (no-slip, zero heat flux), 'isothermal'
(no-slip, fixed wall temperature via theta = cv*T_w), 'slip'
(reflective), 'dirichlet' (far-field state, for the shocktube drivers).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..core.discretization import Discretization
from ..utils.pytree import pytree_dataclass


@pytree_dataclass(meta_fields=("kind", "state", "entropy_state",
                               "stress_state"))
class Region:
    """One boundary region (a JAX pytree; mask and profiles are leaves).

    mask: bool [Nfq, K]; kind: wall type; u_wall: tangential wall
    velocity components (scalars or [Nfq, K] arrays, e.g. the cavity lid
    or the regularized lid profile of the convergence test); theta:
    cv * T_wall for isothermal walls.  For 'dirichlet' regions the
    static callables give the ghost traces: ``state(t)`` the stacked
    flux variables, ``entropy_state(t)`` the entropy-variable traces
    for the BR1 gradient stage (defaults to ``state`` if absent), and
    ``stress_state(t)`` the ghost stresses (defaults to natural).
    Dirichlet callables close over global-shaped arrays and are
    therefore supported on the pjit path only, not under shard_map.
    """

    mask: jnp.ndarray
    kind: str
    u_wall: tuple = (0.0, 0.0, 0.0)
    theta: Optional[float] = None
    state: Optional[Callable] = None
    entropy_state: Optional[Callable] = None
    stress_state: Optional[Callable] = None


def region_from_indicator(disc: Discretization, indicator, kind, **kw) -> Region:
    """Build a Region by evaluating a coordinate indicator on face nodes."""
    coords = [np.asarray(c) for c in disc.xf]
    mask = np.asarray(indicator(*coords), dtype=bool)
    mask &= np.asarray(disc.bmask)
    return Region(mask=jnp.asarray(mask), kind=kind, **kw)


@pytree_dataclass(meta_fields=("dim",))
class WallBC:
    """Bundle of the three ghost-state hooks for a set of wall regions.

    A frozen pytree: ``regions`` (tuple of Region), ``nhat`` (unit
    outward normals, dim x [Nfq, K]) and ``bmask`` are leaves sharded
    along K like every other trace array.  Build via ``make_wall_bc``.
    """

    regions: tuple
    nhat: tuple
    bmask: jnp.ndarray
    dim: int

    # -- helpers ---------------------------------------------------------
    def _mirror_normal(self, vec, mask):
        """v -> v - 2 (v.n) n on masked nodes (vec: list of [Nfq,K])."""
        dim = self.dim
        vn = sum(vec[d] * self.nhat[d] for d in range(dim))
        return [
            jnp.where(mask, vec[d] - 2.0 * vn * self.nhat[d], vec[d])
            for d in range(dim)
        ]

    # -- hooks -----------------------------------------------------------
    def inviscid(self, disc, qm, qp, um, up, t=0.0):
        """Ghost for the (rho, u_1..d, beta) traces.

        No-slip/slip walls: rho+ = rho-, beta+ = beta-, u+ = mirror(u-).
        Dirichlet: the far-field state.
        """
        dim = disc.dim
        for r in self.regions:
            m = r.mask
            if r.kind == "dirichlet":
                qbc = r.state(t)  # stacked [Nf, Nfq, K] flux variables
                qp = jnp.where(m[None], qbc, qp)
                continue
            vel = [qp[1 + d] for d in range(dim)]
            # start from the interior trace, then mirror
            vel_in = [jnp.where(m, qm[1 + d], v) for d, v in enumerate(vel)]
            vel_out = self._mirror_normal(vel_in, m)
            rows = [jnp.where(m, qm[0], qp[0])]
            rows += vel_out
            rows += [jnp.where(m, qm[dim + 1], qp[dim + 1])]
            qp = jnp.stack(rows)
        return qp, up

    def entropy_vars(self, disc, vuf, vup, t=0.0):
        """Ghost entropy-variable traces for the BR1 gradient."""
        dim = disc.dim
        for r in self.regions:
            m = r.mask
            if r.kind == "dirichlet":
                src = r.entropy_state if r.entropy_state is not None else r.state
                vup = jnp.where(m[None], src(t), vup)
                continue
            if r.kind == "slip":
                vmom = [jnp.where(m, vuf[1 + d], vup[1 + d]) for d in range(dim)]
                vmom = self._mirror_normal(vmom, m)
                rows = [vup[0]] + vmom + [
                    jnp.where(m, vuf[dim + 1], vup[dim + 1])]
                vup = jnp.stack(rows)
                continue
            if r.kind == "adiabatic":
                # v_mom+ = -v_mom- + 2 u_wall * (-v4-): enforces u = u_wall
                # at the interface average; v4+ = v4- (zero heat flux)
                rows = [vup[0]]
                for d in range(dim):
                    target = r.u_wall[d] * (-vuf[dim + 1])
                    rows.append(
                        jnp.where(m, 2.0 * target - vuf[1 + d], vup[1 + d])
                    )
                rows.append(jnp.where(m, vuf[dim + 1], vup[dim + 1]))
                vup = jnp.stack(rows)
                continue
            if r.kind == "isothermal":
                # wall state: v_mom = u_wall/theta, v4 = -1/theta
                th = r.theta
                rows = [vup[0]]
                for d in range(dim):
                    rows.append(
                        jnp.where(
                            m, 2.0 * r.u_wall[d] / th - vuf[1 + d], vup[1 + d]
                        )
                    )
                rows.append(
                    jnp.where(m, -2.0 / th - vuf[dim + 1], vup[dim + 1]))
                vup = jnp.stack(rows)
                continue
            raise ValueError(f"unknown wall kind {r.kind!r}")
        return vup

    def stress(self, disc, s_f, s_p, vuf, t=0.0):
        """Ghost stress traces (tuples over directions of [Nf, Nfq, K]).

        Adiabatic: momentum stresses pass through, energy stress
        reflects with 2 u_wall . tau added (wall does work, no heat
        flux).  Isothermal: natural (sigma+ = sigma-).  Slip: mirror the
        traction, reflect the energy row.
        """
        dim = disc.dim
        new_sp = []
        for xdir in range(dim):
            sp = s_p[xdir]
            sf = s_f[xdir]
            for r in self.regions:
                m = r.mask
                if r.kind == "dirichlet" and r.stress_state is not None:
                    sp = jnp.where(m[None], r.stress_state(t)[xdir], sp)
                    continue
                if r.kind == "dirichlet" or r.kind == "isothermal":
                    # natural: sigma+ = sigma-
                    sp = jnp.where(m[None], sf, sp)
                    continue
                if r.kind == "adiabatic":
                    rows = [sp[0]]
                    for d in range(dim):
                        rows.append(jnp.where(m, sf[1 + d], sp[1 + d]))
                    work = sum(
                        2.0 * r.u_wall[d] * sf[1 + d] for d in range(dim)
                    )
                    rows.append(
                        jnp.where(m, -sf[dim + 1] + work, sp[dim + 1]))
                    sp = jnp.stack(rows)
                    continue
                if r.kind == "slip":
                    # traction components mirror: s+ = -s- + 2 n (s.n)
                    smom = [jnp.where(m, sf[1 + d], sp[1 + d]) for d in range(dim)]
                    sn = sum(smom[d] * self.nhat[d] for d in range(dim))
                    rows = [sp[0]]
                    for d in range(dim):
                        rows.append(
                            jnp.where(
                                m, -smom[d] + 2.0 * self.nhat[d] * sn, sp[1 + d]
                            )
                        )
                    rows.append(jnp.where(m, -sf[dim + 1], sp[dim + 1]))
                    sp = jnp.stack(rows)
                    continue
            new_sp.append(sp)
        return tuple(new_sp)

    def stress_normal(self, disc, t_f, t_ex, t=0.0):
        """Normal-contracted ghost traction sum_x s_p[x] nxj_m[x]
        from the LOCAL contraction t_f = sum_x s_f[x] nxj_m[x] and
        the EXCHANGED neighbor contraction t_ex = sum_x s_p[x]
        nxj_p[x] (comm-avoiding: only the contraction crosses the
        exchange; conforming faces carry negated normals, so interior
        faces read -t_ex).  Every wall kind of `stress` commutes with
        the contraction — each is a linear map on the stress
        components with coefficients constant across directions — so
        the ghost rules below are the contracted images of the
        component rules (reference impose_BCs_stress!,
        dg2D_CNS_cavity_optimized.jl:219-260):

          dirichlet/isothermal: natural, t_pn = t_f;
          adiabatic: momentum rows pass, energy reflects with
            2 u_wall . traction added;
          slip: traction mirrors about nhat, energy reflects.
        """
        dim = self.dim
        # base rule: interior -t_ex; self-mapped boundary faces not
        # covered by any region stay natural (t_f, zero jump) — the
        # self-gather would otherwise flip the traction sign there
        t_pn = jnp.where(disc.bmask[None], t_f, -t_ex)
        for r in self.regions:
            m = r.mask
            if r.kind == "dirichlet" and r.stress_state is not None:
                st = r.stress_state(t)
                contr = sum(st[x] * disc.nxj[x][None] for x in range(dim))
                t_pn = jnp.where(m[None], contr, t_pn)
                continue
            if r.kind in ("dirichlet", "isothermal"):
                t_pn = jnp.where(m[None], t_f, t_pn)
                continue
            if r.kind == "adiabatic":
                rows = [jnp.where(m, t_f[0], t_pn[0])]
                for d in range(dim):
                    rows.append(jnp.where(m, t_f[1 + d], t_pn[1 + d]))
                work = sum(2.0 * r.u_wall[d] * t_f[1 + d]
                           for d in range(dim))
                rows.append(
                    jnp.where(m, -t_f[dim + 1] + work, t_pn[dim + 1]))
                t_pn = jnp.stack(rows)
                continue
            if r.kind == "slip":
                tmom = [jnp.where(m, t_f[1 + d], t_pn[1 + d])
                        for d in range(dim)]
                tn = sum(tmom[d] * self.nhat[d] for d in range(dim))
                rows = [jnp.where(m, t_f[0], t_pn[0])]
                for d in range(dim):
                    rows.append(jnp.where(
                        m, -tmom[d] + 2.0 * self.nhat[d] * tn,
                        t_pn[1 + d]))
                rows.append(jnp.where(m, -t_f[dim + 1], t_pn[dim + 1]))
                t_pn = jnp.stack(rows)
                continue
            raise ValueError(f"unknown wall kind {r.kind!r}")
        return t_pn

    def penalty_energy_rows(self, vuf, vup, dv, tau, adiabatic_mask):
        """Boundary override of the viscous-penalty energy row
        (dg2D_CNS_cavity_optimized.jl:827-837)."""
        avg2 = 0.5 * (vup + vuf)
        bmask = self.bmask
        last = self.dim + 1
        base = sum(avg2[1 + d] * dv[1 + d] for d in range(self.dim))
        full = base + 0.5 * dv[last] * dv[last]
        num = jnp.where(adiabatic_mask, base, full)
        return jnp.where(bmask, -tau * num / vuf[last], tau * dv[last])


def make_wall_bc(disc: Discretization, regions: Sequence[Region]) -> WallBC:
    """Assemble a WallBC bundle; checks every boundary node is covered."""
    covered = np.zeros(np.asarray(disc.bmask).shape, dtype=bool)
    for r in regions:
        covered |= np.asarray(r.mask)
    missing = np.asarray(disc.bmask) & ~covered
    if missing.any():
        raise ValueError(
            f"{missing.sum()} boundary face nodes not covered by any region"
        )
    nhat = tuple(n * disc.inv_sj for n in disc.nxj)
    return WallBC(regions=tuple(regions), nhat=nhat, bmask=disc.bmask,
                  dim=disc.dim)
