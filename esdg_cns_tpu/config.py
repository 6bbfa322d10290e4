"""Typed configuration + one-call simulation runner.

The reference configures runs with top-of-script globals (N, K1D, CFL,
T, BCTYPE, TESTCASE, dissipation booleans, gamma/Ma/mu/lambda/Pr/Re —
dg2D_CNS_cavity_optimized.jl:21-36).  Here the same knobs form a typed
config (SURVEY.md section 5 'config/flag system' row) consumed by
``run_simulation``, which assembles mesh -> discretization -> RHS ->
stepper and returns the final state plus diagnostics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import numpy as np

from .core import build_discretization, make_ref_elem
from .mesh import (
    uniform_hex_mesh,
    uniform_line_mesh,
    uniform_quad_mesh,
    uniform_tri_mesh,
)


@dataclasses.dataclass
class SimConfig:
    # discretization
    equation: str = "euler"          # advection|wave|burgers|euler|cns
    elem_type: str = "tri"           # line|tri|quad|hex
    n: int = 3                       # polynomial degree
    k1d: int = 8                     # elements per direction
    periodic: bool = True
    node_type: Optional[str] = None  # quad/hex: 'gauss' (collocated) | 'lobatto'
    curved_map: Optional[Callable] = None

    # physics
    gamma: float = 1.4
    advection_velocity: Sequence[float] = (1.0, 0.5, 0.25)
    mach: float = 0.3
    reynolds: float = 1000.0
    mu: Optional[float] = None       # default 1/Re
    lam: Optional[float] = None      # default -2/3 mu
    prandtl: float = 0.71

    # scheme
    inviscid_dissipation: bool = True
    viscous_dissipation: bool = False
    flux_diff_impl: str = "auto"  # auto|xla|lines|lines_perm|lines_rot
    cns_volume_impl: str = "auto"  # CNS: auto|xla ('auto' = composed-
                                   # operator affine path when the mesh is
                                   # affine; 'xla' = the generic RHS)
    rhstest_mode: str = "native"   # native|compensated|f64 diagnostics

    # stepping
    stepper: str = "lsrk45"          # lsrk45|ssprk33|dopri45|implicit_midpoint
    implicit_precond: bool = True    # colored block-Jacobi for the
                                     # implicit stepper's GMRES
    cfl: float = 0.5
    t_end: float = 1.0
    dt: Optional[float] = None       # override the CFL heuristic
    err_tol: float = 1e-5            # dopri45

    # numerics
    dtype: Optional[object] = None

    def estimate_dt(self) -> float:
        if self.dt is not None:
            return self.dt
        cn = (self.n + 1) * (self.n + 2) / 2
        if self.elem_type == "hex":
            cn *= 3.0  # 3D trace constant (N+1)(N+2)*3/2, dg3D_advec_hex.jl:40
        h = 2.0 / self.k1d
        dt = self.cfl * h / cn
        if self.equation == "cns":
            dt = min(dt, 2.0 / (cn * self.k1d**2))  # parabolic restriction
        return dt


def build_problem(cfg: SimConfig, bc=None, device_mesh=None,
                  shard_axis: str = "e"):
    """Mesh + discretization + rhs from a config. Returns (disc, rhs).

    ``device_mesh`` (a ``jax.sharding.Mesh``): element-axis SPMD in one
    call — the Discretization's K-trailing leaves are sharded along
    ``shard_axis`` before the RHS closes over them, so every downstream
    jit (run_simulation's steppers included) partitions automatically;
    state built from the returned disc's arrays inherits the sharding.
    BC closures stay replicated (masks are small boundary constants).
    """
    kw = {} if cfg.node_type is None else {"node_type": cfg.node_type}
    ref = make_ref_elem(cfg.elem_type, cfg.n, **kw)
    if cfg.elem_type == "line":
        vx, etov = uniform_line_mesh(cfg.k1d)
        verts = (vx,)
    elif cfg.elem_type == "tri":
        vx, vy, etov = uniform_tri_mesh(cfg.k1d)
        verts = (vx, vy)
    elif cfg.elem_type == "quad":
        vx, vy, etov = uniform_quad_mesh(cfg.k1d)
        verts = (vx, vy)
    else:
        vx, vy, vz, etov = uniform_hex_mesh(cfg.k1d)
        verts = (vx, vy, vz)
    axes = tuple(range(ref.dim)) if cfg.periodic else ()
    disc = build_discretization(
        ref, verts, etov, periodic_axes=axes, curved_map=cfg.curved_map,
        dtype=cfg.dtype,
    )
    if device_mesh is not None:
        from .parallel.sharding import shard_discretization

        if disc.num_elements % device_mesh.devices.size != 0:
            raise ValueError(
                f"element count {disc.num_elements} not divisible by "
                f"{device_mesh.devices.size} devices")
        disc, _ = shard_discretization(device_mesh, shard_axis, disc)

    if cfg.equation == "advection":
        from .solvers import make_advection_rhs

        rhs = make_advection_rhs(disc, cfg.advection_velocity[: disc.dim])
    elif cfg.equation == "wave":
        from .solvers import make_wave_rhs

        rhs = make_wave_rhs(disc)
    elif cfg.equation == "burgers":
        from .solvers.burgers import make_burgers_rhs

        rhs = make_burgers_rhs(disc, dissipation=cfg.inviscid_dissipation)
    elif cfg.equation == "euler":
        from .solvers import make_euler_rhs

        rhs = make_euler_rhs(
            disc, gamma=cfg.gamma, dissipation=cfg.inviscid_dissipation,
            flux_diff_impl=cfg.flux_diff_impl,
            rhstest_mode=cfg.rhstest_mode,
            bc_fun=(None if bc is None else
                    (lambda d, qm, qp, um, up, t: bc.inviscid(d, qm, qp, um, up, t))),
        )
    elif cfg.equation == "cns":
        from .solvers import make_cns_rhs, make_cns_rhs_affine

        mu = cfg.mu if cfg.mu is not None else 1.0 / cfg.reynolds
        kw = dict(
            mu=mu, lam=cfg.lam, pr=cfg.prandtl, gamma=cfg.gamma,
            bc=bc, re=cfg.reynolds,
            inviscid_dissipation=cfg.inviscid_dissipation,
            viscous_dissipation=cfg.viscous_dissipation,
            rhstest_mode=cfg.rhstest_mode,
        )
        if cfg.cns_volume_impl not in ("auto", "xla"):
            raise ValueError(
                f"unknown cns_volume_impl {cfg.cns_volume_impl!r} "
                "(expected 'auto' or 'xla')")
        if cfg.cns_volume_impl == "auto" and disc.affine:
            rhs = make_cns_rhs_affine(
                disc, flux_diff_impl=cfg.flux_diff_impl, **kw)
        else:
            rhs = make_cns_rhs(
                disc, flux_diff_impl=cfg.flux_diff_impl, **kw,
            )
    else:
        raise ValueError(f"unknown equation {cfg.equation!r}")
    return disc, rhs


def run_simulation(cfg: SimConfig, q0, rhs, *, t0: float = 0.0, disc=None):
    """Integrate to cfg.t_end with the configured stepper (jitted).

    ``disc`` (optional) enables the colored block-Jacobi preconditioner
    for the implicit stepper (element coloring needs the gather table).
    """
    from .timestepping import dopri45, lsrk45, ssprk33
    from .timestepping.implicit import implicit_midpoint

    dt = cfg.estimate_dt()
    span = cfg.t_end - t0
    if cfg.stepper == "dopri45":
        fn = jax.jit(lambda q: dopri45(rhs, q, cfg.t_end, dt, t0=t0,
                                       err_tol=cfg.err_tol))
        return fn(q0)
    nsteps = max(int(np.ceil(span / dt)), 1)
    dt = span / nsteps
    if cfg.stepper == "lsrk45":
        fn = jax.jit(lambda q: lsrk45(rhs, q, dt, nsteps, t0=t0))
    elif cfg.stepper == "ssprk33":
        fn = jax.jit(lambda q: ssprk33(rhs, q, dt, nsteps, t0=t0))
    elif cfg.stepper == "implicit_midpoint":
        pk = {}
        if cfg.implicit_precond and disc is not None:
            from .timestepping.implicit import element_coloring

            pk = dict(precond_rhs=rhs, precond_colors=element_coloring(disc))
        fn = jax.jit(lambda q: implicit_midpoint(rhs, q, dt, nsteps, t0=t0,
                                                 **pk))
    else:
        raise ValueError(f"unknown stepper {cfg.stepper!r}")
    return fn(q0)
