"""Multi-chip execution: element-axis domain decomposition.

The reference is a serial code (SURVEY.md 2.4); its only cross-element
data dependence is the ``mapP`` face-trace gather.  The element axis K
(last axis of every array) is the sharding axis:

  * ``shard_discretization`` — pjit/SPMD path: annotate every leaf whose
    trailing axis is K with ``P(..., 'e')``, replicate the small
    reference operators, and let XLA's SPMD partitioner turn the trace
    gather into collectives and the diagnostics into cross-device
    reductions.  Zero code changes to the RHS.
  * ``make_sharded_rhs`` / halo machinery (shard_map + ppermute) — the
    explicitly-scheduled path for uniform slab decompositions,
    where each device owns a contiguous slab of elements and only
    exchanges boundary face traces with its ring neighbors.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.discretization import Discretization


# reference-operator / quadrature-weight fields of Discretization:
# ALWAYS replicated, even when a trailing dim coincidentally equals K
# (e.g. hex N=1, k1d=2 has Np == K == 8 — the shape heuristic alone
# would slice Vf across devices and break trace interpolation)
_REPLICATED_FIELDS = frozenset({
    "vq", "vf", "pq", "lift", "d", "q_skew", "vh", "ph", "vhp",
    "wq", "wf", "vp",
})


def _leaf_field_name(path):
    """Innermost dataclass attribute name on a key path (or None)."""
    for entry in reversed(path):
        name = getattr(entry, "name", None)
        if name is not None:
            return name
    return None


def shard_discretization(mesh: Mesh, axis: str, disc: Discretization,
                         q: Optional[jnp.ndarray] = None):
    """Place a Discretization (and optionally a state) on a device mesh.

    Every leaf with trailing dimension K is sharded along ``axis``;
    everything else (reference operators, quadrature weights) is
    replicated.  Returns (disc_sharded, q_sharded | None).
    """
    k = disc.num_elements

    def put(path, leaf):
        leaf = jnp.asarray(leaf)
        if (_leaf_field_name(path) not in _REPLICATED_FIELDS
                and leaf.ndim >= 1 and leaf.shape[-1] == k):
            spec = P(*([None] * (leaf.ndim - 1) + [axis]))
        else:
            spec = P()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    disc_s = jax.tree_util.tree_map_with_path(put, disc)
    if q is None:
        return disc_s, None
    q_s = jax.device_put(
        jnp.asarray(q), NamedSharding(mesh, P(None, None, axis))
    )
    return disc_s, q_s


def partition_specs(tree, k: int, axis: str):
    """PartitionSpec pytree: shard every leaf with trailing dim K
    (reference-operator fields always replicate, see
    ``_REPLICATED_FIELDS``)."""

    def spec(path, leaf):
        leaf = jnp.asarray(leaf)
        if (_leaf_field_name(path) not in _REPLICATED_FIELDS
                and leaf.ndim >= 1 and leaf.shape[-1] == k):
            return P(*([None] * (leaf.ndim - 1) + [axis]))
        return P()

    return jax.tree_util.tree_map_with_path(spec, tree)


def make_sharded_rhs(mesh: Mesh, disc: Discretization, builder,
                     axis: str = "e", **kw):
    """Wrap any RHS builder under shard_map with the explicit ppermute
    halo exchange (slab decomposition of the element axis).

    ``builder(disc, gather_fn=..., psum_axis=..., **kw) -> rhs``.
    Returns rhs(q, t=0.0) -> (dq, aux); q is the global [.., Np, K]
    state, re-sharded automatically by shard_map.

    Wall-BC problems: a ``bc=WallBC(...)`` keyword is itself a pytree
    whose [Nfq, K] leaves (region masks, normals, wall-velocity
    profiles) are sharded along the element axis like every other trace
    array, so each device applies the ghost-state hooks to its own slab.
    Restriction: 'dirichlet' regions whose state callables close over
    global-shaped arrays are pjit-path only (shard_discretization).
    """
    from jax import shard_map

    from .halo import build_halo_exchange

    n = mesh.shape[axis]
    bc = kw.pop("bc", None)
    if bc is not None:
        for r in bc.regions:
            if r.kind == "dirichlet":
                raise ValueError(
                    "dirichlet regions (global-state closures) are not "
                    "supported under shard_map; use the pjit path "
                    "(shard_discretization)"
                )
    halo = build_halo_exchange(disc, n, axis)
    k = disc.num_elements
    disc_specs = partition_specs(disc, k, axis)
    halo_specs = partition_specs(halo, k, axis)
    bc_specs = partition_specs(bc, k, axis)
    qspec = P(None, None, axis)

    def fn(q, t, disc_in, halo_in, bc_in):
        rhs = builder(disc_in, gather_fn=halo_in.gather, psum_axis=axis,
                      **(dict(bc=bc_in) if bc_in is not None else {}), **kw)
        return rhs(q, t)

    sm = shard_map(
        fn, mesh=mesh,
        in_specs=(qspec, P(), disc_specs, halo_specs, bc_specs),
        out_specs=(qspec, P()),
    )

    def rhs(q, t=0.0):
        return sm(q, jnp.asarray(t, q.dtype), disc, halo, bc)

    return rhs


def make_sharded_euler_rhs(mesh: Mesh, disc: Discretization, axis: str = "e",
                           **kw):
    """Sharded ES-DG Euler RHS (see make_sharded_rhs)."""
    from ..solvers.euler import make_euler_rhs

    return make_sharded_rhs(mesh, disc, make_euler_rhs, axis, **kw)


def make_sharded_cns_rhs(mesh: Mesh, disc: Discretization, axis: str = "e",
                         **kw):
    """Sharded CNS RHS, periodic or wall-BC (see make_sharded_rhs)."""
    from ..solvers.cns import make_cns_rhs

    return make_sharded_rhs(mesh, disc, make_cns_rhs, axis, **kw)


def make_sharded_cns_rhs_affine(mesh: Mesh, disc: Discretization,
                                axis: str = "e", **kw):
    """Sharded composed-operator affine CNS RHS, periodic or wall-BC
    (the production 2D/3D cavity path under shard_map)."""
    from ..solvers.cns_fused import make_cns_rhs_affine

    return make_sharded_rhs(mesh, disc, make_cns_rhs_affine, axis, **kw)

