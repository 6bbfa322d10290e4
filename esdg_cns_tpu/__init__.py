"""esdg_cns_tpu — an entropy-stable modal DG framework for the
compressible Euler / Navier-Stokes equations in JAX.

Re-designed from scratch for JAX/XLA/pjit with the capabilities of the
reference Julia research code yiminllin/ESDG-CNS (entropy stable modal DG
schemes and wall boundary conditions for compressible Navier-Stokes,
Lin & Chan, arXiv:2011.11089).

Architecture (accelerator-first, not a port):
  * All reference-element / mesh / operator setup happens host-side in
    NumPy float64 and is frozen into small static matrices plus
    ``[.., K]``-shaped device arrays (element axis last, the axis that is
    vectorized over and sharded).
  * The semi-discrete RHS is a single jitted function composed of
    einsum operator applications (matrix units), vectorized entropy
    projection, flux differencing (line-sparse on collocated hexes,
    all-pairs otherwise), and mask-blend boundary conditions (no
    scatter).
  * Multi-chip runs shard the element axis over a ``jax.sharding.Mesh``
    with ``shard_map``; the only cross-element dependence (the ``mapP``
    face-trace gather) becomes a nearest-neighbor ``ppermute`` halo
    exchange, and global diagnostics become ``psum``.
"""

__version__ = "0.1.0"

GAMMA = 1.4
