"""Compile a structured neighbor exchange out of the mapP gather.

The generic trace exchange is ``jnp.take(flat, map_p)`` — an arbitrary
gather along the element axis.  But on the uniform grids every workload
here uses, mapP is not arbitrary: all elements of the same "kind" (e.g. the
lower/upper triangles of a grid cell) see their neighbor at the same
element-index offset.  This module discovers that structure on the
host, at setup time, directly from mapP — no assumptions about the
generator beyond gridness:

  for each target face f, group the K columns by the pattern
      (source node rows, element offset)
  of the neighbor they read; if only a few patterns exist (interior
  kind(s), periodic wraps, boundary self-reads), the exchange becomes

      out[face] = select_k  masked  roll(uf[perm_rows], -offset)

  — static element-axis rolls and row picks, no gather at all.

Falls back to None (caller keeps the gather) for genuinely
unstructured meshes.  The fully-periodic-hex fast path in
Discretization.gather_traces (grid_shape) is the special case this
generalizes; tri/quad grids and partially periodic hex grids (e.g. the
3D shocktube) compile here.

Reference counterpart: none — the reference's exchange is the Julia
array gather ``x[mapP]`` (src/node_map_functions.jl); this is its
gather-free re-expression.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

MAX_PATTERNS_PER_FACE = 8


def compile_roll_plan(map_p_rm: np.ndarray, nfp: int,
                      max_patterns: int = MAX_PATTERNS_PER_FACE):
    """Host-side analysis of row-major mapP [Nfq, K] (node*K + elem).

    Returns (plan, masks) or None.
      plan:  tuple per face of tuples (perm_rows, offset) — static.
      masks: tuple per face of bool [K] arrays aligned with plan
             (masks of a face partition the element axis).
    """
    map_p = np.asarray(map_p_rm)
    nfq, k = map_p.shape
    if nfq % nfp:
        return None
    nfaces = nfq // nfp
    node = map_p // k                      # source node row [Nfq, K]
    elem = map_p % k                       # source element  [Nfq, K]
    cols = np.arange(k)

    plan = []
    masks = []
    for f in range(nfaces):
        rows = slice(f * nfp, (f + 1) * nfp)
        src = node[rows]                   # [nfp, K]
        # all nodes of a face read the same neighbor element
        if (elem[rows] != elem[f * nfp][None]).any():
            return None
        off = (elem[f * nfp] - cols) % k   # forward offset in [0, K)
        # pattern id per column: (src rows tuple, offset)
        key = np.concatenate([src, off[None]], axis=0)  # [nfp+1, K]
        _, inv = np.unique(key, axis=1, return_inverse=True)
        n_pat = inv.max() + 1
        if n_pat > max_patterns:
            return None
        f_plan = []
        f_masks = []
        for p in range(n_pat):
            m = inv == p
            col0 = int(np.argmax(m))
            perm = tuple(int(v) for v in src[:, col0])
            o = int(off[col0])
            f_plan.append((perm, o))
            f_masks.append(m)
        plan.append(tuple(f_plan))
        masks.append(tuple(f_masks))
    return tuple(plan), tuple(masks)


def apply_roll_plan(plan, masks, uf: jnp.ndarray) -> jnp.ndarray:
    """Execute a compiled plan: uf [..., Nfq, K] -> neighbor traces.

    Static row permutations are lowered WITHOUT gathers: the perms a
    structured mesh produces are contiguous runs (ascending = partner
    face block, descending = orientation-reversed partner).  Ascending
    runs are static slices; descending runs are ascending slices of
    ONE shared flip of the whole trace block (computed lazily, at most
    one reverse per exchange instead of one per face-pattern);
    anything else becomes single-row slices + one concat.  XLA fuses
    all of these, while `uf[..., perm, :]` lowers to a gather.

    Same contract as the generic mapP gather (and bit-identical to it:
    tests/test_roll_exchange.py)."""
    nfq = uf.shape[-2]
    rev = None

    def permute(perm):
        nonlocal rev
        n = len(perm)
        if perm == tuple(range(perm[0], perm[0] + n)):
            return uf[..., perm[0]:perm[0] + n, :]
        if perm == tuple(range(perm[0], perm[0] - n, -1)):
            if rev is None:
                rev = jnp.flip(uf, axis=-2)
            start = nfq - 1 - perm[0]
            return rev[..., start:start + n, :]
        return jnp.concatenate([uf[..., i:i + 1, :] for i in perm],
                               axis=-2)

    outs = []
    for f_plan, f_masks in zip(plan, masks):
        acc = None
        for (perm, off), m in zip(f_plan, f_masks):
            src = permute(perm)
            rolled = jnp.roll(src, -off, axis=-1) if off else src
            acc = rolled if acc is None else jnp.where(m, rolled, acc)
        outs.append(acc)
    return jnp.concatenate(outs, axis=-2)
