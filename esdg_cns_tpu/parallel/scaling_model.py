"""Exchange accounting for the element-axis decomposition: the rows
each RHS ships and the bytes that cross a slab boundary, counted from
the implementation's REAL exchange patterns (device-independent).

1. **The payload is measured, not estimated.**
   :func:`measure_exchange_rows` wraps the production RHS builders'
   ``gather_fn`` hook and traces one RHS abstractly (``jax.eval_shape``
   — no compute), recording exactly which rows cross the element-axis
   boundary per evaluation.  The comm-avoiding designs (qm+logs
   exchange, contracted Nf-row stress exchange — see docs/design.md)
   are therefore reflected automatically, and the tests pin the counts
   so a payload regression fails CI.

2. **The boundary size comes from the real decomposition.**
   :func:`halo_bytes_per_rhs` builds the actual
   :func:`~esdg_cns_tpu.parallel.halo.build_halo_exchange` for the
   slab partition and reads its ``n_send`` — the number of face-trace
   values per row each device ships per direction under the ring
   ``ppermute`` — rather than assuming a surface/volume ratio.

Times are not modelled here: exchange time comes from a profiler trace
of the sharded run on the devices themselves.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import jax
import jax.numpy as jnp

from ..core.discretization import Discretization
from .halo import build_halo_exchange


def measure_exchange_rows(
    build_rhs: Callable[..., Callable],
    disc: Discretization,
    q0: jnp.ndarray,
    **builder_kw,
) -> List[int]:
    """Rows shipped by each neighbor exchange of one RHS evaluation.

    ``build_rhs(disc, gather_fn=..., **builder_kw)`` must return
    ``rhs(q, t)``; every array handed to ``gather_fn`` is an exchange
    payload of shape ``[rows..., Nfq, K]``.  The RHS is traced
    abstractly (no FLOPs run), so this is cheap even at production
    sizes.  Returns one entry per gather call: the product of the
    leading (row) dimensions.
    """
    rows: List[int] = []

    def spy(uf):
        rows.append(int(math.prod(uf.shape[:-2])) or 1)
        return disc.gather_traces(uf)

    rhs = build_rhs(disc, gather_fn=spy, **builder_kw)
    jax.eval_shape(lambda q: rhs(q, 0.0), q0)
    return rows


def halo_bytes_per_rhs(
    disc: Discretization,
    rows_per_exchange: Sequence[int],
    *,
    n_devices: int = 4,
    itemsize: int = 4,
) -> Dict[str, float]:
    """Bytes each device ships to its ring neighbours per RHS for a slab
    partition.

    Uses the production :func:`build_halo_exchange` pattern: per
    exchange, each device sends ``rows * n_send`` values to each ring
    neighbor.
    ``n_devices`` only selects a valid partition to analyze — for slab
    decompositions the boundary plane (hence ``n_send``) is the same
    for every n >= 3 that divides K (n = 2 degenerately doubles it:
    both ring neighbors are the same device).
    """
    he = build_halo_exchange(disc, n_devices)
    rows = int(sum(rows_per_exchange))
    per_dir = rows * he.n_send * itemsize
    return {
        "n_send_traces": int(he.n_send),
        "rows_total": rows,
        "n_exchanges": len(rows_per_exchange),
        "bytes_per_direction": float(per_dir),
        "bytes_total": float(2 * per_dir),
    }
