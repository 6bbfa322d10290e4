"""Explicit ring halo exchange for slab-decomposed element axes.

The pjit/SPMD path (sharding.py) lets XLA turn the global trace gather
into collectives.  This module is the explicitly-scheduled alternative:
elements are partitioned into contiguous slabs (the uniform mesh
generators emit x-fastest ordering, so contiguous chunks are slabs along
the last coordinate); the only cross-device data dependence is then a
nearest-neighbor exchange of boundary face-node traces, implemented as
two ring ``lax.ppermute`` sends — the direct analogue of the reference's
``x[mapP]`` neighbor indexing (SURVEY.md 2.4).

Host-side setup splits the global gather table into
  * a local gather into [own traces | recv-from-left | recv-from-right],
  * replicated send-index patterns (verified identical across devices —
    true for uniform meshes with aligned slabs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.discretization import Discretization
from ..utils.pytree import pytree_dataclass


@pytree_dataclass(meta_fields=("axis_name", "n_devices", "n_send"))
class HaloExchange:
    axis_name: str
    n_devices: int
    n_send: int
    send_left: jnp.ndarray    # int32 [n_send] into local flat traces
    send_right: jnp.ndarray   # int32 [n_send]
    table: jnp.ndarray        # int32 [Nfq, K_global] into extended buffer

    def gather(self, uf: jnp.ndarray) -> jnp.ndarray:
        """Neighbor traces inside shard_map; uf [..., Nfq, K_local]."""
        lead = uf.shape[:-2]
        nfq, kloc = uf.shape[-2:]
        flat = uf.reshape(*lead, nfq * kloc)
        to_left = jnp.take(flat, self.send_left, axis=-1)
        to_right = jnp.take(flat, self.send_right, axis=-1)
        n = self.n_devices
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        recv_left = jax.lax.ppermute(to_right, self.axis_name, perm=fwd)
        recv_right = jax.lax.ppermute(to_left, self.axis_name, perm=bwd)
        buf = jnp.concatenate([flat, recv_left, recv_right], axis=-1)
        out = jnp.take(buf, self.table.reshape(-1), axis=-1)
        return out.reshape(*lead, nfq, kloc)


def build_halo_exchange(disc: Discretization, n_devices: int,
                        axis_name: str = "e") -> HaloExchange:
    """Split the global mapP into local gather + ring-exchange patterns."""
    k = disc.num_elements
    nfq = disc.nfq
    if k % n_devices != 0:
        raise ValueError(f"K={k} not divisible by {n_devices} devices")
    kloc = k // n_devices

    map_p = np.asarray(disc.map_p)            # [Nfq, K], values node*K+elem
    node_g, elem_g = np.divmod(map_p, k)

    owner = elem_g // kloc                    # device owning the source
    my_dev = np.arange(k)[None, :] // kloc    # device owning the target

    rel = (owner - my_dev) % n_devices
    if not np.all((rel == 0) | (rel == 1) | (rel == n_devices - 1)):
        raise ValueError(
            "slab partition has non-neighbor couplings; use fewer devices "
            "or reorder elements"
        )
    local_flat = node_g * kloc + (elem_g - owner * kloc)  # id within owner

    send_right_per_dev = []   # ids I must send to my right neighbor
    send_left_per_dev = []
    for d in range(n_devices):
        cols = slice(d * kloc, (d + 1) * kloc)
        from_left = np.unique(
            local_flat[:, cols][rel[:, cols] == n_devices - 1]
        ) if n_devices > 1 else np.array([], np.int64)
        from_right = np.unique(local_flat[:, cols][rel[:, cols] == 1]) \
            if n_devices > 1 else np.array([], np.int64)
        # what device d receives from its left neighbor is what that
        # neighbor sends right: record the pattern per-sender
        send_right_per_dev.append(from_left)   # left neighbor sends these
        send_left_per_dev.append(from_right)   # right neighbor sends these

    # SPMD needs ONE send pattern shared by all devices: take the union
    # of every receiver's expectation.  Periodic uniform meshes have
    # identical per-device patterns (union is a no-op); wall-BC meshes
    # differ at the boundary slabs (their boundary faces self-map
    # instead of wrapping), so some union slots go unused by some
    # receivers — harmless, they are simply never indexed by the table.
    def _union(parts):
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.array([], np.int64)
        return np.unique(np.concatenate(parts))

    send_right = _union(send_right_per_dev)
    send_left = _union(send_left_per_dev)

    n_send = max(len(send_right), len(send_left), 1)
    pad = lambda a: np.pad(a, (0, n_send - len(a)), constant_values=0)
    send_right_p = pad(send_right)
    send_left_p = pad(send_left)

    table = np.empty_like(map_p)
    base = nfq * kloc
    m0 = rel == 0
    m_left = rel == n_devices - 1
    m_right = rel == 1
    table[m0] = local_flat[m0]
    if n_devices > 1:
        # unique() output is sorted, so positions come from searchsorted
        table[m_left] = base + np.searchsorted(send_right, local_flat[m_left])
        table[m_right] = base + n_send + np.searchsorted(
            send_left, local_flat[m_right]
        )

    return HaloExchange(
        axis_name=axis_name,
        n_devices=n_devices,
        n_send=n_send,
        send_left=jnp.asarray(send_left_p, jnp.int32),
        send_right=jnp.asarray(send_right_p, jnp.int32),
        table=jnp.asarray(table, jnp.int32),
    )
