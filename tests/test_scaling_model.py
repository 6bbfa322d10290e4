"""Exchange accounting: the payloads must be the ones the production RHS
builders actually ship (pinning the comm-avoiding designs), and the
boundary size must come from the real halo pattern."""

import jax

from esdg_cns_tpu.core import build_discretization, ref_tri
from esdg_cns_tpu.mesh import uniform_tri_mesh
from esdg_cns_tpu.parallel import (
    build_halo_exchange,
    halo_bytes_per_rhs,
    measure_exchange_rows,
)
from esdg_cns_tpu.presets import euler_hex_3d, lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs, make_euler_rhs


def _tri_euler(k1d=4, n=2):
    vx, vy, etov = uniform_tri_mesh(k1d)
    disc = build_discretization(ref_tri(n), (vx, vy), etov,
                                periodic_axes=(0, 1))
    sh = (disc.np_, disc.num_elements)
    q0 = jax.ShapeDtypeStruct((4, *sh), disc.wq.dtype)
    return disc, q0


def test_euler_payload_is_qm_plus_logs_2d():
    # comm-avoiding inviscid exchange: (rho,u,v,beta) + 2 logs = 6 rows
    disc, q0 = _tri_euler()
    rows = measure_exchange_rows(make_euler_rhs, disc, q0,
                                 dissipation=True)
    assert rows == [6]


def test_euler_payload_3d():
    disc, q0 = euler_hex_3d(n=2, k1d=2)
    q0 = jax.ShapeDtypeStruct(q0.shape, q0.dtype)
    rows = measure_exchange_rows(make_euler_rhs, disc, q0,
                                 dissipation=True)
    assert rows == [7]  # (rho,u,v,w,beta) + 2 logs


def test_cns_payload_two_exchanges_2d():
    # exchange 1: qm+logs (6); exchange 2: contracted traction (Nf=4)
    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4)
    q0 = jax.ShapeDtypeStruct(q0.shape, q0.dtype)
    rows = measure_exchange_rows(
        make_cns_rhs, disc, q0, mu=p["mu"], pr=p["pr"], re=p["re"],
        bc=bc, inviscid_dissipation=True, viscous_dissipation=True,
    )
    assert rows == [6, 4]


def test_halo_bytes_consistent_with_pattern():
    disc, _ = _tri_euler(k1d=4)
    he = build_halo_exchange(disc, 2)
    out = halo_bytes_per_rhs(disc, [6], n_devices=2)
    assert out["bytes_per_direction"] == 6 * he.n_send * 4
    assert out["bytes_total"] == 2 * out["bytes_per_direction"]
    # slab boundary is one element-plane: n_send scales with k1d
    disc8, _ = _tri_euler(k1d=8)
    out8 = halo_bytes_per_rhs(disc8, [6], n_devices=2)
    assert out8["n_send_traces"] == 2 * out["n_send_traces"]


def test_slab_boundary_independent_of_device_count():
    # for n >= 3 the per-direction payload is one slab boundary plane;
    # n = 2 is the degenerate ring (both neighbors are the same device,
    # two planes per direction)
    disc, _ = _tri_euler(k1d=8)
    b4 = halo_bytes_per_rhs(disc, [6], n_devices=4)
    b8 = halo_bytes_per_rhs(disc, [6], n_devices=8)
    b2 = halo_bytes_per_rhs(disc, [6], n_devices=2)
    assert b4["n_send_traces"] == b8["n_send_traces"]
    assert b2["n_send_traces"] == 2 * b4["n_send_traces"]
