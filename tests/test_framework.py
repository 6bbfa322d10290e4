"""Framework-level surfaces: typed config runner, checkpoint/resume,
metrics logging, NaN guard, convergence harness (tiny instance),
structured exchange equivalence."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esdg_cns_tpu.config import SimConfig, build_problem, run_simulation
from esdg_cns_tpu.physics import primitive_to_conservative
from esdg_cns_tpu.presets import euler_hex_3d
from esdg_cns_tpu.utils.checkpoint import CheckpointManager
from esdg_cns_tpu.utils.metrics import MetricsLogger, check_finite_or_raise, nan_guard
from esdg_cns_tpu.verification import wall_bc_convergence_study


def test_config_runner_advection():
    cfg = SimConfig(equation="advection", elem_type="line", n=3, k1d=8,
                    t_end=0.25, cfl=0.25)
    disc, rhs = build_problem(cfg)
    u0 = jnp.sin(jnp.pi * disc.x[0])
    uf, _ = run_simulation(cfg, u0, rhs)
    uex = jnp.sin(jnp.pi * (disc.x[0] - cfg.t_end))
    assert float(jnp.abs(uf - uex).max()) < 1e-3


def test_config_runner_euler_dopri():
    cfg = SimConfig(equation="euler", elem_type="tri", n=2, k1d=3,
                    t_end=0.01, stepper="dopri45")
    disc, rhs = build_problem(cfg)
    rng = np.random.default_rng(0)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.1 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    qf, stats = run_simulation(cfg, q0, rhs)
    assert float(stats["t"]) >= cfg.t_end - 1e-12
    assert np.isfinite(np.asarray(qf)).all()


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = {
        "q": jnp.arange(12.0).reshape(3, 4),
        "t": jnp.asarray(0.5),
        "step": 7,
    }
    mgr.save(7, state)
    assert mgr.latest_step() == 7
    restored = mgr.restore(template=state)
    np.testing.assert_allclose(np.asarray(restored["q"]), np.asarray(state["q"]))
    assert float(restored["t"]) == 0.5


def test_metrics_logger_inside_scan():
    logger = MetricsLogger()

    @jax.jit
    def run(x):
        def step(c, i):
            c = c * 0.5
            logger.log(step=i, value=jnp.sum(c))
            return c, None

        return jax.lax.scan(step, x, jnp.arange(4))[0]

    out = run(jnp.ones(3))
    jax.effects_barrier()
    assert len(logger.rows) == 4
    assert logger.history("value")[0] > logger.history("value")[-1]


def test_nan_guard():
    q = jnp.ones((2, 3))
    assert not bool(nan_guard(q))
    assert bool(nan_guard(q.at[0, 0].set(jnp.nan)))
    check_finite_or_raise(q)
    try:
        check_finite_or_raise(q.at[0, 0].set(jnp.inf))
        raise AssertionError("should have raised")
    except FloatingPointError:
        pass


def test_wall_bc_convergence_harness_smoke(tmp_path):
    out = tmp_path / "err.json"
    res = wall_bc_convergence_study(
        orders=(1,), k1d=3, reynolds=(100.0, 200.0),
        dissipation_cases=((True, True),), t_end=0.02,
        output_path=str(out),
    )
    assert len(res) == 2
    (key, err), *_ = sorted(res.items())
    assert key == (1, 100.0, "adiabatic", True, True)
    assert np.isfinite(err) and err < 2.0
    assert out.exists()


def test_structured_exchange_equivalence():
    disc, _ = euler_hex_3d(n=1, k1d=3)
    assert disc.grid_shape == (3, 3, 3)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((5, disc.nfq, disc.num_elements)))
    plain = dataclasses.replace(disc, grid_shape=None)
    np.testing.assert_array_equal(
        np.asarray(disc.gather_traces(u)), np.asarray(plain.gather_traces(u))
    )


def test_simconfig_cns_volume_impls_agree():
    """The config-level CNS routing (generic 'xla' / composed-operator
    'auto') produces the same RHS on a periodic tri mesh."""
    import jax
    import numpy as np

    rng = np.random.default_rng(0)
    q = None
    outs = {}
    for impl in ("xla", "auto"):
        cfg = SimConfig(equation="cns", elem_type="tri", n=2, k1d=4,
                        periodic=True, reynolds=100.0,
                        cns_volume_impl=impl)
        disc, rhs = build_problem(cfg)
        if q is None:
            sh = (disc.np_, disc.num_elements)
            q = primitive_to_conservative(
                jnp.asarray(2 + 0.1 * rng.random(sh)),
                jnp.asarray(0.2 * rng.standard_normal((2, *sh))),
                jnp.asarray(2 + 0.1 * rng.random(sh)),
            )
        dq, _ = jax.jit(rhs)(q, 0.0)
        outs[impl] = np.asarray(dq)
    scale = np.abs(outs["xla"]).max()
    assert np.abs(outs["auto"] - outs["xla"]).max() < 1e-10 * scale


@pytest.mark.parametrize("equation,field,value", [
    ("euler", "flux_diff_impl", "fused"),
    ("euler", "flux_diff_impl", "pallas"),
    ("euler", "flux_diff_impl", "lines_pallas"),
    ("cns", "cns_volume_impl", "fused"),
    ("cns", "cns_volume_impl", "fused_hex"),
])
def test_simconfig_removed_impls_raise(equation, field, value):
    """The removed kernel names are gone from the config: each raises at
    build time instead of routing anywhere."""
    cfg = SimConfig(equation=equation, elem_type="hex", n=2, k1d=2,
                    **{field: value})
    with pytest.raises(ValueError):
        build_problem(cfg)


def test_simconfig_cns_viscous_impl_removed():
    with pytest.raises(TypeError):
        SimConfig(equation="cns", cns_viscous_impl="fused")


@pytest.mark.parametrize("case", ["euler_hex", "cns_tri", "cns_hex"])
def test_simconfig_routes_to_xla_paths(case):
    """One rule on every platform: build_problem's RHS is exactly the
    XLA builder the config names (line-sparse flux differencing on
    collocated hexes, the composed affine CNS operators on affine
    meshes) — nothing consults the device."""
    import jax

    from esdg_cns_tpu.solvers import make_cns_rhs_affine, make_euler_rhs

    equation, elem = case.split("_")
    cfg = SimConfig(equation=equation, elem_type=elem, n=2, k1d=2,
                    periodic=True, reynolds=100.0)
    disc, rhs = build_problem(cfg)
    rng = np.random.default_rng(1)
    sh = (disc.np_, disc.num_elements)
    q = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.2 * rng.standard_normal((disc.dim, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    if equation == "euler":
        ref = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines")
    else:
        ref = make_cns_rhs_affine(disc, mu=1.0 / 100.0, re=100.0,
                                  pr=cfg.prandtl, inviscid_dissipation=True,
                                  flux_diff_impl="auto")
    np.testing.assert_array_equal(np.asarray(jax.jit(rhs)(q, 0.0)[0]),
                                  np.asarray(jax.jit(ref)(q, 0.0)[0]))


def test_wall_bc_convergence_study_results():
    """The EXECUTED reference-scale wall-BC convergence study (round 3):
    N=1..4, K1D=32, Re=100, T=1.0, adiabatic walls,
    regularized lid (f32;
    examples/wall_bc_convergence.py -> results/wall_bc_errors_r03.json,
    parity with err_arr.txt of dg2D_CNS_convergence_test.jl:840-852).
    The boundary L2 error must decrease monotonically with N in both
    dissipation cases."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "wall_bc_errors_r03.json")
    with open(path) as f:
        rows = json.load(f)
    for dissp in (False, True):
        errs = [r["boundary_l2_error"] for r in sorted(
            (r for r in rows if r["viscous_dissp"] == dissp),
            key=lambda r: r["n"])]
        assert len(errs) == 4
        assert all(e2 < e1 for e1, e2 in zip(errs, errs[1:])), errs
        assert errs[0] > 0.03 and errs[-1] < 0.002   # pin the scale


def test_wall_bc_convergence_full_matrix_results():
    """The EXECUTED full reference grid (round 4):
    N=1..4 x all four dissipation combos x Re in {100, 1000} x
    {adiabatic, isothermal}, K1D=32, T=1 (64 cells, f32;
    examples/wall_bc_convergence.py ->
    results/wall_bc_errors_r04.json; reference sweep
    dg2D_CNS_convergence_test.jl:848-852).

    Re-executed after the round-4 self-review fixed the error
    observable's trace interpolation to precision=HIGHEST: the earlier
    artifact's apparent N=4 "plateau" at ~1.8e-3 was a reduced-precision
    matmul floor polluting the measurement, not a property of the scheme —
    the corrected Re=100 high-N errors dropped up to 32x (N=4 down to
    5.6e-5) and EVERY group now converges strictly monotonically in N.
    Cross-axis physics: Re=1000 errors exceed Re=100 at every N
    (thinner boundary layer, same mesh), and inviscid dissipation
    never increases the error at N=1."""
    import collections
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "wall_bc_errors_r04.json")
    with open(path) as f:
        rows = json.load(f)
    assert len(rows) == 64
    groups = collections.defaultdict(dict)
    for r in rows:
        key = (r["re"], r["bctype"], r["inviscid_dissp"],
               r["viscous_dissp"])
        groups[key][r["n"]] = r["boundary_l2_error"]
    assert len(groups) == 16
    for key, by_n in groups.items():
        errs = [by_n[n] for n in (1, 2, 3, 4)]
        for e1, e2 in zip(errs, errs[1:]):
            assert e2 < e1, (key, errs)
        assert errs[0] > 0.02 and errs[-1] < 0.008, (key, errs)
    # Re=1000 is strictly harder than Re=100 on the same mesh
    for (re_, bt, inv_d, visc_d), by_n in groups.items():
        if re_ != 1000.0:
            continue
        ref = groups[(100.0, bt, inv_d, visc_d)]
        for n in (1, 2, 3, 4):
            assert by_n[n] > ref[n], (bt, inv_d, visc_d, n)


def test_shocktube2d_convergence_results():
    """EXECUTED 2D viscous-shocktube refinement (round 4, f32):
    examples/dg2d_cns_shocktube.py SWEEP=32,64,128 ->
    results/shocktube2d_errors_r04.json at the reference's N=2, T=0.2,
    mu=0.01, M_0=3 Becker configuration (dg2D_CNS_modalESDG.jl:21-27;
    composite relative errors over rho/rhou/E per :765-774).  K1D=128
    matches the reference's hx=1/32 resolution.  Every norm must
    decrease monotonically with refinement; scales pinned."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "shocktube2d_errors_r04.json")
    with open(path) as f:
        data = json.load(f)
    rows = sorted(data["rows"], key=lambda r: r["k1d"])
    assert [r["k1d"] for r in rows] == [32, 64, 128]
    for norm in ("l1", "l2", "linf"):
        errs = [r[norm] for r in rows]
        assert all(e2 < e1 for e1, e2 in zip(errs, errs[1:])), (norm, errs)
    assert rows[-1]["l2"] < 0.006 and rows[0]["l2"] > 0.05
    assert all(r["n_accepted"] > 0 for r in rows)


def test_checkpoint_npz_fallback(tmp_path):
    """The non-orbax path: path-keyed npz with template verification."""
    import pytest

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                            use_orbax=False)
    assert mgr._mgr is None  # actually exercising the fallback
    state = {
        "q": jnp.arange(12.0).reshape(3, 4),
        "t": jnp.asarray(0.5),
        "step": 7,
    }
    mgr.save(7, state)
    mgr.save(9, state)
    restored = mgr.restore(template=state)
    np.testing.assert_allclose(np.asarray(restored["q"]),
                               np.asarray(state["q"]))
    assert float(restored["t"]) == 0.5
    assert restored["step"] == 7

    # restore is keyed by pytree path, not insertion order
    with pytest.raises(ValueError, match="does not match the template"):
        mgr.restore(template={"q": state["q"], "time": state["t"],
                              "step": 7})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(template={"q": jnp.zeros((4, 3)), "t": state["t"],
                              "step": 7})
    with pytest.raises(ValueError, match="template"):
        mgr.restore()

    # max_to_keep pruning
    mgr.save(11, state)
    assert sorted(mgr._npz_steps()) == [9, 11]
    assert mgr.latest_step() == 11


def test_launch_helpers():
    """Multi-host bootstrap helper (SURVEY 2.4 launcher row): single
    process is a no-op; mesh construction covers 1D and 2D layouts."""
    import os

    import pytest

    from esdg_cns_tpu.parallel import launch

    os.environ.pop("JAX_COORDINATOR_ADDRESS", None)
    assert launch.maybe_initialize() is False

    mesh = launch.make_device_mesh()
    assert mesh.axis_names == ("e",)
    assert mesh.devices.size == jax.device_count()

    mesh2 = launch.make_device_mesh(shape=(2, jax.device_count() // 2),
                                    axis_names=("ens", "e"))
    assert mesh2.shape["ens"] == 2
    with pytest.raises(ValueError, match="devices"):
        launch.make_device_mesh(shape=(3,))
    with pytest.raises(ValueError, match="equal length"):
        launch.make_device_mesh(shape=(2, 4), axis_names=("e",))


def test_cavity_profile_convergence_results():
    """The EXECUTED centerline grid-convergence study (round 4):
    Re=1000 cavity steady states at N=3, K1D in {8, 16, 24}, each
    integrated to T=100
    (examples/cavity_profile_convergence.py ->
    results/cavity_profiles_r04.json).  Pins: the successive-resolution
    centerline L2 differences SHRINK (the flagship anchor at K1D=16 is
    discretization-converged, not a mesh artifact), every run reached
    T=100 without rejected steps, and the primary-vortex extrema at all
    resolutions stay in the canonical Re~1000 band.
    """
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "cavity_profiles_r04.json")
    with open(path) as f:
        d = json.load(f)

    assert [r["k1d"] for r in d["runs"]] == [8, 16, 24]
    for r in d["runs"]:
        assert r["n_rejected"] == 0
        assert r["n_accepted"] > 5000

    diffs = d["successive_l2_diffs"]
    assert len(diffs) == 2
    # refinement must shrink the profile change by ~the expected factor
    assert diffs[1]["u_l2_diff"] < 0.5 * diffs[0]["u_l2_diff"]
    assert diffs[1]["v_l2_diff"] < 0.5 * diffs[0]["v_l2_diff"]
    # fine-grid profile change is small in absolute terms
    assert diffs[1]["u_l2_diff"] < 1e-2
    assert diffs[1]["v_l2_diff"] < 1e-2

    for e in d["extrema"]:
        assert -0.50 < e["u_min"] < -0.35
        assert -0.62 < e["v_min"] < -0.48
        assert 0.35 < e["v_max"] < 0.48


def test_ghia_tables_and_comparator():
    """Vendored Ghia, Ghia & Shin (1982) Re=1000 tables: structural
    sanity (endpoint BC values, station ordering, canonical extrema)
    and the comparator's fixed point (feeding the tables back through
    compare_to_ghia on [-1,1] coordinates gives zero deviation).
    """
    from esdg_cns_tpu.physics.cavity_benchmarks import (
        GHIA_RE1000_U, GHIA_RE1000_V, compare_to_ghia)

    for tab in (GHIA_RE1000_U, GHIA_RE1000_V):
        assert tab.shape == (17, 2)
        assert tab[-1, 0] == 0.0 and tab[0, 0] == 1.0
        assert np.all(np.diff(tab[:, 0]) < 0)  # stations descend
    assert GHIA_RE1000_U[0, 1] == 1.0   # lid
    assert GHIA_RE1000_U[-1, 1] == 0.0  # bottom wall
    assert abs(GHIA_RE1000_U[:, 1].min() - (-0.38289)) < 1e-12
    assert abs(GHIA_RE1000_V[:, 1].min() - (-0.51550)) < 1e-12
    assert abs(GHIA_RE1000_V[:, 1].max() - 0.37095) < 1e-12

    y = 2.0 * GHIA_RE1000_U[::-1, 0] - 1.0
    x = 2.0 * GHIA_RE1000_V[::-1, 0] - 1.0
    c = compare_to_ghia(y, GHIA_RE1000_U[::-1, 1], x, GHIA_RE1000_V[::-1, 1])
    assert c["u_max_dev"] < 1e-14 and c["v_max_dev"] < 1e-14


def test_cavity_ghia_anchor_results():
    """The EXECUTED external-anchor comparison (round 4): steady
    cavity centerlines vs the Ghia et al. (1982) Re=1000 tables at
    matched nondimensionalization (preset re=500 -> Ghia Re = 1000 on
    the side-2 domain), two compressibility legs Ma in {0.3, 0.15}
    (examples/cavity_ghia_compare.py -> results/cavity_ghia_r04.json).
    Pins: every leg reached T=100 with zero rejected steps and agrees
    with the incompressible benchmark to <=1.2e-2 RMS / <=2.5e-2 max in
    BOTH centerline velocity components — the same order as the
    measured K1D=16 discretization error (cavity_profiles_r04.json), so
    the anchor is matched to within the numerics.
    """
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "cavity_ghia_r04.json")
    with open(path) as f:
        d = json.load(f)

    assert d["config"]["re_ghia"] == 1000.0
    assert sorted(l["ma"] for l in d["legs"]) == [0.15, 0.3]
    for leg in d["legs"]:
        assert leg["n_rejected"] == 0
        assert leg["n_accepted"] > 10000
        c = leg["comparison"]
        assert len(c["u_ghia"]) == 17 and len(c["v_ghia"]) == 17
        assert c["u_rms_dev"] < 1.2e-2, c["u_rms_dev"]
        assert c["v_rms_dev"] < 1.2e-2, c["v_rms_dev"]
        assert c["u_max_dev"] < 2.5e-2, c["u_max_dev"]
        assert c["v_max_dev"] < 2.5e-2, c["v_max_dev"]


def test_mms_harness_smoke():
    """Live MMS run at the coarsest pair: the AD-derived source keeps
    the manufactured solution an (approximate) solution of the discrete
    system — interior L2 error small and refining at rate > N - 0.5
    even pre-asymptotically (2 -> 4 elements per side)."""
    from esdg_cns_tpu.verification import mms_convergence_study

    res = mms_convergence_study(orders=(2,), k1ds=(2, 4), t_end=0.05)
    errs = res[2]["error"]
    assert errs[0] < 0.05, errs
    assert errs[1] < errs[0]
    assert res[2]["rates"][0] > 1.5, res[2]["rates"]


def test_mms_3d_convergence_results():
    """The EXECUTED 3D hex MMS artifact (round 4, CPU f64, mu=0.05,
    T=0.05): interior L2 errors of the full 3D CNS operator vs the
    manufactured solution decay monotonically for N=2,3 with the finest
    observed rate approaching N+1 (measured 2.99 / 3.39)."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "mms_rates_3d_r04.json")
    with open(path) as f:
        d = json.load(f)
    assert d["config"]["elem"] == "hex"
    assert d["config"]["x64"] is True
    for n_str, row in d["results"].items():
        n = int(n_str)
        errs = row["error"]
        assert all(e2 < e1 for e1, e2 in zip(errs, errs[1:])), (n, errs)
        assert row["rates"][-1] > n + 0.3, (n, row["rates"])
        assert errs[-1] < 5e-4, (n, errs)


def test_mms_curved_quad_smoke():
    """Live curved-mesh MMS at the coarsest pair: the wJq-weighted
    source projection + variable-geofac BR1/flux-differencing paths
    keep the manufactured solution converging on a warped quad mesh
    (measured rates 1.93 / 2.56 over 2->4->8; the pair here is the
    cheap pre-asymptotic one)."""
    from esdg_cns_tpu.verification import (
        boundary_preserving_warp, mms_convergence_study)

    res = mms_convergence_study(orders=(2,), k1ds=(2, 4), elem="quad",
                                curved_map=boundary_preserving_warp,
                                t_end=0.02)
    errs = res[2]["error"]
    assert errs[0] < 0.05, errs
    assert res[2]["rates"][0] > 1.5, res[2]["rates"]


def test_mms_line_smoke():
    """Live 1D MMS: the elem='line' leg of the study converges on the
    full 1D CNS operator (measured rates 3.2 / 2.7 over 4->8->16 at
    N=2; the pair here is the cheap coarse one)."""
    from esdg_cns_tpu.verification import mms_convergence_study

    res = mms_convergence_study(orders=(2,), k1ds=(4, 8), elem="line",
                                t_end=0.05)
    errs = res[2]["error"]
    assert errs[0] < 0.01, errs
    assert res[2]["rates"][0] > 2.0, res[2]["rates"]


def test_mms_curved_projection_reproduces_polynomials():
    """The curved-mesh weighted projection in make_mms_rhs is a true
    L2 projection: applied to a source that IS a nodal polynomial
    (interpolated to quadrature points), it must return that polynomial
    exactly, element by element, on a genuinely curved mesh."""
    import jax
    import numpy as np

    from esdg_cns_tpu.core import build_discretization, ref_quad
    from esdg_cns_tpu.mesh import uniform_quad_mesh
    from esdg_cns_tpu.verification import (
        boundary_preserving_warp, make_mms_rhs)

    vx, vy, etov = uniform_quad_mesh(3)
    disc = build_discretization(ref_quad(3), (vx, vy), etov,
                                periodic_axes=(0, 1),
                                curved_map=boundary_preserving_warp)
    assert disc.geo.shape[1] != 1  # genuinely curved
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(
        (4, disc.np_, disc.num_elements)))
    uq = jnp.einsum("ij,fjk->fik", disc.vq, u,
                    precision=jax.lax.Precision.HIGHEST)
    rhs_mms = make_mms_rhs(disc, lambda q, t: (jnp.zeros_like(u), None),
                           lambda xq, t: uq)
    dq, _ = rhs_mms(u, 0.0)
    assert float(jnp.max(jnp.abs(dq - u))) < 1e-11


def test_mms_source_consistency():
    """Local truncation of the projected-source RHS on the interpolated
    exact state: resid = rhs(q_ex) + P(S) - du_ex/dt, measured in the
    quadrature-weighted L2 norm, decays under refinement (measured rate
    ~1.7 pre-asymptotically at N=3 — the viscous truncation carries
    mu * pi^4-scale fourth-derivative constants; the SOLUTION error
    converges at ~N+1, see test_mms_harness_smoke / the executed
    artifact)."""
    import jax

    from esdg_cns_tpu.core import build_discretization, ref_tri
    from esdg_cns_tpu.mesh import uniform_tri_mesh
    from esdg_cns_tpu.solvers import make_cns_rhs
    from esdg_cns_tpu.verification import (
        make_mms_rhs, make_mms_source, mms_solution_2d)

    mu = 0.05
    source = make_mms_source(mms_solution_2d, 2, mu=mu, pr=0.71)

    def l2_resid(k1d):
        vx, vy, etov = uniform_tri_mesh(k1d)
        disc = build_discretization(ref_tri(3), (vx, vy), etov,
                                    periodic_axes=(0, 1))
        rhs = make_cns_rhs(disc, mu=mu, pr=0.71, compute_rhstest=False)
        rhs_mms = make_mms_rhs(disc, rhs, source)
        q0 = mms_solution_2d(*[jnp.asarray(c) for c in disc.x], 0.0)
        dudt = jax.jacfwd(
            lambda t: mms_solution_2d(*[jnp.asarray(c) for c in disc.x], t)
        )(0.0)
        dq, _ = rhs_mms(q0, 0.0)
        dql = jnp.einsum("ij,fjk->fik", disc.vq, dq - dudt,
                         precision=jax.lax.Precision.HIGHEST)
        return float(jnp.sqrt(jnp.sum(disc.wjq * jnp.sum(dql**2, axis=0))))

    r4, r8 = l2_resid(4), l2_resid(8)
    assert r8 < 0.2, (r4, r8)            # absolute sanity (measured 0.097)
    assert r8 < r4 / 2.0, (r4, r8)       # decays under refinement


def test_mms_convergence_results():
    """The EXECUTED MMS artifact (round 4, CPU f64, mu=0.05, T=0.1,
    LF + viscous dissipation on): interior L2 errors of the full CNS
    operator vs the manufactured solution decay monotonically for
    N=2,3,4 over K1D=2,4,8, with the finest observed rate > N + 0.4
    (measured 3.06 / 3.62 / 4.45 — approaching N+1)."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "mms_rates_r04.json")
    with open(path) as f:
        d = json.load(f)
    assert d["config"]["x64"] is True
    for n_str, row in d["results"].items():
        n = int(n_str)
        errs = row["error"]
        assert all(e2 < e1 for e1, e2 in zip(errs, errs[1:])), (n, errs)
        assert row["rates"][-1] > n + 0.4, (n, row["rates"])
        assert errs[-1] < 5e-4, (n, errs)
