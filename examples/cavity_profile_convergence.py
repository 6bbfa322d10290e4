"""Grid self-convergence of the Re=1000 cavity centerline profiles.

The round-4 flagship run (examples/cavity_t100.py) pinned the steady
state at the reference resolution (N=3, K1D=16,
dg2D_CNS_cavity_optimized.jl:21-36) and checked its centerline extrema
against the canonical incompressible values.  This study quantifies the
discretization error of that anchor with a K1D in {8, 16, 24} sweep at
fixed N=3: each resolution is integrated to steady state (T=100,
adaptive DOPRI45), the centerline profiles u(0, y) and v(x, 0) are
interpolated to a common grid, and successive-resolution L2 differences
plus the primary-vortex extrema are recorded.  Done = the 16->24
difference is several times smaller than 8->16 (the profiles are
converging) and the extrema move monotonically toward the fine-grid
values.

    python examples/cavity_profile_convergence.py

Env: T (default 100), RES (comma list, default "8,16,24"),
OUT (default results/cavity_profiles_r04.json).
Results recorded in PARITY.md; artifact pinned by
tests/test_framework.py.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from common import env_float

import jax
import jax.numpy as jnp
import numpy as np


from esdg_cns_tpu.presets import lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs_affine
from esdg_cns_tpu.timestepping import dopri45
from esdg_cns_tpu.utils.postprocess import extract_line


def run_one(n, k1d, re, ma, t_end, err_tol):
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    disc, q0, bc, p = lid_driven_cavity(n=n, k1d=k1d, bctype="isothermal",
                                        ma=ma, re=re, dtype=dtype)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=re, bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
    )
    cn = (n + 1) * (n + 2) / 2
    dt0 = min(0.5 * (2.0 / k1d) / cn, 2.0 / (cn * k1d * k1d))

    @jax.jit
    def run_chunk(q, t0, t1, dt):
        return dopri45(rhs, q, t1, dt, t0=t0, err_tol=err_tol,
                       max_records=8, dt_clamp_base=dt0)

    q, t, dt = q0, jnp.asarray(0.0, dtype), jnp.asarray(dt0, dtype)
    acc = rej = 0
    chunk = max(1.0, t_end / 10)
    tw = time.time()
    while float(t) < t_end - 1e-9:
        t1 = min(float(t) + chunk, t_end)
        q, stats = run_chunk(q, t, jnp.asarray(t1, dtype), dt)
        q.block_until_ready()
        t, dt = stats["t"], stats["dt"]
        acc += int(stats["n_accepted"])
        rej += int(stats["n_rejected"])
        if bool(stats["stalled"]):
            raise RuntimeError(f"K1D={k1d}: stepper stalled at t={float(t)}")
        print(f"  K1D={k1d}: t={float(t):6.1f} dt={float(dt):.3e} "
              f"acc={acc} rej={rej} "
              f"visc={float(stats['rhstest_visc']):.3e}", flush=True)
    wall = time.time() - tw

    qn = np.asarray(q)
    u = qn[1] / qn[0]
    v = qn[2] / qn[0]
    y_line, u_c = extract_line(disc, u[None], axis=0, value=0.0)
    x_line, v_c = extract_line(disc, v[None], axis=1, value=0.0)
    return {
        "k1d": k1d, "n_accepted": acc, "n_rejected": rej, "wall_s": wall,
        "y": np.asarray(y_line), "u_at_x0": np.asarray(u_c[0]),
        "x": np.asarray(x_line), "v_at_y0": np.asarray(v_c[0]),
    }


def main():
    n = int(os.environ.get("N", 3))
    re = env_float("RE", 1000.0)
    ma = env_float("MA", 0.3)
    t_end = env_float("T", 100.0)
    err_tol = env_float("ERRTOL", 1e-5)
    res = [int(s) for s in os.environ.get("RES", "8,16,24").split(",")]
    out_path = os.environ.get("OUT", "results/cavity_profiles_r04.json")

    runs = []
    for k1d in res:
        print(f"K1D={k1d} ...", flush=True)
        runs.append(run_one(n, k1d, re, ma, t_end, err_tol))

    # common interpolation grid (open interval: avoid wall endpoints where
    # every resolution is pinned to the BC anyway)
    yy = np.linspace(-0.98, 0.98, 99)
    ui = [np.interp(yy, r["y"], r["u_at_x0"]) for r in runs]
    vi = [np.interp(yy, r["x"], r["v_at_y0"]) for r in runs]

    def l2(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    pairs = []
    for i in range(len(runs) - 1):
        pairs.append({
            "k1d_pair": [runs[i]["k1d"], runs[i + 1]["k1d"]],
            "u_l2_diff": l2(ui[i], ui[i + 1]),
            "v_l2_diff": l2(vi[i], vi[i + 1]),
        })

    extrema = [{
        "k1d": r["k1d"],
        "u_min": float(r["u_at_x0"].min()),
        "v_min": float(r["v_at_y0"].min()),
        "v_max": float(r["v_at_y0"].max()),
    } for r in runs]

    out = {
        "config": {"n": n, "re": re, "ma": ma, "t_end": t_end,
                   "err_tol": err_tol, "bctype": "isothermal",
                   "platform": jax.devices()[0].platform},
        "runs": [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in r.items()} for r in runs],
        "successive_l2_diffs": pairs,
        "extrema": extrema,
        # canonical incompressible Re=1000 anchors (Ghia, Ghia & Shin
        # 1982): u_min ~ -0.38, v_min ~ -0.52, v_max ~ +0.37; ours is
        # Ma=0.3 compressible, so agreement is expected to ~10%, with
        # the fine-grid values the honest target of the sweep
        "canonical_incompressible": {"u_min": -0.38, "v_min": -0.52,
                                     "v_max": 0.37},
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)

    print("\nextrema (per K1D):")
    for e in extrema:
        print(f"  K1D={e['k1d']:3d}: u_min={e['u_min']:+.4f} "
              f"v_min={e['v_min']:+.4f} v_max={e['v_max']:+.4f}")
    print("successive centerline L2 differences:")
    for pr in pairs:
        print(f"  K1D {pr['k1d_pair'][0]:3d} -> {pr['k1d_pair'][1]:3d}: "
              f"u {pr['u_l2_diff']:.3e}  v {pr['v_l2_diff']:.3e}")
    print(f"-> {out_path}")


if __name__ == "__main__":
    main()
