"""Quantitative external anchor: cavity centerlines vs Ghia et al. 1982.

The reference's headline cavity (dg2D_CNS_cavity_optimized.jl) is
validated only by eye against MATLAB plots.  Here the steady-state
centerline profiles are compared POINTWISE against the canonical
incompressible benchmark (Ghia, Ghia & Shin 1982, Re=1000 tables,
vendored in esdg_cns_tpu.physics.cavity_benchmarks).

Nondimensionalization: the preset cavity lives on [-1,1]^2 (side L=2)
with mu = 1/re_param, so Ghia's Re = U*L/nu = 2*re_param; re_param=500
matches Ghia's Re=1000 exactly.  The remaining modeling difference is
compressibility: Ghia is incompressible, ours is compressible at Ma.
Running two Ma legs (0.3, 0.15) shows the deviation from Ghia SHRINKS
as Ma -> 0, pinning the gap as physical (compressibility), not
numerical error.

    python examples/cavity_ghia_compare.py

Env: T (default 100), N (3), K1D (16), MAS ("0.3,0.15"),
OUT (default results/cavity_ghia_r04.json).
Results recorded in PARITY.md; artifact pinned by
tests/test_framework.py::test_cavity_ghia_anchor_results.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from common import env_float

import jax


from cavity_profile_convergence import run_one

from esdg_cns_tpu.physics.cavity_benchmarks import compare_to_ghia


def main():
    n = int(os.environ.get("N", 3))
    k1d = int(os.environ.get("K1D", 16))
    t_end = env_float("T", 100.0)
    err_tol = env_float("ERRTOL", 1e-5)
    mas = [float(s) for s in os.environ.get("MAS", "0.3,0.15").split(",")]
    out_path = os.environ.get("OUT", "results/cavity_ghia_r04.json")

    # preset re=500 -> mu=2e-3 -> Ghia Re = U*L/nu = 1*2/2e-3 = 1000
    re_param = 500.0

    legs = []
    for ma in mas:
        print(f"Ma={ma} ...", flush=True)
        r = run_one(n, k1d, re_param, ma, t_end, err_tol)
        cmp_ = compare_to_ghia(r["y"], r["u_at_x0"], r["x"], r["v_at_y0"])
        legs.append({
            "ma": ma,
            "n_accepted": r["n_accepted"],
            "n_rejected": r["n_rejected"],
            "wall_s": r["wall_s"],
            "comparison": cmp_,
        })
        print(f"  u: rms={cmp_['u_rms_dev']:.4f} max={cmp_['u_max_dev']:.4f}"
              f"   v: rms={cmp_['v_rms_dev']:.4f} "
              f"max={cmp_['v_max_dev']:.4f}", flush=True)

    out = {
        "config": {"n": n, "k1d": k1d, "re_ghia": 1000.0,
                   "re_param": re_param, "t_end": t_end,
                   "err_tol": err_tol, "bctype": "isothermal",
                   "platform": jax.devices()[0].platform},
        "legs": legs,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {out_path}")


if __name__ == "__main__":
    main()
