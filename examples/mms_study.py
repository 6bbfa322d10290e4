"""Manufactured-solution (MMS) convergence study for the full CNS
operator on periodic tri (ELEM=tri, default) or 3D hex (ELEM=hex)
meshes.

Beyond-reference verification: the reference's exact-solution anchors
are the 1D Becker profile and the cavity boundary-trace error; MMS
measures interior L2 convergence of the complete multi-dimensional
operator (EC flux differencing + BR1 viscous terms + LF/viscous
dissipation) against an arbitrary smooth exact solution, with the
source term derived by nested forward-mode AD through the same
euler_flux / v_ufun / viscous_flux_2d compositions the solver uses
(esdg_cns_tpu.verification.make_mms_source).

Runs on CPU float64 by default (this is a correctness artifact; f32
would floor the fine-grid errors).  Override with ORDERS / K1DS / MU /
T / OUT.

Usage:  python examples/mms_study.py
"""

import json
import os

import jax

# correctness artifact: CPU f64 by default, PLATFORM=gpu for the card
jax.config.update("jax_platforms", os.environ.get("PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", os.environ.get("X64", "1") == "1")

from common import env_float, env_int  # noqa: E402

from esdg_cns_tpu.verification import mms_convergence_study  # noqa: E402


def main():
    elem = os.environ.get("ELEM", "tri")
    curved = os.environ.get("CURVED", "0") == "1"
    alpha = env_float("ALPHA", 0.1)
    orders = tuple(
        int(s) for s in os.environ.get(
            "ORDERS", "2,3" if elem == "hex" else "2,3,4").split(","))
    k1ds = tuple(int(s) for s in os.environ.get("K1DS", "2,4,8").split(","))
    mu = env_float("MU", 0.05)
    t_end = env_float("T", 0.05 if elem == "hex" else 0.1)
    default_out = ("mms_rates_3d_r04.json" if elem == "hex"
                   else "mms_rates_r04.json")
    if curved:
        default_out = default_out.replace(".json", "_curved.json")
    out = os.environ.get("OUT", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "results",
        default_out))

    curved_map = None
    if curved:
        from functools import partial

        from esdg_cns_tpu.verification import boundary_preserving_warp
        curved_map = partial(boundary_preserving_warp, alpha=alpha)

    results = mms_convergence_study(
        orders=orders, k1ds=k1ds, mu=mu, t_end=t_end, elem=elem,
        curved_map=curved_map, verbose=True)

    payload = {
        "config": {"elem": elem, "orders": list(orders),
                   "k1ds": list(k1ds), "mu": mu,
                   "curved": curved, "alpha": alpha if curved else None,
                   "pr": 0.71, "t_end": t_end, "dissipation": [True, True],
                   "solution": "verification.mms_solution_%dd"
                   % (3 if elem == "hex" else 2),
                   "backend": jax.default_backend(),
                   "x64": jax.config.read("jax_enable_x64")},
        "results": {str(n): v for n, v in results.items()},
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload["results"]))
    for n, v in results.items():
        print(f"N={n}: errors={['%.3e' % e for e in v['error']]} "
              f"rates={['%.2f' % r for r in v['rates']]}")


if __name__ == "__main__":
    main()
