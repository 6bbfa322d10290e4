"""Profiler trace of the RHS on the device, reduced to the top device
ops and the device's idle share.

    python examples/trace_rhs.py
    (env: OUT=trace_out STEPS=4 EULER_K1D=32 CAVITY_K1D=128)

Traces STEPS fixed-dt LSRK45 steps (5 RHS each, one jit call, after a
warm-up call) of two problems on their XLA paths: 3D Euler hex N=3
K=32^3 ('lines' flux differencing) and the 2D CNS cavity N=3 K=2*128^2
(composed affine operators).  For each it prints the device planes'
timelines, the busy time (union of op intervals on the busiest device
timeline), the idle share of the traced window and the ops that take
the most device time, and writes the same as JSON under OUT.
"""

import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common  # noqa: F401  (repo path + compile cache)

import jax
import jax.numpy as jnp

from esdg_cns_tpu.presets import euler_hex_3d, lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs_affine, make_euler_rhs
from esdg_cns_tpu.timestepping import lsrk45
from esdg_cns_tpu.utils.device_info import card_lines, jax_device


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path, top=15):
    """Busy/idle and top ops from one .xplane.pb file."""
    return reduce_planes(jax.profiler.ProfileData.from_file(path).planes,
                         top)


def reduce_planes(planes, top=15):
    """Busy/idle and top ops from profiler planes (each with a name and
    lines of events carrying name, start_ns and duration_ns)."""
    lines = {}
    for plane in planes:
        if "/device:" not in plane.name or "CPU" in plane.name:
            continue
        for line in plane.lines:
            evs = [(ev.name, ev.start_ns, ev.duration_ns)
                   for ev in line.events]
            if evs:
                lines[f"{plane.name} | {line.name}"] = evs
    if not lines:
        raise RuntimeError("no device timeline in the trace")
    # kernels run on the stream timelines; module/op summary lines
    # overlap them, so the busiest single timeline is the measure
    ops_key = max(lines, key=lambda k: len(lines[k]))
    evs = lines[ops_key]
    start = min(s for _, s, _ in evs)
    stop = max(s + d for _, s, d in evs)
    busy = _union([(s, s + d) for _, s, d in evs])
    per_op = {}
    for name, _, d in evs:
        per_op[name] = per_op.get(name, 0) + d
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "timelines": {k: len(v) for k, v in lines.items()},
        "timeline_used": ops_key,
        "window_ns": stop - start,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / (stop - start),
        "n_events": len(evs),
        "top_ops": [{"name": n, "ns": t, "share_of_busy": t / busy}
                    for n, t in ranked],
    }


def problems():
    k1d = int(os.environ.get("EULER_K1D", 32))
    disc, q0 = euler_hex_3d(n=3, k1d=k1d, dtype=jnp.float32)
    yield "euler_hex_n3_lines", q0, make_euler_rhs(
        disc, dissipation=True, flux_diff_impl="lines",
        compute_rhstest=False)
    k1d = int(os.environ.get("CAVITY_K1D", 128))
    disc, q0, bc, p = lid_driven_cavity(n=3, k1d=k1d, dtype=jnp.float32)
    yield "cns_cavity_n3_affine", q0, make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        flux_diff_impl="xla", compute_rhstest=False)


def main():
    out = os.environ.get("OUT", "trace_out")
    steps = int(os.environ.get("STEPS", 4))
    summary = {"device": jax_device(), "card": card_lines(), "runs": {}}
    for name, q0, rhs in problems():
        run = jax.jit(lambda q, rhs=rhs: lsrk45(
            rhs, q, jnp.asarray(1e-6, q.dtype), steps)[0])
        jax.block_until_ready(run(q0))
        t0 = time.perf_counter()
        jax.block_until_ready(run(q0))
        wall = time.perf_counter() - t0
        logdir = os.path.join(out, name)
        with jax.profiler.trace(logdir):
            jax.block_until_ready(run(q0))
        path = sorted(glob.glob(os.path.join(
            logdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
        r = reduce_trace(path)
        r["wall_s_untraced"] = wall
        r["rhs_evals"] = 5 * steps
        summary["runs"][name] = r
        print(f"== {name}: {5 * steps} RHS, untraced wall "
              f"{wall * 1e3:.3f} ms, traced window "
              f"{r['window_ns'] / 1e6:.3f} ms, busy "
              f"{r['busy_ns'] / 1e6:.3f} ms, idle share "
              f"{r['idle_share']:.4f}")
        for k, v in r["timelines"].items():
            print(f"   timeline {k}: {v} events")
        for op in r["top_ops"]:
            print(f"   {op['ns'] / 1e6:9.3f} ms {op['share_of_busy']:7.2%}"
                  f"  {op['name'][:100]}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
