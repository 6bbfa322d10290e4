"""Flagship workload at reference duration: the Re=1000, Ma=0.3
isothermal lid-driven cavity integrated to T=100 with adaptive DOPRI45,
checkpoint/restart and per-step metric histories.

Parity workload: reference examples/CompressibleNS/dg2D_CNS_cavity_optimized.jl
(N=3, K1D=16, Re=1000, T=100.0 at :21-36,26; DOPRI45 loop :999-1053 with
thist/dthist/vischist/rhstesthist histories :1039-1042).

Structure: the run is split into CHUNK-sized dopri45 calls (one compiled
program reused for every chunk: t0/t_end/dt ride as traced arguments),
with a CheckpointManager save after every chunk.  On start the driver
restores the latest checkpoint if one exists, so killing and relaunching
the process resumes the run — set STOP_AT_T=50 for the first launch and
rerun without it to exercise a real cross-process restart (recorded in
the output JSON as `resume_events`).

Outputs:
  OUT (default results/cavity_T100.json): chunk summaries, dt /
    rhstest / rhstest_visc histories (downsampled), wall times, resume
    events, and the steady-state centerline profiles u(0, y), v(x, 0).
  HIST_OUT (default results/cavity_t100_history.npz): full per-step
    histories.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from common import env_float, env_int

import jax
import jax.numpy as jnp
import numpy as np


from esdg_cns_tpu.presets import lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs_affine
from esdg_cns_tpu.timestepping import dopri45
from esdg_cns_tpu.utils.checkpoint import CheckpointManager
from esdg_cns_tpu.utils.postprocess import extract_line


def main():
    n, k1d = env_int("N", 3), env_int("K1D", 16)
    re = env_float("RE", 1000.0)
    ma = env_float("MA", 0.3)
    t_end = env_float("T", 100.0)
    chunk = env_float("CHUNK", 1.0)
    err_tol = env_float("ERRTOL", 1e-5)
    stop_at_t = env_float("STOP_AT_T", -1.0)
    bctype = os.environ.get("BCTYPE", "isothermal")
    out_path = os.environ.get("OUT", "results/cavity_T100.json")
    hist_path = os.environ.get("HIST_OUT", "results/cavity_t100_history.npz")
    ckpt_dir = os.environ.get("CKPT_DIR", "results/cavity_t100_ckpt")
    max_records = env_int("MAX_RECORDS", 2048)

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    disc, q0, bc, p = lid_driven_cavity(n=n, k1d=k1d, bctype=bctype,
                                        ma=ma, re=re, dtype=dtype)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=re, bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
    )
    cn = (n + 1) * (n + 2) / 2
    dt0 = min(0.5 * (2.0 / k1d) / cn, 2.0 / (cn * k1d * k1d))

    @jax.jit
    def run_chunk(q, t0, t1, dt):
        return dopri45(
            rhs, q, t1, dt, t0=t0, err_tol=err_tol,
            max_records=max_records, record_every=1, dt_clamp_base=dt0,
        )

    mgr = CheckpointManager(ckpt_dir, max_to_keep=3)
    state = {
        "q": q0, "t": jnp.asarray(0.0, dtype), "dt": jnp.asarray(dt0, dtype),
        "chunk": 0, "n_accepted": 0, "n_rejected": 0,
    }
    resume_events = []
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(latest, template=state)
        resume_events.append(
            {"restored_step": int(latest), "t": float(state["t"]),
             "dt": float(state["dt"]),
             "n_accepted": int(state["n_accepted"])}
        )
        print(f"RESUMED from checkpoint step {latest}: t={float(state['t']):.3f}"
              f", dt={float(state['dt']):.3e}, "
              f"accepted={int(state['n_accepted'])}")

    chunks = []
    hist = {k: [] for k in ("t", "dt", "err", "rhstest", "rhstest_visc")}
    wall_prev = 0.0
    if resume_events:
        # merge the previous legs' artifacts so the final JSON/npz cover
        # the whole run, not just the post-restart leg
        if os.path.exists(out_path):
            with open(out_path) as f:
                prev = json.load(f)
            chunks = [c for c in prev.get("chunks", [])
                      if c["t"] <= float(state["t"]) + 1e-9]
            resume_events = prev.get("resume_events", []) + resume_events
            wall_prev = prev.get("wall_s_total", 0.0)
        if os.path.exists(hist_path):
            with np.load(hist_path) as prev_h:
                for k in hist:
                    if k in prev_h:
                        keep = prev_h["t"] <= float(state["t"]) + 1e-9
                        hist[k].append(prev_h[k][keep])
    n_chunks = int(round(t_end / chunk))
    t_wall0 = time.time()
    q, t, dt = state["q"], state["t"], state["dt"]
    tot_acc, tot_rej = int(state["n_accepted"]), int(state["n_rejected"])

    for i in range(int(state["chunk"]), n_chunks):
        t1 = (i + 1) * chunk
        if float(t) >= t1 - 1e-12:
            continue
        tw = time.time()
        q, stats = run_chunk(q, t, jnp.asarray(t1, dtype), dt)
        q.block_until_ready()
        wall = time.time() - tw
        t, dt = stats["t"], stats["dt"]
        acc, rej = int(stats["n_accepted"]), int(stats["n_rejected"])
        tot_acc += acc
        tot_rej += rej
        if bool(stats["stalled"]):
            raise RuntimeError(f"stepper stalled at t={float(t)}")
        nrec = int(stats["n_records"])
        for k in hist:
            hist[k].append(np.asarray(stats["history"][k])[:nrec])
        row = {
            "chunk": i, "t": float(t), "dt": float(dt),
            "n_accepted": acc, "n_rejected": rej,
            "rhstest": float(stats["rhstest"]),
            "rhstest_visc": float(stats["rhstest_visc"]),
            "wall_s": wall,
        }
        chunks.append(row)
        state = {"q": q, "t": t, "dt": dt, "chunk": i + 1,
                 "n_accepted": tot_acc, "n_rejected": tot_rej}
        mgr.save(i + 1, state)
        print(f"chunk {i + 1}/{n_chunks}: t={row['t']:.2f} "
              f"dt={row['dt']:.3e} acc/rej={acc}/{rej} "
              f"rhstest={row['rhstest']:.3e} "
              f"visc={row['rhstest_visc']:.3e} [{wall:.1f}s]")
        if 0 < stop_at_t <= float(t):
            print(f"STOP_AT_T={stop_at_t}: exiting for restart test "
                  f"(rerun without STOP_AT_T to resume)")
            break

    hist_np = {k: (np.concatenate(v) if v else np.zeros(0))
               for k, v in hist.items()}
    os.makedirs(os.path.dirname(os.path.abspath(hist_path)), exist_ok=True)
    np.savez(hist_path, **hist_np)

    # steady-state centerline profiles (the cavity benchmark observable;
    # reference plot machinery dg2D_CNS_cavity_optimized.jl:1060-1092)
    qn = np.asarray(q)
    u = qn[1] / qn[0]
    v = qn[2] / qn[0]
    y_line, u_c = extract_line(disc, u[None], axis=0, value=0.0)
    x_line, v_c = extract_line(disc, v[None], axis=1, value=0.0)

    ds = max(1, hist_np["t"].size // 2000)
    out = {
        "config": {"n": n, "k1d": k1d, "re": re, "ma": ma,
                   "bctype": bctype, "t_end": t_end, "err_tol": err_tol,
                   "dtype": str(dtype.__name__),
                   "platform": jax.devices()[0].platform},
        "t_final": float(t),
        "n_accepted": tot_acc,
        "n_rejected": tot_rej,
        "wall_s_total": wall_prev + time.time() - t_wall0,
        "resume_events": resume_events,
        "chunks": chunks,
        "history_downsampled": {k: hist_np[k][::ds].tolist()
                                for k in hist_np},
        "centerline": {
            "y": np.asarray(y_line).tolist(),
            "u_at_x0": u_c[0].tolist(),
            "x": np.asarray(x_line).tolist(),
            "v_at_y0": v_c[0].tolist(),
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"t={float(t):.2f} accepted={tot_acc} rejected={tot_rej} "
          f"wall={out['wall_s_total']:.0f}s -> {out_path}")
    print(f"max |u| on x=0 centerline: {np.abs(u_c).max():.4f}")


if __name__ == "__main__":
    main()
