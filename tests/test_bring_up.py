"""Entry-point plumbing shared by bench.py, chip_smoke.py, the CLI and
the examples: the compile-cache rule, the device/card report, the bench
runners at tiny sizes, the build-time guard of the double-float paths
and the profiler-trace reduction."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402
from esdg_cns_tpu.utils import compile_cache, device_info, df64  # noqa: E402


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set(monkeypatch, tmp_path, cache_config):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; the helper
    sets no other directory."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch, cache_config):
    """Unset: the cache goes to <repo>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("stdout,want", [
    (None, []),
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", ["NVIDIA H100 80GB HBM3, 700.00 W"]),
])
def test_card_lines(monkeypatch, stdout, want):
    def fake_run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        if stdout is None:
            raise FileNotFoundError(cmd[0])
        return subprocess.CompletedProcess(cmd, 0, stdout=stdout)

    monkeypatch.setattr(device_info.subprocess, "run", fake_run)
    assert device_info.card_lines() == want


def test_jax_device_report():
    d = device_info.jax_device()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": jax.device_count()}


@pytest.mark.parametrize("name", sorted(bench.RUNNERS))
def test_bench_runner_tiny(name, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    n, k1d = (2, 4) if name == "cns_cavity" else (2, 2)
    r = bench.RUNNERS[name](n=n, k1d=k1d, steps=2, reps=2)
    assert r["finite"] and r["dtype"] == "float32"
    assert r["reps"] == 2 and r["steps"] == 2
    assert r["value"] == pytest.approx(r["dof"] * 10 / r["median_elapsed_s"])
    assert r["best"] >= r["value"]


def test_bench_refuses_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert "GPU" in str(e.value.code)
    assert capsys.readouterr().out == ""


def _builders():
    from esdg_cns_tpu.presets import euler_hex_3d, lid_driven_cavity
    from esdg_cns_tpu.solvers import (make_cns_rhs, make_cns_rhs_affine,
                                      make_euler_rhs)
    from esdg_cns_tpu.solvers.euler_df64 import make_euler_rhs_df64

    def df64_rhs():
        disc, _, host = euler_hex_3d(n=1, k1d=2, dtype=jnp.float32,
                                     return_host=True)
        return make_euler_rhs_df64(disc, host)

    def euler():
        disc, _ = euler_hex_3d(n=1, k1d=2)
        return make_euler_rhs(disc, rhstest_mode="compensated")

    def cns(builder):
        def build():
            disc, _, bc, p = lid_driven_cavity(n=1, k1d=2)
            return builder(disc, mu=p["mu"], bc=bc,
                           rhstest_mode="compensated")
        return build

    return {"df64": df64_rhs, "euler_compensated": euler,
            "cns_compensated": cns(make_cns_rhs),
            "cns_affine_compensated": cns(make_cns_rhs_affine)}


@pytest.mark.parametrize("which", ["df64", "euler_compensated",
                                   "cns_compensated",
                                   "cns_affine_compensated"])
def test_double_float_paths_refuse_inexact_backend(which, monkeypatch):
    """A backend that breaks the error-free transformations makes every
    double-float path refuse to build, naming native float64 — never an
    inexact number returned quietly.  On an exact backend they build."""
    build = _builders()[which]
    build()                                   # exact here (AVX pin)

    def broken():
        raise RuntimeError("contracted into FMA")

    monkeypatch.setattr(df64, "verify_eft", broken)
    monkeypatch.setattr(df64, "_EFT_FAILURES", {})
    with pytest.raises(RuntimeError, match="native float64"):
        build()


def test_trace_reduction(monkeypatch, tmp_path):
    """examples/trace_rhs.py: busy time is the union of the op intervals
    on the busiest device timeline; host planes are ignored."""
    from types import SimpleNamespace as NS

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), "..",
                                             "examples"))
    import trace_rhs

    def line(name, evs):
        return NS(name=name, events=[NS(name=n, start_ns=s, duration_ns=d)
                                     for n, s, d in evs])

    host = NS(name="/host:CPU", lines=[line("python", [("x", 0, 1000)])])
    gpu = NS(name="/device:GPU:0", lines=[
        line("Stream #1", [("a", 0, 10), ("b", 5, 10), ("a", 30, 10),
                           ("c", 90, 5)]),
        line("XLA Modules", [("jit_run", 0, 95)]),
    ])
    r = trace_rhs.reduce_planes([host, gpu], top=2)
    assert r["timeline_used"] == "/device:GPU:0 | Stream #1"
    # busy: [0,15) + [30,40) + [90,95)
    assert r["window_ns"] == 95 and r["busy_ns"] == 30
    assert r["idle_share"] == pytest.approx(65 / 95)
    assert [(op["name"], op["ns"]) for op in r["top_ops"]] == [("a", 20),
                                                                ("b", 10)]
    with pytest.raises(RuntimeError, match="no device timeline"):
        trace_rhs.reduce_planes([host])
