"""Test configuration: run JAX on CPU with float64 and 8 virtual devices.

The sharding tests exercise the multi-device path on a virtual 8-device
CPU mesh (the same mechanism ``__graft_entry__.dryrun_multichip`` uses);
numerics tests need float64 to verify entropy conservation to ~1e-12.
The GPU runs are ``chip_smoke.py`` and ``bench.py`` (README).
"""

import os

# the tests run on the host CPU
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_max_isa" not in flags:
    # x86 FMA contraction breaks the error-free transformations behind
    # the compensated/df64 arithmetic (measured: fl(p+2e) instead of
    # fl(p+e) in the renormalization — utils/compensated.py).  AVX(1)
    # has no FMA instructions, so restricting codegen to it makes every
    # f32 op round individually, which is what the EFTs require.  Other
    # backends are checked at build time by utils.df64.require_exact_eft.
    flags = (flags + " --xla_cpu_max_isa=AVX").strip()
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# every test compiles fresh: no persistent compile cache, whatever an
# entry point under test sets (utils.compile_cache)
jax.config.update("jax_enable_compilation_cache", False)
