"""Shared helpers for the example drivers."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

if os.environ.get("EXAMPLES_CPU", "0") == "1":
    jax.config.update("jax_platforms", "cpu")
if os.environ.get("EXAMPLES_X64", "0") == "1":
    jax.config.update("jax_enable_x64", True)

from esdg_cns_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def env_int(name, default):
    return int(os.environ.get(name, default))


def env_float(name, default):
    return float(os.environ.get(name, default))
