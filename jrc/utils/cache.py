"""Persistent XLA compile-cache helper.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
this module sets no directory of its own. Otherwise the cache lives at the
fixed path ``.jax_cache/<machine fingerprint>`` inside the checkout: the
path is part of the cache key, and XLA:CPU results are specialized to the
compiling machine's ISA (AVX512/AMX feature set) — loading them on a
different host fails noisily and can SIGILL — so each machine gets its own
namespace.
"""
from __future__ import annotations

import hashlib
import os
import platform

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def machine_fingerprint() -> str:
    bits = [platform.machine(), platform.processor()]
    try:
        import jaxlib

        bits.append(jaxlib.__version__)
    except Exception:
        pass
    # The flags line alone is NOT enough: two hosts with identical cpuinfo
    # flags can still make LLVM infer different target features (model-
    # dependent tuning like prefer-no-scatter), and AOT results then fail to
    # load / risk SIGILL. Key on the model line and every flag/bug line.
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "model name", "microcode", "bugs")):
                    bits.append(line.strip())
                if line.strip() == "" and len(bits) > 3:
                    break  # first core only
    except OSError:
        pass
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:12]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache", machine_fingerprint())
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
