"""The persistent-compilation-cache policy of the launch entry points, as
the reference names it (``repro.launch.jitcache``).

The reference points jax's persistent compilation cache at a directory so
that a restarted process loads its compiled programs from disk. The port
compiles nothing per program: its only compiled code is the kernels,
which `kernels.build` builds once into ``src/repro_torch/_build/`` (file
names keyed by a hash of source and flags) and every later process loads
from there. So these functions keep the reference's names and arguments,
return that build directory, and change nothing. ``--jit-cache`` on
`launch.train` and `launch.bidserve`, and ``WorkerSpec.jit_cache``, go
through them.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.build import BUILD_DIR


def default_cache_dir() -> str:
    """Where compiled code persists across runs: the kernels' build
    directory."""
    return BUILD_DIR


def cache_dir_for_run(run_dir: str) -> str:
    """The per-run cache location. The kernels are shared by every run,
    so this is the same build directory for every ``run_dir``."""
    del run_dir
    return BUILD_DIR


def enable_persistent_cache(cache_dir: Optional[str] = None,
                            min_compile_secs: float = 0.0) -> str:
    """Accepts the reference's arguments and returns the build directory
    the kernels load from; there is nothing to enable."""
    del cache_dir, min_compile_secs
    return BUILD_DIR
