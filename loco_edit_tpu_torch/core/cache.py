"""Where the port's compiled kernels live (port of loco_edit_tpu/core/cache.py).

The JAX package points XLA's persistent compilation cache at a directory so
that a restarted CLI or server finds its programs compiled. The port's
counterpart is the build directory of its native code: the CUDA kernels of
csrc/ (ops/_cuda.py) and the host image pipeline (native/). Both loaders
read `build_dir()`, so a rebuild happens only when a source changes, and an
install into a read-only site-packages still builds.

Resolution order, as in the JAX package:
  1. `LOCO_COMPILE_CACHE`: a directory path, or `0`/`off` for a fresh build
     into a temporary directory that is removed at exit (for build-time
     measurements, which must start cold).
  2. The checkout's `loco_edit_tpu_torch/_build/` (git-ignored), when the
     package is run from a source tree.
  3. `~/.cache/loco_edit_tpu_torch/build` for an installed package.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

_DISABLE = {"0", "off", "false", "no"}
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_resolved: str | None = None


def default_cache_dir() -> str:
    """The checkout's `_build/` beside the sources when the package runs
    from a source tree, else a user-level cache directory."""
    root = os.path.dirname(_PKG)
    installed = os.path.basename(root) in ("site-packages", "dist-packages")
    if not installed and os.access(_PKG, os.W_OK):
        return os.path.join(_PKG, "_build")
    return os.path.join(os.path.expanduser("~"), ".cache", "loco_edit_tpu_torch",
                        "build")


def enable_compile_cache() -> str:
    """Resolve the build directory (idempotent: the first call decides for
    the process), create it and return it."""
    global _resolved
    if _resolved is not None:
        return _resolved
    env = os.environ.get("LOCO_COMPILE_CACHE", "").strip()
    if env and env.lower() in _DISABLE:
        path = tempfile.mkdtemp(prefix="loco_build_")
        atexit.register(shutil.rmtree, path, True)
    else:
        path = env or default_cache_dir()
        os.makedirs(path, exist_ok=True)
    _resolved = path
    return path


def build_dir() -> str:
    """The directory the loaders build into and load from."""
    return enable_compile_cache()
