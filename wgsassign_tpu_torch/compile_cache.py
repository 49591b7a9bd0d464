"""Where the port builds its native code: the CUDA kernel library
(``_kernels``) and the Beagle reader (``_native``).

Counterpart of ``enable_compilation_cache`` in the JAX package's mesh
module, and it reads the same variable, ``WGSA_COMPILE_CACHE``, when a
build runs (not when a module is imported):

- unset or empty: ``build/`` at the root of the checkout;
- a directory: that directory, so several checkouts or an installed package
  share one set of builds;
- ``off``, ``0`` or ``none``, in any case: a temporary directory of this
  process, removed when it exits, so every process builds cold.

Each library lives in ``<root>/<name>/<hash>/``, the hash taken over its
sources and flags; the Beagle reader's also covers :func:`host_key`, since
it is built with ``-march=native``, so hosts of different CPUs that share a
directory never load each other's build.
"""

from __future__ import annotations

import atexit
import functools
import hashlib
import os
import platform
import shutil
import tempfile
from pathlib import Path

VARIABLE = "WGSA_COMPILE_CACHE"
OFF_WORDS = ("off", "0", "none")
CHECKOUT_BUILD = Path(__file__).resolve().parents[1] / "build"


@functools.lru_cache(maxsize=None)
def _process_temp_dir(pid: int) -> Path:
    path = Path(tempfile.mkdtemp(prefix=f"wgsassign_tpu_torch_build.{pid}."))
    atexit.register(shutil.rmtree, path, True)
    return path


@functools.lru_cache(maxsize=None)
def host_key() -> str:
    """A hash of what ``-march=native`` compiles for on this host: the
    machine and its first CPU's model and feature flags (``/proc/cpuinfo``;
    ``platform.processor()`` where that file is missing)."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break  # the first processor's block ends
                key = line.split(":", 1)[0].strip()
                if key in ("vendor_id", "cpu family", "model", "model name",
                           "flags", "CPU implementer", "CPU part",
                           "Features"):
                    parts.append(line.strip())
    except OSError:
        parts.append(platform.processor())
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def build_base() -> Path:
    """The directory that ``WGSA_COMPILE_CACHE`` selects (see the module
    docstring)."""
    value = os.environ.get(VARIABLE, "")
    if value.lower() in OFF_WORDS:
        return _process_temp_dir(os.getpid())
    if value:
        return Path(value).expanduser()
    return CHECKOUT_BUILD


def build_root(name: str) -> Path:
    """The directory of one library's builds, ``<base>/<name>``."""
    return build_base() / name
