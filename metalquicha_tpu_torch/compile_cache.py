"""Persistent build cache of the port's compiled kernels.

Counterpart of metalquicha_tpu's `compile_cache.py`, which points JAX's
persistent XLA cache at a directory. What the port compiles is the nvcc
build of each source in `csrc/` (seconds, at the first launch of a
process that finds no finished build), so `enable()` directs the
directory those builds are kept in, `ops.kernel_build.BUILD_DIR`: every
later process finds the shared objects there, keyed by a hash of the
source and the flags.

Call `enable()` BEFORE the first kernel launch (safe to call repeatedly; a
library that is already loaded stays loaded). The directory defaults to
`_build/` inside the package and can be overridden with MQC_COMPILE_CACHE;
"0" disables the cache: the process builds into a fresh temporary
directory, which is removed when it exits. A build that fails raises
wherever it is kept: the cache is never a way around the kernel.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

_DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def enable(path: str | None = None) -> None:
    from .ops import kernel_build

    target = path or os.environ.get("MQC_COMPILE_CACHE") or _DEFAULT
    if target == "0":
        target = tempfile.mkdtemp(prefix="mqc_build_")
        atexit.register(shutil.rmtree, target, ignore_errors=True)
    kernel_build.BUILD_DIR = Path(target)
