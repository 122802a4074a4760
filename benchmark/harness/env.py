"""The process environment of a benchmark run: every build and kernel cache
at a fixed path inside the checkout, and no library led to load JAX."""

from __future__ import annotations

import os

from .spec import BENCH_DIR

BUILD_CACHE = os.path.join(BENCH_DIR, ".build_cache")


def prepare() -> None:
    """Set before the program's first kernel launch."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD_CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD_CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the program reads these: nothing of them may change what it runs
    for name in ("MQC_FORM_VARIANT", "MQC_COMPILE_CACHE", "MQC_NO_OVERLAY"):
        os.environ.pop(name, None)
    from metalquicha_tpu_torch import compile_cache

    compile_cache.enable(os.path.join(BUILD_CACHE, "kernels"))
