"""opal_tpu_torch: opal_tpu's sequence-alignment engine on PyTorch and CUDA.

The port of opal_tpu (JAX/Pallas on a TPU) to one NVIDIA H100. The DP
kernel is written by hand in CUDA C++ (engine/csrc/ragged_dp.cu); around it
the engine is plain PyTorch and numpy, and it imports nothing of JAX or of
opal_tpu. Entry points run on "cuda" unless the caller passes
device="cpu", which runs each kernel's plain PyTorch version instead.

Importing the package builds nothing and touches no device: the search API
below loads lazily, and the kernel compiles at its first launch.
"""
from .constants import (  # noqa: F401
    ALIGN_DEL,
    ALIGN_INS,
    ALIGN_MATCH,
    ALIGN_MISMATCH,
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    OVERFLOW_BUCKETS,
    OVERFLOW_SIMPLE,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from .matrices import ScoreMatrix  # noqa: F401
from .result import SearchResult, init_results  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports so `import opal_tpu_torch` stays cheap (no torch import).
    if name in ("search_database", "search_database_arrays",
                "search_database_multi_arrays", "Engine", "EngineConfig"):
        from .engine import search as _s

        return getattr(_s, name)
    if name == "search_database_char_sw":
        from .engine import cascade as _c

        return _c.search_database_char_sw
    raise AttributeError(name)
