"""dmlc_core_tpu_torch — the PyTorch/CUDA port of ``dmlc_core_tpu``.

Module names mirror the JAX package's.  The port imports ``torch`` and
nothing of JAX or of ``dmlc_core_tpu``; where it needs one of that
package's framework-free helpers it keeps its own copy.  It binds the same
shared C++ runtime (``build/libdmlctpu.so``) through the C API.  Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU, and raise when asked for a card that is not there.

Importing the package builds and loads nothing: the native runtime and
the CUDA kernels are built from the checkout on first use.

The top-level names are the JAX package's (its submodules, ``NativeError``,
``native_version`` and the ``data`` and ``io`` names), each imported on
first use through the module ``__getattr__``.
"""
import importlib

__version__ = "0.1.0"

_SUBMODULES = ("checkpoint", "data", "faultinject", "io", "models", "ops",
               "parallel", "telemetry", "timer")
_DATA = ("BinnedBatch", "BinnedRowIter", "BinnedStagingIter",
         "DeviceStagingIter", "PaddedBatch", "Parser", "RecordBatch",
         "RecordStagingIter", "RowBlock", "build_bin_cache")
_IO = ("FileInfo", "InputSplit", "RecordIOReader", "RecordIOWriter",
       "listdir", "open_seek_stream", "open_stream", "path_info")
#: where each top-level name lives: (module, attribute)
_LAZY = {"NativeError": ("._native", "NativeError"),
         "native_version": ("._native", "version"),
         **{n: (".data", n) for n in _DATA}, **{n: (".io", n) for n in _IO}}

__all__ = [
    "checkpoint", "data", "faultinject", "io", "models", "ops", "parallel",
    "telemetry", "timer",
    "NativeError", "native_version",
    "DeviceStagingIter", "PaddedBatch", "Parser", "RowBlock",
    "RecordBatch", "RecordStagingIter",
    "BinnedBatch", "BinnedRowIter", "BinnedStagingIter", "build_bin_cache",
    "InputSplit", "RecordIOReader", "RecordIOWriter",
    "FileInfo", "open_stream", "open_seek_stream", "listdir", "path_info",
]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module, __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
