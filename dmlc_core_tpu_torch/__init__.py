"""dmlc_core_tpu_torch — the PyTorch/CUDA port of ``dmlc_core_tpu``.

Module names mirror the JAX package's.  The port imports ``torch`` and
nothing of JAX or of ``dmlc_core_tpu``; where it needs one of that
package's framework-free helpers it keeps its own copy.  It binds the same
shared C++ runtime (``build/libdmlctpu.so``) through the C API.  Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU, and raise when asked for a card that is not there.

Importing the package builds and loads nothing: the native runtime and
the CUDA kernels are built from the checkout on first use.
"""
