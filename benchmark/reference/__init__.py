"""Plain references the benchmark judges the port by: straightforward
PyTorch and NumPy implementations of the same semantics, independent of
the code under test.  Nothing here imports the port (``dmlc_core_tpu_torch``),
JAX or the JAX package; nothing here takes anything the port has made
except the outputs it judges."""
