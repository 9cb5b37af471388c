"""Runnable programs of the port, the counterparts of the JAX package's
``examples/``: each runs as ``python -m
dmlc_core_tpu_torch.examples.<name>`` with its JAX counterpart's flags,
synthetic data, printed lines and exit code, plus ``--device`` (the card
by default; ``--device cpu`` runs the kernels' plain versions), and
exposes ``main(argv=None) -> int``.

* ``train_linear``: a libsvm file staged onto the device, sparse logistic
  regression by SGD (``--shard``: data parallel over the job's ranks).
* ``train_ffm``: a libfm file with field ids, the field-aware FM.
* ``gbdt_train``: the histogram GBDT, dense (densify, bin, ``fit``),
  ``--native-sparse`` (``fit_batch`` on the staged CSR rows with
  streamed cuts), ``--rank`` (``rank:pairwise`` over qid groups),
  ``--missing``, ``--shard`` and ``--kernel-mesh``.
* ``distributed_train``: one rank of a multi-process linear job, under
  ``python -m dmlc_core_tpu_torch.tracker.dmlc_submit`` or
  ``--coord/--nprocs/--pid``.
"""
