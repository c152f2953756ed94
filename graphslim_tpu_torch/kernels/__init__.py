"""Kernels of the port.  Hand-written CUDA C++ for Hopper (sources under
``csrc/``, built by :mod:`graphslim_tpu_torch.kernels.build`): the PGE pair
MLP (:mod:`.pge`), the blocked SpMM (:mod:`.spmm_blocked`) and the
shared-memory row gather (:mod:`.smem_gather`).  Composed of tensor ops:
the on-device sampler (:mod:`.sample`), the segment reductions
(:mod:`.segment`), the SpMM dispatch (:mod:`.spmm`) and k-means
(:mod:`.kmeans`)."""
