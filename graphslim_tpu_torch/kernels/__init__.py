"""Kernels of the port: the hand-written CUDA PGE pair MLP
(:mod:`graphslim_tpu_torch.kernels.pge`, sources under ``csrc/``) and the
on-device sampler composed of tensor ops."""
