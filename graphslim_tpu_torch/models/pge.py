"""PGE — the parametrized structure generator for GCond.

Counterpart of ``graphslim_tpu/models/pge.py`` on its Pallas path: an MLP
scores every (i, j) feature pair through the fused pair kernels
(:mod:`graphslim_tpu_torch.kernels.pge`, BatchNorm statistics per
16 × 128 tile of pairs); the score matrix is symmetrized, squashed with
sigmoid and zero-diagonal'd.  The first linear factorizes over the pair
concatenation (``[x_i|x_j] W = x_i W_a + x_j W_b``), so the kernels read
only ``a = x·W₀ₐ`` and ``b = x·W₀ᵦ + b₀`` (computed here in float32).
"""

from __future__ import annotations

import dataclasses

import torch

from graphslim_tpu_torch.kernels import pge as K
from graphslim_tpu_torch.models import nn


@dataclasses.dataclass(frozen=True)
class PGEConfig:
    nfeat: int
    nnodes: int
    nhid: int = 128
    nlayers: int = 3
    # bf16 matmul operands in the pair MLP; the card's kernels take only
    # True, False runs the plain version on the CPU (the JAX parity tests)
    mm_bf16: bool = True

    @staticmethod
    def for_dataset(nfeat: int, nnodes: int, dataset: str,
                    reduction_rate: float) -> "PGEConfig":
        """Reference width policy (``parametrized_adj.py:9-17``)."""
        nhid = 128
        if dataset in ("ogbn-arxiv", "arxiv", "flickr", "reddit"):
            nhid = 256
        if dataset == "reddit" and reduction_rate == 0.01:
            nhid = 128
        return PGEConfig(nfeat=nfeat, nnodes=nnodes, nhid=nhid)


class PGE:
    def __init__(self, cfg: PGEConfig):
        if cfg.nlayers < 2:
            raise ValueError("PGE needs at least 2 layers")
        self.cfg = cfg

    def init(self, gen: torch.Generator) -> dict:
        c = self.cfg
        dims = [c.nfeat * 2] + [c.nhid] * (c.nlayers - 1) + [1]
        return {
            "layers": [nn.linear_init(gen, a, b)
                       for a, b in zip(dims[:-1], dims[1:])],
            "bns": [nn.bn_init(d, gen.device) for d in dims[1:-1]],
        }

    def scores(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Raw pair scores [n, n] (before symmetrize/sigmoid)."""
        c = self.cfg
        layers = params["layers"]
        d = x.shape[1]
        w0 = layers[0]["w"]
        a = x @ w0[:d]
        b = x @ w0[d:] + layers[0]["b"]
        hid = layers[1:-1]
        wmid = torch.stack([p["w"] for p in hid]) if hid else \
            x.new_zeros((0, c.nhid, c.nhid))
        bmid = torch.stack([p["b"] for p in hid]) if hid else \
            x.new_zeros((0, c.nhid))
        gamma = torch.stack([p["scale"] for p in params["bns"]])
        beta = torch.stack([p["bias"] for p in params["bns"]])
        wlast = layers[-1]["w"].reshape(1, -1)
        s = K.pair_scores(a, b, wmid, bmid, gamma, beta, wlast, c.nnodes,
                          c.mm_bf16)
        return s + layers[-1]["b"][0]

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        adj = self.scores(params, x)
        adj = torch.sigmoid((adj + adj.T) / 2)
        return adj - torch.diag(torch.diagonal(adj))

    def inference(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.apply(params, x)
