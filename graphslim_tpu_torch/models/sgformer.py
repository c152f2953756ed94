"""SGFormer: a linear-attention transformer branch beside a GNN branch.

Counterpart of ``graphslim_tpu/models/sgformer.py``.  The transformer
branch is the softmax-free attention ``qs·(ksᵀ vs)`` with the additive
``n·vs`` term, where ``qs`` and ``ks`` are divided by the Frobenius norm
of the whole ``[n, H, D]`` tensor (not a norm per row); the graph branch
is ``gnn_layers`` rounds of ``aggregate`` then a bias-free linear (on the
card, the blocked SpMM).  The two are mixed at ``graph_weight``.  Layer
norms take the population variance (eps 1e-5).  Dropout draws the
transformer branch's masks first, then the graph branch's.
"""

from __future__ import annotations

import torch

from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.models.base import GNNModel, aggregate


def _layer_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


class SGFormer(GNNModel):
    gnn_layers = 2
    heads = 1
    graph_weight = 0.8

    @property
    def trans_layers(self) -> int:
        return self.cfg.trans_layers

    def init(self, gen):
        c, dev = self.cfg, gen.device
        h = c.nhid
        return {
            "t_fc": nn.linear_init(gen, c.nfeat, h),
            "t_ln": [nn.bn_init(h, dev) for _ in range(self.trans_layers
                                                       + 1)],
            "t_conv": [
                {"wq": nn.linear_init(gen, h, h * self.heads),
                 "wk": nn.linear_init(gen, h, h * self.heads),
                 "wv": nn.linear_init(gen, h, h * self.heads)}
                for _ in range(self.trans_layers)],
            "g_fc": nn.linear_init(gen, c.nfeat, h),
            # built as in the JAX package; its forward reads none of them
            "g_bn": [nn.bn_init(h, dev) for _ in range(self.gnn_layers + 1)],
            "g_conv": [nn.linear_init(gen, h, h, bias=False)
                       for _ in range(self.gnn_layers)],
            "out": nn.linear_init(gen, h, c.nclass),
        }

    def _attention(self, p, x):
        n = x.shape[0]
        H, D = self.heads, x.shape[-1]
        qs = nn.linear_apply(p["wq"], x).reshape(n, H, D)
        ks = nn.linear_apply(p["wk"], x).reshape(n, H, D)
        vs = nn.linear_apply(p["wv"], x).reshape(n, H, D)
        qs = qs / torch.clamp(torch.linalg.vector_norm(qs), min=1e-12)
        ks = ks / torch.clamp(torch.linalg.vector_norm(ks), min=1e-12)
        kvs = torch.einsum("lhm,lhd->hmd", ks, vs)
        num = torch.einsum("nhm,hmd->nhd", qs, kvs) + n * vs
        denom = torch.einsum("nhm,hm->nh", qs, ks.sum(0))[..., None] + n
        return (num / denom).mean(1)

    def _forward(self, params, x, adj, *, training, gen):
        c = self.cfg
        t = nn.linear_apply(params["t_fc"], x)
        t = torch.relu(_layer_norm(t, params["t_ln"][0]))
        t = nn.dropout(gen, t, c.dropout, training)
        hist = [t]
        for i in range(self.trans_layers):
            t = self._attention(params["t_conv"][i], t)
            t = (t + hist[i]) / 2.0
            t = torch.relu(_layer_norm(t, params["t_ln"][i + 1]))
            t = nn.dropout(gen, t, c.dropout, training)
            hist.append(t)
        g = torch.relu(nn.linear_apply(params["g_fc"], x))
        g = nn.dropout(gen, g, c.dropout, training)
        for i in range(self.gnn_layers):
            g = nn.linear_apply(params["g_conv"][i], aggregate(adj, g))
            g = nn.dropout(gen, torch.relu(g), c.dropout, training)
        out = self.graph_weight * g + (1 - self.graph_weight) * t
        return nn.linear_apply(params["out"], out)
