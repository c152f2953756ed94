"""GDEM — graph distillation by eigenbasis matching.

Counterpart of ``graphslim_tpu/reduce/gdem.py`` (reference
``graphslim/condensation/gdem.py`` and ``condensation/utils.py:457-628``):

* the normalized Laplacian of the largest connected component and its
  smallest eigenpairs: a dense ``numpy.linalg.eigh`` up to 6000 nodes,
  above that ``k = min(1000, n − 1)`` pairs from :func:`eigsh_smallest`;
  cached under ``save_path/eigen/<dataset>``;
* learnable eigenvectors ``[n_syn, eigen_k]`` (started from an SBM
  graph's Laplacian basis) and synthetic features, against α · the
  subspace-covariance match + β · the class-embedding match + γ · the
  orthogonality of the eigenvectors; Adam steps of the eigenvectors for
  ``e1`` epochs, then of the features for ``e2``.

The large-graph eigensolve (``eigen_backend``): ``device`` is the
Chebyshev-filtered subspace iteration :func:`filtered_subspace_smallest`,
whose products with the normalized adjacency go through
``SparseAdj.matmul`` (on the card: the blocked SpMM, here at the width
k + q); ``host`` is ARPACK.  The device result is kept only when its
largest residual is below 1e-2; otherwise a warning is logged and ARPACK
runs.  ``auto`` is the device on the card and the host on the CPU.
"""

from __future__ import annotations

import logging
import math
import os
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch
from scipy.sparse.linalg import eigsh

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.data import synthetic
from graphslim_tpu_torch.reduce.cond_base import CondensationBase

log = logging.getLogger("graphslim_tpu_torch")

_DENSE_EIG_CUTOFF = 6000
_RESIDUAL_GATE = 1e-2


def filtered_subspace_smallest(adj: G.SparseAdj, n: int, k: int,
                               sweeps: int = 15, degree: int = 24,
                               tol: float = 1e-3, seed: int = 0) -> tuple:
    """The ``k`` smallest eigenpairs of ``L = I − An`` by Chebyshev-filtered
    subspace iteration on ``k + q`` columns (q = min(max(k // 10, 8),
    n − k)) → (eigenvalues, eigenvectors as float64 numpy, largest
    residual, sweeps run).

    Each sweep applies a degree-``degree`` Chebyshev polynomial of ``An``
    that damps ``[−1, lo]`` and grows on the wanted top of ``An``'s
    spectrum, orthonormalizes (QR), and rotates by Rayleigh–Ritz on ``L``;
    ``lo`` follows the current Ritz values.  It stops when the largest
    residual ``‖Lv − λv‖`` of the ``k`` wanted pairs is below ``tol``."""
    q = min(max(k // 10, 8), n - k)
    kq = k + q
    X = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, kq)).astype(np.float32), device=adj.device)

    def cheb(X, lo):
        c, e = (lo - 1.0) / 2.0, (lo + 1.0) / 2.0
        y0, y1 = X, (adj.matmul(X) - c * X) / e
        for _ in range(degree - 1):
            y0, y1 = y1, (2.0 / e) * (adj.matmul(y1) - c * y1) - y0
        return y1

    lo = 0.0                     # first pass: grow μ(An) > 0
    for it in range(sweeps):
        Q, _ = torch.linalg.qr(cheb(X, lo))
        T = Q.T @ (Q - adj.matmul(Q))
        w, S = torch.linalg.eigh((T + T.T) / 2.0)
        X = Q @ S                # Ritz vectors, λ ascending
        res = torch.linalg.norm((X - adj.matmul(X)) - X * w[None, :], dim=0)
        r = float(res[:k].max())
        if r < tol:
            break
        # damp everything below the (k + q/2)-th wanted direction
        lo = float(np.clip(1.0 - float(w[min(k + q // 2, kq - 1)]), -0.95,
                           0.999))
    return (w[:k].double().cpu().numpy(), X[:, :k].double().cpu().numpy(),
            r, it + 1)


def eigsh_smallest(An: sp.spmatrix, k: int, backend: str, device,
                   seed: int = 0) -> tuple:
    """The ``k`` smallest eigenpairs of ``I − An`` → (values, vectors,
    info).  ``backend`` auto | host | device; ``auto`` is the device when
    ``device`` is a CUDA card.  The device path runs when ``k ≤ n / 6``
    and is kept when its residual is below 1e-2; otherwise ARPACK runs
    (``info['arpack']``)."""
    if backend not in ("auto", "host", "device"):
        raise ValueError(
            f"eigen_backend must be auto|host|device, got {backend!r}")
    if backend == "auto":
        backend = "device" if torch.device(device).type == "cuda" \
            else "host"
    n = An.shape[0]
    info = {"backend": backend, "n": n, "k": k, "arpack": False}
    if backend == "device" and k <= n // 6:
        coo = An.tocoo()
        adj = G.from_edge_index(
            np.stack([coo.row, coo.col]).astype(np.int64), n,
            edge_weight=coo.data.astype(np.float32), dedup=False,
            device=device)
        t0 = time.perf_counter()
        vals, vecs, resid, sweeps = filtered_subspace_smallest(
            adj, n, k, seed=seed)
        info.update(sweeps=sweeps, residual=resid,
                    device_seconds=time.perf_counter() - t0)
        if resid < _RESIDUAL_GATE:
            log.info("filtered-subspace eigensolve: n=%d k=%d sweeps=%d "
                     "resid=%.2e", n, k, sweeps, resid)
            return vals, vecs, info
        log.warning("device eigensolve residual %.2e too large; falling "
                    "back to host ARPACK", resid)
    info["arpack"] = True
    L = sp.eye(n) - An
    vals, vecs = eigsh(L, k=k, which="SA", tol=1e-5)
    return vals, vecs, info


def subspace_covariance(eigenvecs: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
    """[k, d, d] per-direction outer products of the L2-normalized
    spectral projection ``Uᵀx``."""
    x_trans = eigenvecs.T @ x
    x_trans = x_trans / torch.clamp(
        torch.linalg.norm(x_trans, dim=1, keepdim=True), min=1e-12)
    return torch.einsum("kd,ke->kde", x_trans, x_trans)


def embed_mean(eigenvals, eigenvecs, x, onehot) -> torch.Tensor:
    """Normalized per-class mean of ``U diag(1 − λ) Uᵀ x``."""
    x_trans = (1.0 - eigenvals)[:, None] * (eigenvecs.T @ x)
    cls = onehot.T @ (eigenvecs @ x_trans)
    cls = cls / torch.clamp(onehot.sum(0)[:, None], min=1.0)
    return cls / torch.clamp(torch.linalg.norm(cls, dim=1, keepdim=True),
                             min=1e-12)


class GDEM(CondensationBase):
    with_structure = False   # the structure comes from the eigenbasis

    def __init__(self, data, args):
        args = args.replace(eigen_k=min(args.eigen_k, 256))
        super().__init__(data, args)
        self.eigen_k = min(args.eigen_k, self.n_syn)
        self.eigen_info: dict = {}

    # -- spectral preprocessing ------------------------------------------
    def lcc_eigen(self, data: G.Dataset) -> tuple:
        """(LCC node ids, eigenvalues, eigenvectors) of the normalized
        Laplacian ``I − D^-1/2 (A + I) D^-1/2`` of the largest connected
        component of the real graph (the train subgraph in the inductive
        setting), cached under ``save_path/eigen/<dataset>``."""
        cache = os.path.join(self.args.save_path, "eigen", data.name)
        os.makedirs(cache, exist_ok=True)
        vp, up, ip = (os.path.join(cache, f) for f in (
            "eigenvalues.npy", "eigenvectors.npy", "idx_lcc.npy"))
        if os.path.exists(vp) and os.path.exists(up):
            return np.load(ip), np.load(vp), np.load(up)
        host = data.train_host()
        n = host.n_rows
        W = sp.csr_matrix((host.values_or_ones(), (host.row, host.col)),
                          shape=(n, n))
        _, comp = csgraph.connected_components(W, directed=False)
        idx_lcc = np.flatnonzero(comp == np.argmax(np.bincount(comp)))
        Wl = W[np.ix_(idx_lcc, idx_lcc)] + sp.eye(idx_lcc.shape[0])
        dinv = 1.0 / np.sqrt(np.maximum(np.asarray(Wl.sum(1)).ravel(),
                                        1e-12))
        An = sp.diags(dinv) @ Wl @ sp.diags(dinv)
        if Wl.shape[0] <= _DENSE_EIG_CUTOFF:
            vals, vecs = np.linalg.eigh((sp.eye(Wl.shape[0]) - An)
                                        .toarray())
            self.eigen_info = {"backend": "dense", "n": Wl.shape[0]}
        else:
            vals, vecs, self.eigen_info = eigsh_smallest(
                An, min(1000, Wl.shape[0] - 1), self.args.eigen_backend,
                data.device, seed=self.args.seed or 0)
        np.save(vp, vals)
        np.save(up, vecs)
        np.save(ip, idx_lcc)
        return idx_lcc, vals, vecs

    @staticmethod
    def syn_eigen(vals, vecs, eigen_k: int, ratio: float) -> tuple:
        """The ``⌈eigen_k · ratio⌉`` smallest and the rest largest
        directions."""
        k1 = math.ceil(eigen_k * ratio)
        total = vals.shape[0]
        sel = list(range(k1)) + list(range(total - (eigen_k - k1), total))
        return vals[sel], vecs[:, sel]

    def init_eigenvecs(self) -> torch.Tensor:
        """The first ``eigen_k`` Laplacian eigenvectors of an SBM graph on
        ``n_syn`` nodes (the data layer's generator)."""
        n_syn, C = self.n_syn, self.nclass
        ei, _, _ = synthetic.generate(
            n_syn, 8, C, avg_degree=max(n_syn / C / 3.0, 2.0),
            homophily=0.75, seed=self.args.seed)
        adj = G.from_edge_index(ei, n_syn, symmetrize=True, device="cpu")
        dense = G.gcn_norm(adj).to_dense().numpy()
        _, vecs = np.linalg.eigh(np.eye(n_syn) - dense)
        return torch.as_tensor(vecs[:, :self.eigen_k], dtype=torch.float32,
                               device=self.data.device)

    def syn_adj(self, u_syn: torch.Tensor, vals: torch.Tensor
                ) -> torch.Tensor:
        """``I − U diag(λ) Uᵀ``."""
        return torch.eye(self.n_syn, device=u_syn.device) \
            - (u_syn * vals[None, :]) @ u_syn.T

    def loss_fn(self, vals, co_real, mean_real, onehot_syn):
        args = self.args
        iden_c = torch.eye(self.nclass, device=vals.device)
        iden_k = torch.eye(self.eigen_k, device=vals.device)

        def loss_of(x, u):
            l_eigen = ((subspace_covariance(u, x) - co_real) ** 2).mean()
            mean_syn = embed_mean(vals, u, x, onehot_syn)
            l_class = ((mean_real @ mean_syn.T - iden_c) ** 2).mean()
            l_orth = ((u.T @ u - iden_k) ** 2).mean()
            return (args.alpha * l_eigen + args.beta * l_class
                    + args.gamma * l_orth)

        return loss_of

    def real_targets(self, data: G.Dataset, idx_lcc, vals, vecs) -> tuple:
        """(subspace covariance, class-embedding means) of the real LCC."""
        dev = data.device
        x_lcc = self.real.features[torch.as_tensor(idx_lcc, device=dev)]
        co_real = subspace_covariance(vecs, x_lcc)
        train = data.pool_ids()
        train_lcc = train[np.isin(train, idx_lcc)]
        onehot = np.zeros((idx_lcc.shape[0], self.nclass), dtype=np.float32)
        onehot[np.searchsorted(idx_lcc, train_lcc)] = np.eye(
            self.nclass, dtype=np.float32)[
                self.real.labels_real.cpu().numpy()[train_lcc]]
        mean_real = embed_mean(vals, vecs, x_lcc,
                               torch.as_tensor(onehot, device=dev))
        return co_real, mean_real

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        dev = data.device
        idx_lcc, vals_lcc, vecs_lcc = self.lcc_eigen(data)
        vals, vecs = self.syn_eigen(vals_lcc, vecs_lcc, self.eigen_k,
                                    args.ratio)
        vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
        vecs = torch.as_tensor(vecs, dtype=torch.float32, device=dev)
        co_real, mean_real = self.real_targets(data, idx_lcc, vals, vecs)
        onehot_syn = torch.nn.functional.one_hot(
            self.labels_syn, self.nclass).to(torch.float32)
        loss_of = self.loss_fn(vals, co_real, mean_real, onehot_syn)

        x_syn = self.init_feat_syn(verbose).requires_grad_(True)
        u_syn = self.init_eigenvecs().requires_grad_(True)
        opt_x, opt_u = utils.Adam(args.lr_feat), utils.Adam(args.lr_eigenvec)
        sx, su = opt_x.init([x_syn]), opt_u.init([u_syn])
        best_val = 0.0
        self._best_reduced = None
        self.losses = []
        period = max(args.e1 + args.e2, 1)
        for ep in range(args.epochs):
            with torch.enable_grad():
                loss = loss_of(x_syn, u_syn)
                gx, gu = torch.autograd.grad(loss, [x_syn, u_syn])
            if ep % period < args.e1:
                opt_u.step([u_syn], [gu], su)
            else:
                opt_x.step([x_syn], [gx], sx)
            self.losses.append(loss.detach())
            if ep in args.checkpoints:
                best_val = self.intermediate_evaluation(
                    x_syn, self.syn_adj(u_syn.detach(), vals), best_val, ep,
                    loss.item(), verbose)
        if self._best_reduced is not None:
            return self._best_reduced
        return G.Reduced(feat=x_syn.detach().clone(),
                         adj=self.syn_adj(u_syn.detach(), vals),
                         labels=self.labels_syn)
