"""Plain PyTorch reference of GCond's outer steps, for the correctness
check.

Written from GCond's published algorithm (Jin et al., ICLR 2022;
GraphSlim's ``gcond`` agent) and the port's stated semantics, with none of
the port's code: NumPy and SciPy build the graph, everything else is
plain ``torch`` in float32 with TF32 off, class by class, with no kernel,
no batching over classes and no cache.

* The real graph: the twin's edges made symmetric, duplicates and self
  loops dropped, then ``D^-1/2 (A + I) D^-1/2`` (transductive: the whole
  graph; inductive: the subgraph induced on the train nodes).  Features
  standardized by the train rows' mean and population deviation.
* Class budgets: classes by train count ascending, each
  ``max(int(count·r), 1)``, the largest taking what is left of
  ``int(n_train·r)``.
* A sampled block (judged by :func:`judge_sample`): every hop gives each
  target ``fanout`` slots and a self slot, last.  A target of degree at
  most the fanout holds each of its neighbours once and pads with itself;
  a larger one holds neighbours drawn with replacement, weighted by
  ``deg / fanout``.  The weights are the reference's own Â values.
* The condense model, SGC: ``ntrans`` linears with ReLU between, then
  ``nlayers`` propagations, log-softmax; the real loss is the mean NLL
  over a class's valid targets, the synthetic one over its synthetic
  nodes.
* The match loss (``dis_metric='ours'``): for each weight matrix
  ``[in, out]`` of the per-class gradients, the sum over its rows of
  ``1 − cos`` between the synthetic and the real row; biases are left
  out; classes weigh ``budget / n_syn``.
* The PGE: ``[x_i | x_j]`` through linears of widths ``2d → H → … → 1``,
  BatchNorm (batch statistics, biased variance, ε = 1e-5) and ReLU after
  each hidden linear; BatchNorm's population is each 16 × 128 tile of
  pairs, those outside ``[n, n]`` left out (the port's stated semantics,
  from its TPU kernel); the hidden H × H products take bf16 operands
  with float32 sums, as the configuration states.  Then
  ``sigmoid((S + Sᵀ)/2)`` with a zero diagonal, and
  ``D^-1/2 (A + I) D^-1/2``.
* GCond's schedule: epochs with ``epoch % 50 < 10`` step the PGE, the
  others the features; Adam (β 0.9 / 0.999, ε 1e-8, bias-corrected)
  on each; after every outer step ``inner_loop`` Adam steps of the model
  on the detached synthetic graph.

``precision='tf32'`` is the control: the same computation with the
float32 products in TF32 (the card's TF32 path on a CUDA device; on the
CPU each product's operands rounded to TF32 in the forward).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

TI, TJ = 16, 128
BN_EPS = 1e-5
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (10 mantissa bits, to nearest even), keeping the
    gradient as it is."""
    i = x.detach().contiguous().view(torch.int32)
    r = (i + (0xFFF + ((i >> 13) & 1))) & -8192
    return x + (r.view(torch.float32) - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class Precision:
    """How the reference's float32 products run: ``fp32`` (TF32 off) or
    ``tf32`` (the control)."""

    def __init__(self, mode: str, device):
        if mode not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.emulate = mode == "tf32" and torch.device(device).type != "cuda"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.emulate:
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        if self.emulate:
            a, b = round_tf32(a), round_tf32(b)
        return torch.einsum(eq, a, b)

    @contextlib.contextmanager
    def active(self):
        m, c = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32" and not self.emulate
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = m
            torch.backends.cudnn.allow_tf32 = c


# ---------------------------------------------------------------------------
# The real graph
# ---------------------------------------------------------------------------

class RealGraph:
    """The graph the condensation matches against, on ``device``."""

    def __init__(self, arrays: dict, setting: str, device):
        import scipy.sparse as sp

        dev = torch.device(device)
        n_all = arrays["feat"].shape[0]
        ei = np.asarray(arrays["edge_index"], dtype=np.int64)
        A = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                          shape=(n_all, n_all)).tocsr()
        A = ((A + A.T) > 0).astype(np.float64).tocsr()
        A.setdiag(0)
        A.eliminate_zeros()
        tr = np.sort(np.asarray(arrays["idx_train"], dtype=np.int64))
        feat = np.asarray(arrays["feat"], dtype=np.float64)
        mu, sd = feat[tr].mean(0), feat[tr].std(0)
        feat = (feat - mu) / np.maximum(sd, 1e-12)
        labels = np.asarray(arrays["labels"], dtype=np.int64)
        if setting == "ind":
            A = A[tr][:, tr].tocsr()
            feat, labels = feat[tr], labels[tr]
            pool = np.arange(tr.shape[0])
        else:
            pool = tr
        A.sort_indices()
        n = A.shape[0]
        deg = np.asarray(A.sum(1)).ravel()
        dinv = (deg + 1.0) ** -0.5
        row = np.repeat(np.arange(n), np.diff(A.indptr))
        vals = dinv[row] * dinv[A.indices]
        self.n = n
        self.keys = torch.as_tensor(row * n + A.indices, device=dev)
        self.vals = torch.as_tensor(vals.astype(np.float32), device=dev)
        self.self_vals = torch.as_tensor((dinv * dinv).astype(np.float32),
                                         device=dev)
        self.deg = torch.as_tensor(deg.astype(np.int64), device=dev)
        self.feat = torch.as_tensor(feat.astype(np.float32), device=dev)
        self.labels = torch.as_tensor(labels, device=dev)
        self.pool = pool
        self.pool_labels = labels[pool]
        self.device = dev

    def lookup(self, t: torch.Tensor, s: torch.Tensor) -> tuple:
        """(whether s is a neighbour of t, Â[t, s] where it is)."""
        key = t * self.n + s
        pos = torch.searchsorted(self.keys, key).clamp(
            max=self.keys.numel() - 1)
        hit = self.keys[pos] == key
        return hit, torch.where(hit, self.vals[pos],
                                torch.zeros_like(self.vals[pos]))


def class_budgets(labels_pool: np.ndarray, r: float) -> tuple:
    """(sorted classes, {class: budget}, labels_syn) by the rule above;
    the synthetic labels run class after class, smallest class first."""
    classes, counts = np.unique(labels_pool, return_counts=True)
    order = np.argsort(counts, kind="stable")
    total = int(labels_pool.shape[0] * r)
    budgets, labels, running = {}, [], 0
    for i, ix in enumerate(order):
        c, num = int(classes[ix]), int(counts[ix])
        b = total - running if i == len(order) - 1 else int(num * r)
        b = min(max(b, 1), num)
        budgets[c] = b
        running += b
        labels += [c] * b
    return sorted(budgets), budgets, np.asarray(labels, dtype=np.int64)


def class_pools(g: RealGraph, classes: list) -> list:
    return [np.sort(g.pool[g.pool_labels == c]) for c in classes]


# ---------------------------------------------------------------------------
# Judging a sampled block
# ---------------------------------------------------------------------------

def expected_valid(pools: list, batch: int, device) -> torch.Tensor:
    """Which target slots of each class count: all of a pool larger than
    the batch, else one slot per pool member."""
    C = len(pools)
    slot = torch.arange(batch, device=device)[None, :]
    cnt = torch.as_tensor([len(p) for p in pools], device=device)[:, None]
    return (slot < cnt) | (cnt > batch)


def block_weights(g: RealGraph, targets: torch.Tensor, src: torch.Tensor
                  ) -> tuple:
    """The reference's weights of one hop, and its violations.

    ``targets [m]``, ``src [m, f + 1]`` (self slot last) →
    ``(weights [m, f + 1], number of slots that break the rules)``."""
    m, s = src.shape
    f = s - 1
    deg = g.deg[targets]
    slot = torch.arange(f, device=src.device)[None, :]
    nb = src[:, :f]
    t = targets[:, None].expand(m, f)
    hit, val = g.lookup(t.reshape(-1), nb.reshape(-1))
    hit, val = hit.reshape(m, f), val.reshape(m, f)
    small = (deg <= f)[:, None]
    real = (slot < deg[:, None]) | ~small
    bad = (real & ~hit) | (~real & (nb != t))
    # a target of degree <= f holds each neighbour once
    marked = torch.where(real & small, nb, -1 - slot)
    srt = torch.sort(marked, dim=1).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
    bad_self = (src[:, f] != targets).sum()
    scale = torch.where(small[:, 0], torch.ones_like(deg, dtype=val.dtype),
                        deg.to(val.dtype) / f)
    w = torch.where(real, val, torch.zeros_like(val)) * scale[:, None]
    w = torch.cat([w, g.self_vals[targets][:, None]], dim=1)
    return w, int(bad.sum() + dup + bad_self)


def judge_sample(g: RealGraph, pools: list, batch: int, sample: dict
                 ) -> tuple:
    """(the reference's weights per level, [C, m, f + 1] each, and the
    number of violations: targets outside their class pool, a valid mask
    other than the pool's, a pool not covered by a small class's slots,
    neighbours that are not, missing or repeated neighbours, a wrong self
    slot, and weights that differ from Â's by more than 1e-5 of a weight).
    """
    dev = g.device
    targets, valid = sample["targets"], sample["valid"]
    C, B = targets.shape
    bad = int((valid != expected_valid(pools, batch, dev)).sum())
    for c, p in enumerate(pools):
        pt = torch.as_tensor(p, device=dev)
        tc = targets[c]
        pos = torch.searchsorted(pt, tc).clamp(max=len(p) - 1)
        bad += int((pt[pos] != tc).sum())
        if len(p) <= B:
            bad += len(p) - int(torch.unique(tc[valid[c]]).numel())
    ids, ws = sample["ids"], sample["ws"]
    if not torch.equal(ids[-1].reshape(C, -1), targets):
        bad += 1
    weights = [None] * len(ws)
    for lvl in range(len(ws)):
        tg = ids[lvl + 1].reshape(-1)
        s = ws[lvl].shape[-1]
        src = ids[lvl].reshape(-1, s)
        w, b = block_weights(g, tg, src)
        w_prog = ws[lvl].reshape(-1, s)
        tol = 1e-5 * w.abs().max().clamp(min=1e-30)
        b += int(((w_prog - w).abs() > tol).sum())
        bad += b
        weights[lvl] = w.reshape(C, -1, s)
    return weights, bad


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def sgc_transform(layers: list, x: torch.Tensor, prec: Precision):
    for i, p in enumerate(layers):
        x = prec.mm(x, p["w"]) + p["b"]
        if i != len(layers) - 1:
            x = torch.relu(x)
    return x


def sgc_block(layers, feat_rows, weights, prec):
    """SGC on one class's sampled block: transform the deepest rows, then
    aggregate level by level up to the targets."""
    x = sgc_transform(layers, feat_rows, prec)
    for w in weights:
        m, s = w.shape
        x = prec.einsum("ms,msd->md", w, x.reshape(m, s, x.shape[-1]))
    return torch.log_softmax(x, dim=-1)


def sgc_dense(layers, x, adj, nprop, prec):
    x = sgc_transform(layers, x, prec)
    for _ in range(nprop):
        x = prec.mm(adj, x)
    return torch.log_softmax(x, dim=-1)


def normalize_dense(adj: torch.Tensor) -> torch.Tensor:
    adj = adj + torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
    deg = adj.sum(1)
    dinv = torch.where(deg > 0, deg.clamp(min=1e-12) ** -0.5,
                       torch.zeros_like(deg))
    return adj * dinv[:, None] * dinv[None, :]


def _tile_bn(h, mask, count, gamma, beta):
    """BatchNorm over each tile's valid pairs (dims 2 and 3), then
    ReLU."""
    mean = (h * mask).sum((2, 3), keepdim=True) / count
    cen = h - mean
    var = (cen * cen * mask).sum((2, 3), keepdim=True) / count
    return torch.relu(cen * torch.rsqrt(var + BN_EPS) * gamma + beta)


def pge_adj(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The PGE's adjacency ``[n, n]`` (before normalization)."""
    layers, bns = p["layers"], p["bns"]
    n, d = x.shape
    w0 = layers[0]["w"]
    a = prec.mm(x, w0[:d])
    b = prec.mm(x, w0[d:]) + layers[0]["b"]
    H = a.shape[1]
    ni, nj = -(-n // TI), -(-n // TJ)
    ap = torch.cat([a, a.new_zeros(ni * TI - n, H)]).reshape(ni, 1, TI, 1, H)
    bp = torch.cat([b, b.new_zeros(nj * TJ - n, H)]).reshape(1, nj, 1, TJ, H)
    rows = (torch.arange(ni * TI, device=x.device) < n).reshape(ni, 1, TI, 1)
    cols = (torch.arange(nj * TJ, device=x.device) < n).reshape(1, nj, 1, TJ)
    mask = (rows & cols).to(x.dtype)[..., None]
    count = mask.sum((2, 3), keepdim=True)
    h = _tile_bn(ap + bp, mask, count, bns[0]["scale"], bns[0]["bias"])
    for layer, bn in zip(layers[1:-1], bns[1:]):
        h = prec.mm(bf16(h), bf16(layer["w"])) + layer["b"]
        h = _tile_bn(h, mask, count, bn["scale"], bn["bias"])
    s = prec.mm(h, layers[-1]["w"])[..., 0] + layers[-1]["b"][0]
    s = s.permute(0, 2, 1, 3).reshape(ni * TI, nj * TJ)[:n, :n]
    adj = torch.sigmoid((s + s.T) / 2)
    return adj - torch.diag(torch.diagonal(adj))


# ---------------------------------------------------------------------------
# Parameters as named leaves
# ---------------------------------------------------------------------------

def tree(flat: dict) -> dict:
    """``{"layers.0.w": t, "bns.1.scale": t}`` → ``{"layers": [{...}],
    "bns": [{...}]}``."""
    out: dict = {}
    for name, t in flat.items():
        group, i, key = name.split(".")
        lst = out.setdefault(group, [])
        while len(lst) <= int(i):
            lst.append({})
        lst[int(i)][key] = t
    return out


class Adam:
    def __init__(self, lr: float, params: list):
        self.lr, self.t = lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: list, grads: list) -> None:
        b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + eps))


# ---------------------------------------------------------------------------
# The outer steps
# ---------------------------------------------------------------------------

def match_rows(gs: torch.Tensor, gr: torch.Tensor) -> torch.Tensor:
    gs2, gr2 = gs.reshape(gs.shape[0], -1), gr.reshape(gr.shape[0], -1)
    num = (gs2 * gr2).sum(-1)
    den = torch.linalg.norm(gs2, dim=-1) * torch.linalg.norm(gr2, dim=-1)
    return (1.0 - num / (den + 1e-6)).sum()


def real_grads(g: RealGraph, mp: dict, sample: dict, weights: list,
               valid: torch.Tensor, c: int, nprop: int, prec: Precision):
    """One class's gradient of its real loss, per model leaf name."""
    names = sorted(mp)
    params = {k: mp[k].detach().clone().requires_grad_(True) for k in names}
    layers = tree(params)["layers"]
    rows = sample["ids"][0].reshape(len(valid), -1)[c]
    with torch.enable_grad():
        out = sgc_block(layers, g.feat[rows], [w[c] for w in weights], prec)
        tg = sample["targets"][c]
        ll = out.gather(1, g.labels[tg][:, None])[:, 0]
        m = valid[c].to(ll.dtype)
        loss = -(ll * m).sum() / m.sum().clamp(min=1.0)
        gr = torch.autograd.grad(loss, [params[k] for k in names])
    return dict(zip(names, gr))


def outer_step(g, pools, cfg, prec, state, sample, labels_syn, classes,
               budgets, fault=None):
    """One outer step's match loss and its gradients with respect to the
    features and the PGE's leaves.  ``state`` holds ``feat``, ``pge``
    and ``mp`` (flat leaves).  ``fault`` plants a fault for calibration:
    ``half_batch`` leaves the second half of each class's targets out of
    the real loss (its mean over the rest), ``altered`` changes one pair
    of the generated adjacency where the PGE produces it."""
    nprop, batch = cfg["nlayers"], cfg["batch"]
    dev = g.device
    feat = state["feat"].detach().clone().requires_grad_(True)
    pnames = sorted(state["pge"])
    pge = {k: state["pge"][k].detach().clone().requires_grad_(True)
           for k in pnames}
    weights, bad = judge_sample(g, pools, batch, sample)
    valid = expected_valid(pools, batch, dev)
    if fault == "half_batch":
        valid = valid.clone()
        valid[:, batch // 2:] = False
    n_syn = labels_syn.shape[0]
    mnames = sorted(state["mp"])
    total = 0.0
    g_adj = None
    g_feat = torch.zeros_like(feat)
    with torch.enable_grad():
        raw = pge_adj(tree(pge), feat, prec)
        if fault == "altered":
            flip = torch.zeros_like(raw)
            flip[0, 1] = flip[1, 0] = 1.0
            raw = raw + flip * (1.0 - 2.0 * raw.detach())
        adj = normalize_dense(raw)
        adj_d = adj.detach().requires_grad_(True)
        for c_i, c in enumerate(classes):
            gr = real_grads(g, state["mp"], sample, weights, valid, c_i,
                            nprop, prec)
            ps = {k: state["mp"][k].detach().clone().requires_grad_(True)
                  for k in mnames}
            out = sgc_dense(tree(ps)["layers"], feat, adj_d, nprop, prec)
            sel = labels_syn == c
            loss_s = -out[sel].gather(1, labels_syn[sel][:, None]).mean()
            gs = torch.autograd.grad(loss_s, [ps[k] for k in mnames],
                                     create_graph=True)
            dis = sum(match_rows(gk, gr[k]) for k, gk in zip(mnames, gs)
                      if gk.ndim >= 2)
            term = dis * (budgets[c] / n_syn)
            ga, gf = torch.autograd.grad(term, [adj_d, feat])
            g_adj = ga if g_adj is None else g_adj + ga
            g_feat = g_feat + gf
            total = total + term.detach()
        gp = torch.autograd.grad(adj, [feat] + [pge[k] for k in pnames],
                                 grad_outputs=g_adj)
    g_feat = g_feat + gp[0]
    return total, g_feat, dict(zip(pnames, gp[1:])), bad


def _copy(state: dict) -> dict:
    return {"feat": state["feat"].clone(),
            "pge": {k: v.clone() for k, v in state["pge"].items()},
            "mp": {k: v.clone() for k, v in state["mp"].items()}}


def follow(g, pools, cfg, prec, start: dict, samples: list,
           labels_syn: torch.Tensor, classes: list, budgets: dict,
           epoch: int, fault=None, states=None) -> dict:
    """Three outer steps at ``epoch``'s first step, on the program's
    sampled blocks.  States hold ``feat``, ``pge`` and ``mp`` as flat
    leaves.

    With ``states`` (the program's state at the start of steps 0 to 3)
    the reference follows the program step by step: each step's loss and
    gradients from the program's state at that step, the outer update by
    the reference's own Adam from them, the inner loop from the program's
    model and the program's generator and features after the step.
    Without, it runs its own three steps from ``start`` (a control or a
    fault in the program's place) and returns its states.  A stretch
    starts an epoch, where the model and its optimizer are
    re-initialized, at the first step of the optimizer it steps (GCond's
    schedule: the PGE's from epoch 0, the features' from epoch 10), so
    both optimizers start fresh.

    Returns the losses, the first gradients (``first``: every leaf's;
    ``given``: those the optimizers got), every leaf's change summed over
    the three steps (``change``) and over the first (``step``), the
    states, and the sample violations."""
    own = states is None
    states = [_copy(start)] if own else [_copy(s) for s in states]
    step_pge = epoch % 50 < 10
    pn, mn = list(states[0]["pge"]), list(states[0]["mp"])
    opt_out = Adam(cfg["lr_adj"] if step_pge else cfg["lr_feat"],
                   [states[0]["pge"][n] for n in pn] if step_pge
                   else [states[0]["feat"]])
    opt_m = Adam(cfg["lr"], [states[0]["mp"][n] for n in mn])
    change = {"feat": torch.zeros_like(states[0]["feat"])}
    change.update({f"pge.{n}": torch.zeros_like(states[0]["pge"][n])
                   for n in pn})
    change.update({f"mp.{n}": torch.zeros_like(states[0]["mp"][n])
                   for n in mn})
    losses, first, bad = [], {}, 0
    for k, sample in enumerate(samples):
        st = states[k]
        with prec.active():
            loss, g_feat, g_pge, b = outer_step(
                g, pools, cfg, prec, st, sample, labels_syn, classes,
                budgets, fault)
        bad += b
        losses.append(float(loss))
        if k == 0:
            first["feat"] = g_feat.clone()
            first.update({f"pge.{n}": g_pge[n].clone() for n in pn})
        nxt = _copy(st)
        if step_pge:
            opt_out.step([nxt["pge"][n] for n in pn], [g_pge[n] for n in pn])
            for n in pn:
                change[f"pge.{n}"] += nxt["pge"][n] - st["pge"][n]
        else:
            opt_out.step([nxt["feat"]], [g_feat])
            change["feat"] += nxt["feat"] - st["feat"]
        after = nxt if own else states[k + 1]
        with prec.active():
            with torch.no_grad():
                adj_in = normalize_dense(pge_adj(tree(after["pge"]),
                                                 after["feat"], prec))
            mp = {n: st["mp"][n].clone() for n in mn}
            for i in range(cfg["inner_loop"]):
                ps = {n: mp[n].detach().requires_grad_(True) for n in mn}
                with torch.enable_grad():
                    out = sgc_dense(tree(ps)["layers"], after["feat"],
                                    adj_in, cfg["nlayers"], prec)
                    ll = out.gather(1, labels_syn[:, None])[:, 0]
                    gm = torch.autograd.grad(-ll.mean(),
                                             [ps[n] for n in mn])
                if k == 0 and i == 0:
                    first.update({f"mp.{n}": gm[j].clone()
                                  for j, n in enumerate(mn)})
                opt_m.step([mp[n] for n in mn], list(gm))
        for n in mn:
            change[f"mp.{n}"] += mp[n] - st["mp"][n]
        if k == 0:
            step = {n: v.clone() for n, v in change.items()}
        if own:
            nxt["mp"] = mp
            states.append(nxt)
    stepped = "pge" if step_pge else "feat"
    given = {k: v for k, v in first.items()
             if k.split(".")[0] in (stepped, "mp")}
    return dict(losses=losses, first=first, given=given, change=change,
                step=step, states=states, bad=bad)
