"""Plain PyTorch reference of MSGC's outer steps, for the correctness
check of the port's MSGC.

Written from MSGC's published algorithm (Gao et al., "Multiple Sparse
Graphs Condensation", Knowledge-Based Systems, 2023; GraphSlim's ``msgc``
agent) and the port's stated semantics, with none of the port's code.
MSGC keeps GCond's engine and swaps its generator, so the real side is
the GCond reference's (:mod:`gsbench.reference`: the real graph from the
twin's raw file, the sampled blocks judged alone, SGC on a block, a
class's real gradient, the 'ours' row distance, Adam, the TF32 control);
what is MSGC's own is here.  Everything is plain ``torch`` in float32
with TF32 off, class by class and skeleton by skeleton: no kernel, no
batching over classes or skeletons.

* Labels: ``n_syn = max(int(n_train·r), C)``; class ``c`` gets
  ``floor((n_syn − C)·share_c) + 1`` nodes, then the nodes left go one
  at a time to the class whose ``n_c / Σn / share_c`` is least (the
  first such class); the labels run class after class, class 0 first.
* Skeletons: ``B`` graphs over the synthetic nodes.  In each, node after
  node and, for each node, class after class, a node that has at most
  one link into class ``c`` links to the node of ``c`` (itself left out)
  that has the fewest links into the node's own class; ties are broken
  by a seeded draw.  Each link is written as two entries, ``(r, c)``
  then ``(c, r)``.  The program's triples ``(rows, cols, batches)`` are
  judged alone (:func:`judge_skeletons`) and then followed as they are:
  a later program may draw its ties otherwise.
* The scorer, shared by the skeletons: ``[x_r | x_c]`` of every entry,
  duplicates included, through Linear → BatchNorm → ReLU, twice, then
  Linear → sigmoid, one score an entry.  BatchNorm takes the statistics
  of the whole batch of entries (every skeleton, duplicates included),
  biased variance, ε = 1e-5.
* Skeleton ``b``'s adjacency: its entries' scores in a zero ``[n, n]``
  matrix, where an entry written twice takes its later score;
  ``(A + Aᵀ)/2``, then ``D^-1/2 (A + I) D^-1/2``.
* The synthetic loss of class ``c``: SGC on each skeleton in turn (the
  features shared), the NLL of the class's nodes summed over the
  skeletons and divided by ``B`` times the class's count (the labels
  tiled once a skeleton); the match is GCond's 'ours' with the class
  weight ``budget_c / n_syn``.
* The schedule is GCond's: epochs with ``epoch % 50 < 10`` step the
  scorer, the others the features, by Adam; after every outer step
  ``inner_loop`` Adam steps of the model on the detached skeletons, the
  mean NLL over all ``B·n`` nodes.

**Where this departs from GraphSlim's** ``msgc.py`` (each as the port
states its semantics):

* an entry written twice takes its later score; a scatter by indices
  with repeats, as a dense ``torch`` assignment would do, leaves the
  winner unspecified on a CUDA device;
* the scorer's BatchNorm keeps no running statistics: the inner loop's
  no-grad scores take the batch's statistics too, where a
  ``BatchNorm1d`` module in eval mode would take its running ones;
* the ties of the skeletons' build are drawn from NumPy's
  ``default_rng(seed)``, not from ``random``;
* the 20-snapshot window average runs only at a checkpoint evaluation,
  which this reference does not follow (a check covers outer steps).

**The skeletons' judge** (:func:`judge_skeletons`) replays the rule on
the program's triples and counts each entry or link that breaks it: the
entries come in pairs ``(r, c), (c, r)`` of one skeleton; no self link;
``B`` skeletons, in order; within a skeleton the initiators (the first
entry of a pair) never decrease and one initiator's target classes
rise, so a node starts at most one link into each class; a node starts a
link into class ``c`` exactly when ``c`` holds another node and the node
has at most one link into ``c`` so far; the node it links to has the
fewest links into the initiator's class among its class (the initiator
left out); and at the end every node links into every class that holds
another node.  Only the tie-break is left free.

**The init's judge** (:func:`start_violations`): with the ``clustering``
init every synthetic row of class ``c`` is a k-means centroid of the
class's train rows, a mean of some of them, so each lies inside the
rows' box coordinate by coordinate, and the class's rows are distinct; a
class with no more train rows than its budget holds its rows in pool
order, repeated.

``precision='tf32'`` is the control, as in the GCond reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gsbench import reference as R

BN_EPS = 1e-5
# an initial row lies in its class's box to this share of the box's width
# (the port standardizes the features in float32, the GCond reference in
# float64)
BOX_TOL = 1e-3


# ---------------------------------------------------------------------------
# Labels and skeletons
# ---------------------------------------------------------------------------

def n_syn_of(n_pool: int, r: float, nclass: int) -> int:
    return max(int(n_pool * r), nclass)


def proportional_labels(labels_pool: np.ndarray, n_syn: int,
                        nclass: int) -> np.ndarray:
    """MSGC's allocation (see above) as a label vector."""
    share = np.bincount(labels_pool, minlength=nclass) / len(labels_pool)
    n_c = np.floor((n_syn - nclass) * share) + 1
    while n_c.sum() < n_syn:
        ratio = n_c / n_c.sum() / np.maximum(share, 1e-12)
        n_c[int(np.argmin(ratio))] += 1
    return np.repeat(np.arange(nclass), n_c.astype(np.int64))


def judge_skeletons(rows, cols, batches, y_syn: np.ndarray, nclass: int,
                    batch: int) -> int:
    """Entries and links of the program's triples that break MSGC's link
    rule (see above); 0 when the triples are a build of the rule."""
    rows, cols, batches = (np.asarray(a, np.int64)
                           for a in (rows, cols, batches))
    if not (rows.shape == cols.shape == batches.shape) or rows.size % 2:
        return max(rows.size, 1)
    y = np.asarray(y_syn, np.int64)
    n = y.shape[0]
    r0, c0, b0 = rows[0::2], cols[0::2], batches[0::2]
    bad = int(((rows[1::2] != c0) | (cols[1::2] != r0)
               | (batches[1::2] != b0)).sum())
    bad += int((r0 == c0).sum())
    bad += int((np.diff(b0) < 0).sum())
    bad += int(not np.array_equal(np.unique(b0), np.arange(batch)))
    size = np.bincount(y, minlength=nclass)
    order = np.argsort(y, kind="stable")
    starts = np.searchsorted(y[order], np.arange(nclass))
    filled = size > 0
    for b in range(batch):
        ini, tgt = r0[b0 == b], c0[b0 == b]
        bad += int((np.diff(ini) < 0).sum())
        nb = np.zeros((n, nclass), np.int64)   # links of node into class
        lo = np.searchsorted(ini, np.arange(n), side="left")
        hi = np.searchsorted(ini, np.arange(n), side="right")
        for i in range(n):
            t = tgt[lo[i]:hi[i]]
            if ((t < 0) | (t >= n)).any():
                bad += t.size
                continue
            tc, yi = y[t], y[i]
            bad += int((np.diff(tc) <= 0).sum())
            others = size.copy()
            others[yi] -= 1
            linked = np.zeros(nclass, bool)
            linked[tc] = True
            bad += int(((others > 0) & (nb[i] <= 1) != linked).sum())
            key = nb[:, yi].astype(np.float64)
            key[i] = np.inf
            least = np.full(nclass, np.inf)
            least[filled] = np.minimum.reduceat(key[order],
                                                starts[filled])
            bad += int((nb[t, yi] != least[tc]).sum())
            nb[i, tc] += 1
            np.add.at(nb[:, yi], t, 1)
        others = size[None, :] - np.eye(nclass, dtype=np.int64)[y]
        bad += int(((others > 0) & (nb == 0)).sum())
    return bad


class Skeletons:
    """The program's triples on ``device``, with each skeleton's entries
    that are scattered: of an entry written twice, its later position."""

    def __init__(self, rows, cols, batches, n: int, batch: int, device):
        rows, cols, batches = (np.asarray(a, np.int64)
                               for a in (rows, cols, batches))
        self.n, self.batch = n, batch
        self.entries = rows.shape[0]

        def t(a):
            return torch.as_tensor(a, device=device)

        self.rows, self.cols = t(rows), t(cols)
        self.kept = []
        for b in range(batch):
            pos = np.flatnonzero(batches == b)
            key = rows[pos] * n + cols[pos]
            srt = np.lexsort((pos, key))
            last = np.r_[key[srt][1:] != key[srt][:-1], True]
            p = pos[srt][last]
            self.kept.append((t(p), t(rows[p]), t(cols[p])))


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

def scorer_scores(p: dict, x: torch.Tensor, sk: Skeletons,
                  prec: R.Precision) -> torch.Tensor:
    """One score in (0, 1) for every entry of the triples."""
    h = torch.cat([x[sk.rows], x[sk.cols]], dim=1)
    layers, bns = p["layers"], p["bns"]
    for i, layer in enumerate(layers):
        h = prec.mm(h, layer["w"]) + layer["b"]
        if i < len(layers) - 1:
            mean = h.mean(0)
            var = ((h - mean) ** 2).mean(0)
            h = (h - mean) / torch.sqrt(var + BN_EPS)
            h = torch.relu(h * bns[i]["scale"] + bns[i]["bias"])
    return torch.sigmoid(h[:, 0])


def altered(s: torch.Tensor, sk: Skeletons) -> torch.Tensor:
    """The planted fault: the first scattered entry of skeleton 0 takes
    ``1 − score``."""
    flip = torch.zeros_like(s)
    flip[sk.kept[0][0][0]] = 1.0
    return s + flip * (1.0 - 2.0 * s.detach())


def skeleton_adjs(s: torch.Tensor, sk: Skeletons) -> list:
    """Each skeleton's normalized adjacency ``[n, n]``, in turn."""
    out = []
    for pos, r, c in sk.kept:
        a = s.new_zeros((sk.n, sk.n)).index_put((r, c), s[pos])
        out.append(R.normalize_dense((a + a.T) / 2))
    return out


def generate(scorer: dict, feat: torch.Tensor, sk: Skeletons,
             prec: R.Precision, fault=None) -> list:
    s = scorer_scores(R.tree(scorer), feat, sk, prec)
    if fault == "altered":
        s = altered(s, sk)
    return skeleton_adjs(s, sk)


# ---------------------------------------------------------------------------
# The outer steps
# ---------------------------------------------------------------------------

def skeleton_nll(layers: list, feat: torch.Tensor, adjs: list,
                 y_syn: torch.Tensor, sel: torch.Tensor, nprop: int,
                 prec: R.Precision) -> torch.Tensor:
    """The mean NLL of the nodes ``sel`` over every skeleton."""
    total = 0.0
    for adj in adjs:
        out = R.sgc_dense(layers, feat, adj, nprop, prec)
        total = total - out[sel].gather(1, y_syn[sel][:, None]).sum()
    return total / (len(adjs) * int(sel.sum()))


def outer_step(g, pools, cfg, prec, state, sample, y_syn, sk, classes,
               budgets, fault=None):
    """One outer step's match loss and its gradients with respect to the
    features and the scorer's leaves.  ``state`` holds ``feat``,
    ``scorer`` and ``mp`` (flat leaves).  ``fault``: ``half_batch``
    leaves the second half of each class's targets out of the real loss,
    ``altered`` changes one entry's score (:func:`altered`)."""
    nprop, batch = cfg["nlayers"], cfg["batch"]
    feat = state["feat"].detach().clone().requires_grad_(True)
    snames = sorted(state["scorer"])
    sc = {k: state["scorer"][k].detach().clone().requires_grad_(True)
          for k in snames}
    weights, bad = R.judge_sample(g, pools, batch, sample)
    valid = R.expected_valid(pools, batch, g.device)
    if fault == "half_batch":
        valid = valid.clone()
        valid[:, batch // 2:] = False
    n_syn = y_syn.shape[0]
    mnames = sorted(state["mp"])
    total = 0.0
    g_feat = torch.zeros_like(feat)
    with torch.enable_grad():
        adjs = generate(sc, feat, sk, prec, fault)
        adj_d = [a.detach().requires_grad_(True) for a in adjs]
        g_adj = [torch.zeros_like(a) for a in adjs]
        for c_i, c in enumerate(classes):
            gr = R.real_grads(g, state["mp"], sample, weights, valid, c_i,
                              nprop, prec)
            ps = {k: state["mp"][k].detach().clone().requires_grad_(True)
                  for k in mnames}
            loss_s = skeleton_nll(R.tree(ps)["layers"], feat, adj_d, y_syn,
                                  y_syn == c, nprop, prec)
            gs = torch.autograd.grad(loss_s, [ps[k] for k in mnames],
                                     create_graph=True)
            dis = sum(R.match_rows(gk, gr[k]) for k, gk in zip(mnames, gs)
                      if gk.ndim >= 2)
            term = dis * (budgets[c] / n_syn)
            *ga, gf = torch.autograd.grad(term, adj_d + [feat])
            g_adj = [a + b for a, b in zip(g_adj, ga)]
            g_feat = g_feat + gf
            total = total + term.detach()
        gp = torch.autograd.grad(adjs, [feat] + [sc[k] for k in snames],
                                 grad_outputs=g_adj)
    g_feat = g_feat + gp[0]
    return total, g_feat, dict(zip(snames, gp[1:])), bad


def inner_fit(cfg, prec, mp: dict, feat, adjs: list, y_syn, opt: R.Adam):
    """``inner_loop`` Adam steps of the model (updated in place) on the
    detached skeletons; returns the first step's gradients."""
    names = list(mp)
    first = None
    everyone = torch.ones_like(y_syn, dtype=torch.bool)
    for _ in range(cfg["inner_loop"]):
        ps = {n: mp[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            loss = skeleton_nll(R.tree(ps)["layers"], feat, adjs, y_syn,
                                everyone, cfg["nlayers"], prec)
            gm = torch.autograd.grad(loss, [ps[n] for n in names])
        if first is None:
            first = dict(zip(names, (x.clone() for x in gm)))
        opt.step([mp[n] for n in names], list(gm))
    return first


def _copy(state: dict) -> dict:
    return {k: v.clone() if torch.is_tensor(v)
            else {n: t.clone() for n, t in v.items()}
            for k, v in state.items()}


def follow(g, pools, cfg, prec, start: dict, samples: list, y_syn, sk,
           classes: list, budgets: dict, epoch: int, fault=None,
           states=None) -> dict:
    """Three outer steps at ``epoch``'s first step, on the program's
    sampled blocks, as :func:`gsbench.reference.follow` does for GCond:
    with ``states`` (the program's state at the start of steps 0 to 3)
    step by step from the program's state, else its own three steps from
    ``start``.  States hold ``feat``, ``scorer`` and ``mp`` as flat
    leaves.  Returns the losses, the first gradients (``first``: every
    leaf's, named ``feat``, ``scorer.<leaf>``, ``mp.<leaf>``; ``given``:
    those the optimizers got), every leaf's change over the three steps
    (``change``) and over the first (``step``), the states, and the
    sample violations."""
    own = states is None
    states = [_copy(start)] if own else [_copy(s) for s in states]
    step_scorer = epoch % 50 < 10
    sn, mn = list(states[0]["scorer"]), list(states[0]["mp"])
    opt_out = R.Adam(cfg["lr_adj"] if step_scorer else cfg["lr_feat"],
                     [states[0]["scorer"][n] for n in sn] if step_scorer
                     else [states[0]["feat"]])
    opt_m = R.Adam(cfg["lr"], [states[0]["mp"][n] for n in mn])
    change = {"feat": torch.zeros_like(states[0]["feat"])}
    change.update({f"scorer.{n}": torch.zeros_like(states[0]["scorer"][n])
                   for n in sn})
    change.update({f"mp.{n}": torch.zeros_like(states[0]["mp"][n])
                   for n in mn})
    losses, first, bad = [], {}, 0
    for k, sample in enumerate(samples):
        st = states[k]
        with prec.active():
            loss, g_feat, g_sc, b = outer_step(
                g, pools, cfg, prec, st, sample, y_syn, sk, classes,
                budgets, fault)
        bad += b
        losses.append(float(loss))
        if k == 0:
            first["feat"] = g_feat.clone()
            first.update({f"scorer.{n}": g_sc[n].clone() for n in sn})
        nxt = _copy(st)
        if step_scorer:
            opt_out.step([nxt["scorer"][n] for n in sn],
                         [g_sc[n] for n in sn])
            for n in sn:
                change[f"scorer.{n}"] += nxt["scorer"][n] - st["scorer"][n]
        else:
            opt_out.step([nxt["feat"]], [g_feat])
            change["feat"] += nxt["feat"] - st["feat"]
        after = nxt if own else states[k + 1]
        with prec.active():
            with torch.no_grad():
                adjs = generate(after["scorer"], after["feat"], sk, prec)
            mp = {n: st["mp"][n].clone() for n in mn}
            gm = inner_fit(cfg, prec, mp, after["feat"], adjs, y_syn, opt_m)
        if k == 0:
            first.update({f"mp.{n}": v for n, v in gm.items()})
        for n in mn:
            change[f"mp.{n}"] += mp[n] - st["mp"][n]
        if k == 0:
            step = {n: v.clone() for n, v in change.items()}
        if own:
            nxt["mp"] = mp
            states.append(nxt)
    stepped = "scorer" if step_scorer else "feat"
    given = {k: v for k, v in first.items()
             if k.split(".")[0] in (stepped, "mp")}
    return dict(losses=losses, first=first, given=given, change=change,
                step=step, states=states, bad=bad)


# ---------------------------------------------------------------------------
# The start
# ---------------------------------------------------------------------------

def start_violations(feat: torch.Tensor, labels_syn_prog: torch.Tensor,
                     y_syn: torch.Tensor, batch: int,
                     pool_rows: list) -> int:
    """Violations of the program's start: a tiled label vector other
    than MSGC's allocation tiled ``batch`` times, or an initial row that
    the ``clustering`` init could not give (see above).  ``pool_rows``
    holds ``(class, its train rows in pool order)``."""
    if not torch.equal(labels_syn_prog.cpu(), y_syn.cpu().repeat(batch)):
        return 1
    bad = 0
    for c, rows in pool_rows:
        x = feat[(y_syn == c).to(feat.device)].to(rows.device).double()
        p = rows.double()
        if p.shape[0] <= x.shape[0]:
            want = p[torch.arange(x.shape[0], device=p.device) % len(p)]
            scale = torch.linalg.vector_norm(want, dim=1).clamp(min=1.0)
            err = torch.linalg.vector_norm(x - want, dim=1)
            bad += int((err > BOX_TOL * scale).sum())
            continue
        lo, hi = p.min(0).values, p.max(0).values
        tol = BOX_TOL * (hi - lo) + 1e-6
        bad += int(((x < lo - tol) | (x > hi + tol)).any(1).sum())
        bad += x.shape[0] - int(torch.unique(x, dim=0).shape[0])
    return bad
