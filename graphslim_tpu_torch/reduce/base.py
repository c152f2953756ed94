"""Reducer base class: budgets, timing, artifact persistence.

Counterpart of ``graphslim_tpu/reduce/base.py``: every reducer exposes
``reduce(data, verbose=False) -> Reduced`` and never mutates ``data``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.data import save_reduced
from graphslim_tpu_torch.profiling import span

log = logging.getLogger("graphslim_tpu_torch")


def class_budgets(labels_train: np.ndarray, r: float,
                  absorb_remainder: bool = False):
    """Per-class synthetic budgets → (budget dict, labels_syn, ranges).

    Classes sorted by frequency ascending, each gets ``max(int(num·r), 1)``;
    with ``absorb_remainder`` the most frequent class absorbs the rounding
    remainder so the total hits ``int(n·r)``.
    """
    labels_train = np.asarray(labels_train)
    classes, counts = np.unique(labels_train, return_counts=True)
    order = np.argsort(counts, kind="stable")
    n_total = int(labels_train.shape[0] * r)
    budgets: dict[int, int] = {}
    labels_syn: list[int] = []
    class_ranges: dict[int, list] = {}
    running = 0
    for i, ix in enumerate(order):
        c, num = int(classes[ix]), int(counts[ix])
        if absorb_remainder and i == len(order) - 1:
            budgets[c] = max(n_total - running, 1)
        else:
            budgets[c] = max(int(num * r), 1)
        budgets[c] = min(budgets[c], num)
        running += budgets[c]
        class_ranges[c] = [len(labels_syn), len(labels_syn) + budgets[c]]
        labels_syn += [c] * budgets[c]
    return budgets, np.asarray(labels_syn, dtype=np.int32), class_ranges


def budgets_of(labels_syn: np.ndarray) -> dict:
    """Per-class budgets of an imposed synthetic label vector (a
    condenser's, handed to its init reducer)."""
    classes, counts = np.unique(labels_syn, return_counts=True)
    return dict(zip(classes.tolist(), counts.tolist()))


class Reducer:
    """Base reducer: stores (data, args), times ``reduce`` (a ``reduce``
    span, which opens a job of the span recorder), saves output."""

    save_output = True

    def __init__(self, data: G.Dataset, args):
        self.data = data
        self.args = args

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        raise NotImplementedError

    def reduce(self, data: G.Dataset = None, verbose: bool = False
               ) -> G.Reduced:
        data = data if data is not None else self.data
        with span("reduce", method=type(self).__name__) as job:
            reduced = self._reduce(data, verbose)
            if reduced.feat.is_cuda:
                torch.cuda.synchronize(reduced.feat.device)
        dt = job.seconds
        orig_mb = (data.feat.numel() * 4 + data.adj.nnz * 12) / 2 ** 20
        red_mb = (reduced.feat.numel() * 4 + (
            0 if reduced.adj is None else
            reduced.n_syn * reduced.n_syn * 4)) / 2 ** 20
        log.info("reduce[%s] %.2fs  %.1fMB -> %.2fMB",
                 type(self).__name__, dt, orig_mb, red_mb)
        if verbose:
            print(f"{type(self).__name__}: {dt:.2f}s, "
                  f"{orig_mb:.1f}MB -> {red_mb:.3f}MB")
        if self.save_output:
            save_reduced(reduced, self.args.save_path, self.args.method,
                         data.name, self.args.reduction_rate,
                         self.args.seed,
                         attack=getattr(self.args, "attack", None))
        return reduced
