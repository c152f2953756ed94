"""Experiment tracking: Null / WandB trackers and graph summaries.

Counterpart of ``graphslim_tpu/tracking.py``: WandB on ``--wandb`` when
it is importable, a :class:`NullTracker` (with a warning) otherwise, and a
hard failure only with ``--wandb_required``.  ``wandb`` is an optional
dependency, imported only when a run asks for it.
"""

from __future__ import annotations

import logging

log = logging.getLogger("graphslim_tpu_torch")


def graph_summary(n_nodes: int, n_edges: int) -> dict:
    density = n_edges / max(n_nodes * (n_nodes - 1), 1)
    return {"nodes": n_nodes, "edges": n_edges, "density": density}


class NullTracker:
    def log_graph(self, name: str, summary: dict) -> None:
        log.debug("graph[%s]: %s", name, summary)

    def log_metrics(self, metrics: dict, step: int | None = None) -> None:
        log.debug("metrics: %s", metrics)

    def finish(self) -> None:
        pass


class WandbTracker:
    def __init__(self, args):
        import wandb  # deferred; optional dependency

        self._run = wandb.init(project=args.wandb_project,
                               name=args.wandb_run_name,
                               config=vars(args))
        self._wandb = wandb

    def log_graph(self, name: str, summary: dict) -> None:
        self._run.summary.update({f"{name}/{k}": v
                                  for k, v in summary.items()})

    def log_metrics(self, metrics: dict, step: int | None = None) -> None:
        self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        self._run.finish()


def build_tracker(args):
    """WandB when requested and importable; Null otherwise (a failure
    raises only with ``wandb_required``)."""
    if getattr(args, "wandb", False):
        try:
            return WandbTracker(args)
        except Exception as e:
            if getattr(args, "wandb_required", False):
                raise
            log.warning("wandb unavailable (%s); using NullTracker", e)
    return NullTracker()
