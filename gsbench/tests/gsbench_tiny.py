"""Tiny stand-ins of the cells for CPU tests: the cells' configurations
with a small twin (the same generator, the split at the published
shares) and four outer steps an epoch."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gsbench import manifest  # noqa: E402


def tiny(config: str) -> tuple:
    """(configuration, traffic mix) of a tiny twin under ``config``'s
    engine: a few thousand nodes, four classes, narrow features."""
    bench = manifest.benchmark(ROOT)
    cfg = copy.deepcopy(manifest.config(bench, config))
    arxiv = cfg["dataset"] == "ogbn-arxiv"
    n = 2000
    split = cfg["twin"]["split"]
    share = {k: v / cfg["twin"]["n_nodes"] for k, v in split.items()}
    train, val = int(n * share["train"]), int(n * share["val"])
    cfg["twin"].update(n_nodes=n, n_feat=16 if arxiv else 24, nclass=4,
                       avg_degree=8.0,
                       split=dict(train=train, val=val,
                                  test=n - train - val))
    cfg["published"].update(outer_loop=4, epochs=30,
                            inner_loop=2 if arxiv else 1)
    return cfg, {"reduction_rate": 0.01 if arxiv else 0.02}
