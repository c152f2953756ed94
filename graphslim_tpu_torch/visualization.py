"""Graph visualization: original and reduced graphs side by side.

Counterpart of ``graphslim_tpu/visualization.py`` (reference
``graphslim/visualization.py:26-96``): a networkx spring layout of at most
``MAX_NODES`` nodes each, coloured by class, written as a PNG (matplotlib's
Agg backend).  Adjacencies are read from their host mirrors; a dense one
is copied back once.  Run as ``python -m graphslim_tpu_torch.visualization
-D cora -M kcenter [--device cpu]`` after a reduction saved its triple:
the figure lands under ``{save_path}/figures/``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.utils import host_array

log = logging.getLogger("graphslim_tpu_torch")

MAX_NODES = 300


def _to_networkx(adj, labels, max_nodes: int = MAX_NODES):
    """(graph over the first ``max_nodes`` nodes, their labels); a dense
    adjacency keeps the entries above its mean."""
    import networkx as nx

    labels = host_array(labels)
    if adj is None:
        n = len(labels)
        g = nx.empty_graph(min(n, max_nodes))
        return g, labels[: min(n, max_nodes)]
    if isinstance(adj, G.SparseAdj):
        h = G.host_of(adj)
        row, col, n = h.row, h.col, h.n_rows
    else:
        a = host_array(adj)
        row, col = np.nonzero(a > (a.mean() if a.size else 0))
        n = a.shape[0]
    keep = min(n, max_nodes)
    g = nx.Graph()
    g.add_nodes_from(range(keep))
    mask = (row < keep) & (col < keep)
    g.add_edges_from(zip(row[mask].tolist(), col[mask].tolist()))
    if labels.ndim == 2:
        labels = labels.argmax(1)
    return g, labels[:keep]


def draw_graph_pair(original: G.Dataset, reduced: G.Reduced,
                    out_path: str, title: Optional[str] = None) -> str:
    """Side-by-side spring-layout render → the PNG's path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, (adj, labels, name) in zip(axes, [
            (original.adj, original.labels, "original"),
            (reduced.adj, reduced.labels, "reduced")]):
        g, lab = _to_networkx(adj, labels)
        pos = nx.spring_layout(g, seed=0)
        nx.draw_networkx_nodes(g, pos, node_color=lab, node_size=25,
                               cmap="tab10", ax=ax)
        nx.draw_networkx_edges(g, pos, alpha=0.2, ax=ax)
        ax.set_title(f"{name} ({g.number_of_nodes()} nodes, "
                     f"{g.number_of_edges()} edges)")
        ax.axis("off")
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    log.info("wrote %s", out_path)
    return out_path


def main(argv: Optional[list[str]] = None):
    """Load a saved reduced triple and render it beside the original."""
    from graphslim_tpu_torch.config import get_args
    from graphslim_tpu_torch.data import load, load_reduced

    args = get_args(argv)
    data = load(args.dataset, setting=args.setting, split=args.split,
                seed=args.seed, data_dir=args.load_path, device=args.device)
    reduced = load_reduced(args.save_path, args.method, args.dataset,
                           args.reduction_rate, args.seed,
                           device=args.device)
    out = os.path.join(args.save_path, "figures",
                       f"{args.method}_{args.dataset}_"
                       f"{args.reduction_rate}.png")
    draw_graph_pair(data, reduced, out,
                    title=f"{args.method} r={args.reduction_rate}")
    print(out)
    return out


if __name__ == "__main__":
    main()
