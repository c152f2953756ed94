"""The port's visualization and t-SNE against the JAX package's (CPU).

``_to_networkx`` gives the JAX function's nodes, edges and labels for a
``SparseAdj``, a dense adjacency (the entries above its mean), no
adjacency and one-hot labels, under the 300-node cap; ``draw_graph_pair``,
``Evaluator.tsne_vis`` and the ``python -m
graphslim_tpu_torch.visualization`` entry write PNGs over 1 kB; and
``tsne_vis`` hands t-SNE the JAX package's real rows (the same
``default_rng(0)`` subsample) and synthetic rows, in both settings.
"""

from unittest import mock

import numpy as np
import pytest
import sklearn.manifold
from torch_shared import dataset_pair, reduced_pair
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import visualization as JV
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.eval import Evaluator as JEvaluator
from graphslim_tpu_torch import visualization as V
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import save_reduced
from graphslim_tpu_torch.eval import Evaluator

DATASETS = {"trans": "synth-small", "ind": "synth-ind-small"}


@pytest.fixture(scope="module")
def twins():
    return {s: dataset_pair(n) for s, n in DATASETS.items()}


def _graph(g):
    return sorted(g.nodes()), sorted(tuple(sorted(e)) for e in g.edges())


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "dense", "none"])
def test_to_networkx_matches_jax(twins, kind, onehot):
    jds, _ = twins["trans"]
    jred, tred = reduced_pair(jds, kind, n=120, onehot=onehot)
    jg, jlab = JV._to_networkx(jred.adj, jred.labels, max_nodes=100)
    g, lab = V._to_networkx(tred.adj, tred.labels, max_nodes=100)
    assert _graph(g) == _graph(jg)
    assert np.array_equal(lab, np.asarray(jlab))


def test_to_networkx_of_the_full_graph_matches_jax(twins):
    jds, tds = twins["trans"]
    jg, jlab = JV._to_networkx(jds.adj, jds.labels)
    g, lab = V._to_networkx(tds.adj, tds.labels)
    assert g.number_of_nodes() == V.MAX_NODES
    assert _graph(g) == _graph(jg) and np.array_equal(lab, np.asarray(jlab))


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_draw_graph_pair_writes_a_png(twins, tmp_path, kind):
    _, tds = twins["trans"]
    _, tred = reduced_pair(twins["trans"][0], kind)
    out = V.draw_graph_pair(tds, tred, str(tmp_path / "fig" / "pair.png"),
                            title="pair")
    assert open(out, "rb").read(4) == b"\x89PNG"
    assert (tmp_path / "fig" / "pair.png").stat().st_size > 1024


def test_visualization_main_renders_a_saved_triple(twins, tmp_path):
    _, tred = reduced_pair(twins["trans"][0], "sparse")
    save_reduced(tred, str(tmp_path), "kcenter", "synth-small", 0.25, 1)
    out = V.main(["-D", "synth-small", "-M", "kcenter", "--device", "cpu",
                  "--save_path", str(tmp_path)])
    assert out.endswith("kcenter_synth-small_0.25.png")
    assert (tmp_path / "figures" / "kcenter_synth-small_0.25.png"
            ).stat().st_size > 1024


class _Recorder:
    """A stand-in for ``sklearn.manifold.TSNE`` that records its input."""

    seen: list = []

    def __init__(self, **kw):
        self.kw = kw

    def fit_transform(self, data):
        _Recorder.seen.append((self.kw, np.array(data)))
        return np.zeros((data.shape[0], 2))


@pytest.mark.parametrize("setting", sorted(DATASETS))
def test_tsne_vis_takes_the_jax_rows(twins, tmp_path, setting):
    jds, tds = twins[setting]
    jred, tred = reduced_pair(jds, "dense", n=30, onehot=True)
    base = dict(dataset=tds.name, method="random", save_path=str(tmp_path))
    jev = JEvaluator(jds, jfinalize(JArgs(**base), set()))
    ev = Evaluator(tds, finalize(Args(**base, device="cpu"), set()))
    _Recorder.seen = []
    with mock.patch.object(sklearn.manifold, "TSNE", _Recorder):
        jev.tsne_vis(jred, str(tmp_path / "j.png"), max_real=50)
        ev.tsne_vis(tred, str(tmp_path / "t.png"), max_real=50)
    (jkw, jdata), (kw, data) = _Recorder.seen
    assert kw == jkw and kw["random_state"] == 0
    assert data.shape == (50 + 30, tds.n_feat)
    assert np.array_equal(data, jdata)


def test_tsne_vis_writes_a_png(twins, tmp_path):
    _, tds = twins["ind"]
    _, tred = reduced_pair(twins["ind"][0], "none", n=20)
    ev = Evaluator(tds, finalize(Args(dataset=tds.name, device="cpu"),
                                 set()))
    out = ev.tsne_vis(tred, str(tmp_path / "tsne.png"), max_real=60)
    assert (tmp_path / "tsne.png").stat().st_size > 1024
    assert out == str(tmp_path / "tsne.png")
