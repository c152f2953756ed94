"""The port's public configuration and registry against the JAX package.

* Every ``Args`` field the two packages share has the same default (the
  port's own ``device`` aside), so ``get_args([])`` runs the same method
  on the same data in both.
* The registry: all 43 names (38 methods and 5 aliases) resolve to the
  same ``MethodSpec`` family, module and classes; ``list_methods`` is
  equal for each family and for all; ``create_reducer(name, data, args,
  labels_syn_override=...)`` constructs in both packages (a reducer that
  takes no override is built without it).
"""

import dataclasses

import numpy as np
import pytest

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import registry as jregistry
from graphslim_tpu_torch import reduce as R
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load

from torch_shared import one_thread as _one_thread  # noqa: F401


def _defaults(cls) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


def test_every_shared_args_default_equals_jax():
    mine, theirs = _defaults(Args), _defaults(JArgs)
    shared = (set(mine) & set(theirs)) - {"device"}
    for name in ("method", "ptb_r", "prbcd_epochs", "prbcd_fine_tune",
                 "prbcd_block", "attack"):
        assert name in shared
    assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}
    assert Args().method == "kcenter"


def test_the_cli_reads_the_attack_options(tmp_path):
    from graphslim_tpu.config import get_args as jget_args
    from graphslim_tpu_torch.config import get_args

    argv = ["--save_path", str(tmp_path), "-A", "metattack", "-P", "0.05",
            "--prbcd_block", "1000", "--prbcd_epochs", "7",
            "--prbcd_fine_tune", "2"]
    a, j = get_args(argv), jget_args(argv)
    for k in ("method", "attack", "ptb_r", "prbcd_block", "prbcd_epochs",
              "prbcd_fine_tune"):
        assert getattr(a, k) == getattr(j, k)
    assert a.method == "kcenter" and a.ptb_r == 0.05


NAMES = sorted(jregistry.REGISTRY) + sorted(jregistry._ALIASES)


def test_43_names():
    assert len(NAMES) == 43 and len(jregistry.REGISTRY) == 38


@pytest.mark.parametrize("name", NAMES)
def test_method_spec_equals_jax(name):
    spec, jspec = R.get_method_spec(name), jregistry.get_method_spec(name)
    assert isinstance(spec, R.MethodSpec)
    assert (spec.name, spec.family, spec.module, spec.cls, spec.agg_cls) == \
        (jspec.name, jspec.family, jspec.module, jspec.cls, jspec.agg_cls)


@pytest.mark.parametrize("family", [None, "sparsification", "coarsening",
                                    "condensation"])
def test_list_methods_equals_jax(family):
    assert R.list_methods(family) == jregistry.list_methods(family)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown reduction method"):
        R.get_method_spec("nope")


@pytest.fixture(scope="module")
def both():
    return (jload("synth-small", seed=0),
            load("synth-small", seed=0, device="cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_create_reducer_takes_labels_syn_override(name, both, tmp_path):
    jds, tds = both
    override = np.repeat(np.arange(tds.nclass), 3)
    base = dict(dataset="synth-small", method=name, save_path=str(tmp_path))
    agent = R.create_reducer(name, tds, finalize(Args(device="cpu", **base)),
                             labels_syn_override=override)
    jagent = jregistry.create_reducer(name, jds, jfinalize(JArgs(**base)),
                                      labels_syn_override=override)
    assert type(agent).__name__ == type(jagent).__name__
