"""Train-state checkpoints of a condensation run, for ``--resume``.

Counterpart of ``graphslim_tpu/checkpoint.py``: the whole optimization
state (synthetic features, generator parameters, both Adam states, the
epoch counter) goes to one npz, written to a temporary file and moved into
place with ``os.replace``; the structure is recovered from a template with
the same tree layout (leaves in :func:`graphslim_tpu_torch.utils.tree_leaves`
order: dict keys sorted).

One difference: the JAX package re-splits its random key from the seed on
resume, while the port's reducers draw from one stateful
``torch.Generator``.  The port therefore also stores the generator's state
(``torch.Generator.get_state``) as a leaf of the state, and a resumed run
continues the random stream of the uninterrupted run: on the CPU it ends
at the same state bit for bit.
"""

from __future__ import annotations

import logging
import os
import zipfile

import numpy as np
import torch

from graphslim_tpu_torch.utils import is_writer, tree_leaves

log = logging.getLogger("graphslim_tpu_torch")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state, epoch: int) -> None:
    """Write ``state`` (a tree of tensors, ints and ``None``) and the
    epoch to resume from (rank 0 of a distributed run writes; the others
    return)."""
    if not is_writer():
        return
    leaves = tree_leaves(state)
    payload = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)
               if x is not None}
    payload["__epoch__"] = np.asarray(epoch)
    payload["__n_leaves__"] = np.asarray(len(leaves))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)


def _rebuild(template, leaves):
    """``template``'s tree with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        new = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: new[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, leaves) for t in template)
    return next(leaves)


def _restore(arr: np.ndarray, leaf):
    """A stored array as the kind of leaf the template holds."""
    if isinstance(leaf, torch.Tensor):
        out = torch.as_tensor(arr, dtype=leaf.dtype, device=leaf.device)
        return out.requires_grad_(leaf.requires_grad)
    if isinstance(leaf, int):
        return int(arr)
    return arr


def load_state(path: str, template) -> tuple:
    """(state with ``template``'s structure, epoch), or ``(None, 0)`` when
    the file is absent or does not fit the template (logged)."""
    if not os.path.exists(path):
        return None, 0
    try:
        with np.load(path) as blob:
            leaves = tree_leaves(template)
            if int(blob["__n_leaves__"]) != len(leaves):
                log.warning("checkpoint %s has a different structure; "
                            "ignoring it", path)
                return None, 0
            new = []
            for i, leaf in enumerate(leaves):
                key = f"leaf_{i}"
                if leaf is None or key not in blob.files:
                    new.append(leaf)
                    continue
                arr = blob[key]
                if tuple(arr.shape) != _shape(leaf):
                    log.warning("checkpoint %s leaf %d has shape %s, "
                                "expected %s; ignoring it", path, i,
                                arr.shape, _shape(leaf))
                    return None, 0
                new.append(_restore(arr, leaf))
            return _rebuild(template, iter(new)), int(blob["__epoch__"])
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        # a torn or foreign file: start afresh
        log.warning("failed to load checkpoint %s: %s", path, e)
        return None, 0
