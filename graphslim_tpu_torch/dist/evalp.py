"""Seed-parallel evaluation: the seeds of a multi-seed run shard over the
ranks.

Counterpart of ``graphslim_tpu/dist/evalp.py``, where the seed axis of a
vmap shards over the mesh.  Here the seeds are padded to a multiple of the
world size, rank r runs seeds ``r·k .. r·k + k - 1`` one after another,
each from its own generator (:func:`seed_generator`, from ``(seed, i)``,
so a seed's result does not depend on the world size), and the results are
gathered over the ranks; every rank returns the first ``n_seeds`` in seed
order.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import utils
from graphslim_tpu_torch.dist.mesh import all_gather, axis_size


def seed_generator(seed: int, i: int, device) -> torch.Generator:
    """The generator of seed ``i`` of a run seeded with ``seed``."""
    state = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)
    return torch.Generator(device=torch.device(device)).manual_seed(
        int(state[0]) & (2 ** 63 - 1))


def sharded_multi_seed(mesh, fn, n_seeds: int, seed: int = 0,
                       axis: str = "data"):
    """``fn(generator) -> tensor or tree of tensors`` for ``n_seeds``
    seeds, sharded over ``axis`` → the results stacked on a leading seed
    axis, on every rank.  ``fn`` gets a generator on the mesh's device and
    returns tensors of one shape and type for every seed, on that
    device."""
    device = mesh.device_type
    n_dev, me = axis_size(mesh, axis), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    per = -(-n_seeds // n_dev)
    outs = [fn(seed_generator(seed, i, device))
            for i in range(me * per, (me + 1) * per)]
    leaves0 = utils.tree_leaves(outs[0])
    stacked = [torch.stack([utils.tree_leaves(o)[k] for o in outs])
               for k in range(len(leaves0))]
    full = []
    for s in stacked:
        g = s.new_empty((n_dev * per,) + tuple(s.shape[1:]))
        all_gather(g, s.contiguous(), group)
        full.append(g[:n_seeds])
    at = {id(leaf): k for k, leaf in enumerate(leaves0)}
    return utils.tree_map(lambda leaf: full[at[id(leaf)]], outs[0])
