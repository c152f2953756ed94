"""Dataset layer: the synthetic twins, splits and the artifact store."""

from graphslim_tpu_torch.data.loader import load, DATASET_SPECS, DatasetSpec
from graphslim_tpu_torch.data.artifacts import (
    save_reduced, read_npz, sparsify, load_reduced, get_syn_data,
)
