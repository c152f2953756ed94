"""graphslim_tpu_torch — the PyTorch/CUDA port of ``graphslim_tpu``.

The module layout mirrors ``graphslim_tpu`` so each counterpart is easy to
find.  This package imports ``torch`` and numpy only: never JAX and nothing
of ``graphslim_tpu`` (whose import pulls in JAX).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Every float32 matrix product and convolution stays in
true float32 (TF32 off): the nested gradients of GCond lose quality at
reduced precision.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from graphslim_tpu_torch.utils import resolve_device  # noqa: E402,F401
