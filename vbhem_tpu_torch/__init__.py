"""vbhem_tpu_torch — the PyTorch / CUDA port of :mod:`vbhem_tpu`.

Same containers, field names and layouts as the JAX package, as plain
functions on tensors.  The VBHEM pair E-step, the VBEM forward-backward
and the VHEM / DIC pair recursion run as hand-written CUDA kernels
(``csrc/``) on CUDA tensors and as their plain PyTorch versions on CPU
tensors.  This package never imports JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# The JAX package forces "highest" matmul precision because reduced
# precision corrupted the pair / FB recursions and ELBOs at the 1e-2
# level; the counterpart here is to keep TF32 off for matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import HEMConfig, VBConfig, VBHEMConfig  # noqa: E402,F401
from .containers import (H3M, HMM, HMMPosterior, NIW, SeqBatch,  # noqa: E402,F401
                         VBHMMResult, pack_sequences)
