"""PyTorch/CUDA port of the LegoDiffusion serving system.

A package beside the JAX reference ``repro``, laid out module for module
like it.  It imports ``torch`` and never ``jax`` or anything of ``repro``.
Entry points run on the CUDA card unless the caller asks for the CPU.

Importing the package turns TF32 off for float32 matmuls and cuDNN
convolutions: the path computes in float32 as the JAX reference does, and
TF32 keeps only about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
