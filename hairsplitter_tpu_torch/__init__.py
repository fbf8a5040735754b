"""hairsplitter_tpu_torch — the PyTorch / CUDA port of hairsplitter_tpu.

Same stages, CLI flags and artifacts as the JAX package `hairsplitter_tpu`
(the reference implementation, unchanged beside this one); plain tensor
code is PyTorch, and the Myers bit-vector DP under the fused mapping call
is a hand-written CUDA kernel for Hopper (`csrc/myers_fused.cu`). The
package stands alone: it keeps its own copy of every host module it needs
(io, seeding, the native C++ library, pileup, graph untangling helpers,
simulators) under the same relative names as in the JAX package.

The package never imports JAX, nor anything of the JAX package. Float32 matmuls run in full precision: the
Chinese-Whispers vote and chi² contingency matmuls must give exact integer
sums, which TF32 would not.
"""

import torch

__version__ = "0.5.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
