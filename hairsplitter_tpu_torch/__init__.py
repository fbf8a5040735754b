"""hairsplitter_tpu_torch — the PyTorch / CUDA port of hairsplitter_tpu.

Same stages, CLI flags and artifacts as the JAX package `hairsplitter_tpu`
(the reference implementation, unchanged beside this one); plain tensor
code is PyTorch, and the Myers bit-vector DP under the fused mapping call
is a hand-written CUDA kernel for Hopper (`csrc/myers_rows.cu`). Host
modules of the JAX package that load without JAX (io, seeding, native,
pileup, graph untangling helpers, simulators) are reused, not copied.

The package never imports JAX. Float32 matmuls run in full precision: the
Chinese-Whispers vote and chi² contingency matmuls must give exact integer
sums, which TF32 would not.
"""

import torch

__version__ = "0.5.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
