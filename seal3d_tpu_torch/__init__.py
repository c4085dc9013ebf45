"""seal3d_tpu_torch — the PyTorch/CUDA port of seal3d_tpu for one NVIDIA H100.

The JAX package `seal3d_tpu` stays the reference; this package mirrors its
module names (ops/, models/, render/, data/, train/) so each counterpart is
easy to find, and never imports it or JAX. Plain tensor code is PyTorch; each
Pallas kernel of the ported path is a hand-written Hopper kernel under
`csrc/`, built with nvcc at first use (runtime/build.py) and bound with
ctypes. On a CPU tensor a kernel wrapper runs the kernel's plain PyTorch
version instead; on a CUDA tensor it launches the kernel or raises.

Numerics: the reference computes in float32 (bf16 only where it says so), so
TF32 is switched off for float32 matmuls and cuDNN convolutions here — both
would otherwise keep only ~10 mantissa bits on the card.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
