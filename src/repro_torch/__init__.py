"""PyTorch/CUDA port of the repo's serving path (dense and MoE decoders,
paged KV).

Layout mirrors ``repro``: ``models/``, ``kernels/``, ``serving/``,
``launch/``, ``configs/``, ``core/``.  The port imports ``torch`` and
numpy only; what it needs from framework-free modules of the JAX package
it keeps as its own copies.

Precision: everything runs in fp32, as the JAX package serves.  Importing
the package turns TF32 off for matmuls and cuDNN convolutions, so a fp32
product on the card is a full fp32 product (PyTorch's matmul default is
already so; cuDNN's is not).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
