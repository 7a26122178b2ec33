"""qtos_torch — the SOLO12 gait-trajectory stack in PyTorch, for an NVIDIA H100.

The module layout mirrors `qtos_tpu`: `qtos_torch.solver.solve` is the
counterpart of `qtos_tpu.solver.solve`, and so on.  Everything is float32.
The batched block-tridiagonal solve of every Levenberg-Marquardt iteration is
a hand-written CUDA kernel (`csrc/btd.cu`, wrapped by `ops.btd`); the rest is
plain PyTorch.

Public entry points take ``device=None``, which means CUDA.  Without a card
they raise unless the caller passes ``device="cpu"`` explicitly.
"""

import torch

# float32 products in full precision: TF32 keeps ~3 decimal digits, and the
# Gauss-Newton blocks are badly scaled enough for that to move the iterates.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from qtos_torch.device import resolve_device  # noqa: E402,F401
