"""ipoke_tpu_torch — the PyTorch/CUDA port of ``ipoke_tpu`` for NVIDIA Hopper.

The port keeps the JAX package's module names, its parameter trees (nested
dicts and lists of tensors) and its NHWC layout at every public function, so
each function here has a counterpart of the same name there.  Inside, convs
run through ``torch.nn.functional`` on NCHW views; the masked-conv-flow
inverses, the sequential hot loop of sampling, run in hand-written CUDA
kernels (``ops/cuda``, sources in ``csrc/``).

This package imports ``torch`` and ``numpy`` only: nothing of JAX and nothing
of ``ipoke_tpu``.  What it needs from there it keeps as its own copy.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
``device=None`` and no CUDA device they raise rather than fall back.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the first CUDA card.

    Raises when ``None`` is given and no card is present: the port never
    moves to the CPU unless the caller asks for it.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ipoke_tpu_torch: no CUDA device; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
