"""Where the port's constructors put the tensors they build.

The port runs on the card: a constructor called without a device (cameras,
synthetic data, ``graph.empty``, ``state.empty_state``, the bench problems)
builds on the current CUDA device, and raises where there is none. It never
falls back to the CPU; the CPU tests and the CPU side of a parity check ask
for it with ``device="cpu"``. Functions that take tensors run on the device
of their inputs and do not use this.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as given, or the current CUDA device when it is None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the card by "
                           "default; pass device='cpu' to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
