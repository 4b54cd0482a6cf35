"""nrslam_tpu_torch — the PyTorch + CUDA port of nrslam_tpu.

The package mirrors ``nrslam_tpu``'s module names (``geometry/se3.py``,
``slam/tracking.py``, ...) so each counterpart is easy to find. State pytrees
are NamedTuples of tensors with the JAX package's field names; every function
works on the device of its input tensors, and constructors build on the card
unless asked for the CPU (``utils/device.py``). The three whole-solver LM
kernels (pose-only, joint pose+deformation, keyframe BA) are hand-written
CUDA C++ under ``csrc/``; on a CPU tensor their wrappers run the plain
PyTorch version instead.

Parity with the JAX reference is held in float32 at full matmul precision, so
TF32 is switched off once here, at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
