"""The plain reference of the benchmark: a frozen copy of
nrslam_tpu_torch's eager op path (image ops, KLT, Shi-Tomasi, the
initializer, tracking, mapping, the deformation graph and the plain LM
drivers of the three solves), in plain PyTorch. It imports nothing of the
port, of the JAX package or of JAX; every solve runs its plain driver on
whatever device its tensors are on (no hand-written kernel, no CUDA
graph). Float32 at full matmul precision: TF32 is switched off here, as
the port does; the benchmark's control switches it on."""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
