"""Carry state across between the JAX package and the port.

``from_numpy(tree, device)`` takes any JAX-package pytree after
``jax.device_get`` (NamedTuples of numpy arrays, lists/tuples of them such
as a pyramid, or the JAX ``Camera`` dataclass) and builds the port's
counterpart field by field, by class and field name. ``to_numpy(tree)``
goes back to numpy leaves, keeping the port's NamedTuple classes. Neither
imports JAX: they read class and field names, not JAX types.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import graph, initializer, state, tracking
from nrslam_tpu_torch.solver import bundle_adjustment, deformable_triangulation
from nrslam_tpu_torch.solver import pose_deformation
from nrslam_tpu_torch.utils.tree import is_namedtuple, tree_map

# Port classes by the JAX package's class name.
_CLASSES = {cls.__name__: cls for cls in (
    se3.SE3, klt.KLTRefs, klt.KLTConfig, graph.GraphState, state.SlamState,
    state.Config, pose_deformation.PairEdges,
    pose_deformation.PoseDeformationResult, tracking.FrameResult,
    deformable_triangulation.TriangulationInputs,
    bundle_adjustment.BAProblem, initializer.InitializerState,
    initializer.InitializationResult, initializer.InitializerConfig)}


def _leaf_to_tensor(x, device):
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    return torch.from_numpy(np.array(x)).to(device)


def from_numpy(tree, device=None):
    """JAX-package pytree (numpy leaves) -> the port's counterpart."""
    name = type(tree).__name__
    if name == "Camera" and dataclasses.is_dataclass(tree):
        return cameras.Camera(_leaf_to_tensor(tree.params, device), tree.kind)
    if is_namedtuple(tree):
        if name not in _CLASSES:
            raise TypeError(f"no port counterpart for {name}")
        cls = _CLASSES[name]
        if name in ("Config", "KLTConfig", "InitializerConfig"):
            return cls(**tree._asdict())
        fields = tree._asdict()
        return cls(**{f: from_numpy(fields[f], device) for f in cls._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(x, device) for x in tree)
    return _leaf_to_tensor(tree, device)


def to_numpy(tree):
    """Port pytree -> the same structure with numpy leaves."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def to_device(tree, device):
    """Copy every tensor leaf of a port pytree to ``device``."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, tree)
