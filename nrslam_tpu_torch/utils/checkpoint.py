"""Checkpoint and resume of the SLAM state (counterpart of
nrslam_tpu/utils/checkpoint.py, which writes the pytree through orbax).

``save`` writes ``<path>/step_<k>.pt``: ``torch.save`` of a dict of the
state's tensors, moved to the CPU, by dotted field name (``"Tcw.q"``,
``"graph.weight"``). ``restore`` rebuilds the structure of an example state
on that example's device. It also reads the JAX package's npz fallback
layout (``step_<k>.npz`` holding ``leaf_0..`` in the pytree's leaf order,
which for a NamedTuple state is field order, depth first), so a state saved
by the JAX package resumes in the port. The JAX package's default layout,
an orbax directory ``step_<k>/``, is read through orbax, imported only
then (the card's machine has none).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from nrslam_tpu_torch.utils.tree import is_namedtuple


def _named_leaves(tree, prefix=""):
    """(dotted name, tensor) of every leaf, depth first in field order."""
    if is_namedtuple(tree):
        for field, value in zip(tree._fields, tree):
            yield from _named_leaves(value, f"{prefix}{field}.")
    elif isinstance(tree, (list, tuple)):
        for k, value in enumerate(tree):
            yield from _named_leaves(value, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _nested_map(fn, tree):
    """``fn`` over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _nested_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_nested_map(fn, v) for v in tree]
    return fn(tree)


def _read_orbax(directory: Path, names):
    """The arrays of the orbax checkpoint ``directory`` (nested dicts by
    field name, lists by position) at each dotted name, as numpy."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as err:
        raise RuntimeError(f"{directory} is an orbax checkpoint (the JAX "
                           f"package's default layout): reading it needs "
                           f"the orbax-checkpoint package") from err
    with ocp.PyTreeCheckpointer() as ckptr:
        meta = ckptr.metadata(directory).item_metadata
        args = _nested_map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray),
                           getattr(meta, "tree", meta))
        tree = ckptr.restore(directory, restore_args=args)
    leaves = []
    _nested_map(leaves.append, tree)
    n_saved = len(leaves)
    if n_saved != len(names):
        raise ValueError(f"{directory}: {n_saved} arrays, the example state "
                         f"has {len(names)}")
    values = []
    for name in names:
        node = tree
        for key in name.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        values.append(torch.from_numpy(np.array(node)))
    return values


def save(path: str, state, step: int = 0) -> None:
    """Write ``state`` (any NamedTuple / list / tuple tree of tensors) to
    ``<path>/step_<step>.pt``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({name: leaf.detach().cpu()
                for name, leaf in _named_leaves(state)},
               path / f"step_{step}.pt")


def restore(path: str, example_state, step: int = 0):
    """The state saved at ``step``, in ``example_state``'s structure, on its
    device: the port's ``step_<k>.pt``, else the JAX package's orbax
    directory ``step_<k>/`` or its ``step_<k>.npz``. Raises where a leaf's
    name, shape or dtype does not match the example."""
    path = Path(path)
    example = list(_named_leaves(example_state))
    pt = path / f"step_{step}.pt"
    if pt.exists():
        saved = torch.load(pt, weights_only=True)
        values = [saved[name] for name, _ in example]
        if len(saved) != len(example):
            raise ValueError(f"{pt}: {len(saved)} tensors, the example "
                             f"state has {len(example)}")
    elif (path / f"step_{step}").is_dir():
        values = _read_orbax((path / f"step_{step}").absolute(),
                             [name for name, _ in example])
    else:
        data = np.load(path / f"step_{step}.npz")
        if len(data.files) != len(example):
            raise ValueError(f"{path / f'step_{step}.npz'}: {len(data.files)} "
                             f"leaves, the example state has {len(example)}")
        values = [torch.from_numpy(np.array(data[f"leaf_{i}"]))
                  for i in range(len(example))]
    out = []
    for (name, ref), value in zip(example, values):
        if value.shape != ref.shape or value.dtype != ref.dtype:
            raise ValueError(f"checkpoint leaf {name}: {value.dtype} "
                             f"{tuple(value.shape)}, expected {ref.dtype} "
                             f"{tuple(ref.shape)}")
        out.append(value.to(ref.device))
    return _rebuild(example_state, iter(out))
