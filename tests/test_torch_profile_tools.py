"""The port's per-stage tools (nrslam_tpu_torch/profile_{stages,device,
mapping,scale}.py) against the JAX package's root scripts of the same
names: each reports the keys its JAX script reports (read from the
script's AST, without importing it), refuses to run without a CUDA device,
and its stage calls run on a small CPU problem (P=128 at 160x120), each
giving a finite result, a device step its carry's structure back."""

import ast
import os

import pytest
import torch

from nrslam_tpu_torch import (profile_device, profile_mapping, profile_scale,
                              profile_stages)
from nrslam_tpu_torch.utils import tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOLS = {"profile_stages": profile_stages, "profile_device": profile_device,
         "profile_mapping": profile_mapping, "profile_scale": profile_scale}


def _script(name):
    with open(os.path.join(REPO, f"{name}.py")) as f:
        return ast.parse(f.read())


class _ResultKeys(ast.NodeVisitor):
    """The keys stored as ``results[...] = ...``, in source order; an
    f-string key is expanded over the constant tuple its loop runs over."""

    def __init__(self):
        self.keys, self.env = [], {}

    def visit_For(self, node):
        if not (isinstance(node.target, ast.Name)
                and isinstance(node.iter, (ast.Tuple, ast.List))):
            return self.generic_visit(node)
        for value in ast.literal_eval(node.iter):
            self.env[node.target.id] = value
            for stmt in node.body:
                self.visit(stmt)
        del self.env[node.target.id]

    def visit_Subscript(self, node):
        if (isinstance(node.value, ast.Name) and node.value.id == "results"
                and isinstance(node.ctx, ast.Store)):
            self.keys.append(self._text(node.slice))
        self.generic_visit(node)

    def _text(self, node):
        if isinstance(node, ast.Constant):
            return node.value
        return "".join(str(self.env[v.value.id])
                       if isinstance(v, ast.FormattedValue) else v.value
                       for v in node.values)


def _returned_dict_keys(module, function):
    """The keywords of the ``dict(...)`` that ``function`` returns."""
    fn = next(n for n in module.body
              if isinstance(n, ast.FunctionDef) and n.name == function)
    call = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Return))
    assert isinstance(call, ast.Call) and call.func.id == "dict"
    return tuple(k.arg for k in call.keywords)


@pytest.mark.parametrize("name", ["profile_stages", "profile_device",
                                  "profile_mapping"])
def test_stage_keys_are_the_jax_scripts(name):
    visitor = _ResultKeys()
    visitor.visit(_script(name))
    assert len(visitor.keys) >= 6
    assert TOOLS[name].KEYS == tuple(visitor.keys)


def test_scale_rows_and_points_are_the_jax_scripts():
    """The JAX script's row keys lead the port's rows; the operating points
    are the same."""
    module = _script("profile_scale")
    point = _returned_dict_keys(module, "bench_point")
    init = _returned_dict_keys(module, "init_at_scale")
    assert profile_scale.POINT_KEYS[:len(point)] == point
    assert profile_scale.INIT_KEYS[:len(init)] == init
    main = next(n for n in module.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    points = next(ast.literal_eval(n.value) for n in ast.walk(main)
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "points")
    assert tuple(points) == profile_scale.POINTS


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_main_needs_a_cuda_device(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[name].main([])


def test_chain_refuses_the_cpu():
    """The captured chain needs a CUDA device, as device_timeit does."""
    from nrslam_tpu_torch.utils import profiler

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.Chain(lambda c: c + 1, torch.zeros(4), k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.device_reading(lambda: None)


@pytest.fixture(scope="module")
def problem():
    return profile_stages.steady_state(128, 120, 160, 64, device="cpu")


def _finite(x):
    return all(torch.isfinite(t.to(torch.float32)).all()
               for t in tree.leaves(x))


@pytest.mark.parametrize("name", ["profile_stages", "profile_mapping"])
def test_chained_stage_calls_run_on_cpu(problem, name):
    calls = (profile_stages.stage_calls(problem) if name == "profile_stages"
             else profile_mapping.mapping_calls(problem))
    assert tuple(calls) == TOOLS[name].KEYS
    eps = torch.zeros(())
    for key, (fn, perturb) in calls.items():
        out = fn(perturb(eps))
        assert isinstance(out, torch.Tensor) and out.numel() > 0, key
        assert _finite(out), key


def test_device_steps_return_their_carry_on_cpu(problem):
    """Each step of profile_device maps its carry to a tree of the same
    structure, dtypes and shapes (what the captured chain writes back)."""
    steps = profile_device.stage_steps(problem)
    assert tuple(steps) == profile_device.KEYS
    for key, (step, carry0) in steps.items():
        out = step(step(carry0))
        assert tree.packing(out).specs == tree.packing(carry0).specs, key
        assert _finite(out), key
