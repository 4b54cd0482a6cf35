"""Build and load the port's hand-written CUDA kernels.

The sources under ``nrslam_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked into
one shared library with a plain C interface, at first use, into
``kernels/_build/`` (listed in .gitignore). The library name carries a
hash of the sources and flags, so an edited source triggers a rebuild and a
stale build is never loaded. The library is bound with ``ctypes``: every
pointer and the stream are ``c_void_p``, every size ``c_int``, and every
entry point returns ``cudaGetLastError()``.

Nothing is built or loaded at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ptxas's report (registers, shared memory, spills) of each source of the
# loaded library, by file name: kept beside the library when it is built
# (``.log``, JSON) and read back when a later process loads it.
build_log: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures: name -> (restype, argtypes).
_SIGNATURES = {
    "nrslam_pose_only": (_I, [_P] * 9 + [_I] * 7 + [_P]),
    "nrslam_pose_only_limits": (_I, [_I, _P]),
    "nrslam_pose_deformation": (_I, [_P] * 17 + [_I] * 10 + [_P]),
    "nrslam_pose_deformation_scratch": (ctypes.c_long, [_I, _I]),
    "nrslam_pose_deformation_blocks": (_I, []),
    "nrslam_ba": (_I, [_P] * 17 + [_I] * 7 + [_P]),
    "nrslam_ba_scratch": (ctypes.c_long, [_I, _I, _I]),
    "nrslam_ba_blocks": (_I, []),
    "nrslam_pose_shard_layout": (_I, [_P]),
    "nrslam_pose_shard_partials": (_I, [_P, _P, _I, _P, _P, _P] + [_I] * 5
                                   + [_P, _P]),
    "nrslam_pose_shard_step": (_I, [_P, _P, _I, _I, _P]),
    "nrslam_pose_shard_relevel": (_I, [_P] * 6 + [_I, _I, _P]),
    "nrslam_joint_shard_layout": (_I, [_I] * 4 + [_P]),
    "nrslam_joint_shard": (_I, [_I, _I, _P, _I] + [_P] * 14 + [_I] * 6
                           + [_P]),
    "nrslam_ba_shard_layout": (_I, [_I] * 5 + [_P]),
    "nrslam_ba_shard": (_I, [_I, _I, _P, _I] + [_P] * 14 + [_I] * 7
                        + [_P]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin); the CUDA kernels cannot be "
                           "built")
    return path


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")), sorted(SOURCE_DIR.glob("*.cuh"))


def _digest() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> dict:
    """Wait for every (name, Popen); raise with the output of a failure,
    else return each one's output by name."""
    failed, logs = [], {}
    for name, proc in procs:
        out, err = proc.communicate()
        logs[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{out}{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Raises on failure."""
    cu, _ = _sources()
    so = BUILD_DIR / f"libnrslam_kernels_{_digest()}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f.stem + ".o") for f in cu]
            nvcc = _nvcc()
            build_log.update(_run([(f.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(f)], text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
                for f, o in zip(cu, objs)]))
            linked = os.path.join(tmp, "lib.so")
            _run([("link", subprocess.Popen(
                [nvcc, "-shared", "-o", linked, *objs], text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))])
            log.write_text(json.dumps(build_log))
            os.replace(linked, so)
    elif log.exists():
        build_log.update(json.loads(log.read_text()))
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require_cuda(name: str, *tensors) -> torch.device:
    """Every tensor on one CUDA device, contiguous; returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    return dev


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
