"""Port parity of the small public helpers: ``graph.neighborhood_rings``,
the SE(3) interpolation and matrix helpers, ``stats.CHI2_95``,
``core.inv_spd6``, the camera's intrinsics accessors and
``native_loader.build``, each against the JAX package on the CPU; and the
kernels' camera-kind numbers (``kernels.CAMERA_KINDS``) against
csrc/common.cuh's.

Tolerances: 1e-5 on float32 geometry (both sides evaluate the same
formulas; libm rounding differs by a few ulp); 1e-5 relative on the 6x6
inverse of a matrix with condition number below 1e3; masks, tables and
accessors equal.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrslam_tpu.geometry import cameras as jcam
from nrslam_tpu.geometry import se3 as jse3
from nrslam_tpu.slam import graph as jgraph
from nrslam_tpu.solver import core as jcore
from nrslam_tpu.utils import stats as jstats
from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras as tcam
from nrslam_tpu_torch.geometry import se3 as tse3
from nrslam_tpu_torch.slam import graph as tgraph
from nrslam_tpu_torch.solver import core as tcore
from nrslam_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)

TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rings_both(positions, seeds, sigma, k):
    P = positions.shape[0]
    jg = jgraph.initialize(jgraph.empty(P), jnp.asarray(positions),
                           jnp.ones(P, bool), sigma)
    tg = tgraph.initialize(tgraph.empty(P, device="cpu"), _t(positions),
                           torch.ones(P, dtype=torch.bool), sigma)
    rj = jgraph.neighborhood_rings(jg, jnp.asarray(seeds), k=k)
    rt = tgraph.neighborhood_rings(tg, _t(seeds), k=k)
    return [np.asarray(r) for r in rj], [r.numpy() for r in rt]


def test_neighborhood_rings_line():
    """The JAX package's own case (test_system_extras.py): a line of four
    points and a far one."""
    pos = np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0],
                    [50, 0, 0]], np.float32)
    seeds = np.array([True, False, False, False, False])
    rj, rt = _rings_both(pos, seeds, 2.0, 2)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b, a)
    r0, r1, r2 = rt
    assert r1[1] and r1[2] and not r1[0] and r2[3] and not r2[4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neighborhood_rings_random(seed):
    """40 random points, a few seeds, k=4, equal-weight ties included (a
    duplicated point): every ring equal to JAX's."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    pos[7] = pos[3]
    seeds = rng.random(40) < 0.1
    seeds[3] = True
    rj, rt = _rings_both(pos, seeds, 0.6, 4)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b, a)
    assert rt[1].any() and rt[2].any()


def test_quat_slerp_and_slerp_match_jax():
    rng = np.random.default_rng(3)
    q0, q1 = _rand_quats(rng, 16), _rand_quats(rng, 16)
    q1[0] = q0[0]                      # parallel: the lerp branch
    q1[1] = -q0[1]                     # antipodal: the shortest arc
    u = rng.uniform(0, 1, 16).astype(np.float32)
    np.testing.assert_allclose(
        tse3.quat_slerp(_t(q0), _t(q1), _t(u)).numpy(),
        np.asarray(jse3.quat_slerp(jnp.asarray(q0), jnp.asarray(q1),
                                   jnp.asarray(u))), atol=TOL)
    t0, t1 = (rng.normal(size=(16, 3)).astype(np.float32) for _ in range(2))
    Tj = jse3.slerp(jse3.SE3(jnp.asarray(q0), jnp.asarray(t0)),
                    jse3.SE3(jnp.asarray(q1), jnp.asarray(t1)), 0.25)
    Tt = tse3.slerp(tse3.SE3(_t(q0), _t(t0)), tse3.SE3(_t(q1), _t(t1)), 0.25)
    np.testing.assert_allclose(Tt.q.numpy(), np.asarray(Tj.q), atol=TOL)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=TOL)


def test_matrix_and_stack_match_jax():
    rng = np.random.default_rng(4)
    tw = np.concatenate([rng.uniform(-2.5, 2.5, (12, 3)),
                         rng.uniform(-1, 1, (12, 3))], -1).astype(np.float32)
    Tj = jse3.exp(jnp.asarray(tw))
    Tt = tse3.exp(_t(tw))
    Mj, Mt = jse3.to_matrix(Tj), tse3.to_matrix(Tt)
    assert Mt.shape == (12, 4, 4)
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=TOL)
    Bj, Bt = jse3.from_matrix(Mj), tse3.from_matrix(_t(Mj))
    np.testing.assert_allclose(Bt.q.numpy(), np.asarray(Bj.q), atol=TOL)
    np.testing.assert_allclose(Bt.t.numpy(), np.asarray(Bj.t), atol=TOL)
    Sj = jse3.stack([jse3.index(Tj, i) for i in range(3)], axis=1)
    St = tse3.stack([tse3.index(Tt, i) for i in range(3)], dim=1)
    assert St.q.shape == tuple(Sj.q.shape) == (4, 3)
    np.testing.assert_allclose(St.t.numpy(), np.asarray(Sj.t), atol=TOL)


def test_chi2_table_matches_jax():
    np.testing.assert_array_equal(tstats.CHI2_95.numpy(),
                                  np.asarray(jstats.CHI2_95))
    assert tstats.CHI2_95.dtype == torch.float32


def test_inv_spd6_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    H = (A @ A.transpose(0, 2, 1) + 2.0 * np.eye(6, dtype=np.float32))
    Hi_t = tcore.inv_spd6(_t(H)).numpy()
    Hi_j = np.asarray(jcore.inv_spd6(jnp.asarray(H)))
    scale = np.abs(Hi_j).max()
    np.testing.assert_allclose(Hi_t, Hi_j, atol=TOL * scale)
    np.testing.assert_allclose(H @ Hi_t, np.broadcast_to(np.eye(6), H.shape),
                               atol=1e-3)


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_camera_intrinsics_match_jax(kind):
    if kind == "pinhole":
        cj = jcam.pinhole(472.65, 470.0, 479.5, 359.5)
        ct = tcam.pinhole(472.65, 470.0, 479.5, 359.5, device="cpu")
    else:
        args = (400.0, 401.0, 319.5, 239.5, 0.05, -0.01, 0.004, -0.001)
        cj = jcam.kannala_brandt8(*args)
        ct = tcam.kannala_brandt8(*args, device="cpu")
    for name in ("fx", "fy", "cx", "cy"):
        assert float(getattr(ct, name)) == float(getattr(cj, name)), name


@pytest.mark.parametrize("kind, constant", [(tcam.PINHOLE, "kPinhole"),
                                            (tcam.KB8, "kKB8")])
def test_camera_kinds_match_common_cuh(kind, constant):
    """``kernels.CAMERA_KINDS`` numbers each kind as csrc/common.cuh's
    constant does, and ``CAMERA_PARAMS`` counts the parameters its
    constructor makes: a change made on one side alone fails."""
    src = (Path(kernels.SOURCE_DIR) / "common.cuh").read_text()
    found = re.findall(rf"constexpr int {constant} = (\d+);", src)
    assert found and kernels.CAMERA_KINDS[kind] == int(found[0])
    assert set(kernels.CAMERA_KINDS) == set(kernels.CAMERA_PARAMS) \
        == {tcam.PINHOLE, tcam.KB8}
    make = {tcam.PINHOLE: lambda: tcam.pinhole(1.0, 1.0, 0.0, 0.0, "cpu"),
            tcam.KB8: lambda: tcam.kannala_brandt8(1.0, 1.0, 0.0, 0.0, 0.0,
                                                   0.0, 0.0, 0.0, "cpu")}
    assert make[kind]().params.shape == (kernels.CAMERA_PARAMS[kind],)


def test_native_loader_build_matches_jax(tmp_path):
    """build() succeeds here exactly where the JAX package's does, and a
    forced rebuild gives a library that decodes."""
    from nrslam_tpu.datasets import native_loader as jnl
    from nrslam_tpu_torch.datasets import native_loader as tnl

    ok = tnl.build()
    assert ok == jnl.build()
    if not ok:
        pytest.skip("native toolchain unavailable here")
    assert tnl.build(force=True)
    assert tnl.decode(str(tmp_path / "missing.png")) is None
