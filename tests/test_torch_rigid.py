"""The port's rigid solve, euler extraction and observation angles
(egonet_tpu_torch/geometry/rigid.py) against egonet_tpu's, on the CPU, to
1e-5 rad; and the facade's one-kernel rigid stage, the operator
``egonet::rigid_solve`` (ops/rigid_solve.py, csrc/rigid_solve.cuh): its CPU
kernel against the JAX package's solve (angles to the same 1e-5 rad,
translations bit-equal), the header's tables against constants.py, its
schema, Meta kernel and contract.  The CUDA kernel's own tests are in
tests/test_torch_rigid_cuda.py (no JAX there)."""

import inspect
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from egonet_tpu.data import cuboid as jcb
from egonet_tpu.geometry import rigid as jr
from egonet_tpu_torch import constants
from egonet_tpu_torch.data import cuboid as tcb
from egonet_tpu_torch.geometry import rigid as tr
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops.rigid_solve import rigid_solve

torch.set_num_threads(1)
TOL = 1e-5


def _angdiff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = np.mod(d, 2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _noisy_cuboids(rng, n=16, noise=0.02):
    preds = []
    for _ in range(n):
        box = tcb.construct_box_3d(3.9 + 0.2 * rng.randn(), 1.5, 1.7)
        rel = box[:, 1:] - box[:, :1]
        rot = tcb.rot_y_matrix(float(rng.uniform(-np.pi, np.pi)))
        preds.append((rot @ rel).T + noise * rng.randn(32, 3))
    return np.stack(preds).astype(np.float32)


def test_cuboid_copy_matches(rng):
    for l, h, w in ((3.9, 1.5, 1.6), (4.2, 1.6, 1.9)):
        np.testing.assert_array_equal(tcb.construct_box_3d(l, h, w),
                                      jcb.construct_box_3d(l, h, w))
    np.testing.assert_array_equal(tcb.rot_y_matrix(0.7), jcb.rot_y_matrix(0.7))


@pytest.mark.parametrize("method", ["quaternion", "svd"])
def test_six_dof_matches(rng, method):
    preds = _noisy_cuboids(rng)
    a_j, t_j = jr.six_dof_from_cuboids(jnp.asarray(preds), method=method)
    a_t, t_t = tr.six_dof_from_cuboids(torch.from_numpy(preds), method=method)
    assert _angdiff(a_t.numpy(), np.asarray(a_j)).max() < TOL
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))


def test_template_matches(rng):
    preds = _noisy_cuboids(rng, n=4)
    got = tr.template_from_prediction(torch.from_numpy(preds))
    for i in range(4):
        ref = np.asarray(jr.template_from_prediction(jnp.asarray(preds[i])))
        np.testing.assert_allclose(got[i].numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("method", ["quaternion", "svd"])
def test_kabsch_reflection_cases_match(rng, method):
    """Point inversion (Y = -X, not a rotation) and mirrored covariances
    must still give a proper rotation, the same one as the JAX package."""
    cases = [(X, -X) for X in (rng.uniform(-1, 1, (3, 4)) for _ in range(3))]
    for i in range(6):
        X = rng.randn(3, 32)
        Y = rng.randn(3, 32) if i % 2 else \
            0.5 * X + rng.randn(3, 1) + 0.2 * rng.randn(3, 32)
        cases.append((X, Y))
    for X, Y in cases:
        X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
        R_t, t_t = tr.kabsch(torch.from_numpy(X32), torch.from_numpy(Y32),
                             method)
        R_j, t_j = jr.kabsch(jnp.asarray(X32), jnp.asarray(Y32), method)
        assert np.isclose(np.linalg.det(R_t.numpy()), 1.0, atol=1e-5)
        e_t = tr.rotation_to_xyz_angles(R_t).numpy()
        e_j = np.asarray(jr.rotation_to_xyz_angles(R_j))
        assert _angdiff(e_t, e_j).max() < TOL, (e_t, e_j)


def test_jacobi_tau_zero_case():
    """Equal diagonal pair with a nonzero off-diagonal needs the 45-degree
    rotation (tau = 0 -> t = 1)."""
    K = np.diag([5.0, 7.0, 2.0, 2.0])
    K[2, 3] = K[3, 2] = 1.0
    ev_t, V_t = tr._jacobi_eig4(torch.tensor(K[None], dtype=torch.float32))
    ev_j, _ = jr._jacobi_eig4(jnp.asarray(K[None], jnp.float32))
    np.testing.assert_allclose(np.sort(ev_t[0].numpy()), [1.0, 3.0, 5.0, 7.0],
                               atol=1e-5)
    np.testing.assert_allclose(ev_t[0].numpy(), np.asarray(ev_j[0]),
                               atol=1e-5)
    v, lam = V_t[0].numpy(), ev_t[0].numpy()
    np.testing.assert_allclose(K @ v, v * lam, atol=1e-5)


def test_euler_matches_scipy_and_jax(rng):
    Rs = Rotation.random(20, random_state=rng)
    mats = Rs.as_matrix().astype(np.float32)
    got = tr.euler_yxz(torch.from_numpy(mats)).numpy()
    for i in range(20):
        ref = np.asarray(jr.euler_yxz(jnp.asarray(mats[i])))
        assert _angdiff(got[i], ref).max() < TOL
    assert _angdiff(got, Rs.as_euler("yxz")).max() < 1e-4


def test_observation_angles_match(rng):
    n = 32
    ry = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    trans = np.stack([rng.uniform(-20, 20, n), rng.uniform(-1, 2, n),
                      rng.uniform(2, 60, n)], 1).astype(np.float32)
    kx = rng.uniform(0, 1242, n).astype(np.float32)
    f = np.float32(707.0)
    cx = rng.uniform(590, 620, n).astype(np.float32)
    a_t = tr.observation_angle_trans(torch.from_numpy(ry),
                                     torch.from_numpy(trans)).numpy()
    a_j = np.asarray(jr.observation_angle_trans(jnp.asarray(ry),
                                                jnp.asarray(trans)))
    assert _angdiff(a_t, a_j).max() < TOL
    p_t = tr.observation_angle_proj(torch.from_numpy(ry), torch.from_numpy(kx),
                                    torch.tensor(f), torch.from_numpy(cx))
    p_j = jr.observation_angle_proj(jnp.asarray(ry), jnp.asarray(kx),
                                    jnp.float32(f), jnp.asarray(cx))
    assert _angdiff(p_t.numpy(), np.asarray(p_j)).max() < TOL
    assert (np.abs(a_t) <= np.pi + 1e-6).all()


# ------------------------------------------------- egonet::rigid_solve

HEADER = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc",
                      "rigid_solve.cuh")


def _with_root(rng, preds):
    """'R3d+T' rows: a camera-frame root in slot 0, then the cuboid."""
    root = np.stack([rng.uniform(-20, 20, len(preds)),
                     rng.uniform(-1, 2, len(preds)),
                     rng.uniform(2, 60, len(preds))], 1)
    return np.concatenate([root[:, None].astype(np.float32), preds], axis=1)


def _check_op_against_jax(kpts):
    """The op's angles within TOL of the JAX package's solve of the cuboid
    (slots 1..32 with a root), its translations slot 0 bit for bit."""
    six = rigid_solve(torch.from_numpy(kpts))
    assert six.shape == (len(kpts), 6) and six.dtype == torch.float32
    cuboid = kpts[:, 1:] if kpts.shape[1] == 33 else kpts
    a_j, t_j = jr.six_dof_from_cuboids(jnp.asarray(cuboid))
    assert _angdiff(six[:, :3].numpy(), np.asarray(a_j)).max() < TOL
    np.testing.assert_array_equal(six[:, 3:].numpy(), kpts[:, 0])
    if kpts.shape[1] == 32:
        np.testing.assert_array_equal(six[:, 3:].numpy(), np.asarray(t_j))
    return six


@pytest.mark.parametrize("points", [32, 33])
@pytest.mark.parametrize("n", [1, 7, 512])
def test_rigid_solve_op_matches_jax(rng, n, points):
    preds = _noisy_cuboids(rng, n=n)
    _check_op_against_jax(preds if points == 32 else _with_root(rng, preds))


@pytest.mark.parametrize("points", [32, 33])
def test_rigid_solve_op_degenerate_covariance(rng, points):
    """Cuboids collapsed to one point: the template is all zeros, so H and
    Horn's K are zero and every one of the 36 Jacobi rotations takes the
    ``kpq == 0`` branch (t = 0); the quaternion is the first eigenvector
    (a four-way tie), the rotation the identity.  Mixed with noisy crops in
    one batch, which keep their own answers."""
    spots = rng.uniform(-5, 5, (4, 1, 3)).astype(np.float32)
    flat = np.repeat(spots, 32, axis=1)
    preds = np.concatenate([flat, _noisy_cuboids(rng, n=4)])
    kpts = preds if points == 32 else _with_root(rng, preds)
    six = _check_op_against_jax(kpts)
    np.testing.assert_array_equal(six[:4, :3].numpy(), np.zeros((4, 3)))


def _header_macro(name):
    with open(HEADER) as f:
        text = f.read()
    body = re.search(rf"#define {name} (.+)", text).group(1)
    return [float(v.rstrip("f")) for v in re.findall(r"[-\d.]+f?", body)]


def test_header_tables_are_the_constants():
    """The kernel's edge table, interpolation coefficients and sweep count
    are constants.py's and _jacobi_eig4's."""
    parents, children = constants.INTERP_DICT["bbox12"]
    assert _header_macro("EGONET_RIGID_EDGE_PARENT") == (parents - 1).tolist()
    assert _header_macro("EGONET_RIGID_EDGE_CHILD") == (children - 1).tolist()
    coef = _header_macro("EGONET_RIGID_INTERP_COEF")
    assert np.float32(coef).tolist() == \
        np.float32(constants.DEFAULT_INTERP_COEF).tolist()
    sweeps = inspect.signature(tr._jacobi_eig4).parameters["sweeps"].default
    assert _header_macro("EGONET_RIGID_SWEEPS") == [sweeps]


def test_rigid_solve_schema():
    _build.load_ops("cpu")
    assert str(torch.ops.egonet.rigid_solve.default._schema) == \
        "egonet::rigid_solve(Tensor kpts_3d) -> Tensor"


@pytest.mark.parametrize("n,points", [(1, 32), (9, 33), (64, 32)])
def test_rigid_solve_opcheck(rng, n, points):
    """Schema, Meta kernel (with symbolic shapes), CPU kernel and the
    dispatcher's autograd and AOT checks, against each other."""
    _build.load_ops("cpu")
    preds = _noisy_cuboids(rng, n=n)
    kpts = preds if points == 32 else _with_root(rng, preds)
    torch.library.opcheck(torch.ops.egonet.rigid_solve.default,
                          (torch.from_numpy(kpts),))


RIGID_BREACHES = {
    "fp64": ((4, 32, 3), torch.float64, False),
    "bf16": ((4, 32, 3), torch.bfloat16, False),
    "31_points": ((4, 31, 3), torch.float32, False),
    "34_points": ((4, 34, 3), torch.float32, False),
    "2_coordinates": ((4, 32, 2), torch.float32, False),
    "2d": ((4, 96), torch.float32, False),
    "strided": ((32, 4, 3), torch.float32, True),
}


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("name", sorted(RIGID_BREACHES))
def test_rigid_solve_refuses_every_breach(name, device):
    _build.load_ops("cpu")
    shape, dtype, strided = RIGID_BREACHES[name]
    x = torch.zeros(shape, dtype=dtype, device=device)
    if strided:
        x = x.transpose(0, 1)
    with pytest.raises(ValueError):
        torch.ops.egonet.rigid_solve(x)


@pytest.mark.parametrize("points", [32, 33])
def test_rigid_solve_meta_kernel_shapes_the_output(points):
    _build.load_ops("cpu")
    y = torch.ops.egonet.rigid_solve(torch.empty(300, points, 3,
                                                 device="meta"))
    assert y.shape == (300, 6) and y.dtype == torch.float32 and y.is_meta


def test_rigid_solve_counts_no_cpu_launch(rng):
    """The count is the CUDA kernel's: the CPU kernel adds nothing, and the
    counter is apart from the fused kernels'."""
    saved = [_build.launches(op) for op in
             (_build.TILED, _build.STENCIL, _build.RIGID)]
    try:
        rigid_solve.launches = 5
        rigid_solve(torch.from_numpy(_noisy_cuboids(rng, n=3)))
        assert _build.launches(_build.RIGID) == rigid_solve.launches == 5
        assert [_build.launches(op) for op in (_build.TILED, _build.STENCIL)] \
            == saved[:2]
    finally:
        _build.set_launches(_build.RIGID, saved[2])
