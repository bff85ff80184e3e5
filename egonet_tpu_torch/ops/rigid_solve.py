"""The facade's rigid stage as one hand-written kernel: the operator
``egonet::rigid_solve`` (``csrc/rigid_solve.cuh``, ``csrc/rigid_solve.cu``,
registered in ``csrc/egonet_ops*.cpp``).

``kpts_3d`` [N, P, 3] fp32 contiguous -> [N, 6] fp32 = (rx, ry, rz, tx, ty,
tz): ``geometry/rigid.six_dof_from_cuboids``'s quaternion path (template
fit, Horn covariance, the static 6-sweep Jacobi eigensolver, euler angles)
in one launch on the card, one thread per crop.  P = 32 is a
center-relative cuboid; P = 33 ('R3d+T') carries the camera-frame root in
slot 0 and the cuboid in slots 1..32.  Either way the translation is slot
0, as ``EgoNet._tail`` took it from the torch ops this replaces.  The CPU
kernel runs the same per-crop routine in a loop; the Meta kernel holds the
contract, so ``torch.export`` traces the op as one node.

``geometry/rigid.py`` keeps the solve in torch ops (with the SVD method
beside it): the tests' reference, and the path of the callers that run the
solve outside the facade.  ``rigid_solve.launches`` counts the CUDA
kernel's launches (and nothing else).
"""

from __future__ import annotations

import torch

from egonet_tpu_torch.ops import _build


@_build.counted(_build.RIGID)
def rigid_solve(kpts_3d: torch.Tensor) -> torch.Tensor:
    """[N, 6] (rx, ry, rz, tx, ty, tz) of ``kpts_3d`` [N, 32 or 33, 3]
    (contiguous fp32), on its device: the CUDA kernel on the current stream
    of a CUDA tensor, the per-crop loop on the CPU."""
    _build.load_ops(kpts_3d.device.type)
    return torch.ops.egonet.rigid_solve.default(kpts_3d)
