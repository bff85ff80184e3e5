// The rigid solve of one crop, for the CUDA kernel of rigid_solve.cu and
// the CPU kernel of egonet_ops.cpp alike (compiled by nvcc as __host__
// __device__, by the host compiler as plain inline C++):
//
//   kpts [P, 3] fp32, P = 32 (the center-relative cuboid) or P = 33
//   ('R3d+T': slot 0 the camera-frame root, slots 1..32 the cuboid)
//   -> out [6] = (rx, ry, rz, tx, ty, tz)
//
// Step for step geometry/rigid.py's quaternion path (six_dof_from_cuboids
// with method="quaternion"), in fp32: the template fit (the 12 edge lengths,
// the h / l / w means, the 8 corners and the 24 points interpolated along
// the edges), both centroids and H = Xc Yc^T, Horn's 4x4 K, the static
// Jacobi schedule of _jacobi_eig4 (6 sweeps over the pairs (0,1) (0,2)
// (0,3) (1,2) (1,3) (2,3), t = 0 where K[p][q] == 0), the eigenvector of the
// largest eigenvalue (the first index of a tie, as torch.argmax), the
// normalised quaternion's rotation and its euler_yxz angles reordered to
// (rx, ry, rz).  The translation is slot 0 of kpts, for either P.  Each
// Jacobi rotation K <- G^T K G touches only rows and columns p and q, and
// V <- V G only columns p and q: the 4x4 products of rigid.py without their
// zero terms.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define EGONET_HD __host__ __device__ __forceinline__
#define EGONET_UNROLL _Pragma("unroll")
#else
#define EGONET_HD inline
#define EGONET_UNROLL
#endif

// 0-based (parent, child) corner of each of the 12 edges (constants.py,
// INTERP_DICT["bbox12"] less one): 4 along the height, 4 along the length,
// 4 along the width; and the interpolation coefficients
// (DEFAULT_INTERP_COEF).  Initialiser lists, so that device code holds them
// as its own constants.
#define EGONET_RIGID_EDGE_PARENT {0, 2, 4, 6, 0, 1, 2, 3, 0, 1, 4, 5}
#define EGONET_RIGID_EDGE_CHILD {1, 3, 5, 7, 4, 5, 6, 7, 2, 3, 6, 7}
#define EGONET_RIGID_INTERP_COEF {0.332f, 0.667f}
#define EGONET_RIGID_SWEEPS 6

namespace egonet {
namespace rigid {

// Point k of the template (k < 8 a corner, else the point interpolated at
// coefficient (k - 8) / 12 along edge (k - 8) % 12): p + coef * (c - p).
EGONET_HD void template_point(const float (&corner)[8][3], int k,
                              float (&x)[3]) {
  constexpr int parent[12] = EGONET_RIGID_EDGE_PARENT;
  constexpr int child[12] = EGONET_RIGID_EDGE_CHILD;
  constexpr float coef[2] = EGONET_RIGID_INTERP_COEF;
  if (k < 8) {
    for (int d = 0; d < 3; ++d) x[d] = corner[k][d];
    return;
  }
  const int e = (k - 8) % 12;
  const float a = coef[(k - 8) / 12];
  for (int d = 0; d < 3; ++d) {
    const float p = corner[parent[e]][d];
    x[d] = p + a * (corner[child[e]][d] - p);
  }
}

// One rotation of the (P, Q) plane: tau, t, c, s as _jacobi_eig4 forms
// them, then K <- G^T K G and V <- V G with G = I but G[P][P] = G[Q][Q] = c,
// G[P][Q] = s, G[Q][P] = -s.
template <int P, int Q>
EGONET_HD void jacobi_rotate(float (&k)[4][4], float (&v)[4][4]) {
  const float kpq = k[P][Q];
  const bool zero = kpq == 0.0f;
  const float tau = (k[Q][Q] - k[P][P]) / (2.0f * (zero ? 1.0f : kpq));
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  if (zero) t = 0.0f;
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = t * c;
  for (int i = 0; i < 4; ++i) {          // K G: columns P and Q
    const float a = k[i][P], b = k[i][Q];
    k[i][P] = c * a - s * b;
    k[i][Q] = s * a + c * b;
  }
  for (int j = 0; j < 4; ++j) {          // G^T (K G): rows P and Q
    const float a = k[P][j], b = k[Q][j];
    k[P][j] = c * a - s * b;
    k[Q][j] = s * a + c * b;
  }
  for (int i = 0; i < 4; ++i) {          // V G: columns P and Q
    const float a = v[i][P], b = v[i][Q];
    v[i][P] = c * a - s * b;
    v[i][Q] = s * a + c * b;
  }
}

}  // namespace rigid

// kpts: the crop's P x 3 points (row-major); out: its 6 numbers.
EGONET_HD void rigid_solve_one(const float* kpts, int p, float* out) {
  using rigid::jacobi_rotate;
  using rigid::template_point;
  constexpr int parent[12] = EGONET_RIGID_EDGE_PARENT;
  constexpr int child[12] = EGONET_RIGID_EDGE_CHILD;
  const float* y = p == 33 ? kpts + 3 : kpts;   // the 32-point cuboid

  // the template: mean edge length along each dimension
  float lines[12];
  EGONET_UNROLL
  for (int e = 0; e < 12; ++e) {
    const float dx = y[3 * parent[e]] - y[3 * child[e]];
    const float dy = y[3 * parent[e] + 1] - y[3 * child[e] + 1];
    const float dz = y[3 * parent[e] + 2] - y[3 * child[e] + 2];
    lines[e] = sqrtf(dx * dx + dy * dy + dz * dz);
  }
  const float h = (lines[0] + lines[1] + lines[2] + lines[3]) / 4.0f;
  const float l = (lines[4] + lines[5] + lines[6] + lines[7]) / 4.0f;
  const float w = (lines[8] + lines[9] + lines[10] + lines[11]) / 4.0f;
  float corner[8][3];
  for (int c = 0; c < 8; ++c) {
    corner[c][0] = (c < 4 ? l : 0.0f) - l / 2.0f;
    corner[c][1] = (c & 1 ? h : 0.0f) - h;
    corner[c][2] = (c & 2 ? 0.0f : w) - w / 2.0f;
  }

  // both centroids, then H = Xc Yc^T over the 32 points
  float mx[3] = {0.0f, 0.0f, 0.0f}, my[3] = {0.0f, 0.0f, 0.0f};
  EGONET_UNROLL
  for (int k = 0; k < 32; ++k) {
    float x[3];
    template_point(corner, k, x);
    for (int d = 0; d < 3; ++d) {
      mx[d] += x[d];
      my[d] += y[3 * k + d];
    }
  }
  for (int d = 0; d < 3; ++d) {
    mx[d] /= 32.0f;
    my[d] /= 32.0f;
  }
  float hm[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f},
                    {0.0f, 0.0f, 0.0f}};
  EGONET_UNROLL
  for (int k = 0; k < 32; ++k) {
    float x[3];
    template_point(corner, k, x);
    for (int i = 0; i < 3; ++i) {
      const float xc = x[i] - mx[i];
      for (int j = 0; j < 3; ++j) hm[i][j] += xc * (y[3 * k + j] - my[j]);
    }
  }

  // Horn's K: [[tr, d^T], [d, H + H^T - tr I]]
  const float tr = hm[0][0] + hm[1][1] + hm[2][2];
  const float d[3] = {hm[1][2] - hm[2][1], hm[2][0] - hm[0][2],
                      hm[0][1] - hm[1][0]};
  float k[4][4], v[4][4];
  k[0][0] = tr;
  for (int i = 0; i < 3; ++i) {
    k[0][i + 1] = d[i];
    k[i + 1][0] = d[i];
    for (int j = 0; j < 3; ++j) {
      const float s = hm[i][j] + hm[j][i];
      k[i + 1][j + 1] = i == j ? s - tr : s;
    }
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
  }
  for (int sweep = 0; sweep < EGONET_RIGID_SWEEPS; ++sweep) {
    jacobi_rotate<0, 1>(k, v);
    jacobi_rotate<0, 2>(k, v);
    jacobi_rotate<0, 3>(k, v);
    jacobi_rotate<1, 2>(k, v);
    jacobi_rotate<1, 3>(k, v);
    jacobi_rotate<2, 3>(k, v);
  }

  // the largest eigenvalue's vector (torch.argmax: NaN the largest, the
  // first index of a tie), normalised
  // (selects, not an index, so that device code keeps v in registers)
  int best = 0;
  float top = k[0][0];
  for (int i = 1; i < 4; ++i) {
    const float e = k[i][i];
    if (!(top != top) && (e > top || e != e)) {
      best = i;
      top = e;
    }
  }
  float q[4];
  for (int i = 0; i < 4; ++i) {
    q[i] = best == 0 ? v[i][0]
         : best == 1 ? v[i][1]
         : best == 2 ? v[i][2]
                     : v[i][3];
  }
  const float norm =
      sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] /= norm;
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];

  // the rotation's entries euler_yxz reads, then its angles
  const float r01 = 2.0f * (qx * qy - qw * qz);
  const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r20 = 2.0f * (qx * qz - qw * qy);
  const float r21 = 2.0f * (qy * qz + qw * qx);
  const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
  const float r21c = r21 < -1.0f ? -1.0f : (r21 > 1.0f ? 1.0f : r21);
  out[0] = asinf(r21c);              // rx: the 'x' angle of yxz
  out[1] = atan2f(-r20, r22);        // ry
  out[2] = atan2f(-r01, r11);        // rz
  for (int i = 0; i < 3; ++i) out[3 + i] = kpts[i];
}

}  // namespace egonet
