// Native LBVH construction — the host-side analogue of the reference's
// acceleration-structure build driver (src/acceleration_structures.rs),
// which records BLAS/TLAS builds for the GPU's ray-tracing hardware. Here
// the build runs on the host CPU; this C++ implementation replaces the
// interpreted Python loop in ops/bvh.py for large scenes (~100x faster).
//
// Exposed via a plain C ABI and loaded with ctypes (no pybind11 in this
// toolchain). All arrays are caller-allocated.
//
// Layout contract (must match ops/bvh.py BVH / wide_layout): leaf rows
// sorted by Morton code, implicit 8-ary levels folded bottom-up, one
// [8 * 6]-float row of child AABBs per internal node, coarsest level last.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Morton-encode [n,3] normalised centroids -> 30-bit codes.
void trtpu_morton3(int64_t n, const float* xyz, uint32_t* codes) {
  auto expand = [](uint32_t v) {
    v = (v | (v << 16)) & 0x030000FFu;
    v = (v | (v << 8)) & 0x0300F00Fu;
    v = (v | (v << 4)) & 0x030C30C3u;
    v = (v | (v << 2)) & 0x09249249u;
    return v;
  };
  for (int64_t i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int k = 0; k < 3; ++k) {
      float f = xyz[i * 3 + k] * 1024.0f;
      if (f < 0.0f) f = 0.0f;
      if (f > 1023.0f) f = 1023.0f;
      q[k] = (uint32_t)f;
    }
    codes[i] = (expand(q[0]) << 2) | (expand(q[1]) << 1) | expand(q[2]);
  }
}

// 8-ary bottom-up AABB fold over leaf-row AABBs — builds every internal
// level of the implicit wide BVH (layout contract: ops/bvh.py
// wide_layout / BVH docstring).
//   n_leaves: number of leaf rows, >= 1
//   leaf_min: [n_leaves, 3] f32 (Morton-sorted leaf-row AABBs)
//   leaf_max: [n_leaves, 3] f32
//   boxes:    [sum(level counts), 8*6] f32 out — level-k node i's row
//             holds its children's (min3, max3) per child slot; unused
//             slots hold inverted boxes (+inf/-inf).
void trtpu_wide_fold(int64_t n_leaves, const float* leaf_min,
                     const float* leaf_max, float* boxes) {
  const float kInf = std::numeric_limits<float>::infinity();
  std::vector<float> cmin(leaf_min, leaf_min + n_leaves * 3);
  std::vector<float> cmax(leaf_max, leaf_max + n_leaves * 3);
  int64_t n = n_leaves;
  float* out = boxes;
  for (;;) {
    const int64_t m = (n + 7) / 8;
    std::vector<float> nmin(m * 3), nmax(m * 3);
    for (int64_t i = 0; i < m; ++i) {
      float fmin[3] = {kInf, kInf, kInf};
      float fmax[3] = {-kInf, -kInf, -kInf};
      for (int64_t j = 0; j < 8; ++j) {
        const int64_t c = i * 8 + j;
        float* row = out + (i * 8 + j) * 6;
        if (c < n) {
          for (int k = 0; k < 3; ++k) {
            row[k] = cmin[c * 3 + k];
            row[3 + k] = cmax[c * 3 + k];
            fmin[k] = std::min(fmin[k], row[k]);
            fmax[k] = std::max(fmax[k], row[3 + k]);
          }
        } else {
          for (int k = 0; k < 3; ++k) {
            row[k] = kInf;
            row[3 + k] = -kInf;
          }
        }
      }
      for (int k = 0; k < 3; ++k) {
        nmin[i * 3 + k] = fmin[k];
        nmax[i * 3 + k] = fmax[k];
      }
    }
    out += m * 8 * 6;
    cmin.swap(nmin);
    cmax.swap(nmax);
    n = m;
    if (m == 1) break;
  }
}

// World-space Similarity transform of gathered vertices:
//   out[i] = trans[i] + scale[i] * rotate(quat[i] (xyzw), pos[i])
void trtpu_transform_points(int64_t n, const float* pos, const float* trans,
                            const float* scale, const float* quat,
                            float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pos + i * 3;
    const float* q = quat + i * 4;
    // t = 2 * cross(q.xyz, p); r = p + q.w * t + cross(q.xyz, t)
    float tx = 2.0f * (q[1] * p[2] - q[2] * p[1]);
    float ty = 2.0f * (q[2] * p[0] - q[0] * p[2]);
    float tz = 2.0f * (q[0] * p[1] - q[1] * p[0]);
    float rx = p[0] + q[3] * tx + (q[1] * tz - q[2] * ty);
    float ry = p[1] + q[3] * ty + (q[2] * tx - q[0] * tz);
    float rz = p[2] + q[3] * tz + (q[0] * ty - q[1] * tx);
    out[i * 3 + 0] = trans[i * 3 + 0] + scale[i] * rx;
    out[i * 3 + 1] = trans[i * 3 + 1] + scale[i] * ry;
    out[i * 3 + 2] = trans[i * 3 + 2] + scale[i] * rz;
  }
}

}  // extern "C"
