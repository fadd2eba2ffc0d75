// Host-side C++ triangle rasterizer (depth + optional vertex-color RGB).
//
// The port's copy of the JAX package's csrc/rasterizer.cpp (the same code,
// so both packages' native renders agree bit for bit): the host twin of the
// rasterizer (freepose_tpu_torch/ops/rasterizer.py and kernel K1), mirroring
// the external C++ bop_renderer the reference's eval can use (reference
// bop_toolkit/bop_toolkit_lib/renderer_cpp.py:12-66). The eval path runs on
// hosts with no GPU with the same conventions as the device path:
//   - OpenCV camera (x right, y down, z forward), pose = camera-from-object
//   - pixel centers at (i + 0.5, j + 0.5)
//   - no backface culling: coverage via edge functions on the sign of the
//     screen-space area, with the same 1e-5*|area| seam tolerance
//   - perspective-correct 1/z interpolation, znear clamp
//   - z-buffer keeps the LOWEST face index on exact depth ties (the plain
//     rasterizer's argmin semantics)
//   - RGB = barycentric vertex colors * ambient, clipped to [0, 1]
//   - depth = 0 and rgb = 0 where nothing is hit
//
// Built with g++ at first use by freepose_tpu_torch/ops/raster_native.py into
// freepose_tpu_torch/_build/, named by a hash of this file and the flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

namespace {

struct V2 {
  float x, y;
};

inline float edge_fn(const V2 &p, const V2 &q, float px, float py) {
  // cross(q - p, pix - p)
  return (q.x - p.x) * (py - p.y) - (q.y - p.y) * (px - p.x);
}

}  // namespace

extern "C" {

// Rasterize one mesh at one pose.
//   vertices  [n_vertices * 3] object-space float32
//   faces     [n_faces * 3]    int32 vertex indices
//   pose      [16]             row-major 4x4 camera-from-object
//   intr      [9]              row-major 3x3 K
//   colors    [n_vertices * 3] in [0,1], or nullptr for depth-only
//   out_depth [height * width] metres, 0 where empty (never nullptr)
//   out_rgb   [height * width * 3] in [0,1], or nullptr
void rasterize_mesh(const float *vertices, int32_t n_vertices,
                    const int32_t *faces, int32_t n_faces, const float *pose,
                    const float *intr, const float *colors, int32_t height,
                    int32_t width, float znear, float ambient,
                    float *out_depth, float *out_rgb) {
  const float fx = intr[0], cx = intr[2], fy = intr[4], cy = intr[5];

  // Project all vertices once.
  float *uvz = new float[static_cast<size_t>(n_vertices) * 3];
  for (int32_t i = 0; i < n_vertices; ++i) {
    const float *v = vertices + static_cast<size_t>(i) * 3;
    float x = pose[0] * v[0] + pose[1] * v[1] + pose[2] * v[2] + pose[3];
    float y = pose[4] * v[0] + pose[5] * v[1] + pose[6] * v[2] + pose[7];
    float z = pose[8] * v[0] + pose[9] * v[1] + pose[10] * v[2] + pose[11];
    float sz = std::fabs(z) < 1e-9f ? 1e-9f : z;
    uvz[i * 3 + 0] = fx * x / sz + cx;
    uvz[i * 3 + 1] = fy * y / sz + cy;
    uvz[i * 3 + 2] = z;
  }

  const size_t n_px = static_cast<size_t>(height) * width;
  // z-buffer in camera depth; +inf = empty. Best face kept implicitly by
  // looping faces in ascending index with a strict '<' test (first face
  // wins exact ties, like the XLA argmin).
  float *zbuf = out_depth;
  std::fill(zbuf, zbuf + n_px, std::numeric_limits<float>::infinity());
  if (out_rgb) std::fill(out_rgb, out_rgb + n_px * 3, 0.0f);

  for (int32_t f = 0; f < n_faces; ++f) {
    const int32_t ia = faces[f * 3 + 0], ib = faces[f * 3 + 1],
                  ic = faces[f * 3 + 2];
    const float za = uvz[ia * 3 + 2], zb = uvz[ib * 3 + 2],
                zc = uvz[ic * 3 + 2];
    if (!(za > znear && zb > znear && zc > znear)) continue;  // in_front
    const V2 a{uvz[ia * 3], uvz[ia * 3 + 1]};
    const V2 b{uvz[ib * 3], uvz[ib * 3 + 1]};
    const V2 c{uvz[ic * 3], uvz[ic * 3 + 1]};

    const float area =
        (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
    const float abs_area = std::fabs(area);
    if (abs_area <= 1e-12f) continue;
    const float s = area > 0.0f ? 1.0f : -1.0f;
    const float eps = 1e-5f * abs_area;
    const float inv_area = 1.0f / area;

    // Pixel-center bbox, clipped to the viewport.
    const float bb_min_x = std::min(a.x, std::min(b.x, c.x));
    const float bb_max_x = std::max(a.x, std::max(b.x, c.x));
    const float bb_min_y = std::min(a.y, std::min(b.y, c.y));
    const float bb_max_y = std::max(a.y, std::max(b.y, c.y));
    int32_t x0 = std::max<int32_t>(0, (int32_t)std::floor(bb_min_x - 0.5f));
    int32_t x1 = std::min<int32_t>(width - 1, (int32_t)std::ceil(bb_max_x));
    int32_t y0 = std::max<int32_t>(0, (int32_t)std::floor(bb_min_y - 0.5f));
    int32_t y1 = std::min<int32_t>(height - 1, (int32_t)std::ceil(bb_max_y));
    if (x0 > x1 || y0 > y1) continue;

    const float iza = 1.0f / std::max(za, znear);
    const float izb = 1.0f / std::max(zb, znear);
    const float izc = 1.0f / std::max(zc, znear);

    for (int32_t py = y0; py <= y1; ++py) {
      const float pyc = py + 0.5f;
      for (int32_t px = x0; px <= x1; ++px) {
        const float pxc = px + 0.5f;
        const float w0 = edge_fn(b, c, pxc, pyc);  // weight of vertex a
        const float w1 = edge_fn(c, a, pxc, pyc);
        const float w2 = edge_fn(a, b, pxc, pyc);
        if (w0 * s < -eps || w1 * s < -eps || w2 * s < -eps) continue;
        const float l0 = w0 * inv_area, l1 = w1 * inv_area,
                    l2 = w2 * inv_area;
        const float iz = l0 * iza + l1 * izb + l2 * izc;
        const float z = 1.0f / std::max(iz, 1e-12f);
        const size_t pi = static_cast<size_t>(py) * width + px;
        if (z < zbuf[pi]) {
          zbuf[pi] = z;
          if (out_rgb && colors) {
            const float *ca = colors + static_cast<size_t>(ia) * 3;
            const float *cb = colors + static_cast<size_t>(ib) * 3;
            const float *cc = colors + static_cast<size_t>(ic) * 3;
            for (int ch = 0; ch < 3; ++ch) {
              float col = (l0 * ca[ch] * iza + l1 * cb[ch] * izb +
                           l2 * cc[ch] * izc) *
                          z * ambient;
              out_rgb[pi * 3 + ch] = std::min(1.0f, std::max(0.0f, col));
            }
          }
        }
      }
    }
  }

  for (size_t i = 0; i < n_px; ++i) {
    if (!std::isfinite(zbuf[i])) zbuf[i] = 0.0f;
  }
  delete[] uvz;
}

// Batch over poses: poses [n_poses * 16]; out_depth [n_poses * H * W];
// out_rgb [n_poses * H * W * 3] or nullptr.
void rasterize_mesh_batch(const float *vertices, int32_t n_vertices,
                          const int32_t *faces, int32_t n_faces,
                          const float *poses, int32_t n_poses,
                          const float *intr, const float *colors,
                          int32_t height, int32_t width, float znear,
                          float ambient, float *out_depth, float *out_rgb) {
  const size_t n_px = static_cast<size_t>(height) * width;
  for (int32_t p = 0; p < n_poses; ++p) {
    rasterize_mesh(vertices, n_vertices, faces, n_faces,
                   poses + static_cast<size_t>(p) * 16, intr, colors, height,
                   width, znear, ambient, out_depth + n_px * p,
                   out_rgb ? out_rgb + n_px * 3 * p : nullptr);
  }
}

}  // extern "C"
