// EWA projection of 3D Gaussians on Hopper (sm_90a): one kernel for the
// forward of skyfall_gs_tpu_torch/ops/projection.py project_gaussians_torch,
// one for its backward, one thread per splat.
//
// It replaces no TPU kernel: the JAX package's projection
// (skyfall_gs_tpu/ops/projection.py project_gaussians) is plain XLA, and so
// was the port's, kept as the plain version.  It was added because the
// benchmark's trace showed that plain version taking 5.6-5.9 ms per view at
// one million splats (span render.project, a third of a 1080p viewer frame)
// while its work is a few hundred flops per splat: about 200 eager kernels
// in the forward and 350 in the autograd backward, each a pass over device
// memory, and two 1,000,000-batch cuBLAS products of 3x3 matrices
// (L L^T and R Sigma R^T) on 32x32 SIMT tiles.  The Python wrapper, the
// autograd Function and the routing rule live in ops/projection.py.
//
// What bounds it on this card: bytes.  Per splat the forward reads position,
// scale, quaternion, opacity and the alive flag (45 B) and writes mean2d,
// conic, depth, radius, opacity, compensation and radius_xy (44 B): 89 MB at
// 1M splats, 27 us at 3.35 TB/s, against ~200 flops a splat (3 us of fp32).
// The backward reads the same inputs and the cotangents of mean2d, conic,
// depth, opacity and compensation (77 B) and writes the gradients of the
// four inputs (44 B): 121 MB, 36 us.  The design:
//   * every intermediate (the rotation, L, Sigma, R Sigma R^T, the Jacobian,
//     the 2D covariance) lives in registers; nothing of size (N, 3, 3)
//     reaches device memory, and each output is written once;
//   * the backward saves nothing from the forward: it recomputes the
//     forward's intermediates from the inputs (a few hundred flops against
//     the 9 x 4 B per splat of an (N, 3, 3) product kept for it) and then
//     runs the chain rule back by hand;
//   * the camera (world_view, full_proj, centre, focal lengths, field of
//     view, principal point) is read from its device tensors into shared
//     memory once per block, so a call needs no host read of the camera;
//   * a warp's loads of (N, 3) and (N, 4) rows cover whole contiguous
//     ranges, so each sector is fetched once.
//
// Arithmetic: float32 throughout, in the plain version's order of operations
// (no fast-math: exact sqrt, log and division; nvcc contracts a product and
// a sum into one fma, as it does inside PyTorch's own kernels).  On a
// needle-like splat the 2D covariance's terms cancel and both versions lose
// digits to rounding; the tests bound the kernel's error per splat by the
// plain version's and by how far the exact result moves when the inputs
// move by one float32 ulp.  Its gradients follow autograd's conventions:
// clamp, clamp_min and clamp_max pass the gradient on the closed interval,
// each torch.where routes it to the branch taken, sqrt's derivative is
// g / (2 sqrt(x)), the quaternion's normalisation is differentiated (the
// norm's term is zero for a zero quaternion).  A culled splat's mean gets
// zero gradient (the projection sees a constant safe point in front of the
// camera); a kept splat's depth gradient goes through its true depth;
// radius and radius_xy carry none.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SKYFALL_HD __host__ __device__ __forceinline__

namespace {

constexpr int kThreads = 256;
constexpr float kNearZ = 0.2f;                    // ops/projection.py NEAR_CULL_Z
constexpr float kMaxScale = 1e4f;                 // scales past it overflow the determinants
constexpr float kAlphaEps = (float)(1.0 / 255.0);

// The camera as the kernels read it.
struct Cam {
  float wv[16];                   // world -> camera, row-major
  float proj[16];                 // world -> clip, row-major
  float center[3];                // camera centre in world space
  float fx, fy;                   // focal lengths, pixels
  float lo_x, hi_x, lo_y, hi_y;   // the EWA Jacobian's window on x/z and y/z
  float width, height, kernel_size, modifier;
};

// NaN-propagating clamps, as torch's.
SKYFALL_HD float min_of(float x, float hi) { return x > hi ? hi : x; }
SKYFALL_HD float max_of(float x, float lo) { return x < lo ? lo : x; }
SKYFALL_HD float clamp_to(float x, float lo, float hi) { return min_of(max_of(x, lo), hi); }

// One splat's forward: every value the outputs and the backward need.
struct Splat {
  bool keep;                      // alive and in front of the near plane
  float p[3];                     // the mean, or the safe point when culled
  float s[3];                     // the scale after the 1e4 clamp
  float qn, den, u[4];            // |q|, |q| + 1e-12, q / den (w, x, y, z)
  float r[9], l[9];               // rotation, L = R diag(modifier * s)
  float clip0, clip1, w;          // clip x, y and 1 / (clip w + 1e-7)
  float mx, my, depth;
  float t[3], tz, ux, uy, cux, cuy, inv_z, inv_z2;
  float j00, j02, j11, j12;       // the EWA Jacobian's non-zero entries
  float v00, v01, v02, v11, v12, v22;   // R_view Sigma R_view^T
  float c00, c01, c11, c00d, c11d;      // 2D covariance before / after dilation
  float det0, det1, d1c, ratio, comp, inv_det;
};

SKYFALL_HD float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

SKYFALL_HD void project_one(const Cam& c, const float m[3], const float s_raw[3],
                            const float q[4], bool alive, Splat& f) {
  const float* wv = c.wv;
  const float depth_true = dot3(m, wv + 8) + wv[11];
  f.keep = alive && depth_true > kNearZ;
  for (int i = 0; i < 3; ++i) {
    f.p[i] = f.keep ? m[i] : c.center[i] + wv[8 + i];
    f.s[i] = min_of(s_raw[i], kMaxScale);
  }
  // Sigma = L L^T, L = R(q / (|q| + 1e-12)) diag(modifier * s)
  f.qn = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
  f.den = f.qn + 1e-12f;
  for (int i = 0; i < 4; ++i) f.u[i] = q[i] / f.den;
  const float w = f.u[0], x = f.u[1], y = f.u[2], z = f.u[3];
  f.r[0] = 1.f - 2.f * (y * y + z * z);
  f.r[1] = 2.f * (x * y - w * z);
  f.r[2] = 2.f * (x * z + w * y);
  f.r[3] = 2.f * (x * y + w * z);
  f.r[4] = 1.f - 2.f * (x * x + z * z);
  f.r[5] = 2.f * (y * z - w * x);
  f.r[6] = 2.f * (x * z - w * y);
  f.r[7] = 2.f * (y * z + w * x);
  f.r[8] = 1.f - 2.f * (x * x + y * y);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) f.l[3 * i + j] = f.r[3 * i + j] * (c.modifier * f.s[j]);
  float sig[9];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) sig[3 * i + k] = dot3(f.l + 3 * i, f.l + 3 * k);

  // The perspective projection of the point.
  const float* pr = c.proj;
  f.clip0 = dot3(pr, f.p) + pr[3];
  f.clip1 = dot3(pr + 4, f.p) + pr[7];
  f.w = 1.f / ((dot3(pr + 12, f.p) + pr[15]) + 1e-7f);
  f.mx = ((f.clip0 * f.w + 1.f) * c.width - 1.f) * 0.5f;
  f.my = ((f.clip1 * f.w + 1.f) * c.height - 1.f) * 0.5f;
  f.depth = f.keep ? depth_true : dot3(f.p, wv + 8) + wv[11];

  // EWA: the view-space point, the frustum-clamped Jacobian, R Sigma R^T.
  for (int i = 0; i < 3; ++i) f.t[i] = dot3(wv + 4 * i, f.p) + wv[4 * i + 3];
  f.tz = max_of(f.t[2], 1e-6f);
  f.ux = f.t[0] / f.tz;
  f.uy = f.t[1] / f.tz;
  f.cux = clamp_to(f.ux, c.lo_x, c.hi_x);
  f.cuy = clamp_to(f.uy, c.lo_y, c.hi_y);
  const float tx = f.cux * f.tz, ty = f.cuy * f.tz;
  f.inv_z = 1.f / f.tz;
  f.inv_z2 = f.inv_z * f.inv_z;
  f.j00 = c.fx * f.inv_z;
  f.j02 = -c.fx * tx * f.inv_z2;
  f.j11 = c.fy * f.inv_z;
  f.j12 = -c.fy * ty * f.inv_z2;
  float a[9];                                      // R_view Sigma
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      a[3 * i + k] = (wv[4 * i] * sig[k] + wv[4 * i + 1] * sig[3 + k]) + wv[4 * i + 2] * sig[6 + k];
  const float* r0 = wv;
  const float* r1 = wv + 4;
  const float* r2 = wv + 8;
  f.v00 = dot3(a, r0);
  f.v01 = dot3(a, r1);
  f.v02 = dot3(a, r2);
  f.v11 = dot3(a + 3, r1);
  f.v12 = dot3(a + 3, r2);
  f.v22 = dot3(a + 6, r2);

  // The 2D covariance, its dilation and the opacity compensation: det0 of a
  // thin splat cancels to anywhere in [-eps, eps], so the sqrt is floored at
  // 1e-6 and the forward zeroed below it (bounded gradients).
  const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
  f.c00 = (j00 * j00 * f.v00 + 2.f * j00 * j02 * f.v02) + j02 * j02 * f.v22;
  f.c01 = ((j00 * j11 * f.v01 + j00 * j12 * f.v02) + j02 * j11 * f.v12) + j02 * j12 * f.v22;
  f.c11 = (j11 * j11 * f.v11 + 2.f * j11 * j12 * f.v12) + j12 * j12 * f.v22;
  f.det0 = f.c00 * f.c11 - f.c01 * f.c01;
  f.c00d = f.c00 + c.kernel_size;
  f.c11d = f.c11 + c.kernel_size;
  f.det1 = f.c00d * f.c11d - f.c01 * f.c01;
  f.d1c = max_of(f.det1, 1e-12f);
  f.ratio = f.det0 / f.d1c;
  f.comp = f.ratio > 1e-6f ? sqrtf(max_of(f.ratio, 1e-6f)) : 0.f;
  f.inv_det = 1.f / f.d1c;
}

// The screen radius and the alpha >= 1/255 cutoff AABB's half-extents of a
// splat of opacity op (0 where invisible or off screen).
SKYFALL_HD void radii(const Cam& c, const Splat& f, float op, int& radius, int& rx_out,
                      int& ry_out) {
  const float mid = 0.5f * (f.c00d + f.c11d);
  const float lam1 = mid + sqrtf(max_of(mid * mid - f.det1, 0.1f));
  const float op_eff = clamp_to(op * f.comp, 1e-12f, 1.f);
  const float log_term = max_of(2.f * logf(255.f * op_eff), 1e-6f);
  const float sm_exact = sqrtf(log_term);
  const float rad = ceilf(min_of(sm_exact, 3.f) * sqrtf(lam1));
  const float rx = ceilf(sm_exact * sqrtf(max_of(f.c00d, 0.f)) + 0.5f);
  const float ry = ceilf(sm_exact * sqrtf(max_of(f.c11d, 0.f)) + 0.5f);
  const bool visible = f.keep && f.det1 > 0.f && op_eff >= kAlphaEps && f.mx + rx >= 0.f &&
                       f.mx - rx < c.width && f.my + ry >= 0.f && f.my - ry < c.height;
  radius = visible ? (int)rad : 0;
  rx_out = visible ? (int)rx : 0;
  ry_out = visible ? (int)ry : 0;
}

// Cotangents of one splat's outputs.
struct Cotangent {
  float mx, my, ca, cb, cc, depth, opacity, comp;
};

// The gradients of one splat's means, scales, quaternion and opacity.
SKYFALL_HD void backward_one(const Cam& c, const Splat& f, const float s_raw[3],
                             const float q[4], float op, const Cotangent& g, float gm[3],
                             float gs[3], float gq[4], float& gop) {
  const float* wv = c.wv;
  // opacity = op * comp; comp = where(ratio > 1e-6, sqrt(clamp_min(ratio, 1e-6)), 0)
  gop = g.opacity * f.comp;
  const float g_comp = g.comp + g.opacity * op;
  const float g_ratio = f.ratio > 1e-6f ? g_comp / (2.f * f.comp) : 0.f;
  // ratio = det0 / d1c; conic = (c11d, -c01, c00d) * inv_det, inv_det = 1 / d1c;
  // d1c = clamp_min(det1, 1e-12)
  const float g_det0 = g_ratio / f.d1c;
  const float g_inv = (g.ca * f.c11d - g.cb * f.c01) + g.cc * f.c00d;
  const float g_d1c = -g_ratio * f.ratio / f.d1c - g_inv * f.inv_det * f.inv_det;
  const float g_det1 = f.det1 >= 1e-12f ? g_d1c : 0.f;
  // det1 = c00d c11d - c01^2, det0 = c00 c11 - c01^2, c00d = c00 + k, c11d = c11 + k
  const float g00 = (g.cc * f.inv_det + g_det1 * f.c11d) + g_det0 * f.c11;
  const float g11 = (g.ca * f.inv_det + g_det1 * f.c00d) + g_det0 * f.c00;
  const float g01 = (-g.cb * f.inv_det - 2.f * g_det1 * f.c01) - 2.f * g_det0 * f.c01;

  // The 2D covariance from the Jacobian and R Sigma R^T (its upper triangle).
  const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
  const float gv00 = g00 * j00 * j00;
  const float gv01 = g01 * j00 * j11;
  const float gv02 = 2.f * g00 * j00 * j02 + g01 * j00 * j12;
  const float gv11 = g11 * j11 * j11;
  const float gv12 = g01 * j02 * j11 + 2.f * g11 * j11 * j12;
  const float gv22 = (g00 * j02 * j02 + g01 * j02 * j12) + g11 * j12 * j12;
  const float gj00 =
      g00 * (2.f * j00 * f.v00 + 2.f * j02 * f.v02) + g01 * (j11 * f.v01 + j12 * f.v02);
  const float gj02 =
      g00 * (2.f * j00 * f.v02 + 2.f * j02 * f.v22) + g01 * (j11 * f.v12 + j12 * f.v22);
  const float gj11 =
      g01 * (j00 * f.v01 + j02 * f.v12) + g11 * (2.f * j11 * f.v11 + 2.f * j12 * f.v12);
  const float gj12 =
      g01 * (j00 * f.v02 + j02 * f.v22) + g11 * (2.f * j11 * f.v12 + 2.f * j12 * f.v22);

  // The Jacobian from the view-space point: j00 = fx / tz, j02 = -fx tx / tz^2,
  // tx = clamp(t0 / tz, lo, hi) tz (and y alike), tz = clamp_min(t2, 1e-6).
  const float tx = f.cux * f.tz, ty = f.cuy * f.tz;
  const float g_tx = gj02 * -c.fx * f.inv_z2;
  const float g_ty = gj12 * -c.fy * f.inv_z2;
  const float g_inv_z2 = gj02 * (-c.fx * tx) + gj12 * (-c.fy * ty);
  const float g_inv_z = (gj00 * c.fx + gj11 * c.fy) + 2.f * f.inv_z * g_inv_z2;
  const float g_ux = f.ux >= c.lo_x && f.ux <= c.hi_x ? g_tx * f.tz : 0.f;
  const float g_uy = f.uy >= c.lo_y && f.uy <= c.hi_y ? g_ty * f.tz : 0.f;
  const float g_tz = ((-g_inv_z * f.inv_z * f.inv_z + g_tx * f.cux) + g_ty * f.cuy) -
                     (g_ux * f.ux + g_uy * f.uy) / f.tz;
  const float g_t[3] = {g_ux / f.tz, g_uy / f.tz, f.t[2] >= 1e-6f ? g_tz : 0.f};

  // The mean: t = R_view p + t_view, the pixel coordinates from the clip
  // coordinates, the true depth; a culled splat's p is a constant.
  const float* pr = c.proj;
  const float g_ndx = g.mx * 0.5f * c.width;
  const float g_ndy = g.my * 0.5f * c.height;
  const float g_c0 = g_ndx * f.w, g_c1 = g_ndy * f.w;
  const float g_c3 = -(g_ndx * f.clip0 + g_ndy * f.clip1) * f.w * f.w;
  for (int j = 0; j < 3; ++j) {
    const float g_p = ((wv[j] * g_t[0] + wv[4 + j] * g_t[1]) + wv[8 + j] * g_t[2]) +
                      ((pr[j] * g_c0 + pr[4 + j] * g_c1) + pr[12 + j] * g_c3);
    gm[j] = f.keep ? g_p + wv[8 + j] * g.depth : 0.f;
  }

  // Sigma from V = R_view Sigma R_view^T: the gradient of Sigma plus its
  // transpose is T = R_view^T (G + G^T) R_view, G the upper-triangular
  // gradient of V; Sigma = L L^T gives g_L = T L.
  const float sym[9] = {2.f * gv00, gv01, gv02, gv01, 2.f * gv11, gv12, gv02, gv12, 2.f * gv22};
  float b[9];                                      // (G + G^T) R_view
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      b[3 * i + k] = (sym[3 * i] * wv[k] + sym[3 * i + 1] * wv[4 + k]) + sym[3 * i + 2] * wv[8 + k];
  float tm[9];  // R_view^T (G + G^T) R_view: symmetric, its upper triangle mirrored
  for (int i = 0; i < 3; ++i)
    for (int k = i; k < 3; ++k) {
      tm[3 * i + k] = (wv[i] * b[k] + wv[4 + i] * b[3 + k]) + wv[8 + i] * b[6 + k];
      tm[3 * k + i] = tm[3 * i + k];
    }
  float gr[9];
  for (int j = 0; j < 3; ++j) {
    const float sm = c.modifier * f.s[j];
    float g_sm = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float gl =
          (tm[3 * i] * f.l[j] + tm[3 * i + 1] * f.l[3 + j]) + tm[3 * i + 2] * f.l[6 + j];
      gr[3 * i + j] = gl * sm;
      g_sm += gl * f.r[3 * i + j];
    }
    gs[j] = s_raw[j] <= kMaxScale ? c.modifier * g_sm : 0.f;
  }

  // The rotation from the unit quaternion, the quaternion's normalisation.
  const float w = f.u[0], x = f.u[1], y = f.u[2], z = f.u[3];
  float gu[4];
  gu[0] = 2.f * (((-z * gr[1] + y * gr[2]) + (z * gr[3] - x * gr[5])) + (-y * gr[6] + x * gr[7]));
  gu[1] = 2.f * (((y * gr[1] + z * gr[2]) + (y * gr[3] - w * gr[5])) + (z * gr[6] + w * gr[7])) -
          4.f * x * (gr[4] + gr[8]);
  gu[2] = 2.f * (((x * gr[1] + w * gr[2]) + (x * gr[3] + z * gr[5])) + (-w * gr[6] + z * gr[7])) -
          4.f * y * (gr[0] + gr[8]);
  gu[3] = 2.f * (((-w * gr[1] + x * gr[2]) + (w * gr[3] + y * gr[5])) + (x * gr[6] + y * gr[7])) -
          4.f * z * (gr[0] + gr[4]);
  const float g_den = -(((gu[0] * q[0] + gu[1] * q[1]) + gu[2] * q[2]) + gu[3] * q[3]) /
                      (f.den * f.den);
  const float g_norm = f.qn > 0.f ? g_den / f.qn : 0.f;
  for (int i = 0; i < 4; ++i) gq[i] = gu[i] / f.den + g_norm * q[i];
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Camera tensors on the device; the window, when the camera fixes one.
struct CamArgs {
  const float* wv;
  const float* proj;
  const float* center;
  const float* scalars[6];        // fx, fy, tan_fovx, tan_fovy, cx, cy (0-d tensors)
  int has_window;
  float window[4];
  float frustum_clamp;
  float width, height, kernel_size, modifier;
};

__device__ __forceinline__ void load_camera(const CamArgs& a, Cam& c) {
  __shared__ float s[41];
  const int t = threadIdx.x;
  if (t < 16) {
    s[t] = a.wv[t];
    s[16 + t] = a.proj[t];
  } else if (t < 19) {
    s[32 + t - 16] = a.center[t - 16];
  } else if (t == 19) {           // constant indices: a runtime index into the
    for (int k = 0; k < 6; ++k)   // by-value arguments would copy them to local memory
      s[35 + k] = *a.scalars[k];
  }
  __syncthreads();
  for (int i = 0; i < 16; ++i) {
    c.wv[i] = s[i];
    c.proj[i] = s[16 + i];
  }
  for (int i = 0; i < 3; ++i) c.center[i] = s[32 + i];
  c.fx = s[35];
  c.fy = s[36];
  if (a.has_window) {
    c.lo_x = a.window[0];
    c.hi_x = a.window[1];
    c.lo_y = a.window[2];
    c.hi_y = a.window[3];
  } else {                        // core/camera.py clamp_window
    const float tan_x = s[37], tan_y = s[38], cx = s[39], cy = s[40], m = a.frustum_clamp;
    c.lo_x = tan_x * (-m - cx);
    c.hi_x = tan_x * (m - cx);
    c.lo_y = tan_y * (-m - cy);
    c.hi_y = tan_y * (m - cy);
  }
  c.width = a.width;
  c.height = a.height;
  c.kernel_size = a.kernel_size;
  c.modifier = a.modifier;
}

__device__ __forceinline__ void load_splat(int i, const float* means, const float* scales,
                                           const float* quats, float m[3], float s[3],
                                           float q[4]) {
  for (int k = 0; k < 3; ++k) {
    m[k] = means[3 * i + k];
    s[k] = scales[3 * i + k];
  }
  const float4 qv = reinterpret_cast<const float4*>(quats)[i];
  q[0] = qv.x;
  q[1] = qv.y;
  q[2] = qv.z;
  q[3] = qv.w;
}

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(CamArgs args, int n, const float* __restrict__ means,
                   const float* __restrict__ scales, const float* __restrict__ quats,
                   const float* __restrict__ opacities, const bool* __restrict__ alive,
                   float2* __restrict__ mean2d, float* __restrict__ conic,
                   float* __restrict__ depth, int* __restrict__ radius,
                   float* __restrict__ opacity_out, float* __restrict__ comp_out,
                   int2* __restrict__ radius_xy) {
  Cam c;
  load_camera(args, c);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float m[3], s[3], q[4];
  load_splat(i, means, scales, quats, m, s, q);
  const float op = opacities[i];
  Splat f;
  project_one(c, m, s, q, alive == nullptr || alive[i], f);
  int rad, rx, ry;
  radii(c, f, op, rad, rx, ry);
  mean2d[i] = make_float2(f.mx, f.my);
  conic[3 * i] = f.c11d * f.inv_det;
  conic[3 * i + 1] = -f.c01 * f.inv_det;
  conic[3 * i + 2] = f.c00d * f.inv_det;
  depth[i] = f.depth;
  radius[i] = rad;
  opacity_out[i] = op * f.comp;
  comp_out[i] = f.comp;
  radius_xy[i] = make_int2(rx, ry);
}

// A cotangent: a pointer (null: zero) and the stride of its rows, elements.
struct Grad {
  const float* p;
  long long stride;
};

__device__ __forceinline__ float at(const Grad& g, int i, int k) {
  return g.p == nullptr ? 0.f : g.p[(long long)i * g.stride + k];
}

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(CamArgs args, int n, const float* __restrict__ means,
                   const float* __restrict__ scales, const float* __restrict__ quats,
                   const float* __restrict__ opacities, const bool* __restrict__ alive,
                   Grad g_mean2d, Grad g_conic, Grad g_depth, Grad g_opacity, Grad g_comp,
                   float* __restrict__ g_means, float* __restrict__ g_scales,
                   float* __restrict__ g_quats, float* __restrict__ g_opacities) {
  Cam c;
  load_camera(args, c);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float m[3], s[3], q[4];
  load_splat(i, means, scales, quats, m, s, q);
  const float op = opacities[i];
  Splat f;
  project_one(c, m, s, q, alive == nullptr || alive[i], f);
  Cotangent g;
  g.mx = at(g_mean2d, i, 0);
  g.my = at(g_mean2d, i, 1);
  g.ca = at(g_conic, i, 0);
  g.cb = at(g_conic, i, 1);
  g.cc = at(g_conic, i, 2);
  g.depth = at(g_depth, i, 0);
  g.opacity = at(g_opacity, i, 0);
  g.comp = at(g_comp, i, 0);
  float gm[3], gs[3], gq[4], gop;
  backward_one(c, f, s, q, op, g, gm, gs, gq, gop);
  for (int k = 0; k < 3; ++k) {
    g_means[3 * i + k] = gm[k];
    g_scales[3 * i + k] = gs[k];
  }
  reinterpret_cast<float4*>(g_quats)[i] = make_float4(gq[0], gq[1], gq[2], gq[3]);
  g_opacities[i] = gop;
}

CamArgs camera_args(const float* wv, const float* proj, const float* center, const float* fx,
                    const float* fy, const float* tan_fovx, const float* tan_fovy,
                    const float* cx, const float* cy, int has_window, float lo_x, float hi_x,
                    float lo_y, float hi_y, float frustum_clamp, float width, float height,
                    float kernel_size, float modifier) {
  CamArgs a;
  a.wv = wv;
  a.proj = proj;
  a.center = center;
  const float* scalars[6] = {fx, fy, tan_fovx, tan_fovy, cx, cy};
  for (int k = 0; k < 6; ++k) a.scalars[k] = scalars[k];
  a.has_window = has_window;
  a.window[0] = lo_x;
  a.window[1] = hi_x;
  a.window[2] = lo_y;
  a.window[3] = hi_y;
  a.frustum_clamp = frustum_clamp;
  a.width = width;
  a.height = height;
  a.kernel_size = kernel_size;
  a.modifier = modifier;
  return a;
}

}  // namespace

// The camera arguments of both entry points: world_view (4, 4), full_proj
// (4, 4), cam_center (3,) and six 0-d tensors, all float32 on the device;
// has_window with the window (lo_x, hi_x, lo_y, hi_y) when the camera fixes
// one, else the window is frustum_clamp times the field of view about the
// principal point; the image size, the dilation and the scale modifier.
#define SKYFALL_CAMERA_PARAMS                                                               \
  const float *wv, const float *proj, const float *center, const float *fx, const float *fy, \
      const float *tan_fovx, const float *tan_fovy, const float *cx, const float *cy,       \
      int has_window, float lo_x, float hi_x, float lo_y, float hi_y, float frustum_clamp,  \
      float width, float height, float kernel_size, float modifier
#define SKYFALL_CAMERA_ARGS                                                                   \
  camera_args(wv, proj, center, fx, fy, tan_fovx, tan_fovy, cx, cy, has_window, lo_x, hi_x, \
              lo_y, hi_y, frustum_clamp, width, height, kernel_size, modifier)

// Inputs: means (N, 3), scales (N, 3), quats (N, 4) 16-byte aligned,
// opacities (N,), alive (N,) bool or null; all contiguous.  Outputs:
// mean2d (N, 2), conic (N, 3), depth, radius (int32), opacity,
// compensation (N,), radius_xy (N, 2) int32.  Returns the launch's
// cudaError_t.
extern "C" int skyfall_project_fwd(SKYFALL_CAMERA_PARAMS, int n, const float* means,
                                   const float* scales, const float* quats,
                                   const float* opacities, const bool* alive, float* mean2d,
                                   float* conic, float* depth, int* radius, float* opacity_out,
                                   float* comp_out, int* radius_xy, void* stream) {
  if (n <= 0) return 0;
  project_fwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      SKYFALL_CAMERA_ARGS, n, means, scales, quats, opacities, alive,
      reinterpret_cast<float2*>(mean2d), conic, depth, radius, opacity_out, comp_out,
      reinterpret_cast<int2*>(radius_xy));
  return (int)cudaGetLastError();
}

// The same inputs, the cotangents of mean2d (N, 2), conic (N, 3), depth,
// opacity and compensation (N,), each null (zero) or with unit stride
// within a row and the given row stride; writes the gradients of means
// (N, 3), scales (N, 3), quats (N, 4) 16-byte aligned and opacities (N,).
extern "C" int skyfall_project_bwd(SKYFALL_CAMERA_PARAMS, int n, const float* means,
                                   const float* scales, const float* quats,
                                   const float* opacities, const bool* alive,
                                   const float* g_mean2d, long long s_mean2d,
                                   const float* g_conic, long long s_conic,
                                   const float* g_depth, long long s_depth,
                                   const float* g_opacity, long long s_opacity,
                                   const float* g_comp, long long s_comp, float* g_means,
                                   float* g_scales, float* g_quats, float* g_opacities,
                                   void* stream) {
  if (n <= 0) return 0;
  project_bwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      SKYFALL_CAMERA_ARGS, n, means, scales, quats, opacities, alive,
      Grad{g_mean2d, s_mean2d}, Grad{g_conic, s_conic}, Grad{g_depth, s_depth},
      Grad{g_opacity, s_opacity}, Grad{g_comp, s_comp}, g_means, g_scales, g_quats,
      g_opacities);
  return (int)cudaGetLastError();
}
