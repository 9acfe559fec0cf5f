// Tile compositing kernels for Hopper (sm_90a): forward and backward.
//
// Replace the two Pallas TPU kernels of skyfall_gs_tpu/ops/rasterize_tiled.py:
//   skyfall_composite_fwd  <- _fwd_kernel (pl.pallas_call in _fwd_call)
//   skyfall_composite_bwd  <- _bwd_kernel (pl.pallas_call in _bwd_call)
// The Python wrappers, their plain PyTorch versions and the layout contract
// live in skyfall_gs_tpu_torch/ops/rasterize_tiled.py.
//
// Work unit: one 16x16 pixel tile = one thread block of 256 threads, one
// thread per pixel; warp w holds the 16x2 pixel strip of rows 2w, 2w+1.  A
// tile's entries are the depth-sorted run [tile_start, tile_start +
// tile_count) of the binned entry stream; entry e reads row gather_idx[e] of
// the per-gaussian attribute table (N+1, 16):
//   cols 0..6 channels, 7 zero pad, 8 mx, 9 my, 10..12 conic a b c,
//   13 opacity, 14..15 AbsGS dummies (never read; the backward keeps 1/op
//   in column 14 of its staged copy).
// The backward adds every entry's gradient row into the per-gaussian
// gradient table (N+1, 16), zero-filled by the caller.
//
// What bounds them.  Both are ALU-bound: per (entry, pixel) pair ~11 flops
// to reach the alpha test, per passing pair ~18 more in the forward and ~72
// in the backward, against ~21 / ~37 MB of bytes.  At the bench shape
// (512 px, 100k splats, ~540k entries in 1,024 tiles) the tiles walk ~310k
// entries under the block exit: ~52M pixel pairs, of which ~12.6M pass the
// alpha test, in ~2.0M warp-entry slots, of which only ~0.85M hold a
// passing pair.  So the work that cannot contribute dominates, and the
// design removes it; the backward is then bound by its per-slot
// instruction count (shuffles, the recomputed forward) and the forward by
// the blend's separately rounded multiply-adds.
//
//   * Strip cull.  When a batch is staged, one thread per entry computes an
//     8-bit mask of the warp strips that the entry's alpha >= 1/255 ellipse
//     can reach (strip_mask): the ellipse q(dx, dy) <= k, k = 2 ln(255 op),
//     has half-extents sqrt(k c / det) and sqrt(k a / det) (det = a c - b^2),
//     tested against each strip's box of actual pixel centres (offsets
//     included).  k carries a margin for the float error of the kernels'
//     power (relative to the conic's condition a c / det) and the extents
//     one of x1.001 + 0.01 px, so no pair that passes the alpha test is
//     dropped; op < 1/255 reaches no strip, a conic that is not positive
//     definite or not finite reaches every strip.  Each warp compacts the
//     batch's entries that reach its strip into a list (ballot + popc) and
//     walks only those.  The output cannot change: only pairs that the
//     alpha test rejects are skipped.  It drops ~47% of the walked
//     warp-slots at the bench shape.
//   * Staging.  Rows (and their gather indices, for the backward's atomics)
//     arrive by cp.async in 128-entry batches, double-buffered: batch b+1
//     loads while batch b is composited, and the gather indices of batch
//     b+2 are loaded into registers meanwhile.  Two barriers per batch: one
//     after the copy lands, one that publishes the masks and takes the
//     block-wide early-exit vote (__syncthreads_or).  All 256 threads stage:
//     a separate staging warp cost more in occupancy than it hid.
//   * Backward reduction.  The 16 per-pixel terms (15 and a zero pad) are
//     summed over the warp by a transposed butterfly: at xor 16, 8, 4, 2 a
//     lane keeps half of its values and adds its partner's copy of them,
//     then xor 1 adds the pair: 8+4+2+1+1 = 16 shuffles per warp-slot with
//     a passing lane (the row-by-row reduction needs 75), after which lane
//     l holds column (l >> 1) of the warp sum, scaled (-1/2, -1, -1/2 for
//     the conic, 1/op for the opacity, staged once per entry).
//   * Backward accumulation.  Three more shuffles gather columns 4m..4m+3
//     into lane 8m, and four lanes add the warp's row into the gaussian's
//     row of the gradient table with 16-byte atomics (atomicAdd on float4,
//     sm_90), skipping zero quads.  A block sum per entry in shared memory
//     followed by four atomics per entry was slower.  No per-entry buffer
//     leaves the kernel.  Per-gaussian sums therefore come out in atomic
//     order, which differs from run to run (last-bit differences: the
//     backward is not deterministic).
//
// Arithmetic on the thresholded path (power, alpha, transmittance, blend
// weights) uses explicit round-to-nearest intrinsics in the same operation
// order as the plain PyTorch version, so no fused multiply-add can move an
// alpha >= 1/255 or T >= 1e-4 decision away from it: the forward equals its
// plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels per tile = threads per block
constexpr int kWarps = kPix / 32;
constexpr int kNA = 16;              // attribute / gradient columns per entry
constexpr int kNCh = 7;              // blended channels
constexpr int kBatch = 128;          // entries per staged batch, a multiple of 64
// Resident blocks per SM that ptxas must allow (40 and 48 registers, no
// spills): on the H100 these beat 4 or 8 blocks for the forward and 4 or
// 6 for the backward (PERF.md).
constexpr int kFwdMinBlocks = 6;
constexpr int kBwdMinBlocks = 5;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAllStrips = (1u << kWarps) - 1u;

// The thresholds as the plain version sees them: Python doubles cast to f32.
constexpr float kAlphaEps = (float)(1.0 / 255.0);
constexpr float kAlphaMax = (float)0.99;
constexpr float kTEps = (float)1e-4;

// Strip-cull margins (mirrored by strip_mask_torch in rasterize_tiled.py):
// k' = k (1 + kMarginRel + kMarginCond * a c / det) + kMarginAbs, then each
// half-extent x kExtentRel + kExtentAbs pixels.
constexpr float kMarginRel = 1e-4f;
constexpr float kMarginCond = 4e-6f;  // ~64 float32 ulps per unit of condition
constexpr float kMarginAbs = 1e-5f;
constexpr float kExtentRel = 1.001f;
constexpr float kExtentAbs = 0.01f;

struct Stage {
  float4 rows[2][kBatch][kNA / 4];     // attribute rows of batches b and b+1
  int gid[2][kBatch];                  // their gather indices (the backward's atomics)
  unsigned mask[kBatch];               // strips each entry of batch b reaches
  unsigned char list[kWarps][kBatch];  // per warp: the entries of batch b reaching its strip
  float4 strip[kWarps];                // per warp: x min, x max, y min, y max of its pixel centres
};

__device__ __forceinline__ float2 pixel_center(int t, int p, int tiles_x,
                                               const float* offx, const float* offy) {
  // Integer pixel coordinates plus the subpixel offset (no +0.5).
  const float x = (float)((t % tiles_x) * kTile + p % kTile);
  const float y = (float)((t / tiles_x) * kTile + p / kTile);
  const size_t i = (size_t)t * kPix + p;
  return make_float2(__fadd_rn(x, offx[i]), __fadd_rn(y, offy[i]));
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, b the conic's off-diagonal.
__device__ __forceinline__ float gauss_power(const float* r, float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(r[10], dx), dx),
                            __fmul_rn(__fmul_rn(r[12], dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(r[11], dx), dy));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void strip_bounds(float4* strip, float2 pc, int lane, int warp) {
  float x0 = pc.x, x1 = pc.x, y0 = pc.y, y1 = pc.y;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFull, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(kFull, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, o));
  }
  if (lane == 0) strip[warp] = make_float4(x0, x1, y0, y1);
}

// The warp strips an entry's alpha >= 1/255 ellipse can reach.
__device__ __forceinline__ unsigned strip_mask(const float* r, const float4* strip) {
  const float mx = r[8], my = r[9], a = r[10], b = r[11], c = r[12], op = r[13];
  if (op < kAlphaEps) return 0u;  // alpha <= op < 1/255 everywhere
  // Products of floats are exact in double: det has one rounding.
  const float det = (float)((double)a * (double)c - (double)b * (double)b);
  if (!(a > 0.0f && c > 0.0f && det > 0.0f) || !isfinite(a * c) || !isfinite(op) ||
      !isfinite(mx) || !isfinite(my)) {
    return kAllStrips;
  }
  // __logf's error (< 2^-21 absolute near 1) and the reciprocal's rounding
  // lie far inside the margins.
  const float k = fmaxf(2.0f * __logf(255.0f * op), 0.0f);
  const float rdet = __frcp_rn(det);
  const float km = k * (1.0f + kMarginRel + kMarginCond * (a * c * rdet)) + kMarginAbs;
  const float ex = sqrtf(km * c * rdet) * kExtentRel + kExtentAbs;
  const float ey = sqrtf(km * a * rdet) * kExtentRel + kExtentAbs;
  if (!(isfinite(ex) && isfinite(ey))) return kAllStrips;
  unsigned m = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float4 s = strip[w];
    if (s.x - mx <= ex && mx - s.y <= ex && s.z - my <= ey && my - s.w <= ey) m |= 1u << w;
  }
  return m;
}

// Staging.  Thread p copies quarter (p & 3) of rows (p >> 2) + 64 i of every
// batch with cp.async, one batch ahead of the batch being composited, and
// loads the gather indices one batch further ahead into registers.  After
// a batch has landed, thread p < batch size computes row p's strip mask.
struct Stager {
  static constexpr int kPer = kBatch / 64;  // rows per thread quarter
  const float* table;
  const int64_t* gidx;
  int start, cnt, p;
  int g[kPer];  // gather indices of the next batch to issue

  __device__ __forceinline__ void load(int base) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      g[i] = (int)gidx[start + min(base + (p >> 2) + 64 * i, cnt - 1)];  // clamped: never stalls here
    }
  }
  __device__ __forceinline__ void issue(Stage& st, int b, int base) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = (p >> 2) + 64 * i;
      if (base + row < cnt) {
        cp_async16(&st.rows[b & 1][row][p & 3], table + (size_t)g[i] * kNA + 4 * (p & 3));
        if ((p & 3) == 0) st.gid[b & 1][row] = g[i];
      }
    }
    cp_async_commit();
  }
  // First half of the top of the loop for batch b: wait until it has landed
  // and every warp is done with batch b-1.
  __device__ __forceinline__ void land() const {
    cp_async_wait_all();
    __syncthreads();
  }
  // Second half: start batch b+1, publish batch b's masks (and, for the
  // backward, 1/op in the row's unused AbsGS column 14) and take the
  // early-exit vote.  Returns false once no pixel of the tile can take
  // another contribution.
  __device__ __forceinline__ bool advance(Stage& st, int b, int base, bool done, bool inv_op) {
    issue(st, b + 1, base + kBatch);
    load(base + 2 * kBatch);
    if (p < min(kBatch, cnt - base)) {
      float* r = reinterpret_cast<float*>(st.rows[b & 1][p]);
      st.mask[p] = strip_mask(r, st.strip);
      if (inv_op) r[14] = r[13] > 0.0f ? 1.0f / r[13] : 0.0f;
    }
    return __syncthreads_or(!done);
  }
};

// Compacts this warp's entries of the batch (those reaching its strip) into
// st.list[warp], in order; returns their count.
__device__ __forceinline__ int warp_list(Stage& st, int nb, int lane, int warp) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < kBatch; k += 32) {
    const bool mine = k + lane < nb && ((st.mask[k + lane] >> warp) & 1u);
    const unsigned ballot = __ballot_sync(kFull, mine);
    if (mine) st.list[warp][n + __popc(ballot & ((1u << lane) - 1u))] = (unsigned char)(k + lane);
    n += __popc(ballot);
  }
  __syncwarp();
  return n;
}

// One halving step of the transposed warp sum: a lane keeps the half of
// its kHalf*2 values selected by lane bit 2*kHalf and adds its partner's
// copy of that half.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[kNA], int lane) {
  const bool up = (lane & (2 * kHalf)) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// Transposed warp sum of 16 values in 8+4+2+1+1 = 16 shuffles: after it,
// lane l holds the warp's sum of v[l >> 1].
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kNA], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

__global__ void __launch_bounds__(kPix, kFwdMinBlocks)
fwd_kernel(const float* __restrict__ table, const int64_t* __restrict__ gidx,
           const int* __restrict__ tile_start, const int* __restrict__ tile_count,
           const float* __restrict__ offx, const float* __restrict__ offy,
           float* __restrict__ out, float* __restrict__ tfin, int tiles_x) {
  __shared__ Stage st;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int cnt = tile_count[t];
  const float2 pc = pixel_center(t, p, tiles_x, offx, offy);
  strip_bounds(st.strip, pc, p & 31, warp);

  float T = 1.0f;  // true running transmittance; frozen once done
  bool done = false;
  float acc[kNCh];
#pragma unroll
  for (int ch = 0; ch < kNCh; ++ch) acc[ch] = 0.0f;

  if (cnt > 0) {
    Stager sg{table, gidx, tile_start[t], cnt, p, {}};
    sg.load(0);
    sg.issue(st, 0, 0);
    sg.load(kBatch);
    for (int b = 0, base = 0; base < cnt; ++b, base += kBatch) {
      sg.land();
      if (!sg.advance(st, b, base, done, false)) break;
      const int n = warp_list(st, min(kBatch, cnt - base), p & 31, warp);
      for (int i = 0; i < n && !done; ++i) {
        const float* r = reinterpret_cast<const float*>(st.rows[b & 1][st.list[warp][i]]);
        const float dx = __fsub_rn(pc.x, r[8]);
        const float dy = __fsub_rn(pc.y, r[9]);
        const float power = gauss_power(r, dx, dy);
        if (!(power <= 0.0f)) continue;
        const float alpha = fminf(__fmul_rn(r[13], expf(power)), kAlphaMax);
        if (!(alpha >= kAlphaEps)) continue;
        const float t_after = __fmul_rn(T, __fsub_rn(1.0f, alpha));
        if (t_after < kTEps) {  // the stopping splat is not composited
          done = true;
          break;
        }
        const float w = __fmul_rn(alpha, T);
#pragma unroll
        for (int ch = 0; ch < kNCh; ++ch) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(w, r[ch]));
        T = t_after;
      }
    }
    cp_async_wait_all();  // no copy may land after the block exits
  }
#pragma unroll
  for (int ch = 0; ch < kNCh; ++ch) out[((size_t)t * kNCh + ch) * kPix + p] = acc[ch];
  tfin[(size_t)t * kPix + p] = T;
}

__global__ void __launch_bounds__(kPix, kBwdMinBlocks)
bwd_kernel(const float* __restrict__ table, const int64_t* __restrict__ gidx,
           const int* __restrict__ tile_start, const int* __restrict__ tile_count,
           const float* __restrict__ offx, const float* __restrict__ offy,
           const float* __restrict__ out, const float* __restrict__ tfin,
           const float* __restrict__ dout, const float* __restrict__ dtfin,
           float* __restrict__ dtab, int tiles_x) {
  __shared__ Stage st;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int cnt = tile_count[t];
  if (cnt == 0) return;  // block-uniform
  const float2 pc = pixel_center(t, p, tiles_x, offx, offy);
  strip_bounds(st.strip, pc, lane, warp);

  // B = sum_ch dC_ch C_ch + dT_fin T_fin: the whole-pixel total from which
  // the suffix (B - Q) of the entries behind the current one follows.
  float dC[kNCh];
  const size_t pix = (size_t)t * kPix + p;
  float B = dtfin[pix] * tfin[pix];
#pragma unroll
  for (int ch = 0; ch < kNCh; ++ch) {
    dC[ch] = dout[((size_t)t * kNCh + ch) * kPix + p];
    B += dC[ch] * out[((size_t)t * kNCh + ch) * kPix + p];
  }
  // This lane's column after the transposed warp sum, and its scale (the
  // opacity column's 1/op is per entry).
  const int col = lane >> 1;
  const float col_scale = (col == 10 || col == 12) ? -0.5f : (col == 11 ? -1.0f : 1.0f);

  float T = 1.0f;  // recomputed forward transmittance
  float Q = 0.0f;  // running prefix of w * (c . dC), the exact running total
  bool done = false;

  Stager sg{table, gidx, tile_start[t], cnt, p, {}};
  sg.load(0);
  sg.issue(st, 0, 0);
  sg.load(kBatch);
  for (int b = 0, base = 0; base < cnt; ++b, base += kBatch) {
    sg.land();
    if (!sg.advance(st, b, base, done, true)) break;
    if (__all_sync(kFull, done)) continue;  // this warp is done: wait at the barriers
    const int n = warp_list(st, min(kBatch, cnt - base), lane, warp);
    for (int i = 0; i < n; ++i) {  // warp-uniform: shuffles below
      const int j = st.list[warp][i];
      const float* r = reinterpret_cast<const float*>(st.rows[b & 1][j]);
      float v[kNA];
#pragma unroll
      for (int k = 0; k < kNA; ++k) v[k] = 0.0f;
      bool live = false;
      if (!done) {
        const float dx = __fsub_rn(pc.x, r[8]);
        const float dy = __fsub_rn(pc.y, r[9]);
        const float power = gauss_power(r, dx, dy);
        const float alpha_un = __fmul_rn(r[13], expf(power));
        const float alpha = fminf(alpha_un, kAlphaMax);
        if (power <= 0.0f && alpha >= kAlphaEps) {
          const float t_after = __fmul_rn(T, __fsub_rn(1.0f, alpha));
          if (t_after < kTEps) {
            done = true;
          } else {
            live = true;
            const float w = __fmul_rn(alpha, T);
            float a_dot = 0.0f;
#pragma unroll
            for (int ch = 0; ch < kNCh; ++ch) {
              a_dot += dC[ch] * r[ch];
              v[ch] = dC[ch] * w;
            }
            const float w_adot = w * a_dot;
            Q += w_adot;
            float dpower = 0.0f;
            if (alpha_un < kAlphaMax) {
              dpower = w_adot - (B - Q) * __fdividef(alpha_un, 1.0f - alpha);
            }
            const float u = dpower * dx;
            const float vv = dpower * dy;
            const float sx = r[10] * u + r[11] * vv;  // = dpower d(power)/d(mx)
            const float sy = r[12] * vv + r[11] * u;
            v[8] = sx;
            v[9] = sy;
            v[10] = u * dx;
            v[11] = u * dy;
            v[12] = vv * dy;
            v[13] = dpower;
            v[14] = fabsf(sx);
            v[15] = fabsf(sy);
            T = t_after;
          }
        }
      }
      // Warp sums; a warp none of whose pixels the entry touches skips them.
      if (__any_sync(kFull, live)) {
        const float scale = col == 13 ? r[14] : col_scale;  // r[14]: 1/op, set when staged
        const float s0 = warp_transpose_sum(v, lane) * scale;
        // Lane 8m gathers columns 4m..4m+3 (held by lanes 8m, +2, +4, +6).
        const float s1 = __shfl_down_sync(kFull, s0, 2);
        const float s2 = __shfl_down_sync(kFull, s0, 4);
        const float s3 = __shfl_down_sync(kFull, s0, 6);
        if ((lane & 7) == 0 && (s0 != 0.0f || s1 != 0.0f || s2 != 0.0f || s3 != 0.0f)) {
          atomicAdd(reinterpret_cast<float4*>(dtab + (size_t)st.gid[b & 1][j] * kNA) + (lane >> 3),
                    make_float4(s0, s1, s2, s3));
        }
      }
      if (__all_sync(kFull, done)) break;
    }
  }
  cp_async_wait_all();
}

}  // namespace

extern "C" int skyfall_composite_fwd(const float* table, const int64_t* gidx,
                                     const int* tile_start, const int* tile_count,
                                     const float* offx, const float* offy, float* out,
                                     float* tfin, int num_tiles, int tiles_x,
                                     void* stream) {
  if (num_tiles > 0) {
    fwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        table, gidx, tile_start, tile_count, offx, offy, out, tfin, tiles_x);
  }
  return (int)cudaGetLastError();
}

extern "C" int skyfall_composite_bwd(const float* table, const int64_t* gidx,
                                     const int* tile_start, const int* tile_count,
                                     const float* offx, const float* offy,
                                     const float* out, const float* tfin,
                                     const float* dout, const float* dtfin, float* dtab,
                                     int num_tiles, int tiles_x, void* stream) {
  if (num_tiles > 0) {
    bwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        table, gidx, tile_start, tile_count, offx, offy, out, tfin, dout, dtfin, dtab,
        tiles_x);
  }
  return (int)cudaGetLastError();
}
