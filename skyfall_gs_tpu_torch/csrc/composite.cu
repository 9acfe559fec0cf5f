// Tile compositing kernels for Hopper (sm_90a): forward and backward.
//
// Replace the two Pallas TPU kernels of skyfall_gs_tpu/ops/rasterize_tiled.py:
//   skyfall_composite_fwd  <- _fwd_kernel (pl.pallas_call in _fwd_call)
//   skyfall_composite_bwd  <- _bwd_kernel (pl.pallas_call in _bwd_call)
// The Python wrappers, their plain PyTorch versions and the layout contract
// live in skyfall_gs_tpu_torch/ops/rasterize_tiled.py.
//
// Work unit: one 16x16 pixel tile = one thread block of 256 threads, one
// thread per pixel.  A tile's entries are the depth-sorted run
// [tile_start, tile_start + tile_count) of the binned entry stream; entry e
// reads row gather_idx[e] of the per-gaussian attribute table (N+1, 16):
//   cols 0..6 channels, 7 zero pad, 8 mx, 9 my, 10..12 conic a b c,
//   13 opacity, 14..15 AbsGS dummies (unused here).
//
// What bounds them on this card: per (entry, pixel) pair ~30 flops and one
// expf, i.e. ALU work of entries x 256 pixels per tile, plus one 64-byte
// attribute row read per entry (an indirect gather through gather_idx).
// Design: rows are staged in batches through shared memory with 16-byte
// loads (each thread fetches whole rows, then every pixel reads them as
// broadcasts), so each row crosses device memory once per tile; a
// block-wide vote (__syncthreads_or) stops a tile once every pixel's
// transmittance has terminated.  Tiles are independent blocks, so the
// sequential TPU grid's cross-tile boundary accumulation is not needed.
//
// Arithmetic on the thresholded path (power, alpha, transmittance, blend
// weights) uses explicit round-to-nearest intrinsics in the same operation
// order as the plain PyTorch version, so no fused multiply-add can move an
// alpha >= 1/255 or T >= 1e-4 decision away from it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels per tile = threads per block
constexpr int kWarps = kPix / 32;
constexpr int kNA = 16;              // attribute / gradient columns per entry
constexpr int kNCh = 7;              // blended channels
constexpr int kFwdBatch = 256;       // entries staged per batch (forward)
constexpr int kBwdBatch = 32;        // entries staged per batch (backward)
constexpr int kNRed = 15;            // per-pixel terms reduced per entry
constexpr unsigned kFull = 0xffffffffu;

// The thresholds as the plain version sees them: Python doubles cast to f32.
constexpr float kAlphaEps = (float)(1.0 / 255.0);
constexpr float kAlphaMax = (float)0.99;
constexpr float kTEps = (float)1e-4;

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

__device__ __forceinline__ void stage_rows(float4 (*dst)[kNA / 4], const float* table,
                                           const int64_t* gidx, int first, int n,
                                           int tid) {
  // Thread tid copies float4 (tid % 4) of row (tid / 4) of the batch.
  for (int k = tid; k < n * (kNA / 4); k += kPix) {
    const int j = k >> 2;
    const float4* src = reinterpret_cast<const float4*>(table + gidx[first + j] * kNA);
    dst[j][k & 3] = src[k & 3];
  }
}

__global__ void __launch_bounds__(kPix)
fwd_kernel(const float* __restrict__ table, const int64_t* __restrict__ gidx,
           const int* __restrict__ tile_start, const int* __restrict__ tile_count,
           const float* __restrict__ offx, const float* __restrict__ offy,
           float* __restrict__ out, float* __restrict__ tfin, int tiles_x) {
  __shared__ float4 rows[kFwdBatch][kNA / 4];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int cnt = tile_count[t];
  const float2 pc = pixel_center(t, p, tiles_x, offx, offy);

  float T = 1.0f;  // true running transmittance; frozen once done
  bool done = false;
  float acc[kNCh];
#pragma unroll
  for (int ch = 0; ch < kNCh; ++ch) acc[ch] = 0.0f;

  for (int base = 0; base < cnt; base += kFwdBatch) {
    // Barrier for the previous batch's reads, and the early exit: stop once
    // no pixel of the tile can take another contribution.
    if (!__syncthreads_or(!done)) break;
    const int nb = min(kFwdBatch, cnt - base);
    stage_rows(rows, table, gidx, start + base, nb, p);
    __syncthreads();
    for (int j = 0; j < nb && !done; ++j) {
      const float* r = reinterpret_cast<const float*>(rows[j]);
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
#pragma unroll
  for (int ch = 0; ch < kNCh; ++ch) out[((size_t)t * kNCh + ch) * kPix + p] = acc[ch];
  tfin[(size_t)t * kPix + p] = T;
}

__global__ void __launch_bounds__(kPix)
bwd_kernel(const float* __restrict__ table, const int64_t* __restrict__ gidx,
           const int* __restrict__ tile_start, const int* __restrict__ tile_count,
           const float* __restrict__ offx, const float* __restrict__ offy,
           const float* __restrict__ out, const float* __restrict__ tfin,
           const float* __restrict__ dout, const float* __restrict__ dtfin,
           float* __restrict__ dent, int tiles_x) {
  __shared__ float4 rows[kBwdBatch][kNA / 4];
  __shared__ float part[kWarps][kBwdBatch][kNRed];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int start = tile_start[t];
  const int cnt = tile_count[t];
  const float2 pc = pixel_center(t, p, tiles_x, offx, offy);

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

  float T = 1.0f;  // recomputed forward transmittance
  float Q = 0.0f;  // running prefix of w * (c . dC), the exact running total
  bool done = false;

  for (int base = 0; base < cnt; base += kBwdBatch) {
    if (!__syncthreads_or(!done)) break;
    const int nb = min(kBwdBatch, cnt - base);
    stage_rows(rows, table, gidx, start + base, nb, p);
    __syncthreads();
    for (int j = 0; j < nb; ++j) {  // warp-uniform: shuffles below
      const float* r = reinterpret_cast<const float*>(rows[j]);
      float v[kNRed];
#pragma unroll
      for (int k = 0; k < kNRed; ++k) v[k] = 0.0f;
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
              dpower = w_adot - (B - Q) * (alpha_un / (1.0f - alpha));
            }
            const float u = dpower * dx;
            const float vv = dpower * dy;
            const float sx = r[10] * u + r[11] * vv;  // = dpower d(power)/d(mx)
            const float sy = r[12] * vv + r[11] * u;
            v[7] = sx;
            v[8] = sy;
            v[9] = u * dx;
            v[10] = u * dy;
            v[11] = vv * dy;
            v[12] = dpower;
            v[13] = fabsf(sx);
            v[14] = fabsf(sy);
            T = t_after;
          }
        }
      }
      // Warp sums; a warp none of whose pixels the entry touches skips them.
      if (__any_sync(kFull, live)) {
#pragma unroll
        for (int k = 0; k < kNRed; ++k) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(kFull, v[k], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kNRed; ++k) part[warp][j][k] = v[k];
      }
    }
    __syncthreads();
    // Block sums over the 8 warps, written straight to the entries' rows:
    // each entry belongs to exactly one tile, so this block owns its rows.
    for (int k = p; k < nb * kNA; k += kPix) {
      const int j = k / kNA;
      const int c = k % kNA;
      float s = 0.0f;
      if (c != 7) {
        const int term = c < 7 ? c : c - 1;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[w][j][term];
      }
      const float* r = reinterpret_cast<const float*>(rows[j]);
      if (c == 10 || c == 12) s *= -0.5f;                  // d conic a, c
      if (c == 11) s = -s;                                  // d conic b
      if (c == 13) s *= (r[13] > 0.0f ? 1.0f / r[13] : 0.0f);  // d opacity
      dent[(size_t)(start + base + j) * kNA + c] = s;
    }
  }
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
                                     const float* dout, const float* dtfin, float* dent,
                                     int num_tiles, int tiles_x, void* stream) {
  if (num_tiles > 0) {
    bwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        table, gidx, tile_start, tile_count, offx, offy, out, tfin, dout, dtfin, dent,
        tiles_x);
  }
  return (int)cudaGetLastError();
}
