// Fused softmax attention for FLUX on Hopper (sm_90a): one launch computes
// softmax(q k^T / sqrt(128)) v for every image and head of a call.
//
// It replaces no TPU kernel: the JAX package's attention
// (skyfall_gs_tpu/priors/flux.py _attention) is plain XLA, and so was the
// port's (skyfall_gs_tpu_torch/ops/attention.py attention, kept as the plain
// version).  It was added because a profile of Stage-2 view generation showed
// that plain version taking about two thirds of the device time: a float32
// QK^T on the SIMT units, then the float32 score matrix (24 x 4608^2 per
// image and block, 2 GB) written to device memory and read back three times
// (scale, softmax, cast to bf16).  The Python wrapper and both routing rules
// live in skyfall_gs_tpu_torch/ops/attention.py.
//
// Arithmetic, as the JAX package's _attention defines it: QK^T on bf16
// operands with float32 accumulation (a bf16 x bf16 product is exact in
// float32, so the scores are the float32 ones up to summation order), the
// softmax in float32, the weights rounded to bf16 before PV, PV accumulated
// in float32, the output rounded to bf16.  Online: per 128-key tile the
// running row max m and row sum l are float32, p = exp2(s * c - m * c) with
// c = log2(e) / sqrt(128), p rounded to bf16 feeds PV unnormalised, and O is
// divided by l once at the end.  Keys past L are masked to -inf.
//
// What bounds it on this card.  At FLUX's shape (4,096 + 512 tokens, 24
// heads of 128) one image costs 4 L^2 hd H = 261 GFLOP per block in its two
// products and reads 28 MB each of q, k, v: ~9,300 operations per byte, far
// above the H100's ~295, so the tensor cores bound it (0.26 ms per image at
// 989 TFLOP/s).  Beside them, the exponentials: 128 x 128 per tile, on the
// 16-per-clock special function units, cost about half of a tile's
// tensor-core time; and a CTA's K and V stream from L2 once per 128 query
// rows.  The design:
//   * no score leaves the SM: S lives in registers, P is converted in
//     registers into the A operand of the PV product (the accumulator layout
//     of wgmma m64nNk16 is its A-fragment layout), O stays in registers;
//   * one CTA per (image, head, 128 query rows): a producer warp keeps Q
//     resident and streams 128-key K and V tiles by TMA (128-byte swizzle,
//     two 64-column boxes each) into a 2-stage ring guarded by mbarriers;
//     two consumer warpgroups of 64 query rows each run wgmma m64n128k16
//     (bf16 in, float32 accumulators) for S = Q K^T from shared memory and
//     O += P V with P from registers and V (key-major, so "transposed") from
//     shared memory; while one warpgroup computes its exponentials the
//     other's products keep the tensor cores busy;
//   * registers move from the producer (24) to the consumers (240) with
//     setmaxnreg: a consumer holds O (64 floats), S (64) and P (32);
//   * the epilogue writes O / l as bf16 into Q's shared memory (Q is dead
//     by then) in the 128-byte swizzle and stores it by TMA straight into
//     the (B, L, H * 128) layout the out-projection reads;
//   * q, k and v are (B, H, L, 128) with unit stride in the last dimension;
//     the other strides go into the TMA descriptors, so a transposed view
//     (the single block's v) needs no copy.  TMA fills rows past L with
//     zeros on load and drops them on store: any L >= 1 works.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;            // head width: FLUX.1's only one
constexpr int kBM = 128;            // query rows per CTA
constexpr int kBN = 128;            // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;       // producer warpgroup + 2 consumer warpgroups
constexpr int kHalf = 64 * kBN * 2;     // one 64-column box of a 128-row tile: 16 KB
constexpr int kTile = 2 * kHalf;        // a 128 x 128 bf16 tile: 32 KB
constexpr int kQOff = 0;
constexpr int kKOff = kTile;
constexpr int kVOff = kKOff + kStages * kTile;
constexpr int kBarOff = kVOff + kStages * kTile;
constexpr int kSmemBytes = kBarOff + 128 + 1024;   // barriers, and slack to align to 1 KB

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity ``parity`` has completed.  A wait that
// lasts ~2^35 clocks (tens of seconds) traps: a fault, not a hung card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), swizzle 1.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
       | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC8(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
                "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define ACC64 ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, float32) (+)= A (64 x 16) B (16 x 128), both from shared
// memory, K-major; ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void gmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64 ", %64, %65, p, 1, 1, 0, 0;\n\t"
      "}\n"
      : ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, float32) += A (64 x 16, bf16 pairs in registers) B (16 x 128)
// from shared memory, MN-major (the key-major V tile).
__device__ __forceinline__ void gmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t"
      "}\n"
      : ACC64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
// Grid (ceil(L / 128), H, B); 384 threads: warpgroup 0 produces, 1 and 2
// consume query rows [0, 64) and [64, 128) of the CTA's tile.
//
// Shared memory (1 KB aligned): Q, K[2], V[2], each a 128-row tile as two
// 16 KB boxes of 64 columns, row r of a box at r * 128 bytes, its 16-byte
// chunks XOR-swizzled by r % 8 (TMA's 128-byte swizzle).  For the products:
//   * Q and K are K-major (the head dimension is contiguous): k-step kk of
//     16 columns starts at box kk / 4, byte (kk % 4) * 32; 8-row groups are
//     1 KB apart (stride byte offset), the leading offset is unused;
//   * V is MN-major for O += P V (its head dimension, the product's N, is
//     contiguous): k-step kk of 16 keys starts at row 16 kk; the two
//     64-column boxes are 16 KB apart along N (leading byte offset), 8-key
//     groups 1 KB apart (stride byte offset).
// Accumulator layout of wgmma m64n128 (per warpgroup thread t, warp w =
// t / 32, lane l): d[4i + {0, 1}] is row 16 w + l / 4, columns
// 8 i + 2 (l % 4) + {0, 1}; d[4i + {2, 3}] the same columns of row + 8.

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, int L, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t bar = base + kBarOff;   // q_full, k_full[2], v_full[2], k_empty[2], v_empty[2]
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (3 + s); };
  auto k_empty = [&](int s) { return bar + 8 * (5 + s); };
  auto v_empty = [&](int s) { return bar + 8 * (7 + s); };

  const int q0 = blockIdx.x * kBM, head = blockIdx.y, img = blockIdx.z;
  const int n_tiles = (L + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(k_empty(s), 8);   // lane 0 of each consumer warp
      bar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && lane == 0) {
      bar_expect_tx(q_full, kTile);
      tma_load_4d(base + kQOff, &q_map, q_full, 0, q0, head, img);
      tma_load_4d(base + kQOff + kHalf, &q_map, q_full, 64, q0, head, img);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        const uint32_t k_dst = base + kKOff + s * kTile, v_dst = base + kVOff + s * kTile;
        bar_wait(k_empty(s), parity);
        bar_expect_tx(k_full(s), kTile);
        tma_load_4d(k_dst, &k_map, k_full(s), 0, j * kBN, head, img);
        tma_load_4d(k_dst + kHalf, &k_map, k_full(s), 64, j * kBN, head, img);
        bar_wait(v_empty(s), parity);
        bar_expect_tx(v_full(s), kTile);
        tma_load_4d(v_dst, &v_map, v_full(s), 0, j * kBN, head, img);
        tma_load_4d(v_dst + kHalf, &v_map, v_full(s), 64, j * kBN, head, img);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;                         // rows [64 c, 64 c + 64) of the tile
    const int r0 = 16 * warp + lane / 4;          // this thread's rows r0 and r0 + 8
    const int col = 2 * (lane % 4);
    const uint32_t q_slab = base + kQOff + c * 64 * 128;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    bar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t k_tile = base + kKOff + s * kTile, v_tile = base + kVOff + s * kTile;

      // S = Q K^T
      float sc[64];
      bar_wait(k_full(s), parity);
      pin(sc);
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        gmma_ss(sc, gmma_desc(q_slab + off, 16, 1024), gmma_desc(k_tile + off, 16, 1024),
                kk > 0);
      }
      gmma_commit();
      gmma_wait_all();
      pin(sc);
      __syncwarp();
      if (lane == 0) bar_arrive(k_empty(s));

      // Keys past L.
      if ((j + 1) * kBN > L) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int key = j * kBN + 8 * i + col;
          if (key >= L) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
          if (key + 1 >= L) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
        }
      }

      // Online softmax: the running max, the rescale of O and l, P.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = ex2((m0 - mx0) * scale_log2), corr1 = ex2((m1 - mx1) * scale_log2);
      const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
      m0 = mx0;
      m1 = mx1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i] *= corr0;
        o[4 * i + 1] *= corr0;
        o[4 * i + 2] *= corr1;
        o[4 * i + 3] *= corr1;
      }
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p00 = ex2(fmaf(sc[4 * i], scale_log2, -mc0));
        const float p01 = ex2(fmaf(sc[4 * i + 1], scale_log2, -mc0));
        const float p10 = ex2(fmaf(sc[4 * i + 2], scale_log2, -mc1));
        const float p11 = ex2(fmaf(sc[4 * i + 3], scale_log2, -mc1));
        l0 += p00 + p01;
        l1 += p10 + p11;
        pa[2 * i] = pack_bf16(p00, p01);
        pa[2 * i + 1] = pack_bf16(p10, p11);
      }

      // O += P V: k-step kk takes keys [16 kk, 16 kk + 16), the S columns of
      // n-blocks 2 kk and 2 kk + 1.
      bar_wait(v_full(s), parity);
      pin(o);
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        gmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                gmma_desc(v_tile + kk * 16 * 128, kHalf, 1024));
      }
      gmma_commit();
      gmma_wait_all();
      pin(o);
      __syncwarp();
      if (lane == 0) bar_arrive(v_empty(s));
    }

    // Epilogue: O / l in bf16 into this warpgroup's rows of the Q tile, in
    // the 128-byte swizzle, then one TMA store per 64-column box.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    uint8_t* slab = smem + kQOff + c * 64 * 128;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int box = i / 8, chunk = i % 8;
      const int sw = (chunk ^ (r0 % 8)) * 16 + 2 * col;   // r0 and r0 + 8 agree mod 8
      *reinterpret_cast<uint32_t*>(slab + box * kHalf + r0 * 128 + sw) =
          pack_bf16(o[4 * i] / l0, o[4 * i + 1] / l0);
      *reinterpret_cast<uint32_t*>(slab + box * kHalf + (r0 + 8) * 128 + sw) =
          pack_bf16(o[4 * i + 2] / l1, o[4 * i + 3] / l1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
    if (threadIdx.x % 128 == 0 && q0 + 64 * c < L) {
      tma_store_3d(&o_map, q_slab, head * kHd, q0 + 64 * c, img);
      tma_store_3d(&o_map, q_slab + kHalf, head * kHd + 64, q0 + 64 * c, img);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once in libcuda (this library links
// only the CUDA runtime).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle: dims and byte strides
// innermost first (strides of dims 1..rank-1), box of 64 columns.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled encode = encode_tiled();
  return encode && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v: (B, H, L, 128) bf16, unit stride in the last dimension, the other
// strides (elements) as given; out: (B, L, H * 128) bf16, contiguous.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue when a
// tensor map cannot be encoded (strides or pointers not 16-byte aligned).
extern "C" int skyfall_flash_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int L, long long q_sb, long long q_sh,
                                       long long q_sl, long long k_sb, long long k_sh,
                                       long long k_sl, long long v_sb, long long v_sh,
                                       long long v_sl, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return 0;
  CUtensorMap maps[4];
  const void* ptrs[3] = {q, k, v};
  const long long strides[3][3] = {{q_sl, q_sh, q_sb}, {k_sl, k_sh, k_sb}, {v_sl, v_sh, v_sb}};
  const cuuint64_t dims[4] = {kHd, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t box[4] = {64, kBN, 1, 1};
  for (int t = 0; t < 3; ++t) {
    const cuuint64_t bytes[3] = {(cuuint64_t)strides[t][0] * 2, (cuuint64_t)strides[t][1] * 2,
                                 (cuuint64_t)strides[t][2] * 2};
    if (!make_map(&maps[t], ptrs[t], 4, dims, bytes, box)) return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t o_dims[3] = {(cuuint64_t)H * kHd, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t o_bytes[2] = {(cuuint64_t)H * kHd * 2, (cuuint64_t)L * H * kHd * 2};
  const cuuint32_t o_box[3] = {64, 64, 1};
  if (!make_map(&maps[3], out, 3, o_dims, o_bytes, o_box)) return (int)cudaErrorInvalidValue;

  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((L + kBM - 1) / kBM, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)kHd);
  flash_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], L, scale_log2);
  return (int)cudaGetLastError();
}
