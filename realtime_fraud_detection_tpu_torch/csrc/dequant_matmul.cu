// Weight-only int8 kernels of the quantized BERT branch, for Hopper (sm_90a).
//
// rtfd_dequant_matmul replaces the Pallas kernel
// realtime_fraud_detection_tpu/ops/dequant_matmul.py dequant_matmul (body
// _dequant_matmul_kernel): y = x @ dequant(qw, scale) + b, x f32 [M, K],
// qw i8 [K, N] with per-output-channel f32 scales, y f32 [M, N].
//
//   bf16 compute: w = bf16(f32(q) * f32(bf16(scale))), the product of x
//   rounded to bf16 and w accumulated in f32 over the full K, rounded once
//   to bf16, widened, then + b in f32 (the reference's rounding points).
//   f32 compute: w = f32(q) * scale, f32 accumulation, + b.
//
// Design (bf16): a persistent, warp-specialised wgmma kernel. One CTA per
// SM walks 128 x 128 output tiles, all N tiles of one 128-row x panel back
// to back, so the CTAs in flight share a few x panels in L2 and x comes
// from device memory about once. Each K step of 64 is one stage of a
// 4-deep shared-memory ring guarded by mbarriers (full: TMA bytes landed;
// ready: weight widened; empty: both consumers done):
//   - a TMA warp (one lane) loads the f32 x tile (two 128B-swizzled
//     [128 x 32] boxes) and the raw i8 weight tile [64 x 128];
//   - a dequant warpgroup widens the i8 tile once per stage: 4-byte loads
//     of [8 k x 4 n] blocks, q -> f32 exactly by a byte permute into the
//     mantissa of 2^23 and one subtraction, * bf16(scale), rounded to bf16,
//     written transposed into the K-major 128B-swizzled layout a wgmma B
//     descriptor reads; then it fences the async proxy and arrives;
//   - two consumer warpgroups (64 rows each) read their x rows from shared
//     memory, round them to packed bf16x2 A fragments in registers and
//     issue wgmma.m64n128k16 (A from registers, B from shared memory) with
//     f32 accumulators in registers; a stage is released when the next
//     stage's group is issued (wgmma.wait_group 1), so fragment building
//     overlaps the tensor cores.
// The widened weight never reaches device memory. The epilogue rounds each
// accumulator once to bf16, widens it, adds the f32 bias and stores. The
// ragged M edge and the K / N tails are zero-filled by TMA and masked on
// store. The tensor maps are encoded on the host through
// cudaGetDriverEntryPoint (cuTensorMapEncodeTiled), so the library links
// without -lcuda. The f32 path is a plain shared-memory tiled FMA kernel
// (4x4 outputs a thread), used where f32 compute is asked for; it is not on
// the served path.
//
// Bound: at M = 16384 (bucket 256 x 64 tokens) and K = N = 768 the work is
// 19 GFLOP against 101 MB of f32 x read and y written: bytes (30 us at
// 3.35 TB/s). At (768, 3072) and (3072, 768) it is 77 GFLOP: operations
// (78 us at 989 TFLOP/s bf16). What still stands between this design and
// those bounds: x is f32 and is re-read from L2 once per 128 output
// columns (24 times at N = 3072) and the raw weight tile once per 128
// rows, and one dequant warpgroup widens every weight tile by itself.
//
// rtfd_dequant_rows replaces the Pallas kernel dequant_rows (body
// _dequant_rows_kernel) and fuses the embedding gather the TPU left to XLA:
// out[r] = f32(table[idx[r]]) * scale[idx[r]], bit-exact (one exact widen and
// one rounded multiply). A flat grid of 256-thread blocks, a thread per 4
// columns of a row (4-byte i8 load, 16-byte f32 store), so all lanes work
// at any width and every warp's loads and stores are contiguous; the first
// design (one 64-thread block per row, 16-byte loads, 16 of 64 lanes idle
// at H = 768) ran the 16384-row word site at 46% of its bound on the card.
// Bound: bytes (the gathered i8 rows and the indices in, f32 rows out).

#include <cuda.h>  // CUtensorMap and its enums only; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- bf16 compute: tiles, ring and roles
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                    // wgmma warpgroups, 64 rows each
constexpr int DEQUANT_TID0 = CONSUMERS * 128;   // the dequant warpgroup
constexpr int TMA_TID = DEQUANT_TID0 + 128;     // one lane of the last warp
constexpr int THREADS = TMA_TID + 32;
constexpr int X_HALF_BYTES = BM * 32 * 4;       // one [128 x 32] f32 box
constexpr int X_STAGE_BYTES = 2 * X_HALF_BYTES;
constexpr int W_STAGE_BYTES = BN * BK * 2;      // bf16, K-major, 128B-swizzled
constexpr int Q_STAGE_BYTES = BK * BN;          // the raw i8 tile
constexpr int STAGE_BYTES = X_STAGE_BYTES + W_STAGE_BYTES + Q_STAGE_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8;
static_assert(STAGE_BYTES % 1024 == 0, "swizzled tiles need 1024-byte alignment");
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with this parity has completed. A wait
// that never ends (a broken pipeline invariant) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO), leading offset unused for this layout.
__device__ __forceinline__ uint64_t desc_b128(const void* p) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Keep the compiler from moving accumulator accesses across wgmma fences.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += a[64 x 16] (bf16, registers) * B[16 x 128] (bf16, shared).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Two f32 of x at (row r, column c, c + 1) of a 128B-swizzled [128 x 32]
// box, rounded to a packed bf16x2 (low half = column c).
__device__ __forceinline__ uint32_t x_pair(const uint8_t* box, int r, int c) {
  const float2 v = *reinterpret_cast<const float2*>(
      box + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)));
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(THREADS, 1)
dequant_matmul_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap q_map,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, float* __restrict__ y,
                           int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);  // TMA landed
  uint64_t* ready = full + STAGES;  // weight tile widened
  uint64_t* empty = ready + STAGES;  // consumers done with the stage
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 128);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = ((M + BM - 1) / BM) * tiles_n;
  const int k_steps = (K + BK - 1) / BK;
  int s = 0;
  uint32_t phase = 0;

  if (tid < DEQUANT_TID0) {
    // ---- consumers: x rows -> bf16 A fragments, wgmma, epilogue
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int r_lo = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;  // and r_lo + 8
    float d[64];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      fence_acc(d);
      // One K step: A fragments of this stage into a, four wgmma, then wait
      // for the previous step's group (so its stage and fragments are free)
      // while this one runs.
      int held = -1;  // the stage whose wgmma group may still be running
      auto step = [&](uint32_t(&a)[4][4]) {
        mbar_wait(&full[s], phase);
        mbar_wait(&ready[s], phase);
        const uint8_t* st = smem + s * STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint8_t* box = st + (kk >> 1) * X_HALF_BYTES;
          const int c = (kk & 1) * 16 + 2 * t4;
          a[kk][0] = x_pair(box, r_lo, c);
          a[kk][1] = x_pair(box, r_lo + 8, c);
          a[kk][2] = x_pair(box, r_lo, c + 8);
          a[kk][3] = x_pair(box, r_lo + 8, c + 8);
        }
        const uint64_t desc = desc_b128(st + X_STAGE_BYTES);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16(d, a[kk], desc + 2 * kk);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (held >= 0) mbar_arrive(&empty[held]);
        held = s;
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      };
      uint32_t a_even[4][4], a_odd[4][4];
      for (int ks = 0; ks < k_steps; ks += 2) {
        step(a_even);
        if (ks + 1 < k_steps) step(a_odd);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);
      mbar_arrive(&empty[held]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        if (col >= N) continue;
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + r_lo + 8 * h;
          if (row < M)
            *reinterpret_cast<float2*>(y + (size_t)row * N + col) = make_float2(
                __bfloat162float(__float2bfloat16_rn(d[4 * j + 2 * h])) + b0,
                __bfloat162float(__float2bfloat16_rn(d[4 * j + 2 * h + 1])) + b1);
        }
      }
    }
  } else if (tid < TMA_TID) {
    // ---- dequant warpgroup: per stage each thread widens two [8 k x 4 n]
    // blocks of the raw i8 tile (eight 4-byte loads each) into four 16-byte
    // chunks of the K-major bf16 tile, placed by the 128B swizzle. A byte q
    // widens exactly as float(0x4B000000 | (q + 128)) - (2^23 + 128), one
    // byte permute and one add; then * bf16(scale), rounded to bf16.
    const int lane = tid & 31, kg0 = (tid - DEQUANT_TID0) >> 5;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      float sc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = (t % tiles_n) * BN + 4 * lane + i;
        sc[i] = col < N ? __bfloat162float(__float2bfloat16_rn(scale[col])) : 0.f;
      }
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[s], phase);
        uint8_t* st = smem + s * STAGE_BYTES;
        const uint32_t* raw =
            reinterpret_cast<const uint32_t*>(st + X_STAGE_BYTES + W_STAGE_BYTES);
#pragma unroll
        for (int it = 0; it < 2; ++it) {
          const int kg = kg0 + 4 * it;  // k = 8 kg .. 8 kg + 7
          uint32_t w[8];
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            w[kk] = raw[(8 * kg + kk) * (BN / 4) + lane] ^ 0x80808080u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // column 4 lane + c; staggered so that 8 lanes' stores hit 8 banks groups
            const int c = (i + (lane >> 1)) & 3;
            const uint32_t sel = 0x7440u | c;
            const float scc = c == 0 ? sc[0] : c == 1 ? sc[1] : c == 2 ? sc[2] : sc[3];
            uint32_t packed[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float lo = __fsub_rn(__uint_as_float(__byte_perm(w[2 * j], 0x4B000000u, sel)),
                                         8388736.f);
              const float hi = __fsub_rn(
                  __uint_as_float(__byte_perm(w[2 * j + 1], 0x4B000000u, sel)), 8388736.f);
              const __nv_bfloat162 h =
                  __floats2bfloat162_rn(__fmul_rn(lo, scc), __fmul_rn(hi, scc));
              packed[j] = *reinterpret_cast<const uint32_t*>(&h);
            }
            const int n = 4 * lane + c;
            *reinterpret_cast<uint4*>(st + X_STAGE_BYTES + n * 128 + ((kg ^ (n & 7)) << 4)) =
                make_uint4(packed[0], packed[1], packed[2], packed[3]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&ready[s]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else if (tid == TMA_TID) {
    // ---- producer: keep up to STAGES K steps of x and the i8 weight in flight
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], X_STAGE_BYTES + Q_STAGE_BYTES);
        tma_load_2d(st, &x_map, &full[s], ks * BK, m0);
        tma_load_2d(st + X_HALF_BYTES, &x_map, &full[s], ks * BK + 32, m0);
        tma_load_2d(st + X_STAGE_BYTES + W_STAGE_BYTES, &q_map, &full[s], n0, ks * BK);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  }
}

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
dequant_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ qw,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ y,
                          int M, int N, int K) {
  __shared__ float as[FK][FT + 4];  // x tile, transposed: [k][m]
  __shared__ float bs[FK][FT];      // dequantized weight tile: [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * FT, col0 = blockIdx.x * FT;
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int bk = tid >> 4, bc = (tid & 15) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    const int gr = row0 + ar;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < M) f = *reinterpret_cast<const float4*>(x + (size_t)gr * K + k0 + ak);
    as[ak + 0][ar] = f.x;
    as[ak + 1][ar] = f.y;
    as[ak + 2][ar] = f.z;
    as[ak + 3][ar] = f.w;
    const char4 q4 = *reinterpret_cast<const char4*>(qw + (size_t)(k0 + bk) * N + col0 + bc);
    bs[bk][bc + 0] = static_cast<float>(q4.x) * scale[col0 + bc + 0];
    bs[bk][bc + 1] = static_cast<float>(q4.y) * scale[col0 + bc + 1];
    bs[bk][bc + 2] = static_cast<float>(q4.z) * scale[col0 + bc + 2];
    bs[bk][bc + 3] = static_cast<float>(q4.w) * scale[col0 + bc + 3];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      y[(size_t)gr * N + c] = acc[i][j] + bias[c];
    }
  }
}

// dequant_rows: a flat grid of ROWS_THREADS-thread blocks over (row, 4
// columns) units, so every lane works whatever H is and a warp reads 128
// contiguous bytes of a row and writes 512 contiguous bytes.
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_VEC = 4;

__global__ void __launch_bounds__(ROWS_THREADS)
dequant_rows_kernel(const int8_t* __restrict__ table, const float* __restrict__ scale,
                    const int32_t* __restrict__ idx, float* __restrict__ out, int rows,
                    int table_rows, int H) {
  const int per_row = H / ROWS_VEC;
  const long long unit = (long long)blockIdx.x * ROWS_THREADS + threadIdx.x;
  if (unit >= (long long)rows * per_row) return;
  const int r = static_cast<int>(unit / per_row), c = static_cast<int>(unit % per_row);
  int src = idx != nullptr ? idx[r] : r;
  src = min(max(src, 0), table_rows - 1);  // clamp like an XLA gather
  const float s = scale[src];
  const char4 q = reinterpret_cast<const char4*>(table + (size_t)src * H)[c];
  reinterpret_cast<float4*>(out + (size_t)r * H)[c] =
      make_float4(static_cast<float>(q.x) * s, static_cast<float>(q.y) * s,
                  static_cast<float>(q.z) * s, static_cast<float>(q.w) * s);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, cols] tensor map with [box_rows, box_cols] boxes;
// out-of-range elements load as zero.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows,
               int cols, int elem_bytes, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_bf16(const void* x, const void* qw, const void* scale, const void* bias,
                        void* y, int M, int N, int K, cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dequant_matmul_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  CUtensorMap x_map, q_map;
  if (!encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, M, K, 4, BM, 32,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, K, N, 1, BK, BN,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int n_tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  dequant_matmul_bf16_kernel<<<n_tiles < sms ? n_tiles : sms, THREADS, SMEM_BYTES, st>>>(
      x_map, q_map, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// bf16 != 0 selects bf16 compute, else f32. Needs K % 32 == 0, N % 64 == 0
// and 16-byte aligned x / qw (the wrapper checks).
extern "C" int rtfd_dequant_matmul(const void* x, const void* qw, const void* scale,
                                   const void* bias, void* y, int M, int N, int K,
                                   int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return static_cast<int>(launch_bf16(x, qw, scale, bias, y, M, N, K, st));
  const dim3 grid(N / FT, (M + FT - 1) / FT);
  dequant_matmul_f32_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// idx may be null: row r of the output is then table row r (a prefix).
// Needs H % 16 == 0 (the wrapper checks; the kernel itself needs H % 4).
extern "C" int rtfd_dequant_rows(const void* table, const void* scale, const void* idx,
                                 void* out, int rows, int table_rows, int H,
                                 void* stream) {
  const long long units = (long long)rows * (H / ROWS_VEC);
  const int blocks = static_cast<int>((units + ROWS_THREADS - 1) / ROWS_THREADS);
  dequant_rows_kernel<<<blocks, ROWS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(table), static_cast<const float*>(scale),
      static_cast<const int32_t*>(idx), static_cast<float*>(out), rows, table_rows, H);
  return static_cast<int>(cudaGetLastError());
}
