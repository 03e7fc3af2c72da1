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
// Design (bf16): a 64x64 output tile per block of 4 warps, a K loop in steps
// of 32. Each step loads the f32 x tile and rounds it to bf16 into shared
// memory, loads the i8 weight tile with one 16-byte load a thread and
// dequantizes it in registers into shared memory, then each warp runs a 2x2
// grid of 16x16x16 bf16 tensor-core products (WMMA) with f32 accumulators.
// The widened weight never reaches device memory. The epilogue stages the
// accumulators through shared memory to apply the bf16 rounding and the bias.
// The f32 path is a plain shared-memory tiled FMA kernel (4x4 outputs a
// thread), used where f32 compute is asked for.
//
// Bound: at M = 16384 (bucket 256 x 64 tokens) and K = N = 768 the work is
// 19 GFLOP against 101 MB of f32 x read and y written: bytes (30 us at
// 3.35 TB/s). At (768, 3072) and (3072, 768) it is 77 GFLOP: operations
// (78 us at 989 TFLOP/s bf16). This simple version has no TMA, no wgmma and
// no software pipelining, and it reads each x tile once per 64 output
// columns; those are the levers of a later, faster version.
//
// rtfd_dequant_rows replaces the Pallas kernel dequant_rows (body
// _dequant_rows_kernel) and fuses the embedding gather the TPU left to XLA:
// out[r] = f32(table[idx[r]]) * scale[idx[r]], bit-exact (one exact widen and
// one rounded multiply). One block per output row, 16-byte i8 loads and
// 16-byte f32 stores. Bound: bytes (the gathered i8 rows in, f32 rows out).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int A_LD = BK + 8;  // bf16 elements; rows stay 32-byte aligned
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // f32 elements

__global__ void __launch_bounds__(128)
dequant_matmul_bf16_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ qw,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, float* __restrict__ y,
                           int M, int N, int K) {
  __shared__ __align__(32) __nv_bfloat16 as[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 bs[BK * B_LD];
  __shared__ __align__(32) float cs[BM * C_LD];
  __shared__ float sc[BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  if (tid < BN)
    sc[tid] = __bfloat162float(__float2bfloat16_rn(scale[col0 + tid]));

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  // per-thread load slots: x row ar, columns ac..ac+15; weight row br,
  // columns bc..bc+15
  const int ar = tid >> 1, ac = (tid & 1) * 16;
  const int br = tid >> 2, bc = (tid & 3) * 16;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int gr = row0 + ar;
    if (gr < M) {
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)gr * K + k0 + ac);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = src[i];
        __nv_bfloat16* dst = as + ar * A_LD + ac + 4 * i;
        dst[0] = __float2bfloat16_rn(f.x);
        dst[1] = __float2bfloat16_rn(f.y);
        dst[2] = __float2bfloat16_rn(f.z);
        dst[3] = __float2bfloat16_rn(f.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) as[ar * A_LD + ac + i] = __float2bfloat16_rn(0.f);
    }
    const int4 raw = *reinterpret_cast<const int4*>(qw + (size_t)(k0 + br) * N + col0 + bc);
    const int8_t* qb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      bs[br * B_LD + bc + i] =
          __float2bfloat16_rn(static_cast<float>(qb[i]) * sc[bc + i]);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn + 16 * j, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * C_LD + wn + 16 * j, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += blockDim.x) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r;
    if (gr < M)
      y[(size_t)gr * N + col0 + c] =
          __bfloat162float(__float2bfloat16_rn(cs[r * C_LD + c])) + bias[col0 + c];
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

__global__ void dequant_rows_kernel(const int8_t* __restrict__ table,
                                    const float* __restrict__ scale,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ out, int table_rows, int H) {
  const int r = blockIdx.x;
  int src = idx != nullptr ? idx[r] : r;
  src = min(max(src, 0), table_rows - 1);  // clamp like an XLA gather
  const float s = scale[src];
  const int4* in = reinterpret_cast<const int4*>(table + (size_t)src * H);
  float4* o = reinterpret_cast<float4*>(out + (size_t)r * H);
  for (int c = threadIdx.x; c < H / 16; c += blockDim.x) {
    const int4 raw = in[c];
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[4 * c + i] = make_float4(static_cast<float>(q[4 * i + 0]) * s,
                                 static_cast<float>(q[4 * i + 1]) * s,
                                 static_cast<float>(q[4 * i + 2]) * s,
                                 static_cast<float>(q[4 * i + 3]) * s);
  }
}

}  // namespace

// bf16 != 0 selects bf16 compute, else f32. Needs K % 32 == 0, N % 64 == 0
// and 16-byte aligned x / qw (the wrapper checks).
extern "C" int rtfd_dequant_matmul(const void* x, const void* qw, const void* scale,
                                   const void* bias, void* y, int M, int N, int K,
                                   int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  if (bf16) {
    dequant_matmul_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(qw),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(y), M, N, K);
  } else {
    dequant_matmul_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(qw),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(y), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx may be null: row r of the output is then table row r (a prefix).
// Needs H % 16 == 0 (the wrapper checks).
extern "C" int rtfd_dequant_rows(const void* table, const void* scale, const void* idx,
                                 void* out, int rows, int table_rows, int H,
                                 void* stream) {
  dequant_rows_kernel<<<rows, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(table), static_cast<const float*>(scale),
      static_cast<const int32_t*>(idx), static_cast<float*>(out), table_rows, H);
  return static_cast<int>(cudaGetLastError());
}
