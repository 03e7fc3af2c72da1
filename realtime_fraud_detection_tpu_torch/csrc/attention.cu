// Masked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel realtime_fraud_detection_tpu/ops/attention.py
// flash_attention (body _flash_kernel). q, k, v are f32 [B, H, S, D] given by
// strides (the last dim contiguous, rows 16-byte aligned), key_mask is u8 (or
// bool) [B, S]; the output is written as a contiguous f32 [B, S, H, D], which
// the wrapper returns as its [B, H, S, D] view, so the encoder's merge of the
// heads is a free view. Semantics follow the Pallas kernel: q is scaled by
// 1/sqrt(D) before the dot, a masked score is -1e30 (not -inf), the running
// max starts at -1e30 and the denominator is floored at 1e-30, so a fully
// masked row averages all values uniformly. Keys past S weigh nothing.
//
// Design: one CTA of four warps per (b, h, 64-query tile); each warp owns 16
// query rows. The q tile and each 64-key block of K and V are staged in
// shared memory with 16-byte cp.async (rows padded to 68 floats, so every
// fragment read below is free of bank conflicts). Both products run on the
// tensor cores as mma.sync.m16n8k8 TF32 in the 3xTF32 split: x = big +
// small with big = tf32(x), small = tf32(x - big), and a*b accumulates
// small*big + big*small + big*big in f32 (about f32 accuracy; one TF32
// product alone misses the 5e-5 tolerance). The score fragments stay in
// registers: mask, row max and row sum (quad shuffles), the online rescale
// across key blocks, and they feed P.V directly as A fragments; the keys
// of each 8-key step are taken in the order (0,2,4,6 | 1,3,5,7) on both
// sides of that product, which makes the score accumulator layout the A
// operand layout with no shuffle.
//
// Bound: bytes. At S = 64, D = 64 the work is 2*2*S*S*D flops per (b, h)
// against 4*S*D*4 bytes moved, 16 flops a byte, under the f32 ridge of an
// H100 (67 TFLOP/s over 3.35 TB/s, 20 flops a byte); the 3xTF32 products
// (3 x 495 TFLOP/s-class issue) keep the math under the memory time. The
// kernel reads q, k and v once and writes the output once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // query rows per CTA, keys per block
constexpr int kThreads = 128;     // four warps of 16 query rows
constexpr int kD = 64;            // head width
constexpr int kLd = kD + 4;       // padded shared row, floats
constexpr int kSmemBytes = 3 * kTile * kLd * 4 + kTile * 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows [r0, r0 + 64) of a [S, D] slice with row stride rs -> dst (zero past S)
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long rs,
                                           int r0, int S) {
  for (int i = threadIdx.x; i < kTile * (kD / 4); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    float* d = dst + r * kLd + c;
    if (r0 + r < S)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(d)),
                   "l"(src + (r0 + r) * rs + c)
                   : "memory");
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in the 3xTF32 split (the small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, a_small, bb0, bb1);
  mma_tf32(c, a_big, bs0, bs1);
  mma_tf32(c, a_big, bb0, bb1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int H, int S, int n_tiles, long long qsb,
                       long long qsh, long long qss, long long ksb, long long ksh,
                       long long kss, long long vsb, long long vsh, long long vss,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [64][kLd] query tile
  float* ks = qs + kTile * kLd;          // [64][kLd] key block
  float* vs = ks + kTile * kLd;          // [64][kLd] value block
  int* kind = reinterpret_cast<int*>(vs + kTile * kLd);  // 0 valid, 1 masked, 2 past S

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh % H;
  const int q0 = tile * kTile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // this thread's rows r0 and r0 + 8
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  stage_rows(qs, q + b * qsb + h * qsh, qss, q0, S);

  float o[8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous block is no longer read
    stage_rows(ks, kb, kss, k0, S);
    stage_rows(vs, vb, vss, k0, S);
    if (threadIdx.x < kTile) {
      const int j = k0 + threadIdx.x;
      kind[threadIdx.x] = j >= S ? 2 : (mask[(size_t)b * S + j] ? 0 : 1);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();

    // scores: s[j] holds keys 8j + 2*t4 (+1) of rows r0 (e = 0, 1), r0 + 8 (e = 2, 3)
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      uint32_t ab[4], as[4];
      const float* qa = qs + r0 * kLd + 8 * kk + t4;
      split_tf32(qa[0] * scale, ab[0], as[0]);
      split_tf32(qa[8 * kLd] * scale, ab[1], as[1]);
      split_tf32(qa[4] * scale, ab[2], as[2]);
      split_tf32(qa[8 * kLd + 4] * scale, ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float* kr = ks + (8 * j + g) * kLd + 8 * kk + t4;
        mma_3xtf32(s[j], ab, as, kr[0], kr[4]);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kind[8 * j + 2 * t4 + (e & 1)];
        s[j][e] = c == 0 ? s[j][e] : (c == 1 ? kNegInf : -INFINITY);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int dj = 0; dj < kD / 8; ++dj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dj][e] *= alpha[e >> 1];

    // o += p . v; the A fragment's column t4 is key 2*t4, column t4 + 4 key 2*t4 + 1
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(s[kk][0], ab[0], as[0]);
      split_tf32(s[kk][2], ab[1], as[1]);
      split_tf32(s[kk][1], ab[2], as[2]);
      split_tf32(s[kk][3], ab[3], as[3]);
#pragma unroll
      for (int dj = 0; dj < kD / 8; ++dj) {
        const float* vr = vs + (8 * kk + 2 * t4) * kLd + 8 * dj + g;
        mma_3xtf32(o[dj], ab, as, vr[0], vr[kLd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + (((size_t)b * S + row) * H + h) * kD;
#pragma unroll
    for (int dj = 0; dj < kD / 8; ++dj)
      *reinterpret_cast<float2*>(orow + 8 * dj + 2 * t4) =
          make_float2(o[dj][2 * i] / denom, o[dj][2 * i + 1] / denom);
  }
}

}  // namespace

// out is a contiguous f32 [B, S, H, D]. Needs D == 64, S >= 1, 16-byte
// aligned q/k/v with row strides that are multiples of 4 (the wrapper checks).
extern "C" int rtfd_flash_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int H,
                                    int S, int D, long long qsb, long long qsh,
                                    long long qss, long long ksb, long long ksh,
                                    long long kss, long long vsb, long long vsh,
                                    long long vss, float scale, void* stream) {
  if (D != kD || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int n_tiles = (S + kTile - 1) / kTile;
  const dim3 grid((unsigned)(B * H * n_tiles));
  flash_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), H, S, n_tiles, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
      vss, scale);
  return static_cast<int>(cudaGetLastError());
}
