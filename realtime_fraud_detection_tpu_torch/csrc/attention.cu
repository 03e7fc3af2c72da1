// Masked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel realtime_fraud_detection_tpu/ops/attention.py
// flash_attention (body _flash_kernel). q, k, v are f32 [B, H, S, D] given by
// strides (the last dim contiguous), key_mask is u8 [B, S]; the output is a
// contiguous f32 [B, H, S, D]. Semantics follow the Pallas kernel: q is
// scaled by 1/sqrt(D) before the dot, a masked score is -1e30 (not -inf),
// the running max starts at -1e30 and the denominator is floored at 1e-30,
// so a fully masked row averages all values uniformly.
//
// Design: one block per (b, h, 64-row q tile), one thread per query row. K,
// V and the mask for the whole sequence are staged in shared memory once per
// block; every thread of the warp reads the same K/V element at the same
// time (a shared-memory broadcast). Each thread keeps its scaled query row,
// its f32 accumulator and the running (max, denominator) in registers and
// streams the keys one at a time with the online-softmax rescale.
//
// Bound: bytes. At S = 64, D = 64 the work is 2*2*S*S*D flops per (b, h)
// against 4*S*D*4 bytes moved, 16 flops a byte, under the f32 ridge of an
// H100 (67 TFLOP/s over 3.35 TB/s, 20 flops a byte). The design reads each
// of q, k, v once from device memory and writes the output once; what keeps
// it from that floor is the one-thread-per-row f32 arithmetic (no tensor
// cores) and 64-thread blocks. A tensor-core (mma) version is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 64;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kTileQ)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask, float* __restrict__ out,
                       int H, int S, int n_tiles, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;              // [S][D]
  float* vs = smem + S * D;      // [S][D]
  float* ms = smem + 2 * S * D;  // [S] 1 = valid key

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh % H;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
    const int s = i / D, d = i % D;
    ks[i] = kb[s * kss + d];
    vs[i] = vb[s * vss + d];
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    ms[s] = mask[(size_t)b * S + s] ? 1.f : 0.f;
  __syncthreads();

  const int row = tile * kTileQ + threadIdx.x;
  if (row >= S) return;
  const float* qr = q + b * qsb + h * qsh + row * qss;
  float qv[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = qr[d] * scale;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (int j = 0; j < S; ++j) {
    const float* kj = ks + j * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qv[d], kj[d], s);
    if (ms[j] == 0.f) s = kNegInf;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const float* vj = vs + j * D;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vj[d], acc[d] * alpha);
    m = m_new;
  }
  const float denom = fmaxf(l, 1e-30f);
  float* o = out + (((size_t)b * H + h) * S + row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = acc[d] / denom;
}

}  // namespace

extern "C" int rtfd_flash_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int H,
                                    int S, int D, long long qsb, long long qsh,
                                    long long qss, long long ksb, long long ksh,
                                    long long kss, long long vsb, long long vsh,
                                    long long vss, float scale, void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * (size_t)S * D + S) * sizeof(float);
  auto kernel = flash_attention_kernel<64>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (S + kTileQ - 1) / kTileQ;
  const dim3 grid((unsigned)(B * H * n_tiles));
  kernel<<<grid, kTileQ, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), H, S, n_tiles, qsb, qsh, qss, ksb, ksh, kss, vsb,
      vsh, vss, scale);
  return static_cast<int>(cudaGetLastError());
}
