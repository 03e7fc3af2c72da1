// Fused score-and-blend epilogue for Hopper (sm_90a).
//
// Replaces the Pallas kernel realtime_fraud_detection_tpu/ops/epilogue.py
// fused_epilogue (body _epilogue_kernel, math combine_matrix). One thread
// per batch row: it combines the M branch probabilities under the validity
// mask with the blend weights (strategy chosen at run time), derives the
// per-model confidence, the decision and risk ladders, the explanation
// contributions w*p and the rules-only ladder over the rule score, and
// writes one row of the [B, M+6] epilogue matrix:
//   prob, confidence, decision, risk, contributions[M], rule_decision,
//   rule_risk  (ints ride as exact small floats).
// The row math is combine_row of combine.cuh, which the megakernel shares.
//
// Bound: bytes. It reads (2M+1)*4 bytes and writes (M+6)*4 bytes per row and
// does a few dozen flops, so at B=256 the launch itself dominates. The design
// keeps it to a single pass over each row held in registers.

#include <cuda_runtime.h>

#include "combine.cuh"

namespace {

__global__ void epilogue_kernel(const float* __restrict__ preds,
                                const float* __restrict__ vf,
                                const float* __restrict__ rule,
                                const float* __restrict__ w,
                                const float* __restrict__ cm,
                                float* __restrict__ out, int B, int M,
                                CombineParams c) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float* o = out + (size_t)r * (M + 6);
  combine_row(preds + (size_t)r * M, vf + (size_t)r * M, w, cm, M, rule[r], c,
              o, o + 4, o + 4 + M);
}

// A kernel that does nothing, launched with the epilogue's grid: its time is
// the launch floor the epilogue's device time is held against.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int rtfd_empty(int B, void* stream) {
  const int threads = 128;
  empty_kernel<<<(B + threads - 1) / threads, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtfd_epilogue(const void* preds, const void* vf, const void* rule,
                             const void* w, const void* cm, void* out, int B,
                             int M, int strategy, float fraud_threshold,
                             float confidence_threshold, float decline,
                             float review, float monitor, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const CombineParams c{strategy, fraud_threshold, confidence_threshold,
                        decline, review, monitor};
  epilogue_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(preds), static_cast<const float*>(vf),
      static_cast<const float*>(rule), static_cast<const float*>(w),
      static_cast<const float*>(cm), static_cast<float*>(out), B, M, c);
  return static_cast<int>(cudaGetLastError());
}
