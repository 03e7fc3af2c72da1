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
//
// Bound: bytes. It reads (2M+1)*4 bytes and writes (M+6)*4 bytes per row and
// does a few dozen flops, so at B=256 the launch itself dominates. The design
// keeps it to a single pass over each row held in registers. Products and
// sums use __fmul_rn/__fadd_rn so the compiler cannot contract them into
// FMAs: the rounding then follows the plain PyTorch version step by step.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ladder(float p, float decline, float review,
                                        float monitor) {
  // APPROVE 0, APPROVE_WITH_MONITORING 1, REVIEW 2, DECLINE 3
  return p >= decline ? 3.f : (p >= review ? 2.f : (p >= monitor ? 1.f : 0.f));
}

__device__ __forceinline__ float risk_code(float p) {
  // RISK_LEVEL_THRESHOLDS (0.3, 0.6, 0.8, 0.95): VERY_LOW 0 .. CRITICAL 4
  return (p >= 0.3f ? 1.f : 0.f) + (p >= 0.6f ? 1.f : 0.f) +
         (p >= 0.8f ? 1.f : 0.f) + (p >= 0.95f ? 1.f : 0.f);
}

__global__ void epilogue_kernel(const float* __restrict__ preds,
                                const float* __restrict__ vf,
                                const float* __restrict__ rule,
                                const float* __restrict__ w,
                                const float* __restrict__ cm,
                                float* __restrict__ out, int B, int M,
                                int strategy, float fraud_threshold,
                                float confidence_threshold, float decline,
                                float review, float monitor) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const float* p_row = preds + (size_t)r * M;
  const float* v_row = vf + (size_t)r * M;

  float w_total = 0.f, pw = 0.f, cw = 0.f;          // weighted average
  float n_valid = 0.f, votes = 0.f;                 // voting
  float conf_total = 0.f, pc = 0.f;                 // stacking
  for (int m = 0; m < M; ++m) {
    const float p = p_row[m];
    const float v = v_row[m];
    const float conf =
        __fmul_rn(fminf(1.f, __fmul_rn(__fmul_rn(fabsf(p - 0.5f), 2.f), cm[m])), v);
    const float wm = __fmul_rn(w[m], v);
    w_total = __fadd_rn(w_total, wm);
    pw = __fadd_rn(pw, __fmul_rn(p, wm));
    cw = __fadd_rn(cw, __fmul_rn(conf, wm));
    n_valid = __fadd_rn(n_valid, v);
    votes = __fadd_rn(votes, __fmul_rn(p > fraud_threshold ? 1.f : 0.f, v));
    conf_total = __fadd_rn(conf_total, conf);
    pc = __fadd_rn(pc, __fmul_rn(p, conf));
  }
  const float wa_prob = w_total > 0.f ? pw / fmaxf(w_total, 1e-12f) : 0.5f;
  const float wa_conf = w_total > 0.f ? cw / fmaxf(w_total, 1e-12f) : 0.f;
  float prob, confidence;
  if (strategy == 0) {            // weighted_average
    prob = wa_prob;
    confidence = wa_conf;
  } else if (strategy == 1) {     // voting
    prob = n_valid > 0.f ? votes / fmaxf(n_valid, 1.f) : 0.f;
    confidence = n_valid > 0.f ? conf_total / fmaxf(n_valid, 1.f) : 0.f;
  } else {                        // stacking, weighted average at zero confidence
    prob = conf_total > 0.f ? pc / fmaxf(conf_total, 1e-12f) : wa_prob;
    confidence = conf_total > 0.f ? conf_total / fmaxf(n_valid, 1.f) : wa_conf;
  }

  float* o = out + (size_t)r * (M + 6);
  o[0] = prob;
  o[1] = confidence;
  o[2] = confidence < confidence_threshold ? 2.f
                                           : ladder(prob, decline, review, monitor);
  o[3] = risk_code(prob);
  for (int m = 0; m < M; ++m) o[4 + m] = __fmul_rn(w[m], p_row[m]);
  const float rs = rule[r];
  o[4 + M] = ladder(rs, decline, review, monitor);
  o[5 + M] = risk_code(rs);
}

}  // namespace

extern "C" int rtfd_epilogue(const void* preds, const void* vf, const void* rule,
                             const void* w, const void* cm, void* out, int B,
                             int M, int strategy, float fraud_threshold,
                             float confidence_threshold, float decline,
                             float review, float monitor, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  epilogue_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(preds), static_cast<const float*>(vf),
      static_cast<const float*>(rule), static_cast<const float*>(w),
      static_cast<const float*>(cm), static_cast<float*>(out), B, M, strategy,
      fraud_threshold, confidence_threshold, decline, review, monitor);
  return static_cast<int>(cudaGetLastError());
}
