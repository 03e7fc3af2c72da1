// Ensemble combine and decision ladders for one batch row, shared by the
// fused epilogue (epilogue.cu) and the megakernel (megakernel.cu): one
// definition, two kernels, as ops/epilogue.py combine_matrix is the plain
// version of both.
//
// Products and sums use __fmul_rn/__fadd_rn so the compiler cannot contract
// them into FMAs: the rounding then follows the plain PyTorch version step
// by step.
#pragma once

#include <cuda_runtime.h>

struct CombineParams {
  int strategy;                 // 0 weighted_average, 1 voting, 2 stacking
  float fraud_threshold;
  float confidence_threshold;
  float decline, review, monitor;
};

__device__ __forceinline__ float combine_ladder(float p, float decline,
                                               float review, float monitor) {
  // APPROVE 0, APPROVE_WITH_MONITORING 1, REVIEW 2, DECLINE 3
  return p >= decline ? 3.f : (p >= review ? 2.f : (p >= monitor ? 1.f : 0.f));
}

__device__ __forceinline__ float combine_risk_code(float p) {
  // RISK_LEVEL_THRESHOLDS (0.3, 0.6, 0.8, 0.95): VERY_LOW 0 .. CRITICAL 4
  return (p >= 0.3f ? 1.f : 0.f) + (p >= 0.6f ? 1.f : 0.f) +
         (p >= 0.8f ? 1.f : 0.f) + (p >= 0.95f ? 1.f : 0.f);
}

// Blends the M probabilities ``p_row`` under the validity mask ``v_row``
// with the weights ``w`` and confidence multipliers ``cm``, and writes
//   head[0..3]    prob, confidence, decision, risk
//   contrib[0..M) the explanation contributions w * p
//   rule_out[0,1] the rules-only decision and risk over ``rule``
// (ints ride as exact small floats). Each operand is anything indexed by
// [m]: a pointer into global or shared memory (the megakernel) or an array
// held in registers (the epilogue, whose weights arrive by value); with M a
// compile-time constant the loops unroll and the arrays stay in registers.
template <typename PRow, typename VRow, typename WVec, typename CVec>
__device__ __forceinline__ void combine_row(const PRow& p_row,
                                            const VRow& v_row,
                                            const WVec& w, const CVec& cm,
                                            int M, float rule,
                                            const CombineParams& c,
                                            float* head, float* contrib,
                                            float* rule_out) {
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
    votes = __fadd_rn(votes, __fmul_rn(p > c.fraud_threshold ? 1.f : 0.f, v));
    conf_total = __fadd_rn(conf_total, conf);
    pc = __fadd_rn(pc, __fmul_rn(p, conf));
  }
  const float wa_prob = w_total > 0.f ? pw / fmaxf(w_total, 1e-12f) : 0.5f;
  const float wa_conf = w_total > 0.f ? cw / fmaxf(w_total, 1e-12f) : 0.f;
  float prob, confidence;
  if (c.strategy == 0) {          // weighted_average
    prob = wa_prob;
    confidence = wa_conf;
  } else if (c.strategy == 1) {   // voting
    prob = n_valid > 0.f ? votes / fmaxf(n_valid, 1.f) : 0.f;
    confidence = n_valid > 0.f ? conf_total / fmaxf(n_valid, 1.f) : 0.f;
  } else {                        // stacking, weighted average at zero confidence
    prob = conf_total > 0.f ? pc / fmaxf(conf_total, 1e-12f) : wa_prob;
    confidence = conf_total > 0.f ? conf_total / fmaxf(n_valid, 1.f) : wa_conf;
  }

  head[0] = prob;
  head[1] = confidence;
  head[2] = confidence < c.confidence_threshold
                ? 2.f
                : combine_ladder(prob, c.decline, c.review, c.monitor);
  head[3] = combine_risk_code(prob);
  for (int m = 0; m < M; ++m) contrib[m] = __fmul_rn(w[m], p_row[m]);
  rule_out[0] = combine_ladder(rule, c.decline, c.review, c.monitor);
  rule_out[1] = combine_risk_code(rule);
}
