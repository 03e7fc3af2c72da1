// Persistent ensemble megakernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel realtime_fraud_detection_tpu/ops/megakernel.py
// fused_megakernel (_mega_call, body at :318, pallas_call at :352): one
// launch scores a whole packed microbatch. Per transaction it computes the
// rule score and key factors, the GBDT (100 trees) and isolation forest
// (100 trees) leaves, the LSTM over the front-padded history, the bipartite
// GNN with masked neighbour means, the BERT text branch (int8 or f32
// weights) and the ensemble combine with its ladders, and writes one row of
// the extended packed matrix [B, 2M+10]:
//   prob, confidence, decision, risk, rule_score, high_amount, unusual_hour,
//   high_risk_payment, preds[M], contributions[M], rule_decision, rule_risk.
// No branch intermediate reaches device memory. The plain version is
// ops/megakernel.py megakernel_reference.
//
// Design. The TPU grid walks batch blocks in order on one core; here a
// persistent grid of min(B, #SMs) CTAs of 256 threads strides over rows, one
// transaction per CTA iteration, every stage in shared memory:
//  1. rule score and key factors (one thread);
//  2. trees and 3. isolation forest: one thread per tree descends to its
//     leaf (x >= threshold goes right, a +inf threshold is unsplit), which is
//     the leaf the GEMM form selects; leaves are summed in tree order;
//  4. LSTM: per step a thread computes gate columns over [x_t ; h], then a
//     thread per unit updates c and h (masked steps are skipped: the state
//     is kept, as the reference's where does);
//  5. GNN: frontier, masked means, SAGE layer and head, one output each;
//  6. BERT: dequantized embedding rows + positions, LN, then per layer the
//     q/k/v dense, masked softmax attention (a warp per query row), o dense,
//     residual LN, FFN with tanh GELU, residual LN. The last layer computes
//     q, attention, o and the FFN for [CLS] only: nothing else reads them.
//     Dense layers stage 32-deep weight tiles (dequantized, bf16-rounded) in
//     shared memory; a warp owns up to 8 token rows and a lane up to 8
//     output columns, with f32 accumulators in registers;
//  7. combine_row (combine.cuh, shared with epilogue.cu) and the row write.
// A pruned branch (bit clear in mega_valid) does no work and writes 0.0.
// Shared memory is x, q, the k|v region (k padded to H+1 columns so the
// score loop is free of bank conflicts; the FFN activations reuse k|v) and
// one scratch region: 165 KB at TINY width, one CTA per SM.
//
// Rounding follows core/precision.py matmul_cd: products of bf16-rounded
// operands are exact in f32, sums are f32, the dense output is rounded once
// to bf16 and the bias added in f32; LN, softmax, GELU and the heads are
// f32. Built without fast math.
//
// Bound. At TINY width a bucket-256 batch needs ~6.4 GFLOP of products
// (BERT at [CLS]-only last layer plus the LSTM steps) and ~7 MB of traffic
// (5.3 MB of int8 parameters, the packed inputs, the output): it is bound
// by operations, ~6.5 us at the bf16 tensor-core peak. This first version
// runs its products as scalar FMAs, whose peak is 15x lower, and re-reads
// the weights from L2 for every row; tensor-core tiles (wgmma) and several
// rows per weight tile are the way to that bound, in later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "combine.cuh"

#define MEGA_THREADS 256
#define MEGA_WARPS (MEGA_THREADS / 32)
#define MEGA_KC 32
#define MEGA_NUM_MODELS 5
#define MEGA_MAX_LAYERS 8
#define MEGA_MAX_TEXT 64
#define MEGA_MAX_WIDTH 256
#define MEGA_MAX_HEAD_DIM 64
#define MEGA_SMEM_LIMIT 232448

// Batch leaves, in the order of ops/megakernel.py MEGA_INPUTS.
enum MegaInput {
  IN_PRIOR_FRAUD_SCORE,
  IN_HAS_USER,
  IN_USER_RISK_SCORE,
  IN_ACCOUNT_AGE_DAYS,
  IN_USER_VERIFIED,
  IN_MERCHANT_FRAUD_RATE,
  IN_MERCHANT_RISK_CODE,
  IN_MERCHANT_BLACKLISTED,
  IN_MERCHANT_HIGH_RISK_CATEGORY,
  IN_HAS_MERCHANT,
  IN_USER_AVG_AMOUNT,
  IN_AMOUNT,
  IN_HAS_TXN_FINGERPRINT,
  IN_HAS_DEVICE_LIST,
  IN_KNOWN_DEVICE,
  IN_HOUR_OF_DAY,
  IN_HAS_OP_HOURS,
  IN_MERCHANT_OP_START,
  IN_MERCHANT_OP_END,
  IN_HIGH_RISK_PAYMENT,
  IN_FEATURES,
  IN_HISTORY,
  IN_HISTORY_LEN,
  IN_USER_FEAT,
  IN_MERCHANT_FEAT,
  IN_USER_NEIGH_FEAT,
  IN_USER_NEIGH_MASK,
  IN_MERCH_NEIGH_FEAT,
  IN_MERCH_NEIGH_MASK,
  IN_TOKEN_IDS,
  IN_TOKEN_MASK,
  IN_VALID,
  IN_COUNT
};

enum DenseSite { D_Q, D_K, D_V, D_O, D_FFN1, D_FFN2 };

// ops/megakernel.py MegaArgs mirrors this struct field for field.
struct MegaArgs {
  const void* inp[IN_COUNT];
  long long inp_stride[IN_COUNT];
  const void* tree_feature;
  const void* tree_threshold;
  const void* tree_leaf;
  const void* tree_base;
  const void* if_feature;
  const void* if_threshold;
  const void* if_path;
  const void* if_cpsi;
  const void* lstm_w_gates;
  const void* lstm_b_gates;
  const void* lstm_w_head1;
  const void* lstm_b_head1;
  const void* lstm_w_head2;
  const void* lstm_b_head2;
  const void* gnn_w_sage1;
  const void* gnn_b_sage1;
  const void* gnn_w_sage2;
  const void* gnn_b_sage2;
  const void* gnn_w_head1;
  const void* gnn_b_head1;
  const void* gnn_w_head2;
  const void* gnn_b_head2;
  const void* word_emb;
  const void* word_scale;
  const void* pos_emb;
  const void* pos_scale;
  const void* emb_ln_scale;
  const void* emb_ln_bias;
  const void* dense_w[MEGA_MAX_LAYERS][6];
  const void* dense_scale[MEGA_MAX_LAYERS][6];
  const void* dense_b[MEGA_MAX_LAYERS][6];
  const void* ln_scale[MEGA_MAX_LAYERS][2];
  const void* ln_bias[MEGA_MAX_LAYERS][2];
  const void* pre_w;
  const void* pre_b;
  const void* cls_w;
  const void* cls_b;
  const void* weights;
  const void* conf_mult;
  void* out;
  int batch;
  int n_trees;
  int tree_depth;
  int n_iforest;
  int iforest_depth;
  int feat_dim;
  int seq_len;
  int lstm_hidden;
  int lstm_head;
  int node_dim;
  int fanout;
  int gnn_hidden;
  int gnn_head;
  int text_len;
  int hidden;
  int ffn;
  int heads;
  int layers;
  int vocab;
  int max_pos;
  int mega_valid;
  int strategy;
  int int8;
  int bf16;
  float fraud_threshold;
  float confidence_threshold;
  float decline;
  float review;
  float monitor;
  float ln_eps;
  float sqrt_head_dim;
};

static_assert(sizeof(MegaArgs) <= 4096, "kernel parameter limit");

// Shared-memory layout in floats (ops/megakernel.py mega_smem_bytes).
struct MegaLayout {
  int x, q, kv, scr, feat, small, mask, total;
};

__host__ __device__ inline int mega_imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline MegaLayout mega_layout(const MegaArgs& a) {
  const int s = a.text_len, h = a.hidden, f = a.ffn;
  int scr = MEGA_KC * mega_imax(h, f);
  scr = mega_imax(scr, 6 * a.lstm_hidden + a.lstm_head);
  scr = mega_imax(scr, 2 * a.fanout * a.gnn_hidden + 4 * a.gnn_hidden + a.gnn_head);
  scr = mega_imax(scr, mega_imax(a.n_trees, a.n_iforest));
  scr = mega_imax(scr, mega_imax(h, MEGA_WARPS * s));
  MegaLayout l;
  l.x = 0;
  l.q = l.x + s * h;
  l.kv = l.q + s * h;
  l.scr = l.kv + s * mega_imax(2 * h + 1, f);
  l.feat = l.scr + scr;
  l.small = l.feat + a.feat_dim;
  l.mask = l.small + 16;
  l.total = l.mask + s;
  return l;
}

namespace {

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float cd(float x) {
  return BF16 ? bf16r(x) : x;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;   // sqrt(2 / pi)
  const float k_kappa = 0.044715f;
  const float inner = k_beta * (x + k_kappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ const T* in_row(const MegaArgs& a, int f, int r) {
  return static_cast<const T*>(a.inp[f]) + (long long)r * a.inp_stride[f];
}
__device__ __forceinline__ float in_f(const MegaArgs& a, int f, int r) {
  return *in_row<float>(a, f, r);
}
__device__ __forceinline__ int in_i(const MegaArgs& a, int f, int r) {
  return *in_row<int>(a, f, r);
}
__device__ __forceinline__ float in_b(const MegaArgs& a, int f, int r) {
  return *in_row<unsigned char>(a, f, r) != 0 ? 1.f : 0.f;
}
template <typename T>
__device__ __forceinline__ const T* P(const void* p) {
  return static_cast<const T*>(p);
}

// features/rules.py rule_score, one row, rounding op by op as the plain
// version does (no FMA contraction).
__device__ float rule_score_row(const MegaArgs& a, int r) {
  float score = __fmul_rn(0.5f, in_f(a, IN_PRIOR_FRAUD_SCORE, r));
  const float user_known = __fadd_rn(
      __fadd_rn(__fmul_rn(in_f(a, IN_USER_RISK_SCORE, r), 0.2f),
                __fmul_rn(0.1f, in_f(a, IN_ACCOUNT_AGE_DAYS, r) < 30.f ? 1.f : 0.f)),
      __fmul_rn(0.15f, 1.f - in_b(a, IN_USER_VERIFIED, r)));
  const bool has_user = in_b(a, IN_HAS_USER, r) != 0.f;
  score = __fadd_rn(score, has_user ? user_known : 0.35f);

  const float rate = in_f(a, IN_MERCHANT_FRAUD_RATE, r);
  const int risk = in_i(a, IN_MERCHANT_RISK_CODE, r);
  float merch_known = __fadd_rn(__fmul_rn(0.2f, risk == 2 ? 1.f : 0.f),
                                __fmul_rn(0.1f, risk == 1 ? 1.f : 0.f));
  merch_known = __fadd_rn(merch_known,
                          __fmul_rn(0.4f, in_b(a, IN_MERCHANT_BLACKLISTED, r)));
  merch_known = __fadd_rn(merch_known, rate > 0.05f ? __fmul_rn(rate, 2.f) : 0.f);
  merch_known = __fadd_rn(
      merch_known, __fmul_rn(0.15f, in_b(a, IN_MERCHANT_HIGH_RISK_CATEGORY, r)));
  const bool has_merchant = in_b(a, IN_HAS_MERCHANT, r) != 0.f;
  score = __fadd_rn(score, has_merchant ? merch_known : 0.1f);

  const float avg = in_f(a, IN_USER_AVG_AMOUNT, r);
  const bool large = has_user && avg > 0.f &&
                     __fdiv_rn(in_f(a, IN_AMOUNT, r), fmaxf(avg, 1e-9f)) > 5.f;
  const bool new_device = in_b(a, IN_HAS_TXN_FINGERPRINT, r) != 0.f && has_user &&
                          in_b(a, IN_HAS_DEVICE_LIST, r) != 0.f &&
                          in_b(a, IN_KNOWN_DEVICE, r) == 0.f;
  const int hour = in_i(a, IN_HOUR_OF_DAY, r);
  const bool unusual = hour <= 5 || hour >= 23;
  const bool outside = has_merchant && in_b(a, IN_HAS_OP_HOURS, r) != 0.f &&
                       !(hour >= in_i(a, IN_MERCHANT_OP_START, r) &&
                         hour <= in_i(a, IN_MERCHANT_OP_END, r));
  score = __fadd_rn(score, __fmul_rn(0.15f, large ? 1.f : 0.f));
  score = __fadd_rn(score, __fmul_rn(0.1f, new_device ? 1.f : 0.f));
  score = __fadd_rn(score, __fmul_rn(0.05f, unusual ? 1.f : 0.f));
  score = __fadd_rn(score, __fmul_rn(0.1f, outside ? 1.f : 0.f));
  return fminf(fmaxf(score, 0.f), 1.f);
}

// Leaf value of every tree of a complete-tree ensemble into vals[T].
__device__ void tree_leaves(const int* feat, const float* thr, const float* leaf,
                            int n_trees, int depth, const float* x, float* vals) {
  const int n_internal = (1 << depth) - 1;
  for (int t = threadIdx.x; t < n_trees; t += blockDim.x) {
    const int* ft = feat + (size_t)t * n_internal;
    const float* th = thr + (size_t)t * n_internal;
    int node = 0;
    for (int d = 0; d < depth; ++d)
      node = 2 * node + 1 + (x[ft[node]] >= th[node] ? 1 : 0);
    vals[t] = leaf[((size_t)t << depth) + (node - n_internal)];
  }
}

// models/lstm.py lstm_logits -> sigmoid, one row. scr: h, c, z[4LH], head.
template <bool BF16>
__device__ float lstm_row(const MegaArgs& a, int r, float* scr) {
  const int nf = a.feat_dim, lh = a.lstm_hidden, steps = a.seq_len;
  const int g4 = 4 * lh, hh = a.lstm_head;
  float* h = scr;
  float* c = h + lh;
  float* z = c + lh;
  float* z1 = z + g4;
  const float* w = P<float>(a.lstm_w_gates);
  const float* bg = P<float>(a.lstm_b_gates);
  const float* hist = in_row<float>(a, IN_HISTORY, r);
  const int len = in_i(a, IN_HISTORY_LEN, r);
  for (int j = threadIdx.x; j < lh; j += blockDim.x) h[j] = c[j] = 0.f;
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    if (t < steps - len) continue;          // front padding: the state is kept
    const float* xt = hist + (size_t)t * nf;
    for (int n = threadIdx.x; n < g4; n += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < nf; ++k)
        acc = fmaf(cd<BF16>(xt[k]), cd<BF16>(w[(size_t)k * g4 + n]), acc);
      for (int k = 0; k < lh; ++k)
        acc = fmaf(cd<BF16>(h[k]), cd<BF16>(w[(size_t)(nf + k) * g4 + n]), acc);
      z[n] = cd<BF16>(acc) + bg[n];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < lh; j += blockDim.x) {
      const float ig = sigm(z[j]), fg = sigm(z[lh + j]);
      const float g = tanhf(z[2 * lh + j]), og = sigm(z[3 * lh + j]);
      const float cn = __fadd_rn(__fmul_rn(fg, c[j]), __fmul_rn(ig, g));
      c[j] = cn;
      h[j] = __fmul_rn(og, tanhf(cn));
    }
    __syncthreads();
  }
  const float* w1 = P<float>(a.lstm_w_head1);
  const float* b1 = P<float>(a.lstm_b_head1);
  for (int j = threadIdx.x; j < hh; j += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < lh; ++k) acc = fmaf(h[k], w1[(size_t)k * hh + j], acc);
    z1[j] = fmaxf(acc + b1[j], 0.f);
  }
  __syncthreads();
  float logit = 0.f;
  if (threadIdx.x == 0) {
    const float* w2 = P<float>(a.lstm_w_head2);
    for (int j = 0; j < hh; ++j) logit = fmaf(z1[j], w2[j], logit);
    logit = sigm(logit + P<float>(a.lstm_b_head2)[0]);
  }
  return logit;
}

// models/gnn.py gnn_logits (bipartite) -> sigmoid, one row.
// scr: frontier [2][K][G], agg [2][G], h [2][G], head [GH].
__device__ float gnn_row(const MegaArgs& a, int r, const float* x, float* scr) {
  const int d = a.node_dim, k = a.fanout, g = a.gnn_hidden, gh = a.gnn_head;
  const int nf = a.feat_dim;
  float* fr = scr;
  float* agg = fr + 2 * k * g;
  float* hv = agg + 2 * g;
  float* z = hv + 2 * g;
  const float* w1 = P<float>(a.gnn_w_sage1);
  const float* b1 = P<float>(a.gnn_b_sage1);
  const float* w2 = P<float>(a.gnn_w_sage2);
  const float* b2 = P<float>(a.gnn_b_sage2);
  // first SAGE layer over each neighbour: its own two-hop frontier is empty,
  // so the aggregate half of [self ; agg] is zero and only self contributes
  for (int idx = threadIdx.x; idx < 2 * k * g; idx += blockDim.x) {
    const int side = idx / (k * g), kk = (idx / g) % k, gg = idx % g;
    const float* nfeat =
        in_row<float>(a, side ? IN_MERCH_NEIGH_FEAT : IN_USER_NEIGH_FEAT, r) + kk * d;
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(nfeat[j], w1[j * g + gg], acc);
    fr[idx] = fmaxf(acc + b1[gg], 0.f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * g; idx += blockDim.x) {
    const int side = idx / g, gg = idx % g;
    const unsigned char* mask =
        in_row<unsigned char>(a, side ? IN_MERCH_NEIGH_MASK : IN_USER_NEIGH_MASK, r);
    float sum = 0.f, cnt = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float m = mask[kk] ? 1.f : 0.f;
      sum = __fadd_rn(sum, __fmul_rn(fr[(side * k + kk) * g + gg], m));
      cnt = __fadd_rn(cnt, m);
    }
    agg[idx] = __fdiv_rn(sum, fmaxf(cnt, 1.f));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * g; idx += blockDim.x) {
    const int side = idx / g, gg = idx % g;
    const float* self = in_row<float>(a, side ? IN_MERCHANT_FEAT : IN_USER_FEAT, r);
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(self[j], w2[j * g + gg], acc);
    for (int j = 0; j < g; ++j) acc = fmaf(agg[side * g + j], w2[(d + j) * g + gg], acc);
    hv[idx] = fmaxf(acc + b2[gg], 0.f);
  }
  __syncthreads();
  const float* wh = P<float>(a.gnn_w_head1);
  const float* bh = P<float>(a.gnn_b_head1);
  for (int j = threadIdx.x; j < gh; j += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < 2 * g; ++i) acc = fmaf(hv[i], wh[i * gh + j], acc);
    for (int i = 0; i < nf; ++i) acc = fmaf(x[i], wh[(2 * g + i) * gh + j], acc);
    z[j] = fmaxf(acc + bh[j], 0.f);
  }
  __syncthreads();
  float out = 0.f;
  if (threadIdx.x == 0) {
    const float* w = P<float>(a.gnn_w_head2);
    for (int j = 0; j < gh; ++j) out = fmaf(z[j], w[j], out);
    out = sigm(out + P<float>(a.gnn_b_head2)[0]);
  }
  return out;
}

// Y[rows, N] = X[rows, K] @ W[K, N] + b (act 1: tanh GELU), the rounding of
// models/bert.py _dense. W is int8 with per-column scales (I8) or f32.
// A warp owns rows warp + 8i, a lane columns lane + 32j; weight tiles of
// MEGA_KC rows are staged in wtile. Every thread of the block must call it.
template <bool BF16, bool I8>
__device__ void dense(const float* X, int ldx, int rows, int K, const void* wp,
                      const float* scale, const float* bias, int N, float* Y,
                      int ldy, int act, float* wtile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nj = N >> 5;
  const int ri = rows > warp ? (rows - warp + MEGA_WARPS - 1) / MEGA_WARPS : 0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MEGA_KC) {
    const int kc = K - k0 < MEGA_KC ? K - k0 : MEGA_KC;
    __syncthreads();                      // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kc * N; idx += blockDim.x) {
      const int kk = idx / N, n = idx - kk * N;
      const size_t off = (size_t)(k0 + kk) * N + n;
      float w;
      if (I8) {
        w = (float)P<signed char>(wp)[off] * (BF16 ? bf16r(scale[n]) : scale[n]);
      } else {
        w = P<float>(wp)[off];
      }
      wtile[idx] = cd<BF16>(w);
    }
    __syncthreads();
    if (ri > 0) {
      for (int kk = 0; kk < kc; ++kk) {
        float xv[8], wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xv[i] = i < ri ? cd<BF16>(X[(warp + MEGA_WARPS * i) * ldx + k0 + kk]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = j < nj ? wtile[kk * N + lane + 32 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i >= ri) continue;
    const int r = warp + MEGA_WARPS * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= nj) continue;
      const int n = lane + 32 * j;
      float y = cd<BF16>(acc[i][j]) + bias[n];
      if (act == 1) y = gelu_tanh(y);
      Y[r * ldy + n] = y;
    }
  }
}

// x[i] = LN(x[i] + add[i]) for i < rows (add may be null): biased variance,
// a warp per row, rounding op by op.
__device__ void layer_norm_rows(float* x, const float* add, int ldadd, int rows,
                                int h, const float* gamma, const float* beta,
                                float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += MEGA_WARPS) {
    float* xr = x + i * h;
    float vals[8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lane + 32 * j;
      vals[j] = 0.f;
      if (c < h) {
        vals[j] = add ? __fadd_rn(xr[c], add[i * ldadd + c]) : xr[c];
        sum += vals[j];
      }
    }
    const float mu = __fdiv_rn(warp_sum(sum), (float)h);
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (lane + 32 * j < h) {
        const float dv = vals[j] - mu;
        var = __fadd_rn(var, __fmul_rn(dv, dv));
      }
    }
    var = __fdiv_rn(warp_sum(var), (float)h);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lane + 32 * j;
      if (c < h)
        xr[c] = __fadd_rn(__fmul_rn(__fmul_rn(vals[j] - mu, inv), gamma[c]), beta[c]);
    }
  }
}

// Masked softmax attention for query rows < nq, a warp per row; the context
// of head hh overwrites q's head-hh columns of the same row. k has H+1
// columns, v H. scr holds one probability row per warp.
__device__ void attention_rows(float* q, const float* k, const float* v,
                               const float* mask, int nq, int s, int h,
                               int heads, float sqrt_hd, float* scr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = h / heads;
  float* p = scr + warp * s;
  for (int hh = 0; hh < heads; ++hh) {
    for (int i = warp; i < nq; i += MEGA_WARPS) {
      const float* qi = q + i * h + hh * hd;
      float sc[2];
      float mx = neg_inf();
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        sc[jj] = neg_inf();
        if (j < s) {
          const float* kj = k + j * (h + 1) + hh * hd;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qi[d], kj[d], dot);
          sc[jj] = mask[j] != 0.f ? __fdiv_rn(dot, sqrt_hd) : -1e30f;
          mx = fmaxf(mx, sc[jj]);
        }
      }
      mx = warp_max(mx);
      float e[2], sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        e[jj] = lane + 32 * jj < s ? expf(sc[jj] - mx) : 0.f;
        sum += e[jj];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (lane + 32 * jj < s) p[lane + 32 * jj] = __fdiv_rn(e[jj], sum);
      __syncwarp();
      float ctx[2] = {0.f, 0.f};
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) {
          float acc = 0.f;
          for (int j = 0; j < s; ++j) acc = fmaf(p[j], v[j * h + hh * hd + d], acc);
          ctx[dd] = acc;
        }
      }
      __syncwarp();
      float* ci = q + i * h + hh * hd;
#pragma unroll
      for (int dd = 0; dd < 2; ++dd)
        if (lane + 32 * dd < hd) ci[lane + 32 * dd] = ctx[dd];
      __syncwarp();
    }
  }
}

// models/bert.py bert_predict for one row: softmax(logits)[1].
template <bool BF16, bool I8>
__device__ float bert_row(const MegaArgs& a, int r, float* smem, const MegaLayout& l) {
  const int s = a.text_len, h = a.hidden, f = a.ffn;
  float* x = smem + l.x;
  float* q = smem + l.q;
  float* k = smem + l.kv;
  float* v = k + s * (h + 1);
  float* hid = smem + l.kv;
  float* scr = smem + l.scr;
  const float* mask = smem + l.mask;
  const int* ids = in_row<int>(a, IN_TOKEN_IDS, r);
  for (int idx = threadIdx.x; idx < s * h; idx += blockDim.x) {
    const int t = idx / h, c = idx - t * h;
    int tok = ids[t];
    tok = tok < 0 ? 0 : (tok >= a.vocab ? a.vocab - 1 : tok);
    float wv, pv;
    if (I8) {
      wv = (float)P<signed char>(a.word_emb)[(size_t)tok * h + c] *
           P<float>(a.word_scale)[tok];
      pv = (float)P<signed char>(a.pos_emb)[(size_t)t * h + c] * P<float>(a.pos_scale)[t];
    } else {
      wv = P<float>(a.word_emb)[(size_t)tok * h + c];
      pv = P<float>(a.pos_emb)[(size_t)t * h + c];
    }
    x[idx] = wv + pv;
  }
  __syncthreads();
  layer_norm_rows(x, nullptr, 0, s, h, P<float>(a.emb_ln_scale),
                  P<float>(a.emb_ln_bias), a.ln_eps);
  for (int li = 0; li < a.layers; ++li) {
    const int nq = li == a.layers - 1 ? 1 : s;   // last layer: [CLS] only
    const void* const* w = a.dense_w[li];
    const void* const* sc = a.dense_scale[li];
    const void* const* b = a.dense_b[li];
#define MEGA_DENSE(site, X, ldx, rows, K, N, Y, ldy, act)                      \
  dense<BF16, I8>(X, ldx, rows, K, w[site], P<float>(sc[site]),                \
                  P<float>(b[site]), N, Y, ldy, act, scr)
    MEGA_DENSE(D_Q, x, h, nq, h, h, q, h, 0);
    MEGA_DENSE(D_K, x, h, s, h, h, k, h + 1, 0);
    MEGA_DENSE(D_V, x, h, s, h, h, v, h, 0);
    __syncthreads();
    attention_rows(q, k, v, mask, nq, s, h, a.heads, a.sqrt_head_dim, scr);
    MEGA_DENSE(D_O, q, h, nq, h, h, k, h, 0);
    __syncthreads();
    layer_norm_rows(x, k, h, nq, h, P<float>(a.ln_scale[li][0]),
                    P<float>(a.ln_bias[li][0]), a.ln_eps);
    MEGA_DENSE(D_FFN1, x, h, nq, h, f, hid, f, 1);
    MEGA_DENSE(D_FFN2, hid, f, nq, f, h, q, h, 0);
    __syncthreads();
    layer_norm_rows(x, q, h, nq, h, P<float>(a.ln_scale[li][1]),
                    P<float>(a.ln_bias[li][1]), a.ln_eps);
#undef MEGA_DENSE
  }
  __syncthreads();
  const float* pw = P<float>(a.pre_w);
  const float* pb = P<float>(a.pre_b);
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < h; ++c) acc = fmaf(x[c], pw[c * h + j], acc);
    scr[j] = fmaxf(acc + pb[j], 0.f);
  }
  __syncthreads();
  float prob = 0.f;
  if (threadIdx.x == 0) {
    const float* cw = P<float>(a.cls_w);
    const float* cb = P<float>(a.cls_b);
    float l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < h; ++j) {
      l0 = fmaf(scr[j], cw[2 * j], l0);
      l1 = fmaf(scr[j], cw[2 * j + 1], l1);
    }
    l0 += cb[0];
    l1 += cb[1];
    const float m = fmaxf(l0, l1);
    const float e0 = expf(l0 - m), e1 = expf(l1 - m);
    prob = __fdiv_rn(e1, e0 + e1);
  }
  return prob;
}

template <bool BF16, bool I8>
__global__ void __launch_bounds__(MEGA_THREADS, 1)
    megakernel(const __grid_constant__ MegaArgs a) {
  extern __shared__ float smem[];
  const MegaLayout l = mega_layout(a);
  float* feat = smem + l.feat;
  float* small = smem + l.small;   // preds[5], rule, key factors[3]
  float* mask = smem + l.mask;
  float* scr = smem + l.scr;
  const int mv = a.mega_valid;
  const int width = 2 * MEGA_NUM_MODELS + 10;

  for (int r = blockIdx.x; r < a.batch; r += gridDim.x) {
    const float* xr = in_row<float>(a, IN_FEATURES, r);
    const unsigned char* tm = in_row<unsigned char>(a, IN_TOKEN_MASK, r);
    for (int i = threadIdx.x; i < a.feat_dim; i += blockDim.x) feat[i] = xr[i];
    for (int i = threadIdx.x; i < a.text_len; i += blockDim.x) mask[i] = tm[i] ? 1.f : 0.f;
    if (threadIdx.x < MEGA_NUM_MODELS) small[threadIdx.x] = 0.f;
    if (threadIdx.x == 0) {
      small[5] = rule_score_row(a, r);
      const int hour = in_i(a, IN_HOUR_OF_DAY, r);
      small[6] = in_f(a, IN_AMOUNT, r) > 10000.f ? 1.f : 0.f;
      small[7] = (hour < 6 || hour >= 23) ? 1.f : 0.f;
      small[8] = in_b(a, IN_HIGH_RISK_PAYMENT, r);
    }
    __syncthreads();

    if (mv & 1) {                                   // xgboost_primary
      tree_leaves(P<int>(a.tree_feature), P<float>(a.tree_threshold),
                  P<float>(a.tree_leaf), a.n_trees, a.tree_depth, feat, scr);
      __syncthreads();
      if (threadIdx.x == 0) {
        float sum = 0.f;
        for (int t = 0; t < a.n_trees; ++t) sum += scr[t];
        small[0] = sigm(P<float>(a.tree_base)[0] + sum);
      }
      __syncthreads();
    }
    if (mv & 16) {                                  // isolation_forest
      tree_leaves(P<int>(a.if_feature), P<float>(a.if_threshold),
                  P<float>(a.if_path), a.n_iforest, a.iforest_depth, feat, scr);
      __syncthreads();
      if (threadIdx.x == 0) {
        float sum = 0.f;
        for (int t = 0; t < a.n_iforest; ++t) sum += scr[t];
        const float mean = __fdiv_rn(sum, (float)a.n_iforest);
        const float score = exp2f(__fdiv_rn(-mean, P<float>(a.if_cpsi)[0]));
        small[4] = __fdiv_rn(1.f, 1.f + expf(0.5f - score));
      }
      __syncthreads();
    }
    if (mv & 2) {                                   // lstm_sequential
      const float p = lstm_row<BF16>(a, r, scr);
      if (threadIdx.x == 0) small[1] = p;
      __syncthreads();
    }
    if (mv & 8) {                                   // graph_neural
      const float p = gnn_row(a, r, feat, scr);
      if (threadIdx.x == 0) small[3] = p;
      __syncthreads();
    }
    if (mv & 4) {                                   // bert_text
      const float p = bert_row<BF16, I8>(a, r, smem, l);
      if (threadIdx.x == 0) small[2] = p;
      __syncthreads();
    }

    if (threadIdx.x == 0) {
      const float valid = in_b(a, IN_VALID, r);
      float vf[MEGA_NUM_MODELS];
      for (int m = 0; m < MEGA_NUM_MODELS; ++m)
        vf[m] = __fmul_rn(valid, (mv >> m) & 1 ? 1.f : 0.f);
      const CombineParams c{a.strategy, a.fraud_threshold, a.confidence_threshold,
                            a.decline, a.review, a.monitor};
      float* o = static_cast<float*>(a.out) + (size_t)r * width;
      combine_row(small, vf, P<float>(a.weights), P<float>(a.conf_mult),
                  MEGA_NUM_MODELS, small[5], c, o, o + 8 + MEGA_NUM_MODELS,
                  o + 8 + 2 * MEGA_NUM_MODELS);
      o[4] = small[5];
      o[5] = small[6];
      o[6] = small[7];
      o[7] = small[8];
      for (int m = 0; m < MEGA_NUM_MODELS; ++m) o[8 + m] = small[m];
    }
    __syncthreads();                                // smem is reused next row
  }
}

template <bool BF16, bool I8>
int launch(const MegaArgs& a, int grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      megakernel<BF16, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  megakernel<BF16, I8><<<grid, MEGA_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtfd_megakernel_smem_bytes(const void* args) {
  return mega_layout(*static_cast<const MegaArgs*>(args)).total * (int)sizeof(float);
}

extern "C" int rtfd_megakernel(const void* args, int grid, void* stream) {
  const MegaArgs& a = *static_cast<const MegaArgs*>(args);
  const size_t smem = (size_t)mega_layout(a).total * sizeof(float);
  if (smem > MEGA_SMEM_LIMIT || grid <= 0 || a.layers > MEGA_MAX_LAYERS ||
      a.text_len > MEGA_MAX_TEXT || a.hidden > MEGA_MAX_WIDTH ||
      a.ffn > MEGA_MAX_WIDTH || a.hidden % 32 || a.ffn % 32 || a.heads <= 0 ||
      a.hidden % a.heads || a.hidden / a.heads > MEGA_MAX_HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.bf16) return a.int8 ? launch<true, true>(a, grid, smem, st)
                            : launch<true, false>(a, grid, smem, st);
  return a.int8 ? launch<false, true>(a, grid, smem, st)
                : launch<false, false>(a, grid, smem, st);
}
