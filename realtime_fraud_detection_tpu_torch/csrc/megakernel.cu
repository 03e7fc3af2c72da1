// Persistent ensemble megakernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel realtime_fraud_detection_tpu/ops/megakernel.py
// fused_megakernel (_mega_call, body at :318, pallas_call at :352): one
// launch scores a whole packed microbatch. Per transaction it computes the
// rule score and key factors, the GBDT (100 trees) and isolation forest
// (100 trees) leaves, the LSTM over the front-padded history, the GNN with
// masked neighbour means (bipartite, or typed: every node row first goes
// through its node type's (D, D) projection, models/gnn.py
// typed_node_projection, and the transaction features are clipped to
// [-10, 10]), the BERT text branch (int8 or f32
// weights) and the ensemble combine with its ladders, and writes one row of
// the extended packed matrix [B, 2M+10]:
//   prob, confidence, decision, risk, rule_score, high_amount, unusual_hour,
//   high_risk_payment, preds[M], contributions[M], rule_decision, rule_risk.
// No branch intermediate reaches device memory. The plain version is
// ops/megakernel.py megakernel_reference.
//
// Design (bf16 compute, megakernel_tc, the served path). A persistent grid
// of CTAs of 256 threads walks groups of up to MEGA_MAX_ROWS transactions:
// at bucket 256 on 132 SMs each of 128 CTAs scores two rows together, below
// that one row each. Every stage works on all of the group's rows at once:
//  1. rule score and key factors (a thread per row);
//  2. trees and 3. isolation forest: a thread per (row, tree) descends to
//     its leaf (x >= threshold goes right, a +inf threshold is unsplit),
//     the leaf the GEMM form selects; leaves are summed in tree order;
//  4. LSTM: w_gates is widened to bf16 into shared memory once per group,
//     then each step's gate product [x_t ; h] @ W runs on the tensor cores
//     (mma.sync m16n8k16, the group's rows in one 16-row tile) and a thread
//     per (row, unit) updates c and h (masked steps keep the state);
//  5. GNN: its weights are staged in shared memory once per group; typed
//     parameters project the group's centre and neighbour rows into shared
//     memory first (a thread per output element, the four type matrices
//     blended by the row's tag slots); then frontier, masked means, SAGE
//     layer and head as scalar f32 FMAs;
//  6. BERT: dequantized embedding rows + positions, LN (a half-warp per
//     row), then per layer the q/k/v dense, masked softmax attention (f32
//     as the reference; a warp per (row, head, eight queries), so each k
//     and v element read serves eight queries), o dense, residual LN, FFN
//     with tanh GELU, residual LN. The last layer computes q, attention, o and the FFN for
//     the [CLS] rows only. Every dense layer runs on the tensor cores
//     (mma.sync m16n8k16 bf16 -> f32): its weight streams in chunks of
//     MEGA_KC rows x MEGA_NP columns; raw int8 chunks come in by cp.async
//     into a two-deep ring and each is widened once per group (exactly:
//     f32(q) * bf16(scale), rounded to bf16) into a padded [k][n] tile read
//     by ldmatrix.trans, while the previous chunk's products run. The 8
//     warps split the group's tokens and the columns (at the [CLS] rows all
//     8 split the columns). Dense outputs are stored as bf16(acc), the
//     value matmul_cd rounds to, with the bias added in f32 by the reader
//     (attention, LN, GELU), so q/k/v/o/FFN activations take 2 bytes each;
//  7. combine_row (combine.cuh, shared with epilogue.cu) and the row write.
// A pruned branch (bit clear in mega_valid) does no work and writes 0.0.
//
// Shared memory (mega_layout_tc, mirrored by ops/megakernel.py): x f32
// [R*S, H+8]; the bf16 activations q|k|v [3, R*S, H+2] (rows of an odd
// word count, so a lane per key reads k without bank conflicts), reused by
// the FFN hidden [R*S, F+8] and the FFN output; the widened weight ring
// [2, KC, NP+8] bf16 (between dense layers it holds attention's per-warp
// scratch); the raw ring [2, KC, NP] i8. The staged LSTM weights and
// history, the GNN weights and the tree leaves reuse the same region before
// BERT runs. Then per-row features, masks, slots and the [CLS] head.
// 225,920 B at TINY width with two rows (207,424 B with one, where the
// staged LSTM weight is the largest stage), one CTA per SM.
//
// f32 compute (megakernel_f32, not on the served path) keeps the first
// design: one row per CTA iteration, scalar FMA dense over 32-deep weight
// tiles (mega_layout_f32).
//
// Rounding follows core/precision.py matmul_cd: products of bf16-rounded
// operands are exact in f32, sums are f32 (on the tensor cores in another
// order than the scalar loop, so a bf16 output can move by one ulp), the
// dense output is rounded once to bf16 and the bias added in f32; LN,
// softmax, GELU, attention and the heads are f32. Built without fast math.
//
// Bound. At TINY width a bucket-256 batch needs ~6.3 GFLOP of products
// (BERT at [CLS]-only last layer plus the LSTM steps) and ~7 MB of traffic
// (5.3 MB of int8 parameters, the packed inputs, the output): it is bound
// by operations, ~6.4 us at the bf16 tensor-core peak. What still stands
// between this design and that bound: attention and the GNN are scalar f32
// FMAs (the reference's f32 attention has no exact bf16 tensor-core form),
// the dense layers use mma.sync with one barrier per weight chunk rather
// than wgmma, and each CTA's rows are scored serially through the branches
// with the whole CTA on one stage at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "combine.cuh"

// Phase stamps, compiled in only with -DMEGA_PHASES (megakernel_phases.py):
// at each phase boundary of the bf16 path all threads meet at a barrier and
// thread 0 of block 0 records %globaltimer; rtfd_megakernel_phases reads
// the stamps back and clears them. Other builds compile MEGA_PHASE() away.
#ifdef MEGA_PHASES
__device__ unsigned long long mega_ph[256];
__device__ int mega_ph_n;
#define MEGA_PHASE()                                                     \
  do {                                                                   \
    __syncthreads();                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0 && mega_ph_n < 256) {        \
      unsigned long long t;                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));              \
      mega_ph[mega_ph_n++] = t;                                          \
    }                                                                    \
  } while (0)
#else
#define MEGA_PHASE() \
  do {               \
  } while (0)
#endif

#define MEGA_THREADS 256
#define MEGA_WARPS (MEGA_THREADS / 32)
#define MEGA_MAX_ROWS 2
#define MEGA_KC 64
#define MEGA_NP 128
#define MEGA_KC_F32 32
#define MEGA_NUM_MODELS 5
#define MEGA_MAX_LAYERS 8
#define MEGA_MAX_TEXT 64
#define MEGA_MAX_WIDTH 256     // the hidden width (LN keeps 8 values a lane)
#define MEGA_MAX_FFN 1024      // the FFN width (column passes of 256 / MEGA_NP)
#define MEGA_MAX_HEAD_DIM 64
#define MEGA_MAX_LSTM 128
#ifndef MEGA_ATT_Q
#define MEGA_ATT_Q 8      // a multiple of 4 (-DMEGA_ATT_Q=4 builds the variant)
#endif
// floats of one warp's attention scratch: queries, probabilities, biases
#define MEGA_ATT_SCRATCH ((MEGA_MAX_HEAD_DIM + MEGA_MAX_TEXT) * MEGA_ATT_Q + 2 * MEGA_MAX_HEAD_DIM)
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
  const void* gnn_w_node[4];      // typed GNN: user, merchant, device, ip
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
  int gnn_typed;
  float fraud_threshold;
  float confidence_threshold;
  float decline;
  float review;
  float monitor;
  float ln_eps;
  float sqrt_head_dim;
};

static_assert(sizeof(MegaArgs) <= 4096, "kernel parameter limit");

__host__ __device__ inline int mega_imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int mega_al16(int bytes) { return (bytes + 15) & ~15; }

// f32-compute layout in floats (ops/megakernel.py mega_smem_bytes_f32).
struct MegaLayout {
  int x, q, kv, scr, feat, small, mask, total;
};

__host__ __device__ inline MegaLayout mega_layout_f32(const MegaArgs& a) {
  const int s = a.text_len, h = a.hidden, f = a.ffn;
  int scr = MEGA_KC_F32 * mega_imax(h, f);
  scr = mega_imax(scr, 6 * a.lstm_hidden + a.lstm_head);
  scr = mega_imax(scr, 2 * a.fanout * a.gnn_hidden + 4 * a.gnn_hidden + a.gnn_head +
                           2 * (a.fanout + 1) * a.node_dim);
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

// Tensor-core layout for `rows` rows per CTA iteration, in bytes, every
// region 16-byte aligned (ops/megakernel.py mega_smem_bytes_tc). Row
// strides: x H+8 floats, q|k|v and the FFN output H+2 halves, the FFN
// hidden F+8 halves, the widened weight NP+8 halves, the staged w_gates
// 4*LH+8 halves.
struct MegaLayoutTc {
  int ldx, ldq, ldf, ldg;
  int x, act, wide, raw;                        // BERT
  int wg, xh, hist, z, hc, lhead;               // LSTM (reuses BERT's region)
  int ws1, ws2, wh1, fr, agg, hv, gz, pj;       // GNN (reuses BERT's region)
  int leaves;                                   // trees (reuses BERT's region)
  int feat, mask, small, cls, total;            // per-row tail
};

__host__ __device__ inline MegaLayoutTc mega_layout_tc(const MegaArgs& a, int rows) {
  const int s = a.text_len, h = a.hidden, f = a.ffn, rs = rows * s;
  const int fd = a.feat_dim, lh = a.lstm_hidden, d = a.node_dim, g = a.gnn_hidden;
  MegaLayoutTc l;
  l.ldx = h + 8;
  l.ldq = h + 2;
  l.ldf = f + 8;
  l.ldg = 4 * lh + 8;
  l.x = 0;
  l.act = l.x + mega_al16(rs * l.ldx * 4);
  const int act = mega_imax(3 * mega_al16(rs * l.ldq * 2),
                            mega_al16(rs * l.ldf * 2) + mega_al16(rs * l.ldq * 2));
  l.wide = l.act + act;
  // the ring also holds attention's per-warp scratch between dense layers
  l.raw = l.wide + mega_imax(2 * mega_al16(MEGA_KC * (MEGA_NP + 8) * 2),
                             MEGA_WARPS * MEGA_ATT_SCRATCH * 4);
  int end = l.raw + 2 * MEGA_KC * MEGA_NP;
  l.wg = 0;
  l.xh = l.wg + mega_al16((fd + lh) * l.ldg * 2);
  l.hist = l.xh + mega_al16(rows * (fd + lh) * 4);
  l.z = l.hist + mega_al16(rows * a.seq_len * fd * 4);
  l.hc = l.z + mega_al16(rows * 4 * lh * 4);
  l.lhead = l.hc + mega_al16(rows * 2 * lh * 4);
  end = mega_imax(end, l.lhead + mega_al16(rows * a.lstm_head * 4));
  l.ws1 = 0;
  l.ws2 = l.ws1 + mega_al16(d * g * 4);
  l.wh1 = l.ws2 + mega_al16((d + g) * g * 4);
  l.fr = l.wh1 + mega_al16((2 * g + fd) * a.gnn_head * 4);
  l.agg = l.fr + mega_al16(rows * 2 * a.fanout * g * 4);
  l.hv = l.agg + mega_al16(rows * 2 * g * 4);
  l.gz = l.hv + mega_al16(rows * 2 * g * 4);
  l.pj = l.gz + mega_al16(rows * a.gnn_head * 4);
  end = mega_imax(end, l.pj + mega_al16(rows * 2 * (a.fanout + 1) * d * 4));
  l.leaves = 0;
  end = mega_imax(end, mega_al16(rows * mega_imax(a.n_trees, a.n_iforest) * 4));
  l.feat = end;
  l.mask = l.feat + mega_al16(rows * fd * 4);
  l.small = l.mask + mega_al16(rows * s * 4);
  l.cls = l.small + mega_al16(rows * 16 * 4);
  l.total = l.cls + mega_al16(rows * h * 4);
  return l;
}

// The shared memory the plan charges: the larger of the one-row
// tensor-core layout and the f32-compute layout.
__host__ __device__ inline int mega_plan_smem_bytes(const MegaArgs& a) {
  return mega_imax(mega_layout_tc(a, 1).total, mega_layout_f32(a).total * 4);
}

namespace {

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// Leaf value of every (row, tree) of a complete-tree ensemble into
// vals[r * n_trees + t], for the group's nr rows of features feat[r * fd].
__device__ void tree_leaves_rows(const int* feat_idx, const float* thr, const float* leaf,
                                 int n_trees, int depth, const float* feat, int fd, int nr,
                                 float* vals) {
  const int n_internal = (1 << depth) - 1;
  for (int idx = threadIdx.x; idx < nr * n_trees; idx += blockDim.x) {
    const int r = idx / n_trees, t = idx - r * n_trees;
    const float* x = feat + r * fd;
    const int* ft = feat_idx + (size_t)t * n_internal;
    const float* th = thr + (size_t)t * n_internal;
    int node = 0;
    for (int d = 0; d < depth; ++d) node = 2 * node + 1 + (x[ft[node]] >= th[node] ? 1 : 0);
    vals[idx] = leaf[((size_t)t << depth) + (node - n_internal)];
  }
}

// models/lstm.py lstm_logits -> sigmoid, one row. scr: h, c, z[4LH], head.
__device__ float lstm_row_f32(const MegaArgs& a, int r, float* scr) {
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
        acc = fmaf(xt[k], w[(size_t)k * g4 + n], acc);
      for (int k = 0; k < lh; ++k)
        acc = fmaf(h[k], w[(size_t)(nf + k) * g4 + n], acc);
      z[n] = acc + bg[n];
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

// A GNN node row of row r: side 0 the user's, 1 the merchant's; n 0 the
// centre, 1..K its neighbours.
__device__ __forceinline__ const float* gnn_node(const MegaArgs& a, int r, int side, int n) {
  if (n == 0) return in_row<float>(a, side ? IN_MERCHANT_FEAT : IN_USER_FEAT, r);
  return in_row<float>(a, side ? IN_MERCH_NEIGH_FEAT : IN_USER_NEIGH_FEAT, r) +
         (n - 1) * a.node_dim;
}

// models/gnn.py typed_node_projection for the nodes of nr rows (from row
// r0) into pj[((r * 2 + side) * (K + 1) + n) * D + j], a thread per output
// element: the user / merchant / device / ip matrices weighted by the row's
// tags (slots 8, 9, 10; users untagged), each product an f32 dot in the
// plain version's order. Every thread of the block must call it.
__device__ void gnn_project(const MegaArgs& a, int r0, int nr, float* pj) {
  const int d = a.node_dim, k1 = a.fanout + 1;
  const float* wu = P<float>(a.gnn_w_node[0]);
  const float* wm = P<float>(a.gnn_w_node[1]);
  const float* wd = P<float>(a.gnn_w_node[2]);
  const float* wi = P<float>(a.gnn_w_node[3]);
  for (int idx = threadIdx.x; idx < nr * 2 * k1 * d; idx += blockDim.x) {
    const int j = idx % d, node = idx / d;
    const int n = node % k1, side = (node / k1) & 1, r = node / (2 * k1);
    const float* x = gnn_node(a, r0 + r, side, n);
    const float tm = x[8], td = x[9], ti = x[10];
    const float tu = fminf(fmaxf(__fsub_rn(__fsub_rn(__fsub_rn(1.f, tm), td), ti), 0.f), 1.f);
    float pu = 0.f, pm = 0.f, pd = 0.f, pi = 0.f;
    for (int i = 0; i < d; ++i) {
      pu = fmaf(x[i], wu[i * d + j], pu);
      pm = fmaf(x[i], wm[i * d + j], pm);
      pd = fmaf(x[i], wd[i * d + j], pd);
      pi = fmaf(x[i], wi[i * d + j], pi);
    }
    pj[idx] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(tu, pu), __fmul_rn(tm, pm)),
                                  __fmul_rn(td, pd)),
                        __fmul_rn(ti, pi));
  }
  __syncthreads();
}

// models/gnn.py gnn_logits -> sigmoid, one row.
// scr: frontier [2][K][G], agg [2][G], h [2][G], head [GH], then (typed)
// the projected node rows [2][K+1][D].
__device__ float gnn_row(const MegaArgs& a, int r, const float* x, float* scr) {
  const int d = a.node_dim, k = a.fanout, g = a.gnn_hidden, gh = a.gnn_head;
  const int nf = a.feat_dim;
  const bool typed = a.gnn_typed != 0;
  float* fr = scr;
  float* agg = fr + 2 * k * g;
  float* hv = agg + 2 * g;
  float* z = hv + 2 * g;
  float* pj = z + gh;
  if (typed) gnn_project(a, r, 1, pj);
  auto node = [&](int side, int n) -> const float* {
    return typed ? pj + (side * (k + 1) + n) * d : gnn_node(a, r, side, n);
  };
  const float* w1 = P<float>(a.gnn_w_sage1);
  const float* b1 = P<float>(a.gnn_b_sage1);
  const float* w2 = P<float>(a.gnn_w_sage2);
  const float* b2 = P<float>(a.gnn_b_sage2);
  // first SAGE layer over each neighbour: its own two-hop frontier is empty,
  // so the aggregate half of [self ; agg] is zero and only self contributes
  for (int idx = threadIdx.x; idx < 2 * k * g; idx += blockDim.x) {
    const int side = idx / (k * g), kk = (idx / g) % k, gg = idx % g;
    const float* nfeat = node(side, kk + 1);
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
    const float* self = node(side, 0);
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
    for (int i = 0; i < nf; ++i) {
      const float xi = typed ? fminf(fmaxf(x[i], -10.f), 10.f) : x[i];
      acc = fmaf(xi, wh[(2 * g + i) * gh + j], acc);
    }
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

// f32 compute: Y[rows, N] = X[rows, K] @ W[K, N] + b (act 1: tanh GELU) as
// models/bert.py _dense at f32. W is int8 with per-column scales (I8) or f32.
// The columns go in passes of up to 256 (an FFN wider than that takes
// several); in a pass a warp owns rows warp + 8i, a lane columns
// nb + lane + 32j; weight tiles of MEGA_KC_F32 rows x the pass's columns are
// staged in wtile. Every thread of the block must call it.
template <bool I8>
__device__ void dense_f32(const float* X, int ldx, int rows, int K, const void* wp,
                      const float* scale, const float* bias, int N, float* Y,
                      int ldy, int act, float* wtile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ri = rows > warp ? (rows - warp + MEGA_WARPS - 1) / MEGA_WARPS : 0;
  for (int nb = 0; nb < N; nb += 256) {
    const int nw = N - nb < 256 ? N - nb : 256;
    const int nj = nw >> 5;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += MEGA_KC_F32) {
      const int kc = K - k0 < MEGA_KC_F32 ? K - k0 : MEGA_KC_F32;
      __syncthreads();                    // the previous tile is consumed
      for (int idx = threadIdx.x; idx < kc * nw; idx += blockDim.x) {
        const int kk = idx / nw, n = nb + idx - kk * nw;
        const size_t off = (size_t)(k0 + kk) * N + n;
        float w;
        if (I8) {
          w = (float)P<signed char>(wp)[off] * scale[n];
        } else {
          w = P<float>(wp)[off];
        }
        wtile[idx] = w;
      }
      __syncthreads();
      if (ri > 0) {
        for (int kk = 0; kk < kc; ++kk) {
          float xv[8], wv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            xv[i] = i < ri ? X[(warp + MEGA_WARPS * i) * ldx + k0 + kk] : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) wv[j] = j < nj ? wtile[kk * nw + lane + 32 * j] : 0.f;
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
        const int n = nb + lane + 32 * j;
        float y = acc[i][j] + bias[n];
        if (act == 1) y = gelu_tanh(y);
        Y[r * ldy + n] = y;
      }
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
template <bool I8>
__device__ float bert_row_f32(const MegaArgs& a, int r, float* smem, const MegaLayout& l) {
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
  dense_f32<I8>(X, ldx, rows, K, w[site], P<float>(sc[site]),                \
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

template <bool I8>
__global__ void __launch_bounds__(MEGA_THREADS, 1)
    megakernel_f32(const __grid_constant__ MegaArgs a) {
  extern __shared__ float smem[];
  const MegaLayout l = mega_layout_f32(a);
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
      tree_leaves_rows(P<int>(a.tree_feature), P<float>(a.tree_threshold),
                       P<float>(a.tree_leaf), a.n_trees, a.tree_depth, feat, a.feat_dim, 1,
                       scr);
      __syncthreads();
      if (threadIdx.x == 0) {
        float sum = 0.f;
        for (int t = 0; t < a.n_trees; ++t) sum += scr[t];
        small[0] = sigm(P<float>(a.tree_base)[0] + sum);
      }
      __syncthreads();
    }
    if (mv & 16) {                                  // isolation_forest
      tree_leaves_rows(P<int>(a.if_feature), P<float>(a.if_threshold),
                       P<float>(a.if_path), a.n_iforest, a.iforest_depth, feat, a.feat_dim,
                       1, scr);
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
      const float p = lstm_row_f32(a, r, scr);
      if (threadIdx.x == 0) small[1] = p;
      __syncthreads();
    }
    if (mv & 8) {                                   // graph_neural
      const float p = gnn_row(a, r, feat, scr);
      if (threadIdx.x == 0) small[3] = p;
      __syncthreads();
    }
    if (mv & 4) {                                   // bert_text
      const float p = bert_row_f32<I8>(a, r, smem, l);
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


// ------------------------------------------------ tensor-core path (bf16)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 rounded to a packed bf16x2 (low half = lo).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float bf_at(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// d[16 x 8] += a[16 x 16] (row) * b[16 x 8] (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two adjacent n8 tiles from a row-major [k][n] bf16 tile:
// b[0], b[1] for columns n0..n0+7 (k 0-7, 8-15), b[2], b[3] for n0+8..15.
// `row0` points at (k0, n0); `ld` is the row stride in halves.
__device__ __forceinline__ void ldsm_b_pair(uint32_t (&b)[4], const __nv_bfloat16* row0,
                                            int ld) {
  const int l = threadIdx.x & 31;
  const __nv_bfloat16* p = row0 + (((l >> 3) & 1) * 8 + (l & 7)) * ld + (l >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(p)));
}

// A fragment (rows r0 and r0 + 8, k columns k0..k0+15) of an f32 or bf16
// row-major matrix in shared memory; rows >= m read as zero. Row i of the
// operand is shared-memory row i * step.
template <bool XF32>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const void* X, int ldx, int step,
                                       int m, int r0, int k0) {
  const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= m) {
      a[h] = a[h + 2] = 0u;
      continue;
    }
    if (XF32) {
      const float* row = static_cast<const float*>(X) + (size_t)r * step * ldx + k0 + t2;
      const float2 lo = *reinterpret_cast<const float2*>(row);
      const float2 hi = *reinterpret_cast<const float2*>(row + 8);
      a[h] = pack_bf16(lo.x, lo.y);
      a[h + 2] = pack_bf16(hi.x, hi.y);
    } else {
      const __nv_bfloat16* row =
          static_cast<const __nv_bfloat16*>(X) + (size_t)r * step * ldx + k0 + t2;
      a[h] = *reinterpret_cast<const uint32_t*>(row);
      a[h + 2] = *reinterpret_cast<const uint32_t*>(row + 8);
    }
  }
}

// Y = bf16(X @ W) for operand rows i < M (shared-memory row i * step of X
// and Y): X f32 (XF32, rounded to bf16 in the fragments) or bf16, W int8
// with per-column scales (I8) or f32 in device memory, [K, N] row-major.
// With `gelu` Y = bf16(gelu(bf16(X @ W) + b)), else the bias is left to the
// reader. W streams in chunks of MEGA_KC rows x MEGA_NP columns: raw int8
// chunks by cp.async into `raw` (two stages), each widened once into
// `wide` (two stages, [KC][NP+8] bf16) while the previous chunk's mma run.
// Warps: with two or more 16-row tiles, 2 (tiles, round robin) x 4 (32
// columns each) per pass, else 8 x 16 columns. Every thread must call it;
// it ends with a barrier. Needs K % 32 == 0, N % 32 == 0.
template <bool I8, bool XF32>
__device__ void dense_tc(const void* X, int ldx, int M, int step, int K, const void* w,
                         const float* scale, const float* bias, int N, bool gelu,
                         __nv_bfloat16* Y, int ldy, __nv_bfloat16* wide, int8_t* raw) {
  constexpr int WLD = MEGA_NP + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int m_tiles = (M + 15) >> 4;
  const int wm_n = m_tiles >= 2 ? 2 : 1;
  const int wm = warp % wm_n, wn = warp / wm_n;
  const int n_per_warp = MEGA_NP / (MEGA_WARPS / wm_n);   // 32 or 16 columns
  const int k_chunks = (K + MEGA_KC - 1) / MEGA_KC;
  const int passes = (N + MEGA_NP - 1) / MEGA_NP;
  const int n_chunks = passes * k_chunks;

  auto chunk_k0 = [&](int c) { return (c % k_chunks) * MEGA_KC; };
  auto chunk_n0 = [&](int c) { return (c / k_chunks) * MEGA_NP; };
  auto chunk_kn = [&](int c) { return min(MEGA_KC, K - chunk_k0(c)); };
  auto chunk_np = [&](int c) { return min(MEGA_NP, N - chunk_n0(c)); };
  // raw int8 chunk c into raw stage c & 1 (one commit group per call)
  auto issue = [&](int c) {
    if (I8 && c < n_chunks) {
      const int k0 = chunk_k0(c), n0 = chunk_n0(c), kn = chunk_kn(c), np = chunk_np(c);
      int8_t* dst = raw + (c & 1) * MEGA_KC * MEGA_NP;
      const int per_row = np >> 4;
      for (int i = tid; i < kn * per_row; i += MEGA_THREADS) {
        const int kk = i / per_row, q = i - kk * per_row;
        cp_async16(dst + kk * MEGA_NP + 16 * q,
                   static_cast<const int8_t*>(w) + (size_t)(k0 + kk) * N + n0 + 16 * q);
      }
    }
    cp_async_commit();
  };
  // widen chunk c: thread (kk, 4 columns); exact f32(q) * bf16(scale) or
  // the f32 weight, rounded once to bf16
  auto widen = [&](int c) {
    if (c >= n_chunks) return;
    const int k0 = chunk_k0(c), n0 = chunk_n0(c), kn = chunk_kn(c), np = chunk_np(c);
    const int n4 = lane;
    if (4 * n4 >= np) return;
    __nv_bfloat16* dst = wide + (c & 1) * MEGA_KC * WLD;
    float sc[4];
    if (I8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = bf16r(scale[n0 + 4 * n4 + i]);
    }
    for (int kk = warp; kk < kn; kk += MEGA_WARPS) {
      float v[4];
      if (I8) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(
            raw + (c & 1) * MEGA_KC * MEGA_NP + kk * MEGA_NP + 4 * n4);
#pragma unroll
        for (int i = 0; i < 4; ++i)    // byte i, sign-extended: exact in f32
          v[i] = __fmul_rn((float)(static_cast<int>(u << (24 - 8 * i)) >> 24), sc[i]);
      } else {
        const float4 f = *reinterpret_cast<const float4*>(
            static_cast<const float*>(w) + (size_t)(k0 + kk) * N + n0 + 4 * n4);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      }
      *reinterpret_cast<uint2*>(dst + kk * WLD + 4 * n4) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  issue(0);
  cp_async_wait_all();
  __syncthreads();                         // raw chunk 0 landed; X complete
  issue(1);
  widen(0);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();                       // wide c ready, raw c+1 landed, mma c-1 done
    issue(c + 2);
    widen(c + 1);
    const int k0 = chunk_k0(c), n0 = chunk_n0(c), kn = chunk_kn(c), np = chunk_np(c);
    const __nv_bfloat16* wt = wide + (c & 1) * MEGA_KC * WLD;
    const int nb = wn * n_per_warp;        // this warp's first column in the pass
    if (nb < np) {
      for (int ks = 0; ks < kn; ks += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mt = wm + wm_n * i;
          if (mt < m_tiles) load_a<XF32>(a[i], X, ldx, step, M, mt * 16 + g, k0 + ks);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (16 * jp >= n_per_warp) continue;
          uint32_t b[4];
          ldsm_b_pair(b, wt + ks * WLD + nb + 16 * jp, WLD);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (wm + wm_n * i >= m_tiles) continue;
            mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
            mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    if (c % k_chunks == k_chunks - 1) {    // the pass is summed: store it
      if (nb < np) {
        float2 bj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bj[j] = gelu && 8 * j < n_per_warp
                      ? *reinterpret_cast<const float2*>(bias + n0 + nb + 8 * j + t2)
                      : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mt = wm + wm_n * i;
          if (mt >= m_tiles) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (8 * j >= n_per_warp) continue;
            const int n = n0 + nb + 8 * j + t2;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + g + 8 * h;
              if (r >= M) continue;
              float y0 = bf16r(acc[i][j][2 * h]), y1 = bf16r(acc[i][j][2 * h + 1]);
              if (gelu) {
                y0 = gelu_tanh(y0 + bj[j].x);
                y1 = gelu_tanh(y1 + bj[j].y);
              }
              *reinterpret_cast<uint32_t*>(Y + (size_t)r * step * ldy + n) = pack_bf16(y0, y1);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  __syncthreads();                         // Y complete; the rings are free
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x[i] = LN(x[i] + (add[i] + badd)) for rows i < M at shared-memory row
// i * step (add holds bf16(acc) without its bias, or is null): biased
// variance, a half-warp per row (two rows a warp at a time), rounding op by
// op as the plain version.
__device__ void ln_rows_tc(float* x, int ldx, const __nv_bfloat16* add, int lda,
                           const float* badd, int M, int step, int h, const float* gamma,
                           const float* beta, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hl = lane & 15;
  float gv[16], bv[16], av[16];   // this lane's columns are the same in every row
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = hl + 16 * j;
    gv[j] = c < h ? gamma[c] : 0.f;
    bv[j] = c < h ? beta[c] : 0.f;
    av[j] = c < h && add ? badd[c] : 0.f;
  }
  for (int i0 = 2 * warp; i0 < M; i0 += 2 * MEGA_WARPS) {
    const int i = i0 + (lane >> 4);
    const bool on = i < M;
    float* xr = x + (size_t)(on ? i : i0) * step * ldx;
    const __nv_bfloat16* ar = add ? add + (size_t)(on ? i : i0) * step * lda : nullptr;
    float vals[16];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = hl + 16 * j;
      vals[j] = 0.f;
      if (c < h) {
        vals[j] = ar ? __fadd_rn(xr[c], __fadd_rn(bf_at(ar + c), av[j])) : xr[c];
        sum += vals[j];
      }
    }
    const float mu = __fdiv_rn(half_warp_sum(sum), (float)h);
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (hl + 16 * j < h) {
        const float dv = vals[j] - mu;
        var = __fadd_rn(var, __fmul_rn(dv, dv));
      }
    }
    var = __fdiv_rn(half_warp_sum(var), (float)h);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (!on) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = hl + 16 * j;
      if (c < h)
        xr[c] = __fadd_rn(__fmul_rn(__fmul_rn(vals[j] - mu, inv), gv[j]), bv[j]);
    }
  }
}

// Masked softmax attention, f32 as the plain version, a warp per (row,
// head, MEGA_ATT_Q queries): the queries are all s tokens of each of the nr
// rows, or with nq = 1 the [CLS] token alone. A lane owns keys lane and
// lane + 32 for the scores and head columns lane and lane + 32 for the
// context, so each k and v element read serves MEGA_ATT_Q queries; every
// dot product and context sum keeps the plain version's sequential order.
// q/k/v hold bf16(acc) in rows of ld halves; their biases are added here.
// The context, rounded to bf16 (the o dense rounds it so), overwrites the
// queries' head columns of q. wscr holds per warp the queries with their
// bias, [head dim][MEGA_ATT_Q], the probabilities, [s][MEGA_ATT_Q], and the
// head's k and v biases.
__device__ void attention_tc(__nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, int ld, const float* bq,
                             const float* bk, const float* bv, const float* mask, int nr,
                             int nq, int s, int h, int heads, float sqrt_hd, float* wscr) {
  constexpr int Q = MEGA_ATT_Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = h / heads;
  float* qs = wscr + warp * MEGA_ATT_SCRATCH;
  float* p = qs + MEGA_MAX_HEAD_DIM * Q;
  float* bks = p + MEGA_MAX_TEXT * Q;       // the head's k and v biases
  float* bvs = bks + MEGA_MAX_HEAD_DIM;
  const int groups = (nq + Q - 1) / Q;
  const int tasks = nr * heads * groups;
  for (int task = warp; task < tasks; task += MEGA_WARPS) {
    const int r = task / (heads * groups), hh = (task / groups) % heads;
    const int i0 = (task % groups) * Q, nqi = min(Q, nq - i0);
    const int c0 = hh * hd;
    __nv_bfloat16* q0 = q + (size_t)(r * s + i0) * ld + c0;
    const __nv_bfloat16* kr = k + (size_t)r * s * ld + c0;
    const __nv_bfloat16* vr = v + (size_t)r * s * ld + c0;
    const float* mr = mask + r * s;
    for (int idx = lane; idx < hd * Q; idx += 32) {
      const int d = idx / Q, qq = idx % Q;
      qs[idx] = qq < nqi ? bf_at(q0 + (size_t)qq * ld + d) + bq[c0 + d] : 0.f;
    }
    for (int d = lane; d < hd; d += 32) {
      bks[d] = bk[c0 + d];
      bvs[d] = bv[c0 + d];
    }
    __syncwarp();
    // keys lane and lane + 32 (a key past s reads row 0 and is discarded)
    float dot[2][Q];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) dot[jj][qq] = 0.f;
    const __nv_bfloat16* kj0 = kr + (size_t)(lane < s ? lane : 0) * ld;
    const __nv_bfloat16* kj1 = kr + (size_t)(lane + 32 < s ? lane + 32 : 0) * ld;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float b = bks[d];
      const float k0 = bf_at(kj0 + d) + b, k1 = bf_at(kj1 + d) + b;
#pragma unroll
      for (int q4 = 0; q4 < Q; q4 += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + d * Q + q4);
        dot[0][q4] = fmaf(qv.x, k0, dot[0][q4]);
        dot[0][q4 + 1] = fmaf(qv.y, k0, dot[0][q4 + 1]);
        dot[0][q4 + 2] = fmaf(qv.z, k0, dot[0][q4 + 2]);
        dot[0][q4 + 3] = fmaf(qv.w, k0, dot[0][q4 + 3]);
        dot[1][q4] = fmaf(qv.x, k1, dot[1][q4]);
        dot[1][q4 + 1] = fmaf(qv.y, k1, dot[1][q4 + 1]);
        dot[1][q4 + 2] = fmaf(qv.z, k1, dot[1][q4 + 2]);
        dot[1][q4 + 3] = fmaf(qv.w, k1, dot[1][q4 + 3]);
      }
    }
    float sc[2][Q];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = lane + 32 * jj;
#pragma unroll
      for (int qq = 0; qq < Q; ++qq)
        sc[jj][qq] = j < s ? (mr[j] != 0.f ? __fdiv_rn(dot[jj][qq], sqrt_hd) : -1e30f)
                           : neg_inf();
    }
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      const float mx = warp_max(fmaxf(sc[0][qq], sc[1][qq]));
      const float e0 = lane < s ? expf(sc[0][qq] - mx) : 0.f;
      const float e1 = lane + 32 < s ? expf(sc[1][qq] - mx) : 0.f;
      const float sum = warp_sum(e0 + e1);
      if (lane < s) p[lane * Q + qq] = __fdiv_rn(e0, sum);
      if (lane + 32 < s) p[(lane + 32) * Q + qq] = __fdiv_rn(e1, sum);
    }
    __syncwarp();
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd) {
        const float b = bvs[d];
        float acc[Q];
#pragma unroll
        for (int qq = 0; qq < Q; ++qq) acc[qq] = 0.f;
#pragma unroll 4
        for (int j = 0; j < s; ++j) {
          const float vv = bf_at(vr + (size_t)j * ld + d) + b;
#pragma unroll
          for (int q4 = 0; q4 < Q; q4 += 4) {
            const float4 pv = *reinterpret_cast<const float4*>(p + j * Q + q4);
            acc[q4] = fmaf(pv.x, vv, acc[q4]);
            acc[q4 + 1] = fmaf(pv.y, vv, acc[q4 + 1]);
            acc[q4 + 2] = fmaf(pv.z, vv, acc[q4 + 2]);
            acc[q4 + 3] = fmaf(pv.w, vv, acc[q4 + 3]);
          }
        }
#pragma unroll
        for (int qq = 0; qq < Q; ++qq)
          if (qq < nqi) q0[(size_t)qq * ld + d] = __float2bfloat16_rn(acc[qq]);
      }
    }
    __syncwarp();
  }
}

// models/lstm.py lstm_logits -> sigmoid for the group's nr rows, into
// small[r * 16 + 1]. w_gates is widened to bf16 in shared memory once; each
// step's gate product [x_t ; h] @ W runs on the tensor cores with the rows
// in one 16-row tile (a warp per 16-column pair of n8 tiles, round robin);
// z = bf16(acc) + b, then a thread per (row, unit) updates c and h where the
// step is inside the row's history.
__device__ void lstm_tc(const MegaArgs& a, int r0, int nr, uint8_t* sm, const MegaLayoutTc& l,
                        float* small) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int fd = a.feat_dim, lh = a.lstm_hidden, g4 = 4 * lh, kin = fd + lh;
  const int steps = a.seq_len, hh = a.lstm_head, ldg = l.ldg;
  __nv_bfloat16* wg = reinterpret_cast<__nv_bfloat16*>(sm + l.wg);
  float* xh = reinterpret_cast<float*>(sm + l.xh);
  float* hist = reinterpret_cast<float*>(sm + l.hist);
  float* z = reinterpret_cast<float*>(sm + l.z);
  float* h = reinterpret_cast<float*>(sm + l.hc);
  float* c = h + nr * lh;
  float* z1 = reinterpret_cast<float*>(sm + l.lhead);
  const float* w = P<float>(a.lstm_w_gates);
  const float* bg = P<float>(a.lstm_b_gates);
  for (int i = tid; i < kin * g4 / 4; i += MEGA_THREADS) {
    const int k = i / (g4 / 4), n4 = i - k * (g4 / 4);
    const float4 f = reinterpret_cast<const float4*>(w)[i];
    *reinterpret_cast<uint2*>(wg + k * ldg + 4 * n4) =
        make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
  }
  for (int i = tid; i < nr * lh; i += MEGA_THREADS) h[i] = c[i] = 0.f;
  for (int i = tid; i < nr * steps * fd; i += MEGA_THREADS)
    hist[i] = in_row<float>(a, IN_HISTORY, r0 + i / (steps * fd))[i % (steps * fd)];
  int len[MEGA_MAX_ROWS], max_len = 0;
#pragma unroll
  for (int r = 0; r < MEGA_MAX_ROWS; ++r) {
    len[r] = r < nr ? in_i(a, IN_HISTORY_LEN, r0 + r) : 0;
    max_len = max(max_len, len[r]);
  }
  __syncthreads();
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  for (int t = steps - min(max_len, steps); t < steps; ++t) {
    for (int i = tid; i < nr * kin; i += MEGA_THREADS) {
      const int r = i / kin, k = i - r * kin;
      xh[i] = k < fd ? hist[(r * steps + t) * fd + k] : h[r * lh + k - fd];
    }
    __syncthreads();
    float acc[4][2][4];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jp][j][e] = 0.f;
    for (int k0 = 0; k0 < kin; k0 += 16) {
      uint32_t af[4];
      load_a<true>(af, xh, kin, 1, nr, g, k0);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int pair = warp + MEGA_WARPS * jp;
        if (pair * 16 >= g4) continue;
        uint32_t b[4];
        ldsm_b_pair(b, wg + k0 * ldg + pair * 16, ldg);
        mma_bf16(acc[jp][0], af, b[0], b[1]);
        mma_bf16(acc[jp][1], af, b[2], b[3]);
      }
    }
    if (g < nr) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int pair = warp + MEGA_WARPS * jp;
        if (pair * 16 >= g4) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = pair * 16 + 8 * j + t2;
          z[g * g4 + n] = bf16r(acc[jp][j][0]) + bg[n];
          z[g * g4 + n + 1] = bf16r(acc[jp][j][1]) + bg[n + 1];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * lh; i += MEGA_THREADS) {
      const int r = i / lh, j = i - r * lh;
      int lr = 0;
#pragma unroll
      for (int rr = 0; rr < MEGA_MAX_ROWS; ++rr) lr = rr == r ? len[rr] : lr;
      if (t < steps - lr) continue;                      // front padding
      const float* zr = z + r * g4;
      const float ig = sigm(zr[j]), fg = sigm(zr[lh + j]);
      const float gg = tanhf(zr[2 * lh + j]), og = sigm(zr[3 * lh + j]);
      const float cn = __fadd_rn(__fmul_rn(fg, c[i]), __fmul_rn(ig, gg));
      c[i] = cn;
      h[i] = __fmul_rn(og, tanhf(cn));
    }
    __syncthreads();
  }
  const float* w1 = P<float>(a.lstm_w_head1);
  const float* b1 = P<float>(a.lstm_b_head1);
  for (int i = tid; i < nr * hh; i += MEGA_THREADS) {
    const int r = i / hh, j = i - r * hh;
    float acc = 0.f;
    for (int k = 0; k < lh; ++k) acc = fmaf(h[r * lh + k], w1[(size_t)k * hh + j], acc);
    z1[i] = fmaxf(acc + b1[j], 0.f);
  }
  __syncthreads();
  if (tid < nr) {
    const float* w2 = P<float>(a.lstm_w_head2);
    float logit = 0.f;
    for (int j = 0; j < hh; ++j) logit = fmaf(z1[tid * hh + j], w2[j], logit);
    small[tid * 16 + 1] = sigm(logit + P<float>(a.lstm_b_head2)[0]);
  }
  __syncthreads();
}

// models/gnn.py gnn_logits -> sigmoid for the group's nr rows, into
// small[r * 16 + 3]; the SAGE and head weights are staged in shared memory
// once (typed parameters also project the rows' nodes there first), the
// arithmetic is the f32 FMA order of the plain version.
__device__ void gnn_tc(const MegaArgs& a, int r0, int nr, uint8_t* sm, const MegaLayoutTc& l,
                       const float* feat, float* small) {
  const int tid = threadIdx.x;
  const int d = a.node_dim, k = a.fanout, g = a.gnn_hidden, gh = a.gnn_head;
  const int fd = a.feat_dim;
  float* ws1 = reinterpret_cast<float*>(sm + l.ws1);
  float* ws2 = reinterpret_cast<float*>(sm + l.ws2);
  float* wh1 = reinterpret_cast<float*>(sm + l.wh1);
  float* fr = reinterpret_cast<float*>(sm + l.fr);
  float* agg = reinterpret_cast<float*>(sm + l.agg);
  float* hv = reinterpret_cast<float*>(sm + l.hv);
  float* z = reinterpret_cast<float*>(sm + l.gz);
  const bool typed = a.gnn_typed != 0;
  float* pj = reinterpret_cast<float*>(sm + l.pj);
  auto node = [&](int r, int side, int n) -> const float* {
    return typed ? pj + ((r * 2 + side) * (k + 1) + n) * d : gnn_node(a, r0 + r, side, n);
  };
  // the first SAGE layer's neighbours have an empty two-hop frontier, so
  // only the self half (the first d rows) of w_sage1 contributes
  for (int i = tid; i < d * g; i += MEGA_THREADS) ws1[i] = P<float>(a.gnn_w_sage1)[i];
  for (int i = tid; i < (d + g) * g; i += MEGA_THREADS) ws2[i] = P<float>(a.gnn_w_sage2)[i];
  for (int i = tid; i < (2 * g + fd) * gh; i += MEGA_THREADS)
    wh1[i] = P<float>(a.gnn_w_head1)[i];
  __syncthreads();
  if (typed) gnn_project(a, r0, nr, pj);
  const float* b1 = P<float>(a.gnn_b_sage1);
  const float* b2 = P<float>(a.gnn_b_sage2);
  for (int idx = tid; idx < nr * 2 * k * g; idx += MEGA_THREADS) {
    const int r = idx / (2 * k * g), side = (idx / (k * g)) & 1;
    const int kk = (idx / g) % k, gg = idx % g;
    const float* nfeat = node(r, side, kk + 1);
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(nfeat[j], ws1[j * g + gg], acc);
    fr[idx] = fmaxf(acc + b1[gg], 0.f);
  }
  __syncthreads();
  for (int idx = tid; idx < nr * 2 * g; idx += MEGA_THREADS) {
    const int r = idx / (2 * g), side = (idx / g) & 1, gg = idx % g;
    const unsigned char* mask = in_row<unsigned char>(
        a, side ? IN_MERCH_NEIGH_MASK : IN_USER_NEIGH_MASK, r0 + r);
    float sum = 0.f, cnt = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float m = mask[kk] ? 1.f : 0.f;
      sum = __fadd_rn(sum, __fmul_rn(fr[((r * 2 + side) * k + kk) * g + gg], m));
      cnt = __fadd_rn(cnt, m);
    }
    agg[idx] = __fdiv_rn(sum, fmaxf(cnt, 1.f));
  }
  __syncthreads();
  for (int idx = tid; idx < nr * 2 * g; idx += MEGA_THREADS) {
    const int r = idx / (2 * g), side = (idx / g) & 1, gg = idx % g;
    const float* self = node(r, side, 0);
    const float* ag = agg + (r * 2 + side) * g;
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(self[j], ws2[j * g + gg], acc);
    for (int j = 0; j < g; ++j) acc = fmaf(ag[j], ws2[(d + j) * g + gg], acc);
    hv[idx] = fmaxf(acc + b2[gg], 0.f);
  }
  __syncthreads();
  const float* bh = P<float>(a.gnn_b_head1);
  for (int idx = tid; idx < nr * gh; idx += MEGA_THREADS) {
    const int r = idx / gh, j = idx - r * gh;
    float acc = 0.f;
    for (int i = 0; i < 2 * g; ++i) acc = fmaf(hv[r * 2 * g + i], wh1[i * gh + j], acc);
    for (int i = 0; i < fd; ++i) {
      const float xi = feat[r * fd + i];
      acc = fmaf(typed ? fminf(fmaxf(xi, -10.f), 10.f) : xi, wh1[(2 * g + i) * gh + j], acc);
    }
    z[idx] = fmaxf(acc + bh[j], 0.f);
  }
  __syncthreads();
  if (tid < nr) {
    const float* w = P<float>(a.gnn_w_head2);
    float out = 0.f;
    for (int j = 0; j < gh; ++j) out = fmaf(z[tid * gh + j], w[j], out);
    small[tid * 16 + 3] = sigm(out + P<float>(a.gnn_b_head2)[0]);
  }
  __syncthreads();
}

// models/bert.py bert_predict (softmax(logits)[1]) for the group's nr rows,
// into small[r * 16 + 2]; `rows` is the layout's row count.
template <bool I8>
__device__ void bert_tc(const MegaArgs& a, int r0, int nr, int rows, uint8_t* sm,
                        const MegaLayoutTc& l, float* small) {
  const int tid = threadIdx.x;
  const int s = a.text_len, h = a.hidden, f = a.ffn, rs = rows * s;
  const int ldx = l.ldx, ldq = l.ldq, ldf = l.ldf;
  float* x = reinterpret_cast<float*>(sm + l.x);
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(sm + l.act);
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(sm + l.act + mega_al16(rs * ldq * 2));
  __nv_bfloat16* vb =
      reinterpret_cast<__nv_bfloat16*>(sm + l.act + 2 * mega_al16(rs * ldq * 2));
  __nv_bfloat16* hid = qb;                 // the FFN hidden reuses q|k
  __nv_bfloat16* f2 = reinterpret_cast<__nv_bfloat16*>(sm + l.act + mega_al16(rs * ldf * 2));
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(sm + l.wide);
  int8_t* raw = reinterpret_cast<int8_t*>(sm + l.raw);
  const float* mask = reinterpret_cast<const float*>(sm + l.mask);
  float* wscr = reinterpret_cast<float*>(sm + l.wide);   // between dense layers
  float* cls = reinterpret_cast<float*>(sm + l.cls);

  // embeddings, four columns a thread
  const int h4 = h / 4;
  for (int idx = tid; idx < nr * s * h4; idx += MEGA_THREADS) {
    const int rt = idx / h4, c = 4 * (idx - rt * h4), r = rt / s, t = rt - r * s;
    int tok = in_row<int>(a, IN_TOKEN_IDS, r0 + r)[t];
    tok = tok < 0 ? 0 : (tok >= a.vocab ? a.vocab - 1 : tok);
    float wv[4], pv[4];
    if (I8) {
      const char4 wq = *reinterpret_cast<const char4*>(P<signed char>(a.word_emb) +
                                                       (size_t)tok * h + c);
      const char4 pq = *reinterpret_cast<const char4*>(P<signed char>(a.pos_emb) +
                                                       (size_t)t * h + c);
      const float ws = P<float>(a.word_scale)[tok], ps = P<float>(a.pos_scale)[t];
      wv[0] = (float)wq.x * ws; wv[1] = (float)wq.y * ws;
      wv[2] = (float)wq.z * ws; wv[3] = (float)wq.w * ws;
      pv[0] = (float)pq.x * ps; pv[1] = (float)pq.y * ps;
      pv[2] = (float)pq.z * ps; pv[3] = (float)pq.w * ps;
    } else {
      const float4 wf = *reinterpret_cast<const float4*>(P<float>(a.word_emb) + (size_t)tok * h + c);
      const float4 pf = *reinterpret_cast<const float4*>(P<float>(a.pos_emb) + (size_t)t * h + c);
      wv[0] = wf.x; wv[1] = wf.y; wv[2] = wf.z; wv[3] = wf.w;
      pv[0] = pf.x; pv[1] = pf.y; pv[2] = pf.z; pv[3] = pf.w;
    }
    float* xr = x + (size_t)rt * ldx + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) xr[i] = wv[i] + pv[i];
  }
  __syncthreads();
  ln_rows_tc(x, ldx, nullptr, 0, nullptr, nr * s, 1, h, P<float>(a.emb_ln_scale),
             P<float>(a.emb_ln_bias), a.ln_eps);
  MEGA_PHASE();
  for (int li = 0; li < a.layers; ++li) {
    const bool last = li == a.layers - 1;   // last layer: the [CLS] rows only
    const int mq = last ? nr : nr * s, step = last ? s : 1;
    const void* const* w = a.dense_w[li];
    const float* sc[6];
    const float* b[6];
    for (int i = 0; i < 6; ++i) {
      sc[i] = P<float>(a.dense_scale[li][i]);
      b[i] = P<float>(a.dense_b[li][i]);
    }
    dense_tc<I8, true>(x, ldx, mq, step, h, w[D_Q], sc[D_Q], b[D_Q], h, false, qb, ldq, wide,
                       raw);
    MEGA_PHASE();
    dense_tc<I8, true>(x, ldx, nr * s, 1, h, w[D_K], sc[D_K], b[D_K], h, false, kb, ldq, wide,
                       raw);
    MEGA_PHASE();
    dense_tc<I8, true>(x, ldx, nr * s, 1, h, w[D_V], sc[D_V], b[D_V], h, false, vb, ldq, wide,
                       raw);
    MEGA_PHASE();
    attention_tc(qb, kb, vb, ldq, b[D_Q], b[D_K], b[D_V], mask, nr, last ? 1 : s, s, h,
                 a.heads, a.sqrt_head_dim, wscr);
    MEGA_PHASE();
    dense_tc<I8, false>(qb, ldq, mq, step, h, w[D_O], sc[D_O], b[D_O], h, false, kb, ldq, wide,
                        raw);
    MEGA_PHASE();
    ln_rows_tc(x, ldx, kb, ldq, b[D_O], mq, step, h, P<float>(a.ln_scale[li][0]),
               P<float>(a.ln_bias[li][0]), a.ln_eps);
    MEGA_PHASE();
    dense_tc<I8, true>(x, ldx, mq, step, h, w[D_FFN1], sc[D_FFN1], b[D_FFN1], f, true, hid, ldf,
                       wide, raw);
    MEGA_PHASE();
    dense_tc<I8, false>(hid, ldf, mq, step, f, w[D_FFN2], sc[D_FFN2], b[D_FFN2], h, false, f2,
                        ldq, wide, raw);
    MEGA_PHASE();
    ln_rows_tc(x, ldx, f2, ldq, b[D_FFN2], mq, step, h, P<float>(a.ln_scale[li][1]),
               P<float>(a.ln_bias[li][1]), a.ln_eps);
    MEGA_PHASE();
  }
  __syncthreads();
  const float* pw = P<float>(a.pre_w);
  const float* pb = P<float>(a.pre_b);
  for (int idx = tid; idx < nr * h; idx += MEGA_THREADS) {
    const int r = idx / h, j = idx - r * h;
    const float* xr = x + (size_t)r * s * ldx;
    float acc = 0.f;
    for (int c = 0; c < h; ++c) acc = fmaf(xr[c], pw[c * h + j], acc);
    cls[idx] = fmaxf(acc + pb[j], 0.f);
  }
  __syncthreads();
  if (tid < nr) {
    const float* cw = P<float>(a.cls_w);
    const float* cb = P<float>(a.cls_b);
    float l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < h; ++j) {
      l0 = fmaf(cls[tid * h + j], cw[2 * j], l0);
      l1 = fmaf(cls[tid * h + j], cw[2 * j + 1], l1);
    }
    l0 += cb[0];
    l1 += cb[1];
    const float m = fmaxf(l0, l1);
    const float e0 = expf(l0 - m), e1 = expf(l1 - m);
    small[tid * 16 + 2] = __fdiv_rn(e1, e0 + e1);
  }
  __syncthreads();
}

template <bool I8>
__global__ void __launch_bounds__(MEGA_THREADS, 1)
    megakernel_tc(const __grid_constant__ MegaArgs a, int rows) {
  extern __shared__ float smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem);
  const MegaLayoutTc l = mega_layout_tc(a, rows);
  float* feat = reinterpret_cast<float*>(sm + l.feat);
  float* mask = reinterpret_cast<float*>(sm + l.mask);
  float* small = reinterpret_cast<float*>(sm + l.small);   // per row: preds[5], rule, factors[3]
  float* leaves = reinterpret_cast<float*>(sm + l.leaves);
  const int tid = threadIdx.x, mv = a.mega_valid, fd = a.feat_dim, s = a.text_len;
  const int width = 2 * MEGA_NUM_MODELS + 10;
  const int groups = (a.batch + rows - 1) / rows;

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    MEGA_PHASE();
    const int r0 = grp * rows, nr = min(rows, a.batch - r0);
    for (int i = tid; i < nr * fd; i += MEGA_THREADS)
      feat[i] = in_row<float>(a, IN_FEATURES, r0 + i / fd)[i % fd];
    for (int i = tid; i < nr * s; i += MEGA_THREADS)
      mask[i] = in_row<unsigned char>(a, IN_TOKEN_MASK, r0 + i / s)[i % s] ? 1.f : 0.f;
    if (tid < nr * 16) small[tid] = 0.f;
    __syncthreads();
    if (tid < nr) {
      const int r = r0 + tid, hour = in_i(a, IN_HOUR_OF_DAY, r);
      float* sr = small + tid * 16;
      sr[5] = rule_score_row(a, r);
      sr[6] = in_f(a, IN_AMOUNT, r) > 10000.f ? 1.f : 0.f;
      sr[7] = (hour < 6 || hour >= 23) ? 1.f : 0.f;
      sr[8] = in_b(a, IN_HIGH_RISK_PAYMENT, r);
    }
    __syncthreads();

    if (mv & 1) {                                   // xgboost_primary
      tree_leaves_rows(P<int>(a.tree_feature), P<float>(a.tree_threshold),
                       P<float>(a.tree_leaf), a.n_trees, a.tree_depth, feat, fd, nr, leaves);
      __syncthreads();
      if (tid < nr) {
        float sum = 0.f;
        for (int t = 0; t < a.n_trees; ++t) sum += leaves[tid * a.n_trees + t];
        small[tid * 16] = sigm(P<float>(a.tree_base)[0] + sum);
      }
      __syncthreads();
    }
    if (mv & 16) {                                  // isolation_forest
      tree_leaves_rows(P<int>(a.if_feature), P<float>(a.if_threshold), P<float>(a.if_path),
                       a.n_iforest, a.iforest_depth, feat, fd, nr, leaves);
      __syncthreads();
      if (tid < nr) {
        float sum = 0.f;
        for (int t = 0; t < a.n_iforest; ++t) sum += leaves[tid * a.n_iforest + t];
        const float mean = __fdiv_rn(sum, (float)a.n_iforest);
        const float score = exp2f(__fdiv_rn(-mean, P<float>(a.if_cpsi)[0]));
        small[tid * 16 + 4] = __fdiv_rn(1.f, 1.f + expf(0.5f - score));
      }
      __syncthreads();
    }
    MEGA_PHASE();
    if (mv & 2) lstm_tc(a, r0, nr, sm, l, small);           // lstm_sequential
    MEGA_PHASE();
    if (mv & 8) gnn_tc(a, r0, nr, sm, l, feat, small);      // graph_neural
    MEGA_PHASE();
    if (mv & 4) bert_tc<I8>(a, r0, nr, rows, sm, l, small);  // bert_text
    MEGA_PHASE();

    if (tid < nr) {
      const int r = r0 + tid;
      const float* sr = small + tid * 16;
      const float valid = in_b(a, IN_VALID, r);
      float vf[MEGA_NUM_MODELS];
      for (int m = 0; m < MEGA_NUM_MODELS; ++m)
        vf[m] = __fmul_rn(valid, (mv >> m) & 1 ? 1.f : 0.f);
      const CombineParams c{a.strategy, a.fraud_threshold, a.confidence_threshold,
                            a.decline, a.review, a.monitor};
      float* o = static_cast<float*>(a.out) + (size_t)r * width;
      combine_row(sr, vf, P<float>(a.weights), P<float>(a.conf_mult), MEGA_NUM_MODELS, sr[5],
                  c, o, o + 8 + MEGA_NUM_MODELS, o + 8 + 2 * MEGA_NUM_MODELS);
      o[4] = sr[5];
      o[5] = sr[6];
      o[6] = sr[7];
      o[7] = sr[8];
      for (int m = 0; m < MEGA_NUM_MODELS; ++m) o[8 + m] = sr[m];
    }
    __syncthreads();                                // smem is reused next group
  }
}

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MEGA_SMEM_LIMIT);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" int rtfd_megakernel_smem_bytes(const void* args) {
  return mega_plan_smem_bytes(*static_cast<const MegaArgs*>(args));
}

#ifdef MEGA_PHASES
// Copies the phase stamps (at most 256) into `out` and their count into
// `n`, then clears the count.
extern "C" int rtfd_megakernel_phases(unsigned long long* out, int* n) {
  cudaError_t err = cudaMemcpyFromSymbol(out, mega_ph, sizeof(unsigned long long) * 256);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(n, mega_ph_n, sizeof(int));
  const int zero = 0;
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(mega_ph_n, &zero, sizeof(int));
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}
#endif

// `sms` is the card's SM count: the grid is at most one CTA per SM. With
// bf16 compute each CTA iteration scores `rows` rows, the fewest that cover
// the batch in one wave, at most MEGA_MAX_ROWS and as many as fit.
extern "C" int rtfd_megakernel(const void* args, int sms, void* stream) {
  const MegaArgs& a = *static_cast<const MegaArgs*>(args);
  if (mega_plan_smem_bytes(a) > MEGA_SMEM_LIMIT || sms <= 0 || a.batch <= 0 ||
      a.layers <= 0 || a.layers > MEGA_MAX_LAYERS || a.text_len > MEGA_MAX_TEXT ||
      a.hidden > MEGA_MAX_WIDTH || a.ffn > MEGA_MAX_FFN || a.hidden % 32 || a.ffn % 32 ||
      a.heads <= 0 || a.hidden % a.heads || a.hidden / a.heads > MEGA_MAX_HEAD_DIM ||
      a.lstm_hidden > MEGA_MAX_LSTM || a.lstm_hidden % 4 || (a.feat_dim + a.lstm_hidden) % 16 ||
      (a.gnn_typed && a.node_dim < 11))     // the tag slots 8, 9, 10
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool ready[4] = {false, false, false, false};
  cudaError_t err;
  if (!a.bf16) {
    const size_t smem = (size_t)mega_layout_f32(a).total * sizeof(float);
    const int grid = a.batch < sms ? a.batch : sms;
    if (a.int8) {
      err = raise_smem_limit(megakernel_f32<true>, ready[0]);
      if (err == cudaSuccess) megakernel_f32<true><<<grid, MEGA_THREADS, smem, st>>>(a);
    } else {
      err = raise_smem_limit(megakernel_f32<false>, ready[1]);
      if (err == cudaSuccess) megakernel_f32<false><<<grid, MEGA_THREADS, smem, st>>>(a);
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  int rows = (a.batch + sms - 1) / sms;
  if (rows > MEGA_MAX_ROWS) rows = MEGA_MAX_ROWS;
  while (rows > 1 && mega_layout_tc(a, rows).total > MEGA_SMEM_LIMIT) --rows;
  const int groups = (a.batch + rows - 1) / rows;
  const int grid = groups < sms ? groups : sms;
  const size_t smem = mega_layout_tc(a, rows).total;
  if (a.int8) {
    err = raise_smem_limit(megakernel_tc<true>, ready[2]);
    if (err == cudaSuccess) megakernel_tc<true><<<grid, MEGA_THREADS, smem, st>>>(a, rows);
  } else {
    err = raise_smem_limit(megakernel_tc<false>, ready[3]);
    if (err == cudaSuccess) megakernel_tc<false><<<grid, MEGA_THREADS, smem, st>>>(a, rows);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
