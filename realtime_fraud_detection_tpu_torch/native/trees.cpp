// Boosted-tree ensemble inference kernel (C ABI, OpenMP-free, threadable).
//
// A copy of the JAX package's native/trees.cpp. The host twin of
// models/trees.py's tensorized traversal: the same complete-binary-tree
// layout (feature i32[T, 2^D-1], threshold f32[T, 2^D-1], leaf f32[T, 2^D],
// split rule x >= threshold goes RIGHT) traversed scalar-fashion per row.
// Gives the host a scorer when no accelerator is attached (the reference
// served xgboost on CPU, model_manager.py:309-311) and an independent
// oracle for the tensorized traversal's numerics.
//
// Exposed as a flat C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Scores one batch: logits[b] = base + sum_t leaf[t][descend(t, x_b)].
// feature/threshold: [n_trees * n_internal]; leaf: [n_trees * n_leaf];
// x: [n_rows * n_features] row-major; out: [n_rows].
// depth = log2(n_leaf); n_internal = n_leaf - 1.
void trees_score(const int32_t* feature, const float* threshold,
                 const float* leaf, float base_score, int32_t n_trees,
                 int32_t depth, const float* x, int32_t n_rows,
                 int32_t n_features, float* out) {
  const int32_t n_internal = (1 << depth) - 1;
  const int32_t n_leaf = 1 << depth;
  for (int32_t r = 0; r < n_rows; ++r) {
    const float* row = x + static_cast<int64_t>(r) * n_features;
    float acc = base_score;
    for (int32_t t = 0; t < n_trees; ++t) {
      const int32_t* tf = feature + static_cast<int64_t>(t) * n_internal;
      const float* tt = threshold + static_cast<int64_t>(t) * n_internal;
      int32_t node = 0;
      for (int32_t d = 0; d < depth; ++d) {
        node = 2 * node + 1 + (row[tf[node]] >= tt[node] ? 1 : 0);
      }
      acc += leaf[static_cast<int64_t>(t) * n_leaf + (node - n_internal)];
    }
    out[r] = acc;
  }
}

// Multi-threaded variant: rows split across n_threads hardware threads.
void trees_score_mt(const int32_t* feature, const float* threshold,
                    const float* leaf, float base_score, int32_t n_trees,
                    int32_t depth, const float* x, int32_t n_rows,
                    int32_t n_features, float* out, int32_t n_threads) {
  if (n_threads <= 1 || n_rows < 2 * n_threads) {
    trees_score(feature, threshold, leaf, base_score, n_trees, depth, x,
                n_rows, n_features, out);
    return;
  }
  std::vector<std::thread> workers;
  const int32_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int32_t i = 0; i < n_threads; ++i) {
    const int32_t lo = i * chunk;
    const int32_t hi = std::min(n_rows, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([=] {
      trees_score(feature, threshold, leaf, base_score, n_trees, depth,
                  x + static_cast<int64_t>(lo) * n_features, hi - lo,
                  n_features, out + lo);
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
