// Monotonic alignment search (Viterbi maximum path), the host C++ core of
// slam_llm_tpu_torch.ops.monotonic_align.
//
// The reference's only native source is the Cython kernel vendored from
// Matcha-TTS (monotonic_align/core.pyx), used by TTS duration modeling:
// given a batch of log-likelihood matrices value[b, t_x, t_y], find for each
// the best monotonic hard alignment path.
//
// The DP recurrence is the reference's: value[x, y] accumulates
// max(value[x, y-1], value[x-1, y-1]) in place, then the path is traced
// backwards. Batch items run in parallel with OpenMP when the compiler has it.
//
// Built at first use by ops/monotonic_align.py:
//   g++ -O3 -shared -fPIC -fopenmp monotonic_align.cpp -o libmonotonic_align-<hash>.so

#include <algorithm>
#include <cstdint>

extern "C" {

static void maximum_path_each(int32_t* path, float* value, int t_x, int t_y,
                              int stride_y, float max_neg_val) {
  for (int y = 0; y < t_y; ++y) {
    int x_lo = std::max(0, t_x + y - t_y);
    int x_hi = std::min(t_x, y + 1);
    for (int x = x_lo; x < x_hi; ++x) {
      float v_cur = (x == y) ? max_neg_val : value[x * stride_y + (y - 1)];
      float v_prev;
      if (x == 0) {
        v_prev = (y == 0) ? 0.f : max_neg_val;
      } else {
        v_prev = value[(x - 1) * stride_y + (y - 1)];
      }
      value[x * stride_y + y] += std::max(v_cur, v_prev);
    }
  }
  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    path[index * stride_y + y] = 1;
    if (index != 0 &&
        (index == y ||
         value[index * stride_y + (y - 1)] < value[(index - 1) * stride_y + (y - 1)])) {
      --index;
    }
  }
}

// paths:  int32[b, t_x_max, t_y_max] zero-initialized (written)
// values: float32[b, t_x_max, t_y_max] log-likelihoods (clobbered)
// t_xs, t_ys: per-item valid lengths
void maximum_path(int32_t* paths, float* values, const int32_t* t_xs,
                  const int32_t* t_ys, int b, int t_x_max, int t_y_max,
                  float max_neg_val) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < b; ++i) {
    maximum_path_each(paths + (int64_t)i * t_x_max * t_y_max,
                      values + (int64_t)i * t_x_max * t_y_max, t_xs[i], t_ys[i],
                      t_y_max, max_neg_val);
  }
}

}  // extern "C"
