// Native metrics kernel: AUROC + average precision over large score arrays.
//
// The evaluation pipeline scores every pixel of every test image
// (~20M float32 per class at 518^2); Python-side sorting dominates host
// time.  This computes both metrics with a parallel sort (libstdc++
// parallel mode / OpenMP) and a single linear pass over distinct score
// cuts — semantics identical to sklearn's roc_auc_score /
// average_precision_score (trapezoidal ROC integration, step-wise AP).
//
// Exposed via a C ABI for ctypes; built by aaclip_tpu_torch/native/build.py.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

#if defined(_OPENMP)
#include <parallel/algorithm>
#define SORT __gnu_parallel::sort
#else
#define SORT std::sort
#endif

extern "C" {

// Computes ROC AUC and AP for binary labels. Returns 0 on success,
// 1 if only one class is present (outputs set to NaN).
//
// Scores are float64: the Python pipeline min-max normalizes in float64,
// and a float32 cast here would merge sub-f32-ulp score differences into
// ties, diverging from the numpy/sklearn paths.
int auroc_ap(const double* scores, const uint8_t* labels, int64_t n,
             double* out_auroc, double* out_ap) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), int64_t{0});
  SORT(order.begin(), order.end(), [scores](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });

  double total_pos = 0;
  for (int64_t i = 0; i < n; ++i) total_pos += labels[i];
  const double total_neg = static_cast<double>(n) - total_pos;
  if (total_pos == 0 || total_neg == 0) {
    *out_auroc = *out_ap = std::numeric_limits<double>::quiet_NaN();
    return 1;
  }

  // walk descending scores; emit a curve point at each distinct value
  double tps = 0, fps = 0;
  double prev_tpr = 0, prev_fpr = 0, prev_recall = 0;
  double auc = 0, ap = 0;
  for (int64_t i = 0; i < n; ++i) {
    tps += labels[order[i]];
    fps += 1.0 - labels[order[i]];
    const bool last = (i == n - 1);
    if (last || scores[order[i]] != scores[order[i + 1]]) {
      const double tpr = tps / total_pos;
      const double fpr = fps / total_neg;
      auc += (fpr - prev_fpr) * (tpr + prev_tpr) * 0.5;
      const double precision = tps / (tps + fps);
      ap += (tpr - prev_recall) * precision;
      prev_tpr = tpr;
      prev_fpr = fpr;
      prev_recall = tpr;
    }
  }
  *out_auroc = auc;
  *out_ap = ap;
  return 0;
}

// 4-connectivity connected-component labeling (scipy.ndimage.label default
// structure) for AUPRO region extraction. labels_out must hold h*w int32.
// Returns the number of components.
int32_t label_components(const uint8_t* mask, int32_t h, int32_t w,
                         int32_t* labels_out) {
  const int64_t size = static_cast<int64_t>(h) * w;
  std::fill(labels_out, labels_out + size, 0);
  std::vector<int64_t> stack;
  int32_t next = 0;
  for (int64_t start = 0; start < size; ++start) {
    if (!mask[start] || labels_out[start]) continue;
    ++next;
    stack.push_back(start);
    labels_out[start] = next;
    while (!stack.empty()) {
      const int64_t p = stack.back();
      stack.pop_back();
      const int64_t y = p / w, x = p % w;
      const int64_t nbrs[4] = {p - w, p + w, p - 1, p + 1};
      const bool ok[4] = {y > 0, y < h - 1, x > 0, x < w - 1};
      for (int k = 0; k < 4; ++k) {
        if (ok[k] && mask[nbrs[k]] && !labels_out[nbrs[k]]) {
          labels_out[nbrs[k]] = next;
          stack.push_back(nbrs[k]);
        }
      }
    }
  }
  return next;
}

}  // extern "C"
