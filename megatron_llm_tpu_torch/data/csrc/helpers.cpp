// Index builders of the GPT dataset (port of the JAX package's
// data/csrc/helpers.cpp, its GPT entry points): the sample index that
// stitches documents into seq_length + 1 token samples, and the blend
// index of weighted datasets. A plain C ABI bound with ctypes; the
// Python wrappers in data/helpers.py allocate the numpy outputs, pass
// raw pointers, and build this file with g++ into build/ at first use.

#include <algorithm>
#include <cstdint>

extern "C" {

// Number of (seq_length+1)-token training samples obtainable from
// num_epochs passes over tokens_per_epoch tokens. The -1 mirrors the
// reference's overlap accounting (ref: helpers.cpp:103,
// gpt_dataset.py:414-425): consecutive samples share one boundary token.
int64_t num_samples_from_epochs(int64_t num_epochs, int64_t tokens_per_epoch,
                                int32_t seq_length) {
  return (num_epochs * tokens_per_epoch - 1) / seq_length;
}

// Fill sample_idx[(num_samples+1) x 2] with (doc_idx_index, doc_offset)
// pairs: sample i spans tokens from pair i to pair i+1 inclusive.
// Parity: ref helpers.cpp build_sample_idx (:83-175) / the Python
// equivalent gpt_dataset.py:449-491.
void build_sample_idx(const int32_t* sizes, const int32_t* doc_idx,
                      int32_t seq_length, int64_t num_epochs,
                      int64_t tokens_per_epoch, int32_t* sample_idx) {
  const int64_t num_samples =
      num_samples_from_epochs(num_epochs, tokens_per_epoch, seq_length);

  int64_t doc_idx_index = 0;
  int32_t doc_offset = 0;
  sample_idx[0] = 0;
  sample_idx[1] = 0;

  for (int64_t s = 1; s <= num_samples; ++s) {
    int32_t remaining = seq_length + 1;
    while (remaining != 0) {
      const int32_t doc_length = sizes[doc_idx[doc_idx_index]] - doc_offset;
      remaining -= doc_length;
      if (remaining <= 0) {
        // sample ends inside this document; next sample re-reads the
        // boundary token (the -1)
        doc_offset += remaining + doc_length - 1;
        remaining = 0;
      } else {
        ++doc_idx_index;
        doc_offset = 0;
      }
    }
    sample_idx[2 * s] = static_cast<int32_t>(doc_idx_index);
    sample_idx[2 * s + 1] = doc_offset;
  }
}

// Greedy error-minimising interleave of weighted datasets.
// Parity: ref helpers.cpp build_blending_indices (:20-81) including the
// max(sample_idx, 1.0) detail so sample 0 matches.
void build_blending_indices(uint8_t* dataset_index,
                            int64_t* dataset_sample_index,
                            const double* weights, int32_t num_datasets,
                            int64_t size) {
  int64_t* current = new int64_t[num_datasets]();
  for (int64_t i = 0; i < size; ++i) {
    const double i_d = std::max(static_cast<double>(i), 1.0);
    int64_t best = 0;
    double best_err = weights[0] * i_d - static_cast<double>(current[0]);
    for (int32_t d = 1; d < num_datasets; ++d) {
      const double err = weights[d] * i_d - static_cast<double>(current[d]);
      if (err > best_err) {
        best_err = err;
        best = d;
      }
    }
    dataset_index[i] = static_cast<uint8_t>(best);
    dataset_sample_index[i] = current[best];
    ++current[best];
  }
  delete[] current;
}

}  // extern "C"
