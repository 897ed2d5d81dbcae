// Dataset index builders (port of the JAX package's
// data/csrc/helpers.cpp): the GPT sample index that stitches documents
// into seq_length + 1 token samples, the blend index of weighted
// datasets, BERT's sentence-pair map and ICT's sentence-block map. A
// plain C ABI bound with ctypes; the Python wrappers in data/helpers.py
// allocate the numpy outputs, pass raw pointers, and build this file
// with g++ into build/ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>

namespace {

constexpr int32_t kLongSentenceLen = 512;  // ref helpers.cpp LONG_SENTENCE_LEN

// ref helpers.cpp:171-185 get_target_sample_len
int32_t target_sample_len(int32_t short_seq_ratio, int32_t max_length,
                          std::mt19937& gen) {
  if (short_seq_ratio == 0) return max_length;
  const uint32_t random_number = gen();
  if ((random_number % short_seq_ratio) == 0) {
    return 2 + random_number % (max_length - 1);
  }
  return max_length;
}

// ref helpers.cpp:393-404: 64-bit Fisher-Yates with seed + 1
void shuffle_rows(int64_t* maps, int64_t num_samples, int32_t row,
                  int32_t seed) {
  std::mt19937_64 gen(seed + 1);
  for (int64_t i = num_samples - 1; i > 0; --i) {
    const int64_t j = static_cast<int64_t>(gen() % (i + 1));
    for (int32_t c = 0; c < row; ++c) {
      std::swap(maps[row * i + c], maps[row * j + c]);
    }
  }
}

}  // namespace

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

// Sentence-pair sample map for BERT-style datasets: rows of
// (start_sentence, end_sentence, target_seq_length). Two-phase: with
// maps == nullptr only counts; with maps != nullptr fills and applies the
// seed+1 Fisher-Yates shuffle. RNG sequences use std::mt19937 exactly as
// the reference so the produced maps are bit-identical.
// Parity: ref helpers.cpp build_mapping_impl (:187-410).
int64_t build_mapping(const int64_t* docs, int64_t n_doc_bounds,
                      const int32_t* sizes, int32_t num_epochs,
                      uint64_t max_num_samples, int32_t max_seq_length,
                      double short_seq_prob, int32_t seed,
                      int32_t min_num_sent, int64_t* maps) {
  int32_t short_seq_ratio = 0;
  if (short_seq_prob > 0) {
    short_seq_ratio =
        static_cast<int32_t>(std::lround(1.0 / short_seq_prob));
  }
  const bool fill = maps != nullptr;
  std::mt19937 gen(seed);
  uint64_t map_index = 0;
  for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
    if (map_index >= max_num_samples) break;
    for (int64_t doc = 0; doc < n_doc_bounds - 1; ++doc) {
      const int64_t sent_first = docs[doc];
      const int64_t sent_last = docs[doc + 1];
      int64_t prev_start = sent_first;
      int64_t num_remain = sent_last - sent_first;

      bool has_long = false;
      if (num_remain > 1) {
        for (int64_t s = sent_first; s < sent_last; ++s) {
          if (sizes[s] > kLongSentenceLen) {
            has_long = true;
            break;
          }
        }
      }
      if (num_remain < min_num_sent || has_long) continue;

      int32_t seq_len = 0;
      int32_t num_sent = 0;
      int32_t target = target_sample_len(short_seq_ratio, max_seq_length, gen);
      for (int64_t s = sent_first; s < sent_last; ++s) {
        seq_len += sizes[s];
        ++num_sent;
        --num_remain;
        if (((seq_len >= target) && (num_remain > 1) &&
             (num_sent >= min_num_sent)) ||
            (num_remain == 0)) {
          if (fill) {
            maps[3 * map_index] = prev_start;
            maps[3 * map_index + 1] = s + 1;
            maps[3 * map_index + 2] = target;
          }
          ++map_index;
          prev_start = s + 1;
          target = target_sample_len(short_seq_ratio, max_seq_length, gen);
          seq_len = 0;
          num_sent = 0;
        }
      }
    }
  }
  if (fill) shuffle_rows(maps, static_cast<int64_t>(map_index), 3, seed);
  return static_cast<int64_t>(map_index);
}

// Sentence-block sample map for ICT/REALM-style datasets: rows of
// (start_sentence, end_sentence, doc_index, block_id), a block closing
// once it reaches max_seq_length less the document's title. The same
// two phases and seed+1 shuffle as build_mapping; no draw decides a
// block, so only the shuffle uses the seed.
// Parity: ref helpers.cpp build_blocks_mapping_impl (:453-656).
int64_t build_blocks_mapping(const int64_t* docs, int64_t n_doc_bounds,
                             const int32_t* sizes,
                             const int32_t* titles_sizes, int32_t num_epochs,
                             uint64_t max_num_samples, int32_t max_seq_length,
                             int32_t seed, int32_t use_one_sent_blocks,
                             int64_t* maps) {
  const int32_t min_num_sent = use_one_sent_blocks ? 1 : 2;
  const bool fill = maps != nullptr;
  uint64_t map_index = 0;
  for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
    int32_t block_id = 0;
    if (map_index >= max_num_samples) break;
    for (int64_t doc = 0; doc < n_doc_bounds - 1; ++doc) {
      const int64_t sent_first = docs[doc];
      const int64_t sent_last = docs[doc + 1];
      const int32_t target = max_seq_length - titles_sizes[doc];
      int64_t prev_start = sent_first;
      int64_t num_remain = sent_last - sent_first;

      bool has_long = false;
      if (num_remain >= min_num_sent) {
        for (int64_t s = sent_first; s < sent_last; ++s) {
          if (sizes[s] > kLongSentenceLen) {
            has_long = true;
            break;
          }
        }
      }
      if (num_remain < min_num_sent || has_long) continue;

      int32_t seq_len = 0;
      int32_t num_sent = 0;
      for (int64_t s = sent_first; s < sent_last; ++s) {
        seq_len += sizes[s];
        ++num_sent;
        --num_remain;
        if (((seq_len >= target) && (num_remain >= min_num_sent) &&
             (num_sent >= min_num_sent)) ||
            (num_remain == 0)) {
          if (fill) {
            maps[4 * map_index] = prev_start;
            maps[4 * map_index + 1] = s + 1;
            maps[4 * map_index + 2] = doc;
            maps[4 * map_index + 3] = block_id;
          }
          ++map_index;
          ++block_id;
          prev_start = s + 1;
          seq_len = 0;
          num_sent = 0;
        }
      }
    }
  }
  if (fill) shuffle_rows(maps, static_cast<int64_t>(map_index), 4, seed);
  return static_cast<int64_t>(map_index);
}

}  // extern "C"
