// Native host-side hot path of the UL2 collator.
//
// The reference identifies collator packing on the host CPU as a training
// hot loop (SURVEY.md §3.1 "hot loops"); its Python implementation
// (src/data/data_collator_ul2.py:49-87, :222-295) re-scans every remaining
// example per bin. This C++ core implements:
//   - random span-noise mask generation (Mesh-TF random_spans_noise_mask
//     semantics incl. the single-suffix-span S-denoiser case)
//   - greedy first-fit bin packing with input-length / label-length /
//     sentinel-budget constraints
// exposed via a plain C ABI for ctypes.
//
// A copy of flasht5_tpu/native/ul2_core.cpp. Built at first use by
// flasht5_tpu_torch/native/__init__.py (g++ -O3 -fPIC -shared -std=c++17)
// into the package's build/ directory.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Fill `out_mask[0..length)` with the alternating nonnoise/noise span mask.
// max_spans == 1 forces a single suffix span of ~length*(1 - 1/mu) tokens
// (reference: data_collator_ul2.py:246-250). Returns number of noise tokens.
int64_t ul2_random_spans_noise_mask(int64_t length, double mu, double r,
                                    int64_t max_spans, uint64_t seed,
                                    uint8_t* out_mask) {
  std::memset(out_mask, 0, static_cast<size_t>(length));
  if (length <= 1) return 0;

  std::mt19937_64 rng(seed);
  std::vector<int64_t> interleaved;

  if (max_spans == 1) {
    int64_t prefix = static_cast<int64_t>(std::llround(length / mu));
    interleaved = {prefix, length - prefix};
  } else {
    int64_t num_noise = static_cast<int64_t>(std::llround(length * r));
    num_noise = std::min(std::max<int64_t>(num_noise, 1), length - 1);
    int64_t num_spans =
        std::min(max_spans, static_cast<int64_t>(std::llround(num_noise / mu)));
    num_spans = std::max<int64_t>(num_spans, 1);
    int64_t num_nonnoise = length - num_noise;

    // random partition of n items into k positive segments:
    // shuffle k-1 ones among n-1 slots, segment lengths = gaps
    auto segment = [&rng](int64_t n, int64_t k) {
      std::vector<uint8_t> first(static_cast<size_t>(n - 1), 0);
      for (int64_t i = 0; i < k - 1; ++i) first[static_cast<size_t>(i)] = 1;
      std::shuffle(first.begin(), first.end(), rng);
      std::vector<int64_t> lengths;
      int64_t run = 1;
      for (size_t i = 0; i < first.size(); ++i) {
        if (first[i]) {
          lengths.push_back(run);
          run = 1;
        } else {
          ++run;
        }
      }
      lengths.push_back(run);
      return lengths;
    };

    auto noise_lengths = segment(num_noise, num_spans);
    auto nonnoise_lengths = segment(num_nonnoise, num_spans);
    for (int64_t s = 0; s < num_spans; ++s) {
      interleaved.push_back(nonnoise_lengths[static_cast<size_t>(s)]);
      interleaved.push_back(noise_lengths[static_cast<size_t>(s)]);
    }
  }

  int64_t pos = 0, noise_count = 0;
  for (size_t s = 0; s < interleaved.size(); ++s) {
    bool is_noise = (s % 2) == 1;
    for (int64_t i = 0; i < interleaved[s] && pos < length; ++i, ++pos) {
      out_mask[pos] = is_noise ? 1 : 0;
      noise_count += is_noise;
    }
  }
  return noise_count;
}

// Greedy first-fit packing (reference semantics: data_collator_ul2.py:49-87).
// Inputs: per-example input length, label length, sentinel count.
// Output: out_bin[i] = bin index in [0, batch_size) or -1 if unpacked.
// Returns number of bins used.
int64_t ul2_best_fit_pack(int64_t n_examples, const int64_t* len_in,
                          const int64_t* len_lb, const int64_t* n_sent,
                          int64_t max_len, int64_t max_labels,
                          int64_t sentinel_budget, int64_t batch_size,
                          int64_t* out_bin) {
  std::vector<uint8_t> used(static_cast<size_t>(n_examples), 0);
  for (int64_t i = 0; i < n_examples; ++i) out_bin[i] = -1;

  int64_t bins = 0;
  for (int64_t b = 0; b < batch_size; ++b) {
    int64_t cur_in = 0, cur_lb = 0, cur_sent = 0;
    bool any = false;
    for (int64_t i = 0; i < n_examples; ++i) {
      if (used[static_cast<size_t>(i)]) continue;
      if (cur_in + len_in[i] < max_len && cur_lb + len_lb[i] < max_labels &&
          cur_sent + n_sent[i] < sentinel_budget) {
        used[static_cast<size_t>(i)] = 1;
        out_bin[i] = b;
        cur_in += len_in[i];
        cur_lb += len_lb[i];
        cur_sent += n_sent[i];
        any = true;
      }
    }
    if (any) ++bins;
  }
  return bins;
}

}  // extern "C"
