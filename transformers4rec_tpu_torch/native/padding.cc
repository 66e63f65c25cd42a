// Host-side data kernels of the loader: ragged -> dense padding and row
// gathers for batch assembly.
//
// Counterpart of transformers4rec_tpu/native/padding.cc, the same
// arithmetic (memcpy and memset only, so the results are numpy's bit for
// bit). The reference's dataloader does this work in cuDF kernels; here it
// runs on the host between storage and the copy to the card.
//
// C ABI (loaded with ctypes by native/__init__.py):
//   pad_ragged_{f32,i64,i32}: values + offsets -> zero-padded dense
//     [n_rows, max_len], keeping the first max_len items of each row
//   gather_rows: rows of a 2-D (or flattened N-D) array by index
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread padding.cc -o lib.so
// Rows fan out over std::thread ranges (no OpenMP runtime needed).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_rows(int64_t n_rows, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::min<int64_t>(hw ? hw : 4, std::max<int64_t>(n_rows / 256, 1));
  if (n_threads <= 1) {
    fn(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(lo + chunk, n_rows);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

template <typename T>
void pad_ragged_impl(const T* values, const int64_t* offsets, int64_t n_rows,
                     int64_t max_len, T* out) {
  parallel_rows(n_rows, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t start = offsets[r];
      int64_t len = std::min<int64_t>(offsets[r + 1] - start, max_len);
      T* dst = out + r * max_len;
      std::memcpy(dst, values + start, len * sizeof(T));
      std::memset(dst + len, 0, (max_len - len) * sizeof(T));
    }
  });
}

}  // namespace

extern "C" {

void pad_ragged_f32(const float* values, const int64_t* offsets, int64_t n_rows,
                    int64_t max_len, float* out) {
  pad_ragged_impl(values, offsets, n_rows, max_len, out);
}

void pad_ragged_i64(const int64_t* values, const int64_t* offsets,
                    int64_t n_rows, int64_t max_len, int64_t* out) {
  pad_ragged_impl(values, offsets, n_rows, max_len, out);
}

void pad_ragged_i32(const int32_t* values, const int64_t* offsets,
                    int64_t n_rows, int64_t max_len, int32_t* out) {
  pad_ragged_impl(values, offsets, n_rows, max_len, out);
}

// row_bytes = product(trailing dims) * itemsize
void gather_rows(const char* src, const int64_t* indices, int64_t n_indices,
                 int64_t row_bytes, char* out) {
  parallel_rows(n_indices, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(out + r * row_bytes, src + indices[r] * row_bytes, row_bytes);
    }
  });
}

}  // extern "C"
