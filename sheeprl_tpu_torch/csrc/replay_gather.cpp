// Native replay-buffer gather kernels (host C++; the port's own copy of
// sheeprl_tpu/native/replay_gather.cpp).
//
// The sequential replay sample is thousands of strided row copies per
// gradient step; here it is a multithreaded memcpy loop, bound to Python
// with ctypes (sheeprl_tpu_torch/data/native.py builds it with g++).
//
// Layout contract: `src` is a C-contiguous [R, F] byte matrix (R = rows =
// buffer_size * n_envs, F = row bytes); `row_idx` holds N row indices in
// *destination* order, so dst is written once, contiguously, already in the
// [n_samples, seq_len, batch, ...] layout the training step wants (the numpy
// path needs an extra transpose+copy to get there).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Copy rows src[row_idx[i]] -> dst[i] for i in [0, n_out).
void gather_rows(const char* src,
                 int64_t row_bytes,
                 const int64_t* row_idx,
                 int64_t n_out,
                 char* dst,
                 int32_t n_threads) {
  if (n_out <= 0 || row_bytes <= 0) return;
  const int64_t total_bytes = n_out * row_bytes;
  // Small gathers: threading overhead dominates.
  int32_t workers = n_threads;
  if (workers <= 0) workers = 1;
  if (total_bytes < (1 << 20)) workers = 1;
  workers = std::min<int64_t>(workers, n_out);

  auto copy_range = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      std::memcpy(dst + i * row_bytes, src + row_idx[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };

  if (workers == 1) {
    copy_range(0, n_out);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  const int64_t chunk = (n_out + workers - 1) / workers;
  for (int32_t t = 0; t < workers; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end = std::min<int64_t>(begin + chunk, n_out);
    if (begin >= end) break;
    threads.emplace_back(copy_range, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
