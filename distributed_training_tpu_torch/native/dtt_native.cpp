// Native host-side data-loader kernels (the port's own copy of the JAX
// package's native/dtt_native.cpp, the same code).
//
// Batch assembly is a strided row-gather over columnar NumPy storage,
// which NumPy executes single-threaded. These kernels do the
// same gather (and the synthetic-data fills) multithreaded, bound via
// ctypes from distributed_training_tpu_torch/native/__init__.py.
//
// Build: g++ -O3 -march=native -shared -fPIC (driven by the Python
// wrapper, cached in distributed_training_tpu_torch/build/).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int clamp_threads(int requested, std::int64_t work_items) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    std::int64_t cap = std::min<std::int64_t>(
        requested > 0 ? requested : static_cast<std::int64_t>(hw),
        work_items);
    return static_cast<int>(std::max<std::int64_t>(cap, 1));
}

template <typename Fn>
void parallel_chunks(std::int64_t n, int n_threads, Fn fn) {
    if (n_threads <= 1 || n < 2) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    std::int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        std::int64_t lo = t * chunk;
        std::int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        pool.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& th : pool) th.join();
}

// SplitMix64: tiny, seedable, statistically solid for synthetic data.
inline std::uint64_t splitmix64(std::uint64_t& s) {
    std::uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d4a2ca9c8de917ULL;
    return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// Gather rows: out[i, :] = src[idx[i], :], rows treated as raw bytes
// (dtype-agnostic). Returns 0 on success, -1 on an out-of-range index
// (checked up front so partial output is never silently wrong).
int dtt_gather_rows(const char* src, std::int64_t n_src_rows,
                    std::int64_t row_bytes, const std::int64_t* idx,
                    std::int64_t n_idx, char* out, int n_threads) {
    for (std::int64_t i = 0; i < n_idx; ++i) {
        if (idx[i] < 0 || idx[i] >= n_src_rows) return -1;
    }
    // Thread spawn costs ~10us; only worth it for multi-MB gathers.
    int threads = (n_idx * row_bytes < (1 << 20))
                      ? 1
                      : clamp_threads(n_threads, n_idx);
    parallel_chunks(n_idx, threads, [=](std::int64_t lo, std::int64_t hi) {
        for (std::int64_t i = lo; i < hi; ++i) {
            std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes,
                        static_cast<std::size_t>(row_bytes));
        }
    });
    return 0;
}

// Fill `n` int32 tokens uniformly in [0, vocab). Deterministic in
// (seed); parallel chunks reseed per-chunk so the output is identical
// for any thread count.
void dtt_fill_tokens(std::int64_t seed, std::int64_t vocab,
                     std::int32_t* out, std::int64_t n, int n_threads) {
    const std::int64_t block = 4096;
    std::int64_t n_blocks = (n + block - 1) / block;
    int threads = clamp_threads(n_threads, n_blocks);
    parallel_chunks(n_blocks, threads,
                    [=](std::int64_t lo, std::int64_t hi) {
        for (std::int64_t b = lo; b < hi; ++b) {
            std::uint64_t s = static_cast<std::uint64_t>(seed) ^
                              (0xd1342543de82ef95ULL *
                               static_cast<std::uint64_t>(b + 1));
            std::int64_t end = std::min(n, (b + 1) * block);
            for (std::int64_t i = b * block; i < end; ++i) {
                out[i] = static_cast<std::int32_t>(
                    splitmix64(s) % static_cast<std::uint64_t>(vocab));
            }
        }
    });
}

}  // extern "C"
