// Native batch assembly — the data-loader hot path.
//
// The port's own copy of bigdl_tpu/native/batchpack.cpp, built by
// bigdl_tpu_torch/native/__init__.py with the local g++ into build/native/.
//
// Reference parity (SURVEY.md §2.4): the reference's input pipeline leans on
// native code (OpenCV JNI decode, JVM-side contiguous Sample storage). The
// equivalent here is this small library: stacking N sample buffers into one
// contiguous batch is pure memcpy work that Python does under the GIL
// (np.stack); calling it through ctypes releases the GIL, so the prefetch
// producer thread assembles batch k+1 while the main thread dispatches step k
// — the exact overlap the pipeline exists for.
//
// Built on demand with: g++ -O3 -shared -fPIC -std=c++17 -pthread.

#include <cstring>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Copy n source buffers of nbytes each into dst (contiguous, stride nbytes).
void pack_batch(const void** srcs, int64_t n, int64_t nbytes, void* dst) {
    char* out = static_cast<char*>(dst);
    // memcpy is memory-bandwidth bound; split across a few threads only when
    // the batch is large enough to amortise thread startup
    const int64_t total = n * nbytes;
    const int64_t kParallelThreshold = 8 << 20;  // 8 MB
    int hw = (int)std::thread::hardware_concurrency();
    if (total < kParallelThreshold || n < 2 || hw < 2) {
        for (int64_t i = 0; i < n; ++i)
            std::memcpy(out + i * nbytes, srcs[i], (size_t)nbytes);
        return;
    }
    int n_threads = hw < 4 ? hw : 4;
    if (n_threads > n) n_threads = (int)n;
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
        workers.emplace_back([=]() {
            for (int64_t i = t; i < n; i += n_threads)
                std::memcpy(out + i * nbytes, srcs[i], (size_t)nbytes);
        });
    }
    for (auto& w : workers) w.join();
}

// Gather rows: dst[i] = src[idx[i]] for row-sized nbytes — index-side shuffle
// without Python-level loops.
void gather_rows(const void* src, const int64_t* idx, int64_t n,
                 int64_t nbytes, void* dst) {
    const char* in = static_cast<const char*>(src);
    char* out = static_cast<char*>(dst);
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(out + i * nbytes, in + idx[i] * nbytes, (size_t)nbytes);
}

}  // extern "C"
