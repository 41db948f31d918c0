// Native host-side data path for the trainer's DataLoader (PyTorch port).
//
// The reference's data plane rides on torch DataLoader worker *processes*
// (hf_llm_training.py -> transformers.Trainer); a TPU host feeding one or
// more chips wants the opposite design: no pickling/IPC, just a
// memory-bandwidth-bound gather of shuffled rows out of a (possibly
// memory-mapped) token arena into a contiguous staging buffer that the
// loader copies to the card from pinned memory, running on real OS threads
// outside the Python GIL so it overlaps the device step.
//
// C ABI (consumed via ctypes from training_operator_tpu_torch/native/__init__.py):
//   tod_gather_rows     threaded strided row gather (int32 rows)
//   tod_pack_tokens     flat token stream -> [n, row] matrix
//   tod_prefetcher_*    double-buffered background gather pipeline
//
// Built on demand by native/__init__.py _build():
//   g++ -O3 -std=c++17 -shared -fPIC -pthread
// (into training_operator_tpu_torch/build/, keyed by source + command).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// Copy rows[idx[i]] for i in [0, n_idx) into out (contiguous [n_idx, row_len]).
// Returns 0 on success, -1 on bad arguments. Bounds-checks every index so a
// corrupt shuffle order cannot scribble outside the arena.
int tod_gather_rows(const int32_t* base, int64_t n_rows, int64_t row_len,
                    const int64_t* idx, int64_t n_idx, int32_t* out,
                    int32_t n_threads) {
  if (base == nullptr || idx == nullptr || out == nullptr) return -1;
  if (n_rows < 0 || row_len <= 0 || n_idx < 0) return -1;
  for (int64_t i = 0; i < n_idx; ++i) {
    if (idx[i] < 0 || idx[i] >= n_rows) return -1;
  }
  const size_t row_bytes = static_cast<size_t>(row_len) * sizeof(int32_t);
  if (n_threads <= 1 || n_idx < 2 * n_threads) {
    for (int64_t i = 0; i < n_idx; ++i) {
      std::memcpy(out + i * row_len, base + idx[i] * row_len, row_bytes);
    }
    return 0;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int64_t per = (n_idx + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(n_idx, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(out + i * row_len, base + idx[i] * row_len, row_bytes);
      }
    });
  }
  for (auto& t : ts) t.join();
  return 0;
}

// Pack the first n_rows*(row_len) tokens of a flat stream into [n_rows,
// row_len] (the Python side computes n_rows = len(stream) // row_len and
// drops the remainder). One big memcpy — here for ABI completeness so a
// caller can stage straight from an mmap'd token file.
int tod_pack_tokens(const int32_t* stream, int64_t n_rows, int64_t row_len,
                    int32_t* out) {
  if (stream == nullptr || out == nullptr || n_rows < 0 || row_len <= 0)
    return -1;
  std::memcpy(out, stream,
              static_cast<size_t>(n_rows) * row_len * sizeof(int32_t));
  return 0;
}

// ---------------------------------------------------------------------------
// Background prefetcher: one worker thread, one request slot, one result
// slot. The Python loader submits the NEXT batch's indices while the device
// runs the CURRENT step; wait() blocks only if the gather hasn't finished.
// Double buffering comes from the caller alternating two staging buffers.

struct TodPrefetcher {
  const int32_t* base;
  int64_t n_rows;
  int64_t row_len;
  int32_t n_threads;

  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;

  // Request slot (guarded by mu).
  std::vector<int64_t> req_idx;
  int32_t* req_out = nullptr;
  bool has_req = false;
  // True from submit until the result is consumed by wait — this is what
  // distinguishes "worker is mid-gather" (has_req already false, result
  // not yet posted) from "nothing submitted". Without it, a wait() landing
  // in that window reads as a protocol error and the caller may free the
  // staging buffer while the worker is still writing into it.
  bool in_flight = false;
  // Result slot (guarded by mu).
  bool has_result = false;
  int result_rc = 0;
  bool stop = false;

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [&] { return has_req || stop; });
      if (stop) return;
      std::vector<int64_t> idx = std::move(req_idx);
      int32_t* out = req_out;
      has_req = false;
      lk.unlock();
      int rc = tod_gather_rows(base, n_rows, row_len, idx.data(),
                               static_cast<int64_t>(idx.size()), out,
                               n_threads);
      lk.lock();
      result_rc = rc;
      has_result = true;
      cv.notify_all();
    }
  }
};

void* tod_prefetcher_create(const int32_t* base, int64_t n_rows,
                            int64_t row_len, int32_t n_threads) {
  if (base == nullptr || n_rows < 0 || row_len <= 0) return nullptr;
  auto* p = new TodPrefetcher();
  p->base = base;
  p->n_rows = n_rows;
  p->row_len = row_len;
  p->n_threads = n_threads;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Submit a gather of idx[0..n_idx) into out. Returns -2 if a request is
// already in flight (the caller must wait() first), -1 on bad args.
int tod_prefetcher_submit(void* handle, const int64_t* idx, int64_t n_idx,
                          int32_t* out) {
  auto* p = static_cast<TodPrefetcher*>(handle);
  if (p == nullptr || idx == nullptr || out == nullptr || n_idx < 0) return -1;
  std::lock_guard<std::mutex> lk(p->mu);
  if (p->in_flight) return -2;
  p->req_idx.assign(idx, idx + n_idx);
  p->req_out = out;
  p->has_req = true;
  p->in_flight = true;
  p->cv.notify_all();
  return 0;
}

// Block until the in-flight gather completes; returns its rc, or -2 if
// nothing was submitted.
int tod_prefetcher_wait(void* handle) {
  auto* p = static_cast<TodPrefetcher*>(handle);
  if (p == nullptr) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  if (!p->in_flight) return -2;
  p->cv.wait(lk, [&] { return p->has_result; });
  p->has_result = false;
  p->in_flight = false;
  return p->result_rc;
}

void tod_prefetcher_destroy(void* handle) {
  auto* p = static_cast<TodPrefetcher*>(handle);
  if (p == nullptr) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv.notify_all();
  }
  p->worker.join();
  delete p;
}

}  // extern "C"
