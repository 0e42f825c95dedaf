// reve_core — native pipeline core: segment planner, SPSC frame ring,
// progress counters.
//
// The reference's pipeline core is native (Rust: reve-shared/src/lib.rs) —
// this is the equivalent native layer for the TPU rebuild.  The planner is
// the single source of truth shared with the Python layer (tests assert
// parity); the ring buffer is the zero-copy frame hand-off between decode
// threads and the engine feeder (bounded, with blocking push/pop and
// shutdown), and the counters are the lock-free progress backend.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

// ------------------------------------------------------------- planner -----

extern "C" {

// Frame-exact segment plan: tiles [0, frames) with ceil(frames/segsize)
// segments (no reference-style remainder-1 tail; SURVEY.md §2.5).
// Returns segment count, or -1 if cap too small / bad args.
long rc_plan_segments(long frames, long segsize, long* starts, long* sizes,
                      long cap) {
  if (frames <= 0 || segsize <= 0) return -1;
  long n = (frames + segsize - 1) / segsize;
  if (n > cap) return -1;
  long start = 0;
  for (long i = 0; i < n; i++) {
    long size = frames - start < segsize ? frames - start : segsize;
    starts[i] = start;
    sizes[i] = size;
    start += size;
  }
  return n;
}

}  // extern "C"

// ------------------------------------------------- SPSC frame ring buffer ---

namespace {

struct FrameRing {
  std::vector<uint8_t> data;   // capacity * frame_bytes
  size_t frame_bytes;
  size_t capacity;
  std::atomic<uint64_t> head{0};  // next write slot
  std::atomic<uint64_t> tail{0};  // next read slot
  std::atomic<bool> closed{false};
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
};

}  // namespace

extern "C" {

void* rc_ring_create(long frame_bytes, long capacity) {
  auto* r = new FrameRing();
  r->frame_bytes = size_t(frame_bytes);
  r->capacity = size_t(capacity);
  r->data.resize(r->frame_bytes * r->capacity);
  return r;
}

void rc_ring_destroy(void* ring) { delete static_cast<FrameRing*>(ring); }

void rc_ring_close(void* ring) {
  auto* r = static_cast<FrameRing*>(ring);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed.store(true);
  }
  r->cv_push.notify_all();
  r->cv_pop.notify_all();
}

// Blocking push; returns 0 ok, 1 closed, 2 timeout. timeout_ms<0 = forever.
int rc_ring_push(void* ring, const uint8_t* frame, long timeout_ms) {
  auto* r = static_cast<FrameRing*>(ring);
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [&] {
    return r->closed.load() || r->head.load() - r->tail.load() < r->capacity;
  };
  if (timeout_ms < 0) r->cv_push.wait(lk, pred);
  else if (!r->cv_push.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                pred))
    return 2;
  if (r->closed.load()) return 1;
  uint64_t slot = r->head.load() % r->capacity;
  std::memcpy(&r->data[slot * r->frame_bytes], frame, r->frame_bytes);
  r->head.fetch_add(1);
  lk.unlock();
  r->cv_pop.notify_one();
  return 0;
}

// Blocking pop; returns 0 ok, 1 closed-and-empty, 2 timeout.
int rc_ring_pop(void* ring, uint8_t* frame_out, long timeout_ms) {
  auto* r = static_cast<FrameRing*>(ring);
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [&] {
    return r->head.load() != r->tail.load() || r->closed.load();
  };
  if (timeout_ms < 0) r->cv_pop.wait(lk, pred);
  else if (!r->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                               pred))
    return 2;
  if (r->head.load() == r->tail.load()) return 1;  // closed and drained
  uint64_t slot = r->tail.load() % r->capacity;
  std::memcpy(frame_out, &r->data[slot * r->frame_bytes], r->frame_bytes);
  r->tail.fetch_add(1);
  lk.unlock();
  r->cv_push.notify_one();
  return 0;
}

long rc_ring_size(void* ring) {
  auto* r = static_cast<FrameRing*>(ring);
  return long(r->head.load() - r->tail.load());
}

// ------------------------------------------------------ progress counters ---

void* rc_counters_create(long n) {
  auto* c = new std::atomic<int64_t>[n];
  for (long i = 0; i < n; i++) c[i].store(0);
  return c;
}

void rc_counters_destroy(void* counters) {
  delete[] static_cast<std::atomic<int64_t>*>(counters);
}

void rc_counter_add(void* counters, long idx, long delta) {
  static_cast<std::atomic<int64_t>*>(counters)[idx].fetch_add(delta);
}

long rc_counter_get(void* counters, long idx) {
  return long(static_cast<std::atomic<int64_t>*>(counters)[idx].load());
}

}  // extern "C"
