// Host staging ring: page-aligned, reusable feed buffers.
//
// Reference analog: paddle/fluid/memory pinned-host allocations + the
// DataProvider double buffer: batches are assembled into page-locked
// memory so the card's copy engine never waits on pageable copies. The
// role here (reader/staging.py): a producer thread packs `steps` batches
// contiguously into one aligned superbatch buffer while the previous
// window trains; the consumer wraps the buffer zero-copy as CPU tensors
// and issues one host-to-device copy per field per window, from a slot
// page-locked once with cudaHostRegister, feeding
// Executor.run_steps(stacked_feed=True). Page alignment keeps each
// field's copy on the aligned DMA route; buffer reuse means
// steady-state feeding allocates nothing on the host.
//
// States per slot: FREE -> (producer) FILLING -> READY -> (consumer)
// CONSUMING -> FREE. Plain C ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread staging.cpp -o libstaging.so

#include <cstdint>
#include <cstdlib>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr size_t kAlign = 4096;  // page alignment for the DMA path

struct Ring {
  struct Slot {
    uint8_t* data = nullptr;
    uint64_t len = 0;        // committed bytes
    int state = 0;           // 0 FREE, 1 FILLING, 2 READY, 3 CONSUMING
  };
  std::vector<Slot> slots;
  uint64_t capacity = 0;
  size_t produce_idx = 0;    // next slot to hand to the producer
  size_t consume_idx = 0;    // next slot to hand to the consumer
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv;

  ~Ring() {
    for (auto& s : slots) std::free(s.data);
  }
};

}  // namespace

extern "C" {

// Ring of n_buffers aligned buffers of buf_bytes each. Returns nullptr
// on allocation failure.
void* staging_open(uint64_t buf_bytes, int n_buffers) {
  if (buf_bytes == 0 || n_buffers < 2) return nullptr;
  auto* r = new Ring();
  r->capacity = buf_bytes;
  r->slots.resize(n_buffers);
  uint64_t rounded = (buf_bytes + kAlign - 1) / kAlign * kAlign;
  for (auto& s : r->slots) {
    s.data = static_cast<uint8_t*>(std::aligned_alloc(kAlign, rounded));
    if (!s.data) {
      delete r;
      return nullptr;
    }
  }
  return r;
}

uint64_t staging_capacity(void* h) {
  return static_cast<Ring*>(h)->capacity;
}

// Producer: block until a FREE slot is available, return its buffer.
// Returns nullptr if the ring was closed.
uint8_t* staging_acquire_fill(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  auto& s = r->slots[r->produce_idx];
  r->cv.wait(lk, [&] { return r->closed || s.state == 0; });
  if (r->closed) return nullptr;
  s.state = 1;
  return s.data;
}

// Producer: mark the slot acquired by staging_acquire_fill as READY with
// `len` valid bytes. Returns 0, or -1 on misuse (no slot being filled /
// len over capacity).
int staging_commit(void* h, uint64_t len) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  auto& s = r->slots[r->produce_idx];
  if (s.state != 1 || len > r->capacity) return -1;
  s.len = len;
  s.state = 2;
  r->produce_idx = (r->produce_idx + 1) % r->slots.size();
  r->cv.notify_all();
  return 0;
}

// Consumer: block until a READY slot exists; returns its buffer and
// writes the committed length. nullptr when closed and drained.
const uint8_t* staging_acquire_read(void* h, uint64_t* out_len) {
  auto* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  auto& s = r->slots[r->consume_idx];
  r->cv.wait(lk, [&] { return r->closed || s.state == 2; });
  if (s.state != 2) return nullptr;  // closed with nothing staged
  s.state = 3;
  *out_len = s.len;
  return s.data;
}

// Consumer: return the slot from staging_acquire_read to the FREE pool.
int staging_release(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  auto& s = r->slots[r->consume_idx];
  if (s.state != 3) return -1;
  s.state = 0;
  r->consume_idx = (r->consume_idx + 1) % r->slots.size();
  r->cv.notify_all();
  return 0;
}

// Unblock all waiters; slots already READY can still be drained.
void staging_close_ring(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  r->closed = true;
  r->cv.notify_all();
}

void staging_free(void* h) {
  delete static_cast<Ring*>(h);
}

}  // extern "C"
