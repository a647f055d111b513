// Host event and span rings of the port's profiler (the C ABI of the
// reference's runtime_cpp/trace.cc, the port's own copy). Two fixed-size
// rings: flat events (name_id, tid, t0, t1) from RecordEvent, and finished
// spans (the same plus span_id, parent_id) from the span tracer. A writer
// claims a slot with one relaxed atomic add on the ring's cursor, so any
// number of threads record without a lock; the newest `capacity` records
// survive a wraparound, and `ptt_dropped` counts the ones it overwrote.
// Names are interned once under a mutex. The rings hold timing only:
// nesting is rebuilt from the ids and attributes stay in Python, joined by
// span id at export.
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Event {
  uint32_t name_id;
  uint32_t tid;
  uint64_t t0;
  uint64_t t1;
};

struct SpanEvent {
  uint32_t name_id;
  uint32_t tid;
  uint64_t t0;
  uint64_t t1;
  uint64_t span_id;
  uint64_t parent_id;
};

template <typename T>
class Ring {
 public:
  explicit Ring(size_t capacity) : slots_(capacity), cursor_(0) {}

  void Push(const T& rec) {
    size_t i = cursor_.fetch_add(1, std::memory_order_relaxed) % slots_.size();
    slots_[i] = rec;
  }

  // Copy out up to n records, oldest first, of the most recent window.
  int64_t Drain(T* out, size_t n) const {
    size_t total = cursor_.load(std::memory_order_relaxed);
    size_t avail = total < slots_.size() ? total : slots_.size();
    size_t count = avail < n ? avail : n;
    for (size_t k = 0; k < count; ++k)
      out[k] = slots_[(total - avail + k) % slots_.size()];
    return static_cast<int64_t>(count);
  }

  // Records overwritten since the last reset: the cursor past the capacity.
  int64_t Dropped() const {
    size_t total = cursor_.load(std::memory_order_relaxed);
    return static_cast<int64_t>(total > slots_.size() ? total - slots_.size()
                                                       : 0);
  }

  void Reset() { cursor_.store(0); }

 private:
  std::vector<T> slots_;
  std::atomic<size_t> cursor_;
};

class Recorder {
 public:
  explicit Recorder(size_t capacity) : events_(capacity), spans_(capacity) {}

  uint32_t InternName(const char* name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = name_ids_.find(name);
    if (it != name_ids_.end()) return it->second;
    uint32_t id = static_cast<uint32_t>(names_.size());
    names_.emplace_back(name);
    name_ids_[name] = id;
    return id;
  }

  const char* Name(uint32_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    return id < names_.size() ? names_[id].c_str() : "";
  }

  void Reset() {
    events_.Reset();
    spans_.Reset();
  }

  Ring<Event> events_;
  Ring<SpanEvent> spans_;

 private:
  std::vector<std::string> names_;
  std::unordered_map<std::string, uint32_t> name_ids_;
  std::mutex mu_;
};

uint64_t NowNs() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

Recorder* R(void* r) { return static_cast<Recorder*>(r); }

}  // namespace

extern "C" {

void* ptt_create(int64_t capacity) {
  return new Recorder(static_cast<size_t>(capacity));
}

void ptt_destroy(void* r) { delete R(r); }

uint32_t ptt_intern(void* r, const char* name) { return R(r)->InternName(name); }

uint64_t ptt_now_ns() { return NowNs(); }

void ptt_record(void* r, uint32_t name_id, uint32_t tid, uint64_t t0,
                uint64_t t1) {
  R(r)->events_.Push(Event{name_id, tid, t0, t1});
}

// out layout per event: name_id u32 | tid u32 | t0 u64 | t1 u64 (24 bytes)
int64_t ptt_drain(void* r, uint8_t* out, int64_t max_events) {
  std::vector<Event> tmp(static_cast<size_t>(max_events));
  int64_t n = R(r)->events_.Drain(tmp.data(), tmp.size());
  std::memcpy(out, tmp.data(), static_cast<size_t>(n) * sizeof(Event));
  return n;
}

void ptt_span_record(void* r, uint32_t name_id, uint32_t tid, uint64_t t0,
                     uint64_t t1, uint64_t span_id, uint64_t parent_id) {
  R(r)->spans_.Push(SpanEvent{name_id, tid, t0, t1, span_id, parent_id});
}

// out layout per span: name_id u32 | tid u32 | t0 u64 | t1 u64 | span_id u64
// | parent_id u64 (40 bytes)
int64_t ptt_span_drain(void* r, uint8_t* out, int64_t max_spans) {
  std::vector<SpanEvent> tmp(static_cast<size_t>(max_spans));
  int64_t n = R(r)->spans_.Drain(tmp.data(), tmp.size());
  std::memcpy(out, tmp.data(), static_cast<size_t>(n) * sizeof(SpanEvent));
  return n;
}

const char* ptt_name(void* r, uint32_t id) { return R(r)->Name(id); }

void ptt_reset(void* r) { R(r)->Reset(); }

// Records a wraparound overwrote since the last reset, of the event ring
// (span_ring 0) or the span ring (1); an addition to the reference's ABI.
int64_t ptt_dropped(void* r, int32_t span_ring) {
  return span_ring ? R(r)->spans_.Dropped() : R(r)->events_.Dropped();
}

}  // extern "C"
