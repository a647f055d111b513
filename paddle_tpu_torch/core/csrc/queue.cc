// Bounded blocking queue of byte buffers (the C ABI of the reference's
// runtime_cpp/queue.cc, the port's own copy): the DataLoader's thread
// workers push pickled numpy batches, the consumer pops them and makes the
// tensors. Producers block while the queue is full and copy their bytes in
// with the GIL released (ctypes drops it around every call); close() wakes
// every waiter, after which push fails and pop drains what is left, then
// reports the end.
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

class BlockingQueue {
 public:
  explicit BlockingQueue(size_t capacity) : capacity_(capacity) {}

  // 0 on success, -1 when closed
  int Push(const uint8_t* bytes, size_t n) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return closed_ || q_.size() < capacity_; });
    if (closed_) return -1;
    q_.emplace_back(bytes, bytes + n);
    not_empty_.notify_one();
    return 0;
  }

  // The size of the next buffer (it stays queued), 0 once closed and
  // drained. PopInto then takes it into the caller's storage.
  int64_t PopSize() {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return 0;
    return static_cast<int64_t>(q_.front().size());
  }

  // The buffer's size, 0 once closed and drained, -1 when it does not fit
  // (it is dropped).
  int64_t PopInto(uint8_t* out, size_t out_cap) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return 0;
    std::vector<uint8_t> b = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    if (b.size() > out_cap) return -1;
    std::memcpy(out, b.data(), b.size());
    return static_cast<int64_t>(b.size());
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  size_t capacity_;
  bool closed_ = false;
  std::deque<std::vector<uint8_t>> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
};

BlockingQueue* Q(void* q) { return static_cast<BlockingQueue*>(q); }

}  // namespace

extern "C" {

void* ptq_create(int64_t capacity) {
  return new BlockingQueue(static_cast<size_t>(capacity));
}

int ptq_push(void* q, const uint8_t* bytes, int64_t n) {
  return Q(q)->Push(bytes, static_cast<size_t>(n));
}

int64_t ptq_pop_size(void* q) { return Q(q)->PopSize(); }

int64_t ptq_pop_into(void* q, uint8_t* out, int64_t cap) {
  return Q(q)->PopInto(out, static_cast<size_t>(cap));
}

void ptq_close(void* q) { Q(q)->Close(); }

int64_t ptq_size(void* q) { return static_cast<int64_t>(Q(q)->Size()); }

void ptq_destroy(void* q) { delete Q(q); }

}  // extern "C"
