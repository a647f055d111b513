// Host staging arena (the C ABI of the reference's runtime_cpp/arena.cc, the
// port's own copy): aligned slabs in size classes (one 4 KiB page, else the
// next power of two) with a free list a class, so a step that stages
// buffers of the same sizes again reuses its slabs instead of calling
// malloc. Thread-safe; every slab is freed with the arena.
#include <cstdint>
#include <cstdlib>
#include <map>
#include <mutex>
#include <vector>

namespace {

class Arena {
 public:
  explicit Arena(size_t align) : align_(align) {}

  ~Arena() {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : free_)
      for (void* p : kv.second) std::free(p);
    for (auto& kv : live_) std::free(kv.first);
  }

  void* Alloc(size_t n) {
    size_t rounded = SizeClass(n);
    std::lock_guard<std::mutex> lk(mu_);
    auto it = free_.find(rounded);
    if (it != free_.end() && !it->second.empty()) {
      void* p = it->second.back();
      it->second.pop_back();
      live_[p] = rounded;
      reused_++;
      return p;
    }
    void* p = nullptr;
    if (posix_memalign(&p, align_, rounded) != 0) return nullptr;
    live_[p] = rounded;
    allocated_ += rounded;
    return p;
  }

  void Free(void* p) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = live_.find(p);
    if (it == live_.end()) return;
    free_[it->second].push_back(p);
    live_.erase(it);
  }

  int64_t BytesAllocated() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<int64_t>(allocated_);
  }

  int64_t ReuseCount() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<int64_t>(reused_);
  }

 private:
  static size_t SizeClass(size_t n) {
    const size_t page = 4096;
    if (n <= page) return page;
    size_t p = page;
    while (p < n) p <<= 1;
    return p;
  }

  size_t align_;
  std::mutex mu_;
  std::map<size_t, std::vector<void*>> free_;
  std::map<void*, size_t> live_;
  size_t allocated_ = 0;
  size_t reused_ = 0;
};

Arena* A(void* a) { return static_cast<Arena*>(a); }

}  // namespace

extern "C" {

void* pta_create(int64_t align) { return new Arena(static_cast<size_t>(align)); }

void pta_destroy(void* a) { delete A(a); }

void* pta_alloc(void* a, int64_t n) {
  return A(a)->Alloc(static_cast<size_t>(n));
}

void pta_free(void* a, void* p) { A(a)->Free(p); }

int64_t pta_bytes(void* a) { return A(a)->BytesAllocated(); }

int64_t pta_reused(void* a) { return A(a)->ReuseCount(); }

}  // extern "C"
