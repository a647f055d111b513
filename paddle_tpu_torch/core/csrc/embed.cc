// Host-embedding PS kernels of the port (its own copy of the reference's
// embed.cc, with the same pte_* C ABI): the reference's
// memory_sparse_table.cc / sparse_sgd_rule.cc hot path (batched pull gather,
// SelectedRows-style sparse optimizer scatter, duplicate-id grad merge) as
// native multi-threaded routines over the RAM/memmap row store.
//
// Bit-exactness contract with the numpy path
// (paddle_tpu_torch/incubate/host_embedding.py, FLAGS_host_emb_native=0):
//   * pte_unique matches np.unique(ids, return_inverse=True): sorted
//     unique ids, int64 inverse.
//   * pte_gather is a row memcpy: trivially exact.
//   * pte_merge sums duplicate rows IN INPUT ORDER with float32 adds,
//     matching np.add.at's unbuffered in-order scalar loop. Threading
//     partitions by DESTINATION row (each output row is accumulated by
//     exactly one thread, still in input order), so the result is
//     deterministic and thread-count independent.
//   * pte_sgd is elementwise float32 (row - (float)lr * g), the same IEEE
//     ops numpy performs (built without -ffast-math or an -march that
//     would contract them into a fused multiply-add).
//   * pte_adagrad accumulates each row's sum(g^2) as a SEQUENTIAL double
//     sum (the numpy path mirrors this with a float64 cumsum, which forces
//     numpy into the same sequential order), then applies the float32
//     rowwise rule.
//
// C ABI (pte_*) consumed via ctypes; every call validates ids against
// [0, nrows) and returns -1 instead of faulting on a bad id.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// Persistent worker pool: per-call std::thread spawn costs ~50us/thread,
// which would eat the entire win on millisecond-scale batches. Lazily
// started detached daemon workers park on a condition variable between
// calls; one batch job (fn over thread indices 1..T-1, caller runs 0) at a
// time, enforced by run_mu_ — the Python layer's trainer and PS-worker
// threads DO call kernels concurrently (they serialize on different
// locks), and an unserialized second run() would overwrite fn_/want_
// mid-job.
class Pool {
 public:
  static Pool& get() {
    // intentionally leaked: a static destructor would tear down the mutex/
    // condvar while detached workers still wait on them, hanging exit
    static Pool* p = new Pool();
    return *p;
  }

  // run fn(t) for t in [0, threads); fn(0) on the caller
  void run(int64_t threads, const std::function<void(int64_t)>& fn) {
    if (threads <= 1) {
      fn(0);
      return;
    }
    std::lock_guard<std::mutex> job(run_mu_);
    ensure(threads - 1);
    {
      std::unique_lock<std::mutex> lk(mu_);
      fn_ = &fn;
      want_ = threads - 1;
      done_ = 0;
      ++gen_;
      cv_.notify_all();
    }
    fn(0);
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return done_ == want_; });
    fn_ = nullptr;
  }

 private:
  void ensure(int64_t n) {
    std::unique_lock<std::mutex> lk(mu_);
    while (static_cast<int64_t>(nworkers_) < n) {
      int64_t idx = nworkers_++;
      std::thread([this, idx] { worker(idx); }).detach();
    }
  }

  void worker(int64_t idx) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int64_t)>* fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return gen_ != seen && idx < want_; });
        seen = gen_;
        fn = fn_;
      }
      (*fn)(idx + 1);
      std::unique_lock<std::mutex> lk(mu_);
      if (++done_ == want_) done_cv_.notify_all();
    }
  }

  std::mutex run_mu_;  // serializes whole jobs across calling threads
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int64_t)>* fn_ = nullptr;
  int64_t want_ = 0, done_ = 0, nworkers_ = 0;
  uint64_t gen_ = 0;
};

// run fn(t) for t in [0, threads) on the persistent pool
template <typename F>
void parallel_for_threads(int64_t threads, F fn) {
  Pool::get().run(threads, fn);
}

inline int64_t clamp_threads(int64_t nthreads, int64_t work_items) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int64_t t = std::min(nthreads > 0 ? nthreads : 1, hw);
  // pool wakeup ~5us/thread: still not worth it for tiny batches
  if (work_items < (1 << 13)) return 1;
  return std::max<int64_t>(1, std::min(t, work_items / (1 << 11)));
}

// Hash-sharded unique index over a REUSED generation-stamped work table.
// A fresh hash table per call costs more than the hashing itself (8MB of
// page faults + clears per batch); instead one process-wide open-addressing
// table is kept warm and slots are validated by a generation stamp, so a
// new batch "clears" the table by bumping one counter.
//
// The table is split into power-of-two slot shards. Shard t dedups the ids
// whose hash lands in its range (every occurrence of an id belongs to
// exactly one shard, probes stay inside the shard, so no cross-thread
// writes), then the shard slots are repointed at the ids' SORTED positions.
// Result — sorted uniq + id->pos lookups — is deterministic and
// thread-count independent.
//
// NOT reentrant: callers serialize (the Python side holds the table lock;
// the embedding layer's prefetch worker and trainer thread both route
// through it). A mutex enforces that assumption cheaply.
struct ShardedIndex {
  std::vector<int64_t> keys;
  std::vector<int64_t> vals;
  std::vector<uint32_t> stamp;
  std::vector<std::vector<int64_t>> local;  // per-shard uniq collectors
  std::vector<int64_t> uniq;                // sorted
  std::vector<int64_t> pos_work;            // merge's destination positions
  uint32_t gen = 0;
  uint64_t cap = 0;
  int64_t nshards = 1;
  uint64_t shard_mask = 0;
  std::mutex mu;

  static ShardedIndex& get() {
    static ShardedIndex* s = new ShardedIndex();  // leaked, like the pool
    return *s;
  }

  inline int64_t shard_of(uint64_t h) const {
    return static_cast<int64_t>(
        (static_cast<unsigned __int128>(h) * static_cast<uint64_t>(nshards)) >>
        64);
  }

  inline uint64_t first_slot(uint64_t h, int64_t shard) const {
    return static_cast<uint64_t>(shard) * (shard_mask + 1) + (h & shard_mask);
  }

  void reserve(int64_t n, int64_t threads) {
    int64_t shards = 1;
    while (shards * 2 <= threads) shards *= 2;
    uint64_t want = 16;
    // 4x headroom absorbs zipf-skewed shard occupancy without growth
    while (want < static_cast<uint64_t>(n) * 4) want <<= 1;
    if (want > cap || shards != nshards) {
      cap = std::max(want, cap);
      nshards = shards;
      shard_mask = cap / nshards - 1;
      keys.resize(cap);
      vals.resize(cap);
      stamp.assign(cap, 0);
      gen = 0;
      local.resize(nshards);
    }
    if (++gen == 0) {  // stamp wraparound: one real clear every 2^32 calls
      std::fill(stamp.begin(), stamp.end(), 0);
      gen = 1;
    }
  }

  // dedup + sort + repoint; false on a negative id
  bool build(const int64_t* ids, int64_t n, int64_t nthreads) {
    reserve(n, clamp_threads(nthreads, n));
    std::atomic<bool> bad{false};
    std::atomic<bool> full{false};
    parallel_for_threads(nshards, [&](int64_t t) {
      std::vector<int64_t>& u = local[t];
      u.clear();
      for (int64_t i = 0; i < n; ++i) {
        int64_t id = ids[i];
        if (id < 0) {
          bad.store(true, std::memory_order_relaxed);
          return;
        }
        uint64_t h = splitmix64(static_cast<uint64_t>(id));
        if (shard_of(h) != t) continue;
        uint64_t base = static_cast<uint64_t>(t) * (shard_mask + 1);
        uint64_t s = first_slot(h, t);
        uint64_t probes = 0;
        while (stamp[s] == gen && keys[s] != id) {
          s = base + ((s - base + 1) & shard_mask);
          if (++probes > shard_mask) {  // shard full (extreme hash skew)
            full.store(true, std::memory_order_relaxed);
            return;
          }
        }
        if (stamp[s] != gen) {
          stamp[s] = gen;
          keys[s] = id;
          u.push_back(id);
        }
      }
    });
    if (bad.load()) return false;
    if (full.load()) {
      // retry with double the capacity; terminates (cap grows past 8n,
      // where a full shard is impossible even fully skewed)
      cap *= 2;
      shard_mask = cap / nshards - 1;
      keys.resize(cap);
      vals.resize(cap);
      stamp.assign(cap, 0);
      gen = 1;
      return build(ids, n, nthreads);
    }
    size_t nu = 0;
    for (auto& u : local) nu += u.size();
    uniq.clear();
    uniq.reserve(nu);
    for (auto& u : local) uniq.insert(uniq.end(), u.begin(), u.end());
    std::sort(uniq.begin(), uniq.end());
    // repoint each shard's slots at the sorted positions
    parallel_for_threads(nshards, [&](int64_t t) {
      for (int64_t p = 0; p < static_cast<int64_t>(uniq.size()); ++p) {
        uint64_t h = splitmix64(static_cast<uint64_t>(uniq[p]));
        if (shard_of(h) != t) continue;
        uint64_t base = static_cast<uint64_t>(t) * (shard_mask + 1);
        uint64_t s = first_slot(h, t);
        while (keys[s] != uniq[p]) s = base + ((s - base + 1) & shard_mask);
        vals[s] = p;
      }
    });
    return true;
  }

  inline int64_t pos_of(int64_t id) const {
    uint64_t h = splitmix64(static_cast<uint64_t>(id));
    int64_t t = shard_of(h);
    uint64_t base = static_cast<uint64_t>(t) * (shard_mask + 1);
    uint64_t s = first_slot(h, t);
    while (stamp[s] == gen && keys[s] != id)
      s = base + ((s - base + 1) & shard_mask);
    return stamp[s] == gen ? vals[s] : -1;
  }
};

}  // namespace

extern "C" {

// sorted unique + inverse (np.unique(ids, return_inverse=True) semantics).
// uniq_out needs capacity n, inv_out capacity n. Returns n_uniq, -1 on a
// negative id.
int64_t pte_unique(const int64_t* ids, int64_t n, int64_t* uniq_out,
                   int64_t* inv_out, int64_t nthreads) {
  if (n <= 0) return 0;
  ShardedIndex& idx = ShardedIndex::get();
  std::lock_guard<std::mutex> lk(idx.mu);
  if (!idx.build(ids, n, nthreads)) return -1;
  std::memcpy(uniq_out, idx.uniq.data(), idx.uniq.size() * sizeof(int64_t));
  int64_t threads = clamp_threads(nthreads, n);
  parallel_for_threads(threads, [&](int64_t t) {
    int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
    for (int64_t i = lo; i < hi; ++i) inv_out[i] = idx.pos_of(ids[i]);
  });
  return static_cast<int64_t>(idx.uniq.size());
}

// out[i] = table[ids[i]] (row memcpy, parallel over rows)
int pte_gather_f32(const float* table, int64_t nrows, int64_t dim,
                   const int64_t* ids, int64_t n, float* out,
                   int64_t nthreads) {
  for (int64_t i = 0; i < n; ++i)
    if (ids[i] < 0 || ids[i] >= nrows) return -1;
  int64_t threads = clamp_threads(nthreads, n * dim / 64);
  size_t row_bytes = static_cast<size_t>(dim) * sizeof(float);
  parallel_for_threads(threads, [&](int64_t t) {
    int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
    for (int64_t i = lo; i < hi; ++i)
      std::memcpy(out + i * dim, table + ids[i] * dim, row_bytes);
  });
  return 0;
}

// table[ids[i]] -= (float)lr * grad[i]  (ids must be unique: rows are
// touched in parallel)
int pte_sgd_f32(float* table, int64_t nrows, int64_t dim, const int64_t* ids,
                int64_t n, const float* grad, float lr, int64_t nthreads) {
  for (int64_t i = 0; i < n; ++i)
    if (ids[i] < 0 || ids[i] >= nrows) return -1;
  int64_t threads = clamp_threads(nthreads, n * dim / 16);
  parallel_for_threads(threads, [&](int64_t t) {
    int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
    for (int64_t i = lo; i < hi; ++i) {
      float* row = table + ids[i] * dim;
      const float* g = grad + i * dim;
      for (int64_t j = 0; j < dim; ++j) row[j] = row[j] - lr * g[j];
    }
  });
  return 0;
}

// rowwise Adagrad (reference sparse_sgd_rule.cc SparseAdaGradSGDRule):
//   accum[id] += mean(g^2)   (sequential double sum -> float)
//   table[id] -= (lr / (sqrt(accum[id]) + eps)) * g
int pte_adagrad_f32(float* table, float* accum, int64_t nrows, int64_t dim,
                    const int64_t* ids, int64_t n, const float* grad, float lr,
                    float eps, int64_t nthreads) {
  for (int64_t i = 0; i < n; ++i)
    if (ids[i] < 0 || ids[i] >= nrows) return -1;
  int64_t threads = clamp_threads(nthreads, n * dim / 16);
  parallel_for_threads(threads, [&](int64_t t) {
    int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
    for (int64_t i = lo; i < hi; ++i) {
      const float* g = grad + i * dim;
      double s = 0.0;
      for (int64_t j = 0; j < dim; ++j)
        s += static_cast<double>(g[j]) * static_cast<double>(g[j]);
      float g2 = static_cast<float>(s / static_cast<double>(dim));
      float a = accum[ids[i]] + g2;
      accum[ids[i]] = a;
      float scale = lr / (std::sqrt(a) + eps);
      float* row = table + ids[i] * dim;
      for (int64_t j = 0; j < dim; ++j) row[j] = row[j] - scale * g[j];
    }
  });
  return 0;
}

// Coalesce duplicate-id sparse grads: uniq_out = sorted unique ids,
// merged_out[pos] = sum of grads[i] over ids[i] == uniq_out[pos], summed in
// INPUT ORDER with float32 adds (np.add.at semantics). Parallel over
// destination rows. Returns n_uniq, -1 on a negative id.
int64_t pte_merge_f32(const int64_t* ids, int64_t n, const float* grads,
                      int64_t dim, int64_t* uniq_out, float* merged_out,
                      int64_t nthreads) {
  if (n <= 0) return 0;
  ShardedIndex& idx = ShardedIndex::get();
  std::lock_guard<std::mutex> lk(idx.mu);
  if (!idx.build(ids, n, nthreads)) return -1;
  int64_t nu = static_cast<int64_t>(idx.uniq.size());
  std::memcpy(uniq_out, idx.uniq.data(), nu * sizeof(int64_t));
  // precompute destination positions once (reused buffer, read-only below)
  idx.pos_work.resize(n);
  int64_t* pos = idx.pos_work.data();
  {
    int64_t threads = clamp_threads(nthreads, n);
    parallel_for_threads(threads, [&](int64_t t) {
      int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
      for (int64_t i = lo; i < hi; ++i) pos[i] = idx.pos_of(ids[i]);
    });
  }
  int64_t threads = clamp_threads(nthreads, n * dim / 16);
  parallel_for_threads(threads, [&](int64_t t) {
    // thread t owns destination rows [lo, hi): every input row lands in
    // exactly one partition, zeroed then accumulated in input order
    int64_t lo = nu * t / threads, hi = nu * (t + 1) / threads;
    std::memset(merged_out + lo * dim, 0,
                static_cast<size_t>(hi - lo) * dim * sizeof(float));
    for (int64_t i = 0; i < n; ++i) {
      int64_t p = pos[i];
      if (p < lo || p >= hi) continue;
      float* dst = merged_out + p * dim;
      const float* g = grads + i * dim;
      for (int64_t j = 0; j < dim; ++j) dst[j] += g[j];
    }
  });
  return nu;
}

}  // extern "C"
