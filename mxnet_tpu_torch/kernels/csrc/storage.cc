// Native host storage manager: a size-bucketed pooled allocator.
//
// The port's copy of the JAX package's src/storage.cc (that file stays
// as it is), built by mxnet_tpu_torch/kernels/_build.py with the host C++
// compiler at first use and bound by mxnet_tpu_torch/storage.py over
// ctypes. Device memory is PyTorch's caching allocator's; this pool
// manages the HOST staging side (batch assembly, temp_space), the
// reference's GPUPooledStorageManager design (pooled_storage_manager.h:
// 48-132) applied to pageable host memory. Buckets are powers of two from
// 4 KB; a freed buffer parks in the pool until the pooled total would
// pass MXNET_HOST_MEM_POOL_MB (default 1024), then goes back to the OS.
//
// C ABI: sto_alloc / sto_free / sto_direct_free / sto_stats /
// sto_release_all.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>

namespace {

struct Pool {
  std::mutex mu;
  // rounded bucket size -> parked buffer (multimap: many per bucket)
  std::multimap<size_t, void*> free_list;
  size_t allocated_bytes = 0;  // currently handed out
  size_t pooled_bytes = 0;     // parked in the free list
  size_t peak_bytes = 0;       // high-water mark of handed-out bytes
  size_t pool_limit;

  Pool() {
    const char* env = std::getenv("MXNET_HOST_MEM_POOL_MB");
    long mb = env ? std::atol(env) : 1024;
    pool_limit = static_cast<size_t>(mb < 0 ? 0 : mb) << 20;
  }

  static size_t RoundSize(size_t nbytes) {
    size_t b = 4096;
    while (b < nbytes) b <<= 1;
    return b;
  }
};

Pool* pool() {
  static Pool* p = new Pool();  // leaked intentionally: outlive atexit
  return p;
}

}  // namespace

extern "C" {

void* sto_alloc(size_t nbytes) {
  Pool* p = pool();
  size_t bucket = Pool::RoundSize(nbytes);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->free_list.find(bucket);
    if (it != p->free_list.end()) {
      void* buf = it->second;
      p->free_list.erase(it);
      p->pooled_bytes -= bucket;
      p->allocated_bytes += bucket;
      if (p->allocated_bytes > p->peak_bytes)
        p->peak_bytes = p->allocated_bytes;
      return buf;
    }
  }
  void* buf = std::aligned_alloc(64, bucket);
  if (buf == nullptr) return nullptr;
  std::lock_guard<std::mutex> lk(p->mu);
  p->allocated_bytes += bucket;
  if (p->allocated_bytes > p->peak_bytes) p->peak_bytes = p->allocated_bytes;
  return buf;
}

// Return a buffer to the pool (or the OS once the pool is over its limit).
void sto_free(void* buf, size_t nbytes) {
  if (buf == nullptr) return;
  Pool* p = pool();
  size_t bucket = Pool::RoundSize(nbytes);
  std::lock_guard<std::mutex> lk(p->mu);
  p->allocated_bytes -= bucket;
  if (p->pooled_bytes + bucket > p->pool_limit) {
    std::free(buf);
    return;
  }
  p->free_list.emplace(bucket, buf);
  p->pooled_bytes += bucket;
}

// Bypass the pool (parity: Storage::DirectFree).
void sto_direct_free(void* buf, size_t nbytes) {
  if (buf == nullptr) return;
  Pool* p = pool();
  std::lock_guard<std::mutex> lk(p->mu);
  p->allocated_bytes -= Pool::RoundSize(nbytes);
  std::free(buf);
}

void sto_stats(size_t* allocated, size_t* pooled, size_t* peak) {
  Pool* p = pool();
  std::lock_guard<std::mutex> lk(p->mu);
  if (allocated) *allocated = p->allocated_bytes;
  if (pooled) *pooled = p->pooled_bytes;
  if (peak) *peak = p->peak_bytes;
}

// Drop every parked buffer (parity: ReleaseAll on shutdown/OOM retry).
void sto_release_all() {
  Pool* p = pool();
  std::lock_guard<std::mutex> lk(p->mu);
  for (auto& kv : p->free_list) std::free(kv.second);
  p->free_list.clear();
  p->pooled_bytes = 0;
}

}  // extern "C"
