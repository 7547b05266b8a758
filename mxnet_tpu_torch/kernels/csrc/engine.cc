// Native dependency engine for host-side asynchronous work.
//
// The port's copy of the JAX package's src/engine.cc (that file stays as
// it is), built by mxnet_tpu_torch/kernels/_build.py with the host C++
// compiler at first use and bound by mxnet_tpu_torch/engine.py over
// ctypes. It schedules HOST work (record prefetch, augmentation,
// checkpoint writes, the next batch's data): PyTorch orders device work
// on its CUDA streams. Semantics follow the reference's threaded engine
// (src/engine/threaded_engine.h:66-217, ThreadedVar/OprBlock): every op
// declares read (const) and write (mutable) variable sets; per-variable
// queues grant concurrent readers and exclusive writers in push order;
// WaitForVar blocks until every earlier writer of the variable has
// completed; WaitForAll drains. A naive engine runs each op in the
// caller (the reference's NaiveEngine).
//
// C ABI: eng_create / eng_destroy / eng_new_var / eng_delete_var /
// eng_push / eng_wait_for_var / eng_wait_all.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Callback = void (*)(void*);

struct Opr;

// Per-variable access queue: readers run concurrently, writers are
// exclusive and ordered (reference ThreadedVar / VersionedVarBlock).
struct Var {
  struct Pending {
    Opr* op;
    bool write;
  };
  std::deque<Pending> queue;
  int active_readers = 0;
  bool active_writer = false;
};

struct Opr {
  Callback fn;
  void* arg;
  std::vector<int64_t> const_vars;
  std::vector<int64_t> mutable_vars;
  std::atomic<int> wait{0};
  int priority = 0;
};

class Engine {
 public:
  explicit Engine(int num_workers, bool naive)
      : naive_(naive) {
    if (naive_) return;
    if (num_workers < 1) num_workers = 1;
    for (int i = 0; i < num_workers; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Engine() {
    WaitAll();
    {
      std::unique_lock<std::mutex> lk(mu_);
      shutdown_ = true;
      cv_.notify_all();
    }
    for (auto& t : workers_) t.join();
  }

  int64_t NewVar() {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t id = next_var_++;
    vars_.emplace(id, Var{});
    return id;
  }

  void DeleteVar(int64_t id) {
    // Deletion is itself ordered: drop the var once all pending ops on it
    // completed (reference Engine::DeleteVariable pushes a delete op).
    std::unique_lock<std::mutex> lk(mu_);
    auto it = vars_.find(id);
    if (it != vars_.end() && it->second.queue.empty() &&
        it->second.active_readers == 0 && !it->second.active_writer) {
      vars_.erase(it);
    } else if (it != vars_.end()) {
      doomed_vars_.push_back(id);
    }
  }

  void Push(Callback fn, void* arg, const int64_t* cvars, int n_c,
            const int64_t* mvars, int n_m, int priority) {
    if (naive_) {
      fn(arg);  // reference NaiveEngine: run synchronously in caller
      return;
    }
    Opr* op = new Opr;
    op->fn = fn;
    op->arg = arg;
    op->const_vars.assign(cvars, cvars + n_c);
    op->mutable_vars.assign(mvars, mvars + n_m);
    op->priority = priority;
    // +1 sentinel so the op cannot fire while we are still enqueueing it
    op->wait.store(1 + n_c + n_m, std::memory_order_relaxed);
    {
      std::unique_lock<std::mutex> lk(mu_);
      ++outstanding_;
      for (int64_t v : op->const_vars) EnqueueAccess(v, op, /*write=*/false);
      for (int64_t v : op->mutable_vars) EnqueueAccess(v, op, /*write=*/true);
    }
    Satisfy(op, 1);  // drop sentinel
  }

  void WaitForVar(int64_t var) {
    // Equivalent to pushing a read op and blocking on it
    // (reference ThreadedEngine::WaitForVar, threaded_engine.cc:356).
    std::mutex m;
    std::condition_variable done_cv;
    bool done = false;
    struct Ctx { std::mutex* m; std::condition_variable* cv; bool* done; };
    Ctx ctx{&m, &done_cv, &done};
    auto cb = [](void* p) {
      Ctx* c = static_cast<Ctx*>(p);
      std::unique_lock<std::mutex> lk(*c->m);
      *c->done = true;
      c->cv->notify_all();
    };
    Push(cb, &ctx, &var, 1, nullptr, 0, /*priority=*/1);
    std::unique_lock<std::mutex> lk(m);
    done_cv.wait(lk, [&] { return done; });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(mu_);
    all_done_cv_.wait(lk, [this] { return outstanding_ == 0; });
  }

 private:
  // mu_ held.
  void EnqueueAccess(int64_t vid, Opr* op, bool write) {
    Var& v = vars_[vid];
    v.queue.push_back({op, write});
    GrantLocked(vid);
  }

  // mu_ held. Advance the var's queue, granting permitted accessors.
  // Collect ops whose wait hits zero into ready_ for dispatch.
  void GrantLocked(int64_t vid) {
    Var& v = vars_[vid];
    while (!v.queue.empty()) {
      Var::Pending front = v.queue.front();
      if (front.write) {
        if (v.active_readers == 0 && !v.active_writer) {
          v.active_writer = true;
          v.queue.pop_front();
          SatisfyLocked(front.op, 1);
        }
        break;  // writer is exclusive; later accessors wait
      }
      if (v.active_writer) break;
      ++v.active_readers;
      v.queue.pop_front();
      SatisfyLocked(front.op, 1);
      // loop: grant consecutive readers
    }
  }

  // mu_ held: move op to ready queue when its wait count drains.
  void SatisfyLocked(Opr* op, int n) {
    if (op->wait.fetch_sub(n, std::memory_order_acq_rel) == n) {
      ready_.push_back(op);
      cv_.notify_one();
    }
  }

  void Satisfy(Opr* op, int n) {
    std::unique_lock<std::mutex> lk(mu_);
    SatisfyLocked(op, n);
  }

  void WorkerLoop() {
    for (;;) {
      Opr* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return shutdown_ || !ready_.empty(); });
        if (shutdown_ && ready_.empty()) return;
        // priority: scan a small window for a high-priority op
        // (reference keeps a separate priority queue for CPU ops)
        size_t pick = 0;
        for (size_t i = 0; i < ready_.size() && i < 8; ++i) {
          if (ready_[i]->priority > ready_[pick]->priority) pick = i;
        }
        op = ready_[pick];
        ready_.erase(ready_.begin() + pick);
      }
      op->fn(op->arg);
      Complete(op);
    }
  }

  void Complete(Opr* op) {
    std::unique_lock<std::mutex> lk(mu_);
    for (int64_t vid : op->const_vars) {
      auto it = vars_.find(vid);
      if (it == vars_.end()) continue;
      --it->second.active_readers;
      GrantLocked(vid);
    }
    for (int64_t vid : op->mutable_vars) {
      auto it = vars_.find(vid);
      if (it == vars_.end()) continue;
      it->second.active_writer = false;
      GrantLocked(vid);
    }
    ReapDoomedLocked();
    delete op;
    if (--outstanding_ == 0) all_done_cv_.notify_all();
  }

  // mu_ held: erase vars whose deletion was deferred until quiescent.
  void ReapDoomedLocked() {
    for (auto it = doomed_vars_.begin(); it != doomed_vars_.end();) {
      auto vit = vars_.find(*it);
      if (vit == vars_.end() || (vit->second.queue.empty() &&
                                 vit->second.active_readers == 0 &&
                                 !vit->second.active_writer)) {
        if (vit != vars_.end()) vars_.erase(vit);
        it = doomed_vars_.erase(it);
      } else {
        ++it;
      }
    }
  }

  bool naive_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable all_done_cv_;
  std::vector<std::thread> workers_;
  std::unordered_map<int64_t, Var> vars_;
  std::vector<int64_t> doomed_vars_;
  std::vector<Opr*> ready_;
  int64_t next_var_ = 1;
  int64_t outstanding_ = 0;
  bool shutdown_ = false;
};

}  // namespace

extern "C" {

void* eng_create(int num_workers, int naive) {
  return new Engine(num_workers, naive != 0);
}

void eng_destroy(void* h) { delete static_cast<Engine*>(h); }

int64_t eng_new_var(void* h) { return static_cast<Engine*>(h)->NewVar(); }

void eng_delete_var(void* h, int64_t v) {
  static_cast<Engine*>(h)->DeleteVar(v);
}

void eng_push(void* h, void (*fn)(void*), void* arg, const int64_t* cvars,
              int n_c, const int64_t* mvars, int n_m, int priority) {
  static_cast<Engine*>(h)->Push(fn, arg, cvars, n_c, mvars, n_m, priority);
}

void eng_wait_for_var(void* h, int64_t v) {
  static_cast<Engine*>(h)->WaitForVar(v);
}

void eng_wait_all(void* h) { static_cast<Engine*>(h)->WaitAll(); }

}  // extern "C"
