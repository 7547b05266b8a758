// Native RecordIO reader + threaded batch loader (host code, no CUDA).
//
// The port's own copy of the JAX package's src/recordio.cc, unchanged in
// its wire format and its extern "C" API: the reference's C++ IO pipeline
// (src/io/iter_image_recordio_2.cc: multithreaded batch assembly feeding a
// prefetch queue, over dmlc-core RecordIO). The binary format matches
// recordio.py (and dmlc): per record a LE uint32 magic 0xced7230a, a
// uint32 whose low 29 bits are the payload length, payload, 4-byte
// padding. Payload = IRHeader{uint32 flag; float label; uint64 id,id2}
// + raw uint8 CHW image tensor.
//
// Built with the host C++ compiler by kernels/_build.py at first use and
// bound through ctypes (mxnet_tpu_torch/_native.py); io.ImageRecordIter's
// Python path implements the same semantics.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};

struct Record {
  float label;
  std::vector<uint8_t> payload;  // image bytes (after header)
};

struct Batch {
  std::vector<float> data;    // batch*C*H*W normalised floats
  std::vector<float> label;   // batch
};

class RecordFile {
 public:
  bool Load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    for (;;) {
      uint32_t magic = 0, lrec = 0;
      if (std::fread(&magic, 4, 1, f) != 1) break;
      if (magic != kMagic) { std::fclose(f); return false; }
      if (std::fread(&lrec, 4, 1, f) != 1) { std::fclose(f); return false; }
      uint32_t len = lrec & kLenMask;
      std::vector<uint8_t> buf(len);
      if (len && std::fread(buf.data(), 1, len, f) != len) {
        std::fclose(f);
        return false;
      }
      uint32_t pad = (4 - len % 4) % 4;
      if (pad) std::fseek(f, pad, SEEK_CUR);
      if (len < sizeof(IRHeader)) continue;
      IRHeader hdr;
      std::memcpy(&hdr, buf.data(), sizeof(IRHeader));
      Record rec;
      rec.label = hdr.label;
      rec.payload.assign(buf.begin() + sizeof(IRHeader), buf.end());
      records_.push_back(std::move(rec));
    }
    std::fclose(f);
    return true;
  }

  const std::vector<Record>& records() const { return records_; }

 private:
  std::vector<Record> records_;
};

// Threaded batch assembler: worker threads build batches ahead of the
// consumer (the reference's PrefetcherIter double-buffering).
class BatchLoader {
 public:
  BatchLoader(RecordFile* file, int batch, int c, int h, int w, int threads,
              bool shuffle, uint64_t seed, float scale, const float* mean,
              const float* std)
      : file_(file), batch_(batch), c_(c), h_(h), w_(w),
        shuffle_(shuffle), rng_(seed), scale_(scale), stop_(false),
        epoch_pos_(0) {
    std::memcpy(mean_, mean, sizeof(float) * 3);
    std::memcpy(std_, std, sizeof(float) * 3);
    order_.resize(file_->records().size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    Reshuffle();
    n_batches_ = order_.size() / batch_;
    int nthreads = threads > 0 ? threads : 2;
    for (int i = 0; i < nthreads; ++i)
      workers_.emplace_back([this] { WorkLoop(); });
  }

  ~BatchLoader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_out_.notify_all();
    for (auto& t : workers_) t.join();
  }

  size_t num_batches() const { return n_batches_; }

  // Blocks until the next in-order batch is ready; returns false at epoch
  // end. Caller provides float[batch*c*h*w] and float[batch].
  bool Next(float* data_out, float* label_out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (next_out_ >= n_batches_) return false;
    size_t want = next_out_;
    cv_out_.wait(lk, [&] { return stop_ || done_.count(want); });
    if (stop_ && !done_.count(want)) return false;
    Batch b = std::move(done_[want]);
    done_.erase(want);
    ++next_out_;
    cv_work_.notify_all();
    lk.unlock();
    std::memcpy(data_out, b.data.data(), b.data.size() * sizeof(float));
    std::memcpy(label_out, b.label.data(), b.label.size() * sizeof(float));
    return true;
  }

  void Reset() {
    std::unique_lock<std::mutex> lk(mu_);
    next_build_ = 0;
    next_out_ = 0;
    done_.clear();
    Reshuffle();
    cv_work_.notify_all();
  }

 private:
  void Reshuffle() {
    if (shuffle_) {
      std::shuffle(order_.begin(), order_.end(), rng_);
    }
  }

  void WorkLoop() {
    const size_t elems = static_cast<size_t>(c_) * h_ * w_;
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] {
          return stop_ ||
                 (next_build_ < n_batches_ &&
                  done_.size() + building_ < kMaxPrefetch);
        });
        if (stop_) return;
        if (next_build_ >= n_batches_) {
          cv_work_.wait(lk, [&] { return stop_ || next_build_ < n_batches_; });
          if (stop_) return;
        }
        idx = next_build_++;
        ++building_;
      }
      Batch b;
      b.data.resize(static_cast<size_t>(batch_) * elems);
      b.label.resize(batch_);
      const auto& recs = file_->records();
      for (int i = 0; i < batch_; ++i) {
        size_t ri = order_[idx * batch_ + i];
        const Record& r = recs[ri];
        b.label[i] = r.label;
        float* dst = b.data.data() + static_cast<size_t>(i) * elems;
        size_t n = r.payload.size() < elems ? r.payload.size() : elems;
        for (size_t ch = 0; ch < static_cast<size_t>(c_); ++ch) {
          const float m = mean_[ch % 3];
          const float s = std_[ch % 3];
          const size_t plane = static_cast<size_t>(h_) * w_;
          for (size_t px = 0; px < plane; ++px) {
            size_t off = ch * plane + px;
            float v = off < n ? static_cast<float>(r.payload[off]) : 0.f;
            dst[off] = (v * scale_ - m) / s;
          }
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(b);
        --building_;
      }
      cv_out_.notify_all();
      cv_work_.notify_all();
    }
  }

  static constexpr size_t kMaxPrefetch = 8;

  RecordFile* file_;
  int batch_, c_, h_, w_;
  bool shuffle_;
  std::mt19937_64 rng_;
  float scale_;
  float mean_[3], std_[3];
  std::vector<size_t> order_;
  size_t n_batches_ = 0;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_out_;
  std::map<size_t, Batch> done_;
  size_t next_build_ = 0;
  size_t next_out_ = 0;
  size_t building_ = 0;
  bool stop_;
  size_t epoch_pos_;
};

}  // namespace

extern "C" {

void* rio_open(const char* path) {
  auto* f = new RecordFile();
  if (!f->Load(path)) {
    delete f;
    return nullptr;
  }
  return f;
}

long rio_num_records(void* handle) {
  return static_cast<long>(static_cast<RecordFile*>(handle)->records().size());
}

long rio_record_size(void* handle, long i) {
  return static_cast<long>(
      static_cast<RecordFile*>(handle)->records()[i].payload.size());
}

float rio_record_label(void* handle, long i) {
  return static_cast<RecordFile*>(handle)->records()[i].label;
}

void rio_record_copy(void* handle, long i, uint8_t* out) {
  const auto& p = static_cast<RecordFile*>(handle)->records()[i].payload;
  std::memcpy(out, p.data(), p.size());
}

void rio_close(void* handle) { delete static_cast<RecordFile*>(handle); }

void* loader_create(void* file_handle, int batch, int c, int h, int w,
                    int threads, int shuffle, uint64_t seed, float scale,
                    const float* mean, const float* stdv) {
  return new BatchLoader(static_cast<RecordFile*>(file_handle), batch, c, h,
                         w, threads, shuffle != 0, seed, scale, mean, stdv);
}

long loader_num_batches(void* handle) {
  return static_cast<long>(static_cast<BatchLoader*>(handle)->num_batches());
}

int loader_next(void* handle, float* data_out, float* label_out) {
  return static_cast<BatchLoader*>(handle)->Next(data_out, label_out) ? 1 : 0;
}

void loader_reset(void* handle) { static_cast<BatchLoader*>(handle)->Reset(); }

void loader_destroy(void* handle) { delete static_cast<BatchLoader*>(handle); }

}  // extern "C"
