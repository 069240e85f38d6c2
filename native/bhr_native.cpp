// bhr_native: native I/O runtime for the black-hole renderer.
//
// The reference implements its readback + image-save pipeline in native Rust
// (reference: src/lib.rs:613-702, staging-buffer readback + `image` crate
// encode). This is the build's native equivalent: a C++ PNG encoder with
// an asynchronous worker pool, so animation frame dumps (the only host-side
// hot path) overlap with on-device rendering instead of stalling it.
//
// Exposed C ABI (consumed via ctypes from bhr_tpu/io/native.py):
//   int  bhr_write_png(const char* path, const uint8_t* rgba, int w, int h);
//   int  bhr_submit_frame(const char* path, const uint8_t* rgba, int w, int h);
//   int  bhr_drain(void);            // wait for all queued writes, return #errors
//   int  bhr_pending(void);          // frames still queued/in-flight
//   void bhr_strip_rows(const uint8_t* src, uint8_t* dst,
//                       int rows, int src_stride, int dst_stride);

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(static_cast<uint8_t>(v >> 24));
  out.push_back(static_cast<uint8_t>(v >> 16));
  out.push_back(static_cast<uint8_t>(v >> 8));
  out.push_back(static_cast<uint8_t>(v));
}

void put_chunk(std::vector<uint8_t>& out, const char tag[4],
               const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + tag_pos, static_cast<uInt>(4 + len));
  put_be32(out, crc);
}

// Encode RGBA8 as a PNG byte stream (filter type 0 per row, zlib level 4 —
// fast; star fields are mostly near-black and compress well regardless).
bool encode_png(const uint8_t* rgba, int w, int h, std::vector<uint8_t>& out) {
  const size_t row = static_cast<size_t>(w) * 4;
  std::vector<uint8_t> raw((row + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (row + 1)] = 0;  // filter: none
    std::memcpy(&raw[y * (row + 1) + 1], rgba + y * row, row);
  }
  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> comp(bound);
  if (compress2(comp.data(), &bound, raw.data(),
                static_cast<uLong>(raw.size()), 4) != Z_OK) {
    return false;
  }
  comp.resize(bound);

  out.clear();
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = static_cast<uint8_t>(w >> 24); ihdr[1] = static_cast<uint8_t>(w >> 16);
  ihdr[2] = static_cast<uint8_t>(w >> 8);  ihdr[3] = static_cast<uint8_t>(w);
  ihdr[4] = static_cast<uint8_t>(h >> 24); ihdr[5] = static_cast<uint8_t>(h >> 16);
  ihdr[6] = static_cast<uint8_t>(h >> 8);  ihdr[7] = static_cast<uint8_t>(h);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 6;   // color type RGBA
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, sizeof(ihdr));
  put_chunk(out, "IDAT", comp.data(), comp.size());
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool write_file(const std::string& path, const std::vector<uint8_t>& bytes) {
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  size_t n = std::fwrite(bytes.data(), 1, bytes.size(), f);
  std::fclose(f);
  return n == bytes.size();
}

struct Job {
  std::string path;
  std::vector<uint8_t> rgba;
  int w, h;
};

class WriterPool {
 public:
  static WriterPool& instance() {
    // Intentionally leaked: a static instance's destructor would run at
    // process exit while detached workers still wait on the condition
    // variable, which deadlocks/UBs. The OS reclaims everything at exit.
    static WriterPool* pool = new WriterPool();
    return *pool;
  }

  void submit(Job&& job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      start_workers_locked();
      queue_.push_back(std::move(job));
      ++pending_;
    }
    cv_.notify_one();
  }

  int drain() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
    int e = errors_;
    errors_ = 0;
    return e;
  }

  int pending() {
    std::unique_lock<std::mutex> lk(mu_);
    return pending_;
  }

 private:
  void start_workers_locked() {
    if (!workers_.empty()) return;
    unsigned n = std::thread::hardware_concurrency();
    unsigned count = n > 8 ? 4 : (n > 2 ? 2 : 1);
    for (unsigned i = 0; i < count; ++i) {
      workers_.emplace_back([this] { worker_loop(); });
      workers_.back().detach();
    }
  }

  void worker_loop() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return !queue_.empty(); });
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      std::vector<uint8_t> png;
      bool ok = encode_png(job.rgba.data(), job.w, job.h, png) &&
                write_file(job.path, png);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (!ok) ++errors_;
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<Job> queue_;
  std::vector<std::thread> workers_;
  int pending_ = 0;
  int errors_ = 0;
};

}  // namespace

extern "C" {

int bhr_write_png(const char* path, const uint8_t* rgba, int w, int h) {
  std::vector<uint8_t> png;
  if (!encode_png(rgba, w, h, png)) return 1;
  return write_file(path, png) ? 0 : 2;
}

int bhr_submit_frame(const char* path, const uint8_t* rgba, int w, int h) {
  Job job;
  job.path = path;
  job.rgba.assign(rgba, rgba + static_cast<size_t>(w) * h * 4);
  job.w = w;
  job.h = h;
  WriterPool::instance().submit(std::move(job));
  return 0;
}

int bhr_drain(void) { return WriterPool::instance().drain(); }

int bhr_pending(void) { return WriterPool::instance().pending(); }

// Strip per-row padding (the analog of reference lib.rs:675-685, which
// removes COPY_BYTES_PER_ROW_ALIGNMENT padding after texture readback).
void bhr_strip_rows(const uint8_t* src, uint8_t* dst, int rows,
                    int src_stride, int dst_stride) {
  for (int y = 0; y < rows; ++y) {
    std::memcpy(dst + static_cast<size_t>(y) * dst_stride,
                src + static_cast<size_t>(y) * src_stride, dst_stride);
  }
}

}  // extern "C"
