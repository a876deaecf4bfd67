// Native data-loader core: multithreaded pread of raw binary shards.
//
// The port's copy of makani_tpu's csrc/makani_loader.cpp (host C++, no
// CUDA): yearly raw float32 shards (T, C, H, W) read with positioned preads
// across a thread pool, optionally O_DIRECT with aligned buffers, filling
// caller-provided numpy buffers (optionally z-score normalized per channel
// in the read workers). data/native_loader.py builds it with the host
// compiler into build/native/ and binds it with ctypes.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ThreadPool {
  explicit ThreadPool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> f) {
    {
      std::unique_lock<std::mutex> lock(mu_);
      tasks_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

struct Loader {
  std::vector<int> fds;
  std::vector<char> fd_odirect;       // per fd: opened with O_DIRECT?
  std::vector<int64_t> n_samples;     // per file
  std::vector<int64_t> data_offsets;  // header offset per file (e.g. npy header)
  int64_t sample_bytes;               // C*H*W*itemsize
  ThreadPool* pool;
  int use_odirect;
};

int64_t total_offset(const Loader* L, int file_idx, int64_t sample_idx) {
  return L->data_offsets[file_idx] + sample_idx * L->sample_bytes;
}

// full pread loop (pread may return short reads)
int pread_full(int fd, char* buf, int64_t count, int64_t offset) {
  int64_t done = 0;
  while (done < count) {
    ssize_t r = pread(fd, buf + done, count - done, offset + done);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (r == 0) return -1;  // unexpected EOF
    done += r;
  }
  return 0;
}

// Grow-only per-thread scratch buffers. The thread-pool hot path would
// otherwise pay a posix_memalign/free (or vector) pair PER READ; reuse keeps
// allocation off the IO path entirely after warmup. Two slots because the
// strided-row O_DIRECT path stages a row band (slot 1) while the nested
// direct pread uses the bounce buffer (slot 0) — both live in one task.
char* tls_scratch(int slot, int64_t n, int64_t align) {
  static thread_local char* bufs[2] = {nullptr, nullptr};
  static thread_local int64_t caps[2] = {0, 0};
  if (n > caps[slot]) {
    free(bufs[slot]);
    void* p = nullptr;
    if (posix_memalign(&p, (size_t)align, (size_t)n) != 0) {
      bufs[slot] = nullptr;
      caps[slot] = 0;
      return nullptr;
    }
    bufs[slot] = static_cast<char*>(p);
    caps[slot] = n;
  }
  return bufs[slot];
}

// O_DIRECT requires block-aligned offset/length/buffer; sample windows are
// none of those, so read the enclosing aligned range into a reused aligned
// bounce buffer and copy out the slice (the reference instead pre-aligns the
// FILES via h5_align + DALI's aligned reads; a bounce buffer serves arbitrary
// layouts at the cost of one memcpy; tools/h5_align.py still minimizes the
// over-read by aligning sample boundaries). Large reads go through the
// buffer in fixed 16 MB chunks: bounded scratch regardless of read size
// (a multi-sample window would otherwise transiently double its memory),
// and each chunk is a single large sequential direct pread.
int pread_full_direct(int fd, char* buf, int64_t count, int64_t offset) {
  const int64_t A = 4096;
  const int64_t CHUNK = 16ll << 20;  // A-aligned by construction
  char* tmp = tls_scratch(0, CHUNK, A);
  if (tmp == nullptr) return -1;
  int64_t done = 0;
  while (done < count) {
    int64_t off = offset + done;
    int64_t astart = off & ~(A - 1);
    int64_t lead = off - astart;
    int64_t want = count - done;
    if (want > CHUNK - lead) want = CHUNK - lead;
    int64_t alen = ((lead + want + A - 1) & ~(A - 1));
    int64_t got = 0;
    while (got < alen) {
      ssize_t r = pread(fd, tmp + got, alen - got, astart + got);
      if (r < 0) {
        if (errno == EINTR) continue;
        return -1;
      }
      if (r == 0) break;  // EOF inside the trailing partial block is fine
      got += r;
    }
    if (got < lead + want) return -1;
    memcpy(buf + done, tmp + lead, (size_t)want);
    done += want;
  }
  return 0;
}

// dispatch by the fd's actual open mode (O_DIRECT opens can fall back)
int loader_pread(const Loader* L, int file_idx, char* buf, int64_t count,
                 int64_t offset) {
  if (L->fd_odirect[file_idx])
    return pread_full_direct(L->fds[file_idx], buf, count, offset);
  return pread_full(L->fds[file_idx], buf, count, offset);
}

}  // namespace

extern "C" {

// paths: array of n_files C strings; n_samples/data_offsets arrays of n_files
void* loader_create(const char** paths, int n_files, const int64_t* n_samples,
                    const int64_t* data_offsets, int64_t sample_bytes,
                    int n_threads, int use_odirect) {
  Loader* L = new Loader();
  L->sample_bytes = sample_bytes;
  L->use_odirect = use_odirect;
  for (int i = 0; i < n_files; ++i) {
    int flags = O_RDONLY;
#ifdef O_DIRECT
    if (use_odirect) flags |= O_DIRECT;
#endif
    int fd = open(paths[i], flags);
    char got_direct = (fd >= 0 && use_odirect) ? 1 : 0;
    if (fd < 0 && use_odirect) {  // filesystem rejects O_DIRECT: fall back
      fd = open(paths[i], O_RDONLY);
      got_direct = 0;
    }
    if (fd < 0) {
      for (int f : L->fds) close(f);
      delete L;
      return nullptr;
    }
    L->fds.push_back(fd);
    L->fd_odirect.push_back(got_direct);
    L->n_samples.push_back(n_samples[i]);
    L->data_offsets.push_back(data_offsets[i]);
  }
  L->pool = new ThreadPool(n_threads > 0 ? n_threads : 4);
  return L;
}

void loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  if (!L) return;
  delete L->pool;
  for (int fd : L->fds) close(fd);
  delete L;
}

// Read a batch of samples in parallel: out must hold batch*sample_bytes.
// file_idx/sample_idx arrays of length batch. Returns 0 on success.
int loader_read_batch(void* handle, const int* file_idx, const int64_t* sample_idx,
                      int batch, char* out) {
  Loader* L = static_cast<Loader*>(handle);
  std::atomic<int> remaining(batch);
  std::atomic<int> error(0);
  std::mutex mu;
  std::condition_variable cv;

  for (int b = 0; b < batch; ++b) {
    L->pool->submit([L, b, file_idx, sample_idx, out, &remaining, &error, &mu, &cv] {
      int fi = file_idx[b];
      int64_t off = total_offset(L, fi, sample_idx[b]);
      if (loader_pread(L, fi, out + (int64_t)b * L->sample_bytes,
                       L->sample_bytes, off) != 0) {
        error.store(1);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::unique_lock<std::mutex> lock(mu);
        cv.notify_one();
      }
    });
  }

  std::unique_lock<std::mutex> lock(mu);
  cv.wait(lock, [&remaining] { return remaining.load() == 0; });
  return error.load();
}

// Read a contiguous window of samples from one file (for history/future windows).
int loader_read_window(void* handle, int file_idx, int64_t sample_start,
                       int64_t n_window, char* out) {
  Loader* L = static_cast<Loader*>(handle);
  int64_t off = total_offset(L, file_idx, sample_start);
  return loader_pread(L, file_idx, out, n_window * L->sample_bytes, off);
}

// Read a channel/spatial subwindow of a window of samples: for each of
// n_window consecutive samples starting at sample_start, read channels
// chans[0..n_chan) rows [x0, x0+nx) cols [y0, y0+ny) of the (C, H, W)
// float32 sample into out (n_window, n_chan, nx, ny). This is the
// io-sharded read path (each spatial rank reads only its lat/lon patch;
// ref capability: dali_es_helper_2d.py:276-285,494-501) and the
// channel-subset path (in_channels/out_channels selections read only the
// requested channels instead of slicing in numpy afterwards).
//
// bias/inv_scale (nullable, length n_chan, indexed by OUTPUT channel
// position) fuse the z-score normalization into the read workers:
// out = (raw - bias[c]) * inv_scale[c]. This is the DALI-analog fused
// normalize stage (ref: data_loader_dali_2d.py normalization ops) — doing
// it here keeps the Python side zero-copy and runs the arithmetic in the
// pool threads while other reads are in flight.
//
// Parallelized per (sample, channel) across the thread pool; full-width
// windows collapse to one contiguous pread per channel.
int loader_read_subwindow_norm(void* handle, int file_idx, int64_t sample_start,
                               int64_t n_window, const int* chans, int n_chan,
                               int64_t H, int64_t W, int64_t x0, int64_t nx,
                               int64_t y0, int64_t ny, const float* bias,
                               const float* inv_scale, char* out) {
  Loader* L = static_cast<Loader*>(handle);
  const int64_t item = 4;  // float32
  const int64_t row_bytes = W * item;
  const int64_t chan_bytes = H * row_bytes;
  const int64_t out_chan_bytes = nx * ny * item;

  int total = static_cast<int>(n_window) * n_chan;
  std::atomic<int> remaining(total);
  std::atomic<int> error(0);
  std::mutex mu;
  std::condition_variable cv;

  for (int64_t s = 0; s < n_window; ++s) {
    for (int c = 0; c < n_chan; ++c) {
      L->pool->submit([=, &remaining, &error, &mu, &cv] {
        int64_t base = total_offset(L, file_idx, sample_start + s) +
                       (int64_t)chans[c] * chan_bytes + x0 * row_bytes +
                       y0 * item;
        char* dst = out + (s * n_chan + c) * out_chan_bytes;
        int rc = 0;
        if (ny == W && y0 == 0) {
          rc = loader_pread(L, file_idx, dst, nx * row_bytes, base);
        } else if (L->fd_odirect[file_idx]) {
          // strided rows under O_DIRECT: one aligned read covering the
          // whole row band beats per-row bounce buffers; staged in the
          // per-thread band scratch (slot 1 — slot 0 is the direct-pread
          // bounce buffer, live at the same time)
          int64_t band = nx * row_bytes;
          char* tmp = tls_scratch(1, band, 64);
          rc = tmp == nullptr ? -1
                              : loader_pread(L, file_idx, tmp, band, base - y0 * item);
          if (rc == 0) {
            for (int64_t r = 0; r < nx; ++r)
              memcpy(dst + r * ny * item, tmp + r * row_bytes + y0 * item,
                     ny * item);
          }
        } else {
          for (int64_t r = 0; r < nx && rc == 0; ++r) {
            rc = pread_full(L->fds[file_idx], dst + r * ny * item, ny * item,
                            base + r * row_bytes);
          }
        }
        if (rc == 0 && bias != nullptr) {
          float* v = reinterpret_cast<float*>(dst);
          const float b = bias[c];
          const float si = inv_scale[c];
          const int64_t n = nx * ny;
          for (int64_t i = 0; i < n; ++i) v[i] = (v[i] - b) * si;
        }
        if (rc != 0) error.store(1);
        if (remaining.fetch_sub(1) == 1) {
          std::unique_lock<std::mutex> lock(mu);
          cv.notify_one();
        }
      });
    }
  }

  std::unique_lock<std::mutex> lock(mu);
  cv.wait(lock, [&remaining] { return remaining.load() == 0; });
  return error.load();
}

int loader_read_subwindow(void* handle, int file_idx, int64_t sample_start,
                          int64_t n_window, const int* chans, int n_chan,
                          int64_t H, int64_t W, int64_t x0, int64_t nx,
                          int64_t y0, int64_t ny, char* out) {
  return loader_read_subwindow_norm(handle, file_idx, sample_start, n_window,
                                    chans, n_chan, H, W, x0, nx, y0, ny,
                                    nullptr, nullptr, out);
}

// 1 if every file is actually being read with O_DIRECT (open with the flag
// succeeded), else 0 — lets callers/tests detect silent buffered fallback.
int loader_odirect_active(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  if (L->fds.empty()) return 0;
  for (char d : L->fd_odirect)
    if (!d) return 0;
  return 1;
}

}  // extern "C"
