// Native IO runtime for the noize_tpu_torch buffer store; the port's own
// copy of noize_tpu/native/serde_native.cpp.
//
// The reference's serialization layer (PipelineSerialization.cs:128-236)
// does raw unsafe byte dumps of NativeArrays on the main thread.  Here the
// host-side runtime is C++: a worker thread pool drains an async write
// queue (checkpoints overlap with device compute), reads go through
// mmap for zero-copy restores, and every file carries a FNV-1a checksum
// validated on load.  Exposed via a C ABI consumed with ctypes
// (noize_tpu_torch/native/__init__.py).
//
// Build: g++ -O2 -fPIC -std=c++17 -pthread -shared, at first use, into
// build/noize_tpu_torch/ (noize_tpu_torch/native/__init__.py).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <locale.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4e5a544655ull;  // "NZTFU"
constexpr uint32_t kVersion = 1;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t reserved;
  uint64_t nbytes;
  uint64_t checksum;
};

uint64_t fnv1a(const uint8_t* data, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= 1099511628211ull;
  }
  return h;
}

int write_all(int fd, const uint8_t* p, size_t n) {
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return -errno;  // callers report the real cause (ENOSPC vs EPERM)
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// async write pool
// ---------------------------------------------------------------------------

struct WriteJob {
  std::string path;
  std::vector<uint8_t> data;  // owned copy so the caller's buffer can go away
  uint64_t ticket;
};

class WritePool {
 public:
  explicit WritePool(int workers) : stop_(false), next_ticket_(1), completed_(0) {
    for (int i = 0; i < workers; ++i) {
      threads_.emplace_back([this] { Loop(); });
    }
  }

  ~WritePool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  uint64_t Submit(const char* path, const uint8_t* data, size_t n) {
    WriteJob job;
    job.path = path;
    job.data.assign(data, data + n);
    std::lock_guard<std::mutex> g(mu_);
    job.ticket = next_ticket_++;
    uint64_t t = job.ticket;
    queue_.push_back(std::move(job));
    cv_.notify_one();
    return t;
  }

  // Block until ticket `ticket` ITSELF has retired.  With multiple
  // workers jobs can finish out of order, so the wait condition is a
  // contiguous-retirement watermark (lowest unfinished ticket − 1), not a
  // raw completion count: watermark_ >= t guarantees every ticket <= t is
  // done, including t.  Ticket 0 waits for everything submitted so far.
  int Wait(uint64_t ticket) {
    std::unique_lock<std::mutex> g(mu_);
    if (ticket == 0) ticket = next_ticket_ - 1;
    done_cv_.wait(g, [&] { return watermark_ >= ticket; });
    int err = first_error_;
    return err;
  }

  int Pending() {
    std::lock_guard<std::mutex> g(mu_);
    return static_cast<int>(next_ticket_ - 1 - completed_);
  }

 private:
  void Loop() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [&] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      int rc = DoWrite(job);
      {
        std::lock_guard<std::mutex> g(mu_);
        completed_ += 1;
        retired_.insert(job.ticket);
        // advance the contiguous watermark: out-of-order retirements park
        // in retired_ until every lower ticket has also finished
        while (!retired_.empty() && *retired_.begin() == watermark_ + 1) {
          retired_.erase(retired_.begin());
          ++watermark_;
        }
        if (rc != 0 && first_error_ == 0) first_error_ = rc;
      }
      done_cv_.notify_all();
    }
  }

  static int DoWrite(const WriteJob& job) {
    std::string tmp = job.path + ".tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return -errno;
    Header h{kMagic, kVersion, 0, job.data.size(),
             fnv1a(job.data.data(), job.data.size())};
    int rc = write_all(fd, reinterpret_cast<const uint8_t*>(&h), sizeof(h));
    if (rc == 0) rc = write_all(fd, job.data.data(), job.data.size());
    if (rc == 0 && ::fsync(fd) != 0) rc = -errno;
    ::close(fd);
    if (rc == 0 && ::rename(tmp.c_str(), job.path.c_str()) != 0) rc = -errno;
    if (rc != 0) ::unlink(tmp.c_str());
    return rc;
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::deque<WriteJob> queue_;
  std::vector<std::thread> threads_;
  bool stop_;
  uint64_t next_ticket_;
  uint64_t completed_;
  uint64_t watermark_ = 0;       // every ticket <= watermark_ has retired
  std::set<uint64_t> retired_;   // retired tickets above the watermark
  int first_error_ = 0;
};

WritePool* pool() {
  static WritePool p(2);
  return &p;
}

}  // namespace

extern "C" {

// Synchronous checked write (header + checksum). Returns 0 on success.
int nz_write(const char* path, const void* data, uint64_t nbytes) {
  WriteJob job;
  job.path = path;
  (void)job;
  int fd = ::open((std::string(path) + ".tmp").c_str(),
                  O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  Header h{kMagic, kVersion, 0, nbytes,
           fnv1a(static_cast<const uint8_t*>(data), nbytes)};
  int rc = write_all(fd, reinterpret_cast<const uint8_t*>(&h), sizeof(h));
  if (rc == 0)
    rc = write_all(fd, static_cast<const uint8_t*>(data), nbytes);
  if (rc == 0 && ::fsync(fd) != 0) rc = -errno;
  ::close(fd);
  if (rc == 0 &&
      ::rename((std::string(path) + ".tmp").c_str(), path) != 0)
    rc = -errno;
  if (rc != 0) ::unlink((std::string(path) + ".tmp").c_str());
  return rc;
}

// Async write: copies the buffer, queues it, returns a ticket (> 0).
uint64_t nz_write_async(const char* path, const void* data, uint64_t nbytes) {
  return pool()->Submit(path, static_cast<const uint8_t*>(data), nbytes);
}

// Wait for a ticket (0 = all submitted so far). Returns 0 on success.
int nz_wait(uint64_t ticket) { return pool()->Wait(ticket); }

int nz_pending() { return pool()->Pending(); }

// Size query: payload bytes, or < 0 on error/format mismatch.
int64_t nz_payload_size(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  Header h;
  ssize_t r = ::read(fd, &h, sizeof(h));
  ::close(fd);
  if (r != sizeof(h)) return -1;
  if (h.magic != kMagic) return -2;  // legacy raw file
  return static_cast<int64_t>(h.nbytes);
}

// mmap read into caller buffer with checksum validation.
// Returns 0 ok, -2 bad magic, -3 size mismatch, -4 checksum mismatch.
int nz_read(const char* path, void* out, uint64_t nbytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return -errno;
  }
  size_t total = static_cast<size_t>(st.st_size);
  if (total < sizeof(Header)) {
    ::close(fd);
    return -2;
  }
  void* m = ::mmap(nullptr, total, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) return -errno;
  const Header* h = static_cast<const Header*>(m);
  int rc = 0;
  const uint8_t* payload = static_cast<const uint8_t*>(m) + sizeof(Header);
  if (h->magic != kMagic) {
    rc = -2;
  } else if (h->nbytes != nbytes || total - sizeof(Header) < nbytes) {
    rc = -3;
  } else if (fnv1a(payload, nbytes) != h->checksum) {
    rc = -4;
  } else {
    std::memcpy(out, payload, nbytes);
  }
  ::munmap(m, total);
  return rc;
}

uint64_t nz_checksum(const void* data, uint64_t nbytes) {
  return fnv1a(static_cast<const uint8_t*>(data), nbytes);
}

// ---------------------------------------------------------------------------
// Wavefront OBJ writer
// ---------------------------------------------------------------------------
// The Python OBJ path (numpy savetxt) formats one %-string per line and
// costs ~3.4 s for a 512² tile (263K verts / 524K tris) — ~54 s at the
// 2048² production size.  This emits the identical text (same %.7g
// formatting, same v/vt/vn + "f a/a/a b/b/b c/c/c" shape as
// app/mesh_export.py) through a buffered single pass.  Atomic like the
// other writers: tmp file + rename.  Returns bytes written, or -errno.
int64_t nz_obj_write(const char* path, const char* name, const float* pos,
                     const float* nrm, const float* uv, uint64_t n_verts,
                     const uint32_t* tris, uint64_t n_tris) {
  std::string tmp = std::string(path) + ".tmp";
  int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;

  // %g is LC_NUMERIC-sensitive (a de_DE host would emit "1,5" — invalid
  // OBJ, and not byte-identical to the locale-independent numpy path);
  // pin the C locale for this thread while formatting
  locale_t c_loc = ::newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
  locale_t old_loc = c_loc ? ::uselocale(c_loc) : (locale_t)0;

  constexpr size_t kBuf = 1 << 20;
  std::vector<char> buf(kBuf + 512);  // slack for one max-size line
  size_t used = 0;
  int64_t total = 0;
  int rc = 0;

  auto flush = [&](size_t threshold) {
    if (used > threshold && rc == 0) {
      rc = write_all(fd, reinterpret_cast<const uint8_t*>(buf.data()), used);
      total += static_cast<int64_t>(used);
      used = 0;
    }
  };
  // unsigned ascii — faces are pure integers, snprintf is overkill there
  auto put_u64 = [&](uint64_t v) {
    char digits[20];
    int n = 0;
    do {
      digits[n++] = static_cast<char>('0' + v % 10);
      v /= 10;
    } while (v);
    while (n) buf[used++] = digits[--n];
  };

  // header: the name is caller-controlled and unbounded — write it
  // directly rather than through the fixed-size line buffer
  {
    std::string header = std::string("o ") + name + "\n";
    rc = write_all(fd, reinterpret_cast<const uint8_t*>(header.data()),
                   header.size());
    total += static_cast<int64_t>(header.size());
  }
  for (uint64_t i = 0; i < n_verts && rc == 0; ++i) {
    used += static_cast<size_t>(
        snprintf(buf.data() + used, 256, "v %.7g %.7g %.7g\n",
                 static_cast<double>(pos[3 * i]),
                 static_cast<double>(pos[3 * i + 1]),
                 static_cast<double>(pos[3 * i + 2])));
    flush(kBuf);
  }
  for (uint64_t i = 0; i < n_verts && rc == 0; ++i) {
    used += static_cast<size_t>(
        snprintf(buf.data() + used, 256, "vt %.7g %.7g\n",
                 static_cast<double>(uv[2 * i]),
                 static_cast<double>(uv[2 * i + 1])));
    flush(kBuf);
  }
  for (uint64_t i = 0; i < n_verts && rc == 0; ++i) {
    used += static_cast<size_t>(
        snprintf(buf.data() + used, 256, "vn %.7g %.7g %.7g\n",
                 static_cast<double>(nrm[3 * i]),
                 static_cast<double>(nrm[3 * i + 1]),
                 static_cast<double>(nrm[3 * i + 2])));
    flush(kBuf);
  }
  for (uint64_t i = 0; i < n_tris && rc == 0; ++i) {
    buf[used++] = 'f';
    for (int c = 0; c < 3; ++c) {
      uint64_t id = static_cast<uint64_t>(tris[3 * i + c]) + 1;  // 1-based
      buf[used++] = ' ';
      put_u64(id);
      buf[used++] = '/';
      put_u64(id);
      buf[used++] = '/';
      put_u64(id);
    }
    buf[used++] = '\n';
    flush(kBuf);
  }
  flush(0);
  if (rc == 0 && ::fsync(fd) != 0) rc = -errno;
  ::close(fd);
  if (old_loc) ::uselocale(old_loc);
  if (c_loc) ::freelocale(c_loc);
  if (rc == 0 && ::rename(tmp.c_str(), path) != 0) rc = -errno;
  if (rc != 0) ::unlink(tmp.c_str());  // no partial .tmp litter on failure
  return rc == 0 ? total : rc;
}

}  // extern "C"
