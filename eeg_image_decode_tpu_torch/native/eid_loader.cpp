// The port's host loading engine (bound by data/native_loader.py).
//
// Two pieces, both plain host code with a C interface for ctypes:
//
// - A gather pool: persistent worker threads that copy rows
//   dst[r] = src[idx[r]] for a submitted job while the caller goes on.
//   submit() returns a ticket at once; wait(ticket) blocks until that job's
//   rows are all written. Workers sleep on a condition variable between
//   jobs and claim a few rows at a time through a shared cursor, so a job
//   spreads over every free worker and one slow row range does not hold
//   the rest. ctypes calls release the GIL, so neither the copy nor a wait
//   holds up another Python thread (the one that launches the device's
//   work, in PrefetchLoader).
// - A .npy reader over mmap: parses the header, checks that the file holds
//   every byte the header promises (a touch past the end of a mapping
//   raises SIGBUS, not an error the caller can catch), maps the file
//   read-only and hints readahead over a byte range with
//   madvise(MADV_WILLNEED).
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 eid_loader.cpp
//            -o libeid_loader.so

#include <algorithm>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Rows a worker claims at a time: about four claims a worker, at most
// kMaxChunk rows, but at least kMinClaimBytes a claim, so that a job of
// small rows (a batch's labels) goes to one worker instead of waking all.
constexpr int64_t kMaxChunk = 64;
constexpr int64_t kMinClaimBytes = 64 * 1024;

struct Job {
  const uint8_t* src;
  uint8_t* dst;
  const int64_t* idx;
  int64_t n_rows;
  int64_t row_bytes;
  int64_t chunk;
  int64_t claimed = 0;  // rows handed to workers (under the pool's lock)
  int64_t done = 0;     // rows written (under the pool's lock)
};

class Pool {
 public:
  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { run(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    work_cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int threads() const { return static_cast<int>(workers_.size()); }

  int64_t submit(const uint8_t* src, uint8_t* dst, const int64_t* idx,
                 int64_t n_rows, int64_t row_bytes) {
    auto job = std::make_unique<Job>();
    job->src = src;
    job->dst = dst;
    job->idx = idx;
    job->n_rows = n_rows;
    job->row_bytes = row_bytes;
    const int64_t claims = 4 * static_cast<int64_t>(workers_.size());
    const int64_t min_rows =
        (kMinClaimBytes + std::max<int64_t>(row_bytes, 1) - 1) /
        std::max<int64_t>(row_bytes, 1);
    job->chunk = std::max<int64_t>(
        {1, std::min<int64_t>(kMaxChunk, (n_rows + claims - 1) / claims),
         std::min(min_rows, n_rows)});
    const bool one_claim = job->chunk >= n_rows;
    int64_t ticket;
    {
      std::lock_guard<std::mutex> lk(mu_);
      ticket = next_ticket_++;
      if (n_rows > 0) queue_.push_back(job.get());
      jobs_.emplace(ticket, std::move(job));
    }
    if (n_rows == 0) return ticket;
    if (one_claim) {
      work_cv_.notify_one();
    } else {
      work_cv_.notify_all();
    }
    return ticket;
  }

  // 0 once the ticket's rows are all written; -1 for a ticket this pool
  // did not issue or that was already waited on.
  int wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = jobs_.find(ticket);
    if (it == jobs_.end()) return -1;
    Job* job = it->second.get();
    done_cv_.wait(lk, [job] { return job->done == job->n_rows; });
    jobs_.erase(it);
    return 0;
  }

 private:
  void run() {
    for (;;) {
      Job* job;
      int64_t begin, end;
      {
        std::unique_lock<std::mutex> lk(mu_);
        work_cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) return;  // stopping, with no work left
        job = queue_.front();
        begin = job->claimed;
        end = std::min(begin + job->chunk, job->n_rows);
        job->claimed = end;
        if (end == job->n_rows) queue_.pop_front();
      }
      const size_t rb = static_cast<size_t>(job->row_bytes);
      for (int64_t r = begin; r < end; ++r) {
        std::memcpy(job->dst + r * job->row_bytes,
                    job->src + job->idx[r] * job->row_bytes, rb);
      }
      bool finished;
      {
        std::lock_guard<std::mutex> lk(mu_);
        job->done += end - begin;
        finished = job->done == job->n_rows;
      }
      if (finished) done_cv_.notify_all();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable work_cv_;  // workers: a job has unclaimed rows
  std::condition_variable done_cv_;  // waiters: a job finished
  std::deque<Job*> queue_;           // jobs with unclaimed rows, in order
  std::unordered_map<int64_t, std::unique_ptr<Job>> jobs_;  // not waited on
  int64_t next_ticket_ = 1;
  bool stop_ = false;
};

// ——— .npy header ———————————————————————————————————————————————————

enum NpyStatus {
  kNpyOk = 0,
  kNpyIoError = 1,     // open, stat or mmap failed (errno is kept)
  kNpyNotNpy = 2,      // no .npy magic, or a header this reader cannot parse
  kNpyOtherLayout = 3, // a valid .npy this reader does not map: Fortran
                       // order, big-endian, structured or object dtype
  kNpyTruncated = 4,   // shorter than its header promises
};

constexpr int kMaxDims = 32;

struct NpyMap {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t file_bytes = 0;
  size_t data_offset = 0;
  size_t data_bytes = 0;
  int ndim = 0;
  int64_t shape[kMaxDims];
  char descr[32];
};

// The text after `'key':` in the header dict, leading blanks skipped.
const char* header_value(const std::string& hdr, const char* key) {
  size_t k = hdr.find(key);
  if (k == std::string::npos) return nullptr;
  size_t colon = hdr.find(':', k + std::strlen(key));
  if (colon == std::string::npos) return nullptr;
  const char* p = hdr.c_str() + colon + 1;
  while (*p == ' ') ++p;
  return p;
}

// Fills descr, ndim and shape from the header; returns a NpyStatus.
int parse_header(const std::string& hdr, NpyMap* m) {
  const char* d = header_value(hdr, "'descr'");
  if (d == nullptr) return kNpyNotNpy;
  if (*d == '[') return kNpyOtherLayout;  // a structured dtype
  if (*d != '\'') return kNpyNotNpy;
  const char* d_end = std::strchr(d + 1, '\'');
  if (d_end == nullptr) return kNpyNotNpy;
  std::string descr(d + 1, d_end);
  if (descr.size() < 2 || descr.size() >= sizeof(m->descr)) return kNpyNotNpy;
  if (descr[0] == '>') return kNpyOtherLayout;
  if (descr[1] == 'O') return kNpyOtherLayout;
  std::snprintf(m->descr, sizeof(m->descr), "%s", descr.c_str());

  const char* f = header_value(hdr, "'fortran_order'");
  if (f == nullptr) return kNpyNotNpy;
  if (std::strncmp(f, "True", 4) == 0) return kNpyOtherLayout;
  if (std::strncmp(f, "False", 5) != 0) return kNpyNotNpy;

  const char* s = header_value(hdr, "'shape'");
  if (s == nullptr || *s != '(') return kNpyNotNpy;
  ++s;
  m->ndim = 0;
  for (;;) {
    while (*s == ' ' || *s == ',') ++s;
    if (*s == ')') break;
    if (*s < '0' || *s > '9' || m->ndim == kMaxDims) return kNpyNotNpy;
    char* after;
    errno = 0;
    long long v = std::strtoll(s, &after, 10);
    if (errno != 0) return kNpyNotNpy;
    m->shape[m->ndim++] = v;
    s = after;
  }
  return kNpyOk;
}

// Bytes of one element from a descr such as "<f4", "|b1" or "<U8"
// (4 bytes a character); 0 if the descr names no size.
size_t item_bytes(const char* descr) {
  size_t n = 0;
  bool any = false;
  for (const char* p = descr + 2; *p >= '0' && *p <= '9'; ++p) {
    n = n * 10 + static_cast<size_t>(*p - '0');
    any = true;
  }
  if (!any) return 0;
  return descr[1] == 'U' ? 4 * n : n;
}

}  // namespace

extern "C" {

// A pool of n_threads workers (at least one; the binding sets the
// default).
void* eid_pool_create(int n_threads) {
  return new Pool(std::max(n_threads, 1));
}

// Joins the workers. The caller waits out every ticket first.
void eid_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int eid_pool_threads(void* pool) {
  return static_cast<Pool*>(pool)->threads();
}

// Starts dst[r] = src[idx[r]] (row_bytes each) for r < n_rows and returns
// its ticket (> 0). Every index is checked against src_rows first: if one
// lies outside [0, src_rows), nothing is copied and -1 - r is returned for
// the first such r. src, dst and idx must stay alive until
// eid_gather_wait returns for the ticket.
int64_t eid_gather_submit(void* pool, const void* src, void* dst,
                          const int64_t* idx, int64_t n_rows,
                          int64_t row_bytes, int64_t src_rows) {
  for (int64_t r = 0; r < n_rows; ++r) {
    if (idx[r] < 0 || idx[r] >= src_rows) return -1 - r;
  }
  return static_cast<Pool*>(pool)->submit(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), idx,
      n_rows, row_bytes);
}

int eid_gather_wait(void* pool, int64_t ticket) {
  return static_cast<Pool*>(pool)->wait(ticket);
}

// ——— .npy over mmap ———————————————————————————————————————————————

// Maps a .npy file read-only. Returns a handle, or null with *status set
// (a NpyStatus; *err_no holds errno for kNpyIoError).
void* eid_npy_map(const char* path, int* status, int* err_no) {
  *err_no = 0;
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) {
    *err_no = errno;
    *status = kNpyIoError;
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    *err_no = errno;
    close(fd);
    *status = kNpyIoError;
    return nullptr;
  }
  const size_t size = static_cast<size_t>(st.st_size);
  if (size < 10) {
    close(fd);
    *status = kNpyNotNpy;
    return nullptr;
  }
  auto* base = static_cast<uint8_t*>(
      mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  if (base == MAP_FAILED) {
    *err_no = errno;
    close(fd);
    *status = kNpyIoError;
    return nullptr;
  }
  auto fail = [&](int why) -> void* {
    munmap(base, size);
    close(fd);
    *status = why;
    return nullptr;
  };
  if (std::memcmp(base, "\x93NUMPY", 6) != 0) return fail(kNpyNotNpy);
  size_t header_len, header_off;
  if (base[6] == 1) {
    header_len = base[8] | (base[9] << 8);
    header_off = 10;
  } else if (base[6] == 2 || base[6] == 3) {
    if (size < 12) return fail(kNpyNotNpy);
    header_len = base[8] | (base[9] << 8) | (base[10] << 16) |
                 (static_cast<size_t>(base[11]) << 24);
    header_off = 12;
  } else {
    return fail(kNpyNotNpy);
  }
  if (header_off + header_len > size) return fail(kNpyTruncated);
  std::string hdr(reinterpret_cast<const char*>(base) + header_off,
                  header_len);
  auto m = std::make_unique<NpyMap>();
  int parsed = parse_header(hdr, m.get());
  if (parsed != kNpyOk) return fail(parsed);
  size_t n = item_bytes(m->descr);
  if (n == 0) return fail(kNpyNotNpy);
  for (int i = 0; i < m->ndim; ++i) {
    const auto dim = static_cast<size_t>(m->shape[i]);
    if (dim != 0 && n > SIZE_MAX / dim) return fail(kNpyNotNpy);
    n *= dim;
  }
  const size_t data_offset = header_off + header_len;
  if (n > size - data_offset) return fail(kNpyTruncated);
  m->fd = fd;
  m->base = base;
  m->file_bytes = size;
  m->data_offset = data_offset;
  m->data_bytes = n;
  *status = kNpyOk;
  return m.release();
}

int eid_npy_ndim(void* h) { return static_cast<NpyMap*>(h)->ndim; }

void eid_npy_shape(void* h, int64_t* out) {
  auto* m = static_cast<NpyMap*>(h);
  for (int i = 0; i < m->ndim; ++i) out[i] = m->shape[i];
}

const char* eid_npy_descr(void* h) { return static_cast<NpyMap*>(h)->descr; }

const void* eid_npy_data(void* h) {
  auto* m = static_cast<NpyMap*>(h);
  return m->base + m->data_offset;
}

int64_t eid_npy_data_bytes(void* h) {
  return static_cast<int64_t>(static_cast<NpyMap*>(h)->data_bytes);
}

// Asks the kernel to read ahead the payload's bytes [offset, offset +
// n_bytes), clipped to the payload. Returns 0, or errno if madvise failed.
int eid_npy_willneed(void* h, int64_t offset, int64_t n_bytes) {
  auto* m = static_cast<NpyMap*>(h);
  const auto total = static_cast<int64_t>(m->data_bytes);
  offset = std::max<int64_t>(0, std::min(offset, total));
  n_bytes = std::max<int64_t>(0, std::min(n_bytes, total - offset));
  if (n_bytes == 0) return 0;
  const auto page = static_cast<uintptr_t>(sysconf(_SC_PAGESIZE));
  const auto first = reinterpret_cast<uintptr_t>(m->base + m->data_offset +
                                                  offset);
  const uintptr_t start = first & ~(page - 1);
  const size_t len = static_cast<size_t>(first + n_bytes - start);
  return madvise(reinterpret_cast<void*>(start), len, MADV_WILLNEED) == 0
             ? 0
             : errno;
}

void eid_npy_unmap(void* h) {
  auto* m = static_cast<NpyMap*>(h);
  munmap(m->base, m->file_bytes);
  close(m->fd);
  delete m;
}

}  // extern "C"
