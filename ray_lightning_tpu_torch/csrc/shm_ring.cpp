// Shared-memory ring buffer for cross-process batch hand-off.
//
// The native runtime piece of the host-side data pipeline: worker processes
// (forked data loaders) push framed byte messages (serialized batches) into
// a POSIX shared-memory segment; the trainer process pops them without
// pickling through a pipe and without holding the Python GIL — calls are
// plain C through ctypes, so the copy and all blocking happens GIL-free and
// overlaps the device step.
//
// Role in the framework (see SURVEY.md §2.2): the reference consumes its
// native capabilities (NCCL rings, Ray's plasma object store) from external
// C++ deps; this file is the equivalent in-repo native layer for the one
// hot host-side path the TPU build owns itself — feeding the chips.
//
// Layout of the segment:
//   [Header | data bytes ...]
// Messages are framed [u64 len][payload], stored contiguously; a len of
// WRAP_MARKER means "skip to start of data area". Synchronization is a
// process-shared pthread mutex + two condvars (not_full / not_empty).
//
// Build: g++ -O3 -shared -fPIC -pthread shm_ring.cpp -o libtlnative.so -lrt

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t WRAP_MARKER = ~0ull;
constexpr uint32_t MAGIC = 0x544c5247;  // "TLRG"

struct Header {
  uint32_t magic;
  uint32_t closed;
  uint64_t capacity;   // bytes in the data area
  uint64_t head;       // read offset into data area
  uint64_t tail;       // write offset into data area
  uint64_t used;       // bytes currently stored (incl. frame headers)
  uint64_t n_messages;
  pthread_mutex_t mutex;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
};

struct Ring {
  Header* hdr;
  char* data;
  size_t map_size;
  int owner;  // created (vs attached) — owner unlinks on destroy
  char name[256];
};

void make_abstime(double timeout_s, timespec* ts) {
  clock_gettime(CLOCK_REALTIME, ts);
  time_t sec = static_cast<time_t>(timeout_s);
  long nsec = static_cast<long>((timeout_s - sec) * 1e9);
  ts->tv_sec += sec;
  ts->tv_nsec += nsec;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

// Space needed to store a message of n payload bytes at offset `tail`
// given `capacity` (accounts for a possible wrap marker).
uint64_t frame_bytes(uint64_t n) { return 8 + n; }

}  // namespace

extern "C" {

// Create a new ring in shared memory. Returns handle or nullptr.
void* tlshm_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a dead run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t map_size = sizeof(Header) + capacity;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Header* hdr = static_cast<Header*>(mem);
  std::memset(hdr, 0, sizeof(Header));
  hdr->capacity = capacity;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutex_init(&hdr->mutex, &ma);
  pthread_mutexattr_destroy(&ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_full, &ca);
  pthread_cond_init(&hdr->not_empty, &ca);
  pthread_condattr_destroy(&ca);

  hdr->magic = MAGIC;

  Ring* r = new Ring();
  r->hdr = hdr;
  r->data = static_cast<char*>(mem) + sizeof(Header);
  r->map_size = map_size;
  r->owner = 1;
  std::strncpy(r->name, name, sizeof(r->name) - 1);
  return r;
}

// Attach to an existing ring. Returns handle or nullptr.
void* tlshm_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* hdr = static_cast<Header*>(mem);
  if (hdr->magic != MAGIC) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Ring* r = new Ring();
  r->hdr = hdr;
  r->data = static_cast<char*>(mem) + sizeof(Header);
  r->map_size = static_cast<size_t>(st.st_size);
  r->owner = 0;
  std::strncpy(r->name, name, sizeof(r->name) - 1);
  return r;
}

// True iff a frame of fb bytes can be written contiguously right now
// (either at the tail, or at offset 0 after retiring the tail gap).
static bool fits_locked(const Header* h, uint64_t fb) {
  if (h->capacity - h->used < fb) return false;
  uint64_t head = h->head, tail = h->tail;
  if (h->used > 0 && head > tail) return head - tail >= fb;
  // Free region spans the end of the data area (or the ring is empty).
  if (h->capacity - tail >= fb) return true;
  return head >= fb;  // wrap: the [tail, capacity) gap is retired as used
}

int tlshm_push_v(void* handle, const char* const* bufs,
                 const uint64_t* lens, uint64_t n_bufs, double timeout_s);

// Push one message. 0 = ok, -1 = timeout, -2 = closed, -3 = too large.
int tlshm_push(void* handle, const char* buf, uint64_t n, double timeout_s) {
  return tlshm_push_v(handle, &buf, &n, 1, timeout_s);
}

// Scatter-gather push: one framed message assembled from n_bufs segments,
// memcpy'd straight from caller memory into the ring. This is the
// zero-detour batch path: the Python side hands the pickle-5 meta plus the
// raw numpy array buffers as segments, so array bytes cross exactly once
// (producer memory -> shm) instead of detouring through a concatenated
// bytes object first. Same return codes as tlshm_push.
int tlshm_push_v(void* handle, const char* const* bufs,
                 const uint64_t* lens, uint64_t n_bufs, double timeout_s) {
  Ring* r = static_cast<Ring*>(handle);
  Header* h = r->hdr;
  uint64_t n = 0;
  for (uint64_t i = 0; i < n_bufs; ++i) n += lens[i];
  uint64_t fb = frame_bytes(n);
  if (fb * 2 > h->capacity) return -3;

  timespec deadline;
  make_abstime(timeout_s, &deadline);
  pthread_mutex_lock(&h->mutex);
  while (!fits_locked(h, fb) && !h->closed) {
    if (pthread_cond_timedwait(&h->not_full, &h->mutex, &deadline) ==
        ETIMEDOUT) {
      pthread_mutex_unlock(&h->mutex);
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mutex);
    return -2;
  }
  uint64_t tail = h->tail;
  if (h->capacity - tail < fb) {
    if (h->capacity - tail >= 8)
      std::memcpy(r->data + tail, &WRAP_MARKER, 8);
    h->used += h->capacity - tail;
    tail = 0;
  }
  std::memcpy(r->data + tail, &n, 8);
  uint64_t off = tail + 8;
  for (uint64_t i = 0; i < n_bufs; ++i) {
    std::memcpy(r->data + off, bufs[i], lens[i]);
    off += lens[i];
  }
  h->tail = (tail + fb) % h->capacity;
  h->used += fb;
  h->n_messages += 1;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

// Size of the next message without consuming it.
// >=0 = size, -1 = timeout, -2 = closed and drained.
int64_t tlshm_peek(void* handle, double timeout_s) {
  Ring* r = static_cast<Ring*>(handle);
  Header* h = r->hdr;
  timespec deadline;
  make_abstime(timeout_s, &deadline);
  pthread_mutex_lock(&h->mutex);
  while (h->n_messages == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mutex);
      return -2;
    }
    if (pthread_cond_timedwait(&h->not_empty, &h->mutex, &deadline) ==
        ETIMEDOUT) {
      pthread_mutex_unlock(&h->mutex);
      return -1;
    }
  }
  uint64_t head = h->head;
  uint64_t len;
  if (h->capacity - head < 8) {  // tail gap too small for a marker
    std::memcpy(&len, r->data, 8);
  } else {
    std::memcpy(&len, r->data + head, 8);
    if (len == WRAP_MARKER) std::memcpy(&len, r->data, 8);
  }
  pthread_mutex_unlock(&h->mutex);
  return static_cast<int64_t>(len);
}

// Pop one message into buf (cap bytes).
// >=0 = bytes written, -1 = timeout, -2 = closed and drained, -4 = buf small.
int64_t tlshm_pop(void* handle, char* buf, uint64_t cap, double timeout_s) {
  Ring* r = static_cast<Ring*>(handle);
  Header* h = r->hdr;
  timespec deadline;
  make_abstime(timeout_s, &deadline);
  pthread_mutex_lock(&h->mutex);
  while (h->n_messages == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mutex);
      return -2;
    }
    if (pthread_cond_timedwait(&h->not_empty, &h->mutex, &deadline) ==
        ETIMEDOUT) {
      pthread_mutex_unlock(&h->mutex);
      return -1;
    }
  }
  // Compute the wrap-gap retirement into locals and commit head/used only
  // after the len<=cap check: a -4 return must leave the ring untouched so
  // the caller can retry with a bigger buffer.
  uint64_t head = h->head;
  uint64_t len;
  uint64_t gap = 0;
  if (h->capacity - head < 8) {  // tail gap too small for a marker
    gap = h->capacity - head;
    head = 0;
    std::memcpy(&len, r->data, 8);
  } else {
    std::memcpy(&len, r->data + head, 8);
    if (len == WRAP_MARKER) {
      gap = h->capacity - head;
      head = 0;
      std::memcpy(&len, r->data, 8);
    }
  }
  if (len > cap) {
    pthread_mutex_unlock(&h->mutex);
    return -4;
  }
  std::memcpy(buf, r->data + head + 8, len);
  h->head = (head + frame_bytes(len)) % h->capacity;
  h->used -= gap + frame_bytes(len);
  h->n_messages -= 1;
  // Broadcast: several producers may fit in the space one pop frees.
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mutex);
  return static_cast<int64_t>(len);
}

uint64_t tlshm_count(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  pthread_mutex_lock(&r->hdr->mutex);
  uint64_t n = r->hdr->n_messages;
  pthread_mutex_unlock(&r->hdr->mutex);
  return n;
}

int tlshm_is_closed(void* handle) {
  return static_cast<Ring*>(handle)->hdr->closed;
}

// Close: producers stop; consumers drain then see -2.
void tlshm_close(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  pthread_mutex_lock(&r->hdr->mutex);
  r->hdr->closed = 1;
  pthread_cond_broadcast(&r->hdr->not_empty);
  pthread_cond_broadcast(&r->hdr->not_full);
  pthread_mutex_unlock(&r->hdr->mutex);
}

// Detach; the creating process also unlinks the segment.
void tlshm_destroy(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  munmap(r->hdr, r->map_size);
  if (r->owner) shm_unlink(r->name);
  delete r;
}

}  // extern "C"
