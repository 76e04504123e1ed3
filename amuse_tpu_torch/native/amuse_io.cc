// amuse_io: native batch loader for the stage-2 window cache.
//
// A copy of amuse_tpu/native/amuse_io.cc (host code, not a kernel): the
// same ABIN format and the same std::mt19937_64 shuffle, so one seed gives
// one batch order in both packages. The reference leans on two native
// libraries for its training cache - LMDB (C) for storage and pyarrow (C++)
// for serialisation (dm/dm.py:663-683, dm/dataload.py:250-271). This is
// their equivalent: a memory-mapped fixed-stride binary shard format plus a
// background prefetch thread that assembles shuffled batches into a ring of
// host buffers while the device computes - so the Python process never
// blocks on batch assembly.
//
// Format (one file, "ABIN"):
//   header: magic "ABIN" | u32 version | u64 num_records
//           u32 num_fields | per field: u32 name_len, name bytes,
//           u32 dtype (0=f32, 1=i32), u32 ndim, u64 dims[ndim]
//   data:   records back-to-back, each record = all fields in order,
//           row-major, native endian.
//
// C API (ctypes-friendly): see extern "C" block at the bottom.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Field {
  std::string name;
  uint32_t dtype = 0;  // 0=f32, 1=i32
  std::vector<uint64_t> dims;
  uint64_t elem_count = 1;
  uint64_t byte_size = 0;   // per record
  uint64_t offset = 0;      // within record
};

struct Dataset {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  const uint8_t* data = nullptr;  // start of records
  uint64_t num_records = 0;
  uint64_t record_stride = 0;
  std::vector<Field> fields;

  // epoch state
  std::vector<uint64_t> order;
  uint64_t batch_size = 0;
  uint64_t next_batch = 0;
  uint64_t num_batches = 0;

  // prefetch ring
  struct Slot {
    std::vector<uint8_t> buf;  // batch_size * record_stride, field-major
    uint64_t batch_index = 0;
    bool ready = false;
  };
  std::vector<Slot> ring;
  uint64_t ring_head = 0;  // next slot consumer reads
  uint64_t ring_fill = 0;  // next batch index producer assembles
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::atomic<bool> stop{false};

  ~Dataset() {
    {
      // notify must happen with the mutex held (like amuse_start_epoch):
      // an unlocked notify can fire in the window between the worker's
      // predicate check and its re-block - a lost wakeup that parks the
      // worker forever and deadlocks worker.join() here
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
      cv_produce.notify_all();
    }
    if (worker.joinable()) worker.join();
    if (map) munmap(const_cast<uint8_t*>(map), map_size);
    if (fd >= 0) close(fd);
  }
};

template <typename T>
T read_pod(const uint8_t*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

// Assemble one batch into slot.buf, field-major:
// [field0 of all records | field1 of all records | ...]
void assemble(Dataset* ds, Dataset::Slot* slot, uint64_t batch_idx) {
  const uint64_t b = ds->batch_size;
  uint8_t* out = slot->buf.data();
  for (const Field& f : ds->fields) {
    for (uint64_t i = 0; i < b; ++i) {
      uint64_t rec = ds->order[batch_idx * b + i];
      const uint8_t* src = ds->data + rec * ds->record_stride + f.offset;
      std::memcpy(out, src, f.byte_size);
      out += f.byte_size;
    }
  }
  // NOTE: ready/batch_index are published by the CALLER under ds->mu;
  // writing them here (outside the lock) would race the consumer's and
  // worker predicate's locked reads
}

void worker_loop(Dataset* ds) {
  for (;;) {
    std::unique_lock<std::mutex> lk(ds->mu);
    ds->cv_produce.wait(lk, [&] {
      if (ds->stop.load()) return true;
      if (ds->ring_fill >= ds->num_batches) return false;
      // a free (consumed) slot?
      auto& s = ds->ring[ds->ring_fill % ds->ring.size()];
      return !s.ready;
    });
    if (ds->stop.load()) return;
    uint64_t idx = ds->ring_fill++;
    auto& slot = ds->ring[idx % ds->ring.size()];
    lk.unlock();
    assemble(ds, &slot, idx);  // fills buf only; publication is below
    lk.lock();
    slot.batch_index = idx;
    slot.ready = true;  // under the mutex: consumer reads these locked
    ds->cv_consume.notify_all();
  }
}

}  // namespace

extern "C" {

// Open an ABIN file. Returns an opaque handle or nullptr.
void* amuse_open(const char* path) {
  auto ds = new Dataset();
  ds->fd = ::open(path, O_RDONLY);
  if (ds->fd < 0) { delete ds; return nullptr; }
  struct stat st;
  if (fstat(ds->fd, &st) != 0) { delete ds; return nullptr; }
  ds->map_size = st.st_size;
  ds->map = static_cast<const uint8_t*>(
      mmap(nullptr, ds->map_size, PROT_READ, MAP_SHARED, ds->fd, 0));
  if (ds->map == MAP_FAILED) { ds->map = nullptr; delete ds; return nullptr; }

  // Header parsing with hard bounds checks: a truncated or corrupted file
  // (e.g. an interrupted cache_to_abin before the temp+rename fix) must be
  // REJECTED, not silently served as garbage batches / SIGBUS on read.
  const uint8_t* p = ds->map;
  const uint8_t* end = ds->map + ds->map_size;
  auto fail = [&]() { delete ds; return static_cast<void*>(nullptr); };
  if (ds->map_size < 20 || std::memcmp(p, "ABIN", 4) != 0) return fail();
  p += 4;
  uint32_t version = read_pod<uint32_t>(p);
  (void)version;
  ds->num_records = read_pod<uint64_t>(p);
  uint32_t nf = read_pod<uint32_t>(p);
  if (nf == 0 || nf > 1024) return fail();
  uint64_t offset = 0;
  for (uint32_t i = 0; i < nf; ++i) {
    Field f;
    if (end - p < 4) return fail();
    uint32_t nl = read_pod<uint32_t>(p);
    if (nl > 4096 || static_cast<uint64_t>(end - p) < nl + 8ull) return fail();
    f.name.assign(reinterpret_cast<const char*>(p), nl);
    p += nl;
    f.dtype = read_pod<uint32_t>(p);
    uint32_t nd = read_pod<uint32_t>(p);
    if (nd > 16 || static_cast<uint64_t>(end - p) < nd * 8ull) return fail();
    for (uint32_t d = 0; d < nd; ++d) {
      uint64_t dim = read_pod<uint64_t>(p);
      f.dims.push_back(dim);
      f.elem_count *= dim;
    }
    f.byte_size = f.elem_count * 4;  // f32/i32 both 4 bytes
    f.offset = offset;
    offset += f.byte_size;
    ds->fields.push_back(std::move(f));
  }
  ds->record_stride = offset;
  ds->data = p;
  // the declared record payload must actually be inside the mapping
  uint64_t avail = static_cast<uint64_t>(end - p);
  if (ds->record_stride == 0 || ds->num_records > avail / ds->record_stride)
    return fail();
  return ds;
}

uint64_t amuse_num_records(void* h) {
  return static_cast<Dataset*>(h)->num_records;
}

uint32_t amuse_num_fields(void* h) {
  return static_cast<Dataset*>(h)->fields.size();
}

// Field metadata queries (index-based).
const char* amuse_field_name(void* h, uint32_t i) {
  return static_cast<Dataset*>(h)->fields[i].name.c_str();
}
uint32_t amuse_field_dtype(void* h, uint32_t i) {
  return static_cast<Dataset*>(h)->fields[i].dtype;
}
uint32_t amuse_field_ndim(void* h, uint32_t i) {
  return static_cast<Dataset*>(h)->fields[i].dims.size();
}
uint64_t amuse_field_dim(void* h, uint32_t i, uint32_t d) {
  return static_cast<Dataset*>(h)->fields[i].dims[d];
}

// Begin a shuffled epoch with background prefetch (ring of `prefetch` slots).
// Returns the number of batches.
uint64_t amuse_start_epoch(void* h, uint64_t batch_size, uint64_t seed,
                           uint32_t shuffle, uint32_t prefetch) {
  auto ds = static_cast<Dataset*>(h);
  {
    std::lock_guard<std::mutex> lk(ds->mu);
    ds->stop.store(true);
    ds->cv_produce.notify_all();
  }
  if (ds->worker.joinable()) ds->worker.join();
  ds->stop.store(false);

  ds->batch_size = batch_size;
  ds->order.resize(ds->num_records);
  for (uint64_t i = 0; i < ds->num_records; ++i) ds->order[i] = i;
  if (shuffle && ds->num_records > 1) {  // empty: i = 2^64-1 would OOB
    std::mt19937_64 rng(seed);
    for (uint64_t i = ds->num_records - 1; i > 0; --i) {
      std::uniform_int_distribution<uint64_t> dist(0, i);
      std::swap(ds->order[i], ds->order[dist(rng)]);
    }
  }
  ds->num_batches = ds->num_records / batch_size;  // drop remainder
  ds->next_batch = 0;
  ds->ring_head = 0;
  ds->ring_fill = 0;
  uint32_t slots = prefetch < 1 ? 1 : prefetch;
  ds->ring.assign(slots, {});
  for (auto& s : ds->ring) {
    s.buf.resize(batch_size * ds->record_stride);
    s.ready = false;
  }
  ds->worker = std::thread(worker_loop, ds);
  ds->cv_produce.notify_all();
  return ds->num_batches;
}

// Copy the next prefetched batch (field-major) into `out`
// (batch_size * record_stride bytes). Returns 1 on success, 0 at epoch end.
int amuse_next_batch(void* h, uint8_t* out) {
  auto ds = static_cast<Dataset*>(h);
  std::unique_lock<std::mutex> lk(ds->mu);
  if (ds->next_batch >= ds->num_batches) return 0;
  uint64_t idx = ds->next_batch;
  auto& slot = ds->ring[idx % ds->ring.size()];
  ds->cv_consume.wait(lk, [&] { return slot.ready && slot.batch_index == idx; });
  lk.unlock();
  std::memcpy(out, slot.buf.data(), slot.buf.size());
  lk.lock();
  slot.ready = false;
  ds->next_batch++;
  ds->cv_produce.notify_all();
  return 1;
}

uint64_t amuse_batch_bytes(void* h) {
  auto ds = static_cast<Dataset*>(h);
  return ds->batch_size * ds->record_stride;
}

void amuse_close(void* h) { delete static_cast<Dataset*>(h); }

}  // extern "C"
