// Copy of lua_mapreduce_tpu/coord/native/jobstore.cpp. The torch package
// builds its own library from it (core/native_build.py) and imports
// nothing of the JAX package; the two libraries read and write the
// same files.
//
// Native job-status index — the coordination client's hot path.
//
// TPU-native equivalent of the reference's native C++ layer (SURVEY.md
// §2.4): where lua-mapreduce links luamongo + mongo-cxx-driver to talk to a
// MongoDB control plane, this framework's control plane is a shared-file
// compare-and-swap index, and this library is its native engine. The Python
// fallback (coord/idx_py.py) implements the identical on-disk format; both
// may operate on the same files concurrently.
//
// Concurrency model: every operation opens the index file, takes an
// exclusive flock, operates with pread/pwrite, and releases on close. flock
// is process-crash-safe (the OS drops the lock when the holder dies), which
// is what makes worker failure recovery sound with no lease machinery.
//
// Layout (little-endian, matching idx_py.py):
//   header: char magic[8] = "JSIX0003"; int64 count;
//   record: int32 status; int32 repetitions; int64 worker; double started;
//           double reserved;   // reserved = last heartbeat time
//                              // (0.0 = never beaten)
//           double times[5];   // job times (started, finished, written,
//                              // cpu, real); all-zero = not recorded.
//           int64 spec_worker; // shadow-lease holder (duplicate lease)
//           int32 spec_state;  // 0 none | 1 open | 2 taken
//           int32 spec_pad;    // reserved (alignment)
//                              // 88 bytes total. JSIX0002 embedded the
//                              // times so a batch commit retires status
//                              // AND timing in one flock cycle; JSIX0003
//                              // adds the duplicate-lease fields so the
//                              // first-commit-wins arbitration is one
//                              // CAS under the same flock (DESIGN §21).

#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'J', 'S', 'I', 'X', '0', '0', '0', '3'};
constexpr int64_t kHeaderSize = 16;
constexpr int64_t kRecordSize = 88;
constexpr int kNTimes = 5;

// Status values mirror core/constants.py (reference utils.lua:33-40).
enum Status : int32_t {
  kWaiting = 0,
  kRunning = 1,
  kBroken = 2,
  kFinished = 3,
  kWritten = 4,
  kFailed = 5,
};

constexpr uint32_t kClaimMask = (1u << kWaiting) | (1u << kBroken);

// spec_state values (DESIGN §21), mirrored by coord/idx_py.py
enum SpecState : int32_t {
  kSpecNone = 0,
  kSpecOpen = 1,   // straggler detector marked: shadow lease claimable
  kSpecTaken = 2,  // spec_worker holds the shadow lease
};

#pragma pack(push, 1)
struct Header {
  char magic[8];
  int64_t count;
};
struct Record {
  int32_t status;
  int32_t repetitions;
  int64_t worker;
  double started;
  double reserved;
  double times[kNTimes];
  int64_t spec_worker;
  int32_t spec_state;
  int32_t spec_pad;
};
#pragma pack(pop)

static_assert(sizeof(Header) == kHeaderSize, "header layout");
static_assert(sizeof(Record) == kRecordSize, "record layout");
// the status values ARE the wire format (both engines write them into
// shared index files); drift against core/constants.py corrupts live
// coordination state, so they are pinned here and re-checked from the
// Python side at library load via jsx_abi()
static_assert(kWaiting == 0 && kRunning == 1 && kBroken == 2 &&
                  kFinished == 3 && kWritten == 4 && kFailed == 5,
              "status enum drifted from core/constants.py");

class LockedIndex {
 public:
  explicit LockedIndex(const char* path, bool create)
      : fd_(open(path, O_RDWR | (create ? O_CREAT : 0), 0666)) {
    if (fd_ >= 0 && flock(fd_, LOCK_EX) != 0) {
      close(fd_);
      fd_ = -1;
    }
  }
  ~LockedIndex() {
    if (fd_ >= 0) close(fd_);  // close releases the flock
  }
  bool ok() const { return fd_ >= 0; }

  int64_t count() const {
    Header h;
    if (pread(fd_, &h, sizeof h, 0) != (ssize_t)sizeof h) return 0;
    if (memcmp(h.magic, kMagic, sizeof kMagic) != 0) return -1;
    return h.count;
  }

  bool set_count(int64_t n) const {
    Header h;
    memcpy(h.magic, kMagic, sizeof kMagic);
    h.count = n;
    return pwrite(fd_, &h, sizeof h, 0) == (ssize_t)sizeof h;
  }

  bool read(int64_t id, Record* rec) const {
    return pread(fd_, rec, sizeof *rec, kHeaderSize + id * kRecordSize) ==
           (ssize_t)sizeof *rec;
  }

  bool write(int64_t id, const Record& rec) const {
    return pwrite(fd_, &rec, sizeof rec, kHeaderSize + id * kRecordSize) ==
           (ssize_t)sizeof rec;
  }

  // One bulk pread of every record — scan-shaped operations (claim,
  // counts, snapshot, scavenge, requeue) pay ONE IO round trip under the
  // flock instead of one pread per record; mutated records are written
  // back individually (few per pass).
  bool read_all(std::vector<Record>* out) const {
    const int64_t n = count();
    if (n < 0) return false;
    out->resize((size_t)n);
    if (n == 0) return true;
    const ssize_t want = (ssize_t)(n * kRecordSize);
    return pread(fd_, out->data(), want, kHeaderSize) == want;
  }

 private:
  int fd_;
};

// the duplicate-lease ownership rule (DESIGN §21): the claimant owns
// the record, and while a shadow lease is TAKEN so does the speculative
// worker — either may land the ONE commit; the status CAS arbitrates
// first-commit-wins under the flock.
bool owner_ok(const Record& rec, int64_t expect_worker) {
  if (rec.worker == expect_worker) return true;
  return rec.spec_state == kSpecTaken && rec.spec_worker == expect_worker;
}

// placement tag of a worker from its stable name hash (the fleet-side
// twin of engine/placement.py's 8 virtual failure domains; unsigned so
// Python and C++ agree on negative hashes)
uint64_t worker_tag(int64_t worker) { return (uint64_t)worker % 8; }

// leaving the leased states (release/requeue) dissolves any shadow
// lease: a re-claimed job must never be committable by a stale
// speculative worker.
void clear_spec_on_unlease(Record* rec, int32_t to) {
  if (to == kWaiting || to == kBroken) {
    rec->spec_worker = 0;
    rec->spec_state = kSpecNone;
    rec->spec_pad = 0;
  }
}

double now_seconds() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

}  // namespace

extern "C" {

int64_t jsx_claim_batch(const char* path, int64_t worker,
                        const int64_t* preferred, int64_t n_preferred,
                        int32_t steal, int64_t* out_ids, int32_t* out_reps,
                        int64_t k);

// ABI self-description: the on-disk layout THIS build writes. The Python
// loader (coord/idx.py) calls it once per process and refuses the native
// engine if anything disagrees with idx_py.py — a version skew between
// the two engines must fail at load time, never as silent corruption of
// a shared index file. Fills magic_out[8], sizes_out[2] = {header,
// record}, statuses_out[6] in core/constants.py order; returns 1.
int32_t jsx_abi(char* magic_out, int64_t* sizes_out,
                int32_t* statuses_out) {
  memcpy(magic_out, kMagic, sizeof kMagic);
  sizes_out[0] = kHeaderSize;
  sizes_out[1] = kRecordSize;
  const int32_t statuses[6] = {kWaiting, kRunning, kBroken,
                               kFinished, kWritten, kFailed};
  memcpy(statuses_out, statuses, sizeof statuses);
  return 1;
}

// Append n WAITING records; returns first new id, or -1 on error.
int64_t jsx_insert(const char* path, int64_t n) {
  LockedIndex idx(path, /*create=*/true);
  if (!idx.ok()) return -1;
  int64_t count = idx.count();  // 0 for a freshly created empty file
  if (count < 0) return -1;
  Record rec{kWaiting, 0, 0, 0.0, 0.0, {}, 0, kSpecNone, 0};
  for (int64_t i = 0; i < n; ++i) {
    if (!idx.write(count + i, rec)) return -1;
  }
  if (!idx.set_count(count + n)) return -1;
  return count;
}

// Number of records, 0 if missing, -1 on corruption.
int64_t jsx_count(const char* path) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  return idx.count();
}

// Claim first WAITING|BROKEN record for worker (preferred ids first; when
// steal == 0 only the preferred ids are considered — map-affinity mode).
// Returns claimed id or -1. Thin wrapper over the batch path (k = 1), so
// both share the one-bulk-read scan.
int64_t jsx_claim(const char* path, int64_t worker, const int64_t* preferred,
                  int64_t n_preferred, int32_t steal) {
  int64_t id = -1;
  int32_t reps = 0;
  const int64_t n = jsx_claim_batch(path, worker, preferred, n_preferred,
                                    steal, &id, &reps, 1);
  return n == 1 ? id : -1;
}

// Claim up to k WAITING|BROKEN records for worker in ONE locked pass (the
// batch-lease amortization of jsx_claim). Fills out_ids/out_reps with the
// claimed ids and their pre-claim repetition counts; returns how many were
// claimed (0 when nothing is claimable), or -1 on error. Preferred ids are
// tried first; steal == 0 restricts the scan to them.
int64_t jsx_claim_batch(const char* path, int64_t worker,
                        const int64_t* preferred, int64_t n_preferred,
                        int32_t steal, int64_t* out_ids, int32_t* out_reps,
                        int64_t k) {
  if (k <= 0) return 0;
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  std::vector<Record> recs;
  if (!idx.read_all(&recs)) return -1;
  const int64_t count = (int64_t)recs.size();
  if (count <= 0) return 0;
  const double now = now_seconds();
  int64_t taken = 0;

  // scan in memory; a claimed record's in-buffer status flips to RUNNING,
  // which also makes it unclaimable again this pass (a preferred id later
  // reachable by the steal scan)
  auto try_id = [&](int64_t id) -> bool {
    Record& rec = recs[(size_t)id];
    if (!((1u << rec.status) & kClaimMask)) return false;
    out_ids[taken] = id;
    out_reps[taken] = rec.repetitions;
    rec.status = kRunning;
    rec.worker = worker;
    rec.started = now;
    rec.reserved = 0.0;  // fresh claim: fresh silence clock, fresh
    for (int t = 0; t < kNTimes; ++t) rec.times[t] = 0.0;  // times,
    rec.spec_worker = 0;                 // and no carried shadow lease
    rec.spec_state = kSpecNone;
    rec.spec_pad = 0;
    if (!idx.write(id, rec)) return false;
    ++taken;
    return true;
  };

  for (int64_t i = 0; i < n_preferred && taken < k; ++i) {
    const int64_t id = preferred[i];
    if (id >= 0 && id < count) try_id(id);
  }
  if (steal) {
    for (int64_t id = 0; id < count && taken < k; ++id) try_id(id);
  }
  return taken;
}

// CAS status; expect_mask is a bitmask of (1<<status), 0 = unconditional;
// expect_worker != 0 additionally requires the record's claim owner to
// match (a stale claimant must not clobber a re-claimed job). Moving to
// BROKEN increments repetitions. Returns 1 on success, 0 on
// mismatch/bounds, -1 on error.
int jsx_cas_status(const char* path, int64_t id, int32_t to,
                   uint32_t expect_mask, int64_t expect_worker) {
  if (access(path, F_OK) != 0) return 0;  // namespace dropped: CAS misses
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  const int64_t count = idx.count();
  if (id < 0 || id >= count) return 0;
  Record rec;
  if (!idx.read(id, &rec)) return -1;
  if (expect_mask && !((1u << rec.status) & expect_mask)) return 0;
  if (expect_worker != 0 && !owner_ok(rec, expect_worker)) return 0;
  if (to == kBroken) rec.repetitions += 1;
  rec.status = to;
  clear_spec_on_unlease(&rec, to);
  return idx.write(id, rec) ? 1 : -1;
}

// jsx_cas_status over n ids under ONE flock — the batch-commit
// amortization. ok_out[i] = 1 where the CAS landed; each id is judged
// independently (one lost claim never blocks the rest of the batch).
// Returns how many landed, or -1 on IO error.
int64_t jsx_cas_status_batch(const char* path, const int64_t* ids, int64_t n,
                             int32_t to, uint32_t expect_mask,
                             int64_t expect_worker, int32_t* ok_out) {
  for (int64_t i = 0; i < n; ++i) ok_out[i] = 0;
  if (n <= 0) return 0;
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  const int64_t count = idx.count();
  int64_t landed = 0;
  Record rec;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t id = ids[i];
    if (id < 0 || id >= count) continue;
    if (!idx.read(id, &rec)) return -1;
    if (expect_mask && !((1u << rec.status) & expect_mask)) continue;
    if (expect_worker != 0 && !owner_ok(rec, expect_worker)) continue;
    if (to == kBroken) rec.repetitions += 1;
    rec.status = to;
    clear_spec_on_unlease(&rec, to);
    if (!idx.write(id, rec)) return -1;
    ok_out[i] = 1;
    ++landed;
  }
  return landed;
}

// Retire a batch in ONE flock cycle: for each id, iff the record is
// RUNNING|FINISHED and `worker` owns the claim (0 = skip the check),
// write its 5 job times (times + i*5) into the record and flip it
// WRITTEN. ok_out[i] = 1 where the commit landed. Returns how many
// landed, or -1 on IO error. The v1 protocol spent two status CASes plus
// a times-sidecar rename per job here.
int64_t jsx_commit_batch(const char* path, const int64_t* ids, int64_t n,
                         int64_t worker, const double* times,
                         int32_t* ok_out) {
  for (int64_t i = 0; i < n; ++i) ok_out[i] = 0;
  if (n <= 0) return 0;
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  const int64_t count = idx.count();
  int64_t landed = 0;
  Record rec;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t id = ids[i];
    if (id < 0 || id >= count) continue;
    if (!idx.read(id, &rec)) return -1;
    // first-commit-wins: WRITTEN fails this status check, so the
    // losing duplicate's entry is skipped without any state change
    if (rec.status != kRunning && rec.status != kFinished) continue;
    if (worker != 0 && !owner_ok(rec, worker)) continue;
    rec.status = kWritten;
    for (int t = 0; t < kNTimes; ++t) rec.times[t] = times[i * kNTimes + t];
    if (!idx.write(id, rec)) return -1;
    ok_out[i] = 1;
    ++landed;
  }
  return landed;
}

// Record a job's times without touching its status (the single-job
// set_job_times path). Returns 1 on success, 0 on bounds/missing, -1 on
// IO error.
int jsx_set_times(const char* path, int64_t id, const double* times5) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  if (id < 0 || id >= idx.count()) return 0;
  Record rec;
  if (!idx.read(id, &rec)) return -1;
  for (int t = 0; t < kNTimes; ++t) rec.times[t] = times5[t];
  return idx.write(id, rec) ? 1 : -1;
}

// Read one record (times5 gets the 5 job times; all-zero = none
// recorded; spec_state/spec_worker describe any duplicate lease).
// Returns 1 on success, 0 if out of bounds, -1 on error.
int jsx_get(const char* path, int64_t id, int32_t* status,
            int32_t* repetitions, int64_t* worker, double* started,
            double* times5, int32_t* spec_state, int64_t* spec_worker) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  if (id < 0 || id >= idx.count()) return 0;
  Record rec;
  if (!idx.read(id, &rec)) return -1;
  *status = rec.status;
  *repetitions = rec.repetitions;
  *worker = rec.worker;
  *started = rec.started;
  for (int t = 0; t < kNTimes; ++t) times5[t] = rec.times[t];
  *spec_state = rec.spec_state;
  *spec_worker = rec.spec_worker;
  return 1;
}

// Per-status counts into out[6]. Returns total count or -1.
int64_t jsx_counts(const char* path, int64_t* out6) {
  for (int i = 0; i < 6; ++i) out6[i] = 0;
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  std::vector<Record> recs;
  if (!idx.read_all(&recs)) return -1;
  for (const Record& rec : recs) {
    if (rec.status >= 0 && rec.status < 6) out6[rec.status] += 1;
  }
  return (int64_t)recs.size();
}

// RUNNING|FINISHED records whose last liveness signal — claim time or
// worker heartbeat (record.reserved, see jsx_heartbeat) — predates cutoff
// → BROKEN (+1 repetition). Covers hard-killed workers, including a kill
// between the FINISHED and WRITTEN transitions (no analog in the
// reference; see jobstore.py). A legitimately long job whose worker keeps
// heartbeating is never requeued, however long it runs.
int64_t jsx_requeue_stale(const char* path, double cutoff) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  std::vector<Record> recs;
  if (!idx.read_all(&recs)) return -1;
  int64_t n = 0;
  for (int64_t id = 0; id < (int64_t)recs.size(); ++id) {
    Record& rec = recs[(size_t)id];
    const double live =
        rec.reserved > rec.started ? rec.reserved : rec.started;
    if ((rec.status == kRunning || rec.status == kFinished) &&
        live < cutoff) {
      rec.status = kBroken;
      rec.repetitions += 1;
      clear_spec_on_unlease(&rec, kBroken);
      if (!idx.write(id, rec)) return -1;
      ++n;
    }
  }
  return n;
}

// Refresh the liveness timestamp (record.reserved) of a RUNNING|FINISHED
// record, iff `worker` still owns the claim (0 = skip the ownership
// check). Returns 1 on success, 0 on mismatch/bounds/missing, -1 on
// error. The worker runtime beats this during long map/reduce jobs so
// the server's stale-requeue measures silence, not elapsed time.
int jsx_heartbeat(const char* path, int64_t id, int64_t worker, double now) {
  if (access(path, F_OK) != 0) return 0;  // namespace dropped: miss
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  if (id < 0 || id >= idx.count()) return 0;
  Record rec;
  if (!idx.read(id, &rec)) return -1;
  if (rec.status != kRunning && rec.status != kFinished) return 0;
  if (worker != 0 && !owner_ok(rec, worker)) return 0;
  rec.reserved = now;
  return idx.write(id, rec) ? 1 : -1;
}

// jsx_heartbeat over n ids under ONE flock — the batch lease's single
// heartbeat thread beats every leased job in one lock cycle. Returns how
// many beats landed, or -1 on IO error.
int64_t jsx_heartbeat_batch(const char* path, const int64_t* ids, int64_t n,
                            int64_t worker, double now) {
  if (n <= 0) return 0;
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  const int64_t count = idx.count();
  int64_t landed = 0;
  Record rec;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t id = ids[i];
    if (id < 0 || id >= count) continue;
    if (!idx.read(id, &rec)) return -1;
    if (rec.status != kRunning && rec.status != kFinished) continue;
    if (worker != 0 && !owner_ok(rec, worker)) continue;
    rec.reserved = now;
    if (!idx.write(id, rec)) return -1;
    ++landed;
  }
  return landed;
}

// Bulk snapshot: fill caller arrays (capacity cap) with every record's
// state in one locked pass. Returns the number filled, or -1 on error.
int64_t jsx_snapshot(const char* path, int32_t* statuses, int32_t* reps,
                     int64_t* workers, double* started, double* times,
                     int32_t* spec_states, int64_t* spec_workers,
                     int64_t cap) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  std::vector<Record> recs;
  if (!idx.read_all(&recs)) return -1;
  int64_t count = (int64_t)recs.size();
  if (count > cap) count = cap;
  for (int64_t id = 0; id < count; ++id) {
    const Record& rec = recs[(size_t)id];
    statuses[id] = rec.status;
    reps[id] = rec.repetitions;
    workers[id] = rec.worker;
    started[id] = rec.started;
    for (int t = 0; t < kNTimes; ++t)
      times[id * kNTimes + t] = rec.times[t];
    spec_states[id] = rec.spec_state;
    spec_workers[id] = rec.spec_worker;
  }
  return count;
}

// BROKEN records with repetitions >= max_retries → FAILED. Returns how many.
int64_t jsx_scavenge(const char* path, int32_t max_retries) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  std::vector<Record> recs;
  if (!idx.read_all(&recs)) return -1;
  int64_t n = 0;
  for (int64_t id = 0; id < (int64_t)recs.size(); ++id) {
    Record& rec = recs[(size_t)id];
    if (rec.status == kBroken && rec.repetitions >= max_retries) {
      rec.status = kFailed;
      if (!idx.write(id, rec)) return -1;
      ++n;
    }
  }
  return n;
}

// -- duplicate leases (speculative execution, DESIGN §21) -------------------

// Mark a RUNNING record speculation-OPEN (a shadow lease may be taken by
// jsx_claim_spec). CASed on (RUNNING, no existing speculation) so the
// detector's repeated passes are idempotent and a job carries at most ONE
// shadow lease. Returns 1 landed, 0 refused, -1 on error.
int jsx_speculate(const char* path, int64_t id) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  if (id < 0 || id >= idx.count()) return 0;
  Record rec;
  if (!idx.read(id, &rec)) return -1;
  if (rec.status != kRunning || rec.spec_state != kSpecNone) return 0;
  rec.spec_worker = 0;
  rec.spec_state = kSpecOpen;
  return idx.write(id, rec) ? 1 : -1;
}

// Take ONE speculation-open shadow lease for `worker`. A worker never
// shadows its own job; records whose claimant sits on a DIFFERENT
// placement tag are preferred, lowest id first within each preference
// class (same scan order as the Python engine). Fills *out_reps;
// returns the job id, -1 when nothing is open, or -2 on IO error —
// "no lease" and "the index is broken" must stay distinguishable, or
// speculation dies silently on a sick disk.
int64_t jsx_claim_spec(const char* path, int64_t worker, int32_t* out_reps) {
  if (access(path, F_OK) != 0) return -1;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -2;
  std::vector<Record> recs;
  if (!idx.read_all(&recs)) return -2;
  const uint64_t my_tag = worker_tag(worker);
  int64_t fallback = -1;
  for (int64_t id = 0; id < (int64_t)recs.size(); ++id) {
    const Record& rec = recs[(size_t)id];
    if (rec.status != kRunning || rec.spec_state != kSpecOpen ||
        rec.worker == worker)
      continue;
    if (worker_tag(rec.worker) != my_tag) {
      Record take = rec;
      take.spec_worker = worker;
      take.spec_state = kSpecTaken;
      if (!idx.write(id, take)) return -2;
      *out_reps = take.repetitions;
      return id;
    }
    if (fallback < 0) fallback = id;
  }
  if (fallback >= 0) {
    Record take = recs[(size_t)fallback];
    take.spec_worker = worker;
    take.spec_state = kSpecTaken;
    if (!idx.write(fallback, take)) return -2;
    *out_reps = take.repetitions;
    return fallback;
  }
  return -1;
}

// Dissolve a shadow lease `worker` holds — the loser / failure path; the
// job's status and repetitions are never touched (the original claimant
// still owns the lease). worker == 0 clears any OPEN or TAKEN speculation
// (the detector's retraction). Returns 1 cleared, 0 refused, -1 on error.
int jsx_cancel_spec(const char* path, int64_t id, int64_t worker) {
  if (access(path, F_OK) != 0) return 0;
  LockedIndex idx(path, false);
  if (!idx.ok()) return -1;
  if (id < 0 || id >= idx.count()) return 0;
  Record rec;
  if (!idx.read(id, &rec)) return -1;
  if (worker != 0) {
    if (rec.spec_state != kSpecTaken || rec.spec_worker != worker) return 0;
  } else if (rec.spec_state == kSpecNone) {
    return 0;
  }
  rec.spec_worker = 0;
  rec.spec_state = kSpecNone;
  rec.spec_pad = 0;
  return idx.write(id, rec) ? 1 : -1;
}

}  // extern "C"
