// dslog: append-only stream log with (stream, time) ordered index.
//
// The native storage engine under emqx_tpu_torch.ds.builtin_local — the slot
// the reference fills with RocksDB via erlang-rocksdb
// (EMQX rebar.config:85; apps/emqx_durable_storage/src/
// emqx_ds_storage_layer.erl).  Scope-matched to what the DS layer
// actually needs from its KV store: append message batches under a
// (stream-id, timestamp) key, replay a stream from a timestamp in
// order, survive restart (log is the source of truth; the index
// rebuilds on open), and recover from damage without silent loss.
//
// Layout: <dir>/seg-<n>.log, records are
//   [u32 len][u32 crc32(payload)][u32 stream][u64 ts][u64 seq][payload]
// A segment rolls at seg_bytes.  Readers use pread on the segment fd,
// so appends and iteration don't contend.
//
// Crash/corruption contract:
//
//   * TORN TAIL — a record whose extent reaches EOF but fails its CRC
//     (or an incomplete header/payload at EOF) is the artifact of an
//     append cut by a crash: it is truncated away, exactly as before.
//   * INTERIOR CORRUPTION — a record that fails its CRC but whose
//     extent ends BEFORE EOF was once intact and got flipped on disk
//     (bit rot, a misdirected write).  The segment's suffix from that
//     record on is QUARANTINED: never indexed, never truncated (the
//     bytes are preserved on disk for forensics), never appended into
//     (a quarantined final segment rolls to a fresh one on open), and
//     never reclaimed by gc.  The intact prefix keeps serving.  The
//     walkable-record estimate of the suffix accumulates in
//     `corrupt_records` so the binding can raise the
//     `ds_storage_corruption` alarm instead of losing data silently —
//     the old behavior (truncate at first CRC break) destroyed the
//     whole suffix with no trace.
//   * fsync ordering — rolling fsyncs the outgoing segment before
//     closing it and fsyncs the directory after creating a segment
//     file, so one dslog_sync on the current fd covers every record
//     appended since the previous sync, across rolls.
//
// C ABI (ctypes-friendly): all functions return >=0 on success,
// negative errno-style codes on failure.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <sys/uio.h>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kHeaderLen = 4 + 4 + 4 + 8 + 8;
constexpr uint64_t kDefaultSegBytes = 64ull << 20;
constexpr uint32_t kMaxRecordLen = 128u << 20;

uint32_t crc32_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc32_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    c = crc32_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Entry {
  uint64_t ts;
  uint64_t seq;
  uint32_t seg;
  uint64_t off;   // offset of payload within segment
  uint32_t len;
};

struct Db {
  std::string dir;
  uint64_t seg_bytes = kDefaultSegBytes;
  // per-stream ordered index: (ts, seq) -> location
  std::map<uint32_t, std::map<std::pair<uint64_t, uint64_t>, Entry>> index;
  std::map<uint32_t, int> seg_fds;  // read fds per segment
  uint32_t cur_seg = 0;
  int cur_fd = -1;
  uint64_t cur_size = 0;
  uint64_t next_seq = 1;
  // interior-corruption quarantine (see header comment)
  int64_t corrupt_records = 0;
  std::set<uint32_t> quarantined;
  std::mutex mu;

  ~Db() {
    if (cur_fd >= 0) close(cur_fd);
    for (auto& kv : seg_fds)
      if (kv.second >= 0 && kv.second != cur_fd) close(kv.second);
  }
};

struct Iter {
  Db* db;
  uint32_t stream;
  // resume key: strictly-greater-than cursor
  uint64_t ts = 0;
  uint64_t seq = 0;
  bool first = true;
};

std::string seg_path(const Db& db, uint32_t seg) {
  char buf[32];
  snprintf(buf, sizeof buf, "/seg-%06u.log", seg);
  return db.dir + buf;
}

int open_segment_fd(Db& db, uint32_t seg) {
  auto it = db.seg_fds.find(seg);
  if (it != db.seg_fds.end()) return it->second;
  int fd = open(seg_path(db, seg).c_str(), O_RDONLY);
  db.seg_fds[seg] = fd;
  return fd;
}

// walk the unreadable suffix by its length fields to estimate how
// many records it holds (>= 1; trailing unwalkable garbage counts 1).
int64_t count_suffix_records(int fd, uint64_t off, uint64_t size) {
  int64_t n = 0;
  uint64_t o = off;
  while (o + kHeaderLen <= size) {
    uint32_t len;
    if (pread(fd, &len, 4, o) != 4) break;
    if (len > kMaxRecordLen || o + kHeaderLen + len > size) break;
    n++;
    o += kHeaderLen + len;
  }
  if (o < size || n == 0) n++;
  return n;
}

// scan one segment, filling the index.  A torn TAIL (partial append
// cut by a crash: damage reaching EOF) truncates as before; damage
// with intact bytes written after it is interior corruption and
// quarantines the suffix (kept on disk, not served) instead of
// silently destroying it.
int recover_segment(Db& db, uint32_t seg) {
  std::string path = seg_path(db, seg);
  int fd = open(path.c_str(), O_RDWR);
  if (fd < 0) return -errno;
  struct stat st;
  if (fstat(fd, &st) != 0) { int e = -errno; close(fd); return e; }
  uint64_t size = (uint64_t)st.st_size, off = 0;
  std::vector<uint8_t> buf;
  bool quarantine = false;
  while (off + kHeaderLen <= size) {
    uint8_t head[kHeaderLen];
    if (pread(fd, head, kHeaderLen, off) != (ssize_t)kHeaderLen) {
      // the header lies within the file (loop guard) yet could not
      // be read: an IO error (bad sector), not a torn write —
      // truncating would destroy whatever intact data follows, so
      // quarantine conservatively
      quarantine = true;
      break;
    }
    uint32_t len, crc, stream;
    uint64_t ts, seq;
    memcpy(&len, head, 4);
    memcpy(&crc, head + 4, 4);
    memcpy(&stream, head + 8, 4);
    memcpy(&ts, head + 12, 8);
    memcpy(&seq, head + 20, 8);
    if (len > kMaxRecordLen) {
      // a complete header with an implausible length was flipped on
      // disk (writev writes the header atomically enough that a torn
      // append leaves a prefix, not garbage); bytes beyond the bare
      // header mean data follows it — interior corruption
      quarantine = size - off > kHeaderLen;
      break;
    }
    if (off + kHeaderLen + len > size) break;  // extends past EOF: torn
    buf.resize(len);
    if (pread(fd, buf.data(), len, off + kHeaderLen) != (ssize_t)len) {
      // extent is fully inside the file: a short/failed read is a
      // bad sector, not a crash artifact — quarantine, never truncate
      quarantine = true;
      break;
    }
    if (crc32(buf.data(), len) != crc) {
      // extent ends before EOF -> something intact was written after
      // this record, so it was once valid: interior corruption.  At
      // EOF it is the torn tail of the crashed append.
      quarantine = off + kHeaderLen + len < size;
      break;
    }
    db.index[stream][{ts, seq}] =
        Entry{ts, seq, seg, off + kHeaderLen, len};
    if (seq >= db.next_seq) db.next_seq = seq + 1;
    off += kHeaderLen + len;
  }
  if (off < size) {
    if (quarantine) {
      db.corrupt_records += count_suffix_records(fd, off, size);
      db.quarantined.insert(seg);
    } else if (ftruncate(fd, (off_t)off) != 0) {
      int e = -errno;
      close(fd);
      return e;
    }
  }
  close(fd);
  return 0;
}

int fsync_dir(const std::string& dir) {
  int dfd = open(dir.c_str(), O_RDONLY);
  if (dfd < 0) return -errno;
  int rc = fsync(dfd) != 0 ? -errno : 0;
  close(dfd);
  return rc;
}

int roll_segment(Db& db) {
  if (db.cur_fd >= 0) {
    // sync-ordering invariant: the outgoing segment is fully durable
    // before it becomes unreachable from dslog_sync (which only
    // fsyncs cur_fd) — a group-commit sync after a roll must cover
    // the records appended before it.  A FAILED flush here must fail
    // the roll (and so the append): swallowing it would let a later
    // dslog_sync on the fresh segment report success over un-flushed
    // records — the "acked means durable" contract broken silently.
    // State stays consistent for a retry: cur_fd remains the old
    // segment and cur_size still exceeds seg_bytes.
    if (fsync(db.cur_fd) != 0) return -errno;
    close(db.cur_fd);
    // also close any cached READ fd for the rolled segment (distinct
    // from cur_fd) before dropping it from the map — else it leaks
    auto it = db.seg_fds.find(db.cur_seg);
    if (it != db.seg_fds.end()) {
      if (it->second >= 0 && it->second != db.cur_fd) close(it->second);
      db.seg_fds.erase(it);
    }
    db.cur_seg++;
  }
  std::string path = seg_path(db, db.cur_seg);
  bool fresh = access(path.c_str(), F_OK) != 0;
  db.cur_fd = open(path.c_str(), O_CREAT | O_WRONLY | O_APPEND, 0644);
  if (db.cur_fd < 0) return -errno;
  if (fresh) fsync_dir(db.dir);  // the dir entry must survive too
  struct stat st;
  fstat(db.cur_fd, &st);
  db.cur_size = (uint64_t)st.st_size;
  return 0;
}

}  // namespace

extern "C" {

// open (and recover) a db directory; returns handle or null.
void* dslog_open(const char* dir, uint64_t seg_bytes) {
  Db* db = new Db;
  db->dir = dir;
  if (seg_bytes) db->seg_bytes = seg_bytes;
  mkdir(dir, 0755);
  // find existing segments
  std::vector<uint32_t> segs;
  if (DIR* d = opendir(dir)) {
    while (dirent* e = readdir(d)) {
      unsigned n;
      if (sscanf(e->d_name, "seg-%06u.log", &n) == 1) segs.push_back(n);
    }
    closedir(d);
  }
  uint32_t max_seg = 0;
  for (uint32_t s : segs) {
    if (recover_segment(*db, s) != 0) { delete db; return nullptr; }
    if (s > max_seg) max_seg = s;
  }
  db->cur_seg = segs.empty() ? 0 : max_seg;
  if (db->quarantined.count(db->cur_seg)) {
    // the final segment carries a quarantined suffix: appends must
    // never land after unreadable bytes (recovery would quarantine
    // them too) — start a fresh segment instead
    db->cur_seg = max_seg + 1;
  }
  // open current segment for append (without rolling past it)
  {
    std::string path = seg_path(*db, db->cur_seg);
    bool fresh = access(path.c_str(), F_OK) != 0;
    db->cur_fd = open(path.c_str(), O_CREAT | O_WRONLY | O_APPEND, 0644);
    if (db->cur_fd < 0) { delete db; return nullptr; }
    if (fresh) fsync_dir(db->dir);
    struct stat st;
    fstat(db->cur_fd, &st);
    db->cur_size = (uint64_t)st.st_size;
  }
  return db;
}

void dslog_close(void* h) { delete static_cast<Db*>(h); }

// append one record; returns assigned seq (>0) or negative error.
int64_t dslog_append(void* h, uint32_t stream, uint64_t ts,
                     const uint8_t* data, uint32_t len) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  if (db.cur_size >= db.seg_bytes) {
    int rc = roll_segment(db);
    if (rc != 0) return rc;
  }
  uint64_t seq = db.next_seq++;
  uint8_t head[kHeaderLen];
  uint32_t crc = crc32(data, len);
  memcpy(head, &len, 4);
  memcpy(head + 4, &crc, 4);
  memcpy(head + 8, &stream, 4);
  memcpy(head + 12, &ts, 8);
  memcpy(head + 20, &seq, 8);
  struct iovec iov[2] = {{head, kHeaderLen}, {(void*)data, len}};
  ssize_t n = writev(db.cur_fd, iov, 2);
  if (n != (ssize_t)(kHeaderLen + len)) {
    // a short write (ENOSPC/EINTR) left stray bytes at EOF: truncate
    // back so later appends land where the index says they do
    if (n > 0) ftruncate(db.cur_fd, (off_t)db.cur_size);
    db.next_seq--;  // seq was not durably consumed
    return -EIO;
  }
  uint64_t payload_off = db.cur_size + kHeaderLen;
  db.index[stream][{ts, seq}] =
      Entry{ts, seq, db.cur_seg, payload_off, len};
  db.cur_size += kHeaderLen + len;
  return (int64_t)seq;
}

int dslog_sync(void* h) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  return db.cur_fd >= 0 && fsync(db.cur_fd) != 0 ? -errno : 0;
}

// list distinct stream ids; out_cap in elements. returns count stored.
int dslog_streams(void* h, uint32_t* out, int out_cap) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  int n = 0;
  for (auto& kv : db.index) {
    if (n < out_cap) out[n] = kv.first;
    n++;
  }
  return n;
}

void* dslog_iter_new(void* h, uint32_t stream, uint64_t ts_from) {
  Iter* it = new Iter;
  it->db = static_cast<Db*>(h);
  it->stream = stream;
  it->ts = ts_from;
  it->seq = 0;
  it->first = true;
  return it;
}

void dslog_iter_free(void* itp) { delete static_cast<Iter*>(itp); }

// next record: fills buf (cap bytes), ts/seq out. returns payload len,
// 0 at end, negative on error; -E2BIG when cap is too small (record is
// NOT consumed — retry with a bigger buffer).
int64_t dslog_iter_next(void* itp, uint8_t* buf, uint32_t cap,
                        uint64_t* ts_out, uint64_t* seq_out) {
  Iter& it = *static_cast<Iter*>(itp);
  Db& db = *it.db;
  Entry e;
  {
    std::lock_guard<std::mutex> lock(db.mu);
    auto sit = db.index.find(it.stream);
    if (sit == db.index.end()) return 0;
    auto& m = sit->second;
    // first call: >= (ts_from, 0); afterwards strictly greater
    auto mit = it.first ? m.lower_bound({it.ts, 0})
                        : m.upper_bound({it.ts, it.seq});
    if (mit == m.end()) return 0;
    e = mit->second;
  }
  if (e.len > cap) return -E2BIG;
  int fd;
  {
    std::lock_guard<std::mutex> lock(db.mu);
    fd = open_segment_fd(db, e.seg);
  }
  if (fd < 0) return -EIO;
  if (pread(fd, buf, e.len, (off_t)e.off) != (ssize_t)e.len) return -EIO;
  it.ts = e.ts;
  it.seq = e.seq;
  it.first = false;
  *ts_out = e.ts;
  *seq_out = e.seq;
  return (int64_t)e.len;
}

// retention GC: unlink whole segments whose every record is older than
// cutoff_ts (the current segment is never dropped).  Returns the number
// of records reclaimed.  Segment-granular like RocksDB generation drops
// — cheap, no rewrite.  A segment id doubles as the store's GENERATION:
// `pin_floor` is the lowest generation some live replay cursor still
// needs — segments at or above it are never reclaimed, whatever their
// age (pass UINT32_MAX for "nothing pinned").
int64_t dslog_gc2(void* h, uint64_t cutoff_ts, uint32_t pin_floor) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  // per-segment max ts + record count
  std::map<uint32_t, std::pair<uint64_t, int64_t>> seg_stat;
  for (auto& skv : db.index)
    for (auto& ekv : skv.second) {
      auto& st = seg_stat[ekv.second.seg];
      if (ekv.second.ts > st.first) st.first = ekv.second.ts;
      st.second++;
    }
  int64_t reclaimed = 0;
  for (auto& kv : seg_stat) {
    uint32_t seg = kv.first;
    if (seg == db.cur_seg || kv.second.first >= cutoff_ts) continue;
    if (seg >= pin_floor) continue;  // generation pinned by a cursor
    // a quarantined segment is preserved for forensics: its suffix's
    // timestamps are unknowable, so age-based reclaim never applies
    if (db.quarantined.count(seg)) continue;
    auto fdit = db.seg_fds.find(seg);
    if (fdit != db.seg_fds.end()) {
      if (fdit->second >= 0) close(fdit->second);
      db.seg_fds.erase(fdit);
    }
    unlink(seg_path(db, seg).c_str());
    for (auto& skv : db.index) {
      auto& m = skv.second;
      for (auto it = m.begin(); it != m.end();)
        it = it->second.seg == seg ? m.erase(it) : std::next(it);
    }
    reclaimed += kv.second.second;
  }
  return reclaimed;
}

int64_t dslog_gc(void* h, uint64_t cutoff_ts) {
  return dslog_gc2(h, cutoff_ts, UINT32_MAX);
}

// generation (= segment id) of the first record of `stream` strictly
// after cursor (ts, seq): the generation a resuming session's replay
// cursor pins.  -1 when the cursor is exhausted (nothing left to read,
// so nothing to pin).
int64_t dslog_seg_for(void* h, uint32_t stream, uint64_t ts,
                      uint64_t seq) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  auto sit = db.index.find(stream);
  if (sit == db.index.end()) return -1;
  auto mit = sit->second.upper_bound({ts, seq});
  if (mit == sit->second.end()) return -1;
  return (int64_t)mit->second.seg;
}

// the current generation (the segment new appends land in)
int64_t dslog_cur_seg(void* h) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  return (int64_t)db.cur_seg;
}

// estimated record count across quarantined suffixes (corruption the
// recovery detected and preserved instead of serving or destroying)
int64_t dslog_corrupt_records(void* h) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  return db.corrupt_records;
}

// number of segments carrying a quarantined suffix
int dslog_quarantined_count(void* h) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  return (int)db.quarantined.size();
}

// record count for a stream (for stats/tests)
int64_t dslog_stream_count(void* h, uint32_t stream) {
  Db& db = *static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db.mu);
  auto sit = db.index.find(stream);
  return sit == db.index.end() ? 0 : (int64_t)sit->second.size();
}

}  // extern "C"
