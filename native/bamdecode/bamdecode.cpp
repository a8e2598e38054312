// Native BAM decoder: BGZF -> records -> fragments -> packed columnar batches.
//
// Host-side equivalent of the reference's BAM2blocks stage (SURVEY.md §2 rows
// 7-8, historical src/irfinder/BAM2blocks.cpp [R] — the mounted snapshot is a
// tombstone, behavior reconstructed; the Python decoder
// irfinder_tpu/io/bampy.py is the executable conformance spec and
// tests/test_bamdecode.py asserts bit-identical batch streams).
//
// Design (SURVEY.md §7.3 item 3 — decode must not bottleneck the device):
//   * the file is mmap'd; a pre-scan walks BGZF headers only (18 bytes per
//     ~64KiB block) collecting (offset, csize, isize) per block;
//   * a pool of worker threads inflates blocks independently (BGZF blocks are
//     self-contained raw-deflate members) into an ordered slot ring;
//   * the caller-driven parser consumes slots in order, reassembling records
//     that straddle block boundaries in a rolling buffer, applies the
//     admission filter, walks CIGARs into aligned blocks + splice gaps,
//     pairs mates by read-name adjacency, and emits fixed-capacity columnar
//     batches (the PackedBatch layout of irfinder_tpu/io/batch.py).
//
// C ABI only (no pybind11 in this image); Python binds via ctypes
// (irfinder_tpu/native/bamdecode.py). Batch pointers stay valid until the
// next bd_next_batch() call on the same handle.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <chrono>

#include <fcntl.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#ifdef HAVE_LIBDEFLATE
// libdeflate's raw-deflate decompressor is ~3.2x zlib on BGZF members
// (measured 314 -> 1011 MB/s single-thread on the realistic-mix bench BAM);
// the Makefile enables it when <libdeflate.h> is present, zlib otherwise.
#include <libdeflate.h>
#endif

namespace {

// One raw-deflate member -> out buffer.  Returns inflated byte count, or -1.
#ifdef HAVE_LIBDEFLATE
struct Inflater {
  libdeflate_decompressor* d;
  Inflater() : d(libdeflate_alloc_decompressor()) {}
  ~Inflater() { libdeflate_free_decompressor(d); }
  int64_t run(const uint8_t* in, uint32_t in_n, uint8_t* out, uint32_t cap) {
    size_t got = 0;
    if (libdeflate_deflate_decompress(d, in, in_n, out, cap, &got) !=
        LIBDEFLATE_SUCCESS)
      return -1;
    return (int64_t)got;
  }
};
#else
struct Inflater {
  z_stream zs;
  Inflater() {
    memset(&zs, 0, sizeof(zs));
    inflateInit2(&zs, -15);
  }
  ~Inflater() { inflateEnd(&zs); }
  int64_t run(const uint8_t* in, uint32_t in_n, uint8_t* out, uint32_t cap) {
    inflateReset(&zs);
    zs.next_in = const_cast<uint8_t*>(in);
    zs.avail_in = in_n;
    zs.next_out = out;
    zs.avail_out = cap;
    if (inflate(&zs, Z_FINISH) != Z_STREAM_END) return -1;
    return (int64_t)zs.total_out;
  }
};
#endif

// ---- counting semantics DEFAULTS (mirror irfinder_tpu/semantics.py's
// defaults; the runtime values are INJECTED per-handle via bd_open_ex so a
// semantics override — golden pinning, env hook — never needs a rebuild) ----
constexpr int32_t kFlagDropMask = 0x4 | 0x100 | 0x800;
constexpr int32_t kMinMapq = 5;
constexpr int32_t kMinGapAsJunction = 0;

struct BlockDesc {
  uint64_t offset;  // file offset of the gzip member
  uint32_t csize;   // compressed payload size (raw deflate bytes)
  uint32_t isize;   // inflated size
  uint32_t data_off;  // offset of deflate data within the member
};

struct Slot {
  std::vector<uint8_t> data;
  uint32_t len = 0;
  std::atomic<int64_t> block = -1;  // which block index currently occupies it
};

constexpr int kSlots = 64;

// Streaming (pipe) mode: compressed-member ring fed by a reader thread.
// 256 members x <=64KiB compressed bounds memory at ~16MiB worst case.
constexpr int kCSlots = 256;

struct StreamBlock {
  std::vector<uint8_t> raw;  // full BGZF member bytes
  uint32_t csize = 0, isize = 0, data_off = 0;
};

// Bounded spin: yield briefly, then sleep — waiting sides of the pipe
// pipeline must not starve a slow producer on a small host.
inline void backoff(int& spins) {
  if (++spins < 64) {
    std::this_thread::yield();
  } else {
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

struct ParsedRead {
  std::string name;
  int32_t ref_id;
  int32_t strand;  // fragment-strand contribution
  std::vector<std::pair<int32_t, int32_t>> blocks;
  std::vector<std::pair<int32_t, int32_t>> gaps;
};

struct BatchBuf {
  std::vector<int32_t> blk_chrom, blk_start, blk_end, blk_strand;
  std::vector<int32_t> gap_chrom, gap_start, gap_end, gap_strand;
  std::vector<int32_t> frag_chrom, frag_refid, frag_start, frag_end, frag_strand;
  std::vector<int32_t> frag_nblk;  // blocks emitted for this frag row
  int64_t n_blocks = 0, n_gaps = 0, n_frags = 0, n_reads = 0;
  int64_t cap_blocks = 0, cap_gaps = 0, cap_frags = 0;

  void init(int64_t cap, int64_t bpf, int64_t gpf) {
    cap_frags = cap;
    // io/batch.py BLOCKS_PER_FRAG / GAPS_PER_FRAG (or the LONGREAD_*
    // geometry via bd_open_ex2), floored at MIN_CAP_UNITS so one fragment
    // (even a long-read spliced alignment) always fits
    cap_blocks = std::max<int64_t>(cap * bpf, 4096);
    cap_gaps = std::max<int64_t>(cap * gpf, 4096);
    blk_chrom.assign(cap_blocks, -1);
    blk_start.assign(cap_blocks, 0);
    blk_end.assign(cap_blocks, 0);
    blk_strand.assign(cap_blocks, 0);
    gap_chrom.assign(cap_gaps, -1);
    gap_start.assign(cap_gaps, 0);
    gap_end.assign(cap_gaps, 0);
    gap_strand.assign(cap_gaps, 0);
    frag_chrom.assign(cap_frags, -1);
    frag_refid.assign(cap_frags, -1);
    frag_start.assign(cap_frags, 0);
    frag_end.assign(cap_frags, 0);
    frag_strand.assign(cap_frags, 0);
    frag_nblk.assign(cap_frags, 0);
    n_blocks = n_gaps = n_frags = n_reads = 0;
  }
  void reset() {
    std::fill(blk_chrom.begin(), blk_chrom.begin() + n_blocks, -1);
    std::fill(gap_chrom.begin(), gap_chrom.begin() + n_gaps, -1);
    std::fill(frag_chrom.begin(), frag_chrom.begin() + n_frags, -1);
    std::fill(frag_refid.begin(), frag_refid.begin() + n_frags, -1);
    std::fill(frag_nblk.begin(), frag_nblk.begin() + n_frags, 0);
    n_blocks = n_gaps = n_frags = n_reads = 0;
  }
  bool would_overflow(int64_t nb, int64_t ng, int64_t nf) const {
    return n_blocks + nb > cap_blocks || n_gaps + ng > cap_gaps ||
           n_frags + nf > cap_frags;
  }
};

struct Stats {
  int64_t reads_total = 0, reads_admitted = 0, fragments = 0, pairs = 0,
          singles = 0, blocks_inflated = 0;
};

class Decoder {
 public:
  std::string error;

  bool open(const char* path, int64_t cap_frags, int n_threads,
            int32_t drop_mask, int32_t min_mapq, int32_t min_gap,
            const uint8_t* token, int64_t token_len,
            int64_t blocks_per_frag = 3, int64_t gaps_per_frag = 1) {
    drop_mask_ = drop_mask;
    min_mapq_ = min_mapq;
    min_gap_ = min_gap;
    fd_ = ::open(path, O_RDONLY);
    if (fd_ < 0) return fail("cannot open file");
    struct stat st;
    if (fstat(fd_, &st) != 0) return fail("fstat failed");
    fsize_ = st.st_size;
    map_ = static_cast<const uint8_t*>(
        mmap(nullptr, fsize_, PROT_READ, MAP_PRIVATE, fd_, 0));
    if (map_ == MAP_FAILED) return fail("mmap failed");
    if (!scan_blocks()) return false;
    for (auto& s : slots_) s.data.resize(1 << 16);
    cur_.init(cap_frags, blocks_per_frag, gaps_per_frag);
    // header parse runs in synchronous mode (ensure() inflates inline while
    // workers_ is empty) so a resume can reposition the pipeline BEFORE any
    // worker starts racing ahead of the target block
    if (!parse_header()) return false;
    if (token && token_len > 0) {
      if (!restore_token(token, token_len)) return false;
    }
    n_threads = std::max(1, n_threads);
    next_block_.store(next_consume_);
    consumed_.store(next_consume_);
    stop_.store(false);
    for (int i = 0; i < n_threads; i++)
      workers_.emplace_back([this] { worker(); });
    return true;
  }

  // Streaming (pipe/fd) mode (SURVEY.md §3.2 FIFO chain — the reference's
  // counter reads the aligner's SAM/BAM stream directly; this is this
  // build's equivalent so FastQ --stream rides the SAME multithreaded
  // inflate/parse pipeline as the file path): a reader thread pulls BGZF
  // members off the fd into a bounded compressed ring; the worker pool
  // inflates from the ring.  No mmap, no pre-scan, memory O(kCSlots*64KiB).
  // Resume tokens are emitted (format-shared) but cannot reposition a pipe.
  bool open_fd(int fd, int64_t cap_frags, int n_threads, int32_t drop_mask,
               int32_t min_mapq, int32_t min_gap, int64_t blocks_per_frag,
               int64_t gaps_per_frag, int tee_fd) {
    drop_mask_ = drop_mask;
    min_mapq_ = min_mapq;
    min_gap_ = min_gap;
    streaming_ = true;
    fd_ = dup(fd);  // own our copy; caller's fd lifecycle stays theirs
    if (fd_ < 0) return fail("cannot dup stream fd");
    tee_fd_ = tee_fd;
    for (auto& s : slots_) s.data.resize(1 << 16);
    cur_.init(cap_frags, blocks_per_frag, gaps_per_frag);
    stop_.store(false);
    next_block_.store(0);
    consumed_.store(0);
    reader_ = std::thread([this] { reader(); });
    n_threads = std::max(1, n_threads);
    for (int i = 0; i < n_threads; i++)
      workers_.emplace_back([this] { worker(); });
    if (!parse_header()) return false;
    return true;
  }

  // Logical (inflated-stream) offset of the parse cursor.
  int64_t tell() const { return appended_ - (int64_t)(buf_.size() - pos_); }

  std::vector<uint8_t> token() const { return make_token(); }

  ~Decoder() {
    stop_.store(true);
    if (reader_.joinable()) reader_.join();
    for (auto& t : workers_) t.join();
    if (map_ && map_ != MAP_FAILED) munmap(const_cast<uint8_t*>(map_), fsize_);
    if (fd_ >= 0) ::close(fd_);
  }

  void set_lut(const int32_t* lut, int64_t n) { lut_.assign(lut, lut + n); }

  int n_refs() const { return (int)ref_names_.size(); }
  const std::string& ref_name(int i) const { return ref_names_[i]; }
  int64_t ref_len(int i) const { return ref_lens_[i]; }

  // Returns 1 when a batch is produced (view valid until next call), 0 at
  // clean EOF with an empty batch, <0 on error.
  int next_batch(BatchBuf** out) {
    cur_.reset();
    while (true) {
      if (have_pending_flush_) {
        // fragment carried over because the previous batch was full
        have_pending_flush_ = false;
        emit_fragment(carry_frag_);
        carry_frag_.clear();
      }
      ParsedRead rd;
      int r = next_admitted_read(&rd);
      if (r < 0) return -1;
      if (r == 0) {  // EOF: flush pending mate + finish
        if (pending_valid_) {
          std::vector<ParsedRead> frag{std::move(pending_)};
          pending_valid_ = false;
          stats_.fragments++;
          stats_.singles++;
          if (!try_emit(frag)) {  // full: carry to next batch
            *out = &cur_;
            return 1;
          }
        }
        eof_reached_ = true;
        *out = &cur_;
        return cur_.n_frags > 0 ? 1 : 0;
      }
      // name-adjacency pairing (bampy FragmentAssembler semantics)
      std::vector<ParsedRead> frag;
      if (pending_valid_ && pending_.name == rd.name) {
        frag.push_back(std::move(pending_));
        frag.push_back(std::move(rd));
        pending_valid_ = false;
        stats_.fragments++;
        stats_.pairs++;
      } else {
        if (pending_valid_) {
          frag.push_back(std::move(pending_));
          stats_.fragments++;
          stats_.singles++;
        }
        pending_ = std::move(rd);
        pending_valid_ = true;
      }
      if (!frag.empty() && !try_emit(frag)) {
        *out = &cur_;
        return 1;
      }
    }
  }

  bool at_eof() const { return eof_reached_; }
  const Stats& stats() const { return stats_; }

 private:
  bool fail(const char* msg) {
    error = msg;
    return false;
  }

  // ---- BGZF layer ---------------------------------------------------------
  bool scan_blocks() {
    uint64_t off = 0;
    while (off + 18 <= (uint64_t)fsize_) {
      const uint8_t* p = map_ + off;
      if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4))
        return fail("not a BGZF block (bad gzip magic)");
      uint16_t xlen;
      memcpy(&xlen, p + 10, 2);
      uint32_t bsize = 0;
      uint32_t xo = 12;
      bool found = false;
      while (xo + 4 <= 12u + xlen) {
        uint8_t si1 = p[xo], si2 = p[xo + 1];
        uint16_t slen;
        memcpy(&slen, p + xo + 2, 2);
        if (si1 == 66 && si2 == 67 && slen == 2) {
          uint16_t b;
          memcpy(&b, p + xo + 4, 2);
          bsize = (uint32_t)b + 1;
          found = true;
        }
        xo += 4 + slen;
      }
      if (!found) return fail("BGZF BC subfield missing");
      uint32_t data_off = 12 + xlen;
      if (off + bsize > (uint64_t)fsize_) return fail("truncated BGZF block");
      uint32_t csize = bsize - data_off - 8;
      uint32_t isize;
      memcpy(&isize, map_ + off + bsize - 4, 4);
      if (isize > (1u << 16)) return fail("BGZF block isize > 64KiB");
      blocks_.push_back({off, csize, isize, data_off});
      off += bsize;
    }
    if (off != (uint64_t)fsize_ && fsize_ != 0)
      return fail("trailing garbage after last BGZF block");
    return true;
  }

  void worker() {
    Inflater inf;
    while (!stop_.load(std::memory_order_relaxed)) {
      int64_t i = next_block_.fetch_add(1);
      if (streaming_) {
        // wait for the reader to have scanned member i (or stream EOF)
        int spins = 0;
        while (scanned_.load(std::memory_order_acquire) <= i) {
          if (stream_eof_.load(std::memory_order_acquire) &&
              scanned_.load(std::memory_order_acquire) <= i)
            return;
          if (stop_.load(std::memory_order_relaxed)) return;
          backoff(spins);
        }
      } else if (i >= (int64_t)blocks_.size()) {
        break;
      }
      Slot& s = slots_[i % kSlots];
      // wait until the consumer has freed this slot (consumed block i-kSlots)
      int spins = 0;
      while (consumed_.load(std::memory_order_acquire) < i - kSlots + 1) {
        if (stop_.load(std::memory_order_relaxed)) return;
        backoff(spins);
      }
      if (streaming_) {
        const StreamBlock& b = sblocks_[i % kCSlots];
        int64_t got = inf.run(b.raw.data() + b.data_off, b.csize,
                              s.data.data(), (uint32_t)s.data.size());
        if (got != (int64_t)b.isize) {
          bad_block_.store(i, std::memory_order_release);
        }
        s.len = b.isize;
        s.block.store(i, std::memory_order_release);
      } else {
        const BlockDesc& b = blocks_[i];
        int64_t got = inf.run(map_ + b.offset + b.data_off, b.csize,
                              s.data.data(), (uint32_t)s.data.size());
        if (got != (int64_t)b.isize) {
          bad_block_.store(i, std::memory_order_release);
        }
        s.len = b.isize;
        s.block.store(i, std::memory_order_release);
      }
    }
  }

  // ---- streaming reader ----------------------------------------------------
  // Fill `n` bytes from fd_ (poll-loop so destruction can interrupt a wait on
  // a silent producer).  Returns n, 0 on clean EOF at a member boundary
  // (got==0), -1 on error / short read.
  int64_t read_full(uint8_t* dst, int64_t n) {
    int64_t got = 0;
    while (got < n) {
      if (stop_.load(std::memory_order_relaxed)) return -1;
      struct pollfd p {fd_, POLLIN, 0};
      int pr = poll(&p, 1, 200);
      if (pr < 0) return -1;
      if (pr == 0) continue;  // timeout: re-check stop_
      ssize_t r = ::read(fd_, dst + got, (size_t)(n - got));
      if (r < 0) return -1;
      if (r == 0) return got == 0 ? 0 : -1;  // EOF
      if (tee_fd_ >= 0) {
        // pass-through spool (--keep-bam --stream): a failed write must
        // FAIL the run — a silently truncated Unsorted.bam is corrupt
        // output the user has no signal about (disk full, closed sink)
        int64_t w = 0;
        while (w < r) {
          ssize_t ww = ::write(tee_fd_, dst + got + w, (size_t)(r - w));
          if (ww <= 0) {
            tee_fd_ = -1;
            tee_failed_.store(true, std::memory_order_release);
            return -1;
          }
          w += ww;
        }
      }
      got += r;
    }
    return got;
  }

  // One BGZF member -> ring slot.  1 = ok, 0 = clean EOF, -1 = corrupt.
  int read_member(StreamBlock& sb) {
    sb.raw.resize(1 << 16);
    int64_t r = read_full(sb.raw.data(), 12);
    if (r <= 0) return (int)r;
    const uint8_t* p = sb.raw.data();
    if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4)) return -1;
    uint16_t xlen;
    memcpy(&xlen, p + 10, 2);
    // a valid BGZF member is <= 64KiB total; a corrupt xlen claiming more
    // would otherwise overflow the fixed ring buffer below
    if (12u + xlen + 8u > sb.raw.size()) return -1;
    if (read_full(sb.raw.data() + 12, xlen) != xlen) return -1;
    uint32_t bsize = 0, xo = 12;
    while (xo + 4 <= 12u + xlen) {
      uint8_t si1 = p[xo], si2 = p[xo + 1];
      uint16_t slen;
      memcpy(&slen, p + xo + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t b;
        memcpy(&b, p + xo + 4, 2);
        bsize = (uint32_t)b + 1;
      }
      xo += 4 + slen;
    }
    if (bsize == 0 || bsize > (1u << 16) || bsize < 12u + xlen + 8u) return -1;
    sb.data_off = 12 + xlen;
    int64_t rest = (int64_t)bsize - sb.data_off;
    if (read_full(sb.raw.data() + sb.data_off, rest) != rest) return -1;
    sb.csize = bsize - sb.data_off - 8;
    memcpy(&sb.isize, sb.raw.data() + bsize - 4, 4);
    if (sb.isize > (1u << 16)) return -1;
    return 1;
  }

  void reader() {
    int64_t i = 0;
    while (!stop_.load(std::memory_order_relaxed)) {
      StreamBlock& sb = sblocks_[i % kCSlots];
      // wait until the consumer has drained member i-kCSlots
      int spins = 0;
      while (consumed_.load(std::memory_order_acquire) < i - kCSlots + 1) {
        if (stop_.load(std::memory_order_relaxed)) return;
        backoff(spins);
      }
      int rc = read_member(sb);
      if (rc <= 0) {
        if (rc < 0) stream_bad_.store(true, std::memory_order_release);
        stream_eof_.store(true, std::memory_order_release);
        return;
      }
      scanned_.store(i + 1, std::memory_order_release);
      i++;
    }
  }

  // Pull inflated payload of block `i` (blocking until the worker finishes).
  const uint8_t* block_payload(int64_t i, uint32_t* len) {
    Slot& s = slots_[i % kSlots];
    int spins = 0;
    while (s.block.load(std::memory_order_acquire) != i)
      backoff(spins);
    if (bad_block_.load(std::memory_order_acquire) == i) return nullptr;
    *len = s.len;
    return s.data.data();
  }

  // ---- rolling logical byte stream ---------------------------------------
  // ensure(n): at least n bytes available at buf_[pos_..]; false at EOF.
  // While workers_ is empty (header parse / resume repositioning) blocks are
  // inflated inline; afterwards they come from the worker slot ring.
  bool ensure(size_t n) {
    while (buf_.size() - pos_ < n) {
      if (streaming_) {
        // wait for the reader to produce member next_consume_ (or EOF)
        int spins = 0;
        while (scanned_.load(std::memory_order_acquire) <= next_consume_) {
          if (stream_eof_.load(std::memory_order_acquire) &&
              scanned_.load(std::memory_order_acquire) <= next_consume_) {
            if (stream_bad_.load(std::memory_order_acquire)) {
              error = tee_failed_.load(std::memory_order_acquire)
                          ? "tee write failed (--keep-bam sink: disk full?)"
                          : "corrupt BGZF member in stream";
              io_error_ = true;
            }
            return false;
          }
          backoff(spins);
        }
      } else if (next_consume_ >= (int64_t)blocks_.size()) {
        return false;
      }
      if (pos_ > 0 && pos_ == buf_.size()) {
        buf_.clear();
        pos_ = 0;
      } else if (pos_ > (1 << 20)) {  // compact occasionally
        buf_.erase(buf_.begin(), buf_.begin() + pos_);
        pos_ = 0;
      }
      uint32_t len;
      const uint8_t* p;
      if (workers_.empty()) {
        p = inflate_sync(next_consume_, &len);
      } else {
        p = block_payload(next_consume_, &len);
      }
      if (!p) {
        error = "corrupt BGZF block";
        io_error_ = true;
        return false;
      }
      buf_.insert(buf_.end(), p, p + len);
      appended_ += len;
      stats_.blocks_inflated++;
      consumed_.store(++next_consume_, std::memory_order_release);
    }
    return true;
  }

  // Synchronous single-block inflate (header parse / resume, pre-workers).
  const uint8_t* inflate_sync(int64_t i, uint32_t* len) {
    const BlockDesc& b = blocks_[i];
    sync_buf_.resize(1 << 16);
    Inflater inf;
    int64_t got = inf.run(map_ + b.offset + b.data_off, b.csize,
                          sync_buf_.data(), (uint32_t)sync_buf_.size());
    if (got != (int64_t)b.isize) return nullptr;
    *len = b.isize;
    return sync_buf_.data();
  }

  // ---- resume token: (logical offset, pairing/carry state, stats) ---------
  // Format (little-endian): magic 'IRT1' u32 | tell u64 | stats i64[5] |
  // has_pending u8 | n_carry u8 | ParsedRead*  where ParsedRead =
  // name_len u32 | name | ref_id i32 | strand i32 | nb u32 | (s,e) i32 pairs
  // | ng u32 | (s,e) i32 pairs.  Shared byte-for-byte with the Python
  // decoder (io/bampy.py), so checkpoints are decoder-portable.
  static void put_read(std::vector<uint8_t>& out, const ParsedRead& r) {
    auto put = [&out](const void* p, size_t n) {
      const uint8_t* b = (const uint8_t*)p;
      out.insert(out.end(), b, b + n);
    };
    uint32_t nl = (uint32_t)r.name.size();
    put(&nl, 4);
    put(r.name.data(), nl);
    put(&r.ref_id, 4);
    put(&r.strand, 4);
    uint32_t nb = (uint32_t)r.blocks.size(), ng = (uint32_t)r.gaps.size();
    put(&nb, 4);
    for (auto& p2 : r.blocks) { put(&p2.first, 4); put(&p2.second, 4); }
    put(&ng, 4);
    for (auto& p2 : r.gaps) { put(&p2.first, 4); put(&p2.second, 4); }
  }

  std::vector<uint8_t> make_token() const {
    std::vector<uint8_t> out;
    auto put = [&out](const void* p, size_t n) {
      const uint8_t* b = (const uint8_t*)p;
      out.insert(out.end(), b, b + n);
    };
    uint32_t magic = 0x31545249;  // 'IRT1'
    put(&magic, 4);
    int64_t t = tell();
    put(&t, 8);
    int64_t st[5] = {stats_.reads_total, stats_.reads_admitted,
                     stats_.fragments, stats_.pairs, stats_.singles};
    put(st, 40);
    uint8_t hp = pending_valid_ ? 1 : 0;
    uint8_t nc = have_pending_flush_ ? (uint8_t)carry_frag_.size() : 0;
    put(&hp, 1);
    put(&nc, 1);
    if (hp) put_read(out, pending_);
    for (uint8_t i = 0; i < nc; i++) put_read(out, carry_frag_[i]);
    return out;
  }

  bool restore_token(const uint8_t* tok, int64_t len) {
    int64_t off = 0;
    auto get = [&](void* p, size_t n) -> bool {
      if (off + (int64_t)n > len) return false;
      memcpy(p, tok + off, n);
      off += n;
      return true;
    };
    auto get_read = [&](ParsedRead* r) -> bool {
      uint32_t nl;
      if (!get(&nl, 4) || off + nl > len) return false;
      r->name.assign((const char*)tok + off, nl);
      off += nl;
      uint32_t nb, ng;
      if (!get(&r->ref_id, 4) || !get(&r->strand, 4) || !get(&nb, 4))
        return false;
      r->blocks.resize(nb);
      for (auto& p : r->blocks)
        if (!get(&p.first, 4) || !get(&p.second, 4)) return false;
      if (!get(&ng, 4)) return false;
      r->gaps.resize(ng);
      for (auto& p : r->gaps)
        if (!get(&p.first, 4) || !get(&p.second, 4)) return false;
      return true;
    };
    uint32_t magic;
    int64_t target, st[5];
    uint8_t hp, nc;
    if (!get(&magic, 4) || magic != 0x31545249)
      return fail("bad resume token (magic)");
    if (!get(&target, 8) || !get(st, 40) || !get(&hp, 1) || !get(&nc, 1))
      return fail("bad resume token (truncated)");
    if (hp && !get_read(&pending_)) return fail("bad resume token (pending)");
    pending_valid_ = hp != 0;
    carry_frag_.clear();
    for (uint8_t i = 0; i < nc; i++) {
      ParsedRead r;
      if (!get_read(&r)) return fail("bad resume token (carry)");
      carry_frag_.push_back(std::move(r));
    }
    have_pending_flush_ = nc > 0;
    stats_.reads_total = st[0];
    stats_.reads_admitted = st[1];
    stats_.fragments = st[2];
    stats_.pairs = st[3];
    stats_.singles = st[4];
    // reposition: find the block containing `target` by cumulative isize
    // (no inflation), reset the rolling buffer there — resume cost is
    // O(#blocks) header arithmetic, independent of position in the BAM
    int64_t cum = 0;
    size_t b = 0;
    while (b < blocks_.size() && cum + blocks_[b].isize <= target)
      cum += blocks_[b++].isize;
    if (b >= blocks_.size() && target != cum)
      return fail("resume offset beyond end of BAM");
    buf_.clear();
    pos_ = 0;
    next_consume_ = (int64_t)b;
    appended_ = cum;
    int64_t intra = target - cum;
    if (intra > 0) {
      if (!ensure((size_t)intra)) return fail("resume offset inside missing block");
      pos_ = (size_t)intra;
    }
    return true;
  }

  template <typename T>
  T get() {
    T v;
    memcpy(&v, buf_.data() + pos_, sizeof(T));
    pos_ += sizeof(T);
    return v;
  }

  bool parse_header() {
    if (!ensure(8)) return fail("truncated BAM header");
    if (memcmp(buf_.data() + pos_, "BAM\x01", 4) != 0)
      return fail("missing BAM magic");
    pos_ += 4;
    int32_t l_text = get<int32_t>();
    if (!ensure(l_text + 4)) return fail("truncated BAM header text");
    pos_ += l_text;
    int32_t n_ref = get<int32_t>();
    for (int i = 0; i < n_ref; i++) {
      if (!ensure(4)) return fail("truncated BAM ref list");
      int32_t l_name = get<int32_t>();
      if (!ensure((size_t)l_name + 4)) return fail("truncated BAM ref name");
      ref_names_.emplace_back((const char*)buf_.data() + pos_, l_name - 1);
      pos_ += l_name;
      ref_lens_.push_back(get<int32_t>());
    }
    return true;
  }

  // 1 = read parsed, 0 = EOF, -1 = error
  int next_admitted_read(ParsedRead* out) {
    while (true) {
      if (!ensure(4)) return io_error_ ? -1 : 0;
      int32_t block_size = get<int32_t>();
      if (block_size < 32) {
        error = "corrupt BAM record (block_size < 32)";
        return -1;
      }
      if (!ensure((size_t)block_size)) {
        error = io_error_ ? error : "truncated BAM record";
        return -1;
      }
      size_t body_end = pos_ + block_size;
      int32_t ref_id = get<int32_t>();
      int32_t posn = get<int32_t>();
      uint8_t l_read_name = get<uint8_t>();
      uint8_t mapq = get<uint8_t>();
      pos_ += 2;  // bin
      uint16_t n_cigar = get<uint16_t>();
      uint16_t flag = get<uint16_t>();
      pos_ += 16;  // l_seq, next_ref, next_pos, tlen
      stats_.reads_total++;
      if ((flag & drop_mask_) || mapq < min_mapq_ || ref_id < 0 ||
          n_cigar == 0) {
        pos_ = body_end;
        continue;
      }
      out->name.assign((const char*)buf_.data() + pos_, l_read_name - 1);
      pos_ += l_read_name;
      out->ref_id = ref_id;
      out->blocks.clear();
      out->gaps.clear();
      int32_t cur = posn, blk_start = posn;
      bool open_block = false;
      for (int c = 0; c < n_cigar; c++) {
        uint32_t cig = get<uint32_t>();
        uint32_t op = cig & 0xF, ln = cig >> 4;
        bool is_gap = (op == 3);                           // N
        bool consumes = (op == 0 || op == 2 || op == 7 || op == 8);  // M D = X
        if (is_gap && (int32_t)ln >= min_gap_) {
          if (open_block) {
            out->blocks.emplace_back(blk_start, cur);
            open_block = false;
          }
          out->gaps.emplace_back(cur, cur + (int32_t)ln);
          cur += ln;
          blk_start = cur;
        } else if (consumes) {
          if (!open_block) {
            blk_start = cur;
            open_block = true;
          }
          cur += ln;
        }
      }
      if (open_block) out->blocks.emplace_back(blk_start, cur);
      int read_rev = (flag & 0x10) ? 1 : 0;
      out->strand =
          (!(flag & 0x1) || (flag & 0x40)) ? read_rev : 1 - read_rev;
      pos_ = body_end;
      stats_.reads_admitted++;
      return 1;
    }
  }

  // ---- batch emission -----------------------------------------------------
  // Returns false when the current batch was full: the fragment is stashed
  // and the caller must return the (now complete) batch.
  bool try_emit(std::vector<ParsedRead>& frag) {
    int64_t nb = 0, ng = 0;
    // group mates by ref_id in first-seen order (bampy dict semantics)
    int nf = (frag.size() == 2 && frag[0].ref_id != frag[1].ref_id) ? 2 : 1;
    for (auto& r : frag) {
      nb += (int64_t)r.blocks.size();
      ng += (int64_t)r.gaps.size();
    }
    if (cur_.would_overflow(nb, ng, nf)) {
      if (cur_.n_frags == 0) {
        // an empty batch cannot hold this fragment: corrupt/absurd CIGAR.
        // Drop it (do NOT write past the fixed buffers) and surface an error.
        error = "fragment exceeds batch capacity (corrupt CIGAR?)";
        frag.clear();
        return true;
      }
      carry_frag_ = std::move(frag);
      have_pending_flush_ = true;
      return false;
    }
    emit_fragment(frag);
    return true;
  }

  void emit_fragment(std::vector<ParsedRead>& frag) {
    // first-seen-order refid groups (<=2 mates)
    int32_t rids[2];
    int n_groups = 0;
    for (auto& r : frag) {
      bool seen = false;
      for (int g = 0; g < n_groups; g++) seen |= (rids[g] == r.ref_id);
      if (!seen) rids[n_groups++] = r.ref_id;
    }
    for (int g = 0; g < n_groups; g++) {
      int32_t rid = rids[g];
      int32_t chrom =
          (rid >= 0 && rid < (int32_t)lut_.size()) ? lut_[rid] : -1;
      int32_t strand = -1;
      int64_t span_lo = -1, span_hi = -1;
      int32_t nblk = 0;
      for (auto& r : frag) {
        if (r.ref_id != rid) continue;
        if (strand < 0) strand = r.strand;
        for (auto& b : r.blocks) {
          nblk++;
          int64_t i = cur_.n_blocks++;
          cur_.blk_chrom[i] = chrom;
          cur_.blk_start[i] = b.first;
          cur_.blk_end[i] = b.second;
          cur_.blk_strand[i] = strand;
          span_lo = span_lo < 0 ? b.first : std::min(span_lo, (int64_t)b.first);
          span_hi = std::max(span_hi, (int64_t)b.second);
        }
        for (auto& gp : r.gaps) {
          int64_t i = cur_.n_gaps++;
          cur_.gap_chrom[i] = chrom;
          cur_.gap_start[i] = gp.first;
          cur_.gap_end[i] = gp.second;
          cur_.gap_strand[i] = strand;
        }
      }
      int64_t i = cur_.n_frags++;
      cur_.frag_chrom[i] = chrom;
      cur_.frag_refid[i] = rid;
      cur_.frag_start[i] = span_lo < 0 ? 0 : (int32_t)span_lo;
      cur_.frag_end[i] = span_hi < 0 ? 0 : (int32_t)span_hi;
      cur_.frag_strand[i] = strand < 0 ? 0 : strand;
      cur_.frag_nblk[i] = nblk;
    }
    cur_.n_reads += (int64_t)frag.size();
  }

  int fd_ = -1;
  int64_t fsize_ = 0;
  const uint8_t* map_ = nullptr;
  std::vector<BlockDesc> blocks_;
  Slot slots_[kSlots];
  std::vector<std::thread> workers_;
  std::atomic<int64_t> next_block_{0};
  std::atomic<int64_t> consumed_{0};
  std::atomic<int64_t> bad_block_{-1};
  std::atomic<bool> stop_{false};
  int64_t next_consume_ = 0;
  bool io_error_ = false;

  // streaming mode state
  bool streaming_ = false;
  int tee_fd_ = -1;
  std::thread reader_;
  StreamBlock sblocks_[kCSlots];
  std::atomic<int64_t> scanned_{0};
  std::atomic<bool> stream_eof_{false};
  std::atomic<bool> stream_bad_{false};
  std::atomic<bool> tee_failed_{false};

  std::vector<uint8_t> buf_;
  std::vector<uint8_t> sync_buf_;
  size_t pos_ = 0;
  int64_t appended_ = 0;  // total inflated bytes ever appended to buf_
  int32_t drop_mask_ = kFlagDropMask;
  int32_t min_mapq_ = kMinMapq;
  int32_t min_gap_ = kMinGapAsJunction;
  std::vector<std::string> ref_names_;
  std::vector<int64_t> ref_lens_;
  std::vector<int32_t> lut_;

  ParsedRead pending_;
  bool pending_valid_ = false;
  std::vector<ParsedRead> carry_frag_;
  bool have_pending_flush_ = false;
  bool eof_reached_ = false;

  BatchBuf cur_;
  Stats stats_;
};

}  // namespace

// ---- C ABI -----------------------------------------------------------------
extern "C" {

typedef struct {
  int32_t *blk_chrom, *blk_start, *blk_end, *blk_strand;
  int32_t *gap_chrom, *gap_start, *gap_end, *gap_strand;
  int32_t *frag_chrom, *frag_refid, *frag_start, *frag_end, *frag_strand;
  int32_t *frag_nblk;
  int64_t n_blocks, n_gaps, n_frags, n_reads;
  int64_t cap_blocks, cap_gaps, cap_frags;
} BdBatchView;

// bd_open_ex2: bd_open_ex plus explicit batch geometry (blocks/gaps column
// capacity as multiples of cap_frags — io/batch.py BLOCKS_PER_FRAG or the
// LONGREAD_* geometry for many-block single-end alignments)
void* bd_open_ex2(const char* path, int64_t cap_frags, int n_threads,
                  int32_t flag_drop_mask, int32_t min_mapq, int32_t min_gap,
                  const uint8_t* token, int64_t token_len,
                  int64_t blocks_per_frag, int64_t gaps_per_frag) {
  auto* d = new Decoder();
  if (!d->open(path, cap_frags, n_threads, flag_drop_mask, min_mapq, min_gap,
               token, token_len, blocks_per_frag, gaps_per_frag)) {
    // keep handle so the error is retrievable; caller must bd_close
  }
  return d;
}

void* bd_open_ex(const char* path, int64_t cap_frags, int n_threads,
                 int32_t flag_drop_mask, int32_t min_mapq, int32_t min_gap,
                 const uint8_t* token, int64_t token_len) {
  return bd_open_ex2(path, cap_frags, n_threads, flag_drop_mask, min_mapq,
                     min_gap, token, token_len, 3, 1);
}

void* bd_open(const char* path, int64_t cap_frags, int n_threads) {
  return bd_open_ex(path, cap_frags, n_threads, kFlagDropMask, kMinMapq,
                    kMinGapAsJunction, nullptr, 0);
}

// Streaming (pipe) mode: count straight off an fd carrying a BGZF BAM stream
// (the aligner's stdout in FastQ --stream).  The fd is dup()ed — the caller
// keeps ownership of its descriptor.  tee_fd >= 0 spools the raw stream
// (--keep-bam) as it is read.  Resume is not supported on pipes.
void* bd_open_fd(int fd, int64_t cap_frags, int n_threads,
                 int32_t flag_drop_mask, int32_t min_mapq, int32_t min_gap,
                 int64_t blocks_per_frag, int64_t gaps_per_frag, int tee_fd) {
  auto* d = new Decoder();
  if (!d->open_fd(fd, cap_frags, n_threads, flag_drop_mask, min_mapq, min_gap,
                  blocks_per_frag, gaps_per_frag, tee_fd)) {
    // keep handle so the error is retrievable; caller must bd_close
  }
  return d;
}

// Serialize the resume token for the CURRENT position (call between
// bd_next_batch calls).  Returns bytes written, or the required size when
// buflen is too small; pass buflen=0 to size the buffer.
int64_t bd_token(void* h, uint8_t* buf, int64_t buflen) {
  auto tok = static_cast<Decoder*>(h)->token();
  if ((int64_t)tok.size() <= buflen && buf) memcpy(buf, tok.data(), tok.size());
  return (int64_t)tok.size();
}

const char* bd_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

int bd_n_refs(void* h) { return static_cast<Decoder*>(h)->n_refs(); }

int bd_ref_name(void* h, int i, char* buf, int buflen) {
  const std::string& s = static_cast<Decoder*>(h)->ref_name(i);
  int n = (int)s.size();
  if (n + 1 > buflen) return -1;
  memcpy(buf, s.c_str(), n + 1);
  return n;
}

int64_t bd_ref_len(void* h, int i) {
  return static_cast<Decoder*>(h)->ref_len(i);
}

void bd_set_chrom_lut(void* h, const int32_t* lut, int64_t n) {
  static_cast<Decoder*>(h)->set_lut(lut, n);
}

int bd_next_batch(void* h, BdBatchView* out) {
  auto* d = static_cast<Decoder*>(h);
  if (!d->error.empty()) return -1;
  BatchBuf* b = nullptr;
  int rc = d->next_batch(&b);
  if (rc <= 0) return rc;
  out->blk_chrom = b->blk_chrom.data();
  out->blk_start = b->blk_start.data();
  out->blk_end = b->blk_end.data();
  out->blk_strand = b->blk_strand.data();
  out->gap_chrom = b->gap_chrom.data();
  out->gap_start = b->gap_start.data();
  out->gap_end = b->gap_end.data();
  out->gap_strand = b->gap_strand.data();
  out->frag_chrom = b->frag_chrom.data();
  out->frag_refid = b->frag_refid.data();
  out->frag_start = b->frag_start.data();
  out->frag_end = b->frag_end.data();
  out->frag_strand = b->frag_strand.data();
  out->frag_nblk = b->frag_nblk.data();
  out->n_blocks = b->n_blocks;
  out->n_gaps = b->n_gaps;
  out->n_frags = b->n_frags;
  out->n_reads = b->n_reads;
  out->cap_blocks = b->cap_blocks;
  out->cap_gaps = b->cap_gaps;
  out->cap_frags = b->cap_frags;
  return 1;
}

void bd_stats(void* h, int64_t* out6) {
  const Stats& s = static_cast<Decoder*>(h)->stats();
  out6[0] = s.reads_total;
  out6[1] = s.reads_admitted;
  out6[2] = s.fragments;
  out6[3] = s.pairs;
  out6[4] = s.singles;
  out6[5] = s.blocks_inflated;
}

// Semantics constants baked into this binary, for drift checks from Python.
void bd_semantics(int32_t* out3) {
  out3[0] = kFlagDropMask;
  out3[1] = kMinMapq;
  out3[2] = kMinGapAsJunction;
}

void bd_close(void* h) { delete static_cast<Decoder*>(h); }

}  // extern "C"
