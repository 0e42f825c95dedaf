// Shared internals of the native container core: ISO-BMFF parsing structs
// used by both mp4.cpp (mp4 concat/remux) and mkv.cpp (Matroska muxing of
// mp4-encoded video parts).  See mp4.cpp for the overall design notes.
#pragma once

#include <cstdint>
#include <cstdio>
#include <stdexcept>
#include <string>
#include <vector>

namespace reve {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

inline uint32_t rd32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
inline uint64_t rd64(const uint8_t* p) {
  return (uint64_t(rd32(p)) << 32) | rd32(p + 4);
}
inline void wr32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
inline void wr64(uint8_t* p, uint64_t v) {
  wr32(p, uint32_t(v >> 32)); wr32(p + 4, uint32_t(v));
}

struct File {
  FILE* f = nullptr;
  explicit File(const std::string& path, const char* mode) {
    f = std::fopen(path.c_str(), mode);
    if (!f) throw Error("cannot open " + path);
  }
  ~File() { if (f) std::fclose(f); }
  uint64_t size() {
    std::fseek(f, 0, SEEK_END);
    return uint64_t(std::ftell(f));
  }
  void read_at(uint64_t off, void* dst, size_t n) {
    if (std::fseek(f, long(off), SEEK_SET) != 0 ||
        std::fread(dst, 1, n, f) != n)
      throw Error("short read");
  }
  void write(const void* src, size_t n) {
    if (std::fwrite(src, 1, n, f) != n) throw Error("short write");
  }
  uint64_t tell() { return uint64_t(std::ftell(f)); }
  void write_at(uint64_t off, const void* src, size_t n) {
    uint64_t cur = tell();
    std::fseek(f, long(off), SEEK_SET);
    write(src, n);
    std::fseek(f, long(cur), SEEK_SET);
  }
};

// ISO-BMFF box writer
struct Buf {
  std::vector<uint8_t> d;
  void u8(uint8_t v) { d.push_back(v); }
  void u16(uint16_t v) { d.push_back(v >> 8); d.push_back(uint8_t(v)); }
  void u32(uint32_t v) { size_t o = d.size(); d.resize(o + 4); wr32(&d[o], v); }
  void u64(uint64_t v) { size_t o = d.size(); d.resize(o + 8); wr64(&d[o], v); }
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    d.insert(d.end(), b, b + n);
  }
  void raw(const std::vector<uint8_t>& v) { raw(v.data(), v.size()); }
  // open a box, returns patch position for its size
  size_t open(const char type[4]) {
    size_t at = d.size();
    u32(0);
    raw(type, 4);
    return at;
  }
  void close(size_t at) { wr32(&d[at], uint32_t(d.size() - at)); }
};

struct BoxRef {
  std::string type;
  uint64_t payload_off, payload_len, box_off, box_len;
};

std::vector<BoxRef> children(const uint8_t* data, uint64_t off, uint64_t end);
const BoxRef* find(const std::vector<BoxRef>& boxes, const std::string& type);

struct SttsEntry { uint32_t count, delta; };
struct CttsEntry { uint32_t count; int32_t offset; };
struct StscEntry { uint32_t first_chunk, samples_per_chunk, desc_id; };

struct Track {
  std::string handler;              // vide / soun / text / ...
  uint32_t track_id = 0;
  uint32_t timescale = 0;
  uint64_t duration = 0;            // media timescale units
  uint32_t width16 = 0, height16 = 0;  // 16.16 fixed from tkhd
  std::vector<uint8_t> stsd;        // full stsd box (with header)
  std::vector<SttsEntry> stts;
  std::vector<CttsEntry> ctts;
  bool has_stss = false;
  std::vector<uint32_t> stss;       // 1-based sync sample numbers
  std::vector<StscEntry> stsc;
  uint32_t fixed_sample_size = 0;   // stsz sample_size field
  std::vector<uint32_t> sample_sizes;  // empty if fixed_sample_size
  std::vector<uint64_t> chunk_offsets;
  // tref/chap references: track ids this track marks as CHAPTER tracks
  // (QuickTime chapter convention — a text track listed here is chapter
  // metadata, not a subtitle stream)
  std::vector<uint32_t> chap_refs;
  // raw trak box bytes (for verbatim copy of non-video tracks)
  std::vector<uint8_t> trak_raw;
  // offset of stco/co64 payload within trak_raw (for patching)
  uint64_t co_off_in_trak = 0;
  bool co_is_64 = false;
  uint32_t co_count = 0;

  uint32_t sample_count() const {
    if (!sample_sizes.empty()) return uint32_t(sample_sizes.size());
    uint32_t n = 0;
    for (auto& e : stts) n += e.count;
    return n;
  }
  uint32_t sample_size(uint32_t i) const {
    // bounds-checked: stsc may claim more samples than stsz holds in a
    // corrupt/crafted file — cross-table inconsistency must not read OOB
    if (fixed_sample_size) return fixed_sample_size;
    return i < sample_sizes.size() ? sample_sizes[i] : 0;
  }
  // samples in chunk c (0-based) via stsc expansion
  uint32_t samples_in_chunk(uint32_t c) const {
    uint32_t spc = 0;
    for (auto& e : stsc) {
      if (e.first_chunk <= c + 1) spc = e.samples_per_chunk;
      else break;
    }
    return spc;
  }
};

struct Movie {
  std::vector<uint8_t> mvhd;  // full box
  uint32_t movie_timescale = 0;
  uint64_t movie_duration = 0;
  std::vector<Track> tracks;
  std::vector<std::vector<uint8_t>> extra_moov_children;  // udta, meta...
};

// A crafted stts can claim ~2^32 samples (count fields are attacker
// controlled and sample_count() sums them) while the file is tiny; every
// sample-table expansion that allocates O(n) must clamp what it trusts to
// the file size — a real sample occupies at least a byte of mdat, so no
// legitimate file loses samples, and a lie now hits the existing
// stsc/stco-inconsistency errors instead of a multi-GB allocation.
inline uint32_t bounded_sample_count(const Track& t, uint64_t file_size) {
  uint32_t n = t.sample_count();
  return uint64_t(n) <= file_size ? n : uint32_t(file_size);
}

Movie parse_movie(File& f);
void copy_bytes(File& src, uint64_t off, uint64_t len, File& dst);
uint64_t chunk_length(const Track& t, uint32_t chunk_idx,
                      uint32_t first_sample);

}  // namespace reve
