// reve_core — native pipeline core: ISO-BMFF (MP4) demux/remux.
//
// Re-implements, natively and in-process, what the reference obtained from
// `ffmpeg -f concat ... -map 0:v -map 1:a? -map 1:s? -map_chapters 1 -c copy`
// (reve-shared/src/lib.rs:181-204): concatenate upscaled video segment files
// WITHOUT re-encoding, and carry the original file's audio / subtitle /
// chapter data into the output.
//
// Approach:
//   * Video parts (all written by this framework's encoder with identical
//     codec config): fully parse their sample tables (stts/ctts/stss/stsc/
//     stsz/stco), merge them, copy sample bytes into the new mdat, and emit
//     a fresh video trak that references part 0's stsd verbatim.
//   * Non-video tracks of the original (audio, subtitles): copy each trak
//     box byte-for-byte, then patch the chunk-offset entries (stco/co64) in
//     place to point at where we copied the chunk data in the new mdat.
//     This preserves edit lists, esds/codec config, language tags —
//     everything — with no codec knowledge.  Non-video chunks are laid out
//     FIRST in the new mdat so 32-bit stco entries stay valid.
//   * mvhd and udta (chapters live in udta) are copied from the original and
//     patched (duration, next-track-id), keeping the movie timescale so
//     copied edit lists remain correct.
//
// No external dependencies; C++17; exposed through the C ABI in api section
// at the bottom (ctypes-friendly).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "mp4_internal.h"

namespace reve {

// ---------------------------------------------------------------- utilities

// ------------------------------------------------------------------- parsing

// walk direct children of [off, end)
std::vector<BoxRef> children(const uint8_t* data, uint64_t off,
                                    uint64_t end) {
  std::vector<BoxRef> out;
  while (off + 8 <= end) {
    uint64_t size = rd32(data + off);
    std::string type(reinterpret_cast<const char*>(data + off + 4), 4);
    uint64_t hdr = 8;
    if (size == 1) {
      if (off + 16 > end) break;
      size = rd64(data + off + 8);
      hdr = 16;
    } else if (size == 0) {
      size = end - off;
    }
    // overflow-safe: a crafted 64-bit largesize can make off+size wrap
    if (size < hdr || size > end - off) break;
    out.push_back({type, off + hdr, size - hdr, off, size});
    off += size;
  }
  return out;
}

const BoxRef* find(const std::vector<BoxRef>& boxes,
                          const std::string& type) {
  for (auto& b : boxes) if (b.type == type) return &b;
  return nullptr;
}

static void parse_stbl(const uint8_t* data, const BoxRef& stbl, Track& t,
                       uint64_t trak_box_off) {
  auto cs = children(data, stbl.payload_off, stbl.payload_off + stbl.payload_len);
  for (auto& b : cs) {
    const uint8_t* p = data + b.payload_off;
    // Entry counts come from the file; clamp each to what the payload can
    // actually hold so corrupt/crafted tables (reachable via CLI concat and
    // the web service) cannot drive reads past the box.
    auto entries = [&](uint64_t count_off, uint64_t entry_size) -> uint32_t {
      if (b.payload_len < count_off + 4) return 0;
      uint64_t n = rd32(p + count_off);
      uint64_t cap = (b.payload_len - (count_off + 4)) / entry_size;
      return uint32_t(n > cap ? cap : n);
    };
    if (b.type == "stsd") {
      t.stsd.assign(data + b.box_off, data + b.box_off + b.box_len);
    } else if (b.type == "stts") {
      uint32_t n = entries(4, 8);
      for (uint32_t i = 0; i < n; i++)
        t.stts.push_back({rd32(p + 8 + i * 8), rd32(p + 12 + i * 8)});
    } else if (b.type == "ctts") {
      uint32_t n = entries(4, 8);
      for (uint32_t i = 0; i < n; i++)
        t.ctts.push_back({rd32(p + 8 + i * 8), int32_t(rd32(p + 12 + i * 8))});
    } else if (b.type == "stss") {
      t.has_stss = true;
      uint32_t n = entries(4, 4);
      for (uint32_t i = 0; i < n; i++) t.stss.push_back(rd32(p + 8 + i * 4));
    } else if (b.type == "stsc") {
      uint32_t n = entries(4, 12);
      for (uint32_t i = 0; i < n; i++)
        t.stsc.push_back({rd32(p + 8 + i * 12), rd32(p + 12 + i * 12),
                          rd32(p + 16 + i * 12)});
    } else if (b.type == "stsz") {
      if (b.payload_len < 12) continue;
      t.fixed_sample_size = rd32(p + 4);
      if (t.fixed_sample_size == 0) {
        uint32_t n = entries(8, 4);
        for (uint32_t i = 0; i < n; i++)
          t.sample_sizes.push_back(rd32(p + 12 + i * 4));
      }
    } else if (b.type == "stco") {
      uint32_t n = entries(4, 4);
      for (uint32_t i = 0; i < n; i++)
        t.chunk_offsets.push_back(rd32(p + 8 + i * 4));
      t.co_off_in_trak = b.payload_off - trak_box_off;
      t.co_is_64 = false;
      t.co_count = n;
    } else if (b.type == "co64") {
      uint32_t n = entries(4, 8);
      for (uint32_t i = 0; i < n; i++)
        t.chunk_offsets.push_back(rd64(p + 8 + i * 8));
      t.co_off_in_trak = b.payload_off - trak_box_off;
      t.co_is_64 = true;
      t.co_count = n;
    }
  }
}

static Track parse_trak(const uint8_t* data, const BoxRef& trak) {
  Track t;
  t.trak_raw.assign(data + trak.box_off, data + trak.box_off + trak.box_len);
  auto cs = children(data, trak.payload_off, trak.payload_off + trak.payload_len);
  if (auto* tkhd = find(cs, "tkhd")) {
    // min payloads: v0 = 84 bytes, v1 = 96 (ver/flags, times, id, ...)
    const uint8_t* p = data + tkhd->payload_off;
    uint8_t ver = tkhd->payload_len >= 1 ? p[0] : 0;
    if (tkhd->payload_len >= uint64_t(ver == 1 ? 96 : 84)) {
      t.track_id = ver == 1 ? rd32(p + 20) : rd32(p + 12);
      // width/height are the last 8 bytes of tkhd payload
      t.width16 = rd32(data + tkhd->payload_off + tkhd->payload_len - 8);
      t.height16 = rd32(data + tkhd->payload_off + tkhd->payload_len - 4);
    }
  }
  if (auto* tref = find(cs, "tref")) {
    // tref children are reference-type boxes whose payload is a list of
    // u32 track ids; 'chap' marks QuickTime chapter tracks
    for (auto& r : children(data, tref->payload_off,
                            tref->payload_off + tref->payload_len)) {
      if (r.type != "chap") continue;
      for (uint64_t o = 0; o + 4 <= r.payload_len; o += 4)
        t.chap_refs.push_back(rd32(data + r.payload_off + o));
    }
  }
  if (auto* mdia = find(cs, "mdia")) {
    auto ms = children(data, mdia->payload_off,
                       mdia->payload_off + mdia->payload_len);
    if (auto* mdhd = find(ms, "mdhd")) {
      const uint8_t* p = data + mdhd->payload_off;
      if (mdhd->payload_len >= 32 && p[0] == 1) {
        t.timescale = rd32(p + 20);
        t.duration = rd64(p + 24);
      } else if (mdhd->payload_len >= 20 && p[0] == 0) {
        t.timescale = rd32(p + 12);
        t.duration = rd32(p + 16);
      }
    }
    if (auto* hdlr = find(ms, "hdlr")) {
      const uint8_t* p = data + hdlr->payload_off;
      if (hdlr->payload_len >= 12)
        t.handler.assign(reinterpret_cast<const char*>(p + 8), 4);
    }
    if (auto* minf = find(ms, "minf")) {
      auto fs = children(data, minf->payload_off,
                         minf->payload_off + minf->payload_len);
      if (auto* stbl = find(fs, "stbl"))
        parse_stbl(data, *stbl, t, trak.box_off);
    }
  }
  return t;
}

Movie parse_movie(File& f) {
  Movie m;
  uint64_t fsize = f.size();
  uint64_t off = 0;
  std::vector<uint8_t> hdr(16);
  std::vector<uint8_t> moov;
  while (off + 8 <= fsize) {
    uint64_t avail = std::min<uint64_t>(16, fsize - off);
    f.read_at(off, hdr.data(), avail);
    uint64_t size = rd32(hdr.data());
    std::string type(reinterpret_cast<char*>(hdr.data()) + 4, 4);
    uint64_t hsz = 8;
    if (size == 1) {
      if (avail < 16) throw Error("truncated largesize box header");
      size = rd64(hdr.data() + 8);
      hsz = 16;
    }
    else if (size == 0) size = fsize - off;
    // overflow-safe advance: size > fsize - off also catches off wrap
    if (size < hsz || size > fsize - off) throw Error("bad box size");
    if (type == "moov") {
      moov.resize(size);
      f.read_at(off, moov.data(), size);
      auto cs = children(moov.data(), hsz, size);
      for (auto& b : cs) {
        if (b.type == "mvhd") {
          m.mvhd.assign(moov.data() + b.box_off, moov.data() + b.box_off + b.box_len);
          const uint8_t* p = moov.data() + b.payload_off;
          if (b.payload_len >= 32 && p[0] == 1) {
            m.movie_timescale = rd32(p + 20);
            m.movie_duration = rd64(p + 24);
          } else if (b.payload_len >= 20 && p[0] == 0) {
            m.movie_timescale = rd32(p + 12);
            m.movie_duration = rd32(p + 16);
          }
        } else if (b.type == "trak") {
          m.tracks.push_back(parse_trak(moov.data(), b));
        } else if (b.type == "udta" || b.type == "meta") {
          m.extra_moov_children.emplace_back(
              moov.data() + b.box_off, moov.data() + b.box_off + b.box_len);
        }
      }
      break;  // moov found; chunk offsets are absolute, no need to continue
    }
    off += size;
  }
  if (m.tracks.empty()) throw Error("no moov/trak found");
  return m;
}

// ------------------------------------------------------------------ chunk IO

void copy_bytes(File& src, uint64_t off, uint64_t len, File& dst) {
  static thread_local std::vector<uint8_t> buf;
  buf.resize(1 << 20);
  while (len) {
    size_t n = size_t(std::min<uint64_t>(len, buf.size()));
    src.read_at(off, buf.data(), n);
    dst.write(buf.data(), n);
    off += n;
    len -= n;
  }
}

uint64_t chunk_length(const Track& t, uint32_t chunk_idx,
                      uint32_t first_sample) {
  uint32_t spc = t.samples_in_chunk(chunk_idx);
  uint64_t len = 0;
  for (uint32_t s = 0; s < spc; s++) len += t.sample_size(first_sample + s);
  return len;
}

// ------------------------------------------------------------------- concat

struct PartData {
  Movie movie;
  Track* video = nullptr;
  std::unique_ptr<File> file;
};

// merged video sample tables + fresh trak emission
struct MergedVideo {
  std::vector<SttsEntry> stts;
  std::vector<CttsEntry> ctts;
  std::vector<uint32_t> stss;
  bool any_stss = false, any_ctts = false;
  std::vector<uint32_t> sizes;
  std::vector<uint64_t> chunk_offsets;      // one chunk per part
  std::vector<uint32_t> chunk_sample_counts;
  uint32_t timescale = 0;
  uint64_t duration = 0;
  uint32_t width16 = 0, height16 = 0;
  const std::vector<uint8_t>* stsd = nullptr;
};

static void append_stts(std::vector<SttsEntry>& dst,
                        const std::vector<SttsEntry>& src) {
  for (auto& e : src) {
    if (!dst.empty() && dst.back().delta == e.delta)
      dst.back().count += e.count;
    else
      dst.push_back(e);
  }
}

static void emit_video_trak(Buf& moov, const MergedVideo& v,
                            uint32_t track_id, uint32_t movie_timescale) {
  uint64_t movie_dur =
      v.timescale ? v.duration * movie_timescale / v.timescale : 0;
  size_t trak = moov.open("trak");
  {
    size_t tkhd = moov.open("tkhd");
    moov.u8(0); moov.u8(0); moov.u16(3);            // v0, flags enabled|in_movie
    moov.u32(0); moov.u32(0);                       // times
    moov.u32(track_id); moov.u32(0);
    moov.u32(uint32_t(movie_dur));
    moov.u32(0); moov.u32(0);                       // reserved
    moov.u16(0); moov.u16(0); moov.u16(0); moov.u16(0);  // layer/group/volume
    // identity matrix
    const uint32_t mat[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
    for (uint32_t x : mat) moov.u32(x);
    moov.u32(v.width16); moov.u32(v.height16);
    moov.close(tkhd);
  }
  size_t mdia = moov.open("mdia");
  {
    size_t mdhd = moov.open("mdhd");
    moov.u8(0); moov.u8(0); moov.u16(0);
    moov.u32(0); moov.u32(0);
    moov.u32(v.timescale); moov.u32(uint32_t(v.duration));
    moov.u16(0x55c4); moov.u16(0);                  // language 'und'
    moov.close(mdhd);

    size_t hdlr = moov.open("hdlr");
    moov.u32(0); moov.u32(0);
    moov.raw("vide", 4);
    moov.u32(0); moov.u32(0); moov.u32(0);
    moov.raw("VideoHandler", 13);                   // includes NUL
    moov.close(hdlr);

    size_t minf = moov.open("minf");
    {
      size_t vmhd = moov.open("vmhd");
      moov.u8(0); moov.u8(0); moov.u16(1);
      moov.u16(0); moov.u16(0); moov.u16(0); moov.u16(0);
      moov.close(vmhd);

      size_t dinf = moov.open("dinf");
      size_t dref = moov.open("dref");
      moov.u32(0); moov.u32(1);
      size_t url = moov.open("url ");
      moov.u8(0); moov.u8(0); moov.u16(1);          // self-contained
      moov.close(url);
      moov.close(dref);
      moov.close(dinf);

      size_t stbl = moov.open("stbl");
      moov.raw(*v.stsd);

      size_t stts = moov.open("stts");
      moov.u32(0); moov.u32(uint32_t(v.stts.size()));
      for (auto& e : v.stts) { moov.u32(e.count); moov.u32(e.delta); }
      moov.close(stts);

      if (v.any_ctts && !v.ctts.empty()) {
        size_t ctts = moov.open("ctts");
        moov.u32(0); moov.u32(uint32_t(v.ctts.size()));
        for (auto& e : v.ctts) { moov.u32(e.count); moov.u32(uint32_t(e.offset)); }
        moov.close(ctts);
      }
      if (v.any_stss) {
        size_t stss = moov.open("stss");
        moov.u32(0); moov.u32(uint32_t(v.stss.size()));
        for (uint32_t s : v.stss) moov.u32(s);
        moov.close(stss);
      }

      size_t stsc = moov.open("stsc");
      moov.u32(0); moov.u32(uint32_t(v.chunk_offsets.size()));
      for (uint32_t i = 0; i < v.chunk_offsets.size(); i++) {
        moov.u32(i + 1);
        moov.u32(v.chunk_sample_counts[i]);
        moov.u32(1);
      }
      moov.close(stsc);

      size_t stsz = moov.open("stsz");
      moov.u32(0); moov.u32(0); moov.u32(uint32_t(v.sizes.size()));
      for (uint32_t s : v.sizes) moov.u32(s);
      moov.close(stsz);

      size_t co64 = moov.open("co64");
      moov.u32(0); moov.u32(uint32_t(v.chunk_offsets.size()));
      for (uint64_t o : v.chunk_offsets) moov.u64(o);
      moov.close(co64);

      moov.close(stbl);
    }
    moov.close(minf);
  }
  moov.close(mdia);
  moov.close(trak);
}

// patch mvhd duration (+ next_track_id) in a raw mvhd box copy.
// Payload layouts (ISO 14496-12 §8.2.2): ver/flags(4) ctime/mtime(8 or 16)
// timescale(4) duration(4 or 8) rate(4) volume(2) reserved(10) matrix(36)
// pre_defined(24) next_track_ID(4) — so v0 payload is 100 bytes with
// next_track_ID at offset 96, v1 is 112 bytes with it at offset 108.
static void patch_mvhd(std::vector<uint8_t>& mvhd, uint64_t duration,
                       uint32_t next_track_id) {
  if (mvhd.size() < 8 + 4) throw Error("mvhd box too small");
  uint8_t* p = mvhd.data() + 8;  // skip box header
  if (p[0] == 1) {
    if (mvhd.size() < 8 + 112) throw Error("mvhd v1 payload too small");
    wr64(p + 24, duration);
    wr32(p + 108, next_track_id);
  } else {
    if (mvhd.size() < 8 + 100) throw Error("mvhd v0 payload too small");
    wr32(p + 16, uint32_t(duration));
    wr32(p + 96, next_track_id);
  }
}

// Concatenate video parts; optionally remux non-video tracks from `original`.
static void concat_mp4(const std::vector<std::string>& parts,
                       const std::string& original,  // "" = none
                       const std::string& out_path) {
  if (parts.empty()) throw Error("no parts given");

  // parse all parts
  std::vector<PartData> pds;
  for (auto& p : parts) {
    PartData pd;
    pd.file.reset(new File(p, "rb"));
    pd.movie = parse_movie(*pd.file);
    for (auto& t : pd.movie.tracks)
      if (t.handler == "vide") { pd.video = &t; break; }
    if (!pd.video) throw Error("no video track in " + p);
    pds.push_back(std::move(pd));
  }

  MergedVideo v;
  v.timescale = pds[0].video->timescale;
  v.stsd = &pds[0].video->stsd;
  v.width16 = pds[0].video->width16;
  v.height16 = pds[0].video->height16;
  v.any_ctts = false;  // becomes true if ANY part has ctts
  for (auto& pd : pds) {
    if (pd.video->timescale != v.timescale)
      throw Error("video timescale mismatch between parts");
    if (!pd.video->ctts.empty()) v.any_ctts = true;
    if (pd.video->has_stss) v.any_stss = true;
  }

  std::unique_ptr<File> orig_file;
  Movie orig_movie;
  if (!original.empty()) {
    orig_file.reset(new File(original, "rb"));
    orig_movie = parse_movie(*orig_file);
  }

  File out(out_path, "wb");
  // ftyp: isom brand
  {
    Buf b;
    size_t ftyp = b.open("ftyp");
    b.raw("isom", 4); b.u32(0x200);
    b.raw("isom", 4); b.raw("iso2", 4); b.raw("mp41", 4);
    b.close(ftyp);
    out.write(b.d.data(), b.d.size());
  }
  // mdat with 64-bit size, patched at the end
  uint64_t mdat_off = out.tell();
  {
    uint8_t hdr[16];
    wr32(hdr, 1);
    std::memcpy(hdr + 4, "mdat", 4);
    wr64(hdr + 8, 0);
    out.write(hdr, 16);
  }

  // 1) copy non-video chunks from original first (keeps stco 32-bit safe),
  //    recording new offsets per track
  std::vector<Track*> copied_tracks;
  std::vector<std::vector<uint64_t>> copied_new_offsets;
  uint32_t max_orig_track_id = 0;
  if (orig_file) {
    for (auto& t : orig_movie.tracks) {
      max_orig_track_id = std::max(max_orig_track_id, t.track_id);
      if (t.handler == "vide") continue;
      std::vector<uint64_t> new_offsets;
      uint32_t first_sample = 0;
      for (uint32_t c = 0; c < t.chunk_offsets.size(); c++) {
        uint64_t len = chunk_length(t, c, first_sample);
        new_offsets.push_back(out.tell());
        copy_bytes(*orig_file, t.chunk_offsets[c], len, out);
        first_sample += t.samples_in_chunk(c);
      }
      copied_tracks.push_back(&t);
      copied_new_offsets.push_back(std::move(new_offsets));
    }
  }

  // 2) copy video sample data part by part (one output chunk per part)
  for (auto& pd : pds) {
    Track& t = *pd.video;
    uint32_t n = bounded_sample_count(t, pd.file->size());
    v.chunk_offsets.push_back(out.tell());
    v.chunk_sample_counts.push_back(n);
    uint32_t sample_base = uint32_t(v.sizes.size());
    // copy chunk by chunk (samples are contiguous within a chunk)
    uint32_t first_sample = 0;
    for (uint32_t c = 0; c < t.chunk_offsets.size(); c++) {
      uint64_t len = chunk_length(t, c, first_sample);
      copy_bytes(*pd.file, t.chunk_offsets[c], len, out);
      first_sample += t.samples_in_chunk(c);
    }
    if (first_sample != n)
      throw Error("stsc/stco inconsistent with sample count");
    for (uint32_t i = 0; i < n; i++) v.sizes.push_back(t.sample_size(i));
    append_stts(v.stts, t.stts);
    if (!t.ctts.empty()) {
      for (auto& e : t.ctts) v.ctts.push_back(e);
    } else if (v.any_ctts) {
      // some OTHER part uses composition offsets: a ctts-less part means
      // pts == dts for its samples, which a merged ctts must state
      // explicitly as zero offsets — dropping the box entirely would
      // wreck the B-frame parts' presentation order
      v.ctts.push_back({n, 0});
    }
    if (t.has_stss)
      for (uint32_t s : t.stss) v.stss.push_back(sample_base + s);
    else if (v.any_stss)  // part without stss: every sample is sync
      for (uint32_t i = 0; i < n; i++) v.stss.push_back(sample_base + i + 1);
    v.duration += t.duration;
  }

  // patch mdat size
  {
    uint64_t end = out.tell();
    uint8_t sz[8];
    wr64(sz, end - mdat_off);
    out.write_at(mdat_off + 8, sz, 8);
  }

  // 3) moov
  uint32_t movie_timescale =
      orig_file ? orig_movie.movie_timescale
                : (pds[0].movie.movie_timescale ? pds[0].movie.movie_timescale
                                                : 1000);
  uint64_t movie_dur =
      v.timescale ? v.duration * movie_timescale / v.timescale : 0;
  uint32_t video_track_id = max_orig_track_id + 1;

  Buf moov;
  size_t moov_box = moov.open("moov");
  {
    std::vector<uint8_t> mvhd;
    if (orig_file) mvhd = orig_movie.mvhd;
    else if (!pds[0].movie.mvhd.empty()) mvhd = pds[0].movie.mvhd;
    if (!mvhd.empty()) {
      patch_mvhd(mvhd, movie_dur, video_track_id + 1);
      moov.raw(mvhd);
    }
  }
  emit_video_trak(moov, v, video_track_id, movie_timescale);
  // copied non-video traks with patched chunk offsets
  for (size_t i = 0; i < copied_tracks.size(); i++) {
    Track& t = *copied_tracks[i];
    std::vector<uint8_t> raw = t.trak_raw;
    if (t.co_off_in_trak == 0) throw Error("copied track has no stco/co64");
    uint8_t* co = raw.data() + t.co_off_in_trak;
    uint32_t n = rd32(co + 4);
    if (n != copied_new_offsets[i].size()) throw Error("stco patch mismatch");
    for (uint32_t c = 0; c < n; c++) {
      uint64_t off = copied_new_offsets[i][c];
      if (t.co_is_64) wr64(co + 8 + c * 8, off);
      else {
        if (off > 0xffffffffull) throw Error("stco overflow in copied track");
        wr32(co + 8 + c * 4, uint32_t(off));
      }
    }
    moov.raw(raw);
  }
  if (orig_file)
    for (auto& extra : orig_movie.extra_moov_children) moov.raw(extra);
  moov.close(moov_box);
  out.write(moov.d.data(), moov.d.size());
}

// --------------------------------------------------------------------- probe

struct ProbeResult {
  int32_t width, height;
  int64_t video_samples;
  int64_t timescale;
  int64_t duration;
  int32_t n_tracks;
  int32_t has_audio;
};

static ProbeResult probe_mp4(const std::string& path) {
  File f(path, "rb");
  Movie m = parse_movie(f);
  ProbeResult r{};
  r.n_tracks = int32_t(m.tracks.size());
  for (auto& t : m.tracks) {
    if (t.handler == "vide" && r.width == 0) {
      r.width = int32_t(t.width16 >> 16);
      r.height = int32_t(t.height16 >> 16);
      r.video_samples = t.sample_count();
      r.timescale = t.timescale;
      r.duration = int64_t(t.duration);
    } else if (t.handler == "soun") {
      r.has_audio = 1;
    }
  }
  return r;
}

}  // namespace reve

// ----------------------------------------------------------------- C ABI ---

extern "C" {

static thread_local std::string g_err;

static int fail(const char* what) {
  g_err = what;
  return -1;
}

const char* rc_last_error() { return g_err.c_str(); }

// error plumbing for sibling translation units (mkv.cpp)
void rc_set_error(const char* what) { g_err = what; }

// Concat video parts (+ optional original for audio/subs/chapters remux).
int rc_concat_mp4(const char** parts, int n_parts, const char* original,
                  const char* out_path) {
  try {
    std::vector<std::string> ps(parts, parts + n_parts);
    reve::concat_mp4(ps, original ? original : "", out_path);
    return 0;
  } catch (const std::exception& e) {
    return fail(e.what());
  }
}

int rc_probe_mp4(const char* path, int32_t* width, int32_t* height,
                 int64_t* video_samples, int64_t* timescale,
                 int64_t* duration, int32_t* n_tracks, int32_t* has_audio) {
  try {
    auto r = reve::probe_mp4(path);
    *width = r.width; *height = r.height;
    *video_samples = r.video_samples;
    *timescale = r.timescale; *duration = r.duration;
    *n_tracks = r.n_tracks; *has_audio = r.has_audio;
    return 0;
  } catch (const std::exception& e) {
    return fail(e.what());
  }
}

}  // extern "C"
