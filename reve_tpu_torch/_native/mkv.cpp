// reve_core — native Matroska (mkv) muxing: concatenate mp4-encoded video
// segment parts into an .mkv WITHOUT re-encoding, remuxing audio/subtitle
// tracks and chapters from the original input.
//
// This closes the reference's mkv flow (`ffmpeg -f concat ... -map 1:a?
// -map 1:s? -map_chapters 1 -c copy out.mkv`, reve-shared/src/lib.rs:181-204)
// natively: the framework's encoder writes segment parts as mp4 (cv2/native
// writers), and the CLI requires mkv output for mkv input
// (reve-cli/src/main.rs:124-140), so the mkv output path is
// "mp4 video parts + original mkv-or-mp4 A/V metadata -> mkv".
//
//   * Video: samples are read from the mp4 parts' sample tables (shared
//     ISO-BMFF parser, mp4_internal.h), timestamps rebased to one stream,
//     and written as Matroska SimpleBlocks; the codec is mapped from the
//     parts' stsd entry (mp4v->V_MPEG4/ISO/ASP with the esds
//     DecoderSpecificInfo as CodecPrivate, avc1->V_MPEG4/ISO/AVC with avcC,
//     hvc1/hev1->V_MPEGH/ISO/HEVC with hvcC, vp09->V_VP9, mjpg->V_MJPEG).
//   * Original = .mkv: non-video TrackEntry elements are copied VERBATIM
//     (preserving codec private data, language, defaults); their
//     SimpleBlock/BlockGroup elements are copied with only the
//     cluster-relative timestamp patched (lacing and frame bytes
//     untouched); Chapters/Tags/Attachments elements are copied verbatim.
//   * Original = .mp4: audio tracks are remuxed sample-by-sample with a
//     codec map (mp4a/esds objectType 0x40->A_AAC, 0x69/0x6B->A_MPEG/L3,
//     ac-3->A_AC3, ec-3->A_EAC3), sampling rate/channels parsed from the
//     AudioSampleEntry.
//   * Output layout: EBML header, Segment (size patched at close), Info
//     (TimestampScale = 1 ms), Tracks, ~1 s Clusters with interleaved
//     blocks sorted by timestamp, Cues (one CuePoint per cluster at its
//     first video keyframe), then any copied Chapters/Tags.
//
// No external dependencies; C++17; C ABI at the bottom.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "mp4_internal.h"

namespace reve {
namespace mkv {

// ------------------------------------------------------------ EBML writing

struct EbmlBuf {
  std::vector<uint8_t> d;

  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    d.insert(d.end(), b, b + n);
  }
  void raw(const std::vector<uint8_t>& v) { raw(v.data(), v.size()); }

  void id(uint32_t v) {  // EBML ids are written as-is (marker included)
    uint8_t tmp[4];
    int n = v > 0xFFFFFF ? 4 : v > 0xFFFF ? 3 : v > 0xFF ? 2 : 1;
    for (int i = 0; i < n; i++) tmp[i] = uint8_t(v >> (8 * (n - 1 - i)));
    raw(tmp, n);
  }
  void vint(uint64_t v) {  // size field: minimal-length vint
    int n = 1;
    while (n < 8 && v >= (uint64_t(1) << (7 * n)) - 1) n++;
    uint8_t tmp[8];
    uint64_t marked = v | (uint64_t(1) << (7 * n));
    for (int i = 0; i < n; i++)
      tmp[i] = uint8_t(marked >> (8 * (n - 1 - i)));
    raw(tmp, n);
  }
  void elem(uint32_t eid, const std::vector<uint8_t>& payload) {
    id(eid);
    vint(payload.size());
    raw(payload);
  }
  void elem(uint32_t eid, const EbmlBuf& child) { elem(eid, child.d); }
  void uint_elem(uint32_t eid, uint64_t v) {
    int n = 1;
    while (n < 8 && (v >> (8 * n)) != 0) n++;
    id(eid);
    vint(uint64_t(n));
    uint8_t tmp[8];
    for (int i = 0; i < n; i++) tmp[i] = uint8_t(v >> (8 * (n - 1 - i)));
    raw(tmp, n);
  }
  void float_elem(uint32_t eid, double v) {
    id(eid);
    vint(8);
    uint64_t bits;
    std::memcpy(&bits, &v, 8);
    uint8_t tmp[8];
    for (int i = 0; i < 8; i++) tmp[i] = uint8_t(bits >> (8 * (7 - i)));
    raw(tmp, 8);
  }
  void str_elem(uint32_t eid, const std::string& s) {
    id(eid);
    vint(s.size());
    raw(s.data(), s.size());
  }
};

// ------------------------------------------------------------ EBML parsing

struct Ebml {
  const uint8_t* d;
  uint64_t n;
  uint64_t pos = 0;

  bool eof() const { return pos >= n; }
  uint32_t read_id() {
    if (pos >= n) throw Error("mkv: truncated id");
    uint8_t b0 = d[pos];
    int len = b0 & 0x80 ? 1 : b0 & 0x40 ? 2 : b0 & 0x20 ? 3 : b0 & 0x10 ? 4 : 0;
    if (!len || pos + len > n) throw Error("mkv: bad element id");
    uint32_t v = 0;
    for (int i = 0; i < len; i++) v = (v << 8) | d[pos + i];
    pos += len;
    return v;
  }
  // returns UINT64_MAX for "unknown size"
  uint64_t read_size() {
    if (pos >= n) throw Error("mkv: truncated size");
    uint8_t b0 = d[pos];
    int len = 0;
    for (int i = 0; i < 8; i++)
      if (b0 & (0x80 >> i)) { len = i + 1; break; }
    if (!len || pos + len > n) throw Error("mkv: bad size vint");
    uint64_t v = b0 & (0xFF >> len);
    for (int i = 1; i < len; i++) v = (v << 8) | d[pos + i];
    pos += len;
    uint64_t unknown = (uint64_t(1) << (7 * len)) - 1;
    return v == unknown ? UINT64_MAX : v;
  }
};

static uint64_t ebml_uint(const uint8_t* p, uint64_t len) {
  uint64_t v = 0;
  for (uint64_t i = 0; i < len; i++) v = (v << 8) | p[i];
  return v;
}

// one parsed child element: id + payload span
struct Elem {
  uint32_t id;
  uint64_t off, len;      // payload span within the parent buffer
  uint64_t elem_off;      // element start (id byte)
};

static std::vector<Elem> ebml_children(const uint8_t* d, uint64_t off,
                                       uint64_t end) {
  std::vector<Elem> out;
  Ebml r{d, end, off};
  while (r.pos < end) {
    uint64_t eoff = r.pos;
    uint32_t eid = r.read_id();
    uint64_t sz = r.read_size();
    if (sz == UINT64_MAX || sz > end || r.pos > end - sz)
      throw Error("mkv: unknown-size or overflowing child element");
    out.push_back({eid, r.pos, sz, eoff});
    r.pos += sz;
  }
  return out;
}

// EBML / Matroska element ids
enum : uint32_t {
  ID_EBML = 0x1A45DFA3,
  ID_DocType = 0x4282,
  ID_Segment = 0x18538067,
  ID_Info = 0x1549A966,
  ID_TimestampScale = 0x2AD7B1,
  ID_Duration = 0x4489,
  ID_MuxingApp = 0x4D80,
  ID_WritingApp = 0x5741,
  ID_Tracks = 0x1654AE6B,
  ID_TrackEntry = 0xAE,
  ID_TrackNumber = 0xD7,
  ID_TrackUID = 0x73C5,
  ID_TrackType = 0x83,
  ID_CodecID = 0x86,
  ID_CodecPrivate = 0x63A2,
  ID_CodecDelay = 0x56AA,
  ID_SeekPreRoll = 0x56BB,
  ID_DefaultDuration = 0x23E383,
  ID_Video = 0xE0,
  ID_PixelWidth = 0xB0,
  ID_PixelHeight = 0xBA,
  ID_Audio = 0xE1,
  ID_SamplingFrequency = 0xB5,
  ID_Channels = 0x9F,
  ID_Cluster = 0x1F43B675,
  ID_Timestamp = 0xE7,
  ID_SimpleBlock = 0xA3,
  ID_BlockGroup = 0xA0,
  ID_Block = 0xA1,
  ID_BlockDuration = 0x9B,
  ID_Chapters = 0x1043A770,
  ID_EditionEntry = 0x45B9,
  ID_EditionFlagDefault = 0x45DB,
  ID_ChapterAtom = 0xB6,
  ID_ChapterUID = 0x73C4,
  ID_ChapterTimeStart = 0x91,
  ID_ChapterDisplay = 0x80,
  ID_ChapString = 0x85,
  ID_ChapLanguage = 0x437C,
  ID_Tags = 0x1254C367,
  ID_Attachments = 0x1941A469,
  ID_Cues = 0x1C53BB6B,
  ID_CuePoint = 0xBB,
  ID_CueTime = 0xB3,
  ID_CueTrackPositions = 0xB7,
  ID_CueTrack = 0xF7,
  ID_CueClusterPosition = 0xF1,
  ID_SeekHead = 0x114D9B74,
  ID_Void = 0xEC,
  ID_CRC32 = 0xBF,
};

// ----------------------------------------------------------- mkv demuxing

struct MkvTrack {
  uint64_t number = 0;
  uint8_t type = 0;  // 1 video, 2 audio, 17 subtitle
  std::string codec;
  std::vector<uint8_t> entry_raw;  // full TrackEntry element
};

struct CopiedBlock {
  int64_t ts;                    // output-timescale (ms) absolute timestamp
  std::vector<uint8_t> raw;      // full SimpleBlock or BlockGroup element
  uint64_t relts_off;            // offset of the s16 rel-timestamp in raw
};

struct MkvOriginal {
  uint64_t ts_scale = 1000000;   // ns per tick
  double duration_s = 0;
  std::vector<MkvTrack> tracks;  // all tracks
  std::vector<CopiedBlock> blocks;  // non-video blocks only
  std::vector<uint8_t> chapters, tags, attachments;  // raw elements
};

// offset of the relative-timestamp s16 within a (Simple)Block payload
static uint64_t block_relts_off(const uint8_t* p, uint64_t len) {
  if (!len) throw Error("mkv: empty block");
  uint8_t b0 = p[0];
  int tlen = 0;
  for (int i = 0; i < 8; i++)
    if (b0 & (0x80 >> i)) { tlen = i + 1; break; }
  if (!tlen || uint64_t(tlen) + 3 > len) throw Error("mkv: bad block header");
  return uint64_t(tlen);
}

static uint64_t block_track(const uint8_t* p, uint64_t len) {
  uint64_t off = block_relts_off(p, len);  // validates
  uint64_t v = p[0] & (0xFF >> off);
  for (uint64_t i = 1; i < off; i++) v = (v << 8) | p[i];
  return v;
}


// streaming top-level walker: reads element heads through File and loads
// one payload at a time — originals can be multi-GB movies, and only
// Info/Tracks/Chapters/Tags/Attachments plus one Cluster at a time need
// to be resident (the mp4 part files stream through the shared File APIs
// the same way).
struct FileEbml {
  File& f;
  uint64_t size;
  uint64_t pos = 0;

  bool read_head(uint32_t* id, uint64_t* sz) {
    if (pos + 2 > size) return false;
    uint8_t buf[12];
    size_t n = size_t(std::min<uint64_t>(12, size - pos));
    f.read_at(pos, buf, n);
    uint8_t b0 = buf[0];
    int idlen = b0 & 0x80 ? 1 : b0 & 0x40 ? 2 : b0 & 0x20 ? 3 :
                b0 & 0x10 ? 4 : 0;
    if (!idlen || size_t(idlen) >= n) throw Error("mkv: bad element id");
    uint32_t v = 0;
    for (int i = 0; i < idlen; i++) v = (v << 8) | buf[i];
    uint8_t s0 = buf[idlen];
    int slen = 0;
    for (int i = 0; i < 8; i++)
      if (s0 & (0x80 >> i)) { slen = i + 1; break; }
    if (!slen || size_t(idlen + slen) > n) throw Error("mkv: bad size vint");
    uint64_t val = s0 & (0xFF >> slen);
    for (int i = 1; i < slen; i++) val = (val << 8) | buf[idlen + i];
    uint64_t unknown = (uint64_t(1) << (7 * slen)) - 1;
    *id = v;
    *sz = val == unknown ? UINT64_MAX : val;
    pos += uint64_t(idlen + slen);
    return true;
  }

  std::vector<uint8_t> read_payload(uint64_t sz) {
    // overflow-safe (sz can be a 56-bit lie or the UINT64_MAX sentinel:
    // pos + sz must never be formed)
    if (sz > size || pos > size - sz)
      throw Error("mkv: element overflows file");
    std::vector<uint8_t> buf(sz);
    if (sz) f.read_at(pos, buf.data(), sz);
    pos += sz;
    return buf;
  }
};

static MkvOriginal parse_mkv(const std::string& path) {
  File f(path, "rb");
  FileEbml r{f, f.size()};

  uint32_t eid;
  uint64_t sz;
  if (!r.read_head(&eid, &sz) || eid != ID_EBML)
    throw Error("not an mkv (no EBML header)");
  if (sz == UINT64_MAX) throw Error("mkv: unknown-size EBML header");
  r.pos += sz;
  if (!r.read_head(&eid, &sz) || eid != ID_Segment)
    throw Error("mkv: no Segment");
  uint64_t seg_end = sz == UINT64_MAX ? r.size : r.pos + sz;
  if (seg_end > r.size) seg_end = r.size;

  MkvOriginal m;
  std::vector<uint64_t> video_tracks;
  // walk top-level Segment children, loading one payload at a time
  while (r.pos < seg_end) {
    if (!r.read_head(&eid, &sz)) break;
    if (sz == UINT64_MAX)
      throw Error("mkv: unknown-size element (live stream?) unsupported");
    if (sz > seg_end || r.pos > seg_end - sz)
      throw Error("mkv: element overflows segment");
    if (eid != ID_Info && eid != ID_Tracks && eid != ID_Cluster &&
        eid != ID_Chapters && eid != ID_Tags && eid != ID_Attachments) {
      r.pos += sz;  // SeekHead, Cues, Void, ...: skip without reading
      continue;
    }
    std::vector<uint8_t> data = r.read_payload(sz);
    const uint8_t* d = data.data();
    uint64_t payload = 0, end = sz;
    if (eid == ID_Info) {
      for (auto& e : ebml_children(d, payload, end)) {
        if (e.id == ID_TimestampScale) m.ts_scale = ebml_uint(d + e.off, e.len);
        if (e.id == ID_Duration) {
          if (e.len == 8) {
            uint64_t bits = rd64(d + e.off);
            double v;
            std::memcpy(&v, &bits, 8);
            m.duration_s = v;
          } else if (e.len == 4) {
            uint32_t bits = rd32(d + e.off);
            float v;
            std::memcpy(&v, &bits, 4);
            m.duration_s = v;
          }
        }
      }
      m.duration_s *= double(m.ts_scale) / 1e9;
    } else if (eid == ID_Tracks) {
      for (auto& e : ebml_children(d, payload, end)) {
        if (e.id != ID_TrackEntry) continue;
        MkvTrack t;
        t.entry_raw.assign(d + e.elem_off, d + e.off + e.len);
        for (auto& c : ebml_children(d, e.off, e.off + e.len)) {
          if (c.id == ID_TrackNumber) t.number = ebml_uint(d + c.off, c.len);
          if (c.id == ID_TrackType)
            t.type = uint8_t(ebml_uint(d + c.off, c.len));
          if (c.id == ID_CodecID)
            t.codec.assign(reinterpret_cast<const char*>(d + c.off), c.len);
        }
        if (t.type == 1) video_tracks.push_back(t.number);
        m.tracks.push_back(std::move(t));
      }
    } else if (eid == ID_Cluster) {
      int64_t cluster_ts = 0;
      for (auto& e : ebml_children(d, payload, end)) {
        if (e.id == ID_Timestamp) {
          cluster_ts = int64_t(ebml_uint(d + e.off, e.len));
        } else if (e.id == ID_SimpleBlock || e.id == ID_BlockGroup) {
          uint64_t boff = e.off, blen = e.len;
          uint64_t group_shift = 0;
          if (e.id == ID_BlockGroup) {
            const Elem* blk = nullptr;
            auto gs = ebml_children(d, e.off, e.off + e.len);
            for (auto& g : gs)
              if (g.id == ID_Block) { blk = &g; break; }
            if (!blk) continue;
            boff = blk->off;
            blen = blk->len;
            group_shift = blk->off - e.elem_off;
          }
          uint64_t trk = block_track(d + boff, blen);
          bool is_video = false;
          for (uint64_t v : video_tracks) is_video |= (v == trk);
          if (is_video) continue;
          uint64_t ro = block_relts_off(d + boff, blen);
          int16_t rel = int16_t((d[boff + ro] << 8) | d[boff + ro + 1]);
          CopiedBlock cb;
          cb.raw.assign(d + e.elem_off, d + e.off + e.len);
          cb.relts_off = (e.id == ID_BlockGroup ? group_shift
                                                : (e.off - e.elem_off)) + ro;
          // absolute ts in ORIGINAL ticks; the output adopts the
          // original's TimestampScale so copied BlockDuration /
          // ReferenceBlock tick values stay correct without rescaling
          cb.ts = cluster_ts + rel;
          m.blocks.push_back(std::move(cb));
        }
      }
    } else if (eid == ID_Chapters) {
      m.chapters = std::move(data);
    } else if (eid == ID_Tags) {
      m.tags = std::move(data);
    } else if (eid == ID_Attachments) {
      m.attachments = std::move(data);
    }
  }
  return m;
}

// ----------------------------------------------- video source (mp4 parts)

struct VideoSample {
  uint64_t file_off;
  uint32_t size;
  int64_t ts_ns;    // presentation time, nanoseconds
  bool key;
  File* file;
};

struct VideoStream {
  std::vector<VideoSample> samples;  // ts-ordered
  std::string codec_id;
  std::vector<uint8_t> codec_private;
  uint32_t width = 0, height = 0;
  uint64_t default_duration_ns = 0;
  double duration_s = 0;
};

// walk an MPEG-4 descriptor blob for a tag, returns payload span
static bool find_descriptor(const uint8_t* p, uint64_t len, uint8_t tag,
                            uint64_t* off, uint64_t* dlen) {
  uint64_t pos = 0;
  while (pos + 2 <= len) {
    uint8_t t = p[pos++];
    uint64_t sz = 0;
    int n = 0;
    while (pos < len && n < 4) {
      uint8_t b = p[pos++];
      sz = (sz << 7) | (b & 0x7F);
      n++;
      if (!(b & 0x80)) break;
    }
    if (pos + sz > len) return false;
    if (t == tag) {
      *off = pos;
      *dlen = sz;
      return true;
    }
    // descend into container descriptors (ES=0x03, DecoderConfig=0x04)
    if (t == 0x03) {
      // skip ES_ID(2) + flags(1) (+ optional fields if flags set)
      uint64_t skip = 3;
      if (sz >= 3) {
        uint8_t flags = p[pos + 2];
        if (flags & 0x80) skip += 2;
        if (flags & 0x40 && pos + skip < len) skip += 1 + p[pos + skip];
        if (flags & 0x20) skip += 2;
      }
      // skip may exceed a lying descriptor's sz: sz - skip would wrap
      if (skip < sz &&
          find_descriptor(p + pos + skip, sz - skip, tag, off, dlen)) {
        *off += pos + skip;
        return true;
      }
    } else if (t == 0x04) {
      // DecoderConfig: objectType(1) stream(1) buffer(3) maxbr(4) avgbr(4)
      if (sz > 13 && find_descriptor(p + pos + 13, sz - 13, tag, off, dlen)) {
        *off += pos + 13;
        return true;
      }
    }
    pos += sz;
  }
  return false;
}

// map the parts' stsd video entry to (CodecID, CodecPrivate)
static void map_video_codec(const std::vector<uint8_t>& stsd,
                            VideoStream* vs) {
  // stsd: hdr(8) verflags(4) count(4) entry...
  if (stsd.size() < 16 + 8) throw Error("stsd too small");
  const uint8_t* p = stsd.data() + 16;
  uint64_t len = stsd.size() - 16;
  std::string fmt(reinterpret_cast<const char*>(p + 4), 4);
  // VisualSampleEntry: 8 hdr + 78 fixed, then extension boxes
  if (len < 86) throw Error("video sample entry too small");
  auto ext = children(p, 86, len);
  auto ext_payload = [&](const char* t) -> std::vector<uint8_t> {
    const BoxRef* b = find(ext, t);
    if (!b) return {};
    return std::vector<uint8_t>(p + b->payload_off,
                                p + b->payload_off + b->payload_len);
  };
  if (fmt == "avc1" || fmt == "avc3") {
    vs->codec_id = "V_MPEG4/ISO/AVC";
    vs->codec_private = ext_payload("avcC");
  } else if (fmt == "hvc1" || fmt == "hev1") {
    vs->codec_id = "V_MPEGH/ISO/HEVC";
    vs->codec_private = ext_payload("hvcC");
  } else if (fmt == "vp09") {
    vs->codec_id = "V_VP9";
  } else if (fmt == "av01") {
    vs->codec_id = "V_AV1";
    vs->codec_private = ext_payload("av1C");
  } else if (fmt == "mp4v") {
    vs->codec_id = "V_MPEG4/ISO/ASP";
    auto esds = ext_payload("esds");
    if (esds.size() > 4) {
      uint64_t off, dlen;  // DecSpecificInfo tag 0x05 holds the VOL headers
      if (find_descriptor(esds.data() + 4, esds.size() - 4, 0x05, &off,
                          &dlen))
        vs->codec_private.assign(esds.begin() + 4 + long(off),
                                 esds.begin() + 4 + long(off + dlen));
    }
  } else if (fmt == "mjpg" || fmt == "jpeg" || fmt == "MJPG") {
    vs->codec_id = "V_MJPEG";
  } else {
    throw Error("unsupported video codec for mkv mux: " + fmt);
  }
}

static VideoStream build_video_stream(
    std::vector<std::unique_ptr<File>>& files, std::vector<Movie>& movies) {
  VideoStream vs;
  int64_t ts_acc_ns = 0;
  for (size_t pi = 0; pi < movies.size(); pi++) {
    Track* t = nullptr;
    for (auto& tr : movies[pi].tracks)
      if (tr.handler == "vide") { t = &tr; break; }
    if (!t) throw Error("no video track in part");
    if (pi == 0) {
      map_video_codec(t->stsd, &vs);
      vs.width = t->width16 >> 16;
      vs.height = t->height16 >> 16;
      if (!t->stts.empty() && t->timescale)
        vs.default_duration_ns =
            uint64_t(double(t->stts[0].delta) * 1e9 / t->timescale);
    }
    if (!t->timescale) throw Error("video track has no timescale");
    // per-sample dts from stts, pts offset from ctts, key from stss
    uint64_t part_size = files[pi]->size();
    uint32_t n = bounded_sample_count(*t, part_size);
    std::vector<uint64_t> offs(n);
    {
      uint32_t s = 0;
      for (uint32_t c = 0; c < t->chunk_offsets.size() && s < n; c++) {
        uint64_t o = t->chunk_offsets[c];
        uint32_t spc = t->samples_in_chunk(c);
        for (uint32_t k = 0; k < spc && s < n; k++) {
          offs[s] = o;
          o += t->sample_size(s);
          s++;
        }
      }
      if (s != n) throw Error("mkv mux: stsc/stco inconsistent");
    }
    std::vector<bool> key(n, !t->has_stss);
    for (uint32_t sn : t->stss)
      if (sn >= 1 && sn <= n) key[sn - 1] = true;
    std::vector<int64_t> pts_off(n, 0);
    {
      uint32_t s = 0;
      for (auto& e : t->ctts)
        for (uint32_t k = 0; k < e.count && s < n; k++) pts_off[s++] = e.offset;
    }
    uint64_t dts = 0;
    uint32_t s = 0;
    int64_t part_dur_ticks = 0;
    for (auto& e : t->stts) part_dur_ticks += int64_t(e.count) * e.delta;
    for (auto& e : t->stts) {
      for (uint32_t k = 0; k < e.count && s < n; k++) {
        int64_t pts_ticks = int64_t(dts) + pts_off[s];
        VideoSample smp;
        smp.file_off = offs[s];
        smp.size = t->sample_size(s);
        // a lied stsz entry must not drive a giant framebuf allocation
        // in the cluster writer: every sample-copy source lives inside
        // its part file (overflow-safe: a 64-bit co64 offset near 2^64
        // wraps off+size below the file size)
        if (smp.file_off > part_size ||
            uint64_t(smp.size) > part_size - smp.file_off)
          throw Error("mkv mux: video sample outside its part file");
        smp.ts_ns = ts_acc_ns +
                    int64_t(double(pts_ticks) * 1e9 / t->timescale);
        smp.key = key[s];
        smp.file = files[pi].get();
        vs.samples.push_back(smp);
        dts += e.delta;
        s++;
      }
    }
    ts_acc_ns += int64_t(double(part_dur_ticks) * 1e9 / t->timescale);
  }
  vs.duration_s = double(ts_acc_ns) / 1e9;
  // pts may reorder around dts order within a part; clusters want ts order
  std::stable_sort(vs.samples.begin(), vs.samples.end(),
                   [](const VideoSample& a, const VideoSample& b) {
                     return a.ts_ns < b.ts_ns;
                   });
  return vs;
}

// --------------------------------------------- mp4-original audio remux

struct AudioCodec {
  std::string codec_id;
  std::vector<uint8_t> codec_private;
  double sample_rate = 0;
  uint32_t channels = 0;
  uint64_t codec_delay_ns = 0;   // Opus: PreSkip in ns (48 kHz samples)
  uint64_t seek_preroll_ns = 0;  // Opus: 80 ms per RFC 7845 §4.2
  uint8_t track_type = 2;        // 2 audio, 17 subtitle (S_TEXT/UTF8)
};

static bool map_audio_codec(const Track& t, AudioCodec* ac) {
  if (t.stsd.size() < 16 + 8) return false;
  const uint8_t* p = t.stsd.data() + 16;
  uint64_t len = t.stsd.size() - 16;
  std::string fmt(reinterpret_cast<const char*>(p + 4), 4);
  // AudioSampleEntry: 8 hdr + 8 reserved + 2 ver + 6 reserved +
  // channelcount(2)@24 samplesize(2) predefined(2) reserved(2)
  // samplerate(4,16.16)@32, extensions @36
  if (len < 36) return false;
  ac->channels = (uint32_t(p[24]) << 8) | p[25];
  ac->sample_rate = double(rd32(p + 32)) / 65536.0;
  auto ext = children(p, 36, len);
  if (fmt == "mp4a") {
    const BoxRef* esds = find(ext, "esds");
    if (!esds || esds->payload_len <= 4) return false;  // verflags(4)
    const uint8_t* e = p + esds->payload_off + 4;
    uint64_t elen = esds->payload_len - 4;
    uint64_t off, dlen;
    uint8_t object_type = 0x40;
    if (find_descriptor(e, elen, 0x04, &off, &dlen) && dlen >= 1)
      object_type = e[off];
    if (object_type == 0x40 || object_type == 0x66 || object_type == 0x67 ||
        object_type == 0x68) {
      ac->codec_id = "A_AAC";
      if (find_descriptor(e, elen, 0x05, &off, &dlen))
        ac->codec_private.assign(e + off, e + off + dlen);
      return true;
    }
    if (object_type == 0x69 || object_type == 0x6B) {
      ac->codec_id = "A_MPEG/L3";
      return true;
    }
    return false;
  }
  if (fmt == "ac-3") { ac->codec_id = "A_AC3"; return true; }
  if (fmt == "ec-3") { ac->codec_id = "A_EAC3"; return true; }
  if (fmt == "fLaC") {
    // dfLa (FLAC-in-ISOBMFF): FullBox verflags(4), then the METADATA_BLOCKs
    // starting with STREAMINFO.  Matroska A_FLAC CodecPrivate is the native
    // FLAC stream header: "fLaC" magic + those same blocks, verbatim.
    const BoxRef* dfla = find(ext, "dfLa");
    if (!dfla || dfla->payload_len < 4 + 38) return false;  // STREAMINFO=38
    ac->codec_id = "A_FLAC";
    ac->codec_private = {'f', 'L', 'a', 'C'};
    ac->codec_private.insert(ac->codec_private.end(),
                             p + dfla->payload_off + 4,
                             p + dfla->payload_off + dfla->payload_len);
    return true;
  }
  if (fmt == "Opus") {
    // dOps (Opus-in-ISOBMFF, NOT a FullBox): Version(1)=0,
    // OutputChannelCount(1), PreSkip(be16), InputSampleRate(be32),
    // OutputGain(be16), ChannelMappingFamily(1)
    // [+ StreamCount(1), CoupledCount(1), ChannelMapping(chans) if
    //  family != 0 — identical order to OpusHead's table].
    // Matroska CodecPrivate is the Ogg OpusHead (RFC 7845 §5.1): same
    // fields with the multi-byte ones little-endian, behind the magic.
    const BoxRef* dops = find(ext, "dOps");
    if (!dops || dops->payload_len < 11) return false;
    const uint8_t* o = p + dops->payload_off;
    if (o[0] != 0) return false;  // unknown dOps version
    uint8_t chans = o[1];
    uint16_t preskip = uint16_t((uint16_t(o[2]) << 8) | o[3]);
    uint32_t in_rate = rd32(o + 4);
    uint16_t gain = uint16_t((uint16_t(o[8]) << 8) | o[9]);
    uint8_t family = o[10];
    std::vector<uint8_t> head = {'O', 'p', 'u', 's', 'H', 'e', 'a', 'd', 1,
                                 chans,
                                 uint8_t(preskip), uint8_t(preskip >> 8),
                                 uint8_t(in_rate), uint8_t(in_rate >> 8),
                                 uint8_t(in_rate >> 16), uint8_t(in_rate >> 24),
                                 uint8_t(gain), uint8_t(gain >> 8), family};
    if (family != 0) {
      uint64_t tbl = 2 + uint64_t(chans);
      if (dops->payload_len < 11 + tbl) return false;
      head.insert(head.end(), o + 11, o + 11 + tbl);
    }
    ac->codec_id = "A_OPUS";
    ac->codec_private = std::move(head);
    ac->channels = chans;
    // dOps InputSampleRate is the original rate (0 = unspecified); Opus
    // itself always decodes at 48 kHz, which is also PreSkip's timebase
    if (in_rate) ac->sample_rate = double(in_rate);
    ac->codec_delay_ns = uint64_t(preskip) * 1000000000ull / 48000;
    ac->seek_preroll_ns = 80000000;  // 80 ms, RFC 7845 §4.2
    return true;
  }
  return false;
}

// ------------------------------------------------------------------ muxing

struct OutBlock {
  int64_t ts;
  int order;  // stable tie-break: video first
  // either a prebuilt element (copied from mkv original)...
  std::vector<uint8_t> raw;
  uint64_t relts_off = 0;
  // ...or a frame to wrap into a fresh SimpleBlock
  uint64_t track = 0;
  bool key = false;
  File* file = nullptr;
  uint64_t file_off = 0;
  uint32_t size = 0;
  // duration > 0 wraps the fresh block in a BlockGroup with BlockDuration
  // (subtitle blocks: Matroska derives display time from it)
  uint64_t duration = 0;
};

static void write_mkv(const std::string& out_path, VideoStream& vs,
                      uint64_t video_track_num,
                      const std::vector<const MkvTrack*>& copied_tracks,
                      std::vector<OutBlock>& blocks,
                      const std::vector<std::vector<uint8_t>>& extra_elements,
                      const std::vector<std::pair<uint64_t, AudioCodec>>&
                          mp4_audio_tracks,
                      double duration_s, uint64_t ts_scale) {
  File out(out_path, "wb");
  {
    EbmlBuf h;
    h.uint_elem(0x4286, 1);      // EBMLVersion
    h.uint_elem(0x42F7, 1);      // EBMLReadVersion
    h.uint_elem(0x42F2, 4);      // EBMLMaxIDLength
    h.uint_elem(0x42F3, 8);      // EBMLMaxSizeLength
    h.str_elem(ID_DocType, "matroska");
    h.uint_elem(0x4287, 4);      // DocTypeVersion
    h.uint_elem(0x4285, 2);      // DocTypeReadVersion
    EbmlBuf top;
    top.elem(ID_EBML, h);
    out.write(top.d.data(), top.d.size());
  }
  // Segment with an 8-byte size placeholder, patched at the end
  {
    EbmlBuf sid;
    sid.id(ID_Segment);
    out.write(sid.d.data(), sid.d.size());
    uint8_t szp[8] = {0x01, 0, 0, 0, 0, 0, 0, 0};
    out.write(szp, 8);
  }
  uint64_t seg_payload_start = out.tell();

  {
    EbmlBuf info;
    info.uint_elem(ID_TimestampScale, ts_scale);
    info.float_elem(ID_Duration, duration_s * 1e9 / double(ts_scale));
    info.str_elem(ID_MuxingApp, "reve-tpu");
    info.str_elem(ID_WritingApp, "reve-tpu");
    EbmlBuf e;
    e.elem(ID_Info, info);
    out.write(e.d.data(), e.d.size());
  }
  {
    EbmlBuf tracks;
    {
      EbmlBuf te;
      te.uint_elem(ID_TrackNumber, video_track_num);
      te.uint_elem(ID_TrackUID, video_track_num);
      te.uint_elem(ID_TrackType, 1);
      te.str_elem(ID_CodecID, vs.codec_id);
      if (!vs.codec_private.empty())
        te.elem(ID_CodecPrivate, vs.codec_private);
      if (vs.default_duration_ns)
        te.uint_elem(ID_DefaultDuration, vs.default_duration_ns);
      EbmlBuf vid;
      vid.uint_elem(ID_PixelWidth, vs.width);
      vid.uint_elem(ID_PixelHeight, vs.height);
      te.elem(ID_Video, vid);
      tracks.elem(ID_TrackEntry, te);
    }
    for (auto* t : copied_tracks) tracks.raw(t->entry_raw);
    for (auto& [num, ac] : mp4_audio_tracks) {
      EbmlBuf te;
      te.uint_elem(ID_TrackNumber, num);
      te.uint_elem(ID_TrackUID, num);
      te.uint_elem(ID_TrackType, ac.track_type);
      te.str_elem(ID_CodecID, ac.codec_id);
      if (ac.codec_delay_ns) te.uint_elem(ID_CodecDelay, ac.codec_delay_ns);
      if (ac.seek_preroll_ns)
        te.uint_elem(ID_SeekPreRoll, ac.seek_preroll_ns);
      if (!ac.codec_private.empty())
        te.elem(ID_CodecPrivate, ac.codec_private);
      if (ac.track_type == 2) {
        EbmlBuf au;
        au.float_elem(ID_SamplingFrequency, ac.sample_rate);
        au.uint_elem(ID_Channels, ac.channels ? ac.channels : 2);
        te.elem(ID_Audio, au);
      }
      tracks.elem(ID_TrackEntry, te);
    }
    EbmlBuf e;
    e.elem(ID_Tracks, tracks);
    out.write(e.d.data(), e.d.size());
  }

  std::stable_sort(blocks.begin(), blocks.end(),
                   [](const OutBlock& a, const OutBlock& b) {
                     return a.ts != b.ts ? a.ts < b.ts : a.order < b.order;
                   });

  // clusters + cues
  struct Cue { int64_t ts; uint64_t cluster_off; };
  std::vector<Cue> cues;
  // ~1 s per cluster, capped so every relative timestamp fits in s16
  const int64_t CLUSTER_TICKS =
      std::min<int64_t>(32000, std::max<int64_t>(
          1, int64_t(1e9 / double(ts_scale))));
  size_t i = 0;
  std::vector<uint8_t> framebuf;
  while (i < blocks.size()) {
    int64_t base = blocks[i].ts;
    EbmlBuf cl;
    cl.uint_elem(ID_Timestamp, uint64_t(std::max<int64_t>(base, 0)));
    uint64_t cluster_off = out.tell() - seg_payload_start;
    bool cue_added = false;
    while (i < blocks.size() && blocks[i].ts - base < CLUSTER_TICKS) {
      OutBlock& b = blocks[i];
      int64_t rel = b.ts - base;
      if (!b.raw.empty()) {
        // copied element: patch its relative timestamp
        std::vector<uint8_t> raw = b.raw;
        raw[b.relts_off] = uint8_t(uint16_t(rel) >> 8);
        raw[b.relts_off + 1] = uint8_t(uint16_t(rel));
        cl.raw(raw);
      } else {
        framebuf.resize(b.size);
        b.file->read_at(b.file_off, framebuf.data(), b.size);
        EbmlBuf payload;
        payload.vint(b.track);  // track number as vint
        payload.d.push_back(uint8_t(uint16_t(rel) >> 8));
        payload.d.push_back(uint8_t(uint16_t(rel)));
        payload.d.push_back(b.duration ? 0x00
                                       : (b.key ? 0x80 : 0x00));  // flags
        payload.raw(framebuf);
        if (b.duration) {
          // BlockGroup{Block, BlockDuration}: subtitle display time
          EbmlBuf grp;
          grp.elem(ID_Block, payload);
          grp.uint_elem(ID_BlockDuration, b.duration);
          cl.elem(ID_BlockGroup, grp);
        } else {
          cl.elem(ID_SimpleBlock, payload);
        }
        if (b.track == video_track_num && b.key && !cue_added) {
          cues.push_back({b.ts, cluster_off});
          cue_added = true;
        }
      }
      i++;
    }
    EbmlBuf e;
    e.elem(ID_Cluster, cl);
    out.write(e.d.data(), e.d.size());
  }

  if (!cues.empty()) {
    EbmlBuf cs;
    for (auto& c : cues) {
      EbmlBuf cp;
      cp.uint_elem(ID_CueTime, uint64_t(std::max<int64_t>(c.ts, 0)));
      EbmlBuf ctp;
      ctp.uint_elem(ID_CueTrack, video_track_num);
      ctp.uint_elem(ID_CueClusterPosition, c.cluster_off);
      cp.elem(ID_CueTrackPositions, ctp);
      cs.elem(ID_CuePoint, cp);
    }
    EbmlBuf e;
    e.elem(ID_Cues, cs);
    out.write(e.d.data(), e.d.size());
  }
  for (auto& raw : extra_elements)
    if (!raw.empty()) out.write(raw.data(), raw.size());

  // patch the segment size (8-byte vint: 0x01 marker + 56-bit value)
  uint64_t seg_size = out.tell() - seg_payload_start;
  uint8_t szp[8];
  szp[0] = 0x01;
  for (int k = 0; k < 7; k++) szp[1 + k] = uint8_t(seg_size >> (8 * (6 - k)));
  out.write_at(seg_payload_start - 8, szp, 8);
}

// ------------------------------------------------------------- entry point

void concat_mkv(const std::vector<std::string>& parts,
                const std::string& original, const std::string& out_path) {
  if (parts.empty()) throw Error("no parts given");
  std::vector<std::unique_ptr<File>> files;
  std::vector<Movie> movies;
  for (auto& p : parts) {
    files.emplace_back(new File(p, "rb"));
    movies.push_back(parse_movie(*files.back()));
  }
  VideoStream vs = build_video_stream(files, movies);

  std::vector<OutBlock> blocks;
  std::vector<const MkvTrack*> copied_tracks;
  std::vector<std::vector<uint8_t>> extra;
  std::vector<std::pair<uint64_t, AudioCodec>> mp4_audio;
  double duration_s = vs.duration_s;

  MkvOriginal orig;  // keeps copied entry_raw alive
  std::unique_ptr<File> orig_mp4_file;
  Movie orig_mp4;
  uint64_t video_num = 1;
  uint64_t ts_scale = 1000000;  // ns/tick; mkv originals set their own

  bool orig_is_mkv = false;
  if (!original.empty()) {
    File probe(original, "rb");
    uint8_t magic[4] = {0, 0, 0, 0};
    if (probe.size() >= 4) probe.read_at(0, magic, 4);
    orig_is_mkv = rd32(magic) == ID_EBML;
  }

  if (!original.empty() && orig_is_mkv) {
    orig = parse_mkv(original);
    if (orig.ts_scale) ts_scale = orig.ts_scale;
    uint64_t max_num = 0;
    for (auto& t : orig.tracks)
      if (t.type != 1) max_num = std::max(max_num, t.number);
    video_num = max_num + 1;
    for (auto& t : orig.tracks)
      if (t.type != 1) copied_tracks.push_back(&t);
    for (auto& b : orig.blocks) {
      OutBlock ob;
      ob.ts = b.ts;
      ob.order = 1;
      ob.raw = std::move(b.raw);
      ob.relts_off = b.relts_off;
      blocks.push_back(std::move(ob));
    }
    if (!orig.chapters.empty()) {
      EbmlBuf e;
      e.elem(ID_Chapters, orig.chapters);
      extra.push_back(std::move(e.d));
    }
    if (!orig.tags.empty()) {
      EbmlBuf e;
      e.elem(ID_Tags, orig.tags);
      extra.push_back(std::move(e.d));
    }
    if (!orig.attachments.empty()) {
      EbmlBuf e;
      e.elem(ID_Attachments, orig.attachments);
      extra.push_back(std::move(e.d));
    }
  } else if (!original.empty()) {
    // mp4 original: remux audio tracks sample-by-sample
    orig_mp4_file.reset(new File(original, "rb"));
    orig_mp4 = parse_movie(*orig_mp4_file);
    // QuickTime chapter convention: any track listed in another track's
    // tref/chap is chapter METADATA, not a stream — convert it to a
    // Matroska Chapters element (the reference's -map_chapters 1)
    std::vector<uint32_t> chapter_track_ids;
    for (auto& t : orig_mp4.tracks)
      for (uint32_t id : t.chap_refs) chapter_track_ids.push_back(id);
    uint64_t next_num = 2;
    for (auto& t : orig_mp4.tracks) {
      if (!t.timescale) continue;
      bool is_chapter = false;
      for (uint32_t id : chapter_track_ids)
        is_chapter |= (t.track_id != 0 && id == t.track_id);
      if (is_chapter) {
        EbmlBuf atoms;
        uint64_t orig_size = orig_mp4_file->size();
        uint32_t n = bounded_sample_count(t, orig_size);
        std::vector<uint64_t> offs(n);
        uint32_t s = 0;
        for (uint32_t c = 0; c < t.chunk_offsets.size() && s < n; c++) {
          uint64_t o = t.chunk_offsets[c];
          uint32_t spc = t.samples_in_chunk(c);
          for (uint32_t k = 0; k < spc && s < n; k++) {
            offs[s] = o;
            o += t.sample_size(s);
            s++;
          }
        }
        uint64_t dts = 0;
        s = 0;
        uint64_t uid = 1;
        for (auto& e : t.stts) {
          for (uint32_t k = 0; k < e.count && s < n; k++) {
            uint32_t sz = t.sample_size(s);
            std::string title;
            // lied stsz entry / truncated chapter mdat: surface the error
            // BEFORE allocating sz bytes (read_at would catch it after);
            // overflow-safe against co64 offsets near 2^64
            if (offs[s] > orig_size || uint64_t(sz) > orig_size - offs[s])
              throw Error("mkv mux: chapter sample outside the original "
                          "file");
            if (sz >= 2) {
              std::vector<uint8_t> buf(sz);
              orig_mp4_file->read_at(offs[s], buf.data(), sz);
              uint32_t tl = (uint32_t(buf[0]) << 8) | buf[1];
              if (tl && tl <= sz - 2)
                title.assign(reinterpret_cast<char*>(buf.data() + 2), tl);
            }
            EbmlBuf atom;
            atom.uint_elem(ID_ChapterUID, uid++);
            atom.uint_elem(ID_ChapterTimeStart,
                           uint64_t(double(dts) * 1e9 / t.timescale));
            if (!title.empty()) {
              EbmlBuf disp;
              disp.str_elem(ID_ChapString, title);
              disp.str_elem(ID_ChapLanguage, "und");
              atom.elem(ID_ChapterDisplay, disp);
            }
            atoms.elem(ID_ChapterAtom, atom);
            dts += e.delta;
            s++;
          }
        }
        if (atoms.d.size()) {
          EbmlBuf ed;
          ed.uint_elem(ID_EditionFlagDefault, 1);
          ed.raw(atoms.d);
          EbmlBuf ch;
          ch.elem(ID_EditionEntry, ed);
          EbmlBuf e;
          e.elem(ID_Chapters, ch);
          extra.push_back(std::move(e.d));
        }
        continue;
      }
      bool is_audio = t.handler == "soun";
      // 3GPP timed text ('text'/'sbtl' handler, tx3g sample entries):
      // remuxed as Matroska S_TEXT/UTF8 — each tx3g sample is a u16 BE
      // text length + UTF-8 bytes (+ style boxes we drop); display time
      // comes from BlockDuration (the stts delta).  The reference's
      // `-map 1:s?` concat carries subtitle streams the same way
      // (reve-shared/src/lib.rs:181-204).
      bool is_text = t.handler == "text" || t.handler == "sbtl";
      AudioCodec ac;
      if (is_audio) {
        if (!map_audio_codec(t, &ac)) continue;
      } else if (is_text) {
        if (t.stsd.size() < 16 + 8) continue;
        std::string fmt(reinterpret_cast<const char*>(
                            t.stsd.data() + 16 + 4), 4);
        if (fmt != "tx3g") continue;
        ac.codec_id = "S_TEXT/UTF8";
        ac.track_type = 17;
      } else {
        continue;
      }
      uint64_t num = next_num++;
      mp4_audio.emplace_back(num, ac);
      uint64_t orig_size = orig_mp4_file->size();
      uint32_t n = bounded_sample_count(t, orig_size);
      std::vector<uint64_t> offs(n);
      uint32_t s = 0;
      for (uint32_t c = 0; c < t.chunk_offsets.size() && s < n; c++) {
        uint64_t o = t.chunk_offsets[c];
        uint32_t spc = t.samples_in_chunk(c);
        for (uint32_t k = 0; k < spc && s < n; k++) {
          offs[s] = o;
          o += t.sample_size(s);
          s++;
        }
      }
      if (s != n) throw Error("mkv mux: audio stsc/stco inconsistent");
      uint64_t dts = 0;
      s = 0;
      for (auto& e : t.stts) {
        for (uint32_t k = 0; k < e.count && s < n; k++) {
          OutBlock ob;
          ob.ts = int64_t(double(dts) * 1e9 /
                          (double(t.timescale) * double(ts_scale)));
          ob.order = 1;
          ob.track = num;
          ob.key = true;
          ob.file = orig_mp4_file.get();
          ob.file_off = offs[s];
          ob.size = t.sample_size(s);
          // lied stsz entry: the cluster writer allocates ob.size bytes,
          // so refuse samples that reach past the source file
          // (overflow-safe against co64 offsets near 2^64)
          if (ob.file_off > orig_size ||
              uint64_t(ob.size) > orig_size - ob.file_off)
            throw Error("mkv mux: audio sample outside the original file");
          if (is_text) {
            // strip the tx3g u16 length prefix; empty text = a gap
            // (no subtitle displayed) -> no block at all
            uint8_t lenb[2] = {0, 0};
            if (ob.size < 2) { dts += e.delta; s++; continue; }
            orig_mp4_file->read_at(ob.file_off, lenb, 2);
            uint32_t text_len = (uint32_t(lenb[0]) << 8) | lenb[1];
            if (!text_len || text_len > ob.size - 2) {
              dts += e.delta;
              s++;
              continue;
            }
            ob.file_off += 2;
            ob.size = text_len;
            ob.duration = uint64_t(
                double(e.delta) * 1e9 /
                (double(t.timescale) * double(ts_scale)));
          }
          blocks.push_back(std::move(ob));
          dts += e.delta;
          s++;
        }
      }
    }
    video_num = 1;
  }

  for (auto& smp : vs.samples) {
    OutBlock ob;
    ob.ts = int64_t(double(smp.ts_ns) / double(ts_scale));
    ob.order = 0;
    ob.track = video_num;
    ob.key = smp.key;
    ob.file = smp.file;
    ob.file_off = smp.file_off;
    ob.size = smp.size;
    blocks.push_back(std::move(ob));
  }
  for (auto& b : blocks)
    duration_s = std::max(duration_s,
                          double(b.ts) * double(ts_scale) / 1e9);

  write_mkv(out_path, vs, video_num, copied_tracks, blocks, extra,
            mp4_audio, duration_s, ts_scale);
}

// quick structural probe (tests / io chain)
struct MkvProbe {
  int32_t width = 0, height = 0;
  int64_t video_blocks = 0;
  int32_t n_tracks = 0;
  int32_t has_audio = 0;
  double duration_s = 0;
};

MkvProbe probe_mkv(const std::string& path) {
  File f(path, "rb");
  FileEbml r{f, f.size()};
  uint32_t eid;
  uint64_t sz;
  if (!r.read_head(&eid, &sz) || eid != ID_EBML) throw Error("not an mkv");
  if (sz == UINT64_MAX) throw Error("mkv: unknown-size header");
  r.pos += sz;
  if (!r.read_head(&eid, &sz) || eid != ID_Segment)
    throw Error("mkv: no Segment");
  uint64_t seg_end = sz == UINT64_MAX ? r.size : r.pos + sz;
  if (seg_end > r.size) seg_end = r.size;
  MkvProbe pr;
  uint64_t ts_scale = 1000000;
  std::vector<uint64_t> video_tracks;
  while (r.pos < seg_end) {
    if (!r.read_head(&eid, &sz)) break;
    if (sz == UINT64_MAX) throw Error("mkv: unknown-size element");
    if (sz > seg_end || r.pos > seg_end - sz) break;
    if (eid != ID_Info && eid != ID_Tracks && eid != ID_Cluster) {
      r.pos += sz;
      continue;
    }
    std::vector<uint8_t> data = r.read_payload(sz);
    const uint8_t* d = data.data();
    uint64_t payload = 0, end = sz;
    if (eid == ID_Info) {
      for (auto& e : ebml_children(d, payload, end)) {
        if (e.id == ID_TimestampScale) ts_scale = ebml_uint(d + e.off, e.len);
        if (e.id == ID_Duration) {
          if (e.len == 8) {
            uint64_t bits = rd64(d + e.off);
            std::memcpy(&pr.duration_s, &bits, 8);
          } else if (e.len == 4) {
            uint32_t bits = rd32(d + e.off);
            float v;
            std::memcpy(&v, &bits, 4);
            pr.duration_s = v;
          }
        }
      }
      pr.duration_s *= double(ts_scale) / 1e9;
    } else if (eid == ID_Tracks) {
      for (auto& e : ebml_children(d, payload, end)) {
        if (e.id != ID_TrackEntry) continue;
        pr.n_tracks++;
        uint8_t type = 0;
        uint64_t num = 0;
        int32_t vw = 0, vh = 0;
        // element order inside a TrackEntry is unconstrained: collect
        // first, interpret after
        for (auto& c : ebml_children(d, e.off, e.off + e.len)) {
          if (c.id == ID_TrackType) type = uint8_t(ebml_uint(d + c.off, c.len));
          if (c.id == ID_TrackNumber) num = ebml_uint(d + c.off, c.len);
          if (c.id == ID_Video) {
            for (auto& v : ebml_children(d, c.off, c.off + c.len)) {
              if (v.id == ID_PixelWidth)
                vw = int32_t(ebml_uint(d + v.off, v.len));
              if (v.id == ID_PixelHeight)
                vh = int32_t(ebml_uint(d + v.off, v.len));
            }
          }
        }
        if (type == 1) {
          video_tracks.push_back(num);
          if (vw) pr.width = vw;
          if (vh) pr.height = vh;
        }
        if (type == 2) pr.has_audio = 1;
      }
    } else if (eid == ID_Cluster) {
      for (auto& e : ebml_children(d, payload, end)) {
        uint64_t boff = 0, blen = 0;
        if (e.id == ID_SimpleBlock) {
          boff = e.off;
          blen = e.len;
        } else if (e.id == ID_BlockGroup) {
          for (auto& g : ebml_children(d, e.off, e.off + e.len))
            if (g.id == ID_Block) { boff = g.off; blen = g.len; break; }
        }
        if (!blen) continue;
        uint64_t trk = block_track(d + boff, blen);
        for (uint64_t v : video_tracks)
          if (v == trk) { pr.video_blocks++; break; }
      }
    }
  }
  return pr;
}

}  // namespace mkv
}  // namespace reve

// ----------------------------------------------------------------- C ABI ---

extern "C" {

const char* rc_last_error();  // defined in mp4.cpp
void rc_set_error(const char* what);

int rc_concat_mkv(const char** parts, int n_parts, const char* original,
                  const char* out_path) {
  try {
    std::vector<std::string> ps(parts, parts + n_parts);
    reve::mkv::concat_mkv(ps, original ? original : "", out_path);
    return 0;
  } catch (const std::exception& e) {
    rc_set_error(e.what());
    return -1;
  }
}

int rc_probe_mkv(const char* path, int32_t* width, int32_t* height,
                 int64_t* video_blocks, double* duration_s,
                 int32_t* n_tracks, int32_t* has_audio) {
  try {
    auto r = reve::mkv::probe_mkv(path);
    *width = r.width;
    *height = r.height;
    *video_blocks = r.video_blocks;
    *duration_s = r.duration_s;
    *n_tracks = r.n_tracks;
    *has_audio = r.has_audio;
    return 0;
  } catch (const std::exception& e) {
    rc_set_error(e.what());
    return -1;
  }
}

}  // extern "C"
