// reve_core — native YUV4MPEG2 (.y4m) stream-copy concatenation.
//
// The reference finalizes jobs with `ffmpeg -f concat ... -c copy`
// (reve-shared/src/lib.rs:181-204): video parts are STREAM-COPIED, never
// re-encoded.  For the framework's codec-free y4m path (the hermetic-test
// backend and the 10-bit output path, io/writer.py Y4MWriter) the previous
// fallback was rewrite_concat — a YUV->RGB->YUV round trip per frame that
// is not byte-exact.  This muxer restores the reference's stream-copy
// semantics for y4m: parse each part's header, validate the geometry
// matches, and splice the frame bytes verbatim.
//
// Format: one ASCII header line "YUV4MPEG2 W<w> H<h> F<n>:<d> ... C<chroma>",
// then per frame an ASCII "FRAME[ params]\n" line followed by raw planes.
// Frames are self-delimiting, so concatenation = first part's header line +
// every part's bytes after its own header.
//
// No external dependencies; C++17; C ABI at the bottom.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace reve {
namespace y4m {

struct Header {
  std::string line;  // full header line, without the trailing '\n'
  long width = 0, height = 0;
  long fps_num = 0, fps_den = 0;
  std::string chroma = "420jpeg";  // y4m default when C is absent
};

struct File {
  std::FILE* f = nullptr;
  ~File() {
    if (f) std::fclose(f);
  }
};

// Reads the header line (capped at 4 KiB) and leaves the stream positioned
// at the first FRAME marker.
static Header parse_header(std::FILE* f, const std::string& path) {
  std::string line;
  for (;;) {
    int c = std::fgetc(f);
    if (c == EOF) throw std::runtime_error(path + ": truncated y4m header");
    if (c == '\n') break;
    line.push_back(static_cast<char>(c));
    if (line.size() > 4096)
      throw std::runtime_error(path + ": y4m header too long");
  }
  if (line.rfind("YUV4MPEG2", 0) != 0)
    throw std::runtime_error(path + ": not a y4m file");
  Header h;
  h.line = line;
  size_t pos = 9;  // after the magic
  while (pos < line.size()) {
    while (pos < line.size() && line[pos] == ' ') pos++;
    size_t end = line.find(' ', pos);
    if (end == std::string::npos) end = line.size();
    if (end > pos) {
      const std::string tok = line.substr(pos, end - pos);
      switch (tok[0]) {
        case 'W': h.width = std::atol(tok.c_str() + 1); break;
        case 'H': h.height = std::atol(tok.c_str() + 1); break;
        case 'F': {
          const char* colon = std::strchr(tok.c_str(), ':');
          h.fps_num = std::atol(tok.c_str() + 1);
          h.fps_den = colon ? std::atol(colon + 1) : 1;
          break;
        }
        case 'C': h.chroma = tok.substr(1); break;
        default: break;  // Ip / A1:1 / X comments: pass through verbatim
      }
    }
    pos = end;
  }
  if (h.width <= 0 || h.height <= 0)
    throw std::runtime_error(path + ": y4m header missing W/H");
  // sanity bounds: keep frame_bytes and the fps cross-products far from
  // long overflow on hostile headers (atol silently saturates/overflows)
  if (h.width > (1L << 20) || h.height > (1L << 20) ||
      h.fps_num < 0 || h.fps_den < 0 ||
      h.fps_num > 1000000000L || h.fps_den > 1000000000L)
    throw std::runtime_error(path + ": implausible y4m header values");
  return h;
}

static void concat(const std::vector<std::string>& parts,
                   const std::string& output) {
  if (parts.empty()) throw std::runtime_error("no parts to concatenate");

  File out;
  out.f = std::fopen(output.c_str(), "wb");
  if (!out.f) throw std::runtime_error("cannot open output: " + output);

  Header first;
  std::vector<uint8_t> buf(1 << 20);
  for (size_t i = 0; i < parts.size(); i++) {
    File in;
    in.f = std::fopen(parts[i].c_str(), "rb");
    if (!in.f) throw std::runtime_error("cannot open part: " + parts[i]);
    Header h = parse_header(in.f, parts[i]);
    if (i == 0) {
      first = h;
      const std::string line = h.line + "\n";
      if (std::fwrite(line.data(), 1, line.size(), out.f) != line.size())
        throw std::runtime_error("short write: " + output);
    } else if (h.width != first.width || h.height != first.height ||
               h.chroma != first.chroma ||
               // compare fps as a cross-product (25:1 == 50:2)
               h.fps_num * first.fps_den != first.fps_num * h.fps_den) {
      throw std::runtime_error(
          parts[i] + ": geometry mismatch (" + std::to_string(h.width) + "x" +
          std::to_string(h.height) + " F" + std::to_string(h.fps_num) + ":" +
          std::to_string(h.fps_den) + " C" + h.chroma + " vs first part " +
          std::to_string(first.width) + "x" + std::to_string(first.height) +
          " F" + std::to_string(first.fps_num) + ":" +
          std::to_string(first.fps_den) + " C" + first.chroma + ")");
    }
    // splice the rest of the part (FRAME lines + planes) verbatim
    for (;;) {
      size_t n = std::fread(buf.data(), 1, buf.size(), in.f);
      if (n == 0) {
        if (std::ferror(in.f))
          throw std::runtime_error("read error: " + parts[i]);
        break;
      }
      if (std::fwrite(buf.data(), 1, n, out.f) != n)
        throw std::runtime_error("short write: " + output);
    }
  }
  if (std::fflush(out.f) != 0)
    throw std::runtime_error("flush failed: " + output);
}

}  // namespace y4m
}  // namespace reve

// ------------------------------------------------------------------- C ABI

extern "C" {
const char* rc_last_error();  // defined in mp4.cpp
void rc_set_error(const char* what);

// Stream-copy concat of y4m parts into one y4m file.  Returns 0 on success.
int rc_concat_y4m(const char** parts, long n_parts, const char* output) {
  try {
    std::vector<std::string> p;
    for (long i = 0; i < n_parts; i++) p.emplace_back(parts[i]);
    reve::y4m::concat(p, output);
    return 0;
  } catch (const std::exception& e) {
    rc_set_error(e.what());
    return 1;
  }
}

// Probe a y4m file: fills width/height/fps and the exact frame count
// (walks the FRAME markers — robust to FRAME parameter strings, unlike a
// file-size division).  Returns 0 on success.
int rc_probe_y4m(const char* path, long* width, long* height, long* fps_num,
                 long* fps_den, long* frames) {
  try {
    reve::y4m::File in;
    in.f = std::fopen(path, "rb");
    if (!in.f) throw std::runtime_error(std::string("cannot open: ") + path);
    reve::y4m::Header h = reve::y4m::parse_header(in.f, path);
    long bpe = h.chroma.find("p10") != std::string::npos ||
                       h.chroma.find("p12") != std::string::npos ||
                       h.chroma.find("p16") != std::string::npos
                   ? 2
                   : 1;
    long denom = 0;  // chroma plane pixels per 4 luma pixels
    if (h.chroma.rfind("420", 0) == 0) denom = 1;
    else if (h.chroma.rfind("422", 0) == 0) denom = 2;
    else if (h.chroma.rfind("444", 0) == 0) denom = 4;
    else if (h.chroma.rfind("mono", 0) == 0) denom = 0;
    else throw std::runtime_error(path + (": unsupported chroma C" + h.chroma));
    // per-plane rounding: 420/422 chroma planes are ceil(w/2) wide (and
    // ceil(h/2) tall for 420) — (w*h*denom)/4 undercounts odd dimensions
    long cw, ch;
    if (denom == 1) { cw = (h.width + 1) / 2; ch = (h.height + 1) / 2; }
    else if (denom == 2) { cw = (h.width + 1) / 2; ch = h.height; }
    else if (denom == 4) { cw = h.width; ch = h.height; }
    else { cw = 0; ch = 0; }
    const long frame_bytes = (h.width * h.height + 2 * cw * ch) * bpe;
    const long data_start = std::ftell(in.f);
    std::fseek(in.f, 0, SEEK_END);
    const long file_size = std::ftell(in.f);
    std::fseek(in.f, data_start, SEEK_SET);
    long count = 0;
    std::string line;
    for (;;) {
      line.clear();
      int c;
      while ((c = std::fgetc(in.f)) != EOF && c != '\n') {
        line.push_back(static_cast<char>(c));
        if (line.size() > 4096)  // bounded read: a corrupt file without
          // newlines must not force a near-file-size allocation
          throw std::runtime_error(std::string(path) +
                                   ": FRAME marker line too long");
      }
      if (c == EOF) break;  // torn tail: a marker cut mid-line cannot be
                            // followed by a complete frame — stop counting
      if (line.rfind("FRAME", 0) != 0)
        throw std::runtime_error(std::string(path) + ": bad FRAME marker");
      if (std::ftell(in.f) + frame_bytes > file_size)
        break;  // torn tail frame: stop counting
      std::fseek(in.f, frame_bytes, SEEK_CUR);
      count++;
    }
    if (width) *width = h.width;
    if (height) *height = h.height;
    if (fps_num) *fps_num = h.fps_num;
    if (fps_den) *fps_den = h.fps_den ? h.fps_den : 1;
    if (frames) *frames = count;
    return 0;
  } catch (const std::exception& e) {
    rc_set_error(e.what());
    return 1;
  }
}
}  // extern "C"
