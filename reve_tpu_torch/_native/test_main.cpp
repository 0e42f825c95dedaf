// Sanitizer test harness for the native core (built with ASan/UBSan by
// tests/test_native_sanitized.py).  Exercises probe, video-only concat,
// audio remux, and corrupt-input rejection on files passed via argv.
//
// Usage: reve_core_test <part1.mp4> <part2.mp4> <original_or_-> <out.mp4>
//        [corrupt1] [corrupt2] ...
// Exits 0 on success (including expected failures on corrupt inputs).

#include <cstdio>
#include <cstring>
#include <string>

extern "C" {
const char* rc_last_error();
int rc_concat_mp4(const char** parts, int n_parts, const char* original,
                  const char* out_path);
int rc_concat_mkv(const char** parts, int n_parts, const char* original,
                  const char* out_path);
int rc_probe_mkv(const char* path, int* width, int* height,
                 long long* video_blocks, double* duration_s,
                 int* n_tracks, int* has_audio);
int rc_probe_mp4(const char* path, int* width, int* height,
                 long long* video_samples, long long* timescale,
                 long long* duration, int* n_tracks, int* has_audio);
long rc_plan_segments(long frames, long segsize, long* starts, long* sizes,
                      long cap);
int rc_concat_y4m(const char** parts, long n_parts, const char* output);
int rc_probe_y4m(const char* path, long* width, long* height, long* fps_num,
                 long* fps_den, long* frames);
}

// Writes a tiny 4x2 C420 y4m with `frames` gray frames.
static int write_y4m(const char* path, int frames, int shade) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  std::fprintf(f, "YUV4MPEG2 W4 H2 F24:1 Ip A1:1 C420\n");
  for (int i = 0; i < frames; i++) {
    std::fprintf(f, "FRAME\n");
    unsigned char y[8], uv[4] = {128, 128, 128, 128};  // 2x1 u + 2x1 v
    std::memset(y, shade + i * 3, sizeof(y));
    std::fwrite(y, 1, 8, f);
    std::fwrite(uv, 1, 4, f);
  }
  std::fclose(f);
  return 0;
}

static int probe(const char* path, bool expect_ok) {
  int w, h, ntracks, has_audio;
  long long samples, ts, dur;
  int rc = rc_probe_mp4(path, &w, &h, &samples, &ts, &dur, &ntracks,
                        &has_audio);
  if (expect_ok && rc != 0) {
    std::fprintf(stderr, "probe(%s) failed: %s\n", path, rc_last_error());
    return 1;
  }
  if (!expect_ok && rc == 0) {
    std::fprintf(stderr, "probe(%s) unexpectedly succeeded\n", path);
    return 1;
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr, "need part1 part2 original|- out [corrupt...]\n");
    return 2;
  }
  const char* parts[2] = {argv[1], argv[2]};
  const char* original = std::strcmp(argv[3], "-") ? argv[3] : nullptr;
  const char* out = argv[4];

  long starts[64], sizes[64];
  if (rc_plan_segments(1001, 250, starts, sizes, 64) != 5) return 1;
  if (starts[4] != 1000 || sizes[4] != 1) return 1;

  if (probe(parts[0], true)) return 1;
  if (rc_concat_mp4(parts, 2, original, out) != 0) {
    std::fprintf(stderr, "concat failed: %s\n", rc_last_error());
    return 1;
  }
  if (probe(out, true)) return 1;

  // video-only concat (no original): the output mvhd is copied from
  // parts[0], so a version-1 mvhd part exercises patch_mvhd's v1 layout
  // under the sanitizers.
  std::string out2 = std::string(out) + ".noaudio.mp4";
  if (rc_concat_mp4(parts, 2, nullptr, out2.c_str()) != 0) {
    std::fprintf(stderr, "video-only concat failed: %s\n", rc_last_error());
    return 1;
  }
  if (probe(out2.c_str(), true)) return 1;

  // Matroska mux under the sanitizers: video-only, mp4-original audio
  // remux, and mkv-original verbatim-copy remux chained together.
  std::string mkv1 = std::string(out) + ".1.mkv";
  std::string mkv2 = std::string(out) + ".2.mkv";
  std::string mkv3 = std::string(out) + ".3.mkv";
  if (rc_concat_mkv(parts, 2, nullptr, mkv1.c_str()) != 0) {
    std::fprintf(stderr, "mkv concat failed: %s\n", rc_last_error());
    return 1;
  }
  if (rc_concat_mkv(parts, 2, original, mkv2.c_str()) != 0) {
    std::fprintf(stderr, "mkv concat+mp4 audio failed: %s\n",
                 rc_last_error());
    return 1;
  }
  if (rc_concat_mkv(parts, 2, mkv2.c_str(), mkv3.c_str()) != 0) {
    std::fprintf(stderr, "mkv concat+mkv original failed: %s\n",
                 rc_last_error());
    return 1;
  }
  {
    int w, h, ntracks, has_audio;
    long long blocks;
    double dur;
    if (rc_probe_mkv(mkv3.c_str(), &w, &h, &blocks, &dur, &ntracks,
                     &has_audio) != 0) {
      std::fprintf(stderr, "mkv probe failed: %s\n", rc_last_error());
      return 1;
    }
    if (blocks <= 0) { std::fprintf(stderr, "mkv probe: no blocks\n"); return 1; }
  }

  // y4m stream-copy concat + probe under the sanitizers.
  {
    std::string y1 = std::string(out) + ".a.y4m";
    std::string y2 = std::string(out) + ".b.y4m";
    std::string yc = std::string(out) + ".cat.y4m";
    if (write_y4m(y1.c_str(), 3, 40) || write_y4m(y2.c_str(), 2, 90)) {
      std::fprintf(stderr, "y4m fixture write failed\n");
      return 1;
    }
    const char* yparts[2] = {y1.c_str(), y2.c_str()};
    if (rc_concat_y4m(yparts, 2, yc.c_str()) != 0) {
      std::fprintf(stderr, "y4m concat failed: %s\n", rc_last_error());
      return 1;
    }
    long w, h, fn, fd, fr;
    if (rc_probe_y4m(yc.c_str(), &w, &h, &fn, &fd, &fr) != 0 || fr != 5) {
      std::fprintf(stderr, "y4m probe failed (%s), frames=%ld\n",
                   rc_last_error(), fr);
      return 1;
    }
  }

  // corrupt inputs must not crash (no sanitizer report).  Rejection
  // strictness for truncated/garbage files is asserted by the Python tests
  // (tests/test_native.py); here table-count-lie fixtures may parse with
  // clamped tables, so tolerate either outcome.
  for (int i = 5; i < argc; i++) {
    const char* bad[1] = {argv[i]};
    (void)rc_concat_mp4(bad, 1, nullptr, "/dev/null");
    (void)rc_concat_mkv(bad, 1, nullptr, "/dev/null");
    (void)rc_concat_mp4(parts, 2, argv[i], "/dev/null");
    (void)rc_concat_mkv(parts, 2, argv[i], "/dev/null");
    int w, h, ntracks, has_audio;
    long long samples, ts, dur;
    (void)rc_probe_mp4(argv[i], &w, &h, &samples, &ts, &dur, &ntracks,
                       &has_audio);
    long long blocks;
    double dsec;
    (void)rc_probe_mkv(argv[i], &w, &h, &blocks, &dsec, &ntracks,
                       &has_audio);
    long lw, lh, fn, fd, fr;
    (void)rc_probe_y4m(argv[i], &lw, &lh, &fn, &fd, &fr);
    (void)rc_concat_y4m(bad, 1, "/dev/null");
  }
  std::puts("sanitized native core: ok");
  return 0;
}
