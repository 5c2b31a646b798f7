// Native audio runtime of the PyTorch port (a copy of the JAX package's,
// kept here so that the port reads no file of that package).
//
// A small, dependency-free C++ library driven from Python over ctypes:
//
//   * RIFF/WAVE decode (PCM 8/16/24/32 + IEEE float) -> mono float32
//   * WAV encode (PCM16)
//   * waveform preprocessing: peak-normalize, pre-emphasis
//   * a thread-pool batch decoder that fills a caller-provided padded
//     [batch, max_len] float32 matrix in one call (decode happens off the
//     GIL while Python collates).
//
// Build: native/__init__.py compiles it with the host compiler at first use
// (g++ -O3 -std=c++17 -fPIC -shared -pthread) into build/torch_native/.
// Python falls back to the numpy codec in data/wavio.py when the build
// fails.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
  bool ok = false;
  std::string error;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

WavData decode_wav(const uint8_t* data, size_t n) {
  WavData out;
  if (n < 12 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0) {
    out.error = "not a RIFF/WAVE file";
    return out;
  }
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* payload = nullptr;
  size_t payload_len = 0;
  while (pos + 8 <= n) {
    const uint8_t* cid = data + pos;
    uint32_t size = rd_u32(data + pos + 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + size > n) size = (uint32_t)(n - pos - 8);
    if (memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      sr = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE) fmt = (bits == 32) ? 3 : 1;  // WAVE_FORMAT_EXTENSIBLE
    } else if (memcmp(cid, "data", 4) == 0) {
      payload = body;
      payload_len = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!payload || channels == 0) {
    out.error = "missing fmt/data chunk";
    return out;
  }
  size_t frame_bytes = (size_t)channels * bits / 8;
  if (frame_bytes == 0) {
    out.error = "bad frame size";
    return out;
  }
  size_t frames = payload_len / frame_bytes;
  out.samples.resize(frames);
  const double inv_ch = 1.0 / channels;
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = payload + i * frame_bytes + (size_t)c * bits / 8;
      double v = 0.0;
      if (fmt == 3 && bits == 32) {  // IEEE float
        float f;
        memcpy(&f, p, 4);
        v = f;
      } else if (fmt == 1 && bits == 16) {
        int16_t s = (int16_t)rd_u16(p);
        v = s / 32768.0;
      } else if (fmt == 1 && bits == 24) {
        int32_t s = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
        if (s >= (1 << 23)) s -= (1 << 24);
        v = s / 8388608.0;
      } else if (fmt == 1 && bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (fmt == 1 && bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      } else {
        out.error = "unsupported format";
        return out;
      }
      acc += v;
    }
    out.samples[i] = (float)(acc * inv_ch);
  }
  out.sample_rate = (int)sr;
  out.ok = true;
  return out;
}

WavData read_wav_file(const char* path) {
  WavData out;
  FILE* f = fopen(path, "rb");
  if (!f) {
    out.error = "cannot open file";
    return out;
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)n);
  size_t got = fread(buf.data(), 1, (size_t)n, f);
  fclose(f);
  if ((long)got != n) {
    out.error = "short read";
    return out;
  }
  return decode_wav(buf.data(), buf.size());
}

}  // namespace

extern "C" {

// ---- single-file API -----------------------------------------------------

// Returns sample count, or -1 on error. sr_out receives the sample rate.
long sevit_wav_info(const char* path, int* sr_out) {
  WavData w = read_wav_file(path);
  if (!w.ok) return -1;
  if (sr_out) *sr_out = w.sample_rate;
  return (long)w.samples.size();
}

// Decode into caller buffer of capacity cap; returns samples written or -1.
long sevit_wav_read(const char* path, float* out, long cap, int* sr_out) {
  WavData w = read_wav_file(path);
  if (!w.ok) return -1;
  if (sr_out) *sr_out = w.sample_rate;
  long n = (long)w.samples.size();
  if (n > cap) n = cap;
  memcpy(out, w.samples.data(), (size_t)n * sizeof(float));
  return n;
}

// Write mono float32 samples as PCM16 WAV. Returns 0 on success.
int sevit_wav_write(const char* path, const float* x, long n, int sr) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t payload = (uint32_t)(n * 2);
  uint8_t hdr[44];
  memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + payload;
  memcpy(hdr + 4, &riff, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmtsize = 16;
  memcpy(hdr + 16, &fmtsize, 4);
  uint16_t fmt = 1, ch = 1, bits = 16;
  uint32_t brate = (uint32_t)sr * 2;
  uint16_t balign = 2;
  memcpy(hdr + 20, &fmt, 2);
  memcpy(hdr + 22, &ch, 2);
  uint32_t sru = (uint32_t)sr;
  memcpy(hdr + 24, &sru, 4);
  memcpy(hdr + 28, &brate, 4);
  memcpy(hdr + 32, &balign, 2);
  memcpy(hdr + 34, &bits, 2);
  memcpy(hdr + 36, "data", 4);
  memcpy(hdr + 40, &payload, 4);
  fwrite(hdr, 1, 44, f);
  std::vector<int16_t> pcm((size_t)n);
  for (long i = 0; i < n; ++i) {
    float v = x[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    pcm[(size_t)i] = (int16_t)(v * 32767.0f);
  }
  fwrite(pcm.data(), 2, (size_t)n, f);
  fclose(f);
  return 0;
}

// ---- preprocessing -------------------------------------------------------

// In-place peak normalization to target level; returns the original peak.
float sevit_peak_normalize(float* x, long n, float target) {
  float peak = 0.0f;
  for (long i = 0; i < n; ++i) {
    float a = x[i] < 0 ? -x[i] : x[i];
    if (a > peak) peak = a;
  }
  if (peak > 0.0f) {
    float s = target / peak;
    for (long i = 0; i < n; ++i) x[i] *= s;
  }
  return peak;
}

// In-place pre-emphasis y[n] = x[n] - coef*x[n-1].
void sevit_pre_emphasis(float* x, long n, float coef) {
  float prev = 0.0f;
  for (long i = 0; i < n; ++i) {
    float cur = x[i];
    x[i] = (i == 0) ? cur : cur - coef * prev;
    prev = cur;
  }
}

// ---- threaded batch decoder ---------------------------------------------

// Decode `count` wav files into a pre-allocated [count, max_len] row-major
// matrix (zero-padded). lengths[i] receives each file's sample count
// (clamped to max_len); rates[i] the sample rate; lengths[i] = -1 on error.
// `normalize` != 0 applies peak normalization to `target` per utterance.
void sevit_decode_batch(const char** paths, long count, float* out,
                        long max_len, long* lengths, int* rates,
                        int normalize, float target, int num_threads) {
  if (num_threads <= 0) num_threads = (int)std::thread::hardware_concurrency();
  if (num_threads <= 0) num_threads = 2;
  std::atomic<long> next(0);
  auto worker = [&]() {
    while (true) {
      long i = next.fetch_add(1);
      if (i >= count) return;
      WavData w = read_wav_file(paths[i]);
      float* row = out + i * max_len;
      memset(row, 0, (size_t)max_len * sizeof(float));
      if (!w.ok) {
        lengths[i] = -1;
        rates[i] = 0;
        continue;
      }
      long n = (long)w.samples.size();
      if (n > max_len) n = max_len;
      memcpy(row, w.samples.data(), (size_t)n * sizeof(float));
      if (normalize) sevit_peak_normalize(row, n, target);
      lengths[i] = n;
      rates[i] = w.sample_rate;
    }
  };
  std::vector<std::thread> threads;
  int t = (int)std::min<long>(num_threads, count);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

int sevit_version() { return 1; }

}  // extern "C"
