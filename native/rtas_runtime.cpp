// rtas_runtime — native host-runtime pieces for real_time_audio_sync_tpu.
//
// The reference's real-time transport is PortAudio's C ring buffer polled
// from Python (ims/audio.py:64-74).  This library provides the accelerator-host
// equivalents:
//
//  * a lock-free single-producer/single-consumer float ring buffer for the
//    audio-callback → follower handoff (acquire/release atomics, no locks,
//    wait-free on both sides);
//  * a RIFF/WAV PCM16 decoder with channel averaging (the hot part of
//    librosa.load for this corpus) so wav ingest doesn't round-trip through
//    Python byte handling.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer
// ---------------------------------------------------------------------------

struct RtasRing {
  float* data;
  size_t capacity;  // power of two
  size_t mask;
  std::atomic<size_t> head;  // write index (producer)
  std::atomic<size_t> tail;  // read index (consumer)
};

static size_t next_pow2(size_t x) {
  size_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

RtasRing* rtas_ring_create(size_t min_capacity) {
  RtasRing* r = new RtasRing();
  r->capacity = next_pow2(min_capacity < 2 ? 2 : min_capacity);
  r->mask = r->capacity - 1;
  r->data = static_cast<float*>(malloc(r->capacity * sizeof(float)));
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  return r;
}

void rtas_ring_destroy(RtasRing* r) {
  if (!r) return;
  free(r->data);
  delete r;
}

size_t rtas_ring_capacity(const RtasRing* r) { return r->capacity; }

size_t rtas_ring_readable(const RtasRing* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

size_t rtas_ring_writable(const RtasRing* r) {
  return r->capacity - rtas_ring_readable(r);
}

// Producer side: returns the number of samples actually written (may be
// short when the ring is full — same contract as PortAudio's WriteRingBuffer).
size_t rtas_ring_push(RtasRing* r, const float* src, size_t n) {
  size_t head = r->head.load(std::memory_order_relaxed);
  size_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_space = r->capacity - (head - tail);
  if (n > free_space) n = free_space;
  for (size_t i = 0; i < n; ++i) {
    r->data[(head + i) & r->mask] = src[i];
  }
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer side: returns the number of samples actually read.
size_t rtas_ring_pop(RtasRing* r, float* dst, size_t n) {
  size_t tail = r->tail.load(std::memory_order_relaxed);
  size_t head = r->head.load(std::memory_order_acquire);
  size_t avail = head - tail;
  if (n > avail) n = avail;
  for (size_t i = 0; i < n; ++i) {
    dst[i] = r->data[(tail + i) & r->mask];
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ---------------------------------------------------------------------------
// WAV PCM16 decode (RIFF parse + int16 → float32 with channel averaging)
// ---------------------------------------------------------------------------

// Returns the number of mono frames, or a negative error code.
// out must hold at least rtas_wav_frames(...) floats.
//  -1: cannot open   -2: not RIFF/WAVE   -3: unsupported format
int64_t rtas_wav_decode(const char* path, float* out, int64_t out_capacity,
                        int32_t* sample_rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  uint32_t riff_size;
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "RIFF", 4) != 0 ||
      fread(&riff_size, 4, 1, f) != 1 || fread(magic, 1, 4, f) != 4 ||
      memcmp(magic, "WAVE", 4) != 0) {
    fclose(f);
    return -2;
  }
  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  int64_t frames = -3;
  while (fread(magic, 1, 4, f) == 4) {
    uint32_t chunk_size;
    if (fread(&chunk_size, 4, 1, f) != 1) break;
    if (memcmp(magic, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (chunk_size < 16 || fread(fmt, 1, 16, f) != 16) break;
      memcpy(&audio_format, fmt + 0, 2);
      memcpy(&channels, fmt + 2, 2);
      memcpy(&rate, fmt + 4, 4);
      memcpy(&bits, fmt + 14, 2);
      if (chunk_size > 16) fseek(f, chunk_size - 16, SEEK_CUR);
    } else if (memcmp(magic, "data", 4) == 0) {
      if (audio_format != 1 || bits != 16 || channels == 0) break;
      int64_t n_frames = chunk_size / (2 * channels);
      if (n_frames > out_capacity) n_frames = out_capacity;
      const int64_t kBlock = 1 << 16;
      int16_t* buf = static_cast<int16_t*>(malloc(kBlock * channels * 2));
      int64_t done = 0;
      const float inv_scale = 1.0f / 32768.0f;
      const float inv_ch = 1.0f / static_cast<float>(channels);
      while (done < n_frames) {
        int64_t want = n_frames - done;
        if (want > kBlock) want = kBlock;
        size_t got = fread(buf, 2 * channels, want, f);
        if (got == 0) break;
        for (size_t i = 0; i < got; ++i) {
          float acc = 0.0f;
          for (uint16_t ch = 0; ch < channels; ++ch) {
            acc += static_cast<float>(buf[i * channels + ch]) * inv_scale;
          }
          out[done + i] = acc * inv_ch;
        }
        done += static_cast<int64_t>(got);
      }
      free(buf);
      frames = done;
      break;
    } else {
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (sample_rate_out) *sample_rate_out = static_cast<int32_t>(rate);
  return frames;
}

// Number of mono frames in the wav (for buffer sizing); negative on error.
int64_t rtas_wav_frames(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  uint32_t sz;
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "RIFF", 4) != 0 ||
      fread(&sz, 4, 1, f) != 1 || fread(magic, 1, 4, f) != 4 ||
      memcmp(magic, "WAVE", 4) != 0) {
    fclose(f);
    return -2;
  }
  uint16_t channels = 0;
  int64_t frames = -3;
  while (fread(magic, 1, 4, f) == 4) {
    uint32_t chunk_size;
    if (fread(&chunk_size, 4, 1, f) != 1) break;
    if (memcmp(magic, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (chunk_size < 16 || fread(fmt, 1, 16, f) != 16) break;
      memcpy(&channels, fmt + 2, 2);
      if (chunk_size > 16) fseek(f, chunk_size - 16, SEEK_CUR);
    } else if (memcmp(magic, "data", 4) == 0) {
      if (channels) frames = static_cast<int64_t>(chunk_size) / (2 * channels);
      break;
    } else {
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  return frames;
}

}  // extern "C"
