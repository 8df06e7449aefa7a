// sdrkit — native host-side kernels for supersdr_jax.
//
// The device owns the DSP; these are the *host* hot paths that sit on the
// ingest/egress edge at line rate: IMA-ADPCM transcode (sequential,
// per-sample — the one loop numpy cannot vectorize; reference decodes it
// in pure Python at kiwi/client.py:58-87), big-endian sample conversion
// for SND frames (utils_supersdr.py:1066-1072), RFC6455 XOR masking, and
// a lock-free SPSC ring buffer for the audio callback path.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsdrkit.so sdrkit.cpp
// Loaded via ctypes (supersdr_jax/native.py); every entry point has a
// pure-python fallback.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ------------------------------------------------------------ IMA ADPCM

static const int16_t kStepSizes[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

static const int8_t kIndexAdjust[16] = {-1, -1, -1, -1, 2, 4, 6, 8,
                                        -1, -1, -1, -1, 2, 4, 6, 8};

struct AdpcmState {
  int32_t index;
  int32_t prev;
};

static inline int16_t decode_nibble(AdpcmState* st, int code) {
  int step = kStepSizes[st->index];
  int idx = st->index + kIndexAdjust[code];
  st->index = idx < 0 ? 0 : (idx > 88 ? 88 : idx);
  int diff = step >> 3;
  if (code & 1) diff += step >> 2;
  if (code & 2) diff += step >> 1;
  if (code & 4) diff += step;
  if (code & 8) diff = -diff;
  int s = st->prev + diff;
  st->prev = s < -32768 ? -32768 : (s > 32767 ? 32767 : s);
  return (int16_t)st->prev;
}

// Decode n_bytes of packed 4-bit codes (low nibble first) -> 2*n_bytes
// int16 samples. State threads across calls.
void adpcm_decode(const uint8_t* data, int64_t n_bytes, int16_t* out,
                  AdpcmState* st) {
  for (int64_t i = 0; i < n_bytes; ++i) {
    out[2 * i] = decode_nibble(st, data[i] & 0x0F);
    out[2 * i + 1] = decode_nibble(st, data[i] >> 4);
  }
}

// Encode n int16 samples (n even) -> n/2 packed bytes.
void adpcm_encode(const int16_t* samples, int64_t n, uint8_t* out,
                  AdpcmState* st) {
  for (int64_t i = 0; i < n; i += 2) {
    uint8_t byte = 0;
    for (int half = 0; half < 2; ++half) {
      int step = kStepSizes[st->index];
      int diff = (int)samples[i + half] - st->prev;
      int code = 0;
      if (diff < 0) {
        code = 8;
        diff = -diff;
      }
      if (diff >= step) {
        code |= 4;
        diff -= step;
      }
      if (diff >= (step >> 1)) {
        code |= 2;
        diff -= step >> 1;
      }
      if (diff >= (step >> 2)) code |= 1;
      decode_nibble(st, code);  // track decoder state exactly
      byte |= half ? (uint8_t)(code << 4) : (uint8_t)code;
    }
    out[i / 2] = byte;
  }
}

// -------------------------------------------- big-endian frame payloads

// Big-endian int16 stream -> float32 (SND audio payload).
void be16_to_f32(const uint8_t* data, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    int16_t v = (int16_t)((data[2 * i] << 8) | data[2 * i + 1]);
    out[i] = (float)v;
  }
}

// Interleaved big-endian I/Q int16 pairs -> interleaved float32 (complex64
// layout), scaled by 1/scale (pass 1.0 for raw).
void be16_iq_to_c64(const uint8_t* data, int64_t n_pairs, float scale,
                    float* out) {
  float inv = 1.0f / scale;
  for (int64_t i = 0; i < n_pairs; ++i) {
    int16_t re = (int16_t)((data[4 * i] << 8) | data[4 * i + 1]);
    int16_t im = (int16_t)((data[4 * i + 2] << 8) | data[4 * i + 3]);
    out[2 * i] = (float)re * inv;
    out[2 * i + 1] = (float)im * inv;
  }
}

// Interleaved big-endian I/Q int16 pairs -> SPLIT little-endian int16
// planes (re[], im[]) — the wideband pipeline's int16 ingest format
// (process_i16 / i16 chunks): wire bytes land device-ready with no
// float conversion and HALF the host->device transfer of complex64.
void be16_iq_split_i16(const uint8_t* data, int64_t n_pairs,
                       int16_t* re, int16_t* im) {
  for (int64_t i = 0; i < n_pairs; ++i) {
    re[i] = (int16_t)((data[4 * i] << 8) | data[4 * i + 1]);
    im[i] = (int16_t)((data[4 * i + 2] << 8) | data[4 * i + 3]);
  }
}

// ------------------------------------------------------- RFC6455 masking

void xor_mask(uint8_t* data, int64_t n, const uint8_t* mask4) {
  // word-at-a-time once aligned
  uint32_t m;
  memcpy(&m, mask4, 4);
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t a, b;
    memcpy(&a, data + i, 4);
    memcpy(&b, data + i + 4, 4);
    a ^= m;
    b ^= m;
    memcpy(data + i, &a, 4);
    memcpy(data + i + 4, &b, 4);
  }
  for (; i < n; ++i) data[i] ^= mask4[i & 3];
}

// --------------------------------------------------- SPSC ring buffer

struct RingBuf {
  float* buf;
  int64_t capacity;  // in floats, power of two
  std::atomic<int64_t> head;  // write index
  std::atomic<int64_t> tail;  // read index
};

RingBuf* rb_create(int64_t capacity) {
  int64_t cap = 1;
  while (cap < capacity) cap <<= 1;
  RingBuf* rb = new RingBuf();
  rb->buf = (float*)malloc(sizeof(float) * cap);
  rb->capacity = cap;
  rb->head.store(0);
  rb->tail.store(0);
  return rb;
}

void rb_destroy(RingBuf* rb) {
  free(rb->buf);
  delete rb;
}

int64_t rb_size(RingBuf* rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

int64_t rb_write(RingBuf* rb, const float* src, int64_t n) {
  int64_t head = rb->head.load(std::memory_order_relaxed);
  int64_t tail = rb->tail.load(std::memory_order_acquire);
  int64_t space = rb->capacity - (head - tail);
  if (n > space) n = space;
  int64_t mask = rb->capacity - 1;
  for (int64_t i = 0; i < n; ++i) rb->buf[(head + i) & mask] = src[i];
  rb->head.store(head + n, std::memory_order_release);
  return n;
}

int64_t rb_read(RingBuf* rb, float* dst, int64_t n) {
  int64_t tail = rb->tail.load(std::memory_order_relaxed);
  int64_t head = rb->head.load(std::memory_order_acquire);
  int64_t avail = head - tail;
  if (n > avail) n = avail;
  int64_t mask = rb->capacity - 1;
  for (int64_t i = 0; i < n; ++i) dst[i] = rb->buf[(tail + i) & mask];
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
