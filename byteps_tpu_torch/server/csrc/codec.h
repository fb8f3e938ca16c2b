// Server-side wire codecs for the DCN summation service.
//
// Reference analog: the server half of byteps's compression feature —
// byteps/server/server.cc decompresses each pushed partition, sums in fp32,
// and re-compresses the round result before answering pulls (SURVEY §2.2 /
// §3.3). The codec id rides the frame header's `flags` byte; per-codec
// parameters the response must reuse (topk's k, dithering's mode/levels)
// are remembered per key from the last push (CodecHint).
//
// Wire formats (little-endian), dense store = n fp32 elements:
//   kCodecRaw    n*f32                      (positional sum; also the
//                                            values-only wire of seed-synced
//                                            randomk, store size = k)
//   kCodecFP16   n*f16 (IEEE binary16)
//   kCodecOnebit [f32 scale][ceil(n/32)*u32]  bit (i&31) of word i>>5 set
//                                            => x[i] >= 0; value = ±scale
//   kCodecTopk   [u32 k][k*u32 idx][k*f32 val]  scatter-add
//   kCodecDither [u8 flags][u8 s][u16 0][f32 norm][n*i8 levels]
//                flags bit0: natural (powers-of-two) levels, else linear
//                flags bit1: max-norm (else l2) — used when re-encoding
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace bps {

enum Codec : uint8_t {
  kCodecRaw = 0,
  kCodecFP16 = 1,
  kCodecOnebit = 2,
  kCodecTopk = 3,
  kCodecDither = 4,
  // [f32 scale][n bytes e4m3fn] — quarter of raw fp32 (see
  // compression/fp8.py; byte-exact twin of the ml_dtypes cast)
  kCodecFP8 = 5,
};

constexpr uint8_t kDitherNatural = 0x1;
constexpr uint8_t kDitherMaxNorm = 0x2;

// Per-key parameters remembered from the most recent push, reused when
// re-encoding the round result for a compressed pull response.
struct CodecHint {
  uint32_t topk_k = 0;
  uint8_t dither_flags = 0;
  uint8_t dither_s = 127;
  // scaling=False workers push scale == 1.0f exactly (signSGD); mirror
  // that choice when re-encoding so two-way pulls return ±1, not ±mean|x|.
  bool onebit_scaled = true;
};

// Validate payload size + internal header against a dense store of n floats.
bool validate_payload(uint8_t codec, const char* buf, size_t len, int64_t n);

// dst[0..n) += decode(payload). Caller validated first.
void decode_sum(uint8_t codec, const char* buf, size_t len, float* dst,
                int64_t n);

// Remember response-relevant parameters from a validated push payload.
void update_hint(uint8_t codec, const char* buf, size_t len, CodecHint* hint);

// Encode src[0..n) for a pull response. `seed` drives stochastic rounding
// (dithering); deterministic per (key, version) so tests can golden it.
std::vector<char> encode(uint8_t codec, const float* src, int64_t n,
                         const CodecHint& hint, uint64_t seed);

// Portable IEEE half conversions (software; auto-vectorizable loops).
float half_to_float(uint16_t h);
uint16_t float_to_half(float f);

// e4m3fn conversions (1-4-3, bias 7, max finite 448, no inf;
// round-to-nearest-even on encode — matches the ml_dtypes cast the
// Python wire codec uses, asserted over all 256 bytes in tests).
float fp8_to_float(uint8_t b);
uint8_t float_to_fp8(float f);

}  // namespace bps
