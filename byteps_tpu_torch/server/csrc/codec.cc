#include "codec.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <numeric>
#include <random>

namespace bps {

namespace {

inline int64_t onebit_words(int64_t n) { return (n + 31) / 32; }

// xorshift-based uniform in [0,1) — cheap, reproducible stochastic rounding
// for re-encoded dithering responses (seeded per key+version by the server).
struct Rng01 {
  uint64_t s;
  explicit Rng01(uint64_t seed) : s(seed * 0x9E3779B97F4A7C15ull + 1) {}
  float next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return static_cast<float>((s >> 11) & 0xFFFFFF) * (1.0f / 16777216.0f);
  }
};

}  // namespace

float half_to_float(uint16_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // ±0
    } else {
      // subnormal half -> normalized float
      exp = 127 - 15 + 1;
      while ((man & 0x400) == 0) {
        man <<= 1;
        exp--;
      }
      man &= 0x3FF;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);  // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t float_to_half(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  const uint16_t sign = static_cast<uint16_t>((bits >> 16) & 0x8000u);
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t man = bits & 0x7FFFFF;
  if (exp >= 31) {
    // overflow -> inf (or nan preserved)
    const bool is_nan = ((bits >> 23) & 0xFF) == 0xFF && man != 0;
    return static_cast<uint16_t>(sign | 0x7C00 | (is_nan ? 0x200 : 0));
  }
  if (exp <= 0) {
    if (exp < -10) return sign;  // underflow to ±0
    // subnormal: shift mantissa (with implicit 1) right
    man |= 0x800000;
    const int shift = 14 - exp;
    uint32_t half_man = man >> shift;
    // round to nearest even
    const uint32_t rem = man & ((1u << shift) - 1);
    const uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_man & 1))) half_man++;
    return static_cast<uint16_t>(sign | half_man);
  }
  uint32_t half_man = man >> 13;
  const uint32_t rem = man & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (half_man & 1))) {
    half_man++;
    if (half_man == 0x400) {  // mantissa rollover bumps exponent
      half_man = 0;
      exp++;
      if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00);
    }
  }
  return static_cast<uint16_t>(sign | (exp << 10) | half_man);
}

float fp8_to_float(uint8_t b) {
  const float sign = (b & 0x80u) ? -1.0f : 1.0f;
  const int exp = (b >> 3) & 0xF;
  const int man = b & 0x7;
  if (exp == 15 && man == 7) return std::nanf("");  // the only NaN pattern
  if (exp == 0) return sign * std::ldexp(static_cast<float>(man), -9);
  // (1 + man/8) * 2^(exp-7) == (8 + man) * 2^(exp-10)
  return sign * std::ldexp(static_cast<float>(8 + man), exp - 10);
}

uint8_t float_to_fp8(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  const uint8_t sign = static_cast<uint8_t>((bits >> 24) & 0x80u);
  const uint32_t exp_f = (bits >> 23) & 0xFFu;
  const uint32_t man_f = bits & 0x7FFFFFu;
  if (exp_f == 0xFF) return sign | 0x7F;  // inf/NaN -> NaN
  if ((bits & 0x7FFFFFFFu) == 0) return sign;  // ±0
  const int e = static_cast<int>(exp_f) - 127;
  // 24-bit significand with the implicit bit (fp32 subnormal inputs have
  // e == -127 and no implicit bit, but those are << the fp8 subnormal
  // cutoff and fall into the shift>31 underflow below regardless)
  const uint32_t sig = man_f | 0x800000u;
  int shift, out_exp;
  if (e < -6) {  // fp8-subnormal target: ulp = 2^-9
    shift = 20 + (-6 - e);
    out_exp = 0;
    if (shift > 31) return sign;  // underflow to ±0
  } else {
    shift = 20;
    out_exp = e + 7;
  }
  // round to nearest, ties to even
  uint32_t rounded = sig >> shift;
  const uint32_t rem = sig & ((1u << shift) - 1u);
  const uint32_t half = 1u << (shift - 1);
  if (rem > half || (rem == half && (rounded & 1u))) rounded++;
  if (out_exp == 0) {
    if (rounded >= 8) {  // rounded up into the normal range
      out_exp = 1;
      rounded -= 8;
    }
  } else {
    if (rounded >= 16) {  // mantissa carry: exponent bumps, mantissa 0
      out_exp++;
      rounded >>= 1;
    }
    rounded -= 8;  // strip the implicit bit
  }
  if (out_exp > 15 || (out_exp == 15 && rounded >= 7)) {
    // e4m3fn has no inf and S.1111.111 is NaN: anything rounding past
    // ±448 (i.e. |x| > 464 after RNE) becomes NaN, matching the
    // ml_dtypes cast bit-for-bit on ALL inputs. The scaled wire path
    // pre-clips to ±448 before this function, so production encodes
    // never take this branch.
    return sign | 0x7F;
  }
  return sign | static_cast<uint8_t>(out_exp << 3) |
         static_cast<uint8_t>(rounded);
}

bool validate_payload(uint8_t codec, const char* buf, size_t len, int64_t n) {
  switch (codec) {
    case kCodecRaw:
      return len == static_cast<size_t>(n) * 4;
    case kCodecFP16:
      return len == static_cast<size_t>(n) * 2;
    case kCodecFP8:
      return len == 4 + static_cast<size_t>(n);
    case kCodecOnebit:
      return len == 4 + static_cast<size_t>(onebit_words(n)) * 4;
    case kCodecTopk: {
      if (len < 4) return false;
      uint32_t k;
      std::memcpy(&k, buf, 4);
      if (k == 0 || static_cast<int64_t>(k) > n) return false;
      if (len != 4 + static_cast<size_t>(k) * 8) return false;
      const char* ip = buf + 4;
      for (uint32_t i = 0; i < k; ++i) {
        uint32_t idx;
        std::memcpy(&idx, ip + i * 4, 4);
        if (static_cast<int64_t>(idx) >= n) return false;
      }
      return true;
    }
    case kCodecDither: {
      if (len != 8 + static_cast<size_t>(n)) return false;
      const uint8_t s = static_cast<uint8_t>(buf[1]);
      return s >= 1 && s <= 127;
    }
    default:
      return false;
  }
}

void decode_sum(uint8_t codec, const char* buf, size_t len, float* dst,
                int64_t n) {
  switch (codec) {
    case kCodecRaw: {
      const float* src = reinterpret_cast<const float*>(buf);
      float* __restrict__ d = dst;
      for (int64_t i = 0; i < n; ++i) d[i] += src[i];
      break;
    }
    case kCodecFP16: {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(buf);
      for (int64_t i = 0; i < n; ++i) dst[i] += half_to_float(src[i]);
      break;
    }
    case kCodecFP8: {
      float scale;
      std::memcpy(&scale, buf, 4);
      const uint8_t* src = reinterpret_cast<const uint8_t*>(buf + 4);
      for (int64_t i = 0; i < n; ++i) dst[i] += fp8_to_float(src[i]) * scale;
      break;
    }
    case kCodecOnebit: {
      float scale;
      std::memcpy(&scale, buf, 4);
      const uint32_t* words = reinterpret_cast<const uint32_t*>(buf + 4);
      for (int64_t i = 0; i < n; ++i) {
        const bool pos = (words[i >> 5] >> (i & 31)) & 1u;
        dst[i] += pos ? scale : -scale;
      }
      break;
    }
    case kCodecTopk: {
      uint32_t k;
      std::memcpy(&k, buf, 4);
      const uint32_t* idx = reinterpret_cast<const uint32_t*>(buf + 4);
      const float* val = reinterpret_cast<const float*>(buf + 4 + k * 4);
      for (uint32_t i = 0; i < k; ++i) dst[idx[i]] += val[i];
      break;
    }
    case kCodecDither: {
      const uint8_t flags = static_cast<uint8_t>(buf[0]);
      const int s = static_cast<uint8_t>(buf[1]);
      float norm;
      std::memcpy(&norm, buf + 4, 4);
      const int8_t* lv = reinterpret_cast<const int8_t*>(buf + 8);
      const bool natural = flags & kDitherNatural;
      for (int64_t i = 0; i < n; ++i) {
        const int l = lv[i];
        const int mag = l < 0 ? -l : l;
        if (mag == 0) continue;
        float p;
        if (natural) {
          p = std::exp2f(static_cast<float>(mag - 1 - (s - 1)));
        } else {
          p = static_cast<float>(mag) / static_cast<float>(s);
        }
        dst[i] += (l < 0 ? -p : p) * norm;
      }
      break;
    }
    default:
      (void)len;
      break;
  }
}

void update_hint(uint8_t codec, const char* buf, size_t len, CodecHint* hint) {
  (void)len;
  if (codec == kCodecTopk) {
    std::memcpy(&hint->topk_k, buf, 4);
  } else if (codec == kCodecDither) {
    hint->dither_flags = static_cast<uint8_t>(buf[0]);
    hint->dither_s = static_cast<uint8_t>(buf[1]);
  } else if (codec == kCodecOnebit) {
    float scale;
    std::memcpy(&scale, buf, 4);
    hint->onebit_scaled = scale != 1.0f;
  }
}

std::vector<char> encode(uint8_t codec, const float* src, int64_t n,
                         const CodecHint& hint, uint64_t seed) {
  switch (codec) {
    case kCodecFP16: {
      std::vector<char> out(static_cast<size_t>(n) * 2);
      uint16_t* dst = reinterpret_cast<uint16_t*>(out.data());
      for (int64_t i = 0; i < n; ++i) dst[i] = float_to_half(src[i]);
      return out;
    }
    case kCodecFP8: {
      float absmax = 0.f;
      for (int64_t i = 0; i < n; ++i)
        absmax = std::max(absmax, std::fabs(src[i]));
      const float scale = absmax > 0.f ? absmax / 448.0f : 1.0f;
      std::vector<char> out(4 + static_cast<size_t>(n));
      std::memcpy(out.data(), &scale, 4);
      uint8_t* dst = reinterpret_cast<uint8_t*>(out.data() + 4);
      for (int64_t i = 0; i < n; ++i) {
        const float q =
            std::min(448.0f, std::max(-448.0f, src[i] / scale));
        dst[i] = float_to_fp8(q);
      }
      return out;
    }
    case kCodecOnebit: {
      // scale = mean|x|, unless the pushes were unscaled (scale 1.0 ==
      // signSGD, learned via CodecHint) — then mirror ±1 semantics
      float scale = 1.f;
      if (hint.onebit_scaled) {
        double acc = 0.0;
        for (int64_t i = 0; i < n; ++i) acc += std::fabs(src[i]);
        scale = n > 0 ? static_cast<float>(acc / n) : 0.f;
      }
      std::vector<char> out(4 + static_cast<size_t>(onebit_words(n)) * 4, 0);
      std::memcpy(out.data(), &scale, 4);
      uint32_t* words = reinterpret_cast<uint32_t*>(out.data() + 4);
      for (int64_t i = 0; i < n; ++i) {
        if (!std::signbit(src[i])) words[i >> 5] |= 1u << (i & 31);
      }
      return out;
    }
    case kCodecTopk: {
      uint32_t k = hint.topk_k;
      if (k == 0 || static_cast<int64_t>(k) > n) {
        k = static_cast<uint32_t>(n);
      }
      std::vector<uint32_t> order(static_cast<size_t>(n));
      std::iota(order.begin(), order.end(), 0u);
      std::nth_element(
          order.begin(), order.begin() + k, order.end(),
          [src](uint32_t a, uint32_t b) {
            return std::fabs(src[a]) > std::fabs(src[b]);
          });
      std::vector<char> out(4 + static_cast<size_t>(k) * 8);
      std::memcpy(out.data(), &k, 4);
      uint32_t* idx = reinterpret_cast<uint32_t*>(out.data() + 4);
      float* val = reinterpret_cast<float*>(out.data() + 4 + k * 4);
      for (uint32_t i = 0; i < k; ++i) {
        idx[i] = order[i];
        val[i] = src[order[i]];
      }
      return out;
    }
    case kCodecDither: {
      const bool natural = hint.dither_flags & kDitherNatural;
      const bool maxnorm = hint.dither_flags & kDitherMaxNorm;
      const int s = hint.dither_s >= 1 ? hint.dither_s : 127;
      float norm = 0.f;
      if (maxnorm) {
        for (int64_t i = 0; i < n; ++i)
          norm = std::max(norm, std::fabs(src[i]));
      } else {
        double acc = 0.0;
        for (int64_t i = 0; i < n; ++i)
          acc += static_cast<double>(src[i]) * src[i];
        norm = static_cast<float>(std::sqrt(acc));
      }
      const float safe = norm > 0 ? norm : 1.f;
      Rng01 rng(seed);
      std::vector<char> out(8 + static_cast<size_t>(n), 0);
      out[0] = static_cast<char>(hint.dither_flags);
      out[1] = static_cast<char>(s);
      std::memcpy(out.data() + 4, &norm, 4);
      int8_t* lv = reinterpret_cast<int8_t*>(out.data() + 8);
      for (int64_t i = 0; i < n; ++i) {
        const float x = src[i];
        const float p = std::fabs(x) / safe;  // in [0, 1]
        const float u = rng.next();
        int level;
        if (!natural) {
          const float y = std::min(p, 1.f) * s;
          const float lo = std::floor(y);
          level = static_cast<int>(lo) + (u < (y - lo) ? 1 : 0);
        } else {
          // quantize p onto {0} ∪ {2^-j : j in [0, s-1]}, stochastic in the
          // mantissa; level index = log2(q) + (s-1) + 1, 0 => zero (matches
          // the worker-side DitheringCompressor natural partition)
          const float tiny = std::exp2f(static_cast<float>(-(s - 1)));
          if (p < tiny) {
            level = (u < p / tiny) ? 1 : 0;  // level 1 == tiny, else zero
          } else {
            const float pc = std::min(p, 1.f);
            const float e = std::floor(std::log2f(pc));
            const float base = std::exp2f(e);
            const float frac = pc / base - 1.f;
            const float q = base * (u < frac ? 2.f : 1.f);
            level = static_cast<int>(std::lround(std::log2f(q))) + (s - 1) + 1;
            if (level > s) level = s;
          }
        }
        if (level > 127) level = 127;
        lv[i] = static_cast<int8_t>(x < 0 ? -level : level);
      }
      return out;
    }
    case kCodecRaw:
    default: {
      std::vector<char> out(static_cast<size_t>(n) * 4);
      std::memcpy(out.data(), src, out.size());
      return out;
    }
  }
}

}  // namespace bps
