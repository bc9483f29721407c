// Native ingest data plane: base64 raster decode + device-layout packing.
//
// The reference's ingest hot path is merlin's per-chip HTTP decode
// (base64 int16 rasters, SURVEY.md §3.3) followed by Spark/Kryo
// serialization of per-pixel rows.  Here the equivalent work — payload
// decode and the [B,T,100,100] -> [B,P,T] pixel-major transpose that
// produces the device batch layout — is done in C++: a vectorizable
// base64 decoder and a cache-blocked, multithreaded transpose, exposed
// through a C ABI for ctypes (firebird_tpu_torch/native/__init__.py).
// The PyTorch port's own copy of firebird_tpu/native/fastpack.cpp.
//
// Build (native/__init__.py does it at first use, into
// build/firebird_tpu_torch/):
// g++ -O3 -std=c++17 -shared -fPIC -pthread fastpack.cpp -o libfastpack.so

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// base64
// ---------------------------------------------------------------------------

alignas(64) int8_t B64_LUT[256];
// Pre-shifted quad LUTs: a full 4-char group decodes as
// D0[a]|D1[b]|D2[c]|D3[d] -> 24-bit triple, with bit 24 set iff any char
// is invalid (so one branch tests the whole group).
alignas(64) uint32_t B64_D0[256], B64_D1[256], B64_D2[256], B64_D3[256];
constexpr uint32_t B64_BAD = 1u << 24;

struct LutInit {
  LutInit() {
    const char* alpha =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 256; ++i) {
      B64_LUT[i] = -1;
      B64_D0[i] = B64_D1[i] = B64_D2[i] = B64_D3[i] = B64_BAD;
    }
    for (uint32_t i = 0; i < 64; ++i) {
      const uint8_t c = (uint8_t)alpha[i];
      B64_LUT[c] = (int8_t)i;
      B64_D0[c] = i << 18;
      B64_D1[c] = i << 12;
      B64_D2[c] = i << 6;
      B64_D3[c] = i;
    }
    B64_LUT[(uint8_t)'='] = -2;  // padding
  }
} lut_init;

// Cache-blocked [T, HW] -> [HW, cap] transpose for 16-bit elements.
// Rows beyond T (up to cap) are filled with `fill`.
void transpose_block_u16(const uint16_t* src, uint16_t* dst, int64_t T,
                         int64_t HW, int64_t cap, uint16_t fill,
                         int64_t p0, int64_t p1) {
  constexpr int64_t BP = 128;  // pixel tile
  constexpr int64_t BT = 64;   // time tile
  for (int64_t pb = p0; pb < p1; pb += BP) {
    const int64_t pe = pb + BP < p1 ? pb + BP : p1;
    for (int64_t tb = 0; tb < T; tb += BT) {
      const int64_t te = tb + BT < T ? tb + BT : T;
      for (int64_t p = pb; p < pe; ++p) {
        uint16_t* drow = dst + p * cap;
        for (int64_t t = tb; t < te; ++t) drow[t] = src[t * HW + p];
      }
    }
    for (int64_t p = pb; p < pe; ++p) {
      uint16_t* drow = dst + p * cap;
      for (int64_t t = T; t < cap; ++t) drow[t] = fill;
    }
  }
}

void parallel_for(int64_t n, int64_t grain,
                  const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? (int64_t)hw : 4;
  int64_t chunks = (n + grain - 1) / grain;
  if (n_threads > chunks) n_threads = chunks;
  if (n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int64_t i = 0; i < n_threads; ++i) {
    int64_t lo = i * per, hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Decode base64 `in[0..n_in)` into `out`; returns decoded byte count,
// or -1 on invalid input.  Whitespace is skipped (JSON payloads may wrap).
// Fast path: full 4-char groups through the pre-shifted LUTs, one branch
// per group; any irregular char (whitespace, padding) falls back to the
// scalar loop from that point.
int64_t fb_b64_decode(const char* in, int64_t n_in, uint8_t* out) {
  int64_t i = 0, o = 0;
  // Leave the final group (possibly padded) plus slack to the slow path.
  const int64_t fast_end = n_in - 8;
  while (i <= fast_end) {
    const uint32_t x = B64_D0[(uint8_t)in[i]] | B64_D1[(uint8_t)in[i + 1]] |
                       B64_D2[(uint8_t)in[i + 2]] | B64_D3[(uint8_t)in[i + 3]];
    if (x & B64_BAD) break;
    out[o] = (uint8_t)(x >> 16);
    out[o + 1] = (uint8_t)(x >> 8);
    out[o + 2] = (uint8_t)x;
    i += 4;
    o += 3;
  }
  uint32_t acc = 0;
  int have = 0;
  for (; i < n_in; ++i) {
    const uint8_t c = (uint8_t)in[i];
    if (c == '\n' || c == '\r' || c == ' ' || c == '\t') continue;
    const int8_t v = B64_LUT[c];
    if (v == -2) break;  // padding: done
    if (v < 0) return -1;
    acc = (acc << 6) | (uint32_t)v;
    if (++have == 4) {
      out[o++] = (uint8_t)(acc >> 16);
      out[o++] = (uint8_t)(acc >> 8);
      out[o++] = (uint8_t)acc;
      have = 0;
      acc = 0;
    }
  }
  if (have == 2) {
    out[o++] = (uint8_t)(acc >> 4);
  } else if (have == 3) {
    out[o++] = (uint8_t)(acc >> 10);
    out[o++] = (uint8_t)(acc >> 2);
  } else if (have == 1) {
    return -1;
  }
  return o;
}

// Pack one chip's spectra: src [B, T, HW] int16 -> dst [B, HW, cap] int16,
// transposed per band and fill-padded along the trailing time axis.
void fb_pack_spectra(const int16_t* src, int64_t B, int64_t T, int64_t HW,
                     int64_t cap, int16_t fill, int16_t* dst) {
  parallel_for(B * HW, 4096, [&](int64_t lo, int64_t hi) {
    // span [lo, hi) over the flattened (band, pixel) space; handle each
    // band's pixel subrange with the blocked transpose.
    int64_t b0 = lo / HW, b1 = (hi + HW - 1) / HW;
    for (int64_t b = b0; b < b1; ++b) {
      int64_t p0 = b == b0 ? lo - b * HW : 0;
      int64_t p1 = (b == b1 - 1 && hi - b * HW < HW) ? hi - b * HW : HW;
      transpose_block_u16((const uint16_t*)(src + b * T * HW),
                          (uint16_t*)(dst + b * HW * cap), T, HW, cap,
                          (uint16_t)fill, p0, p1);
    }
  });
}

// Pack one chip's QA: src [T, HW] uint16 -> dst [HW, cap] uint16.
void fb_pack_qa(const uint16_t* src, int64_t T, int64_t HW, int64_t cap,
                uint16_t fill, uint16_t* dst) {
  parallel_for(HW, 4096, [&](int64_t lo, int64_t hi) {
    transpose_block_u16(src, dst, T, HW, cap, fill, lo, hi);
  });
}

}  // extern "C"
