// Reading one row of a KV page pool: fp rows, or int8 / packed int4 rows
// with one float32 scale a row (ServeConfig.kv_format "int8" / "int4").
//
// Shared by the two paged kernels, whose tensor-core routes also share
// the tile copies below: a key tile's rows copied with 16-byte cp.async
// through a lookup of each row's pool index, and, from a quantized pool,
// the raw rows widened to bf16 in shared memory.  A quantized row is
// dequantized as the reference's PageFormat.dequantize does it, element
// for element:
// (unpack(q).astype(f32) * s).astype(T) -- the b-bit lane sign-extended,
// one float32 multiply by the row scale (not contracted into a later
// add), then a rounding to the query type T, widened again for the tile.
// Skipping the rounding would leave the bf16 partials quietly apart from
// the plain version.
//
// The int4 layout is strided, not interleaved (core/packing.py): byte j
// of a packed W-wide row holds element j in its low nibble and element
// j + W/2 in its high nibble.  A GQA head row (W = 128) keeps elements
// 0-63 in the low nibbles; an MLA latent row (W = 576) keeps c_kv
// (0-511) in every low nibble and the high nibbles of bytes 0-223, and
// k_rope (512-575) in the high nibbles of bytes 224-287, so the row is
// dequantized whole and only then split at r.
#pragma once

#include "flash_tile.cuh"
#include "mma.cuh"

#include <cstdint>
#include <type_traits>

// Storage type of a pool row: T itself (BITS 0), else int8 lanes.
template <typename T, int BITS>
using stored_t = std::conditional_t<BITS == 0, T, int8_t>;

// Stored length of a W-wide row, in elements of stored_t.
template <int BITS, int W>
__host__ __device__ constexpr int stored_width() {
  static_assert(BITS == 0 || BITS == 8 || BITS == 4, "storage bits");
  return BITS == 0 ? W : W * BITS / 8;
}

// Signed value of a b-bit lane.
template <int BITS>
__device__ __forceinline__ int lane_value(int byte, int hi) {
  if constexpr (BITS == 8) {
    return static_cast<int8_t>(byte);
  } else {
    const int v = (byte >> (4 * hi)) & 15;
    return ((v + 8) & 15) - 8;
  }
}

// A quantized lane times its row scale, rounded to T and widened.
template <typename T>
__device__ __forceinline__ float dequant(int q, float scale) {
  return round_to<T>(__fmul_rn(static_cast<float>(q), scale));
}

// Element d (< W) of the stored row `row`, as the tile takes it; `scale`
// is the row's scale (ignored for fp rows).
template <typename T, int BITS, int W>
__device__ __forceinline__ float page_elem(const stored_t<T, BITS>* row,
                                           float scale, int d) {
  if constexpr (BITS == 0) {
    return to_f<T>(row[d]);
  } else if constexpr (BITS == 8) {
    return dequant<T>(row[d], scale);
  } else {
    constexpr int HALF = W / 2;
    const int hi = d >= HALF;
    const int byte = static_cast<uint8_t>(row[hi ? d - HALF : d]);
    return dequant<T>(lane_value<4>(byte, hi), scale);
  }
}

// ---------------------------------------------------------------------------
// Key tiles of the tensor-core routes.
// ---------------------------------------------------------------------------

// The W-byte slices for head kvh of ROWS pool rows (rows[r]: the row's
// index in a pool of KV slices a row, W bytes each; -1: dead) into rows of
// STRIDE bytes at dst, by NT threads with 16-byte cp.async; a dead row is
// zero-filled and never read.
template <int W, int STRIDE, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const unsigned char* pool,
                                          const int* rows, int KV, int kvh,
                                          int tid) {
  static_assert(W % 16 == 0 && STRIDE % 16 == 0, "16-byte rows");
  constexpr int C = W / 16;             // 16-byte chunks a row
  for (int c = tid; c < ROWS * C; c += NT) {
    const int r = c / C, d = (c % C) * 16, row = rows[r];
    const unsigned char* src =
        row >= 0 ? pool + ((size_t)row * KV + kvh) * W + d : pool;
    cp_async16(dst + r * STRIDE + d, src, row >= 0);
  }
}

// Eight lanes of a quantized row, one from each byte of w (the byte at
// 8 bits; at 4 its low nibble, or with `hi` its high one), as the
// reference dequantizes them (dequant above): the lane times the row
// scale in one float32 multiply, not contracted into a later add, then
// rounded to bf16; packed as eight bf16, the lowest byte's lane first.
template <int BITS>
__device__ __forceinline__ uint4 widen8(uint2 w, float s, int hi) {
  unsigned o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned word = (i < 2 ? w.x : w.y) >> (16 * (i & 1));
    const float lo = static_cast<float>(lane_value<BITS>(word & 255, hi));
    const float up = static_cast<float>(lane_value<BITS>((word >> 8) & 255,
                                                         hi));
    o[i] = pack_bf16(__fmul_rn(lo, s), __fmul_rn(up, s));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Rows [r0, r1) of a tile's raw rows (W lanes in W * BITS / 8 bytes each,
// back to back from raw) widened with their scales into bf16 rows of
// STRIDE elements at dst, by NT threads.  A thread takes 8 raw bytes at a
// time: eight threads read 64 contiguous bytes and write 128 contiguous
// bytes of one bf16 row.  The int4 layout is strided, so byte j's low
// nibble is lane j and its high nibble lane j + W / 2: 8 bytes widen into
// two runs of eight lanes.
template <int BITS, int W, int STRIDE, int NT>
__device__ __forceinline__ void widen_rows(__nv_bfloat16* dst,
                                           const unsigned char* raw,
                                           const float* scale, int r0,
                                           int r1, int tid) {
  constexpr int RB = W * BITS / 8;      // raw bytes a row
  constexpr int U = RB / 8;             // 8-byte units a row
  for (int c = r0 * U + tid; c < r1 * U; c += NT) {
    const int r = c / U, j = c % U;
    const float s = scale[r];
    const uint2 w = *reinterpret_cast<const uint2*>(raw + r * RB + 8 * j);
    __nv_bfloat16* out = dst + r * STRIDE + 8 * j;
    *reinterpret_cast<uint4*>(out) = widen8<BITS>(w, s, 0);
    if constexpr (BITS == 4)
      *reinterpret_cast<uint4*>(out + W / 2) = widen8<BITS>(w, s, 1);
  }
}
