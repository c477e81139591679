// Reading one row of a KV page pool: fp rows, or int8 / packed int4 rows
// with one float32 scale a row (ServeConfig.kv_format "int8" / "int4").
//
// Shared by the two paged kernels.  A quantized row is dequantized as the
// reference's PageFormat.dequantize does it, element for element:
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
