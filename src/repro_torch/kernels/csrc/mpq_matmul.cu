// Packed sub-byte matmuls: the weight-only kernel and the integer kernel.
//
// Replaces: the Pallas bodies `_wo_kernel` (weight-only, behind
// `repro/kernels/mpq_matmul.py::wo_matmul_kernel`) and `_int_kernel`
// (integer, behind `mpq_matmul_kernel`), TPU.
//
// Both compute the function of `repro/kernels/ref.py`, not the Pallas
// blocking.  An operand packed with factor f = 8 / bits along K (length K,
// Kp = K / f packed positions) keeps element k in lane k / Kp of packed
// position k % Kp (`core/packing.py`).  The two operands of the integer
// kernel may have different factors; the kernels therefore walk K in
// "base" positions of the finer factor F = max(fa, fw): one stage takes
// base positions j in [j0, j0 + TT) and, for every lane group g < F, the
// elements k = g * (K / F) + j.  An operand with factor fo reads those
// from its packed positions (g % (F / fo)) * (K / F) + j, lane
// g / (F / fo): contiguous runs, and the same k for x and w.
//
//   wo_matmul:  out[m, n] = (sum_k x[m, k] * w[k, n]) * w_scale[n]
//               x float32 or bf16, w int{8,4,2}; products and the sum in
//               float32 (a bf16 x times an integer weight is exact in
//               float32), the per-channel scale after the whole sum, the
//               result rounded once to the output type.
//   mpq_matmul: out[m, n] = ((float)sum_k xq[m, k] * wq[k, n])
//                           * x_scale[m] * w_scale[n]
//               int{8,4,2} x int{8,4,2}, exact int32 sum, then two
//               float32 multiplies in that order.
//
// The weight is never written unpacked to device memory: each stage
// stages packed bytes in shared memory and unpacks them from there.
//
// What bounds them on an H100: at decode (M = 8 rows) a call streams its
// packed weight once and does ~2 * M operations per weight element, far
// below the ~295 operations per byte where compute takes over, so it is
// bound by bytes (K * N * bits / 8).  At a prefill wave (M = 2048) it is
// bound by operations (2 * M * K * N).  With few rows there are few
// output tiles, so K is split over extra blocks (each sums a contiguous
// range of stages into a float32 / int32 partial) until the grid covers
// the card, and a second launch adds the partials in split order and
// applies the epilogue: the result does not depend on the launch order.
//
// Tensor-core routes: the weight-only kernel with bf16 x (the serving
// path) and the integer kernel.  A stage's x runs and packed weight rows
// come into a ring of four shared-memory slots by 16-byte `cp.async`
// (`ops.prepare_weight` pads K to 256 and N to 128, so runs and rows
// start on 16-byte boundaries; the launch checks this and the operands'
// alignment and returns cudaErrorInvalidValue otherwise), three stages
// in flight and one barrier a stage.  The weight stays packed in shared
// memory (rows padded to 144 bytes, so the loads are free of bank
// conflicts) and `ldmatrix.trans` hands each lane the bytes of two packed
// rows and two adjacent columns; every fragment pair is then the even and
// the odd columns of a 16-column chunk, and the epilogue puts them back.
// The route is chosen by M before launch:
//   * M > 16 (`wo_mma_rows`, `int_mma_rows`, operation-bound): 128 x 128
//     outputs a block of four warps (64 x 64 each: every x fragment feeds
//     eight mma, every weight fragment four), two blocks an SM;
//   * M <= 16 (`wo_mma_cols`, `int_mma_cols`, byte-bound): the
//     transposed product D^T = W^T x^T, so N fills the mma's 16-row side
//     and the <= 16 rows of x its 8-column side (no lane of the weight
//     side is padding); 128 columns a block of four warps, and K split
//     until the grid holds three blocks an SM, so that enough weight
//     bytes are in flight to stream at the memory's rate.
// Weight-only, bf16 x: `mma.sync` m16n8k16 (bf16 products, float32
// sums).  Every sign-extended lane (-128..127) and every x is exact in
// bf16, so the products are exact and only the order of the float32 sum
// changes.  A stage is 64 k values (TT = 64 / F packed rows), its lanes
// sign-extended into bf16 fragments in registers, F k-steps from one
// load; x fragments come from `ldmatrix` on the bf16 x tile.
// Integer: `mma.sync` m16n8k32 s8 (exact int32 sums, so the result is
// bitwise the plain version's whatever the order).  A stage is TT = 64
// base positions (32 when F = 4) of each operand, packed x staged as it
// lies.  Both s8 fragments want four k of one row or column in a
// register; x's `ldmatrix` gives that directly, and the weight's
// `ldmatrix.trans` gives four k of two columns in two registers once the
// stage stores each 16 packed rows in the order 0, 1, 4, 5, 8, 9, 12, 13,
// 2, 3, 6, 7, ... (`w_slot`), so one `__byte_perm` a register sorts
// them.  Lanes of packed bytes are sign-extended four at a time
// (`s8_lanes`); a8w8 needs none.
// Weight-only with float32 x: CUDA cores (`wo_kernel` on float32 FMA),
// 64-column tiles, the weight widened element by element into shared
// memory.  On tensor cores float32 would mean TF32, another function, so
// the float32 route is chosen by dtype and keeps this design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int TARGET_BLOCKS = 264;    // two blocks per SM of an H100 (132)
constexpr int MIN_STAGES_PER_SPLIT = 4;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Lane l of a packed byte, sign-extended: move the lane to the top of a
// 32-bit word and shift it back arithmetically.
template <int BITS>
__device__ __forceinline__ int lane_of(unsigned b, int l) {
  return static_cast<int>(b << (32 - BITS * (l + 1))) >> (32 - BITS);
}

__device__ __forceinline__ unsigned byte_at(const int8_t* p, bool ok) {
  return ok ? static_cast<unsigned>(static_cast<uint8_t>(*p)) : 0u;
}

// ---------------------------------------------------------------------------
// Weight-only kernel, float32 route.  Block: BM x BN outputs,
// (BM / TM) x (BN / TN) threads, each with a TM x 4 register tile.  Stage:
// BK = 64 k positions, i.e. TT = 64 / fw packed weight rows.  Position p = g * TT + t holds
// k = g * Kp + j0 + t.
// ---------------------------------------------------------------------------
constexpr int WO_BK = 64;

template <int BITS, int BM, int BN, int TM>
__global__ void __launch_bounds__((BM / TM) * (BN / 4))
wo_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ ws, float* __restrict__ out,
          float* __restrict__ part, int M, int N, int K, int per_split) {
  constexpr int F = 8 / BITS;
  constexpr int TT = WO_BK / F;
  constexpr int TN = 4;
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BM][WO_BK + 1];
  __shared__ __align__(16) float Bs[WO_BK][BN];

  const int kp = K / F;
  const int n_stages = (kp + TT - 1) / TT;
  const int s0 = blockIdx.z * per_split;
  const int s1 = min(s0 + per_split, n_stages);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int st = s0; st < s1; ++st) {
    const int j0 = st * TT;
    for (int idx = tid; idx < BM * WO_BK; idx += NT) {
      const int m = idx / WO_BK, p = idx % WO_BK;
      const int g = p / TT, t = p % TT;
      float v = 0.f;
      if (m0 + m < M && j0 + t < kp)
        v = x[(size_t)(m0 + m) * K + (size_t)g * kp + j0 + t];
      As[m][p] = v;
    }
    for (int idx = tid; idx < TT * BN; idx += NT) {
      const int t = idx / BN, n = idx % BN;
      const unsigned b = byte_at(w + (size_t)(j0 + t) * N + n0 + n,
                                 j0 + t < kp && n0 + n < N);
#pragma unroll
      for (int l = 0; l < F; ++l) Bs[l * TT + t][n] = (float)lane_of<BITS>(b, l);
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < WO_BK; ++p) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty * TM + i][p];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[p][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(a[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      if (part != nullptr)
        part[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
      else
        out[(size_t)m * N + n] = __fmul_rn(acc[i][j], ws[n]);
    }
  }
}

template <typename T>
__global__ void wo_reduce(const float* __restrict__ part,
                          const float* __restrict__ ws, T* __restrict__ out,
                          int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + i];
  out[i] = from_f<T>(__fmul_rn(s, ws[i % N]));
}

// ---------------------------------------------------------------------------
// Weight-only kernel, bf16 route: mma.sync with a cp.async ring.  Stage
// position p = g * TT + t holds k = g * Kp + j0 + t, for x and w alike.
//
// The packed tile stays packed in shared memory.  `ldmatrix.trans` reads
// it as 8 x 8 tiles of 16-bit pairs of bytes: lane (gq = lane / 4, c =
// lane % 4) receives the bytes of packed rows t = 2c, 2c + 1 and columns
// n = 2gq, 2gq + 1.  Sign-extending lane g of those bytes gives two
// fragments at once, one for the even columns (n = 2gq) and one for the
// odd (n = 2gq + 1): the mma's 8 (or 16) weight columns are a 16-column
// chunk taken even columns first, and the epilogue puts them back.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int MMA_BK = 64;            // k values a stage
constexpr int MMA_BN = 128;           // output columns a block
constexpr int XS = MMA_BK + 8;        // padded row strides: bf16 (x) and
constexpr int WPS = MMA_BN + 16;      // bytes (packed w)
constexpr int ROWS_BM = 128, ROWS_NT = 128, ROWS_ST = 4;   // M > 16
constexpr int COLS_BM = 16, COLS_NT = 128, COLS_ST = 4;    // M <= 16
constexpr int COLS_TARGET_BLOCKS = 396;   // three blocks per SM

// Shared memory of one block: ST ring slots of x (BM x 64 bf16) and of
// packed w (TT x 128 bytes).
template <int BITS, int BM, int ST>
struct WoMma {
  static constexpr int F = 8 / BITS, TT = MMA_BK / F;
  static constexpr size_t x_bytes = sizeof(bf16) * ST * BM * XS;
  static constexpr size_t smem_bytes() {
    return x_bytes + (size_t)ST * TT * WPS;
  }
};

// Issue stage `st` into one ring slot: x rows m0..m0+BM (zero past M),
// F runs of TT columns each, and packed w rows j0..j0+TT of columns
// n0..n0+128 (zero past N).
template <int BITS, int BM, int NT>
__device__ __forceinline__ void wo_stage(const bf16* x, const int8_t* w,
                                         bf16* Xs, int8_t* Wp, int st, int M,
                                         int N, int K, int m0, int n0,
                                         int tid) {
  constexpr int F = 8 / BITS, TT = MMA_BK / F;
  const int kp = K / F, j0 = st * TT;
  for (int c = tid; c < BM * (MMA_BK / 8); c += NT) {
    const int r = c / (MMA_BK / 8), p = (c % (MMA_BK / 8)) * 8;
    const int g = p / TT, t = p % TT, m = m0 + r;
    cp_async16(Xs + r * XS + p,
               x + (size_t)min(m, M - 1) * K + (size_t)g * kp + j0 + t,
               m < M);
  }
  for (int c = tid; c < TT * (MMA_BN / 16); c += NT) {
    const int t = c / (MMA_BN / 16), dn = (c % (MMA_BN / 16)) * 16;
    const bool ok = n0 + dn < N;
    cp_async16(Wp + t * WPS + dn,
               w + (size_t)(j0 + t) * N + (ok ? n0 + dn : 0), ok);
  }
}

// Lane g of the four bytes an `ldmatrix.trans` register holds, as bf16
// pairs over k: the even column's (t = 2c, 2c + 1) and the odd column's.
// Every lane is exact in bf16.  Below 8 bits, flipping each lane's sign
// bit turns v into u = v + 2^(BITS-1), which fits the 7-bit mantissa of
// 128 (bf16 0x4300 | u is 128 + u): two lanes take one shift, one
// mask-and-or and one bf16x2 subtraction of 128 + 2^(BITS-1).  Bytes are
// sign-extended and converted through float32.
template <int BITS>
__device__ __forceinline__ void split_lanes(unsigned r, int g, unsigned& even,
                                            unsigned& odd) {
  if constexpr (BITS == 8) {
    even = pack_bf16((float)lane_of<8>(r, 0),
                     (float)lane_of<8>(r >> 16, 0));
    odd = pack_bf16((float)lane_of<8>(r >> 8, 0),
                    (float)lane_of<8>(r >> 24, 0));
  } else {
    constexpr unsigned SIGNS = BITS == 4 ? 0x88888888u : 0xaaaaaaaau;
    constexpr unsigned MASK = ((1u << BITS) - 1) * 0x00010001u;
    const unsigned u = r ^ SIGNS;
    const __nv_bfloat162 bias =
        __float2bfloat162_rn(128.f + (float)(1 << (BITS - 1)));
    unsigned e = ((u >> (BITS * g)) & MASK) | 0x43004300u;
    unsigned o = ((u >> (8 + BITS * g)) & MASK) | 0x43004300u;
    __nv_bfloat162 ev = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&e), bias);
    __nv_bfloat162 ov = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&o), bias);
    even = *reinterpret_cast<unsigned*>(&ev);
    odd = *reinterpret_cast<unsigned*>(&ov);
  }
}

// The four packed-weight registers of 16 packed rows (16q..16q+15) and
// the 32 columns from `col`: r[0], r[1] for rows 16q + 0..7, 8..15 of
// the first 16 columns, r[2], r[3] of the next 16.
__device__ __forceinline__ void packed_rows(unsigned (&r)[4],
                                           const int8_t* Wt, int q, int col,
                                           int lane) {
  ldsm_x4_t(r, Wt + (16 * q + (lane & 7) + ((lane >> 3) & 1) * 8) * WPS +
                   col + (lane >> 4) * 16);
}

// The k loop of every tensor-core route: this block's split of stages
// runs through a ring of ST shared-memory slots, ST - 1 in flight while
// one is consumed; one barrier a stage.  `start(stage, slot)` starts a
// stage's copies into a slot, `consume(slot)` runs its products.
template <int ST, typename Start, typename Consume>
__device__ __forceinline__ void stage_ring(int n_stages, int per_split,
                                           Start start, Consume consume) {
  const int s0 = blockIdx.z * per_split;
  const int ns = max(min(s0 + per_split, n_stages) - s0, 0);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < ns) start(s0 + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<ST - 2>();            // stage i landed (this thread's part)
    __syncthreads();                    // everyone's; slot i - 1 is free
    const int nx = i + ST - 1;
    if (nx < ns) start(s0 + nx, nx % ST);
    cp_async_commit();
    consume(i % ST);
  }
  cp_async_wait<0>();
}

// The k loop of both weight-only routes: `consume(Xt, Wt)` on each
// stage's x tile and packed weight tile.
template <int BITS, int BM, int NT, int ST, typename Consume>
__device__ __forceinline__ void wo_loop(const bf16* x, const int8_t* w,
                                        unsigned char* smem, int M, int N,
                                        int K, int per_split, int m0, int n0,
                                        Consume consume) {
  using L = WoMma<BITS, BM, ST>;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  int8_t* Wp = reinterpret_cast<int8_t*>(smem + L::x_bytes);
  stage_ring<ST>(
      K / MMA_BK, per_split,
      [&](int st, int slot) {
        wo_stage<BITS, BM, NT>(x, w, Xs + slot * BM * XS,
                               Wp + slot * L::TT * WPS, st, M, N, K, m0, n0,
                               threadIdx.x);
      },
      [&](int slot) { consume(Xs + slot * BM * XS, Wp + slot * L::TT * WPS); });
}

// M > 16: out (or a split's partial) for 128 x 128 outputs; warp w owns
// rows 64 * (w / 2).. and columns 64 * (w % 2).. of the block's tile, as
// eight 8-column mma tiles: even and odd columns of four 16-column
// chunks.
template <int BITS>
__global__ void __launch_bounds__(ROWS_NT, 2)
wo_mma_rows(const bf16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ ws, bf16* __restrict__ out,
            float* __restrict__ part, int M, int N, int K, int per_split) {
  constexpr int F = 8 / BITS, Q = MMA_BK / F / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * ROWS_BM, n0 = blockIdx.x * MMA_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  wo_loop<BITS, ROWS_BM, ROWS_NT, ROWS_ST>(
      x, w, smem_raw, M, N, K, per_split, m0, n0,
      [&](const bf16* Xt, const int8_t* Wt) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          unsigned r[2][4];
          packed_rows(r[0], Wt, q, wn, lane);
          packed_rows(r[1], Wt, q, wn + 32, lane);
#pragma unroll
          for (int g = 0; g < F; ++g) {
            const int kk = g * Q + q;   // positions g * TT + 16q..
            unsigned b[8][2];           // (even, odd) x 4 chunks; b0, b1
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              split_lanes<BITS>(r[h][0], g, b[4 * h][0], b[4 * h + 1][0]);
              split_lanes<BITS>(r[h][1], g, b[4 * h][1], b[4 * h + 1][1]);
              split_lanes<BITS>(r[h][2], g, b[4 * h + 2][0],
                                b[4 * h + 3][0]);
              split_lanes<BITS>(r[h][3], g, b[4 * h + 2][1],
                                b[4 * h + 3][1]);
            }
            unsigned a[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
              ldsm_x4(a[mt], Xt + (wm + 16 * mt + (lane & 15)) * XS +
                                 16 * kk + (lane >> 4) * 8);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
          }
        }
      });
  // tile 2ch holds columns 4c and 4c + 2 of chunk ch, tile 2ch + 1
  // columns 4c + 1 and 4c + 3: four adjacent outputs a row
  const int gq = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const int n = n0 + wn + 16 * ch + 4 * c4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + 16 * mt + gq + 8 * half;
        if (m >= M || n >= N) continue;
        const float* e = acc[mt][2 * ch];
        const float* o = acc[mt][2 * ch + 1];
        const int i0 = 2 * half, i1 = 2 * half + 1;
        if (part != nullptr)
          *reinterpret_cast<float4*>(
              part + ((size_t)blockIdx.z * M + m) * N + n) =
              make_float4(e[i0], o[i0], e[i1], o[i1]);
        else
          *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = make_uint2(
              pack_bf16(__fmul_rn(e[i0], ws[n]), __fmul_rn(o[i0], ws[n + 1])),
              pack_bf16(__fmul_rn(e[i1], ws[n + 2]),
                        __fmul_rn(o[i1], ws[n + 3])));
      }
    }
}

// M <= 16: D^T = W^T x^T for 128 columns; warp w owns columns 32 * w..
// as two 16-row A tiles of W^T (a 16-column chunk each, even columns in
// rows 0-7, odd in rows 8-15) and every row of x (two 8-column B tiles,
// the second only when M > 8).
template <int BITS>
__global__ void __launch_bounds__(COLS_NT)
wo_mma_cols(const bf16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ ws, bf16* __restrict__ out,
            float* __restrict__ part, int M, int N, int K, int per_split) {
  constexpr int F = 8 / BITS, Q = MMA_BK / F / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * COLS_BM, n0 = blockIdx.x * MMA_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp * 32;
  const bool two = M - m0 > 8;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  wo_loop<BITS, COLS_BM, COLS_NT, COLS_ST>(
      x, w, smem_raw, M, N, K, per_split, m0, n0,
      [&](const bf16* Xt, const int8_t* Wt) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          unsigned r[4];
          packed_rows(r, Wt, q, wn, lane);
#pragma unroll
          for (int g = 0; g < F; ++g) {
            const int kk = g * Q + q;
            unsigned a[2][4], xb[4];
            split_lanes<BITS>(r[0], g, a[0][0], a[0][1]);
            split_lanes<BITS>(r[1], g, a[0][2], a[0][3]);
            split_lanes<BITS>(r[2], g, a[1][0], a[1][1]);
            split_lanes<BITS>(r[3], g, a[1][2], a[1][3]);
            ldsm_x4(xb, Xt + ((lane & 7) + (lane >> 4) * 8) * XS + 16 * kk +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][0], a[mt], xb[0], xb[1]);
              if (two) mma_bf16(acc[mt][1], a[mt], xb[2], xb[3]);
            }
          }
        }
      });
  // A row gq is column 2gq of the chunk, row gq + 8 column 2gq + 1
  const int gq = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn + 16 * mt + 2 * gq;
        const int m = m0 + 8 * j + 2 * c4 + e;
        if (m >= M || n >= N) continue;
        const float v0 = acc[mt][j][e], v1 = acc[mt][j][2 + e];
        if (part != nullptr)
          *reinterpret_cast<float2*>(
              part + ((size_t)blockIdx.z * M + m) * N + n) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<unsigned*>(out + (size_t)m * N + n) =
              pack_bf16(__fmul_rn(v0, ws[n]), __fmul_rn(v1, ws[n + 1]));
      }
}

// ---------------------------------------------------------------------------
// Integer kernel: mma.sync m16n8k32 s8 with a cp.async ring.  Stage
// position (run rr, t) holds base position j0 + t of lane groups g with
// g % R == rr, for x (R = RA) and w (R = RW) alike.
//
// x stays packed in shared memory as it lies in memory (RA runs of TT
// bytes a row), so `ldmatrix` gives each lane four consecutive positions
// of one row: an s8 fragment once lane g / RA of each byte is taken.
// The packed weight tile keeps RW runs of TT rows of 128 bytes; within
// each 16 rows, row t sits in slot `w_slot(t)`, so that one
// `ldmatrix.trans` of 32 consecutive slots hands lane (gq, c) the rows
// 4c, 4c + 1 (first register) and 4c + 2, 4c + 3 (second) of columns
// 2gq and 2gq + 1, for k 0..15 and again for 16..31 of a 32-row chunk.
// `__byte_perm` sorts them into the four k of one column that an s8
// fragment wants: the even column's and the odd one's.
// ---------------------------------------------------------------------------
// Base positions a stage: two 32-row chunks a run, one when F = 4 (so
// that a stage of x is at most 128 bytes a row).
constexpr int int_tt(int f) { return f == 4 ? 32 : 64; }

template <int ABITS, int WBITS>
struct IntMma {
  static constexpr int FA = 8 / ABITS, FW = 8 / WBITS;
  static constexpr int F = FA > FW ? FA : FW;
  static constexpr int RA = F / FA, RW = F / FW;   // runs a stage: x, w
  static constexpr int TT = int_tt(F);
  static constexpr int Q = TT / 32;                // 32-row chunks a run
  static constexpr int XB = RA * TT + 16;          // padded x row, bytes
  static constexpr int W_BYTES = RW * TT * WPS;    // packed w, one slot
  static constexpr size_t smem_bytes(int bm, int st) {
    return (size_t)st * (bm * XB + W_BYTES);
  }
};

// Slot of packed row t within its stage run: the slots of each 16 rows
// hold rows 0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15.
__device__ __forceinline__ int w_slot(int t) {
  const int r = t & 15;
  return (t & ~15) | ((r & 2) << 2) | ((r >> 1) & 6) | (r & 1);
}

// Start the copies of stage `st` into one ring slot: x rows m0..m0+BM
// (zero past M), RA runs of TT bytes each, and RW runs of TT packed w
// rows of columns n0..n0+128 (zero past N).
template <int ABITS, int WBITS, int BM, int NT>
__device__ __forceinline__ void int_stage(const int8_t* xq, const int8_t* w,
                                          int8_t* Xs, int8_t* Ws, int st,
                                          int M, int N, int K, int m0, int n0,
                                          int tid) {
  using L = IntMma<ABITS, WBITS>;
  constexpr int XC = L::RA * L::TT / 16;           // 16-byte chunks a row
  const int kb = K / L::F, ka = K / L::FA, j0 = st * L::TT;
  for (int c = tid; c < BM * XC; c += NT) {
    const int r = c / XC, p = (c % XC) * 16, m = m0 + r;
    cp_async16(Xs + r * L::XB + p,
               xq + (size_t)min(m, M - 1) * ka + (size_t)(p / L::TT) * kb +
                   j0 + p % L::TT,
               m < M);
  }
  for (int c = tid; c < L::RW * L::TT * (MMA_BN / 16); c += NT) {
    const int row = c / (MMA_BN / 16), dn = (c % (MMA_BN / 16)) * 16;
    const int rr = row / L::TT, t = row % L::TT;
    const bool ok = n0 + dn < N;
    cp_async16(Ws + (rr * L::TT + w_slot(t)) * WPS + dn,
               w + ((size_t)rr * kb + j0 + t) * N + (ok ? n0 + dn : 0), ok);
  }
}

// Lane l of four packed bytes, each sign-extended to an s8 in its byte:
// mask the lane, flip its sign bit (v + 2^(BITS-1)) and subtract
// 2^(BITS-1) byte by byte.
template <int BITS>
__device__ __forceinline__ unsigned s8_lanes(unsigned r, int l) {
  if constexpr (BITS == 8) {
    return r;
  } else {
    constexpr unsigned MASK = ((1u << BITS) - 1) * 0x01010101u;
    constexpr unsigned SIGN = (1u << (BITS - 1)) * 0x01010101u;
    return __vsub4(((r >> (BITS * l)) & MASK) ^ SIGN, SIGN);
  }
}

// The weight's fragments for 16 columns from `col` and the 32 packed
// rows from slot `row0`: f[0], f[1] the even and odd columns at k 0..15,
// f[2], f[3] at k 16..31.  As B: (f[0], f[2]) and (f[1], f[3]); as the
// A of W^T (rows 0-7 even columns, 8-15 odd): f itself.
__device__ __forceinline__ void packed_k32(unsigned (&f)[4], const int8_t* Wt,
                                           int row0, int col, int lane) {
  unsigned r[4];
  ldsm_x4_t(r, Wt + (row0 + lane) * WPS + col);
  f[0] = __byte_perm(r[0], r[1], 0x6420);
  f[1] = __byte_perm(r[0], r[1], 0x7531);
  f[2] = __byte_perm(r[2], r[3], 0x6420);
  f[3] = __byte_perm(r[2], r[3], 0x7531);
}

// The k loop of both integer routes: `consume(Xt, Wt)` on each stage's
// packed x tile and packed weight tile.
template <int ABITS, int WBITS, int BM, int NT, int ST, typename Consume>
__device__ __forceinline__ void int_loop(const int8_t* xq, const int8_t* w,
                                         unsigned char* smem, int M, int N,
                                         int K, int per_split, int m0, int n0,
                                         Consume consume) {
  using L = IntMma<ABITS, WBITS>;
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ws = Xs + ST * BM * L::XB;
  stage_ring<ST>(
      K / (L::F * L::TT), per_split,
      [&](int st, int slot) {
        int_stage<ABITS, WBITS, BM, NT>(xq, w, Xs + slot * BM * L::XB,
                                        Ws + slot * L::W_BYTES, st, M, N, K,
                                        m0, n0, threadIdx.x);
      },
      [&](int slot) {
        consume(Xs + slot * BM * L::XB, Ws + slot * L::W_BYTES);
      });
}

__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// M > 16: out (or a split's int32 partial) for 128 x 128 outputs; warp w
// owns rows 64 * (w / 2).. and columns 64 * (w % 2).. of the block's
// tile, as eight 8-column mma tiles: even and odd columns of four
// 16-column chunks.  Lane group g of a chunk takes x run g % RA, lane
// g / RA, and w run g % RW, lane g / RW; a run shared by every group is
// loaded once.
template <int ABITS, int WBITS>
__global__ void __launch_bounds__(ROWS_NT, 2)
int_mma_rows(const int8_t* __restrict__ xq, const float* __restrict__ xs,
             const int8_t* __restrict__ w, const float* __restrict__ ws,
             float* __restrict__ out, int* __restrict__ part, int M, int N,
             int K, int per_split) {
  using L = IntMma<ABITS, WBITS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * ROWS_BM, n0 = blockIdx.x * MMA_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  int acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int_loop<ABITS, WBITS, ROWS_BM, ROWS_NT, ROWS_ST>(
      xq, w, smem_raw, M, N, K, per_split, m0, n0,
      [&](const int8_t* Xt, const int8_t* Wt) {
        unsigned xr[4][4], wr[4][4];
        auto load_x = [&](int run, int q) {
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            ldsm_x4(xr[mt], Xt + (wm + 16 * mt + (lane & 15)) * L::XB +
                                run * L::TT + 32 * q + (lane >> 4) * 16);
        };
        auto load_w = [&](int run, int q) {
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
            packed_k32(wr[ch], Wt, run * L::TT + 32 * q, wn + 16 * ch, lane);
        };
#pragma unroll
        for (int q = 0; q < L::Q; ++q) {
          if constexpr (L::RA == 1) load_x(0, q);
          if constexpr (L::RW == 1) load_w(0, q);
#pragma unroll
          for (int g = 0; g < L::F; ++g) {
            if constexpr (L::RA > 1) load_x(g % L::RA, q);
            if constexpr (L::RW > 1) load_w(g % L::RW, q);
            unsigned b[4][4];
#pragma unroll
            for (int ch = 0; ch < 4; ++ch)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                b[ch][i] = s8_lanes<WBITS>(wr[ch][i], g / L::RW);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              unsigned a[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                a[i] = s8_lanes<ABITS>(xr[mt][i], g / L::RA);
#pragma unroll
              for (int ch = 0; ch < 4; ++ch) {
                mma_s8(acc[mt][2 * ch], a, b[ch][0], b[ch][2]);
                mma_s8(acc[mt][2 * ch + 1], a, b[ch][1], b[ch][3]);
              }
            }
          }
        }
      });
  // tile 2ch holds columns 4c and 4c + 2 of chunk ch, tile 2ch + 1
  // columns 4c + 1 and 4c + 3: four adjacent outputs a row
  const int gq = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const int n = n0 + wn + 16 * ch + 4 * c4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + 16 * mt + gq + 8 * half;
        if (m >= M || n >= N) continue;
        const int* e = acc[mt][2 * ch];
        const int* o = acc[mt][2 * ch + 1];
        const int i0 = 2 * half, i1 = 2 * half + 1;
        if (part != nullptr) {
          *reinterpret_cast<int4*>(part + ((size_t)blockIdx.z * M + m) * N +
                                   n) = make_int4(e[i0], o[i0], e[i1], o[i1]);
        } else {
          const float s = xs[m];
          *reinterpret_cast<float4*>(out + (size_t)m * N + n) = make_float4(
              dequant(e[i0], s, ws[n]), dequant(o[i0], s, ws[n + 1]),
              dequant(e[i1], s, ws[n + 2]), dequant(o[i1], s, ws[n + 3]));
        }
      }
    }
}

// M <= 16: D^T = W^T x^T for 128 columns; warp w owns columns 32 * w..
// as two 16-row A tiles of W^T (a 16-column chunk each, even columns in
// rows 0-7, odd in rows 8-15) and every row of x (two 8-column B tiles,
// the second only when M > 8).
template <int ABITS, int WBITS>
__global__ void __launch_bounds__(COLS_NT)
int_mma_cols(const int8_t* __restrict__ xq, const float* __restrict__ xs,
             const int8_t* __restrict__ w, const float* __restrict__ ws,
             float* __restrict__ out, int* __restrict__ part, int M, int N,
             int K, int per_split) {
  using L = IntMma<ABITS, WBITS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * COLS_BM, n0 = blockIdx.x * MMA_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp * 32;
  const bool two = M - m0 > 8;
  int acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int_loop<ABITS, WBITS, COLS_BM, COLS_NT, COLS_ST>(
      xq, w, smem_raw, M, N, K, per_split, m0, n0,
      [&](const int8_t* Xt, const int8_t* Wt) {
        unsigned xr[4], wr[2][4];
        auto load_x = [&](int run, int q) {
          ldsm_x4(xr, Xt + ((lane & 7) + (lane >> 4) * 8) * L::XB +
                          run * L::TT + 32 * q + ((lane >> 3) & 1) * 16);
        };
        auto load_w = [&](int run, int q) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            packed_k32(wr[mt], Wt, run * L::TT + 32 * q, wn + 16 * mt, lane);
        };
#pragma unroll
        for (int q = 0; q < L::Q; ++q) {
          if constexpr (L::RA == 1) load_x(0, q);
          if constexpr (L::RW == 1) load_w(0, q);
#pragma unroll
          for (int g = 0; g < L::F; ++g) {
            if constexpr (L::RA > 1) load_x(g % L::RA, q);
            if constexpr (L::RW > 1) load_w(g % L::RW, q);
            unsigned xb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              xb[i] = s8_lanes<ABITS>(xr[i], g / L::RA);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              unsigned a[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                a[i] = s8_lanes<WBITS>(wr[mt][i], g / L::RW);
              mma_s8(acc[mt][0], a, xb[0], xb[1]);
              if (two) mma_s8(acc[mt][1], a, xb[2], xb[3]);
            }
          }
        }
      });
  // A row gq is column 2gq of the chunk, row gq + 8 column 2gq + 1
  const int gq = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn + 16 * mt + 2 * gq;
        const int m = m0 + 8 * j + 2 * c4 + e;
        if (m >= M || n >= N) continue;
        const int v0 = acc[mt][j][e], v1 = acc[mt][j][2 + e];
        if (part != nullptr)
          *reinterpret_cast<int2*>(part + ((size_t)blockIdx.z * M + m) * N +
                                   n) = make_int2(v0, v1);
        else
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(
              dequant(v0, xs[m], ws[n]), dequant(v1, xs[m], ws[n + 1]));
      }
}

__global__ void int_reduce(const int* __restrict__ part,
                           const float* __restrict__ xs,
                           const float* __restrict__ ws, float* __restrict__ out,
                           int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += part[z * mn + i];
  out[i] = dequant(s, xs[i / N], ws[i % N]);
}

// ---------------------------------------------------------------------------
// Host side: tiles, splits, dispatch over formats.
// ---------------------------------------------------------------------------
constexpr int BN = 64;

// (BM, TM): 16-row tiles for decode-sized M, 64-row tiles otherwise.
inline bool small_m(int M) { return M <= 16; }

// Splits of K that bring a grid of `grid` output tiles up to `target`
// blocks, with at least MIN_STAGES_PER_SPLIT stages a split.
int splits_for(long grid, int n_stages, int target) {
  if (grid >= target) return 1;
  int s = (int)((target + grid - 1) / grid);
  const int cap = n_stages / MIN_STAGES_PER_SPLIT;
  if (s > cap) s = cap;
  return s < 1 ? 1 : s;
}

// The CUDA-core kernel (float32 weight-only).
int split_count(int M, int N, int n_stages) {
  const int bm = small_m(M) ? 16 : 64;
  return splits_for((long)((M + bm - 1) / bm) * ((N + BN - 1) / BN),
                    n_stages, TARGET_BLOCKS);
}

// The tensor-core routes (bf16 weight-only and integer).
int mma_split_count(int M, int N, int n_stages) {
  const bool cols = small_m(M);
  const int bm = cols ? COLS_BM : ROWS_BM;
  return splits_for((long)((M + bm - 1) / bm) * ((N + MMA_BN - 1) / MMA_BN),
                    n_stages, cols ? COLS_TARGET_BLOCKS : TARGET_BLOCKS);
}


// Raise a kernel's dynamic shared-memory cap once per instantiation.
template <typename Kernel>
cudaError_t raise_smem_cap(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

int per_split(int n_stages, int splits) { return (n_stages + splits - 1) / splits; }

template <int BITS>
int launch_wo_fma(const void* x, const void* w, const float* ws, void* out,
                  float* part, int M, int N, int K, int splits,
                  cudaStream_t s) {
  constexpr int TT = WO_BK / (8 / BITS);
  const int n_stages = (K / (8 / BITS) + TT - 1) / TT;
  const int per = per_split(n_stages, splits);
  float* p = splits > 1 ? part : nullptr;
  const float* xt = static_cast<const float*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  float* o = static_cast<float*>(out);
  if (small_m(M)) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    wo_kernel<BITS, 16, BN, 2><<<grid, (16 / 2) * (BN / 4), 0, s>>>(
        xt, wt, ws, o, p, M, N, K, per);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    wo_kernel<BITS, 64, BN, 4><<<grid, (64 / 4) * (BN / 4), 0, s>>>(
        xt, wt, ws, o, p, M, N, K, per);
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    wo_reduce<float><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
        part, ws, o, M, N, splits);
  }
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_wo_mma(const void* x, const void* w, const float* ws, void* out,
                  float* part, int M, int N, int K, int splits,
                  cudaStream_t s) {
  // what the 16-byte copies rely on: x runs and weight rows start on
  // 16-byte boundaries, and a stage never crosses a lane group's run
  if (K % MMA_BK != 0 || N % 16 != 0 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out) || (splits > 1 && !aligned16(part)))
    return (int)cudaErrorInvalidValue;
  const int per = per_split(K / MMA_BK, splits);
  float* p = splits > 1 ? part : nullptr;
  const bf16* xt = static_cast<const bf16*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t e;
  if (small_m(M)) {
    static bool ok = false;
    const size_t smem = WoMma<BITS, COLS_BM, COLS_ST>::smem_bytes();
    if ((e = raise_smem_cap(wo_mma_cols<BITS>, smem, &ok)) != cudaSuccess)
      return (int)e;
    dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + COLS_BM - 1) / COLS_BM, splits);
    wo_mma_cols<BITS><<<grid, COLS_NT, smem, s>>>(xt, wt, ws, o, p, M, N, K,
                                                  per);
  } else {
    static bool ok = false;
    const size_t smem = WoMma<BITS, ROWS_BM, ROWS_ST>::smem_bytes();
    if ((e = raise_smem_cap(wo_mma_rows<BITS>, smem, &ok)) != cudaSuccess)
      return (int)e;
    dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + ROWS_BM - 1) / ROWS_BM, splits);
    wo_mma_rows<BITS><<<grid, ROWS_NT, smem, s>>>(xt, wt, ws, o, p, M, N, K,
                                                  per);
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    wo_reduce<bf16><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
        part, ws, o, M, N, splits);
  }
  return (int)cudaGetLastError();
}

// x_dtype 0 = float32 (CUDA cores), 1 = bf16 (tensor cores).
int wo_bits(int w_bits, int x_dtype, const void* x, const void* w,
            const float* ws, void* out, float* part, int M, int N, int K,
            int splits, cudaStream_t s) {
#define WO_CASE(B)                                                          \
  case B:                                                                   \
    return x_dtype == 1                                                     \
               ? launch_wo_mma<B>(x, w, ws, out, part, M, N, K, splits, s)  \
               : launch_wo_fma<B>(x, w, ws, out, part, M, N, K, splits, s);
  switch (w_bits) {
    WO_CASE(8)
    WO_CASE(4)
    WO_CASE(2)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WO_CASE
}

template <int A, int W>
int launch_int(const int8_t* xq, const float* xs, const int8_t* w,
               const float* ws, float* out, int* part, int M, int N, int K,
               int splits, cudaStream_t s) {
  using L = IntMma<A, W>;
  // what the 16-byte copies rely on: x runs and weight rows start on
  // 16-byte boundaries, and a stage never crosses a lane group's run
  if (K % (L::F * L::TT) != 0 || N % 16 != 0 || !aligned16(xq) ||
      !aligned16(w) || !aligned16(out) || (splits > 1 && !aligned16(part)))
    return (int)cudaErrorInvalidValue;
  const int per = per_split(K / (L::F * L::TT), splits);
  int* p = splits > 1 ? part : nullptr;
  cudaError_t e;
  if (small_m(M)) {
    static bool ok = false;
    const size_t smem = L::smem_bytes(COLS_BM, COLS_ST);
    if ((e = raise_smem_cap(int_mma_cols<A, W>, smem, &ok)) != cudaSuccess)
      return (int)e;
    dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + COLS_BM - 1) / COLS_BM, splits);
    int_mma_cols<A, W><<<grid, COLS_NT, smem, s>>>(xq, xs, w, ws, out, p, M,
                                                   N, K, per);
  } else {
    static bool ok = false;
    const size_t smem = L::smem_bytes(ROWS_BM, ROWS_ST);
    if ((e = raise_smem_cap(int_mma_rows<A, W>, smem, &ok)) != cudaSuccess)
      return (int)e;
    dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + ROWS_BM - 1) / ROWS_BM, splits);
    int_mma_rows<A, W><<<grid, ROWS_NT, smem, s>>>(xq, xs, w, ws, out, p, M,
                                                   N, K, per);
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    int_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, xs, ws, out,
                                                            M, N, splits);
  }
  return (int)cudaGetLastError();
}

template <int A>
int int_wbits(int w_bits, const int8_t* xq, const float* xs, const int8_t* w,
              const float* ws, float* out, int* part, int M, int N, int K,
              int splits, cudaStream_t s) {
  switch (w_bits) {
    case 8: return launch_int<A, 8>(xq, xs, w, ws, out, part, M, N, K, splits, s);
    case 4: return launch_int<A, 4>(xq, xs, w, ws, out, part, M, N, K, splits, s);
    case 2: return launch_int<A, 2>(xq, xs, w, ws, out, part, M, N, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bits_ok(int b) { return b == 8 || b == 4 || b == 2; }

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K splits the wrapper must allocate partials for: (splits, M, N) float32
// (wo_matmul) or int32 (mpq_matmul) when the count is above 1.
extern "C" int wo_matmul_splits(int M, int N, int K, int w_bits,
                                int x_dtype) {
  if (!bits_ok(w_bits)) return -1;
  if (x_dtype == 1) return mma_split_count(M, N, K / MMA_BK);
  const int tt = WO_BK / (8 / w_bits);
  return split_count(M, N, (K / (8 / w_bits) + tt - 1) / tt);
}

extern "C" int mpq_matmul_splits(int M, int N, int K, int a_bits, int w_bits) {
  if (!bits_ok(a_bits) || !bits_ok(w_bits)) return -1;
  const int f = (8 / a_bits) > (8 / w_bits) ? (8 / a_bits) : (8 / w_bits);
  return mma_split_count(M, N, K / (f * int_tt(f)));
}

// x (M, K) contiguous, dtype 0 = float32, 1 = bf16 (then K % 64 == 0,
// N % 16 == 0 and every pointer 16-byte aligned); w (K / (8 / w_bits), N)
// int8 in the strided layout; w_scale (N,) float32; out (M, N) of x's
// dtype; part: (splits, M, N) float32 when splits > 1.
extern "C" int wo_matmul(const void* x, const void* w, const void* w_scale,
                         void* out, void* part, int M, int N, int K, int w_bits,
                         int x_dtype, int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (!bits_ok(w_bits) || splits < 1 || (splits > 1 && part == nullptr) ||
      K % (8 / w_bits) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ws = static_cast<const float*>(w_scale);
  float* p = static_cast<float*>(part);
  if (x_dtype != 0 && x_dtype != 1) return (int)cudaErrorInvalidValue;
  return wo_bits(w_bits, x_dtype, x, w, ws, out, p, M, N, K, splits, s);
}

// x_q (M, K / (8 / a_bits)) int8 and w (K / (8 / w_bits), N) int8, both in
// the strided layout (K % 128 == 0, 64 at a8w8; N % 16 == 0; every
// pointer 16-byte aligned); x_scale (M,) and w_scale (N,) float32; out
// (M, N) float32; part: (splits, M, N) int32 when splits > 1.
extern "C" int mpq_matmul(const void* x_q, const void* x_scale, const void* w,
                          const void* w_scale, void* out, void* part, int M,
                          int N, int K, int a_bits, int w_bits, int splits,
                          void* stream) {
  if (M == 0 || N == 0) return 0;
  if (!bits_ok(a_bits) || !bits_ok(w_bits) || splits < 1 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x_q);
  const float* xs = static_cast<const float*>(x_scale);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  int* p = static_cast<int*>(part);
  switch (a_bits) {
    case 8: return int_wbits<8>(w_bits, xq, xs, wq, ws, o, p, M, N, K, splits, s);
    case 4: return int_wbits<4>(w_bits, xq, xs, wq, ws, o, p, M, N, K, splits, s);
    case 2: return int_wbits<2>(w_bits, xq, xs, wq, ws, o, p, M, N, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
