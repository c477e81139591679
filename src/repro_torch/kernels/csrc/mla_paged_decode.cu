// MLA compressed-space paged decode partials, read straight from the
// latent page pool.
//
// Replaces: the Pallas bodies `_mla_page_kernel` (fp pool) and
// `_mla_page_kernel_quant` (int8 / packed int4 pool) behind
// `repro/kernels/paged_flash_decode.py::mla_paged_decode_partials` (TPU).
//
// Inputs: pool (N, ps, R + DR) — one latent row per cached token, the
// normalised c_kv (R wide) followed by the roped k_rope (DR wide); a
// quantized pool (entry point `mla_paged_decode_partials_quant`) holds
// int8 rows (N, ps, 576) or packed int4 rows (N, ps, 288) with one (N, ps)
// float32 scale a row covering c_kv and k_rope alike: each row is
// dequantized whole (page_rows.cuh), and only then split at R, as the
// reference's `_mla_page_kernel_quant` does; absorbed queries q_c
// (B, Sq, H, R) and q_rope (B, Sq, H, DR); tbl (B, P) int32 page table
// (-1 = unmapped); pos (B,) int32 slot positions (-1 = inactive slot).
// Output: float32 partials m, l (B, Sq, H, S) and acc (B, Sq, H, S, R)
// over S splits of the logical page axis, split s covering pages
// [s*c, (s+1)*c) with c = pages_per_split.  For each live key row k
// (mapped, kpos <= pos[b]):
//   sc = ((q_c . c_k) + (q_rope . kr_k)) * scale      (each dot in float32)
//   m = max sc,  w = exp(sc - m),  l = sum w,  acc = sum round(w) * c_k
// where round() is the input type (the reference casts w before the
// product) and scale = (nope + rope)^-0.5 comes from the caller.  Every
// query row of a slot shares the slot's one position, as in the
// reference.  A page is skipped, and the pool never read for it, when its
// table entry is < 0 or it starts past pos[b] (pos = -1 skips them all);
// a split with nothing live writes the exact identities m = -1e30, l = 0,
// acc = 0.  With c = 1 these are the reference's per-page partials; inside
// a split the keys are walked in order with the online softmax, the same
// reduction as the caller's combine.  The engine's decode takes one
// 64-key tile a split (`models/mla.py::decode_split`: 4 pages at page
// 16, 2 at page 32, more only where the partials would pass the engine's
// memory budget), not one page: per-page partials of 16 heads x 512
// float32 (32 KB a page at page 16) would outweigh the 18 KB bf16 page
// they come from.  MMA_BK is the wrapper's TILE_KEYS.
//
// What bounds it on an H100: a decode step reads each live latent page
// once, (R + DR) elements a row, and does ~2 * H * (2R + DR) operations a
// row, far below ~295 operations per byte, so it is memory-bound; the
// float32 partials it writes (B * Sq * H * S * (R + 2) * 4 bytes, 8.4 MB a
// layer at B 8, H 16, 32 splits) count in the least time beside the live
// pages (7.1 MB in bf16 at the engine's positions; 2x / 4x fewer bytes
// from an int8 / int4 pool, plus 4 bytes of scale a row).
//
// Every route reads each live row once for all H heads (the latent row
// is shared by every head, the point of MLA) and launches one block per
// (16-row tile of the Sq x H query rows, split, slot): row R of a slot is
// query R / H, head R % H; rows past Sq x H are padding and write
// nothing.  The route is chosen before launch by dtype; none falls back
// on another:
//
// * bf16, `mla_partials_mma`: the scores S = Q C^T and the context
//   O = P C on `mma.sync` m16n8k16 (bf16 in, float32 sums) from ONE
//   staged key tile C, since the latent row is key and value at once.
//   At H 16 the 16 query rows of a slot are exactly one m16 tile, which
//   is why this is `mma.sync` and not `wgmma`: a warpgroup product takes
//   64 rows, and three quarters of it would multiply padding.  Q (q_c and
//   q_rope side by side, 576 wide) sits in shared memory as bf16.  A key
//   tile is 64 rows (four pages at page 16, two at 32), copied by 16-byte
//   `cp.async` through the page table: 64 threads first look up each
//   key's pool row (-1: unmapped, past pos[b] or past the split), so dead
//   rows are zero-filled and never read, and one `__syncthreads_or` skips
//   a tile with no live key.  Scores: each of the four warps takes 16 keys
//   over k = 576 (the 512 c_kv columns into one float32 sum, the 64
//   k_rope columns into another, added as the reference adds its two
//   dots), C^T by plain `ldmatrix`; scale and mask, then the row max and
//   sum are exchanged across the warps through shared memory.  The
//   weights, rounded to bf16, go to shared memory; the context reads them
//   as A fragments and C's first 512 columns by `ldmatrix.trans` from the
//   same tile, each warp owning 128 output columns (64 float32
//   accumulators a thread).  A split longer than one tile keeps the online
//   softmax across tiles.  One block is one tile at the engine's split,
//   so the tile is single-buffered and the overlap of copies with
//   products comes from the two blocks an SM holds (shared memory below
//   113 KB: 94 KB fp, 104 KB int8, 95 KB int4): B 8 x 32 splits = 256
//   blocks on 132 SMs, one wave.
//   On a quantized pool a `cp.async` cannot dequantize: the raw rows (576
//   bytes at int8, 288 at int4) and each key's scale (4-byte `cp.async`,
//   0 for a dead key, whose zero bytes then widen to exact zeros) land
//   first, and one shared-memory pass widens them into the bf16 tile with
//   the reference's op sequence (page_rows.cuh), so that on the pool
//   dequantized to bf16 the fp and quantized routes give the same bits.
//   The raw rows are copied into the tile's own tail (and a little past
//   it) so as not to cost a second tile of shared memory: rows
//   [0, SPLIT) are widened first, their bf16 rows ending before the raw
//   region starts; then, after a barrier, rows [SPLIT, 64), whose raw
//   rows lie past the tile's end.
// * float32, `mla_partials_kernel`: FMA on the CUDA cores (float32 on
//   tensor cores would be TF32, another function).  The block stages 16
//   pool rows at a time in shared memory as float32 with 16-byte vector
//   loads (a row is 1152 bytes in bf16, 2304 in float32, 576 in int8 and
//   288 in int4, all multiples of 16, so every row of a 16-byte-aligned
//   pool starts on a 16-byte boundary; an int4 vector of bytes j..j+15
//   yields elements j..j+15 and j+288..j+303).  Thread (row, key)
//   computes one score; the 16 keys of a row sit in one half warp, so the
//   row's max and sum are half-warp shuffles; then thread (row, lane)
//   keeps output dims lane, lane + 16, ... of its row in registers.
#include "mma.cuh"
#include "page_rows.cuh"

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// float32 route: FMA on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int BQ = 16;                  // query rows (q, h) per block
constexpr int BK = 16;                  // pool rows staged per step
constexpr int NT = BQ * BK;             // one thread per (row, key)

template <int R, int DR>
struct MlaSmem {
  static constexpr int W = R + DR;
  static constexpr int RS = W + 1;      // padded row stride (floats)
  static constexpr int PS = BK + 1;
  static constexpr size_t bytes() {
    return sizeof(float) * (BQ * RS + BK * RS + BQ * PS);
  }
};

// Stage the 16-byte vector v of a stored W-wide row into the float32 row
// `dst`: 8 bf16 or 4 float32 values as they are; 16 int8 lanes; or 16
// int4 bytes, whose low nibbles are elements 16v.. and high nibbles
// elements W/2 + 16v.. (the strided layout), each dequantized with the
// row's `scale`.
template <typename T, int BITS, int W>
__device__ __forceinline__ void stage16(const stored_t<T, BITS>* row,
                                        float scale, int v, float* dst) {
  constexpr int PER = 16 / sizeof(stored_t<T, BITS>);
  const int e = v * PER;
  const uint4 raw = *reinterpret_cast<const uint4*>(row + e);
  if constexpr (BITS == 0) {
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[e + i] = to_f<T>(x[i]);
  } else {
    const uint8_t* x = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dst[e + i] = dequant<T>(lane_value<BITS>(x[i], 0), scale);
      if constexpr (BITS == 4)
        dst[W / 2 + e + i] = dequant<T>(lane_value<4>(x[i], 1), scale);
    }
  }
}

// BITS 0: an fp pool of T; 8 / 4: a quantized pool with row scales.
template <typename T, int BITS, int R, int DR>
__global__ void __launch_bounds__(NT)
mla_partials_kernel(const stored_t<T, BITS>* __restrict__ pool,
                    const float* __restrict__ scales,
                    const T* __restrict__ q_c,
                    const T* __restrict__ q_rope, const int* __restrict__ tbl,
                    const int* __restrict__ pos, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ acc_out,
                    int Sq, int H, int ps, int P, int pages_per_split,
                    int n_splits, float scale) {
  using S = MlaSmem<R, DR>;
  constexpr int W = S::W, RS = S::RS;
  constexpr int SW = stored_width<BITS, W>();   // stored row length
  constexpr int NV = SW * sizeof(stored_t<T, BITS>) / 16;  // 16-byte vectors
  constexpr int ND = R / BK;            // output dims per thread
  static_assert(R % BK == 0 && NV * 16 == SW * sizeof(stored_t<T, BITS>),
                "widths");
  extern __shared__ float smem[];
  float* Qs = smem;                     // BQ x (R + DR) queries
  float* Ks = Qs + BQ * RS;             // BK x (R + DR) pool rows
  float* Ps = Ks + BK * RS;             // BQ x BK weights, rounded to T

  const int b = blockIdx.z, split = blockIdx.y, row0 = blockIdx.x * BQ;
  const int rows = Sq * H;
  const int tid = threadIdx.x;
  const int r = tid / BK, lane = tid % BK;    // row of the tile; key / lane
  const int R_ = row0 + r;
  const bool row_valid = R_ < rows;
  const int pb = pos[b];

  // stage the tile's queries: row rr = (query qi, head h) at R = qi*H + h
  for (int idx = tid; idx < BQ * W; idx += NT) {
    const int rr = idx / W, d = idx % W, Rq = row0 + rr;
    float v = 0.f;
    if (Rq < rows) {
      const size_t qr = (size_t)b * rows + Rq;
      v = d < R ? to_f<T>(q_c[qr * R + d]) : to_f<T>(q_rope[qr * DR + d - R]);
    }
    Qs[rr * RS + d] = v;
  }

  float m = ATTN_NEG_INF, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, P);
  for (int j = j0; j < j1; ++j) {
    const int page = tbl[b * P + j];
    for (int sub = 0; sub < ps; sub += BK) {
      const int kbase = j * ps + sub;
      // block-uniform skip: unmapped page, or rows past the slot position
      if (page < 0 || kbase > pb) break;
      __syncthreads();                  // queries staged / Ks, Ps consumed
      const size_t srow = (size_t)page * ps + sub;  // cache row of c = 0
      for (int v = tid; v < BK * NV; v += NT) {
        const int c = v / NV;
        stage16<T, BITS, W>(pool + (srow + c) * SW,
                            BITS ? scales[srow + c] : 0.f, v % NV,
                            Ks + c * RS);
      }
      __syncthreads();

      // score of (row r, key lane): the c_kv dot and the k_rope dot,
      // each summed in float32, then added and scaled
      const float* qrow = Qs + r * RS;
      const float* krow = Ks + lane * RS;
      float sc_c = 0.f, sc_r = 0.f;
#pragma unroll 8
      for (int d = 0; d < R; ++d) sc_c = fmaf(qrow[d], krow[d], sc_c);
#pragma unroll 8
      for (int d = R; d < W; ++d) sc_r = fmaf(qrow[d], krow[d], sc_r);
      const bool live = row_valid && kbase + lane <= pb;
      const float sc = live ? (sc_c + sc_r) * scale : ATTN_NEG_INF;

      // the row's 16 keys are the 16 lanes of one half warp
      float mx = sc;
#pragma unroll
      for (int o = BK / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, BK));
      const float m_new = fmaxf(m, mx);
      const float w = sc <= ATTN_NEG_INF / 2 ? 0.f : expf(sc - m_new);
      float sum = w;
#pragma unroll
      for (int o = BK / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o, BK);
      const float corr = expf(m - m_new);
      l = l * corr + sum;
      m = m_new;
      Ps[r * S::PS + lane] = round_to<T>(w);
      __syncwarp();                     // the row's weights are its half warp's

      const float* prow = Ps + r * S::PS;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] *= corr;
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float p = prow[c];
        const float* crow = Ks + c * RS + lane;
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] = fmaf(p, crow[BK * i], acc[i]);
      }
    }
  }
  if (row_valid) {
    const size_t os = ((size_t)b * rows + R_) * n_splits + split;
    if (lane == 0) {
      m_out[os] = m;
      l_out[os] = l;
    }
    float* dst = acc_out + os * R + lane;
#pragma unroll
    for (int i = 0; i < ND; ++i) dst[BK * i] = acc[i];
  }
}

template <typename T, int BITS, int R, int DR>
int launch_fma(const void* pool, const float* scales, const void* q_c,
               const void* q_rope, const int* tbl, const int* pos, float* m,
               float* l, float* acc, int B, int Sq, int H, int ps, int P,
               int pps, int n_splits, float scale, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t smem = MlaSmem<R, DR>::bytes();
  cudaError_t e =
      allow_smem(mla_partials_kernel<T, BITS, R, DR>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq * H + BQ - 1) / BQ, n_splits, B);
  mla_partials_kernel<T, BITS, R, DR><<<grid, NT, smem, stream>>>(
      static_cast<const stored_t<T, BITS>*>(pool), scales,
      static_cast<const T*>(q_c), static_cast<const T*>(q_rope), tbl, pos, m,
      l, acc, Sq, H, ps, P, pps, n_splits, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync m16n8k16 on one key tile that is key and value.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int MMA_NT = 128;             // four warps
constexpr int MMA_BQ = 16;              // query rows a block: one m16 tile
constexpr int MMA_BK = 64;              // keys a tile (16 a warp in S)

constexpr int up16(int x) { return (x + 15) / 16 * 16; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory, in bytes from the base: the bf16 key tile C (MMA_BK rows
// of W, padded by 8 a row); the weights P (MMA_BQ x MMA_BK bf16, padded)
// right after it; a quantized pool's raw rows from RAW on, overlapping the
// tile's tail and P (both dead while raw rows wait to be widened); then Q
// (MMA_BQ rows as C's) and the keys' row scales.
template <int BITS, int R, int DR>
struct MlaMmaTile {
  static constexpr int W = R + DR;
  static constexpr int CS = W + 8;      // padded row strides (bf16)
  static constexpr int PS = MMA_BK + 8;
  static constexpr int TILE = MMA_BK * CS * 2;
  static constexpr int RB = W * BITS / 8;       // raw bytes a row
  // rows widened before the barrier: their bf16 rows end before RAW, and
  // the raw rows after them start at or past TILE
  static constexpr int SPLIT = BITS ? TILE / (CS * 2 + RB) : MMA_BK;
  static constexpr int RAW =
      BITS ? up16(imax(SPLIT * CS * 2, TILE - SPLIT * RB)) : TILE;
  static constexpr int Q = up16(imax(RAW + MMA_BK * RB,
                                     TILE + MMA_BQ * PS * 2));
  static constexpr int SC = Q + MMA_BQ * CS * 2;
  static constexpr int BYTES = SC + (BITS ? MMA_BK * 4 : 0);
  static_assert(RAW >= SPLIT * CS * 2 && RAW + SPLIT * RB >= TILE,
                "the two widening passes must not overlap");
  static_assert(BYTES <= 113 * 1024, "two blocks an SM");
};

// BITS 0: an fp pool of bf16; 8 / 4: a quantized pool with row scales.
template <int BITS, int R, int DR>
__global__ void __launch_bounds__(MMA_NT)
mla_partials_mma(const stored_t<bf16, BITS>* __restrict__ pool,
                 const float* __restrict__ scales,
                 const bf16* __restrict__ q_c,
                 const bf16* __restrict__ q_rope, const int* __restrict__ tbl,
                 const int* __restrict__ pos, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ acc_out,
                 int Sq, int H, int ps, int P, int pages_per_split,
                 int n_splits, float scale) {
  using L = MlaMmaTile<BITS, R, DR>;
  constexpr int W = L::W, CS = L::CS, PS = L::PS, RB = L::RB;
  constexpr int SB = BITS ? RB : W * 2;         // stored bytes a row
  constexpr int KC = R / 16, KR = DR / 16;      // k-steps of S: c_kv, k_rope
  constexpr int OW = R / 4;                     // output columns a warp
  constexpr int NO = OW / 8;                    // their n8 tiles
  constexpr int QC = R / 8, QR = DR / 8;        // 16-byte chunks of a Q row
  static_assert(R % 64 == 0 && DR % 16 == 0, "latent widths");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + L::TILE);
  unsigned char* Craw = smem_raw + L::RAW;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L::Q);
  float* Ssc = reinterpret_cast<float*>(smem_raw + L::SC);
  __shared__ int s_row[MMA_BK];                 // pool row of each key
  __shared__ float s_red[2][MMA_NT / 32][MMA_BQ];   // row max, row sum

  const int b = blockIdx.z, split = blockIdx.y, row0 = blockIdx.x * MMA_BQ;
  const int rows = Sq * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int kw = warp * 16;                     // the warp's keys in S

  // keys of this split that the slot may see: [ks0, klim)
  const int* tb = tbl + (size_t)b * P;
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, P);
  const int ks0 = j0 * ps;
  const int klim = min(j1 * ps, pos[b] + 1);
  const int nt = klim > ks0 ? (klim - ks0 + MMA_BK - 1) / MMA_BK : 0;

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = ATTN_NEG_INF, m1 = ATTN_NEG_INF, l0 = 0.f, l1 = 0.f;

  if (nt > 0) {                         // Q, committed with the first tile
    for (int c = tid; c < MMA_BQ * (QC + QR); c += MMA_NT) {
      const int rr = c / (QC + QR), k = c % (QC + QR), Rq = row0 + rr;
      const size_t qr = (size_t)b * rows + min(Rq, rows - 1);
      const bf16* src = k < QC ? q_c + qr * R + k * 8
                               : q_rope + qr * DR + (k - QC) * 8;
      cp_async16(Qs + rr * CS + k * 8, src, Rq < rows);
    }
  }
  for (int t = 0; t < nt; ++t) {
    const int k0 = ks0 + t * MMA_BK;
    int row = -1;
    if (tid < MMA_BK) {
      const int kpos = k0 + tid;
      if (kpos < klim) {
        const int j = kpos / ps, page = tb[j];
        if (page >= 0) row = page * ps + (kpos - j * ps);
      }
      s_row[tid] = row;
    }
    // the previous tile is consumed; a tile with no live key is skipped
    if (!__syncthreads_or(row >= 0)) continue;
    const auto* src = reinterpret_cast<const unsigned char*>(pool);
    if constexpr (BITS == 0) {
      copy_rows<SB, CS * 2, MMA_BK, MMA_NT>(
          reinterpret_cast<unsigned char*>(Cs), src, s_row, 1, 0, tid);
    } else {
      if (tid < MMA_BK)
        cp_async4(Ssc + tid, row >= 0 ? scales + row : scales, row >= 0);
      copy_rows<SB, RB, MMA_BK, MMA_NT>(Craw, src, s_row, 1, 0, tid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (BITS != 0) {          // the raw rows into the bf16 tile
      widen_rows<BITS, W, CS, MMA_NT>(Cs, Craw, Ssc, 0, L::SPLIT, tid);
      __syncthreads();
      widen_rows<BITS, W, CS, MMA_NT>(Cs, Craw, Ssc, L::SPLIT, MMA_BK, tid);
      __syncthreads();
    }

    // S = Q C^T for the warp's 16 keys: c_kv and k_rope summed apart
    float sc[2][4], sr[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sr[j][e] = 0.f;
    const bf16* Ck = Cs + (kw + (lane & 7) + (lane >> 4) * 8) * CS +
                     ((lane >> 3) & 1) * 8;
    const bf16* Qa = Qs + (lane & 15) * CS + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      unsigned qf[4], kb[4];
      ldsm_x4(qf, Qa + kk * 16);
      ldsm_x4(kb, Ck + kk * 16);
      mma_bf16(sc[0], qf, kb[0], kb[1]);
      mma_bf16(sc[1], qf, kb[2], kb[3]);
    }
#pragma unroll
    for (int kk = KC; kk < KC + KR; ++kk) {
      unsigned qf[4], kb[4];
      ldsm_x4(qf, Qa + kk * 16);
      ldsm_x4(kb, Ck + kk * 16);
      mma_bf16(sr[0], qf, kb[0], kb[1]);
      mma_bf16(sr[1], qf, kb[2], kb[3]);
    }
    // scale and mask: a key counts iff its row was looked up live (every
    // query row of the slot shares its position)
    float mx0 = ATTN_NEG_INF, mx1 = ATTN_NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kw + 8 * j + 2 * c4 + (e & 1);
        sc[j][e] = s_row[col] >= 0 ? (sc[j][e] + sr[j][e]) * scale
                                   : ATTN_NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, sc[j][e]);
        else mx1 = fmaxf(mx1, sc[j][e]);
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    if (c4 == 0) {
      s_red[0][warp][g] = mx0;
      s_red[0][warp][g + 8] = mx1;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < MMA_NT / 32; ++w) {
      mx0 = fmaxf(mx0, s_red[0][w][g]);
      mx1 = fmaxf(mx1, s_red[0][w][g + 8]);
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        p[e] = sc[j][e] <= ATTN_NEG_INF / 2 ? 0.f : expf(sc[j][e] - mn);
      }
      sum0 += p[0] + p[1];
      sum1 += p[2] + p[3];
      const int col = kw + 8 * j + 2 * c4;
      *reinterpret_cast<unsigned*>(Ps + g * PS + col) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<unsigned*>(Ps + (g + 8) * PS + col) =
          pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    if (c4 == 0) {
      s_red[1][warp][g] = sum0;
      s_red[1][warp][g + 8] = sum1;
    }
    __syncthreads();                    // P and the warps' sums are written
    sum0 = sum1 = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_NT / 32; ++w) {
      sum0 += s_red[1][w][g];
      sum1 += s_red[1][w][g + 8];
    }
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[i][0] *= corr0;
      acc[i][1] *= corr0;
      acc[i][2] *= corr1;
      acc[i][3] *= corr1;
    }

    // O += P C[:, warp's 128 columns of c_kv]
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      unsigned pf[4];
      ldsm_x4(pf, Ps + (lane & 15) * PS + kk * 16 + (lane >> 4) * 8);
      const bf16* Cv = Cs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                CS + warp * OW + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        unsigned vb[4];
        ldsm_x4_t(vb, Cv + 16 * p);
        mma_bf16(acc[2 * p], pf, vb[0], vb[1]);
        mma_bf16(acc[2 * p + 1], pf, vb[2], vb[3]);
      }
    }
  }
  cp_async_commit();                    // Q's copies when no tile was live
  cp_async_wait<0>();

  // the partials of this lane's valid rows: m and l from warp 0 (every
  // warp holds the same), acc as float2 pairs straight from the registers
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int Rr = row0 + g + 8 * half;
    if (Rr >= rows) continue;
    const size_t os = ((size_t)b * rows + Rr) * n_splits + split;
    if (warp == 0 && c4 == 0) {
      m_out[os] = half ? m1 : m0;
      l_out[os] = half ? l1 : l0;
    }
    float* dst = acc_out + os * R + warp * OW + 2 * c4;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(acc[i][2 * half], acc[i][2 * half + 1]);
  }
}

template <int BITS, int R, int DR>
int launch_mma(const void* pool, const float* scales, const void* q_c,
               const void* q_rope, const int* tbl, const int* pos, float* m,
               float* l, float* acc, int B, int Sq, int H, int ps, int P,
               int pps, int n_splits, float scale, cudaStream_t stream) {
  // 16-byte rows: a latent row (1152 bytes bf16, 576 int8, 288 int4) and
  // a query row (R * 2, DR * 2 bytes) start on a 16-byte boundary when
  // the bases do; acc is stored as float2
  if (!aligned16(pool) || !aligned16(q_c) || !aligned16(q_rope) ||
      !aligned16(acc))
    return (int)cudaErrorInvalidValue;
  using S = stored_t<bf16, BITS>;
  static bool smem_ok = false;
  const size_t smem = MlaMmaTile<BITS, R, DR>::BYTES;
  cudaError_t e = allow_smem(mla_partials_mma<BITS, R, DR>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq * H + MMA_BQ - 1) / MMA_BQ, n_splits, B);
  mla_partials_mma<BITS, R, DR><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const S*>(pool), scales, static_cast<const bf16*>(q_c),
      static_cast<const bf16*>(q_rope), tbl, pos, m, l, acc, Sq, H, ps, P,
      pps, n_splits, scale);
  return (int)cudaGetLastError();
}

// The route, by dtype, before launch: float32 on the FMA kernel, bf16 on
// the tensor cores, on any pool (fp, int8 or int4).
template <int BITS>
int dispatch_dtype(int dtype, const void* pool, const float* scales,
                   const void* q_c, const void* q_rope, const void* tbl,
                   const void* pos, void* m, void* l, void* acc, int B,
                   int Sq, int H, int ps, int P, int pps, float scale,
                   cudaStream_t s) {
  const int ns = (P + pps - 1) / pps;
  const int* t = static_cast<const int*>(tbl);
  const int* pb = static_cast<const int*>(pos);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  if (dtype == 0)
    return launch_fma<float, BITS, 512, 64>(pool, scales, q_c, q_rope, t, pb,
                                            mf, lf, af, B, Sq, H, ps, P, pps,
                                            ns, scale, s);
  if (dtype == 1)
    return launch_mma<BITS, 512, 64>(pool, scales, q_c, q_rope, t, pb, mf, lf,
                                     af, B, Sq, H, ps, P, pps, ns, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (r, dr) = (512, 64), deepseek-v2's
// latent widths; ps a multiple of 16; pool 16-byte aligned; all tensors
// contiguous on the device; n_splits = ceil(P / pages_per_split).
extern "C" int mla_paged_decode_partials(
    const void* pool, const void* q_c, const void* q_rope, const void* tbl,
    const void* pos, void* m, void* l, void* acc, int B, int Sq, int H, int r,
    int dr, int ps, int P, int pages_per_split, float scale, int dtype,
    void* stream) {
  if (B == 0 || Sq == 0 || H == 0 || P == 0) return 0;
  if (ps % BK != 0 || pages_per_split < 1 || r != 512 || dr != 64)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtype<0>(dtype, pool, nullptr, q_c, q_rope, tbl, pos, m, l,
                           acc, B, Sq, H, ps, P, pages_per_split, scale,
                           static_cast<cudaStream_t>(stream));
}

// The quantized latent pool: int8 rows of (r + dr) * bits / 8 bytes,
// scale_pool (N, ps) float32, bits 8 or 4; dtype (0 = float32, 1 =
// bfloat16) is the queries' and the dequantized rows' type.  Otherwise as
// above.
extern "C" int mla_paged_decode_partials_quant(
    const void* pool, const void* scale_pool, const void* q_c,
    const void* q_rope, const void* tbl, const void* pos, void* m, void* l,
    void* acc, int B, int Sq, int H, int r, int dr, int ps, int P,
    int pages_per_split, float scale, int bits, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0 || P == 0) return 0;
  if (ps % BK != 0 || pages_per_split < 1 || r != 512 || dr != 64)
    return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale_pool);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return dispatch_dtype<8>(dtype, pool, sp, q_c, q_rope, tbl, pos, m, l,
                             acc, B, Sq, H, ps, P, pages_per_split, scale, s);
  if (bits == 4)
    return dispatch_dtype<4>(dtype, pool, sp, q_c, q_rope, tbl, pos, m, l,
                             acc, B, Sq, H, ps, P, pages_per_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
