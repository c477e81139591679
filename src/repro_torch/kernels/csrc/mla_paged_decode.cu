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
// dequantized whole as it is staged (page_rows.cuh), and only then split
// at R, as the reference's `_mla_page_kernel_quant` does; absorbed
// queries q_c (B, Sq, H, R) and q_rope (B, Sq, H, DR); tbl (B, P) int32
// page table (-1 = unmapped); pos (B,) int32 slot positions (-1 = inactive
// slot).  Output: float32 partials m, l (B, Sq, H, S) and acc
// (B, Sq, H, S, R) over S splits of the logical page axis, split s
// covering pages [s*c, (s+1)*c) with c = pages_per_split.  For each live
// key row k of a page (kpos <= pos[b]):
//   sc = ((q_c . c_k) + (q_rope . kr_k)) * scale      (each dot in float32)
//   m = max sc,  w = exp(sc - m),  l = sum w,  acc = sum round(w) * c_k
// where round() is the input type (the reference casts w before the
// product) and scale = (nope + rope)^-0.5 comes from the caller.  Every
// query row of a slot shares the slot's one position, as in the
// reference.  A page is skipped, and the pool never read for it, when its
// table entry is < 0 or it starts past pos[b] (pos = -1 skips them all);
// a split with nothing live writes the exact identities m = -1e30, l = 0,
// acc = 0.  With c = 1 these are the reference's per-page partials; inside
// a split the pages are walked in order with the online softmax, the same
// reduction as the caller's combine.
//
// What bounds it on an H100: a decode step reads each live latent page
// once, (R + DR) elements a row, and does ~2 * H * (2R + DR) operations a
// row, far below ~295 operations per byte, so it is memory-bound; but the
// float32 partials a page writes (H * R * 4 = 32 KB at H 16, R 512) weigh
// more than the page it reads (16 * 576 * 2 = 18 KB in bf16), so the
// least time counts both.  The design reads each live page once for all H
// heads (the latent row is shared by every head, the point of MLA): one
// block per (16 query rows, split, slot).  The block stages 16 pool rows
// at a time in shared memory as float32 with 16-byte vector loads (a row
// is 1152 bytes in bf16, 2304 in float32, 576 in int8 and 288 in int4,
// all multiples of 16, so every row of a 16-byte-aligned pool starts on a
// 16-byte boundary; an int4 vector of bytes j..j+15 yields elements j..
// j+15 and j+288..j+303).  A quantized page moves 2x (int8) or 4x (int4)
// fewer bytes than bf16, plus 4 bytes of scale a row.  Thread
// (row, key) computes one score; the 16 keys of a row sit in one half
// warp, so the row's max and sum are half-warp shuffles; then thread
// (row, lane) keeps output dims lane, lane + 16, ... of its row in
// registers.  Plain FMA on the CUDA cores; wgmma and TMA come later.
#include "page_rows.cuh"

#include <cstdint>

namespace {

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
int launch(const void* pool, const float* scales, const void* q_c,
           const void* q_rope, const int* tbl, const int* pos, float* m,
           float* l, float* acc, int B, int Sq, int H, int ps, int P, int pps,
           int n_splits, float scale, cudaStream_t stream) {
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
    return launch<float, BITS, 512, 64>(pool, scales, q_c, q_rope, t, pb, mf,
                                        lf, af, B, Sq, H, ps, P, pps, ns,
                                        scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, BITS, 512, 64>(pool, scales, q_c, q_rope, t,
                                                pb, mf, lf, af, B, Sq, H, ps,
                                                P, pps, ns, scale, s);
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
