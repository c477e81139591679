// MLA compressed-space paged decode partials, read straight from the
// latent page pool.
//
// Replaces: the Pallas body `_mla_page_kernel` behind
// `repro/kernels/paged_flash_decode.py::mla_paged_decode_partials` (TPU).
//
// Inputs: pool (N, ps, R + DR) — one latent row per cached token, the
// normalised c_kv (R wide) followed by the roped k_rope (DR wide); absorbed
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
// is 1152 bytes in bf16, 2304 in float32, and the c/k_rope split at R =
// 512 falls on a 16-byte boundary, so no vector straddles it).  Thread
// (row, key) computes one score; the 16 keys of a row sit in one half
// warp, so the row's max and sum are half-warp shuffles; then thread
// (row, lane) keeps output dims lane, lane + 16, ... of its row in
// registers.  Plain FMA on the CUDA cores; wgmma and TMA come later.
#include "flash_tile.cuh"

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

// 16 bytes of T widened into `dst` (8 bf16 or 4 float values).
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i) dst[i] = to_f<T>(v[i]);
}

template <typename T, int R, int DR>
__global__ void __launch_bounds__(NT)
mla_partials_kernel(const T* __restrict__ pool, const T* __restrict__ q_c,
                    const T* __restrict__ q_rope, const int* __restrict__ tbl,
                    const int* __restrict__ pos, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ acc_out,
                    int Sq, int H, int ps, int P, int pages_per_split,
                    int n_splits, float scale) {
  using S = MlaSmem<R, DR>;
  constexpr int W = S::W, RS = S::RS;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int ND = R / BK;            // output dims per thread
  static_assert(R % BK == 0 && W % VEC == 0 && R % VEC == 0, "widths");
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
      const T* src = pool + ((size_t)page * ps + sub) * W;
      for (int v = tid; v < BK * W / VEC; v += NT) {
        const int c = v / (W / VEC), e = (v % (W / VEC)) * VEC;
        load16<T>(src + (size_t)c * W + e, Ks + c * RS + e);
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

template <typename T, int R, int DR>
int launch(const void* pool, const void* q_c, const void* q_rope,
           const int* tbl, const int* pos, float* m, float* l, float* acc,
           int B, int Sq, int H, int ps, int P, int pps, int n_splits,
           float scale, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t smem = MlaSmem<R, DR>::bytes();
  cudaError_t e = allow_smem(mla_partials_kernel<T, R, DR>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq * H + BQ - 1) / BQ, n_splits, B);
  mla_partials_kernel<T, R, DR><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(pool), static_cast<const T*>(q_c),
      static_cast<const T*>(q_rope), tbl, pos, m, l, acc, Sq, H, ps, P, pps,
      n_splits, scale);
  return (int)cudaGetLastError();
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
  const int ns = (P + pages_per_split - 1) / pages_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tbl);
  const int* pb = static_cast<const int*>(pos);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  if (dtype == 0)
    return launch<float, 512, 64>(pool, q_c, q_rope, t, pb, mf, lf, af, B, Sq,
                                  H, ps, P, pages_per_split, ns, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 512, 64>(pool, q_c, q_rope, t, pb, mf, lf, af,
                                          B, Sq, H, ps, P, pages_per_split, ns,
                                          scale, s);
  return (int)cudaErrorInvalidValue;
}
