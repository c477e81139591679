// Paged flash-decode partials, read straight from the KV page pool.
//
// Replaces: the Pallas bodies `_gqa_page_kernel` (fp pools) and
// `_gqa_page_kernel_quant` (int8 / packed int4 pools) behind
// `repro/kernels/paged_flash_decode.py::paged_flash_decode_partials` (TPU).
//
// Inputs: q (B, Sq, H, dk); pools K (N, ps, KV, dk) and V (N, ps, KV, dv);
// tbl (B, P) int32 page table (-1 = unmapped); qpos (B, Sq) int32 query
// positions; kv_valid (B,) int32 filled-row bounds.  The softmax scale is
// dk^-0.5.  dk = dv except for MLA's resumed chunk, whose window is
// expanded to dk = 192, dv = 128 and viewed as a pool by the caller.
// Quantized pools (entry point `paged_flash_decode_partials_quant`) hold
// int8 rows (N, ps, KV, dh) or packed int4 rows (N, ps, KV, dh / 2) with
// (N, ps) float32 row scales k_scale / v_scale, one per cache row across
// its KV heads, read through the same table; each page is dequantized as
// it is staged (page_rows.cuh) and the score and softmax code is the fp
// kernel's.  The softmax scale uses the full dh.
// Output: float32 flash partials m, l (B, Sq, KV, G, S) and acc
// (B, Sq, KV, G, S, dv) over S splits of the
// logical page axis, split s covering pages [s*c, (s+1)*c) with
// c = pages_per_split.  With c = 1 these are exactly the reference's
// per-logical-page partials; the caller combines the S partials with the
// reference's `_combine_page_partials`.
//
// A page is skipped, and the pool never read for it, when its table entry
// is < 0, when it starts past the block's largest query position, or at or
// past kv_valid.  A split whose pages are all skipped writes the exact
// identities m = -1e30, l = 0, acc = 0, as the reference's skipped pages
// do.  Inside a split the pages are walked in order with the online
// softmax, which is the same reduction as the combine.
//
// What bounds it on an H100: decode (Sq = 1) does ~2 * G * (dk + dv)
// operations per cached K/V row of dk + dv elements, far below the card's ~295
// operations per byte, so it is memory-bound: the least time is the
// mapped, live pages' bytes over 3.35 TB/s (a quantized pool moves 2x /
// 4x fewer of them than bf16, plus 8 bytes of scales a row).  The design
// reads each live page once per (slot, KV head) and keeps the gathered
// (and dequantized) window out of device memory: one block per (row tile
// of Sq*G query rows, split, slot, KV head) reads its own table entries
// and stages each page in shared memory as float32, 16 rows at a time.
// For a resumed chunk (Sq = a whole prefill chunk) the partials would
// grow as Sq * P; the caller then raises c so that S stays small, and
// each block walks its c pages in order.
#include "page_rows.cuh"

namespace {

constexpr int BK = 16;                  // pool rows staged per step

// BITS 0: fp pools of T; 8 / 4: quantized pools with row scales.
template <typename T, int BITS, int DK, int DV, int BQ>
__global__ void __launch_bounds__(4 * BQ)
paged_partials_kernel(const T* __restrict__ q,
                      const stored_t<T, BITS>* __restrict__ kpool,
                      const stored_t<T, BITS>* __restrict__ vpool,
                      const float* __restrict__ kscale,
                      const float* __restrict__ vscale,
                      const int* __restrict__ tbl,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kv_valid, float* __restrict__ m_out,
                      float* __restrict__ l_out, float* __restrict__ acc_out,
                      int Sq, int H, int KV, int ps, int P, int pages_per_split,
                      int n_splits, float scale) {
  using Tile = FlashTile<T, DK, DV, BQ, BK>;
  constexpr int SK = stored_width<BITS, DK>(), SV = stored_width<BITS, DV>();
  extern __shared__ float smem[];
  __shared__ int s_maxq;
  Tile tile;
  tile.init(smem);
  const int b = blockIdx.z / KV, kvh = blockIdx.z % KV;
  const int split = blockIdx.y, row0 = blockIdx.x * BQ;
  const int G = H / KV, rows = Sq * G;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < BQ * DK; idx += Tile::NT) {
    const int rr = idx / DK, d = idx % DK, R = row0 + rr;
    const T* src = nullptr;
    if (R < rows) {
      const int qi = R / G, h = kvh * G + R % G;
      src = q + (((size_t)b * Sq + qi) * H + h) * DK + d;
    }
    tile.stage_q_elem(rr, d, src, scale);
  }
  if (tid == 0) {                       // largest query position of the tile
    int mq = -1;
    const int last = min(row0 + BQ, rows) - 1;
    for (int qi = row0 / G; qi <= last / G; ++qi) mq = max(mq, qpos[b * Sq + qi]);
    s_maxq = mq;
  }
  __syncthreads();
  const int maxq = s_maxq;
  const int R = row0 + tile.r;
  const bool row_valid = R < rows;
  const int qi = row_valid ? R / G : 0;
  const int my_qpos = row_valid ? qpos[b * Sq + qi] : -1;
  const int kvs = kv_valid[b];

  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, P);
  for (int j = j0; j < j1; ++j) {
    const int page = tbl[b * P + j];
    for (int sub = 0; sub < ps; sub += BK) {
      const int kbase = j * ps + sub;
      // block-uniform skip: unmapped, causally future or unfilled rows
      if (page < 0 || kbase > maxq || kbase >= kvs) break;
      const size_t srow = (size_t)page * ps + sub;   // cache row of c = 0
      const size_t prow = srow * KV + kvh;              // its pool row
      for (int idx = tid; idx < BK * DK; idx += Tile::NT) {
        const int c = idx / DK, d = idx % DK;
        tile.Ks[c * Tile::KS + d] = page_elem<T, BITS, DK>(
            kpool + (prow + (size_t)c * KV) * SK, BITS ? kscale[srow + c] : 0.f,
            d);
      }
      for (int idx = tid; idx < BK * DV; idx += Tile::NT) {
        const int c = idx / DV, d = idx % DV;
        tile.Vs[c * DV + d] = page_elem<T, BITS, DV>(
            vpool + (prow + (size_t)c * KV) * SV, BITS ? vscale[srow + c] : 0.f,
            d);
      }
      __syncthreads();
      tile.step(kbase, BK, my_qpos, kvs, row_valid);
    }
  }
  if (row_valid) {
    const size_t o = (((size_t)b * Sq + qi) * KV + kvh) * G + R % G;
    const size_t os = o * n_splits + split;
    if (tile.qq == 0) {
      m_out[os] = tile.m;
      l_out[os] = tile.l;
    }
    float* dst = acc_out + os * DV + tile.qq;
#pragma unroll
    for (int i = 0; i < Tile::ND; ++i) dst[4 * i] = tile.acc[i];
  }
}

template <typename T, int BITS, int DK, int DV, int BQ>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* tbl, const int* qpos, const int* kvv,
           float* m, float* l, float* acc, int B, int Sq, int H, int KV,
           int ps, int P, int pps, int n_splits, cudaStream_t stream) {
  using Tile = FlashTile<T, DK, DV, BQ, BK>;
  using S = stored_t<T, BITS>;
  static bool smem_ok = false;
  const size_t smem = Tile::smem_bytes();
  cudaError_t e =
      allow_smem(paged_partials_kernel<T, BITS, DK, DV, BQ>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const int rows = Sq * (H / KV);
  dim3 grid((rows + BQ - 1) / BQ, n_splits, B * KV);
  paged_partials_kernel<T, BITS, DK, DV, BQ><<<grid, Tile::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(kp),
      static_cast<const S*>(vp), ks, vs, tbl, qpos, kvv, m, l, acc, Sq, H, KV,
      ps, P, pps, n_splits, 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// Everything a launch takes besides its compile-time shape.
struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *tbl, *qpos, *kvv;
  float *m, *l, *acc;
  int B, Sq, H, KV, ps, P, pps, ns;
  cudaStream_t s;
};

template <typename T, int BITS, int DK, int DV>
int pick_bq(const Args& a) {
#define LAUNCH(BQ_)                                                          \
  return launch<T, BITS, DK, DV, BQ_>(a.q, a.kp, a.vp, a.ks, a.vs, a.tbl,    \
                                      a.qpos, a.kvv, a.m, a.l, a.acc, a.B,   \
                                      a.Sq, a.H, a.KV, a.ps, a.P, a.pps,     \
                                      a.ns, a.s);
  // decode rows (Sq * G) rarely fill a 64-row tile: use 16-row blocks
  if (a.Sq * (a.H / a.KV) <= 16) LAUNCH(16)
  LAUNCH(64)
#undef LAUNCH
}

// fp (dk, dv) pairs: dk = dv heads, and MLA's expanded window (192, 128).
template <typename T>
int dispatch_dh(int dk, int dv, const Args& a) {
#define PICK(DK_, DV_) \
  if (dk == DK_ && dv == DV_) return pick_bq<T, 0, DK_, DV_>(a);
  PICK(32, 32)
  PICK(64, 64)
  PICK(128, 128)
  PICK(192, 128)
#undef PICK
  return (int)cudaErrorInvalidValue;
}

// Quantized pools: qwen2.5-3b's head width, int8 or int4 rows.
template <typename T>
int dispatch_quant(int dh, int bits, const Args& a) {
  if (dh != 128) return (int)cudaErrorInvalidValue;
  if (bits == 8) return pick_bq<T, 8, 128, 128>(a);
  if (bits == 4) return pick_bq<T, 4, 128, 128>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ps must be a multiple of 16.  All
// tensors contiguous on the device; n_splits = ceil(P / pages_per_split).
extern "C" int paged_flash_decode_partials(
    const void* q, const void* k_pool, const void* v_pool, const void* tbl,
    const void* qpos, const void* kv_valid, void* m, void* l, void* acc, int B,
    int Sq, int H, int KV, int dk, int dv, int ps, int P, int pages_per_split,
    int dtype, void* stream) {
  if (B == 0 || Sq == 0 || P == 0) return 0;
  if (ps % BK != 0 || pages_per_split < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(tbl), static_cast<const int*>(qpos),
               static_cast<const int*>(kv_valid), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(acc), B, Sq, H, KV,
               ps, P, pages_per_split,
               (P + pages_per_split - 1) / pages_per_split,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_dh<float>(dk, dv, a);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(dk, dv, a);
  return (int)cudaErrorInvalidValue;
}

// The quantized pools: k_pool / v_pool int8 rows of dh * bits / 8 bytes a
// (page row, KV head), k_scale / v_scale (N, ps) float32; bits 8 or 4;
// dtype (0 = float32, 1 = bfloat16) is the queries' and the dequantized
// rows' type.  dh must be 128; otherwise as above.
extern "C" int paged_flash_decode_partials_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tbl,
    const void* qpos, const void* kv_valid, void* m, void* l, void* acc, int B,
    int Sq, int H, int KV, int dh, int ps, int P, int pages_per_split,
    int bits, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || P == 0) return 0;
  if (ps % BK != 0 || pages_per_split < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tbl), static_cast<const int*>(qpos),
               static_cast<const int*>(kv_valid), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(acc), B, Sq, H, KV,
               ps, P, pages_per_split,
               (P + pages_per_split - 1) / pages_per_split,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_quant<float>(dh, bits, a);
  if (dtype == 1) return dispatch_quant<__nv_bfloat16>(dh, bits, a);
  return (int)cudaErrorInvalidValue;
}
