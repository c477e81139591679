// Causal flash attention forward for one fresh prefill chunk.
//
// Replaces: the Pallas kernel `_flash_kernel` behind
// `repro/kernels/flash_attention.py::flash_attention` (TPU).
//
// Computes, for q (B, Sq, H, dk), k (B, Skv, KV, dk) and v (B, Skv, KV, dv)
// with H % KV == 0,
//   o[b, i, h] = softmax_j(q_i . k_j * dk^-0.5 | j <= i, j < kv_valid) v_j
// with the KV head h / (H / KV), accumulating in float32 and writing q's
// type, o (B, Sq, H, dv).  q * scale is rounded to q's type before the
// dot, as the reference rounds it.  dk = dv everywhere except MLA's naive
// form of a fresh chunk (dk = nope + rope = 192, dv = 128), where the
// scale is still dk^-0.5, as the reference's `sdpa` takes it from q.
//
// What bounds it on an H100: the causal product is ~B * H * (dk + dv) *
// Sq^2 operations over B * (Sq * H * dk + Skv * KV * (dk + dv)) input
// elements, so at serving chunk widths it is operation-bound (far above
// the ~295 bf16 operations per byte where the tensor cores take over from
// memory).  This first version computes the products with plain FMA on
// the CUDA cores, so it runs far below the tensor-core bound; what the
// design does keep is the reference's traffic: one block per (b, h,
// 64-row query tile), K/V tiles of 32 rows staged in shared memory (99 KB
// at dk 192, above the 48 KB default: the launch raises the block's
// dynamic cap first), scores never written to device memory, and the key
// loop stopping at the causal diagonal and at kv_valid.  Unlike the
// Pallas version (Sq % bq == 0) the ragged last query tile is masked, so
// any chunk length is accepted.  Tensor cores (wgmma) and TMA staging
// come in a later change.
#include "flash_tile.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(4 * BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int kv_valid, float scale) {
  using Tile = FlashTile<T, DK, DV, BQ, BK>;
  extern __shared__ float smem[];
  Tile tile;
  tile.init(smem);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;

  for (int idx = tid; idx < BQ * DK; idx += Tile::NT) {
    const int rr = idx / DK, d = idx % DK, qi = q0 + rr;
    const T* src = qi < Sq ? q + (((size_t)b * Sq + qi) * H + h) * DK + d : nullptr;
    tile.stage_q_elem(rr, d, src, scale);
  }
  const int qi = q0 + tile.r;
  const bool row_valid = qi < Sq;
  // keys past the block's last query row or past kv_valid are masked for
  // every row of the block: the loop stops there (the causal skip).
  const int hi = min(min(q0 + BQ, Skv), kv_valid);
  for (int k0 = 0; k0 < hi; k0 += BK) {
    const int n = min(BK, Skv - k0);
    __syncthreads();                    // Q staged / previous tile consumed
    const size_t row0 = (size_t)b * Skv + k0;
    for (int idx = tid; idx < BK * DK; idx += Tile::NT) {
      const int c = idx / DK, d = idx % DK;
      tile.stage_k_elem(c, d, c < n ? k + ((row0 + c) * KV + kvh) * DK + d
                                    : nullptr);
    }
    for (int idx = tid; idx < BK * DV; idx += Tile::NT) {
      const int c = idx / DV, d = idx % DV;
      tile.stage_v_elem(c, d, c < n ? v + ((row0 + c) * KV + kvh) * DV + d
                                    : nullptr);
    }
    __syncthreads();
    tile.step(k0, n, qi, kv_valid, row_valid);
  }
  if (row_valid) {
    const float inv = 1.f / fmaxf(tile.l, 1e-30f);
    T* dst = o + (((size_t)b * Sq + qi) * H + h) * DV + tile.qq;
#pragma unroll
    for (int i = 0; i < Tile::ND; ++i) dst[4 * i] = from_f<T>(tile.acc[i] * inv);
  }
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int kv_valid, cudaStream_t stream) {
  using Tile = FlashTile<T, DK, DV, BQ, BK>;
  static bool smem_ok = false;
  const size_t smem = Tile::smem_bytes();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DK, DV>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DK, DV><<<grid, Tile::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, kv_valid,
      1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// (dk, dv) pairs: dk = dv heads, and MLA's naive form (192, 128).
template <typename T>
int dispatch_dh(int dk, int dv, const void* q, const void* k, const void* v,
                void* o, int B, int Sq, int Skv, int H, int KV, int kv_valid,
                cudaStream_t s) {
  if (dk == 32 && dv == 32)
    return launch<T, 32, 32>(q, k, v, o, B, Sq, Skv, H, KV, kv_valid, s);
  if (dk == 64 && dv == 64)
    return launch<T, 64, 64>(q, k, v, o, B, Sq, Skv, H, KV, kv_valid, s);
  if (dk == 128 && dv == 128)
    return launch<T, 128, 128>(q, k, v, o, B, Sq, Skv, H, KV, kv_valid, s);
  if (dk == 192 && dv == 128)
    return launch<T, 192, 128>(q, k, v, o, B, Sq, Skv, H, KV, kv_valid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous on the device.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H,
                                   int KV, int dk, int dv, int kv_valid,
                                   int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dk, dv, q, k, v, o, B, Sq, Skv, H, KV,
                              kv_valid, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dk, dv, q, k, v, o, B, Sq, Skv, H, KV,
                                      kv_valid, s);
  return (int)cudaErrorInvalidValue;
}
