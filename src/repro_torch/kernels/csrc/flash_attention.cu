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
// dot, and the weights p to v's type before the PV product, as the
// reference rounds them; the running max, the denominator (a sum of the
// unrounded p) and the output sums are float32.  dk = dv everywhere
// except MLA's naive form of a fresh chunk (dk = nope + rope = 192, dv =
// 128), where the scale is still dk^-0.5, as the reference's `sdpa`
// takes it from q.  The ragged last query tile is masked (the Pallas
// version needs Sq % bq == 0), so any chunk length and any kv_valid are
// accepted.
//
// What bounds it on an H100: the causal products are ~B * H * (dk + dv) *
// Sq^2 operations over B * (Sq * H * dk + Skv * KV * (dk + dv)) input
// elements, far above the ~295 bf16 operations per byte where the tensor
// cores take over from memory; the byte bound is still the larger of the
// two at a 256-row chunk, because a chunk is short.  Either way the
// kernel must feed the tensor cores and keep scores out of device memory.
//
// Two routes, chosen by dtype before launch (not a fallback):
//
// * bf16, `flash_fwd_mma` (the serving path).  FA2's design on
//   `mma.sync` m16n8k16 (bf16 in, float32 sums), which needs no
//   warpgroup-wide tile and so fits both head pairs and short chunks:
//   one block of four warps per (64-row query tile, head, batch); each
//   warp owns 16 query rows.  K and V come in 64-row tiles through a
//   two-slot ring filled by 16-byte `cp.async`; Q is staged once, in the
//   second K slot, and its fragments (scaled and rounded) move to
//   registers for the whole key loop before that slot is first refilled.
//   Tiles stay bf16 in shared memory, rows padded by 16 bytes so every
//   `ldmatrix` is free of bank conflicts (70 KB at dk 128: three blocks
//   an SM; 86 KB at dk 192: two).  S = Q K^T and O += P V run on the tensor cores;
//   scores, the running max and sum and O stay in registers, reduced
//   across the four lanes of a row with __shfl_xor_sync; P becomes the
//   A fragments of the PV product in registers (rounded to bf16 there)
//   and never touches shared memory.  The output goes through the
//   warp's own rows of the second K slot and leaves in 16-byte stores.
//   The key loop stops at the causal diagonal and at kv_valid, and the
//   masks run only on tiles that cross either.  Query tiles launch
//   heaviest first (the tile index is the slowest grid axis, reversed),
//   so the last wave is made of short tiles.  One block serves one head:
//   a group's K/V (2 MB at qwen2.5-3b's chunk) stays in the 50 MB L2, so
//   serving several heads a block would save L2 reads, not device
//   bytes, and would cut the grid below two waves.
// * float32, `flash_fwd_fma` (the 2-layer f32 checks).  On tensor cores
//   float32 would mean TF32, another function, so this route keeps the
//   FMA design of `flash_tile.cuh`: four threads a query row, 32-key
//   tiles widened to float in shared memory (99 KB at dk 192).
#include "flash_tile.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 route: CUDA-core FMA (flash_tile.cuh).
// ---------------------------------------------------------------------------
constexpr int FMA_BQ = 64;
constexpr int FMA_BK = 32;

template <int DK, int DV>
__global__ void __launch_bounds__(4 * FMA_BQ)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Skv, int H, int KV, int kv_valid, float scale) {
  constexpr int BQ = FMA_BQ, BK = FMA_BK;
  using Tile = FlashTile<float, DK, DV, BQ, BK>;
  extern __shared__ float smem[];
  Tile tile;
  tile.init(smem);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;

  for (int idx = tid; idx < BQ * DK; idx += Tile::NT) {
    const int rr = idx / DK, d = idx % DK, qi = q0 + rr;
    const float* src =
        qi < Sq ? q + (((size_t)b * Sq + qi) * H + h) * DK + d : nullptr;
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
    float* dst = o + (((size_t)b * Sq + qi) * H + h) * DV + tile.qq;
#pragma unroll
    for (int i = 0; i < Tile::ND; ++i) dst[4 * i] = tile.acc[i] * inv;
  }
}

template <int DK, int DV>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, int kv_valid,
               cudaStream_t stream) {
  using Tile = FlashTile<float, DK, DV, FMA_BQ, FMA_BK>;
  static bool smem_ok = false;
  const size_t smem = Tile::smem_bytes();
  cudaError_t e = allow_smem(flash_fwd_fma<DK, DV>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + FMA_BQ - 1) / FMA_BQ, H, B);
  flash_fwd_fma<DK, DV><<<grid, Tile::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      kv_valid, 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync m16n8k16 with a cp.async K/V ring.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int MMA_BQ = 64;              // query rows a block (16 a warp)
constexpr int MMA_BK = 64;              // key rows a tile
constexpr int MMA_NT = 128;             // four warps

// Shared memory: two K slots and two V slots.  Q (BQ = BK rows of the
// same width as K) is staged in the second K slot, read into registers
// before that slot is first refilled, and the output leaves through it.
template <int DK, int DV>
struct MmaTile {
  static_assert(MMA_BQ == MMA_BK, "Q borrows a K slot");
  static constexpr int KS = DK + 8;     // padded row strides (bf16)
  static constexpr int VS = DV + 8;
  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * 2 * MMA_BK * (KS + VS);
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(MMA_NT)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
              int Skv, int H, int KV, int kv_valid, float scale) {
  constexpr int BQ = MMA_BQ, BK = MMA_BK;
  constexpr int KS = MmaTile<DK, DV>::KS, VS = MmaTile<DK, DV>::VS;
  constexpr int KD = DK / 16;           // k-steps of S = Q K^T
  constexpr int NS = BK / 8;            // score tiles of 8 keys
  constexpr int NO = DV / 8;            // output tiles of 8 dims
  constexpr int DKC = DK / 8, DVC = DV / 8;   // 16-byte chunks a row
  static_assert(DK % 16 == 0 && DV % 16 == 0, "head widths");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // two slots
  bf16* Vs = Ks + 2 * BK * KS;                       // two slots
  bf16* Qs = Ks + BK * KS;                           // = K slot 1

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lim = min(kv_valid, Skv);
  // keys past the block's last query row or past kv_valid are masked for
  // every row of the block: the loop stops there (the causal skip).
  const int hi = min(q0 + BQ, lim);
  const int nt = hi > 0 ? (hi + BK - 1) / BK : 0;

  for (int c = tid; c < BQ * DKC; c += MMA_NT) {
    const int r = c / DKC, d = (c % DKC) * 8, qi = q0 + r;
    const bf16* src =
        q + (((size_t)b * Sq + min(qi, Sq - 1)) * H + h) * DK + d;
    cp_async16(Qs + r * KS + d, src, qi < Sq);
  }
  // rows at or past kv_valid are zero-filled: masked keys never meet a
  // stale value
  auto load_kv = [&](int t) {
    const int k0 = t * BK, st = t & 1;
    for (int c = tid; c < BK * DKC; c += MMA_NT) {
      const int r = c / DKC, d = (c % DKC) * 8, kr = k0 + r;
      const bf16* src =
          k + (((size_t)b * Skv + min(kr, lim - 1)) * KV + kvh) * DK + d;
      cp_async16(Ks + (st * BK + r) * KS + d, src, kr < lim);
    }
    for (int c = tid; c < BK * DVC; c += MMA_NT) {
      const int r = c / DVC, d = (c % DVC) * 8, kr = k0 + r;
      const bf16* src =
          v + (((size_t)b * Skv + min(kr, lim - 1)) * KV + kvh) * DV + d;
      cp_async16(Vs + (st * BK + r) * VS + d, src, kr < lim);
    }
  };
  if (nt > 0) load_kv(0);
  cp_async_commit();                    // Q and key tile 0

  const int g = lane >> 2, c4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's query rows: row0,
  const int row1 = row0 + 8;            // row0 + 8
  unsigned qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = ATTN_NEG_INF, m1 = ATTN_NEG_INF, l0 = 0.f, l1 = 0.f;

  cp_async_wait<0>();
  __syncthreads();
  // Q fragments: (q * scale) rounded to bf16, as the reference's
  // `(q * scale).astype(q.dtype)`
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * KS + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(qf[kk][e]);
      qf[kk][e] = pack_bf16(f.x * scale, f.y * scale);
    }
  }
  __syncthreads();                      // K slot 1 is free of Q

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) load_kv(t + 1);
    cp_async_commit();
    if (t > 0) {
      cp_async_wait<1>();               // tile t landed
      __syncthreads();
    }
    const bf16* Kt = Ks + (t & 1) * BK * KS;
    const bf16* Vt = Vs + (t & 1) * BK * VS;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        unsigned kb[4];
        ldsm_x4(kb, Kt + (16 * p + (lane & 7) + (lane >> 4) * 8) * KS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qf[kk], kb[2], kb[3]);
      }
    }
    const int k0 = t * BK;
    if (k0 + BK - 1 > q0 + warp * 16 || k0 + BK > lim) {
      // a key counts for a row iff kpos < kv_valid and kpos <= qpos
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * c4 + (e & 1);
          const int qpos = e < 2 ? row0 : row1;
          if (!(kpos < lim && kpos <= qpos)) s[j][e] = ATTN_NEG_INF;
        }
    }
    float mx0 = ATTN_NEG_INF, mx1 = ATTN_NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
    unsigned pf[BK / 16][4];            // P as A fragments of P V
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        p[e] = s[j][e] <= ATTN_NEG_INF / 2 ? 0.f : expf(s[j][e] - mn);
      }
      sum0 += p[0] + p[1];
      sum1 += p[2] + p[3];
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
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
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        unsigned vb[4];
        ldsm_x4_t(vb, Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               VS + 16 * p + (lane >> 4) * 8);
        mma_bf16(acc[2 * p], pf[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * p + 1], pf[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();                    // stage t & 1 may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();                      // K slot 1 is free for the output

  // the warp writes its 16 rows into its own rows of K slot 1, then
  // stores them
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* Os = Qs + warp * 16 * KS;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int col = 8 * i + 2 * c4;
    *reinterpret_cast<unsigned*>(Os + g * KS + col) =
        pack_bf16(acc[i][0] * inv0, acc[i][1] * inv0);
    *reinterpret_cast<unsigned*>(Os + (g + 8) * KS + col) =
        pack_bf16(acc[i][2] * inv1, acc[i][3] * inv1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * DVC; c += 32) {
    const int r = c / DVC, d = (c % DVC) * 8, qi = q0 + warp * 16 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(o + (((size_t)b * Sq + qi) * H + h) * DV +
                                d) =
          *reinterpret_cast<const uint4*>(Os + r * KS + d);
  }
}

template <int DK, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, int kv_valid,
               cudaStream_t stream) {
  // 16-byte rows: every head's row starts on a 16-byte boundary when the
  // bases do (dk and dv are multiples of 8)
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  static bool smem_ok = false;
  const size_t smem = MmaTile<DK, DV>::smem_bytes();
  cudaError_t e = allow_smem(flash_fwd_mma<DK, DV>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (Sq + MMA_BQ - 1) / MMA_BQ);
  flash_fwd_mma<DK, DV><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, KV,
      kv_valid, 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// (dk, dv) pairs: dk = dv heads, and MLA's naive form (192, 128).
template <bool MMA>
int dispatch_dh(int dk, int dv, const void* q, const void* k, const void* v,
                void* o, int B, int Sq, int Skv, int H, int KV, int kv_valid,
                cudaStream_t s) {
#define FLASH_CASE(DK, DV)                                                  \
  if (dk == DK && dv == DV)                                                 \
    return MMA ? launch_mma<DK, DV>(q, k, v, o, B, Sq, Skv, H, KV,          \
                                    kv_valid, s)                            \
               : launch_fma<DK, DV>(q, k, v, o, B, Sq, Skv, H, KV,          \
                                    kv_valid, s);
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(112, 112)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (FMA route), 1 = bfloat16 (tensor-core route).  All
// tensors contiguous on the device.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H,
                                   int KV, int dk, int dv, int kv_valid,
                                   int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0 || kv_valid < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<false>(dk, dv, q, k, v, o, B, Sq, Skv, H, KV,
                              kv_valid, s);
  if (dtype == 1)
    return dispatch_dh<true>(dk, dv, q, k, v, o, B, Sq, Skv, H, KV, kv_valid,
                             s);
  return (int)cudaErrorInvalidValue;
}
