// One online-softmax attention tile, shared by the two attention kernels.
//
// A block owns BQ query rows of one (KV head, slot) and walks key/value
// tiles of BK rows that its caller stages in shared memory.  Queries and
// keys are DK wide, values DV wide (MLA's naive form: DK = nope + rope =
// 192, DV = 128; every other attention: DK = DV).  Every score,
// running max, denominator and output sum is float32; inputs are float or
// bf16 and are widened when staged.
//
// Threads: four per query row (NT = 4 * BQ), the four in one warp.
//   * scores: thread (r, qq) computes columns qq, qq+4, ... of row r from
//     the staged Q row and K rows (plain FMA, no tensor cores yet);
//   * row max and row sum reduce over the four with __shfl_xor_sync;
//   * P (rounded to the input type, as the reference casts p before the
//     PV product) goes through shared memory, and thread (r, qq) keeps
//     output dims qq, qq+4, ... of row r in registers.
// Shared strides are padded by one float so that the eight rows and four
// columns a warp touches fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#define ATTN_NEG_INF (-1e30f)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the reference's `.astype(dtype)`.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <typename T, int DK, int DV, int BQ, int BK>
struct FlashTile {
  static constexpr int NT = 4 * BQ;     // threads per block
  static constexpr int QS = DK + 1;     // padded row strides (floats)
  static constexpr int KS = DK + 1;
  static constexpr int PS = BK + 1;
  static constexpr int NC = BK / 4;     // score columns per thread
  static constexpr int ND = DV / 4;     // output dims per thread
  static_assert(BK % 4 == 0 && DK % 4 == 0 && DV % 4 == 0, "tile widths");

  static constexpr size_t smem_bytes() {
    return sizeof(float) * (BQ * QS + BK * KS + BK * DV + BQ * PS);
  }

  float* Qs;
  float* Ks;
  float* Vs;
  float* Ps;
  int r, qq;
  float m, l;
  float acc[ND];

  __device__ void init(float* smem) {
    Qs = smem;
    Ks = Qs + BQ * QS;
    Vs = Ks + BK * KS;
    Ps = Vs + BK * DV;
    r = threadIdx.x >> 2;
    qq = threadIdx.x & 3;
    m = ATTN_NEG_INF;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  }

  // Stage row `rr` of Q: (q * scale) rounded to T, as the reference's
  // `(q * scale).astype(q.dtype)`.  `src` null = padding row (zeros).
  __device__ void stage_q_elem(int rr, int d, const T* src, float scale) {
    Qs[rr * QS + d] = src ? round_to<T>(to_f<T>(*src) * scale) : 0.f;
  }

  // Stage element d of key row c (d < DK) or value row c (d < DV).
  // `src` null = padding row (zeros).
  __device__ void stage_k_elem(int c, int d, const T* src) {
    Ks[c * KS + d] = src ? to_f<T>(*src) : 0.f;
  }
  __device__ void stage_v_elem(int c, int d, const T* src) {
    Vs[c * DV + d] = src ? to_f<T>(*src) : 0.f;
  }

  // One key tile (staged by the caller, followed by __syncthreads): keys
  // at positions kpos0 + c for c < n.  A key counts for this thread's row
  // iff the row is valid, kpos < kv_valid and kpos <= qpos.  Every thread
  // of the block must call this (it synchronises at the end).
  __device__ void step(int kpos0, int n, int qpos, int kv_valid,
                       bool row_valid) {
    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * QS;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] = fmaf(qv, Ks[(qq + 4 * j) * KS + d], s[j]);
    }
    float mx = ATTN_NEG_INF;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = qq + 4 * j;
      const int kpos = kpos0 + c;
      const bool ok = row_valid && c < n && kpos < kv_valid && kpos <= qpos;
      s[j] = ok ? s[j] : ATTN_NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = s[j] <= ATTN_NEG_INF / 2 ? 0.f : expf(s[j] - m_new);
      sum += p;
      Ps[r * PS + qq + 4 * j] = round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();                       // the row's P is written by its warp
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= corr;
    const float* prow = Ps + r * PS;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * DV + qq;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = fmaf(p, vrow[4 * i], acc[i]);
    }
    __syncthreads();                    // K/V/P may be restaged now
  }
};

// Raise a kernel's dynamic shared-memory cap once per instantiation.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}
