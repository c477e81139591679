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
//               int{8,4,2} x int{8,4,2}, exact int32 sum (__dp4a on four
//               k at a time), then two float32 multiplies in that order.
//
// The weight is never written unpacked to device memory: each stage
// stages packed bytes in shared memory as sign-extended lanes, and the
// products run from there.
//
// What bounds them on an H100: at decode (M = 8 rows) a call streams its
// packed weight once and does ~2 * M operations per weight element, far
// below the ~295 operations per byte where compute takes over, so it is
// bound by bytes (K * N * bits / 8).  At a prefill wave (M = 2048) it is
// bound by operations (2 * M * K * N).  This first version computes on
// the CUDA cores (float32 FMA; __dp4a for the integer kernel) with
// 64-column tiles and no tensor cores, so at prefill it sits far above
// the tensor-core bound.  For decode the design keeps the memory side
// busy: with few rows there are few output tiles, so K is split over
// extra blocks (each sums a contiguous range of stages into a float32 /
// int32 partial) until the grid covers the card twice, and a second
// launch adds the partials in split order and applies the epilogue; the
// result does not depend on the launch order.  Tensor cores (int8 and
// bf16 mma / wgmma) and TMA staging come in a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TARGET_BLOCKS = 264;    // two blocks per SM of an H100 (132)
constexpr int MIN_STAGES_PER_SPLIT = 4;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// Four sign-extended lanes of four consecutive positions as one __dp4a word.
template <int BITS>
__device__ __forceinline__ int word_of(const unsigned (&b)[4], int l) {
  return (lane_of<BITS>(b[0], l) & 0xff) | ((lane_of<BITS>(b[1], l) & 0xff) << 8) |
         ((lane_of<BITS>(b[2], l) & 0xff) << 16) |
         static_cast<int>(static_cast<unsigned>(lane_of<BITS>(b[3], l)) << 24);
}

__device__ __forceinline__ unsigned byte_at(const int8_t* p, bool ok) {
  return ok ? static_cast<unsigned>(static_cast<uint8_t>(*p)) : 0u;
}

// ---------------------------------------------------------------------------
// Weight-only kernel.  Block: BM x BN outputs, (BM / TM) x (BN / TN)
// threads, each with a TM x 4 register tile.  Stage: BK = 64 k positions,
// i.e. TT = 64 / fw packed weight rows.  Position p = g * TT + t holds
// k = g * Kp + j0 + t.
// ---------------------------------------------------------------------------
constexpr int WO_BK = 64;

template <typename T, int BITS, int BM, int BN, int TM>
__global__ void __launch_bounds__((BM / TM) * (BN / 4))
wo_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ ws, T* __restrict__ out,
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
        v = to_f(x[(size_t)(m0 + m) * K + (size_t)g * kp + j0 + t]);
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
        out[(size_t)m * N + n] = from_f<T>(__fmul_rn(acc[i][j], ws[n]));
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
// Integer kernel.  Stage: BK = 128 k positions = TT = 128 / F base
// positions; both operands are staged as __dp4a words of four
// consecutive positions (Aw[m][q], Bw[q][n], q = p / 4).
// ---------------------------------------------------------------------------
constexpr int INT_BK = 128;

template <int ABITS, int WBITS, int BM, int BN, int TM>
__global__ void __launch_bounds__((BM / TM) * (BN / 4))
int_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
           const int8_t* __restrict__ w, const float* __restrict__ ws,
           float* __restrict__ out, int* __restrict__ part, int M, int N,
           int K, int per_split) {
  constexpr int FA = 8 / ABITS, FW = 8 / WBITS;
  constexpr int F = FA > FW ? FA : FW;
  constexpr int RA = F / FA, RW = F / FW;
  constexpr int TT = INT_BK / F;       // base positions per stage
  constexpr int QT = TT / 4;           // words per lane group
  constexpr int BQ = INT_BK / 4;       // words per stage
  constexpr int TN = 4;
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ int Aw[BM][BQ + 1];
  __shared__ __align__(16) int Bw[BQ][BN];

  const int kb = K / F;                // base positions
  const int ka = K / FA;               // packed row length of xq
  const int n_stages = (kb + TT - 1) / TT;
  const int s0 = blockIdx.z * per_split;
  const int s1 = min(s0 + per_split, n_stages);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int st = s0; st < s1; ++st) {
    const int j0 = st * TT;
    // x: item (m, rr, u) reads packed positions rr * kb + j0 + 4u + [0, 4)
    for (int idx = tid; idx < BM * RA * QT; idx += NT) {
      const int u = idx % QT, rr = (idx / QT) % RA, m = idx / (QT * RA);
      const bool row = m0 + m < M;
      const int8_t* src = xq + (size_t)(m0 + m) * ka + (size_t)rr * kb + j0 + 4 * u;
      unsigned b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = byte_at(src + i, row && j0 + 4 * u + i < kb);
#pragma unroll
      for (int l = 0; l < FA; ++l) Aw[m][(l * RA + rr) * QT + u] = word_of<ABITS>(b, l);
    }
    // w: item (rr, u, n) reads packed rows rr * kb + j0 + 4u + [0, 4)
    for (int idx = tid; idx < RW * QT * BN; idx += NT) {
      const int n = idx % BN, u = (idx / BN) % QT, rr = idx / (BN * QT);
      const bool col = n0 + n < N;
      const int8_t* src = w + ((size_t)rr * kb + j0 + 4 * u) * N + n0 + n;
      unsigned b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[i] = byte_at(src + (size_t)i * N, col && j0 + 4 * u + i < kb);
#pragma unroll
      for (int l = 0; l < FW; ++l) Bw[(l * RW + rr) * QT + u][n] = word_of<WBITS>(b, l);
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < BQ; ++q) {
      int a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Aw[ty * TM + i][q];
      const int4 bv = *reinterpret_cast<const int4*>(&Bw[q][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = __dp4a(a[i], bv.x, acc[i][0]);
        acc[i][1] = __dp4a(a[i], bv.y, acc[i][1]);
        acc[i][2] = __dp4a(a[i], bv.z, acc[i][2]);
        acc[i][3] = __dp4a(a[i], bv.w, acc[i][3]);
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
        out[(size_t)m * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xs[m]), ws[n]);
    }
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
  out[i] = __fmul_rn(__fmul_rn(__int2float_rn(s), xs[i / N]), ws[i % N]);
}

// ---------------------------------------------------------------------------
// Host side: tiles, splits, dispatch over formats.
// ---------------------------------------------------------------------------
constexpr int BN = 64;

// (BM, TM): 16-row tiles for decode-sized M, 64-row tiles otherwise.
inline bool small_m(int M) { return M <= 16; }

int split_count(int M, int N, int n_stages) {
  const int bm = small_m(M) ? 16 : 64;
  const long grid = (long)((M + bm - 1) / bm) * ((N + BN - 1) / BN);
  if (grid >= TARGET_BLOCKS) return 1;
  int s = (int)((TARGET_BLOCKS + grid - 1) / grid);
  const int cap = n_stages / MIN_STAGES_PER_SPLIT;
  if (s > cap) s = cap;
  return s < 1 ? 1 : s;
}

int per_split(int n_stages, int splits) { return (n_stages + splits - 1) / splits; }

template <typename T, int BITS>
int launch_wo(const void* x, const void* w, const float* ws, void* out,
              float* part, int M, int N, int K, int splits, cudaStream_t s) {
  constexpr int TT = WO_BK / (8 / BITS);
  const int n_stages = (K / (8 / BITS) + TT - 1) / TT;
  const int per = per_split(n_stages, splits);
  float* p = splits > 1 ? part : nullptr;
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  T* o = static_cast<T*>(out);
  if (small_m(M)) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    wo_kernel<T, BITS, 16, BN, 2><<<grid, (16 / 2) * (BN / 4), 0, s>>>(
        xt, wt, ws, o, p, M, N, K, per);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    wo_kernel<T, BITS, 64, BN, 4><<<grid, (64 / 4) * (BN / 4), 0, s>>>(
        xt, wt, ws, o, p, M, N, K, per);
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    wo_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, ws, o, M, N,
                                                               splits);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int wo_bits(int w_bits, const void* x, const void* w, const float* ws, void* out,
            float* part, int M, int N, int K, int splits, cudaStream_t s) {
  switch (w_bits) {
    case 8: return launch_wo<T, 8>(x, w, ws, out, part, M, N, K, splits, s);
    case 4: return launch_wo<T, 4>(x, w, ws, out, part, M, N, K, splits, s);
    case 2: return launch_wo<T, 2>(x, w, ws, out, part, M, N, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int A, int W>
int launch_int(const int8_t* xq, const float* xs, const int8_t* w, const float* ws,
               float* out, int* part, int M, int N, int K, int splits,
               cudaStream_t s) {
  constexpr int F = (8 / A) > (8 / W) ? (8 / A) : (8 / W);
  constexpr int TT = INT_BK / F;
  const int n_stages = (K / F + TT - 1) / TT;
  const int per = per_split(n_stages, splits);
  int* p = splits > 1 ? part : nullptr;
  if (small_m(M)) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    int_kernel<A, W, 16, BN, 2><<<grid, (16 / 2) * (BN / 4), 0, s>>>(
        xq, xs, w, ws, out, p, M, N, K, per);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    int_kernel<A, W, 64, BN, 4><<<grid, (64 / 4) * (BN / 4), 0, s>>>(
        xq, xs, w, ws, out, p, M, N, K, per);
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    int_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, xs, ws, out, M,
                                                            N, splits);
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
extern "C" int wo_matmul_splits(int M, int N, int K, int w_bits) {
  if (!bits_ok(w_bits)) return -1;
  const int tt = WO_BK / (8 / w_bits);
  return split_count(M, N, (K / (8 / w_bits) + tt - 1) / tt);
}

extern "C" int mpq_matmul_splits(int M, int N, int K, int a_bits, int w_bits) {
  if (!bits_ok(a_bits) || !bits_ok(w_bits)) return -1;
  const int f = (8 / a_bits) > (8 / w_bits) ? (8 / a_bits) : (8 / w_bits);
  const int tt = INT_BK / f;
  return split_count(M, N, (K / f + tt - 1) / tt);
}

// x (M, K) contiguous, dtype 0 = float32, 1 = bf16; w (K / (8 / w_bits), N)
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
  if (x_dtype == 0)
    return wo_bits<float>(w_bits, x, w, ws, out, p, M, N, K, splits, s);
  if (x_dtype == 1)
    return wo_bits<__nv_bfloat16>(w_bits, x, w, ws, out, p, M, N, K, splits, s);
  return (int)cudaErrorInvalidValue;
}

// x_q (M, K / (8 / a_bits)) int8 and w (K / (8 / w_bits), N) int8, both in
// the strided layout; x_scale (M,) and w_scale (N,) float32; out (M, N)
// float32; part: (splits, M, N) int32 when splits > 1.
extern "C" int mpq_matmul(const void* x_q, const void* x_scale, const void* w,
                          const void* w_scale, void* out, void* part, int M,
                          int N, int K, int a_bits, int w_bits, int splits,
                          void* stream) {
  if (M == 0 || N == 0) return 0;
  if (!bits_ok(a_bits) || !bits_ok(w_bits) || splits < 1 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int f = (8 / a_bits) > (8 / w_bits) ? (8 / a_bits) : (8 / w_bits);
  if (K % f != 0) return (int)cudaErrorInvalidValue;
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
