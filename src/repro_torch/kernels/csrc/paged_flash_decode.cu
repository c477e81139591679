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
// 4x fewer of them than bf16, plus 8 bytes of scales a row) plus the
// float32 partials written.  The engine's decode takes one 64-key tile a
// split (`models/attention.py::page_split`: 4 pages at page 16, 2 at
// page 32, more only where the partials would pass the engine's memory
// budget), not one page: per-page partials of G x dv float32 a KV head
// (8.5 MB a layer at qwen2.5-3b's B 8, P 128) would weigh as much as the
// bf16 pages they come from.  A resumed chunk (Sq = a whole prefill
// chunk, 256 rows) does ~Sq * G times more operations on the same bytes:
// ~17 GFLOP at qwen2.5-3b's serving shape against ~86 MB, of which the
// float32 partials are most.  The byte bound still wins against the
// tensor cores' rate, but on the CUDA cores (67 TFLOP/s in float32) the
// products alone would take ~10x the bound.  The partials grow as Sq * P,
// so the caller raises c there so that S stays small, and each block
// walks its c pages in order.
//
// Every route reads each live page once per (slot, KV head), keeps the
// gathered window out of device memory, and launches one block per (row
// tile of the Sq * G query rows, split, slot, KV head): GQA packs the G
// heads of a KV head and consecutive query positions into one tile
// (row R = query R / G, head R % G), so one K/V read serves all of them.
// Each block reads its own table entries.  The route is chosen before
// launch by (dtype, bits, rows); none falls back on another:
//
// * bf16 with Sq * G <= 16 rows (every GQA decode step on fp, int8 and
//   int4 pools; MHA and MLA's expanded window up to 16 query
//   positions), `paged_decode_mma`: the rows are one m16 tile of
//   `mma.sync` m16n8k16 (bf16 in, float32 sums), the shape of the MLA
//   kernel's bf16 route (`mla_paged_decode.cu`).  One block of four
//   warps per (split, slot, KV head).  A key tile is 64 rows, its K and
//   V slices copied by 16-byte `cp.async` after 64 threads look up each
//   key's pool row (the chunk route's lookup below), so dead rows are
//   zero-filled and never read, and one `__syncthreads_or` skips a tile
//   with no live key.  Q is copied with the first live tile and its
//   fragments ((q * scale) rounded to bf16) stay in registers.  Scores:
//   each warp takes 16 keys over dk (K^T by plain `ldmatrix`); the mask,
//   then the row max and sum exchanged across the warps through shared
//   memory; the weights, rounded to bf16, go to shared memory, and the
//   context reads them as A fragments and V by `ldmatrix.trans`, in
//   16-column blocks dealt out to the warps in runs (dv / 4 columns a
//   warp; dv / 2 at dv 32: two warps; at dv 112, seven blocks: 2, 2, 2
//   and 1, so no column is padded and the fourth warp idles half).  A
//   split longer than one tile keeps the online softmax across tiles.
//   At the engine's split a block is one tile, so the tile is
//   single-buffered and copies overlap products across the blocks an SM
//   holds (41 KB of shared memory at 128 / 128, 57 KB at int8, 49 KB at
//   int4, 51 KB at 192 / 128): B 8 x KV 2 x 32 splits = 512 blocks, one
//   wave.  The G = 8 rows of qwen2.5-3b's decode fill half the m16 tile;
//   decode is memory-bound, so the padding costs products, not bytes.
//   On a quantized pool the raw rows and each key's k and v scales (4-byte
//   `cp.async`, 0 for a dead key) land first and one shared-memory pass
//   widens them into the bf16 tiles, as the chunk route's, so that on
//   the pool dequantized to bf16 the two decode routes give the same
//   bits.
// * bf16 with Sq * G > 16 rows (resumed and MLA chunks on fp pools;
//   fresh and resumed chunks on int8 and int4 pools),
//   `paged_partials_mma`: FA2 on `mma.sync` m16n8k16 (bf16 in, float32
//   sums), as the flash forward's bf16 route.  One block of four warps
//   serves a 64-row tile; each warp owns 16 rows.  K and V come in
//   64-key tiles (four pages at page 16, two at 32) through a two-slot
//   ring filled by 16-byte `cp.async`: a cache row's slice for one KV
//   head is dk * 2 contiguous bytes, rows strided by KV * dk * 2.  Before
//   a tile is copied, 64 threads look up its keys' pool rows in the
//   table (-1: unmapped, at or past the split's end, kv_valid or the
//   tile's largest query position), so dead rows are zero-filled and
//   never read, and one `__syncthreads_and` tells whether the whole tile
//   is live.  Q is staged once, in the last K slot, and its fragments
//   ((q * scale) rounded to bf16) stay in registers; scores, the running
//   max and sum and the unnormalised acc stay in registers, and P becomes
//   the PV product's A fragments, rounded to bf16 there.  The key loop
//   stops at the tile's largest query position and at kv_valid; the
//   masks (dead key, kpos > qpos) run only on tiles that are not whole or
//   cross a row's position.  A row that sees no key keeps m = -1e30, its
//   weights are 0 by the guard on masked scores, and it writes exactly
//   (-1e30, 0, 0).  Shared memory: two slots of 64 K and V rows in bf16,
//   padded by 16 bytes a row, 68 KB at 128 / 128 (three blocks an SM),
//   84 KB at 192 / 128 (a slot of 43 KB; two blocks an SM).
//   On a quantized pool (one template on BITS, so the score, softmax,
//   mask and store code is the fp route's) a `cp.async` cannot
//   dequantize: the ring holds the raw rows instead (128 bytes a head
//   slice at int8, 64 at int4, 16-byte aligned when the pool is) and,
//   copied by the same 64 threads that look up the rows, each key's k
//   and v scale (0 for a dead key, whose zero-filled bytes then widen
//   to exact zeros: no stale scale reaches V).  Once a tile has landed,
//   one shared-memory pass widens it into a single bf16 K and V slot,
//   element for element as the reference dequantizes (page_rows.cuh), so
//   on the same pool dequantized to bf16 the two routes give the same
//   bits.  Shared memory 67 KB at int8 (34 KB of bf16 slots, 33 KB of
//   ring), 51 KB at int4.
// * float32, `paged_partials_kernel`: the CUDA-core FMA tile of
//   `flash_tile.cuh`, 16-row blocks for decode rows and 64-row blocks
//   for chunks.  Each page is staged in shared memory as float32
//   (dequantized first from a quantized pool), 16 rows at a time.
//   Float32 on tensor cores would be TF32, another function.  Float32
//   decode is no serving path on the card; it runs at the engine's
//   one-tile split too, where its blocks walk four pages each.  A decode
//   block computes each page's partials from the identities, as the
//   reference's per-page bodies do, and merges them in page order with
//   the combine's arithmetic: at one page a split its results are the
//   per-page ones bit for bit, and at more they track them.  A chunk
//   block walks its split's pages with one online softmax.
#include "mma.cuh"
#include "page_rows.cuh"

#include <climits>
#include <type_traits>

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

  // A chunk block (64 rows) walks the split's pages with one online
  // softmax.  A decode block (16 rows) computes each page's (m, l, acc)
  // from the identities and merges them in page order as the caller's
  // combine merges splits.
  constexpr bool PER_PAGE = BQ == 16;
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, P);
  float ms = ATTN_NEG_INF, ls = 0.f, accs[Tile::ND];
#pragma unroll
  for (int i = 0; i < Tile::ND; ++i) accs[i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const int page = tbl[b * P + j];
    if constexpr (PER_PAGE) {
      tile.m = ATTN_NEG_INF;
      tile.l = 0.f;
#pragma unroll
      for (int i = 0; i < Tile::ND; ++i) tile.acc[i] = 0.f;
    }
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
    if constexpr (PER_PAGE) {
      // a page that saw nothing (m = -1e30) adds exact zeros; merged into
      // the identities, a page's partials come out unchanged
      const float mn = fmaxf(ms, tile.m);
      const float cs = expf(ms - mn), cp = expf(tile.m - mn);
      ls = ls * cs + tile.l * cp;
#pragma unroll
      for (int i = 0; i < Tile::ND; ++i)
        accs[i] = accs[i] * cs + tile.acc[i] * cp;
      ms = mn;
    }
  }
  if constexpr (!PER_PAGE) {
    ms = tile.m;
    ls = tile.l;
#pragma unroll
    for (int i = 0; i < Tile::ND; ++i) accs[i] = tile.acc[i];
  }
  if (row_valid) {
    const size_t o = (((size_t)b * Sq + qi) * KV + kvh) * G + R % G;
    const size_t os = o * n_splits + split;
    if (tile.qq == 0) {
      m_out[os] = ms;
      l_out[os] = ls;
    }
    float* dst = acc_out + os * DV + tile.qq;
#pragma unroll
    for (int i = 0; i < Tile::ND; ++i) dst[4 * i] = accs[i];
  }
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

template <typename T, int BITS, int DK, int DV, int BQ>
int launch_fma(const Args& a) {
  using Tile = FlashTile<T, DK, DV, BQ, BK>;
  using S = stored_t<T, BITS>;
  static bool smem_ok = false;
  const size_t smem = Tile::smem_bytes();
  cudaError_t e =
      allow_smem(paged_partials_kernel<T, BITS, DK, DV, BQ>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const int rows = a.Sq * (a.H / a.KV);
  dim3 grid((rows + BQ - 1) / BQ, a.ns, a.B * a.KV);
  paged_partials_kernel<T, BITS, DK, DV, BQ><<<grid, Tile::NT, smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.kp),
      static_cast<const S*>(a.vp), a.ks, a.vs, a.tbl, a.qpos, a.kvv, a.m, a.l,
      a.acc, a.Sq, a.H, a.KV, a.ps, a.P, a.pps, a.ns, 1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 chunk route: mma.sync m16n8k16 with a cp.async K/V ring read
// through the page table; on a quantized pool the ring holds the raw
// rows, widened to bf16 in shared memory.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int MMA_BQ = 64;              // query rows a block (16 a warp)
constexpr int MMA_BK = 64;              // keys a tile
constexpr int MMA_NT = 128;             // four warps
constexpr int MMA_MIN_ROWS = 17;        // Sq * G from which a chunk takes it

// Shared memory.  An fp pool (BITS 0): two bf16 K slots and two V slots,
// which the copies fill.  A quantized pool: one bf16 K slot and one V
// slot, widened from a two-slot ring of the raw rows (DK * BITS / 8 and
// DV * BITS / 8 bytes a row) and their scales, which the copies fill.
// Q (BQ = BK rows of the same width as K) is staged in the last K slot
// and read into registers before that slot is first refilled.
template <int BITS, int DK, int DV>
struct MmaTile {
  static_assert(MMA_BQ == MMA_BK, "Q borrows a K slot");
  static constexpr int KS = DK + 8;     // padded row strides (bf16)
  static constexpr int VS = DV + 8;
  static constexpr int SLOTS = BITS ? 1 : 2;   // bf16 K (and V) slots
  static constexpr int RK = DK * BITS / 8;     // raw bytes a row
  static constexpr int RV = DV * BITS / 8;
  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * SLOTS * MMA_BK * (KS + VS) +
           2 * MMA_BK * (RK + RV + (BITS ? 2 * sizeof(float) : 0));
  }
};

// BITS 0: an fp pool of bf16; 8 / 4: a quantized pool with row scales.
template <int BITS, int DK, int DV>
__global__ void __launch_bounds__(MMA_NT)
paged_partials_mma(const bf16* __restrict__ q,
                   const stored_t<bf16, BITS>* __restrict__ kpool,
                   const stored_t<bf16, BITS>* __restrict__ vpool,
                   const float* __restrict__ kscale,
                   const float* __restrict__ vscale,
                   const int* __restrict__ tbl,
                   const int* __restrict__ qpos,
                   const int* __restrict__ kv_valid, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out,
                   int Sq, int H, int KV, int ps, int P, int pages_per_split,
                   int n_splits, float scale) {
  using Tile = MmaTile<BITS, DK, DV>;
  constexpr int BQ = MMA_BQ, BK = MMA_BK;
  constexpr int KS = Tile::KS, VS = Tile::VS, NB = Tile::SLOTS;
  constexpr int RK = Tile::RK, RV = Tile::RV;
  constexpr int KD = DK / 16;           // k-steps of S = Q K^T
  constexpr int NS = BK / 8;            // score tiles of 8 keys
  constexpr int NO = DV / 8;            // output tiles of 8 dims
  constexpr int DKC = DK / 8;           // 16-byte chunks a Q row
  static_assert(DK % 16 == 0 && DV % 16 == 0, "head widths");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // NB slots
  bf16* Vs = Ks + NB * BK * KS;                      // NB slots
  bf16* Qs = Ks + (NB - 1) * BK * KS;                // = the last K slot
  // a quantized pool's two-slot ring: raw K rows, raw V rows, then the
  // K and V scales of each key (0 for a dead key)
  unsigned char* Kq = reinterpret_cast<unsigned char*>(Vs + NB * BK * VS);
  unsigned char* Vq = Kq + 2 * BK * RK;
  float* Ksc = reinterpret_cast<float*>(Vq + 2 * BK * RV);
  float* Vsc = Ksc + 2 * BK;
  __shared__ int s_row[2][BK];          // pool row of each key (-1: dead)
  __shared__ int s_maxq[MMA_NT / 32];

  const int b = blockIdx.z / KV, kvh = blockIdx.z % KV;
  const int split = blockIdx.y, row0 = blockIdx.x * BQ;
  const int G = H / KV, rows = Sq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;

  // this lane's query rows r0 and r0 + 8, and their positions (-1 for a
  // padding row: it sees nothing and is never stored)
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const int qp0 = r0 < rows ? qpos[b * Sq + r0 / G] : -1;
  const int qp1 = r1 < rows ? qpos[b * Sq + r1 / G] : -1;
  // the warp's smallest position (a tile past it needs the causal mask)
  // and the block's largest (the key loop stops there)
  int wmin = min(r0 < rows ? qp0 : INT_MAX, r1 < rows ? qp1 : INT_MAX);
  int wmax = max(qp0, qp1);
#pragma unroll
  for (int x = 1; x < 32; x <<= 1) {
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, x));
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, x));
  }
  if (lane == 0) s_maxq[warp] = wmax;
  __syncthreads();
  const int maxq = max(max(s_maxq[0], s_maxq[1]), max(s_maxq[2], s_maxq[3]));

  // keys of this split that any row of the block may see: [ks0, klim)
  const int* tb = tbl + (size_t)b * P;
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, P);
  const int ks0 = j0 * ps;
  const int klim = min(min(j1 * ps, kv_valid[b]), maxq + 1);
  const int nt = klim > ks0 ? (klim - ks0 + BK - 1) / BK : 0;

  // Look up tile t's pool rows (-1: dead, zero-filled and never read) and
  // start its copies (a quantized pool's: raw rows and scales into ring
  // slot t & 1); returns whether every key of the tile is live.  Every
  // thread of the block must call it.
  auto load_kv = [&](int t) -> bool {
    const int k0 = ks0 + t * BK, st = t & 1;
    int live = 1;
    if (tid < BK) {
      const int kpos = k0 + tid;
      int row = -1;
      if (kpos < klim) {
        const int j = kpos / ps, page = tb[j];
        if (page >= 0) row = page * ps + (kpos - j * ps);
      }
      s_row[st][tid] = row;
      live = row >= 0;
      if constexpr (BITS != 0) {
        cp_async4(Ksc + st * BK + tid, row >= 0 ? kscale + row : kscale,
                  row >= 0);
        cp_async4(Vsc + st * BK + tid, row >= 0 ? vscale + row : vscale,
                  row >= 0);
      }
    }
    const bool whole = __syncthreads_and(live);
    const auto* kp = reinterpret_cast<const unsigned char*>(kpool);
    const auto* vp = reinterpret_cast<const unsigned char*>(vpool);
    if constexpr (BITS == 0) {
      copy_rows<DK * 2, KS * 2, BK, MMA_NT>(
          reinterpret_cast<unsigned char*>(Ks + st * BK * KS), kp, s_row[st],
          KV, kvh, tid);
      copy_rows<DV * 2, VS * 2, BK, MMA_NT>(
          reinterpret_cast<unsigned char*>(Vs + st * BK * VS), vp, s_row[st],
          KV, kvh, tid);
    } else {
      copy_rows<RK, RK, BK, MMA_NT>(Kq + st * BK * RK, kp, s_row[st], KV,
                                    kvh, tid);
      copy_rows<RV, RV, BK, MMA_NT>(Vq + st * BK * RV, vp, s_row[st], KV,
                                    kvh, tid);
    }
    return whole;
  };

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = ATTN_NEG_INF, m1 = ATTN_NEG_INF, l0 = 0.f, l1 = 0.f;

  if (nt > 0) {                         // block-uniform
    for (int c = tid; c < BQ * DKC; c += MMA_NT) {
      const int rr = c / DKC, d = (c % DKC) * 8, R = row0 + rr;
      const int Rc = min(R, rows - 1);
      const bf16* src =
          q + (((size_t)b * Sq + Rc / G) * H + kvh * G + Rc % G) * DK + d;
      cp_async16(Qs + rr * KS + d, src, R < rows);
    }
    bool whole = load_kv(0);
    cp_async_commit();                  // Q and key tile 0
    unsigned qf[KD][4];
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
    __syncthreads();                    // the last K slot is free of Q

    for (int t = 0; t < nt; ++t) {
      const bool next = t + 1 < nt ? load_kv(t + 1) : false;
      cp_async_commit();
      if (t > 0) {
        cp_async_wait<1>();             // tile t landed
        __syncthreads();
      }
      const int st = t & 1, k0 = ks0 + t * BK;
      if constexpr (BITS != 0) {        // tile t's raw rows into bf16
        widen_rows<BITS, DK, KS, MMA_NT>(Ks, Kq + st * BK * RK,
                                         Ksc + st * BK, 0, BK, tid);
        widen_rows<BITS, DV, VS, MMA_NT>(Vs, Vq + st * BK * RV,
                                         Vsc + st * BK, 0, BK, tid);
        __syncthreads();
      }
      const bf16* Kt = Ks + (st % NB) * BK * KS;
      const bf16* Vt = Vs + (st % NB) * BK * VS;
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
      if (!whole || k0 + BK - 1 > wmin) {
        // a key counts for a row iff it is live and kpos <= qpos
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * c4 + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            if (!(s_row[st][col] >= 0 && k0 + col <= qp))
              s[j][e] = ATTN_NEG_INF;
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
      unsigned pf[BK / 16][4];          // P as A fragments of P V
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
      whole = next;
      __syncthreads();                  // slot st may be refilled
    }
    cp_async_wait<0>();
  }

  // the partials of this lane's valid rows: m and l from the row's first
  // lane, acc (unnormalised) as float2 pairs straight from the registers
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = half ? r1 : r0;
    if (R >= rows) continue;
    const size_t os =
        ((((size_t)b * Sq + R / G) * KV + kvh) * G + R % G) * n_splits + split;
    if (c4 == 0) {
      m_out[os] = half ? m1 : m0;
      l_out[os] = half ? l1 : l0;
    }
    float* dst = acc_out + os * DV + 2 * c4;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(acc[i][2 * half], acc[i][2 * half + 1]);
  }
}

template <int BITS, int DK, int DV>
int launch_mma(const Args& a) {
  // 16-byte rows: every pool row's slice (DK * 2 bytes in bf16, DK *
  // BITS / 8 quantized: 128 at int8, 64 at int4) starts on a 16-byte
  // boundary when the bases do (dk and dv are multiples of 8)
  if (!aligned16(a.q) || !aligned16(a.kp) || !aligned16(a.vp) ||
      !aligned16(a.acc))
    return (int)cudaErrorInvalidValue;
  using S = stored_t<bf16, BITS>;
  static bool smem_ok = false;
  const size_t smem = MmaTile<BITS, DK, DV>::smem_bytes();
  cudaError_t e =
      allow_smem(paged_partials_mma<BITS, DK, DV>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const int rows = a.Sq * (a.H / a.KV);
  dim3 grid((rows + MMA_BQ - 1) / MMA_BQ, a.ns, a.B * a.KV);
  paged_partials_mma<BITS, DK, DV><<<grid, MMA_NT, smem, a.s>>>(
      static_cast<const bf16*>(a.q), static_cast<const S*>(a.kp),
      static_cast<const S*>(a.vp), a.ks, a.vs, a.tbl, a.qpos, a.kvv, a.m, a.l,
      a.acc, a.Sq, a.H, a.KV, a.ps, a.P, a.pps, a.ns,
      1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 decode route: the <= 16 query rows of a (slot, KV head) as one m16
// tile against one cp.async key tile at a time, read through the page
// table; on a quantized pool the raw rows are widened to bf16 in shared
// memory.
// ---------------------------------------------------------------------------
constexpr int DEC_BQ = MMA_MIN_ROWS - 1;   // query rows a block: one m16 tile

// Shared memory, in bytes from the base: the bf16 K and V tiles (MMA_BK
// rows each, padded by 8 a row), Q (DEC_BQ rows as K's), the weights P
// (DEC_BQ x MMA_BK bf16, padded); a quantized pool's raw K and V rows
// (DK * BITS / 8 and DV * BITS / 8 bytes a row) and the keys' k and v
// scales after them.
template <int BITS, int DK, int DV>
struct DecodeTile {
  static_assert(DEC_BQ == 16, "one m16 tile");
  static constexpr int KS = DK + 8;     // padded row strides (bf16)
  static constexpr int VS = DV + 8;
  static constexpr int PS = MMA_BK + 8;
  static constexpr int RK = DK * BITS / 8;     // raw bytes a row
  static constexpr int RV = DV * BITS / 8;
  // the context product in 16-column blocks (two n8 tiles, one
  // ldmatrix.x4.trans): NB of them over CW warps, each warp owning BW
  // consecutive blocks (fewer for the last where CW does not divide NB:
  // 2, 2, 2, 1 at DV 112); four warps, or DV / 16 at DV 32
  static constexpr int NB = DV / 16;
  static constexpr int CW = NB < 4 ? NB : 4;
  static constexpr int BW = (NB + CW - 1) / CW;
  static constexpr int V = 2 * MMA_BK * KS;
  static constexpr int Q = V + 2 * MMA_BK * VS;
  static constexpr int P = Q + 2 * DEC_BQ * KS;
  static constexpr int RAW = P + 2 * DEC_BQ * PS;
  static constexpr int SC = RAW + MMA_BK * (RK + RV);
  static constexpr int BYTES = SC + (BITS ? 2 * MMA_BK * 4 : 0);
  static_assert(RAW % 16 == 0 && SC % 16 == 0, "16-byte regions");
};

// BITS 0: an fp pool of bf16; 8 / 4: a quantized pool with row scales.
template <int BITS, int DK, int DV>
__global__ void __launch_bounds__(MMA_NT)
paged_decode_mma(const bf16* __restrict__ q,
                 const stored_t<bf16, BITS>* __restrict__ kpool,
                 const stored_t<bf16, BITS>* __restrict__ vpool,
                 const float* __restrict__ kscale,
                 const float* __restrict__ vscale,
                 const int* __restrict__ tbl, const int* __restrict__ qpos,
                 const int* __restrict__ kv_valid, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ acc_out,
                 int Sq, int H, int KV, int ps, int P, int pages_per_split,
                 int n_splits, float scale) {
  using L = DecodeTile<BITS, DK, DV>;
  constexpr int BK = MMA_BK, KS = L::KS, VS = L::VS, PS = L::PS;
  constexpr int RK = L::RK, RV = L::RV, BW = L::BW;
  constexpr int KD = DK / 16;           // k-steps of S = Q K^T
  constexpr int NO = 2 * BW;            // a context warp's n8 tiles
  constexpr int DKC = DK / 8;           // 16-byte chunks a Q row
  static_assert(DK % 16 == 0 && DV % 16 == 0, "head widths");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L::V);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L::Q);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + L::P);
  unsigned char* Kq = smem_raw + L::RAW;
  unsigned char* Vq = Kq + BK * RK;
  float* Ksc = reinterpret_cast<float*>(smem_raw + L::SC);
  float* Vsc = Ksc + BK;
  __shared__ int s_row[BK];             // pool row of each key (-1: dead)
  __shared__ float s_red[2][MMA_NT / 32][DEC_BQ];   // row max, row sum

  const int split = blockIdx.x, b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV, rows = Sq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int kw = warp * 16;             // the warp's keys in S

  // this lane's query rows g and g + 8 and their positions (-1 for a
  // padding row: it sees nothing and is never stored); the slot's
  // largest position, where the key loop stops
  const int qp0 = g < rows ? qpos[b * Sq + g / G] : -1;
  const int qp1 = g + 8 < rows ? qpos[b * Sq + (g + 8) / G] : -1;
  int maxq = -1;
  for (int i = 0; i < Sq; ++i) maxq = max(maxq, qpos[b * Sq + i]);

  // keys of this split that any row may see: [ks0, klim)
  const int* tb = tbl + (size_t)b * P;
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, P);
  const int ks0 = j0 * ps;
  const int klim = min(min(j1 * ps, kv_valid[b]), maxq + 1);
  const int nt = klim > ks0 ? (klim - ks0 + BK - 1) / BK : 0;

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = ATTN_NEG_INF, m1 = ATTN_NEG_INF, l0 = 0.f, l1 = 0.f;
  unsigned qf[KD][4];
  bool q_ready = false;

  if (nt > 0) {                         // Q, committed with the first tile
    for (int c = tid; c < DEC_BQ * DKC; c += MMA_NT) {
      const int rr = c / DKC, d = (c % DKC) * 8, Rc = min(rr, rows - 1);
      const bf16* src =
          q + (((size_t)b * Sq + Rc / G) * H + kvh * G + Rc % G) * DK + d;
      cp_async16(Qs + rr * KS + d, src, rr < rows);
    }
  }
  for (int t = 0; t < nt; ++t) {
    const int k0 = ks0 + t * BK;
    int row = -1;
    if (tid < BK) {
      const int kpos = k0 + tid;
      if (kpos < klim) {
        const int j = kpos / ps, page = tb[j];
        if (page >= 0) row = page * ps + (kpos - j * ps);
      }
      s_row[tid] = row;
    }
    // the previous tile is consumed; a tile with no live key is skipped
    if (!__syncthreads_or(row >= 0)) continue;
    const auto* kp = reinterpret_cast<const unsigned char*>(kpool);
    const auto* vp = reinterpret_cast<const unsigned char*>(vpool);
    if constexpr (BITS == 0) {
      copy_rows<DK * 2, KS * 2, BK, MMA_NT>(
          reinterpret_cast<unsigned char*>(Ks), kp, s_row, KV, kvh, tid);
      copy_rows<DV * 2, VS * 2, BK, MMA_NT>(
          reinterpret_cast<unsigned char*>(Vs), vp, s_row, KV, kvh, tid);
    } else {
      if (tid < BK) {
        cp_async4(Ksc + tid, row >= 0 ? kscale + row : kscale, row >= 0);
        cp_async4(Vsc + tid, row >= 0 ? vscale + row : vscale, row >= 0);
      }
      copy_rows<RK, RK, BK, MMA_NT>(Kq, kp, s_row, KV, kvh, tid);
      copy_rows<RV, RV, BK, MMA_NT>(Vq, vp, s_row, KV, kvh, tid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (BITS != 0) {          // the raw rows into the bf16 tiles
      widen_rows<BITS, DK, KS, MMA_NT>(Ks, Kq, Ksc, 0, BK, tid);
      widen_rows<BITS, DV, VS, MMA_NT>(Vs, Vq, Vsc, 0, BK, tid);
      __syncthreads();
    }
    if (!q_ready) {                     // block-uniform
      // Q fragments: (q * scale) rounded to bf16, as the reference's
      // `(q * scale).astype(q.dtype)`
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldsm_x4(qf[kk], Qs + (lane & 15) * KS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(qf[kk][e]);
          qf[kk][e] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
      q_ready = true;
    }

    // S = Q K^T for the warp's 16 keys
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* Kt = Ks + (kw + (lane & 7) + (lane >> 4) * 8) * KS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned kb[4];
      ldsm_x4(kb, Kt + kk * 16);
      mma_bf16(s[0], qf[kk], kb[0], kb[1]);
      mma_bf16(s[1], qf[kk], kb[2], kb[3]);
    }
    // mask: a key counts for a row iff it is live and kpos <= qpos
    float mx0 = ATTN_NEG_INF, mx1 = ATTN_NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kw + 8 * j + 2 * c4 + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        if (!(s_row[col] >= 0 && k0 + col <= qp)) s[j][e] = ATTN_NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
        else mx1 = fmaxf(mx1, s[j][e]);
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
        p[e] = s[j][e] <= ATTN_NEG_INF / 2 ? 0.f : expf(s[j][e] - mn);
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

    // O += P V[:, the warp's OW columns]
    if (warp < L::CW) {                 // warp-uniform
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[i][0] *= corr0;
        acc[i][1] *= corr0;
        acc[i][2] *= corr1;
        acc[i][3] *= corr1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pf[4];
        ldsm_x4(pf, Ps + (lane & 15) * PS + kk * 16 + (lane >> 4) * 8);
        const bf16* Vt = Vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  VS + warp * BW * 16 + (lane >> 4) * 8;
#pragma unroll
        for (int p = 0; p < BW; ++p) {
          if (warp * BW + p >= L::NB) break;    // warp-uniform
          unsigned vb[4];
          ldsm_x4_t(vb, Vt + 16 * p);
          mma_bf16(acc[2 * p], pf, vb[0], vb[1]);
          mma_bf16(acc[2 * p + 1], pf, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_commit();                    // Q's copies when no tile was live
  cp_async_wait<0>();

  // the partials of this lane's valid rows: m and l from warp 0 (every
  // warp holds the same), acc as float2 pairs straight from the registers
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = g + 8 * half;
    if (R >= rows) continue;
    const size_t os =
        ((((size_t)b * Sq + R / G) * KV + kvh) * G + R % G) * n_splits + split;
    if (warp == 0 && c4 == 0) {
      m_out[os] = half ? m1 : m0;
      l_out[os] = half ? l1 : l0;
    }
    if (warp < L::CW) {
      float* dst = acc_out + os * DV + warp * BW * 16 + 2 * c4;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        if (warp * BW + i / 2 >= L::NB) break;  // warp-uniform
        *reinterpret_cast<float2*>(dst + 8 * i) =
            make_float2(acc[i][2 * half], acc[i][2 * half + 1]);
      }
    }
  }
}

template <int BITS, int DK, int DV>
int launch_decode(const Args& a) {
  // 16-byte rows, as launch_mma's
  if (!aligned16(a.q) || !aligned16(a.kp) || !aligned16(a.vp) ||
      !aligned16(a.acc))
    return (int)cudaErrorInvalidValue;
  using S = stored_t<bf16, BITS>;
  static bool smem_ok = false;
  const size_t smem = DecodeTile<BITS, DK, DV>::BYTES;
  cudaError_t e = allow_smem(paged_decode_mma<BITS, DK, DV>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.ns, a.B * a.KV);
  paged_decode_mma<BITS, DK, DV><<<grid, MMA_NT, smem, a.s>>>(
      static_cast<const bf16*>(a.q), static_cast<const S*>(a.kp),
      static_cast<const S*>(a.vp), a.ks, a.vs, a.tbl, a.qpos, a.kvv, a.m, a.l,
      a.acc, a.Sq, a.H, a.KV, a.ps, a.P, a.pps, a.ns,
      1.f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

// The route, by (dtype, bits, rows), before launch: bf16 on any pool
// (fp, int8 or int4) on the tensor cores, decode rows (Sq * G <= 16) on
// the one-tile route and chunks on the FA2 ring; float32 on FMA blocks of
// 16 rows (decode) or 64 (chunks).
template <typename T, int BITS, int DK, int DV>
int pick_route(const Args& a) {
  const int rows = a.Sq * (a.H / a.KV);
  if constexpr (std::is_same_v<T, bf16>) {
    if (rows < MMA_MIN_ROWS) return launch_decode<BITS, DK, DV>(a);
    return launch_mma<BITS, DK, DV>(a);
  } else {
    if (rows < MMA_MIN_ROWS) return launch_fma<T, BITS, DK, DV, 16>(a);
    return launch_fma<T, BITS, DK, DV, 64>(a);
  }
}

// fp (dk, dv) pairs: dk = dv heads, and MLA's expanded window (192, 128).
template <typename T>
int dispatch_dh(int dk, int dv, const Args& a) {
#define PICK(DK_, DV_) \
  if (dk == DK_ && dv == DV_) return pick_route<T, 0, DK_, DV_>(a);
  PICK(32, 32)
  PICK(64, 64)
  PICK(112, 112)
  PICK(128, 128)
  PICK(192, 128)
#undef PICK
  return (int)cudaErrorInvalidValue;
}

// Quantized pools: qwen2.5-3b's head width, int8 or int4 rows.
template <typename T>
int dispatch_quant(int dh, int bits, const Args& a) {
  if (dh != 128) return (int)cudaErrorInvalidValue;
  if (bits == 8) return pick_route<T, 8, 128, 128>(a);
  if (bits == 4) return pick_route<T, 4, 128, 128>(a);
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
