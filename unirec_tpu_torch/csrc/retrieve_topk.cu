// Full-catalog top-k retrieval for Hopper (sm_90a): K2 over a float32
// catalog and B11 over an int8 catalog, one pass over the catalog a call.
//
// Replaces unirec_tpu/ops/ranking.py:118 _retrieval_kernel (with
// merge_running_topk :92, called at :214) and unirec_tpu/ops/quantization.py:78
// _q_retrieval_kernel (called at :166).  Scores are the cosines of the
// L2-normalised users [B, D] against the catalog [N, D]:
//   K2   (u . c) / max(|u|, 1e-12) / max(|c|, 1e-12)   (normalize = 0: u . c)
//   B11  (u . float(q_n)) / max(|u|, 1e-12) * s_n      (codes q, row scales s)
// and the result is the top k <= 32 per user, scores descending, an equal
// score going to the lower catalog index.  Neither the [B, N] scores nor a
// normalised copy of either operand reaches device memory: each score is the
// raw dot product scaled in the epilogue by the user's and the row's inverse
// norm, both summed from the values the dot products read.
//
// Two launches:
//   1. the share pass: a persistent grid of one CTA per SM.  The catalog is
//      cut into equal contiguous shares of rows (ops/ranking.retrieval_plan)
//      and a share into tiles of whole 32-row slots (152 rows: 96 + 56).  A
//      CTA streams its share as stages (tile, user group, chunk of 512 bytes
//      of a float32 row or 256 int8 codes) through a ring of shared-memory
//      stages: one producer warp fills them, eight consumer warps compute,
//      with a full and an empty mbarrier per stage.  The producer's lane 0
//      loads each stage as 4 KB boxes of 32 rows x 128 bytes by 2-D TMA
//      (tensor maps over the catalog and the users, 128-byte swizzle, zeros
//      past the edges): a handful of requests a stage (a copy per thread
//      or per row segment kept the catalog stream well short of HBM's rate
//      on the card).  Users come in groups of UG (8, 16, 32 or 64) from L2;
//      above 64 users the CTA loops over the groups inside each tile, so a
//      tile's rows cross HBM once and again only from L2.  A consumer thread
//      computes a register tile of up to 4 rows x 8 users in fp32 FMAs (k
//      split over 64 / UG threads, folded by a reduce-scatter butterfly), a
//      tile taking only the row slots it has, and sums the squares of the
//      rows (and users) it reads.  At a tile's end each warp keeps a running
//      top-32 per user (lane j holds entry j, in shared memory between
//      tiles): the tile's scores that beat the k-th entry are sorted by a
//      warp bitonic network, two users and up to four columns of 32 at once,
//      and merged in.  Each CTA writes its top k per user.
//   2. the merge: one CTA per user; each of 16 warps folds every 16th
//      share's list into its own top-32 (skipping a list none of whose
//      entries beats its k-th), then the warps' lists merge pairwise.
// Every score is the same arithmetic whichever share, tile slot or thread
// computes it, and the selection is a top-k under a total order (score, then
// index), so repeats give identical bits and ties go to the lower index
// across share boundaries.
//
// What bounds it on an H100.  At 8 users the catalog read: 82 MB in float32
// at 20,000 x 1,024 (0.0245 ms at 3.35 TB/s), 20.5 MB in int8; the
// arithmetic is 8 FMAs a catalog value, and the ring keeps up to 3 stages
// (200 KB) in flight per SM.  The selection's share of the time is a tile's
// worth at the end of a share, which the stream cannot hide, and the merge
// launch.  At 64 users the fp32 FMAs: 2.62 GFLOP, 0.039 ms at 67 TFLOP/s; a
// tile stays in shared memory while all 64 users pass over it, so the
// catalog still crosses HBM once, and each thread's 4 x 8 tile takes 12
// shared-memory vector loads for 128 FMAs; there the selection of 64 users'
// lists per tile costs about a fifth of the time.  Tensor cores are not
// used: the function is float32 and the scores are held to 1e-5 with id
// swaps only between scores within 1e-6, which TF32 (about three digits)
// cannot meet, and at the serving batch the kernel is bound by bytes, not
// operations.  (int8 codes are exact in bf16, so a three-way bf16 split of
// the users on wgmma could serve B11 at 64 users and more: later work.)
// B11's codes become floats by a byte permute into 0x4B0000xx and one
// subtraction, exact and cheaper than an I2F per code.
//
// Any width D >= 1: the stage layout is the kernel's own, so the consumers
// read it in vectors at every D.  TMA needs 16-byte row strides (D % 4 == 0
// in float32, D % 16 == 0 in int8); at other widths the producer warp fills
// the same layout by 4-byte cp.async (float32, or int8 rows of whole words)
// or plain loads (int8 rows off 4 bytes), zeros past D, and waits for its
// copies before it arrives.  The wrappers pass 16-byte aligned bases.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ptx_helpers.cuh"

namespace {

constexpr int THREADS = 256;  // the consumer warps; one producer warp beside them
constexpr int WARPS = THREADS / 32;
constexpr int CTA_THREADS = THREADS + 32;
constexpr int TR = 128;  // catalog rows a tile: 4 row slots of 32
constexpr int KMAX = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NORM_EPS = 1e-12f;
constexpr int SMEM_MAX = 232448;
constexpr int MERGE_THREADS = 512;  // a user's merge
constexpr int BOX = 4096;  // a catalog box: 32 rows x 128 bytes

enum CopyMode { COPY16 = 0, COPY4 = 1, COPY1 = 2 };

// A stage holds, for a tile's row slots and a chunk of DC columns, the
// catalog as boxes of 32 rows x 128 bytes (box (slot, b) at (slot * CB + b)
// * BOX) and the user group's chunk as boxes of UG rows x 32 floats (box b at
// CAT_BYTES + b * UG * 128); a 128-byte row's 16-byte unit c lies at unit c ^
// (row & 7), the TMA's 128-byte swizzle, so that the consumers' vector loads
// of 4 or 8 rows at one column hit distinct banks.
template <typename T, int UG>
struct Cfg {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int KS = 64 / UG;  // threads that split one tile along k
  static constexpr int UT = UG / 8;   // a thread's users are ut + UT * j
  static constexpr int BC = 128 / ES;  // columns a catalog box
  static constexpr int DC = ES == 4 ? 128 : 256;  // chunk width, elements
  static constexpr int CB = DC / BC, UB = DC / 32;  // catalog and user boxes a row slot
  static constexpr int STEPS = DC / 4 / KS;       // 4-wide steps a chunk
  static constexpr int CAT_BYTES = 4 * CB * BOX;
  static constexpr int STAGE_BYTES = CAT_BYTES + UB * UG * 128;
  static constexpr int SCP = TR + 4;  // pitch of the tile's dot products, floats
  static constexpr int SC_BYTES = UG * SCP * 4;
  // the ring's full and empty barriers, row and user scales, the users' lists
  static constexpr int EXTRA = 16 * 8 + (TR + UG) * 4 + UG * 32 * 8;
  // the dot products have a space of their own where two stages leave room,
  // so that a tile's last stage is released before its selection; else they
  // take the consumed stage's
  static constexpr bool SC_OWN = 1024 + 2 * STAGE_BYTES + EXTRA + SC_BYTES <= SMEM_MAX;
  static constexpr int AVAIL = SMEM_MAX - 1024 - EXTRA - (SC_OWN ? SC_BYTES : 0);
  static constexpr int NS = AVAIL / STAGE_BYTES < 4 ? AVAIL / STAGE_BYTES : 4;  // ring depth
  static constexpr size_t SMEM =
      1024 + (size_t)NS * STAGE_BYTES + EXTRA + (SC_OWN ? SC_BYTES : 0);
  static_assert(NS >= 2, "a ring of two stages at least");
  static_assert(SC_BYTES <= STAGE_BYTES, "the dot products fit a consumed stage");
};

// byte offset of 16-byte unit `unit` (+ `inner` bytes) of a 128-byte row
__device__ __forceinline__ int swz(int row, int unit, int inner) {
  return row * 128 + ((unit ^ (row & 7)) << 4) + inner;
}

// the stage offset of element `col` (of the chunk) of tile row `r`
template <typename T, int UG>
__device__ __forceinline__ int cat_at(int r, int col) {
  using C = Cfg<T, UG>;
  const int byte = (col % C::BC) * C::ES;
  return ((r >> 5) * C::CB + col / C::BC) * BOX + swz(r & 31, byte >> 4, byte & 15);
}

// the stage offset of chunk element `col` of group user `u`
template <typename T, int UG>
__device__ __forceinline__ int user_at(int u, int col) {
  using C = Cfg<T, UG>;
  return C::CAT_BYTES + (col >> 5) * UG * 128 + swz(u, (col & 31) >> 2, (col & 3) * 4);
}

// Total order: higher score first, then the lower catalog index.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// One compare-exchange of a warp bitonic network: the lane that should hold
// the better of the pair (lower lane of a descending block, upper lane of an
// ascending one) takes its partner's entry when that is better.
__device__ __forceinline__ void exchange(float& s, int& i, int lane, int stride, bool desc) {
  const float os = __shfl_xor_sync(FULL, s, stride);
  const int oi = __shfl_xor_sync(FULL, i, stride);
  const bool keep_better = ((lane & stride) == 0) == desc;
  const bool eq = os == s;
  const bool other = (os > s) | (eq & (oi < i)), mine = (s > os) | (eq & (i < oi));
  if (keep_better ? other : mine) {
    s = os;
    i = oi;
  }
}

// (ls, li) := the top 32 of two descending lists: the elementwise better of
// the list and the other reversed is bitonic and holds the top 32; a
// half-cleaner cascade sorts it.
__device__ __forceinline__ void warp_merge(float& ls, int& li, float s, int i, int lane) {
  const float rs = __shfl_sync(FULL, s, 31 - lane);
  const int ri = __shfl_sync(FULL, i, 31 - lane);
  if (better(rs, ri, ls, li)) {
    ls = rs;
    li = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) exchange(ls, li, lane, stride, true);
}

// Four int8 codes to floats: each code + 128 as an unsigned byte under the
// exponent of 2^23, less 2^23 + 128 (exact).
__device__ __forceinline__ float4 codes4(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const float bias = 8388736.f;
  return make_float4(__uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540)) - bias,
                     __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7541)) - bias,
                     __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7542)) - bias,
                     __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7543)) - bias);
}

template <typename T>
__device__ __forceinline__ float4 load4(const unsigned char* p) {
  if constexpr (sizeof(T) == 4)
    return *reinterpret_cast<const float4*>(p);
  else
    return codes4(*reinterpret_cast<const uint32_t*>(p));
}

// The producer warp's fill of one stage: rows [t0, t0 + rows) of the tile
// (rows: its row slots) x columns [c0, c0 + DC), and users [g0, g0 + UG) x
// the same columns.  COPY16: lane 0 loads the boxes by TMA, zeros past the
// catalog's and the users' edges, completing bytes on `full`; rows past r1
// inside the last slot come too, and are never read.  COPY4: 4-byte
// cp.async, COPY1 (int8 rows off 4 bytes): plain loads of rows < r1, zeros
// past D; each lane then waits for its copies and arrives on `full` (32
// arrivals).
template <typename T, int UG>
__device__ __forceinline__ void fill_stage(unsigned char* st, const CUtensorMap* cmap,
                                           const CUtensorMap* umap, const T* catalog,
                                           const float* users, int t0, int rows, int r1, int g0,
                                           int B, int c0, int D, int mode, uint64_t* full,
                                           int lane) {
  using C = Cfg<T, UG>;
  if (mode == COPY16) {
    if (lane == 0) {
      fence_proxy_async();  // earlier generic writes to the stage before the copies
      mbar_arrive_expect(full, (rows / 32) * C::CB * BOX + C::UB * UG * 128);
      for (int slot = 0; slot < rows / 32; ++slot)
        for (int b = 0; b < C::CB; ++b)
          tma_load_2d(st + (slot * C::CB + b) * BOX, cmap, c0 + b * C::BC, t0 + 32 * slot, full);
      for (int b = 0; b < C::UB; ++b)
        tma_load_2d(st + C::CAT_BYTES + b * UG * 128, umap, c0 + 32 * b, g0, full);
    }
    return;
  }
  const unsigned char* src = reinterpret_cast<const unsigned char*>(catalog);
  const int n_rows = min(rows, r1 - t0), n_users = min(UG, B - g0);
  if (mode == COPY4) {
    constexpr int PER = 4 / C::ES;  // elements a 4-byte copy
    for (int e = lane; e < n_rows * (C::DC / PER); e += 32) {
      const int r = e / (C::DC / PER), col = e % (C::DC / PER) * PER;
      const bool ok = c0 + col < D;
      cp_async_4(smem_addr(st + cat_at<T, UG>(r, col)),
                 ok ? src + ((size_t)(t0 + r) * D + c0 + col) * C::ES : src, ok);
    }
  } else {
    for (int e = lane; e < n_rows * C::DC; e += 32) {
      const int r = e / C::DC, col = e % C::DC;
      st[cat_at<T, UG>(r, col)] = c0 + col < D ? src[(size_t)(t0 + r) * D + c0 + col] : 0;
    }
  }
  for (int e = lane; e < n_users * C::DC; e += 32) {
    const int u = e / C::DC, col = e % C::DC;
    const bool ok = c0 + col < D;
    cp_async_4(smem_addr(st + user_at<T, UG>(u, col)),
               ok ? users + (size_t)(g0 + u) * D + c0 + col : users, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();  // the plain stores and the copies, then one release arrival
  mbar_arrive(full);
}

// acc[r * 8 + j] += row slot r (row rt + 32 r) . user ut + UT j over this
// thread's k-steps of the stage's chunk, in a fixed order; with `sq` also
// rss[r] += row slot r's squares over the same steps (where a thread is the
// only one to read its rows' values: one user slot, UT = 1).
template <typename T, int UG, int R>
__device__ __forceinline__ void dots(const unsigned char* st, float (&acc)[32], float (&rss)[4],
                                     bool sq, int ks, int ut, int rt) {
  using C = Cfg<T, UG>;
#pragma unroll 2
  for (int s = 0; s < C::STEPS; ++s) {
    const int kk = 4 * (ks + C::KS * s);
    float4 c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = load4<T>(st + cat_at<T, UG>(rt + 32 * r, kk));
    if (sq)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rss[r] = fmaf(c[r].x, c[r].x, rss[r]);
        rss[r] = fmaf(c[r].y, c[r].y, rss[r]);
        rss[r] = fmaf(c[r].z, c[r].z, rss[r]);
        rss[r] = fmaf(c[r].w, c[r].w, rss[r]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 u = *reinterpret_cast<const float4*>(st + user_at<T, UG>(ut + C::UT * j, kk));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = acc[r * 8 + j];
        a = fmaf(c[r].x, u.x, a);
        a = fmaf(c[r].y, u.y, a);
        a = fmaf(c[r].z, u.z, a);
        a = fmaf(c[r].w, u.w, a);
        acc[r * 8 + j] = a;
      }
    }
  }
}

// One level of the reduce-scatter butterfly over the k-split lanes: the
// lane with bit O clear keeps values [0, HALF), the other [HALF, 2 HALF).
template <int HALF, int O>
__device__ __forceinline__ void fold_level(float (&v)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int x = 0; x < HALF; ++x) {
    const float send = upper ? v[x] : v[x + HALF];
    const float keep = upper ? v[x + HALF] : v[x];
    v[x] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// After it, lane ks holds the full sums of values [ks * 32 / KS, ...) in v[0..32 / KS).
template <int KS>
__device__ __forceinline__ void fold_k(float (&v)[32], int lane) {
  if constexpr (KS >= 8) fold_level<32 * 4 / KS, 4>(v, lane);
  if constexpr (KS >= 4) fold_level<32 * 2 / KS, 2>(v, lane);
  if constexpr (KS >= 2) fold_level<32 / KS, 1>(v, lane);
}

// A tile's candidates for P users at once (independent chains), 4 columns
// of 32 rows each (row lane + 32 col, rows from v on out): the entries that
// beat a user's k-th are sorted, the columns up to the last holding one at
// once, merged into one column and then into the user's running top-32
// (ls, li).
template <int P>
__device__ __forceinline__ void select_tile(float (&ls)[P], int (&li)[P], const float* const (&dots)[P],
                                            const float (&su)[P], const float* rscale, int t0,
                                            int v, int k, int lane) {
  float s[P][4];
  int ix[P][4];
  int ncol = 0;  // the columns up to the last with a candidate, over the P users
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float th = __shfl_sync(FULL, ls[p], k - 1);
    const int thi = __shfl_sync(FULL, li[p], k - 1);
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const int row = lane + 32 * col;
      s[p][col] = -INFINITY;
      ix[p][col] = INT_MAX;
      bool cand = false;
      if (row < v) {
        const float x = (dots[p][row] * su[p]) * rscale[row];
        if (better(x, t0 + row, th, thi)) {
          s[p][col] = x;
          ix[p][col] = t0 + row;
          cand = true;
        }
      }
      if (__ballot_sync(FULL, cand)) ncol = max(ncol, col + 1);
    }
  }
  if (ncol == 0) return;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int col = 0; col < 4; ++col)
        if (col < ncol)
#pragma unroll
          for (int p = 0; p < P; ++p)
            exchange(s[p][col], ix[p][col], lane, stride, (lane & size) == 0);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (ncol > 1) warp_merge(s[p][0], ix[p][0], s[p][1], ix[p][1], lane);
    if (ncol > 3) warp_merge(s[p][2], ix[p][2], s[p][3], ix[p][3], lane);
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (ncol > 2) warp_merge(s[p][0], ix[p][0], s[p][2], ix[p][2], lane);
#pragma unroll
  for (int p = 0; p < P; ++p) warp_merge(ls[p], li[p], s[p][0], ix[p][0], lane);
}

template <typename T, int UG>
__global__ void __launch_bounds__(CTA_THREADS, 1)
topk_share_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap umap,
                  const float* __restrict__ users, const T* __restrict__ catalog,
                  const float* __restrict__ scales, float* __restrict__ part_s,
                  int* __restrict__ part_i, int B, int N, int D, int k, int normalize,
                  int rows_per_share, int tile_rows, int mode) {
  using C = Cfg<T, UG>;
  constexpr int NS = C::NS;
  constexpr int UPW = UG / WARPS;  // users whose list a warp keeps: warp + WARPS m
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // TMA boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)NS * C::STAGE_BYTES);  // [NS]
  uint64_t* empty = full + 8;                                                        // [NS]
  float* rscale = reinterpret_cast<float*>(empty + 8);  // [TR]: 1 / |row|, the int8 scale, or 1
  float* uscale = rscale + TR;                          // [UG]: 1 / |user| or 1
  float* list_s = uscale + UG;                          // [UG][32]: each user's running top-32
  int* list_i = reinterpret_cast<int*>(list_s + UG * 32);
  float* sc_own = reinterpret_cast<float*>(list_i + UG * 32);  // [UG][SCP] when SC_OWN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int share = blockIdx.x, S = gridDim.x;
  const int r0 = share * rows_per_share, r1 = min(N, r0 + rows_per_share);
  const int G = (B + UG - 1) / UG;
  const int chunks = (D + C::DC - 1) / C::DC;
  const int tiles = r1 > r0 ? (r1 - r0 + tile_rows - 1) / tile_rows : 0;
  const int steps = tiles * G * chunks;  // stages: (tile, user group, chunk), chunks inner

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i, mode == COPY16 ? 1 : 32);
      mbar_init(empty + i, WARPS);
    }
    mbar_fence_init();
  }
  for (int e = tid; e < UG * 32; e += CTA_THREADS) {
    list_s[e] = -INFINITY;
    list_i[e] = INT_MAX;
  }
  __syncthreads();

  if (warp >= WARPS) {  // the producers: stage q into slot q % NS once it is free
    for (int q = 0; q < steps; ++q) {
      if (q >= NS) mbar_wait(empty + q % NS, (q / NS - 1) & 1);
      const int c = q % chunks, g = (q / chunks) % G, t0 = r0 + q / (chunks * G) * tile_rows;
      const int rows = (min(tile_rows, r1 - t0) + 31) / 32 * 32;
      fill_stage<T, UG>(smem + (size_t)(q % NS) * C::STAGE_BYTES, &cmap, &umap, catalog, users,
                        t0, rows, r1, g * UG, B, c * C::DC, D, mode, full + q % NS, lane);
    }
    return;
  }

  // the consumers: named barrier 1 is theirs alone
  const int ks = tid % C::KS, ut = (tid / C::KS) % C::UT, rt = tid / 8;
  const bool fold = normalize != 0;
  auto store = [&](int g, int u, float s, int i) {  // user g * UG + u's list, lanes < k
    if (g * UG + u < B && lane < k) {
      const size_t off = ((size_t)(g * UG + u) * S + share) * k + lane;
      part_s[off] = s;
      part_i[off] = i;
    }
  };
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  // a row's sum of squares: in dots where a thread alone reads its rows'
  // values (rsq, per row slot, folded over the k-split lanes), else by the
  // side pass below (rss, row tid / 2)
  constexpr bool SQ_IN_DOTS = C::ES == 4 && C::UT == 1;
  float rsq[4] = {0.f, 0.f, 0.f, 0.f};
  float rss = 0.f, uss = 0.f, row_scale = 0.f;
  int c = 0, g = 0, t = 0;  // stage q's chunk, user group and tile
  for (int q = 0; q < steps; ++q) {
    mbar_wait(full + q % NS, (q / NS) & 1);
    const int t0 = r0 + t * tile_rows, v = min(tile_rows, r1 - t0), R = (v + 31) / 32;
    unsigned char* st = smem + (size_t)(q % NS) * C::STAGE_BYTES;
    if constexpr (C::ES == 1)
      if (g == 0 && c == 0 && tid < TR) row_scale = t0 + tid < r1 ? scales[t0 + tid] : 0.f;
    const bool sq = SQ_IN_DOTS && fold && g == 0;
    switch (R) {
      case 1: dots<T, UG, 1>(st, acc, rsq, sq, ks, ut, rt); break;
      case 2: dots<T, UG, 2>(st, acc, rsq, sq, ks, ut, rt); break;
      case 3: dots<T, UG, 3>(st, acc, rsq, sq, ks, ut, rt); break;
      default: dots<T, UG, 4>(st, acc, rsq, sq, ks, ut, rt); break;
    }
    if (fold) {  // sums of squares from the same values: row tid / 2, user tid / 4
      if constexpr (C::ES == 4 && !SQ_IN_DOTS) {
        if (g == 0 && (tid >> 1) < v) {
#pragma unroll 4
          for (int s = 0; s < C::DC / 8; ++s) {
            const float4 x = *reinterpret_cast<const float4*>(
                st + cat_at<T, UG>(tid >> 1, 4 * ((tid & 1) + 2 * s)));
            rss = fmaf(x.x, x.x, rss);
            rss = fmaf(x.y, x.y, rss);
            rss = fmaf(x.z, x.z, rss);
            rss = fmaf(x.w, x.w, rss);
          }
        }
      }
      if (tid < 4 * UG) {
#pragma unroll 4
        for (int s = 0; s < C::DC / 16; ++s) {
          const float4 x = *reinterpret_cast<const float4*>(
              st + user_at<T, UG>(tid >> 2, 4 * ((tid & 3) + 4 * s)));
          uss = fmaf(x.x, x.x, uss);
          uss = fmaf(x.y, x.y, uss);
          uss = fmaf(x.z, x.z, uss);
          uss = fmaf(x.w, x.w, uss);
        }
      }
    }
    const int tg = g;  // the stage's group and tile, before the counters move on
    const bool last = ++c == chunks;
    if (last) {
      c = 0;
      if (++g == G) {
        g = 0;
        ++t;
      }
    }
    if (!last || C::SC_OWN) {  // done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + q % NS);
    }
    if (!last) continue;

    // the tile's epilogue for user group tg: scales, dot products, selection
    float row_inv = 1.f, user_inv = 1.f, slot_inv[4];
    if constexpr (C::ES == 1) {
      row_inv = row_scale;
    } else if (SQ_IN_DOTS) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // the same sum on every k-split lane
        float x = rsq[r];
#pragma unroll
        for (int o = 1; o < C::KS; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
        slot_inv[r] = 1.f / fmaxf(sqrtf(x), NORM_EPS);
        if (tg == 0) rsq[r] = 0.f;
      }
    } else if (fold) {
      row_inv = 1.f / fmaxf(sqrtf(rss + __shfl_xor_sync(FULL, rss, 1)), NORM_EPS);
      if (tg == 0) rss = 0.f;
    }
    if (fold) {
      float s2 = uss + __shfl_xor_sync(FULL, uss, 1);
      s2 = s2 + __shfl_xor_sync(FULL, s2, 2);
      user_inv = 1.f / fmaxf(sqrtf(s2), NORM_EPS);
      uss = 0.f;
    }
    fold_k<C::KS>(acc, lane);
    // every consumer is done with the stage and with the last selection: the
    // scales and the stage's space (the dot products) may be written
    named_barrier(1, THREADS);
    if (SQ_IN_DOTS && fold) {
      if (tg == 0 && ks == 0)
#pragma unroll
        for (int r = 0; r < 4; ++r) rscale[rt + 32 * r] = slot_inv[r];
    } else {
      const bool row_pairs = C::ES == 4 && fold;  // row tid / 2's sum on lanes 2i, 2i + 1
      if (tg == 0 && (row_pairs ? (tid & 1) == 0 : tid < TR))
        rscale[row_pairs ? tid >> 1 : tid] = row_inv;
    }
    if (fold ? tid < 4 * UG && (tid & 3) == 0 : tid < UG) uscale[fold ? tid >> 2 : tid] = user_inv;
    float* sc = C::SC_OWN ? sc_own : reinterpret_cast<float*>(st);  // [UG][SCP]
    constexpr int PER = 32 / C::KS;
#pragma unroll
    for (int x2 = 0; x2 < PER; ++x2) {
      const int x = ks * PER + x2;
      sc[(ut + C::UT * (x % 8)) * C::SCP + rt + 32 * (x / 8)] = acc[x2];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] = 0.f;
    named_barrier(1, THREADS);

    const int tt = (t0 - r0) / tile_rows;  // the tile's index in the share
    constexpr int P = UPW >= 2 ? 2 : 1;  // users a warp selects for at once
#pragma unroll 1
    for (int m = 0; m < UPW; m += P) {
      float ls[P], su[P];
      int li[P];
      const float* dots_u[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int u = warp + WARPS * (m + p);
        dots_u[p] = sc + u * C::SCP;
        su[p] = uscale[u];
        if (G > 1) {  // the group's lists wait in the share's output between tiles
          const size_t off = ((size_t)(tg * UG + u) * S + share) * k + lane;
          const bool old = tt > 0 && lane < k && tg * UG + u < B;
          ls[p] = old ? part_s[off] : -INFINITY;
          li[p] = old ? part_i[off] : INT_MAX;
        } else {
          ls[p] = list_s[u * 32 + lane];
          li[p] = list_i[u * 32 + lane];
        }
      }
      select_tile<P>(ls, li, dots_u, su, rscale, t0, v, k, lane);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int u = warp + WARPS * (m + p);
        if (G > 1) {
          store(tg, u, ls[p], li[p]);
        } else {
          list_s[u * 32 + lane] = ls[p];
          list_i[u * 32 + lane] = li[p];
        }
      }
    }
    if (!C::SC_OWN) {
      fence_proxy_async();  // the dots written into the stage, before its next copies
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + q % NS);
    }
  }
  if (G == 1 || tiles == 0) {
    named_barrier(1, THREADS);
    for (int gg = 0; gg < G; ++gg)
      for (int u = warp; u < UG; u += WARPS)  // (an empty share's: sentinels)
        store(gg, u, list_s[u * 32 + lane], list_i[u * 32 + lane]);
  }
}

// One CTA a user: the S shares' lists of k (part_s / part_i [B][S][k]) into
// the user's top k.  Each of the 16 warps folds every 16th list into its own
// top-32 (the next list's load in flight), skipping a list none of whose
// entries beats its k-th; the warps' lists are then merged pairwise in four
// rounds.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                  float* __restrict__ out_s, long long* __restrict__ out_i, int S, int k) {
  constexpr int MW = MERGE_THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [MW][32]
  int* wi = reinterpret_cast<int*>(ws + MW * 32);
  const int u = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)u * S * k;
  float ls = -INFINITY;
  int li = INT_MAX;
  auto take = [&](float e, int ei) {
    const float th = __shfl_sync(FULL, ls, k - 1);
    const int thi = __shfl_sync(FULL, li, k - 1);
    if (__ballot_sync(FULL, better(e, ei, th, thi))) warp_merge(ls, li, e, ei, lane);
  };
  float e = -INFINITY;
  int ei = INT_MAX;
  if (warp < S && lane < k) {
    e = part_s[base + warp * k + lane];
    ei = part_i[base + warp * k + lane];
  }
  for (int s = warp; s < S; s += MW) {
    float en = -INFINITY;
    int ein = INT_MAX;
    if (s + MW < S && lane < k) {
      en = part_s[base + (s + MW) * k + lane];
      ein = part_i[base + (s + MW) * k + lane];
    }
    take(e, ei);
    e = en;
    ei = ein;
  }
  ws[warp * 32 + lane] = ls;
  wi[warp * 32 + lane] = li;
  for (int h = MW / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (warp < h) {
      take(lane < k ? ws[(warp + h) * 32 + lane] : -INFINITY,
           lane < k ? wi[(warp + h) * 32 + lane] : INT_MAX);
      ws[warp * 32 + lane] = ls;
      wi[warp * 32 + lane] = li;
    }
  }
  if (warp == 0 && lane < k) {
    out_s[(size_t)u * k + lane] = ls;
    out_i[(size_t)u * k + lane] = (long long)li;
  }
}

typedef CUresult (*EncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &q) == cudaSuccess &&
                    q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeFn>(p) : nullptr;
  }();
  return fn;
}

// the map of a row-major [rows, cols] matrix in boxes of 128 bytes x
// box_rows rows, 128-byte swizzled, zeros past its edges
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                       const void* base, int rows, int cols, int box_rows) {
  const EncodeFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int UG>
cudaError_t launch_shares(const float* users, const T* catalog, const float* scales,
                          float* part_s, int* part_i, int B, int N, int D, int k, int normalize,
                          int shares, int rows_per_share, int tile_rows, int mode,
                          cudaStream_t s) {
  using C = Cfg<T, UG>;
  CUtensorMap cmap{}, umap{};  // COPY16 only: the copies that need no map take none
  if (mode == COPY16) {
    cudaError_t e = tensor_map(&cmap,
                               sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                               sizeof(T), catalog, N, D, 32);
    if (e == cudaSuccess)
      e = tensor_map(&umap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, users, B, D, UG);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      topk_share_kernel<T, UG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  topk_share_kernel<T, UG><<<shares, CTA_THREADS, C::SMEM, s>>>(
      cmap, umap, users, catalog, scales, part_s, part_i, B, N, D, k, normalize, rows_per_share,
      tile_rows, mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t retrieve(const float* users, const T* catalog, const float* scales, float* part_s,
                     int* part_i, float* out_s, long long* out_i, int B, int N, int D, int k,
                     int normalize, int users_per_group, int shares, int rows_per_share,
                     int tile_rows, cudaStream_t s) {
  if (k < 1 || k > KMAX || k > N || B < 1 || D < 1 || shares < 1 || rows_per_share < 1 ||
      (long long)shares * rows_per_share < N || (long long)(shares - 1) * rows_per_share >= N ||
      tile_rows < 32 || tile_rows > TR || tile_rows % 32 || (uintptr_t)users % 16 ||
      (uintptr_t)catalog % 16)
    return cudaErrorInvalidValue;
  // bulk copies where every row segment is 16-byte aligned (the users' too),
  // else 4-byte cp.async (float32, or int8 rows of whole words), else loads
  const int mode = (D * (int)sizeof(T)) % 16 == 0       ? COPY16
                   : (sizeof(T) == 4 || D % 4 == 0) ? COPY4
                                                    : COPY1;
  cudaError_t err;
  switch (users_per_group) {
    case 8: err = launch_shares<T, 8>(users, catalog, scales, part_s, part_i, B, N, D, k,
                                      normalize, shares, rows_per_share, tile_rows, mode, s); break;
    case 16: err = launch_shares<T, 16>(users, catalog, scales, part_s, part_i, B, N, D, k,
                                        normalize, shares, rows_per_share, tile_rows, mode, s); break;
    case 32: err = launch_shares<T, 32>(users, catalog, scales, part_s, part_i, B, N, D, k,
                                        normalize, shares, rows_per_share, tile_rows, mode, s); break;
    case 64: err = launch_shares<T, 64>(users, catalog, scales, part_s, part_i, B, N, D, k,
                                        normalize, shares, rows_per_share, tile_rows, mode, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t smem2 = MERGE_THREADS * 8;
  err = cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<B, MERGE_THREADS, smem2, s>>>(part_s, part_i, out_s, out_i, shares, k);
  return cudaGetLastError();
}

}  // namespace

// K2.  users [B, D] and catalog [N, D] float32, contiguous, 16-byte aligned;
// part_s / part_i [B, shares, k] scratch; out_s [B, k] float32, out_i [B, k]
// int64.  normalize = 0 scores the raw dot products.  users_per_group,
// shares, rows_per_share and tile_rows are ops/ranking.retrieval_plan's.
// Requires 1 <= k <= 32, k <= N.
extern "C" int unirec_retrieve_topk(const float* users, const float* catalog, float* part_s,
                                    int* part_i, float* out_s, long long* out_i, int B, int N,
                                    int D, int k, int normalize, int users_per_group,
                                    int shares, int rows_per_share, int tile_rows,
                                    void* stream) {
  return (int)retrieve<float>(users, catalog, nullptr, part_s, part_i, out_s, out_i, B, N, D, k,
                              normalize, users_per_group, shares, rows_per_share, tile_rows,
                              static_cast<cudaStream_t>(stream));
}

// B11.  users [B, D] float32; catalog codes [N, D] int8 and row scales [N]
// float32 (quantize_rows); the rest as unirec_retrieve_topk, the users always
// normalised.
extern "C" int unirec_retrieve_topk_int8(const float* users, const int8_t* catalog,
                                         const float* scales, float* part_s, int* part_i,
                                         float* out_s, long long* out_i, int B, int N, int D,
                                         int k, int users_per_group, int shares,
                                         int rows_per_share, int tile_rows, void* stream) {
  return (int)retrieve<int8_t>(users, catalog, scales, part_s, part_i, out_s, out_i, B, N, D, k,
                               1, users_per_group, shares, rows_per_share, tile_rows,
                               static_cast<cudaStream_t>(stream));
}
