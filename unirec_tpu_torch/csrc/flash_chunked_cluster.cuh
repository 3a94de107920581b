// The cluster form of the chunked flash kernels (flash_chunked.cuh): bf16
// head dims of 6 to 8 chunks of 256 in the forward (K1, B13, B14, B14p;
// 1281 <= hd <= 2048) and of 3 to 8 chunks in the backward over rows (B7b's
// dq, B14 / B14p's one pass; 513 <= hd <= 2048), where the tensor-core forms'
// shared memory no longer holds the q tile's C chunks (and dO's); float32
// at 2 to 8 chunks in both, every product in 3xTF32 (chunk_fwd_cl32,
// chunk_bwd_rows_cl32, the second part of this file).
//
// Replaces, at those head dims, the Pallas TPU kernels
//   K1       unirec_tpu/ops/flash_causal_vjp.py::_fwd_kernel;
//   B7b dq   unirec_tpu/ops/flash_causal_vjp.py::_dq_kernel;
//   B13      unirec_tpu/ops/attention.py::_flash_kernel;
//   B14      unirec_tpu/ops/flash_vjp.py::_mh_fwd_kernel and _mh_bwd_kernel;
//   B14p     unirec_tpu/ops/flash_vjp.py::_fwd_kernel and _bwd_kernel.
//
// Design.  The C blocks of one (64-row q tile, key split, head, batch) run
// as one thread-block cluster of C blocks along x, block rank c owning chunk
// c of the output columns.  A block keeps only its own chunk of the q tile
// resident (and of dO in the backward): 33,792 bytes, or 67,584, whatever C
// is.  Each 32-key tile streams through a cp.async ring as two units of the
// block's own chunk, K_c and V_c (the backward takes V_c first, so that K_c
// is still in the ring for dq += ds K_c).  On its unit the block computes
// the partial S_c = Q_c K_c^T (and dP_c = dO_c V_c^T) on mma.sync with fp32
// accumulators, stores it to its exchange buffer in the accumulator layout
// ([n-tile][thread] float4s: a warp's stores and every peer's reads of one
// n-tile are 512 contiguous bytes) and arrives at the cluster barrier; after
// the wait it reads the C partials through distributed shared memory
// (mapa + ld.shared::cluster.v4) and sums them in rank order 0 .. C - 1, its
// own from registers.  So every block of the cluster holds the same S (and
// dP) bit for bit, computed once per chunk instead of C times, as the
// scalar form does.  The buffer is double-buffered by key-tile parity: a
// block writes tile t + 1's partial only after tile t's barrier, which its
// peers reach only after reading tile t - 1's, so one barrier a key tile
// suffices.  A last barrier keeps every block's shared memory alive until
// its peers' reads are done.  The rest is chunk_fwd_tc's and
// chunk_bwd_rows_tc's: the online softmax (P rounded to bf16 hi for K1 /
// B13, hi + lo for B14 / B14p's float32 o), o_c += P V_c; p = exp(s - m) /
// l, ds = p (dp - dsum) scale, dq_c += ds K_c, and for B14 / B14p dv_c = p^T
// dO_c and dk_c = ds^T Q_c per 64-row q tile (float32 partials and
// chunk_dkv_sum above one q tile: no atomics, the same bits on every run).
// The cross forward keeps chunk_fwd_tc's key splits and chunk_fwd_merge.
//
// What bounds it: at 8 users, 64 queries over 1,600 memory rows and one
// head of 1536 the forward moves ~40 MB (12 us at 3.35 TB/s); a block's
// time is its chain of 50 key tiles, each two units, one cluster barrier
// and C * 4 (forward) or C * 8 (backward) float4 reads through distributed
// shared memory a thread.  Shared memory: forward 33,792 (Q_c) + 16,384
// (two parities of S) + S * 17,024 (a unit and a key tile's key info), S
// = 3 units (101,248 bytes, two blocks an SM); backward 67,584 (Q_c, dO_c)
// + 10,240 (p, ds) + 32,768 (two parities of S and dP) + S * 17,024, S = 7
// (229,760 bytes).  The cluster is at most 8 blocks, the portable size: 8
// chunks, hd 2048.
//
// Launch: cudaLaunchKernelEx with a cluster of (C, 1, 1) over a grid of (C,
// q tiles x splits x heads, batch), after cudaOccupancyMaxActiveClusters
// says at least one such cluster fits (an error otherwise: the form is
// chosen by shape before the launch and nothing falls back).  This header
// is included by flash_chunked.cuh after its tensor-core kernels, whose
// constants and helpers it uses.
#pragma once

namespace chunked {

constexpr int CL_MAX = 8;                  // chunks of the cluster form: its blocks
constexpr int XF = TK / 8 * TTHREADS * 4;  // floats of one exchanged score tile
constexpr size_t CL_STAGE_BYTES = UNIT * sizeof(bf16) + TK * sizeof(float);
// shared memory besides the ring: forward Q_c and two parities of S;
// backward Q_c, dO_c, p, ds and two parities of (S, dP)
constexpr size_t CL_FWD_FIXED = QCH * sizeof(bf16) + 2 * XF * sizeof(float);
constexpr size_t CL_BWD_FIXED = (2 * QCH + 2 * BQ * PLD) * sizeof(bf16) + 4 * XF * sizeof(float);
// the rings' units: the forward's 3 let two blocks share an SM; the
// backward takes as many as fit
constexpr int CL_FWD_STAGES = 3;
constexpr int CL_BWD_STAGES = (int)((SMEM_MAX - CL_BWD_FIXED) / CL_STAGE_BYTES);
static_assert(CL_FWD_FIXED + CL_FWD_STAGES * CL_STAGE_BYTES <= SMEM_PAIR, "two blocks an SM");
static_assert(CL_BWD_STAGES >= 2 && CL_BWD_STAGES <= MAX_STAGES, "the backward's ring");

// part (the caller's partial, 16 floats of this thread) -> its slot of the
// exchange X ([TK / 8][TTHREADS] float4s)
__device__ __forceinline__ void cl_put(float* X, const float (&part)[TK / 8][4], int tid) {
#pragma unroll
  for (int n = 0; n < TK / 8; ++n)
    *reinterpret_cast<float4*>(X + (n * TTHREADS + tid) * 4) =
        make_float4(part[n][0], part[n][1], part[n][2], part[n][3]);
}

// sum = the C ranks' partials at this thread's slot of X, added in rank
// order 0 .. C - 1 (own: this block's, from registers), two ranks' reads
// in flight at a time
__device__ __forceinline__ void cl_sum(float (&sum)[TK / 8][4], const float (&own)[TK / 8][4],
                                       const float* X, int C, int c, int tid) {
  const uint32_t at = smem_addr(X + tid * 4);
#pragma unroll 2
  for (int r = 0; r < C; ++r) {
    float4 x[TK / 8];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
      x[n] = r == c ? make_float4(own[n][0], own[n][1], own[n][2], own[n][3])
                    : ld_cluster_f32x4(cluster_map(at + n * TTHREADS * 16, r));
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
      if (r == 0) {
        sum[n][0] = x[n].x; sum[n][1] = x[n].y; sum[n][2] = x[n].z; sum[n][3] = x[n].w;
      } else {
        sum[n][0] += x[n].x; sum[n][1] += x[n].y; sum[n][2] += x[n].z; sum[n][3] += x[n].w;
      }
    }
  }
}

// The forward in a cluster for one (64-row q tile, key split, head, batch):
// blockIdx.x = c, the block's chunk and rank; blockIdx.y = (h * n_qt + q
// tile) * splits + split.  Units: K_c, then V_c, of each key tile of the
// split's range.  Outputs as chunk_fwd_tc's: o (and from rank 0, m and l),
// or with splits > 1 the split's partial for chunk_fwd_merge.
template <typename OT, bool CAUSAL, bool PART>
__global__ void __launch_bounds__(TTHREADS)
chunk_fwd_cl(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const float* __restrict__ bm, OT* __restrict__ o, float* __restrict__ m_out,
             float* __restrict__ l_out, float* __restrict__ part, Strides qs, Strides ks,
             Strides vs, Strides os, int Lq, int Lkv, int H, int group, int C, int cols,
             int S, int splits, float scale) {
  constexpr bool F32O = std::is_same<OT, float>::value;
  constexpr int NT = TK / 8;
  extern __shared__ __align__(16) unsigned char chunk_cl_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(chunk_cl_smem);          // [BQ][LDC]  Q_c
  bf16* ring = Qs + QCH;                                        // [S][TK][LDC]
  float* X = reinterpret_cast<float*>(ring + S * UNIT);        // [2][NT][TTHREADS][4]
  float* kin = X + 2 * XF;                                      // [S][TK]

  const int c = blockIdx.x;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int sp = (int)blockIdx.y % splits;
  const int qi = (int)blockIdx.y / splits % n_qt;
  const int h = (int)blockIdx.y / splits / n_qt;
  // longest rows first (causal: the last q tiles visit the most key tiles)
  const int qt = CAUSAL ? n_qt - 1 - qi : qi;
  const int q0 = qt * BQ;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int nc = tc_cols<PART>(cols, c);
  const bf16* kb = k + b * ks.b + (h / group) * ks.h + c * CW;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h + c * CW;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / TK + 1 : (Lkv + TK - 1) / TK;
  const int per = (n_kv + splits - 1) / splits;
  const int t0 = sp * per, t1 = min(t0 + per, n_kv);
  const int n_units = t1 > t0 ? (t1 - t0) * 2 : 0;

  auto load_unit = [&](int u) {
    const int tt = u >> 1, t = t0 + tt;
    copy_chunk(ring + (u % S) * UNIT, (u & 1) ? vb : kb, (u & 1) ? vs.r : ks.r, t * TK, TK, Lkv,
               nc, tid);
    if (!(u & 1)) copy_key_info(kin + (tt % S) * TK, bmb, t * TK, Lkv, q, tid);
  };
  copy_chunk(Qs, q + b * qs.b + h * qs.h + c * CW, qs.r, q0, BQ, Lq, nc, tid);
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }

  float oacc[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2], l_run[2] = {0.f, 0.f};  // rows g and g + 8; l: this thread's columns' share
  m_run[0] = m_run[1] = CAUSAL ? -INFINITY : NEG_INF;
  float own[NT][4] = {}, s[NT][4] = {};

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_upto(S - 2);  // unit u (and Q_c) has landed
    __syncthreads();            // ... for every thread, and unit u - 1's stage is free
    if (u + S - 1 < n_units) load_unit(u + S - 1);
    cp_async_commit();
    const int tt = u >> 1;
    const int k0 = (t0 + tt) * TK;
    const bf16* tile = ring + (u % S) * UNIT;
    float* Xp = X + (tt & 1) * XF;
    // causal: a warp whose rows all lie before the tile's first key skips it
    // (in every block of the cluster alike: its peers neither write nor read
    // its slots)
    const bool active = !CAUSAL || k0 <= q0 + r0 + 15;
    if (!(u & 1)) {  // K_c: the partial S_c = Q_c K_c^T to the exchange
      if (active) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) own[n][e] = 0.f;
        chunk_scores(own, Qs, tile, r0, lane);
        cl_put(Xp, own, tid);
      }
      cluster_arrive();
      continue;
    }
    cluster_wait();  // every rank's partial of this tile is in its exchange
    if (!active) continue;
    cl_sum(s, own, Xp, C, c, tid);

    // the online softmax of rows g (e < 2) and g + 8 (e >= 2), as chunk_fwd_tc
    const float* kt = kin + (tt % S) * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        s[n][e] = tc_score<CAUSAL>(s[n][e], scale, kt[col], q0 + r0 + g + 8 * (e >> 1), k0 + col,
                                   Lkv);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = m_new == -INFINITY ? 1.f : __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    if constexpr (!F32O) {
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
    }
    // O += P V_c: P (bf16; hi and lo with F32O) from the S fragments, V via
    // ldmatrix.trans, CC columns at a time (F32O's tile sums stay few
    // registers); with F32O each tile's P V is summed from zero and folded
    // into o by an fp32 fma (o alpha + tile)
    constexpr int CC = 32;
#pragma unroll
    for (int c0 = 0; c0 < CW; c0 += CC) {
      float tacc[F32O ? CC / 8 : 1][4];
      if constexpr (F32O) {
#pragma unroll
        for (int n = 0; n < CC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = s[2 * kk + (r >> 1)] + 2 * (r & 1);
          if constexpr (F32O)
            split_bf16(x[0], x[1], a[r], lo[r]);
          else
            a[r] = pack_bf16(x[0], x[1]);
        }
#pragma unroll
        for (int nd = 0; nd < CC / 16; ++nd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                     LDC +
                                          c0 + nd * 16 + (lane >> 4) * 8));
          if constexpr (F32O) {
            mma_16816(tacc[2 * nd], a, bv[0], bv[1]);
            mma_16816(tacc[2 * nd + 1], a, bv[2], bv[3]);
            mma_16816(tacc[2 * nd], lo, bv[0], bv[1]);
            mma_16816(tacc[2 * nd + 1], lo, bv[2], bv[3]);
          } else {
            mma_16816(oacc[c0 / 8 + 2 * nd], a, bv[0], bv[1]);
            mma_16816(oacc[c0 / 8 + 2 * nd + 1], a, bv[2], bv[3]);
          }
        }
      }
      if constexpr (F32O) {
#pragma unroll
        for (int n = 0; n < CC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[c0 / 8 + n][e] = fmaf(oacc[c0 / 8 + n][e], alpha[e >> 1], tacc[n][e]);
      }
    }
  }
  cp_async_wait<0>();
  cluster_arrive();  // no block leaves while a peer may read its exchange
  cluster_wait();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int HDP = C * CW;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Lq) continue;
    if (splits > 1) {  // the split's partial: o unnormalised, m and l
      float* prow = part + ((((long long)sp * B + b) * H + h) * Lq + row) * HDP + c * CW;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n)
        *reinterpret_cast<float2*>(prow + n * 8 + 2 * t4) =
            make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
      if (c == 0 && t4 == 0) {
        float* ml = part + (long long)splits * B * H * Lq * HDP;
        ml[(((long long)sp * 2 * B + b) * Lq + row) * H + h] = m_run[r];
        ml[((((long long)sp * 2 + 1) * B + b) * Lq + row) * H + h] = l_run[r];
      }
      continue;
    }
    OT* orow = o + b * os.b + h * os.h + c * CW + row * os.r;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    const float den = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      if (PART && c * CW + n * 8 >= cols) continue;
      const float x0 = CAUSAL ? oacc[n][2 * r] * inv : oacc[n][2 * r] / den;
      const float x1 = CAUSAL ? oacc[n][2 * r + 1] * inv : oacc[n][2 * r + 1] / den;
      if constexpr (F32O)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t4) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) = __floats2bfloat162_rn(x0, x1);
    }
    if (m_out != nullptr && c == 0 && t4 == 0) {
      const size_t ri = ((size_t)b * Lq + row) * H + h;
      m_out[ri] = m_run[r];
      l_out[ri] = l_run[r];
    }
  }
}

// The backward over the key tiles of one (64-row q tile, head, batch) in a
// cluster: blockIdx.x = c, the block's chunk and rank; blockIdx.y = h * n_qt
// + q tile.  Units: V_c, then K_c, of each key tile; the partials dP_c (on
// V_c's unit) and S_c (on K_c's) go to the exchange, one barrier, the sums
// in rank order, then chunk_bwd_rows_tc's p, ds and dq_c += ds K_c with K_c
// still in the ring; with DKV (B14 / B14p) dv_c = p^T dO_c and dk_c = ds^T
// Q_c, written as they are (part null: one q tile) or as float32 partials
// [n_qt][dk, dv][B][H][Lkv][C * CW] to part.  Without DKV it is B7b's dq.
template <bool CAUSAL, bool DKV, bool PART>
__global__ void __launch_bounds__(TTHREADS)
chunk_bwd_rows_cl(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bm,
                  const bf16* __restrict__ dout, const float* __restrict__ m_in,
                  const float* __restrict__ l_in, const float* __restrict__ dsum_in,
                  bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  float* __restrict__ part, BwdStrides st, int Lq, int Lkv, int H, int group,
                  int C, int cols, int S, float scale) {
  constexpr int NT = TK / 8;
  constexpr int UNITS = TK / 8;  // (16 keys, dk or dv) products of a key tile
  extern __shared__ __align__(16) unsigned char chunk_cl_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(chunk_cl_smem);   // [BQ][LDC]  Q_c
  bf16* dOs = Qs + QCH;                                  // [BQ][LDC]  dO_c
  bf16* Ps = dOs + QCH;                                  // [BQ][PLD]  p, bf16
  bf16* dSs = Ps + BQ * PLD;                             // [BQ][PLD]  ds, bf16
  bf16* ring = dSs + BQ * PLD;                           // [S][TK][LDC]
  float* X = reinterpret_cast<float*>(ring + S * UNIT);  // [2][S, dP][NT][TTHREADS][4]
  float* kin = X + 4 * XF;                               // [S][TK]

  const int c = blockIdx.x;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int qi = (int)blockIdx.y % n_qt, h = (int)blockIdx.y / n_qt;
  const int qt = CAUSAL ? n_qt - 1 - qi : qi;
  const int q0 = qt * BQ;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int kh = h / group;
  const int nc = tc_cols<PART>(cols, c);
  const bf16* kb = k + b * st.k.b + kh * st.k.h + c * CW;
  const bf16* vb = v + b * st.v.b + kh * st.v.h + c * CW;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / TK + 1 : (Lkv + TK - 1) / TK;
  const int n_units = n_kv * 2;

  auto load_unit = [&](int u) {
    const int t = u >> 1;
    copy_chunk(ring + (u % S) * UNIT, (u & 1) ? kb : vb, (u & 1) ? st.k.r : st.v.r, t * TK, TK,
               Lkv, nc, tid);
    if (!(u & 1)) copy_key_info(kin + (t % S) * TK, bmb, t * TK, Lkv, q, tid);
  };
  copy_chunk(Qs, q + b * st.q.b + h * st.q.h + c * CW, st.q.r, q0, BQ, Lq, nc, tid);
  copy_chunk(dOs, dout + b * st.dout.b + h * st.dout.h + c * CW, st.dout.r, q0, BQ, Lq, nc, tid);
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp: m, l (0 guarded to 1), dsum
  float mr[2], lr[2], dsr[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    row_ok[r] = row < Lq;
    const size_t ri = ((size_t)b * Lq + (row_ok[r] ? row : 0)) * H + h;
    const float lv = row_ok[r] ? l_in[ri] : 1.f;
    mr[r] = row_ok[r] ? m_in[ri] : 0.f;
    lr[r] = lv == 0.f ? 1.f : lv;
    dsr[r] = row_ok[r] ? dsum_in[ri] : 0.f;
  }

  float dqacc[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.f;
  float own_s[NT][4] = {}, own_dp[NT][4] = {}, s[NT][4] = {}, dp[NT][4] = {};

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_upto(S - 2);  // unit u (and Q_c, dO_c) has landed
    __syncthreads();            // ... for every thread; unit u - 1's stage is free
    if (u + S - 1 < n_units) load_unit(u + S - 1);
    cp_async_commit();
    const int t = u >> 1;
    const int k0 = t * TK;
    const bf16* tile = ring + (u % S) * UNIT;
    float* Xs = X + (t & 1) * 2 * XF;  // this tile's S partials, then dP's
    // causal: a warp whose rows all lie before the tile's first key skips it
    // (in every block of the cluster alike)
    const bool active = !CAUSAL || k0 <= q0 + r0 + 15;
    if (!(u & 1)) {  // V_c: dP_c = dO_c V_c^T
      if (active) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) own_dp[n][e] = 0.f;
        chunk_scores(own_dp, dOs, tile, r0, lane);
        cl_put(Xs + XF, own_dp, tid);
      }
      continue;
    }
    if (active) {  // K_c: S_c = Q_c K_c^T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) own_s[n][e] = 0.f;
      chunk_scores(own_s, Qs, tile, r0, lane);
      cl_put(Xs, own_s, tid);
    }
    cluster_arrive();
    cluster_wait();  // every rank's partials of this tile are in its exchange
    if (active) {
      cl_sum(s, own_s, Xs, C, c, tid);
      cl_sum(dp, own_dp, Xs + XF, C, c, tid);
    }

    // p = exp(score - m) / l (0 for dead pairs and rows past Lq), ds = p (dp
    // - dsum) scale, kept in dp; with DKV both to shared memory as bf16
    const float* kt = kin + (t % S) * TK;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t4 + e;
          const float sc = tc_score<CAUSAL>(s[n][2 * r + e], scale, kt[col], q0 + r0 + g + 8 * r,
                                            k0 + col, Lkv);
          pe[e] = active && row_ok[r] && sc != -INFINITY ? __expf(sc - mr[r]) / lr[r] : 0.f;
          dp[n][2 * r + e] = pe[e] * (dp[n][2 * r + e] - dsr[r]) * scale;
        }
        if constexpr (DKV) {
          const int at = (r0 + g + 8 * r) * PLD + n * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(Ps + at) = pack_bf16(pe[0], pe[1]);
          *reinterpret_cast<uint32_t*>(dSs + at) = pack_bf16(dp[n][2 * r], dp[n][2 * r + 1]);
        }
      }
    // dq += ds K_c: ds (bf16) from the fragments, K_c via ldmatrix.trans
    if (active) {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = dp[2 * kk + (r >> 1)] + 2 * (r & 1);
          a[r] = pack_bf16(x[0], x[1]);
        }
#pragma unroll
        for (int nd = 0; nd < CW / 16; ++nd) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, smem_addr(tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDC +
                                          nd * 16 + (lane >> 4) * 8));
          mma_16816(dqacc[2 * nd], a, bk[0], bk[1]);
          mma_16816(dqacc[2 * nd + 1], a, bk[2], bk[3]);
        }
      }
    }
    if constexpr (DKV) {
      __syncthreads();  // p and ds of every row written
      // unit w: dv (w < UNITS / 2) or dk of keys kg .. kg + 15 of the tile,
      // over the q tile's 64 rows: p^T / ds^T and dO_c / Q_c via
      // ldmatrix.trans, 16 output columns at a time
      for (int w = warp; w < UNITS; w += TTHREADS / 32) {
        const bool is_dk = w >= UNITS / 2;
        const int kg = (w % (UNITS / 2)) * 16;
        const bf16* as = is_dk ? dSs : Ps;
        const bf16* bsrc = is_dk ? Qs : dOs;
        uint32_t a[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          ldmatrix_x4_trans(a[kk], smem_addr(as + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * PLD +
                                             kg + ((lane >> 3) & 1) * 8));
        const int key0 = k0 + kg + g;  // rows g and g + 8 of the product
#pragma unroll 2
        for (int nd = 0; nd < CW / 16; ++nd) {
          float acc[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, smem_addr(bsrc + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                       LDC +
                                            nd * 16 + (lane >> 4) * 8));
            mma_16816(acc[0], a[kk], bb[0], bb[1]);
            mma_16816(acc[1], a[kk], bb[2], bb[3]);
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int key = key0 + 8 * hf;
            if (key >= Lkv) continue;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int col = c * CW + nd * 16 + n * 8 + 2 * t4;
              if (PART && part == nullptr && col >= cols) continue;
              if (part != nullptr) {
                const long long at =
                    ((((long long)(qt * 2 + is_dk) * B + b) * H + h) * Lkv + key) * (C * CW) + col;
                *reinterpret_cast<float2*>(part + at) =
                    make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
              } else {
                bf16* out = is_dk ? dk + b * st.dk.b + h * st.dk.h + key * st.dk.r
                                  : dv + b * st.dv.b + h * st.dv.h + key * st.dv.r;
                *reinterpret_cast<__nv_bfloat162*>(out + col) =
                    __floats2bfloat162_rn(acc[n][2 * hf], acc[n][2 * hf + 1]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  cluster_arrive();  // no block leaves while a peer may read its exchange
  cluster_wait();

  bf16* dqb = dq + b * st.dq.b + h * st.dq.h + c * CW;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    bf16* drow = dqb + (q0 + r0 + g + 8 * r) * st.dq.r;
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
      if (!PART || c * CW + n * 8 < cols)
        *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(dqacc[n][2 * r], dqacc[n][2 * r + 1]);
  }
}

// ---------------------------------------------- float32: 3xTF32, a cluster --
// The float32 forms of the two cluster kernels above (chunk_fwd_cl32,
// chunk_bwd_rows_cl32): the same cluster of C blocks, one chunk a block, the
// partial scores summed in rank order through distributed shared memory, but
// every product on mma.sync.m16n8k8 in 3xTF32 (ptx_helpers.cuh: each
// float32 operand split into tf32 big + small in registers as it is read,
// three products a step, summed from zero and added to the accumulator by an
// fp32 add).  P and ds enter their products through the same split, never
// rounded to a lower type; o, dq, dk and dv stay float32.
//   - 8 warps a block: warp w and w + 4 share rows 16 (w % 4) .. + 15 of the
//     64-row q tile; warp w / 4 = hk owns half of the key tile's partial
//     scores (keys 16 hk .. of the forward's 32-key tile; n-tile hk of the
//     backward's 16) and half of the chunk's output columns (128 hk ..).
//     Both warps of a pair read the whole summed tile from the exchange and
//     run the same softmax (or p and ds) on it, bit for bit.  A thread so
//     holds 64 floats of o (or dq), not 128, and the SM two warps a
//     sub-partition: with 4 warps and 128 a thread (255 registers, spills)
//     the products waited on their own chains (B13 at 2 heads of 512 and 8
//     users 0.2009 ms, B14's backward 1.9391, scripts/probe_chunked_tf32.py).
//   - Tiles are float32 rows padded to LDF = 260 floats (4 mod 32 banks), read
//     as 32-bit words: the score products read rows g and columns t, t + 4
//     of A and B (banks 4g + t: no conflicts); the products whose A is the
//     accumulator of the previous one (P V_c, dq += ds K_c) take the k index
//     permuted (ptx_helpers.cuh) and read B's rows 2t and 2t + 1 (banks 8t +
//     g: no conflicts); dv_c = p^T dO_c and dk_c = ds^T Q_c read p / ds
//     ([64][20] floats, 20 = 4 mod 8) and dO_c / Q_c the same way.
//   - The exchange: X[n-tile][row group][lane] float4s; every thread reads
//     its slots of all C ranks (its own through the cluster window too), in
//     rank order.
//   - Shared memory: a float32 chunk row is 1,040 bytes, so a 64-row q chunk
//     is 66,560 and a 32-key unit 33,280.  Forward: Q_c + two parities of S
//     (16,384) + 4 stages of (a 32-key unit, its key info) = 216,576 bytes,
//     one block an SM (two would need Q_c and two units in 113,664).
//     Backward over rows: Q_c + dO_c (133,120) + p and ds (10,240) + two
//     parities of (S, dP) (16,384) + 4 stages of 16-key units (16,704 each)
//     = 226,560: 32-key units would leave room for one stage only, and 32-row
//     q tiles would double the q tiles, so B14 at Lq 64 would write float32
//     dk / dv partials (twice dk and dv's size) for chunk_dkv_sum.  So the
//     backward's key tile is 16 keys: twice the cluster barriers of 32-key
//     tiles, each over half the work.
//   - Key splits: one block an SM, so a grid of fewer blocks splits each
//     row's key tiles (the cross forward and backward: up to one block an
//     SM; K1 and B7b's dq, whose causal grid's last q tiles visit the most
//     key tiles: up to two), the forward's splits merged by chunk_fwd_merge
//     and the backward's dq partials added by chunk_dq_sum, in split order.
//   - What bounds it: the tensor cores' issue of three mma a step (about
//     30% of the time at 8 users in 2 heads of 512) and the split's ALU work
//     (about 18%; scripts/probe_chunked_tf32.py: without the second and
//     third products, or without the split), and, as in bf16, a block's
//     chain of key tiles with its exchange (about 10%).
constexpr int FTHREADS = 256;     // 8 warps
constexpr int LDF = CW + 4;       // padded float row of a float32 chunk tile
constexpr int QCH32 = BQ * LDF;   // one resident float32 q or dO chunk [BQ][LDF]
constexpr int TKR = 16;           // keys of the float32 backward's key tile
constexpr int PLF = TKR + 4;      // padded float row of its p / ds tiles
constexpr int XFR = TKR / 8 * BQ / 16 * 32 * 4;  // floats of one exchanged backward tile
constexpr size_t F32_FWD_STAGE = (size_t)(TK * LDF + TK) * sizeof(float);
constexpr size_t F32_BWD_STAGE = (size_t)(TKR * LDF + TKR) * sizeof(float);
constexpr size_t F32_FWD_FIXED = (size_t)(QCH32 + 2 * XF) * sizeof(float);
constexpr size_t F32_BWD_FIXED = (size_t)(2 * QCH32 + 2 * BQ * PLF + 4 * XFR) * sizeof(float);
constexpr int F32_FWD_STAGES = (int)((SMEM_MAX - F32_FWD_FIXED) / F32_FWD_STAGE);
constexpr int F32_BWD_STAGES = (int)((SMEM_MAX - F32_BWD_FIXED) / F32_BWD_STAGE);
static_assert(XF == TK / 8 * BQ / 16 * 32 * 4, "the forward's exchange holds its score tile");
static_assert(F32_FWD_STAGES >= 3 && F32_FWD_STAGES <= MAX_STAGES, "the forward's ring");
static_assert(F32_BWD_STAGES >= 3 && F32_BWD_STAGES <= MAX_STAGES, "the backward's ring");

// rows [r0, r0 + n) of one float32 chunk (src at the chunk's first column,
// row stride rs; rows past L and columns from ncol on zero-filled) -> smem
// [n][LDF] by 16-byte cp.async over the block's FTHREADS threads
__device__ __forceinline__ void copy_chunk32(float* dst, const float* src, long long rs, int r0,
                                             int n, int L, int ncol, int tid) {
  constexpr int CH = CW / 4;  // 16-byte pieces of a chunk's row
  for (int e = tid; e < n * CH; e += FTHREADS) {
    const int r = e / CH, ch = e % CH;
    const int row = r0 + r;
    const bool ok = row < L && ch * 4 < ncol;
    cp_async_16(smem_addr(dst + r * LDF + ch * 4), ok ? src + (long long)row * rs + ch * 4 : src,
                ok);
  }
}

// part (NT n-tiles of this thread's partial, from n-tile n0 of the key tile)
// -> its slots of the exchange X ([n-tile][row group][lane] float4s)
template <int NT>
__device__ __forceinline__ void cl32_put(float* X, const float (&part)[NT][4], int n0, int rg,
                                         int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    *reinterpret_cast<float4*>(X + (((n0 + n) * (BQ / 16) + rg) * 32 + lane) * 4) =
        make_float4(part[n][0], part[n][1], part[n][2], part[n][3]);
}

// sum = the C ranks' partials of the key tile's NT n-tiles at this thread's
// slots of X, added in rank order 0 .. C - 1, two ranks' reads in flight
template <int NT>
__device__ __forceinline__ void cl32_sum(float (&sum)[NT][4], const float* X, int C, int rg,
                                         int lane) {
  const uint32_t at = smem_addr(X + (rg * 32 + lane) * 4);
#pragma unroll 2
  for (int r = 0; r < C; ++r) {
    float4 x[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      x[n] = ld_cluster_f32x4(cluster_map(at + n * (BQ / 16) * 32 * 16, r));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (r == 0) {
        sum[n][0] = x[n].x; sum[n][1] = x[n].y; sum[n][2] = x[n].z; sum[n][3] = x[n].w;
      } else {
        sum[n][0] += x[n].x; sum[n][1] += x[n].y; sum[n][2] += x[n].z; sum[n][3] += x[n].w;
      }
    }
  }
}

// s (16 rows of the warp x 8 NT columns) += A (rows r0.., one float32 chunk)
// . B^T (the first 8 NT rows of Bt, one float32 chunk), in 3xTF32: each run
// of 4 steps (32 columns) summed from zero, then added to s
template <int NT>
__device__ __forceinline__ void chunk_scores32(float (&s)[NT][4], const float* A, const float* Bt,
                                               int r0, int lane) {
  const float* ar = A + (r0 + (lane >> 2)) * LDF + (lane & 3);
  const float* br = Bt + (lane >> 2) * LDF + (lane & 3);
#pragma unroll 1
  for (int k0 = 0; k0 < CW; k0 += 32) {
    float t[NT][4] = {};
#pragma unroll 2
    for (int kk = k0; kk < k0 + 32; kk += 8) {
      uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
      split_tf32(ar[kk], ab[0], as[0]);
      split_tf32(ar[8 * LDF + kk], ab[1], as[1]);
      split_tf32(ar[kk + 4], ab[2], as[2]);
      split_tf32(ar[8 * LDF + kk + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split_tf32(br[n * 8 * LDF + kk], bb[n][0], bs[n][0]);
        split_tf32(br[n * 8 * LDF + kk + 4], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<NT>(t, ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += t[n][e];
  }
}

// acc (16 rows x 8 ND columns) += P (the C fragments of NT n-tiles: 8 NT
// keys) . B (rows: those keys, from B's first row and the columns' first),
// in 3xTF32, each 8-key step's k index permuted: A slot t holds key 2t and
// slot t + 4 key 2t + 1, as the C fragment has them; B's rows read to match.
// G n-tiles of the output side by side, each group's NT steps summed from
// zero, then added to acc
template <int NT, int ND>
__device__ __forceinline__ void frag_product32(float (&acc)[ND][4], const float (&p)[NT][4],
                                               const float* B, int lane) {
  constexpr int G = 4;
  static_assert(ND % G == 0, "whole groups of n-tiles");
  const float* br = B + 2 * (lane & 3) * LDF + (lane >> 2);
  uint32_t ab[NT][4], as[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    split_tf32(p[kk][0], ab[kk][0], as[kk][0]);  // (g, key 2t)
    split_tf32(p[kk][2], ab[kk][1], as[kk][1]);  // (g + 8, key 2t)
    split_tf32(p[kk][1], ab[kk][2], as[kk][2]);  // (g, key 2t + 1)
    split_tf32(p[kk][3], ab[kk][3], as[kk][3]);  // (g + 8, key 2t + 1)
  }
#pragma unroll
  for (int nd = 0; nd < ND; nd += G) {
    float t[G][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float* bk = br + kk * 8 * LDF + nd * 8;
      uint32_t bb[G][2], bs[G][2];
#pragma unroll
      for (int n = 0; n < G; ++n) {
        split_tf32(bk[n * 8], bb[n][0], bs[n][0]);
        split_tf32(bk[LDF + n * 8], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<G>(t, ab[kk], as[kk], bb, bs);
    }
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd + n][e] += t[n][e];
  }
}

// The float32 forward in a cluster, chunk_fwd_cl's schedule: blockIdx.x = c,
// the block's chunk and rank; blockIdx.y = (q tile * H + h) * splits +
// split (causal: the causal forward takes splits too).  Units: K_c, then V_c, of each 32-key tile of the split's range.
// Warp w: rows 16 (w % 4) .., keys 16 hk .. of the partial S_c and columns
// 128 hk .. of o_c (hk = w / 4).  The online softmax in fp32 registers
// (expf) over the summed tile's 32 keys; o_c = o_c alpha + P V_c in place.
// Outputs as chunk_fwd_cl's (o in float32; m and l from the hk = 0 warps).
template <bool CAUSAL, bool PART>
__global__ void __launch_bounds__(FTHREADS)
chunk_fwd_cl32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bm, float* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ part,
               Strides qs, Strides ks, Strides vs, Strides os, int Lq, int Lkv, int H, int group,
               int C, int cols, int S, int splits, float scale) {
  constexpr int NT = TK / 8;        // n-tiles of the key tile
  constexpr int NTH = NT / 2;       // a warp's n-tiles of the partial scores
  constexpr int ND = CW / 2 / 8;    // a warp's n-tiles of o_c
  extern __shared__ __align__(16) unsigned char chunk_cl_smem[];
  float* Qs = reinterpret_cast<float*>(chunk_cl_smem);  // [BQ][LDF]  Q_c
  float* ring = Qs + QCH32;                              // [S][TK][LDF]
  float* X = ring + S * TK * LDF;                        // [2][NT][BQ / 16][32][4]
  float* kin = X + 2 * XF;                               // [S][TK]

  const int c = blockIdx.x;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int sp = (int)blockIdx.y % splits;
  const int h = (int)blockIdx.y / splits % H;
  const int qi = (int)blockIdx.y / splits / H;
  // longest rows first, over every head (causal: the last q tiles visit the
  // most key tiles, and a split grid runs in more than one wave)
  const int qt = CAUSAL ? n_qt - 1 - qi : qi;
  const int q0 = qt * BQ;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, hk = warp >> 2;
  const int r0 = rg * 16;
  const int nc = tc_cols<PART>(cols, c);
  const float* kb = k + b * ks.b + (h / group) * ks.h + c * CW;
  const float* vb = v + b * vs.b + (h / group) * vs.h + c * CW;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / TK + 1 : (Lkv + TK - 1) / TK;
  const int per = (n_kv + splits - 1) / splits;
  const int t0 = sp * per, t1 = min(t0 + per, n_kv);
  const int n_units = t1 > t0 ? (t1 - t0) * 2 : 0;

  auto load_unit = [&](int u) {
    const int tt = u >> 1, t = t0 + tt;
    copy_chunk32(ring + (u % S) * TK * LDF, (u & 1) ? vb : kb, (u & 1) ? vs.r : ks.r, t * TK, TK,
                 Lkv, nc, tid);
    if (!(u & 1)) copy_key_info(kin + (tt % S) * TK, bmb, t * TK, Lkv, q, tid);
  };
  copy_chunk32(Qs, q + b * qs.b + h * qs.h + c * CW, qs.r, q0, BQ, Lq, nc, tid);
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2], l_run[2] = {0.f, 0.f};  // rows g and g + 8; l: this thread's columns' share
  m_run[0] = m_run[1] = CAUSAL ? -INFINITY : NEG_INF;
  float own[NTH][4] = {}, s[NT][4] = {};

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_upto(S - 2);  // unit u (and Q_c) has landed
    __syncthreads();            // ... for every thread, and unit u - 1's stage is free
    if (u + S - 1 < n_units) load_unit(u + S - 1);
    cp_async_commit();
    const int tt = u >> 1;
    const int k0 = (t0 + tt) * TK;
    const float* tile = ring + (u % S) * TK * LDF;
    float* Xp = X + (tt & 1) * XF;
    // causal: a warp whose rows all lie before the tile's first key skips it
    // (in every block of the cluster alike, and both warps of the pair)
    const bool active = !CAUSAL || k0 <= q0 + r0 + 15;
    if (!(u & 1)) {  // K_c: the warp's half of the partial S_c = Q_c K_c^T
      if (active) {
#pragma unroll
        for (int n = 0; n < NTH; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) own[n][e] = 0.f;
        chunk_scores32(own, Qs, tile + hk * NTH * 8 * LDF, r0, lane);
        cl32_put(Xp, own, hk * NTH, rg, lane);
      }
      cluster_arrive();
      continue;
    }
    cluster_wait();  // every rank's partial of this tile is in its exchange
    if (!active) continue;
    cl32_sum(s, Xp, C, rg, lane);

    // the online softmax of rows g (e < 2) and g + 8 (e >= 2)
    const float* kt = kin + (tt % S) * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        s[n][e] = tc_score<CAUSAL>(s[n][e], scale, kt[col], q0 + r0 + g + 8 * (e >> 1), k0 + col,
                                   Lkv);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = m_new == -INFINITY ? 1.f : expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == -INFINITY ? 0.f : expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
    frag_product32(oacc, s, tile + hk * ND * 8, lane);  // o_c += P V_c, the warp's columns
  }
  cp_async_wait<0>();
  cluster_arrive();  // no block leaves while a peer may read its exchange
  cluster_wait();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int HDP = C * CW;
  const int c0 = c * CW + hk * ND * 8;  // the warp's first column of o
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Lq) continue;
    if (splits > 1) {  // the split's partial: o unnormalised, m and l
      float* prow = part + ((((long long)sp * B + b) * H + h) * Lq + row) * HDP + c0;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(prow + n * 8 + 2 * t4) =
            make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
      if (c == 0 && hk == 0 && t4 == 0) {
        float* ml = part + (long long)splits * B * H * Lq * HDP;
        ml[(((long long)sp * 2 * B + b) * Lq + row) * H + h] = m_run[r];
        ml[((((long long)sp * 2 + 1) * B + b) * Lq + row) * H + h] = l_run[r];
      }
      continue;
    }
    float* orow = o + b * os.b + h * os.h + c0 + row * os.r;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    const float den = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (PART && c0 + n * 8 + 2 * t4 >= cols) continue;
      const float x0 = CAUSAL ? oacc[n][2 * r] * inv : oacc[n][2 * r] / den;
      const float x1 = CAUSAL ? oacc[n][2 * r + 1] * inv : oacc[n][2 * r + 1] / den;
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t4) = make_float2(x0, x1);
    }
    if (m_out != nullptr && c == 0 && hk == 0 && t4 == 0) {
      const size_t ri = ((size_t)b * Lq + row) * H + h;
      m_out[ri] = m_run[r];
      l_out[ri] = l_run[r];
    }
  }
}

// The float32 backward over the key tiles of one (64-row q tile, key split,
// head, batch) in a cluster, chunk_bwd_rows_cl's schedule over 16-key tiles:
// blockIdx.x = c, the block's chunk and rank; blockIdx.y = (q tile * H +
// h) * splits + split.  Units: V_c, then K_c, of each key tile of the
// split's range; warp w's n-tile hk = w / 4
// of the partials dP_c (on V_c's unit) and S_c (on K_c's) to the exchange,
// one cluster barrier, the sums of both n-tiles in rank order; p = exp(s -
// m) / l and ds = p (dp - dsum) scale in fp32 registers, dq_c += ds K_c for
// the warp's columns 128 hk .. with K_c still in the ring.  With DKV (B14 /
// B14p) each warp writes its n-tile of p and ds to shared memory and warp w
// takes dv (w < 4) or dk of the tile's 16 keys and chunk columns 64 (w % 4)
// .. + 63 over the q tile's 64 rows (dv_c = p^T dO_c, dk_c = ds^T Q_c),
// written as they are (part null: one q tile) or as float32 partials
// [n_qt][dk, dv][B][H][Lkv][C * CW] to part.  Without DKV it is B7b's dq.
// With splits > 1 each split writes its dq_c unsummed to dqpart
// [splits][B][H][Lq][C * CW] for chunk_dq_sum.
template <bool CAUSAL, bool DKV, bool PART>
__global__ void __launch_bounds__(FTHREADS)
chunk_bwd_rows_cl32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bm,
                    const float* __restrict__ dout, const float* __restrict__ m_in,
                    const float* __restrict__ l_in, const float* __restrict__ dsum_in,
                    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ part, float* __restrict__ dqpart, BwdStrides st, int Lq,
                    int Lkv, int H, int group, int C, int cols, int S, int splits, float scale) {
  constexpr int NT = TKR / 8;      // n-tiles of the key tile (one a warp of the pair)
  constexpr int ND = CW / 2 / 8;   // a warp's n-tiles of dq_c
  extern __shared__ __align__(16) unsigned char chunk_cl_smem[];
  float* Qs = reinterpret_cast<float*>(chunk_cl_smem);  // [BQ][LDF]  Q_c
  float* dOs = Qs + QCH32;                               // [BQ][LDF]  dO_c
  float* Ps = dOs + QCH32;                               // [BQ][PLF]  p
  float* dSs = Ps + BQ * PLF;                            // [BQ][PLF]  ds
  float* ring = dSs + BQ * PLF;                          // [S][TKR][LDF]
  float* X = ring + S * TKR * LDF;                       // [2][S, dP][NT][BQ / 16][32][4]
  float* kin = X + 4 * XFR;                              // [S][TKR]

  const int c = blockIdx.x;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int sp = (int)blockIdx.y % splits;
  const int h = (int)blockIdx.y / splits % H, qi = (int)blockIdx.y / splits / H;
  // longest rows first, over every head (as chunk_fwd_cl32)
  const int qt = CAUSAL ? n_qt - 1 - qi : qi;
  const int q0 = qt * BQ;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, hk = warp >> 2;
  const int r0 = rg * 16;
  const int kh = h / group;
  const int nc = tc_cols<PART>(cols, c);
  const float* kb = k + b * st.k.b + kh * st.k.h + c * CW;
  const float* vb = v + b * st.v.b + kh * st.v.h + c * CW;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / TKR + 1 : (Lkv + TKR - 1) / TKR;
  const int per = (n_kv + splits - 1) / splits;
  const int t0 = sp * per, t1 = min(t0 + per, n_kv);
  const int n_units = t1 > t0 ? (t1 - t0) * 2 : 0;

  auto load_unit = [&](int u) {
    const int tt = u >> 1, t = t0 + tt;
    copy_chunk32(ring + (u % S) * TKR * LDF, (u & 1) ? kb : vb, (u & 1) ? st.k.r : st.v.r,
                 t * TKR, TKR, Lkv, nc, tid);
    if (!(u & 1)) copy_key_info<TKR>(kin + (tt % S) * TKR, bmb, t * TKR, Lkv, q, tid);
  };
  copy_chunk32(Qs, q + b * st.q.b + h * st.q.h + c * CW, st.q.r, q0, BQ, Lq, nc, tid);
  copy_chunk32(dOs, dout + b * st.dout.b + h * st.dout.h + c * CW, st.dout.r, q0, BQ, Lq, nc, tid);
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp: m, l (0 guarded to 1), dsum
  float mr[2], lr[2], dsr[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    row_ok[r] = row < Lq;
    const size_t ri = ((size_t)b * Lq + (row_ok[r] ? row : 0)) * H + h;
    const float lv = row_ok[r] ? l_in[ri] : 1.f;
    mr[r] = row_ok[r] ? m_in[ri] : 0.f;
    lr[r] = lv == 0.f ? 1.f : lv;
    dsr[r] = row_ok[r] ? dsum_in[ri] : 0.f;
  }

  float dqacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.f;
  float own_s[1][4] = {}, own_dp[1][4] = {}, s[NT][4] = {}, dp[NT][4] = {};

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_upto(S - 2);  // unit u (and Q_c, dO_c) has landed
    __syncthreads();            // ... for every thread; unit u - 1's stage is free
    if (u + S - 1 < n_units) load_unit(u + S - 1);
    cp_async_commit();
    const int tt = u >> 1;
    const int k0 = (t0 + tt) * TKR;
    const float* tile = ring + (u % S) * TKR * LDF;
    float* Xs = X + (tt & 1) * 2 * XFR;  // this tile's S partials, then dP's
    // causal: a warp whose rows all lie before the tile's first key skips it
    // (in every block of the cluster alike, and both warps of the pair)
    const bool active = !CAUSAL || k0 <= q0 + r0 + 15;
    if (!(u & 1)) {  // V_c: n-tile hk of dP_c = dO_c V_c^T
      if (active) {
#pragma unroll
        for (int e = 0; e < 4; ++e) own_dp[0][e] = 0.f;
        chunk_scores32(own_dp, dOs, tile + hk * 8 * LDF, r0, lane);
        cl32_put(Xs + XFR, own_dp, hk, rg, lane);
      }
      continue;
    }
    if (active) {  // K_c: n-tile hk of S_c = Q_c K_c^T
#pragma unroll
      for (int e = 0; e < 4; ++e) own_s[0][e] = 0.f;
      chunk_scores32(own_s, Qs, tile + hk * 8 * LDF, r0, lane);
      cl32_put(Xs, own_s, hk, rg, lane);
    }
    cluster_arrive();
    cluster_wait();  // every rank's partials of this tile are in its exchange
    if (active) {
      cl32_sum(s, Xs, C, rg, lane);
      cl32_sum(dp, Xs + XFR, C, rg, lane);
    }

    // p = exp(score - m) / l (0 for dead pairs and rows past Lq), ds = p (dp
    // - dsum) scale, kept in dp; with DKV the warp's n-tile of both to
    // shared memory
    const float* kt = kin + (tt % S) * TKR;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t4 + e;
          const float sc = tc_score<CAUSAL>(s[n][2 * r + e], scale, kt[col], q0 + r0 + g + 8 * r,
                                            k0 + col, Lkv);
          pe[e] = active && row_ok[r] && sc != -INFINITY ? expf(sc - mr[r]) / lr[r] : 0.f;
          dp[n][2 * r + e] = pe[e] * (dp[n][2 * r + e] - dsr[r]) * scale;
        }
        if (DKV && n == hk) {
          const int at = (r0 + g + 8 * r) * PLF + n * 8 + 2 * t4;
          *reinterpret_cast<float2*>(Ps + at) = make_float2(pe[0], pe[1]);
          *reinterpret_cast<float2*>(dSs + at) = make_float2(dp[n][2 * r], dp[n][2 * r + 1]);
        }
      }
    if (active) frag_product32(dqacc, dp, tile + hk * ND * 8, lane);  // dq_c += ds K_c
    if constexpr (DKV) {
      __syncthreads();  // p and ds of every row written
      // warp w: dv (w < 4) or dk of the tile's keys g and g + 8, columns cq
      // .. cq + 63 of the chunk, over the q tile's rows: p^T / ds^T (A, the
      // k index over rows permuted as in frag_product32) and dO_c / Q_c
      const bool is_dk = warp >= 4;
      const int cq = rg * 64;
      const float* ar = (is_dk ? dSs : Ps) + 2 * t4 * PLF + g;
      const float* br = (is_dk ? Qs : dOs) + 2 * t4 * LDF + cq + g;
#pragma unroll 1
      for (int n0 = 0; n0 < 64; n0 += 32) {
        float acc[4][4] = {};
#pragma unroll
        for (int rs = 0; rs < BQ; rs += 32) {  // 4 steps from zero, then added
          float t[4][4] = {};
#pragma unroll 2
          for (int kk = rs; kk < rs + 32; kk += 8) {
            uint32_t ab[4], as[4];
            split_tf32(ar[kk * PLF], ab[0], as[0]);            // (key g, row 2t)
            split_tf32(ar[kk * PLF + 8], ab[1], as[1]);        // (key g + 8, row 2t)
            split_tf32(ar[(kk + 1) * PLF], ab[2], as[2]);      // (key g, row 2t + 1)
            split_tf32(ar[(kk + 1) * PLF + 8], ab[3], as[3]);  // (key g + 8, row 2t + 1)
            uint32_t bb[4][2], bs[4][2];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              split_tf32(br[kk * LDF + n0 + n * 8], bb[n][0], bs[n][0]);
              split_tf32(br[(kk + 1) * LDF + n0 + n * 8], bb[n][1], bs[n][1]);
            }
            mma_3xtf32<4>(t, ab, as, bb, bs);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = k0 + g + 8 * hf;
          if (key >= Lkv) continue;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = c * CW + cq + n0 + n * 8 + 2 * t4;
            if (part != nullptr) {
              const long long at =
                  ((((long long)(qt * 2 + is_dk) * B + b) * H + h) * Lkv + key) * (C * CW) + col;
              *reinterpret_cast<float2*>(part + at) = make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
            } else if (!PART || col < cols) {
              float* out = is_dk ? dk + b * st.dk.b + h * st.dk.h + key * st.dk.r
                                 : dv + b * st.dv.b + h * st.dv.h + key * st.dv.r;
              *reinterpret_cast<float2*>(out + col) = make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  cluster_arrive();  // no block leaves while a peer may read its exchange
  cluster_wait();

  const int c0 = c * CW + hk * ND * 8;  // the warp's first column of dq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    const int row = q0 + r0 + g + 8 * r;
    const bool whole = splits > 1;  // the split's partial: every column
    float* drow = whole ? dqpart + ((((long long)sp * B + b) * H + h) * Lq + row) * (C * CW) + c0
                        : dq + b * st.dq.b + h * st.dq.h + row * st.dq.r + c0;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (whole || !PART || c0 + n * 8 + 2 * t4 < cols)
        *reinterpret_cast<float2*>(drow + n * 8 + 2 * t4) =
            make_float2(dqacc[n][2 * r], dqacc[n][2 * r + 1]);
  }
}

// dq from the key splits' float32 partials of chunk_bwd_rows_cl32
// ([splits][B][H][Lq][HDP]), added in split order (its first cols columns)
template <typename T>
__global__ void __launch_bounds__(256)
chunk_dq_sum(const float* __restrict__ part, T* __restrict__ dq, Strides dqs, int splits, int B,
             int H, int Lq, int HDP, int cols) {
  const long long n = (long long)B * H * Lq * HDP;  // elements of one split
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    const int col = (int)(i % HDP);
    if (col >= cols) continue;
    const long long row = i / HDP;  // (b, h, query row)
    const int r = (int)(row % Lq);
    const int h = (int)((row / Lq) % H);
    const int b = (int)(row / ((long long)Lq * H));
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) sum += part[sp * n + i];
    put(dq + b * dqs.b + h * dqs.h + r * dqs.r + col, sum);
  }
}

// a launch of kernel over grid in clusters of (C, 1, 1), threads a block,
// with smem bytes of dynamic shared memory a block, after the occupancy query says that at
// least one such cluster fits (cudaErrorNotSupported otherwise)
template <typename Kernel, typename... Args>
cudaError_t launch_in_clusters(Kernel kernel, dim3 grid, int threads, int C, size_t smem,
                               cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorNotSupported;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename OT, bool CAUSAL, bool PART>
cudaError_t launch_fwd_cl(const void* q, const void* k, const void* v, const float* bm, void* o,
                          float* m, float* l, float* part, Strides qs, Strides ks, Strides vs,
                          Strides os, int B, int H, int group, int Lq, int Lkv, int C, int cols,
                          int splits, float scale, cudaStream_t stream) {
  constexpr int S = CL_FWD_STAGES;
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((long long)n_qt * splits * H > 65535) return cudaErrorInvalidValue;
  return launch_in_clusters(
      chunk_fwd_cl<OT, CAUSAL, PART>, dim3(C, n_qt * splits * H, B), TTHREADS, C,
      CL_FWD_FIXED + S * CL_STAGE_BYTES, stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), bm, static_cast<OT*>(o), m, l,
      part, qs, ks, vs, os, Lq, Lkv, H, group, C, cols, S, splits, scale);
}

template <bool CAUSAL, bool DKV, bool PART>
cudaError_t launch_rows_cl(const void* q, const void* k, const void* v, const float* bm,
                           const void* dout, const float* m, const float* l, const float* dsum,
                           void* dq, void* dk, void* dv, float* part, const BwdStrides& st,
                           int B, int H, int group, int Lq, int Lkv, int C, int cols,
                           float scale, cudaStream_t stream) {
  constexpr int S = CL_BWD_STAGES;
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((long long)n_qt * H > 65535) return cudaErrorInvalidValue;
  return launch_in_clusters(
      chunk_bwd_rows_cl<CAUSAL, DKV, PART>, dim3(C, n_qt * H, B), TTHREADS, C,
      CL_BWD_FIXED + S * CL_STAGE_BYTES, stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), bm,
      static_cast<const bf16*>(dout), m, l, dsum, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, st, Lq, Lkv, H, group, C, cols, S, scale);
}


template <bool CAUSAL, bool PART>
cudaError_t launch_fwd_cl32(const void* q, const void* k, const void* v, const float* bm, void* o,
                            float* m, float* l, float* part, Strides qs, Strides ks, Strides vs,
                            Strides os, int B, int H, int group, int Lq, int Lkv, int C, int cols,
                            int splits, float scale, cudaStream_t stream) {
  constexpr int S = F32_FWD_STAGES;
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((long long)n_qt * splits * H > 65535) return cudaErrorInvalidValue;
  return launch_in_clusters(
      chunk_fwd_cl32<CAUSAL, PART>, dim3(C, n_qt * splits * H, B), FTHREADS, C,
      F32_FWD_FIXED + S * F32_FWD_STAGE, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), bm, static_cast<float*>(o), m,
      l, part, qs, ks, vs, os, Lq, Lkv, H, group, C, cols, S, splits, scale);
}

template <bool CAUSAL, bool DKV, bool PART>
cudaError_t launch_rows_cl32(const void* q, const void* k, const void* v, const float* bm,
                             const void* dout, const float* m, const float* l, const float* dsum,
                             void* dq, void* dk, void* dv, float* part, float* dqpart,
                             const BwdStrides& st, int B, int H, int group, int Lq, int Lkv, int C,
                             int cols, int splits, float scale, cudaStream_t stream) {
  constexpr int S = F32_BWD_STAGES;
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((long long)n_qt * splits * H > 65535) return cudaErrorInvalidValue;
  return launch_in_clusters(
      chunk_bwd_rows_cl32<CAUSAL, DKV, PART>, dim3(C, n_qt * splits * H, B), FTHREADS, C,
      F32_BWD_FIXED + S * F32_BWD_STAGE, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), bm,
      static_cast<const float*>(dout), m, l, dsum, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), part, dqpart, st, Lq, Lkv, H, group, C,
      cols, S, splits, scale);
}

}  // namespace chunked
