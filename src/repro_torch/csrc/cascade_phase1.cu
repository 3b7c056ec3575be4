// Cascade verify attention, phase 1, in float32 on Hopper tensor cores
// (sm_90a), in 3xTF32: mma.sync on cp.async-staged tiles, the GQA group
// stacked so each K/V tile is staged once per block.
//
// Replaces, for float32 inputs, the two Pallas TPU kernels of
// repro/kernels/cascade_attention.py:
//   * _phase1_kernel        (dense cache [B,Hkv,S,D], rolling buffers)
//         -> cascade_phase1_dense below
//   * _phase1_paged_kernel  (page pool [P,Hkv,page,D] + page table [B,MP])
//         -> cascade_phase1_paged below
// Both emit the un-normalized split-K flash partials of a query block
// (the D2SD tree, Tq <= ~136 tokens) over a long KV cache:
//   acc [B,Hq,ns,Tq,D], m/l [B,Hq,ns,Tq] (fp32); the phase-2 log-sum-exp
// merge with the tree-masked block runs in torch
// (repro_torch/kernels/cascade_attention.py). bfloat16 inputs run in
// cascade_phase1_sm90.cu instead; these entry points take float32 only,
// q pre-scaled and contiguous.
//
// What bounds it on an H100: at the decode verify shape (B 4, Hq 32, Hkv
// 8, D 128, Tq 76, caches of 520-600 keys) a call does 2.8 GFLOP on about
// 18.5 MB of live fp32 K/V, 5 MB of q and 10 MB (dense, 2 splits) to 40 MB
// (paged, 8 splits) of partials: 0.010-0.019 ms of bytes at 3.35 TB/s,
// 0.042 ms of FLOPs on the CUDA cores (67 TFLOP/s), 0.017 ms as 3xTF32 on
// the tensor cores (3 x 2.8 GFLOP at 495 TFLOP/s). So the products go to
// the tensor cores, and each K/V byte is read once per KV head:
//   * one block per (slab of 64 stacked query rows, split, batch row x KV
//     head): the GQA group's g query heads are stacked into one M
//     dimension of g*Tq rows (row r is head hk*g + r / Tq, position
//     r % Tq), so a K/V tile is staged once for 64 query rows (304 rows
//     at the verify shape fill five slabs, 5 % of them padding); split is
//     the slowest grid index, so the long first splits start first. Four
//     warps of 16 rows; two blocks share an SM (107.5 KB of shared
//     memory and at most 178 registers a thread each);
//   * all 128 threads stage 32-key K/V tiles with cp.async into a ring of
//     two stages: the next tile loads while this one is multiplied, one
//     __syncthreads a tile. Each key's address is resolved per key, once
//     a warp (a lane resolves it, the warp copies the row): the slot of a
//     dense or rolling cache, or the physical page from the table,
//     clamped to [0, n_phys-1] before it is multiplied by the page stride
//     (PAGE_SENTINEL is int32 max). So K/V are read in place through the
//     caller's strides. Copies are 16 bytes where the bases, D and
//     every stepped stride are multiples of 4 floats, else 8 or 4 bytes;
//     keys past the split's live end and columns past D arrive as zeros.
//     Each split loops only over its keys below min(cache_len, S) (dense)
//     or its pages below ceil(cache_len / pos_stride) (paged): dead pages
//     cost neither bytes nor FLOPs;
//   * S = Q K^T and O += P V run as mma.sync m16n8k8 tf32 in 3xTF32: each
//     operand x is split as its fragment is loaded into big = x rounded
//     to tf32 (to nearest, ties away: cvt.rna) and small = x - big (exact
//     in fp32), which the tensor cores read truncated to tf32; small*big
//     + big*small + big*big go into fp32 accumulators. The dropped
//     small*small term and the truncation of small leave each product
//     within 2^-21 of its value, against fp32's 2^-24: the error budget
//     that tests/test_torch_kernels.py emulates. P is split the same way.
//     The split costs three integer and float operations and no cvt
//     (which compiles to four with an infinity test); the two correction
//     products of S go to an accumulator of their own, so the dependent
//     mma chains are half as long. The mma units add with truncation, so
//     each tile's P V products go to a fresh accumulator that is added
//     to O in fp32: one accumulator over a 32k-token split biased O by
//     up to 4e-3 of the partials;
//   * fragment orders that need no shuffle and no bank conflict: in
//     Q K^T, k-step pairs read float4s of Q and K (d = 16 kk + 4 tig +
//     {0,1} for the first k-step, {2,3} for the second), rows 144 floats
//     apart; in P V, the S accumulator is the A fragment as it stands
//     (its keys 2 tig, 2 tig + 1 are the k indices tig, tig + 4, so V is
//     read at the same keys), and n-block j of a 32-column group holds
//     columns 4 n + j, so a thread reads float4s of V (rows 132 floats
//     apart) and writes 8 contiguous acc columns;
//   * the online softmax stays in the registers of the warp that owns the
//     rows: fp32, natural units (expf, as the plain version), row max and
//     sum over a quad of lanes;
//   * a row that sees every key of a tile skips the mask;
//   * head dims up to 256 (recurrentgemma-2b's local layers) run the same
//     body with twice the tile width (phase1_tf32x3_kernel_d256): 201 KB
//     of shared memory, one block an SM, and 128 O accumulators a thread.
// On an H100 the kernel is bound by latency, not by bytes or the mma
// units: two warps an SM sub-partition fill neither their issue slots
// nor the mma pipe, and each warp waits on its chain of loads, splits,
// products and the softmax between them.
// Each block owns its output rows (no atomics, deterministic); a split
// with no live key loads nothing and writes acc = 0, l = 0, m = -1e30.
//
// Masking follows the Pallas bodies exactly: masked in-range keys score
// -1e30 (a fully masked split therefore reports m = -1e30), keys past the
// split's live end are not part of the split (-inf), rolling position
// recovery is kpos = last - rem(last - slot, S) with C's truncating %
// (jax.lax.rem) and the TRUE capacity S, padded split slots (slot >= S)
// are dead, pages take pos_stride/pos_offset, the window keeps kpos >
// qpos - window, and the softcap (softcap * tanh(s / softcap)) comes
// before the mask.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int BM = 64;               // stacked query rows per block
constexpr int BK = 32;               // keys per tile
constexpr int NTHREADS = 128;        // four warps of 16 rows

// The tile geometry of a kernel for head dims up to DMAX (128, or 256
// for recurrentgemma-2b's local layers).
template <int DMAX>
struct Geom {
  static constexpr int QK_LD = DMAX + 16;   // row stride (floats) of Q, K
  static constexpr int V_LD = DMAX + 4;     // of V tiles
  static constexpr int Q_FLOATS = BM * QK_LD;
  static constexpr int K_FLOATS = BK * QK_LD;
  static constexpr int V_FLOATS = BK * V_LD;
  static constexpr int SMEM_BYTES = 4 * (Q_FLOATS + 2 * (K_FLOATS + V_FLOATS));
};

struct Params {
  const float* q;            // [B,Hq,Tq,D] contiguous, fp32, pre-scaled
  const float* k;
  const float* v;
  long long ks0, ks1, ks2;   // element strides of the K view (last is 1)
  long long vs0, vs1, vs2;
  const int* table;          // paged: [B, mp]
  const int* cache_len;      // [B]
  const int* q_abs;          // [B, Tq]
  float* acc;                // [B,Hq,ns,Tq,D]
  float* m;                  // [B,Hq,ns,Tq]
  float* l;
  int B, Hq, Hkv, Tq, D, ns, nk_inner;
  // dense: S = true capacity, bk = split block; paged: page geometry
  int S, bk, rolling;
  int page, mp, n_phys, stride, off;
  int window;                // <= 0: none
  float softcap;             // <= 0: none
  int vec;                   // floats per cp.async copy: 4, 2 or 1
};

// The slab's Q rows [r0, r0 + BM), VEC floats a copy. A KV head's stacked
// rows are contiguous in q: row r of head hk is q row (b*Hq + hk*g)*Tq + r.
template <int DMAX, int VEC>
__device__ __forceinline__ void stage_q(const Params& p, float* qs, int b,
                                        int hk, int g, int r0, int R) {
  constexpr int QK_LD = Geom<DMAX>::QK_LD;
  constexpr int CPR = DMAX / VEC;
  const float* q0 =
      p.q + (static_cast<long long>(b * p.Hq + hk * g) * p.Tq + r0) * p.D;
#pragma unroll 4
  for (int i = threadIdx.x; i < BM * CPR; i += NTHREADS) {
    const int row = i / CPR, c = i % CPR * VEC;
    const bool ok = r0 + row < R && c < p.D;
    cp_async<4 * VEC>(qs + row * QK_LD + c, ok ? q0 + row * p.D + c : p.q,
                      ok);
  }
}

// The K/V tile of keys [t0, t0 + BK), VEC floats a copy: warp w copies
// the rows of keys w + 4 s, whose addresses lane s resolved.
template <int DMAX, bool PAGED, int VEC>
__device__ __forceinline__ void stage_kv(const Params& p, float* ks,
                                         float* vs, int b, int hk, int t0,
                                         int k_end) {
  constexpr int QK_LD = Geom<DMAX>::QK_LD, V_LD = Geom<DMAX>::V_LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  long long kl = 0, vl = 0;
  const int tl = t0 + warp + 4 * (lane % 8);
  if (tl < k_end) key_rows<PAGED>(p, b, hk, tl, kl, vl);
#pragma unroll
  for (int s = 0; s < BK / 4; ++s) {
    const int j = warp + 4 * s;
    const long long ko = __shfl_sync(0xffffffffu, kl, s);
    const long long vo = __shfl_sync(0xffffffffu, vl, s);
#pragma unroll
    for (int u = 0; u < DMAX / (32 * VEC); ++u) {
      const int c = (lane + 32 * u) * VEC;
      const bool ok = t0 + j < k_end && c < p.D;
      cp_async<4 * VEC>(ks + j * QK_LD + c, ok ? p.k + ko + c : p.k, ok);
      cp_async<4 * VEC>(vs + j * V_LD + c, ok ? p.v + vo + c : p.v, ok);
    }
  }
}

template <int DMAX, bool PAGED>
__device__ __forceinline__ void phase1_tf32x3_body(const Params& p) {
  constexpr int QK_LD = Geom<DMAX>::QK_LD, V_LD = Geom<DMAX>::V_LD;
  constexpr int Q_FLOATS = Geom<DMAX>::Q_FLOATS;
  constexpr int K_FLOATS = Geom<DMAX>::K_FLOATS;
  constexpr int V_FLOATS = Geom<DMAX>::V_FLOATS;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + Q_FLOATS;                  // two stages each
  float* Vs = Ks + 2 * K_FLOATS;

  const int g = p.Hq / p.Hkv, R = g * p.Tq;
  const int nslab = (R + BM - 1) / BM;
  const int per = nslab * p.B * p.Hkv;
  const int split = blockIdx.x / per;
  const int bh = blockIdx.x % per / nslab;
  const int r0 = blockIdx.x % per % nslab * BM;      // first stacked row
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int clen = p.cache_len[b];

  // this split's live key range, in logical key index t
  int k_begin, k_end;
  if (PAGED) {
    const int live_pages = clen > 0 ? (clen + p.stride - 1) / p.stride : 0;
    const int pg0 = split * p.nk_inner;
    const int pg1 = min(pg0 + p.nk_inner, live_pages);
    k_begin = pg0 * p.page;
    k_end = max(pg1, pg0) * p.page;
  } else {
    const int span = p.nk_inner * p.bk;
    k_begin = split * span;
    k_end = max(k_begin, min(k_begin + span, min(clen, p.S)));
  }
  const int ntiles = (k_end - k_begin + BK - 1) / BK;

  if (ntiles == 0) {                 // a dead split: the merge weighs it 0
    for (int r = r0 + threadIdx.x / 32; r < min(r0 + BM, R);
         r += NTHREADS / 32) {
      const long long o = out_row(p, b, hk, g, split, r);
      for (int d = threadIdx.x % 32; d < p.D; d += 32) p.acc[o * p.D + d] = 0.f;
      if (threadIdx.x % 32 == 0) {
        p.m[o] = NEG_INF;
        p.l[o] = 0.f;
      }
    }
    return;
  }

  auto load_tile = [&](int it) {
    float* kd = Ks + (it & 1) * K_FLOATS;
    float* vd = Vs + (it & 1) * V_FLOATS;
    const int t0 = k_begin + it * BK;
    if (p.vec == 4) stage_kv<DMAX, PAGED, 4>(p, kd, vd, b, hk, t0, k_end);
    else if (p.vec == 2)
      stage_kv<DMAX, PAGED, 2>(p, kd, vd, b, hk, t0, k_end);
    else stage_kv<DMAX, PAGED, 1>(p, kd, vd, b, hk, t0, k_end);
  };
  if (p.vec == 4) stage_q<DMAX, 4>(p, Qs, b, hk, g, r0, R);
  else if (p.vec == 2) stage_q<DMAX, 2>(p, Qs, b, hk, g, r0, R);
  else stage_q<DMAX, 1>(p, Qs, b, hk, g, r0, R);
  load_tile(0);
  cp_async_commit();                         // group 0: Q and tile 0

  // warp w owns slab rows 16 w + [0, 16); this thread holds rows ra and
  // ra + 8 of them: of S the keys 8 n + 2 tig + {0, 1} of each n-block,
  // of O the columns 32 c + 8 tig + [0, 8) of each 32-column group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ra = 16 * warp + gid;
  const int row_a = r0 + ra, row_b = row_a + 8;
  const bool warp_live = r0 + 16 * warp < R;
  // a row past R attends nothing (qpos -1) and is never written
  const int qa = row_a < R ? p.q_abs[b * p.Tq + row_a % p.Tq] : -1;
  const int qb = row_b < R ? p.q_abs[b * p.Tq + row_b % p.Tq] : -1;
  const int nk16 = (p.D + 15) / 16;
  const bool cap = p.softcap > 0.f;

  float o[DMAX / 32][4][4];
#pragma unroll
  for (int c = 0; c < DMAX / 32; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][j][e] = 0.f;
  // running max (a row with no live key keeps NEG_INF) and this thread's
  // part of the row sum
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();                      // this thread's part of tile it
    __syncthreads();                         // everyone's; stage it-1 free
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    if (!warp_live) continue;

    const int t0 = k_begin + it * BK;
    const float* kt = Ks + (it & 1) * K_FLOATS;
    const float* vt = Vs + (it & 1) * V_FLOATS;

    // ---- S = Q K^T: s gets big*big, sc the two correction products ----
    float s[BK / 8][4], sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sc[n][e] = 0.f;
    const float* qrow = Qs + ra * QK_LD + 4 * tig;
    const float* krow = kt + gid * QK_LD + 4 * tig;
    for (int kk = 0; kk < nk16; ++kk) {
      const float4 xa = *reinterpret_cast<const float4*>(qrow + 16 * kk);
      const float4 xb =
          *reinterpret_cast<const float4*>(qrow + 8 * QK_LD + 16 * kk);
      // A fragments of the two k-steps: (row a, k tig), (row b, k tig),
      // (row a, k tig + 4), (row b, k tig + 4)
      uint32_t ab[2][4], as[2][4];
      split_tf32(xa.x, ab[0][0], as[0][0]);
      split_tf32(xb.x, ab[0][1], as[0][1]);
      split_tf32(xa.y, ab[0][2], as[0][2]);
      split_tf32(xb.y, ab[0][3], as[0][3]);
      split_tf32(xa.z, ab[1][0], as[1][0]);
      split_tf32(xb.z, ab[1][1], as[1][1]);
      split_tf32(xa.w, ab[1][2], as[1][2]);
      split_tf32(xb.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float4 y =
            *reinterpret_cast<const float4*>(krow + 8 * n * QK_LD + 16 * kk);
        uint32_t bb[2][2], bs[2][2];
        split_tf32(y.x, bb[0][0], bs[0][0]);
        split_tf32(y.y, bb[0][1], bs[0][1]);
        split_tf32(y.z, bb[1][0], bs[1][0]);
        split_tf32(y.w, bb[1][1], bs[1][1]);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          mma_tf32(sc[n], as[st], bb[st]);
          mma_tf32(sc[n], ab[st], bs[st]);
          mma_tf32(s[n], ab[st], bb[st]);
        }
      }
    }

    // ---- softcap, then the mask (not needed for a row that sees every
    // key of the tile); running max ----
    int lo = 0, hi = 0;
    const bool span = tile_span<BK, PAGED>(p, t0, k_end, clen, lo, hi);
    const bool whole = span && hi <= min(qa, qb) &&
                       (p.window <= 0 || lo > max(qa, qb) - p.window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = s[n][e] + sc[n][e], xb = s[n][2 + e] + sc[n][2 + e];
        if (cap) {
          xa = p.softcap * tanhf(xa / p.softcap);
          xb = p.softcap * tanhf(xb / p.softcap);
        }
        const int t = t0 + 8 * n + 2 * tig + e;
        if (!whole && t >= k_end) {          // not part of this split
          xa = -INFINITY;
          xb = -INFINITY;
        } else if (!whole) {
          int kpos;
          const bool live = key_live<PAGED>(p, t, clen, kpos);
          if (!(live && kpos <= qa && (p.window <= 0 || kpos > qa - p.window)))
            xa = NEG_INF;
          if (!(live && kpos <= qb && (p.window <= 0 || kpos > qb - p.window)))
            xb = NEG_INF;
        }
        s[n][e] = xa;
        s[n][2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }

    // ---- online softmax over the quad's row ----
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - mn_a);
        s[n][2 + e] = expf(s[n][2 + e] - mn_b);
        sum_a += s[n][e];
        sum_b += s[n][2 + e];
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[c][j][0] *= al_a;
        o[c][j][1] *= al_a;
        o[c][j][2] *= al_b;
        o[c][j][3] *= al_b;
      }

    // ---- O += P V: P's k-step n is S's n-block (key 2 tig at k tig, key
    // 2 tig + 1 at k tig + 4); n-block j of column group c holds the
    // columns 32 c + 4 n + j. The mma units add with truncation, which
    // over a long split's tiles biased o toward zero (4.9e-4 of the
    // partials at 128 tiles a split): each tile's products go to a fresh
    // accumulator t, added to o in fp32 (round to nearest), as
    // flash_attention.cu's mma_pb does ----
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) {
      if (32 * c >= p.D) break;
      float t[4][4] = {};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t pb[4], ps[4];
        split_tf32(s[n][0], pb[0], ps[0]);
        split_tf32(s[n][2], pb[1], ps[1]);
        split_tf32(s[n][1], pb[2], ps[2]);
        split_tf32(s[n][3], pb[3], ps[3]);
        const float* v0 = vt + (8 * n + 2 * tig) * V_LD + 4 * gid + 32 * c;
        const float4 y0 = *reinterpret_cast<const float4*>(v0);
        const float4 y1 = *reinterpret_cast<const float4*>(v0 + V_LD);
        const float e0[4] = {y0.x, y0.y, y0.z, y0.w};
        const float e1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[2], bs[2];
          split_tf32(e0[j], bb[0], bs[0]);
          split_tf32(e1[j], bb[1], bs[1]);
          mma_tf32(t[j], ps, bb);
          mma_tf32(t[j], pb, bs);
          mma_tf32(t[j], pb, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][j][e] += t[j][e];
    }
  }

  if (!warp_live) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? row_b : row_a;
    if (r >= R) continue;
    const long long orow = out_row(p, b, hk, g, split, r);
    float* A = p.acc + orow * p.D;
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) {
      const int d0 = 32 * c + 8 * tig;
      const float x[8] = {o[c][0][2 * half], o[c][1][2 * half],
                          o[c][2][2 * half], o[c][3][2 * half],
                          o[c][0][2 * half + 1], o[c][1][2 * half + 1],
                          o[c][2][2 * half + 1], o[c][3][2 * half + 1]};
      if (p.D % 4 == 0) {
        if (d0 < p.D)
          *reinterpret_cast<float4*>(A + d0) =
              make_float4(x[0], x[1], x[2], x[3]);
        if (d0 + 4 < p.D)
          *reinterpret_cast<float4*>(A + d0 + 4) =
              make_float4(x[4], x[5], x[6], x[7]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (d0 + i < p.D) A[d0 + i] = x[i];
      }
    }
    if (tig == 0) {
      p.m[orow] = half ? m_b : m_a;
      p.l[orow] = half ? l_b : l_a;
    }
  }
}

// Head dims up to 128: two blocks an SM (107.5 KB of shared memory, at
// most 255 / 2 registers a thread each).
template <bool PAGED>
__global__ void __launch_bounds__(NTHREADS, 2)
phase1_tf32x3_kernel(const Params p) {
  phase1_tf32x3_body<128, PAGED>(p);
}

// Head dims 129 to 256: the same tiles at twice the width, one block an
// SM (201 KB of shared memory; a thread holds 128 O accumulators).
template <bool PAGED>
__global__ void __launch_bounds__(NTHREADS, 1)
phase1_tf32x3_kernel_d256(const Params p) {
  phase1_tf32x3_body<256, PAGED>(p);
}

// The widest copy (in floats) that every row start allows: the bases 4 *
// vec-byte aligned, and D and every stride of an axis longer than one a
// multiple of vec (q is contiguous, its rows D apart).
int copy_width(const Params& p, int n0, int n2) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p.q) |
                          reinterpret_cast<uintptr_t>(p.k) |
                          reinterpret_cast<uintptr_t>(p.v);
  long long strides = p.D;
  const long long sizes[3] = {n0, p.Hkv, n2};
  const long long ks[3] = {p.ks0, p.ks1, p.ks2};
  const long long vs[3] = {p.vs0, p.vs1, p.vs2};
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1) strides |= ks[i] | vs[i];
  for (int w = 4; w > 1; w /= 2)
    if (bases % (4 * w) == 0 && strides % w == 0) return w;
  return 1;
}

template <bool PAGED>
int launch(Params& p, int n0, int n2, cudaStream_t st) {
  if (p.D > 256 || p.D < 1 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || p.B < 1 ||
      p.Tq < 1 || p.ns < 1 || p.nk_inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec = copy_width(p, n0, n2);
  const int g = p.Hq / p.Hkv;
  const long long nblocks = static_cast<long long>((g * p.Tq + BM - 1) / BM) *
                            p.B * p.Hkv * p.ns;
  if (nblocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = p.D > 128;
  auto kern = wide ? phase1_tf32x3_kernel_d256<PAGED>
                   : phase1_tf32x3_kernel<PAGED>;
  const int smem = wide ? Geom<256>::SMEM_BYTES : Geom<128>::SMEM_BYTES;
  // the largest shared-memory carveout (two blocks an SM at D <= 128)
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(nblocks), NTHREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cascade_phase1_dense(
    const float* q, const float* k, const float* v,
    long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2,
    const int* cache_len, const int* q_abs,
    float* acc, float* m, float* l,
    int B, int Hq, int Hkv, int Tq, int D,
    int S, int bk, int nk_inner, int ns,
    int rolling, int window, float softcap, void* stream) {
  if (S < 1 || bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q; p.k = k; p.v = v;
  p.ks0 = ks0; p.ks1 = ks1; p.ks2 = ks2;
  p.vs0 = vs0; p.vs1 = vs1; p.vs2 = vs2;
  p.table = nullptr; p.cache_len = cache_len; p.q_abs = q_abs;
  p.acc = acc; p.m = m; p.l = l;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.D = D;
  p.ns = ns; p.nk_inner = nk_inner;
  p.S = S; p.bk = bk; p.rolling = rolling;
  p.window = window; p.softcap = softcap;
  return launch<false>(p, B, S, static_cast<cudaStream_t>(stream));
}

int cascade_phase1_paged(
    const float* q, const float* k, const float* v,
    long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2,
    const int* table, const int* cache_len, const int* q_abs,
    float* acc, float* m, float* l,
    int B, int Hq, int Hkv, int Tq, int D,
    int page, int mp, int n_phys, int nk_inner, int ns,
    int stride, int off, int window, float softcap, void* stream) {
  if (page < 1 || mp < 1 || n_phys < 1 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q; p.k = k; p.v = v;
  p.ks0 = ks0; p.ks1 = ks1; p.ks2 = ks2;
  p.vs0 = vs0; p.vs1 = vs1; p.vs2 = vs2;
  p.table = table; p.cache_len = cache_len; p.q_abs = q_abs;
  p.acc = acc; p.m = m; p.l = l;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.D = D;
  p.ns = ns; p.nk_inner = nk_inner;
  p.page = page; p.mp = mp; p.n_phys = n_phys; p.stride = stride; p.off = off;
  p.window = window; p.softcap = softcap;
  return launch<true>(p, n_phys, page, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
