// Flash attention forward and backward in float32 for Hopper (sm_90a), on
// the tensor cores in 3xTF32.
//
// Replaces, for float32 inputs, the three Pallas TPU kernels of
// repro/kernels/flash_attention.py:
//   * _fwd_kernel      -> flash_fwd       (o [B,Hq,Tq,D], lse [B,Hq,Tq])
//   * _bwd_dq_kernel   -> flash_bwd_dq    (dq)
//   * _bwd_dkv_kernel  -> flash_bwd_dkv   (dk, dv, summed over the GQA
//                                          group inside the block)
// with GQA (Hq % Hkv == 0), causal masking with a scalar q_offset (query i
// sits at i + q_offset, key j at j), a sliding window (key live if
// kpos > qpos - window), a per-row kv_len [B], and the gemma-style softcap
// applied BEFORE the mask, as _mask_block does.
// bfloat16 inputs run all three on the tensor cores with wgmma instead, in
// flash_attention_sm90.cu; these entry points refuse them.
//
// What bounds them on an H100: operations. At the training shape (T 4096,
// D 128, causal) a (b, q-head) pair does T^2/2 * D * 4 FLOPs forward on
// 2*T*D*4 input bytes: thousands of FLOPs per byte, far above the card's
// ridge. Key tiles (forward, dq) and query tiles (dk/dv) that lie wholly
// past the causal edge, before the window or past kv_len are skipped, so
// causal attention costs half of the full square.
//
// Every product runs on the tensor cores as mma.sync m16n8k8 tf32 in
// 3xTF32, as cascade_phase1.cu does (split_tf32 and mma_tf32 in
// sm90_common.cuh): each operand x is split as its fragment loads into big
// (x plus half a tf32 ulp, read truncated by the unit: x rounded to
// nearest) and small (x - big, exact in fp32, read truncated), and
// small*big + big*small + big*big go into fp32 accumulators. Each product
// stays within 2^-21 of its fp32 value, so the fp32 training identity
// holds (tests/test_torch_flash.py emulates the budget; one tf32 product
// in place of three would not keep it). The mma units add into their
// accumulator with truncation, not rounding: summed over the thousands of
// tiles of a long row (o, dq) or key (dk, dv) that bias took dk past the
// fp32 gate at T 4096, so each tile's products go to a fresh accumulator
// that is added to the running sum in fp32 (mma_pb).
//   * forward: one block per (64 query rows, q head, batch row), the
//     longest tiles first; four warps of 16 rows. Q*scale is staged once;
//     32-key K/V tiles come through a two-stage cp.async ring, so the next
//     tile loads while this one is multiplied. Each warp forms S =
//     (Q*scale) K^T over D, the softcap and (on edge tiles) the mask, then
//     the online softmax in its registers: a thread holds rows gid and
//     gid + 8, the row max and sum are taken over its quad of lanes, and
//     the 16 x 128 o accumulator (64 registers a thread) is rescaled once
//     a tile. Then O += P V with the S accumulator as the A fragment as it
//     stands (mma_pb). o = acc / l and lse = m + log l at the end; two
//     blocks an SM (99 KB of shared memory each).
//   * dq: one block per (64 query rows, q head, batch row), the longest
//     tiles first; four warps of 16 rows. Q*scale and dO are staged once;
//     16-key K/V tiles come through a two-stage cp.async ring. Each warp
//     forms S = (Q*scale) K^T and dP = dO V^T over D, then dS = P (dP -
//     delta) dcap in the accumulators, then dQ += dS K over the keys with
//     the dS accumulator as the A fragment as it stands: its keys 2 tig
//     and 2 tig + 1 are the k indices tig and tig + 4, and K is read at
//     those keys. The 16 x 128 dq accumulator takes 64 registers a thread;
//     two blocks an SM (99 KB of shared memory each).
//   * dk/dv: one block per (32 keys, KV head, batch row), the longest
//     first; K and V staged once, then a loop over the GQA group's q heads
//     and their 16-row query tiles (Q*scale, dO, lse and delta in the
//     two-stage ring). Each 16 keys belong to a pair of warps: one forms
//     S^T = K (Q*scale)^T, P and dV += P^T dO; it hands P and dcap to its
//     partner through shared memory (a named barrier of the two warps),
//     which forms dP^T = V dO^T, dS^T and dK += dS^T (Q*scale). So each
//     warp holds one 16 x 128 accumulator (dk and dv in one warp would
//     take 128 registers and spill); three blocks an SM (168 registers,
//     70 KB of shared memory each). The group is summed in registers and
//     written once: no atomics (a training step is deterministic) and no
//     per-q-head [B,Hq,Tkv,D] buffer; key tiles that no query sees are
//     written as zeros.
//   * all three: rows lie DP + 4 floats apart (132 for D 128, 68 for
//     D <= 64), so the float4 fragment reads of both product orders are
//     free of bank conflicts: over D (rows gid, columns 32 kk + 8 tig +
//     4 h) and over keys or queries (rows 2 tig, columns 32 c + 4 gid).
//     Copies are 16 bytes where the bases, D and every stepped stride
//     allow, else 8 or 4; rows past T and columns past D arrive as zeros.
//     A warp skips a tile in which none of its pairs is live, and the mask
//     where all are. The two correction products of S and dP go to
//     accumulators of their own, so the dependent mma chains are half as
//     long. Each block owns its outputs: every kernel is deterministic.
//
// A TPU grid carries the running softmax across sequential kv steps in
// scratch; here each block loops over its own key (or query) tiles.
// Inputs are read through element strides with a contiguous head-dim axis,
// so the model's [B,T,H,D] tensors come in as transposed views, and the
// outputs are written through strides the same way.
//
// Masked keys contribute p = 0 exactly (the Pallas forward counts a masked
// key as exp(-1e30 - (-1e30)) = 1 while no live key has been seen). Rows
// with at least one live key agree; a row with none returns o = 0 and
// lse = -1e30 + log(1e-30) here. The Pallas wrapper pads T to block
// multiples and gives padded rows lse = 1.0; these kernels loop to Tq and
// Tkv exactly and have no padded rows, so they need no such value.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

struct Params {
  const void* q; const void* k; const void* v; const void* dout;
  int64_t qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2, ds0, ds1, ds2;
  const float* lse_in;     // [B,Hq,Tq] contiguous (backward)
  const float* delta;      // [B,Hq,Tq] contiguous (backward)
  const int* kv_len;       // [B]
  void* o;                 // forward: o; dq kernel: dq; dkv kernel: dk
  int64_t os0, os1, os2;
  void* o2;                // dkv kernel: dv
  int64_t o2s0, o2s1, o2s2;
  float* lse_out;          // forward: [B,Hq,Tq]
  int B, Hq, Hkv, Tq, Tkv, D;
  int causal, q_offset, window;   // window <= 0: none
  float softcap, scale;           // softcap <= 0: none
  int vec;                 // floats per cp.async copy (4, 2, 1)
};

__device__ __forceinline__ bool live_key(const Params& p, int qpos, int kpos,
                                         int kvl) {
  bool ok = kpos < kvl;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Key range [kbeg, kend) a query tile [q0, q0 + nq) can see, kbeg on a
// multiple of the key tile.
template <int TILE>
__device__ __forceinline__ void key_range(const Params& p, int q0, int nq,
                                          int kvl, int& kbeg, int& kend) {
  const int qmin = q0 + p.q_offset, qmax = q0 + nq - 1 + p.q_offset;
  kend = kvl;
  if (p.causal) kend = min(kend, qmax + 1);
  kbeg = 0;
  if (p.window > 0) kbeg = max(0, qmin - p.window + 1);
  kbeg = (kbeg / TILE) * TILE;
}

// ------------------------------------------------ 3xTF32 helpers ---
constexpr int THREADS = 128;     // four warps
constexpr int Q_ROWS = 64;       // forward, dq: query rows a block, 16 a warp
constexpr int FWD_KEYS = 32;     // forward: keys a tile
constexpr int KV_ROWS = 32;      // dk/dv: keys a block, 16 a pair of warps
constexpr int BW_TILE = 16;      // keys (dq) or queries (dk/dv) a tile

// threadIdx.x, read anew where it is used: the staging loops' offsets,
// derived from it, would otherwise be hoisted out of the tile loops and
// held in registers (or spilled) for the whole kernel.
__device__ __forceinline__ int tid_fresh() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Rows [row0, row0 + R) of a [T, D] slice (row stride rs) into an
// [R][DP + 4] tile by cp.async, VEC floats a copy; rows >= T and columns
// >= D arrive as zeros.
template <int R, int DP, int VEC>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int64_t rs, int row0, int T_,
                                            int D) {
  constexpr int LD = DP + 4, CPR = DP / VEC;
#pragma unroll 4
  for (int i = tid_fresh(); i < R * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR * VEC;
    const bool ok = row0 + r < T_ && c < D;
    cp_async<4 * VEC>(dst + r * LD + c, ok ? src + (row0 + r) * rs + c : src,
                      ok);
  }
}

// Multiplies by mul what stage_async<R, DP, VEC> copied in this thread,
// once the copies have landed.
template <int R, int DP, int VEC>
__device__ __forceinline__ void scale_own(float* dst, float mul) {
  constexpr int LD = DP + 4, CPR = DP / VEC;
#pragma unroll 4
  for (int i = tid_fresh(); i < R * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR * VEC;
#pragma unroll
    for (int u = 0; u < VEC; ++u) dst[r * LD + c + u] *= mul;
  }
}

// stage_async and scale_own, p.vec floats a copy
template <int R, int DP>
__device__ __forceinline__ void stage_rows(const Params& p, float* dst,
                                           const float* src, int64_t rs,
                                           int row0, int T_) {
  if (p.vec == 4) stage_async<R, DP, 4>(dst, src, rs, row0, T_, p.D);
  else if (p.vec == 2) stage_async<R, DP, 2>(dst, src, rs, row0, T_, p.D);
  else stage_async<R, DP, 1>(dst, src, rs, row0, T_, p.D);
}

template <int R, int DP>
__device__ __forceinline__ void scale_rows(const Params& p, float* dst) {
  if (p.vec == 4) scale_own<R, DP, 4>(dst, p.scale);
  else if (p.vec == 2) scale_own<R, DP, 2>(dst, p.scale);
  else scale_own<R, DP, 1>(dst, p.scale);
}

// c[n] (+ cc[n]) += A[16 x DP] B[8 NB x DP]^T for the 8-row blocks n < NB
// of B, in 3xTF32: big*big into c, the two correction products into cc.
// a points at A + gid * LD + 8 tig (this thread's rows gid and gid + 8),
// b at B + gid * LD + 8 tig. A k-step pair reads a float4 of each row: k
// index tig of k-step 2 h + s is column 32 kk + 8 tig + 4 h + 2 s, k index
// tig + 4 the column after it (a permutation of D that A and B share).
template <int DP, int NB>
__device__ __forceinline__ void mma_abt(float (&c)[NB][4], float (&cc)[NB][4],
                                        const float* a, const float* b) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int kk = 0; kk < DP / 32; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 32 * kk + 4 * h;
      const float4 xa = *reinterpret_cast<const float4*>(a + d);
      const float4 xb = *reinterpret_cast<const float4*>(a + 8 * LD + d);
      // A fragments of the two k-steps: (row gid, k tig), (row gid + 8,
      // k tig), (row gid, k tig + 4), (row gid + 8, k tig + 4)
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
      for (int n = 0; n < NB; ++n) {
        const float4 y = *reinterpret_cast<const float4*>(b + 8 * n * LD + d);
        uint32_t bb[2][2], bs[2][2];
        split_tf32(y.x, bb[0][0], bs[0][0]);
        split_tf32(y.y, bb[0][1], bs[0][1]);
        split_tf32(y.z, bb[1][0], bs[1][0]);
        split_tf32(y.w, bb[1][1], bs[1][1]);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma_tf32(cc[n], as[s], bb[s]);
          mma_tf32(cc[n], ab[s], bs[s]);
          mma_tf32(c[n], ab[s], bb[s]);
        }
      }
    }
  }
}

// acc += P[16 x 8 NB] B[8 NB x DP] in 3xTF32, P in mma_abt's accumulator
// layout: its k-step n is the 8-column block n, whose columns 2 tig and
// 2 tig + 1 are the k indices tig and tig + 4, so B is read at those rows.
// b points at B + 2 tig * LD + 4 gid. n-block j of the 32-column group c
// holds the columns 32 c + 4 gid + j, so a thread reads float4s of B and
// holds the columns 32 c + 8 tig + [0, 8) of acc. The tile's products go
// to a fresh accumulator, added to acc in fp32 (round to nearest): the
// mma units add into their accumulator with truncation, a bias that
// would grow with the thousands of tiles a long row or key sums.
template <int DP, int NB>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 32][4][4],
                                       float (&pm)[NB][4], const float* b) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int c = 0; c < DP / 32; ++c) {
    float t[4][4] = {};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint32_t pb[4], ps[4];
      split_tf32(pm[n][0], pb[0], ps[0]);
      split_tf32(pm[n][2], pb[1], ps[1]);
      split_tf32(pm[n][1], pb[2], ps[2]);
      split_tf32(pm[n][3], pb[3], ps[3]);
      const float* b0 = b + 8 * n * LD + 32 * c;
      const float4 y0 = *reinterpret_cast<const float4*>(b0);
      const float4 y1 = *reinterpret_cast<const float4*>(b0 + LD);
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
      for (int e = 0; e < 4; ++e) acc[c][j][e] += t[j][e];
  }
}

// This thread's row gid (half 0) or gid + 8 (half 1) of an acc that mma_pb
// filled: its columns 32 c + 8 tig + [0, 8) below D, times mul, to out.
template <int DP>
__device__ __forceinline__ void store_row(float* out,
                                          float (&acc)[DP / 32][4][4],
                                          int half, int tig, int D,
                                          float mul) {
#pragma unroll
  for (int c = 0; c < DP / 32; ++c) {
    const int d0 = 32 * c + 8 * tig;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (d0 + j < D) out[d0 + j] = acc[c][j][2 * half] * mul;
      if (d0 + 4 + j < D) out[d0 + 4 + j] = acc[c][j][2 * half + 1] * mul;
    }
  }
}

// The softcap (x = cap tanh(x / cap), dcap = 1 - tanh^2) of a score.
__device__ __forceinline__ float capped(const Params& p, float x,
                                        float& dcap) {
  dcap = 1.f;
  if (p.softcap <= 0.f) return x;
  const float t = tanhf(x / p.softcap);
  dcap = 1.f - t * t;
  return p.softcap * t;
}

// ------------------------------------------------------------- forward ---
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const Params p) {
  constexpr int LD = DP + 4, KV_TILE = FWD_KEYS * LD, NB = FWD_KEYS / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // Q * scale [64][LD]
  float* Ks = Qs + Q_ROWS * LD;                  // two stages each
  float* Vs = Ks + 2 * KV_TILE;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * Q_ROWS;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(Q_ROWS, p.Tq - q0);
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  const float* Q = static_cast<const float*>(p.q) + b * p.qs0 + h * p.qs1;
  const float* K = static_cast<const float*>(p.k) + b * p.ks0 + hk * p.ks1;
  const float* V = static_cast<const float*>(p.v) + b * p.vs0 + hk * p.vs1;
  int kbeg, kend;
  key_range<FWD_KEYS>(p, q0, nq, kvl, kbeg, kend);
  const int ntiles =
      kend > kbeg ? (kend - kbeg + FWD_KEYS - 1) / FWD_KEYS : 0;

  auto load_kv = [&](int it) {
    const int k0 = kbeg + it * FWD_KEYS;
    stage_rows<FWD_KEYS, DP>(p, Ks + (it & 1) * KV_TILE, K, p.ks2, k0, p.Tkv);
    stage_rows<FWD_KEYS, DP>(p, Vs + (it & 1) * KV_TILE, V, p.vs2, k0, p.Tkv);
  };
  if (ntiles > 0) {
    stage_rows<Q_ROWS, DP>(p, Qs, Q, p.qs2, q0, p.Tq);
    load_kv(0);
    cp_async_commit();                     // group 0: Q and tile 0
  }

  // warp w owns rows 16 w + [0, 16) of the tile; this thread rows ra, rb
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ra = 16 * warp + gid, rb = ra + 8;
  const int qa = q0 + ra + p.q_offset, qb = qa + 8;
  const int wrows = min(16, nq - 16 * warp);   // the warp's rows, positions
  const int qlo = q0 + 16 * warp + p.q_offset, qhi = qlo + wrows - 1;

  float acc[DP / 32][4][4];
#pragma unroll
  for (int c = 0; c < DP / 32; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  // the running max of rows ra and rb (NEG_INF until a live key) and this
  // thread's part of their sums
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();                    // this thread's part of tile it
    if (it == 0) scale_rows<Q_ROWS, DP>(p, Qs);
    __syncthreads();                       // everyone's; stage it-1 free
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();

    // skip a tile in which no pair of the warp is live; no mask where all
    const int k0 = kbeg + it * FWD_KEYS;
    const int k1 = min(k0 + FWD_KEYS, kvl) - 1;
    if (wrows <= 0 || k1 < k0 || (p.causal && k0 > qhi) ||
        (p.window > 0 && k1 <= qlo - p.window))
      continue;
    const bool whole = wrows == 16 && k0 + FWD_KEYS <= kvl &&
                       (!p.causal || k0 + FWD_KEYS - 1 <= qlo) &&
                       (p.window <= 0 || k0 > qhi - p.window);
    const float* kt = Ks + (it & 1) * KV_TILE;
    const float* vt = Vs + (it & 1) * KV_TILE;

    float s[NB][4] = {}, sc[NB][4] = {};
    mma_abt<DP>(s, sc, Qs + ra * LD + 8 * tig, kt + gid * LD + 8 * tig);

    // the softcap, then the mask (masked: -inf, so p = 0 exactly), in s:
    // element e of n-block n is row (e < 2 ? ra : rb), key
    // k0 + 8 n + 2 tig + e % 2
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float dcap;
        const float x = capped(p, s[n][e] + sc[n][e], dcap);
        const bool ok = whole || ((lo ? ra : rb) < nq &&
                                  live_key(p, lo ? qa : qb,
                                           k0 + 8 * n + 2 * tig + e % 2, kvl));
        s[n][e] = ok ? x : -INFINITY;
        if (lo) mx_a = fmaxf(mx_a, s[n][e]);
        else mx_b = fmaxf(mx_b, s[n][e]);
      }

    // the online softmax over the quad's rows: P in s, acc rescaled
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - mn_a);
        s[n][2 + e] = expf(s[n][2 + e] - mn_b);
        sum_a += s[n][e];
        sum_b += s[n][2 + e];
      }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[c][j][0] *= al_a;
        acc[c][j][1] *= al_a;
        acc[c][j][2] *= al_b;
        acc[c][j][3] *= al_b;
      }
    mma_pb<DP>(acc, s, vt + 2 * tig * LD + 4 * gid);     // O += P V
  }

  // o = acc / l (0 for a row with no live key) and lse = m + log l
  const float ls_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float ls_b = fmaxf(quad_sum(l_b), 1e-30f);
  float* O = static_cast<float*>(p.o) + b * p.os0 + h * p.os1;
  float* lse = p.lse_out + ((int64_t)b * p.Hq + h) * p.Tq + q0;
  if (ra < nq) {
    store_row<DP>(O + (q0 + ra) * p.os2, acc, 0, tig, p.D, 1.f / ls_a);
    if (tig == 0) lse[ra] = m_a + logf(ls_a);
  }
  if (rb < nq) {
    store_row<DP>(O + (q0 + rb) * p.os2, acc, 1, tig, p.D, 1.f / ls_b);
    if (tig == 0) lse[rb] = m_b + logf(ls_b);
  }
}

// ---------------------------------------------------------- backward dq ---
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DP + 4, KV_TILE = BW_TILE * LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // Q * scale [64][LD]
  float* dOs = Qs + Q_ROWS * LD;
  float* Ks = dOs + Q_ROWS * LD;                // two stages each
  float* Vs = Ks + 2 * KV_TILE;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * Q_ROWS;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(Q_ROWS, p.Tq - q0);
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  const float* Q = static_cast<const float*>(p.q) + b * p.qs0 + h * p.qs1;
  const float* dO = static_cast<const float*>(p.dout) + b * p.ds0 + h * p.ds1;
  const float* K = static_cast<const float*>(p.k) + b * p.ks0 + hk * p.ks1;
  const float* V = static_cast<const float*>(p.v) + b * p.vs0 + hk * p.vs1;
  int kbeg, kend;
  key_range<BW_TILE>(p, q0, nq, kvl, kbeg, kend);
  const int ntiles = kend > kbeg ? (kend - kbeg + BW_TILE - 1) / BW_TILE : 0;

  auto load_kv = [&](int it) {
    const int k0 = kbeg + it * BW_TILE;
    stage_rows<BW_TILE, DP>(p, Ks + (it & 1) * KV_TILE, K, p.ks2, k0, p.Tkv);
    stage_rows<BW_TILE, DP>(p, Vs + (it & 1) * KV_TILE, V, p.vs2, k0, p.Tkv);
  };
  if (ntiles > 0) {
    stage_rows<Q_ROWS, DP>(p, Qs, Q, p.qs2, q0, p.Tq);
    stage_rows<Q_ROWS, DP>(p, dOs, dO, p.ds2, q0, p.Tq);
    load_kv(0);
    cp_async_commit();                     // group 0: Q, dO and tile 0
  }

  // warp w owns rows 16 w + [0, 16) of the tile; this thread rows ra, rb
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ra = 16 * warp + gid, rb = ra + 8;
  const int64_t rbase = ((int64_t)b * p.Hq + h) * p.Tq + q0;
  const float lse_a = ra < nq ? p.lse_in[rbase + ra] : 0.f;
  const float lse_b = rb < nq ? p.lse_in[rbase + rb] : 0.f;
  const float dl_a = ra < nq ? p.delta[rbase + ra] : 0.f;
  const float dl_b = rb < nq ? p.delta[rbase + rb] : 0.f;
  const int qa = q0 + ra + p.q_offset, qb = qa + 8;
  const int wrows = min(16, nq - 16 * warp);   // the warp's rows, positions
  const int qlo = q0 + 16 * warp + p.q_offset, qhi = qlo + wrows - 1;

  float dq[DP / 32][4][4];
#pragma unroll
  for (int c = 0; c < DP / 32; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[c][j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();                    // this thread's part of tile it
    if (it == 0) scale_rows<Q_ROWS, DP>(p, Qs);
    __syncthreads();                       // everyone's; stage it-1 free
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();

    // skip a tile in which no pair of the warp is live; no mask where all
    const int k0 = kbeg + it * BW_TILE;
    const int k1 = min(k0 + BW_TILE, kvl) - 1;
    if (wrows <= 0 || k1 < k0 || (p.causal && k0 > qhi) ||
        (p.window > 0 && k1 <= qlo - p.window))
      continue;
    const bool whole = wrows == 16 && k0 + BW_TILE <= kvl &&
                       (!p.causal || k0 + BW_TILE - 1 <= qlo) &&
                       (p.window <= 0 || k0 > qhi - p.window);
    const float* kt = Ks + (it & 1) * KV_TILE;
    const float* vt = Vs + (it & 1) * KV_TILE;

    float s[2][4] = {}, sc[2][4] = {}, dp[2][4] = {}, dpc[2][4] = {};
    mma_abt<DP>(s, sc, Qs + ra * LD + 8 * tig, kt + gid * LD + 8 * tig);
    mma_abt<DP>(dp, dpc, dOs + ra * LD + 8 * tig, vt + gid * LD + 8 * tig);

    // dS = P (dP - delta) dcap, in s: element e of n-block n is row
    // (e < 2 ? ra : rb), key k0 + 8 n + 2 tig + e % 2
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float dcap;
        const float x = capped(p, s[n][e] + sc[n][e], dcap);
        const bool ok = whole || ((lo ? ra : rb) < nq &&
                                  live_key(p, lo ? qa : qb,
                                           k0 + 8 * n + 2 * tig + e % 2, kvl));
        const float pr = ok ? expf(x - (lo ? lse_a : lse_b)) : 0.f;
        s[n][e] = pr * (dp[n][e] + dpc[n][e] - (lo ? dl_a : dl_b)) * dcap;
      }
    mma_pb<DP>(dq, s, kt + 2 * tig * LD + 4 * gid);
  }

  float* dQ = static_cast<float*>(p.o) + b * p.os0 + h * p.os1;
  if (ra < nq) store_row<DP>(dQ + (q0 + ra) * p.os2, dq, 0, tig, p.D, p.scale);
  if (rb < nq) store_row<DP>(dQ + (q0 + rb) * p.os2, dq, 1, tig, p.D, p.scale);
}

// --------------------------------------------------------- backward dkv ---
// named barrier id (1-15; 0 is __syncthreads) for n threads
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = DP + 4, Q_TILE = BW_TILE * LD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [32][LD]
  float* Vs = Ks + KV_ROWS * LD;
  float* Qs = Vs + KV_ROWS * LD;                 // Q * scale, two stages
  float* dOs = Qs + 2 * Q_TILE;                  // two stages
  float* rows_s = dOs + 2 * Q_TILE;              // lse, delta: two stages
  // P and dcap from the dV warp of each pair to its dK warp: [2][4][32]
  // float4s, lane-minor (conflict-free)
  float4* xbuf = reinterpret_cast<float4*>(rows_s + 4 * BW_TILE);

  const int k0 = blockIdx.x * KV_ROWS;           // the longest (causal) first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  const float* K = static_cast<const float*>(p.k) + b * p.ks0 + hk * p.ks1;
  const float* V = static_cast<const float*>(p.v) + b * p.vs0 + hk * p.vs1;

  // query rows [ibeg, iend) that can see a key of this tile, in 16-row
  // tiles; the block loops over them for each q head of the group
  const int kmax = min(k0 + KV_ROWS, kvl) - 1;
  int ibeg = 0, iend = p.Tq;
  if (p.causal) ibeg = max(0, k0 - p.q_offset);
  if (p.window > 0) iend = min(iend, kmax - p.q_offset + p.window);
  if (kmax < k0) iend = ibeg;                    // no live key in the tile
  const int qt_beg = ibeg / BW_TILE;
  const int nqt = iend > ibeg ? (iend + BW_TILE - 1) / BW_TILE - qt_beg : 0;
  const int n_it = g * nqt;

  auto load_q = [&](int it) {
    const int h = hk * g + it / nqt, q0 = (qt_beg + it % nqt) * BW_TILE;
    const float* Q = static_cast<const float*>(p.q) + b * p.qs0 + h * p.qs1;
    const float* dO =
        static_cast<const float*>(p.dout) + b * p.ds0 + h * p.ds1;
    stage_rows<BW_TILE, DP>(p, Qs + (it & 1) * Q_TILE, Q, p.qs2, q0, p.Tq);
    stage_rows<BW_TILE, DP>(p, dOs + (it & 1) * Q_TILE, dO, p.ds2, q0, p.Tq);
    const int t = threadIdx.x, i = t % BW_TILE;
    if (t < 2 * BW_TILE) {
      const bool ok = q0 + i < p.Tq;
      const float* src = (t < BW_TILE ? p.lse_in : p.delta) +
                         ((int64_t)b * p.Hq + h) * p.Tq + (ok ? q0 + i : 0);
      cp_async<4>(rows_s + (it & 1) * 2 * BW_TILE + t, src, ok);
    }
  };
  if (n_it > 0) {
    stage_rows<KV_ROWS, DP>(p, Ks, K, p.ks2, k0, p.Tkv);
    stage_rows<KV_ROWS, DP>(p, Vs, V, p.vs2, k0, p.Tkv);
    load_q(0);
    cp_async_commit();                     // group 0: K, V and tile 0
  }

  // warps w and w + 2 (w = 0, 1) own keys 16 w + [0, 16) of the block:
  // warp w forms S^T, P and dV, warp w + 2 dP^T, dS and dK, each holding
  // its 16 x 128 accumulator (64 registers); this thread keys ka, kb
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kg = warp % 2;
  const bool dk_warp = warp >= 2;
  const int ka = 16 * kg + gid, kb = ka + 8;
  const int kw0 = k0 + 16 * kg;                  // the pair's keys
  const int kw1 = min(kw0 + 16, kvl) - 1;        // its last that can be live
  float4* xw = xbuf + kg * 4 * 32 + lane;        // this lane's 4 float4s

  float acc[DP / 32][4][4];                      // dV or dK
#pragma unroll
  for (int c = 0; c < DP / 32; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();                    // this thread's part of tile it
    scale_rows<BW_TILE, DP>(p, Qs + (it & 1) * Q_TILE);
    __syncthreads();                       // everyone's; stage it-1 free
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();

    // skip a tile in which no pair of the keys is live (both warps of the
    // pair alike); no mask where all are
    const int q0 = (qt_beg + it % nqt) * BW_TILE;
    const int qn = min(BW_TILE, p.Tq - q0);
    const int qlo = q0 + p.q_offset, qhi = qlo + qn - 1;
    if (kw1 < kw0 || (p.causal && kw0 > qhi) ||
        (p.window > 0 && kw1 <= qlo - p.window))
      continue;
    const float* qt = Qs + (it & 1) * Q_TILE;
    const float* ot = dOs + (it & 1) * Q_TILE;
    float s[2][4] = {}, sc[2][4] = {};
    if (!dk_warp) {
      const bool whole = qn == BW_TILE && kw0 + 16 <= kvl &&
                         (!p.causal || kw0 + 15 <= qlo) &&
                         (p.window <= 0 || kw0 > qhi - p.window);
      const float* lse = rows_s + (it & 1) * 2 * BW_TILE;
      // S^T: rows the pair's keys, columns the tile's queries; then P^T
      // in s (element e of n-block n: key (e < 2 ? ka : kb), query
      // q0 + 8 n + 2 tig + e % 2) and dcap in sc, for the partner too
      mma_abt<DP>(s, sc, Ks + ka * LD + 8 * tig, qt + gid * LD + 8 * tig);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * n + 2 * tig + e % 2;
          const float x = capped(p, s[n][e] + sc[n][e], sc[n][e]);
          const bool ok = whole || (q0 + i < p.Tq &&
                                    live_key(p, qlo + i,
                                             k0 + (e < 2 ? ka : kb), kvl));
          s[n][e] = ok ? expf(x - lse[i]) : 0.f;
        }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        xw[32 * n] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        xw[32 * (n + 2)] = make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
      }
      bar_arrive(1 + kg, 64);
      mma_pb<DP>(acc, s, ot + 2 * tig * LD + 4 * gid);     // dV += P^T dO
    } else {
      const float* dlt = rows_s + (it & 1) * 2 * BW_TILE + BW_TILE;
      // dP^T, then (once the partner's P and dcap are in) dS^T =
      // P (dP - delta) dcap in s
      mma_abt<DP>(s, sc, Vs + ka * LD + 8 * tig, ot + gid * LD + 8 * tig);
      bar_sync(1 + kg, 64);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float4 pr = xw[32 * n], dc = xw[32 * (n + 2)];
        const float prs[4] = {pr.x, pr.y, pr.z, pr.w};
        const float dcs[4] = {dc.x, dc.y, dc.z, dc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * n + 2 * tig + e % 2;
          s[n][e] = prs[e] * (s[n][e] + sc[n][e] - dlt[i]) * dcs[e];
        }
      }
      mma_pb<DP>(acc, s, qt + 2 * tig * LD + 4 * gid);     // dK += dS^T Q
    }
  }

  float* out = dk_warp ? static_cast<float*>(p.o) + b * p.os0 + hk * p.os1
                       : static_cast<float*>(p.o2) + b * p.o2s0 + hk * p.o2s1;
  const int64_t rs = dk_warp ? p.os2 : p.o2s2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = k0 + (half ? kb : ka);
    if (t < p.Tkv) store_row<DP>(out + t * rs, acc, half, tig, p.D, 1.f);
  }
}

// ----------------------------------------------------------- launching ---
// forward: Q ([64][DP + 4]) staged once, two stages of K and V tiles
// ([32][DP + 4]); dq: Q and dO staged once, two stages of K and V tiles
// ([16][DP + 4]); dk/dv: K and V ([32][DP + 4]) staged once, two stages of
// Q and dO tiles and of lse and delta, and the pairs' P and dcap
template <int DP> constexpr size_t fwd_smem() {
  return sizeof(float) * (Q_ROWS + 4 * FWD_KEYS) * (DP + 4);
}
template <int DP> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * Q_ROWS + 4 * BW_TILE) * (DP + 4);
}
template <int DP> constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * KV_ROWS + 4 * BW_TILE) * (DP + 4) + 4 * BW_TILE +
                          2 * 4 * 32 * 4);
}

// The widest cp.async copy (in floats) that every staged row start allows:
// the bases of q, k, v and do (null in the forward) 4 * w-byte aligned,
// and D and every stride of an axis longer than one a multiple of w.
int copy_width(const Params& p) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p.q) |
                          reinterpret_cast<uintptr_t>(p.k) |
                          reinterpret_cast<uintptr_t>(p.v) |
                          reinterpret_cast<uintptr_t>(p.dout);
  long long strides = p.D;
  const int nq[3] = {p.B, p.Hq, p.Tq}, nk[3] = {p.B, p.Hkv, p.Tkv};
  const long long qs[3] = {p.qs0, p.qs1, p.qs2}, ds[3] = {p.ds0, p.ds1, p.ds2};
  const long long ks[3] = {p.ks0, p.ks1, p.ks2}, vs[3] = {p.vs0, p.vs1, p.vs2};
  for (int i = 0; i < 3; ++i) {
    if (nq[i] > 1) strides |= qs[i] | ds[i];
    if (nk[i] > 1) strides |= ks[i] | vs[i];
  }
  for (int w = 4; w > 1; w /= 2)
    if (bases % (4 * w) == 0 && strides % w == 0) return w;
  return 1;
}

// Each kernel also asks for the largest shared-memory carveout, so that
// two (forward, dq) or three (dk/dv) blocks share an SM.
template <typename Kern>
int launch(Kern kern, dim3 grid, size_t smem, const Params& p,
           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

enum Which { FWD, DQ, DKV };

template <int DP>
int dispatch(Which w, Params p, cudaStream_t st) {
  p.vec = copy_width(p);
  if (w == FWD) {
    const dim3 grid((p.Tq + Q_ROWS - 1) / Q_ROWS, p.Hq, p.B);
    return launch(flash_fwd_kernel<DP>, grid, fwd_smem<DP>(), p, st);
  }
  if (w == DQ) {
    const dim3 grid((p.Tq + Q_ROWS - 1) / Q_ROWS, p.Hq, p.B);
    return launch(flash_bwd_dq_kernel<DP>, grid, dq_smem<DP>(), p, st);
  }
  const dim3 grid((p.Tkv + KV_ROWS - 1) / KV_ROWS, p.Hkv, p.B);
  return launch(flash_bwd_dkv_kernel<DP>, grid, dkv_smem<DP>(), p, st);
}

int run(Which w, const Params& p, int bf16, void* stream) {
  // bf16 is flash_attention_sm90.cu's
  if (p.D < 1 || p.D > 128 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || p.B < 1 ||
      p.Tq < 1 || p.Tkv < 1 || bf16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.D <= 64) return dispatch<64>(w, p, st);
  return dispatch<128>(w, p, st);
}

Params make(const void* q, const void* k, const void* v, const void* dout,
            long long qs0, long long qs1, long long qs2,
            long long ks0, long long ks1, long long ks2,
            long long vs0, long long vs1, long long vs2,
            long long ds0, long long ds1, long long ds2,
            const int* kv_len, int B, int Hq, int Hkv, int Tq, int Tkv, int D,
            int causal, int q_offset, int window, float softcap, float scale) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.qs0 = qs0; p.qs1 = qs1; p.qs2 = qs2;
  p.ks0 = ks0; p.ks1 = ks1; p.ks2 = ks2;
  p.vs0 = vs0; p.vs1 = vs1; p.vs2 = vs2;
  p.ds0 = ds0; p.ds1 = ds1; p.ds2 = ds2;
  p.kv_len = kv_len;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tkv = Tkv; p.D = D;
  p.causal = causal; p.q_offset = q_offset; p.window = window;
  p.softcap = softcap; p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v,
              long long qs0, long long qs1, long long qs2,
              long long ks0, long long ks1, long long ks2,
              long long vs0, long long vs1, long long vs2,
              const int* kv_len, void* o, long long os0, long long os1,
              long long os2, float* lse,
              int B, int Hq, int Hkv, int Tq, int Tkv, int D,
              int causal, int q_offset, int window, float softcap, float scale,
              int bf16, void* stream) {
  Params p = make(q, k, v, nullptr, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1,
                  vs2, 0, 0, 0, kv_len, B, Hq, Hkv, Tq, Tkv, D, causal,
                  q_offset, window, softcap, scale);
  p.o = o; p.os0 = os0; p.os1 = os1; p.os2 = os2;
  p.lse_out = lse;
  return run(FWD, p, bf16, stream);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 long long qs0, long long qs1, long long qs2,
                 long long ks0, long long ks1, long long ks2,
                 long long vs0, long long vs1, long long vs2,
                 long long ds0, long long ds1, long long ds2,
                 const float* lse, const float* delta, const int* kv_len,
                 void* dq, long long os0, long long os1, long long os2,
                 int B, int Hq, int Hkv, int Tq, int Tkv, int D,
                 int causal, int q_offset, int window, float softcap,
                 float scale, int bf16, void* stream) {
  Params p = make(q, k, v, dout, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,
                  ds0, ds1, ds2, kv_len, B, Hq, Hkv, Tq, Tkv, D, causal,
                  q_offset, window, softcap, scale);
  p.lse_in = lse; p.delta = delta;
  p.o = dq; p.os0 = os0; p.os1 = os1; p.os2 = os2;
  return run(DQ, p, bf16, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  long long qs0, long long qs1, long long qs2,
                  long long ks0, long long ks1, long long ks2,
                  long long vs0, long long vs1, long long vs2,
                  long long ds0, long long ds1, long long ds2,
                  const float* lse, const float* delta, const int* kv_len,
                  void* dk, long long dks0, long long dks1, long long dks2,
                  void* dv, long long dvs0, long long dvs1, long long dvs2,
                  int B, int Hq, int Hkv, int Tq, int Tkv, int D,
                  int causal, int q_offset, int window, float softcap,
                  float scale, int bf16, void* stream) {
  Params p = make(q, k, v, dout, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,
                  ds0, ds1, ds2, kv_len, B, Hq, Hkv, Tq, Tkv, D, causal,
                  q_offset, window, softcap, scale);
  p.lse_in = lse; p.delta = delta;
  p.o = dk; p.os0 = dks0; p.os1 = dks1; p.os2 = dks2;
  p.o2 = dv; p.o2s0 = dvs0; p.o2s1 = dvs1; p.o2s2 = dvs2;
  return run(DKV, p, bf16, stream);
}

}  // extern "C"
