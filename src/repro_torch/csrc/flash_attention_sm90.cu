// Flash attention forward and backward for bfloat16 on Hopper tensor cores
// (sm_90a): wgmma on TMA-staged, 128-byte-swizzled tiles.
//
// Replaces, for bfloat16 inputs, the three Pallas TPU kernels of
// repro/kernels/flash_attention.py:
//   * _fwd_kernel      -> flash_fwd_sm90      (o in bf16, lse [B,Hq,Tq] fp32)
//   * _bwd_dq_kernel   -> flash_bwd_dq_sm90   (dq in bf16)
//   * _bwd_dkv_kernel  -> flash_bwd_dkv_sm90  (dk, dv in bf16, summed over
//                                              the GQA group in the block)
// float32 inputs run in flash_attention.cu instead, to fp32 accuracy.
// The semantics are those kernels': GQA (Hq % Hkv == 0), causal masking
// with a scalar q_offset (query i sits at i + q_offset, key j at j), a
// sliding window (key live if kpos > qpos - window), a per-row kv_len [B],
// the softcap applied before the mask (and 1 - tanh^2 in dq, dk); masked
// keys give p = 0 exactly, so a row with no live key gets o = 0, dq = 0
// and a key no query sees gets dk = dv = 0; ragged Tq / Tkv need no
// padding; inputs are read through strides whose head-dim axis is
// contiguous (the model's [B,T,H,D] tensors come in as transposed views)
// and outputs are written through the strides of their input.
//
// What bounds them on an H100: operations. At the training shape (B 2,
// Hq 32, Hkv 8, T 4096, D 128, causal) the forward does 2.75e11 FLOPs on
// 169 MB of inputs and outputs, dq 4.12e11 on 237 MB and dk/dv 5.50e11 on
// 203 MB: over 1,600 FLOPs per byte against the card's bf16 ridge of about
// 295, so only the tensor cores can bring them near their bound. The
// design:
//   * every kernel has two consumer warpgroups of 64 rows each; tiles
//     come in by TMA (4-D maps over (D, T, H, B) built on the host from
//     the strides, out-of-bounds rows and head-dim columns filled with
//     zeros, 128-byte swizzle) through a ring in shared memory, one
//     mbarrier per stage for "full" and one for "empty";
//   * the consumers run wgmma.m64nNk16 straight from the swizzled tiles
//     (both operands K-major along D) for the first products, run the
//     softcap, the mask (only on tiles that cross the causal edge, the
//     window edge, kv_len or Tq) and the softmax on the accumulator
//     registers, cast the result to bf16 in registers and multiply it
//     into the next operand with the register-A wgmma, the B tile read
//     MN-major (transpose bit set); nothing goes through shared memory;
//   * tiles that no row of the block can see are never loaded, which
//     halves causal work; blocks are issued longest first;
//   * forward: one block is 128 query rows of one (row, q-head); a
//     producer warp (288 threads in all) loads Q once and streams K and V
//     in 128-key tiles through two stages; S = Q K^T, the online softmax
//     (row max and sum over the four threads of a quad), O += P V;
//   * dq: the same blocks and producer warp, Q and dO resident, K and V
//     stream in 64-key tiles, S = Q K^T and dP = dO V^T, dS = P (dP -
//     delta) dcap in registers, dQ += dS K;
//   * dk/dv: one block is 128 keys of one (row, kv-head), K and V
//     resident; 64-row Q and dO tiles, with their lse and delta, stream
//     through three stages for each of the group's query heads and each
//     query tile that can see a key of the block. The consumers compute
//     the transposed products, so every operand is already where wgmma
//     wants it: S^T = K Q^T and dP^T = V dO^T (A the resident K or V, B
//     the Q or dO tile), P^T = exp(S^T - lse) and dS^T = P^T (dP^T -
//     delta) dcap with lse and delta indexed by column, then dV += P^T dO
//     and dK += dS^T Q; dK is scaled once in the epilogue, and the group
//     is summed in the accumulators;
//   * registers: the SM's register file is split over four partitions and
//     a block's warps are dealt to them in turn, so 9 warps (the forward
//     and dq) put 3 on one partition and cap a thread at 168 registers,
//     which those kernels fit. dk/dv holds 192 fp32 accumulators a thread
//     (dK and dV 64 each, S^T and dP^T 32 each) and needs more, so it has
//     no producer warp: 8 warps allow 255 registers (it uses 236, no
//     spill). Its warp 0 also loads: it refills the stage of the previous
//     iteration once both warpgroups have released it, which keeps two
//     tiles in flight and seldom waits. (setmaxnreg does not help here:
//     ptxas still allocated the consumers within the 168 of the launch.)
//   * head dims 129 to 256 (gemma2-2b, recurrentgemma-2b's local layers;
//     a D under 256 is zero-filled to it by the TMA maps) keep these
//     accumulators: the D 128 tiles at D 256 would need 128 O registers a
//     thread in the forward and 256 for dK and dV, and up to 320 KB of
//     shared memory. So the block is 64 rows (forward, dq) or 64 keys
//     (dk/dv), both warpgroups work on all of them, and each owns one
//     half of the head dim of the output: it forms the full-D scores
//     (the two warpgroups form the same S and dP, an extra 50 % of the
//     forward's products and 67 % of dq's and dk/dv's) and multiplies
//     them into its 128 columns of V, K, dO or Q (the m64n128k16 of D
//     128, on the tile's panels 2 wg and 2 wg + 1). Tiles of 64 keys
//     (forward) and two dk/dv stages keep shared memory at 161, 193 and
//     194 KB; registers are those of D 128;
//   * each block owns its output rows: no atomics anywhere and the
//     results are deterministic.
// P and dS are rounded to bf16 for the second products (the plain version
// keeps them in fp32); row sums and every accumulator stay fp32.
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point (cudaGetDriverEntryPoint), so the library links no -lcuda. The
// descriptor, wgmma and quad helpers are shared with the cascade kernels
// (sm90_common.cuh).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int WG_ROWS = 64;       // rows per consumer warpgroup
constexpr int DQ_BK = 64;         // keys per dq tile
constexpr int NSTAGE = 2;         // ring depth (forward, dq)
constexpr int DKV_BQ = 64;        // query rows per dk/dv tile
constexpr int DKV_THREADS = 256;  // dk/dv: two warpgroups, no producer warp
constexpr int NTHREADS = 288;     // two consumer warpgroups + a producer warp
constexpr long long WATCHDOG_CYCLES = 1ll << 35;   // ~17 s: trap, not hang

// The tiles of a head-dim instantiation. Up to D 128 each consumer
// warpgroup owns 64 of the block's rows (forward, dq) or keys (dk/dv) and
// every column of the output. At D 256 (SPLIT) the two warpgroups share
// the block's 64 rows or keys and split the head dim: each forms the
// scores over all 256 columns and owns 128 columns of the output, so its
// accumulators are those of the D 128 layout and no register spills.
template <int DP> struct Tiles {
  static constexpr bool SPLIT = DP > 128;
  static constexpr int BQ = SPLIT ? 64 : 128;           // forward, dq rows
  static constexpr int FWD_BK = SPLIT ? 64 : 128;       // forward keys a tile
  static constexpr int DKV_BK = SPLIT ? 64 : 128;       // dk/dv keys a block
  static constexpr int DKV_NSTAGE = SPLIT ? 2 : 3;      // dk/dv ring depth
  static constexpr int ON = SPLIT ? 128 : DP;           // output columns a WG
};

struct Params {
  const int* kv_len;       // [B]
  void* out;               // forward: o; dq kernel: dq; dkv kernel: dk (bf16)
  long long os0, os1, os2;
  float* lse_out;          // forward: [B,Hq,Tq]
  const float* lse_in;     // dq, dkv: [B,Hq,Tq]
  const float* delta;      // dq, dkv: [B,Hq,Tq]
  int B, Hq, Hkv, Tq, Tkv, D;
  int causal, q_offset, window;   // window <= 0: none
  float softcap, scale;           // softcap <= 0: none
};

// The dkv kernel's second output, a kernel argument of its own: the same
// fields added to Params made the forward and dq, which never read them,
// 21 % and 12 % slower on an H100 (timed with scripts/flash_ab.py).
struct Out2 {
  void* ptr;               // dv (bf16)
  long long s0, s1, s2;
};

// ---------------------------------------------- mbarriers and TMA ---
// (the wgmma and swizzle helpers are in sm90_common.cuh)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of the given parity to complete. A wait that outlives
// WATCHDOG_CYCLES traps, so a fault in the pipeline surfaces as a launch
// error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > WATCHDOG_CYCLES) __trap();
  }
}

// TMA: the box at (c0, c1, c2, c3) = (d, t, h, b) of a 4-D map into shared
// memory, completion counted in bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ bool live_key(const Params& p, int qpos, int kpos,
                                         int kvl) {
  return kpos < kvl && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// Key tiles [kbeg, kbeg + n * BK) that the query rows [q0, q0 + nq) can see.
template <int BK>
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int nq,
                                         int kvl, int& kbeg) {
  const int qmin = q0 + p.q_offset, qmax = q0 + nq - 1 + p.q_offset;
  int kend = kvl;
  if (p.causal) kend = min(kend, qmax + 1);
  kbeg = p.window > 0 ? max(0, qmin - p.window + 1) : 0;
  kbeg = (kbeg / BK) * BK;
  return kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
}

// True when every key of [k0, k0 + BK) is live for every query position
// in [qlo, qhi]: the tile needs no mask.
template <int BK>
__device__ __forceinline__ bool tile_all_live(const Params& p, int k0,
                                              int qlo, int qhi, int kvl) {
  return k0 + BK <= kvl && (!p.causal || k0 + BK - 1 <= qlo) &&
         (p.window <= 0 || k0 > qhi - p.window);
}

// The block's (query tile of ROWS rows, q-head, row) from a 1-D grid whose
// first blocks hold the last query tiles, the longest under a causal mask.
template <int ROWS>
__device__ __forceinline__ void block_coords(const Params& p, int& q0, int& h,
                                             int& b) {
  const int nqb = (p.Tq + ROWS - 1) / ROWS;
  const int per = p.Hq * p.B;
  const int i = blockIdx.x;
  q0 = (nqb - 1 - i / per) * ROWS;
  h = (i % per) % p.Hq;
  b = (i % per) / p.Hq;
}


// ------------------------------------------------------------- forward ---
// Shared memory: Q [DP/64 panels][BQ rows][64], then per stage K and V
// [DP/64 panels][FWD_BK rows][64]; each panel row is 128 bytes, swizzled.
template <int DP> struct FwdSmem {
  static constexpr int NP = DP / PANEL;
  static constexpr uint32_t Q_BYTES = NP * Tiles<DP>::BQ * 128;
  static constexpr uint32_t KV_BYTES = NP * Tiles<DP>::FWD_BK * 128;  // K or V
  static constexpr uint32_t TILES = Q_BYTES + 2 * NSTAGE * KV_BYTES;
  static constexpr size_t BYTES = TILES + 8 * (1 + 3 * NSTAGE) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const Params p) {
  using L = FwdSmem<DP>;
  using T = Tiles<DP>;
  constexpr int BK = T::FWD_BK, NP = L::NP, ROWS = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + L::Q_BYTES;
  uint8_t* Vs = Ks + NSTAGE * L::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::TILES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + NSTAGE;
  uint64_t* empty = v_full + NSTAGE;

  int q0, h, b;
  block_coords<ROWS>(p, q0, h, b);
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(ROWS, p.Tq - q0);
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  int kbeg;
  const int ntiles = key_tiles<BK>(p, q0, nq, kvl, kbeg);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                                   // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < NP; ++c)
        tma_load(Qs + c * ROWS * 128, &tm_q, q_full, c * PANEL, q0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % NSTAGE;
        if (it >= NSTAGE) mbar_wait(&empty[s], ((it / NSTAGE) & 1) ^ 1);
        const int k0 = kbeg + it * BK;
        uint8_t* kd = Ks + s * L::KV_BYTES;
        uint8_t* vd = Vs + s * L::KV_BYTES;
        mbar_expect_tx(&k_full[s], L::KV_BYTES);
        for (int c = 0; c < NP; ++c)
          tma_load(kd + c * BK * 128, &tm_k, &k_full[s], c * PANEL, k0, hk, b);
        mbar_expect_tx(&v_full[s], L::KV_BYTES);
        for (int c = 0; c < NP; ++c)
          tma_load(vd + c * BK * 128, &tm_v, &v_full[s], c * PANEL, k0, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [q0 + r0, q0 + r0 + 64) and output
  // columns [c0, c0 + T::ON); this thread holds rows ra = 16 w + lane / 4
  // and ra + 8 of them, and of each 8-column block of an accumulator the
  // columns 2 (lane % 4) + {0, 1}
  const int wg = warp / 4, w = warp % 4;
  const int r0 = T::SPLIT ? 0 : WG_ROWS * wg, c0 = T::SPLIT ? T::ON * wg : 0;
  const int ra = 16 * w + lane / 4;
  const int qlo = q0 + r0 + p.q_offset;             // position of WG row 0
  const int qa = qlo + ra, qb = qa + 8;
  const int col = 2 * (lane % 4);
  const float sl = p.scale * LOG2E;                  // natural -> log2 units
  const bool cap = p.softcap > 0.f;
  const float cap_in = cap ? p.scale / p.softcap : 0.f;
  const float cap_out = p.softcap * LOG2E;

  float o[T::ON / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < T::ON / 2; ++i) o[i] = 0.f;
  // running max (log2 units; a row with no live key keeps NEG_INF in
  // natural units) and this thread's part of the row sum
  float m_a = NEG_INF * LOG2E, m_b = NEG_INF * LOG2E, l_a = 0.f, l_b = 0.f;

  const uint8_t* qw = Qs + r0 * 128;
  mbar_wait(q_full, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % NSTAGE;
    const uint32_t ph = (it / NSTAGE) & 1;
    const int k0 = kbeg + it * BK;
    const uint8_t* kt = Ks + st * L::KV_BYTES;
    const uint8_t* vt = Vs + st * L::KV_BYTES;

    mbar_wait(&k_full[st], ph);
    __syncwarp();
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<BK>(s, sw128_desc(qw + c * ROWS * 128 + off, 16, 1024),
                   sw128_desc(kt + c * BK * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(s);

    // scores in log2 units: softcap, mask, running max
    const bool masked = !tile_all_live<BK>(p, k0, qlo, qlo + WG_ROWS - 1, kvl);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float xa = s[4 * n + j], xb = s[4 * n + 2 + j];
        if (cap) {
          xa = cap_out * tanhf(xa * cap_in);
          xb = cap_out * tanhf(xb * cap_in);
        } else {
          xa *= sl;
          xb *= sl;
        }
        if (masked) {
          const int kpos = k0 + 8 * n + col + j;
          if (!live_key(p, qa, kpos, kvl)) xa = -INFINITY;
          if (!live_key(p, qb, kpos, kvl)) xb = -INFINITY;
        }
        s[4 * n + j] = xa;
        s[4 * n + 2 + j] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pa[BK / 4];            // P as the A operand: 4 registers per 16 keys
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = exp2f(s[4 * n] - mn_a), p1 = exp2f(s[4 * n + 1] - mn_a);
      const float p2 = exp2f(s[4 * n + 2] - mn_b), p3 = exp2f(s[4 * n + 3] - mn_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      // keys 16 kk + [0, 8) go to registers 0 (row a) and 1 (row b),
      // keys 16 kk + [8, 16) to registers 2 and 3
      pa[(n / 2) * 4 + (n % 2) * 2] = pack_bf16(p0, p1);
      pa[(n / 2) * 4 + (n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < T::ON / 8; ++n) {
      o[4 * n] *= al_a;
      o[4 * n + 1] *= al_a;
      o[4 * n + 2] *= al_b;
      o[4 * n + 3] *= al_b;
    }

    mbar_wait(&v_full[st], ph);
    __syncwarp();
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<T::ON>(o, &pa[4 * kk],
                      sw128_desc(vt + (c0 / PANEL) * BK * 128 + kk * 16 * 128,
                                 BK * 128, 1024));
    wg_commit();
    wg_wait_all();
    reg_fence(o);
    mbar_arrive(&empty[st]);
  }

  l_a = fmaxf(quad_sum(l_a), 1e-30f);
  l_b = fmaxf(quad_sum(l_b), 1e-30f);
  const int row_a = q0 + r0 + ra, row_b = row_a + 8;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.out) + b * p.os0 + h * p.os1;
#pragma unroll
  for (int n = 0; n < T::ON / 8; ++n) {
    const int d = c0 + 8 * n + col;
    if (c0 + 8 * n >= p.D) continue;
    if (row_a < p.Tq)
      *reinterpret_cast<uint32_t*>(O + row_a * p.os2 + d) =
          pack_bf16(o[4 * n] / l_a, o[4 * n + 1] / l_a);
    if (row_b < p.Tq)
      *reinterpret_cast<uint32_t*>(O + row_b * p.os2 + d) =
          pack_bf16(o[4 * n + 2] / l_b, o[4 * n + 3] / l_b);
  }
  if (lane % 4 == 0 && (!T::SPLIT || wg == 0)) {
    const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Tq;
    // back to natural units: lse = m ln 2 + ln l
    if (row_a < p.Tq) p.lse_out[rb + row_a] = m_a / LOG2E + logf(l_a);
    if (row_b < p.Tq) p.lse_out[rb + row_b] = m_b / LOG2E + logf(l_b);
  }
}

// ---------------------------------------------------------- backward dq ---
// Shared memory: Q and dO [DP/64 panels][BQ rows][64], then per stage K
// and V [DP/64 panels][DQ_BK rows][64], swizzled as in the forward.
template <int DP> struct DqSmem {
  static constexpr int NP = DP / PANEL;
  static constexpr uint32_t Q_BYTES = NP * Tiles<DP>::BQ * 128;
  static constexpr uint32_t KV_BYTES = NP * DQ_BK * 128;
  static constexpr uint32_t TILES = 2 * Q_BYTES + 2 * NSTAGE * KV_BYTES;
  static constexpr size_t BYTES = TILES + 8 * (1 + 2 * NSTAGE) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const Params p) {
  using L = DqSmem<DP>;
  using T = Tiles<DP>;
  constexpr int BK = DQ_BK, NP = L::NP, ROWS = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Qs = base;
  uint8_t* dOs = Qs + L::Q_BYTES;
  uint8_t* Ks = dOs + L::Q_BYTES;
  uint8_t* Vs = Ks + NSTAGE * L::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::TILES);
  uint64_t* q_full = bars;                 // Q and dO
  uint64_t* full = bars + 1;               // K and V of a stage
  uint64_t* empty = full + NSTAGE;

  int q0, h, b;
  block_coords<ROWS>(p, q0, h, b);
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(ROWS, p.Tq - q0);
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  int kbeg;
  const int ntiles = key_tiles<BK>(p, q0, nq, kvl, kbeg);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                                   // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
      for (int c = 0; c < NP; ++c) {
        tma_load(Qs + c * ROWS * 128, &tm_q, q_full, c * PANEL, q0, h, b);
        tma_load(dOs + c * ROWS * 128, &tm_do, q_full, c * PANEL, q0, h, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % NSTAGE;
        if (it >= NSTAGE) mbar_wait(&empty[s], ((it / NSTAGE) & 1) ^ 1);
        const int k0 = kbeg + it * BK;
        uint8_t* kd = Ks + s * L::KV_BYTES;
        uint8_t* vd = Vs + s * L::KV_BYTES;
        mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
        for (int c = 0; c < NP; ++c) {
          tma_load(kd + c * BK * 128, &tm_k, &full[s], c * PANEL, k0, hk, b);
          tma_load(vd + c * BK * 128, &tm_v, &full[s], c * PANEL, k0, hk, b);
        }
      }
    }
    return;
  }

  // consumers, laid out as in the forward
  const int wg = warp / 4, w = warp % 4;
  const int r0 = T::SPLIT ? 0 : WG_ROWS * wg, c0 = T::SPLIT ? T::ON * wg : 0;
  const int ra = 16 * w + lane / 4;
  const int qlo = q0 + r0 + p.q_offset;
  const int qa = qlo + ra, qb = qa + 8;
  const int row_a = q0 + r0 + ra, row_b = row_a + 8;
  const int col = 2 * (lane % 4);
  const float sl = p.scale * LOG2E;
  const bool cap = p.softcap > 0.f;
  const float cap_in = cap ? p.scale / p.softcap : 0.f;
  const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Tq;
  // lse and delta of this thread's rows (rows past Tq are never stored)
  const float lse_a = row_a < p.Tq ? p.lse_in[rb + row_a] * LOG2E : 0.f;
  const float lse_b = row_b < p.Tq ? p.lse_in[rb + row_b] * LOG2E : 0.f;
  const float dl_a = row_a < p.Tq ? p.delta[rb + row_a] : 0.f;
  const float dl_b = row_b < p.Tq ? p.delta[rb + row_b] : 0.f;

  float dq[T::ON / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < T::ON / 2; ++i) dq[i] = 0.f;

  const uint8_t* qw = Qs + r0 * 128;
  const uint8_t* dow = dOs + r0 * 128;
  mbar_wait(q_full, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % NSTAGE;
    const uint32_t ph = (it / NSTAGE) & 1;
    const int k0 = kbeg + it * BK;
    const uint8_t* kt = Ks + st * L::KV_BYTES;
    const uint8_t* vt = Vs + st * L::KV_BYTES;

    mbar_wait(&full[st], ph);
    __syncwarp();
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<BK>(s, sw128_desc(qw + c * ROWS * 128 + off, 16, 1024),
                   sw128_desc(kt + c * BK * 128 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<BK>(dp, sw128_desc(dow + c * ROWS * 128 + off, 16, 1024),
                   sw128_desc(vt + c * BK * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // dS = P (dP - delta) dcap, P = exp(s - lse), 0 on masked keys
    const bool masked = !tile_all_live<BK>(p, k0, qlo, qlo + WG_ROWS - 1, kvl);
    uint32_t da[BK / 4];            // dS as the A operand
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool rb8 = e >= 2;
        float x = s[4 * n + e], dcap = 1.f;
        if (cap) {
          const float t = tanhf(x * cap_in);
          x = p.softcap * LOG2E * t;
          dcap = 1.f - t * t;
        } else {
          x *= sl;
        }
        float pr = exp2f(x - (rb8 ? lse_b : lse_a));
        if (masked && !live_key(p, rb8 ? qb : qa, k0 + 8 * n + col + (e & 1), kvl))
          pr = 0.f;
        ds[e] = pr * (dp[4 * n + e] - (rb8 ? dl_b : dl_a)) * dcap;
      }
      da[(n / 2) * 4 + (n % 2) * 2] = pack_bf16(ds[0], ds[1]);
      da[(n / 2) * 4 + (n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    reg_fence(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<T::ON>(dq, &da[4 * kk],
                      sw128_desc(kt + (c0 / PANEL) * BK * 128 + kk * 16 * 128,
                                 BK * 128, 1024));
    wg_commit();
    wg_wait_all();
    reg_fence(dq);
    mbar_arrive(&empty[st]);
  }

  __nv_bfloat16* dQ = static_cast<__nv_bfloat16*>(p.out) + b * p.os0 + h * p.os1;
#pragma unroll
  for (int n = 0; n < T::ON / 8; ++n) {
    const int d = c0 + 8 * n + col;
    if (c0 + 8 * n >= p.D) continue;
    if (row_a < p.Tq)
      *reinterpret_cast<uint32_t*>(dQ + row_a * p.os2 + d) =
          pack_bf16(dq[4 * n] * p.scale, dq[4 * n + 1] * p.scale);
    if (row_b < p.Tq)
      *reinterpret_cast<uint32_t*>(dQ + row_b * p.os2 + d) =
          pack_bf16(dq[4 * n + 2] * p.scale, dq[4 * n + 3] * p.scale);
  }
}

// --------------------------------------------------------- backward dkv ---
// Shared memory: K and V [DP/64 panels][DKV_BK rows][64], resident; then
// per stage Q and dO [DP/64 panels][DKV_BQ rows][64], swizzled as in the
// forward; then per stage the tile's lse (log2 units) and delta [DKV_BQ].
template <int DP> struct DkvSmem {
  static constexpr int NP = DP / PANEL, NS = Tiles<DP>::DKV_NSTAGE;
  static constexpr uint32_t KV_BYTES = NP * Tiles<DP>::DKV_BK * 128;  // K or V
  static constexpr uint32_t Q_BYTES = NP * DKV_BQ * 128;    // a Q or dO tile
  static constexpr uint32_t TILES = 2 * KV_BYTES + 2 * NS * Q_BYTES;
  static constexpr uint32_t ROWS = TILES + NS * 2 * DKV_BQ * 4;
  static constexpr size_t BYTES = ROWS + 8 * (1 + 2 * NS) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const Params p, const Out2 dvo) {
  using L = DkvSmem<DP>;
  using T = Tiles<DP>;
  constexpr int BK = T::DKV_BK, BQT = DKV_BQ, NP = L::NP, NSTAGE = L::NS;
  // warp 0 refills a stage LAG iterations after the consumers used it
  constexpr int LAG = NSTAGE > 2 ? 1 : 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Ks = base;
  uint8_t* Vs = Ks + L::KV_BYTES;
  uint8_t* Qs = Vs + L::KV_BYTES;          // stage s: Q, then dO
  float* rows = reinterpret_cast<float*>(base + L::TILES);  // stage s: lse, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::ROWS);
  uint64_t* kv_full = bars;                // K and V
  uint64_t* full = bars + 1;               // Q, dO, lse and delta of a stage
  uint64_t* empty = full + NSTAGE;

  // The block's (key tile, kv-head, row) from a 1-D grid whose first
  // blocks hold the first key tiles, which the most queries see under a
  // causal mask.
  const int per = p.Hkv * p.B;
  const int k0 = (blockIdx.x / per) * BK;
  const int hk = (blockIdx.x % per) % p.Hkv;
  const int b = (blockIdx.x % per) / p.Hkv;
  const int g = p.Hq / p.Hkv;
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  // query rows [ibeg, iend) that can see a key of [k0, min(k0 + BK, kvl)),
  // as query tiles [qt_beg, qt_beg + nqt), for each of the g query heads
  const int kmax = min(k0 + BK, kvl) - 1;
  const int ibeg = p.causal ? max(0, k0 - p.q_offset) : 0;
  int iend = p.Tq;
  if (p.window > 0) iend = min(iend, kmax - p.q_offset + p.window);
  const int qt_beg = ibeg / BQT;
  const int nqt = kmax >= k0 && iend > ibeg ? (iend + BQT - 1) / BQT - qt_beg : 0;
  const int niter = g * nqt;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 32);             // the lanes of warp 0 arrive
      mbar_init(&empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warp 0 also loads. Tile j of the block's (query head, query tile)
  // sequence goes to stage j % NSTAGE: Q and dO by TMA, and lse (log2
  // units) and delta by the warp's lanes. Rows past Tq get lse = delta =
  // 0, never an unread value: their p is masked to 0, and 0 * NaN is not 0.
  // (The lambda takes scalars by value: a reference to the kernel
  // parameter p would copy it to local memory.)
  const float* lse_in = p.lse_in;
  const float* delta = p.delta;
  const int Tq = p.Tq;
  const long long row0 = static_cast<long long>(b) * p.Hq + hk * g;
  const CUtensorMap* mq = &tm_q;
  const CUtensorMap* mdo = &tm_do;
  auto load_tile = [=](int j) {
    const int st = j % NSTAGE;
    const int h = hk * g + j / nqt;
    const int q0 = (qt_beg + j % nqt) * BQT;
    const long long rb = (row0 + j / nqt) * Tq;
    float* lse_s = rows + st * 2 * BQT;
    for (int i = lane; i < BQT; i += 32) {
      const bool in = q0 + i < Tq;
      lse_s[i] = in ? lse_in[rb + q0 + i] * LOG2E : 0.f;
      lse_s[BQT + i] = in ? delta[rb + q0 + i] : 0.f;
    }
    if (lane == 0) {
      uint8_t* qd = Qs + st * 2 * L::Q_BYTES;
      uint8_t* dod = qd + L::Q_BYTES;
      mbar_expect_tx(&full[st], 2 * L::Q_BYTES);
      for (int c = 0; c < NP; ++c) {
        tma_load(qd + c * BQT * 128, mq, &full[st], c * PANEL, q0, h, b);
        tma_load(dod + c * BQT * 128, mdo, &full[st], c * PANEL, q0, h, b);
      }
    } else {
      mbar_arrive(&full[st]);
    }
  };
  if (warp == 0 && niter > 0) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int c = 0; c < NP; ++c) {
        tma_load(Ks + c * BK * 128, &tm_k, kv_full, c * PANEL, k0, hk, b);
        tma_load(Vs + c * BK * 128, &tm_v, kv_full, c * PANEL, k0, hk, b);
      }
    }
    for (int j = 0; j < min(NSTAGE, niter); ++j) load_tile(j);
  }

  // consumers: warpgroup wg owns keys [kw0, kw0 + 64) and the columns
  // [c0, c0 + T::ON) of their dK and dV; this thread holds keys ka = kw0 +
  // 16 w + lane / 4 and ka + 8, and of each 8-column block of S^T / dP^T
  // the query columns 2 (lane % 4) + {0, 1}
  const int wg = warp / 4, w = warp % 4;
  const int r0 = T::SPLIT ? 0 : WG_ROWS * wg, c0 = T::SPLIT ? T::ON * wg : 0;
  const int kw0 = k0 + r0;
  const int ka = kw0 + 16 * w + lane / 4, kb = ka + 8;
  const int kwmax = min(kw0 + WG_ROWS, kvl) - 1;     // last live key of the WG
  const int col = 2 * (lane % 4);
  const float sl = p.scale * LOG2E;
  const bool cap = p.softcap > 0.f;
  const float cap_in = cap ? p.scale / p.softcap : 0.f;
  const float cap_out = p.softcap * LOG2E;

  float dk[T::ON / 2], dv[T::ON / 2], s[BQT / 2], dp[BQT / 2];
#pragma unroll
  for (int i = 0; i < T::ON / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint64_t k_desc = sw128_desc(Ks + r0 * 128, 16, 1024);
  const uint64_t v_desc = sw128_desc(Vs + r0 * 128, 16, 1024);
  if (niter > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < niter; ++it) {
    const int st = it % NSTAGE;
    const uint32_t ph = (it / NSTAGE) & 1;
    const int q0 = (qt_beg + it % nqt) * BQT;
    const uint8_t* qt = Qs + st * 2 * L::Q_BYTES;
    const uint8_t* dot = qt + L::Q_BYTES;
    const float* lse_s = rows + st * 2 * BQT;
    // positions of the tile's first and last query row below Tq
    const int qlo = q0 + p.q_offset;
    const int qhi = min(q0 + BQT, p.Tq) - 1 + p.q_offset;
    // skip a tile in which no key of this warpgroup is live for any row
    const bool any = kwmax >= kw0 && (!p.causal || kw0 <= qhi) &&
                     (p.window <= 0 || kwmax > qlo - p.window);

    mbar_wait(&full[st], ph);
    if (any) {
      // the descriptors of each k-step are one add from a base that is
      // opaque in every iteration, so the compiler cannot hoist all 16 of
      // K's and V's out of the loop and hold them in registers
      uint64_t kd = k_desc, vd = v_desc;
      asm volatile("" : "+l"(kd), "+l"(vd));
      const uint64_t qd = sw128_desc(qt, 16, 1024);
      const uint64_t dod = sw128_desc(dot, 16, 1024);
      __syncwarp();
      reg_fence(s);
      reg_fence(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BQT>(s, desc_add(kd, c * BK * 128 + off),
                      desc_add(qd, c * BQT * 128 + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BQT>(dp, desc_add(vd, c * BK * 128 + off),
                      desc_add(dod, c * BQT * 128 + off), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(s);
      reg_fence(dp);

      // P^T = exp(S^T - lse), 0 on masked keys and on rows past Tq;
      // dS^T = P^T (dP^T - delta) dcap; lse and delta by column
      const bool masked = !(kw0 + WG_ROWS <= kvl && q0 + BQT <= p.Tq &&
                            (!p.causal || kw0 + WG_ROWS - 1 <= qlo) &&
                            (p.window <= 0 || kw0 > qhi - p.window));
      uint32_t pa[BQT / 4], da[BQT / 4];   // P^T, dS^T as A operands
#pragma unroll
      for (int n = 0; n < BQT / 8; ++n) {
        const int j = 8 * n + col;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + j);
        const float2 dl = *reinterpret_cast<const float2*>(lse_s + BQT + j);
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * n + e], dcap = 1.f;
          if (cap) {
            const float t = tanhf(x * cap_in);
            x = cap_out * t;
            dcap = 1.f - t * t;
          } else {
            x *= sl;
          }
          float pv = exp2f(x - ((e & 1) ? ls.y : ls.x));
          if (masked) {
            const int qi = q0 + j + (e & 1);
            if (qi >= p.Tq || !live_key(p, qi + p.q_offset, e >= 2 ? kb : ka, kvl))
              pv = 0.f;
          }
          pr[e] = pv;
          ds[e] = pv * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x)) * dcap;
        }
        // queries 16 kk + [0, 8) go to registers 0 (key a) and 1 (key b),
        // queries 16 kk + [8, 16) to registers 2 and 3
        pa[(n / 2) * 4 + (n % 2) * 2] = pack_bf16(pr[0], pr[1]);
        pa[(n / 2) * 4 + (n % 2) * 2 + 1] = pack_bf16(pr[2], pr[3]);
        da[(n / 2) * 4 + (n % 2) * 2] = pack_bf16(ds[0], ds[1]);
        da[(n / 2) * 4 + (n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      const int cp = (c0 / PANEL) * BQT * 128;   // the WG's first panel
      const uint64_t dot_t = sw128_desc(dot + cp, BQT * 128, 1024);
      const uint64_t qt_t = sw128_desc(qt + cp, BQT * 128, 1024);
      reg_fence(dv);
      reg_fence(dk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs<T::ON>(dv, &pa[4 * kk], desc_add(dot_t, kk * 16 * 128));
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs<T::ON>(dk, &da[4 * kk], desc_add(qt_t, kk * 16 * 128));
      wg_commit();
      wg_wait_all();
      reg_fence(dv);
      reg_fence(dk);
    }
    mbar_arrive(&empty[st]);
    // Warp 0 refills the stage of iteration it - LAG once both
    // warpgroups have released it. With three stages (D <= 128) that is a
    // stage late, so it seldom waits for the other warpgroup, and still
    // NSTAGE - 1 tiles ahead of the consumers; with two (D 256, where the
    // warpgroups do the same work on the same tile) it is the stage just
    // used, one tile ahead.
    if (warp == 0 && it >= LAG && it - LAG + NSTAGE < niter) {
      mbar_wait(&empty[(it - LAG) % NSTAGE], ((it - LAG) / NSTAGE) & 1);
      load_tile(it - LAG + NSTAGE);
    }
  }

  // every key row below Tkv is written, zeros where no query saw it
  __nv_bfloat16* dK = static_cast<__nv_bfloat16*>(p.out) + b * p.os0 + hk * p.os1;
  __nv_bfloat16* dV = static_cast<__nv_bfloat16*>(dvo.ptr) + b * dvo.s0 + hk * dvo.s1;
#pragma unroll
  for (int n = 0; n < T::ON / 8; ++n) {
    const int d = c0 + 8 * n + col;
    if (c0 + 8 * n >= p.D) continue;
    if (ka < p.Tkv) {
      *reinterpret_cast<uint32_t*>(dK + ka * p.os2 + d) =
          pack_bf16(dk[4 * n] * p.scale, dk[4 * n + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dV + ka * dvo.s2 + d) =
          pack_bf16(dv[4 * n], dv[4 * n + 1]);
    }
    if (kb < p.Tkv) {
      *reinterpret_cast<uint32_t*>(dK + kb * p.os2 + d) =
          pack_bf16(dk[4 * n + 2] * p.scale, dk[4 * n + 3] * p.scale);
      *reinterpret_cast<uint32_t*>(dV + kb * dvo.s2 + d) =
          pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
}

// ------------------------------------------------------------ the host ---
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// An input of the kernels: a bf16 [B, H, T, D] tensor and its element
// strides (s0, s1, s2, 1).
struct In {
  const void* ptr;
  long long s0, s1, s2;
};

// An input as a 4-D TMA map over (D, T, H, B) whose box is 64 head-dim
// columns x `rows` rows, 128-byte swizzled, zero-filled out of bounds. TMA
// takes a 16-byte-aligned base and strides that are multiples of 16 bytes;
// a dimension of size 1 has no stride to align, so it gets the largest of
// the others.
int make_map(CUtensorMap* map, const In& t, int B, int H, int T, int D,
             int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorInitializationError);
  const void* ptr = t.ptr;
  long long st[3] = {t.s2, t.s1, t.s0};           // T, H, B
  const int n[3] = {T, H, B};
  long long widest = 8;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1) widest = st[i] > widest ? st[i] : widest;
  for (int i = 0; i < 3; ++i)
    if (n[i] == 1) st[i] = widest;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || D % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 3; ++i)
    if (st[i] <= 0 || st[i] % 8 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[0]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2};
  const cuuint32_t box[4] = {PANEL, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int check_dims(int B, int Hq, int Hkv, int Tq, int Tkv, int D, int bf16) {
  if (!bf16 || D < 8 || D > 256 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0 ||
      B < 1 || Tq < 1 || Tkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

Params make(const int* kv_len, void* out, long long os0, long long os1,
            long long os2, int B, int Hq, int Hkv, int Tq, int Tkv, int D,
            int causal, int q_offset, int window, float softcap, float scale) {
  Params p{};
  p.kv_len = kv_len;
  p.out = out; p.os0 = os0; p.os1 = os1; p.os2 = os2;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tkv = Tkv; p.D = D;
  p.causal = causal; p.q_offset = q_offset; p.window = window;
  p.softcap = softcap; p.scale = scale;
  return p;
}

// Blocks of the forward and dq: (query tile, q-head, row).
template <int DP>
long long q_blocks(const Params& p) {
  constexpr int R = Tiles<DP>::BQ;
  return static_cast<long long>((p.Tq + R - 1) / R) * p.Hq * p.B;
}

template <typename Kern, typename... Args>
int launch(Kern kern, size_t smem, long long nblocks, int nthreads,
           cudaStream_t st, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nblocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(nblocks), nthreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Each kernel at one head-dim instantiation: the TMA maps with that
// instantiation's tile rows, then the launch.
template <int DP>
int run_fwd(const In& q, const In& k, const In& v, const Params& p,
            cudaStream_t st) {
  using T = Tiles<DP>;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, p.B, p.Hq, p.Tq, p.D, T::BQ);
  if (!rc) rc = make_map(&mk, k, p.B, p.Hkv, p.Tkv, p.D, T::FWD_BK);
  if (!rc) rc = make_map(&mv, v, p.B, p.Hkv, p.Tkv, p.D, T::FWD_BK);
  if (rc) return rc;
  return launch(flash_fwd_sm90_kernel<DP>, FwdSmem<DP>::BYTES,
                q_blocks<DP>(p), NTHREADS, st, mq, mk, mv, p);
}

template <int DP>
int run_dq(const In& q, const In& k, const In& v, const In& dout,
           const Params& p, cudaStream_t st) {
  using T = Tiles<DP>;
  CUtensorMap mq, mk, mv, mdo;
  int rc = make_map(&mq, q, p.B, p.Hq, p.Tq, p.D, T::BQ);
  if (!rc) rc = make_map(&mk, k, p.B, p.Hkv, p.Tkv, p.D, DQ_BK);
  if (!rc) rc = make_map(&mv, v, p.B, p.Hkv, p.Tkv, p.D, DQ_BK);
  if (!rc) rc = make_map(&mdo, dout, p.B, p.Hq, p.Tq, p.D, T::BQ);
  if (rc) return rc;
  return launch(flash_bwd_dq_sm90_kernel<DP>, DqSmem<DP>::BYTES,
                q_blocks<DP>(p), NTHREADS, st, mq, mk, mv, mdo, p);
}

template <int DP>
int run_dkv(const In& q, const In& k, const In& v, const In& dout,
            const Params& p, const Out2& dvo, cudaStream_t st) {
  using T = Tiles<DP>;
  CUtensorMap mq, mk, mv, mdo;
  int rc = make_map(&mq, q, p.B, p.Hq, p.Tq, p.D, DKV_BQ);
  if (!rc) rc = make_map(&mk, k, p.B, p.Hkv, p.Tkv, p.D, T::DKV_BK);
  if (!rc) rc = make_map(&mv, v, p.B, p.Hkv, p.Tkv, p.D, T::DKV_BK);
  if (!rc) rc = make_map(&mdo, dout, p.B, p.Hq, p.Tq, p.D, DKV_BQ);
  if (rc) return rc;
  // blocks: (key tile, kv-head, row)
  const long long nblocks =
      static_cast<long long>((p.Tkv + T::DKV_BK - 1) / T::DKV_BK) * p.Hkv *
      p.B;
  return launch(flash_bwd_dkv_sm90_kernel<DP>, DkvSmem<DP>::BYTES, nblocks,
                DKV_THREADS, st, mq, mk, mv, mdo, p, dvo);
}

}  // namespace

extern "C" {

int flash_fwd_sm90(const void* q, const void* k, const void* v,
                   long long qs0, long long qs1, long long qs2,
                   long long ks0, long long ks1, long long ks2,
                   long long vs0, long long vs1, long long vs2,
                   const int* kv_len, void* o, long long os0, long long os1,
                   long long os2, float* lse,
                   int B, int Hq, int Hkv, int Tq, int Tkv, int D,
                   int causal, int q_offset, int window, float softcap,
                   float scale, int bf16, void* stream) {
  const int rc = check_dims(B, Hq, Hkv, Tq, Tkv, D, bf16);
  if (rc) return rc;
  Params p = make(kv_len, o, os0, os1, os2, B, Hq, Hkv, Tq, Tkv, D, causal,
                  q_offset, window, softcap, scale);
  p.lse_out = lse;
  const In qi{q, qs0, qs1, qs2}, ki{k, ks0, ks1, ks2}, vi{v, vs0, vs1, vs2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return run_fwd<64>(qi, ki, vi, p, st);
  if (D <= 128) return run_fwd<128>(qi, ki, vi, p, st);
  return run_fwd<256>(qi, ki, vi, p, st);
}

int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout,
                      long long qs0, long long qs1, long long qs2,
                      long long ks0, long long ks1, long long ks2,
                      long long vs0, long long vs1, long long vs2,
                      long long ds0, long long ds1, long long ds2,
                      const float* lse, const float* delta, const int* kv_len,
                      void* dq, long long os0, long long os1, long long os2,
                      int B, int Hq, int Hkv, int Tq, int Tkv, int D,
                      int causal, int q_offset, int window, float softcap,
                      float scale, int bf16, void* stream) {
  const int rc = check_dims(B, Hq, Hkv, Tq, Tkv, D, bf16);
  if (rc) return rc;
  Params p = make(kv_len, dq, os0, os1, os2, B, Hq, Hkv, Tq, Tkv, D, causal,
                  q_offset, window, softcap, scale);
  p.lse_in = lse;
  p.delta = delta;
  const In qi{q, qs0, qs1, qs2}, ki{k, ks0, ks1, ks2}, vi{v, vs0, vs1, vs2},
      di{dout, ds0, ds1, ds2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return run_dq<64>(qi, ki, vi, di, p, st);
  if (D <= 128) return run_dq<128>(qi, ki, vi, di, p, st);
  return run_dq<256>(qi, ki, vi, di, p, st);
}

int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout,
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
  const int rc = check_dims(B, Hq, Hkv, Tq, Tkv, D, bf16);
  if (rc) return rc;
  Params p = make(kv_len, dk, dks0, dks1, dks2, B, Hq, Hkv, Tq, Tkv, D,
                  causal, q_offset, window, softcap, scale);
  const Out2 dvo{dv, dvs0, dvs1, dvs2};
  p.lse_in = lse;
  p.delta = delta;
  const In qi{q, qs0, qs1, qs2}, ki{k, ks0, ks1, ks2}, vi{v, vs0, vs1, vs2},
      di{dout, ds0, ds1, ds2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return run_dkv<64>(qi, ki, vi, di, p, dvo, st);
  if (D <= 128) return run_dkv<128>(qi, ki, vi, di, p, dvo, st);
  return run_dkv<256>(qi, ki, vi, di, p, dvo, st);
}

}  // extern "C"
