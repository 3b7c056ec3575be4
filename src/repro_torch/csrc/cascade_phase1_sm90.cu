// Cascade verify attention, phase 1, in bfloat16 on Hopper tensor cores
// (sm_90a): wgmma on cp.async-staged, 128-byte-swizzled tiles.
//
// Replaces, for bfloat16 inputs, the two Pallas TPU kernels of
// repro/kernels/cascade_attention.py:
//   * _phase1_kernel        (dense cache [B,Hkv,S,D], rolling buffers)
//         -> cascade_phase1_dense_sm90
//   * _phase1_paged_kernel  (page pool [P,Hkv,page,D] + page table [B,MP])
//         -> cascade_phase1_paged_sm90
// float32 inputs run in the 3xTF32 kernels of cascade_phase1.cu.
// The contract is theirs: the un-normalized split-K flash partials of the
// tree query block, acc [B,Hq,ns,Tq,D] and m/l [B,Hq,ns,Tq] in fp32, over
// the split geometry the wrapper computes, with their masking rules: a
// masked key inside the split's range scores -1e30, a key past the split's
// live end is not part of the split, rolling recovery is kpos = last -
// rem(last - slot, S) with C's truncating % and the true capacity S,
// padded slots are dead, a page id is clamped to [0, n_phys-1] before it
// is multiplied by the page stride, and the softcap comes before the mask.
//
// What bounds it on an H100: bytes. At the decode verify shape (B 4, Hq 32,
// Hkv 8, D 128, Tq 76, caches of 520-600 keys) a call does 2.8 GFLOP on
// about 9.3 MB of live bf16 K/V, 2.5 MB of q and 10 MB (dense, 2 splits)
// to 40 MB (paged, 8 splits) of fp32 partials: 50-130 FLOPs per byte,
// under the card's bf16 ridge of about 295. The design:
//   * one block per (slab of 128 stacked query rows, split, row x KV
//     head): the GQA group's g query heads are stacked into one M
//     dimension of g*Tq rows (row r is head hk*g + r / Tq, position
//     r % Tq), so a K/V tile is fetched once per block for 128 query rows
//     (the CUDA-core kernel fetched it once for 16 rows of one head);
//     split is the slowest grid index, so the long first splits start
//     first;
//   * two consumer warpgroups of 64 rows and no producer warp. All 256
//     threads stage the tiles with 16-byte cp.async, each chunk written to
//     its swizzled place (chunk ^ row % 8), the row's address resolved per
//     key: the slot for a dense or rolling cache, the clamped physical
//     page from the table and the offset in it for a paged one. So every
//     page size loads, and any strides that are multiples of 8 elements;
//     keys past the split's live end and head-dim columns past D arrive as
//     zeros (cp.async with a source size of 0);
//   * Q is read once per block, in place, in bf16, through its strides;
//     the scale is applied to the fp32 scores, in log2 units for exp2;
//   * per 64-key tile and warpgroup: S = Q K^T (wgmma m64n64k16, both
//     operands K-major along D), the scale, the softcap and the mask on
//     the accumulators (each column's kpos computed as above), the online
//     softmax with the row max and sum over a quad, P packed to bf16 in
//     registers as the register-A fragment, O += P V (wgmma m64nDk16, V
//     read MN-major with the transpose bit); l sums the fp32 p;
//   * tiles pass through a ring of NSTAGE stages in shared memory: while a
//     tile is multiplied the next NSTAGE - 1 are in flight, and one
//     __syncthreads per tile both publishes a tile and frees the stage of
//     the one before. The ring waits on cp.async groups, not on
//     mbarriers, so no wait can outlive a fault;
//   * two blocks share an SM (at most 128 registers a thread, 97 KB of
//     shared memory a block with two stages), so one block's loads overlap
//     another's products: most blocks are short (a paged split is two
//     tiles) and their first loads, not their products, take the time.
//     On an H100 this ran the paged cache faster than one block an SM with
//     three stages, and the dense one about as fast;
//   * head dims up to 256 (recurrentgemma-2b's local layers): the D 256
//     instantiation keeps the same tiles, so a block holds a 64 KB Q slab
//     and a two-stage ring of 32 KB K and V tiles (193 KB: one block an
//     SM, up to 255 registers a thread), and a thread's 128 fp32 O
//     accumulators are formed as two m64n128k16 halves, one per pair of V
//     panels;
//   * a row that sees every key of a tile skips the mask: its scores are
//     only scaled;
//   * each block owns its output rows (no atomics, deterministic); a split
//     with no live key loads nothing and writes acc = 0, l = 0,
//     m = -1e30, so the merge weighs it by exp(m - m_g) = 0 and never
//     meets an unwritten value.
// P is rounded to bf16 for O += P V (the plain version keeps it in fp32),
// as in the flash kernels; m, l and acc stay fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;           // stacked query rows per block
constexpr int WG_ROWS = 64;       // rows per consumer warpgroup
constexpr int BK = 64;            // keys per tile
constexpr int NSTAGE = 2;         // ring depth
constexpr int NTHREADS = 256;     // two consumer warpgroups
constexpr float NEG_L2 = NEG_INF * LOG2E;   // a masked score, log2 units

struct Params {
  const __nv_bfloat16* q;    // [B,Hq,Tq,D] through qs0..2
  const __nv_bfloat16* k;    // dense [B,Hkv,S,D] or pool [P,Hkv,page,D]
  const __nv_bfloat16* v;
  long long qs0, qs1, qs2;   // element strides (the last is 1)
  long long ks0, ks1, ks2;
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
  float softcap, scale;      // softcap <= 0: none
};

template <int DP> struct Smem {
  static constexpr int NP = DP / PANEL;
  static constexpr uint32_t Q_BYTES = NP * BQ * 128;
  static constexpr uint32_t KV_BYTES = NP * BK * 128;   // one K or V tile
  static constexpr size_t BYTES = Q_BYTES + 2 * NSTAGE * KV_BYTES + 1024;
};

// Order this thread's landed cp.async writes before wgmma's reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Byte offset of 16-byte chunk cc of row `row` in a swizzled tile of
// `rows` rows per 64-column panel.
__device__ __forceinline__ uint32_t sw_offset(int rows, int row, int cc) {
  return (cc / 8) * rows * 128 + row * 128 + (((cc % 8) ^ (row % 8)) << 4);
}

template <int DP, bool PAGED>
__global__ void __launch_bounds__(NTHREADS, DP > 128 ? 1 : 2)
phase1_sm90_kernel(const Params p) {
  using L = Smem<DP>;
  constexpr int CPR = DP / 8;                 // 16-byte chunks per row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + L::Q_BYTES;
  uint8_t* Vs = Ks + NSTAGE * L::KV_BYTES;

  const int g = p.Hq / p.Hkv, R = g * p.Tq;
  const int nslab = (R + BQ - 1) / BQ;
  const int per = nslab * p.B * p.Hkv;
  const int split = blockIdx.x / per;
  const int bh = blockIdx.x % per / nslab;
  const int r0 = blockIdx.x % per % nslab * BQ;      // first stacked row
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
    const int d4 = p.D / 4;
    for (int i = threadIdx.x; i < BQ * d4; i += NTHREADS) {
      const int r = r0 + i / d4;
      if (r < R)
        reinterpret_cast<float4*>(p.acc + out_row(p, b, hk, g, split, r) *
                                              p.D)[i % d4] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const int r = r0 + i;
      if (r < R) {
        const long long o = out_row(p, b, hk, g, split, r);
        p.m[o] = NEG_INF;
        p.l[o] = 0.f;
      }
    }
    return;
  }

  // ---- loads: Q once, then K/V tiles into the ring ----
  for (int i = threadIdx.x; i < BQ * CPR; i += NTHREADS) {
    const int row = i / CPR, cc = i % CPR, r = r0 + row;
    const bool ok = r < R && cc * 8 < p.D;
    const __nv_bfloat16* src = p.q;
    if (ok)
      src = p.q + b * p.qs0 + (hk * g + r / p.Tq) * p.qs1 +
            (r % p.Tq) * p.qs2 + cc * 8;
    cp_async16(Qs + sw_offset(BQ, row, cc), src, ok);
  }
  auto load_tile = [&](int it) {
    uint8_t* kd = Ks + (it % NSTAGE) * L::KV_BYTES;
    uint8_t* vd = Vs + (it % NSTAGE) * L::KV_BYTES;
    const int t0 = k_begin + it * BK;
    for (int i = threadIdx.x; i < BK * CPR; i += NTHREADS) {
      const int j = i / CPR, cc = i % CPR, t = t0 + j;
      const bool ok = t < k_end && cc * 8 < p.D;
      long long ko = 0, vo = 0;
      if (ok) key_rows<PAGED>(p, b, hk, t, ko, vo);
      const uint32_t o = sw_offset(BK, j, cc);
      cp_async16(kd + o, ok ? p.k + ko + cc * 8 : p.k, ok);
      cp_async16(vd + o, ok ? p.v + vo + cc * 8 : p.v, ok);
    }
  };
  load_tile(0);
  cp_async_commit();                         // group 0: Q and tile 0
#pragma unroll
  for (int s = 1; s < NSTAGE - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();                       // group s: tile s (or empty)
  }

  // warpgroup wg owns stacked rows r0 + 64 wg + [0, 64); this thread holds
  // rows ra and ra + 8 of them, and of each 8-column block of an
  // accumulator the columns 2 (lane % 4) + {0, 1}
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w = warp % 4;
  const int ra = 16 * w + lane / 4;
  const int row_a = r0 + WG_ROWS * wg + ra, row_b = row_a + 8;
  const bool wg_live = r0 + WG_ROWS * wg < R;
  // a row past R attends nothing (qpos -1) and is never written
  const int qa = row_a < R ? p.q_abs[b * p.Tq + row_a % p.Tq] : -1;
  const int qb = row_b < R ? p.q_abs[b * p.Tq + row_b % p.Tq] : -1;
  const int col = 2 * (lane % 4);
  const float sl = p.scale * LOG2E;          // natural -> log2 units
  const bool cap = p.softcap > 0.f;
  const float cap_in = cap ? p.scale / p.softcap : 0.f;
  const float cap_out = p.softcap * LOG2E;

  float o[DP / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // running max in log2 units (a row with no live key keeps NEG_L2) and
  // this thread's part of the row sum
  float m_a = NEG_L2, m_b = NEG_L2, l_a = 0.f, l_b = 0.f;
  const uint8_t* qw = Qs + WG_ROWS * wg * 128;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<NSTAGE - 2>();             // this thread's part of tile it
    fence_async_shared();
    __syncthreads();                         // everyone's; stage it-1 free
    if (it + NSTAGE - 1 < ntiles) load_tile(it + NSTAGE - 1);
    cp_async_commit();
    if (!wg_live) continue;

    const int t0 = k_begin + it * BK;
    const uint8_t* kt = Ks + (it % NSTAGE) * L::KV_BYTES;
    const uint8_t* vt = Vs + (it % NSTAGE) * L::KV_BYTES;
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<BK>(s, sw128_desc(qw + c * BQ * 128 + off, 16, 1024),
                   sw128_desc(kt + c * BK * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(s);

    // scores in log2 units: scale or softcap, then the mask (not needed
    // for a row that sees every key of the tile); running max
    int lo = 0, hi = 0;
    const bool span = tile_span<BK, PAGED>(p, t0, k_end, clen, lo, hi);
    const bool whole = span && hi <= min(qa, qb) &&
                       (p.window <= 0 || lo > max(qa, qb) - p.window);
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
        const int t = t0 + 8 * n + col + j;
        if (!whole && t >= k_end) {          // not part of this split
          xa = -INFINITY;
          xb = -INFINITY;
        } else if (!whole) {
          int kpos;
          const bool live = key_live<PAGED>(p, t, clen, kpos);
          if (!(live && kpos <= qa && (p.window <= 0 || kpos > qa - p.window)))
            xa = NEG_L2;
          if (!(live && kpos <= qb && (p.window <= 0 || kpos > qb - p.window)))
            xb = NEG_L2;
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
    for (int n = 0; n < DP / 8; ++n) {
      o[4 * n] *= al_a;
      o[4 * n + 1] *= al_a;
      o[4 * n + 2] *= al_b;
      o[4 * n + 3] *= al_b;
    }

    reg_fence(o);
    wg_fence();
    if constexpr (DP <= 128) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP>(o, &pa[4 * kk],
                     sw128_desc(vt + kk * 16 * 128, BK * 128, 1024));
    } else {
      // D 256: O as two 128-column halves, each an m64n128k16 over its
      // two V panels
      float(&o_lo)[64] = *reinterpret_cast<float(*)[64]>(o);
      float(&o_hi)[64] = *reinterpret_cast<float(*)[64]>(o + 64);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<128>(o_lo, &pa[4 * kk],
                      sw128_desc(vt + kk * 16 * 128, BK * 128, 1024));
        wgmma_rs<128>(o_hi, &pa[4 * kk],
                      sw128_desc(vt + 2 * BK * 128 + kk * 16 * 128,
                                 BK * 128, 1024));
      }
    }
    wg_commit();
    wg_wait_all();
    reg_fence(o);
  }

  if (!wg_live) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? row_b : row_a;
    if (r >= R) continue;
    const long long orow = out_row(p, b, hk, g, split, r);
    float* A = p.acc + orow * p.D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < p.D)
        *reinterpret_cast<float2*>(A + 8 * n + col) =
            make_float2(o[4 * n + 2 * half], o[4 * n + 2 * half + 1]);
    if (lane % 4 == 0) {
      const float mr = half ? m_b : m_a;
      // back to natural units; a row with no live key reports -1e30
      p.m[orow] = mr == NEG_L2 ? NEG_INF : mr / LOG2E;
      p.l[orow] = half ? l_b : l_a;
    }
  }
}

int check(const Params& p) {
  if (p.D < 8 || p.D > 256 || p.D % 8 != 0 || p.Hkv < 1 ||
      p.Hq % p.Hkv != 0 || p.B < 1 || p.Tq < 1 || p.ns < 1 ||
      p.nk_inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p.q) |
                          reinterpret_cast<uintptr_t>(p.k) |
                          reinterpret_cast<uintptr_t>(p.v);
  return bases % 16 ? static_cast<int>(cudaErrorMisalignedAddress) : 0;
}

template <bool PAGED>
int launch(const Params& p, cudaStream_t st) {
  const int rc = check(p);
  if (rc) return rc;
  const int g = p.Hq / p.Hkv;
  const long long nblocks = static_cast<long long>((g * p.Tq + BQ - 1) / BQ) *
                            p.B * p.Hkv * p.ns;
  if (nblocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = p.D <= 64    ? phase1_sm90_kernel<64, PAGED>
              : p.D <= 128 ? phase1_sm90_kernel<128, PAGED>
                           : phase1_sm90_kernel<256, PAGED>;
  const size_t smem = p.D <= 64    ? Smem<64>::BYTES
                      : p.D <= 128 ? Smem<128>::BYTES
                                   : Smem<256>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(nblocks), NTHREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make(const void* q, const void* k, const void* v, long long qs0,
            long long qs1, long long qs2, long long ks0, long long ks1,
            long long ks2, long long vs0, long long vs1, long long vs2,
            const int* cache_len, const int* q_abs, float* acc, float* m,
            float* l, int B, int Hq, int Hkv, int Tq, int D, int nk_inner,
            int ns, int window, float softcap, float scale) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.qs0 = qs0; p.qs1 = qs1; p.qs2 = qs2;
  p.ks0 = ks0; p.ks1 = ks1; p.ks2 = ks2;
  p.vs0 = vs0; p.vs1 = vs1; p.vs2 = vs2;
  p.cache_len = cache_len; p.q_abs = q_abs;
  p.acc = acc; p.m = m; p.l = l;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.D = D;
  p.nk_inner = nk_inner; p.ns = ns;
  p.window = window; p.softcap = softcap; p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

int cascade_phase1_dense_sm90(
    const void* q, const void* k, const void* v,
    long long qs0, long long qs1, long long qs2,
    long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2,
    const int* cache_len, const int* q_abs,
    float* acc, float* m, float* l,
    int B, int Hq, int Hkv, int Tq, int D,
    int S, int bk, int nk_inner, int ns,
    int rolling, int window, float softcap, float scale, void* stream) {
  Params p = make(q, k, v, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,
                  cache_len, q_abs, acc, m, l, B, Hq, Hkv, Tq, D, nk_inner,
                  ns, window, softcap, scale);
  p.S = S; p.bk = bk; p.rolling = rolling;
  if (S < 1 || bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

int cascade_phase1_paged_sm90(
    const void* q, const void* k, const void* v,
    long long qs0, long long qs1, long long qs2,
    long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2,
    const int* table, const int* cache_len, const int* q_abs,
    float* acc, float* m, float* l,
    int B, int Hq, int Hkv, int Tq, int D,
    int page, int mp, int n_phys, int nk_inner, int ns,
    int stride, int off, int window, float softcap, float scale,
    void* stream) {
  Params p = make(q, k, v, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,
                  cache_len, q_abs, acc, m, l, B, Hq, Hkv, Tq, D, nk_inner,
                  ns, window, softcap, scale);
  p.table = table;
  p.page = page; p.mp = mp; p.n_phys = n_phys; p.stride = stride;
  p.off = off;
  if (page < 1 || mp < 1 || n_phys < 1 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
