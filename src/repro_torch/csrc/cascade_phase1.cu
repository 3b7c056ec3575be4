// Cascade verify attention, phase 1, in float32 on the CUDA cores, for
// Hopper (sm_90a).
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
// (repro_torch/kernels/cascade_attention.py). bfloat16 inputs run on the
// tensor cores instead, in cascade_phase1_sm90.cu; these entry points take
// float32 only.
//
// What bounds it on an H100: the bytes of LIVE K/V. A verify step reads
// each committed key and value once per layer (Tq*D*2 FLOPs per byte pair
// at most ~76 query rows: below the card's ~295 FLOP/byte ridge), so the
// design aims to move no dead bytes:
//   * each split loops only over its keys below min(cache_len, S) (dense)
//     or its pages below ceil(cache_len / pos_stride) (paged) -- this is
//     what the TPU kernel's clamped index_map + DMA elision did. Dead
//     pages cost neither bytes nor FLOPs.
//   * K/V are read through the strides the caller passes, so the model's
//     [.., S, Hkv, D] storage is read in place with no transpose copy; a
//     page id is clamped to [0, n_phys-1] before it is multiplied by the
//     page stride (PAGE_SENTINEL is int32 max).
// This version is simple and exact, not fast: one thread block per
// (query tile of 16 rows, split, batch row * query head); K/V tiles of 32
// keys staged in shared memory; scores, online softmax and the accumulator
// in fp32 on the CUDA cores. A query head's block re-reads its KV head's
// tiles once per query tile and per GQA group member (L2 absorbs most of
// it at verify sizes). It stays on the CUDA cores on purpose: TF32 tensor
// cores would round the products and break the fp32 token identity.
//
// Masking follows the Pallas bodies exactly: masked in-range keys score
// -1e30 (a fully masked split therefore reports m = -1e30), rolling
// position recovery is kpos = last - rem(last - slot, S) with C's
// truncating % (jax.lax.rem) and the TRUE capacity S, and padded split
// slots (slot >= S) are dead.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 16;       // query rows per block
constexpr int BK = 32;       // keys per shared-memory tile (one per lane)
constexpr int DMAX = 128;    // largest head dim this version takes
constexpr int NT = 128;      // threads per block (4 warps)
constexpr float NEG_INF = -1e30f;

struct Params {
  const float* q;            // [B,Hq,Tq,D] contiguous, fp32, pre-scaled
  const float* k;
  const float* v;
  int64_t ks0, ks1, ks2;     // element strides of the K view (last is 1)
  int64_t vs0, vs1, vs2;
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
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool PAGED>
__global__ void __launch_bounds__(NT) phase1_kernel(const Params p) {
  __shared__ float qs[TQ][DMAX];
  __shared__ float ks[BK][DMAX + 1];   // +1: lanes read different rows
  __shared__ float vs[BK][DMAX];
  __shared__ float ps[TQ][BK];
  __shared__ float m_s[TQ], l_s[TQ], a_s[TQ];
  __shared__ int qpos_s[TQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int b = blockIdx.z / p.Hq;
  const int h = blockIdx.z % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int D = p.D;
  const int nq = min(TQ, p.Tq - q0);
  const int clen = p.cache_len[b];
  const float* K = p.k;
  const float* V = p.v;

  for (int i = tid; i < TQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    qs[r][d] = r < nq ? p.q[((int64_t)(b * p.Hq + h) * p.Tq + q0 + r) * D + d] : 0.f;
  }
  if (tid < TQ) {
    qpos_s[tid] = tid < nq ? p.q_abs[b * p.Tq + q0 + tid] : 0;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

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

  float acc[TQ];
#pragma unroll
  for (int r = 0; r < TQ; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    // ---- stage the K/V tile (fp32) ----
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i - j * D;
      const int t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < k_end) {
        int64_t ok_, ov_;
        if (PAGED) {
          const int pi = t / p.page, w = t - pi * p.page;
          int phys = pi < p.mp ? p.table[b * p.mp + pi] : p.n_phys - 1;
          phys = max(0, min(phys, p.n_phys - 1));
          ok_ = phys * p.ks0 + hk * p.ks1 + w * p.ks2 + d;
          ov_ = phys * p.vs0 + hk * p.vs1 + w * p.vs2 + d;
        } else {
          ok_ = b * p.ks0 + hk * p.ks1 + t * p.ks2 + d;
          ov_ = b * p.vs0 + hk * p.vs1 + t * p.vs2 + d;
        }
        kx = K[ok_];
        vx = V[ov_];
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    // ---- scores: lane j = key, warp w = rows w, w+4, w+8, w+12 ----
    {
      const int j = tid & 31, w = tid >> 5;
      const int t = t0 + j;
      const bool in_range = t < k_end;
      bool live = in_range;
      int kpos;
      if (PAGED) {
        const int pi = t / p.page;
        kpos = pi * p.stride + p.off + (t - pi * p.page);
      } else if (p.rolling) {
        const int last = clen - 1;
        kpos = last - (last - t) % p.S;      // C % truncates: jax.lax.rem
        live = live && kpos >= 0;
      } else {
        kpos = t;
      }
      live = live && kpos < clen;
      float sc[TQ / 4];
#pragma unroll
      for (int rr = 0; rr < TQ / 4; ++rr) sc[rr] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = ks[j][d];
#pragma unroll
        for (int rr = 0; rr < TQ / 4; ++rr) sc[rr] += qs[w + 4 * rr][d] * kd;
      }
#pragma unroll
      for (int rr = 0; rr < TQ / 4; ++rr) {
        const int r = w + 4 * rr;
        float s = sc[rr];
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        const int qp = qpos_s[r];
        bool ok = live && kpos <= qp;
        if (p.window > 0) ok = ok && kpos > qp - p.window;
        // keys past the split's live end are not part of this split
        ps[r][j] = in_range ? (ok ? s : NEG_INF) : -INFINITY;
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row ----
    {
      const int lane = tid & 31, w = tid >> 5;
      for (int r = w; r < TQ; r += 4) {
        const float x = ps[r][lane];
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(x));
        const float e = expf(x - m_new);
        const float sum = warp_sum(e);
        ps[r][lane] = e;
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          a_s[r] = a;
          l_s[r] = l_s[r] * a + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();

    // ---- accumulator: thread d owns column d of every row ----
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < TQ; ++r) acc[r] *= a_s[r];
      for (int j = 0; j < BK; ++j) {
        const float vj = vs[j][tid];
#pragma unroll
        for (int r = 0; r < TQ; ++r) acc[r] += ps[r][j] * vj;
      }
    }
    __syncthreads();
  }

  const int64_t row0 = ((int64_t)(b * p.Hq + h) * p.ns + split) * p.Tq + q0;
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < TQ; ++r)
      if (r < nq) p.acc[(row0 + r) * D + tid] = acc[r];
  }
  if (tid < nq) {
    p.m[row0 + tid] = m_s[tid];
    p.l[row0 + tid] = l_s[tid];
  }
}

template <bool PAGED>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Tq + TQ - 1) / TQ, p.ns, p.B * p.Hq);
  phase1_kernel<PAGED><<<grid, NT, 0, stream>>>(p);
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
  if (D > DMAX || D < 1 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
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
  return launch<false>(p, static_cast<cudaStream_t>(stream));
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
  if (D > DMAX || D < 1 || Hq % Hkv != 0 || n_phys < 1)
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
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
