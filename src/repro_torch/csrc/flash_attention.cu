// Flash attention forward and backward in float32 on the CUDA cores, for
// Hopper (sm_90a).
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
// bfloat16 inputs run all three on the tensor cores instead, in
// flash_attention_sm90.cu; these entry points refuse them.
//
// What bounds it on an H100: operations. At the training shape (T 4096,
// D 128, causal) a (b, q-head) pair does T^2/2 * D * 4 FLOPs forward on
// 2*T*D*4 input bytes: thousands of FLOPs per byte, far above the card's
// ridge. These kernels are simple and exact, not fast: fp32 on the
// CUDA cores, tiles of 64 queries x 64 keys staged in shared memory, each
// of 256 threads owning a 4 x 4 patch of the score tile and a 4 x (D/16)
// patch of its accumulator.
// What the design does for the operation count:
//   * key tiles that lie wholly past the causal edge, before the window,
//     or past kv_len are skipped, so causal attention costs half of the
//     full square;
//   * the dk/dv kernel gives one block to (key tile, KV head, row) and
//     loops over the GQA group's query heads itself, so dk/dv are summed
//     in registers and written once: no atomics (a training step is
//     deterministic) and no per-query-head [B,Hq,Tkv,D] buffer.
// They stay on the CUDA cores on purpose: TF32 tensor cores would round
// the products and break the fp32 training identity.
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

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr float NEG_INF = -1e30f;

// max / sum over the 16 lanes of a half warp (the threads of one ty row)
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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
};

// Stage rows [row0, row0 + BQ) of a [T, D] slice (row stride rs) into a
// [BQ][LD] fp32 tile, times mul; rows >= T and columns >= D read as 0.
template <int DP, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t rs,
                                      int row0, int T_, int D, float mul) {
  for (int i = threadIdx.x; i < BQ * DP; i += NT) {
    const int r = i / DP, d = i - r * DP;
    const int t = row0 + r;
    dst[r * LD + d] = (t < T_ && d < D) ? src[t * rs + d] * mul : 0.f;
  }
}

__device__ __forceinline__ bool live_key(const Params& p, int qpos, int kpos,
                                         int kvl) {
  bool ok = kpos < kvl;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Key range [kbeg, kend) a query tile [q0, q0 + nq) can see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int nq,
                                          int kvl, int& kbeg, int& kend) {
  const int qmin = q0 + p.q_offset, qmax = q0 + nq - 1 + p.q_offset;
  kend = kvl;
  if (p.causal) kend = min(kend, qmax + 1);
  kbeg = 0;
  if (p.window > 0) kbeg = max(0, qmin - p.window + 1);
  kbeg = (kbeg / BK) * BK;
}

// ------------------------------------------------------------- forward ---
template <int DP>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int LDQ = DP + 4, LDK = DP + 1, LDV = DP, LDP = BK + 1, NC = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(BQ, p.Tq - q0);
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  const float* Q = static_cast<const float*>(p.q) + b * p.qs0 + h * p.qs1;
  const float* K = static_cast<const float*>(p.k) + b * p.ks0 + hk * p.ks1;
  const float* V = static_cast<const float*>(p.v) + b * p.vs0 + hk * p.vs1;

  stage<DP, LDQ>(Qs, Q, p.qs2, q0, p.Tq, p.D, p.scale);
  int kbeg, kend;
  key_range(p, q0, nq, kvl, kbeg, kend);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();
    stage<DP, LDK>(Ks, K, p.ks2, k0, p.Tkv, p.D, 1.f);
    stage<DP, LDV>(Vs, V, p.vs2, k0, p.Tkv, p.D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * LDQ + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LDK + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const int qpos = q0 + row + p.q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool ok = row < nq && live_key(p, qpos, k0 + tx + 16 * c, kvl);
        s[r][c] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[r][c] - m_new);      // masked: exp(-inf) = 0
        Ps[row * LDP + tx + 16 * c] = e;
        sum += e;
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + group_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * LDV + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += pv[r] * vv[c];
    }
  }

  float* O = static_cast<float*>(p.o) + b * p.os0 + h * p.os1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= nq) continue;
    const float ls = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) O[(q0 + row) * p.os2 + d] = acc[r][c] / ls;
    }
    if (tx == 0)
      p.lse_out[((int64_t)b * p.Hq + h) * p.Tq + q0 + row] = m[r] + logf(ls);
  }
}

// ---------------------------------------------------------- backward dq ---
template <int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  constexpr int LDQ = DP + 4, LDK = DP + 1, LDP = BK + 1, NC = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LDQ;
  float* Ks = dOs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* dSs = Vs + BK * LDK;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(BQ, p.Tq - q0);
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  const float* Q = static_cast<const float*>(p.q) + b * p.qs0 + h * p.qs1;
  const float* dO = static_cast<const float*>(p.dout) + b * p.ds0 + h * p.ds1;
  const float* K = static_cast<const float*>(p.k) + b * p.ks0 + hk * p.ks1;
  const float* V = static_cast<const float*>(p.v) + b * p.vs0 + hk * p.vs1;
  const int64_t rbase = ((int64_t)b * p.Hq + h) * p.Tq + q0;

  stage<DP, LDQ>(Qs, Q, p.qs2, q0, p.Tq, p.D, p.scale);
  stage<DP, LDQ>(dOs, dO, p.ds2, q0, p.Tq, p.D, 1.f);
  float lse[4], dlt[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    lse[r] = row < nq ? p.lse_in[rbase + row] : 0.f;
    dlt[r] = row < nq ? p.delta[rbase + row] : 0.f;
  }
  int kbeg, kend;
  key_range(p, q0, nq, kvl, kbeg, kend);

  float dq[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();
    stage<DP, LDK>(Ks, K, p.ks2, k0, p.Tkv, p.D, 1.f);
    stage<DP, LDK>(Vs, V, p.vs2, k0, p.Tkv, p.D, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = Qs[(ty * 4 + r) * LDQ + d];
        ov[r] = dOs[(ty * 4 + r) * LDQ + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = Ks[(tx + 16 * c) * LDK + d];
        vv[c] = Vs[(tx + 16 * c) * LDK + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] += qv[r] * kv[c];
          dp[r][c] += ov[r] * vv[c];
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const int qpos = q0 + row + p.q_offset;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c], dcap = 1.f;
        if (p.softcap > 0.f) {
          const float t = tanhf(x / p.softcap);
          x = p.softcap * t;
          dcap = 1.f - t * t;
        }
        const bool ok = row < nq && live_key(p, qpos, k0 + tx + 16 * c, kvl);
        const float pr = ok ? expf(x - lse[r]) : 0.f;
        dSs[row * LDP + tx + 16 * c] = pr * (dp[r][c] - dlt[r]) * dcap;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[4], kv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = dSs[(ty * 4 + r) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[j * LDK + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[r][c] += sv[r] * kv[c];
    }
  }

  float* dQ = static_cast<float*>(p.o) + b * p.os0 + h * p.os1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= nq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) dQ[(q0 + row) * p.os2 + d] = dq[r][c] * p.scale;
    }
  }
}

// --------------------------------------------------------- backward dkv ---
template <int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LDK = DP + 4, LDQ = DP + 1, LDP = BQ + 1, NC = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LDK;
  float* Qs = Vs + BK * LDK;
  float* dOs = Qs + BQ * LDQ;
  float* Ps = dOs + BQ * LDQ;          // P^T, then dS^T: [BK][LDP]
  float* lse_s = Ps + BK * LDP;        // [BQ]
  float* dlt_s = lse_s + BQ;           // [BQ]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BK;      // the longest (causal) tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  const int kvl = max(0, min(p.Tkv, p.kv_len[b]));
  const float* K = static_cast<const float*>(p.k) + b * p.ks0 + hk * p.ks1;
  const float* V = static_cast<const float*>(p.v) + b * p.vs0 + hk * p.vs1;

  stage<DP, LDK>(Ks, K, p.ks2, k0, p.Tkv, p.D, 1.f);
  stage<DP, LDK>(Vs, V, p.vs2, k0, p.Tkv, p.D, 1.f);

  // query rows [ibeg, iend) that can see a key of this tile
  const int kmax = min(k0 + BK, kvl) - 1;
  int ibeg = 0, iend = p.Tq;
  if (p.causal) ibeg = max(0, k0 - p.q_offset);
  if (p.window > 0) iend = min(iend, kmax - p.q_offset + p.window);
  if (kmax < k0) iend = ibeg;          // no live key in the tile
  const int qt_beg = ibeg / BQ;
  const int qt_end = iend > ibeg ? (iend + BQ - 1) / BQ : qt_beg;

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const float* Q = static_cast<const float*>(p.q) + b * p.qs0 + h * p.qs1;
    const float* dO = static_cast<const float*>(p.dout) + b * p.ds0 + h * p.ds1;
    const int64_t rbase = ((int64_t)b * p.Hq + h) * p.Tq;
    for (int qt = qt_beg; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      stage<DP, LDQ>(Qs, Q, p.qs2, q0, p.Tq, p.D, p.scale);
      stage<DP, LDQ>(dOs, dO, p.ds2, q0, p.Tq, p.D, 1.f);
      if (tid < BQ) {
        const bool in = q0 + tid < p.Tq;
        lse_s[tid] = in ? p.lse_in[rbase + q0 + tid] : 0.f;
        dlt_s[tid] = in ? p.delta[rbase + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows = this thread's keys, columns = its queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kv[r] = Ks[(ty * 4 + r) * LDK + d];
          vv[r] = Vs[(ty * 4 + r) * LDK + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = Qs[(tx + 16 * c) * LDQ + d];
          ov[c] = dOs[(tx + 16 * c) * LDQ + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] += kv[r] * qv[c];
            dp[r][c] += vv[r] * ov[c];
          }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = tx + 16 * c;
          float x = s[r][c], dcap = 1.f;
          if (p.softcap > 0.f) {
            const float t = tanhf(x / p.softcap);
            x = p.softcap * t;
            dcap = 1.f - t * t;
          }
          const bool ok = q0 + i < p.Tq &&
                          live_key(p, q0 + i + p.q_offset, kpos, kvl);
          const float pr = ok ? expf(x - lse_s[i]) : 0.f;
          Ps[(ty * 4 + r) * LDP + i] = pr;
          s[r][c] = pr * (dp[r][c] - dlt_s[i]) * dcap;   // dS^T
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {                   // dV += P^T dO
        float pv[4], ov[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * LDP + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) ov[c] = dOs[i * LDQ + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) dv[r][c] += pv[r] * ov[c];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) Ps[(ty * 4 + r) * LDP + tx + 16 * c] = s[r][c];
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {                   // dK += dS^T (q*scale)
        float sv[4], qv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = Ps[(ty * 4 + r) * LDP + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) qv[c] = Qs[i * LDQ + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) dk[r][c] += sv[r] * qv[c];
      }
    }
  }

  float* dK = static_cast<float*>(p.o) + b * p.os0 + hk * p.os1;
  float* dV = static_cast<float*>(p.o2) + b * p.o2s0 + hk * p.o2s1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = k0 + ty * 4 + r;
    if (t >= p.Tkv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) {
        dK[t * p.os2 + d] = dk[r][c];
        dV[t * p.o2s2 + d] = dv[r][c];
      }
    }
  }
}

// ----------------------------------------------------------- launching ---
template <int DP> constexpr size_t fwd_smem() {
  return sizeof(float) * (BQ * (DP + 4) + BK * (DP + 1) + BK * DP + BQ * (BK + 1));
}
template <int DP> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (DP + 4) + 2 * BK * (DP + 1) + BQ * (BK + 1));
}
template <int DP> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * BK * (DP + 4) + 2 * BQ * (DP + 1) + BK * (BQ + 1) + 2 * BQ);
}

template <typename Kern>
int launch(Kern kern, dim3 grid, size_t smem, const Params& p, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, NT, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

enum Which { FWD, DQ, DKV };

template <int DP>
int dispatch(Which w, const Params& p, cudaStream_t st) {
  const dim3 gq((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  const dim3 gk((p.Tkv + BK - 1) / BK, p.Hkv, p.B);
  if (w == FWD) return launch(flash_fwd_kernel<DP>, gq, fwd_smem<DP>(), p, st);
  if (w == DQ) return launch(flash_bwd_dq_kernel<DP>, gq, dq_smem<DP>(), p, st);
  return launch(flash_bwd_dkv_kernel<DP>, gk, dkv_smem<DP>(), p, st);
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
