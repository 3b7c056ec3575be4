// Device helpers shared by the tensor-core kernels for Hopper (sm_90a):
// the bf16 ones of flash_attention_sm90.cu and cascade_phase1_sm90.cu, and
// the fp32 (3xTF32) ones of cascade_phase1.cu and flash_attention.cu,
// which use the cp.async copies, the quad reductions and
// the tf32 split and product (split_tf32, mma_tf32). Both cascade sources
// take their key addressing and masking from here (key_rows, key_live,
// tile_span, out_row), templated on each file's Params and tile width.
//
// Tiles live in shared memory as 64-column panels of 128-byte rows, 128-byte
// swizzled: in each 1024-byte group of 8 rows, the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8). wgmma reads them through the descriptors below;
// an fp32 accumulator's register layout is the register-A fragment of the
// next product, so P is packed to bf16 in place (pack_bf16).
#pragma once
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 64;         // head-dim columns per swizzled panel (128 B)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A descriptor advanced by `bytes` (a multiple of 16) inside its tile: the
// start address field is the low 14 bits, which no tile here overflows.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that reads and writes them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[128 x 16]^T; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A in registers (bf16 pairs), B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
// N (4, 8 or 16) bytes from global to shared memory, or N zero bytes when
// !valid; both addresses N-byte aligned
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (N == 16) {
    cp_async16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(N), "r"(valid ? N : 0)
                 : "memory");
  }
}

// ---- 3xTF32: fp32 products on the tf32 tensor cores (the fp32 kernels of
// cascade_phase1.cu and the fp32 flash kernels of flash_attention.cu) ----

// x as big + small for the tf32 tensor cores, which read the top 19 bits
// of an operand register and ignore the low 13: big is x plus half a tf32
// ulp (so the unit reads x rounded to nearest, ties away: cvt.rna), small
// is x minus that rounded value, exact in fp32, read truncated to tf32.
// This is CUTLASS's 3xTF32 split (cutlass/tfloat32.h:
// round_half_ulp_truncate for big, its float() that clears the low 13 bits
// for x - big); tests/test_torch_cuda.py::test_tf32x3_split_rule_on_card
// and the flash twins test_flash_fwd_tf32x3_split_on_card and
// test_flash_bwd_tf32x3_split_on_card hold the unit to it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d[16 x 8] += a[16 x 8] b[8 x 8], tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the cascade phase-1 kernels' addressing and masking, for the Params
// of cascade_phase1.cu (fp32) and cascade_phase1_sm90.cu (bf16) alike ----

// Element offsets of logical key t's K and V rows for batch row b, KV head
// hk: the slot of a dense cache, or the offset in the clamped physical page
// of the table's entry.
template <bool PAGED, class P>
__device__ __forceinline__ void key_rows(const P& p, int b, int hk, int t,
                                         long long& ko, long long& vo) {
  if (PAGED) {
    const int pi = t / p.page, w = t - pi * p.page;
    int phys = pi < p.mp ? p.table[b * p.mp + pi] : p.n_phys - 1;
    phys = max(0, min(phys, p.n_phys - 1));
    ko = phys * p.ks0 + hk * p.ks1 + w * p.ks2;
    vo = phys * p.vs0 + hk * p.vs1 + w * p.vs2;
  } else {
    ko = b * p.ks0 + hk * p.ks1 + t * p.ks2;
    vo = b * p.vs0 + hk * p.vs1 + t * p.vs2;
  }
}

// Absolute position of logical key t (in the split's range) and whether it
// holds a key at all.
template <bool PAGED, class P>
__device__ __forceinline__ bool key_live(const P& p, int t, int clen,
                                         int& kpos) {
  bool live = true;
  if (PAGED) {
    const int pi = t / p.page;
    kpos = pi * p.stride + p.off + (t - pi * p.page);
  } else if (p.rolling) {
    const int last = clen - 1;
    kpos = last - (last - t) % p.S;        // C % truncates: jax.lax.rem
    live = kpos >= 0;
  } else {
    kpos = t;
  }
  return live && kpos < clen;
}

// Whether every key of the tile [t0, t0 + BK) is in the split's range and
// holds a key, and then its smallest and largest position (positions rise
// with t on a dense cache and on pages laid no closer than their size; a
// rolling buffer wraps, so its tiles are always masked key by key).
template <int BK, bool PAGED, class P>
__device__ __forceinline__ bool tile_span(const P& p, int t0, int k_end,
                                          int clen, int& lo, int& hi) {
  if (t0 + BK > k_end || (PAGED ? p.stride < p.page : p.rolling))
    return false;
  const int t1 = t0 + BK - 1;
  if (PAGED) {
    lo = t0 / p.page * p.stride + p.off + t0 % p.page;
    hi = t1 / p.page * p.stride + p.off + t1 % p.page;
  } else {
    lo = t0;
    hi = t1;
  }
  return hi < clen;
}

// Output row of stacked row r: ((b, hk*g + r / Tq), split, r % Tq).
template <class P>
__device__ __forceinline__ long long out_row(const P& p, int b, int hk,
                                             int g, int split, int r) {
  const int h = hk * g + r / p.Tq;
  return (static_cast<long long>(b * p.Hq + h) * p.ns + split) * p.Tq +
         r % p.Tq;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

}  // namespace
