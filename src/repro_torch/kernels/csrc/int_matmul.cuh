// The mainloop that the two int8-activation matmuls share (w8a8_matmul.cu,
// w4a8_matmul.cu), in two regimes chosen by M inside int_matmul_launch.
//
// Prefill and chunks (M > 16): bound by operations (M = 2048: ~2-10 GOP a
// call). 128 x 128 output tiles, 8 warps of 64 x 32, on the int8 tensor
// cores (mma.sync m16n8k32, s8 x s8 -> s32). The K loop walks 32-deep
// tiles through four shared-memory stages filled by cp.async in 16-byte
// copies, three tiles in flight ahead of the MMAs. A (row-major,
// K-contiguous) feeds ldmatrix (an int8 16 x 32 tile has the byte layout
// of a b16 16 x 16 one). B is (K, N) N-contiguous and is staged raw; the
// .col B fragment wants 4 consecutive k of one column in a register, so
// each lane reads one 32-bit word (4 columns) from each of the 4 k rows of
// a k-word (W8A8) or the 2 packed rows (W4A8, nibbles sign-extended with
// __vsub4) and transposes the 4 x 4 byte block with __byte_perm: lane
// group j's 4 columns feed n8 tiles 0..3, so n8 tile c holds columns
// {4 j + c}, a permutation undone at the store. B's 16-byte chunks are
// XOR-swizzled by k-word so these reads are conflict-free. The epilogue
// reads its column sums and scales before any store and writes four
// consecutive outputs a store. W4A8 with more than one group keeps the
// finished groups in f32 registers (FOLD: one block a SM); one group is
// scaled at the end, at W8A8's register count (two blocks a SM). At these
// tiles the L2-to-SM traffic of the re-read A and B rows costs about as
// much as the MMAs (tools/kernel_variants.py); larger tiles, wgmma and TMA
// are later work: wgmma takes int8 B K-major from shared memory and TMA
// cannot transpose bytes, so both want the resident weight stored
// (N, K) / (N, K/2).
//
// Decode (M <= 16): bound by bytes (each weight byte feeds M products).
// Split-K weight streaming over the whole card: a block of 4 warps takes
// 128 columns and a slice of at most 32 k-steps of 32 inside one group;
// the slice is sized so the call has ~2 blocks per SM. A's rows of the slice
// sit in shared memory, zero-padded to 16 rows. Each lane loads 16 columns
// of the k rows that its B fragment needs (16-byte ld.global.nc, two
// k-steps in flight: 256 bytes a lane for W8A8), transposes them in
// registers and feeds them to mma.sync straight from the registers: lane
// group j of the warp loads column block j, so n8 tile c of the MMA holds
// columns {16 j + c}, a permutation undone at the store. The warps' int32
// partials meet in shared memory; a slice of a split column tile adds them
// into an int32 workspace (G, M, N) with atomics, takes a ticket, and the
// last block of the tile runs the epilogue (a thread a column, the
// partials read four rows and eight groups at a time), zeroes its
// workspace entries and its ticket: one launch per call. A tile with one
// slice finishes straight from shared memory. What a call costs beyond
// the bytes is mostly latency: the launch, one round trip for the weight
// and one for the merge (tools/kernel_variants.py times each).
//
// The decode regime also takes A as the f32 or bf16 activation (x_kind 1
// or 2) with its static s_x and z_x, and quantizes it while it stages the
// slice (act_quant_static's arithmetic, act_quant.cuh): the standalone
// quantizer's launch goes away. Its loads of x (16- or 8-byte vectors where
// x is aligned) and its divisions run behind the first two k-steps' weight
// loads, already in flight. Every column tile's blocks quantize their
// slice of A again: a call does M x K x ceil(N / 128) divisions in all
// (M = 4: ~0.05 M for qkv, 1.5 M for the tied head), at most M x 1024 a
// block, against a weight slice of at least 4 KB a block
// (tools/kernel_variants.py times the fused call against int8 A). Padding
// past M and past the group's end stays the int8 zero, as for int8 A.
//
// Exactness: int32 addition is exact in any order, so no split, tile or
// regime changes a row's bits. Every k-step lies inside one group (a step
// that crosses the group's end is masked with zeros), so a group's int32
// partial is complete before it is converted; W8A8 dequantizes once,
// (acc - z * colsum) * (s_x * s_w); W4A8 adds float(partial_g) * s_w[g] in
// group order, then (acc - z * colsum_scaled) * s_x. Every f32 step rounds
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, never a fused multiply-add),
// matching the plain PyTorch versions bit for bit. Never built with
// --use_fast_math. s_w is read in its stored dtype (f32 or bf16, converted
// exactly). Ragged M and N are masked; K and the group are multiples of 4
// (checked by the wrappers), with vector paths where alignment allows.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace imm {

// prefill tiles
constexpr int P_BM = 128, P_BN = 128, P_BK = 32, P_THREADS = 256;
constexpr int P_STAGES = 4;
constexpr int P_ALD = P_BK + 16;         // A row stride in bytes
// decode slices
// the decode regime (and its quantizing staging) takes at most this many
// rows: one m16 MMA tile
constexpr int D_MAX_M = 16;
constexpr int D_NW = 4, D_THREADS = 32 * D_NW, D_BN = 128, D_MAXCS = 32;
constexpr int D_ALD = 32 * D_MAXCS + 16;  // A row stride in bytes
constexpr int D_TARGET_BLOCKS = 264;      // two a SM
static_assert(D_THREADS == D_BN, "the decode epilogue: a thread a column");

__device__ __forceinline__ float ld_scale(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// rows r0..r3 (byte j = column j) -> c[j] = column j (byte i = row i)
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t* c) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// every byte in [0, 15] -> its nibble sign-extended
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

// packed rows p0 (k, k + 1) and p1 (k + 2, k + 3), four columns each ->
// c[j] = column j's four k, sign-extended
__device__ __forceinline__ void unpack4(uint32_t p0, uint32_t p1,
                                        uint32_t* c) {
  transpose4(sext_nibbles(p0 & 0x0F0F0F0Fu),
             sext_nibbles((p0 >> 4) & 0x0F0F0F0Fu),
             sext_nibbles(p1 & 0x0F0F0F0Fu),
             sext_nibbles((p1 >> 4) & 0x0F0F0F0Fu), c);
}

// 16 bytes of row `src` from column n on (columns >= N read as 0)
__device__ __forceinline__ uint4 load16(const int8_t* src, int n, int N,
                                        bool vec) {
  if (vec && n + 16 <= N) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n + j < N) v[j / 4] |= (uint32_t)(uint8_t)src[j] << (8 * (j % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// c += a (16 x 32, row) . b (32 x 8, col), s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue's operands are read before any output is stored (the
// kernels' restrict-qualified pointers keep the compiler from serializing
// each load behind the previous store).
template <bool PACKED>
__device__ __forceinline__ float colsum_at(const void* colsum, int n) {
  if constexpr (PACKED) return static_cast<const float*>(colsum)[n];
  else return __int2float_rn(static_cast<const int*>(colsum)[n]);
}

// One output: W8A8 from the int32 sum, (acc - z * colsum) * (s_x * s_w);
// W4A8 from the f32 sum of the scaled group partials,
// (facc - z * colsum_scaled) * s_x.
template <bool PACKED>
__device__ __forceinline__ float dequant(int acc, float facc, float z,
                                         float scale, float cs) {
  const float a = PACKED ? facc : __int2float_rn(acc);
  return __fmul_rn(__fsub_rn(a, __fmul_rn(z, cs)), scale);
}

// W8A8 forms s_x * s_w first
template <bool PACKED>
__device__ __forceinline__ float out_scale(const float* sx, const void* sw,
                                           int sw_bf16) {
  return PACKED ? *sx : __fmul_rn(*sx, ld_scale(sw, 0, sw_bf16));
}

__device__ __forceinline__ void store1(void* __restrict__ out, int bf16,
                                       size_t i, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// four consecutive outputs of row m from column n (vec: 8 / 16-byte
// aligned rows)
__device__ __forceinline__ void store4(void* __restrict__ out, int bf16,
                                       int m, int n, int N, bool vec,
                                       const float* v) {
  const size_t i = (size_t)m * N + n;
  if (vec && n + 4 <= N) {
    if (bf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) = u;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) store1(out, bf16, i + j, v[j]);
}

// W8A8's int32 output mode (out_kind 2): the accumulators, no epilogue
__device__ __forceinline__ void store4i(void* __restrict__ out, int m, int n,
                                        int N, bool vec, const int* a) {
  int* o = static_cast<int*>(out) + (size_t)m * N + n;
  if (vec && n + 4 <= N) {
    *reinterpret_cast<int4*>(o) = make_int4(a[0], a[1], a[2], a[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) o[j] = a[j];
}

// ---------------------------------------------------------------------------
// Regime 1: M > 16, tensor-core tiles
// ---------------------------------------------------------------------------

// FOLD: W4A8 with more than one group, whose finished groups are kept in
// f32 accumulators (twice the registers); one group is scaled at the end.
template <bool PACKED, bool FOLD>
__global__ void __launch_bounds__(P_THREADS, 1)
int_matmul_mma(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const void* __restrict__ sw, int sw_bf16,
               const void* __restrict__ colsum, const float* __restrict__ sx,
               const float* __restrict__ zx, float z_shift,
               void* __restrict__ out, int out_kind, int M, int N, int K,
               int group) {
  // per stage: A (BM rows of BK bytes, padded) and B's raw rows (BK int8
  // rows or BK / 2 packed rows of BN bytes, 16-byte chunks swizzled)
  __shared__ __align__(16) int8_t As[P_STAGES][P_BM * P_ALD];
  __shared__ __align__(16) uint32_t Bs[P_STAGES][P_BK * P_BN / 4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g8 = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * P_BM, n0 = blockIdx.x * P_BN;
  const int tpg = (group + P_BK - 1) / P_BK;   // tiles per group
  const int T = (K / group) * tpg;
  const bool a16 = (K % 16 == 0) && (group % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool b16 = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);

  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        facc[i][j][e] = 0.0f;
      }

  auto load_tile = [&](int t, int st) {
    const int g = t / tpg;
    const int k0 = g * group + (t - g * tpg) * P_BK;
    const int kend = min(k0 + P_BK, (g + 1) * group);
    {  // A: one 16-byte chunk a thread
      const int r = tid >> 1, c = tid & 1;
      const int m = m0 + r, k = k0 + 16 * c;
      int8_t* dst = &As[st][r * P_ALD + 16 * c];
      const int8_t* src = x + (size_t)m * K + k;
      if (a16 && m < M && k + 16 <= kend) {
        cp_async16(dst, src, 16);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = m < M && k + 4 * j < kend;
          cp_async4(dst + 4 * j, ok ? src + 4 * j : x, ok ? 4 : 0);
        }
      }
    }
    // B: raw rows, chunk c of row r at chunk c ^ 2 ((r / RK) & 3), RK rows
    // per k-word
    constexpr int BR = PACKED ? P_BK / 2 : P_BK, RK = PACKED ? 2 : 4;
    if (tid < BR * (P_BN / 16)) {
      const int r = tid >> 3, c = tid & 7;
      const int k = k0 + (PACKED ? 2 * r : r);
      const size_t row = PACKED ? (size_t)(k / 2) : (size_t)k;
      const int n = n0 + 16 * c;
      int8_t* dst = reinterpret_cast<int8_t*>(Bs[st]) + r * P_BN +
                    16 * (c ^ (2 * ((r / RK) & 3)));
      const int8_t* src = w + row * N + n;
      if (b16) {
        const bool ok = k < kend && n < N;
        cp_async16(dst, ok ? src : w, ok ? 16 : 0);
      } else {
        // ragged or unaligned N: byte loads, stored before the barrier
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (k < kend && n + j < N) ? src[j] : (int8_t)0;
      }
    }
  };

  auto compute = [&](int st) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldmatrix_x4(af[i], &As[st][(wm * 64 + i * 16 + (lane & 15)) * P_ALD +
                                 (lane >> 4) * 16]);
    // lane (g8, q) takes k-words q and q + 4 of columns 4 g8 .. 4 g8 + 3 of
    // the warp's 32: n8 tile j holds columns {4 g8 + j}
    const int wc = wn * 8 + g8;                 // word column in a row
    const int col = (((wc >> 2) ^ (2 * q)) << 2) + (wc & 3);
    const uint32_t* b = Bs[st];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t c4[4];
      const int kw = q + 4 * h;
      if constexpr (PACKED) {
        unpack4(b[(2 * kw) * (P_BN / 4) + col],
                b[(2 * kw + 1) * (P_BN / 4) + col], c4);
      } else {
        transpose4(b[(4 * kw) * (P_BN / 4) + col],
                   b[(4 * kw + 1) * (P_BN / 4) + col],
                   b[(4 * kw + 2) * (P_BN / 4) + col],
                   b[(4 * kw + 3) * (P_BN / 4) + col], c4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) bf[j][h] = c4[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
  };

  // output column of n8 tile j, fragment column e
  auto out_col = [&](int j, int e) {
    return n0 + wn * 32 + 4 * (2 * q + e) + j;
  };

#pragma unroll
  for (int s = 0; s < P_STAGES - 1; ++s) {
    if (s < T) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<P_STAGES - 2>();
    __syncthreads();
    const int nt = t + P_STAGES - 1;
    if (nt < T) load_tile(nt, nt % P_STAGES);
    cp_async_commit();
    compute(t % P_STAGES);
    if constexpr (FOLD) {
      if ((t + 1) % tpg == 0) {
        // end of the group: scale its exact partial and add it in order
        const size_t g = t / tpg;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = out_col(j, e);
            const float s = n < N ? ld_scale(sw, g * N + n, sw_bf16) : 0.0f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int qq = 2 * h + e;
                facc[i][j][qq] = __fadd_rn(
                    facc[i][j][qq],
                    __fmul_rn(__int2float_rn(acc[i][j][qq]), s));
                acc[i][j][qq] = 0;
              }
          }
      }
    }
  }

  const float z = __fadd_rn(*zx, z_shift);
  const float scale = out_scale<PACKED>(sx, sw, sw_bf16);
  float cs[4][2], s1[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = out_col(j, e);
      // (the int32 mode reads no colsum: it may be null)
      cs[j][e] = (n < N && out_kind != 2) ? colsum_at<PACKED>(colsum, n)
                                          : 0.0f;
      s1[j][e] = (PACKED && !FOLD && n < N) ? ld_scale(sw, n, sw_bf16)
                                             : 0.0f;
    }
  const int out_bf16 = out_kind == 1;
  const int align = out_bf16 ? 8 : 16;
  const bool vec = (N % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % align == 0);
  // n8 tiles 0..3 of fragment column e are four consecutive columns
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * 64 + i * 16 + g8 + hh * 8;
      if (m >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (!PACKED) {
          if (out_kind == 2) {
            int a4[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) a4[j] = acc[i][j][2 * hh + e];
            store4i(out, m, out_col(0, e), N, vec, a4);
            continue;
          }
        }
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = acc[i][j][2 * hh + e];
          // one group: its partial scaled as the fold would (0 + p s)
          const float f =
              FOLD ? facc[i][j][2 * hh + e]
                   : __fadd_rn(0.0f, __fmul_rn(__int2float_rn(a), s1[j][e]));
          // W4A8's accumulator mode (out_kind 2): the f32 sum, no epilogue
          v[j] = (PACKED && out_kind == 2)
                     ? f : dequant<PACKED>(a, f, z, scale, cs[j][e]);
        }
        store4(out, out_bf16, m, out_col(0, e), N, vec, v);
      }
    }
}

// ---------------------------------------------------------------------------
// Regime 2: M <= 16, split-K weight streaming
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t part(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Four activations of a row from p on, as one word of int8 codes: int8 A
// as it is; f32 or bf16 A quantized (vec: p aligned to the 4 elements)
template <typename XT>
__device__ __forceinline__ uint32_t a_word(const XT* p, bool vec, float s,
                                           float z) {
  if constexpr (sizeof(XT) == 1) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    float f[4];
    if (!vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = aq::to_f32(p[j]);
    } else if constexpr (sizeof(XT) == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      f[0] = u.x;
      f[1] = u.y;
      f[2] = u.z;
      f[3] = u.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      f[0] = __uint_as_float(u.x << 16);
      f[1] = __uint_as_float(u.x & 0xFFFF0000u);
      f[2] = __uint_as_float(u.y << 16);
      f[3] = __uint_as_float(u.y & 0xFFFF0000u);
    }
    return aq::pack4(aq::code_bits<false>(f[0], s, z, 255.0f),
                     aq::code_bits<false>(f[1], s, z, 255.0f),
                     aq::code_bits<false>(f[2], s, z, 255.0f),
                     aq::code_bits<false>(f[3], s, z, 255.0f));
  }
}

// One k-step (32 k) of this lane's B fragments: 16 columns from n, the
// words of k-words q (b0) and q + 4 (b1) of the step.
template <bool PACKED>
struct StepB {
  static constexpr int R = PACKED ? 2 : 4;   // rows a k-word spans
  uint4 raw[2][R];

  __device__ __forceinline__ void load(const int8_t* w, int k0, int kend,
                                       int q, int n, int N, bool vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 16 * h + 4 * q;
      const bool ok = k < kend;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t row = PACKED ? (size_t)(k / 2 + r) : (size_t)(k + r);
        raw[h][r] = ok ? load16(w + row * N + n, n, N, vec)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // words[h][c]: column c's four k of k-word (q + 4 h)
  __device__ __forceinline__ void words(uint32_t (*wd)[16]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (PACKED)
          unpack4(part(raw[h][0], i), part(raw[h][1], i), &wd[h][4 * i]);
        else
          transpose4(part(raw[h][0], i), part(raw[h][1], i),
                     part(raw[h][2], i), part(raw[h][3], i), &wd[h][4 * i]);
      }
  }
};

// XT: int8 codes, or the f32 / bf16 activation quantized while staged
template <bool PACKED, typename XT>
__global__ void __launch_bounds__(D_THREADS)
int_matmul_stream(const XT* __restrict__ x, const int8_t* __restrict__ w,
                  const void* __restrict__ sw, int sw_bf16,
                  const void* __restrict__ colsum,
                  const float* __restrict__ sx, const float* __restrict__ zx,
                  float z_shift, void* __restrict__ out, int out_kind, int M,
                  int N, int K, int group, int cs, int cpg,
                  int* __restrict__ ws) {
  __shared__ __align__(16) int8_t As[16 * D_ALD];
  __shared__ int red[16 * D_BN];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, g = blockIdx.y / cpg, c = blockIdx.y % cpg;
  const int G = K / group;
  const int n0 = tile * D_BN;
  const int spg = (group + 31) / 32;                  // k-steps per group
  const int s0 = c * cs, s1 = min(s0 + cs, spg);       // this slice's steps
  const int gk0 = g * group, gk1 = gk0 + group;
  const int kb = gk0 + 32 * s0, ke = min(gk0 + 32 * s1, gk1);
  const bool vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int q = lane & 3, n = n0 + 16 * (lane >> 2);

  // the first two k-steps' weight loads go out before A is staged
  StepB<PACKED> bx, by;
  int s = s0 + warp;
  if (s < s1)
    bx.load(w, gk0 + 32 * s, min(gk0 + 32 * s + 32, gk1), q, n, N, vec);
  if (s + D_NW < s1)
    by.load(w, gk0 + 32 * (s + D_NW), min(gk0 + 32 * (s + D_NW) + 32, gk1),
            q, n, N, vec);

  // the slice of A's rows (quantized from f32 / bf16), zero past M and
  // past the group's end
  const int words = (s1 - s0) * 8;
  float qs = 0.0f, qz = 0.0f;
  if constexpr (sizeof(XT) > 1) {
    qs = *sx;
    qz = *zx;
  }
  const bool xvec =
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(XT)) == 0;
  const int n_live = M * words;
#pragma unroll 4
  for (int i = tid; i < n_live; i += D_THREADS) {
    const int r = i / words, cw = i - r * words;
    const int k = kb + 4 * cw;
    const uint32_t v = k < ke ? a_word(x + (size_t)r * K + k, xvec, qs, qz)
                              : 0u;
    *reinterpret_cast<uint32_t*>(&As[r * D_ALD + 4 * cw]) = v;
  }
  for (int i = n_live + tid; i < 16 * words; i += D_THREADS) {
    const int r = i / words, cw = i - r * words;
    *reinterpret_cast<uint32_t*>(&As[r * D_ALD + 4 * cw]) = 0u;
  }
  for (int i = tid; i < 16 * D_BN; i += D_THREADS) red[i] = 0;
  __syncthreads();

  int acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  auto step = [&](const StepB<PACKED>& b, int st) {
    uint32_t af[4], wd[2][16];
    ldmatrix_x4(af, &As[(lane & 15) * D_ALD + (st - s0) * 32 +
                        (lane >> 4) * 16]);
    b.words(wd);
#pragma unroll
    for (int j = 0; j < 16; ++j) mma_s8(acc[j], af, wd[0][j], wd[1][j]);
  };

  for (; s < s1; s += 2 * D_NW) {
    step(bx, s);
    if (s + D_NW < s1) step(by, s + D_NW);
    const int sa = s + 2 * D_NW, sb = s + 3 * D_NW;
    if (sa < s1)
      bx.load(w, gk0 + 32 * sa, min(gk0 + 32 * sa + 32, gk1), q, n, N, vec);
    if (sb < s1)
      by.load(w, gk0 + 32 * sb, min(gk0 + 32 * sb + 32, gk1), q, n, N, vec);
  }

  // the warps' partials meet in shared memory; n8 tile j, column e of the
  // fragment, is local column 16 (2 q + e) + j
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (lane >> 2) + 8 * (e >> 1);
      if (r < M) atomicAdd(&red[r * D_BN + 16 * (2 * q + (e & 1)) + j],
                           acc[j][e]);
    }
  __syncthreads();

  const float z = __fadd_rn(*zx, z_shift);
  const float scale = out_scale<PACKED>(sx, sw, sw_bf16);
  const int out_bf16 = out_kind == 1;
  const bool out_acc = !PACKED && out_kind == 2;   // int32 accumulators
  const bool out_facc = PACKED && out_kind == 2;   // W4A8's f32 sum
  const int nn = n0 + tid;                     // this thread's column
  const bool live = nn < N;
  const float csum =
      (live && out_kind != 2) ? colsum_at<PACKED>(colsum, nn) : 0.0f;
  const int total = G * cpg;
  if (total == 1) {
    if (live) {
      const float s_g = PACKED ? ld_scale(sw, nn, sw_bf16) : 0.0f;
      for (int r = 0; r < M; ++r) {
        const int a = red[r * D_BN + tid];
        const float f =
            PACKED ? __fadd_rn(0.0f, __fmul_rn(__int2float_rn(a), s_g)) : 0.0f;
        if (out_acc)
          static_cast<int*>(out)[(size_t)r * N + nn] = a;
        else
          store1(out, out_bf16, (size_t)r * N + nn,
                 out_facc ? f : dequant<PACKED>(a, f, z, scale, csum));
      }
    }
    return;
  }

  // split tile: add into the workspace, the last block finishes
  int* tickets = ws + (size_t)G * M * N;
  if (live)
    for (int r = 0; r < M; ++r)
      atomicAdd(&ws[((size_t)g * M + r) * N + nn], red[r * D_BN + tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(&tickets[tile], 1) == total - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  if (live) {
    // the (G, M) partials of this column, four rows and eight groups a
    // batch (32 loads in flight), added in group order (W8A8: one group)
    const size_t gstride = (size_t)M * N;
    for (int r0 = 0; r0 < M; r0 += 4) {
      int* pw = ws + (size_t)r0 * N + nn;
      int a[4] = {0, 0, 0, 0};
      float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int g0 = 0; g0 < G; g0 += 8) {
        int part[8][4];
        float s_g[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const bool okg = g0 + u < G;
          s_g[u] = (PACKED && okg)
                       ? ld_scale(sw, (size_t)(g0 + u) * N + nn, sw_bf16)
                       : 0.0f;
#pragma unroll
          for (int v = 0; v < 4; ++v)
            part[u][v] = (okg && r0 + v < M)
                             ? __ldcg(pw + (g0 + u) * gstride + (size_t)v * N)
                             : 0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (g0 + u >= G) break;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (r0 + v >= M) break;
            pw[(g0 + u) * gstride + (size_t)v * N] = 0;
            if constexpr (PACKED)
              f[v] = __fadd_rn(
                  f[v], __fmul_rn(__int2float_rn(part[u][v]), s_g[u]));
            else
              a[v] = part[u][v];
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (r0 + v >= M) continue;
        if (out_acc)
          static_cast<int*>(out)[(size_t)(r0 + v) * N + nn] = a[v];
        else
          store1(out, out_bf16, (size_t)(r0 + v) * N + nn,
                 out_facc ? f[v]
                          : dequant<PACKED>(a[v], f[v], z, scale, csum));
      }
    }
  }
  if (tid == 0) tickets[tile] = 0;
}

// int32 elements of the decode regime's workspace (partials and tickets)
static long long workspace_elems(int M, int N, int K, int group) {
  if (M > D_MAX_M || group <= 0) return 0;
  return (long long)(K / group) * M * N + (N + D_BN - 1) / D_BN;
}

// the regime for M: tensor-core tiles above 16 rows, split-K streaming at
// or below. x_kind: 0 int8 codes; 1 f32 or 2 bf16 activations, quantized
// in the decode regime's staging (M <= 16 only). out_kind: 0 f32, 1 bf16,
// 2 the accumulators with no epilogue: W8A8's int32 sums, W4A8's f32 sums
// of the scaled group partials (the row-parallel sites of tensor
// parallelism sum them over the ranks first; colsum and z_shift are then
// not read, nor W8A8's scales). ws: workspace_elems int32 zeros (the decode
// regime leaves them zero).
template <bool PACKED>
static int int_matmul_launch(const void* x, int x_kind, const void* w,
                             const void* sw, int sw_bf16, const void* colsum,
                             const void* sx, const void* zx, float z_shift,
                             void* out, int out_kind, int M, int N, int K,
                             int group, void* ws, cudaStream_t st) {
  if (x_kind < 0 || x_kind > 2 || (x_kind != 0 && M > D_MAX_M))
    return (int)cudaErrorInvalidValue;
  if (out_kind < 0 || out_kind > 2) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if (M > D_MAX_M) {
    dim3 grid((N + P_BN - 1) / P_BN, (M + P_BM - 1) / P_BM);
    auto kernel = int_matmul_mma<PACKED, false>;
    if constexpr (PACKED)
      if (K / group > 1) kernel = int_matmul_mma<true, true>;
    kernel<<<grid, P_THREADS, 0, st>>>(
        (const int8_t*)x, (const int8_t*)w, sw, sw_bf16, colsum,
        (const float*)sx, (const float*)zx, z_shift, out, out_kind, M, N, K,
        group);
  } else {
    const int tiles = (N + D_BN - 1) / D_BN, G = K / group;
    const int spg = (group + 31) / 32;
    const long long work = (long long)tiles * G * spg;
    int cs = (int)((work + D_TARGET_BLOCKS - 1) / D_TARGET_BLOCKS);
    cs = (cs + D_NW - 1) / D_NW * D_NW;
    cs = cs < D_NW ? D_NW : (cs > D_MAXCS ? D_MAXCS : cs);
    if (cs > spg) cs = spg;
    const int cpg = (spg + cs - 1) / cs;
    dim3 grid(tiles, G * cpg);
    auto launch = [&](auto xt) {
      using XT = decltype(xt);
      int_matmul_stream<PACKED, XT><<<grid, D_THREADS, 0, st>>>(
          (const XT*)x, (const int8_t*)w, sw, sw_bf16, colsum,
          (const float*)sx, (const float*)zx, z_shift, out, out_kind, M, N,
          K, group, cs, cpg, (int*)ws);
    };
    if (x_kind == 0) launch(int8_t{});
    else if (x_kind == 1) launch(float{});
    else launch(__nv_bfloat16{});
  }
  return (int)cudaGetLastError();
}

}  // namespace imm
