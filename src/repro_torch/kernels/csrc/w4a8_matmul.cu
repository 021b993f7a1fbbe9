// W4A8 matmul: int8 activations x int4-packed weights, group-wise weight
// scales, f32 epilogue.
//
// Replaces: src/repro/kernels/w4a8_matmul.py `w4a8_matmul` (Pallas
// `_kernel`), reached from core/quantization.py `_int4_matmul` at every
// prequantized qlinear site under --weight-bits 4 (qkv, o, mlp up/gate,
// down; the tied head stays W8A8).
//
//   out[m, n] = (acc[m, n] - z * colsum[n]) * s_x,   z = z_x + z_shift
//   acc[m, n] = sum over groups g, in order, of
//               float(sum_{k in g} x[m, k] * w[k, n]) * s_w[g, n]
//
// w_packed is the resident layout, row-major (K/2, N): byte p of column n
// holds w[2p, n] in its low nibble and w[2p+1, n] in its high nibble.
//
// Bound on the card: at decode (M = 4) bytes — every packed weight byte
// (0.5 byte per weight) is streamed once per step and feeds 2 M
// multiply-adds; at prefill (M = 4 * 512) operations. Design: the __dp4a
// tile mainloop of int_matmul.cuh, with the K loop nested in a loop over
// the groups. The B tile is unpacked while it is staged: a thread loads four
// packed columns of one packed row (one 32-bit word), sign-extends the
// eight nibbles in registers and stores them n-major, so that four
// consecutive k of one column form one word for __dp4a against one aligned
// word of the activation row. A group's int32 partial is exact (|x| <= 128,
// |w| <= 8); at the end of the group it is converted to f32 and added into
// the f32 accumulator with its scale.
//
// Exactness: every step rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, never a fused multiply-add), in the order above, matching the
// plain PyTorch version bit for bit. Never built with --use_fast_math.
#include "int_matmul.cuh"

extern "C" int w4a8_matmul_launch(const void* x, const void* wp,
                                  const void* sw, const void* colsum,
                                  const void* sx, const void* zx,
                                  float z_shift, void* out, int out_bf16,
                                  int M, int N, int K, int group,
                                  void* stream) {
  return int_matmul_launch<true>(x, wp, sw, colsum, sx, zx, z_shift, out,
                                 out_bf16, M, N, K, group,
                                 (cudaStream_t)stream);
}
