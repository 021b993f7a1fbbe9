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
// multiply-adds; at prefill (M = 4 * 512) operations. Design: the two
// regimes of int_matmul.cuh with the nibbles unpacked in registers (two
// packed rows -> four k of a column, sign-extended with __vsub4 and
// transposed with __byte_perm) on their way to mma.sync. Every k-step lies
// inside one group; a group's int32 partial is exact (|x| <= 128,
// |w| <= 8) and is converted and scaled when it is complete: at the end of
// the group's tiles at prefill, and at decode by the last block of a
// column tile, which reads the (G, M, N) int32 workspace in group order.
//
// Exactness: every step rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, never a fused multiply-add), in the order above, s_w read in
// its stored dtype (f32 or bf16), matching the plain PyTorch version bit
// for bit. Never built with --use_fast_math.
#include "int_matmul.cuh"

// x_kind: 0 int8 codes; 1 f32 or 2 bf16 activations quantized with s_x,
// z_x in the decode staging (M <= 16 only; act_quant_static's codes).
// out_kind: 0 f32, 1 bf16, 2 the f32 accumulator acc above with no
// epilogue (colsum unread: may be null; the row-parallel sites of tensor
// parallelism sum it over the ranks and apply the epilogue once).
// ws: int_matmul_workspace_elems(M, N, K, group) int32 zeros (left zero)
extern "C" int w4a8_matmul_launch(const void* x, int x_kind, const void* wp,
                                  const void* sw, int sw_bf16,
                                  const void* colsum, const void* sx,
                                  const void* zx, float z_shift, void* out,
                                  int out_kind, int M, int N, int K,
                                  int group, void* ws, void* stream) {
  return imm::int_matmul_launch<true>(x, x_kind, wp, sw, sw_bf16, colsum,
                                      sx, zx, z_shift, out, out_kind, M, N,
                                      K, group, ws, (cudaStream_t)stream);
}
