// W8A8 per-tensor-static matmul: int8 x int8 -> int32, f32 epilogue.
//
// Replaces: src/repro/kernels/w8a8_matmul.py `w8a8_matmul` (Pallas
// `_kernel`), reached from core/quantization.py `_int8_matmul` at every
// qlinear site (qkv, o, mlp up/gate, down) and the tied head.
//
//   out[m, n] = (float(acc[m, n]) - z * float(colsum[n])) * (s_x * s_w)
//   acc = x_int @ w_int (int32),  z = z_x + z_shift
//
// Bound on the card: at decode (M = batch = 4) bytes — every weight byte is
// streamed once per step and feeds only M multiply-adds; at prefill
// (M = 4 * 512) operations. Design (int_matmul.cuh, one group of K): at
// prefill 128 x 128 tiles on the int8 tensor cores (mma.sync m16n8k32), A
// by cp.async, B transposed in registers while it is staged, two stages;
// at decode split-K streaming of the weight over every SM, 16-byte loads
// with two k-steps in flight a lane, the slices' int32 partials merged
// exactly in a workspace by the last block of each column tile.
//
// Exactness: the epilogue rounds each step on its own (__fmul_rn, __fsub_rn,
// never a fused multiply-add), in the order above with s_x * s_w formed
// first (s_w read in its stored dtype, f32 or bf16), matching the plain
// PyTorch version bit for bit.
#include "int_matmul.cuh"

// x_kind: 0 int8 codes; 1 f32 or 2 bf16 activations quantized with s_x,
// z_x in the decode staging (M <= 16 only; act_quant_static's codes).
// out_kind: 0 f32, 1 bf16, 2 int32 acc with no epilogue (colsum unread:
// may be null; the row-parallel sites of tensor parallelism sum acc over
// the ranks and apply the epilogue once, in the order above).
// ws: int_matmul_workspace_elems(M, N, K, K) int32 zeros (left zero)
extern "C" int w8a8_matmul_launch(const void* x, int x_kind, const void* w,
                                  const void* colsum, const void* sx,
                                  const void* zx, const void* sw,
                                  int sw_bf16, float z_shift, void* out,
                                  int out_kind, int M, int N, int K,
                                  void* ws, void* stream) {
  return imm::int_matmul_launch<false>(x, x_kind, w, sw, sw_bf16, colsum,
                                       sx, zx, z_shift, out, out_kind, M, N,
                                       K, K, ws, (cudaStream_t)stream);
}

// int32 elements of the workspace a launch of either int matmul needs (0
// above 16 rows): the decode regime's (G, M, N) partials and one ticket per
// 128-column tile
extern "C" long long int_matmul_workspace_elems(int M, int N, int K,
                                                int group) {
  return imm::workspace_elems(M, N, K, group);
}

// the most rows at which either int matmul takes an f32 / bf16 activation
// and quantizes it in its staging (x_kind 1 or 2): the decode regime's
extern "C" int int_matmul_decode_max_m() { return imm::D_MAX_M; }
