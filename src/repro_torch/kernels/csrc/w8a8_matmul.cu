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
// streamed once per step and each byte feeds only M multiply-adds; at
// prefill (M = 4 * 512) operations. Design: the __dp4a tile mainloop of
// int_matmul.cuh with int8 B rows and a single group of K.
//
// Exactness: the epilogue rounds each step on its own (__fmul_rn, __fsub_rn,
// never a fused multiply-add), in the order above with s_x * s_w formed
// first, matching the plain PyTorch version bit for bit.
#include "int_matmul.cuh"

extern "C" int w8a8_matmul_launch(const void* x, const void* w,
                                  const void* colsum, const void* sx,
                                  const void* zx, const void* sw,
                                  float z_shift, void* out, int out_bf16,
                                  int M, int N, int K, void* stream) {
  return int_matmul_launch<false>(x, w, sw, colsum, sx, zx, z_shift, out,
                                  out_bf16, M, N, K, K, (cudaStream_t)stream);
}
