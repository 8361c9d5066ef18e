// Grouped expert SwiGLU FFN for Hopper (sm_90a), bf16 in, fp32 out.
//
// Replaces the TPU kernel `repro/kernels/moe_gemm.py::expert_ffn`
// (`_ffn_kernel`, pallas_call at moe_gemm.py:50): for every expert e
//     g = x[e] @ Wg[e],  u = x[e] @ Wu[e]        (fp32 sums)
//     h = bf16(silu(g) * u)                      (rounded to x's dtype)
//     out[e] = h @ Wd[e]                         (fp32 sums)
//
// Design.
// - This is `slot_ffn` without the indirection: the same two launches of
//   the tiled mma.sync GEMM in `swiglu_gemm.cuh`, called with no slot
//   table, so expert e's weights are entry e. Under the identity table
//   `slot_ffn` and this kernel give the same bits.
// - The TPU grid (expert, C tile, F tile) accumulates h @ Wd over F tiles
//   in its output block, relying on the sequential grid. Here the down
//   product is a separate launch whose blocks each loop over all of F, so
//   no sum crosses blocks and no atomics are needed: deterministic.
// - The TPU kernel asks C to divide by block_c and F by block_f (its VMEM
//   tiling). Here any C >= 1 works (rows are masked) and D, F need only be
//   multiples of 8 (16-byte loads).
// - bf16 only: every path of the port runs bf16 experts. The TPU kernel
//   also takes f32; on the card the wrapper raises for it (the plain
//   version serves f32 on the CPU).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): each expert's
// weights are read once (3 * D * F * 2 bytes) and x, out once; FLOPs
// 6 * E * C * D * F. At olmoe-1b-7b widths (E = 64, C = 128, D = 2048,
// F = 1024) that is 806 MB (0.24 ms) against 103 GFLOP (0.10 ms): bytes
// bound below C ~ 300 rows per expert, operations bound above.
//
// C interface (bound with ctypes): expert_ffn_launch returns
// cudaGetLastError() after enqueueing both launches on `stream`. It
// allocates nothing: the caller passes the bf16 (E, C, F) scratch `h` and
// the fp32 output.

#include "swiglu_gemm.cuh"

extern "C" int expert_ffn_launch(const void* x, const void* w_gate,
                                 const void* w_up, const void* w_down,
                                 void* h, void* out, int E, int C, int D,
                                 int F, void* stream) {
  return swiglu_ffn_launch(x, nullptr, w_gate, w_up, w_down, h, out, E, C,
                           D, F, E, stream);
}
