// Grouped expert SwiGLU FFN for Hopper (sm_90a), bf16 or f32 in, fp32 out.
//
// Replaces the TPU kernel `repro/kernels/moe_gemm.py::expert_ffn`
// (`_ffn_kernel`, pallas_call at moe_gemm.py:50): for every expert e
//     g = x[e] @ Wg[e],  u = x[e] @ Wu[e]        (fp32 sums)
//     h = bf16(silu(g) * u)                      (rounded to x's dtype)
//     out[e] = h @ Wd[e]                         (fp32 sums)
//
// What bounds it. Each expert's weights are read once (3 * D * F * 2
// bytes), x and out once; FLOPs 6 * E * C * D * F. On an H100 SXM
// (3.35 TB/s, 989 TFLOP/s bf16 dense) at olmoe-1b-7b widths (E = 64,
// C = 128, D = 2048, F = 1024) that is 806 MB (0.24 ms) against 103 GFLOP
// (0.10 ms): bytes bound below C ~ 300 rows per expert, operations bound
// above. Every row holds data here, so nothing is skipped: the weights
// have to stream at the card's memory rate while the tensor cores keep up.
//
// Design.
// - This is `slot_ffn` without the indirection or the counts: the same two
//   launches of the persistent TMA + wgmma GEMM in `swiglu_gemm.cuh`, with
//   expert e's weights at tensor-map coordinate e. Under the identity table
//   `slot_ffn` and this kernel give the same bits.
// - TMA keeps a 6-stage ring of weight and row boxes in flight per SM
//   while two warpgroups run wgmma on the stages that have landed; each
//   128-row tile shares one weight panel between its two warpgroups.
// - The TPU grid (expert, C tile, F tile) accumulates h @ Wd over F tiles
//   in its output block, relying on the sequential grid. Here the down
//   product is a separate launch whose tiles each loop over all of F, so
//   no sum crosses blocks and no atomics are needed: deterministic.
// - The TPU kernel asks C to divide by block_c and F by block_f (its VMEM
//   tiling). Here any C >= 1 works (rows are masked) and D, F need only be
//   multiples of 8 (16-byte TMA strides); TMA zero-fills the ragged tails.
// - f32: the reference kernel also runs in f32 (to 2e-5). One TF32 product
//   would miss that, so f32 takes `swiglu_f32.cuh`, a 3xTF32 GEMM over the
//   same tile walk (`expert_ffn_f32_launch`; wgmma above 64 rows an expert).
//
// C interface (bound with ctypes): expert_ffn_launch returns
// cudaGetLastError() after enqueueing both launches on `stream`
// (cudaErrorInvalidValue if a tensor map cannot be encoded). It allocates
// nothing: the caller passes the bf16 (E, C, F) scratch `h` and the fp32
// output.

#include "swiglu_f32.cuh"  // includes swiglu_gemm.cuh

extern "C" int expert_ffn_launch(const void* x, const void* w_gate,
                                 const void* w_up, const void* w_down,
                                 void* h, void* out, int E, int C, int D,
                                 int F, void* stream) {
  return swiglu_ffn_launch(x, nullptr, nullptr, w_gate, w_up, w_down, h, out,
                           E, C, D, F, E, stream);
}

// The f32 path (`swiglu_f32.cuh`): x and the weights fp32, h the fp32
// (E, C, F) scratch.
extern "C" int expert_ffn_f32_launch(const void* x, const void* w_gate,
                                     const void* w_up, const void* w_down,
                                     void* h, void* out, int E, int C, int D,
                                     int F, void* stream) {
  return swiglu_ffn_f32_launch(x, nullptr, nullptr, w_gate, w_up, w_down, h,
                               out, E, C, D, F, E, stream);
}
