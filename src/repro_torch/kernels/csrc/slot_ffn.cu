// Slot-indirect expert SwiGLU FFN for Hopper (sm_90a), bf16 or f32 in,
// fp32 out (f32: `swiglu_f32.cuh`, `slot_ffn_f32_launch`).
//
// Replaces the TPU kernel `repro/kernels/slot_gather.py::slot_ffn`
// (`_slot_ffn_kernel`, pallas_call at slot_gather.py:72): for every expert e
//     g = x[e] @ Wg[slot[e]],  u = x[e] @ Wu[slot[e]]        (fp32 sums)
//     h = bf16(silu(g) * u)
//     out[e] = h @ Wd[slot[e]]                                (fp32 sums)
// with the weights read straight out of the bounded slot buffer through the
// expert -> slot table, over the first counts[e] rows of x[e] (all C rows
// without counts).
//
// What bounds it. The dispatch buffer holds C = T*k rows per expert, of
// which T*k in all hold tokens, and only the routed, resident experts'
// weights are needed. On an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense)
// at olmoe-1b-7b widths (D = 2048, F = 1024; one expert = 12.6 MB) the
// needed bytes dominate at every serving shape: decode (32 rows over <= 32
// experts) reads <= 403 MB, 0.12 ms; a 128-token prefill (1,024 rows over
// ~64 experts, 6.4 GFLOP) ~805 MB, 0.24 ms.
//
// Design (the GEMM is `swiglu_gemm.cuh`, shared with `expert_ffn.cu`).
// - The TPU version computes every (expert, C tile) of the buffer and hands
//   the table to its BlockSpec index maps. Here the caller passes counts
//   (rows holding tokens per expert; 0 for an expert that is not resident)
//   and the kernel builds its tile list from them on the device: an expert
//   with no rows (empty, or not resident) reads neither rows nor weights,
//   and an expert with r rows takes ceil(r / 128) row tiles instead of
//   ceil(C / 128): up to the 64-row boxes of x it loads, the bytes it
//   moves are those of the bound above.
// - The slot chase is the third coordinate of the weights' TMA tensor map:
//   slot_of_expert[e] (clamped into [0, S)) picks the slot, and no gathered
//   copy of the weights is made.
// - The TPU reduces h @ Wd over F tiles in a sequential grid. Here the FFN
//   is two launches on one stream (g/u with the SwiGLU epilogue writing h
//   in bf16, the TPU kernel's rounding point; then h @ Wd over all of F),
//   with no atomics and no split-K, so it is deterministic.
//
// C interface (bound with ctypes): slot_ffn_launch returns cudaGetLastError()
// after enqueueing both launches on `stream` (cudaErrorInvalidValue if a
// tensor map cannot be encoded). It allocates nothing: the caller passes the
// bf16 (E, C, F) scratch `h` and the fp32 output. `counts` may be null.

#include "swiglu_f32.cuh"  // includes swiglu_gemm.cuh

extern "C" int slot_ffn_launch(const void* x, const void* slot_of_expert,
                               const void* counts, const void* s_gate,
                               const void* s_up, const void* s_down, void* h,
                               void* out, int E, int C, int D, int F, int S,
                               void* stream) {
  return swiglu_ffn_launch(x, static_cast<const int*>(slot_of_expert),
                           static_cast<const int*>(counts), s_gate, s_up,
                           s_down, h, out, E, C, D, F, S, stream);
}

// The f32 path (`swiglu_f32.cuh`): x and the slot buffers fp32, h the fp32
// (E, C, F) scratch.
extern "C" int slot_ffn_f32_launch(const void* x, const void* slot_of_expert,
                                   const void* counts, const void* s_gate,
                                   const void* s_up, const void* s_down,
                                   void* h, void* out, int E, int C, int D,
                                   int F, int S, void* stream) {
  return swiglu_ffn_f32_launch(x, static_cast<const int*>(slot_of_expert),
                               static_cast<const int*>(counts), s_gate, s_up,
                               s_down, h, out, E, C, D, F, S, stream);
}
