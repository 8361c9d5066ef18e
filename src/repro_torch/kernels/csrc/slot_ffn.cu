// Slot-indirect expert SwiGLU FFN for Hopper (sm_90a), bf16 in, fp32 out.
//
// Replaces the TPU kernel `repro/kernels/slot_gather.py::slot_ffn`
// (`_slot_ffn_kernel`, pallas_call at slot_gather.py:72): for every expert e
//     g = x[e] @ Wg[slot[e]],  u = x[e] @ Wu[slot[e]]        (fp32 sums)
//     h = bf16(silu(g) * u)
//     out[e] = h @ Wd[slot[e]]                                (fp32 sums)
// with the weights read straight out of the bounded slot buffer through the
// expert -> slot table.
//
// Design.
// - The TPU version hands the table to its BlockSpec index maps as a
//   scalar-prefetch operand. Here every block chases the pointer itself:
//   it reads slot_of_expert[e] from device memory and offsets its weight
//   loads by it. No gathered copy of the weights is ever made.
// - The TPU reduces h @ Wd over F tiles in a sequential grid, carrying the
//   sum in its output block. Blocks on the card run in no order, and a
//   (rows x D) fp32 sum does not fit a block, so the FFN runs as two
//   launches on one stream: (1) g/u GEMMs over D with the SwiGLU epilogue,
//   writing h in bf16 (the same rounding point as the TPU kernel); (2) the
//   h @ Wd GEMM, one block per output tile, looping over all of F. No
//   atomics and no split-F: every output element is summed by one thread
//   in one fixed order, so the result is deterministic from run to run.
// - Both launches are the tiled mma.sync GEMM of `swiglu_gemm.cuh`, which
//   `expert_ffn.cu` shares (so the two give the same bits for the same
//   weights).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), olmoe-1b-7b
// (D = 2048, F = 1024, E = 64; one expert = 12.6 MB):
// - decode, batch 4: C = B*k = 32, E*C = 2048 rows, 25.8 GFLOP. Memory
//   bound: it reads the weights of every distinct slot the table names (at
//   most B*k = 32 routed experts, 403 MB; 805 MB if all 64 are distinct),
//   so the floor is distinct bytes / 3.35 TB/s, 0.12-0.24 ms.
// - prefill, a 128-token prompt: C = T*k = 1024, E*C = 65536 rows,
//   0.82 TFLOP per layer, so 0.83 ms at 989 TFLOP/s.
// Only T*k of the E*C dispatch rows hold tokens; the rest are zero padding
// that this kernel multiplies like any other row (E*C / (T*k) = 64x the
// needed work at both shapes). Skipping empty rows is left to a later
// change; the caller's capacity choice, not the kernel, sets the padding.
//
// C interface (bound with ctypes): slot_ffn_launch returns cudaGetLastError()
// after enqueueing both launches on `stream`. It allocates nothing: the
// caller passes the bf16 (E, C, F) scratch `h` and the fp32 output.

#include "swiglu_gemm.cuh"

extern "C" int slot_ffn_launch(const void* x, const void* slot_of_expert,
                               const void* s_gate, const void* s_up,
                               const void* s_down, void* h, void* out, int E,
                               int C, int D, int F, int S, void* stream) {
  return swiglu_ffn_launch(x, static_cast<const int*>(slot_of_expert), s_gate,
                           s_up, s_down, h, out, E, C, D, F, S, stream);
}
