#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero before
the last line:

1. environment: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port (`slot_ffn`, `fused_moe_entry`,
   `fused_decode_attention`, `fused_mla_decode_attention`, `topk_gating`,
   `expert_ffn`), from `src/repro_torch/kernels/csrc`, one nvcc per
   source, all at once; each entry function's registers, static shared
   memory and spills as ptxas reports them, and how many HGMMA (wgmma),
   UTMALDG (TMA load) and TF32 HMMA (the f32 path's 3xTF32 mma.sync)
   instructions the `slot_ffn`, `expert_ffn` and `fused_moe_entry`
   libraries' SASS holds (`cuobjdump -sass`; "not checked" without it);
3. kernels: each kernel against its plain PyTorch version on the card at
   its paths' shapes, with CUDA-event medians of the kernel, the plain
   version and a library yardstick (timed only; the port never calls it),
   and the kernel's bound (the larger of needed bytes / 3.35 TB/s and
   needed operations over the H100 SXM peak for their type; the f32 SwiGLU
   GEMM's as 3xTF32, three TF32 products at 495 TFLOP/s), with the SwiGLU
   GEMM rows' achieved TB/s and TFLOP/s. The five
   kernels the reference also runs in f32 (all but `topk_gating`, which
   takes fp32 logits anyway) are checked in f32 too (`f32_*` shapes, each
   GEMM's launches timed by the profiler), to the reference's f32
   tolerance, 2e-5:
   - `slot_ffn` at olmoe-1b-7b decode (batch 4), prefill (128 tokens), one
     32-token prefill chunk (every routed expert resident, and 16 of 64
     experts resident as serving meets it) and a ragged shape, at
     DeepSeek-V2-Lite decode, prefill and chunk, and at the three Qwen
     models' decode and chunk shapes (E = 60 top-4 at d 2048, f 1408; 64
     top-8 at 3584, 2560; 128 top-8 at 4096, 1536), also with no expert
     resident (an empty work list: every count 0), tolerance 2e-2: with the
     per-expert row counts `moe_slotbuf` passes (rows < counts checked,
     deterministic and equal to the all-rows call's; bound from the rows
     that hold tokens, the bound of reading and writing every row beside
     it) and without counts (every row);
   - `fused_moe_entry` at olmoe-1b-7b decode (T=4, 256 slots) with every
     routed expert resident and with 16 resident experts per layer (some
     routed ones absent), bias zeros and nonzero, at DeepSeek-V2-Lite
     decode (T=4, top-6, 416 slots) and at T=64 (up to 64 rows an expert,
     each weight panel still read once an expert), at the three Qwen
     decode shapes (T=4; a routed quarter and 16 resident experts, and an
     empty work list for qwen1.5 and qwen3: y and every gate 0), and in f32
     at T=4 and T=128 (the f32 GEMM's wgmma route): ids equal, gates within
     1e-6, y within 2e-2 (f32: 2e-5), deterministic, with each of its three launches' device time
     from a `torch.profiler` trace (`launch_split`);
   - `fused_decode_attention` at B=4, Hq=Hkv=16, D=128, S=256 with cache
     lengths 0, 63, 128, 255, a wrapped ring (lengths >= S), GQA shapes
     (G=4; G=16 at D=64 and D=256 with every length 0; the Qwen groups at
     D=128: G=7, Hq=28, Hkv=4, and G=16, Hq=64, Hkv=4), S=130 (no multiple
     of the 8 splits), S=2048 and one () length, softcap 0 and 30, and
     gemma2-9b's local layer (Hq=16, Hkv=8, D=256, a 4096-row ring, lengths
     that wrap it, softcap 50, queries at 8x so the cap changes the
     scores by O(1); its out within half a bf16 step (+ 1e-4) of the plain
     version in f32, the uncapped output more than 10x that away),
     recurrentgemma-2b's local MQA layer (Hq=10, Hkv=1: G=10, not a power
     of two; D=256, a 2048-row ring, lengths 100, 2047, 2100, 5000) and
     whisper-large-v3's decoder self-attention (Hq=Hkv=20, D=64, S=256,
     lengths 0, 63, 128, 255): new
     caches bitwise equal, out finite and within 2e-2, with the kernel's
     device time (profiler) and a clone + insert + SDPA yardstick
     (`enable_gqa` where G > 1);
   - `fused_mla_decode_attention` at DeepSeek-V2-Lite decode (B=4, H=16,
     R=512, P=64, S=256) with cache lengths 0, 63, 128, 255 and with every
     row at S - 1, and at minicpm3-4b decode (H=40, three of the kernel's
     16-head groups; R=256, P=32): new caches bitwise equal, ctx within
     2e-4; its time is
     the kernel's, printed beside the wrapper's with the host bound the
     serving path passes (`max_len`, no device read) and without it
     (reading the lengths back), and the kernel's device time (profiler);
   - `topk_gating` at (T, E, k) = (4, 64, 8), (512, 64, 8) (fp32 and bf16
     logits), (512, 64, 6), (512, 60, 4), (33, 128, 8), (256, 256, 8),
     (7, 8, 8) and with exactly tied logits: ids equal, gates within 1e-6
     abs / 1e-5 rel; its device time (profiler), the bare launch's event
     time and an empty kernel's (the launch floor, built by this script
     alone from `EMPTY_KERNEL_CU` beside the port's kernels in phase 2)
     beside the wrapper's;
   - `expert_ffn` at (E, C, D, F) = (64, 128, 2048, 1024), (64, 128, 2048,
     1408) and (3, 40, 64, 48), within 2e-2, with `slot_ffn` under the
     identity table bitwise equal to it;
4. the kernel API, the only path of the reference that runs `topk_gating`
   and `expert_ffn`: one MoE layer's routed experts (512 tokens, olmoe and
   DeepSeek widths) through `ops.topk` and `ops.expert_ffn`, counts zeroed
   before and read after, the output within 2e-2 of the same chain through
   the plain versions;
5. serving, unfused path: olmoe-1b-7b at its published widths (16 layers,
   weights drawn from a seed on the card), 16 expert slots per layer,
   `slot_ffn` on, 8 greedy requests of 64-128 prompt tokens and 16 new
   tokens at batch 4 through `ServingEngine`, twice: with monolithic
   admission (`prefill_chunk=0`) and with chunked prefill
   (`prefill_chunk=32`, the serving default). Every kernel's launch count is
   zeroed just before and read just after each run; every prefill (or
   prefill chunk) and decode step must launch `slot_ffn` once per MoE
   layer at least, `topk_gating` and `expert_ffn` never, and experts must
   be swapped in and evicted. Oracle: one prompt prefilled (whole or in
   chunks, as the run admits) and decoded single-stream through the slot
   path gives logits bitwise equal to the same functions over every
   expert; every served request's tokens match those of the request
   decoded alone through the fully-resident path, teacher-forced, both in a
   state of the serving batch's width (request in row 0, the other rows
   idle: the same shapes, so the same bits) unless the reference's top two
   logits are within 5e-2 (a near-tie), and single-stream unless a
   near-tie or a router flip at a near-tie (see `router_flip`): batch-1
   products round differently, and a last-bit difference can flip a
   router's k-th choice, after which the logits move by more than a
   near-tie. The chunked run
   also prints max |chunked - whole-prompt| prefill logits of one prompt
   (their greedy tokens must agree unless the top two are within 5e-2; the
   chunk's GEMMs and attention have other shapes, so the bits differ) and
   how many served streams differ from the monolithic run's;
6. serving, superkernel path: the same model (same seed), requests, batch
   and two admissions through `ServingEngine(SlotBufferEngine(
   use_kernel=True, use_superkernel=True))`. Every decode step must launch
   `fused_moe_entry` once per MoE layer and `fused_decode_attention` once
   per layer at least, `fused_mla_decode_attention` and `slot_ffn` never
   (prefill still launches `slot_ffn`, once per MoE layer at least per
   prompt or chunk); the same oracles, with the decode steps held against
   the segment functions over every expert with the identity slot table;
7. phases 5 and 6 again on DeepSeek-V2-Lite at its published widths (27
   layers: a dense first layer and 26 MoE layers with MLA attention, 64
   routed experts top-6 and 2 shared experts), 16 expert slots per layer,
   the same requests recipe and checks, with MLA's kernel in place of GQA's:
   unfused, `slot_ffn` once per MoE layer at least per prefill (chunk) and
   decode step; superkernel, per decode step `fused_mla_decode_attention`
   once per layer and `fused_moe_entry` once per MoE layer at least,
   `slot_ffn` and `fused_decode_attention` never, and the same checks of
   the served streams;
8. §3.4 cache-aware routing: the monolithic runs of olmoe-1b-7b (unfused
   and superkernel) and DeepSeek-V2-Lite (superkernel) again, with the
   same requests and route bias 1.0 (`EngineServingConfig.route_bias`,
   the reference's own value), each printing its demand misses, replays,
   swapped GB (copy s, GB/s), TTFT / TPOT p50 and tok/s beside the bias-off
   run of the same call, and how many served streams differ from it. The
   launch checks of phases 5-7 hold; the routing calls of decode
   (`fused_moe_entry`'s bias operand, or `route`'s `logit_bias` unfused)
   must see a nonzero bias, and those of every bias-off run none; the run
   demands no more experts than its bias-off run. At strength 1.0 one
   prompt prefilled and decoded single-stream through the slot path (16
   steps), with the bias each MoE layer routed with at each step recorded,
   gives logits bitwise equal to the path's fully-resident oracle routed
   with those same biases (`biased_oracle`). Then the engine's
   strength is held at 0 with the biased calls still on (its ceiling
   stays 1.0 and its controller, never given one, stays at 0): one
   prompt's logits over prefill + 16 decode steps are bitwise equal to its
   fully-resident oracle and to the bias-off engine's;
10. the reference's Qwen MoE configs at their published widths, 16 expert
   slots a layer, the eight-request recipe with every launch check and
   oracle of phases 5-7 for its path: qwen1.5-moe-a2.7b (24 layers, cut
   to 6, MHA, 60 experts top-4 and 4 shared fused into one FFN of width
   5632) unfused
   and monolithic, and superkernel with 32-token chunks;
   qwen2-moe-57b (GQA G = 7, 64 experts top-8, a shared FFN of 20480) and
   qwen3-moe-235b-a22b (GQA G = 16 at head dim 128, qk-norm, 128 experts
   top-8, normalised gates) superkernel and monolithic, with the same
   checks of the served streams;
11. faults and graceful degradation (`core/faults.py`), each run printing
   its health counters, brownout deferrals, TTFT / TPOT p50 and swapped GB
   beside the fault-free run of its path in this call: a disabled
   `FaultPlan()` on olmoe superkernel gives one prompt's logits over
   prefill + 16 decode steps bitwise equal to the fault-free engine's;
   `FaultPlan.brownout_preset(seed=0)` served on olmoe superkernel and
   DeepSeek-V2-Lite unfused (monolithic) emits every request's budget with
   retries and link failures and sheds nothing; `FaultPlan.total_outage()`
   on olmoe superkernel (no expert ever resident: every MoE work list
   empty) emits every budget degraded, ends degraded at the degraded
   strength, swaps nothing, and one prompt's logits are bitwise those of
   the path's oracle with no expert resident; an outage in [0, 2) of the
   link clock with `degraded_recover_streak=1` and 64 slots a layer
   recovers, and a fresh population served on that engine then gives
   logits traces bitwise equal to a never-faulted engine's;
12. the disk tier (`core/expert_tiers.py`, `core/integrity.py`): each
   model's experts drawn from the seed on the card layer by layer (in
   `Model.init`'s order, so the weights are the earlier phases'), written
   as expert shards into one temporary directory (`tempfile.mkdtemp()`,
   outside the checkout; each layer file fsync'd and dropped from the page
   cache; removed at the end, also on SIGTERM), served through a
   demand-only `TieredExpertStore` (a fixed page-locked pool of host
   records; `TIER_PREFETCH`) with 16 slots a layer, each run printing the
   tier's snapshot, host hits and misses, disk stall, the integrity
   counters, the bytes read from the shards and their rate, CRC seconds,
   TTFT / TPOT p50 and swapped GB beside the pre-staged run of its config
   and path in this call:
   - olmoe-1b-7b unfused and DeepSeek-V2-Lite superkernel (`verify=
     "promote"`; at 9 of 27 layers, `TIER_DEPTH`), monolithic, phase 5's
     traffic, a host budget of a third of the shards: host evictions, no
     corruption detected, one prompt single-stream (prefill + 16 decode
     steps) bitwise equal to the path's oracle (its experts read from the
     shards), every served stream equal to the pre-staged run's or parting
     only at a near-tie of this run's top two logits (and then held by the
     rules of phases 5-7; a cut run's streams by those rules alone);
   - before DeepSeek's run, `io_probe`: a verified promotion batch's
     records read and CRC-32'd in the tier's 2 MiB tasks against one task
     a record, every CRC equal to its manifest's;
   - olmoe-1b-7b superkernel on the same shards under
     `FaultPlan.corrupt_flaky(seed=0)` (`verify="scrub"`) and
     `corrupt_disk(seed=0)` (`verify="promote"`): every budget emitted,
     corruption detected (and quarantined under `corrupt_disk`), the
     episode invariant, no quarantined expert resident, and every occupied
     device slot's bytes, copied back, with its shard record's CRC-32;
   - qwen2-moe-57b superkernel, monolithic, from disk shards of as many of
     its 28 layers as the disk's free bytes and what is left of the run's
     write allowance (`DISK_WRITE_LIMIT`) after olmoe's and DeepSeek's
     shards hold (2 GB to spare), a host budget of 35 % of its shards (32
     GiB at 28 layers), 2 greedy requests of 64 prompt tokens and 8 new
     tokens at batch 2: every budget, finite logits, host misses,
     promotions and evictions, and up to 64 occupied slots drawn from the
     seed holding their shard records' bytes;
13. the adaptive horizon's knobs, trace collection, the forest, the
   simulators and the serving CLI (`runtime/engine.py`'s `Engine` and
   `SlotBufferEngine(prefetch=, link_bandwidth=, controller=)`,
   `core/{trace,forest,predictor,coordinator}.py`, `simulator/`,
   `launch/serve.py`):
   - (c) `Engine(get_config("olmoe-1b-7b"))` on the card, the whole model
     resident (the reference's plain grouped MoE: no kernel), collects the
     traces of `make_workload("poisson", 8, seed=0, mean_decode=16)` (the
     serving CLI's recipe, at most 16 steps a request): every step records
     16 MoE layers of ids in [0, 64), and a rerun of request 0 gives the
     same ids and tokens bitwise. `ForestPredictor` fits the first
     `FOREST_REQUESTS` requests' samples in a process of its own (numpy
     on the host) while the card runs (a), (b), (d) and (e); then
     `simulate_serving` replays all 8 traces under `baseline`,
     `pregate_fixed(2)`, `promoe_like(2)` and `expertflow()` on
     `PLATFORMS["h100"]` (16 slots a layer, batch 4), printing each
     policy's modeled stall, TTFT, TPOT, hit rate and occupancy;
   - (a) olmoe-1b-7b superkernel, monolithic, phase 5's traffic, with
     `prefetch=False`: the no-prefetch baseline, nothing prefetched and no
     layer run speculatively (a segment that finds a routed expert absent
     still replays: routing runs inside it), held to phase 5's oracles
     and printed beside phase 5's prefetch-on run;
   - (b) one stream of prefill + 16 decode steps on the superkernel path
     with the reference test's controller (stall threshold 40, no capacity
     guard), a starved link (`link_bandwidth=1.0`) against a fast one
     (64e9): final S, its history and the late hits, every step's logits
     bitwise the path's oracle;
   - (d) `Engine` on the olmoe and DeepSeek smoke configs on the card
     against the same params on the CPU: ids equal until a router
     near-tie, tokens until such a parting or a top-two near-tie;
   - (e) `launch/serve.py`'s `main` in process, `--backend engine` and
     `--backend sim` on `--platform h100` (the default arch's smoke
     config): both return, with the same report keys;
14. the plain `Model` API on the attention-only models, then training
   (`models/transformer.py::Model`, `training/`, `checkpoint/
   checkpointer.py`, `TrainRunner`, `launch/train.py`), at published
   widths, depth cut as `TRAIN_DEPTH` says:
   - (a) yi-9b, command-r-plus-104b (tied, vocab 256000), minicpm3-4b
     (MLA, 40 heads, tied), gemma2-9b (two local and two global layers, a
     4100-token prompt past its 4096-row window) and llava-next-34b's
     backbone (`embeds=` input): `prefill` + 4 `decode_step`s (the decode
     kernels) against `forward` on the grown sequence: prefill's last
     logits within 2e-2, decode by the near-tie rule (max |dlogit|
     printed); at the first step every layer's attention part
     (`attn_decode`, before the post-norm and the residual add) with
     `use_kernel=True` against `use_kernel=False`: new caches bitwise,
     output within 2e-2 absolute (one bf16 step where a value passes
     2.56). The two attention kernels' launches in `decode_step` are this
     path's counts (the comparison's own are not counted);
   - (b) olmoe-1b-7b, 4 layers, 4 x 512 tokens of `token_batches(seed=0)`,
     `remat=True`, 10 AdamW steps: every loss finite, the mean of the last
     3 below the first; ms/step, tokens/s, peak memory;
   - (c) yi-9b, 2 layers: 5 steps on one batch, the loss falls;
   - (d) olmoe-1b-7b at 1 layer: 6 steps with `Checkpointer(every=3)`; a
     new `TrainRunner` restores step 3 (params and moments bitwise the
     saved ones) and reruns steps 4-6, their losses within 1e-3 relative
     of the first run's (bitwise or not, printed);
   - (e) f32 smoke olmoe, yi, gemma2 and minicpm3: loss and every gradient
     on the card within 1e-4 of the CPU's on the same params and batch;
   - (f) `launch/train.py --smoke --device cuda --steps 20` in process:
     the final loss below the first;
15. the recurrent and encoder-decoder models on the plain `Model` API
   (`models/recurrent.py`, `models/xlstm.py`, cross-attention and
   `Model.encode`), then their training, at published widths, depth cut
   as `REC_DEPTH` says (recurrentgemma-2b two (rec, rec, attn) units,
   xlstm-1.3b its sLSTM layers 0 and 8 with the seven mLSTM layers between,
   whisper-large-v3 4 encoder and 4 decoder layers over its 1500 source
   frames):
   - (a) `prefill` + 4 `decode_step`s against `forward` on the grown
     sequence: prefill's last logits within 2e-2, decode by the near-tie
     rule (max |dlogit| printed); recurrentgemma's prompt is 2080 tokens
     at batch 2 (its local layers' 2048-row rings wrap), xlstm's 64,
     whisper's 32 over random frames from the seed;
   - (b) at the first decode step every attention layer's attention part
     (`attn_decode`: recurrentgemma's local MQA, whisper's decoder
     self-attention) with `use_kernel=True` against `use_kernel=False`:
     new caches bitwise, output within 2e-2 absolute. The GQA kernel's
     launches counted for this path are those of `decode_step` (the
     comparison's own are not counted);
   - (c) `rglru_block`, `mlstm_block` and `slstm_block` at full width in
     f32, an 8-token prefill and one decode step, card against CPU within
     1e-4 (outputs and states);
   - (d) the reference test's one-batch descent on xlstm smoke (5 AdamW
     steps, lr 1e-3, the loss falls), then f32 smoke recurrentgemma, xlstm
     and whisper (with frames): loss and every gradient on the card within
     1e-4 of the CPU's;
   - (e) the phase's seconds, each model's prefill ms and ms per decode
     step, and each recurrent kind's time loop against its whole block
     (one layer at the model's prompt length: the loop's share), beside
     the card's name and power limit;
16. the pre-fused engine path, the superkernel's dense tail, the mesh,
   the pipeline and the dry run; the card's name and power limit beside
   every time:
   - (a) olmoe-1b-7b (16 layers) through `SlotBufferEngine(fused=False)`,
     batch 4 of 64-token prompts, seed 0: with every expert a slot against
     the eager unrolled model with a drop-free capacity (bitwise on the
     CPU; on the card within four bf16 steps of the largest hidden value:
     the grouped model and the legacy path run the MoE GEMMs at other
     shapes, and cuBLAS picks its kernels by shape), at 16 slots a layer
     bitwise that all-resident run; swap calls, host syncs, swapped GB
     and wall ms a forward beside `fused=True` at 16 slots;
   - (b) DeepSeek-V2-Lite's widths with `moe_every=2` at 4 layers (dense,
     dense, MoE, a dense MLA tail), 32 slots (its one MoE layer's pool
     must hold a decode step's demand, batch 4 x top-6, for the oracle to
     hold), 1-token prompts at batch 4, 8 superkernel decode steps
     bitwise their oracle (`sk_reference_decode_step`: the segment
     functions over every expert, then the tail layer by layer through
     `layer_decode` and the model's logits, not the engine's tail
     function), and within one bf16 step of the logit (or TOL) of the
     oracle with the tail's plain path; the tail's
     `fused_mla_decode_attention` once a step;
   - (c) a (1, 1) mesh over a one-rank NCCL group (in-memory store, no
     port): phase 14 (b)'s olmoe training (4 of 16 layers, 4 x 512
     tokens, 10 steps) with FSDP against the same steps without a mesh
     from one init, ms/step and peak memory both ways (beside phase 14
     (b)'s), the expert-parallel path a step and its collectives (none
     cross a mesh axis of size 1); yi-9b's forward at 4 of 48 layers on
     the mesh against without it, bitwise;
   - (d) one pipeline stage over a one-rank ``pod`` mesh against the stage
     function, bitwise;
   - (e) the dry run of olmoe-1b-7b train_4k and qwen3-moe-235b-a22b
     decode_32k on a fake 16x16 mesh (fake tensors, on the host, one
     child process a cell, started after (a)-(d), so no timed phase
     shares the host with them): peak GiB, FLOPs, bytes, collective
     bytes a device and the dominant term (modeled on the H100's
     data-sheet peaks).
   The process group is destroyed before the end;
17. last, a `{"kernels": [...]}` line (per kernel: `launches` summed over
   the runs whose path runs it, the kernel API's for `topk_gating` and
   `expert_ffn`, `launches_by_path` per run; times at the shape its entry
   names, every measured shape under `shapes`), the total time, then the
   last line `{"ok": true, "device": {...}}`. Before them the card is
   synchronized, the cached device and page-locked host memory freed,
   and no thread but the main one may be left (a check).

The script reaps every process it starts, however deep
(PR_SET_CHILD_SUBREAPER): on its way out, pass or fail, any that is
still there is ended (SIGTERM, SIGKILL after 5 s) and named on stderr.

Depth cuts (no width is cut): qwen2-moe-57b at 6 of 28 layers (cut
from 12 so that phase 14 fits the run's 1200 s) and
qwen3-moe-235b-a22b at 8 of 94 in phase 10, whose experts (98.7 GB and
454 GB) do not fit the host's memory (and qwen3's not the card's) at full
depth; qwen1.5-moe-a2.7b at 6 of 24 in phase 10 and DeepSeek-V2-Lite's
monolithic and cache-aware runs (phases 5-8) and its brownout (phase 11)
at 9 of 27 (`SERVE_DEPTH`), so that the run fits its 1200 s on a slower
host too (1379.4 s at full depth there); in phase 12 qwen2 at the depth
the shard disk and the run's write allowance hold after olmoe's and
DeepSeek's shards and phase 14's checkpoints (`TRAIN_CKPT_BYTES`) (its
28 layers' shards are 98.65 GB), which it prints with the free bytes and
the allowance it had; so that the run fits its 1200 s with phase 13,
phase 12's DeepSeek-V2-Lite run at 9 of its 27 layers (`TIER_DEPTH`; its
host budget still a third of its shards, its streams held by the rules
of phases 5-7 instead of against the pre-staged run's) and, with phase
14, olmoe's tiered runs at 6 of its 16 layers (its corruption runs share
those shards); so that phase 12 fits the run's time, the chunked runs of
phases 5-7 at 5 of olmoe's 16 layers and 6 of DeepSeek-V2-Lite's 27
(`CHUNKED_DEPTH`; a cut chunked run is not compared with the monolithic
run's streams). Every other run is at full depth (olmoe's serving runs
at all 16 layers).
Runs of one config follow each other, so that its experts are pinned
once (`build_engine`): phases 5-8 run olmoe's monolithic, cache-aware and
chunked runs, then DeepSeek-V2-Lite's; phase 11 runs olmoe's plans, then
DeepSeek-V2-Lite's brownout.

Exits with code 2 and prints no result without a CUDA device or outside a
checkout of the repository.

    python3 chip_smoke.py --kernels[=name,name]

runs phases 1-3 only (all six kernels, or the named ones), writes
`chiprun_out/chip_smoke_kernels.json` and prints no result: the quick call
for kernel work.

    python3 chip_smoke.py --disk

runs phase 1 and measures the disk phase 12 writes its shards to (free
bytes, write rate, read rates after POSIX_FADV_DONTNEED and from the page
cache, zlib.crc32's rate on one thread and on 8) into
`chiprun_out/chip_smoke_disk.json`, and prints no result.

    python3 chip_smoke.py --horizon

runs phases 1-2, phase 5's olmoe-1b-7b superkernel monolithic run (the
prefetch-on row phase 13 prints beside its own) and phase 13, writes
`chiprun_out/chip_smoke_horizon.json` and prints no result.

    python3 chip_smoke.py --train

runs phases 1-2, 14 and 15, writes `chiprun_out/chip_smoke_train.json`
and prints no result.

    python3 chip_smoke.py --mesh

runs phases 1-2 and 16, writes `chiprun_out/chip_smoke_mesh.json` and
prints no result.
"""
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from collections.abc import Mapping
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12     # dense bf16 tensor cores, H100 SXM
H100_FP32_FLOP_PER_S = 67e12      # fp32 outside the tensor cores, H100 SXM
H100_TF32_FLOP_PER_S = 495e12     # dense TF32 tensor cores, H100 SXM
TOL = 2e-2
TOL_F32 = 2e-5     # the f32 paths: the reference's own f32 tolerance
TOL_GATES = 1e-6
NEAR_TIE = 5e-2
SEED = 0
KERNELS = ("slot_ffn", "fused_moe_entry", "fused_decode_attention",
           "fused_mla_decode_attention", "topk_gating", "expert_ffn")
TOL_TOPK_ABS, TOL_TOPK_REL = 1e-6, 1e-5   # topk_gating's gates (fp32)
CHUNK = 32        # the chunked runs' prefill chunk (the serving default)
GEMMA2_Q_GAIN = 8.0   # gemma2's row: queries scaled so the cap bites
GEMMA2_ATOL = 1e-4    # and fp32 summation order beside half a bf16 step
TOL_CTX = 2e-4     # fused_mla_decode_attention's ctx: fp32, summation order
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite")
ROUTE_BIAS = 1.0   # the cache-aware runs' strength (the reference's value)
# the paths served again at ROUTE_BIAS (superkernel or not), per model
BIASED = {"olmoe-1b-7b": (False, True), "deepseek-v2-lite": (True,)}
# Depth cuts (widths stay as published): qwen2 and qwen3, whose experts
# fit neither the host (101 GiB) nor the card at full depth: 98.7 GB and
# 454 GB of bf16 experts; qwen1.5 for the run's time.
QWEN_DEPTH = {
    "qwen1.5-moe-a2.7b": (6, "the run's 1200 s (1379.4 s on a host 30 % "
                             "slower): 6 of 24 layers, 96 slots for its 60 "
                             "experts"),
    "qwen2-moe-57b": (6, "its 28 layers' 98.7 GB of experts do not fit the "
                         "host's memory beside the rest; 6 layers, 21.1 "
                         "GB (12 before phase 14), so that phase 14 fits "
                         "the run's 1200 s"),
    "qwen3-moe-235b-a22b": (8, "its 94 layers' 454 GB of experts fit "
                               "neither the host nor the card; 8 layers: "
                               "38.7 GB")}
# phase 12: the tiered runs' host budget (a third of the shards), qwen2's
# host budget at its full 28 layers (32 GiB, 35 % of 98.65 GB of shards;
# at a cut depth the same share of its shards), its traffic (requests,
# prompt tokens, new tokens), and the bytes left free on the shard disk
# when qwen2's depth is chosen
TIER_BUDGET_SHARE = 1 / 3
QWEN_TIER_BUDGET = 32 * 2 ** 30
QWEN_TIER_REQUESTS = (2, 64, 8)
DISK_MARGIN = 2e9
# Bytes a run may write to the shard disk: the H100 machine this script
# runs on ends a run that has written more than 45 GiB to its disk
# (deleted files count). Every shard goes to one temporary directory
# (`tempfile.mkdtemp()`, under TMPDIR): olmoe's and DeepSeek's first
# (12.88 + 28.79 GB, never cut), then qwen2's, as deep as what is left
# of this allowance holds.
DISK_WRITE_LIMIT = 45 * 2 ** 30
# Phase 12's tiers promote on demand only (`TieredExpertStore(prefetch=
# False)`): at the tier's default disk bandwidth, 2e9 bytes a link-clock
# unit (one MoE layer dispatch), the reference's S_disk prefetcher takes
# the disk to land some 160 olmoe records a layer and keeps the host tier
# churning far past the run's time. The CPU tests hold the prefetcher's
# decisions to the reference's; on the card it is not exercised yet.
TIER_PREFETCH = False
# decode steps of phase 12's single-stream oracle (as phases 5-7's)
TIER_ORACLE_STEPS = 16
# Depth cuts of phase 12's pre-staged-config runs (widths as published;
# the host budget stays a third of the cut model's shards): arch ->
# (layers, why). A cut run's streams are held by phases 5-7's rules
# instead of against the full-depth pre-staged run's.
TIER_DEPTH = {
    "deepseek-v2-lite": (9, "the run's 1200 s: with phase 13 the run took "
                            "1216.1 s at full depth"),
    "olmoe-1b-7b": (6, "the run's 1200 s with phase 14 (8 layers before "
                       "a host 30 % slower took 1379.4 s); its corruption "
                       "runs share these shards"),
}
# records of the per-record against chunked read + CRC probe (phase 12)
IO_PROBE_RECORDS = 24
# Depth cuts of the chunked runs of phases 5-7 (widths as published), so
# that phase 12 fits the run's time: (layers, why)
# (at least 5 MoE layers: their 80 slots hold a chunk's 64 routed experts,
# which the oracle needs)
CHUNKED_DEPTH = {
    "olmoe-1b-7b": (5, "phase 12's disk tier needs the time; the "
                       "monolithic runs keep all 16 layers"),
    "deepseek-v2-lite": (6, "phase 12's disk tier needs the time; the "
                            "monolithic runs are at SERVE_DEPTH's 9")}
# Depth cut of DeepSeek-V2-Lite's monolithic and cache-aware runs of
# phases 5-8 and of its brownout (phase 11), widths as published:
# (layers, why). 8 MoE layers keep 128 slots for a prompt's 64 routed
# experts a layer; the depth is phase 12's tiered run's.
SERVE_DEPTH = {
    "deepseek-v2-lite": (9, "the run's 1200 s (1379.4 s on a host 30 % "
                            "slower at 27 layers)")}
# phase 10: (arch, superkernel, prefill chunk)
QWEN_RUNS = (("qwen1.5-moe-a2.7b", False, 0),
             ("qwen1.5-moe-a2.7b", True, CHUNK),
             ("qwen2-moe-57b", True, 0),
             ("qwen3-moe-235b-a22b", True, 0))
# The launch floor beside phase 3's topk_gating rows: an empty kernel on
# the same grid, enqueued the same way. Only this script builds it.
EMPTY_KERNEL_CU = r"""
__global__ void empty_kernel() {}

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def adopt_orphans():
    """Make this process the reaper of every process it starts, however
    deep: a process whose parent ended before it is handed to this one,
    not to init, so `stop_children` finds it (Linux; elsewhere a no-op)."""
    import ctypes
    try:
        ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)   # PR_SET_CHILD_SUBREAPER
    except (OSError, AttributeError):
        pass


def _children():
    """{pid: command line} of this process's live or unreaped children."""
    import os
    me, out = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
            if int(stat.rsplit(")", 1)[1].split()[1]) != me:
                continue
            cmd = Path(f"/proc/{d}/cmdline").read_bytes()
            out[int(d)] = (cmd.replace(b"\0", b" ").decode(errors="replace")
                           .strip() or stat.split("(", 1)[1].rsplit(")")[0])
        except (OSError, IndexError, ValueError):
            pass
    return out


def stop_children(grace=5.0):
    """End and reap every process this one started that is still there
    (none should be: each nvcc, nvidia-smi and cuobjdump call is waited
    for), SIGTERM first, SIGKILL after `grace` seconds; returns
    {pid: command line} of those found."""
    import os
    import signal
    found = {}
    for _ in range(10):              # a stopped child's children come next
        kids = _children()
        if not kids:
            break
        found.update(kids)
        for pid in kids:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace
        pending = set(kids)
        while pending:
            for pid in list(pending):
                try:
                    if os.waitpid(pid, os.WNOHANG)[0]:
                        pending.discard(pid)
                except ChildProcessError:
                    pending.discard(pid)
            if pending and time.monotonic() > deadline:
                for pid in pending:
                    try:
                        os.kill(pid, signal.SIGKILL)
                        os.waitpid(pid, 0)
                    except (ProcessLookupError, ChildProcessError):
                        pass
                pending.clear()
            time.sleep(0.05)
    return found


def teardown(torch):
    """Before the result: wait for the card, free its cached blocks and the
    cached page-locked host memory, and check that no thread but this one
    is left, so the process ends as soon as it has printed."""
    import threading
    gc.collect()
    torch.cuda.synchronize()
    torch._C._host_emptyCache()
    torch.cuda.empty_cache()
    left = [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not t.daemon]
    check(not left, f"threads still running at the end: {left}")


def time_ms(torch, fn, reps=5, inner=5):
    """Median over `reps` CUDA-event windows of `inner` back-to-back calls,
    per call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return statistics.median(out)


def launch_split(torch, fn, reps=20):
    """Device time of each CUDA kernel that one call of `fn` launches, ms
    per call, from a `torch.profiler` trace of `reps` calls after a
    warm-up: {kernel: ms}, in launch order; {} where the profiler saw no
    device time."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        t = (ev.device_time_total
             if ev.device_type == torch.autograd.DeviceType.CUDA else 0)
        m = re.search(r"(\w+_kernel)(<[^>(]*>)?", ev.name)
        if t <= 0 or not m:
            continue
        name = m.group(1) + (m.group(2) or "").replace(" ", "")
        split[name] = split.get(name, 0.0) + t / reps / 1e3
    return split


def mount_of(path):
    """(mount point, filesystem type) holding `path`, from /proc/mounts."""
    import os
    path = os.path.realpath(path)
    best = ("", "?")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt, fstype = parts[1], parts[2]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best[0]):
                    best = (mnt, fstype)
    except OSError:
        pass
    return best


def threaded(fn, items, workers=8):
    """`fn` over `items` on `workers` threads (file reads and zlib's CRC
    release the GIL); results in order."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def disk_probe(np, gb=16.0, record=55_050_240):
    """The shard disk's rates: free bytes of the temporary directory (where
    phase 12 writes its shards), `gb` GB written in 64 MiB blocks and
    fsync'd, then read back after POSIX_FADV_DONTNEED (from the disk, not
    the page cache) record by record (`record` bytes, a qwen2 expert) on
    one thread and on 8, and again on 8 from the page cache; zlib.crc32 over
    such records on one thread and on 8."""
    import os
    import shutil
    import tempfile
    import zlib
    tmp = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    out = {"tmpdir": tmp, "mount": mount_of(tmp),
           "free_GB": shutil.disk_usage(tmp).free / 1e9,
           "repo_free_GB": shutil.disk_usage(ROOT).free / 1e9,
           "cpus": os.cpu_count()}
    with open("/proc/meminfo") as f:
        mem = dict(line.split(":", 1) for line in f)
    out["mem_total_GB"] = int(mem["MemTotal"].split()[0]) * 1024 / 1e9
    out["mem_available_GB"] = \
        int(mem["MemAvailable"].split()[0]) * 1024 / 1e9
    log(f"disk: {json.dumps(out)}")
    try:
        block = np.random.default_rng(SEED).integers(
            0, 256, 64 << 20, dtype=np.uint8)
        n_blocks = int(gb * 1e9) // block.size
        path = os.path.join(tmp, "probe.bin")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            for _ in range(n_blocks):
                f.write(memoryview(block))
            f.flush()
            os.fsync(f.fileno())
        nbytes = n_blocks * block.size
        out["write_GBps"] = nbytes / (time.perf_counter() - t0) / 1e9
        fd = os.open(path, os.O_RDONLY)
        n_rec = nbytes // record
        bufs = [np.empty(record, np.uint8) for _ in range(8)]

        def read(i, buf):
            got = os.preadv(fd, [memoryview(buf)], i * record)
            assert got == record, got

        def drop():
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)

        def rate(fn):
            t0 = time.perf_counter()
            fn()
            return n_rec * record / (time.perf_counter() - t0) / 1e9
        drop()
        out["read_cold_1_GBps"] = rate(
            lambda: [read(i, bufs[0]) for i in range(n_rec)])
        drop()
        out["read_cold_8_GBps"] = rate(lambda: threaded(
            lambda i: read(i, bufs[i % 8]), range(n_rec)))
        out["read_warm_8_GBps"] = rate(lambda: threaded(
            lambda i: read(i, bufs[i % 8]), range(n_rec)))
        drop()
        os.close(fd)
        t0 = time.perf_counter()
        for b in bufs:
            zlib.crc32(b)
        out["crc32_1_GBps"] = 8 * record / (time.perf_counter() - t0) / 1e9
        t0 = time.perf_counter()
        threaded(zlib.crc32, bufs * 4)
        out["crc32_8_GBps"] = 32 * record / (time.perf_counter() - t0) / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"disk: {json.dumps(out)}")
    return out


def bound(nbytes, ops):
    """(bound ms, what bounds it): `ops` is [(operations, peak per s)]."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = sum(n / peak for n, peak in ops) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gemm_ops(flops, f32):
    """The SwiGLU GEMM's operations for `bound`: bf16 products on the
    tensor cores, or f32 as 3xTF32 (three TF32 products a multiply-add)."""
    return ([(3 * flops, H100_TF32_FLOP_PER_S)] if f32
            else [(flops, H100_BF16_FLOP_PER_S)])


def rates(nbytes, flops, ms):
    """Achieved TB/s and TFLOP/s of `nbytes` and `flops` done in `ms`."""
    return {"achieved_tb_s": nbytes / ms / 1e9,
            "achieved_tflop_s": flops / ms / 1e9}


def kernel_name(mangled):
    """The `...kernel` identifier of a mangled entry-function name, with its
    first template argument (`swiglu_gemm_kernel<1>`)."""
    import re
    i = 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            break
        j = i + len(m.group(0))
        ident, i = mangled[j:j + int(m.group(0))], j + int(m.group(0))
        if "kernel" in ident:
            t = re.match(r"IL[a-z](\d+)E", mangled[i:])
            return ident + (f"<{t.group(1)}>" if t else "")
    return mangled


def start_empty_kernel_build(build):
    """Start nvcc on `EMPTY_KERNEL_CU` into the port's git-ignored build
    directory, beside the kernels' own builds; returns a function that
    waits for it and loads the library."""
    import ctypes
    out_dir = build.BUILD_ROOT / "launch_floor"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "empty.cu", out_dir / "libempty.so"
    src.write_text(EMPTY_KERNEL_CU)
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def finish():
        out, _ = proc.communicate()
        check(proc.returncode == 0,
              f"nvcc failed for the empty kernel:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int
        return lib
    return finish


def build_report(build):
    """Per kernel library: each entry function's registers, static shared
    memory and spills as ptxas reported them, with ptxas's performance
    warnings (serialised wgmma), and, for the three libraries
    of the SwiGLU GEMM, how many HGMMA (wgmma), UTMALDG (TMA load) and TF32
    HMMA (mma.sync, the f32 path's 3xTF32) instructions their SASS holds
    (`cuobjdump -sass`, where the toolkit has it)."""
    import os
    import re
    import shutil
    info = {}
    for name, out in build.LIBS.build_log.items():
        fn, entries = None, []
        for line in out.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                fn = kernel_name(m.group(1))
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):   # e.g. serialised wgmma
                entries.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
        info[name] = {"ptxas": entries}
        for e in entries:
            log(f"build {name}: {e}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in ("slot_ffn", "expert_ffn", "fused_moe_entry"):
        info.setdefault(name, {"ptxas": []})
        if not os.path.exists(cuobjdump):
            info[name]["sass"] = "not checked"
            log(f"build {name}: SASS not checked (no cuobjdump)")
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(build._lib_path(name))],
                              capture_output=True, text=True).stdout
        info[name]["sass"] = {op: sass.count(op) for op in ("HGMMA",
                                                            "UTMALDG")}
        info[name]["sass"]["HMMA.TF32"] = len(
            re.findall(r"HMMA\.\S*TF32", sass))
        log(f"build {name}: SASS holds {info[name]['sass']}")
    return info


# --------------------------------------------------------------- phase 3

def slot_ffn_inputs(torch, moe_mod, g, *, B, T, k, E, D, F, S, resident_frac,
                    n_resident=None):
    """A dispatch buffer, slot table and row counts shaped as the serving
    path builds them: T*B tokens route to k distinct experts each, the
    buffer holds capacity B*T*k rows per expert (the rest zero padding),
    routed experts sit in distinct slots, and a share of the others is
    resident too (the rest point at slot 0, as `moe_slotbuf` clamps
    non-resident entries); with `n_resident`, that many experts drawn at
    random are resident instead, as in serving when a layer's working set
    overflows its slots. The counts are `moe_slotbuf`'s (the dispatch's
    rows per expert, 0 where not resident)."""
    dev = "cuda"
    n = B * T
    x_tok = torch.randn((n, D), generator=g, device=dev).to(torch.bfloat16)
    logits = torch.randn((n, E), generator=g, device=dev)
    _, ids = moe_mod.top_k_first_max(logits, k)
    buf, *_, counts = moe_mod._dispatch_gather(x_tok, ids, E, n * k)
    routed = torch.zeros(E, dtype=torch.bool, device=dev)
    routed[ids.reshape(-1)] = True
    keep = routed | (torch.rand(E, generator=g, device=dev) < resident_frac)
    if n_resident is not None:
        keep = torch.zeros_like(keep)
        keep[torch.randperm(E, generator=g, device=dev)[:n_resident]] = True
    perm = torch.randperm(S, generator=g, device=dev)[:E].to(torch.int32)
    table = torch.where(keep, perm, torch.full_like(perm, -1))
    counts = moe_mod.slot_ffn_row_counts(counts, table, n * k)
    slot = torch.clamp(table, min=0).contiguous()
    w = lambda *s: (torch.randn(s, generator=g, device=dev)  # noqa: E731
                    * s[-2] ** -0.5).to(torch.bfloat16)
    wg, wu, wd = w(S, D, F), w(S, D, F), w(S, F, D)
    return (buf.contiguous(), slot, wg, wu, wd), counts, slot[routed & keep]


def slot_ffn_phase(torch, moe_mod, slot_gather, ref, g):
    import torch.nn.functional as Fn

    def library(x, slot, wg, wu, wd):
        # yardstick only: a slot gather + torch.bmm chain (bf16 throughout)
        idx = slot.long()
        h = Fn.silu(torch.bmm(x, wg[idx])) * torch.bmm(x, wu[idx])
        return torch.bmm(h, wd[idx]).float()

    shapes = {
        "decode": dict(B=4, T=1, k=8, E=64, D=2048, F=1024, S=256,
                       resident_frac=0.25),
        "prefill": dict(B=1, T=128, k=8, E=64, D=2048, F=1024, S=256,
                        resident_frac=0.25),
        "ragged": dict(B=1, T=5, k=2, E=3, D=96, F=40, S=4,
                       resident_frac=1.0),
        "deepseek_decode": dict(B=4, T=1, k=6, E=64, D=2048, F=1408, S=416,
                                resident_frac=0.25),
        "deepseek_prefill": dict(B=1, T=128, k=6, E=64, D=2048, F=1408,
                                 S=416, resident_frac=0.25),
        # one prefill chunk of the chunked serving runs
        "chunk": dict(B=1, T=CHUNK, k=8, E=64, D=2048, F=1024, S=256,
                      resident_frac=0.25),
        "deepseek_chunk": dict(B=1, T=CHUNK, k=6, E=64, D=2048, F=1408,
                               S=416, resident_frac=0.25),
        # a chunk as serving meets it: 16 of the 64 experts resident
        "chunk_16_resident": dict(B=1, T=CHUNK, k=8, E=64, D=2048, F=1024,
                                  S=256, resident_frac=0.0, n_resident=16),
        # the f32 path (the reference runs slot_ffn in f32 too)
        "f32_decode": dict(B=4, T=1, k=8, E=64, D=2048, F=1024, S=256,
                           resident_frac=0.25, f32=True),
        "f32_ragged": dict(B=1, T=5, k=2, E=3, D=96, F=40, S=4,
                           resident_frac=1.0, f32=True),
        # a prefill chunk's buffer (256 rows an expert): the wgmma route
        "f32_chunk": dict(B=1, T=CHUNK, k=8, E=64, D=2048, F=1024, S=256,
                          resident_frac=0.25, f32=True),
        # the Qwen models' decode and chunk shapes (16 slots a layer over
        # phase 10's depths), and an empty work list: no expert resident
        "qwen15_decode": dict(B=4, T=1, k=4, E=60, D=2048, F=1408, S=384,
                              resident_frac=0.25),
        "qwen15_chunk": dict(B=1, T=CHUNK, k=4, E=60, D=2048, F=1408,
                             S=384, resident_frac=0.25),
        "qwen2_decode": dict(B=4, T=1, k=8, E=64, D=3584, F=2560, S=192,
                             resident_frac=0.25),
        "qwen2_chunk": dict(B=1, T=CHUNK, k=8, E=64, D=3584, F=2560, S=192,
                            resident_frac=0.25),
        "qwen3_decode": dict(B=4, T=1, k=8, E=128, D=4096, F=1536, S=128,
                             resident_frac=0.25),
        "qwen3_chunk": dict(B=1, T=CHUNK, k=8, E=128, D=4096, F=1536,
                            S=128, resident_frac=0.25),
        "qwen15_decode_empty": dict(B=4, T=1, k=4, E=60, D=2048, F=1408,
                                    S=384, resident_frac=0.0, n_resident=0),
        "qwen3_chunk_empty": dict(B=1, T=CHUNK, k=8, E=128, D=4096, F=1536,
                                  S=128, resident_frac=0.0, n_resident=0),
    }
    results = {}
    for name, sh in shapes.items():
        f32 = sh.pop("f32", False)
        args, counts, routed_slots = slot_ffn_inputs(torch, moe_mod, g, **sh)
        if f32:
            args = tuple(a.float() if a.is_floating_point() else a
                         for a in args)
        tol = TOL_F32 if f32 else TOL
        isz = args[0].element_size()
        x = args[0]
        E, C, D = x.shape
        F = args[2].shape[-1]
        # with counts (the serving path's call): rows < counts[e] only
        got = slot_gather.slot_ffn(*args, counts=counts)
        again = slot_gather.slot_ffn(*args, counts=counts)
        want = ref.slot_ffn_ref(*args, counts=counts)
        # without counts: every row, the reference's function
        got_all = slot_gather.slot_ffn(*args)
        want_all = ref.slot_ffn_ref(*args)
        torch.cuda.synchronize()
        live = (torch.arange(C, device="cuda")[None, :]
                < counts.long()[:, None])[..., None]
        counted = lambda y: torch.where(live, y, 0)  # noqa: E731
        err = float((counted(got) - want).abs().max())
        err_all = float((got_all - want_all).abs().max())
        check(torch.allclose(counted(got), want, rtol=tol, atol=tol),
              f"slot_ffn with counts disagrees with its plain version at "
              f"{name}: max |err| {err}")
        check(torch.allclose(got_all, want_all, rtol=tol, atol=tol),
              f"slot_ffn disagrees with its plain version at {name}: "
              f"max |err| {err_all}")
        check(torch.equal(counted(got), counted(again))
              and torch.equal(counted(got), counted(got_all)),
              f"slot_ffn rows < counts differ between runs or from the "
              f"all-rows call at {name}")
        rows = int(counts.sum())                      # rows holding tokens
        check((rows == 0) == (sh.get("n_resident") == 0),
              f"slot_ffn {name}: {rows} counted rows")
        distinct = int(torch.unique(routed_slots).numel())
        w_bytes = distinct * 3 * D * F * isz
        nbytes = rows * D * (isz + 4) + E * 8 + w_bytes
        flops = 2 * 3 * D * F * rows
        b_ms, b_by = bound(nbytes, gemm_ops(flops, f32))
        # the all-rows figure: every row of the buffer read and written
        b_all_ms, _ = bound(x.numel() * isz + E * C * D * 4 + E * 4 + w_bytes,
                            gemm_ops(flops, f32))
        dense_ms = bound(0, gemm_ops(2 * 3 * D * F * E * C, f32))[0]
        heavy = E * C * D > 2 ** 26
        r = {
            "shape": {"E": E, "C": C, "D": D, "F": F,
                      "S": args[2].shape[0]}, "dtype": str(x.dtype),
            "max_abs_err": max(err, err_all),
            "max_abs_err_counted_rows": err,
            "max_abs_err_all_rows": err_all,
            "ms": time_ms(torch, lambda: slot_gather.slot_ffn(
                *args, counts=counts)),
            "ms_all_rows": time_ms(torch, lambda: slot_gather.slot_ffn(*args)),
            "plain_ms": time_ms(torch, lambda: ref.slot_ffn_ref(
                *args, counts=counts), reps=3, inner=2 if heavy else 5),
            "library_ms": time_ms(torch, lambda: library(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_all_rows_ms": b_all_ms,
            "needed_rows": rows, "computed_experts": int((counts > 0).sum()),
            "distinct_routed_slots": distinct,
            "dense_rows_flop_ms": dense_ms,
        }
        r.update(rates(nbytes, flops, r["ms"]))
        if f32:
            r["launch_split_ms"] = launch_split(
                torch, lambda: slot_gather.slot_ffn(*args, counts=counts))
        results[name] = r
        log(f"kernel slot_ffn {name} {r['shape']}: {rows} rows over "
            f"{r['computed_experts']} experts; max|err| {err:.3g} (counted "
            f"rows), {err_all:.3g} (all rows); kernel {r['ms']:.4f} ms with "
            f"counts, {r['ms_all_rows']:.4f} ms all rows; plain "
            f"{r['plain_ms']:.4f} ms, gather+bmm {r['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; reading and writing all {E * C} "
            f"rows: {b_all_ms:.4f} ms; all rows dense FLOPs: "
            f"{dense_ms:.4f} ms); {r['achieved_tb_s']:.3f} TB/s, "
            f"{r['achieved_tflop_s']:.2f} TFLOP/s"
            + (f"; per launch (profiler, ms) {r['launch_split_ms']}"
               if f32 else ""))
        del args, got, again, want, got_all, want_all
        torch.cuda.empty_cache()
    return results


def moe_entry_phase(torch, dsk, ref, g):
    """`fused_moe_entry` at olmoe-1b-7b's and DeepSeek-V2-Lite's decode
    shapes."""
    results = moe_entry_cases(torch, dsk, ref, g, T=4, d=2048, E=64, k=8,
                              f=1024, S=256, prefix="")
    results.update(moe_entry_cases(torch, dsk, ref, g, T=4, d=2048, E=64,
                                   k=6, f=1408, S=416, prefix="deepseek_",
                                   only_all_routed=True))
    # 64 tokens: up to 512 rows over the 64 experts
    results.update(moe_entry_cases(torch, dsk, ref, g, T=64, d=2048, E=64,
                                   k=8, f=1024, S=256, prefix="t64_",
                                   only_all_routed=True))
    # the f32 path (the reference runs fused_moe_entry in f32 too)
    results.update(moe_entry_cases(torch, dsk, ref, g, T=4, d=2048, E=64,
                                   k=8, f=1024, S=256, prefix="f32_",
                                   only_all_routed=True, f32=True))
    # more than 64 tokens: the f32 GEMM's wgmma route, the combine folded in
    results.update(moe_entry_cases(torch, dsk, ref, g, T=128, d=2048, E=64,
                                   k=8, f=1024, S=256, prefix="f32_t128_",
                                   only_all_routed=True, f32=True))
    # the Qwen models' decode shapes (E = 60 leaves padding entries in a
    # route lane), with an empty work list (no expert resident, as under a
    # total link outage) for the narrowest and the widest
    for prefix, E, k, d, f, empty in (("qwen15_", 60, 4, 2048, 1408, True),
                                      ("qwen2_", 64, 8, 3584, 2560, False),
                                      ("qwen3_", 128, 8, 4096, 1536, True)):
        results.update(moe_entry_cases(torch, dsk, ref, g, T=4, d=d, E=E,
                                       k=k, f=f, S=E, prefix=prefix,
                                       empty=empty))
    return results


def moe_entry_cases(torch, dsk, ref, g, *, T, d, E, k, f, S, prefix,
                    only_all_routed=False, f32=False, empty=False):
    import torch.nn.functional as Fn
    dev = "cuda"

    def library(x, rw, bias, soe, sg, su, sd):
        # yardstick only: route + gather of the routed experts + torch.bmm
        probs = torch.softmax(x.float() @ rw + bias, dim=-1)
        gates, ids = torch.topk(probs, k)
        gates = gates / gates.sum(-1, keepdim=True)
        gates = gates * (soe[ids] >= 0)
        slot = soe[ids].clamp(min=0).long().reshape(-1)
        xr = x.repeat_interleave(k, 0)[:, None]               # (T*k, 1, d)
        h = Fn.silu(torch.bmm(xr, sg[slot])) * torch.bmm(xr, su[slot])
        part = torch.bmm(h, sd[slot])[:, 0].float().view(T, k, d)
        return (part * gates[..., None]).sum(1)

    dt = torch.float32 if f32 else torch.bfloat16
    tol = TOL_F32 if f32 else TOL
    w = lambda *s: (torch.randn(s, generator=g, device=dev)  # noqa: E731
                    * s[-2] ** -0.5).to(dt)
    sg, su, sd = w(S, d, f), w(S, d, f), w(S, f, d)
    x = torch.randn((T, d), generator=g, device=dev).to(dt)
    rw = torch.randn((d, E), generator=g, device=dev) * d ** -0.5
    perm = torch.randperm(S, generator=g, device=dev)[:E].to(torch.int32)
    probs = torch.softmax(x.float() @ rw, dim=-1)
    routed = torch.zeros(E, dtype=torch.bool, device=dev)
    routed[torch.topk(probs, k).indices.reshape(-1)] = True
    cases = {
        # as after a verified sync: every routed expert resident, plus a
        # quarter of the rest
        "decode": (routed | (torch.rand(E, generator=g, device=dev) < 0.25),
                   torch.zeros(E, device=dev)),
        # 16 resident experts, some routed ones absent; a nonzero bias
        "decode_16_resident": (
            torch.zeros(E, dtype=torch.bool, device=dev).index_fill_(
                0, torch.randperm(E, generator=g, device=dev)[:16], True),
            torch.randn(E, generator=g, device=dev) * 0.5),
    }
    if only_all_routed:
        del cases["decode_16_resident"]
    if empty:
        cases["decode_empty"] = (torch.zeros(E, dtype=torch.bool, device=dev),
                                 torch.zeros(E, device=dev))
    results = {}
    for name, (resident, bias) in cases.items():
        name = prefix + name
        soe = torch.where(resident, perm, torch.full_like(perm, -1))
        args = (x, rw, bias, soe, sg, su, sd)
        y, gates, ids = dsk.fused_moe_entry(*args, top_k=k)
        y2, _, _ = dsk.fused_moe_entry(*args, top_k=k)
        yr, gr, ir = ref.fused_moe_entry_ref(*args, top_k=k)
        torch.cuda.synchronize()
        err = float((y - yr).abs().max())
        check(torch.equal(ids, ir), f"fused_moe_entry ids differ at {name}")
        check(float((gates - gr).abs().max()) <= TOL_GATES,
              f"fused_moe_entry gates differ at {name}")
        check(torch.allclose(y, yr, rtol=tol, atol=tol),
              f"fused_moe_entry y disagrees at {name}: max |err| {err}")
        check(torch.equal(y, y2), "fused_moe_entry not deterministic")
        check(bool(resident.any()) or not (y.any() or gates.any()),
              f"fused_moe_entry {name}: an empty work list gave a nonzero "
              f"y or gate")
        live = soe[ids.long()] >= 0
        pairs = int(live.sum())
        distinct = int(torch.unique(ids[live]).numel())
        isz = x.element_size()
        nbytes = (x.numel() * isz + rw.numel() * 4 + E * 4 + E * 4
                  + distinct * 3 * d * f * isz + T * d * 4 + T * k * 8)
        flops = 2 * 3 * d * f * pairs
        b_ms, b_by = bound(nbytes, gemm_ops(flops, f32)
                           + [(2 * T * d * E, H100_FP32_FLOP_PER_S)])
        r = {"shape": {"T": T, "d": d, "E": E, "k": k, "f": f, "S": S},
             "dtype": str(dt), "resident": int(resident.sum()), "routed_resident_pairs": pairs,
             "distinct_routed_resident": distinct,
             "max_abs_err": err,
             "ms": time_ms(torch, lambda: dsk.fused_moe_entry(*args,
                                                              top_k=k)),
             "plain_ms": time_ms(torch, lambda: ref.fused_moe_entry_ref(
                 *args, top_k=k), reps=3, inner=2),
             "library_ms": time_ms(torch, lambda: library(*args)),
             "bound_ms": b_ms, "bound_by": b_by,
             "launch_split_ms": launch_split(
                 torch, lambda: dsk.fused_moe_entry(*args, top_k=k))}
        r.update(rates(nbytes, flops, r["ms"]))
        results[name] = r
        log(f"kernel fused_moe_entry {name}: {distinct} distinct routed "
            f"resident experts ({pairs} pairs), max|err| {err:.3g}, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, route+gather+"
            f"bmm {r['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"{r['achieved_tb_s']:.3f} TB/s, {r['achieved_tflop_s']:.2f} "
            f"TFLOP/s; per launch (profiler, ms) {r['launch_split_ms']}")
    del sg, su, sd
    torch.cuda.empty_cache()
    return results


def attention_phase(torch, dsk, ref, g):
    """`fused_decode_attention` at olmoe-1b-7b's decode shape, a wrapped
    ring, GQA shapes, a cache length that no split divides, a long cache,
    the widest group at the narrowest and widest head dims with every row
    empty, and one length for every row (a () `cache_len`)."""
    import torch.nn.functional as Fn
    dev = "cuda"
    B = 4

    def library(q, kn, vn, kc, vc, clen):
        # yardstick only: clone + ring insert + scaled_dot_product_attention
        S = kc.shape[1]
        clen = clen.reshape(-1).expand(B)
        rows = torch.arange(B, device=dev)
        slot = clen % S
        k2, v2 = kc.clone(), vc.clone()
        k2[rows, slot] = kn[:, 0]
        v2[rows, slot] = vn[:, 0]
        valid = (clen + 1).clamp(max=S)
        mask = torch.arange(S, device=dev)[None] < valid[:, None]
        out = Fn.scaled_dot_product_attention(
            q.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2),
            attn_mask=mask[:, None, None, :],
            enable_gqa=q.shape[2] != kc.shape[2])
        return out.transpose(1, 2), k2, v2

    # name: (Hq, Hkv, D, S, cache lengths; an int is one () length)
    cases = {"decode": (16, 16, 128, 256, [0, 63, 128, 255]),
             "wrapped": (16, 16, 128, 256, [256, 300, 511, 1000]),
             "gqa_G4": (16, 4, 128, 256, [17, 255, 0, 90]),
             "s130": (16, 16, 128, 130, [0, 129, 70, 300]),
             "s2048": (16, 16, 128, 2048, [0, 511, 1500, 2047]),
             "g16_d64_empty": (32, 2, 64, 256, [0, 0, 0, 0]),
             "g16_d256_empty": (32, 2, 256, 256, [0, 0, 0, 0]),
             "one_length": (16, 16, 128, 256, 100),
             # the f32 path (the reference runs it in f32 too)
             "f32_decode": (16, 16, 128, 256, [0, 63, 128, 255]),
             "f32_gqa_G4": (16, 4, 128, 256, [17, 255, 0, 90]),
             # the Qwen models' groups at head dim 128 (qwen1.5 is
             # "decode"): qwen2 G = 7, qwen3 G = 16
             "qwen2_G7": (28, 4, 128, 256, [0, 63, 128, 255]),
             "qwen3_G16": (64, 4, 128, 256, [0, 63, 128, 255]),
             # gemma2-9b's local layer: a 4096-row window ring, lengths
             # that wrap it, soft-cap 50 (held by gemma2_held below)
             "gemma2_local": (16, 8, 256, 4096, [100, 4095, 5000, 12345]),
             # recurrentgemma-2b's local MQA layer: G = 10, a 2048-row
             # window ring, lengths that wrap it
             "recurrentgemma_local": (10, 1, 256, 2048,
                                      [100, 2047, 2100, 5000]),
             # whisper-large-v3's decoder self-attention (no rope)
             "whisper_decoder": (20, 20, 64, 256, [0, 63, 128, 255])}
    results = {}
    for name, (Hq, Hkv, D, S, clens) in cases.items():
        gemma2 = name.startswith("gemma2")
        caps = (50.0,) if gemma2 else (0.0, 30.0)
        tcap = caps[-1] if gemma2 else 0.0
        f32 = name.startswith("f32")
        dt = torch.float32 if f32 else torch.bfloat16
        tol = TOL_F32 if f32 else TOL
        r16 = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                     device=dev).to(dt)
        # gemma2: queries at 8x, so the scores reach the tens and the cap
        # changes them by O(1)
        args = (r16(B, 1, Hq, D) * (GEMMA2_Q_GAIN if gemma2 else 1),
                r16(B, 1, Hkv, D), r16(B, 1, Hkv, D),
                r16(B, S, Hkv, D), r16(B, S, Hkv, D),
                torch.tensor(clens, device=dev))
        err = lib_err = 0.0
        if gemma2:
            err = gemma2_held(torch, dsk, ref, args, name)
            caps = ()
        for cap in caps:
            o, k2, v2 = dsk.fused_decode_attention(*args, logit_softcap=cap)
            o2, _, _ = dsk.fused_decode_attention(*args, logit_softcap=cap)
            orf, kr, vr = ref.fused_decode_attention_ref(
                *args, logit_softcap=cap)
            torch.cuda.synchronize()
            check(torch.isfinite(o).all(),
                  f"fused_decode_attention out not finite at {name}")
            check(torch.equal(k2, kr) and torch.equal(v2, vr),
                  f"fused_decode_attention caches differ at {name}")
            e = float((o.float() - orf.float()).abs().max())
            check(e <= tol, f"fused_decode_attention out disagrees at {name}"
                            f" softcap {cap}: max |err| {e}")
            check(torch.equal(o, o2), "fused_decode_attention not "
                                      "deterministic")
            err = max(err, e)
        lib_err = float((library(*args)[0].float() - ref.
                         fused_decode_attention_ref(*args)[0].float())
                        .abs().max())
        library_ms = time_ms(torch, lambda: library(*args))
        lens = [clens] * B if isinstance(clens, int) else clens
        valid = sum(min(c + 1, S) for c in lens)
        isz = args[0].element_size()
        nbytes = (4 * B * S * Hkv * D * isz + B * Hq * D * isz * 2
                  + 2 * B * Hkv * D * isz + B * 8)
        b_ms, b_by = bound(nbytes, [(4 * Hq * D * valid,
                                     H100_FP32_FLOP_PER_S)])
        r = {"shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S": S,
                       "cache_len": clens}, "dtype": str(dt),
             "max_abs_err": err, "softcap": tcap,
             "ms": time_ms(torch, lambda: dsk.fused_decode_attention(
                 *args, logit_softcap=tcap)),
             "plain_ms": time_ms(torch, lambda:
                                 ref.fused_decode_attention_ref(
                                     *args, logit_softcap=tcap)),
             "library_ms": library_ms,
             "library_max_abs_err": lib_err,
             "bound_ms": b_ms, "bound_by": b_by,
             "launch_split_ms": launch_split(
                 torch, lambda: dsk.fused_decode_attention(
                     *args, logit_softcap=tcap))}
        r["device_ms"] = sum(r["launch_split_ms"].values()) or None
        results[name] = r
        log(f"kernel fused_decode_attention {name} {r['shape']}: max|err| "
            f"{err:.3g}, kernel {r['ms']:.4f} ms (device {r['device_ms']}), "
            f"plain {r['plain_ms']:.4f} ms, clone+insert+sdpa "
            f"{library_ms:.4f} ms (max|err| {lib_err:.3g}), bound "
            f"{b_ms:.4f} ms ({b_by})")
    return results


def gemma2_held(torch, dsk, ref, args, name):
    """gemma2's row: the kernel's bf16 output against the plain version on
    the same inputs widened to f32, within half a bf16 step of each value
    (2^-8 relative, since the kernel works in fp32 and rounds once) plus
    1e-4 of fp32 summation order; the capped plain output must stand more
    than 10x that far from the uncapped one, so a kernel that dropped the
    cap could not pass. Caches bitwise. Returns max |err|."""
    cap = 50.0
    o, k2, v2 = dsk.fused_decode_attention(*args, logit_softcap=cap)
    o2, _, _ = dsk.fused_decode_attention(*args, logit_softcap=cap)
    _, kr, vr = ref.fused_decode_attention_ref(*args, logit_softcap=cap)
    wide = [a.float() if a.is_floating_point() else a for a in args]
    r = ref.fused_decode_attention_ref(*wide, logit_softcap=cap)[0]
    r_nocap = ref.fused_decode_attention_ref(*wide)[0]
    torch.cuda.synchronize()
    check(torch.equal(k2, kr) and torch.equal(v2, vr),
          f"fused_decode_attention caches differ at {name}")
    check(torch.equal(o, o2), "fused_decode_attention not deterministic")
    d = (o.float() - r).abs()
    allowed = 2.0 ** -8 * r.abs() + GEMMA2_ATOL
    worst = float((d / allowed).max())
    err = float(d.max())
    cap_gap = float((r_nocap - r).abs().max())
    log(f"{name}: max |out| {float(r.abs().max()):.4g}, max |err| {err:.3g} "
        f"({worst:.3g} of the allowed), max |capped - uncapped| "
        f"{cap_gap:.4g}")
    check(worst <= 1.0, f"fused_decode_attention out disagrees at {name}: "
                        f"max |err| {err} ({worst:.3g}x the allowed)")
    check(cap_gap > 10 * float(allowed.max()),
          f"{name}: the soft-cap moves the output by only {cap_gap}")
    return err


def yardstick_backends(torch, library, args, cr, dsk, scale, outs,
                       sdpa_kernel, SDPBackend):
    """minicpm3's yardstick on each SDPA backend: its ctx's max |err|
    against the plain version (or why the backend refused). The kernel's
    outputs from before must come through these calls bitwise, and its next
    call must give the same bits."""
    keep = [t.clone() for t in outs]
    per = {}
    for b in ("DEFAULT", "MATH", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
              "FLASH_ATTENTION"):
        which = contextlib.nullcontext if b == "DEFAULT" else \
            (lambda b=b: sdpa_kernel(getattr(SDPBackend, b)))
        try:
            out = library(*args, which=which)[0]
            torch.cuda.synchronize()
            per[b] = float((out - cr).abs().max())
        except RuntimeError as e:
            per[b] = "refused: " + str(e).strip().splitlines()[0][:120]
    again = dsk.fused_mla_decode_attention(*args, scale=scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, k) for a, k in zip(outs, keep)),
          "fused_mla_decode_attention's outputs changed beside SDPA")
    check(all(torch.equal(a, k) for a, k in zip(again, keep)),
          "fused_mla_decode_attention gave other bits after SDPA")
    log(f"minicpm3 yardstick by SDPA backend (max |err| against the plain "
        f"version): {json.dumps(per)}")
    return per


def mla_phase(torch, dsk, ref, g):
    """`fused_mla_decode_attention` at DeepSeek-V2-Lite's decode shape and
    at minicpm3-4b's (40 heads: three head groups of the kernel's 16)."""
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel
    dev = "cuda"
    B, S = 4, 256

    def library(q_abs, q_pe, c_new, pe_new, lat, pe, clen, which=None):
        # yardstick only: clone + positional insert + one SDPA call with
        # q = [q_abs | q_pe], k = [latent | pe] (one kv head), v = latent;
        # `which`: the SDPA backend's context (default: the case's)
        rows = torch.arange(B, device=dev)
        lat2, pe2 = lat.clone(), pe.clone()
        lat2[rows, clen] = c_new
        pe2[rows, clen] = pe_new
        q = torch.cat([q_abs, q_pe], -1)[:, :, None]             # (B,H,1,K)
        k = torch.cat([lat2, pe2], -1).float()[:, None]          # (B,1,S,K)
        v = lat2.float()[:, None]
        mask = torch.arange(S, device=dev)[None] <= clen[:, None]
        H = q_abs.shape[1]
        with (which or backend)():
            ctx = Fn.scaled_dot_product_attention(
                q, k.expand(-1, H, -1, -1), v.expand(-1, H, -1, -1),
                attn_mask=mask[:, None, None, :], scale=scale)
        return ctx[:, :, 0], lat2, pe2

    # name: (cache lengths; H, R, P, qk_nope + qk_rope)
    deepseek, minicpm3 = (16, 512, 64, 128 + 64), (40, 256, 32, 64 + 32)
    cases = {"decode": ([0, 63, 128, 255], deepseek),
             "full": ([S - 1] * B, deepseek),
             # the f32 path: f32 caches (the reference runs it in f32 too)
             "f32_decode": ([0, 63, 128, 255], deepseek),
             "minicpm3_decode": ([0, 63, 128, 255], minicpm3)}
    results = {}
    for name, (clens, (H, R, P, qk)) in cases.items():
        scale = qk ** -0.5
        # the yardstick on SDPA's math backend at minicpm3's key width
        # (288): with the default choice there its ctx was wrong (max |err|
        # 0.58 against the plain version) and the checks of the kernel's
        # calls beside it failed; on the math backend both hold
        backend = (lambda: sdpa_kernel(SDPBackend.MATH)) \
            if name.startswith("minicpm3") else contextlib.nullcontext
        f32 = name.startswith("f32")
        dt = torch.float32 if f32 else torch.bfloat16
        tol = TOL_F32 if f32 else TOL_CTX
        f = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
        args = (f(B, H, R) * 0.05, f(B, H, P) * 0.05, f(B, R).to(dt),
                f(B, P).to(dt), f(B, S, R).to(dt), f(B, S, P).to(dt),
                torch.tensor(clens, device=dev))
        max_len = max(clens)
        ctx, lat, pe = dsk.fused_mla_decode_attention(*args, scale=scale)
        ctx2, _, _ = dsk.fused_mla_decode_attention(*args, scale=scale)
        cr, lr, pr = ref.fused_mla_decode_attention_ref(*args, scale=scale)
        cl, ll, pl = library(*args)
        torch.cuda.synchronize()
        check(torch.equal(lat, lr) and torch.equal(pe, pr),
              f"fused_mla_decode_attention caches differ at {name}")
        err = float((ctx - cr).abs().max())
        check(err <= tol, f"fused_mla_decode_attention ctx disagrees at "
                          f"{name}: max |err| {err}")
        # the serving path's call: the host's bound, no device read
        ctx3, lat3, pe3 = dsk.fused_mla_decode_attention(
            *args, scale=scale, max_len=max_len)
        torch.cuda.synchronize()
        check(torch.equal(ctx3, ctx) and torch.equal(lat3, lat)
              and torch.equal(pe3, pe), "fused_mla_decode_attention with "
              "max_len differs from the checked call")
        check(torch.equal(ctx, ctx2), "fused_mla_decode_attention not "
                                      "deterministic")
        lib_err = float((cl - cr).abs().max())
        by_backend = (yardstick_backends(torch, library, args, cr, dsk,
                                         scale, (ctx, lat, pe), sdpa_kernel,
                                         SDPBackend)
                      if name.startswith("minicpm3") else None)
        valid = sum(c + 1 for c in clens)
        isz = args[4].element_size()
        nbytes = (2 * B * S * (R + P) * isz + B * H * (R + P) * 4
                  + B * (R + P) * isz + B * H * R * 4 + B * 8)
        b_ms, b_by = bound(nbytes, [(2 * H * (2 * R + P) * valid,
                                     H100_FP32_FLOP_PER_S)])
        r = {"shape": {"B": B, "H": H, "R": R, "P": P, "S": S,
                       "cache_len": clens}, "dtype": str(dt),
             "max_abs_err": err, "library_max_abs_err": lib_err,
             "library_max_abs_err_by_sdpa_backend": by_backend,
             "ms": time_ms(torch, lambda: dsk._launch_mla(*args, scale)),
             "wrapper_ms": time_ms(torch, lambda: dsk.
                                   fused_mla_decode_attention(
                                       *args, scale=scale)),
             "wrapper_host_bound_ms": time_ms(
                 torch, lambda: dsk.fused_mla_decode_attention(
                     *args, scale=scale, max_len=max_len)),
             "plain_ms": time_ms(torch, lambda:
                                 ref.fused_mla_decode_attention_ref(
                                     *args, scale=scale)),
             "library_ms": time_ms(torch, lambda: library(*args)),
             "bound_ms": b_ms, "bound_by": b_by,
             "launch_split_ms": launch_split(
                 torch, lambda: dsk._launch_mla(*args, scale))}
        results[name] = r
        log(f"kernel fused_mla_decode_attention {name} {r['shape']}: max|err|"
            f" {err:.3g}, kernel {r['ms']:.4f} ms (through the wrapper: "
            f"{r['wrapper_host_bound_ms']:.4f} ms with the host bound, "
            f"{r['wrapper_ms']:.4f} ms reading the lengths back; profiler "
            f"{r['launch_split_ms']}), plain {r['plain_ms']:.4f} ms, "
            f"clone+insert+sdpa {r['library_ms']:.4f} ms (max|err| "
            f"{lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})")
    return results


def topk_phase(torch, ops, ref, g, floor_lib):
    """`topk_gating` through `ops.topk` at the router shapes: olmoe-1b-7b
    decode (T=4) and a batch of prompts (T=512, fp32 and bf16 logits),
    DeepSeek-V2-Lite (k=6), qwen1.5-moe (E=60, no multiple of 32), the
    reference's own test shapes (33, 128, 8) and (7, 8, 8: k = E), the
    largest E it takes (256), and exactly tied logits. ids equal, gates
    within 1e-6 abs / 1e-5 rel. Each shape's time three ways: the wrapper's
    CUDA-event median ("ms", host time included), the same for the bare
    ctypes launch into preallocated outputs ("launch_ms"), and the kernel's
    device time from a profiler trace ("device_ms"); beside them the floor,
    an empty kernel enqueued the same way on the same grid (`floor_lib`,
    built from `EMPTY_KERNEL_CU`)."""
    from repro_torch.kernels.build import LIBS
    dev = "cuda"
    lib = LIBS.get("topk_gating")

    def library(x, k):
        # yardstick only: softmax + torch.topk + normalise
        gates, ids = torch.softmax(x.float(), dim=-1).topk(k)
        return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), ids

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def empty(blocks):
        floor_lib.empty_launch(blocks, 256, stream())   # topk's block size

    def bare(x, k, out):
        # the kernel's launch alone: no checks, no allocation
        lib.topk_gating_launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                               out.data_ptr(), out[x.shape[0] * k:].data_ptr(),
                               x.shape[0], x.shape[1], k, 1, stream())

    cases = {"olmoe_decode": (4, 64, 8), "olmoe_batch": (512, 64, 8),
             "olmoe_batch_bf16": (512, 64, 8),
             "deepseek_batch": (512, 64, 6), "qwen_batch": (512, 60, 4),
             "wide_e": (33, 128, 8), "e256": (256, 256, 8),
             "k_equals_e": (7, 8, 8), "tied": (64, 64, 8)}
    results = {}
    for name, (T, E, k) in cases.items():
        if name == "tied":          # pairs of equal logits and a tied row
            x = torch.randn((T, E // 2), generator=g,
                            device=dev).repeat_interleave(2, dim=1)
            x[0] = 0.0
        else:
            x = torch.randn((T, E), generator=g, device=dev)
        if name.endswith("bf16"):
            x = x.bfloat16()
        gates, ids = ops.topk(x, k)
        gates2, ids2 = ops.topk(x, k)
        gr, ir = ref.topk_gating_ref(x, k)
        torch.cuda.synchronize()
        check(torch.equal(ids, ir), f"topk_gating ids differ at {name}")
        err = float((gates - gr).abs().max())
        check(torch.allclose(gates, gr, rtol=TOL_TOPK_REL,
                             atol=TOL_TOPK_ABS),
              f"topk_gating gates disagree at {name}: max |err| {err}")
        check(torch.equal(gates, gates2) and torch.equal(ids, ids2),
              "topk_gating not deterministic")
        if name == "tied":
            check(ids[0].tolist() == list(range(k)),
                  f"tied row did not pick the lowest ids: {ids[0].tolist()}")
        nbytes = T * E * x.element_size() + T * k * 8
        b_ms, b_by = bound(nbytes, [(T * E * (k + 6),
                                     H100_FP32_FLOP_PER_S)])
        out = torch.empty(2 * T * k, dtype=torch.float32, device=dev)
        blocks = -(-T // 8)             # the grid of 8 rows a block
        split = launch_split(torch, lambda: ops.topk(x, k))
        floor_split = launch_split(torch, lambda: empty(blocks))
        r = {"shape": {"T": T, "E": E, "k": k}, "dtype": str(x.dtype),
             "max_abs_err": err,
             "ms": time_ms(torch, lambda: ops.topk(x, k)),
             "launch_ms": time_ms(torch, lambda: bare(x, k, out)),
             "empty_launch_ms": time_ms(torch, lambda: empty(blocks)),
             "launch_split_ms": split,
             "device_ms": sum(split.values()) or None,
             "empty_device_ms": sum(floor_split.values()) or None,
             "plain_ms": time_ms(torch, lambda: ref.topk_gating_ref(x, k)),
             "library_ms": time_ms(torch, lambda: library(x, k)),
             "bound_ms": b_ms, "bound_by": b_by}
        results[name] = r
        log(f"kernel topk_gating {name} {r['shape']} {r['dtype']}: max|err| "
            f"{err:.3g}, kernel {r['ms']:.4f} ms through the wrapper, "
            f"{r['launch_ms']:.4f} ms bare launch, device {r['device_ms']} "
            f"ms; empty kernel on {blocks} blocks {r['empty_launch_ms']:.4f}"
            f" ms, device {r['empty_device_ms']} ms; plain "
            f"{r['plain_ms']:.4f} ms, softmax+topk {r['library_ms']:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by})")
    return results


def expert_ffn_phase(torch, ops, ref, g):
    """`expert_ffn` through `ops.expert_ffn` at olmoe-1b-7b's and
    DeepSeek-V2-Lite's expert widths (64 experts, 128 rows each) and a
    ragged shape, within 2e-2; and `slot_ffn` under the identity table
    equal to it bitwise."""
    import torch.nn.functional as Fn
    dev = "cuda"

    def library(x, wg, wu, wd):
        # yardstick only: three torch.bmm + SiLU, h rounded to bf16
        h = (Fn.silu(torch.bmm(x, wg).float())
             * torch.bmm(x, wu).float()).to(x.dtype)
        return torch.bmm(h, wd).float()

    cases = {"olmoe": (64, 128, 2048, 1024), "deepseek": (64, 128, 2048, 1408),
             "ragged": (3, 40, 64, 48),
             # the f32 path (the reference runs expert_ffn in f32 too)
             "f32_olmoe": (64, 128, 2048, 1024), "f32_ragged": (3, 40, 64, 48)}
    results = {}
    for name, (E, C, D, F) in cases.items():
        f32 = name.startswith("f32")
        dt = torch.float32 if f32 else torch.bfloat16
        tol = TOL_F32 if f32 else TOL
        x = torch.randn((E, C, D), generator=g, device=dev).to(dt)
        w = lambda *s: (torch.randn(s, generator=g, device=dev)  # noqa: E731
                        * s[-2] ** -0.5).to(dt)
        args = (x, w(E, D, F), w(E, D, F), w(E, F, D))
        got = ops.expert_ffn(*args)
        again = ops.expert_ffn(*args)
        want = ref.expert_ffn_ref(*args)
        ident = torch.arange(E, dtype=torch.int32, device=dev)
        via_slots = ops.slot_ffn(args[0], ident, *args[1:])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=tol, atol=tol),
              f"expert_ffn disagrees at {name}: max |err| {err}")
        check(torch.equal(got, again), "expert_ffn not deterministic")
        check(torch.equal(got, via_slots),
              f"slot_ffn under the identity table differs from expert_ffn "
              f"at {name}")
        isz = x.element_size()
        nbytes = E * C * D * isz + 3 * E * D * F * isz + E * C * D * 4
        flops = 6 * E * C * D * F
        b_ms, b_by = bound(nbytes, gemm_ops(flops, f32))
        heavy = E * C * D > 2 ** 23
        r = {"shape": {"E": E, "C": C, "D": D, "F": F}, "dtype": str(dt),
             "max_abs_err": err,
             "slot_ffn_identity_bitwise": True,
             "ms": time_ms(torch, lambda: ops.expert_ffn(*args)),
             "plain_ms": time_ms(torch, lambda: ref.expert_ffn_ref(*args),
                                 reps=3, inner=2 if heavy else 5),
             "library_ms": time_ms(torch, lambda: library(*args)),
             "bound_ms": b_ms, "bound_by": b_by}
        r.update(rates(nbytes, flops, r["ms"]))
        if f32:
            r["launch_split_ms"] = launch_split(
                torch, lambda: ops.expert_ffn(*args), reps=5)
        results[name] = r
        log(f"kernel expert_ffn {name} {r['shape']}: max|err| {err:.3g}, "
            f"slot_ffn(identity) bitwise equal, kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, 3x bmm {r['library_ms']:.4f} ms,"
            f" bound {b_ms:.4f} ms ({b_by}); {r['achieved_tb_s']:.3f} TB/s, "
            f"{r['achieved_tflop_s']:.2f} TFLOP/s"
            + (f"; per launch (profiler, ms) {r['launch_split_ms']}"
               if f32 else ""))
        del args, got, again, want, via_slots
        torch.cuda.empty_cache()
    return results


def kernel_api_phase(torch, ops, ref, moe_mod, g):
    """The path that runs `topk_gating` and `expert_ffn`: the kernel API
    (no serving, training or model path of the reference calls them). One
    MoE layer's routed experts at full width, as a user of `ops` would run
    it: 512 tokens of router logits through `ops.topk`, dispatched into 128
    rows per expert, `ops.expert_ffn`, gate-weighted combine; olmoe-1b-7b
    (64 experts top-8, F=1024) and DeepSeek-V2-Lite (top-6, F=1408). The
    counts are zeroed just before and read just after; the layer's output
    is held against the same chain through the plain versions."""
    dev = "cuda"
    T, D, E, C = 512, 2048, 64, 128
    inputs = []
    for k, F in ((8, 1024), (6, 1408)):
        w = lambda *s: (torch.randn(s, generator=g, device=dev)  # noqa: E731
                        * s[-2] ** -0.5).bfloat16()
        x = torch.randn((T, D), generator=g, device=dev).bfloat16()
        router = torch.randn((D, E), generator=g, device=dev) * D ** -0.5
        inputs.append((k, x, router, w(E, D, F), w(E, D, F), w(E, F, D)))

    def layer(topk, ffn, k, x, router, wg, wu, wd):
        gates, ids = topk(x.float() @ router, k)
        buf, _, _, keep, order, flat_slot, _ = moe_mod._dispatch_gather(
            x, ids.long(), E, C)
        y = ffn(buf.contiguous(), wg, wu, wd)
        weight = gates.reshape(-1)[order] * keep.float()
        out = moe_mod._combine_gather(y.reshape(E * C, D), flat_slot, order,
                                      weight, T, k, valid=keep)
        return out, ids, keep

    ops.topk.launches = ops.expert_ffn.launches = 0
    outs = [layer(ops.topk, ops.expert_ffn, *a) for a in inputs]
    torch.cuda.synchronize()
    launches = {"topk_gating": ops.topk.launches,
                "expert_ffn": ops.expert_ffn.launches}
    check(launches == {"topk_gating": len(inputs), "expert_ffn": len(inputs)},
          f"kernel API path launches {launches}")
    errs = []
    for (out, ids, keep), a in zip(outs, inputs):
        want, want_ids, _ = layer(ref.topk_gating_ref, ref.expert_ffn_ref,
                                  *a)
        check(torch.equal(ids, want_ids), "kernel API path: ids differ")
        check(bool(keep.all()), "kernel API path: an assignment overflowed "
                                "its expert's 128 rows")
        errs.append(float((out - want).abs().max()))
        check(errs[-1] <= TOL, f"kernel API path output disagrees: max "
                               f"|err| {errs[-1]}")
    log(f"kernel API path (512 tokens, one MoE layer, olmoe and deepseek "
        f"widths): launches {launches}, max |out - plain| {errs}")
    return launches, errs


# --------------------------------------------------------------- phase 5-7

def sk_reference_decode_step(eng, tok, state, DecodeState, biases=None,
                             tail_kernel=True):
    """The fully-resident oracle of the superkernel path: the engine's own
    segment functions over every expert of each layer with the identity
    slot table (no slot buffer, no swaps, no pre-gate rows). `biases`: each
    MoE layer's (E,) router-logit bias for `fused_moe_entry`'s operand
    (None: zeros). Trailing dense layers, where the model has them, run
    after the last segment layer by layer through `layer_decode` (their
    attention kernels when `tail_kernel`, else the plain path), then the
    model's logits: not through the engine's tail function."""
    from repro_torch.models.transformer import layer_decode
    segs, tail = eng._sk_segments()
    caches, clen = list(state.caches), state.cache_len
    x = tok
    logits = None
    for li, seg in enumerate(segs):
        x, _, new_cs, logits = eng._sk_seg(
            seg, [eng._p[j] for j in seg], [caches[j] for j in seg], x, clen,
            eng._full_experts(li), eng._ident_map, eng._router_stack[:0],
            eng._zero_bias if biases is None else biases[li], first=li == 0,
            with_logits=li == len(segs) - 1 and not tail)
        for jj, aj in enumerate(seg):
            caches[aj] = new_cs[jj]
    for j in tail:      # layer by layer, not through the engine's tail
        x, caches[j] = layer_decode(eng._p[j], eng.cfg, eng.specs[j], x,
                                    caches[j], clen, use_kernel=tail_kernel)
    if tail:
        logits = eng.model.logits(eng.params, x[:, -1])
    return logits, DecodeState(caches, clen + 1, pos=state.pos + 1)


def biased_reference_decode_step(eng, tok, state, biases):
    """The unfused path's fully-resident oracle (`reference_decode_step`)
    with MoE layer li routed with `biases[li]`: its `_pre_decode` calls,
    one per MoE layer in order, get the bias as their `rbias`."""
    it = iter(biases)
    pre = eng._pre_decode
    eng._pre_decode = lambda *a: pre(*a, rbias=next(it))
    try:
        return eng.reference_decode_step(tok, state)
    finally:
        del eng._pre_decode


def biased_oracle(torch, eng, prompt, superkernel, DecodeState, tag):
    """At the engine's own strength (> 0): one prompt prefilled (unbiased,
    as serving prefills) and decoded single-stream through the slot path,
    teacher-forced on the oracle's greedy tokens, with the residency bias
    each MoE layer routed with at each step recorded (a replay rebuilds
    it: the last one counts); the path's fully-resident oracle, routed with
    those same biases, must give bitwise equal logits. Returns how many
    (step, layer) biases were nonzero."""
    seen = {}
    orig = eng._residency_bias

    def record(li):
        seen[li] = orig(li)
        return seen[li]

    eng._residency_bias = record
    try:
        lg, s_slot = eng.prefill(prompt)
        lr, s_ref = eng.reference_prefill(prompt)
        worst, nonzero, toks = float((lg - lr).abs().max()), 0, []
        for _ in range(16):
            tok = lr.argmax(-1)
            toks.append(int(tok[0]))
            seen.clear()
            lg, s_slot = eng.decode_step(tok, s_slot)
            biases = [seen[li] for li in range(len(eng.moe_layer_ids))]
            nonzero += sum(int(torch.count_nonzero(b)) > 0 for b in biases)
            if superkernel:
                lr, s_ref = sk_reference_decode_step(eng, tok, s_ref,
                                                     DecodeState, biases)
            else:
                lr, s_ref = biased_reference_decode_step(eng, tok, s_ref,
                                                         biases)
            worst = max(worst, float((lg - lr).abs().max()))
    finally:
        del eng._residency_bias
    check(worst == 0.0, f"[{tag}] at strength {eng._route_bias_strength()} "
                        f"the slot path differs from its oracle routed with "
                        f"the same biases: max |dlogit| {worst}")
    check(nonzero > 0, f"[{tag}] no decode step routed with a nonzero bias")
    log(f"oracle [{tag}]: at strength {eng._route_bias_strength()}, "
        f"single-stream slot path bitwise equal to its fully-resident "
        f"oracle routed with the same recorded biases over prefill + 16 "
        f"decode steps ({nonzero} nonzero layer biases; tokens "
        f"{toks[:8]}...)")
    return nonzero


def counters(mods):
    return {n: getattr(mods[n], "launches") for n in KERNELS}


class BiasRecorder:
    """Wraps a routing function during a serving run and keeps each call's
    logit-bias tensor (a reference: no device read during the run), to
    count afterwards the calls that saw a nonzero bias."""

    def __init__(self, module, name, arg):
        self.module, self.name, self.arg = module, name, arg
        self.fn = getattr(module, name)
        self.biases = []

    def __enter__(self):
        def call(*a, **kw):
            b = kw.get("logit_bias", a[self.arg] if len(a) > self.arg
                       else None)
            if b is not None:
                self.biases.append(b)
            return self.fn(*a, **kw)
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def nonzero_calls(self, torch):
        return sum(int(torch.count_nonzero(b)) > 0 for b in self.biases)


def model_at_depth(mods, arch, layers=None):
    """The published config of `arch`, its depth cut to `layers` when
    given (widths untouched)."""
    cfg = mods["get_config"](arch)
    if layers is not None and layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


_PINNED_FOR = [None]   # the config of the last engine's pinned experts


def build_engine(torch, mods, cfg, *, superkernel, slots=16, **kw):
    """Weights drawn from SEED on the card, then the engine (its experts
    move to pinned host memory). The cached pinned host memory is freed
    first unless the last engine built was of the same config: pinning is
    most of an engine's build, and an engine of the same config reuses
    those blocks. Returns (engine, init s, engine s)."""
    if _PINNED_FOR[0] != cfg and hasattr(torch._C, "_host_emptyCache"):
        gc.collect()
        torch._C._host_emptyCache()
    _PINNED_FOR[0] = cfg
    t0 = time.perf_counter()
    model = mods["Model"](cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(g, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = mods["SlotBufferEngine"](
        cfg, params, model, n_slots_per_layer=slots, use_kernel=True,
        use_superkernel=superkernel, max_seq=256, device="cuda", **kw)
    del params                      # the experts now live in pinned memory
    torch.cuda.empty_cache()
    return eng, t_init, time.perf_counter() - t0


def release(torch):
    """Free the card's cached blocks between runs (the cached pinned host
    memory goes when the next engine is of another config:
    `build_engine`)."""
    gc.collect()
    torch.cuda.empty_cache()


def the_requests(np, mods, cfg, seed=SEED):
    """The serving runs' population: 8 greedy requests of 64-128 prompt
    tokens and 16 new tokens, from `seed`."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(k))
               for k in rng.integers(64, 129, 8)]
    return prompts, [mods["Request"](p, max_new_tokens=16) for p in prompts]


def serving_phase(torch, np, mods, *, arch: str, superkernel: bool,
                  chunk: int, mono_outputs=None, route_bias: float = 0.0,
                  base=None, layers=None, why_cut="", prefetch=True):
    """One serving run: `chunk` = 0 admits monolithically, > 0 through
    chunked prefill (then `mono_outputs`, the monolithic run's served
    tokens on the same path and depth, are compared with this run's, where
    given). `route_bias` > 0 serves with §3.4 cache-aware routing at that
    strength; `base` is then the bias-off run of the same path and
    admission, whose counters and streams this run's are printed beside and
    held against. `layers` cuts the depth (`why_cut` says why).
    `prefetch=False` serves the no-prefetch baseline (horizon 0, no
    pre-gate): nothing may be prefetched or run speculatively."""
    path = "superkernel" if superkernel else "unfused"
    admission = f"chunked {chunk}" if chunk else "monolithic"
    tag = f"{arch} {path} {admission}" + (f" bias {route_bias}"
                                          if route_bias else "") \
        + ("" if prefetch else " prefetch off")
    cfg = model_at_depth(mods, arch, layers)
    full_depth = mods["get_config"](arch).num_layers
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    eng, t_init, t_engine = build_engine(torch, mods, cfg,
                                         superkernel=superkernel,
                                         prefetch=prefetch)
    n_moe = len(eng.moe_layer_ids)
    if cfg.num_layers != full_depth:
        log(f"serving [{tag}]: depth cut to {cfg.num_layers} of "
            f"{full_depth} layers ({why_cut}); widths as published")
    log(f"serving [{tag}]: {cfg.num_layers} layers ({n_moe} MoE, "
        f"{cfg.attention} attention), d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
        f"{cfg.moe.num_shared_experts} shared; "
        f"init {t_init:.1f} s on the card, host store "
        f"{eng.store.nbytes / 1e9:.2f} GB pinned ({t_engine:.1f} s), slot "
        f"buffer {eng.n_slots} slots = "
        f"{eng.n_slots * cfg.expert_bytes() / 1e9:.2f} GB")

    prompts, reqs = the_requests(np, mods, cfg)
    srv = mods["ServingEngine"](eng, mods["EngineServingConfig"](
        max_batch=4, admission_cap=False, prefill_chunk=chunk,
        route_bias=route_bias or None))

    # per-call launch counts and engine counters through shims
    # ("prefill" is one whole prompt, or one chunk on the chunked runs)
    per = {"prefill": [], "decode": []}
    pf_name = "prefill_chunk" if chunk else "prefill"
    orig_prefill, orig_step = getattr(eng, pf_name), eng.decode_step
    st = eng.stats

    def snap():
        return dict(counters(mods), dispatches=st.dispatches,
                    host_syncs=st.host_syncs, replays=st.replays)

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    def prefill(arg):
        s0 = snap()
        out = orig_prefill(arg)
        per["prefill"].append(delta(s0, snap()))
        return out

    def decode_step(tok, state):
        s0 = snap()
        out = orig_step(tok, state)
        per["decode"].append(delta(s0, snap()))
        return out

    setattr(eng, pf_name, prefill)
    eng.decode_step = decode_step
    eng.stats.reset()
    for n in KERNELS:                          # this path's counts
        mods[n].launches = 0
    moe_mod = mods["moe_mod"]
    # the bias each routing call of decode saw: fused_moe_entry's operand
    # (superkernel) or route's logit_bias (unfused; prefill passes none)
    rec = (BiasRecorder(moe_mod, "fused_moe_entry", 2) if superkernel
           else BiasRecorder(moe_mod, "route", 4))
    t0 = time.perf_counter()
    with rec:
        report = srv.serve(reqs)
        eng.synchronize()
    wall = time.perf_counter() - t0
    launches = counters(mods)
    setattr(eng, pf_name, orig_prefill)
    eng.decode_step = orig_step

    summ = report.summary()
    n_layers = len(eng.specs)
    on_path = on_path_kernels(cfg, superkernel)
    for r in reqs:
        check(len(r.output) == 16 and all(0 <= t < cfg.vocab_size
                                          for t in r.output),
              f"[{tag}] request {r.request_id} output {r.output}")

    def per_call(kind, name):
        return [c[name] for c in per[kind]]

    check(min(per_call("prefill", "slot_ffn")) >= n_moe,
          f"[{tag}] slot_ffn launches per {pf_name} "
          f"{per_call('prefill', 'slot_ffn')} fall below {n_moe}")
    if superkernel:
        for name, least in ((on_path[1], n_moe), (on_path[2], n_layers)):
            check(min(per_call("decode", name)) >= least,
                  f"[{tag}] {name} launches per decode step "
                  f"{per_call('decode', name)} fall below {least}")
        check(max(per_call("decode", "slot_ffn")) == 0,
              f"[{tag}] decode steps launched slot_ffn")
    else:
        check(min(per_call("decode", "slot_ffn")) >= n_moe,
              f"[{tag}] slot_ffn launches per decode step "
              f"{per_call('decode', 'slot_ffn')} fall below {n_moe}")
    check(all(launches[n] > 0 for n in on_path),
          f"[{tag}] a kernel of the path was never launched: {launches}")
    check(all(launches[n] == 0 for n in KERNELS if n not in on_path),
          f"[{tag}] a kernel off the path was launched: {launches}")
    check(st.swap_experts > 0 and st.evictions > 0,
          f"[{tag}] no churn: swapped {st.swap_experts}, evicted "
          f"{st.evictions}")
    if not prefetch:
        check(st.prefetched == 0 and st.spec_layers == 0,
              f"[{tag}] prefetched {st.prefetched} experts and ran "
              f"{st.spec_layers} layers speculatively with prefetch off")
    biased_calls = rec.nonzero_calls(torch)
    check((biased_calls > 0) == bool(route_bias),
          f"[{tag}] {biased_calls} of {len(rec.biases)} routing calls saw a "
          f"nonzero logit bias at route_bias {route_bias}")
    rec.biases.clear()
    gbps = st.swap_bytes / st.copy_s / 1e9 if st.copy_s > 0 else float("nan")
    mean = lambda xs: float(np.mean(xs))  # noqa: E731
    serving = {
        "arch": arch, "path": path, "prefill_chunk": chunk,
        "layers": n_layers, "moe_layers": n_moe,
        "published_layers": full_depth, "depth_cut_why": why_cut or None,
        "attention": cfg.attention,
        "requests": len(reqs), "batch": 4,
        "prompt_tokens": [int(len(p)) for p in prompts],
        "new_tokens": 16, "wall_s": wall,
        "ttft_p50_s": summ["ttft_p50_s"], "tpot_p50_s": summ["tpot_p50_s"],
        "throughput_tok_s": summ["throughput_tok_s"],
        "launches": launches,
        f"launches_per_{pf_name}": {n: per_call("prefill", n)
                                    for n in KERNELS},
        "launches_per_decode_step_mean": {
            n: mean(per_call("decode", n)) for n in KERNELS},
        "decode_steps": len(per["decode"]),
        "dispatches_per_decode_step": mean(per_call("decode", "dispatches")),
        "host_syncs_per_decode_step": mean(per_call("decode", "host_syncs")),
        "replays_per_decode_step": mean(per_call("decode", "replays")),
        "replays": st.replays, "spec_layers": st.spec_layers,
        "swap_experts": st.swap_experts, "evictions": st.evictions,
        "demand_misses": st.demand_misses, "prefetched": st.prefetched,
        "prefetch_hits": st.prefetch_hits,
        "swapped_bytes": st.swap_bytes, "copy_s": st.copy_s,
        "h2d_GBps": gbps,
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9,
        "controller_s_history": list(eng.controller.s_history),
        "outputs": [list(r.output) for r in reqs],
        "route_bias": route_bias,
        "routing_calls_with_nonzero_bias": biased_calls,
    }
    log(f"serving [{tag}]: {len(reqs)} requests done in {wall:.2f} s; TTFT "
        f"p50 {serving['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{serving['tpot_p50_s'] * 1e3:.1f} ms, "
        f"{serving['throughput_tok_s']:.2f} tok/s")
    log(f"serving [{tag}]: launches {launches}; per decode step (mean over "
        f"{len(per['decode'])} steps) "
        f"{serving['launches_per_decode_step_mean']}, dispatches "
        f"{serving['dispatches_per_decode_step']:.2f}, host syncs "
        f"{serving['host_syncs_per_decode_step']:.2f}, replays "
        f"{serving['replays_per_decode_step']:.2f}")
    log(f"serving [{tag}]: swapped {st.swap_experts} experts = "
        f"{st.swap_bytes / 1e9:.2f} GB in {st.copy_s:.3f} s of copies "
        f"({gbps:.2f} GB/s host->device), {st.evictions} evictions")
    log(f"serving [{tag}]: " + json.dumps(serving))
    if route_bias:
        log_beside(tag, serving, base)
        check(st.demand_misses <= base["demand_misses"],
              f"[{tag}] demanded {st.demand_misses} experts, more than the "
              f"bias-off run's {base['demand_misses']}")
        serving["oracle_biased_nonzero_layer_steps"] = biased_oracle(
            torch, eng, prompts[0][None, :], superkernel,
            mods["DecodeState"], tag)
        # the oracle below needs strength 0: the ceiling keeps the biased
        # calls on, the controller (never given a ceiling) holds it at 0
        eng.route_bias_adaptive = True
        check(eng._route_bias_strength() == 0.0,
              f"[{tag}] strength {eng._route_bias_strength()} with the "
              f"controller held at 0")

    # ---- oracle checks -----------------------------------------------------
    if superkernel:
        DecodeState = mods["DecodeState"]
        step_ref = lambda tok, s: sk_reference_decode_step(  # noqa: E731
            eng, tok, s, DecodeState)
        what = "the segment functions over every expert"
    else:
        step_ref = eng.reference_decode_step
        what = "the fully-resident reference"
    prompt = prompts[0][None, :]
    if chunk:
        prefill_ref = lambda p: eng.reference_prefill_chunked(  # noqa: E731
            p, chunk)
        lg, s_slot = eng.prefill_chunked(prompt, chunk)
    else:
        prefill_ref = eng.reference_prefill
        lg, s_slot = eng.prefill(prompt)
    lr, s_ref = prefill_ref(prompt)
    worst = float((lg - lr).abs().max())
    toks_slot, toks_ref, rows = [], [], [lg.cpu()]
    for _ in range(16):
        toks_slot.append(int(lg.argmax(-1)[0]))
        toks_ref.append(int(lr.argmax(-1)[0]))
        tok = lr.argmax(-1)
        lg, s_slot = eng.decode_step(tok, s_slot)
        lr, s_ref = step_ref(tok, s_ref)
        rows.append(lg.cpu())
        worst = max(worst, float((lg - lr).abs().max()))
    check(worst == 0.0 and toks_slot == toks_ref,
          f"[{tag}] slot path differs from {what}: max |dlogit| {worst}, "
          f"tokens {toks_slot} vs {toks_ref}")
    log(f"oracle [{tag}]: single-stream slot path bitwise equal to {what} "
        f"over prefill + 16 decode steps (tokens {toks_slot[:8]}...)"
        + (" at strength 0 with the biased calls on" if route_bias else ""))
    if route_bias:
        same = all(torch.equal(a, b) for a, b in zip(rows,
                                                     base["_oracle_rows"]))
        check(same, f"[{tag}] the zero-strength engine's logits differ from "
                    f"the bias-off engine's on the same prompt")
        log(f"oracle [{tag}]: logits of request {reqs[0].request_id}'s "
            f"prompt over prefill + 16 decode steps bitwise equal to the "
            f"bias-off engine's")
        parted = [r.request_id for r, o in zip(reqs, base["outputs"])
                  if list(r.output) != o]
        serving["streams_parting_from_bias_off_run"] = parted
        serving["zero_strength_bitwise"] = True
        log(f"oracle [{tag}]: {len(parted)} of {len(reqs)} served streams "
            f"differ from the bias-off run's {parted} (the bias moves "
            f"routing, so streams part by design)")
        eng.drop_resident_experts()
        serving["phase_s"] = time.perf_counter() - t_phase
        return serving, launches
    serving["_oracle_rows"] = rows
    if chunk:
        # chunked against whole-prompt ingestion, both fully resident: the
        # chunk's GEMMs and attention have other shapes than the prompt's
        lm, _ = eng.reference_prefill(prompt)
        lc, _ = eng.reference_prefill_chunked(prompt, chunk)
        d = float((lm - lc).abs().max())
        same = int(lm.argmax(-1)[0]) == int(lc.argmax(-1)[0])
        top2 = lm[0].float().topk(2).values
        check(same or float(top2[0] - top2[1]) <= NEAR_TIE,
              f"[{tag}] chunked and whole-prompt prefill pick different "
              f"tokens past a near-tie (max |dlogit| {d})")
        parted = None if mono_outputs is None else [
            r.request_id for r, o in zip(reqs, mono_outputs)
            if list(r.output) != o]
        serving["chunked_vs_monolithic_prefill_max_abs"] = d
        serving["chunked_vs_monolithic_same_greedy"] = same
        serving["streams_parting_from_monolithic_run"] = parted
        log(f"oracle [{tag}]: prefill of request {reqs[0].request_id} "
            f"chunked vs whole, both fully resident: max |dlogit| {d:.4g}, "
            f"same greedy token {same}"
            + ("" if parted is None else
               f"; {len(parted)} of {len(reqs)} served streams differ from "
               f"the monolithic run's {parted}"))
    # served streams against single-request decoding, teacher-forced on
    # the served tokens:
    # - at the serving batch's width (the request alone in row 0 of a
    #   4-row state, the other rows idle) through the same path's oracle:
    #   the same shapes give the same bits, so every stream must match
    #   (a near-tie of the top two logits, 5e-2, is the only excuse);
    # - at batch 1 through the fully-resident reference, as phases 4-5
    #   always did. Batch-1 products round differently from batch-4 ones,
    #   and a last-bit difference can flip a router's k-th choice, after
    #   which the logits move by more than a near-tie (DeepSeek's 26
    #   routers and qwen1.5's 24 do so on the card). So a stream may part
    #   past a near-tie only after such a flip: `router_flip` finds the
    #   first one between batch 1 and the path's oracle at the batch's
    #   width, and the experts it swapped must lie within a near-tie of
    #   each other in the router's logits at both widths.
    hold_streams(torch, np, mods, eng, reqs, prompts, prefill_ref, step_ref,
                 what, tag, serving)
    eng.drop_resident_experts()
    serving["phase_s"] = time.perf_counter() - t_phase
    serving["oracle_bitwise"] = True
    return serving, launches


def hold_streams(torch, np, mods, eng, reqs, prompts, prefill_ref, step_ref,
                 what, tag, serving):
    """The served streams of `reqs` held by the rules of phases 5-7 (see
    `serving_phase`): alone at the batch's width through the path's oracle
    `step_ref` a stream may part only at a near-tie; alone at batch 1
    through the fully-resident reference only at a near-tie or after a
    router flip at a near-tie. Writes what it finds into `serving`."""
    by_id = {r.request_id: (r, p) for r, p in zip(reqs, prompts)}
    for width, step_fn, what_s in (
            (4, step_ref, what),
            (1, eng.reference_decode_step, "the fully-resident reference")):
        parts = stream_partings(torch, np, eng, reqs, prompts, prefill_ref,
                                step_fn, width, mods["DecodeState"])
        flips = {}
        for rid, step, t, want, gap in parts:
            if gap <= NEAR_TIE:
                continue
            check(width == 1,
                  f"[{tag}] request {rid} step {step}: served {t}, alone at "
                  f"batch {width} through {what_s} {want}, top-2 gap {gap}")
            r, p = by_id[rid]
            flip = router_flip(torch, eng, mods["moe_mod"], prefill_ref,
                               step_ref, p, r.output[:step],
                               mods["DecodeState"])
            check(flip is not None and flip["tie"] <= NEAR_TIE,
                  f"[{tag}] request {rid} step {step}: served {t}, alone at "
                  f"batch 1 {want}, top-2 gap {gap}, and no router flipped "
                  f"at a near-tie before it: {flip}")
            flips[rid] = flip
        serving[f"served_streams_part_at_batch_{width}"] = [
            [float(v) for v in x] for x in parts]
        log(f"oracle [{tag}]: served streams against each request decoded "
            f"alone at batch {width} through {what_s}: {len(parts)} "
            f"stream(s) part (request, step, top-2 gap: "
            f"{[(x[0], x[1], round(float(x[4]), 4)) for x in parts]})")
        if flips:
            serving["batch_1_router_flips"] = flips
            log(f"oracle [{tag}]: each batch-1 parting past a near-tie "
                f"follows a router flip at a near-tie (request: decode "
                f"step, MoE layer, swapped experts, the swap's larger "
                f"router-logit gap at the two widths, max |router-logit "
                f"difference| there): "
                + "; ".join(f"{rid}: {f['step']}, {f['layer']}, "
                            f"{f['swapped']}, {f['tie']:.4g}, "
                            f"{f['drift']:.4g}" for rid, f in flips.items()))


# --------------------------------------------------------------- phase 11

def on_path_kernels(cfg, superkernel):
    """The serving kernels a path launches (prefill launches `slot_ffn` on
    both paths)."""
    if not superkernel:
        return ("slot_ffn",)
    attn = ("fused_mla_decode_attention" if cfg.attention == "mla"
            else "fused_decode_attention")
    return ("slot_ffn", "fused_moe_entry", attn)


def fault_serve(torch, np, mods, eng, tag, *, superkernel, base=None,
                seed=SEED, **serving_kw):
    """Serve the eight-request population on `eng` (monolithic admission),
    every kernel's count zeroed just before and read just after; hold every
    request to its full budget and the path's kernels to launching (and
    the others to not). Returns (run summary, launches)."""
    cfg = eng.cfg
    prompts, reqs = the_requests(np, mods, cfg, seed)
    srv = mods["ServingEngine"](eng, mods["EngineServingConfig"](
        max_batch=4, admission_cap=False, prefill_chunk=0, **serving_kw))
    eng.stats.reset()
    for n in KERNELS:
        mods[n].launches = 0
    t0 = time.perf_counter()
    report = srv.serve(reqs)
    eng.synchronize()
    wall = time.perf_counter() - t0
    launches = counters(mods)
    on_path = on_path_kernels(cfg, superkernel)
    check(all(launches[n] > 0 for n in on_path)
          and all(launches[n] == 0 for n in KERNELS if n not in on_path),
          f"[{tag}] launches off the path's kernels: {launches}")
    for r in reqs:
        check(len(r.output) == 16 and all(0 <= t < cfg.vocab_size
                                          for t in r.output),
              f"[{tag}] request {r.request_id} output {r.output}")
    st, summ = eng.stats, report.summary()
    run = {"arch": cfg.name, "path": "superkernel" if superkernel
           else "unfused", "prefill_chunk": 0, "layers": cfg.num_layers,
           "attention": cfg.attention, "wall_s": wall,
           "ttft_p50_s": summ["ttft_p50_s"], "tpot_p50_s": summ["tpot_p50_s"],
           "throughput_tok_s": summ["throughput_tok_s"],
           "swapped_bytes": st.swap_bytes, "copy_s": st.copy_s,
           "demand_misses": st.demand_misses, "replays": st.replays,
           "launches": launches,
           "health": {k: summ[k] for k in ("n_link_failures", "n_retries",
                                           "n_degraded_steps", "n_shed")},
           "brownout_deferred": srv.batcher.stats.brownout_deferred,
           "degraded_at_end": eng._degraded,
           "watchdog_trips": (eng.watchdog.n_trips if eng.watchdog is not None
                              else None),
           "outputs": [list(r.output) for r in reqs],
           "request_ids": [r.request_id for r in reqs]}
    line = lambda r: (  # noqa: E731
        f"TTFT p50 {r['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{r['tpot_p50_s'] * 1e3:.1f} ms, swapped "
        f"{r['swapped_bytes'] / 1e9:.2f} GB, demand misses "
        f"{r['demand_misses']}")
    log(f"faults [{tag}]: {len(reqs)} requests in {wall:.2f} s; health "
        f"{run['health']}, brownout_deferred {run['brownout_deferred']}, "
        f"degraded at the end {run['degraded_at_end']}, watchdog trips "
        f"{run['watchdog_trips']}; {line(run)}; launches {launches}")
    if base is not None:
        log(f"faults [{tag}]: fault-free run of the path (same call): "
            f"{line(base)}")
    return run, srv, launches


def slot_path_rows(eng, prompt, steps=16):
    """One prompt prefilled and decoded greedily, single-stream, through
    the engine's slot path: its logits over prefill + `steps` steps."""
    lg, st = eng.prefill(prompt)
    rows = [lg.cpu()]
    for _ in range(steps):
        lg, st = eng.decode_step(lg.argmax(-1), st)
        rows.append(lg.cpu())
    return rows


def no_expert_oracle_rows(torch, eng, prompt, superkernel, DecodeState,
                          steps=16):
    """The path's fully-resident oracle with no expert resident (every
    slot-table entry -1, as a total outage leaves it): prefill + `steps`
    greedy decode steps, single-stream."""
    full, ident = eng._full_experts, eng._ident_map
    eng._full_experts = lambda li: eng.buffer
    eng._ident_map = torch.full_like(ident, -1)
    try:
        step = ((lambda t, s: sk_reference_decode_step(eng, t, s,
                                                       DecodeState))
                if superkernel else eng.reference_decode_step)
        lg, st = eng.reference_prefill(prompt)
        rows = [lg.cpu()]
        for _ in range(steps):
            lg, st = step(lg.argmax(-1), st)
            rows.append(lg.cpu())
        return rows
    finally:
        eng._full_experts, eng._ident_map = full, ident


def faults_phase(torch, np, mods, serving, launches):
    """Phase 11: the fault plans on the card (see the module docstring)."""
    FaultPlan, DecodeState = mods["FaultPlan"], mods["DecodeState"]
    olmoe = model_at_depth(mods, "olmoe-1b-7b")
    runs = {}
    sk_base = serving["olmoe-1b-7b superkernel monolithic"]
    prompts, _ = the_requests(np, mods, olmoe)
    prompt = prompts[0][None, :]

    # a disabled plan: exactly the fault-free engine
    tag = "olmoe-1b-7b superkernel disabled plan"
    eng, *_ = build_engine(torch, mods, olmoe, superkernel=True,
                           faults=FaultPlan())
    check(eng.faults is None and eng.watchdog is None,
          f"[{tag}] a disabled plan built an injector or a watchdog")
    rows = slot_path_rows(eng, prompt)
    same = all(torch.equal(a, b) for a, b in zip(rows,
                                                  sk_base["_oracle_rows"]))
    check(same and len(rows) == len(sk_base["_oracle_rows"]),
          f"[{tag}] logits differ from the fault-free engine's")
    log(f"faults [{tag}]: one prompt's logits over prefill + 16 decode steps "
        f"bitwise equal to the fault-free engine's")
    runs[tag] = {"bitwise_to_fault_free": True}
    del eng
    release(torch)

    # brownout: flaky transfers on a collapsed link (olmoe's here; the
    # olmoe runs go first, so that they share one config's pinned host
    # memory: `build_engine`)
    brownout(torch, np, mods, serving, launches, runs, "olmoe-1b-7b", True)

    # a total outage from t = 0: no expert ever resident, every MoE work
    # list empty; served degraded, and bitwise the no-expert oracle
    tag = "olmoe-1b-7b superkernel monolithic total outage"
    # no backoff: every demand fails all its retries, and sleeping 7 ms
    # for each of some 10^4 of them would only add idle time
    eng, *_ = build_engine(torch, mods, olmoe, superkernel=True,
                           faults=FaultPlan.total_outage(),
                           retry_backoff_s=0.0)
    run, _, launches[tag] = fault_serve(torch, np, mods, eng, tag,
                                        superkernel=True, base=sk_base)
    h = run["health"]
    check(h["n_degraded_steps"] > 0 and eng._degraded
          and eng._route_bias_strength() == eng.degraded_route_bias
          and eng.stats.swap_experts == 0,
          f"[{tag}] health {h}, degraded {eng._degraded}, strength "
          f"{eng._route_bias_strength()}, swapped {eng.stats.swap_experts}")
    got = slot_path_rows(eng, prompt)
    want = no_expert_oracle_rows(torch, eng, prompt, True, DecodeState)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"[{tag}] the slot path with no expert resident differs from the "
          f"no-expert oracle")
    log(f"faults [{tag}]: strength {eng._route_bias_strength()} (the "
        f"degraded floor); one prompt's logits over prefill + 16 decode "
        f"steps bitwise equal to the oracle with no expert resident")
    run["no_expert_oracle_bitwise"] = True
    runs[tag] = run
    del eng
    release(torch)

    # recovery: the link is dead in [0, 2) of the link clock; one clean
    # demand ends degraded routing; with every expert fitting (64 slots a
    # layer) a fresh population served after is bitwise a never-faulted
    # engine's, logits trace for logits trace
    tag = "olmoe-1b-7b superkernel monolithic recovery"
    eng, *_ = build_engine(torch, mods, olmoe, superkernel=True, slots=64,
                           faults=FaultPlan(outage=((0.0, 2.0),)),
                           degraded_recover_streak=1)
    run, _, launches[tag] = fault_serve(torch, np, mods, eng, tag,
                                        superkernel=True, base=sk_base)
    check(run["health"]["n_link_failures"] > 0 and not eng._degraded
          and eng._clock > 2.0, f"[{tag}] did not fault and recover: "
          f"{run['health']}, degraded {eng._degraded}, clock {eng._clock}")
    # brownout admission off for the comparison: the recovered engine's
    # watchdog reads the wall clock, and a pause would batch the rows
    # otherwise than the never-faulted server does
    run_b, srv_b, launches[tag + " after"] = fault_serve(
        torch, np, mods, eng, tag + " after", superkernel=True,
        seed=SEED + 1, trace_logits=True, brownout_admission=False)
    trace_b = [srv_b.logits_trace[r] for r in run_b["request_ids"]]
    del eng, srv_b
    release(torch)
    eng, *_ = build_engine(torch, mods, olmoe, superkernel=True, slots=64)
    run_c, srv_c, launches[tag + " never faulted"] = fault_serve(
        torch, np, mods, eng, tag + " never faulted", superkernel=True,
        seed=SEED + 1, trace_logits=True)
    # request by request, in the order both populations were made
    trace_c = [srv_c.logits_trace[r] for r in run_c["request_ids"]]
    n_rows = sum(len(v) for v in trace_c)
    check(len(trace_b) == len(trace_c) and all(
        len(b) == len(c) and all(np.array_equal(x, y) for x, y in zip(b, c))
        for b, c in zip(trace_b, trace_c)),
        f"[{tag}] the recovered engine's logits trace differs from the "
        f"never-faulted engine's")
    log(f"faults [{tag}]: after recovery (watchdog tripped "
        f"{run_b['watchdog_trips']} times), {len(trace_c)} requests' "
        f"{n_rows} logits rows bitwise equal to a never-faulted engine's")
    run["after_recovery_bitwise_rows"] = n_rows
    runs[tag] = run
    del eng, srv_c
    release(torch)
    brownout(torch, np, mods, serving, launches, runs, "deepseek-v2-lite",
             False)
    return runs


def brownout(torch, np, mods, serving, launches, runs, arch, sk):
    """`FaultPlan.brownout_preset(seed=0)` served on `arch` at its fault-free
    run's depth (`SERVE_DEPTH`): retries and link failures, nothing
    shed."""
    path = "superkernel" if sk else "unfused"
    tag = f"{arch} {path} monolithic brownout"
    eng, *_ = build_engine(torch, mods, model_at_depth(
                               mods, arch, SERVE_DEPTH.get(arch, (None,))[0]),
                           superkernel=sk,
                           faults=mods["FaultPlan"].brownout_preset(seed=0))
    run, _, launches[tag] = fault_serve(
        torch, np, mods, eng, tag, superkernel=sk,
        base=serving[f"{arch} {path} monolithic"])
    h = run["health"]
    check(h["n_retries"] > 0 and h["n_link_failures"] > 0
          and h["n_shed"] == 0, f"[{tag}] health {h}")
    runs[tag] = run
    del eng
    release(torch)


# --------------------------------------------------------------- phase 12

class SeededModel(Mapping):
    """`Model.init`'s draws from SEED on the card, layer by layer and in its
    order (so the weights are phase 5-10's), without ever holding every
    expert: indexing it by MoE layer (in order, as the shard writer does)
    draws the layers up to that one and hands back its experts on the host;
    everything else stays on the card. `params()` draws what is left and
    returns the param tree without experts. Peak: one layer's experts."""

    def __init__(self, torch, mods, cfg):
        tr = mods["transformer"]
        self.torch, self.tr, self.cfg = torch, tr, cfg
        model = mods["Model"](cfg)
        self.specs, self.dtype = list(model.specs), model.dtype
        self.moe_ids = [i for i, s in enumerate(self.specs) if s.is_moe]
        self.kw = dict(generator=torch.Generator(device="cuda").manual_seed(
            SEED), device=torch.device("cuda"))
        dt, d = self.dtype, cfg.d_model
        self.tree = {
            "embed": tr.embed_init(cfg.vocab_size, d, dt, **self.kw),
            "final_norm": torch.ones((d,), dtype=dt, device="cuda"),
            "lm_head": tr.dense_init(d, cfg.vocab_size, dt, **self.kw),
            "layers": []}

    def _draw(self):
        i = len(self.tree["layers"])
        p = self.tr.init_layer(self.cfg, self.specs[i], self.dtype, **self.kw)
        experts = None
        if self.specs[i].is_moe:
            moe = p["moe"]
            # to the host through page-locked buffers (a fast copy; the
            # caching host allocator reuses them layer after layer)
            experts = tuple(
                self.torch.empty(w.shape, dtype=w.dtype,
                                 pin_memory=True).copy_(w)
                for w in (moe.pop(k) for k in ("w_gate", "w_up", "w_down")))
        self.tree["layers"].append(p)
        return experts

    def __len__(self):
        return len(self.moe_ids)

    def __iter__(self):
        return iter(range(len(self.moe_ids)))

    def __getitem__(self, li):
        target = self.moe_ids[li]
        assert len(self.tree["layers"]) <= target, "layers in order only"
        while True:
            experts = self._draw()
            if len(self.tree["layers"]) == target + 1:
                return experts

    def params(self):
        while len(self.tree["layers"]) < len(self.specs):
            self._draw()
        return self.tree


def export_seeded(torch, mods, cfg, out_dir):
    """Shards of `cfg`'s experts drawn from SEED, written, fsync'd and
    dropped from the page cache; returns (non-expert params on the card,
    export seconds, bytes written)."""
    t0 = time.perf_counter()
    seeded = SeededModel(torch, mods, cfg)
    mods["export_expert_shards"](seeded, out_dir, drop_cache=True)
    params = seeded.params()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gc.collect()                 # free the page-locked staging buffers
    torch._C._host_emptyCache()
    nbytes = sum(f.stat().st_size for f in Path(out_dir).glob("*.bin"))
    log(f"tier [{cfg.name}]: exported {len(seeded)} MoE layers' experts, "
        f"{nbytes / 1e9:.2f} GB, to {out_dir} in {secs:.1f} s "
        f"({nbytes / secs / 1e9:.3f} GB/s drawn on the card, written, "
        f"fsync'd, dropped from the page cache)")
    return params, secs, nbytes


def slot_crcs(torch, eng, slots):
    """CRC-32 of each device slot's (w_gate | w_up | w_down) bytes, copied
    back: the bytes a shard record holds."""
    import zlib

    def crc(s):
        c = 0
        for name in ("w_gate", "w_up", "w_down"):
            w = eng.buffer[name][s].cpu().contiguous()
            c = zlib.crc32(w.view(torch.uint8).numpy(), c)
        return c
    eng.synchronize()
    return threaded(crc, list(slots))


def check_slots(torch, eng, tag, slots=None):
    """Every occupied device slot (or the given ones) holds its shard
    record's bytes. Returns how many were checked."""
    occupied = [s for s, k in enumerate(eng.table.key_of_slot)
                if k is not None]
    slots = occupied if slots is None else slots
    got = slot_crcs(torch, eng, slots)
    rd = eng.tiers.reader
    bad = [(s, eng.table.key_of_slot[s]) for s, c in zip(slots, got)
           if c != rd.record_crc(*eng.table.key_of_slot[s])]
    check(not bad, f"[{tag}] device slots whose bytes differ from their "
                   f"shard record: {bad[:8]} ({len(bad)} of {len(slots)})")
    return len(slots)


def tier_engine(torch, mods, cfg, params, sdir, *, superkernel, budget,
                verify="off", **kw):
    """A `SlotBufferEngine` on a `TieredExpertStore` over `sdir` (16 slots a
    layer, `slot_ffn` on). Returns (engine, store, build seconds)."""
    gc.collect()
    t0 = time.perf_counter()
    store = mods["TieredExpertStore"](sdir, host_budget_bytes=budget,
                                      verify=verify, prefetch=TIER_PREFETCH)
    eng = mods["SlotBufferEngine"](
        cfg, params, mods["Model"](cfg), n_slots_per_layer=16,
        use_kernel=True, use_superkernel=superkernel, max_seq=256,
        device="cuda", store=store, **kw)
    return eng, store, time.perf_counter() - t0


def tier_serve(torch, np, mods, eng, tag, *, superkernel, prompts,
               new_tokens=16, batch=4, base=None):
    """Serve `prompts` greedily on a tiered engine (monolithic admission,
    logits traced), every kernel's count zeroed just before and read just
    after; hold every request to its budget, every logit finite, the
    path's kernels to launching (and the others to not). Prints the tier's
    counters beside `base`, the pre-staged run of the same config and path
    in this call. Returns (run summary, requests, server, launches)."""
    cfg, store = eng.cfg, eng.tiers
    reqs = [mods["Request"](p, max_new_tokens=new_tokens) for p in prompts]
    srv = mods["ServingEngine"](eng, mods["EngineServingConfig"](
        max_batch=batch, admission_cap=False, prefill_chunk=0,
        trace_logits=True))
    eng.stats.reset()
    for n in KERNELS:
        mods[n].launches = 0
    io0, snap0 = store.io_stats(), store.snapshot()
    t0 = time.perf_counter()
    report = srv.serve(reqs)
    eng.synchronize()
    wall = time.perf_counter() - t0
    launches = counters(mods)
    on_path = on_path_kernels(cfg, superkernel)
    check(all(launches[n] > 0 for n in on_path)
          and all(launches[n] == 0 for n in KERNELS if n not in on_path),
          f"[{tag}] launches off the path's kernels: {launches}")
    for r in reqs:
        check(len(r.output) == new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.output),
              f"[{tag}] request {r.request_id} output {r.output}")
        rows = srv.logits_trace[r.request_id]
        check(len(rows) == new_tokens
              and all(np.isfinite(x).all() for x in rows),
              f"[{tag}] request {r.request_id}: non-finite logits")
    st, summ = eng.stats, report.summary()
    io = {k: v - io0[k] for k, v in store.io_stats().items()}
    snap = store.snapshot()
    g = store.guard
    run = {"arch": cfg.name, "path": "superkernel" if superkernel
           else "unfused", "layers": cfg.num_layers,
           "requests": len(reqs), "batch": batch,
           "prompt_tokens": [int(len(p)) for p in prompts],
           "new_tokens": new_tokens, "wall_s": wall,
           "ttft_p50_s": summ["ttft_p50_s"], "tpot_p50_s": summ["tpot_p50_s"],
           "throughput_tok_s": summ["throughput_tok_s"],
           "swapped_bytes": st.swap_bytes, "copy_s": st.copy_s,
           "demand_misses": st.demand_misses, "replays": st.replays,
           "host_hits": st.host_hits, "host_misses": st.host_misses,
           "disk_stall_s": st.disk_stall_s,
           "tier_snapshot": snap,
           "tier_snapshot_delta": {k: snap[k] - snap0[k] for k in snap},
           "report_tier": {k: summ[k] for k in (
               "n_host_hits", "n_host_misses", "disk_stall_s",
               "n_corrupt_detected", "n_requarantined", "n_scrubbed",
               "n_quarantined_experts")},
           "n_episodes": g.n_episodes, "healing": len(g.healing),
           "quarantined": sorted(g.quarantined),
           "io": io, "pool_GB": store.nbytes / 1e9,
           "pool_records": store.capacity,
           "host_budget_GB": store.model.host_budget_bytes / 1e9,
           "launches": launches,
           "outputs": [list(r.output) for r in reqs]}
    rd = io["read_s"]
    log(f"tier [{tag}]: {len(reqs)} requests in {wall:.2f} s; TTFT p50 "
        f"{run['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{run['tpot_p50_s'] * 1e3:.1f} ms, swapped "
        f"{st.swap_bytes / 1e9:.2f} GB, demand misses {st.demand_misses}; "
        f"host hits {st.host_hits}, misses {st.host_misses}, disk stall "
        f"{st.disk_stall_s:.4g} (link clock); read "
        f"{io['bytes_read'] / 1e9:.2f} GB from the shards "
        f"({io['bytes_read'] / rd / 1e9 if rd else float('nan'):.2f} GB/s a "
        f"thread, {io['bytes_read'] / wall / 1e9:.2f} GB/s over the run, "
        f"{io['read_wait_s']:.2f} s waited), CRC "
        f"{io['crc_s']:.2f} s; launches {launches}")
    log(f"tier [{tag}]: snapshot {json.dumps(snap)}; integrity "
        f"{json.dumps(run['report_tier'])}, episodes {g.n_episodes}")
    if base is not None:
        log(f"tier [{tag}]: pre-staged run of the path (same call): TTFT "
            f"p50 {base['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
            f"{base['tpot_p50_s'] * 1e3:.1f} ms, swapped "
            f"{base['swapped_bytes'] / 1e9:.2f} GB, demand misses "
            f"{base['demand_misses']}, {base.get('layers')} layers")
    return run, reqs, srv, launches


def path_oracle(mods, eng, superkernel):
    """(decode-step oracle, what it is) of the engine's path."""
    if superkernel:
        DecodeState = mods["DecodeState"]
        return ((lambda tok, s: sk_reference_decode_step(eng, tok, s,
                                                         DecodeState)),
                "the segment functions over every expert")
    return eng.reference_decode_step, "the fully-resident reference"


def tier_oracles(torch, np, mods, eng, tag, run, reqs, srv, prompts, base,
                 superkernel):
    """A tiered run of a phase 5-7 config held to that phase's rules: one
    prompt single-stream through the slot path bitwise equal to the path's
    oracle (its experts read from the shards); every served stream equal to
    the pre-staged run's token for token, or parting only where this run's
    top two logits lie within NEAR_TIE (the serving loop reads the wall
    clock), and every parted stream held by the rules of phases 5-7."""
    step_ref, what = path_oracle(mods, eng, superkernel)
    prompt = prompts[0][None, :]
    lg, s_slot = eng.prefill(prompt)
    lr, s_ref = eng.reference_prefill(prompt)
    worst = float((lg - lr).abs().max())
    for _ in range(TIER_ORACLE_STEPS):
        tok = lr.argmax(-1)
        lg, s_slot = eng.decode_step(tok, s_slot)
        lr, s_ref = step_ref(tok, s_ref)
        worst = max(worst, float((lg - lr).abs().max()))
    check(worst == 0.0, f"[{tag}] slot path through the tier differs from "
                        f"{what}: max |dlogit| {worst}")
    log(f"oracle [{tag}]: single-stream slot path through the tier bitwise "
        f"equal to {what} (experts read from the shards) over prefill + "
        f"{TIER_ORACLE_STEPS} decode steps")
    if base["layers"] != eng.cfg.num_layers:
        # a cut run against a full-depth one: held by phases 5-7's rules
        run["partings_from_prestaged"] = None
        hold_streams(torch, np, mods, eng, reqs, prompts,
                     eng.reference_prefill, step_ref, what, tag, run)
        eng.drop_resident_experts()
        return
    partings = []
    for r, want in zip(reqs, base["outputs"]):
        got = list(r.output)
        if got == want:
            continue
        step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        row = np.sort(srv.logits_trace[r.request_id][step].reshape(-1))
        gap = float(row[-1] - row[-2])
        check(gap <= NEAR_TIE, f"[{tag}] request {r.request_id} parts from "
                               f"the pre-staged run at step {step} with a "
                               f"top-2 gap of {gap}")
        partings.append((r.request_id, step, gap))
    run["partings_from_prestaged"] = partings
    log(f"oracle [{tag}]: served streams against the pre-staged run's: "
        f"{len(partings)} of {len(reqs)} part (request, step, top-2 gap: "
        f"{partings})")
    if partings:
        ids = {rid for rid, _, _ in partings}
        sel = [(r, p) for r, p in zip(reqs, prompts) if r.request_id in ids]
        hold_streams(torch, np, mods, eng, [r for r, _ in sel],
                     [p for _, p in sel], eng.reference_prefill, step_ref,
                     what, tag, run)
    eng.drop_resident_experts()


def _terminate(signum, frame):
    raise SystemExit(128 + signum)


def tier_phase(torch, np, mods, serving, launches):
    """Phase 12: the disk tier (see the module docstring)."""
    import shutil
    import signal
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_shards_"))
    runs = {"shard_dir": str(root), "mount": mount_of(root)}
    log(f"tier: shards under {root} ({runs['mount']}, "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB free)")
    written = 0                  # bytes written to the disk in this phase
    gc.collect()                 # the last pre-staged engine's pinned blocks
    torch._C._host_emptyCache()
    _PINNED_FOR[0] = None
    # a termination signal ends the run through the `finally` below, which
    # removes the shards
    old_handler = signal.signal(signal.SIGTERM, _terminate)
    try:
        # D.1 olmoe unfused and D.3 olmoe superkernel under corruption,
        # on one set of shards; D.2 DeepSeek superkernel, verified
        for arch, superkernel, verify in (
                ("olmoe-1b-7b", False, "off"),
                ("deepseek-v2-lite", True, "promote")):
            layers, why = TIER_DEPTH.get(arch, (None, ""))
            cfg = model_at_depth(mods, arch, layers)
            sdir = str(root / arch)
            if layers is not None:
                log(f"tier [{arch}]: depth cut to {layers} of "
                    f"{mods['get_config'](arch).num_layers} layers ({why}); "
                    f"widths as published")
            params, secs, nbytes = export_seeded(torch, mods, cfg, sdir)
            written += nbytes
            if verify != "off":
                runs["io_probe"] = io_probe(torch, mods, sdir)
            path = "superkernel" if superkernel else "unfused"
            tag = f"{arch} {path} monolithic tiered"
            base = serving[f"{arch} {path} monolithic"]
            eng, store, t_build = tier_engine(
                torch, mods, cfg, params, sdir, superkernel=superkernel,
                budget=store_bytes(sdir) * TIER_BUDGET_SHARE, verify=verify)
            budget = store.model.host_budget_bytes
            log(f"tier [{tag}]: host budget {budget / 1e9:.2f} GB of "
                f"{store.total_expert_bytes / 1e9:.2f} GB, pool "
                f"{store.capacity} records = {store.nbytes / 1e9:.2f} GB "
                f"pinned, verify {store.verify}; engine {t_build:.1f} s")
            prompts, _ = the_requests(np, mods, cfg)
            run, reqs, srv, launches[tag] = tier_serve(
                torch, np, mods, eng, tag, superkernel=superkernel,
                prompts=prompts, base=base)
            snap = run["tier_snapshot"]
            check(snap["evictions"] > 0 and run["host_misses"] > 0,
                  f"[{tag}] no host churn: {snap}")
            check(run["report_tier"]["n_corrupt_detected"] == 0,
                  f"[{tag}] corruption detected on a clean disk: {snap}")
            tier_oracles(torch, np, mods, eng, tag, run, reqs, srv, prompts,
                         base, superkernel)
            run.update(export_s=secs, export_bytes=nbytes, build_s=t_build)
            runs[tag] = run
            store.close()
            del eng, srv
            release(torch)
            if arch == "olmoe-1b-7b":
                integrity_runs(torch, np, mods, cfg, params, sdir, runs,
                               launches, serving)
            del params
            release(torch)
            shutil.rmtree(sdir)
        qwen_tier(torch, np, mods, root, written, runs, launches, serving)
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        shutil.rmtree(root, ignore_errors=True)
    return runs


def io_probe(torch, mods, sdir):
    """How a verified promotion batch's bytes move best: `n` records of a
    shard set just written and dropped from the page cache, read and
    CRC-32'd into page-locked memory on the tier's 8 I/O threads, in 2 MiB
    tasks whose CRCs are combined (the tier's way: `TieredExpertStore.
    _read`) and in one task a record (one read, one zlib.crc32), each on
    layers of its own in ABBA order; then one record alone the same two
    ways. Every CRC must equal its manifest's. Returns the seconds."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import expert_tiers as et
    rd = et.ExpertShardReader(sdir)
    rec, layers = rd.record_nbytes(0), rd.layers()
    n = min(IO_PROBE_RECORDS, rd.num_experts(0))
    buf = torch.empty((n, rec), dtype=torch.uint8, pin_memory=True).numpy()
    spans = [(lo, min(rec, lo + et.READ_CHUNK))
             for lo in range(0, rec, et.READ_CHUNK)]

    def chunk(layer, e, lo, hi):
        rd.read_into(layer, e, buf[e, lo:hi], lo)
        return zlib.crc32(buf[e, lo:hi])

    def record(layer, e):
        rd.read_into(layer, e, buf[e])
        return zlib.crc32(buf[e])

    def chunked(ex, layer, count):
        futs = [[ex.submit(chunk, layer, e, lo, hi) for lo, hi in spans]
                for e in range(count)]
        return [et.chunked_crc32((f.result(), hi - lo)
                                 for f, (lo, hi) in zip(fs, spans))
                for fs in futs]

    def per_record(ex, layer, count):
        return list(ex.map(lambda e: record(layer, e), range(count)))

    out = {"chunked": [], "per_record": [], "chunked_1": [],
           "per_record_1": []}
    with ThreadPoolExecutor(et.IO_THREADS) as ex:
        order = [("chunked", chunked, n), ("per_record", per_record, n),
                 ("per_record", per_record, n), ("chunked", chunked, n),
                 ("chunked_1", chunked, 1), ("per_record_1", per_record, 1),
                 ("per_record_1", per_record, 1), ("chunked_1", chunked, 1)]
        for i, (name, fn, count) in enumerate(order):
            layer = layers[i % len(layers)]
            t0 = time.perf_counter()
            got = fn(ex, layer, count)
            out[name].append(time.perf_counter() - t0)
            want = [rd.record_crc(layer, e) for e in range(count)]
            check(got == want, f"[io probe] {name} CRCs of layer {layer} "
                               f"differ from the manifest's")
    rd.close()
    res = {k: statistics.mean(v) for k, v in out.items()}
    res.update(records=n, record_bytes=rec)
    log(f"tier [io probe]: {n} records of {rec / 1e6:.1f} MB read + CRC-32 "
        f"on {et.IO_THREADS} threads after POSIX_FADV_DONTNEED: "
        f"{res['chunked'] * 1e3:.1f} ms in 2 MiB tasks "
        f"({n * rec / res['chunked'] / 1e9:.2f} GB/s), "
        f"{res['per_record'] * 1e3:.1f} ms one task a record "
        f"({n * rec / res['per_record'] / 1e9:.2f} GB/s); one record "
        f"{res['chunked_1'] * 1e3:.1f} ms against "
        f"{res['per_record_1'] * 1e3:.1f} ms")
    return res


def store_bytes(sdir):
    return sum(f.stat().st_size for f in Path(sdir).glob("*.bin"))


def integrity_runs(torch, np, mods, cfg, params, sdir, runs, launches,
                   serving):
    """D.3: olmoe superkernel on D.1's shards under corruption plans."""
    FaultPlan = mods["FaultPlan"]
    base = serving["olmoe-1b-7b superkernel monolithic"]
    for plan, verify in (("corrupt_flaky", "scrub"),
                         ("corrupt_disk", "promote")):
        tag = f"olmoe-1b-7b superkernel monolithic tiered {plan}"
        eng, store, t_build = tier_engine(
            torch, mods, cfg, params, sdir, superkernel=True,
            budget=store_bytes(sdir) * TIER_BUDGET_SHARE, verify=verify,
            faults=getattr(FaultPlan, plan)(seed=0))
        prompts, _ = the_requests(np, mods, cfg)
        run, reqs, srv, launches[tag] = tier_serve(
            torch, np, mods, eng, tag, superkernel=True, prompts=prompts,
            base=base)
        rt, g = run["report_tier"], store.guard
        check(rt["n_corrupt_detected"] > 0,
              f"[{tag}] no corruption detected: {rt}")
        check(plan != "corrupt_disk" or rt["n_quarantined_experts"] > 0,
              f"[{tag}] nothing quarantined: {rt}")
        check(g.n_episodes == g.n_requarantined + len(g.quarantined)
              + len(g.healing), f"[{tag}] episode invariant broken: "
              f"{g.n_episodes} != {g.n_requarantined} + "
              f"{len(g.quarantined)} + {len(g.healing)}")
        bad = [k for k in g.quarantined
               if eng.table.slot_of[k] >= 0 or store.host_resident(k)]
        check(not bad, f"[{tag}] quarantined experts resident: {bad}")
        run["slots_checked"] = check_slots(torch, eng, tag)
        log(f"tier [{tag}]: every request emitted its budget; episodes "
            f"{g.n_episodes} = {g.n_requarantined} healed + "
            f"{len(g.quarantined)} quarantined + {len(g.healing)} open; "
            f"all {run['slots_checked']} occupied device slots hold their "
            f"shard records' bytes; no quarantined expert resident")
        run["build_s"] = t_build
        runs[tag] = run
        store.close()
        del eng, srv
        release(torch)


def qwen_tier(torch, np, mods, root, written, runs, launches, serving):
    """D.4: qwen2-moe-57b, superkernel, from disk shards of as many of its
    28 layers as the disk's free bytes and the run's write allowance
    (`DISK_WRITE_LIMIT`, less the `written` bytes) hold, DISK_MARGIN to
    spare: all of them where both have room. Its host budget is
    QWEN_TIER_BUDGET's share of the full depth's shards (35 %)."""
    import shutil
    arch = "qwen2-moe-57b"
    full = mods["get_config"](arch)
    layer_bytes = (full.moe.num_experts * full.expert_bytes())
    free = shutil.disk_usage(root).free
    allowance = DISK_WRITE_LIMIT - TRAIN_CKPT_BYTES - written
    room = min(free, allowance) - DISK_MARGIN
    layers = max(0, min(full.num_layers, int(room // layer_bytes)))
    why = ""
    if layers < full.num_layers:
        why = (f"{full.num_layers} layers' shards are "
               f"{full.num_layers * layer_bytes / 1e9:.1f} GB; the shard "
               f"disk had {free / 1e9:.1f} GB free and the run may write "
               f"{allowance / 1e9:.1f} GB more to it (phase 14's "
               f"checkpoints kept apart), "
               f"{DISK_MARGIN / 1e9:.0f} GB to spare: {layers} layers, "
               f"{layers * layer_bytes / 1e9:.1f} GB")
    check(layers >= 1, f"[{arch}] the shard disk holds no layer")
    cfg = model_at_depth(mods, arch, layers)
    budget = QWEN_TIER_BUDGET * layers / full.num_layers
    tag = f"{arch} superkernel monolithic tiered"
    if why:
        log(f"tier [{tag}]: depth cut to {layers} of {full.num_layers} "
            f"layers: {why}")
    sdir = str(root / arch)
    params, secs, nbytes = export_seeded(torch, mods, cfg, sdir)
    eng, store, t_build = tier_engine(torch, mods, cfg, params, sdir,
                                      superkernel=True, budget=budget)
    log(f"tier [{tag}]: {layers} layers, {nbytes / 1e9:.2f} GB of shards; "
        f"host budget {budget / 2**30:.2f} GiB = "
        f"{store.budget_records} records "
        f"({budget / store.total_expert_bytes:.0%}), pool "
        f"{store.capacity} records = {store.nbytes / 1e9:.2f} GB pinned; "
        f"slots {eng.n_slots} = {eng.n_slots * cfg.expert_bytes() / 1e9:.2f}"
        f" GB; engine {t_build:.1f} s")
    n_req, n_prompt, n_new = QWEN_TIER_REQUESTS
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n_prompt)
               for _ in range(n_req)]
    run, reqs, srv, launches[tag] = tier_serve(
        torch, np, mods, eng, tag, superkernel=True, prompts=prompts,
        new_tokens=n_new, batch=n_req,
        base=serving.get(f"{arch} superkernel monolithic"))
    snap = run["tier_snapshot"]
    check(run["host_misses"] > 0 and snap["promotions"] > 0
          and snap["evictions"] > 0, f"[{tag}] no host churn: {snap}")
    occupied = [s for s, k in enumerate(eng.table.key_of_slot)
                if k is not None]
    pick = sorted(np.random.default_rng(SEED).choice(
        occupied, size=min(64, len(occupied)), replace=False).tolist())
    run["slots_checked"] = check_slots(torch, eng, tag, pick)
    log(f"tier [{tag}]: every request emitted its budget with finite "
        f"logits; {run['slots_checked']} occupied device slots drawn from "
        f"the seed hold their shard records' bytes")
    run.update(export_s=secs, export_bytes=nbytes, build_s=t_build,
               published_layers=full.num_layers, depth_cut_why=why or None,
               free_disk_GB=free / 1e9)
    runs[tag] = run
    store.close()
    del eng, srv, params
    release(torch)
    shutil.rmtree(sdir)


def log_beside(tag, run, base):
    """Print a biased run's counters and times beside its bias-off run's."""
    def line(r):
        gb = r["swapped_bytes"] / 1e9
        return (f"demand misses {r['demand_misses']}, replays {r['replays']}"
                f", swapped {gb:.2f} GB ({r['copy_s']:.2f} s, "
                f"{r['h2d_GBps']:.2f} GB/s), TTFT p50 "
                f"{r['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
                f"{r['tpot_p50_s'] * 1e3:.1f} ms, "
                f"{r['throughput_tok_s']:.2f} tok/s")
    log(f"serving [{tag}]: {line(run)}")
    log(f"serving [{tag}]: bias off (same call): {line(base)}")


def alone(eng, prefill_fn, prompt, width, DecodeState):
    """`prompt` prefilled through `prefill_fn`: its logits and a decode
    state of `width` rows holding the request in row 0, the others empty
    (width 1 is the plain single-stream state)."""
    lr, st = prefill_fn(prompt[None, :])
    if width > 1:
        wide = eng.alloc_decode_state(width)
        eng._commit_prefill_row(wide, 0, st.caches, st.pos)
        st = DecodeState(wide.caches, wide.cache_len, pos=int(st.pos))
    return lr, st


def stream_partings(torch, np, eng, reqs, prompts, prefill_fn, step_fn,
                    width, DecodeState):
    """Each served request's tokens against greedy decoding of its prompt
    alone, teacher-forced on the served tokens: prefilled through
    `prefill_fn` (the fully-resident oracle of the run's admission), then
    stepped through `step_fn` in a state of
    `width` rows with the request in row 0 (the others empty; width 1 is
    the plain single-stream state). Returns [(request id, step, served
    token, reference token, the reference's top-2 logit gap)] for every
    stream that parts, at the step where it first does."""
    parts = []
    for r, p in zip(reqs, prompts):
        lr, st = alone(eng, prefill_fn, p, width, DecodeState)
        for step, t in enumerate(r.output):
            row = lr[0].float().cpu().numpy()
            want = int(row.argmax())
            if t != want:
                top2 = np.sort(row)[-2:]
                parts.append((r.request_id, step, t, want,
                              float(top2[1] - top2[0])))
                break
            tok = torch.zeros(width, dtype=torch.long, device=eng.device)
            tok[0] = t
            lr, st = step_fn(tok, st)
    return parts


def router_flip(torch, eng, moe_mod, prefill_fn, wide_step, prompt, tokens,
                DecodeState):
    """The first routing decision that batch 1 and the serving batch's
    width make differently for one request: its prompt prefilled through
    `prefill_fn` and decoded teacher-forced on `tokens`, alone through the
    fully-resident reference and in row 0 of a 4-row state through
    `wide_step` (the path's oracle at the batch's width), each MoE layer's
    routing of row 0 recorded (`_route_ffn_entry` unfused,
    `moe_slotbuf_fused` on the superkernel path, whose router logits are
    recomputed from its input). Returns None if every decode step routed
    alike, else the step, the MoE layer, the swapped experts, `tie` (the
    larger of the two widths' router-logit gaps between what each chose
    and the other did not) and `drift` (max |router-logit difference| of
    the two widths at that layer)."""
    eng_mod = sys.modules[type(eng).__module__]
    entry, fused = eng_mod._route_ffn_entry, moe_mod.moe_slotbuf_fused

    def routed(step_fn, width):
        rec, steps = [], []

        def entry_hook(*a, **kw):
            out = entry(*a, **kw)
            rec.append((out[1].expert_ids[0].tolist(),
                        out[1].logits[0].float().cpu()))
            return out

        def fused_hook(params, slot_weights, soe, x, moe, logit_bias=None):
            out = fused(params, slot_weights, soe, x, moe, logit_bias)
            lg = x[:1].float() @ params["router"].float()
            if logit_bias is not None:
                lg = lg + logit_bias.float()
            rec.append((out[2][0].tolist(), lg[0].cpu()))
            return out
        _, st = alone(eng, prefill_fn, prompt, width, DecodeState)
        eng_mod._route_ffn_entry, moe_mod.moe_slotbuf_fused = \
            entry_hook, fused_hook
        try:
            for t in tokens:
                tok = torch.zeros(width, dtype=torch.long, device=eng.device)
                tok[0] = t
                _, st = step_fn(tok, st)
                steps.append(rec[:])
                rec.clear()
        finally:
            eng_mod._route_ffn_entry, moe_mod.moe_slotbuf_fused = entry, fused
        return steps

    for step, (one, four) in enumerate(zip(
            routed(eng.reference_decode_step, 1), routed(wide_step, 4))):
        for layer, ((ids1, l1), (ids4, l4)) in enumerate(zip(one, four)):
            a, b = sorted(set(ids1) - set(ids4)), sorted(set(ids4) - set(ids1))
            if not a:
                continue
            tie = max(float(l1[a].min() - l1[b].max()),
                      float(l4[b].min() - l4[a].max()))
            return {"step": step, "layer": layer, "swapped": [a, b],
                    "tie": tie, "drift": float((l1 - l4).abs().max())}
    return None


# --------------------------------------------------------------- phase 13

# (b): the reference test's controller settings for the starved link
HORIZON_CTRL = dict(capacity_guard=False, stall_threshold=40,
                    overfetch_threshold=10 ** 9)
HORIZON_LINKS = (("starved", 1.0), ("fast", 64e9))
HORIZON_STEPS = 16
# (c): the forest fits the first FOREST_REQUESTS requests' traces in a
# process of its own while the card runs (a), (b), (d) and (e): numpy on
# one core, it takes about a minute at olmoe's widths for 4 requests (16
# layers, 64 experts, 1,106 features, 16 trees of depth 12) and about
# twice that for all 8
FOREST_REQUESTS = 4
TRACE_REQUESTS = 8
TRACE_NEW = 16
FOREST_FIT = """
import pickle, sys, time
sys.path.insert(0, sys.argv[1])
from repro_torch.core import FeatureSpec, ForestPredictor, TraceLog
log = TraceLog.load(sys.argv[2])
spec = FeatureSpec(*pickle.loads(bytes.fromhex(sys.argv[3])))
t0 = time.perf_counter()
forest = ForestPredictor(spec)
mse = forest.fit(log)
with open(sys.argv[4], "wb") as f:
    pickle.dump((forest, mse, time.perf_counter() - t0), f)
"""


def collect_traces(torch, np, mods, cfg, tag):
    """(c): `Engine` on the card, the CLI's recipe at full width: each
    request of a poisson workload generated greedily, its prompt padded to
    a multiple of 16; checks each step's ids and layer count, and a rerun of
    request 0. Returns (requests, trace log of the first FOREST_REQUESTS,
    routers, summary)."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    t0 = time.perf_counter()
    eng = mods["Engine"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), max_seq=256, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    L = len(eng.moe_layer_ids)
    specs = mods["make_workload"]("poisson", TRACE_REQUESTS, seed=SEED,
                                  mean_decode=TRACE_NEW)
    rng = np.random.default_rng(SEED)
    reqs, logs, first = [], mods["TraceLog"](), None
    for n in KERNELS:
        mods[n].launches = 0
    t0 = time.perf_counter()
    for i, sr in enumerate(specs):
        n_steps = max(2, min(sr.decode_len, TRACE_NEW))
        toks = mods["pad_to_bucket"](mods["prompt_tokens"](
            sr, cfg.vocab_size, rng))
        out, trace, log_ = eng.generate(toks[None, :], n_steps=n_steps)
        check(len(trace.steps) == n_steps
              and all(len(st.assignments) == L for st in trace.steps),
              f"[{tag}] request {i}: {len(trace.steps)} steps, layers "
              f"{[len(st.assignments) for st in trace.steps]}")
        check(all(a.min() >= 0 and a.max() < E and a.shape[-1] == k
                  for st in trace.steps for a in st.assignments),
              f"[{tag}] request {i}: expert ids outside [0, {E})")
        if i < FOREST_REQUESTS:
            logs.extend(log_.samples)
        if i == 0:
            first = (toks, out, trace)
        reqs.append(mods["ServingRequest"](
            prompt_len=sr.prompt_len, max_new_tokens=n_steps,
            steps=trace.steps, arrival_s=sr.arrival_s,
            request_id=sr.request_id, topic=sr.topic))
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = counters(mods)
    toks, out, trace = first
    out2, trace2, _ = eng.generate(toks[None, :], n_steps=len(trace.steps))
    same = np.array_equal(out, out2) and all(
        np.array_equal(a, b) for s1, s2 in zip(trace.steps, trace2.steps)
        for a, b in zip(s1.assignments, s2.assignments))
    check(same, f"[{tag}] a rerun of request 0 gave other ids or tokens")
    routers = eng.routers()
    del eng
    release(torch)
    n_steps = sum(r.max_new_tokens for r in reqs)
    summ = {"init_s": t_init, "generate_s": t_gen, "requests": len(reqs),
            "decode_steps": n_steps, "samples": len(logs.samples),
            "forest_requests": FOREST_REQUESTS, "launches": launches,
            "prompt_tokens": [int(r.prompt_len) for r in reqs],
            "rerun_bitwise": True}
    log(f"trace [{tag}]: Engine at full width on the card ({t_init:.1f} s "
        f"init): {len(reqs)} requests, {n_steps} steps of {L} MoE layers in "
        f"{t_gen:.2f} s; ids in [0, {E}), {L} layers a step; a rerun of "
        f"request 0 bitwise; {len(logs.samples)} samples of the first "
        f"{FOREST_REQUESTS} requests for the forest; launches {launches}")
    return reqs, logs, routers, summ


def start_forest_fit(mods, logs, spec):
    """Fit `ForestPredictor(spec)` on `logs` in a child process (numpy on
    the host, while the card runs). Returns a function that waits for it
    and returns (forest, mse, fit seconds)."""
    import os
    import pickle
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_forest_")
    path, out = os.path.join(tmp, "trace.jsonl"), os.path.join(tmp, "f.pkl")
    logs.save(path)
    arg = pickle.dumps(dataclasses.astuple(spec)).hex()
    proc = subprocess.Popen([sys.executable, "-c", FOREST_FIT, str(SRC),
                             path, arg, out])

    def wait():
        try:
            rc = proc.wait()
            check(rc == 0, f"forest fit exited {rc}")
            with open(out, "rb") as f:
                return pickle.load(f)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)
    return wait


def horizon_links(torch, mods, cfg, prompt):
    """(b): one stream, prefill + HORIZON_STEPS greedy decode steps on the
    superkernel path, starved link against a fast one, each with the
    reference test's controller: every step's logits bitwise the path's
    oracle (teacher-forced on the slot path's tokens afterwards, so no
    oracle launch is counted), the kernels of the path launched. Returns
    {link: summary}."""
    DecodeState = mods["DecodeState"]
    out = {}
    for name, bw in HORIZON_LINKS:
        tag = f"{cfg.name} superkernel single-stream link {name}"
        ctrl = mods["StepSizeController"](
            cfg=mods["StepSizeConfig"](**HORIZON_CTRL), s=2)
        eng, _, _ = build_engine(torch, mods, cfg, superkernel=True,
                                 link_bandwidth=bw, controller=ctrl)
        for n in KERNELS:
            mods[n].launches = 0
        t0 = time.perf_counter()
        lg, st = eng.prefill(prompt)
        rows, toks = [lg], []
        for _ in range(HORIZON_STEPS):
            tok = lg.argmax(-1)
            toks.append(tok)
            lg, st = eng.decode_step(tok, st)
            rows.append(lg)
        eng.synchronize()
        wall = time.perf_counter() - t0
        launches = counters(mods)
        on_path = on_path_kernels(cfg, True)
        check(all(launches[n] > 0 for n in on_path)
              and all(launches[n] == 0 for n in KERNELS if n not in on_path),
              f"[{tag}] launches off the path's kernels: {launches}")
        lr, sr = eng.reference_prefill(prompt)
        worst = float((rows[0] - lr).abs().max())
        for tok, row in zip(toks, rows[1:]):
            lr, sr = sk_reference_decode_step(eng, tok, sr, DecodeState)
            worst = max(worst, float((row - lr).abs().max()))
        check(worst == 0.0, f"[{tag}] differs from the segment functions "
                            f"over every expert: max |dlogit| {worst}")
        s_ = eng.stats
        out[name] = {
            "link_bandwidth": bw, "final_s": ctrl.s,
            "s_history": list(ctrl.s_history), "late_hits": s_.late_hits,
            "demand_misses": s_.demand_misses,
            "prefetch_hits": s_.prefetch_hits, "prefetched": s_.prefetched,
            "replays": s_.replays, "spec_layers": s_.spec_layers,
            "host_syncs": s_.host_syncs, "guard_hits": ctrl.guard_hits,
            "wall_s": wall, "launches": launches, "oracle_bitwise": True}
        log(f"horizon [{tag}]: final S {ctrl.s}, S history "
            f"{ctrl.s_history}, late hits {s_.late_hits}, demand misses "
            f"{s_.demand_misses}, prefetch hits {s_.prefetch_hits}, "
            f"replays {s_.replays}, host syncs {s_.host_syncs} over prefill "
            f"+ {HORIZON_STEPS} decode steps in {wall:.2f} s; bitwise the "
            f"segment functions over every expert; launches {launches}")
        eng.drop_resident_experts()
        del eng
        release(torch)
    return out


def engine_card_vs_cpu(torch, np, mods, arch, n_steps=8):
    """(d): `Engine` on a smoke config on the card against the same params
    on the CPU, one prompt of 2 rows: the recorded ids equal until a
    router near-tie (the first parting's swapped experts within NEAR_TIE
    of each other in the CPU's router logits), the tokens equal until
    such a parting or a near-tie of the CPU's top two logits."""
    cfg = mods["get_smoke_config"](arch)
    card = mods["Engine"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), max_seq=64, device="cuda")
    cpu = mods["Engine"](cfg, max_seq=64, device="cpu")
    cpu.params = _tree_to(card.params, "cpu")
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 12))
    got = {}
    for name, eng in (("card", card), ("cpu", cpu)):
        seen = []
        for fn in ("_prefill_collect", "_decode_collect"):
            orig = getattr(eng, fn)

            def hook(*a, _o=orig):
                res = _o(*a)
                seen.append(([p.float().cpu() for _, p in res[2]],
                             res[0].float().cpu()))
                return res
            setattr(eng, fn, hook)
        out, trace, _ = eng.generate(prompt, n_steps=n_steps)
        got[name] = (out, trace, seen)
    k = cfg.moe.top_k
    (out_g, tr_g, _), (out_c, tr_c, seen_c) = got["card"], got["cpu"]
    parted = None
    for s in range(n_steps):
        for li, (a, b) in enumerate(zip(tr_g.steps[s].assignments,
                                        tr_c.steps[s].assignments)):
            rows = [t for t in range(a.shape[0])
                    if set(a[t].tolist()) != set(b[t].tolist())]
            if not rows:
                continue
            lp = torch.log(seen_c[s][0][li][rows[0]])
            top = lp.sort(descending=True).values
            gap = float(top[k - 1] - top[k])
            check(gap <= NEAR_TIE, f"[{arch} Engine] step {s} layer {li}: "
                                   f"ids part at a router gap of {gap}")
            parted = ("ids", s, li, gap)
            break
        if parted:
            break
        if not np.array_equal(out_g[:, s], out_c[:, s]):
            row = seen_c[s][1][int(np.flatnonzero(out_g[:, s]
                                                  != out_c[:, s])[0])]
            top2 = row.topk(2).values
            gap = float(top2[0] - top2[1])
            check(gap <= NEAR_TIE, f"[{arch} Engine] step {s}: tokens part "
                                   f"at a top-2 gap of {gap}")
            parted = ("tokens", s, None, gap)
            break
    log(f"trace [{arch} smoke Engine]: card against the CPU over prefill + "
        f"{n_steps - 1} decode steps: "
        + ("every id and token equal" if parted is None else
           f"{parted[0]} part at step {parted[1]} (layer {parted[2]}) at a "
           f"near-tie, gap {parted[3]:.4g}; equal before it"))
    return {"parted": parted, "steps": n_steps}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def cli_runs(torch, mods):
    """(e): the port's serving CLI in process, both backends on the h100
    spec (its default arch's smoke config on the card). Returns {backend:
    summary}."""
    out = {}
    for backend in ("engine", "sim"):
        for n in KERNELS:
            mods[n].launches = 0
        t0 = time.perf_counter()
        res = mods["serve_main"](["--backend", backend, "--platform", "h100",
                                  "--device", "cuda"])
        wall = time.perf_counter() - t0
        reps = ([res["report"]] if backend == "engine"
                else list(res["reports"].values()))
        out[backend] = {"wall_s": wall, "launches": counters(mods),
                        "keys": sorted(reps[0].summary()),
                        "summaries": [r.summary() for r in reps]}
        log(f"cli [{backend}]: exited in {wall:.2f} s, {len(reps)} "
            f"report(s), launches {out[backend]['launches']}")
        release(torch)
    check(out["engine"]["keys"] == out["sim"]["keys"],
          f"the CLI's backends report different keys: "
          f"{set(out['engine']['keys']) ^ set(out['sim']['keys'])}")
    log(f"cli: both backends exited 0 with the same "
        f"{len(out['engine']['keys'])} report keys")
    return out


def horizon_phase(torch, np, mods, serving, launches):
    """Phase 13: the adaptive horizon's knobs and the simulator on the card
    (see the module docstring)."""
    runs = {}
    olmoe = model_at_depth(mods, "olmoe-1b-7b")
    # (c) traces at full width; the forest fits while the card runs on
    tag = "olmoe-1b-7b Engine"
    t0 = time.perf_counter()
    reqs, logs, routers, runs["trace"] = collect_traces(torch, np, mods,
                                                        olmoe, tag)
    launches[f"{tag} traces"] = runs["trace"]["launches"]
    L, M = len(routers), olmoe.moe.num_experts
    spec = mods["FeatureSpec"](olmoe.vocab_size, 16, L, M,
                               include_pregate=True)
    forest_done = start_forest_fit(mods, logs, spec)
    # (a) the no-prefetch baseline beside phase 5's prefetch-on run
    base = serving["olmoe-1b-7b superkernel monolithic"]
    atag = "olmoe-1b-7b superkernel monolithic prefetch off"
    serving[atag], launches[atag] = serving_phase(
        torch, np, mods, arch="olmoe-1b-7b", superkernel=True, chunk=0,
        prefetch=False)
    release(torch)
    a = serving[atag]

    def row(r):
        return (f"wall {r['wall_s']:.2f} s, TTFT p50 "
                f"{r['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
                f"{r['tpot_p50_s'] * 1e3:.1f} ms, swapped "
                f"{r['swapped_bytes'] / 1e9:.2f} GB ({r['copy_s']:.2f} s, "
                f"{r['h2d_GBps']:.2f} GB/s), demand misses "
                f"{r['demand_misses']}, host syncs a step "
                f"{r['host_syncs_per_decode_step']:.2f}, replays a step "
                f"{r['replays_per_decode_step']:.2f}, prefetched "
                f"{r['prefetched']}, speculative layers {r['spec_layers']}")
    log(f"horizon [{atag}]: {row(a)}")
    log(f"horizon [{atag}]: prefetch on (phase 5, same call): {row(base)}")
    # (b) starved against fast link, one stream
    prompts, _ = the_requests(np, mods, olmoe)
    runs["links"] = horizon_links(torch, mods, olmoe, prompts[0][None, :])
    for name, r in runs["links"].items():
        launches[f"olmoe-1b-7b superkernel single-stream link {name}"] = \
            r.pop("launches")
    # (d) Engine on the smoke configs, card against the CPU
    runs["engine_card_vs_cpu"] = {
        arch: engine_card_vs_cpu(torch, np, mods, arch) for arch in ARCHS}
    # (e) the CLI
    runs["cli"] = cli_runs(torch, mods)
    for backend, r in runs["cli"].items():
        launches[f"cli {backend}"] = r["launches"]
    # (c) the modeled policy comparison on the card's traces
    forest, mse, fit_s = forest_done()
    runs["forest"] = {"mse": mse, "fit_s": fit_s,
                      "samples": len(logs.samples), "features":
                      spec.feature_dim}
    log(f"trace [{tag}]: forest fit on {len(logs.samples)} samples "
        f"({spec.feature_dim} features) in {fit_s:.1f} s (its own process, "
        f"beside the card's runs), mse {mse:.4f}")
    hw = mods["PLATFORMS"]["h100"]
    sim = mods["SimSpec"](
        expert_bytes=mods["expert_bytes"](olmoe),
        layer_time_s=mods["layer_time_decode"](olmoe, hw, 4, 64),
        capacity_experts=16 * L)
    wl_args = (L, M, olmoe.moe.top_k, routers)
    runs["modeled"] = {}
    for pol in (mods["baseline"](), mods["pregate_fixed"](2),
                mods["promoe_like"](2), mods["expertflow"]()):
        wl = mods["ServingWorkload"](*wl_args, reqs, model=olmoe.name,
                                     name="poisson")
        t1 = time.perf_counter()
        rep = mods["simulate_serving"](wl, sim, hw, pol, forest=forest,
                                       cfg=mods["ServingConfig"](max_batch=4))
        s_ = rep.summary()
        runs["modeled"][s_["policy"]] = dict(s_, sim_s=time.perf_counter()
                                             - t1)
        log(f"modeled [{s_['policy']}] (h100 spec, 16 slots a layer, batch "
            f"4; not measured): stall {s_['stall_s'] * 1e3:.3f} ms, TTFT "
            f"p50 {s_['ttft_p50_s'] * 1e3:.3f} ms, TPOT p50 "
            f"{s_['tpot_p50_s'] * 1e3:.3f} ms, hit {s_['hit_rate']:.3f}, "
            f"occupancy {s_['mean_occupancy']:.2f}")
    runs["phase_s"] = time.perf_counter() - t0
    log(f"horizon: phase 13 in {runs['phase_s']:.1f} s")
    return runs


def horizon_mods():
    """The port's modules phase 13 drives, imported after the build."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (FeatureSpec, TraceLog, baseline,
                                  expertflow, pregate_fixed, promoe_like)
    from repro_torch.core.step_size import (StepSizeConfig,
                                            StepSizeController)
    from repro_torch.data.workloads import make_workload, prompt_tokens
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine
    from repro_torch.simulator.events import SimSpec
    from repro_torch.simulator.hardware import (PLATFORMS, expert_bytes,
                                                layer_time_decode)
    from repro_torch.simulator.serving import (ServingConfig,
                                               ServingRequest,
                                               ServingWorkload,
                                               simulate_serving)
    return dict(
        get_smoke_config=get_smoke_config, FeatureSpec=FeatureSpec,
        TraceLog=TraceLog, baseline=baseline, expertflow=expertflow,
        pregate_fixed=pregate_fixed, promoe_like=promoe_like,
        StepSizeConfig=StepSizeConfig, StepSizeController=StepSizeController,
        make_workload=make_workload, prompt_tokens=prompt_tokens,
        pad_to_bucket=serve._pad_to_bucket, serve_main=serve.main,
        Engine=Engine, SimSpec=SimSpec, PLATFORMS=PLATFORMS,
        expert_bytes=expert_bytes, layer_time_decode=layer_time_decode,
        ServingConfig=ServingConfig, ServingRequest=ServingRequest,
        ServingWorkload=ServingWorkload, simulate_serving=simulate_serving)


# ---------------------------------------------------------------------------
# phase 14: the plain Model API on the attention-only models, then training
# ---------------------------------------------------------------------------

# Depth cuts of phase 14 (widths, heads, vocabularies as published): arch ->
# (layers, why). gemma2 keeps two local and two global layers.
TRAIN_DEPTH = {
    "yi-9b": (4, "the Model API's oracle is per layer; 4 of 48 layers hold "
                 "its prefill / decode / forward in the phase's time"),
    "command-r-plus-104b": (2, "104 B params do not fit the card; 2 of 64 "
                               "layers: 12.6 GB with its 256000 x 12288 "
                               "tied embedding"),
    "minicpm3-4b": (4, "4 of 62 layers: the MLA kernel at 40 heads runs "
                       "once a layer"),
    "gemma2-9b": (4, "4 of 42 layers: two local (4096-row window) and two "
                     "global, the pattern's two units"),
    "llava-next-34b": (2, "2 of 60 layers of the backbone (34 B params do "
                          "not fit beside the phase's other models)"),
    "olmoe-1b-7b": (4, "training keeps params, grads and two fp32 moments "
                       "(12 B a param) and the optimizer's new state: 4 of "
                       "16 layers, 1.9 G params, ~42 GB at the update"),
    "yi-9b train": (2, "2 of 48 layers: the reference test's one-batch "
                       "descent at full width"),
    "olmoe-1b-7b ckpt": (1, "each checkpoint writes params and both fp32 "
                            "moments to the disk (6.3 GB at 1 of 16 "
                            "layers), inside the run's disk allowance")}
API_ARCHS = ("yi-9b", "command-r-plus-104b", "minicpm3-4b", "gemma2-9b",
             "llava-next-34b")
API_PROMPT = 64          # prompt tokens (gemma2: past its window, below)
API_STEPS = 4            # decode steps, each against forward
GEMMA2_PROMPT = 4100     # > the 4096-row window: the local rings wrap
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 10
TRAIN_LR = 3e-4   # the reference's default (1e-3 overshoots at d 2048)
CKPT_STEPS, CKPT_EVERY = 6, 3
# the bytes phase 14's checkpoints write (2 saves of olmoe at 1 layer:
# 626.5 M params in bf16 and two fp32 moments), kept out of phase 12's
# allowance
TRAIN_CKPT_BYTES = 13e9
CARD_VS_CPU = ("olmoe-1b-7b", "yi-9b", "gemma2-9b", "minicpm3-4b")
TOL_CARD_CPU = 1e-4


def train_mods():
    """The port's modules phase 14 drives, imported after the build."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import token_batches
    from repro_torch.distributed.fault_tolerance import TrainRunner
    from repro_torch.kernels import decode_superkernel as dsk
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer
    from repro_torch.training import optimizer, steps
    from repro_torch.tree import tree_leaves, tree_map
    return dict(Checkpointer=Checkpointer, get_config=get_config,
                get_smoke_config=get_smoke_config,
                token_batches=token_batches, TrainRunner=TrainRunner,
                dsk=dsk, train_cli=train_cli, transformer=transformer,
                optimizer=optimizer, steps=steps, tree_leaves=tree_leaves,
                tree_map=tree_map)


def cut(cfg, layers):
    return dataclasses.replace(cfg, num_layers=layers,
                               name=f"{cfg.name}@{layers}")


def near_tie_held(torch, got, want, tag):
    """The same greedy token in every row unless the reference's top two
    logits lie within NEAR_TIE; returns max |dlogit|."""
    same = got.argmax(-1) == want.argmax(-1)
    top2 = torch.topk(want.float(), 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    check(bool((same | (gap <= NEAR_TIE)).all()),
          f"[{tag}] greedy tokens part past a near-tie: gaps "
          f"{gap[~same].tolist()}")
    return float((got.float() - want.float()).abs().max())


def api_run(torch, tm, arch, dev, g, smoke):
    """One model: prefill + API_STEPS decode steps (the decode kernels)
    against forward on the grown sequence, and every layer's kernel decode
    against its plain decode at the first step."""
    T = API_PROMPT
    if smoke:
        cfg = tm["get_smoke_config"](arch)
        T = 20 if arch == "gemma2-9b" else T
    else:
        cfg = cut(tm["get_config"](arch), TRAIN_DEPTH[arch][0])
        T = GEMMA2_PROMPT if arch == "gemma2-9b" else T
    model = tm["transformer"].Model(cfg)
    B, d = 2, cfg.d_model
    t0 = time.perf_counter()
    params = model.init(g, device=dev)
    torch.cuda.synchronize() if dev == "cuda" else None
    init_s = time.perf_counter() - t0
    n = T + API_STEPS
    if cfg.uses_input_embeds:
        seq = (torch.randn((B, n, d), generator=g, device=dev) * 0.5
               ).to(model.dtype)
        inp = lambda k: {"embeds": seq[:, :k]}  # noqa: E731
    else:
        toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                             device=dev)
        inp = lambda k: {"tokens": toks[:, :k]}  # noqa: E731
    res = {"layers": cfg.num_layers, "prompt": T, "init_s": init_s}
    t0 = time.perf_counter()
    with torch.no_grad():
        fwd = model.logits(params, model.forward(params, **inp(T))[:, -1])
        lp, cache = model.prefill(params, **inp(T), max_seq=n + 4)
        e = float((lp - fwd).abs().max())
        check(torch.allclose(lp, fwd, rtol=TOL, atol=TOL),
              f"[{arch}] prefill's last logits part from forward's: "
              f"max |d| {e}")
        res["prefill_max_abs_dlogit"] = e
        specs, layer_checks = model.specs, []
        nxt = lp.argmax(-1)
        errs = []
        for i in range(API_STEPS):
            tok = seq[:, T + i] if cfg.uses_input_embeds else nxt
            if i == 0:      # every layer: kernel decode against plain
                # (the comparison's launches are not the path's)
                n0 = {k: getattr(tm["dsk"], k).launches for k in
                      ("fused_decode_attention",
                       "fused_mla_decode_attention")}
                x = tok[:, None] if tok.dim() == 2 else \
                    model.embed(params, tok[:, None])
                clen = cache["len"]
                for li, (p, sp, c) in enumerate(zip(
                        params["layers"], specs, cache["layers"])):
                    # the attention part alone (before the post-norm and
                    # the residual add): TOL absolute, or one bf16 step of
                    # the value where that step is larger (|value| > 2.56:
                    # the two sides are one rounding of it apart)
                    ak, ck = tm["transformer"].attn_decode(
                        p, cfg, sp, x, c, clen, use_kernel=True)
                    ap, cp = tm["transformer"].attn_decode(
                        p, cfg, sp, x, c, clen, use_kernel=False)
                    for name in ck:
                        check(torch.equal(ck[name], cp[name]),
                              f"[{arch}] layer {li}: the kernel's new "
                              f"{name} cache differs from the plain one")
                    d = (ak.float() - ap.float()).abs()
                    le = float(d.max())
                    check(bool((d <= torch.clamp(
                              2.0 ** -7 * ap.float().abs(), min=TOL)).all()),
                          f"[{arch}] layer {li}: the kernel's attention "
                          f"parts from plain by {le}")
                    layer_checks.append(
                        {"max_abs_err": le,
                         "max_abs_out": float(ap.float().abs().max())})
                    x, _ = tm["transformer"].layer_decode(
                        p, cfg, sp, x, c, clen, use_kernel=True)
                for k, v in n0.items():
                    getattr(tm["dsk"], k).launches = v
            ld, cache = model.decode_step(params, tok, cache)
            if cfg.uses_input_embeds:
                h = model.forward(params, **inp(T + i + 1))
            else:
                toks = torch.cat([toks, tok[:, None]], 1)
                h = model.forward(params, tokens=toks)
            ref = model.logits(params, h[:, -1])
            errs.append(near_tie_held(torch, ld, ref, f"{arch} step {i}"))
            nxt = ld.argmax(-1)
    if dev == "cuda":
        torch.cuda.synchronize()
    res.update(decode_max_abs_dlogit=errs, layer_kernel_vs_plain=layer_checks,
               finite=bool(torch.isfinite(ld).all()),
               run_s=time.perf_counter() - t0)
    check(res["finite"], f"[{arch}] decode logits not finite")
    del params, cache
    return res


def train_steps(torch, tm, model, params, opt, batches, n, remat=True):
    step = tm["steps"].make_train_step(model, lr=TRAIN_LR, remat=remat,
                                       ce_chunk=2048)
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, next(batches))
        losses.append(float(met["loss"]))       # synchronises
        times.append(time.perf_counter() - t0)
    return params, opt, losses, times


def batch_iter(torch, tm, cfg, B, T, dev, seed=0):
    for toks, labels in tm["token_batches"](cfg.vocab_size, B, T, seed=seed):
        yield {"tokens": torch.from_numpy(toks).long().to(dev),
               "labels": torch.from_numpy(labels).long().to(dev)}


def train_phase(torch, np, dev="cuda", smoke=False):
    """Phase 14 (see the module docstring). `smoke` runs every part at the
    smoke configs (a CPU rehearsal). Returns (results, launches)."""
    import tempfile
    import shutil
    tm = train_mods()
    dsk = tm["dsk"]
    cuda = dev == "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {"depth": {k: v[0] for k, v in TRAIN_DEPTH.items()}}
    t_phase = time.perf_counter()

    # (a) the Model API, the decode kernels counted
    for k in ("fused_decode_attention", "fused_mla_decode_attention"):
        getattr(dsk, k).launches = 0
    api = {}
    for arch in API_ARCHS:
        api[arch] = api_run(torch, tm, arch, dev, g, smoke)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        log(f"[phase 14 (a)] {arch}: {json.dumps(api[arch])}")
    launches = {k: getattr(dsk, k).launches for k in
                ("fused_decode_attention", "fused_mla_decode_attention")}
    if cuda:
        for k, v in launches.items():
            check(v > 0, f"[phase 14 (a)] {k} never launched")
    res["api"] = api

    # (b) training olmoe at published width, 4 of 16 layers
    def model_for(arch, key):
        cfg = tm["get_smoke_config"](arch) if smoke else \
            cut(tm["get_config"](arch), TRAIN_DEPTH[key][0])
        return cfg, tm["transformer"].Model(cfg)

    cfg, model = model_for("olmoe-1b-7b", "olmoe-1b-7b")
    B, T = (2, 32) if smoke else (TRAIN_BATCH, TRAIN_SEQ)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params, opt = tm["steps"].init_train_state(model, g, device=dev)
    n_params = sum(p.numel() for p in tm["tree_leaves"](params))
    params, opt, losses, times = train_steps(
        torch, tm, model, params, opt,
        batch_iter(torch, tm, cfg, B, T, dev), TRAIN_STEPS)
    check(all(np.isfinite(losses)), f"[phase 14 (b)] loss not finite: "
                                    f"{losses}")
    check(np.mean(losses[-3:]) < losses[0], f"[phase 14 (b)] the loss did "
                                            f"not fall: {losses}")
    warm = times[1:]
    res["train_olmoe"] = {
        "params": n_params, "batch": [B, T], "losses": losses,
        "ms_per_step": 1e3 * statistics.median(warm),
        "first_step_ms": 1e3 * times[0],
        "tokens_per_s": B * T / statistics.median(warm),
        "steps_per_s": 1 / statistics.median(warm),
        "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                    if cuda else None)}
    log(f"[phase 14 (b)] {json.dumps(res['train_olmoe'])}")
    del params, opt
    gc.collect()

    # (c) yi-9b at full width, 2 layers: one batch memorised
    cfg, model = model_for("yi-9b", "yi-9b train")
    params, opt = tm["steps"].init_train_state(model, g, device=dev)
    one = next(batch_iter(torch, tm, cfg, 2, 16 if smoke else 256, dev,
                          seed=1))
    params, opt, losses, _ = train_steps(
        torch, tm, model, params, opt, iter([one] * 5), 5)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[phase 14 (c)] yi-9b did not descend: {losses}")
    res["train_yi"] = {"losses": losses}
    log(f"[phase 14 (c)] yi-9b losses {losses}")
    del params, opt
    gc.collect()

    # (d) checkpoint and resume on the card
    cfg, model = model_for("olmoe-1b-7b", "olmoe-1b-7b ckpt")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        params, opt = tm["steps"].init_train_state(model, g, device=dev)
        step = tm["steps"].make_train_step(model, lr=TRAIN_LR, remat=True)
        saved = {}

        def step_fn(state, batch):
            p, o, m = step(*state, batch)
            return (p, o), {"loss": float(m["loss"])}

        class Keeping(tm["Checkpointer"]):
            def maybe_save(self, s, tree, blocking=False):
                if s % self.every == 0:
                    saved[s] = tm["tree_map"](lambda x: x.detach().cpu(),
                                              tree)
                return super().maybe_save(s, tree, blocking)

        first = []
        ck = Keeping(root, keep=2, every=CKPT_EVERY)
        data = list(zip(range(CKPT_STEPS), batch_iter(
            torch, tm, cfg, B, T, dev, seed=2)))
        t0 = time.perf_counter()
        tm["TrainRunner"](step_fn, ck, (params, opt)).run(
            (b for _, b in data), CKPT_STEPS,
            metrics_cb=lambda s, m: first.append(m["loss"]))
        run_s = time.perf_counter() - t0
        # restore step 3 into a new runner (step 6's directory removed)
        shutil.rmtree(f"{root}/step_{CKPT_STEPS}")
        like = tm["steps"].init_train_state(model, g, device=dev)
        runner = tm["TrainRunner"](step_fn, tm["Checkpointer"](
            root, keep=2, every=10 ** 9), like)
        t0 = time.perf_counter()
        check(runner.restore_if_available(like) and runner.step == CKPT_EVERY,
              f"[phase 14 (d)] no restore of step {CKPT_EVERY}")
        restore_s = time.perf_counter() - t0
        for got, want in zip(tm["tree_leaves"](runner.state),
                             tm["tree_leaves"](saved[CKPT_EVERY])):
            check(got.dtype == want.dtype and torch.equal(got.cpu(), want),
                  "[phase 14 (d)] a restored leaf differs from the saved one")
        again = []
        runner.run((b for _, b in data[CKPT_EVERY:]), CKPT_STEPS,
                   metrics_cb=lambda s, m: again.append(m["loss"]))
        rel = [abs(a - b) / abs(b) for a, b in zip(again,
                                                   first[CKPT_EVERY:])]
        check(len(again) == CKPT_STEPS - CKPT_EVERY and max(rel) <= 1e-3,
              f"[phase 14 (d)] resumed losses {again} part from "
              f"{first[CKPT_EVERY:]}")
        res["checkpoint"] = {
            "losses": first, "resumed_losses": again,
            "bitwise": again == first[CKPT_EVERY:], "max_rel": max(rel),
            "run_s": run_s, "restore_s": restore_s,
            "checkpoint_gb": sum(
                f.stat().st_size for f in Path(root).rglob("*")
                if f.is_file()) / 1e9}
        log(f"[phase 14 (d)] {json.dumps(res['checkpoint'])}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params, opt, like, runner, saved
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (e) card against CPU: f32 smoke configs, same params and batch
    card_cpu = {}
    for arch in CARD_VS_CPU:
        cfg = dataclasses.replace(tm["get_smoke_config"](arch),
                                  dtype="float32")
        model = tm["transformer"].Model(cfg)
        pc = model.init(torch.Generator().manual_seed(SEED), device="cpu")
        toks, labels = next(tm["token_batches"](cfg.vocab_size, 2, 32))
        bc = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
        vg = tm["steps"].value_and_grad(tm["steps"].make_loss_fn(
            model, remat=False, ce_chunk=16))
        lc, gc_ = vg(pc, bc)
        ld, gd = vg(tm["tree_map"](lambda x: x.to(dev), pc),
                    {k: v.to(dev) for k, v in bc.items()})
        pairs = list(zip(tm["tree_leaves"](gd), tm["tree_leaves"](gc_)))
        err = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        lerr = abs(float(ld) - float(lc))
        check(abs(lerr) <= TOL_CARD_CPU * (1 + abs(float(lc))) and all(
            torch.allclose(a.cpu(), b, rtol=TOL_CARD_CPU, atol=TOL_CARD_CPU)
            for a, b in pairs), f"[phase 14 (e)] {arch}: card and CPU "
              f"part: loss {lerr}, grads max |d| {err}")
        card_cpu[arch] = {"loss": float(lc), "loss_err": lerr,
                          "grad_max_abs_err": err}
    res["card_vs_cpu"] = card_cpu
    log(f"[phase 14 (e)] {json.dumps(card_cpu)}")

    # (f) the CLI
    root = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    try:
        cli = tm["train_cli"].main(["--smoke", "--device", dev, "--steps",
                                    "20", "--ckpt-dir", root])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(cli["losses"][-1] < cli["losses"][0],
          f"[phase 14 (f)] the CLI's loss did not fall: {cli['losses']}")
    res["cli"] = {"start": cli["losses"][0], "final": cli["losses"][-1]}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase 14] done in {res['phase_s']:.1f} s")
    return res, launches


# ---------------------------------------------------------------------------
# phase 15: the recurrent and encoder-decoder models on the plain Model API,
# then their training
# ---------------------------------------------------------------------------

# Depth cuts of phase 15 (widths, heads, vocabularies as published): arch ->
# (layers, why); whisper's encoder is cut to its decoder's depth.
REC_DEPTH = {
    "recurrentgemma-2b": (6, "two (rec, rec, attn) units of its 26 layers: "
                             "four RG-LRU layers and two local-attention "
                             "layers"),
    "xlstm-1.3b": (9, "9 of 48: its sLSTM layers 0 and 8 with the seven "
                      "mLSTM layers between (a prefill runs a loop step a "
                      "token per layer over a 16 MiB state a row)"),
    "whisper-large-v3": (4, "4 of 32 decoder and 4 of 32 encoder layers, "
                            "over its full 1500 source frames")}
REC_PROMPT = {"recurrentgemma-2b": 2080,    # > the 2048-row window
              "xlstm-1.3b": 64, "whisper-large-v3": 32}
REC_BATCH = 2
REC_STEPS = 4            # decode steps, each against forward
REC_MIXER_T = 8          # (c): the mixers' prefill tokens
REC_GRADS = ("recurrentgemma-2b", "xlstm-1.3b", "whisper-large-v3")


def rec_mods():
    """The port's modules phase 15 drives, imported after the build."""
    from repro_torch.models import recurrent, xlstm
    tm = train_mods()
    tm.update(recurrent=recurrent, xlstm=xlstm)
    return tm


def rec_config(tm, arch, smoke):
    if smoke:
        return tm["get_smoke_config"](arch)
    cfg = tm["get_config"](arch)
    n = REC_DEPTH[arch][0]
    return dataclasses.replace(cfg, num_layers=n, name=f"{cfg.name}@{n}",
                               encoder_layers=min(cfg.encoder_layers, n))


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def rec_api_run(torch, tm, arch, dev, g, smoke):
    """One model: prefill + REC_STEPS decode steps against forward on the
    grown sequence, and every attention layer's kernel decode against its
    plain decode at the first step (those launches are not the path's)."""
    tf, dsk = tm["transformer"], tm["dsk"]
    cfg = rec_config(tm, arch, smoke)
    T = REC_PROMPT[arch] if not smoke else \
        (20 if arch == "recurrentgemma-2b" else 16)
    model = tf.Model(cfg)
    B = REC_BATCH
    t0 = time.perf_counter()
    params = model.init(g, device=dev)
    sync(torch, dev)
    res = {"layers": cfg.num_layers, "kinds": [s.kind for s in model.specs],
           "prompt": T, "init_s": time.perf_counter() - t0}
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
    t0 = time.perf_counter()
    enc = {}
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            S = cfg.max_source_positions
            frames = torch.randn((B, S, cfg.d_model), generator=g,
                                 device=dev).to(model.dtype)
            enc = {"enc_out": model.encode(params, frames)}
            res.update(source_frames=S, encoder_layers=cfg.encoder_layers)
        fwd = model.logits(params, model.forward(params, toks, **enc)[:, -1])
        sync(torch, dev)
        t1 = time.perf_counter()
        lp, cache = model.prefill(params, toks, max_seq=T + REC_STEPS + 4,
                                  **enc)
        sync(torch, dev)
        res["prefill_ms"] = 1e3 * (time.perf_counter() - t1)
        e = float((lp - fwd).abs().max())
        check(torch.allclose(lp, fwd, rtol=TOL, atol=TOL),
              f"[{arch}] prefill's last logits part from forward's: "
              f"max |d| {e}")
        res["prefill_max_abs_dlogit"] = e
        nxt = lp.argmax(-1)
        errs, step_ms, layer_checks = [], [], []
        for i in range(REC_STEPS):
            if i == 0:      # every attention layer: kernel against plain
                n0 = dsk.fused_decode_attention.launches
                clen = cache["len"]
                x = model.embed(params, nxt[:, None],
                                positions=clen.reshape(-1, 1).expand(B, 1))
                for li, (p, sp, c) in enumerate(zip(
                        params["layers"], model.specs, cache["layers"])):
                    if sp.kind == "attn":
                        ak, ck = tf.attn_decode(p, cfg, sp, x, c, clen,
                                                use_kernel=True)
                        ap, cp = tf.attn_decode(p, cfg, sp, x, c, clen,
                                                use_kernel=False)
                        for name in ck:
                            check(torch.equal(ck[name], cp[name]),
                                  f"[{arch}] layer {li}: the kernel's new "
                                  f"{name} cache differs from the plain one")
                        le = float((ak.float() - ap.float()).abs().max())
                        check(le <= TOL, f"[{arch}] layer {li}: the "
                                         f"kernel's attention parts from "
                                         f"plain by {le}")
                        layer_checks.append(
                            {"layer": li, "max_abs_err": le,
                             "max_abs_out": float(ap.float().abs().max())})
                    x, _ = tf.layer_decode(p, cfg, sp, x, c, clen,
                                           use_kernel=True)
                dsk.fused_decode_attention.launches = n0
            sync(torch, dev)
            t1 = time.perf_counter()
            ld, cache = model.decode_step(params, nxt, cache)
            sync(torch, dev)
            step_ms.append(1e3 * (time.perf_counter() - t1))
            toks = torch.cat([toks, nxt[:, None]], 1)
            h = model.forward(params, toks, **enc)
            ref = model.logits(params, h[:, -1])
            errs.append(near_tie_held(torch, ld, ref, f"{arch} step {i}"))
            nxt = ld.argmax(-1)
    sync(torch, dev)
    if dev == "cuda":
        res["loop_shares"] = loop_shares(torch, tm, cfg, params, model.specs,
                                         T, g)
    res.update(decode_max_abs_dlogit=errs, layer_kernel_vs_plain=layer_checks,
               decode_step_ms=step_ms,
               ms_per_decode_step=statistics.median(step_ms),
               max_abs_logit=float(ld.abs().max()),
               finite=bool(torch.isfinite(ld).all()),
               run_s=time.perf_counter() - t0)
    check(res["finite"], f"[{arch}] decode logits not finite")
    check(any(s.kind == "attn" for s in model.specs) == bool(layer_checks),
          f"[{arch}] an attention layer went unchecked")
    del params, cache, enc
    return res


def loop_shares(torch, tm, cfg, params, specs, T, g):
    """(e): each recurrent kind's time loop against its whole block, one
    layer of this model at its prompt's length, bf16 on the card (CUDA-event
    medians): the loop's share of the block's time."""
    rec, xl = tm["recurrent"], tm["xlstm"]
    B, H = REC_BATCH, cfg.num_heads
    out = {}
    for p, sp in zip(params["layers"], specs):
        if sp.kind == "attn" or sp.kind in out:
            continue
        dev = p["pre_norm"].device
        h = torch.randn((B, T, cfg.d_model), generator=g,
                        device=dev).to(p["pre_norm"].dtype)
        if sp.kind == "rec":
            r = p["rec"]
            xb, _ = rec._temporal_conv(h @ r["w_x"], r["conv_w"],
                                       r["conv_b"])
            a, b = rec._rglru_coeffs(r, xb.float())

            def block():
                rec.rglru_block(r, h)

            def loop():
                rec.rglru_scan(a, b)
        else:
            m = p["mix"]
            mlstm = sp.kind == "mlstm"
            if mlstm:
                u = h @ m["w_up"]
                u = u[..., :u.shape[-1] // 2]
                proj = xl._mlstm_project(m, H, u)
                st0 = xl.mlstm_zero_state(B, H, u.shape[-1] // H, dev)
            else:
                proj = xl._slstm_project(m, H, h)
                st0 = xl.slstm_zero_state(B, H, cfg.d_model // H, dev)

            def block(fn=xl.mlstm_block if mlstm else xl.slstm_block):
                fn(m, h, H)

            def loop(mlstm=mlstm, proj=proj, st0=st0):
                st = st0
                for t in range(T):
                    step = [x[:, t] for x in proj]
                    st, _ = xl._mlstm_step(st, step) if mlstm else \
                        xl._slstm_step(m, st, step)
        with torch.no_grad():
            b_ms = time_ms(torch, block, reps=3, inner=1)
            l_ms = time_ms(torch, loop, reps=3, inner=1)
        out[sp.kind] = {"tokens": T, "block_ms": b_ms, "loop_ms": l_ms,
                        "loop_share": l_ms / b_ms}
    return out


def mixers_card_vs_cpu(torch, tm, dev, smoke):
    """(c): each recurrent mixer at its published width in f32, params
    drawn on `dev` and copied to the CPU: an REC_MIXER_T-token prefill from
    no state, then one decode step from the CPU's state, on both; outputs
    and states within TOL_CARD_CPU."""
    rec, xl = tm["recurrent"], tm["xlstm"]
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    get = tm["get_smoke_config"] if smoke else tm["get_config"]
    rg, xc = get("recurrentgemma-2b"), get("xlstm-1.3b")
    f32 = torch.float32

    def rg_run(p, x, st):
        out, c, r = rec.rglru_block(p, x, conv_state=st and st[0],
                                    rec_state=st and st[1],
                                    decode=st is not None)
        return out, (c, r)

    def xl_run(fn):
        return lambda p, x, st: fn(p, x, xc.num_heads, state=st,
                                   decode=st is not None)

    cases = {
        "rglru_block": (rec.init_rglru_block(
            rg.d_model, rg.lru_width or rg.d_model, rg.conv1d_width, f32,
            generator=g, device=dev), rg_run, rg.d_model),
        "mlstm_block": (xl.init_mlstm_block(
            xc.d_model, xc.num_heads, xc.proj_factor, f32, generator=g,
            device=dev), xl_run(xl.mlstm_block), xc.d_model),
        "slstm_block": (xl.init_slstm_block(
            xc.d_model, xc.num_heads, xc.proj_factor, f32, generator=g,
            device=dev), xl_run(xl.slstm_block), xc.d_model)}
    out = {}
    for name, (p, run, d) in cases.items():
        pc = {k: v.cpu() for k, v in p.items()}
        x = torch.randn((REC_BATCH, REC_MIXER_T, d), generator=g, device=dev)
        xd = torch.randn((REC_BATCH, 1, d), generator=g, device=dev)
        with torch.no_grad():
            want, st = run(pc, x.cpu(), None)
            sync(torch, dev)
            t0 = time.perf_counter()
            got, st_d = run(p, x, None)
            sync(torch, dev)
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            want_d, st2 = run(pc, xd.cpu(), st)
            moved = [t.to(dev) for t in st]
            st_on = type(st)(*moved) if hasattr(st, "_fields") \
                else tuple(moved)
            t0 = time.perf_counter()
            got_d, st2_d = run(p, xd, st_on)
            sync(torch, dev)
            decode_ms = 1e3 * (time.perf_counter() - t0)
        pairs = list(zip((got, got_d, *st_d, *st2_d),
                         (want, want_d, *st, *st2)))
        err = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        check(all(torch.allclose(a.cpu(), b, rtol=TOL_CARD_CPU,
                                 atol=TOL_CARD_CPU) for a, b in pairs),
              f"[phase 15 (c)] {name}: card and CPU part by {err}")
        out[name] = {"d_model": d, "tokens": REC_MIXER_T,
                     "max_abs_err": err, "prefill_ms": prefill_ms,
                     "decode_ms": decode_ms}
        del p, pc
    return out


def recurrent_phase(torch, np, gpu, dev="cuda", smoke=False):
    """Phase 15 (see the module docstring); `gpu` is the card's nvidia-smi
    line, printed beside every time. `smoke` runs every part at the smoke
    configs (a CPU rehearsal). Returns (results, launches)."""
    tm = rec_mods()
    dsk = tm["dsk"]
    cuda = dev == "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {"gpu": gpu, "depth": {k: v[0] for k, v in REC_DEPTH.items()},
           "depth_why": {k: v[1] for k, v in REC_DEPTH.items()}}
    for arch, (n, why) in REC_DEPTH.items():
        log(f"[phase 15] {arch} cut to {n} layers: {why}")
    t_phase = time.perf_counter()

    # (a) + (b): the Model API, the GQA decode kernel counted
    dsk.fused_decode_attention.launches = 0
    api = {}
    for arch in REC_DEPTH:
        api[arch] = rec_api_run(torch, tm, arch, dev, g, smoke)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        log(f"[phase 15 (a)] {arch} ({gpu}): {json.dumps(api[arch])}")
    launches = {"fused_decode_attention": dsk.fused_decode_attention.launches}
    if cuda:
        check(launches["fused_decode_attention"] > 0,
              "[phase 15 (a)] fused_decode_attention never launched")
    res["api"] = api

    # (c) the mixers at full width, card against CPU in f32
    res["mixers_card_vs_cpu"] = mixers_card_vs_cpu(torch, tm, dev, smoke)
    log(f"[phase 15 (c)] ({gpu}) {json.dumps(res['mixers_card_vs_cpu'])}")
    gc.collect()

    # (d) training: the reference test's descent on xlstm smoke, then loss
    # and every gradient on the card against the CPU (f32 smoke)
    cfg = tm["get_smoke_config"]("xlstm-1.3b")
    model = tm["transformer"].Model(cfg)
    params, opt = tm["steps"].init_train_state(model, g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g, device=dev)
    step = tm["steps"].make_train_step(model, lr=1e-3, remat=False,
                                       ce_chunk=64)
    losses = []
    for _ in range(5):
        params, opt, met = step(params, opt, {"tokens": toks,
                                              "labels": toks})
        losses.append(float(met["loss"]))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[phase 15 (d)] xlstm smoke did not descend: {losses}")
    res["train_xlstm"] = {"losses": losses}
    log(f"[phase 15 (d)] xlstm smoke losses {losses}")
    card_cpu = {}
    for arch in REC_GRADS:
        cfg = dataclasses.replace(tm["get_smoke_config"](arch),
                                  dtype="float32")
        model = tm["transformer"].Model(cfg)
        pc = model.init(torch.Generator().manual_seed(SEED), device="cpu")
        toks, labels = next(tm["token_batches"](cfg.vocab_size, 2, 32))
        bc = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
        if cfg.is_encoder_decoder:
            bc["frames"] = torch.randn(
                (2, 24, cfg.d_model), generator=torch.Generator()
                .manual_seed(SEED + 1))
        vg = tm["steps"].value_and_grad(tm["steps"].make_loss_fn(
            model, remat=False, ce_chunk=16))
        lc, gc_ = vg(pc, bc)
        ld, gd = vg(tm["tree_map"](lambda x: x.to(dev), pc),
                    {k: v.to(dev) for k, v in bc.items()})
        pairs = list(zip(tm["tree_leaves"](gd), tm["tree_leaves"](gc_)))
        err = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        lerr = abs(float(ld) - float(lc))
        check(lerr <= TOL_CARD_CPU * (1 + abs(float(lc))) and all(
            torch.allclose(a.cpu(), b, rtol=TOL_CARD_CPU, atol=TOL_CARD_CPU)
            for a, b in pairs), f"[phase 15 (d)] {arch}: card and CPU "
              f"part: loss {lerr}, grads max |d| {err}")
        card_cpu[arch] = {"loss": float(lc), "loss_err": lerr,
                          "grad_max_abs_err": err, "leaves": len(pairs)}
    res["card_vs_cpu"] = card_cpu
    log(f"[phase 15 (d)] {json.dumps(card_cpu)}")

    # (e) timing
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase 15 (e)] ({gpu}) done in {res['phase_s']:.1f} s; prefill "
        f"ms, ms per decode step, loop shares: " + json.dumps(
            {a: [r["prefill_ms"], r["ms_per_decode_step"],
                 r.get("loop_shares")] for a, r in api.items()}))
    return res, launches


# ---------------------------------------------------------------------------
# phase 16: the pre-fused engine path, the superkernel's dense tail, the
# mesh on one card, the pipeline and the dry run
# ---------------------------------------------------------------------------

LEGACY_BATCH, LEGACY_PROMPT, LEGACY_SLOTS, LEGACY_REPS = 4, 64, 16, 3
# (b): DeepSeek-V2-Lite's widths with moe_every=2 at 4 layers (0-1 dense,
# 2 MoE, 3 a dense MLA tail); its one MoE layer's slots must hold a
# decode step's demand (batch 4 x top-6 = 24 experts at most) for the
# oracle to hold, and the prompts are one token each for the prefill's
TAIL_LAYERS, TAIL_SLOTS, TAIL_BATCH, TAIL_STEPS = 4, 32, 4, 8
MESH_YI_LAYERS, MESH_YI_TOKENS = 4, (2, 256)
PIPE_MICRO = 4
DRYRUN_CELLS = (("olmoe-1b-7b", "train_4k"),
                ("qwen3-moe-235b-a22b", "decode_32k"))
DRYRUN_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun
arch, shape = sys.argv[3].split(":")
try:
    out = dryrun.run_cell(arch, shape, multi_pod=False,
                          with_components=False)
except Exception as e:
    out = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def run_dryrun(cells=DRYRUN_CELLS):
    """(e): the dry run of `cells` on the fake 16x16 mesh, one child
    process a cell, all started together (fake tensors on the CPU: they
    never touch the card). Called after the card's timed phases, so none
    shares the host with them. Returns each cell's report."""
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = {}
    try:
        for a, s in cells:
            cell = f"{a}:{s}"
            out = os.path.join(tmp, f"{a}__{s}.json")
            procs[cell] = (out, subprocess.Popen(
                [sys.executable, "-c", DRYRUN_CHILD, str(SRC), out, cell],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        reports = {}
        for cell, (out, proc) in procs.items():
            _, err = proc.communicate()
            check(proc.returncode == 0,
                  f"[phase 16 (e)] dry run {cell} exited {proc.returncode}: "
                  f"{err[-2000:]}")
            with open(out) as f:
                reports[cell] = json.load(f)
        return reports
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_mods():
    """The port's modules phase 16 drives, imported after the build."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import token_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_stages
    from repro_torch.kernels import decode_superkernel as dsk
    from repro_torch.kernels import slot_gather
    from repro_torch.launch import hlo
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.engine import DecodeState, SlotBufferEngine
    from repro_torch.training import steps
    from repro_torch.tree import tree_leaves
    return dict(get_config=get_config, get_smoke_config=get_smoke_config,
                token_batches=token_batches, shd=shd,
                pipeline_stages=pipeline_stages, dsk=dsk,
                slot_gather=slot_gather, hlo=hlo, mesh=mesh_mod,
                moe_mod=moe_mod, Model=Model, DecodeState=DecodeState,
                SlotBufferEngine=SlotBufferEngine, steps=steps,
                tree_leaves=tree_leaves)


def _sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def legacy_part(torch, np, mm, gpu, dev, smoke):
    """(a) olmoe (full depth; smoke: its smoke config) through the
    pre-fused path: with every expert given a slot against the eager
    unrolled model (bitwise on the CPU; on the card within four bf16 steps,
    the GEMMs run at other shapes), at LEGACY_SLOTS a layer bitwise that
    all-resident run, and its per-forward counters and wall time beside
    the fused path's at the same slots."""
    cfg = mm["get_smoke_config"]("olmoe-1b-7b") if smoke else \
        mm["get_config"]("olmoe-1b-7b")
    slots = 4 if smoke else LEGACY_SLOTS
    model = mm["Model"](cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LEGACY_BATCH, LEGACY_PROMPT))).to(dev)
    # the eager unrolled model drop-free, as the smoke configs are (the
    # legacy path's capacity, B*T*k, drops nothing; the published
    # capacity factor would drop assignments in the grouped MoE)
    m = cfg.moe
    eager = mm["Model"](dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k)))
    with torch.no_grad():
        want = eager.forward(params, toks)
    res = {"batch": [LEGACY_BATCH, LEGACY_PROMPT], "slots": slots,
           "layers": cfg.num_layers, "gpu": gpu}

    def engine(n, fused):
        return mm["SlotBufferEngine"](
            cfg, params, model, n_slots_per_layer=n, fused=fused,
            use_kernel=fused, max_seq=256, device=dev)

    eng = engine(cfg.moe.num_experts, False)
    with torch.no_grad():
        x_all = eng.forward(toks)
    res["all_resident_vs_eager_max_abs"] = float(
        (x_all.float() - want.float()).abs().max())
    res["max_abs_x"] = float(want.float().abs().max())
    log(f"[phase 16 (a)] legacy with every expert a slot against the eager "
        f"unrolled model: max |d| {res['all_resident_vs_eager_max_abs']} "
        f"at |x| up to {res['max_abs_x']} (bitwise on the CPU; on the card "
        f"the two dispatch the MoE GEMMs at other shapes: the grouped "
        f"model 64-row capacities a group, the legacy path one 2048-row "
        f"dispatch over every slot)")
    check(eng.swap_count > 0, "[phase 16 (a)] nothing was swapped in")
    del eng
    gc.collect()
    for fused in (False, True):
        name = "fused" if fused else "legacy"
        eng = engine(slots, fused)
        walls, per = [], []
        with torch.no_grad():
            for _ in range(LEGACY_REPS):
                before = eng.stats.snapshot()
                _sync(torch, dev)
                t0 = time.perf_counter()
                x = eng.forward(toks)
                _sync(torch, dev)
                walls.append(1e3 * (time.perf_counter() - t0))
                after = eng.stats.snapshot()
                per.append({k: after[k] - before[k] for k in
                            ("swap_calls", "swap_experts", "swap_bytes",
                             "host_syncs", "demand_misses", "dispatches")})
                if not fused:
                    d = float((x.float() - x_all.float()).abs().max())
                    res["slots_vs_all_resident_max_abs"] = max(
                        d, res.get("slots_vs_all_resident_max_abs", 0.0))
        if fused:
            res["fused_max_abs_vs_eager"] = float(
                (x.float() - want.float()).abs().max())
        res[name] = {
            "wall_ms_median": statistics.median(walls), "wall_ms": walls,
            "first_forward": per[0], "per_forward": per[-1],
            "swapped_gb_per_forward": per[-1]["swap_bytes"] / 1e9}
        log(f"[phase 16 (a)] {name} at {slots} slots a layer ({gpu}): "
            f"{json.dumps(res[name])}")
        del eng
        gc.collect()
    # within four bf16 steps of the largest hidden value (one GEMM's
    # rounding carried through 16 layers' residual stream)
    check(res["all_resident_vs_eager_max_abs"]
          <= 4 * 2 ** -7 * res["max_abs_x"],
          f"[phase 16 (a)] the all-resident legacy forward parts from the "
          f"eager unrolled model by {res['all_resident_vs_eager_max_abs']}")
    check(res["slots_vs_all_resident_max_abs"] == 0.0,
          f"[phase 16 (a)] legacy at {slots} slots a layer differs from "
          f"all-resident: max |d| {res['slots_vs_all_resident_max_abs']}")
    return res


def tail_part(torch, np, mm, gpu, dev, smoke, kern):
    """(b) the superkernel's dense tail on DeepSeek-V2-Lite's widths
    (smoke: its smoke widths) at moe_every=2: TAIL_STEPS decode steps at
    batch TAIL_BATCH bitwise the fully-resident oracle (the engine's own
    segment functions over every expert, then the tail layer by layer
    through `layer_decode` and the model's logits), and within one bf16
    step of the logit (or TOL) of the same oracle with the tail's plain
    path; the tail's fused_mla_decode_attention launched once a step.
    Returns (results, the slot path's launches: its prefill and decode
    steps, not the oracle's)."""
    base = mm["get_smoke_config"]("deepseek-v2-lite") if smoke else \
        mm["get_config"]("deepseek-v2-lite")
    cfg = dataclasses.replace(
        base, num_layers=TAIL_LAYERS,
        moe=dataclasses.replace(base.moe, moe_every=2))
    model = mm["Model"](cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    eng = mm["SlotBufferEngine"](cfg, params, model,
                                 n_slots_per_layer=TAIL_SLOTS,
                                 use_kernel=True, use_superkernel=True,
                                 max_seq=256, device=dev)
    del params
    segs, tail = eng._sk_segments()
    check(tail == [TAIL_LAYERS - 1] and len(segs) == 1,
          f"[phase 16 (b)] layout {segs} + tail {tail}")
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                  (TAIL_BATCH, 1))
    DecodeState = mm["DecodeState"]
    mla = kern["fused_mla_decode_attention"]
    launches = dict.fromkeys(kern, 0)

    def counted(fn, *a):
        """fn(*a) with the kernels' launches during it added to the
        path's (the counts are set to 0 just before, read just after)."""
        for k in kern.values():
            k.launches = 0
        out = fn(*a)
        for n, k in kern.items():
            launches[n] += k.launches
        return out

    tail_mla = []
    sk_tail = eng._sk_tail

    def tail_counted(*a, **kw):
        n0 = mla.launches
        out = sk_tail(*a, **kw)
        tail_mla.append(mla.launches - n0)
        return out

    eng._sk_tail = tail_counted
    lg, s_slot = counted(eng.prefill, prompt)
    lr, s_ref = eng.reference_prefill(prompt)
    worst = float((lg - lr).abs().max())
    plain_worst, plain_ok = 0.0, True
    for _ in range(TAIL_STEPS):
        tok = lr.argmax(-1)
        lg, s_slot = counted(eng.decode_step, tok, s_slot)
        # the oracle with the tail's plain path: within one bf16 step of
        # the logit, or TOL
        lp, _ = sk_reference_decode_step(eng, tok, s_ref, DecodeState,
                                         tail_kernel=False)
        lr, s_ref = sk_reference_decode_step(eng, tok, s_ref, DecodeState)
        worst = max(worst, float((lg - lr).abs().max()))
        d = (lg - lp).abs()
        plain_worst = max(plain_worst, float(d.max()))
        plain_ok &= bool((d <= torch.clamp(2.0 ** -7 * lp.abs(),
                                           min=TOL)).all())
    del eng._sk_tail
    check(worst == 0.0, f"[phase 16 (b)] the superkernel step with a dense "
          f"tail differs from its oracle: max |dlogit| {worst}")
    check(plain_ok, f"[phase 16 (b)] the superkernel step parts from the "
          f"oracle with the tail's plain path by {plain_worst}")
    tail_steps = tail_mla      # the slot path's (the oracle's tail is its own)
    if dev == "cuda":
        check(tail_steps == [1] * TAIL_STEPS, f"[phase 16 (b)] the tail's "
              f"fused_mla_decode_attention launches a step: {tail_steps}")
    res = {"layers": TAIL_LAYERS, "slots": TAIL_SLOTS, "batch": TAIL_BATCH,
           "steps": TAIL_STEPS, "tail": tail, "bitwise": True,
           "max_abs_dlogit_plain_tail": plain_worst,
           "tail_mla_launches_per_step": tail_steps,
           "path_launches": launches, "replays": eng.stats.replays,
           "evictions": eng.stats.evictions}
    log(f"[phase 16 (b)] ({gpu}) {json.dumps(res)}")
    eng.drop_resident_experts()
    del eng
    gc.collect()
    return res, launches


def mesh_part(torch, np, mm, gpu, dev, smoke, base_train=None):
    """(c) a (1, 1) mesh on one device (NCCL on the card, gloo on the CPU,
    a one-rank group with an in-memory store): olmoe's training of phase
    14 (b) with FSDP against the same steps without a mesh; the EP path
    and its collectives a step; yi-9b's forward on the mesh against
    without it. (d) one pipeline stage on a one-rank ``pod`` mesh against
    the stage function."""
    import torch.distributed as dist
    shd, hlo, moe_mod = mm["shd"], mm["hlo"], mm["moe_mod"]
    mm["mesh"].init_local_group(dev)
    try:
        mesh = mm["mesh"].make_host_mesh()
        res = {"mesh": list(mesh.shape), "backend": dist.get_backend(),
               "gpu": gpu}
        # (c) training, the same params and batches both ways
        cfg = mm["get_smoke_config"]("olmoe-1b-7b") if smoke else \
            cut(mm["get_config"]("olmoe-1b-7b"), TRAIN_DEPTH["olmoe-1b-7b"][0])
        B, T = (2, 32) if smoke else (TRAIN_BATCH, TRAIN_SEQ)
        model = mm["Model"](cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        step = mm["steps"].make_train_step(model, lr=TRAIN_LR, remat=True,
                                           ce_chunk=2048)
        from repro_torch.training.optimizer import adamw_init

        def run(p, meshed):
            o = adamw_init(p)
            losses, times = [], []
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            for i, (toks, labels) in zip(range(TRAIN_STEPS), mm[
                    "token_batches"](cfg.vocab_size, B, T, seed=0)):
                b = {"tokens": torch.from_numpy(toks).long().to(dev),
                     "labels": torch.from_numpy(labels).long().to(dev)}
                if meshed:
                    b = {k: shd.distribute(v, ("data", None))
                         for k, v in b.items()}
                t0 = time.perf_counter()
                if meshed and i == 1:
                    # each MoE call's choice of formulation, read from
                    # `_can_shard_map` as `_moe_mesh` calls it
                    can, taken = moe_mod._can_shard_map, []
                    moe_mod._can_shard_map = \
                        lambda *a: taken.append(can(*a)) or taken[-1]
                    try:
                        with hlo.record() as rec:
                            p, o, m = step(p, o, b)
                            loss = float(m["loss"])
                    finally:
                        moe_mod._can_shard_map = can
                    res["ep_paths_a_step"] = {
                        "shard_map": taken.count(True),
                        "gathered": taken.count(False)}
                    st = hlo.collective_stats(rec)
                    res["collectives_a_step"] = {
                        "count_by_kind": st.count_by_kind,
                        "bytes_by_kind": st.bytes_by_kind}
                else:
                    p, o, m = step(p, o, b)
                    loss = float(m["loss"])
                losses.append(loss)
                times.append(time.perf_counter() - t0)
            mem = torch.cuda.max_memory_allocated() / 1e9 \
                if dev == "cuda" else None
            return losses, 1e3 * statistics.median(times[1:]), mem

        plain = run(params, False)
        with shd.mesh_context(mesh, fsdp=True):
            meshed = run(shd.distribute_params(params, mesh, fsdp=True),
                         True)
        parted = max(abs(a - b) for a, b in zip(plain[0], meshed[0]))
        res["train"] = {
            "arch": cfg.name, "layers": cfg.num_layers, "batch": [B, T],
            "losses_no_mesh": plain[0], "losses_mesh": meshed[0],
            "bitwise": plain[0] == meshed[0], "max_abs_loss_diff": parted,
            "ms_per_step_no_mesh": plain[1], "ms_per_step_mesh": meshed[1],
            "max_memory_allocated_gb_no_mesh": plain[2],
            "max_memory_allocated_gb_mesh": meshed[2],
            "phase_14b": None if base_train is None else {
                k: base_train.get(k) for k in
                ("ms_per_step", "max_memory_allocated_gb", "losses")}}
        log(f"[phase 16 (c)] olmoe training, (1, 1) mesh with FSDP against "
            f"no mesh ({gpu}): {json.dumps(res['train'])}")
        if not res["train"]["bitwise"]:
            log(f"[phase 16 (c)] the losses part by {parted}: not bitwise")
        check(parted <= 1e-3 * abs(plain[0][0]),
              f"[phase 16 (c)] mesh losses {meshed[0]} against {plain[0]}")
        check(res["ep_paths_a_step"]["shard_map"] > 0
              and res["ep_paths_a_step"]["gathered"] == 0,
              f"[phase 16 (c)] the EP path was not taken: "
              f"{res['ep_paths_a_step']}")
        check(moe_mod._can_shard_map(mesh, cfg.moe, B, T, cfg.d_model),
              "[phase 16 (c)] _can_shard_map is false at Tg > 1")
        log(f"[phase 16 (c)] EP path a step {res['ep_paths_a_step']}, "
            f"collectives a step {json.dumps(res['collectives_a_step'])}")
        del params
        gc.collect()
        # yi-9b's forward
        cfg = mm["get_smoke_config"]("yi-9b") if smoke else \
            cut(mm["get_config"]("yi-9b"), MESH_YI_LAYERS)
        model = mm["Model"](cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, MESH_YI_TOKENS)).to(dev)
        with torch.no_grad():
            want = model.forward(params, toks)
            with shd.mesh_context(mesh, fsdp=True):
                got = model.forward(shd.distribute_params(params, mesh, True),
                                    shd.distribute(toks, ("data", None)))
                got = got.full_tensor()
        res["yi_forward"] = {
            "layers": cfg.num_layers, "tokens": list(MESH_YI_TOKENS),
            "bitwise": bool(torch.equal(got, want)),
            "max_abs_diff": float((got.float() - want.float()).abs().max())}
        check(res["yi_forward"]["bitwise"], f"[phase 16 (c)] yi-9b's mesh "
              f"forward differs: {res['yi_forward']}")
        log(f"[phase 16 (c)] yi-9b forward on the mesh: "
            f"{json.dumps(res['yi_forward'])}")
        del params
        gc.collect()
        # (d) one pipeline stage
        from torch.distributed.device_mesh import init_device_mesh
        pmesh = init_device_mesh(dev, (1,), mesh_dim_names=("pod",))
        w = torch.randn(64, 64, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        x = torch.randn(PIPE_MICRO, 8, 64, generator=torch.Generator(
            device=dev).manual_seed(SEED + 1), device=dev)
        stage = lambda p, h: torch.tanh(h @ p)  # noqa: E731
        with hlo.record() as rec:
            y = mm["pipeline_stages"](stage, 1, PIPE_MICRO, "pod",
                                      pmesh)(w, x)
        want = torch.stack([stage(w, x[i]) for i in range(PIPE_MICRO)])
        res["pipeline"] = {
            "stages": 1, "microbatches": PIPE_MICRO,
            "bitwise": bool(torch.equal(y, want)),
            "permutes": hlo.collective_stats(rec).count_by_kind}
        check(res["pipeline"]["bitwise"], "[phase 16 (d)] one pipeline "
              "stage differs from the stage function")
        log(f"[phase 16 (d)] {json.dumps(res['pipeline'])}")
        return res
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, np, gpu, dev="cuda", smoke=False, base_train=None):
    """Phase 16 (see the module docstring). Returns (results, launches of
    its kernel paths)."""
    t_phase = time.perf_counter()
    mm = mesh_mods()
    res = {"gpu": gpu}
    launches = {}
    from repro_torch.kernels import ops
    dsk, sg = mm["dsk"], mm["slot_gather"]
    kern = {"slot_ffn": sg.slot_ffn, "fused_moe_entry": dsk.fused_moe_entry,
            "fused_decode_attention": dsk.fused_decode_attention,
            "fused_mla_decode_attention": dsk.fused_mla_decode_attention,
            "topk_gating": ops.topk, "expert_ffn": ops.expert_ffn}
    assert set(kern) == set(KERNELS)
    for k in kern.values():
        k.launches = 0
    res["legacy"] = legacy_part(torch, np, mm, gpu, dev, smoke)
    launches["phase 16 (a) legacy and fused forwards"] = {
        n: k.launches for n, k in kern.items()}
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    res["tail"], launches["phase 16 (b) superkernel tail"] = tail_part(
        torch, np, mm, gpu, dev, smoke, kern)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    res["mesh"] = mesh_part(torch, np, mm, gpu, dev, smoke, base_train)
    t_dry = time.perf_counter()
    reports = run_dryrun()
    dry = {}
    for cell, r in reports.items():
        check(r.get("status") == "ok",
              f"[phase 16 (e)] dry run {cell}: {r.get('error', r)}")
        roof = r["roofline"]
        dry[cell] = {"peak_gib": r["peak_memory_bytes"] / 2 ** 30,
                     "flops_per_device": r["raw_flops_per_device"],
                     "bytes_per_device": r["raw_bytes_per_device"],
                     "collective_bytes_per_device":
                         r["raw_collective_bytes"],
                     "dominant": roof["dominant"],
                     "run_s": r["compile_seconds"]}
        log(f"[phase 16 (e)] dry run {cell} on a fake 16x16 mesh (host, "
            f"modeled on H100 data-sheet peaks): {json.dumps(dry[cell])}")
    res["dryrun"] = {"cells": dry, "wall_s": time.perf_counter() - t_dry}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase 16] done in {res['phase_s']:.1f} s (the dry run's "
        f"children {res['dryrun']['wall_s']:.1f} s of it)")
    return res, launches


def main(argv) -> int:
    only = None            # --kernels[=a,b]: phases 1-3 only, no result
    disk_only = False      # --disk: phase 1 and the disk probe, no result
    horizon_only = False   # --horizon: phases 1-2, 5's base and 13
    train_only = False     # --train: phases 1-2, 14 and 15
    mesh_only = False      # --mesh: phases 1-2 and 16
    for a in argv:
        if a == "--disk":
            disk_only = True
        elif a == "--horizon":
            horizon_only = True
        elif a == "--train":
            train_only = True
        elif a == "--mesh":
            mesh_only = True
        elif a == "--kernels" or a.startswith("--kernels="):
            only = [n for n in a.partition("=")[2].split(",") if n]
            bad = set(only) - set(KERNELS)
            if bad:
                print(f"chip_smoke: unknown kernels {sorted(bad)}",
                      file=sys.stderr)
                return 2
        else:
            print(f"chip_smoke: unknown argument {a}", file=sys.stderr)
            return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: environment ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if disk_only:
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_disk.json").write_text(json.dumps(
            {"gpu": smi[0], "disk": disk_probe(np)}, indent=1))
        log("--disk: phases 2-12 skipped, no result")
        return 0

    # ---- phase 2: build ------------------------------------------------------
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    floor_build = start_empty_kernel_build(build)
    secs = build.build_all()
    floor_lib = floor_build()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s wall)")
    build_info = build_report(build)
    if mesh_only:
        res, counts = mesh_phase(torch, np, smi[0])
        teardown(torch)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_mesh.json").write_text(json.dumps(
            {"gpu": smi[0], "mesh_phase": res, "launches": counts,
             "total_s": time.perf_counter() - t_start}, indent=1,
            default=str))
        log(f"--mesh: phases 3-15 skipped, no result "
            f"({time.perf_counter() - t_start:.1f} s)")
        return 0
    if train_only:
        res, counts = train_phase(torch, np)
        rec_res, rec_counts = recurrent_phase(torch, np, smi[0])
        teardown(torch)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_train.json").write_text(json.dumps(
            {"gpu": smi[0], "train": res, "launches": counts,
             "recurrent": rec_res, "recurrent_launches": rec_counts,
             "total_s": time.perf_counter() - t_start}, indent=1,
            default=str))
        log(f"--train: phases 3-13 skipped, no result "
            f"({time.perf_counter() - t_start:.1f} s)")
        return 0

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_superkernel as dsk
    from repro_torch.kernels import ops, ref, slot_gather
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.engine import DecodeState, SlotBufferEngine
    from repro_torch.runtime.request import Request
    from repro_torch.runtime.serving import EngineServingConfig, ServingEngine

    # ---- phase 3: kernels against their plain versions ----------------------
    g = torch.Generator(device="cuda").manual_seed(SEED)
    phases = {
        "slot_ffn": lambda: slot_ffn_phase(torch, moe_mod, slot_gather, ref,
                                           g),
        "fused_moe_entry": lambda: moe_entry_phase(torch, dsk, ref, g),
        "fused_decode_attention": lambda: attention_phase(torch, dsk, ref, g),
        "fused_mla_decode_attention": lambda: mla_phase(torch, dsk, ref, g),
        "topk_gating": lambda: topk_phase(torch, ops, ref, g, floor_lib),
        "expert_ffn": lambda: expert_ffn_phase(torch, ops, ref, g)}
    kres = {n: phases[n]() for n in
            ([] if horizon_only else only or KERNELS)}
    log(f"kernels done at {time.perf_counter() - t_start:.1f} s")
    if only is not None:
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_kernels.json").write_text(json.dumps(
            {"gpu": smi[0], "kernels": kres, "build": build_info}, indent=1))
        log("--kernels: phases 4-12 skipped, no result")
        return 0

    # ---- phase 4: the kernel API, the path of topk_gating and expert_ffn ----
    launches = {"kernel API": dict.fromkeys(KERNELS, 0)}
    if not horizon_only:
        api_launches, api_errs = kernel_api_phase(torch, ops, ref, moe_mod,
                                                  g)
        launches["kernel API"].update(api_launches)

    # ---- phases 5-7: serving at published widths, oracles -----------------
    from repro_torch.core.expert_tiers import (TieredExpertStore,
                                               export_expert_shards)
    from repro_torch.core.faults import FaultPlan
    from repro_torch.models import transformer
    mods = dict(get_config=get_config, Model=Model, transformer=transformer,
                TieredExpertStore=TieredExpertStore,
                export_expert_shards=export_expert_shards,
                SlotBufferEngine=SlotBufferEngine, DecodeState=DecodeState,
                Request=Request, ServingEngine=ServingEngine,
                EngineServingConfig=EngineServingConfig, FaultPlan=FaultPlan,
                slot_ffn=slot_gather.slot_ffn,
                fused_moe_entry=dsk.fused_moe_entry,
                fused_decode_attention=dsk.fused_decode_attention,
                fused_mla_decode_attention=dsk.fused_mla_decode_attention,
                topk_gating=ops.topk, expert_ffn=ops.expert_ffn,
                moe_mod=moe_mod)
    mods.update(horizon_mods())
    serving = {}

    def run(tag, **kw):
        serving[tag], launches[tag] = serving_phase(torch, np, mods, **kw)
        release(torch)
        log(f"[{tag}] done at {time.perf_counter() - t_start:.1f} s")

    if horizon_only:
        run("olmoe-1b-7b superkernel monolithic", arch="olmoe-1b-7b",
            superkernel=True, chunk=0)
        res = horizon_phase(torch, np, mods, serving, launches)
        for r in serving.values():
            r.pop("_oracle_rows", None)
        teardown(torch)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_horizon.json").write_text(json.dumps(
            {"gpu": smi[0], "serving": serving, "horizon": res,
             "launches": launches,
             "total_s": time.perf_counter() - t_start}, indent=1,
            default=str))
        log(f"--horizon: phases 3-12 skipped, no result "
            f"({time.perf_counter() - t_start:.1f} s)")
        return 0

    # Runs of one config follow each other (the monolithic runs, their
    # cache-aware runs, then the chunked runs at their cut depth), so that
    # each config's experts are pinned once (`build_engine`).
    for arch in ARCHS:
        depth, why_depth = SERVE_DEPTH.get(arch, (None, ""))
        for superkernel in (False, True):
            path = "superkernel" if superkernel else "unfused"
            run(f"{arch} {path} monolithic", arch=arch,
                superkernel=superkernel, chunk=0, layers=depth,
                why_cut=why_depth)
        # §3.4 cache-aware routing (phase 8): the monolithic runs again at
        # route bias ROUTE_BIAS, each beside its bias-off run of this call
        for superkernel in BIASED[arch]:
            base = f"{arch} {'superkernel' if superkernel else 'unfused'} " \
                   f"monolithic"
            run(f"{base} bias {ROUTE_BIAS}", arch=arch,
                superkernel=superkernel, chunk=0, route_bias=ROUTE_BIAS,
                base=serving[base], layers=depth, why_cut=why_depth)
        for superkernel in (False, True):
            path = "superkernel" if superkernel else "unfused"
            layers, why = CHUNKED_DEPTH.get(arch, (None, ""))
            run(f"{arch} {path} chunked", arch=arch, superkernel=superkernel,
                chunk=CHUNK, layers=layers, why_cut=why,
                mono_outputs=None if layers else
                serving[f"{arch} {path} monolithic"]["outputs"])

    # ---- phase 10: the reference's Qwen MoE configs ------------------------
    for arch, superkernel, chunk in QWEN_RUNS:
        layers, why = QWEN_DEPTH.get(arch, (None, ""))
        path = "superkernel" if superkernel else "unfused"
        run(f"{arch} {path} {'chunked' if chunk else 'monolithic'}",
            arch=arch, superkernel=superkernel, chunk=chunk, layers=layers,
            why_cut=why)

    # ---- phase 11: faults and graceful degradation --------------------------
    fault_runs = faults_phase(torch, np, mods, serving, launches)
    log(f"faults done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 12: the disk tier and expert integrity -----------------------
    tier_runs = tier_phase(torch, np, mods, serving, launches)
    log(f"tier done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 13: the adaptive horizon's knobs, traces, the simulator ----
    horizon_runs = horizon_phase(torch, np, mods, serving, launches)
    log(f"horizon done at {time.perf_counter() - t_start:.1f} s")
    for r in serving.values():
        r.pop("_oracle_rows", None)
    release(torch)

    # ---- phase 14: the plain Model API on the attention-only models, then
    # training; its path's counts set to 0 just before it and read after
    for n in KERNELS:
        mods[n].launches = 0
    train_res, _ = train_phase(torch, np)
    launches["phase 14 model API"] = counters(mods)
    log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 15: the recurrent and encoder-decoder models, then their
    # training; its path's counts set to 0 just before it and read after
    for n in KERNELS:
        mods[n].launches = 0
    rec_res, _ = recurrent_phase(torch, np, smi[0])
    launches["phase 15 recurrent and enc-dec"] = counters(mods)
    log(f"phase 15 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 16: the pre-fused path, the superkernel's dense tail, the
    # mesh, the pipeline and the dry run; each kernel path's counts set to 0
    # just before it and read just after
    mesh_res, mesh_launches = mesh_phase(
        torch, np, smi[0], base_train=train_res.get("train_olmoe"))
    launches.update(mesh_launches)
    log(f"phase 16 done at {time.perf_counter() - t_start:.1f} s")
    teardown(torch)

    src = "src/repro_torch/kernels/csrc/"
    # (kernel, source, TPU kernel it replaces, the shape whose times head
    # its entry). Every run held the kernels off its path to 0 launches, so
    # a kernel's launches summed over all runs are its path runs' launches.
    rows = [("slot_ffn", "slot_ffn.cu", "src/repro/kernels/slot_gather.py:72",
             "decode"),
            ("fused_moe_entry", "fused_moe_entry.cu",
             "src/repro/kernels/decode_superkernel.py:141", "decode"),
            ("fused_decode_attention", "fused_decode_attention.cu",
             "src/repro/kernels/decode_superkernel.py:259", "decode"),
            ("fused_mla_decode_attention", "fused_mla_decode_attention.cu",
             "src/repro/kernels/decode_superkernel.py:344", "decode"),
            ("topk_gating", "topk_gating.cu",
             "src/repro/kernels/topk_gating.py:56", "olmoe_batch"),
            ("expert_ffn", "expert_ffn.cu", "src/repro/kernels/moe_gemm.py:50",
             "olmoe")]
    kernels = {"kernels": []}
    for name, file, replaces, shape in rows:
        r = kres[name][shape]
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": src + file,
            "replaces": replaces,
            "launches": sum(launches[p][name] for p in launches),
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": max(v["max_abs_err"] for v in kres[name].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "build": build_info.get(name),
            "shapes": kres[name]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"gpu": smi[0], "kernels": kernels["kernels"], "serving": serving,
         "faults": fault_runs, "tier": tier_runs, "horizon": horizon_runs,
         "train": train_res, "recurrent": rec_res, "mesh": mesh_res,
         "kernel_api_max_abs_err": api_errs,
         "total_s": time.perf_counter() - t_start}, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    adopt_orphans()
    try:
        rc = main(sys.argv[1:])
    finally:
        left = stop_children()
        if left:
            print(f"chip_smoke: stopped processes it had left running: "
                  f"{left}", file=sys.stderr, flush=True)
    sys.exit(rc)
