#!/usr/bin/env python3
"""Proof on an NVIDIA card that the PyTorch/CUDA port (``src/repro_torch``)
runs its main path through its own kernels, and what those kernels cost.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card at the main
   path's smollm-360m shapes, timed beside its bound and, where one
   PyTorch call computes the same function, that call; ``flash_decode``
   with per-row (B, K) scales, and ``flash_decode_paged`` also held
   bit-identical (``torch.equal``) to ``flash_decode`` on the gathered pool
   (fp and int8, (K,) and (B, K) scales, a shuffled page table, pos at
   m - 1, on a page boundary, mid-page and retired), and row b of a batch
   ``torch.equal`` to the row computed alone; ``flash_attention``'s last
   100 rows of the main-path prefill ``torch.equal`` to a call on those
   rows alone with the prefix moved by the cut; how each scales with
   length: ``flash_decode`` at pos 4000 in a 4096-position cache and
   ``flash_attention`` at B=1, S=2048; ``w8a8_matmul`` and
   ``w4a8_matmul`` (one group of 960 and 20 groups of 128) ``torch.equal``
   at every site for M = 4 (decode), 256 (a chunk) and 2048 (a prefill),
   s_w in bf16 and f32, beside ``torch._int_mm`` (x zero-padded to 32 rows
   at decode; at prefill also on the K-major weight); at M = 4 both int
   matmuls also on bf16 and f32 activations that they quantize while
   staging A (``quant_w8a8_matmul``, ``quant_w4a8_matmul``), held
   ``torch.equal`` to ``act_quant_static`` + the matmul and to the plain
   composition at every site, timed beside that unfused pair; and
   ``act_quant_ptoken`` on bf16 and f32
   input (``torch.equal`` on codes, scales and zero points, with an
   outlier row, and again with an all-zero row planted; timed both ways,
   the kernels line's step from the rows without it); ``act_quant_static``
   at M = 4 and 2048
   beside ``torch.quantize_per_tensor``; both quantizers' time a call also
   over the method's floor, a one-element fill timed first;
   ``flash_attention`` with the live-length mask at the search's scoring
   shape (B=16, S=257, 4 prefix rows, 2 live: one bf16 ulp of the plain
   version, garbage in the dead rows changing nothing) beside SDPA with the
   same boolean mask; ``flash_attention_bwd`` at the tuning shape (B=2,
   S=256, m=4), f32 and bf16, all rows live and rows [1, 4) dead, against
   ``flash_attention_bwd_plain`` (f32 1e-5 of the largest entry, bf16 one
   ulp plus that; dead rows exactly zero; two calls identical), timed
   beside its bound, the kernel's forward + backward and SDPA's forward +
   backward; ``flash_attention``'s non-causal mode at whisper-base's shapes
   (8 heads of 64, bf16): its encoder (B=4, S=T=1500), its cross-attention
   at prefill (S=256 over T=1500) and at decode (S=1), each within one
   bf16 ulp of the plain version, two calls ``torch.equal``, rows 0, S/2
   and S-1 ``torch.equal`` to the row computed alone, timed beside the
   plain version, the bound and SDPA; its backward at the tuning's
   cross-attention shape (B=2, S=256, T=1500) within one ulp plus 1e-5 of
   the largest entry, two calls identical, beside SDPA's forward +
   backward; and ``flash_attention``, ``flash_attention_bwd``,
   ``flash_decode`` and ``flash_decode_paged`` at stablelm-3b's head_dim
   80 (32 heads over 32 KV heads, bf16; B = 4 x 512 behind the 4-row
   cushion; decode at pos 576, int8 with (B, K) scales, the paged pool
   ``torch.equal`` to the contiguous kernel), each within its bar of its
   plain version, timed beside its bound and SDPA (``head_dim_80_rows``;
   ``stablelm_*`` in the kernels line);
4. the static main path at full width: smollm-360m (32 layers, bf16,
   seeded random weights), a 4-token cushion from ``extract_cushion``,
   pt_static scales calibrated on 2 pipeline batches, int8-resident
   weights, int8 KV cache; ``Engine.generate`` for B=4, a 512-token prompt
   and 64 new tokens, its decode step a CUDA graph captured at the warm-up
   request and replayed once per token, with every kernel's launch count
   read around that one request and held to its exact expected value
   (``act_quant_static`` at the prefill's 160 sites,
   ``act_quant_static_fused``, the quantization inside an int matmul at
   M <= 16, at the prefill's head and all 161 sites of every decode step)
   and 63 graph replays; the eager per-token loop (``generate_py``) gives
   the same tokens and launches; two requests give TTFT, TPOT and
   tokens/s quartiles, and the profiler the device time per step of the
   replayed graph and of the eager step, the graph's capture time and node
   count; then the fp path
   (``--quant none``, fp KV), W4A8 (int4-packed weights, the same scales,
   int8 KV; resident int4 bytes exactly half the W8A8 int8 bytes) and
   ``ptoken_dynamic`` (fp KV) the same way; every split-KV merge counter
   and split-K workspace is zero afterwards; then SmoothQuant's fold
   (``apply_smoothquant``, alpha 0.8) from the phase's calibration
   statistics, recalibrated and prequantized, serving B=1 (64-token
   prompt, 8 tokens) in W8A8 with int8 KV, the largest ``mlp_in`` channel
   max lower after the fold than before;
4b. the continuous path at full width, same model, cushion, scales and
   weights, 4 slots, 12 requests queued at once (prompts 512 / 520 tokens,
   budgets 64 / 32): (a) contiguous int8 pool; (b) paged int8 pool (page
   size 64), tokens identical to (a); (c) the static B=1 int8 Engine on the
   first 4 requests, tokens identical to (a); (d) a paged fp pool with the
   prefix cache and 256-token chunks over prompts sharing a 256-token stem,
   with prefix hits, chunks, every budget met and first-token logits within
   phase 5's W8A8 tolerance of a blocking, cache-free run of the same pool;
   (e) a paged int8 pool with W4A8 weights, tokens identical to the static
   B=1 W4A8 Engine on the first 4 requests; (f) a contiguous fp pool under
   ptoken_dynamic, first tokens identical to the static B=1 ptoken Engine
   on all 12 requests. Each pool's decode step is a CUDA graph captured
   when the engine is built. Launch counts are read around each run and
   held exactly, the static quantizer's route counted from each prefill
   call's rows, and one graph replay per step; four more runs of the trace
   give the same tokens and the TPOT and tokens/s quartiles; the counters
   and workspaces are zero afterwards;
4c. the paper's method at full width, same model and weights:
   ``discover`` under pt_dynamic (the KV-reuse ``greedy_search``, 64
   candidates in chunks of 16, a 256-token sample, the prefix padded to 4
   rows, tau 1, seed token 1) and ``extract_cushion``, every accepted token
   within tau of its base L_q and the launches exact; the scores of 4
   candidates behind a 2-token live prefix on a 32-token sample against the
   port's CPU version (``SCORE_RTOL``, argmin agreement printed);
   ``prefix_tune`` for 20 steps (B=2, 256 tokens, lam 0.05, lr 1e-3,
   log_every 10): finite losses, at most 3 host syncs, the cushion moved,
   exactly 32 ``flash_attention`` and 32 ``flash_attention_bwd`` launches a
   step, the step's device ms as quartiles; the gradient into the cushion
   (B=1, 32 tokens) against the CPU's: of CE without fake quant against the
   CPU's bf16 gradient (``GRAD_TOL``), of the tuning loss against the CPU's
   f32 gradient, no farther than the CPU's bf16 one (``GRAD_TUNE_FACTOR``);
   max-activation top-1
   and held-out ppl, greedy -> tuned (printed); pt_static scales
   calibrated under the tuned cushion, the artifact saved through
   ``CheckpointManager`` and reloaded by ``load_cushion_artifact`` (the
   same fingerprint; a W8A8 int8-KV ``Engine`` on it gives the in-memory
   cushion's tokens, B=1, 64-token prompt, 8 tokens; stale scales refused);
4d. the replica router at full width (run after 4c), same model, cushion,
   scales and W8A8 weights, prequantized once and shared by every replica
   (one address per int8 weight tensor in all three engines):
   ``ReplicaRouter`` over 3 replicas x 4 paged int8 slots (page size 64),
   the default ``RouterConfig``, phase 4b's trace extended the same way to
   24 requests at t = 0 (the first 12 are 4b's). A first run with budgets
   of 2 records what each replica's first steps cost. (r0) no fault: all
   24 complete with no retry, failover, death, error or rejection, tokens
   per uid equal to 4b's run (b) for uids 0-11; (r1)
   ``crash@replica1.step:6``: all 24 complete with r0's tokens per uid,
   one death, states [HEALTHY, DEAD, HEALTHY], failovers equal to replica
   1's live requests at its death, retries at least that, and the failover
   time (the death to the completion of the last request moved); (r2)
   ``interrupt@replica0.step:10``: drained, every completed uid with r0's
   tokens, every other uid rejected as ``draining``; (r3) r1's schedule
   over contiguous int8 pools, r0's tokens. After every run: launch counts
   exact (from the replicas' steps and admissions), graph replays equal
   to the replicas' steps, each replica's graph the one captured at
   construction, every merge counter and workspace zero, and no replica
   error or death beyond the injected ones (the router catches a replica's
   exception, as the reference does; this phase refuses it). One round of
   the three replicas' steps is profiled, as a round and replica by
   replica; beside the router, one ``ContinuousEngine`` of 12 slots on
   r0's trace gives r0's tokens per uid and its tokens/s;
4e. the MoE family at full width: olmoe-1b-7b (8 of its 16 layers since
   PR 23, a cut that keeps the whole script in its time; 64 experts,
   top-8, capacity factor 1.25, bf16, seeded random weights), a 4-token
   cushion, pt_static scales from phase 4's 2 calibration batches,
   int8-resident attention and head (the experts stay fp and are
   fake-quantized per call, as in the reference), int8 KV:
   ``Engine.generate`` for B=4, a 512-token prompt and 32 new tokens in
   W8A8 and in fp, the decode step a CUDA graph replayed once per token,
   launch counts exact, graph tokens = the eager loop's, two requests for
   the quartiles; the replayed W8A8 step's device time split into the
   ported kernels (by name in the profile) and the MoE's parts timed alone
   at the step's shapes (the experts' weight fake-quant, the expert
   einsums, the dispatch and combine, the activation fake-quant); every
   ported kernel of the path at olmoe's shapes (head_dim 128) against its
   plain version, timed beside it and its bound (``moe_*`` in the kernels
   line); a paged
   int8 ``ContinuousEngine`` of 4 slots over 8 requests with exact
   launches, every request's tokens = the static B=1 Engine's; a short
   ``discover`` under pt_dynamic (16 candidates, the prefix padded to 4
   rows, 2 seed tokens) and 3 ``prefix_tune`` steps with exact launches;
   the card's teacher-forced logits against the port's CPU version at 2 of
   the layers in fp and W8A8 (``MOE_LOGIT_TOL``); the peak device
   memory and the phase's seconds; the model is released afterwards;
4f. the VLM at full width: internvl2-26b at 8 of its 48 layers (16 until
   PR 23, cut to keep the whole script in its time; d_model
   6144, 48 heads over 8 kv-heads, head_dim 128, vocab 92,553 untied,
   bf16, seeded random weights), 1024 seeded stub patches before the text,
   a 4-token cushion before the patches, pt_static scales from 2 drawn
   batches: ``Engine.generate`` for B=4, [1024 patches; 512 tokens] and
   32 new tokens in W8A8 (int8 KV, int8-resident weights) and fp, the
   decode step a CUDA graph, launch counts exact, graph tokens = the eager
   loop's, two requests for the quartiles; every ported kernel of the
   path at its shapes (G = 6; the head's N = 92,553) against its plain
   version (``vlm_*`` in the kernels line); a paged int8 pool of 4 slots
   over 8 requests that carry patches, launches exact, tokens = the static
   B=1 Engine's; ``discover`` (the KV-reuse search, each candidate between
   the cushion and the patches, 16 candidates, 2 iterations) and 3 tuning
   steps, launches exact; card vs CPU at 2 of the layers (64 patches, 64
   tokens, ``MOE_LOGIT_TOL``); the peak device memory;
4g. the Jamba hybrid at full width, one period: jamba-v0.1-52b at 8 of its
   32 layers (attention at 3, Mamba at the other seven, 16 experts top-2
   on the odd layers, d_model 4096, G = 4, bf16, seeded random weights),
   a cushion of KV and Mamba state: the static Engine for B=4, 512 tokens
   and 16 new tokens in W8A8 and fp as in 4f; the Mamba scan's device and
   wall ms and its kernel count at the prefill's shape (the reference's
   associative scan, ``models/ssm.py``); the kernels at its shapes (``hybrid_*``;
   mamba_out's K = 8192); a contiguous and a paged int8 pool over 8
   requests, tokens = the static B=1 Engine's; ``discover`` through
   ``greedy_search_ref`` (no KV-reuse scoring for a recurrence; 16
   candidates, 2 iterations) and 3 tuning steps, launches exact, the
   cushion's Mamba state bit-identical after tuning; card vs CPU on a
   two-layer period of full width (a Mamba layer with its dense MLP, the
   attention layer with its MoE); the peak device memory;
4h. the encoder-decoder at full width and depth: whisper-base (6 encoder
   and 6 decoder layers, d_model 512, 8 heads of 64, vocab 51,865 untied,
   1500 seeded stub frames a request, bf16, seeded random weights), a
   4-token cushion (the decoder's self-attention KV, extracted under zero
   frames): ``Engine.generate`` for B=4, [1500 frames; 256 tokens] and 32
   new tokens in fp and in W8A8 as the reference serves it (pt_dynamic
   with true int8: the int matmul at every site, the weights quantized a
   call), launches exact (the encoder's and the cross-attention's
   non-causal ``flash_attention``, at decode too, inside the graph),
   graph tokens = the eager loop's; an Engine under pt_static refused
   (the reference's head takes no scales there); the int matmul and
   ``flash_decode`` (fp KV, G=1) at its shapes (``encdec_*``); 4
   contiguous fp slots over 8 requests, each with its own frames, tokens
   = the static B=1 Engine's; ``discover`` through ``greedy_search_ref``
   (16 candidates, 2 iterations) and 3 tuning steps (B=2, 256 tokens)
   with exact forward and backward launches, causal and non-causal; card
   vs CPU at 2 encoder + 2 decoder layers (``FAM_LOGIT_TOL``); phase
   4k's one-rank side of its static requests and its pool;
4i. the xLSTM at full width and depth: xlstm-350m (12 mLSTM / sLSTM
   pairs, d_model 1024, 4 heads of 512, inner 2048, vocab 50,304, bf16,
   seeded random weights), a seeded CushionState (the state after 4
   token ids): ``Engine.generate`` for B=4, 512 tokens and 32 new tokens
   in W8A8 (pt_static, ``w_proj`` int8-resident, ``m_in`` / ``s_in``
   quantized a call, as the reference's key list leaves them) and fp,
   launches exact; the sLSTM and mLSTM blocks at the prefill's shape
   (device ms, wall ms, kernels a sublayer); the int matmul at its sites
   (``xlstm_*``); 4 contiguous W8A8 slots over 8 requests (the state tree
   scattered along its nested axes), tokens = the static B=1 Engine's;
   ``greedy_search_ref`` over 64-token samples and 3 tuning steps (B=2,
   64 tokens) that move every leaf of the state tree; card vs CPU at one
   pair; phase 4k's one-rank side of its static requests and its pool;
4j. one-card training at full width and depth: smollm-360m (32 layers,
   bf16, seeded random weights made on the card) through
   ``launch/train.py`` ``main`` at the launcher's defaults (B=8 x 256, lr
   1e-3, warmup 10, remat on, ``--quant none``) for 21 steps on phase 4's
   corpus: the held-out loss falling (the launcher's eval batches under
   the initial and the trained weights), the logged losses finite, exact
   launches (``flash_attention`` twice a layer a step, the recompute, and
   once a layer for each eval batch; ``flash_attention_bwd`` once a layer
   a step), the host syncs the log's only, ms a step from CUDA events,
   tokens trained a second, the peak device memory, the final 4.4 GB
   checkpoint; the train step alone on staged batches (ms a step, zero
   host syncs, CUDA's synchronizing calls in a step counted, the
   profiler's device ms and busy share); ``flash_attention`` and its
   backward at the training shape (no cushion, B=8, S=256, G=3) against
   their plain versions, timed beside their bounds and SDPA (``train_*``
   in the kernels line); 6 steps each under pt_dynamic and ptoken_dynamic
   (``act_quant_ptoken`` launches exact), 6 with ``microbatches=2``
   against 1, a step at B=1 x 2048; 12 straight launcher steps against 6,
   saved, and 6 resumed, bit for bit, at 2 of the layers at full width;
   one step on the card against the port's CPU step: smollm at 2 layers in
   f32 and bf16, and each other family at its reduced size in f32;
4k. tensor-parallel serving: deepseek-67b at full width (d_model 8192,
   64 heads, 8 KV heads of 128, d_ff 22016, vocab 102400, bf16, seeded
   random weights) cut to 4 of its 95 layers, a 4-token cushion, scales
   calibrated on 2 batches of 4 x 512; served by one rank in this process,
   then by two ranks (``launch/mesh.spawn_tp``: gloo on one card, NCCL
   where every rank has a card, which then runs as well) that each make
   the same weights from the seed and keep their shard: the static
   ``Engine`` in W8A8 with int8-resident weights and an int8 KV cache (B =
   4 x 512, 32 greedy tokens: both ranks' prefill logits and tokens equal
   one rank's, bit for bit) and in fp (a row's tokens may part only at a
   near tie, ``TP_FP_TIE``), and a paged int8 W8A8 ``ContinuousEngine`` of 4
   slots over 8 requests (tokens and admissions equal); every rank's
   launches of every kernel equal to one rank's, the cushion block whole
   and bit-identical on every rank; TTFT / TPOT, the backend and the peak
   memory of each run; in the same spawn W4A8 (int4-resident, int8 KV),
   ``pt_dynamic`` and ``ptoken_dynamic`` as ``serve.py`` serves them (the
   dynamic ones 16 tokens, ``TP_DYN_NEW``),
   tokens equal to one rank's up to near ties (``TP_FP_TIE``), the prefill
   logits' largest difference printed, launches a rank one rank's with the
   row-parallel sites' modes counted by name (``w4a8_matmul_acc``,
   ``act_quant_ptoken_range`` / ``_given``); ``w8a8_matmul``'s int32 mode
   (the row-parallel sites' accumulators) ``torch.equal`` to its plain
   version at the shards' shapes, two K-halves summed with the epilogue
   applied once equal to the whole launch, timed beside the bf16 epilogue
   launch; ``w4a8_matmul``'s f32 accumulator mode and ``act_quant_ptoken``'s
   range-only and given-range modes at the same shards ``torch.equal`` to
   their plain versions, a row's two halves given their joint range equal
   to the whole row, two K-halves' W4A8 accumulators with the epilogue
   within the W4A8 bar of the whole launch, each timed beside its bound;
   in the same spawn the families at full width against phases 4e-4i's
   one-rank engines: olmoe-1b-7b, internvl2-26b and jamba-v0.1-52b,
   whisper-base (6 + 6 layers: heads, d_ff cut; the
   cross-attention's ``wq`` / ``wkv`` read by the rank's columns; W8A8 as
   pt_dynamic with true int8, and fp) and xlstm-350m (24 layers: the
   vocabulary and the mLSTM memory's values cut; W8A8 with int8-resident
   ``w_proj``, and fp), each static at B = 4 and through its pool (a
   contiguous one of 4 slots over 8 requests for whisper and xlstm):
   tokens equal to one rank's up to near ties (``TP_FAM_TIE``; whether
   W8A8 was one rank's bit for bit is printed), launches a rank one
   rank's, the cushion as each rank holds it (its heads of the KV, its
   value slice of the xLSTM's ``C``); the kernels at the families' rank
   shapes against their plain versions (whisper: the non-causal
   ``flash_attention`` of the encoder, the cross-attention's prefill and
   decode and ``flash_decode`` on 4 heads of 64, ``w8a8_matmul``'s int32
   mode at the ``xattn/wo`` shard);
4l. data parallelism over a (data, tp) rank mesh: smollm-360m at full
   width and depth on two gloo ranks of the one card
   (``launch/mesh.spawn_mesh``; they time-slice the card through the
   host: not data parallelism's speed). (d) The user's path, each stage
   timed: ``launch/train.py`` 2 steps (its 4.4 GB checkpoint), ``tune.py
   --dp 2 --ckpt-dir`` (B = 4 x 256, 20 pt_dynamic steps, a search of 2
   tokens over 16 candidates, ``--with-scales``), ``serve.py --ckpt-dir
   --cushion`` (W8A8, int8 KV) on one rank: tokens in range, the
   checkpoint's sha256 verified at every restore. (b) Its tuning against
   ``tune.py --dp 1`` on the same checkpoint: the prefix ids equal, every
   rank's cushion equal after every step (the log's ``ranks_equal``) and
   its fingerprint, each rank's ``flash_attention`` / ``flash_attention_bwd``
   launches 32 / 32 a step as one rank's, the logs within ``DP_CE_TOL`` /
   ``DP_SQ_TOL``, the first step's gradient (the rank program
   ``tests/_dp_probe.py``, dp 2 against rank 0 alone) within
   ``GRAD_TOL``, the tuned cushions' mean difference below
   ``DP_MOVE_SHARE`` of dp 1's move and a planted fault's above it
   (``tune.py --dp 1 --batch 2``: rank 1's rows dropped); ms a step and
   peak GiB a rank, the phase's seconds by stage and by case. (c)
   ``shard_train_step`` (FSDP, remat) at B = 8 x 256, 4 steps of phase 4j's batches, against
   rank 0's one-rank ``make_train_step``: the metrics equal on both
   ranks, launches 64 / 32 a step a rank, each leaf's shard and f32
   moments by its spec, the losses within ``DP_LOSS0_TOL`` /
   ``DP_LOSS_TOL`` and the two runs' first moments within ``GRAD_TOL``; ms a
   step, peak GiB, a step profiled on rank 0. (a) ``compressed_psum`` of
   2.46 M values and ``dp_train_step_compressed``: every rank equal,
   within ``amax / 127 + 1e-6`` of the exact mean. (e) Tensor-parallel
   training in the same two processes as one (data 1, model 2) mesh:
   qwen1.5-0.5b at full width and depth (24 layers, QKV bias, a tied
   vocabulary of 151,936 cut in two), ``shard_train_step`` at B = 4 x 256
   for 3 steps under none and pt_dynamic against rank 0's
   ``make_train_step`` on the whole tree and the same batches: the ranks'
   metrics and whole leaves equal bit for bit, the first step's loss
   within ``TPT_LOSS_TOL`` and gradient norm within ``TPT_GNORM_TOL`` of
   one rank's, the attention kernels' launches a rank a step one rank's;
   ms a step, gloo all-reduces a step, peak GiB and resident parameter and
   moment bytes a rank beside one rank's (``tp_train_*`` in the kernels
   line). (f) The same for the families without experts beside the dense
   one, in the same two processes: whisper-base whole (B = 4 x 256 over
   1,500 frames), xlstm-350m whole (B = 4 x 256) and internvl2-26b at
   full width and 2 of its 48 layers (B = 2, 1,024 patches + 256 tokens;
   its one-rank side run first on rank 0 and freed), each held as (e)
   (the attention launches a step: whisper's encoder, decoder and
   cross-attention, none in the xLSTM), with ``tp_train_<arch>_*`` in the
   kernels line; ``prefix_tune(mesh=)`` of xlstm-350m for 3 steps
   (``ranks_equal`` 1 at every step, the first step's loss within
   ``TPT_LOSS_TOL`` of rank 0's one-rank tuning); the attention kernels
   at a rank's shapes, forward and backward, against their plain
   versions (whisper's 4 heads of 64 over 1,500 frames, internvl2's 24
   query heads over 4 KV heads of head_dim 128);
4m. the router over tensor-parallel replicas: smollm-360m whole on four
   gloo ranks of the card, 2 replicas of tp = 2
   (``launch/mesh.spawn_mesh(data=2, tp=2)``, ``make_replica_meshes``; the
   15 heads whole on every rank, d_ff and the vocabulary cut), W8A8
   int8-resident, paged int8 pools of 4 slots a replica, phase 4d's
   cushion and scales and the first 12 requests of its trace, with
   ``crash@replica1.step:48`` (phase 4d holds the router without
   faults): every request completed with
   phase 4d's tokens, every rank's ``RouterStats`` the same, the crash one
   death with its live requests failed over, each rank's launches those
   of its replica's admissions and steps; TTFT / TPOT p50, each rank's
   wall split (its replica's steps, prefills, the rest) and peak GiB;
4o. stablelm-3b (head_dim 80) at full width and 4 of its 32 layers (run
   after 4e), seeded random weights, a 4-token cushion, scales calibrated
   on 2 batches of 4 x 512: ``Engine.generate`` for B = 4, a 512-token
   prompt and 64 new tokens in W8A8 (int8-resident weights, int8 KV) and
   fp, the decode step a CUDA graph replayed once per token, launch
   counts exact, graph tokens = the eager loop's;
4n. the dry-run accounting (``launch/dryrun.py``), run right after phase
   4 on its W8A8 engine (int8-resident weights, int8 KV cache, the
   4-token cushion, its pt_static scales): the prefill (B = 4, 512 tokens)
   and one decode step on meta tensors, then the same two calls through
   ``api.prefill`` / ``api.decode_step`` on the card. Each kernel's
   launches (the fused counts too) equal ``_lib.LAUNCHES`` around the
   card's call, the argument bytes (parameters, cache, inputs, cushion,
   scales) equal the card's, and the predicted peak (arguments + the meta
   run's temp bytes) lies within ``DRYRUN_PEAK_TOL`` of the card's
   (arguments + the rise of ``max_memory_allocated``); both peaks, the
   FLOPs, bytes, roofline time and the card's time of the call are
   printed;
5. the card's Engine against the port's CPU Engine on the same weights,
   scales and cushion (B=1, 64-token prompt, 8 tokens) in all four phase-4
   modes: teacher-forced logits within the stated bf16 tolerance,
   greedy-token agreement printed;
6. the ``kernels`` line (all eight kernels; launches from the continuous
   runs (a) and (b) of phase 4b, from (e) for ``w4a8_matmul``, from the
   static ptoken run for ``act_quant_ptoken`` and from phase 4c's tuning
   for ``flash_attention_bwd``; ``act_quant_static`` timed over a prefill,
   where it runs, with its fused cost at decode beside; the router runs'
   launches of phase 4d beside, as ``router_launches``, and phases 4e-4i's,
   as ``moe_launches``, ``vlm_launches``, ``hybrid_launches``,
   ``encdec_launches``, ``xlstm_launches``, from phase 4j's launcher
   run, ``train_launches``, from phase 4k's rank 0, ``tp_launches``,
   from a rank of phase 4l's ``tune.py --dp 2``, ``dp_launches``, and
   from phase 4m's four ranks, ``router_tp_launches``,
   with each kernel's row at those phases' shapes; the non-causal rows under ``noncausal``), then
   ``{"ok": true, ...}`` as the last line.

Exits nonzero with no result line when CUDA is unavailable or when the port
is missing (the script alone, outside a checkout). Writes the full record to
``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12          # CUDA cores, no tensor core

ARCH = "smollm-360m"
B, PROMPT, NEW_TOKENS, CUSHION = 4, 512, 64, 4
# the runs of each static request and continuous trace beside the first,
# for the quartiles (phases 4, 4b, 4e-4i): 1 since phase 4l came, 4 before
REPEATS = 1
# phase 4c, the method: the search (launch/tune.py's pt_dynamic, chunks of
# 16 candidates, a 256-token sample, the prefix padded to 4 rows) and the
# tuning (B = 2, 256 tokens, 20 steps)
MAX_PREFIX, N_CANDIDATES, SEARCH_CHUNK, SAMPLE_LEN = 4, 64, 16, 256
TUNE_B, TUNE_S, TUNE_STEPS, TUNE_LOG_EVERY = 2, 256, 20, 10
BF16_ULP = 2.0 ** -7             # relative spacing bound of bf16
# phase 5: card vs CPU logits after 32 bf16 layers. Both sides round
# activations to bf16 at the same points but reduce in other orders (norms,
# attention, RoPE's sin/cos), so a value can land one bf16 ulp apart; under
# W8A8 an activation's int8 code then flips by one step (the site's range
# / 255), a far larger jump, and both kinds of difference grow through the
# 32 random-weight layers. A fault (a wrong scale, mask or position) moves
# every logit by O(1), so the mean error is bounded as well as the largest.
# W4A8 takes W8A8's bound: its matmul is bit-identical between the kernel
# and the CPU's plain version on the same codes, so the only sources are
# W8A8's (activation codes that flip on a one-ulp difference). ptoken takes
# it too: a one-ulp difference flips a code by one step of its row's range
# / 255 (or moves the row's range when it hits the row's extreme), a step
# no larger than the per-tensor one of W8A8; the weights are fake-quantized
# by the same tensor ops on both sides.
# mode: (largest |card - cpu|, mean |card - cpu|)
LOGIT_TOL = {"fp": (0.25, 0.05), "w8a8_int8kv": (0.5, 0.1),
             "w4a8_int8kv": (0.5, 0.1), "ptoken_fp": (0.5, 0.1)}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    if CPU_HALVES is not None:
        CPU_HALVES.close(kill=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# The CPU halves of the card-vs-CPU checks (phases 4e-4i and 5) run in one
# worker process started at the script's start, beside the card phases. A
# check's card half runs in its phase; its CPU half is queued (its inputs,
# CPU copies, written to a file under a temporary directory by a thread of
# this process, so the phase goes on) and the comparison, with its
# tolerances as before, is made when the script joins the queue, before
# phase 5's. The worker takes half the host's cores, so the host-bound card
# phases keep the rest.

CPU_HALVES = None


def _cpu_worker_init(threads: int) -> None:
    """The worker yields the host's cores to the card phases' host work
    (its own priority lowered) and takes ``threads`` of them."""
    import torch
    os.nice(10)
    torch.set_num_threads(threads)


class CpuHalves:
    """The worker, the queued CPU halves ({label: the thread that saves
    the inputs and waits for the worker, its result box}) and the
    comparisons to make at the join."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        import tempfile
        self.threads = max(1, (os.cpu_count() or 2) // 2)
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(self.threads,))
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        self.jobs = {}
        self.pending = []
        self.seconds = {}

    def submit(self, label, fn, payload):
        """Queue ``fn(path)`` on the worker, ``path`` a file holding
        ``payload`` (``torch.save``): a thread writes the file, hands the
        job to the worker and ends, dropping the payload."""
        import threading
        import torch
        box, held = {}, [payload]
        path = os.path.join(self.dir, f"{len(self.jobs)}.pt")

        def run():
            try:
                t0 = time.perf_counter()
                torch.save(held.pop(), path)
                box["save_s"] = time.perf_counter() - t0
                box["future"] = self.pool.submit(fn, path)
            except Exception as e:          # reported by result()
                box["error"] = e
        th = threading.Thread(target=run, daemon=True)
        th.start()
        self.jobs[label] = (th, box, time.perf_counter())

    def result(self, label):
        th, box, t_sub = self.jobs[label]
        t0 = time.perf_counter()
        th.join()
        try:
            if "error" in box:
                raise box["error"]
            out = box["future"].result()
        except Exception as e:
            fail(f"the CPU half of {label} failed: {e!r}")
        self.seconds[label] = {"waited_s": time.perf_counter() - t0,
                               "save_s": box["save_s"],
                               "queued_to_joined_s": time.perf_counter()
                               - t_sub}
        return out

    def later(self, compare):
        """A comparison to make at the join."""
        self.pending.append(compare)

    def join(self):
        """Make every queued comparison, in order."""
        while self.pending:
            self.pending.pop(0)()

    def close(self, kill=False):
        import shutil
        if kill:
            for proc in list(getattr(self.pool, "_processes", {}).values()):
                proc.terminate()
        self.pool.shutdown(wait=not kill, cancel_futures=True)
        shutil.rmtree(self.dir, ignore_errors=True)


def family_trajectory(a, p, qcfg, kv, sc, cush, pre, prompt, gen_toks,
                      routing):
    """Teacher-forced logits of ``a``'s model along ``gen_toks`` (B = 1):
    the prefill of ``prompt``, then a decode step per token; the experts
    picked at the prefill's MoE layers appended to ``routing``."""
    import torch
    from repro_torch.core import quantization as TQ
    from repro_torch.models import moe as MO
    with torch.inference_mode():
        prm = TQ.prequantize_tree(p.tree(), qcfg) if pre else p.tree()
        cache = a.init_cache(1, 256, kv_dtype=kv, prefix_len=CUSHION)
        inner = MO.route

        def recording(x, router, k):
            out = inner(x, router, k)
            routing.append(out[2].cpu())
            return out
        MO.route = recording
        try:
            lg, cache, pos = a.prefill(
                prm, {k: v.to(a.device) for k, v in prompt.items()},
                cache, qcfg, cushion=cush, scales=sc)
        finally:
            MO.route = inner
        out = [lg[:, -1].float().cpu()]
        for n in range(gen_toks.shape[1] - 1):
            tok = torch.as_tensor(gen_toks[:, n], dtype=torch.int32,
                                  device=a.device)
            lg, cache = a.decode_step(prm, tok, pos + n, cache, qcfg,
                                      scales=sc)
            out.append(lg.float().cpu())
        return torch.stack(out)


def cpu_family_half(path):
    """The worker: ``family_trajectory`` on the CPU for each mode of a
    family's card-vs-CPU check. Returns {label: (logits, routing)} as
    numpy arrays."""
    import torch
    from repro_torch.models.common import ParamTree
    from repro_torch.models.registry import build
    job = torch.load(path, weights_only=False)
    os.remove(path)
    api, p = build(job["cfg"], "cpu"), ParamTree(job["params"])
    out = {}
    for label, (qcfg, kv, pre, toks) in job["modes"].items():
        routing = []
        lp = family_trajectory(api, p, qcfg, kv,
                               job["scales"] if pre else None,
                               job["cushion"], pre, job["prompt"], toks,
                               routing)
        out[label] = (lp.numpy(), [r.numpy() for r in routing])
    return out


def cushion_grad(a, p, cush, b, qcfg, lam):
    """Phase 4c: the gradient into the cushion's KV of CE + ``lam`` x the
    activation range penalty, flattened, f32 on the CPU."""
    import torch
    from repro_torch.core import outliers as OUT
    c = {"kv": {k: t.detach().clone().requires_grad_()
                for k, t in cush["kv"].items()}}
    with torch.enable_grad():
        _, aux = a.loss_fn(p, b, qcfg, cushion=c, collect=True)
        loss = aux["ce"] + lam * OUT.activation_range_penalty(aux["taps"])
        g = torch.autograd.grad(loss, [c["kv"]["k"], c["kv"]["v"]])
    return torch.cat([x.float().cpu().reshape(-1) for x in g])


def method_scores(a, p, pad, cands, tokens, qcfg):
    """Phase 4c: the search's candidate scores and base L_q of a padded
    two-token prefix on ``a``'s device."""
    import torch
    d = a.device
    with torch.no_grad():
        pkv = a.prefix_kv(p, pad.to(d), qcfg)
        b = {"tokens": tokens.to(d)}
        return (a.score_candidates(p, pkv, 2, cands.to(d), b,
                                   qcfg).float().cpu().numpy(),
                float(a.prefix_qerr(p, pkv, 2, b, qcfg)))


def cpu_method_half(path):
    """The worker, phase 4c: the scores on the CPU in bf16, and the
    gradients into the cushion in bf16 and in f32 (CE under ``none``, the
    tuning loss under pt_dynamic)."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import QuantConfig
    from repro_torch.models.common import ParamTree
    from repro_torch.models.registry import build
    job = torch.load(path, weights_only=False)
    os.remove(path)
    cfg, qdyn, lam = job["cfg"], job["qdyn"], job["lam"]
    api, params = build(cfg, "cpu"), ParamTree(job["params"])
    out = {"scores": method_scores(api, params, job["pad"], job["cands"],
                                   job["s32"], qdyn)}
    gb, greedy, qnone = job["gb"], job["greedy"], QuantConfig()
    out["ce"] = cushion_grad(api, params, greedy, gb, qnone, 0.0)
    out["tune"] = cushion_grad(api, params, greedy, gb, qdyn, lam)

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return t.float() if t.is_floating_point() else t
    api32 = build(dc.replace(cfg, dtype="float32"), "cpu")
    p32 = ParamTree(f32(job["params"]))
    out["ce_ref"] = cushion_grad(api32, p32, f32(greedy), gb, qnone, 0.0)
    out["tune_ref"] = cushion_grad(api32, p32, f32(greedy), gb, qdyn, lam)
    return {k: (v if k == "scores" else v.numpy()) for k, v in out.items()}


def train_first_moments(api_, params, batch, dtype_cfg):
    """Phase 4j: AdamW's first moments (CPU f32 leaves) and the loss of one
    training step of ``api_``'s model from ``params`` on ``batch``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import make_optimizer, make_train_step
    r = RunConfig(model=dtype_cfg, seq_len=64, global_batch=2, lr=1e-3,
                  train_steps=TRAIN_STEPS, warmup_steps=10)
    opt_ = make_optimizer(r)
    _, s_, m_ = make_train_step(api_, r, opt_)(params, opt_.init(params),
                                               batch)
    return [t.float().cpu() for t in tree_leaves(s_.mu)], float(m_["loss"])


def cpu_train_half(path):
    """The worker, phase 4j: one training step on the CPU of each
    {label: (config, batch)}, from the CPU generator's seed 0 (the weights
    the card's side copies). Returns {label: (first moments, loss)} as
    numpy arrays."""
    import torch
    from repro_torch.models.registry import build
    job = torch.load(path, weights_only=False)
    os.remove(path)
    out = {}
    for label, (c, b) in job.items():
        api_ = build(c, "cpu")
        cp = api_.init_params(torch.Generator().manual_seed(0)).tree()
        mu, loss = train_first_moments(api_, cp, b, c)
        out[label] = ([t.numpy() for t in mu], loss)
    return out


def engine_trajectory(eng, tokens, gen_toks):
    """Phase 5: teacher-forced logits of an engine's model along
    ``gen_toks`` (B = 1), its prefill of ``tokens`` and a decode step per
    token."""
    import torch
    with torch.inference_mode():
        api_ = eng.api
        cache = api_.init_cache(1, eng.max_seq, kv_dtype=eng.kv_dtype,
                                prefix_len=eng.prefix_len)
        p = eng.params.tree()
        lg, cache, pos_ = api_.prefill(p, {"tokens": tokens}, cache,
                                       eng.qcfg, cushion=eng.cushion,
                                       scales=eng.scales)
        out = [lg[:, -1].float().cpu()]
        for n in range(gen_toks.shape[1] - 1):
            tok = torch.as_tensor(gen_toks[:, n], dtype=torch.int32,
                                  device=api_.device)
            lg, cache = api_.decode_step(p, tok, pos_ + n, cache, eng.qcfg,
                                         scales=eng.scales)
            out.append(lg.float().cpu())
        return torch.stack(out)


def cpu_engine_half(path):
    """The worker, phase 5: the port's CPU engine on the card's weights in
    each mode, its greedy tokens and its logits along the card's. Returns
    {label: (logits, tokens)} as numpy arrays."""
    import torch
    from repro_torch.models.common import ParamTree
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Engine
    job = torch.load(path, weights_only=False)
    os.remove(path)
    api, params = build(job["cfg"], "cpu"), ParamTree(job["params"])
    b1 = job["tokens"]
    out = {}
    for label, (qcfg, kv, pre, wb, scales, card_toks) in job["modes"].items():
        eng = Engine(api, params, qcfg, cushion=job["cushion"],
                     scales=scales, max_seq=128, kv_dtype=kv, prequant=pre,
                     weight_bits=wb)
        toks = eng.generate({"tokens": b1}, job["n_cmp"]).tokens
        lp = engine_trajectory(eng, b1, card_toks)
        out[label] = (lp.numpy(), toks)
    return out


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound_ms(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_events(prof):
    """The trace's device events as (name, us), read from the profiler's
    raw results: its ``events()`` list builds every CPU op's tree in
    Python, seconds a trace of tens of thousands of events, for nothing
    read here."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def trace_device_ms(prof, steps=1):
    """(device ms, kernels) a step in the trace."""
    ev = device_events(prof)
    return sum(us for _, us in ev) / 1e3 / steps, len(ev) / steps


def by_kernel(prof, steps, top=10):
    """The profiler's device time per step by kernel name, the largest
    first (``top`` of them; None: all): {name: [calls per step, ms per
    step]}."""
    by = {}
    for name, us0 in device_events(prof):
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + us0)
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
    return {k: [n / steps, us / 1e3 / steps] for k, (n, us) in rows}


def quartiles(**metrics):
    """[p25, p50, p75] of each metric over repeated runs, and the number
    of runs."""
    import numpy as np
    out = {k: [float(x) for x in np.percentile(v, [25, 50, 75])]
           for k, v in metrics.items()}
    out["runs"] = len(next(iter(metrics.values())))
    return out


def device_ms(fn, flush_buf, iters=10) -> float:
    """Mean device ms of fn, the L2 flushed (by zeroing ``flush_buf``, a
    buffer larger than the L2) before every call: the serving path finds
    weights and caches cold. The card sleeps while the host enqueues every
    call, so each event pair brackets device time only, not the host's
    launch latency."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(4e8))       # ~0.2 s at 1.98 GHz
    for a, b in evs:
        flush_buf.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


# phase 4c's tolerances. Card vs CPU, both bf16 at full width: the sides
# round activations to bf16 at the same points but reduce in other orders,
# so values land one bf16 ulp apart and drift through the 32 layers (phase
# 5's fp logits differ by up to LOGIT_TOL["fp"]); a tensor's range moves
# with the drift, and L_q grows with the range squared; under pt_dynamic a
# one-ulp difference at a tensor's extreme or at a rounding tie moves its
# range and every code of it (on f32 paper_tiny, where no bf16 drift
# exists, card and CPU scores differ by 1e-2: tests/test_torch_cuda.py). So
# the scores are held within 0.1 relative; the kernels' own function is
# held tightly in phase 3 and the scoring semantics in the CPU tests
# against JAX.
SCORE_RTOL = 0.1
# The gradient into the cushion. Of the smooth part, CE without fake quant:
# each bf16 rounding is ~2^-9 relative, and ~100 of them on a path through
# 32 layers of attention and MLP add up to a few percent, so card and CPU
# within 0.1 in L2 with a cosine of at least 0.99 (a wrong mask, head or
# broadcast sum gives an unrelated direction). Of the tuning loss itself
# (pt_dynamic, CE + 0.05 range) no such bound holds: the range term reaches
# the cushion only through each site's arg-max element, and pt_dynamic's
# codes flip on one-ulp differences, so bf16 rounding alone can route it
# elsewhere. It is held to the CPU's f32 gradient: the card no farther from
# it than the CPU's bf16 gradient, within a factor GRAD_TUNE_FACTOR in L2
# (the two bf16 errors are of one size but independent). Both sides'
# distances from the f32 gradient are recorded.
GRAD_TOL = (0.1, 0.99)
GRAD_TUNE_FACTOR = 1.5


def method_phase(api, params, cfg, corpus, calib, batch, dev, qw8):
    """Phase 4c: the paper's method at full width (smollm-360m, the phase-4
    weights): ``discover`` under pt_dynamic, its scores against the CPU's,
    ``prefix_tune`` with exact kernel launches and bounded host syncs, its
    gradient against the CPU's, pt_static scales under the tuned cushion,
    the artifact saved and served back. Returns the record."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import monitoring as MON
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.configs import CushionConfig, QuantConfig
    from repro_torch.core import cushioncache as CC
    from repro_torch.core.calibration import calibrate_tagged, scales_to_plain
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import load_cushion_artifact, to_device
    from repro_torch.launch.tune import _quality
    from repro_torch.serving.engine import Engine

    L, V = cfg.n_layers, cfg.vocab_size
    rec = {}

    def profiled(fn, steps, what):
        """fn (``steps`` steps of work) under the profiler: wall ms a step
        (host clock, ending in a sync), the kernels' device ms a step, their
        share of the wall, and the largest kernels."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        busy, n = trace_device_ms(prof, steps)
        out = {"wall_ms": wall, "device_ms": busy,
               "busy_share": busy / wall, "kernels": n,
               "by_kernel": by_kernel(prof, steps, top=8),
               "backward_by_kernel": {
                   k: v for k, v in by_kernel(prof, steps, top=None).items()
                   if "attn_bwd" in k}}
        bwd = ", ".join(
            f"{re.search(r'attn_bwd_[a-z0-9_]+', k).group(0)} {v[1]:.3f} ms "
            f"({v[0]:.0f} calls)" for k, v in out["backward_by_kernel"].items())
        log(f"profiled {what}: wall {wall:.1f} ms, device {busy:.1f} ms "
            f"(busy {busy / wall:.2f}), {n:.0f} kernels"
            + (f"; the backward's kernels a step: {bwd}" if bwd else ""))
        return out
    qdyn = QuantConfig(mode="pt_dynamic")
    ccfg = CushionConfig(max_prefix_len=MAX_PREFIX, tau=1.0,
                         sample_len=SAMPLE_LEN, n_candidates=N_CANDIDATES,
                         seed_tokens=(1,), lam=0.05, tune_steps=TUNE_STEPS,
                         tune_lr=1e-3, log_every=TUNE_LOG_EVERY)
    zero = {k: 0 for k in _lib.LAUNCHES}

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.detach().cpu()

    # launch/tune.py's batches (its seeds), staged on the card before the
    # runs: the search's samples, the tuning and the eval batches
    sample_pipe = Pipeline(corpus, batch=1, seq_len=SAMPLE_LEN, seed=1)
    tune_pipe = Pipeline(corpus, batch=TUNE_B, seq_len=TUNE_S, seed=2)
    samples = [to_device(sample_pipe.get_batch(i), dev)
               for i in range(MAX_PREFIX)]
    tune_b = [to_device(tune_pipe.get_batch(3000 + i), dev)
              for i in range(TUNE_STEPS)]
    eval_b = [to_device(tune_pipe.get_batch(7000 + i), dev)
              for i in range(2)]

    # 1. search (KV-reuse fast path) and extraction
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy, sr, _ = CC.discover(api, params, lambda i: samples[i], iter(()),
                                qdyn, ccfg, torch.Generator().manual_seed(2),
                                skip_tune=True, verbose=False)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    counts = dict(_lib.LAUNCHES)
    n_it = len(sr.history)
    n_pool = CC._pool_pad_len(V, ccfg, SEARCH_CHUNK)
    # an iteration: the padded prefix's prefill, the base L_q and one
    # forward a chunk; then extract_cushion's prefill
    want = {**zero, "flash_attention":
            L * (n_it * (2 + n_pool // SEARCH_CHUNK) + 1)}
    if counts != want:
        fail(f"search: launches {counts}, expected {want}")
    prefix = [int(t) for t in sr.prefix_ids]
    n_seed = len(ccfg.seed_tokens)
    for i, tok in enumerate(prefix[n_seed:]):
        h = sr.history[i]
        if h["best_tok"] != tok or not h["best_err"] <= ccfg.tau * h[
                "base_err"]:
            fail(f"search contract: accepted token {tok} at iteration {i} "
                 f"with {h}")
    if len(prefix) < MAX_PREFIX and not (
            sr.history[-1]["best_err"] > ccfg.tau * sr.history[-1][
                "base_err"]):
        fail("search stopped early without an eq. (10) stop")
    wdt = params.tree()["embed"]["w"].dtype        # the model's dtype
    if tuple(greedy["kv"]["k"].shape) != (L, len(prefix), cfg.n_kv_heads,
                                          cfg.head_dim) \
            or greedy["kv"]["k"].dtype != wdt:
        fail(f"extracted cushion {tuple(greedy['kv']['k'].shape)} "
             f"{greedy['kv']['k'].dtype}")
    rec["search"] = {"prefix_ids": prefix, "history": sr.history,
                     "wall_s": search_s, "iterations": n_it,
                     "s_per_iteration": search_s / n_it,
                     "candidates_scored_per_s": n_it * n_pool / search_s,
                     "candidates_scored_are": f"the pool padded to {n_pool} "
                                              "a iteration",
                     "launches": counts}
    log(f"search: prefix {prefix} in {search_s:.2f} s ({n_it} iterations, "
        f"{search_s / n_it:.3f} s each, {n_it * n_pool / search_s:.0f} "
        f"candidates scored a second); history "
        + "; ".join(f"{h['base_err']:.4g} -> {h['best_err']:.4g} "
                    f"(tok {h['best_tok']})" for h in sr.history)
        + f"; launches {counts['flash_attention']} flash_attention")

    # where an iteration's time goes: one search step under the profiler
    step_fn = CC.make_search_step_fn(api, qdyn)
    padded = torch.tensor((prefix + [0] * MAX_PREFIX)[:MAX_PREFIX],
                          dtype=torch.int32, device=dev)
    pool = (torch.arange(n_pool, dtype=torch.int32, device=dev) * 7 + 5) \
        .reshape(-1, SEARCH_CHUNK)
    rec["search"]["profile"] = profiled(
        lambda: step_fn(params, padded, MAX_PREFIX - 1, pool, samples[0]),
        1, "search iteration")

    # 2. card against CPU: a 32-token sample, 4 candidates, a 2-token live
    # prefix padded to MAX_PREFIX rows (the CPU's side in the worker, with
    # the gradients below; both compared at the join)
    s32 = {"tokens": samples[0]["tokens"][:, :32]}
    two = (prefix + [3])[:2]
    pad = torch.tensor(two + [0] * (MAX_PREFIX - 2), dtype=torch.int32)
    cands = torch.tensor([13, 198, V // 4, V - 1], dtype=torch.int32)
    sc_card = method_scores(api, params, pad, cands, s32["tokens"], qdyn)

    # 3. tune: exact launches, bounded host syncs, per-step device time
    evs = []

    def timed_batches():
        for b_ in tune_b:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append(ev)
            yield b_

    _lib.reset_launches()
    with MON.count_host_syncs() as hs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = CC.prefix_tune(api, params, greedy, timed_batches(), qdyn, ccfg,
                            verbose=False)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    counts = dict(_lib.LAUNCHES)
    want = {**zero, "flash_attention": L * TUNE_STEPS,
            "flash_attention_bwd": L * TUNE_STEPS}
    if counts != want:
        fail(f"tune: launches {counts}, expected {want}")
    if hs.count > TUNE_STEPS // TUNE_LOG_EVERY + 1:
        fail(f"tune: {hs.count} host syncs")
    if len(tr.log) != TUNE_STEPS or not all(
            np.isfinite(r[k]) for r in tr.log for k in r):
        fail(f"tune: log {tr.log}")
    tuned = tr.cushion
    if torch.equal(tuned["kv"]["k"], greedy["kv"]["k"]) or \
            tuned["kv"]["k"].dtype != wdt:
        fail("tune: the cushion did not move, or changed dtype")
    evs.append(end)
    step_ms = [a.elapsed_time(b_) for a, b_ in zip(evs, evs[1:])]
    rec["tune"] = {"steps": TUNE_STEPS, "wall_s": tune_s,
                   "step_ms": quartiles(step_ms=step_ms)["step_ms"],
                   "step_ms_all": step_ms, "host_syncs": hs.count,
                   "launches": counts, "log": tr.log,
                   "moved_max_abs": float((tuned["kv"]["k"].float()
                                           - greedy["kv"]["k"].float())
                                          .abs().max())}
    log(f"tune: {TUNE_STEPS} steps (B={TUNE_B}, {TUNE_S} tokens) in "
        f"{tune_s:.2f} s, ms a step (device, p25/p50/p75) "
        f"{rec['tune']['step_ms']}; host syncs {hs.count}; launches "
        f"{counts['flash_attention']} / {counts['flash_attention_bwd']}; "
        f"loss {tr.log[0]['loss']:.4f} -> {tr.log[-1]['loss']:.4f}")

    # where a step's time goes: two more steps under the profiler
    rec["tune"]["profile"] = profiled(
        lambda: CC.prefix_tune(api, params, tuned, iter(tune_b[:2]), qdyn,
                               dataclasses.replace(ccfg, tune_steps=2,
                                                   log_every=2),
                               verbose=False), 2, "tuning step")

    # the gradient into the cushion, card against CPU (B = 1, 32 tokens):
    # the smooth part (CE, no fake quant) against the CPU's bf16 gradient,
    # and the tuning loss against the CPU's f32 gradient, beside the CPU's
    # bf16 one
    gb = {k: v[:1, :32] for k, v in tune_b[0].items()}

    def cmp(a, b):
        return (float((a - b).norm() / b.norm()),
                float(torch.dot(a, b) / (a.norm() * b.norm())))

    qnone = QuantConfig()
    _lib.reset_launches()
    g_ce_card = cushion_grad(api, params, greedy, gb, qnone, 0.0)
    g_tune_card = cushion_grad(api, params, greedy, gb, qdyn, ccfg.lam)
    if _lib.LAUNCHES["flash_attention_bwd"] != 2 * L:
        fail(f"gradient: {_lib.LAUNCHES['flash_attention_bwd']} backward "
             f"launches, expected {2 * L}")
    CPU_HALVES.submit("phase 4c", cpu_method_half, {
        "cfg": cfg, "params": to_cpu(params.tree()), "pad": pad,
        "cands": cands, "s32": to_cpu(s32["tokens"]), "gb": to_cpu(gb),
        "greedy": to_cpu(greedy), "qdyn": qdyn, "lam": ccfg.lam})

    def compare():
        got = CPU_HALVES.result("phase 4c")
        sc = {"card": sc_card, "cpu": got["scores"]}
        rel = np.abs(sc["card"][0] - sc["cpu"][0]) / np.abs(sc["cpu"][0])
        base_rel = abs(sc["card"][1] - sc["cpu"][1]) / abs(sc["cpu"][1])
        agree = int(np.argmin(sc["card"][0])) == int(np.argmin(sc["cpu"][0]))
        rec["scores_card_vs_cpu"] = {
            "card": sc["card"][0].tolist(), "cpu": sc["cpu"][0].tolist(),
            "base_card": sc["card"][1], "base_cpu": sc["cpu"][1],
            "max_rel_err": float(rel.max()), "base_rel_err": base_rel,
            "rtol": SCORE_RTOL, "argmin_agrees": agree}
        log(f"scores card vs CPU (32 tokens, candidates {cands.tolist()}, "
            f"prefix {two} padded to {MAX_PREFIX}): max rel err "
            f"{float(rel.max()):.3g}, base {base_rel:.3g} (tolerance "
            f"{SCORE_RTOL}); argmin agrees: {agree}")
        if float(rel.max()) > SCORE_RTOL or base_rel > SCORE_RTOL:
            fail("search scores: card and CPU beyond the stated tolerance")
        g_ce_cpu, g_tune_cpu, g_ce_ref, g_tune_ref = (
            torch.from_numpy(got[k]) for k in ("ce", "tune", "ce_ref",
                                               "tune_ref"))
        ce_rel, ce_cos = cmp(g_ce_card, g_ce_cpu)
        card_rel, card_cos = cmp(g_tune_card, g_tune_ref)
        cpu_rel, cpu_cos = cmp(g_tune_cpu, g_tune_ref)
        rec["grad_card_vs_cpu"] = {
            "ce_rel_l2": ce_rel, "ce_cosine": ce_cos, "ce_tol": GRAD_TOL,
            "ce_card_vs_f32": list(cmp(g_ce_card, g_ce_ref)),
            "ce_cpu_bf16_vs_f32": list(cmp(g_ce_cpu, g_ce_ref)),
            "tune_card_vs_f32": [card_rel, card_cos],
            "tune_cpu_bf16_vs_f32": [cpu_rel, cpu_cos],
            "tune_card_vs_cpu_bf16": list(cmp(g_tune_card, g_tune_cpu)),
            "tune_factor": GRAD_TUNE_FACTOR,
            "cpu_half": CPU_HALVES.seconds["phase 4c"]}
        gr = rec["grad_card_vs_cpu"]
        log(f"gradient into the cushion (B=1, 32 tokens): CE, card vs CPU "
            f"bf16: relative L2 {ce_rel:.4g}, cosine {ce_cos:.6f} "
            f"(tolerance {GRAD_TOL}; against the CPU's f32 gradient: card "
            f"{gr['ce_card_vs_f32'][0]:.4g}, CPU bf16 "
            f"{gr['ce_cpu_bf16_vs_f32'][0]:.4g}); tuning loss against the "
            f"CPU's f32 gradient: card {card_rel:.4g} / {card_cos:.4f}, CPU "
            f"bf16 {cpu_rel:.4g} / {cpu_cos:.4f} (card within "
            f"{GRAD_TUNE_FACTOR}x the CPU's)")
        if ce_rel > GRAD_TOL[0] or ce_cos < GRAD_TOL[1] \
                or card_rel > GRAD_TUNE_FACTOR * cpu_rel:
            fail("gradient: card and CPU beyond the stated tolerance")
    CPU_HALVES.later(compare)

    # quality before and after tuning (random weights: printed, not gated)
    g_top1, g_ppl = _quality(api, params, greedy, eval_b)
    t_top1, t_ppl = _quality(api, params, tuned, eval_b)
    rec["quality"] = {"maxact_top1": {"greedy": g_top1, "tuned": t_top1},
                      "ppl": {"greedy": g_ppl, "tuned": t_ppl}}
    log(f"max-activation top-1 {g_top1:.2f} -> {t_top1:.2f}, held-out ppl "
        f"{g_ppl:.2f} -> {t_ppl:.2f} (greedy -> tuned; printed, not gated)")

    # 4. pt_static scales under the tuned cushion, the artifact saved and
    # served back
    tagged, _ = calibrate_tagged(api, params, calib, qw8, cushion=tuned)
    art = ROOT / "build" / "chip_smoke_artifact"
    shutil.rmtree(art, ignore_errors=True)
    fp = CC.cushion_fingerprint(tuned)
    CheckpointManager(str(art)).save(
        1, {"cushion": tuned, "scales": scales_to_plain(tagged.scales)},
        extra={"kind": "cushion", "arch": cfg.name, "dtype": cfg.dtype,
               "fingerprint": fp, "prefix_ids": prefix,
               "quant_mode": "pt_dynamic", "tune_steps": TUNE_STEPS,
               "scales_cushion_fp": tagged.cushion_fp})
    cush2, sc2, _ = load_cushion_artifact(str(art), api)
    if CC.cushion_fingerprint(cush2) != fp or sc2.cushion_fp != fp:
        fail("artifact: the reloaded fingerprint differs")
    b1 = {"tokens": batch["tokens"][:1, :64]}
    kw = dict(max_seq=128, kv_dtype="int8", prequant=True)
    mem = Engine(api, params, qw8, cushion=tuned, scales=tagged, **kw)
    toks_mem = mem.generate(b1, 8).tokens
    del mem
    toks_art = Engine(api, params, qw8, cushion=cush2, scales=sc2,
                      **kw).generate(b1, 8).tokens
    if not np.array_equal(toks_mem, toks_art):
        fail(f"artifact: reloaded cushion tokens {toks_art} != in-memory "
             f"{toks_mem}")
    try:
        Engine(api, params, qw8, cushion=greedy, scales=sc2, **kw)
        fail("artifact: stale scales were accepted")
    except ValueError as e:
        if "stale" not in str(e):
            raise
    shutil.rmtree(art, ignore_errors=True)
    rec["artifact"] = {"fingerprint": fp, "tokens": toks_art.tolist(),
                       "stale_scales_refused": True}
    log(f"artifact: fingerprint {fp[:12]} equal after reload; the reloaded "
        f"cushion's W8A8 int8-KV tokens {toks_art[0].tolist()} = the "
        f"in-memory cushion's; stale scales refused")
    return rec


# phase 4d, the replica router: 3 replicas x 4 slots, the 12 requests of
# phase 4b extended the same way to 24, all arriving at t = 0
REPLICAS, ROUTER_SLOTS, ROUTER_REQ = 3, 4, 24
# phase 4d's no-fault tokens by uid, which phase 4m's replicas must give
ROUTER_TOKENS = {}


def router_phase(api, params, qw8, cushion, scales, reqs_4b, outs_4b, ps,
                 zero_counts, counters_zero, profiled_steps):
    """Phase 4d: ``ReplicaRouter`` at full width (see the module
    docstring). Every run is held to exact launch counts, one graph
    replay per replica step, graphs captured once, zero merge counters
    and workspaces, one copy of the weights and no replica error or death
    beyond the injected ones; tokens are compared per uid, never by
    replica or slot (a DEGRADED flag moves a request, not its tokens)."""
    import numpy as np
    import torch
    from repro_torch.distributed.fault_injection import FaultInjector
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import poisson_trace
    from repro_torch.serving.router import DEAD, HEALTHY, ReplicaRouter
    from repro_torch.serving.scheduler import ContinuousEngine

    L = api.cfg.n_layers
    reqs = poisson_trace(api, 0, ROUTER_REQ, 0.0, (PROMPT, PROMPT + 8),
                         (NEW_TOKENS, NEW_TOKENS // 2))
    for r, r4 in zip(reqs, reqs_4b):
        if not torch.equal(r.batch["tokens"], r4.batch["tokens"]) \
                or r.max_new_tokens != r4.max_new_tokens:
            fail(f"router trace: request {r.uid} is not phase 4b's")
    kw = dict(n_slots=ROUTER_SLOTS, max_seq=PROMPT + 8 + NEW_TOKENS + 32,
              cushion=cushion, scales=scales, kv_dtype="int8")
    rec = {"replicas": REPLICAS, "slots": ROUTER_SLOTS,
           "requests": ROUTER_REQ, "runs": {}, "launches": {}}

    def shared_weights(router):
        """The int8 weight tensors' addresses, one tuple for every replica
        (the same tensors behind all of them), or fail."""
        ptrs = {tuple(t.data_ptr() for t in rep.engine.params.buffers()
                      if t.dtype == torch.int8) for rep in router.replicas}
        if len(ptrs) != 1 or not next(iter(ptrs)):
            fail("router: the replicas do not share one copy of the int8 "
                 "weights")
        return next(iter(ptrs))

    def build_router(paged):
        t0 = time.perf_counter()
        router = ReplicaRouter(api, params, qw8, n_replicas=REPLICAS,
                               prequant=True, paged=paged, page_size=ps,
                               **kw)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        ptrs = shared_weights(router)
        graphs = [rep.engine.graph for rep in router.replicas]
        if any(g is None for g in graphs):
            fail("router: a replica has no captured decode step")
        # each replica's step walls (host clock; a step ends in its sync)
        for rep in router.replicas:
            rep.walls = []

            def timed_step(step=rep.engine.step, walls=rep.walls):
                t0 = time.perf_counter()
                out = step()
                walls.append(time.perf_counter() - t0)
                return out
            rep.engine.step = timed_step
        log(f"router ({'paged' if paged else 'contiguous'} int8 pools): "
            f"{REPLICAS} replicas built in {built:.2f} s (one "
            f"prequantization, {REPLICAS} graph captures: "
            f"{[round(g.capture_s, 3) for g in graphs]} s), "
            f"{len(ptrs)} int8 weight tensors shared")
        return router, graphs, built

    def metrics(outs, wall):
        total = sum(len(o.tokens) for o in outs)
        span = max(o.finished_s for o in outs)
        ttft = [o.ttft_ms for o in outs]
        tpot = [o.tpot_ms for o in outs]
        lat = [o.latency_s * 1e3 for o in outs]
        return {"wall_s": wall, "tokens": total, "tokens_per_s": total / span,
                **{f"{k}_p{q}": float(np.percentile(v, q))
                   for k, v in (("ttft_ms", ttft), ("tpot_ms", tpot),
                                ("latency_ms", lat)) for q in (50, 99)}}

    def expected(steps, prefills, paged):
        """Launches of ``steps`` decode steps and ``prefills`` B = 1
        prefills of > 16 rows (the static quantizer standalone at the 160
        layer sites of a prefill, fused at its head and at every decode
        site)."""
        sites = 5 * L
        return {**zero_counts,
                "w8a8_matmul": (sites + 1) * (steps + prefills),
                "act_quant_static": sites * prefills,
                "act_quant_static_fused": prefills + (sites + 1) * steps,
                "flash_attention": L * prefills,
                "flash_decode": 0 if paged else L * steps,
                "flash_decode_paged": L * steps if paged else 0}

    def route(label, router, graphs, paged, chaos=None):
        """One run of the 24-request trace under ``chaos``, checked as the
        docstring says; returns (result, deaths seen, record)."""
        deaths = []
        kill = router._kill_replica

        def spy(rep, now, reason, rejected, outputs):
            if not rep.dead_handled:
                deaths.append({"replica": rep.idx, "at_s": now,
                               "reason": reason, "live": [
                                   r.uid for r in rep.engine.live_requests()]})
            return kill(rep, now, reason, rejected, outputs)

        router._kill_replica = spy
        for rep in router.replicas:
            rep.walls.clear()
        inj = FaultInjector.parse(chaos) if chaos else None
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = router.run(reqs, injector=inj)
        finally:
            del router._kill_replica
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.LAUNCHES)
        replays = _lib.COUNTERS["graph_replays"]
        st, per = res.stats, res.stats.per_replica
        steps = sum(p["steps"] for p in per)
        prefills = sum(p["admitted"] for p in per)
        if replays != steps:
            fail(f"router {label}: {replays} graph replays, the replicas "
                 f"stepped {steps} times")
        if any(rep.engine.graph is not g
               for rep, g in zip(router.replicas, graphs)):
            fail(f"router {label}: a replica captured its step again")
        shared_weights(router)
        crashes = sum(kind == "crash" for _, _, kind in inj.log) if inj \
            else 0
        errors = [rep.health.errors for rep in router.replicas]
        if st.replica_deaths != crashes or len(deaths) != crashes \
                or any(errors) \
                or any(p["consecutive_errors"] for p in per):
            fail(f"router {label}: {st.replica_deaths} deaths ({crashes} "
                 f"injected), errors {errors}: a replica failed on its own")
        want = expected(steps, prefills, paged)
        if counts != want:
            fail(f"router {label}: launches {counts}, expected {want}")
        for k, n in counts.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + n
        counters_zero(f"phase 4d {label}", graphs)
        # where the wall went: the replicas' steps, the completed
        # requests' admission prefills (TTFT), the rest (the router's host
        # loop, failed attempts' prefills)
        steps_s = [sum(rep.walls) for rep in router.replicas]
        prefill_s = sum(o.ttft_ms for o in res.outputs) / 1e3
        info = {**(metrics(res.outputs, wall) if res.outputs else {}),
                "step_wall_s": steps_s, "prefill_wall_s": prefill_s,
                "other_wall_s": wall - sum(steps_s) - prefill_s,
                "step_ms_p50": [float(np.median(rep.walls)) * 1e3
                                for rep in router.replicas if rep.walls],
                "stats": {k: v for k, v in st.as_dict().items()
                          if k != "per_replica"},
                "per_replica": [{k: p[k] for k in (
                    "state", "steps", "admitted", "finished", "canceled",
                    "occupancy", "stragglers", "consecutive_errors")}
                    for p in per],
                "errors": errors, "deaths": deaths, "launches": counts,
                "graph_replays": replays}
        log(f"router {label}: {st.completed} completed, {st.rejected} "
            f"rejected {st.rejections}, {st.retries} retries, "
            f"{st.failovers} failovers, {st.replica_deaths} deaths, queue "
            f"peak {st.queue_depth_peak}, states "
            f"{[p['state'] for p in per]}, steps "
            f"{[p['steps'] for p in per]}, "
            + (f"{info['tokens_per_s']:.1f} tok/s, TTFT p50/p99 "
               f"{info['ttft_ms_p50']:.2f}/{info['ttft_ms_p99']:.2f} ms, "
               f"TPOT p50/p99 {info['tpot_ms_p50']:.2f}/"
               f"{info['tpot_ms_p99']:.2f} ms, latency p50/p99 "
               f"{info['latency_ms_p50']:.1f}/{info['latency_ms_p99']:.1f} "
               f"ms, " if res.outputs else "")
            + f"steps {sum(steps_s):.3f} s, prefills {prefill_s:.3f} s, "
            f"other {info['other_wall_s']:.3f} s of {wall:.3f} s, "
            f"{replays} graph replays, launches {counts}")
        return res, deaths, info

    def same_tokens(label, outs, want):
        for o in outs:
            if not np.array_equal(o.tokens, want[o.uid]):
                fail(f"router {label}: request {o.uid} tokens differ")

    router, graphs, built = build_router(paged=True)
    rec["build_s"] = built
    # the first run after construction, budgets of 2: what the first steps
    # of each replica cost (host ms of the step, which ends in its sync)
    router.run([dataclasses.replace(r, max_new_tokens=2) for r in reqs])
    rec["first_steps_ms"] = [[t * 1e3 for t in rep.walls]
                             for rep in router.replicas]
    counters_zero("phase 4d warm-up", graphs)

    res0, _, rec["runs"]["r0_no_fault"] = route("r0", router, graphs, True)
    st = res0.stats
    if len(res0.outputs) != ROUTER_REQ or st.completed != ROUTER_REQ \
            or st.rejected or st.retries or st.failovers:
        fail(f"router r0: {st.as_dict()}")
    for o in res0.outputs:
        if o.tokens.shape != (reqs[o.uid].max_new_tokens,):
            fail(f"router r0: request {o.uid} gave {o.tokens.shape} tokens")
    same_tokens("r0 vs phase 4b (b)", res0.outputs[:len(outs_4b)],
                {o.uid: o.tokens for o in outs_4b})
    tok0 = {o.uid: o.tokens for o in res0.outputs}
    ROUTER_TOKENS.update(tok0)
    log(f"router: first steps of each replica after construction (ms) "
        f"{[[round(t, 2) for t in ts[:3]] for ts in rec['first_steps_ms']]}"
        f", r0's median step "
        f"{[round(t, 2) for t in rec['runs']['r0_no_fault']['step_ms_p50']]}"
        f" ms")

    res1, deaths, info = route("r1", router, graphs, True,
                               "crash@replica1.step:6")
    st = res1.stats
    if len(res1.outputs) != ROUTER_REQ or st.rejected:
        fail(f"router r1: {st.completed} completed, {st.rejections}")
    same_tokens("r1 vs r0", res1.outputs, tok0)
    states = [p["state"] for p in st.per_replica]
    failed = deaths[0]["live"]
    if states != [HEALTHY, DEAD, HEALTHY] or st.failovers != len(failed) \
            or st.retries < st.failovers or not failed:
        fail(f"router r1: states {states}, {st.failovers} failovers and "
             f"{st.retries} retries for {len(failed)} live requests")
    done = {o.uid: o.finished_s for o in res1.outputs}
    info["failover_s"] = max(done[u] for u in failed) - deaths[0]["at_s"]
    rec["runs"]["r1_crash"] = info
    log(f"router r1: replica 1 died at {deaths[0]['at_s'] * 1e3:.1f} ms "
        f"with {len(failed)} live requests {failed}; the last of them "
        f"completed {info['failover_s'] * 1e3:.1f} ms later")

    res2, _, rec["runs"]["r2_drain"] = route("r2", router, graphs, True,
                                             "interrupt@replica0.step:10")
    st = res2.stats
    served = {o.uid for o in res2.outputs}
    if not st.drained or not served \
            or {r.reason for r in res2.rejected} != {"draining"} \
            or sorted(served | {r.uid for r in res2.rejected}) \
            != list(range(ROUTER_REQ)) \
            or len(served) + len(res2.rejected) != ROUTER_REQ:
        fail(f"router r2: drained={st.drained}, {len(served)} completed, "
             f"{st.rejections}")
    same_tokens("r2 vs r0", res2.outputs, tok0)

    # one round of the three replicas' steps, all slots decoding, profiled
    # as a round and replica by replica
    with torch.inference_mode():
        for rep in router.replicas:
            rep.engine.start()
        for i, r in enumerate(reqs[:REPLICAS * ROUTER_SLOTS]):
            if not router.replicas[i % REPLICAS].engine.try_admit(r):
                fail("router profile: admission refused")

        def round_():
            for rep in router.replicas:
                rep.engine.step()

        round_()
        busy = {"round": profiled_steps(round_, 4)}
        for rep in router.replicas:
            busy[f"replica{rep.idx}"] = profiled_steps(rep.engine.step, 4)
    # busy share: device ms over the profiled wall, and over r0's
    # unprofiled median step (the round: the three medians summed)
    med = rec["runs"]["r0_no_fault"]["step_ms_p50"]
    for key, d in busy.items():
        if not isinstance(d["device_ms_per_step"], str):
            d["busy_share"] = (d["device_ms_per_step"]
                               / d["profiled_wall_ms_per_step"])
            d["busy_share_of_r0_step"] = d["device_ms_per_step"] / (
                sum(med) if key == "round" else med[int(key[-1])])
    rec["busy"] = busy
    counters_zero("phase 4d profile", graphs)
    log(f"router: one round of {REPLICAS} replica steps (4 slots each): "
        f"wall {busy['round']['profiled_wall_ms_per_step']:.3f} ms, device "
        f"{busy['round']['device_ms_per_step']} ms, busy share "
        f"{busy['round'].get('busy_share')} (of r0's median steps "
        f"{busy['round'].get('busy_share_of_r0_step')}); alone: " + ", ".join(
            f"replica {i} {busy[f'replica{i}']['device_ms_per_step']} of "
            f"{busy[f'replica{i}']['profiled_wall_ms_per_step']:.3f} ms"
            for i in range(REPLICAS)))

    # r3: r1's schedule over contiguous int8 pools (flash_decode)
    router_c, graphs_c, _ = build_router(paged=False)
    res3, _, rec["runs"]["r3_contiguous_crash"] = route(
        "r3", router_c, graphs_c, False, "crash@replica1.step:6")
    if len(res3.outputs) != ROUTER_REQ or res3.stats.rejected:
        fail(f"router r3: {res3.stats.as_dict()}")
    same_tokens("r3 vs r0", res3.outputs, tok0)
    del router_c, graphs_c

    # beside them, not a router: one engine of 12 slots on the same trace
    eng = ContinuousEngine(api, router.replicas[0].engine.params.tree(), qw8,
                           paged=True, page_size=ps,
                           **dict(kw, n_slots=REPLICAS * ROUTER_SLOTS))
    eng.run([dataclasses.replace(r, max_new_tokens=2) for r in reqs])
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if _lib.COUNTERS["graph_replays"] != eng.stats.steps \
            or len(outs) != ROUTER_REQ:
        fail(f"12-slot engine: {len(outs)} outputs, "
             f"{_lib.COUNTERS['graph_replays']} replays, "
             f"{eng.stats.steps} steps")
    same_tokens("12-slot engine vs r0", outs, tok0)
    counters_zero("phase 4d 12-slot engine", [eng.graph])
    rec["engine_12_slots"] = {**metrics(outs, wall),
                              "steps": eng.stats.steps,
                              "occupancy": eng.stats.occupancy()}
    log(f"one engine of {REPLICAS * ROUTER_SLOTS} slots: "
        f"{rec['engine_12_slots']['tokens_per_s']:.1f} tok/s in "
        f"{eng.stats.steps} steps, beside the router's r0 "
        f"{rec['runs']['r0_no_fault']['tokens_per_s']:.1f} tok/s "
        f"({sum(p['steps'] for p in rec['runs']['r0_no_fault']['per_replica'])}"
        f" replica steps); tokens equal per uid")
    return rec


def smoothquant_step(api, params, cfg, calib, batch, cushion, qw8):
    """Phase 4's SmoothQuant sub-step on smollm-360m: fold the model with
    ``apply_smoothquant`` from its calibration statistics under the
    cushion, recalibrate, prequantize, and serve B=1 (a 64-token prompt, 8
    tokens) in W8A8 with int8 KV; the largest ``mlp_in`` channel max falls
    (``tests/test_substrate.py``'s check)."""
    import torch
    from repro_torch.core.calibration import calibrate
    from repro_torch.core.smoothquant import apply_smoothquant
    from repro_torch.serving.engine import Engine

    t0 = time.perf_counter()
    with torch.inference_mode():
        _, stats = calibrate(api, params, calib, qw8, cushion=cushion)
        sm = apply_smoothquant(params, stats, cfg, alpha=0.8)
        scales, stats2 = calibrate(api, sm, calib, qw8, cushion=cushion)
    before = float(stats["layers"]["mlp_in"]["absmax_ch"].float().max())
    after = float(stats2["layers"]["mlp_in"]["absmax_ch"].float().max())
    eng = Engine(api, sm, qw8, cushion=cushion, scales=scales, max_seq=128,
                 kv_dtype="int8", prequant=True)
    toks = eng.generate({"tokens": batch["tokens"][:1, :64]}, 8).tokens
    if toks.shape != (1, 8) or toks.min() < 0 or toks.max() >= \
            cfg.vocab_size:
        fail(f"smoothquant: bad tokens {toks}")
    rec = {"mlp_in_absmax_before": before, "mlp_in_absmax_after": after,
           "alpha": 0.8, "tokens": toks[0].tolist(),
           "weight_bytes_int8": eng.weight_bytes_int8,
           "seconds": time.perf_counter() - t0}
    log(f"smoothquant (alpha 0.8): largest mlp_in channel max {before:.4g} "
        f"-> {after:.4g}; W8A8 int8-KV Engine on the folded model: tokens "
        f"{rec['tokens']} ({rec['seconds']:.1f} s)")
    if not after < before:
        fail("smoothquant did not lower the largest mlp_in channel max")
    return rec


# phase 4k's one-rank sides of the MoE, VLM and hybrid runs, recorded by
# phases 4e-4g from their own engines: {arch: {"one", "cases", ...}}
TP_FAMILIES = {}


def import_tp_probe():
    """``tests/_tp_probe.py``, a tensor-parallel rank's program (jax-free),
    beside the tests that spawn it too; the spawned ranks inherit this
    ``sys.path``."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.append(str(ROOT / "tests"))
    import _tp_probe
    return _tp_probe


# phases 4f and 4g: the VLM and the Jamba hybrid at full width, each through
# both engines, the search and the tuning (see the module docstring)
# 8 of internvl2's 48 layers and of olmoe's 16 (both 16 until phases 4h and
# 4i came: cuts of depth that keep the whole script well inside its limit)
VLM_ARCH, VLM_LAYERS, VLM_TEXT, VLM_NEW = "internvl2-26b", 8, 512, 32
HY_ARCH, HY_NEW = "jamba-v0.1-52b", 16
FAM_REQ, FAM_PROMPTS, FAM_BUDGETS = 8, (128, 136), (16, 8)
FAM_CANDIDATES, FAM_SEEDS, FAM_TUNE_STEPS = 16, (1, 198), 3
# card vs CPU at full width and a cut depth: the VLM at 2 of its layers
# (64 patches, 64 tokens, 4 logits rows), the hybrid as a two-layer period
# (a Mamba layer with a dense MLP, the attention layer with the MoE; 64
# tokens, 2 logits rows: each CPU call under W8A8 fake-quantizes the
# layer's 2.8 B expert weights, ~16 s), phase 4e's sources and
# tolerances; in the hybrid a one-ulp difference also travels along the
# Mamba recurrence, within the same bounds
FAM_CMP_PROMPT, VLM_CMP_TOKENS, HY_CMP_TOKENS = 64, 4, 2


# phase 4e, the MoE family at full width: olmoe-1b-7b (8 of its 16 layers,
# 64 experts, top-8, capacity factor 1.25, bf16, seeded random weights)
# through both engines, the search and the tuning
MOE_ARCH, MOE_LAYERS, MOE_NEW = "olmoe-1b-7b", 8, 32
# card vs CPU, olmoe at 2 of its layers (full width): the CPU side at
# more would hold GBs and take minutes. Both sides round to bf16
# at the same points but reduce in other orders, the combine einsum
# summing the 8 experts' outputs included, so values land one bf16 ulp
# apart, and under W8A8 a code flips by one step of its site's range / 255
# (phase 5's sources, over 2 layers, not 32). One source is the MoE's own:
# a token whose 8th and 9th gate probabilities nearly tie can take another
# expert on one side (the gate logits see the one-ulp differences of their
# bf16 input), which moves that position's MoE output by the expert's
# share, up to O(1) at that position and little elsewhere. So the largest
# error is held at 1.0 and the mean at phase 5's: a fault (a wrong scale,
# slot, expert or position) moves every logit by O(1). The routing
# disagreements of the prefill are counted and printed.
# mode: (largest |card - cpu|, mean |card - cpu|)
MOE_LOGIT_TOL = {"fp": (1.0, 0.05), "w8a8_int8kv": (1.0, 0.1)}
MOE_CMP_LAYERS, MOE_CMP_PROMPT, MOE_CMP_TOKENS = 2, 64, 4
# the names of the port's own kernels in a profiler trace
PORTED = re.compile(r"act_quant_|flash_attention|attn_bwd|flash_decode|"
                    r"int_matmul")


def int_matmul_rows(tag, dev, timed, sites, M, g=None):
    """The int matmul at every site in ``sites`` ({name: (K, N, calls a
    step)}) quantizing bf16 A at decode (M = B) and, but for the head, on
    int8 codes at prefill (``M`` rows), and ``act_quant_static`` at the
    prefill's sites, all held ``torch.equal`` to their plain versions and
    timed over the calls of their unit beside the plain versions and their
    bounds; inputs drawn from ``g``. Returns {kernel: row}."""
    import torch
    from repro_torch.kernels.act_quant import (act_quant_static,
                                               act_quant_static_plain)
    from repro_torch.kernels.w8a8_matmul import (
        quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_matmul,
        w8a8_matmul_plain)

    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(22) if g is None else g
    rows = {}

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    s_x, z_x = scalar(0.031), scalar(111.0)
    dec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    pre = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    aqs = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    n_dec = n_pre = 0
    for name, (Kd, N, n) in sites.items():
        w = torch.randint(-127, 128, (Kd, N), generator=g, device=dev,
                          dtype=torch.int8)
        s_w = torch.tensor(0.002, dtype=bf, device=dev)
        cs = w.sum(0, dtype=torch.int32)
        x = torch.randn((B, Kd), generator=g, device=dev).to(bf) * 3
        args = (x, w, s_x, z_x, s_w, cs)
        for dt in (bf, torch.float32):
            if not torch.equal(quant_w8a8_matmul(*args, out_dtype=dt),
                               quant_w8a8_matmul_plain(*args, out_dtype=dt)):
                fail(f"{tag} w8a8_matmul {name} (M={B}, {dt}): not "
                     f"bit-exact")
        n_dec += n
        dec["ms"] += n * timed(lambda: quant_w8a8_matmul(*args,
                                                         out_dtype=bf))
        dec["plain_ms"] += n * timed(
            lambda: quant_w8a8_matmul_plain(*args, out_dtype=bf), 3)
        dec["bound_ms"] += n * bound_ms(2 * B * Kd + Kd * N + 4 * N
                                        + 2 * B * N, 2.0 * B * Kd * N,
                                        INT8_OPS_PER_S)[0]
        if name == "head":
            continue
        xa = torch.randn((M, Kd), generator=g, device=dev).to(bf) * 3
        if not torch.equal(act_quant_static(xa, s_x, z_x),
                           act_quant_static_plain(xa, s_x, z_x)):
            fail(f"{tag} act_quant_static {name}: not bit-exact")
        xq = act_quant_static(xa, s_x, z_x)
        pa = (xq, w, s_x, z_x, s_w, cs, -128.0, bf)
        if not torch.equal(w8a8_matmul(*pa), w8a8_matmul_plain(*pa)):
            fail(f"{tag} w8a8_matmul {name} (M={M}): not bit-exact")
        n_pre += n
        pre["ms"] += n * timed(lambda: w8a8_matmul(*pa))
        pre["plain_ms"] += n * timed(lambda: w8a8_matmul_plain(*pa), 3)
        pre["bound_ms"] += n * bound_ms(M * Kd + Kd * N + 4 * N + 2 * M * N,
                                        2.0 * M * Kd * N, INT8_OPS_PER_S)[0]
        aqs["ms"] += n * timed(lambda: act_quant_static(xa, s_x, z_x))
        aqs["plain_ms"] += n * timed(
            lambda: act_quant_static_plain(xa, s_x, z_x), 3)
        aqs["bound_ms"] += n * bound_ms(3 * M * Kd, 0.0, INT8_OPS_PER_S)[0]
        del xa, xq
    rows["w8a8_matmul"] = {
        "unit": f"one {tag} decode step ({n_dec} calls, M={B}, bf16 x "
                f"quantized in the staging; sites "
                f"{ {k: v[:2] for k, v in sites.items()} })",
        **dec, "bound_by": "bytes", "max_abs_err": 0.0,
        **{f"prefill_{k}": v for k, v in pre.items()},
        "prefill_unit": f"one {tag} prefill ({n_pre} calls at the layer "
                        f"sites, M={M})"}
    rows["act_quant_static"] = {
        "unit": f"one {tag} prefill ({n_pre} calls, M={M})", **aqs,
        "bound_by": "bytes", "max_abs_err": 0.0}

    return rows


def family_kernels(tag, cfg, dev, timed, sites, n_attn, prompt, pos_static,
                   smax_static, smax_pool, tune_s):
    """The ported kernels at a model's shapes, each against its plain
    version on the same inputs, timed over the calls of its unit beside
    the plain version and its bound: the int matmul at every site in
    ``sites`` ({name: (K, N, calls a step)}) quantizing bf16
    A at decode (M = B) and, but for the head, on int8 codes at prefill (M
    = B * prompt), ``act_quant_static`` at the prefill's sites, held
    ``torch.equal``; ``flash_attention`` (B, prompt behind the cushion),
    ``flash_decode`` (int8, (K,) scales), ``flash_decode_paged`` (int8
    pages, (B, K) scales; also ``torch.equal`` to the contiguous kernel on
    the gathered pool) within one bf16 ulp, and ``flash_attention_bwd``
    at the tuning's shape (B = TUNE_B, tune_s positions) within one bf16
    ulp plus 1e-5 of the largest entry. ``n_attn`` attention layers a
    unit. Returns {kernel: row}."""
    import torch
    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain)
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_plain,
        flash_decode_plain, gather_pages)

    bf = torch.bfloat16
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(dev).manual_seed(22)
    rows = int_matmul_rows(tag, dev, timed, sites, B * prompt, g)

    def within(name, got, want, floor=1e-6):
        err = (got.float() - want.float()).abs()
        if not bool((err <= BF16_ULP * want.float().abs() + floor).all()):
            fail(f"{tag} {name}: {float(err.max()):.3g} beyond one bf16 ulp")
        return float(err.max())

    T = prompt + CUSHION
    q = torch.randn((B, H, prompt, hd), generator=g, device=dev).to(bf)
    k = torch.randn((B, K, T, hd), generator=g, device=dev).to(bf)
    v = torch.randn((B, K, T, hd), generator=g, device=dev).to(bf)
    err = within("flash_attention",
                 flash_attention(q, k, v, prefix_len=CUSHION),
                 flash_attention_plain(q, k, v, prefix_len=CUSHION))
    pairs = B * H * (prompt * CUSHION + prompt * (prompt + 1) / 2)
    bms, by = bound_ms(2 * (2 * B * H * prompt * hd + 2 * B * K * T * hd),
                       4.0 * hd * pairs, BF16_FLOPS_PER_S)
    rows["flash_attention"] = {
        "unit": f"one {tag} prefill ({n_attn} calls, B={B}, S={prompt}, "
                f"m={CUSHION}, hd={hd}, G={H // K})",
        "ms": n_attn * timed(lambda: flash_attention(q, k, v,
                                                     prefix_len=CUSHION)),
        "plain_ms": n_attn * timed(lambda: flash_attention_plain(
            q, k, v, prefix_len=CUSHION), 3),
        "bound_ms": n_attn * bms, "bound_by": by, "max_abs_err": err}
    del q, k, v

    qd = torch.randn((B, H, hd), generator=g, device=dev).to(bf)
    kq = torch.randint(-127, 128, (B, smax_static, K, hd), generator=g,
                       device=dev, dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, smax_static, K, hd), generator=g,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((K,), generator=g, device=dev) * 0.05 + 0.01
    kc = torch.randn((CUSHION, K, hd), generator=g, device=dev).to(bf)
    pos = torch.tensor(pos_static, dtype=torch.int32, device=dev)
    a = (qd, kq, vq, pos, ks, ks, kc, kc)
    err = within("flash_decode", flash_decode(*a), flash_decode_plain(*a))
    bms, by = bound_ms(4 * B * H * hd + 2 * B * (pos_static + 1 - CUSHION)
                       * K * hd + 4 * CUSHION * K * hd + 8 * K,
                       4.0 * B * H * hd * (pos_static + 1), BF16_FLOPS_PER_S)
    rows["flash_decode"] = {
        "unit": f"one {tag} decode step ({n_attn} calls, int8 KV, (K,) "
                f"scales, B={B}, pos={pos_static} of {smax_static}, "
                f"G={H // K})",
        "ms": n_attn * timed(lambda: flash_decode(*a)),
        "plain_ms": n_attn * timed(lambda: flash_decode_plain(*a), 3),
        "bound_ms": n_attn * bms, "bound_by": by, "max_abs_err": err}
    del kq, vq

    P = smax_pool // 64
    n_pages = B * P + 1
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1) \
        .to(torch.int32).reshape(B, P)
    kp = torch.randint(-127, 128, (n_pages, 64, K, hd), generator=g,
                       device=dev, dtype=torch.int8)
    vp = torch.randint(-127, 128, (n_pages, 64, K, hd), generator=g,
                       device=dev, dtype=torch.int8)
    ksb = torch.rand((B, K), generator=g, device=dev) * 0.05 + 0.01
    posb = torch.tensor([CUSHION + 140 + 10 * i for i in range(B)],
                        dtype=torch.int32, device=dev)
    pa = (qd, kp, vp, table, posb, ksb, ksb, kc, kc)
    got = flash_decode_paged(*pa)
    err = within("flash_decode_paged", got, flash_decode_paged_plain(*pa))
    if not torch.equal(got, flash_decode(qd, gather_pages(kp, table),
                                         gather_pages(vp, table), posb, ksb,
                                         ksb, kc, kc)):
        fail(f"{tag} flash_decode_paged: not bit-identical to flash_decode "
             f"on the gathered pool")
    live = int(posb.sum()) + B - B * CUSHION
    bms, by = bound_ms(4 * B * H * hd + 2 * live * K * hd
                       + 4 * CUSHION * K * hd + 8 * B * K + 4 * B * P,
                       4.0 * H * hd * (int(posb.sum()) + B),
                       BF16_FLOPS_PER_S)
    rows["flash_decode_paged"] = {
        "unit": f"one {tag} decode step of the continuous pool ({n_attn} "
                f"calls, int8 pages of 64, (B, K) scales, B={B}, pos "
                f"{posb.tolist()}, G={H // K})",
        "ms": n_attn * timed(lambda: flash_decode_paged(*pa)),
        "plain_ms": n_attn * timed(lambda: flash_decode_paged_plain(*pa), 3),
        "bound_ms": n_attn * bms, "bound_by": by, "max_abs_err": err}
    del kp, vp

    qb = torch.randn((TUNE_B, H, tune_s, hd), generator=g, device=dev).to(bf)
    Tb = tune_s + MAX_PREFIX
    kb = torch.randn((TUNE_B, K, Tb, hd), generator=g, device=dev).to(bf)
    vb = torch.randn((TUNE_B, K, Tb, hd), generator=g, device=dev).to(bf)
    do = torch.randn(qb.shape, generator=g, device=dev).to(bf)
    o, lse = _launch(qb, kb, vb, MAX_PREFIX, MAX_PREFIX, with_lse=True)
    ba = (qb, kb, vb, o, lse, do, MAX_PREFIX, MAX_PREFIX)
    errs = []
    for got_, want_ in zip(flash_attention_bwd(*ba),
                           flash_attention_bwd_plain(*ba)):
        errs.append(within("flash_attention_bwd", got_, want_,
                           1e-5 * float(want_.float().abs().max())))
    pairs = TUNE_B * H * (tune_s * MAX_PREFIX + tune_s * (tune_s + 1) / 2)
    bms, by = bound_ms(2 * (4 * TUNE_B * H * tune_s * hd
                            + 4 * TUNE_B * K * Tb * hd)
                       + 4 * TUNE_B * H * tune_s, 10.0 * hd * pairs,
                       BF16_FLOPS_PER_S)
    rows["flash_attention_bwd"] = {
        "unit": f"one {tag} tuning step ({n_attn} calls, B={TUNE_B}, "
                f"S={tune_s}, m={MAX_PREFIX}, hd={hd}, G={H // K})",
        "ms": n_attn * timed(lambda: flash_attention_bwd(*ba)),
        "plain_ms": n_attn * timed(lambda: flash_attention_bwd_plain(*ba),
                                   3),
        "bound_ms": n_attn * bms, "bound_by": by, "max_abs_err": max(errs)}
    for name, r in rows.items():
        log(f"{tag} {name}: {r['unit']}: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}), max |err| {r['max_abs_err']:.3g}")
    return rows


class FamilyRun:
    """The parts phases 4f and 4g share: a model at full width on the card,
    its launch bookkeeping, the static engines, the continuous pools, the
    method and the card-vs-CPU comparison."""

    def __init__(self, tag, cfg, dev, zero_counts, counters_zero):
        import torch
        from repro_torch.models.registry import build
        self.tag, self.cfg, self.dev = tag, cfg, dev
        self.zero_counts, self.counters_zero = zero_counts, counters_zero
        self.t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        self.api = build(cfg, "cuda")
        t0 = time.perf_counter()
        self.params = self.api.init_params(
            torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        n = sum(t.numel() for t in self.params.buffers())
        self.rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
                    "weights": n, "init_s": time.perf_counter() - t0,
                    "launches": {}}
        log(f"{tag}: {n / 1e9:.3f} B weights "
            f"({sum(t.numel() * t.element_size() for t in self.params.buffers()) / 1e9:.2f}"
            f" GB) made in {self.rec['init_s']:.1f} s")

    def add_launches(self, counts):
        for k, n in counts.items():
            self.rec["launches"][k] = self.rec["launches"].get(k, 0) + n

    def check_tokens(self, label, toks, shape):
        V = self.cfg.vocab_size
        if toks.shape != shape or toks.min() < 0 or toks.max() >= V:
            fail(f"{self.tag} {label}: bad tokens {toks.shape} "
                 f"[{toks.min()}, {toks.max()}]")

    def static(self, batch, new, cushion, calib, expect, modes):
        """Engine.generate for ``batch`` and ``new`` tokens in each mode
        {label: (qcfg, kv_dtype, prequant)}: exact launches, one replay a
        token, graph tokens = the eager loop's, two requests for the
        quartiles. Returns {label: engine}."""
        import numpy as np
        from repro_torch.kernels import _lib
        from repro_torch.serving.engine import Engine
        Bn = batch["tokens"].shape[0]
        engines, self.rec["static"], self.static_runs = {}, {}, {}
        for label, (qcfg, kv, pre) in modes.items():
            eng = Engine(self.api, self.params, qcfg, cushion=cushion,
                         max_seq=self.positions(batch) + new + 32,
                         kv_dtype=kv, calib_batches=calib if pre else None,
                         prequant=pre)
            eng.generate(batch, 4)           # warm-up; captures B's step
            graph = eng.states[Bn].graph
            _lib.reset_launches()
            res = eng.generate(batch, new)
            counts = dict(_lib.LAUNCHES)
            replays = _lib.COUNTERS["graph_replays"]
            self.check_tokens(label, res.tokens, (Bn, new))
            if counts != expect[label]:
                fail(f"{self.tag} {label}: launches {counts}, expected "
                     f"{expect[label]}")
            if replays != new - 1:
                fail(f"{self.tag} {label}: {replays} graph replays")
            self.add_launches(counts)
            _lib.reset_launches()
            eager = eng.generate_py(batch, new)
            if not np.array_equal(eager.tokens, res.tokens):
                fail(f"{self.tag} {label}: graph tokens differ from the "
                     f"eager step's")
            if dict(_lib.LAUNCHES) != counts:
                fail(f"{self.tag} {label}: eager launches differ from the "
                     f"graph's")
            reps = [res] + [eng.generate(batch, new)
                            for _ in range(REPEATS)]
            for r in reps[1:]:
                if not np.array_equal(r.tokens, res.tokens):
                    fail(f"{self.tag} {label}: a repeated request gave "
                         f"other tokens")
            self.static_runs[label] = (res, counts)
            self.rec["static"][label] = {
                "ttft_ms": res.ttft_ms, "tpot_ms": res.tpot_ms,
                "launches": counts, "graph_replays": replays,
                "graph": {"capture_s": graph.capture_s,
                          "n_nodes": graph.n_nodes},
                "eager_tpot_ms": eager.tpot_ms,
                "weight_bytes_fp": eng.weight_bytes_fp,
                "weight_bytes_int8": eng.weight_bytes_int8,
                "repeats": quartiles(
                    ttft_ms=[r.ttft_ms for r in reps],
                    tpot_ms=[r.tpot_ms for r in reps],
                    tokens_per_s=[Bn * new * 1e3
                                  / (r.ttft_ms + r.tpot_ms * (new - 1))
                                  for r in reps])}
            q = self.rec["static"][label]["repeats"]
            log(f"{self.tag} {label}: B={Bn} positions "
                f"{self.positions(batch)} new={new} m={CUSHION} TTFT "
                f"quartiles {q['ttft_ms']} ms, TPOT {q['tpot_ms']} ms, "
                f"tokens/s {q['tokens_per_s']} (eager loop TPOT "
                f"{eager.tpot_ms:.2f} ms); weights fp={eng.weight_bytes_fp}"
                f" B int8={eng.weight_bytes_int8} B; launches {counts}; "
                f"{replays} replays, {graph.n_nodes} nodes")
            engines[label] = eng
        return engines

    @staticmethod
    def positions(batch):
        n = batch["tokens"].shape[1]
        return n + (batch["patches"].shape[1] if "patches" in batch else 0)

    def pool(self, label, reqs, static_eng, qcfg, scales, cushion, want_fn,
             **kw):
        """A 4-slot ContinuousEngine over ``reqs`` at t = 0 (an int8 KV
        pool with int8-resident weights unless ``kw`` says otherwise):
        exact launches (``want_fn(admitted, steps)``), one replay a step,
        every request's tokens = the static B = 1 Engine's (generated once
        a phase, ``self.solo``)."""
        import numpy as np
        import torch
        from repro_torch.kernels import _lib
        from repro_torch.serving.scheduler import ContinuousEngine
        ce = ContinuousEngine(self.api, self.params, qcfg, n_slots=4,
                              max_seq=max(FAM_PROMPTS) + max(FAM_BUDGETS)
                              + 32 + max(self.positions(r.batch)
                                         - r.batch["tokens"].shape[1]
                                         for r in reqs),
                              cushion=cushion, scales=scales,
                              **{"kv_dtype": "int8", "prequant": True, **kw})
        ce.run([dataclasses.replace(r, max_new_tokens=2) for r in reqs[:4]])
        admissions = []
        book = ce._book_admission

        def logged(req, slot, first, tpf):
            admissions.append((req.uid, slot, ce.stats.steps))
            book(req, slot, first, tpf)
        ce._book_admission = logged
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = ce.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del ce._book_admission
        counts = dict(_lib.LAUNCHES)
        st = ce.stats
        if _lib.COUNTERS["graph_replays"] != st.steps:
            fail(f"{self.tag} {label}: {_lib.COUNTERS['graph_replays']} "
                 f"replays, {st.steps} steps")
        want = {**self.zero_counts, **want_fn(st.admitted, st.steps)}
        if counts != want:
            fail(f"{self.tag} {label}: launches {counts}, expected {want}")
        self.add_launches(counts)
        if not hasattr(self, "solo"):
            self.solo = {r.uid: static_eng.generate(
                r.batch, r.max_new_tokens).tokens[0] for r in reqs}
        for r, o in zip(reqs, outs):
            self.check_tokens(f"{label} {r.uid}", o.tokens,
                              (r.max_new_tokens,))
            if not np.array_equal(self.solo[r.uid], o.tokens):
                fail(f"{self.tag} {label} request {r.uid}: tokens differ "
                     f"from the static B=1 Engine's")
        total = sum(len(o.tokens) for o in outs)
        out = {"wall_s": wall, "tokens": total,
               "tokens_per_s": total / max(o.finished_s for o in outs),
               "ttft_ms_p50": float(np.percentile([o.ttft_ms for o in outs],
                                                  50)),
               "tpot_ms_p50": float(np.percentile([o.tpot_ms for o in outs],
                                                  50)),
               "steps": st.steps, "launches": counts,
               "graph_nodes": ce.graph.n_nodes}
        log(f"{self.tag} {label} (4 slots, {len(reqs)} requests): "
            f"{total} tokens in {wall:.2f} s ({out['tokens_per_s']:.1f} "
            f"tok/s), TTFT p50 {out['ttft_ms_p50']:.1f} ms, TPOT p50 "
            f"{out['tpot_ms_p50']:.2f} ms, {st.steps} steps = replays; "
            f"launches exact; tokens = the static B=1 Engine's")
        self.counters_zero(f"{self.tag} {label}", [ce.graph])
        self.pool_outputs = {"tokens": {o.uid: o.tokens for o in outs},
                             "admissions": admissions,
                             "max_seq": ce.max_seq}
        return out

    def tp_one_rank(self, engines, batch, new, cushion, in_turn=False):
        """Phase 4k's one-rank side of this model, from this phase's static
        engines (the same seed, cushion, scales and prompt as the two
        ranks'): each engine's request of ``static`` (its tokens, launches,
        TTFT / TPOT), the peak memory so far, the prefill as the rank
        program sees it (``prefill_view``: the logits, the cushion as the
        cache holds it) and the teacher-forced top-1 - top-2 margins along
        its tokens; and the cases the two ranks serve in phase 4k. Returns
        nothing; the record is ``TP_FAMILIES[arch]``."""
        import torch
        from repro_torch.core.calibration import scales_to_plain
        tp_probe = import_tp_probe()
        cpu = lambda t: t.detach().cpu()       # noqa: E731
        one, cases = {}, []
        for label, eng in engines.items():
            case = dict(
                cfg=self.cfg, seed=0, name=f"{self.cfg.name}/{label}",
                kind="static", qcfg=eng.qcfg,
                prequant=bool(eng.weight_bytes_int8),
                kv_dtype=eng.kv_dtype, max_seq=eng.max_seq,
                cushion=tree_map(cpu, cushion),
                scales=(None if eng.scales is None else
                        tree_map(cpu, scales_to_plain(eng.scales))),
                n_tokens=new, logits=True, in_turn=in_turn,
                **{k: cpu(v) for k, v in batch.items()})
            res, counts = self.static_runs[label]
            peak = torch.cuda.max_memory_allocated()
            # the request's own memory: the peak of its prefill and decode
            # steps (teacher-forced) above what the card held before
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            one[label] = dict(
                tp_probe.prefill_view(eng, batch), tokens=res.tokens,
                ttft_ms=res.ttft_ms, tpot_ms=res.tpot_ms, launches=counts,
                peak_bytes=peak,
                margins=tp_probe._margins(eng, batch, res.tokens))
            one[label]["request_bytes"] = \
                torch.cuda.max_memory_allocated() - held
            cases.append(case)
        TP_FAMILIES[self.cfg.name] = {"one": one, "cases": cases,
                                      "new": new, "in_turn": in_turn}
        torch.cuda.synchronize()
        log(f"{self.tag}: phase 4k's one-rank side recorded ("
            + ", ".join(f"{k}: tokens {v['tokens'].shape}, TTFT "
                        f"{v['ttft_ms']:.1f} ms, TPOT {v['tpot_ms']:.2f} ms"
                        for k, v in one.items()) + ")")

    def tp_one_rank_pool(self, reqs, static_eng, qcfg, cushion,
                         page_size=None, prequant=True, kv_dtype="int8",
                         in_turn=True):
        """Phase 4k's one-rank side of the pool just run (its tokens and
        admissions; paged with ``page_size``, else contiguous), with the
        teacher-forced margins of each request along its tokens from the
        static B = 1 engine, and the case the two ranks serve."""
        import numpy as np
        import torch
        from repro_torch.core.calibration import scales_to_plain
        tp_probe = import_tp_probe()
        cpu = lambda t: t.detach().cpu()       # noqa: E731
        po = self.pool_outputs
        # teacher-forced through the static engine a prompt length at a
        # time (its rows are independent: a row's margins are its B = 1
        # ones), each row's tokens padded to the group's longest budget
        margins = {}
        for n in sorted({r.batch["tokens"].shape[1] for r in reqs}):
            grp = [r for r in reqs if r.batch["tokens"].shape[1] == n]
            steps = max(len(po["tokens"][r.uid]) for r in grp)
            toks = np.zeros((len(grp), steps), np.int64)
            for i, r in enumerate(grp):
                toks[i, :len(po["tokens"][r.uid])] = po["tokens"][r.uid]
            mg = tp_probe._margins(static_eng, {
                k: torch.cat([r.batch[k] for r in grp])
                for k in grp[0].batch}, toks)
            for i, r in enumerate(grp):
                margins[r.uid] = mg[i, :len(po["tokens"][r.uid])]
        paged = page_size is not None
        key = "paged" if paged else "contiguous"
        case = dict(
            cfg=self.cfg, seed=0, name=f"{self.cfg.name}/{key}_pool",
            kind="continuous", qcfg=qcfg, prequant=prequant,
            kv_dtype=kv_dtype, paged=paged, page_size=page_size or 64,
            n_slots=4, max_seq=po["max_seq"],
            cushion=tree_map(cpu, cushion),
            scales=(None if static_eng.scales is None else
                    tree_map(cpu, scales_to_plain(static_eng.scales))),
            requests=[dict({k: cpu(v) for k, v in r.batch.items()},
                           max_new_tokens=r.max_new_tokens) for r in reqs],
            in_turn=in_turn)
        rec = TP_FAMILIES[self.cfg.name]
        rec["cases"].append(case)
        rec["pool"] = {"tokens": po["tokens"], "admissions":
                       po["admissions"], "margins": margins,
                       "seconds": self.rec[key]["wall_s"]}
        rec["pool_launches"] = self.rec[key]["launches"]
        torch.cuda.synchronize()
        log(f"{self.tag}: phase 4k's one-rank pool recorded, margins "
            f"min {min(float(np.min(m)) for m in margins.values()):.4g}")

    def method(self, sample_fn, tune_b, search_want, tune_want, check=None,
               sample_len=SAMPLE_LEN):
        """``discover`` under pt_dynamic (16 candidates, the prefix padded
        to MAX_PREFIX rows, 2 seed tokens) and FAM_TUNE_STEPS tuning steps,
        launches exact (``search_want(iterations)``, ``tune_want``).
        ``check(greedy, tuned)`` adds the family's own checks."""
        import numpy as np
        import torch
        from repro_torch.configs import CushionConfig, QuantConfig
        from repro_torch.core import cushioncache as CC
        from repro_torch.kernels import _lib
        qdyn = QuantConfig(mode="pt_dynamic")
        ccfg = CushionConfig(max_prefix_len=MAX_PREFIX, tau=1.0,
                             sample_len=sample_len,
                             n_candidates=FAM_CANDIDATES,
                             seed_tokens=FAM_SEEDS, lam=0.05,
                             tune_steps=FAM_TUNE_STEPS, tune_lr=1e-3,
                             log_every=FAM_TUNE_STEPS)
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy, sr, _ = CC.discover(self.api, self.params, sample_fn,
                                    iter(()), qdyn, ccfg,
                                    torch.Generator().manual_seed(2),
                                    skip_tune=True, verbose=False)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        counts = dict(_lib.LAUNCHES)
        n_it = len(sr.history)
        want = {**self.zero_counts, **search_want(n_it, ccfg)}
        if counts != want or not 1 <= n_it <= MAX_PREFIX - len(FAM_SEEDS):
            fail(f"{self.tag} search: {n_it} iterations, launches {counts},"
                 f" expected {want}")
        self.add_launches(counts)
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = CC.prefix_tune(self.api, self.params, greedy, iter(tune_b),
                            qdyn, ccfg, verbose=False)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        counts = dict(_lib.LAUNCHES)
        want = {**self.zero_counts, **tune_want}
        if counts != want:
            fail(f"{self.tag} tune: launches {counts}, expected {want}")
        if len(tr.log) != FAM_TUNE_STEPS or not all(
                np.isfinite(r[k]) for r in tr.log for k in r):
            fail(f"{self.tag} tune: log {tr.log}")
        from repro_torch.optim.adamw import tree_leaves
        if all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.cushion),
                                                 tree_leaves(greedy))):
            fail(f"{self.tag} tune: the cushion did not move")
        if check is not None:
            check(greedy, tr.cushion)
        self.add_launches(counts)
        self.rec["method"] = {
            "prefix_ids": [int(t) for t in sr.prefix_ids],
            "history": sr.history, "search_s": search_s, "iterations": n_it,
            "tune_s": tune_s, "tune_s_per_step": tune_s / FAM_TUNE_STEPS,
            "tune_log": tr.log,
            "peak_mem_bytes_so_far": torch.cuda.max_memory_allocated()}
        log(f"{self.tag} method: prefix {self.rec['method']['prefix_ids']} "
            f"in {search_s:.2f} s ({n_it} iterations); {FAM_TUNE_STEPS} "
            f"tuning steps in {tune_s:.2f} s, loss {tr.log[0]['loss']:.4f} "
            f"-> {tr.log[-1]['loss']:.4f}; launches exact; peak device "
            f"memory so far "
            f"{self.rec['method']['peak_mem_bytes_so_far'] / 2 ** 30:.2f} GiB")

    def card_vs_cpu(self, cfg2, p2, cush2, calib2, prompt, modes, n_tok,
                    tols=MOE_LOGIT_TOL):
        """The card's teacher-forced logits against the port's CPU version
        on a cut model (``cfg2``, ``p2``) in each mode, within ``tols``
        ({mode: (largest, mean)}); the prefill's (token, MoE layer) pairs
        that the two sides route to other experts are counted. The modes
        with int8-resident weights serve scales calibrated once, on the
        card, on ``calib2``. The card's half runs here; the CPU's runs in
        the CPU worker (``CpuHalves``) and the comparison is made at the
        join, into ``self.rec["card_vs_cpu"]``."""
        import torch
        from repro_torch.core.calibration import calibrate
        from repro_torch.models.registry import build
        from repro_torch.serving.engine import Engine
        cpu = lambda t: t.detach().cpu()       # noqa: E731
        api2 = build(cfg2, "cuda")
        static = [q for q, _, pre in modes.values() if pre]
        sc2 = (calibrate(api2, p2, calib2, static[0], cushion=cush2)[0]
               if static else None)
        card, jobs = {}, {}
        for label, (qcfg, kv, pre) in modes.items():
            t0 = time.perf_counter()
            sc_card = sc2 if pre else None
            eng2 = Engine(api2, p2, qcfg, cushion=cush2, scales=sc_card,
                          max_seq=256, kv_dtype=kv, prequant=pre)
            toks = eng2.generate(prompt, n_tok).tokens
            del eng2
            routing = []
            lc = family_trajectory(api2, p2, qcfg, kv, sc_card, cush2, pre,
                                   prompt, toks, routing)
            card[label] = (lc, routing, time.perf_counter() - t0)
            jobs[label] = (qcfg, kv, pre, toks)
        CPU_HALVES.submit(self.tag, cpu_family_half, {
            "cfg": cfg2, "params": tree_map(cpu, p2.tree()),
            "cushion": tree_map(cpu, cush2),
            "scales": None if sc2 is None else tree_map(cpu, sc2),
            "prompt": {k: cpu(v) for k, v in prompt.items()},
            "modes": jobs})
        rec = self.rec["card_vs_cpu"] = {"n_layers": cfg2.n_layers}
        tag, positions = self.tag, self.positions(prompt)

        def compare():
            got = CPU_HALVES.result(tag)
            for label in modes:
                lc, r_card, card_s = card[label]
                lp = torch.from_numpy(got[label][0])
                r_cpu = [torch.from_numpy(r) for r in got[label][1]]
                err = (lc - lp).abs()
                max_tol, mean_tol = tols[label]
                pairs = list(zip(r_card, r_cpu))
                cmp = {"max_abs_err": float(err.max()),
                       "mean_abs_err": float(err.mean()),
                       "max_abs_logit": float(lp.abs().max()),
                       "prefill_tokens_with_other_experts": sum(
                           int((a.sort(-1).values != b.sort(-1).values)
                               .any(-1).sum()) for a, b in pairs),
                       "prefill_token_layers": sum(a[..., 0].numel()
                                                   for a, _ in pairs),
                       "tol_max": max_tol, "tol_mean": mean_tol,
                       "card_seconds": card_s,
                       "cpu_half": CPU_HALVES.seconds[tag]}
                rec[label] = cmp
                log(f"{tag} card vs CPU, {label} ({cfg2.n_layers} layers, "
                    f"B=1, {positions} positions, {n_tok} logits rows): "
                    f"max |err| {cmp['max_abs_err']:.4g} (tolerance "
                    f"{max_tol}), mean {cmp['mean_abs_err']:.4g} (tolerance "
                    f"{mean_tol}), max |logit| {cmp['max_abs_logit']:.3g}; "
                    f"prefill (token, MoE layer) pairs routed to other "
                    f"experts {cmp['prefill_tokens_with_other_experts']} of "
                    f"{cmp['prefill_token_layers']}; card half "
                    f"{card_s:.1f} s, CPU half in the worker")
                if cmp["max_abs_err"] > max_tol \
                        or cmp["mean_abs_err"] > mean_tol:
                    fail(f"{tag} {label}: card and CPU logits differ "
                         f"beyond the stated tolerance")
        CPU_HALVES.later(compare)

    def done(self):
        import torch
        self.rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        self.rec["seconds"] = time.perf_counter() - self.t0
        log(f"{self.tag}: peak device memory "
            f"{self.rec['peak_mem_bytes'] / 2 ** 30:.2f} GiB; phase launches "
            f"{self.rec['launches']}")
        return self.rec


def moe_phase(dev, corpus, calib, batch, ps, zero_counts, counters_zero,
              timed):
    """Phase 4e: olmoe-1b-7b at full width (see the module docstring).
    Returns the record; the model, its engines and graphs are released
    when it returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core import cushioncache as CC
    from repro_torch.core import quantization as TQ
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.launch.serve import (poisson_trace, seeded_cushion,
                                          to_device)
    from repro_torch.models import moe as MO
    from repro_torch.models.common import ParamTree
    from repro_torch.serving.engine import cache_seq_len

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    run = FamilyRun(MOE_ARCH, cfg, dev, zero_counts, counters_zero)
    api, params, rec = run.api, run.params, run.rec
    L, V, E = cfg.n_layers, cfg.vocab_size, cfg.moe.num_experts
    D, Fd, K = cfg.d_model, cfg.d_ff, cfg.moe.top_k
    rec["capacity_factor"] = cfg.moe.capacity_factor
    if params.tree()["layers"]["moe"]["router"].dtype != torch.float32:
        fail("olmoe: the router is not f32 in the bf16 model")
    cushion = seeded_cushion(api, params, CUSHION, seed=0)
    qw8 = QuantConfig(mode="pt_static", true_int8=True)

    # 1. the static Engine, W8A8 (int8 attention and head, fp experts,
    # int8 KV) and fp
    sites = 2 * L + 1                       # qkv, o per layer and the head
    attn = {"flash_attention": L, "flash_decode": L * (MOE_NEW - 1)}
    expect = {"w8a8_int8kv": {**zero_counts, **attn,
                              "w8a8_matmul": sites * MOE_NEW,
                              "act_quant_static": 2 * L,
                              "act_quant_static_fused":
                                  1 + sites * (MOE_NEW - 1)},
              "fp": {**zero_counts, **attn}}
    modes = {"w8a8_int8kv": (qw8, "int8", True), "fp": (QuantConfig(), None,
                                                        False)}
    engines = run.static(batch, MOE_NEW, cushion, calib, expect, modes)
    w8 = engines["w8a8_int8kv"]
    run.tp_one_rank(engines, {"tokens": batch["tokens"]}, MOE_NEW, cushion)
    fp_bytes = rec["static"]["fp"]["weight_bytes_fp"]
    if not (w8.weight_bytes_int8 > 0 and w8.weight_bytes_fp < fp_bytes):
        fail("olmoe: prequantization did not shrink the fp bytes")

    # where a replayed W8A8 decode step's time goes: the graph profiled
    # (its total and the ported kernels by name), and the MoE's parts
    # timed alone at the step's shapes, once per layer
    with torch.inference_mode():
        st, _ = w8._run_prefill(batch)
        st.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                st.step()
            torch.cuda.synchronize()
    rows = by_kernel(prof, 4, top=None)
    step_ms = sum(v[1] for v in rows.values())
    ported_ms = sum(v[1] for k_, v in rows.items() if PORTED.search(k_))
    lp = {k_: v[0] for k_, v in params.tree()["layers"]["moe"].items()}
    sc = {s_: TQ.SiteScale(w8.scales[s_].scale[0], w8.scales[s_].zero[0])
          for s_ in ("mlp_in", "down")}
    C1 = MO.capacity(1, cfg)
    g = torch.Generator(dev).manual_seed(9)
    x1 = torch.randn(B, 1, D, generator=g, device=dev).to(torch.bfloat16)
    xq = torch.randn(B, E, C1, D, generator=g, device=dev).to(torch.bfloat16)
    hq = torch.randn(B, E, C1, Fd, generator=g, device=dev) \
        .to(torch.bfloat16)
    wq = {k_: TQ.weight_fake_quant(lp[k_], qw8)
          for k_ in ("w_up", "w_gate", "w_down")}

    def wfq():
        for k_ in ("w_up", "w_gate", "w_down"):
            TQ.weight_fake_quant(lp[k_], qw8)

    def experts():
        up = torch.einsum("becd,edf->becf", xq, wq["w_up"])
        gate = torch.einsum("becd,edf->becf", xq, wq["w_gate"])
        h = torch.nn.functional.silu(gate) * up
        torch.einsum("becf,efd->becd", h, wq["w_down"])

    def dispatch():
        _, top_w, idx = MO.route(x1, lp["router"], K)
        onehot = (idx[..., None] == torch.arange(E, device=dev)).float()
        disp = MO.dispatch(onehot, C1).to(x1.dtype)
        comb = torch.einsum("bsk,bskec->bsec", top_w.to(x1.dtype), disp)
        torch.einsum("bsec,bsd->becd", disp.sum(2), x1)
        torch.einsum("bsec,becd->bsd", comb, xq)

    def act_fq():
        TQ.act_fake_quant(xq, qw8, sc["mlp_in"].scale, sc["mlp_in"].zero)
        TQ.act_fake_quant(hq, qw8, sc["down"].scale, sc["down"].zero)

    with torch.inference_mode():
        parts = {"weight_fake_quant": L * timed(wfq, iters=3),
                 "expert_einsums": L * timed(experts, iters=5),
                 "dispatch_combine": L * timed(dispatch, iters=5),
                 "act_fake_quant": L * timed(act_fq, iters=5)}
    del wq
    expert_bytes = 3 * E * D * Fd * 2 * L
    rec["decode_step"] = {
        "device_ms": step_ms, "ported_kernels_ms": ported_ms,
        "parts_timed_alone_ms": parts,
        "rest_ms": step_ms - ported_ms - sum(parts.values()),
        "rest_is": "the graph's total minus the ported kernels and the "
                   "parts timed alone: norms, RoPE, the KV writes, the "
                   "residual adds, the head's argmax",
        "expert_weight_bytes": expert_bytes,
        "bound_ms_expert_weights_once": expert_bytes / HBM_BYTES_PER_S * 1e3,
        "by_kernel_top": dict(list(rows.items())[:12]),
        "kernels_per_step": sum(v[0] for v in rows.values())}
    log(f"olmoe W8A8 decode step (graph replay, B={B}): device "
        f"{step_ms:.2f} ms; ported kernels {ported_ms:.3f} ms; timed alone "
        f"x {L} layers: "
        + ", ".join(f"{k_} {v:.2f} ms" for k_, v in parts.items())
        + f"; rest {rec['decode_step']['rest_ms']:.2f} ms; bound of reading "
        f"the expert weights once {rec['decode_step']['bound_ms_expert_weights_once']:.2f}"
        f" ms")

    # olmoe's shapes through every ported kernel of the path, against the
    # plain versions
    H, hd = cfg.n_heads, cfg.head_dim
    rec["kernels"] = family_kernels(
        "olmoe-1b-7b", cfg, dev, timed,
        {"qkv": (D, (H + 2 * cfg.n_kv_heads) * hd, L), "o": (H * hd, D, L),
         "head": (D, V, 1)},
        L, PROMPT, CUSHION + PROMPT + MOE_NEW // 2,
        cache_seq_len(PROMPT + MOE_NEW + 32),
        cache_seq_len(max(FAM_PROMPTS) + max(FAM_BUDGETS) + 32), TUNE_S)

    # 2. the continuous path: 4 paged int8 slots, 8 requests at t = 0
    reqs = poisson_trace(api, 3, FAM_REQ, 0.0, FAM_PROMPTS, FAM_BUDGETS)
    rec["continuous"] = run.pool(
        "paged pool", reqs, w8, qw8, w8.scales, cushion,
        lambda n, s_: {"w8a8_matmul": sites * (n + s_),
                       "act_quant_static": 2 * L * n,
                       "act_quant_static_fused": n + sites * s_,
                       "flash_attention": L * n,
                       "flash_decode_paged": L * s_},
        paged=True, page_size=ps)
    counters_zero("phase 4e", [s_.graph for e in engines.values()
                               for s_ in e.states.values()])

    # 3. the method: a short discover (pt_dynamic, the KV-reuse search) and
    # prefix tuning, launches exact
    samples = [to_device(Pipeline(corpus, batch=1, seq_len=SAMPLE_LEN,
                                  seed=1).get_batch(i), dev)
               for i in range(MAX_PREFIX)]
    tune_pipe = Pipeline(corpus, batch=TUNE_B, seq_len=TUNE_S, seed=2)
    tune_b = [to_device(tune_pipe.get_batch(3000 + i), dev)
              for i in range(FAM_TUNE_STEPS)]

    def search_want(n_it, ccfg):
        n_pool = CC._pool_pad_len(V, ccfg, SEARCH_CHUNK)
        return {"flash_attention":
                L * (n_it * (2 + n_pool // SEARCH_CHUNK) + 1)}

    run.method(lambda i: samples[i], tune_b, search_want,
               {"flash_attention": L * FAM_TUNE_STEPS,
                "flash_attention_bwd": L * FAM_TUNE_STEPS})
    del samples, tune_b

    # 4. card against CPU at 2 layers of the full width, fp and W8A8
    cfg2 = dataclasses.replace(cfg, n_layers=MOE_CMP_LAYERS)
    tree = params.tree()
    cut = lambda t: tree_map(lambda a: a[:MOE_CMP_LAYERS], t)  # noqa: E731
    p2 = ParamTree({**tree, "layers": cut(tree["layers"])})
    run.card_vs_cpu(cfg2, p2, {"kv": cut(cushion["kv"])}, calib[:1],
                    {"tokens": batch["tokens"][:1, :MOE_CMP_PROMPT]}, modes,
                    MOE_CMP_TOKENS)
    return run.done()


def vlm_phase(dev, zero_counts, counters_zero, timed):
    """Phase 4f: internvl2-26b at full width and VLM_LAYERS of its 48
    layers (see the module docstring)."""
    import torch
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.launch.serve import poisson_trace, seeded_cushion
    from repro_torch.models.common import ParamTree
    from repro_torch.serving.engine import cache_seq_len

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    run = FamilyRun("internvl2-26b", cfg, dev, zero_counts, counters_zero)
    api, params, rec = run.api, run.params, run.rec
    L, V, Pn = cfg.n_layers, cfg.vocab_size, cfg.vlm.num_patches
    n_pos = Pn + VLM_TEXT
    rec["patches"], rec["text_tokens"] = Pn, VLM_TEXT

    def draw(seed, b, n):
        return api.make_batch(torch.Generator(dev).manual_seed(seed), b, n)

    batch = {k: v for k, v in draw(1, B, n_pos).items() if k != "labels"}
    calib = [draw(1000 + i, B, n_pos) for i in range(2)]
    cushion = seeded_cushion(api, params, CUSHION, seed=0)
    qw8 = QuantConfig(mode="pt_static", true_int8=True)

    # 1. the static Engine: [patches; text] prefill, 32 new tokens
    sites = 5 * L + 1          # qkv, o, up, gate, down a layer; the head
    attn = {"flash_attention": L, "flash_decode": L * (VLM_NEW - 1)}
    expect = {"w8a8_int8kv": {**zero_counts, **attn,
                              "w8a8_matmul": sites * VLM_NEW,
                              "act_quant_static": 5 * L,
                              "act_quant_static_fused":
                                  1 + sites * (VLM_NEW - 1)},
              "fp": {**zero_counts, **attn}}
    modes = {"w8a8_int8kv": (qw8, "int8", True),
             "fp": (QuantConfig(), None, False)}
    engines = run.static(batch, VLM_NEW, cushion, calib, expect, modes)
    w8 = engines["w8a8_int8kv"]
    run.tp_one_rank(engines, batch, VLM_NEW, cushion)
    D, Fd, H, K, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    rec["kernels"] = family_kernels(
        "internvl2-26b", cfg, dev, timed,
        {"qkv": (D, (H + 2 * K) * hd, L), "o": (H * hd, D, L),
         "mlp_in": (D, Fd, 2 * L), "down": (Fd, D, L), "head": (D, V, 1)},
        L, n_pos, CUSHION + n_pos + VLM_NEW // 2,
        cache_seq_len(n_pos + VLM_NEW + 32),
        cache_seq_len(Pn + max(FAM_PROMPTS) + max(FAM_BUDGETS) + 32),
        Pn + TUNE_S)

    # 2. a paged int8 pool over 8 requests with patches
    reqs = poisson_trace(api, 3, FAM_REQ, 0.0,
                         tuple(Pn + p for p in FAM_PROMPTS), FAM_BUDGETS)
    rec["paged"] = run.pool(
        "paged pool", reqs, w8, qw8, w8.scales, cushion,
        lambda n, s: {"w8a8_matmul": sites * (n + s),
                      "act_quant_static": 5 * L * n,
                      "act_quant_static_fused": n + sites * s,
                      "flash_attention": L * n,
                      "flash_decode_paged": L * s},
        paged=True, page_size=64)
    run.counters_zero("internvl2-26b static",
                      [s.graph for e in engines.values()
                       for s in e.states.values()])
    del engines, w8              # the engines' caches and int8 copies
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the method: the KV-reuse search with each candidate before the
    # patches, and the tuning
    samples = [{k: v for k, v in draw(5000 + i, 1, Pn + SAMPLE_LEN).items()
                if k != "labels"} for i in range(MAX_PREFIX)]
    tune_b = [draw(3000 + i, TUNE_B, Pn + TUNE_S)
              for i in range(FAM_TUNE_STEPS)]

    def search_want(n_it, ccfg):
        from repro_torch.core import cushioncache as CC
        n_pool = CC._pool_pad_len(V, ccfg, SEARCH_CHUNK)
        return {"flash_attention":
                L * (n_it * (2 + n_pool // SEARCH_CHUNK) + 1)}

    run.method(lambda i: samples[i], tune_b, search_want,
               {"flash_attention": L * FAM_TUNE_STEPS,
                "flash_attention_bwd": L * FAM_TUNE_STEPS})
    del samples, tune_b

    # 4. card against CPU at 2 of the layers, 64 patches + 64 tokens
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    tree = params.tree()
    cut = lambda t: (tree_map(lambda a: a[:2], t))   # noqa: E731
    p2 = ParamTree({**tree, "layers": cut(tree["layers"])})
    prompt = {"tokens": batch["tokens"][:1, :FAM_CMP_PROMPT],
              "patches": batch["patches"][:1, :FAM_CMP_PROMPT]}
    calib2 = [{"tokens": calib[0]["tokens"][:, :FAM_CMP_PROMPT],
               "patches": calib[0]["patches"][:, :FAM_CMP_PROMPT]}]
    run.card_vs_cpu(cfg2, p2, {"kv": cut(cushion["kv"])}, calib2, prompt,
                    modes, VLM_CMP_TOKENS)
    return run.done()


def hybrid_phase(dev, zero_counts, counters_zero, timed):
    """Phase 4g: jamba-v0.1-52b at full width and one period (see the
    module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.launch.serve import poisson_trace, seeded_cushion
    from repro_torch.models import hybrid as HY
    from repro_torch.models import ssm as SSM
    from repro_torch.models.common import ParamTree
    from repro_torch.serving.engine import cache_seq_len

    full = get_config(HY_ARCH)
    cfg = dataclasses.replace(full, n_layers=full.hybrid.period)
    run = FamilyRun("jamba-v0.1-52b", cfg, dev, zero_counts, counters_zero)
    api, params, rec = run.api, run.params, run.rec
    V = cfg.vocab_size
    n_per, kinds = HY.layout(cfg)
    nm = HY.n_mamba_per_period(cfg)
    n_dense = sum(1 for _, m in kinds if m == "dense")
    n_attn = n_per * sum(1 for m, _ in kinds if m == "attn")
    rec["layout"] = kinds

    def draw(seed, b, n):
        return api.make_batch(torch.Generator(dev).manual_seed(seed), b, n)

    batch = {"tokens": draw(1, B, PROMPT)["tokens"]}
    calib = [draw(1000 + i, B, PROMPT) for i in range(2)]
    cushion = seeded_cushion(api, params, CUSHION, seed=0)
    qw8 = QuantConfig(mode="pt_static", true_int8=True)

    # 1. the static Engine, 16 new tokens
    layer_sites = n_per * (2 * (n_attn // n_per) + 2 * nm + 3 * n_dense)
    sites = layer_sites + 1
    attn = {"flash_attention": n_attn, "flash_decode": n_attn * (HY_NEW - 1)}
    expect = {"w8a8_int8kv": {**zero_counts, **attn,
                              "w8a8_matmul": sites * HY_NEW,
                              "act_quant_static": layer_sites,
                              "act_quant_static_fused":
                                  1 + sites * (HY_NEW - 1)},
              "fp": {**zero_counts, **attn}}
    modes = {"w8a8_int8kv": (qw8, "int8", True),
             "fp": (QuantConfig(), None, False)}
    engines = run.static(batch, HY_NEW, cushion, calib, expect, modes)
    w8 = engines["w8a8_int8kv"]
    # phase 4k's ranks build this period in turn: one whole tree on the
    # card at a time
    run.tp_one_rank(engines, batch, HY_NEW, cushion, in_turn=True)

    # the Mamba scan's cost at the prefill's shape (B x PROMPT), one
    # sublayer timed alone, times the period's nm sublayers
    inner, N, _, _ = SSM.dims(cfg)
    g = torch.Generator(dev).manual_seed(5)
    dt_ = torch.rand((B, PROMPT, inner), generator=g, device=dev) * 0.1
    xc = torch.randn((B, PROMPT, inner), generator=g, device=dev) \
        .to(torch.bfloat16)
    Bm = torch.randn((B, PROMPT, N), generator=g, device=dev)
    Cm = torch.randn((B, PROMPT, N), generator=g, device=dev)
    A = -torch.exp(params.tree()["layers"]["sub"][0]["mamba"]["A_log"][0])
    h0 = torch.zeros((B, inner, N), device=dev)
    with torch.inference_mode():
        SSM._scan(dt_, xc, Bm, Cm, A, h0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            SSM._scan(dt_, xc, Bm, Cm, A, h0)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    scan_rows = by_kernel(prof, 1, top=None)
    dev_ms = sum(v[1] for v in scan_rows.values())
    scan_bytes = B * PROMPT * (2 * inner + 2 * N + inner) * 4
    rec["mamba_scan"] = {
        "unit": f"one Mamba sublayer's scan at B={B}, S={PROMPT}, "
                f"inner={inner}, N={N}; x {n_per * nm} a prefill",
        "device_ms": dev_ms, "wall_ms": wall,
        "device_ms_per_prefill": n_per * nm * dev_ms,
        "wall_ms_per_prefill": n_per * nm * wall,
        "kernels": sum(v[0] for v in scan_rows.values()),
        "bound_ms_inputs_once": scan_bytes / HBM_BYTES_PER_S * 1e3,
        "by_kernel_top": dict(list(scan_rows.items())[:6])}
    log(f"jamba Mamba scan ({rec['mamba_scan']['unit']}): device "
        f"{dev_ms:.3f} ms, wall {wall:.2f} ms in "
        f"{rec['mamba_scan']['kernels']:.0f} kernels (the position-by-"
        f"position loop it replaced: 5.83 ms device, 18.5 ms wall, 541 "
        f"kernels, PERF.md section 5); a prefill "
        f"{rec['mamba_scan']['device_ms_per_prefill']:.2f} ms device, "
        f"{rec['mamba_scan']['wall_ms_per_prefill']:.2f} ms wall")
    del dt_, xc, Bm, Cm, h0, prof

    D, Fd, H, K, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    rec["kernels"] = family_kernels(
        "jamba-v0.1-52b", cfg, dev, timed,
        {"qkv": (D, (H + 2 * K) * hd, n_attn), "o": (H * hd, D, n_attn),
         "mamba_in": (D, 2 * inner, n_per * nm),
         "mamba_out": (inner, D, n_per * nm),
         "mlp_in": (D, Fd, 2 * n_per * n_dense),
         "down": (Fd, D, n_per * n_dense), "head": (D, V, 1)},
        n_attn, PROMPT, CUSHION + PROMPT + HY_NEW // 2,
        cache_seq_len(PROMPT + HY_NEW + 32),
        cache_seq_len(max(FAM_PROMPTS) + max(FAM_BUDGETS) + 32), TUNE_S)

    # 2. a contiguous and a paged int8 pool over 8 requests
    reqs = poisson_trace(api, 3, FAM_REQ, 0.0, FAM_PROMPTS, FAM_BUDGETS)

    def pool_want(decode):
        return lambda n, s: {"w8a8_matmul": sites * (n + s),
                             "act_quant_static": layer_sites * n,
                             "act_quant_static_fused": n + sites * s,
                             "flash_attention": n_attn * n,
                             decode: n_attn * s}

    rec["contiguous"] = run.pool("contiguous pool", reqs, w8, qw8,
                                 w8.scales, cushion,
                                 pool_want("flash_decode"))
    rec["paged"] = run.pool("paged pool", reqs, w8, qw8, w8.scales, cushion,
                            pool_want("flash_decode_paged"), paged=True,
                            page_size=64)
    run.tp_one_rank_pool(reqs, w8, qw8, cushion, 64)
    run.counters_zero("jamba static", [s.graph for e in engines.values()
                                       for s in e.states.values()])
    del engines, w8              # the engines' caches and int8 copies
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the method: greedy_search_ref (no KV-reuse scoring for a
    # recurrence) and the tuning; the Mamba state never trains
    samples = [{"tokens": draw(5000 + i, 1, SAMPLE_LEN)["tokens"]}
               for i in range(MAX_PREFIX)]
    tune_b = [draw(3000 + i, TUNE_B, TUNE_S) for i in range(FAM_TUNE_STEPS)]

    def search_want(n_it, ccfg):
        # a base forward and one chunk of candidates an iteration, and the
        # extraction's prefill
        from repro_torch.core import cushioncache as CC
        n_pool = CC._pool_pad_len(V, ccfg, SEARCH_CHUNK)
        return {"flash_attention":
                n_attn * (n_it * (1 + n_pool // SEARCH_CHUNK) + 1)}

    def state_frozen(greedy, tuned):
        for k in ("h", "conv"):
            if not torch.equal(tuned["state"][k], greedy["state"][k]):
                fail(f"jamba tune: the cushion's Mamba state {k} moved")
        log("jamba tune: the cushion's Mamba state (h, conv) is "
            "bit-identical after tuning")

    if api.supports_kv_scoring:
        fail("jamba: the hybrid must search with greedy_search_ref")
    run.method(lambda i: samples[i], tune_b, search_want,
               {"flash_attention": n_attn * FAM_TUNE_STEPS,
                "flash_attention_bwd": n_attn * FAM_TUNE_STEPS},
               check=state_frozen)
    del samples, tune_b

    # 4. card against CPU: a two-layer period at full width, the first
    # Mamba sublayer (dense MLP) and the attention sublayer (MoE)
    i_m = next(i for i, (m, f) in enumerate(kinds)
               if m == "mamba" and f == "dense")
    i_a = next(i for i, (m, f) in enumerate(kinds) if m == "attn")
    if kinds[i_a][1] != "moe":
        fail("jamba: the attention sublayer carries no MoE")
    cfg2 = dataclasses.replace(cfg, n_layers=2, hybrid=dataclasses.replace(
        cfg.hybrid, period=2, attn_at=(1,), moe_every=2, moe_offset=1))
    if HY.layout(cfg2)[1] != [kinds[i_m], kinds[i_a]]:
        fail(f"jamba: the cut period is {HY.layout(cfg2)[1]}")
    tree = params.tree()
    p2 = ParamTree({**tree, "layers": {"sub": [tree["layers"]["sub"][i_m],
                                               tree["layers"]["sub"][i_a]]}})
    mi = sum(1 for m, _ in kinds[:i_m] if m == "mamba")
    cush2 = {"kv": cushion["kv"],
             "state": {k: v[:, mi:mi + 1]
                       for k, v in cushion["state"].items()}}
    prompt = {"tokens": batch["tokens"][:1, :FAM_CMP_PROMPT]}
    calib2 = [{"tokens": calib[0]["tokens"][:1, :FAM_CMP_PROMPT]}]
    rec["card_vs_cpu_cut"] = (f"a two-layer period of full width: sublayer "
                              f"{i_m} {kinds[i_m]} and {i_a} {kinds[i_a]}")
    run.card_vs_cpu(cfg2, p2, cush2, calib2, prompt, modes, HY_CMP_TOKENS)
    return run.done()


# phase 3 at stablelm-3b's shapes (32 heads of 80 over 32 KV heads, bf16:
# head_dim 80, no power of two) and phase 4o, stablelm-3b serving at full
# width and 4 of its 32 layers (as phase 4k cuts deepseek-67b), B = 4 x
# 512 and 64 new tokens
SL_ARCH, SL_LAYERS, SL_NEW = "stablelm-3b", 4, 64
SL_POS = PROMPT + NEW_TOKENS          # the decode rows' position, 576


def head_dim_80_rows(dev, timed):
    """Rows 4, 5, 6 and 8 of the kernel table at stablelm-3b's shapes:
    ``flash_attention`` (B = 4, S = 512 behind the 4-row cushion) within one
    bf16 ulp of its plain version, timed beside its bound and SDPA with the
    same boolean mask; ``flash_decode`` and ``flash_decode_paged`` (int8,
    (B, K) scales, pos 576, the paged pool a shuffled table of 64-position
    pages) within one bf16 ulp, the paged kernel ``torch.equal`` to the
    contiguous one on the gathered pool, timed beside their bounds and SDPA
    on the dequantized bf16 cache (not the same inputs: no PyTorch call
    reads int8 with scales); ``flash_attention_bwd`` (the same shape, the
    cushion live) within one bf16 ulp plus 1e-5 of the largest entry, two
    calls ``torch.equal``, timed beside its bound and SDPA's forward +
    backward against the kernels' forward + backward. Returns {kernel:
    row}, one call a row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain)
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_plain,
        flash_decode_plain, gather_pages)
    from repro_torch.serving.engine import cache_seq_len

    cfg = get_config(SL_ARCH)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if hd != 80:
        fail(f"{SL_ARCH}: head_dim {hd}, not 80")
    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(80)
    rows = {}

    def within(name, got, want, floor=1e-6):
        err = (got.float() - want.float()).abs()
        if not bool((err <= BF16_ULP * want.float().abs() + floor).all()):
            fail(f"head_dim 80 {name}: {float(err.max()):.3g} beyond one "
                 f"bf16 ulp")
        return float(err.max())

    def sdpa(fn, what):
        try:
            return timed(fn)
        except (RuntimeError, TypeError) as e:
            log(f"scaled_dot_product_attention {what} not timed: {e}")
            return None

    S, m = PROMPT, CUSHION
    T = S + m
    q = torch.randn((B, H, S, hd), generator=g, device=dev).to(bf)
    k = torch.randn((B, K, T, hd), generator=g, device=dev).to(bf)
    v = torch.randn((B, K, T, hd), generator=g, device=dev).to(bf)
    err = within("flash_attention", flash_attention(q, k, v, prefix_len=m),
                 flash_attention_plain(q, k, v, prefix_len=m))
    i_ = torch.arange(S, device=dev)[:, None]
    j_ = torch.arange(T, device=dev)[None, :]
    vis = (j_ < m) | (j_ <= i_ + m)
    pairs = B * H * (S * m + S * (S + 1) / 2)
    bms, by = bound_ms(2 * (2 * B * H * S * hd + 2 * B * K * T * hd),
                       4.0 * hd * pairs, BF16_FLOPS_PER_S)
    rows["flash_attention"] = {
        "unit": f"one call (B={B}, S={S}, m={m}, {H} heads of {hd}, G=1)",
        "ms": timed(lambda: flash_attention(q, k, v, prefix_len=m)),
        "plain_ms": timed(lambda: flash_attention_plain(q, k, v,
                                                        prefix_len=m), 3),
        "bound_ms": bms, "bound_by": by, "max_abs_err": err,
        "library_ms": sdpa(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=vis), "forward"),
        "library_of": "scaled_dot_product_attention with the same boolean "
                      "mask"}

    # the backward: the kernels' forward (writing the log-sum-exp) and
    # backward against the plain backward on the same output and lse
    do = torch.randn(q.shape, generator=g, device=dev).to(bf)
    o, lse = _launch(q, k, v, m, m, with_lse=True)
    ba = (q, k, v, o, lse, do, m, m)
    got1 = flash_attention_bwd(*ba)
    got2 = flash_attention_bwd(*ba)
    errs = []
    for a_, b_, want_ in zip(got1, got2, flash_attention_bwd_plain(*ba)):
        if not torch.equal(a_, b_):
            fail("head_dim 80 flash_attention_bwd: two calls differ")
        errs.append(within("flash_attention_bwd", a_, want_,
                           1e-5 * float(want_.float().abs().max())))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        flash_attention(qg, kg, vg, prefix_len=m).backward(do)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg,
                                       attn_mask=vis).backward(do)
    bms, by = bound_ms(2 * (4 * B * H * S * hd + 4 * B * K * T * hd)
                       + 4 * B * H * S, 10.0 * hd * pairs, BF16_FLOPS_PER_S)
    rows["flash_attention_bwd"] = {
        "unit": f"one call (B={B}, S={S}, m={m} live, {H} heads of {hd})",
        "ms": timed(lambda: flash_attention_bwd(*ba)),
        "plain_ms": timed(lambda: flash_attention_bwd_plain(*ba), 3),
        "bound_ms": bms, "bound_by": by, "max_abs_err": max(errs),
        "fwd_bwd_ms": timed(fwd_bwd),
        "library_ms": sdpa(sdpa_fwd_bwd, "forward + backward"),
        "library_of": "scaled_dot_product_attention forward + backward "
                      "with the same boolean mask, against fwd_bwd_ms"}
    del q, k, v, o, lse, do, qg, kg, vg, got1, got2

    # decode: int8 cache, per-row (B, K) scales, pos 576
    Smax = cache_seq_len(SL_POS + 32)
    qd = torch.randn((B, H, hd), generator=g, device=dev).to(bf)
    kq = torch.randint(-127, 128, (B, Smax, K, hd), generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, Smax, K, hd), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((B, K), generator=g, device=dev) * 0.05 + 0.01
    vs = torch.rand((B, K), generator=g, device=dev) * 0.05 + 0.01
    kc = torch.randn((m, K, hd), generator=g, device=dev).to(bf)
    vc = torch.randn((m, K, hd), generator=g, device=dev).to(bf)
    pos = torch.full((B,), SL_POS, dtype=torch.int32, device=dev)
    a = (qd, kq, vq, pos, ks, vs, kc, vc)
    got = flash_decode(*a)
    err = within("flash_decode", got, flash_decode_plain(*a))
    # SDPA on the dequantized bf16 cache (the cushion rows in place)
    kd = (kq.float() * ks[:, None, :, None]).to(bf)
    vd = (vq.float() * vs[:, None, :, None]).to(bf)
    kd[:, :m], vd[:, :m] = kc, vc
    kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    vis_d = (torch.arange(Smax, device=dev) <= SL_POS)[None, None, None]
    sdpa_ms = sdpa(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], kt, vt, attn_mask=vis_d), "decode")
    live = B * (SL_POS + 1 - m)
    bms, by = bound_ms(4 * B * H * hd + 2 * live * K * hd
                       + 4 * m * K * hd + 8 * B * K,
                       4.0 * B * H * hd * (SL_POS + 1), BF16_FLOPS_PER_S)
    rows["flash_decode"] = {
        "unit": f"one call (int8 KV, (B, K) scales, B={B}, pos {SL_POS} of "
                f"{Smax}, {H} heads of {hd})",
        "ms": timed(lambda: flash_decode(*a)),
        "plain_ms": timed(lambda: flash_decode_plain(*a), 3),
        "bound_ms": bms, "bound_by": by, "max_abs_err": err,
        "library_ms": None,
        "library_of": "none: no PyTorch call reads an int8 cache with "
                      "scales; sdpa_dequantized_ms is SDPA on its "
                      "dequantized bf16 copy",
        "sdpa_dequantized_ms": sdpa_ms}
    del kd, vd, kt, vt

    # the paged pool: the same rows in 64-position pages, a shuffled table
    P = Smax // 64
    n_pages = B * P + 1
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1) \
        .to(torch.int32).reshape(B, P)
    kp = torch.zeros((n_pages, 64, K, hd), dtype=torch.int8, device=dev)
    vp = torch.zeros((n_pages, 64, K, hd), dtype=torch.int8, device=dev)
    kp[table.reshape(-1).long()] = kq.reshape(B * P, 64, K, hd)
    vp[table.reshape(-1).long()] = vq.reshape(B * P, 64, K, hd)
    pa = (qd, kp, vp, table, pos, ks, vs, kc, vc)
    gotp = flash_decode_paged(*pa)
    errp = within("flash_decode_paged", gotp, flash_decode_paged_plain(*pa))
    if not torch.equal(gotp, got) or not torch.equal(
            gotp, flash_decode(qd, gather_pages(kp, table),
                               gather_pages(vp, table), pos, ks, vs, kc,
                               vc)):
        fail("head_dim 80 flash_decode_paged: not bit-identical to "
             "flash_decode on the gathered pool")
    bms, by = bound_ms(4 * B * H * hd + 2 * live * K * hd + 4 * m * K * hd
                       + 8 * B * K + 4 * B * P,
                       4.0 * B * H * hd * (SL_POS + 1), BF16_FLOPS_PER_S)
    rows["flash_decode_paged"] = {
        "unit": f"one call (int8 pages of 64, (B, K) scales, B={B}, pos "
                f"{SL_POS}, {H} heads of {hd})",
        "ms": timed(lambda: flash_decode_paged(*pa)),
        "plain_ms": timed(lambda: flash_decode_paged_plain(*pa), 3),
        "bound_ms": bms, "bound_by": by, "max_abs_err": errp,
        "library_ms": None, "library_of": rows["flash_decode"]["library_of"],
        "sdpa_dequantized_ms": sdpa_ms}
    for name, r in rows.items():
        log(f"head_dim 80 {name}: {r['unit']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, SDPA {r.get('library_ms')}"
            + (f", SDPA dequantized {r['sdpa_dequantized_ms']}"
               if "sdpa_dequantized_ms" in r else "")
            + (f", fwd + bwd {r['fwd_bwd_ms']:.4f}" if "fwd_bwd_ms" in r
               else "") + f"), max |err| {r['max_abs_err']:.3g}")
    return rows


def stablelm_phase(dev, zero_counts, counters_zero):
    """Phase 4o: stablelm-3b (head_dim 80) at full width and SL_LAYERS of
    its 32 layers: ``Engine.generate`` for B = 4, a 512-token prompt and
    64 new tokens in W8A8 (int8-resident weights, int8 KV) and in fp, the
    decode step a CUDA graph replayed once per token, launch counts exact,
    the graph's tokens the eager loop's (as phases 4e-4g hold theirs)."""
    import torch
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.launch.serve import seeded_cushion

    cfg = dataclasses.replace(get_config(SL_ARCH), n_layers=SL_LAYERS)
    run = FamilyRun(SL_ARCH, cfg, dev, zero_counts, counters_zero)
    api, params, L = run.api, run.params, cfg.n_layers

    def draw(seed, b, n):
        return api.make_batch(torch.Generator(dev).manual_seed(seed), b, n)

    batch = {k: v for k, v in draw(1, B, PROMPT).items() if k != "labels"}
    calib = [draw(1000 + i, B, PROMPT) for i in range(2)]
    cushion = seeded_cushion(api, params, CUSHION, seed=0)
    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    sites = 5 * L + 1          # qkv, o, up, gate, down a layer; the head
    attn = {"flash_attention": L, "flash_decode": L * (SL_NEW - 1)}
    expect = {"w8a8_int8kv": {**zero_counts, **attn,
                              "w8a8_matmul": sites * SL_NEW,
                              "act_quant_static": 5 * L,
                              "act_quant_static_fused":
                                  1 + sites * (SL_NEW - 1)},
              "fp": {**zero_counts, **attn}}
    modes = {"w8a8_int8kv": (qw8, "int8", True),
             "fp": (QuantConfig(), None, False)}
    engines = run.static(batch, SL_NEW, cushion, calib, expect, modes)
    run.counters_zero(f"{SL_ARCH} static",
                      [s.graph for e in engines.values()
                       for s in e.states.values()])
    del engines
    return run.done()

# phase 3, the non-causal mode of flash_attention (and of its backward) at
# whisper-base's shapes: 8 heads of 64 (G = 1), bf16
NC_ARCH = "whisper-base"


def noncausal_attention_rows(dev, timed):
    """``flash_attention(causal=False)`` at whisper-base's shapes: its
    encoder (B = 4, S = T = 1500: 23 full key tiles and a ragged 28), its
    cross-attention at prefill (S = 256 over the 1500 encoder states) and
    at decode (S = 1): one bf16 ulp of the plain version (1e-6 floor), two
    calls bit-identical, rows 0, S/2 and S-1 bit-identical to the row
    computed alone, timed beside the plain version, the bound and SDPA with
    no mask; the backward at the tuning's cross-attention shape (B =
    TUNE_B, S = TUNE_S, T = 1500) within one bf16 ulp plus 1e-5 of the
    largest entry, two calls bit-identical, timed beside the plain
    version, its bound, the forward + backward through autograd and SDPA's
    forward + backward. Returns ({shape: row}, backward row)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    wcfg = get_config(NC_ARCH)
    H, K, hd = wcfg.n_heads, wcfg.n_kv_heads, wcfg.head_dim
    Te = wcfg.encdec.encoder_seq
    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(23)

    def mk(*sh):
        return torch.randn(sh, generator=g, device=dev).to(bf)

    def sdpa_ms(fn, what):
        try:
            return timed(fn)
        except (RuntimeError, TypeError) as e:
            log(f"scaled_dot_product_attention {what} not timed: {e}")
            return None

    def row(name, Bq, S, T):
        qh = mk(Bq, S, H, hd).transpose(1, 2)
        kh, vh = mk(Bq, T, K, hd).transpose(1, 2), \
            mk(Bq, T, K, hd).transpose(1, 2)
        got = flash_attention(qh, kh, vh, causal=False)
        want = flash_attention_plain(qh, kh, vh, causal=False)
        err = (got.float() - want.float()).abs()
        if not bool((err <= BF16_ULP * want.float().abs() + 1e-6).all()):
            fail(f"flash_attention non-causal {name}: beyond one bf16 ulp, "
                 f"max err {float(err.max())}")
        if not torch.equal(got, flash_attention(qh, kh, vh, causal=False)):
            fail(f"flash_attention non-causal {name}: two calls differ")
        for i in sorted({0, S // 2, S - 1}):
            alone = flash_attention(qh[:, :, i:i + 1], kh, vh, causal=False)
            if not torch.equal(got[:, :, i:i + 1], alone):
                fail(f"flash_attention non-causal {name}: row {i} differs "
                     f"from the row computed alone")
        qc, kc_, vc_ = (t.contiguous() for t in (qh, kh, vh))
        bms, by = bound_ms(2 * (2 * Bq * H * S * hd + 2 * Bq * K * T * hd),
                           4.0 * hd * Bq * H * S * T, BF16_FLOPS_PER_S)
        r = {"unit": f"one call, B={Bq}, S={S}, T={T}, {H} heads of {hd}",
             "ms": timed(lambda: flash_attention(qh, kh, vh, causal=False)),
             "plain_ms": timed(lambda: flash_attention_plain(
                 qh, kh, vh, causal=False), 3),
             "bound_ms": bms, "bound_by": by,
             "max_abs_err": float(err.max()),
             "library_ms": sdpa_ms(lambda: F.scaled_dot_product_attention(
                 qc, kc_, vc_), "forward")}
        print(json.dumps({"kernel": "flash_attention", "causal": False,
                          "shape": name, **r}), flush=True)
        return r

    rows = {"encoder": row("encoder", B, Te, Te),
            "cross_prefill": row("cross-attention prefill", B, 256, Te),
            "cross_decode": row("cross-attention decode", B, 1, Te)}

    Bq, S, T = TUNE_B, TUNE_S, Te
    q = mk(Bq, S, H, hd).transpose(1, 2)
    k, v = mk(Bq, T, K, hd).transpose(1, 2), mk(Bq, T, K, hd).transpose(1, 2)
    do = mk(Bq, S, H, hd).transpose(1, 2)
    o, lse = FA._launch(q, k, v, 0, 0, with_lse=True, causal=False)
    a = (q, k, v, o, lse, do)
    got = flash_attention_bwd(*a, causal=False)
    again = flash_attention_bwd(*a, causal=False)
    want = flash_attention_bwd_plain(*a, causal=False)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail("flash_attention_bwd non-causal: two calls differ")
    errs = []
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        e = (x.float() - y.float()).abs()
        lim = BF16_ULP * y.float().abs() + 1e-5 * float(y.float().abs().max())
        if not bool((e <= lim).all()):
            fail(f"flash_attention_bwd non-causal {name}: beyond the stated "
                 f"tolerance, max err {float(e.max())}")
        errs.append(float(e.max()))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    qs, ks_, vs_ = (t.detach().contiguous().requires_grad_()
                    for t in (q, k, v))
    dos = do.contiguous()
    bms, by = bound_ms(2 * (4 * Bq * H * S * hd + 4 * Bq * K * T * hd)
                       + 4 * Bq * H * S, 10.0 * hd * Bq * H * S * T,
                       BF16_FLOPS_PER_S)
    bwd = {"unit": f"one call, B={Bq}, S={S}, T={T}, {H} heads of {hd}",
           "ms": timed(lambda: flash_attention_bwd(*a, causal=False)),
           "plain_ms": timed(lambda: flash_attention_bwd_plain(
               *a, causal=False), 3),
           "bound_ms": bms, "bound_by": by, "max_abs_err": max(errs),
           "fwd_bwd_ms": timed(lambda: flash_attention(
               qg, kg, vg, causal=False).backward(do)),
           "library_ms": sdpa_ms(lambda: F.scaled_dot_product_attention(
               qs, ks_, vs_).backward(dos), "forward + backward"),
           "library_of": "scaled_dot_product_attention forward + backward "
                         "(beside fwd_bwd_ms)"}
    print(json.dumps({"kernel": "flash_attention_bwd", "causal": False,
                      **bwd}), flush=True)
    log("flash_attention non-causal (whisper-base shapes): " + ", ".join(
        f"{k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA {r['library_ms']})"
        for k, r in rows.items()) + f"; backward {bwd['ms']:.4f} ms "
        f"(plain {bwd['plain_ms']:.3f}, bound {bwd['bound_ms']:.4f}, "
        f"fwd+bwd {bwd['fwd_bwd_ms']:.4f}, SDPA fwd+bwd "
        f"{bwd['library_ms']}); within their bars, rows independent, "
        f"two calls identical")
    return rows, bwd


# phases 4h and 4i: the encoder-decoder and the xLSTM at full width and
# depth, each through both engines, the search and the tuning (see the
# module docstring)
ED_ARCH, ED_PROMPT, ED_NEW = "whisper-base", 256, 32
XL_ARCH, XL_NEW = "xlstm-350m", 32
# the xLSTM's search sample and tuning batches: 64 positions, not the other
# families' 256 (SAMPLE_LEN, TUNE_S): the sLSTM scan is a host loop over
# the positions, a forward a candidate, and its backward the same loop
# again
XL_SAMPLE, XL_TUNE_S = 64, 64
# card vs CPU: whisper at 2 encoder and 2 decoder layers (the 1500 frames,
# 64 tokens), xlstm at one pair (64 tokens), 4 logits rows each; the MoE
# phase's bars (both sides round to bf16 at the same points and reduce in
# other orders; under W8A8 a code flips by one step of its range / 255):
# mode: (largest |card - cpu|, mean |card - cpu|)
FAM_LOGIT_TOL = {"fp": (1.0, 0.05), "w8a8": (1.0, 0.1),
                 "w8a8_dynamic": (1.0, 0.1)}
FAM_CMP_TOKENS = 4


def encdec_phase(dev, zero_counts, counters_zero, timed):
    """Phase 4h: whisper-base at full width and depth (see the module
    docstring)."""
    import torch
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core import cushioncache as CC
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.launch.serve import poisson_trace, seeded_cushion
    from repro_torch.models.common import ParamTree
    from repro_torch.serving.engine import Engine, cache_seq_len

    cfg = get_config(ED_ARCH)
    run = FamilyRun("whisper-base", cfg, dev, zero_counts, counters_zero)
    api, params, rec = run.api, run.params, run.rec
    L, E, V = cfg.n_layers, cfg.encdec.encoder_layers, cfg.vocab_size
    Te = cfg.encdec.encoder_seq
    D, Fd, H, K, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    rec["encoder_layers"], rec["frames"] = E, Te

    def draw(seed, b, n):
        return {k: v for k, v in api.make_batch(
            torch.Generator(dev).manual_seed(seed), b, n).items()}

    batch = {k: v for k, v in draw(1, B, ED_PROMPT).items() if k != "labels"}
    cushion = seeded_cushion(api, params, CUSHION, seed=0)
    qdyn8 = QuantConfig(mode="pt_dynamic", true_int8=True)

    # 1. the static Engine: [1500 frames; 256 tokens] + 32 new tokens. A
    # prefill runs the E encoder layers (non-causal attention) and the L
    # decoder layers (causal self-attention, non-causal cross-attention);
    # a decode step L flash_decode and L cross-attention calls (S = 1).
    # W8A8 here is pt_dynamic with true int8 (the reference cannot serve
    # pt_static for this family): the int matmul at every site (the 4 E + 6
    # L of a prefill and its head, the 6 L + 1 of a decode step) on codes
    # that a bf16 dynamic range gives, formed by tensor ops as the
    # reference forms them with jnp (no quantizer kernel runs)
    layer_sites, dec_sites = 4 * E + 6 * L, 6 * L + 1
    attn = {"flash_attention": E + 2 * L + L * (ED_NEW - 1),
            "flash_decode": L * (ED_NEW - 1)}
    expect = {"w8a8_dynamic": {
                  **zero_counts, **attn,
                  "w8a8_matmul": layer_sites + 1 + dec_sites * (ED_NEW - 1)},
              "fp": {**zero_counts, **attn}}
    modes = {"w8a8_dynamic": (qdyn8, None, False),
             "fp": (QuantConfig(), None, False)}
    engines = run.static(batch, ED_NEW, cushion, None, expect, modes)
    try:
        Engine(api, params, QuantConfig(mode="pt_static", true_int8=True),
               max_seq=64)
        fail("whisper: an Engine under pt_static was made")
    except ValueError as e:
        if "lm_head without site scales" not in str(e):
            raise
        rec["pt_static_refused"] = str(e)
    log(f"whisper pt_static refused, as the reference cannot serve it: "
        f"{rec['pt_static_refused'][:90]}...")

    rec["kernels"] = int_matmul_rows(
        "whisper-base", dev, timed,
        {"qkv": (D, (H + 2 * K) * hd, L), "o": (H * hd, D, L),
         "xq": (D, H * hd, L), "xo": (H * hd, D, L), "mlp_in": (D, Fd, L),
         "down": (Fd, D, L), "head": (D, V, 1)}, B * ED_PROMPT)
    # flash_decode at the decode step's shape: the fp cache (cushion rows
    # in it), G = 1, mid-generation
    g = torch.Generator(dev).manual_seed(24)
    smax = cache_seq_len(ED_PROMPT + ED_NEW + 32)
    pos_v = CUSHION + ED_PROMPT + ED_NEW // 2
    qd = torch.randn((B, H, hd), generator=g, device=dev).to(torch.bfloat16)
    kf = torch.randn((B, smax, K, hd), generator=g, device=dev) \
        .to(torch.bfloat16)
    vf = torch.randn((B, smax, K, hd), generator=g, device=dev) \
        .to(torch.bfloat16)
    pos = torch.tensor(pos_v, dtype=torch.int32, device=dev)
    got, want = flash_decode(qd, kf, vf, pos), flash_decode_plain(qd, kf, vf,
                                                                 pos)
    err = (got.float() - want.float()).abs()
    if not bool((err <= BF16_ULP * want.float().abs() + 1e-6).all()):
        fail(f"whisper flash_decode: beyond one bf16 ulp ({float(err.max())})")
    bms, by = bound_ms(4 * B * H * hd + 4 * B * (pos_v + 1) * K * hd,
                       4.0 * B * H * hd * (pos_v + 1), BF16_FLOPS_PER_S)
    rec["kernels"]["flash_decode"] = {
        "unit": f"one whisper-base decode step ({L} calls, fp KV, B={B}, "
                f"pos={pos_v} of {smax}, G=1)",
        "ms": L * timed(lambda: flash_decode(qd, kf, vf, pos)),
        "plain_ms": L * timed(lambda: flash_decode_plain(qd, kf, vf, pos), 3),
        "bound_ms": L * bms, "bound_by": by, "max_abs_err": float(err.max())}
    for name, r in rec["kernels"].items():
        log(f"whisper {name}: {r['unit']}: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}), max |err| {r['max_abs_err']:.3g}")
    del qd, kf, vf

    # 2. 4 contiguous fp slots over 8 requests, each with its own frames
    reqs = poisson_trace(api, 3, FAM_REQ, 0.0, FAM_PROMPTS, FAM_BUDGETS)
    rec["contiguous"] = run.pool(
        "contiguous fp pool", reqs, engines["fp"], QuantConfig(), None,
        cushion, lambda n, s: {"flash_attention": (E + 2 * L) * n + L * s,
                               "flash_decode": L * s},
        kv_dtype=None, prequant=False)
    # phase 4k's one-rank sides: the static requests and the pool
    run.tp_one_rank(engines, batch, ED_NEW, cushion)
    run.tp_one_rank_pool(reqs, engines["fp"], QuantConfig(), cushion,
                         prequant=False, kv_dtype=None, in_turn=False)
    run.counters_zero("whisper static", [s_.graph for e in engines.values()
                                         for s_ in e.states.values()])
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the method: greedy_search_ref (the decoder reads each sample's
    # frames: no KV-reuse scoring), each forward E + 2 L attention calls;
    # the tuning's backward runs through the causal self-attention and the
    # non-causal cross-attention (2 L calls a step; the encoder, which no
    # gradient reaches, runs no backward)
    samples = [{k: v for k, v in draw(5000 + i, 1, SAMPLE_LEN).items()
                if k != "labels"} for i in range(MAX_PREFIX)]
    tune_b = [draw(3000 + i, TUNE_B, TUNE_S) for i in range(FAM_TUNE_STEPS)]

    def search_want(n_it, ccfg):
        n_pool = CC._pool_pad_len(V, ccfg, SEARCH_CHUNK)
        return {"flash_attention":
                (E + 2 * L) * (n_it * (1 + n_pool // SEARCH_CHUNK) + 1)}

    if api.supports_kv_scoring:
        fail("whisper: the encoder-decoder must search with "
             "greedy_search_ref")
    run.method(lambda i: samples[i], tune_b, search_want,
               {"flash_attention": (E + 2 * L) * FAM_TUNE_STEPS,
                "flash_attention_bwd": 2 * L * FAM_TUNE_STEPS})
    del samples, tune_b

    # 4. card against CPU at 2 encoder and 2 decoder layers, full width
    cfg2 = dataclasses.replace(cfg, n_layers=2, encdec=dataclasses.replace(
        cfg.encdec, encoder_layers=2))
    tree = params.tree()
    cut = lambda t: tree_map(lambda a: a[:2], t)      # noqa: E731
    p2 = ParamTree({**tree, "encoder": cut(tree["encoder"]),
                    "decoder": cut(tree["decoder"])})
    prompt = {"tokens": batch["tokens"][:1, :FAM_CMP_PROMPT],
              "frames": batch["frames"][:1]}
    run.card_vs_cpu(cfg2, p2, {"kv": cut(cushion["kv"])}, None, prompt,
                    modes, FAM_CMP_TOKENS, tols=FAM_LOGIT_TOL)
    return run.done()


def xlstm_phase(dev, zero_counts, counters_zero, timed):
    """Phase 4i: xlstm-350m at full width and depth (see the module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.launch.serve import poisson_trace, seeded_cushion
    from repro_torch.models import xlstm as XL
    from repro_torch.models.common import ParamTree

    cfg = get_config(XL_ARCH)
    run = FamilyRun("xlstm-350m", cfg, dev, zero_counts, counters_zero)
    api, params, rec = run.api, run.params, run.rec
    P, D, V = XL.n_pairs(cfg), cfg.d_model, cfg.vocab_size
    inner, NH, hdx = XL.dims(cfg)

    def draw(seed, b, n):
        return api.make_batch(torch.Generator(dev).manual_seed(seed), b, n)

    batch = {"tokens": draw(1, B, PROMPT)["tokens"]}
    calib = [draw(1000 + i, B, PROMPT) for i in range(2)]
    # the seeded CushionState: the state after 4 seeded token ids
    cushion = seeded_cushion(api, params, CUSHION, seed=0)
    qw8 = QuantConfig(mode="pt_static", true_int8=True)

    # 1. the static Engine, B x 512 + 32 new tokens. No attention: W8A8
    # runs the int matmul at the 4 P sites and the head (w_proj
    # int8-resident, m_in / s_in quantized a call), the prefill's
    # quantizer standalone (the head too: the reference's prefill runs it
    # over every position), fused at every decode site; fp launches none
    sites = 4 * P + 1
    expect = {"w8a8": {**zero_counts, "w8a8_matmul": sites * XL_NEW,
                       "act_quant_static": sites,
                       "act_quant_static_fused": sites * (XL_NEW - 1)},
              "fp": dict(zero_counts)}
    modes = {"w8a8": (qw8, None, True), "fp": (QuantConfig(), None, False)}
    engines = run.static(batch, XL_NEW, cushion, calib, expect, modes)
    w8 = engines["w8a8"]
    rec["resident_bytes_w8a8"] = (w8.weight_bytes_fp, w8.weight_bytes_int8)

    # the sLSTM block (its scan: a loop over the 512 positions) and the
    # mLSTM block (two chunks of 256) at the prefill's shape under `none`,
    # one sublayer each: device ms (the profiler's kernels), wall ms and
    # kernels launched, x P a prefill
    lp = tree_map(lambda a: a[0], params.tree()["layers"])
    x = torch.randn((B, PROMPT, D), generator=torch.Generator(dev)
                    .manual_seed(5), device=dev).to(torch.bfloat16)
    qn = QuantConfig()
    for name, fn in (
            ("slstm", lambda: XL.apply_slstm(lp["slstm"], x, cfg, qn, None,
                                             None)),
            ("mlstm", lambda: XL.apply_mlstm(lp["mlstm"], x, cfg, qn, None,
                                             None))):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        krows = by_kernel(prof, 1, top=None)
        dev_ms = sum(v[1] for v in krows.values())
        rec[f"{name}_block"] = {
            "unit": f"one {name} block at B={B}, S={PROMPT}, inner={inner}, "
                    f"{NH} heads of {hdx}, under none; x {P} a prefill",
            "device_ms": dev_ms, "wall_ms": wall,
            "device_ms_per_prefill": P * dev_ms,
            "wall_ms_per_prefill": P * wall,
            "kernels": sum(v[0] for v in krows.values()),
            "by_kernel_top": dict(list(krows.items())[:6])}
        r = rec[f"{name}_block"]
        log(f"xlstm {name} block ({r['unit']}): device {dev_ms:.3f} ms, "
            f"wall {wall:.2f} ms in {r['kernels']:.0f} kernels; a prefill "
            f"{r['device_ms_per_prefill']:.2f} ms device, "
            f"{r['wall_ms_per_prefill']:.2f} ms wall")
        del prof
    del x, lp

    rec["kernels"] = int_matmul_rows(
        "xlstm-350m", dev, timed,
        {"m_in": (D, 3 * inner, P), "m_out": (inner, D, P),
         "s_in": (D, 4 * inner, P), "s_out": (inner, D, P),
         "head": (D, V, 1)}, B * PROMPT)
    for name, r in rec["kernels"].items():
        log(f"xlstm {name}: {r['unit']}: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")

    # 2. 4 contiguous W8A8 slots over 8 requests: the state tree scattered
    # along its nested batch axes
    reqs = poisson_trace(api, 3, FAM_REQ, 0.0, FAM_PROMPTS, FAM_BUDGETS)
    rec["contiguous"] = run.pool(
        "contiguous pool", reqs, w8, qw8, w8.scales, cushion,
        lambda n, s: {"w8a8_matmul": sites * (n + s),
                      "act_quant_static": sites * n,
                      "act_quant_static_fused": sites * s},
        kv_dtype=None)
    # phase 4k's one-rank sides: the static requests and the pool
    run.tp_one_rank(engines, batch, XL_NEW, cushion)
    run.tp_one_rank_pool(reqs, w8, qw8, cushion, kv_dtype=None,
                         in_turn=False)
    run.counters_zero("xlstm static", [s_.graph for e in engines.values()
                                       for s_ in e.states.values()])
    del engines, w8
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the method: greedy_search_ref and 3 tuning steps under
    # pt_dynamic's fake quant (no kernel of the port runs); the whole state
    # tree trains
    samples = [{"tokens": draw(5000 + i, 1, XL_SAMPLE)["tokens"]}
               for i in range(MAX_PREFIX)]
    tune_b = [draw(3000 + i, TUNE_B, XL_TUNE_S)
              for i in range(FAM_TUNE_STEPS)]

    def every_leaf_moved(greedy, tuned):
        for (gk, gl), (_, tl) in zip(
                ((f"{g}.{k}", v) for g, d in greedy["state"].items()
                 for k, v in d.items()),
                ((f"{g}.{k}", v) for g, d in tuned["state"].items()
                 for k, v in d.items())):
            if not bool(torch.isfinite(tl).all()):
                fail(f"xlstm tune: state leaf {gk} is not finite")
            if torch.equal(tl, gl):
                fail(f"xlstm tune: state leaf {gk} did not move")
        log("xlstm tune: every leaf of the state tree moved, all finite")

    if api.supports_kv_scoring:
        fail("xlstm: the xLSTM must search with greedy_search_ref")
    run.method(lambda i: samples[i], tune_b, lambda n, c: {}, {},
               check=every_leaf_moved, sample_len=XL_SAMPLE)
    del samples, tune_b

    # 4. card against CPU at one pair of full width
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    tree = params.tree()
    one = lambda t: tree_map(lambda a: a[:1], t)      # noqa: E731
    p2 = ParamTree({**tree, "layers": one(tree["layers"])})
    prompt = {"tokens": batch["tokens"][:1, :FAM_CMP_PROMPT]}
    calib2 = [{"tokens": calib[0]["tokens"][:1, :FAM_CMP_PROMPT]}]
    run.card_vs_cpu(cfg2, p2, {"state": one(cushion["state"])}, calib2,
                    prompt, modes, FAM_CMP_TOKENS, tols=FAM_LOGIT_TOL)
    return run.done()


# phase 4j, one-card training at full width and depth: smollm-360m through
# launch/train.py at the launcher's defaults (B = 8 x 256, lr 1e-3, remat
# on), TRAIN_STEPS steps (0..20: the launcher logs steps 0 and 20); the
# quantization-aware modes, microbatches and the backward at length through
# train/trainer.py; resume at 2 of smollm's layers at full width (a
# checkpoint of the full model's train state is 4.4 GB of npz a save)
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_QAT_STEPS = 21, 8, 256, 6
TRAIN_TIMED_STEPS, TRAIN_LONG_S, TRAIN_CUT_LAYERS = 10, 2048, 2
# card vs CPU, one step: in f32 each first moment (0.1 x the clipped
# gradient) within 1e-5 of its leaf's largest entry and the loss within
# 1e-5 relative (smollm's two layers: the kernels and the plain versions
# sum in other orders, ~1e-6); the other families at their reduced sizes,
# f32, within 1e-4 of a leaf's largest entry (their Mamba and sLSTM scans
# and the MoE's routing run as tensor ops on both sides, in other kernels);
# in bf16 the card's first moments no farther from the CPU's f32 ones than
# GRAD_TUNE_FACTOR x the CPU's bf16 ones (phase 4c's bar)
TRAIN_F32_TOL, TRAIN_FAM_TOL = 1e-5, 1e-4
# microbatches = 2 against 1 from the same weights and batches, bf16: the
# first step's loss within 1e-2 relative and its first moments within
# GRAD_TOL (the row count changes cuBLAS's kernels, so rows round apart),
# the six steps' losses within 5e-2
TRAIN_MB_LOSS, TRAIN_MB_LOSS_6 = 1e-2, 5e-2


def train_phase(dev, corpus, timed):
    """Phase 4j: one-card training of smollm-360m at full width and depth
    (see the module docstring). Returns the record."""
    import shutil
    import warnings

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import monitoring as MON
    from repro_torch.configs import QuantConfig, RunConfig, get_config, reduced
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as TL
    from repro_torch.launch.serve import to_device
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import tree_leaves, tree_paths
    from repro_torch.train.trainer import (eval_ppl, make_optimizer,
                                           make_train_step)

    cfg = get_config(ARCH)
    L, H, K, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    zero = {k: 0 for k in _lib.LAUNCHES}
    rec = {}
    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    pipe = Pipeline(corpus, batch=TRAIN_B, seq_len=TRAIN_S, seed=0)
    tokens = TRAIN_B * TRAIN_S

    def launches(fa, bwd, ptoken=0):
        return {**zero, "flash_attention": fa, "flash_attention_bwd": bwd,
                "act_quant_ptoken": ptoken}

    # (a) launch/train.py main at full width: a CUDA event at the start of
    # every train step (the launcher's step function wrapped, nothing else
    # changed), the launches and host syncs of the whole run
    real_step = TL.make_train_step
    evs = []

    def evented(*a, **kw):
        step = real_step(*a, **kw)

        def f(*args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append(ev)
            return step(*args)
        return f
    # the held-out loss before training: the launcher's eval batches under
    # its initial weights (the same seed on the card)
    n_eval = 8
    api = build(cfg, "cuda")
    p0 = api.init_params(torch.Generator(dev).manual_seed(0)).tree()
    ppl0 = eval_ppl(api, p0, [to_device(pipe.get_batch(10_000 + i), dev)
                              for i in range(n_eval)], QuantConfig())
    del p0
    argv = ["--arch", ARCH, "--device", "cuda", "--steps", str(TRAIN_STEPS),
            "--quant", "none", "--eval-batches", str(n_eval), "--ckpt-dir",
            str(work / "a"), "--out", str(work / "a.json")]
    TL.make_train_step = evented
    _lib.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()      # earlier phases' tensors
    t0 = time.perf_counter()
    try:
        with MON.count_host_syncs() as hs:
            state, ppl = TL.main(argv, pipe=pipe)
    finally:
        TL.make_train_step = real_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.LAUNCHES)
    # remat: every layer's attention forward twice a step (the recompute),
    # its backward once; the eval's forwards once a layer
    want = launches(TRAIN_STEPS * 2 * L + n_eval * L, TRAIN_STEPS * L)
    if counts != want:
        fail(f"train: launches {counts}, expected {want}")
    out = json.loads((work / "a.json").read_text())
    log_ = out["log"]
    # the loss falls on the held-out batches; the logged training losses
    # (steps 0 and 20) are of two other batches, whose spread (~0.014 at
    # 2,048 tokens) is of the 21 steps' gain's size
    if [r["step"] for r in log_] != [0, 20] or not all(
            np.isfinite(r[k]) for r in log_ for k in r) \
            or not ppl < ppl0:
        fail(f"train: the launcher's log {log_}, eval ppl {ppl0} -> {ppl}")
    if hs.count != len(log_) or out["report"]["failures"]:
        fail(f"train: {hs.count} host syncs (the log's {len(log_)}), "
             f"report {out['report']}")
    step_ms = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
    peak = torch.cuda.max_memory_allocated()
    rec["launcher"] = {
        "argv": argv, "wall_s": wall, "log": log_, "eval_ppl": ppl,
        "eval_ppl_before": ppl0,
        "report": out["report"], "launches": counts, "host_syncs": hs.count,
        "step_ms": quartiles(step_ms=step_ms)["step_ms"],
        "step_ms_all": step_ms,
        "step_ms_are": "CUDA events at the starts of consecutive train "
                       "steps: the launcher's whole step, the host's batch "
                       "drawing included",
        "tokens_per_s": tokens / (float(np.median(step_ms)) / 1e3),
        "peak_mem_bytes": peak, "mem_before_bytes": mem0,
        "peak_mem_of_run_bytes": peak - mem0}
    log(f"train (launch/train.py, {ARCH}, B={TRAIN_B} x {TRAIN_S}, "
        f"{TRAIN_STEPS} steps, remat): loss {log_[0]['loss']:.4f} (step 0)"
        f", {log_[-1]['loss']:.4f} (step 20); held-out ppl {ppl0:.1f} -> "
        f"{ppl:.1f}; ms a step (p25/p50/"
        f"p75) {rec['launcher']['step_ms']}, "
        f"{rec['launcher']['tokens_per_s']:.0f} tokens/s; launches "
        f"{counts['flash_attention']} / {counts['flash_attention_bwd']}; "
        f"{hs.count} host syncs (the log's); peak {peak / 2 ** 30:.2f} GiB "
        f"({(peak - mem0) / 2 ** 30:.2f} above the earlier phases'); "
        f"{wall:.1f} s with the final checkpoint and the eval")
    del state
    shutil.rmtree(work / "a", ignore_errors=True)

    # the train step alone on staged batches: ms a step, host syncs, the
    # profiler's device time, CUDA's synchronizing calls
    run = RunConfig(model=cfg, quant=QuantConfig(), seq_len=TRAIN_S,
                    global_batch=TRAIN_B, lr=1e-3, train_steps=TRAIN_STEPS,
                    warmup_steps=10)              # the launcher's
    staged = [to_device(pipe.get_batch(i), dev)
              for i in range(TRAIN_TIMED_STEPS + 4)]

    def fresh(r):
        opt = make_optimizer(r)
        p = api.init_params(torch.Generator(dev).manual_seed(0)).tree()
        return opt, p, opt.init(p)

    opt, p, s = fresh(run)
    step = make_train_step(api, run, opt)
    p, s, _ = step(p, s, staged[0])                 # warm-up
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(TRAIN_TIMED_STEPS + 1)]
    _lib.reset_launches()
    with MON.count_host_syncs() as hs:
        for i in range(TRAIN_TIMED_STEPS):
            evs[i].record()
            p, s, m = step(p, s, staged[1 + i])
        evs[-1].record()
    torch.cuda.synchronize()
    counts = dict(_lib.LAUNCHES)
    want = launches(TRAIN_TIMED_STEPS * 2 * L, TRAIN_TIMED_STEPS * L)
    if counts != want or hs.count:
        fail(f"train step: launches {counts} (expected {want}), "
             f"{hs.count} host syncs")
    alone = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
    # CUDA's synchronizing calls inside one step, as PyTorch's sync debug
    # mode sees them (one warning a call; its note on being a prototype is
    # not one), with one known sync after the step as the detector's check
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            p, s, m = step(p, s, staged[-3])
            n_in_step = sum("called a synchronizing" in str(w.message)
                            for w in caught)
            float(m["loss"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0][:160] for w in caught
             if "called a synchronizing" in str(w.message)]
    if len(syncs) != n_in_step + 1:
        fail(f"the sync detector missed the known sync: {syncs}")
    syncs = syncs[:n_in_step]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b_ in staged[-2:]:
            p, s, m = step(p, s, b_)
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3 / 2
    dev_ms, n_k = trace_device_ms(prof, 2)
    rec["step"] = {
        "steps": TRAIN_TIMED_STEPS, "step_ms": quartiles(
            step_ms=alone)["step_ms"], "step_ms_all": alone,
        "tokens_per_s": tokens / (float(np.median(alone)) / 1e3),
        "host_syncs": hs.count, "launches": counts,
        "cuda_synchronizing_calls": len(syncs),
        "cuda_synchronizing_first": syncs[:3],
        "profile": {"wall_ms": pwall, "device_ms": dev_ms,
                    "busy_share": dev_ms / pwall, "kernels": n_k,
                    "by_kernel": by_kernel(prof, 2, top=10)}}
    log(f"train step alone (staged batches, {TRAIN_TIMED_STEPS} steps): ms "
        f"(p25/p50/p75) {rec['step']['step_ms']}, "
        f"{rec['step']['tokens_per_s']:.0f} tokens/s; host syncs "
        f"{hs.count}; CUDA synchronizing calls in a step {len(syncs)} "
        f"{syncs[:1]}; profiled: device {dev_ms:.1f} of {pwall:.1f} ms "
        f"(busy {dev_ms / pwall:.2f}), {n_k:.0f} kernels a step")
    del p, s, m, step

    # the attention kernels at the training shape (B = 8 x 256, no
    # cushion, 15 heads over 5), against their plain versions, timed
    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(7)
    mk = lambda *sh: torch.randn(sh, generator=g, device=dev).to(bf)  # noqa: E731
    q = mk(TRAIN_B, TRAIN_S, H, hd).transpose(1, 2)
    k = mk(TRAIN_B, TRAIN_S, K, hd).transpose(1, 2)
    v = mk(TRAIN_B, TRAIN_S, K, hd).transpose(1, 2)
    do = mk(TRAIN_B, TRAIN_S, H, hd).transpose(1, 2)
    o, lse = FA._launch(q, k, v, 0, 0, with_lse=True)
    want_o = FA.flash_attention_plain(q, k, v)
    e_o = (o.float() - want_o.float()).abs()
    if not bool((e_o <= BF16_ULP * want_o.float().abs() + 1e-5).all()):
        fail(f"flash_attention at the training shape: max err "
             f"{float(e_o.max())}")
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, 0, 0)
    want_g = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, 0, 0)
    errs = []
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want_g):
        e = (a.float() - b_.float()).abs()
        lim = BF16_ULP * b_.float().abs() + 1e-5 * float(
            b_.float().abs().max())
        if not bool((e <= lim).all()):
            fail(f"flash_attention_bwd at the training shape, {name}: max "
                 f"err {float(e.max())}")
        errs.append(float(e.max()))
    pairs = TRAIN_B * H * TRAIN_S * (TRAIN_S + 1) / 2
    io = 2 * (2 * TRAIN_B * H * TRAIN_S * hd + 2 * TRAIN_B * K * TRAIN_S * hd)
    f_b, f_by = bound_ms(io, 4.0 * hd * pairs, BF16_FLOPS_PER_S)
    b_b, b_by = bound_ms(2 * (4 * TRAIN_B * H * TRAIN_S * hd
                              + 4 * TRAIN_B * K * TRAIN_S * hd)
                         + 4 * TRAIN_B * H * TRAIN_S, 10.0 * hd * pairs,
                         BF16_FLOPS_PER_S)
    qs, ks_, vs_ = (t.detach().contiguous().requires_grad_()
                    for t in (q, k, v))
    dos = do.contiguous()
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def lib_or_none(fn):
        try:
            return timed(fn)
        except (RuntimeError, TypeError) as e_:
            log(f"scaled_dot_product_attention not timed: {e_}")
            return None
    fa_row = {"unit": f"one call (B={TRAIN_B}, S={TRAIN_S}, no cushion)",
              "ms": timed(lambda: FA.flash_attention(q, k, v)),
              "plain_ms": timed(lambda: FA.flash_attention_plain(q, k, v),
                                3),
              "bound_ms": f_b, "bound_by": f_by,
              "library_ms": lib_or_none(
                  lambda: F.scaled_dot_product_attention(
                      qs, ks_, vs_, is_causal=True, enable_gqa=True)),
              "max_abs_err": float(e_o.max())}
    bwd_row = {"unit": f"one call (B={TRAIN_B}, S={TRAIN_S}, no cushion)",
               "ms": timed(lambda: FA.flash_attention_bwd(
                   q, k, v, o, lse, do, 0, 0)),
               "plain_ms": timed(lambda: FA.flash_attention_bwd_plain(
                   q, k, v, o, lse, do, 0, 0), 3),
               "bound_ms": b_b, "bound_by": b_by,
               "fwd_bwd_ms": timed(lambda: FA.flash_attention(
                   qg, kg, vg).backward(do)),
               "library_ms": lib_or_none(
                   lambda: F.scaled_dot_product_attention(
                       qs, ks_, vs_, is_causal=True,
                       enable_gqa=True).backward(dos)),
               "library_of": "scaled_dot_product_attention forward + "
                             "backward, against fwd_bwd_ms",
               "max_abs_err": max(errs)}
    rec["kernels"] = {"flash_attention": fa_row,
                      "flash_attention_bwd": bwd_row}
    log(f"at the training shape (B={TRAIN_B} x {TRAIN_S}, m=0): "
        f"flash_attention {fa_row['ms']:.4f} ms (bound {f_b:.4f}, SDPA "
        f"{fa_row['library_ms']}), flash_attention_bwd {bwd_row['ms']:.4f} "
        f"(bound {b_b:.4f}); forward + backward {bwd_row['fwd_bwd_ms']:.4f} "
        f"against SDPA's {bwd_row['library_ms']}")
    del q, k, v, do, o, lse, qs, ks_, vs_, qg, kg, vg

    # (b) quantization-aware training, microbatches, the backward at length
    def steps_of(r, batches, microbatches=1):
        opt_, p_, s_ = fresh(r)
        st = make_train_step(api, r, opt_, microbatches=microbatches)
        _lib.reset_launches()
        losses, first = [], None
        for b_ in batches:
            p_, s_, m_ = st(p_, s_, b_)
            losses.append(m_["loss"])
            if first is None:
                first = [t.float() for t in tree_leaves(s_.mu)]
        n = dict(_lib.LAUNCHES)
        out_ = [float(x) for x in torch.stack(losses).cpu()]
        del p_, s_
        return out_, n, first

    qat = {}
    per_fwd = 5 * L                  # qkv, o, w_up, w_gate, down a layer
    for mode in ("pt_dynamic", "ptoken_dynamic"):
        r = dataclasses.replace(run, quant=QuantConfig(mode=mode))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, n, _ = steps_of(r, staged[:TRAIN_QAT_STEPS])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        # the head's quantizer runs outside the layers' checkpoints
        want = launches(TRAIN_QAT_STEPS * 2 * L, TRAIN_QAT_STEPS * L,
                        TRAIN_QAT_STEPS * (2 * per_fwd + 1)
                        if mode == "ptoken_dynamic" else 0)
        if n != want or not all(np.isfinite(losses)):
            fail(f"train {mode}: launches {n} (expected {want}), losses "
                 f"{losses}")
        qat[mode] = {"losses": losses, "launches": n, "seconds": sec,
                     "act_quant_ptoken_per_step": n["act_quant_ptoken"]
                     // TRAIN_QAT_STEPS}
        log(f"train {mode}: {TRAIN_QAT_STEPS} steps, losses "
            f"{[round(x, 4) for x in losses]}, {sec:.2f} s; launches a "
            f"step: flash_attention {2 * L}, flash_attention_bwd {L}, "
            f"act_quant_ptoken {n['act_quant_ptoken'] // TRAIN_QAT_STEPS}")
    l1, _, mu1 = steps_of(run, staged[:TRAIN_QAT_STEPS])
    l2, n2, mu2 = steps_of(run, staged[:TRAIN_QAT_STEPS], microbatches=2)
    a_ = torch.cat([t.reshape(-1) for t in mu2])
    b_ = torch.cat([t.reshape(-1) for t in mu1])
    mb_rel = float((a_ - b_).norm() / b_.norm())
    mb_cos = float(torch.dot(a_, b_) / (a_.norm() * b_.norm()))
    rels = [abs(x / y - 1) for x, y in zip(l2, l1)]
    del a_, b_, mu1, mu2
    # two microbatches: each layer's attention twice a microbatch
    if n2 != launches(TRAIN_QAT_STEPS * 4 * L, TRAIN_QAT_STEPS * 2 * L) \
            or rels[0] > TRAIN_MB_LOSS or max(rels) > TRAIN_MB_LOSS_6 \
            or mb_rel > GRAD_TOL[0] or mb_cos < GRAD_TOL[1]:
        fail(f"microbatches=2 against 1: launches {n2}, loss rel {rels}, "
             f"first moments rel {mb_rel} cos {mb_cos}")
    qat["microbatches"] = {"losses_1": l1, "losses_2": l2, "loss_rel": rels,
                           "first_moment_rel_l2": mb_rel,
                           "first_moment_cosine": mb_cos}
    log(f"microbatches=2 against 1 (bf16): losses rel {max(rels):.3g} at "
        f"most ({rels[0]:.3g} at step 0), first moments rel L2 "
        f"{mb_rel:.4g}, cosine {mb_cos:.6f}")
    long_pipe = Pipeline(corpus, batch=1, seq_len=TRAIN_LONG_S, seed=0)
    long_b = [to_device(long_pipe.get_batch(i), dev) for i in range(2)]
    opt_, p_, s_ = fresh(run)
    st = make_train_step(api, run, opt_)
    p_, s_, _ = st(p_, s_, long_b[0])
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    _lib.reset_launches()
    e0.record()
    p_, s_, m_ = st(p_, s_, long_b[1])
    e1.record()
    torch.cuda.synchronize()
    n = dict(_lib.LAUNCHES)
    if n != launches(2 * L, L) or not np.isfinite(float(m_["loss"])):
        fail(f"train at S={TRAIN_LONG_S}: launches {n}, loss {m_['loss']}")
    qat["long"] = {"B": 1, "S": TRAIN_LONG_S, "step_ms": e0.elapsed_time(e1),
                   "loss": float(m_["loss"]), "launches": n}
    log(f"train B=1 x {TRAIN_LONG_S}: a step {e0.elapsed_time(e1):.1f} ms, "
        f"loss {float(m_['loss']):.4f}")
    del p_, s_, m_, st, staged
    rec["qat"] = qat

    # (c) checkpoint and resume through the launcher, at 2 of the layers at
    # full width: 12 straight steps against 6, saved, and 6 resumed
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    real_get = TL.get_config
    TL.get_config = lambda arch: cut
    base = ["--arch", ARCH, "--device", "cuda", "--save-every", "6",
            "--eval-batches", "1"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        a, _ = TL.main(base + ["--steps", "12", "--ckpt-dir",
                               str(work / "r1")], pipe=pipe)
        TL.main(base + ["--steps", "6", "--ckpt-dir", str(work / "r2")],
                pipe=pipe)
        b, _ = TL.main(base + ["--steps", "12", "--ckpt-dir",
                               str(work / "r2"), "--resume"], pipe=pipe)
    finally:
        TL.get_config = real_get
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    paths = tree_leaves(tree_paths(a))
    diff = [(pth, float((x.float() - y.float()).abs().max()))
            for pth, x, y in zip(paths, tree_leaves(a), tree_leaves(b))
            if not torch.equal(x, y)]
    if diff or int(b["opt"]["step"]) != 12:
        fail(f"resume: the resumed state differs from the straight run's "
             f"at {diff[:4]}")
    n_bytes = sum(t.numel() * 4 for t in tree_leaves(a))
    rec["resume"] = {"layers": TRAIN_CUT_LAYERS, "steps": 12,
                     "leaves": len(paths), "bit_identical": True,
                     "checkpoint_bytes": n_bytes, "seconds": sec}
    log(f"resume ({TRAIN_CUT_LAYERS} layers at full width): 12 straight "
        f"steps = 6 + a resumed 6, bit for bit on all {len(paths)} leaves "
        f"of params and moments ({n_bytes / 2 ** 20:.0f} MiB a checkpoint; "
        f"{sec:.1f} s for the three launches)")
    del a, b
    shutil.rmtree(work, ignore_errors=True)

    # (d) one step on the card against the port's CPU step (the CPU's in
    # the worker, compared at the join)
    def leaf_err(x, y):
        return max(float((a_ - b_).abs().max() / b_.abs().max())
                   for a_, b_ in zip(x, y))

    def rel_l2(x, y):
        d = torch.cat([(a_ - b_).reshape(-1) for a_, b_ in zip(x, y)])
        return float(d.norm() / torch.cat([b_.reshape(-1) for b_ in y])
                     .norm())

    b0 = {k_: torch.as_tensor(v_[:2, :64])
          for k_, v_ in pipe.get_batch(0).items()}
    jobs, card = {}, {}
    for dt in ("float32", "bfloat16"):
        jobs[dt] = (dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS,
                                        dtype=dt), b0)
    fams = ("olmoe-1b-7b", "internvl2-26b", "jamba-v0.1-52b",
            "whisper-base", "xlstm-350m")
    for arch in fams:
        rc = reduced(get_config(arch), dtype="float32")
        jobs[arch] = (rc, build(rc, "cpu").make_batch(
            torch.Generator().manual_seed(1), 2, 32))
    for label, (c, b) in jobs.items():
        cp = build(c, "cpu").init_params(
            torch.Generator().manual_seed(0)).tree()
        card[label] = train_first_moments(
            build(c, "cuda"), tree_map(lambda t: t.to(dev), cp),
            tree_map(lambda t: t.to(dev), b), c)
        del cp
    CPU_HALVES.submit("phase 4j", cpu_train_half, jobs)

    def compare():
        got = {k: ([torch.from_numpy(t) for t in v[0]], v[1])
               for k, v in CPU_HALVES.result("phase 4j").items()}
        cvc = {}
        (card32, lc32), (cpu32, lp32) = card["float32"], got["float32"]
        (card16, lc16), (cpu16, lp16) = card["bfloat16"], got["bfloat16"]
        cvc["smollm_2_layers"] = {
            "f32_first_moment_leaf_err": leaf_err(card32, cpu32),
            "f32_loss_rel": abs(lc32 / lp32 - 1),
            "bf16_card_vs_cpu_f32_rel_l2": rel_l2(card16, cpu32),
            "bf16_cpu_vs_cpu_f32_rel_l2": rel_l2(cpu16, cpu32),
            "bf16_loss_card_cpu": [lc16, lp16]}
        sm = cvc["smollm_2_layers"]
        if sm["f32_first_moment_leaf_err"] > TRAIN_F32_TOL \
                or sm["f32_loss_rel"] > TRAIN_F32_TOL \
                or sm["bf16_card_vs_cpu_f32_rel_l2"] > GRAD_TUNE_FACTOR * \
                sm["bf16_cpu_vs_cpu_f32_rel_l2"]:
            fail(f"train card vs CPU (smollm, {TRAIN_CUT_LAYERS} layers): "
                 f"{sm}")
        for arch in fams:
            (card_mu, lc), (cpu_mu, lp) = card[arch], got[arch]
            cvc[arch] = {"first_moment_leaf_err": leaf_err(card_mu, cpu_mu),
                         "loss_rel": abs(lc / lp - 1), "leaves": len(cpu_mu)}
            if cvc[arch]["first_moment_leaf_err"] > TRAIN_FAM_TOL \
                    or cvc[arch]["loss_rel"] > TRAIN_FAM_TOL:
                fail(f"train card vs CPU, {arch}: {cvc[arch]}")
        cvc["cpu_half"] = CPU_HALVES.seconds["phase 4j"]
        rec["card_vs_cpu"] = cvc
        log("train card vs CPU, one step: smollm 2 layers f32 first moments "
            f"{sm['f32_first_moment_leaf_err']:.3g} of a leaf's max, loss "
            f"{sm['f32_loss_rel']:.3g}; bf16 rel L2 from the CPU's f32 "
            f"{sm['bf16_card_vs_cpu_f32_rel_l2']:.4g} (the CPU's bf16 "
            f"{sm['bf16_cpu_vs_cpu_f32_rel_l2']:.4g}); families (reduced, "
            f"f32): " + ", ".join(f"{a_} {cvc[a_]['first_moment_leaf_err']:.3g}"
                                  for a_ in fams))
    CPU_HALVES.later(compare)
    rec["launches"] = rec["launcher"]["launches"]
    rec["kernels"]["act_quant_ptoken"] = {
        "ptoken_launches": qat["ptoken_dynamic"]["launches"][
            "act_quant_ptoken"],
        "ptoken_launches_per_step": qat["ptoken_dynamic"][
            "act_quant_ptoken_per_step"]}
    return rec


# phase 4k, tensor-parallel serving: deepseek-67b at full width (d_model
# 8192, 64 heads, 8 KV heads of 128, d_ff 22016, vocab 102400) cut to 4 of
# its 95 layers, served by one rank in this process and by two ranks
# (launch/mesh.spawn_tp: gloo on the one card, NCCL where there is a card a
# rank); W8A8 with int8-resident weights and an int8 KV cache, fp, and a
# paged int8 ContinuousEngine of 4 slots over 8 requests
TP_ARCH, TP_LAYERS, TP_B, TP_PROMPT, TP_NEW = "deepseek-67b", 4, 4, 512, 32
TP_SLOTS, TP_REQS, TP_PAGE = 4, 8, 64
# fp (none) at tp = 2: the two ranks' bf16 partial products are summed in
# f32 and rounded once, where one rank rounds the whole product: logits
# differ by bf16 roundings. A row's tokens may part only at a near tie: a
# token where one rank's top-1 and top-2 logits lie within TP_FP_TIE (phase
# 5's largest fp card-vs-CPU gap); the prefill logits lie within it
TP_FP_TIE = 0.25
# phase 4k's cases beside W8A8 and fp (name, qcfg, prequant, weight_bits,
# kv_dtype), as serve.py serves them; they are made in tp_phase
TP_MODES = [("w4a8_int8kv", "pt_static", True, 4, "int8"),
            ("pt_dynamic", "pt_dynamic", False, 8, None),
            ("ptoken_dynamic", "ptoken_dynamic", False, 8, None)]
# the dynamic modes' tokens (their rows part at near ties within the first
# 20 of 32 on the NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6; their
# weights are fake-quantized on every call)
TP_DYN_NEW = 16
# the tensor-parallel modes' launch names and the kernel each replaces at
# a rank's row-parallel sites (the range-only launches ride with the
# given-range ones, one each)
TP_MODE_NAMES = {"w4a8_matmul_acc": "w4a8_matmul",
                 "act_quant_ptoken_given": "act_quant_ptoken"}


def merge_tp_modes(counts):
    """A rank's launch counts with its modes' launches counted under the
    kernels they replace: one rank's counts where every check holds."""
    out = {k: v for k, v in counts.items() if k != "act_quant_ptoken_range"}
    for mode, kern in TP_MODE_NAMES.items():
        out[kern] = out.get(kern, 0) + out.pop(mode, 0)
        out[mode] = 0
    out["act_quant_ptoken_range"] = 0
    return out


def tp_mode_launches(name, counts):
    """The modes' launches a rank of phase 4k's run ``name`` must make: the
    two row-parallel sites of each of the TP_LAYERS layers at every one of
    the case's forwards (W4A8: the accumulator mode; ptoken_dynamic: a
    range-only and a given-range launch), none elsewhere. Returns the
    counts, or None where they differ."""
    rows = 2 * TP_LAYERS * (TP_NEW if name == "w4a8_int8kv"
                            else TP_DYN_NEW)
    want = {"w4a8_matmul_acc": rows if name == "w4a8_int8kv" else 0,
            "act_quant_ptoken_given": rows if name == "ptoken_dynamic"
            else 0,
            "act_quant_ptoken_range": rows if name == "ptoken_dynamic"
            else 0}
    got = {k: counts.get(k, 0) for k in want}
    return got if got == want else None


def tp_phase(dev, timed):
    """Phase 4k: tensor-parallel serving of deepseek-67b at full width and
    4 layers (see the module docstring). Returns the record."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core.calibration import calibrate, scales_to_plain
    from repro_torch.kernels import _lib
    from repro_torch.kernels.act_quant import act_quant_static_plain
    from repro_torch.kernels.w8a8_matmul import (
        quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_epilogue,
        w8a8_matmul, w8a8_matmul_plain)
    from repro_torch.launch.mesh import TPMesh, spawn_tp
    from repro_torch.models.registry import build
    tp_probe = import_tp_probe()

    gc.collect()
    torch.cuda.empty_cache()
    rec = {"arch": TP_ARCH, "reduced": f"n_layers {TP_LAYERS} of 95",
           "runs": {}, "script_holds_gib_at_start":
               torch.cuda.memory_allocated() / 2 ** 30}
    cfg = dataclasses.replace(get_config(TP_ARCH), n_layers=TP_LAYERS)
    V, K = cfg.vocab_size, cfg.n_kv_heads
    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    rs = np.random.RandomState(25)
    prompt = rs.randint(0, V, (TP_B, TP_PROMPT))
    calib = [rs.randint(0, V, (TP_B, TP_PROMPT)) for _ in range(2)]
    base = dict(cfg=cfg, seed=0, max_seq=TP_PROMPT + 2 * TP_NEW + 64)
    api = build(cfg, dev)
    t0 = time.perf_counter()
    params = tp_probe._params(api, base)
    cushion = api.extract_cushion(
        params, torch.as_tensor(rs.randint(0, V, CUSHION),
                                dtype=torch.int32), None, QuantConfig())
    scales, _ = calibrate(api, params, [
        {"tokens": torch.as_tensor(c, dtype=torch.int32, device=dev)}
        for c in calib], qw8, cushion=cushion)
    base.update(cushion=tree_map(lambda t: t.cpu(), cushion),
                scales=tree_map(lambda t: t.cpu(), scales_to_plain(scales)))
    rec["setup_s"] = time.perf_counter() - t0
    reqs = [dict(tokens=rs.randint(0, V, (1, (TP_PROMPT // 2,
                                             TP_PROMPT // 2 + 64)[i % 2])),
                 max_new_tokens=(TP_NEW, TP_NEW // 2)[i % 2])
            for i in range(TP_REQS)]
    cases = [dict(base, name="w8a8_int8kv", kind="static", qcfg=qw8,
                  prequant=True, kv_dtype="int8", tokens=prompt,
                  n_tokens=TP_NEW, logits=True, warmup=True),
             dict(base, name="fp", kind="static", qcfg=QuantConfig(),
                  tokens=prompt, n_tokens=TP_NEW, logits=True, warmup=True),
             dict(base, name="paged_w8a8_int8kv", kind="continuous",
                  qcfg=qw8, prequant=True, kv_dtype="int8", paged=True,
                  page_size=TP_PAGE, n_slots=TP_SLOTS, requests=reqs)]
    # W4A8 (int4-resident, int8 KV), pt_dynamic and ptoken_dynamic as
    # serve.py serves them, the ranks once each (no warm-up: their tokens,
    # logits and launches are what is held)
    cases += [dict(base, name=name, kind="static",
                   qcfg=QuantConfig(mode=q, true_int8=q == "pt_static"),
                   prequant=pre, weight_bits=wb, kv_dtype=kv, tokens=prompt,
                   n_tokens=TP_NEW if wb == 4 else TP_DYN_NEW, logits=True)
              for name, q, pre, wb, kv in TP_MODES]
    # the margins at the partings are one rank's; the one rank warms up
    # (its decode graph's capture steps stay out of the launch counts)
    one_rank_only = {"fp": dict(margins=True),
                     **{m[0]: dict(margins=True, warmup=True)
                        for m in TP_MODES}}

    # (1) one rank, in this process, without a mesh
    t0 = time.perf_counter()
    one = {c["name"]: tp_probe.run_case(
        TPMesh(0, 1, None, dev, None),
        dict(c, mesh=False, **one_rank_only.get(c["name"], {})))
        for c in cases}
    rec["one_rank_s"] = time.perf_counter() - t0
    del params, cushion, scales
    tp_probe._TREES.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the MoE, VLM and hybrid runs (phases 4e-4g recorded their one-rank
    # sides), in the same two ranks after deepseek's
    fam_cases = [c for f in TP_FAMILIES.values() for c in f["cases"]]
    all_cases = cases + fam_cases

    def spawned(label):
        t0 = time.perf_counter()
        ranks = spawn_tp(tp_probe.run_cases, 2, all_cases, device=dev.type,
                         every_rank=True, backend=label)
        rec[f"{label}_s"] = time.perf_counter() - t0
        return [{c["name"]: r[i] for i, c in enumerate(all_cases)}
                for r in ranks]

    def held(label, ranks):
        """Every check of the two ranks against one rank."""
        out = {}
        for name, ref in one.items():
            reps = [r[name] for r in ranks]
            for rank, rep in enumerate(reps):
                # the row-parallel sites' launches count under their
                # mode's name (2 sites a layer, a forward a token)
                modes = tp_mode_launches(name, rep["launches"])
                if modes is None or merge_tp_modes(rep["launches"]) \
                        != ref["launches"]:
                    fail(f"tp {label} {name}: rank {rank} launched "
                         f"{rep['launches']}, one rank {ref['launches']}")
            if isinstance(ref["tokens"], dict):
                for rank, rep in enumerate(reps):
                    if sorted(rep["tokens"]) != sorted(ref["tokens"]) or any(
                            not np.array_equal(rep["tokens"][u], t)
                            for u, t in ref["tokens"].items()):
                        fail(f"tp {label} {name}: rank {rank}'s tokens "
                             f"differ from one rank's")
                    if rep["admissions"] != ref["admissions"]:
                        fail(f"tp {label} {name}: rank {rank} admitted "
                             f"{rep['admissions']}, one rank "
                             f"{ref['admissions']}")
                n = K // 2
                for rank, rep in enumerate(reps):
                    for k_ in ("kc", "vc"):
                        v_ = ref["cushion"][k_]
                        if not np.array_equal(rep["cushion"][k_], v_) \
                                or not np.array_equal(
                                    rep["cushion"][k_ + "_tp"],
                                    v_[:, :, n * rank:n * (rank + 1)]):
                            fail(f"tp {label} {name}: rank {rank}'s cushion "
                                 f"block {k_} is not one rank's")
                out[name] = {
                    "ttft_ms_p50": [float(np.median(list(
                        rep["ttft_ms"].values()))) for rep in reps],
                    "tpot_ms_p50": [float(np.median(list(
                        rep["tpot_ms"].values()))) for rep in reps],
                    "seconds": [rep["seconds"] for rep in reps],
                    "one_rank_ttft_ms_p50": float(np.median(list(
                        ref["ttft_ms"].values()))),
                    "one_rank_tpot_ms_p50": float(np.median(list(
                        ref["tpot_ms"].values()))),
                    "one_rank_seconds": ref["seconds"],
                    "peak_gib": [rep["peak_bytes"] / 2 ** 30
                                 for rep in reps],
                    "one_rank_peak_gib": ref["peak_bytes"] / 2 ** 30}
                continue
            for rank, rep in enumerate(reps):
                if not np.array_equal(rep["tokens"], reps[0]["tokens"]):
                    fail(f"tp {label} {name}: the ranks' tokens differ")
                # the cushion block: whole and bit-identical on every rank
                # (int8: kc / vc, one rank's block; fp: each rank's heads
                # of the rows [0:m))
                n = K // 2
                for k_, v_ in ref["cushion"].items():
                    mine = rep["cushion"][k_]
                    want = v_ if k_ in ("kc", "vc") else \
                        v_[..., n * rank:n * (rank + 1), :]
                    if not np.array_equal(mine, want):
                        fail(f"tp {label} {name}: rank {rank}'s cushion "
                             f"{k_} is not one rank's")
                    if k_ in ("kc", "vc") and not np.array_equal(
                            rep["cushion"][k_ + "_tp"],
                            v_[:, :, n * rank:n * (rank + 1)]):
                        fail(f"tp {label} {name}: rank {rank}'s {k_}_tp is "
                             f"not its heads of the block")
            gap = float(np.abs(reps[0]["logits"] - ref["logits"]).max())
            o = {"ttft_ms": [rep["ttft_ms"] for rep in reps],
                 "tpot_ms": [rep["tpot_ms"] for rep in reps],
                 "one_rank_ttft_ms": ref["ttft_ms"],
                 "one_rank_tpot_ms": ref["tpot_ms"],
                 "peak_gib": [rep["peak_bytes"] / 2 ** 30 for rep in reps],
                 "one_rank_peak_gib": ref["peak_bytes"] / 2 ** 30,
                 "prefill_logits_max_abs_err": gap,
                 "tokens_equal": float((reps[0]["tokens"]
                                        == ref["tokens"]).mean())}
            if name == "w8a8_int8kv":
                if gap != 0.0 or not np.array_equal(reps[0]["tokens"],
                                                    ref["tokens"]):
                    fail(f"tp {label} W8A8: the ranks' logits or tokens are "
                         f"not one rank's (prefill logits max |err| {gap})")
            else:
                # fp: the logits within the bound; the modes of TP_MODES:
                # printed (a range that moves by an ulp flips codes: the
                # near ties gate)
                if name == "fp" and gap > TP_FP_TIE:
                    fail(f"tp {label} fp: prefill logits max |err| {gap} > "
                         f"{TP_FP_TIE}")
                parts = []
                for b in range(TP_B):
                    diff = np.flatnonzero(reps[0]["tokens"][b]
                                          != ref["tokens"][b])
                    if not diff.size:
                        parts.append(None)
                        continue
                    first = int(diff[0])
                    margin = float(ref["margins"][b, first])
                    if margin >= TP_FP_TIE:
                        fail(f"tp {label} {name}: row {b} parts at token "
                             f"{first}, where one rank's top-2 margin is "
                             f"{margin} (no near tie: >= {TP_FP_TIE})")
                    parts.append([first, margin])
                o["first_part_and_its_margin"] = parts
            out[name] = o
        return out

    ranks = spawned("gloo")
    backend = ranks[0]["w8a8_int8kv"]["backend"]
    rec["backend"] = backend
    rec["runs"]["two_ranks"] = held("gloo", ranks)
    rec["families"] = {"two_ranks": tp_family_checks("gloo", ranks)}
    rec["launches"] = {}
    for name in one:
        for k_, v_ in ranks[0][name]["launches"].items():
            rec["launches"][k_] = rec["launches"].get(k_, 0) + v_
    # rank 0's launches in each family's runs, for the kernels line
    rec["family_launches"] = {}
    for arch, fam in TP_FAMILIES.items():
        tot = rec["family_launches"].setdefault(TP_FAMILY_TAG[arch], {})
        for c in fam["cases"]:
            for k_, v_ in ranks[0][c["name"]]["launches"].items():
                tot[k_] = tot.get(k_, 0) + v_
    if torch.cuda.device_count() >= 2:
        nccl = spawned("nccl")
        rec["runs"]["nccl"] = held("nccl", nccl)
        rec["families"]["nccl"] = tp_family_checks("nccl", nccl)
    for name, o in rec["runs"]["two_ranks"].items():
        if "ttft_ms" in o:
            log(f"tp=2 ({backend}) {name}: TTFT {o['ttft_ms'][0]:.1f} ms "
                f"(one rank {o['one_rank_ttft_ms']:.1f}), TPOT "
                f"{o['tpot_ms'][0]:.2f} ms (one rank "
                f"{o['one_rank_tpot_ms']:.2f}), peak "
                f"{o['peak_gib'][0]:.2f} / {o['peak_gib'][1]:.2f} GiB "
                f"(one rank {o['one_rank_peak_gib']:.2f}); prefill logits "
                f"max |err| {o['prefill_logits_max_abs_err']:.4g}, tokens "
                f"equal {o['tokens_equal']:.3f}")
        else:
            log(f"tp=2 ({backend}) {name}: {TP_REQS} requests in "
                f"{o['seconds'][0]:.2f} s (one rank "
                f"{o['one_rank_seconds']:.2f}), TTFT p50 "
                f"{o['ttft_ms_p50'][0]:.1f} ms (one rank "
                f"{o['one_rank_ttft_ms_p50']:.1f}), TPOT p50 "
                f"{o['tpot_ms_p50'][0]:.2f} ms (one rank "
                f"{o['one_rank_tpot_ms_p50']:.2f}); tokens, admissions and "
                f"the cushion block equal")

    # the int matmul's int32 mode at the row-parallel sites' shards
    g = torch.Generator(dev).manual_seed(25)
    sx, zx = (torch.tensor(v, device=dev) for v in (0.031, 111.0))
    sw = torch.tensor(0.0042, device=dev).to(torch.bfloat16)
    N = cfg.d_model
    i32 = {}
    for site, Kk in (("o", cfg.n_heads * cfg.head_dim // 2),
                     ("down", cfg.d_ff // 2)):
        w = torch.randint(-127, 128, (Kk, N), generator=g, device=dev,
                          dtype=torch.int8)
        colsum = w.sum(0, dtype=torch.int32)
        for M in (TP_B, TP_B * TP_PROMPT):
            if M <= 16:     # decode: bf16 x quantized in the staging
                x = torch.randn((M, Kk), generator=g, device=dev).mul_(
                    3).to(torch.bfloat16)
                f_acc = lambda: quant_w8a8_matmul(   # noqa: E731
                    x, w, sx, zx, sw, out_dtype=torch.int32)
                f_out = lambda: quant_w8a8_matmul(   # noqa: E731
                    x, w, sx, zx, sw, colsum, out_dtype=torch.bfloat16)
                want = quant_w8a8_matmul_plain(x, w, sx, zx, sw,
                                               out_dtype=torch.int32)
                xb = M * Kk * 2
            else:           # prefill: int8 codes
                x = torch.randint(-128, 128, (M, Kk), generator=g,
                                  device=dev, dtype=torch.int8)
                f_acc = lambda: w8a8_matmul(          # noqa: E731
                    x, w, sx, zx, sw, out_dtype=torch.int32)
                f_out = lambda: w8a8_matmul(          # noqa: E731
                    x, w, sx, zx, sw, colsum, -128.0, torch.bfloat16)
                want = w8a8_matmul_plain(x, w, sx, zx, sw,
                                         out_dtype=torch.int32)
                xb = M * Kk
            acc = f_acc()
            if not torch.equal(acc, want):
                fail(f"w8a8_matmul int32 mode ({site}, M={M}) differs from "
                     f"its plain version")
            if M > 16:
                # two K-halves summed, the epilogue once = the whole launch
                h = Kk // 2
                halves = [w8a8_matmul(x[:, s_].contiguous(),
                                      w[s_].contiguous(), sx, zx, sw,
                                      out_dtype=torch.int32)
                          for s_ in (slice(0, h), slice(h, Kk))]
                whole = f_out()
                if not torch.equal(whole, w8a8_epilogue(
                        halves[0] + halves[1], sx, zx, sw, colsum, -128.0,
                        torch.bfloat16)):
                    fail(f"w8a8_matmul ({site}, M={M}): two K-halves' int32 "
                         f"sums with the epilogue are not the whole launch")
            b_ms, b_by = bound_ms(xb + Kk * N + 4 * M * N, 2 * M * N * Kk,
                                  INT8_OPS_PER_S)
            # the library's int8 x int8 -> int32 product: torch._int_mm
            # (M > 16: at decode x's codes zero-padded to 32 rows, the copy
            # made outside the timed window, as on the kernels line)
            if M <= 16:
                xl = torch.zeros((32, Kk), dtype=torch.int8, device=dev)
                xl[:M] = act_quant_static_plain(x, sx, zx)
            else:
                xl = x
            i32[f"{site}_M{M}"] = {
                "K": Kk, "N": N, "M": M, "int32_ms": timed(f_acc),
                "epilogue_bf16_ms": timed(f_out),
                "int32_plain_ms": timed(lambda: (quant_w8a8_matmul_plain(
                    x, w, sx, zx, sw, out_dtype=torch.int32) if M <= 16
                    else w8a8_matmul_plain(x, w, sx, zx, sw,
                                           out_dtype=torch.int32)), iters=3),
                "int32_library_ms": timed(lambda: torch._int_mm(xl, w)),
                "int32_library_of": ("torch._int_mm" if M > 16 else
                                     "torch._int_mm, x's codes zero-padded "
                                     "to 32 rows"),
                "int32_bound_ms": b_ms, "int32_bound_by": b_by}
    rec["int32_mode"] = i32
    log("w8a8_matmul's int32 mode at deepseek-67b's tp = 2 shards (ms: "
        "int32 / the bf16 epilogue launch): " + ", ".join(
            f"{k_} {v_['int32_ms']:.4f} / {v_['epilogue_bf16_ms']:.4f}"
            for k_, v_ in i32.items()))
    dec = [i32[f"{s_}_M{TP_B}"] for s_ in ("o", "down")]
    rec["kernels"] = {"w8a8_matmul": {
        "int32_unit": f"the two row-parallel sites of one layer at one "
                      f"rank's shard of deepseek-67b at tp=2 (o: K="
                      f"{dec[0]['K']}, down: K={dec[1]['K']}, N={N}), "
                      f"M={TP_B}, bf16 x quantized in the staging",
        "int32_ms": sum(d["int32_ms"] for d in dec),
        "int32_epilogue_ms": sum(d["epilogue_bf16_ms"] for d in dec),
        "int32_bound_ms": sum(d["int32_bound_ms"] for d in dec),
        "int32_plain_ms": sum(d["int32_plain_ms"] for d in dec),
        "int32_library_ms": sum(d["int32_library_ms"] for d in dec),
        "int32_library_of": dec[0]["int32_library_of"]}}
    for name, r in tp_kernel_rows(dev, timed, cfg).items():
        rec["kernels"].setdefault(name, {}).update(r)
    for name, r in tp_mode_rows(dev, timed, cfg).items():
        rec["kernels"].setdefault(name, {}).update(r)
    # rank 0's launches of the modes in the runs above
    rec["kernels"]["w4a8_matmul"]["acc_launches"] = \
        rec["launches"].get("w4a8_matmul_acc", 0)
    rec["kernels"]["act_quant_ptoken"].update(
        range_launches=rec["launches"].get("act_quant_ptoken_range", 0),
        given_launches=rec["launches"].get("act_quant_ptoken_given", 0))
    for name, r in tp_family_kernel_rows(dev, timed).items():
        rec["kernels"].setdefault(name, {}).update(r)
    return rec


def tp_family_kernel_rows(dev, timed):
    """Phase 4k's kernels at the shapes the MoE, VLM and hybrid runs give a
    rank of two where they differ from deepseek's, each against its plain
    version on the same inputs (random, from a seed): w8a8_matmul's int32
    mode at jamba's ``mamba_out`` shard (K = 4096 of its 8192 channels,
    N = 4096; decode, bf16 x quantized in the staging, and prefill, int8
    codes), torch.equal; internvl2's attention at a rank's 24 query heads
    over 4 KV heads (G = 6, head_dim 128): the prefill over [1024 patches;
    512 tokens] behind the 4-row cushion, and the int8 decode with the
    cushion, within phase 4k's bars. Returns {kernel: the tp_* keys of the
    kernels line}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.act_quant import act_quant_static_plain
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.w8a8_matmul import (
        quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_matmul,
        w8a8_matmul_plain)
    from repro_torch.models import ssm as SSM
    from repro_torch.serving.engine import cache_seq_len

    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(271)
    out = {}

    def within(name, got, want, floor_rel):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        floor = floor_rel * float(want.abs().max()) if floor_rel else 1e-6
        if not bool((err <= BF16_ULP * want.abs() + floor).all()):
            fail(f"phase 4k {name}: max |kernel - plain| "
                 f"{float(err.max())} beyond its bar")
        return float(err.max())

    # jamba's mamba_out at a rank: int32 out, the epilogue after the sum
    hy = get_config(HY_ARCH)
    inner = SSM.dims(hy)[0]
    Kk, N = inner // 2, hy.d_model
    sx, zx = (torch.tensor(v_, device=dev) for v_ in (0.027, 119.0))
    sw = torch.tensor(0.0039, device=dev).to(bf)
    w = torch.randint(-127, 128, (Kk, N), generator=g, device=dev,
                      dtype=torch.int8)
    i32 = {}
    for M in (B, B * PROMPT):
        if M <= 16:
            x = (torch.randn((M, Kk), generator=g, device=dev) * 3).to(bf)
            f = lambda: quant_w8a8_matmul(         # noqa: E731
                x, w, sx, zx, sw, out_dtype=torch.int32)
            fp = lambda: quant_w8a8_matmul_plain(  # noqa: E731
                x, w, sx, zx, sw, out_dtype=torch.int32)
            xl = torch.zeros((32, Kk), dtype=torch.int8, device=dev)
            xl[:M] = act_quant_static_plain(x, sx, zx)
            xb = 2 * M * Kk
        else:
            x = torch.randint(-128, 128, (M, Kk), generator=g, device=dev,
                              dtype=torch.int8)
            f = lambda: w8a8_matmul(               # noqa: E731
                x, w, sx, zx, sw, out_dtype=torch.int32)
            fp = lambda: w8a8_matmul_plain(        # noqa: E731
                x, w, sx, zx, sw, out_dtype=torch.int32)
            xl = x
            xb = M * Kk
        if not torch.equal(f(), fp()):
            fail(f"phase 4k w8a8_matmul int32 mode at jamba's mamba_out "
                 f"shard (M={M}) differs from its plain version")
        bms, by = bound_ms(xb + Kk * N + 4 * M * N, 2.0 * M * N * Kk,
                           INT8_OPS_PER_S)
        i32[M] = {"ms": timed(f), "plain_ms": timed(fp, 3),
                  "library_ms": timed(lambda: torch._int_mm(xl, w)),
                  "bound_ms": bms, "bound_by": by}
    d = i32[B]
    out["w8a8_matmul"] = {
        "mamba_out_int32_unit": f"jamba-v0.1-52b's mamba_out at a rank of "
                                f"tp = 2 (K={Kk}, N={N}), M={B}, bf16 x "
                                f"quantized in the staging, int32 out",
        "mamba_out_int32_ms": d["ms"], "mamba_out_int32_plain_ms":
        d["plain_ms"], "mamba_out_int32_bound_ms": d["bound_ms"],
        "mamba_out_int32_library_ms": d["library_ms"],
        "mamba_out_int32_prefill_ms": i32[B * PROMPT]["ms"],
        "mamba_out_int32_prefill_bound_ms": i32[B * PROMPT]["bound_ms"],
        "mamba_out_int32_max_abs_err": 0.0}
    del w, x, xl

    # internvl2's attention at a rank: 24 query heads over 4 KV heads
    vl = get_config(VLM_ARCH)
    H, Kh, hd, m = vl.n_heads // 2, vl.n_kv_heads // 2, vl.head_dim, CUSHION
    S = vl.vlm.num_patches + VLM_TEXT

    def rnd(*shape, dtype=bf):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q = rnd(B, S, H, hd).transpose(1, 2)
    k = rnd(B, S + m, Kh, hd).transpose(1, 2)
    v = rnd(B, S + m, Kh, hd).transpose(1, 2)
    e = within("flash_attention G=6", flash_attention(q, k, v, prefix_len=m),
               flash_attention_plain(q, k, v, prefix_len=m), 0)
    pairs = B * H * (S * m + S * (S + 1) / 2)
    bms, by = bound_ms(2 * (2 * B * H * S * hd + 2 * B * Kh * (S + m) * hd),
                       4.0 * hd * pairs, BF16_FLOPS_PER_S)
    out["flash_attention"] = {
        "g6_unit": f"internvl2-26b at a rank of tp = 2: B={B}, {H} query / "
                   f"{Kh} KV heads (G = 6), S={S} behind m={m}",
        "g6_ms": timed(lambda: flash_attention(q, k, v, prefix_len=m)),
        "g6_plain_ms": timed(lambda: flash_attention_plain(
            q, k, v, prefix_len=m), 3),
        "g6_bound_ms": bms, "g6_bound_by": by, "g6_max_abs_err": e}
    del q, k, v
    Smax = cache_seq_len(S + VLM_NEW + 32)
    pos_v = m + S + VLM_NEW // 2
    qd = rnd(B, H, hd)
    kq, vq = rnd(B, Smax, Kh, hd, dtype=torch.int8), \
        rnd(B, Smax, Kh, hd, dtype=torch.int8)
    sc = torch.rand((Kh,), generator=g, device=dev) * 0.05 + 0.01
    kw = dict(k_scale=sc, v_scale=sc.flip(0).contiguous(),
              kc=rnd(m, Kh, hd), vc=rnd(m, Kh, hd))
    pos = torch.tensor(pos_v, dtype=torch.int32, device=dev)
    e = within("flash_decode G=6", flash_decode(qd, kq, vq, pos, **kw),
               flash_decode_plain(qd, kq, vq, pos, **kw), TP_DECODE_FLOOR)
    live = pos_v + 1 - m
    bms, by = bound_ms(4 * B * H * hd + 2 * B * live * Kh * hd
                       + 4 * m * Kh * hd + 8 * Kh,
                       4.0 * B * H * hd * (pos_v + 1), BF16_FLOPS_PER_S)
    out["flash_decode"] = {
        "g6_unit": f"internvl2-26b at a rank of tp = 2: B={B}, {H} query / "
                   f"{Kh} KV heads, int8 cache with the cushion, pos {pos_v}",
        "g6_ms": timed(lambda: flash_decode(qd, kq, vq, pos, **kw)),
        "g6_plain_ms": timed(lambda: flash_decode_plain(qd, kq, vq, pos,
                                                        **kw), 3),
        "g6_bound_ms": bms, "g6_bound_by": by, "g6_max_abs_err": e}
    for name, r in tp_encdec_kernel_rows(dev, timed, within, rnd).items():
        out.setdefault(name, {}).update(r)
    log("phase 4k at the families' rank shapes: w8a8_matmul int32 at "
        f"jamba's mamba_out shard {d['ms']:.4f} ms (plain "
        f"{d['plain_ms']:.4f}, bound {d['bound_ms']:.4f}, _int_mm "
        f"{d['library_ms']:.4f}), torch.equal; internvl2 G = 6: "
        f"flash_attention {out['flash_attention']['g6_ms']:.4f} ms (plain "
        f"{out['flash_attention']['g6_plain_ms']:.4f}, bound "
        f"{out['flash_attention']['g6_bound_ms']:.4f}), flash_decode "
        f"{out['flash_decode']['g6_ms']:.4f} ms (plain "
        f"{out['flash_decode']['g6_plain_ms']:.4f}, bound "
        f"{out['flash_decode']['g6_bound_ms']:.4f}), each within its bar")
    return out


def tp_encdec_kernel_rows(dev, timed, within, rnd):
    """Phase 4k's kernels at whisper-base's shapes at a rank of two (4 of
    its 8 heads of 64, G = 1, bf16), each against its plain version on
    the same random inputs, within phase 4k's bars: the non-causal
    ``flash_attention`` of the encoder (S = T = 1,500), of the
    cross-attention's prefill (S = 256 over the 1,500 frames) and of its
    decode (S = 1), beside SDPA; ``flash_decode`` over the fp cache with
    the cushion's rows in it; ``w8a8_matmul``'s int32 mode at the
    cross-attention's ``wo`` shard (K = 256 of 512, N = 512; decode on
    bf16 x quantized in the staging, prefill on int8 codes), torch.equal,
    the two ranks' partials with the epilogue once equal to the whole
    launch. Returns {kernel: {"encdec_rank": ...}}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.act_quant import act_quant_static_plain
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.w8a8_matmul import (
        quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_epilogue,
        w8a8_matmul, w8a8_matmul_plain)
    from repro_torch.serving.engine import cache_seq_len

    wh = get_config(ED_ARCH)
    H, hd, Te = wh.n_heads // 2, wh.head_dim, wh.encdec.encoder_seq
    fa = {}
    for tag, S in (("encoder", Te), ("cross_prefill", ED_PROMPT),
                   ("cross_decode", 1)):
        q, k, v = rnd(B, H, S, hd), rnd(B, H, Te, hd), rnd(B, H, Te, hd)
        e = within(f"flash_attention non-causal at whisper's rank ({tag})",
                   flash_attention(q, k, v, causal=False),
                   flash_attention_plain(q, k, v, causal=False), 0)
        bms, by = bound_ms(2 * (2 * B * H * S * hd + 2 * B * H * Te * hd),
                           4.0 * hd * B * H * S * Te, BF16_FLOPS_PER_S)
        fa[tag] = {
            "unit": f"whisper-base at a rank of tp = 2: B={B}, {H} heads of "
                    f"{hd}, S={S} over T={Te}, non-causal",
            "ms": timed(lambda: flash_attention(q, k, v, causal=False)),
            "plain_ms": timed(lambda: flash_attention_plain(
                q, k, v, causal=False), 3),
            "library_ms": timed(lambda: F.scaled_dot_product_attention(
                q, k, v)),
            "bound_ms": bms, "bound_by": by, "max_abs_err": e}
        del q, k, v
    smax = cache_seq_len(ED_PROMPT + ED_NEW + 32)
    pos_v = CUSHION + ED_PROMPT + ED_NEW // 2
    qd, kf, vf = rnd(B, H, hd), rnd(B, smax, H, hd), rnd(B, smax, H, hd)
    pos = torch.tensor(pos_v, dtype=torch.int32, device=dev)
    e = within("flash_decode at whisper's rank", flash_decode(qd, kf, vf, pos),
               flash_decode_plain(qd, kf, vf, pos), TP_DECODE_FLOOR)
    bms, by = bound_ms(4 * B * H * hd + 4 * B * (pos_v + 1) * H * hd,
                       4.0 * B * H * hd * (pos_v + 1), BF16_FLOPS_PER_S)
    fd = {"unit": f"whisper-base at a rank of tp = 2: B={B}, {H} heads of "
                  f"{hd}, fp cache, pos {pos_v} of {smax}",
          "ms": timed(lambda: flash_decode(qd, kf, vf, pos)),
          "plain_ms": timed(lambda: flash_decode_plain(qd, kf, vf, pos), 3),
          "bound_ms": bms, "bound_by": by, "max_abs_err": e}
    del qd, kf, vf
    # the cross-attention's wo at a rank: int32 out, the epilogue after
    # the ranks' sum
    g = torch.Generator(dev).manual_seed(277)
    Kk, N = H * hd, wh.d_model
    sx, zx = (torch.tensor(v_, device=dev) for v_ in (0.029, 113.0))
    sw = torch.tensor(0.0041, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (2 * Kk, N), generator=g, device=dev,
                      dtype=torch.int8)
    colsum = w.sum(0, dtype=torch.int32)
    i32 = {}
    for M in (B, B * ED_PROMPT):
        if M <= 16:
            x = (torch.randn((M, 2 * Kk), generator=g, device=dev) * 3).to(
                torch.bfloat16)
            mm = lambda xx, ww, **kw: quant_w8a8_matmul(  # noqa: E731
                xx, ww, sx, zx, sw, **kw)
            pm = quant_w8a8_matmul_plain
            whole = mm(x, w, colsum=colsum, out_dtype=torch.bfloat16)
            xl = torch.zeros((32, Kk), dtype=torch.int8, device=dev)
            xl[:M] = act_quant_static_plain(x[:, :Kk], sx, zx)
            xb = 2 * M * Kk
        else:
            x = torch.randint(-128, 128, (M, 2 * Kk), generator=g,
                              device=dev, dtype=torch.int8)
            mm = lambda xx, ww, **kw: w8a8_matmul(  # noqa: E731
                xx, ww, sx, zx, sw, **kw)
            pm = w8a8_matmul_plain
            whole = w8a8_matmul(x, w, sx, zx, sw, colsum, -128.0,
                                torch.bfloat16)
            xl = x[:, :Kk].contiguous()
            xb = M * Kk
        halves = [(x[:, r * Kk:(r + 1) * Kk].contiguous(),
                   w[r * Kk:(r + 1) * Kk].contiguous()) for r in range(2)]
        parts = [mm(xx, ww, out_dtype=torch.int32) for xx, ww in halves]
        for (xx, ww), got in zip(halves, parts):
            if not torch.equal(got, pm(xx, ww, sx, zx, sw,
                                       out_dtype=torch.int32)):
                fail(f"phase 4k w8a8_matmul int32 mode at whisper's "
                     f"xattn/wo shard (M={M}) differs from its plain "
                     f"version")
        if not torch.equal(whole, w8a8_epilogue(
                parts[0] + parts[1], sx, zx, sw, colsum, -128.0,
                torch.bfloat16)):
            fail(f"phase 4k w8a8_matmul at whisper's xattn/wo (M={M}): the "
                 f"two ranks' int32 partials with the epilogue are not the "
                 f"whole launch")
        xx, ww = halves[0]
        bms, by = bound_ms(xb + Kk * N + 4 * M * N, 2.0 * M * N * Kk,
                           INT8_OPS_PER_S)
        i32[M] = {"ms": timed(lambda: mm(xx, ww, out_dtype=torch.int32)),
                  "plain_ms": timed(lambda: pm(xx, ww, sx, zx, sw,
                                               out_dtype=torch.int32), 3),
                  "library_ms": timed(lambda: torch._int_mm(xl, ww)),
                  "bound_ms": bms, "bound_by": by}
    log("phase 4k at whisper-base's rank shapes (4 heads of 64), ms (plain, "
        "bound; SDPA): " + ", ".join(
            f"flash_attention {t} {r['ms']:.4f} ({r['plain_ms']:.4f}, "
            f"{r['bound_ms']:.4f}; {r['library_ms']:.4f})"
            for t, r in fa.items())
        + f", flash_decode {fd['ms']:.4f} ({fd['plain_ms']:.4f}, "
        f"{fd['bound_ms']:.4f}), w8a8_matmul int32 at xattn/wo M={B} "
        f"{i32[B]['ms']:.4f} ({i32[B]['plain_ms']:.4f}, "
        f"{i32[B]['bound_ms']:.4f}; _int_mm {i32[B]['library_ms']:.4f}); "
        f"each within its bar, the int32 mode torch.equal")
    return {"flash_attention": {"encdec_rank": fa},
            "flash_decode": {"encdec_rank": fd},
            "w8a8_matmul": {"encdec_rank_xo_int32": {
                "unit": f"whisper-base's xattn/wo at a rank of tp = 2 "
                        f"(K={Kk} of {2 * Kk}, N={N}), int32 out; M={B}: "
                        f"bf16 x quantized in the staging, M={B * ED_PROMPT}"
                        f": int8 codes",
                "decode": i32[B], "prefill": i32[B * ED_PROMPT],
                "max_abs_err": 0.0}}}


# phase 4k's MoE, VLM and hybrid runs: two ranks against one rank on the
# same seed, cushion, scales and prompt (the one-rank side from phases
# 4e-4g). A row's tokens may part from one rank's only at a near tie: a
# token where one rank's top-1 and top-2 logits lie within the model's
# bound. The VLM is the dense family
# (TP_FP_TIE). In olmoe and jamba the experts' partial outputs are summed
# in f32 over the ranks where one rank's einsum rounds its f32 sum once,
# so a MoE output may land one bf16 ulp apart, which can send a token
# whose 8th and 9th (olmoe) or 2nd and 3rd (jamba) gate probabilities
# nearly tie to another expert in the next layer and move that position's
# logits by O(1): the bound is MOE_LOGIT_TOL's largest, 1.0.
# whisper-base is the dense family's arithmetic (its five row-parallel
# sites sum as the dense family's do) and the xLSTM sums nothing over the
# ranks (its ranks differ only in the mLSTM value columns they hold):
# TP_FP_TIE.
TP_FAM_TIE = {"olmoe-1b-7b": 1.0, "internvl2-26b": TP_FP_TIE,
              "jamba-v0.1-52b": 1.0, "whisper-base": TP_FP_TIE,
              "xlstm-350m": TP_FP_TIE}
# The prefill logits: under W8A8 every site but the experts sums int32
# and the experts' partial outputs meet in f32, so they lie within the
# same bound (jamba's were one rank's bit for bit on an H100 once the
# Mamba projection was formed whole on every rank, models/ssm.py). Under
# fp the
# ranks' bf16 partial products and column shards round otherwise than one
# rank's whole products, and jamba's Mamba recurrence carries those
# roundings over 512 positions (up to 2.4 on an H100): they are printed,
# and the tokens' near ties hold the run.
TP_FAMILY_TAG = {"olmoe-1b-7b": "moe", "internvl2-26b": "vlm",
                 "jamba-v0.1-52b": "hybrid", "whisper-base": "encdec",
                 "xlstm-350m": "xlstm"}


def _flat_state(tree, prefix=""):
    """A cushion state tree's leaves by their dotted path, as numpy f32
    (the rank program's ``cushion_state`` keys)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree.float().numpy()}


def _state_slice(key, whole, n, rank):
    """Rank ``rank``'s part of a cushion state leaf, ``n`` entries of its
    cut axis, as the rank's prefill reads it: the Mamba ``h`` on its
    channel rows and ``conv`` on its channel columns (jamba), the mLSTM
    memory ``m.C`` on its value columns (the xLSTM); every other xLSTM
    leaf whole."""
    import numpy as np
    ax = {"h": -2, "conv": -1, "m.C": -1}.get(key)
    if ax is None:
        return whole
    return np.take(whole, range(n * rank, n * (rank + 1)), axis=ax)


def _first_parts(got, want, margins, tie, label):
    """[first index, one rank's margin there] of each row (None where the
    rows are equal); fails where a row parts at no near tie."""
    import numpy as np
    parts = []
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if not diff.size:
            parts.append(None)
            continue
        first = int(diff[0])
        margin = float(margins[b][first])
        if margin >= tie:
            fail(f"tp {label}: row {b} parts at token {first}, where one "
                 f"rank's top-2 margin is {margin} (no near tie: >= {tie})")
        parts.append([first, margin])
    return parts


def tp_family_checks(label, ranks):
    """Phase 4k's MoE, VLM and hybrid runs on two ranks against one rank:
    exact launches of every kernel a rank; the ranks' tokens equal; the
    tokens equal to one rank's up to near ties (``_first_parts``), the
    W8A8 prefill logits within the same bound (fp: printed); the int8
    cushion block kc /
    vc whole on every rank and bit-identical to the artifact (kc_tp / vc_tp
    the rank's KV heads of it), an fp cache's rows [0:m) the rank's heads;
    jamba's Mamba cushion state each rank's channel slice of the
    artifact; the paged pool's admissions one rank's. Returns the record:
    TTFT / TPOT and the peak memory a rank beside one rank's, the share of
    tokens equal, each parting and its margin."""
    import numpy as np
    out = {}
    for arch, fam in TP_FAMILIES.items():
        tie = TP_FAM_TIE[arch]
        for case in fam["cases"]:
            name = case["name"]
            mode = name.split("/", 1)[1]
            reps = [r[name] for r in ranks]
            if case["kind"] == "continuous":
                ref = fam["pool"]
                want_launches = fam["pool_launches"]
            else:
                ref = fam["one"][mode]
                want_launches = ref["launches"]
            for rank, rep in enumerate(reps):
                if rep["launches"] != want_launches:
                    fail(f"tp {label} {name}: rank {rank} launched "
                         f"{rep['launches']}, one rank {want_launches}")
            if case["kind"] == "continuous":
                o = {"seconds": [rep["seconds"] for rep in reps],
                     "one_rank_seconds": ref["seconds"],
                     "peak_gib": [rep["peak_bytes"] / 2 ** 30
                                  for rep in reps]}
                for rank, rep in enumerate(reps):
                    if sorted(rep["tokens"]) != sorted(ref["tokens"]):
                        fail(f"tp {label} {name}: rank {rank} finished "
                             f"other requests")
                    if rep["admissions"] != ref["admissions"]:
                        fail(f"tp {label} {name}: rank {rank} admitted "
                             f"{rep['admissions']}, one rank "
                             f"{ref['admissions']}")
                    for k_ in ("kc", "vc"):
                        if k_ not in rep["cushion"]:
                            continue
                        want = case["cushion"]["kv"][k_[0]].float().numpy()
                        if not np.array_equal(rep["cushion"][k_], want):
                            fail(f"tp {label} {name}: rank {rank}'s "
                                 f"cushion block {k_} is not the artifact")
                    if "slot_rows" in rep:
                        # a contiguous fp pool: every slot's rows [0:m)
                        # hold the rank's heads of the cushion
                        rows = rep["slot_rows"]
                        n = rows.shape[-2]
                        want = case["cushion"]["kv"]["k"].float().numpy()[
                            :, None, :, n * rank:n * (rank + 1)]
                        if not np.array_equal(rows, np.broadcast_to(
                                want, rows.shape)):
                            fail(f"tp {label} {name}: rank {rank}'s slots' "
                                 f"cushion rows are not its heads of the "
                                 f"artifact")
                uids = sorted(ref["tokens"])
                got = [reps[0]["tokens"][u] for u in uids]
                want = [ref["tokens"][u] for u in uids]
                o["first_part_and_its_margin"] = {
                    u: _first_parts(g_[None], w_[None],
                                    ref["margins"][u][None], tie,
                                    f"{label} {name} request {u}")[0]
                    for u, g_, w_ in zip(uids, got, want)}
                o["tokens_equal"] = float(np.mean(np.concatenate(
                    [g_ == w_ for g_, w_ in zip(got, want)])))
                out[name] = o
                continue
            art = {k: case["cushion"]["kv"][k].float().numpy()
                   for k in ("k", "v")} if "kv" in case["cushion"] else {}
            for rank, rep in enumerate(reps):
                if not np.array_equal(rep["tokens"], reps[0]["tokens"]):
                    fail(f"tp {label} {name}: the ranks' tokens differ")
                cu = rep["cushion"]
                if not art:
                    pass        # a cushion of state only (the xLSTM)
                elif "kc" in cu:
                    for c_, k_ in (("kc", "k"), ("vc", "v")):
                        n = cu[c_ + "_tp"].shape[-2]
                        if not np.array_equal(cu[c_], art[k_]) \
                                or not np.array_equal(
                                    cu[c_ + "_tp"],
                                    art[k_][:, :, n * rank:n * (rank + 1)]):
                            fail(f"tp {label} {name}: rank {rank}'s cushion "
                                 f"block {c_} is not the artifact's")
                else:
                    for c_, k_ in (("k_rows", "k"), ("v_rows", "v")):
                        n = cu[c_].shape[-2]
                        want = art[k_][:, :, n * rank:n * (rank + 1)]
                        if not np.array_equal(cu[c_], np.broadcast_to(
                                want[:, None], cu[c_].shape)):
                            fail(f"tp {label} {name}: rank {rank}'s cushion "
                                 f"rows {c_} are not its heads of the "
                                 f"artifact")
                if "cushion_state" in rep:
                    whole = _flat_state(case["cushion"]["state"])
                    if sorted(whole) != sorted(rep["cushion_state"]):
                        fail(f"tp {label} {name}: rank {rank}'s cushion "
                             f"state holds {sorted(rep['cushion_state'])}")
                    for k_, v_ in rep["cushion_state"].items():
                        n = v_.shape[-2 if k_ == "h" else -1]
                        want = _state_slice(k_, whole[k_], n, rank)
                        if not np.array_equal(v_, want):
                            fail(f"tp {label} {name}: rank {rank}'s "
                                 f"cushion state {k_} is not its part of "
                                 f"the artifact")
            err = np.abs(reps[0]["logits"] - ref["logits"])
            gap, mean = float(err.max()), float(err.mean())
            if case["prequant"] and gap > tie:
                fail(f"tp {label} {name}: prefill logits max |err| {gap} > "
                     f"{tie}")
            out[name] = {
                "bit_for_bit": bool(gap == 0.0 and np.array_equal(
                    reps[0]["tokens"], ref["tokens"])),
                "ttft_ms": [rep["ttft_ms"] for rep in reps],
                "tpot_ms": [rep["tpot_ms"] for rep in reps],
                "one_rank_ttft_ms": ref["ttft_ms"],
                "one_rank_tpot_ms": ref["tpot_ms"],
                "peak_gib": [rep["peak_bytes"] / 2 ** 30 for rep in reps],
                "one_rank_peak_gib_phase": ref["peak_bytes"] / 2 ** 30,
                "request_gib": [(rep["peak_bytes"] - rep["held_bytes"])
                                / 2 ** 30 for rep in reps],
                "one_rank_request_gib": ref.get("request_bytes", 0)
                / 2 ** 30,
                "prefill_logits_max_abs_err": gap,
                "prefill_logits_mean_abs_err": mean,
                "prefill_logits_row_max_abs_err": err.max(1).tolist(),
                "tokens_equal": float((reps[0]["tokens"]
                                       == ref["tokens"]).mean()),
                "first_part_and_its_margin": _first_parts(
                    reps[0]["tokens"], ref["tokens"], ref["margins"], tie,
                    f"{label} {name}"),
                "near_tie_bound": tie}
    for name, o in out.items():
        if "ttft_ms" in o:
            log(f"tp=2 ({label}) {name}: TTFT {o['ttft_ms'][0]:.1f} ms (one "
                f"rank {o['one_rank_ttft_ms']:.1f}), TPOT "
                f"{o['tpot_ms'][0]:.2f} ms (one rank "
                f"{o['one_rank_tpot_ms']:.2f}), peak "
                f"{o['peak_gib'][0]:.2f} / {o['peak_gib'][1]:.2f} GiB (one "
                f"rank's phase so far {o['one_rank_peak_gib_phase']:.2f}), "
                f"of it the request's {o['request_gib'][0]:.3f} GiB above "
                f"what the rank held (one rank's "
                f"{o['one_rank_request_gib']:.3f}); "
                f"prefill logits max |err| "
                f"{o['prefill_logits_max_abs_err']:.4g} (rows "
                f"{[round(x, 4) for x in o['prefill_logits_row_max_abs_err']]}"
                f"), mean {o['prefill_logits_mean_abs_err']:.4g}, tokens equal "
                f"{o['tokens_equal']:.3f}, one rank's bit for bit: "
                f"{o['bit_for_bit']}, partings (token, one rank's "
                f"margin) {o['first_part_and_its_margin']}")
        else:
            log(f"tp=2 ({label}) {name}: {o['seconds'][0]:.2f} s (one rank "
                f"{o['one_rank_seconds']:.2f}), peak {o['peak_gib'][0]:.2f} "
                f"/ {o['peak_gib'][1]:.2f} GiB; tokens equal "
                f"{o['tokens_equal']:.3f}, partings "
                f"{o['first_part_and_its_margin']}; admissions and the "
                f"cushion block one rank's")
    return out


# the bars of phase 4k's kernel checks: prefill attention within one bf16
# ulp (+1e-6) of its plain version, as phase 2's; decode within one bf16
# ulp plus 1e-5 of the largest entry, the bar of tests/test_torch_cuda.py
# at G = 4, 6 and 8 (24-64 heads: a row holds entries that cancel to
# ~1e-4, where the split-KV chunks' f32 sums, merged in another order,
# leave a few 1e-6); the int matmul torch.equal
TP_DECODE_FLOOR = 1e-5


def tp_mode_rows(dev, timed, cfg):
    """Phase 4k's tensor-parallel modes at deepseek-67b's row-parallel
    shards at tp = 2 (``o``: K 4,096; ``down``: K 11,008; N 8,192;
    groups of 128), M = TP_B (decode: bf16 x, W4A8 quantizing it in its
    staging) and TP_B x TP_PROMPT (prefill: W4A8 on int8 codes, the
    per-token quantizer on bf16 x): ``w4a8_matmul``'s f32 accumulator mode
    and ``act_quant_ptoken``'s range-only and given-range modes
    ``torch.equal`` to their plain versions; the given range of a row's
    two halves (the ranks' shards) gives each half the whole row's codes,
    scale and zero (``torch.equal``); the two K halves' accumulators
    summed, with the epilogue once, within the reference's W4A8 bar (rtol
    1e-4, atol 1e-3: f32 sums in another order) of the whole weight's
    launch. Each timed beside its plain version and its bound (no PyTorch
    call computes either). Returns {kernel: the tp_* keys}."""
    import torch

    from repro_torch.kernels.act_quant import (
        act_quant_ptoken, act_quant_ptoken_plain, act_quant_ptoken_range,
        act_quant_ptoken_range_plain)
    from repro_torch.kernels.w4a8_matmul import (
        quant_w4a8_matmul, quant_w4a8_matmul_plain, w4a8_epilogue,
        w4a8_matmul, w4a8_matmul_plain)

    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(252)
    N, G_ = cfg.d_model, 128
    sx, zx = (torch.tensor(v_, device=dev) for v_ in (0.031, 111.0))
    acc_rows, pt_rows = [], []
    for site, Kw in (("o", cfg.n_heads * cfg.head_dim),
                     ("down", cfg.d_ff)):
        Kr = Kw // 2                         # a rank's rows of two
        wq = torch.randint(-7, 8, (Kw, N), generator=g, device=dev,
                           dtype=torch.int8)
        lo, hi = wq[0::2].view(torch.uint8) & 0xF, wq[1::2].view(
            torch.uint8) & 0xF
        wp = (lo | (hi << 4)).view(torch.int8)
        s_w = (torch.rand((Kw // G_, N), generator=g, device=dev) * 0.02
               + 1e-3).to(bf)
        colsum = (wq.to(torch.int32).reshape(Kw // G_, G_, N).sum(1).float()
                  * s_w.float()).sum(0)
        half = [(wp[r * Kr // 2:(r + 1) * Kr // 2].contiguous(),
                 s_w[r * Kr // G_:(r + 1) * Kr // G_].contiguous())
                for r in range(2)]
        for M in (TP_B, TP_B * TP_PROMPT):
            if M <= 16:
                x = (torch.randn((M, Kw), generator=g, device=dev) * 3) \
                    .to(bf)
                xr = x[:, :Kr].contiguous()
                run = lambda a, w_, s_: quant_w4a8_matmul(  # noqa: E731
                    a, w_, sx, zx, s_, None, G_, accumulate=True)
                plain = lambda a, w_, s_: quant_w4a8_matmul_plain(  # noqa
                    a, w_, sx, zx, s_, None, G_, accumulate=True)
                whole = quant_w4a8_matmul(x, wp, sx, zx, s_w, colsum, G_)
                xs = [x[:, r * Kr:(r + 1) * Kr].contiguous()
                      for r in range(2)]
                xb = 2 * M * Kr
            else:
                x = torch.randint(-128, 128, (M, Kw), generator=g,
                                  device=dev, dtype=torch.int8)
                xr = x[:, :Kr].contiguous()
                run = lambda a, w_, s_: w4a8_matmul(  # noqa: E731
                    a, w_, sx, zx, s_, None, G_, accumulate=True)
                plain = lambda a, w_, s_: w4a8_matmul_plain(  # noqa: E731
                    a, w_, sx, zx, s_, None, G_, accumulate=True)
                whole = w4a8_matmul(x, wp, sx, zx, s_w, colsum, G_, -128.0)
                xs = [x[:, r * Kr:(r + 1) * Kr].contiguous()
                      for r in range(2)]
                xb = M * Kr
            got = run(xr, *half[0])
            if not torch.equal(got, plain(xr, *half[0])):
                fail(f"w4a8_matmul accumulator mode ({site} shard, M={M}) "
                     f"differs from its plain version")
            split = w4a8_epilogue(run(xs[0], *half[0]) + run(xs[1], *half[1]),
                                  sx, zx, colsum, -128.0)
            err = float((split - whole).abs().max())
            if not bool(((split - whole).abs()
                         <= 1e-4 * whole.abs() + 1e-3).all()):
                fail(f"w4a8_matmul ({site}, M={M}): the two K halves' "
                     f"accumulators with the epilogue are {err} from the "
                     f"whole weight's launch, beyond the W4A8 bar")
            bms, by = bound_ms(xb + Kr * N // 2 + 2 * (Kr // G_) * N
                               + 4 * M * N, 2.0 * M * Kr * N,
                               INT8_OPS_PER_S)
            acc_rows.append(dict(
                site=site, K=Kr, N=N, M=M, halves_max_abs_err=err,
                ms=timed(lambda: run(xr, *half[0])),
                plain_ms=timed(lambda: plain(xr, *half[0]), 3),
                bound_ms=bms, bound_by=by))
            # the per-token quantizer on the rank's bf16 activation
            xa = (torch.randn((M, Kw), generator=g, device=dev) * 3
                  + 0.2).to(bf)
            parts = [xa[:, r * Kr:(r + 1) * Kr].contiguous()
                     for r in range(2)]
            rngs = [act_quant_ptoken_range(p_) for p_ in parts]
            for p_, r_ in zip(parts, rngs):
                if not all(torch.equal(a, b) for a, b in zip(
                        r_, act_quant_ptoken_range_plain(p_))):
                    fail(f"act_quant_ptoken range-only mode ({site}, M={M}) "
                         f"differs from its plain version")
            mn = torch.minimum(rngs[0][0], rngs[1][0])
            mx = torch.maximum(rngs[0][1], rngs[1][1])
            given = [act_quant_ptoken(p_, rng=(mn, mx)) for p_ in parts]
            for p_, got_ in zip(parts, given):
                if not all(torch.equal(a, b) for a, b in zip(
                        got_, act_quant_ptoken_plain(p_, rng=(mn, mx)))):
                    fail(f"act_quant_ptoken given-range mode ({site}, M={M}) "
                         f"differs from its plain version")
            want = act_quant_ptoken(xa)
            if not torch.equal(torch.cat([q_[0] for q_ in given], 1),
                               want[0]) or not all(
                    torch.equal(q_[1], want[1])
                    and torch.equal(q_[2], want[2]) for q_ in given):
                fail(f"act_quant_ptoken ({site}, M={M}): the halves' given "
                     f"range does not give the whole row's codes")
            p0 = parts[0]
            r_b, r_by = bound_ms(2 * M * Kr + 8 * M, 0, BF16_FLOPS_PER_S)
            g_b, g_by = bound_ms(2 * M * Kr + M * Kr + 16 * M, 0,
                                 BF16_FLOPS_PER_S)
            pt_rows.append(dict(
                site=site, D=Kr, M=M,
                range_ms=timed(lambda: act_quant_ptoken_range(p0)),
                range_plain_ms=timed(
                    lambda: act_quant_ptoken_range_plain(p0), 3),
                range_bound_ms=r_b,
                given_ms=timed(lambda: act_quant_ptoken(p0, rng=(mn, mx))),
                given_plain_ms=timed(
                    lambda: act_quant_ptoken_plain(p0, rng=(mn, mx)), 3),
                given_bound_ms=g_b, bound_by=g_by))
        del wq, wp, x, xa
    log("phase 4k's tensor-parallel modes at deepseek-67b's row-parallel "
        "shards (ms; plain; bound): w4a8_matmul accumulator " + ", ".join(
            f"{x['site']} K={x['K']} M={x['M']} {x['ms']:.4f} "
            f"({x['plain_ms']:.4f}; {x['bound_ms']:.4f}; halves + epilogue "
            f"{x['halves_max_abs_err']:.3g} from whole)" for x in acc_rows)
        + "; act_quant_ptoken range-only / given-range " + ", ".join(
            f"{x['site']} D={x['D']} M={x['M']} {x['range_ms']:.4f} / "
            f"{x['given_ms']:.4f} ({x['range_plain_ms']:.4f} / "
            f"{x['given_plain_ms']:.4f}; {x['range_bound_ms']:.4f} / "
            f"{x['given_bound_ms']:.4f})" for x in pt_rows))
    dec_a = [x for x in acc_rows if x["M"] == TP_B]
    pre_a = [x for x in acc_rows if x["M"] > TP_B]
    dec_p = [x for x in pt_rows if x["M"] == TP_B]
    pre_p = [x for x in pt_rows if x["M"] > TP_B]
    unit = ("the two row-parallel sites of one layer at a rank's shard of "
            "deepseek-67b at tp = 2 (o: K=4096, down: K=11008, N=8192)")
    return {
        "w4a8_matmul": {
            "acc_unit": unit + f", M={TP_B}, bf16 x quantized in the staging",
            "acc_ms": sum(x["ms"] for x in dec_a),
            "acc_plain_ms": sum(x["plain_ms"] for x in dec_a),
            "acc_bound_ms": sum(x["bound_ms"] for x in dec_a),
            "acc_prefill_ms": sum(x["ms"] for x in pre_a),
            "acc_prefill_plain_ms": sum(x["plain_ms"] for x in pre_a),
            "acc_prefill_bound_ms": sum(x["bound_ms"] for x in pre_a),
            "acc_library_ms": None,
            "acc_halves_max_abs_err": max(x["halves_max_abs_err"]
                                          for x in acc_rows)},
        "act_quant_ptoken": {
            "modes_unit": unit.replace("K=", "D=") + f", M={TP_B}, bf16",
            "range_ms": sum(x["range_ms"] for x in dec_p),
            "range_plain_ms": sum(x["range_plain_ms"] for x in dec_p),
            "range_bound_ms": sum(x["range_bound_ms"] for x in dec_p),
            "given_ms": sum(x["given_ms"] for x in dec_p),
            "given_plain_ms": sum(x["given_plain_ms"] for x in dec_p),
            "given_bound_ms": sum(x["given_bound_ms"] for x in dec_p),
            "given_prefill_ms": sum(x["given_ms"] for x in pre_p),
            "given_prefill_bound_ms": sum(x["given_bound_ms"]
                                          for x in pre_p),
            "range_prefill_ms": sum(x["range_ms"] for x in pre_p),
            "modes_library_ms": None}}


def tp_kernel_rows(dev, timed, cfg):
    """Phase 4k's kernels at the shapes its runs give them, each against
    its plain version on the same inputs (random, from a seed): deepseek-
    67b's G = 8 at head_dim 128 at one rank (64 query / 8 KV heads) and at
    each of two ranks (32 / 4), prefill (B = 4 x 512 behind the 4-row
    cushion), contiguous decode (int8 with (K,) scales and the cushion,
    and fp) and paged decode (int8 with (B, K) scales); w8a8_matmul at the
    column-parallel sites' shards and whole weights and the row-parallel
    sites' whole weights, decode (bf16 x quantized in the staging) and
    prefill (int8 codes), bf16 out. Returns {kernel: the tp_* keys of the
    kernels line}; fails on a disagreement."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_plain,
        flash_decode_plain)
    from repro_torch.kernels.w8a8_matmul import (
        quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_matmul,
        w8a8_matmul_plain)
    from repro_torch.serving.engine import cache_seq_len

    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(251)
    hd, m, B, S = cfg.head_dim, CUSHION, TP_B, TP_PROMPT
    Smax = cache_seq_len(TP_PROMPT + 2 * TP_NEW + 64)
    pos_v = m + S + TP_NEW // 2
    out = {}

    def err_within(name, got, want, floor_rel):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        floor = floor_rel * float(want.abs().max()) if floor_rel else 1e-6
        if not bool((err <= BF16_ULP * want.abs() + floor).all()):
            fail(f"phase 4k {name}: max |kernel - plain| "
                 f"{float(err.max())} beyond its bar")
        return float(err.max())

    def rnd(*shape, dtype=bf):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    rows = {"flash_attention": [], "flash_decode": [],
            "flash_decode_paged": []}
    for tp in (1, 2):
        H, K = cfg.n_heads // tp, cfg.n_kv_heads // tp
        # prefill
        q = rnd(B, S, H, hd).transpose(1, 2)
        k = rnd(B, S + m, K, hd).transpose(1, 2)
        v = rnd(B, S + m, K, hd).transpose(1, 2)
        e = err_within(f"flash_attention tp={tp}",
                       flash_attention(q, k, v, prefix_len=m),
                       flash_attention_plain(q, k, v, prefix_len=m), 0)
        pairs = B * H * (S * m + S * (S + 1) / 2)
        bms, by = bound_ms(2 * (2 * B * H * S * hd + 2 * B * K * (S + m)
                                * hd), 4.0 * hd * pairs, BF16_FLOPS_PER_S)
        rows["flash_attention"].append(dict(
            tp=tp, H=H, K=K, max_abs_err=e,
            ms=timed(lambda: flash_attention(q, k, v, prefix_len=m)),
            plain_ms=timed(lambda: flash_attention_plain(
                q, k, v, prefix_len=m), 3), bound_ms=bms, bound_by=by))
        del q, k, v
        # contiguous decode: int8 + (K,) scales + the cushion, and fp
        qd = rnd(B, H, hd)
        pos = torch.tensor(pos_v, dtype=torch.int32, device=dev)
        kq = rnd(B, Smax, K, hd, dtype=torch.int8)
        vq = rnd(B, Smax, K, hd, dtype=torch.int8)
        sc = lambda *s_: torch.rand(s_, generator=g,  # noqa: E731
                                    device=dev) * 0.05 + 0.01
        cu = dict(kc=rnd(m, K, hd), vc=rnd(m, K, hd))
        kf, vf = rnd(B, Smax, K, hd), rnd(B, Smax, K, hd)
        for mode, a, kw in (("int8", (qd, kq, vq, pos),
                             dict(cu, k_scale=sc(K), v_scale=sc(K))),
                            ("fp", (qd, kf, vf, pos), {})):
            e = err_within(f"flash_decode {mode} tp={tp}",
                           flash_decode(*a, **kw),
                           flash_decode_plain(*a, **kw), TP_DECODE_FLOOR)
            live = pos_v + 1 - (m if mode == "int8" else 0)
            cb = 1 if mode == "int8" else 2
            bms, by = bound_ms(4 * B * H * hd + 2 * B * live * K * hd * cb
                               + (4 * m * K * hd + 8 * K if mode == "int8"
                                  else 0),
                               4.0 * B * H * hd * (pos_v + 1),
                               BF16_FLOPS_PER_S)
            rows["flash_decode"].append(dict(
                tp=tp, H=H, K=K, mode=mode, max_abs_err=e,
                ms=timed(lambda: flash_decode(*a, **kw)),
                plain_ms=timed(lambda: flash_decode_plain(*a, **kw), 3),
                bound_ms=bms, bound_by=by))
        # paged decode over the pool's 4 slots: (B, K) scales, page 64, a
        # shuffled table, per-row pos (one row retired)
        P = Smax // TP_PAGE
        n_pages = TP_SLOTS * P + 1
        table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1) \
            .to(torch.int32).reshape(TP_SLOTS, P)
        kp = torch.full((n_pages, TP_PAGE, K, hd), 99, dtype=torch.int8,
                        device=dev)
        vp = kp.clone()
        kp[table.reshape(-1).long()] = kq[:TP_SLOTS].reshape(
            TP_SLOTS * P, TP_PAGE, K, hd)
        vp[table.reshape(-1).long()] = vq[:TP_SLOTS].reshape(
            TP_SLOTS * P, TP_PAGE, K, hd)
        prows = [m + 256 + 9, m + 320 + 2, 2 * TP_PAGE, -1]
        prow = torch.tensor(prows, dtype=torch.int32, device=dev)
        kw = dict(cu, k_scale=sc(TP_SLOTS, K), v_scale=sc(TP_SLOTS, K))
        a = (qd[:TP_SLOTS], kp, vp, table, prow)
        e = err_within(f"flash_decode_paged tp={tp}",
                       flash_decode_paged(*a, **kw),
                       flash_decode_paged_plain(*a, **kw), TP_DECODE_FLOOR)
        # the keys this run's rows read: pos + 1 each (none for the
        # retired row), the cushion's m from the block
        n_keys = sum(p_ + 1 for p_ in prows if p_ >= 0)
        n_int8 = n_keys - m * sum(p_ >= 0 for p_ in prows)
        bms, by = bound_ms(4 * TP_SLOTS * H * hd + 2 * n_int8 * K * hd
                           + 4 * m * K * hd + 8 * TP_SLOTS * K
                           + 4 * TP_SLOTS * P,
                           4.0 * H * hd * n_keys, BF16_FLOPS_PER_S)
        rows["flash_decode_paged"].append(dict(
            tp=tp, H=H, K=K, max_abs_err=e,
            ms=timed(lambda: flash_decode_paged(*a, **kw)),
            plain_ms=timed(lambda: flash_decode_paged_plain(*a, **kw), 3),
            bound_ms=bms, bound_by=by))
        del kq, vq, kf, vf, kp, vp

    # the int matmul: (K, N) of each site at one rank and at a rank of two
    # (the row-parallel sites' shards are held in the int32 mode above)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    sites = [("qkv", D, qkv, 1), ("qkv", D, qkv // 2, 2),
             ("up_gate", D, F, 1), ("up_gate", D, F // 2, 2),
             ("head", D, V, 1), ("head", D, V // 2, 2),
             ("o", cfg.n_heads * hd, D, 1), ("down", F, D, 1)]
    sx, zx = (torch.tensor(v_, device=dev) for v_ in (0.031, 111.0))
    sw = torch.tensor(0.0042, device=dev).to(bf)
    mm = []
    for site, Kd, N, tp in sites:
        w = rnd(Kd, N, dtype=torch.int8)
        colsum = w.sum(0, dtype=torch.int32)
        xd = (torch.randn((B, Kd), generator=g, device=dev) * 3).to(bf)
        xp = torch.randint(-128, 128, (B * S, Kd), generator=g, device=dev,
                           dtype=torch.int8)
        for M, f, fp in (
                (B, lambda: quant_w8a8_matmul(xd, w, sx, zx, sw, colsum,
                                              out_dtype=bf),
                 lambda: quant_w8a8_matmul_plain(xd, w, sx, zx, sw, colsum,
                                                 out_dtype=bf)),
                (B * S, lambda: w8a8_matmul(xp, w, sx, zx, sw, colsum,
                                            -128.0, bf),
                 lambda: w8a8_matmul_plain(xp, w, sx, zx, sw, colsum,
                                           -128.0, bf))):
            if not torch.equal(f(), fp()):
                fail(f"phase 4k w8a8_matmul {site} tp={tp} (K={Kd}, N={N}, "
                     f"M={M}): not torch.equal to its plain version")
            if tp == 2 and M == B:
                bms, by = bound_ms(2 * M * Kd + Kd * N + 4 * N + 2 * M * N,
                                   2.0 * M * Kd * N, INT8_OPS_PER_S)
                mm.append(dict(site=site, K=Kd, N=N, M=M,
                               ms=timed(f), plain_ms=timed(fp, 3),
                               bound_ms=bms, bound_by=by))
        del w, xp
    for name, r in rows.items():
        log(f"phase 4k {name} at G = 8, hd 128 against its plain version: "
            + ", ".join(f"tp={x['tp']} {x.get('mode', '')} H={x['H']} "
                        f"K={x['K']} max |err| {x['max_abs_err']:.3g}, "
                        f"{x['ms']:.4f} ms (plain {x['plain_ms']:.4f}, "
                        f"bound {x['bound_ms']:.4f})" for x in r))
    log(f"phase 4k w8a8_matmul: {len(sites)} sites x 2 M torch.equal to the "
        f"plain version; a rank's column shards at decode (ms): "
        + ", ".join(f"{x['site']} N={x['N']} {x['ms']:.4f} (plain "
                    f"{x['plain_ms']:.4f}, bound {x['bound_ms']:.4f})"
                    for x in mm))
    for name, r in rows.items():
        two = [x for x in r if x["tp"] == 2]
        out[name] = {
            "checked_unit": "deepseek-67b at G = 8, head_dim 128, at one "
                            "rank and at a rank of tp = 2 (random inputs "
                            "at the runs' shapes)",
            "checked_max_abs_err": max(x["max_abs_err"] for x in r),
            "rank_unit": "a rank of tp = 2: " + ", ".join(
                f"{x.get('mode', '')} H={x['H']} K={x['K']}".strip()
                for x in two),
            "rank_ms": sum(x["ms"] for x in two),
            "rank_plain_ms": sum(x["plain_ms"] for x in two),
            "rank_bound_ms": sum(x["bound_ms"] for x in two)}
    out["w8a8_matmul"] = {
        "checked_sites": [f"{s_} K={k_} N={n_} tp={t_}"
                          for s_, k_, n_, t_ in sites],
        "checked_max_abs_err": 0.0,
        "shard_unit": f"the column-parallel sites of one layer and the head "
                      f"at a rank of tp = 2, M={B}, bf16 x quantized in the "
                      f"staging (up_gate twice)",
        "shard_ms": sum(x["ms"] * (2 if x["site"] == "up_gate" else 1)
                        for x in mm),
        "shard_plain_ms": sum(x["plain_ms"] * (2 if x["site"] == "up_gate"
                                               else 1) for x in mm),
        "shard_bound_ms": sum(x["bound_ms"] * (2 if x["site"] == "up_gate"
                                               else 1) for x in mm)}
    return out


# phase 4n, the dry-run accounting against the card (launch/dryrun.py): the
# prefill (B x PROMPT tokens) and one decode step of phase 4's W8A8 engine
# (int8-resident weights, int8 KV cache, the CUSHION-token cushion, its
# pt_static scales), run on meta tensors, then the same two calls on the
# card through api.prefill / api.decode_step. The launches and the argument
# bytes are held equal; the predicted peak (arguments + the meta run's temp
# bytes) within DRYRUN_PEAK_TOL of the card's (arguments + the rise of
# max_memory_allocated over what the card held when the count was reset)
DRYRUN_PEAK_TOL = 0.10


def dryrun_phase(api, eng, batch, cushion):
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import dryrun as DRY
    tree = eng.params.tree()
    tokens = batch["tokens"][:, :PROMPT].to(torch.int32).contiguous()
    out, cache, step_in = {}, None, None
    for kind in ("prefill", "decode"):
        prog = DRY.serving_program(api.cfg, kind, B, PROMPT, qcfg=eng.qcfg,
                                   cushion_m=CUSHION, prequant=True,
                                   kv_dtype="int8", max_seq=eng.max_seq)
        pred = DRY.measure_program(prog)
        if kind == "prefill":
            cache = eng._init_cache(B)
            inputs = {"tokens": tokens}
            args = {"params": tree, "cache": cache, "inputs": inputs,
                    "scales": eng.scales, "cushion": cushion}
        else:
            inputs = step_in
            args = {"params": tree, "cache": cache, "inputs": inputs,
                    "scales": eng.scales}
        card_args = {k: DRY.tree_bytes(v) for k, v in args.items()}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _lib.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            if kind == "prefill":
                logits, cache, pos = api.prefill(
                    tree, inputs, cache, eng.qcfg, cushion=cushion,
                    scales=eng.scales)
            else:
                logits, cache = api.decode_step(
                    tree, inputs["token"], inputs["pos"], cache, eng.qcfg,
                    scales=eng.scales)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        rise = torch.cuda.max_memory_allocated() - held
        launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
        if kind == "prefill":
            step_in = {"token": torch.argmax(logits[:, -1], dim=-1)
                       .to(torch.int32), "pos": pos}
        del logits
        mem = pred["memory"]
        pred_peak = mem["argument_bytes"] + mem["temp_bytes"]
        card_peak = sum(card_args.values()) + rise
        miss = (pred_peak - card_peak) / card_peak
        c = pred["cost"]
        terms = DRY.roofline(c.flops, pred["int8_flops"], c.bytes,
                             c.collective_bytes)
        out[kind] = {
            "launches_dryrun": pred["launches"], "launches_card": launches,
            "argument_bytes_dryrun": pred["arguments"],
            "argument_bytes_card": card_args,
            "temp_bytes_dryrun": mem["temp_bytes"], "rise_bytes_card": rise,
            "held_bytes_card": held, "peak_bytes_dryrun": pred_peak,
            "peak_bytes_card": card_peak, "peak_miss": miss,
            "flops": c.flops, "int8_flops": pred["int8_flops"],
            "bytes": c.bytes, "terms_s": terms, "card_ms": card_ms,
            "dryrun_s": pred["seconds"]}
        log(f"phase 4n {kind} (B={B}, {PROMPT} tokens, m={CUSHION}, W8A8 "
            f"int8 weights and KV): dry-run launches {pred['launches']}, "
            f"card {launches}; arguments dry-run {pred['arguments']}, card "
            f"{card_args}; peak dry-run {pred_peak} B (arguments + temp "
            f"{mem['temp_bytes']}), card {card_peak} B (arguments + rise "
            f"{rise}; {held} B held at the reset): miss {miss:+.4f}; "
            f"{c.flops:.6g} FLOPs ({pred['int8_flops']:.6g} int8), "
            f"{c.bytes:.6g} B, roofline {max(terms.values()) * 1e3:.4f} ms "
            f"({max(terms, key=terms.get)}) against {card_ms:.3f} ms on the "
            f"card (one eager call); the meta run took "
            f"{pred['seconds']:.2f} s")
        if launches != pred["launches"]:
            fail(f"phase 4n {kind}: the dry-run's launches "
                 f"{pred['launches']} != the card's {launches}")
        if card_args != pred["arguments"]:
            fail(f"phase 4n {kind}: the dry-run's argument bytes "
                 f"{pred['arguments']} != the card's {card_args}")
        if abs(miss) > DRYRUN_PEAK_TOL:
            fail(f"phase 4n {kind}: predicted peak {pred_peak} B is "
                 f"{miss:+.2%} off the card's {card_peak} B (bar "
                 f"{DRYRUN_PEAK_TOL:.0%})")
    return out


# phase 4m, the router over tensor-parallel replicas: smollm-360m whole,
# 2 replicas of tp = 2 (four gloo ranks of the one card,
# launch/mesh.spawn_mesh(data=2, tp=2), each replica a data row), W8A8
# int8-resident with int8 paged pools of ROUTER_SLOTS slots, phase 4d's
# cushion, scales and the first RTP_REQ requests of its trace
RTP_REPLICAS, RTP_TP, RTP_REQ = 2, 2, 12
# replica 1 dies with requests live (it steps 94 times without a fault on
# the NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 5); late enough that
# replica 0 takes over only the requests replica 1 holds then
RTP_CRASH = "crash@replica1.step:48"


def router_tp_phase(dev, api, cushion, scales, ps):
    """Phase 4m: ``ReplicaRouter(meshes=make_replica_meshes(2, 2))`` on
    four ranks, with ``RTP_CRASH``: every rank's
    ``RouterStats`` the same; every request completed with phase 4d's
    tokens (its one-rank replicas'; W8A8 at tp = 2 is one rank's bit for
    bit); the fault run one death and its live requests failed over; the
    launches of each rank those of its replica's admissions and steps.
    Prints TTFT / TPOT p50, the wall split and each rank's peak GiB.
    Returns the record."""
    import numpy as np
    import torch
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core.calibration import scales_to_plain
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.launch.serve import poisson_trace
    tp_probe = import_tp_probe()

    cfg = get_config(ARCH)
    L = cfg.n_layers
    reqs = poisson_trace(api, 0, ROUTER_REQ, 0.0, (PROMPT, PROMPT + 8),
                         (NEW_TOKENS, NEW_TOKENS // 2))[:RTP_REQ]
    cpu = lambda t: t.detach().cpu()       # noqa: E731
    base = dict(cfg=cfg, seed=0, kind="router",
                qcfg=QuantConfig(mode="pt_static", true_int8=True),
                prequant=True, kv_dtype="int8", paged=True, page_size=ps,
                n_slots=ROUTER_SLOTS, n_replicas=RTP_REPLICAS,
                max_seq=PROMPT + 8 + NEW_TOKENS + 32,
                cushion=tree_map(cpu, cushion),
                scales=tree_map(cpu, scales_to_plain(scales)),
                requests=[dict(tokens=cpu(r.batch["tokens"]),
                               max_new_tokens=r.max_new_tokens)
                          for r in reqs])
    # the crash run alone: phase 4d holds the router without faults, and
    # this run's requests that never met the fault give its tokens too
    cases = [dict(base, name="crash", chaos=RTP_CRASH)]
    rec = {"arch": ARCH, "replicas": RTP_REPLICAS, "tp": RTP_TP,
           "slots": ROUTER_SLOTS, "requests": RTP_REQ, "runs": {},
           "launches": {}, "kernels": {},
           "note": "four gloo ranks time-slice one card: the mechanism, "
                   "not the speed of tensor parallelism"}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = spawn_mesh(tp_probe.run_router_cases, RTP_REPLICAS, RTP_TP, cases,
                     device="cuda", every_rank=True)
    rec["spawn_s"] = time.perf_counter() - t0
    sites = 5 * L
    zero = {k: 0 for k in _lib.LAUNCHES}
    for i, case in enumerate(cases):
        name = case["name"]
        ranks = [o[i] for o in out]
        r0 = ranks[0]
        st = r0["stats"]
        for rep in ranks:
            if rep["stats"] != st or [o[:3] for o in rep["outputs"]] != [
                    o[:3] for o in r0["outputs"]]:
                fail(f"router tp {name}: rank {rep['rank']}'s router saw "
                     f"another run than rank 0's")
            # this rank's launches: its replica's admissions (B = 1
            # prefills of > 16 rows) and decode steps
            per = st["per_replica"][rep["replica"]]
            n, s_ = per["admitted"], per["steps"]
            want = {**zero, "w8a8_matmul": (sites + 1) * (s_ + n),
                    "act_quant_static": sites * n,
                    "act_quant_static_fused": n + (sites + 1) * s_,
                    "flash_attention": L * n, "flash_decode_paged": L * s_}
            if rep["launches"] != want:
                fail(f"router tp {name}: rank {rep['rank']} launched "
                     f"{rep['launches']}, its replica's {n} admissions and "
                     f"{s_} steps make {want}")
            for k_, v_ in rep["launches"].items():
                rec["launches"][k_] = rec["launches"].get(k_, 0) + v_
        outs = {o[0]: o for o in r0["outputs"]}
        if sorted(outs) != list(range(RTP_REQ)) or st["completed"] != RTP_REQ \
                or st["rejected"]:
            fail(f"router tp {name}: {st['completed']} of {RTP_REQ} "
                 f"completed, rejections {st['rejections']}")
        for uid, o in outs.items():
            if not np.array_equal(o[3], ROUTER_TOKENS[uid]):
                fail(f"router tp {name}: request {uid}'s tokens are not "
                     f"phase 4d's")
        states = [p["state"] for p in st["per_replica"]]
        if name == "crash":
            if st["replica_deaths"] != 1 or states != ["HEALTHY", "DEAD"] \
                    or not st["failovers"] \
                    or st["retries"] < st["failovers"]:
                fail(f"router tp crash: {st['replica_deaths']} deaths, "
                     f"states {states}, {st['failovers']} failovers, "
                     f"{st['retries']} retries")
        elif st["replica_deaths"] or st["failovers"] or st["retries"]:
            fail(f"router tp no fault: {st}")
        ttft = list(r0["ttft_ms"].values())
        tpot = list(r0["tpot_ms"].values())
        split = []
        for rep in ranks:
            mine = [o[0] for o in r0["outputs"] if o[1] == rep["replica"]]
            pre = sum(r0["ttft_ms"][u] for u in mine) / 1e3
            split.append({"rank": rep["rank"], "replica": rep["replica"],
                          "wall_s": rep["seconds"], "step_s": rep["step_s"],
                          "steps": rep["steps"], "prefill_s": pre,
                          "other_s": rep["seconds"] - rep["step_s"] - pre,
                          "peak_gib": rep["peak_bytes"] / 2 ** 30})
        rec["runs"][name] = {
            "stats": {k: v for k, v in st.items() if k != "per_replica"},
            "states": states,
            "per_replica": [{k: p[k] for k in ("state", "steps", "admitted",
                                               "finished", "canceled",
                                               "stragglers")}
                            for p in st["per_replica"]],
            "ttft_ms_p50": float(np.median(ttft)),
            "tpot_ms_p50": float(np.median(tpot)),
            "ranks": split, "launches_rank0": r0["launches"]}
        log(f"router tp ({RTP_REPLICAS} replicas x tp={RTP_TP}, "
            f"{r0['backend']}) {name}: {st['completed']} completed, "
            f"{st['failovers']} failovers, {st['replica_deaths']} deaths, "
            f"states {states}; TTFT p50 {np.median(ttft):.1f} ms, TPOT p50 "
            f"{np.median(tpot):.2f} ms; tokens = phase 4d's; launches a "
            f"rank exact; by rank (wall: steps / prefills / other s, peak "
            f"GiB) " + ", ".join(
                f"{x['rank']}: {x['wall_s']:.2f}: {x['step_s']:.2f} / "
                f"{x['prefill_s']:.2f} / {x['other_s']:.2f}, "
                f"{x['peak_gib']:.2f}" for x in split))
    return rec


# phase 4l, data parallelism over a (data, tp) rank mesh: smollm-360m at
# full width and depth, two gloo ranks of the one card
# (launch/mesh.spawn_mesh); see the module docstring
DP_TUNE_B, DP_TUNE_S, DP_TUNE_STEPS = 4, 256, 20
DP_TRAIN_B, DP_TRAIN_S, DP_TRAIN_STEPS = 8, 256, 4
DP_SEARCH = ["--max-prefix-len", "2", "--candidates", "16", "--sample-len",
             "64"]
# The bars of (b), tune.py --dp 2 against --dp 1, derived on the CPU first
# (PERF.md §6): in f32 the two runs differ only in the order of CE's and
# L_q's f32 sums, 1.6e-7 relative (tests/test_torch_data_parallel.py); in
# bf16 (smollm's width, 4 layers, B = 4 x 128, 20 pt_dynamic steps) each
# rank's GEMMs take half the rows, which rounds bf16 activations apart:
# CE 5.5e-4 relative at most, range 4.2e-2, L_q 6.5e-2, the first step's
# gradient 0.041 in L2 with a cosine of 0.9995. CE, the smooth part, takes
# the method's 1e-3; range, L_q and the loss are sums of squared extremes
# under pt_dynamic, where a one-ulp difference at a tensor's extreme moves
# its range and every code of it: 0.1; the gradient phase 4c's GRAD_TOL.
# The gradient norm after the first step is not held: the range term
# reaches the cushion only through each site's arg-max element, which the
# roundings move (0.46 apart at one step in the CPU's bf16 run). The final
# cushion, in units of dp 1's mean move (|tuned - greedy|): Adam moves an
# element by about the learning rate a step, whatever the size of its
# gradient, so an element whose small gradient changes sign between two
# runs parts from the other run by about its move. The f32 tests' 0.25
# was the first bar; dp 2 read 0.32 (k) and 0.25 (v) on the NVIDIA H100
# 80GB HBM3 at 700 W, so the bar is 0.5, and the phase plants a fault
# beside it to show that the bar parts a wrong gradient from dp 2's
# roundings: tune.py --dp 1 --batch 2, rank 0's rows alone (rank 1's rows
# dropped), read 0.93 (k) and 0.75 (v) there (PERF.md §6). A gradient
# counted twice over barely moves Adam's update; the first step's
# gradient (GRAD_TOL) is the check that catches it.
DP_CE_TOL, DP_SQ_TOL, DP_MOVE_SHARE = 1e-3, 0.1, 0.5
# (c), shard_train_step at data = 2 against one rank's make_train_step on
# phase 4j's batches: each rank's GEMMs take half the rows, as phase 4j's
# microbatches = 2 do, so phase 4j's microbatch bars: the first step's loss
# within 1e-2 relative, the four steps' within 5e-2, and the first moments
# (f32) of the whole tree within GRAD_TOL (relative L2, cosine). The bf16
# parameters' updates are printed, not held: an update of ~1e-4 on a
# weight of ~1e-2 is about one bf16 ulp, so which side of a rounding it
# lands on turns on the last bits (0.0907 apart, cosine 0.9959, on the
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6)
DP_LOSS0_TOL, DP_LOSS_TOL = 1e-2, 5e-2


# phase 4l's tensor-parallel training, (e) and (f): each model on the same
# two processes as one (data 1, model 2) mesh, shard_train_step for 3 steps
# under none and pt_dynamic against rank 0's make_train_step on the whole
# tree and the same batches. (e) qwen1.5-0.5b at full width and depth (24
# layers, d_model 1024, 16 heads, QKV bias, a tied vocabulary of 151,936
# cut in two); (f) the families without experts beside the dense one:
# whisper-base whole (6 + 6 layers, 8 heads of 64 cut in two, d_ff cut,
# its odd vocabulary of 51,865 whole) over 1,500 frames, xlstm-350m whole
# (24 layers, its vocabulary and mLSTM values cut), internvl2-26b at full
# width and 2 of its 48 layers (48 query heads and 8 KV heads cut in two,
# d_ff 16,384 cut, its odd vocabulary of 92,553 whole: about 1.92 B
# parameters) over 1,024 patches. The ranks' row-parallel sums (wo,
# w_down) add in another order than one rank's GEMMs, in bf16, as phase
# 4l's data-parallel ranks' halves of the rows do: its bars, the first
# step's loss within 1e-2 relative; the gradient norm within 5e-2 (the
# clip reads it). internvl2's one-rank side (bf16 weights and gradients,
# f32 moments: about 23 GB, twice the moments while it updates) runs first
# on rank 0 and is freed before the rank's shards are made
# (``one_rank_first``); its ranks' steps write their new shards and
# moments into the old ones (``donate``, the reference's donated state:
# two ranks' functional updates, 35 GiB each by the dry-run's count, do
# not fit on the card together)
TPT_STEPS = 3
TPT_MODES = ("none", "pt_dynamic")
TPT_LOSS_TOL, TPT_GNORM_TOL = 1e-2, 5e-2
# (arch, the layers kept (None: all), B, S text positions, the phase's
# case)
TPT_RUNS = (("qwen1.5-0.5b", None, 4, 256, "e"),
            ("whisper-base", None, 4, 256, "f"),
            ("xlstm-350m", None, 4, 256, "f"),
            ("internvl2-26b", 2, 2, 256, "f"))
# (f)'s prefix_tune(mesh=) of xlstm-350m (its mLSTM state summed over tp,
# its sLSTM state not): 3 steps at B = 4 x 256 under none from a 4-token
# cushion, against rank 0's one-rank tuning
TPT_TUNE_ARCH, TPT_TUNE_B, TPT_TUNE_S = "xlstm-350m", 4, 256
TPT_TUNE_IDS = [11, 12, 13, 14]


def tpt_cfg(arch, layers):
    """A (e) / (f) model's config: the whole model's, ``layers`` of its
    layers where the depth is cut."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def attention_layers(cfg) -> int:
    """The attention layers a forward runs: the encoder-decoder's encoder,
    decoder and cross-attention, none in the xLSTM."""
    if cfg.family.value == "ssm":
        return 0
    if cfg.encdec is not None:
        return cfg.encdec.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def tpt_batches(cfg, B, S, n, seed):
    """``n`` batches of seeded random tokens (B, S), with a VLM's patches or
    an encoder-decoder's frames (normal x 0.02, f32, the stub frontends'
    output)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        extra = (("patches", cfg.vlm.num_patches) if cfg.vlm is not None
                 else ("frames", cfg.encdec.encoder_seq)
                 if cfg.encdec is not None else None)
        if extra is not None:
            b[extra[0]] = (rs.randn(B, extra[1], cfg.d_model)
                           * 0.02).astype(np.float32)
        out.append(b)
    return out


def tp_train_cases():
    """The rank program's cases of the tensor-parallel training (one a
    model and mode) and (f)'s xLSTM tuning."""
    from repro_torch.configs import CushionConfig, QuantConfig
    cases = []
    for i, (arch, layers, B, S, _) in enumerate(TPT_RUNS):
        cfg = tpt_cfg(arch, layers)
        batches = tpt_batches(cfg, B, S, TPT_STEPS, 31 + i)
        cases += [dict(kind="train", name=f"tp_train_{arch}_{mode}",
                       cfg=cfg, seed=0, batches=batches, batch_rows=B,
                       seq=S, steps=TPT_STEPS, lr=1e-3, warmup=10,
                       mesh_shape=(1, 2), one_rank=True, one_rank_tp=[0],
                       one_rank_first=cfg.vlm is not None,
                       donate=cfg.vlm is not None,
                       qcfg=QuantConfig(mode=mode))
                  for mode in TPT_MODES]
    cfg = tpt_cfg(TPT_TUNE_ARCH, None)
    cases.append(dict(
        kind="tune", name=f"tp_tune_{TPT_TUNE_ARCH}", cfg=cfg, seed=0,
        cushion_ids=TPT_TUNE_IDS, mesh_shape=(1, 2),
        batches=tpt_batches(cfg, TPT_TUNE_B, TPT_TUNE_S, TPT_STEPS, 41),
        qcfg=QuantConfig(), one_rank=True, one_rank_tp=[0],
        ccfg=CushionConfig(tune_steps=TPT_STEPS, tune_lr=1e-3, lam=0.05,
                           log_every=TPT_STEPS)))
    return cases


def tp_train_kernel_rows(dev, timed):
    """(f)'s attention kernels at a rank's shapes of its training step, in
    bf16, against their plain versions: ``flash_attention`` and, through
    autograd, ``flash_attention_bwd`` at whisper-base's 4 heads of 64 of
    tp = 2 (B = 4: the encoder and the cross-attention non-causal over
    1,500 frames, the decoder's self-attention causal at S = 256) and
    internvl2-26b's 24 query heads over 4 KV heads of head_dim 128 (B = 2,
    causal, S = 1,280), the forward within one bf16 ulp, the backward
    within one bf16 ulp plus 1e-5 of the largest entry; each timed beside
    its plain version, its bound and SDPA. Returns {kernel: {shape_key:
    value}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(47)
    shapes = (("whisper-base_encoder", 4, 4, 1, 1500, 1500, 64, False),
              ("whisper-base_cross", 4, 4, 1, 256, 1500, 64, False),
              ("whisper-base_self", 4, 4, 1, 256, 256, 64, True),
              ("internvl2-26b_self", 2, 4, 6, 1280, 1280, 128, True))
    out = {"flash_attention": {}, "flash_attention_bwd": {}}

    def sdpa_ms(fn):
        try:
            return timed(fn)
        except (RuntimeError, TypeError) as e:
            log(f"scaled_dot_product_attention not timed: {e}")
            return None
    for key, B, Kh, G, S, T, hd, causal in shapes:
        H = Kh * G
        q = torch.randn((B, H, S, hd), generator=g, device=dev).to(bf)
        k = torch.randn((B, Kh, T, hd), generator=g, device=dev).to(bf)
        v = torch.randn((B, Kh, T, hd), generator=g, device=dev).to(bf)
        do = torch.randn((B, H, S, hd), generator=g, device=dev).to(bf)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        e_o = (got.float() - want.float()).abs()
        if not bool((e_o <= BF16_ULP * want.float().abs() + 1e-6).all()):
            fail(f"phase 4l (f) flash_attention at {key}: max err "
                 f"{float(e_o.max())} beyond one bf16 ulp")
        o, lse = FA._launch(q, k, v, 0, 0, with_lse=True, causal=causal)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        FA.flash_attention(qg, kg, vg, causal=causal).backward(do)
        wants = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal)
        errs = []
        for name, a, b_ in zip(("dq", "dk", "dv"), (qg.grad, kg.grad,
                                                    vg.grad), wants):
            e = (a.float() - b_.float()).abs()
            lim = BF16_ULP * b_.float().abs() + 1e-5 * float(
                b_.float().abs().max())
            if not bool((e <= lim).all()):
                fail(f"phase 4l (f) flash_attention_bwd at {key}, {name}: "
                     f"max err {float(e.max())}")
            errs.append(float(e.max()))
        pairs = B * H * (S * (S + 1) / 2 if causal else S * T)
        io = 2 * (2 * B * H * S * hd + 2 * B * Kh * T * hd)
        f_b, f_by = bound_ms(io, 4.0 * hd * pairs, BF16_FLOPS_PER_S)
        b_b, b_by = bound_ms(2 * (4 * B * H * S * hd + 4 * B * Kh * T * hd)
                             + 4 * B * H * S, 10.0 * hd * pairs,
                             BF16_FLOPS_PER_S)
        qs, ks_, vs_ = (t.detach().contiguous().requires_grad_()
                        for t in (q, k, v))
        dos = do.contiguous()
        gqa = dict(enable_gqa=True) if G > 1 else {}
        fwd = {"ms": timed(lambda: FA.flash_attention(q, k, v,
                                                      causal=causal)),
               "plain_ms": timed(lambda: FA.flash_attention_plain(
                   q, k, v, causal=causal), 3),
               "bound_ms": f_b, "bound_by": f_by,
               "library_ms": sdpa_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks_, vs_, is_causal=causal, **gqa)),
               "max_abs_err": float(e_o.max())}
        bwd = {"ms": timed(lambda: FA.flash_attention_bwd(
                   q, k, v, o, lse, do, causal=causal)),
               "plain_ms": timed(lambda: FA.flash_attention_bwd_plain(
                   q, k, v, o, lse, do, causal=causal), 3),
               "bound_ms": b_b, "bound_by": b_by,
               "library_ms": sdpa_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks_, vs_, is_causal=causal, **gqa).backward(dos)),
               "library_of": "scaled_dot_product_attention forward + "
                             "backward",
               "max_abs_err": max(errs)}
        unit = (f"one call of a tp = 2 rank, B={B}, S={S}, T={T}, {H} "
                f"heads over {Kh}, hd={hd}, "
                f"{'causal' if causal else 'non-causal'}")
        for kname, row in (("flash_attention", fwd),
                           ("flash_attention_bwd", bwd)):
            out[kname].update({f"{key}_{k_}": v_ for k_, v_ in row.items()})
            out[kname][f"{key}_unit"] = unit
        log(f"(f) at {key} ({unit}): flash_attention {fwd['ms']:.4f} ms "
            f"(plain {fwd['plain_ms']:.4f}, bound {f_b:.4f}, SDPA "
            f"{fwd['library_ms']}), flash_attention_bwd {bwd['ms']:.4f} "
            f"(plain {bwd['plain_ms']:.4f}, bound {b_b:.4f}, SDPA forward + "
            f"backward {bwd['library_ms']})")
        del q, k, v, do, o, lse, qg, kg, vg, qs, ks_, vs_, dos, wants
    return out


def tp_train_checks(got, dev, timed):
    """Hold phase 4l's tensor-parallel training and tuning (``got``: {case
    name: [rank 0's report, rank 1's]}) to their bars and return the
    record: for each model, the ranks' metrics and whole leaves equal bit
    for bit, the first step's loss and gradient norm against rank 0's
    one-rank run, the attention kernels' launches a rank a step one
    rank's; ms a step, gloo all-reduces a step, peak GiB and resident
    parameter and moment bytes a rank, each beside one rank's; the
    xLSTM's tuning: ``ranks_equal`` 1 at every step, the first step's loss
    against one rank's; (f)'s kernels at the ranks' shapes
    (``tp_train_kernel_rows``)."""
    import numpy as np
    gib = 2.0 ** 30
    rec = {"mesh": "(data 1, model 2), two gloo ranks of the one card",
           "steps": TPT_STEPS, "launches": {}, "kernels": {}}
    for arch, layers, B, S, part in TPT_RUNS:
        cfg = tpt_cfg(arch, layers)
        n_attn = attention_layers(cfg)
        rec[arch] = {"case": part, "B": B, "S": S,
                     "layers": cfg.n_layers, "attention_layers": n_attn}
        for mode in TPT_MODES:
            r0, r1 = got[f"tp_train_{arch}_{mode}"]
            what = f"phase 4l ({part}) {arch} {mode}"
            if r0["metrics"] != r1["metrics"]:
                fail(f"{what}: the ranks' metrics differ")
            for path, a in r0["whole_digests"].items():
                if a != r1["whole_digests"][path]:
                    fail(f"{what}: whole leaf {path} differs between the "
                         f"ranks")
            one = r0["one"]
            m0, o0 = r0["metrics"][0], one["metrics"][0]
            rel = {k: abs(m0[k] / o0[k] - 1) for k in ("loss", "grad_norm")}
            if rel["loss"] > TPT_LOSS_TOL or \
                    rel["grad_norm"] > TPT_GNORM_TOL:
                fail(f"{what}: the first step against one rank's {rel} "
                     f"(bars loss {TPT_LOSS_TOL}, gradient norm "
                     f"{TPT_GNORM_TOL})")
            want = {k: v for k, v in one["launches"][0].items() if v}
            if want.get("flash_attention", 0) != 2 * n_attn or \
                    want.get("flash_attention_bwd", 0) != n_attn:
                fail(f"{what}: one rank launched {want} a step")
            for r in (r0, r1):
                if any({k: v for k, v in x.items() if v} != want
                       for x in r["launches"]):
                    fail(f"{what}: a rank launched {r['launches']}, one "
                         f"rank {want} a step")
            for k_, v_ in r0["launches"][0].items():
                rec["launches"][k_] = rec["launches"].get(k_, 0) \
                    + v_ * TPT_STEPS
            rec[arch][mode] = {
                "loss": [m["loss"] for m in r0["metrics"]],
                "one_rank_loss": [m["loss"] for m in one["metrics"]],
                "grad_norm": [m["grad_norm"] for m in r0["metrics"]],
                "one_rank_grad_norm": [m["grad_norm"]
                                       for m in one["metrics"]],
                "first_step_rel": rel, "launches_a_step": want,
                "ms_a_step": [r["ms"] for r in (r0, r1)],
                "one_rank_ms_a_step": one["ms"],
                "all_reduces_a_step": [r["collectives"] for r in (r0, r1)],
                "peak_gib": [r["peak_bytes"] / gib for r in (r0, r1)],
                "one_rank_peak_gib": one["peak_bytes"] / gib,
                "param_bytes": [r["shard_bytes"] for r in (r0, r1)],
                "moment_bytes": [r["moment_bytes"] for r in (r0, r1)],
                "one_rank_param_bytes": one["bytes"]["params"],
                "one_rank_moment_bytes": one["bytes"]["moments"],
                "whole_leaves": len(r0["whole_digests"])}
            x = rec[arch][mode]
            log(f"({part}) tensor-parallel training, {arch} at full width"
                f"{'' if layers is None else f', {layers} layers'}, {mode},"
                f" (data 1, model 2), B={B} x {S}, {TPT_STEPS} steps: "
                f"losses {[round(v, 5) for v in x['loss']]} vs one rank's "
                f"{[round(v, 5) for v in x['one_rank_loss']]}, the first "
                f"step apart {rel}; metrics and {x['whole_leaves']} whole "
                f"leaves equal on both ranks; launches a rank a step {want} "
                f"= one rank's; ms a step a rank "
                f"{[[round(v, 1) for v in ms] for ms in x['ms_a_step']]} vs "
                f"one rank's {[round(v, 1) for v in one['ms']]}; gloo "
                f"all-reduces a step {x['all_reduces_a_step'][0]} (one "
                f"rank: 0); peak GiB a rank "
                f"{[round(v, 2) for v in x['peak_gib']]} vs one rank's run "
                f"{x['one_rank_peak_gib']:.2f}; a rank holds "
                f"{x['param_bytes'][0] / gib:.3f} GiB of parameters and "
                f"{x['moment_bytes'][0] / gib:.3f} of moments, one rank "
                f"{x['one_rank_param_bytes'] / gib:.3f} and "
                f"{x['one_rank_moment_bytes'] / gib:.3f}")
        # the kernels line's tp_train_<arch>_* figures (under none)
        x = rec[arch]["none"]
        figures = {
            f"{arch}_ms_a_step": float(np.median(x["ms_a_step"][0][1:])),
            f"{arch}_one_rank_ms_a_step": float(np.median(
                x["one_rank_ms_a_step"][1:])),
            f"{arch}_all_reduces_a_step": x["all_reduces_a_step"][0][0],
            f"{arch}_peak_gib": x["peak_gib"],
            f"{arch}_one_rank_peak_gib": x["one_rank_peak_gib"],
            f"{arch}_param_bytes": x["param_bytes"][0],
            f"{arch}_one_rank_param_bytes": x["one_rank_param_bytes"],
            f"{arch}_moment_bytes": x["moment_bytes"][0],
            f"{arch}_one_rank_moment_bytes": x["one_rank_moment_bytes"]}
        for kname in ("flash_attention", "flash_attention_bwd"):
            n = x["launches_a_step"].get(kname, 0)
            if n:
                rec["kernels"].setdefault(kname, {}).update(
                    figures, **{f"{arch}_launches_a_step": n})

    # (f) the xLSTM's prefix_tune(mesh=)
    t0_, t1_ = got[f"tp_tune_{TPT_TUNE_ARCH}"]
    one = t0_["one"]
    if t0_["fingerprint"] != t1_["fingerprint"]:
        fail("phase 4l (f) tuning: the ranks' tuned cushions differ")
    eq = [x["ranks_equal"] for x in t0_["log"]]
    if eq != [1.0] * TPT_STEPS:
        fail(f"phase 4l (f) tuning: ranks_equal {eq}")
    rel = abs(t0_["log"][0]["loss"] / one["log"][0]["loss"] - 1)
    if rel > TPT_LOSS_TOL:
        fail(f"phase 4l (f) tuning: the first step's loss {rel:.3g} "
             f"relative from one rank's (bar {TPT_LOSS_TOL})")
    rec["tune"] = {"arch": TPT_TUNE_ARCH, "B": TPT_TUNE_B, "S": TPT_TUNE_S,
                   "ranks_equal": eq,
                   "loss": [x["loss"] for x in t0_["log"]],
                   "one_rank_loss": [x["loss"] for x in one["log"]],
                   "first_step_rel": rel,
                   "ms_a_step": [t0_["ms"], t1_["ms"]],
                   "one_rank_ms_a_step": one["ms"]}
    log(f"(f) prefix_tune(mesh=) of {TPT_TUNE_ARCH} on (data 1, model 2), "
        f"B={TPT_TUNE_B} x {TPT_TUNE_S}, {TPT_STEPS} steps under none: "
        f"ranks_equal {eq}; losses "
        f"{[round(v, 5) for v in rec['tune']['loss']]} vs one rank's "
        f"{[round(v, 5) for v in rec['tune']['one_rank_loss']]} (first "
        f"step {rel:.2e} apart); ms a step a rank "
        f"{[round(v, 1) for v in rec['tune']['ms_a_step']]} vs one rank's "
        f"{one['ms']:.1f}")
    # (f)'s kernels at the ranks' shapes
    for kname, row in tp_train_kernel_rows(dev, timed).items():
        rec["kernels"].setdefault(kname, {}).update(row)
    return rec


def dp_phase(dev, corpus, timed):
    """Phase 4l: data-parallel tuning and training of smollm-360m over two
    gloo ranks of the card, and the user's path train -> tune --dp 2 ->
    serve --ckpt-dir (see the module docstring). Returns the record."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TL
    from repro_torch.launch import tune as TU
    from repro_torch.launch.mesh import spawn_mesh
    if str(ROOT / "tests") not in sys.path:
        sys.path.append(str(ROOT / "tests"))
    import _dp_probe as dp_probe

    cfg = get_config(ARCH)
    L = cfg.n_layers
    work = ROOT / "build" / "chip_smoke_dp"
    shutil.rmtree(work, ignore_errors=True)
    rec = {"arch": ARCH, "ranks": 2, "backend": "gloo",
           "note": "two ranks time-slice one card through the host: not "
                   "data parallelism's speed"}
    zero = {k: 0 for k in _lib.LAUNCHES}
    gib = 2.0 ** 30

    # (d) the user's path: launch/train.py 2 steps -> tune.py --dp 2
    # --ckpt-dir -> serve.py --ckpt-dir --cushion, timed stage by stage;
    # (b) is its tuning, held against --dp 1 on the same checkpoint
    pipe = Pipeline(corpus, batch=DP_TRAIN_B, seq_len=DP_TRAIN_S, seed=0)
    ckpt = str(work / "ckpt")
    path_s = {}
    t0 = time.perf_counter()
    TL.main(["--arch", ARCH, "--device", "cuda", "--steps", "2",
             "--eval-batches", "1", "--ckpt-dir", ckpt], pipe=pipe)
    torch.cuda.synchronize()
    path_s["train"] = time.perf_counter() - t0
    store = CheckpointManager(ckpt)
    if store.latest_step() != 2:
        fail(f"phase 4l: the trainer saved steps {store.steps()}, not 2")
    sha = store.manifest(2)["sha256"]["arrays.npz"]
    tune_argv = ["--arch", ARCH, "--device", "cuda", "--ckpt-dir", ckpt,
                 "--seq-len", str(DP_TUNE_S), "--steps", str(DP_TUNE_STEPS),
                 "--quant", "pt_dynamic", "--log-every", "10",
                 "--eval-batches", "1", *DP_SEARCH]
    # dp 2 (the path's, its artifact served below), dp 1 on the same
    # batches, and the planted fault: dp 1 on rank 0's rows alone (a
    # launcher batch's rows are drawn by their index, so --batch 2 takes
    # the first two rows of each --batch 4 batch: rank 1's rows dropped)
    reps = {}
    for name, dp, rows, extra in (
            ("dp2", 2, DP_TUNE_B, ["--with-scales", "--calib-batches", "1"]),
            ("dp1", 1, DP_TUNE_B, []), ("drop", 1, DP_TUNE_B // 2, [])):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        TU.main(tune_argv + extra + [
            "--dp", str(dp), "--batch", str(rows),
            "--out-dir", str(work / name),
            "--report-json", str(work / f"{name}.json")], corpus=corpus)
        torch.cuda.synchronize()
        reps[name] = json.loads((work / f"{name}.json").read_text())
        reps[name]["wall_s"] = time.perf_counter() - t0
    path_s["tune_dp2"] = reps["dp2"]["wall_s"]
    t0 = time.perf_counter()
    res = SV.main(["--arch", ARCH, "--device", "cuda", "--ckpt-dir", ckpt,
                   "--cushion", str(work / "dp2"), "--quant", "pt_static",
                   "--prequant", "--kv-dtype", "int8", "--batch", "4",
                   "--prompt-len", "64", "--tokens", "16"],
                  corpus=corpus)
    torch.cuda.synchronize()
    path_s["serve"] = time.perf_counter() - t0
    toks = np.asarray(res.tokens)
    if toks.shape != (4, 16) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"phase 4l: served tokens {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    if store.manifest(2)["sha256"]["arrays.npz"] != sha:
        fail("phase 4l: the checkpoint changed under the path")
    rec["path"] = {"seconds": path_s, "total_s": sum(path_s.values()),
                   "checkpoint_sha256": sha, "tokens": toks[0].tolist()}
    log(f"path (d): launch/train.py 2 steps {path_s['train']:.1f} s -> "
        f"tune.py --dp 2 --ckpt-dir {path_s['tune_dp2']:.1f} s -> serve.py "
        f"--ckpt-dir --cushion {path_s['serve']:.1f} s (the checkpoint's "
        f"sha256 {sha[:12]} verified at each restore); tokens "
        f"{toks[0][:8].tolist()}")

    # (b) tune.py --dp 2 against --dp 1
    two, one = reps["dp2"], reps["dp1"]
    if two["prefix_ids"] != one["prefix_ids"]:
        fail(f"phase 4l: prefix ids {two['prefix_ids']} (dp 2) != "
             f"{one['prefix_ids']} (dp 1)")
    if len(two["ranks"]) != 2 or len({r["fingerprint"]
                                      for r in two["ranks"]}) != 1:
        fail(f"phase 4l: the ranks' tuned cushions differ")
    if not all(x["ranks_equal"] == 1.0 for x in two["tune_log"]) or len(
            two["tune_log"]) != DP_TUNE_STEPS:
        fail("phase 4l: a step left the ranks' cushions unequal")
    want = dict(zero, flash_attention=DP_TUNE_STEPS * L,
                flash_attention_bwd=DP_TUNE_STEPS * L)
    for r in two["ranks"] + one["ranks"] + reps["drop"]["ranks"]:
        if r["tune_launches"] != want:
            fail(f"phase 4l: a rank's tuning launched {r['tune_launches']},"
                 f" expected {want} ({L} / {L} a step)")
    rel = {k: [abs(a[k] / b[k] - 1) for a, b in zip(two["tune_log"],
                                                   one["tune_log"])]
           for k in ("loss", "ce", "range", "qerr", "gnorm")}
    if max(rel["ce"]) > DP_CE_TOL or max(max(rel[k]) for k in
                                         ("loss", "range", "qerr")) \
            > DP_SQ_TOL:
        fail(f"phase 4l: dp 2 vs dp 1 logs apart by "
             f"{ {k: max(v) for k, v in rel.items()} }")
    arts = {n: CheckpointManager(str(work / n)).restore_tree(1)[0]["cushion"]
            for n in ("dp2", "dp1", "drop")}
    tune_ms = {n: [1e3 * r["tune_s"] / DP_TUNE_STEPS for r in reps[n]["ranks"]]
               for n in reps}
    rec["tune"] = {"argv": tune_argv, "prefix_ids": two["prefix_ids"],
                   "log_rel_max": {k: max(v) for k, v in rel.items()},
                   "ms_a_step": tune_ms,
                   "peak_gib": {n: [(r["peak_bytes"] or 0) / gib for r in
                                    reps[n]["ranks"]] for n in reps},
                   "launches_a_rank": two["ranks"][0]["tune_launches"],
                   "losses": {n: [x["loss"] for x in reps[n]["tune_log"]]
                              for n in reps}}

    # (a), (c) and the first tuning step's gradient: one spawn of the rank
    # program; the one-rank references run in rank 0
    V = cfg.vocab_size
    tpipe = Pipeline(corpus, batch=DP_TUNE_B, seq_len=DP_TUNE_S, seed=2)
    rs = np.random.RandomState(26)
    big = (rs.randn(2, 960 * 2560) * 0.02).astype(np.float32)
    cases = [
        dict(kind="compressed", name="compressed", x=big),
        dict(kind="dp_step", name="dp_step",
             params=rs.randn(8, 4).astype(np.float32),
             batch=rs.randn(4, 8).astype(np.float32)),
        dict(kind="grad", name="grad", cfg=cfg, seed=0,
             cushion_ids=two["prefix_ids"] or [0],
             batch=tpipe.get_batch(3000), qcfg=QuantConfig(mode="pt_dynamic"),
             lam=0.05, one_rank=True),
        dict(kind="train", name="train", cfg=cfg, seed=0,
             batches=[pipe.get_batch(i) for i in range(DP_TRAIN_STEPS)],
             batch_rows=DP_TRAIN_B, seq=DP_TRAIN_S, steps=DP_TRAIN_STEPS,
             lr=1e-3, warmup=max(10, 300 // 20), one_rank=True,
             profile=True)] + tp_train_cases()
    t0 = time.perf_counter()
    ranks = spawn_mesh(dp_probe.run_cases, 2, 1, cases, device="cuda",
                       every_rank=True, backend="gloo")
    rec["probe_s"] = time.perf_counter() - t0
    got = {c["name"]: [r[i] for r in ranks] for i, c in enumerate(cases)}
    # where the spawn's time went: each case's seconds on each rank
    rec["probe_case_s"] = {n: [r["seconds"] for r in v]
                           for n, v in got.items()}

    # (a) compressed_psum and dp_train_step_compressed
    c0, c1 = got["compressed"]
    exact = big.mean(axis=0)
    err = float(np.abs(c0["out"] - exact).max())
    if not (np.array_equal(c0["out"], c1["out"])
            and np.array_equal(c0["acc"], c1["acc"])):
        fail("phase 4l: compressed_psum differs between the ranks")
    if err > np.abs(big).max() / 127 + 1e-6:
        fail(f"phase 4l: compressed_psum off the exact mean by {err}")
    s0, s1 = got["dp_step"]
    if s0["loss"] != s1["loss"] or not np.array_equal(s0["grads"],
                                                      s1["grads"]):
        fail("phase 4l: dp_train_step_compressed differs between the ranks")
    rec["compressed"] = {"n": int(big.shape[1]), "max_abs_err": err,
                         "bound": float(np.abs(big).max() / 127 + 1e-6)}

    # the first tuning step's gradient, dp 2 against one rank
    g0, g1 = got["grad"]
    gl = {}
    for k in ("k", "v"):
        a, b = g0["grads"]["kv"][k], g1["grads"]["kv"][k]
        if not np.array_equal(a, b):
            fail(f"phase 4l: the ranks' summed gradients d{k} differ")
        w = g1["one"]["grads"]["kv"][k]
        gl[k] = (float(np.linalg.norm(a - w) / np.linalg.norm(w)),
                 float((a * w).sum() / np.linalg.norm(a) / np.linalg.norm(w)))
        if gl[k][0] > GRAD_TOL[0] or gl[k][1] < GRAD_TOL[1]:
            fail(f"phase 4l: first tuning gradient d{k}, dp 2 vs one rank: "
                 f"relative L2 {gl[k][0]:.4g}, cosine {gl[k][1]:.6f} "
                 f"(tolerance {GRAD_TOL})")
    if g0["launches"] != dict(zero, flash_attention=L,
                              flash_attention_bwd=L):
        fail(f"phase 4l: a gradient step launched {g0['launches']}")
    # each tuned cushion's mean |. - dp1| in units of dp 1's mean move:
    # dp 2 below the bar, the planted fault (rank 1's rows dropped) above
    move, share = {}, {}
    for k in ("k", "v"):
        b = arts["dp1"]["kv"][k].float().numpy()
        mv = one["ranks"][0]["cushion_move"][k]
        share[k] = {n: float(np.abs(arts[n]["kv"][k].float().numpy()
                                    - b).mean()) / mv
                    for n in ("dp2", "drop")}
        move[k] = (share[k]["dp2"] * mv, mv)
        if not share[k]["dp2"] < DP_MOVE_SHARE < share[k]["drop"]:
            fail(f"phase 4l: tuned {k}, mean |. - dp1| over dp 1's mean "
                 f"move {mv:.3g}: dp 2 {share[k]['dp2']:.3g}, rank 1's rows "
                 f"dropped {share[k]['drop']:.3g} (the bar {DP_MOVE_SHARE} "
                 f"must part them)")
    # the gradient step is not profiled (a trace of 11 s); (c)'s training
    # step is, on rank 0
    rec["tune"].update(first_gradient=gl, cushion_mean_diff_and_move=move,
                       cushion_diff_share=share, busy_share="not measured")
    log(f"(b) tune.py --dp 2 vs --dp 1 (B={DP_TUNE_B} x {DP_TUNE_S}, "
        f"{DP_TUNE_STEPS} steps, pt_dynamic): prefix {two['prefix_ids']} "
        f"equal; ranks equal after every step; launches a rank "
        f"{L} / {L} a step; logs apart at most "
        f"{ {k: round(max(v), 5) for k, v in rel.items()} } (tolerance CE "
        f"{DP_CE_TOL}, loss / range / L_q {DP_SQ_TOL}); first gradient "
        f"rel L2 / cosine {gl}; tuned cushion mean |. - dp1| / dp 1's mean "
        f"move {share} (bar {DP_MOVE_SHARE}); "
        f"ms a step {tune_ms}; peak GiB a "
        f"rank {rec['tune']['peak_gib']}")

    # (c) shard_train_step at data = 2 against one rank's make_train_step
    t0_, t1_ = got["train"]
    if t0_["metrics"] != t1_["metrics"]:
        fail("phase 4l: the ranks' training metrics differ")
    want = dict(zero, flash_attention=2 * L, flash_attention_bwd=L)
    for r in (t0_, t1_):
        if any(x != want for x in r["launches"]):
            fail(f"phase 4l: a training step launched {r['launches']}, "
                 f"expected {want} a step (remat)")
        for path, lf in r["leaves"].items():
            share = 2 if "data" in lf["spec"] else 1
            if lf["shard"] * share != lf["full"] or \
                    lf["moments"] != 2 * lf["shard"] or \
                    lf["moment_dtype"] != "torch.float32":
                fail(f"phase 4l: {path} holds {lf}")
    n_sharded = sum("data" in lf["spec"] for lf in t0_["leaves"].values())
    one_ = t1_["one"]
    l2 = [abs(a["loss"] / b["loss"] - 1) for a, b in zip(t0_["metrics"],
                                                        one_["metrics"])]
    if l2[0] > DP_LOSS0_TOL or max(l2) > DP_LOSS_TOL:
        fail(f"phase 4l: shard_train_step losses apart {l2}")
    mom = one_["moments"]
    if mom["rel_l2"] > GRAD_TOL[0] or mom["cosine"] < GRAD_TOL[1]:
        fail(f"phase 4l: the first moments apart: relative L2 "
             f"{mom['rel_l2']:.4g}, cosine {mom['cosine']:.6f}")
    tprof = t0_["profile"]
    tbusy = (tprof["device_ms"] / tprof["ms"]
             if not isinstance(tprof["device_ms"], str) else "not measured")
    rec["train"] = {
        "losses": [m["loss"] for m in t0_["metrics"]],
        "one_rank_losses": [m["loss"] for m in one_["metrics"]],
        "loss_rel": l2, "moments": mom, "update": one_["update"],
        "ms_a_step": [r["ms"] for r in (t0_, t1_)],
        "peak_gib": [r["peak_bytes"] / gib for r in (t0_, t1_)],
        "leaves_sharded": [n_sharded, len(t0_["leaves"])],
        "param_bytes": {"whole": t0_["full_bytes"],
                        "rank": t0_["shard_bytes"],
                        "moments_rank": t0_["moment_bytes"]},
        "profile": tprof, "busy_share": tbusy,
        "launches_a_step": t0_["launches"][0]}
    log(f"(c) shard_train_step at data = 2 (B={DP_TRAIN_B} x {DP_TRAIN_S}, "
        f"{DP_TRAIN_STEPS} steps, FSDP, remat) vs one rank's make_train_step:"
        f" losses {[round(x, 4) for x in rec['train']['losses']]} vs "
        f"{[round(x, 4) for x in rec['train']['one_rank_losses']]} (rel "
        f"{max(l2):.2e}); first moments rel L2 {mom['rel_l2']:.4g}, cosine "
        f"{mom['cosine']:.6f} (the bf16 parameters' updates "
        f"{one_['update']['rel_l2']:.4g}, {one_['update']['cosine']:.6f}: "
        f"printed, not gated); a rank holds "
        f"{t0_['shard_bytes'] / gib:.3f} of {t0_['full_bytes'] / gib:.3f} "
        f"GiB of parameters ({n_sharded} of {len(t0_['leaves'])} leaves "
        f"sharded) and {t0_['moment_bytes'] / gib:.3f} GiB of "
        f"moments; launches a step {L * 2} / {L}; ms a step "
        f"{[round(x, 1) for x in t0_['ms']]}; peak GiB a rank "
        f"{rec['train']['peak_gib']}; one step profiled on rank 0: wall "
        f"{tprof['ms']:.1f} ms, device {tprof['device_ms']} ms (busy "
        f"{tbusy})")
    # (e) tensor-parallel training on the same two processes
    rec["tp_train"] = tp_train_checks(got, dev, timed)
    log(f"(a) compressed_psum over 2 ranks of {big.shape[1]} values: every "
        f"rank equal, max |err| {err:.3g} against the exact mean (bound "
        f"{rec['compressed']['bound']:.3g}); dp_train_step_compressed equal "
        f"on both ranks")
    cases_s = {n: [round(x, 1) for x in v]
               for n, v in rec["probe_case_s"].items()}
    log(f"where the phase's time went (s): the path {path_s}, tune.py "
        f"{ {n: round(r['wall_s'], 1) for n, r in reps.items()} }, the rank "
        f"program's spawn {rec['probe_s']:.1f} (each case's on each rank "
        f"{cases_s})")
    # the kernels' launches on the phase's main path: one rank's tuning
    rec["launches"] = two["ranks"][0]["tune_launches"]
    rec["kernels"] = {}
    shutil.rmtree(work, ignore_errors=True)
    return rec


def tree_map(fn, t):
    """fn on every tensor of a tree of dicts, lists and SiteScale leaves."""
    from repro_torch.core.quantization import SiteScale
    if isinstance(t, dict):
        return {k: tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [tree_map(fn, v) for v in t]
    if isinstance(t, SiteScale):
        return SiteScale(fn(t.scale), fn(t.zero))
    return fn(t)


def main() -> None:
    global CPU_HALVES
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the card")
    import numpy as np
    try:
        from repro_torch.kernels import _lib
    except ImportError as e:
        fail(f"the port is missing ({e}); run from the root of a checkout")
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core import quantization as TQ
    from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
    from repro_torch.kernels.act_quant import (
        act_quant_ptoken, act_quant_ptoken_plain, act_quant_static,
        act_quant_static_plain)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import w8a8_matmul as W8
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_plain,
        flash_decode_plain, gather_pages)
    from repro_torch.kernels.w4a8_matmul import (
        quant_w4a8_matmul, quant_w4a8_matmul_plain, w4a8_matmul,
        w4a8_matmul_plain)
    from repro_torch.kernels.w8a8_matmul import (
        quant_w8a8_matmul, quant_w8a8_matmul_plain, w8a8_matmul,
        w8a8_matmul_plain)
    from repro_torch.launch.serve import (poisson_trace, seeded_cushion,
                                          to_device)
    from repro_torch.models.common import ParamTree
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Engine, cache_seq_len
    from repro_torch.serving.scheduler import ContinuousEngine
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"phases": {}, "phase_seconds": {}}
    t_start = time.perf_counter()
    t_mark = [t_start]

    def phase_done(name):
        # a phase's engines and their decode states refer to each other:
        # only the cyclic collector frees them (and the weights they hold);
        # the memory before and after it is printed
        held = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        now = time.perf_counter()
        record["phases"][name] = "ok"
        record["phase_seconds"][name] = now - t_mark[0]
        record.setdefault("allocated_gib_after", {})[name] = \
            torch.cuda.memory_allocated() / 2 ** 30
        # the host's run queue over the last minute: the host-bound phases
        # move with it
        load = os.getloadavg()[0]
        record.setdefault("host_load_after", {})[name] = load
        log(f"phase {name}: ok in {now - t_mark[0]:.1f} s (this process "
            f"holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of "
            f"the card, {held / 2 ** 30:.2f} before the cyclic collector "
            f"ran; {torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved; "
            f"host load {load:.1f} on {os.cpu_count()} cores)")
        t_mark[0] = now

    # 1. the card -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    record["card"] = card
    # smollm's synthetic corpus takes a minute and more of one host core:
    # a process of its own builds it (the same SyntheticCorpus(V, seed=0),
    # returned by pickle) while the kernels build and phase 3 runs
    import concurrent.futures
    import multiprocessing
    corpus_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    # the CPU halves' worker, idle until phase 4 queues the first
    CPU_HALVES = CpuHalves()
    corpus_job = corpus_pool.submit(SyntheticCorpus,
                                    get_config(ARCH).vocab_size, 0)

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _lib.lib()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s (per source, cumulative: "
        f"{ {k: round(v, 1) for k, v in _lib.BUILD_LOG.items()} })")
    record["build_s"] = build_s
    record["build_log"] = dict(_lib.BUILD_LOG)
    phase_done("build")

    # 3. kernels against their plain versions ---------------------------
    cfg = get_config(ARCH)
    D, H, K, hd, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    V = cfg.vocab_size
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)
    gen = torch.Generator(dev).manual_seed(0)

    def timed(fn, iters=10):
        return device_ms(fn, flush_buf, iters)

    def profiled_steps(step, steps):
        """``step`` run ``steps`` times under the profiler: its wall ms per
        step (the host's clock around the window, ending in a sync) and
        the kernel time per step, by name ("not measured" where the trace
        has no device events)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        busy = trace_device_ms(prof, steps)[0]
        if busy == 0:
            return {"profiled_wall_ms_per_step": wall, "device_ms_per_step":
                    "not measured (no device events in the trace)"}
        return {"profiled_wall_ms_per_step": wall,
                "device_ms_per_step": busy,
                "by_kernel": by_kernel(prof, steps)}

    @torch.inference_mode()
    def decode_busy(eng, batch, steps=8):
        """The decode step after a prefill of ``batch``: the captured
        graph's replays, then the same step run eagerly, each profiled
        over ``steps`` steps."""
        st, _ = eng._run_prefill(batch)
        st.step()
        graph = profiled_steps(st.step, steps)
        tok, pos = st.tok.clone(), st.pos.clone()

        def eager():
            logits, _ = eng._decode(tok, pos, st.cache)
            tok.copy_(torch.argmax(logits, dim=-1))
            pos.add_(1)

        eager()
        graph["eager"] = profiled_steps(eager, steps)
        return graph

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    detail = []
    bf = torch.bfloat16
    # the floor of the method: launch and events around a one-element fill
    one = torch.zeros(1, device=dev)
    floor_ms = timed(lambda: one.zero_(), iters=20)
    record["floor_ms"] = floor_ms
    log(f"timing floor (a one-element fill): {floor_ms * 1e3:.2f} us a call")
    # a site's static activation scale and zero (codes clip at both ends
    # of the range for the randn * 3 activations below)
    a_sx, a_zx = scalar(0.031), scalar(111.0)

    def fused_row(kernel, name, Kd, N, fused, unfused, plain, extra_bytes):
        """The int matmul at M = B on the f32 / bf16 activation, which it
        quantizes while staging A: torch.equal to the plain composition for
        bf16 and f32 x and s_w (``fused(x, sw)``), timed on bf16 x and s_w
        (the main path) beside act_quant_static + the matmul on the codes
        (``unfused``) and the plain composition."""
        x32 = torch.randn((B, Kd), generator=gen, device=dev) * 3
        for x_ in (x32.to(bf), x32):
            for sw_bf in (True, False):
                got = fused(x_, sw_bf)
                want = plain(x_, sw_bf)
                ref2 = unfused(x_, sw_bf)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(got, ref2)):
                    fail(f"{kernel} fused {name} x {x_.dtype} s_w "
                         f"{'bf16' if sw_bf else 'f32'}: not bit-exact to "
                         f"act_quant_static + the matmul")
        xb = x32.to(bf)
        ms = timed(lambda: fused(xb, True))
        ums = timed(lambda: unfused(xb, True))
        pms = timed(lambda: plain(xb, True), iters=3)
        bms, by = bound_ms(2 * B * Kd + extra_bytes + 2 * B * N,
                           2.0 * B * Kd * N, INT8_OPS_PER_S)
        detail.append({"kernel": f"{kernel} (act_quant_static fused)",
                       "site": name, "M": B, "K": Kd, "N": N,
                       "max_abs_err": 0.0, "kernel_ms": ms,
                       "unfused_ms": ums, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": None})
        print(json.dumps(detail[-1]), flush=True)
        return ms, ums, pms, bms
    # the int matmuls at every main-path M: decode (B rows), a 256-token
    # chunk of run (d), a whole prefill (B * PROMPT rows); s_w in bf16 (the
    # weight's dtype, the main path) and f32, both held torch.equal
    MS = (B, 256, B * PROMPT)
    # w8a8: the five (K, N) pairs of one layer plus the tied head
    shapes = {"qkv": (D, (H + 2 * K) * hd), "o": (H * hd, D),
              "up_gate": (D, F_), "down": (F_, D), "head": (D, V)}
    per_layer = {"qkv": 1, "o": 1, "up_gate": 2, "down": 1}
    w8, fz8 = {}, {}
    for name, (Kd, N) in shapes.items():
        w = torch.randint(-127, 128, (Kd, N), generator=gen, device=dev,
                          dtype=torch.int8)
        colsum = w.sum(0, dtype=torch.int32)
        w_kmajor = w.t().contiguous().t()      # the same (K, N), K-major
        for M in MS:
            x = torch.randint(-128, 128, (M, Kd), generator=gen, device=dev,
                              dtype=torch.int8)
            sw_bf = scalar(0.0037).to(bf)
            args = (x, w, scalar(0.021), scalar(131.0), sw_bf, colsum)
            kw = dict(z_shift=-128.0, out_dtype=torch.bfloat16)
            for sw in (sw_bf, scalar(0.0037)):
                a_ = (*args[:4], sw, colsum)
                out_k = w8a8_matmul(*a_, **kw)
                out_p = w8a8_matmul_plain(*a_, **kw)
                torch.cuda.synchronize()
                if not torch.equal(out_k, out_p):
                    fail(f"w8a8_matmul {name} M={M} s_w {sw.dtype}: not "
                         f"bit-exact, max err "
                         f"{(out_k.float() - out_p.float()).abs().max():.3g}")
            ms = timed(lambda: w8a8_matmul(*args, **kw))
            if M == B:
                sws = {True: sw_bf, False: scalar(0.0037)}
                fz8[name] = fused_row(
                    "w8a8_matmul", name, Kd, N,
                    lambda x_, b_: quant_w8a8_matmul(
                        x_, w, a_sx, a_zx, sws[b_], colsum, out_dtype=bf),
                    lambda x_, b_: w8a8_matmul(
                        act_quant_static(x_, a_sx, a_zx), w, a_sx, a_zx,
                        sws[b_], colsum, z_shift=-128.0, out_dtype=bf),
                    lambda x_, b_: quant_w8a8_matmul_plain(
                        x_, w, a_sx, a_zx, sws[b_], colsum, out_dtype=bf),
                    Kd * N + 4 * N)
            if M == 256:
                # held and timed, not summed into a step or a prefill
                detail.append({"kernel": "w8a8_matmul", "site": name,
                               "M": M, "K": Kd, "N": N, "max_abs_err": 0.0,
                               "kernel_ms": ms})
                print(json.dumps(detail[-1]), flush=True)
                continue
            pms = timed(lambda: w8a8_matmul_plain(*args, **kw), iters=3)
            lib_km = None
            if M > 16:
                lib_ms = timed(lambda: torch._int_mm(x, w))
                lib_km = timed(lambda: torch._int_mm(x, w_kmajor))
            else:
                # _int_mm takes M > 16: x zero-padded to 32 rows, the copy
                # made outside the timed window
                xp = torch.zeros((32, Kd), dtype=torch.int8, device=dev)
                xp[:M] = x
                lib_ms = timed(lambda: torch._int_mm(xp, w))
            bms, by = bound_ms(M * Kd + Kd * N + 4 * N + 2 * M * N,
                               2.0 * M * Kd * N, INT8_OPS_PER_S)
            w8[(name, M)] = (ms, pms, bms, lib_ms, lib_km)
            detail.append({"kernel": "w8a8_matmul", "site": name, "M": M,
                           "K": Kd, "N": N, "max_abs_err": 0.0,
                           "kernel_ms": ms,
                           "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                           "library_ms": lib_ms,
                           "library_of": ("torch._int_mm" if M > 16 else
                                          "torch._int_mm, x zero-padded to "
                                          "32 rows"),
                           "library_kmajor_ms": lib_km})
            print(json.dumps(detail[-1]), flush=True)
        del w_kmajor

    # act_quant: every GEMM input at decode (M=B) and prefill (M=B*PROMPT)
    aq = {}
    for Dd in (D, F_):
        for M in (B, B * PROMPT):
            x = torch.randn((M, Dd), generator=gen, device=dev).to(
                torch.bfloat16) * 3
            s, z = scalar(0.027), scalar(117.0)
            a_k = act_quant_static(x, s, z)
            a_p = act_quant_static_plain(x, s, z)
            torch.cuda.synchronize()
            if not torch.equal(a_k, a_p):
                fail(f"act_quant_static D={Dd} M={M}: not bit-exact")
            ms = timed(lambda: act_quant_static(x, s, z))
            pms = timed(lambda: act_quant_static_plain(x, s, z), iters=3)
            # the nearest PyTorch call: quint8 codes in [0, 255] (no -128
            # offset), from an f32 copy of the same values (it takes no bf16)
            xf = x.float()
            try:
                lib_ms = timed(lambda: torch.quantize_per_tensor(
                    xf, 0.027, 117, torch.quint8))
            except RuntimeError as e:
                log(f"quantize_per_tensor not timed: {e}")
                lib_ms = None
            bms, by = bound_ms(3 * M * Dd, 4.0 * M * Dd, F32_FLOPS_PER_S)
            aq[(Dd, M)] = (ms, pms, bms, lib_ms)
            detail.append({"kernel": "act_quant_static", "D": Dd, "M": M,
                           "max_abs_err": 0.0, "kernel_ms": ms, "plain_ms": pms,
                           "over_floor_ms": ms - floor_ms,
                           "bound_ms": bms, "bound_by": by,
                           "library_ms": lib_ms,
                           "library_of": "torch.quantize_per_tensor quint8, "
                                         "f32 input"})
            print(json.dumps(detail[-1]), flush=True)

    # w4a8: the four prequantized (K, N) pairs of one layer (the tied head
    # stays W8A8); one group of 960 where 128 does not divide d_model,
    # twenty of 128 for down; s_w in bf16 (the main path) and f32
    w4, fz4 = {}, {}
    for name in per_layer:
        Kd, N = shapes[name]
        wg = QuantConfig().w_group
        gs = wg if Kd % wg == 0 else Kd
        G = Kd // gs
        wp = torch.randint(-128, 128, (Kd // 2, N), generator=gen,
                           device=dev, dtype=torch.int8)
        s_w32 = torch.rand((G, N), generator=gen, device=dev) * 0.002 + 1e-4
        s_w = s_w32.to(bf)
        colsum = torch.randn((N,), generator=gen, device=dev)
        for M in MS:
            x = torch.randint(-128, 128, (M, Kd), generator=gen, device=dev,
                              dtype=torch.int8)
            args = (x, wp, scalar(0.021), scalar(131.0), s_w, colsum, gs)
            kw = dict(z_shift=-128.0, out_dtype=torch.bfloat16)
            for sw in (s_w, s_w32):
                a_ = (*args[:4], sw, colsum, gs)
                out_k = w4a8_matmul(*a_, **kw)
                out_p = w4a8_matmul_plain(*a_, **kw)
                torch.cuda.synchronize()
                if not torch.equal(out_k, out_p):
                    fail(f"w4a8_matmul {name} M={M} s_w {sw.dtype}: not "
                         f"bit-exact, max err "
                         f"{(out_k.float() - out_p.float()).abs().max():.3g}")
            ms = timed(lambda: w4a8_matmul(*args, **kw))
            if M == B:
                sws = {True: s_w, False: s_w32}
                fz4[name] = fused_row(
                    "w4a8_matmul", name, Kd, N,
                    lambda x_, b_: quant_w4a8_matmul(
                        x_, wp, a_sx, a_zx, sws[b_], colsum, gs,
                        out_dtype=bf),
                    lambda x_, b_: w4a8_matmul(
                        act_quant_static(x_, a_sx, a_zx), wp, a_sx, a_zx,
                        sws[b_], colsum, gs, z_shift=-128.0, out_dtype=bf),
                    lambda x_, b_: quant_w4a8_matmul_plain(
                        x_, wp, a_sx, a_zx, sws[b_], colsum, gs,
                        out_dtype=bf),
                    Kd // 2 * N + 2 * G * N + 4 * N)
            if M == 256:
                detail.append({"kernel": "w4a8_matmul", "site": name,
                               "M": M, "K": Kd, "N": N, "groups": G,
                               "max_abs_err": 0.0, "kernel_ms": ms})
                print(json.dumps(detail[-1]), flush=True)
                continue
            pms = timed(lambda: w4a8_matmul_plain(*args, **kw), iters=3)
            bms, by = bound_ms(M * Kd + Kd // 2 * N + 2 * G * N + 4 * N
                               + 2 * M * N, 2.0 * M * Kd * N, INT8_OPS_PER_S)
            w4[(name, M)] = (ms, pms, bms)
            detail.append({"kernel": "w4a8_matmul", "site": name, "M": M,
                           "K": Kd, "N": N, "groups": G, "max_abs_err": 0.0,
                           "kernel_ms": ms, "plain_ms": pms, "bound_ms": bms,
                           "bound_by": by, "library_ms": None,
                           "w8a8_kernel_ms": w8[(name, M)][0]})
            print(json.dumps(detail[-1]), flush=True)
    log("w8a8_matmul and w4a8_matmul torch.equal to their plain versions "
        f"at every site for M in {MS}, s_w in bf16 and f32; at M = {B} "
        "quantizing bf16 and f32 x in their staging, torch.equal to "
        "act_quant_static + the matmul and to the plain composition")

    # act_quant_ptoken: every GEMM input, both arithmetics (bf16 input: the
    # smollm path; f32 input: f32 activations), with an outlier row; held
    # torch.equal also with an all-zero row planted, and timed both ways
    # (the gate reads the rows without it: an all-zero activation row is
    # not known to occur in serving, and its zero dividends take the IEEE
    # division's slow path)
    pt = {}
    for Dd in (D, F_):
        for M in (B, B * PROMPT):
            x = torch.randn((M, Dd), generator=gen, device=dev) * 3 + 0.2
            x[2, 11] = 300.0
            xz = x.clone()
            xz[1] = 0.0
            for mode, xin, xzin in (("bf16", x.to(bf), xz.to(bf)),
                                    ("f32", x, xz)):
                for rows, x_ in (("", xin), (" with a zero row", xzin)):
                    a_k = act_quant_ptoken(x_)
                    a_p = act_quant_ptoken_plain(x_)
                    torch.cuda.synchronize()
                    if not all(torch.equal(u, v) for u, v in zip(a_k, a_p)):
                        fail(f"act_quant_ptoken {mode} D={Dd} M={M}{rows}: "
                             f"not bit-exact")
                ms = timed(lambda: act_quant_ptoken(xin))
                zms = timed(lambda: act_quant_ptoken(xzin))
                pms = timed(lambda: act_quant_ptoken_plain(xin), iters=3)
                bms, by = bound_ms((xin.element_size() + 1) * M * Dd + 8 * M,
                                   6.0 * M * Dd, F32_FLOPS_PER_S)
                pt[(Dd, M, mode)] = (ms, pms, bms, zms)
                detail.append({"kernel": "act_quant_ptoken", "mode": mode,
                               "D": Dd, "M": M, "max_abs_err": 0.0,
                               "kernel_ms": ms, "plain_ms": pms,
                               "over_floor_ms": ms - floor_ms,
                               "zero_row_kernel_ms": zms,
                               "bound_ms": bms, "bound_by": by,
                               "library_ms": None})
                print(json.dumps(detail[-1]), flush=True)

    log("act quantizers, us a call and over the floor of "
        f"{floor_ms * 1e3:.2f}: static "
        + ", ".join(f"D={k[0]} M={k[1]} {v[0] * 1e3:.2f} "
                    f"(+{(v[0] - floor_ms) * 1e3:.2f})" for k, v in aq.items())
        + "; ptoken "
        + ", ".join(f"{k[2]} D={k[0]} M={k[1]} {v[0] * 1e3:.2f} "
                    f"(+{(v[0] - floor_ms) * 1e3:.2f})" for k, v in pt.items()))

    def ulp_check(name, got, want):
        err = (got.float() - want.float()).abs()
        lim = BF16_ULP * want.float().abs() + 1e-6
        if not bool((err <= lim).all()):
            fail(f"{name}: beyond one bf16 ulp, max err {float(err.max())}")
        return float(err.max())

    def attention_row(Bq, S, m):
        """flash_attention (bf16) at (Bq, S) behind an m-row cushion: one
        bf16 ulp of the plain version, timed beside its bound and SDPA."""
        T = S + m
        q = torch.randn((Bq, S, H, hd), generator=gen, device=dev).to(bf)
        k = torch.randn((Bq, T, K, hd), generator=gen, device=dev).to(bf)
        v = torch.randn((Bq, T, K, hd), generator=gen, device=dev).to(bf)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        err = ulp_check(f"flash_attention B={Bq} S={S}",
                        flash_attention(qh, kh, vh, prefix_len=m),
                        flash_attention_plain(qh, kh, vh, prefix_len=m))
        ms = timed(lambda: flash_attention(qh, kh, vh, prefix_len=m))
        pms = timed(lambda: flash_attention_plain(qh, kh, vh,
                                                  prefix_len=m), 3)
        i = torch.arange(S, device=dev)[:, None]
        j = torch.arange(T, device=dev)[None, :]
        vis = (j < m) | (j <= i + m)
        qc, kc_, vc_ = qh.contiguous(), kh.contiguous(), vh.contiguous()
        try:
            lib = timed(lambda: F.scaled_dot_product_attention(
                qc, kc_, vc_, attn_mask=vis, enable_gqa=True))
        except (RuntimeError, TypeError) as e:
            log(f"scaled_dot_product_attention not timed: {e}")
            lib = None
        pairs = Bq * H * (S * m + S * (S + 1) / 2)
        bms, by = bound_ms(2 * (2 * Bq * H * S * hd + 2 * Bq * K * T * hd),
                           4.0 * hd * pairs, BF16_FLOPS_PER_S)
        detail.append({"kernel": "flash_attention", "B": Bq, "S": S,
                       "m": m, "max_abs_err": err, "kernel_ms": ms,
                       "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lib})
        print(json.dumps(detail[-1]), flush=True)
        return (ms, pms, bms, by, err, lib), (qh, kh, vh)

    # flash_attention: B=4, S=512 behind a 4-row cushion (the main path),
    # and B=1, S=2048 (how the tiles scale with length)
    (fa_ms, fa_pms, fa_bms, fa_by, fa_err, fa_lib), (qh, kh, vh) = \
        attention_row(B, PROMPT, CUSHION)
    fa_long = attention_row(1, 2048, CUSHION)[0]
    # a query's result depends on no other query: the last 100 rows of the
    # one-shot call equal a call on those rows alone with the prefix moved
    # by the cut (the chunked prefill's call)
    cut = PROMPT - 100
    if not torch.equal(
            flash_attention(qh, kh, vh, prefix_len=CUSHION)[:, :, cut:],
            flash_attention(qh[:, :, cut:], kh, vh,
                            prefix_len=CUSHION + cut)):
        fail("flash_attention: the last 100 rows differ from a call on "
             "those rows alone")
    log("flash_attention rows independent of the other queries "
        "(torch.equal)")

    # flash_attention with the live-length mask at the search's scoring
    # shape (phase 4c): a chunk of 16 candidates, each [candidate; the
    # 256-token sample] (S = 257) behind the prefix padded to 4 rows, 2
    # live; one bf16 ulp of the plain version, garbage in the dead rows
    # changing nothing, timed beside its bound and SDPA with the same mask
    def vis_mask(S, m, live):
        i = torch.arange(S, device=dev)[:, None]
        j = torch.arange(S + m, device=dev)[None, :]
        return ((j < live) | (j >= m)) & ((j < m) | (j <= i + m))

    def masked_row(Bq, S, m, live):
        T = S + m
        q = torch.randn((Bq, S, H, hd), generator=gen, device=dev).to(bf)
        k = torch.randn((Bq, T, K, hd), generator=gen, device=dev).to(bf)
        v = torch.randn((Bq, T, K, hd), generator=gen, device=dev).to(bf)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kw = dict(prefix_len=m, prefix_live=live)
        got = flash_attention(qh, kh, vh, **kw)
        err = ulp_check(f"flash_attention masked B={Bq} S={S} live={live}",
                        got, flash_attention_plain(qh, kh, vh, **kw))
        kd, vd = k.clone(), v.clone()
        kd[:, live:m], vd[:, live:m] = 1e3, -1e3
        if not torch.equal(flash_attention(qh, kd.transpose(1, 2),
                                           vd.transpose(1, 2), **kw), got):
            fail("flash_attention: a dead prefix row changed the result")
        ms = timed(lambda: flash_attention(qh, kh, vh, **kw))
        pms = timed(lambda: flash_attention_plain(qh, kh, vh, **kw), 3)
        vis = vis_mask(S, m, live)
        qc, kc_, vc_ = qh.contiguous(), kh.contiguous(), vh.contiguous()
        try:
            lib = timed(lambda: F.scaled_dot_product_attention(
                qc, kc_, vc_, attn_mask=vis, enable_gqa=True))
        except (RuntimeError, TypeError) as e:
            log(f"scaled_dot_product_attention not timed: {e}")
            lib = None
        pairs = Bq * H * (S * live + S * (S + 1) / 2)
        bms, by = bound_ms(2 * (2 * Bq * H * S * hd + 2 * Bq * K * T * hd),
                           4.0 * hd * pairs, BF16_FLOPS_PER_S)
        detail.append({"kernel": "flash_attention", "mask": "prefix_live",
                       "B": Bq, "S": S, "m": m, "prefix_live": live,
                       "max_abs_err": err, "kernel_ms": ms, "plain_ms": pms,
                       "bound_ms": bms, "bound_by": by, "library_ms": lib})
        print(json.dumps(detail[-1]), flush=True)
        return ms, pms, bms, by, err, lib

    fa_masked = masked_row(SEARCH_CHUNK, SAMPLE_LEN + 1, MAX_PREFIX, 2)

    # flash_attention_bwd at the tuning shape (B = 2, S = 256 behind the
    # 4-row cushion), f32 and bf16, all rows live and with rows [1, 4)
    # dead: against flash_attention_bwd_plain on the same inputs (the
    # kernel's own output and log-sum-exp), f32 within 1e-5 of the largest
    # entry, bf16 within one bf16 ulp plus 1e-5 of the largest entry (the
    # f32 sums run in another order, and P and dS enter the tensor cores
    # as two bf16 terms each, before the bf16 rounding); dead rows exactly
    # zero; two calls identical; timed beside its bound, the plain version,
    # the kernel's forward + backward through autograd and SDPA's forward +
    # backward with the same boolean mask
    def bwd_row(dt, live):
        Bq, S, m = TUNE_B, TUNE_S, MAX_PREFIX
        T = S + m
        mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)  # noqa: E731
        q = mk(Bq, S, H, hd).transpose(1, 2)
        k, v = mk(Bq, T, K, hd).transpose(1, 2), mk(Bq, T, K, hd).transpose(1, 2)
        do = mk(Bq, S, H, hd).transpose(1, 2)
        o, lse = FA._launch(q, k, v, m, live, with_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, m, live)
        again = flash_attention_bwd(q, k, v, o, lse, do, m, live)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, m, live)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd {dt} live={live}: two calls on the "
                 f"same inputs differ")
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            e = (a.float() - b.float()).abs()
            lim = 1e-5 * float(b.float().abs().max())
            if dt == bf:
                lim = BF16_ULP * b.float().abs() + lim
            if not bool((e <= lim).all()):
                fail(f"flash_attention_bwd {dt} live={live} {name}: beyond "
                     f"the stated tolerance, max err {float(e.max())}")
            errs.append(float(e.max()))
        if got[1][:, :, live:m].any() or got[2][:, :, live:m].any():
            fail("flash_attention_bwd: a dead prefix row has a gradient")
        ms = timed(lambda: flash_attention_bwd(q, k, v, o, lse, do, m, live))
        pms = timed(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      m, live), 3)
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (q, k, v))

        def fwd_bwd():
            flash_attention(qg, kg, vg, prefix_len=m,
                            prefix_live=live).backward(do)

        fb_ms = timed(fwd_bwd)
        vis = vis_mask(S, m, live)
        qs, ks_, vs_ = (t.detach().contiguous().requires_grad_()
                        for t in (q, k, v))
        dos = do.contiguous()

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                qs, ks_, vs_, attn_mask=vis, enable_gqa=True).backward(dos)

        try:
            lib = timed(sdpa_fwd_bwd)
        except (RuntimeError, TypeError) as e:
            log(f"scaled_dot_product_attention backward not timed: {e}")
            lib = None
        eb = 2 if dt == bf else 4
        pairs = Bq * H * (S * live + S * (S + 1) / 2)
        # reads q, k, v, o, do and lse once, writes dq, dk, dv once; the
        # products need 10 hd operations a visible pair (QK^T and dO V^T
        # recomputed, dV, dK, dQ)
        bms, by = bound_ms(eb * (4 * Bq * H * S * hd + 4 * Bq * K * T * hd)
                           + 4 * Bq * H * S, 10.0 * hd * pairs,
                           BF16_FLOPS_PER_S if dt == bf else F32_FLOPS_PER_S)
        detail.append({"kernel": "flash_attention_bwd",
                       "dtype": str(dt).replace("torch.", ""), "B": Bq,
                       "S": S, "m": m, "prefix_live": live,
                       "max_abs_err": max(errs), "kernel_ms": ms,
                       "plain_ms": pms, "fwd_bwd_ms": fb_ms,
                       "bound_ms": bms, "bound_by": by, "library_ms": lib,
                       "library_of": "scaled_dot_product_attention forward "
                                     "+ backward, the same boolean mask "
                                     "(beside fwd_bwd_ms)"})
        print(json.dumps(detail[-1]), flush=True)
        return ms, pms, bms, by, max(errs), lib, fb_ms

    fa_bwd = {(str(dt).replace("torch.", ""), live): bwd_row(dt, live)
              for dt in (bf, torch.float32) for live in (MAX_PREFIX, 1)}
    log("flash_attention_bwd within its stated tolerance of the plain "
        "version (f32, bf16; all live and rows [1, 4) dead), dead rows "
        "exactly zero, two calls identical: ms a call (a tuning step: "
        f"x {cfg.n_layers}) " + ", ".join(
            f"{k}: {v[0]:.4f} ({cfg.n_layers * v[0]:.3f} a step; bound "
            f"{v[2]:.4f}, fwd+bwd {v[6]:.4f}, SDPA fwd+bwd {v[5]})"
            for k, v in fa_bwd.items()))
    fb, sdpa = fa_bwd[("bfloat16", MAX_PREFIX)][6], \
        fa_bwd[("bfloat16", MAX_PREFIX)][5]
    log(f"bf16, all rows live: forward + backward through autograd "
        f"{fb:.4f} ms against SDPA's forward + backward {sdpa} ms "
        f"({'no slower' if sdpa is not None and fb <= sdpa else 'slower'})")

    # rows 4, 5, 6 and 8 at stablelm-3b's head_dim 80 (phase 4o serves it)
    record["stablelm"] = {"kernels": head_dim_80_rows(dev, timed)}

    # the non-causal mode, forward and backward, at whisper-base's shapes
    fa_nc, fa_nc_bwd = noncausal_attention_rows(dev, timed)
    detail += [{"kernel": "flash_attention", "causal": False, "shape": k_,
                **r} for k_, r in fa_nc.items()]
    detail.append({"kernel": "flash_attention_bwd", "causal": False,
                   **fa_nc_bwd})

    # flash_decode: int8 + cushion (main path) and fp, mid-generation pos
    Smax = cache_seq_len(PROMPT + NEW_TOKENS + 32)
    pos_v = CUSHION + PROMPT + NEW_TOKENS // 2
    qd = torch.randn((B, H, hd), generator=gen, device=dev).to(bf)
    pos = torch.tensor(pos_v, dtype=torch.int32, device=dev)
    kq = torch.randint(-127, 128, (B, Smax, K, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, Smax, K, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((K,), generator=gen, device=dev) * 0.05 + 0.01
    vs = torch.rand((K,), generator=gen, device=dev) * 0.05 + 0.01
    kc = torch.randn((CUSHION, K, hd), generator=gen, device=dev).to(bf)
    vc = torch.randn((CUSHION, K, hd), generator=gen, device=dev).to(bf)
    kf = torch.randn((B, Smax, K, hd), generator=gen, device=dev).to(bf)
    vf = torch.randn((B, Smax, K, hd), generator=gen, device=dev).to(bf)
    fd = {}
    for mode, a in (("int8", (qd, kq, vq, pos, ks, vs, kc, vc)),
                    ("fp", (qd, kf, vf, pos))):
        err = ulp_check(f"flash_decode {mode}", flash_decode(*a),
                        flash_decode_plain(*a))
        ms = timed(lambda: flash_decode(*a))
        pms = timed(lambda: flash_decode_plain(*a), 3)
        n_live = pos_v + 1 - (CUSHION if mode == "int8" else 0)
        cache_b = 1 if mode == "int8" else 2
        by_ = (4 * B * H * hd + 2 * B * n_live * K * hd * cache_b
               + (4 * CUSHION * K * hd + 8 * K if mode == "int8" else 0))
        bms, by = bound_ms(by_, 4.0 * B * H * hd * (pos_v + 1),
                           BF16_FLOPS_PER_S)
        fd[mode] = (ms, pms, bms, by, err)
        lib_ms = None
        if mode == "fp":
            # one PyTorch call computes the fp contiguous mode: SDPA with
            # the position mask and GQA (no row is retired here)
            q4 = qd[:, :, None]
            kt, vt = kf.transpose(1, 2).contiguous(), \
                vf.transpose(1, 2).contiguous()
            vis_d = (torch.arange(Smax, device=dev) <= pos_v)[None, None,
                                                                None]
            try:
                lib_ms = timed(lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=vis_d, enable_gqa=True))
                got = F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=vis_d, enable_gqa=True)[:, :, 0]
                diff = (got.float() - flash_decode(*a).float()).abs().max()
                log(f"flash_decode fp: SDPA {lib_ms:.4f} ms, max |SDPA - "
                    f"kernel| {float(diff):.3g}")
            except (RuntimeError, TypeError) as e:
                log(f"scaled_dot_product_attention not timed: {e}")
        fd[mode] += (lib_ms,)
        detail.append({"kernel": "flash_decode", "mode": mode, "B": B,
                       "Smax": Smax, "pos": pos_v, "max_abs_err": err,
                       "kernel_ms": ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lib_ms})
        print(json.dumps(detail[-1]), flush=True)

    # how split-KV scales with length: int8 (B, K) at pos 4000 in a
    # 4096-position cache (and fp beside SDPA), B = 4
    SL, PL = 4096, 4000
    kql = torch.randint(-127, 128, (B, SL, K, hd), generator=gen,
                        device=dev, dtype=torch.int8)
    vql = torch.randint(-127, 128, (B, SL, K, hd), generator=gen,
                        device=dev, dtype=torch.int8)
    kfl = torch.randn((B, SL, K, hd), generator=gen, device=dev).to(bf)
    vfl = torch.randn((B, SL, K, hd), generator=gen, device=dev).to(bf)
    ksl = torch.rand((B, K), generator=gen, device=dev) * 0.05 + 0.01
    vsl = torch.rand((B, K), generator=gen, device=dev) * 0.05 + 0.01
    prl = torch.full((B,), PL, dtype=torch.int32, device=dev)
    fd_long = {}
    for mode, a in (("int8_BK", (qd, kql, vql, prl, ksl, vsl, kc, vc)),
                    ("fp", (qd, kfl, vfl, prl))):
        err = ulp_check(f"flash_decode {mode} Smax={SL}", flash_decode(*a),
                        flash_decode_plain(*a))
        ms = timed(lambda: flash_decode(*a))
        pms = timed(lambda: flash_decode_plain(*a), 3)
        if mode == "fp":
            by_ = 4 * B * H * hd + 2 * B * (PL + 1) * K * hd * 2
        else:
            by_ = (4 * B * H * hd + 2 * B * (PL + 1 - CUSHION) * K * hd
                   + 4 * CUSHION * K * hd + 8 * B * K)
        bms, by = bound_ms(by_, 4.0 * B * H * hd * (PL + 1),
                           BF16_FLOPS_PER_S)
        lib_ms = None
        if mode == "fp":
            kt, vt = kfl.transpose(1, 2).contiguous(), \
                vfl.transpose(1, 2).contiguous()
            vis_d = (torch.arange(SL, device=dev) <= PL)[None, None, None]
            try:
                lib_ms = timed(lambda: F.scaled_dot_product_attention(
                    qd[:, :, None], kt, vt, attn_mask=vis_d,
                    enable_gqa=True))
            except (RuntimeError, TypeError) as e:
                log(f"scaled_dot_product_attention not timed: {e}")
        fd_long[mode] = (ms, pms, bms, by, err, lib_ms)
        detail.append({"kernel": "flash_decode", "mode": mode, "B": B,
                       "Smax": SL, "pos": PL, "max_abs_err": err,
                       "kernel_ms": ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lib_ms})
        print(json.dumps(detail[-1]), flush=True)
    del kql, vql, kfl, vfl

    # the continuous path's decode attention: per-row (B, K) scales on the
    # contiguous slot pool, and the paged pool (page size 64, the pool's P
    # pages per row, a shuffled table over B * P + 1 pages, page 0 scratch)
    PS = 64
    Pn = Smax // PS
    ksr = torch.rand((B, K), generator=gen, device=dev) * 0.05 + 0.01
    vsr = torch.rand((B, K), generator=gen, device=dev) * 0.05 + 0.01
    n_pages = B * Pn + 1
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(B, Pn)

    def paginate(dense):
        pages = torch.zeros((n_pages, PS, K, hd), dtype=dense.dtype,
                            device=dev)
        if dense.dtype == torch.int8:
            pages[0] = 99                        # scratch junk
        else:
            pages[0] = 1e3
        pages[table.reshape(-1).long()] = dense.reshape(B * Pn, PS, K, hd)
        return pages

    kpq, vpq, kpf, vpf = (paginate(t) for t in (kq, vq, kf, vf))
    # pos at m - 1, on a page boundary, mid-page (the timed position), and
    # a retired row
    pcase = torch.tensor([CUSHION - 1, 2 * PS, pos_v, -1], dtype=torch.int32,
                         device=dev)
    int8_k = dict(k_scale=ks, v_scale=vs, kc=kc, vc=vc)
    int8_bk = dict(k_scale=ksr, v_scale=vsr, kc=kc, vc=vc)
    err_bk = ulp_check("flash_decode (B, K) scales",
                       flash_decode(qd, kq, vq, pcase, **int8_bk),
                       flash_decode_plain(qd, kq, vq, pcase, **int8_bk))
    paged_err = {}
    for mode, (kp, vp), kw in (("int8_K", (kpq, vpq), int8_k),
                               ("int8_BK", (kpq, vpq), int8_bk),
                               ("fp", (kpf, vpf), {}),
                               ("fp_cushion", (kpf, vpf),
                                dict(kc=kc, vc=vc))):
        got = flash_decode_paged(qd, kp, vp, table, pcase, **kw)
        paged_err[mode] = ulp_check(
            f"flash_decode_paged {mode}", got,
            flash_decode_paged_plain(qd, kp, vp, table, pcase, **kw))
        kd, vd = gather_pages(kp, table), gather_pages(vp, table)
        if mode == "fp_cushion":
            # the contiguous fp kernel keeps the cushion in-cache; live rows
            # must agree bit for bit (a retired row sees the cushion only
            # in the paged pool)
            kd[:, :CUSHION], vd[:, :CUSHION] = kc, vc
            live = pcase >= 0
            same = torch.equal(got[live], flash_decode(qd, kd, vd,
                                                       pcase)[live])
        else:
            same = torch.equal(got, flash_decode(qd, kd, vd, pcase, **kw))
        if not same:
            fail(f"flash_decode_paged {mode}: not bit-identical to "
                 f"flash_decode on the gathered pool")
    log(f"flash_decode_paged bit-identical to flash_decode on the gathered "
        f"pool (int8 (K,) and (B, K), fp, fp + cushion); max |err| vs plain "
        f"{paged_err}; (B, K) contiguous vs plain {err_bk:.3g}")
    # a row's result does not depend on the batch: row b of the B = 4 call
    # equals the row computed alone, contiguous and paged
    for name, full, alone in (
            ("flash_decode (B, K)",
             flash_decode(qd, kq, vq, pcase, **int8_bk),
             lambda r: flash_decode(qd[r], kq[r], vq[r], pcase[r],
                                    k_scale=ksr[r], v_scale=vsr[r], kc=kc,
                                    vc=vc)),
            ("flash_decode_paged fp",
             flash_decode_paged(qd, kpf, vpf, table, pcase),
             lambda r: flash_decode_paged(qd[r], kpf, vpf, table[r],
                                          pcase[r]))):
        for b_ in range(B):
            r = slice(b_, b_ + 1)
            if not torch.equal(full[r], alone(r)):
                fail(f"{name}: row {b_} of the batch differs from the row "
                     f"computed alone")
    log("flash_decode rows independent of the batch (torch.equal)")
    # timed at the continuous path's decode shape: every row at pos_v
    prow = torch.full((B,), pos_v, dtype=torch.int32, device=dev)
    n_live = pos_v + 1 - CUSHION
    pages_live = -(-(pos_v + 1) // PS)
    cont = {}
    for name, fn, plain, extra in (
            ("flash_decode_BK",
             lambda: flash_decode(qd, kq, vq, prow, **int8_bk),
             lambda: flash_decode_plain(qd, kq, vq, prow, **int8_bk), 0),
            ("flash_decode_paged_BK",
             lambda: flash_decode_paged(qd, kpq, vpq, table, prow,
                                        **int8_bk),
             lambda: flash_decode_paged_plain(qd, kpq, vpq, table, prow,
                                              **int8_bk),
             4 * B * pages_live),
            ("flash_decode_paged_fp",
             lambda: flash_decode_paged(qd, kpf, vpf, table, prow,
                                        kc=kc, vc=vc),
             lambda: flash_decode_paged_plain(qd, kpf, vpf, table, prow,
                                              kc=kc, vc=vc),
             4 * B * pages_live)):
        ms = timed(fn)
        pms = timed(plain, 3)
        cache_b = 2 if name.endswith("_fp") else 1
        by_ = (4 * B * H * hd + 2 * B * n_live * K * hd * cache_b
               + 4 * CUSHION * K * hd + extra
               + (0 if cache_b == 2 else 8 * B * K))
        bms, by = bound_ms(by_, 4.0 * B * H * hd * (pos_v + 1),
                           BF16_FLOPS_PER_S)
        cont[name] = (ms, pms, bms, by)
        detail.append({"kernel": name, "B": B, "Smax": Smax, "page_size": PS,
                       "pos": pos_v, "kernel_ms": ms, "plain_ms": pms,
                       "bound_ms": bms, "bound_by": by, "library_ms": None})
        print(json.dumps(detail[-1]), flush=True)
    log(f"decode attention per call at pos {pos_v}: contiguous (B, K) "
        f"{cont['flash_decode_BK'][0]:.4f} ms, paged (B, K) "
        f"{cont['flash_decode_paged_BK'][0]:.4f} ms, paged fp "
        f"{cont['flash_decode_paged_fp'][0]:.4f} ms")
    record["kernel_detail"] = detail
    phase_done("kernels")

    # 4. the main path at full width ------------------------------------
    api = build(cfg, "cuda")
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    cushion = seeded_cushion(api, params, CUSHION, seed=0)
    t0 = time.perf_counter()
    corpus = corpus_job.result()
    corpus_pool.shutdown()
    log(f"synthetic corpus over {V} ids (built beside phases 2 and 3), "
        f"waited {time.perf_counter() - t0:.1f} s for it (host set-up)")
    pipe = Pipeline(corpus, batch=B, seq_len=PROMPT, seed=1)
    calib = [to_device(pipe.get_batch(1000 + n), dev) for n in range(2)]
    batch = to_device(pipe.get_batch(0), dev)
    max_seq = PROMPT + NEW_TOKENS + 32
    qw8 = QuantConfig(mode="pt_static", true_int8=True)
    qpt = QuantConfig(mode="ptoken_dynamic")
    # label: (qcfg, kv_dtype, prequant, weight_bits)
    modes = {"w8a8_int8kv": (qw8, "int8", True, 8),
             "fp": (QuantConfig(), None, False, 8),
             "w4a8_int8kv": (qw8, "int8", True, 4),
             "ptoken_fp": (qpt, None, False, 8)}
    L = cfg.n_layers
    zero_counts = {k: 0 for k in _lib.LAUNCHES}
    attn = {"flash_attention": L, "flash_decode": L * (NEW_TOKENS - 1)}
    # launches per request of B = 4 (NEW_TOKENS forward passes: 160 qlinear
    # sites and the head each). The static quantizer runs standalone at the
    # prefill's 160 sites (M = B * PROMPT) and inside the matmul at M <= 16:
    # the prefill's head (the last position, M = B) and every decode site
    quant = {"act_quant_static": 160,
             "act_quant_static_fused": 1 + 161 * (NEW_TOKENS - 1)}
    expect_static = {
        "w8a8_int8kv": {**zero_counts, **attn, **quant,
                        "w8a8_matmul": 161 * NEW_TOKENS},
        "fp": {**zero_counts, **attn},
        "w4a8_int8kv": {**zero_counts, **attn, **quant,
                        "w4a8_matmul": 160 * NEW_TOKENS,
                        "w8a8_matmul": NEW_TOKENS},     # the tied head
        "ptoken_fp": {**zero_counts, **attn,
                      "act_quant_ptoken": 161 * NEW_TOKENS}}
    runs, engines = {}, {}
    for label, (qcfg, kv, pre, wb) in modes.items():
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(api, params, qcfg, cushion=cushion, max_seq=max_seq,
                     kv_dtype=kv, calib_batches=calib if pre else None,
                     scales=(engines["w8a8_int8kv"].scales
                             if pre and engines else None),
                     prequant=pre, weight_bits=wb)
        eng.generate(batch, 8)              # warm-up; captures B's step
        graph = eng.states[B].graph
        _lib.reset_launches()
        res = eng.generate(batch, NEW_TOKENS)
        counts = dict(_lib.LAUNCHES)
        replays = _lib.COUNTERS["graph_replays"]
        toks = res.tokens
        if toks.shape != (B, NEW_TOKENS) or toks.min() < 0 \
                or toks.max() >= V:
            fail(f"{label}: bad tokens {toks.shape} "
                 f"[{toks.min()}, {toks.max()}]")
        if counts != expect_static[label]:
            fail(f"{label}: launches {counts}, expected "
                 f"{expect_static[label]}")
        if replays != NEW_TOKENS - 1:
            fail(f"{label}: {replays} graph replays, expected "
                 f"{NEW_TOKENS - 1}")
        # the eager per-token loop: the same tokens and launches
        _lib.reset_launches()
        eager = eng.generate_py(batch, NEW_TOKENS)
        if not np.array_equal(eager.tokens, toks):
            fail(f"{label}: graph tokens differ from the eager step's")
        if dict(_lib.LAUNCHES) != counts:
            fail(f"{label}: eager launches {dict(_lib.LAUNCHES)} != the "
                 f"graph's {counts}")
        reps = [res] + [eng.generate(batch, NEW_TOKENS)
                        for _ in range(REPEATS)]
        for r in reps[1:]:
            if not np.array_equal(r.tokens, toks):
                fail(f"{label}: a repeated request gave other tokens")
        runs[label] = {"ttft_ms": res.ttft_ms, "tpot_ms": res.tpot_ms,
                       "weight_bytes_fp": eng.weight_bytes_fp,
                       "weight_bytes_int8": eng.weight_bytes_int8,
                       "weight_bytes_int4": eng.weight_bytes_int4,
                       "launches": counts, "graph_replays": replays,
                       "graph": {"capture_s": graph.capture_s,
                                 "n_nodes": graph.n_nodes,
                                 "launches_per_replay": graph.launches},
                       "eager_generate_py": {"ttft_ms": eager.ttft_ms,
                                             "tpot_ms": eager.tpot_ms},
                       # tokens/s: the request's tokens over its wall
                       "repeats": quartiles(
                           ttft_ms=[r.ttft_ms for r in reps],
                           tpot_ms=[r.tpot_ms for r in reps],
                           tokens_per_s=[
                               B * NEW_TOKENS * 1e3
                               / (r.ttft_ms + r.tpot_ms * (NEW_TOKENS - 1))
                               for r in reps]),
                       "device_busy": decode_busy(eng, batch),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        busy = runs[label]["device_busy"]
        tpot50 = runs[label]["repeats"]["tpot_ms"][1]
        for d in (busy, busy["eager"]):
            if not isinstance(d["device_ms_per_step"], str):
                # kernel time per step over the unprofiled time per token
                d["busy_share_of_tpot"] = d["device_ms_per_step"] / tpot50
        log(f"{label}: B={B} prompt={PROMPT} new={NEW_TOKENS} m={CUSHION} "
            f"TTFT={res.ttft_ms:.2f} ms TPOT={res.tpot_ms:.3f} ms "
            f"({REPEATS + 1} runs: TPOT quartiles "
            f"{runs[label]['repeats']['tpot_ms']}, tokens/s "
            f"{runs[label]['repeats']['tokens_per_s']}; eager "
            f"per-token loop TPOT {eager.tpot_ms:.3f} ms) weights "
            f"fp={eng.weight_bytes_fp} B int8={eng.weight_bytes_int8} B "
            f"int4={eng.weight_bytes_int4} B launches={counts} graph: "
            f"{replays} replays, captured in {graph.capture_s:.3f} s, "
            f"{graph.n_nodes} nodes; decode device ms per step "
            f"{busy['device_ms_per_step']} (eager step "
            f"{busy['eager']['device_ms_per_step']}), busy share "
            f"{busy.get('busy_share_of_tpot')}")
        engines[label] = eng

    def counters_zero(label, graphs):
        """Every split-KV merge counter and split-K workspace, those of the
        eager streams and those the graphs captured, is zero after the
        runs (each launch, replayed or not, leaves its own zero)."""
        bufs = [*FD.TICKETS.values(), *W8.WORKSPACE.values(),
                *(w for g in graphs for w in g.workspaces)]
        torch.cuda.synchronize()
        nz = sum(int(torch.count_nonzero(t)) for t in bufs)
        if nz:
            fail(f"{label}: {nz} nonzero merge counters or workspace "
                 f"entries after the runs")
        log(f"{label}: all {len(bufs)} merge-counter and workspace buffers "
            f"are zero")
        return len(bufs)

    record["counters_zero_main_path"] = counters_zero(
        "phase 4", [st.graph for e in engines.values()
                    for st in e.states.values()])
    main_counts = runs["w8a8_int8kv"]["launches"]
    # W4A8 packs the same sites as W8A8 at half a byte per weight
    i8, i4 = (runs["w8a8_int8kv"]["weight_bytes_int8"],
              runs["w4a8_int8kv"]["weight_bytes_int4"])
    if i4 * 2 != i8 or runs["w4a8_int8kv"]["weight_bytes_int8"]:
        fail(f"resident int4 bytes {i4} are not half the int8 bytes {i8}")
    log(f"resident weights: int4 {i4} B = int8 {i8} B / 2")
    # the tied head requantizes embed.T on every call (as the reference)
    emb_t = params.tree()["embed"]["w"].T
    record["head_requant_ms"] = timed(
        lambda: TQ.weight_quant_int(emb_t, qw8)[0].contiguous()
        .sum(0, dtype=torch.int32), iters=5)
    log(f"tied-head weight requantization per call: "
        f"{record['head_requant_ms']:.3f} ms")
    record["runs"] = runs
    record["smoothquant"] = smoothquant_step(api, params, cfg, calib, batch,
                                             cushion, qw8)
    # phase 5's card half: each engine's greedy tokens and its logits along
    # them (B = 1, a 64-token prompt, 8 tokens); the CPU half is queued
    cpu = lambda t: t.detach().cpu()       # noqa: E731
    b1 = {"tokens": batch["tokens"][:1, :64]}
    n_cmp = 8
    card_cmp, cpu_modes = {}, {}
    for label, (qcfg, kv, pre, wb) in modes.items():
        card_eng = engines[label]
        card_toks = card_eng.generate(b1, n_cmp).tokens
        card_cmp[label] = (card_toks, engine_trajectory(card_eng,
                                                        b1["tokens"],
                                                        card_toks))
        cpu_modes[label] = (qcfg, kv, pre, wb,
                            (tree_map(cpu, card_eng.scales)
                             if card_eng.scales is not None else None),
                            card_toks)
    CPU_HALVES.submit("phase 5", cpu_engine_half, {
        "cfg": cfg, "params": tree_map(cpu, params.tree()),
        "cushion": tree_map(cpu, cushion), "tokens": cpu(b1["tokens"]),
        "n_cmp": n_cmp, "modes": cpu_modes})
    phase_done("main_path")

    # 4n. the dry-run's accounting against the card, on phase 4's tree -----
    record["dryrun"] = dryrun_phase(api, engines["w8a8_int8kv"], batch,
                                    cushion)
    phase_done("dryrun")

    # 4b. the continuous path at full width -----------------------------
    N_REQ, SLOTS = 12, 4
    w8_scales = engines["w8a8_int8kv"].scales
    reqs = poisson_trace(api, 0, N_REQ, 0.0, (PROMPT, PROMPT + 8),
                         (NEW_TOKENS, NEW_TOKENS // 2))
    ce_kw = dict(n_slots=SLOTS, max_seq=PROMPT + 8 + NEW_TOKENS + 32,
                 cushion=cushion, scales=w8_scales, prequant=True)

    class FirstLogits(ContinuousEngine):
        """Keeps each request's first-token logits: those of the last
        prefill call before its admission is booked (a blocking prefill,
        or a stream's final chunk)."""
        first_logits = None

        def _prefill(self, *a, **k):
            out = super()._prefill(*a, **k)
            self._last = out[0]
            return out

        def _book_admission(self, req, slot, first, tpf):
            self.first_logits[req.uid] = self._last[0].float().cpu()
            super()._book_admission(req, slot, first, tpf)

    @torch.inference_mode()
    def pool_busy(eng, trace, steps=8):
        """Device time per decode step of a full pool (the captured step's
        replays; admissions and host work around them): kernel time from
        the profiler over ``steps`` steps once every slot decodes."""
        eng.start()
        for r in trace[:eng.n_slots]:
            if not eng.try_admit(r):
                fail("pool_busy: admission refused")
        while eng.prefilling:
            eng.step()
        eng.step()
        return profiled_steps(eng.step, steps)

    def serve(label, eng, trace, path="w8a8"):
        warm = [dataclasses.replace(r, max_new_tokens=2)
                for r in trace[:SLOTS]]
        eng.first_logits = {}
        eng.run(warm)                                # warm-up
        eng.first_logits = {}
        # the rows of every prefill call (B = 1: its tokens), which pick the
        # static quantizer's route at its 160 layer sites
        prefill_rows = []
        prefill = eng._prefill

        def rows_counted(batch, *a, **k):
            prefill_rows.append(int(batch["tokens"].numel()))
            return prefill(batch, *a, **k)

        eng._prefill = rows_counted
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.LAUNCHES)
        replays = _lib.COUNTERS["graph_replays"]
        del eng._prefill
        st = eng.stats
        if replays != st.steps:
            fail(f"{label}: {replays} graph replays, {st.steps} steps")
        if [o.uid for o in outs] != [r.uid for r in trace]:
            fail(f"{label}: finished {[o.uid for o in outs]}")
        for o, r in zip(outs, trace):
            if o.tokens.shape != (r.max_new_tokens,) or o.tokens.min() < 0 \
                    or o.tokens.max() >= V:
                fail(f"{label}: request {o.uid} tokens {o.tokens.shape}")
        # every prompt here streams when chunking is on (512 > 256), so
        # each prefill call is one chunk, else one admission
        prefills = st.prefill_chunks if eng.chunk_tokens else st.admitted
        passes = st.steps + prefills
        if len(prefill_rows) != prefills:
            fail(f"{label}: {len(prefill_rows)} prefill calls, stats count "
                 f"{prefills}")
        # 161 quantized sites per pass (160 qlinear and the head); under
        # W4A8 the tied head stays W8A8. The static quantizer: standalone
        # at the 160 layer sites of a prefill call above 16 rows, fused at
        # those of a shorter call, at every prefill's head (its last
        # position, M = 1) and at all 161 sites of every decode step
        # (M = SLOTS)
        long_ = sum(r > 16 for r in prefill_rows)
        static = path != "ptoken"
        expect = {**zero_counts,
                  "w8a8_matmul": {"w8a8": 161 * passes,
                                  "w4a8": passes}.get(path, 0),
                  "w4a8_matmul": 160 * passes if path == "w4a8" else 0,
                  "act_quant_static": 160 * long_ if static else 0,
                  "act_quant_static_fused": (
                      160 * (prefills - long_) + prefills + 161 * st.steps
                      if static else 0),
                  "act_quant_ptoken": 161 * passes if path == "ptoken" else 0,
                  "flash_attention": cfg.n_layers * prefills,
                  "flash_decode": 0 if eng.paged else cfg.n_layers * st.steps,
                  "flash_decode_paged": (cfg.n_layers * st.steps if eng.paged
                                         else 0)}
        for name, n in expect.items():
            if counts[name] != n:
                fail(f"{label}: {name} launched {counts[name]} times, "
                     f"expected {n}")
        ttft = np.asarray([o.ttft_ms for o in outs])
        tpot = np.asarray([o.tpot_ms for o in outs])
        total = sum(len(o.tokens) for o in outs)
        span = max(o.finished_s for o in outs)
        res = {"wall_s": wall, "tokens": total, "tokens_per_s": total / span,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_p99": float(np.percentile(ttft, 99)),
               "tpot_ms_p50": float(np.percentile(tpot, 50)),
               "tpot_ms_p99": float(np.percentile(tpot, 99)),
               "launches": counts, "graph_replays": replays,
               "graph": {"capture_s": eng.graph.capture_s,
                         "n_nodes": eng.graph.n_nodes,
                         "launches_per_replay": eng.graph.launches},
               "stats": st.as_dict(),
               "prefill_rows": prefill_rows,
               "slots": [o.slot for o in outs]}
        # REPEATS more runs of the trace: the same tokens, and each run's
        # TTFT / TPOT p50 and tokens/s for the quartiles
        rep = [(res["ttft_ms_p50"], res["tpot_ms_p50"],
                res["tokens_per_s"])]
        for _ in range(REPEATS):
            again = eng.run(trace)
            for o, o2 in zip(outs, again):
                if not np.array_equal(o.tokens, o2.tokens):
                    fail(f"{label}: a repeated run gave other tokens")
            rep.append((float(np.median([o.ttft_ms for o in again])),
                        float(np.median([o.tpot_ms for o in again])),
                        sum(len(o.tokens) for o in again)
                        / max(o.finished_s for o in again)))
        res["repeats"] = quartiles(ttft_ms_p50=[r[0] for r in rep],
                                   tpot_ms_p50=[r[1] for r in rep],
                                   tokens_per_s=[r[2] for r in rep])
        res["device_busy"] = pool_busy(eng, trace)     # resets the stats
        busy = res["device_busy"]["device_ms_per_step"]
        if not isinstance(busy, str):
            res["device_busy"]["busy_share_of_tpot"] = \
                busy / res["repeats"]["tpot_ms_p50"][1]
        sd = res["stats"]
        log(f"{label}: {len(outs)} requests, {total} tokens in {wall:.2f} s "
            f"({res['tokens_per_s']:.1f} tok/s), TTFT p50/p99 "
            f"{res['ttft_ms_p50']:.2f}/{res['ttft_ms_p99']:.2f} ms, TPOT "
            f"p50/p99 {res['tpot_ms_p50']:.2f}/{res['tpot_ms_p99']:.2f} ms, "
            f"occupancy {sd['occupancy']:.3f}, steps {sd['steps']}, "
            f"pool_bytes {sd['pool_bytes']}, device ms per decode step "
            f"{res['device_busy']['device_ms_per_step']}, prefix hits/misses "
            f"{sd['prefix_hits']}/{sd['prefix_misses']}, chunks "
            f"{sd['prefill_chunks']}, page-table syncs "
            f"{sd['page_table_syncs']}, launches {counts}, {replays} graph "
            f"replays (captured in {eng.graph.capture_s:.3f} s, "
            f"{eng.graph.n_nodes} nodes); {REPEATS + 1} runs: TPOT p50 "
            f"quartiles {res['repeats']['tpot_ms_p50']}, tokens/s "
            f"{res['repeats']['tokens_per_s']}; busy share "
            f"{res['device_busy'].get('busy_share_of_tpot')}")
        return outs, res

    cruns = {}
    eng_a = ContinuousEngine(api, params, qw8, kv_dtype="int8", **ce_kw)
    outs_a, cruns["a_contiguous_int8"] = serve("(a) contiguous int8 pool",
                                              eng_a, reqs)
    eng_b = ContinuousEngine(api, params, qw8, kv_dtype="int8", paged=True,
                             page_size=PS, **ce_kw)
    outs_b, cruns["b_paged_int8"] = serve("(b) paged int8 pool", eng_b, reqs)
    for oa, ob in zip(outs_a, outs_b):
        if not np.array_equal(oa.tokens, ob.tokens) or oa.slot != ob.slot:
            fail(f"(b) request {oa.uid}: paged tokens differ from "
                 f"contiguous")
    # (c) the static B=1 Engine with an int8 KV cache (phase 4's engine)
    eng_c = engines["w8a8_int8kv"]
    for r, oa in zip(reqs[:SLOTS], outs_a):
        got = eng_c.generate(r.batch, r.max_new_tokens).tokens[0]
        if not np.array_equal(got, oa.tokens):
            fail(f"(c) request {r.uid}: static B=1 Engine tokens differ "
                 f"from the contiguous pool's")
    log(f"(a) == (b) for all {N_REQ} requests (tokens and slots); (c) the "
        f"static B=1 int8 Engine == (a) for requests 0-{SLOTS - 1}")
    # (e) paged int8 pool with W4A8 weights, against the static B=1 W4A8
    # Engine (phase 4's) on the first requests
    eng_e = ContinuousEngine(api, params, qw8, kv_dtype="int8", paged=True,
                             page_size=PS, weight_bits=4, **ce_kw)
    outs_e, cruns["e_paged_int8_w4a8"] = serve(
        "(e) paged int8 pool, W4A8 weights", eng_e, reqs, path="w4a8")
    if eng_e.stats.weight_bytes_int4 != i4:
        fail(f"(e) int4 bytes {eng_e.stats.weight_bytes_int4} != {i4}")
    eng_4 = engines["w4a8_int8kv"]
    for r, oe in zip(reqs[:SLOTS], outs_e):
        got = eng_4.generate(r.batch, r.max_new_tokens).tokens[0]
        if not np.array_equal(got, oe.tokens):
            fail(f"(e) request {r.uid}: static B=1 W4A8 Engine tokens differ "
                 f"from the paged W4A8 pool's")
    log(f"(e) the static B=1 W4A8 Engine == (e) for requests "
        f"0-{SLOTS - 1}")
    # (f) contiguous fp pool under ptoken_dynamic (fp weights fake-quantized
    # per call), against the static B=1 ptoken Engine (phase 4's). Prefill
    # is B=1 on both sides, so every first token must be equal; decode
    # multiplies M=4 rows where the static Engine multiplies one, through
    # cuBLAS, whose result may depend on M, and a per-token code then flips
    # on a one-ulp difference, so later tokens are compared, not gated
    eng_f = ContinuousEngine(api, params, qpt,
                             **dict(ce_kw, scales=None, prequant=False))
    outs_f, cruns["f_contiguous_fp_ptoken"] = serve(
        "(f) contiguous fp pool, ptoken_dynamic", eng_f, reqs, path="ptoken")
    eng_pt = engines["ptoken_fp"]
    same_f = []
    for r, of in zip(reqs, outs_f):
        got = eng_pt.generate(r.batch, r.max_new_tokens).tokens[0]
        if got[0] != of.tokens[0]:
            fail(f"(f) request {r.uid}: first token {of.tokens[0]} != the "
                 f"static B=1 ptoken Engine's {got[0]}")
        same_f.append(bool(np.array_equal(got, of.tokens)))
    cruns["f_contiguous_fp_ptoken"]["requests_identical_to_static"] = \
        float(np.mean(same_f))
    log(f"(f) first tokens == the static B=1 ptoken Engine's for all "
        f"{N_REQ} requests; requests identical throughout "
        f"{float(np.mean(same_f)):.3f} (printed, not gated)")
    # (d) paged fp pool, prefix cache + 256-token chunks, shared stem
    STEM = 256
    reqs_d = [dataclasses.replace(r, batch={"tokens": r.batch["tokens"]
                                            .clone()}) for r in reqs]
    for r in reqs_d:
        r.batch["tokens"][:, :STEM] = reqs[0].batch["tokens"][:, :STEM]
    eng_d0 = FirstLogits(api, params, qw8, paged=True, page_size=PS,
                         **ce_kw)
    outs_d0, cruns["d0_paged_fp_blocking"] = serve(
        "(d0) paged fp pool, blocking, no prefix cache", eng_d0, reqs_d)
    eng_d = FirstLogits(api, params, qw8, paged=True, page_size=PS,
                        prefix_cache=True, chunk_tokens=256, **ce_kw)
    outs_d, cruns["d_paged_fp_prefix_chunked"] = serve(
        "(d) paged fp pool, prefix cache, 256-token chunks", eng_d, reqs_d)
    st_d = cruns["d_paged_fp_prefix_chunked"]["stats"]
    if st_d["prefix_hits"] <= 0 or st_d["prefill_chunks"] <= 0:
        fail(f"(d) prefix hits {st_d['prefix_hits']}, chunks "
             f"{st_d['prefill_chunks']}")
    l0 = torch.stack([eng_d0.first_logits[r.uid] for r in reqs_d])
    l1 = torch.stack([eng_d.first_logits[r.uid] for r in reqs_d])
    err = (l1 - l0).abs()
    agree = float(np.mean([np.array_equal(a.tokens, b.tokens)
                           for a, b in zip(outs_d0, outs_d)]))
    first_agree = float(np.mean([a.tokens[0] == b.tokens[0]
                                 for a, b in zip(outs_d0, outs_d)]))
    max_tol, mean_tol = LOGIT_TOL["w8a8_int8kv"]
    record["prefix_chunked_vs_blocking"] = {
        "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
        "max_abs_logit": float(l0.abs().max()), "tol_max": max_tol,
        "tol_mean": mean_tol, "requests_identical": agree,
        "first_token_agreement": first_agree}
    log(f"(d) vs (d0) first-token logits: max |err| {float(err.max()):.4g} "
        f"(tolerance {max_tol}), mean {float(err.mean()):.4g} (tolerance "
        f"{mean_tol}); requests with identical tokens {agree:.3f}, first "
        f"tokens {first_agree:.3f} (printed, not gated: chunk and tail "
        f"prefill reduce attention in another order)")
    if float(err.max()) > max_tol or float(err.mean()) > mean_tol:
        fail("(d) first-token logits beyond the stated tolerance")
    record["continuous"] = cruns
    record["counters_zero_continuous"] = counters_zero(
        "phase 4b", [e.graph for e in (eng_a, eng_b, eng_e, eng_f, eng_d0,
                                       eng_d)]
        + [st.graph for e in engines.values() for st in e.states.values()])
    phase_done("continuous")

    # 4c. the method: search, tune, the artifact ------------------------
    method = method_phase(api, params, cfg, corpus, calib, batch, dev, qw8)
    record["method"] = method
    phase_done("method")

    # 4d. the replica router at full width ------------------------------
    record["router"] = router_phase(api, params, qw8, cushion, w8_scales,
                                    reqs, outs_b, PS, zero_counts,
                                    counters_zero, profiled_steps)
    phase_done("router")

    # 4e. the MoE family at full width ----------------------------------
    record["moe"] = moe_phase(dev, corpus, calib, batch, PS, zero_counts,
                              counters_zero, timed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("moe")

    # 4o. stablelm-3b (head_dim 80) at full width, 4 of its layers ------
    record["stablelm"].update(stablelm_phase(dev, zero_counts,
                                             counters_zero))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("stablelm")

    # 4f. the VLM at full width -----------------------------------------
    record["vlm"] = vlm_phase(dev, zero_counts, counters_zero, timed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("vlm")

    # 4g. the Jamba hybrid at full width, one period --------------------
    record["hybrid"] = hybrid_phase(dev, zero_counts, counters_zero, timed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("hybrid")

    # 4h. the encoder-decoder at full width and depth -------------------
    record["encdec"] = encdec_phase(dev, zero_counts, counters_zero, timed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("encdec")

    # 4i. the xLSTM at full width and depth -------------------------------
    record["xlstm"] = xlstm_phase(dev, zero_counts, counters_zero, timed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("xlstm")

    # 4j. one-card training at full width and depth ---------------------
    record["train"] = train_phase(dev, corpus, timed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("train")

    # 4k. tensor-parallel serving, deepseek-67b at full width ------------
    record["tp"] = tp_phase(dev, timed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("tp")

    # 4l. data-parallel tuning and training, smollm-360m on two ranks ---
    record["dp"] = dp_phase(dev, corpus, timed)
    record["tp_train"] = record["dp"].pop("tp_train")
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("dp")

    # 4m. the router over tensor-parallel replicas -----------------------
    record["router_tp"] = router_tp_phase(dev, api, cushion, w8_scales, PS)
    phase_done("router_tp")

    # 5. card vs the port's CPU engine on the same weights --------------
    # the card halves ran in phase 4 (and the families' in theirs); the CPU
    # halves in the worker beside the card phases: every comparison now
    CPU_HALVES.join()
    got = CPU_HALVES.result("phase 5")
    record["card_vs_cpu"] = {}
    for label, (card_toks, lc) in card_cmp.items():
        lp = torch.from_numpy(got[label][0])
        cpu_toks = got[label][1]
        err = (lc - lp).abs()
        agree = float((card_toks == cpu_toks).mean())
        # the CPU's top-1 minus top-2 logit at the first token: below the
        # error there, the two greedy runs may part at once (random weights)
        top2 = lp[0].topk(2, dim=-1).values
        max_tol, mean_tol = LOGIT_TOL[label]
        cmp = {"max_abs_err": float(err.max()),
               "mean_abs_err": float(err.mean()),
               "max_abs_logit": float(lp.abs().max()),
               "greedy_agreement": agree,
               "first_token_margin": float((top2[..., 0] - top2[..., 1])
                                           .min()),
               "first_token_max_abs_err": float(err[0].max()),
               "tol_max": max_tol, "tol_mean": mean_tol}
        record["card_vs_cpu"][label] = cmp
        log(f"card vs CPU, {label} (B=1, prompt 64, {n_cmp} tokens): logits "
            f"max |err| {cmp['max_abs_err']:.4g} (tolerance {max_tol}), mean "
            f"{cmp['mean_abs_err']:.4g} (tolerance {mean_tol}), max |logit| "
            f"{cmp['max_abs_logit']:.3g}; greedy agreement {agree:.3f} "
            f"(first token: top-2 margin {cmp['first_token_margin']:.4g}, "
            f"max |err| {cmp['first_token_max_abs_err']:.4g})")
    for label, cmp in record["card_vs_cpu"].items():
        if cmp["max_abs_err"] > cmp["tol_max"] \
                or cmp["mean_abs_err"] > cmp["tol_mean"]:
            fail(f"{label}: card and CPU logits differ beyond the stated "
                 f"tolerance")
    record["cpu_halves"] = {"threads": CPU_HALVES.threads,
                            "seconds": CPU_HALVES.seconds}
    CPU_HALVES.close()
    phase_done("card_vs_cpu")

    # 6. the kernels line -----------------------------------------------
    # launches: the continuous path, runs (a) and (b) of phase 4b, for the
    # W8A8 path's five kernels; run (e) for w4a8_matmul; the static
    # ptoken_dynamic run (phase 4) for act_quant_ptoken, its only path. The
    # static W8A8 / W4A8 counts ride along as static_launches
    cont_counts = {k: cruns["a_contiguous_int8"]["launches"][k]
                   + cruns["b_paged_int8"]["launches"][k]
                   for k in _lib.LAUNCHES}

    def layer_sum(idx, M):
        return L * sum(per_layer[s] * w8[(s, M)][idx] for s in per_layer)

    def step_sum(idx, M):
        return layer_sum(idx, M) + w8[("head", B)][idx]

    def aq_sum(idx, M, table=aq):
        if any(table[k][idx] is None for k in table):
            return None
        return (L * (4 * table[(D, M)][idx] + table[(F_, M)][idx])
                + table[(D, B)][idx])

    def w4_sum(idx, M):
        return L * sum(per_layer[s] * w4[(s, M)][idx] for s in per_layer)

    def fused_sum(table, idx):
        """One decode step of the quantizing int matmuls (M = B): the 160
        layer sites, and the head where the table has it (w8a8)."""
        v = L * sum(per_layer[s] * table[s][idx] for s in per_layer)
        return v + (table["head"][idx] if "head" in table else 0.0)

    def aq_prefill(idx):
        """act_quant_static over one prefill's 160 layer sites."""
        a, b = aq[(D, B * PROMPT)][idx], aq[(F_, B * PROMPT)][idx]
        return None if a is None or b is None else L * (4 * a + b)

    pt_bf = {(Dd, M): v for (Dd, M, mode), v in pt.items() if mode == "bf16"}
    w4_launches = cruns["e_paged_int8_w4a8"]["launches"]

    kernels = [
        {"name": "w8a8_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/w8a8_matmul.cu",
         "replaces": "src/repro/kernels/w8a8_matmul.py:42",
         "launches": cont_counts["w8a8_matmul"],
         "static_launches": main_counts["w8a8_matmul"],
         "max_abs_err": 0.0,
         "unit": "one decode step (161 calls, M=4)",
         "ms": step_sum(0, B), "plain_ms": step_sum(1, B),
         "bound_ms": step_sum(2, B), "bound_by": "bytes",
         "library_ms": step_sum(3, B),
         "library_of": "torch._int_mm, x zero-padded to 32 rows (it takes "
                       "M > 16; the copy outside the timed window); "
                       "prefill: torch._int_mm",
         "prefill_ms": layer_sum(0, B * PROMPT),
         "prefill_plain_ms": layer_sum(1, B * PROMPT),
         "prefill_bound_ms": layer_sum(2, B * PROMPT),
         "prefill_library_ms": layer_sum(3, B * PROMPT),
         "prefill_library_kmajor_ms": layer_sum(4, B * PROMPT),
         "prefill_unit": f"one prefill ({L * 5} calls at the layer sites, "
                         f"M={B * PROMPT})",
         "fused_unit": "one decode step (161 calls, M=4) on bf16 x, "
                       "quantized in the staging (the main path)",
         "fused_ms": fused_sum(fz8, 0), "fused_plain_ms": fused_sum(fz8, 2),
         "fused_bound_ms": fused_sum(fz8, 3),
         "unfused_ms": fused_sum(fz8, 1),
         "unfused_of": "act_quant_static + w8a8_matmul on the codes"},
        {"name": "act_quant_static", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/act_quant.cu",
         "replaces": "src/repro/kernels/act_quant.py:31",
         "launches": cont_counts["act_quant_static"],
         "static_launches": main_counts["act_quant_static"],
         "fused_launches": cont_counts["act_quant_static_fused"],
         "static_fused_launches": main_counts["act_quant_static_fused"],
         "fused_launches_are": "quantizations inside w8a8_matmul / "
                               "w4a8_matmul launches (M <= 16), not "
                               "launches of their own",
         "max_abs_err": 0.0,
         "unit": f"one prefill ({L * 5} calls at the layer sites, "
                 f"M={B * PROMPT}); at decode it runs fused",
         "ms": aq_prefill(0), "plain_ms": aq_prefill(1),
         "bound_ms": aq_prefill(2), "bound_by": "bytes",
         "library_ms": aq_prefill(3),
         "library_of": "torch.quantize_per_tensor to quint8 (no -128 "
                       "offset) of an f32 copy",
         "floor_ms": floor_ms,
         "ms_over_floor": aq_prefill(0) - L * 5 * floor_ms,
         "decode_unit": "one decode step (161 sites, M=4)",
         "decode_standalone_ms": aq_sum(0, B),
         "decode_standalone_bound_ms": aq_sum(2, B),
         "decode_standalone_library_ms": aq_sum(3, B),
         "decode_fused_extra_ms": fused_sum(fz8, 0) - step_sum(0, B),
         "decode_fused_extra_of": "w8a8_matmul on bf16 x (quantized in "
                                  "its staging) minus w8a8_matmul on int8 "
                                  "codes, summed over the step",
         "w4a8_decode_fused_extra_ms": fused_sum(fz4, 0) - w4_sum(0, B)},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:70",
         "launches": cont_counts["flash_attention"],
         "static_launches": main_counts["flash_attention"],
         "max_abs_err": fa_err,
         "unit": f"one prefill ({L} calls, B={B}, S={PROMPT})",
         "ms": L * fa_ms, "plain_ms": L * fa_pms, "bound_ms": L * fa_bms,
         "bound_by": fa_by,
         "library_ms": None if fa_lib is None else L * fa_lib,
         "long_unit": "one call, B=1, S=2048, m=4",
         "long_ms": fa_long[0], "long_plain_ms": fa_long[1],
         "long_bound_ms": fa_long[2], "long_library_ms": fa_long[5],
         "method_launches": {
             "search": method["search"]["launches"]["flash_attention"],
             "tune": method["tune"]["launches"]["flash_attention"]},
         "masked_unit": f"one call with the live-length mask, the search's "
                        f"scoring shape (B={SEARCH_CHUNK}, "
                        f"S={SAMPLE_LEN + 1}, m={MAX_PREFIX}, 2 live)",
         "masked_ms": fa_masked[0], "masked_plain_ms": fa_masked[1],
         "masked_bound_ms": fa_masked[2], "masked_bound_by": fa_masked[3],
         "masked_max_abs_err": fa_masked[4],
         "masked_library_ms": fa_masked[5],
         "noncausal": fa_nc,
         "noncausal_of": "the non-causal mode at whisper-base's shapes "
                         "(8 heads of 64, bf16): its encoder, its "
                         "cross-attention at prefill and at decode; "
                         "library_ms: scaled_dot_product_attention, no "
                         "mask"},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:163",
         "launches": cont_counts["flash_decode"],
         "static_launches": main_counts["flash_decode"],
         "max_abs_err": max(fd["int8"][4], fd["fp"][4], err_bk),
         "unit": f"one decode step ({L} calls, int8 KV, (B, K) scales, "
                 f"pos={pos_v})",
         "ms": L * cont["flash_decode_BK"][0],
         "plain_ms": L * cont["flash_decode_BK"][1],
         "bound_ms": L * cont["flash_decode_BK"][2],
         "bound_by": cont["flash_decode_BK"][3],
         "static_ms": L * fd["int8"][0], "fp_ms": L * fd["fp"][0],
         "library_ms": None if fd["fp"][5] is None else L * fd["fp"][5],
         "library_of": "fp mode (fp_ms): scaled_dot_product_attention",
         "long_unit": f"one call, B={B}, pos {PL} in a {SL}-position cache",
         "long_ms": fd_long["int8_BK"][0],
         "long_plain_ms": fd_long["int8_BK"][1],
         "long_bound_ms": fd_long["int8_BK"][2],
         "long_fp_ms": fd_long["fp"][0],
         "long_library_ms": fd_long["fp"][5]},
        {"name": "flash_decode_paged", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:264",
         "launches": cont_counts["flash_decode_paged"],
         "max_abs_err": max(paged_err.values()),
         "unit": f"one decode step ({L} calls, int8 pages, (B, K) scales, "
                 f"page size {PS}, pos={pos_v})",
         "ms": L * cont["flash_decode_paged_BK"][0],
         "plain_ms": L * cont["flash_decode_paged_BK"][1],
         "bound_ms": L * cont["flash_decode_paged_BK"][2],
         "bound_by": cont["flash_decode_paged_BK"][3],
         "fp_ms": L * cont["flash_decode_paged_fp"][0],
         "library_ms": None},
        {"name": "w4a8_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/w4a8_matmul.cu",
         "replaces": "src/repro/kernels/w4a8_matmul.py:60",
         "launches": w4_launches["w4a8_matmul"],
         "launches_from": "run (e), paged int8 pool, W4A8",
         "static_launches": runs["w4a8_int8kv"]["launches"]["w4a8_matmul"],
         "max_abs_err": 0.0,
         "unit": "one decode step (160 calls, M=4)",
         "ms": w4_sum(0, B), "plain_ms": w4_sum(1, B),
         "bound_ms": w4_sum(2, B), "bound_by": "bytes",
         "library_ms": None,
         "library_of": "none: no PyTorch call multiplies int8 by packed "
                       "int4 with group scales",
         "w8a8_ms_same_sites": L * sum(per_layer[s] * w8[(s, B)][0]
                                       for s in per_layer),
         "prefill_ms": w4_sum(0, B * PROMPT),
         "prefill_plain_ms": w4_sum(1, B * PROMPT),
         "prefill_bound_ms": w4_sum(2, B * PROMPT),
         "w8a8_prefill_ms_same_sites": layer_sum(0, B * PROMPT),
         "fused_unit": "one decode step (160 calls, M=4) on bf16 x, "
                       "quantized in the staging (the main path)",
         "fused_ms": fused_sum(fz4, 0), "fused_plain_ms": fused_sum(fz4, 2),
         "fused_bound_ms": fused_sum(fz4, 3),
         "unfused_ms": fused_sum(fz4, 1),
         "unfused_of": "act_quant_static + w4a8_matmul on the codes"},
        {"name": "act_quant_ptoken", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/act_quant.cu",
         "replaces": "src/repro/kernels/act_quant.py:65",
         "launches": runs["ptoken_fp"]["launches"]["act_quant_ptoken"],
         "launches_from": "static ptoken_dynamic run, B=4",
         "continuous_launches": cruns["f_contiguous_fp_ptoken"]["launches"][
             "act_quant_ptoken"],
         "max_abs_err": 0.0,
         "unit": "one decode step (161 calls, M=4, bf16 mode), rows "
                 "with an outlier and no all-zero row",
         "ms": aq_sum(0, B, pt_bf), "plain_ms": aq_sum(1, B, pt_bf),
         "zero_row_ms": aq_sum(3, B, pt_bf),
         "zero_row_of": "the same step with row 1 of every call all zero",
         "bound_ms": aq_sum(2, B, pt_bf), "bound_by": "bytes",
         "library_ms": None,
         "library_of": "none: no single PyTorch call quantizes per row",
         "prefill_ms": aq_sum(0, B * PROMPT, pt_bf),
         "prefill_bound_ms": aq_sum(2, B * PROMPT, pt_bf),
         "floor_ms": floor_ms,
         "ms_over_floor": aq_sum(0, B, pt_bf) - 161 * floor_ms,
         "prefill_ms_over_floor": aq_sum(0, B * PROMPT, pt_bf)
         - 161 * floor_ms},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "none: no Pallas kernel; the reference differentiates "
                     "its jnp attention (src/repro/models/common.py:210 "
                     "flash_attention_jnp) with jax.grad",
         "launches": method["tune"]["launches"]["flash_attention_bwd"],
         "launches_from": f"phase 4c's prefix_tune, {TUNE_STEPS} steps "
                          f"({L} a step)",
         "max_abs_err": max(v[4] for v in fa_bwd.values()),
         "unit": f"one tuning step ({L} calls, B={TUNE_B}, S={TUNE_S}, "
                 f"m={MAX_PREFIX}, bf16)",
         "ms": L * fa_bwd[("bfloat16", MAX_PREFIX)][0],
         "plain_ms": L * fa_bwd[("bfloat16", MAX_PREFIX)][1],
         "bound_ms": L * fa_bwd[("bfloat16", MAX_PREFIX)][2],
         "bound_by": fa_bwd[("bfloat16", MAX_PREFIX)][3],
         "library_ms": (None if fa_bwd[("bfloat16", MAX_PREFIX)][5] is None
                        else L * fa_bwd[("bfloat16", MAX_PREFIX)][5]),
         "library_of": "scaled_dot_product_attention forward + backward "
                       "with the same boolean mask, against fwd_bwd_ms",
         "fwd_bwd_ms": L * fa_bwd[("bfloat16", MAX_PREFIX)][6],
         "fwd_bwd_of": "flash_attention (writing the log-sum-exp) + "
                       "flash_attention_bwd through autograd",
         "dead_rows_ms": L * fa_bwd[("bfloat16", 1)][0],
         "f32_ms": L * fa_bwd[("float32", MAX_PREFIX)][0],
         "f32_bound_ms": L * fa_bwd[("float32", MAX_PREFIX)][2],
         "noncausal": fa_nc_bwd,
         "noncausal_launches": record["encdec"]["launches"].get(
             "flash_attention_bwd", 0),
         "noncausal_launches_from": "phase 4h's prefix_tune (whisper-base: "
                                    "half of them non-causal, the "
                                    "cross-attention)"},
    ]
    for kk in kernels:
        if kk["launches"] <= 0:
            fail(f"{kk['name']} not launched on its path")
        if record["router"]["launches"].get(kk["name"]):
            kk["router_launches"] = record["router"]["launches"][kk["name"]]
        # the kernel's launches and rows at olmoe's (phase 4e), internvl2's
        # (4f), jamba's (4g), whisper-base's (4h) and xlstm-350m's (4i)
        # shapes, beside smollm's; smollm's training run (4j); rank 0 of
        # deepseek-67b's tensor-parallel runs (4k)
        for tag in ("moe", "stablelm", "vlm", "hybrid", "encdec", "xlstm",
                    "train", "tp", "dp", "router_tp", "tp_train"):
            if record[tag]["launches"].get(kk["name"]):
                kk[f"{tag}_launches"] = record[tag]["launches"][kk["name"]]
            kk.update({f"{tag}_{k_}": v for k_, v in
                       record[tag]["kernels"].get(kk["name"], {}).items()})
        # rank 0 of phase 4k's MoE, VLM and hybrid runs
        for fam, counts in record["tp"]["family_launches"].items():
            if counts.get(kk["name"]):
                kk[f"tp_{fam}_launches"] = counts[kk["name"]]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"done in {record['seconds']:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
