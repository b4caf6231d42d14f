#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the serve and training paths from the sources in
the checkout, holds each against its plain PyTorch version on the card,
drives the port's serve engine (on one shard, and on a slots mesh of two
shards of the one card) and its trainer at the full width of
``llama3.2-3b``, its trainer at that of the encoder-only
``hubert-xlarge`` (with checkpoint and exact resume) and of
``internvl2-26b`` (4 of its 48 layers), its serve engine at the full width of the MLA model
``minicpm3-4b``, of the MoE model ``phi3.5-moe-42b-a6.6b`` (16 of its
32 layers: the whole model does not fit the card), of the SSM
``falcon-mamba-7b``, of the hybrid ``zamba2-1.2b`` and of the QKV-bias
``glm4-9b`` (random weights from a seed), drives the autotune tier
(``repro_torch.tune``: the serve CLI's ``--burst-smoke``, the
virtual-clock replay and the knob sweep) at ``llama3.2-3b``'s width, and
times each kernel beside its bound, its plain version and a library
call.  Raises at the first
failed check, so any failure exits non-zero; with no CUDA device, or
outside a checkout of the repository, it exits non-zero before printing
any result.

Phases:
  1. the card (nvidia-smi name and power limit) and versions; TF32 off
  2. build the kernels (one nvcc per source, started together; each
     source's build time)
  3. moa_reduce against moa_reduce_plain, torch.equal with the signs of
     zero, at the kernel-test shapes and dtypes (N = 2 to 300, so every
     split of the tree across lanes) and at the serve path's own shapes
     (phase 6's paged geometry and G3's generate over pages of 32), and
     the MoE top-k combine's columns at N = 1 and 2, bf16 operands and
     fp32 sums (phi3.5-moe decode, prefill piece and chain verify,
     llama4-scout decode), and at glm4-9b's serve shapes under phase 6's
     geometry (32 query heads: prefill o (16, 1048576), decode o (16,
     16384), and the chain and tree verify shapes)
  4. flash attention: the forward kernel against flash_attention_plain
     (2e-5 fp32; bf16 2e-2 and relative norm error 1e-2) and the dq and
     dk/dv kernels against flash_attention_plain_bwd and against autograd
     through the plain forward (fp32 rtol 1e-4 atol 1e-5; bf16 relative
     norm error 1e-2), causal and not, at the kernel-test shapes, bf16
     shapes with a ragged S, and the training path's; two forward calls
     at the path shape give torch.equal o and lse, two backward calls
     torch.equal dq, delta, dk and dv; and at zamba2's shared-block shape,
     (2, 2048, 32, 64) bf16 (32 query and 32 KV heads of 64), at
     hubert-xlarge's (2, 2048, 16, 16, 80) bf16 (head dim 80, zero-padded
     to 128 by the wrappers), at internvl2-26b's (2, 2048, 48, 8, 128),
     at glm4-9b's (2, 2048, 32, 2, 128) bf16 (a GQA group of 16), at
     qwen2.5-14b's (2, 2048, 40, 8, 128) bf16 (a group of 5) and at one
     small fp32 shape of group 16
  5. serve, reduced-config parity: the engine on CUDA against the engine
     on CPU, same weights: greedy tokens equal, decode logits within 1e-3;
     then the traffic of phases A-C cut to the reduced fp32 config, CUDA
     against CPU: tokens and every prefix, dedup, session, SLO, shed,
     ladder and eviction counter equal, decode logits within 1e-3; then
     the sequential engine and chain (spec_k 4), tree, auto and random
     draft-head speculative engines on repeated passages, CUDA against
     CPU: tokens and every counter (the spec_* ones too) equal; whether
     each CUDA spec run's tokens equal the CUDA sequential run's is
     printed; then int8 and int4 pools and sampled requests (temperature
     0.8, top-k 40, top-p 0.9, a seed each), each sequential and chain
     (spec_k 4), CUDA against CPU: tokens and every counter equal; and
     sample_tokens on one seeded (64, 128256) fp32 logits tensor, CUDA
     against CPU: equal tokens, with threefry's bits and uniforms bit for
     bit; then contiguous slots (paged_kv=False) on the reduced llama,
     CUDA against CPU: sequential, prefix-cache warm (copy_slot hits),
     chain (spec_k 4), tree and sampled over slot rows read as pages of
     16, and a page-0 engine (one softmax): tokens and every counter
     equal, decode logits within 1e-3, moa_reduce launched 2 * layers per
     dispatch (0 at page 0); then the reduced fp32 minicpm3-4b engine
     (MLA's latent pools), CUDA against CPU on the same weights:
     sequential, prefix-cache warm, chain (spec_k 4), tree, int8 and int4
     pools, sampled (temperature 0.8, top-k 40), and contiguous,
     contiguous prefix warm and contiguous tree: tokens and every counter
     equal, decode logits within 1e-3, no kernel launched; then the
     reduced fp32 phi3.5-moe and llama4-scout engines, each drop-free
     and at capacity factor 1.0 (a dispatch's rows compete for expert
     places), 6 slots for 5 requests: sequential, chain (spec_k 4), int8,
     sampled and contiguous, CUDA against CPU: tokens and every counter
     equal, decode logits within 1e-3, moa_reduce launched 3 * layers a
     dispatch (2 page combines and the expert combine); and one reduced
     phi3.5-moe train_loss at capacity 1.0, its loss and every gradient
     CUDA against CPU within 1e-4 (the combine's backward, MoaReduce);
     then the reduced fp32 falcon-mamba-7b and zamba2-1.2b with a tail (5
     layers: 2 groups of 2 and 1, a random LoRA lora_b): resolve() turns
     paging, speculation, the prefix cache and KV quantization off;
     sequential and sampled engines (2 slots, 5 requests) and generate,
     CUDA against CPU: tokens and every counter equal, decode logits
     within 1e-3, no kernel launched; warmup() on a live CUDA engine
     leaves every state leaf and counter as it was; one train_loss and
     every gradient CUDA against CPU within 1e-4, the hybrid's shared
     attention through the flash kernels (each launched once a group);
     then the reduced fp32 glm4-9b (32/2 heads) and qwen2.5-14b (20/4
     heads) with QKV biases drawn N(0, 0.5): sequential, prefix warm,
     chain (spec_k 4) and contiguous, CUDA against CPU: tokens and every
     counter equal, decode logits within 1e-3, moa_reduce launched 2 *
     layers a dispatch; then the port's replay_open_loop on the reduced
     llama, CUDA against CPU: the JAX package's canned burst (18
     arrivals, seed 11, spec_k 3) with the degrade ladder, and 2
     conversations x 3 turns: outputs, the whole trajectory (virtual
     time, steps, SLO, shed and goodput tallies) and every counter equal
  6. serve, full width: llama3.2-3b, 28 layers, bf16, 8 greedy requests
     of 128 to 1024 prompt tokens and 32 new tokens on 4 slots, prefix
     cache off (what PRs 11-17 measured); every request retires with 32
     tokens, no logit is NaN, and moa_reduce ran exactly 2 * layers times
     per dispatch
  G. contiguous slots, full width on phase 6's weights, each engine
     warmed up first (warmup() moves no counter): G1, phase 6's traffic
     and geometry on contiguous slots read as pages of 128 (split-K over
     dense rows), tokens equal phase 6's paged tokens and moa_reduce
     launched 2 * layers * (prefill dispatches + decode steps); G2, the
     same at page 0 (one softmax), moa_reduce launched 0 times, its token
     agreement with G1 printed; G3, generate (one decode_step a position,
     a 0-d index) on 4 prompts of 128 tokens x 32 new over pages of 32
     (auto_page_size(160)), moa_reduce launched 2 * layers * 160
     dispatches, and an engine on the same prompts: prefill and decode
     tok/s and the token agreement printed
  K. mesh-sharded serve on phase 6's weights, two shards on the one card
     (devices [cuda:0, cuda:0]): K1, phase 6's traffic and geometry on 2
     shards of 2 slots (prefix cache off): every request retires, no
     page left, no row ever maps a page outside its shard's block (held
     after every step), moa_reduce launched 2 * layers * (prefill
     dispatches + the shards' decode dispatches), and the tokens equal
     phase 6's or part from them only at a near tie (within 2 bf16 ulp
     in divergence's teacher-forced pass: a shard's dispatch has 2 lanes
     where phase 6's has 4); lane steps a shard, ms a step and peak
     memory printed; K2, the prefix cache on over two shared prefixes,
     one placed on each shard: both re-admissions hit on their own shard,
     and a third request whose prefix is resident only on the other
     shard misses (the one-shard trie would have matched it); K3, the
     reduced fp32 llama (TF32 off) on the card, 2 shards against 1,
     sequential and chain (spec_k 3): tokens equal
  A. shared prefix, full width on phase 6's weights: 8 requests of a
     1024-token system prompt and a 64-448-token tail, served cold (prefix
     cache off), warm (the default) and with page dedup (prefix cache
     off): warm and dedup tokens equal cold; warm 7 hits over 7 * 1024
     reused tokens, no page copied, pages shared by reference a multiple
     of 8; dedup no trie hit, pages shared by content a multiple of 8, no
     collision; the refcount invariant; prefill rates, admission and step
     percentiles, the dedup hashing time per admission
  B. sessions: 6 conversations x 3 turns on 4 slots (512-token first
     turns, 64-192-token later ones, 32-token replies), with a 160-page
     pool (no snapshot dropped, every returning turn reuses its history)
     and a 40-page pool (snapshots dropped, every turn completes); the
     refcount invariant after every step; end_session releases exactly the
     snapshots' references; token agreement of the two runs reported
  C. overload on a virtual clock priced at phase 6's chunk and step times:
     4 no-SLO requests, one tight-SLO arrival while they hold every slot,
     then an SLO'd burst (24 requests in all), with the degrade ladder off
     and on: the ladder reaches small_chunks, sheds only pending requests
     (no tokens, a reason), preempts at least once, every victim completes
     and a re-admission reuses its resident prefix; requests whose prefill
     pieces match across the two runs have equal tokens; both runs'
     goodput is reported
  D. speculative serve, full width on phase 6's weights and geometry: 8
     greedy requests of 128-1024 prompt tokens (a seeded 64-token passage
     per request, repeated with 2 tokens edited in each copy) x 16 new
     tokens, served sequentially, then chain (spec_k 4), tree and auto
     (12 nodes, branch 3) and draft heads (4 heads of width 64, fitted on
     the card by fit_draft_heads on the sequential histories' last 256
     tokens, 100 Adam steps); every request completes, no logit is NaN,
     the refcount invariant after every step, moa_reduce launched 2 *
     layers * (prefill dispatches + decode steps); each run's decode tok/s,
     step p50 and p99, tokens per step, accept and draft-hit rates, pages
     rolled back, shape picks and requests equal to the sequential run's
     tokens
  C (spec). phase C's trace again with spec_k 4, ladder off and on, the
     virtual step priced at D's chain step p50: goodput and SLOs printed
  E. quantized KV and sampling, full width on phase 6's weights and
     geometry.  E1: phase 6's 8 greedy requests (8 new tokens each)
     over an unquantized (bf16),
     an int8 and an int4 pool: pool bytes asserted (114,688 / 59,136 /
     30,464 bytes a token over the pool's pages, scratch included), the
     refcount invariant after every step, moa_reduce launched 2 * layers
     * dispatches; prefill tok/s, decode step p50 / p99 and tok/s, requests
     with the unquantized run's tokens and the logit drift against it
     (max and mean over the aligned decode traces) printed.  E2: int8 on
     8 slots with the pool pages that fit E1's bf16 pool bytes, 16
     requests of the same length mix: decode tok/s and step p50 beside
     E1's bf16 run.  E3: phase D's repeated passages x 8 new tokens,
     every request sampled (temperature 0.8, top-k 40, seed 7) over an
     int8 pool: sequential twice (equal tokens asserted: restart
     determinism), chain (spec_k 4) and tree (12 nodes, branch 3); step
     p50, tokens a step, accept rate and requests equal to the sequential
     run printed, and where each request first parts from it, scored as
     the sampler scores it: each run's own logits row of that draw (kept
     on the card during the run), sorted, masked past top-k and given the
     Gumbel noise of (seed, index) by rank; each run's winning rank and
     margin, and how many of the top-k ranks hold another token in the
     two rows
  T. the autotune tier on phase 6's weights, after E: T1 the serve CLI's
     --burst-smoke --requests 8 at full width (its own weights) returns
     0; T2 replay_open_loop of an 8-arrival bursty_trace (rate 1, bursts
     of 16 a second, 256-token mean prompts, 24 new) on C's geometry with
     spec_k 4, priced at phase 6's chunk and step times and D's chain
     step (VirtualCosts), the SLO twice a mean request's service time,
     ladder off, on and on again: the two ladder-on replays have equal
     outputs, virtual time and shed, every shed request a reason and no
     tokens, every served request complete, moa_reduce launched 2 *
     layers a replayed dispatch (counted after the driver's warmup);
     both goodputs printed, no order asserted; T3 4 conversations x 3
     turns of 256 tokens + 16 on 2 slots: a session hit for each of the 8
     returning turns; T4 run_sweep over prefill_chunk {128, 256} x spec_k
     {0, 4} around phase 6's engine config plus page_size 96 (resolve
     rejects it) on sweep_workload (4 requests, 512 shared + 64 tokens,
     4 new), the (256, 0) point under torch.profiler: 4 records with
     metrics, one with its error, no profile_error, a non-empty Chrome
     trace (deleted after); each point and the Pareto front under
     (decode tok/s max, pool bytes min, p99 step min) printed
  F. MLA serve: minicpm3-4b at its published width (d 2560, 40 heads,
     q_lora_rank 768, kv_lora_rank 256, nope 64, rope 32, v 64, d_ff
     6400, vocab 73448) cut to 8 of its 62 layers (0.88 B params, bf16,
     random from seed 0), after T with the llama weights freed, on phase
     6's geometry: phase 6's traffic over bf16, int8 and int4 latent pools
     (4,608 / 2,368 / 1,216 bytes a token asserted: 8/62 of the whole
     model's 35,712 / 18,352 / 9,424), phase A's shared-prefix traffic cold
     and warm (tokens equal, 7 hits), chain (spec_k 4) and tree (12 nodes,
     branch 3) on phase D's passages, and E3's sampling over int8 twice
     (tokens equal); the refcount invariant after every step, every
     request complete, no NaN logit, and moa_reduce, flash_attention,
     bitplane_add and quant_matmul launched 0 times in every run; prefill
     tok/s, decode step p50/p99, decode tok/s and tokens a step printed
  M. MoE serve: phi3.5-moe-42b-a6.6b at its published width (d 4096,
     32/8 heads of 128, d_ff 6400, vocab 32064, 16 experts, top-2,
     capacity factor 1.25) cut to 16 of its 32 layers (21.07 B params,
     42.1 GB bf16, random from seed 0), after F with the MLA weights
     freed, on phase 6's geometry: M1 phase 6's traffic, M2 phase D's
     passages sequential and chain (spec_k 4); the refcount invariant
     after every step, every request complete, no NaN logit, moa_reduce
     launched 3 * 16 * dispatches, flash attention, bitplane_add and
     quant_matmul 0 times; prefill tok/s, decode step p50/p99, decode
     tok/s, M2's tokens a step and its chain run's agreement with its
     sequential run, and the kept share of (token, k) assignments at T = 4
     and T = 256 (the port's router and dispatch on layer 0) printed
  S. SSM serve: falcon-mamba-7b at its published width (64 Mamba-1
     layers, d 4096, d_inner 8192, state 16, dt_rank 256, vocab 65024;
     7,272,665,088 random bf16 parameters, 14.55 GB), after M with the
     MoE weights freed: 4 contiguous slots x max_seq 2048, chunk 32,
     warmup() first, 8 greedy requests (4 of 16 prompt tokens, 4 of
     16-32: their prefill is one host-bound decode step a token) x 16 new
     tokens: every request retires with 16 tokens, no
     decode logit is NaN, the state is 36,700,160 B a slot, no kernel is
     launched, and a second engine repeats the tokens; prefill tok/s,
     decode step p50/p99, decode tok/s, peak memory, and generate on the
     four 16-token prompts (its tok/s and token agreement with the
     engine) printed
  Z. hybrid serve: zamba2-1.2b at its published width (38 Mamba-2 layers
     in 6 groups of 6 and a tail of 2, d 2048, 64 heads of 64, state 64,
     a shared attention block of 32/32 heads of 64, d_ff 8192, vocab
     32000; 1,172,046,720 parameters), S's traffic, asserts and prints,
     141,472,256 B of state a slot
  Q. QKV-bias serve: glm4-9b at its published width (40 layers, d 4096,
     32/2 heads of 128, d_ff 13696, vocab 151552; its exact parameter
     count printed, bf16, random from seed 0, the biases N(0, 0.5) from
     seed 1), after Z: phase 6's traffic over bf16 and int8 pages, chain
     (spec_k 4) on D's passages; the refcount invariant after every
     step, every request complete, no NaN logit, moa_reduce launched 2 *
     40 a dispatch, pool bytes a token exactly kv_token_bytes (40,960 in
     bf16); the bias check: the bf16 engine's last decode logits row of
     its 128-token request lies at least 10x nearer forward's row (the
     flash kernels) with the biases than with them zeroed; prefill and
     decode tok/s, step p50 and p99 and peak GB printed
  7. moa_reduce timings at the serve path shapes, the verify shapes of a
     chain (C = 5) and a tree (C = 17) and G3's generate (N = 5) among
     them, the MoE combine's bf16 shapes and glm4-9b's prefill o and
     decode o (CUDA events, median of 50), beside the bound, the plain
     version and torch.sum
  8. train, reduced-config parity: 3 AdamW steps of the reduced fp32
     config from one state on the CPU (chunked attention) and on CUDA (the
     kernels): losses within 1e-4, kernels launched layers * steps times;
     the same for the reduced hubert-xlarge (audio frames, non-causal) and
     internvl2-26b (8 vision-stub tokens before the text, the loss on the
     text); then one reduced glm4-9b train_loss (32/2 heads, nonzero QKV
     biases), CUDA against CPU: the loss and the bq, bk and bv gradients
     within 1e-4, each flash kernel launched once a layer
  9. train, full width: llama3.2-3b, fp32 masters, bf16 compute, remat,
     batch 2 x seq 2048: loss and gradient norm through the kernels
     against the chunked attention (use_flash_attn off: no flash launch)
     on one state and batch (loss within 2e-3, norm within 0.1%), then 1
     warm-up and 3 timed AdamW steps (peak lr 3e-4, 100-step warm-up):
     finite losses and grad norms, the first loss within 1.0 of
     ln(vocab), the forward kernel launched 2 * layers
     * steps times (remat runs each layer's forward again in the backward)
     and each backward kernel layers * steps times
  H. hubert-xlarge at its published width and depth (48 layers, d 1280,
     16/16 heads of 80, d_ff 5120, vocab 504, non-causal, audio stub of
     512; 1.26 B parameters), fp32 masters, bf16 compute, remat, batch 2 x
     2048 frames, after phase 9 with its state freed.  H1, as phase 9: the
     kernel path against the chunked one, 1 warm-up and 3 timed steps,
     the first loss within 1.0 of ln(504), the flash launches.  H2,
     checkpoint and resume: from one seeded state a TrainLoop with
     ckpt_every 2 runs 4 steps into a temporary directory; a fresh loop on
     a state from another seed restores step 2 from a directory that holds
     only that checkpoint and runs steps 3-4: its losses equal the first
     run's, and its params, m, v and step torch.equal the first run's
     step-4 checkpoint read back; GB a checkpoint, the save's host copy and file-write seconds and the
     restore seconds printed; the directory is deleted.  With less free
     disk than 3 checkpoints, H2 runs at a depth that fits; it runs at
     RESUME_LAYERS, 12 of the 48 layers (3.80 GB checkpoints)
  V. internvl2-26b at its published width (d 6144, 48/8 heads of 128,
     d_ff 16384, vocab 92553, vision stub 3200 -> 256 tokens) cut to 4 of
     48 layers (2.72 B parameters; the whole model's train state is ~320
     GB), batch 2 x (256 stub + 1792 text) positions: as H1 with 2 timed
     steps, the loss on the text positions, the first loss within 1.0 of
     ln(92553)
 10. flash attention timings at the training path shape (median of 20)
     beside the bound, the plain version and PyTorch's
     scaled_dot_product_attention; the forward's and the backward's
     TFLOP/s and share of the bf16 peak beside SDPA's; then the same at
     zamba2's shared-block shape, hubert-xlarge's (non-causal; the bound
     counts the real head dim 80, and the padded-work ratio 128 / 80 is
     printed beside it), internvl2-26b's and glm4-9b's
 11. bitplane_add and quant_matmul against bitplane_add_plain and
     quant_matmul_plain, torch.equal, at the kernel-test shapes (Fig 12
     lanes, ragged and unaligned lanes, N = 1 to 64, M = 1 to 31, the all
     -128 K = 8192 case, a binding 18-bit plan), quant_matmul's ragged
     tiles, the wrap of two plan blocks (x -128, w 127, K = 262144: 2^25
     after wrapping) on both routes, K or N not a multiple of 16 and
     unaligned bases, each through the kernels quant_matmul.route names
     (wgmma, or the pre-pass and mma.sync; by counter), and at the adder
     path's shapes; the width guard raises before any launch
 12. the adder path, taken from llama3.2-3b's training step (4096 tokens):
     bitplane_add over one activation tensor (B = 4096 x d_model lanes) as
     the 16 x 16, 4 x 16 and 64 x 20 adders, quant_matmul at the gate/up,
     down and q/o projections and all -128 at K = d_ff; core.moa's
     reconfigured_add (Fig 15) and serial_add on the 16 x 16 lanes as
     plain device code; every result exact, each kernel launched once
     per call, every quant_matmul call one launch of the wgmma kernel
     (no pre-pass)
 13. adder timings at the path shapes beside the bound, the plain version
     and a library call (torch.sum, torch._int_mm on the row-major w and
     on a column-major w); bitplane_add's integer operations per lane in
     its source; quant_matmul's time with every launch, its TOP/s and
     share of the int8 peak, and the mma.sync route's parts (the parent's
     design): the pre-pass, the mma.sync product and the parent's PyTorch
     copy of w to K-major
  X. the mesh's collective half, after 13: ranks spawned as processes
     that all sit on cuda:0, joined by gloo (NCCL refuses two ranks of
     one communicator on one device; gloo takes CUDA tensors for every
     op used, so nothing is staged through host memory), TF32 off.  On
     2 ranks: X1 llama3.2-3b's gradient leaves at published width (one
     layer's and the final norm's) through the
     radix-4 tree: an int32 tree_psum torch.equal to the sum, the int8
     compressed mean against (g + e - new_err) summed within 1e-6; X2 one
     phi3.5-moe layer (16 experts of 4096 x 6400, fp32, capacity E/k,
     drop-free) on 2 expert ranks, 2 x 1024 tokens: moe_ffn_ep and
     moe_ffn_ep_psum against the dense dispatch within 2e-4, one
     moa_reduce a call, moa_reduce at the per-rank combine (2, 1024,
     4096) torch.equal to its plain version; X3 one pod-compressed train
     step of llama3.2-3b cut to 1 of 28 layers (0.89 B params, ~20 B a
     param a rank: its sharded state keeps params, m and v whole over
     ``pod``, as the JAX layout does, and ``err`` the pod's block of 1),
     one sequence of the 2 x 2048 batch a pod, against
     rank 0's oracle (both pods' gradients on one rank, quantized at one
     shared scale a leaf, the codes summed and meaned): the loss within
     rtol 1e-3 of the single-device loss, the grad norm within rtol 1e-5,
     flash launched as one remat train step; X4 one split-K decode
     step of llama3.2-3b at full depth, 2 sequences at a cache of 8192
     split over 2 ranks, against the unsharded decode_step: fp32 logits
     and cache blocks within 1e-4, bf16 split-K no farther from the fp32
     logits than the bf16 unsharded step (x 1.5, relative L2); X4m the
     same for MLA's latent cache (mla_decode_splitk): minicpm3-4b at
     published width cut to F's 8 of 62 layers, at X4's batch, cache and
     index; X6 the
     sharded train state: llama3.2-3b at published width cut to 2 of 28
     layers (989,346,816 params) on a (data 2, model 1) mesh, each rank
     holding its half of params, m and v (the dry run's per-device
     figure, to the byte), gathering a layer at a time: two steps of
     2 x 2048, a mesh checkpoint after each (each rank writes its rows),
     then, in the smoke's own process, the first checkpoint restored
     onto the one device and step 2 taken there: its loss within rtol
     1e-3 of the 2-rank step 2's, its grad norm within rtol 1e-4, and
     its m, v and param update within X6_STATE_RTOL (relative L2, each
     leaf) of the mesh's step 2 read back from the second checkpoint;
     the bytes handed to each collective beside the shapes' reckoning,
     and equal by op to the dry run's (run_cell on the mesh's shape,
     traced on meta tensors); X7 holds its steps (the sequence-parallel
     pair, the ragged one) and its first decode step against the dry
     run the same way, and the params and cache a rank holds to decode
     against the dry run's per-device figure, to the byte.  On 3
     ranks: X5 qwen2.5-14b's attention (40 q heads padded to 48, 16 a
     rank, 8 KV, hd 128) at 1 of 48 layers, fp32, one sequence of
     512: logits, loss and every
     gradient against the unsharded forward (1e-4, 1e-5, 5e-4; rank 0's
     oracle moved to the host first), flash launched as one remat train
     step and a forward, and flash at the per-rank group
     (1, 1024, 16, 128) against its plain version.  Each check prints its
     wall seconds, peak GB a rank, the transport, the bytes it handed the
     collectives and its kernel launches; its collective times are gloo's
     through host memory on one card, not NVLink's.  To rehearse on the
     CPU, import chip_smoke from a script guarded by ``if __name__ ==
     "__main__"`` and call ``phase_mesh_collectives("cpu", reduced=True)``
     (the reduced fp32 configs, ~3 min here)
  R. roofline, after X: the dry run (repro_torch.launch.dryrun) traces
     each step the phases above time on meta tensors, on the CPU, at that
     step's own batch, sequence or cache depth and depth (6's decode step
     over 4 slots x 2048 and its 256-token prefill chunk, Q's, M1's (16
     layers), S's and Z's decode steps with bf16 params as they were
     served; 9's, H1's and V's (4 layers) train steps at 2 x 2048 with
     fp32 masters): one line a step with the measured ms, the record's
     bound and dominant term, the resident bytes over 3.35 TB/s (the
     weight-and-state read floor) and measured over bound; the card's
     total_memory beside the H100 entry's 80 GB.  No kernel launches
 14. the kernels line (the flash rows at each shape; H's and V's train
     and resume figures once, in the forward's row), then the card line,
     then the result line; each phase's wall time is printed as it ends
     ("[wall]")
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import json
import math
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# noqa: E402 below: these need the path
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import lut, planner, reconfig  # noqa: E402
from repro_torch.core import moa as core_moa  # noqa: E402
from repro_torch.data.pipeline import HostDataConfig, host_batch  # noqa: E402
from repro_torch.dist.collectives import (make_tree_mesh,  # noqa: E402
                                          tree_psum)
from repro_torch.dist.plan import make_reduction_plan  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import bitplane_add as bpa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moa_reduce as moa  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import (block_owner,  # noqa: E402
                                       init_params, rms_norm,
                                       shape_structs, shard_block,
                                       split_axes)
from repro_torch.launch.dryrun import (KINDS, held_bytes,  # noqa: E402
                                       run_cell)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.mesh import device_mesh  # noqa: E402
from repro_torch.models.attention import tp_head_pad  # noqa: E402
from repro_torch.models.lm import (fit_draft_heads,  # noqa: E402
                                   forward, hidden_states, train_loss)
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, global_norm  # noqa: E402
from repro_torch.optim.compression import compressed_psum_mean  # noqa: E402
from repro_torch.optim.grad_accum import value_and_grad  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.roofline.analysis import H100, fmt_seconds  # noqa: E402
from repro_torch.models.quant_kv import KV_DTYPES  # noqa: E402
from repro_torch.serve import (EngineConfig, SamplingParams,  # noqa: E402
                               ServeEngine, auto_page_size, prng)
from repro_torch.serve.sampling import (sample_tokens,  # noqa: E402
                                        sampling_lanes)
from repro_torch.serve.engine import tree_width  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.train.state import (build_train_step,  # noqa: E402
                                     init_train_state, mesh_params,
                                     split_layers, train_state_shardings,
                                     train_state_specs)
from repro_torch.tree import leaves, map_tree  # noqa: E402
from repro_torch.tune import (Arrival, SweepSpec,  # noqa: E402
                              VirtualCosts, bursty_trace, multi_turn_trace,
                              pareto_front, replay_open_loop, run_sweep,
                              sweep_workload)
from repro_torch.tune.sweep import TRACE_FILE  # noqa: E402

#: H100 SXM memory rate and dense bf16 and int8 tensor-core rates (NVIDIA
#: data sheet) for the bounds
HBM_BYTES_PER_S = H100.hbm_bw
BF16_FLOP_PER_S = H100.peak_flops
INT8_OPS_PER_S = 1979e12
#: INT32 operations of the CUDA cores: 132 SMs x 64 INT32 lanes x 1.98 GHz,
#: the clock of the data sheet's 67 TFLOP/s fp32 (132 x 128 x 2 x 1.98 GHz)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: kernel sources: name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "moa_reduce": ("src/repro_torch/kernels/csrc/moa_reduce.cu",
                   "src/repro/kernels/moa_reduce.py:93"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:97"),
    "bitplane_add": ("src/repro_torch/kernels/csrc/bitplane_add.cu",
                     "src/repro/kernels/bitplane_add.py:78"),
    "quant_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:61"),
}

#: the second served architecture: Multi-head Latent Attention; phase F
#: serves it at its published width cut to 8 of its 62 layers (at 62 F
#: took 165-209 s, the smoke's longest phase; at 31, 104-128 s, and the
#: smoke took 1331.4 s of phases on a slow host; at 16, 41-106 s, and
#: with phase X7 the smoke took 1151.4 s on a slow host)
MLA_ARCH, MLA_LAYERS = "minicpm3-4b", 8
#: phase M: the routed MoE FFN at its published width, cut to 16 of its 32
#: layers (the whole model, 83.7 GB in bf16, does not fit the card); and
#: the other MoE architecture, held at its reduced config
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 16
MOE_ARCH_TOP1 = "llama4-scout-17b-a16e"

#: phases S and Z: the SSM (Mamba-1) and hybrid (Mamba-2 + shared
#: attention) families at their published widths, and phase 5's reduced
#: hybrid with a tail (5 = 2 groups of 2 + 1, as 38 = 6 x 6 + 2 has one)
SSM_ARCH, HYBRID_ARCH, HYBRID_REDUCED_LAYERS = ("falcon-mamba-7b",
                                                "zamba2-1.2b", 5)
#: decode state a slot at max_seq 2048: falcon-mamba's fp32 h (64 x 8192 x
#: 16) and bf16 conv (64 x 3 x 8192); zamba2's 38 h (64 x 64 x 64) and conv
#: (3 x 4224) and 6 groups' bf16 k and v (2048 x 32 x 64)
SSM_SLOT_BYTES = {SSM_ARCH: 36_700_160, HYBRID_ARCH: 141_472_256}
#: S and Z traffic: 8 greedy requests x 16 new tokens (32 until the smoke
#: took 1246.4 s of phases on a slow host) on 4 slots, prompts
#: of 16-32 tokens (16-64, and 32 for the first four, until it took
#: 1025.1 s on another, S and Z 74.6 and 78.4 s) and a prefill chunk of 32
#: (so warmup() prefills 8 + 16 + 32 tokens): these families prefill one
#: decode step a token, ~54 ms at full width on an H100 80GB HBM3 at
#: 700 W (host-bound), where 64-256-token prompts took 160 s a phase; the
#: first four prompts share one length, so generate() can take them as a
#: batch
SSM_NEW, SSM_GENERATE_LEN, SSM_PROMPTS, SSM_CHUNK = 16, 16, (16, 32), 32

#: the training path's attention shape: llama3.2-3b at batch 2 x seq 2048
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
#: the schedule the timed steps sit at the start of: peak lr 3e-4 after a
#: 100-step linear warm-up, cosine over 1000 steps
TRAIN_WARMUP, TRAIN_TOTAL = 100, 1000
#: zamba2-1.2b's shared attention block at batch 2 x seq 2048: 32 query
#: and 32 KV heads of 64 (its training path's flash shape)
ZAMBA_FLASH_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 32, 32, 64)
#: phases H and V: the modality-frontend families' training at their
#: published widths.  hubert-xlarge (encoder-only, audio frames) at its
#: full depth; internvl2-26b (a vision stub of 256 tokens before the text)
#: cut to 4 of its 48 layers: its whole train state (~320 GB of fp32
#: params, m, v and grads) does not fit the card.  Their flash shapes at
#: batch 2 x 2048 positions: hubert 16/16 heads of 80, non-causal (the
#: bf16 kernels take 64 or 128: the wrappers zero-pad 80 to 128);
#: internvl2 48/8 heads of 128, causal
AUDIO_ARCH, VLM_ARCH, VLM_LAYERS = "hubert-xlarge", "internvl2-26b", 4
AUDIO_STEPS, VLM_STEPS = 3, 2
HUBERT_FLASH_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 80)
INTERNVL_FLASH_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 48, 8, 128)
#: phase Q and the QKV-bias parity: glm4-9b (32 query heads over 2 KV
#: heads, a GQA group of 16) and qwen2.5-14b (40 over 8, a group of 5);
#: their reduced configs keep the group at narrow widths
QKV_ARCH, QWEN_ARCH = "glm4-9b", "qwen2.5-14b"
QKV_BIAS_HEADS = {QKV_ARCH: dict(n_heads=32, n_kv_heads=2),
                  QWEN_ARCH: dict(n_heads=20, n_kv_heads=4)}
#: their training shapes at batch 2 x seq 2048 (phases 4 and 10)
GLM4_FLASH_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 32, 2, 128)
QWEN_FLASH_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 40, 8, 128)
#: phase 4's named bf16 shapes, each with the causal flag its path runs
FLASH_NAMED = {"path": ((TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128), True),
               "zamba2": (ZAMBA_FLASH_SHAPE, True),
               "hubert": (HUBERT_FLASH_SHAPE, False),
               "internvl2": (INTERNVL_FLASH_SHAPE, True),
               "glm4": (GLM4_FLASH_SHAPE, True),
               "qwen": (QWEN_FLASH_SHAPE, True)}
#: phase H2: steps, save period, the two seeds (the first run's state
#: and the resumed loop's state before it restores) and the depth (at
#: hubert's 48 layers its 15.1 GB checkpoints took 45-52 s of file
#: writes a run, and the smoke 1246.4 s of phases on a slow host)
RESUME_STEPS, RESUME_EVERY, RESUME_SEEDS, RESUME_LAYERS = 4, 2, (1, 2), 12
FLASH_CHECK_SHAPES = [(2, 256, 4, 2, 64, torch.float32),
                      (1, 128, 8, 8, 128, torch.float32),
                      (2, 256, 6, 2, 80, torch.bfloat16),
                      (1, 512, 4, 1, 128, torch.float32),
                      (1, 256, 2, 2, 64, torch.float32),
                      (2, 37, 6, 2, 16, torch.float32),
                      (2, 100, 6, 2, 128, torch.bfloat16),
                      (1, 200, 4, 1, 64, torch.bfloat16),
                      (2, 37, 4, 4, 80, torch.bfloat16),
                      (2, TRAIN_SEQ, 24, 8, 128, torch.bfloat16),
                      ZAMBA_FLASH_SHAPE + (torch.bfloat16,),
                      HUBERT_FLASH_SHAPE + (torch.bfloat16,),
                      INTERNVL_FLASH_SHAPE + (torch.bfloat16,),
                      (1, 128, 16, 1, 64, torch.float32),
                      GLM4_FLASH_SHAPE + (torch.bfloat16,),
                      QWEN_FLASH_SHAPE + (torch.bfloat16,)]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _timed_build(name):
    t0 = time.perf_counter()
    log = _build.build(name)
    return log, time.perf_counter() - t0


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:
        done = dict(zip(KERNELS, ex.map(_timed_build, KERNELS)))
    for name, (log, secs) in done.items():
        _build.load(name)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
        print(f"[build] {name}.cu: {secs:.2f} s"
              f"{'' if log else ' (already built)'}")
    print(f"[build] {len(KERNELS)} kernel(s) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


#: phase G3: generate's traffic, GEN_ROWS equal prompts x new tokens
GEN_ROWS, GEN_PROMPT, GEN_NEW = 4, 128, 32


def verify_rows(ecfg) -> dict:
    """Rows a slot feeds a verify dispatch at ``ecfg``'s speculative
    knobs: ``spec_k + 1`` for a chain, and the width of an auto-mode tree
    dispatch (``engine.tree_width``)."""
    return {"chain": ecfg.spec_k + 1,
            "tree": tree_width(ecfg.spec_k, ecfg.spec_tree_nodes,
                               ecfg.spec_branch, "auto")}


def path_shapes(cfg, ecfg):
    """(label, N, M) of the two moa_reduce calls per layer per dispatch:
    decode over all slots (C = 1), a full prefill piece (B = 1), and the
    verify dispatches over all slots (C = ``verify_rows``), for a resolved
    engine config with the speculative knobs set."""
    n = ecfg.max_seq // ecfg.page_size
    h, hd = cfg.n_heads, cfg.hd
    b, c = ecfg.max_slots, ecfg.prefill_chunk
    out = [("decode_l", n, b * h), ("decode_o", n, b * h * hd),
           ("prefill_l", n, c * h), ("prefill_o", n, c * h * hd)]
    for name, rows in verify_rows(ecfg).items():
        out += [(f"verify_{name}_l", n, b * h * rows),
                (f"verify_{name}_o", n, b * h * rows * hd)]
    return out


def moe_shapes(ecfg):
    """(label, N, M) of the MoE top-k combine, one moa_reduce a layer a
    dispatch over N = top_k bf16 operands of M = T * d_model columns,
    summed in fp32: phi3.5-moe's decode over all slots (T = slots), a full
    prefill piece (T = chunk) and a chain verify (T = slots * (spec_k +
    1)), and llama4-scout's top-1 decode, at the resolved engine config
    ``ecfg`` of phase 6's geometry."""
    phi, scout = get_config(MOE_ARCH), get_config(MOE_ARCH_TOP1)
    b, c = ecfg.max_slots, ecfg.prefill_chunk
    rows = verify_rows(ecfg)["chain"]
    return [("moe_decode", phi.top_k, b * phi.d_model),
            ("moe_prefill", phi.top_k, c * phi.d_model),
            ("moe_verify_chain", phi.top_k, b * rows * phi.d_model),
            ("moe_decode_top1", scout.top_k, b * scout.d_model)]


def generate_shapes(cfg):
    """(label, N, M) of phase G3's two moa_reduce calls per layer per
    dispatch: ``generate``'s GEN_ROWS lockstep rows (C = 1) over its dense
    cache of GEN_PROMPT + GEN_NEW positions read as pages of
    ``auto_page_size`` of that length."""
    seq = GEN_PROMPT + GEN_NEW
    n = seq // auto_page_size(seq)
    rows = GEN_ROWS * cfg.n_heads
    return [("generate_l", n, rows), ("generate_o", n, rows * cfg.hd)]


def phase_kernel_check(shapes, moe_path) -> float:
    """moa_reduce (through ops, as the path calls it) against the plain
    version on the same CUDA inputs, bit for bit: the kernel-test cases,
    the page combine's ``shapes`` in fp32, and the MoE combine's
    ``moe_path`` columns at N = 1 and 2 in bf16.  Returns the max |diff|."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    cases = []
    # N = 3, 4 (s = 0 split levels), 5 .. 64 (s = 1), 65 .. 300 (s = 2)
    for n, rows, cols in [(2, 8, 128), (4, 64, 128), (7, 33, 257),
                          (16, 128, 384), (33, 16, 130), (24, 32, 256),
                          (3, 4, 129), (5, 8, 128), (17, 2, 130),
                          (52, 4, 256), (64, 2, 512), (65, 4, 257),
                          (244, 1, 96), (300, 2, 64)]:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            cases.append((n, (rows, cols), dt))
    cases += [(n, (m,), torch.float32) for _, n, m in shapes]
    cases += [(n, (m,), torch.bfloat16) for _, _, m in moe_path
              for n in (1, 2)]
    for n, tail, dt in cases:
        if dt == torch.int32:
            x = torch.randint(-1000, 1000, (n, *tail), generator=gen,
                              device=dev, dtype=torch.int32)
            acc = torch.int32
        else:
            x = torch.randn((n, *tail), generator=gen, device=dev)
            x[..., :8] = -0.0           # the plan's padding turns some +0
            x = x.to(dt)
            acc = torch.float32
        got = ops.moa_reduce(x, acc, out_dtype=acc)
        want = moa.moa_reduce_plain(x, acc, acc)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and
              torch.equal(torch.signbit(got), torch.signbit(want)),
              f"moa_reduce != moa_reduce_plain at N={n} {tail} {dt}")
        err = max(err, float((got.double() - want.double()).abs().max()))
    # bf16 operands, fp32 accumulator: the small terms must survive
    n = 256
    x = torch.cat([torch.full((1, 8, 128), 1024.0, device=dev),
                   torch.full((n - 1, 8, 128), 0.25, device=dev)]
                  ).to(torch.bfloat16)
    got = ops.moa_reduce(x, torch.float32, out_dtype=torch.float32)
    check(bool((got == 1024.0 + 0.25 * (n - 1)).all()),
          "bf16 operands lost small terms in the fp32 accumulator")
    print(f"[check] moa_reduce == moa_reduce_plain (torch.equal, signs of "
          f"zero too) on {len(cases) + 1} shape/dtype cases, max |diff| "
          f"{err}")
    return err


def make_prompts(lens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def phase_reduced_parity() -> None:
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    gen = torch.Generator().manual_seed(0)
    cpu_params = init_params(get_api(cfg).param_specs(cfg), gen,
                             torch.device("cpu"), cfg.dtype)
    ecfg = EngineConfig(max_slots=2, max_seq=64, prefill_chunk=16,
                        page_size=16)
    prompts = make_prompts((5, 19, 33, 12), cfg.vocab, seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = (cpu_params if dev == "cpu"
                  else map_tree(lambda t: t.to(dev), cpu_params))
        eng = ServeEngine(cfg, params, config=ecfg, device=dev)
        eng.trace_logits = True
        before = moa.LAUNCHES
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        runs[dev] = (reqs, eng, moa.LAUNCHES - before)
    (creqs, ceng, _), (greqs, geng, launched) = runs["cpu"], runs["cuda"]
    check([r.generated for r in creqs] == [r.generated for r in greqs],
          "reduced config: CUDA greedy tokens differ from CPU")
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(ceng.logit_trace, geng.logit_trace))
    check(len(ceng.logit_trace) == len(geng.logit_trace) and diff <= 1e-3,
          f"reduced config: decode logits differ by {diff} (> 1e-3)")
    check(launched > 0 and launched == geng.stats["moa_reduce_launches"],
          "reduced config: the CUDA engine did not launch moa_reduce")
    print(f"[parity] reduced llama3.2-3b (fp32, kv_heads=2): tokens equal "
          f"CPU vs CUDA over {len(prompts)} requests, max |logit diff| "
          f"{diff:.3e} (tol 1e-3), moa_reduce launches {launched}")
    cpu_runs = reduced_serve_runs(cfg, cpu_params, "cpu")
    gpu_runs = reduced_serve_runs(cfg, map_tree(lambda t: t.to("cuda"),
                                                cpu_params), "cuda")
    for name, (ceng, creqs) in cpu_runs.items():
        geng, greqs = gpu_runs[name]
        check(_tokens(creqs) == _tokens(greqs),
              f"reduced {name}: CUDA greedy tokens differ from CPU")
        cst, gst = ceng.stats_summary(), geng.stats_summary()
        bad = [k for k in SERVE_COUNTERS
               if k != "moa_reduce_launches" and cst[k] != gst[k]]
        check(not bad, f"reduced {name}: counters differ CPU vs CUDA: "
                       f"{[(k, cst[k], gst[k]) for k in bad]}")
        diff = _logit_diff(ceng, geng)
        check(diff <= 1e-3, f"reduced {name}: decode logits differ by "
                            f"{diff} (> 1e-3)")
        check(gst["moa_reduce_launches"] > 0,
              f"reduced {name}: the CUDA engine did not launch moa_reduce")
        print(f"[parity] reduced {name}: tokens and {len(SERVE_COUNTERS) - 1}"
              f" counters equal CPU vs CUDA over {len(creqs)} requests "
              f"(hits {gst['prefix_hits']}, shared {gst['pages_shared']}, "
              f"cow {gst['pages_cow']}, dedup {gst['dedup_pages_shared']}, "
              f"session hits {gst['session_hits']}, drops "
              f"{gst['session_snapshot_drops']}, preemptions "
              f"{gst['preemptions']}, shed {gst['shed_requests']}, ladder "
              f"max {getattr(geng, 'max_level', 0)}); "
              f"max |logit diff| {diff:.3e} (tol 1e-3)")
    _free(*(e for e, _ in cpu_runs.values()),
          *(e for e, _ in gpu_runs.values()))
    cpu_runs = reduced_spec_runs(cfg, cpu_params, "cpu")
    gpu_runs = reduced_spec_runs(cfg, map_tree(lambda t: t.to("cuda"),
                                               cpu_params), "cuda")
    seq = _tokens(gpu_runs["sequential"][1])
    for name, (ceng, creqs) in cpu_runs.items():
        geng, greqs = gpu_runs[name]
        check(_tokens(creqs) == _tokens(greqs),
              f"reduced spec {name}: CUDA greedy tokens differ from CPU")
        cst, gst = ceng.stats_summary(), geng.stats_summary()
        bad = [k for k in SERVE_COUNTERS + SPEC_COUNTERS
               if k != "moa_reduce_launches" and cst[k] != gst[k]]
        check(not bad, f"reduced spec {name}: counters differ CPU vs CUDA: "
                       f"{[(k, cst[k], gst[k]) for k in bad]}")
        check(gst["moa_reduce_launches"] == 2 * cfg.n_layers * (
            gst["prefill_dispatches"] + gst["decode_steps"]),
              f"reduced spec {name}: moa_reduce launches "
              f"{gst['moa_reduce_launches']}")
        print(f"[parity] reduced spec {name}: tokens and "
              f"{len(SERVE_COUNTERS) - 1 + len(SPEC_COUNTERS)} counters "
              f"equal CPU vs CUDA over {len(creqs)} requests (decode steps "
              f"{gst['decode_steps']}, drafted {gst['spec_drafted']}, "
              f"accepted {gst['spec_accepted']}, rolled back "
              f"{gst['spec_pages_rolled_back']}, tree steps "
              f"{gst['spec_tree_steps']}, shapes chain/tree "
              f"{gst['spec_shape_chain']}/{gst['spec_shape_tree']}); CUDA "
              f"tokens == CUDA sequential: {_tokens(greqs) == seq}")
    _free(*(e for e, _ in cpu_runs.values()),
          *(e for e, _ in gpu_runs.values()))
    cpu_runs = reduced_quant_runs(cfg, cpu_params, "cpu")
    gpu_runs = reduced_quant_runs(cfg, map_tree(lambda t: t.to("cuda"),
                                                cpu_params), "cuda")
    for name, (ceng, creqs) in cpu_runs.items():
        geng, greqs = gpu_runs[name]
        check(_tokens(creqs) == _tokens(greqs),
              f"reduced {name}: CUDA tokens differ from CPU")
        cst, gst = ceng.stats_summary(), geng.stats_summary()
        bad = [k for k in SERVE_COUNTERS + SPEC_COUNTERS + (
            "kv_dtype", "kv_bytes_per_slot", "pool_bytes")
            if k != "moa_reduce_launches" and cst[k] != gst[k]]
        check(not bad, f"reduced {name}: counters differ CPU vs CUDA: "
                       f"{[(k, cst[k], gst[k]) for k in bad]}")
        base = gpu_runs[name.removesuffix(" chain")][1]
        print(f"[parity] reduced {name}: tokens and counters equal CPU vs "
              f"CUDA over {len(creqs)} requests (CUDA tokens == CUDA "
              f"sequential: {_tokens(greqs) == _tokens(base)}; kv_dtype "
              f"{gst['kv_dtype']}, {gst['kv_bytes_per_slot']} bytes a slot;"
              f" decode steps {gst['decode_steps']}, drafted "
              f"{gst['spec_drafted']}, accepted {gst['spec_accepted']}; "
              f"moa_reduce launches {gst['moa_reduce_launches']})")
    _free(*(e for e, _ in cpu_runs.values()),
          *(e for e, _ in gpu_runs.values()))
    sampling_parity()
    table_parity(cfg, REDUCED_CONTIGUOUS_RUNS)
    table_parity(get_config(MLA_ARCH).reduced(dtype=torch.float32),
                 REDUCED_MLA_RUNS)
    for arch in (MOE_ARCH, MOE_ARCH_TOP1):
        base = get_config(arch).reduced(dtype=torch.float32)
        # drop-free (the reduced capacity), then 1.0: rows compete
        for cf in (base.capacity_factor, 1.0):
            table_parity(dataclasses.replace(base, capacity_factor=cf),
                         REDUCED_MOE_RUNS)
    moe_train_parity()
    for cfg in ssm_reduced_configs():
        ssm_reduced_parity(cfg)
    for arch in (QKV_ARCH, QWEN_ARCH):
        qcfg = reduced_qkv(arch)
        table_parity(qcfg, REDUCED_BIAS_RUNS,
                     with_biases(seed_params(qcfg), seed=1))
    replay_parity()


#: the QKV-bias parameters a layer, drawn nonzero by :func:`with_biases`
QKV_BIASES = ("bq", "bk", "bv")
#: phase 5's runs of the reduced QKV-bias archs
REDUCED_BIAS_RUNS = {
    "sequential": (dict(prefix_cache=False), False),
    "prefix warm": ({}, False),
    "chain": (dict(spec_k=4), False),
    "contiguous": (dict(paged_kv=False), False)}


def reduced_qkv(arch):
    """The reduced fp32 QKV-bias ``arch`` at its published GQA group."""
    return get_config(arch).reduced(dtype=torch.float32,
                                    **QKV_BIAS_HEADS[arch])


def seed_params(cfg):
    """Seed-0 params of ``cfg`` on the CPU."""
    return init_params(get_api(cfg).param_specs(cfg),
                       torch.Generator().manual_seed(0),
                       torch.device("cpu"), cfg.dtype)


def with_biases(params, seed: int):
    """``params`` with ``bq``, ``bk`` and ``bv`` drawn N(0, 0.5) from
    ``seed`` on their device, in their dtype (their init is zeros, which
    would hide a dropped or misplaced bias add).  Returns ``params``."""
    attn = params["blocks"]["attn"]
    dev = attn["bq"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for k in QKV_BIASES:
        attn[k] = (0.5 * torch.randn(attn[k].shape, generator=gen,
                                     device=dev)).to(attn[k].dtype)
    return params


def zeroed_biases(params):
    """A shallow copy of ``params`` whose QKV biases are zeros."""
    attn = params["blocks"]["attn"]
    return dict(params, blocks=dict(params["blocks"], attn=dict(
        attn, **{k: torch.zeros_like(attn[k]) for k in QKV_BIASES})))


#: the virtual prices of the reduced replays (the JAX package's defaults)
REDUCED_COSTS = VirtualCosts(0.010, 0.020, 0.032)
#: what a replay's trajectory is: the fields of replay_open_loop's result
#: held equal between two runs
TRAJECTORY = ("outputs", "elapsed_s", "steps", "served_tokens",
              "goodput_tokens", "slo_met", "slo_missed", "shed")


def counted_replay(eng, trace, costs, what):
    """``replay_open_loop`` of ``trace`` on ``eng`` at ``costs``: every
    kernel count zeroed again after the driver's ``warmup()`` (which moves
    no engine counter), so the launches held by :func:`_check_launches`
    are those of the replayed steps; the scheduler's clock restored.
    Returns (result, moa_reduce launches)."""
    warm, clock = eng.warmup, eng.scheduler.clock

    def warmup():
        warm()
        _sync()
        _zero_kernel_counts()

    eng.warmup = warmup
    res = {}
    launches = _counted_run(eng, lambda: res.update(
        replay_open_loop(eng, trace, costs)))
    check(eng.scheduler.clock is clock,
          f"{what}: the scheduler's clock was not restored")
    _check_launches(eng, launches, what)
    refcount_check(eng, what)
    return res, launches


def replay_parity() -> None:
    """The port's ``replay_open_loop`` on the reduced fp32 llama, CUDA
    against CPU on the same weights: the JAX package's canned burst (18
    arrivals, seed 11, spec_k 3) with the degrade ladder, and 2
    conversations x 3 turns; outputs, the whole trajectory and every
    counter equal."""
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    cpu_params = seed_params(cfg)
    runs = {
        "burst, ladder on": (bursty_trace(
            18, rate=2.0, burst_rate=30.0, mean_prompt=16, mean_gen=8,
            max_prompt=40, max_gen=16, vocab=cfg.vocab, slo_ms=800.0,
            seed=11), dict(spec_k=3, degrade=True)),
        "multi-turn": (multi_turn_trace(2, 3, turn_tokens=8, gen=4,
                                        think_s=0.2, vocab=cfg.vocab,
                                        seed=2), {})}
    keys = [k for k in SERVE_COUNTERS + SPEC_COUNTERS
            if k != "moa_reduce_launches"]
    for name, (trace, knobs) in runs.items():
        out = {}
        for dev in ("cpu", "cuda"):
            params = (cpu_params if dev == "cpu"
                      else map_tree(lambda t: t.to(dev), cpu_params))
            eng = ServeEngine(cfg, params, config=EngineConfig(
                max_slots=2, max_seq=96, prefill_chunk=16, **knobs),
                device=dev)
            out[dev] = counted_replay(eng, trace, REDUCED_COSTS,
                                      f"reduced replay {name} {dev}")
            _free(eng)
        (cres, _), (gres, launched) = out["cpu"], out["cuda"]
        bad = [k for k in TRAJECTORY if cres[k] != gres[k]] + [
            k for k in keys if cres["stats"][k] != gres["stats"][k]]
        check(not bad, f"reduced replay {name}: CUDA differs from CPU in "
                       f"{bad}")
        st = gres["stats"]
        print(f"[parity] reduced replay_open_loop, {name}: outputs, "
              f"{len(TRAJECTORY) - 1} trajectory fields and {len(keys)} "
              f"counters equal CPU vs CUDA over {len(trace)} arrivals "
              f"({gres['steps']} steps over {gres['elapsed_s']:.4f} "
              f"virtual s, SLO met {gres['slo_met']} / missed "
              f"{gres['slo_missed']}, shed {gres['shed']}, ladder "
              f"transitions {st['degrade_transitions']}, spec steps "
              f"{st['spec_steps']}, session hits {st['session_hits']}); "
              f"moa_reduce launches {launched}")


def moe_train_parity() -> None:
    """One reduced phi3.5-moe ``train_loss`` (capacity 1.0: assignments
    dropped) and its gradients, CUDA against CPU on one batch, within
    1e-4: on the card the top-k combine is the moa_reduce kernel (once a
    layer in the forward) under ``MoaReduce``'s backward, which must hand
    every expert weight its gradient."""
    cfg = get_config(MOE_ARCH).reduced(dtype=torch.float32,
                                       capacity_factor=1.0)
    cpu_params = init_params(get_api(cfg).param_specs(cfg),
                             torch.Generator().manual_seed(0),
                             torch.device("cpu"), cfg.dtype)
    toks = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab, (4, 33)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = map_tree(lambda t: t.to(dev).requires_grad_(True), cpu_params)
        batch = {"tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        _zero_kernel_counts()
        loss = train_loss(p, batch, cfg)
        grads = torch.autograd.grad(loss, leaves(p))
        _sync()
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    moa.LAUNCHES)
    (closs, cgrads, _), (gloss, ggrads, launched) = out["cpu"], out["cuda"]
    diff = max(float((a - b).abs().max()) for a, b in zip(cgrads, ggrads))
    check(abs(closs - gloss) <= 1e-4 and diff <= 1e-4,
          f"reduced MoE train: CUDA loss {gloss} (CPU {closs}), max "
          f"|grad diff| {diff} (> 1e-4)")
    check(launched == cfg.n_layers,
          f"reduced MoE train: moa_reduce launched {launched} times, "
          f"expected {cfg.n_layers} (one combine a layer)")
    ffn = cpu_params["blocks"]["ffn"]
    expert = [g for g, t in zip(ggrads, leaves(cpu_params))
              if any(t is ffn[k] for k in ("w1", "w2", "w3"))]
    check(len(expert) == 3 and all(bool(g.abs().sum() > 0) for g in expert),
          "reduced MoE train: an expert weight got no gradient on the card")
    print(f"[parity] reduced {MOE_ARCH} train_loss (fp32, capacity 1.0, "
          f"batch 4 x seq 32): loss CPU {closs:.6f} CUDA {gloss:.6f}; "
          f"{len(ggrads)} gradient leaves, max |diff| {diff:.3e} (tol "
          f"1e-4); moa_reduce launches {launched} (the backward through "
          f"MoaReduce, no launch)")


#: phase 5's SSM and hybrid runs: 2 slots for 5 requests (a slot turns
#: over, idle lanes run), contiguous as resolve() makes them
REDUCED_SSM_RUNS = {"sequential": ({}, False), "sampled": ({}, True)}


def ssm_reduced_configs():
    """Phase 5's reduced fp32 falcon-mamba-7b and tailed zamba2-1.2b."""
    return (get_config(SSM_ARCH).reduced(dtype=torch.float32),
            get_config(HYBRID_ARCH).reduced(
                dtype=torch.float32, n_layers=HYBRID_REDUCED_LAYERS))


def ssm_cpu_params(cfg):
    """Seed-0 weights on the CPU; a hybrid's ``lora_b`` (zeros at init)
    drawn random too, so every group's LoRA delta on ``wq`` matters."""
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), cfg.dtype)
    if "lora_b" in params:
        params["lora_b"] = 0.2 * torch.randn(
            params["lora_b"].shape, generator=torch.Generator().manual_seed(1))
    return params


def check_ssm_gates(cfg, what: str) -> None:
    """resolve() turns paging, speculation, prefix reuse and KV
    quantization off for a state that is not positional."""
    r = EngineConfig(max_slots=4, max_seq=2048, spec_k=4, spec_mode="tree",
                     kv_dtype="int8", page_dedup=True).resolve(cfg)
    check((r.paged_kv, r.spec_k, r.spec_mode, r.prefix_cache, r.kv_dtype,
           r.page_dedup) == (False, 0, "chain", False, "fp32", False),
          f"{what}: resolve() kept a gate on: {r.to_dict()}")


def check_warmup_keeps(eng, what: str) -> None:
    """``warmup()`` on an engine with live requests changes no state leaf
    and no counter."""
    before = {k: v.clone() for k, v in eng.state.items()}
    stats = dict(eng.stats)
    eng.warmup()
    check(eng.stats == stats, f"{what}: warmup moved a counter")
    bad = [k for k, v in eng.state.items() if not torch.equal(v, before[k])]
    check(not bad, f"{what}: warmup changed the state leaves {bad}")


def ssm_reduced_parity(cfg) -> None:
    """Phase 5 on a reduced SSM or hybrid ``cfg``: the gates; sequential
    greedy and sampled engines and ``generate``, CUDA against CPU (tokens
    and every counter equal, decode logits within 1e-3, no kernel
    launched); ``warmup()`` on a live CUDA engine keeps its state; and one
    ``train_loss`` and every gradient CUDA against CPU within 1e-4 (the
    hybrid's shared attention through the flash kernels on the card)."""
    tag = f"reduced {cfg.arch_id} ({cfg.n_layers} layers)"
    check_ssm_gates(cfg, tag)
    cpu_params = ssm_cpu_params(cfg)
    table_parity(cfg, REDUCED_SSM_RUNS, cpu_params)
    gpu_params = map_tree(lambda t: t.to("cuda"), cpu_params)
    prompts = np.random.default_rng(18).integers(0, cfg.vocab, (3, 11))
    ids = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        _zero_kernel_counts()
        ids[dev] = generate(cfg, p, prompts, 8, device=dev)[0]
        _sync()
        check(not any(_kernel_counts().values()),
              f"{tag} generate on {dev}: a kernel launched")
    check(np.array_equal(ids["cpu"], ids["cuda"]),
          f"{tag}: generate tokens differ CPU vs CUDA")
    eng = ServeEngine(cfg, gpu_params, config=EngineConfig(
        max_slots=2, max_seq=64, prefill_chunk=16))
    for q in make_prompts((7, 12, 5), cfg.vocab, seed=19):
        eng.submit(q, 8)
    eng.step()
    eng.step()
    check_warmup_keeps(eng, tag)
    eng.run()
    _free(eng)
    toks = torch.from_numpy(np.random.default_rng(20).integers(
        0, cfg.vocab, (2, 33)))
    out = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        p = map_tree(lambda t: t.detach().requires_grad_(True), params)
        batch = {"tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        _zero_kernel_counts()
        loss = get_api(cfg).train_loss(p, batch, cfg)
        grads = torch.autograd.grad(loss, leaves(p))
        _sync()
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    _kernel_counts())
    (closs, cgrads, _), (gloss, ggrads, counts) = out["cpu"], out["cuda"]
    diff = max(float((a - b).abs().max()) for a, b in zip(cgrads, ggrads))
    check(abs(closs - gloss) <= 1e-4 and diff <= 1e-4,
          f"{tag} train: CUDA loss {gloss} (CPU {closs}), max |grad diff| "
          f"{diff} (> 1e-4)")
    groups = cfg.n_layers // cfg.shared_attn_period \
        if cfg.family == "hybrid" else 0
    want = {k: (groups if k.startswith("flash") else 0) for k in counts}
    check(counts == want, f"{tag} train: kernel launches {counts}, "
                          f"expected {want}")
    print(f"[parity] {tag} train_loss (fp32, batch 2 x seq 32): loss CPU "
          f"{closs:.6f} CUDA {gloss:.6f}; {len(ggrads)} gradient leaves, max "
          f"|diff| {diff:.3e} (tol 1e-4); kernel launches {counts}; "
          f"generate tokens equal CPU vs CUDA; gates off; warmup kept the "
          f"state")


#: phase 5's MLA runs: (engine knobs, sampled?); a "prefix warm" run
#: serves shared-prefix prompts, the others repeated passages
REDUCED_MLA_RUNS = {
    "sequential": (dict(prefix_cache=False), False),
    "prefix warm": ({}, False),
    "chain": (dict(spec_k=4), False),
    "tree": (dict(spec_k=4, spec_mode="tree"), False),
    "int8": (dict(kv_dtype="int8"), False),
    "int4": (dict(kv_dtype="int4"), False),
    "sampled": ({}, True),
    "contiguous": (dict(paged_kv=False), False),
    "contiguous prefix warm": (dict(paged_kv=False), False),
    "contiguous tree": (dict(paged_kv=False, spec_k=4, spec_mode="tree"),
                        False)}

#: phase 5's contiguous llama runs (the same table form): split-K over
#: dense slot rows read as pages of 16, and (page 0) one softmax
REDUCED_CONTIGUOUS_RUNS = {
    "contiguous": (dict(paged_kv=False, prefix_cache=False), False),
    "contiguous prefix warm": (dict(paged_kv=False), False),
    "contiguous chain": (dict(paged_kv=False, spec_k=4), False),
    "contiguous tree": (dict(paged_kv=False, spec_k=4, spec_mode="tree"),
                        False),
    "contiguous sampled": (dict(paged_kv=False), True),
    "dense": (dict(page_size=0), False)}


#: phase 5's MoE runs: 6 slots for 5 requests, so a lane is always idle
#: and its row routes with the live ones
REDUCED_MOE_RUNS = {
    "sequential": (dict(max_slots=6, prefix_cache=False), False),
    "chain": (dict(max_slots=6, prefix_cache=False, spec_k=4), False),
    "int8": (dict(max_slots=6, prefix_cache=False, kv_dtype="int8"), False),
    "sampled": (dict(max_slots=6, prefix_cache=False), True),
    "contiguous": (dict(max_slots=6, paged_kv=False, prefix_cache=False),
                   False)}


def _tag(cfg) -> str:
    """The arch, and for MoE its capacity factor."""
    return cfg.arch_id + (f" capacity {cfg.capacity_factor}"
                          if cfg.n_experts else "")


def reduced_table_runs(cfg, params, dev, table):
    """Phase 5's runs of ``table`` (name -> (engine knobs, sampled?)) on
    ``dev``: 2 slots x 64, chunk 16, page 16 under the knobs; every run
    stepped with the refcount invariant after every step (paged) and its
    decode logits traced; a sampled run's request ``i`` draws with
    temperature 0.8, top-k 40 and seed ``i``.  (engine, requests) by run
    name."""
    passages = spec_prompts((40, 13, 28, 20, 33), cfg.vocab, seed=15,
                            passage=6, edits=1)
    rng = np.random.default_rng(16)
    system = rng.integers(0, cfg.vocab, 24).tolist()
    shared = [system + rng.integers(0, cfg.vocab, n).tolist()
              for n in (5, 9, 3, 12, 7)]
    runs = {}
    for name, (knobs, sampled) in table.items():
        eng = ServeEngine(cfg, params, config=EngineConfig(**dict(dict(
            max_slots=2, max_seq=64, prefill_chunk=16, page_size=16),
            **knobs)), device=dev)
        eng.trace_logits = True
        prompts = shared if name.endswith("prefix warm") else passages
        reqs = [eng.submit(q, 16, sampling=SamplingParams(
            temperature=0.8, top_k=40, seed=i) if sampled else None)
            for i, q in enumerate(prompts)]

        def drive():
            while eng.scheduler.has_work:
                eng.step()
                refcount_check(eng, f"reduced {_tag(cfg)} {name}")

        launches = _counted_run(eng, drive)
        _check_launches(eng, launches, f"reduced {_tag(cfg)} {name}")
        runs[name] = (eng, reqs)
    return runs


def table_parity(cfg, table, cpu_params=None) -> None:
    """The runs of ``table`` on the reduced fp32 ``cfg``, CUDA against CPU
    on the same weights (``cpu_params``, else drawn from seed 0): tokens
    and every counter equal (the launch count aside: CPU tensors launch
    nothing; the card's is held by ``_check_launches``), decode logits
    within 1e-3."""
    if cpu_params is None:
        cpu_params = init_params(get_api(cfg).param_specs(cfg),
                                 torch.Generator().manual_seed(0),
                                 torch.device("cpu"), cfg.dtype)
    cpu_runs = reduced_table_runs(cfg, cpu_params, "cpu", table)
    gpu_runs = reduced_table_runs(cfg, map_tree(lambda t: t.to("cuda"),
                                                cpu_params), "cuda", table)
    keys = [k for k in SERVE_COUNTERS + SPEC_COUNTERS + (
        "kv_dtype", "kv_bytes_per_slot", "pool_bytes")
        if k != "moa_reduce_launches"]
    for name, (ceng, creqs) in cpu_runs.items():
        geng, greqs = gpu_runs[name]
        what = f"reduced {_tag(cfg)} {name}"
        check(_tokens(creqs) == _tokens(greqs),
              f"{what}: CUDA tokens differ from CPU")
        cst, gst = ceng.stats_summary(), geng.stats_summary()
        bad = [k for k in keys if cst[k] != gst[k]]
        check(not bad, f"{what}: counters differ CPU vs CUDA: "
                       f"{[(k, cst[k], gst[k]) for k in bad]}")
        diff = _logit_diff(ceng, geng)
        check(diff <= 1e-3, f"{what}: decode logits differ by {diff} "
                            f"(> 1e-3)")
        print(f"[parity] {what}: tokens and {len(keys)} counters equal CPU "
              f"vs CUDA over {len(creqs)} requests (paged_kv {geng.paged}, "
              f"page {geng.page_size}, decode steps "
              f"{gst['decode_steps']}, prefix hits {gst['prefix_hits']}, "
              f"bytes copied {gst['prefix_bytes_copied']}, pages shared "
              f"{gst['pages_shared']}, drafted {gst['spec_drafted']}, "
              f"accepted {gst['spec_accepted']}, tree steps "
              f"{gst['spec_tree_steps']}, kv_dtype {gst['kv_dtype']}, "
              f"{gst['kv_bytes_per_slot']} bytes a slot); max |logit diff| "
              f"{diff:.3e} (tol 1e-3); kernel launches "
              f"{geng.kernel_launches}")
    _free(*(e for e, _ in cpu_runs.values()),
          *(e for e, _ in gpu_runs.values()))


def phase_full_width():
    """Returns the moa_reduce launches of the measured run, the weights,
    the run's mean prefill-dispatch and decode-step times, and its
    tokens."""
    cfg = get_config("llama3.2-3b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(get_api(cfg).param_specs(cfg), gen, dev, cfg.dtype)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"[full] llama3.2-3b params: {nbytes / 1e9:.3f} GB {cfg.dtype}, "
          f"initialized in {time.perf_counter() - t0:.2f} s")
    # the prefix cache off: what PRs 11-17 measured (its retired rows would
    # stay resident, and nothing here shares a prefix)
    ecfg = EngineConfig(max_slots=4, max_seq=2048, prefill_chunk=256,
                        prefix_cache=False)
    eng = ServeEngine(cfg, params, config=ecfg)
    print(f"[full] engine: slots {ecfg.max_slots}, max_seq {ecfg.max_seq}, "
          f"prefill_chunk {ecfg.prefill_chunk}, page {eng.page_size}, pool "
          f"{eng.pool.num_pages} pages "
          f"({eng.stats_summary()['pool_bytes'] / 1e9:.3f} GB KV)")
    # warm-up request (cuBLAS handles, allocator), untimed
    eng.submit(make_prompts((64,), cfg.vocab, seed=1)[0], 2)
    eng.run()
    eng.reset_stats()

    lens = SPEC_LENS
    prompts = make_prompts(lens, cfg.vocab, seed=2)
    eng.trace_logits = True
    reqs = [eng.submit(p, 32) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moa.LAUNCHES = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = moa.LAUNCHES
    st = eng.stats_summary()
    check(all(r.slot is None and len(r.generated) == 32 for r in reqs),
          "full width: a request did not retire with 32 tokens")
    check(all(np.isfinite(t).all() for t in eng.logit_trace),
          "full width: a decode logit is not finite")
    dispatches = st["prefill_dispatches"] + st["decode_steps"]
    check(launches == 2 * cfg.n_layers * dispatches,
          f"full width: moa_reduce launched {launches} times, expected "
          f"2 * {cfg.n_layers} * {dispatches}")
    check(st["pages_in_use"] == 0, "full width: pages left allocated")
    print(f"[full] {len(reqs)} requests, prompt lens {list(lens)}, 32 new "
          f"tokens each: all retired; wall {wall:.3f} s")
    print(f"[full] prefill {st['prefill_tokens']} tok in "
          f"{st['prefill_dispatches']} dispatches, {st['prefill_s']:.4f} s "
          f"= {st['prefill_tok_s']:.1f} tok/s; decode {st['decode_tokens']} "
          f"tok in {st['decode_steps']} steps, {st['decode_s']:.4f} s = "
          f"{st['decode_tok_s']:.1f} tok/s "
          f"({1e3 * st['decode_s'] / st['decode_steps']:.3f} ms/step)")
    print(f"[full] moa_reduce launches {launches} = 2 * {cfg.n_layers} * "
          f"({st['prefill_dispatches']} + {st['decode_steps']}); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")
    chunk_s = st["prefill_s"] / st["prefill_dispatches"]
    step_s = st["decode_s"] / st["decode_steps"]
    _free(eng)
    return launches, params, chunk_s, step_s, _tokens(reqs)




def phase_contiguous(cfg, params, paged_tokens):
    """Phase G at full width on phase 6's weights.  G1: phase 6's traffic
    and geometry on contiguous slots read as pages of 128 (split-K over
    dense rows); its tokens equal phase 6's paged ones.  G2: the same with
    page 0 (one softmax, no page combine).  G3: generate, the per-token
    loop, on 4 equal prompts, and an engine on the same prompts.  Each
    engine is warmed up (``warmup``) before its counted run.  Returns
    (summary rows, launches by run)."""
    prompts = make_prompts(SPEC_LENS, cfg.vocab, seed=2)
    rows, launches, toks = {}, {}, {}
    for name, knobs in (("G1 contiguous split-K",
                         dict(paged_kv=False, page_size=128)),
                        ("G2 contiguous dense", dict(page_size=0))):
        eng = ServeEngine(cfg, params, config=EngineConfig(
            max_slots=4, max_seq=2048, prefill_chunk=256,
            prefix_cache=False, **knobs))
        check(not eng.paged, f"{name}: the engine resolved paged_kv=True")
        eng.warmup()
        check(all(v == 0 for v in eng.stats.values()),
              f"{name}: warmup moved a counter")
        eng.trace_logits = True
        reqs = [eng.submit(p, QUANT_NEW) for p in prompts]
        n = _counted_run(eng, eng.run)
        _check_launches(eng, n, name)
        check(all(r.slot is None and len(r.generated) == QUANT_NEW
                  for r in reqs), f"{name}: a request did not retire")
        check(all(np.isfinite(t).all() for t in eng.logit_trace),
              f"{name}: a decode logit is not finite")
        st = eng.stats_summary()
        toks[name] = _tokens(reqs)
        rows[name] = dict(_serve_row(st), launches=n,
                          prefix_bytes_copied=st["prefix_bytes_copied"],
                          page=eng.page_size)
        launches[name] = n
        print(f"[contig] {name} (page {eng.page_size}, "
              f"{st['kv_bytes_per_slot']} bytes a slot): {_serve_line(st)};"
              f" prefix_bytes_copied {st['prefix_bytes_copied']}; "
              f"moa_reduce launches {n}")
        _free(eng)
    g1, g2 = toks["G1 contiguous split-K"], toks["G2 contiguous dense"]
    check(g1 == paged_tokens, "G1: the contiguous split-K engine's tokens "
                              "differ from phase 6's paged tokens")
    same = sum(a == b for a, b in zip(g2, g1))
    print(f"[contig] G1 tokens == phase 6's paged tokens in "
          f"{len(g1)} of {len(g1)} requests (asserted); G2 (one softmax) "
          f"equal to G1 in {same} of {len(g1)} requests (reported)")

    # G3: the per-token baseline, split-K over pages of the page that
    # divides its cache (auto_page_size of prompt + new tokens)
    page = auto_page_size(GEN_PROMPT + GEN_NEW)
    gcfg = dataclasses.replace(cfg, decode_page_size=page)
    gp = make_prompts((GEN_PROMPT,) * GEN_ROWS, cfg.vocab, seed=30)
    _zero_kernel_counts()
    ids, gst = generate(gcfg, params, np.asarray(gp), GEN_NEW)
    _sync()
    n = moa.LAUNCHES
    # one dispatch a position and one warm-up
    disp = GEN_PROMPT + GEN_NEW
    _check_count(params["embed"].device,
                 n == 2 * cfg.n_layers * disp and not any(
                     v for k, v in _kernel_counts().items()
                     if k != "moa_reduce"),
                 f"G3 generate: moa_reduce launched {n} times, expected 2 * "
                 f"{cfg.n_layers} * {disp} (page {page})")
    eng = ServeEngine(cfg, params, config=EngineConfig(
        max_slots=4, max_seq=2048, prefill_chunk=256, prefix_cache=False,
        paged_kv=False, page_size=128))
    eng.warmup()
    reqs = [eng.submit(p, GEN_NEW) for p in gp]
    n_eng = _counted_run(eng, eng.run)
    _check_launches(eng, n_eng, "G3 engine")
    est = eng.stats_summary()
    _free(eng)
    same = sum(list(ids[i, GEN_PROMPT:]) == r.generated
               for i, r in enumerate(reqs))
    rows["G3 generate"] = {"prefill_tok_s": gst["prefill_tok_s"],
                           "decode_tok_s": gst["decode_tok_s"],
                           "prefill_s": gst["prefill_s"],
                           "decode_s": gst["decode_s"], "launches": n,
                           "page": page, "equal_to_engine": same}
    rows["G3 engine"] = dict(_serve_row(est), launches=n_eng)
    launches["G3 generate"] = n
    launches["G3 engine"] = n_eng
    print(f"[contig] G3 generate ({len(gp)} x {GEN_PROMPT} prompt + "
          f"{GEN_NEW} new, page {page}): prefill {gst['prefill_s']:.4f} s ="
          f" {gst['prefill_tok_s']:.1f} tok/s, decode {gst['decode_s']:.4f} s"
          f" = {gst['decode_tok_s']:.1f} tok/s; moa_reduce launches {n} = "
          f"2 * {cfg.n_layers} * {disp} dispatches (asserted)")
    print(f"[contig] G3 engine on the same prompts (contiguous split-K, "
          f"page 128): {_serve_line(est)}; launches {n_eng}; generate's "
          f"tokens equal the engine's in {same} of {len(gp)} requests "
          f"(reported: other prefill cuts)")
    return rows, launches


#: phase K: the shards' devices (both shards on the one card) and the
#: near-tie rule a differing token must meet (bf16 ulp of its logit)
MESH_DEVICES = ("cuda:0", "cuda:0")
MESH_TIE_ULPS = 2


def mesh_engine(cfg, params, **knobs):
    return ServeEngine(cfg, params, config=EngineConfig(**dict(dict(
        max_slots=4, max_seq=2048, prefill_chunk=256, prefix_cache=False,
        mesh_shards=2), **knobs)), devices=list(MESH_DEVICES))


def phase_mesh_serve(cfg, params, paged_tokens, step_s):
    """Phase K at full width on phase 6's weights: two shards on the one
    card.  K1 phase 6's traffic (its tokens ``paged_tokens``, its mean
    step ``step_s`` seconds), K2 shared prefixes on each shard, K3 the
    reduced config, two shards against one.  Returns (summary rows,
    launches by run)."""
    rows, launches = {}, {}
    # ---- K1: phase 6's traffic on two shards
    prompts = make_prompts(SPEC_LENS, cfg.vocab, seed=2)
    eng = mesh_engine(cfg, params)
    eng.warmup()
    check(all(v == 0 for v in eng.stats.values()),
          "K1: warmup moved a counter")
    eng.trace_logits = True
    reqs = [eng.submit(p, 32) for p in prompts]
    torch.cuda.reset_peak_memory_stats()

    def drive():
        while eng.scheduler.has_work:
            eng.step()
            refcount_check(eng, "K1")

    n = _counted_run(eng, drive)
    st = eng.stats_summary()
    check(all(r.slot is None and len(r.generated) == 32 for r in reqs),
          "K1: a request did not retire with 32 tokens")
    check(all(np.isfinite(t).all() for t in eng.logit_trace),
          "K1: a decode logit is not finite")
    check(st["pages_in_use"] == 0, "K1: pages left allocated")
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    _check_launches(eng, n, "K1")
    toks = _tokens(reqs)
    where = divergence(cfg, params, prompts, paged_tokens, toks)
    check(all(abs(w["gap"]) <= MESH_TIE_ULPS * w["ulp"] for w in where),
          f"K1: a token parts from phase 6's at more than {MESH_TIE_ULPS}"
          f" bf16 ulp: {where}")
    step_ms = 1e3 * st["decode_s"] / st["decode_steps"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    same = sum(a == b for a, b in zip(toks, paged_tokens))
    rows["K1"] = dict(_serve_row(st), launches=n, step_ms=step_ms,
                      phase6_step_ms=1e3 * step_s,
                      decode_dispatches=st["decode_dispatches"],
                      shard_lane_steps=st["shard_lane_steps"],
                      skew=st["shard_occupancy_skew"], peak_gb=peak,
                      equal_to_phase6=same, divergence=where)
    launches["K1"] = n
    print(f"[mesh] K1 2 shards x 2 slots on {list(MESH_DEVICES)}: "
          f"{_serve_line(st)}; {step_ms:.3f} ms a step (phase 6: "
          f"{1e3 * step_s:.3f}, x{step_ms / (1e3 * step_s):.3f}); decode "
          f"dispatches "
          f"{st['decode_dispatches']} over {st['decode_steps']} steps; "
          f"lane steps a shard {st['shard_lane_steps']} (skew "
          f"{st['shard_occupancy_skew']:.3f}); moa_reduce launches {n} = "
          f"2 * {cfg.n_layers} * ({st['prefill_dispatches']} + "
          f"{st['decode_dispatches']}) = 2 * {cfg.n_layers} * {dispatches}"
          f"; max_memory_allocated {peak:.3f} GB; requests with phase 6's "
          f"tokens {same} of {len(toks)}")
    if where:
        print(f"[mesh] K1 first token unlike phase 6's (request, index, "
              f"logit gap, bf16 ulp): "
              f"{[(w['request'], w['index'], round(w['gap'], 4), w['ulp']) for w in where]}")
    _free(eng)

    # ---- K2: a shared prefix placed on each shard
    rng = np.random.default_rng(40)
    pre = [rng.integers(0, cfg.vocab, 512).tolist() for _ in range(2)]

    def tail(k):
        return rng.integers(0, cfg.vocab, k).tolist()

    eng = mesh_engine(cfg, params, prefix_cache=True)
    eng.warmup()

    def wave(prompts_):
        rs = [eng.submit(p, 8) for p in prompts_]
        eng.run()
        refcount_check(eng, "K2")
        return rs

    def drive2():
        # free slots fill 0 (shard 0), 2 (shard 1), 1, 3 on idle shards
        first = wave([pre[0] + tail(64), pre[1] + tail(96)])
        hits0 = eng.stats["prefix_hits"]
        second = wave([pre[0] + tail(80), pre[1] + tail(48)])
        hits = eng.stats["prefix_hits"] - hits0
        ctx = pre[1] + tail(72)
        n_any, src = eng.prefix.longest_match(ctx, touch=False)
        misses0 = eng.stats["prefix_misses"]
        third = wave([ctx])
        return (first, second, third, hits, n_any, src,
                eng.stats["prefix_misses"] - misses0)

    out = {}
    n2 = _counted_run(eng, lambda: out.update(r=drive2()))
    first, second, third, hits, n_any, src, missed = out["r"]
    st = eng.stats_summary()
    check(hits == 2, f"K2: the re-admissions hit {hits} times, expected 2 "
                     f"(one on each shard)")
    check(n_any >= 512 and eng._slot_shard(src) == 1 and missed == 1
          and third[0].slot is None,
          f"K2: the third request (shard 0) should miss its prefix, "
          f"resident only on shard 1: longest match {n_any} at slot {src}, "
          f"misses {missed}")
    _check_launches(eng, n2, "K2")
    rows["K2"] = dict(_serve_row(st), launches=n2,
                      prefix_hits=st["prefix_hits"],
                      prefix_misses=st["prefix_misses"],
                      prefix_reused_tokens=st["prefix_reused_tokens"],
                      shard_lane_steps=st["shard_lane_steps"])
    launches["K2"] = n2
    print(f"[mesh] K2 prefix cache on: {st['prefix_hits']} hits (both "
          f"same-shard) / {st['prefix_misses']} misses, "
          f"{st['prefix_reused_tokens']} tokens reused; a 512-token prefix "
          f"resident on shard 1 (slot {src}) refused to a shard-0 admission"
          f"; moa_reduce launches {n2}")
    _free(eng)

    # ---- K3: the reduced fp32 config on the card, two shards against one
    rcfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                             n_kv_heads=2)
    dev = params["embed"].device
    rparams = init_params(get_api(rcfg).param_specs(rcfg),
                          torch.Generator(device=dev).manual_seed(0), dev,
                          torch.float32)
    rp = spec_prompts((40, 24, 56, 32, 48, 16), rcfg.vocab, seed=41,
                      passage=8)
    for knobs in (dict(), dict(spec_k=3)):
        got = {}
        for shards in (1, 2):
            e = ServeEngine(rcfg, rparams, config=EngineConfig(**dict(dict(
                max_slots=4, max_seq=128, prefill_chunk=16, page_size=16,
                mesh_shards=shards), **knobs)),
                devices=list(MESH_DEVICES) if shards > 1 else None)
            e.warmup()
            rs = [e.submit(p, 12) for p in rp]
            nk = _counted_run(e, e.run)
            _check_launches(e, nk, "K3")
            got[shards] = _tokens(rs)
            name = f"K3 {'chain' if knobs else 'sequential'} {shards} shard"
            launches[name] = nk
        check(got[1] == got[2], f"K3 {knobs}: two shards' tokens differ "
                                f"from one shard's")
    print(f"[mesh] K3 reduced fp32 llama (TF32 off), sequential and chain "
          f"(spec_k 3): 2-shard tokens == 1-shard tokens (asserted)")
    return rows, launches


def phase_shared_prefix(cfg, params):
    """Phase A at full width: cold, warm and dedup engines, one at a
    time.  Returns the launches of each run."""
    tr = FULL_TRAFFIC
    prompts = shared_prefix_prompts(tr, cfg.vocab, seed=20)
    runs, launches = {}, {}
    for name, knobs in (("cold", dict(prefix_cache=False)), ("warm", {}),
                        ("dedup", dict(prefix_cache=False,
                                       page_dedup=True))):
        eng, reqs, launched = serve_shared_prefix(cfg, params, "cuda", tr,
                                                  prompts, **knobs)
        _check_launches(eng, launched, f"shared prefix {name}")
        check(all(len(r.generated) == tr.new for r in reqs)
              and all(np.isfinite(t).all() for t in eng.logit_trace),
              f"shared prefix {name}: a request fell short or a logit is "
              f"not finite")
        st = eng.stats_summary()
        runs[name] = (_tokens(reqs), st, eng.hash_s)
        launches[name] = launched
        print(f"[prefix] {name}: prefill {st['prefill_tokens']} tok in "
              f"{st['prefill_dispatches']} dispatches, {st['prefill_s']:.4f} "
              f"s = {st['prefill_tok_s']:.1f} tok/s (effective "
              f"{st['effective_prefill_tok_s']:.1f}); decode "
              f"{st['decode_steps']} steps, p50 "
              f"{1e3 * st['decode_step_p50_s']:.3f} ms, p99 "
              f"{1e3 * st['decode_step_p99_s']:.3f} ms; hits "
              f"{st['prefix_hits']} / misses {st['prefix_misses']}, reused "
              f"{st['prefix_reused_tokens']}, pages shared "
              f"{st['pages_shared']}, cow {st['pages_cow']}, bytes copied "
              f"{st['prefix_bytes_copied']}; hit admit p50 "
              f"{1e3 * st['hit_admit_s_p50']:.3f} ms, cold admit p50 "
              f"{1e3 * st['cold_admit_s_p50']:.3f} ms; dedup pages "
              f"{st['dedup_pages_shared']} (hits {st['dedup_hits']}, "
              f"collisions {st['dedup_hash_collisions']}); moa_reduce "
              f"launches {launched}")
        _free(eng)
    (cold, _, _), (warm, wst, _), (dedup, dst, hash_s) = (
        runs["cold"], runs["warm"], runs["dedup"])
    check(warm == cold, "shared prefix: warm tokens differ from cold")
    check(dedup == cold, "shared prefix: dedup tokens differ from cold")
    n, k = tr.requests, tr.system
    check(wst["prefix_hits"] == n - 1 and wst["prefix_misses"] == 1
          and wst["prefix_reused_tokens"] == (n - 1) * k
          and wst["pages_cow"] == 0 and wst["prefix_bytes_copied"] == 0,
          f"shared prefix warm: hits {wst['prefix_hits']}, misses "
          f"{wst['prefix_misses']}, reused {wst['prefix_reused_tokens']}, "
          f"cow {wst['pages_cow']}, bytes {wst['prefix_bytes_copied']}")
    per = k // tr.page
    check(0 < wst["pages_shared"] <= (n - 1) * per
          and wst["pages_shared"] % per == 0,
          f"shared prefix warm: pages_shared {wst['pages_shared']}")
    check(dst["prefix_hits"] == 0 and dst["dedup_hash_collisions"] == 0
          and dst["dedup_pages_shared"] > 0
          and dst["dedup_pages_shared"] % per == 0,
          f"shared prefix dedup: hits {dst['prefix_hits']}, pages "
          f"{dst['dedup_pages_shared']}, collisions "
          f"{dst['dedup_hash_collisions']}")
    per_admit = (hash_s["to_host"] + hash_s["blake2b"]) / dst["admissions"]
    print(f"[prefix] warm and dedup tokens == cold over {n} requests; warm "
          f"pages shared by reference {wst['pages_shared']} (<= "
          f"{(n - 1) * per}), dedup pages shared by content "
          f"{dst['dedup_pages_shared']}; prefill tok/s cold "
          f"{runs['cold'][1]['prefill_tok_s']:.1f} warm "
          f"{wst['prefill_tok_s']:.1f} (effective "
          f"{wst['effective_prefill_tok_s']:.1f}); dedup hashing "
          f"{hash_s['pages']} pages: to the host {hash_s['to_host']:.4f} s, "
          f"blake2b {hash_s['blake2b']:.4f} s, together {1e3 * per_admit:.3f}"
          f" ms per admission ({dst['admissions']} admissions)")
    return launches


def phase_sessions(cfg, params):
    """Phase B at full width, both pools.  Returns the launches of each
    run."""
    tr = FULL_TRAFFIC
    turns = session_turns(tr, cfg.vocab, seed=21)
    runs, launches = {}, {}
    for pool in tr.pools:
        eng, reqs, launched, released = serve_sessions(cfg, params, "cuda",
                                                       tr, turns, pool)
        _check_launches(eng, launched, f"sessions pool {pool}")
        st = eng.stats_summary()
        check(released, f"sessions pool {pool}: end_session did not release "
                        f"exactly the snapshots' references")
        check(st["session_turns"] == tr.convs * tr.turns
              and all(len(r.generated) == tr.reply for r in reqs),
              f"sessions pool {pool}: {st['session_turns']} turns, not all "
              f"complete")
        returning = tr.convs * (tr.turns - 1)
        if pool == max(tr.pools):
            check(st["session_snapshot_drops"] == 0
                  and st["session_hits"] + st["prefix_hits"] == returning
                  and st["session_hits"] > 0,
                  f"sessions pool {pool}: drops "
                  f"{st['session_snapshot_drops']}, session hits "
                  f"{st['session_hits']} + prefix hits {st['prefix_hits']} "
                  f"!= {returning}")
        else:
            check(st["session_snapshot_drops"] > 0,
                  f"sessions pool {pool}: no snapshot dropped")
        runs[pool] = _tokens(reqs)
        launches[pool] = launched
        print(f"[sessions] pool {pool}: {st['session_turns']} turns, session "
              f"hits {st['session_hits']} ({st['session_reused_tokens']} "
              f"tokens), prefix hits {st['prefix_hits']}, snapshot drops "
              f"{st['session_snapshot_drops']}, pages shared "
              f"{st['pages_shared']}, cow {st['pages_cow']}; prefill "
              f"{st['prefill_tokens']} tok {st['prefill_s']:.4f} s, decode "
              f"p50 {1e3 * st['decode_step_p50_s']:.3f} ms; refcounts held "
              f"after every step; moa_reduce launches {launched}")
        _free(eng)
    big, small = (runs[p] for p in tr.pools)
    same = sum(a == b for a, b in zip(big, small))
    print(f"[sessions] token agreement pool {tr.pools[0]} vs "
          f"{tr.pools[1]}: {same} of {len(big)} turns equal (a dropped "
          f"snapshot re-prefills with another cut; reported, not asserted)")
    return launches


def phase_overload(cfg, params, chunk_s, step_s):
    """Phase C at full width on phase 6's prices.  Returns the launches of
    each run."""
    tr = FULL_TRAFFIC
    trace = overload_trace(tr, cfg.vocab, chunk_s, step_s, seed=22)
    runs, launches = {}, {}
    for degrade in (False, True):
        eng, reqs, launched = serve_overload(cfg, params, "cuda", tr, trace,
                                             chunk_s, step_s, degrade)
        _check_launches(eng, launched, f"overload degrade={degrade}")
        st = eng.stats_summary()
        runs[degrade] = (reqs, st, eng.pieces_log, eng.victims,
                         eng.max_level)
        launches[degrade] = launched
        print(f"[overload] degrade={degrade}: {len(trace)} arrivals over "
              f"{eng.virtual_s:.3f} virtual s; SLO met {st['slo_met']} / "
              f"missed {st['slo_missed']}, shed {st['shed_requests']}, "
              f"goodput {st['goodput_tokens']} tokens, preemptions "
              f"{st['preemptions']}, ladder transitions "
              f"{st['degrade_transitions']} (highest level "
              f"{runs[degrade][4]}), degraded steps {st['degrade_steps']}; "
              f"prefill dispatches {st['prefill_dispatches']}, decode steps "
              f"{st['decode_steps']}; moa_reduce launches {launched}")
        _free(eng)
    (off, ost, opieces, _, _), (on, nst, npieces, victims, top) = (
        runs[False], runs[True])
    check(ost["slo_missed"] > 0, "overload: the ladder-off engine met every "
                                 "SLO, so the trace is no overload")
    check(top >= 2, f"overload: the ladder reached level {top}, not "
                    f"small_chunks")
    shed = [r for r in on if r.shed_reason is not None]
    check(len(shed) == nst["shed_requests"]
          and all(not r.generated and r.slo_met is False for r in shed),
          "overload: a shed request emitted tokens or lacks its reason")
    check(nst["preemptions"] >= 1 and victims
          and all(len(on[i].generated) == on[i].max_new for i in victims),
          f"overload: preemptions {nst['preemptions']}, a victim did not "
          f"complete")
    same_cut = [i for i, r in enumerate(on) if r.shed_reason is None
                and npieces.get(i) == opieces.get(i)]
    check(all(on[i].generated == off[i].generated for i in same_cut),
          "overload: a request with the ladder-off run's prefill pieces has "
          "other tokens")
    others = [i for i, r in enumerate(on) if r.shed_reason is None
              and i not in same_cut]
    agree = sum(on[i].generated == off[i].generated for i in others)
    # every re-admission of a preempted request: where its first piece
    # starts (0 is a full re-prefill, more is a prefix reuse)
    starts = [p[0][0] for i in sorted(set(victims)) for p in npieces[i][1:]]
    reused = sum(1 for a in starts if a > 0)
    check(reused >= 1, f"overload: no preempted request re-admitted through "
                       f"its resident prefix (first pieces at {starts})")
    print(f"[overload] ladder reached level {top}; shed {len(shed)} pending "
          f"requests, each with no tokens and a reason; {len(victims)} "
          f"preemptions of requests {sorted(set(victims))}, each completed; "
          f"{len(starts)} re-admissions, {reused} reusing a prefix "
          f"(first piece at {starts}); goodput with the ladder "
          f"{nst['goodput_tokens']} tokens, without {ost['goodput_tokens']} "
          f"(reported: with speculative decode not ported, the ladder's "
          f"spec_off level saves nothing and small_chunks only adds "
          f"dispatches); {len(same_cut)} served requests with the ladder-off "
          f"run's pieces have its tokens; {agree} of the {len(others)} "
          f"others agree")
    return launches


#: phase D: prompt lengths (as phase 6's), new tokens (64 until the smoke
#: took 1331.4 s of phases on a slow host, 32 until it took 1151.4 s with
#: phase X7; also F's, M2's and Q's speculative runs), and the draft-head
#: fit (4 heads of width 64 on the last FIT_WINDOW tokens of each
#: sequential history, FIT_STEPS full-batch Adam steps)
SPEC_LENS = (1024, 128, 768, 256, 896, 384, 640, 512)
SPEC_NEW, FIT_WINDOW, FIT_STEPS = 16, 256, 100


def serve_spec(cfg, params, knobs, prompts, what, new=SPEC_NEW,
               sampling=None, trace=False, record=None):
    """One full-width engine (phase 6's geometry, ``knobs`` over it)
    serving ``prompts`` x ``new`` tokens, each request with ``sampling``:
    a warm-up request first (untimed), then the traffic, stepped with the
    refcount invariant after every step and every logit's finiteness held
    on the card (``trace``: decode logits kept in ``logit_trace``; a
    ``record`` list: every decode and verify dispatch's live slots, batch
    and logits, kept on the card for :func:`drawn_rows`).  Returns
    (engine, requests, moa_reduce launches)."""
    eng = ServeEngine(cfg, params, config=EngineConfig(**dict(dict(
        max_slots=4, max_seq=2048, prefill_chunk=256, prefix_cache=False),
        **knobs)))
    eng.submit(spec_prompts((192,), cfg.vocab, seed=3)[0], 16,
               sampling=sampling)
    eng.run()
    eng.reset_stats()
    eng.trace_logits = trace
    finite = [torch.ones((), dtype=torch.bool, device=eng.device)]
    api = eng.api

    def held(fn):
        def call(params, state, batch, cfg, **kw):
            out = fn(params, state, batch, cfg, **kw)
            finite[0] &= torch.isfinite(out[0]).all()
            if record is not None:
                record.append((dict(eng.scheduler.active), batch, out[0]))
            return out
        return call

    eng.api = dataclasses.replace(
        api, decode_step=held(api.decode_step),
        verify_chunk=held(api.verify_chunk),
        verify_tree=held(api.verify_tree))
    reqs = [eng.submit(p, new, sampling=sampling) for p in prompts]

    def drive():
        while eng.scheduler.has_work:
            eng.step()
            refcount_check(eng, what)

    launches = _counted_run(eng, drive)
    _check_launches(eng, launches, what)
    check(all(r.slot is None and len(r.generated) == new
              for r in reqs), f"{what}: a request did not retire with "
                              f"{new} tokens")
    check(bool(finite[0]), f"{what}: a decode or verify logit is not "
                           f"finite")
    # with the prefix cache, retired rows stay resident for later hits
    check(eng.prefix is not None or eng.pool.used_count == 0,
          f"{what}: pages left allocated")
    return eng, reqs, launches


def phase_spec_serve(cfg, params):
    """Phase D at full width on phase 6's weights: the sequential engine,
    then chain, tree, auto and draft-head speculative engines on one
    traffic of repeated passages.  Returns (per-run summary rows, the
    launches of each run, the chain run's step p50 in seconds)."""
    prompts = spec_prompts(SPEC_LENS, cfg.vocab, seed=23)
    rows, launches, seq = {}, {}, None
    for name in ["sequential"] + list(SPEC_RUNS):
        knobs = SPEC_RUNS.get(name, {})
        p = params
        if name == "heads":
            _sync()
            t0 = time.perf_counter()
            streams = [r.context[-FIT_WINDOW:] for r in seq_reqs]
            fitted = fit_draft_heads(cfg, params, streams, n_heads=4,
                                     head_dim=64, steps=FIT_STEPS, seed=0)
            _sync()
            fit_s = time.perf_counter() - t0
            p = dict(params, draft_heads=fitted)
            print(f"[spec] draft heads: 4 x {cfg.d_model} -> 64 -> "
                  f"{cfg.d_model}, fitted on the card on {len(streams)} "
                  f"sequential histories (last {FIT_WINDOW} tokens each), "
                  f"{FIT_STEPS} full-batch Adam steps in {fit_s:.2f} s")
        eng, reqs, launched = serve_spec(cfg, p, knobs, prompts,
                                         f"spec {name}")
        st = eng.stats_summary()
        if name == "sequential":
            seq, seq_reqs = _tokens(reqs), reqs
        elif name in ("tree", "auto"):
            check(eng._tree_width() == verify_rows(eng.config)["tree"],
                  f"spec {name}: tree width {eng._tree_width()}")
        same = sum(a == b for a, b in zip(_tokens(reqs), seq))
        where = divergence(cfg, params, prompts, seq, _tokens(reqs))
        rows[name] = {
            "decode_tok_s": st["decode_tok_s"],
            "step_p50_ms": 1e3 * st["decode_step_p50_s"],
            "step_p99_ms": 1e3 * st["decode_step_p99_s"],
            "tokens_per_step": st["tokens_per_step"],
            "decode_steps": st["decode_steps"],
            "accept_rate": st["spec_accept_rate"],
            "draft_hit_rate": st["spec_draft_hit_rate"],
            "rolled_back": st["spec_pages_rolled_back"],
            "shapes": [st["spec_shape_chain"], st["spec_shape_tree"]],
            "equal_to_sequential": same, "launches": launched,
            "divergence": where}
        launches[name] = launched
        print(f"[spec] {name}: decode {st['decode_tokens']} tok in "
              f"{st['decode_steps']} steps, {st['decode_s']:.4f} s = "
              f"{st['decode_tok_s']:.1f} tok/s; step p50 "
              f"{1e3 * st['decode_step_p50_s']:.3f} ms, p99 "
              f"{1e3 * st['decode_step_p99_s']:.3f} ms; "
              f"{st['tokens_per_step']:.3f} tokens/step; accept rate "
              f"{st['spec_accept_rate']:.4f}, draft hit rate "
              f"{st['spec_draft_hit_rate']:.4f}; drafted "
              f"{st['spec_drafted']}, accepted {st['spec_accepted']}; "
              f"pages rolled back {st['spec_pages_rolled_back']}; shape "
              f"picks chain {st['spec_shape_chain']} / tree "
              f"{st['spec_shape_tree']}; prefill {st['prefill_dispatches']}"
              f" dispatches; requests with the sequential tokens {same} of "
              f"{len(reqs)}; moa_reduce launches {launched}")
        if where:
            print(f"[spec] {name}: first token unlike the sequential run's, "
                  f"(request, index, logit gap, bf16 ulp): "
                  f"{[(w['request'], w['index'], round(w['gap'], 4), w['ulp']) for w in where]}")
        _free(eng)
    return rows, launches, rows["chain"]["step_p50_ms"] / 1e3


def divergence(cfg, params, prompts, seq, toks):
    """Where each request's greedy tokens first leave the sequential run's:
    the index, and in one teacher-forced pass over the sequential context
    before it (``lm.hidden_states``, bf16 logits as the engine takes them)
    the logit of the sequential token less that of the other token, beside
    one bf16 ulp at that logit.  A gap within an ulp or two is a near tie
    that another accumulation order (C = 5 or 17 rows against 1) may
    flip."""
    out = []
    head = params["lm_head"]
    for r, (p, a, b) in enumerate(zip(prompts, seq, toks)):
        i = _parting(a, b)
        if i is None:
            continue
        ctx = torch.tensor([p + a[:i]], device=head.device)
        with torch.no_grad():
            x = hidden_states(params, cfg, ctx)[0, -1]
            logits = (x.to(head.dtype) @ head).float()
        top = float(logits[a[i]])
        out.append({"request": r, "index": i,
                    "gap": top - float(logits[b[i]]),
                    "ulp": (2.0 ** (math.floor(math.log2(abs(top))) - 7)
                            if top else 0.0)})
    return out


def _parting(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def drawn_rows(record, reqs):
    """The logits row each request's token ``i`` was drawn from, by
    ``(request, i)``, from a :func:`serve_spec` ``record``: a dispatch row
    counts when every fed token on its path (the chain before it, or its
    tree ancestors) is the request's final stream at that position, and the
    first such row of an index is the one whose draw was emitted (later
    ones are a tree's chain rows drawing an emitted index again)."""
    number = {id(r): n for n, r in enumerate(reqs)}
    streams = [list(r.prompt) + r.generated for r in reqs]
    out = {}
    for active, batch, logits in record:
        tokens = batch["tokens"].cpu().numpy()
        index = batch["index"].cpu().numpy()
        c = tokens.shape[1]
        parents = (batch["parents"].cpu().numpy() if "parents" in batch
                   else np.broadcast_to(np.arange(c) - 1, tokens.shape))
        pos_off = (batch["pos_off"].cpu().numpy() if "pos_off" in batch
                   else np.broadcast_to(np.arange(c), tokens.shape))
        nspec = (batch["nspec"].cpu().numpy() if "nspec" in batch
                 else np.ones(len(tokens), np.int64))
        rows = logits if logits.dim() == 3 else logits[:, None]
        for slot, req in active.items():
            n = number.get(id(req))
            if n is None:
                continue
            stream, lp = streams[n], len(req.prompt)
            for j in range(int(nspec[slot])):
                q, ok = j, True
                while q >= 0 and ok:
                    at = int(index[slot] + pos_off[slot, q])
                    ok = at < len(stream) and stream[at] == tokens[slot, q]
                    q = int(parents[slot, q])
                i = int(index[slot] + pos_off[slot, j]) + 1 - lp
                if ok and 0 <= i < len(req.generated) and (n, i) not in out:
                    out[(n, i)] = rows[slot, j].clone()
    return out


def rank_draw(logits, sp, index):
    """``sample_tokens``' draw of one logits row, in its rank space: the
    stable descending order, and per rank the scaled logit plus the Gumbel
    noise that ``(seed, index)`` gives that rank (-inf past top-k and the
    nucleus).  Returns (order, scores)."""
    v = logits.shape[-1]
    order = torch.sort(-logits, stable=True).indices
    scaled = logits[order] / max(sp.temperature, 1e-6)
    ranks = torch.arange(v, device=logits.device)
    keep = ranks < (sp.top_k if sp.top_k > 0 else v)
    e = torch.exp(scaled - scaled.max())
    probs = e / e.sum()
    keep &= (torch.cumsum(probs, 0) - probs) < sp.top_p
    keep[0] = True
    key = prng.fold_in(prng.prng_key(torch.tensor(
        [sp.seed], device=logits.device)), index)
    noise = prng.gumbel(key, v)[0]
    return order, torch.where(keep, scaled, -torch.inf) + noise


def sampled_divergence(seq, toks, seq_rows, run_rows, sp):
    """Where each sampled request first leaves the sequential run's, scored
    as the sampler scores it: each run's own logits row at that index
    (:func:`drawn_rows`) through :func:`rank_draw`.  Per parting: each
    run's winning rank and its margin over the runner-up, whether that
    rank's token is the run's token, the count of top-k ranks whose token
    differs between the two rows, and their largest |logit| difference."""
    out = []
    for r, (a, b) in enumerate(zip(seq, toks)):
        i = _parting(a, b)
        if i is None:
            continue
        row = {"request": r, "index": i}
        pair = (seq_rows.get((r, i)), run_rows.get((r, i)))
        if pair[0] is None or pair[1] is None:
            row["missing"] = [x is None for x in pair]
            out.append(row)
            continue
        draws = [rank_draw(x.float(), sp, i) for x in pair]
        row["win_rank"], row["margin"], row["drew_own_token"] = [], [], []
        for (order, score), tok in zip(draws, (a[i], b[i])):
            top2 = torch.topk(score, 2)
            row["win_rank"].append(int(top2.indices[0]))
            row["margin"].append(float(top2.values[0] - top2.values[1]))
            row["drew_own_token"].append(int(order[top2.indices[0]]) == tok)
        k = sp.top_k if sp.top_k > 0 else len(draws[0][0])
        row["top_k_ranks_differ"] = int((draws[0][0][:k]
                                         != draws[1][0][:k]).sum())
        row["max_logit_diff"] = float((pair[0].float() - pair[1].float())
                                      .abs().max())
        out.append(row)
    return out


def phase_overload_spec(cfg, params, chunk_s, trace_step_s, step_s):
    """Phase C's trace (built on phase 6's prices, ``chunk_s`` and
    ``trace_step_s``) once more with ``spec_k=4``, ladder off and on, on a
    virtual clock priced at phase 6's chunk time and phase D's chain step
    p50 (``step_s``).  Goodput and SLOs are printed, not asserted.
    Returns the launches and the summary of each run."""
    tr = FULL_TRAFFIC
    trace = overload_trace(tr, cfg.vocab, chunk_s, trace_step_s, seed=22)
    launches, out = {}, {}
    for degrade in (False, True):
        eng, reqs, launched = serve_overload(cfg, params, "cuda", tr, trace,
                                             chunk_s, step_s, degrade,
                                             spec_k=4)
        _check_launches(eng, launched, f"overload spec degrade={degrade}")
        st = eng.stats_summary()
        check(all(len(r.generated) == r.max_new for r in reqs
                  if r.shed_reason is None),
              f"overload spec degrade={degrade}: a request fell short")
        launches[degrade] = launched
        out[degrade] = {k: st[k] for k in (
            "slo_met", "slo_missed", "shed_requests", "goodput_tokens",
            "preemptions", "degrade_transitions", "decode_steps",
            "prefill_dispatches", "spec_steps", "tokens_per_step")}
        out[degrade]["max_level"] = eng.max_level
        out[degrade]["virtual_s"] = eng.virtual_s
        print(f"[overload spec] degrade={degrade}: {len(trace)} arrivals "
              f"over {eng.virtual_s:.3f} virtual s (step {1e3 * step_s:.3f}"
              f" ms, chunk {1e3 * chunk_s:.3f} ms); SLO met "
              f"{st['slo_met']} / missed {st['slo_missed']}, shed "
              f"{st['shed_requests']}, goodput {st['goodput_tokens']} "
              f"tokens, preemptions {st['preemptions']}, ladder "
              f"transitions {st['degrade_transitions']} (highest level "
              f"{eng.max_level}); decode steps {st['decode_steps']} "
              f"(speculative {st['spec_steps']}, "
              f"{st['tokens_per_step']:.3f} tokens/step); moa_reduce "
              f"launches {launched}")
        _free(eng)
    print(f"[overload spec] goodput with the ladder "
          f"{out[True]['goodput_tokens']} tokens, without "
          f"{out[False]['goodput_tokens']} (reported, not asserted)")
    return launches, out


#: phase E: phase 6's new tokens (its prompt lengths are SPEC_LENS); the
#: E3 sampling (the stochastic pair of the JAX package's bench_serve)
QUANT_NEW = 32
#: E1's and E2's new tokens a request: at QUANT_NEW phase E took
#: 62.2-102.3 s, at 16 (E3 too) 44.5-70.8 s, and phase X6 needs the room
E1_NEW = 8
E3_SAMPLING = SamplingParams(temperature=0.8, top_k=40, seed=7)
#: E3's new tokens a request: at D's 64 phase E took 91.3-97.7 s on an
#: H100 80GB HBM3 at 700 W, with the smoke near its 1200 s limit; at 32,
#: 102.3-113.6 s on a slow host; at 16, see E1_NEW
E3_NEW = 8


def kv_token_bytes(cfg, kv_dtype: str) -> int:
    """KV bytes a token at ``cfg``'s width in every layer: a row of
    values in the model's dtype, or int8 codes (int4: two a byte) plus the
    row's fp32 scale.  GQA keeps a row of ``hd`` for K and for V in each
    KV head; MLA one latent ``ckv`` row of ``kv_lora_rank`` and one shared
    rope-key row of ``qk_rope_dim``."""
    widths = ((cfg.kv_lora_rank, cfg.qk_rope_dim) if cfg.attn_kind == "mla"
              else (cfg.hd,) * (2 * cfg.n_kv_heads))
    row = {"fp32": lambda w: w * cfg.dtype.itemsize,
           "int8": lambda w: w + 4, "int4": lambda w: w // 2 + 4}[kv_dtype]
    return cfg.n_layers * sum(row(w) for w in widths)


def logit_drift(a: np.ndarray, b: np.ndarray) -> tuple:
    """(max, mean) |a - b| over the aligned decode logit traces (the JAX
    package's bench_serve probe: rows correspond step for step, since the
    runs schedule alike; after tokens part it measures free-running
    divergence)."""
    n = min(len(a), len(b))
    d = np.abs(a[:n].astype(np.float64) - b[:n].astype(np.float64))
    return float(d.max()), float(d.mean())


def _serve_row(st) -> dict:
    return {"prefill_tok_s": st["prefill_tok_s"],
            "decode_tok_s": st["decode_tok_s"],
            "step_p50_ms": 1e3 * st["decode_step_p50_s"],
            "step_p99_ms": 1e3 * st["decode_step_p99_s"],
            "tokens_per_step": st["tokens_per_step"],
            "decode_steps": st["decode_steps"],
            "prefill_dispatches": st["prefill_dispatches"],
            "pool_bytes": st["pool_bytes"],
            "kv_bytes_per_slot": st["kv_bytes_per_slot"]}


def _serve_line(st) -> str:
    return (f"prefill {st['prefill_tokens']} tok in "
            f"{st['prefill_dispatches']} dispatches = "
            f"{st['prefill_tok_s']:.1f} tok/s; decode {st['decode_tokens']} "
            f"tok in {st['decode_steps']} steps = {st['decode_tok_s']:.1f} "
            f"tok/s, step p50 {1e3 * st['decode_step_p50_s']:.3f} ms, p99 "
            f"{1e3 * st['decode_step_p99_s']:.3f} ms")


def phase_quant_serve(cfg, params):
    """Phase E at full width on phase 6's weights: E1 the pool dtypes on
    phase 6's traffic, E2 int8 on 8 slots within E1's bf16 pool bytes, E3
    sampled sequential (twice), chain and tree decode over an int8 pool.
    Returns (summary rows, launches by run)."""
    rows, launches = {}, {}
    prompts = make_prompts(SPEC_LENS, cfg.vocab, seed=2)
    base = None
    for kv in KV_DTYPES:
        what = f"E1 {kv}"
        eng, reqs, launched = serve_spec(cfg, params, dict(kv_dtype=kv),
                                         prompts, what, new=E1_NEW,
                                         trace=True)
        st = eng.stats_summary()
        per_token = kv_token_bytes(cfg, kv)
        check(st["pool_bytes"] == per_token * eng.pool.num_pages
              * eng.page_size and st["kv_bytes_per_slot"]
              == per_token * eng.max_seq,
              f"{what}: pool bytes {st['pool_bytes']} (slot "
              f"{st['kv_bytes_per_slot']}), expected {per_token} a token")
        trace = np.concatenate(eng.logit_trace, axis=0)
        toks = _tokens(reqs)
        if base is None:
            base = (toks, trace)
        same = sum(a == b for a, b in zip(toks, base[0]))
        drift = logit_drift(trace, base[1])
        rows[what] = dict(_serve_row(st), kv_dtype=kv,
                          bytes_per_token=per_token, launches=launched,
                          equal_to_unquantized=same, logit_drift=drift)
        launches[what] = launched
        print(f"[quant] {what}: pool {eng.pool.num_pages} pages = "
              f"{st['pool_bytes']} bytes ({per_token} a token, "
              f"{st['kv_bytes_per_slot']} a slot); {_serve_line(st)}; "
              f"requests with the unquantized tokens {same} of "
              f"{len(reqs)}; logit drift max {drift[0]:.4f} mean "
              f"{drift[1]:.5f}; moa_reduce launches {launched} = 2 * "
              f"{cfg.n_layers} * ({st['prefill_dispatches']} + "
              f"{st['decode_steps']})")
        _free(eng)
    bf16 = rows["E1 fp32"]
    page_bytes = kv_token_bytes(cfg, "int8") * 128
    pool_pages = bf16["pool_bytes"] // page_bytes - 1     # + scratch
    what = "E2 int8 8 slots"
    eng, reqs, launched = serve_spec(
        cfg, params, dict(kv_dtype="int8", max_slots=8,
                          pool_pages=pool_pages),
        make_prompts(SPEC_LENS * 2, cfg.vocab, seed=4), what,
        new=E1_NEW)
    st = eng.stats_summary()
    check(st["pool_bytes"] <= bf16["pool_bytes"],
          f"{what}: pool {st['pool_bytes']} bytes exceeds the bf16 pool's")
    rows[what] = dict(_serve_row(st), kv_dtype="int8", slots=8,
                      pool_pages=pool_pages, launches=launched,
                      decode_tok_s_over_bf16=st["decode_tok_s"]
                      / bf16["decode_tok_s"],
                      step_p50_over_bf16=1e3 * st["decode_step_p50_s"]
                      / bf16["step_p50_ms"])
    launches[what] = launched
    print(f"[quant] {what}: {pool_pages} pool pages, {st['pool_bytes']} "
          f"bytes (bf16 4 slots: {bf16['pool_bytes']}); 16 requests; "
          f"{_serve_line(st)}; mean occupancy {st['mean_occupancy']:.3f}; "
          f"decode tok/s {st['decode_tok_s'] / bf16['decode_tok_s']:.3f}x "
          f"and step p50 {rows[what]['step_p50_over_bf16']:.3f}x E1's "
          f"bf16 4-slot run; moa_reduce launches {launched}")
    _free(eng)
    prompts = spec_prompts(SPEC_LENS, cfg.vocab, seed=23)
    seq = seq_rows = None
    for name, knobs in (("sequential", {}), ("sequential again", {}),
                        ("chain", SPEC_RUNS["chain"]),
                        ("tree", SPEC_RUNS["tree"])):
        what = f"E3 sampled {name}"
        record = []
        eng, reqs, launched = serve_spec(cfg, params,
                                         dict(kv_dtype="int8", **knobs),
                                         prompts, what, new=E3_NEW,
                                         sampling=E3_SAMPLING, record=record)
        st = eng.stats_summary()
        toks = _tokens(reqs)
        drawn = drawn_rows(record, reqs)
        del record
        if seq is None:
            seq, seq_rows = toks, drawn
        elif name == "sequential again":
            check(toks == seq, f"{what}: the sampled tokens did not repeat")
        same = sum(a == b for a, b in zip(toks, seq))
        where = sampled_divergence(seq, toks, seq_rows, drawn, E3_SAMPLING)
        rows[what] = dict(_serve_row(st), launches=launched,
                          accept_rate=st["spec_accept_rate"],
                          equal_to_sequential=same, divergence=where)
        launches[what] = launched
        print(f"[quant] {what}: {_serve_line(st)}; "
              f"{st['tokens_per_step']:.3f} tokens/step, accept rate "
              f"{st['spec_accept_rate']:.4f} (drafted {st['spec_drafted']},"
              f" accepted {st['spec_accepted']}); requests with the "
              f"sampled sequential tokens {same} of {len(reqs)}; the "
              f"decode or verify row of {len(drawn)} of its "
              f"{sum(len(t) - 1 for t in toks)} draws after the first "
              f"found; moa_reduce launches {launched}")
        for w in where:
            print(f"[quant] {what}: parts from the sequential run at "
                  f"request {w['request']} index {w['index']}: "
                  + (f"no drawn row found (sequential, this run) "
                     f"{w['missing']}" if "missing" in w else
                     f"winning rank (sequential, this run) {w['win_rank']}, "
                     f"margin over the runner-up "
                     f"{[round(m, 4) for m in w['margin']]}, the rank's "
                     f"token is the run's {w['drew_own_token']}; "
                     f"{w['top_k_ranks_differ']} of the top-"
                     f"{E3_SAMPLING.top_k} ranks hold another token in the "
                     f"two rows; max |logit diff| "
                     f"{w['max_logit_diff']:.4f}"))
        del drawn
        _free(eng)
    return rows, launches


def mla_params(cfg):
    """minicpm3-4b's weights on the card: random, bf16, from seed 0."""
    t0 = time.perf_counter()
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         torch.device("cuda"), cfg.dtype)
    _sync()
    n_params = sum(t.numel() for t in leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"[mla] {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, q_lora_rank {cfg.q_lora_rank}, "
          f"kv_lora_rank {cfg.kv_lora_rank}, nope {cfg.qk_nope_dim}, rope "
          f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}: {n_params / 1e9:.3f} B params, "
          f"{nbytes / 1e9:.3f} GB {cfg.dtype}, initialized in "
          f"{time.perf_counter() - t0:.2f} s")
    return params


def phase_mla_serve(cfg, params):
    """Phase F: minicpm3-4b at its published width and ``MLA_LAYERS`` of
    its layers (``params`` from :func:`mla_params`) on phase 6's
    geometry.  Phase 6's traffic over
    bf16, int8 and int4 latent pools (pool bytes a token asserted exactly);
    phase A's shared-prefix traffic cold and warm (tokens equal); chain and
    tree on phase D's repeated passages; E3's sampling over int8,
    sequential twice (tokens equal).  Every run: the refcount invariant
    after every step, every request complete, no NaN logit, and no kernel
    launched.  Returns (summary rows, moa_reduce launches by run)."""
    rows, launches = {}, {}

    def run(name, knobs, prompts, new, sampling=None):
        what = f"F {name}"
        eng, reqs, launched = serve_spec(cfg, params, knobs, prompts, what,
                                         new=new, sampling=sampling)
        st = eng.stats_summary()
        per_token = kv_token_bytes(cfg, eng.kv_dtype)
        check(st["pool_bytes"] == per_token * eng.pool.num_pages
              * eng.page_size and st["kv_bytes_per_slot"]
              == per_token * eng.max_seq,
              f"{what}: pool bytes {st['pool_bytes']} (slot "
              f"{st['kv_bytes_per_slot']}), expected {per_token} a token")
        rows[name] = dict(_serve_row(st), kv_dtype=eng.kv_dtype,
                          bytes_per_token=per_token,
                          spec_k=eng.spec_k, spec_mode=eng.spec_mode,
                          accept_rate=st["spec_accept_rate"],
                          prefix_hits=st["prefix_hits"],
                          kernel_launches=eng.kernel_launches)
        launches[name] = launched
        print(f"[mla] {what}: pool {eng.pool.num_pages} pages x "
              f"{eng.page_size} = {st['pool_bytes']} bytes ({per_token} a "
              f"token, kv_dtype {eng.kv_dtype}); {_serve_line(st)}; "
              f"{st['tokens_per_step']:.3f} tokens/step (spec_k "
              f"{eng.spec_k}, {eng.spec_mode}; accept rate "
              f"{st['spec_accept_rate']:.4f}); prefix hits "
              f"{st['prefix_hits']}; kernel launches {eng.kernel_launches}")
        toks = _tokens(reqs)
        _free(eng)
        return toks, st

    plain = make_prompts(SPEC_LENS, cfg.vocab, seed=2)
    for kv in KV_DTYPES:
        run(kv, dict(kv_dtype=kv), plain, QUANT_NEW)
    shared = shared_prefix_prompts(FULL_TRAFFIC, cfg.vocab, seed=20)
    cold, _ = run("prefix cold", {}, shared, FULL_TRAFFIC.new)
    warm, wst = run("prefix warm", dict(prefix_cache=True), shared,
                    FULL_TRAFFIC.new)
    n = FULL_TRAFFIC.requests
    check(warm == cold, "F prefix warm: tokens differ from cold")
    check(wst["prefix_hits"] == n - 1 and wst["prefix_reused_tokens"]
          == (n - 1) * FULL_TRAFFIC.system,
          f"F prefix warm: hits {wst['prefix_hits']}, reused "
          f"{wst['prefix_reused_tokens']}")
    passages = spec_prompts(SPEC_LENS, cfg.vocab, seed=23)
    for name in ("chain", "tree"):
        run(name, SPEC_RUNS[name], passages, SPEC_NEW)
    first, _ = run("sampled int8", dict(kv_dtype="int8"), passages, SPEC_NEW,
                   E3_SAMPLING)
    again, _ = run("sampled int8 again", dict(kv_dtype="int8"), passages,
                   SPEC_NEW, E3_SAMPLING)
    check(again == first, "F sampled int8: the sampled tokens did not "
                          "repeat")
    print(f"[mla] warm tokens == cold over {n} requests ({n - 1} hits); the "
          f"sampled int8 run repeated its tokens; pool bytes a token "
          f"{[rows[kv]['bytes_per_token'] for kv in KV_DTYPES]} "
          f"(bf16, int8, int4; llama3.2-3b's bf16 "
          f"{kv_token_bytes(get_config('llama3.2-3b'), 'fp32')}); no kernel "
          f"launched in {len(rows)} runs")
    return rows, launches


def moe_params(cfg):
    """Phase M's weights on the card: random, bf16, from seed 0 (each leaf
    drawn in fp32, then cast: the largest, one stacked expert leaf, peaks
    at its fp32 draw beside the bf16 leaves made before it)."""
    t0 = time.perf_counter()
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         torch.device("cuda"), cfg.dtype)
    _sync()
    n_params = sum(t.numel() for t in leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"[moe] {cfg.arch_id}, {cfg.n_layers} of "
          f"{get_config(cfg.arch_id).n_layers} layers: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, {cfg.n_experts} experts, top-"
          f"{cfg.top_k}, capacity factor {cfg.capacity_factor}, vocab "
          f"{cfg.vocab}: {n_params / 1e9:.3f} B params, {nbytes / 1e9:.3f} "
          f"GB {cfg.dtype}, initialized in {time.perf_counter() - t0:.2f} s;"
          f" max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return params


def kept_share(cfg, params, tokens, t: int) -> float:
    """Share of the (token, k) assignments kept at a dispatch of ``t``
    tokens: the port's router and dispatch on layer 0's FFN weights, over
    ``tokens`` cut into dispatches of ``t``.  The inputs are the tokens'
    embeddings under layer 0's FFN norm (the block's attention skipped),
    so the share describes random weights routing random-like rows."""
    layer = map_tree(lambda w: w[0], params["blocks"])
    x = params["embed"][tokens[:len(tokens) // t * t]].to(cfg.dtype)
    x = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
    cap = moe._capacity(t, cfg)
    kept = total = 0
    for xt in x.split(t):
        _, idx, _ = moe._router(xt, layer["ffn"]["router"], cfg)
        _, _, keep = moe._dispatch_indices(idx, cfg.n_experts, cap)
        kept += int(keep.sum())
        total += keep.numel()
    return kept / total


def phase_moe_serve(cfg, params):
    """Phase M: phi3.5-moe at its published width, 16 layers, on phase 6's
    geometry.  M1: phase 6's traffic (8 greedy requests of 128-1024
    prompt tokens x 32 new); M2: phase D's repeated passages x SPEC_NEW
    new tokens, sequential and chain (spec_k 4), the chain run's agreement
    with the sequential one printed.  Every run: the refcount invariant
    after every step, every request complete, no NaN logit, moa_reduce
    launched 3 * layers a dispatch (2 page combines and the expert
    combine), flash attention, bitplane_add and quant_matmul never.
    Returns (summary rows, moa_reduce launches by run)."""
    rows, launches, toks = {}, {}, {}

    def run(name, knobs, prompts, new):
        what = f"M {name}"
        eng, reqs, launched = serve_spec(cfg, params, knobs, prompts, what,
                                         new=new)
        st = eng.stats_summary()
        others = {k: v for k, v in eng.kernel_launches.items()
                  if k != "moa_reduce"}
        check(not any(others.values()),
              f"{what}: a kernel other than moa_reduce launched: {others}")
        dispatches = st["prefill_dispatches"] + st["decode_steps"]
        _check_count(eng.device, launched == 3 * cfg.n_layers * dispatches,
                     f"{what}: moa_reduce launched {launched} times, "
                     f"expected 3 * {cfg.n_layers} * {dispatches}")
        rows[name] = dict(_serve_row(st), spec_k=eng.spec_k,
                          accept_rate=st["spec_accept_rate"],
                          launches=launched, page=eng.page_size)
        launches[name] = launched
        toks[name] = _tokens(reqs)
        print(f"[moe] {what}: page {eng.page_size}, pool "
              f"{eng.pool.num_pages} pages; {_serve_line(st)}; "
              f"{st['tokens_per_step']:.3f} tokens/step (spec_k "
              f"{eng.spec_k}; accept rate {st['spec_accept_rate']:.4f}); "
              f"moa_reduce launches {launched} = 3 * {cfg.n_layers} * "
              f"({st['prefill_dispatches']} + {st['decode_steps']}); "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        _free(eng)

    plain = make_prompts(SPEC_LENS, cfg.vocab, seed=2)
    torch.cuda.reset_peak_memory_stats()
    run("M1", {}, plain, QUANT_NEW)
    passages = spec_prompts(SPEC_LENS, cfg.vocab, seed=23)
    run("M2 sequential", {}, passages, SPEC_NEW)
    run("M2 chain", SPEC_RUNS["chain"], passages, SPEC_NEW)
    same = sum(a == b for a, b in zip(toks["M2 chain"],
                                      toks["M2 sequential"]))
    rows["M2 chain"]["equal_to_sequential"] = same
    tokens = torch.tensor(plain[0], device=params["embed"].device)
    shares = {t: kept_share(cfg, params, tokens, t) for t in (4, 256)}
    rows["kept_share"] = shares
    print(f"[moe] M2 chain: {rows['M2 chain']['tokens_per_step']:.3f} "
          f"tokens a step, requests with the sequential run's tokens "
          f"{same} of {len(passages)} (capacity couples a dispatch's rows, "
          f"and a verify dispatch has other rows than a decode step); "
          f"kept share of (token, k) assignments at capacity factor "
          f"{cfg.capacity_factor}: T=4 {shares[4]:.4f} (capacity "
          f"{moe._capacity(4, cfg)}), T=256 {shares[256]:.4f} (capacity "
          f"{moe._capacity(256, cfg)})")
    return rows, launches


def ssm_params(cfg):
    """An SSM or hybrid model's weights on the card at its published width:
    random, bf16, from seed 0 (each leaf drawn in fp32, then cast)."""
    t0 = time.perf_counter()
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         torch.device("cuda"), cfg.dtype)
    _sync()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"[ssm] {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"d_inner {cfg.d_inner}, state {cfg.ssm_state}, "
          f"{cfg.ssm_variant}, vocab {cfg.vocab}: {n_params} params, "
          f"{sum(t.numel() * t.element_size() for t in leaves(params))} B "
          f"{cfg.dtype}, initialized in {time.perf_counter() - t0:.2f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")
    return params, n_params


def phase_ssm_serve(cfg, params, n_params, what):
    """Phases S and Z: an SSM or hybrid model at its published width on
    contiguous slots (4 slots x max_seq 2048, chunk ``SSM_CHUNK``;
    resolve() turns paging, speculation and the prefix cache off), 8
    greedy requests of ``SSM_PROMPTS`` prompt tokens x ``SSM_NEW`` new,
    after warmup(): every request retires
    with ``SSM_NEW`` tokens, no decode logit is NaN, the decode state is
    ``SSM_SLOT_BYTES`` a slot, no kernel is launched (the reference runs
    no Pallas kernel on this path), and a second engine repeats the
    tokens.  ``generate`` (one decode_step a position, a 0-d index) on the
    first four prompts, their token agreement with the engine printed.
    Returns a summary row."""
    check_ssm_gates(cfg, what)
    rng = np.random.default_rng(31)
    lens = [SSM_GENERATE_LEN] * 4 + rng.integers(
        SSM_PROMPTS[0], SSM_PROMPTS[1] + 1, 4).tolist()
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    ecfg = EngineConfig(max_slots=4, max_seq=2048, prefill_chunk=SSM_CHUNK)
    toks, row = [], {}
    for attempt in range(2):
        eng = ServeEngine(cfg, params, config=ecfg)
        check(not eng.paged and eng.prefix is None and eng.spec_k == 0,
              f"{what}: not a contiguous sequential engine")
        if attempt == 0:
            t0 = time.perf_counter()
            eng.warmup()
            warm_s = time.perf_counter() - t0
        eng.trace_logits = True
        reqs = [eng.submit(q, SSM_NEW) for q in prompts]

        def drive():
            while eng.scheduler.has_work:
                eng.step()

        launches = _counted_run(eng, drive)
        _check_launches(eng, launches, f"{what} run {attempt + 1}")
        st = eng.stats_summary()
        check(all(r.slot is None and len(r.generated) == SSM_NEW
                  for r in reqs),
              f"{what}: a request did not retire with {SSM_NEW} tokens")
        check(not any(np.isnan(t).any() for t in eng.logit_trace),
              f"{what}: a decode logit is NaN")
        check(st["kv_bytes_per_slot"] == SSM_SLOT_BYTES[cfg.arch_id]
              and st["pool_bytes"] == 4 * SSM_SLOT_BYTES[cfg.arch_id],
              f"{what}: state {st['kv_bytes_per_slot']} B a slot, "
              f"{st['pool_bytes']} B in all")
        toks.append(_tokens(reqs))
        if attempt == 0:
            row = dict(_serve_row(st), warmup_s=warm_s, params=n_params,
                       launches=eng.kernel_launches)
            print(f"[ssm] {what} run 1: {_serve_line(st)}; warmup "
                  f"{warm_s:.2f} s; state {st['kv_bytes_per_slot']} B a "
                  f"slot; kernel launches {eng.kernel_launches}; "
                  f"max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        _free(eng)
    check(toks[0] == toks[1], f"{what}: a second run changed the tokens")
    batch = np.asarray([q for q in prompts[:4]])
    _zero_kernel_counts()
    ids, gst = generate(cfg, params, batch, SSM_NEW)
    check(not any(_kernel_counts().values()),
          f"{what} generate: a kernel launched")
    gen_toks = ids[:, SSM_GENERATE_LEN:].tolist()
    same = sum(a == b for a, b in zip(gen_toks, toks[0][:4]))
    agree = float(np.mean([np.mean(np.asarray(a) == np.asarray(b))
                           for a, b in zip(gen_toks, toks[0][:4])]))
    row.update(generate_prefill_tok_s=gst["prefill_tok_s"],
               generate_decode_tok_s=gst["decode_tok_s"],
               generate_equal_requests=same, generate_token_agreement=agree,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               repeat_equal=True)
    print(f"[ssm] {what}: a second engine repeated every token; generate "
          f"(4 x {SSM_GENERATE_LEN} + {SSM_NEW}): prefill "
          f"{gst['prefill_tok_s']:.1f} tok/s, decode "
          f"{gst['decode_tok_s']:.1f} tok/s, requests equal to the "
          f"engine's {same} of 4, token agreement {agree:.4f}; peak "
          f"max_memory_allocated {row['peak_gb']:.3f} GB")
    return row


#: phase Q: glm4-9b's KV bytes a token in bf16 (40 layers x K and V x 2
#: heads x 128 x 2 B)
QKV_TOKEN_BYTES = 40_960


def qkv_params(cfg):
    """glm4-9b's weights on the card: random bf16 from seed 0, the QKV
    biases N(0, 0.5) from seed 1.  Returns (params, parameter count)."""
    t0 = time.perf_counter()
    params = with_biases(init_params(
        get_api(cfg).param_specs(cfg),
        torch.Generator(device="cuda").manual_seed(0),
        torch.device("cuda"), cfg.dtype), seed=1)
    _sync()
    n_params = sum(t.numel() for t in leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"[qkv] {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd} (GQA group "
          f"{cfg.n_heads // cfg.n_kv_heads}), QKV bias, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}: {n_params:,} params, {nbytes / 1e9:.3f} GB "
          f"{cfg.dtype}, initialized in {time.perf_counter() - t0:.2f} s")
    return params, n_params


def bias_check(cfg, params, req, row) -> dict:
    """The engine's logits row ``row`` that drew ``req``'s last token,
    against ``forward`` over the same context with the biases and with
    them zeroed (bf16 logits, the flash kernels): the row must lie nearer
    the biased forward's, by at least 10x in L2 distance."""
    i = len(req.generated) - 1
    ctx = torch.tensor([list(req.prompt) + req.generated[:i]],
                       device=params["embed"].device)
    _zero_flash_counts()
    with torch.no_grad():
        rows = [forward(p, {"tokens": ctx}, cfg)[0][0, -1].float()
                for p in (params, zeroed_biases(params))]
    _sync()
    counts = _flash_counts()
    d_bias, d_zero = (float((row.float() - r).norm()) for r in rows)
    check(d_zero >= 10 * d_bias,
          f"Q bias check: the engine's row is {d_bias:.4f} from forward "
          f"with the biases and {d_zero:.4f} without (under 10x)")
    check(counts["fwd"] == 2 * cfg.n_layers,
          f"Q bias check: flash forward launched {counts['fwd']} times")
    print(f"[qkv] bias check on a request of {len(req.prompt)} prompt "
          f"tokens, its last decode row (index {i}): L2 distance to forward "
          f"with the biases {d_bias:.4f}, with them zeroed {d_zero:.4f} "
          f"({d_zero / max(d_bias, 1e-30):.1f}x, >= 10x asserted); flash "
          f"launches {counts}")
    return {"to_biased": d_bias, "to_zeroed": d_zero,
            "flash_launches": counts}


def phase_qkv_serve(cfg, params):
    """Phase Q: glm4-9b at its published width (``params`` from
    :func:`qkv_params`) on phase 6's geometry: phase 6's traffic over bf16
    and int8 pages, and chain (spec_k 4) on phase D's passages.  Every
    run: the refcount invariant after every step, every request complete,
    no NaN logit, moa_reduce launched 2 * 40 a dispatch, pool bytes a
    token exactly ``kv_token_bytes``; the bias check on the bf16 run.
    Returns (summary rows, moa_reduce launches by run)."""
    torch.cuda.reset_peak_memory_stats()
    rows, launches = {}, {}
    plain = make_prompts(SPEC_LENS, cfg.vocab, seed=2)
    passages = spec_prompts(SPEC_LENS, cfg.vocab, seed=23)
    check(kv_token_bytes(cfg, "fp32") == QKV_TOKEN_BYTES,
          f"Q: {kv_token_bytes(cfg, 'fp32')} KV bytes a token")
    for name, knobs, prompts, new in (
            ("bf16", dict(kv_dtype="fp32"), plain, QUANT_NEW),
            ("int8", dict(kv_dtype="int8"), plain, QUANT_NEW),
            ("chain", SPEC_RUNS["chain"], passages, SPEC_NEW)):
        what = f"Q {name}"
        record = [] if name == "bf16" else None
        eng, reqs, launched = serve_spec(cfg, params, knobs, prompts, what,
                                         new=new, record=record)
        st = eng.stats_summary()
        per_token = kv_token_bytes(cfg, eng.kv_dtype)
        check(st["pool_bytes"] == per_token * eng.pool.num_pages
              * eng.page_size and st["kv_bytes_per_slot"]
              == per_token * eng.max_seq,
              f"{what}: pool bytes {st['pool_bytes']} (slot "
              f"{st['kv_bytes_per_slot']}), expected {per_token} a token")
        rows[name] = dict(_serve_row(st), kv_dtype=eng.kv_dtype,
                          bytes_per_token=per_token, launches=launched,
                          accept_rate=st["spec_accept_rate"])
        launches[name] = launched
        print(f"[qkv] {what}: pool {eng.pool.num_pages} pages x "
              f"{eng.page_size} = {st['pool_bytes']} bytes ({per_token} a "
              f"token); {_serve_line(st)}; {st['tokens_per_step']:.3f} "
              f"tokens/step (accept rate {st['spec_accept_rate']:.4f}); "
              f"moa_reduce launches {launched} = 2 * {cfg.n_layers} * "
              f"({st['prefill_dispatches']} + {st['decode_steps']})")
        if record is not None:
            r = SPEC_LENS.index(min(SPEC_LENS))
            row = drawn_rows(record, reqs)[(r, len(reqs[r].generated) - 1)]
            del record
            rows["bias_check"] = bias_check(cfg, params, reqs[r], row)
        _free(eng)
    rows["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[qkv] peak memory {rows['peak_gb']:.3f} GB")
    return rows, launches


#: phase T: the autotune tier at full width on phase 6's weights: the
#: burst's arrivals, mean prompt and new tokens; the conversations
#: T1 and T2 take 8 arrivals, T4 4 requests of 4 new tokens: at 24 and 32
#: phase T took 111.6-119.9 s (its profiled point 31-40 s, a 434-662 MB
#: trace) on an H100 80GB HBM3 at 700 W, with the smoke near its 1200 s
#: limit; at 16 and 8, 77.6-112.8 s; at 12 and 8 x 4, 64.7-100.8 s; and
#: phase X6 needs the room
TUNE_ARRIVALS, TUNE_PROMPT, TUNE_GEN = 8, 256, 24
TUNE_SWEEP_REQUESTS, TUNE_SWEEP_GEN = 4, 4
TUNE_USERS, TUNE_TURNS, TUNE_TURN_TOKENS, TUNE_REPLY = 4, 3, 256, 16
#: the sweep's objectives for its Pareto front
SWEEP_OBJECTIVES = (("decode_tok_s", "max"), ("pool_bytes", "min"),
                    ("decode_step_p99_s", "min"))


def phase_tune(cfg, params, chunk_s, step_s, chain_step_s):
    """Phase T at full width on phase 6's weights and prices.  T1: the
    serve CLI's ``--burst-smoke`` (its own weights, drawn from seed 0).
    T2: ``replay_open_loop`` of an 8-arrival ``bursty_trace`` on phase C's
    geometry with spec_k 4, priced at phase 6's chunk and step and phase
    D's chain step: ladder off, on, and on again (equal outputs, virtual
    time and shed asserted; goodputs printed).  T3: 4 conversations x 3
    turns on 2 slots, a session hit for each of the 8 returning turns.  T4:
    ``run_sweep`` over prefill_chunk {128, 256} x spec_k {0, 4} on phase
    6's engine config, plus a point ``resolve`` rejects, one point under
    ``torch.profiler``; the Pareto front printed.  Returns (summary rows,
    moa_reduce launches by run)."""
    rows, launches = {}, {}
    t0 = time.perf_counter()
    _zero_kernel_counts()
    rc = serve_main(["--burst-smoke", "--requests", str(TUNE_ARRIVALS)])
    _sync()
    launches["T1 --burst-smoke"] = moa.LAUNCHES
    check(rc == 0 and moa.LAUNCHES > 0,
          f"T1: --burst-smoke returned {rc}, moa_reduce launches "
          f"{moa.LAUNCHES}")
    gc.collect()
    torch.cuda.empty_cache()       # the CLI's weights go
    print(f"[tune] T1 --burst-smoke --requests {TUNE_ARRIVALS} at full "
          f"width: rc 0 in {time.perf_counter() - t0:.1f} s; moa_reduce "
          f"launches {launches['T1 --burst-smoke']} (its warm-up included)")

    costs = VirtualCosts(chunk_s, step_s, chain_step_s)
    # an SLO of twice a mean request's service time alone: the burst's
    # queue misses it, so the ladder climbs to shedding
    slo_ms = 2e3 * (chunk_s + TUNE_GEN * chain_step_s)
    trace = bursty_trace(TUNE_ARRIVALS, rate=1.0, burst_rate=16.0,
                         mean_prompt=TUNE_PROMPT, mean_gen=TUNE_GEN,
                         max_prompt=1024, max_gen=64, vocab=cfg.vocab,
                         slo_ms=slo_ms, seed=24)
    res = {}
    for name, degrade in (("ladder off", False), ("ladder on", True),
                          ("ladder on again", True)):
        what = f"T2 {name}"
        eng = ServeEngine(cfg, params, config=FULL_TRAFFIC.engine(
            spec_k=4, degrade=degrade))
        r, launches[what] = counted_replay(eng, trace, costs, what)
        shed = [q for q in r["finished"] if q.shed_reason is not None]
        check(len(shed) == r["shed"] and all(
            q.shed_reason and not q.generated for q in shed),
              f"{what}: a shed request has tokens or no reason")
        served = [q for q in r["finished"] if q.shed_reason is None]
        check(len(served) + len(shed) == len(trace) and all(
            len(q.generated) == q.max_new for q in served),
              f"{what}: a served request is incomplete")
        st = r["stats"]
        res[name] = r
        rows[what] = {k: r[k] for k in TRAJECTORY if k != "outputs"}
        rows[what].update(goodput_tok_s=r["goodput_tok_s"],
                          degrade_transitions=st["degrade_transitions"],
                          spec_steps=st["spec_steps"],
                          preemptions=st["preemptions"])
        print(f"[tune] {what}: {len(trace)} arrivals (SLO "
              f"{slo_ms:.1f} ms) over {r['elapsed_s']:.4f} virtual s in "
              f"{r['steps']} steps; SLO met {r['slo_met']} / missed "
              f"{r['slo_missed']}, shed {r['shed']}"
              + (f" (first reason {shed[0].shed_reason!r})" if shed else "")
              + f"; goodput {r['goodput_tokens']} tokens = "
              f"{r['goodput_tok_s']:.2f} tok/s (virtual); ladder "
              f"transitions {st['degrade_transitions']}, spec steps "
              f"{st['spec_steps']}, preemptions {st['preemptions']}; "
              f"moa_reduce launches {launches[what]}")
        _free(eng)
    on, again = res["ladder on"], res["ladder on again"]
    check(on["outputs"] == again["outputs"]
          and on["elapsed_s"] == again["elapsed_s"]
          and on["shed"] == again["shed"],
          "T2: the two ladder-on replays differ")
    print(f"[tune] T2: the ladder-on replay repeated its outputs, virtual "
          f"time and shed (asserted); goodput ladder on "
          f"{on['goodput_tok_s']:.2f} tok/s, off "
          f"{res['ladder off']['goodput_tok_s']:.2f} (reported)")

    turns = multi_turn_trace(TUNE_USERS, TUNE_TURNS,
                             turn_tokens=TUNE_TURN_TOKENS, gen=TUNE_REPLY,
                             think_s=0.5, vocab=cfg.vocab, seed=25)
    # 2 slots for 4 conversations: slots turn over between turns, so a
    # returning turn finds its history in its snapshot, not in the trie
    eng = ServeEngine(cfg, params, config=EngineConfig(
        max_slots=2, max_seq=2048, prefill_chunk=256, page_size=128,
        pool_pages=64))
    r, launches["T3 multi-turn"] = counted_replay(eng, turns, costs,
                                                  "T3 multi-turn")
    st = r["stats"]
    returning = TUNE_USERS * (TUNE_TURNS - 1)
    check(st["session_hits"] == returning and all(
        len(o) == TUNE_REPLY for o in r["outputs"]),
          f"T3: session hits {st['session_hits']} (expected {returning}), "
          f"replies {[len(o) for o in r['outputs']]}")
    rows["T3 multi-turn"] = {k: r[k] for k in TRAJECTORY if k != "outputs"}
    rows["T3 multi-turn"].update(session_hits=st["session_hits"],
                                 session_reused_tokens=st[
                                     "session_reused_tokens"])
    print(f"[tune] T3 multi-turn: {TUNE_USERS} conversations x "
          f"{TUNE_TURNS} turns of {TUNE_TURN_TOKENS} tokens + "
          f"{TUNE_REPLY} replied; {r['steps']} steps over "
          f"{r['elapsed_s']:.4f} virtual s; session hits "
          f"{st['session_hits']} = the {returning} returning turns "
          f"(asserted), {st['session_reused_tokens']} tokens reused; "
          f"moa_reduce launches {launches['T3 multi-turn']}")
    _free(eng)

    base = EngineConfig(max_slots=4, max_seq=2048, prefill_chunk=256,
                        prefix_cache=False)
    points = SweepSpec(base, {"prefill_chunk": [128, 256],
                              "spec_k": [0, 4]}).points()
    bad = base.replace(page_size=96)
    prompts, gens = sweep_workload(cfg.vocab, requests=TUNE_SWEEP_REQUESTS,
                                   shared_prefix=512, tail=64,
                                   gen=TUNE_SWEEP_GEN)
    root = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        _zero_kernel_counts()
        t0 = time.perf_counter()
        recs = run_sweep(cfg, params, points[:2], prompts, gens)
        t1 = time.perf_counter()
        recs += run_sweep(cfg, params, points[2:3], prompts, gens,
                          profile_dir=root)
        t2 = time.perf_counter()
        recs += run_sweep(cfg, params, points[3:] + [bad], prompts, gens)
        _sync()
        t3 = time.perf_counter()
        launches["T4 sweep"] = moa.LAUNCHES
        trace_file = os.path.join(recs[2].get("trace_dir", root),
                                  TRACE_FILE)
        trace_bytes = (os.path.getsize(trace_file)
                       if os.path.exists(trace_file) else 0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    valid = [r for r in recs if "metrics" in r]
    check(len(valid) == 4 and "error" in recs[-1]
          and "metrics" not in recs[-1]
          and not any("profile_error" in r for r in recs)
          and trace_bytes > 0 and launches["T4 sweep"] > 0,
          f"T4: {len(valid)} records with metrics, last record "
          f"{recs[-1]}, profile errors "
          f"{[r.get('profile_error') for r in recs]}, trace {trace_bytes} "
          f"bytes")
    front = pareto_front([r["metrics"] for r in valid], SWEEP_OBJECTIVES)
    rows["T4 sweep"] = {
        "points": [dict(prefill_chunk=r["config"]["prefill_chunk"],
                        spec_k=r["config"]["spec_k"], **r["metrics"])
                   for r in valid],
        "error": recs[-1]["error"], "front": front,
        "trace_bytes": trace_bytes,
        "seconds": {"two points": t1 - t0, "one profiled point": t2 - t1,
                    "one point and the rejected one": t3 - t2}}
    for i, r in enumerate(valid):
        m = r["metrics"]
        print(f"[tune] T4 point prefill_chunk {r['config']['prefill_chunk']}"
              f" spec_k {r['config']['spec_k']}: decode "
              f"{m['decode_tok_s']:.1f} tok/s, prefill "
              f"{m['prefill_tok_s']:.1f} tok/s, step p50 "
              f"{1e3 * m['decode_step_p50_s']:.3f} ms p99 "
              f"{1e3 * m['decode_step_p99_s']:.3f} ms, pool "
              f"{m['pool_bytes']} bytes, {m['tokens_per_step']:.3f} "
              f"tokens/step, occupancy {m['mean_occupancy']:.3f}"
              + (" (profiled)" if "trace_dir" in r else "")
              + (" [front]" if i in front else ""))
    print(f"[tune] T4: 4 points with metrics, the rejected one's error "
          f"{recs[-1]['error'][:60]!r}...; the profiled point's Chrome "
          f"trace {trace_bytes} bytes; sweep seconds "
          f"{rows['T4 sweep']['seconds']}; Pareto front under "
          f"{SWEEP_OBJECTIVES}: points {front}; moa_reduce launches "
          f"{launches['T4 sweep']} (engine warm-ups included)")
    return rows, launches


@dataclasses.dataclass(frozen=True)
class Traffic:
    """The serve traffic of phases A-C at one scale: the engine geometry,
    A's shared-prefix requests, B's conversations and C's burst."""

    slots: int
    max_seq: int
    chunk: int
    page: int
    system: int                   # A: system prompt (a multiple of both
    tail: tuple                   #    chunk and page), tail length range,
    new: int                      #    new tokens a request,
    requests: int                 #    requests
    first: int                    # B: first-turn tokens, later-turn range,
    turn: tuple                   #    reply tokens, conversations, turns,
    reply: int                    #    the two pool sizes
    convs: int
    turns: int
    pools: tuple
    burst: int                    # C: requests, prompt and budget ranges
    prompt: tuple
    gen: tuple

    def engine(self, **knobs) -> EngineConfig:
        return EngineConfig(max_slots=self.slots, max_seq=self.max_seq,
                            prefill_chunk=self.chunk, page_size=self.page,
                            **knobs)


FULL_TRAFFIC = Traffic(4, 2048, 256, 128, 1024, (64, 448), 32, 8,
                       512, (64, 192), 32, 6, 3, (160, 40),
                       24, (128, 1024), (16, 64))
REDUCED_TRAFFIC = Traffic(4, 128, 16, 16, 64, (4, 28), 4, 8,
                          32, (4, 12), 4, 6, 3, (60, 14),
                          24, (8, 64), (2, 8))

#: counters the reduced CUDA run must share with the CPU run
SERVE_COUNTERS = (
    "prefill_tokens", "decode_tokens", "decode_steps", "prefill_dispatches",
    "admissions", "evictions", "preemptions", "oom_deferred",
    "prefix_hits", "prefix_misses", "prefix_reused_tokens",
    "prefix_evictions", "prefix_bytes_copied", "pages_shared", "pages_cow",
    "trie_evictions", "dedup_hits", "dedup_pages_shared",
    "dedup_hash_collisions", "dedup_indexed_pages", "session_turns",
    "session_hits", "session_reused_tokens", "session_snapshot_drops",
    "sessions_live", "slo_met", "slo_missed", "shed_requests",
    "goodput_tokens", "degrade_steps", "degrade_level",
    "degrade_transitions", "pages_in_use", "moa_reduce_launches")


def _free(*engines) -> None:
    for eng in engines:
        eng.state = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def refcount_check(eng, what: str) -> None:
    """Every page's refcount equals its occurrences across table rows and
    session snapshots; every shard's scratch page (page 0 of a one-shard
    pool) is pinned and mapped by nothing; the free lists and the used
    pages partition the pool, each free list inside its shard's block; no
    row maps a page outside its slot's shard block; no dedup entry sits
    on a freed page.  A contiguous engine has no pool: nothing to
    hold."""
    if not eng.paged:
        return
    pool = eng.pool
    counts = np.bincount(eng.table[eng.table != 0].ravel(),
                         minlength=pool.num_pages)
    counts += np.bincount(np.asarray(eng.sessions.snapshot_pages(),
                                     np.int64), minlength=pool.num_pages)
    free = {p for block in pool._free for p in block}
    scratch = np.arange(pool.shards) * pool.block
    rest = np.setdiff1d(np.arange(pool.num_pages), scratch)
    check((pool.refcount[scratch] == 1).all() and not counts[scratch].any()
          and (pool.refcount[rest] == counts[rest]).all()
          and len(free) == pool.free_count
          and free == set(np.flatnonzero(counts == 0)) - set(scratch)
          and all(pool.shard_of(p) == sh
                  for sh, block in enumerate(pool._free) for p in block)
          and all(pool.shard_of(p) == eng._slot_shard(slot)
                  for slot in range(eng.max_slots)
                  for p in eng.table[slot] if p)
          and all(pool.refcount[p] > 0 for p in (eng.dedup.pages()
                                                  if eng.dedup else ())),
          f"{what}: the refcount invariant does not hold")


def _zero_kernel_counts() -> None:
    moa.LAUNCHES = bpa.LAUNCHES = qmm.LAUNCHES = 0
    _zero_flash_counts()


def _kernel_counts() -> dict:
    """Every kernel's launch counter, by kernel."""
    return {"moa_reduce": moa.LAUNCHES, "bitplane_add": bpa.LAUNCHES,
            "quant_matmul": qmm.LAUNCHES,
            **{f"flash_attention_{k}": v for k, v in _flash_counts().items()}}


def _counted_run(eng, drive) -> int:
    """moa_reduce launches of ``drive()``: every kernel's count is zeroed
    just before and read just after (all of them into
    ``eng.kernel_launches``)."""
    _zero_kernel_counts()
    drive()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    eng.kernel_launches = _kernel_counts()
    return moa.LAUNCHES


def _check_count(device: torch.device, ok: bool, msg: str) -> None:
    """A launch count is held only on the card: on the CPU every wrapper
    runs its plain version and counts nothing."""
    if device.type == "cuda":
        check(ok, msg)


def launches_per_dispatch(cfg, page_size: int) -> int:
    """moa_reduce launches a dispatch: GQA's page combine twice a layer
    when its engine resolved a page (paged, or contiguous split-K over
    slot rows) and never without one (a contiguous engine of page 0 takes
    one softmax; MLA a plain softmax over the latent view); the MoE top-k
    combine once a layer."""
    if cfg.family in ("ssm", "hybrid"):
        return 0                       # recurrent state: no page combine
    page = 2 if cfg.attn_kind != "mla" and page_size else 0
    expert = 1 if cfg.n_experts and cfg.use_moa_reduce else 0
    return (page + expert) * cfg.n_layers


def _check_launches(eng, launches: int, what: str) -> None:
    """On the card: moa_reduce launched :func:`launches_per_dispatch`
    times a dispatch; a dense-FFN MLA model and the SSM and hybrid
    families launch no kernel at all."""
    st = eng.stats
    if (eng.cfg.attn_kind == "mla" and not eng.cfg.n_experts) or \
            eng.cfg.family in ("ssm", "hybrid"):
        check(launches == st["moa_reduce_launches"] == 0 and not any(
            eng.kernel_launches.values()),
            f"{what}: a run with no kernel on its path launched one: "
            f"{eng.kernel_launches}")
        return
    per = launches_per_dispatch(eng.cfg, eng.page_size)
    want = per * (st["prefill_dispatches"] + st["decode_dispatches"])
    _check_count(eng.device, launches == want == st["moa_reduce_launches"],
                 f"{what}: moa_reduce launched {launches} times, expected "
                 f"{per} * ({st['prefill_dispatches']} + "
                 f"{st['decode_dispatches']}) = {want} (page "
                 f"{eng.page_size})")


def shared_prefix_prompts(tr: Traffic, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, tr.system).tolist()
    return [system + rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(tr.tail[0], tr.tail[1] + 1, tr.requests)]


def serve_shared_prefix(cfg, params, dev, tr: Traffic, prompts, **knobs):
    """One engine serving A's requests; returns (engine, requests,
    moa_reduce launches).  With ``page_dedup`` the digest step is timed."""
    eng = ServeEngine(cfg, params, config=tr.engine(**knobs), device=dev)
    eng.trace_logits = True
    # with page_dedup: seconds moving pages to the host and hashing them,
    # and the pages hashed
    eng.hash_s = {"to_host": 0.0, "blake2b": 0.0, "pages": 0}
    if eng.dedup is not None:
        def timed(fn, key):
            def run(x):
                t0 = time.perf_counter()
                out = fn(x)
                eng.hash_s[key] += time.perf_counter() - t0
                eng.hash_s["pages"] += key == "blake2b"
                return out
            return run

        eng._page_bytes_of = timed(eng._page_bytes_of, "to_host")
        eng._digest_fn = timed(eng._digest_fn, "blake2b")
    reqs = [eng.submit(p, tr.new) for p in prompts]
    launches = _counted_run(eng, eng.run)
    refcount_check(eng, f"shared prefix {knobs}")
    return eng, reqs, launches


def session_turns(tr: Traffic, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, vocab, tr.first if k == 0 else int(
        rng.integers(tr.turn[0], tr.turn[1] + 1))).tolist()
        for k in range(tr.turns)] for _ in range(tr.convs)]


def serve_sessions(cfg, params, dev, tr: Traffic, turns, pool_pages):
    """Every conversation's turns in rounds on ``tr.slots`` slots (more
    conversations than slots: slots turn over between turns), the
    refcount invariant after every step, then end_session on all.  Returns
    (engine, requests in submission order, launches, released) where
    ``released`` says end_session released exactly the snapshots'
    references."""
    eng = ServeEngine(cfg, params, config=tr.engine(pool_pages=pool_pages),
                      device=dev)
    eng.trace_logits = True
    reqs = []

    def drive():
        for k in range(tr.turns):
            for c in range(tr.convs):
                reqs.append(eng.submit_turn(c, turns[c][k], tr.reply))
            while eng.scheduler.has_work:
                eng.step()
                refcount_check(eng, f"sessions pool {pool_pages}")

    launches = _counted_run(eng, drive)
    before = eng.pool.refcount.copy()
    snap = np.bincount(np.asarray(eng.sessions.snapshot_pages(), np.int64),
                       minlength=eng.pool.num_pages)
    ended = sum(eng.end_session(c) for c in range(tr.convs))
    released = (ended == tr.convs and not len(eng.sessions)
                and ((before - eng.pool.refcount) == snap).all())
    refcount_check(eng, f"sessions pool {pool_pages} after end_session")
    return eng, reqs, launches, released


def overload_trace(tr: Traffic, vocab: int, chunk_s: float, step_s: float,
                   seed: int):
    """C's arrivals, in virtual seconds: ``tr.slots`` no-SLO requests at
    t = 0 that fill every slot, one tight-SLO request while they decode
    (its deadline is met if it is admitted at once, missed if it waits for
    a slot to free), then a burst of SLO'd requests arriving at four times
    the rate the engine serves them."""
    rng = np.random.default_rng(seed)

    def service(p, n):
        return -(-p // tr.chunk) * chunk_s + n * step_s

    def toks(n):
        return rng.integers(0, vocab, int(n)).tolist()

    bg_prompt, bg_new = 2 * tr.prompt[0], tr.gen[1]
    out = [Arrival(0.0, toks(bg_prompt), bg_new) for _ in range(tr.slots)]
    t_urgent = tr.slots * service(bg_prompt, 0) + 3 * step_s
    left = bg_new - 4
    out.append(Arrival(t_urgent, toks(tr.prompt[0]), tr.gen[0], 1e3 * (
        service(tr.prompt[0], tr.gen[0]) + 0.5 * left * step_s)))
    t = t_urgent
    for _ in range(tr.burst - tr.slots - 1):
        p = int(rng.integers(tr.prompt[0], tr.prompt[1] + 1))
        n = int(rng.integers(tr.gen[0], tr.gen[1] + 1))
        t += float(rng.exponential(service(p, n) / tr.slots / 4))
        out.append(Arrival(t, toks(p), n, 3e3 * service(p, n)))
    return out


def replay(eng, trace, chunk_s: float, step_s: float):
    """Serve ``trace`` open-loop on a virtual clock: the scheduler reads
    the loop's time, the cost model gets the fixed prices before every
    step, and time advances by them per prefill dispatch and decode step.
    Logs each request's prefill pieces (``eng.pieces_log``, by trace
    index) and each preemption's victim (``eng.victims``).  Returns the
    requests in trace order."""
    vt = [0.0]
    sched = eng.scheduler
    sched.clock = lambda: vt[0]
    eng.pieces_log, eng.victims, eng.max_level = {}, [], 0
    index, current = {}, [None]
    admit, pieces, preempt = eng._admit, eng._pieces, sched.maybe_preempt

    def logged_admit(slot, req):
        current[0] = index[req.rid]
        return admit(slot, req)

    def logged_pieces(ctx, start=0, chunk=None):
        out = pieces(ctx, start, chunk)
        eng.pieces_log.setdefault(current[0], []).append(
            [(a, n) for a, n, _ in out])
        return out

    def logged_preempt(now=None):
        victim = preempt(now)
        if victim is not None:
            eng.victims.append(index[sched.active[victim].rid])
        return victim

    eng._admit, eng._pieces, sched.maybe_preempt = (
        logged_admit, logged_pieces, logged_preempt)
    order = sorted(range(len(trace)), key=lambda i: trace[i].t)
    reqs, nxt = [None] * len(trace), 0
    while nxt < len(order) or sched.has_work:
        while nxt < len(order) and trace[order[nxt]].t <= vt[0]:
            a = trace[order[nxt]]
            reqs[order[nxt]] = eng.submit(a.prompt, a.max_new,
                                          slo_ms=a.slo_ms)
            index[reqs[order[nxt]].rid] = order[nxt]
            nxt += 1
        if not sched.has_work:
            vt[0] = trace[order[nxt]].t
            continue
        sched.update_cost_model(chunk_s=chunk_s, step_s=step_s,
                                tokens_per_step=1.0)
        before = (eng.stats["prefill_dispatches"], eng.stats["decode_steps"])
        eng.step()
        vt[0] += ((eng.stats["prefill_dispatches"] - before[0]) * chunk_s
                  + (eng.stats["decode_steps"] - before[1]) * step_s)
        if eng.ladder is not None:
            eng.max_level = max(eng.max_level, eng.ladder.level)
    eng.virtual_s = vt[0]
    return reqs


def serve_overload(cfg, params, dev, tr: Traffic, trace, chunk_s, step_s,
                   degrade: bool, **knobs):
    eng = ServeEngine(cfg, params, config=tr.engine(degrade=degrade,
                                                    **knobs), device=dev)
    eng.trace_logits = True
    reqs = []
    launches = _counted_run(eng, lambda: reqs.extend(
        replay(eng, trace, chunk_s, step_s)))
    refcount_check(eng, f"overload degrade={degrade}")
    return eng, reqs, launches


def _tokens(reqs):
    return [r.generated for r in reqs]


def _logit_diff(a, b) -> float:
    check(len(a.logit_trace) == len(b.logit_trace),
          "decode logit traces differ in length")
    return max((float(np.abs(x - y).max())
                for x, y in zip(a.logit_trace, b.logit_trace)), default=0.0)


def reduced_serve_runs(cfg, params, dev):
    """Phases A-C's traffic cut to the reduced config, on ``dev``: the
    engines' tokens, counters and logit traces by run name."""
    tr = REDUCED_TRAFFIC
    runs = {}
    prompts = shared_prefix_prompts(tr, cfg.vocab, seed=10)
    for name, knobs in (("A cold", dict(prefix_cache=False)),
                        ("A warm", {}),
                        ("A dedup", dict(prefix_cache=False,
                                         page_dedup=True))):
        eng, reqs, _ = serve_shared_prefix(cfg, params, dev, tr, prompts,
                                           **knobs)
        runs[name] = (eng, reqs)
    turns = session_turns(tr, cfg.vocab, seed=11)
    for pool in tr.pools:
        eng, reqs, _, released = serve_sessions(cfg, params, dev, tr, turns,
                                                pool)
        check(released, f"reduced sessions pool {pool}: end_session did not "
                        f"release exactly the snapshots' references")
        runs[f"B pool {pool}"] = (eng, reqs)
    trace = overload_trace(tr, cfg.vocab, 0.010, 0.020, seed=12)
    for degrade in (False, True):
        eng, reqs, _ = serve_overload(cfg, params, dev, tr, trace, 0.010,
                                      0.020, degrade)
        runs[f"C degrade={degrade}"] = (eng, reqs)
    return runs


#: the speculative runs of phases 5 and D: the serve CLI's defaults
#: (spec_k 4; tree nodes 12, branch 3), heads with the drafter of that name
SPEC_RUNS = {"chain": dict(spec_k=4),
             "tree": dict(spec_k=4, spec_mode="tree"),
             "auto": dict(spec_k=4, spec_mode="auto"),
             "heads": dict(spec_k=4, spec_mode="tree", spec_drafter="heads")}

#: speculative counters a CUDA run must share with the CPU run
SPEC_COUNTERS = ("spec_drafted", "spec_accepted", "spec_lanes_drafted",
                 "spec_lanes_hit", "spec_pages_rolled_back", "spec_steps",
                 "spec_tree_steps", "spec_shape_chain", "spec_shape_tree")


def spec_prompts(lens, vocab, seed, passage=64, edits=2):
    """Prompts where prompt lookup pays: per request a seeded
    ``passage``-token passage repeated to its length, each copy with
    ``edits`` tokens changed (code edits, quoted summaries)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        base = rng.integers(0, vocab, passage)
        reps = []
        for _ in range(-(-n // passage)):
            p = base.copy()
            p[rng.integers(0, passage, edits)] = rng.integers(0, vocab,
                                                              edits)
            reps.append(p)
        out.append(np.concatenate(reps)[:n].tolist())
    return out


def reduced_spec_runs(cfg, params, dev):
    """Phase 5's speculative runs on ``dev``: the sequential engine and
    each of SPEC_RUNS (random draft heads for "heads") on one traffic of
    repeated passages; (engine, requests) by run name."""
    heads = init_params(get_api(cfg).draft_head_specs(cfg, 3, 16),
                        torch.Generator().manual_seed(9),
                        torch.device("cpu"), torch.float32)
    prompts = spec_prompts((40, 13, 28, 20, 33), cfg.vocab, seed=13,
                           passage=6, edits=1)
    runs = {}
    for name, knobs in [("sequential", {})] + list(SPEC_RUNS.items()):
        p = params
        if name == "heads":
            p = dict(params, draft_heads=map_tree(lambda t: t.to(dev),
                                                  heads))
        eng = ServeEngine(cfg, p, config=EngineConfig(
            max_slots=2, max_seq=64, prefill_chunk=16, page_size=16,
            **knobs), device=dev)
        reqs = [eng.submit(q, 16) for q in prompts]
        launches = _counted_run(eng, eng.run)
        _check_launches(eng, launches, f"reduced spec {name}")
        refcount_check(eng, f"reduced spec {name}")
        runs[name] = (eng, reqs)
    return runs


#: phase 5's quantized and sampled runs: (engine knobs, sampled?)
REDUCED_QUANT_RUNS = {
    "int8": (dict(kv_dtype="int8"), False),
    "int8 chain": (dict(kv_dtype="int8", spec_k=4), False),
    "int4": (dict(kv_dtype="int4"), False),
    "int4 chain": (dict(kv_dtype="int4", spec_k=4), False),
    "sampled": ({}, True),
    "sampled chain": (dict(spec_k=4), True)}


def reduced_quant_runs(cfg, params, dev):
    """Phase 5's quantized and sampled runs on ``dev`` over repeated
    passages; a sampled run's request ``i`` draws with temperature 0.8,
    top-k 40, top-p 0.9 and seed ``i``.  (engine, requests) by run name."""
    prompts = spec_prompts((40, 13, 28, 20, 33), cfg.vocab, seed=14,
                           passage=6, edits=1)
    runs = {}
    for name, (knobs, sampled) in REDUCED_QUANT_RUNS.items():
        eng = ServeEngine(cfg, params, config=EngineConfig(
            max_slots=2, max_seq=64, prefill_chunk=16, page_size=16,
            **knobs), device=dev)
        reqs = [eng.submit(q, 16, sampling=SamplingParams(
            temperature=0.8, top_k=40, top_p=0.9, seed=i) if sampled
            else None) for i, q in enumerate(prompts)]
        launches = _counted_run(eng, eng.run)
        _check_launches(eng, launches, f"reduced {name}")
        refcount_check(eng, f"reduced {name}")
        runs[name] = (eng, reqs)
    return runs


def sampling_parity() -> None:
    """sample_tokens on one seeded (64, 128256) fp32 logits tensor and
    threefry's bits and uniforms, CUDA against CPU."""
    gen = torch.Generator().manual_seed(0)
    logits = 3 * torch.randn((64, 128256), generator=gen)
    sps = [SamplingParams(temperature=(0.0, 0.5, 0.8, 1.5)[i % 4],
                          top_k=(0, 1, 40)[i % 3],
                          top_p=(0.05, 0.9, 1.0)[(i // 3) % 3], seed=i)
           for i in range(64)]
    idxs = list(range(0, 640, 10))
    cpu = sample_tokens(logits, *sampling_lanes(sps, idxs))
    gpu = sample_tokens(logits.cuda(), *sampling_lanes(sps, idxs, "cuda"))
    check(torch.equal(gpu.cpu(), cpu),
          f"sample_tokens: CUDA differs from CPU in "
          f"{int((gpu.cpu() != cpu).sum())} of 64 rows")
    seeds = torch.tensor([s.seed for s in sps])
    bits, unis = [], []
    for dev in ("cpu", "cuda"):
        key = prng.fold_in(prng.prng_key(seeds.to(dev)),
                           torch.tensor(idxs, device=dev))
        bits.append(prng.random_bits(key, 128256).cpu())
        unis.append(prng.uniform(key, 128256, torch.finfo(
            torch.float32).tiny).cpu().view(torch.int32))
    check(torch.equal(*bits) and torch.equal(*unis),
          "threefry bits or uniforms differ CUDA vs CPU")
    print(f"[parity] sample_tokens (64, 128256) fp32: tokens equal CPU vs "
          f"CUDA ({int((cpu != logits.argmax(-1)).sum())} of 64 rows drew "
          f"a token other than the argmax); threefry bits and uniforms "
          f"bit for bit over 64 x 128256")


def device_ms(fn, reps: int = 50) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events.
    A sleep kernel queued ahead keeps the card busy while the host enqueues
    the events and ``fn``, so the interval holds device work only."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(shapes, dtype=torch.float32):
    """moa_reduce on (N, M) ``dtype`` operands with an fp32 accumulator,
    at each of ``shapes``: kernel, plain version and torch.sum."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for label, n, m in shapes:
        x = torch.randn((n, m), generator=gen, device=dev).to(dtype)
        kernel = device_ms(lambda: moa.moa_reduce_cuda(x, torch.float32))
        plain = device_ms(lambda: moa.moa_reduce_plain(x, torch.float32))
        library = device_ms(lambda: torch.sum(x, 0, dtype=torch.float32))
        nbytes = moa.bound_bytes(n, m, dtype, torch.float32)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"label": label, "shape": [n, m],
                     "dtype": str(dtype).removeprefix("torch."), "ms": kernel,
                     "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound, "bytes": nbytes})
        print(f"[time] moa_reduce {label} N={n} M={m} {rows[-1]['dtype']}: "
              f"kernel_ms "
              f"{kernel:.5f} bound_ms {bound:.5f} ({nbytes} B / 3.35 TB/s) "
              f"library_ms {library:.5f} (torch.sum) plain_ms {plain:.5f} "
              f"kernel/bound {kernel / bound:.2f} kernel/library "
              f"{kernel / library:.3f}")
    return rows


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() /
                 b.float().norm().clamp_min(1e-30))


def phase_flash_check():
    """The forward, dq and dk/dv kernels against the plain versions on the
    same CUDA inputs.  Returns, per kernel, the max |diff| over the fp32
    cases and at each of FLASH_NAMED's shapes (bf16, at its path's causal
    flag)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {k: dict.fromkeys(("fp32",) + tuple(FLASH_NAMED), 0.0)
            for k in ("fwd", "bwd_dq", "bwd_dkv")}
    n = repeats = 0
    for b, s, hq, hkv, hd, dt in FLASH_CHECK_SHAPES:
        for causal in (True, False):
            what = f"(B,S,Hq,Hkv,hd)={(b, s, hq, hkv, hd)} {dt} causal={causal}"
            q, do = (torch.randn((b, s, hq, hd), generator=gen, device=dev)
                     .to(dt) for _ in range(2))
            k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
            dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do,
                                                       causal)
            dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                     causal)
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, causal)
            tol = 2e-5 if dt == torch.float32 else 2e-2
            check(torch.allclose(o.float(), po.float(), rtol=tol, atol=tol),
                  f"flash forward != plain at {what}")
            check(dt == torch.float32 or _rel(o, po) <= 1e-2,
                  f"flash forward relative norm error {_rel(o, po)} > 1e-2 "
                  f"at {what}")
            check(torch.allclose(lse, plse, rtol=1e-5, atol=1e-5),
                  f"flash lse != plain at {what}")
            plain = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(
                fa.flash_attention_plain(*leaves, causal)[0], leaves, do)
            for name, got, want, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                            plain, auto):
                for w, wname in ((want, "plain_bwd"), (ref, "autograd")):
                    ok = (torch.allclose(got, w, rtol=1e-4, atol=1e-5)
                          if dt == torch.float32 else _rel(got, w) <= 1e-2)
                    check(ok, f"flash {name} != {wname} at {what}")
            if (b, s, hq, dt) == (TRAIN_BATCH, TRAIN_SEQ, 24,
                                  torch.bfloat16):
                o2, lse2 = fa.flash_attention_fwd_cuda(q, k, v, causal)
                check(torch.equal(o, o2) and torch.equal(lse, lse2),
                      f"flash forward: two calls differ at {what}")
                dq2, delta2 = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse,
                                                             do, causal)
                dk2, dv2 = fa.flash_attention_bwd_dkv_cuda(q, k, v, lse,
                                                           delta2, do, causal)
                check(all(torch.equal(x, y) for x, y in zip(
                    (dq, delta, dk, dv), (dq2, delta2, dk2, dv2))),
                    f"flash backward: two calls differ at {what}")
                repeats += 1
                del o2, lse2, dq2, delta2, dk2, dv2
            found = {"fwd": (o.float() - po.float()).abs().max(),
                     "bwd_dq": (dq.float() - plain[0].float()).abs().max(),
                     "bwd_dkv": max((dk.float() - plain[1].float()).abs()
                                    .max(), (dv.float() - plain[2].float())
                                    .abs().max())}
            key = "fp32" if dt == torch.float32 else next(
                (name for name, named in FLASH_NAMED.items()
                 if named == ((b, s, hq, hkv, hd), causal)), None)
            for name, e in found.items():
                if key:
                    errs[name][key] = max(errs[name][key], float(e))
            n += 1
            del q, k, v, do, o, lse, dq, dk, dv, plain, auto, leaves
    print(f"[check] flash attention forward, dq and dk/dv kernels == plain "
          f"versions and autograd on {n} shape/dtype/causal cases; max "
          f"|diff| fp32 fwd {errs['fwd']['fp32']:.3e} dq "
          f"{errs['bwd_dq']['fp32']:.3e} dkv {errs['bwd_dkv']['fp32']:.3e}; "
          f"at the path shape (bf16) fwd {errs['fwd']['path']:.3e} dq "
          f"{errs['bwd_dq']['path']:.3e} dkv {errs['bwd_dkv']['path']:.3e}; "
          f"at zamba2's shared-block shape {ZAMBA_FLASH_SHAPE} (bf16, "
          f"causal) fwd {errs['fwd']['zamba2']:.3e} dq "
          f"{errs['bwd_dq']['zamba2']:.3e} dkv "
          f"{errs['bwd_dkv']['zamba2']:.3e}; two forward and two backward "
          f"calls torch.equal at the path shape ({repeats} cases)")
    for name in ("hubert", "internvl2", "glm4", "qwen"):
        shape, causal = FLASH_NAMED[name]
        print(f"[check] flash at {name}'s shape {shape} (bf16, causal="
              f"{causal}): max |diff| fwd {errs['fwd'][name]:.3e} dq "
              f"{errs['bwd_dq'][name]:.3e} dkv {errs['bwd_dkv'][name]:.3e}")
    check(repeats == 2, "flash: the path shape was not repeated")
    return errs


def _zero_flash_counts() -> None:
    fa.LAUNCHES_FWD = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0


def _flash_counts():
    return {"fwd": fa.LAUNCHES_FWD, "bwd_dq": fa.LAUNCHES_BWD_DQ,
            "bwd_dkv": fa.LAUNCHES_BWD_DKV}


def _expected_counts(cfg, steps):
    fwd = cfg.n_layers * steps * (2 if cfg.remat else 1)
    return {"fwd": fwd, "bwd_dq": cfg.n_layers * steps,
            "bwd_dkv": cfg.n_layers * steps}


def phase_train_parity():
    """Three AdamW steps of each reduced fp32 config from one state, on
    the CPU (chunked attention) and on CUDA (the flash kernels): llama3.2-3b
    with kv_heads=2, then the frontend families; then the reduced glm4-9b's
    loss and bias gradients.  Returns glm4's flash launches."""
    train_parity(get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                                   n_kv_heads=2),
                 "kv_heads=2, ")
    train_parity(get_config(AUDIO_ARCH).reduced(dtype=torch.float32),
                 "audio frames, non-causal, ")
    train_parity(get_config(VLM_ARCH).reduced(dtype=torch.float32),
                 "8 vision-stub + 56 text positions, ")
    return qkv_train_parity()


def qkv_train_parity() -> dict:
    """One reduced glm4-9b ``train_loss`` (group 16, nonzero biases) and
    its bias gradients, CUDA (the flash kernels) against CPU on one
    batch, within 1e-4; on the card each flash kernel runs once a
    layer."""
    cfg = reduced_qkv(QKV_ARCH)
    cpu_params = with_biases(seed_params(cfg), seed=1)
    toks = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab, (4, 65)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = map_tree(lambda t: t.to(dev).requires_grad_(True), cpu_params)
        _zero_kernel_counts()
        loss = train_loss(p, {"tokens": toks[:, :-1].to(dev),
                              "labels": toks[:, 1:].to(dev)}, cfg)
        grads = torch.autograd.grad(
            loss, [p["blocks"]["attn"][k] for k in QKV_BIASES])
        _sync()
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    _flash_counts())
    (closs, cgrads, _), (gloss, ggrads, counts) = out["cpu"], out["cuda"]
    diff = max(float((a - b).abs().max()) for a, b in zip(cgrads, ggrads))
    check(abs(closs - gloss) <= 1e-4 and diff <= 1e-4,
          f"reduced {QKV_ARCH} train: CUDA loss {gloss} (CPU {closs}), max "
          f"|bias grad diff| {diff} (> 1e-4)")
    check(all(bool(g.abs().sum() > 0) for g in ggrads),
          f"reduced {QKV_ARCH} train: a bias got no gradient on the card")
    want = dict.fromkeys(("fwd", "bwd_dq", "bwd_dkv"), cfg.n_layers)
    check(counts == want, f"reduced {QKV_ARCH} train: flash launches "
                          f"{counts}, expected {want}")
    print(f"[parity] reduced {QKV_ARCH} train_loss (fp32, 32/2 heads, "
          f"nonzero QKV biases, batch 4 x seq 64): loss CPU {closs:.6f} "
          f"CUDA {gloss:.6f}; bq, bk, bv gradients max |diff| {diff:.3e} "
          f"(tol 1e-4); flash launches {counts}")
    return counts


def train_parity(cfg, what: str) -> None:
    shape = ShapeConfig("parity", seq_len=64, global_batch=4,
                              kind="train")
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    states = {"cuda": map_tree(lambda t: t.to("cuda"), state), "cpu": state}
    losses, counts = {}, None
    for dev in ("cpu", "cuda"):
        step_fn = build_train_step(
            cfg, AdamWConfig(lr=1e-3),
            lr_schedule=warmup_cosine(1e-3, 1, 3))
        loop = TrainLoop(cfg, shape, LoopConfig(
            total_steps=3, log_every=1, seed=5), step_fn, states[dev])
        _zero_flash_counts()
        loop.run()
        if dev == "cuda":
            counts = _flash_counts()
        losses[dev] = [m["loss"] for m in loop.metrics_log]
    diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    check(len(losses["cuda"]) == 3 and diff <= 1e-4,
          f"reduced {cfg.arch_id} train: CUDA losses {losses['cuda']} "
          f"differ from CPU {losses['cpu']} by {diff} (> 1e-4)")
    want = _expected_counts(cfg, 3)
    check(counts == want, f"reduced {cfg.arch_id} train: flash launches "
                          f"{counts}, expected {want}")
    print(f"[parity] reduced {cfg.arch_id} train (fp32, {what}batch 4 x "
          f"seq 64): losses CPU {['%.6f' % x for x in losses['cpu']]} CUDA "
          f"{['%.6f' % x for x in losses['cuda']]}, max |diff| {diff:.3e} "
          f"(tol 1e-4); flash launches {counts}")


def train_full_width(cfg, steps: int):
    """``cfg`` (bf16 compute, remat) from a seeded fp32-master state at
    batch TRAIN_BATCH x TRAIN_SEQ positions: the loss and gradient norm
    through the kernels against the chunked attention on one state and
    batch, then 1 untimed warm-up step and ``steps`` timed steps through
    TrainLoop.  Returns (flash launches of the timed steps, a summary)."""
    check(cfg.remat and cfg.dtype == torch.bfloat16,
          f"full-width {cfg.arch_id} train config must be bf16 with remat")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    print(f"[train] {cfg.arch_id} train state ({cfg.n_layers} layers): "
          f"{n_params / 1e9:.3f} B fp32 params + fp32 m, v, initialized in "
          f"{time.perf_counter() - t0:.2f} s")
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, kind="train")
    data = HostDataConfig(0, 1, 0)
    # the same loss and gradient through the kernels and, for comparison
    # only, with use_flash_attn off, which takes attention.chunked_attention
    # (the JAX package's path off the TPU), same state and batch; bf16
    # rounds at other places in the two
    batch0 = {k: torch.as_tensor(v).to(dev) for k, v in
              host_batch(cfg, shape, data, 0).items()}
    got = {}
    for flash in (True, False):
        run_cfg = dataclasses.replace(cfg, use_flash_attn=flash)
        vg = value_and_grad(lambda p, b: train_loss(p, b, run_cfg))
        _zero_flash_counts()
        loss, grads = vg(split_layers(state["params"]), batch0)
        got[flash] = (float(loss), float(global_norm(grads)),
                      _flash_counts()["fwd"])
        del grads
    del batch0
    check(got[True][2] > 0 and got[False][2] == 0,
          f"full train: flash forward launches {got[True][2]} through the "
          f"kernels, {got[False][2]} through the chunked attention")
    dl = abs(got[True][0] - got[False][0])
    dn = abs(got[True][1] - got[False][1]) / got[False][1]
    check(dl <= 2e-3 and dn <= 1e-3,
          f"full train: kernel path (loss, grad norm) {got[True][:2]} vs "
          f"chunked path {got[False][:2]}")
    print(f"[train] kernel path vs chunked path, same state and batch: loss "
          f"{got[True][0]:.5f} vs {got[False][0]:.5f} (|diff| {dl:.3e}, tol "
          f"2e-3), grad norm {got[True][1]:.4f} vs {got[False][1]:.4f} "
          f"(rel {dn:.3e}, tol 1e-3)")
    total = 1 + steps
    step_fn = build_train_step(
        cfg, AdamWConfig(lr=3e-4, grad_clip=1.0),
        lr_schedule=warmup_cosine(3e-4, TRAIN_WARMUP, TRAIN_TOTAL))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, warm = step_fn(state, host_batch(cfg, shape, data, 0))
    first_loss = float(warm["loss"])
    print(f"[train] warm-up step: loss {first_loss:.4f} grad_norm "
          f"{float(warm['grad_norm']):.4f} in "
          f"{time.perf_counter() - t0:.2f} s (untimed)")
    loop = TrainLoop(cfg, shape, LoopConfig(
        total_steps=total, log_every=1, seed=0), step_fn, state,
        data_cfg=data)
    del state
    torch.cuda.synchronize()
    _zero_flash_counts()
    t0 = time.perf_counter()
    loop.run(start_step=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    log = loop.metrics_log
    losses = [first_loss] + [m["loss"] for m in log]
    norms = [float(warm["grad_norm"])] + [m["grad_norm"] for m in log]
    check(len(log) == steps, f"full train: {len(log)} timed steps")
    check(all(math.isfinite(x) for x in losses + norms),
          f"full train: a loss or grad norm is not finite: {losses} {norms}")
    ln_v = math.log(cfg.vocab)
    check(abs(first_loss - ln_v) <= 1.0,
          f"full train: first loss {first_loss} not within 1.0 of "
          f"ln({cfg.vocab}) = {ln_v:.4f}")
    want = _expected_counts(cfg, steps)
    check(counts == want, f"full train: flash launches {counts}, expected "
                          f"{want} (fwd 2 * layers * steps under remat)")
    ms = [m["time_s"] * 1e3 for m in log]
    toks = steps * TRAIN_BATCH * TRAIN_SEQ
    for m in log:
        print(f"[train] step {m['step']}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} lr {m['lr']:.3e} "
              f"{m['time_s'] * 1e3:.1f} ms")
    print(f"[train] {cfg.arch_id}, {cfg.n_layers} layers, fp32 masters / "
          f"bf16 compute, remat, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: "
          f"{steps} timed steps, {toks} tokens in {wall:.3f} s = "
          f"{toks / wall:.1f} train tok/s; ms per step {['%.1f' % x for x in ms]}"
          f" (median {float(np.median(ms)):.1f}); first loss "
          f"{first_loss:.4f} vs ln(vocab) {ln_v:.4f}; flash launches "
          f"{counts}; max_memory_allocated {peak / 1e9:.3f} GB")
    summary = {"params": n_params, "layers": cfg.n_layers,
               "tok_s": toks / wall, "ms": ms, "first_loss": first_loss,
               "peak_gb": peak / 1e9, "launches": counts,
               "loss_kernel_vs_chunked": dl, "grad_norm_rel": dn}
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def phase_train_audio():
    """H1 at hubert-xlarge's published width and depth, then H2."""
    cfg = get_config(AUDIO_ARCH)
    check(not cfg.causal and cfg.encoder_only and
          cfg.frontend == "audio_stub", f"{AUDIO_ARCH}: not the audio stub")
    counts, summary = train_full_width(cfg, AUDIO_STEPS)
    summary["resume"] = checkpoint_resume(cfg)
    return counts, summary


def phase_train_vlm():
    """internvl2-26b at its published width, VLM_LAYERS of its layers."""
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, kind="train")
    batch = host_batch(cfg, shape, HostDataConfig(0, 1, 0), 0)
    check(batch["vision_embeds"].shape == (TRAIN_BATCH,
                                           cfg.n_frontend_tokens,
                                           cfg.frontend_dim) and
          batch["labels"].shape == (TRAIN_BATCH,
                                    TRAIN_SEQ - cfg.n_frontend_tokens),
          f"{VLM_ARCH}: batch shapes {[v.shape for v in batch.values()]}")
    print(f"[train] {VLM_ARCH}: {cfg.n_frontend_tokens} vision-stub "
          f"positions + {TRAIN_SEQ - cfg.n_frontend_tokens} text positions "
          f"a row; the loss on the text positions")
    return train_full_width(cfg, VLM_STEPS)


def _ckpt_bytes(d: str) -> int:
    return sum(e.stat().st_size for e in os.scandir(d))


def checkpoint_resume(cfg):
    """H2: a TrainLoop saving every RESUME_EVERY steps runs RESUME_STEPS
    steps from a seeded state; a fresh loop on a state from another seed
    restores step RESUME_EVERY from a directory holding only that
    checkpoint and runs the rest.  Its losses equal the first run's, and
    its params, m, v and step torch.equal the first run's last checkpoint
    read back: the same kernels on the same shapes, and no op of the step
    accumulates in a data-dependent order."""
    dev = torch.device("cuda")
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, kind="train")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        def state_bytes(n):    # fp32 params, m and v, and the int32 step
            specs = get_api(cfg).param_specs(
                dataclasses.replace(cfg, n_layers=n))
            return 12 * sum(math.prod(sp.shape) for sp in leaves(specs)) + 4

        free = shutil.disk_usage(root).free
        layers = min(cfg.n_layers, RESUME_LAYERS)
        while layers > 1 and 3 * state_bytes(layers) > free:
            layers -= 1
        if layers < min(cfg.n_layers, RESUME_LAYERS):
            print(f"[resume] {free / 1e9:.1f} GB free under {root}: less "
                  f"than 3 checkpoints of {state_bytes(cfg.n_layers) / 1e9:.2f}"
                  f" GB; H2 runs at {layers} of {cfg.n_layers} layers")
        run_cfg = dataclasses.replace(cfg, n_layers=layers)
        step_fn = build_train_step(
            run_cfg, AdamWConfig(lr=3e-4, grad_clip=1.0),
            lr_schedule=warmup_cosine(3e-4, TRAIN_WARMUP, TRAIN_TOTAL))

        def loop_for(seed, d):
            return TrainLoop(run_cfg, shape, LoopConfig(
                total_steps=RESUME_STEPS, ckpt_dir=d,
                ckpt_every=RESUME_EVERY, log_every=1, seed=0),
                step_fn, init_train_state(
                    run_cfg, torch.Generator(device=dev).manual_seed(seed)),
                data_cfg=HostDataConfig(0, 1, 0))

        first_dir, resume_dir = (os.path.join(root, n) for n in ("a", "b"))
        first = loop_for(RESUME_SEEDS[0], first_dir)
        t0 = time.perf_counter()
        first.run()
        first_s = time.perf_counter() - t0
        first_losses = [m["loss"] for m in first.metrics_log]
        saves = list(first.ckpt.timings)
        first.ckpt.close()
        del first
        gc.collect()
        torch.cuda.empty_cache()
        last = os.path.join(first_dir, f"step_{RESUME_STEPS:08d}")
        nbytes = _ckpt_bytes(last)
        mid = f"step_{RESUME_EVERY:08d}"
        os.makedirs(resume_dir)
        os.replace(os.path.join(first_dir, mid),
                   os.path.join(resume_dir, mid))
        check(ckpt.latest_step(resume_dir) == RESUME_EVERY,
              f"H2: {resume_dir} does not hold step {RESUME_EVERY} alone")
        resumed = loop_for(RESUME_SEEDS[1], resume_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = resumed.maybe_restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(start == RESUME_EVERY, f"H2: restored step {start}")
        resumed.run(start_step=start)
        resumed.ckpt.close()
        saves += resumed.ckpt.timings
        losses = [m["loss"] for m in resumed.metrics_log]
        check(losses == first_losses[RESUME_EVERY:],
              f"H2: resumed losses {losses} != the first run's "
              f"{first_losses[RESUME_EVERY:]}")
        t0 = time.perf_counter()
        want = ckpt.restore_checkpoint(first_dir, RESUME_STEPS,
                                       resumed.state)
        torch.cuda.synchronize()
        readback_s = time.perf_counter() - t0
        check(int(want["step"]) == int(resumed.state["step"]) ==
              RESUME_STEPS, "H2: the step counters differ")
        differ = [p for (p, x), (_, y) in zip(
            ckpt.flatten_with_paths(resumed.state),
            ckpt.flatten_with_paths(want)) if not torch.equal(x, y)]
        check(not differ, f"H2: the resumed state differs from the first "
                          f"run's step-{RESUME_STEPS} checkpoint at {differ}")
        del resumed, want
        gc.collect()
        torch.cuda.empty_cache()
        snap = [t["snapshot_s"] for t in saves]
        write = [t["write_s"] for t in saves]
        print(f"[resume] {run_cfg.arch_id} at {layers} layers: "
              f"{RESUME_STEPS} steps saving every {RESUME_EVERY} in "
              f"{first_s:.2f} s, then a fresh loop (seed {RESUME_SEEDS[1]}) "
              f"restored step {RESUME_EVERY} in {restore_s:.2f} s and ran "
              f"steps {RESUME_EVERY + 1}-{RESUME_STEPS}: losses {losses} == "
              f"the first run's; params, m, v and step torch.equal to its "
              f"step-{RESUME_STEPS} checkpoint (read back in "
              f"{readback_s:.2f} s)")
        print(f"[resume] a checkpoint: {nbytes / 1e9:.3f} GB on disk; "
              f"{len(saves)} saves: host copy (D2H, pinned) s "
              f"{['%.3f' % x for x in snap]}, file writes s "
              f"{['%.3f' % x for x in write]}; disk free at start "
              f"{free / 1e9:.1f} GB ({root})")
        return {"layers": layers, "ckpt_gb": nbytes / 1e9,
                "snapshot_s": snap, "write_s": write,
                "restore_s": restore_s, "readback_s": readback_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_flash_timing(shape=(TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128),
                       causal=True):
    """Device times at ``shape`` (B, S, Hq, Hkv, hd), bf16: the llama
    training path's by default.  The bounds count the head dim given (a
    head dim the bf16 kernels are not built for is zero-padded; the
    padded-work ratio is printed)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, hq, hkv, hd = shape
    dt = torch.bfloat16
    q, do = (torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
            for _ in range(2))
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, causal)
    reps = 20
    ms = {
        "fwd": device_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v,
                                                             causal), reps),
        "bwd_dq": device_ms(lambda: fa.flash_attention_bwd_dq_cuda(
            q, k, v, o, lse, do, causal), reps),
        "bwd_dkv": device_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
            q, k, v, lse, delta, do, causal), reps),
    }
    plain_fwd = device_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                          reps)
    plain_bwd = device_ms(lambda: fa.flash_attention_plain_bwd(
        q, k, v, o, lse, do, causal), reps)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    with torch.no_grad():
        lib_fwd = device_ms(sdpa, reps)
        lib_err = float((sdpa().transpose(1, 2).float() - o.float())
                        .abs().max())
    lib_fwdbwd = device_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                       dot), reps)
    out = sdpa()
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), reps)
    rows = {}
    for part, plain_ms, lib_ms in (("fwd", plain_fwd, lib_fwd),
                                   ("bwd_dq", plain_bwd, lib_bwd),
                                   ("bwd_dkv", plain_bwd, lib_bwd),
                                   ("bwd", plain_bwd, lib_bwd)):
        flops = fa.bound_flops(b, s, hq, hd, causal, part)
        nbytes = fa.bound_bytes(b, s, hq, hkv, hd, dt, part)
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        kernel = (ms["bwd_dq"] + ms["bwd_dkv"]) if part == "bwd" else ms[part]
        rows[part] = {"ms": kernel, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "flops": flops, "bytes": nbytes}
        print(f"[time] flash {part} (B,S,Hq,Hkv,hd)={(b, s, hq, hkv, hd)} "
              f"bf16 causal={causal}: kernel_ms {kernel:.4f} bound_ms "
              f"{rows[part]['bound_ms']:.4f} ({flops:.4e} flop / 989 "
              f"TFLOP/s; {nbytes} B / 3.35 TB/s) plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} kernel/bound "
              f"{kernel / rows[part]['bound_ms']:.1f}")
    for part, lib_ms in (("fwd", lib_fwd), ("bwd", lib_bwd)):
        r = rows[part]
        r["bf16_peak_share"] = r["flops"] / (r["ms"] * 1e-3) / BF16_FLOP_PER_S
        r["library_bf16_peak_share"] = r["flops"] / (lib_ms * 1e-3) / \
            BF16_FLOP_PER_S
    print(f"[time] flash forward: {ms['fwd']:.4f} ms; its 2 matmuls at "
          f"{rows['fwd']['flops'] / ms['fwd'] / 1e9:.1f} TFLOP/s = "
          f"{rows['fwd']['bf16_peak_share']:.3f} of the 989 TFLOP/s bf16 "
          f"peak; SDPA forward {lib_fwd:.4f} ms, "
          f"{rows['fwd']['flops'] / lib_fwd / 1e9:.1f} TFLOP/s = "
          f"{rows['fwd']['library_bf16_peak_share']:.3f}")
    bwd_ms = ms["bwd_dq"] + ms["bwd_dkv"]
    built = fa.bound_flops(b, s, hq, hd, causal, "bwd") * 7 // 5
    print(f"[time] flash backward (dq + dk/dv): {bwd_ms:.4f} ms; the "
          f"function's 5 matmuls at {rows['bwd']['flops'] / bwd_ms / 1e9:.1f}"
          f" TFLOP/s = {rows['bwd']['bf16_peak_share']:.3f} of the 989 "
          f"TFLOP/s bf16 peak; the 7 matmuls the kernels do (S and dP "
          f"recomputed) at {built / bwd_ms / 1e9:.1f} TFLOP/s = "
          f"{built / (bwd_ms * 1e-3) / BF16_FLOP_PER_S:.3f}; SDPA backward "
          f"{rows['bwd']['flops'] / lib_bwd / 1e9:.1f} TFLOP/s = "
          f"{rows['bwd']['library_bf16_peak_share']:.3f}")
    padded = fa._pad_bf16(q)[0].shape[-1]   # the head dim the kernels ran
    if padded != hd:
        print(f"[time] head dim {hd} runs padded to {padded}: the kernels do "
              f"{padded / hd:.3f}x the bound's work (padded-work ratio "
              f"{padded} / {hd})")
    print(f"[time] scaled_dot_product_attention (is_causal={causal}, "
          f"enable_gqa) at "
          f"the same shape: fwd {lib_fwd:.4f} ms, fwd+bwd {lib_fwdbwd:.4f} "
          f"ms, bwd {lib_bwd:.4f} ms; kernel fwd+bwd "
          f"{ms['fwd'] + ms['bwd_dq'] + ms['bwd_dkv']:.4f} ms; max |o - "
          f"sdpa| {lib_err:.3e}")
    return rows


def adder_shapes(cfg):
    """The adder path's shapes, from one training step of ``cfg`` at batch
    TRAIN_BATCH x seq TRAIN_SEQ: bitplane_add (label, N, M, B) over one
    activation tensor, quant_matmul (label, M, K, N) at the projections."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    lanes = tokens * cfg.d_model
    bitplane = [("16x16", 16, 16, lanes), ("4x16", 4, 16, lanes),
                ("64x20", 64, 20, lanes)]
    matmul = [("gate_up", tokens, cfg.d_model, cfg.d_ff),
              ("down", tokens, cfg.d_ff, cfg.d_model),
              ("q_o", tokens, cfg.d_model, cfg.n_heads * cfg.hd)]
    return bitplane, matmul


def _lanes(n, m_bits, b, gen):
    return torch.randint(0, 2 ** m_bits, (n, b), generator=gen,
                         device="cuda", dtype=torch.int32)


def _int8(shape, gen):
    return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _unaligned_int8(shape, gen):
    """A contiguous int8 tensor whose base is 1 byte past 16-byte aligned."""
    flat = _int8((shape[0] * shape[1] + 16,), gen)
    return flat[1:1 + shape[0] * shape[1]].view(shape)


def phase_adder_check(bitplane, matmul):
    """Both kernels against their plain versions on the same CUDA inputs,
    torch.equal.  Returns the max |diff| of each (0 when all are equal)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    err = {"bitplane_add": 0, "quant_matmul": 0}
    # the kernel-test shapes, then B % 4 != 0 (the 1-lane instance), N = 1,
    # 2, 5, 17, 64, M = 1 and 31, K = 1 .. 7 counter words, and an offset
    # view that is not 16-byte aligned (unaligned=True)
    cases = [(4, 4, 64), (4, 16, 256), (16, 16, 128), (3, 8, 33),
             (64, 20, 512), (1, 31, 100), (2, 30, 1000), (5, 12, 4099),
             (17, 8, 4096), (9, 1, 1026), (40, 24, 2048), (64, 1, 260),
             (8, 16, 4096), (33, 16, 12345)]
    cases = [c + (False,) for c in cases] + [(16, 16, 4096, True)]
    cases += [(n, m, b, False) for _, n, m, b in bitplane]
    fig12 = torch.tensor([[0xA], [0xF], [0x1], [0x2]], dtype=torch.int32,
                         device="cuda").repeat(1, 256)
    for n, m_bits, b, unaligned in cases + [(4, 4, None, False)]:
        if b is None:
            x = fig12
        elif unaligned:
            x = _lanes(n, m_bits, b + 1, gen).reshape(-1)[1:1 + n * b]
            x = x.reshape(n, b)
            check(x.data_ptr() % 16 != 0, "the unaligned case is aligned")
        else:
            x = _lanes(n, m_bits, b, gen)
        got = bpa.bitplane_add_cuda(x, m_bits)
        want = bpa.bitplane_add_plain(x, m_bits)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and
              torch.equal(got, x.sum(0, dtype=torch.int32)),
              f"bitplane_add != bitplane_add_plain at N={n} M={m_bits} B={b}"
              f"{' unaligned' if unaligned else ''}")
        err["bitplane_add"] = max(err["bitplane_add"],
                                  int((got - want).abs().max()))
        del x, got, want
    check(bool((bpa.bitplane_add_cuda(fig12, 4) == 0x1C).all()),
          "bitplane_add: Fig 12 lanes do not give 0x1C")
    before = bpa.LAUNCHES
    try:
        bpa.bitplane_add_cuda(torch.zeros((8, 4), dtype=torch.int32,
                                          device="cuda"), 30)
        raised = False
    except ValueError:
        raised = True
    check(raised and bpa.LAUNCHES == before,
          "bitplane_add: the width guard did not raise before a launch")
    # (M, K, N, acc_bits, operands): the kernel-test shapes, ragged tiles of
    # the wgmma kernel, K or N not a multiple of 16 and unaligned bases (the
    # mma.sync kernel), the path's shapes, and the all -128 and wrap cases
    mm_cases = [(8, 128, 128, 32), (32, 384, 256, 32), (130, 257, 65, 32),
                (256, 1024, 512, 32), (130, 257, 65, 18), (130, 272, 208, 32),
                (130, 272, 208, 18), (1, 16, 16, 32), (300, 4112, 272, 32),
                (300, 4112, 272, 18), (17, 40, 9, 32), (130, 272, 200, 32),
                (1, 16, 8, 32), (300, 4112, 264, 18)]
    mm_cases = [c + ("random",) for c in mm_cases]
    mm_cases += [(130, 256, 64, 32, "x_unaligned"),
                 (130, 256, 64, 32, "w_unaligned")]
    mm_cases += [(m, k, n, 32, "random") for _, m, k, n in matmul]
    mm_cases += [(4, 8192, 4, 32, "all_-128"), (4, 262144, 16, 32, "wrap"),
                 (4, 262144, 4, 32, "wrap")]
    routes = {"wgmma": 0, "mma_sync": 0}
    for m, k, n, acc_bits, kind in mm_cases:
        if kind == "all_-128":             # the reference's worst case
            x = torch.full((m, k), -128, dtype=torch.int8, device="cuda")
            w = torch.full((k, n), -128, dtype=torch.int8, device="cuda")
        elif kind == "wrap":               # two plan blocks whose sum wraps
            x = torch.full((m, k), -128, dtype=torch.int8, device="cuda")
            w = torch.full((k, n), 127, dtype=torch.int8, device="cuda")
        elif kind.endswith("unaligned"):   # a base 1 byte past alignment
            x = (_unaligned_int8 if kind[0] == "x" else _int8)((m, k), gen)
            w = (_unaligned_int8 if kind[0] == "w" else _int8)((k, n), gen)
        else:
            x, w = _int8((m, k), gen), _int8((k, n), gen)
        which = qmm.route(k, n, x.data_ptr(), w.data_ptr())
        before = (qmm.WGMMA_LAUNCHES, qmm.MMA_SYNC_LAUNCHES)
        got = qmm.quant_matmul_cuda(x, w, acc_bits)
        want = qmm.quant_matmul_plain(x, w, acc_bits)
        torch.cuda.synchronize()
        took = (qmm.WGMMA_LAUNCHES - before[0],
                qmm.MMA_SYNC_LAUNCHES - before[1])
        check(took == ((1, 0) if which == "wgmma" else (0, 1)),
              f"quant_matmul at {(m, k, n)} {kind}: route {which}, launches "
              f"(wgmma, mma.sync) {took}")
        check((which == "wgmma") == (k % 16 == 0 and n % 16 == 0
                                      and not kind.endswith("unaligned")),
              f"quant_matmul at {(m, k, n)} {kind}: route {which}")
        routes[which] += 1
        check(torch.equal(got, want),
              f"quant_matmul != quant_matmul_plain at {(m, k, n)} acc_bits "
              f"{acc_bits} {kind}")
        err["quant_matmul"] = max(err["quant_matmul"],
                                  int((got.long() - want.long()).abs().max()))
        if kind == "all_-128":
            check(bool((got == k * 128 * 128).all()),
                  "quant_matmul: all -128 at K = 8192 is not 8192 * 2^14")
        if kind == "wrap":
            check(bool((got == 33554432).all()),
                  f"quant_matmul ({which}): x -128, w 127 at K = 262144 is "
                  f"not 33554432 (the int32 wrap of two plan blocks)")
        del x, w, got, want
    print(f"[check] bitplane_add == bitplane_add_plain (torch.equal) on "
          f"{len(cases) + 1} shapes incl. Fig 12, ragged and unaligned lanes "
          f"and the path's; width guard "
          f"raises before a launch; quant_matmul == quant_matmul_plain on "
          f"{len(mm_cases)} shapes incl. ragged tiles, unaligned bases, all "
          f"-128 at K = 8192, the two-block wrap at K = 262144 (33554432, "
          f"both routes) and the path's, by route {routes}; max |diff| "
          f"{err}")
    return err


def phase_adder_path(cfg, bitplane, matmul):
    """The library's multi-operand integer adders on the card at the
    path's shapes, with the launch counts read around the run."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    bpa.LAUNCHES = qmm.LAUNCHES = 0
    qmm.WGMMA_LAUNCHES = qmm.MMA_SYNC_LAUNCHES = qmm.TRANSPOSE_LAUNCHES = 0
    # Fig 3 == Fig 4 on the card: the netlist over all 16 codes is the LUT
    codes = torch.arange(16, dtype=torch.int32, device="cuda")
    bits = (codes[:, None] >> torch.arange(4, dtype=torch.int32,
                                           device="cuda")) & 1
    check(torch.equal(lut.lut4_netlist(bits), lut.lut4_lookup(codes)),
          "core.lut: the Fig-4 netlist differs from the Fig-3 table")
    for label, n, m_bits, b in bitplane:
        rplan = reconfig.plan_reconfig(n, m_bits)
        x = _lanes(n, m_bits, b, gen)
        want = x.sum(0, dtype=torch.int32)
        got = ops.bitplane_add(x, m_bits)
        check(torch.equal(got, want),
              f"bitplane_add {label}: not the int32 sum")
        line = (f"[adder] bitplane_add {label} (N={n}, M={m_bits}, B={b}): "
                f"exact; plan_reconfig: {len(rplan.levels)} levels, "
                f"{rplan.total_modules} modules, {rplan.result_bits} result "
                f"bits, serial {rplan.serial_clocks} clocks vs "
                f"{rplan.latency_stages} stages")
        if (n, m_bits) == (16, 16):     # Fig 15 on the same lanes
            lanes = x.t().contiguous()              # core.moa's (B, N)
            del x
            carry_max = 0
            for i, chunk in enumerate(lanes.split(1 << 21)):
                res, st = core_moa.reconfigured_add(chunk, m_bits,
                                                    return_structure=True)
                ser, clocks = core_moa.serial_add(chunk, m_bits)
                part = want[i << 21:(i << 21) + chunk.shape[0]]
                check(torch.equal(res, part) and torch.equal(ser, part),
                      "core.moa reconfigured_add / serial_add: not the sum")
                carry_max = max(carry_max, int(st["carry_total"].max()))
                del res, st, ser
            check(carry_max <= n - 1 and clocks == m_bits + 1,
                  f"core.moa: carry {carry_max} > N - 1 or clocks {clocks}")
            # Lemma 3: serial units of one Fig-4 LUT each against the
            # reconfigured adder's gate area, in the lanes' massively
            # parallel setting
            serial = planner.UnitSpec(area=lut.LUT_AREA_GATES,
                                      clocks_per_op=rplan.serial_clocks)
            parallel = planner.UnitSpec(area=rplan.gate_cost.area_gates,
                                        clocks_per_op=rplan.latency_stages)
            wins = planner.serial_beats_parallel(serial, parallel)
            line += (f"; core.moa reconfigured_add and serial_add equal it "
                     f"(max carry {carry_max} <= {n - 1}, {clocks} clocks); "
                     f"Lemma 3, serial LUT units ({lut.LUT_AREA_GATES} gates, "
                     f"{rplan.serial_clocks} clocks) beat the reconfigured "
                     f"adder ({rplan.gate_cost.area_gates:.0f} gates, "
                     f"{rplan.latency_stages} stages) in equal area: {wins}")
            del lanes
        print(line)
        del got, want
    for label, m, k, n in matmul + [("down_all_-128", matmul[1][1],
                                     matmul[1][2], matmul[1][3])]:
        if label.endswith("-128"):
            x = torch.full((m, k), -128, dtype=torch.int8, device="cuda")
            w = torch.full((k, n), -128, dtype=torch.int8, device="cuda")
        else:
            x, w = _int8((m, k), gen), _int8((k, n), gen)
        plan = qmm.k_plan(k)
        which = qmm.route(k, n, x.data_ptr(), w.data_ptr())
        check(which == "wgmma", f"quant_matmul {label}: route {which}")
        got = ops.quant_matmul(x, w)
        want = ref.quant_matmul_ref(x, w)
        check(torch.equal(got, want), f"quant_matmul {label}: not exact")
        if label.endswith("-128"):
            check(bool((got == k * 128 * 128).all()),
                  f"quant_matmul {label}: not {k} * 2^14 everywhere")
        print(f"[adder] quant_matmul {label} ({m}, {k}) @ ({k}, {n}): exact "
              f"(float64 oracle) through the {which} kernel; plan block "
              f"{plan.block}, {plan.num_blocks} block(s), max_block "
              f"{plan.max_block}")
        del x, w, got, want
    counts = {"bitplane_add": bpa.LAUNCHES, "quant_matmul": qmm.LAUNCHES,
              "quant_matmul_wgmma": qmm.WGMMA_LAUNCHES,
              "quant_matmul_mma_sync": qmm.MMA_SYNC_LAUNCHES,
              "quant_matmul_transpose": qmm.TRANSPOSE_LAUNCHES}
    calls = len(matmul) + 1
    want = {"bitplane_add": len(bitplane), "quant_matmul": calls,
            "quant_matmul_wgmma": calls, "quant_matmul_mma_sync": 0,
            "quant_matmul_transpose": 0}
    check(counts == want, f"adder path: launches {counts}, expected {want}")
    print(f"[adder] launches on the adder path: {counts}")
    return counts


def qmm_old_parts(x, w):
    """Device ms of the parts of the parent design of quant_matmul at one
    shape, which the mma.sync route keeps: PyTorch's per-call copy of w to
    K-major (the parent's), the qmm_transpose pre-pass that replaces it,
    and the mma.sync product on the K-major w."""
    k = x.shape[1]
    copy = device_ms(lambda: w.t().contiguous(), 20)
    prepass = device_ms(lambda: qmm.transpose_w_cuda(w), 20)
    wt = qmm.transpose_w_cuda(w)
    bk = min(qmm.k_plan(k).block, k)
    sync = device_ms(lambda: qmm.mma_sync_cuda(x, wt, k, bk), 20)
    return {"copy_ms": copy, "prepass_ms": prepass, "mma_sync_ms": sync}


def phase_adder_timing(bitplane, matmul):
    """Device times at the path shapes beside the bound, the plain version
    and the library call."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {"bitplane_add": [], "quant_matmul": []}
    for label, n, m_bits, b in bitplane:
        x = _lanes(n, m_bits, b, gen)
        kernel = device_ms(lambda: bpa.bitplane_add_cuda(x, m_bits), 20)
        plain = device_ms(lambda: bpa.bitplane_add_plain(x, m_bits), 3)
        library = device_ms(lambda: torch.sum(x, 0, dtype=torch.int32), 20)
        nbytes = bpa.bound_bytes(n, b)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (n - 1) * b / INT32_OPS_PER_S * 1e3
        per_lane = bpa.netlist_ops_per_lane(n)
        alu = per_lane * b / INT32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        rows["bitplane_add"].append({
            "label": label, "shape": [n, m_bits, b], "ms": kernel,
            "plain_ms": plain, "library_ms": library, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes})
        print(f"[time] bitplane_add {label} N={n} M={m_bits} B={b}: kernel_ms "
              f"{kernel:.4f} bound_ms {bound:.4f} ({nbytes} B / 3.35 TB/s; "
              f"{n - 1} adds per lane {t_ops:.4f} ms) library_ms "
              f"{library:.4f} (torch.sum) plain_ms {plain:.4f} kernel/bound "
              f"{kernel / bound:.2f} kernel/library {kernel / library:.3f}; "
              f"the kernel's source: {per_lane} int ops per lane (bit-sliced "
              f"counters, K = {max(1, n.bit_length())}), estimated, not "
              f"measured, at {alu:.4f} ms at 16.7 Tops/s INT32")
        del x
    for label, m, k, n in matmul:
        x, w = _int8((m, k), gen), _int8((k, n), gen)
        kernel = device_ms(lambda: qmm.quant_matmul_cuda(x, w), 20)
        old = qmm_old_parts(x, w)
        plain = device_ms(lambda: qmm.quant_matmul_plain(x, w), 5)
        library = device_ms(lambda: torch._int_mm(x, w), 20)
        # the same call on a column-major copy of w, for reference only
        wc = w.t().contiguous().t()
        library_col = device_ms(lambda: torch._int_mm(x, wc), 20)
        check(torch.equal(torch._int_mm(x, wc), qmm.quant_matmul_cuda(x, w)),
              f"torch._int_mm differs from the kernel at {label}")
        ops_ = qmm.bound_ops(m, k, n)
        nbytes = qmm.bound_bytes(m, k, n)
        t_ops = ops_ / INT8_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        tops = ops_ / kernel * 1e-9
        rows["quant_matmul"].append({
            "label": label, "shape": [m, k, n], "ms": kernel,
            "plain_ms": plain, "library_ms": library, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops_, "bytes": nbytes,
            "library_ms_w_column_major": library_col, "tops": tops,
            "int8_peak_share": tops * 1e12 / INT8_OPS_PER_S,
            "parent_copy_ms": old["copy_ms"],
            "mma_sync_route_prepass_ms": old["prepass_ms"],
            "mma_sync_route_product_ms": old["mma_sync_ms"]})
        print(f"[time] quant_matmul {label} ({m}, {k}) @ ({k}, {n}): "
              f"kernel_ms {kernel:.4f} (qmm_wgmma on the row-major w: every "
              f"launch) bound_ms {bound:.4f} ({ops_:.4e} int8 ops / 1979 "
              f"TOP/s; {nbytes} B / 3.35 TB/s = {t_bytes:.4f} ms) "
              f"library_ms {library:.4f} (torch._int_mm, w row-major; "
              f"{library_col:.4f} w column-major) plain_ms {plain:.4f} "
              f"kernel/bound {kernel / bound:.2f} kernel/library "
              f"{kernel / library:.3f} kernel/library_column_major "
              f"{kernel / library_col:.3f}; {tops:.1f} TOP/s, "
              f"{tops * 1e12 / INT8_OPS_PER_S:.3f} of the int8 peak")
        print(f"[time] quant_matmul {label} mma.sync route (the parent's "
              f"design): pre-pass qmm_transpose {old['prepass_ms']:.4f} ms "
              f"(bound {2 * k * n / HBM_BYTES_PER_S * 1e3:.4f}, {2 * k * n} "
              f"B) + mma.sync product {old['mma_sync_ms']:.4f} ms; the "
              f"parent's PyTorch w.t().contiguous() {old['copy_ms']:.4f} ms")
        del x, w, wc
    return rows


#: phase R: the dry-run cell of each timed step, (label, arch, shape,
#: layers it ran at or None for all, params' dtype or None for the specs'
#: fp32 masters).  Serve steps: phase 6's geometry (4 slots x max_seq 2048,
#: a prefill dispatch is one slot's 256-token chunk), bf16 weights; train
#: steps: batch 2 x 2048 positions
SERVE_DECODE = ShapeConfig("decode_4x2048", 2048, 4, "decode")
SERVE_PREFILL = ShapeConfig("prefill_1x256", 256, 1, "prefill")
TRAIN_CELL = ShapeConfig("train_2x2048", TRAIN_SEQ, TRAIN_BATCH, "train")
ROOFLINE_STEPS = (
    ("6 decode step (mean)", "llama3.2-3b", SERVE_DECODE, None,
     torch.bfloat16),
    ("6 prefill chunk (mean)", "llama3.2-3b", SERVE_PREFILL, None,
     torch.bfloat16),
    ("Q bf16 decode step (p50)", QKV_ARCH, SERVE_DECODE, None,
     torch.bfloat16),
    ("M1 decode step (p50)", MOE_ARCH, SERVE_DECODE, MOE_LAYERS,
     torch.bfloat16),
    ("S decode step (p50)", SSM_ARCH, SERVE_DECODE, None, torch.bfloat16),
    ("Z decode step (p50)", HYBRID_ARCH, SERVE_DECODE, None,
     torch.bfloat16),
    ("9 train step (median)", "llama3.2-3b", TRAIN_CELL, None, None),
    ("H1 train step (median)", AUDIO_ARCH, TRAIN_CELL, None, None),
    ("V train step (median)", VLM_ARCH, TRAIN_CELL, VLM_LAYERS, None),
)


#: phase R's worker processes beside this one: the meta traces are
#: host-bound Python, and a process's first trace pays ~8 s of imports on
#: the card's host, so the serve steps' short traces (~1 s each) run in
#: workers while this process, already warm, takes the train steps' long
#: ones (5-15 s each)
ROOFLINE_WORKERS = 3


def phase_roofline(measured_ms: dict) -> None:
    """Phase R: each step of ``ROOFLINE_STEPS`` traced on meta tensors by
    the dry run's ``run_cell`` (nothing runs on the card): the train
    steps here, the serve steps in ``ROOFLINE_WORKERS`` spawned processes
    meanwhile; printed beside ``measured_ms[label]``."""
    cells = []
    for label, arch, shape, layers, param_dtype in ROOFLINE_STEPS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cells.append((label, arch, shape, cfg, param_dtype))

    def trace(i):
        _, arch, shape, cfg, param_dtype = cells[i]
        return dict(arch_id=arch, shape=shape, cfg=cfg,
                    param_dtype=param_dtype, verbose=False)

    train = [i for i, c in enumerate(cells) if c[2].kind == "train"]
    with ProcessPoolExecutor(ROOFLINE_WORKERS,
                             mp_context=mp.get_context("spawn")) as ex:
        futures = {i: ex.submit(run_cell, **trace(i))
                   for i in range(len(cells)) if i not in train}
        records = {i: run_cell(**trace(i)) for i in train}
        records.update({i: f.result() for i, f in futures.items()})
    records = [records[i] for i in range(len(cells))]
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[roofline] card total_memory {total / 1e9:.3f} GB "
          f"({total} B, torch.cuda.get_device_properties) against the "
          f"{H100.name} entry's hbm_per_chip {H100.hbm_per_chip / 1e9:.0f} "
          f"GB; bounds at {H100.peak_flops / 1e12:.0f} TFLOP/s bf16 and "
          f"{H100.hbm_bw / 1e12:.2f} TB/s")
    for (label, arch, shape, cfg, _), rec in zip(cells, records):
        ro = rec["roofline"]
        ms = measured_ms[label]
        resident = rec["resident_bytes_per_device"]
        check(ro["bound_s"] > 0 and math.isfinite(ro["bound_s"])
              and ms > 0 and resident < total,
              f"R {label}: bound {ro['bound_s']} s, measured {ms} ms, "
              f"resident {resident} B")
        print(f"[roofline] {label}: {arch}, {cfg.n_layers} layers, "
              f"{shape.kind} {shape.global_batch} x {shape.seq_len}, params "
              f"{rec['param_dtype'] or 'fp32'}: measured {ms:.3f} ms; bound "
              f"{fmt_seconds(ro['bound_s'])} ({ro['dominant']}; compute "
              f"{fmt_seconds(ro['compute_s'])}, memory "
              f"{fmt_seconds(ro['memory_s'])}); resident "
              f"{resident / 1e9:.3f} GB / 3.35 TB/s = "
              f"{1e3 * resident / H100.hbm_bw:.3f} ms; measured / bound "
              f"{ms / (1e3 * ro['bound_s']):.2f}; traced in "
              f"{rec['trace_s']:.2f} s")


#: phase X: the mesh's collective half on the one card.  Its ranks are
#: processes that all sit on cuda:0, joined by gloo: NCCL refuses two
#: ranks of one communicator on one device.  gloo takes CUDA tensors for
#: every op the mesh uses (repro_torch.dist.gloo_probe on the card's torch
#: 2.11), so no payload is staged through host memory.  X1-X4 run on one
#: spawn of 2 ranks with X6 and X7, X5 on one of 3.
X_TRANSPORT = ("gloo, tensors on the ranks' device, no host staging "
               "(gloo takes CUDA tensors for all_reduce sum/max, all_gather, "
               "reduce_scatter and all_to_all: python -m "
               "repro_torch.dist.gloo_probe)")
X_WORLDS = ((2, ("X1", "X2", "X3", "X4", "X4m", "X6", "X7")), (3, ("X5",)))
#: X3: llama3.2-3b cut to 1 of 28 layers: 0.89 B params, x 20 B (fp32
#: params, m, v, grads, err) = ~18 GB a rank (at 4 layers X3 took 32.6 s,
#: its oracle 20.4; at 2, 26.8-36.2 s, and the smoke with X7 took 1151.4 s
#: of phases on a slow host)
X_TRAIN_LAYERS = 1
#: X4: one split-K decode step of 2 sequences at cache position X_INDEX of
#: X_CACHE (model rank 1 owns it and writes the new row); X4m the same for
#: MLA's latent cache (minicpm3-4b at F's MLA_LAYERS of 62)
X_CACHE, X_DECODE_BATCH, X_INDEX = 8192, 2, 6000
#: X2: 2 x 1024 tokens; on 2 expert ranks each routes 1024
X_MOE_TOKENS = (2, 1024)
#: X5: qwen2.5-14b's attention layout at 1 of its 48 layers, fp32, one
#: sequence of 512 (at 2 layers each of the 3 ranks held the 2.11 B params
#: and their gradients, 16.9 GB; at 2048 the three ranks and the smoke's
#: own process ran the card out of memory; at 2 layers and 1024 tokens X5
#: took 28.3-40.3 s, at 2 and 512 25.1-31.9 s)
X_PAD_ARCH, X_PAD_LAYERS, X_PAD_SEQ = "qwen2.5-14b", 1, 512
#: X6: llama3.2-3b's sharded train state at 2 of 28 layers, 989,346,816
#: params: 11.87 GB of fp32 params, m and v, 5.94 GB a rank on
#: (data 2, model 1); each of its two checkpoints is the whole 11.87 GB
#: on disk
X6_LAYERS = 2
#: X6: the largest relative L2 error of a leaf of m, v or the param update
#: of the one-device step 2 against the mesh's.  The two take the same
#: state and batch and differ in the gradient's rounding alone (bf16
#: compute, a row a rank against both rows at once); a lost moment, a
#: wrong block of the reduce-scatter or a wrong update is O(1)
X6_STATE_RTOL = 1e-2
#: X7: llama3.2-3b at 2 of 28 layers on (model 2, data 1), fp32 (TF32
#: off), the sequence-parallel step: X6's 2 x TRAIN_SEQ batch, each rank
#: its TRAIN_SEQ / 2 stretch; a ragged step at X7_RAGGED_SEQ (model 2 does
#: not divide it: the logits split over the vocab); decode: an
#: X7_PROMPT-token prompt through prefill_chunk into a split-K cache of
#: X7_CACHE positions (the chunk straddles the two ranks' stretches), then
#: X7_DECODE greedy steps.  fp32, not the published bf16, as X5: the head
#: split rounds each token's bf16 sums otherwise than one device does, and
#: AdamW's first updates, near sign(g) a parameter, turn that into a 4-6%
#: gap in the embedding's update (bf16 on an H100: 4.2e-2 for the
#: sequence-parallel step 2, 6.0e-2 for the ragged step), over
#: X6_STATE_RTOL, with no fault behind it
X7_LAYERS, X7_RAGGED_SEQ = 2, TRAIN_SEQ - 1
X7_PROMPT, X7_CACHE, X7_DECODE = 512, 768, 8
#: seconds a spawn may run, and one collective may wait
X_SPAWN_TIMEOUT, X_COLLECTIVE_TIMEOUT = 600, 300
#: the spawn's scratch directory, in each rank (X6's checkpoint goes there)
X_DIR = None


def x_configs(reduced: bool = False) -> dict:
    """Phase X's configs: published widths (cut in depth where said), or,
    to rehearse on the CPU, the reduced fp32 ones."""
    def cut(arch, **over):
        cfg = get_config(arch)
        if reduced:
            return cfg.reduced(dtype=torch.float32)
        return dataclasses.replace(cfg, **over)
    moe_cfg = cut(MOE_ARCH, dtype=torch.float32)
    moe_cfg = dataclasses.replace(
        moe_cfg, use_ep=True,
        capacity_factor=moe_cfg.n_experts / moe_cfg.top_k)  # drop-free
    return {"X1": cut("llama3.2-3b"), "X2": moe_cfg,
            "X3": cut("llama3.2-3b", n_layers=X_TRAIN_LAYERS),
            "X4": cut("llama3.2-3b"),
            "X4m": cut(MLA_ARCH, n_layers=MLA_LAYERS),
            "X6": cut("llama3.2-3b", n_layers=X6_LAYERS),
            # reduced: an even vocab, which the ragged step splits
            "X7": (get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                                     vocab=96) if reduced
                   else cut("llama3.2-3b", n_layers=X7_LAYERS,
                            dtype=torch.float32)),
            "X5": cut(X_PAD_ARCH, n_layers=X_PAD_LAYERS,
                      dtype=torch.float32)}


def _x_diff(a, b) -> float:
    """max |a - b|."""
    return float((a.float() - b.float()).abs().max())


def x1_tree_collectives(cfg, dev, mesh):
    """X1: the gradient leaves of ``cfg`` at its published width (one
    layer's, the other layers repeat their shapes, and the final norm's)
    through the radix-4 tree: an int32 ``tree_psum``
    of int8-range payloads equals the sum on one rank (each rank draws
    every rank's payload from its seed), and ``compressed_psum_mean``'s
    mean equals ``(g + e - new_err)`` summed over the ranks and divided by
    n within 1e-6."""
    n, rank = mesh.shape["data"], mesh.index("data")
    tree, sub = make_tree_mesh(mesh, "data")
    plan = make_reduction_plan(n, payload_bits=8, acc_bits=32)
    # the train step's gradient leaves of one layer and the final norm (all
    # 255 leaves took 52.6 s on an H100 80GB HBM3 at 700 W, 43.3 GB a rank
    # through gloo at 0.82 GB/s; with the embedding and the head, 14-15 s)
    pspecs = get_api(cfg).param_specs(cfg)
    shapes = [s.shape[1:] for s in leaves(pspecs["blocks"])]
    shapes.append(pspecs["final_norm"].shape)
    worst, elems = 0.0, 0
    for i, shape in enumerate(shapes):
        gens = [torch.Generator(device=dev).manual_seed(7919 * i + r)
                for r in range(n)]
        ints = [torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int32) for g in gens]
        got = tree_psum(ints[rank], sub, plan=plan, mesh=tree)
        check(torch.equal(got, sum(ints)),
              f"X1 int32 tree_psum != the sum at leaf {i} {shape}")
        del ints, got
        g = torch.randn(shape, generator=gens[rank], device=dev)
        e = 1e-3 * torch.randn(shape, generator=gens[rank], device=dev)
        mean, new_err = compressed_psum_mean({"g": g}, {"g": e}, sub, n,
                                             mesh=tree)
        recon = tree_psum(g + e - new_err["g"], sub, mesh=tree) / n
        check(torch.allclose(recon, mean["g"], rtol=1e-6, atol=1e-6),
              f"X1 compressed mean != (g + e - new_err) meaned at leaf {i}")
        worst = max(worst, _x_diff(recon, mean["g"]))
        elems += g.numel()
        del g, e, mean, new_err, recon
    return {"leaves": len(shapes), "elements": elems,
            "max_abs_err": worst}


def x2_moe_ep(cfg, dev, mesh):
    """X2: one MoE layer of ``cfg`` (fp32, drop-free) on the expert ranks:
    ``moe_ffn_ep`` on each rank's half of the sequence and
    ``moe_ffn_ep_psum`` on all the tokens match the dense dispatch with the
    whole weights on one rank within 2e-4; each launches moa_reduce once;
    and moa_reduce at the per-rank combine shape is torch.equal to its
    plain version."""
    ep, m = mesh.shape["model"], mesh.index("model")
    gen = torch.Generator(device=dev).manual_seed(11)
    p = init_params(moe.moe_param_specs(cfg), gen, dev)
    x = torch.randn(X_MOE_TOKENS + (cfg.d_model,), generator=gen, device=dev)
    y_ref, aux_ref = moe.moe_ffn_dense_dispatch(x, p, cfg)
    blk = {"router": p["router"].chunk(ep, 1)[m],
           **{k: p[k].chunk(ep, 0)[m] for k in ("w1", "w3", "w2")}}
    launches = {}
    _zero_kernel_counts()
    y_ep, aux_ep = moe.moe_ffn_ep(x.chunk(ep, 1)[m], blk, cfg, mesh)
    _sync_if(dev)
    launches["ep"] = moa.LAUNCHES
    want = y_ref.chunk(ep, 1)[m]
    check(torch.allclose(y_ep, want, rtol=2e-4, atol=2e-4),
          f"X2 moe_ffn_ep != dense dispatch: {_x_diff(y_ep, want)}")
    _zero_kernel_counts()
    y_ps, _ = moe.moe_ffn_ep_psum(x, blk, cfg, mesh)
    _sync_if(dev)
    launches["psum"] = moa.LAUNCHES
    check(torch.allclose(y_ps, y_ref, rtol=2e-4, atol=2e-4),
          f"X2 moe_ffn_ep_psum != dense dispatch: "
          f"{_x_diff(y_ps, y_ref)}")
    _check_count(dev, launches == {"ep": 1, "psum": 1},
                 f"X2 moa_reduce launches {launches}, want 1 a call")
    t = x.chunk(ep, 1)[m].numel() // cfg.d_model
    parts = torch.randn((cfg.top_k, t, cfg.d_model), generator=gen,
                        device=dev)
    got = ops.moa_reduce(parts, torch.float32, out_dtype=torch.float32)
    plain = moa.moa_reduce_plain(parts, torch.float32, torch.float32)
    check(torch.equal(got, plain),
          f"X2 moa_reduce != plain at the per-rank combine "
          f"{tuple(parts.shape)}")
    return {"tokens_a_rank": t, "max_abs_err_ep": _x_diff(y_ep, want),
            "max_abs_err_psum": _x_diff(y_ps, y_ref),
            "aux_ep": float(aux_ep), "aux_dense": float(aux_ref),
            "moa_reduce_launches": launches,
            "moa_reduce_checked": list(parts.shape)}


def _x3_oracle(cfg, params, batch, n: int):
    """What a pod-compressed step of ``n`` pods must give, on one rank and
    without a collective: (the pods' mean loss, the norm of the gradient
    it hands AdamW).  Each pod's gradient of its rows (layer by layer, as
    the step takes it), a leaf (a stacked one whole) quantized to int8
    codes at one shared scale (the max |g| over the pods / 127), the codes
    summed and meaned."""
    losses, grads = [], []
    for i in range(n):
        loss, g = value_and_grad(lambda p, b: train_loss(p, b, cfg))(
            split_layers(params), {k: v.chunk(n)[i] for k, v in batch.items()})
        losses.append(float(loss))
        grads.append({**g, "blocks": map_tree(lambda *xs: torch.stack(xs),
                                              *g["blocks"])})
    sq = 0.0
    for parts in zip(*(leaves(g) for g in grads)):
        scale = torch.clamp(max(g.abs().max() for g in parts) / 127.0,
                            min=1e-12)
        total = sum(torch.clamp(torch.round(g / scale), -127, 127)
                    for g in parts)
        sq += float(((total * scale / n) ** 2).sum())
    return sum(losses) / n, math.sqrt(sq)


def x3_pod_compressed(cfg, dev, mesh):
    """X3: one pod-compressed train step of ``cfg`` on the pod ranks, the
    2 x TRAIN_SEQ batch one sequence a pod, against what rank 0 computes
    from both pods' gradients without the mesh (``_x3_oracle``): the loss
    (meaned over pods) within rtol 1e-3 of the single-device loss of the
    same state and batch (the pods' mean), the grad norm within rtol 1e-5;
    flash launched as one remat train step.  The state is the rank's
    blocks under ``train_state_shardings(pod_compressed=True)``: on a pod
    axis alone params, m and v stay whole (replicated over ``pod``) and
    ``err`` is the pod's block of 1."""
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(cfg, gen, pod_compressed=True, mesh=mesh)
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    batch = host_batch(cfg, shape, HostDataConfig(0, 1, 0), 0)
    t0 = time.perf_counter()
    ref = want_norm = None
    if mesh.index("pod") == 0:
        ref, want_norm = _x3_oracle(
            cfg, state["params"],
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
            mesh.shape["pod"])
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    oracle_s = time.perf_counter() - t0
    step = build_train_step(cfg, AdamWConfig(lr=3e-4, grad_clip=1.0),
                            pod_compressed=True, mesh=mesh)
    _zero_kernel_counts()
    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    _sync_if(dev)
    step_s = time.perf_counter() - t0
    counts = _flash_counts()
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if ref is not None:
        check(abs(loss - ref) <= 1e-3 * abs(ref),
              f"X3 pod-compressed loss {loss} vs single-device {ref}")
        check(abs(norm - want_norm) <= 1e-5 * want_norm,
              f"X3 pod-compressed grad norm {norm} vs the oracle's "
              f"{want_norm}")
    _check_count(dev, counts == _expected_counts(cfg, 1),
                 f"X3 flash launches {counts}, want "
                 f"{_expected_counts(cfg, 1)}")
    errs = leaves(state["err"])
    check(all(bool(torch.isfinite(e).all()) for e in errs)
          and any(bool((e != 0).any()) for e in errs),
          "X3 error-feedback residual not finite or all zero")
    return {"params": sum(p.numel() for p in leaves(state["params"])),
            "state_bytes_a_rank": _tree_bytes(state),
            "loss": loss, "single_device_loss": ref, "grad_norm": norm,
            "oracle_grad_norm": want_norm, "oracle_s": oracle_s,
            "step_s": step_s, "flash_launches": counts}


def x4_splitk_decode(cfg, dev, mesh):
    """X4 (GQA) and X4m (MLA's latent cache): one decode step of ``cfg``
    with the cache split over the model ranks along the sequence, against
    the unsharded ``decode_step`` on the whole cache: in fp32 (TF32 off)
    the logits and each rank's cache block within 1e-4; in bf16, as
    served, the split-K logits no farther (relative L2) from the fp32
    unsharded logits than the bf16 unsharded step's are, times 1.5 (the
    two round the same sums differently: one softmax in bf16
    probabilities against fp32 partials)."""
    what = "X4m" if cfg.attn_kind == "mla" else "X4"
    tp, m = mesh.shape["model"], mesh.index("model")
    api = get_api(cfg)
    specs = api.decode_state_specs(cfg, X_DECODE_BATCH, X_CACHE)
    out, logits = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        run = dataclasses.replace(cfg, dtype=dt)
        gen = torch.Generator(device=dev).manual_seed(5)
        # the same bf16-rounded weights and cache in both dtypes
        params = map_tree(lambda t: t.to(dt), init_params(
            api.param_specs(run), gen, dev, torch.bfloat16))
        gen = torch.Generator(device=dev).manual_seed(6)
        state = {k: (0.5 * torch.randn(s.shape, generator=gen, device=dev)
                     ).to(torch.bfloat16).to(dt) for k, s in specs.items()}
        blocks = {k: v.chunk(tp, 2)[m].clone() for k, v in state.items()}
        batch = {"tokens": torch.randint(0, cfg.vocab, (X_DECODE_BATCH, 1),
                                         generator=gen, device=dev),
                 "index": torch.tensor(X_INDEX, device=dev)}
        with torch.no_grad():
            ref, state = api.decode_step(params, state, batch, run)
            _zero_kernel_counts()
            t0 = time.perf_counter()
            got, blocks = api.decode_step(params, blocks, batch, run, mesh)
            _sync_if(dev)
        name = "fp32" if dt == torch.float32 else "bf16"
        out[f"step_s_{name}"] = time.perf_counter() - t0
        out[f"max_abs_err_{name}"] = _x_diff(got, ref)
        logits[name] = (got.float(), ref.float())
        if dt == torch.float32:
            check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4),
                  f"{what} fp32 split-K logits != unsharded: "
                  f"{out['max_abs_err_fp32']}")
            for k, v in blocks.items():
                check(torch.allclose(v, state[k].chunk(tp, 2)[m],
                                     rtol=1e-4, atol=1e-4),
                      f"{what} split-K cache block {k} != unsharded")
        del params, state, blocks
        gc.collect()
    exact = logits["fp32"][1]
    sk, one = (_rel(t, exact) for t in logits["bf16"])
    out.update(bf16_rel_err_splitk=sk, bf16_rel_err_unsharded=one,
               launches=_kernel_counts())
    check(sk <= 1.5 * one,
          f"{what} bf16 split-K rel err {sk} vs unsharded bf16's {one}")
    return out


def x5_head_pad(cfg, dev, mesh):
    """X5: ``cfg`` (fp32) on the model ranks with its q heads padded
    (qwen2.5-14b: 40 -> 48, 16 a rank): logits, loss and every gradient
    match the unsharded forward (1e-4, 1e-5, 5e-4).  Rank 0 computes the
    oracle first, moves it to the host and frees it.  Flash launches as
    one remat train step and a forward, and is held against its plain
    version at the per-rank padded group."""
    tp, rank = mesh.shape["model"], mesh.index("model")
    pad = tp_head_pad(cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = init_params(get_api(cfg).param_specs(cfg), gen, dev)
    toks = torch.randint(0, cfg.vocab, (2, 1, X_PAD_SEQ), generator=gen,
                         device=dev)
    batch = {"tokens": toks[0], "labels": toks[1]}
    ref, t0 = None, time.perf_counter()
    if rank == 0:
        with torch.no_grad():
            logits_ref = forward(params, batch, cfg)[0].cpu()
        loss_ref, grads = value_and_grad(
            lambda p, b: train_loss(p, b, cfg))(params, batch)
        # pinned: the 8.4 GB go to the host and back at copy-engine speed
        ref = (logits_ref, float(loss_ref), map_tree(
            lambda g: torch.empty(g.shape, dtype=g.dtype,
                                  pin_memory=dev.type == "cuda").copy_(g),
            grads))
        del grads
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    t1 = time.perf_counter()
    _zero_kernel_counts()
    with torch.no_grad():
        logits = forward(params, batch, cfg, mesh)[0].cpu()
    loss, grads = value_and_grad(
        lambda p, b: train_loss(p, b, cfg, mesh))(params, batch)
    _sync_if(dev)
    counts = _flash_counts()
    out = {"pad": pad, "heads_a_rank": (cfg.n_heads + pad) // tp,
           "flash_launches": counts, "oracle_s": t1 - t0,
           "sharded_s": time.perf_counter() - t1}
    if rank == 0:
        logits_ref, loss_ref, grads_ref = ref
        check(torch.allclose(logits, logits_ref, rtol=1e-4, atol=1e-4),
              f"X5 logits != unsharded: {_x_diff(logits, logits_ref)}")
        check(abs(float(loss) - loss_ref) <= 1e-5 * abs(loss_ref),
              f"X5 loss {float(loss)} vs unsharded {loss_ref}")
        worst = 0.0
        for g, want in zip(leaves(grads), leaves(grads_ref)):
            want = want.to(dev)
            check(torch.allclose(g, want, rtol=5e-4, atol=5e-4),
                  f"X5 gradient != unsharded: {_x_diff(g, want)}")
            worst = max(worst, _x_diff(g, want))
        out.update(max_abs_err_logits=_x_diff(logits, logits_ref),
                   loss=float(loss), loss_ref=loss_ref,
                   max_abs_err_grads=worst)
    # one remat train step's launches and the no-grad forward's
    want = _expected_counts(cfg, 1)
    want["fwd"] += cfg.n_layers
    _check_count(dev, pad == 8 and counts == want,
                 f"X5 pad {pad}, flash launches {counts}, want {want}")
    # flash at the per-rank padded group, against its plain version
    if dev.type == "cuda":
        shape = (1, X_PAD_SEQ, (cfg.n_heads + pad) // tp, cfg.hd)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, True)
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, True)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                 True)
        po, _ = fa.flash_attention_plain(q, k, v, True)
        pdq, pdk, pdv = fa.flash_attention_plain_bwd(q, k, v, o, lse, do,
                                                     True)
        check(torch.allclose(o, po, rtol=2e-5, atol=2e-5),
              f"X5 flash forward != plain at {shape}")
        for a, b, what in ((dq, pdq, "dq"), (dk, pdk, "dk"), (dv, pdv, "dv")):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                  f"X5 flash {what} != plain at {shape}")
        out["flash_checked"] = list(shape)
    return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _dry_check(what: str, cfg, shape: ShapeConfig, mesh, *counted: dict
               ) -> tuple:
    """The dry run of ``shape`` on this mesh's shape (``run_cell``: the
    first rank's step traced on meta tensors, every rank's the same)
    against the bytes by op this rank's Transport counted in each step of
    ``counted``: equal to the byte.  Returns the dry run's bytes by kind
    and its resident bytes a device."""
    rec = run_cell(cfg.arch_id, shape, mesh=dict(mesh.shape), cfg=cfg,
                   verbose=False)
    dry = {k: v["bytes"] for k, v in rec["collectives"].items()}
    for i, step in enumerate(counted):
        got = {KINDS[op]: n for op, n in step.items()}
        check(got == dry, f"{what} (step {i + 1}): the Transport counted "
              f"{got} B, the dry run {dry}")
    return dry, rec["resident_bytes_per_device"]


def x6_sharded_state(cfg, dev, mesh):
    """X6: the sharded train state on (data 2, model 1).  Each rank draws
    its blocks of the seeded state (a leaf whole at a time) and holds
    exactly the dry run's per-device resident bytes for the mesh; two
    steps of the 2 x TRAIN_SEQ batch, one row a rank, each gathering a
    layer's params at a time (twice under remat) and reduce-scattering
    the gradients: the bytes handed to all_gather and reduce_scatter equal
    the shapes' reckoning; flash launched as one remat train step a step.
    After each step a mesh checkpoint into the spawn's directory, each
    rank writing its rows (step 1's while step 2 runs);
    ``x6_restore_one_device`` reads them back."""
    shardings = train_state_shardings(cfg, mesh)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             mesh=mesh)
    nbytes = _tree_bytes(state)
    whole = 4 * sum(math.prod(sp.shape)
                    for sp in leaves(train_state_specs(cfg)["params"]))
    reckon = {"all_gather": _tree_bytes(state["params"])
              + _tree_bytes(state["params"]["blocks"]),
              "reduce_scatter": whole}
    step = build_train_step(cfg, AdamWConfig(lr=3e-4, grad_clip=1.0),
                            mesh=mesh)
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    ckpt_dir = os.path.join(X_DIR, "x6_ckpt")
    steps, save = [], None
    for i in range(2):
        batch = host_batch(cfg, shape, HostDataConfig(0, 1, 0), i)
        mesh.transport.reset()
        _zero_kernel_counts()
        dist.barrier()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        _sync_if(dev)
        dt = time.perf_counter() - t0
        counts = _flash_counts()
        got = dict(mesh.transport.bytes)
        steps.append({"step_s": dt, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "bytes_by_op": got,
                      "calls_by_op": dict(mesh.transport.calls),
                      "flash_launches": counts})
        for op, want in reckon.items():
            check(got.get(op) == want, f"X6 step {i + 1}: {got.get(op)} B "
                  f"handed to {op}, the shapes give {want}")
        _check_count(dev, counts == _expected_counts(cfg, 1),
                     f"X6 flash launches {counts}, want "
                     f"{_expected_counts(cfg, 1)}")
        if i == 0:
            free = shutil.disk_usage(X_DIR).free
            check(free > 1.05 * 2 * (3 * whole + 4), f"X6: {free / 1e9:.1f} "
                  f"GB free under {X_DIR}, less than two checkpoints of "
                  f"{3 * whole / 1e9:.2f} GB")
            saver = ckpt.AsyncCheckpointer(ckpt_dir, keep=2, mesh=mesh,
                                           shardings=shardings)
            save = {"free_gb": free / 1e9}
        else:
            # step 1's files were written while step 2 ran, as a
            # TrainLoop's; what is left of them, then step 2's buffer is
            # step 1's
            t0 = time.perf_counter()
            saver.wait()
            save["wait_after_step_2_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        saver.save(i + 1, state)
        save[f"save_blocks_s_{i + 1}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    saver.close()                  # every rank's rows written, committed
    save.update(close_s=time.perf_counter() - t0, saves=saver.timings)
    dry_coll, dry = _dry_check("X6", cfg, shape, mesh,
                               *(row["bytes_by_op"] for row in steps))
    check(nbytes == dry, f"X6 state {nbytes} B a rank, the dry run's "
          f"per-device figure {dry}")
    return {"params": whole // 4, "state_bytes_a_rank": nbytes,
            "dryrun_bytes_a_device": dry, "reckoned_bytes": reckon,
            "dryrun_collective_bytes": dry_coll,
            "steps": steps, "save": save, "ckpt_dir": ckpt_dir}


def _x6_gap(got, want, base=None):
    """``(largest relative L2 error of a leaf of got against want, its
    path)``; with ``base`` (a tree like them) the errors are relative to
    the leaves' differences from it, ``|got - want| / |want - base|``."""
    flat = lambda t: ckpt.flatten_with_paths(t)
    bases = ([b for _, b in flat(base)] if base is not None
             else [None] * len(flat(got)))
    worst = (0.0, "")
    for (path, a), (_, b), c in zip(flat(got), flat(want), bases):
        ref = b if c is None else b - c
        err = float((a - b).float().norm()
                    / ref.float().norm().clamp_min(1e-30))
        worst = max(worst, (err, path))
    return worst


def x6_restore_one_device(cfg, row, device):
    """X6's second half, in the smoke's own process once the ranks are
    gone: their step-1 checkpoint restored onto the one device (a new tree
    from the manifest's whole leaves), step 2 taken there; its loss within
    rtol 1e-3 of the 2-rank step 2's (bf16 compute, the gradients summed
    in another order), its grad norm within rtol 1e-4, and its m, v and
    param update within ``X6_STATE_RTOL`` of the mesh's step 2 (the
    step-2 checkpoint, restored onto the device)."""
    dev = torch.device(device)
    target = shape_structs(train_state_specs(cfg))
    t0 = time.perf_counter()
    state = ckpt.restore_checkpoint(row["ckpt_dir"], 1, target, device=dev)
    _sync_if(dev)
    restore_s = time.perf_counter() - t0
    check(int(state["step"]) == 1, "X6: the restored step is not 1")
    before = map_tree(torch.clone, state["params"])
    step = build_train_step(cfg, AdamWConfig(lr=3e-4, grad_clip=1.0))
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    batch = host_batch(cfg, shape, HostDataConfig(0, 1, 0), 1)
    _zero_kernel_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    _sync_if(dev)
    step_s = time.perf_counter() - t0
    counts = _flash_counts()
    mesh_step = row["steps"][1]
    loss, want = float(metrics["loss"]), mesh_step["loss"]
    check(abs(loss - want) <= 1e-3 * abs(want),
          f"X6 one-device step 2 loss {loss} vs the 2-rank step 2's {want}")
    norm, want_norm = float(metrics["grad_norm"]), mesh_step["grad_norm"]
    check(abs(norm - want_norm) <= 1e-4 * abs(want_norm),
          f"X6 one-device step 2 grad norm {norm} vs the 2-rank step 2's "
          f"{want_norm}")
    _check_count(dev, counts == _expected_counts(cfg, 1),
                 f"X6 one-device flash launches {counts}")
    t0 = time.perf_counter()
    mesh2 = ckpt.restore_checkpoint(row["ckpt_dir"], 2, target, device=dev)
    _sync_if(dev)
    restore2_s = time.perf_counter() - t0
    check(int(mesh2["step"]) == 2 and int(state["step"]) == 2,
          f"X6: steps {int(mesh2['step'])} (mesh) and {int(state['step'])}"
          " after step 2")
    gaps = {"m": _x6_gap(state["m"], mesh2["m"]),
            "v": _x6_gap(state["v"], mesh2["v"]),
            "update": _x6_gap(state["params"], mesh2["params"], before)}
    for k, (err, path) in gaps.items():
        check(err <= X6_STATE_RTOL, f"X6 one-device step 2's {k} {path} "
              f"{err:.3e} from the 2-rank step 2's (relative L2), over "
              f"{X6_STATE_RTOL}")
    del state, mesh2, before
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"restore_s": restore_s, "one_device_step_s": step_s,
            "one_device_loss": loss, "loss_gap": loss - want,
            "one_device_grad_norm": norm, "grad_norm_gap": norm - want_norm,
            "restore_step_2_s": restore2_s,
            "state_gap_rel_l2": {k: {"max": e, "leaf": p}
                                 for k, (e, p) in gaps.items()},
            "one_device_flash_launches": counts}


def _x7_split_bytes(params, pspecs, mesh) -> int:
    """fp32 bytes of this rank's blocks of the leaves split over
    ``model``."""
    return sum(leaves(map_tree(
        lambda t, ps: t.numel() * 4 if "model" in split_axes(ps, mesh)
        else 0, params, pspecs)))


def _x7_reckon(cfg, params, pspecs, mesh, b, s) -> dict:
    """The bytes one sequence-parallel remat step on (model tp, data 1)
    hands all_gather and reduce_scatter, from the shapes.  A layer's
    leaves split over ``model`` are all-gathered (their fp32 blocks) in the
    forward and again in the recompute, and their whole gradients are
    reduce-scattered once; ``lm_head``'s block is gathered once for the
    loss.  A layer all-gathers the normed stretch (B, S / tp, D) into the
    attention and reduce-scatters its heads' partial outputs (B, S, D),
    in the forward and the recompute, and the backward reverses each
    once.  The embedding reduce-scatters its fp32 (B, S, D) partial rows
    and all-gathers their stretch's cotangent, once each."""
    tp, d = mesh.shape["model"], cfg.d_model
    act = torch.empty((), dtype=cfg.dtype).element_size()
    layers = _x7_split_bytes(params["blocks"], pspecs["blocks"], mesh)
    stretch, whole = b * (s // tp) * d, b * s * d
    return {"all_gather": 2 * layers + params["lm_head"].numel() * 4
            + cfg.n_layers * 3 * stretch * act + stretch * 4,
            "reduce_scatter": tp * layers + cfg.n_layers * 3 * whole * act
            + whole * 4}


def _x7_one_device(cfg, dev, mesh, shardings, batches, got) -> dict:
    """The one-device steps of ``batches`` from the seeded whole state,
    taken on one rank at a time (the whole state and its gradients on the
    card): each step's (loss, grad norm), and the largest relative L2
    error of a leaf of ``got`` (this rank's blocks of the mesh's ``m``,
    ``v`` and last ``update``) from the one-device step's; a leaf whole on
    every rank counts once."""
    index, sums, ref = [], None, []
    for r in range(mesh.shape["model"]):
        if mesh.index("model") == r:
            state = init_train_state(
                cfg, torch.Generator(device=dev).manual_seed(0))
            step = build_train_step(cfg, AdamWConfig(lr=3e-4, grad_clip=1.0))
            mine = lambda tree: map_tree(
                lambda t, ps: shard_block(t, ps, mesh).clone(), tree,
                shardings["params"])
            for batch in batches:
                before = mine(state["params"])
                state, metrics = step(state, batch)
                ref.append((float(metrics["loss"]),
                            float(metrics["grad_norm"])))
            want = {"m": mine(state["m"]), "v": mine(state["v"]),
                    "update": map_tree(torch.sub, mine(state["params"]),
                                       before)}
            del state, before
            parts = []
            for k in ("m", "v", "update"):
                def sq(a, w, ps):
                    return float(block_owner(ps, mesh)) * torch.stack(
                        [(a - w).float().pow(2).sum(), w.float().pow(2).sum()])
                for path, t in ckpt.flatten_with_paths(
                        map_tree(sq, got[k], want[k], shardings["params"])):
                    index.append((k, path))
                    parts.append(t)
            sums = torch.stack(parts)
            del want, parts
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    dist.all_reduce(sums)
    errs = {}
    for (name, path), (num, den) in zip(index, sums.tolist()):
        errs.setdefault(name, []).append(
            (math.sqrt(num) / max(math.sqrt(den), 1e-30), path))
    return {"steps": ref, "gaps": {k: sorted(v, reverse=True)[:3]
                                   for k, v in errs.items()}}


def _x7_train(cfg, dev, mesh, batches, reckon_fn) -> dict:
    """The mesh's steps of ``batches`` from the seeded state's blocks:
    each timed, its all_gather and reduce_scatter bytes held against
    ``reckon_fn(state)``, its flash launches against one remat step's, the
    logits a rank held against half the whole logits; then X6's checks
    against the same steps on one device (:func:`_x7_one_device`): loss
    within rtol 1e-3, grad norm within rtol 1e-4, m, v and the last
    update within ``X6_STATE_RTOL`` (relative L2, every leaf)."""
    shardings = train_state_shardings(cfg, mesh)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             mesh=mesh)
    reckon, nbytes = reckon_fn(state, shardings), _tree_bytes(state)
    step = build_train_step(cfg, AdamWConfig(lr=3e-4, grad_clip=1.0),
                            mesh=mesh)
    seq = batches[0]["tokens"].shape[1]
    logits_bytes, real_head = set(), lm_mod.head_logits

    def head_spy(*a):
        out = real_head(*a)
        logits_bytes.add(out.numel() * out.element_size())
        return out
    rows = []
    for i, batch in enumerate(batches):
        before = map_tree(torch.clone, state["params"])
        mesh.transport.reset()
        _zero_kernel_counts()
        dist.barrier()
        lm_mod.head_logits = head_spy
        t0 = time.perf_counter()
        try:
            state, metrics = step(state, batch)
            _sync_if(dev)
        finally:
            lm_mod.head_logits = real_head
        dt = time.perf_counter() - t0
        counts = _flash_counts()
        got = dict(mesh.transport.bytes)
        rows.append({"step_s": dt, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "bytes_by_op": got,
                     "calls_by_op": dict(mesh.transport.calls),
                     "flash_launches": counts})
        for op in ("all_gather", "reduce_scatter"):
            check(got.get(op, 0) == reckon.get(op, 0),
                  f"X7 S={seq} step {i + 1}: {got.get(op, 0)} B handed to "
                  f"{op}, the shapes give {reckon.get(op, 0)}")
        _check_count(dev, counts == _expected_counts(cfg, 1),
                     f"X7 flash launches {counts}, want "
                     f"{_expected_counts(cfg, 1)}")
    dry_coll, _ = _dry_check(
        f"X7 S={seq}", cfg, ShapeConfig("train", seq_len=seq, global_batch=
                                        batches[0]["tokens"].shape[0],
                                        kind="train"), mesh,
        *(row["bytes_by_op"] for row in rows))
    whole_logits = (batches[0]["tokens"].shape[0] * seq * cfg.vocab
                    * torch.empty((), dtype=cfg.dtype).element_size())
    check(logits_bytes == {whole_logits // mesh.shape["model"]},
          f"X7 S={seq}: logits of {logits_bytes} B a rank, the whole "
          f"{whole_logits} B")
    got = {"m": state["m"], "v": state["v"],
           "update": map_tree(torch.sub, state["params"], before)}
    del state, before
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    one = _x7_one_device(cfg, dev, mesh, shardings, batches, got)
    for i, (row, (loss, norm)) in enumerate(zip(rows, one["steps"])):
        check(abs(row["loss"] - loss) <= 1e-3 * abs(loss),
              f"X7 S={seq} step {i + 1} loss {row['loss']} vs the one "
              f"device's {loss}")
        check(abs(row["grad_norm"] - norm) <= 1e-4 * abs(norm),
              f"X7 S={seq} step {i + 1} grad norm {row['grad_norm']} vs "
              f"the one device's {norm}")
    gaps = {k: [{"rel_l2": e, "leaf": p} for e, p in v]
            for k, v in one["gaps"].items()}
    for k, ((err, path), *_) in one["gaps"].items():
        check(err <= X6_STATE_RTOL, f"X7 S={seq}: {k} {path} {err:.3e} from "
              f"the one-device step's (relative L2), over {X6_STATE_RTOL}; "
              f"the worst leaves {gaps}")
    return {"state_bytes_a_rank": nbytes, "steps": rows,
            "reckoned_bytes": reckon, "dryrun_collective_bytes": dry_coll,
            "logits_bytes_a_rank": min(logits_bytes),
            "logits_bytes_whole": whole_logits,
            "one_device_steps": one["steps"], "state_gap_rel_l2": gaps}


def _x7_decode(cfg, dev, mesh) -> dict:
    """fp32 (TF32 off): the seeded params as the rank's blocks
    (``mesh_params``) and a split-K dense cache of X7_CACHE positions (the
    rank's stretch), an X7_PROMPT-token prompt through ``prefill_chunk``
    and X7_DECODE greedy ``decode_step`` s; rank 0 repeats them on one
    device with the whole params and cache: the tokens equal, the logits
    within 1e-4."""
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    api, tp = get_api(cfg), mesh.shape["model"]
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (X_DECODE_BATCH, X7_PROMPT),
                           generator=gen, device=dev)

    step_bytes = {}

    def run(params, state, mesh=None):
        out, t0 = [], time.perf_counter()
        with torch.no_grad():
            logits, state = api.prefill_chunk(
                params, state, {"tokens": prompt,
                                "index": torch.tensor(0, device=dev),
                                "nvalid": X7_PROMPT}, cfg, mesh)
            out.append(logits)
            _sync_if(dev)
            t1 = time.perf_counter()
            for i in range(X7_DECODE):
                # the first step's bytes alone, for the dry run's
                first = mesh is not None and i == 0
                before = dict(mesh.transport.bytes) if first else {}
                logits, state = api.decode_step(
                    params, state,
                    {"tokens": out[-1].argmax(-1)[:, None],
                     "index": torch.tensor(X7_PROMPT + i, device=dev)},
                    cfg, mesh)
                out.append(logits)
                if first:
                    step_bytes.update(
                        (op, n - before.get(op, 0))
                        for op, n in mesh.transport.bytes.items()
                        if n != before.get(op, 0))
            _sync_if(dev)
        return (torch.stack(out), {"prefill_s": t1 - t0,
                                   "decode_s": time.perf_counter() - t1})

    def cache(split):
        return {k: torch.zeros(sp.shape[:2] + (sp.shape[2] // split,)
                               + sp.shape[3:], dtype=sp.dtype, device=dev)
                for k, sp in api.decode_state_specs(
                    cfg, X_DECODE_BATCH, X7_CACHE).items()}
    blocks = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                              mesh=mesh)["params"]
    mesh.transport.reset()
    params, state = mesh_params(blocks, cfg, mesh), cache(tp)
    held = held_bytes((params, state))
    got, times = run(params, state, mesh)
    dry, dry_held = _dry_check(
        "X7 decode step", cfg, ShapeConfig(
            "decode", seq_len=X7_CACHE, global_batch=X_DECODE_BATCH,
            kind="decode"), mesh, step_bytes)
    check(held == dry_held, f"X7 decode: the rank holds {held} B of params "
          f"and cache, the dry run's per-device figure {dry_held}")
    out = {**times, "bytes_by_op": dict(mesh.transport.bytes),
           "step_bytes_by_op": step_bytes, "dryrun_step_bytes": dry,
           "held_bytes_a_rank": held}
    del blocks, params, state
    gc.collect()
    if mesh.index("model") == 0:
        whole = init_train_state(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))["params"]
        want, _ = run(whole, cache(1))
        del whole
        err = _x_diff(got, want)
        check(torch.equal(got.argmax(-1), want.argmax(-1)),
              "X7 mesh decode tokens != the one-device port's")
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"X7 mesh decode logits {err} from the one-device port's")
        out.update(max_abs_err_logits=err,
                   tokens=got.argmax(-1).t().tolist())
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def x7_seq_parallel(cfg, dev, mesh):
    """X7: the sequence-parallel layout on (model 2, data 1).  Two train
    steps of X6's 2 x TRAIN_SEQ batch, each rank its stretch of the
    stream, the logits and the loss (``_x7_train``: bytes against
    ``_x7_reckon``, logits a rank half the whole, X6's checks against the
    one-device steps); one step at X7_RAGGED_SEQ, where the stream stays
    whole and the logits split over the vocab (the vocab-parallel loss;
    all_gather the layers' blocks, twice, and no reduce_scatter); then
    fp32 prefill and greedy decode of the rank's sharded params
    (``_x7_decode``)."""
    out = {}
    for name, seq, n, reckon in (
            ("sp", TRAIN_SEQ, 2, lambda st, sh: _x7_reckon(
                cfg, st["params"], sh["params"], mesh, TRAIN_BATCH,
                TRAIN_SEQ)),
            ("ragged", X7_RAGGED_SEQ, 1, lambda st, sh: {
                "all_gather": 2 * _x7_split_bytes(
                    st["params"]["blocks"], sh["params"]["blocks"],
                    mesh)})):
        shape = ShapeConfig("train", seq_len=seq, global_batch=TRAIN_BATCH,
                            kind="train")
        batches = [host_batch(cfg, shape, HostDataConfig(0, 1, 0), i)
                   for i in range(n)]
        out[name] = _x7_train(cfg, dev, mesh, batches, reckon)
    out["decode"] = _x7_decode(cfg, dev, mesh)
    out["params"] = sum(math.prod(sp.shape) for sp in
                        leaves(train_state_specs(cfg)["params"]))
    return out


X_CHECKS = {"X1": (x1_tree_collectives, ("data",)),
            "X2": (x2_moe_ep, ("model",)),
            "X3": (x3_pod_compressed, ("pod",)),
            "X4": (x4_splitk_decode, ("model",)),
            "X4m": (x4_splitk_decode, ("model",)),
            "X5": (x5_head_pad, ("model",)),
            "X6": (x6_sharded_state, ("data", "model")),
            "X7": (x7_seq_parallel, ("model", "data"))}


def _sync_if(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _x_rank(rank, world, store, out, names, device, reduced):
    """One rank of phase X: runs ``names`` in order, each on a mesh of its
    own axes over the ``world`` ranks (the first of them all the ranks,
    the others of one), and writes its figures."""
    global X_DIR
    X_DIR = os.path.dirname(out)
    dev = torch.device(device)
    if dev.type == "cuda":
        # the ranks share the card: free blocks go back to it whole
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=X_COLLECTIVE_TIMEOUT))
    cfgs = x_configs(reduced)
    results = {}
    for name in names:
        fn, axes = X_CHECKS[name]
        mesh = device_mesh((world,) + (1,) * (len(axes) - 1), axes, dev)
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        row = fn(cfgs[name], dev, mesh)
        _sync_if(dev)
        row["wall_s"] = time.perf_counter() - t0
        peak = torch.tensor(torch.cuda.max_memory_allocated() / 1e9
                            if dev.type == "cuda" else 0.0)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        row["peak_gb_a_rank"] = float(peak)
        sent = torch.tensor(float(sum(mesh.transport.bytes.values())))
        dist.all_reduce(sent)
        row["collective_bytes_a_rank"] = dict(mesh.transport.bytes)
        row["collective_bytes_all_ranks"] = int(sent)
        row["collective_calls_a_rank"] = dict(mesh.transport.calls)
        results[name] = row
        if rank == 0:
            _x_print(name, row)
        del mesh
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


def phase_mesh_collectives(device: str = "cuda", reduced: bool = False
                           ) -> dict:
    """Phase X: X1-X7 (``X_CHECKS``) on ranks spawned as processes on the
    one card (``X_WORLDS``), joined by gloo; prints each check's wall
    seconds, peak GB a rank, transport, collective bytes and kernel
    launches.  The collective times here are gloo's through the one card
    and host memory: they say nothing of NVLink."""
    results = {}
    for world, names in X_WORLDS:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_x_")
        try:
            out = os.path.join(tmp, "results.json")
            t0 = time.perf_counter()
            ctx = torch_mp.start_processes(
                _x_rank, args=(world, os.path.join(tmp, "store"), out, names,
                               device, reduced),
                nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + X_SPAWN_TIMEOUT
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise RuntimeError(f"phase X: {names} on {world} ranks "
                                       f"ran past {X_SPAWN_TIMEOUT} s")
            with open(out) as f:
                got = json.load(f)
            if "X6" in got:
                one = x6_restore_one_device(x_configs(reduced)["X6"],
                                            got["X6"], device)
                got["X6"].update(one)
                print(f"[mesh] X6 restored onto the one device: "
                      + json.dumps(one), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"[mesh] {world} ranks on {device} ({X_TRANSPORT}): spawn "
              f"and checks {time.perf_counter() - t0:.1f} s")
        results.update(got)
    return results


def _x_print(name: str, row: dict) -> None:
    print(f"[mesh] {name}: {row['wall_s']:.2f} s, peak "
          f"{row['peak_gb_a_rank']:.2f} GB a rank, "
          f"{row['collective_bytes_all_ranks'] / 1e9:.3f} GB through the "
          f"collectives (all ranks; a rank: {row['collective_bytes_a_rank']}"
          f"); " + json.dumps({k: v for k, v in row.items() if k not in (
              "wall_s", "peak_gb_a_rank", "collective_bytes_a_rank",
              "collective_bytes_all_ranks")}), flush=True)



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[wall] {label}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("2 build", phase_build)
    full_cfg = get_config("llama3.2-3b")
    full_ecfg = EngineConfig(max_slots=4, max_seq=2048, prefill_chunk=256,
                             spec_k=4).resolve(full_cfg)
    shapes = path_shapes(full_cfg, full_ecfg) + generate_shapes(full_cfg)
    moe_path = moe_shapes(full_ecfg)
    qkv_cfg = get_config(QKV_ARCH)
    qkv_shapes = [(f"glm4_{label}", n, m) for label, n, m in path_shapes(
        qkv_cfg, EngineConfig(max_slots=4, max_seq=2048, prefill_chunk=256,
                              spec_k=4).resolve(qkv_cfg))]
    err = timed("3 moa_reduce check", phase_kernel_check,
                shapes + qkv_shapes, moe_path)
    flash_err = timed("4 flash check", phase_flash_check)
    timed("5 reduced serve parity", phase_reduced_parity)
    launches, serve_params, chunk_s, step_s, paged_tokens = timed(
        "6 full width", phase_full_width)
    mesh_rows, mesh_launches = timed(
        "K mesh-sharded serve", phase_mesh_serve, full_cfg, serve_params,
        paged_tokens, step_s)
    contig_rows, contig_launches = timed(
        "G contiguous slots", phase_contiguous, full_cfg, serve_params,
        paged_tokens)
    serve_launches = {
        "K": mesh_launches,
        "G": contig_launches,
        "A": timed("A shared prefix", phase_shared_prefix, full_cfg,
                   serve_params),
        "B": timed("B sessions", phase_sessions, full_cfg, serve_params),
        "C": timed("C overload", phase_overload, full_cfg, serve_params,
                   chunk_s, step_s)}
    spec_rows, serve_launches["D"], chain_step_s = timed(
        "D speculative serve", phase_spec_serve, full_cfg, serve_params)
    serve_launches["C spec"], _ = timed(
        "C overload, spec_k=4", phase_overload_spec, full_cfg,
        serve_params, chunk_s, step_s, chain_step_s)
    quant_rows, serve_launches["E"] = timed(
        "E quantized KV and sampling", phase_quant_serve, full_cfg,
        serve_params)
    tune_rows, serve_launches["T"] = timed(
        "T autotune tier", phase_tune, full_cfg, serve_params, chunk_s,
        step_s, chain_step_s)
    del serve_params
    gc.collect()
    torch.cuda.empty_cache()       # the llama serve weights go
    mla_cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    mla_weights = mla_params(mla_cfg)
    mla_rows, serve_launches["F"] = timed("F minicpm3-4b serve",
                                          phase_mla_serve, mla_cfg,
                                          mla_weights)
    del mla_weights
    gc.collect()
    torch.cuda.empty_cache()       # the MLA weights go
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    moe_weights = moe_params(moe_cfg)
    moe_rows, moe_launches = timed("M phi3.5-moe serve", phase_moe_serve,
                                   moe_cfg, moe_weights)
    serve_launches["M"] = moe_launches
    del moe_weights
    gc.collect()
    torch.cuda.empty_cache()       # the MoE weights go
    ssm_rows = {}
    for label, arch in (("S", SSM_ARCH), ("Z", HYBRID_ARCH)):
        torch.cuda.reset_peak_memory_stats()
        ssm_cfg = get_config(arch)
        weights, n_params = ssm_params(ssm_cfg)
        ssm_rows[label] = timed(f"{label} {arch} serve", phase_ssm_serve,
                                ssm_cfg, weights, n_params, label)
        del weights
        gc.collect()
        torch.cuda.empty_cache()   # its weights go
    qkv_weights, qkv_n = qkv_params(qkv_cfg)
    qkv_rows, serve_launches["Q"] = timed(f"Q {QKV_ARCH} serve",
                                          phase_qkv_serve, qkv_cfg,
                                          qkv_weights)
    qkv_rows["params"] = qkv_n
    del qkv_weights
    gc.collect()
    torch.cuda.empty_cache()       # the glm4 weights go
    rows = timed("7 moa_reduce timing", phase_timing, shapes) + \
        phase_timing(moe_path, torch.bfloat16) + \
        phase_timing([r for r in qkv_shapes
                      if r[0] in ("glm4_prefill_o", "glm4_decode_o")])
    qkv_train_counts = timed("8 train parity", phase_train_parity)
    flash_launches, train_summary = timed(
        "9 train full width", train_full_width, full_cfg, TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()       # the train state goes
    frontend = {"hubert": timed(f"H {AUDIO_ARCH} train and resume",
                                phase_train_audio),
                "internvl2": timed(f"V {VLM_ARCH} train ({VLM_LAYERS} "
                                   f"layers)", phase_train_vlm)}
    flash_rows = timed("10 flash timing", phase_flash_timing)
    zamba_flash_rows = timed("10 flash timing, zamba2 shape",
                             phase_flash_timing, ZAMBA_FLASH_SHAPE)
    frontend_flash_rows = {
        name: timed(f"10 flash timing, {name} shape", phase_flash_timing,
                    *FLASH_NAMED[name]) for name in frontend}
    glm4_flash_rows = timed("10 flash timing, glm4 shape",
                            phase_flash_timing, *FLASH_NAMED["glm4"])
    bitplane, matmul = adder_shapes(full_cfg)
    adder_err = timed("11 adder check", phase_adder_check, bitplane, matmul)
    adder_launches = timed("12 adder path", phase_adder_path, full_cfg,
                           bitplane, matmul)
    adder_rows = timed("13 adder timing", phase_adder_timing, bitplane,
                       matmul)
    gc.collect()
    torch.cuda.empty_cache()       # the ranks of phase X share the card
    print(f"[mesh] this process holds {torch.cuda.memory_reserved() / 1e9:.3f}"
          f" GB of the card ({torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated) as phase X starts")
    x_rows = timed("X mesh collectives", phase_mesh_collectives)

    def median_ms(summary):
        return float(np.median(summary["ms"]))

    timed("R roofline", phase_roofline, {
        "6 decode step (mean)": 1e3 * step_s,
        "6 prefill chunk (mean)": 1e3 * chunk_s,
        "Q bf16 decode step (p50)": qkv_rows["bf16"]["step_p50_ms"],
        "M1 decode step (p50)": moe_rows["M1"]["step_p50_ms"],
        "S decode step (p50)": ssm_rows["S"]["step_p50_ms"],
        "Z decode step (p50)": ssm_rows["Z"]["step_p50_ms"],
        "9 train step (median)": median_ms(train_summary),
        "H1 train step (median)": median_ms(frontend["hubert"][1]),
        "V train step (median)": median_ms(frontend["internvl2"][1])})
    print(f"[wall] phases 2-13 and R: {time.perf_counter() - t_start:.1f} s")

    main_row = next(r for r in rows if r["label"] == "prefill_o")
    source, replaces = KERNELS["moa_reduce"]
    kernels = [{
        "name": "moa_reduce", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"], "shape": main_row["shape"],
        "checked": "torch.equal vs moa_reduce_plain", "shapes": rows,
        "spec_serve": spec_rows, "quant_serve": quant_rows,
        "mla_serve": mla_rows, "moe_serve": moe_rows,
        "ssm_serve": ssm_rows, "qkv_serve": qkv_rows, "tune": tune_rows,
        "contiguous_serve": contig_rows, "mesh_serve": mesh_rows,
        "mesh_collectives": x_rows,
        "launches_by_serve_phase": {
            f"{ph} {run}": n for ph, d in serve_launches.items()
            for run, n in d.items()}}]
    source, replaces = KERNELS["flash_attention"]
    plain = {"fwd": "flash_attention_plain",
             "bwd_dq": "flash_attention_plain_bwd (dq, dk, dv together)",
             "bwd_dkv": "flash_attention_plain_bwd (dq, dk, dv together)"}
    library = {"fwd": "scaled_dot_product_attention forward",
               "bwd_dq": "scaled_dot_product_attention backward (dq, dk, "
                         "dv together)",
               "bwd_dkv": "scaled_dot_product_attention backward (dq, dk, "
                          "dv together)"}
    bound = {"fwd": "QK^T, PV",
             "bwd_dq": "dO V^T, dS K: 2 of the backward's 5 matmuls",
             "bwd_dkv": "QK^T, P^T dO, dS^T Q: 3 of the backward's 5 "
                        "matmuls"}
    for part in ("fwd", "bwd_dq", "bwd_dkv"):
        r = flash_rows[part]
        kernels.append({
            "name": f"flash_attention_{part}", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": flash_launches[part],
            "max_abs_err": flash_err[part]["path"],
            "max_abs_err_fp32": flash_err[part]["fp32"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": [TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128], "dtype": "bf16",
            "plain": plain[part], "library": library[part],
            "bound": bound[part],
            "zamba2_shape": dict(
                {k: zamba_flash_rows[part][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                shape=list(ZAMBA_FLASH_SHAPE), dtype="bf16",
                max_abs_err=flash_err[part]["zamba2"]),
            **{f"{name}_shape": dict(
                {k: frontend_flash_rows[name][part][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                shape=list(FLASH_NAMED[name][0]), dtype="bf16",
                causal=FLASH_NAMED[name][1],
                max_abs_err=flash_err[part][name],
                launches=frontend[name][0][part]) for name in frontend},
            "glm4_shape": dict(
                {k: glm4_flash_rows[part][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                shape=list(GLM4_FLASH_SHAPE), dtype="bf16", causal=True,
                max_abs_err=flash_err[part]["glm4"],
                launches_reduced_train=qkv_train_counts[part],
                launches_phase_q=(qkv_rows["bias_check"]["flash_launches"]
                                  [part]))})
    kernels[-3]["frontend_train"] = {name: summary for name, (_, summary)
                                     in frontend.items()}
    checked = {"bitplane_add": "torch.equal vs bitplane_add_plain",
               "quant_matmul": "torch.equal vs quant_matmul_plain"}
    for name in ("bitplane_add", "quant_matmul"):
        source, replaces = KERNELS[name]
        r = adder_rows[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": adder_launches[name],
            "max_abs_err": adder_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "checked": checked[name],
            "shapes": adder_rows[name]})
    kernels[-1]["launches_by_kernel"] = {
        k: v for k, v in adder_launches.items()
        if k.startswith("quant_matmul_")}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
