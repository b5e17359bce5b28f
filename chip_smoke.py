#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  — requires ``torch.cuda.is_available()`` (otherwise exits
   non-zero before printing any result) and prints the card's name and
   power limit as ``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader`` gives them;
2. build   — compiles every CUDA source under ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together);
   analysis — (after the serve model's init) the static contract
   checkers on the card: every registered launch layout of K1-K8
   (``analysis/launch_check.py``) held against its source's C geometry
   entry (grid, threads, dynamic and static shared memory), each
   kernel's registers, blocks an SM and spills, the sm_90 constants
   against the device's limits; the collective inventory of one MoE
   forward at the full-width train_2x2 plan (a2a, a2a_pipelined over the
   int8 wire, gather) recorded on a real 2x2 gloo world with the kernels
   on (K1, K2, K3, K7, K4 launched) and in one process, both equal to
   ``expected_inventory``, and the one-rank fused path's (none);
   ``python -m repro_torch.analysis`` on the tree (exit 0); the meta
   dry-run of gpt3_medium_moe x train_4k x pod1 and at train_1rank's
   shapes (its parameter, gradient and AdamW bytes held against the
   train_1rank phase's state after its run); ``generate`` with and
   without ``fns=make_generate_fns(...)`` on the serve context, kernels
   on (K4 sums in a fixed order, so two runs of one path agree to the
   bit), the same greedy tokens;
3. checks  — holds each kernel against its plain PyTorch version on the
   card in bf16 at the full-width shapes its main path gives it: the
   fused local-MoE kernel (K4) at the decode layout (8 slots x 64
   experts), the prefill layout (4 x 128 tokens x 64 experts) and the
   one-rank training layout (a real route of 2048 tokens, 64 segments of
   128 slots, partly filled), each with the rows its FFN launches compute
   (the compacted counts) beside the weighted rows, bit-equal over 3
   repeated calls, and read by ``chip_ab.fused_readings`` (``device_ms``,
   ``call_ms``, ``host_us``, bit-equal over 5 calls);
   plus edges at Tg = 100 (a picked expert whose every weight is 0, a
   weighted sentinel slot inside a count, a segment with every slot live;
   gelu and swiglu) and swiglu at Tg = 8 and 100; its compaction launch
   (``ops.compact_slots``) bit-equal to ``ref.compact_slots`` and its
   token index (``ops.token_rows``: the compaction, scan, fill and the
   combine's sort) bit-equal to ``ref.token_rows`` at every one of those
   layouts; flash attention (K5) at the prefill shape
   [4, 128, 16, 64] and at [4, 512, 16, 64] (plus ragged, windowed,
   non-causal and GQA edge shapes), permute
   (K1) and unpermute (K2) on rank (0, 0)'s indices of the 2x2 training
   plan and of chunk 0 of the pipelined int8 plan (S = 4864 and 608 slots;
   plus edge cases: other element types and row widths, S = 0, all
   sentinels, dropped picks, K = 1, 4 and 40, uneven grids, refused
   rows), each also read as ``device_ms`` (the card's time only),
   ``call_ms`` (called as the training path calls it, under grad) and
   ``host_us`` (the enqueue cost) beside its library call, by
   ``chip_ab.py``'s reading functions, the ragged
   grouped FFN (K3) on rank (0, 0)'s indices of the 2x2 training plan
   (1024 tokens, caps (120, 16), 16 experts a rank; read by
   ``chip_ab.ragged_readings``) and on a ragged layout (R = 1888, a
   zero-count segment inside an expert's span; gelu and swiglu), K1, K2
   and K3 once more at that rank's layout after train_2x2_replan's
   replan (caps (128, 0): one stage, the empty one dropped) and at rank
   (0, 0, 0)'s of train_2x2x2 (512 tokens, three stages, 8 experts; read
   by ``chip_ab``'s functions too), K4 at serve_2x2's gather layouts
   (rank (0, 0)'s 16 experts over the world's 8 gathered decode tokens
   and over one gathered prefill pack of 4 x 128), and the
   int8 ragged
   grouped FFN (K7) on rank (0, 0)'s chunk 0 of the pipelined int8 plan
   (8 chunks of 15 + 2 slots, int8-encoded payload, counts through the
   chains) and on the whole staged 2x2 buffer (S = 4864), with the
   weights quantized once as the engine does and in the call, the dense
   grouped FFN (K6) at the einsum phase's [64, 128,
   1024] buffer (rows past each expert's count of a top-2 route of
   random tokens zero, whose outputs must be exact zeros; plus swiglu,
   C = 1, 64, 100 and 200 (a last tile of 8 rows), E = 1 and a C = 200
   swiglu buffer zero past random counts), and decode attention (K8)
   at B = 32 requests against a 32768-row cache (16 heads of 64, NaN in
   every row past a request's length; plus GQA, window, L = 1000 and
   length-0 edge cases), with kernel, plain, bound and library times (K1
   ``index_select``, K2 ``embedding_bag``, K5 and K8
   ``scaled_dot_product_attention``; K6 has no one-call library
   counterpart, and the cuBLAS chain bmm -> gelu -> bmm is timed beside
   it as ``bmm_chain_ms``), and every kernel's and yardstick's
   ``device_ms`` (the card's time only, ``chip_ab.device_ms``);
4. backward checks — each K1-K4, K6 and K7 ``autograd.Function`` on the
   card against autograd of its plain version (K7: of the full-precision
   plain version, its straight-through rule) at a small shape, and K1's
   and K2's at the 2x2 plan's rank-0 layout, before and after the
   replan, and at the 2x2x2 plan's;
5. serve   — gpt3_medium_moe at full width (12 layers, d=1024, 64
   experts top-2, vocab 50304, bf16, random weights from a seed) through
   ``ServingEngine.run``: 8 requests, 8 slots, packs of 4, prompt bucket
   128, cache 256.  Checks every stream's budget and vocabulary, that the
   launch counters show every MoE layer of every step went through K4 and
   every prefill attention through K5, and that on a small input the
   kernel path is as close to a float32 plain run as the bf16 plain path;
6. profile — host-clock step times and a torch.profiler breakdown
   (device busy share, top kernels) of one prefill pack and one decode
   step;
7. serve_2x2 — the same model (depth cut to WORLD_LAYERS, 2, for the
   time limit: see the constant) and request mix on a (pod x data) = (2, 2)
   EP world of four spawned ranks sharing the card over gloo (one spawn,
   ``world_session``, runs every 2x2 phase in turn: serve_2x2,
   train_2x2 and train_2x2_pipelined, train_2x2_replan, and 23.'s
   serving and training; each job's tensors freed before the next), each with
   its 16 experts a layer, 2 of the 8 slots and one row of each pack of
   4; every MoE layer through the gather path.  Every rank must launch
   K4 once per MoE layer of every prefill pack and decode step, K5 once
   per layer of every pack and nothing else; the ranks' streams must be
   the same; on 4 prompts (one a rank) the world's kernel path must be
   as close to a one-rank float32 plain run as the one-rank bf16 plain
   path is (E2E_RATIO, E2E_FLOOR); tokens/s and each rank's prefill-pack
   and decode-step times;
8. train_1rank — in a child process, ``trainer.train`` of full-width
   gpt3_medium_moe on one rank: ``dispatch="a2a"``, ``aux_mode="ta"``,
   seq 512, batch 4, AdamW, 3 steps.  K4 must launch once per layer and
   forward (36 times), and the first step's loss must agree with the plain
   path's (kernels off) on the same weights and batch.  Then, on the
   trained state, a forward and backward with the fused cross entropy
   (``ctx.fused_xent``) and with the default loss: the losses within
   LOSS_RTOL and each one's peak device memory; then one training step
   with it (K4 12 launches, counted as ``train_1rank_fused_xent``);
9. train_2x2 — the same on a 2x2 (pod x data) EP world of four spawned
   ranks that share the card over gloo, batch 8 (1024 tokens a rank),
   depth cut to WORLD_LAYERS (2; the time limit, below):
   every rank must launch K1, K2 and K3 6 times each and K4 never, the
   ranks must agree on the world-mean losses, and the first step's loss
   must agree with the plain path's.  Each rank profiles one more step
   twice: as shipped, and with the earlier spare-row backwards of K1 and
   K2 (``spare_row_backwards``), reporting the device time inside each
   profiler range of ``PROFILED_RANGES`` (the backwards; on the pipelined
   phase K7's forward and its weight quantization too);
10. train_2x2_pipelined — the same world (train_2x2's processes, a
   second run from the same draw: ``train_rank``'s ``then``) through
   ``dispatch="a2a_pipelined"`` with the int8 wire codec and the overlap
   model's chunk count (8), 2 steps, depth WORLD_LAYERS (2): every rank must
   launch K1, K2 and K7 32 times each (2 layers x 8 chunks x 2 steps) and
   K3 and K4 never, and
   the first step's loss must agree with the plain path's within
   LOSS_RTOL_INT8;
11. train_einsum_k6 — in train_1rank's child process (``train_chain``:
   one process start for the three one-rank gpt3 runs), full-width
   gpt3_medium_moe on
   one rank through the paper's einsum baseline (``dispatch="einsum"``,
   ``aux_mode="lb"``, ``build_ctx(use_moe_kernel=True)``, capacity 128)
   with ``trainer.make_train_step``: seq 512, batch 4, AdamW, 3 steps,
   depth CUT_LAYERS.  K6 must launch once per layer and forward (18
   times), and the first
   step's loss must agree with the plain path's (``REPRO_TORCH_KERNELS=0``:
   ``grouped_ffn_ref``) on the same weights and batch;
12. train_1rank_accum_remat — in train_1rank's child process too,
   ``trainer.train`` of
   full-width gpt3_medium_moe on one rank with batch 8 accumulated over 2
   microbatches of 4 and ``remat=True`` (every layer recomputed in the
   backward), 3 steps, depth CUT_LAYERS: K4 must launch 6 x 2 x 2 x 3 =
   72 times, the
   first step's loss (the mean of the microbatches') must agree with the
   plain path's; with remat and without, one microbatch's forward reads
   the device memory it holds for the backward and one more step reads
   the peak device memory (``remat_memory``);
13. train_resilient — in train_1rank's child process too
   (``resilient_phase``): a
   1-layer full-width model under chaos with rolling checkpoints (a
   skipped NaN step, a spike rolled back past a corrupted checkpoint to
   the one before, the restored tensors bit-equal to it; the run's own
   saves, the rollback's verify and restore timed where the trainer
   makes them), then depth CUT_LAYERS guarded
   against unguarded on the same weights (losses within LOSS_RTOL, steady
   step walls);
14. train_2x2_replan — the 2x2 world at full width and depth 2 with the
   pod axis degraded 64x: every rank must replan once, at step 2, to the
   port planner's caps with the pod level's beta at inf (last cap 0), K1,
   K2 and K3 must launch every layer of every step (after the replan too)
   and K4 never, the losses must be finite, and the first step after the
   replan must log the loss the plain path computes from the same
   parameters and batch under the replanned context (within LOSS_RTOL);
   each axis's measured alpha and beta (gloo all-to-alls) are reported;
15. train_2x2x2 — the paper's nested [[2, 2], [2, 2]] topology: eight
   ranks over (pod, node, data) sharing the card over gloo, full width,
   depth cut to 2 (WORLD_LAYERS: at 12 the eight ranks run the card
   out of memory; 6 fit, 2 for the time limit), ``a2a``,
   ``aux_mode="ta"``, seq 512, batch 8 (512 tokens a rank), 3 steps: the
   plan's three caps > 0 and a length-3 frac_by_level, K1, K2 and K3 6
   launches on every rank and K4 none,
   the first step's world-mean loss within LOSS_RTOL of the plain path's;
16. train_dp — a (pod x data) = (3, 2) world: 6 does not divide the 64
   experts, so they span data (32 a rank) and pod is pure data
   parallelism (three replicas); depth cut to DP_LAYERS, batch 6, 3
   steps: K1-K3 every layer and step, K4 none, the first step's loss
   within LOSS_RTOL of the plain path's, and every rank's expert leaves
   bit-equal (sha256) to their replicas' on the other pods;
17. DeepSeek-V2-Lite (arXiv:2405.04434) at full width on one rank,
   after every gpt3_medium_moe tensor of this process is freed: d 2048,
   MLA (rank 512, qk 128 + 64, v 128), 64 routed experts top-6 of f 1408
   beside 2 shared, swiglu, rmsnorm, a dense first layer, vocab 102400,
   27 layers, bf16 weights from seed 0.  ``checks_dsv2_lite``: K4 at the
   serve's decode and prefill gather layouts (its compaction bit-equal),
   K1 (bit-equal), K2 and K3 at the 2x2 plan's rank-0 layout and K7 at
   chunk 0 of the pipelined int8 plan, all on layer 1's weights (the
   first MoE layer), swiglu, against their plain versions with times
   and bounds.  ``serve_dsv2_lite``: the kernel path's logits against
   the bf16 plain path's (limit from a float32 plain run that casts one
   layer at a time), then the serve phase's 8 requests: K4 exactly once
   a MoE layer (26) of every prefill pack and decode step, K5 and every
   other kernel never (MLA attends in plain PyTorch); tokens/s, peak
   memory, a profiled prefill pack and decode step.
   ``e2e_dsv2_lite_d4``: the float32 three-way verdict on the first 4
   layers (a whole float32 copy of 27 does not fit beside the bf16
   weights).  ``train_dsv2_lite_d4``: in a child process, 3 steps of
   ``trainer.train`` at depth 4, seq 512, batch 4, ``aux_mode="ta"``: K4
   9 launches, the first step's loss within LOSS_RTOL of the plain
   path's, step walls and peak memory;
18. Jamba-v0.1 (arXiv:2403.19887) at full width on one rank, after
   DeepSeek-V2-Lite's weights are freed: d 4096, Mamba (d_inner 8192,
   d_state 16, dt_rank 256) in 7 of each 8 layers and GQA attention (32
   heads, 8 KV, head dim 128) in the fifth, 16 experts top-2 of f 14336
   (swiglu) in every second layer and a dense FFN of f 14336 in the
   others, vocab 65536, depth cut 32 -> 4 (``cut_depth``: its group of 8
   cut to a Mamba layer with a dense FFN, one with the MoE FFN, again,
   then attention with the MoE FFN; bf16 parameters from seed 0; the 32
   layers, 103 GB, do not fit the card, and 16, then 8, outgrew the time
   limit).
   ``init_jamba_d4``; ``checks_jamba`` (``checks_wide`` on layer 1: K4
   at the decode (8 slots) and prefill-scan step (4 rows) gather layouts
   and the one-rank forward layout (seq 512 x batch 2, 160 slots an
   expert), K1-K3 at the 2x2 plan's rank 0 (4 experts a rank), K7 at
   pipelined chunk 0); ``serve_jamba_d4``: the kernel path's and the
   bf16 plain path's logits, then the serve mix prefilled by scanning
   decode steps as the reference prefills recurrent models: K4 exactly 2
   x (scan steps + decode steps), K5 and every other kernel never;
   ``e2e_jamba_d4``: the float32 verdict on those logits, the float32
   run casting one layer at a time; ``loss_jamba_d4``: one forward and
   loss through ``loss_fn`` on the one-rank ``a2a`` path (seq 512, batch
   2, no backward), K4 once a MoE layer, within LOSS_RTOL of the plain
   path's;
19. the dense decoders (OLMo-1B arXiv:2402.00838, Granite-3.0-2B
   hf:ibm-granite/granite-3.0-2b-base, InternLM2-1.8B arXiv:2403.17297,
   Minitron-4B arXiv:2407.14679) at full width and full depth on one
   rank, after Jamba's weights are freed, bf16 weights from seed 0.
   ``checks_dense``: K5 at each one's serving prefill shape ([4, 128, H,
   hd] with its KV heads: 16/16/128, 32/8/64, 16/8/128, 24/8/128) and
   at [4, 512, 16, 128] with 8 KV heads beside SDPA, windowed and
   non-causal at hd 128; K8 at hd 128 on the decode_32k cache (B = 32,
   L = 32768, 8 KV heads, G = 2, random lengths with one 0: exact zeros
   there) beside SDPA, and windowed.  ``serve_<config>`` for each:
   ``serve_mix`` with ``use_flash=True``, K5 exactly once an attention
   layer of every prefill pack and every other kernel never; tokens/s,
   a profiled prefill pack and decode step, peak memory;
   ``e2e_<config>``: the float32 verdict against a whole float32 copy.
   ``train_internlm2``: in a child process, 3 steps at seq 512, batch 4,
   ``aux_mode="none"`` on the plain ``_sdpa`` path (K5 has no backward),
   every kernel at 0; step walls, peak memory, a profiled step; then
   one step with ``microbatch=2`` against the full-batch step from the
   same state, losses within LOSS_RTOL;
20. the last three families at full width on one rank, after the dense
   decoders' weights are freed, bf16 weights from seed 0: xLSTM-350M
   (arXiv:2405.04517; 7 mLSTM then one sLSTM in each group of 8, d 1024,
   vocab 50304; depth cut 24 -> 8, one whole group, for the time limit), Whisper-tiny (arXiv:2212.04356;
   4 encoder and 4 decoder layers, d 384, 6 heads of 64, 1500 frames a
   request from ``models/whisper.make_frames``) and InternVL2-26B
   (arXiv:2404.16821; 48 layers, d 6144, 48 over 8 KV heads of 128, f
   16384, 19.3 B parameters; 256 patches of width 1024 a request from
   ``models/vlm.make_patches``, prompts of 256 + 32-128 tokens in a
   bucket of VLM_BUCKET).  ``checks_families``: K5 at Whisper's encoder
   shape [4, 1500, 6, 64] non-causal (ragged last blocks) and at
   InternVL2's prefill pack [4, VLM_BUCKET, 48, 128] over 8 KV heads
   (GQA 6:1), beside SDPA.  ``serve_<config>`` for each: ``serve_mix``
   with ``use_flash=True`` and per-request frontends; K5 exactly once an
   encoder layer (Whisper) or a layer (InternVL2) of every prefill pack,
   xLSTM no kernel at all, every other kernel never; xLSTM and Whisper
   prefill by scanning decode steps.  ``e2e_<config>``: the float32
   verdict (xLSTM's kernel path is its plain path; InternVL2's float32
   run casts one layer at a time).  The families through the trainer,
   in train_1rank's child process (``train_chain``), one rank at full
   width, TRAIN_SEQ x TRAIN_BATCH_1 with their frames or patches:
   ``train_whisper`` (full depth), ``train_xlstm`` (8 of 24 blocks) and
   ``train_internvl2_d4`` (4 of 48 layers), ``family_train_phase``: no
   kernel launched (attention through ``_sdpa``), the first bf16 step's
   loss and global gradient norm within FAMILY_TRAIN's limits of a
   float32 step's on the same weights and batch, the loss falling over
   FAMILY_TRAIN_STEPS steps on that one batch (RunConfig's warmup);
   ``train_jamba_d2`` (``train_phase`` at JAMBA_TRAIN_LAYERS: a Mamba
   layer with a dense FFN, then attention with the MoE FFN): before the
   run, K4 against its plain version and its compaction bit-equal at the
   run's own first-step layout (``own_layout_k4``: seq 512 x batch 4, 16
   experts of 320 slots), then K4 once a step, the first-step loss within
   LOSS_RTOL of the plain path's; each
   with step walls, busy share and peak memory;
21. tensor parallelism — a (data 1, model 2) world of two gloo ranks
   sharing the card (``tp_phases``), after every other model's weights
   are freed.  ``checks_tp2``: K4 at a model rank's layouts (layer 0's
   experts cut to f / 2 = 1024: the gather path's decode and prefill
   layouts over all 64 experts and train_1rank's layout) and K5 at
   gpt3's prefill pack with 8 of 16 heads and Minitron-4B's with 12 of
   24 heads over 4 of 8 KV heads of 128, against their plain versions,
   timed, with bounds.  ``serve_tp2``: gpt3_medium_moe at depth
   WORLD_LAYERS, each rank holding half of every attention's heads, of
   every expert's width and of the vocabulary: the end-to-end verdict of
   the E2E rows against one-rank float32 and bf16 plain runs (greedy
   tokens printed beside the one-rank kernel run's), then the serve
   phase's requests: K4 exactly once a layer of every prefill pack and
   decode step, K5 once a layer of every pack, every other kernel never,
   both ranks' streams and top-k picks (sha256 of every gate's picks)
   equal; tokens/s and parameter bytes a rank; then Minitron-4B at
   depth TP_DENSE_LAYERS (vocabulary 256000 split in two): one prefill
   of the E2E rows and TP_DENSE_STEPS decode steps through K5 (4
   launches) against its own one-rank float32 run.  ``train_tp2``:
   gpt3_medium_moe at depth WORLD_LAYERS, ``aux_mode="ta"``,
   train_1rank's batch, TP_TRAIN_STEPS steps: K4 once a layer a step,
   the first-step loss within LOSS_RTOL of the one-rank plain path's,
   a sliced and two replicated leaves' gradients (gathered) within the
   bf16 backward tolerances of the one-rank plain path's, the ranks'
   losses and picks equal; step walls, busy share, peak memory; then
   one step of the einsum baseline with ``use_moe_kernel``
   (``aux_mode="lb"``): K6 once a layer at a model rank's f 1024 (its
   [64, 128, 1024] buffer checked in ``checks_tp2``), the first-step
   loss within LOSS_RTOL of the one-rank plain einsum path's;
22. tensor parallelism on an EP x TP world and on the other families
   (in ``tp_phases`` too: the (data 1, model 2) world is spawned once
   for serve_tp2, train_tp2 and serve_tp2_families, ``world_session``,
   after the main process has built all their references).
   ``checks_ep_tp``:
   K1, K2, K3 and K7 at rank 0's layouts of a (data 2, model 2) EP x TP
   world (32 experts a rank, each at f 1024: the a2a plan's S = 8192
   and the pipelined int8 plan's chunk 0, S = 1024) against their plain
   versions, timed, with bounds (K1 and K2 without the call, host and
   library readings of the 2x2 layouts).  ``train_ep_tp``:
   gpt3_medium_moe at depth WORLD_LAYERS on that world of four gloo
   ranks sharing the card, EP_TP_STEPS steps through a2a (K1, K3, K2 once a layer a step) and
   EP_TP_PIPELINED_STEPS through a2a_pipelined over the int8 wire (K1,
   K7, K2 once a layer a chunk a step), each run's first-step loss
   within LOSS_RTOL (LOSS_RTOL_INT8) of the plain path's, the model
   ranks of each data rank with bit-equal picks, step walls, busy share
   and peak memory a rank; the a2a state through ``ckpt.save`` /
   ``verify`` / ``restore_into`` of its parameters (one payload a
   process), bit-equal, timed.  ``checks_tp2_families``: K4 at
   DeepSeek-V2-Lite's f 704 and Jamba's f 7168, K5 at Whisper's encoder with 3 of 6 heads and
   InternVL2's prefill with 24 of 48 over 4 of 8 KV heads, on each
   family's one-rank weights, timed; each family's bf16 and float32
   plain runs of TP_FAMILY_DRAWS draws of the E2E rows.
   ``serve_tp2_families``: each of TP_FAMILIES on the (data 1, model 2)
   world, for each draw one prefill and TP_FAMILY_STEPS decode steps,
   held against the one-rank float32 runs by ``e2e_row_verdict`` at
   E2E_RATIO times the one-rank bf16 plain runs' error, request by
   request (the median of the draws' rows), launches exact, the ranks'
   picks and greedy tokens equal, parameter bytes a rank;
23. the repo's other MoE models on the paper's 2x2 EP world: their
   one-rank references and checks (``ep_family_references``) in the main
   process after the serve phase's weights are freed, their serving and
   training as jobs of the 2x2 world's session (``ep_family_jobs``,
   after train_2x2_replan; ``ep_family_results`` reads them):
   DeepSeek-V2-Lite at depth 3 (the dense first layer and two MoE
   layers; 16 routed experts of f 1408 a rank, top-6, 2 shared, MLA),
   Jamba at depth 2 (``cut_depth``; 4 experts of f 14336 a rank) and
   DeepSeek-V2-236B at depth 3 (d 5120, 128 MLA heads with the low-rank
   query branch; 40 routed experts of f 1536 a rank, top-6, 2 shared;
   the ranks draw its weights in turns, ``init_in_turns``).
   ``checks_dsv2_2x2``: K4 at both models' gather layouts of the 2x2
   serving world (rank 0's experts over 8 gathered decode slots, and a
   gathered prefill pack of 4 x 128 or a scan step of 4 rows), and K1,
   K2 (top-6), K3 (swiglu) at DeepSeek-V2-Lite's staged buffer of
   train_dsv2_2x2 (batch DSV2_22_BATCH: 512 tokens a rank, caps (112,
   16)) and K7 (swiglu) at chunk 0 of its int8 pipelined plan, each
   equal to ``kernels/layouts.py``'s registered layout, against its
   plain version, timed; each model's one-rank bf16 and float32 plain
   runs of TP_FAMILY_DRAWS draws of the E2E rows.
   ``checks_dsv2_236b_2x2``: the same for DeepSeek-V2-236B at the same
   plan (K1 and K2 at T 512, S 5120; K3 over its 40 experts of f 1536
   at d 5120; K7 at chunk 0 of 8, R 640; K4 over the 40 experts at the
   gathered decode slots and pack), its float32 run cast one layer at a
   time.  ``serve_dsv2_2x2``, ``serve_jamba_2x2`` and
   ``serve_dsv2_236b_2x2`` (one spawn of four ranks, ``serve_rank`` a
   model): the kernel path's median request within E2E_RATIO of the
   one-rank bf16 run's (``e2e_row_verdict``), EP_FAMILY_REQUESTS of
   the serve mix through ``ServingEngine.run``, every MoE layer through
   the gather path (K4 once a MoE layer of every pack, scan step and
   decode step; K5 never: MLA attends in plain PyTorch, Jamba prefills
   by scan), the ranks' streams equal; tokens/s, prefill and decode
   step times.  ``train_dsv2_2x2``: DSV2_22_STEPS steps through a2a
   (K1, K3, K2 once a MoE layer a step) and DSV2_22_INT8_STEPS through
   a2a_pipelined over the int8 wire (K1, K7, K2 once a MoE layer a
   chunk), each first-step loss within LOSS_RTOL (LOSS_RTOL_INT8) of the
   plain path's, peak memory a rank;
24. kernels — one ``{"kernels": [...]}`` line for K1-K8, launches
   summed over the main paths (serve, every rank of serve_2x2,
   train_1rank and its fused cross entropy step, every rank of
   train_2x2 and train_2x2_pipelined, train_einsum_k6,
   train_1rank_accum_remat, train_resilient, every rank of
   train_2x2_replan, train_2x2x2 and train_dp, serve_dsv2_lite,
   train_dsv2_lite_d4, serve_jamba_d4, loss_jamba_d4, the four dense
   ``serve_<config>``, train_internlm2, the three families'
   ``serve_<config>``, every rank of serve_tp2 (gpt3 and Minitron),
   train_tp2 and its einsum step, train_ep_tp (a2a and pipelined),
   each family's serve_tp2_<config>, serve_dsv2_2x2, serve_jamba_2x2,
   serve_dsv2_236b_2x2 and train_dsv2_2x2 (a2a and pipelined),
   train_jamba_d2 and the families' training), with DeepSeek-V2-Lite's,
   DeepSeek-V2-236B's and Jamba's readings beside each of K1-K4 and K7
   (one rank's and the 2x2 world's), the hd-128 readings beside K5's
   and K8's, the
   families' shapes beside K5's, the tensor-parallel layouts beside
   K4's, K5's and K6's, and the EP x TP layouts beside K1, K2, K3 and
   K7's.  K8 lies on no path (no model calls it, as in the reference):
   its row gives the launches of its checks as ``check_launches``.

Every phase but the einsum steps must show no launch of K6, and every
phase none of K8; no training phase's plain run may launch any kernel.
Any failed phase raises (exit code non-zero).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

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

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

ARCH_ID = "gpt3_medium_moe"
NUM_SLOTS, PACK, BUCKET, CACHE_LEN = 8, 4, 128, 256
NUM_REQUESTS = 8
# H100 SXM published dense peaks (NVIDIA data sheet), used for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_INT8_OPS_PER_S = 1979e12
# kernel vs plain tolerances in bf16: |kernel - plain| <= ATOL + RTOL*|plain|.
# K4: the plain version rounds each expert row to bf16 before the weighted
# combine (the kernel combines its f32 accumulator), and the FFN's f32 sums
# run in another order (the kernel's tile products; its combine adds a
# token's rows in slot order, as the plain index_add_ does): a few bf16
# ulps of |y| ~ 1.
K4_ATOL, K4_RTOL = 3e-2, 2e-2
# K5: scores, softmax and output sums in f32 on both sides, but the kernel
# rounds each probability to bf16 for the tensor cores' P.V product (the
# plain version keeps it f32): a relative error of up to 2^-9 a weight,
# which averages out over the keys of a row, then one bf16 rounding of the
# output; together at most a bf16 ulp or two of |out|, which RTOL covers.
K5_ATOL, K5_RTOL = 1e-2, 1e-2
# K2: both sum K = 2 weighted bf16 rows in f32; the kernel fuses each
# multiply-add (one rounding fewer): an f32 ulp or two of |out| ~ 1.
K2_ATOL, K2_RTOL = 1e-5, 1e-5
# K3: as K4 (bf16 output of f32 sums taken in another order).  K1 copies
# rows and must be bit-equal.
K3_ATOL, K3_RTOL = 3e-2, 2e-2
# K7: its integer sums are exact on both sides and both dequantize with the
# same f32 factors; the rest is K3's (bf16 hidden and output, f32 sums of
# the down-projection in another order)
K7_ATOL, K7_RTOL = K3_ATOL, K3_RTOL
# K6: K3's arithmetic on equal, full segments (bf16 hidden and output of f32
# sums taken in another order)
K6_ATOL, K6_RTOL = K3_ATOL, K3_RTOL
# K8: f32 inside on both sides, then one bf16 rounding of the output.  The
# split combine sums in another order than the plain softmax, which leaves
# the two f32 results a few f32 ulps apart; the rounding then puts them at
# most one bf16 ulp apart, at most 2^-7 of the value, which RTOL covers.
# ATOL is kept small because the outputs are: a request of length n averages n
# unit-variance v rows, so |out| ~ n^-1/2, about 0.013 at the main shape's
# median length.  Sound H100 runs read at most 2.4e-4 max abs error, all
# of it within RTOL (4.1e-9 beyond it).  A planted fault that drops one
# 512-row split from each request longer than 24k rows needed an atol of
# 5.3e-3 on an H100: caught here, not by K5's 1e-2 + 1e-2*|plain|.
K8_ATOL, K8_RTOL = 1e-4, 1e-2
# the library call SDPA is only the K8 row's yardstick: its check against
# the plain version keeps K5's tolerance
K8_LIB_ATOL, K8_LIB_RTOL = K5_ATOL, K5_RTOL
# K4's determinism: calls on one input that must give equal bits
REPEATS_K4 = 3
# K8's main check: the reference's decode_32k cache length, gpt3_medium_moe's
# heads, 32 requests (a 4.3 GB bf16 cache)
DECODE_B, DECODE_L = 32, 32768
# backward checks: a Function on the card against autograd of its plain
# version, |got - want| <= ATOL + RTOL * max|want| per tensor.  f32 (K1,
# K2): scatter-adds by atomics in another order.  bf16 inputs (K3, K4):
# the same plain arithmetic, but autograd's scatter-add of the weight
# gradients over an expert's segments runs in bf16 with atomics, so the
# order of those sums (a few bf16 ulps of the largest entry) changes from
# run to run.
BWD_F32_ATOL, BWD_F32_RTOL = 1e-5, 1e-5
BWD_BF16_ATOL, BWD_BF16_RTOL = 1e-2, 3e-2
# training phases: full width, seq 512, 3 steps; one rank with batch 4
# (2048 tokens, caps (128,)), the 2x2 world with batch 8 (1024 tokens a
# rank, caps (120, 16))
TRAIN_SEQ, TRAIN_STEPS = 512, 3
# the pipelined phase's steps take about 10 s each over gloo; two keep the
# whole smoke near its earlier length and still check a step that starts
# from updated weights
PIPELINED_STEPS = 2
TRAIN_BATCH_1, TRAIN_BATCH_22 = 4, 8
WORLD_22 = (2, 2)
# first-step world-mean loss, kernel path against the plain path, both in
# bf16: the kernels round and sum in other orders, which can flip a few
# near-tied top-2 picks in later layers; the loss is a mean over 2048
# tokens (4096 in the world), so it moves far less than one token's share.
# Sound runs on an H100 gave 9.3e-5 (one rank) and 1.4e-4 (2x2 world).
LOSS_RTOL = 1e-3
# the int8 wire's phase: the kernel path quantizes each (expert, stage,
# source) segment with its own scale, the plain path each expert's chunk
# span with one, so the two first-step losses differ by more than bf16
# rounding.  At the phases' depth (WORLD_LAYERS, 2) on an H100
# (chip_k7_guard.py): 3.0e-4 relative in a sound run on the 2x2 world,
# and faults planted in K7's per-segment scales moved it by 4.4e-3
# (stage-1 segments x1.25), 5.3e-3 (every segment x1.1), 1.2e-2 (stage-1
# zeroed) and 1.4e-2 (stage-1 x2): the limit sits 5x above the sound gap
# and 2.9x below the smallest fault; on train_ep_tp's world 7.9e-5 sound,
# 6.0e-3 with every segment x1.1 (its one stage has no narrow segments).
# At 6 layers: 2.2e-4 sound, faults from 7.0e-3; at 12: 3.0e-4, 8.1e-3.
LOSS_RTOL_INT8 = 1.5e-3
PIPELINED_CHUNKS = 8      # the overlap model's pick for the 2x2 plan
# the command time varies about a fifth with the host a run lands on (1064
# and 1257 s for one tree on two H100 machines at 700 W) against a limit
# of 1200 s: train_einsum_k6, train_1rank_accum_remat, the resilient
# phase's guard runs take CUT_LAYERS of gpt3_medium_moe's 12
# layers (every layer is alike, so each path, kernel and check runs as at
# 12, half as often)
CUT_LAYERS = 6
# every world phase of gpt3_medium_moe (serve_2x2, train_2x2,
# train_2x2_pipelined, train_2x2x2, serve_tp2, train_tp2, train_ep_tp)
# takes WORLD_LAYERS: with the tensor-parallel phases after them the whole
# smoke outgrew its time limit, and these worlds' collectives and steps
# scale with the depth (every layer is alike, so each path, kernel and
# check runs as at 12)
WORLD_LAYERS = 2
# train_1rank_accum_remat: one rank, full depth, batch 8 as 2 microbatches
# of 4, each layer recomputed in the backward
ACCUM_BATCH, ACCUM_MICRO = 8, 4
# train_resilient: 9 steps of a 1-layer model with a checkpoint every 2
# steps; step 2's gradients are NaN (skipped), the parameters are scaled
# 10x after step 6 (the loss spikes at 7 and 8: rolled back at 8), and the
# step-5 checkpoint is corrupted right after its save (the rollback falls
# back to step 3); then GUARD_STEPS steps at full depth per guard run
RESILIENT_STEPS, GUARD_STEPS = 9, 4
RESILIENT_CHAOS = {"nan_grad_steps": (2,), "spike_steps": (6,),
                   "corrupt_ckpt_steps": (5,)}
# train_2x2_replan: the pod axis degrades 64x from step 1; the step-2
# probe collapses the pod level (replan_every 2), 4 steps, depth 2
REPLAN_LAYERS, REPLAN_STEPS = 2, 4
REPLAN_RESILIENCE = {"replan_every": 2, "degrade_threshold": 4.0,
                     "collapse_slowdown": 64.0}
REPLAN_CHAOS = {"degraded_links": ((1, "pod", 64.0),)}
# train_2x2x2: the paper's nested [[2, 2], [2, 2]] topology, eight ranks
# sharing the card over gloo, batch 8 (512 tokens a rank), at
# WORLD_LAYERS.  At 12 layers each rank peaks at 9.15 GB allocated
# (10.3 GB reserved: AdamW's f32 moments of its 0.5 B parameters, 4 GB, and K3's plain f32
# backward), and eight of them ran the 79 GB card out of memory on an
# H100; at 6 layers each peaks at 6.57 GB
SPEC_222 = [[2, 2], [2, 2]]
TRAIN_BATCH_222 = 8
# train_dp: a (pod x data) = (3, 2) world: 6 does not divide 64 experts, so
# the experts span data (32 a rank) and pod is pure data parallelism with
# three replicas; batch 6 (512 tokens a rank); depth cut to 2, as
# train_2x2_replan's, for memory (six ranks of 32 experts a layer) and time
WORLD_DP, TRAIN_BATCH_DP, DP_LAYERS = (3, 2), 6, 2
# serve_2x2 and the end-to-end check on it: 4 prompts of 32 tokens, one a
# rank, prefill + 4 decode steps
E2E_PROMPT, E2E_STEPS, E2E_ROWS = 32, 4, 4
# end to end after 12 bf16 layers, relative Frobenius error of the logits
# against a float32 plain run: the kernel path may be at most E2E_RATIO
# times as far from it as the plain bf16 path (both differ from float32 by
# bf16 rounding, which random-weight layers amplify), or E2E_FLOOR
E2E_RATIO, E2E_FLOOR = 1.5, 1e-2
# DeepSeek-V2-Lite (arXiv:2405.04434) at full width: d 2048, 16 MLA heads
# (rank 512, qk 128 + 64, v 128), 64 routed experts top-6 of f 1408 beside
# 2 shared, a dense first layer of f 10944, vocab 102400, 27 layers (15.5 B
# bf16 parameters, 31 GB from seed 0); the checks take layer 1's weights,
# its first MoE layer.  e2e_dsv2_lite_d4 and train_dsv2_lite_d4 cut the
# depth to 4 (the dense layer and 3 MoE layers): at 27 a float32 copy
# beside the bf16 weights (93 GB), or AdamW's float32 moments (124 GB), do
# not fit the card
DSV2_ID, DSV2_MOE_LAYER, DSV2_CUT_LAYERS = "deepseek_v2_lite_16b", 1, 4
# Jamba-v0.1 (arXiv:2403.19887) at full width: d 4096, 32 heads (8 KV) of
# 128, Mamba (d_inner 8192, d_state 16, dt_rank 256) in 7 layers of each
# group of 8 and attention in the fifth, 16 experts top-2 of f 14336
# (swiglu) in every second layer and a dense FFN of f 14336 in the others,
# vocab 65536.  Depth cut 32 -> 4 (``cut_depth``: the group of 8 cut to
# 4 with each kind of layer kept, attention last): the 32 layers are 51.3
# B parameters, 103 GB in bf16, more than the card holds, and 16 (25.8
# B), then 8 (13.0 B), outgrew the time limit.  The checks take layer 1's
# weights (the first MoE layer); loss_jamba_d4 runs one forward at seq
# 512, batch 2 (1024 tokens, 160 slots an expert at capacity 1.25)
JAMBA_ID, JAMBA_LAYERS, JAMBA_MOE_LAYER = "jamba_v0_1_52b", 4, 1
JAMBA_LOSS_BATCH = 2
# the dense decoders at full width and full depth, one rank each, after
# Jamba's weights are freed (bf16 parameters from seed 0: OLMo-1B 1.18 B,
# Granite-3.0-2B 2.53 B, InternLM2-1.8B 1.70 B, Minitron-4B 4.31 B; a
# whole float32 copy of the largest, 17.2 GB, fits beside its bf16
# weights, so no depth is cut).  K5's checks at each one's serving
# prefill shape [PACK, BUCKET, H, hd] with its KV heads, at the training
# length [PACK, TRAIN_SEQ, 16, 128] with 8 KV heads, and windowed; K8 at
# head dim 128 on the decode_32k cache (DECODE_B x DECODE_L, 8 KV heads
# of 128, G = 2) and windowed.  train_internlm2: TRAIN_STEPS steps at
# TRAIN_SEQ x TRAIN_BATCH_1 on the plain _sdpa path (K5 has no backward),
# then one step with microbatch DENSE_MICRO against the full-batch step
# from the same state
DENSE_IDS = ("olmo_1b", "granite_3_2b", "internlm2_1_8b", "minitron_4b")
DENSE_TRAIN_ID, DENSE_MICRO = "internlm2_1_8b", 2
# the last three families at full width, one rank each, after the dense
# decoders' weights are freed, bf16 weights from seed 0: xLSTM-350M (d
# 1024; no attention, no experts: no hand-written kernel on its path; its
# 24 blocks cut to FAMILY_LAYERS' 8, one whole group, for the time
# limit), Whisper-tiny (4 encoder + 4 decoder layers, d 384, 6
# heads of 64; each request carries 1500 frames: K5 non-causal in the
# encoder, once an encoder layer of every prefill pack; the decoder
# prefills by scan) and InternVL2-26B (48 layers, d 6144, 48 over 8 KV
# heads of 128, 19.3 B parameters, 38.7 GB; each request carries 256
# patches of width 1024, so its prompts are 256 + 32-128 tokens in a
# bucket of VLM_BUCKET: K5 once a layer of every prefill pack).  The
# float32 verdicts: xLSTM's and Whisper's on a whole float32 copy,
# InternVL2's cast one layer at a time (a whole copy is 77 GB)
XLSTM_ID, WHISPER_ID, VLM_ID = "xlstm_350m", "whisper_tiny", "internvl2_26b"
FAMILY_IDS = (XLSTM_ID, WHISPER_ID, VLM_ID)
FAMILY_LAYERS = {XLSTM_ID: 8}
# the families through the trainer on the card, one rank each at full
# width, in train_1rank's child process (``train_chain``), batch
# TRAIN_BATCH_1 with their frames or patches from ``SyntheticLM``:
# Whisper-tiny at full depth, xLSTM-350M at 8 of 24 blocks (one whole
# group: 7 mLSTM and the sLSTM) and sequence XLSTM_TRAIN_SEQ (its sLSTM
# steps the positions one by one, about 107 launches a position forward
# and backward: at 512 a step made 54,754 launches and its profiled step
# cost 12.6-14.2 s, which took the smoke over its time budget),
# InternVL2-26B at 4 of 48 layers (2.2 B parameters; with AdamW's
# float32 moments 37.5 GB at the peak), each (phase, config, depth (0:
# the full depth), sequence, loss limit, gradient-norm limit).  They run no hand-written kernel in training (attention
# through ``_sdpa``; K5 is forward-only), so each is held to a float32
# step of the same weights and batch: the first bf16 step's loss and
# global gradient norm within the limits (relative); and to a loss that
# falls over FAMILY_TRAIN_STEPS steps on one repeated batch at the
# trainer's default warmup (RunConfig's 100 steps: lr 3e-6, then 6e-6).
# At full lr from the first step (warmup 1) InternVL2's loss doubles
# after the first update in bf16 and in float32 alike (12.49 -> 25.87
# and 25.82 on an H100), an overshoot of Adam's first, sign-sized step
# at d 6144, not a fault of the path.  Each limit sits between the sound
# gap and the nearest fault planted in the bf16 step
# (``chip_family_train.py --faults``; on an H100, bit-equal over runs and
# machines), near their geometric mean (bf16 against float32, loss /
# gradient norm): Whisper sound 4.0e-6 / 2.4e-4, a middle layer's
# self-attention output zeroed 9.0e-4 / 0.032, its gradients zeroed 0 /
# 0.029, the frames zeroed 5.6e-3 / 3.6e17; InternVL2 sound 7.5e-5 /
# 1.6e-5, a layer's attention output zeroed 2.1e-3 / 0.045, its
# gradients zeroed 0 / 0.051, the patches zeroed 0.025 / 0.41, the
# patch mask ignored 8.0e-3 / 0.30; xLSTM sound 2.3e-5 / 0.083 (random-
# weight xLSTM is ill-conditioned in bf16: its first blocks' gradients
# lie a third of their norm from float32), the middle mLSTM's output
# zeroed 1.1e-3 / 0.155; its gradients zeroed (0.084) lie within xLSTM's
# sound gap and no limit sees them.  The learning rate negated makes
# every family's loss rise over the steps, which the falling-loss check
# refuses.
XLSTM_TRAIN_SEQ = 128
FAMILY_TRAIN = (("train_whisper", WHISPER_ID, 0, TRAIN_SEQ, 6e-5, 5e-3),
                ("train_xlstm", XLSTM_ID, 8, XLSTM_TRAIN_SEQ, 1.5e-4, 0.11),
                ("train_internvl2_d4", VLM_ID, 4, TRAIN_SEQ, 4e-4, 5e-3))
FAMILY_TRAIN_STEPS = 2
# train_jamba_d2: Jamba at depth JAMBA_TRAIN_LAYERS (``cut_depth``: a
# Mamba layer with a dense FFN, then attention with the MoE FFN, K4's
# forward; 65 GB at the peak with AdamW's moments and the eager
# update's float32 temporaries of the 0.94 B-entry expert leaves, since
# K4's backward takes one expert's float32 weights at a time) through
# ``train_phase``, its first-step loss within LOSS_RTOL of the plain
# path's
JAMBA_TRAIN_LAYERS = 2
VLM_BUCKET, VLM_CACHE_LEN = 384, 512
# tensor parallelism: a (data 1, model 2) world of two gloo ranks sharing
# the card, each with half of every attention's heads, of every FFN's and
# expert's width and of the vocabulary.  serve_tp2: gpt3_medium_moe at
# depth WORLD_LAYERS with the serve phase's request mix, then Minitron-4B at
# depth TP_DENSE_LAYERS (one prefill of the E2E rows, TP_DENSE_STEPS
# decode steps); train_tp2: gpt3_medium_moe at depth WORLD_LAYERS,
# TP_TRAIN_STEPS steps at train_1rank's shapes.  Depths cut for the time
# limit: the new phases are budgeted at 120 s together
TP_WORLD, TP_MODEL = (1,), 2
TP_DENSE_ID, TP_DENSE_LAYERS, TP_DENSE_STEPS = "minitron_4b", 4, 8
TP_TRAIN_STEPS = 2
# train_tp2's gradients against the one-rank plain path's: a sliced leaf
# (layer 0's wq columns) and two replicated ones (layer 0's norm scale and
# layer 1's gate), gathered over the model axis
TP_GRAD_LEAVES = (("layers", "0", "mixer", "wq"),
                  ("layers", "0", "norm1", "scale"),
                  ("layers", "1", "ffn", "gate", "w"))
# tensor parallelism on an EP x TP world and the other families.
# train_ep_tp: gpt3_medium_moe at depth WORLD_LAYERS on an EP x TP world of
# four gloo ranks (EP_TP_WORLD x TP_MODEL: 32 experts a rank over data,
# each at f 1024 over model), TRAIN_BATCH_22 rows: EP_TP_STEPS steps
# through a2a (K1, K3, K2), then EP_TP_PIPELINED_STEPS through
# a2a_pipelined over the int8 wire (K1, K7, K2), and a checkpoint round
# trip.  serve_tp2_families: on the (data 1, model 2) world, each family
# at its depth below (``tp_family_of``), TP_FAMILY_DRAWS draws of the E2E
# rows' prompts, each one prefill and TP_FAMILY_STEPS decode steps,
# against the family's one-rank float32 run of the same draw:
# DeepSeek-V2-Lite at depth 4 (MLA; K4 at f 704), Jamba at 2 (its group
# of 8 cut to 2: a Mamba layer with a dense FFN, then attention with the
# MoE FFN, K4 at f 7168; its scan prefill), xLSTM-350M at 2 (its group cut
# to an mLSTM and an sLSTM block), Whisper-tiny at 2 decoder layers (its
# 4 encoder layers: K5 at 3 of 6 heads, non-causal; cross-attention by
# heads), InternVL2-26B at 2 (prompts of VLM_BUCKET with 256 patches: K5
# at 24 of 48 heads over 4 of 8 KV heads).  Depths and steps cut for the
# time limit
EP_TP_WORLD = (2,)
EP_TP_STEPS, EP_TP_PIPELINED_STEPS = 2, 1
TP_FAMILY_STEPS, TP_FAMILY_DRAWS = 4, 3
TP_FAMILIES = (("deepseek_v2_lite_16b", 4), ("jamba_v0_1_52b", 2),
               ("xlstm_350m", 2), ("whisper_tiny", 2), ("internvl2_26b", 2))
# the repo's other two MoE models on the paper's 2x2 EP world (pod x
# data; four gloo ranks sharing the card, each with a quarter of the
# experts), after every other model's weights are freed: DeepSeek-V2-Lite
# at depth 3 (its dense first layer and two MoE layers of 16 experts of f
# 1408 a rank, top-6, 2 shared: one staged layer feeds another) and
# Jamba at depth 2 (``cut_depth``: a Mamba layer with a dense FFN, then
# attention with the MoE FFN, 4 experts of f 14336 a rank).
# checks_dsv2_2x2: the kernels at rank 0's layouts (the layouts of
# ``kernels/layouts.py``'s ``dsv2_staged``); serve_dsv2_2x2 and
# serve_jamba_2x2: ServingEngine.run of EP_FAMILY_REQUESTS of the serve
# mix (one pack of 4: 1.56 B parameters a rank for Jamba, 3.1 GB), every
# MoE layer through gather, held by ``e2e_row_verdict`` to the one-rank
# runs of TP_FAMILY_DRAWS draws of the E2E rows; train_dsv2_2x2:
# DSV2_22_STEPS steps through a2a, then in the same processes
# DSV2_22_INT8_STEPS through a2a_pipelined over the int8 wire, at global
# batch DSV2_22_BATCH (512 tokens a rank; about 0.84 B parameters and 10
# GB of state a rank).  Jamba does not train on the card's world: with
# its gradients and AdamW moments it would hold about 19 GB a rank
# DeepSeek-V2-236B (arXiv:2405.04434), the configuration the paper's
# topology-aware dispatch exists for (236 B parameters, 470 GB in bf16:
# no one card holds it), joins them on the 2x2 world: full width (d
# 5120, 128 MLA heads with the low-rank query branch, q_lora_rank 1536,
# 160 routed experts top-6 of f 1536 beside 2 shared, vocab 102400) cut
# to depth 3 (the dense first layer and two MoE layers), 40 experts a
# rank: about 3.7 B parameters, 7.3 GB a rank; the one-rank references
# hold 8.8 B (17.6 GB) and cast one layer at a time to float32.  Its
# kernels are checked at train_dsv2_2x2's plan (checks_dsv2_236b_2x2);
# it serves (serve_dsv2_236b_2x2) but does not train: at depth 2 a
# rank's bf16 parameters and gradients and float32 moments would be
# about 31 GB, 123 GB for the four ranks on one card.  Each rank draws
# a layer's 160 experts whole before keeping its 40 (about 17 GB of
# transients), so the ranks of a serving world draw their weights in
# turns (``init_in_turns``)
DSV2_236B_ID = "deepseek_v2_236b"
# (config, depth, the short name of its phases)
EP_FAMILIES = ((DSV2_ID, 3, "dsv2"), (JAMBA_ID, 2, "jamba"),
               (DSV2_236B_ID, 3, "dsv2_236b"))
EP_FAMILY_REQUESTS = 4
DSV2_22_BATCH, DSV2_22_STEPS, DSV2_22_INT8_STEPS = 4, 2, 1
# kernels no earlier phase may launch: K6 runs only on the einsum phases, K8
# on no path
OFF_PATH = ("moe_gemm.grouped_ffn", "decode_attn.decode_attention")
# the profiler ranges whose device time a profiled training step reports:
# the backwards written for K1 and K2, the ragged FFN's (K3's and K7's)
# backward, and K7's forward (of it the profiler credits the x
# quantization's operators, not the ctypes launches) and its weight
# quantization (once a layer forward)
PROFILED_RANGES = ("moe_permute.permute.backward",
                   "moe_permute.unpermute.backward",
                   "moe_gemm.grouped_ffn_ragged.backward",
                   "moe_gemm.grouped_ffn_ragged_quant.forward",
                   "moe_gemm.quantize_expert_weights")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(torch, got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def atol_needed(torch, got, want, rtol) -> float:
    """The least atol with which ``close(got, want, atol, rtol)`` holds."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - rtol * want.abs()).max().clamp(min=0))


def dev_ms(torch, fn, iters: int) -> float:
    """The card's time of one call of ``fn`` (``chip_ab.device_ms``: the
    profiler's kernel, copy and memset durations, launch gaps left out)."""
    import chip_ab
    return chip_ab.device_ms(torch, fn, iters)[0]


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOP_PER_S + int8_ops / PEAK_INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gather_k4_case(torch, params, ctx, Tg: int, gen, swiglu=False,
                   rank: int = 0, ep_world: int = 1, layer: int = 0):
    """K4's inputs at the gather path's slot layout for Tg tokens of layer
    ``layer``: one segment per expert, every row of a picked expert's
    segment valid.  With ``ep_world`` > 1 the layout is EP rank ``rank``'s
    on a world of that many: its ``E / ep_world`` experts over the ``Tg``
    tokens gathered from every rank, gated over all ``E``.  A swiglu
    model's layer brings its own gate projection; with ``swiglu`` on a
    gelu model (gpt3_medium_moe) a random one is added, to hold the
    kernel's swiglu branch too."""
    from repro_torch.core import gating
    from repro_torch.core.dispatch import routing, transport
    p = params["layers"][layer]["ffn"]
    d, E = ctx.arch.d_model, ctx.arch.moe.num_experts
    E_l = E // ep_world
    mine = slice(rank * E_l, (rank + 1) * E_l)
    x = torch.randn((Tg, d), generator=gen, device="cuda").to(torch.bfloat16)
    gate_out = gating.gate_forward(p["gate"], x, ctx.gate_cfg)
    tok, w, valid = routing.gather_slots(gate_out, rank, E_l)
    w_in, w_out = p["w_in"][mine].contiguous(), p["w_out"][mine].contiguous()
    w_gate, act = None, "gelu"
    if "w_gate" in p:
        w_gate, act = p["w_gate"][mine].contiguous(), "swiglu"
    elif swiglu:
        w_gate = (torch.randn(w_in.shape, generator=gen, device="cuda")
                  * d ** -0.5).to(torch.bfloat16)
        act = "swiglu"
    return (x, tok, w, transport.expert_segments(E_l, Tg), tuple(range(E_l)),
            valid, w_in, w_gate, w_out), act


def moe_rows(torch, params, ctx, tokens, layer: int):
    """The [B * S, d] rows that layer ``layer``'s MoE block receives on
    ``tokens`` [B, S]: the embedding, the sublayers before it, then its
    own mixer and ``norm2``, as ``transformer.forward_features`` runs
    them."""
    import dataclasses
    from repro_torch.models import layers, transformer
    subs = transformer.layer_list(ctx.arch)
    x = layers.embed_apply(params["embed"], tokens)
    zero = torch.zeros((), device=x.device)
    frac = torch.zeros((ctx.frac_levels,), device=x.device)
    for i in range(layer):
        x = transformer._apply_sublayer(params["layers"][i], x, subs[i], ctx,
                                        zero, frac, zero, layer_idx=i)[0]
    p = params["layers"][layer]
    x = transformer._apply_sublayer(p, x, dataclasses.replace(
        subs[layer], ffn=None), ctx, zero, frac, zero)[0]
    return layers.norm_apply(p["norm2"], x, ctx.arch.norm).reshape(
        -1, x.shape[-1])


def train1_k4_case(torch, params, arch, gen, layer: int = 0, x=None,
                   global_batch: int = TRAIN_BATCH_1):
    """K4's inputs at the one-rank training layout: a real ``route`` +
    ``build_indices`` of TRAIN_SEQ * ``global_batch`` (default
    TRAIN_BATCH_1: 2048) tokens through layer ``layer``'s gate on the
    one-rank plan (gpt3_medium_moe: caps (128,)), laid out by the
    engine's ``local_layout``: one segment an
    expert as wide as the capacity, partly filled, with sentinel slots
    past each expert's realized rows and the picks past the capacity
    dropped.  The rows are random unless ``x`` (``moe_rows`` of a training
    batch) is given.  A swiglu layer (DeepSeek's) brings its own gate
    projection."""
    from repro_torch.core.dispatch import engine as engine_lib
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.launch.mesh import unit_world
    from repro_torch.models import model as model_lib
    world = unit_world("cuda")
    ctx = model_lib.build_ctx(arch, None, seq_len=TRAIN_SEQ,
                              global_batch=global_batch, aux_mode="ta",
                              dispatch="a2a", device="cuda")
    T = TRAIN_SEQ * global_batch
    p = params["layers"][layer]["ffn"]
    if x is None:
        x = torch.randn((T, arch.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
    routed = routing.route(p, x, ctx.moe_cfg, ctx.ep, ctx.plan, ctx.gate_cfg,
                           world.coords)
    stages = transport.plan_stages(ctx.plan, ctx.ep)
    local = [(stage, sel) for (_, sel), stage in zip(routed.sels, stages)
             if stage.num_dests == 1]
    if len(local) != len(stages):
        raise SystemExit(f"train_1rank layout: {len(stages) - len(local)} "
                         f"of {len(stages)} stages are not local on one rank")
    li, offs, exps = engine_lib.local_layout(
        local, routed.gate_out["topk_idx"], T, p["w_in"].shape[0])
    w_gate = p.get("w_gate")
    return (x, li.slot_to_token, li.slot_w, offs, exps, li.rows_per_expert,
            p["w_in"], w_gate, p["w_out"]), ("gelu" if w_gate is None
                                             else "swiglu")


def check_k4(torch, args, act: str, label: str, timed=True):
    """K4 against its plain version on one layout's inputs (``args`` in
    ``local_moe``'s order), and bit-equal to itself over REPEATS_K4
    calls.  ``computed_rows`` is the rows the kernel's FFN
    launches compute (the compacted counts' sum), beside
    ``weighted_rows`` (the rows with a nonzero combine weight) and
    ``dense_rows`` (every row below the counts).  When timed, with kernel
    (events) and plain times, and for gelu ``chip_ab.fused_readings``
    (device, call and host times under grad, the bound), for swiglu (a
    DeepSeek layer) ``ffn_readings`` as serving calls it; the bound is
    ``k4_work``'s either way."""
    import chip_ab
    from repro_torch.kernels.moe_fused import ops as fused_ops
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    x, tok, w, offs, exps, valid = args[:6]
    Tg = x.shape[0]

    def kernel():
        return fused_ops.local_moe(*args, activation=act, use_pallas=True)

    def plain():
        return local_moe_ref(*args, activation=act)

    got = kernel()
    again = [kernel() for _ in range(REPEATS_K4 - 1)]
    torch.cuda.synchronize()
    if not all(torch.equal(got, a) for a in again):
        raise SystemExit(f"K4 {label}: {REPEATS_K4} calls on one input "
                         f"differ")
    del again
    want = plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K4_ATOL, K4_RTOL)
    if not ok:
        raise SystemExit(f"K4 {label}: kernel disagrees with plain "
                         f"(max abs err {err})")
    computed = int(fused_ops.compact_slots(tok, w, offs, valid,
                                           Tg)[1].sum())
    nbytes, flops, rows = k4_work(args)
    out = {"layout": label, "Tg": Tg, "activation": act,
           "slots": tok.numel(), "segments": len(exps),
           "computed_rows": computed, **rows, "max_abs_err": err,
           "atol": K4_ATOL, "rtol": K4_RTOL, "bit_equal_calls": REPEATS_K4}
    if not timed:
        return out
    iters = 50 if Tg <= 64 else 10
    if act == "gelu":
        out.update(chip_ab.fused_readings(
            torch, fused_ops, {"label": label, "args": args},
            chip_ab.kernel_names(REPO, "moe_fused"), time_ms, bound_ms,
            K4_ATOL, K4_RTOL))
    else:
        out.update(ffn_readings(torch, kernel, "moe_fused", nbytes, flops,
                                iters))
    out.update(ms=time_ms(torch, kernel, iters),
               plain_ms=time_ms(torch, plain, max(3, iters // 5)),
               library_ms=None)
    return out


def k4_work(args):
    """K4's ``(bytes, operations, rows)`` on one layout (``args`` in
    ``local_moe``'s order): the tokens, the slot maps and counts, the
    [T, d] f32 output and the weights of the experts that hold valid rows
    (two matrices, three with a gate projection), and the operations of
    the rows with a nonzero combine weight (the work the output needs);
    ``rows`` counts those, the rows below the counts (what a dense tiling
    computes) and the active experts.  For gelu the bound equals
    ``chip_ab.fused_bound``'s."""
    x, tok, w, offs, exps, valid, w_in, w_gate, _ = args
    T, d = x.shape
    f = w_in.shape[2]
    mats = 2 if w_gate is None else 3
    weighted = int((w != 0).sum())
    active = len({e for e, v in zip(exps, valid.tolist()) if v > 0})
    nbytes = (T * d * 2 + tok.numel() * 4 + w.numel() * 4 + len(exps) * 4
              + active * mats * d * f * 2 + T * d * 4)
    return nbytes, 2.0 * weighted * mats * d * f, {
        "weighted_rows": weighted, "dense_rows": int(valid.sum()),
        "active_experts": active}


def ffn_readings(torch, kernel, source: str, nbytes: float, flops: float,
                 iters: int, int8_ops: float = 0.0) -> dict:
    """``device_ms`` of one call of ``kernel`` (``chip_ab.device_ms``),
    ``kernel_device_ms`` of its hand-written launches in
    ``csrc/<source>.cu`` alone, and the bound of ``nbytes`` and
    ``flops`` (``int8_ops``)."""
    import chip_ab
    dev, by_key = chip_ab.device_ms(torch, kernel, iters)
    b_ms, b_by = bound_ms(nbytes, flops, int8_ops)
    return {"device_ms": dev,
            "kernel_device_ms": chip_ab.ours_ms(
                by_key, chip_ab.kernel_names(REPO, source)),
            "bound_ms": b_ms, "bound_by": b_by}


def k4_edge_case(torch, params, ctx, gen, swiglu=False):
    """The gather layout at Tg = 100 (not a multiple of 64) with three
    edges planted: a picked expert whose every combine weight is 0, a
    sentinel slot with a nonzero weight inside its segment's count, and a
    segment whose every slot carries a weight (100 live rows: two tiles)."""
    args, act = gather_k4_case(torch, params, ctx, 100, gen, swiglu)
    x, tok, w, offs, exps, valid, w_in, w_gate, w_out = args
    Tg = x.shape[0]
    tok, w, valid = tok.clone(), w.clone(), valid.clone()
    picked = [e for e, v in enumerate(valid.tolist()) if v > 0]
    if len(picked) < 3:
        raise SystemExit(f"K4 edges: {len(picked)} experts picked of "
                         f"{len(exps)}, 3 needed")
    zero_e, sent_e, full_e = picked[:3]
    w[offs[zero_e]:offs[zero_e + 1]] = 0
    tok[offs[sent_e] + 3] = Tg
    w[offs[sent_e] + 3] = 0.7
    w[offs[full_e]:offs[full_e + 1]] = 0.1 + 0.9 * torch.rand(
        Tg, generator=gen, device="cuda")
    return (x, tok, w, offs, exps, valid, w_in, w_gate, w_out), act


def check_compaction(torch, args, label: str):
    """K4's index launches alone, each bit-equal to its plain mirror on
    one layout: the compaction (``ops.compact_slots``) and the token index
    (``ops.token_rows``: the compaction, the scan, the fill and the
    combine's sort, each token's tile rows ascending)."""
    from repro_torch.kernels.moe_fused import ops as fused_ops
    from repro_torch.kernels.moe_fused import ref as fused_ref
    x, tok, w, offs, exps, valid = args[:6]
    T = x.shape[0]
    live, count = fused_ops.compact_slots(tok, w, offs, valid, T,
                                          use_pallas=True)
    want_live, want_count = fused_ref.compact_slots(tok, w, offs, valid, T)
    torch.cuda.synchronize()
    if not (torch.equal(live, want_live) and torch.equal(count, want_count)):
        bad = int((live != want_live).sum()) + int(
            (count != want_count).sum())
        raise SystemExit(f"compact_slots {label}: kernel differs from plain "
                         f"in {bad} entries")
    row_ptr, rows = fused_ops.token_rows(tok, w, offs, exps, valid, T,
                                         use_pallas=True)
    want_ptr, want_rows = fused_ref.token_rows(tok, w, offs, valid, T)
    if not (torch.equal(row_ptr, want_ptr) and torch.equal(rows, want_rows)):
        raise SystemExit(f"token_rows {label}: kernel differs from plain "
                         f"(row_ptr equal: "
                         f"{torch.equal(row_ptr, want_ptr)})")
    return {"layout": label, "slots": tok.numel(),
            "live_rows": int(count.sum()),
            "live_segments": int((count > 0).sum()),
            "token_index_rows": int(rows.numel()),
            "tokens_with_rows": int((row_ptr.diff() > 0).sum())}


def check_k5(torch, shape, gen, causal=True, window=0, timed=True,
             kv_heads=None):
    """K5 against its plain version on random bf16 q [B, S, H, hd] and k, v
    [B, S, kv_heads (default H), hd]; when timed, with kernel, plain, bound
    and ``scaled_dot_product_attention`` times (events), and the kernel's
    and SDPA's ``device_ms``."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    F = torch.nn.functional
    B, S, H, hd = shape
    kv_shape = (B, S, kv_heads or H, hd)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda")
               .to(torch.bfloat16) for sh in (shape, kv_shape, kv_shape))

    def kernel():
        return fa_ops.flash_attention(q, k, v, causal=causal,
                                      sliding_window=window, use_pallas=True)

    def plain():
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=window)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K5_ATOL, K5_RTOL)
    if not ok:
        raise SystemExit(f"K5 {shape} kv_heads={kv_heads} causal={causal} "
                         f"window={window}: kernel disagrees with plain "
                         f"(max abs err {err})")
    out = {"shape": list(shape), "kv_heads": kv_heads or H, "causal": causal,
           "window": window, "max_abs_err": err, "atol": K5_ATOL,
           "rtol": K5_RTOL}
    if not timed:
        return out
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    Kv = kv_shape[2]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=Kv != H)

    pairs = S * (S + 1) // 2 if causal else S * S
    # q and o [B, S, H, hd], k and v [B, S, Kv, hd], bf16, once each
    nbytes = 2 * B * S * (H + Kv) * hd * 2
    flops = 2 * 2 * B * H * hd * pairs
    b_ms, b_by = bound_ms(nbytes, flops)
    out.update(ms=time_ms(torch, kernel, 100),
               device_ms=dev_ms(torch, kernel, 100),
               plain_ms=time_ms(torch, plain, 20),
               library_ms=time_ms(torch, library, 100),
               library_device_ms=dev_ms(torch, library, 100),
               bound_ms=b_ms, bound_by=b_by)
    return out


def staged_case(torch, params, arch, gen, slowdowns=None, sizes=WORLD_22,
                global_batch=TRAIN_BATCH_22, layer: int = 0):
    """Rank (0, 0)'s view of the 2x2 training phase's plan: a real
    ``route`` + ``build_indices`` of 1024 random tokens through layer 0's
    gate, the 2x2 EP spec and its Eq. (7) plan (caps (120, 16)).  The
    rank's send buffer, read back through an identity exchange, stands in
    for the receive buffer of the ragged grouped FFN (K3).  With
    ``slowdowns`` (per-axis link slowdowns) the plan is the one
    ``RecoveryPolicy.replan`` gives under ``REPLAN_RESILIENCE``: the
    train_2x2_replan phase's layout after its replan (caps (128, 0): the
    empty second stage is dropped).  ``sizes`` and ``global_batch`` name
    another world's: (2, 2, 2) and 8 give rank (0, 0, 0)'s view of
    train_2x2x2 (512 tokens, three stages, 8 experts a rank).  ``layer``
    names another layer's gate and weights (a DeepSeek model's first MoE
    layer is 1); ``w_gate`` is the rank's gate projection, None for a gelu
    model."""
    from repro_torch.core.capacity import default_axis_names
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.kernels.moe_permute.ref import permute_ref
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model as model_lib
    from repro_torch.resilience import ResilienceConfig
    from repro_torch.resilience.policy import RecoveryPolicy
    world = EPWorld(axis_names=default_axis_names(len(sizes)),
                    axis_sizes=tuple(sizes), coords=(0,) * len(sizes),
                    device="cuda")
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=global_batch, aux_mode="ta",
                              device="cuda")
    if slowdowns is not None:
        ctx = RecoveryPolicy(ResilienceConfig(**REPLAN_RESILIENCE)).replan(
            ctx, slowdowns)
    T = TRAIN_SEQ * global_batch // world.size
    d = arch.d_model
    p = params["layers"][layer]["ffn"]
    x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
    routed = routing.route(p, x, ctx.moe_cfg, ctx.ep, ctx.plan, ctx.gate_cfg,
                           world.coords)
    di = routing.build_indices(routed.sels, routed.gate_out["topk_idx"], T)
    stages = transport.plan_stages(ctx.plan, ctx.ep)
    flat = permute_ref(x, di.slot_to_token)

    def ident(t, axis, dim):
        return t

    parts, cnts = [], []
    for stage, (_, off, shape), (_, coff, cshape) in zip(
            stages, di.stage_spans(), di.expert_spans()):
        n = math.prod(shape)
        parts.append(transport.dispatch_chain(
            flat[off:off + n].reshape(shape + (d,)), stage, ident))
        cnts.append(transport.counts_chain(
            di.rows_per_expert[coff:coff + math.prod(cshape)].reshape(cshape),
            stage, ident))
    E_l = ctx.plan.experts_per_rank
    segs, exps = transport.stage_segments(
        E_l, tuple((s.num_dests, shape[-1])
                   for s, (_, _, shape) in zip(stages, di.stage_spans())))
    return {"x": x, "di": di, "caps": ctx.plan.caps,
            "xin": torch.cat(parts, dim=1).reshape(-1, d).contiguous(),
            "rows_valid": torch.cat(cnts, dim=1).reshape(-1).contiguous(),
            "segs": segs, "exps": exps,
            "w_in": p["w_in"][:E_l].contiguous(),
            "w_gate": (p["w_gate"][:E_l].contiguous() if "w_gate" in p
                       else None),
            "w_out": p["w_out"][:E_l].contiguous()}


def check_k1(torch, x, tok, full: bool = True):
    """K1 permute at one layout of a world's rank 0 (``x`` [T, d],
    ``slot_to_token`` ``tok`` [S]): a row copy, so the kernel must equal
    the plain version bit for bit.  ``ms`` times 200 calls under no_grad;
    ``chip_ab.permute_readings`` adds ``device_ms``, ``call_ms`` and
    ``host_us`` for the kernel and ``index_select`` alike, and the bound.
    Without ``full``, the kernel's ``device_ms`` alone beside the bound,
    and no library reading."""
    import chip_ab
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import permute_ref
    out = chip_ab.permute_readings(torch, p_ops, x, tok, time_ms, bound_ms,
                                   full=full)
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    idx = tok.long()
    out.update(
        max_abs_err=0.0, atol=0.0,
        ms=time_ms(torch, lambda: p_ops.permute(x, tok, use_pallas=True),
                   200),
        plain_ms=time_ms(torch, lambda: permute_ref(x, tok), 50),
        library_ms=time_ms(torch, lambda: x_pad.index_select(0, idx), 200)
        if full else None)
    return out


def check_k2(torch, y, di, full: bool = True):
    """K2 unpermute at one layout of a world's rank 0, on bf16 slot rows
    ``y`` [S, d]: within K2_ATOL + K2_RTOL·|plain| of the plain version.
    ``ms`` times 200 calls under no_grad; ``library_ms`` ``embedding_bag``
    over an f32 table with the zero row the sentinel S reads (f32, so it
    matches K2's f32 output; built outside the timed region);
    ``chip_ab.unpermute_readings`` adds ``device_ms``, ``call_ms`` and
    ``host_us`` for both, and the bound.  Without ``full``, the kernel's
    ``device_ms`` alone beside the bound, and no library reading."""
    import chip_ab
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import unpermute_ref
    out = chip_ab.unpermute_readings(torch, p_ops, y, di.inv_idx, di.inv_w,
                                     time_ms, bound_ms, K2_ATOL, K2_RTOL,
                                     full=full)
    y_pad = torch.cat([y, y.new_zeros((1, y.shape[1]))]).float()
    inv_idx = di.inv_idx.long()
    out.update(
        ms=time_ms(torch, lambda: p_ops.unpermute(y, di.inv_idx, di.inv_w,
                                                  use_pallas=True), 200),
        plain_ms=time_ms(torch, lambda: unpermute_ref(y, di.inv_idx,
                                                      di.inv_w), 50),
        library_ms=time_ms(torch, lambda: torch.nn.functional.embedding_bag(
            inv_idx, y_pad, per_sample_weights=di.inv_w, mode="sum"), 200)
        if full else None)
    if full:
        out["library_call"] = "embedding_bag, f32 table"
    return out


def permute_edges(torch, gen):
    """K1 against its plain version, bit for bit, where the main layouts do
    not reach: other element types, the narrowest row (16 bytes), a wide
    one (48 KB: many passes a warp), a row that leaves the last pass
    partly empty, S = 0, no token row (T = 0), every slot a sentinel, an
    odd S, and a large one; an x the 16-byte copies cannot take must be
    refused."""
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import permute_ref
    bf = torch.bfloat16
    cases = [("f32", 1024, 1024, 4864, torch.float32),
             ("fp16", 1024, 1024, 4864, torch.float16),
             ("d=8 bf16", 1024, 8, 4864, bf),
             ("S=0", 1024, 1024, 0, bf),
             ("T=0", 0, 1024, 300, bf),
             ("all sentinel", 1024, 1024, 4864, bf),
             ("S=4877", 1024, 1024, 4877, bf),
             ("S=20011", 1024, 1024, 20011, bf),
             ("d=1000 bf16", 1024, 1000, 4864, bf),
             ("48 KB rows", 64, 12288, 300, torch.float32)]
    out = []
    for label, T, d, S, dtype in cases:
        x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
        hi = 1 if label == "all sentinel" else T + 1
        tok = torch.randint(0, hi, (S,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if label == "all sentinel":
            tok += T
        got = p_ops.permute(x, tok, use_pallas=True)
        want = permute_ref(x, tok)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K1 {label}: kernel disagrees with plain")
        out.append({"case": label, "T": T, "d": d, "S": S,
                    "dtype": str(dtype), "max_abs_err": 0.0})
    flat = torch.zeros(64 * 1024 + 1, device="cuda", dtype=bf)
    for label, x in (("x not 16-byte aligned", flat[1:].view(64, 1024)),
                     ("rows of 12 bytes",
                      torch.zeros((64, 3), device="cuda"))):
        try:
            p_ops.permute(x, torch.zeros(8, device="cuda",
                                         dtype=torch.int32), use_pallas=True)
        except ValueError as e:
            out.append({"case": label, "refused": str(e)})
        else:
            raise SystemExit(f"K1 {label}: the wrapper did not refuse it")
    return out


def unpermute_edges(torch, gen):
    """K2 against its plain version (K2_ATOL + K2_RTOL·|plain|) where the
    main layouts do not reach: K = 1 and K = 4 and 40 (the any-K
    instance, 40 over two rounds of the warp's shuffle), f32 rows, a row
    width that leaves the last pass partly empty, tokens whose picks are
    all dropped (exact zeros, also where a dropped pick keeps a weight),
    and a T that the blocks' four tokens do not divide."""
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import unpermute_ref
    cases = [("K=1", 1024, 4864, 1024, 1, torch.bfloat16),
             ("K=4", 1024, 4864, 1024, 4, torch.bfloat16),
             ("K=40", 256, 4864, 1024, 40, torch.bfloat16),
             ("f32 y", 1024, 4864, 1024, 2, torch.float32),
             ("f32 y, K=4", 1024, 4864, 1024, 4, torch.float32),
             ("d=1000", 1024, 4864, 1000, 2, torch.bfloat16),
             ("all dropped", 1024, 4864, 1024, 2, torch.bfloat16),
             ("T=1023", 1023, 4864, 1024, 2, torch.bfloat16)]
    out = []
    for label, T, S, d, K, dtype in cases:
        y = torch.randn((S, d), generator=gen, device="cuda").to(dtype)
        inv_idx = torch.randint(0, S + 1, (T, K), generator=gen,
                                device="cuda", dtype=torch.int32)
        inv_w = torch.rand((T, K), generator=gen, device="cuda")
        if label == "all dropped":
            inv_idx[T // 2:] = S          # half the tokens drop every pick;
            inv_w[T // 2::2] = 0.0        # every other one keeps its weights
        else:
            inv_w = torch.where(inv_idx < S, inv_w, 0.0)
        got = p_ops.unpermute(y, inv_idx, inv_w, use_pallas=True)
        want = unpermute_ref(y, inv_idx, inv_w)
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K2_ATOL, K2_RTOL)
        dead = (inv_idx >= S).all(dim=1)
        if not ok or not bool((got[dead] == 0).all()):
            raise SystemExit(f"K2 {label}: kernel disagrees with plain "
                             f"(max abs err {err})")
        out.append({"case": label, "T": T, "S": S, "d": d, "K": K,
                    "dtype": str(dtype), "dropped_tokens": int(dead.sum()),
                    "max_abs_err": err})
    return out


def check_k3(torch, case):
    """K3 ragged grouped FFN on a staged receive layout (the 2x2 phase's:
    16 experts, 96 segments of width 120 or 16, tanh-gelu), with the
    activation the case's layer has: swiglu where it carries a gate
    projection (a DeepSeek layer).  Gelu is read by
    ``chip_ab.ragged_readings`` (device, call and host times under grad,
    ``kernel_device_ms`` its launch pair alone, the bound); swiglu is held
    here, rows past each segment's count exact zeros, and read by
    ``ffn_readings`` (the bound with the gate's weights and products)."""
    import chip_ab
    from repro_torch.kernels.moe_fused.ops import plan_expert_tiles
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    w_in, w_gate, w_out = case["w_in"], case["w_gate"], case["w_out"]
    act = "gelu" if w_gate is None else "swiglu"

    def kernel():
        return g_ops.grouped_ffn_ragged(xin, segs, exps, valid, w_in, w_gate,
                                        w_out, activation=act,
                                        use_pallas=True)

    def plain():
        return grouped_ffn_ragged_ref(xin, segs, exps, valid, w_in, w_gate,
                                      w_out, activation=act)

    active = len({e for e, v in zip(exps, valid.tolist()) if v > 0})
    if w_gate is None:
        r = chip_ab.ragged_readings(torch, g_ops, case,
                                    chip_ab.kernel_names(REPO, "moe_gemm"),
                                    time_ms, bound_ms, K3_ATOL, K3_RTOL)
    else:
        R, d = xin.shape
        f = w_in.shape[2]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K3_ATOL, K3_RTOL)
        zeros_exact = bool((got[dead_rows(torch, segs, valid, R)]
                            == 0).all())
        if not ok or not zeros_exact:
            raise SystemExit(f"K3 {act} at R={R}: kernel disagrees with "
                             f"plain (max abs err {err}, rows past nvalid "
                             f"zero: {zeros_exact})")
        nvalid = int(valid.sum())
        r = {"R": R, "valid_rows": nvalid, "max_abs_err": err,
             **ffn_readings(torch, kernel, "moe_gemm",
                            nvalid * d * 2 + active * 3 * d * f * 2
                            + R * d * 2 + valid.numel() * 4,
                            2.0 * nvalid * 3 * d * f, 20)}
    widths = {b - a for a, b in zip(segs[:-1], segs[1:])}
    return {**r, "segments": len(exps), "experts": w_in.shape[0],
            "activation": act, "segment_widths": sorted(widths),
            "active_experts": active,
            "tiles": len(plan_expert_tiles(tuple(segs), tuple(exps))),
            "atol": K3_ATOL, "rtol": K3_RTOL,
            "ms": time_ms(torch, kernel, 20),
            "plain_ms": time_ms(torch, plain, 5), "library_ms": None}


def k3_edges(torch, case, gen):
    """K3 against its plain version on a ragged layout of the rank's 16
    experts: stages (2, 45) and (4, 7), so each expert's span is 118 rows
    (two tiles, the second crossing segments) and R = 1888 is not a
    multiple of 64; random counts, and a zero-count segment inside expert
    0's span (its second); gelu and swiglu."""
    from repro_torch.core.dispatch import transport
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    w_in, w_out = case["w_in"], case["w_out"]
    E_l, d, f = w_in.shape
    segs, exps = transport.stage_segments(E_l, ((2, 45), (4, 7)))
    if not exps[0] == exps[1] == exps[2]:
        raise SystemExit(f"K3 edges: segment 1 is not inside expert "
                         f"{exps[0]}'s span")
    R = segs[-1]
    widths = torch.as_tensor(segs[1:], device="cuda") - torch.as_tensor(
        segs[:-1], device="cuda")
    valid = (torch.rand(len(exps), generator=gen, device="cuda")
             * (widths + 1)).to(torch.int32)
    valid[1] = 0
    valid[0] = widths[0]
    xin = torch.randn((R, d), generator=gen, device="cuda").to(torch.bfloat16)
    w_gate = (torch.randn(w_in.shape, generator=gen, device="cuda")
              * d ** -0.5).to(torch.bfloat16)
    dead = dead_rows(torch, segs, valid, R)
    out = []
    for act, wg in (("gelu", None), ("swiglu", w_gate)):
        got = g_ops.grouped_ffn_ragged(xin, segs, exps, valid, w_in, wg,
                                       w_out, activation=act,
                                       use_pallas=True)
        want = grouped_ffn_ragged_ref(xin, segs, exps, valid, w_in, wg,
                                      w_out, activation=act)
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K3_ATOL, K3_RTOL)
        zeros_exact = bool((got[dead] == 0).all())
        if not ok or not zeros_exact:
            raise SystemExit(f"K3 edges, {act}: kernel disagrees with plain "
                             f"(max abs err {err}, rows past nvalid zero: "
                             f"{zeros_exact})")
        out.append({"R": R, "segments": len(exps), "activation": act,
                    "valid_rows": int(valid.sum()), "max_abs_err": err})
    return out


def layout_checks(torch, case, gen):
    """K1, K2 and K3 against their plain versions at one ``staged_case``
    layout (train_2x2_replan's after its replan: the pod axis 64x slower,
    caps (128, 0), so ``plan_stages`` keeps one stage and every slot of a
    rank's send buffer stays in its pod; train_2x2x2's: three stages): K1
    bit-equal, K2 within K2_ATOL + K2_RTOL·|plain| on random bf16 slot
    rows, K3 within K3_ATOL + K3_RTOL·|plain| on the receive buffer, with
    every row past a segment's valid count exactly 0."""
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import permute_ref, unpermute_ref
    x, di = case["x"], case["di"]
    tok = di.slot_to_token
    k1 = p_ops.permute(x, tok, use_pallas=True)
    k1_ok = torch.equal(k1, permute_ref(x, tok))
    y = torch.randn((di.num_slots, x.shape[1]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k2_ok, k2_err = close(
        torch, p_ops.unpermute(y, di.inv_idx, di.inv_w, use_pallas=True),
        unpermute_ref(y, di.inv_idx, di.inv_w), K2_ATOL, K2_RTOL)
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    got = g_ops.grouped_ffn_ragged(xin, segs, exps, valid, case["w_in"],
                                   None, case["w_out"], activation="gelu",
                                   use_pallas=True)
    want = grouped_ffn_ragged_ref(xin, segs, exps, valid, case["w_in"], None,
                                  case["w_out"], activation="gelu")
    torch.cuda.synchronize()
    k3_ok, k3_err = close(torch, got, want, K3_ATOL, K3_RTOL)
    zeros_exact = bool((got[dead_rows(torch, segs, valid, xin.shape[0])]
                        == 0).all())
    if not (k1_ok and k2_ok and k3_ok and zeros_exact):
        raise SystemExit(f"caps {case['caps']}: K1 bit-equal {k1_ok}, K2 "
                         f"max abs err {k2_err}, K3 max abs err {k3_err}, "
                         f"K3 rows past nvalid zero {zeros_exact}")
    return {"caps": list(case["caps"]), "S": di.num_slots,
            "sentinel_slots": int((tok >= x.shape[0]).sum()),
            "R": xin.shape[0], "segments": len(exps),
            "valid_rows": int(valid.sum()),
            "K1_max_abs_err": 0.0, "K2_max_abs_err": k2_err,
            "K3_max_abs_err": k3_err, "K2_atol": K2_ATOL,
            "K2_rtol": K2_RTOL, "K3_atol": K3_ATOL, "K3_rtol": K3_RTOL}


def pipelined_case(torch, params, arch, gen, layer: int = 0,
                   chunks=PIPELINED_CHUNKS, sizes=WORLD_22,
                   global_batch=TRAIN_BATCH_22):
    """Rank (0, 0)'s view of chunk 0 of the train_2x2_pipelined phase: a
    real ``route`` + ``build_indices`` of 1024 random tokens through layer
    0's gate on the 2x2 EP spec and the int8 wire's chunk-aligned plan
    (caps (120, 16), 8 chunks: 15 and 2 slots of the two stages a chunk),
    the payload int8-encoded and decoded and the valid-row counts moved
    through the transport's chains, as the engine does.  An identity
    exchange stands in for the all-to-alls: the rank's send buffer is the
    receive buffer of the int8 ragged grouped FFN (K7).  ``layer`` as
    ``staged_case``'s; ``chunks`` None takes the overlap model's count
    whatever it is; ``sizes`` and ``global_batch`` name another world's
    plan, at its rank 0."""
    import types
    from repro_torch.core.capacity import default_axis_names
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.kernels.moe_permute.ref import permute_ref
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model as model_lib
    world = EPWorld(axis_names=default_axis_names(len(sizes)),
                    axis_sizes=tuple(sizes), coords=(0,) * len(sizes),
                    device="cuda")
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=global_batch, aux_mode="ta",
                              dispatch="a2a_pipelined", wire_codec="int8",
                              device="cuda")
    k = ctx.a2a_num_chunks
    if chunks is not None and k != chunks:
        raise SystemExit(f"pipelined plan: {k} chunks, expected {chunks}")
    T = TRAIN_SEQ * global_batch // world.size
    d = arch.d_model
    p = params["layers"][layer]["ffn"]
    x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
    routed = routing.route(p, x, ctx.moe_cfg, ctx.ep, ctx.plan, ctx.gate_cfg,
                           world.coords)
    stages = transport.plan_stages(ctx.plan, ctx.ep)
    work = []
    for (s, sel), stage in zip(routed.sels, stages):
        sel = routing.pad_selection(sel, axis=s + 2, multiple=k)
        cpc = sel.idx.shape[s + 2] // k
        work.append((stage, routing.slice_selection(sel, s + 2, 0, cpc), cpc))
    di = routing.build_indices(tuple((st.index, sel) for st, sel, _ in work),
                               routed.gate_out["topk_idx"], T)
    tr = transport.A2ATransport(
        ep=ctx.ep, world=types.SimpleNamespace(
            all_to_all=lambda t, axis, dim: t), codec=ctx.wire_codec)
    flat = permute_ref(x, di.slot_to_token)
    parts, cnts = [], []
    for (stage, _, _), (_, off, shape), (_, coff, cshape) in zip(
            work, di.stage_spans(), di.expert_spans()):
        parts.append(tr.dispatch(
            flat[off:off + math.prod(shape)].reshape(shape + (d,)), stage))
        cnts.append(tr.dispatch_counts(
            di.rows_per_expert[coff:coff + math.prod(cshape)].reshape(cshape),
            stage))
    E_l = ctx.plan.experts_per_rank
    segs, exps = transport.stage_segments(
        E_l, tuple((stage.num_dests, cpc) for stage, _, cpc in work))
    return {"x": x, "di": di, "caps": ctx.plan.caps, "chunks": k,
            "chunk_caps": [cpc for _, _, cpc in work],
            "xin": torch.cat(parts, dim=1).reshape(-1, d).contiguous(),
            "rows_valid": torch.cat(cnts, dim=1).reshape(-1).contiguous(),
            "segs": segs, "exps": exps,
            "w_in": p["w_in"][:E_l].contiguous(),
            "w_gate": (p["w_gate"][:E_l].contiguous() if "w_gate" in p
                       else None),
            "w_out": p["w_out"][:E_l].contiguous()}


def dead_rows(torch, segs, valid, R):
    """[R] bool: the rows at or past their segment's valid count."""
    offs = torch.as_tensor(segs, device="cuda")
    rows = torch.arange(R, device="cuda")
    seg_of = torch.searchsorted(offs[1:], rows, right=True)
    return (rows - offs[seg_of]) >= valid[seg_of].long()


def check_k7(torch, case):
    """K7 on one layout of the pipelined int8 plan's rank (0, 0) (chunk 0,
    S = 608, or the whole staged buffer, S = 4864, whose expert spans of
    304 rows cross 64-row tiles) against its plain version on the same
    segments (so the same per-segment and per-expert scales): called as
    the dispatch engine calls it, with the weights quantized once
    (``quantize_expert_weights``), and with them quantized in the call;
    rows past each segment's count must be exact zeros.  The activation
    is the case's layer's: swiglu where it carries a gate projection (a
    DeepSeek layer), whose weights are quantized beside ``w_in``.  With
    kernel (events and ``device_ms``; ``kernel_device_ms`` the launch pair
    alone), plain and bound times, and the times of the quantizations:
    ``quantize_ms`` (x, each call) and ``weights_quantize_ms`` (the
    weights, once a layer forward)."""
    import chip_ab
    from repro_torch.kernels.moe_fused.ops import plan_expert_tiles
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                                  quantize_segments)
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    w_in, w_gate, w_out = case["w_in"], case["w_gate"], case["w_out"]
    act = "gelu" if w_gate is None else "swiglu"
    qw = g_ops.quantize_expert_weights(w_in, w_gate)

    def kernel(qweights=qw):
        return g_ops.grouped_ffn_ragged_quant(xin, segs, exps, valid, w_in,
                                              w_gate, w_out, activation=act,
                                              use_pallas=True,
                                              qweights=qweights)

    def plain():
        return grouped_ffn_ragged_quant_ref(xin, segs, exps, valid, w_in,
                                            w_gate, w_out, activation=act)

    R, d = xin.shape
    f = w_in.shape[2]
    want = plain()
    dead = dead_rows(torch, segs, valid, R)
    errs = []
    for label, got in (("weights quantized once", kernel()),
                       ("weights quantized in the call", kernel(None))):
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K7_ATOL, K7_RTOL)
        zeros_exact = bool((got[dead] == 0).all())
        if not ok or not zeros_exact:
            raise SystemExit(f"K7 at S={R}, {label}: kernel disagrees with "
                             f"plain (max abs err {err}, rows past nvalid "
                             f"zero: {zeros_exact})")
        errs.append(err)
    nvalid = int(valid.sum())
    per_expert = torch.zeros(w_in.shape[0], device="cuda").index_add_(
        0, torch.as_tensor(exps, device="cuda"), valid.float())
    active = int((per_expert > 0).sum())
    # int8 valid rows, the int8 up-projections (w_in, and w_gate for
    # swiglu) and bf16 w_out of the experts used, the bf16 [R, d] output;
    # 2df int8 operations a valid row for each up-projection and 2fd bf16
    ups = 1 if w_gate is None else 2
    nbytes = nvalid * d + active * (ups * d * f + f * d * 2) + R * d * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * nvalid * f * d,
                          int8_ops=2.0 * nvalid * ups * d * f)
    widths = {offs1 - offs0 for offs0, offs1 in zip(segs[:-1], segs[1:])}
    call_dev, by_key = chip_ab.device_ms(torch, kernel, 20)
    return {"R": R, "segments": len(exps), "experts": w_in.shape[0],
            "caps": list(case["caps"]), "chunks": case.get("chunks", 1),
            "chunk_caps": case.get("chunk_caps"),
            "segment_widths": sorted(widths), "valid_rows": nvalid,
            "active_experts": active, "activation": act,
            "tiles": len(plan_expert_tiles(tuple(segs), tuple(exps))),
            "max_abs_err": max(errs), "atol": K7_ATOL, "rtol": K7_RTOL,
            "ms": time_ms(torch, kernel, 20), "device_ms": call_dev,
            "kernel_device_ms": chip_ab.ours_ms(
                by_key, chip_ab.kernel_names(REPO, "moe_gemm")),
            "quantize_ms": time_ms(
                torch, lambda: quantize_segments(xin, segs), 20),
            "weights_quantize_ms": time_ms(
                torch, lambda: g_ops.quantize_expert_weights(w_in, w_gate),
                20),
            "weights_quantize_device_ms": dev_ms(
                torch, lambda: g_ops.quantize_expert_weights(w_in, w_gate),
                20),
            "plain_ms": time_ms(torch, plain, 5), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


def einsum_k6_case(torch, params, arch, gen):
    """K6's input at the einsum phase's shape: the [64, 128, 1024] bf16
    capacity buffer of 2048 random tokens routed top-2 through layer 0's
    gate (capacity 128 by the capacity-factor rule), with each expert's
    rows past its count (capped at the capacity) zero, as the one-hot
    dispatch leaves them; layer 0's w_in and w_out.  The occupancy is
    these random tokens' (about half the rows), not the phase's, whose
    batches drop more picks; K6 computes every row of the buffer either
    way, so its time does not depend on it."""
    from repro_torch.core import gating
    from repro_torch.models import model as model_lib
    ctx = model_lib.build_ctx(arch, None, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_1, aux_mode="lb",
                              dispatch="einsum", use_moe_kernel=True,
                              device="cuda")
    moe = ctx.moe_cfg
    T = TRAIN_SEQ * TRAIN_BATCH_1
    E, d = moe.num_experts, moe.d_model
    C = int(T * moe.top_k * moe.capacity_factor / E)
    p = params["layers"][0]["ffn"]
    tokens = torch.randn((T, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
    gate_out = gating.gate_forward(p["gate"], tokens, ctx.gate_cfg)
    counts = torch.bincount(gate_out["topk_idx"].reshape(-1).long(),
                            minlength=E).clamp(max=C)
    x = torch.randn((E, C, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    x[torch.arange(C, device="cuda")[None, :] >= counts[:, None]] = 0
    return x, p["w_in"], p["w_out"], int(counts.sum())


def k6_zero_past_counts(torch, gen, E: int, C: int, d: int):
    """A random [E, C, d] bf16 buffer whose rows past each expert's count
    are zero, as the one-hot dispatch leaves them; the counts include 0,
    C, and one live row in the last 64-row tile."""
    counts = torch.randint(0, C + 1, (E,), generator=gen, device="cuda")
    counts[:3] = torch.tensor([0, C, (C - 1) // 64 * 64 + 1])
    x = torch.randn((E, C, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    x[torch.arange(C, device="cuda")[None, :] >= counts[:, None]] = 0
    return x


def check_k6(torch, x, w_in, w_gate, w_out, label: str, filled=None,
             timed=True):
    """K6 (``grouped_ffn``, which launches the kernel for CUDA tensors)
    against its plain version, and every all-zero row of ``x`` to an exact
    zero row (gelu(0) = silu(0) * 0 = 0); when timed, with kernel, plain
    and bound times and the cuBLAS chain bmm -> gelu -> bmm on the same
    inputs."""
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ref
    F = torch.nn.functional
    act = "gelu" if w_gate is None else "swiglu"
    E, C, d = x.shape
    f = w_in.shape[2]

    def kernel():
        return g_ops.grouped_ffn(x, w_in, w_gate, w_out, activation=act)

    def plain():
        return grouped_ffn_ref(x, w_in, w_gate, w_out, activation=act)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K6_ATOL, K6_RTOL)
    zero = (x == 0).all(-1)
    if not ok or not bool((got[zero] == 0).all()):
        raise SystemExit(f"K6 {label}: kernel disagrees with plain (max abs "
                         f"err {err}) or a zero row is not zero")
    out = {"layout": label, "shape": [E, C, d], "f": f, "activation": act,
           "max_abs_err": err, "atol": K6_ATOL, "rtol": K6_RTOL,
           "zero_rows": int(zero.sum())}
    if not timed:
        return out

    def bmm_chain():
        return torch.bmm(F.gelu(torch.bmm(x, w_in), approximate="tanh"),
                         w_out)

    _, chain_err = close(torch, bmm_chain(), want, K6_ATOL, K6_RTOL)
    filled = E * C if filled is None else filled
    n_w = 3 if w_gate is not None else 2
    nbytes = 2 * E * C * d * 2 + n_w * E * d * f * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * filled * n_w * d * f)
    out.update(filled_rows=filled, ms=time_ms(torch, kernel, 20),
               device_ms=dev_ms(torch, kernel, 20),
               plain_ms=time_ms(torch, plain, 5), library_ms=None,
               bmm_chain_ms=time_ms(torch, bmm_chain, 20),
               bmm_chain_device_ms=dev_ms(torch, bmm_chain, 20),
               bmm_chain_max_abs_err=chain_err, bound_ms=b_ms, bound_by=b_by)
    return out


def check_k6_edges(torch, x, w_in, w_out, gen):
    """K6 at the edges of its tiling, untimed, on the einsum case's buffer
    ``x`` [E, C, d] and weights: swiglu (a random gate projection), C = 1,
    64, 65 and 100 (the buffer's first rows), C = 200 (a last tile of 8
    rows), E = 1, and a C = 200 swiglu buffer zero past random counts."""
    E, _, d = x.shape
    w_gate = (torch.randn(w_in.shape, generator=gen, device="cuda")
              * d ** -0.5).to(torch.bfloat16)
    out = [check_k6(torch, x, w_in, w_gate, w_out, "swiglu", timed=False)]
    for c in (1, 64, 65, 100):
        out.append(check_k6(torch, x[:, :c].contiguous(), w_in, None, w_out,
                            f"C={c}", timed=False))
    return out + [
        check_k6(torch, torch.randn((E, 200, d), generator=gen,
                                    device="cuda").to(torch.bfloat16),
                 w_in, None, w_out, "C=200", timed=False),
        check_k6(torch, x[:1], w_in[:1], None, w_out[:1], "E=1",
                 timed=False),
        check_k6(torch, k6_zero_past_counts(torch, gen, E, 200, d), w_in,
                 w_gate, w_out, "C=200 swiglu, zero past counts",
                 timed=False)]


def check_k8(torch, gen, B: int, L: int, H: int, K: int, lengths=None,
             window: int = 0, timed=False, hd: int = 64):
    """K8 (``decode_attention``) against its plain version on a bf16 cache
    of head dim ``hd``
    with NaN in every k/v row past its request's length, compared on the
    requests with a valid row; the requests with none must come out as
    exact zeros.  ``lengths`` None draws them in [1, L] with one at L and
    one at 1.  When timed, with plain, bound and SDPA times (SDPA on a copy
    of the cache with the NaN rows zeroed, checked first)."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.decode_attn import ops as d_ops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    F = torch.nn.functional
    if lengths is None:
        lengths = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
        lengths[0], lengths[1] = L, 1
    lens = torch.as_tensor(lengths, device="cuda").to(torch.int32)
    q = torch.randn((B, H, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, L, K, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(L, device="cuda")
    past = pos[None, :] >= lens[:, None].long()              # [B, L]
    k[past], v[past] = float("nan"), float("nan")
    launches0 = backend.LAUNCHES[d_ops.KERNEL]

    def kernel():
        return d_ops.decode_attention(q, k, v, lens, sliding_window=window)

    def plain():
        return decode_attention_ref(q, k, v, lens, sliding_window=window)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    live = lens > 0
    ok, err = close(torch, got[live], want[live], K8_ATOL, K8_RTOL)
    need = atol_needed(torch, got[live], want[live], K8_RTOL)
    zeros_exact = bool((got[~live] == 0).all())
    if not ok or not zeros_exact:
        raise SystemExit(f"K8 B={B} L={L} H={H} K={K} window={window}: "
                         f"kernel disagrees with plain (max abs err {err}, "
                         f"atol needed {need} > {K8_ATOL}, length-0 "
                         f"requests zero: {zeros_exact})")
    valid = ~past
    if window:
        valid &= pos[None, :] >= lens[:, None].long() - window
    rows = int(valid.sum())
    out = {"B": B, "L": L, "H": H, "K": K, "hd": hd, "window": window,
           "zero_length_requests": int((~live).sum()), "valid_rows": rows,
           "max_abs_err": err, "atol_needed": need, "atol": K8_ATOL,
           "rtol": K8_RTOL}
    if timed:
        keep = valid[:, :, None, None]
        kc, vc = (torch.where(keep, t, 0).transpose(1, 2) for t in (k, v))
        mask = valid[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask,
                enable_gqa=K != H)[:, :, 0]

        lib_ok, lib_err = close(torch, library()[live], want[live],
                                K8_LIB_ATOL, K8_LIB_RTOL)
        if not lib_ok:
            raise SystemExit(f"K8: the library call scaled_dot_product_"
                             f"attention disagrees with plain (max abs err "
                             f"{lib_err})")
        # the valid rows' k and v, q, the lengths and the output once; two
        # products of hd a valid row and query head
        nbytes = rows * K * hd * 2 * 2 + 2 * B * H * hd * 2 + B * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * rows * (H // K) * K * hd)
        out.update(ms=time_ms(torch, kernel, 20),
                   device_ms=dev_ms(torch, kernel, 20),
                   plain_ms=time_ms(torch, plain, 3),
                   library_ms=time_ms(torch, library, 10),
                   library_device_ms=dev_ms(torch, library, 10),
                   library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by)
        del kc, vc
    out["launches"] = backend.LAUNCHES[d_ops.KERNEL] - launches0
    return out


def backward_checks(torch, gen, layouts):
    """Each kernel's ``autograd.Function`` on the card against autograd of
    its plain version, at a small shape: K1 and K2 in float32 (their
    backwards are written by hand; also at each of ``layouts``, ``{label:
    (T, di)}`` at full width: "2x2", the 2x2 world's rank 0, a real route
    with about two thirds of the slots sentinels and a quarter of the
    picks dropped; "replan", the same rank's layout after
    train_2x2_replan's replan, caps (128, 0); "2x2x2", rank (0, 0, 0)'s of
    train_2x2x2, three stages), K3, K4,
    K6 and K7 on bf16 inputs (their
    kernels take bf16 only; their backwards are autograd through the plain
    version).  K7's gradients are held against autograd of the
    full-precision plain version (the straight-through rule) and its
    output against the quantized plain version."""
    from repro_torch.core.dispatch import transport
    from repro_torch.kernels.moe_fused import ops as f_ops
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                                  grouped_ffn_ragged_ref,
                                                  grouped_ffn_ref)
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import (permute_ref,
                                                     unpermute_ref)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def grads(fn, inputs, g):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        out.backward(g)
        return out.detach(), [t.grad for t in leaves]

    def compare(name, kernel_fn, plain_fn, inputs, g, atol, rtol,
                plain_out=None):
        """``plain_out``: the forward's plain version when it is not
        ``plain_fn`` (K7)."""
        out_k, g_k = grads(kernel_fn, inputs, g)
        out_p, g_p = grads(plain_fn, inputs, g)
        if plain_out is not None:
            out_p = plain_out(*inputs)
        torch.cuda.synchronize()
        errs = []
        for a, b in zip([out_k] + g_k, [out_p] + g_p):
            ok, err = close(torch, a, b, atol + rtol * float(b.abs().max()),
                            0.0)
            if not ok:
                raise SystemExit(f"{name} backward: kernel Function and "
                                 f"plain autograd disagree (max abs err "
                                 f"{err})")
            errs.append(err)
        return {"max_abs_err": max(errs), "atol": atol, "rtol": rtol}

    T, S, K, d, f, E = 64, 100, 2, 128, 128, 3
    out = {}
    tok = randint(T + 1, (S,))
    out["K1"] = compare(
        "K1", lambda x: p_ops.permute(x, tok, use_pallas=True),
        lambda x: permute_ref(x, tok), [randn(T, d)], randn(S, d),
        BWD_F32_ATOL, BWD_F32_RTOL)
    inv_idx = randint(S + 1, (T, K))
    inv_w = torch.where(inv_idx < S, randn(T, K).abs(), 0.0)
    out["K2"] = compare(
        "K2", lambda y, w: p_ops.unpermute(y, inv_idx, w, use_pallas=True),
        lambda y, w: unpermute_ref(y, inv_idx, w), [randn(S, d), inv_w],
        randn(T, d), BWD_F32_ATOL, BWD_F32_RTOL)
    for label, (Tl, di) in layouts.items():
        tok_l = di.slot_to_token
        out[f"K1_{label}"] = compare(
            f"K1 ({label} layout)",
            lambda x: p_ops.permute(x, tok_l, use_pallas=True),
            lambda x: permute_ref(x, tok_l), [randn(Tl, 1024)],
            randn(di.num_slots, 1024), BWD_F32_ATOL, BWD_F32_RTOL)
        out[f"K1_{label}"]["sentinel_slots"] = int((tok_l >= Tl).sum())
        out[f"K2_{label}"] = compare(
            f"K2 ({label} layout)",
            lambda y, w: p_ops.unpermute(y, di.inv_idx, w, use_pallas=True),
            lambda y, w: unpermute_ref(y, di.inv_idx, w),
            [randn(di.num_slots, 1024), di.inv_w], randn(Tl, 1024),
            BWD_F32_ATOL, BWD_F32_RTOL)
        out[f"K2_{label}"]["dropped_picks"] = int(
            (di.inv_idx >= di.num_slots).sum())
    segs, exps = transport.stage_segments(E, ((2, 24), (4, 8)))
    widths = torch.as_tensor(segs[1:], device="cuda") - torch.as_tensor(
        segs[:-1], device="cuda")
    valid = (torch.rand(len(exps), generator=gen, device="cuda")
             * (widths + 1)).to(torch.int32)
    R = segs[-1]
    w3 = [randn(E, d, f, dtype=torch.bfloat16, scale=d ** -0.5),
          randn(E, f, d, dtype=torch.bfloat16, scale=f ** -0.5)]
    out["K3"] = compare(
        "K3", lambda x, wi, wo: g_ops.grouped_ffn_ragged(
            x, segs, exps, valid, wi, None, wo, activation="gelu",
            use_pallas=True),
        lambda x, wi, wo: grouped_ffn_ragged_ref(
            x, segs, exps, valid, wi, None, wo, activation="gelu"),
        [randn(R, d, dtype=torch.bfloat16)] + w3,
        randn(R, d, dtype=torch.bfloat16), BWD_BF16_ATOL, BWD_BF16_RTOL)
    # K7 on the same layout, with zero rows past each segment's valid count
    # (the zero-slot convention its per-segment scales rely on)
    x7 = randn(R, d, dtype=torch.bfloat16)
    x7[dead_rows(torch, segs, valid, R)] = 0
    out["K7"] = compare(
        "K7", lambda x, wi, wo: g_ops.grouped_ffn_ragged_quant(
            x, segs, exps, valid, wi, None, wo, activation="gelu",
            use_pallas=True, qweights=g_ops.quantize_expert_weights(wi)),
        lambda x, wi, wo: grouped_ffn_ragged_ref(
            x, segs, exps, valid, wi, None, wo, activation="gelu"),
        [x7] + w3, randn(R, d, dtype=torch.bfloat16), BWD_BF16_ATOL,
        BWD_BF16_RTOL,
        plain_out=lambda x, wi, wo: grouped_ffn_ragged_quant_ref(
            x, segs, exps, valid, wi, None, wo, activation="gelu"))
    # K6 on an [E, 40, d] buffer: one 64-row tile an expert, masked at 40
    xg = randn(E, 40, d, dtype=torch.bfloat16)
    out["K6"] = compare(
        "K6", lambda x, wi, wo: g_ops.grouped_ffn(x, wi, None, wo,
                                                  activation="gelu"),
        lambda x, wi, wo: grouped_ffn_ref(x, wi, None, wo,
                                          activation="gelu"),
        [xg] + w3, randn(E, 40, d, dtype=torch.bfloat16), BWD_BF16_ATOL,
        BWD_BF16_RTOL)
    # K4 at the a2a layout's occupancy: each expert's segment holds a
    # random number of realized rows with a gate weight each, then
    # sentinel slots (token T, weight 0)
    s_valid = (torch.rand(E, generator=gen, device="cuda")
               * (T + 1)).to(torch.int32)
    row = torch.arange(T, device="cuda", dtype=torch.int32)
    s_tok = torch.where(row[None, :] < s_valid[:, None], row[None, :],
                        T).reshape(-1).to(torch.int32)
    s_w = torch.where(s_tok < T, torch.rand(E * T, generator=gen,
                                            device="cuda"), 0.0)
    offs = transport.expert_segments(E, T)
    out["K4"] = compare(
        "K4", lambda x, w, wi, wo: f_ops.local_moe(
            x, s_tok, w, offs, tuple(range(E)), s_valid, wi, None, wo,
            activation="gelu", use_pallas=True),
        lambda x, w, wi, wo: local_moe_ref(
            x, s_tok, w, offs, tuple(range(E)), s_valid, wi, None, wo,
            activation="gelu"),
        [randn(T, d, dtype=torch.bfloat16), s_w] + w3, randn(T, d),
        BWD_BF16_ATOL, BWD_BF16_RTOL)
    return out


def train_phase(world, out_path: str, global_batch: int,
                dispatch: str = "a2a", wire_codec: str = "",
                steps: int = TRAIN_STEPS, aux_mode: str = "ta",
                use_moe_kernel: bool = False, microbatch: int = 0,
                remat: bool = False, layers: int = 0,
                spare_row: bool = False, fused_xent: bool = False,
                hash_experts: bool = False, arch_id: str = ARCH_ID,
                check_k4_layer: int = -1) -> None:
    """Full-width ``arch_id`` (gpt3_medium_moe, or DeepSeek-V2-Lite for
    train_dsv2_lite_d4) on this rank (``world`` None: one rank),
    AdamW, ``steps`` steps, the given dispatch path, wire codec and
    auxiliary loss (the pipelined path's chunk count from the overlap
    model); writes this rank's report to ``out_path``.  The run goes
    through ``trainer.train``, or, with ``use_moe_kernel`` (the dense
    grouped FFN kernel, which ``trainer.train`` does not take, as the
    reference's does not), through ``build_ctx(use_moe_kernel=True)`` and
    ``trainer.make_train_step`` on the batches ``trainer.train`` builds.

    Before the run, the plain path computes the first step's loss from the
    same initial parameters and batch, with the kernels switched off by
    ``use_pallas=False`` and by the backend's ``REPRO_TORCH_KERNELS=0``
    (``grouped_ffn`` reads only the latter, as the reference's entry
    ignores ``use_pallas``); with ``microbatch`` it is the mean of the
    microbatches' losses, as the accumulated step logs it.  The launch
    counters are set to 0 just before the run and read just after.  One
    more step on the trained state runs under torch.profiler (not
    counted).  With ``remat``, two more steps read the peak device memory
    of a step with and without it (``remat_memory``).  ``layers`` > 0 cuts
    the depth.  With ``spare_row`` (a2a on a world) the profiled step runs
    once more with the earlier spare-row backwards.  With ``fused_xent``
    (one rank), before the profiled step, the forward and backward with
    the fused cross entropy and with the default loss on the same state
    and batch (``fused_xent_case``), then one training step with it,
    counted on its own.  With ``hash_experts`` the report carries the
    sha256 of this rank's expert leaves after the run, to hold data-
    parallel replicas to each other.  With ``check_k4_layer`` (one rank),
    first K4 against its plain version at the run's own first-step layout
    on that MoE layer (``own_layout_k4``), before any count is read."""
    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    arch = get_config(arch_id)
    if layers:
        arch = cut_depth(arch, layers)
    run = RunConfig(seq_len=TRAIN_SEQ, global_batch=global_batch,
                    warmup_steps=1, aux_mode=aux_mode, dispatch=dispatch,
                    a2a_num_chunks=0, wire_codec=wire_codec, seed=0,
                    microbatch=microbatch, remat=remat)
    rank = 0 if world is None else world.rank
    micro = microbatch if trainer.num_microbatches(run) > 1 else 0

    def ctx_for(use_pallas):
        return model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                                   global_batch=global_batch,
                                   aux_mode=run.aux_mode,
                                   dispatch=run.dispatch,
                                   a2a_num_chunks=run.a2a_num_chunks,
                                   wire_codec=run.wire_codec,
                                   use_pallas=use_pallas,
                                   use_moe_kernel=use_moe_kernel,
                                   remat=run.remat, device="cuda")

    plain_ctx = ctx_for(False)
    params = model_lib.init_params(
        plain_ctx, torch.Generator(device="cuda").manual_seed(run.seed))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=global_batch, seed=run.seed))
    k4_check = (own_layout_k4(torch, params, plain_ctx, data.batch(0),
                              check_k4_layer, global_batch)
                if check_k4_layer >= 0 else None)
    backend.reset_launches()
    os.environ[backend.ENV_VAR] = "0"
    with torch.no_grad():
        b0 = shard_batch(data.batch(0), world, "cuda", microbatch=micro)
        n_mb = trainer.num_microbatches(run)
        per = b0["tokens"].shape[0] // n_mb
        losses = []
        for i in range(n_mb):
            _, m = transformer.loss_fn(
                params, {k: v[i * per:(i + 1) * per] for k, v in b0.items()},
                plain_ctx, aux_weight=run.aux_weight)
            losses.append(m["loss"])
        plain_loss = float(trainer.world_mean_metrics(
            {"loss": sum(losses) / n_mb}, world)["loss"])
    del os.environ[backend.ENV_VAR]
    plain_launches = dict(backend.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    kernel_ctx = ctx_for(None)
    if use_moe_kernel:
        res = steps_through(torch, kernel_ctx, run, params, data, steps)
    else:
        res = trainer.train(arch, run, world, steps=steps, log_every=1,
                            verbose=rank == 0, params=params, device="cuda")
    launches = dict(backend.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    experts_sha256 = (expert_digest(torch, res.params, kernel_ctx)
                      if hash_experts else None)
    from repro_torch.launch.analysis import state_bytes
    held = state_bytes(res.params, res.opt_state)

    step = trainer.make_train_step(kernel_ctx, run)
    batch = shard_batch(data.batch(steps), world, "cuda", microbatch=micro)
    xent = (fused_xent_case(torch, kernel_ctx, run, res, batch)
            if fused_xent else None)
    profiled = profile_train_step(torch, step, res.params, res.opt_state,
                                  batch)
    memory = (remat_memory(torch, arch, run, res, batch) if remat
              else None)
    spare_profiled = None
    if spare_row:
        # the same step once more with the earlier spare-row backwards,
        # for the backward scatters' device time before and after
        spare = spare_row_backwards(torch)
        shipped = {fn: fn.backward for fn in spare}
        for fn, bwd in spare.items():
            fn.backward = staticmethod(bwd)
        try:
            spare_profiled = profile_train_step(torch, step, res.params,
                                                res.opt_state, batch)
        finally:
            for fn, bwd in shipped.items():
                fn.backward = staticmethod(bwd)
    hist = res.metrics_history
    report = {
        "rank": rank, "coords": None if world is None else list(world.coords),
        "a2a_num_chunks": plain_ctx.a2a_num_chunks,
        "caps": list(plain_ctx.plan.caps), "losses": res.losses,
        "nll": [h["nll"] for h in hist], "aux": [h["aux"] for h in hist],
        "frac_by_level": [h.get("frac_by_level") for h in hist],
        "dropped": [h.get("dropped") for h in hist],
        "grad_norm": [h["grad_norm"] for h in hist],
        "plain_first_loss": plain_loss, "plain_launches": plain_launches,
        "step_wall_s": res.step_seconds, "launches": launches,
        "max_memory_allocated_gb": peak_gb, "profiled_step": profiled,
        "profiled_step_spare_row_backwards": spare_profiled,
        "microbatch": microbatch, "remat": remat, "step_memory": memory,
        "layers": arch.num_layers, "fused_xent": xent,
        "experts_sha256": experts_sha256, "state_bytes": held,
        "K4_check": k4_check, "run_seconds": time.time() - t_start}
    with open(out_path, "w") as fh:
        json.dump(report, fh)


def own_layout_k4(torch, params, ctx, batch: dict, layer: int,
                  global_batch: int) -> dict:
    """K4 against its plain version (``check_k4``, timed) and its
    compaction bit-equal (``check_compaction``) at a one-rank training
    run's own first-step layout: ``batch``'s tokens through the model's
    layers before MoE layer ``layer`` and its mixer, routed on the a2a
    plan (``train1_k4_case``).  Frees what it held."""
    tokens = batch["tokens"].cuda()
    with torch.no_grad():
        args, act = train1_k4_case(torch, params, ctx.arch, None,
                                   layer=layer,
                                   x=moe_rows(torch, params, ctx, tokens,
                                              layer),
                                   global_batch=global_batch)
        out = check_k4(torch, args, act, "train_1rank")
        compaction = check_compaction(torch, args, "train_1rank")
    T = args[0].shape[0]
    layout = {"T": T, "slots": args[1].numel(), "segments": len(args[4]),
              "valid_rows": int(args[5].sum()),
              "dropped_picks": T * ctx.arch.moe.top_k - int(args[5].sum())}
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return {"K4": out, "K4_compaction": compaction, "layout": layout}


def train_chain(runs, then: tuple = ()) -> None:
    """One child process for several one-rank ``train_phase`` runs in
    turn, ``(out_path, global_batch, args, kwargs)`` each, then each of
    ``then``'s ``(name, args)``: this module's ``name(*args)`` (a phase
    that writes its own report).  The process start and CUDA context of
    the first serve the rest (10-15 s each); each run's tensors are freed
    before the next starts."""
    import torch
    for out_path, global_batch, args, kwargs in runs:
        train_phase(None, out_path, global_batch, *args, **kwargs)
        gc.collect()
        torch.cuda.empty_cache()
    for name, args in then:
        globals()[name](*args)
        gc.collect()
        torch.cuda.empty_cache()


def family_train_phase(out_path: str, arch_id: str, layers: int = 0,
                       seq: int = TRAIN_SEQ) -> None:
    """One-rank training of ``arch_id`` (a family with no hand-written
    kernel on its training path) at full width, cut to ``layers`` by
    ``cut_depth`` (0: full depth), at sequence ``seq``, on
    ``SyntheticLM``'s batch 0 (with its
    frames or patches, and for a vision model the loss mask zero over the
    patches), AdamW at RunConfig's defaults (lr 3e-4 after 100 warmup
    steps).  First the float32 reference: a
    float32 copy of the weights, one forward and backward, its loss and
    global gradient norm (then freed); then FAMILY_TRAIN_STEPS bf16
    training steps on that batch, each timed after a synchronize, the
    launch counters set to 0 just before and read just after, the peak
    device memory; then one more step under the profiler.  Writes the
    report to ``out_path``; the main process holds it."""
    import dataclasses

    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    arch = get_config(arch_id)
    if layers:
        arch = cut_depth(arch, layers)
    run = RunConfig(seq_len=seq, global_batch=TRAIN_BATCH_1,
                    aux_mode="none", seed=0)
    ctx = model_lib.build_ctx(arch, None, seq_len=seq,
                              global_batch=TRAIN_BATCH_1, aux_mode="none",
                              device="cuda")
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(run.seed))
    host = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=seq, global_batch=TRAIN_BATCH_1,
                                  seed=run.seed), arch).batch(0)
    batch = shard_batch(host, None, "cuda")
    parts = {"init": time.time() - t_start}
    f32_ctx = dataclasses.replace(ctx, arch=dataclasses.replace(
        arch, dtype="float32"))
    p32 = _cast_params(params, torch.float32)
    for p in adamw.tree_leaves(p32):
        p.requires_grad_(True)
    grads, m32 = trainer._backward(p32, batch, f32_ctx, run)
    _, gn32 = trainer.sync_grads(p32, f32_ctx, grads)
    f32 = {"loss": float(m32["loss"].detach()), "grad_norm": float(gn32)}
    del p32, grads, m32, gn32
    gc.collect()
    torch.cuda.empty_cache()
    parts["f32_step"] = time.time() - t_start - sum(parts.values())

    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init_state(params)
    step = trainer.make_train_step(ctx, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    losses, gnorms, walls = [], [], []
    for _ in range(FAMILY_TRAIN_STEPS):
        ts = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - ts)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = dict(backend.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    parts["bf16_steps"] = time.time() - t_start - sum(parts.values())
    profiled = profile_train_step(torch, step, params, opt_state, batch,
                                  device_only=True)
    parts["profiled_step"] = time.time() - t_start - sum(parts.values())
    report = {
        "arch": arch_id, "layers": arch.num_layers,
        "enc_layers": arch.enc_layers,
        "params": model_lib.count_params(params), "seq_len": seq,
        "global_batch": TRAIN_BATCH_1, "steps": FAMILY_TRAIN_STEPS,
        "frontend": (list(host["frontend"].shape) if "frontend" in host
                     else None),
        "loss_mask_zeros": int((host["loss_mask"] == 0).sum()),
        "f32": f32, "losses": losses, "grad_norm": gnorms,
        "step_wall_s": walls, "launches": launches,
        "max_memory_allocated_gb": peak_gb, "profiled_step": profiled,
        "seconds_by_part": parts, "run_seconds": time.time() - t_start}
    with open(out_path, "w") as fh:
        json.dump(report, fh)


def check_family_training(r: dict, label: str, loss_rtol: float,
                          gnorm_rtol: float) -> dict:
    """A family's one-rank training (``family_train_phase``): no kernel
    launched, finite losses that fall over the steps on the repeated
    batch, and the first bf16 step's loss and gradient norm within
    ``loss_rtol`` and ``gnorm_rtol`` of the float32 step's."""
    from repro_torch.kernels import backend
    want = {k: 0 for k in backend.LAUNCHES}
    if r["launches"] != want:
        raise SystemExit(f"{label}: launches {r['launches']}, the path "
                         f"needs none")
    losses = r["losses"]
    if not all(math.isfinite(v) for v in losses + r["grad_norm"]) or \
            not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: losses {losses} on one repeated batch "
                         f"(grad norms {r['grad_norm']}): not finite and "
                         f"falling")
    gaps = {k: abs(got - r["f32"][k]) / abs(r["f32"][k])
            for k, got in (("loss", losses[0]),
                           ("grad_norm", r["grad_norm"][0]))}
    limits = {"loss": loss_rtol, "grad_norm": gnorm_rtol}
    for k, gap in gaps.items():
        if not gap <= limits[k]:
            raise SystemExit(f"{label}: the bf16 step's {k} lies {gap} "
                             f"(relative) from the float32 step's "
                             f"{r['f32'][k]}; limit {limits[k]}")
    return {"rel_diff_vs_f32": gaps, "limits": limits}


def expert_digest(torch, params, ctx) -> str:
    """sha256 over this rank's expert leaves (``trainer.expert_mask``), in
    tree order, as their bytes on the host."""
    import hashlib

    import numpy as np
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    h = hashlib.sha256()
    for leaf, is_expert in zip(adamw.tree_leaves(params),
                               trainer.expert_mask(params, ctx)):
        if is_expert:
            raw = leaf.detach().contiguous().view(torch.uint8).cpu()
            h.update(np.asarray(raw).tobytes())
    return h.hexdigest()


def fused_xent_case(torch, ctx, run, res, batch) -> dict:
    """The fused cross entropy on the trained state: the loss and peak
    device memory of one forward and backward with the default loss and
    with ``fused_xent`` on the same parameters and batch (gradients
    dropped, nothing updated), then one training step with it whose
    launches are counted on their own (``launches``)."""
    import dataclasses

    from repro_torch.kernels import backend
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    fused = dataclasses.replace(ctx, fused_xent=True)
    out = {}
    for name, c in (("default", ctx), ("fused", fused)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        total, _ = transformer.loss_fn(res.params, batch, c,
                                       aux_weight=run.aux_weight)
        total.backward()
        torch.cuda.synchronize()
        out[name] = {"loss": float(total.detach()),
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "above_resident_gb":
                         (torch.cuda.max_memory_allocated() - base) / 1e9}
        del total
        for p in adamw.tree_leaves(res.params):
            p.grad = None
    step = trainer.make_train_step(fused, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    t0 = time.perf_counter()
    _, _, m = step(res.params, res.opt_state, batch)
    torch.cuda.synchronize()
    out["step"] = {"loss": float(m["loss"]),
                   "step_s": time.perf_counter() - t0,
                   "max_memory_allocated_gb":
                       torch.cuda.max_memory_allocated() / 1e9}
    out["launches"] = dict(backend.LAUNCHES)
    d, f = out["default"]["loss"], out["fused"]["loss"]
    out["rel_diff"] = abs(f - d) / abs(d)
    return out


def remat_memory(torch, arch, run, res, batch) -> dict:
    """With remat and without, on the trained state: the device memory one
    microbatch's forward holds for its backward (``forward_held_gb``:
    allocated after the loss minus before it, the activations remat
    drops), then the peak device memory (``max_memory_allocated`` after
    ``reset_peak_memory_stats``) and wall time of one more training step
    on the same batch."""
    import dataclasses

    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.training import trainer
    out = {}
    rows = batch["tokens"].shape[0] // trainer.num_microbatches(run)
    for remat in (True, False):
        ctx = model_lib.build_ctx(arch, None, seq_len=run.seq_len,
                                  global_batch=run.global_batch,
                                  aux_mode=run.aux_mode, remat=remat,
                                  device="cuda")
        step = trainer.make_train_step(
            ctx, dataclasses.replace(run, remat=remat))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        total, _ = transformer.loss_fn(
            res.params, {k: v[:rows] for k, v in batch.items()}, ctx,
            aux_weight=run.aux_weight)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        del total, _
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(res.params, res.opt_state, batch)
        torch.cuda.synchronize()
        out["remat" if remat else "no_remat"] = {
            "forward_held_gb": held / 1e9,
            "step_s": time.perf_counter() - t0,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "above_resident_gb": (torch.cuda.max_memory_allocated() - base)
            / 1e9}
    out["saved_peak_gb"] = (out["no_remat"]["max_memory_allocated_gb"]
                            - out["remat"]["max_memory_allocated_gb"])
    out["saved_held_gb"] = (out["no_remat"]["forward_held_gb"]
                            - out["remat"]["forward_held_gb"])
    return out


def steps_through(torch, ctx, run, params, data, steps: int):
    """``trainer.train``'s loop on one rank from a context it does not
    build: the same optimizer state, batches, step timing and metrics."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init_state(params)
    step = trainer.make_train_step(ctx, run)
    losses, history, step_s = [], [], []
    for i in range(steps):
        batch = shard_batch(data.batch(i), None, "cuda")
        ts = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        h = {k: float(v) if v.dim() == 0 else [float(x) for x in v]
             for k, v in metrics.items()}
        losses.append(h["loss"])
        history.append(h)
        print(f"step {i:5d} loss {h['loss']:.4f} nll {h['nll']:.4f} aux "
              f"{h['aux']:.4f} dropped {h['dropped']:.4f}", flush=True)
    return trainer.TrainResult(losses=losses, metrics_history=history,
                               steps_per_sec=steps / sum(step_s),
                               params=params, opt_state=opt_state,
                               step_seconds=step_s)


def profile_train_step(torch, step, params, opt_state, batch,
                       device_only: bool = False) -> dict:
    """One more training step under torch.profiler (not counted): wall
    and device time, busy share, launches, the top kernels, the device
    time of the kernels launched inside each profiler range of
    PROFILED_RANGES (K1's and K2's scatters apart from the ragged FFN's
    weight scatters; K7's forward apart from its weight quantization), and
    each hand-written kernel's launches and device time by name
    (``port_kernels``).  The profiler credits a range with the PyTorch
    operators' kernels only: a kernel launched through ctypes is in
    ``port_kernels``, not in its range.  With ``device_only`` the
    profiler records the card's activity alone (no ranges): a step of
    tens of thousands of small launches (xLSTM's sLSTM steps its 512
    positions one by one) otherwise spends half a minute in the host
    side's events."""
    import re

    import chip_ab
    from repro_torch.kernels import backend
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if not device_only:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # the ranges also appear as device-side spans; only kernels count
    events = [e for e in averages if e.device_type.name == "CUDA"
              and e.key not in PROFILED_RANGES]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    for name in (n for src in backend.sources()
                 for n in chip_ab.kernel_names(REPO, src)):
        hits = [e for e in events if re.search(rf"\b{name}\b", e.key)]
        if hits:
            port[name] = {"count": sum(e.count for e in hits),
                          "device_ms": sum(e.self_device_time_total
                                           for e in hits) / 1e3}
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:60], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top],
            "port_kernels": port,
            "ranges": {
                e.key: {"count": e.count,
                        "device_ms": e.device_time_total / 1e3}
                for e in averages
                if e.key in PROFILED_RANGES and e.device_type.name == "CPU"}}


def spare_row_backwards(torch):
    """K1's and K2's backwards as the port first had them, every sentinel
    slot (dropped pick) added into one spare row, under the ranges of the
    shipped ones: the yardstick the train_2x2 phase profiles one more
    step with.  Returns ``{Function: backward}``."""
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import _with_zero_row

    def permute_bwd(ctx, g):
        (slot_to_token,) = ctx.saved_tensors
        with torch.profiler.record_function(PROFILED_RANGES[0]):
            gx = g.new_zeros((ctx.num_tokens + 1, g.shape[-1]))
            gx.index_add_(0, slot_to_token.long(), g)
            return gx[:ctx.num_tokens], None, None

    def unpermute_bwd(ctx, g):
        y, inv_idx, inv_w = ctx.saved_tensors
        S, d = y.shape
        with torch.profiler.record_function(PROFILED_RANGES[1]):
            g = g.to(torch.float32)
            y_z = _with_zero_row(y)
            gy = torch.zeros((S + 1, d), dtype=torch.float32,
                             device=y.device)
            gw_cols = []
            for k in range(inv_idx.shape[1]):
                idx = inv_idx[:, k].long()
                gy.index_add_(0, idx,
                              g * inv_w[:, k].to(torch.float32)[:, None])
                picked = y_z.index_select(0, idx).to(torch.float32)
                gw_cols.append(torch.sum(g * picked, dim=-1))
            gw = torch.stack(gw_cols, dim=1).to(inv_w.dtype)
            return gy[:S].to(y.dtype), None, gw, None

    return {p_ops.Permute: permute_bwd, p_ops.Unpermute: unpermute_bwd}


def resilient_phase(out_path: str) -> None:
    """The resilient runtime at full width on one rank, in two parts.

    1. One layer (0.32 B parameters; a checkpoint of params and AdamW
       moments is about 3.2 GB) under ``RESILIENT_CHAOS``: rolling
       checkpoints every 2 steps (2 kept) in a temporary directory that
       is deleted after; a NaN-gradient step must be skipped, and the
       spike must be rolled back at the last step to the newest
       checkpoint that verifies: the newest (step 5) is corrupted, so the
       step-3 one, whose tensors the returned state must equal bit for
       bit.  The run's own ``ckpt.save``, ``verify`` and
       ``restore_into`` calls are timed where the trainer makes them
       (``timed_ckpt_calls``): the saves' mean, and the rollback's
       ``verify`` of the step-3 checkpoint (which must pass) and its
       ``restore_into`` (``check_hashes=False``: the verify hashed every
       leaf), with the checkpoint's bytes.
    2. Depth CUT_LAYERS: the unguarded and the guarded loop (no chaos) on
       the
       same initial weights, in turns (unguarded, guarded, guarded,
       unguarded), ``GUARD_STEPS`` steps each: their losses must agree
       within LOSS_RTOL, and the steady step walls give the guard's
       cost.

    Launch counters are set to 0 before each run and read after it."""
    import dataclasses

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.kernels import backend
    from repro_torch.optim import adamw
    from repro_torch.resilience import ChaosConfig, ResilienceConfig
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.time()
    full = get_config(ARCH_ID)
    arch = dataclasses.replace(full, num_layers=1)
    base = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_1,
                warmup_steps=1, aux_mode="ta", seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    report = {}
    try:
        res = ResilienceConfig(rollback_on_spike=True, spike_factor=1.5,
                               spike_patience=2, spike_warmup=3,
                               chaos=ChaosConfig(**RESILIENT_CHAOS))
        ck = os.path.join(tmp, "ck.npz")
        backend.reset_launches()
        t0 = time.perf_counter()
        with timed_ckpt_calls(ckpt) as calls:
            r = trainer.train(arch, RunConfig(resilience=res, **base), None,
                              steps=RESILIENT_STEPS, log_every=1,
                              verbose=True, ckpt_path=ck, ckpt_every=2,
                              ckpt_keep=2, device="cuda")
        run_s = time.perf_counter() - t0
        launches = dict(backend.LAUNCHES)
        if (r.skipped_steps, r.rollbacks) != (1, 1):
            raise SystemExit(f"train_resilient: {r.skipped_steps} skipped "
                             f"steps and {r.rollbacks} rollbacks, the chaos "
                             f"schedule needs 1 and 1")
        newest = os.path.join(tmp, "ck-000005.npz")
        if ckpt.verify(newest):
            raise SystemExit("train_resilient: the corrupted step-5 "
                             "checkpoint verifies")
        state = {"params": r.params, "opt": r.opt_state}
        step3 = os.path.join(tmp, "ck-000003.npz")
        # the rollback's verify of the step-3 checkpoint hashed every leaf
        good = ckpt.restore(step3, state, check_hashes=False)
        live = adamw.tree_leaves([state["params"], state["opt"]["mu"],
                                  state["opt"]["nu"]])
        saved = adamw.tree_leaves([good["params"], good["opt"]["mu"],
                                   good["opt"]["nu"]])
        unequal = sum(not torch.equal(a.detach(), b)
                      for a, b in zip(live, saved))
        if unequal or good["opt"]["step"] != r.opt_state["step"]:
            raise SystemExit(f"train_resilient: {unequal} restored tensors "
                             f"differ from the step-3 checkpoint")
        del good, saved
        saves = [c for c in calls if c["call"] == "save"]
        verifies = {os.path.basename(c["path"]): c for c in calls
                    if c["call"] == "verify"}
        restores = [c for c in calls if c["call"] == "restore_into"]
        rollback_verify = verifies.get("ck-000003.npz")
        if rollback_verify is None or not rollback_verify["result"] \
                or len(restores) != 1:
            raise SystemExit(f"train_resilient: the rollback's verify of the "
                             f"step-3 checkpoint did not pass, or it "
                             f"restored {len(restores)} times: {calls}")
        save_s = sum(c["seconds"] for c in saves) / len(saves)
        verify_s = rollback_verify["seconds"]
        restore_s = restores[0]["seconds"]
        nbytes = os.path.getsize(step3)
        hist = r.metrics_history
        report["chaos"] = {
            "layers": 1, "params": sum(t.numel() for t in
                                       adamw.tree_leaves(r.params)),
            "steps": RESILIENT_STEPS, "chaos": RESILIENT_CHAOS,
            "losses": r.losses, "nonfinite": [h["nonfinite"] for h in hist],
            "skipped_steps": r.skipped_steps, "rollbacks": r.rollbacks,
            "rolled_back_to_step": 3, "restored_bit_equal": True,
            "launches": launches, "run_s": run_s,
            "step_wall_s": r.step_seconds,
            "checkpoint_bytes": nbytes, "save_s": save_s,
            "saves": len(saves), "verify_s": verify_s,
            "restore_s": restore_s, "ckpt_calls": [
                {k: v for k, v in c.items() if k != "path"}
                | {"file": os.path.basename(c["path"])} for c in calls],
            "restore_check_hashes": False,
            "rollback_s": verify_s + restore_s,
            "save_gb_per_s": nbytes / 1e9 / save_s,
            "verify_gb_per_s": nbytes / 1e9 / verify_s,
            "restore_gb_per_s": nbytes / 1e9 / restore_s}
        del r, state, live
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    runs, guard_launches = [], {}
    guard_arch = dataclasses.replace(full, num_layers=CUT_LAYERS)
    for label in ("unguarded", "guarded", "guarded", "unguarded"):
        run = RunConfig(resilience=ResilienceConfig() if label == "guarded"
                        else None, **base)
        backend.reset_launches()
        r = trainer.train(guard_arch, run, None, steps=GUARD_STEPS,
                          log_every=1, verbose=False, device="cuda")
        for k, v in backend.LAUNCHES.items():
            guard_launches[k] = guard_launches.get(k, 0) + v
        runs.append({"label": label, "losses": r.losses,
                     "step_wall_s": r.step_seconds})
        del r
        gc.collect()
        torch.cuda.empty_cache()
    ref = runs[0]["losses"]
    worst = max(abs(a - b) / abs(b) for g in runs for a, b in
                zip(g["losses"], ref))
    if not worst <= LOSS_RTOL or not all(math.isfinite(v) for g in runs
                                         for v in g["losses"]):
        raise SystemExit(f"train_resilient: guarded and unguarded losses "
                         f"differ by {worst} (relative) > {LOSS_RTOL}")

    def steady(label):
        walls = [w for g in runs if g["label"] == label
                 for w in g["step_wall_s"][1:]]
        return sum(walls) / len(walls)

    report["guard"] = {
        "layers": guard_arch.num_layers, "steps": GUARD_STEPS, "runs": runs,
        "max_rel_loss_diff": worst, "rtol": LOSS_RTOL,
        "steady_step_s_unguarded": steady("unguarded"),
        "steady_step_s_guarded": steady("guarded"),
        "guard_cost": steady("guarded") / steady("unguarded") - 1.0,
        "launches": guard_launches}
    report["launches"] = {k: report["chaos"]["launches"][k]
                          + guard_launches[k] for k in guard_launches}
    report["run_seconds"] = time.time() - t_start
    with open(out_path, "w") as fh:
        json.dump(report, fh)


class timed_ckpt_calls:
    """Within the block, every call of ``ckpt``'s ``save``, ``verify``
    and ``restore_into`` (module attributes, which the trainer reads at
    each call) is timed on the host clock, the card synchronized after,
    and logged as ``{"call", "path", "seconds", "result"}`` (the verify's
    verdict); the functions are restored after."""

    NAMES = ("save", "verify", "restore_into")

    def __init__(self, ckpt):
        self.ckpt, self.calls, self.orig = ckpt, [], {}

    def __enter__(self):
        import torch
        for name in self.NAMES:
            fn = self.orig[name] = getattr(self.ckpt, name)

            def timed(path, *a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(path, *a, **kw)
                torch.cuda.synchronize()
                self.calls.append({
                    "call": _name, "path": path,
                    "seconds": time.perf_counter() - t0,
                    "result": out if _name == "verify" else None})
                return out
            setattr(self.ckpt, name, timed)
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ckpt, name, fn)
        return False


def replan_rank(world, out_dir: str) -> None:
    """One rank of the 2x2 world under the degraded-link chaos
    (``REPLAN_RESILIENCE``): ``trainer.train`` at full width and depth
    ``REPLAN_LAYERS``, the measured links (``comm_model.measure_link``
    over gloo, cached per process, so the later probe reads the first
    one's fit), the caps before and after the replan, and the caps the
    port's planner gives with the pod level's beta scaled to inf.  The
    step function the replan builds keeps a copy of the parameters and
    batch of its first call; after the run the plain path (kernels off by
    ``use_pallas=False`` and ``REPRO_TORCH_KERNELS=0``) computes that
    step's world-mean loss from them under the replanned context, to hold
    against the loss the run logged.  Writes ``replan<rank>.json``."""
    import contextlib
    import dataclasses
    import io
    import re

    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.core import capacity, comm_model, topology
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.resilience import ChaosConfig, ResilienceConfig
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.time()
    arch = dataclasses.replace(get_config(ARCH_ID), num_layers=REPLAN_LAYERS)
    res = ResilienceConfig(chaos=ChaosConfig(**REPLAN_CHAOS),
                           **REPLAN_RESILIENCE)
    run = RunConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_22,
                    warmup_steps=1, aux_mode="ta", seed=0, resilience=res)
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_22, aux_mode="ta",
                              device="cuda")
    plan = ctx.plan
    want = capacity.make_dispatch_plan(
        tokens_per_device=plan.tokens_per_device,
        num_experts=plan.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor,
        axis_sizes=plan.axis_sizes, axis_names=ctx.ep.axis_names,
        mode=plan.mode, comm=topology.tree_topology_nd(plan.axis_sizes),
        level_beta_scale=(1.0,) * len(plan.axis_sizes) + (math.inf,))
    first = {}
    guarded_step = trainer.make_guarded_train_step

    def keeping_first_after_replan(c, run_cfg):
        step = guarded_step(c, run_cfg)
        if c.plan.caps == plan.caps:
            return step

        def kept(params, opt_state, batch, *rest):
            if not first:
                first.update(ctx=c, params=_clone_tree(params),
                             batch=_clone_tree(batch))
            return step(params, opt_state, batch, *rest)
        return kept

    log = io.StringIO()
    trainer.make_guarded_train_step = keeping_first_after_replan
    backend.reset_launches()
    try:
        with contextlib.redirect_stdout(log):
            r = trainer.train(arch, run, world, steps=REPLAN_STEPS,
                              log_every=1, verbose=True, device="cuda")
    finally:
        trainer.make_guarded_train_step = guarded_step
    launches = dict(backend.LAUNCHES)
    plain_loss = None
    if first:
        os.environ[backend.ENV_VAR] = "0"
        with torch.no_grad():
            _, m = transformer.loss_fn(
                first["params"], first["batch"],
                dataclasses.replace(first["ctx"], use_pallas=False),
                aux_weight=run.aux_weight)
            plain_loss = float(trainer.world_mean_metrics(
                {"loss": m["loss"]}, world)["loss"])
        del os.environ[backend.ENV_VAR]
        first.clear()
    links = comm_model.measured_ep_links(world, ctx.ep.axis_names)
    after = re.findall(r"replan: caps -> \(([0-9, ]*)\)", log.getvalue())
    report = {
        "rank": world.rank, "coords": list(world.coords),
        "layers": REPLAN_LAYERS, "losses": r.losses,
        "replans": r.replans, "caps_before": list(plan.caps),
        "first_replanned_step": res.replan_every,
        "plain_first_replanned_loss": plain_loss,
        "caps_after": [[int(c) for c in a.split(",") if c.strip()]
                       for a in after],
        "planner_caps_pod_beta_inf": list(want.caps),
        "launches": launches, "step_wall_s": r.step_seconds,
        "links": {ax: None if li is None else
                  {"alpha_s": li.alpha, "beta_s_per_byte": li.beta,
                   "gb_per_s": 1e-9 / li.beta, "nbytes": list(li.nbytes),
                   "times_s": list(li.times)}
                  for ax, li in links.items()},
        "log": log.getvalue(), "run_seconds": time.time() - t_start}
    with open(os.path.join(out_dir, f"replan{world.rank}.json"), "w") as fh:
        json.dump(report, fh)


def train_rank(world, out_dir: str, global_batch: int, dispatch: str = "a2a",
               wire_codec: str = "", steps: int = TRAIN_STEPS,
               layers: int = 0, spare_row: bool = False,
               hash_experts: bool = False, arch_id: str = ARCH_ID,
               then: tuple = (), tag: str = "rank") -> None:
    """One rank of a training world: ``train_phase`` of ``arch_id``
    (``<tag><rank>.json``), then in the same processes each run of
    ``then``, ``(tag, dispatch, wire_codec, steps)`` from the same
    initial weights (``<tag><rank>.json``): a world's second run costs
    no second spawn."""
    import torch
    train_phase(world, os.path.join(out_dir, f"{tag}{world.rank}.json"),
                global_batch, dispatch, wire_codec, steps, layers=layers,
                spare_row=spare_row, hash_experts=hash_experts,
                arch_id=arch_id)
    for tag, disp, codec, n in then:
        gc.collect()
        torch.cuda.empty_cache()
        train_phase(world, os.path.join(out_dir, f"{tag}{world.rank}.json"),
                    global_batch, disp, codec, n, layers=layers,
                    hash_experts=hash_experts, arch_id=arch_id)


def check_training(reports, want: dict, label: str,
                   rtol: float = LOSS_RTOL, steps: int = TRAIN_STEPS) -> dict:
    """Launch counts (none on the plain path), finite losses, agreement of
    the ranks' world means, and the kernel path's first-step loss against
    the plain path's."""
    for r in reports:
        if any(r["plain_launches"].values()):
            raise SystemExit(f"{label} rank {r['rank']}: the plain path "
                             f"launched {r['plain_launches']}")
        for name, n in want.items():
            if r["launches"][name] != n:
                raise SystemExit(f"{label} rank {r['rank']}: {name} "
                                 f"launched {r['launches'][name]} times, "
                                 f"the path needs {n}")
        if len(r["losses"]) != steps or not all(
                math.isfinite(v) for v in r["losses"]):
            raise SystemExit(f"{label} rank {r['rank']}: losses "
                             f"{r['losses']}")
        if r["losses"] != reports[0]["losses"]:
            raise SystemExit(f"{label}: ranks disagree on the world-mean "
                             f"losses")
    first, plain = reports[0]["losses"][0], reports[0]["plain_first_loss"]
    rel = abs(first - plain) / abs(plain)
    if not rel <= rtol:
        raise SystemExit(f"{label}: first-step loss {first} (kernels) vs "
                         f"{plain} (plain): relative {rel} > {rtol}")
    return {"first_loss_kernel": first, "first_loss_plain": plain,
            "rel_diff": rel, "rtol": rtol}


def overlap_terms(arch) -> dict:
    """The overlap model's inputs and verdict for the 2x2 plan under the
    int8 wire (the reference's link and peak constants)."""
    from repro_torch.core import comm_model
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model as model_lib
    world = EPWorld(axis_names=("pod", "data"), axis_sizes=WORLD_22,
                    coords=(0, 0), device="cuda")
    plan = model_lib.make_plan(arch, world, TRAIN_SEQ, TRAIN_BATCH_22, "ta")
    terms = comm_model.moe_overlap_terms(
        plan, d_model=arch.d_model, d_ff=arch.moe.d_ff_expert,
        bytes_per_el=2, activation=arch.activation, codec="int8")
    return dict(terms, chunks=comm_model.choose_num_chunks(**terms),
                caps=list(plan.caps), ratios=list(plan.ratios))


def serve_requests(rng, vocab: int, n: int):
    from repro_torch.serving.scheduler import Request
    lens = rng.integers(32, BUCKET + 1, size=n)
    budgets = rng.integers(16, 65, size=n)
    return [Request(uid=i, tokens=rng.integers(0, vocab, size=int(L)).tolist(),
                    max_new_tokens=int(m))
            for i, (L, m) in enumerate(zip(lens, budgets))]


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.detach().clone()


def _cast_params(params, dtype):
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def e2e_logits(torch, params, ctx, prompt, world=None, frontend=None,
               steps: int = E2E_STEPS):
    """Prefill of ``prompt`` [B, S] (with ``frontend`` [B, F, width], a
    model's frame or patch embeddings) then ``steps`` decode steps, each
    fed the prompt's last token: float32 logits [steps + 1, B, V].
    On a world every rank passes the whole batch, runs its rows, and gets
    the whole batch's logits (gathered)."""
    from repro_torch.launch.mesh import gather_rows
    from repro_torch.serving import engine
    rank, n = (0, 1) if world is None else (world.rank, world.size)
    B, S = prompt.shape
    rows = slice(rank * B // n, (rank + 1) * B // n)
    mine = prompt[rows]
    prefill = engine.make_prefill(ctx, with_cache=True,
                                  cache_len=max(64, S + steps))
    step = engine.make_decode_step(ctx)
    batch = {"tokens": mine}
    if frontend is not None:
        batch["frontend"] = frontend[rows]
    lg, cache = prefill(params, batch)
    traj = [gather_rows(world, lg)]
    tok = mine[:, -1:]
    for _ in range(steps):
        out, cache = step(params, cache, tok)
        traj.append(gather_rows(world, out[:, 0]))
    return torch.stack(traj)


def e2e_verdict(torch, got, f32, bf16, label: str) -> dict:
    """The kernel path's logits ``got`` against the float32 plain run's:
    at most E2E_RATIO times as far (relative Frobenius) as the bf16 plain
    run's ``bf16``, or E2E_FLOOR; raises otherwise."""
    def rel(a):
        return float(torch.linalg.vector_norm(a - f32)
                     / torch.linalg.vector_norm(f32))

    rel_kernel, rel_plain = rel(got), rel(bf16)
    agree = float((got.argmax(-1) == f32.argmax(-1)).float().mean())
    limit = max(E2E_RATIO * rel_plain, E2E_FLOOR)
    if not (math.isfinite(rel_kernel) and rel_kernel <= limit):
        raise SystemExit(f"{label}: kernel path logits are {rel_kernel} "
                         f"(relative) from the float32 reference, the plain "
                         f"bf16 path {rel_plain}; limit {limit}")
    return {"rel_err_kernel_vs_f32": rel_kernel,
            "rel_err_plain_bf16_vs_f32": rel_plain, "limit": limit,
            "argmax_agreement_kernel_vs_f32": agree}


def e2e_row_verdict(torch, got, f32, bf16, label: str) -> dict:
    """``e2e_verdict`` request by request (``row_drift``): the kernel
    path's median request may be at most E2E_RATIO times as far from the
    float32 run as the bf16 plain run's median request, or E2E_FLOOR;
    raises otherwise.  Two bf16 runs whose sums round apart can pick
    another expert for a near-tied token, or be carried apart by a
    random-weight model's gains: that moves the requests it happens in,
    where a fault moves every one."""
    out = row_drift(torch, got, f32, bf16)
    med_k = out["median_rel_err_kernel_vs_f32"]
    med_p = out["median_rel_err_plain_bf16_vs_f32"]
    if not (math.isfinite(med_k) and med_k <= out["limit"]):
        raise SystemExit(f"{label}: the kernel path's median request is "
                         f"{med_k} (relative) from the float32 reference, "
                         f"the plain bf16 path's {med_p}; limit "
                         f"{out['limit']}")
    return out


def row_drift(torch, got, f32, bf16) -> dict:
    """``got`` (the kernel path), ``f32`` (a float32 plain run) and
    ``bf16`` (a bf16 plain run) are logits [steps + 1, R, V] of R
    requests: each request's relative Frobenius error from ``f32`` over
    its steps, the medians, the limit E2E_RATIO times the bf16 run's
    median (or E2E_FLOOR), and the whole runs' errors."""
    def rows(a):
        return (torch.linalg.vector_norm(a - f32, dim=(0, 2))
                / torch.linalg.vector_norm(f32, dim=(0, 2)))

    def rel(a):
        return float(torch.linalg.vector_norm(a - f32)
                     / torch.linalg.vector_norm(f32))

    rows_k, rows_p = rows(got), rows(bf16)
    med_k = float(torch.quantile(rows_k, 0.5))
    med_p = float(torch.quantile(rows_p, 0.5))
    limit = max(E2E_RATIO * med_p, E2E_FLOOR)
    return {"median_rel_err_kernel_vs_f32": med_k,
            "median_rel_err_plain_bf16_vs_f32": med_p, "limit": limit,
            "rel_err_kernel_vs_f32": rel(got),
            "rel_err_plain_bf16_vs_f32": rel(bf16),
            "rows_kernel": rows_k.tolist(), "rows_plain_bf16": rows_p.tolist(),
            "argmax_agreement_kernel_vs_f32": float(
                (got.argmax(-1) == f32.argmax(-1)).float().mean())}


class CastLayers(list):
    """A model's layers, each cast to ``dtype`` when the forward reads it
    (``params["layers"][i]``): a float32 run of a model whose float32
    copy would not fit the card beside its bf16 weights holds one layer's
    at a time."""

    def __init__(self, layers, dtype):
        super().__init__(layers)
        self.dtype = dtype

    def __getitem__(self, i):
        return _cast_params(list.__getitem__(self, i), self.dtype)


def plain_runs(torch, params, ctx, prompt, kernel=True, bf16=True, f32=True,
               f32_by_layer=False, frontend=None,
               steps: int = E2E_STEPS) -> dict:
    """``e2e_logits`` on one rank through the kernel path (with
    ``kernel``), the bf16 plain path (with ``bf16``) and a float32 plain
    run of the same weights (with ``f32``; with ``f32_by_layer``, each
    layer cast as it is read: ``CastLayers``), with ``frontend`` where
    the model takes one."""
    import dataclasses
    plain_ctx = dataclasses.replace(ctx, use_pallas=False, use_flash=False)
    f32_ctx = dataclasses.replace(
        plain_ctx, arch=dataclasses.replace(ctx.arch, dtype="float32"))

    def f32_params():
        if not f32_by_layer:
            return _cast_params(params, torch.float32)
        out = {k: _cast_params(v, torch.float32)
               for k, v in params.items() if k != "layers"}
        out["layers"] = CastLayers(params["layers"], torch.float32)
        return out

    runs = (("kernel", kernel, ctx, lambda: params),
            ("plain_bf16", bf16, plain_ctx, lambda: params),
            ("plain_f32", f32, f32_ctx, f32_params))
    return {name: e2e_logits(torch, make(), c, prompt, frontend=frontend,
                             steps=steps)
            for name, wanted, c, make in runs if wanted}


def end_to_end_check(torch, np, params, ctx):
    """The kernel path against a float32 plain reference on the card: one
    32-token prompt, prefill + 4 decode steps.  The bf16 plain path (no
    kernels) is measured against the same reference; the kernel path must
    be no further from it than E2E_RATIO times that, or E2E_FLOOR."""
    rng = np.random.default_rng(7)
    prompt = torch.as_tensor(rng.integers(0, ctx.arch.vocab_size,
                                          size=(1, E2E_PROMPT)),
                             dtype=torch.int32, device="cuda")
    logits = plain_runs(torch, params, ctx, prompt)
    return e2e_verdict(torch, logits["kernel"], logits["plain_f32"],
                       logits["plain_bf16"], "end to end")


def profile_steps(torch, params, ctx, world=None, scan=False,
                  bucket=BUCKET, cache_len=CACHE_LEN, frontend=None):
    """Step times (host clock around synchronized runs) and a
    torch.profiler breakdown of one prefill pack and one decode step at
    the serve phase's shapes (``bucket``, ``cache_len``; the pack with
    ``frontend`` [PACK, F, width] where the model takes one): device busy
    share and the top kernels by device time.  On a world each rank runs
    its rows of the pack and its slots, in step with the others.  A step
    runs 3 times warm, 10 times timed, once profiled.  With ``scan`` (a
    model that prefills by scanning ``bucket`` decode steps a pack) the
    pack runs once warm and once timed, and its profile records the
    card's activity alone: the host's operator events of ``bucket`` steps
    (some 10^5) are slow to sum."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode
    from repro_torch.serving import engine
    rank, n = (0, 1) if world is None else (world.rank, world.size)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, ctx.arch.vocab_size, (PACK, bucket),
                           generator=gen, device="cuda", dtype=torch.int32)
    rows = slice(rank * PACK // n, (rank + 1) * PACK // n)
    pack = {"tokens": tokens[rows]}
    if frontend is not None:
        pack["frontend"] = frontend[rows]
    tokens = tokens[rows]
    prefill = engine.make_prefill(ctx, with_cache=True, cache_len=cache_len)
    step = engine.make_decode_step(ctx)
    cache = decode.init_cache(ctx, NUM_SLOTS // n, cache_len)
    for layer in cache:
        if "pos" in layer["mixer"]:
            layer["mixer"]["pos"].fill_(bucket)
    cur = tokens[:, :1].repeat(NUM_SLOTS // PACK, 1)
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for name, fn, (warm, iters), activities in (
            ("prefill_pack", lambda: prefill(params, pack),
             (1, 1) if scan else (3, 10),
             [ProfilerActivity.CUDA] if scan else both),
            ("decode_step", lambda: step(params, cache, cur), (3, 10),
             both)):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = {
            "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "device_ms": dev_ms,
            "device_busy_share": dev_ms / prof_wall_ms,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:60], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}
    return out


def checks_wide(torch, params, ctx, gen, layer: int, name: str,
                gather_layouts: dict, one_rank: tuple) -> dict:
    """K4, K1, K2, K3 and K7 at a swiglu model's full width on layer
    ``layer``'s weights (its first MoE layer), each against its plain
    version: K4 at the serve's gather layouts (``gather_layouts``: label
    -> tokens a call) and at a one-rank layout (``one_rank``: label and
    global batch at seq TRAIN_SEQ; its first training batch's tokens
    through the embedding and the layers before, routed on the a2a plan:
    capacity segments with sentinel slots and dropped picks), with its
    compaction bit-equal at each; K1 (bit-equal), K2 (top-k picks a
    token) and K3 at ``staged_case``'s 2x2 rank-0 layout; K7 at
    ``pipelined_case``'s chunk 0 (the overlap model's chunk count at these
    widths).  ``name`` prefixes the checks' labels."""
    arch = ctx.arch
    k4, compaction = {}, []
    for label, Tg in gather_layouts.items():
        args, act = gather_k4_case(torch, params, ctx, Tg, gen, layer=layer)
        if act != "swiglu":
            raise SystemExit(f"{name} {label}: activation {act}")
        k4[label] = check_k4(torch, args, act, f"{name}_{label}")
        compaction.append(check_compaction(torch, args, f"{name}_{label}"))
        del args
    case = staged_case(torch, params, arch, gen, layer=layer)
    di = case["di"]
    k1 = check_k1(torch, case["x"], di.slot_to_token)
    k2 = check_k2(torch, torch.randn(
        (di.num_slots, arch.d_model), generator=gen,
        device="cuda").to(torch.bfloat16), di)
    k3 = check_k3(torch, case)
    layout = {"caps": list(case["caps"]), "S": di.num_slots,
              "T": case["x"].shape[0], "picks": di.inv_idx.shape[1],
              "experts_per_rank": case["w_in"].shape[0]}
    del case
    pcase = pipelined_case(torch, params, arch, gen, layer=layer,
                           chunks=None)
    k7 = check_k7(torch, pcase)
    del pcase
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    label, batch = one_rank
    tokens = SyntheticLM(DataConfig(
        vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ, global_batch=batch,
        seed=0)).batch(0)["tokens"].cuda()
    args, act = train1_k4_case(torch, params, arch, gen, layer=layer,
                               x=moe_rows(torch, params, ctx, tokens, layer),
                               global_batch=batch)
    k4[label] = check_k4(torch, args, act, f"{name}_{label}")
    compaction.append(check_compaction(torch, args, f"{name}_{label}"))
    T = args[0].shape[0]
    layout_1rank = {"T": T, "slots": args[1].numel(),
                    "segments": len(args[4]),
                    "sentinel_slots": int((args[1] >= T).sum()),
                    "valid_rows": int(args[5].sum()),
                    "dropped_picks": T * arch.moe.top_k
                    - int(args[5].sum())}
    del args
    return {"K4": k4, "K4_compaction": compaction, "K1": k1, "K2": k2,
            "K3": k3, "K7": k7, "layout_2x2": layout,
            f"layout_{label}": layout_1rank}


def checks_dsv2_lite(torch, params, ctx, gen) -> dict:
    """``checks_wide`` at DeepSeek-V2-Lite's full width (swiglu, d 2048, f
    1408, top-6 of 64) on layer DSV2_MOE_LAYER: K4 at the serve's decode
    (8 slots) and prefill (4 x 128) gather layouts and at
    train_dsv2_lite_d4's one-rank layout (batch 4)."""
    return checks_wide(torch, params, ctx, gen, DSV2_MOE_LAYER, "dsv2_lite",
                       {"decode": NUM_SLOTS, "prefill": PACK * BUCKET},
                       ("train_1rank", TRAIN_BATCH_1))


def serve_mix(torch, np, params, ctx, label: str, want_k4,
              scan=False, want_k5=lambda report: 0,
              make_requests=serve_requests, bucket=BUCKET,
              cache_len=CACHE_LEN, profile_frontend=None) -> dict:
    """The serve phase's request mix (``make_requests(rng, vocab, n)``,
    prompts padded to ``bucket`` in a cache of ``cache_len``) on one rank
    through ``ServingEngine.run``: a warm-up request, then the 8 requests
    with the counters set to 0 just before and read just after.  Every
    stream must get its whole budget inside the vocabulary; K4 must launch
    exactly ``want_k4(report)`` times, K5 ``want_k5(report)`` times (by
    default never) and every other kernel never.
    Returns tokens/s, peak memory and a profiled prefill pack and decode
    step (``profile_steps``; ``scan`` for a scan prefill; the pack with
    ``profile_frontend``)."""
    from repro_torch.kernels import backend
    from repro_torch.serving import engine
    arch = ctx.arch
    eng = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=NUM_SLOTS, cache_len=cache_len, prefill_pack=PACK,
        prompt_buckets=(bucket,)))
    rng = np.random.default_rng(0)
    eng.run(make_requests(rng, arch.vocab_size, 1))           # warm-up
    reqs = make_requests(rng, arch.vocab_size, NUM_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    report = eng.run(reqs)
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for st in report.streams:
        if st.evicted or len(st.generated) != st.request.max_new_tokens or \
                not all(0 <= t < arch.vocab_size for t in st.generated):
            raise SystemExit(f"{label} request {st.request.uid}: "
                             f"{len(st.generated)} of "
                             f"{st.request.max_new_tokens} tokens, or a "
                             f"token outside the vocabulary")
    if len(report.streams) != NUM_REQUESTS:
        raise SystemExit(f"{label}: {len(report.streams)} of "
                         f"{NUM_REQUESTS} streams finished")
    want = {k: 0 for k in backend.LAUNCHES}
    want["moe_fused.local_moe"] = want_k4(report)
    want["flash_attn.flash_attention"] = want_k5(report)
    if launches != want:
        raise SystemExit(f"{label}: launches {launches}, the path needs "
                         f"{want}")
    with torch.no_grad():
        prof = profile_steps(torch, params, ctx, scan=scan, bucket=bucket,
                             cache_len=cache_len, frontend=profile_frontend)
    return {"requests": len(report.streams),
            "new_tokens": report.total_new_tokens,
            "prompt_tokens": sum(len(r.tokens) for r in reqs),
            "decode_steps": report.decode_steps,
            "prefill_packs": report.prefill_calls,
            "wall_s": report.wall_time,
            "tokens_per_s": report.tokens_per_sec, "launches": launches,
            "max_memory_allocated_gb": peak, "profile": prof}


def e2e_prompt(torch, np, vocab: int):
    """The end-to-end checks' 32-token prompt (seed 7), [1, 32] on the
    card."""
    return torch.as_tensor(np.random.default_rng(7).integers(
        0, vocab, size=(1, E2E_PROMPT)), dtype=torch.int32, device="cuda")


def rel_err(torch, a, b) -> float:
    """Relative Frobenius distance of ``a`` from ``b``."""
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def serve_dsv2_lite(torch, np, params, ctx) -> dict:
    """Full-depth DeepSeek-V2-Lite on one rank: first the kernel path's
    logits (a 32-token prompt, prefill + 4 decode steps) against the bf16
    plain path's, with the limit of ``e2e_verdict`` from a float32 plain
    run that casts one layer at a time (``CastLayers``); then
    ``serve_mix``: K4 exactly once a MoE layer (26) of every prefill pack
    and decode step, every other kernel (K5 too: MLA attends in plain
    PyTorch) never."""
    arch = ctx.arch
    prompt = e2e_prompt(torch, np, arch.vocab_size)
    with torch.no_grad():
        logits = plain_runs(torch, params, ctx, prompt, f32_by_layer=True)
    e2e = e2e_verdict(torch, logits["kernel"], logits["plain_f32"],
                      logits["plain_bf16"], "serve_dsv2_lite end to end")
    e2e["rel_err_kernel_vs_plain_bf16"] = rel_err(
        torch, logits["kernel"], logits["plain_bf16"])
    del logits
    n_moe = arch.num_layers - arch.moe.first_dense
    out = serve_mix(torch, np, params, ctx, "serve_dsv2_lite",
                    lambda r: n_moe * (r.prefill_calls + r.decode_steps))
    return {"layers": arch.num_layers, "moe_layers": n_moe,
            "end_to_end": e2e, **out}


def e2e_dsv2_lite_d4(torch, np, params, ctx) -> dict:
    """The float32 three-way verdict (``e2e_verdict``: the kernel path,
    the bf16 plain path and a float32 plain run of a whole float32 copy)
    on DeepSeek-V2-Lite cut to DSV2_CUT_LAYERS layers at full width: the
    first layers of the serve phase's weights, the same prompt."""
    import dataclasses
    from repro_torch.models import model as model_lib
    arch = dataclasses.replace(ctx.arch, num_layers=DSV2_CUT_LAYERS)
    ctx4 = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                               aux_mode="none", seq_len=CACHE_LEN,
                               global_batch=NUM_SLOTS)
    params4 = dict(params, layers=params["layers"][:DSV2_CUT_LAYERS])
    prompt = e2e_prompt(torch, np, arch.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = plain_runs(torch, params4, ctx4, prompt)
    out = e2e_verdict(torch, logits["kernel"], logits["plain_f32"],
                      logits["plain_bf16"], "e2e_dsv2_lite_d4")
    return {"layers": DSV2_CUT_LAYERS, **out,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9}


def analysis_scenarios():
    """The analysis phase's collective scenarios: one MoE layer's forward
    at gpt3_medium_moe's widths (d 1024, 64 experts top-2 of f 2048,
    gelu, capacity factor 2, bf16) and the train_2x2 plan (1024 tokens a
    rank of the 2x2 world: a2a, a2a_pipelined in PIPELINED_CHUNKS chunks
    over the int8 wire, gather), and the one-rank fused path at
    train_1rank's 2048 tokens.  Returns ``(world scenarios, unit)``."""
    from repro_torch.analysis.collective_check import Scenario
    from repro_torch.configs.base import get_config
    arch = get_config(ARCH_ID)
    m = arch.moe

    def sc(name, sizes, path, tokens, **kw):
        return Scenario(name, sizes, path, None, tokens=tokens,
                        num_experts=m.num_experts, d_model=arch.d_model,
                        d_ff=m.d_ff_expert, top_k=m.top_k,
                        capacity_factor=m.capacity_factor, dtype=arch.dtype,
                        activation=arch.activation, **kw)

    t22 = TRAIN_BATCH_22 * TRAIN_SEQ // math.prod(WORLD_22)
    return ((sc("a2a-2x2", WORLD_22, "a2a", t22),
             sc("a2a_pipelined-2x2-int8", WORLD_22, "a2a_pipelined", t22,
                num_chunks=PIPELINED_CHUNKS, wire_codec="int8"),
             sc("gather-2x2", WORLD_22, "gather", t22)),
            sc("a2a-unit-mesh-fused", (1,), "a2a",
               TRAIN_BATCH_1 * TRAIN_SEQ))


#: the kernels each analysis scenario's forward must launch
ANALYSIS_KERNELS = {
    "a2a-2x2": ("moe_permute.permute", "moe_permute.unpermute",
                "moe_gemm.grouped_ffn_ragged"),
    "a2a_pipelined-2x2-int8": ("moe_permute.permute",
                               "moe_permute.unpermute",
                               "moe_gemm.grouped_ffn_ragged_quant"),
    "gather-2x2": ("moe_fused.local_moe",),
    "a2a-unit-mesh-fused": ("moe_fused.local_moe",)}


def inventory_rows(inventory) -> list:
    """A collective inventory as JSON rows [kind, dtype, elements,
    groups]."""
    return [[c.kind, c.dtype, c.elements, [list(g) for g in c.groups]]
            for c in inventory]


def analysis_rank(world, out_dir: str) -> None:
    """One rank of the analysis phase's 2x2 world: each scenario's
    forward through ``record_scenario`` on this rank's real world (the
    recorder passes every call through), kernels on; writes the
    inventories and launch counts to ``analysis<rank>.json``."""
    import torch
    from repro_torch.analysis import collective_check
    from repro_torch.kernels import backend
    out = {}
    for sc in analysis_scenarios()[0]:
        backend.reset_launches()
        inv = collective_check.record_scenario(sc, world, device="cuda")
        torch.cuda.synchronize()
        out[sc.name] = {"inventory": inventory_rows(inv),
                        "launches": dict(backend.LAUNCHES)}
    with open(os.path.join(out_dir, f"analysis{world.rank}.json"), "w") as fh:
        json.dump(out, fh)


def analysis_phase(torch, params, ctx, out_dir: str) -> dict:
    """The ``analysis`` phase (see the module docstring); raises on any
    violation.  The 2x2 world runs in its own processes while this one
    checks the rest."""
    import threading

    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis import collective_check, launch_check
    from repro_torch.kernels import backend
    from repro_torch.launch import dryrun, mesh
    from repro_torch.serving import engine

    t0 = time.time()
    world_err = []

    def run_world():
        try:
            mesh.spawn(analysis_rank, WORLD_22, "gloo", "cuda",
                       args=(out_dir,))
        except Exception as e:           # raised after the join
            world_err.append(e)

    world_thread = threading.Thread(target=run_world)
    world_thread.start()
    problems = []

    # the launch declarations against the compiled kernels and the card
    geo, geometry = launch_check.check_on_device()
    limits = launch_check.device_limits()
    problems += [f"{v.rule} {v.where}: {v.message}" for v in geo]

    # the checkers on the tree, as `python -m repro_torch.analysis` runs
    report_path = os.path.join(out_dir, "analysis_report.json")
    cli_rc = analysis_cli.main(["--json", report_path])
    with open(report_path) as fh:
        report = json.load(fh)
    if cli_rc != 0:
        problems.append(f"python -m repro_torch.analysis exited {cli_rc}: "
                        f"{report['violations'][:5]}")

    # one-process recordings on the card, kernels on
    scenarios, unit = analysis_scenarios()
    local = {}
    for sc in scenarios + (unit,):
        backend.reset_launches()
        inv = collective_check.record_scenario(sc, None, device="cuda")
        torch.cuda.synchronize()
        local[sc.name] = {"inventory": inv,
                          "launches": dict(backend.LAUNCHES)}

    # the meta dry-runs
    rec_4k, _ = dryrun.lower_one(ARCH_ID, "train_4k", "pod1")
    rec_1rank, _ = dryrun.lower_one(
        ARCH_ID, "train_1rank", (1,),
        shape={"seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
               "kind": "train"})

    # generate with and without the prebuilt triple, on the serve context
    # as the serve phase uses it (K4 and K5 on): every kernel of the path
    # sums in a fixed order, so a near-tied greedy pick of random weights
    # comes out the same in both runs
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, ctx.arch.vocab_size, (PACK, 32),
                           generator=gen, device="cuda", dtype=torch.int32)
    plain = engine.generate(params, ctx, prompt, steps=8,
                            cache_len=CACHE_LEN)
    fns = engine.make_generate_fns(ctx, CACHE_LEN)
    with_fns = engine.generate(params, ctx, prompt, steps=8,
                               cache_len=CACHE_LEN, fns=fns)
    if not torch.equal(plain.tokens, with_fns.tokens):
        problems.append("generate(fns=make_generate_fns(...)) gave other "
                        "greedy tokens than generate")

    world_thread.join()
    if world_err:
        raise SystemExit(f"analysis: the 2x2 world failed: {world_err[0]!r}")
    ranks = []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(out_dir, f"analysis{r}.json")) as fh:
            ranks.append(json.load(fh))

    inventories = {}
    for sc in scenarios + (unit,):
        exp = collective_check.expected_inventory(sc, device="cuda")
        mine = local[sc.name]
        problems += [f"{v.where} (one process): {v.message}"
                     for v in collective_check.match_inventory(
                         sc.name, exp, mine["inventory"])]
        runs = [mine["launches"]]
        for r, rk in enumerate(ranks if sc is not unit else ()):
            got = [collective_check.Collective(
                k, dt, n, tuple(tuple(g) for g in gs))
                for k, dt, n, gs in rk[sc.name]["inventory"]]
            problems += [f"{v.where} (rank {r}): {v.message}"
                         for v in collective_check.match_inventory(
                             sc.name, exp, got)]
            if r == 0 and rk[sc.name]["inventory"] != inventory_rows(
                    mine["inventory"]):
                problems.append(f"{sc.name}: rank 0's inventory on the "
                                f"world differs from the one-process "
                                f"recording")
            runs.append(rk[sc.name]["launches"])
        for name in ANALYSIS_KERNELS[sc.name]:
            if min(run[name] for run in runs) < 1:
                problems.append(f"{sc.name}: {name} launched "
                                f"{[run[name] for run in runs]} times")
        inventories[sc.name] = {
            "collectives": len(exp),
            "by_kind_dtype": sorted({(c.kind, c.dtype) for c in exp}),
            "launches_one_process": mine["launches"],
            "launches_world_rank0": (ranks[0][sc.name]["launches"]
                                     if sc is not unit else None)}
    if problems:
        raise SystemExit("analysis: " + "; ".join(problems[:20]))
    return {"seconds": time.time() - t0, "device_limits": limits,
            "geometry": geometry, "layouts_checked": sum(
                1 for _ in launch_check.registered()),
            "cli_rc": cli_rc, "cli_checked": {k: len(v) for k, v in
                                              report["checked"].items()},
            "inventories": inventories,
            "dryrun_train_4k_pod1": rec_4k,
            "dryrun_train_1rank": rec_1rank,
            "generate_fns_equal": True,
            "generate_tokens": plain.tokens.shape[1]}


def serve_rank(world, out_dir: str, arch_id: str = ARCH_ID,
               layers: int = WORLD_LAYERS,
               requests: int = NUM_REQUESTS) -> None:
    """One rank of a serving world (serve_2x2, serve_dsv2_2x2,
    serve_jamba_2x2): full-width ``arch_id`` from seed 0 at depth
    ``layers`` (``cut_depth``: the first layers of the full model's draw
    for gpt3_medium_moe and DeepSeek-V2-Lite; Jamba's group cut to a
    Mamba layer with a dense FFN, then attention with the MoE FFN; this
    rank's quarter of the experts a layer), ``ServeConfig`` as the serve
    phase's, the batch sharded over the world and every MoE layer through
    the gather path.  First the end-to-end check: the kernel path's
    logits against the one-rank float32 and bf16 plain runs the main
    process saved, for gpt3_medium_moe E2E_ROWS prompts (one a rank,
    gathered) by ``e2e_verdict`` (``e2e_reference.pt``), for the other
    families TP_FAMILY_DRAWS draws of them by ``e2e_row_verdict``
    (``e2e_<config>.pt``); then a warm-up request, then ``requests`` of
    the serve phase's mix with the launch counters set to 0 just before
    and read just after, then the prefill pack's and decode step's times
    on this rank (a model that prefills by scan: ``profile_steps``'s
    ``scan``).  Writes ``serve<rank>.json`` (gpt3_medium_moe) or
    ``serve_<config><rank>.json``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import backend
    from repro_torch.models import decode
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    arch = cut_depth(get_config(arch_id), layers)
    ctx = model_lib.build_ctx(arch, world, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    params = init_in_turns(torch, ctx, world)
    with torch.no_grad():
        if arch_id == ARCH_ID:
            ref = torch.load(os.path.join(out_dir, "e2e_reference.pt"))
            got = e2e_logits(torch, params, ctx, ref["prompt"].cuda(), world)
            e2e = e2e_verdict(torch, got, ref["plain_f32"].cuda(),
                              ref["plain_bf16"].cuda(),
                              "serve_2x2 end to end")
        else:
            draws = torch.load(os.path.join(out_dir, f"e2e_{arch_id}.pt"))
            got = torch.cat([e2e_logits(torch, params, ctx,
                                        d["prompt"].cuda(), world)
                             for d in draws], dim=1)
            e2e = e2e_row_verdict(
                torch, got,
                torch.cat([d["plain_f32"] for d in draws], 1).cuda(),
                torch.cat([d["plain_bf16"] for d in draws], 1).cuda(),
                f"serve_{arch_id} 2x2 end to end")
            e2e["greedy"] = got.argmax(-1).t().tolist()
    del got
    eng = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=NUM_SLOTS, cache_len=CACHE_LEN, prefill_pack=PACK,
        prompt_buckets=(BUCKET,)))
    rng = np.random.default_rng(0)
    eng.run(serve_requests(rng, arch.vocab_size, 1))          # warm-up
    reqs = serve_requests(rng, arch.vocab_size, requests)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    report = eng.run(reqs)
    launches = dict(backend.LAUNCHES)
    scan = decode._needs_scan_prefill(arch)
    with torch.no_grad():
        prof = profile_steps(torch, params, ctx, world, scan=scan)
    out = {"rank": world.rank, "coords": list(world.coords),
           "arch": arch_id, "layers": arch.num_layers, "scan_prefill": scan,
           "expert_range": list(ctx.expert_range), "end_to_end": e2e,
           "streams": {s.request.uid: s.generated for s in report.streams},
           "budgets": {s.request.uid: s.request.max_new_tokens
                       for s in report.streams},
           "evicted": sum(s.evicted for s in report.streams),
           "new_tokens": report.total_new_tokens,
           "prompt_tokens": sum(len(r.tokens) for r in reqs),
           "decode_steps": report.decode_steps,
           "prefill_packs": report.prefill_calls,
           "wall_s": report.wall_time,
           "tokens_per_s": report.tokens_per_sec, "launches": launches,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "profile": prof, "run_seconds": time.time() - t_start}
    name = "serve" if arch_id == ARCH_ID else f"serve_{arch_id}"
    with open(os.path.join(out_dir, f"{name}{world.rank}.json"), "w") as fh:
        json.dump(out, fh)


def init_in_turns(torch, ctx, world):
    """``model.init_params`` from seed 0 on each rank of ``world``, one
    rank after another, each freeing its transients (``empty_cache``)
    before the next starts: a rank draws every layer whole before it
    keeps its slice, and four ranks drawing DeepSeek-V2-236B's 160
    experts a layer at once would hold about 17 GB of transients each on
    the one card."""
    from repro_torch.models import model as model_lib
    params, token = None, torch.zeros(1, device="cuda")
    for r in range(world.size):
        if r == world.rank:
            params = model_lib.init_params(
                ctx, torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
        world.all_reduce_sum(token)
    return params


def world_session(world, out_dir: str, jobs: tuple) -> None:
    """One spawn of a world for several phases' rank functions in turn:
    each job ``(name, args)`` calls this module's ``name(world, out_dir,
    *args)``, and its tensors are freed before the next.  Every spawn of
    four gloo ranks costs 10-25 s of process start, CUDA contexts and
    process groups; the 2x2 phases pay it once."""
    import torch
    for name, args in jobs:
        globals()[name](world, out_dir, *args)
        gc.collect()
        torch.cuda.empty_cache()


def serve_world_want(arch, r: dict) -> dict:
    """The launches one rank of a serving world makes for ``arch`` in
    ``r``'s run: K4 once a MoE layer of every prefill pack (of every scan
    step, BUCKET a pack, for a model that prefills by scan) and decode
    step; K5 once an attention layer of every pack, but for MLA (which
    attends in plain PyTorch) and a scan prefill; nothing else."""
    from repro_torch.kernels import backend
    from repro_torch.models import transformer
    subs = transformer.layer_list(arch)
    n_moe = sum(s.ffn == "moe" for s in subs)
    packs = r["prefill_packs"] * (BUCKET if r["scan_prefill"] else 1)
    want = {k: 0 for k in backend.LAUNCHES}
    want["moe_fused.local_moe"] = n_moe * (packs + r["decode_steps"])
    if not r["scan_prefill"]:
        want["flash_attn.flash_attention"] = r["prefill_packs"] * sum(
            s.mixer == "attn" for s in subs)
    return want


def check_serving_world(ranks, arch, label: str, requests: int) -> None:
    """Every rank's streams complete, inside the vocabulary and equal to
    rank 0's; each rank's launches exactly ``serve_world_want``'s."""
    for r in ranks:
        if r["evicted"] or len(r["streams"]) != requests or any(
                len(toks) != r["budgets"][uid]
                or not all(0 <= t < arch.vocab_size for t in toks)
                for uid, toks in r["streams"].items()):
            raise SystemExit(f"{label} rank {r['rank']}: streams "
                             f"incomplete or outside the vocabulary")
        if r["streams"] != ranks[0]["streams"]:
            raise SystemExit(f"{label} rank {r['rank']}: its streams "
                             f"differ from rank 0's")
        want = serve_world_want(arch, r)
        if r["launches"] != want:
            raise SystemExit(f"{label} rank {r['rank']}: launches "
                             f"{r['launches']}, the path needs {want}")


def deepseek_phases(torch, np, trained: str) -> tuple:
    """The DeepSeek-V2-Lite phases (DSV2_ID, one rank): its full-width
    weights from seed 0, ``checks_dsv2_lite``, ``serve_dsv2_lite`` and
    ``e2e_dsv2_lite_d4`` in this process; the weights freed, then
    ``train_dsv2_lite_d4``'s report, ``trained`` (run in train_1rank's
    child process).  Emits each phase's line and returns ``(checks,
    serve, train report)``."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    t0 = time.time()
    arch_ds = get_config(DSV2_ID)
    ctx_ds = model_lib.build_ctx(arch_ds, device="cuda", use_flash=True,
                                 aux_mode="none", seq_len=CACHE_LEN,
                                 global_batch=NUM_SLOTS)
    params_ds = model_lib.init_params(
        ctx_ds, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "init_dsv2_lite", "arch": arch_ds.name,
          "source": arch_ds.source, "layers": arch_ds.num_layers,
          "params": model_lib.count_params(params_ds),
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "seconds": time.time() - t0})
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        ck_ds = checks_dsv2_lite(torch, params_ds, ctx_ds, gen)
    emit({"phase": "checks_dsv2_lite", "seconds": time.time() - t0,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9, **ck_ds})
    t0 = time.time()
    srv_ds = serve_dsv2_lite(torch, np, params_ds, ctx_ds)
    emit({"phase": "serve_dsv2_lite", "seconds": time.time() - t0,
          **srv_ds})
    t0 = time.time()
    e2e_ds = e2e_dsv2_lite_d4(torch, np, params_ds, ctx_ds)
    emit({"phase": "e2e_dsv2_lite_d4", "seconds": time.time() - t0,
          **e2e_ds})
    del params_ds
    gc.collect()
    torch.cuda.empty_cache()
    # one rank, depth cut to DSV2_CUT_LAYERS (run in train_1rank's child)
    with open(trained) as fh:
        tds = json.load(fh)
    n_moe_ds = DSV2_CUT_LAYERS - arch_ds.moe.first_dense
    check_ds = check_training(
        [tds], {k: (n_moe_ds * TRAIN_STEPS if k == "moe_fused.local_moe"
                    else 0) for k in backend.LAUNCHES},
        "train_dsv2_lite_d4")
    emit({"phase": "train_dsv2_lite_d4", "seconds": tds["run_seconds"],
          "arch": arch_ds.name, "depth_cut": f"{arch_ds.num_layers} -> "
          f"{DSV2_CUT_LAYERS}: AdamW's float32 moments of 15.5 B "
          f"parameters alone are 124 GB", "aux_mode": "ta",
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check_ds, **tds})
    return ck_ds, srv_ds, tds


def loss_jamba(torch, params, arch) -> dict:
    """One forward and loss through ``loss_fn`` on the one-rank ``a2a``
    path (``aux_mode="ta"``, seq TRAIN_SEQ, batch JAMBA_LOSS_BATCH; no
    backward: AdamW's float32 moments alone would not fit), through the
    kernels and through the plain path (``use_pallas=False``) on the same
    weights and batch.  The counters are set to 0 just before each run
    and read just after: the kernel path must launch K4 once a MoE layer
    and nothing else, the plain path nothing; the losses must be finite
    and within LOSS_RTOL.  This holds ``mamba_apply``'s parallel scan at
    full width on the card."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    ctx = model_lib.build_ctx(arch, seq_len=TRAIN_SEQ,
                              global_batch=JAMBA_LOSS_BATCH, aux_mode="ta",
                              dispatch="a2a", device="cuda")
    batch = {k: v.cuda() for k, v in SyntheticLM(DataConfig(
        vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=JAMBA_LOSS_BATCH, seed=0)).batch(0).items()}
    n_moe = sum(s.ffn == "moe" for s in transformer.layer_list(arch))
    runs = {}
    for name, c in (("kernel", ctx),
                    ("plain", dataclasses.replace(ctx, use_pallas=False))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, metrics = transformer.loss_fn(params, batch, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {"loss": float(loss), "wall_s": wall,
                      "launches": dict(backend.LAUNCHES),
                      "max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      **{k: torch.as_tensor(v).tolist()
                         for k, v in metrics.items() if k != "loss"}}
    want = {k: 0 for k in backend.LAUNCHES}
    if runs["plain"]["launches"] != want:
        raise SystemExit(f"loss_jamba_d4: the plain path launched "
                         f"{runs['plain']['launches']}")
    want["moe_fused.local_moe"] = n_moe
    if runs["kernel"]["launches"] != want:
        raise SystemExit(f"loss_jamba_d4: launches "
                         f"{runs['kernel']['launches']}, the path needs "
                         f"{want}")
    got, ref = runs["kernel"]["loss"], runs["plain"]["loss"]
    rel = abs(got - ref) / abs(ref)
    if not (math.isfinite(got) and rel <= LOSS_RTOL):
        raise SystemExit(f"loss_jamba_d4: kernel path loss {got}, plain "
                         f"path {ref} (relative {rel}, limit {LOSS_RTOL})")
    return {"seq_len": TRAIN_SEQ, "global_batch": JAMBA_LOSS_BATCH,
            "aux_mode": "ta", "dispatch": "a2a", "caps": list(ctx.plan.caps),
            "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
            "launches": runs["kernel"]["launches"], **runs}


def jamba_phases(torch, np) -> tuple:
    """The Jamba phases (JAMBA_ID at depth JAMBA_LAYERS, one rank), after
    every other model's weights are freed: the full-width weights from
    seed 0 (init_jamba_d4); ``checks_wide`` on layer JAMBA_MOE_LAYER at
    the decode (8 slots) and prefill-scan step (4 rows) gather layouts
    and the one-rank forward layout (checks_jamba); the kernel path's and
    the bf16 plain path's logits on the end-to-end prompt, then
    ``serve_mix``, prefilled by scan: K4 once a MoE layer of every scan
    step (BUCKET a pack) and decode step, K5 never (serve_jamba_d4); the
    float32 verdict on those logits, the float32 run one cast layer at a
    time (e2e_jamba_d4: a whole float32 copy beside the bf16
    weights would fill the card); and
    ``loss_jamba``.  Emits each phase's line and returns ``(checks,
    serve, loss)``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    t0 = time.time()
    full = get_config(JAMBA_ID)
    arch = cut_depth(full, JAMBA_LAYERS)
    ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    subs = transformer.layer_list(arch)
    n_moe = sum(s.ffn == "moe" for s in subs)
    emit({"phase": "init_jamba_d4", "arch": arch.name,
          "source": arch.source, "layers": arch.num_layers,
          "depth_cut": f"{full.num_layers} -> {JAMBA_LAYERS}: the whole "
          f"model is 51.3 B parameters, 103 GB in bf16",
          "attention_layers": [i for i, s in enumerate(subs)
                               if s.mixer == "attn"],
          "moe_layers": n_moe, "params": model_lib.count_params(params),
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "seconds": time.time() - t0})
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        ck = checks_wide(torch, params, ctx, gen, JAMBA_MOE_LAYER, "jamba",
                         {"decode": NUM_SLOTS, "prefill_scan": PACK},
                         ("forward_1rank", JAMBA_LOSS_BATCH))
    emit({"phase": "checks_jamba", "seconds": time.time() - t0,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9, **ck})
    t0 = time.time()
    prompt = e2e_prompt(torch, np, arch.vocab_size)
    with torch.no_grad():
        logits = plain_runs(torch, params, ctx, prompt, f32=False)
    srv = serve_mix(torch, np, params, ctx, "serve_jamba_d4",
                    lambda r: n_moe * (r.prefill_calls * BUCKET
                                       + r.decode_steps), scan=True)
    emit({"phase": "serve_jamba_d4", "seconds": time.time() - t0,
          "layers": arch.num_layers, "moe_layers": n_moe,
          "scan_steps_per_pack": BUCKET,
          "rel_err_kernel_vs_plain_bf16": rel_err(
              torch, logits["kernel"], logits["plain_bf16"]),
          "argmax_agreement_kernel_vs_plain_bf16": float(
              (logits["kernel"].argmax(-1)
               == logits["plain_bf16"].argmax(-1)).float().mean()), **srv})
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        f32 = plain_runs(torch, params, ctx, prompt, kernel=False,
                         bf16=False, f32_by_layer=True)["plain_f32"]
    e2e = e2e_verdict(torch, logits["kernel"], f32, logits["plain_bf16"],
                      "e2e_jamba_d4")
    emit({"phase": "e2e_jamba_d4", "seconds": time.time() - t0,
          "layers": arch.num_layers, **e2e,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})
    del logits, f32
    t0 = time.time()
    loss = loss_jamba(torch, params, arch)
    emit({"phase": "loss_jamba_d4", "seconds": time.time() - t0, **loss})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ck, srv, loss


def checks_dense(torch, gen) -> dict:
    """K5 and K8 at head dim 128 (and K5 at granite_3_2b's 64 with 8 KV
    heads) against their plain versions: K5 at each dense config's
    serving prefill shape and at the training length, timed beside SDPA,
    and windowed; K8 on the decode_32k cache with 8 KV heads of 128 and
    random lengths including 0 (exact zeros there), timed, and
    windowed."""
    from repro_torch.configs.base import get_config
    k5 = {}
    for aid in DENSE_IDS:
        a = get_config(aid)
        k5[aid] = check_k5(torch, (PACK, BUCKET, a.num_heads, a.head_dim_),
                           gen, kv_heads=a.num_kv_heads)
    k5_512 = check_k5(torch, (PACK, TRAIN_SEQ, 16, 128), gen, kv_heads=8)
    k5_edges = [check_k5(torch, (PACK, TRAIN_SEQ, 16, 128), gen, window=128,
                         kv_heads=8, timed=False),
                check_k5(torch, (2, 200, 24, 128), gen, window=70,
                         kv_heads=8, timed=False),
                check_k5(torch, (1, 77, 16, 128), gen, causal=False,
                         timed=False)]
    lengths = torch.randint(0, DECODE_L + 1, (DECODE_B,), generator=gen,
                            device="cuda")
    lengths[0], lengths[1], lengths[2] = DECODE_L, 1, 0
    k8 = check_k8(torch, gen, DECODE_B, DECODE_L, 16, 8, lengths=lengths,
                  timed=True, hd=128)
    gc.collect()
    torch.cuda.empty_cache()
    k8_edges = [check_k8(torch, gen, 4, 8192, 16, 8, window=4096, hd=128),
                check_k8(torch, gen, 4, 1000, 24, 8, lengths=[0, 1, 537,
                                                              1000], hd=128)]
    if not k8["zero_length_requests"]:
        raise SystemExit("checks_dense: K8's main check drew no length-0 "
                         "request")
    return {"K5": k5, "K5_S512": k5_512, "K5_edges": k5_edges, "K8": k8,
            "K8_edges": k8_edges}


def serve_dense(torch, np, aid: str) -> dict:
    """One dense config at full width and full depth on one rank, its
    bf16 weights from seed 0: ``serve_mix`` with ``use_flash=True`` (K5
    exactly once an attention layer of every prefill pack, every other
    kernel never; tokens/s, peak memory, a profiled prefill pack and
    decode step), then the float32 verdict (``e2e_verdict``) of the
    kernel path against a whole float32 copy's plain run, the bf16 plain
    path beside it.  Emits ``serve_<aid>`` and ``e2e_<aid>`` and returns
    the serve line."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    t0 = time.time()
    arch = get_config(aid)
    ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init = {"params": model_lib.count_params(params),
            "init_seconds": time.time() - t0}
    srv = serve_mix(torch, np, params, ctx, f"serve_{aid}", lambda r: 0,
                    want_k5=lambda r: arch.num_layers * r.prefill_calls)
    emit({"phase": f"serve_{aid}", "seconds": time.time() - t0,
          "arch": arch.name, "source": arch.source,
          "layers": arch.num_layers, "d_model": arch.d_model,
          "heads": arch.num_heads, "kv_heads": arch.num_kv_heads,
          "head_dim": arch.head_dim_, "vocab": arch.vocab_size,
          "norm": arch.norm, **init, **srv})
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = plain_runs(torch, params, ctx,
                            e2e_prompt(torch, np, arch.vocab_size))
    e2e = e2e_verdict(torch, logits["kernel"], logits["plain_f32"],
                      logits["plain_bf16"], f"e2e_{aid}")
    emit({"phase": f"e2e_{aid}", "seconds": time.time() - t0,
          "layers": arch.num_layers, **e2e,
          "rel_err_kernel_vs_plain_bf16": rel_err(
              torch, logits["kernel"], logits["plain_bf16"]),
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return srv


def train_dense_phase(out_path: str) -> None:
    """train_internlm2, in train_1rank's child process: full-width, full-depth
    DENSE_TRAIN_ID on one rank through ``trainer.train`` (AdamW,
    ``aux_mode="none"``, seq TRAIN_SEQ, batch TRAIN_BATCH_1, TRAIN_STEPS
    steps) on the plain ``_sdpa`` path, the launch counters set to 0 just
    before and read just after (every kernel must stay at 0); one more
    step under torch.profiler; then, from the state that leaves, one step
    on a copy with the full batch and one with ``microbatch=DENSE_MICRO``
    (float32 accumulation) on the same batch: their losses, which must
    agree within LOSS_RTOL.  Writes the report to ``out_path``."""
    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    arch = get_config(DENSE_TRAIN_ID)
    kw = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_1, warmup_steps=1,
              aux_mode="none", seed=0)
    run = RunConfig(**kw)
    ctx = model_lib.build_ctx(arch, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_1, aux_mode="none",
                              device="cuda")
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH_1, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    res = trainer.train(arch, run, None, steps=TRAIN_STEPS, log_every=1,
                        verbose=True, params=params, device="cuda")
    launches = dict(backend.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = shard_batch(data.batch(TRAIN_STEPS), None, "cuda")
    profiled = profile_train_step(torch, trainer.make_train_step(ctx, run),
                                  res.params, res.opt_state, batch)
    # one step each way from the same state, on the next batch
    batch = shard_batch(data.batch(TRAIN_STEPS + 1), None, "cuda")
    def one_step(mb, params, opt_state):
        step = trainer.make_train_step(ctx, RunConfig(**kw, microbatch=mb))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, _, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        return ({"loss": float(m["loss"]), "microbatch": mb,
                 "step_wall_s": time.perf_counter() - t0,
                 "max_memory_allocated_gb":
                     torch.cuda.max_memory_allocated() / 1e9},
                adamw.tree_leaves(params)[0].detach().float())

    p_copy = _clone_tree(res.params)
    for p in adamw.tree_leaves(p_copy):
        p.requires_grad_(True)
    o_copy = {k: (v if k == "step" else _clone_tree(v))
              for k, v in res.opt_state.items()}
    accum, leaf = {}, {}
    accum["full"], leaf["full"] = one_step(0, p_copy, o_copy)
    del p_copy, o_copy
    accum["microbatch"], leaf["microbatch"] = one_step(
        DENSE_MICRO, res.params, res.opt_state)
    diff = float((leaf["full"] - leaf["microbatch"]).abs().max())
    got, ref = accum["microbatch"]["loss"], accum["full"]["loss"]
    report = {"arch": arch.name, "layers": arch.num_layers,
              "params": model_lib.count_params(res.params),
              "losses": res.losses,
              "grad_norm": [h["grad_norm"] for h in res.metrics_history],
              "step_wall_s": res.step_seconds, "launches": launches,
              "max_memory_allocated_gb": peak_gb, "profiled_step": profiled,
              "accumulation": dict(
                  accum, loss_rel_diff=abs(got - ref) / abs(ref),
                  loss_rtol=LOSS_RTOL,
                  first_leaf_max_abs_diff_after_step=diff)}
    report["run_seconds"] = time.time() - t_start
    with open(out_path, "w") as fh:
        json.dump(report, fh)


def dense_phases(torch, np, trained: str) -> tuple:
    """The dense decoders (DENSE_IDS), after every other model's weights
    are freed: ``checks_dense``; ``serve_dense`` for each config in turn
    (its weights freed before the next); train_internlm2's report,
    ``trained`` (run in train_1rank's child process).  Emits each phase's
    line and returns ``(checks, {config: serve line}, train report)``."""
    from repro_torch.kernels import backend
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        ck = checks_dense(torch, gen)
    emit({"phase": "checks_dense", "seconds": time.time() - t0, **ck})
    gc.collect()
    torch.cuda.empty_cache()
    srv = {aid: serve_dense(torch, np, aid) for aid in DENSE_IDS}
    with open(trained) as fh:
        tr = json.load(fh)
    if tr["launches"] != {k: 0 for k in backend.LAUNCHES}:
        raise SystemExit(f"train_internlm2: launches {tr['launches']}, the "
                         f"plain training path needs none")
    if len(tr["losses"]) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in tr["losses"]):
        raise SystemExit(f"train_internlm2: losses {tr['losses']}")
    acc = tr["accumulation"]
    if not acc["loss_rel_diff"] <= LOSS_RTOL:
        raise SystemExit(f"train_internlm2: the accumulated step's loss "
                         f"{acc['microbatch']['loss']} against the full "
                         f"batch's {acc['full']['loss']}: relative "
                         f"{acc['loss_rel_diff']} > {LOSS_RTOL}")
    emit({"phase": "train_internlm2", "seconds": tr["run_seconds"],
          "aux_mode": "none", "attention": "plain _sdpa (K5 has no "
          "backward)", "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **tr})
    return ck, srv, tr


def frontend_of(np, arch, rng, n: int):
    """``n`` requests' frontend arrays [n, F, width] (float32 on the CPU)
    from the model's stub, or None for a model without a frontend."""
    if arch.frontend == "audio":
        from repro_torch.models import whisper
        return whisper.make_frames(rng, n, arch)
    if arch.frontend == "vision":
        from repro_torch.models import vlm
        return vlm.make_patches(rng, n, arch)
    return None


def family_requests(np, arch):
    """The serve mix's request maker for ``arch``: ``serve_requests``, each
    request with its own frontend array; a vision model's prompts lead
    with ``frontend_len`` tokens the patches take the place of."""
    def make(rng, vocab: int, n: int):
        reqs = serve_requests(rng, vocab, n)
        fr = frontend_of(np, arch, rng, n)
        for i, r in enumerate(reqs):
            if arch.frontend == "vision":
                lead = rng.integers(0, vocab, size=arch.frontend_len)
                r.tokens = lead.tolist() + r.tokens
            if fr is not None:
                r.frontend = fr[i]
        return reqs
    return make


def checks_families(torch, gen) -> dict:
    """K5 against its plain version at the two shapes the new families
    give it, timed beside SDPA (``enable_gqa`` for the GQA shape):
    Whisper's encoder [PACK, 1500, 6, 64], non-causal (1500 rows: the last
    query and key blocks are ragged), and InternVL2's prefill pack [PACK,
    VLM_BUCKET, 48, 128] over 8 KV heads (GQA 6:1), causal."""
    from repro_torch.configs.base import get_config
    w, v = get_config(WHISPER_ID), get_config(VLM_ID)
    return {
        "K5_whisper_encoder": check_k5(
            torch, (PACK, w.frontend_len, w.num_heads, w.head_dim_), gen,
            causal=False),
        "K5_internvl2_prefill": check_k5(
            torch, (PACK, VLM_BUCKET, v.num_heads, v.head_dim_), gen,
            kv_heads=v.num_kv_heads)}


def serve_family(torch, np, aid: str) -> dict:
    """One of FAMILY_IDS at full width on one rank (at FAMILY_LAYERS'
    depth where it names one, else at full depth), its bf16 weights from
    seed 0: the kernel path's and the bf16 plain path's
    logits on the end-to-end prompt (with its frontend), then
    ``serve_mix`` with ``use_flash=True`` and per-request frontends (K5
    exactly once an encoder layer (Whisper) or a layer (InternVL2) of
    every prefill pack, every other kernel never; xLSTM none), then the
    float32 verdict (``e2e_verdict``).  Emits ``serve_<aid>`` and
    ``e2e_<aid>`` and returns the serve line."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    t0 = time.time()
    arch = get_config(aid)
    arch = dataclasses.replace(
        arch, num_layers=FAMILY_LAYERS.get(aid, arch.num_layers))
    ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init = {"params": model_lib.count_params(params),
            "init_seconds": time.time() - t0}
    vision = arch.frontend == "vision"
    bucket, cache_len = ((VLM_BUCKET, VLM_CACHE_LEN) if vision
                         else (BUCKET, CACHE_LEN))
    rng = np.random.default_rng(7)
    prompt = torch.as_tensor(rng.integers(
        0, arch.vocab_size, size=(1, E2E_PROMPT + arch.frontend_len
                                  * vision)), dtype=torch.int32,
        device="cuda")
    e2e_fr = frontend_of(np, arch, rng, 1)
    e2e_fr = None if e2e_fr is None else e2e_fr.to("cuda")
    prof_fr = frontend_of(np, arch, rng, PACK)
    prof_fr = None if prof_fr is None else prof_fr.to("cuda")
    scan = arch.family != "vlm"
    with torch.no_grad():
        logits = plain_runs(torch, params, ctx, prompt, f32=False,
                            kernel=arch.family != "ssm", frontend=e2e_fr)
    if "kernel" not in logits:          # no hand-written kernel on the path
        logits["kernel"] = logits["plain_bf16"]
    per_pack = {"audio": arch.enc_layers, "vlm": arch.num_layers}.get(
        arch.family, 0)
    srv = serve_mix(torch, np, params, ctx, f"serve_{aid}", lambda r: 0,
                    scan=scan, want_k5=lambda r: per_pack * r.prefill_calls,
                    make_requests=family_requests(np, arch), bucket=bucket,
                    cache_len=cache_len, profile_frontend=prof_fr)
    emit({"phase": f"serve_{aid}", "seconds": time.time() - t0,
          "arch": arch.name, "source": arch.source, "family": arch.family,
          "layers": arch.num_layers, "enc_layers": arch.enc_layers,
          "d_model": arch.d_model, "heads": arch.num_heads,
          "kv_heads": arch.num_kv_heads, "head_dim": arch.head_dim_,
          "vocab": arch.vocab_size, "frontend": arch.frontend,
          "frontend_len": arch.frontend_len, "bucket": bucket,
          "cache_len": cache_len, "scan_prefill": scan,
          "k5_launches_per_pack": per_pack, **init, **srv})
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        f32 = plain_runs(torch, params, ctx, prompt, kernel=False,
                         bf16=False, f32_by_layer=vision,
                         frontend=e2e_fr)["plain_f32"]
    e2e = e2e_verdict(torch, logits["kernel"], f32, logits["plain_bf16"],
                      f"e2e_{aid}")
    emit({"phase": f"e2e_{aid}", "seconds": time.time() - t0,
          "layers": arch.num_layers, "prompt_tokens": prompt.shape[1],
          "kernel_path": ("the plain path: no hand-written kernel on it"
                          if arch.family == "ssm" else
                          "K5 (use_flash=True)"),
          "float32_run": ("cast one layer at a time" if vision
                          else "a whole float32 copy"), **e2e,
          "rel_err_kernel_vs_plain_bf16": rel_err(
              torch, logits["kernel"], logits["plain_bf16"]),
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})
    del params, logits, f32
    gc.collect()
    torch.cuda.empty_cache()
    return srv


def family_phases(torch, np) -> tuple:
    """The last three families (FAMILY_IDS), after every other model's
    weights are freed: ``checks_families``; ``serve_family`` for each in
    turn (its weights freed before the next).  Emits each phase's line
    and returns ``(checks, {config: serve line})``."""
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        ck = checks_families(torch, gen)
    emit({"phase": "checks_families", "seconds": time.time() - t0, **ck})
    gc.collect()
    torch.cuda.empty_cache()
    return ck, {aid: serve_family(torch, np, aid) for aid in FAMILY_IDS}


# ---------------------------------------------------------------------------
# tensor parallelism (serve_tp2, train_tp2)
# ---------------------------------------------------------------------------


class PickLog:
    """Records every gate's top-k picks while active (``gating.
    gate_forward`` wrapped) and digests them: two model ranks of one data
    rank must route alike, bit for bit."""

    def __init__(self):
        import hashlib
        self.hash, self.calls = hashlib.sha256(), 0

    def __enter__(self):
        from repro_torch.core import gating
        self._orig = orig = gating.gate_forward

        def rec(*a, **kw):
            out = orig(*a, **kw)
            self.hash.update(out["topk_idx"].to("cpu").numpy().tobytes())
            self.calls += 1
            return out
        gating.gate_forward = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.core import gating
        gating.gate_forward = self._orig

    def result(self) -> dict:
        return {"sha256": self.hash.hexdigest(), "gate_calls": self.calls}


def serve_tp_rank(world, out_dir: str) -> None:
    """One rank of serve_tp2 (a data 1 x model 2 world).  gpt3_medium_moe
    at depth WORLD_LAYERS from seed 0 (the rank's heads, expert columns and
    vocabulary rows of the one-rank model's draw) with ``use_flash``:
    the end-to-end logits of the E2E rows against the one-rank float32
    and bf16 plain runs the main process saved (``tp_reference.pt``),
    the top-k picks' digest of that run, a warm-up request, then the
    serve phase's requests with the launch counters set to 0 just before
    and read just after.  Then Minitron-4B at depth TP_DENSE_LAYERS: its
    end-to-end logits (prefill and TP_DENSE_STEPS decode steps) against
    its own one-rank runs, the counters around them.  Writes
    ``tp<process rank>.json``."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import backend
    from repro_torch.launch import analysis
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    ref = torch.load(os.path.join(out_dir, "tp_reference.pt"))
    arch = dataclasses.replace(get_config(ARCH_ID), num_layers=WORLD_LAYERS)
    ctx = model_lib.build_ctx(arch, world, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad(), PickLog() as picks:
        got = e2e_logits(torch, params, ctx, ref["gpt3"]["prompt"].cuda(),
                         world)
    e2e = e2e_verdict(torch, got, ref["gpt3"]["plain_f32"].cuda(),
                      ref["gpt3"]["plain_bf16"].cuda(),
                      "serve_tp2 end to end")
    greedy = got.argmax(-1).t().tolist()
    del got
    eng = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=NUM_SLOTS, cache_len=CACHE_LEN, prefill_pack=PACK,
        prompt_buckets=(BUCKET,)))
    rng = np.random.default_rng(0)
    eng.run(serve_requests(rng, arch.vocab_size, 1))          # warm-up
    reqs = serve_requests(rng, arch.vocab_size, NUM_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PickLog() as serve_picks:
        backend.reset_launches()
        report = eng.run(reqs)
        launches = dict(backend.LAUNCHES)
    gpt3 = {"end_to_end": e2e, "greedy": greedy, "picks": picks.result(),
            "serve_picks": serve_picks.result(),
            "streams": {s.request.uid: s.generated for s in report.streams},
            "budgets": {s.request.uid: s.request.max_new_tokens
                        for s in report.streams},
            "evicted": sum(s.evicted for s in report.streams),
            "new_tokens": report.total_new_tokens,
            "decode_steps": report.decode_steps,
            "prefill_packs": report.prefill_calls,
            "wall_s": report.wall_time,
            "tokens_per_s": report.tokens_per_sec, "launches": launches,
            "param_bytes": analysis.tree_bytes(params),
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}
    del params, eng, report
    gc.collect()
    torch.cuda.empty_cache()

    darch = dataclasses.replace(get_config(TP_DENSE_ID),
                                num_layers=TP_DENSE_LAYERS)
    dctx = model_lib.build_ctx(darch, world, device="cuda", use_flash=True,
                               aux_mode="none", seq_len=CACHE_LEN,
                               global_batch=E2E_ROWS)
    dparams = model_lib.init_params(
        dctx, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        got = e2e_logits(torch, dparams, dctx,
                         ref["dense"]["prompt"].cuda(), world,
                         steps=TP_DENSE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dlaunches = dict(backend.LAUNCHES)
    dense = {"end_to_end": e2e_verdict(
                 torch, got, ref["dense"]["plain_f32"].cuda(),
                 ref["dense"]["plain_bf16"].cuda(), "serve_tp2 minitron"),
             "greedy": got.argmax(-1).t().tolist(), "launches": dlaunches,
             "wall_s": wall,
             "tokens_per_s": E2E_ROWS * (TP_DENSE_STEPS + 1) / wall,
             "param_bytes": analysis.tree_bytes(dparams),
             "heads": dctx.attn_cfg.num_heads,
             "kv_heads": dctx.attn_cfg.num_kv_heads,
             "vocab_rows": dparams["embed"]["table"].shape[0]}
    out = {"process_rank": world.process_rank,
           "model_coord": world.model_coord, "gpt3": gpt3, "dense": dense}
    out["run_seconds"] = time.time() - t_start
    with open(os.path.join(out_dir, f"tp{world.process_rank}.json"),
              "w") as fh:
        json.dump(out, fh)


def _leaf(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def train_tp_rank(world, out_dir: str) -> None:
    """One rank of train_tp2: gpt3_medium_moe at depth WORLD_LAYERS
    from seed 0 (its slices of the one-rank draw), train_1rank's batch
    and run config.  First one forward and backward of the first batch
    through the kernel path: the synced gradients of TP_GRAD_LEAVES,
    gathered over the model axis, and the top-k picks' digest.  Then
    ``trainer.train`` for TP_TRAIN_STEPS steps with the launch counters
    set to 0 just before and read just after, and one more step under
    torch.profiler (busy share).  Then one step of the einsum baseline
    with ``use_moe_kernel`` (``aux_mode="lb"``, the first batch, the same
    draw): K6 once a layer at a model rank's f / 2, its loss and launches.
    Writes ``train_tp<process rank>.pt`` (the gradients) and ``.json``."""
    import dataclasses

    import torch
    from repro_torch import sharding
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.launch import analysis
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    arch = dataclasses.replace(get_config(ARCH_ID),
                               num_layers=WORLD_LAYERS)
    run = RunConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_1,
                    warmup_steps=1, aux_mode="ta", seed=0)
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_1, aux_mode="ta",
                              device="cuda")
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(run.seed))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH_1, seed=run.seed))
    b0 = shard_batch(data.batch(0), world, "cuda")
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    with PickLog() as picks:
        loss, _ = transformer.loss_fn(params, b0, ctx,
                                      aux_weight=run.aux_weight)
    (loss / world.size).backward()
    grads, _ = trainer.sync_grads(params, ctx)
    specs = dict(sharding._leaves_with_paths(model_lib.param_specs(
        model_lib.full_abstract_params(ctx), ctx)))
    got = {}
    for path in TP_GRAD_LEAVES:
        g = _leaf(grads, path)
        dim = sharding.model_dim(specs[path])
        got["/".join(path)] = (g if dim is None else
                               sharding.gather_from_model(g, world, dim)
                               ).float().cpu()
    first = {"loss": float(loss.detach()), "picks": picks.result(),
             "sliced": {"/".join(p): sharding.model_dim(specs[p]) is not None
                        for p in TP_GRAD_LEAVES}}
    for p in adamw.tree_leaves(params):
        p.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    res = trainer.train(arch, run, world, steps=TP_TRAIN_STEPS, log_every=1,
                        verbose=False, params=params, device="cuda")
    launches = dict(backend.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    param_bytes = analysis.tree_bytes(res.params)
    step = trainer.make_train_step(ctx, run)
    profiled = profile_train_step(
        torch, step, res.params, res.opt_state,
        shard_batch(data.batch(TP_TRAIN_STEPS), world, "cuda"))
    del step
    gc.collect()
    torch.cuda.empty_cache()
    # one step of the einsum baseline with the dense grouped FFN (K6 at a
    # model rank's f / 2), from the same draw and the first batch
    erun = dataclasses.replace(run, aux_mode="lb", dispatch="einsum")
    ectx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH_1, aux_mode="lb",
                               dispatch="einsum", use_moe_kernel=True,
                               device="cuda")
    eparams = model_lib.init_params(
        ectx, torch.Generator(device="cuda").manual_seed(run.seed))
    for p in adamw.tree_leaves(eparams):
        p.requires_grad_(True)
    eopt = adamw.init_state(eparams)
    estep = trainer.make_train_step(ectx, erun)
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    _, _, em = estep(eparams, eopt, b0)
    torch.cuda.synchronize()
    einsum = {"loss": float(em["loss"]), "launches": dict(backend.LAUNCHES),
              "step_wall_s": time.perf_counter() - t0}
    del eparams, eopt, estep
    rank = world.process_rank
    torch.save(got, os.path.join(out_dir, f"train_tp{rank}.pt"))
    with open(os.path.join(out_dir, f"train_tp{rank}.json"), "w") as fh:
        json.dump({"process_rank": rank, "model_coord": world.model_coord,
                   "run_seconds": time.time() - t_start,
                   "first": first, "losses": res.losses,
                   "grad_norm": [h["grad_norm"]
                                 for h in res.metrics_history],
                   "step_wall_s": res.step_seconds, "launches": launches,
                   "max_memory_allocated_gb": peak_gb,
                   "param_bytes": param_bytes, "einsum": einsum,
                   "profiled_step": {k: profiled[k] for k in (
                       "wall_ms", "device_ms", "device_busy_share",
                       "kernel_launches", "top", "port_kernels")}}, fh)


def tp_kernel_checks(torch, params, ctx, gen) -> dict:
    """K4, K5 and K6 at the layouts a model rank of the model-2 world
    gives them, against their plain versions, timed: K4 with layer 0's
    experts cut to their first f / TP_MODEL columns (w_in) and rows
    (w_out), at the gather path's decode (8 tokens) and prefill (one
    pack, 512) layouts over all 64 experts and at train_1rank's layout;
    K5 at gpt3's prefill pack with 8 of its 16 heads and at Minitron-4B's
    with 12 of 24 heads over 4 of 8 KV heads of 128; K6 at train_tp2's
    einsum step ([64, 128, 1024], f 1024)."""
    from repro_torch.configs.base import get_config

    def cut(args):
        x, tok, w, offs, exps, valid, w_in, w_gate, w_out = args
        f = w_in.shape[2] // TP_MODEL
        return (x, tok, w, offs, exps, valid, w_in[..., :f].contiguous(),
                None if w_gate is None else w_gate[..., :f].contiguous(),
                w_out[:, :f].contiguous())

    k4 = {}
    for label, Tg in (("decode", NUM_SLOTS), ("prefill", PACK * BUCKET)):
        args, act = gather_k4_case(torch, params, ctx, Tg, gen)
        k4[label] = check_k4(torch, cut(args), act, f"tp2_{label}")
    args, act = train1_k4_case(torch, params, ctx.arch, gen)
    k4["train_1rank"] = check_k4(torch, cut(args), act, "tp2_train_1rank")
    d = get_config(TP_DENSE_ID)
    k5 = {"gpt3_prefill": check_k5(
              torch, (PACK, BUCKET, 16 // TP_MODEL, 64), gen),
          "minitron_prefill": check_k5(
              torch, (PACK, BUCKET, d.num_heads // TP_MODEL, d.head_dim_),
              gen, kv_heads=d.num_kv_heads // TP_MODEL)}
    # K6 at train_tp2's einsum step: the [64, 128, 1024] buffer, each
    # expert's first f / TP_MODEL columns (w_in) and rows (w_out)
    x6, w_in6, w_out6, filled = einsum_k6_case(torch, params, ctx.arch, gen)
    f6 = w_in6.shape[2] // TP_MODEL
    k6 = check_k6(torch, x6, w_in6[..., :f6].contiguous(), None,
                  w_out6[:, :f6].contiguous(), f"tp2 f={f6}", filled)
    return {"K4": k4, "K5": k5, "K6": k6}


def tp_phases(torch, np) -> tuple:
    """The tensor-parallel phases, after every other model's weights are
    freed.  The main process first builds the one-rank references:
    gpt3 at depth WORLD_LAYERS (the TP layouts of K4, K5 and K6 checked
    on its weights, checks_tp2; its kernel, bf16 plain and float32 plain
    logits on the E2E rows), Minitron-4B at depth TP_DENSE_LAYERS (bf16
    and float32 plain logits), gpt3 at depth WORLD_LAYERS (the plain
    path's first-step loss and gradients, and the plain einsum path's
    first-step loss), and each of TP_FAMILIES on one rank (its kernel
    checks at a model rank's layouts and its float32 and bf16 plain runs
    of the E2E rows, checks_tp2_families).  Then one spawn of the (data
    1, model 2) world runs serve_tp2, train_tp2 and serve_tp2_families in
    turn, each held to its references here: launch counts exact, the
    model ranks' streams, picks and greedy tokens equal, the verdicts,
    the first-step losses within LOSS_RTOL.  Then ``checks_ep_tp`` (K1,
    K2, K3 and K7 at the EP x TP world's rank-0 layouts) and
    ``train_ep_tp`` on the (data 2, model 2) world: launch counts exact,
    each run's first-step loss within LOSS_RTOL (LOSS_RTOL_INT8 over the
    int8 wire) of the plain path's, the ranks' world-mean losses equal,
    the two model ranks of each data rank with bit-equal picks (the data
    ranks' differ), the checkpoint round trip bit-equal.  Returns
    ``(TP kernel checks, serve_tp2 ranks, train_tp2 ranks, EP x TP
    kernel checks, train_ep_tp ranks, family checks, serve_tp2_families
    ranks)``."""

    import dataclasses

    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.launch import analysis, mesh
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adamw

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        arch = dataclasses.replace(get_config(ARCH_ID),
                                   num_layers=WORLD_LAYERS)
        ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                                  aux_mode="none", seq_len=CACHE_LEN,
                                  global_batch=NUM_SLOTS)
        params = model_lib.init_params(
            ctx, torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(9)
        with torch.no_grad():
            checks = tp_kernel_checks(torch, params, ctx, gen)
        prompt = torch.as_tensor(np.random.default_rng(8).integers(
            0, arch.vocab_size, size=(E2E_ROWS, E2E_PROMPT)),
            dtype=torch.int32, device="cuda")
        with torch.no_grad():
            ref = {"gpt3": plain_runs(torch, params, ctx, prompt)}
        ref["gpt3"]["prompt"] = prompt
        one_rank_bytes = analysis.tree_bytes(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        darch = dataclasses.replace(get_config(TP_DENSE_ID),
                                    num_layers=TP_DENSE_LAYERS)
        dctx = model_lib.build_ctx(darch, device="cuda", use_flash=True,
                                   aux_mode="none", seq_len=CACHE_LEN,
                                   global_batch=E2E_ROWS)
        dparams = model_lib.init_params(
            dctx, torch.Generator(device="cuda").manual_seed(0))
        dprompt = torch.as_tensor(np.random.default_rng(8).integers(
            0, darch.vocab_size, size=(E2E_ROWS, E2E_PROMPT)),
            dtype=torch.int32, device="cuda")
        with torch.no_grad():
            ref["dense"] = plain_runs(torch, dparams, dctx, dprompt,
                                      steps=TP_DENSE_STEPS)
        ref["dense"]["prompt"] = dprompt
        dense_one_rank_bytes = analysis.tree_bytes(dparams)
        del dparams
        gc.collect()
        torch.cuda.empty_cache()
        torch.save({m: {k: v.cpu() for k, v in r.items()}
                    for m, r in ref.items()},
                   os.path.join(tmp, "tp_reference.pt"))
        ref_greedy = {m: r["kernel" if "kernel" in r else "plain_bf16"]
                      .argmax(-1).t().tolist() for m, r in ref.items()}
        del ref
        emit({"phase": "checks_tp2", "seconds": time.time() - t0, **checks})

        # train_tp2's references: the one-rank plain path's first step
        tarch = dataclasses.replace(get_config(ARCH_ID),
                                    num_layers=WORLD_LAYERS)
        run = RunConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_1,
                        warmup_steps=1, aux_mode="ta", seed=0)
        pctx = model_lib.build_ctx(tarch, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH_1,
                                   aux_mode="ta", use_pallas=False,
                                   device="cuda")
        tparams = model_lib.init_params(
            pctx, torch.Generator(device="cuda").manual_seed(run.seed))
        for p in adamw.tree_leaves(tparams):
            p.requires_grad_(True)
        data = SyntheticLM(DataConfig(vocab_size=tarch.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH_1,
                                      seed=run.seed))
        backend.reset_launches()
        os.environ[backend.ENV_VAR] = "0"
        try:
            loss, _ = transformer.loss_fn(
                tparams, shard_batch(data.batch(0), None, "cuda"), pctx,
                aux_weight=run.aux_weight)
            loss.backward()
        finally:
            del os.environ[backend.ENV_VAR]
        if any(backend.LAUNCHES.values()):
            raise SystemExit(f"train_tp2's plain path launched "
                             f"{dict(backend.LAUNCHES)}")
        plain_loss = float(loss.detach())
        plain_grads = {"/".join(p): _leaf(tparams, p).grad.float()
                       for p in TP_GRAD_LEAVES}
        # the einsum step's first loss on one rank, plain (grouped_ffn_ref)
        ectx = model_lib.build_ctx(tarch, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH_1, aux_mode="lb",
                                   dispatch="einsum", use_moe_kernel=True,
                                   use_pallas=False, device="cuda")
        os.environ[backend.ENV_VAR] = "0"
        try:
            with torch.no_grad():
                eloss, _ = transformer.loss_fn(
                    tparams, shard_batch(data.batch(0), None, "cuda"), ectx,
                    aux_weight=run.aux_weight)
        finally:
            del os.environ[backend.ENV_VAR]
        if any(backend.LAUNCHES.values()):
            raise SystemExit(f"train_tp2's plain einsum path launched "
                             f"{dict(backend.LAUNCHES)}")
        plain_einsum_loss = float(eloss)
        del tparams, loss, eloss
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        fck, fam_bytes, fam_greedy = {}, {}, {}
        gen = torch.Generator(device="cuda").manual_seed(13)
        for aid, depth in TP_FAMILIES:
            farch = tp_family_of(aid, depth)
            fctx = model_lib.build_ctx(farch, device="cuda", use_flash=True,
                                       aux_mode="none", seq_len=CACHE_LEN,
                                       global_batch=E2E_ROWS)
            fparams = model_lib.init_params(
                fctx, torch.Generator(device="cuda").manual_seed(0))
            draws = []
            with torch.no_grad():
                fck[aid] = tp_family_checks(torch, aid, fparams, fctx, gen)
                for draw in range(TP_FAMILY_DRAWS):
                    prompt, fe = tp_family_prompt(torch, np, farch, draw)
                    runs = plain_runs(torch, fparams, fctx, prompt,
                                      kernel=False, frontend=fe,
                                      steps=TP_FAMILY_STEPS)
                    draws.append({"prompt": prompt.cpu(),
                                  "frontend": None if fe is None else fe.cpu(),
                                  **{k: v.cpu() for k, v in runs.items()}})
            fam_bytes[aid] = analysis.tree_bytes(fparams)
            fam_greedy[aid] = torch.cat([d["plain_f32"] for d in draws],
                                        1).argmax(-1).t().tolist()
            torch.save(draws, os.path.join(tmp, f"tp_family_{aid}.pt"))
            del fparams, runs, draws
            gc.collect()
            torch.cuda.empty_cache()
        emit({"phase": "checks_tp2_families", "seconds": time.time() - t0,
              **fck})

        # one spawn of the (data 1, model 2) world for serve_tp2, train_tp2
        # and serve_tp2_families (``world_session``)
        t0 = time.time()
        mesh.spawn(world_session, TP_WORLD, "gloo", "cuda", args=(tmp, (
            ("serve_tp_rank", ()), ("train_tp_rank", ()),
            ("serve_tp_family_rank", ()))), model=TP_MODEL)
        session_s = time.time() - t0

        srv = []
        for r in range(math.prod(TP_WORLD) * TP_MODEL):
            with open(os.path.join(tmp, f"tp{r}.json")) as fh:
                srv.append(json.load(fh))
        for r in srv:
            g, dn = r["gpt3"], r["dense"]
            if g["evicted"] or len(g["streams"]) != NUM_REQUESTS or any(
                    len(toks) != g["budgets"][uid]
                    or not all(0 <= t < arch.vocab_size for t in toks)
                    for uid, toks in g["streams"].items()):
                raise SystemExit(f"serve_tp2 rank {r['process_rank']}: "
                                 f"streams incomplete or outside the "
                                 f"vocabulary")
            for key in ("streams", "greedy", "picks", "serve_picks"):
                if g[key] != srv[0]["gpt3"][key]:
                    raise SystemExit(f"serve_tp2 rank {r['process_rank']}: "
                                     f"its {key} differ from rank 0's")
            if g["picks"]["gate_calls"] != WORLD_LAYERS * (E2E_STEPS + 1):
                raise SystemExit(f"serve_tp2: {g['picks']['gate_calls']} "
                                 f"gate calls recorded")
            want = {k: 0 for k in backend.LAUNCHES}
            want["moe_fused.local_moe"] = WORLD_LAYERS * (g["prefill_packs"]
                                                        + g["decode_steps"])
            want["flash_attn.flash_attention"] = (WORLD_LAYERS
                                                  * g["prefill_packs"])
            if g["launches"] != want:
                raise SystemExit(f"serve_tp2 rank {r['process_rank']}: "
                                 f"launches {g['launches']}, the path "
                                 f"needs {want}")
            want = {k: 0 for k in backend.LAUNCHES}
            want["flash_attn.flash_attention"] = TP_DENSE_LAYERS
            if dn["launches"] != want:
                raise SystemExit(f"serve_tp2 minitron rank "
                                 f"{r['process_rank']}: launches "
                                 f"{dn['launches']}, the path needs {want}")
            if dn["greedy"] != srv[0]["dense"]["greedy"]:
                raise SystemExit("serve_tp2 minitron: the ranks' greedy "
                                 "tokens differ")
        emit({"phase": "serve_tp2",
              "seconds": max(r["run_seconds"] for r in srv),
              "session_seconds": session_s,
              "world": list(TP_WORLD), "model": TP_MODEL,
              "backend": "gloo", "layers": WORLD_LAYERS,
              "one_rank_param_bytes": one_rank_bytes,
              "greedy_model1_kernel": ref_greedy["gpt3"],
              "dense": {"arch": TP_DENSE_ID, "layers": TP_DENSE_LAYERS,
                        "decode_steps": TP_DENSE_STEPS,
                        "one_rank_param_bytes": dense_one_rank_bytes,
                        "greedy_model1_plain_bf16": ref_greedy["dense"]},
              "ranks": srv})

        trn = []
        for r in range(math.prod(TP_WORLD) * TP_MODEL):
            with open(os.path.join(tmp, f"train_tp{r}.json")) as fh:
                rep = json.load(fh)
            got = torch.load(os.path.join(tmp, f"train_tp{r}.pt"))
            rep["grads"] = {}
            for name, want in plain_grads.items():
                g = got[name].cuda()
                if g.shape != want.shape:
                    raise SystemExit(f"train_tp2: {name} gathered to "
                                     f"{tuple(g.shape)}, the model has "
                                     f"{tuple(want.shape)}")
                err = float((g - want).abs().max())
                lim = BWD_BF16_ATOL + BWD_BF16_RTOL * float(want.abs().max())
                if not err <= lim:
                    raise SystemExit(f"train_tp2 rank {r}: {name}'s "
                                     f"gradient is {err} from the one-rank "
                                     f"plain path's, limit {lim}")
                rep["grads"][name] = {"max_abs_err": err, "limit": lim,
                                      "max_abs": float(want.abs().max())}
            want = {k: 0 for k in backend.LAUNCHES}
            want["moe_fused.local_moe"] = WORLD_LAYERS * TP_TRAIN_STEPS
            if rep["launches"] != want:
                raise SystemExit(f"train_tp2 rank {r}: launches "
                                 f"{rep['launches']}, the path needs {want}")
            if len(rep["losses"]) != TP_TRAIN_STEPS or not all(
                    math.isfinite(v) for v in rep["losses"]):
                raise SystemExit(f"train_tp2 rank {r}: losses "
                                 f"{rep['losses']}")
            if (rep["losses"] != trn[0]["losses"] if trn else False) or (
                    trn and rep["first"]["picks"] != trn[0]["first"]["picks"]):
                raise SystemExit("train_tp2: the model ranks' losses or "
                                 "picks differ")
            trn.append(rep)
        first = trn[0]["losses"][0]
        rel = abs(first - plain_loss) / abs(plain_loss)
        if not rel <= LOSS_RTOL:
            raise SystemExit(f"train_tp2: first-step loss {first} (model 2, "
                             f"kernels) vs {plain_loss} (one rank, plain): "
                             f"relative {rel} > {LOSS_RTOL}")
        want_e = {k: 0 for k in backend.LAUNCHES}
        want_e["moe_gemm.grouped_ffn"] = WORLD_LAYERS
        for rep in trn:
            e = rep["einsum"]
            if e["launches"] != want_e or e["loss"] != trn[0]["einsum"]["loss"]:
                raise SystemExit(f"train_tp2 einsum process "
                                 f"{rep['process_rank']}: launches "
                                 f"{e['launches']} (the path needs {want_e}),"
                                 f" or the model ranks' losses differ")
        efirst = trn[0]["einsum"]["loss"]
        erel = abs(efirst - plain_einsum_loss) / abs(plain_einsum_loss)
        if not erel <= LOSS_RTOL:
            raise SystemExit(f"train_tp2 einsum: first-step loss {efirst} "
                             f"(model 2, K6) vs {plain_einsum_loss} (one "
                             f"rank, plain): relative {erel} > {LOSS_RTOL}")
        emit({"phase": "train_tp2",
              "seconds": max(r["run_seconds"] for r in trn),
              "session_seconds": session_s,
              "world": list(TP_WORLD), "model": TP_MODEL, "backend": "gloo",
              "layers": WORLD_LAYERS, "seq_len": TRAIN_SEQ,
              "global_batch": TRAIN_BATCH_1, "steps": TP_TRAIN_STEPS,
              "first_loss_kernel": first, "first_loss_plain_model1":
              plain_loss, "rel_diff": rel, "rtol": LOSS_RTOL,
              "einsum": {"aux_mode": "lb", "use_moe_kernel": True,
                         "first_loss_kernel": efirst,
                         "first_loss_plain_model1": plain_einsum_loss,
                         "rel_diff": erel, "want_launches": want_e},
              "grad_atol": BWD_BF16_ATOL, "grad_rtol": BWD_BF16_RTOL,
              "ranks": trn})
        fam_srv = []
        for r in range(math.prod(TP_WORLD) * TP_MODEL):
            with open(os.path.join(tmp, f"fam{r}.json")) as fh:
                fam_srv.append(json.load(fh))
        families = {}
        for aid, depth in TP_FAMILIES:
            farch = tp_family_of(aid, depth)
            want = tp_family_want(farch)
            for r in fam_srv:
                got = r["families"][aid]
                if got["launches"] != want:
                    raise SystemExit(f"serve_tp2_families {aid} process "
                                     f"{r['process_rank']}: launches "
                                     f"{got['launches']}, the path needs "
                                     f"{want}")
                for key in ("greedy", "picks"):
                    if got[key] != fam_srv[0]["families"][aid][key]:
                        raise SystemExit(f"serve_tp2_families {aid}: the "
                                         f"model ranks' {key} differ")
            g = fam_srv[0]["families"][aid]
            if farch.is_moe and g["picks"]["gate_calls"] == 0:
                raise SystemExit(f"serve_tp2_families {aid}: no gate call "
                                 f"recorded")
            families[aid] = {
                "layers": depth, "want_launches": want,
                "one_rank_param_bytes": fam_bytes[aid],
                "param_bytes_share": g["param_bytes"] / fam_bytes[aid],
                "greedy_model1_f32": fam_greedy[aid]}
        emit({"phase": "serve_tp2_families",
              "seconds": max(r["run_seconds"] for r in fam_srv),
              "session_seconds": session_s,
              "world": list(TP_WORLD), "model": TP_MODEL, "backend": "gloo",
              "prompt_rows": E2E_ROWS, "draws": TP_FAMILY_DRAWS,
              "decode_steps": TP_FAMILY_STEPS,
              "families": families, "ranks": fam_srv})
        t0 = time.time()
        arch = tp_family_of(ARCH_ID, 1)
        ctx = model_lib.build_ctx(arch, device="cuda", aux_mode="ta",
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH_22)
        params = model_lib.init_params(
            ctx, torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(12)
        with torch.no_grad():
            ck_ep = ep_tp_kernel_checks(torch, params, arch, gen)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "checks_ep_tp", "seconds": time.time() - t0,
              "world": list(EP_TP_WORLD), "model": TP_MODEL, **ck_ep})

        t0 = time.time()
        mesh.spawn(train_ep_tp_rank, EP_TP_WORLD, "gloo", "cuda",
                   args=(tmp,), model=TP_MODEL)
        trn_ep = []
        for r in range(math.prod(EP_TP_WORLD) * TP_MODEL):
            with open(os.path.join(tmp, f"ep_tp{r}.json")) as fh:
                trn_ep.append(json.load(fh))
        verdicts = {}
        for label, steps, per, rtol in (
                ("a2a", EP_TP_STEPS, {"moe_permute.permute": 1,
                                      "moe_permute.unpermute": 1,
                                      "moe_gemm.grouped_ffn_ragged": 1},
                 LOSS_RTOL),
                ("pipelined_int8", EP_TP_PIPELINED_STEPS,
                 {"moe_permute.permute": 1, "moe_permute.unpermute": 1,
                  "moe_gemm.grouped_ffn_ragged_quant": 1},
                 LOSS_RTOL_INT8)):
            chunks = trn_ep[0][label]["a2a_num_chunks"]
            want = {k: per.get(k, 0) * WORLD_LAYERS * steps * chunks
                    for k in backend.LAUNCHES}
            for r in trn_ep:
                rec = r[label]
                if any(rec["plain_launches"].values()):
                    raise SystemExit(f"train_ep_tp {label} process "
                                     f"{r['process_rank']}: the plain path "
                                     f"launched {rec['plain_launches']}")
                if rec["launches"] != want:
                    raise SystemExit(f"train_ep_tp {label} process "
                                     f"{r['process_rank']}: launches "
                                     f"{rec['launches']}, the path needs "
                                     f"{want}")
                if len(rec["losses"]) != steps or not all(
                        math.isfinite(v) for v in rec["losses"]):
                    raise SystemExit(f"train_ep_tp {label}: losses "
                                     f"{rec['losses']}")
                if (rec["losses"] != trn_ep[0][label]["losses"]
                        or rec["a2a_num_chunks"] != chunks):
                    raise SystemExit(f"train_ep_tp {label}: the processes' "
                                     f"world-mean losses or chunk counts "
                                     f"differ")
            picks = [r[label]["picks"] for r in trn_ep]
            if (picks[0] != picks[1] or picks[2] != picks[3]
                    or picks[0] == picks[2]):
                raise SystemExit(f"train_ep_tp {label}: the model ranks' "
                                 f"top-k picks differ (or the data ranks' "
                                 f"agree): {picks}")
            first = trn_ep[0][label]["losses"][0]
            plain = trn_ep[0][label]["plain_first_loss"]
            rel = abs(first - plain) / abs(plain)
            if not rel <= rtol:
                raise SystemExit(f"train_ep_tp {label}: first-step loss "
                                 f"{first} (kernels) vs {plain} (plain): "
                                 f"relative {rel} > {rtol}")
            verdicts[label] = {"first_loss_kernel": first,
                               "first_loss_plain": plain, "rel_diff": rel,
                               "rtol": rtol, "chunks": chunks,
                               "want_launches": want}
        for r in trn_ep:
            c = r["a2a"]["checkpoint"]
            if not (c["verified"] and c["bit_equal"]
                    and c["step"] == c["saved_step"]):
                raise SystemExit(f"train_ep_tp process {r['process_rank']}: "
                                 f"checkpoint round trip {c}")
        emit({"phase": "train_ep_tp", "seconds": time.time() - t0,
              "world": list(EP_TP_WORLD), "model": TP_MODEL,
              "backend": "gloo", "layers": WORLD_LAYERS,
              "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_22,
              "steps": {"a2a": EP_TP_STEPS,
                        "pipelined_int8": EP_TP_PIPELINED_STEPS},
              **verdicts, "ranks": trn_ep})

    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return checks, srv, trn, ck_ep, trn_ep, fck, fam_srv


# ---------------------------------------------------------------------------
# tensor parallelism on an EP x TP world and the other families
# (train_ep_tp, serve_tp2_families)
# ---------------------------------------------------------------------------


def _cut_width(case: dict) -> dict:
    """A ``staged_case`` / ``pipelined_case`` with its experts cut to a
    model rank's width: the first f / TP_MODEL columns of ``w_in`` (and
    ``w_gate``) and rows of ``w_out``, as ``model.shard_params`` gives
    model coordinate 0."""
    f = case["w_in"].shape[2] // TP_MODEL
    out = dict(case)
    out["w_in"] = case["w_in"][..., :f].contiguous()
    out["w_out"] = case["w_out"][:, :f].contiguous()
    if case["w_gate"] is not None:
        out["w_gate"] = case["w_gate"][..., :f].contiguous()
    return out


def ep_tp_kernel_checks(torch, params, arch, gen) -> dict:
    """K1, K2, K3 and K7 at rank 0's layouts of the EP x TP world
    (EP_TP_WORLD x TP_MODEL: 32 experts a rank, each at f 1024), against
    their plain versions, timed, with bounds (K1 and K2 without their
    call, host and library readings, which the 2x2 layouts give): the a2a
    plan's staged
    layout (``staged_case(sizes=EP_TP_WORLD)``: one stage of 2 ranks,
    caps (128,), S = 8192) for K1, K2 and K3, and chunk 0 of the
    pipelined int8 plan (the overlap model's 8 chunks: S = 1024) for K7,
    on layer 0's experts cut to a model rank's width."""
    out, seconds = {}, {}
    case = _cut_width(staged_case(torch, params, arch, gen,
                                  sizes=EP_TP_WORLD,
                                  global_batch=TRAIN_BATCH_22))
    di = case["di"]
    t0 = time.time()
    out["K1"] = check_k1(torch, case["x"], di.slot_to_token, full=False)
    out["K2"] = check_k2(torch, torch.randn(
        (di.num_slots, case["x"].shape[1]), generator=gen,
        device="cuda").to(torch.bfloat16), di, full=False)
    seconds["K1_K2"], t0 = time.time() - t0, time.time()
    out["K3"] = check_k3(torch, case)
    seconds["K3"] = time.time() - t0
    out["layout"] = {"caps": list(case["caps"]), "S": di.num_slots,
                     "T": case["x"].shape[0], "f": case["w_in"].shape[2],
                     "experts_per_rank": case["w_in"].shape[0]}
    del case
    pcase = _cut_width(pipelined_case(
        torch, params, arch, gen, chunks=None, sizes=EP_TP_WORLD,
        global_batch=TRAIN_BATCH_22))
    pdi = pcase["di"]
    t0 = time.time()
    out["K7"] = check_k7(torch, pcase)
    seconds["K7"] = time.time() - t0
    out["check_seconds"] = seconds
    out["layout_chunk0"] = {"chunks": pcase["chunks"], "S": pdi.num_slots,
                            "chunk_caps": pcase["chunk_caps"],
                            "f": pcase["w_in"].shape[2]}
    return out


def train_ep_tp_rank(world, out_dir: str) -> None:
    """One rank of train_ep_tp (EP_TP_WORLD x TP_MODEL: the experts over
    ``data``, each expert's width over ``model``).  gpt3_medium_moe at
    depth WORLD_LAYERS from seed 0 (the rank's expert shard and model
    slices of the one-rank draw), TRAIN_BATCH_22 rows at TRAIN_SEQ,
    ``aux_mode="ta"``, run twice: EP_TP_STEPS steps of ``a2a`` (K1 -> the
    all-to-all -> K3 -> the all-to-all -> K2) and EP_TP_PIPELINED_STEPS of
    ``a2a_pipelined`` over the int8 wire (K1, K7, K2; the overlap model's
    chunk count).  Each run: the plain path's first-step loss from the
    same weights and batch (kernels off), then ``trainer.train`` with the
    launch counters set to 0 just before and read just after and the
    top-k picks digested; the a2a run then profiles one more step and
    takes its parameters and step through ``ckpt.save`` / ``verify`` /
    ``restore_into`` (one payload a process: its expert shard and model
    slices; the restore without hashing again, as the trainer's rollback
    reads) into zeroed tensors, timed.  Writes
    ``ep_tp<process rank>.json``."""
    import dataclasses

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.launch import analysis
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = dataclasses.replace(get_config(ARCH_ID), num_layers=WORLD_LAYERS)
    rank = world.process_rank
    out = {"process_rank": rank, "rank": world.rank,
           "model_coord": world.model_coord}
    for label, dispatch, codec, steps in (
            ("a2a", "a2a", "", EP_TP_STEPS),
            ("pipelined_int8", "a2a_pipelined", "int8",
             EP_TP_PIPELINED_STEPS)):
        run = RunConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_22,
                        warmup_steps=1, aux_mode="ta", dispatch=dispatch,
                        a2a_num_chunks=0, wire_codec=codec, seed=0)

        def ctx_for(use_pallas):
            return model_lib.build_ctx(
                arch, world, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_22,
                aux_mode="ta", dispatch=dispatch, a2a_num_chunks=0,
                wire_codec=codec, use_pallas=use_pallas, device="cuda")

        plain_ctx = ctx_for(False)
        params = model_lib.init_params(
            plain_ctx, torch.Generator(device="cuda").manual_seed(run.seed))
        data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH_22,
                                      seed=run.seed))
        backend.reset_launches()
        os.environ[backend.ENV_VAR] = "0"
        try:
            with torch.no_grad():
                _, m = transformer.loss_fn(
                    params, shard_batch(data.batch(0), world, "cuda"),
                    plain_ctx, aux_weight=run.aux_weight)
                plain_loss = float(trainer.world_mean_metrics(
                    {"loss": m["loss"]}, world)["loss"])
        finally:
            del os.environ[backend.ENV_VAR]
        plain_launches = dict(backend.LAUNCHES)
        kctx = ctx_for(None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with PickLog() as picks:
            backend.reset_launches()
            res = trainer.train(arch, run, world, steps=steps, log_every=1,
                                verbose=False, params=params, device="cuda")
            launches = dict(backend.LAUNCHES)
        rec = {"losses": res.losses, "plain_first_loss": plain_loss,
               "plain_launches": plain_launches, "launches": launches,
               "picks": picks.result(), "step_wall_s": res.step_seconds,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "a2a_num_chunks": kctx.a2a_num_chunks,
               "caps": list(kctx.plan.caps),
               "param_bytes": analysis.tree_bytes(res.params)}
        if label == "a2a":
            step = trainer.make_train_step(kctx, run)
            prof = profile_train_step(
                torch, step, res.params, res.opt_state,
                shard_batch(data.batch(steps), world, "cuda"))
            rec["profiled_step"] = {k: prof[k] for k in (
                "wall_ms", "device_ms", "device_busy_share",
                "kernel_launches", "top", "port_kernels")}
            state = {"params": res.params, "step": res.opt_state["step"]}
            path = ckpt.rank_path(os.path.join(out_dir, "ep_tp.npz"), rank,
                                  world.size * world.model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(path, state, step=steps)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            verified = ckpt.verify(path)
            verify_s = time.perf_counter() - t0
            blank = {"params": adamw.tree_map(torch.zeros_like,
                                              state["params"]), "step": 0}
            t0 = time.perf_counter()
            # verify just hashed every leaf: the restore reads without
            # hashing them again, as the trainer's rollback does
            got = ckpt.restore_into(path, blank, check_hashes=False)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            want = adamw.tree_leaves(state["params"])
            have = adamw.tree_leaves(got["params"])
            rec["checkpoint"] = {
                "payload": os.path.basename(path),
                "bytes": os.path.getsize(path), "save_s": save_s,
                "verify_s": verify_s, "restore_s": restore_s,
                "verified": verified,
                "step": got["step"], "saved_step": state["step"],
                "bit_equal": len(want) == len(have) and all(
                    torch.equal(a.detach(), b) for a, b in zip(want, have))}
            os.unlink(path)
            os.unlink(path + ".meta.json")
            del state, blank, got, want, have
        out[label] = rec
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"ep_tp{rank}.json"), "w") as fh:
        json.dump(out, fh)


def cut_depth(arch, depth: int):
    """``arch`` at ``depth`` layers.  A family that repeats a group longer
    than ``depth`` has its group cut to ``depth`` with each kind of layer
    kept (``layer_plan`` repeats whole groups): Jamba's attention moves
    to the group's last layer, its MoE FFN stays in every second; xLSTM's
    sLSTM block stays last."""
    import dataclasses
    arch = dataclasses.replace(arch, num_layers=depth)
    if arch.family == "hybrid" and arch.attn_every > depth:
        arch = dataclasses.replace(arch, attn_every=depth,
                                   attn_offset=depth - 1)
    if arch.ssm_kind == "xlstm" and arch.slstm_every > depth:
        arch = dataclasses.replace(arch, slstm_every=depth)
    return arch


def tp_family_of(aid: str, depth: int):
    from repro_torch.configs.base import get_config
    return cut_depth(get_config(aid), depth)


def tp_family_want(arch) -> dict:
    """The launches one rank of serve_tp2_families makes for ``arch`` over
    its TP_FAMILY_DRAWS draws: K4 once a MoE layer of the prefill and of
    each decode step (a scan prefill is E2E_PROMPT decode steps), K5 once
    an attention layer of the prefill (Whisper's encoder, InternVL2's
    layers; MLA and Mamba take none), nothing else."""
    from repro_torch.kernels import backend
    from repro_torch.models import decode, transformer
    subs = transformer.layer_list(arch)
    moe = sum(s.ffn == "moe" for s in subs)
    calls = (E2E_PROMPT if decode._needs_scan_prefill(arch) else 1) \
        + TP_FAMILY_STEPS
    k5 = (arch.enc_layers if arch.family == "audio" else
          0 if decode._needs_scan_prefill(arch) else
          sum(s.mixer == "attn" for s in subs))
    want = {k: 0 for k in backend.LAUNCHES}
    want["moe_fused.local_moe"] = moe * calls * TP_FAMILY_DRAWS
    want["flash_attn.flash_attention"] = k5 * TP_FAMILY_DRAWS
    return want


def tp_family_prompt(torch, np, arch, draw: int, device="cuda",
                     length: int = 0):
    """Draw ``draw`` of the E2E rows' prompt [E2E_ROWS, S] (S = ``length``
    or, by default, VLM_BUCKET for a vision model, whose first
    frontend_len positions the patches take, else E2E_PROMPT) and
    frontend (None without one), from its own seed, on ``device``."""
    rng = np.random.default_rng(8 + draw)
    S = length or (VLM_BUCKET if arch.frontend == "vision" else E2E_PROMPT)
    prompt = torch.as_tensor(rng.integers(0, arch.vocab_size,
                                          size=(E2E_ROWS, S)),
                             dtype=torch.int32, device=device)
    fe = frontend_of(np, arch, rng, E2E_ROWS)
    return prompt, None if fe is None else fe.to(device)


def tp_family_checks(torch, aid, params, ctx, gen) -> dict:
    """The kernels at a model rank's layouts that ``aid`` gives them on
    the (data 1, model 2) world, on its one-rank weights cut to coordinate
    0's width, against their plain versions, timed: K4 at
    DeepSeek-V2-Lite's f 704 (decode: E2E_ROWS tokens; prefill: E2E_ROWS x
    E2E_PROMPT) and Jamba's f 7168 (E2E_ROWS tokens; its scan prefill
    steps are the same layout) on their first MoE layer; K5 at Whisper's
    encoder with 3 of 6 heads, non-causal, and InternVL2's prefill with
    24 of 48 heads over 4 of 8 KV heads of 128."""
    from repro_torch.models import transformer
    arch = ctx.arch
    out = {}
    if arch.is_moe:
        layer = [s.ffn for s in transformer.layer_list(arch)].index("moe")
        Tgs = {"decode": E2E_ROWS}
        if arch.mla is not None:
            Tgs["prefill"] = E2E_ROWS * E2E_PROMPT
        for label, Tg in Tgs.items():
            args, act = gather_k4_case(torch, params, ctx, Tg, gen,
                                       layer=layer)
            x, tok, w, offs, exps, valid, w_in, w_gate, w_out = args
            f = w_in.shape[2] // TP_MODEL
            args = (x, tok, w, offs, exps, valid,
                    w_in[..., :f].contiguous(),
                    None if w_gate is None else w_gate[..., :f].contiguous(),
                    w_out[:, :f].contiguous())
            out[f"K4_{label}_f{f}"] = check_k4(torch, args, act,
                                               f"tp2_{aid}_{label}")
    elif arch.frontend == "audio":
        out["K5_encoder"] = check_k5(
            torch, (PACK, arch.frontend_len, arch.num_heads // TP_MODEL,
                    arch.head_dim_), gen, causal=False)
    elif arch.frontend == "vision":
        out["K5_prefill"] = check_k5(
            torch, (PACK, VLM_BUCKET, arch.num_heads // TP_MODEL,
                    arch.head_dim_), gen,
            kv_heads=arch.num_kv_heads // TP_MODEL)
    return out


def serve_tp_family_rank(world, out_dir: str) -> None:
    """One rank of serve_tp2_families (a data 1 x model 2 world): each of
    TP_FAMILIES at its depth from seed 0 (the rank's slices of the
    one-rank draw: MLA and the xLSTM mixers by heads, Mamba by inner
    channels, Whisper's encoder and cross-attention by heads, InternVL2's
    projector by width), ``use_flash=True``: for each of the
    TP_FAMILY_DRAWS prompt draws the main process saved
    (``tp_family_<config>.pt``), one prefill of the E2E rows (with their
    frames or patches) and TP_FAMILY_STEPS decode steps, the launch
    counters set to 0 just before the first draw and read just after the
    last, the top-k picks digested.  The logits are held against the
    family's one-rank float32 runs by ``e2e_row_verdict``, beside the
    one-rank bf16 plain runs.  Writes ``fam<process rank>.json``."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.launch import analysis
    from repro_torch.models import model as model_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    out = {"process_rank": world.process_rank,
           "model_coord": world.model_coord, "families": {}}
    for aid, depth in TP_FAMILIES:
        arch = tp_family_of(aid, depth)
        draws = torch.load(os.path.join(out_dir, f"tp_family_{aid}.pt"))
        ctx = model_lib.build_ctx(arch, world, device="cuda", use_flash=True,
                                  aux_mode="none", seq_len=CACHE_LEN,
                                  global_batch=E2E_ROWS)
        params = model_lib.init_params(
            ctx, torch.Generator(device="cuda").manual_seed(0))
        got = []
        torch.cuda.synchronize()
        with torch.no_grad(), PickLog() as picks:
            backend.reset_launches()
            t0 = time.perf_counter()
            for d in draws:
                fe = d["frontend"]
                got.append(e2e_logits(
                    torch, params, ctx, d["prompt"].cuda(), world,
                    frontend=None if fe is None else fe.cuda(),
                    steps=TP_FAMILY_STEPS))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(backend.LAUNCHES)
        got = torch.cat(got, dim=1)
        e2e = e2e_row_verdict(
            torch, got, torch.cat([d["plain_f32"] for d in draws], 1).cuda(),
            torch.cat([d["plain_bf16"] for d in draws], 1).cuda(),
            f"serve_tp2_families {aid}")
        out["families"][aid] = {
            "end_to_end": e2e, "greedy": got.argmax(-1).t().tolist(),
            "launches": launches, "picks": picks.result(), "wall_s": wall,
            "tokens_per_s": (TP_FAMILY_DRAWS * E2E_ROWS
                             * (TP_FAMILY_STEPS + 1) / wall),
            "param_bytes": analysis.tree_bytes(params),
            "heads": (ctx.mla_cfg.num_heads if arch.mla is not None else
                      ctx.xlstm_cfg.local_heads if arch.ssm_kind == "xlstm"
                      else ctx.attn_cfg.num_heads),
            "attention_split": ctx.attn_sharded}
        del params, got
        gc.collect()
        torch.cuda.empty_cache()
    out["run_seconds"] = time.time() - t_start
    with open(os.path.join(out_dir, f"fam{world.process_rank}.json"),
              "w") as fh:
        json.dump(out, fh)


# ---------------------------------------------------------------------------


def ep_family_checks(torch, aid: str, params, ctx, gen) -> dict:
    """The kernels at rank (0, 0)'s layouts of ``aid`` on the 2x2 EP world
    at full width, on its first MoE layer's weights, each against its
    plain version, timed, with bounds: K4 at the serving world's gather
    layouts (its 16, 40 or 4 experts a rank over the world's 8 gathered
    decode slots, and one gathered prefill pack of 4 x 128, or for a
    model that prefills by scan one scan step's 4 rows); for the
    DeepSeek-V2 models also K1, K2 (top-6: the generic instantiation) and
    K3 (swiglu) at train_dsv2_2x2's staged buffer (DeepSeek-V2-236B's at
    the same plan, which it does not train) and K7 (swiglu) at chunk 0 of
    its int8 pipelined plan, each layout equal to the one
    ``kernels/layouts.py`` registers (``dsv2_staged``)."""
    from repro_torch.kernels import layouts
    from repro_torch.models import decode, transformer
    arch = ctx.arch
    layer = [s.ffn for s in transformer.layer_list(arch)].index("moe")
    ep_world = math.prod(WORLD_22)
    tgs = {"decode_2x2": NUM_SLOTS}
    if decode._needs_scan_prefill(arch):
        tgs["prefill_scan_2x2"] = PACK
    else:
        tgs["prefill_2x2"] = PACK * BUCKET
    out = {"moe_layer": layer, "K4": {}, "K4_compaction": []}
    for label, Tg in tgs.items():
        args, act = gather_k4_case(torch, params, ctx, Tg, gen, rank=0,
                                   ep_world=ep_world, layer=layer)
        if act != "swiglu":
            raise SystemExit(f"checks_dsv2_2x2 {aid} {label}: activation "
                             f"{act}")
        out["K4"][label] = check_k4(torch, args, act, f"{aid}_{label}")
        out["K4_compaction"].append(check_compaction(torch, args,
                                                     f"{aid}_{label}"))
        del args
    if arch.mla is None:
        return out

    def registered(case, lay, label):
        if (tuple(case["segs"]), tuple(case["exps"])) != (
                lay.seg_offsets, lay.seg_experts):
            raise SystemExit(f"checks_dsv2_2x2 {label}: the path's segments "
                             f"differ from the layout kernels/layouts.py "
                             f"registers")

    case = staged_case(torch, params, arch, gen, layer=layer,
                       global_batch=DSV2_22_BATCH)
    registered(case, layouts.dsv2_staged(arch_id=aid), "staged")
    di = case["di"]
    out["K1"] = check_k1(torch, case["x"], di.slot_to_token)
    out["K2"] = check_k2(torch, torch.randn(
        (di.num_slots, arch.d_model), generator=gen,
        device="cuda").to(torch.bfloat16), di)
    out["K3"] = check_k3(torch, case)
    out["layout_2x2"] = {"caps": list(case["caps"]), "S": di.num_slots,
                         "T": case["x"].shape[0],
                         "picks": di.inv_idx.shape[1],
                         "experts_per_rank": case["w_in"].shape[0]}
    del case
    pcase = pipelined_case(torch, params, arch, gen, layer=layer,
                           chunks=None, global_batch=DSV2_22_BATCH)
    registered(pcase, layouts.dsv2_staged(True, aid), "pipelined")
    out["K7"] = check_k7(torch, pcase)
    return out


def ep_family_references(torch, np, out_dir: str) -> dict:
    """checks_dsv2_2x2 and checks_dsv2_236b_2x2, before the 2x2 world's
    session: each of EP_FAMILIES on one rank at its depth (the same draw
    the world's ranks slice), ``ep_family_checks`` on its weights, and
    its bf16 and float32 plain runs of TP_FAMILY_DRAWS draws of the E2E
    rows (``e2e_<config>.pt`` in ``out_dir``, which serve_dsv2_2x2,
    serve_jamba_2x2 and serve_dsv2_236b_2x2 hold their kernel paths to;
    DeepSeek-V2-236B's float32 run casts one layer at a time: a whole
    float32 copy beside its bf16 weights would hold 53 GB).  Emits each
    phase's line and returns the checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    checks, phases = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(14)
    for aid, depth, _ in EP_FAMILIES:
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        arch = cut_depth(get_config(aid), depth)
        ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                                  aux_mode="none", seq_len=CACHE_LEN,
                                  global_batch=NUM_SLOTS)
        params = model_lib.init_params(
            ctx, torch.Generator(device="cuda").manual_seed(0))
        draws = []
        with torch.no_grad():
            checks[aid] = ep_family_checks(torch, aid, params, ctx, gen)
            for draw in range(TP_FAMILY_DRAWS):
                prompt, _ = tp_family_prompt(torch, np, arch, draw)
                runs = plain_runs(torch, params, ctx, prompt, kernel=False,
                                  f32_by_layer=aid == DSV2_236B_ID)
                draws.append({"prompt": prompt.cpu(),
                              **{k: v.cpu() for k, v in runs.items()}})
        checks[aid]["layers"] = depth
        checks[aid]["params"] = model_lib.count_params(params)
        checks[aid]["greedy_model1_f32"] = torch.cat(
            [d["plain_f32"] for d in draws], 1).argmax(-1).t().tolist()
        checks[aid]["max_memory_allocated_gb"] = (
            torch.cuda.max_memory_allocated() / 1e9)
        torch.save(draws, os.path.join(out_dir, f"e2e_{aid}.pt"))
        del params, runs, draws
        gc.collect()
        torch.cuda.empty_cache()
        name = ("checks_dsv2_236b_2x2" if aid == DSV2_236B_ID
                else "checks_dsv2_2x2")
        phase = phases.setdefault(name, {"phase": name, "seconds": 0.0,
                                         "world": list(WORLD_22)})
        phase["seconds"] += time.time() - t0
        phase[aid] = checks[aid]
    for phase in phases.values():
        emit(phase)
    return checks


def ep_family_jobs() -> tuple:
    """The 2x2 world session's jobs for the other MoE models: each of
    EP_FAMILIES served (``serve_rank``), then DeepSeek-V2-Lite trained
    (``train_rank``: DSV2_22_STEPS a2a steps, then DSV2_22_INT8_STEPS
    through a2a_pipelined over the int8 wire)."""
    depth = ep_depth(DSV2_ID)
    return tuple(("serve_rank", (aid, d, EP_FAMILY_REQUESTS))
                 for aid, d, _ in EP_FAMILIES) + (
        ("train_rank", (DSV2_22_BATCH, "a2a", "", DSV2_22_STEPS, depth,
                        False, True, DSV2_ID,
                        (("dsv2_int8_", "a2a_pipelined", "int8",
                          DSV2_22_INT8_STEPS),), "dsv2_")),)


def ep_depth(aid: str) -> int:
    """The depth EP_FAMILIES gives ``aid``."""
    return next(d for a, d, _ in EP_FAMILIES if a == aid)


def ep_family_results(out_dir: str, session_s: float) -> tuple:
    """serve_dsv2_2x2, serve_jamba_2x2, serve_dsv2_236b_2x2 and
    train_dsv2_2x2 from the 2x2
    session's files: each family's verdict (held in the ranks), streams
    complete and equal on every rank, greedy tokens equal, launches
    exact; DeepSeek-V2-Lite's two runs' launches exact (K1, K3, K2 once a
    MoE layer a step; K1, K7, K2 once a MoE layer a chunk a step), each
    first-step loss within LOSS_RTOL (LOSS_RTOL_INT8) of the plain
    path's, the ranks' world-mean losses equal; no rank holds another's
    experts (their digests differ: the world has no data replicas).
    Emits each phase's line and returns ``(serve ranks by config, a2a
    ranks, int8 ranks)``."""
    from repro_torch.configs.base import get_config

    def ranks_of(prefix):
        out = []
        for r in range(math.prod(WORLD_22)):
            with open(os.path.join(out_dir, f"{prefix}{r}.json")) as fh:
                out.append(json.load(fh))
        return out

    srv = {}
    for aid, depth, short in EP_FAMILIES:
        arch = cut_depth(get_config(aid), depth)
        ranks = ranks_of(f"serve_{aid}")
        label = f"serve_{short}_2x2"
        check_serving_world(ranks, arch, label, EP_FAMILY_REQUESTS)
        for r in ranks:
            if r["end_to_end"]["greedy"] != ranks[0]["end_to_end"]["greedy"]:
                raise SystemExit(f"{label}: the ranks' greedy tokens differ")
        srv[aid] = ranks
        emit({"phase": label,
              "seconds": max(r["run_seconds"] for r in ranks),
              "session_seconds": session_s, "world": list(WORLD_22),
              "backend": "gloo", "arch": aid, "layers": depth,
              "requests": EP_FAMILY_REQUESTS,
              "want_launches": serve_world_want(arch, ranks[0]),
              "ranks": ranks})

    depth = ep_depth(DSV2_ID)
    a2a, int8 = ranks_of("dsv2_"), ranks_of("dsv2_int8_")
    n_moe = depth - get_config(DSV2_ID).moe.first_dense
    off = {k: 0 for k in OFF_PATH}
    staged = ("moe_permute.permute", "moe_permute.unpermute")
    check_a = check_training(
        a2a, dict({k: n_moe * DSV2_22_STEPS for k in staged}, **off,
                  **{"moe_gemm.grouped_ffn_ragged": n_moe * DSV2_22_STEPS,
                     "moe_fused.local_moe": 0,
                     "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_dsv2_2x2", LOSS_RTOL, DSV2_22_STEPS)
    chunks = int8[0]["a2a_num_chunks"]
    per_chunk = n_moe * chunks * DSV2_22_INT8_STEPS
    check_i = check_training(
        int8, dict({k: per_chunk for k in staged}, **off,
                   **{"moe_gemm.grouped_ffn_ragged_quant": per_chunk,
                      "moe_gemm.grouped_ffn_ragged": 0,
                      "moe_fused.local_moe": 0}),
        "train_dsv2_2x2_int8", LOSS_RTOL_INT8, DSV2_22_INT8_STEPS)
    digests = [r["experts_sha256"] for r in a2a]
    if len(set(digests)) != len(digests):
        raise SystemExit(f"train_dsv2_2x2: two ranks hold the same expert "
                         f"leaves: {digests}")
    a2a_s = max(r["run_seconds"] for r in a2a)
    int8_s = max(r["run_seconds"] for r in int8)
    emit({"phase": "train_dsv2_2x2", "seconds": a2a_s + int8_s,
          "session_seconds": session_s, "world": list(WORLD_22),
          "backend": "gloo", "arch": DSV2_ID, "layers": depth,
          "moe_layers": n_moe, "seq_len": TRAIN_SEQ,
          "global_batch": DSV2_22_BATCH,
          "steps": {"a2a": DSV2_22_STEPS,
                    "pipelined_int8": DSV2_22_INT8_STEPS},
          "a2a": {**check_a, "seconds": a2a_s},
          "pipelined_int8": {**check_i, "chunks": chunks,
                             "seconds": int8_s},
          "data_replicas": "none: the experts span both axes",
          "ranks": a2a, "int8_ranks": int8})
    return srv, a2a, int8


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import backend
    from repro_torch.launch import mesh
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})

    # 2. build
    t0 = time.time()
    libs = backend.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
             for n, log in backend.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": time.time() - t0,
          "libs": {n: os.path.relpath(str(p), REPO) for n, p in libs.items()},
          "ptxas": ptxas})

    # 3. kernel checks at the serve phase's shapes
    arch = get_config(ARCH_ID)
    ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    t0 = time.time()
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": arch.name, "layers": arch.num_layers,
          "params": model_lib.count_params(params),
          "seconds": time.time() - t0})
    # 2a. the static checkers on the card
    ana_dir = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    try:
        ana = analysis_phase(torch, params, ctx, ana_dir)
    finally:
        shutil.rmtree(ana_dir, ignore_errors=True)
    emit({"phase": "analysis", **ana})
    dry_1rank = ana["dryrun_train_1rank"]["arg_bytes_by_part"]

    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        k4_cases = {
            "decode": gather_k4_case(torch, params, ctx, NUM_SLOTS, gen),
            "prefill": gather_k4_case(torch, params, ctx, PACK * BUCKET, gen)}
        k4 = {label: check_k4(torch, *c, label)
              for label, c in k4_cases.items()}
        k4_edge_cases = {
            "decode_swiglu": gather_k4_case(torch, params, ctx, NUM_SLOTS,
                                            gen, swiglu=True),
            "ragged_swiglu": gather_k4_case(torch, params, ctx, 100, gen,
                                            swiglu=True),
            "edges_gelu": k4_edge_case(torch, params, ctx, gen),
            "edges_swiglu": k4_edge_case(torch, params, ctx, gen,
                                         swiglu=True)}
        k4_edges = [check_k4(torch, *c, label, timed=False)
                    for label, c in k4_edge_cases.items()]
        compaction = [check_compaction(torch, c[0], label)
                      for label, c in {**k4_cases, **k4_edge_cases}.items()]
        del k4_cases, k4_edge_cases
        # K4 on serve_2x2's gather layouts: rank (0, 0)'s 16 experts over
        # the world's gathered decode tokens (8 slots) and one gathered
        # prefill pack
        for label, Tg in (("decode_2x2", NUM_SLOTS),
                          ("prefill_2x2", PACK * BUCKET)):
            c = gather_k4_case(torch, params, ctx, Tg, gen, rank=0,
                               ep_world=math.prod(WORLD_22))
            k4[label] = check_k4(torch, *c, label)
            compaction.append(check_compaction(torch, c[0], label))
            del c
        hd = arch.head_dim_
        k5 = check_k5(torch, (PACK, BUCKET, arch.num_heads, hd), gen)
        # the training sequence length, for information (training attends
        # through the plain _sdpa)
        k5_512 = check_k5(torch, (PACK, TRAIN_SEQ, arch.num_heads, hd), gen)
        edges = [check_k5(torch, (2, 100, arch.num_heads, hd), gen,
                          timed=False),
                 check_k5(torch, (1, 77, 4, hd), gen, window=16,
                          timed=False),
                 check_k5(torch, (1, 50, 4, hd), gen, causal=False,
                          timed=False),
                 check_k5(torch, (2, 96, arch.num_heads, hd), gen,
                          kv_heads=4, timed=False),
                 check_k5(torch, (2, 200, arch.num_heads, hd), gen,
                          window=70, kv_heads=8, timed=False)]
        # K1 and K2 at rank 0's layouts of the 2x2 world: the staged plan
        # (train_2x2) and chunk 0 of the pipelined int8 plan
        # (train_2x2_pipelined)
        case = staged_case(torch, params, arch, gen)
        pcase = pipelined_case(torch, params, arch, gen)
        k1, k2 = {}, {}
        for label, c in (("S=4864", case), ("S=608", pcase)):
            di = c["di"]
            k1[label] = check_k1(torch, c["x"], di.slot_to_token)
            k2[label] = check_k2(torch, torch.randn(
                (di.num_slots, c["x"].shape[1]), generator=gen,
                device="cuda").to(torch.bfloat16), di)
        k1_edges = permute_edges(torch, gen)
        k2_edges = unpermute_edges(torch, gen)
        k3 = check_k3(torch, case)
        k3e = k3_edges(torch, case, gen)
        # K1-K3 at train_2x2_replan's layout after its replan
        rcase = staged_case(torch, params, arch, gen, slowdowns={
            ax: m for _, ax, m in REPLAN_CHAOS["degraded_links"]})
        if rcase["caps"][-1] != 0:
            raise SystemExit(f"the replanned layout has caps "
                             f"{rcase['caps']}, not an empty last stage")
        k_replan = layout_checks(torch, rcase, gen)
        layout_replan = (rcase["x"].shape[0], rcase["di"])
        del rcase
        # K1-K3 at train_2x2x2's layout: rank (0, 0, 0), three stages
        case3 = staged_case(torch, params, arch, gen,
                            sizes=mesh.mesh_from_topology(SPEC_222),
                            global_batch=TRAIN_BATCH_222)
        if len(case3["caps"]) != 3 or min(case3["caps"]) <= 0:
            raise SystemExit(f"the 2x2x2 layout has caps {case3['caps']}, "
                             f"not three stages")
        di3 = case3["di"]
        label3 = f"2x2x2 S={di3.num_slots}"
        k1[label3] = check_k1(torch, case3["x"], di3.slot_to_token)
        k2[label3] = check_k2(torch, torch.randn(
            (di3.num_slots, arch.d_model), generator=gen,
            device="cuda").to(torch.bfloat16), di3)
        k3_222 = check_k3(torch, case3)
        k_222 = layout_checks(torch, case3, gen)
        layout222 = (case3["x"].shape[0], di3)
        del case3
        # K7 on the whole staged buffer too: its expert spans of 304 rows
        # cross 64-row tiles, which chunk 0's spans of 38 do not
        k7_full = check_k7(torch, case)
        layout22 = (case["x"].shape[0], case["di"])
        del case
        k7 = check_k7(torch, pcase)
        del pcase
        train1 = train1_k4_case(torch, params, arch, gen)
        k4["train_1rank"] = check_k4(torch, *train1, "train_1rank")
        compaction.append(check_compaction(torch, train1[0], "train_1rank"))
        del train1
        x6, w_in6, w_out6, filled = einsum_k6_case(torch, params, arch, gen)
        k6 = check_k6(torch, x6, w_in6, None, w_out6, "einsum", filled)
        k6_edges = check_k6_edges(torch, x6, w_in6, w_out6, gen)
        del x6
        H, K = arch.num_heads, arch.num_kv_heads
        k8 = check_k8(torch, gen, DECODE_B, DECODE_L, H, K, timed=True)
        gc.collect()
        torch.cuda.empty_cache()
        k8_edges = [check_k8(torch, gen, 4, 4096, H, 4),
                    check_k8(torch, gen, 4, 8192, H, K, window=4096),
                    check_k8(torch, gen, 4, 1000, H, K,
                             lengths=[0, 1, 537, 1000])]
    emit({"phase": "checks", "K4": k4, "K4_edges": k4_edges,
          "K4_compaction": compaction, "K5": k5,
          "K5_S512": k5_512, "K5_edges": edges, "K1": k1,
          "K1_edges": k1_edges, "K2": k2, "K2_edges": k2_edges, "K3": k3,
          "K3_edges": k3e, "K1_K2_K3_replan_layout": k_replan,
          "K3_2x2x2": k3_222, "K1_K2_K3_2x2x2_layout": k_222,
          "K7": k7, "K7_S4864": k7_full,
          "K6": k6, "K6_edges": k6_edges, "K8": k8, "K8_edges": k8_edges})
    bwd = backward_checks(torch, gen, {"2x2": layout22,
                                       "replan": layout_replan,
                                       "2x2x2": layout222})
    emit({"phase": "backward_checks", **bwd})

    # 4. serve
    with torch.no_grad():
        e2e = end_to_end_check(torch, np, params, ctx)
    emit({"phase": "end_to_end", **e2e})
    cfg = engine.ServeConfig(num_slots=NUM_SLOTS, cache_len=CACHE_LEN,
                             prefill_pack=PACK, prompt_buckets=(BUCKET,))
    eng = engine.ServingEngine(params, ctx, cfg)
    rng = np.random.default_rng(0)
    eng.run(serve_requests(rng, arch.vocab_size, 1))          # warm-up
    reqs = serve_requests(rng, arch.vocab_size, NUM_REQUESTS)
    torch.cuda.synchronize()
    backend.reset_launches()
    report = eng.run(reqs)
    launches = dict(backend.LAUNCHES)
    for s in report.streams:
        if s.evicted or len(s.generated) != s.request.max_new_tokens:
            raise SystemExit(f"request {s.request.uid}: {len(s.generated)} "
                             f"of {s.request.max_new_tokens} tokens")
        if not all(0 <= t < arch.vocab_size for t in s.generated):
            raise SystemExit(f"request {s.request.uid}: token outside the "
                             f"vocabulary")
    if len(report.streams) != NUM_REQUESTS:
        raise SystemExit(f"{len(report.streams)} of {NUM_REQUESTS} streams "
                         f"finished")
    n_moe = arch.num_layers
    want_k4 = n_moe * (report.prefill_calls + report.decode_steps)
    want_k5 = arch.num_layers * report.prefill_calls
    if launches["moe_fused.local_moe"] < want_k4:
        raise SystemExit(f"K4 launched {launches['moe_fused.local_moe']} "
                         f"times, the path needs >= {want_k4}")
    if launches["flash_attn.flash_attention"] < want_k5:
        raise SystemExit(f"K5 launched "
                         f"{launches['flash_attn.flash_attention']} times, "
                         f"the path needs >= {want_k5}")
    for name in OFF_PATH:
        if launches[name]:
            raise SystemExit(f"serve: {name} launched {launches[name]} "
                             f"times, the path needs none")
    emit({"phase": "serve", "requests": len(report.streams),
          "new_tokens": report.total_new_tokens,
          "prompt_tokens": sum(len(r.tokens) for r in reqs),
          "decode_steps": report.decode_steps,
          "prefill_packs": report.prefill_calls,
          "wall_s": report.wall_time,
          "tokens_per_s": report.tokens_per_sec,
          "launches": launches,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})

    with torch.no_grad():
        emit({"phase": "profile", **profile_steps(torch, params, ctx)})
    serve_launches = launches
    # the one-rank plain runs (bf16 and float32) that serve_2x2's
    # end-to-end check holds the world's kernel path to
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    prompt = torch.as_tensor(np.random.default_rng(8).integers(
        0, arch.vocab_size, size=(E2E_ROWS, E2E_PROMPT)), dtype=torch.int32,
        device="cuda")
    import dataclasses
    cut_ctx = dataclasses.replace(ctx, arch=dataclasses.replace(
        arch, num_layers=WORLD_LAYERS))
    with torch.no_grad():
        ref = plain_runs(torch, dict(params,
                                     layers=params["layers"][:WORLD_LAYERS]),
                         cut_ctx, prompt, kernel=False)
    torch.save({"prompt": prompt.cpu(),
                **{k: v.cpu() for k, v in ref.items()}},
               os.path.join(tmp, "e2e_reference.pt"))
    del params, eng, report, ref
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the 2x2 EP world (pod x data): four ranks share the card over
    # gloo, spawned once for every 2x2 phase (``world_session``).  First,
    # in this process, the other MoE models' one-rank references and
    # checks_dsv2_2x2; then the session: serve_2x2, serve_dsv2_2x2,
    # serve_jamba_2x2, train_2x2 and its pipelined run, train_2x2_replan
    # and train_dsv2_2x2
    ck_e = ep_family_references(torch, np, tmp)
    t0 = time.time()
    mesh.spawn(world_session, WORLD_22, "gloo", "cuda", args=(tmp, (
        ("serve_rank", ()),
        ("train_rank", (TRAIN_BATCH_22, "a2a", "", TRAIN_STEPS, WORLD_LAYERS,
                        True, False, ARCH_ID,
                        (("pipelined", "a2a_pipelined", "int8",
                          PIPELINED_STEPS),))),
        ("replan_rank", ())) + ep_family_jobs()))
    session_s = time.time() - t0
    srv = []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(tmp, f"serve{r}.json")) as fh:
            srv.append(json.load(fh))
    n_layers = arch.num_layers
    check_serving_world(srv, cut_ctx.arch, "serve_2x2", NUM_REQUESTS)
    emit({"phase": "serve_2x2", "seconds": max(r["run_seconds"] for r in srv),
          "session_seconds": session_s,
          "world": list(WORLD_22), "backend": "gloo",
          "layers": WORLD_LAYERS, "ranks": srv})
    zero = {k: 0 for k in ("moe_permute.permute", "moe_permute.unpermute",
                           "moe_gemm.grouped_ffn_ragged")}
    off = {k: 0 for k in OFF_PATH}

    # 7. training, 2x2 EP world (in the session), then in the same
    # processes train_2x2_pipelined (8.)
    ranks, pipe = [], []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
        with open(os.path.join(tmp, f"pipelined{r}.json")) as fh:
            pipe.append(json.load(fh))
    pipe_s = max(r["run_seconds"] for r in pipe)
    per_layer = {k: WORLD_LAYERS * TRAIN_STEPS for k in zero}
    check22 = check_training(
        ranks, dict(per_layer, **off,
                    **{"moe_fused.local_moe": 0,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_2x2")
    emit({"phase": "train_2x2",
          "seconds": max(r["run_seconds"] for r in ranks),
          "session_seconds": session_s, "world": list(WORLD_22),
          "backend": "gloo", "layers": WORLD_LAYERS,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_22,
          "steps": TRAIN_STEPS, **check22, "ranks": ranks})

    # 8. training, 2x2 EP world, pipelined dispatch over the int8 wire (in
    # train_2x2's processes: its seconds are the run's own)
    for r in pipe:
        if r["a2a_num_chunks"] != PIPELINED_CHUNKS:
            raise SystemExit(f"train_2x2_pipelined rank {r['rank']}: "
                             f"{r['a2a_num_chunks']} chunks, the overlap "
                             f"model gives {PIPELINED_CHUNKS}")
    per_chunk = {k: WORLD_LAYERS * PIPELINED_CHUNKS * PIPELINED_STEPS
                 for k in ("moe_permute.permute", "moe_permute.unpermute",
                           "moe_gemm.grouped_ffn_ragged_quant")}
    check_p = check_training(
        pipe, dict(per_chunk, **off,
                   **{"moe_gemm.grouped_ffn_ragged": 0,
                      "moe_fused.local_moe": 0}),
        "train_2x2_pipelined", LOSS_RTOL_INT8, PIPELINED_STEPS)
    emit({"phase": "train_2x2_pipelined", "seconds": pipe_s,
          "world": list(WORLD_22), "backend": "gloo", "wire_codec": "int8",
          "layers": WORLD_LAYERS,
          "overlap_terms": overlap_terms(arch), "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_22, "steps": PIPELINED_STEPS,
          **check_p,
          "ranks": pipe})

    # 12. the 2x2 world through a degraded-link replan (in the session)
    rep = []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(tmp, f"replan{r}.json")) as fh:
            rep.append(json.load(fh))
    per_step = {k: REPLAN_LAYERS * REPLAN_STEPS for k in zero}
    want_rp = dict({k: 0 for k in backend.LAUNCHES}, **per_step)
    for r in rep:
        if r["replans"] != 1 or len(r["caps_after"]) != 1:
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: "
                             f"{r['replans']} replans, the chaos needs 1")
        if (r["caps_after"][0] != r["planner_caps_pod_beta_inf"]
                or r["caps_after"][0][-1] != 0
                or r["caps_after"][0] == r["caps_before"]):
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: caps "
                             f"{r['caps_before']} -> {r['caps_after']}, the "
                             f"planner with the pod level's beta at inf "
                             f"gives {r['planner_caps_pod_beta_inf']}")
        if r["launches"] != want_rp:
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: launches "
                             f"{r['launches']}, the path needs {want_rp}")
        if len(r["losses"]) != REPLAN_STEPS or not all(
                math.isfinite(v) for v in r["losses"]):
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: losses "
                             f"{r['losses']}")
        got = r["losses"][r["first_replanned_step"]]
        plain = r["plain_first_replanned_loss"]
        r["first_replanned_rel_diff"] = rel = (
            math.inf if plain is None else abs(got - plain) / abs(plain))
        if not rel <= LOSS_RTOL:
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: the first "
                             f"step after the replan logged loss {got} "
                             f"(kernels), the plain path gives {plain} from "
                             f"the same state: relative {rel} > "
                             f"{LOSS_RTOL}")
    print(rep[0]["log"], end="", flush=True)
    emit({"phase": "train_2x2_replan",
          "seconds": max(r["run_seconds"] for r in rep),
          "session_seconds": session_s,
          "world": list(WORLD_22), "backend": "gloo",
          "layers": REPLAN_LAYERS, "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_22, "steps": REPLAN_STEPS,
          "resilience": REPLAN_RESILIENCE, "chaos": REPLAN_CHAOS,
          "ranks": [{k: v for k, v in r.items() if k != "log"}
                    for r in rep]})

    # the other MoE models on the 2x2 world (in the session)
    srv_e, trn_e, trn_e8 = ep_family_results(tmp, session_s)

    # 6. training, one rank, in a child process (it frees the card when it
    # ends); the kernels were built above, so the child only loads them;
    # after the run, the fused cross entropy on its state.  The same child
    # then runs train_einsum_k6 (9.), train_1rank_accum_remat (10.),
    # train_dsv2_lite_d4 (17.), train_resilient (11.) and train_internlm2
    # (19.), each from its own draw: one process start for the six, whose
    # reports the later phases read from ``one_rank``
    t0 = time.time()
    one_rank = tempfile.mkdtemp(prefix="chip_smoke_one_rank_")
    child = mp.get_context("spawn").Process(target=train_chain, args=([
        (os.path.join(tmp, "train_1rank.json"), TRAIN_BATCH_1, (),
         {"fused_xent": True}),
        (os.path.join(tmp, "einsum.json"), TRAIN_BATCH_1,
         ("einsum", "", TRAIN_STEPS, "lb", True), {"layers": CUT_LAYERS}),
        (os.path.join(tmp, "accum.json"), ACCUM_BATCH, (),
         {"microbatch": ACCUM_MICRO, "remat": True, "layers": CUT_LAYERS}),
        (os.path.join(one_rank, "dsv2_d4.json"), TRAIN_BATCH_1, (),
         {"layers": DSV2_CUT_LAYERS, "arch_id": DSV2_ID}),
        (os.path.join(one_rank, "jamba_d2.json"), TRAIN_BATCH_1, (),
         {"layers": JAMBA_TRAIN_LAYERS, "arch_id": JAMBA_ID,
          "check_k4_layer": JAMBA_TRAIN_LAYERS - 1})], (
        ("resilient_phase", (os.path.join(tmp, "resilient.json"),)),
        ("train_dense_phase", (os.path.join(one_rank, "internlm2.json"),)))
        + tuple(("family_train_phase",
                 (os.path.join(one_rank, f"{label}.json"), aid, depth,
                  seq))
                for label, aid, depth, seq, _, _ in FAMILY_TRAIN)))
    child.start()
    child.join()
    if child.exitcode != 0:
        raise SystemExit(f"train_1rank (with train_einsum_k6, "
                         f"train_1rank_accum_remat, train_dsv2_lite_d4, "
                         f"train_jamba_d2, train_resilient, train_internlm2 "
                         f"and the families' training): the child process "
                         f"failed (exit {child.exitcode})")
    chain_s = time.time() - t0
    with open(os.path.join(tmp, "train_1rank.json")) as fh:
        one = json.load(fh)
    check1 = check_training(
        [one], dict(zero, **off,
                    **{"moe_fused.local_moe": n_layers * TRAIN_STEPS,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_1rank")
    xent = one["fused_xent"]
    want_x = {k: 0 for k in backend.LAUNCHES}
    want_x["moe_fused.local_moe"] = n_layers
    if not xent["rel_diff"] <= LOSS_RTOL or xent["launches"] != want_x:
        raise SystemExit(f"train_1rank fused_xent: loss {xent['fused']} "
                         f"against {xent['default']} (relative "
                         f"{xent['rel_diff']}, limit {LOSS_RTOL}); launches "
                         f"{xent['launches']}, the step needs {want_x}")
    emit({"phase": "train_1rank", "seconds": one["run_seconds"],
          "child_seconds": chain_s,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check1, **one})
    # the meta dry-run's training state at train_1rank's shapes against
    # the state the run holds (parameters, gradients, AdamW's moments)
    if one["state_bytes"] != dry_1rank:
        raise SystemExit(f"dry-run at train_1rank's shapes: {dry_1rank} "
                         f"bytes, the run holds {one['state_bytes']}")
    emit({"phase": "dryrun_vs_train_1rank", "dryrun": dry_1rank,
          "train_1rank": one["state_bytes"], "equal": True})

    # 9. training through the einsum baseline with K6 (run in
    # train_1rank's child process)
    with open(os.path.join(tmp, "einsum.json")) as fh:
        ein = json.load(fh)
    check_e = check_training(
        [ein], {k: (CUT_LAYERS * TRAIN_STEPS if k == "moe_gemm.grouped_ffn"
                    else 0) for k in backend.LAUNCHES},
        "train_einsum_k6")
    emit({"phase": "train_einsum_k6", "seconds": ein["run_seconds"],
          "dispatch": "einsum", "aux_mode": "lb", "use_moe_kernel": True,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check_e, **ein})

    # 10. one rank, microbatch accumulation with remat (run in
    # train_1rank's child process): K4 runs once a layer and microbatch
    # forward and again in the recompute
    with open(os.path.join(tmp, "accum.json")) as fh:
        acc = json.load(fh)
    n_micro = ACCUM_BATCH // ACCUM_MICRO
    check_a = check_training(
        [acc], dict(zero, **off,
                    **{"moe_fused.local_moe": CUT_LAYERS * n_micro * 2
                       * TRAIN_STEPS,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_1rank_accum_remat")
    emit({"phase": "train_1rank_accum_remat", "seconds": acc["run_seconds"],
          "seq_len": TRAIN_SEQ, "global_batch": ACCUM_BATCH,
          "microbatch": ACCUM_MICRO, "remat": True, "steps": TRAIN_STEPS,
          **check_a, **acc})

    # 11. the resilient runtime on one rank (run in train_1rank's child
    # process)
    with open(os.path.join(tmp, "resilient.json")) as fh:
        resil = json.load(fh)
    want_r = {k: 0 for k in backend.LAUNCHES}
    want_r["moe_fused.local_moe"] = (RESILIENT_STEPS
                                     + CUT_LAYERS * GUARD_STEPS * 4)
    if resil["launches"] != want_r:
        raise SystemExit(f"train_resilient: launches {resil['launches']}, "
                         f"the path needs {want_r}")
    emit({"phase": "train_resilient", "seconds": resil["run_seconds"],
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1, **resil})

    # the families through the trainer (run in train_1rank's child
    # process): Jamba through K4's forward against its plain path, the
    # others against a float32 step
    with open(os.path.join(one_rank, "jamba_d2.json")) as fh:
        tjb = json.load(fh)
    check_j = check_training(
        [tjb], dict(zero, **off,
                    **{"moe_fused.local_moe": TRAIN_STEPS,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_jamba_d2")
    emit({"phase": "train_jamba_d2", "seconds": tjb["run_seconds"],
          "arch": JAMBA_ID, "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_1, "steps": TRAIN_STEPS, **check_j,
          **tjb})
    trn_fm = {}
    for label, _, _, _, loss_rtol, gnorm_rtol in FAMILY_TRAIN:
        with open(os.path.join(one_rank, f"{label}.json")) as fh:
            trn_fm[label] = json.load(fh)
        emit({"phase": label, "seconds": trn_fm[label]["run_seconds"],
              **check_family_training(trn_fm[label], label, loss_rtol,
                                      gnorm_rtol),
              **trn_fm[label]})

    # 13. training on the paper's three-level topology: eight ranks
    t0 = time.time()
    d222 = os.path.join(tmp, "2x2x2")
    os.makedirs(d222)
    sizes222 = mesh.mesh_from_topology(SPEC_222)
    mesh.spawn(train_rank, sizes222, "gloo", "cuda",
               args=(d222, TRAIN_BATCH_222, "a2a", "", TRAIN_STEPS,
                     WORLD_LAYERS))
    r222 = []
    for r in range(math.prod(sizes222)):
        with open(os.path.join(d222, f"rank{r}.json")) as fh:
            r222.append(json.load(fh))
    for r in r222:
        if len(r["caps"]) != 3 or min(r["caps"]) <= 0 or any(
                len(fb) != 3 for fb in r["frac_by_level"]):
            raise SystemExit(f"train_2x2x2 rank {r['rank']}: caps "
                             f"{r['caps']}, frac_by_level "
                             f"{r['frac_by_level']}: not three levels")
    check_3 = check_training(
        r222, dict({k: WORLD_LAYERS * TRAIN_STEPS for k in zero}, **off,
                   **{"moe_fused.local_moe": 0,
                      "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_2x2x2")
    emit({"phase": "train_2x2x2", "seconds": time.time() - t0,
          "topology": SPEC_222, "world": list(sizes222), "backend": "gloo",
          "layers": WORLD_LAYERS, "depth_cut": "12 -> 2: eight ranks "
          "at 12 layers ran the card out of memory (9.15 GB a rank)",
          "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_222, "steps": TRAIN_STEPS, **check_3,
          "ranks": r222})

    # 14. data parallelism beside expert parallelism: a (3, 2) world
    t0 = time.time()
    ddp = os.path.join(tmp, "dp")
    os.makedirs(ddp)
    mesh.spawn(train_rank, WORLD_DP, "gloo", "cuda",
               args=(ddp, TRAIN_BATCH_DP, "a2a", "", TRAIN_STEPS, DP_LAYERS,
                     False, True))
    rdp = []
    for r in range(math.prod(WORLD_DP)):
        with open(os.path.join(ddp, f"rank{r}.json")) as fh:
            rdp.append(json.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)
    check_dp = check_training(
        rdp, dict({k: DP_LAYERS * TRAIN_STEPS for k in zero}, **off,
                  **{"moe_fused.local_moe": 0,
                     "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_dp")
    for r in rdp:
        # pod 0's rank with this rank's data coordinate holds the same shard
        twin = rdp[r["coords"][1]]
        if r["experts_sha256"] != twin["experts_sha256"]:
            raise SystemExit(f"train_dp rank {r['rank']}: its expert leaves "
                             f"differ from their replica on rank "
                             f"{twin['rank']}")
    if rdp[0]["experts_sha256"] == rdp[1]["experts_sha256"]:
        raise SystemExit("train_dp: ranks 0 and 1 hold the same expert "
                         "leaves, not two shards")
    emit({"phase": "train_dp", "seconds": time.time() - t0,
          "world": list(WORLD_DP), "backend": "gloo",
          "ep_ranks": WORLD_DP[1], "dp_replicas": WORLD_DP[0],
          "layers": DP_LAYERS, "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_DP, "steps": TRAIN_STEPS, **check_dp,
          "ranks": rdp})

    # 15. DeepSeek-V2-Lite at full width (MLA, top-6 of 64 experts,
    # swiglu) on one rank; every gpt3_medium_moe tensor of this process was
    # freed before serve_2x2
    ck_ds, srv_ds, tds = deepseek_phases(
        torch, np, os.path.join(one_rank, "dsv2_d4.json"))

    # 16. Jamba-v0.1 at full width and depth 16 (Mamba, attention, top-2
    # of 16 experts of f 14336) on one rank, after DeepSeek's weights are
    # freed: 31 GB of them and 51.6 GB of Jamba's do not fit together
    ck_jb, srv_jb, loss_jb = jamba_phases(torch, np)
    # K4 at train_jamba_d2's own layout, held in its child before the run
    # (its compaction too: the train_jamba_d2 line)
    ck_jb["K4"]["train_1rank"] = tjb["K4_check"]["K4"]

    # 17. the dense decoders at full width and depth on one rank, after
    # Jamba's weights are freed; K5 at head dim 128 on three of them
    ck_dn, srv_dn, tr_dn = dense_phases(
        torch, np, os.path.join(one_rank, "internlm2.json"))
    shutil.rmtree(one_rank, ignore_errors=True)

    # 18. xLSTM, Whisper and InternVL2 at full width and depth on one
    # rank, after the dense decoders' weights are freed; K5 non-causal in
    # Whisper's encoder and at GQA 6:1 in InternVL2's prefill
    ck_fm, srv_fm = family_phases(torch, np)

    # 19. tensor parallelism: a (data 1, model 2) world of two ranks
    # sharing the card serves gpt3_medium_moe and Minitron-4B, trains
    # gpt3_medium_moe (through K4, and an einsum step through K6) and
    # serves the other families (MLA, Mamba, the xLSTM mixers, Whisper,
    # InternVL2), through K4 and K5 at a model rank's layouts; 20. the
    # paper's staged paths (K1, K2, K3, K7) on a (data 2, model 2) world
    # with a checkpoint round trip
    (ck_tp, srv_tp, trn_tp, ck_ep, trn_ep, ck_fam,
     srv_fam) = tp_phases(torch, np)


    # 21. kernels: launches summed over every main path and rank
    def total(name):
        return sum(sum(v) if isinstance(v, list) else v
                   for v in by_path(name).values())

    def by_path(name):
        return {"serve": serve_launches[name],
                "serve_2x2": [r["launches"][name] for r in srv],
                "train_1rank": one["launches"][name],
                "train_1rank_fused_xent": xent["launches"][name],
                "train_2x2": [r["launches"][name] for r in ranks],
                "train_2x2_pipelined": [r["launches"][name] for r in pipe],
                "train_einsum_k6": ein["launches"][name],
                "train_1rank_accum_remat": acc["launches"][name],
                "train_resilient": resil["launches"][name],
                "train_2x2_replan": [r["launches"][name] for r in rep],
                "train_2x2x2": [r["launches"][name] for r in r222],
                "train_dp": [r["launches"][name] for r in rdp],
                "serve_dsv2_lite": srv_ds["launches"][name],
                "train_dsv2_lite_d4": tds["launches"][name],
                "serve_jamba_d4": srv_jb["launches"][name],
                "loss_jamba_d4": loss_jb["launches"][name],
                **{f"serve_{aid}": r["launches"][name]
                   for aid, r in srv_dn.items()},
                "train_internlm2": tr_dn["launches"][name],
                "train_jamba_d2": tjb["launches"][name],
                **{label: r["launches"][name]
                   for label, r in trn_fm.items()},
                **{f"serve_{aid}": r["launches"][name]
                   for aid, r in srv_fm.items()},
                "serve_tp2": [r["gpt3"]["launches"][name] for r in srv_tp],
                "serve_tp2_minitron": [r["dense"]["launches"][name]
                                       for r in srv_tp],
                "train_tp2": [r["launches"][name] for r in trn_tp],
                "train_ep_tp": [r["a2a"]["launches"][name] for r in trn_ep],
                "train_ep_tp_pipelined": [
                    r["pipelined_int8"]["launches"][name] for r in trn_ep],
                **{f"serve_tp2_{aid}": [
                    r["families"][aid]["launches"][name] for r in srv_fam]
                   for aid, _ in TP_FAMILIES},
                "train_tp2_einsum": [r["einsum"]["launches"][name]
                                     for r in trn_tp],
                "serve_dsv2_2x2": [r["launches"][name]
                                   for r in srv_e[DSV2_ID]],
                "serve_jamba_2x2": [r["launches"][name]
                                    for r in srv_e[JAMBA_ID]],
                "serve_dsv2_236b_2x2": [r["launches"][name]
                                        for r in srv_e[DSV2_236B_ID]],
                "train_dsv2_2x2": [r["launches"][name] for r in trn_e],
                "train_dsv2_2x2_pipelined": [r["launches"][name]
                                             for r in trn_e8]}

    ck_d22, ck_big = ck_e[DSV2_ID], ck_e[DSV2_236B_ID]

    def dsv2_row(r, extra=()):
        """One reading of ``checks_wide`` (DeepSeek-V2-Lite's or
        Jamba's)."""
        return {n: r[n] for n in ("ms", "device_ms", "kernel_device_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_abs_err") + extra
                if n in r}

    def bwd_err(kernel):
        return max(v["max_abs_err"] for k, v in bwd.items()
                   if k == kernel or k.startswith(kernel + "_"))

    def pair_row(k):
        """K1's or K2's times at the staged layout (S = 4864), and every
        reading at both layouts."""
        main = k["S=4864"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "call_ms", "host_us")
        lib = ("device_ms", "call_ms", "host_us")
        return {**{n: main[n] for n in keys},
                **{f"library_{n}": main["library"][n] for n in lib},
                "layouts": {label: {**{n: r[n] for n in keys},
                                    **{f"library_{n}": r["library"][n]
                                       for n in lib}}
                            for label, r in k.items()}}

    kp = k4["prefill"]
    emit({"kernels": [
        {"name": "moe_permute.permute", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_permute.cu",
         "replaces": "src/repro/kernels/moe_permute/kernel.py:54",
         "launches": total("moe_permute.permute"),
         "launches_by_path": by_path("moe_permute.permute"),
         "max_abs_err": 0.0,
         "backward_max_abs_err": bwd_err("K1"),
         **pair_row(k1),
         "dsv2_lite_2x2": dsv2_row(ck_ds["K1"], ("call_ms", "host_us")),
         "jamba_2x2": dsv2_row(ck_jb["K1"], ("call_ms", "host_us")),
         "ep_tp_S=8192": dsv2_row(ck_ep["K1"], ("call_ms", "host_us")),
         "dsv2_2x2_batch4": dsv2_row(ck_d22["K1"], ("call_ms", "host_us")),
         "dsv2_236b_2x2": dsv2_row(ck_big["K1"], ("call_ms", "host_us"))},
        {"name": "moe_permute.unpermute", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_permute.cu",
         "replaces": "src/repro/kernels/moe_permute/kernel.py:88",
         "launches": total("moe_permute.unpermute"),
         "launches_by_path": by_path("moe_permute.unpermute"),
         "max_abs_err": max(e["max_abs_err"]
                            for e in list(k2.values()) + k2_edges
                            + [ck_ds["K2"], ck_jb["K2"], ck_ep["K2"],
                               ck_d22["K2"], ck_big["K2"]]),
         "backward_max_abs_err": bwd_err("K2"),
         **pair_row(k2),
         "dsv2_lite_2x2": dsv2_row(ck_ds["K2"], ("call_ms", "host_us")),
         "jamba_2x2": dsv2_row(ck_jb["K2"], ("call_ms", "host_us")),
         "ep_tp_T=2048": dsv2_row(ck_ep["K2"], ("call_ms", "host_us")),
         "dsv2_2x2_batch4_top6": dsv2_row(ck_d22["K2"],
                                          ("call_ms", "host_us")),
         "dsv2_236b_2x2_top6": dsv2_row(ck_big["K2"], ("call_ms", "host_us"))},
        {"name": "moe_gemm.grouped_ffn_ragged", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:228",
         "launches": total("moe_gemm.grouped_ffn_ragged"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn_ragged"),
         "max_abs_err": max([k3["max_abs_err"], k3_222["max_abs_err"],
                             k_replan["K3_max_abs_err"],
                             k_222["K3_max_abs_err"],
                             ck_ds["K3"]["max_abs_err"],
                             ck_jb["K3"]["max_abs_err"],
                             ck_ep["K3"]["max_abs_err"],
                             ck_d22["K3"]["max_abs_err"],
                             ck_big["K3"]["max_abs_err"]]
                            + [e["max_abs_err"] for e in k3e]),
         "backward_max_abs_err": bwd["K3"]["max_abs_err"],
         **{n: k3[n] for n in ("ms", "device_ms", "kernel_device_ms",
                               "call_ms", "host_us", "plain_ms", "bound_ms",
                               "bound_by", "tiles")},
         "library_ms": None,
         "layouts": {label: {n: r[n] for n in (
             "ms", "device_ms", "kernel_device_ms", "call_ms", "host_us",
             "plain_ms", "bound_ms", "bound_by", "tiles", "max_abs_err")}
             for label, r in (("2x2", k3), ("2x2x2", k3_222))},
         "dsv2_lite_2x2": dsv2_row(ck_ds["K3"], ("tiles", "valid_rows")),
         "jamba_2x2": dsv2_row(ck_jb["K3"], ("tiles", "valid_rows")),
         "ep_tp_R8192_f1024": dsv2_row(ck_ep["K3"], ("call_ms", "host_us",
                                                     "tiles")),
         "dsv2_2x2_batch4": dsv2_row(ck_d22["K3"], ("tiles", "valid_rows")),
         "dsv2_236b_2x2": dsv2_row(ck_big["K3"], ("tiles", "valid_rows",
                                                  "active_experts"))},
        {"name": "moe_gemm.grouped_ffn_ragged_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:312",
         "launches": total("moe_gemm.grouped_ffn_ragged_quant"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn_ragged_quant"),
         "max_abs_err": max(k7["max_abs_err"], k7_full["max_abs_err"],
                            ck_ds["K7"]["max_abs_err"],
                            ck_jb["K7"]["max_abs_err"],
                            ck_ep["K7"]["max_abs_err"],
                            ck_d22["K7"]["max_abs_err"],
                            ck_big["K7"]["max_abs_err"]),
         "backward_max_abs_err": bwd["K7"]["max_abs_err"],
         "ms": k7["ms"], "device_ms": k7["device_ms"],
         "kernel_device_ms": k7["kernel_device_ms"],
         "quantize_ms": k7["quantize_ms"],
         "weights_quantize_ms": k7["weights_quantize_ms"],
         "weights_quantize_device_ms": k7["weights_quantize_device_ms"],
         "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None,
         "layouts": {"S=608": k7, "S=4864": k7_full},
         "dsv2_lite_chunk0": dsv2_row(ck_ds["K7"], ("chunks", "R",
                                                    "valid_rows")),
         "jamba_chunk0": dsv2_row(ck_jb["K7"], ("chunks", "R",
                                                "valid_rows")),
         "ep_tp_chunk0_f1024": dsv2_row(ck_ep["K7"], ("chunks", "R",
                                                      "valid_rows")),
         "dsv2_2x2_batch4_chunk0": dsv2_row(ck_d22["K7"], ("chunks", "R",
                                                          "valid_rows")),
         "dsv2_236b_2x2_chunk0": dsv2_row(ck_big["K7"], ("chunks", "R",
                                                        "valid_rows",
                                                        "active_experts"))},
        {"name": "moe_fused.local_moe", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_fused.cu",
         "replaces": "src/repro/kernels/moe_fused/kernel.py:123",
         "launches": total("moe_fused.local_moe"),
         "launches_by_path": by_path("moe_fused.local_moe"),
         "max_abs_err": max(e["max_abs_err"]
                            for e in list(k4.values()) + k4_edges
                            + list(ck_ds["K4"].values())
                            + list(ck_jb["K4"].values())
                            + list(ck_tp["K4"].values())
                            + [r for aid in ck_fam
                               for k, r in ck_fam[aid].items()
                               if k.startswith("K4")]
                            + [r for aid in ck_e
                               for r in ck_e[aid]["K4"].values()]),
         "backward_max_abs_err": bwd["K4"]["max_abs_err"],
         **{n: kp[n] for n in ("ms", "device_ms", "kernel_device_ms",
                               "call_ms", "host_us", "plain_ms", "bound_ms",
                               "bound_by", "computed_rows",
                               "weighted_rows")},
         "library_ms": None,
         "layouts": {label: {n: r[n] for n in (
             "ms", "device_ms", "kernel_device_ms", "call_ms", "host_us",
             "plain_ms", "bound_ms", "bound_by", "computed_rows",
             "weighted_rows", "dense_rows", "max_abs_err")}
             for label, r in k4.items()},
         "dsv2_lite_layouts": {
             label: dsv2_row(r, ("computed_rows", "weighted_rows",
                                 "dense_rows"))
             for label, r in ck_ds["K4"].items()},
         "jamba_layouts": {
             label: dsv2_row(r, ("computed_rows", "weighted_rows",
                                 "dense_rows", "active_experts"))
             for label, r in ck_jb["K4"].items()},
         "tp2_layouts": {
             label: dsv2_row(r, ("call_ms", "host_us", "computed_rows",
                                 "weighted_rows", "dense_rows"))
             for label, r in ck_tp["K4"].items()},
         "tp2_family_layouts": {
             f"{aid} {label}": dsv2_row(r, ("call_ms", "host_us",
                                            "computed_rows", "weighted_rows",
                                            "dense_rows"))
             for aid in ck_fam for label, r in ck_fam[aid].items()
             if label.startswith("K4")},
         "ep_family_2x2_layouts": {
             f"{aid} {label}": dsv2_row(r, ("computed_rows", "weighted_rows",
                                            "dense_rows"))
             for aid in ck_e for label, r in ck_e[aid]["K4"].items()}},
        {"name": "flash_attn.flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:65",
         "launches": total("flash_attn.flash_attention"),
         "launches_by_path": by_path("flash_attn.flash_attention"),
         "max_abs_err": max([k5["max_abs_err"], k5_512["max_abs_err"],
                             ck_dn["K5_S512"]["max_abs_err"]]
                            + [e["max_abs_err"] for e in edges
                               + ck_dn["K5_edges"]
                               + list(ck_dn["K5"].values())
                               + list(ck_fm.values())
                               + list(ck_tp["K5"].values())
                               + [r for aid in ck_fam
                                  for k, r in ck_fam[aid].items()
                                  if k.startswith("K5")]]),
         "ms": k5["ms"], "device_ms": k5["device_ms"],
         "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"],
         "library_device_ms": k5["library_device_ms"],
         "shapes": {"4x128x16x64": k5, "4x512x16x64": k5_512,
                    **{f"{aid}_4x128x{r['shape'][2]}x{r['shape'][3]}"
                       f"_kv{r['kv_heads']}": r
                       for aid, r in ck_dn["K5"].items()},
                    "4x512x16x128_kv8": ck_dn["K5_S512"],
                    "whisper_encoder_4x1500x6x64_noncausal":
                        ck_fm["K5_whisper_encoder"],
                    f"internvl2_prefill_4x{VLM_BUCKET}x48x128_kv8":
                        ck_fm["K5_internvl2_prefill"],
                    "tp2_gpt3_prefill_4x128x8x64": ck_tp["K5"]["gpt3_prefill"],
                    "tp2_minitron_prefill_4x128x12x128_kv4":
                        ck_tp["K5"]["minitron_prefill"],
                    "tp2_whisper_encoder_4x1500x3x64_noncausal":
                        ck_fam["whisper_tiny"]["K5_encoder"],
                    f"tp2_internvl2_prefill_4x{VLM_BUCKET}x24x128_kv4":
                        ck_fam["internvl2_26b"]["K5_prefill"]}},
        {"name": "moe_gemm.grouped_ffn", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:185",
         "launches": total("moe_gemm.grouped_ffn"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn"),
         "max_abs_err": max(e["max_abs_err"]
                            for e in [k6, ck_tp["K6"]] + k6_edges),
         "backward_max_abs_err": bwd["K6"]["max_abs_err"],
         "ms": k6["ms"], "device_ms": k6["device_ms"],
         "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
         "library_ms": None, "bmm_chain_ms": k6["bmm_chain_ms"],
         "bmm_chain_device_ms": k6["bmm_chain_device_ms"],
         "tp2_f1024": {n: ck_tp["K6"][n] for n in (
             "shape", "f", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "bmm_chain_ms", "bmm_chain_device_ms",
             "max_abs_err")}},
        {"name": "decode_attn.decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn/kernel.py:65",
         "path": "none: no model calls it, as in the reference",
         "launches": total("decode_attn.decode_attention"),
         "launches_by_path": by_path("decode_attn.decode_attention"),
         "check_launches": sum(e["launches"] for e in [k8] + k8_edges
                               + [ck_dn["K8"]] + ck_dn["K8_edges"]),
         "max_abs_err": max(e["max_abs_err"] for e in [k8] + k8_edges
                            + [ck_dn["K8"]] + ck_dn["K8_edges"]),
         "ms": k8["ms"], "device_ms": k8["device_ms"],
         "plain_ms": k8["plain_ms"],
         "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
         "library_ms": k8["library_ms"],
         "library_device_ms": k8["library_device_ms"],
         "hd128": {n: ck_dn["K8"][n] for n in (
             "B", "L", "H", "K", "hd", "zero_length_requests", "valid_rows",
             "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library_device_ms")}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
