#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vitron_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no `ok` line):
1. device: the `nvidia-smi` name and power limit; exit 1 without CUDA;
   TF32 off for matmuls and cuDNN, deterministic cuDNN algorithms.
2. build: the hand CUDA kernels from `vitron_tpu_torch/csrc/` (one nvcc per
   source, all started together, sm_90a).
3. kernel vs plain at the chat and serving paths' shapes: int4_matmul
   (bf16 x, M in {1, 4, 8, 384}: the decode GEMV at batch 1, 4 and 8 and
   the prefill GEMM, the four Vicuna-7B (K, N) pairs; each output row
   within INT4_ROW_REL of its largest, the same bits twice, CUDA-event
   times with the weights flushed from L2 by a read, GB/s at M <= 8 and
   TFLOP/s at M 384 beside the bound, and torch.matmul on the
   pre-dequantized bf16 weight as a reference, not a library port) and
   flash_attention (bf16, D = 128: masked prefill, cached chunk, GQA, and
   the ContinuousBatcher's two staged-admission chunks of the image chat
   prompt: [1, 256] at q_offset 0 and [1, 128] at q_offset 256 over 384
   slots); error and CUDA-event times.
4. kernel vs plain at the GLIGEN path's shapes: flash_attention (bf16,
   non-causal, shift 0, D 40/80/512 with the ragged fuser lengths),
   geglu_ff (the four UNet sites, float32 and bf16), group_norm_sums (two
   UNet sites, the VAE's full resolution and the SEEM pixel decoder's four
   levels, float32 and bf16; also run twice for identical bits; device
   times from CUDA-graph replay, beside torch.var_mean).
5. kernel vs plain at FocalNet-L's shapes: depthwise_conv2d (the 16
   (stage, k) sites at 512^2 and a ragged shape, float32 and bf16; within
   DW_TOL and, at each output pixel's scale, PIXEL_REL; the same bits
   twice), device times from CUDA-graph replay, beside F.conv2d(groups=C).
5b. kernel vs plain at the task-D path's shapes, float32 and bf16, at the
   four (N, C, heads) levels of the t2v block plan (2 x 24 frames):
   temporal_conv_k3 (beside cuDNN's F.conv2d with a (3, 1) filter),
   frame_attention (beside scaled_dot_product_attention on [B N, H, F, D]),
   geglu_ff at C 512/1024/2048, group_norm_sums at every [B, R, C] that
   one UNet call and the VAE decode of 24 frames give it (from the block
   plan and the VAE config; also run twice for identical bits), and
   flash_attention at the VAE decode's [24, 2880, 1, 512]; then
   frame_attention past 32 frames (B7_LONG_FRAMES: 40 and 64) at the first
   level's [2, F, 2880, 512] (8 heads of 64).
5c. B9 (conv3x3_same) against its plain version, float32 and bf16, at the
   16 distinct eligible stride-1 3x3 convs of the i2vgen UNet at task G's
   64x64 latents, batch 2 x 16 (from the block plan; within VIDEO_TOL and,
   at each output pixel's scale, PIXEL_REL; the same bits twice), each with
   its TFLOP/s beside cuDNN's bf16 F.conv2d on the rounded inputs; then its
   VJP (dx through the kernel) against the plain VJP at a 32x32 level
   shape. No main path calls it.
5d. kernel vs plain at the task-G path's shapes, float32 and bf16: B6, B7
   and B3 at the i2vgen plan's four levels (2 x 16 frames of 64x64), B8 at
   every [B, R, C] of one UNet call, the 512^2 VAE encode and the 16-frame
   decode, and B2 at D 512 (encode [1, 4096, 1, 512], decode
   [16, 4096, 1, 512]) and D 64 (the 32x32 level's self-attention,
   [32, 1024, 16, 64]).
   Every kernel row of phases 3-5d prints its bound (bytes once at
   3.35 TB/s or FLOP at the peak for the type, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time.
6. the chat slice at full width: VitronSystem.chat on Vicuna-7B with random
   packed-int4 projections and lm_head + bf16 ViT-L/14 tower, projector and
   region extractor; a 336x448 image, a bbox, 128 greedy tokens, twice (the
   decode chunk replays a captured CUDA graph; a replay counts the launches
   its graph recorded); kernel launch counts, request / prefill / decode
   times, peak memory.
6b. the serving stack on the same system: generate_scan at
   bench_e2e_request's shape (an image + 49 words, 128 greedy tokens),
   replayed twice and run eagerly, identical, with the decode rate of each
   and the launches of a replayed chunk; PagedServer.step_n at
   bench_continuous_batching's shape (prefill 256, SERVE_CHUNKS chunks of
   64 greedy tokens) at batch 1, 4 identical prompts (identical rows) and 4
   prompts, each row held against the single-stream Generator on its
   prompt (identical, or a first divergence where the single stream's
   top-2 logits lie within DIVERGE_ULPS bf16 ulps), serve_batch1_tok_s,
   serve_batch4_tok_s; four concurrent image chat requests (one sampled)
   through ServingPipeline's ContinuousBatcher, staged with decode chunks
   between their prefill chunks, and a short request admitted while they
   are staged, the greedy replies held against each request served alone;
   then apps/serve.py on 127.0.0.1: /health, POST /chat with a PNG (twice:
   the first captures), /stats (the memory plan's budget is the card's total
   memory). Each main-path run (the replayed generate_scan, the step_n
   replays at batch 1 and 4, the batcher's requests, the second HTTP
   request) is counted alone from zeroed counts and held to its exact
   launches; their sum is the kernels line's `serve` count.
   Phases 6 and 6b run with VITRON_SPEC=0: they measure the plain decode.
6c. speculative decode on the same system (`phase_spec`, VITRON_SPEC's
   default probe policy and `speculative=True`), F = SPEC_FORWARDS verify
   forwards a graph replay (`tools/spec_forwards.py` times other F): (a)
   speculative=True over 256 tokens, whole and in 64-token segments (best
   of two), (b) the default probe over 512 tokens (a plain chunk, then it
   must upgrade), (c) a KeywordStopper request through VitronSystem.chat at
   VITRON_SPEC=2 (segments) whose EOS is the plain stream's token first
   seen last, (d) the same without the EOS and with
   VITRON_SPEC_TPF_MIN=1000 (back to plain chunks), (e) phase 6's
   128-token chat at the default policy beside VITRON_SPEC=0, three turns
   each (the same tokens on the same 512-slot graph: the probe stays
   plain); each stream against the graphed plain greedy stream (identical
   or a near-tie, as in 6b); each measured run held to its exact launches
   (225 B1 + 32 B2 a replayed verify forward, masked ones included; 225 B1
   a plain chunk step; the prefill); tok/s, tokens per forward, forwards,
   replays a segment; no segment emits nothing. Phase 3 holds B1 at M 5
   and B2 at the 5-query window with its q_offset on the device over 512
   and 1,024 slots.
7. the chat path on the CPU and the card: a 2-layer full-width float32
   model, one prefill of the same request on both, last-position logits
   compared.
8. task B at full width: `SeemConfig()` registered with bf16 towers; text,
   stroke and 'segment all' replies routed by `VitronSystem.route` on a
   480x640 image, each twice (identical outputs, non-constant masks, and
   for 'segment all' identical, non-constant class and mask logits);
   depthwise and group-norm launches against the config (96 and 7 per
   encode_image); request times, peak memory; then a torch.profiler trace
   of a text request with ranges around encode_image and the decoder (host
   and kernel time of each, device busy and idle share, time by kernel).
9. task E at full width: a stroke tracked over 8 frames of 480x640, twice;
   9 encode_image's launches.
10. task A at full width: a fixed protocol reply routed to the port's
   `handle_a`: SD v1.4 GLIGEN UNet, SD VAE, CLIP-L text, float32, loaded from
   the GLIGEN bundle that phase 26 (a) wrote, 512^2, 30 grounding slots, 50
   PLMS steps, guidance 7.5, alpha (0.3, 0, 0.7);
   twice (identical, non-constant images); launch counts of all three
   kernels against the block plan; request time, ms per CFG UNet call, VAE
   decode ms, peak memory.
11. task C at full width: the 9-channel inpainting UNet (loaded from phase
   26 (a)'s inpainting bundle) through handle_c's region branch, TASK_C_STEPS PLMS steps (fewer than A's 50, to save
   time), guidance 30; launch counts. Then through its SEEM branch: two
   ';'-separated phrases, no region, no sketch; 2 encode_image's launches
   plus GLIGEN's.
11b. the A9 and A10 remainders, each phase's seconds printed: (a) GLIGEN's
   style request at full width (`phase_style`: task A's UNet with the
   with-image position net, 60 grounding tokens, the CLIP ViT-L/14 tower
   pooled at 224 with its projections, one style crop, 50 PLMS steps, twice,
   B2/B3/B8 held to exact counts; phase 4 holds B2 at its 4,156- and
   1,084-token fusers); (b) eps DDIM (eta 0, eta 1, the inpainting
   composite) and DPM-Solver++(2M), 10 steps each over task A's CFG eps at
   64x64 latents, finite, exact counts, ms a step; (c) the grounding nets at
   full width, each first through its converter (phase 26 (e)) (hint net in the canny and sem forms from a 480x640 map
   resized to 448, 18 B4 launches a forward; the keypoint net at 8 persons;
   the canny / sem downsamplers and the hed resize); (d) Swin-L with the
   deformable pixel decoder (5 B8 launches), DaViT-T (24 B4 launches),
   ResNet-50 and -101 at 512x512, float32 and bf16, twice each (identical); (e)
   B4 at ConvNeXt-T's and DaViT-T's 8 sites (`NEW_DW_SITES`), float32 and
   bf16, as phase 5; (f) the hint net, Swin-L + deformable decoder and
   DaViT-T at reduced depth on the CPU and the card.
12. the bf16 CFG UNet step at bench.py's `bench_sd_unet` shape (SD v1.4, no
   grounding, bf16 params, [2, 64, 64, 4] latents, [2, 77, 768] context):
   `sd_unet_cfg_steps_per_s`.
13. the diffusion path on the CPU and the card: one full-width float32
   grounded CFG UNet call at reduced depth and latent size (one level,
   32x32 latents: four transformer blocks whose self-attention and fuser
   sites take the flash kernel on the card), compared with the CPU.
14. SEEM on the CPU and the card: one full-width float32 segment_text at
   reduced depth (FocalNet depths 1/1/1/1 with all four focal levels, 2
   encoder, decoder and language layers, 256^2): mask logits, the matched
   query and the flipped cross-attention-mask bits.
15. task D at full width: `Text2VideoConfig()` (UNetSD_T2V, SD VAE, CLIP
   text 1024 wide, float32, 24 frames at 320x576, guidance 9) with random
   weights (zero leaves filled), the UNet loaded from the fp16 .pth that
   phase 26 (b) wrote; a fixed protocol reply routed to the port's
   `handle_d`, TASK_D_STEPS DDIM-v steps, twice: identical, finite,
   non-constant frames; launch counts of all five kernels against the block
   plan; request time, ms per CFG UNet call, VAE decode ms, peak memory.
15b. task G at full width: `Image2VideoConfig()` (UNetSD_I2VGen, SD VAE,
   CLIP text 1024 wide, float32, 16 frames at 512x512, fps 16, guidance 9)
   with random weights (zero leaves filled), the UNet through its converter
   (phase 26 (c)), and a seeded stub image embedder, built after task D's
   pipeline is freed; a fixed protocol reply
   routed to the port's `handle_g` with a 480x640 image (resized on the
   host, ROADMAP C7), TASK_G_STEPS DDIM-v steps, twice: identical, finite,
   non-constant frames; launches of all five kernels against the block plan
   x steps plus the VAE encode's and decode's, none of B9; request time, ms
   per CFG UNet call, VAE encode and decode ms, peak memory.
15c. task F at full width (`phase_task_f`): the SD v1.5 UNet, a canny and a
   depth ControlNet, DPT-hybrid, the SD VAE and CLIP-L text (float32, random
   weights, zero leaves filled) and a synthetic atlas bundle (random IMLP
   nets at the released NLA geometries, 16 frames of 448x768, 256^2
   atlases, rendered from the IMLP nets after their conversion), every net
   first through its converter (phase 26 (d)); a fixed
   protocol reply routed to the port's `handle_f`: 3
   keyframes, 20 DDIM steps, guidance 9, a fore and a back prompt; 16 uint8
   frames; B2, B3 and B8 launches held to the plan's counts
   (`task_f_plan`), with each distinct B2 (bf16), B3 and B8 (float32)
   shape first held against its plain version (`phase_task_f_kernels`);
   request seconds, ms a CFG ControlNet + UNet call; then one ControlNet +
   UNet call on the CPU and the card at one level and 32x32 latents.
16. the bf16 CFG video UNet step at bench.py's `bench_video_unet` shape
   ([2, 24, 40, 72, 4] latents, [2, 77, 1024] context):
   `video_unet_cfg_steps_per_s` and `video_unet_mfu` (the block plan's FLOP
   against 989 TFLOP/s).
17. the video path on the CPU and the card: one float32 CFG-batch t2v UNet
   call at the real widths but two levels (512/1024), 8 frames, 16x16
   latents.
17b. the i2v path on the CPU and the card: one float32 CFG-batch i2vgen UNet
   call at the real widths but two levels (512/1024), 8 frames, 16x16
   latents, with text, local-image and global conditioning.
18. the training kernels against their plain versions, bf16 and float32:
   the flash forward with its LSE (B2), dK/dV (B5a) and dQ (B5b) at the
   trainer's [2, 2048, 32, 128] (causal, right-padded kv_mask), a GQA row
   (32 query heads on 8, q_offset 512) and a non-causal D 64 row; errors of
   out, lse, dq, dk, dv, each output row at its own scale (B2's query rows
   within FLASH_ROW_REL, dq's query rows and dk's and dv's key rows within
   FLASH_BWD_ROW_REL), the same bits twice, CUDA-event times beside the
   bound, B5a + B5b's rate over the seven products they run and the SDPA
   backward; then B1 at the trainer's M = 4096 rows and the four (K, N)
   pairs (TFLOP/s beside the bound, per-row limit, the same bits twice).
19. the LoRA trainer at full width: `Trainer.fit` on
   `VitronConfig.serving(llm=vicuna_7b(attn_impl="flash", max_seq_len=2048))`
   with random packed-int4 projections and lm_head and a bf16 ViT-L/14,
   LoRA r 128 on all seven targets + projector + region extractor, AdamW
   2e-4 with warmup-cosine, TRAIN_BATCH rows of 2048, TRAIN_STEPS steps,
   twice from the same state: finite, equal losses; LoRA b and projector
   still at step 1 (learning rate 0) and moved at step 2; launches = the
   config's a step; step seconds, trained tokens/s, peak memory; a profiled
   step by kernel group, and the device time of B1's backward dequantize.
20. training on the CPU and the card: one LoRA step's loss and gradients
   on a 2-layer full-width float32 model with int4 projections, pad_len 512,
   one of its two samples asking about a region box (the region
   extractor's gradient held too); then the same step with a bf16 LLM (B1
   and B2/B5 on their tensor-core paths) against the CPU's plain versions
   in bf16, every gradient by cosine and relative norm
   (TRAIN_BF16_GRAD_LIMIT).
21. the diffusion trainers' kernels: B2 with its LSE, B5a and B5b in bf16 at
   the GLIGEN step's four flash sites ([2, 4096, 8, 40] and [2, 1024, 8, 80]
   self-attention, [2, 4126, 8, 40] and [2, 1054, 8, 80] fusers) and at D
   160 ([2, 1024, 8, 160]), non-causal, shift 0: errors, each dq query row
   and dk/dv key row within FLASH_BWD_ROW_REL, the same bits twice, times
   beside the bound and the SDPA backward; B8 at every shape of the GLIGEN
   step (float32); B6, B7, B3, B8 at every shape of the video step
   (float32, 1 x VIDEO_TRAIN_FRAMES frames of 32x32); then each new
   autograd.Function (B3, B4, B6, B7, B8) at one site: a grad_fn under
   grad, its launches (B6's and B4's dx launch their kernels), the card's
   gradients against the CPU's autograd of the plain version, the same bits
   twice.
22. the GLIGEN trainer at full width (`GligenConfig()`, batch 2 of VAE
   latents of seeded 512^2 images, CLIP-L context and phrases, 30 slots,
   AdamW 5e-5), GLIGEN_TRAIN_STEPS steps twice from the same state: equal
   losses, frozen tensors bit-equal, trainable ones moved, finite gradients,
   each step's launches from the block plan; step seconds, peak memory, a
   profiled step.
23. the video trainer at full width (the 4.4B t2v UNet, float32,
   `VideoTrainConfig()` with the EMA, the value clip and Adafactor at
   `annealing_lr`), batch 1 of VIDEO_TRAIN_FRAMES frames of 32x32 latents,
   VIDEO_TRAIN_STEPS steps twice from the same seeded state: as 22. Then
   the same for the 4.437B i2vgen UNet (`UNetSDVideoConfig.i2vgen_xl()`,
   with a global image embedding and a local image latent; ROADMAP C15),
   without the profiled step.
24. each trainer's step on the CPU and the card at one level: GLIGEN with
   bf16 flash on the card against float32 einsum on the CPU
   (GLIGEN_BF16_GRAD_LIMIT), the t2v and the i2vgen video UNets float32 on
   both (TRAIN_CPU_GPU_TOL); the updated tensors and EMA against the CPU's
   optimizer on the card's gradients (UPDATE_TOL).
25. (run after phase 5d, before 6) checkpoint load at full width: a
   synthetic HF-layout deployment written into the deployment's weights
   directory (`ckpt_root()`, kept until phase 27 ends; `write_deployment`:
   Vicuna-7B v1.5 fp16 safetensors shards
   with their index, a peft LoRA r 128 on the seven projections with
   non_lora_trainables.bin, CLIP ViT-L/14-336 safetensors and the
   LanguageBind video tower's .bin), loaded by
   `runtime/assembly.build_mllm_system(..., quantize="int4")` with the
   port's own safetensors reader: load seconds, the host's RSS before the
   load and its peak during it (`RssPeak`), the device peak, bytes
   written; the loaded leaves (embed, layers 0 and 31, lm_head, the
   towers' first layers, projector, region extractor) bit-equal to the
   port's CPU conversion of the same tensors; the 128-token greedy chat of
   phase 6 twice (same tokens, B1's launches exact, decode tok/s); B1
   against its plain version at the loaded prefill's M (the turn plan's
   padded length) and the four Vicuna-7B (K, N) pairs, as in phase 3; one
   POST /chat over 127.0.0.1 (an image, 128 greedy tokens), whose reply
   equals `system.chat`'s through the server's pipeline, which equals the
   single stream's tokens or first parts from them at a near-tie (as phase
   6b holds it), and each of whose tokens is the single stream's greedy
   pick fed the served tokens before it (teacher forcing), or below its
   top logit by no more than
   DIVERGE_ULPS bf16 ulps plus twice the largest |einsum - flash| logit
   difference of that stream (`check_teacher_forced`).
26. diffusion checkpoints, at full width, each part just before the phase
   that runs on what it loads: (a) before phase 10, `build_gligen`'s trees
   written as GLIGEN's generation and inpainting .pth bundles under the
   weights directory's gligen/, one at a time (fp16, a pickled config of
   a class no process can import, keys no converter reads), each loaded on
   the card by `gligen_pipeline.load_gligen_checkpoint` and kept for phase
   27; the GligenPipeline
   of phases 10, 11 and 11b is the loaded one; (b) before phase 15, the
   UNetSD_T2V written as an fp16 .pth under t2v/ and loaded by
   `unet_sd_video.convert_torch` on the card (task D runs on it); each with
   the seconds to write and to load, the bytes, the host's RSS before and at
   its peak (`RssPeak`; the mapped file's pages count in it) and its
   anonymous part, held within HOST_COPY_GIB of its value before the load
   (no host copy of the file), the device peak and every leaf bit-equal to
   the tree written (after the fp16 rounding); (c) before 15b, the
   i2vgen UNet, (d) before 15c, task F's ControlLDM canny bundle (UNet,
   ControlNet, VAE and text under their four prefixes in one dict), the
   depth ControlNet, DPT-hybrid and the four IMLP atlas nets (task F's atlas
   bundle is rendered from the converted nets), (e) in 11b (c), the hint (canny and sem), keypoint and
   downsampler nets: each written as an in-memory reference-layout state
   dict on the card and converted back, bit-equal, seconds printed; the
   phase then runs on the converted trees.
27. (run after phase 17b, before 18) the whole A-G deployment from one
   weights directory, at full width: phases 25 and 26 (a)/(b) wrote its
   chat, GLIGEN and t2v files; this phase adds, in fp16, seem_focall_v1.pt
   (FocalNet-L, `synthetic.seem_state_dict`), i2vgen/ (the UNetSD_I2VGen
   .pth), the HF CLIPTextModel dir (1024 wide, safetensors) of t2v/ that
   i2vgen/ links to, stablevideo/ (the ControlLDM canny bundle, the depth
   ControlNet, DPT-hybrid; one float32 NLA checkpoint), each file's bytes
   and write seconds printed (the card machine's disk takes 45 GiB of
   writes a call: the whole directory is ~41 GiB; each file of phases
   25-27 goes through `disk_write`, which fails a write that would take
   the process past WRITE_BUDGET_BYTES, 42 GiB, and this phase prints the
   count). `runtime/assembly.
   build_system_from_weights(dir, quantize="int4", device="cuda")` (the
   crc32 tokenizer, the stub CLIP tokenizer and image embedder: the card
   has no transformers) loads it: its report rows, load seconds, the
   host's anonymous RSS growth (held within HOST_COPY_GIB), the device
   peak and the memory plan's rows; SEEM's converted leaves bit-equal to a
   CPU conversion of the same file. Then one greedy chat turn, tasks B
   and E routed on the loaded SEEM at full depth (B4 and B8 launches exact,
   as phases 7 and 8), and A, C, D, G and F once each through the
   assembled system, at WEIGHTS_STEPS sampler steps, D at WEIGHTS_D_FRAMES
   frames, G at WEIGHTS_G_FRAMES, F on a one-frame video (one keyframe)
   (cuts: their full-depth runs are phases 10, 11, 15, 15b and 15c); A, C,
   D and G with launches exact. The directory is then removed.
28. (run after 29 (b), before 8) MPT-7B at mosaicml/mpt-7b's published widths
   (`MPT_7B`), bf16 random weights from a seed on the card: a 512-token
   cached prefill and 64 greedy cached tokens (`mpt_prefill_s`,
   `mpt_decode_tok_s`, the peak), a prefix-LM prefill, no kernel launched;
   then 2 layers of the same widths in float32 on the CPU and the card: the
   prefill's logits within CPU_GPU_TOL, the same 8 greedy tokens.
29. (run after 6c, on phase 6's system) VITRON_W4A8=1: a new engine on the
   same packed weights, whose decode chunks run Q1 (`w4a8_matmul`) and its
   prefill B1, as JAX's: the 128-token chat twice, graphed, launches exact
   (`w4a8_decode_tok_s` beside phase 6's rate), the same steps eager
   against the graphed scan (identical tokens); Q1's rows at the chat's
   four (K, N) shapes, M 1/4/5/8/384, beside B1 on the same inputs. (b)
   after 7: a 2-layer full-width float32 Vicuna's W4A8 scan on the CPU and
   the card (W4A8_CPU_GPU_TOL, the same tokens or a near-tie).
30. W8A8: (a) after 11, VITRON_UNET_QUANT=w8a8 through GligenPipeline on
   the resident GLIGEN trees: task A at W8A8_TASK_A_STEPS PLMS steps twice
   (`taskA_w8a8_request_s`, Q2 at every `sd_w8a8_sites` conv), a quantized
   CFG call's ms beside the float32 call's, Q2's rows at every site beside
   cuDNN's float32 and bf16 convs (the path it replaces, not a port); (b)
   after 15, VITRON_VUNET_QUANT=w8a8 through Text2VideoPipeline on the
   resident t2v trees: task D at W8A8_TASK_D_STEPS steps twice
   (`video_unet_w8a8_cfg_steps_per_s`), Q2's rows at every
   `video_w8a8_sites` conv, the opt-in q8 dot and q8t taps bit-equal to
   their exact sums; (c) after 17b, tiny quantized SD and t2v UNets on the
   CPU and the card (W8A8_CPU_GPU_TOL, Q2's launches at every site).
31. The mesh (A16's serving half) on a one-rank NCCL group over a store at
   127.0.0.1 (`nccl_group`; the card takes no second rank), every
   collective issued: (a) after 29, phase 6's system after `install_mesh`
   gives the 128 greedy tokens it gave without the mesh, its decode chunk
   a CUDA graph holding the collectives (launches exact); a
   ContinuousBatcher on the mesh co-batches two requests to the tokens of
   one without it (the lockstep broadcasts issued); a RING_PREFILL-token
   prefill at attn_impl="ring" within FLASH_ROW_REL of "flash" (launches
   exact); the memory plan's per-device rows for MESH_PLAN_CHIPS cards;
   after 15, task D's t2v tree through `shard_video_step` over the
   one-rank (cfg, frames) mesh equal to one plain CFG call, bit for bit
   (launches exact); these runs' launches are the `mesh` path's. (b) The
   ring's device half at RING_SHAPE (Vicuna-7B widths) in RING_BLOCKS
   blocks: every rank's body run here, B2 with its LSE a block, merged in
   float32, each query row within FLASH_ROW_REL of B2 over the whole
   sequence. (c) The video's device half at the t2v levels' widths,
   VIDEO_FRAMES frames in MESH_SLICES slices: the halo'd B6 (VIDEO_TOL),
   B8's slice sums (GN_TOL) and B7 on the gathered frames (exact) against
   their whole forms. (d) The dryrun's legs at 2 and 4 NCCL ranks where
   the machine has the cards; with one, the phase says why not.
32. (run after 19, on its tree) the sharded train step (A16b):
   `make_train_step` with lora.trainable_filter() (the projector and the
   region extractor, no LoRA factors) under AdamW after
   clip_by_global_norm(1.0), TRAIN_MESH_STEPS steps of TRAIN_BATCH rows of
   TRAIN_SEQ (the first with a box) plain, then as many from the same
   start on a one-rank NCCL mesh after shard_params(...,
   VITRON_SHARDING_RULES), every collective of the step issued: the
   losses and every updated leaf bit-equal, each arm's launches exact, its
   step seconds and peak; then the dry run's train leg on that group; the
   mesh arm's launches are the `train_mesh` path's.
Then one line lists each bf16 B2 row (the 22 of phases 3, 4, 5b, 5d, 18
and 21 that every main path's type gives it) with its kernel ms beside
F.scaled_dot_product_attention's. The line before the last is a JSON object
with one entry per kernel (with its launches on each main path); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import atexit
import collections
import collections.abc
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time
from unittest import mock

import numpy as np

INT4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
MEASURED = {}  # numbers a later phase prints beside its own (phase 6's decode rate)
INT4_TOL = 1e-2   # max |kernel - plain| / max |plain|: bf16 output rounding
# B1's bf16 rows are also held at each output row's scale: max |kernel -
# plain| over a row over that row's largest |plain|. Both sides round the
# same float32 sums (summed in other orders) to bf16, so an output flips by
# at most one bf16 ulp, 2^-7 of its own size.
INT4_ROW_REL = 2 ** -7
FLASH_TOL = 2e-2  # max |kernel - plain| on unit-normal bf16 inputs
# B2 is also held at each query row's own scale: max |kernel - plain| over a
# row's D outputs over that row's largest |plain| (a row whose plain outputs
# are all 0 must be 0). The kernel rounds p against its running max and the
# plain version against the row max, and both round the output to bf16: one
# output flip is at most one bf16 ulp, 2^-7 of the row's largest. Dropping
# one 64-key tile of 4,096 keys, or the 30-key ragged tail at 4,126, moves a
# row by ~0.08 of its largest (unit-normal inputs).
FLASH_ROW_REL = 2 ** -6
# B5a and B5b are held at each output row's scale too (flash_row_rel):
# query rows of dq, key rows of dk and dv. The H100 read 7.46e-3 to
# 9.22e-3 in bf16 at the training rows (float32 sums in other orders flip
# roundings of p, ds and the outputs: one bf16 ulp is 2^-7 of a row's
# largest; the GQA row's dv adds four heads' roundings), so the bf16 limit
# is 2^-6, as B2's; float32 read 0 (the FMA kernels add each
# output's terms in the order of the plain version's products). Dropping one
# 64-key tile of a dq row or one 64-query tile of a dk/dv row moves the row
# by ~(64 / rows summed)^(1/2) of its largest: 0.18 at 2,048. A row where
# the plain output is cancellation noise -- a causal row that sees one key
# has ds = p (dP - delta) with delta = dP, so JAX's dq is 0 up to the order
# of float32 sums -- is held at FLASH_BWD_ROW_FLOOR of the tensor's largest.
FLASH_BWD_ROW_REL = {"bfloat16": 2 ** -6, "float32": 1e-4}
FLASH_BWD_ROW_FLOOR = 2 ** -10
CPU_GPU_TOL = 1e-3  # float32 on both sides: only the order of sums differs
GEGLU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|
GN_TOL = 1e-5  # max |kernel - plain| / max |plain|: float32 sums in two orders
# the diffusion CPU-vs-card check, max |card - cpu| / max |cpu|: with the
# flash sites on the einsum path on both sides only the order of float32 sums
# differs; with them on the kernel, q/k/v are rounded to bf16 (2^-9 relative)
# at the eight flash sites, which moves the eps by up to a few percent
UNET_CPU_GPU_TOL = {"einsum": 1e-3, "flash": 5e-2}
TASK_A_REPLY = ("<module>A</module><instruction>a red car on a street</instruction>"
                "<region>[0.1,0.2,0.6,0.8]</region>")
TASK_C_REPLY = ("<module>C</module><instruction>a green bus</instruction>"
                "<region>[0.25,0.1,0.75,0.6]</region>")
TASK_C_STEPS = 10
TASK_B_REPLY = "<module>B</module><instruction>the red car</instruction>"
TASK_B_PANOPTIC_REPLY = "<module>B</module><instruction></instruction>"
TASK_E_REPLY = "<module>E</module><instruction>track the red car</instruction>"
TASK_C_SEEM_REPLY = "<module>C</module><instruction>the red car; a dog</instruction>"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# peak rates of the bound (H100 SXM data sheet, dense, at 700 W): bf16 on the
# tensor cores for the bf16 matrix products, int8 on the tensor cores for
# Q1 and Q2, float32 on the CUDA cores for everything else (float32
# products run in full float32: TF32 is off)
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12, "int8_tensor": 1979e12}
DW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # max |kernel - plain| / max |plain|
# B4 and B9 are also held at each output pixel's scale (`flash_row_rel` over
# the pixel's C or D values): max |kernel - plain| over the pixel over its
# largest |plain|. In float32 only the order of the sums (and B4's fused
# multiply-adds) differ; in bf16 both sides round nearly equal float32 sums,
# so an output flips by at most one bf16 ulp, 2^-7 of its own size. A
# dropped 64-channel block of one tap moves a pixel by ~10% of its scale.
PIXEL_REL = {"float32": 1e-5, "bfloat16": 2 ** -7}
BBOX = [60.0, 40.0, 300.0, 260.0]
PROMPT = "What is the object in the marked region doing?"
NEW_TOKENS = 128


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi gave nothing"


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of fn() in ms; `flush` (a buffer larger than
    the 50 MB L2) is read before each run, so the weights come from device
    memory, as they do in decode, and the L2 holds clean lines, as it does
    there (the previous projection's weights). Writing the buffer instead
    would leave ~50 MB of dirty lines whose write-back the timed call pays:
    ~15 us at 3.35 TB/s, a cost no decode step has."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one fn() in ms: `calls` calls captured in a CUDA graph
    and replayed, so the host's launch cost (~20-40 us a call from Python,
    more than a small kernel runs) stays out of the reading."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def row(err, rel, ms, plain_ms, nbytes, flops, peak, library_ms=None) -> dict:
    """One kernel-vs-plain measurement with its bound: the least time for
    `nbytes` (each input read once, each output written once) at 3.35 TB/s
    and for `flops` at the `peak` rate, whichever is larger."""
    return {"err": err, "rel": rel, "ms": ms, "plain_ms": plain_ms,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / PEAK_FLOPS[peak] * 1e3, "library_ms": library_ms}


def bound_text(r: dict) -> str:
    b = max(r["bytes_ms"], r["ops_ms"])
    by = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    return f"bound {b:.4f} ms ({by}), library {lib}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tree_map(fn, tree):
    """fn applied to every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def sdpa_ms(torch, q, k, v, attn_mask=None) -> float:
    """CUDA-event time of F.scaled_dot_product_attention on the same
    [B, S, N, D] inputs (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, enable_gqa=gqa), iters=10)


def flash_row_rel(got, want, floor: float = 0.0) -> float:
    """max over rows of max |got - want| over the row's D outputs divided by
    the row's largest |want|, or by `floor` times the tensor's largest
    |want| where that is larger (0/0 counts as 0), for [..., D] outputs:
    B2's query rows, and with floor FLASH_BWD_ROW_FLOOR the query rows of
    B5b's dq and the key rows of B5a's dk and dv."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    scale = scale.clamp_min(max(floor * scale.max().item(), 1e-30))
    return (diff / scale).max().item()


def int4_row(torch, card: str, g, m: int, k: int, n: int, flush=None, iters: int = 20) -> dict:
    """B1 against its plain version on x [m, k] bf16 and a random packed
    [k/2, n] weight with scales: max |kernel - plain| over max |plain| and at
    each output row's scale (INT4_ROW_REL), the same bits twice, CUDA-event
    times of the kernel and the plain version (`flush` read before each run,
    so the weights come from device memory as they do in decode), the
    bound and the rate (GB/s of packed bytes for the GEMV, TFLOP/s above).
    Beside them, torch.matmul of x with the weight dequantized to bf16
    beforehand: a reference only, on other inputs (four times the weight
    bytes), not a library call of the same function -- no PyTorch call takes
    this int4 packing."""
    from vitron_tpu_torch.kernels import int4_matmul as i4

    dev = torch.device("cuda")
    q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8, device=dev)
    s = torch.rand((1, n), generator=g, device=dev) * 0.02 + 0.01
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    got, again = i4.int4_matmul(x, q4, s), i4.int4_matmul(x, q4, s)
    want = i4.int4_matmul_plain(x, q4, s)
    err, rel = rel_err(got, want)
    row_rel = flash_row_rel(got, want)
    same = bool(torch.equal(got, again))
    del again, want
    ms = cuda_ms(torch, lambda: i4.int4_matmul(x, q4, s), iters=iters, flush=flush)
    plain_ms = cuda_ms(torch, lambda: i4.int4_matmul_plain(x, q4, s), iters=min(iters, 5),
                       flush=flush)
    w = (i4.unpack_int4(q4).float() * s).to(torch.bfloat16)
    ref_ms = cuda_ms(torch, lambda: torch.matmul(x, w), iters=iters, flush=flush)
    del w
    flops = 2 * m * k * n
    r = dict(row(err, rel, ms, plain_ms, nbytes(x, q4, s, got), flops, "bf16_tensor"),
             ref_ms=ref_ms, row_rel=row_rel)
    rate = (f"{q4.numel() / (ms * 1e-3) / 1e9:.0f} GB/s packed" if m <= i4.GEMV_MAX_M
            else f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    print(f"int4_matmul M={m} K={k} N={n} bf16: rel_err={rel:.3e} abs_err={err:.3e} "
          f"row_rel_err={row_rel:.3e} (limit {INT4_ROW_REL:.3e}), same bits twice="
          f"{same}; kernel {ms:.4f} ms ({rate}) plain {plain_ms:.4f} ms {bound_text(r)}; "
          f"reference, not a port: torch.matmul on the pre-dequantized bf16 weight "
          f"{ref_ms:.4f} ms [{card}]", flush=True)
    check(rel <= INT4_TOL and row_rel <= INT4_ROW_REL and same,
          f"int4_matmul M={m} K={k} N={n}: rel err {rel} (limit {INT4_TOL}), row rel err "
          f"{row_rel} (limit {INT4_ROW_REL}), same bits twice {same}")
    return r


def check_flash(what: str, err: float, row_rel: float) -> None:
    check(err <= FLASH_TOL and row_rel <= FLASH_ROW_REL,
          f"flash_attention {what}: abs err {err} (limit {FLASH_TOL}), row rel err {row_rel} "
          f"(limit {FLASH_ROW_REL})")


# B2's rows in the smoke: the chat path's (name, S, T, N, KH, q_offset,
# valid slots; B 1, D 128, causal), the GLIGEN path's ([B, S, N, D], keys S,
# non-causal, shift 0), the video paths' (`video_flash_sites`) and the
# trainer's (TRAIN_FLASH_CASES); `b2_shapes` lists them all
CHAT_FLASH_CASES = (
    ("prefill", 384, 512, 32, 32, 0, 305),
    ("cached-chunk", 64, 512, 32, 32, 128, 192),
    ("gqa", 384, 512, 32, 8, 0, 305),
    # the ContinuousBatcher's staged admission of the image chat prompt
    # (phase 6b: 313 slots in a 384 bucket, prefill_chunk 256): its two
    # prefill chunks at the cache's offset over the bucket's 384 slots
    ("staged-chunk-0", 256, 384, 32, 32, 0, 256),
    ("staged-chunk-1", 128, 384, 32, 32, 256, 313),
)
# the speculative verify window (spec_k + 1 = 5 queries) at a slot held on the
# device, over a 512- and a 1,024-slot cache (name, S, T, N, KH, q_offset,
# valid slots): B2 reads q_offset from a [1] int64 tensor, as in phase 6c
SPEC_FLASH_CASES = (
    ("verify-512", 5, 512, 32, 32, 400, 405),
    ("verify-1024", 5, 1024, 32, 32, 900, 905),
)
GLIGEN_FLASH_SHAPES = ((2, 4096, 8, 40), (2, 4126, 8, 40), (2, 1024, 8, 80), (2, 1054, 8, 80),
                       (1, 4096, 1, 512),
                       # the style request's fusers: 60 grounding tokens (text and image)
                       (2, 4156, 8, 40), (2, 1084, 8, 80))


def phase_kernels(torch, card: str):
    from vitron_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows = {"int4": [], "flash": []}
    for m in (1, 4, 5, 8, 384):  # decode GEMV at batch 1, 4 and 8, the verify window; GEMM
        for k, n in INT4_SHAPES:
            rows["int4"].append(int4_row(torch, card, g, m, k, n, flush=flush))
        print_sums(f"B1 at M {m}", rows["int4"][-len(INT4_SHAPES):], card)

    b, d = 1, 128
    cases = [c + (False,) for c in CHAT_FLASH_CASES] + [c + (True,) for c in SPEC_FLASH_CASES]
    for name, s_len, t_len, nh, kh, off, n_valid, on_device in cases:
        q = torch.randn((b, s_len, nh, d), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, t_len, kh, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, t_len, kh, d), generator=g, device=dev).to(torch.bfloat16)
        mask = torch.zeros((b, t_len), dtype=torch.bool, device=dev)
        mask[:, :n_valid] = True
        # the kernel's offset: a host int, or a [1] int64 tensor on the card
        k_off = torch.tensor([off], device=dev) if on_device else off
        got = fa.flash_attention(q, k, v, kv_mask=mask, q_offset=k_off).float()
        want = fa.flash_attention_plain(q, k, v, kv_mask=mask, q_offset=off).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        row_rel = flash_row_rel(got, want)
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, kv_mask=mask, q_offset=k_off))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, kv_mask=mask,
                                                                   q_offset=off))
        visible = fa._visible(b, s_len, t_len, dev, mask, off, True)[:, 0, 0]  # [B, S, T]
        lib_ms = sdpa_ms(torch, q, k, v, visible[:, None])
        flops = 4 * d * nh * int(visible.sum())
        r = dict(row(err, rel, ms, plain_ms, nbytes(q, k, v, mask, got.to(torch.bfloat16)),
                     flops, "bf16_tensor", lib_ms), b2=f"chat {name}")
        print(f"flash_attention {name} S={s_len} T={t_len} N={nh} K={kh} D={d} "
              f"q_offset={off}{' (on the device)' if on_device else ''}: "
              f"abs_err={err:.3e} rel_err={rel:.3e} row_rel_err={row_rel:.3e} "
              f"kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s) plain "
              f"{plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check_flash(name, err, row_rel)
        rows["flash"].append(r)
    del flush
    return rows


def phase_diffusion_kernels(torch, card: str):
    """Each diffusion kernel against its plain version at the GLIGEN path's
    shapes, on the same inputs; CUDA-event times of both."""
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = {"flash_gligen": [], "geglu": [], "gn": []}
    bf16 = torch.bfloat16
    for b, s_len, heads, d in GLIGEN_FLASH_SHAPES:
        q, k, v = (torch.randn((b, s_len, heads, d), generator=g, device=dev).to(bf16)
                   for _ in range(3))
        call = dict(causal=False, softmax_shift=0.0)
        got = fa.flash_attention(q, k, v, **call).float()
        want = fa.flash_attention_plain(q, k, v, **call).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        row_rel = flash_row_rel(got, want)
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **call), iters=10)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **call), iters=10)
        flops = 4 * b * heads * s_len * s_len * d
        tflops = flops / (ms * 1e-3) / 1e12
        r = dict(row(err, rel, ms, plain_ms, 4 * nbytes(q), flops, "bf16_tensor",
                     sdpa_ms(torch, q, k, v)), b2=f"gligen [{b},{s_len},{heads},{d}]")
        print(f"flash_attention gligen [{b},{s_len},{heads},{d}] bf16 non-causal shift 0: "
              f"abs_err={err:.3e} rel_err={rel:.3e} row_rel_err={row_rel:.3e} kernel "
              f"{ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {plain_ms:.4f} ms {bound_text(r)} "
              f"[{card}]", flush=True)
        check_flash(f"D={d} S={s_len}", err, row_rel)
        rows["flash_gligen"].append(r)
        del q, k, v, got, want

    for m, c in ((8192, 320), (2048, 640), (512, 1280), (128, 1280)):
        f = 4 * c
        x = torch.randn((m, c), generator=g, device=dev)
        w1 = torch.randn((c, 2 * f), generator=g, device=dev) / c ** 0.5
        b1 = 0.1 * torch.randn((2 * f,), generator=g, device=dev)
        w2 = torch.randn((f, c), generator=g, device=dev) / f ** 0.5
        b2 = 0.1 * torch.randn((c,), generator=g, device=dev)
        for dtype in (torch.float32, bf16):
            args = [a.to(dtype) for a in (x, w1, b1, w2, b2)]
            got = gf.geglu_ff(*args).float()
            want = gf.geglu_ff_plain(*args).float()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = cuda_ms(torch, lambda: gf.geglu_ff(*args))
            plain_ms = cuda_ms(torch, lambda: gf.geglu_ff_plain(*args))
            tflops = 24 * m * c * c / (ms * 1e-3) / 1e12
            name = str(dtype).split(".")[-1]
            # two products and a gelu: no single PyTorch call, no library time
            r = row(err, rel, ms, plain_ms, nbytes(*args) + nbytes(got.to(dtype)),
                    6 * m * c * f, "bf16_tensor" if dtype == bf16 else "fp32")
            print(f"geglu_ff M={m} C={c} F={f} {name}: rel_err={rel:.3e} abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {plain_ms:.4f} ms "
                  f"{bound_text(r)} [{card}]", flush=True)
            check(rel <= GEGLU_TOL[name], f"geglu_ff M={m} C={c} {name} rel err {rel}")
            rows["geglu"].append(r)

    for shape in GN_SHAPES:
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        for dtype in (torch.float32, bf16):
            x = x32.to(dtype)
            got = gn.group_norm_sums(x)
            again = gn.group_norm_sums(x)
            want = gn.group_norm_sums_plain(x)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = graph_ms(torch, lambda: gn.group_norm_sums(x))
            plain_ms = graph_ms(torch, lambda: gn.group_norm_sums_plain(x))
            # the same per-channel statistics in one call: sum = R mean,
            # sum of squares = R (var + mean^2)
            lib_ms = graph_ms(torch, lambda: torch.var_mean(x, dim=1, correction=0))
            gbs = x.numel() * x.element_size() / (ms * 1e-3) / 1e9
            name = str(dtype).split(".")[-1]
            r = row(err, rel, ms, plain_ms, nbytes(x, got), 3 * x.numel(), "fp32", lib_ms)
            print(f"group_norm_sums {list(shape)} {name}: rel_err={rel:.3e} kernel {ms:.4f} ms "
                  f"({gbs:.0f} GB/s) plain {plain_ms:.4f} ms, same bits twice="
                  f"{bool(torch.equal(got, again))} {bound_text(r)} (graph-replayed device "
                  f"times) [{card}]", flush=True)
            check(rel <= GN_TOL, f"group_norm_sums {shape} {name} rel err {rel} > {GN_TOL}")
            check(bool(torch.equal(got, again)), f"group_norm_sums {shape} not deterministic")
            rows["gn"].append(r)
    return rows


# group-norm sums [B, R, C]: two UNet sites, the VAE at full resolution, and
# the SEEM pixel decoder's four levels at 512^2 (res5 to res2, conv_dim 512)
GN_SHAPES = ((2, 4096, 320), (2, 1024, 640), (1, 262144, 128),
             (1, 256, 512), (1, 1024, 512), (1, 4096, 512), (1, 16384, 512))
# FocalNet-L at the served 512x512 input: (x shape, k) of every depthwise
# site (stage i has 2/2/18/2 blocks, each k = 3/5/7/9) and a ragged shape
DW_SHAPES = ([((1, 128 >> i, 128 >> i, 192 << i), k) for i in range(4) for k in (3, 5, 7, 9)]
             + [((2, 37, 53, 200), 5)])
# B4's other sites: ConvNeXt-T's 7x7 stages in GLIGEN's hint PositionNet at
# its 448 input (3/3/9/3 blocks, one launch each), then DaViT-T's 3x3 conv
# position encodings at SEEM's 512x512 (1/1/3/1 blocks, four launches each)
NEW_DW_SITES = (tuple(((1, 112 >> i, 112 >> i, 96 << i), 7) for i in range(4))
                + tuple(((1, 128 >> i, 128 >> i, 96 << i), 3) for i in range(4)))


def dw_row(torch, card: str, x32, w32, dtype) -> dict:
    """B4 against its plain version on x32 / w32 cast to `dtype`: max
    |kernel - plain| over max |plain| and at each pixel's scale
    (`pixel_rel`), the same bits twice (`same`), graph-replayed device times
    of the kernel, the plain version and F.conv2d(groups=C) on the
    channels-last view (the library yardstick), the bound; printed."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import depthwise_conv as dw

    k, c = w32.shape[0], w32.shape[-1]
    x, w = x32.to(dtype), w32.to(dtype)
    got = dw.depthwise_conv2d(x, w)
    same = torch.equal(got, dw.depthwise_conv2d(x, w))
    want = dw.depthwise_conv2d_plain(x, w)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    pixel_rel = flash_row_rel(got, want)
    ms = graph_ms(torch, lambda: dw.depthwise_conv2d(x, w))
    plain_ms = graph_ms(torch, lambda: dw.depthwise_conv2d_plain(x, w), calls=2)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor: channels_last
    wc = w.permute(2, 0, 1)[:, None].contiguous()
    lib_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, padding=k // 2, groups=c))
    name = str(dtype).split(".")[-1]
    r = dict(row(err, rel, ms, plain_ms, nbytes(x, w, got), 2 * k * k * x.numel(), "fp32",
                 lib_ms), pixel_rel=pixel_rel, same=same)
    print(f"depthwise_conv2d {list(x.shape)} k={k} {name}: abs_err={err:.3e} "
          f"rel_err={rel:.3e} pixel_rel_err={pixel_rel:.3e} same bits twice {same} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {bound_text(r)} "
          f"(graph-replayed device times) [{card}]", flush=True)
    return r


def phase_seem_kernels(torch, card: str):
    """The depthwise kernel against its plain version at FocalNet-L's shapes
    (DW_SHAPES), float32 and bf16, each row (`dw_row`) within DW_TOL of the
    largest output and PIXEL_REL of each pixel's, the same bits twice."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {"dw": []}
    for shape, k in DW_SHAPES:
        x32 = torch.randn(shape, generator=g, device=dev)
        w32 = torch.randn((k, k, shape[-1]), generator=g, device=dev) / k
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            r = dw_row(torch, card, x32, w32, dtype)
            check(r["rel"] <= DW_TOL[name] and r["pixel_rel"] <= PIXEL_REL[name] and r["same"],
                  f"depthwise_conv2d {shape} k={k} {name}: rel err {r['rel']}, pixel rel err "
                  f"{r['pixel_rel']}, same bits twice {r['same']}")
            rows["dw"].append(r)
    return rows


def seem_counts(cfg) -> dict:
    """Kernel launches of one SEEM encode_image, from the config: the
    depthwise kernel at every focal level of every FocalNet block, group norm
    at res5's output and at the lateral and output of each lower level."""
    return {"depthwise_conv2d": sum(d * l for d, l in zip(cfg.backbone.depths,
                                                          cfg.backbone.focal_levels)),
            "group_norm_sums": 2 * len(cfg.pixel.in_channels) - 1}


def build_seem_params(torch, cfg, device, seed: int):
    """SEEM params from a seed, every all-zero leaf (biases, logit_scale)
    filled as for GLIGEN and the FocalNet layerscale gammas drawn from
    U(0.5, 1.5): at their 1e-4 init a block's output falls below bf16's
    resolution against the residual, and the depthwise kernel's output would
    not reach the masks."""
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
    from vitron_tpu_torch.models.seem import model as seem_model

    g = torch.Generator(device=device).manual_seed(seed)
    params = fill_zero_leaves(seem_model.init_params(g, cfg, device), g)
    for stage in params["backbone"]["stages"]:
        for blk in stage["blocks"]:
            for key in ("gamma_1", "gamma_2"):
                blk[key] = 0.5 + torch.rand(blk[key].shape, generator=g, device=device)
    return params


def seem_system(torch, cfg, params, pipe=None):
    """A VitronSystem serving SEEM as registered for deployment (bf16
    backbone and pixel decoder), with GLIGEN beside it when given."""
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer
    from vitron_tpu_torch.runtime.system import VitronSystem

    system = VitronSystem(None)
    system.register_seem(params, cfg, StubClipTokenizer(cfg.lang.vocab_size),
                         compute_dtype="bfloat16")
    if pipe is not None:
        system.register_gligen(pipe)
    return system


def stroke_mask(h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), bool)
    m[h * 3 // 10: h * 7 // 10, w * 3 // 10: w * 2 // 3] = True
    return m


def phase_task_b(torch, card: str, system, cfg):
    """Text, stroke and 'segment all' through VitronSystem.route, each twice
    (identical outputs), with the depthwise and group-norm launches of one
    encode_image per request. 'Segment all' is also held on what the model
    computes before the host thresholds it: segment_panoptic's class and
    mask logits, identical twice and non-constant (random weights leave
    every class score under panoptic_inference's 0.8, so no segment is
    kept)."""
    from vitron_tpu_torch.models.seem import model as seem_model

    per = seem_counts(cfg)
    image = np.random.RandomState(3).randint(0, 256, (480, 640, 3), np.uint8)
    sketch = stroke_mask(480, 640)
    total = collections.Counter()
    logits = []
    segment_panoptic = seem_model.segment_panoptic

    def recorded_panoptic(*args, **kw):
        out = segment_panoptic(*args, **kw)
        logits.append(tuple(t.cpu() for t in out))
        return out

    torch.cuda.reset_peak_memory_stats()
    seem_model.segment_panoptic = recorded_panoptic
    try:
        for name, reply, sk in (("text", TASK_B_REPLY, None), ("stroke", TASK_B_REPLY, sketch),
                                ("panoptic", TASK_B_PANOPTIC_REPLY, None)):
            outs = []
            for i in range(2):
                reset_launches()
                out, t_req = timed_route(torch, system, reply, image=image, sketch_mask=sk)
                total.update(expect_launches(per, f"task B {name} run {i + 1}"))
                check(out["status"] == "ok" and out["task"] == "image_segmentation",
                      f"task B {name}: status {out['status']}, {out.get('error')}")
                if name == "panoptic":
                    res = out["panoptic"]
                    cls, masks = logits[-1]
                    what = (f"{len(out['segments'])} segments, class logits {tuple(cls.shape)} "
                            f"std {cls.std():.4f}, mask logits {tuple(masks.shape)} std "
                            f"{masks.std():.4f}")
                    check(res.shape == (480, 640) and cls.std() > 0 and masks.std() > 0,
                          "task B panoptic: constant class or mask logits")
                else:
                    res = out["mask"]
                    what = f"mask {res.shape} covers {res.mean():.3f}"
                    check(res.shape == (480, 640) and bool(res.any()) and not bool(res.all()),
                          f"task B {name}: the mask is constant")
                outs.append((res, out["overlay"]))
                print(f"task B {name} run {i + 1}: request {t_req:.3f} s, {what} [{card}]",
                      flush=True)
            check(all(np.array_equal(a, b) for a, b in zip(*outs)),
                  f"task B {name}: two identical requests gave other outputs")
    finally:
        seem_model.segment_panoptic = segment_panoptic
    check(len(logits) == 2 and all(torch.equal(a, b) for a, b in zip(*logits)),
          "task B panoptic: two identical requests gave other class or mask logits")
    print(f"task B: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    return dict(total)


def seem_breakdown(torch, card: str, system, image):
    """Where a task-B text request's time goes: a torch.profiler trace of the
    routed request with a range around encode_image and one around the SEEM
    decoder. Each range's host time and the device time of the kernels it
    launched; the device time summed by kernel gives the device's busy
    share of the unprofiled request."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vitron_tpu_torch.models.seem import decoder as dec
    from vitron_tpu_torch.models.seem import model as seem_model

    spans = {"seem.encode_image": (seem_model, "encode_image"), "seem.decoder": (dec, "forward")}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in spans.items()}

    def ranged(name):
        def call(*args, **kw):
            with record_function(name):
                return saved[name](*args, **kw)
        return call

    _, t_req = timed_route(torch, system, TASK_B_REPLY, image=image)
    for name, (mod, attr) in spans.items():
        setattr(mod, attr, ranged(name))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, t_prof = timed_route(torch, system, TASK_B_REPLY, image=image)
    finally:
        for name, (mod, attr) in spans.items():
            setattr(mod, attr, saved[name])
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    # the ranges also appear on the device timeline: not kernels
    kernels = [e for e in events if e.device_type == cuda and e.key not in spans]
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    busy = sum(dev_ms.values())
    dw_ms = sum(v for k, v in dev_ms.items() if "dw_rows_kernel" in k)
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    ranges = []
    for name in spans:
        e = next((e for e in events if e.key == name and e.device_type != cuda), None)
        check(e is not None, f"task B breakdown: no '{name}' range in the trace")
        ranges.append(f"{name} host {e.cpu_time_total / 1e3:.2f} ms, its kernels "
                      f"{e.device_time_total / 1e3:.2f} ms")
    print(f"task B breakdown: text request {t_req * 1e3:.1f} ms unprofiled, "
          f"{t_prof * 1e3:.1f} ms profiled; {'; '.join(ranges)} (profiled, bf16 towers, "
          f"512^2); device busy {busy:.2f} ms = {busy / (t_req * 1e3):.3f} of the unprofiled "
          f"request (idle share {1 - busy / (t_req * 1e3):.3f}); depthwise kernel "
          f"{dw_ms:.3f} ms in {sum(e.count for e in kernels if 'dw_rows_kernel' in e.key)} "
          f"launches [{card}]", flush=True)
    print("task B device time by kernel (ms): " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top),
          flush=True)


def phase_task_e(torch, card: str, system, cfg, frames: int = 8):
    """Video tracking of a stroke over `frames` 480x640 frames (1.6 s at the
    reference's 5 fps), twice: one encode_image per frame plus the reference
    frame's."""
    per = seem_counts(cfg)
    want = {k: (frames + 1) * v for k, v in per.items()}
    video = np.random.RandomState(4).randint(0, 256, (frames, 480, 640, 3), np.uint8)
    runs = []
    for i in range(2):
        reset_launches()
        out, t_req = timed_route(torch, system, TASK_E_REPLY, video=video,
                                 sketch_mask=stroke_mask(480, 640))
        launches = expect_launches(want, f"task E run {i + 1}")
        check(out["status"] == "ok" and out["task"] == "video_tracking",
              f"task E: status {out['status']}, {out.get('error')}")
        masks = out["masks"]
        side = cfg.input_size // 4
        check(masks.shape == (frames, side, side) and out["overlay_frames"].shape ==
              (frames, 480, 640, 3), f"task E shapes {masks.shape}")
        check(bool(masks.any()) and not bool(masks.all()), "task E: the masks are constant")
        runs.append(masks)
        print(f"task E run {i + 1}: {frames} frames 480x640, request {t_req:.3f} s "
              f"({t_req / frames * 1e3:.1f} ms per frame), masks cover {masks.mean():.3f} "
              f"[{card}]", flush=True)
    check(np.array_equal(runs[0], runs[1]), "task E: two identical requests gave other masks")
    return launches


def phase_task_c_seem(torch, card: str, pipe, seem_params, cfg):
    """C with two ';'-separated phrases and neither a region nor a sketch:
    SEEM segments each phrase (two encode_image), then the 9-channel GLIGEN
    inpaint at TASK_C_STEPS steps."""
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenPipeline
    gcfg = dataclasses.replace(pipe.cfg, steps=TASK_C_STEPS)
    short = GligenPipeline(gcfg, pipe.unet_params, pipe.vae_params, pipe.text_params,
                           inpaint_unet_params=pipe.inpaint_unet_params, tokenizer=pipe.tokenizer)
    system = seem_system(torch, cfg, seem_params, short)
    ucfg9 = dataclasses.replace(gcfg.unet, in_channels=9)
    unet = unet_counts(ucfg9, gcfg.latent_size, gcfg.max_objs, gcfg.text.max_length)
    enc, dec = vae_counts(gcfg.vae, gcfg.latent_size ** 2)
    want = {k: (gcfg.steps + 1) * unet[k] + enc[k] + dec[k] for k in unet}
    want["depthwise_conv2d"] = 0
    for k, v in seem_counts(cfg).items():
        want[k] += 2 * v
    image = np.random.RandomState(5).randint(0, 256, (480, 640, 3), np.uint8)
    reset_launches()
    out, t_req = timed_route(torch, system, TASK_C_SEEM_REPLY, image=image)
    launches = expect_launches(want, "task C (SEEM branch)")
    img = out["image"]
    check(out["status"] == "ok" and out["task"] == "image_editing",
          f"task C (SEEM): status {out['status']}, {out.get('error')}")
    check(img.shape == (gcfg.image_size, gcfg.image_size, 3) and int(img.max()) != int(img.min()),
          f"task C (SEEM) image {img.shape}")
    print(f"task C (SEEM branch: 2 phrases segmented, {gcfg.steps} PLMS steps): request "
          f"{t_req:.3f} s, image mean {img.mean():.2f} std {img.std():.2f} [{card}]", flush=True)
    return launches


def phase_seem_cpu_vs_card(torch, card: str):
    """One full-width float32 segment_text at reduced depth (FocalNet depths
    1/1/1/1 with all four focal levels, 2 encoder, 2 decoder and 2 language
    layers, a 256x256 image) on the CPU and on the card: the mask logits, the
    matched query and the flipped cross-attention-mask bits."""
    from vitron_tpu_torch.models.seem import decoder as dec
    from vitron_tpu_torch.models.seem import focalnet, language, pixel_decoder
    from vitron_tpu_torch.models.seem import model as seem_model

    cfg = seem_model.SeemConfig(
        backbone=focalnet.FocalNetConfig.focall(depths=(1, 1, 1, 1)),
        pixel=pixel_decoder.PixelDecoderConfig(num_enc_layers=2),
        decoder=dec.SeemDecoderConfig(dec_layers=2), lang=language.LangConfig(num_layers=2),
        input_size=256)
    cpu = torch.device("cpu")
    params = build_seem_params(torch, cfg, cpu, seed=8)
    image = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (256, 256, 3), np.uint8))
    ids = np.zeros((1, cfg.lang.context_length), np.int64)
    ids[0, :5] = [49406, 320, 736, 1615, 49407]
    ids = torch.from_numpy(ids)
    decoded = []
    forward = dec.forward

    def recorded_forward(*args, **kw):  # keeps the decoder output to find the match
        decoded.append(forward(*args, **kw))
        return decoded[-1]

    res = {}
    dec.forward = recorded_forward
    try:
        for name, device in (("cpu", cpu), ("cuda", torch.device("cuda"))):
            p = params if device == cpu else tree_map(lambda a: a.to(device), params)
            t0 = time.perf_counter()
            with dec.recording_attn_masks() as masks:
                mask, _ = seem_model.segment_text(p, cfg, image.to(device), ids.to(device),
                                                  (ids != 0).to(device))
            pred = decoded[-1]["pred_masks"][0]
            matched = [q for q in range(pred.shape[0]) if torch.equal(pred[q], mask)]
            res[name] = (mask.float().cpu(), [m.cpu() for m in masks], matched)
            print(f"seem cpu-vs-card: {name} segment_text {time.perf_counter() - t0:.1f} s, "
                  f"matched query {matched}", flush=True)
    finally:
        dec.forward = forward
    (m_cpu, a_cpu, q_cpu), (m_gpu, a_gpu, q_gpu) = res["cpu"], res["cuda"]
    rel = (m_gpu - m_cpu).abs().max().item() / m_cpu.abs().max().item()
    flips = sum(int((a != b).sum()) for a, b in zip(a_cpu, a_gpu))
    print(f"seem cpu-vs-card: full-width float32 segment_text (depth 1/1/1/1, 256x256): mask "
          f"logits rel_err={rel:.3e} (limit {CPU_GPU_TOL}), matched query {q_cpu} / {q_gpu}, "
          f"attention-mask bits flipped {flips} of {sum(a.numel() for a in a_cpu)} [{card}]",
          flush=True)
    check(len(q_cpu) == 1 and q_cpu == q_gpu, f"SEEM CPU and card match other queries: "
          f"{q_cpu} / {q_gpu}")
    check(rel <= CPU_GPU_TOL, f"SEEM CPU and card disagree: rel {rel}")


def unet_counts(ucfg, latent: int, n_objs: int, n_ctx: int) -> dict:
    """Kernel launches of one UNet call, from the block plan: flash at every
    attention site (self, fuser with n_objs grounding tokens, cross with
    n_ctx context tokens) whose query and key lengths reach
    VITRON_FLASH_MIN, GEGLU in every block and fuser, group norm twice per
    ResNet, once per spatial transformer and once at the output."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min
    from vitron_tpu_torch.models.diffusion.unet2d import block_plan

    fmin = _flash_min()
    counts = {"flash_attention": 0, "geglu_ff": 0, "group_norm_sums": 1}
    size = latent
    input_plan, middle_plan, output_plan = block_plan(ucfg)
    for entries in input_plan + [middle_plan] + output_plan:
        for e in entries:
            size = size // 2 if e[0] == "down" else size * 2 if e[0] == "up" else size
            if e[0] == "res":
                counts["group_norm_sums"] += 2
            elif e[0] == "attn":
                counts["group_norm_sums"] += 1
                n = size * size
                per_block = (int(n >= fmin) + int(n_objs > 0 and n + n_objs >= fmin)
                             + int(n >= fmin and n_ctx >= fmin))
                counts["flash_attention"] += ucfg.transformer_depth * per_block
                counts["geglu_ff"] += ucfg.transformer_depth * (1 + int(n_objs > 0))
    return counts


def vae_counts(vcfg, pixels: int):
    """(encode, decode) kernel launches: group norm twice per ResNet, once in
    the mid attention, once at the output; flash in the mid attention, which
    runs at the latent's `pixels`."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    levels = len(vcfg.channel_mult)
    flash = int(pixels >= _flash_min())
    enc = {"flash_attention": flash, "geglu_ff": 0,
           "group_norm_sums": 2 * (levels * vcfg.num_res_blocks + 2) + 2}
    dec = {"flash_attention": flash, "geglu_ff": 0,
           "group_norm_sums": 2 * (levels * (vcfg.num_res_blocks + 1) + 2) + 2}
    return enc, dec


def video_plan(ucfg, lh: int, lw: int):
    """(entry, latent pixels at that entry) for every entry of the video
    UNet's block plan at an lh x lw latent."""
    from vitron_tpu_torch.models.diffusion.unet_sd_video import block_plan_hw

    for e, h, w in block_plan_hw(ucfg, lh, lw):
        yield e, h * w


def video_sites(ucfg, lh: int, lw: int):
    """(pixels N, width C, heads) of each temporal-transformer level, widest
    first: where B6 (the res blocks' Co), B7 and B3 run."""
    return sorted({(n, e[1], e[2]) for e, n in video_plan(ucfg, lh, lw) if e[0] == "tattn"},
                  reverse=True)


def video_counts(ucfg, lh: int, lw: int, n_ctx: int) -> dict:
    """Kernel launches of one video UNet call, from the block plan: four
    temporal convs and six group norms per res block (two of its own, four
    in its temporal conv block), two frame attentions per temporal
    transformer, GEGLU and one group norm in every transformer, flash at a
    spatial site whose query and key lengths reach VITRON_FLASH_MIN, and the
    output group norm."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    fmin = _flash_min()
    counts = {"temporal_conv_k3": 0, "frame_attention": 0, "geglu_ff": 0,
              "group_norm_sums": 1, "flash_attention": 0}
    for e, n in video_plan(ucfg, lh, lw):
        if e[0] == "res":
            counts["temporal_conv_k3"] += 4
            counts["group_norm_sums"] += 6
        elif e[0] in ("sattn", "tattn"):
            counts["group_norm_sums"] += 1
            counts["geglu_ff"] += 1
            if e[0] == "tattn":
                counts["frame_attention"] += 2
            else:
                counts["flash_attention"] += int(n >= fmin) + int(n >= fmin and n_ctx >= fmin)
    return counts


def video_gn_shapes(ucfg, lh: int, lw: int, batch: int, frames: int) -> collections.Counter:
    """[B, R, C] of every group-norm-sums launch of one video UNet call, with
    its count, from the block plan: a res block's norm1 [B F, N, cin] and
    norm2 [B F, N, cout] and its temporal conv block's four [B, F N, cout],
    a spatial transformer's [B F, N, C], a temporal one's [B, F N, C], and
    the output norm [B F, lh lw, dim]."""
    bf = batch * frames
    shapes = collections.Counter({(bf, lh * lw, ucfg.dim): 1})
    for e, n in video_plan(ucfg, lh, lw):
        if e[0] == "res":
            shapes[(bf, n, e[1])] += 1
            shapes[(bf, n, e[2])] += 1
            shapes[(batch, frames * n, e[2])] += 4
        elif e[0] == "sattn":
            shapes[(bf, n, e[1])] += 1
        elif e[0] == "tattn":
            shapes[(batch, frames * n, e[1])] += 1
    return shapes


def vae_decode_gn_shapes(vcfg, lh: int, lw: int, batch: int) -> collections.Counter:
    """[B, R, C] of every group-norm-sums launch of one VAE decode of
    [batch, lh, lw, z] latents, with its count: the mid ResNets' four and the
    mid attention's one at the top width, each level's ResNets (norm1 at
    their input width, norm2 at their output width, 4x the rows after each
    upsampling), and the output norm."""
    bc = vcfg.base_channels
    ch, rows = vcfg.channel_mult[-1] * bc, lh * lw
    shapes = collections.Counter({(batch, rows, ch): 5})
    for li, mult in reversed(list(enumerate(vcfg.channel_mult))):
        for _ in range(vcfg.num_res_blocks + 1):
            shapes[(batch, rows, ch)] += 1
            ch = mult * bc
            shapes[(batch, rows, ch)] += 1
        if li != 0:
            rows *= 4
    shapes[(batch, rows, bc)] += 1
    return shapes


def vae_encode_gn_shapes(vcfg, h: int, w: int, batch: int) -> collections.Counter:
    """[B, R, C] of every group-norm-sums launch of one VAE encode of
    [batch, h, w, 3] images, with its count: each level's ResNets (norm1 at
    their input width, norm2 at their output width, a quarter of the rows
    after each downsampling), the mid ResNets' four and the mid attention's
    one at the top width, and the output norm."""
    bc = vcfg.base_channels
    ch, rows = bc, h * w
    shapes = collections.Counter()
    for li, mult in enumerate(vcfg.channel_mult):
        for _ in range(vcfg.num_res_blocks):
            shapes[(batch, rows, ch)] += 1
            ch = mult * bc
            shapes[(batch, rows, ch)] += 1
        if li != len(vcfg.channel_mult) - 1:
            rows //= 4
    shapes[(batch, rows, ch)] += 6
    return shapes


def video_unet_flops(ucfg, lh: int, lw: int, frames: int, batch: int, n_ctx: int) -> int:
    """Multiply-add FLOP (2 per MAC) of one video UNet call, from the block
    plan: every conv, projection, feed-forward, temporal conv and attention
    product (norms and elementwise work left out)."""
    bf = batch * frames
    flops = 2 * 9 * ucfg.dim * ucfg.out_dim * bf * lh * lw  # the out conv
    for e, n in video_plan(ucfg, lh, lw):
        m = bf * n
        if e[0] == "conv_in":
            flops += 2 * 9 * e[1] * e[2] * m
        elif e[0] == "res":
            cin, cout = e[1], e[2]
            flops += 2 * 9 * (cin + cout) * cout * m + 2 * batch * ucfg.embed_dim * cout
            flops += 2 * cin * cout * m if cin != cout else 0
            flops += 4 * 2 * 3 * cout * cout * m  # the temporal conv block
        elif e[0] in ("sattn", "tattn"):
            ch, inner = e[1], (e[3] if e[0] == "tattn" else e[1])
            flops += 2 * 2 * m * ch * inner + 24 * m * inner * inner  # proj in/out, GEGLU
            if e[0] == "tattn":  # two frame self-attentions
                flops += 2 * (4 * 2 * m * inner * inner + 2 * 2 * batch * n * frames ** 2 * inner)
            else:  # self-attention over n tokens, cross-attention to n_ctx
                flops += 4 * 2 * m * inner * inner + 2 * 2 * bf * n * n * inner
                flops += 2 * 2 * m * inner * inner + 2 * 2 * bf * n_ctx * ucfg.context_dim * inner
                flops += 2 * 2 * bf * n * n_ctx * inner
        elif e[0] == "down":
            flops += 2 * 9 * e[1] * e[1] * m
        elif e[0] == "up":
            flops += 2 * 9 * e[1] * e[1] * 4 * m
    return flops


def build_gligen(torch, cfg, device, seed: int):
    """GLIGEN pipeline (float32, random weights with every zero leaf filled)
    plus the 9-channel inpainting UNet."""
    from vitron_tpu_torch.models.diffusion import clip_text, unet2d, vae
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenPipeline
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves

    g = torch.Generator(device=device).manual_seed(seed)
    unet = fill_zero_leaves(unet2d.init_params(g, cfg.unet, device), g)
    unet9 = fill_zero_leaves(unet2d.init_params(
        g, dataclasses.replace(cfg.unet, in_channels=9), device), g)
    vae_p = fill_zero_leaves(vae.init_params(g, cfg.vae, device), g)
    text = fill_zero_leaves(clip_text.init_params(g, cfg.text, device), g)
    return GligenPipeline(cfg, unet, vae_p, text, inpaint_unet_params=unet9,
                          tokenizer=StubClipTokenizer(cfg.text.vocab_size))


def timed_route(torch, system, reply, **media):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.route(reply, **media)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _counters():
    """(name in the kernels line, module, counter attribute) of every kernel
    wrapper, from the port's one list (`kernels.LAUNCH_COUNTERS`)."""
    import importlib

    from vitron_tpu_torch.kernels import LAUNCH_COUNTERS

    return [(name, importlib.import_module(f"vitron_tpu_torch.kernels.{mod}"), attr)
            for name, mod, attr in LAUNCH_COUNTERS]


def reset_launches() -> None:
    """Every kernel's launch count to 0: just before a run that is read."""
    from vitron_tpu_torch.runtime import graphs

    for _, mod, attr in _counters():
        setattr(mod, attr, 0)
    graphs.replayed.clear()


def read_launches() -> dict:
    """Every kernel's launch count since `reset_launches`: the wrappers'
    counts plus the launches that CUDA-graph replays of decode chunks made
    (`runtime/graphs.replayed`, each replay counted as the launches its
    graph recorded at capture; a capture itself counts none)."""
    from vitron_tpu_torch.runtime import graphs

    return {name: getattr(mod, attr) + graphs.replayed[(mod.__name__.rsplit(".", 1)[1], attr)]
            for name, mod, attr in _counters()}


def expect_launches(want: dict, what: str) -> dict:
    """Every kernel's launch count since `reset_launches`; those named in
    `want` must equal it, and B9, which no path calls, must be 0, as must
    Q1 and Q2 where `want` does not name them (they run only under the
    W4A8 / W8A8 knobs)."""
    want = {"conv3x3_same": 0, "w4a8_matmul": 0, "conv2d_w8a8": 0, **want}
    got = read_launches()
    print(f"{what}: launches {got} (expected {want})", flush=True)
    check(all(got[k] == v for k, v in want.items()), f"{what}: kernel launches {got} != {want}")
    return got


def phase_task_a(torch, card: str, pipe):
    from vitron_tpu_torch.models.diffusion import vae
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = pipe.cfg
    system = VitronSystem(None)
    system.register_gligen(pipe)
    unet = unet_counts(cfg.unet, cfg.latent_size, cfg.max_objs, cfg.text.max_length)
    _, dec = vae_counts(cfg.vae, cfg.latent_size ** 2)
    calls = cfg.steps + 1  # PLMS: Heun's second call on the first step
    want = {k: calls * unet[k] + dec[k] for k in unet}
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        reset_launches()
        out, t_req = timed_route(torch, system, TASK_A_REPLY)
        launches = expect_launches(want, f"task A run {i + 1}")
        check(out["status"] == "ok" and out["task"] == "image_generation",
              f"task A: status {out['status']}, task {out.get('task')}")
        img = out["image"]
        check(img.shape == (cfg.image_size, cfg.image_size, 3) and img.dtype == np.uint8,
              f"task A image {img.shape} {img.dtype}")
        runs.append((img, t_req))
        print(f"task A run {i + 1}: request {t_req:.3f} s, image {img.shape} mean "
              f"{img.mean():.2f} std {img.std():.2f} [{card}]", flush=True)
    check(np.array_equal(runs[0][0], runs[1][0]), "task A: two identical requests gave "
          "other images")
    check(int(runs[0][0].max()) != int(runs[0][0].min()), "task A: the image is constant")
    peak = torch.cuda.max_memory_allocated()

    # one CFG UNet call and one VAE decode at the request's shapes, timed alone
    inputs = pipe.prepare("a red car on a street", [[0.1, 0.2, 0.6, 0.8]],
                          ["a red car on a street"])
    from vitron_tpu_torch.models.diffusion import clip_text

    ctx = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_ctx"])
    uc = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_uc"])
    text_emb = torch.zeros((1, cfg.max_objs, cfg.unet.context_dim), device=pipe.device)
    eps = pipe._eps_fn(inputs["params"], ctx, uc, inputs["gb"], inputs["gm"], text_emb, 7.5)
    x = torch.randn((1, cfg.latent_size, cfg.latent_size, 4), device=pipe.device)
    unet_ms = cuda_ms(torch, lambda: eps(x, 501, 1.0), iters=10, warmup=2)
    vae_ms = cuda_ms(torch, lambda: vae.decode(pipe.vae_params, cfg.vae, x), iters=5, warmup=1)
    t_req = runs[1][1]
    print(f"task A: request {t_req:.3f} s ({calls} CFG UNet calls at {unet_ms:.2f} ms = "
          f"{calls * unet_ms / 1e3:.3f} s, VAE decode {vae_ms:.2f} ms, the rest "
          f"{t_req - calls * unet_ms / 1e3 - vae_ms / 1e3:.3f} s), peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    return launches


def phase_task_c(torch, card: str, pipe):
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenPipeline
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = dataclasses.replace(pipe.cfg, steps=TASK_C_STEPS)
    short = GligenPipeline(cfg, pipe.unet_params, pipe.vae_params, pipe.text_params,
                           inpaint_unet_params=pipe.inpaint_unet_params,
                           tokenizer=pipe.tokenizer)
    system = VitronSystem(None)
    system.register_gligen(short)
    ucfg9 = dataclasses.replace(cfg.unet, in_channels=9)
    unet = unet_counts(ucfg9, cfg.latent_size, cfg.max_objs, cfg.text.max_length)
    enc, dec = vae_counts(cfg.vae, cfg.latent_size ** 2)
    want = {k: (cfg.steps + 1) * unet[k] + enc[k] + dec[k] for k in unet}
    image = np.random.RandomState(1).randint(0, 256, (480, 640, 3), np.uint8)
    reset_launches()
    out, t_req = timed_route(torch, system, TASK_C_REPLY, image=image)
    launches = expect_launches(want, "task C")
    img = out["image"]
    check(out["status"] == "ok" and out["task"] == "image_editing",
          f"task C: status {out['status']}, task {out.get('task')}")
    check(img.shape == (cfg.image_size, cfg.image_size, 3) and img.dtype == np.uint8
          and int(img.max()) != int(img.min()), f"task C image {img.shape} {img.dtype}")
    print(f"task C ({cfg.steps} PLMS steps, 9-channel UNet, region branch, 480x640 source): "
          f"request {t_req:.3f} s, image mean {img.mean():.2f} std {img.std():.2f} [{card}]",
          flush=True)
    return launches


def phase_sd_unet_bf16(torch, card: str, cfg, dev):
    """bench.py's bench_sd_unet step: x <- x - 0.01 * eps over a CFG batch."""
    from vitron_tpu_torch.models.diffusion import unet2d
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    g = torch.Generator(device=dev).manual_seed(4)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      fill_zero_leaves(unet2d.init_params(g, cfg, dev, grounding=False), g))
    x0 = torch.randn((2, 64, 64, cfg.in_channels), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g, device=dev).to(torch.bfloat16)

    def steps(n):
        x = x0
        for i in range(n):
            eps = unet2d.forward(params, cfg, x, torch.full((2,), float(i), device=dev), ctx)
            x = x - 0.01 * eps.to(x.dtype)
        return x

    out = steps(3)
    check(bool(torch.isfinite(out.float()).all()), "bf16 UNet step gave non-finite values")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(20)
    torch.cuda.synchronize()
    rate = 20 / (time.perf_counter() - t0)
    print(f"sd_unet_cfg_steps_per_s={rate:.3f} (bf16 SD v1.4 UNet, CFG batch 2, 64x64 latents, "
          f"20 steps after 3) [{card}]", flush=True)
    del params
    torch.cuda.empty_cache()
    return rate


def phase_unet_cpu_vs_card(torch, card: str, cfg, dev):
    """One grounded CFG-batch UNet call on the CPU and on `dev`; at full width
    (320 channels, 8 heads, 768-wide context, 30 grounding tokens) but one
    level and 32x32 latents."""
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.models.diffusion import unet2d
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(6)
    params = fill_zero_leaves(unet2d.init_params(g, cfg, cpu), g)
    x = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.full((2,), 501)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)
    objs = torch.randn((2, 30, cfg.context_dim), generator=g)
    t0 = time.perf_counter()
    want = unet2d.forward(params, cfg, x, t, ctx, objs, gate_scale=0.7)
    print(f"unet cpu-vs-card: cpu forward {time.perf_counter() - t0:.1f} s", flush=True)
    p_dev, args = tree_map(lambda a: a.to(dev), params), [a.to(dev) for a in (x, t, ctx, objs)]
    want_flash = {"flash": unet_counts(cfg, 32, 30, 77)["flash_attention"], "einsum": 0}
    for name, env in (("flash", {}), ("einsum", {"VITRON_FLASH_MIN": str(1 << 30)})):
        with mock.patch.dict(os.environ, env):
            fa.launches = 0
            got = unet2d.forward(p_dev, cfg, *args, gate_scale=0.7).cpu()
            n_flash = fa.launches
        rel = (got - want).abs().max().item() / want.abs().max().item()
        print(f"unet cpu-vs-card ({name} attention on the card, {n_flash} flash launches): "
              f"rel_err={rel:.3e} (limit {UNET_CPU_GPU_TOL[name]}), max |eps| "
              f"{want.abs().max().item():.3f} [{card}]", flush=True)
        check(n_flash == want_flash[name], f"{n_flash} flash launches, expected "
              f"{want_flash[name]}")
        check(rel <= UNET_CPU_GPU_TOL[name], f"diffusion CPU and card disagree ({name}): {rel}")


VIDEO_LATENT = (40, 72)  # 320x576 frames over the SD VAE's factor 8
VIDEO_FRAMES = 24
# max |kernel - plain| / max |plain|: float32 sums in another order; in bf16
# one rounding of the output on each side
VIDEO_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
B7_LONG_FRAMES = (40, 64)  # frame counts past B7's 32-frame kernel (ROADMAP C14)
TASK_D_REPLY = ("<module>D</module><instruction>a red car driving along a coastal road at "
                "sunset</instruction>")
# DDIM-v steps of the smoke's task-D request (the reference runs 50): at ~2.4 s
# per float32 CFG UNet call, two requests of 5 steps take ~25 s (10 until
# phases 28-30 needed the time); a divisor of 1000, so the sampler runs
# exactly this many steps
TASK_D_STEPS = 5
VIDEO_BF16_STEPS = 5
I2V_LATENT = 64   # 512^2 frames over the SD VAE's factor 8
I2V_FRAMES = 16
TASK_G_REPLY = ("<module>G</module><instruction>the waves roll in and the boat drifts slowly"
                "</instruction>")
# DDIM-v steps of the smoke's task-G request (the reference runs 50), a
# divisor of 1000 (ROADMAP C6); 5 since phases 28-30 (10 before)
TASK_G_STEPS = 5


def i2v_context(ucfg, text_len: int) -> int:
    """Context tokens of the i2vgen UNet `ucfg` after `text_len` text tokens:
    those, the 64 local-image tokens (a 32x32 pool, two stride-2 convs) and
    the global ones."""
    return text_len + 64 + ucfg.num_tokens


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / want.float().abs().max().item()


def phase_video_kernels(torch, card: str):
    """The task-D path's kernels against their plain versions at every shape
    the path gives them, float32 and bf16, on the same inputs: the temporal
    conv (B6) and frame attention (B7) at the four (N, C, heads) levels of
    the t2v block plan (CFG batch 2 x 24 frames), GEGLU (B3) at those
    levels' rows, group-norm sums (B8) at every [B, R, C] of one UNet call
    and of the VAE decode of the 24 frames (each also run twice for the
    same bits), flash (B2) at the VAE decode's mid attention
    [24, 2880, 1, 512] (bf16, as `layers._mha` calls it)."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

    t2v = Text2VideoConfig()
    check(t2v.latent_hw == VIDEO_LATENT and t2v.num_frames == VIDEO_FRAMES,
          f"Text2VideoConfig() latents {t2v.latent_hw} x {t2v.num_frames} frames")
    rows = video_kernel_rows(torch, card, t2v.unet, t2v.vae, *VIDEO_LATENT, VIDEO_FRAMES,
                             t2v.text.max_length, seed=9)
    # C14: B7 past 32 frames (the online-softmax kernel) at the first level's shape
    n, c, heads = video_sites(t2v.unet, *VIDEO_LATENT)[0]
    g = torch.Generator(device=torch.device("cuda")).manual_seed(14)
    for f in B7_LONG_FRAMES:
        qkv32 = [torch.randn((2, f, n, c), generator=g, device=torch.device("cuda"))
                 for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            rows["tattn"].append(frame_attention_row(torch, card, qkv32, heads, dtype))
        del qkv32
    return rows


def video_flash_sites(ucfg, lh: int, lw: int, frames: int, n_ctx: int, encode: bool,
                      batch: int = 2, vae: bool = True):
    """(what, B, S, T, heads, D) of B2 on a video path: the VAE's
    single-head mid attention at D 512 (with `vae`, the decode of the frames
    and, with `encode`, the encode of one image) and the UNet's spatial
    sites (`batch` x `frames`: 2 for a CFG call) that reach VITRON_FLASH_MIN
    (self-attention; cross-attention when the `n_ctx` context tokens do
    too), non-causal, shift 0, bf16 as `layers._mha` calls it."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    fmin = _flash_min()
    sites = [("vae decode", frames, lh * lw, lh * lw, 1, 512)] if vae else []
    if encode:
        sites.append(("vae encode", 1, lh * lw, lh * lw, 1, 512))
    for e, n in sorted({(e, n) for e, n in video_plan(ucfg, lh, lw) if e[0] == "sattn"},
                       key=lambda en: -en[1]):
        if n >= fmin:
            sites.append((f"unet self-attention C={e[1]}", batch * frames, n, n, e[2],
                          ucfg.head_dim))
        if n >= fmin and n_ctx >= fmin:
            sites.append((f"unet cross-attention C={e[1]}", batch * frames, n, n_ctx, e[2],
                          ucfg.head_dim))
    return sites


def b7_shapes() -> list:
    """(B, F, N, C, heads) of B7's rows: the t2v plan's four temporal levels
    at 2 x VIDEO_FRAMES frames of VIDEO_LATENT (task D, phase 5b), then the
    i2vgen plan's at 2 x I2V_FRAMES frames of I2V_LATENT^2 (task G, 5d)."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import (Image2VideoConfig,
                                                                   Text2VideoConfig)

    t2v, i2v = Text2VideoConfig(), Image2VideoConfig()
    return ([(2, VIDEO_FRAMES, n, c, h) for n, c, h in video_sites(t2v.unet, *VIDEO_LATENT)]
            + [(2, I2V_FRAMES, n, c, h)
               for n, c, h in video_sites(i2v.unet, I2V_LATENT, I2V_LATENT)])


def frame_attention_row(torch, card: str, qkv32, heads: int, dtype) -> dict:
    """B7 against its plain version on q, k, v (float32 [B, F, N, C] tensors,
    cast to `dtype`), `heads` heads of C / heads: max |kernel - plain| /
    max |plain| (VIDEO_TOL), the same bits twice, device times from
    CUDA-graph replay of the kernel, the plain version and
    F.scaled_dot_product_attention on the [B N, H, F, D] copies (the layout
    copies made outside the timed region), and the bound."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import temporal_attention as ta

    b, f, n, c = qkv32[0].shape
    d = c // heads
    name = str(dtype).split(".")[-1]
    q, k, v = (t.to(dtype) for t in qkv32)
    got, again = (ta.frame_attention(q, k, v, heads, d ** -0.5) for _ in range(2))
    want = ta.frame_attention_plain(q, k, v, heads, d ** -0.5)
    err, rel = rel_err(got, want)
    same = bool(torch.equal(got, again))
    del again, want
    qt, kt, vt = (t.reshape(b, f, n, heads, d).permute(0, 2, 3, 1, 4)
                  .reshape(b * n, heads, f, d).contiguous() for t in (q, k, v))
    ms = graph_ms(torch, lambda: ta.frame_attention(q, k, v, heads, d ** -0.5))
    plain_ms = graph_ms(torch, lambda: ta.frame_attention_plain(q, k, v, heads, d ** -0.5),
                        calls=2)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    r = row(err, rel, ms, plain_ms, nbytes(q, k, v, got), 4 * b * n * heads * f * f * d,
            "fp32" if dtype == torch.float32 else "bf16_tensor", lib_ms)
    print(f"frame_attention [{b},{f},{n},{c}] heads={heads} D={d} {name}: rel_err={rel:.3e} "
          f"same bits twice={same}; kernel {ms:.4f} ms "
          f"({nbytes(q, k, v, got) / (ms * 1e-3) / 1e9:.0f} GB/s) plain {plain_ms:.4f} ms "
          f"{bound_text(r)} (scaled_dot_product_attention on [B N, H, F, D]; graph-replayed "
          f"device times) [{card}]", flush=True)
    check(rel <= VIDEO_TOL[name] and same,
          f"frame_attention [{b},{f},{n},{c}] {name}: rel err {rel}, same bits twice {same}")
    return r


def video_kernel_rows(torch, card: str, ucfg, vcfg, lh: int, lw: int, frames: int, n_ctx: int,
                      seed: int, encode_hw=None, batch: int = 2, dtypes=("float32", "bfloat16")):
    """A video path's kernels against their plain versions, in `dtypes`, at
    the shapes one UNet call (`batch` x `frames` of lh x lw latents: 2 for a
    CFG call; `n_ctx` context tokens) and its VAE (none when vcfg is None, as
    in training) give them, from the block plan and the VAE config:
    B6, B7 and B3 at each temporal-transformer level, B8 at every [B, R, C]
    of the UNet call, the decode of the frames and (with `encode_hw`) the
    encode of one image, B2 at the VAE decode's (and encode's) mid attention
    and at every spatial UNet attention site that reaches VITRON_FLASH_MIN,
    in bf16 as `layers._mha` calls it. Each row: error, device time of the kernel
    and of the library call (CUDA-graph replay) where one PyTorch call
    computes the same function (layout copies made outside the timed
    region), the plain version's (CUDA events where its float32 temporaries
    would fill a graph's pool), and the bound."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn
    from vitron_tpu_torch.kernels import temporal_conv as tc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {"tconv": [], "tattn": [], "geglu_video": [], "gn_video": [], "flash_vae": []}
    b, f = batch, frames
    f32, bf16 = torch.float32, torch.bfloat16
    types = [getattr(torch, t) for t in dtypes]

    def peak(dtype):
        return "fp32" if dtype == f32 else "bf16_tensor"

    for n, c, heads in video_sites(ucfg, lh, lw):
        m = b * f * n
        x32 = torch.randn((b, f, n, c), generator=g, device=dev)
        w32 = torch.randn((3, c, c), generator=g, device=dev) / (3 * c) ** 0.5
        b32 = 0.1 * torch.randn((c,), generator=g, device=dev)
        for dtype in types:
            name = str(dtype).split(".")[-1]
            x, w, bias = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            got = tc.temporal_conv_k3(x, w, bias)
            want = tc.temporal_conv_k3_plain(x, w, bias)
            err, rel = rel_err(got, want)
            # cuDNN: a (3, 1) filter over the [B, C, F, N] view, padded on F
            xc = x.permute(0, 3, 1, 2).contiguous()
            wc = w.permute(2, 1, 0)[..., None].contiguous()
            lib = F.conv2d(xc, wc, bias, padding=(1, 0)).permute(0, 2, 3, 1)
            _, lib_rel = rel_err(lib, want)
            ms = graph_ms(torch, lambda: tc.temporal_conv_k3(x, w, bias), calls=3)
            plain_ms = cuda_ms(torch, lambda: tc.temporal_conv_k3_plain(x, w, bias), iters=5)
            lib_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=(1, 0)), calls=3)
            flops = 6 * c * c * m
            r = row(err, rel, ms, plain_ms, nbytes(x, w, bias, got), flops, peak(dtype), lib_ms)
            print(f"temporal_conv_k3 [{b},{f},{n},{c}] Co={c} {name}: rel_err={rel:.3e} kernel "
                  f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s) plain {plain_ms:.4f} "
                  f"ms {bound_text(r)} (F.conv2d (3,1) filter, rel {lib_rel:.1e}; kernel and "
                  f"library graph-replayed) [{card}]",
                  flush=True)
            check(rel <= VIDEO_TOL[name], f"temporal_conv_k3 N={n} C={c} {name} rel err {rel}")
            rows["tconv"].append(r)
            del got, want, lib, xc, wc
        del x32, w32

        qkv32 = [torch.randn((b, f, n, c), generator=g, device=dev) for _ in range(3)]
        for dtype in types:
            rows["tattn"].append(frame_attention_row(torch, card, qkv32, heads, dtype))
        del qkv32

        fh = 4 * c
        ff32 = [torch.randn(s_, generator=g, device=dev) * sc for s_, sc in (
            ((m, c), 1.0), ((c, 2 * fh), c ** -0.5), ((2 * fh,), 0.1), ((fh, c), fh ** -0.5),
            ((c,), 0.1))]
        for dtype in types:
            name = str(dtype).split(".")[-1]
            args = [t.to(dtype) for t in ff32]
            got = gf.geglu_ff(*args)
            want = gf.geglu_ff_plain(*args)
            err, rel = rel_err(got, want)
            ms = graph_ms(torch, lambda: gf.geglu_ff(*args), calls=2)
            plain_ms = cuda_ms(torch, lambda: gf.geglu_ff_plain(*args), iters=3, warmup=1)
            flops = 6 * m * c * fh
            # two products and a gelu: no single PyTorch call, no library time
            r = row(err, rel, ms, plain_ms, nbytes(*args, got), flops, peak(dtype))
            print(f"geglu_ff M={m} C={c} F={fh} {name}: rel_err={rel:.3e} kernel {ms:.4f} ms "
                  f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, graph-replayed) plain "
                  f"{plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
            check(rel <= GEGLU_TOL[name], f"geglu_ff M={m} C={c} {name} rel err {rel}")
            rows["geglu_video"].append(r)
            del got, want, args
        del ff32

    # B8 at every shape of one CFG UNet call, of the decode of the frames and
    # of the encode of one image
    unet_gn = video_gn_shapes(ucfg, lh, lw, b, f)
    vae_gn = (vae_decode_gn_shapes(vcfg, lh, lw, f) if vcfg is not None
              else collections.Counter())
    enc_gn = (vae_encode_gn_shapes(vcfg, *encode_hw, 1) if encode_hw
              else collections.Counter())
    enc_n, dec_n = vae_counts(vcfg, lh * lw) if vcfg is not None else ({}, {})
    want_n = (video_counts(ucfg, lh, lw, n_ctx)["group_norm_sums"],
              dec_n.get("group_norm_sums", 0), enc_n["group_norm_sums"] if encode_hw else 0)
    check((sum(unet_gn.values()), sum(vae_gn.values()), sum(enc_gn.values())) == want_n,
          f"group-norm shapes {sum(unet_gn.values())}, {sum(vae_gn.values())}, "
          f"{sum(enc_gn.values())} != counts {want_n}")
    for shape in sorted(unet_gn.keys() | vae_gn.keys() | enc_gn.keys()):
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        for dtype in types:
            name = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            got, again = gn.group_norm_sums(x), gn.group_norm_sums(x)
            want = gn.group_norm_sums_plain(x)
            err, rel = rel_err(got, want)
            ms = graph_ms(torch, lambda: gn.group_norm_sums(x), calls=5)
            plain_ms = cuda_ms(torch, lambda: gn.group_norm_sums_plain(x), iters=3, warmup=1)
            lib_ms = graph_ms(torch, lambda: torch.var_mean(x, dim=1, correction=0), calls=5)
            r = row(err, rel, ms, plain_ms, nbytes(x, got), 3 * x.numel(), "fp32", lib_ms)
            enc = f", x{enc_gn[shape]} an encode" if encode_hw else ""
            print(f"group_norm_sums {list(shape)} {name} (x{unet_gn[shape]} a UNet call, "
                  f"x{vae_gn[shape]} a decode{enc}; {gn._splits(*shape)} row splits): "
                  f"rel_err={rel:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms, same bits twice="
                  f"{bool(torch.equal(got, again))} {bound_text(r)} (kernel and library "
                  f"graph-replayed) [{card}]", flush=True)
            check(rel <= GN_TOL and bool(torch.equal(got, again)),
                  f"group_norm_sums {list(shape)} {name}: rel err {rel} or not deterministic")
            rows["gn_video"].append(r)
            del x, got, again, want
        del x32

    call = dict(causal=False, softmax_shift=0.0)
    for what, bb, s_len, t_len, nh, d in video_flash_sites(ucfg, lh, lw, frames, n_ctx,
                                                           encode_hw is not None, b,
                                                           vcfg is not None):
        q = torch.randn((bb, s_len, nh, d), generator=g, device=dev).to(bf16)
        k, v = (torch.randn((bb, t_len, nh, d), generator=g, device=dev).to(bf16)
                for _ in range(2))
        got = fa.flash_attention(q, k, v, **call)
        want = fa.flash_attention_plain(q, k, v, **call)
        err, rel = rel_err(got, want)
        row_rel = flash_row_rel(got, want)
        del want
        ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v, **call), calls=2)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **call), iters=3)
        flops = 4 * bb * nh * s_len * t_len * d
        r = dict(row(err, rel, ms, plain_ms, nbytes(q, k, v, got), flops, "bf16_tensor",
                     sdpa_ms(torch, q, k, v)), b2=f"{what} [{bb},{s_len},{nh},{d}]")
        print(f"flash_attention {what} [{bb},{s_len},{nh},{d}] keys {t_len} bf16 non-causal "
              f"shift 0: abs_err={err:.3e} rel_err={rel:.3e} row_rel_err={row_rel:.3e} kernel "
              f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, graph-replayed) plain "
              f"{plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check_flash(what, err, row_rel)
        rows["flash_vae"].append(r)
        del q, k, v, got
    return rows


def b9_sites(torch, bsz: int):
    """(sites, counts): the distinct eligible stride-1 3x3 convs (H, W, C, D)
    of the i2vgen UNet at task G's latents, batch `bsz`, from the block plan,
    largest first; counts: each site's convs a UNet call."""
    from vitron_tpu_torch.kernels import conv2d as cv
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig, conv3x3_sites

    counts = conv3x3_sites(UNetSDVideoConfig.i2vgen_xl(), I2V_LATENT, I2V_LATENT)
    sites = sorted((s for s in counts if cv.eligible((bsz,) + s[:3], s[3], torch.float32)),
                   key=lambda s: (-s[0], s[2], s[3]))
    return sites, counts


def conv3x3_row(torch, card: str, x32, w32, dtype, what: str = "") -> dict:
    """B9 against its plain version on x32 / w32 cast to `dtype`: max
    |kernel - plain| over max |plain| and at each pixel's scale
    (`pixel_rel`), the same bits twice (`same`), CUDA-event times of the
    kernel (float32: with the cast of x and w to bf16) and the plain
    version, the bound (bytes of x, w and out once at 3.35 TB/s, or
    2 M 9C D FLOP at the bf16 tensor-core rate for both types: the
    products are bf16) and cuDNN's `F.conv2d` on the bf16-rounded x and w,
    channels-last, bf16 in and float32 sums; each with its TFLOP/s; printed."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import conv2d as cv

    bf16 = torch.bfloat16
    bsz, h, w, c = x32.shape
    d = w32.shape[-1]
    flops = 2 * bsz * h * w * 9 * c * d
    name = str(dtype).split(".")[-1]
    x, k = x32.to(dtype), w32.to(dtype)
    got = cv.conv3x3_same(x, k)
    same = torch.equal(got, cv.conv3x3_same(x, k))
    want = cv.conv3x3_plain(x, k)
    err, rel = rel_err(got, want)
    pixel_rel = flash_row_rel(got, want)
    # cuDNN: NCHW views of channels-last bf16 copies (made outside the
    # timed region), bf16 in, float32 sums, bf16 out
    xc = x.to(bf16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    kc = k.to(bf16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib = F.conv2d(xc, kc, padding=1).permute(0, 2, 3, 1)
    _, lib_rel = rel_err(lib, want)
    ms = cuda_ms(torch, lambda: cv.conv3x3_same(x, k), iters=5, warmup=2)
    plain_ms = cuda_ms(torch, lambda: cv.conv3x3_plain(x, k), iters=3, warmup=1)
    lib_ms = cuda_ms(torch, lambda: F.conv2d(xc, kc, padding=1), iters=5, warmup=2)
    r = dict(row(err, rel, ms, plain_ms, nbytes(x, k, got), flops, "bf16_tensor", lib_ms),
             pixel_rel=pixel_rel, same=same)
    print(f"conv3x3_same [{bsz},{h},{w},{c}] D={d} {name}{what}: rel_err={rel:.3e} "
          f"pixel_rel_err={pixel_rel:.3e} same bits twice {same} kernel {ms:.4f} ms "
          f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s) plain {plain_ms:.4f} ms "
          f"{bound_text(r)} (cuDNN F.conv2d bf16 channels-last "
          f"{flops / (lib_ms * 1e-3) / 1e12:.1f} TFLOP/s, rel {lib_rel:.1e}) [{card}]",
          flush=True)
    return r


def phase_conv3x3(torch, card: str):
    """B9 against its plain version, float32 and bf16, at every distinct
    eligible stride-1 3x3 conv (H, W, C, D) of the i2vgen UNet at task G's
    64x64 latents, batch 32 (CFG 2 x 16 frames), from the block plan
    (`b9_sites`); each row (`conv3x3_row`) within VIDEO_TOL of the
    largest output and PIXEL_REL of each pixel's, the same bits twice. Then
    the VJP's dx (the kernel) and dw on the card against
    `conv3x3_vjp_plain` at a 32x32 level shape."""
    from vitron_tpu_torch.kernels import conv2d as cv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    bsz = 2 * I2V_FRAMES
    sites, counts = b9_sites(torch, bsz)
    rows = {"conv3x3": []}
    for h, w, c, d in sites:
        x32 = torch.randn((bsz, h, w, c), generator=g, device=dev)
        w32 = torch.randn((3, 3, c, d), generator=g, device=dev) / (9 * c) ** 0.5
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[-1]
            r = conv3x3_row(torch, card, x32, w32, dtype,
                            f" (x{counts[(h, w, c, d)]} a UNet call, box "
                            f"{cv.plan_boxes(bsz, h, w)})")
            check(r["rel"] <= VIDEO_TOL[name] and r["pixel_rel"] <= PIXEL_REL[name]
                  and r["same"], f"conv3x3_same {(h, w, c, d)} {name}: rel err {r['rel']}, "
                  f"pixel rel err {r['pixel_rel']}, same bits twice {r['same']}")
            rows["conv3x3"].append(r)
        del x32, w32

    # the VJP at a level-1 shape: dx through the kernel, dw by products
    h, c, d = I2V_LATENT // 2, 1024, 1024
    for dtype in (f32, bf16):
        name = str(dtype).split(".")[-1]
        x = torch.randn((bsz, h, h, c), generator=g, device=dev).to(dtype)
        k = (torch.randn((3, 3, c, d), generator=g, device=dev) / (9 * c) ** 0.5).to(dtype)
        gy = torch.randn((bsz, h, h, d), generator=g, device=dev).to(dtype)
        with torch.enable_grad():
            xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
            n0 = cv.launches
            cv.conv3x3_same(xg, kg).backward(gy)
            torch.cuda.synchronize()
            launched = cv.launches - n0
        dx, dw = cv.conv3x3_vjp_plain(x, k, gy)
        _, rel_dx = rel_err(xg.grad, dx)
        _, rel_dw = rel_err(kg.grad, dw)
        print(f"conv3x3_same VJP [{bsz},{h},{h},{c}] D={d} {name}: dx rel_err={rel_dx:.3e}, dw "
              f"rel_err={rel_dw:.3e} against conv3x3_vjp_plain; {launched} launches (forward "
              f"and dx) [{card}]", flush=True)
        check(launched == 2 and rel_dx <= VIDEO_TOL[name] and rel_dw <= VIDEO_TOL[name],
              f"conv3x3_same VJP {name}: dx {rel_dx}, dw {rel_dw}, {launched} launches")
        del x, k, gy, xg, kg, dx, dw
    for name in ("float32", "bfloat16"):
        print_sums(f"conv3x3_same {name}", rows["conv3x3"][name == "bfloat16"::2], card)
    return rows


def phase_i2v_kernels(torch, card: str):
    """5d: the task-G path's kernels at its shapes: B6, B7 and B3 at the
    four levels of the i2vgen plan (2 x 16 frames of 64x64 latents) and B8
    at every [B, R, C] of one UNet call, of the 512^2 VAE encode and of the
    16-frame decode, float32 and bf16; B2 in bf16 (the only type
    `layers._mha` gives it) at D 512 (the encode's [1, 4096, 1, 512], the
    decode's [16, 4096, 1, 512]) and at D 64 (the 32x32 level's
    self-attention, [32, 1024, 16, 64])."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import Image2VideoConfig

    cfg = Image2VideoConfig()
    check(cfg.latent_size == I2V_LATENT and cfg.num_frames == I2V_FRAMES,
          f"Image2VideoConfig() latents {cfg.latent_size} x {cfg.num_frames} frames")
    rows = video_kernel_rows(torch, card, cfg.unet, cfg.vae, I2V_LATENT, I2V_LATENT, I2V_FRAMES,
                             i2v_context(cfg.unet, cfg.text.max_length), seed=14,
                             encode_hw=(cfg.size, cfg.size))
    for key, name in (("tconv", "B6"), ("tattn", "B7"), ("geglu_video", "B3"),
                      ("gn_video", "B8"), ("flash_vae", "B2")):
        print_sums(f"task-G shapes, {name}", rows[key], card)
    return {f"{k}_i2v": v for k, v in rows.items()}


def print_b2_rows(rs, card: str) -> None:
    """One line of B2's bf16 rows (every main path's type; `b2` is None on
    the float32 ones): each row's kernel ms beside
    F.scaled_dot_product_attention's on the same inputs."""
    bf = [r for r in rs if r["b2"]]
    faster = sum(r["ms"] < r["library_ms"] for r in bf)
    print("B2 bf16 rows, kernel ms / SDPA ms: "
          + "; ".join(f"{r['b2']} {r['ms']:.4f} / {r['library_ms']:.4f}" for r in bf)
          + f" ({faster} of {len(bf)} faster than SDPA) [{card}]", flush=True)


def print_sums(what: str, rs, card: str) -> None:
    """One line of a group of kernel rows: their summed kernel, bound,
    plain and library times."""
    lib = [r["library_ms"] for r in rs]
    bound = sum(max(r["bytes_ms"], r["ops_ms"]) for r in rs)
    lib_ms = "none" if None in lib else f"{sum(lib):.4f} ms"
    print(f"{what}: {len(rs)} rows, kernel {sum(r['ms'] for r in rs):.4f} ms, bound "
          f"{bound:.4f} ms, plain {sum(r['plain_ms'] for r in rs):.4f} ms, library {lib_ms}, "
          f"max rel err {max(r['rel'] for r in rs):.3e} [{card}]", flush=True)


def build_t2v(torch, cfg, device, seed: int):
    """T2V pipeline (float32, random weights with every zero leaf filled)."""
    from vitron_tpu_torch.models.diffusion import clip_text, unet_sd_video, vae
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoPipeline

    g = torch.Generator(device=device).manual_seed(seed)
    unet = fill_zero_leaves(unet_sd_video.init_params(g, cfg.unet, device), g)
    vae_p = fill_zero_leaves(vae.init_params(g, cfg.vae, device), g)
    text = fill_zero_leaves(clip_text.init_params(g, cfg.text, device), g)
    return Text2VideoPipeline(cfg, unet, vae_p, text,
                              tokenizer=StubClipTokenizer(cfg.text.vocab_size))


def video_requests(torch, card: str, system, reply: str, task: str, want: dict,
                   shape: tuple, what: str, **media):
    """A routed video reply, twice, on `system`: launches equal to `want`
    each time, status ok with `task`, a uint8 video of `shape`,
    finite latent and decoded frames before the uint8 cast (recorded around
    `vae.decode`), non-constant frames, and the same frames both times.
    Returns (launches, the second request's seconds)."""
    from vitron_tpu_torch.models.diffusion import vae

    label = f"task {reply[len('<module>')]}"
    decoded = []
    decode = vae.decode

    def recorded_decode(params, vcfg, z):
        out = decode(params, vcfg, z)
        decoded.append((bool(torch.isfinite(z).all()), bool(torch.isfinite(out).all()),
                        z.float().std().item(), out.float().abs().max().item()))
        return out

    runs = []
    vae.decode = recorded_decode
    try:
        for i in range(2):
            reset_launches()
            out, t_req = timed_route(torch, system, reply, **media)
            launches = expect_launches(want, f"{label} run {i + 1}")
            check(out["status"] == "ok" and out["task"] == task,
                  f"{label}: status {out['status']}, {out.get('error')}")
            video = out["video"]
            z_ok, frames_ok, z_std, fmax = decoded[-1]
            check(video.shape == shape and video.dtype == np.uint8,
                  f"{label} video {video.shape} {video.dtype}")
            check(z_ok and frames_ok, f"{label}: non-finite latent or decoded frames")
            check(int(video.max()) != int(video.min()), f"{label}: the frames are constant")
            runs.append(video)
            print(f"{label} run {i + 1}: request {t_req:.3f} s ({what}), video "
                  f"{video.shape} mean {video.mean():.2f} std {video.std():.2f}; final latent std "
                  f"{z_std:.3f}, decoded max |x| {fmax:.3f} before the clamp, finite [{card}]",
                  flush=True)
    finally:
        vae.decode = decode
    check(np.array_equal(runs[0], runs[1]), f"{label}: two identical requests gave other frames")
    return launches, t_req


def phase_task_d(torch, card: str, pipe):
    """A routed task-D reply, twice: `cfg.steps` DDIM-v steps of one CFG UNet
    call each, then the VAE decode of the frames. Identical frames both
    times, finite latent and decoded frames before the uint8 cast,
    non-constant frames, and launches of every kernel equal to the block
    plan's count x steps plus the VAE decode's. Then one CFG UNet call and
    one VAE decode at the request's shapes, timed alone."""
    from vitron_tpu_torch.models.diffusion import clip_text, vae
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = pipe.cfg
    system = VitronSystem(None)
    system.register_text2video(pipe)
    lh, lw = cfg.latent_hw
    per_call = video_counts(cfg.unet, lh, lw, cfg.text.max_length)
    _, dec = vae_counts(cfg.vae, lh * lw)
    want = {k: cfg.steps * per_call[k] + dec.get(k, 0) for k in per_call}
    torch.cuda.reset_peak_memory_stats()
    launches, t_req = video_requests(
        torch, card, system, TASK_D_REPLY, "video_generation", want,
        (cfg.num_frames, cfg.height, cfg.width, 3), f"{cfg.steps} DDIM-v steps")
    peak_mem = torch.cuda.max_memory_allocated()

    ids = pipe.tokenize(["a red car", ""])
    v_fn = pipe.v_fn(clip_text.encode(pipe.text_params, cfg.text, ids))
    g = torch.Generator(device=pipe.device).manual_seed(5)
    x = torch.randn((1, cfg.num_frames, lh, lw, cfg.unet.in_dim), generator=g,
                    device=pipe.device)
    unet_ms = cuda_ms(torch, lambda: v_fn(x, 501), iters=3, warmup=1)
    vae_ms = cuda_ms(torch, lambda: vae.decode(pipe.vae_params, cfg.vae, x[0]), iters=2,
                     warmup=1)
    profile_breakdown(torch, card, "task D: one float32 CFG UNet call",
                      lambda: v_fn(x, 501), unet_ms, VIDEO_KERNEL_GROUPS)
    print(f"task D: request {t_req:.3f} s ({cfg.steps} CFG UNet calls at {unet_ms:.2f} ms = "
          f"{cfg.steps * unet_ms / 1e3:.3f} s, VAE decode of {cfg.num_frames} frames "
          f"{vae_ms:.2f} ms, the rest {t_req - cfg.steps * unet_ms / 1e3 - vae_ms / 1e3:.3f} s), "
          f"peak memory {peak_mem / 2**30:.2f} GiB (float32 UNetSD_T2V, 320x576, "
          f"{cfg.num_frames} frames) [{card}]", flush=True)
    return launches


def build_i2v(torch, cfg, device, seed: int):
    """I2V pipeline (float32, random weights with every zero leaf filled) with
    a seeded stub image embedder, so the global tokens are live."""
    from vitron_tpu_torch.models.diffusion import clip_text, unet_sd_video, vae
    from vitron_tpu_torch.models.diffusion.synthetic import (StubClipTokenizer, StubImageEmbedder,
                                                             fill_zero_leaves)
    from vitron_tpu_torch.models.diffusion.video_pipelines import Image2VideoPipeline

    g = torch.Generator(device=device).manual_seed(seed)
    unet = fill_zero_leaves(unet_sd_video.init_params(g, cfg.unet, device), g)
    vae_p = fill_zero_leaves(vae.init_params(g, cfg.vae, device), g)
    text = fill_zero_leaves(clip_text.init_params(g, cfg.text, device), g)
    return Image2VideoPipeline(cfg, unet, vae_p, text,
                               tokenizer=StubClipTokenizer(cfg.text.vocab_size),
                               image_embedder=StubImageEmbedder(cfg.unet.y_dim, seed))


def phase_task_g(torch, card: str, pipe):
    """A routed task-G reply on a 480x640 image (resized to 512^2 on the
    host, C7), twice: the VAE encode of the image, `cfg.steps` DDIM-v steps
    of one CFG i2vgen UNet call each, then the VAE decode of the 16 frames.
    Identical frames both times, finite latent and decoded frames before the
    uint8 cast, non-constant frames, and launches of every kernel equal to
    the block plan's count x steps plus the VAE encode's and decode's (and
    none of B9, which no path calls). Then one CFG UNet call, one encode and
    one decode at the request's shapes, timed alone."""
    from vitron_tpu_torch.models.diffusion import clip_text, vae
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = pipe.cfg
    system = VitronSystem(None)
    system.register_image2video(pipe)
    ls = cfg.latent_size
    per_call = video_counts(cfg.unet, ls, ls, i2v_context(cfg.unet, cfg.text.max_length))
    enc, dec = vae_counts(cfg.vae, ls * ls)
    want = {k: cfg.steps * per_call[k] + enc.get(k, 0) + dec.get(k, 0) for k in per_call}
    image = np.random.RandomState(3).randint(0, 256, (480, 640, 3), np.uint8)
    torch.cuda.reset_peak_memory_stats()
    launches, t_req = video_requests(
        torch, card, system, TASK_G_REPLY, "image_to_video", want,
        (cfg.num_frames, cfg.size, cfg.size, 3),
        f"{cfg.steps} DDIM-v steps, a {image.shape[0]}x{image.shape[1]} image", image=image)
    peak_mem = torch.cuda.max_memory_allocated()

    ids, pixels, glob = pipe.prepare(image, "a boat on the sea")
    local = pipe.encode_image(pixels)
    v_fn = pipe.v_fn(clip_text.encode(pipe.text_params, cfg.text, ids), local, glob)
    g = torch.Generator(device=pipe.device).manual_seed(5)
    x = torch.randn((1, cfg.num_frames, ls, ls, cfg.unet.in_dim), generator=g,
                    device=pipe.device)
    unet_ms = cuda_ms(torch, lambda: v_fn(x, 501), iters=3, warmup=1)
    enc_ms = cuda_ms(torch, lambda: pipe.encode_image(pixels), iters=3, warmup=1)
    dec_ms = cuda_ms(torch, lambda: vae.decode(pipe.vae_params, cfg.vae, x[0]), iters=2,
                     warmup=1)
    profile_breakdown(torch, card, "task G: one float32 CFG i2vgen UNet call",
                      lambda: v_fn(x, 501), unet_ms, VIDEO_KERNEL_GROUPS)
    rest = t_req - cfg.steps * unet_ms / 1e3 - (enc_ms + dec_ms) / 1e3
    print(f"task G: request {t_req:.3f} s ({cfg.steps} CFG UNet calls at {unet_ms:.2f} ms = "
          f"{cfg.steps * unet_ms / 1e3:.3f} s, VAE encode of the {cfg.size}^2 image "
          f"{enc_ms:.2f} ms, decode of {cfg.num_frames} frames {dec_ms:.2f} ms, the rest "
          f"{rest:.3f} s), peak memory {peak_mem / 2**30:.2f} GiB (float32 UNetSD_I2VGen, "
          f"{cfg.size}x{cfg.size}, {cfg.num_frames} frames) [{card}]", flush=True)
    return launches


# device kernels of a video UNet call by what launched them: B2, the port's
# GEMM template (mode 1 = B6's temporal conv, 0 and 2 = B3's two products,
# plus its split-K reduction), B7, B8, cuDNN's convolutions, cuBLAS's
# products (projections, attention einsums), and the rest (PyTorch's
# elementwise and reduction kernels); the first pattern that matches counts
VIDEO_KERNEL_GROUPS = (
    ("B2 flash_attention", r"flash_fwd"),
    ("B6 temporal_conv_k3", r"gemm_(f32|bf16_tc)_kernel<1\b"),
    ("B3 geglu_ff", r"gemm_(f32|bf16_tc)_kernel<[02]\b|split_k_reduce"),
    ("B7 frame_attention", r"frame_attention_kernel"),
    ("B8 group_norm_sums", r"gn_sums_kernel|gn_split_reduce"),
    ("convolutions (cuDNN)", r"conv|implicit|cudnn|fprop|winograd"),
    ("products (cuBLAS)", r"gemm|cutlass"))


def profile_breakdown(torch, card: str, what: str, call, unprofiled_ms: float, kernel_groups):
    """Where one call's device time goes: a torch.profiler trace of the
    call, its kernels' device time summed by group (the first pattern of
    `kernel_groups` that matches a kernel's name) and by name, and the
    device's busy share of the unprofiled call."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
              if e.device_type == cuda}
    busy = sum(dev_ms.values())
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["the rest"] = 0.0
    for key, ms in dev_ms.items():
        name = next((n for n, pat in kernel_groups if re.search(pat, key)), "the rest")
        groups[name] += ms
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    print(f"{what} breakdown: {unprofiled_ms:.1f} ms unprofiled, device busy {busy:.1f} ms = "
          f"{busy / unprofiled_ms:.3f} of it (idle share {1 - busy / unprofiled_ms:.3f}); by "
          f"group (ms): " + "; ".join(f"{k} {v:.1f}" for k, v in groups.items()) + f" [{card}]",
          flush=True)
    print(f"{what} device time by kernel (ms): "
          + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top), flush=True)


def phase_video_unet_bf16(torch, card: str, dev):
    """bench.py's bench_video_unet step: x <- x - 0.01 * v over a CFG batch of
    2 x 24 frames of 40x72 latents, bf16 params, [2, 77, 1024] context; the
    MFU counts the block plan's FLOP against 989 TFLOP/s."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video as usv
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = usv.UNetSDVideoConfig.t2v()
    g = torch.Generator(device=dev).manual_seed(11)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      fill_zero_leaves(usv.init_params(g, cfg, dev), g))
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in tree_leaves(params))
    lh, lw = VIDEO_LATENT
    x0 = torch.randn((2, VIDEO_FRAMES, lh, lw, 4), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g, device=dev).to(torch.bfloat16)

    def steps(n):
        x = x0
        for i in range(n):
            v = usv.forward(params, cfg, x, torch.full((2,), float(i), device=dev), y=ctx)
            x = x - 0.01 * v.to(x.dtype)
        return x

    out = steps(2)
    check(bool(torch.isfinite(out.float()).all()), "bf16 video UNet step gave non-finite values")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(VIDEO_BF16_STEPS)
    torch.cuda.synchronize()
    rate = VIDEO_BF16_STEPS / (time.perf_counter() - t0)
    flops = video_unet_flops(cfg, lh, lw, VIDEO_FRAMES, 2, 77)
    mfu = flops * rate / PEAK_FLOPS["bf16_tensor"]
    print(f"video_unet_cfg_steps_per_s={rate:.4f} video_unet_mfu={mfu:.4f} (bf16 UNetSD_T2V, "
          f"{n_params / 1e9:.3f}B params counted in the built tree, CFG batch 2 x "
          f"{VIDEO_FRAMES} frames, 40x72 latents, {VIDEO_BF16_STEPS} steps after 2; "
          f"{flops / 1e12:.2f} TFLOP a step from the block plan, against 989 TFLOP/s) [{card}]",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return rate


def phase_video_cpu_vs_card(torch, card: str):
    """One float32 CFG-batch call of the t2v UNet at its real widths but
    reduced depth (two levels, 512 and 1024 channels), 8 frames and 16x16
    latents, on the CPU and on the card: B6 at C 512/1024, B7 at 8 and 16
    heads, B3 at C 512/1024 on the card."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video as usv
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = usv.UNetSDVideoConfig.t2v(dim_mult=(1, 2))
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(12)
    params = fill_zero_leaves(usv.init_params(g, cfg, cpu), g)
    x = torch.randn((2, 8, 16, 16, 4), generator=g)
    t = torch.tensor([501.0, 501.0])
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)
    t0 = time.perf_counter()
    want = usv.forward(params, cfg, x, t, y=ctx)
    print(f"video cpu-vs-card: cpu forward {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    reset_launches()
    got = usv.forward(tree_map(lambda a: a.to(dev), params), cfg, x.to(dev), t.to(dev),
                      y=ctx.to(dev)).cpu()
    expect_launches(video_counts(cfg, 16, 16, 77), "video cpu-vs-card")
    rel = (got - want).abs().max().item() / want.abs().max().item()
    print(f"video cpu-vs-card: float32 t2v UNet (levels 512/1024, 8 frames, 16x16 latents) "
          f"rel_err={rel:.3e} (limit {CPU_GPU_TOL}), max |v| {want.abs().max().item():.3f} "
          f"[{card}]", flush=True)
    check(rel <= CPU_GPU_TOL, f"video UNet CPU and card disagree: {rel}")


def phase_i2v_cpu_vs_card(torch, card: str):
    """One float32 CFG-batch call of the i2vgen UNet at its real widths but
    reduced depth (two levels, 512 and 1024 channels), 8 frames and 16x16
    latents (the local-image stream keeps its fixed 32x32 pool, here
    upsampling), with text, local and global conditioning, on the CPU and on
    the card: B6 at C 512/1024, B7 at 8 and 16 heads, B3 at C 512/1024, B8
    on the card; no flash site (8x8 is the attention level)."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video as usv
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = usv.UNetSDVideoConfig.i2vgen_xl(dim_mult=(1, 2))
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(15)
    params = fill_zero_leaves(usv.init_params(g, cfg, cpu), g)
    x = torch.randn((2, 8, 16, 16, 4), generator=g)
    t = torch.tensor([501.0, 501.0])
    fps = torch.tensor([16.0, 16.0])
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)
    glob = torch.randn((1, cfg.y_dim), generator=g)
    image = torch.cat([glob, torch.zeros_like(glob)])
    local = torch.randn((1, 16, 16, 4), generator=g).expand(2, 16, 16, 4).contiguous()
    args = dict(y=ctx, fps=fps, image=image, local_image=local)
    t0 = time.perf_counter()
    want = usv.forward(params, cfg, x, t, **args)
    print(f"i2v cpu-vs-card: cpu forward {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    reset_launches()
    got = usv.forward(tree_map(lambda a: a.to(dev), params), cfg, x.to(dev), t.to(dev),
                      **{k: v.to(dev) for k, v in args.items()}).cpu()
    n_ctx = i2v_context(cfg, 77)
    counts = expect_launches(video_counts(cfg, 16, 16, n_ctx), "i2v cpu-vs-card")
    tol = UNET_CPU_GPU_TOL["flash" if counts["flash_attention"] else "einsum"]
    rel = (got - want).abs().max().item() / want.abs().max().item()
    print(f"i2v cpu-vs-card: float32 i2vgen UNet (levels 512/1024, 8 frames, 16x16 latents, "
          f"{n_ctx} context tokens) rel_err={rel:.3e} (limit {tol}), "
          f"max |v| {want.abs().max().item():.3f} [{card}]", flush=True)
    check(rel <= tol, f"i2v UNet CPU and card disagree: {rel}")


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def random_int4_llm(torch, params, gen, device, scale=None, zero_mean=False):
    """Replace the 7 projections and lm_head with random packed int4: bytes
    uniform in [-128, 128), as the JAX package's bench makes them. scale
    None gives each weight the init's std 1/sqrt(fan_in) (a uniform nibble
    has std 4.61); the bench's fixed 2e-2 is ~6x that at Vicuna-7B width.
    zero_mean draws each nibble from [-7, 7] instead (std 4.32), as
    `quantize_int4` emits them: a uniform byte's nibbles average -0.5, which
    puts one offset on every output of a projection, and through the
    residual stream that makes the second layer's attention amplify
    rounding (PERF.md §6)."""
    llm = params["llm"]

    def qw(w):
        packed = tuple(w.shape[:-2]) + (w.shape[-2] // 2, w.shape[-1])
        if zero_mean:
            lo, hi = (torch.randint(-7, 8, packed, generator=gen, dtype=torch.int16,
                                    device=device) for _ in range(2))
            q4, std = (((hi & 0xF) << 4) | (lo & 0xF)).to(torch.uint8).view(torch.int8), 4.32
        else:
            q4 = torch.randint(-128, 128, packed, generator=gen, dtype=torch.int8, device=device)
            std = 4.61
        s = scale if scale is not None else 1.0 / (std * w.shape[-2] ** 0.5)
        return {"q4": q4, "s": torch.full(tuple(w.shape[:-2]) + (1, w.shape[-1]), s,
                                          dtype=torch.float32, device=device)}

    for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
        llm["layers"][t] = qw(llm["layers"][t])
    llm["lm_head"] = qw(llm["lm_head"])
    return params


def build_system(torch, cfg, device, seed: int, int4_scale=None):
    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.system import VitronSystem

    gen = torch.Generator(device=device).manual_seed(seed)
    params = random_int4_llm(torch, vitron_model.init_params(gen, cfg, device), gen, device,
                             int4_scale)
    torch.cuda.empty_cache()
    return VitronSystem(VitronEngine(params, cfg, DemoTokenizer(), device=device)), params


def timed_chat(torch, system, image, sampling):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.chat(PROMPT, image=image, region_box=BBOX, sampling=sampling)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def build_chat_system(torch):
    """The chat path's full-width system (phases 6 and 6b): Vicuna-7B with
    random packed-int4 projections and lm_head, flash prefill, bf16 ViT-L/14
    -> (system, params, cfg)."""
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig

    cfg = VitronConfig.serving(llm=LlamaConfig.vicuna_7b(attn_impl="flash", max_seq_len=1024))
    t0 = time.perf_counter()
    system, params = build_system(torch, cfg, torch.device("cuda"), seed=0, int4_scale=2e-2)
    torch.cuda.synchronize()
    print(f"slice: Vicuna-7B int4 + ViT-L/14 bf16 random weights built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return system, params, cfg


def int4_weight_bytes(params) -> int:
    """Packed int4 bytes and scales of the LLM's projections and lm_head:
    what one decode step must read."""
    return sum(leaf["q4"].numel() + leaf["s"].numel() * 4
               for leaf in list(params["llm"]["layers"].values()) + [params["llm"]["lm_head"]]
               if isinstance(leaf, dict))


def phase_slice(torch, card: str, system, params, cfg):
    from vitron_tpu_torch.runtime.generation import DEFAULT_DECODE_CHUNK, SamplingConfig

    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    sampling = SamplingConfig(greedy=True, max_new_tokens=NEW_TOKENS, eos_ids=())
    timed_chat(torch, system, image, sampling)  # warm-up (library handles, allocator)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out1, t_req = timed_chat(torch, system, image, sampling)
    peak = torch.cuda.max_memory_allocated()
    gen_ = system.engine.generator
    logits = gen_.last_prefill_logits
    tokens1 = out1["reply"]["tokens"]
    n_layers = cfg.llm.num_layers
    per_forward = 7 * n_layers + 1
    # int4: prefill + one forward per decode step, in whole chunks of
    # DEFAULT_DECODE_CHUNK steps (the decode chunk's graph replayed, each
    # replay counted as the launches it recorded; the host drops the tokens
    # past the budget, as the JAX scan does); flash: the prefill's layers
    steps = -(-(NEW_TOKENS - 1) // DEFAULT_DECODE_CHUNK) * DEFAULT_DECODE_CHUNK
    launches = expect_launches({"int4_matmul": per_forward * (1 + steps),
                                "flash_attention": n_layers}, "slice")
    print(f"slice: status={out1['status']} tokens={len(tokens1)} prefill logits "
          f"{tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())}", flush=True)
    check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    check(len(tokens1) == NEW_TOKENS, f"{len(tokens1)} tokens, expected {NEW_TOKENS}")

    out2, _ = timed_chat(torch, system, image, sampling)
    check(out2["reply"]["tokens"] == tokens1, "a second identical request gave other tokens")
    _, t_prefill = timed_chat(torch, system, image,
                              SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=()))
    decode_tok_s = (NEW_TOKENS - 1) / (t_req - t_prefill)
    MEASURED["decode_tok_s"] = decode_tok_s
    weight_bytes = int4_weight_bytes(params)
    print(f"slice: request {t_req:.3f} s (128 tokens, same tokens twice), prefill request "
          f"(1 token) {t_prefill:.3f} s, decode {decode_tok_s:.1f} tok/s "
          f"({weight_bytes * decode_tok_s / HBM_BYTES_PER_S:.3f} of the 3.35 TB/s weight-"
          f"stream roofline; the decode chunk replays a CUDA graph), peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    return launches


# ------------------------------------------------------------------ serving

SCAN_NEW = 128         # bench_e2e_request's new tokens (generate_scan)
SERVE_PREFILL = 256    # bench_continuous_batching's prompt tokens
SERVE_CHUNK = 64       # ... and its step_n chunk
SERVE_CHUNKS = 4       # step_n chunks a batch runs: the first captures, the best of 3 is timed
SERVE_COMPARE = 128    # tokens of each paged row held against the single stream
BATCHER_NEW = 64       # new tokens of each ContinuousBatcher request: 4 decode chunks of 16
SERVE_SEQ_LEN = 313    # slots of the image chat prompt without a box (its pad bucket: 384)
SERVE_SHORT = "Say hello to the user in one short sentence please now"
DIVERGE_ULPS = 2       # a greedy divergence is allowed where the top-2 gap is this close


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def plan_arrays(plan) -> tuple:
    """A splice plan as `generate_scan`'s plan arrays."""
    return (plan.token_ids, plan.media_idx, plan.use_media, plan.position_ids,
            plan.attention_mask, plan.seq_lens)


def teacher_forced_logits(torch, gen_, arrays, images, tokens, slots: int, **kw):
    """A single stream's logits [len(tokens), V] before each of `tokens`, fed
    `tokens`' own prefix: the prefill into a cache of `slots` slots (the
    decode chunk's), then host-index decode steps -- at the same slots and
    positions as the chunk's device-index steps, with the same operations,
    so the same logits the chunk's argmax read."""
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.models.llm.llama import KVCache

    cache = KVCache.create(gen_.cfg.llm, 1, max_len=slots, device=gen_.device)
    rows = [gen_._prefill(cache, *arrays, images=images, **kw)[0].float()]
    pos = int(arrays[5][0])
    for i, tok in enumerate(tokens[:-1]):
        step, _ = vitron_model.decode_step(gen_.params, gen_.cfg,
                                           torch.tensor([[tok]], device=gen_.device),
                                           torch.tensor([[pos + i]], device=gen_.device), cache)
        rows.append(step[0, -1].float())
    return torch.stack(rows)


def stream_logits(torch, gen_, arrays, images, tokens, j: int, slots: int, **kw):
    """A single stream's logits [V] before its token j (`teacher_forced_logits`)."""
    return teacher_forced_logits(torch, gen_, arrays, images, tokens[:j + 1], slots, **kw)[-1]


def check_divergence(what: str, got, want, logits_at, card: str) -> str:
    """Greedy `got` against the single stream `want`: identical, or first
    different at a token where the single stream's top-2 logits lie within
    DIVERGE_ULPS bf16 ulps of the larger (a near-tie that another order of
    sums may break either way). logits_at(j) gives the stream's logits."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        check(len(got) == len(want), f"{what}: {len(got)} tokens, single stream {len(want)}")
        return "identical"
    top = logits_at(j).topk(2).values.tolist()
    gap, limit = top[0] - top[1], DIVERGE_ULPS * bf16_ulp(top[0])
    msg = (f"first divergence at token {j} ({got[j]} vs {want[j]}): single stream's top-2 "
           f"logits {top[0]:.4f} / {top[1]:.4f}, gap {gap:.4f} (limit {limit:.4f}, "
           f"{DIVERGE_ULPS} bf16 ulps)")
    print(f"{what}: {msg} [{card}]", flush=True)
    check(gap <= limit, f"{what}: {msg}")
    return f"near-tie at {j}"


def check_teacher_forced(torch, what: str, got, gen_, arrays, images, slots: int,
                         card: str) -> str:
    """Every token of greedy `got` against the single stream fed `got`'s own
    tokens before it (`teacher_forced_logits`): its argmax, or below its top
    logit by no more than DIVERGE_ULPS bf16 ulps plus twice the noise, the
    largest |einsum - flash| logit of the single stream on the same prefix
    (two valid orders of the same bf16 sums, measured here). Two paths whose
    logits differ by d at most put a greedy pick at most 2 d below the
    other's top."""
    from vitron_tpu_torch.runtime.generation import Generator

    llm = gen_.cfg.llm
    other = dataclasses.replace(gen_.cfg, llm=dataclasses.replace(
        llm, attn_impl="einsum" if llm.attn_impl == "flash" else "flash"))
    ref = teacher_forced_logits(torch, gen_, arrays, images, got, slots)
    alt = teacher_forced_logits(torch, Generator(gen_.params, other, gen_.device), arrays,
                                images, got, slots)
    noise = (ref - alt).abs().max().item()
    del alt
    top = ref.max(-1).values.tolist()
    picked = ref[torch.arange(len(got)), torch.tensor(got, device=ref.device)].tolist()
    argmax = ref.argmax(-1).tolist()
    off = []
    for j, tok in enumerate(got):
        gap, limit = top[j] - picked[j], DIVERGE_ULPS * bf16_ulp(top[j]) + 2 * noise
        check(gap <= limit,
              f"{what}: token {j} ({tok}) lies {gap:.4f} below the single stream's top logit "
              f"{top[j]:.4f} fed the same prefix (limit {limit:.4f}: {DIVERGE_ULPS} bf16 ulps "
              f"and twice the einsum-flash noise {noise:.4f}) [{card}]")
        if argmax[j] != tok:
            off.append((j, round(gap, 4)))
    return (f"teacher-forced, {len(got) - len(off)} of {len(got)} tokens the single stream's "
            f"argmax, the others (token, gap) {off} within {DIVERGE_ULPS} bf16 ulps and twice "
            f"the einsum-flash noise {noise:.4f}")


def staged_trace_checks(trace, n_chunks: int) -> dict:
    """The batcher's event log: each staged admission is an `admit_embed`
    then `n_chunks` `admit_chunk`s (one at a time). -> {"decode_between":
    staged admissions with a decode between each two of their steps,
    "fused_while_staged": fused admissions made while one was staged}."""
    out = {"decode_between": 0, "fused_while_staged": 0, "staged": 0}
    steps = []  # trace positions of the current staged admission's steps
    for i, e in enumerate(trace):
        if e == "admit_embed":
            steps = [i]
        elif e == "admit_chunk" and steps:
            steps.append(i)
            if len(steps) == n_chunks + 1:
                out["staged"] += 1
                out["decode_between"] += all("decode" in trace[a + 1:b]
                                             for a, b in zip(steps, steps[1:]))
                steps = []
        elif e == "admit_fused" and steps:
            out["fused_while_staged"] += 1
    return out


def batcher_launches(batcher, trace_from: int, captures: int, cfg) -> dict:
    """The B1 and B2 launches a `ContinuousBatcher` made since its event
    log held `trace_from` events: a forward (7 projections a layer and the
    head, flash in every layer) for each prefill (a fused admission or a
    staged admission's chunk), one B1 forward for each decode step (a
    `step_n` chunk of `batcher.chunk` steps is a graph replay) and one for
    the warm-up step of each of the `captures` chunks captured meanwhile."""
    trace = batcher._trace[trace_from:]
    per_forward, n_layers = 7 * cfg.llm.num_layers + 1, cfg.llm.num_layers
    prefills = trace.count("admit_fused") + trace.count("admit_chunk")
    steps = trace.count("decode") * batcher.chunk + captures
    return {"int4_matmul": per_forward * (prefills + steps), "flash_attention": n_layers * prefills}


def phase_serve(torch, card: str, system, params, cfg):
    """Phase 6b: the serving stack on the chat path's system. Its main-path
    runs (a replayed generate_scan, step_n chunks at batch 1 and 4, the
    batcher's requests, the HTTP request) are each counted alone, from
    zeroed counts, and held to their exact launches; their sum is the
    `serve` path's count. The check's own runs (eager references, requests
    served alone, captures) are not counted."""
    from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from vitron_tpu_torch.models.llm.paged_cache import PagedServer
    from vitron_tpu_torch.runtime import telemetry
    from vitron_tpu_torch.runtime.engine import MediaItem, prepare_batch
    from vitron_tpu_torch.runtime.generation import SamplingConfig, generate_scan

    dev = torch.device("cuda")
    gen_ = system.engine.generator
    weight_bytes = int4_weight_bytes(params)
    per_forward, n_layers = 7 * cfg.llm.num_layers + 1, cfg.llm.num_layers
    counted = collections.Counter()  # the serve path's launches
    idle = {name: 0 for name, _, _ in _counters()}

    def count(what, want):
        """Hold the launches since `reset_launches` to `want` (every other
        kernel none) and add them to the serve path's count."""
        got = expect_launches({**idle, **want}, f"serve {what}")
        counted.update(got)
        return got

    # 1. generate_scan at bench_e2e_request's shape, replayed and eager
    row = [1] + [7] * 24 + [IMAGE_TOKEN_INDEX] + [9] * 24
    size = cfg.image_tower.image_size
    px = torch.from_numpy(np.random.RandomState(1).rand(size, size, 3).astype(np.float32))
    plan, images, _, _ = prepare_batch([row], [MediaItem("image", px)],
                                       image_len=cfg.image_tower.num_patches)
    arrays, images = plan_arrays(plan), images.to(dev)

    def scan(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate_scan(params, cfg, arrays, n, images=images, generator=gen_).cpu()
        return toks[0].tolist(), time.perf_counter() - t0

    t0 = time.perf_counter()
    scan(SCAN_NEW)  # captures the chunk
    t_capture = time.perf_counter() - t0
    chunk = gen_.last_chunk
    reset_launches()
    toks1, t_req = scan(SCAN_NEW)
    count("generate_scan", {"int4_matmul": per_forward * SCAN_NEW,
                            "flash_attention": n_layers})
    check(chunk.run.launches == {("int4_matmul", "launches"): per_forward * (SCAN_NEW - 1)},
          f"generate_scan: the chunk's graph holds {chunk.run.launches}")
    toks2, _ = scan(SCAN_NEW)
    _, t_prefill = scan(1)
    check(toks1 == toks2 and len(toks1) == SCAN_NEW,
          f"generate_scan: a second identical request gave other tokens ({len(toks1)})")
    pad_len = plan.token_ids.shape[1]
    seq = torch.as_tensor(plan.seq_lens, device=dev)[:, None]

    def decode(run):
        chunk.start(torch.tensor([[toks1[0]]], device=dev), seq, pad_len, 0.0, 1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return [toks1[0]] + chunk.emits[0].tolist(), time.perf_counter() - t0

    eager, t_eager = decode(chunk.run.body)  # the same steps, eagerly
    replayed, t_replay = decode(chunk.run)
    check(eager == toks1 and replayed == toks1,
          "generate_scan: the eager chunk or a bare replay gave other tokens than the scan")
    steps = SCAN_NEW - 1
    rate_r, rate_e = steps / t_replay, steps / t_eager
    per_token = chunk.run.launches_per_call / steps
    print(f"serve generate_scan: {SCAN_NEW} greedy tokens after an image + 49-word prefill, replayed "
          f"twice and eagerly: identical; request {t_req:.3f} s, prefill-only request "
          f"{t_prefill:.3f} s, first request (captures {steps} steps) {t_capture:.3f} s; "
          f"decode replayed {rate_r:.1f} tok/s ({weight_bytes * rate_r / HBM_BYTES_PER_S:.3f} "
          f"of the 3.35 TB/s weight-stream roofline), eager {rate_e:.1f} tok/s "
          f"({rate_r / rate_e:.2f}x); launches a replayed chunk "
          f"{dict((k[0], v) for k, v in chunk.run.launches.items())} "
          f"({per_token:.0f} a token) [{card}]", flush=True)

    # 2. PagedServer.step_n at bench_continuous_batching's shape, greedy
    llm = params["llm"]
    rs = np.random.RandomState(0)
    prompts = [[int(t) for t in rs.randint(1, 30000, SERVE_PREFILL)] for _ in range(4)]
    singles, single_arrays = [], []
    for p in prompts:
        pl, _, _, _ = prepare_batch([p], [], image_len=cfg.image_tower.num_patches)
        single_arrays.append(plan_arrays(pl))
        singles.append(generate_scan(params, cfg, single_arrays[-1], SERVE_COMPARE,
                                     generator=gen_)[0].tolist())
    slots = gen_.last_chunk.cache.k.shape[2]

    def paged(batch, counted_as=None):
        """step_n over `batch`: SERVE_CHUNKS chunks, the first captures; the
        replays are counted as `counted_as` when it is given."""
        srv = PagedServer(llm, cfg.llm, num_blocks=((SERVE_PREFILL + SERVE_CHUNKS * SERVE_CHUNK)
                                                    // 16 + 2) * len(batch),
                          block_size=16, max_blocks_per_seq=32)
        sids = [srv.add_request(p, chunk=SERVE_PREFILL) for p in batch]
        sampling = {sid: (0.0, 1.0, True) for sid in sids}
        rows, times = {sid: [] for sid in sids}, []
        for i in range(SERVE_CHUNKS):
            if i == 1:
                reset_launches()
            sampling["uniforms"] = torch.zeros((SERVE_CHUNK, len(sids)), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = srv.step_n(SERVE_CHUNK, sampling=sampling)
            times.append(time.perf_counter() - t0)
            for sid in sids:
                rows[sid] += out[sid]
        if counted_as:
            count(counted_as, {"int4_matmul": per_forward * SERVE_CHUNK * (SERVE_CHUNKS - 1)})
        fn = srv._chunk_fns.lookup((SERVE_CHUNK, len(sids), srv.max_blocks, True))
        check(fn.run.launches == {("int4_matmul", "launches"): per_forward * SERVE_CHUNK},
              f"step_n batch {len(sids)}: the chunk's graph holds {fn.run.launches}")
        return ([rows[s] for s in sids], len(sids) * SERVE_CHUNK / min(times[1:]),
                fn.run.launches_per_call)

    def held(what, got, i):
        return check_divergence(
            what, got[:SERVE_COMPARE], singles[i],
            lambda j: stream_logits(torch, gen_, single_arrays[i], None, singles[i], j, slots),
            card)

    rows1, tok_s1, launches1 = paged([prompts[0]], "step_n batch 1")
    same1 = held("serve step_n batch 1", rows1[0], 0)
    rows4s, _, _ = paged([prompts[0]] * 4)
    check(all(r == rows4s[0] for r in rows4s),
          "step_n: four identical prompts gave rows that differ")
    same4s = held("serve step_n batch 4 (identical prompts)", rows4s[0], 0)
    rows4, tok_s4, launches4 = paged(prompts, "step_n batch 4")
    same4 = [held(f"serve step_n batch 4 row {i}", r, i) for i, r in enumerate(rows4)]
    print(f"serve step_n: prefill {SERVE_PREFILL}, {SERVE_CHUNKS} chunks of {SERVE_CHUNK} "
          f"greedy tokens; against the single-stream Generator on the first {SERVE_COMPARE}: "
          f"batch 1 {same1}, four identical prompts bit-identical rows ({same4s}), batch 4 "
          f"{same4}; serve_batch1_tok_s {tok_s1:.1f}, serve_batch4_tok_s {tok_s4:.1f}, ratio "
          f"{tok_s4 / tok_s1:.2f}; launches a replayed chunk {launches1} (batch 1), "
          f"{launches4} (batch 4) [{card}]", flush=True)

    # 3. ContinuousBatcher through ServingPipeline: four staged image requests
    # (one sampled), then a short text-only one while they are staged
    from vitron_tpu_torch.runtime.pipeline import ServingPipeline

    greedy = SamplingConfig(greedy=True, max_new_tokens=BATCHER_NEW, eos_ids=())
    hot = SamplingConfig(temperature=0.9, top_p=0.9, max_new_tokens=BATCHER_NEW, eos_ids=())
    imgs = [np.random.RandomState(10 + i).randint(0, 256, (336, 448, 3), np.uint8)
            for i in range(4)]
    pipe = ServingPipeline(system)
    batcher = pipe.batcher
    try:
        reset_launches()
        t0 = time.perf_counter()
        futs = [pipe.submit(PROMPT, image=imgs[i], sampling=hot if i == 3 else greedy,
                            gen=torch.Generator(device=dev).manual_seed(3) if i == 3 else None)
                for i in range(4)]
        while "admit_embed" not in batcher._trace and time.perf_counter() - t0 < 300:
            time.sleep(0.005)
        futs.append(pipe.submit(SERVE_SHORT, sampling=greedy))
        results = [f.result(timeout=600) for f in futs]
        t_all = time.perf_counter() - t0
        trace, stats = list(batcher._trace), batcher.stats()
        captures = batcher.server._chunk_fns.stats()["misses"]
        count("batcher", batcher_launches(batcher, 0, captures, cfg))
    finally:
        pipe.close()
    del pipe, batcher
    check(all(len(r["reply"]["tokens"]) == BATCHER_NEW for r in results),
          f"batcher: replies of {[len(r['reply']['tokens']) for r in results]} tokens")
    staged = staged_trace_checks(trace, n_chunks=-(-SERVE_SEQ_LEN // 256))
    print(f"serve batcher: 4 image requests (384-slot bucket, staged) + 1 short, "
          f"{BATCHER_NEW} tokens each, in {t_all:.3f} s ({captures} step_n chunks captured "
          f"on the way); stats {stats}; trace {staged}: "
          f"{' '.join(trace)} [{card}]", flush=True)
    check(staged["staged"] == 4 and staged["decode_between"] >= 3
          and staged["fused_while_staged"] >= 1,
          f"batcher: staged admissions {staged} (want 4 staged, decode chunks between the "
          f"steps of every one after the first, the short request admitted while one is staged)")
    held3 = []
    for i in range(3):  # the greedy ones, each served alone
        prepared = system.prepare(PROMPT, image=imgs[i])
        pl, im, _, _, _ = system.engine.plan_turn(prepared["msg"], prepared["media"])
        check(int(pl.seq_lens[0]) == SERVE_SEQ_LEN and pl.token_ids.shape[1] == 384,
              f"batcher: the request has {int(pl.seq_lens[0])} slots, the B2 rows hold "
              f"{SERVE_SEQ_LEN} in a 384 bucket")
        alone = system.chat(PROMPT, image=imgs[i], sampling=greedy)["reply"]["tokens"]
        n = gen_.last_chunk.cache.k.shape[2]
        held3.append(check_divergence(
            f"serve batcher request {i}", results[i]["reply"]["tokens"], alone,
            lambda j: stream_logits(torch, gen_, plan_arrays(pl), im.to(dev), alone, j, n),
            card))
    print(f"serve batcher: greedy replies against each request served alone: {held3} "
          f"[{card}]", flush=True)

    # 4. the HTTP server on the full-width system
    import base64
    import io
    import urllib.request

    from PIL import Image

    from vitron_tpu_torch.apps.serve import serve

    srv = serve(system, host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        buf = io.BytesIO()
        Image.fromarray(imgs[0]).save(buf, format="PNG")
        body = json.dumps({"prompt": PROMPT, "image": base64.b64encode(buf.getvalue()).decode(),
                           "greedy": True, "max_new_tokens": 16}).encode()

        def post():
            req = urllib.request.Request(base + "/chat", data=body,
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read()), time.perf_counter() - t0

        first, t_first = post()  # captures the server's step_n chunk
        http_batcher = srv.pipeline.batcher
        mark = len(http_batcher._trace)
        misses = http_batcher.server._chunk_fns.stats()["misses"]
        reset_launches()
        chat, t_http = post()
        count("http", batcher_launches(
            http_batcher, mark, http_batcher.server._chunk_fns.stats()["misses"] - misses, cfg))
        check(chat.get("raw") == first.get("raw"), "http: a second identical request gave "
              "another reply")
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        srv.pipeline.close()
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"serve http: /health {health}; POST /chat with a 336x448 PNG: status "
          f"{chat.get('status')}, {len(chat.get('raw', '').split())} tokens in {t_http:.3f} s "
          f"(the first, which captured, {t_first:.3f} s); "
          f"/stats budget {stats['budget_bytes']} bytes (the card's total memory {total}), "
          f"resident {stats['resident_bytes']}, fits {stats['fits']}, graph caches "
          f"{stats['programs']}, batching {stats['batching']} [{card}]", flush=True)
    check(health.get("status") == "ok" and chat.get("status") == "chat"
          and len(chat.get("raw", "").split()) == 16 and stats["budget_bytes"] == total
          and stats["fits"] and "llm+towers" in stats["entries"]
          and stats["batching"]["finished"] == 2,
          f"http: health {health}, chat {chat.get('status')}, stats {stats}")
    launches = {name: counted[name] for name in idle}
    print(f"serve: launches of the main-path runs {launches} [{card}]", flush=True)
    print(f"serve graph caches: {telemetry.all_stats()} [{card}]", flush=True)
    return launches


# ------------------------------------------------------------ speculative decode

SPEC_NEW = 256              # (a) speculative=True: the whole budget one segment
SPEC_PROBE_NEW = 512        # (b) the default probe: a plain chunk, then segments
SPEC_STOPPER_NEW = 256      # (c) a KeywordStopper request with an EOS: segments of <= 64 tokens
SPEC_FALLBACK_NEW = 256     # (d) VITRON_SPEC_TPF_MIN forced high: back to plain chunks
SPEC_CHAT_TURNS = 3         # (e) the 128-token chat at each policy, in turns, best kept


def spec_request(torch, system, image):
    """The chat request's generate arguments (the image chat prompt with its
    box, as phase 6 sends it) -> (plan, generate kwargs, the prefill's kwargs
    for `stream_logits`)."""
    gen_ = system.engine.generator
    prepared = system.prepare(PROMPT, image=image, region_box=BBOX)
    plan, images, videos, perm, _ = system.engine.plan_turn(prepared["msg"], prepared["media"])
    kw = dict(images=images, videos=videos, block_perm=perm,
              region_boxes=prepared["region_boxes"])
    pre = {"region_boxes": gen_._t(prepared["region_boxes"], torch.float32),
           "region_block_idx": gen_._t(plan.region_blocks, torch.int64)}
    if perm is not None:
        pre["block_perm"] = gen_._t(perm, torch.int64)
    return plan, kw, pre


def phase_spec(torch, card: str, system, params, cfg):
    """Phase 6c: speculative decode on the chat system (Vicuna-7B int4, flash,
    bf16 tower), F = `generation.SPEC_FORWARDS` verify forwards a graph
    replay (chosen by `tools/spec_forwards.py`): (a) speculative=True over
    SPEC_NEW tokens, whole and in 64-token segments, (b) the default probe
    over SPEC_PROBE_NEW (a plain chunk, then it upgrades), (c) a
    KeywordStopper request through `VitronSystem.chat` (VITRON_SPEC=2:
    segments from the start) whose EOS is the plain stream's token first
    seen last, (d) the same without the EOS and with VITRON_SPEC_TPF_MIN=1000
    (back to plain chunks after 8 forwards), (e) the 128-token chat of phase
    6 at the default policy beside VITRON_SPEC=0 (the probe stays plain on
    the same 512-slot graph). Each stream against the graphed plain greedy
    stream of the same request (identical, or a near-tie `check_divergence`
    accepts); each measured run (after a first one that captures its
    graphs) held to its exact launches: a prefill, 225 B1 a step of each
    plain chunk replay and 225 B1 + 32 B2 a verify forward of each
    speculative replay, masked forwards included; no segment emits
    nothing."""
    from vitron_tpu_torch.mm.tokenization import KeywordStopper
    from vitron_tpu_torch.runtime import generation as gmod

    gen_ = system.engine.generator
    dev = torch.device("cuda")
    f = gmod.SPEC_FORWARDS
    per_forward, n_layers = 7 * cfg.llm.num_layers + 1, cfg.llm.num_layers
    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    plan, kw, pre = spec_request(torch, system, image)
    arrays = plan_arrays(plan)
    chunk_calls = []
    real_call = gmod._DecodeChunk.__call__

    def counted_call(self, gen):
        chunk_calls.append(self.n)
        return real_call(self, gen)

    gmod._DecodeChunk.__call__ = counted_call
    counted = collections.Counter()
    idle = {name: 0 for name, _, _ in _counters()}

    def greedy(n, eos=()):
        return gmod.SamplingConfig(greedy=True, max_new_tokens=n, eos_ids=eos)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run(n, **gkw):
        return gen_.generate(plan, sampling=greedy(n), **kw, **gkw)[0]

    def chat(sampling):
        return system.chat(PROMPT, image=image, region_box=BBOX, sampling=sampling)

    def expect(what):
        """Hold the run's launches to the prefill, its plain chunk replays
        and its speculative replays, and add them to the spec path's count."""
        steps = sum(chunk_calls)
        replays = sum(r for _, _, r in gen_.last_spec_segments)
        want = {"int4_matmul": per_forward * (1 + steps + replays * f),
                "flash_attention": n_layers * (1 + replays * f)}
        got = expect_launches({**idle, **want}, f"spec {what}")
        counted.update(got)
        return replays

    def measured(what, fn):
        """fn() once to capture its graphs, then once counted and timed."""
        fn()
        chunk_calls.clear()
        reset_launches()
        out, t_req = timed(fn)
        st = dict(gen_.last_spec_stats or {})
        return out, t_req, st, expect(what)

    def compare(what, got, want, slots):
        return check_divergence(f"spec {what}", got, want, lambda j: stream_logits(
            torch, gen_, arrays, kw["images"].to(dev), want, j, slots, **pre), card)

    def slots():
        return gen_.last_chunk.cache.k.shape[2]

    try:
        # plain graphed references (their graphs captured by the first call)
        run(1, speculative=False)
        t_prefill = timed(lambda: run(1, speculative=False))[1]
        plain = {}
        for n in sorted({SPEC_NEW, SPEC_PROBE_NEW}):
            run(n, speculative=False)
            plain[n], t_plain = timed(lambda: run(n, speculative=False))
            print(f"spec: plain graphed greedy reference, {n} tokens in {t_plain:.3f} s "
                  f"({(n - 1) / (t_plain - t_prefill):.1f} tok/s decode, {slots()}-slot cache) "
                  f"[{card}]", flush=True)
        # (a) whole, and the same budget in 64-token segments (a stopper that
        # never fires), best of two
        stop = KeywordStopper(["no such stop string"], system.engine.tokenizer, prompt_len=0)
        run(SPEC_NEW, speculative=True, stopper=stop)  # captures the graph
        seg_toks, seg_s = min((timed(lambda: run(SPEC_NEW, speculative=True, stopper=stop))
                               for _ in range(2)), key=lambda r: r[1])
        seg_replays = [r for _, _, r in gen_.last_spec_segments]
        compare("(a) in segments", seg_toks, plain[SPEC_NEW], slots())
        t_other = timed(lambda: run(SPEC_NEW, speculative=True))[1]
        toks, t_req, st, replays = measured("(a)", lambda: run(SPEC_NEW, speculative=True))
        t_req = min(t_req, t_other)
        spec = gen_.last_chunk.spec[(4, 2, (), f)]
        check(spec.run.launches == {("int4_matmul", "launches"): per_forward * f,
                                    ("flash_attention", "launches"): n_layers * f},
              f"spec graph F={f} recorded {spec.run.launches}")
        print(f"spec (a) speculative=True F={f}: {len(toks)} tokens in {t_req:.3f} s "
              f"({len(toks) / t_req:.1f} tok/s with the prefill, "
              f"{(len(toks) - 1) / (t_req - t_prefill):.1f} decode), forwards "
              f"{st['forwards']} (tokens per forward {st['emitted'] / st['forwards']:.2f}), "
              f"replays {replays} ({replays * f} verify forwards run, "
              f"{replays * f - st['forwards'] + 1} masked), segments (emitted, forwards, "
              f"replays) {gen_.last_spec_segments}; in 64-token segments {seg_s:.3f} s "
              f"(replays {seg_replays}) [{card}]", flush=True)
        compare("(a)", toks, plain[SPEC_NEW], slots())
        # (b) the default probe
        with mock.patch.dict(os.environ, {"VITRON_SPEC": "1"}):
            toks, t_req, st, replays = measured("(b) probe", lambda: run(SPEC_PROBE_NEW))
        check(st["mode"] == "probe_spec", f"spec (b): the probe did not upgrade: {st}")
        print(f"spec (b) probe: {len(toks)} tokens in {t_req:.3f} s ({len(toks) / t_req:.1f} "
              f"tok/s), stats {st}, plain chunk replays {len(chunk_calls)}, spec replays "
              f"{replays}, segments {gen_.last_spec_segments}, {slots()}-slot cache "
              f"[{card}]", flush=True)
        compare("(b) probe", toks, plain[SPEC_PROBE_NEW], slots())
        # (c) a KeywordStopper request with an EOS, (d) the forced fallback
        with mock.patch.dict(os.environ, {"VITRON_SPEC": "0"}):
            free = chat(greedy(SPEC_STOPPER_NEW))["reply"]["tokens"]
        first = {}
        for i, t in enumerate(free):
            first.setdefault(t, i)
        eos_at = max(first.values())
        check(eos_at > 0, f"spec (c): the plain stream is one token repeated: {free[:8]}")
        for what, n, eos, env in (("(c) stopper", SPEC_STOPPER_NEW, (free[eos_at],), {}),
                                  ("(d) fallback", SPEC_FALLBACK_NEW, (),
                                   {"VITRON_SPEC_TPF_MIN": "1000"})):
            sampling = greedy(n, eos)
            with mock.patch.dict(os.environ, {"VITRON_SPEC": "0"}):
                want = chat(sampling)["reply"]["tokens"]
            with mock.patch.dict(os.environ, {"VITRON_SPEC": "2", **env}):
                out, t_req, st, replays = measured(what, lambda: chat(sampling))
            toks = out["reply"]["tokens"]
            check(st["fell_back"] == (what == "(d) fallback"),
                  f"spec {what}: fell_back {st['fell_back']}")
            if eos:
                check(want == free[:eos_at + 1], f"spec {what}: the plain stream with the "
                      f"EOS {eos} is not the free one cut at {eos_at}")
            print(f"spec {what}: {len(toks)} tokens in {t_req:.3f} s ({len(toks) / t_req:.1f} "
                  f"tok/s), EOS {eos} (first seen at {eos_at if eos else None}), stats {st}, "
                  f"plain chunk replays {len(chunk_calls)}, spec replays {replays}, segments "
                  f"{gen_.last_spec_segments} [{card}]", flush=True)
            compare(what, toks, want, slots())
        # (e) phase 6's chat at the default policy beside VITRON_SPEC=0, in turns
        chat_s, chat_toks, chat_slots = {"0": [], "1": []}, {}, {}
        for turn in range(SPEC_CHAT_TURNS):
            for mode in ("0", "1"):
                with mock.patch.dict(os.environ, {"VITRON_SPEC": mode}):
                    chunk_calls.clear()
                    reset_launches()
                    out, t_req = timed(lambda: chat(greedy(NEW_TOKENS)))
                    if mode == "1" and turn == SPEC_CHAT_TURNS - 1:
                        st = dict(gen_.last_spec_stats)
                        expect("(e) default chat")
                chat_s[mode].append(t_req)
                chat_toks[mode], chat_slots[mode] = out["reply"]["tokens"], slots()
        check(chat_toks["1"] == chat_toks["0"] and chat_slots["1"] == chat_slots["0"]
              and st["mode"] == "probe_plain",
              f"spec (e): the default chat differs from VITRON_SPEC=0: slots {chat_slots}, "
              f"stats {st}")
        print(f"spec (e) the {NEW_TOKENS}-token chat, best of {SPEC_CHAT_TURNS} in turns: "
              f"default policy {min(chat_s['1']):.4f} s, VITRON_SPEC=0 {min(chat_s['0']):.4f} s "
              f"(all {chat_s}), both on a {chat_slots['0']}-slot cache, stats {st} [{card}]",
              flush=True)
    finally:
        gmod._DecodeChunk.__call__ = real_call
    check(gen_.zero_emission_segments == 0,
          f"spec: {gen_.zero_emission_segments} segments emitted nothing")
    print(f"spec: zero-emission segments {gen_.zero_emission_segments}; path launches "
          f"{dict(counted)} [{card}]", flush=True)
    return dict(counted)


HOST_BUDGET = 64 * 1024 ** 3  # the memory plan of a system on the host (no default there)


def phase_cpu_vs_card(torch, card: str):
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.generation import SamplingConfig
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
    from vitron_tpu_torch.runtime.system import VitronSystem
    from vitron_tpu_torch.apps.cli import DemoTokenizer

    f32 = torch.float32
    cfg = VitronConfig(
        llm=LlamaConfig.vicuna_7b(num_layers=2, attn_impl="flash", max_seq_len=1024,
                                  param_dtype=f32, compute_dtype=f32),
        image_tower=ViTConfig.clip_vit_l14(), video_tower=ViTConfig.video_vit_l14())
    dev = torch.device("cuda")
    # init-scale int4 weights: at the bench's 2e-2 the random net is chaotic
    # (a 1e-6 relative nudge of one input moved the logits by 8e-3 relative
    # on the CPU), so no two summation orders could agree to 1e-3 there
    _, params = build_system(torch, cfg, dev, seed=5)

    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    one = SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=())
    logits = {}
    for name, device, p in (("cuda", dev, params), ("cpu", torch.device("cpu"), tree_map(lambda a: a.cpu(), params))):
        engine = VitronEngine(p, cfg, DemoTokenizer(), device=device)
        t0 = time.perf_counter()
        plan = MemoryPlan.for_device(device) if name == "cuda" else MemoryPlan(HOST_BUDGET)
        VitronSystem(engine, memory_plan=plan).chat(PROMPT, image=image, region_box=BBOX,
                                                    sampling=one)
        logits[name] = engine.generator.last_prefill_logits.float().cpu()
        print(f"cpu-vs-card: {name} prefill {time.perf_counter() - t0:.1f} s", flush=True)
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    rel = err / logits["cpu"].abs().max().item()
    same = bool((logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).all())
    print(f"cpu-vs-card: 2-layer full-width float32 prefill, last-position logits rel_err="
          f"{rel:.3e} same_argmax={same} [{card}]", flush=True)
    check(rel <= CPU_GPU_TOL and same, f"CPU and card disagree: rel {rel}, same argmax {same}")


# ------------------------------------------------------------------ training

TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|
TRAIN_SEQ = 2048     # pad_len: the recipe's model_max_length
TRAIN_BATCH = 2      # the recipe's 16 (trainer.py:46) cut for the smoke's time
TRAIN_STEPS = 3
TRAIN_MESH_STEPS = 2  # phase 32's steps in each arm
TRAIN_REMAT = False  # per-layer recomputation; on when a step's peak would pass ~70 GB
TRAIN_LOSS_RTOL = 1e-6  # the same step twice from the same state
TRAIN_CPU_GPU_TOL = {"loss": 1e-4, "grad": 1e-3}  # grad: max |card - cpu| / max |cpu|
TRAIN_BOX = [30.0, 40.0, 180.0, 200.0]  # a region in the tower's 224^2 pixels (C10)
# The bf16 LoRA step (C11), card against the CPU's plain versions in bf16,
# is held per gradient tensor by its cosine with the CPU's and by
# ||card - cpu|| / ||cpu||: both sides round to bf16 at the same places and
# differ in the order of float32 sums, which flips bf16 roundings and, on a
# random net, moves some gradients a few percent. The limits sit between
# that noise and a dropped 64-deep K chunk of B1 or a dropped 64-key tile
# of B5 (`tools/grad_noise.py --check`, PERF.md section 6).
TRAIN_BF16_GRAD_LIMIT = {"cos": 0.999, "rel_norm": 0.05}
# question and answer lengths in words (DemoTokenizer: a token a word): with
# the 256 image tokens a row fills 1,490-1,900 of the 2,048 slots
TRAIN_WORDS = (200, 350, 1000, 1250)
TRAIN_KERNEL_GROUPS = (
    ("B1 int4_matmul", r"int4_(gemm|gemm_tc|gemv|split_reduce)_kernel"),
    ("B2 flash forward", r"flash_fwd"),
    ("B5a flash dK/dV", r"flash_bwd_kv"),
    ("B5b flash dQ", r"flash_bwd_q"),
    ("products (cuBLAS)", r"gemm|cutlass|xmma"))
TRAIN_FLASH_CASES = [  # name, B, S, T, N, KH, D, q_offset, causal, valid slots of each row
    ("slice", 2, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 128, 0, True, (1893, 1610)),
    ("gqa", 2, 1024, 1536, 32, 8, 128, 512, True, (1536, 1402)),
    ("non-causal-d64", 2, 1024, 1024, 16, 16, 64, 0, False, (1024, 899)),
]


def b2_shapes() -> list:
    """Every shape the smoke holds B2 at, in the order of its phases (3, 4,
    5b, 18, 5d): a label, the shape (B, S, T, N, KH, D), q_offset, causal,
    the valid key slots of each batch row (None: no kv_mask), softmax_shift,
    whether the LSE is returned, and the input type. `tools/flash_rows.py`
    times these."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import (Image2VideoConfig,
                                                                   Text2VideoConfig)

    def shape(label, b, s, t, n, kh, d, off=0, causal=False, valid=None, shift=0.0, lse=False,
              dtype="bfloat16"):
        return dict(label=label, b=b, s=s, t=t, n=n, kh=kh, d=d, q_offset=off, causal=causal,
                    valid=valid, shift=shift, lse=lse, dtype=dtype)

    out = [shape(f"chat {name} [1,{s},{n},128]", 1, s, t, n, kh, 128, off, True, (n_valid,),
                 None)
           for name, s, t, n, kh, off, n_valid in CHAT_FLASH_CASES]
    out += [shape(f"gligen [{b},{s},{n},{d}]", b, s, s, n, n, d)
            for b, s, n, d in GLIGEN_FLASH_SHAPES]
    t2v = Text2VideoConfig()
    out += [shape(f"task D {what} [{b},{s},{n},{d}]", b, s, t, n, n, d)
            for what, b, s, t, n, d in video_flash_sites(t2v.unet, *VIDEO_LATENT, VIDEO_FRAMES,
                                                         t2v.text.max_length, False)]
    out += [shape(f"train {name} [{b},{s},{n},{d}]", b, s, t, n, kh, d, off, causal, valid,
                  None, True, dtype)
            for dtype in ("bfloat16", "float32")
            for name, b, s, t, n, kh, d, off, causal, valid in TRAIN_FLASH_CASES]
    i2v = Image2VideoConfig()
    out += [shape(f"task G {what} [{b},{s},{n},{d}]", b, s, t, n, n, d)
            for what, b, s, t, n, d in video_flash_sites(
                i2v.unet, I2V_LATENT, I2V_LATENT, I2V_FRAMES,
                i2v_context(i2v.unet, i2v.text.max_length), True)]
    return out


def train_step_launches(llm_cfg) -> dict:
    """Kernel launches of one training step of the LLM: every projection and
    the lm_head on B1 and every layer's attention on B2 in the forward (both
    again under remat), B5a and B5b once a layer in the backward."""
    again = 2 if llm_cfg.remat else 1
    n = llm_cfg.num_layers
    return {"int4_matmul": 7 * n * again + 1, "flash_attention": n * again,
            "flash_attention_bwd_kv": n, "flash_attention_bwd_q": n}


def sdpa_bwd_ms(torch, q, k, v, attn_mask, dout) -> float:
    """F.scaled_dot_product_attention's backward on the same [B, S, N, D]
    inputs: CUDA-event time of forward + backward minus the forward's (both
    with grad on, so the forward keeps what its backward needs)."""
    import torch.nn.functional as F

    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))
    gt = dout.transpose(1, 2)
    gqa = q.shape[2] != k.shape[2]

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, enable_gqa=gqa)

    with torch.enable_grad():
        both = cuda_ms(torch, lambda: torch.autograd.grad(fwd(), (qt, kt, vt), gt), iters=5)
        fwd_only = cuda_ms(torch, fwd, iters=5)
    return both - fwd_only


def phase_train_kernels(torch, card: str):
    """B2 with its LSE, B5a and B5b against their plain versions at the
    trainer's attention shape [2, 2048, 32, 128] (causal, right-padded),
    a GQA row with q_offset > 0 and a non-causal D 64 row, in bf16 and f32;
    then B1 at the trainer's M = 4096 rows and the four (K, N) pairs."""
    from vitron_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows = {"flash_lse": [], "bwd_kv": [], "bwd_q": [], "int4_train": []}
    for name, b, s_len, t_len, nh, kh, d, off, causal, valid in TRAIN_FLASH_CASES:
        mask = torch.zeros((b, t_len), dtype=torch.bool, device=dev)
        for i, n_valid in enumerate(valid):
            mask[i, :n_valid] = True
        visible = fa._visible(b, s_len, t_len, dev, mask, off, causal)[:, 0, 0]  # [B, S, T]
        pairs = int(visible.sum()) * nh  # (query row, key) pairs the kernels compute
        scale = 1.0 / d ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            tn = str(dtype).split(".")[1]
            peak = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
            q, dout = (torch.randn((b, s_len, nh, d), generator=g, device=dev).to(dtype)
                       for _ in range(2))
            k, v = (torch.randn((b, t_len, kh, d), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            args = (q, k, v, mask, off, scale, causal)
            out, lse = fa._forward(*args, None, True)
            out2, lse2 = fa._forward(*args, None, True)
            want_out, want_lse = fa.flash_attention_plain(*args, None, return_lse=True)
            delta = fa._delta(out, dout)
            dk, dv = fa.flash_attention_bwd_kv(*args, out, lse, dout, delta)
            dq = fa.flash_attention_bwd_q(*args, out, lse, dout, delta)
            dk2, dv2 = fa.flash_attention_bwd_kv(*args, out, lse, dout, delta)
            dq2 = fa.flash_attention_bwd_q(*args, out, lse, dout, delta)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in
                       ((out, out2), (lse, lse2), (dk, dk2), (dv, dv2), (dq, dq2)))
            want_dk, want_dv = fa.flash_attention_bwd_kv_plain(*args, out, lse, dout)
            want_dq = fa.flash_attention_bwd_q_plain(*args, out, lse, dout)
            live = want_lse > -1e30
            row_rel = flash_row_rel(out, want_out)
            bwd_rows = {what: flash_row_rel(x, y, FLASH_BWD_ROW_FLOOR) for what, x, y in
                        (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))}
            errs = {"out": rel_err(out, want_out), "lse": rel_err(lse[live], want_lse[live]),
                    "dq": rel_err(dq, want_dq), "dk": rel_err(dk, want_dk),
                    "dv": rel_err(dv, want_dv)}
            ms_fwd = cuda_ms(torch, lambda: fa._forward(*args, None, True), iters=10)
            ms_kv = cuda_ms(torch, lambda: fa.flash_attention_bwd_kv(*args, out, lse, dout,
                                                                     delta), iters=10)
            ms_q = cuda_ms(torch, lambda: fa.flash_attention_bwd_q(*args, out, lse, dout,
                                                                   delta), iters=10)
            plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_plain(
                *args, None, return_lse=True), iters=3, warmup=1)
            plain_kv = cuda_ms(torch, lambda: fa.flash_attention_bwd_kv_plain(
                *args, out, lse, dout), iters=3, warmup=1)
            plain_q = cuda_ms(torch, lambda: fa.flash_attention_bwd_q_plain(
                *args, out, lse, dout), iters=3, warmup=1)
            lib_bwd = sdpa_bwd_ms(torch, q, k, v, visible[:, None], dout)
            lib_fwd = sdpa_ms(torch, q, k, v, visible[:, None])
            row_fwd = dict(row(max(errs["out"][0], errs["lse"][0]),
                               max(errs["out"][1], errs["lse"][1]), ms_fwd, plain_fwd,
                               nbytes(q, k, v, mask, out, lse), 4 * d * pairs, peak, lib_fwd),
                           b2=f"train {name}" if dtype == torch.bfloat16 else None)
            # B5a does 4 of the backward's products (scores, dP, dV, dK), B5b 3
            # (scores, dP, dQ); the SDPA backward (dq, dk, dv in one call)
            # stands beside B5a + B5b and is written on B5a's row
            row_kv = row(max(errs["dk"][0], errs["dv"][0]), max(errs["dk"][1], errs["dv"][1]),
                         ms_kv, plain_kv, nbytes(q, k, v, mask, dout, lse, delta, dk, dv),
                         4 * 2 * d * pairs, peak, lib_bwd)
            row_q = row(errs["dq"][0], errs["dq"][1], ms_q, plain_q,
                        nbytes(q, k, v, mask, dout, lse, delta, dq), 3 * 2 * d * pairs, peak)
            five = max(nbytes(q, k, v, mask, out, dout, lse, dq, dk, dv) / HBM_BYTES_PER_S,
                       5 * 2 * d * pairs / PEAK_FLOPS[peak]) * 1e3
            seven_tflops = 7 * 2 * d * pairs / ((ms_kv + ms_q) * 1e-3) / 1e12
            print(f"train flash {name} {tn} B={b} S={s_len} T={t_len} N={nh} K={kh} D={d} "
                  f"q_offset={off} causal={causal}: rel_err "
                  + " ".join(f"{k_}={e[1]:.3e}" for k_, e in errs.items())
                  + f" (limit {TRAIN_TOL[tn]}), out row_rel_err={row_rel:.3e} (limit "
                  f"{FLASH_ROW_REL}), row_rel_err "
                  + " ".join(f"{k_}={e:.3e}" for k_, e in bwd_rows.items())
                  + f" (limit {FLASH_BWD_ROW_REL[tn]}), same bits twice={same}; B2+LSE "
                  f"{ms_fwd:.4f} ms "
                  f"({4 * d * pairs / (ms_fwd * 1e-3) / 1e12:.1f} TFLOP/s) plain "
                  f"{plain_fwd:.4f} {bound_text(row_fwd)}; B5a {ms_kv:.4f} ms plain "
                  f"{plain_kv:.4f} {bound_text(row_kv)}; B5b {ms_q:.4f} ms plain {plain_q:.4f} "
                  f"{bound_text(row_q)}; B5a+B5b {ms_kv + ms_q:.4f} ms ({seven_tflops:.1f} "
                  f"TFLOP/s of the seven products) against the five products' bound "
                  f"{five:.4f} ms and the SDPA backward {lib_bwd:.4f} ms [{card}]", flush=True)
            check(all(e[1] <= TRAIN_TOL[tn] for e in errs.values()),
                  f"train flash {name} {tn}: {errs}")
            check(all(e <= FLASH_BWD_ROW_REL[tn] for e in bwd_rows.values()),
                  f"train flash {name} {tn}: backward row rel errors {bwd_rows} (limit "
                  f"{FLASH_BWD_ROW_REL[tn]})")
            check_flash(f"train {name} {tn}", errs["out"][0], row_rel)
            check(same, f"train flash {name} {tn}: two runs gave other bits")
            rows["flash_lse"].append(row_fwd)
            rows["bwd_kv"].append(row_kv)
            rows["bwd_q"].append(row_q)
            del q, k, v, dout, out, lse, out2, lse2, dq, dk, dv, dq2, dk2, dv2
            del want_out, want_lse, want_dq, want_dk, want_dv
            torch.cuda.empty_cache()

    m = TRAIN_BATCH * TRAIN_SEQ
    for k, n in INT4_SHAPES:
        rows["int4_train"].append(int4_row(torch, card, g, m, k, n, iters=5))
        torch.cuda.empty_cache()
    print_sums(f"B1 at M {m}", rows["int4_train"], card)
    return rows


def train_dataset(path, n: int, seed: int, words, boxes: int = 0):
    """A JSON of n image conversations in DemoTokenizer words: a question of
    words[0]-words[1] words and an answer of words[2]-words[3]. The first
    `boxes` of them ask about a region: "what is in <objs> here?" after the
    question and a "bbox" of TRAIN_BOX (the region extractor's input)."""
    rs = np.random.RandomState(seed)

    def text(lo, hi):
        return " ".join(f"w{x}" for x in rs.randint(0, 5000, rs.randint(lo, hi)))

    items = [{"conversations": [{"from": "human", "value": "<image>\n" + text(*words[:2])},
                                {"from": "gpt", "value": text(*words[2:])}],
              "image": f"img_{i}.png"} for i in range(n)]
    for item in items[:boxes]:
        item["conversations"][0]["value"] += " what is in <objs> here?"
        item["bbox"] = [TRAIN_BOX]
    path.write_text(json.dumps(items))
    return path


def train_media_loader(seed: int, size: int):
    """kind, path -> a random 336x336 image (from seed and the file's index)
    through the port's preprocessing ([size, size, 3] float32)."""
    from vitron_tpu_torch.media.preprocess import preprocess_image

    def load(kind, path):
        i = int(path.rsplit("_", 1)[1].split(".")[0])
        pixels = np.random.RandomState(seed + i).randint(0, 256, (336, 336, 3), np.uint8)
        return preprocess_image(pixels, size)

    return load


def int4_dequant_ms(torch, llm) -> float:
    """Device time, over one training step, of the int4 backward's
    dequantize (`Int4Matmul.backward`: unpack_int4, the scale, the cast to
    bf16, in plain torch: elementwise kernels that a profile counts in "the
    rest"): CUDA events on one layer's seven packed projections, times the
    layer count, and on the lm_head."""
    from vitron_tpu_torch.kernels import int4_matmul as i4

    def ms(q4, s):
        return cuda_ms(torch, lambda: (i4.unpack_int4(q4).to(torch.float32) * s)
                       .to(torch.bfloat16), iters=3, warmup=1)

    layers = llm["layers"]
    per_layer = sum(ms(layers[t]["q4"][0], layers[t]["s"][0])
                    for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"))
    return layers["wq"]["q4"].shape[0] * per_layer + ms(llm["lm_head"]["q4"], llm["lm_head"]["s"])


def train_config():
    """The training phases' model: VitronConfig.serving (Vicuna-7B, packed
    int4 projections and lm_head, flash attention; bf16 ViT-L/14)."""
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig

    return VitronConfig.serving(llm=LlamaConfig.vicuna_7b(
        attn_impl="flash", max_seq_len=TRAIN_SEQ, remat=TRAIN_REMAT))


def train_base(torch) -> dict:
    """`train_config`'s random weights on the card (seed 0) without the video
    tower (image conversations only): phases 19 and 32 share them."""
    from vitron_tpu_torch.models import vitron_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    base = random_int4_llm(torch, vitron_model.init_params(gen, train_config(), dev), gen, dev)
    del base["video_tower"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"train: Vicuna-7B int4 + ViT-L/14 bf16 random weights built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return base


def phase_train(torch, card: str, base):
    """The LoRA trainer at full width: Trainer.fit on `train_config` over
    `base`, LoRA r 128 over the seven targets plus the projector and the
    region extractor, AdamW with warmup-cosine, TRAIN_BATCH rows of
    TRAIN_SEQ, TRAIN_STEPS steps, twice from the same state."""
    import pathlib
    import tempfile

    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.train.data import SupervisedDataset
    from vitron_tpu_torch.train.trainer import TrainConfig, Trainer, make_lora_train_step

    dev = torch.device("cuda")
    cfg = train_config()
    tc = TrainConfig(batch_size=TRAIN_BATCH, pad_len=TRAIN_SEQ, save_steps=10 ** 9)

    class CountingTrainer(Trainer):
        """Records each batch's real and supervised token counts."""

        def _build_batch(self, *a, **kw):
            batch = super()._build_batch(*a, **kw)
            self.tokens.append((int(batch["attn_mask"].sum()),
                                int((batch["labels"] != -100).sum())))
            return batch

    def run(tmp):
        tr = CountingTrainer(cfg, tc, base, str(pathlib.Path(tmp) / "out"),
                             gen=torch.Generator(device=dev).manual_seed(1))
        tr.tokens = []
        proj0 = tr.trainable["projector"]["w2"].detach().clone()
        seen, clock = [], [time.perf_counter()]

        def after_step(step, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            b_max = max(float(ab["b"].detach().abs().max())
                        for ab in tr.trainable["lora"].values())
            moved = not torch.equal(tr.trainable["projector"]["w2"], proj0)
            seen.append((step, loss, now - clock[0], b_max, moved))
            clock[0] = now

        ds = SupervisedDataset(str(train_dataset(pathlib.Path(tmp) / "train.json",
                                                 TRAIN_BATCH * TRAIN_STEPS, 0, TRAIN_WORDS)),
                               DemoTokenizer(), model_max_length=TRAIN_SEQ)
        t_fit = time.perf_counter()
        losses = tr.fit(ds, train_media_loader(100, cfg.image_tower.image_size),
                        total_steps=TRAIN_STEPS, log_every=10 ** 9, callback=after_step)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        return tr, losses, seen, fit_s

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tr, losses, seen, fit_s = run(tmp)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        tokens = tr.tokens
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        tr2, losses2, _, _ = run(tmp)
        step_fn = make_lora_train_step(cfg, tc, tr2.optimizer)
        ds = SupervisedDataset(str(pathlib.Path(tmp) / "train.json"), DemoTokenizer(),
                               model_max_length=TRAIN_SEQ)
        loader = train_media_loader(100, cfg.image_tower.image_size)

        def one_step():
            step_fn(tr2.trainable, base, tr2._build_batch(ds, [0, 1], loader, None))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        profile_breakdown(torch, card, "train: one LoRA step (2 x 2048)", one_step,
                          (time.perf_counter() - t0) * 1e3, TRAIN_KERNEL_GROUPS)
        print(f"train: of the profile's 'the rest', B1's backward dequantize (plain torch "
              f"in Int4Matmul.backward) takes {int4_dequant_ms(torch, base['llm']):.1f} ms a "
              f"step (CUDA events at the step's 225 weight shapes) [{card}]", flush=True)
        del tr2, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    per_step = train_step_launches(cfg.llm)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    step_s = [x[2] for x in seen[1:]]  # steps 2..: the first holds the optimizer's set-up
    mean_s = statistics.mean(step_s)
    tok_s = statistics.mean(t for t, _ in tokens[1:]) / mean_s
    for step, loss, sec, b_max, moved in seen:
        print(f"train: step {step} loss {loss:.6f} {sec:.3f} s, max |lora b| {b_max:.3e}, "
              f"projector moved {moved}", flush=True)
    print(f"train: losses {losses} then {losses2}; launches {launches} (expected {want}: "
          f"{per_step} a step); step {mean_s:.3f} s (steps 2-{TRAIN_STEPS}: "
          f"{', '.join(f'{x:.3f}' for x in step_s)}), {tok_s:.1f} trained tokens/s "
          f"(real tokens a step {[t for t, _ in tokens]}, supervised {[l for _, l in tokens]}),"
          f" fit {fit_s:.1f} s with the final save, peak memory {peak / 2**30:.2f} GiB, "
          f"remat {cfg.llm.remat} [{card}]", flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(losses2)), "training losses not finite")
    check(all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b) for a, b in zip(losses, losses2)),
          f"the same steps twice gave other losses: {losses} vs {losses2}")
    check(seen[0][3] == 0.0 and not seen[0][4],
          "step 1 (learning rate 0 at the warmup's start) moved the LoRA b or the projector")
    check(seen[1][3] > 0.0 and seen[1][4], "step 2 left the LoRA b or the projector unmoved")
    check(all(launches[k] == v for k, v in {"conv3x3_same": 0, **want}.items()),
          f"training launches {launches} != {want}")
    return launches


def phase_train_mesh(torch, card: str, base):
    """Phase 32, the sharded train step at full width: `make_train_step` with
    lora.trainable_filter() over phase 19's tree (no LoRA factors: the
    projector and the region extractor train through the frozen int4 LLM
    and the frozen tower), AdamW after clip_by_global_norm(1.0), on
    TRAIN_BATCH rows of TRAIN_SEQ (the first with a box), TRAIN_MESH_STEPS
    steps without a mesh, then as many from the same start on a one-rank
    NCCL mesh after shard_params(..., VITRON_SHARDING_RULES): every
    collective of the sharded step issued (the fsdp gathers, Megatron's f
    and g, the lm_head's vocab gather, the embedding lookup's all-reduce,
    the supervised count, the gradients, the clip's sums over their axes).
    The losses and every updated projector and region leaf must be
    bit-equal. Then the dry run's train leg on the same group. -> the mesh
    arm's launches."""
    import pathlib
    import tempfile
    import types

    from vitron_tpu_torch.apps import dryrun_multichip as dm
    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.core import distributed as vdist
    from vitron_tpu_torch.core.mesh import create_mesh, gather_params, shard_params
    from vitron_tpu_torch.models.vitron_model import VITRON_SHARDING_RULES
    from vitron_tpu_torch.train import lora
    from vitron_tpu_torch.train import train_step as ts
    from vitron_tpu_torch.train.data import SupervisedDataset
    from vitron_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    cfg = train_config()
    with tempfile.TemporaryDirectory() as tmp:
        ds = SupervisedDataset(str(train_dataset(pathlib.Path(tmp) / "mesh.json", TRAIN_BATCH, 32,
                                                 TRAIN_WORDS, boxes=1)),
                               DemoTokenizer(), model_max_length=TRAIN_SEQ)
        builder = types.SimpleNamespace(model_cfg=cfg, device=dev, train_cfg=TrainConfig(
            batch_size=TRAIN_BATCH, pad_len=TRAIN_SEQ))
        batch = Trainer._build_batch(builder, ds, list(range(TRAIN_BATCH)),
                                     train_media_loader(132, cfg.image_tower.image_size), None)
    trained = ("projector", "region")

    def copy(tree):
        return ts.map_leaves(lambda _, t: t.detach().clone(), tree)

    start = {k: copy(base[k]) for k in trained}

    def fresh():
        return {**base, **{k: copy(start[k]) for k in trained}}

    per_step = train_step_launches(cfg.llm)
    want = {k: v * TRAIN_MESH_STEPS for k, v in per_step.items()}

    def arm(name, tree):
        flt = lora.trainable_filter()
        step = ts.make_train_step(cfg, ts.make_optimizer(ts.set_trainable(tree, flt)), flt)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, secs = [], []
        for _ in range(TRAIN_MESH_STEPS):
            t0 = time.perf_counter()
            losses.append(step(tree, batch))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = expect_launches({"geglu_ff": 0, "group_norm_sums": 0, **want}, f"32 {name}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"32 {name}: losses {[float(x) for x in losses]}, step "
              f"{statistics.median(secs):.3f} s (median of "
              f"{', '.join(f'{x:.3f}' for x in secs)}), peak {peak:.2f} GiB, launches a step "
              f"{per_step} [{card}]", flush=True)
        check(all(np.isfinite(float(x)) for x in losses), f"32 {name}: a loss is not finite")
        return torch.stack(losses), launches, statistics.median(secs), peak

    plain_tree = fresh()
    plain = arm("plain step", plain_tree)
    nccl_group(torch)
    try:
        mesh = create_mesh()
        mesh_tree = shard_params(fresh(), mesh, VITRON_SHARDING_RULES)
        sharded = arm(f"sharded step on the one-rank NCCL mesh {mesh.shape}", mesh_tree)
        moved = dict(ts.named_leaves(gather_params({k: mesh_tree[k] for k in trained})))
        before = dict(ts.named_leaves(start))
        after = dict(ts.named_leaves({k: plain_tree[k] for k in trained}))
        differ = ["/".join(p) for p, t in after.items() if not torch.equal(moved[p], t)]
        still = ["/".join(p) for p, t in after.items() if torch.equal(t, before[p])]
        print(f"32: sharded against plain: losses bit-equal "
              f"{torch.equal(sharded[0], plain[0])}, updated leaves that differ {differ}, "
              f"leaves the plain step left as they were {still}; step {sharded[2]:.3f} s "
              f"against {plain[2]:.3f}, peak {sharded[3]:.2f} GiB against {plain[3]:.2f} "
              f"(+{sharded[3] - plain[3]:.2f}: the gathered int4 copies the backward keeps, "
              f"remat {cfg.llm.remat}) [{card}]", flush=True)
        check(torch.equal(sharded[0], plain[0]),
              f"32: the sharded losses {sharded[0].tolist()} != the plain {plain[0].tolist()}")
        check(not differ, f"32: updated leaves differ from the plain step's: {differ}")
        check(not still, f"32: the plain step left {still} as they were")
        del mesh_tree, moved
        t0 = time.perf_counter()
        with torch.enable_grad():
            dm.leg_train(dev)
        print(f"32: the dry run's train leg on the one-rank NCCL group in "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    finally:
        vdist.shutdown()
    del plain_tree
    gc.collect()
    torch.cuda.empty_cache()
    return sharded[1]


def fan_in_scaled(tower):
    """A random tower with its stacked [L, in, out] matrices rescaled from
    the init's N(0, 1/L) (`dense_init` takes shape[0] as the fan-in, as the
    JAX package does) to N(0, 1/in). At the init's scale the random ViT-L is
    chaotic: float32 rounding in another order moves its features far more
    than rounding, so no two devices could agree downstream of it."""
    def fix(t):
        return t * (t.shape[0] / t.shape[1]) ** 0.5 if t.dim() == 3 else t

    return {**tower, "layers": tree_map(fix, tower["layers"])}


def train_cpu_vs_card_setup(torch):
    """(cfg, params, trainable, train config) of the training CPU-vs-card
    check, built on the CPU from a CPU generator: Vicuna-7B at full width
    cut to 2 layers, float32, zero-mean random int4 projections and lm_head;
    the ViT-L/14 at full depth with fan-in-scaled weights (`fan_in_scaled`);
    float32 LoRA factors with B nonzero (B = 0 would make every dA zero)."""
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.train.lora import init_lora_params
    from vitron_tpu_torch.train.trainer import TrainConfig

    f32, cpu = torch.float32, torch.device("cpu")
    cfg = VitronConfig(
        llm=LlamaConfig.vicuna_7b(num_layers=2, attn_impl="flash", max_seq_len=1024,
                                  param_dtype=f32, compute_dtype=f32),
        image_tower=ViTConfig.clip_vit_l14(), video_tower=ViTConfig.video_vit_l14())
    gen = torch.Generator().manual_seed(11)
    params = random_int4_llm(torch, vitron_model.init_params(gen, cfg, cpu), gen, cpu,
                             zero_mean=True)
    del params["video_tower"]  # image conversations only
    params["image_tower"] = fan_in_scaled(params["image_tower"])
    tc = TrainConfig(batch_size=2, pad_len=512, save_steps=10 ** 9)
    lora = {name: {"a": ab["a"].to(f32), "b": 0.02 * torch.randn(ab["b"].shape, generator=gen)}
            for name, ab in init_lora_params(gen, params["llm"], tc.lora).items()}
    return cfg, params, {"lora": lora, "projector": params["projector"],
                         "region": params["region"]}, tc


def grad_agreement(got, want):
    """(cosine, ||got - want|| / ||want||) of two gradients, in float64."""
    g, w = got.double().flatten(), want.double().flatten()
    norm = w.norm().item()
    cos = (g @ w).item() / max(g.norm().item() * norm, 1e-300)
    return cos, (g - w).norm().item() / max(norm, 1e-300)


def grads_within(got: dict, want: dict, limit=None) -> dict:
    """Each gradient of `want` -> (cosine, relative norm, within `limit`):
    within when the cosine is at least limit["cos"] and the relative norm at
    most limit["rel_norm"] (TRAIN_BF16_GRAD_LIMIT by default)."""
    limit = limit or TRAIN_BF16_GRAD_LIMIT
    out = {}
    for key, w in want.items():
        cos, rel = grad_agreement(got[key], w)
        out[key] = (cos, rel, cos >= limit["cos"] and rel <= limit["rel_norm"])
    return out


def bf16_llm(torch, cfg, params):
    """The training check's state with a bf16 LLM (params and compute, as
    the trainer runs it): every floating leaf of params["llm"] but the int4
    scales in bf16; the tower, projector and region extractor as they were."""
    bf16 = torch.bfloat16
    llm_cfg = dataclasses.replace(cfg.llm, param_dtype=bf16, compute_dtype=bf16)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v, key) for v in tree)
        return tree.to(bf16) if tree.is_floating_point() and key != "s" else tree

    return dataclasses.replace(cfg, llm=llm_cfg), {**params, "llm": cast(params["llm"])}


def lora_step(torch, cfg, tc, params, trainable, ds, device, tmp):
    """One LoRA step's loss, gradients (float32, on the CPU) and kernel
    launches on `device`, from CPU-built state."""
    from vitron_tpu_torch.train.train_step import named_leaves
    from vitron_tpu_torch.train.trainer import Trainer, make_lora_loss

    p = tree_map(lambda a: a.to(device), params)
    tr = Trainer(cfg, tc, p, tmp, trainable=tree_map(lambda a: a.to(device), trainable))
    batch = tr._build_batch(ds, [0, 1], train_media_loader(200, cfg.image_tower.image_size), None)
    check("region_boxes" in batch, "the training check's batch holds no region box")
    reset_launches()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = make_lora_loss(cfg, tc)(tr.trainable, p, batch)
        loss.backward()
    if device.type == "cuda":
        torch.cuda.synchronize()
    grads = {".".join(path): t.grad.float().cpu()
             for path, t in named_leaves(tr.trainable) if t.grad is not None}
    return float(loss.detach()), grads, read_launches(), time.perf_counter() - t0


def phase_train_cpu_vs_card(torch, card: str):
    """One LoRA step's loss and gradients on the CPU and the card, from the
    same CPU-built state (`train_cpu_vs_card_setup`), at pad_len 512, with
    one of the two samples asking about a region box (C10): float32 on both
    sides, every gradient (the region extractor's among them) within
    TRAIN_CPU_GPU_TOL; then the same step with a bf16 LLM (C11), so B1 and
    B2/B5 take their tensor-core paths on the card, against the CPU's plain
    versions in bf16, each gradient within TRAIN_BF16_GRAD_LIMIT."""
    import pathlib
    import tempfile

    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.train.data import SupervisedDataset

    cfg, params, trainable, tc = train_cpu_vs_card_setup(torch)
    cfg16, params16 = bf16_llm(torch, cfg, params)
    want = train_step_launches(cfg.llm)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = SupervisedDataset(str(train_dataset(pathlib.Path(tmp) / "d.json", 2, 1,
                                                 words=(40, 60, 100, 140), boxes=1)),
                               DemoTokenizer(), model_max_length=512)
        for dtype, c, p in (("float32", cfg, params), ("bfloat16", cfg16, params16)):
            for name, device in (("cuda", torch.device("cuda")), ("cpu", torch.device("cpu"))):
                runs[dtype, name] = lora_step(torch, c, tc, p, trainable, ds, device, tmp)
                print(f"train cpu-vs-card: {dtype} {name} loss and gradients "
                      f"{runs[dtype, name][3]:.1f} s", flush=True)
    for dtype in ("float32", "bfloat16"):
        (loss, grads, launches, _), (loss_cpu, grads_cpu, _, _) = (runs[dtype, "cuda"],
                                                                  runs[dtype, "cpu"])
        check(grads.keys() == grads_cpu.keys(), f"{dtype}: the two sides hold other gradients")
        region = sorted(k for k in grads_cpu if k.startswith("region"))
        check(region and all(grads_cpu[k].abs().max() > 0 for k in region),
              f"{dtype}: region extractor gradient absent or zero")
        check(all(launches[k] == v for k, v in want.items()),
              f"{dtype} cpu-vs-card launches {launches} != {want}")
        loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
        if dtype == "float32":
            grad_rel = {k: ((grads[k] - g).abs().max() / g.abs().max()).item()
                        for k, g in grads_cpu.items()}
            worst = max(grad_rel, key=grad_rel.get)
            print(f"train cpu-vs-card: 2-layer full-width float32 LoRA step at pad_len 512, a "
                  f"bbox sample, loss {loss_cpu:.6f} rel_err={loss_rel:.3e} (limit "
                  f"{TRAIN_CPU_GPU_TOL['loss']}), {len(grad_rel)} gradients, worst {worst} "
                  f"rel_err={grad_rel[worst]:.3e}, median "
                  f"{statistics.median(grad_rel.values()):.3e}, region extractor "
                  f"{max(grad_rel[k] for k in region):.3e} over {len(region)} tensors (limit "
                  f"{TRAIN_CPU_GPU_TOL['grad']}); launches {launches} (expected {want}) "
                  f"[{card}]", flush=True)
            check(loss_rel <= TRAIN_CPU_GPU_TOL["loss"], f"training loss CPU vs card: {loss_rel}")
            check(grad_rel[worst] <= TRAIN_CPU_GPU_TOL["grad"],
                  f"gradient {worst}: {grad_rel[worst]}")
        else:
            held = grads_within(grads, grads_cpu)
            worst = min(held, key=lambda k: held[k][0])
            worst_rel = max(held, key=lambda k: held[k][1])
            print(f"train cpu-vs-card: 2-layer full-width bf16 LoRA step (B1 and B2/B5 on the "
                  f"tensor cores) against the CPU's plain versions in bf16, loss "
                  f"{loss_cpu:.6f} rel_err={loss_rel:.3e}, {len(held)} gradients, lowest cosine "
                  f"{worst} {held[worst][0]:.6f}, largest relative norm {worst_rel} "
                  f"{held[worst_rel][1]:.3e}, median cosine "
                  f"{statistics.median(v[0] for v in held.values()):.6f} (limit "
                  f"{TRAIN_BF16_GRAD_LIMIT}); launches {launches} [{card}]", flush=True)
            for key in sorted(held):
                print(f"  bf16 gradient {key}: cosine {held[key][0]:.6f}, relative norm "
                      f"{held[key][1]:.3e}", flush=True)
            bad = [k for k, v in held.items() if not v[2]]
            check(not bad, f"bf16 gradients outside {TRAIN_BF16_GRAD_LIMIT}: {bad}")


# ------------------------------------------------------------ task F

TASK_F_FRAMES = 16
TASK_F_HW = (448, 768)  # LNA's 432x768 raised to the next multiple of 64 (ROADMAP C12)
TASK_F_ATLAS = 256      # NLAAtlasStore's default atlas_res
TASK_F_STEPS = 20  # handle_f edits with the editor's default DDIM steps, as the JAX handler
TASK_F_REPLY = ("<module>F</module><instruction>a red kite with long ribbons</instruction>"
                "<instruction>a snowy mountain valley at dusk</instruction>")
TASK_F_KEYFRAMES = 3


def sd_plan_sites(ucfg, lh: int, lw: int, batch: int, n_ctx: int, part: str):
    """The kernel sites of one SD UNet call ("unet") or ControlNet call
    ("control": the input blocks and the middle) on [batch, lh, lw, C]
    latents, from the block plan: B2 at each attention site whose query and
    key lengths reach VITRON_FLASH_MIN ((B, S, heads, D): self-attention;
    cross-attention's n_ctx keys stay on the einsum path below it), B3
    ((M, C)) in each transformer, B8 ([B, R, C] -> count: twice a ResNet,
    once a transformer, once at the UNet's output)."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min
    from vitron_tpu_torch.models.diffusion.unet2d import block_plan

    fmin = _flash_min()
    flash, geglu, gn = [], [], collections.Counter()
    h, w = lh, lw
    input_plan, middle_plan, output_plan = block_plan(ucfg)
    plan = input_plan + [middle_plan] + (output_plan if part == "unet" else [])
    for entries in plan:
        for e in entries:
            if e[0] == "down":
                h, w = (h + 1) // 2, (w + 1) // 2
            elif e[0] == "up":
                h, w = 2 * h, 2 * w
            elif e[0] == "res":
                gn[(batch, h * w, e[1])] += 1
                gn[(batch, h * w, e[2])] += 1
            elif e[0] == "attn":
                n, ch = h * w, e[1]
                gn[(batch, n, ch)] += 1
                for _ in range(ucfg.transformer_depth):
                    flash += [(batch, n, ucfg.num_heads, ch // ucfg.num_heads)] * (
                        int(n >= fmin) + int(n >= fmin and n_ctx >= fmin))
                    geglu.append((batch * n, ch))
    if part == "unet":
        gn[(batch, lh * lw, ucfg.model_channels)] += 1
    return {"flash": flash, "geglu": geglu, "gn": gn}


def task_f_plan(editor, n_ctx: int):
    """Every kernel site of one task-F request, with its count: the
    foreground's keyframes at TASK_F_HW (the first TASK_F_STEPS DDIM steps
    from noise, no encode; the others min(int(0.9 S), S - 1) + 1 steps after
    a VAE encode), the background at the atlas' size (the same, after an
    encode), each step one CFG ControlNet + UNet call, each edit one VAE
    decode. -> {"flash": Counter, "geglu": Counter, "gn": Counter}."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    ucfg, vcfg = editor.unet_cfg, editor.vae_cfg
    ds = 2 ** (len(vcfg.channel_mult) - 1)
    img_steps = min(int(0.9 * TASK_F_STEPS), TASK_F_STEPS - 1) + 1
    edits = [(TASK_F_HW, TASK_F_STEPS, False)] + [(TASK_F_HW, img_steps, True)] * (
        TASK_F_KEYFRAMES - 1) + [((TASK_F_ATLAS, TASK_F_ATLAS), img_steps, True)]
    out = {"flash": collections.Counter(), "geglu": collections.Counter(),
           "gn": collections.Counter()}
    for (h, w), steps, encode in edits:
        lh, lw = h // ds, w // ds
        for part in ("control", "unet"):
            sites = sd_plan_sites(ucfg, lh, lw, 2, n_ctx, part)
            for k in ("flash", "geglu"):
                for s in sites[k]:
                    out[k][s] += steps
            for s, c in sites["gn"].items():
                out["gn"][s] += steps * c
        vae_flash = [(1, lh * lw, 1, 512)] if lh * lw >= _flash_min() else []
        for s in vae_flash * (1 + int(encode)):
            out["flash"][s] += 1
        out["gn"].update(vae_decode_gn_shapes(vcfg, lh, lw, 1))
        if encode:
            out["gn"].update(vae_encode_gn_shapes(vcfg, h, w, 1))
    return out


def phase_task_f_kernels(torch, card: str, plan) -> dict:
    """Task F's kernels against their plain versions at every distinct shape
    of its request (`task_f_plan`): B2 in bf16 (as `layers._mha` calls it,
    non-causal, shift 0) beside SDPA, B3 and B8 in float32 (the request's
    type) beside `torch.var_mean` for B8. D 160 (the UNet's third level)
    does not reach VITRON_FLASH_MIN at these latents, so it has no row."""
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    rows = {"flash_f": [], "geglu_f": [], "gn_f": []}
    call = dict(causal=False, softmax_shift=0.0)
    for (b, s_len, nh, d), count in sorted(plan["flash"].items()):
        q, k, v = (torch.randn((b, s_len, nh, d), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        got = fa.flash_attention(q, k, v, **call)
        want = fa.flash_attention_plain(q, k, v, **call)
        err, rel = rel_err(got, want)
        row_rel = flash_row_rel(got, want)
        ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v, **call), calls=3)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **call), iters=3)
        flops = 4 * b * nh * s_len * s_len * d
        r = dict(row(err, rel, ms, plain_ms, nbytes(q, k, v, got), flops, "bf16_tensor",
                     sdpa_ms(torch, q, k, v)), b2=f"task F [{b},{s_len},{nh},{d}]")
        print(f"flash_attention task F [{b},{s_len},{nh},{d}] bf16 non-causal shift 0 "
              f"(x{count} a request): abs_err={err:.3e} rel_err={rel:.3e} row_rel_err="
              f"{row_rel:.3e} kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"graph-replayed) plain {plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check_flash(f"task F D={d} S={s_len}", err, row_rel)
        rows["flash_f"].append(r)
        del q, k, v, got, want
    for (m, c), count in sorted(plan["geglu"].items()):
        fh = 4 * c
        args = [torch.randn(s_, generator=g, device=dev) * sc for s_, sc in (
            ((m, c), 1.0), ((c, 2 * fh), c ** -0.5), ((2 * fh,), 0.1), ((fh, c), fh ** -0.5),
            ((c,), 0.1))]
        got, want = gf.geglu_ff(*args), gf.geglu_ff_plain(*args)
        err, rel = rel_err(got, want)
        ms = graph_ms(torch, lambda: gf.geglu_ff(*args), calls=3)
        plain_ms = cuda_ms(torch, lambda: gf.geglu_ff_plain(*args), iters=3)
        flops = 6 * m * c * fh
        r = row(err, rel, ms, plain_ms, nbytes(*args, got), flops, "fp32")
        print(f"geglu_ff task F M={m} C={c} F={fh} float32 (x{count} a request): rel_err="
              f"{rel:.3e} kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"graph-replayed) plain {plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check(rel <= GEGLU_TOL["float32"], f"geglu_ff task F M={m} C={c} rel err {rel}")
        rows["geglu_f"].append(r)
        del args, got, want
    for shape, count in sorted(plan["gn"].items()):
        x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        got, again, want = gn.group_norm_sums(x), gn.group_norm_sums(x), gn.group_norm_sums_plain(x)
        err, rel = rel_err(got, want)
        ms = graph_ms(torch, lambda: gn.group_norm_sums(x), calls=5)
        plain_ms = cuda_ms(torch, lambda: gn.group_norm_sums_plain(x), iters=3, warmup=1)
        lib_ms = graph_ms(torch, lambda: torch.var_mean(x, dim=1, correction=0), calls=5)
        r = row(err, rel, ms, plain_ms, nbytes(x, got), 3 * x.numel(), "fp32", lib_ms)
        print(f"group_norm_sums task F {list(shape)} float32 (x{count} a request): rel_err="
              f"{rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms, same bits twice="
              f"{bool(torch.equal(got, again))} {bound_text(r)} (kernel and library "
              f"graph-replayed) [{card}]", flush=True)
        check(rel <= GN_TOL and bool(torch.equal(got, again)),
              f"group_norm_sums task F {list(shape)}: rel err {rel} or not deterministic")
        rows["gn_f"].append(r)
        del x, got, again, want
    for what, key in (("B2", "flash_f"), ("B3", "geglu_f"), ("B8", "gn_f")):
        print_sums(f"task F {what}", rows[key], card)
    return rows


def build_task_f(torch, device, seed: int):
    """Task F's editor at full width, float32, random weights with every zero
    leaf filled: the SD v1.5 UNet (no grounding), a canny and a depth
    ControlNet (lllyasviel/ControlNet control_sd15_canny / control_sd15_depth
    geometry), DPT-hybrid (MiDaS v3), the SD VAE and CLIP-L text; and random
    IMLP nets at the released NLA geometries (`assembly.nla_imlp_cfgs`). -> (the
    editor, the IMLP nets)."""
    from vitron_tpu_torch.models.diffusion import clip_text, controlnet, depth, unet2d, vae
    from vitron_tpu_torch.models.diffusion import stablevideo as sv
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
    from vitron_tpu_torch.runtime.assembly import nla_imlp_cfgs

    g = torch.Generator(device=device).manual_seed(seed)
    ucfg, vcfg = unet2d.UNetConfig.sd_v1(), vae.VAEConfig.sd()
    tcfg, dcfg = clip_text.TextConfig.clip_l(), depth.DPTConfig.dpt_hybrid()
    unet = fill_zero_leaves(unet2d.init_params(g, ucfg, device, grounding=False), g)
    canny = fill_zero_leaves(controlnet.init_params(g, ucfg, device), g)
    depth_ctrl = fill_zero_leaves(controlnet.init_params(g, ucfg, device), g)
    vae_p = fill_zero_leaves(vae.init_params(g, vcfg, device), g)
    text = fill_zero_leaves(clip_text.init_params(g, tcfg, device), g)
    dpt = fill_zero_leaves(depth.init_params(g, dcfg, device), g)
    editor = sv.StableVideoEditor(ucfg, unet, canny, vcfg, vae_p, tcfg, text,
                                  tokenizer=StubClipTokenizer(tcfg.vocab_size),
                                  depth_control_params=depth_ctrl, depth_annotator=(dpt, dcfg))
    nets = {k: sv.imlp_init(g, c, device) for k, c in nla_imlp_cfgs().items()}
    return editor, nets


def atlas_bundle(torch, nets: dict) -> dict:
    """The synthetic atlas bundle task F renders from: `nets` (the IMLP nets,
    on the card) evaluated for TASK_F_FRAMES frames at TASK_F_HW, the
    atlases on a TASK_F_ATLAS grid."""
    from vitron_tpu_torch.models.diffusion import stablevideo as sv
    from vitron_tpu_torch.runtime.assembly import nla_imlp_cfgs

    geoms = nla_imlp_cfgs()
    fg_uv, bg_uv, alpha = sv.atlas_uvs(nets["fg"], nets["bg"], nets["alpha"], geoms,
                                       TASK_F_FRAMES, *TASK_F_HW)
    r = torch.linspace(-1, 1, TASK_F_ATLAS, device=nets["atlas"]["layers"][0]["w"].device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    colors = torch.clamp(0.5 * (sv.imlp_forward(nets["atlas"], geoms["atlas"],
                                                torch.stack([gx, gy], -1)) + 1.0), 0, 1)
    return {"fg_atlas": colors.cpu().numpy(), "bg_atlas": colors.cpu().numpy(),
            "fg_uv": fg_uv.cpu().numpy(), "bg_uv": bg_uv.cpu().numpy(),
            "alpha": alpha.cpu().numpy()}


def phase_task_f(torch, card: str, editor, bundle):
    """Phase 15c: one routed task-F request at full width (float32, as the
    JAX default): TASK_F_KEYFRAMES keyframes, TASK_F_STEPS DDIM steps,
    guidance 9, a fore and a back prompt, the background through the depth
    ControlNet and DPT-hybrid; 16 uint8 frames; B2, B3 and B8 launches held
    to `task_f_plan`'s counts; request seconds, ms a CFG ControlNet + UNet
    call at the keyframes' latents, peak memory."""
    from vitron_tpu_torch.models.diffusion import clip_text, controlnet
    from vitron_tpu_torch.runtime.system import VitronSystem

    dev = torch.device("cuda")
    system = VitronSystem(None)
    system.register_video_editor(editor, atlas_provider=lambda video, extra: bundle,
                                 num_keyframes=TASK_F_KEYFRAMES)
    plan = task_f_plan(editor, editor.text_cfg.max_length)
    want = {"flash_attention": sum(plan["flash"].values()),
            "geglu_ff": sum(plan["geglu"].values()),
            "group_norm_sums": sum(plan["gn"].values())}
    video = np.zeros((TASK_F_FRAMES,) + TASK_F_HW + (3,), np.uint8)
    torch.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, t_req = timed_route(torch, system, TASK_F_REPLY, video=video)
    launches = expect_launches(want, "task F")
    peak = torch.cuda.max_memory_allocated()
    check(out["status"] == "ok" and out["task"] == "video_editing",
          f"task F: status {out['status']}, task {out.get('task')}")
    frames = out["video"]
    check(frames.shape == (TASK_F_FRAMES,) + TASK_F_HW + (3,) and frames.dtype == np.uint8,
          f"task F frames {frames.shape} {frames.dtype}")
    check(int(frames.max()) != int(frames.min()), "task F: the frames are constant")
    ds = 8
    lh, lw = TASK_F_HW[0] // ds, TASK_F_HW[1] // ds
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((2, lh, lw, 4), generator=g, device=dev)
    hint = torch.rand((2,) + TASK_F_HW + (3,), generator=g, device=dev)
    ids = torch.as_tensor(editor.tokenizer(["a", ""], max_length=editor.text_cfg.max_length)
                          ["input_ids"], device=dev)
    ctx = clip_text.encode(editor.text_params, editor.text_cfg, ids)
    t = torch.full((2,), 501, device=dev)

    def cfg_call():
        ctrl = controlnet.control_residuals(editor.control_params, editor.unet_cfg, x, hint, t,
                                            ctx)
        return controlnet.controlled_forward(editor.unet_params, editor.unet_cfg, x, t, ctx, ctrl)

    call_ms = cuda_ms(torch, cfg_call, iters=5, warmup=1)
    # the request's other parts, each timed alone at its request shapes
    from vitron_tpu_torch.models.diffusion import stablevideo as sv
    from vitron_tpu_torch.models.diffusion import vae

    img = torch.rand((1,) + TASK_F_HW + (3,), generator=g, device=dev) * 2 - 1
    parts = {"VAE encode": cuda_ms(torch, lambda: vae.encode(editor.vae_params,
                                                             editor.vae_cfg, img), iters=3),
             "VAE decode": cuda_ms(torch, lambda: vae.decode(editor.vae_params,
                                                             editor.vae_cfg, x[:1]), iters=3)}
    atlas_u8 = (np.asarray(bundle["bg_atlas"]) * 255).astype(np.uint8)
    kf = np.random.RandomState(14).rand(*TASK_F_HW, 3).astype(np.float32)
    for name, fn in (("DPT-hybrid hint", lambda: sv.depth_hint(*editor.depth_annotator,
                                                               atlas_u8)),
                     ("canny hint (host)", lambda: sv.canny_hint((kf * 255).astype(np.uint8))),
                     ("griddata scatter (host)", lambda: sv.scatter_to_atlas(
                         kf, bundle["fg_uv"][0], (TASK_F_ATLAS, TASK_F_ATLAS)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t0) * 1e3
    print("task F parts, ms each: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f" (a request: {TASK_F_KEYFRAMES} scatters and canny hints, "
          f"{TASK_F_KEYFRAMES} decodes and {TASK_F_KEYFRAMES - 1} encodes at this size, one "
          f"decode and one encode at the atlas', one DPT hint) "
          f"[{card}]", flush=True)
    calls = TASK_F_STEPS + (TASK_F_KEYFRAMES - 1) * (min(int(0.9 * TASK_F_STEPS),
                                                         TASK_F_STEPS - 1) + 1)
    print(f"task F: request {t_req:.3f} s ({TASK_F_FRAMES} frames of {TASK_F_HW[0]}x"
          f"{TASK_F_HW[1]}, {TASK_F_KEYFRAMES} keyframes, {TASK_F_STEPS} DDIM steps; "
          f"{calls} CFG ControlNet + UNet calls at {lh}x{lw} latents, {call_ms:.2f} ms each = "
          f"{calls * call_ms / 1e3:.3f} s, the background's at 32x32 and the rest "
          f"{t_req - calls * call_ms / 1e3:.3f} s), frames mean {frames.mean():.2f} std "
          f"{frames.std():.2f}, peak memory {peak / 2**30:.2f} GiB [{card}]", flush=True)
    return launches


def phase_controlnet_cpu_vs_card(torch, card: str):
    """One CFG-batch ControlNet + controlled UNet call on the CPU and on the
    card, float32, at the real widths (320 channels, 8 heads, 768-wide
    context) but one level and 32x32 latents (1,024 tokens: the card's
    self-attention takes B2), with flash and with einsum attention."""
    from vitron_tpu_torch.models.diffusion import controlnet, unet2d
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = unet2d.UNetConfig.sd_v1(channel_mult=(1,), num_res_blocks=1, attention_resolutions=(1,))
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    g = torch.Generator().manual_seed(13)
    unet = fill_zero_leaves(unet2d.init_params(g, cfg, cpu, grounding=False), g)
    ctrl = fill_zero_leaves(controlnet.init_params(g, cfg, cpu), g)
    x = torch.randn((2, 32, 32, 4), generator=g)
    hint = torch.rand((2, 256, 256, 3), generator=g)
    t = torch.full((2,), 501)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)

    def call(u, c, *a):
        return controlnet.controlled_forward(u, cfg, a[0], a[2], a[3], controlnet.control_residuals(
            c, cfg, *a))

    want = call(unet, ctrl, x, hint, t, ctx)
    u_dev, c_dev = tree_map(lambda a: a.to(dev), unet), tree_map(lambda a: a.to(dev), ctrl)
    args = [a.to(dev) for a in (x, hint, t, ctx)]
    for name, env in (("flash", {}), ("einsum", {"VITRON_FLASH_MIN": str(1 << 30)})):
        with mock.patch.dict(os.environ, env):
            reset_launches()
            got = call(u_dev, c_dev, *args).cpu()
            n_flash = read_launches()["flash_attention"]
        rel = (got - want).abs().max().item() / want.abs().max().item()
        expect_n = sum(len(sd_plan_sites(cfg, 32, 32, 2, 77, part)["flash"])
                       for part in ("control", "unet")) if name == "flash" else 0
        print(f"controlnet cpu-vs-card ({name} attention on the card, {n_flash} flash "
              f"launches): rel_err={rel:.3e} (limit {UNET_CPU_GPU_TOL[name]}) [{card}]",
              flush=True)
        check(n_flash == expect_n, f"controlnet cpu-vs-card: {n_flash} flash launches, "
              f"expected {expect_n}")
        check(rel <= UNET_CPU_GPU_TOL[name], f"controlnet CPU and card disagree ({name}): {rel}")


# ---------------------------------------------------------------- A9 / A10 remainders
STYLE_REPLY_PROMPT = "a vase of flowers and a cup on a wooden table"
STYLE_BOXES = [[0.1, 0.2, 0.55, 0.9], [0.6, 0.5, 0.9, 0.85]]
STYLE_PHRASES = ["a vase of flowers", "a cup"]
SAMPLER_STEPS = 10
HINT_HW = (480, 640)     # a hint map of a 480x640 frame: a real nearest resize to 448
HINT_RESIZE = 448        # GLIGEN's hint PositionNet input (resize_input)
SEM_CLASSES = 150        # a one-hot semantic map over ADE20K's 150 classes
KEYPOINT_PERSONS = 8     # the keypoint PositionNet's max_persons_per_image
SEEM_SIZE = 512          # SEEM's served input


def exact_launches(want: dict) -> dict:
    """`want` with every other kernel's count 0: a path's exact launches."""
    return {name: want.get(name, 0) for name, _, _ in _counters()}


def phase_style(torch, card: str, pipe):
    """(a) GLIGEN's text + image grounded (style) request at full width:
    task A's resident SD v1.4 UNet with its position net swapped for the
    with-image one (30 slots -> 60 grounding tokens), the SD VAE, CLIP-L
    text, and the CLIP ViT-L/14 tower pooled at 224 with a [1024, 768]
    visual projection and GLIGEN's [768, 768] projection matrix, float32;
    512x512, 50 PLMS steps, guidance 7.5, one style crop; twice, identical,
    non-constant; B2, B3, B8 held to the block plan's exact counts (the
    fuser attends over 4096 + 60 and 1024 + 60 tokens); the style feature's
    norm 28.7."""
    from vitron_tpu_torch.media.preprocess import preprocess_image
    from vitron_tpu_torch.models.diffusion import unet2d
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenStylePipeline
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
    from vitron_tpu_torch.models.vision import vit

    cfg = pipe.cfg
    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(21)
    vcfg = vit.ViTConfig.clip_vit_l14()
    cd = cfg.unet.context_dim
    unet = {**pipe.unet_params, "position_net": fill_zero_leaves(
        unet2d.init_position_net_with_image(g, cfg.unet, dev), g)}
    style_pipe = GligenStylePipeline(
        cfg, unet, pipe.vae_params, pipe.text_params,
        vision_params=fill_zero_leaves(vit.init_params(g, vcfg, dev), g), vision_cfg=vcfg,
        visual_proj=torch.randn((vcfg.hidden_size, cd), generator=g, device=dev)
        / vcfg.hidden_size ** 0.5,
        projection_matrix=torch.randn((cd, cd), generator=g, device=dev) / cd ** 0.5,
        tokenizer=pipe.tokenizer)
    crop = np.random.RandomState(22).randint(0, 256, (300, 260, 3), np.uint8)
    style = preprocess_image(crop)[None]  # [1, 224, 224, 3], CLIP-normalized
    n_objs = 2 * cfg.max_objs
    unet_n = unet_counts(cfg.unet, cfg.latent_size, n_objs, cfg.text.max_length)
    _, dec = vae_counts(cfg.vae, cfg.latent_size ** 2)
    calls = cfg.steps + 1
    want = exact_launches({k: calls * unet_n[k] + dec[k] for k in unet_n})
    total = collections.Counter()
    runs = []
    for i in range(2):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = style_pipe.generate_styled(STYLE_REPLY_PROMPT, STYLE_BOXES, STYLE_PHRASES, style,
                                         gen=torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        t_req = time.perf_counter() - t0
        total.update(expect_launches(want, f"style run {i + 1}"))
        img = img.cpu().numpy()
        check(img.shape == (cfg.image_size, cfg.image_size, 3) and img.dtype == np.uint8,
              f"style image {img.shape} {img.dtype}")
        runs.append(img)
        print(f"style run {i + 1}: request {t_req:.3f} s ({calls} CFG UNet calls over "
              f"{n_objs} grounding tokens, ViT-L/14 pooled style features), image mean "
              f"{img.mean():.2f} std {img.std():.2f} [{card}]", flush=True)
    check(np.array_equal(runs[0], runs[1]), "style: two identical requests gave other images")
    check(int(runs[0].max()) != int(runs[0].min()), "style: the image is constant")
    feats = style_pipe.image_features(style.to(dev))
    norm = torch.linalg.vector_norm(feats, dim=-1).item()
    check(abs(norm - 28.7) <= 1e-3, f"style: image feature norm {norm}, not 28.7")
    return dict(total)


def phase_samplers(torch, card: str, pipe):
    """(b) eps DDIM (eta 0; eta 1 with its noise from a generator; eta 0 with
    the inpainting composite over a keep mask) and DPM-Solver++(2M),
    SAMPLER_STEPS steps each, over task A's CFG eps (one batched UNet call a
    step) at 64x64 latents: finite latents, each run held to its exact
    launches; ms a step."""
    from vitron_tpu_torch.models.diffusion import clip_text, samplers

    cfg = pipe.cfg
    dev = pipe.device
    inputs = pipe.prepare("a red car on a street", [[0.1, 0.2, 0.6, 0.8]],
                          ["a red car on a street"])
    ctx = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_ctx"])
    uc = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_uc"])
    gt = pipe.pooled_text_features(inputs["phrase_ids"])[None] * inputs["gm"][..., None]
    eps = pipe._eps_fn(inputs["params"], ctx, uc, inputs["gb"], inputs["gm"], gt, 7.5)
    sched = samplers.DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)
    gates = samplers.alpha_generator(SAMPLER_STEPS, (0.3, 0.0, 0.7))
    g = torch.Generator(device=dev).manual_seed(23)
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.unet.out_channels)
    x_t = torch.randn(shape, generator=g, device=dev)
    keep = torch.ones(shape[:-1] + (1,), device=dev)
    keep[:, 16:48, 16:48] = 0
    x0 = torch.randn(shape, generator=g, device=dev)
    per = unet_counts(cfg.unet, cfg.latent_size, cfg.max_objs, cfg.text.max_length)
    want = exact_launches({k: SAMPLER_STEPS * v for k, v in per.items()})
    runs = {
        "ddim eta 0": lambda: samplers.ddim_sample(eps, x_t, sched, SAMPLER_STEPS,
                                                   gate_alphas=gates),
        "ddim eta 1": lambda: samplers.ddim_sample(
            eps, x_t, sched, SAMPLER_STEPS, eta=1.0, gate_alphas=gates,
            gen=torch.Generator(device=dev).manual_seed(24)),
        "ddim mask_blend": lambda: samplers.ddim_sample(
            eps, x_t, sched, SAMPLER_STEPS, gate_alphas=gates, mask_blend=(keep, x0),
            gen=torch.Generator(device=dev).manual_seed(25)),
        "dpm-solver++(2m)": lambda: samplers.dpm_solver_pp_2m(eps, x_t, sched, SAMPLER_STEPS,
                                                              gate_alphas=gates),
    }
    total = collections.Counter()
    for name, run in runs.items():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total.update(expect_launches(want, f"sampler {name}"))
        check(bool(torch.isfinite(x).all()) and x.shape == shape, f"sampler {name}: non-finite "
              f"or misshapen latent {tuple(x.shape)}")
        if name == "ddim mask_blend":  # the last composite keeps x0's re-noised content
            check(float(x.std()) > 0, "sampler mask_blend: constant latent")
        print(f"sampler {name}: {SAMPLER_STEPS} steps over the CFG GLIGEN UNet at "
              f"{cfg.latent_size}x{cfg.latent_size} latents, {dt * 1e3 / SAMPLER_STEPS:.2f} ms a "
              f"step, latent std {x.std().item():.4f} [{card}]", flush=True)
    return dict(total)


def build_grounding(torch, device, seed: int):
    """GLIGEN's grounding nets at their published widths (ConvNeXt-T,
    resize_input 448, 768-wide tokens), random weights with every zero leaf
    filled and the layerscale gammas from U(0.5, 1.5) (at 1e-6 a block's
    output, B4's among it, would not reach the tokens): the canny / depth /
    hed / normal hint net, the sem one over SEM_CLASSES channels, the
    keypoint net and the canny and sem downsamplers (two 4x4 stride-2
    convs to 8 channels)."""
    from vitron_tpu_torch.models.diffusion import grounding_nets as gn
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    g = torch.Generator(device=device).manual_seed(seed)

    def live(tree):
        tree = fill_zero_leaves(tree, g)
        for stage in tree.get("convnext", {}).get("stages", []):
            for blk in stage:
                blk["gamma"] = 0.5 + torch.rand(blk["gamma"].shape, generator=g, device=device)
        return tree

    def down(cin):
        return {"conv1_w": torch.randn((4, 4, cin, 4), generator=g, device=device) / (16 * cin) ** 0.5,
                "conv1_b": 0.1 * torch.randn((4,), generator=g, device=device),
                "conv2_w": torch.randn((4, 4, 4, 8), generator=g, device=device) / 8,
                "conv2_b": 0.1 * torch.randn((8,), generator=g, device=device)}

    return {"hint": live(gn.init_hint_position_net(g, device, HINT_RESIZE)),
            "sem": live(gn.init_hint_position_net(g, device, HINT_RESIZE, in_dim=SEM_CLASSES)),
            "keypoint": live(gn.init_keypoint_position_net(g, device, KEYPOINT_PERSONS)),
            "canny_down": down(1), "sem_down": down(SEM_CLASSES)}


def grounding_inputs(torch, device, seed: int):
    """A 480x640 edge-like hint (RGB in [0, 1]), a one-hot semantic map of
    the same size, KEYPOINT_PERSONS persons' keypoints (a third masked)."""
    rs = np.random.RandomState(seed)
    hint = (rs.rand(1, *HINT_HW, 1) > 0.9).astype(np.float32).repeat(3, axis=-1)
    labels = rs.randint(0, SEM_CLASSES, (1, HINT_HW[0] // 40, HINT_HW[1] // 40))
    labels = labels.repeat(40, axis=1).repeat(40, axis=2)
    sem = np.eye(SEM_CLASSES, dtype=np.float32)[labels]
    points = rs.rand(1, KEYPOINT_PERSONS * 17, 2).astype(np.float32)
    pmask = (rs.rand(1, KEYPOINT_PERSONS * 17) > 0.33).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("hint", hint), ("sem", sem), ("points", points), ("pmask", pmask))}


def phase_grounding(torch, card: str):
    """(c) the grounding nets at full width on the card, float32, each first
    through its checkpoint converter (phase 26 (e)): the hint net (canny
    form, then sem form with its in_conv) on a 480x640 map resized (nearest)
    to 448, each twice (identical, finite, 196 x 768 tokens, 18 B4 launches
    a forward, exact); the keypoint net at 8 persons; the canny and sem
    downsamplers at 256 and the hed resize to 64."""
    from vitron_tpu_torch.models.diffusion import grounding_nets as gn

    dev = torch.device("cuda")
    nets = grounding_conversions(torch, card, build_grounding(torch, dev, seed=26))
    x = grounding_inputs(torch, dev, seed=27)
    ones = torch.ones((1,), device=dev)
    per = exact_launches({"depthwise_conv2d": sum(gn.CONVNEXT_TINY_DEPTHS)})
    total = collections.Counter()
    for name, hint in (("hint", x["hint"]), ("sem", x["sem"])):
        outs = []
        for i in range(2):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gn.position_net_hint(nets[name], hint, ones, resize_input=HINT_RESIZE)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            total.update(expect_launches(per, f"grounding {name} net run {i + 1}"))
            outs.append(out)
        check(tuple(out.shape) == (1, (HINT_RESIZE // 32) ** 2, 768)
              and bool(torch.isfinite(out).all()) and out.std().item() > 0,
              f"grounding {name} net: tokens {tuple(out.shape)}")
        check(torch.equal(outs[0], outs[1]), f"grounding {name} net: two runs differ")
        print(f"grounding {name} net ({HINT_HW[0]}x{HINT_HW[1]} -> {HINT_RESIZE} nearest, "
              f"ConvNeXt-T): {dt * 1e3:.2f} ms, tokens {tuple(out.shape)} std "
              f"{out.std().item():.4f} [{card}]", flush=True)
    reset_launches()
    kp = gn.position_net_keypoint(nets["keypoint"], x["points"], x["pmask"])
    canny = gn.grounding_downsampler(nets["canny_down"], x["hint"], 256, grayscale=True)
    sem = gn.grounding_downsampler(nets["sem_down"], x["sem"], 256, mode="nearest")
    hed = gn.grounding_downsampler_hed(x["hint"])
    total.update(expect_launches(exact_launches({}), "keypoint net and downsamplers"))
    for what, t, shape in (("keypoint", kp, (1, KEYPOINT_PERSONS * 17, 768)),
                           ("canny downsampler", canny, (1, 64, 64, 8)),
                           ("sem downsampler", sem, (1, 64, 64, 8)), ("hed", hed, (1, 64, 64, 1))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()) and t.std().item() > 0,
              f"grounding {what}: {tuple(t.shape)}, expected {shape}")
    print(f"grounding: keypoint tokens {tuple(kp.shape)}, canny / sem downsampled "
          f"{tuple(canny.shape)} / {tuple(sem.shape)}, hed {tuple(hed.shape)} [{card}]",
          flush=True)
    return dict(total)


def seem_backbone_configs():
    """(name, module, config) of the SEEM backbones at their published sizes."""
    from vitron_tpu_torch.models.seem import davit, resnet, swin

    return [("swin-l", swin, swin.SwinConfig.swin_l()), ("davit-t", davit, davit.DaViTConfig()),
            ("resnet-50", resnet, resnet.ResNetConfig.resnet50()),
            ("resnet-101", resnet, resnet.ResNetConfig.resnet101())]


def phase_seem_backbones(torch, card: str):
    """(d) SEEM's other backbones at SEEM's 512x512 input, random weights,
    float32 and then cast to bf16 (SEEM's serving cast of the backbone and
    pixel decoder): Swin-L followed by `DeformDecoderConfig()` on its four
    maps (5 B8 launches, the deformable attention a torch gather), DaViT-T
    (24 B4 launches: four 3x3 depthwise convs a block), ResNet-50 and -101
    (no kernel). Each run twice in each type, identical (the second timed);
    every map finite; launches exact. The bf16 maps' distance from the float32 ones is
    printed: with random weights it measures the nets' growth, not a fault."""
    from vitron_tpu_torch.models.seem import deform_decoder as dd
    from vitron_tpu_torch.models.seem.model import _cast

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(28)
    img = torch.from_numpy(np.random.RandomState(29).randn(1, SEEM_SIZE, SEEM_SIZE, 3)
                           .astype(np.float32)).to(dev)
    total = collections.Counter()
    dcfg = dd.DeformDecoderConfig()
    dparams = dd.init_params(g, dcfg, dev)
    for name, mod, cfg in seem_backbone_configs():
        params = mod.init_params(g, cfg, dev)
        per = {}
        if name == "davit-t":
            per = {"depthwise_conv2d": 4 * sum(cfg.depths)}
        elif name == "swin-l":  # each input projection's norm, two a lower FPN level
            ntl = dcfg.num_transformer_levels
            per = {"group_norm_sums": ntl + 2 * (len(dcfg.in_channels) - ntl)}

        def run(p, x, dp):
            feats = mod.forward(p, cfg, x)
            if name == "swin-l":
                mask, ms = dd.forward_features(dp, dcfg, feats)
                feats = feats + [mask] + ms
            return feats

        results = {}
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[-1]
            p, dp = (params, dparams) if dtype == torch.float32 else (_cast(params, dtype),
                                                                       _cast(dparams, dtype))
            x = img.to(dtype)
            outs = []
            for i in range(2):  # the second run's time: the first tunes cuDNN's bf16 convs
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(run(p, x, dp))
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                total.update(expect_launches(exact_launches(per), f"{name} {tname} run {i + 1}"))
            check(all(bool(torch.isfinite(o.float()).all()) for o in outs[-1]),
                  f"{name} {tname}: non-finite maps")
            check(all(torch.equal(a, b) for a, b in zip(*outs)), f"{name} {tname}: two runs "
                  f"differ")
            results[tname] = outs[-1]
            print(f"{name} {tname} at {SEEM_SIZE}x{SEEM_SIZE}"
                  f"{' + deformable pixel decoder' if name == 'swin-l' else ''}: "
                  f"{dt * 1e3:.2f} ms, maps {[tuple(o.shape[1:]) for o in outs[-1]]} [{card}]",
                  flush=True)
        rel = max((b.float() - a).abs().max().item() / a.abs().max().item()
                  for a, b in zip(results["float32"], results["bfloat16"]))
        print(f"{name}: bf16 maps against float32, max |bf16 - f32| / max |f32| {rel:.3e} "
              f"(reported, not held: random weights) [{card}]", flush=True)
        del params
    torch.cuda.empty_cache()
    return dict(total)


def phase_new_dw(torch, card: str):
    """(e) B4 against its plain version at ConvNeXt-T's and DaViT-T's sites
    (NEW_DW_SITES), float32 and bf16, as `phase_seem_kernels` holds it at
    FocalNet-L's: within DW_TOL, PIXEL_REL of each pixel, the same bits twice."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(30)
    rows = {"dw_new": []}
    for shape, k in NEW_DW_SITES:
        x32 = torch.randn(shape, generator=g, device=dev)
        w32 = torch.randn((k, k, shape[-1]), generator=g, device=dev) / k
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            r = dw_row(torch, card, x32, w32, dtype)
            check(r["rel"] <= DW_TOL[name] and r["pixel_rel"] <= PIXEL_REL[name] and r["same"],
                  f"depthwise_conv2d {shape} k={k} {name}: rel err {r['rel']}, pixel rel err "
                  f"{r['pixel_rel']}, same bits twice {r['same']}")
            rows["dw_new"].append(r)
    print_sums("B4 at ConvNeXt-T's 7x7 sites", rows["dw_new"][:8], card)
    print_sums("B4 at DaViT-T's 3x3 sites", rows["dw_new"][8:], card)
    return rows


def phase_a9_a10_cpu_vs_card(torch, card: str):
    """(f) the CPU's plain versions against the card, float32: the hint net
    (ConvNeXt-T at full width, resize_input 224 from a 300x260 map), Swin-L
    at depth 1 a stage with the deformable decoder (2 layers) on 192x192, and
    DaViT-T at depth 1 a stage on 128x128; max |card - cpu| / max |cpu|
    within CPU_GPU_TOL."""
    from vitron_tpu_torch.models.diffusion import grounding_nets as gn
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
    from vitron_tpu_torch.models.seem import davit, deform_decoder as dd, swin

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    g = torch.Generator().manual_seed(31)
    rs = np.random.RandomState(32)
    hint_p = fill_zero_leaves(gn.init_hint_position_net(g, cpu, 224), g)
    for stage in hint_p["convnext"]["stages"]:
        for blk in stage:
            blk["gamma"] = 0.5 + torch.rand(blk["gamma"].shape, generator=g)
    scfg = swin.SwinConfig.swin_l(depths=(1, 1, 1, 1))
    dcfg = dd.DeformDecoderConfig(num_layers=2)
    acfg = davit.DaViTConfig(depths=(1, 1, 1, 1))
    cases = {
        "hint net": (lambda p, x: [gn.position_net_hint(p, x[0], x[1], resize_input=224)],
                     hint_p, (torch.from_numpy(rs.rand(1, 300, 260, 3).astype(np.float32)),
                              torch.ones((1,)))),
        "swin-l + deform decoder": (
            lambda p, x: (lambda f: f + [dd.forward_features(p[1], dcfg, f)[0]])(
                swin.forward(p[0], scfg, x[0])),
            (fill_zero_leaves(swin.init_params(g, scfg, cpu), g),
             fill_zero_leaves(dd.init_params(g, dcfg, cpu), g)),
            (torch.from_numpy(rs.randn(1, 192, 192, 3).astype(np.float32)),)),
        "davit-t": (lambda p, x: davit.forward(p, acfg, x[0]),
                    fill_zero_leaves(davit.init_params(g, acfg, cpu), g),
                    (torch.from_numpy(rs.randn(1, 128, 128, 3).astype(np.float32)),)),
    }
    for name, (fn, params, args) in cases.items():
        want = fn(params, args)
        got = fn(tree_map(lambda a: a.to(dev), params), [a.to(dev) for a in args])
        rel = max((b.cpu() - a).abs().max().item() / a.abs().max().item()
                  for a, b in zip(want, got))
        print(f"a9/a10 cpu-vs-card: {name} rel_err={rel:.3e} (limit {CPU_GPU_TOL}) [{card}]",
              flush=True)
        check(rel <= CPU_GPU_TOL, f"{name}: CPU and card disagree: rel {rel}")


# ------------------------------------------------ the diffusion trainers (A15b)

GLIGEN_TRAIN_STEPS = 4
GLIGEN_TRAIN_BOXES = (3, 5)      # valid grounding boxes of each row (of max_objs 30)
GLIGEN_TRAIN_PROMPTS = ("a red car on a street next to a tree", "a dog and a cat on a sofa")
VIDEO_TRAIN_FRAMES = 16
VIDEO_TRAIN_LATENT = 32          # 256x256 frames over the SD VAE's factor 8
VIDEO_TRAIN_STEPS = 3
VIDEO_TRAIN_PROMPT = "a red car driving along a coastal road at sunset"
# B2 with its LSE, B5a and B5b at the SD UNet's head dims, bf16, non-causal,
# shift 0 (as `layers._mha` calls them): (what, B, S = T, N, D), the GLIGEN
# step's self-attention and fuser sites at 64x64 and 32x32 latents (4,096 /
# 1,024 pixels + 30 grounding tokens), and D 160 (no path at 512^2 runs it)
DIFFUSION_BWD_SHAPES = (
    ("gligen self 64x64", 2, 4096, 8, 40),
    ("gligen fuser 64x64", 2, 4126, 8, 40),
    ("gligen self 32x32", 2, 1024, 8, 80),
    ("gligen fuser 32x32", 2, 1054, 8, 80),
    ("d160", 2, 1024, 8, 160),
)
# each new autograd.Function on the card against the CPU's autograd of the
# plain version, float32: max |card - cpu| / max |cpu| of each gradient
FUNCTION_GRAD_TOL = 1e-4
# The GLIGEN CPU-vs-card step: bf16 flash (B2, B5a, B5b) on the card against
# the CPU's float32 einsum attention, each trainable gradient held by its
# cosine with the CPU's and ||card - cpu|| / ||cpu||, as C11's bf16 LoRA
# check is; `tools/grad_noise.py --gligen` measures the noise and shows a
# dropped 64-key tile of B5 failing the limit.
GLIGEN_BF16_GRAD_LIMIT = {"cos": 0.999, "rel_norm": 0.05}
# The video CPU-vs-card step (float32 on both sides): the loss and each
# gradient as TRAIN_CPU_GPU_TOL, a gradient over the larger of its own
# largest |cpu| element and GRAD_FLOOR of the step's largest (a gradient
# that vanishes in exact arithmetic holds only float noise).
GRAD_FLOOR = 1e-3
# The card's updated parameters (and EMA) against the CPU running the same
# optimizer on the card's gradients from the same state: float32
# elementwise work on two devices, max |card - cpu| / max |cpu| a tensor.
UPDATE_TOL = 1e-6
GLIGEN_TRAIN_KERNEL_GROUPS = (
    ("B2 flash forward", r"flash_fwd"),
    ("B5a flash dK/dV", r"flash_bwd_kv"),
    ("B5b flash dQ", r"flash_bwd_q"),
    ("B3 geglu_ff", r"gemm_(f32|bf16_tc)_kernel<[02]\b|split_k_reduce"),
    ("B8 group_norm_sums", r"gn_sums_kernel|gn_split_reduce"),
    ("convolutions (cuDNN)", r"conv|implicit|cudnn|fprop|wgrad|dgrad|winograd"),
    ("products (cuBLAS)", r"gemm|cutlass|xmma"))
VIDEO_TRAIN_KERNEL_GROUPS = (
    ("B6 temporal_conv_k3", r"gemm_(f32|bf16_tc)_kernel<1\b"),
    ("B3 geglu_ff", r"gemm_(f32|bf16_tc)_kernel<[02]\b|split_k_reduce"),
    ("B7 frame_attention", r"frame_attention_kernel"),
    ("B8 group_norm_sums", r"gn_sums_kernel|gn_split_reduce"),
    ("convolutions (cuDNN)", r"conv|implicit|cudnn|fprop|wgrad|dgrad|winograd"),
    ("products (cuBLAS)", r"gemm|cutlass|xmma"))


def gligen_train_launches(ucfg, latent: int, n_objs: int, n_ctx: int) -> dict:
    """Kernel launches of one GLIGEN training step, from the block plan: one
    UNet call's (`unet_counts`: B2, B3, B8 in the forward; their backward
    is torch ops, but B2's), and B5a and B5b once for each flash site whose
    inputs need a gradient: every site but the first attention block's
    self-attention, which sees only frozen weights (the first trainable
    tensors, its fuser and the position net, come after it)."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min
    from vitron_tpu_torch.models.diffusion.unet2d import block_plan

    counts = unet_counts(ucfg, latent, n_objs, n_ctx)
    size, first = latent, None
    for entries in block_plan(ucfg)[0]:
        for e in entries:
            size = size // 2 if e[0] == "down" else size
            if e[0] == "attn" and first is None:
                first = size * size
    bwd = counts["flash_attention"] - int(first is not None and first >= _flash_min())
    return {**counts, "flash_attention_bwd_kv": bwd, "flash_attention_bwd_q": bwd}


def video_train_launches(ucfg, lh: int, lw: int, n_ctx: int) -> dict:
    """Kernel launches of one video training step, from the block plan: one
    UNet call's (`video_counts`), B6 once more for each temporal conv (its
    dx, the kernel on the flipped taps; the whole UNet trains, so every
    conv's input needs a gradient) and B5a and B5b for each flash site."""
    counts = video_counts(ucfg, lh, lw, n_ctx)
    return {**counts, "temporal_conv_k3": 2 * counts["temporal_conv_k3"],
            "flash_attention_bwd_kv": counts["flash_attention"],
            "flash_attention_bwd_q": counts["flash_attention"]}


def gligen_gn_shapes(ucfg, latent: int, batch: int) -> collections.Counter:
    """[B, R, C] of every group-norm-sums launch of one SD UNet call, with
    its count, from the block plan: a ResNet's norm1 [B, HW, cin] and norm2
    [B, HW, cout], a spatial transformer's [B, HW, C], the output norm."""
    from vitron_tpu_torch.models.diffusion.unet2d import block_plan

    shapes = collections.Counter({(batch, latent * latent, ucfg.model_channels): 1})
    size = latent
    input_plan, middle_plan, output_plan = block_plan(ucfg)
    for entries in input_plan + [middle_plan] + output_plan:
        for e in entries:
            size = size // 2 if e[0] == "down" else size * 2 if e[0] == "up" else size
            if e[0] == "res":
                shapes[(batch, size * size, e[1])] += 1
                shapes[(batch, size * size, e[2])] += 1
            elif e[0] == "attn":
                shapes[(batch, size * size, e[1])] += 1
    return shapes


def diffusion_bwd_rows(torch, card: str, rows: dict) -> None:
    """B2 with its LSE, B5a and B5b in bf16 at DIFFUSION_BWD_SHAPES against
    their plain versions: errors, each output row within its limit (B2's
    query rows FLASH_ROW_REL, dq's query rows and dk's and dv's key rows
    FLASH_BWD_ROW_REL), the same bits twice, CUDA-event times beside the
    bound, the SDPA forward and the SDPA backward."""
    from vitron_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    for what, b, s_len, nh, d in DIFFUSION_BWD_SHAPES:
        q, k, v, dout = (torch.randn((b, s_len, nh, d), generator=g, device=dev).to(bf16)
                         for _ in range(4))
        args = (q, k, v, None, 0, d ** -0.5, False)
        out, lse = fa._forward(*args, 0.0, True)
        out2, lse2 = fa._forward(*args, 0.0, True)
        want_out, want_lse = fa.flash_attention_plain(*args, 0.0, return_lse=True)
        delta = fa._delta(out, dout)
        dk, dv = fa.flash_attention_bwd_kv(*args, out, lse, dout, delta)
        dq = fa.flash_attention_bwd_q(*args, out, lse, dout, delta)
        dk2, dv2 = fa.flash_attention_bwd_kv(*args, out, lse, dout, delta)
        dq2 = fa.flash_attention_bwd_q(*args, out, lse, dout, delta)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in
                   ((out, out2), (lse, lse2), (dk, dk2), (dv, dv2), (dq, dq2)))
        del out2, lse2, dk2, dv2, dq2
        want_dk, want_dv = fa.flash_attention_bwd_kv_plain(*args, out, lse, dout)
        want_dq = fa.flash_attention_bwd_q_plain(*args, out, lse, dout)
        row_rel = flash_row_rel(out, want_out)
        bwd_rows = {n_: flash_row_rel(x, y, FLASH_BWD_ROW_FLOOR) for n_, x, y in
                    (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))}
        errs = {"out": rel_err(out, want_out), "lse": rel_err(lse, want_lse),
                "dq": rel_err(dq, want_dq), "dk": rel_err(dk, want_dk), "dv": rel_err(dv, want_dv)}
        del want_out, want_lse, want_dq, want_dk, want_dv
        ms_fwd = cuda_ms(torch, lambda: fa._forward(*args, 0.0, True), iters=10)
        ms_kv = cuda_ms(torch, lambda: fa.flash_attention_bwd_kv(*args, out, lse, dout, delta),
                        iters=10)
        ms_q = cuda_ms(torch, lambda: fa.flash_attention_bwd_q(*args, out, lse, dout, delta),
                       iters=10)
        plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_plain(*args, 0.0, return_lse=True),
                            iters=3, warmup=1)
        plain_kv = cuda_ms(torch, lambda: fa.flash_attention_bwd_kv_plain(*args, out, lse, dout),
                           iters=3, warmup=1)
        plain_q = cuda_ms(torch, lambda: fa.flash_attention_bwd_q_plain(*args, out, lse, dout),
                          iters=3, warmup=1)
        lib_bwd = sdpa_bwd_ms(torch, q, k, v, None, dout)
        lib_fwd = sdpa_ms(torch, q, k, v)
        pairs = b * nh * s_len * s_len
        peak = "bf16_tensor"
        shape = f"[{b},{s_len},{nh},{d}]"
        row_fwd = dict(row(max(errs["out"][0], errs["lse"][0]), max(errs["out"][1],
                                                                    errs["lse"][1]),
                           ms_fwd, plain_fwd, nbytes(q, k, v, out, lse), 4 * d * pairs, peak,
                           lib_fwd), b2=f"{what} with LSE {shape}")
        row_kv = row(max(errs["dk"][0], errs["dv"][0]), max(errs["dk"][1], errs["dv"][1]),
                     ms_kv, plain_kv, nbytes(q, k, v, dout, lse, delta, dk, dv),
                     4 * 2 * d * pairs, peak, lib_bwd)
        row_q = row(errs["dq"][0], errs["dq"][1], ms_q, plain_q,
                    nbytes(q, k, v, dout, lse, delta, dq), 3 * 2 * d * pairs, peak)
        print(f"diffusion flash {what} {shape} bf16 non-causal shift 0: rel_err "
              + " ".join(f"{k_}={e[1]:.3e}" for k_, e in errs.items())
              + f" (limit {TRAIN_TOL['bfloat16']}), out row_rel_err={row_rel:.3e} (limit "
              f"{FLASH_ROW_REL}), row_rel_err "
              + " ".join(f"{k_}={e:.3e}" for k_, e in bwd_rows.items())
              + f" (limit {FLASH_BWD_ROW_REL['bfloat16']}), same bits twice={same}; B2+LSE "
              f"{ms_fwd:.4f} ms plain {plain_fwd:.4f} {bound_text(row_fwd)}; B5a {ms_kv:.4f} "
              f"ms plain {plain_kv:.4f} {bound_text(row_kv)}; B5b {ms_q:.4f} ms plain "
              f"{plain_q:.4f} {bound_text(row_q)}; B5a+B5b {ms_kv + ms_q:.4f} ms "
              f"({7 * 2 * d * pairs / ((ms_kv + ms_q) * 1e-3) / 1e12:.1f} TFLOP/s of the seven "
              f"products) against the SDPA backward {lib_bwd:.4f} ms [{card}]", flush=True)
        check(all(e[1] <= TRAIN_TOL["bfloat16"] for e in errs.values()),
              f"diffusion flash {what}: {errs}")
        check(all(e <= FLASH_BWD_ROW_REL["bfloat16"] for e in bwd_rows.values()),
              f"diffusion flash {what}: backward row rel errors {bwd_rows}")
        check_flash(f"diffusion {what}", errs["out"][0], row_rel)
        check(same, f"diffusion flash {what}: two runs gave other bits")
        rows["flash_lse_diffusion"].append(row_fwd)
        rows["bwd_kv_diffusion"].append(row_kv)
        rows["bwd_q_diffusion"].append(row_q)
        del q, k, v, dout, out, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()


def function_grad_rows(torch, card: str) -> None:
    """Each new autograd.Function at one site of a path, float32: under
    grad the output carries a grad_fn and the forward counts one launch; the
    backward launches B6 and B4 once more (their dx) and the others not at
    all; the card's gradients against the CPU's autograd of the plain
    version on the same inputs and cotangent (FUNCTION_GRAD_TOL), the same
    bits twice. B3 and B8 at the GLIGEN step's 64x64 level, B6 and B7 at the
    video step's 32x32 level, B4 at a FocalNet-L site (no trainer calls it)."""
    from vitron_tpu_torch.kernels import depthwise_conv as dw
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn
    from vitron_tpu_torch.kernels import temporal_attention as ta
    from vitron_tpu_torch.kernels import temporal_conv as tc

    f, n = VIDEO_TRAIN_FRAMES, VIDEO_TRAIN_LATENT ** 2
    cases = [  # name, module, wrapper, plain (on the CPU), [(shape, scale)]
        ("group_norm_sums", gn, gn.group_norm_sums, gn.group_norm_sums_plain,
         [((2, 4096, 320), 1.0)]),
        ("geglu_ff", gf, gf.geglu_ff,
         lambda x, *w: gf.geglu_ff_plain(x.reshape(-1, x.shape[-1]), *w).reshape(x.shape),
         [((2, 4096, 320), 1.0), ((320, 2560), 320 ** -0.5), ((2560,), 0.1),
          ((1280, 320), 1280 ** -0.5), ((320,), 0.1)]),
        ("frame_attention", ta, lambda q, k, v: ta.frame_attention(q, k, v, 8, 64 ** -0.5),
         lambda q, k, v: ta.frame_attention_plain(q, k, v, 8, 64 ** -0.5),
         [((1, f, n, 512), 1.0)] * 3),
        ("temporal_conv_k3", tc, tc.temporal_conv_k3,
         lambda x, w, b: tc.temporal_conv_k3_plain(x, w, b),
         [((1, f, n, 512), 1.0), ((3, 512, 512), (3 * 512) ** -0.5), ((512,), 0.1)]),
        ("depthwise_conv2d", dw, dw.depthwise_conv2d,
         lambda x, w: dw.depthwise_conv2d_plain(x, w),
         [((1, 128, 128, 192), 1.0), ((3, 3, 192), 1 / 3)]),
    ]
    dev = torch.device("cuda")
    for name, mod, fn, plain, shapes in cases:
        g = torch.Generator().manual_seed(len(name))
        inputs = [torch.randn(s, generator=g) * sc for s, sc in shapes]

        def run(fn_, device):
            xs = [a.to(device).requires_grad_(True) for a in inputs]
            before = mod.launches
            out = fn_(*xs)
            fwd = mod.launches - before
            has_fn = out.grad_fn is not None
            cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
            out.backward(cot.to(device))
            return fwd, mod.launches - before - fwd, has_fn, [x.grad.cpu() for x in xs]

        fwd, bwd, has_fn, grads = run(fn, dev)
        _, _, _, again = run(fn, dev)
        _, _, _, want = run(plain, torch.device("cpu"))
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        rels = [rel_err(a, w)[1] for a, w in zip(grads, want)]
        want_bwd = int(name in ("temporal_conv_k3", "depthwise_conv2d"))
        print(f"autograd {name} at {[list(s) for s, _ in shapes]} float32 on the card: grad_fn "
              f"{has_fn}, launches forward {fwd} backward {bwd} (expected 1, {want_bwd}); each "
              f"input's gradient against the CPU's autograd of the plain version, rel_err "
              + " ".join(f"{r:.3e}" for r in rels) + f" (limit {FUNCTION_GRAD_TOL}), same bits "
              f"twice={same} [{card}]", flush=True)
        check(has_fn and fwd == 1 and bwd == want_bwd,
              f"autograd {name}: grad_fn {has_fn}, launches {fwd} / {bwd}")
        check(all(r <= FUNCTION_GRAD_TOL for r in rels) and same,
              f"autograd {name}: gradient rel errors {rels}, same bits twice {same}")
        del inputs, grads, again, want
        torch.cuda.empty_cache()


def phase_diffusion_train_kernels(torch, card: str):
    """The diffusion trainers' kernels on the card at their paths' shapes:
    B2 with its LSE, B5a and B5b at DIFFUSION_BWD_SHAPES (bf16, as the
    UNet's `_mha` calls them); B8 at every [B, R, C] of the GLIGEN step's
    UNet call (float32; its B3 shapes are task A's, phase 4); B6, B7, B3 and
    B8 at every shape of the video step's UNet call (float32, 1 x
    VIDEO_TRAIN_FRAMES frames of VIDEO_TRAIN_LATENT^2); then each new
    autograd.Function (`function_grad_rows`)."""
    from vitron_tpu_torch.kernels import group_norm as gn
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

    rows = {"flash_lse_diffusion": [], "bwd_kv_diffusion": [], "bwd_q_diffusion": [],
            "gn_gligen_train": []}
    diffusion_bwd_rows(torch, card, rows)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    cfg = GligenConfig()
    shapes = gligen_gn_shapes(cfg.unet, cfg.latent_size, 2)
    check(sum(shapes.values()) == unet_counts(cfg.unet, cfg.latent_size, cfg.max_objs,
                                              cfg.text.max_length)["group_norm_sums"],
          "GLIGEN group-norm shapes do not match the plan's count")
    for shape in sorted(shapes):
        x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        got, again = gn.group_norm_sums(x), gn.group_norm_sums(x)
        want = gn.group_norm_sums_plain(x)
        err, rel = rel_err(got, want)
        ms = graph_ms(torch, lambda: gn.group_norm_sums(x), calls=5)
        plain_ms = cuda_ms(torch, lambda: gn.group_norm_sums_plain(x), iters=3, warmup=1)
        lib_ms = graph_ms(torch, lambda: torch.var_mean(x, dim=1, correction=0), calls=5)
        r = row(err, rel, ms, plain_ms, nbytes(x, got), 3 * x.numel(), "fp32", lib_ms)
        same = bool(torch.equal(got, again))
        print(f"group_norm_sums {list(shape)} float32 (x{shapes[shape]} a GLIGEN step): "
              f"rel_err={rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms, same bits twice="
              f"{same} {bound_text(r)} [{card}]", flush=True)
        check(rel <= GN_TOL and same, f"group_norm_sums {list(shape)}: rel err {rel}, same {same}")
        rows["gn_gligen_train"].append(r)
        del x, got, again, want
    t2v = Text2VideoConfig()
    video = video_kernel_rows(torch, card, t2v.unet, None, VIDEO_TRAIN_LATENT, VIDEO_TRAIN_LATENT,
                              VIDEO_TRAIN_FRAMES, t2v.text.max_length, seed=23, batch=1,
                              dtypes=("float32",))
    check(not video.pop("flash_vae"), "the video step's UNet has no flash site at 32x32")
    rows.update({f"{k}_train": v for k, v in video.items()})
    for key, name in (("flash_lse_diffusion", "B2 with LSE"), ("bwd_kv_diffusion", "B5a"),
                      ("bwd_q_diffusion", "B5b"), ("gn_gligen_train", "B8 (GLIGEN step)"),
                      ("tconv_train", "B6 (video step)"), ("tattn_train", "B7 (video step)"),
                      ("geglu_video_train", "B3 (video step)"),
                      ("gn_video_train", "B8 (video step)")):
        print_sums(f"diffusion trainers' shapes, {name}", rows[key], card)
    function_grad_rows(torch, card)
    return rows


class GradStats:
    """Post-accumulate hooks on the trainable tensors: after each backward,
    whether each gradient is finite and whether any element is nonzero (one
    host sync to read them all, no copy of the gradients)."""

    def __init__(self, torch, named):
        self.torch, self.stats = torch, {}
        self.handles = [p.register_post_accumulate_grad_hook(self._hook(path))
                        for path, p in named]

    def _hook(self, path):
        def fn(p):
            self.stats[path] = self.torch.stack([self.torch.isfinite(p.grad).all(),
                                                 p.grad.ne(0).any()])
        return fn

    def read(self) -> dict:
        """{path: (finite, nonzero)} of the last backward, then cleared."""
        keys = list(self.stats)
        flags = self.torch.stack([self.stats[k] for k in keys]).cpu().tolist() if keys else []
        self.stats = {}
        return {k: tuple(f) for k, f in zip(keys, flags)}

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def gligen_train_batch(torch, pipe, gen):
    """The GLIGEN step's batch at the pipeline's config: the VAE latents of
    seeded 512^2 images (encoded one at a time under no_grad: task C's
    encode shapes), the CLIP-L context of GLIGEN_TRAIN_PROMPTS, and
    max_objs grounding slots a row, GLIGEN_TRAIN_BOXES of them valid, with
    seeded boxes and the pooled CLIP features of a phrase each."""
    from vitron_tpu_torch.models.diffusion import clip_text, vae

    cfg, dev = pipe.cfg, pipe.device
    rs = np.random.RandomState(5)
    with torch.no_grad():
        x0 = []
        for _ in GLIGEN_TRAIN_PROMPTS:
            img = torch.as_tensor(rs.randint(0, 256, (cfg.image_size, cfg.image_size, 3)),
                                  dtype=torch.float32, device=dev)
            mean, _ = vae.encode(pipe.vae_params, cfg.vae, (img / 255.0 - 0.5)[None] / 0.5)
            x0.append(mean * vae.SD_SCALE_FACTOR)
        ids = torch.as_tensor(pipe.tokenize(list(GLIGEN_TRAIN_PROMPTS)), device=dev)
        context = clip_text.encode(pipe.text_params, cfg.text, ids)
        masks = torch.zeros((len(GLIGEN_TRAIN_PROMPTS), cfg.max_objs), device=dev)
        for i, n in enumerate(GLIGEN_TRAIN_BOXES):
            masks[i, :n] = 1.0
        lo = torch.rand((len(GLIGEN_TRAIN_PROMPTS), cfg.max_objs, 2), generator=gen,
                        device=dev) * 0.5
        boxes = torch.cat([lo, lo + 0.2 + 0.3 * torch.rand(lo.shape, generator=gen, device=dev)],
                          dim=-1)
        words = [f"{a} {b}" for a in ("a red", "a small", "a blue", "an old", "a green")
                 for b in ("car", "dog", "tree", "house", "bicycle", "cat")]
        phrase_ids = torch.as_tensor(pipe.tokenize(words[:cfg.max_objs]), device=dev)
        phrases = pipe.pooled_text_features(phrase_ids)
        phrase_emb = phrases[None].expand(len(GLIGEN_TRAIN_PROMPTS), -1, -1) * masks[..., None]
    return {"x0": torch.cat(x0), "context": context, "boxes": boxes * masks[..., None],
            "masks": masks, "phrase_emb": phrase_emb.contiguous()}


def phase_train_gligen(torch, card: str):
    """The GLIGEN trainer at full width: `GligenConfig()` (SD v1.4 + GLIGEN
    fusers and position net, float32, 64x64 latents of 512^2 images, 30
    grounding slots, 77 text tokens), batch 2, `GligenTrainConfig()` (AdamW
    5e-5, the 10% whole-batch grounding drop), GLIGEN_TRAIN_STEPS steps
    with draws from a seeded generator, twice from the same state: the same
    losses, frozen tensors bit-equal to their start, every trainable tensor
    with a nonzero gradient moved, every gradient finite, each step's
    launches equal to `gligen_train_launches`; step seconds, peak memory,
    a profiled step by kernel group."""
    import gc

    from vitron_tpu_torch.models.diffusion import clip_text, unet2d, vae
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig, GligenPipeline
    from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
    from vitron_tpu_torch.train import gligen as tg
    from vitron_tpu_torch.train.train_step import named_leaves

    dev = torch.device("cuda")
    cfg = GligenConfig()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    unet = fill_zero_leaves(unet2d.init_params(g, cfg.unet, dev), g)
    pipe = GligenPipeline(cfg, unet, fill_zero_leaves(vae.init_params(g, cfg.vae, dev), g),
                          fill_zero_leaves(clip_text.init_params(g, cfg.text, dev), g),
                          tokenizer=StubClipTokenizer(cfg.text.vocab_size))
    batch = gligen_train_batch(torch, pipe, g)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = tg.GligenTrainConfig()
    sched = DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)
    step, init_state = tg.make_gligen_train_step(cfg.unet, sched, tcfg)
    n_train, n_frozen = tg.partition_params(unet, tcfg)
    trained = tg.trainable_leaves(unet, tcfg)
    start = {path: p.detach().clone() for path, p in named_leaves(unet)}
    torch.cuda.synchronize()
    print(f"train gligen: SD v1.4 GLIGEN UNet ({n_train / 1e6:.1f}M trainable, "
          f"{n_frozen / 1e6:.1f}M frozen), VAE and CLIP-L built on the card and the batch "
          f"encoded in {time.perf_counter() - t0:.1f} s; x0 {list(batch['x0'].shape)} std "
          f"{batch['x0'].std().item():.3f}", flush=True)
    want = gligen_train_launches(cfg.unet, cfg.latent_size, cfg.max_objs, cfg.text.max_length)
    init_state(unet)  # the trainable tensors require grad from here on
    stats = GradStats(torch, trained)

    def run(label):
        with torch.no_grad():
            for path, p in named_leaves(unet):
                p.copy_(start[path])
        state = init_state(unet)
        gen = torch.Generator(device=dev).manual_seed(1)
        losses, secs, total, flags = [], [], collections.Counter(), {}
        for i in range(GLIGEN_TRAIN_STEPS):
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            state, loss = step(state, batch, gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            total.update(expect_launches(want, f"train gligen {label} step {i + 1}"))
            losses.append(float(loss))
            for path, (finite, nonzero) in stats.read().items():
                check(finite, f"train gligen {label} step {i + 1}: gradient {path} not finite")
                flags[path] = flags.get(path, False) or nonzero
        return state, losses, secs, dict(total), flags

    torch.cuda.reset_peak_memory_stats()
    state, losses, secs, launches, flags = run("run 1")
    peak = torch.cuda.max_memory_allocated()
    moved = {path: not torch.equal(p.detach(), start[path]) for path, p in trained}
    frozen_same = all(torch.equal(p.detach(), start[path]) for path, p in named_leaves(unet)
                      if path not in moved)
    del state
    state, losses2, secs2, _, _ = run("run 2")
    frozen_same = frozen_same and all(torch.equal(p.detach(), start[path])
                                      for path, p in named_leaves(unet) if path not in moved)
    stats.remove()
    t1 = time.perf_counter()
    state, _ = step(state, batch, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    profile_breakdown(torch, card, "train gligen: one step (batch 2, 64x64)",
                      lambda: step(state, batch, torch.Generator(device=dev).manual_seed(3)),
                      (time.perf_counter() - t1) * 1e3, GLIGEN_TRAIN_KERNEL_GROUPS)
    no_grad = sorted(".".join(map(str, p)) for p, nz in flags.items() if not nz)
    print(f"train gligen: losses {losses} then {losses2}; step s "
          f"{', '.join(f'{x:.3f}' for x in secs)} then "
          f"{', '.join(f'{x:.3f}' for x in secs2)} (mean of steps 2-{GLIGEN_TRAIN_STEPS}: "
          f"{statistics.mean(secs2[1:]):.3f} s); peak memory {peak / 2**30:.2f} GiB; launches "
          f"{launches} ({want} a step); {sum(moved.values())} of {len(moved)} trainable tensors "
          f"moved, zero gradient on {no_grad or 'none'}; frozen tensors bit-equal {frozen_same} "
          f"[{card}]", flush=True)
    check(all(np.isfinite(losses)) and losses == losses2,
          f"train gligen: the same steps twice gave other losses: {losses} vs {losses2}")
    check(frozen_same, "train gligen: a frozen tensor changed")
    check(all(moved[p] == flags.get(p, False) for p in moved),
          "train gligen: a trainable tensor with a nonzero gradient did not move (or one "
          "without moved)")
    del state, unet, start, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def video_train_params(torch, ucfg, dev, seed: int):
    """Full-width video UNet params from `seed`, zero leaves filled."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    g = torch.Generator(device=dev).manual_seed(seed)
    return fill_zero_leaves(unet_sd_video.init_params(g, ucfg, dev), g)


def video_optimizer(ts, tv, tcfg):
    """The value clip, then Adafactor at `annealing_lr` (JAX trainer.py:51-52)."""
    return ts.chain(ts.clip(tcfg.grad_clip_value),
                    ts.adafactor(lambda count: tv.annealing_lr(tcfg, count)))


def phase_train_video(torch, card: str, variant: str = "t2v"):
    """The video trainer at full width: the t2v UNet (`UNetSDVideoConfig.t2v`,
    float32) or, with variant "i2vgen", the i2vgen one
    (`UNetSDVideoConfig.i2vgen_xl`, with a global `image` embedding and a
    `local_image` latent as its conditions; ROADMAP C15),
    `VideoTrainConfig()` (v-prediction, the cosine zero-terminal-
    SNR schedule, 10% text dropout, the EMA) with the value clip and
    Adafactor at `annealing_lr` (AdamW's two moments and the EMA would not
    fit beside 4.4B float32 weights), batch 1 of VIDEO_TRAIN_FRAMES frames of
    VIDEO_TRAIN_LATENT^2 latents, CLIP text (1024 wide) context,
    VIDEO_TRAIN_STEPS steps twice from the same state (rebuilt from its
    seed): the same losses, every tensor with a nonzero gradient moved,
    every gradient finite, each step's launches equal to
    `video_train_launches`; step seconds, peak memory, and for t2v a
    profiled step."""
    import gc

    from vitron_tpu_torch.models.diffusion import clip_text
    from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig, _tokenize
    from vitron_tpu_torch.train import train_step as ts
    from vitron_tpu_torch.train import video as tv

    dev = torch.device("cuda")
    t2v = Text2VideoConfig()
    ucfg = t2v.unet if variant == "t2v" else UNetSDVideoConfig.i2vgen_xl()
    n_ctx = (t2v.text.max_length if variant == "t2v"
             else i2v_context(ucfg, t2v.text.max_length))
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        text = fill_zero_leaves(clip_text.init_params(g, t2v.text, dev), g)
        ids = _tokenize(StubClipTokenizer(t2v.text.vocab_size), t2v.text,
                        [VIDEO_TRAIN_PROMPT, ""], dev)
        ctx = clip_text.encode(text, t2v.text, ids)
        del text
    lat = VIDEO_TRAIN_LATENT
    batch = {"x0": torch.randn((1, VIDEO_TRAIN_FRAMES, lat, lat, 4), generator=g, device=dev),
             "y": ctx[:1], "zero_y_negative": ctx[1:], "fps": torch.tensor([8], device=dev)}
    if variant == "i2vgen":
        batch["image"] = torch.randn((1, ucfg.y_dim), generator=g, device=dev)
        batch["local_image"] = torch.randn((1, lat, lat, 4), generator=g, device=dev)
    tcfg = tv.VideoTrainConfig()
    sched = DiffusionSchedule.create("cosine", 1000, zero_terminal_snr=True)
    step = tv.make_video_train_step(ucfg, sched, tcfg, video_optimizer(ts, tv, tcfg))
    want = video_train_launches(ucfg, lat, lat, n_ctx)

    def run(label):
        t1 = time.perf_counter()
        state = tv.init_state(video_train_params(torch, ucfg, dev, seed=11), tcfg,
                              video_optimizer(ts, tv, tcfg))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        stats = GradStats(torch, ts.named_leaves(state["params"]))
        gen = torch.Generator(device=dev).manual_seed(1)
        losses, secs, total, flags = [], [], collections.Counter(), {}
        for i in range(VIDEO_TRAIN_STEPS):
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            state, loss = step(state, batch, gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            total.update(expect_launches(want, f"train {variant} {label} step {i + 1}"))
            losses.append(float(loss))
            for path, (finite, nonzero) in stats.read().items():
                check(finite, f"train {variant} {label} step {i + 1}: gradient {path} not "
                      f"finite")
                flags[path] = flags.get(path, False) or nonzero
        stats.remove()
        return state, losses, secs, dict(total), flags, build_s

    torch.cuda.reset_peak_memory_stats()
    state, losses, secs, launches, flags, build_s = run("run 1")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in ts.leaves(state["params"]))
    final = state["params"]
    ema_finite = all(bool(torch.isfinite(e).all()) for e in ts.leaves(state["ema"]))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    fresh = dict(ts.named_leaves(video_train_params(torch, ucfg, dev, seed=11)))
    moved = {path: not torch.equal(p.detach(), fresh[path])
             for path, p in ts.named_leaves(final)}
    del final, fresh
    gc.collect()
    torch.cuda.empty_cache()
    state, losses2, secs2, _, _, _ = run("run 2")
    if variant == "t2v":
        t1 = time.perf_counter()
        state, _ = step(state, batch, torch.Generator(device=dev).manual_seed(2))
        torch.cuda.synchronize()
        profile_breakdown(torch, card, f"train video: one step (1 x {VIDEO_TRAIN_FRAMES} "
                          f"frames, {lat}x{lat})",
                          lambda: step(state, batch, torch.Generator(device=dev).manual_seed(3)),
                          (time.perf_counter() - t1) * 1e3, VIDEO_TRAIN_KERNEL_GROUPS)
    no_grad = sorted(".".join(map(str, p)) for p in moved if not flags.get(p, False))
    print(f"train video: {variant} UNet {n_params / 1e9:.3f}B params built on the card in "
          f"{build_s:.1f} s; losses {losses} then {losses2}; step s "
          f"{', '.join(f'{x:.3f}' for x in secs)} then {', '.join(f'{x:.3f}' for x in secs2)} "
          f"(mean of steps 2-{VIDEO_TRAIN_STEPS}: {statistics.mean(secs2[1:]):.3f} s); peak "
          f"memory {peak / 2**30:.2f} GiB; launches {launches} ({want} a step); "
          f"{sum(moved.values())} of {len(moved)} tensors moved, no or zero gradient on "
          f"{no_grad or 'none'}; EMA finite {ema_finite} [{card}]", flush=True)
    check(all(np.isfinite(losses)) and losses == losses2,
          f"train {variant}: the same steps twice gave other losses: {losses} vs {losses2}")
    check(all(moved[p] == flags.get(p, False) for p in moved),
          f"train {variant}: a tensor with a nonzero gradient did not move (or one without "
          f"moved)")
    check(ema_finite, f"train {variant}: the EMA is not finite")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def updates_within(tx, before: dict, grads: dict, after: dict) -> dict:
    """The CPU's optimizer `tx` on the card's gradients from the same state
    (`before`) against the card's updated tensors: each path -> max |card -
    cpu| / max |cpu|."""
    from vitron_tpu_torch.train import train_step as ts

    paths = list(before)
    params = [before[p].clone() for p in paths]
    for p, t in zip(paths, params):
        t.grad = grads.get(p)
    ts.apply_gradients(tx, params, tx.init(params))
    return {p: rel_err(after[p], t)[1] for p, t in zip(paths, params)}


def gligen_cpu_vs_card_setup(torch):
    """(UNet config, params, batch, draws, train config, schedule) of the
    GLIGEN CPU-vs-card step, built on the CPU from a CPU generator: SD v1.4
    at full width but one level (`UNetConfig.sd_v1(channel_mult=(1,),
    num_res_blocks=1, attention_resolutions=(1,))`), 32x32 latents, batch
    2, 30 boxes (4 and 7 valid), 77 context tokens, no grounding drop."""
    from vitron_tpu_torch.models.diffusion import unet2d
    from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
    from vitron_tpu_torch.train import gligen as tg

    ucfg = unet2d.UNetConfig.sd_v1(channel_mult=(1,), num_res_blocks=1,
                                   attention_resolutions=(1,))
    g = torch.Generator().manual_seed(31)
    params = fill_zero_leaves(unet2d.init_params(g, ucfg, torch.device("cpu")), g)
    masks = torch.zeros((2, 30))
    masks[0, :4], masks[1, :7] = 1.0, 1.0
    batch = {"x0": torch.randn((2, 32, 32, 4), generator=g),
             "context": torch.randn((2, 77, 768), generator=g),
             "boxes": torch.rand((2, 30, 4), generator=g) * masks[..., None],
             "masks": masks, "phrase_emb": torch.randn((2, 30, 768), generator=g)}
    draws = {"drop": torch.tensor(False), "t": torch.tensor([120, 730]),
             "noise": torch.randn((2, 32, 32, 4), generator=g)}
    return (ucfg, params, batch, draws, tg.GligenTrainConfig(),
            DiffusionSchedule.create("linear", 1000, 0.00085, 0.012))


def to_device(torch, tree, device):
    return tree_map(lambda a: a.detach().to(device).clone(), tree)


def gligen_step_on(torch, setup, device):
    """One GLIGEN training step of `gligen_cpu_vs_card_setup` on `device`:
    (loss, trainable gradients, updated trainable tensors, launches), on
    the CPU."""
    from vitron_tpu_torch.train import gligen as tg

    ucfg, params, batch, draws, tcfg, sched = setup
    p = to_device(torch, params, device)
    step, init = tg.make_gligen_train_step(ucfg, sched, tcfg)
    state = init(p)
    grads = {}
    reset_launches()
    state, loss = step(state, to_device(torch, batch, device), to_device(torch, draws, device),
                       grads)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (float(loss), {k: v.cpu() for k, v in grads.items()},
            {k: t.detach().cpu() for k, t in tg.trainable_leaves(p, tcfg)}, read_launches())


def phase_train_cpu_vs_card_diffusion(torch, card: str):
    """One training step of each trainer on the CPU and the card from the
    same CPU-built state and draws. GLIGEN (`gligen_cpu_vs_card_setup`): the
    card's bf16 flash (B2, B5a, B5b at D 40) against the CPU's float32
    einsum attention, each trainable gradient within GLIGEN_BF16_GRAD_LIMIT.
    Video at full width but one level (`UNetSDVideoConfig.t2v(dim_mult=(1,))`,
    2 x 4 frames of 16x16 latents, the value clip and Adafactor, warmup 0 so
    the step moves the weights), float32 on both sides: the loss and each
    gradient within TRAIN_CPU_GPU_TOL. Both: the card's updated tensors (and
    the EMA) against the CPU's optimizer run on the card's gradients
    (UPDATE_TOL), and the card's launches. The i2vgen UNet's step
    (`UNetSDVideoConfig.i2vgen_xl(dim_mult=(1,))`, with its image
    conditions) is held as the t2v one (ROADMAP C15)."""
    from vitron_tpu_torch.train import gligen as tg

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    setup = gligen_cpu_vs_card_setup(torch)
    ucfg, params, _, _, tcfg, _ = setup
    runs = {}
    for name, device in (("cuda", dev), ("cpu", cpu)):
        t0 = time.perf_counter()
        runs[name] = gligen_step_on(torch, setup, device)
        print(f"gligen cpu-vs-card: {name} step {time.perf_counter() - t0:.1f} s", flush=True)
    (loss, grads, after, launches), (loss_cpu, grads_cpu, _, _) = runs["cuda"], runs["cpu"]
    want = {"conv3x3_same": 0, **gligen_train_launches(ucfg, 32, 30, 77)}
    check(all(launches[k] == v for k, v in want.items()),
          f"gligen cpu-vs-card launches {launches} != {want}")
    held = grads_within(grads, grads_cpu, GLIGEN_BF16_GRAD_LIMIT)
    before = dict(tg.trainable_leaves(params, tcfg))
    upd = updates_within(tg.make_optimizer(tcfg), before, grads, after)
    worst = min(held, key=lambda k: held[k][0])
    worst_rel = max(held, key=lambda k: held[k][1])
    print(f"gligen cpu-vs-card: one-level full-width GLIGEN step at 32x32 (bf16 flash B2/B5 at "
          f"D 40 on the card, float32 einsum on the CPU), loss {loss_cpu:.6f} card {loss:.6f}, "
          f"{len(held)} trainable gradients, lowest cosine {'.'.join(map(str, worst))} "
          f"{held[worst][0]:.6f}, largest relative norm {'.'.join(map(str, worst_rel))} "
          f"{held[worst_rel][1]:.3e}, median cosine "
          f"{statistics.median(v[0] for v in held.values()):.6f} (limit {GLIGEN_BF16_GRAD_LIMIT})"
          f"; updated tensors against the CPU's AdamW on the card's gradients, worst rel_err "
          f"{max(upd.values()):.3e} (limit {UPDATE_TOL}); launches {launches} [{card}]",
          flush=True)
    check(not [k for k, v in held.items() if not v[2]],
          f"gligen cpu-vs-card: gradients outside {GLIGEN_BF16_GRAD_LIMIT}: "
          f"{[k for k, v in held.items() if not v[2]]}")
    check(max(upd.values()) <= UPDATE_TOL, f"gligen cpu-vs-card: updates {max(upd.values())}")

    for variant in ("t2v", "i2vgen"):
        video_cpu_vs_card_step(torch, card, variant)


def video_cpu_vs_card_step(torch, card: str, variant: str) -> None:
    """Phase 24's video step: the t2v or the i2vgen UNet (with its global
    `image` and `local_image` conditions) at full width but one level."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video
    from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
    from vitron_tpu_torch.train import train_step as ts
    from vitron_tpu_torch.train import video as tv

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    vcfg = (unet_sd_video.UNetSDVideoConfig.t2v(dim_mult=(1,)) if variant == "t2v"
            else unet_sd_video.UNetSDVideoConfig.i2vgen_xl(dim_mult=(1,)))
    g = torch.Generator().manual_seed(32)
    params = fill_zero_leaves(unet_sd_video.init_params(g, vcfg, cpu), g)
    batch = {"x0": torch.randn((2, 4, 16, 16, 4), generator=g),
             "y": 0.5 * torch.randn((2, 77, 1024), generator=g),
             "zero_y_negative": 0.5 * torch.randn((1, 77, 1024), generator=g),
             "fps": torch.tensor([8, 8])}
    n_ctx = 77
    if variant == "i2vgen":
        batch["image"] = torch.randn((2, vcfg.y_dim), generator=g)
        batch["local_image"] = torch.randn((2, 16, 16, 4), generator=g)
        n_ctx = i2v_context(vcfg, 77)
    draws = {"drop": torch.tensor([True, False]), "t": torch.tensor([250, 900]),
             "noise": torch.randn((2, 4, 16, 16, 4), generator=g)}
    tcfg = tv.VideoTrainConfig(warmup_steps=0)
    sched = DiffusionSchedule.create("cosine", 1000, zero_terminal_snr=True)
    want_launches = video_train_launches(vcfg, 16, 16, n_ctx)
    runs = {}
    for name, device in (("cuda", dev), ("cpu", cpu)):
        tx = video_optimizer(ts, tv, tcfg)
        state = tv.init_state(to_device(torch, params, device), tcfg, tx)
        step = tv.make_video_train_step(vcfg, sched, tcfg, tx)
        grads = {}
        reset_launches()
        t0 = time.perf_counter()
        state, loss = step(state, to_device(torch, batch, device),
                           to_device(torch, draws, device), grads)
        if name == "cuda":
            torch.cuda.synchronize()
            expect_launches(want_launches, f"{variant} cpu-vs-card step")
        runs[name] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                      {k: t.detach().cpu() for k, t in ts.named_leaves(state["params"])},
                      {k: t.cpu() for k, t in ts.named_leaves(state["ema"])})
        print(f"{variant} cpu-vs-card: {name} step {time.perf_counter() - t0:.1f} s", flush=True)
    (loss, grads, after, ema), (loss_cpu, grads_cpu, _, _) = runs["cuda"], runs["cpu"]
    loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
    top = max(w.abs().max().item() for w in grads_cpu.values())
    grad_rel = {k: ((grads[k] - w).abs().max() / max(w.abs().max().item(), GRAD_FLOOR * top))
                .item() for k, w in grads_cpu.items()}
    before = dict(ts.named_leaves(params))
    tx = video_optimizer(ts, tv, tcfg)
    upd = updates_within(tx, before, grads, after)
    # the EMA started as the weights: after + d (before - after), as ema_update
    ema_rel = {k: rel_err(ema[k], after[k] + tcfg.ema_decay * (before[k] - after[k]))[1]
               for k in before}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"{variant} cpu-vs-card: one-level full-width {variant} step (2 x 4 frames, 16x16, "
          f"float32 on both), loss {loss_cpu:.6f} rel_err={loss_rel:.3e} (limit "
          f"{TRAIN_CPU_GPU_TOL['loss']}), {len(grad_rel)} gradients, worst "
          f"{'.'.join(map(str, worst))} rel_err={grad_rel[worst]:.3e}, median "
          f"{statistics.median(grad_rel.values()):.3e} (limit {TRAIN_CPU_GPU_TOL['grad']}, floor "
          f"{GRAD_FLOOR} of the largest); updated tensors against the CPU's value clip + "
          f"Adafactor on the card's gradients, worst rel_err {max(upd.values()):.3e}, EMA "
          f"{max(ema_rel.values()):.3e} (limit {UPDATE_TOL}) [{card}]", flush=True)
    check(grads.keys() == grads_cpu.keys(),
          f"{variant} cpu-vs-card: other gradients on the two sides")
    check(loss_rel <= TRAIN_CPU_GPU_TOL["loss"], f"{variant} cpu-vs-card loss: {loss_rel}")
    check(grad_rel[worst] <= TRAIN_CPU_GPU_TOL["grad"], f"{variant} cpu-vs-card gradient {worst}: "
          f"{grad_rel[worst]}")
    check(max(upd.values()) <= UPDATE_TOL and max(ema_rel.values()) <= UPDATE_TOL,
          f"{variant} cpu-vs-card: updates {max(upd.values())}, EMA {max(ema_rel.values())}")


# ------------------------------------------------------------ checkpoint load (phase 25)

# Vicuna-7B v1.5's config.json (the fields `assembly.llama_cfg_from_hf` reads)
VICUNA_CONFIG = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                 "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
                 "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
                 "max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                 "torch_dtype": "float16", "tie_word_embeddings": False}
# CLIP ViT-L/14-336's vision config
CLIP_CONFIG = {"architectures": ["CLIPVisionModel"], "model_type": "clip_vision_model",
               "hidden_size": 1024, "image_size": 336, "intermediate_size": 4096,
               "num_attention_heads": 16, "num_hidden_layers": 24, "patch_size": 14,
               "projection_dim": 768}
CKPT_SHARDS = 4        # model-0000k-of-00004.safetensors: 8 layers each
CKPT_STD = 2e-2        # HF's initializer_range: every weight N(0, 0.02)
CKPT_LORA = {"peft_type": "LORA", "task_type": "CAUSAL_LM", "r": 128, "lora_alpha": 256,
             "lora_dropout": 0.05, "bias": "none",  # the reference's finetune_lora.sh
             "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                "up_proj", "down_proj"]}
CKPT_FREE_BYTES = 44 * 1024 ** 3  # room the whole deployment (~41 GiB, phase 27) needs
# A card machine's disk takes at most 45 GiB of writes in one call, deleted
# files included: phases 25-27 write ~41 GiB, each file once (the weights
# that phase 26 (a) and 27 write are fp16, as phase 25's Vicuna shards and
# 26 (b)'s UNet are). Every file they write goes through `disk_write`,
# which fails a write that would take the count past WRITE_BUDGET_BYTES
# (the rest of the 45 GiB is the kernels' build and the logs).
WRITE_BUDGET_BYTES = 42 * 1024 ** 3
disk_written = 0  # bytes of the files `disk_write` has written in this process
SAFETENSORS_DTYPES = {"torch.float32": "F32", "torch.float16": "F16", "torch.bfloat16": "BF16",
                      "torch.int8": "I8", "torch.uint8": "U8", "torch.int32": "I32",
                      "torch.int64": "I64"}


def write_safetensors(path, entries) -> int:
    """{name: (dtype, shape, make)} -> one .safetensors file: an 8-byte
    little-endian header length, the JSON header (each tensor's dtype, shape
    and byte offsets), then the bytes of each make() in turn, so the host
    holds one tensor at a time. -> bytes written."""
    import torch

    header, offset = {}, 0
    for name, (dtype, shape, _) in entries.items():
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(dtype)], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)

    def write(path):
        with open(path, "wb") as fh:
            fh.write(struct.pack("<Q", len(head)) + head)
            for name, (dtype, shape, make) in entries.items():
                t = make().to("cpu", dtype).contiguous()
                check(tuple(t.shape) == tuple(shape), f"{name}: {tuple(t.shape)}, header {shape}")
                fh.write(t.reshape(-1).view(torch.uint8).numpy().data)

    return disk_write(path, 8 + len(head) + offset, write)


def disk_write(path, nbytes: int, write) -> int:
    """write(path), once `nbytes` more are seen to keep this process's
    writes within WRITE_BUDGET_BYTES; the file's bytes are added to
    `disk_written`. -> them."""
    global disk_written
    check(disk_written + nbytes <= WRITE_BUDGET_BYTES,
          f"disk write budget: {path} ({nbytes} bytes) would take the files written from "
          f"{disk_written} bytes past WRITE_BUDGET_BYTES ({WRITE_BUDGET_BYTES}); a card "
          f"machine stops a call at 45 GiB written")
    write(path)
    n = os.path.getsize(path)
    disk_written += n
    return n


def save_state(torch, obj, path) -> int:
    """torch.save(obj, path) through `disk_write`, `obj`'s tensor bytes its
    size beforehand. -> the file's bytes."""
    leaves = tree_leaves(obj)
    return disk_write(path, nbytes(*(t for t in leaves if isinstance(t, torch.Tensor))),
                      lambda p: torch.save(obj, p))


def ckpt_root():
    """A directory with CKPT_FREE_BYTES free: the temp dir, else the
    checkout's `build/` (ignored by git)."""
    import tempfile

    for d in (tempfile.gettempdir(), os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "build")):
        os.makedirs(d, exist_ok=True)
        free = shutil.disk_usage(d).free
        print(f"checkpoint: {d} has {free / 2**30:.1f} GiB free", flush=True)
        if free >= CKPT_FREE_BYTES:
            return tempfile.mkdtemp(prefix="vitron_ckpt_", dir=d)
    raise RuntimeError(f"no directory with {CKPT_FREE_BYTES / 2**30:.0f} GiB free")


def write_deployment(torch, root, seed: int) -> int:
    """Phase 25's synthetic HF-layout deployment under `root`, from `seed`
    (values made on the card, written tensor by tensor):
    - vicuna-7b/: Vicuna-7B v1.5's config.json, fp16 shards with
      model.safetensors.index.json, every weight N(0, CKPT_STD), norms 1;
    - vitron_lora/: a peft adapter (adapter_model.safetensors, fp16, r 128,
      alpha 256 on the seven projections) and non_lora_trainables.bin (bf16:
      the projector 1024 -> 4096 -> 4096 and the region extractor);
    - clip_vit_l14/: CLIPVisionModel keys of ViT-L/14-336, float32
      safetensors;
    - languagebind_video/: the same tower with LanguageBind's temporal keys,
      fp16 pytorch_model.bin.
    -> bytes written."""
    import pathlib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    f16, f32, bf16 = torch.float16, torch.float32, torch.bfloat16

    def rand(shape, dtype=f16, mean=0.0):
        def make():
            return (torch.randn(shape, generator=g, device=dev) * CKPT_STD + mean).to(dtype)
        return dtype, tuple(shape), make

    def ones(shape, dtype=f16):
        return dtype, tuple(shape), lambda: torch.ones(shape, dtype=dtype)

    root = pathlib.Path(root)
    written = 0
    c = VICUNA_CONFIG
    h, ff, n_layers, vocab = (c["hidden_size"], c["intermediate_size"],
                              c["num_hidden_layers"], c["vocab_size"])
    base = root / "vicuna-7b"
    base.mkdir()
    (base / "config.json").write_text(json.dumps(c))
    shards = [{} for _ in range(CKPT_SHARDS)]
    shards[0]["model.embed_tokens.weight"] = rand((vocab, h))
    shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h), "self_attn.v_proj": (h, h),
              "self_attn.o_proj": (h, h), "mlp.gate_proj": (ff, h), "mlp.up_proj": (ff, h),
              "mlp.down_proj": (h, ff)}
    for i in range(n_layers):
        s = shards[i * CKPT_SHARDS // n_layers]
        s[f"model.layers.{i}.input_layernorm.weight"] = ones((h,))
        s[f"model.layers.{i}.post_attention_layernorm.weight"] = ones((h,))
        for mod, shape in shapes.items():
            s[f"model.layers.{i}.{mod}.weight"] = rand(shape)
    shards[-1]["model.norm.weight"] = ones((h,))
    shards[-1]["lm_head.weight"] = rand((vocab, h))
    weight_map = {}
    for k, s in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        written += write_safetensors(base / name, s)
        weight_map.update({n: name for n in s})
    (base / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": written}, "weight_map": weight_map}))

    lora = root / "vitron_lora"
    lora.mkdir()
    (lora / "adapter_config.json").write_text(json.dumps(CKPT_LORA))
    r = CKPT_LORA["r"]
    adapter = {}
    for i in range(n_layers):
        for mod, (out, inp) in shapes.items():
            stem = f"base_model.model.model.layers.{i}.{mod}"
            adapter[f"{stem}.lora_A.weight"] = rand((r, inp))
            adapter[f"{stem}.lora_B.weight"] = rand((out, r))
    written += write_safetensors(lora / "adapter_model.safetensors", adapter)
    v = CLIP_CONFIG["hidden_size"]
    nl = {"model.mm_projector.0.weight": (h, v), "model.mm_projector.0.bias": (h,),
          "model.mm_projector.2.weight": (h, h), "model.mm_projector.2.bias": (h,),
          "model.region_extractor.region_linear.layers.0.weight": (h, v),
          "model.region_extractor.loc_encoder.loc_encoder.0.weight": (h // 2, 4),
          "model.region_extractor.loc_encoder.loc_encoder.0.bias": (h // 2,),
          "model.region_extractor.loc_encoder.loc_encoder.2.weight": (h, h // 2),
          "model.region_extractor.loc_encoder.loc_encoder.2.bias": (h,)}
    for j in range(3):
        nl[f"model.region_extractor.region_linear.layers.{j}.bias"] = (h,)
    for j in (1, 2):
        nl[f"model.region_extractor.region_linear.layers.{j}.weight"] = (h, h)
    nl = {k: rand(shape, bf16)[2]().cpu() for k, shape in nl.items()}
    written += save_state(torch, nl, lora / "non_lora_trainables.bin")

    cc = CLIP_CONFIG
    p, ffv, grid = cc["patch_size"], cc["intermediate_size"], cc["image_size"] // cc["patch_size"]

    def tower(dtype, temporal: bool):
        e = {"vision_model.embeddings.class_embedding": rand((v,), dtype),
             "vision_model.embeddings.patch_embedding.weight": rand((v, 3, p, p), dtype),
             "vision_model.embeddings.position_embedding.weight": rand((grid ** 2 + 1, v), dtype),
             "vision_model.embeddings.position_ids": (
                 torch.int64, (1, grid ** 2 + 1),
                 lambda: torch.arange(grid ** 2 + 1, dtype=torch.int64)[None]),
             "vision_model.pre_layrnorm.weight": rand((v,), dtype, 1.0),
             "vision_model.pre_layrnorm.bias": rand((v,), dtype)}
        for i in range(cc["num_hidden_layers"]):
            stem = f"vision_model.encoder.layers.{i}"
            attns = ("self_attn", "temporal_attn") if temporal else ("self_attn",)
            for a in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    e[f"{stem}.{a}.{proj}.weight"] = rand((v, v), dtype)
                    e[f"{stem}.{a}.{proj}.bias"] = rand((v,), dtype)
            norms = ("layer_norm1", "layer_norm2") + (("temporal_layer_norm1",) if temporal
                                                      else ())
            for ln in norms:
                e[f"{stem}.{ln}.weight"] = rand((v,), dtype, 1.0)
                e[f"{stem}.{ln}.bias"] = rand((v,), dtype)
            e[f"{stem}.mlp.fc1.weight"] = rand((ffv, v), dtype)
            e[f"{stem}.mlp.fc1.bias"] = rand((ffv,), dtype)
            e[f"{stem}.mlp.fc2.weight"] = rand((v, ffv), dtype)
            e[f"{stem}.mlp.fc2.bias"] = rand((v,), dtype)
            if temporal:
                e[f"{stem}.temporal_embedding"] = rand((1, 8, v), dtype)
        e["vision_model.post_layernorm.weight"] = rand((v,), dtype, 1.0)
        e["vision_model.post_layernorm.bias"] = rand((v,), dtype)
        return e

    clip = root / "clip_vit_l14"
    clip.mkdir()
    (clip / "config.json").write_text(json.dumps(cc))
    written += write_safetensors(clip / "model.safetensors", tower(f32, False))
    lbv = root / "languagebind_video"
    lbv.mkdir()
    (lbv / "config.json").write_text(json.dumps(cc))
    written += save_state(torch, {k: make().cpu() for k, (_, _, make) in tower(f16, True).items()},
                          lbv / "pytorch_model.bin")
    return written


def anon_bytes() -> int:
    """The process's anonymous resident bytes: the `Anonymous:` lines of
    /proc/self/smaps (pages no file backs, or copied out of a private file
    mapping), so a mapped checkpoint's own pages are not in it and a host
    copy of its tensors is. statm's shared field cannot split them: gVisor's
    reads 0."""
    with open("/proc/self/smaps") as fh:
        return 1024 * sum(int(line.split()[1]) for line in fh if line.startswith("Anonymous:"))


class RssPeak:
    """The process's resident set while the block runs, sampled on a
    thread: `before` and `peak` bytes of all of it (/proc/self/statm, every
    20 ms); with `anon`, also `anon_before` and `anon_peak` of its anonymous
    part (`anon_bytes`, every 100 ms: a read of smaps takes milliseconds)."""

    def __init__(self, anon: bool = False):
        self.anon = anon

    def _read(self) -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        import threading

        self.before = self.peak = self._read()
        self.anon_before = self.anon_peak = anon_bytes() if self.anon else 0
        self._stop = threading.Event()

        def sample():
            tick = 0
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, self._read())
                tick += 1
                if self.anon and tick % 5 == 0:
                    self.anon_peak = max(self.anon_peak, anon_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._read())
        if self.anon:
            self.anon_peak = max(self.anon_peak, anon_bytes())


class _LayerView(collections.abc.Mapping):
    """Layer i of an HF state dict as layer 0 of a one-layer model (lazy)."""

    def __init__(self, sd, i: int):
        self.sd, self.i = sd, i

    def _key(self, k: str) -> str:
        return k.replace("model.layers.0.", f"model.layers.{self.i}.", 1)

    def __getitem__(self, k):
        return self.sd[self._key(k)]

    def __contains__(self, k):
        return self._key(k) in self.sd

    def __iter__(self):
        return iter(k.replace(f"model.layers.{self.i}.", "model.layers.0.", 1) for k in self.sd)

    def __len__(self):
        return len(self.sd)


def check_loaded_leaves(torch, system, root) -> list:
    """The card's loaded leaves against the port's own CPU conversion of the
    same tensors, bit for bit: embed, final norm and lm_head, every leaf of
    layers 0 and 31 (the packed int4 projections and their scales, LoRA
    merged), the image tower's embeddings and first layer, the video
    tower's first layer (temporal leaves included), the projector and the
    region extractor. -> the names held."""
    from vitron_tpu_torch.models.llm import loader
    from vitron_tpu_torch.models.vision import loader as vloader
    from vitron_tpu_torch.models.vision import projector, region_extractor

    cpu = torch.device("cpu")
    gen_ = system.engine.generator
    params, cfg = gen_.params, gen_.cfg
    held = []

    def same(name, got, want):
        if isinstance(want, dict):
            for k in want:
                same(f"{name}.{k}", got[k], want[k])
            return
        ok = got.dtype == want.dtype and torch.equal(got.cpu(), want)
        check(ok, f"checkpoint: {name} on the card differs from the CPU conversion")
        held.append(name)

    def layer(tree, i):
        return {k: layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    sd = loader.load_safetensors_dir(root / "vicuna-7b")
    lora_sd, r, alpha = loader.load_lora_dir(root / "vitron_lora")
    one = dataclasses.replace(cfg.llm, num_layers=1)
    pairs = loader.lora_pairs(sd, lora_sd, r=r, alpha=alpha)
    for i in (0, cfg.llm.num_layers - 1):
        stem = f"model.layers.{i}."
        pairs_i = {k.replace(stem, "model.layers.0.", 1): v for k, v in pairs.items()
                   if k.startswith(stem)}
        ref = loader.convert_hf_llama(_LayerView(sd, i), one, cpu, bits=4, lora=pairs_i,
                                      lora_state=lora_sd)
        same(f"llm.layers[{i}]", layer(params["llm"]["layers"], i), layer(ref["layers"], 0))
        if i == 0:
            for k in ("embed", "final_norm", "lm_head"):
                same(f"llm.{k}", params["llm"][k], ref[k])
    for key, d in (("image_tower", "clip_vit_l14"), ("video_tower", "languagebind_video")):
        tcfg = dataclasses.replace(getattr(cfg, key), num_layers=1)
        from vitron_tpu_torch.runtime.assembly import _load_state_dir

        ref = vloader.convert_hf_clip_vision(_load_state_dir(root / d), tcfg, device=cpu)
        got = {k: v for k, v in params[key].items() if k != "layers"}
        same(key, got, {k: v for k, v in ref.items() if k != "layers"})
        same(f"{key}.layers[0]", layer(params[key]["layers"], 0), layer(ref["layers"], 0))
    nl = loader.load_torch_bin(root / "vitron_lora" / "non_lora_trainables.bin")
    same("projector", params["projector"], projector.convert_hf(nl, device=cpu))
    same("region", params["region"], region_extractor.convert_hf(nl, device=cpu))
    return held


def phase_checkpoint(torch, card: str, root):
    """Phase 25: write the synthetic full-width chat deployment under `root`
    (the weights directory phase 27 loads whole), load it with
    `build_mllm_system(..., quantize="int4")` on the card, hold its leaves
    against the CPU conversion, chat twice (128 greedy tokens, exact B1
    launches), hold B1 against its plain version at the loaded prefill's M,
    and chat once over HTTP. -> (the loaded chat's launches, B1's rows)."""
    import base64
    import io
    import pathlib
    import resource
    import urllib.request

    from PIL import Image

    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.apps.serve import serve
    from vitron_tpu_torch.runtime import assembly
    from vitron_tpu_torch.runtime.generation import DEFAULT_DECODE_CHUNK, SamplingConfig

    root = pathlib.Path(root)
    t0 = time.perf_counter()
    written = write_deployment(torch, root, seed=25)
    t_write = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        system, report = assembly.build_mllm_system(
            str(root / "vicuna-7b"), lora=str(root / "vitron_lora"),
            clip_tower=str(root / "clip_vit_l14"),
            video_tower=str(root / "languagebind_video"),
            quantize="int4", mesh="auto", tokenizer=DemoTokenizer(), device="cuda")
        torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    dev_peak = torch.cuda.max_memory_allocated()
    max_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print("checkpoint: report\n" + report.summary(), flush=True)
    print(f"checkpoint: wrote {written} bytes in {t_write:.1f} s under {root}; "
          f"build_mllm_system(quantize='int4') {t_load:.1f} s, host RSS "
          f"{rss.before / 2**30:.2f} GiB before the load and {rss.peak / 2**30:.2f} GiB at "
          f"its peak (sampled every 20 ms; the process's ru_maxrss so far "
          f"{max_rss / 2**30:.2f} GiB), device peak {dev_peak / 2**30:.2f} GiB [{card}]",
          flush=True)
    check(report.loaded() == ["llm", "image_tower", "video_tower", "projector",
                              "region_extractor"]
          and report.rows["mesh"]["status"] == "skipped", f"checkpoint: report {report.rows}")
    t0 = time.perf_counter()
    held = check_loaded_leaves(torch, system, root)
    print(f"checkpoint: {len(held)} leaves bit-equal to the CPU conversion "
          f"({time.perf_counter() - t0:.1f} s): {', '.join(held[:6])}, ... [{card}]",
          flush=True)

    cfg = system.engine.generator.cfg
    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    sampling = SamplingConfig(greedy=True, max_new_tokens=NEW_TOKENS, eos_ids=())
    timed_chat(torch, system, image, sampling)  # warm-up: captures the decode chunk
    reset_launches()
    out1, t_req = timed_chat(torch, system, image, sampling)
    per_forward = 7 * cfg.llm.num_layers + 1
    steps = -(-(NEW_TOKENS - 1) // DEFAULT_DECODE_CHUNK) * DEFAULT_DECODE_CHUNK
    launches = expect_launches({"int4_matmul": per_forward * (1 + steps),
                                "flash_attention": 0}, "checkpoint chat")
    tokens = out1["reply"]["tokens"]
    out2, _ = timed_chat(torch, system, image, sampling)
    _, t_prefill = timed_chat(torch, system, image,
                              SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=()))
    logits = system.engine.generator.last_prefill_logits
    check(len(tokens) == NEW_TOKENS and out2["reply"]["tokens"] == tokens
          and bool(torch.isfinite(logits).all()),
          f"checkpoint chat: {len(tokens)} tokens, the same twice "
          f"{out2['reply']['tokens'] == tokens}, finite logits")
    decode_tok_s = (NEW_TOKENS - 1) / (t_req - t_prefill)
    print(f"checkpoint chat: {len(tokens)} tokens, the same twice; request {t_req:.3f} s, "
          f"prefill request {t_prefill:.3f} s, decode {decode_tok_s:.1f} tok/s [{card}]",
          flush=True)

    # B1 at the M this chat's prefill gives every projection and lm_head
    prepared = system.prepare(PROMPT, image=image, region_box=BBOX)
    m = int(system.engine.plan_turn(prepared["msg"], prepared["media"])[0]
            .token_ids.shape[-1])
    g = torch.Generator(device=torch.device("cuda")).manual_seed(25)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=torch.device("cuda"))
    int4_rows = [int4_row(torch, card, g, m, k, n, flush=flush) for k, n in INT4_SHAPES]
    del flush
    print_sums(f"B1 at the loaded prefill's M {m}", int4_rows, card)

    # 4. one POST /chat: the server's batched, staged path. Its reply
    # against `system.chat` through the same pipeline (the same tokens),
    # the first divergence from the single stream at a near-tie (as
    # phase 6b holds it), and every served token against the single
    # stream fed the served tokens before it
    greedy = SamplingConfig(greedy=True, max_new_tokens=NEW_TOKENS)
    alone = system.chat(PROMPT, image=image, sampling=greedy)["reply"]["tokens"]
    gen_ = system.engine.generator
    slots = gen_.last_chunk.cache.k.shape[2]
    srv = serve(system, host="127.0.0.1", port=0, background=True)
    try:
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        body = json.dumps({"prompt": PROMPT, "image": base64.b64encode(buf.getvalue()).decode(),
                           "greedy": True, "max_new_tokens": NEW_TOKENS}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/chat",
                                     data=body, headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            reply = json.loads(resp.read())
        t_http = time.perf_counter() - t0
        direct = system.chat(PROMPT, image=image, sampling=greedy)["reply"]
    finally:
        srv.shutdown()
        srv.server_close()
        srv.pipeline.close()
    got = [int(w[3:]) for w in reply.get("raw", "").split()]
    check(reply.get("status") == "chat" and reply.get("raw") == direct["raw"]
          and got == direct["tokens"],
          f"checkpoint http: {reply.get('status')}, {reply.get('raw', '')[:80]!r} against "
          f"the direct chat's {direct['raw'][:80]!r}")
    prepared = system.prepare(PROMPT, image=image)
    pl, im, _, _, _ = system.engine.plan_turn(prepared["msg"], prepared["media"])
    first = check_divergence(
        "checkpoint http", got, alone,
        lambda j: stream_logits(torch, gen_, plan_arrays(pl), im.to(gen_.device), alone, j,
                                slots), card)
    held = check_teacher_forced(torch, "checkpoint http", got, gen_, plan_arrays(pl),
                                im.to(gen_.device), slots, card)
    print(f"checkpoint http: POST /chat status {reply.get('status')}, {len(got)} tokens in "
          f"{t_http:.3f} s, the same as system.chat through the server's pipeline; against "
          f"the single stream: {first}; {held} [{card}]", flush=True)
    del system
    torch.cuda.empty_cache()
    return launches, int4_rows


# ------------------------------------------------------- diffusion checkpoints (phase 26)

# the GLIGEN bundle's pickled OmegaConf config: the targets its load_ckpt reads
GLIGEN_CONFIG = {"model": {"target": "ldm.modules.diffusionmodules.openaimodel.UNetModel"},
                 "autoencoder": {"target": "ldm.models.autoencoder.AutoencoderKL"},
                 "text_encoder": {"target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder"},
                 "diffusion": {"target": "ldm.models.diffusion.ldm.LatentDiffusion"}}


def flat_tree(tree, path: str = "") -> dict:
    """{key path: leaf} of a param tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_tree(sub, f"{path}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat_tree(sub, f"{path}{i}/").items()}
    return {path: tree}


def held_leaves(torch, what: str, got, want, cast=None) -> int:
    """Every leaf of `got` bit-equal to `want`'s leaf at the same key path
    (after `cast`), with its dtype and shape. -> the leaves held."""
    g, w = flat_tree(got), flat_tree(want)
    check(g.keys() == w.keys(), f"{what}: key paths differ, e.g. {sorted(g.keys() ^ w.keys())[:4]}")
    bad = []
    for k, t in w.items():
        t = cast(t) if cast else t
        if g[k].dtype != t.dtype or g[k].shape != t.shape or not torch.equal(g[k], t):
            bad.append(k)
    check(not bad, f"{what}: {len(bad)} of {len(w)} leaves differ from the tree written, "
                   f"e.g. {bad[:3]}")
    return len(w)


def loaded_on_card(torch, load):
    """load() on the card -> (its result, seconds, the host's RssPeak, the
    device's peak and the bytes resident before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RssPeak(anon=True) as rss:
        out = load()
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, rss, torch.cuda.max_memory_allocated(), base


HOST_COPY_GIB = 1.0  # anonymous host memory a checkpoint load may add: no copy of the file


def load_line(what: str, t_load: float, rss, dev_peak: int, base: int) -> str:
    """The load's numbers; fails if its anonymous host memory grew by more
    than HOST_COPY_GIB (the file is mapped and each tensor goes to the card
    one at a time, so no host copy of it may be made)."""
    anon = (rss.anon_peak - rss.anon_before) / 2**30
    check(anon <= HOST_COPY_GIB, f"{what}: the load's anonymous host memory grew by "
                                 f"{anon:.2f} GiB (limit {HOST_COPY_GIB}): a host copy")
    return (f"{t_load:.1f} s; host RSS {rss.before / 2**30:.2f} GiB before the load, "
            f"{rss.peak / 2**30:.2f} at its peak (sampled every 20 ms; the file's pages, mapped, "
            f"count in it), its anonymous part {rss.anon_before / 2**30:.2f} -> "
            f"{rss.anon_peak / 2**30:.2f} GiB at its peak (smaps, every 100 ms; "
            f"+{anon:.2f}, limit {HOST_COPY_GIB}); "
            f"device peak {dev_peak / 2**30:.2f} GiB "
            f"({(dev_peak - base) / 2**30:.2f} above the {base / 2**30:.2f} resident before it)")


GLIGEN_BUNDLES = (("generation", False), ("inpainting", True))  # (name, 9-channel UNet)


def write_gligen_bundle(torch, pipe, root, name: str, inpaint: bool):
    """`pipe`'s trees (the 9-channel UNet with `inpaint`, the SD VAE, CLIP-L
    text) as GLIGEN's `name` .pth bundle in fp16 at
    `root`/gligen/gligen_<name>.pth, with a pickled config of a class no
    process can import and keys no converter reads. -> (path, bytes)."""
    from vitron_tpu_torch.models.diffusion import synthetic

    gdir = os.path.join(root, "gligen")
    os.makedirs(gdir, exist_ok=True)
    path = os.path.join(gdir, f"gligen_{name}.pth")
    bundle = synthetic.gligen_bundle(pipe.inpaint_unet_params if inpaint else pipe.unet_params,
                                     pipe.vae_params, pipe.text_params, pipe.cfg, inpaint,
                                     dtype=torch.float16)
    leaves = [t for t in tree_leaves(bundle) if isinstance(t, torch.Tensor)]
    return path, disk_write(path, nbytes(*leaves), lambda p: synthetic.save_with_absent_config(
        bundle, p, **GLIGEN_CONFIG))


def write_t2v_pth(torch, pipe, root):
    """`pipe`'s UNetSD_T2V as an fp16 .pth state dict in the reference's
    layout at `root`/t2v/text2video_pytorch_model.pth. -> (path, bytes)."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video
    from vitron_tpu_torch.models.diffusion.layers import KeyMap
    from vitron_tpu_torch.models.diffusion.synthetic import reference_state_dict

    os.makedirs(os.path.join(root, "t2v"))
    path = os.path.join(root, "t2v", "text2video_pytorch_model.pth")
    return path, save_state(torch, reference_state_dict(
        unet_sd_video.convert_torch(KeyMap(), pipe.cfg.unet), pipe.unet_params,
        dtype=torch.float16), path)


def phase_gligen_checkpoints(torch, card: str, pipe, root):
    """Phase 26 (a): `pipe`'s trees (task A's UNet, the 9-channel UNet, the
    SD VAE and CLIP-L text) written as GLIGEN's two .pth bundles in fp16
    under `root`/gligen/ (kept for phase 27), one at a time (each with a
    pickled config of a class no process can import and keys no converter
    reads), loaded on the card by `load_gligen_checkpoint`, every leaf held
    bit-equal to the tree rounded to fp16. -> the GligenPipeline on the
    loaded (float32) trees, which phases 10, 11 and 11b route through."""
    from vitron_tpu_torch.models.diffusion import synthetic
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import (GligenPipeline,
                                                                   load_gligen_checkpoint)

    dev = torch.device("cuda")
    cfg = pipe.cfg
    loaded = {}
    for name, inpaint in GLIGEN_BUNDLES:
        unet = pipe.inpaint_unet_params if inpaint else pipe.unet_params
        t0 = time.perf_counter()
        path, written = write_gligen_bundle(torch, pipe, root, name, inpaint)
        t_write = time.perf_counter() - t0
        trees, t_load, rss, dev_peak, base = loaded_on_card(
            torch, lambda: load_gligen_checkpoint(path, cfg, inpaint=inpaint, device=dev))
        check(synthetic.ABSENT_MODULE not in sys.modules,
              "GLIGEN bundle: the load imported the config's module")
        n = sum(held_leaves(torch, f"GLIGEN {name} bundle: {part}", got, want,
                            cast=lambda t: t.to(torch.float16).float())
                for part, got, want in zip(("UNet", "VAE", "text"), trees,
                                           (unet, pipe.vae_params, pipe.text_params)))
        print(f"phase 26 (a) GLIGEN {name} bundle ({9 if inpaint else 4}-channel UNet, SD "
              f"VAE, CLIP-L text, fp16; a pickled config of a class not importable, "
              f"keys no converter reads): wrote {written} bytes in {t_write:.1f} s; "
              f"load_gligen_checkpoint on the card "
              f"{load_line(f'GLIGEN {name} bundle', t_load, rss, dev_peak, base)}; "
              f"{n} leaves bit-equal to the trees written, rounded to fp16 [{card}]",
              flush=True)
        loaded[name] = trees
    unet, vae_p, text = loaded["generation"]
    return GligenPipeline(cfg, unet, vae_p, text, inpaint_unet_params=loaded["inpainting"][0],
                          tokenizer=pipe.tokenizer)


def phase_t2v_checkpoint(torch, card: str, pipe, root):
    """Phase 26 (b): `pipe`'s UNetSD_T2V written as an fp16 .pth state dict
    (the reference's layout) under `root`/t2v/ (kept for phase 27), loaded
    on the card by `unet_sd_video.convert_torch` (mapped, each tensor
    widened there), every leaf held bit-equal to the tree written rounded to
    fp16; `pipe` then runs on the loaded UNet (phase 15)."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video
    from vitron_tpu_torch.models.llm.loader import load_torch_pth

    dev = torch.device("cuda")
    ucfg = pipe.cfg.unet
    t0 = time.perf_counter()
    path, written = write_t2v_pth(torch, pipe, root)
    t_write = time.perf_counter() - t0
    unet, t_load, rss, dev_peak, base = loaded_on_card(
        torch, lambda: unet_sd_video.convert_torch(load_torch_pth(path), ucfg, device=dev))
    n = held_leaves(torch, "t2v .pth", unet, pipe.unet_params,
                    cast=lambda t: t.to(torch.float16).float())
    print(f"phase 26 (b) UNetSD_T2V .pth ({nbytes(*tree_leaves(unet)) / 4e9:.3f}B params, fp16): wrote "
          f"{written} bytes in {t_write:.1f} s; convert_torch on the card "
          f"{load_line('t2v .pth', t_load, rss, dev_peak, base)}; {n} leaves bit-equal to the "
          f"tree written, rounded to fp16 [{card}]", flush=True)
    pipe.unet_params = unet


def held_conversion(torch, card: str, what: str, tree, write, convert):
    """Phase 26 (c)-(e): `tree` written by write() as an in-memory state dict
    in the reference's layout on the card, read back by convert() on the
    card, every leaf held bit-equal; seconds printed. -> the converted tree
    (the tree's path then runs on it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = write(tree)
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = convert(sd)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    del sd
    n = held_leaves(torch, what, out, tree)
    print(f"phase 26 {what}: {n} leaves, {nbytes(*tree_leaves(tree))} bytes; written out in the "
          f"reference's layout on the card in {t_write:.2f} s, converted back in {t_conv:.2f} s, "
          f"bit-equal [{card}]", flush=True)
    return out


def phase_i2v_conversion(torch, card: str, pipe) -> None:
    """Phase 26 (c): the i2vgen UNet (`UNetSDVideoConfig.i2vgen_xl()`, with
    its image streams) through `unet_sd_video.convert_torch`; task G (phase
    15b) runs on the converted tree."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video
    from vitron_tpu_torch.models.diffusion.layers import KeyMap
    from vitron_tpu_torch.models.diffusion.synthetic import reference_state_dict

    dev = torch.device("cuda")
    ucfg = pipe.cfg.unet
    pipe.unet_params = held_conversion(
        torch, card, "(c) UNetSD_I2VGen", pipe.unet_params,
        lambda t: reference_state_dict(unet_sd_video.convert_torch(KeyMap(), ucfg), t,
                                       device=dev),
        lambda sd: unet_sd_video.convert_torch(sd, ucfg, device=dev))


def phase_task_f_conversions(torch, card: str, editor, nets) -> None:
    """Phase 26 (d): task F's checkpoints: the ControlLDM bundle (the SD v1.5
    UNet, the canny ControlNet, the VAE and the text encoder in one dict
    under their four prefixes), the depth ControlNet, DPT-hybrid and the
    four IMLP atlas nets, each through its converter; the editor and the
    nets (`nets`, in place; task F's atlas bundle is made from them) then
    run on the converted trees (phase 15c)."""
    from vitron_tpu_torch.models.diffusion import clip_text, controlnet, depth, unet2d, vae
    from vitron_tpu_torch.models.diffusion import stablevideo as sv
    from vitron_tpu_torch.models.diffusion.layers import KeyMap
    from vitron_tpu_torch.models.diffusion.synthetic import (controlldm_state_dict,
                                                             imlp_state_dict,
                                                             reference_state_dict)

    dev = torch.device("cuda")
    ucfg, vcfg, tcfg = editor.unet_cfg, editor.vae_cfg, editor.text_cfg
    ldm = held_conversion(
        torch, card, "(d) ControlLDM canny bundle (UNet, ControlNet, VAE, text)",
        {"unet": editor.unet_params, "control": editor.control_params,
         "vae": editor.vae_params, "text": editor.text_params},
        lambda t: controlldm_state_dict(t["unet"], t["control"], t["vae"], t["text"], ucfg, vcfg,
                                        tcfg, device=dev),
        lambda sd: {"unet": unet2d.convert_ldm_unet(sd, ucfg, device=dev),
                    "control": controlnet.convert_torch(sd, ucfg, device=dev),
                    "vae": vae.convert_ldm_vae(sd, vcfg, device=dev),
                    "text": clip_text.convert_hf_clip_text(sd, tcfg, device=dev)})
    editor.unet_params, editor.control_params = ldm["unet"], ldm["control"]
    editor.vae_params, editor.text_params = ldm["vae"], ldm["text"]
    editor.depth_control_params = held_conversion(
        torch, card, "(d) depth ControlNet", editor.depth_control_params,
        lambda t: reference_state_dict(controlnet.convert_torch(KeyMap(), ucfg), t,
                                       "control_model.", device=dev),
        lambda sd: controlnet.convert_torch(sd, ucfg, device=dev))
    dpt, dcfg = editor.depth_annotator
    editor.depth_annotator = (held_conversion(
        torch, card, "(d) DPT-hybrid", dpt,
        lambda t: reference_state_dict(depth.convert_midas_torch(KeyMap(), dcfg), t, "model.",
                                       device=dev),
        lambda sd: depth.convert_midas_torch(sd, dcfg, device=dev)), dcfg)
    for name in sorted(nets):
        nets[name] = held_conversion(torch, card, f"(d) IMLP {name} net", nets[name],
                                     lambda t: imlp_state_dict(t, device=dev),
                                     lambda sd: sv.convert_imlp_torch(sd, device=dev))


def grounding_conversions(torch, card: str, nets: dict) -> dict:
    """Phase 26 (e): the grounding nets of phase 11b (c) through their
    converters (the hint net in its canny and sem forms, the keypoint net
    under 'position_net.', the two downsamplers under 'downsample_net.'):
    -> the converted nets, which 11b (c) runs."""
    from vitron_tpu_torch.models.diffusion import grounding_nets as gn
    from vitron_tpu_torch.models.diffusion.layers import KeyMap
    from vitron_tpu_torch.models.diffusion.synthetic import reference_state_dict

    dev = torch.device("cuda")
    convert = {"hint": gn.convert_hint_position_net, "sem": gn.convert_hint_position_net,
               "keypoint": gn.convert_keypoint_position_net,
               "canny_down": gn.convert_grounding_downsampler,
               "sem_down": gn.convert_grounding_downsampler}
    pfx = {"hint": "position_net.", "sem": "position_net.", "keypoint": "position_net.",
           "canny_down": "downsample_net.", "sem_down": "downsample_net."}
    return {name: held_conversion(
        torch, card, f"(e) grounding {name}", tree,
        lambda t, name=name: reference_state_dict(convert[name](KeyMap(), ""), t, pfx[name],
                                                  device=dev),
        lambda sd, name=name: convert[name](sd, pfx[name], device=dev))
        for name, tree in nets.items()}


# --------------------------------------------------- the deployment from one directory (27)

WEIGHTS_STEPS = 2          # phase 27's sampler steps for A, C, D, G (cut: their depth is 10-50)
WEIGHTS_D_FRAMES = 8       # task D's frames in phase 27 (cut from 24: all backends are resident)
WEIGHTS_G_FRAMES = 4       # task G's (cut from 16)
WEIGHTS_CHAT_TOKENS = 32   # the greedy chat turn's new tokens
WEIGHTS_VIDEO = "bear"     # the NLA checkpoint's video name
NLA_FRAMES = 70            # its config.json's maximum_number_of_frames (a DAVIS clip's)


def saved(what: str, card: str, root, rel: str, write) -> int:
    """write(`root`/`rel`) (a `disk_write` that returns the file's bytes),
    its bytes and seconds printed. -> bytes."""
    path = os.path.join(root, rel)
    t0 = time.perf_counter()
    n = write(path)
    dt = time.perf_counter() - t0
    print(f"phase 27 wrote {what}: {rel}, {n} bytes in {dt:.1f} s [{card}]", flush=True)
    return n


def write_text_encoder(torch, card: str, root, rel: str, tree, tcfg) -> int:
    """An HF CLIPTextModel dir: config.json and model.safetensors (fp16,
    'text_model.' keys, `write_safetensors`: the card has no safetensors)."""
    from vitron_tpu_torch.models.diffusion import clip_text
    from vitron_tpu_torch.models.diffusion.layers import KeyMap
    from vitron_tpu_torch.models.diffusion.synthetic import reference_state_dict

    os.makedirs(os.path.join(root, rel))
    with open(os.path.join(root, rel, "config.json"), "w") as fh:
        json.dump({"architectures": ["CLIPTextModel"], "vocab_size": tcfg.vocab_size,
                   "hidden_size": tcfg.hidden_size, "num_hidden_layers": tcfg.num_layers,
                   "num_attention_heads": tcfg.num_heads,
                   "intermediate_size": tcfg.intermediate_size,
                   "max_position_embeddings": tcfg.max_length, "hidden_act": "gelu"}, fh)
    sd = reference_state_dict(clip_text.convert_hf_clip_text(KeyMap(), tcfg), tree, "text_model.",
                              dtype=torch.float16)
    return saved("an HF CLIPTextModel (fp16)", card, root, rel + "/model.safetensors",
                 lambda path: write_safetensors(path, {k: (t.dtype, tuple(t.shape),
                                                           lambda t=t: t)
                                                       for k, t in sd.items()}))


def write_backends(torch, card: str, root, seed: int) -> int:
    """Phase 27's files beside phases 25 and 26's, from random trees made
    on the card at `seed`, fp16 (the IMLP nets float32): seem_focall_v1.pt,
    i2vgen/ (the UNet .pth), t2v/text_encoder/ (i2vgen/text_encoder links
    to it), stablevideo/ (ControlLDM canny bundle, depth ControlNet,
    DPT-hybrid, one NLA checkpoint). -> bytes written."""
    from vitron_tpu_torch.models.diffusion import clip_text, controlnet, depth, unet_sd_video
    from vitron_tpu_torch.models.diffusion import synthetic
    from vitron_tpu_torch.models.diffusion.layers import KeyMap
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig
    from vitron_tpu_torch.models.seem.model import SeemConfig

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    written = 0
    f16 = torch.float16
    cfg = SeemConfig()
    sd = synthetic.seem_state_dict(build_seem_params(torch, cfg, dev, seed), cfg, dtype=f16)
    written += saved("SEEM FocalNet-L (fp16)", card, root, "seem_focall_v1.pt",
                     lambda path: save_state(torch, sd, path))
    del sd
    ucfg = unet_sd_video.UNetSDVideoConfig.i2vgen_xl()
    unet = synthetic.fill_zero_leaves(unet_sd_video.init_params(g, ucfg, dev), g)
    sd = synthetic.reference_state_dict(unet_sd_video.convert_torch(KeyMap(), ucfg), unet,
                                        dtype=f16)
    del unet
    os.makedirs(os.path.join(root, "i2vgen"))
    written += saved("UNetSD_I2VGen (fp16)", card, root, "i2vgen/i2vgen_xl_pytorch_model.pth",
                     lambda path: save_state(torch, sd, path))
    del sd
    # one OpenCLIP ViT-H text encoder, as upstream's t2v and i2vgen share it:
    # i2vgen/text_encoder links to t2v's
    tcfg = Text2VideoConfig().text
    text = synthetic.fill_zero_leaves(clip_text.init_params(g, tcfg, dev), g)
    written += write_text_encoder(torch, card, root, "t2v/text_encoder", text, tcfg)
    os.symlink(os.path.join("..", "t2v", "text_encoder"),
               os.path.join(root, "i2vgen", "text_encoder"))
    torch.cuda.empty_cache()
    editor, nets = build_task_f(torch, dev, seed)
    sv_dir = os.path.join(root, "stablevideo")
    os.makedirs(os.path.join(sv_dir, WEIGHTS_VIDEO))
    sd = synthetic.controlldm_state_dict(editor.unet_params, editor.control_params,
                                         editor.vae_params, editor.text_params, editor.unet_cfg,
                                         editor.vae_cfg, editor.text_cfg, dtype=f16)
    written += saved("ControlLDM canny bundle (fp16)", card, root,
                     "stablevideo/control_sd15_canny.pth",
                     lambda path: save_state(torch, sd, path))
    sd = synthetic.reference_state_dict(controlnet.convert_torch(KeyMap(), editor.unet_cfg),
                                        editor.depth_control_params, "control_model.", dtype=f16)
    written += saved("depth ControlNet (fp16)", card, root,
                     "stablevideo/control_sd15_depth.pth",
                     lambda path: save_state(torch, sd, path))
    dpt, dcfg = editor.depth_annotator
    sd = synthetic.reference_state_dict(depth.convert_midas_torch(KeyMap(), dcfg), dpt, "model.",
                                        dtype=f16)
    written += saved("DPT-hybrid (fp16)", card, root,
                     "stablevideo/dpt_hybrid-midas-501f0c75.pt",
                     lambda path: save_state(torch, sd, path))
    sd = {"model_F_mapping1_state_dict": synthetic.imlp_state_dict(nets["fg"]),
          "model_F_mapping2_state_dict": synthetic.imlp_state_dict(nets["bg"]),
          "model_F_alpha_state_dict": synthetic.imlp_state_dict(nets["alpha"]),
          "F_atlas_state_dict": synthetic.imlp_state_dict(nets["atlas"])}
    with open(os.path.join(sv_dir, WEIGHTS_VIDEO, "config.json"), "w") as fh:
        json.dump({"maximum_number_of_frames": NLA_FRAMES}, fh)
    written += saved("NLA atlas checkpoint (float32)", card, root,
                     f"stablevideo/{WEIGHTS_VIDEO}/checkpoint",
                     lambda path: save_state(torch, sd, path))
    del sd, editor, nets
    torch.cuda.empty_cache()
    return written


def backend_of(system, task: str, cls):
    """The `cls` object that `system`'s task handler closes over (the
    registered pipeline or editor)."""
    for cell in system.registry._handlers[task].__closure__ or ():
        if isinstance(cell.cell_contents, cls):
            return cell.cell_contents
    raise AssertionError(f"task {task}: no {cls.__name__} in its handler")


def phase_weights(torch, card: str, root):
    """Phase 27 (see the module docstring). -> every kernel's launches
    summed over the phase's runs."""
    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.models.diffusion import gligen_pipeline as gp
    from vitron_tpu_torch.models.diffusion import stablevideo as sv
    from vitron_tpu_torch.models.diffusion import video_pipelines as vp
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, StubImageEmbedder
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig
    from vitron_tpu_torch.models.llm.loader import load_torch_pth
    from vitron_tpu_torch.models.seem import model as seem_model
    from vitron_tpu_torch.runtime import assembly
    from vitron_tpu_torch.runtime.generation import SamplingConfig

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    written = write_backends(torch, card, root, seed=27)
    print(f"phase 27: wrote {written} bytes in {time.perf_counter() - t0:.1f} s; the directory "
          f"holds {sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)} "
          f"bytes with phases 25 and 26's files; this process has written {disk_written} bytes "
          f"of files, of its budget of {WRITE_BUDGET_BYTES} [{card}]", flush=True)

    seem_trees = []
    convert = seem_model.convert_torch

    def recording(sd, cfg, device):
        seem_trees.append(convert(sd, cfg, device=device))
        return seem_trees[-1]

    torch.cuda.empty_cache()
    with mock.patch.object(seem_model, "convert_torch", recording):
        (system, report), t_load, rss, dev_peak, base = loaded_on_card(
            torch, lambda: assembly.build_system_from_weights(
                str(root), quantize="int4", device="cuda", tokenizer=DemoTokenizer(),
                clip_tokenizer=StubClipTokenizer(49408),
                image_embedder=StubImageEmbedder(UNetSDVideoConfig.i2vgen_xl().y_dim, 27)))
    print("phase 27: report\n" + report.summary(), flush=True)
    print(f"phase 27: build_system_from_weights(quantize='int4') on the card "
          f"{load_line('phase 27 deployment', t_load, rss, dev_peak, base)} [{card}]", flush=True)
    print(f"phase 27: memory plan ({'fits' if system.memory_plan.fits else 'OVER budget'}), "
          f"device resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]\n"
          + system.memory_plan.report(), flush=True)
    check(set(report.loaded()) == {"llm", "image_tower", "video_tower", "projector",
                                   "region_extractor", "clip_tokenizer", "seem", "gligen", "t2v",
                                   "i2vgen", "stablevideo"},
          f"phase 27: not every component loaded:\n{report.summary()}")
    check(set(system.registry.available()) == set("ABCDEFG"),
          f"phase 27: tasks {sorted(system.registry.available())}")
    scfg = seem_model.SeemConfig()
    t0 = time.perf_counter()
    n = held_leaves(torch, "phase 27 SEEM", seem_trees[0],
                    seem_model.convert_torch(load_torch_pth(os.path.join(root,
                                                                         "seem_focall_v1.pt")),
                                             scfg, device="cpu"), cast=lambda t: t.to(dev))
    del seem_trees[:]
    torch.cuda.empty_cache()
    print(f"phase 27: SEEM's {n} converted leaves on the card bit-equal to the CPU's conversion "
          f"of the same file ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)

    total = collections.Counter()
    torch.cuda.reset_peak_memory_stats()
    image = np.random.RandomState(0).randint(0, 256, (480, 640, 3), np.uint8)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.chat(PROMPT, image=image, sampling=SamplingConfig(
        greedy=True, max_new_tokens=WEIGHTS_CHAT_TOKENS, eos_ids=()))
    torch.cuda.synchronize()
    t_chat = time.perf_counter() - t0
    launches = read_launches()
    total.update(launches)
    check(out["status"] == "chat" and len(out["reply"]["tokens"]) == WEIGHTS_CHAT_TOKENS
          and launches["int4_matmul"] > 0,
          f"phase 27 chat: {out['status']}, {len(out['reply']['tokens'])} tokens, {launches}")
    print(f"phase 27 chat: {WEIGHTS_CHAT_TOKENS} greedy tokens in {t_chat:.3f} s (the first "
          f"request: its decode graph is captured here), B1 launches {launches['int4_matmul']}; "
          f"the random model's reply routes no task, so the protocol replies below are routed "
          f"through VitronSystem.route [{card}]", flush=True)

    def routed(name: str, reply: str, want, check_out, **media):
        reset_launches()
        out, t_req = timed_route(torch, system, reply, **media)
        got = read_launches()
        if isinstance(want, dict):
            expect_launches(want, f"phase 27 task {name}")
        else:
            check(all(got[k] > 0 for k in want), f"phase 27 task {name}: no launch of one of "
                                                 f"{want}: {got}")
            print(f"phase 27 task {name}: launches {got} (each of {list(want)} > 0)", flush=True)
        total.update(got)
        check(out["status"] == "ok", f"phase 27 task {name}: {out['status']}, {out.get('error')}")
        what = check_out(out)
        print(f"phase 27 task {name}: request {t_req:.3f} s, {what} [{card}]", flush=True)

    def mask_out(out):
        m = out["mask"]
        check(m.shape == (480, 640) and bool(m.any()) and not bool(m.all()),
              "phase 27 task B: the mask is constant")
        return f"mask {m.shape} covers {m.mean():.3f}"

    def media_out(key, shape):
        def out_ok(out):
            x = out[key]
            check(x.shape == shape and x.dtype == np.uint8 and int(x.max()) != int(x.min()),
                  f"phase 27: {key} {x.shape} {x.dtype}, constant {int(x.max()) == int(x.min())}")
            return f"{key} {x.shape} mean {x.mean():.2f} std {x.std():.2f}"
        return out_ok

    per = seem_counts(scfg)
    routed("B (text, full depth)", TASK_B_REPLY, per, mask_out, image=image)
    frames = 8
    video = np.random.RandomState(4).randint(0, 256, (frames, 480, 640, 3), np.uint8)

    def tracks(out):
        m = out["masks"]
        check(m.shape == (frames, scfg.input_size // 4, scfg.input_size // 4)
              and bool(m.any()) and not bool(m.all()), f"phase 27 task E: masks {m.shape}")
        return f"{frames} frames, masks {m.shape} cover {m.mean():.3f}"

    routed("E (8 frames, full depth)", TASK_E_REPLY, {k: (frames + 1) * v for k, v in per.items()},
           tracks, video=video, sketch_mask=stroke_mask(480, 640))

    gpipe = backend_of(system, "A", gp.GligenPipeline)
    gpipe.cfg = gcfg = dataclasses.replace(gpipe.cfg, steps=WEIGHTS_STEPS)
    unet = unet_counts(gcfg.unet, gcfg.latent_size, gcfg.max_objs, gcfg.text.max_length)
    enc, dec = vae_counts(gcfg.vae, gcfg.latent_size ** 2)
    routed(f"A ({WEIGHTS_STEPS} PLMS steps: cut)", TASK_A_REPLY,
           {k: (gcfg.steps + 1) * unet[k] + dec[k] for k in unet},
           media_out("image", (gcfg.image_size, gcfg.image_size, 3)))
    unet9 = unet_counts(dataclasses.replace(gcfg.unet, in_channels=9), gcfg.latent_size,
                        gcfg.max_objs, gcfg.text.max_length)
    routed(f"C ({WEIGHTS_STEPS} PLMS steps: cut, region branch)", TASK_C_REPLY,
           {k: (gcfg.steps + 1) * unet9[k] + enc[k] + dec[k] for k in unet9},
           media_out("image", (gcfg.image_size, gcfg.image_size, 3)), image=image)

    tpipe = backend_of(system, "D", vp.Text2VideoPipeline)
    tpipe.cfg = tcfg = dataclasses.replace(tpipe.cfg, steps=WEIGHTS_STEPS,
                                           num_frames=WEIGHTS_D_FRAMES)
    lh, lw = tcfg.latent_hw
    per_call = video_counts(tcfg.unet, lh, lw, tcfg.text.max_length)
    _, dec = vae_counts(tcfg.vae, lh * lw)
    routed(f"D ({WEIGHTS_STEPS} DDIM-v steps, {WEIGHTS_D_FRAMES} frames: cut)", TASK_D_REPLY,
           {k: tcfg.steps * per_call[k] + dec.get(k, 0) for k in per_call},
           media_out("video", (tcfg.num_frames, tcfg.height, tcfg.width, 3)))

    ipipe = backend_of(system, "G", vp.Image2VideoPipeline)
    ipipe.cfg = icfg = dataclasses.replace(ipipe.cfg, steps=WEIGHTS_STEPS,
                                           num_frames=WEIGHTS_G_FRAMES)
    ls = icfg.latent_size
    per_call = video_counts(icfg.unet, ls, ls, i2v_context(icfg.unet, icfg.text.max_length))
    enc, dec = vae_counts(icfg.vae, ls * ls)
    routed(f"G ({WEIGHTS_STEPS} DDIM-v steps, {WEIGHTS_G_FRAMES} frames: cut)", TASK_G_REPLY,
           {k: icfg.steps * per_call[k] + enc.get(k, 0) + dec.get(k, 0) for k in per_call},
           media_out("video", (icfg.num_frames, icfg.size, icfg.size, 3)), image=image)

    backend_of(system, "F", sv.StableVideoEditor)
    routed("F (a one-frame 448x768 video, one keyframe: cut)", TASK_F_REPLY,
           ("flash_attention", "geglu_ff", "group_norm_sums"),
           media_out("video", (1,) + TASK_F_HW + (3,)),
           video=np.zeros((1,) + TASK_F_HW + (3,), np.uint8))
    print(f"phase 27: device peak during the requests {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, the deployment resident; launches summed over the phase {dict(total)} [{card}]",
          flush=True)
    # the system and its handlers hold each other (a cycle): collect it
    # before the card's memory is handed back
    del system, gpipe, tpipe, ipipe
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left <= base + 2 ** 30, f"phase 27: {left / 2**30:.2f} GiB allocated after the "
                                  f"deployment was dropped, {base / 2**30:.2f} before its load")
    return dict(total)


# --------------------------------------------- MPT and the W4A8 / W8A8 variants

# mosaicml/mpt-7b's published widths (its config.json): d_model 4096, 32
# heads, 32 layers, expansion 4, vocab 50432, ALiBi, no bias, bf16
MPT_7B = dict(vocab_size=50432, d_model=4096, n_heads=32, n_layers=32, expansion_ratio=4,
              max_seq_len=2048)
MPT_PREFILL = 512
MPT_NEW = 64
MPT_PREFIX = 256  # prompt positions of the prefix-LM prefill
MPT_CPU_LAYERS = 2
MPT_CPU_PROMPT = 32
MPT_CPU_NEW = 8
W4A8_CPU_NEW = 8  # phase 29 (b)'s greedy tokens on the CPU (~2-3 s each there)
W4A8_EAGER_NEW = 33  # the eager steps (~15 tok/s) against the graphed scan: 32 of them
# the 2-layer W4A8 prefill's logits on the CPU and the card: float32 on both
# and exact int32 sums, but each activation row is rounded to int8 from
# float layers summed in other orders, and a flipped level moves its row's
# product by ~5e-4 (one of ~30 levels over sqrt(K) = 64 terms)
W4A8_CPU_GPU_TOL = 1e-2
W8A8_TASK_A_STEPS = 5   # phase 30's PLMS steps for the quantized task A (phase 10 runs 50)
W8A8_TASK_D_STEPS = 2   # and DDIM-v steps for the quantized task D (phase 15 runs 5)
# Q1 and Q2 against their plain versions at each output row / pixel's
# scale: the int32 sums are exact on both sides, so float32 outputs are
# bit-equal and a bf16 output may flip one rounding, 2^-7 of the value
Q_ROW_REL = {"float32": 0.0, "bfloat16": 2 ** -7}
# A tiny quantized UNet's whole forward on the CPU and the card. Each
# quantized product is held bit-equal from the same inputs; the whole nets
# differ by flips: an ulp of the float layers' other summation order moves
# an activation across a rounding boundary, one int8 level, and the later
# layers compound it (measured 5.6e-3 and 2.1e-2 for the tiny SD net in two
# card runs, 3.7e-2 between JAX and the port for the t2v net). 2^-3 still
# fails a dropped tap (0.5) or a wrong scale's sign.
W8A8_CPU_GPU_TOL = 2 ** -3


def sd_w8a8_sites(ucfg, latent: int, batch: int, min_channels: int = 64) -> collections.Counter:
    """((B, H, W, C), Co, stride, padding) of every conv of one SD UNet call
    that `unet2d.quantize_params(min_channels)` sends to Q2, with its count,
    from the block plan: the res blocks' two 3x3 convs, the stride-2
    downsamples at their input size, the upsamples' convs at the doubled
    size (conv_in and the out conv, 4 or 9 channels wide, stay float)."""
    from vitron_tpu_torch.models.diffusion.unet2d import block_plan

    sites = collections.Counter()

    def add(h, w, c, co, stride=1):
        if c >= min_channels and co >= min_channels:
            sites[((batch, h, w, c), co, stride, 1)] += 1

    h = w = latent
    input_plan, middle_plan, output_plan = block_plan(ucfg)
    for entries in input_plan + [middle_plan] + output_plan:
        for e in entries:
            if e[0] == "conv_in":
                add(h, w, e[1], e[2])
            elif e[0] == "res":
                add(h, w, e[1], e[2])
                add(h, w, e[2], e[2])
            elif e[0] == "down":
                add(h, w, e[1], e[1], 2)
                h, w = (h + 1) // 2, (w + 1) // 2
            elif e[0] == "up":
                h, w = 2 * h, 2 * w
                add(h, w, e[1], e[1])
    add(latent, latent, ucfg.model_channels, ucfg.out_channels)
    return sites


def video_w8a8_sites(ucfg, lh: int, lw: int, batch: int,
                     min_channels: int = 64) -> collections.Counter:
    """The same for one video UNet call on `batch` folded frames at an
    lh x lw latent (`unet_sd_video.quantize_params(min_channels)`)."""
    from vitron_tpu_torch.models.diffusion.unet_sd_video import block_plan_hw

    sites = collections.Counter()

    def add(h, w, c, co, stride=1):
        if c >= min_channels and co >= min_channels:
            sites[((batch, h, w, c), co, stride, 1)] += 1

    cur = (lh, lw)
    for e, h, w in block_plan_hw(ucfg, lh, lw):
        if e[0] == "conv_in":
            add(h, w, e[1], e[2])
        elif e[0] == "res":
            add(h, w, e[1], e[2])
            add(h, w, e[2], e[2])
        elif e[0] == "down":
            add(*cur, e[1], e[1], 2)
        elif e[0] == "up":
            add(2 * h, 2 * w, e[1], e[1])
        cur = (2 * h, 2 * w) if e[0] == "up" else (h, w)
    add(lh, lw, ucfg.dim, ucfg.out_dim)
    return sites


def w8a8_sites() -> collections.Counter:
    """Every Q2 site of phase 30's two quantized UNets: task A's SD v1.4
    GLIGEN UNet (CFG batch 2 at 64x64) and task D's t2v UNet (2 x 24 frames
    at 40x72), with the count of one CFG call each."""
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

    a, d = GligenConfig(), Text2VideoConfig()
    return (sd_w8a8_sites(a.unet, a.latent_size, 2)
            + video_w8a8_sites(d.unet, *VIDEO_LATENT, 2 * VIDEO_FRAMES))


def phase_mpt(torch, card: str):
    """Phase 28: MPT-7B's published widths, bf16, random weights from a seed
    on the card: a 512-token cached prefill and 64 greedy cached tokens
    (prefill s, tok/s, peak GiB), a prefix-LM prefill, and no kernel
    launched (MPT has none). Then the CPU against the card at 2 layers of
    the same widths in float32: the prefill's logits within CPU_GPU_TOL
    and the same greedy tokens."""
    from vitron_tpu_torch.models.llm import mpt

    dev = torch.device("cuda")
    cfg = mpt.MPTConfig(**MPT_7B)
    g = torch.Generator(device=dev).manual_seed(28)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = mpt.init_params(g, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"mpt: MPT-7B ({n_params / 1e9:.3f}B params, bf16) random weights built on the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    ids = torch.randint(0, cfg.vocab_size, (1, MPT_PREFILL), generator=g, device=dev)
    mpt.forward(params, cfg, ids[:, :16])  # warm-up (library handles, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cache = mpt.kv_cache(cfg, 1, MPT_PREFILL + MPT_NEW, dev)
    t0 = time.perf_counter()
    logits, cache = mpt.forward(params, cfg, ids, cache=cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "mpt: prefill logits are not finite")
    tok = logits[:, -1].argmax(-1, keepdim=True)
    toks = []
    t0 = time.perf_counter()
    for _ in range(MPT_NEW):
        toks.append(tok)
        logits, cache = mpt.forward(params, cfg, tok, cache=cache)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.cat(toks, 1)[0].tolist()
    check(bool(torch.isfinite(logits).all()) and cache.index == MPT_PREFILL + MPT_NEW
          and all(0 <= t < cfg.vocab_size for t in tokens),
          f"mpt: decode logits finite, cache at {cache.index}, tokens in the vocabulary")
    launches = expect_launches({name: 0 for name, _, _ in _counters()}, "mpt")
    print(f"mpt_prefill_s={t_prefill:.4f} ({MPT_PREFILL} tokens, cached) "
          f"mpt_decode_tok_s={MPT_NEW / t_decode:.2f} ({MPT_NEW} greedy cached tokens, eager, "
          f"einsum attention with the ALiBi bias) peak {peak / 2**30:.2f} GiB, "
          f"{(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} resident before the "
          f"weights; tokens {tokens[:8]}... [{card}]", flush=True)

    causal = mpt.forward(params, cfg, ids)
    prefix = torch.zeros_like(ids, dtype=torch.bool)
    prefix[:, :MPT_PREFIX] = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plm = mpt.forward(params, cfg, ids, prefix_mask=prefix)
    torch.cuda.synchronize()
    t_plm = time.perf_counter() - t0
    moved = (plm[0, 0] - causal[0, 0]).abs().max().item()
    check(bool(torch.isfinite(plm).all()) and moved > 0,
          f"mpt: prefix-LM logits finite and the first row moved ({moved})")
    print(f"mpt: prefix-LM prefill ({MPT_PREFILL} tokens, the first {MPT_PREFIX} "
          f"bidirectional) {t_plm:.4f} s, finite; the first position's logits move by "
          f"{moved:.4f} from the causal prefill's [{card}]", flush=True)
    del params, cache, logits, causal, plm
    torch.cuda.empty_cache()

    f32 = torch.float32
    small = dataclasses.replace(cfg, n_layers=MPT_CPU_LAYERS, param_dtype=f32, compute_dtype=f32)
    cpu = torch.device("cpu")
    p_cpu = mpt.init_params(torch.Generator().manual_seed(29), small, cpu)
    p_dev = tree_map(lambda a: a.to(dev), p_cpu)
    prompt = torch.randint(0, small.vocab_size, (1, MPT_CPU_PROMPT),
                           generator=torch.Generator().manual_seed(30))
    out = {}
    for name, device, p in (("cuda", dev, p_dev), ("cpu", cpu, p_cpu)):
        t0 = time.perf_counter()
        c = mpt.kv_cache(small, 1, MPT_CPU_PROMPT + MPT_CPU_NEW, device)
        lg, c = mpt.forward(p, small, prompt.to(device), cache=c)
        first = lg[0, -1].float().cpu()
        toks = []
        for _ in range(MPT_CPU_NEW):
            t = int(lg[0, -1].argmax())
            toks.append(t)
            lg, c = mpt.forward(p, small, torch.tensor([[t]], device=device), cache=c)
        out[name] = (first, toks)
        print(f"mpt cpu-vs-card: {name} {time.perf_counter() - t0:.1f} s", flush=True)
    rel = ((out["cuda"][0] - out["cpu"][0]).abs().max() / out["cpu"][0].abs().max()).item()
    same = out["cuda"][1] == out["cpu"][1]
    print(f"mpt cpu-vs-card: {MPT_CPU_LAYERS}-layer MPT-7B-width float32 prefill logits "
          f"rel_err={rel:.3e} (limit {CPU_GPU_TOL}), {MPT_CPU_NEW} greedy tokens identical="
          f"{same} [{card}]", flush=True)
    check(rel <= CPU_GPU_TOL and same, f"mpt: CPU and card disagree: rel {rel}, tokens "
          f"{out['cuda'][1]} vs {out['cpu'][1]}")
    del p_dev
    torch.cuda.empty_cache()
    return launches


def w4a8_row(torch, card: str, g, m: int, k: int, n: int, flush=None) -> dict:
    """Q1 against its plain version on x [m, k] bf16 and a random packed
    [k/2, n] weight: each output row within Q_ROW_REL, the same bits twice,
    CUDA-event times (the weights flushed from L2 by a read) beside the
    bound (bytes at 3.35 TB/s, or 2 m k n operations at the int8 peak) and,
    as the comparison arm, B1 (the int4 product it replaces on the decode
    path) on the same x and weight. No PyTorch call takes the packing."""
    from vitron_tpu_torch.kernels import int4_matmul as i4
    from vitron_tpu_torch.kernels import w4a8_matmul as q1

    dev = torch.device("cuda")
    q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8, device=dev)
    s = torch.rand((1, n), generator=g, device=dev) * 0.02 + 0.01
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    got, again = q1.w4a8_matmul(x, q4, s), q1.w4a8_matmul(x, q4, s)
    want = q1.w4a8_matmul_plain(x, q4, s)
    err, rel = rel_err(got, want)
    row_rel = flash_row_rel(got, want)
    same = bool(torch.equal(got, again))
    del again, want
    ms = cuda_ms(torch, lambda: q1.w4a8_matmul(x, q4, s), flush=flush)
    plain_ms = cuda_ms(torch, lambda: q1.w4a8_matmul_plain(x, q4, s), iters=3, warmup=1,
                       flush=flush)
    b1_ms = cuda_ms(torch, lambda: i4.int4_matmul(x, q4, s), flush=flush)
    ops = 2 * m * k * n
    r = dict(row(err, rel, ms, plain_ms, nbytes(x, q4, s, got), ops, "int8_tensor"),
             ref_ms=b1_ms, row_rel=row_rel)
    rate = (f"{q4.numel() / (ms * 1e-3) / 1e9:.0f} GB/s packed" if m <= q1.GEMV_MAX_M
            else f"{ops / (ms * 1e-3) / 1e12:.1f} TOP/s")
    print(f"w4a8_matmul M={m} K={k} N={n} bf16: rel_err={rel:.3e} row_rel_err={row_rel:.3e} "
          f"(limit {Q_ROW_REL['bfloat16']:.3e}), same bits twice={same}; kernel {ms:.4f} ms "
          f"({rate}) plain {plain_ms:.4f} ms {bound_text(r)}; comparison arm, B1 (int4_matmul) "
          f"on the same x and weight {b1_ms:.4f} ms [{card}]", flush=True)
    check(row_rel <= Q_ROW_REL["bfloat16"] and same,
          f"w4a8_matmul M={m} K={k} N={n}: row rel err {row_rel}, same bits twice {same}")
    return r


def eager_scan(torch, gen_, arrays, n_new: int):
    """`Generator.scan` with the decode chunk's steps run eagerly (its body,
    not its graph): the prefill on the W4A8 tree, then n_new - 1 greedy
    steps -> (tokens, seconds of the steps)."""
    from vitron_tpu_torch.runtime.generation import cache_slots

    pad_len = arrays[0].shape[1]
    chunk = gen_._chunk(n_new - 1, 1, cache_slots(pad_len + n_new), False)
    logits = gen_._prefill(chunk.cache, *arrays, params=gen_.decode_params)
    token = logits.argmax(-1)[:, None]
    chunk.start(token, gen_._t(arrays[5], torch.int64)[:, None], pad_len, 0.0, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk._body()
    torch.cuda.synchronize()
    return torch.cat([token, chunk.emits], 1)[0].tolist(), time.perf_counter() - t0


def text_plan(cfg_llm, n: int, seed: int, pad: int = 64):
    """A text-only splice plan of n random ids (BOS first)."""
    from vitron_tpu_torch.mm.splice import plan_splice

    ids = [1] + np.random.RandomState(seed).randint(3, cfg_llm.vocab_size, n - 1).tolist()
    return plan_arrays(plan_splice([ids], [], pad))


def phase_w4a8(torch, card: str, system, params, cfg, plain_tok_s: float):
    """Phase 29: the chat system of phase 6 served under VITRON_W4A8=1 (a new
    engine on the same packed weights: its decode chunks run Q1, its
    prefill B1, as JAX's do): a 128-token greedy request twice, graphed,
    with Q1's launches exact, beside phase 6's plain rate; the same decode
    steps eager (`eager_scan`) against the graphed `scan`, identical tokens.
    Then Q1's rows at the chat's four (K, N) shapes, M 1/4/5/8/384."""
    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.generation import DEFAULT_DECODE_CHUNK, SamplingConfig
    from vitron_tpu_torch.runtime.system import VitronSystem

    dev = torch.device("cuda")
    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    sampling = SamplingConfig(greedy=True, max_new_tokens=NEW_TOKENS, eos_ids=())
    n_layers = cfg.llm.num_layers
    per_forward = 7 * n_layers + 1
    steps = -(-(NEW_TOKENS - 1) // DEFAULT_DECODE_CHUNK) * DEFAULT_DECODE_CHUNK
    with mock.patch.dict(os.environ, {"VITRON_W4A8": "1", "VITRON_SPEC": "0"}):
        engine = VitronEngine(params, cfg, DemoTokenizer(), device=dev)
        w_system = VitronSystem(engine)
        timed_chat(torch, w_system, image, sampling)  # warm-up: captures the decode graph
        reset_launches()
        out1, t_req = timed_chat(torch, w_system, image, sampling)
        launches = expect_launches({"int4_matmul": per_forward, "w4a8_matmul": per_forward * steps,
                                    "flash_attention": n_layers}, "w4a8 chat")
        tokens = out1["reply"]["tokens"]
        check(len(tokens) == NEW_TOKENS, f"w4a8 chat: {len(tokens)} tokens")
        out2, _ = timed_chat(torch, w_system, image, sampling)
        check(out2["reply"]["tokens"] == tokens, "w4a8 chat: a second request gave other tokens")
        _, t_prefill = timed_chat(torch, w_system, image,
                                  SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=()))
        tok_s = (NEW_TOKENS - 1) / (t_req - t_prefill)

        gen_ = engine.generator
        arrays = text_plan(cfg.llm, 40, seed=29)
        graphed = gen_.scan(arrays, W4A8_EAGER_NEW)[0].tolist()  # captures the scan's chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed = gen_.scan(arrays, W4A8_EAGER_NEW)[0].tolist()
        torch.cuda.synchronize()
        t_graphed = time.perf_counter() - t0
        eager, t_eager = eager_scan(torch, gen_, arrays, W4A8_EAGER_NEW)
        check(eager == graphed, "w4a8: the eager steps gave other tokens than the graph")
    print(f"w4a8_decode_tok_s={tok_s:.1f} (VITRON_W4A8=1 chat, {NEW_TOKENS} greedy tokens, "
          f"graphed decode chunk on Q1; request {t_req:.3f} s, 1-token request {t_prefill:.3f} "
          f"s) beside phase 6's plain int4 decode {plain_tok_s:.1f} tok/s; eager steps "
          f"{(W4A8_EAGER_NEW - 1) / t_eager:.1f} tok/s ({W4A8_EAGER_NEW - 1} steps of a text "
          f"prompt, the same tokens as the graphed scan's {t_graphed:.3f} s with its prefill) "
          f"[{card}]",
          flush=True)
    del engine, w_system, gen_
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(291)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for m in (1, 4, 5, 8, 384):
        for k, n in INT4_SHAPES:
            rows.append(w4a8_row(torch, card, g, m, k, n, flush=flush))
        print_sums(f"Q1 at M {m}", rows[-len(INT4_SHAPES):], card)
    del flush
    return launches, rows


def phase_w4a8_cpu_vs_card(torch, card: str):
    """Phase 29 (b): a 2-layer full-width float32 Vicuna (int4 at the init's
    scale) under VITRON_W4A8=1 on the CPU and the card: `Generator.scan`'s
    W4A8 prefill logits within W4A8_CPU_GPU_TOL and its W4A8_CPU_NEW greedy tokens
    the same, or first different at a near-tie of the CPU's logits."""
    from vitron_tpu_torch.models.llm import llama
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.runtime.generation import Generator

    f32 = torch.float32
    cfg = VitronConfig(
        llm=LlamaConfig.vicuna_7b(num_layers=2, max_seq_len=1024, param_dtype=f32,
                                  compute_dtype=f32),
        image_tower=ViTConfig.clip_vit_l14(), video_tower=ViTConfig.video_vit_l14())
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    _, params = build_system(torch, cfg, dev, seed=5)
    arrays = text_plan(cfg.llm, 24, seed=30)
    out = {}
    with mock.patch.dict(os.environ, {"VITRON_W4A8": "1"}):
        for name, device, p in (("cuda", dev, params),
                                ("cpu", cpu, tree_map(lambda a: a.cpu(), params))):
            t0 = time.perf_counter()
            gen_ = Generator(p, cfg, device)
            toks = gen_.scan(arrays, W4A8_CPU_NEW)[0].tolist()
            out[name] = (gen_.last_prefill_logits.float().cpu(), toks, gen_)
            print(f"w4a8 cpu-vs-card: {name} {time.perf_counter() - t0:.1f} s", flush=True)
        err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
        rel = err / out["cpu"][0].abs().max().item()
        got, want = out["cuda"][1], out["cpu"][1]
        how = "identical"
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if j is not None:  # the CPU's logits before token j, fed the CPU's tokens
            cgen = out["cpu"][2]
            llm = cgen.decode_params["llm"]
            seq = int(arrays[5][0])
            ids = torch.tensor([arrays[0][0][:seq].tolist() + want[:j]])
            lg, _ = llama.forward_tokens(llm, cfg.llm, ids, positions=torch.arange(
                ids.shape[1])[None])
            top = lg[0, -1].topk(2).values.tolist()
            how = (f"first divergence at token {j}: the CPU's top-2 logits {top[0]:.5f} / "
                   f"{top[1]:.5f}, gap {top[0] - top[1]:.5f} (limit {4 * err:.5f}, four times "
                   f"the prefill's largest logit difference)")
            check(top[0] - top[1] <= 4 * err, f"w4a8 cpu-vs-card: {how}")
    print(f"w4a8 cpu-vs-card: 2-layer full-width float32 Vicuna, VITRON_W4A8=1 scan: prefill "
          f"logits rel_err={rel:.3e} (limit {W4A8_CPU_GPU_TOL}), {W4A8_CPU_NEW} greedy tokens "
          f"{how} [{card}]", flush=True)
    check(rel <= W4A8_CPU_GPU_TOL, f"w4a8: CPU and card prefill logits disagree: {rel}")
    del out, params
    torch.cuda.empty_cache()


def q2_row(torch, card: str, g, xs: tuple, co: int, stride: int, pad: int, count: int,
           dtype) -> dict:
    """Q2 against its plain version (the exact float64 conv of the integers)
    at one site: each output pixel within Q_ROW_REL of its largest, the same
    bits twice, CUDA-event times beside the bound (bytes at 3.35 TB/s, or
    2 M 9C Co operations at the int8 peak) and, labelled as the path it
    replaces (not a port), cuDNN's float32 and bf16 convs at the same shape
    (channels-last, TF32 off)."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import conv2d_w8a8 as q2

    dev = torch.device("cuda")
    c = xs[-1]
    xq = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8, device=dev)
    qc = torch.randint(-127, 128, (3, 3, c, co), generator=g, dtype=torch.int8, device=dev)
    ssx = torch.rand((co,), generator=g, device=dev) * 1e-5
    got = q2.conv_s8(xq, qc, ssx, stride, pad, dtype)
    again = q2.conv_s8(xq, qc, ssx, stride, pad, dtype)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = q2.conv_s8_plain(xq, qc, ssx, stride, pad, dtype)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err, rel = rel_err(got, want)
    px_rel = flash_row_rel(got, want)
    same = bool(torch.equal(got, again))
    del again, want
    ms = cuda_ms(torch, lambda: q2.conv_s8(xq, qc, ssx, stride, pad, dtype), iters=10)
    lib = {}
    for name, t in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        xt = xq.to(t).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        wt = qc.to(t).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib[name] = cuda_ms(torch, lambda: F.conv2d(xt, wt, stride=stride, padding=pad),
                            iters=5, warmup=1)
        del xt, wt
    m = got.numel() // co
    ops = 2 * m * 9 * c * co
    r = dict(row(err, rel, ms, plain_ms, nbytes(xq, qc, ssx, got), ops, "int8_tensor"),
             replaces_ms=lib, count=count, site=(xs, co, stride, pad))
    print(f"conv2d_w8a8 x={xs} Co={co} stride={stride} pad={pad} ({count} a call) "
          f"{str(dtype).split('.')[-1]}: pixel_rel_err={px_rel:.3e} (limit "
          f"{Q_ROW_REL[str(dtype).split('.')[-1]]:.3e}), same bits twice={same}; kernel "
          f"{ms:.4f} ms ({ops / (ms * 1e-3) / 1e12:.1f} TOP/s) plain (float64 conv) "
          f"{plain_ms:.4f} ms {bound_text(r)}; the path it replaces, not a port: cuDNN float32 "
          f"{lib['float32']:.4f} ms, bf16 {lib['bf16']:.4f} ms [{card}]", flush=True)
    check(px_rel <= Q_ROW_REL[str(dtype).split(".")[-1]] and same,
          f"conv2d_w8a8 {xs} Co {co} stride {stride}: pixel rel err {px_rel}, same bits {same}")
    return r


def q2_rows(torch, card: str, sites: collections.Counter, what: str) -> list:
    g = torch.Generator(device=torch.device("cuda")).manual_seed(30)
    rows = [q2_row(torch, card, g, xs, co, st, pad, n, torch.float32)
            for (xs, co, st, pad), n in sorted(sites.items())]
    ms = sum(r["ms"] * r["count"] for r in rows)
    f32 = sum(r["replaces_ms"]["float32"] * r["count"] for r in rows)
    bf = sum(r["replaces_ms"]["bf16"] * r["count"] for r in rows)
    bound = sum(max(r["bytes_ms"], r["ops_ms"]) * r["count"] for r in rows)
    print(f"Q2 at {what}'s {len(rows)} sites ({sum(sites.values())} convs a CFG call): "
          f"{ms:.3f} ms a call, bound {bound:.3f} ms; cuDNN float32 {f32:.3f} ms, bf16 "
          f"{bf:.3f} ms [{card}]", flush=True)
    return rows


def phase_w8a8_task_a(torch, card: str, pipe):
    """Phase 30 (a): the resident GLIGEN pipeline's trees through
    GligenPipeline under VITRON_UNET_QUANT=w8a8 (both UNets' eligible convs
    to Q2): task A at W8A8_TASK_A_STEPS PLMS steps, twice, launches exact
    (Q2 at every `sd_w8a8_sites` conv of every call), identical images; one
    quantized CFG UNet call's ms beside the float32 call's, and the
    quantized eps against the float one; Q2's rows at every site."""
    from vitron_tpu_torch.models.diffusion import clip_text
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenPipeline
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = dataclasses.replace(pipe.cfg, steps=W8A8_TASK_A_STEPS)
    with mock.patch.dict(os.environ, {"VITRON_UNET_QUANT": "w8a8"}):
        qpipe = GligenPipeline(cfg, pipe.unet_params, pipe.vae_params, pipe.text_params,
                               inpaint_unet_params=pipe.inpaint_unet_params,
                               tokenizer=pipe.tokenizer)
    sites = sd_w8a8_sites(cfg.unet, cfg.latent_size, 2)
    system = VitronSystem(None)
    system.register_gligen(qpipe)
    unet = unet_counts(cfg.unet, cfg.latent_size, cfg.max_objs, cfg.text.max_length)
    _, dec = vae_counts(cfg.vae, cfg.latent_size ** 2)
    calls = cfg.steps + 1
    want = {k: calls * unet[k] + dec[k] for k in unet}
    want["conv2d_w8a8"] = calls * sum(sites.values())
    runs = []
    for i in range(2):
        reset_launches()
        out, t_req = timed_route(torch, system, TASK_A_REPLY)
        launches = expect_launches(want, f"w8a8 task A run {i + 1}")
        img = out["image"]
        check(out["status"] == "ok" and img.shape == (cfg.image_size, cfg.image_size, 3)
              and img.dtype == np.uint8 and int(img.max()) != int(img.min()),
              f"w8a8 task A: status {out['status']}, image {img.shape}")
        runs.append(img)
    check(np.array_equal(runs[0], runs[1]), "w8a8 task A: two requests gave other images")

    inputs = pipe.prepare("a red car on a street", [[0.1, 0.2, 0.6, 0.8]],
                          ["a red car on a street"])
    ctx = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_ctx"])
    uc = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_uc"])
    text_emb = torch.zeros((1, cfg.max_objs, cfg.unet.context_dim), device=pipe.device)
    args = (ctx, uc, inputs["gb"], inputs["gm"], text_emb, 7.5)
    q_params = qpipe.prepare("a red car on a street", [[0.1, 0.2, 0.6, 0.8]],
                             ["a red car on a street"])["params"]  # the quantized UNet's
    eps_f, eps_q = pipe._eps_fn(inputs["params"], *args), qpipe._eps_fn(q_params, *args)
    x = torch.randn((1, cfg.latent_size, cfg.latent_size, 4), device=pipe.device,
                    generator=torch.Generator(device=pipe.device).manual_seed(31))
    f_out, q_out = eps_f(x, 501, 1.0), eps_q(x, 501, 1.0)
    dev_rel = ((q_out - f_out).abs().max() / f_out.abs().max()).item()
    check(bool(torch.isfinite(q_out).all()), "w8a8 task A: non-finite quantized eps")
    ms = {}
    for name, fn in (("float32", eps_f), ("w8a8", eps_q), ("float32 again", eps_f),
                     ("w8a8 again", eps_q)):
        ms[name] = cuda_ms(torch, lambda: fn(x, 501, 1.0), iters=5, warmup=1)
    print(f"taskA_w8a8_request_s={t_req:.3f} ({cfg.steps} PLMS steps, {calls} CFG calls, "
          f"{sum(sites.values())} Q2 convs a call); a CFG UNet call: w8a8 {ms['w8a8']:.2f} / "
          f"{ms['w8a8 again']:.2f} ms beside float32 {ms['float32']:.2f} / "
          f"{ms['float32 again']:.2f} ms (in turns); the quantized eps differs from the float "
          f"one by {dev_rel:.3e} of its largest [{card}]", flush=True)
    del qpipe, system, eps_q
    torch.cuda.empty_cache()
    return launches, q2_rows(torch, card, sites, "task A's SD UNet")


def phase_w8a8_task_d(torch, card: str, pipe):
    """Phase 30 (b): the resident t2v pipeline's trees through
    Text2VideoPipeline under VITRON_VUNET_QUANT=w8a8: task D at
    W8A8_TASK_D_STEPS DDIM-v steps (24 frames at 320x576), twice, launches
    exact (Q2 at every `video_w8a8_sites` conv); one quantized CFG call's
    ms beside the float32 call's, in turns; Q2's rows at every site; the
    opt-in q8 dot and q8t tap forms once each against their plain versions
    (the exact float64 sums in place of `torch._int_mm`), bit-equal."""
    from vitron_tpu_torch.kernels import quantization as tq
    from vitron_tpu_torch.kernels import temporal_conv as tc
    from vitron_tpu_torch.kernels import w4a8_matmul as q1
    from vitron_tpu_torch.models.diffusion import clip_text
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoPipeline
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = dataclasses.replace(pipe.cfg, steps=W8A8_TASK_D_STEPS)
    with mock.patch.dict(os.environ, {"VITRON_VUNET_QUANT": "w8a8"}):
        qpipe = Text2VideoPipeline(cfg, pipe.unet_params, pipe.vae_params, pipe.text_params,
                                   tokenizer=pipe.tokenizer)
    lh, lw = cfg.latent_hw
    sites = video_w8a8_sites(cfg.unet, lh, lw, 2 * cfg.num_frames)
    system = VitronSystem(None)
    system.register_text2video(qpipe)
    per_call = video_counts(cfg.unet, lh, lw, cfg.text.max_length)
    per_call["conv2d_w8a8"] = sum(sites.values())
    _, dec = vae_counts(cfg.vae, lh * lw)
    want = {k: cfg.steps * per_call[k] + dec.get(k, 0) for k in per_call}
    launches, t_req = video_requests(
        torch, card, system, TASK_D_REPLY, "video_generation", want,
        (cfg.num_frames, cfg.height, cfg.width, 3), f"w8a8, {cfg.steps} DDIM-v steps")
    ids = pipe.tokenize(["a red car", ""])
    ctx = clip_text.encode(pipe.text_params, cfg.text, ids)
    v_f, v_q = pipe.v_fn(ctx), qpipe.v_fn(ctx)
    x = torch.randn((1, cfg.num_frames, lh, lw, cfg.unet.in_dim), device=pipe.device,
                    generator=torch.Generator(device=pipe.device).manual_seed(32))
    ms = {}
    for name, fn in (("float32", v_f), ("w8a8", v_q), ("float32 again", v_f),
                     ("w8a8 again", v_q)):
        ms[name] = cuda_ms(torch, lambda: fn(x, 501), iters=1, warmup=0)  # both warm
    print(f"video_unet_w8a8_cfg_steps_per_s={1e3 / ms['w8a8 again']:.4f} (a CFG call "
          f"{ms['w8a8']:.2f} / {ms['w8a8 again']:.2f} ms, {sum(sites.values())} Q2 convs) "
          f"beside float32 {ms['float32']:.2f} / {ms['float32 again']:.2f} ms (in turns); "
          f"taskD_w8a8_request_s={t_req:.3f} ({cfg.steps} steps, 24 frames) [{card}]",
          flush=True)
    del qpipe, system, v_q
    torch.cuda.empty_cache()
    rows = q2_rows(torch, card, sites, "task D's t2v UNet")

    # the opt-in forms, once each, on the widest level's temporal-transformer shapes
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(33)
    n, c = lh * lw, cfg.unet.dim
    x = torch.randn((2, cfg.num_frames, n, c), generator=g, device=dev)
    w8 = tq.quantize_int8_a8(torch.randn((c, c), generator=g, device=dev) * c ** -0.5)
    wt = tq.quantize_tconv(torch.randn((3, 1, c, c), generator=g, device=dev) * c ** -0.5)
    got_dot, got_tap = tq.matmul_maybe_quantized(x, w8), tc.temporal_conv_k3(x, wt)
    with mock.patch.object(tq, "int_dot", q1.exact_int_dot):
        want_dot, want_tap = tq.matmul_maybe_quantized(x, w8), tc.temporal_conv_k3(x, wt)
    same = torch.equal(got_dot, want_dot) and torch.equal(got_tap, want_tap)
    print(f"w8a8 opt-in forms at [2, {cfg.num_frames}, {n}, {c}]: the q8 dot and the q8t taps "
          f"(torch._int_mm on the card) bit-equal to the exact float64 sums: {same} [{card}]",
          flush=True)
    check(same, "w8a8: the q8 dot or the q8t taps differ from their exact sums")
    return launches, rows


def phase_w8a8_cpu_vs_card(torch, card: str):
    """Phase 30 (c): tiny quantized UNets, float32, on the CPU and the card:
    the SD UNet with every conv of 32 channels or more on Q2, and the t2v
    UNet with every class quantized (convs on Q2, the transformer products
    and the temporal taps on `torch._int_mm`). Every quantized product of
    the CPU's forward (each `conv2d_w8a8`, q8 dot and q8t call, its inputs
    and output recorded) runs again on the card from the same inputs and
    must give the same bits. The two whole forwards then agree within
    W8A8_CPU_GPU_TOL, and Q2's launches on the card equal the site
    enumeration's."""
    from vitron_tpu_torch.kernels import quantization as tq
    from vitron_tpu_torch.kernels import temporal_conv as tc
    from vitron_tpu_torch.models.diffusion import layers, unet2d, unet_sd_video
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    g = torch.Generator().manual_seed(34)
    scfg = unet2d.UNetConfig.tiny(model_channels=64)
    vcfg = unet_sd_video.UNetSDVideoConfig.tiny("t2v", dim=64, head_dim=32)  # B7 takes D 32
    sd = unet2d.quantize_params(fill_zero_leaves(unet2d.init_params(g, scfg, cpu), g),
                                min_channels=32)
    vd = unet_sd_video.quantize_params(
        fill_zero_leaves(unet_sd_video.init_params(g, vcfg, cpu), g), min_channels=32,
        min_dot_dim=32, min_tconv_dim=32)
    cases = (
        ("convs", lambda p, *a: unet2d.forward(p, scfg, *a, gate_scale=0.7), sd,
         (torch.randn((2, 16, 16, 4), generator=g), torch.tensor([981, 21]),
          torch.randn((2, 16, 16), generator=g), torch.randn((2, 4, 16), generator=g)),
         sd_w8a8_sites(scfg, 16, 2, 32)),
        ("all classes", lambda p, x, t, y: unet_sd_video.forward(p, vcfg, x, t, y=y), vd,
         (torch.randn((2, 3, 16, 16, 4), generator=g), torch.tensor([501.0, 17.0]),
          torch.randn((2, 5, vcfg.context_dim), generator=g)),
         video_w8a8_sites(vcfg, 16, 16, 6, 32)))
    products = ((layers, "conv2d_w8a8"), (tq, "_w8a8_matmul"), (tc, "_tconv_w8a8"))
    for name, fwd, p, args, sites in cases:
        calls = []

        def recorded(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                calls.append((fn, a, kw, out))
                return out
            return call

        with contextlib.ExitStack() as stack:
            for mod, attr in products:
                stack.enter_context(mock.patch.object(mod, attr, recorded(getattr(mod, attr))))
            want = fwd(p, *args)
        on_card = lambda t: t.to(dev) if torch.is_tensor(t) else t  # noqa: E731
        same = sum(bool(torch.equal(fn(*tree_map(on_card, list(a)), **kw).cpu(), out))
                   for fn, a, kw, out in calls)
        reset_launches()
        got = fwd(tree_map(lambda a: a.to(dev), p), *(a.to(dev) for a in args)).cpu()
        n = read_launches()["conv2d_w8a8"]
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"w8a8 cpu-vs-card: tiny {'SD' if name == 'convs' else 't2v'} UNet, {name} "
              f"quantized: {same} of the CPU forward's {len(calls)} quantized products "
              f"bit-equal on the card from the same inputs; whole forward rel_err={rel:.3e} "
              f"(limit {W8A8_CPU_GPU_TOL:.3e}); {n} Q2 launches (the sites: "
              f"{sum(sites.values())}) [{card}]", flush=True)
        check(same == len(calls) > 0 and rel <= W8A8_CPU_GPU_TOL and n == sum(sites.values()),
              f"w8a8 cpu-vs-card ({name}): {same} of {len(calls)} products bit-equal, rel "
              f"{rel}, Q2 launches {n}")


# ------------------------------------------------------------------ phase 31: the mesh

MESH_BATCH_NEW = 32    # tokens of each of the batcher's two co-batched requests on the mesh
MESH_BATCH_CHUNK = 16
RING_PREFILL = 512     # tokens of the Vicuna-7B ring-vs-flash prefill
RING_SHAPE = (1, 4096, 32, 128)  # B, S, N, D: the ring's device half at Vicuna-7B widths
RING_BLOCKS = 4
MESH_SLICES = (2, 4)   # frame slices of the video device half
MESH_PLAN_CHIPS = 4    # the deployment whose per-device rows the plan prints


def nccl_group(torch):
    """A one-rank NCCL process group on a store at 127.0.0.1 (an OS-chosen
    port): the mesh path's collectives, each issued, on this card."""
    import socket

    from vitron_tpu_torch.core import distributed as vdist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    vdist.initialize(vdist.DistributedConfig(coordinator_address=f"127.0.0.1:{port}",
                                             num_processes=1, process_id=0), backend="nccl")


def mesh_batch(torch, system, mesh, plans, sampling):
    """Two requests co-batched by a ContinuousBatcher (on `mesh` or one
    device) -> (their tokens, mean batch occupancy)."""
    from vitron_tpu_torch.runtime.batching import ContinuousBatcher

    gen_ = system.engine.generator
    batcher = ContinuousBatcher(gen_.params, gen_.cfg, chunk=MESH_BATCH_CHUNK, max_active=4,
                                num_blocks=256, device=gen_.device, mesh=mesh)
    try:
        futs = [batcher.submit(p, sampling=sampling) for p in plans]
        toks = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        return toks, batcher.stats()["mean_batch_occupancy"]
    finally:
        batcher.close()


def phase_mesh_chat(torch, card: str, system, params, cfg) -> dict:
    """Phase 31 (a), chat: phase 6's Vicuna-7B int4 + ViT-L/14 system on a
    one-rank NCCL serving mesh (`install_mesh`: every leaf a Shard, each
    layer's fsdp all-gathers, the Megatron all-reduces and the vocab
    gathers issued on this card) gives the greedy tokens it gave without the
    mesh, its decode replaying CUDA graphs that hold the collectives; its
    batcher co-batches two requests (rank 0's lockstep broadcasts issued) to
    the tokens of the batcher without the mesh; a prefill at
    attn_impl="ring" (B2 with its LSE over the one-rank context axis)
    matches "flash"; the memory plan prints per-device rows. -> the mesh
    path's launches (the chat, the batcher and the ring prefill)."""
    import dataclasses

    from vitron_tpu_torch.models.llm import llama
    from vitron_tpu_torch.runtime.generation import DEFAULT_DECODE_CHUNK, SamplingConfig
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan, kv_cache_bytes, tree_bytes
    from vitron_tpu_torch.runtime.sharded_serving import install_mesh, serving_mesh

    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    sampling = SamplingConfig(greedy=True, max_new_tokens=NEW_TOKENS, eos_ids=())
    batch_sampling = SamplingConfig(greedy=True, max_new_tokens=MESH_BATCH_NEW, eos_ids=())
    plans = [system.engine.plan_turn(p)[0] for p in (SERVE_SHORT, PROMPT)]
    want, _ = timed_chat(torch, system, image, sampling)
    want_batch, _ = mesh_batch(torch, system, None, plans, batch_sampling)
    total = tree_bytes(params)

    nccl_group(torch)
    mesh = serving_mesh(1)
    install_mesh(system, mesh)
    gen_ = system.engine.generator
    per_forward, n_layers = 7 * cfg.llm.num_layers + 1, cfg.llm.num_layers
    steps = -(-(NEW_TOKENS - 1) // DEFAULT_DECODE_CHUNK) * DEFAULT_DECODE_CHUNK
    counted = collections.Counter()
    timed_chat(torch, system, image, sampling)  # captures the chunk on the mesh
    reset_launches()
    got, t_req = timed_chat(torch, system, image, sampling)
    counted.update(expect_launches({"int4_matmul": per_forward * (1 + steps),
                                    "flash_attention": n_layers}, "31 (a) mesh chat"))
    check(got["reply"]["tokens"] == want["reply"]["tokens"],
          "31 (a): the mesh's greedy tokens differ from the system's without it")
    graph = gen_.last_chunk.run
    check(graph.graph is not None, "31 (a): the mesh's decode chunk is not a CUDA graph")
    _, t_prefill = timed_chat(torch, system, image,
                              SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=()))
    decode_tok_s = (NEW_TOKENS - 1) / (t_req - t_prefill)

    reset_launches()
    got_batch, occupancy = mesh_batch(torch, system, mesh, plans, batch_sampling)
    counted.update(read_launches())
    check(got_batch == want_batch, f"31 (a): the mesh batcher's tokens differ: {got_batch} "
          f"!= {want_batch}")
    check(occupancy > 1.0, f"31 (a): the batcher did not co-batch (occupancy {occupancy})")

    g = torch.Generator(device="cuda").manual_seed(31)
    ids = torch.randint(3, cfg.llm.vocab_size, (1, RING_PREFILL), generator=g, device="cuda")
    pos = torch.arange(RING_PREFILL, device="cuda")[None]
    llm = gen_.params["llm"]
    flash, _ = llama.forward_tokens(llm, cfg.llm, ids, positions=pos)
    reset_launches()
    ring, _ = llama.forward_tokens(llm, dataclasses.replace(cfg.llm, attn_impl="ring"), ids,
                                   positions=pos, mesh=mesh)
    counted.update(expect_launches({"int4_matmul": per_forward, "flash_attention": n_layers},
                                   "31 (a) ring prefill"))
    err, rel = rel_err(ring, flash)
    check(rel <= FLASH_ROW_REL, f"31 (a): ring prefill logits {rel:.3e} from flash's")

    plan = MemoryPlan(budget_bytes=torch.cuda.get_device_properties(0).total_memory,
                      chips=MESH_PLAN_CHIPS)
    plan.add("llm+towers (fsdp x tp)", total, sharded=True)
    plan.add("paged-kv-pool (tp)", kv_cache_bytes(n_layers, 1, 512 * 16, cfg.llm.num_kv_heads,
                                                  cfg.llm.head_dim), shard_factor=2)
    print(plan.report(), flush=True)
    check(plan.fits and "GiB/chip" in plan.report(), "31 (a): the per-device plan")
    print(f"31 (a) mesh chat: mesh {mesh.shape} (one NCCL rank), {NEW_TOKENS} greedy tokens as "
          f"without the mesh in {t_req:.3f} s (the decode chunk's graph holds "
          f"{graph.launches_per_call} kernel launches and the collectives), prefill request "
          f"(1 token) {t_prefill:.3f} s, decode {decode_tok_s:.1f} tok/s (phase 6 without the "
          f"mesh: {MEASURED.get('decode_tok_s', float('nan')):.1f}); batcher: 2 "
          f"requests x {MESH_BATCH_NEW} tokens co-batched (mean occupancy {occupancy}) as "
          f"without the mesh; ring prefill[{RING_PREFILL}] vs flash: max |err| {err:.3e} "
          f"(rel {rel:.3e} <= {FLASH_ROW_REL:.3e}) [{card}]", flush=True)
    return dict(counted)


def phase_mesh_video(torch, card: str, pipe) -> dict:
    """Phase 31 (a), video: task D's resident t2v tree through
    `shard_video_step` over the one-rank (cfg, frames) mesh gives the bits
    of one plain CFG UNet call. -> its launches."""
    from vitron_tpu_torch.distributed import video_sharding as vs
    from vitron_tpu_torch.models.diffusion import clip_text, unet_sd_video

    cfg = pipe.cfg
    lh, lw = cfg.latent_hw
    ctx2 = clip_text.encode(pipe.text_params, cfg.text, pipe.tokenize(["a red car", ""]))
    g = torch.Generator(device=pipe.device).manual_seed(31)
    x = torch.randn((1, cfg.num_frames, lh, lw, cfg.unet.in_dim), generator=g,
                    device=pipe.device)
    xx, tt = torch.cat([x, x]), torch.full((2,), 501.0, device=pipe.device)

    def step(p, x, t, c):
        return unet_sd_video.forward(p, cfg.unet, x, t, y=c)

    want = step(pipe.unet_params, xx, tt, ctx2)
    mesh = vs.create_video_mesh(1)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = vs.shard_video_step(step, mesh)(pipe.unet_params, xx, tt, ctx2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_call = video_counts(cfg.unet, lh, lw, cfg.text.max_length)
    launches = expect_launches(per_call, "31 (a) mesh video step")
    check(torch.equal(got, want), "31 (a): the sharded t2v step differs from the plain call")
    print(f"31 (a) mesh video: the {cfg.num_frames}-frame t2v CFG step through "
          f"shard_video_step over {mesh.shape} (one NCCL rank) equals the plain call bit for "
          f"bit, {dt:.3f} s [{card}]", flush=True)
    return launches


def phase_mesh_ring_half(torch, card: str) -> None:
    """Phase 31 (b): the ring's device half at Vicuna-7B widths. S split
    into RING_BLOCKS blocks, each rank's body run here for every rank: B2
    with its LSE on each block (non-causal on an earlier shard's, causal on
    its own, a later one skipped), merged by LSE in float32; every query row
    within B2's per-row limit of B2 over the whole sequence."""
    from vitron_tpu_torch.distributed.ring_attention import block_attend, merge
    from vitron_tpu_torch.kernels import flash_attention as fa

    b, s, n, d = RING_SHAPE
    g = torch.Generator(device="cuda").manual_seed(32)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    sl = s // RING_BLOCKS
    blk = [t.split(sl, dim=1) for t in (q, k, v)]

    def ring():
        outs = []
        for r in range(RING_BLOCKS):
            acc = None
            for i in range(RING_BLOCKS):
                src = (r - i) % RING_BLOCKS
                if src <= r:
                    acc = merge(acc, *block_attend(blk[0][r], blk[1][src], blk[2][src], scale,
                                                   src == r))
            outs.append(acc[0].to(q.dtype))
        return torch.cat(outs, dim=1)

    whole = fa._forward(q, k, v, None, 0, scale, True, None, False)[0]
    got = ring()
    worst = flash_row_rel(got, whole)
    ring_ms = cuda_ms(torch, ring, iters=5, warmup=1)
    whole_ms = cuda_ms(torch, lambda: fa._forward(q, k, v, None, 0, scale, True, None, False),
                       iters=5, warmup=1)
    print(f"31 (b) ring half: S {s} in {RING_BLOCKS} blocks, {n} heads, D {d}, bf16: "
          f"{RING_BLOCKS * (RING_BLOCKS + 1) // 2} B2-with-LSE blocks merged, worst row "
          f"{worst:.3e} of B2 over the whole sequence (limit {FLASH_ROW_REL:.3e}); the "
          f"{RING_BLOCKS} ranks' blocks in turn {ring_ms:.3f} ms, B2 whole {whole_ms:.3f} ms "
          f"[{card}]", flush=True)
    check(worst <= FLASH_ROW_REL, f"31 (b): ring rows {worst:.3e} from B2's")


def phase_mesh_video_half(torch, card: str) -> None:
    """Phase 31 (c): the video's device half at the t2v levels' widths, the
    {VIDEO_FRAMES} frames of a CFG pair in 2 and 4 slices: the halo'd B6 of
    each slice equals B6 over all frames, B8's slice sums add to the whole's
    (float32 sums in another order: GN_TOL), and B7 on the gathered frames
    equals B7 on all of them."""
    from vitron_tpu_torch.distributed.video_sharding import halo_conv
    from vitron_tpu_torch.kernels.group_norm import group_norm_sums
    from vitron_tpu_torch.kernels.temporal_attention import frame_attention
    from vitron_tpu_torch.kernels.temporal_conv import temporal_conv_k3
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig

    ucfg = UNetSDVideoConfig.t2v()
    lh, lw = VIDEO_LATENT
    g = torch.Generator(device="cuda").manual_seed(33)
    worst = {"tconv": 0.0, "gn": 0.0, "tattn": 0.0}
    exact_tconv = True
    for level, mult in enumerate(ucfg.dim_mult):
        c, h, w = ucfg.dim * mult, -(-lh // 2 ** level), -(-lw // 2 ** level)
        x = torch.randn((2, VIDEO_FRAMES, h, w, c), generator=g, device="cuda")
        wt = torch.randn((3, c, c), generator=g, device="cuda") / (3 * c) ** 0.5
        bias = torch.randn((c,), generator=g, device="cuda")
        whole = temporal_conv_k3(x, wt, bias)
        sums = group_norm_sums(x.reshape(2, -1, c).contiguous())
        qkv = [torch.randn((2, VIDEO_FRAMES, h * w, c), generator=g, device="cuda")
               for _ in range(3)]
        heads = c // ucfg.head_dim
        att = frame_attention(*qkv, heads, ucfg.head_dim ** -0.5)
        for n in MESH_SLICES:
            fl = VIDEO_FRAMES // n
            zero = torch.zeros_like(x[:, :1])
            parts, part_sums = [], 0
            for i in range(n):
                xs = x[:, i * fl:(i + 1) * fl]
                prev = x[:, i * fl - 1:i * fl] if i else zero
                nxt = x[:, (i + 1) * fl:(i + 1) * fl + 1] if i + 1 < n else zero
                parts.append(halo_conv(xs, wt, bias, prev, nxt))
                part_sums = part_sums + group_norm_sums(xs.reshape(2, -1, c).contiguous())
            got = torch.cat(parts, dim=1)
            exact_tconv &= torch.equal(got, whole)
            worst["tconv"] = max(worst["tconv"], rel_err(got, whole)[1])
            worst["gn"] = max(worst["gn"], rel_err(part_sums, sums)[1])
            gathered = [torch.cat(t.split(fl, dim=1), dim=1) for t in qkv]
            got_att = frame_attention(*gathered, heads, ucfg.head_dim ** -0.5)
            worst["tattn"] = max(worst["tattn"], rel_err(got_att, att)[1])
    print(f"31 (c) video half: t2v levels {ucfg.dim_mult} x {ucfg.dim} at {lh}x{lw}, "
          f"{VIDEO_FRAMES} frames in {MESH_SLICES} slices, float32: halo'd B6 rel "
          f"{worst['tconv']:.3e} (bit-equal: {exact_tconv}), B8 slice sums rel "
          f"{worst['gn']:.3e}, gathered B7 rel {worst['tattn']:.3e} [{card}]", flush=True)
    check(worst["tconv"] <= VIDEO_TOL["float32"], f"31 (c): halo'd B6 {worst['tconv']:.3e}")
    check(worst["gn"] <= GN_TOL, f"31 (c): B8 slice sums {worst['gn']:.3e}")
    check(worst["tattn"] == 0.0, f"31 (c): gathered B7 {worst['tattn']:.3e}")


def phase_mesh_multi(torch, card: str) -> None:
    """Phase 31 (d): the dryrun legs at 2 and 4 NCCL ranks where the machine
    has the cards; on one card, why not."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"31 (d): one card (torch.cuda.device_count() == {n}): NCCL refuses two ranks on "
              f"one device, so the 2- and 4-rank legs (ring, 7B-geometry sharded decode, routed "
              f"sharded serving, video step) run on gloo CPU ranks in tests/test_torch_*.py and "
              f"`python -m vitron_tpu_torch.apps.dryrun_multichip --spawn N --device cpu`, not "
              f"here [{card}]", flush=True)
        return
    for ranks in (2, 4):
        if ranks > n:
            print(f"31 (d): {ranks} ranks need {ranks} cards, have {n}", flush=True)
            continue
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "vitron_tpu_torch.apps.dryrun_multichip",
                              "--spawn", str(ranks)], capture_output=True, text=True,
                             timeout=600)
        print(out.stdout[-4000:], flush=True)
        check(out.returncode == 0, f"31 (d): dryrun at {ranks} ranks: {out.stderr[-2000:]}")
        print(f"31 (d): dryrun legs at {ranks} NCCL ranks OK in "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def timed_phase(card: str, what: str, fn, *args):
    """fn(*args) with its seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {what}: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return out


def main() -> int:
    card = nvidia_smi_line()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from vitron_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.lib()
    how = (f"nvcc {_build.build_seconds:.1f} s, per source "
           + ", ".join(f"{k} {v:.1f} s" for k, v in _build.compile_seconds.items())
           if _build.build_seconds is not None else "already built")
    print(f"build: {path} ({how}; {time.perf_counter() - t0:.1f} s in all)", flush=True)

    with torch.no_grad():
        rows = phase_kernels(torch, card)
        rows.update(phase_diffusion_kernels(torch, card))
        rows.update(phase_seem_kernels(torch, card))
        rows.update(phase_video_kernels(torch, card))
        rows.update(phase_conv3x3(torch, card))
        rows.update(phase_i2v_kernels(torch, card))
        # the deployment's weights directory: phases 25, 26 (a) and (b) write
        # into it, phase 27 adds the rest and loads it whole, then removes it
        root = ckpt_root()
        atexit.register(shutil.rmtree, root, True)
        with mock.patch.dict(os.environ, {"VITRON_SPEC": "0"}):  # the plain decode
            ckpt, ckpt_int4 = timed_phase(card, "25 checkpoint load", phase_checkpoint, torch,
                                          card, root)
        rows["int4"] += ckpt_int4
        chat_system = build_chat_system(torch)
        with mock.patch.dict(os.environ, {"VITRON_SPEC": "0"}):  # 6 and 6b: the plain decode
            chat = phase_slice(torch, card, *chat_system)
            serve = phase_serve(torch, card, *chat_system)
        spec = phase_spec(torch, card, *chat_system)
        w4a8, rows["q1"] = timed_phase(card, "29 W4A8 decode", phase_w4a8, torch, card,
                                       *chat_system, MEASURED["decode_tok_s"])
        with mock.patch.dict(os.environ, {"VITRON_SPEC": "0"}):  # the plain decode
            mesh = collections.Counter(timed_phase(card, "31 (a) mesh chat", phase_mesh_chat,
                                                   torch, card, *chat_system))
        del chat_system
        torch.cuda.empty_cache()
        phase_cpu_vs_card(torch, card)
        timed_phase(card, "29 (b) W4A8 cpu-vs-card", phase_w4a8_cpu_vs_card, torch, card)
        mpt = timed_phase(card, "28 MPT-7B", phase_mpt, torch, card)
        from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig
        from vitron_tpu_torch.models.diffusion.unet2d import UNetConfig
        from vitron_tpu_torch.models.seem.model import SeemConfig

        dev = torch.device("cuda")
        seem_cfg = SeemConfig()
        t0 = time.perf_counter()
        seem_params = build_seem_params(torch, seem_cfg, dev, seed=0)
        system = seem_system(torch, seem_cfg, seem_params)
        torch.cuda.synchronize()
        print(f"seem: FocalNet-L + FPN pixel decoder (bf16) + SEEM decoder + language "
              f"encoder (float32) random weights built on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        task_b = phase_task_b(torch, card, system, seem_cfg)
        seem_breakdown(torch, card, system,
                       np.random.RandomState(3).randint(0, 256, (480, 640, 3), np.uint8))
        task_e = phase_task_e(torch, card, system, seem_cfg)
        del system
        t0 = time.perf_counter()
        pipe = build_gligen(torch, GligenConfig(), dev, seed=0)
        torch.cuda.synchronize()
        print(f"gligen: SD v1.4 GLIGEN UNet (4 and 9 channels), SD VAE, CLIP-L text, float32 "
              f"random weights built on the card in {time.perf_counter() - t0:.1f} s", flush=True)
        pipe = timed_phase(card, "26 (a) GLIGEN bundles", phase_gligen_checkpoints, torch, card,
                           pipe, root)
        task_a = phase_task_a(torch, card, pipe)
        task_c = phase_task_c(torch, card, pipe)
        w8a8_a, rows["q2"] = timed_phase(card, "30 (a) W8A8 task A", phase_w8a8_task_a, torch,
                                         card, pipe)
        task_c_seem = phase_task_c_seem(torch, card, pipe, seem_params, seem_cfg)
        del seem_params
        style = timed_phase(card, "(a) style request", phase_style, torch, card, pipe)
        torch.cuda.empty_cache()
        sampler = timed_phase(card, "(b) samplers", phase_samplers, torch, card, pipe)
        del pipe
        torch.cuda.empty_cache()
        grounding = timed_phase(card, "(c) grounding nets", phase_grounding, torch, card)
        backbones = timed_phase(card, "(d) SEEM backbones", phase_seem_backbones, torch, card)
        rows.update(timed_phase(card, "(e) B4 rows", phase_new_dw, torch, card))
        timed_phase(card, "(f) cpu-vs-card", phase_a9_a10_cpu_vs_card, torch, card)
        torch.cuda.empty_cache()
        phase_sd_unet_bf16(torch, card, UNetConfig.sd_v1(), dev)
        phase_unet_cpu_vs_card(torch, card, UNetConfig.sd_v1(
            channel_mult=(1,), num_res_blocks=1, attention_resolutions=(1,)), dev)
        phase_seem_cpu_vs_card(torch, card)
        from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

        t0 = time.perf_counter()
        pipe = build_t2v(torch, Text2VideoConfig(steps=TASK_D_STEPS), dev, seed=0)
        torch.cuda.synchronize()
        n_unet = sum(t.numel() for t in tree_leaves(pipe.unet_params))
        print(f"t2v: UNetSD_T2V ({n_unet / 1e9:.3f}B params), SD VAE, CLIP text (1024 wide), "
              f"float32 random weights built on the card in {time.perf_counter() - t0:.1f} s",
              flush=True)
        timed_phase(card, "26 (b) t2v .pth", phase_t2v_checkpoint, torch, card, pipe, root)
        torch.cuda.empty_cache()
        task_d = phase_task_d(torch, card, pipe)
        mesh.update(timed_phase(card, "31 (a) mesh video", phase_mesh_video, torch, card, pipe))
        from vitron_tpu_torch.core import distributed as vdist

        vdist.shutdown()
        timed_phase(card, "31 (b) ring half", phase_mesh_ring_half, torch, card)
        timed_phase(card, "31 (c) video half", phase_mesh_video_half, torch, card)
        timed_phase(card, "31 (d) multi-card legs", phase_mesh_multi, torch, card)
        for k in ("int4_matmul", "flash_attention", "geglu_ff", "temporal_conv_k3",
                  "frame_attention", "group_norm_sums"):
            check(mesh[k] > 0, f"31: the mesh path launched no {k}")
        w8a8_d, q2_video = timed_phase(card, "30 (b) W8A8 task D", phase_w8a8_task_d, torch,
                                       card, pipe)
        rows["q2"] += q2_video
        del pipe
        torch.cuda.empty_cache()
        from vitron_tpu_torch.models.diffusion.video_pipelines import Image2VideoConfig

        t0 = time.perf_counter()
        pipe = build_i2v(torch, Image2VideoConfig(steps=TASK_G_STEPS), dev, seed=0)
        torch.cuda.synchronize()
        n_unet = sum(t.numel() for t in tree_leaves(pipe.unet_params))
        print(f"i2v: UNetSD_I2VGen ({n_unet / 1e9:.3f}B params), SD VAE, CLIP text (1024 wide), "
              f"float32 random weights and a stub image embedder built on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        timed_phase(card, "26 (c) i2vgen conversion", phase_i2v_conversion, torch, card, pipe)
        torch.cuda.empty_cache()
        task_g = phase_task_g(torch, card, pipe)
        del pipe
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        editor, nets = build_task_f(torch, dev, seed=0)
        torch.cuda.synchronize()
        print(f"task F: SD v1.5 UNet, canny and depth ControlNets, DPT-hybrid, SD VAE, CLIP-L "
              f"text (float32) and IMLP atlas nets, random weights, built on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        timed_phase(card, "26 (d) task F conversions", phase_task_f_conversions, torch, card,
                    editor, nets)
        t0 = time.perf_counter()
        bundle = atlas_bundle(torch, nets)
        print(f"task F: the atlas bundle ({TASK_F_FRAMES} frames of {TASK_F_HW[0]}x"
              f"{TASK_F_HW[1]}) rendered from the converted IMLP nets on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del nets
        torch.cuda.empty_cache()
        rows.update(phase_task_f_kernels(torch, card,
                                         task_f_plan(editor, editor.text_cfg.max_length)))
        task_f = phase_task_f(torch, card, editor, bundle)
        del editor, bundle
        torch.cuda.empty_cache()
        phase_controlnet_cpu_vs_card(torch, card)
        phase_video_unet_bf16(torch, card, dev)
        phase_video_cpu_vs_card(torch, card)
        phase_i2v_cpu_vs_card(torch, card)
        timed_phase(card, "30 (c) W8A8 cpu-vs-card", phase_w8a8_cpu_vs_card, torch, card)
        torch.cuda.empty_cache()
        weights = timed_phase(card, "27 the deployment from one weights directory",
                              phase_weights, torch, card, root)
        shutil.rmtree(root)
    train_rows = phase_train_kernels(torch, card)
    rows["flash"] += train_rows.pop("flash_lse")
    rows["int4"] += train_rows.pop("int4_train")
    rows.update(train_rows)
    base = train_base(torch)
    train = phase_train(torch, card, base)
    train_mesh = timed_phase(card, "32 sharded train step", phase_train_mesh, torch, card, base)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_cpu_vs_card(torch, card)
    diffusion_rows = timed_phase(card, "21 diffusion trainers' kernels",
                                 phase_diffusion_train_kernels, torch, card)
    train_gligen = timed_phase(card, "22 GLIGEN training", phase_train_gligen, torch, card)
    train_video = timed_phase(card, "23 video training", phase_train_video, torch, card)
    train_i2vgen = timed_phase(card, "23 i2vgen training", phase_train_video, torch, card,
                               "i2vgen")
    timed_phase(card, "24 diffusion trainers cpu-vs-card", phase_train_cpu_vs_card_diffusion,
                torch, card)
    rows["flash"] += diffusion_rows.pop("flash_lse_diffusion")
    rows["bwd_kv"] += diffusion_rows.pop("bwd_kv_diffusion")
    rows["bwd_q"] += diffusion_rows.pop("bwd_q_diffusion")
    rows["gn"] += diffusion_rows.pop("gn_gligen_train") + diffusion_rows.pop("gn_video_train")
    rows["tconv"] += diffusion_rows.pop("tconv_train")
    rows["tattn"] += diffusion_rows.pop("tattn_train")
    rows["geglu"] += diffusion_rows.pop("geglu_video_train")
    check(not diffusion_rows, f"rows left unplaced: {sorted(diffusion_rows)}")

    def entry(name, source, replaces, key, launches, paths):
        r = rows[key]
        bytes_ms, ops_ms = sum(x["bytes_ms"] for x in r), sum(x["ops_ms"] for x in r)
        lib = [x["library_ms"] for x in r]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": paths,
                "max_abs_err": max(x["err"] for x in r),
                "max_rel_err": max(x["rel"] for x in r), "ms": sum(x["ms"] for x in r),
                "plain_ms": sum(x["plain_ms"] for x in r),
                "bound_ms": sum(max(x["bytes_ms"], x["ops_ms"]) for x in r),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None if None in lib else sum(lib),
                "ms_is": f"sum over the {len(r)} main-path shapes above"}

    def paths(name):
        return {"chat": chat[name], "serve": serve[name], "spec": spec[name],
                "checkpoint": ckpt[name],
                "task_a": task_a[name], "task_f": task_f[name],
                "task_c": task_c[name],
                "task_b": task_b[name], "task_e": task_e[name], "task_c_seem": task_c_seem[name],
                "task_d": task_d[name], "task_g": task_g[name], "train": train[name],
                "style": style[name], "samplers": sampler[name], "grounding": grounding[name],
                "seem_backbones": backbones[name], "train_gligen": train_gligen[name],
                "train_video": train_video[name], "train_i2vgen": train_i2vgen[name],
                "weights": weights[name], "mpt": mpt[name], "w4a8": w4a8[name],
                "mesh": mesh[name], "train_mesh": train_mesh[name],
                "w8a8": w8a8_a[name] + w8a8_d[name]}

    rows["flash"] += rows.pop("flash_gligen") + rows.pop("flash_vae") + rows.pop("flash_vae_i2v")
    print_b2_rows(rows["flash"], card)
    rows["flash"] += rows.pop("flash_f")
    rows["geglu"] += rows.pop("geglu_video") + rows.pop("geglu_video_i2v") + rows.pop("geglu_f")
    rows["gn"] += rows.pop("gn_video") + rows.pop("gn_video_i2v") + rows.pop("gn_f")
    rows["dw"] += rows.pop("dw_new")
    rows["tconv"] += rows.pop("tconv_i2v")
    rows["tattn"] += rows.pop("tattn_i2v")
    print(json.dumps({"kernels": [
        dict(entry("int4_matmul", "vitron_tpu_torch/csrc/int4_matmul.cu",
                   "vitron_tpu/kernels/int4_matmul.py:108", "int4", chat["int4_matmul"],
                   paths("int4_matmul")),
             reference_ms=sum(r["ref_ms"] for r in rows["int4"]),
             reference_is="torch.matmul of x with the weight dequantized to bf16 beforehand, "
                          "summed over the same rows: other inputs (four times the weight "
                          "bytes), not a port and not a library call of this function"),
        entry("flash_attention", "vitron_tpu_torch/csrc/flash_attention_fwd.cu",
              "vitron_tpu/kernels/flash_attention.py:242", "flash",
              task_a["flash_attention"], paths("flash_attention")),
        entry("geglu_ff", "vitron_tpu_torch/csrc/geglu_ff.cu",
              "vitron_tpu/kernels/geglu_ff.py:90", "geglu", task_a["geglu_ff"],
              paths("geglu_ff")),
        entry("group_norm_sums", "vitron_tpu_torch/csrc/group_norm.cu",
              "vitron_tpu/kernels/group_norm.py:75", "gn", task_a["group_norm_sums"],
              paths("group_norm_sums")),
        entry("depthwise_conv2d", "vitron_tpu_torch/csrc/depthwise_conv.cu",
              "vitron_tpu/kernels/depthwise_conv.py:66", "dw", task_b["depthwise_conv2d"],
              paths("depthwise_conv2d")),
        entry("temporal_conv_k3", "vitron_tpu_torch/csrc/temporal_conv.cu",
              "vitron_tpu/kernels/temporal_conv.py:81", "tconv", task_d["temporal_conv_k3"],
              paths("temporal_conv_k3")),
        entry("frame_attention", "vitron_tpu_torch/csrc/temporal_attention.cu",
              "vitron_tpu/kernels/temporal_attention.py:97", "tattn", task_d["frame_attention"],
              paths("frame_attention")),
        dict(entry("flash_attention_bwd_kv", "vitron_tpu_torch/csrc/flash_attention_bwd.cu",
                   "vitron_tpu/kernels/flash_attention.py:429", "bwd_kv",
                   train["flash_attention_bwd_kv"], paths("flash_attention_bwd_kv")),
             library_is="F.scaled_dot_product_attention's backward (dq, dk and dv in one "
                        "call), beside B5a + B5b"),
        dict(entry("flash_attention_bwd_q", "vitron_tpu_torch/csrc/flash_attention_bwd.cu",
                   "vitron_tpu/kernels/flash_attention.py:450", "bwd_q",
                   train["flash_attention_bwd_q"], paths("flash_attention_bwd_q")),
             library_is="none alone: the SDPA backward, which also gives dk and dv, stands "
                        "on flash_attention_bwd_kv's entry"),
        dict(entry("conv3x3_same", "vitron_tpu_torch/csrc/conv3x3.cu",
                   "vitron_tpu/kernels/conv2d.py:99", "conv3x3",
                   sum(paths("conv3x3_same").values()), paths("conv3x3_same")),
             library_is="cuDNN F.conv2d on the bf16-rounded x and w (channels-last, bf16 in, "
                        "float32 sums); no main path calls conv3x3_same, in JAX or in the "
                        "port, so it has no launches there: held at task G's 16 eligible 3x3 "
                        "shapes",
             ms_is="sum over phase 5c's 32 rows (task G's 16 eligible 3x3 shapes x float32 "
                   "and bf16); library_ms is cuDNN's bf16 conv on both rows of a shape"),
        dict(entry("w4a8_matmul", "vitron_tpu_torch/csrc/w4a8_matmul.cu",
                   "vitron_tpu/kernels/quantization.py:130", "q1", w4a8["w4a8_matmul"],
                   paths("w4a8_matmul")),
             replaces_is="no pallas_call: JAX's _w4a8_matmul is an XLA dot_general (s8 x s4, "
                         "int32 sums)",
             reference_ms=sum(r["ref_ms"] for r in rows["q1"]),
             reference_is="B1 (int4_matmul) on the same x and weight, summed over the same "
                          "rows: the product Q1 replaces on the W4A8 decode path, not a library "
                          "call (no PyTorch call takes the int4 packing)"),
        dict(entry("conv2d_w8a8", "vitron_tpu_torch/csrc/conv2d_w8a8.cu",
                   "vitron_tpu/kernels/quantization.py:277", "q2", w8a8_a["conv2d_w8a8"]
                   + w8a8_d["conv2d_w8a8"], paths("conv2d_w8a8")),
             replaces_is="no pallas_call: JAX's conv2d_w8a8 is an XLA conv_general_dilated "
                         "(s8 x s8, int32 sums)",
             replaced_path_ms={t: sum(r["replaces_ms"][t] for r in rows["q2"])
                               for t in ("float32", "bf16")},
             replaced_path_is="cuDNN F.conv2d in float32 and bf16 at the same sites, the path "
                              "the quantized UNets replace, not a port and not a library call "
                              "of this function (PyTorch has no int8 conv on CUDA)",
             ms_is=f"sum over phase 30's {len(rows['q2'])} rows: every eligible conv site of "
                   "task A's SD UNet and task D's t2v UNet, once each"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
