#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on an NVIDIA GPU and check them.

Run from the repository root, on a machine with one CUDA card (an H100):

    python3 chip_smoke.py [--out DIR] [--profile] [--phases LIST]

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit;
   builds the kernels of `eetq_tpu_torch/csrc/` with nvcc (one process per
   source, all at once). It reads ptxas's `-Xptxas=-v` report and lists the
   kernels whose `wgmma`s ptxas serialized (warning C7520); the run fails if
   any of them is behind `w8a16_gemm`, `w4a16_gemm`, `w8a8_gemm`, `w4a8_gemm`
   or the prefill flash-attention. It prints the registers and spill bytes
   of the attention kernels' head-dim-256 instances (the same report, per
   instance, goes to chip_smoke.json). It counts the tensor-core MMAs (`HMMA.16816`) of every
   decode GEMV kernel in the library's SASS (`cuobjdump -sass`) and fails if
   one has none.
2. Kernels: each of the seventeen kernel entry points against its plain
   PyTorch version on the card at llama2-7b shapes (the MoE kernels at
   Mixtral-8x7B's), with its error, its time beside the plain time, the
   least time the card could take for the same bytes and operations (from
   the shapes and the datasheet rates) and, for the two attention kernels,
   the time of `F.scaled_dot_product_attention` on the same inputs (a
   yardstick: the port never calls it). Every kernel and library call is
   timed twice: one launch between two events after an L2 flush (median of
   20; under 0.1 ms this holds the wrapper's host time), and many launches
   back to back, captured in a CUDA graph, between two events. Prefill
   attention also runs GQA 32/8, ragged lengths (77, 1000), D = 64, a query
   block appended to a cache (delta 256) and a batch of four short prompts;
   the per-channel int8 GEMM also runs m = 9, 200 and 512 and an odd (K, N)
   with bias. The decode GEMVs' summaries keep two regimes apart, m = 1 (b=1
   decode) and m = 8 (an 8-slot engine step); the int8 per-channel GEMV and
   GEMM rows are also timed against `torch._weight_int8pack_mm`, the int4
   g=128 rows against `torch._weight_int4pack_mm` (the yardsticks' packed
   weights made outside the timed call; where the card's PyTorch has no CUDA
   kernel for one, the exception is printed and `library_ms` is null). Every
   GEMV, expert-gather, fused-MLP and flash-decode case runs twice and must
   give bit-equal outputs. The int8 flash-decode's summary keeps two regimes
   apart, B=1 over 1152 keys (b=1 decode) and B=8 over 2048 (an 8-slot
   engine step). The int4 kernels run per-channel
   and with 128-row scale groups, the W8A8 and per-channel W4A8 outputs
   must equal their plain versions bit for bit, and one odd shape each
   needs padding in K and N. Paged decode (bf16 and int8 pools) runs 8
   rows of lengths 1..1088 over 256-token blocks behind a permuted table
   whose dead entries point out of the pool, and must be bit-equal to the
   dense kernel on the gathered cache. The two MoE kernels run int8 and
   int4 banks, per-channel and with 128-row scale groups; the grouped GEMM
   at bm = 128 (a prompt: the wide tile), bm = 8 (an 8-slot engine step: the
   skinny tile), 16 and 64, with the padding blocks skipped by their count,
   and its summary keeps the prompt and the engine-step regimes apart. The
   flash-decode's multi-query mode (S query tokens a row, the verify of
   speculative decoding) runs in its four entry points: b=1 at S = 2 and 8
   over 1152 keys (length 1074), Mixtral's GQA 4 at S = 8 (32 query rows a
   kv head), the dense engine's 8 rows at S = 8 over 2176 keys, and 8 paged
   rows of lengths 1..1088 at S = 8 behind a permuted table; each against
   its plain version, its repeats bit-equal and every token bit-equal to a
   one-token call at its own length (paged also to the dense kernel), with
   `F.scaled_dot_product_attention` under an explicit [S, L] mask beside
   the bf16 MHA cases. The attention kernels' variants (a sliding window,
   ALiBi, a GQA group other than 1, 2, 4, 8) run at the shapes of the
   families below, each recorded as "kernel[variant]": prefill under
   mistral's 4096-key window at S = 4608 and a 256-key window at 1024,
   baichuan-13b's 40 ALiBi heads, qwen2's group 7 and chatglm3's 16; the
   four flash-decode entry points under the window (over 4672 keys at B =
   1 and 8, over 1152 with a 256-key window, and over mistral's 32,768-key
   capacity), ALiBi and both groups at B = 1 and 8 (paged over a table
   whose entries before the earliest window and past the length point out
   of the pool, bit-equal to the dense kernel on the same keys); S = 8
   under a window and ALiBi, S = 9 at G = 7 and S = 4 at G = 16, each token
   bit-equal to a one-token call. Their bounds count only the keys a row's
   window holds; SDPA under the same float mask (bias and -inf) is the
   yardstick of the bf16 cases. Head dim 256 (gemma-7b, recorded as
   "kernel[d256]"): prefill at B=1 S=1024 over 16 heads, also under a
   256-key window and with ALiBi; the four flash-decode entry points at b=1
   over 1280 keys (length 1074), in an 8-slot step over 2048, under a window
   and with ALiBi; verifies of 8, 16 and 32 query rows a kv head (S = 8 at
   G = 1, S = 4 at G = 4 over 8 rows, S = 2 at G = 16), each token bit-equal
   to a one-token call; paged bit-equal to dense throughout. The verify past
   one row block of the flash-decode (ROW_BLOCK_CASES: chatglm3-6b's 32/2 at
   S = 8, 128 query rows a kv head, at b=1 and in an 8-slot step; 32/4 at S
   = 9, 72 rows; each plain, under mistral's window and with ALiBi; at head
   dim 256 64 rows), in the four entry points, each token bit-equal to a
   one-token call and paged bit-equal to dense. The prefill flash-attention
   at chunked prefill's shapes (CHUNK_ATTENTION_CASES: a 512-token chunk
   over 4096 keys, mistral's over 4608 under its window, bench.py's b=4
   chunks of 256) over the cache read in place as [B, L, Hkv, D], against
   its plain version, bit-equal to the kernel on contiguous keys, beside
   SDPA under a lower-right causal bias (a float mask under the window).
   The GEMMs' fused epilogue (EPILOGUE_SHAPES): relu, gelu and silu on the
   gate|up shape and a residual added and multiplied on the o_proj shape, all
   with a bias, in the GEMV (m = 1, 8), the GEMM and the W8A8 / W4A8 GEMM (m =
   1024), int8 per-channel and int4 g = 128, each against its plain version
   and recorded as "kernel[epilogue]" beside the bias-only kernel's times on
   the same inputs (the int8 W8A8 cases without a transcendental bit-equal).
   The int8 GEMV and GEMM with group-wise scales, recorded as
   "kernel[group]" (TP_GROUP_CASES: the offline tensor-parallel reshard's
   o_proj at g = 2048 and down at g = 5504, tp = 2, and down at g = 1376, tp
   = 8, the GEMM's second group tile; the GEMV at m = 1 and 8, the GEMM at
   1024; g = 128 on qkv), and the per-channel GEMM at both of its tiles
   (`tile_m` 128 and 256) at m = 256 and 512 on the four prefill shapes.
   Then `moe_apply` on one full-width Mixtral layer (int8 per-channel, and
   int4 g=128) at 2, 8 and 2048 selections, kernels against the plain path
   on identical input (the routing ids must agree), the kernel calls under
   `torch.cuda.set_sync_debug_mode("error")`: any host sync fails; and on
   the int8 layer each MoE A/B knob in turn (MOE_KNOB_CASES:
   EETQ_MOE_NO_GATHER at a decode step, no expert gather launched;
   EETQ_MOE_NO_GROUPED at a prompt, no grouped GEMM; EETQ_MOE_GROUPED_BM = 32
   at a prompt and 128 at an 8-slot step, the skinny and the wide tile),
   against the plain path with the routing replayed.
3. Model: llama2-7b at full width and depth (32 layers), random weights
   from a seeded `torch.Generator` on the card, W8A16 per-channel with an
   int8 lm_head, built once and driven four ways. Each path runs with the
   launch counters set to 0 just before it and read just after, and every
   kernel it runs must have launched.
   - generate: bf16 KV, unfused MLP, W8A16 prefill; prefill and one decode
     step against the plain path (the decode step must make as many GEMV
     launches as before the tensor-core GEMV: 4 a layer + the lm_head, 129),
     then batch 1 x 1024-token prompt x 50 greedy tokens and batch 4 x 128 x
     32. `decode_loop` runs on the card as one captured step replayed
     (`serve/graph.py`): its 50 greedy tokens must be bit-equal to a Python
     loop of eager `decode_step` on a copy of the same caches, and its
     launch counts those of 49 eager steps (a replay adds its capture's).
     The timing prints ms/step over the 49 steps, and apart the eager
     warm-up step, the capture and the ms of a replayed step.
   - bench decode (`bench.py`'s configuration): prefill into an int8 KV
     cache, then `decode_loop(fused_mlp=True)`; the same checks and
     requests, and prefill/decode times beside the generate path's.
   - server: `Engine(params, cfg, max_batch=8, max_len=2048)` with its
     defaults (which must resolve to W8A8 prefill, int8 KV, decode windows
     of 8 chained up to 8; `warmup()` and `warmup(temperature=0.8)` capture
     the greedy and the sampled window-1 and window-8 programs) behind
     `EngineServer` on 127.0.0.1; about 12 HTTP requests of mixed prompt
     lengths and budgets from several threads; one admission's logits
     against the plain path; `w8a16_gemm` must not launch; the greedy
     requests' tokens equal those of an `Engine(decode_window=1)` twin.
   - text_server: the same default engine behind `EngineServer(tokenizer=)`,
     a byte-level BPE of 32,000 ids made from seeded words
     (`text_tokenizer`); 4 greedy text prompts from threads (one streamed):
     their tokens equal those of the prompts sent as ids, "text" equal to
     decode(tokens), the stream's text deltas concatenated to its text; a
     server without a tokenizer answers a text prompt 400.
   - paged_server: `Engine(..., paged_blocks=41)` (40 blocks of 256 tokens
     and the trash block) behind the same server and requests. It must
     resolve to W8A8 prefill and a bf16 pool; the paged flash-decode kernel
     launches 32 times per decode step and the dense flash-decode entry
     points not at all; the logits of one 8-slot engine step are held
     against the plain path; every block is back on the free list at the
     end; and the greedy requests' tokens equal those of a window-1 engine
     with a dense bf16 cache.
   - bench_decode_chunked: `bench.py` under EETQ_BENCH_PREFILL_CHUNK=256:
     b=4 p=1024 through `prefill_chunked(chunk=256)` into an int8 cache (four
     chunks, each attention on the prefill kernel: 4 launches a layer), then
     `decode_loop(fused_mlp=True)`; its logits within MODEL_TOL of the
     unchunked prefill's and of the chunked plain path's; the chunked
     prefill timed against the unchunked one in turns.
   - chunked_server, chunked_paged_server: `Engine(prefill_chunk=512,
     max_len=4096)` (W8A16 admissions; dense int8, then a paged bf16 pool of
     80 blocks), warmed up, ten requests (two of 3,300 and 3,500 tokens,
     bucket 4096: eight chunks each, queued behind six short ones): every
     chunk runs beside busy slots, each of which commits a token in the same
     step; the greedy tokens equal the same engine's without prefill_chunk,
     or part at a near tie (SPEC_TIE_ULPS); every block freed.
   - ngram_spec, ngram_spec_bench, draft_spec: speculative decoding at b=1
     (k = 7; a verify is m = 8, the GEMV) on a seeded 64-token sequence
     tiled to 1024 tokens: `ngram_spec_generate` with bf16 KV and with
     bench decode's int8 KV + fused MLP, and `spec_generate` with the
     target's first 8 layers and its head as the draft. Greedy tokens must
     be bit-equal to `decode_loop`'s; rounds, accepted drafts, ms a
     replayed round and ms an emitted token are printed beside decode_loop's
     ms/step, timed in turns.
   - spec_server, spec_paged_server: the same HTTP requests through
     `Engine(spec_ngram=7)` (dense int8 cache; then `paged_blocks=41`, a
     bf16 pool), warmed up so that every program is a captured graph; the
     paged one's 8-slot verify round held against the plain path and every
     block freed. Greedy requests must equal the non-spec window-8 twin's,
     or differ first where the twin's tokens leave a near tie (both tokens'
     logits there within SPEC_TIE_ULPS bf16 ulps of the largest |logit| of
     the top one, on the kernel path): an 8-slot verify is m = 64 rows, the
     GEMM, where the twin runs the GEMV.
   llama2-7b is freed before the next model is built.
4. llama2-7b again with int4 weights, at full width and depth, built one
   layer at a time (`random_quantized_params`, 3.6-3.9 GB), two models:
   - int4_generate: int4 with 128-row scale groups, the lm_head quantized
     the same way; bf16 KV, unfused MLP; as `generate` in 3. Runs the int4
     GEMV and GEMM; no int8 and no W8A8/W4A8 kernel may launch.
   - int4_server: the same model in the default Engine behind EngineServer,
     as `server` in 3: W4A8 (group-wise) at admission, the int4 GEMV at
     decode; the int4 GEMM and W8A8 must not launch.
   - int4_bench_decode (`EETQ_BENCH_BITS=4 python bench.py`'s model): int4
     per-channel layers under an int8 lm_head; int8 KV,
     `decode_loop(fused_mlp=True)`; as `bench decode` in 3. Runs the int4
     fused MLP, the int4 GEMV (qkv, o) and the int8 GEMV (lm_head).
5. Mixtral-8x7B W8A16 at full width and depth (32 layers, 8 experts of
   4096 x 14336, top-2), built one layer at a time (the bf16 model,
   ~93 GB, never exists), int8 lm_head, driven two ways: generate (as in
   3, the same requests) and the default Engine behind EngineServer (as in
   3), and `Engine(spec_ngram=3)` over the same default engine
   (mixtral_spec_server: at k = 3 a b=1 verify's 8 expert selections stay
   in the gather regime): one 8-slot verify round against the plain path
   with the routing replayed, greedy requests equal to its non-spec twin's
   with the routing replayed across both engines (`routed_twin`, 11.; on
   the model's first MIXTRAL_SPEC_TWIN_LAYERS = 8 layers, both engines
   eager), or parting at a near tie of the tokens' logits, rounds and
   drafts a round printed. The fused MLP
   must not launch on any. Top-2 routing is
   discontinuous, so each check of the logits replays the kernel path's
   routing in the plain path (a wrapper of `modules.moe.route` records
   each call's weights and ids, then hands them back in order); how many
   routings the plain path would pick otherwise is printed too.
6. Mixtral-8x7B again at W4A16 with 128-row scale groups throughout (expert
   banks, attention linears, lm_head; 32 layers, built one layer at a
   time): mixtral_int4_generate (the int4 grouped GEMM at prefill, the int4
   expert gather at decode; the int8 bank kernels must not launch) and
   mixtral_int4_paged_server (`Engine(..., paged_blocks=41,
   kv_dtype=torch.int8)`: W4A8 attention linears at admission, the int4
   grouped GEMM at admission and at every 8-slot step, the paged int8
   flash-decode; the bf16 one must not launch), checked as in 5.

7. Families (FAMILIES): mistral-7b (window 4096, GQA 4), qwen2-7b (group
   7, qkv bias, a 152,064-token vocabulary), chatglm3-6b (group 16,
   interleaved half rope), baichuan-13b (ALiBi over 40 heads, no rope) and
   gemma-7b (16 heads of 256, GeGLU, unit-offset norms at gain 1, the
   embedding multiplier, a tied 256,000-token head: the bf16 table, its
   device time printed at 1 and 8 rows),
   each at full width and depth, W8A16 per-channel with an int8 lm_head
   (gemma: tied),
   built one layer at a time and freed before the next: a b=1 decode path
   as in 3 (prefill and one decode step against the plain path, the
   replayed decode_loop's 50 greedy tokens bit-equal to eager steps, timed;
   mistral over a 4608-token prompt so that its window bites, bf16 KV;
   qwen2 int8 KV; chatglm3 bf16 KV; baichuan-13b and gemma-7b `bench.py`'s
   int8 KV and fused MLP) and an engine behind the server (mistral paged bf16
   with a request of 4400 + 64 tokens and a step check over a 4465-key row;
   qwen2 and baichuan-13b dense int8; chatglm3 a paged int8 pool; gemma-7b a
   paged bf16 pool), greedy tokens equal to a window-1 twin's; each family
   cut to FAMILY_LAYERS = 8 layers for the run's time limit.
   mistral_chunked: the 4608-token
   prompt through `prefill_chunked(chunk=512)` (nine chunks, the later ones
   under the window), logits within MODEL_TOL of the unchunked prefill's,
   then 50 greedy tokens. chatglm3-6b at the reference's k = 7 (a verify of
   128 query rows a kv head: two row blocks): `ngram_spec_generate` at b=1,
   greedy tokens bit-equal to `greedy_generate`'s, and `Engine(spec_ngram=7)`
   over a paged int8 pool behind the server, against its window-1 twin. A
   family path launches its kernels' variant and nothing else of the port.

8. Checkpoints (the `checkpoint` phase, run after 3): llama2-7b W8A16 with
   an int8 lm_head at full width and depth, built as in 3, saved by
   `EETQCausalLM.save_quantized` at the default 4 GiB shards (two shards and
   an index, in a temporary directory), loaded by
   `AutoEETQForCausalLM.from_quantized` onto the card: every int8 tensor
   equal, every tensor the format stores in fp16 (scales, norms, the
   embedding) equal to the source's as fp16 holds it, the count of values
   fp16 changes printed by kind (the scales must round-trip exactly), then
   bench decode's 50 greedy tokens (b=1 p=1024, int8 KV, fused MLP) of the
   loaded model (checkpoint_llama) bit-equal to the source's as stored;
   GB on disk, save and load seconds and GB/s printed. checkpoint_dense_import:
   an fp16 HF-layout llama checkpoint of llama2-7b's width at 2 layers
   written by the port's own writer, `from_pretrained(quantize=True)`
   bit-equal to `eet_quantize` of the same dense params built in memory,
   its prefill within MODEL_TOL of the plain path. checkpoint_mixtral:
   Mixtral-8x7B W8A16 at full width and 2 layers, the same round trip
   (per-expert w1/w3/w2, the router as fp16), generate's decode (bf16 KV).
   Each directory is deleted after its model.

9. LoRA (the `lora` phase, after 8): llama2-7b W8A16 with an int8 lm_head
   at full width, cut to LORA_LAYERS = 16 layers. eval_ppl (`serve/eval.py`, while the bf16 model
   the W8A16 one is quantized from is still held): `delta_ppl` over 4
   seeded windows of 2048 tokens (random weights: PPL and ΔPPL printed,
   unbounded), the W8A16 kernel path's mean NLL within EVAL_NLL_TOL nats of
   its plain path's and its perplexity within EVAL_MANUAL_RTOL of a
   straight-line per-window cross-entropy, ms a window and tokens/s.
   epilogue_linear: `linear_apply(activation=,
   residual=)` and `w8a16_matmul(residual_mode="mul")` on layer 0's gate|up
   and o_proj, int8 and requantized to int4 g = 128, at m = 1, 8, 1024 and
   a8, against the plain path (every epilogue variant must launch). Then a
   bank of LORA_ADAPTERS adapters of rank LORA_RANK on every qkv and o_proj
   (`surgery.stack_adapters`; its single-adapter twins are slices of the
   bank over the same base, no copy): lora_prefill (b = 4 prompts of 1024
   tokens, row i on adapter i, every position's logits against twin i's and
   the plain path; the bank's prefill and the base's timed in turns);
   lora_train: LoRA finetuning through the autograd Functions around the
   GEMM and the prefill flash-attention (`ops/linear.py::DequantMatmul`,
   `kernels/flash_attention.py::FlashAttention`): twin 0's adapters cloned,
   b = 1 x 1024 seeded tokens, next-token cross-entropy, every adapter
   tensor's gradient finite, nonzero and within TRAIN_TOL of the plain
   path's at the phase's depth, only the GEMM and the flash-attention
   launched; ms
   a forward + backward (the forward and the backward apart), training
   tokens/s, peak GB, the backward's device ms on the attention and on the
   linears (CUDA events around each call of their backward), and
   TRAIN_STEPS SGD steps that must lower the loss; the
   side path's kernel launches and device ms in an eager 8-slot decode step
   (torch.profiler, bank against base); lora_server (dense int8),
   lora_paged_server (a bf16 pool) and lora_spec_server (`spec_ngram=3`),
   W8A16 admission, 12 greedy HTTP requests with adapters mixed, each equal
   to its twin's `greedy_generate` or parting at a near tie (SPEC_TIE_ULPS),
   the same engine over the base serving the same requests in turn (served
   tok/s of both); every adapter must move some request's tokens off the
   base model's; lora_merge: `merge_lora` of adapter 2, the requantized
   weights that moved counted, its prefill logits against the bank at id 2
   within the JAX test's bounds (mean |diff| < 0.05, argmax equal at > 90%).

10. Tooling (the `tooling` phase, after 9): `native.host_symmetric_quantize`
   of llama2-7b's gate|up on the host (f32 and bf16, per-channel and g =
   128, int4 packed by `host_pack_int4`) bit-equal to the card's quantizer,
   seconds and GB/s printed; `utils/profiling.py`: `profile_w8a16_matmul` at
   the four layer shapes at m = 1 and 1024 (reports printed, no fraction of
   the roof above ROOF_SLACK), `device_time` within DEVICE_TIME_AGREE of
   `time_many_ms` on the same calls in turns, a `trace` holding kernel
   events. Then llama2-7b built dense at full width and depth, quantized by
   `EETQCausalLM.quantize(tp=2)` (o_proj and down int8 group-wise at K / 2,
   the lm_head dense) and for tp = 1: tp_generate (generate's b=1 path, bf16
   KV, p = 1024, 50 greedy tokens; the int8 group-wise launches counted as
   "w8a16_gemv[group]" and "w8a16_gemm[group]"; the largest gap of its
   prefill logits to the tp = 1 model's printed), tp_checkpoint (its round
   trip as in 8, `config.json` recording tp 2), autotune (the measured sweep
   of llama2-7b's four projections at m = 1, 8, 256, 512 and 1024 into the
   run's own cache file, which `main` points EETQ_AUTOTUNE_CACHE at before
   anything runs: each winner re-read against the rule in turns and no more
   than AUTOTUNE_SLOWER slower, the lookups reading the file back, b=1
   decode with the tuned cache against the rules in turns, tokens equal or
   parting at a near tie; the file removed after) and tp_ranks (layer 0 at
   tp 2, 4, 8 int8 and 2 int4: each rank's shard through the kernels one
   rank at a time at m = 1 and 1024, the row shards' partials summed in f32,
   against the merged layer within MODEL_TOL). It also launches each
   flash-decode entry point (dense and paged, bf16 and int8) 64 times at an
   8-slot step's shape, each into its own NaN-filled `out` buffer, under
   `torch.profiler`: every buffer written, equal to the first and to the
   plain version, the launch counter 64; the profiler's kernel events are
   printed beside it (a lost event and a skipped launch told apart).

11. Sharded (the `sharded` phase, last): tensor and expert parallelism over
   SHARDED_TP = 2 ranks that the script spawns (`eetq_tpu_torch/dist/
   launch.py`), each a process holding its shard and launching the port's
   kernels on it: NCCL on cuda:rank where there is a card for each rank,
   else gloo with both ranks on cuda:0 (the backend is printed; gloo stages
   every collective through the host, so the ranks' steps run eagerly and
   their times model no NVLink deployment). Each rank's launch and
   collective counters go back to the parent, which sums them per path.
   - tp2_generate: llama2-7b W8A16 cut to SHARDED_LLAMA_LAYERS = 2 layers
     (the run's time limit; the split is the same in every layer), built
     dense from the seed and saved by `quantize(save_dir, tp=2)`; each rank
     runs `from_quantized(dir)
     .shard(mesh)` (o_proj and down per-channel on a rank); b=1, p=1024:
     prefill logits and 49 teacher-forced decode steps within MODEL_TOL of
     the largest logit of the tp = 1 run of the same artifact, 50 greedy
     tokens equal to it or parting at a near tie (SPEC_TIE_ULPS), the ranks
     identical, one forward's collectives 2 L all-reduces and one vocab
     gather with their bytes (`count_collectives`); prefill ms and ms/step.
   - tp2_server: `Engine(sharded)` on both ranks (bf16 KV, W8A16 prefill,
     windows of 8, eager) over server's mix of 12 requests (2 sampled):
     greedy requests equal to the one-card engine's on the tp = 1 twin or a
     near tie; the ranks' outputs identical.
   - tp2_spec_server: `Engine(sharded, spec_ngram=7)`, greedy requests
     equal to tp2_server's or a near tie (its 8-slot verify is the GEMM).
   - mixtral_ep2: Mixtral-8x7B at full width cut to SHARDED_MIXTRAL_LAYERS
     = 2 layers (the EP code is the same in every layer), drawn layer by
     layer from the seed in each rank, `shard_model(quantize=True)`: 4
     experts a rank; every shard's integer sums and scales equal to the
     one-card model's slice (qkv per channel, o_proj group-wise at K / 2,
     the banks per expert), prefill and 15 decode steps against that model
     with rank 0's routing replayed, within MODEL_TOL, no near-tie pass.
   - dp2tp2_generate: the tp2 artifact on 4 ranks, dp 2 x tp 2
     (`make_mesh(tp=2, dp=2)`; each data shard's ranks hold the same
     shards), b = 2 (one seeded 1024-token prompt a data shard) through
     `make_forward_fn`: prefill logits and 49 teacher-forced decode steps
     of each row within MODEL_TOL of the tp = 1 run of the same artifact at
     b = 2, 50 greedy tokens equal or parting at a near tie, the two ranks
     of a data shard identical, one prefill forward's collectives those of
     tp2_generate (2 L all-reduces of 1 p H 2 bytes, one vocab gather), and
     one data-axis gather, of the tokens, at the end of the run.
   - dp2tp2_server: `EngineServer` on rank 0 over `Engine(sharded)` on the
     4 ranks (max_batch 8, 4 slots a data shard; the other ranks
     `serve.api.follow`), the 12 requests over HTTP from 4 threads: greedy
     requests equal to the one-card engine's or a near tie, every rank's
     outputs identical, admission rounds of at most 2 requests; served tok/s.
   - dp2tp2_spec_server: `Engine(sharded, spec_ngram=7)` on the same ranks
     driven directly: greedy requests equal to dp2tp2_server's or a near tie;
     its rounds (the most over the data shards) and tokens a round.
   The Mixtral spec engine (5.) is held to its twin by the same kind of
   replay (`routed_twin`): both engines eager, routing keyed by (prompt,
   position, token) recorded in the twin and replayed in the spec engine;
   equal, or a near tie of the logits only.
12. Pipeline (the `pipeline` phase, last): pipeline parallelism and
   sequence-parallel long-context prefill over ranks the script spawns, as
   the sharded phase's (gloo on cuda:0 with one card). Each path is
   compared with the one-card twin holding the same integers, run by
   `prefill` and `decode_loop`: last-token logits within MODEL_TOL of the
   largest, tokens equal or parting at a near tie (SPEC_TIE_ULPS), the
   ranks identical, every exchange and collective of a rank counted as the
   schedule predicts; the ranks' launch counts summed per path.
   - pp2_generate: llama2-7b W8A16 at full width cut to PP_LAYERS = 8
     layers, 4 a stage (`shard_model_pp(quantize=True)`, each rank drawing its stage
     layer by layer from the seed), b=2 in 2 microbatches, p=1024: pp_prefill
     and pp_decode_loop timed (prefill ms, ms a decode tick), then the main
     path, pp_generate of 50 greedy tokens.
   - pp2tp2_generate: the same model cut to PP_TP_LAYERS = 4 layers on 4
     ranks (pp 2 x tp 2), 16 tokens; each rank's integers equal to the
     twin's slice (qkv and gate|up per channel, o_proj and down group-wise at
     K / 2); 2 model-axis all-reduces a layer a unit and no vocab gather.
   - pp2dp2_generate: the model cut to PP_DP_LAYERS = 4 layers on 4 ranks
     (`make_pp_mesh(pp=2, dp=2)`: two pipelines of 2 stages, 2 layers a
     stage), b = 4 (2 rows a data shard) in 2 microbatches, 16 tokens; the
     logits and tokens gathered over `data` once each.
   - long_generate: mistral-7b W8A16 (window 4096) cut to LONG_LAYERS = 8
     layers, replicated on 2 ranks,
     b=1, p=8192: long_prefill timed (its logits, and its gathered caches
     over the prompt against the twin's within MODEL_TOL of a layer's largest
     value), then the main path, generate_long of 50 greedy tokens; 2 p
     ppermutes a layer, 1 logits gather and 2 L K/V gathers.
13. Presets (the `presets` phase, after 7; PRESET_MODELS): the five
   presets of `models/config.py` that no other phase runs, each at full
   width and depth, built one layer at a time and freed before the next,
   through a b=1 decode path (p = 1024, 50 greedy tokens) and an engine
   behind the server, checked as the families in 7: llama2-13b (40 heads of
   MHA, `bench.py`'s int8 KV + fused MLP at K = 5120; dense int8 engine,
   W8A8 admission), llama3-8b (a 128,256-token int8 lm_head, rope_theta
   500,000, group 4; bf16 KV; a paged bf16 pool), baichuan-7b (model_type
   baichuan with rope and no ALiBi, a 125,696-token lm_head; int8 KV + fused
   MLP; dense int8), tinyllama-1.1b (head dim 64 at group 8; bf16 KV; a
   paged int8 pool) and, last, llama2-70b at W4A16 g = 128 throughout (80
   layers, 64 q heads over 8, 36 GB; the int4 GEMV and the group-wise GEMM
   at K = 28672 and N = 57344; int8 KV, unfused MLP; a paged int8 pool of 8
   slots, W4A8 admission). Each path launches its base kernels and no
   other: none of these shapes is an attention variant.

With `--profile`, each llama2-7b path, the paged engine and the Mixtral
paths are also run under `torch.profiler` (one prefill, the first request's
whole decode_loop, and one steady-state engine step after `warmup()`: a
chain of 8 windows of 8 with 8 slots busy): per decode step, device-busy
time, kernel events (and those of the flash-decode, which must be one a
layer on every decode and engine step), the host's launch calls (a graph
replay is one) and the idle share go to the output and to
`chip_smoke.json`. `--phases`
runs a subset of
`kernels,moe_layer,llama,checkpoint,lora,tooling,int4,mixtral,mixtral_int4,families,presets,`
`sharded,pipeline` (for debugging: a partial run checks what it runs and prints no result
line).

Prints one JSON line of per-kernel results (the attention kernels'
variants and the GEMMs' epilogue as entries of their own, "kernel[variant]",
their launches those of the paths that run them), then as its last line
`{"ok": true, "device": {...}}`. Any failed check, build or launch ends the
run with a non-zero exit code and no result line; so does a machine without
a CUDA device. With `--out DIR` the details (every kernel case, the model
timings, nvcc's register report) also go to `DIR/chip_smoke.json`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import http.client
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

SEED = 0
MODEL = "llama2-7b"
MIXTRAL = "mixtral-8x7b"
REQUESTS = ((1, 1024, 50), (4, 128, 32))  # (batch, prompt tokens, new tokens)
LLAMA_SHAPES = [  # (K, N) of qkv, o_proj, gate/up, down, lm_head
    (4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
]
PRENORM_SHAPES = {(4096, 12288), (4096, 22016)}  # qkv and gate/up take the fused norm
W8A8_SHAPES = LLAMA_SHAPES[:4]  # the prefill projections (the lm_head stays W8A16)
W8A8_ROWS = (32, 1024)  # the engine's smallest prompt bucket, and a full one
INT4_GROUP = 128  # rows per scale group of the group-wise int4 cases and models
# The decode GEMV's two regimes on the main paths, summed apart: b=1 decode
# (generate, bench decode) and an 8-slot engine step (the servers)
GEMV_REGIMES = {1: "decode m=1", 8: "engine step m=8"}
# One odd shape per int4 kernel, where K and N need padding: (K, N, group size)
INT4_ODD = ((1000, 300, None), (960, 300, 64))
# The per-channel int8 GEMM off its 128 x 128 x 64 tile: rows (one past the
# GEMV's 8, ragged row blocks, full), at the o_proj and down shapes and at an
# odd (K, N) whose output rows are not 16-byte aligned
GEMM_ROWS = (9, 200, 512, 1024)
GEMM_EDGE_SHAPES = {(4096, 4096), (11008, 4096)}
GEMM_ODD = (1000, 300)
# ... and at both of its tiles (tile_m 128 and 256, the rule picking 256
# here) at these rows, on the four prefill shapes
GEMM_TILE_ROWS = (256, 512)
# The offline tensor-parallel reshard's int8 group-wise o_proj and down
# (group = K / tp): (K, N, group, the tp_generate path's shape): o_proj and
# down at tp = 2 (the path), down at tp = 8 (1376, not a multiple of the
# GEMM's 64-deep K step: its second group tile); the GEMV at m = 1 and 8,
# the GEMM at 1024
TP_GROUP_CASES = ((4096, 4096, 2048, True), (11008, 4096, 5504, True),
                  (11008, 4096, 1376, False))
TP_GROUP_ROWS = (1, 8, 1024)
# Prefill attention, (batch, sq, skv, q heads, kv heads, head_dim), causal:
# the main path's shape first, then GQA, ragged lengths in one- and
# two-warpgroup tiles, D = 64, a query block appended to a cache of 256 keys
# (delta = skv - sq) and a batch of short prompts
ATTENTION_CASES = (
    (1, 1024, 1024, 32, 32, 128), (1, 1024, 1024, 32, 8, 128), (1, 77, 77, 32, 8, 128),
    (1, 1000, 1000, 32, 32, 128), (1, 1000, 1000, 32, 8, 64), (1, 128, 384, 32, 8, 128),
    (4, 128, 128, 32, 32, 128),
)


def hbm_bytes_per_s() -> float:
    """The card's datasheet memory rate, for the bounds
    (`eetq_tpu_torch/utils/profiling.py::chip_peaks`, the one table)."""
    from eetq_tpu_torch.utils.profiling import chip_peaks

    return chip_peaks().hbm_gbs * 1e9


def peak_ops_per_s(op_type: str) -> float:
    """The card's datasheet dense tensor-core rate for "bf16" or "int8"."""
    from eetq_tpu_torch.utils.profiling import chip_peaks

    peaks = chip_peaks()
    return {"bf16": peaks.bf16_tflops, "int8": peaks.int8_tops}[op_type] * 1e12


# Mixtral's expert banks, (K, N) of gate|up and down; 8 experts, top-2
MIXTRAL_BANKS = ((4096, 28672), (14336, 4096))
# Expert gather: (rows of x at gate|up and at down, ids) of a b=1 and a b=4
# decode step; b=4's 8 selections hold a repeated id
GATHER_CASES = ((1, 2, (5, 2)), (4, 8, (1, 6, 6, 3, 0, 2, 7, 6)))
# Grouped GEMM: (bm, blocks, experts of the real blocks, the main path's
# regime or None); padding blocks follow, clamped to expert 7, and are
# skipped by the count of real blocks. A b=1 p=1024 prompt (2048 selections,
# bm 128: 2048 // 128 + 8 = 24 blocks, 19 of them real: the wide tile), the
# engine's 8-slot decode step (16 selections, bm 8: 10 blocks, 7 real,
# expert 5 idle: the skinny tile), and one case on each side of the
# crossover (128 selections at bm 16, 512 at bm 64).
GROUPED_CASES = ((128, 24, (0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 7, 7), "prefill"),
                 (8, 10, (0, 1, 2, 3, 4, 6, 7), "engine step"),
                 (16, 16, (0, 0, 1, 2, 2, 3, 4, 5, 5, 6, 7), None),
                 (64, 16, (0, 0, 1, 1, 2, 3, 3, 4, 5, 5, 6, 7, 7), None))
MOE_TOKENS = (1, 4, 1024)  # moe_apply on one layer: 2, 8 and 2048 selections
# The MoE A/B knobs on that layer (int8 per-channel): (knob, value, tokens,
# kernels that must launch, kernels that must not). NO_GATHER sends a b=1
# decode step (2 selections) to the masked scan (each expert on the dense
# GEMV); NO_GROUPED a 1024-token prompt (each expert on the dense GEMM);
# GROUPED_BM moves a prompt's blocks from 128 rows to 32 (the skinny tile)
# and an 8-slot step's (16 selections) from 8 rows to 128 (the wide tile).
MOE_KNOB_CASES = (
    ("EETQ_MOE_NO_GATHER", "1", 1, ("w8a16_gemv",), ("w8a16_expert_gemv", "w8a16_grouped_gemm")),
    ("EETQ_MOE_NO_GROUPED", "1", 1024, ("w8a16_gemm",),
     ("w8a16_expert_gemv", "w8a16_grouped_gemm")),
    ("EETQ_MOE_GROUPED_BM", "32", 1024, ("w8a16_grouped_gemm",), ("w8a16_expert_gemv",)),
    ("EETQ_MOE_GROUPED_BM", "128", 8, ("w8a16_grouped_gemm",), ("w8a16_expert_gemv",)),
)
# The server phase: prompt lengths and budgets drawn from a seeded generator
SERVE_REQUESTS = 12
SERVE_LENGTHS = (17, 100, 300, 700, 1024)
SERVE_BUDGETS = (16, 32, 64)
SERVE_THREADS = 4
SERVE_TIMEOUT_S = 600
ADMISSION_PROMPT = 700  # the admission whose logits are checked: 700 tokens in the 1024 bucket
# The int8 flash-decode's two regimes on the main paths, summed apart, by
# (batch, cache length): b=1 decode after a 1024-token prompt (bench decode)
# and the default engine's 8-slot step over its 2048-key cache (the server)
DECODE_REGIMES = {(1, 1152): "decode b=1", (8, 2048): "engine step B=8"}
# The paged engines: 8 slots x 5 blocks of 256 tokens (the longest request of
# the server mix is 1024 + 64 tokens) and the trash block
PAGED_BLOCKS, PAGED_BLOCK_SIZE = 41, 256
# Paged decode in the kernel phase: a pool of more blocks than the engine's,
# rows of very different lengths (one token, block edges, the longest request)
PAGED_POOL_BLOCKS = 72  # a distinct block for every table entry (8 x 8)
PAGED_LENGTHS = (1, 17, 130, 300, 555, 777, 1024, 1088)
# The multi-query verify of speculative decoding in the kernel phase: (batch,
# S, q heads, kv heads, cache length, lengths, the main path's regime or
# None): llama2-7b at b=1 over the 1152 keys of a 1024-token prompt with
# k = 1 and k = 7 drafts (ngram_spec), Mixtral's 32 query rows a kv head
# (GQA 4, S = 8), and the dense engine's 8 slots over its 2176-key cache
# (spec_server); the paged engine's 8 rows at S = 8 follow (spec_paged_server)
VERIFY_CASES = ((1, 2, 32, 32, 1152, (1074,), None),
                (1, 8, 32, 32, 1152, (1074,), "verify b=1 S=8"),
                (1, 8, 32, 8, 1152, (1074,), None),
                (8, 8, 32, 32, 2176, (1074, 8, 640, 2176, 17, 1500, 300, 1024),
                 "engine verify B=8 S=8"))
VERIFY_PAGED_S = 8
# The attention kernels' variants at the family paths' shapes (FAMILIES).
# Prefill: (variant, batch, S, q heads, kv heads, window, ALiBi, a path's
# shape, head dim): mistral-7b's 4608-token prompt under its 4096-key window,
# a window of 256 (most tiles skipped), baichuan-13b's 40 ALiBi heads,
# qwen2-7b's group 7 and chatglm3-6b's 16; gemma-7b's 16 heads of 256 (the
# d256 variant), also under a window of 256 and with ALiBi.
ATTENTION_VARIANT_CASES = (
    ("window", 1, 4608, 32, 8, 4096, False, True, 128),
    ("window", 1, 1024, 32, 8, 256, False, False, 128),
    ("alibi", 1, 1024, 40, 40, None, True, True, 128),
    ("group", 1, 1024, 28, 4, None, False, True, 128),
    ("group", 1, 1024, 32, 2, None, False, True, 128),
    ("d256", 1, 1024, 16, 16, None, False, True, 256),
    ("d256", 1, 1024, 16, 16, 256, False, False, 256),
    ("d256", 1, 1024, 16, 16, None, True, False, 256),
)
# Decode, one token a row: (variant, batch, q heads, kv heads, cache length,
# lengths, window, ALiBi, a path's shape, paged too, head dim). b=1 after the
# families' prompts (a path's shape for the dense entry points) and an 8-slot
# engine step (for the paged ones); mistral over 4672 keys (the window
# bites), a window of 256 over 1152, and mistral's 32,768-key capacity with
# 4672 live (the grid's dead blocks); gemma-7b's 16 heads of 256 at b=1 and
# in an 8-slot step, and under a window and with ALiBi at D = 256.
WINDOW_LENGTHS = (4672, 1, 640, 4355, 17, 1500, 300, 4100)  # 4355: chunk 0 leaves the window
ENGINE_LENGTHS = (1074, 1, 640, 2048, 17, 1500, 300, 1024)
DECODE_VARIANT_CASES = (
    ("window", 1, 32, 8, 4864, (4672,), 4096, False, True, True, 128),
    ("window", 8, 32, 8, 4864, WINDOW_LENGTHS, 4096, False, True, True, 128),
    ("window", 1, 32, 8, 1280, (1152,), 256, False, False, True, 128),
    ("window", 1, 32, 8, 32768, (4672,), 4096, False, False, False, 128),
    ("alibi", 1, 40, 40, 1280, (1074,), None, True, True, True, 128),
    ("alibi", 8, 40, 40, 2048, ENGINE_LENGTHS, None, True, True, True, 128),
    ("group", 1, 28, 4, 1280, (1074,), None, False, True, True, 128),
    ("group", 8, 28, 4, 2048, ENGINE_LENGTHS, None, False, True, True, 128),
    ("group", 1, 32, 2, 1280, (1074,), None, False, True, True, 128),
    ("group", 8, 32, 2, 2048, ENGINE_LENGTHS, None, False, True, True, 128),
    ("d256", 1, 16, 16, 1280, (1074,), None, False, True, True, 256),
    ("d256", 8, 16, 16, 2048, ENGINE_LENGTHS, None, False, True, True, 256),
    ("d256", 1, 16, 16, 1280, (1152,), 256, False, False, True, 256),
    ("d256", 1, 16, 16, 1280, (1074,), None, True, False, True, 256),
)
# The multi-query verify under the variants: (variant, batch, S, q heads, kv
# heads, cache length, lengths, window, ALiBi, head dim). Rows whose window
# starts move across a tile or a chunk between their tokens; G = 7 and 16 at
# the most tokens that fit 64 query rows a kv head; at D = 256 gemma-7b's
# 8-token verify (8 rows) and 16 and 32 rows a kv head (the most there).
VERIFY_VARIANT_CASES = (
    ("window", 8, 8, 32, 8, 4864, (4672, 8, 640, 4355, 17, 1500, 300, 4100), 4096, False, 128),
    ("window", 8, 8, 32, 8, 2048, (1074, 8, 640, 2048, 17, 263, 300, 1027), 256, False, 128),
    ("alibi", 1, 8, 40, 40, 1280, (1074,), None, True, 128),
    ("group", 1, 8, 28, 4, 1280, (1074,), None, False, 128),
    ("group", 1, 4, 32, 2, 1280, (1074,), None, False, 128),
    ("d256", 1, 8, 16, 16, 1280, (1074,), None, False, 256),
    ("d256", 8, 4, 16, 4, 2048, ENGINE_LENGTHS, None, False, 256),
    ("d256", 1, 2, 32, 2, 1280, (1074,), None, False, 256),
)
# The multi-query verify past one row block of the flash-decode (64 query
# rows a kv head, 32 at D = 256): (variant, batch, S, q heads, kv heads, cache
# length, lengths, window, ALiBi, a path's shape, head dim). chatglm3-6b's
# 32/2 at S = 8 (128 rows, two row blocks: a b=1 k = 7 verify and its spec
# engine's 8 slots over an int8 pool), under mistral's window and with ALiBi
# slopes of 32 heads; 32/4 at S = 9 (72 rows: the block edge inside token
# 8's rows) plain, under the window and with ALiBi; at D = 256 32/2 at S = 4
# (64 rows), plain, under a window of 256 and with ALiBi. Each dense bf16 and
# int8, paged bf16 and int8, every token bit-equal to a one-token call and
# paged bit-equal to dense. (A variant of None: the plain body at a base
# group, recorded under the entry point's own name.)
SPEC_ENGINE_LENGTHS = (1074, 8, 640, 2048, 17, 1500, 300, 1024)
ROW_BLOCK_CASES = (
    ("group", 1, 8, 32, 2, 1280, (1074,), None, False, True, 128),
    ("group", 8, 8, 32, 2, 2048, SPEC_ENGINE_LENGTHS, None, False, True, 128),
    ("window", 1, 8, 32, 2, 4864, (4672,), 4096, False, False, 128),
    ("alibi", 1, 8, 32, 2, 1280, (1074,), None, True, False, 128),
    (None, 1, 9, 32, 4, 1280, (1074,), None, False, False, 128),
    ("window", 1, 9, 32, 4, 4864, (4672,), 4096, False, False, 128),
    ("alibi", 1, 9, 32, 4, 1280, (1074,), None, True, False, 128),
    ("d256", 1, 4, 32, 2, 1280, (1074,), None, False, False, 256),
    ("d256", 1, 4, 32, 2, 1280, (1152,), 256, False, False, 256),
    ("d256", 1, 4, 32, 2, 1280, (1074,), None, True, False, 256),
)
# The prefill flash-attention at chunked prefill's shapes, over the cache's
# [B, Hkv, L, D] read as [B, L, Hkv, D] (head stride L D, sequence stride D):
# (variant, batch, chunk, keys, q heads, kv heads, cache capacity, window,
# the bench chunked path's shape): llama2-7b's last 512-token chunk of 4096,
# mistral-7b's last of 4608 under its 4096-key window, and bench.py's b=4
# p=1024 chunk 256 (its last chunk, and its first three)
CHUNK_ATTENTION_CASES = (
    (None, 1, 512, 4096, 32, 32, 4096, None, False),
    ("window", 1, 512, 4608, 32, 8, 4608, 4096, False),
    (None, 4, 256, 1024, 32, 32, 1024, None, True),
    (None, 4, 256, 768, 32, 32, 1024, None, True),
    (None, 4, 256, 512, 32, 32, 1024, None, True),
    (None, 4, 256, 256, 32, 32, 1024, None, True),
)
# Chunked prefill (serve/generate.py::prefill_chunked): bench.py under
# EETQ_BENCH_PREFILL_CHUNK=256 (llama2-7b b=4 p=1024, int8 KV, then
# decode_loop(fused_mlp=True)); mistral-7b's 4608-token prompt in chunks of
# 512 (families)
BENCH_CHUNKED = (4, 1024, 256)  # (batch, prompt tokens, chunk)
MISTRAL_CHUNK = 512
# The chunked engine (Engine(prefill_chunk=CHUNKED_ENGINE_CHUNK)) of llama2-7b:
# max_len 4096, eight short requests and two long ones (bucket 4096: eight
# chunks each), the long ones queued behind six short ones so that chunks run
# beside decoding slots; dense int8 and a paged bf16 pool
CHUNKED_ENGINE_CHUNK = 512
CHUNKED_ENGINE_MAX_LEN = 4096
CHUNKED_ENGINE_REQUESTS = ((17, 64), (300, 96), (700, 64), (100, 128), (1024, 64), (33, 96),
                           (3500, 48), (3300, 48), (257, 64), (512, 32))
CHUNKED_ENGINE_BLOCKS = 81  # 80 blocks of 256 and the trash block
# Mixtral's spec engine: k = 3, so that a b=1 verify's 2 (k + 1) = 8 expert
# selections stay in the gather-GEMV regime
MIXTRAL_SPEC_K = 3
# ... and its 8-slot verify round held against the plain path (the routing
# replayed) after admissions of this budget: past the tokens each slot takes
# before the last admission and its spec window, short enough to finish fast
MIXTRAL_SPEC_STEP_BUDGET = 40
# ... and held against its non-spec twin (`routed_twin`: both engines eager,
# the routing replayed) on the model's first this many layers, the same
# weights: at all 32 the two eager engines took 27.0 s, which the presets
# phase needed (the spec window and the routing are the same in every layer)
MIXTRAL_SPEC_TWIN_LAYERS = 8
# Speculative decoding on MODEL: k drafts a round (a verify is m = k + 1 = 8
# rows at b=1), the draft model's layers (the target's first ones), and the
# prompt's period (a seeded sequence of this many tokens, tiled)
SPEC_K = 7
SPEC_DRAFT_LAYERS = 8
SPEC_BASE = 64
# The engine step whose decode logits are checked: prompts of these lengths
STEP_PROMPTS = (17, 100, 300, 700, 1024, 33, 257, 512)
STEP_BUDGET = 200  # more than the 8 x 8 tokens of the chain after the last admission
# max |kernel - plain| <= TOL * max |plain|: four bf16 ulps of the largest
# output. Sums run in another order and attention rounds p to bf16 before
# p.v (as the TPU kernel does), both far inside this bound; a wrong tile,
# column or mask is off by the size of the output itself.
TOL = 2.0 ** -6
# Model logits after 32 layers: the two paths round differently at every
# bf16 boundary, so the bound is on the error relative to the largest logit.
MODEL_TOL = 5e-2
# Under W8A8 each projection requantizes its input per token: one int8
# step (absmax/127) is two bf16 ulps (absmax/256), so an ulp-level
# difference from attention can come out of the next projection as a whole
# step. The kernel and plain W8A8 products themselves are bit-identical.
A8_MODEL_TOL = 2 * MODEL_TOL
# A speculative engine's greedy request may part from its non-spec twin's
# (the verify at 8 slots is m = 64 rows, the GEMM, where the twin's step is
# the GEMV) only at a near tie: its token and the twin's each within
# SPEC_TIE_ULPS bf16 ulps (of the largest |logit|) of the top next-token
# logit after the twin's tokens. Runs read 0 to 4 ulps, at positions that
# move with the requests' timing (PERF.md §6); a tie may hold more than two
# tokens, so the two need not be the top two. A wrong token lands in the
# band with the odds of a few tokens in 32,000. The chunked engines take the
# same rule against their unchunked twins. A MoE model's spec engine is
# held to its twin with the routing replayed across both (`routed_twin`): a
# flipped expert moves the logits by far more than an ulp (PERF.md §6), and a
# routing near a tie is no longer a pass.
SPEC_TIE_ULPS = 8
# The GEMMs' fused epilogue: each activation on llama2-7b's gate|up shape,
# each residual mode on its o_proj shape, all with a bias; in each regime of
# the GEMV (m = 1, 8), the GEMM and the W8A8 / W4A8 GEMM (m = 1024)
ACTIVATION_NAMES = ("relu", "gelu", "silu")
EPILOGUE_SHAPES = ((4096, 22016, ACTIVATION_NAMES), (4096, 4096, ("add", "mul")))
EPILOGUE_REGIMES = (("gemv", 1), ("gemv", 8), ("gemm", 1024), ("a8", 1024))
EPILOGUE_KERNELS = ("w8a16_gemv", "w4a16_gemv", "w8a16_gemm", "w4a16_gemm", "w8a8_gemm",
                    "w4a8_gemm")
# The lora phase: a bank of LORA_ADAPTERS adapters of rank LORA_RANK on
# every layer's qkv and o_proj of llama2-7b W8A16, A ~ N(0, 1/r) and B ~
# N(0, LORA_B_STD^2), both from the phase's seeded generator, scaling
# LORA_ALPHA / r = 1: a unit-variance input's side path is about 64
# LORA_B_STD = 0.32 against the projection's unit variance (about 0.1 GB)
LORA_ADAPTERS, LORA_RANK, LORA_ALPHA, LORA_B_STD = 4, 16, 16.0, 0.005
# The LoRA phase's depth: the side path, the bank's gather and the autograd
# Functions are the same in every layer; it ran at full depth (32 layers,
# 74.3-84.5 s for the phase) until the presets phase needed the run's time
LORA_LAYERS = 16
LORA_PREFILL = (4, 1024)  # lora_prefill: batch (one row an adapter), prompt tokens
LORA_SPEC_K = 3
LORA_MERGE_ID = 2
# merged against the bank at its id, prefill logits: the bounds of the JAX
# package's test_merge_lora_matches_adapter_model (mean |diff|, argmax share)
LORA_MERGE_MEAN, LORA_MERGE_ARGMAX = 0.05, 0.9
# eval_ppl (the lora phase, on its bf16 llama2-7b and W8A16 base):
# `serve/eval.py::delta_ppl` over EVAL_WINDOWS seeded windows of EVAL_WINDOW
# tokens; the W8A16 kernel path's mean NLL within EVAL_NLL_TOL nats of its
# plain path's, and its perplexity within EVAL_MANUAL_RTOL of a straight-line
# per-window cross-entropy
EVAL_WINDOW, EVAL_WINDOWS = 2048, 4
EVAL_NLL_TOL, EVAL_MANUAL_RTOL = 0.01, 1e-4
# lora_train: twin 0's adapters, cloned, trained on one seeded batch of
# TRAIN_TOKENS tokens (next-token cross-entropy over the f32 logits); every
# adapter tensor's gradient within TRAIN_TOL (the max error over the largest
# value, `tests/test_flash_attention.py:194-197`) of the plain path's; then
# TRAIN_STEPS plain SGD steps on f32 copies of the adapters, at the rate whose
# first step the gradient predicts to lower the loss by TRAIN_DECREASE of it
TRAIN_TOKENS, TRAIN_TOL, TRAIN_STEPS, TRAIN_DECREASE = 1024, 5e-2, 5, 0.01
# text_server (the llama phase): a byte-level BPE tokenizer made from seeded
# words, each request (words in its prompt, new tokens, streamed or not)
TEXT_REQUESTS = ((40, 16, False), (150, 24, True), (300, 32, False), (600, 16, False))
# The sources behind w8a16_gemm, w4a16_gemm, w8a8_gemm, w4a8_gemm and the
# prefill flash-attention (all its instances, head dim 256's too): a C7520
# warning of ptxas for any of them fails the run (the grouped GEMM's
# per-slice group modes are known to draw it and are listed only).
UNSERIALIZED_SOURCES = ("w8a16_gemm.cu", "w4a16_gemm.cu", "w8a8_gemm.cu", "w4a8_gemm.cu",
                        "flash_attention.cu")
REPLACES = {
    "w8a16_gemv": ("cuda", "eetq_tpu_torch/csrc/w8a16_gemv.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "w8a16_gemm": ("cuda", "eetq_tpu_torch/csrc/w8a16_gemm.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "flash_attention_fwd": ("cuda", "eetq_tpu_torch/csrc/flash_attention.cu",
                            "eetq_tpu/kernels/flash_attention.py:179"),
    "flash_decode": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                     "eetq_tpu/kernels/flash_decode.py:362"),
    "w8a8_gemm": ("cuda", "eetq_tpu_torch/csrc/w8a8_gemm.cu", "eetq_tpu/kernels/w8a8.py:90"),
    "fused_mlp_gemv": ("cuda", "eetq_tpu_torch/csrc/fused_mlp.cu",
                       "eetq_tpu/kernels/mlp_fused.py:96"),
    "flash_decode_int8": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                          "eetq_tpu/kernels/flash_decode.py:362"),
    "w8a16_expert_gemv": ("cuda", "eetq_tpu_torch/csrc/w8a16_expert_gemv.cu",
                          "eetq_tpu/kernels/w8a16.py:434"),
    "w8a16_grouped_gemm": ("cuda", "eetq_tpu_torch/csrc/w8a16_grouped_gemm.cu",
                           "eetq_tpu/kernels/w8a16.py:537"),
    "w4a16_gemv": ("cuda", "eetq_tpu_torch/csrc/w4a16_gemv.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "w4a16_gemm": ("cuda", "eetq_tpu_torch/csrc/w4a16_gemm.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "fused_mlp_gemv_i4": ("cuda", "eetq_tpu_torch/csrc/fused_mlp_i4.cu",
                          "eetq_tpu/kernels/mlp_fused.py:241"),
    "w4a8_gemm": ("cuda", "eetq_tpu_torch/csrc/w4a8_gemm.cu", "eetq_tpu/kernels/w8a8.py:277"),
    "paged_flash_decode": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                           "eetq_tpu/kernels/flash_decode.py:228"),
    "paged_flash_decode_int8": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                                "eetq_tpu/kernels/flash_decode.py:228"),
    "w4a16_expert_gemv": ("cuda", "eetq_tpu_torch/csrc/w4a16_expert_gemv.cu",
                          "eetq_tpu/kernels/w8a16.py:434"),
    "w4a16_grouped_gemm": ("cuda", "eetq_tpu_torch/csrc/w4a16_grouped_gemm.cu",
                           "eetq_tpu/kernels/w8a16.py:537"),
}
# ... and the attention kernels' variants, each compiled apart (the group
# variant is the plain body's, at a group other than 1, 2, 4, 8; d256 its
# instances at head dim 256)
VARIANTS = ("window", "alibi", "group", "d256")
VARIANT_SOURCES = {"window": "flash_decode_window.cu", "alibi": "flash_decode_alibi.cu",
                   "group": "flash_decode.cu", "d256": "flash_decode.cu"}
REPLACES.update({f"{name}[epilogue]": REPLACES[name] for name in EPILOGUE_KERNELS})
# ... the int8 GEMV's and GEMM's group-wise mode
REPLACES.update({f"{name}[group]": REPLACES[name] for name in ("w8a16_gemv", "w8a16_gemm")})
REPLACES.update({f"{name}[{v}]": (
    "cuda", REPLACES[name][1] if name == "flash_attention_fwd"
    else f"eetq_tpu_torch/csrc/{VARIANT_SOURCES[v]}", REPLACES[name][2])
    for name in ("flash_attention_fwd", "flash_decode", "flash_decode_int8", "paged_flash_decode",
                 "paged_flash_decode_int8") for v in VARIANTS})
# The kernels each path must launch, and those it must not.
PATH_KERNELS = {
    "generate": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode"),
    "bench_decode": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "fused_mlp_gemv",
                     "flash_decode_int8"),
    "server": ("w8a16_gemv", "flash_attention_fwd", "w8a8_gemm", "flash_decode_int8"),
    "mixtral_generate": ("w8a16_expert_gemv", "w8a16_grouped_gemm", "w8a16_gemv", "w8a16_gemm",
                         "flash_attention_fwd", "flash_decode"),
    "mixtral_server": ("w8a16_grouped_gemm", "w8a8_gemm", "w8a16_gemv", "flash_attention_fwd",
                       "flash_decode_int8"),
    "int4_generate": ("w4a16_gemv", "w4a16_gemm", "flash_attention_fwd", "flash_decode"),
    # int4 layers under an int8 lm_head: both GEMVs
    "int4_bench_decode": ("fused_mlp_gemv_i4", "w4a16_gemv", "w8a16_gemv", "w4a16_gemm",
                          "flash_attention_fwd", "flash_decode_int8"),
    "int4_server": ("w4a8_gemm", "w4a16_gemv", "flash_attention_fwd", "flash_decode_int8"),
    "paged_server": ("w8a16_gemv", "flash_attention_fwd", "w8a8_gemm", "paged_flash_decode"),
    # b=1 speculation: the verify's m = 8 rows on the GEMV (and the fused MLP)
    "ngram_spec": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode"),
    "ngram_spec_bench": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "fused_mlp_gemv",
                         "flash_decode_int8"),
    "draft_spec": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode"),
    # an 8-slot verify is m = 64 rows: the GEMM; the admissions' lm_head the GEMV
    "spec_server": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "w8a8_gemm",
                    "flash_decode_int8"),
    "spec_paged_server": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "w8a8_gemm",
                          "paged_flash_decode"),
    "mixtral_int4_generate": ("w4a16_expert_gemv", "w4a16_grouped_gemm", "w4a16_gemv",
                              "w4a16_gemm", "flash_attention_fwd", "flash_decode"),
    # the 8-slot step holds 16 selections: always the grouped GEMM
    "mixtral_int4_paged_server": ("w4a16_grouped_gemm", "w4a8_gemm", "w4a16_gemv",
                                  "flash_attention_fwd", "paged_flash_decode_int8"),
    # chunked prefill: every chunk on the prefill flash-attention (W8A16
    # projections: the GEMM), then bench decode
    "bench_decode_chunked": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "fused_mlp_gemv",
                             "flash_decode_int8"),
    # the chunked engines: short prompts admitted, long ones chunked, all W8A16
    "chunked_server": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode_int8"),
    "chunked_paged_server": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd",
                             "paged_flash_decode"),
    # Mixtral's spec engine: verify rounds of up to 8 slots x 4 tokens
    "mixtral_spec_server": ("w8a16_grouped_gemm", "w8a8_gemm", "w8a16_gemv",
                            "flash_attention_fwd", "flash_decode_int8"),
}
# The lora phase's paths. The LoRA engines admit with W8A16 (a8_prefill
# False), as their twins' greedy_generate prefills; an 8-slot verify of
# k = 3 is m = 32 rows, the GEMM
_LORA_SERVE = ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd")
PATH_KERNELS.update({
    "epilogue_linear": EPILOGUE_KERNELS + tuple(f"{k}[epilogue]" for k in EPILOGUE_KERNELS),
    "lora_prefill": ("w8a16_gemm", "flash_attention_fwd"),
    "lora_server": _LORA_SERVE + ("flash_decode_int8",),
    "lora_paged_server": _LORA_SERVE + ("paged_flash_decode",),
    "lora_spec_server": _LORA_SERVE + ("flash_decode_int8",),
    "lora_merge": ("w8a16_gemm", "flash_attention_fwd"),
    # perplexity (prefill windows, the dense model's attention too) and the
    # training step: the GEMM and the prefill flash-attention under their
    # autograd Functions; the backward launches no kernel of csrc/
    "eval_ppl": ("w8a16_gemm", "flash_attention_fwd"),
    "lora_train": ("w8a16_gemm", "flash_attention_fwd"),
    # the default engine behind a server with a tokenizer
    "text_server": PATH_KERNELS["server"],
})
# The entry points of the decode GEMV (`csrc/gemv.cuh`)
GEMV_FAMILY = ("w8a16_gemv", "w4a16_gemv", "w8a16_expert_gemv", "w4a16_expert_gemv",
               "fused_mlp_gemv", "fused_mlp_gemv_i4")
# ... and of the flash-decode (`csrc/flash_decode.cu`): two launches of each
# must give bit-equal outputs (both sum their blocks' partials in a fixed
# order, with no float atomics)
DECODE_FAMILY = ("flash_decode", "flash_decode_int8", "paged_flash_decode",
                 "paged_flash_decode_int8")
REPEAT_EQUAL = GEMV_FAMILY + DECODE_FAMILY
MOE_KERNELS = ("w8a16_expert_gemv", "w8a16_grouped_gemm")
INT4_MOE_KERNELS = ("w4a16_expert_gemv", "w4a16_grouped_gemm")
PAGED_KERNELS = ("paged_flash_decode", "paged_flash_decode_int8")
DENSE_DECODE = ("flash_decode", "flash_decode_int8")
INT4_KERNELS = ("w4a16_gemv", "w4a16_gemm", "fused_mlp_gemv_i4", "w4a8_gemm")
INT8_DENSE = ("w8a16_gemv", "w8a16_gemm", "fused_mlp_gemv", "w8a8_gemm")
PATH_IDLE = {
    "generate": MOE_KERNELS + INT4_KERNELS,
    "bench_decode": MOE_KERNELS + INT4_KERNELS,
    # under a8 every prefill projection is W8A8
    "server": ("w8a16_gemm",) + MOE_KERNELS + INT4_KERNELS,
    # a MoE layer has no dense MLP to fuse
    "mixtral_generate": ("fused_mlp_gemv",) + INT4_KERNELS,
    "mixtral_server": ("fused_mlp_gemv", "w8a16_gemm") + INT4_KERNELS,
    "int4_generate": INT8_DENSE + MOE_KERNELS + ("fused_mlp_gemv_i4", "w4a8_gemm"),
    "int4_bench_decode": MOE_KERNELS + ("w8a16_gemm", "fused_mlp_gemv", "w8a8_gemm", "w4a8_gemm"),
    # under a8 every prefill projection of an int4 model is W4A8
    "int4_server": INT8_DENSE + MOE_KERNELS + ("w4a16_gemm", "fused_mlp_gemv_i4"),
    "ngram_spec": MOE_KERNELS + INT4_KERNELS,
    "ngram_spec_bench": MOE_KERNELS + INT4_KERNELS,
    "draft_spec": MOE_KERNELS + INT4_KERNELS,
    "spec_server": MOE_KERNELS + INT4_KERNELS,
    "bench_decode_chunked": MOE_KERNELS + INT4_KERNELS + ("w8a8_gemm",),
    "chunked_server": MOE_KERNELS + INT4_KERNELS + ("w8a8_gemm", "fused_mlp_gemv"),
    "mixtral_spec_server": ("fused_mlp_gemv",) + INT4_KERNELS,
}
# none of the paths above runs a paged cache or an int4 expert bank
PATH_IDLE = {path: idle + PAGED_KERNELS + INT4_MOE_KERNELS for path, idle in PATH_IDLE.items()}
_NOT_LORA = ("w8a8_gemm", "fused_mlp_gemv") + MOE_KERNELS + INT4_KERNELS + INT4_MOE_KERNELS
PATH_IDLE.update({
    "epilogue_linear": ("flash_attention_fwd", "fused_mlp_gemv", "fused_mlp_gemv_i4")
    + MOE_KERNELS + INT4_MOE_KERNELS + DENSE_DECODE + PAGED_KERNELS,
    "lora_prefill": ("w8a16_gemv",) + _NOT_LORA + DENSE_DECODE + PAGED_KERNELS,
    "lora_merge": ("w8a16_gemv",) + _NOT_LORA + DENSE_DECODE + PAGED_KERNELS,
    "lora_server": _NOT_LORA + PAGED_KERNELS + ("flash_decode",),
    "lora_spec_server": _NOT_LORA + PAGED_KERNELS + ("flash_decode",),
    "lora_paged_server": _NOT_LORA + DENSE_DECODE + ("paged_flash_decode_int8",),
    # a paged engine never reaches the dense flash-decode entry points
    "paged_server": DENSE_DECODE + ("paged_flash_decode_int8", "w8a16_gemm") + MOE_KERNELS
    + INT4_KERNELS + INT4_MOE_KERNELS,
    "mixtral_int4_generate": INT8_DENSE + MOE_KERNELS + PAGED_KERNELS
    + ("fused_mlp_gemv_i4", "w4a8_gemm", "flash_decode_int8"),
    "mixtral_int4_paged_server": INT8_DENSE + MOE_KERNELS + DENSE_DECODE
    + ("paged_flash_decode", "w4a16_gemm", "fused_mlp_gemv_i4"),
    "spec_paged_server": DENSE_DECODE + ("paged_flash_decode_int8",) + MOE_KERNELS + INT4_KERNELS
    + INT4_MOE_KERNELS,
    "chunked_paged_server": DENSE_DECODE + ("paged_flash_decode_int8", "w8a8_gemm",
                                            "fused_mlp_gemv") + MOE_KERNELS + INT4_KERNELS
    + INT4_MOE_KERNELS,
})


# The families phase: each preset at full width and depth, W8A16 per-channel
# with an int8 lm_head, through one b=1 decode path (its KV dtype, fused MLP
# or not, prompt tokens; 50 new tokens) and one engine behind the server
# (its keywords; greedy requests of (prompt tokens, budget) beside the mix;
# a paged engine's step prompts). Each path runs the kernels of
# FAMILY_KERNELS and their variants, and nothing else.
FAMILIES = {
    # window 4096: a 4608-token prompt and a request of 4400 + 64 tokens, so
    # the window bites in prefill, decode and the engine; a bf16 pool
    "mistral-7b": dict(
        tag="mistral", variant="window", kv="bf16", fused=False, prompt=4608, chunk=MISTRAL_CHUNK,
        engine=dict(paged_blocks=81, paged_block_size=PAGED_BLOCK_SIZE, max_len=5120,
                    prompt_buckets=(32, 128, 512, 1024, 2048, 4608)),
        twin=dict(kv_dtype="bf16", decode_window=1), long=((4400, 64),),
        step_prompts=(17, 100, 300, 700, 1024, 33, 4400, 512)),
    # group 7, qkv bias, a 152,064-token vocabulary; the dense int8 default
    "qwen2-7b": dict(tag="qwen2", variant="group", kv="int8", fused=False, prompt=1024,
                     engine={}, twin=dict(decode_window=1)),
    # group 16, interleaved half rope, qkv bias; an int8 pool. Speculation at
    # the reference's k = 7: a verify of 8 tokens is 128 query rows a kv head,
    # two row blocks of the flash-decode (b=1 ngram_spec_generate, and the
    # spec engine over a larger int8 pool)
    "chatglm3-6b": dict(
        tag="chatglm3", variant="group", kv="bf16", fused=False, prompt=1024,
        engine=dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE,
                    kv_dtype="int8"),
        twin=dict(kv_dtype="int8", decode_window=1), spec=SPEC_K,
        spec_engine=dict(paged_blocks=CHUNKED_ENGINE_BLOCKS)),
    # ALiBi over 40 heads, no rope; bench.py's int8 KV + fused MLP; dense int8.
    # Its engine admits with W8A16: under W8A8 the admission's logits of this
    # random 40-layer ALiBi model part from the plain path by 0.137-0.139 of
    # the largest logit, past A8_MODEL_TOL, as much against a plain path with
    # the flash kernel's own rounding, and 0.067 with rope in place of ALiBi
    # on the same weights: per-token requantization amplifies any ulp-level
    # difference of its large, unaveraged attention outputs (PERF.md §6,
    # scripts/torch_a8_admission.py)
    "baichuan-13b": dict(tag="baichuan13", variant="alibi", kv="int8", fused=True, prompt=1024,
                         engine=dict(a8_prefill=False),
                         twin=dict(decode_window=1, a8_prefill=False)),
    # 16 heads of 256 (the attention kernels' d256 instances), GeGLU (gelu in
    # the fused MLP), unit-offset norms, the embedding multiplier and a tied
    # 256,000-token head: the bf16 embedding table through
    # models/transformer.py::_tied_head (random_quantized_params leaves a tied
    # config's lm_head None); bench.py's int8 KV + fused MLP; a paged bf16 pool
    "gemma-7b": dict(
        tag="gemma", variant="d256", kv="int8", fused=True, prompt=1024,
        engine=dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE),
        twin=dict(kv_dtype="bf16", decode_window=1)),
}
FAMILY_NEW_TOKENS = 50
# The families' depth: their variants, widths, prompts and engines are the
# presets', and each layer runs the same kernels; they ran at full depth
# (28-40 layers, 113.4-116.7 s for the phase) until the presets phase
# needed the run's time
FAMILY_LAYERS = 8


def _family_paths(table: dict) -> dict:
    """PATH_KERNELS of the paths of `table` (FAMILIES, PRESET_MODELS): their
    linear kernels at the model's bits, decode kernel, prefill attention
    and their variants (such a path launches nothing else)."""
    paths = {}
    for f in table.values():
        paged = "paged_blocks" in f["engine"]
        dec = "flash_decode_int8" if f["kv"] == "int8" else "flash_decode"
        srv = ("paged_flash_decode" if paged else "flash_decode") + (
            "_int8" if f["engine"].get("kv_dtype", "int8" if not paged else "bf16") == "int8"
            else "")
        v = f.get("variant")
        w = "w4a16" if f.get("bits") == 4 else "w8a16"
        variants = ((f"flash_attention_fwd[{v}]", f"{dec}[{v}]") if v else ())
        paths[f"{f['tag']}_decode"] = (
            f"{w}_gemv", f"{w}_gemm", "flash_attention_fwd", dec) + variants + (
            ("fused_mlp_gemv_i4" if f.get("bits") == 4 else "fused_mlp_gemv",)
            if f["fused"] else ())
        prefill = ((w.replace("16", "8") if f["engine"].get("a8_prefill", True) else w)
                   + "_gemm")
        paths[f"{f['tag']}_{'paged_' if paged else ''}server"] = (
            f"{w}_gemv", prefill, "flash_attention_fwd", srv) + (
            (f"flash_attention_fwd[{v}]", f"{srv}[{v}]") if v else ())
        if "chunk" in f:  # chunked prefill, then the decode path's decode
            paths[f"{f['tag']}_chunked"] = paths[f"{f['tag']}_decode"]
        if "spec" in f:  # b=1 verifies of k + 1 tokens on the GEMV; an 8-slot one on the GEMM
            paths[f"{f['tag']}_ngram_spec"] = (
                "w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode",
                f"flash_attention_fwd[{v}]", f"flash_decode[{v}]")
            paths[f"{f['tag']}_spec_{'paged_' if paged else ''}server"] = (
                paths[f"{f['tag']}_{'paged_' if paged else ''}server"] + ("w8a16_gemm",))
    return paths


PATH_KERNELS.update(_family_paths(FAMILIES))

# The presets phase: the five presets of `models/config.py` that no other
# phase runs, each at full width and depth (W8A16 per-channel with an int8
# lm_head; llama2-70b W4A16 with INT4_GROUP-row scale groups throughout,
# the lm_head as int4_generate takes it), through a b=1 decode path and an
# engine behind the server as in the families phase. None of them runs an
# attention variant: their groups (1, 4, 8) and head dims (64, 128) are the
# kernels' plain instances, so each path launches its base kernels and no
# other. llama2-70b comes last, every earlier model freed.
PRESET_MODELS = {
    # the JAX bench's second cell: bench.py's int8 KV + fused MLP (K =
    # 5120), 40 heads of MHA; the dense int8 default engine (W8A8 admission)
    "llama2-13b": dict(tag="llama13b", kv="int8", fused=True, prompt=1024,
                       engine={}, twin=dict(decode_window=1)),
    # a 128,256-token int8 lm_head, rope_theta 500,000, group 4 at I =
    # 14336; the generate form (bf16 KV, unfused MLP); a paged bf16 pool
    "llama3-8b": dict(
        tag="llama3", kv="bf16", fused=False, prompt=1024,
        engine=dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE),
        twin=dict(kv_dtype="bf16", decode_window=1)),
    # model_type "baichuan" without ALiBi (rope, MHA 32/32), a 125,696-token
    # int8 lm_head; int8 KV + fused MLP; the dense int8 default engine
    "baichuan-7b": dict(tag="baichuan7", kv="int8", fused=True, prompt=1024,
                        engine={}, twin=dict(decode_window=1)),
    # head dim 64 at group 8 (32/4) over 22 layers; bf16 KV; a paged int8
    # pool (max_position 2048: the engine's max_len)
    "tinyllama-1.1b": dict(
        tag="tinyllama", kv="bf16", fused=False, prompt=1024,
        engine=dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE,
                    kv_dtype="int8"),
        twin=dict(kv_dtype="int8", decode_window=1)),
    # 80 layers, 64 q heads over 8, W4A16 g = 128: the int4 GEMV and the
    # group-wise GEMM at K = 8192 (N = 10240, 8192, 57344) and K = 28672 (N =
    # 8192); int8 KV, unfused MLP (the fused int4 MLP takes per-channel
    # scales only); a paged int8 pool of 8 slots, W4A8 admission. The plain
    # group-wise products hold [rows, groups, N] (f64 under W4A8): at 1024
    # rows of gate|up 15 GB (30 GB) beside the 36 GB model, so the checks
    # against the plain path run at full width and depth on a 128-token
    # prompt and a 120-token admission (its 128 bucket); the paths
    # themselves run at p = 1024 and the mix's 17-1024
    "llama2-70b": dict(
        tag="llama70b", kv="int8", fused=False, prompt=1024, bits=4,
        group=INT4_GROUP, check_prompt=128, admission_prompt=120,
        engine=dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE,
                    kv_dtype="int8"),
        twin=dict(kv_dtype="int8", decode_window=1)),
}
PATH_KERNELS.update(_family_paths(PRESET_MODELS))

# The checkpoint phase: llama2-7b at full width and depth saved at the
# default shard size (two shards and an index) and loaded back; a dense
# fp16 HF checkpoint of llama2-7b's width at CKPT_DENSE_LAYERS layers,
# written by the port's own writer, imported with quantize=True; Mixtral-8x7B
# at full width and CKPT_MIXTRAL_LAYERS layers saved and loaded.
CKPT_DENSE_LAYERS = 2
CKPT_MIXTRAL_LAYERS = 2
CKPT_SHARDS = 2  # llama2-7b W8A16 (6.9 GB) at the default 4 GiB shards
CKPT_FREE_GB = 8.0  # the phase's peak on disk: llama2-7b's 6.9 GB checkpoint
PATH_KERNELS.update({
    # the loaded llama2-7b through bench.py's decode (int8 KV, fused MLP)
    "checkpoint_llama": PATH_KERNELS["bench_decode"],
    # the imported dense checkpoint, quantized: a W8A16 prefill (the lm_head stays dense)
    "checkpoint_dense_import": ("w8a16_gemm", "flash_attention_fwd"),
    # the loaded 2-layer Mixtral through generate's decode (bf16 KV)
    "checkpoint_mixtral": PATH_KERNELS["mixtral_generate"],
})
PATH_IDLE.update({
    "checkpoint_llama": PATH_IDLE["bench_decode"] + ("w8a8_gemm",),
    "checkpoint_dense_import": tuple(k for k in REPLACES if "[" not in k and k not in
                                     PATH_KERNELS["checkpoint_dense_import"]),
    "checkpoint_mixtral": PATH_IDLE["mixtral_generate"] + ("w8a8_gemm",),
})
PATH_IDLE.update({
    "text_server": PATH_IDLE["server"],
    **{path: tuple(k for k in REPLACES if "[" not in k and k not in PATH_KERNELS[path])
       for path in ("eval_ppl", "lora_train")},
})
PHASES = ("kernels", "moe_layer", "llama", "checkpoint", "lora", "tooling", "int4", "mixtral",
          "mixtral_int4", "families", "presets", "sharded", "pipeline")


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def serialized_wgmma(log: str) -> dict:
    """{source: [function, ...]} of ptxas's C7520 warnings in the build log
    (`_build.py` compiles each source with `-Xptxas=-v` under a "== name"
    line): kernels whose `wgmma`s ptxas serialized because it found one, or a
    read of its accumulators, on a path it could not prove uniform."""
    import re

    found, source = {}, None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "C7520" in line:
            name = re.search(r"function '([^']+)'", line)
            found.setdefault(source, []).append(name.group(1) if name else line.strip())
    return found


def ptxas_usage(log: str) -> dict:
    """{function: (registers, spill stores, spill loads)} of every entry
    function in the build log's `-Xptxas=-v` report (bytes of spill)."""
    import re

    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            regs = usage.get(name, (0, 0, 0))[0]
            usage[name] = (regs, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)),) + usage.get(name, (0, 0, 0))[1:]
    return usage


def head256_usage(log: str) -> dict:
    """ptxas_usage of the attention kernels' head-dim-256 instances (template
    argument 256), by kernel: instances, the least and most registers, the
    most spill stores and loads, and how many spill."""
    out = {}
    for name, (regs, st, ld) in ptxas_usage(log).items():
        kernel = next((k for k in ("flash_attention_fwd_kernel", "flash_decode_kernel")
                       if k in name), None)
        if kernel is None or "Li256E" not in name:
            continue
        o = out.setdefault(kernel, dict(instances=0, min_registers=255, max_registers=0,
                                        max_spill_stores=0, max_spill_loads=0, spilling=0))
        o["instances"] += 1
        o["min_registers"] = min(o["min_registers"], regs)
        o["max_registers"] = max(o["max_registers"], regs)
        o["max_spill_stores"] = max(o["max_spill_stores"], st)
        o["max_spill_loads"] = max(o["max_spill_loads"], ld)
        o["spilling"] += bool(st or ld)
    return out


def gemv_tensor_core_mmas(lib_path: str) -> dict:
    """{GEMV kernel: m16n8k16 tensor-core MMAs} in the built library's SASS
    (`cuobjdump -sass`, beside nvcc): the decode GEMV's product must run on
    the tensor cores (`mma.sync` bf16 compiles to HMMA.16816.F32.BF16)."""
    import re

    from eetq_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        name = re.search(r"Function : (\S+)", line)
        if name:
            fn = name.group(1) if "gemv_kernel" in name.group(1) else None
            if fn:
                found[fn] = 0
        elif fn and re.search(r"\bHMMA\.16816\b", line):
            found[fn] += 1
    return found


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, flush=None) -> float:
    """Median device time of fn() over reps launches (CUDA events), each
    after reading `flush` (larger than the 50 MB L2) when it is given: the
    weights of a decode step are never in L2. Reading leaves clean lines, so
    the timed call pays no write-back of the flush."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_many_ms(fn, single_ms: float, flush=None, device_ms: float = 2.0) -> float:
    """Device time of one fn() from a run of launches back to back between
    two CUDA events: enough of them for `device_ms` of device work by the
    single-launch reading `single_ms` (20 to 2,000), captured once into a
    CUDA graph and replayed after one L2 flush. The device never waits for
    the host inside the run, so a kernel of a few microseconds reads its own
    time here; `time_ms` puts one event pair round one Python call and reads
    the wrapper's host time with it. After the first launch the inputs lie
    in L2 where they fit it. fn() must not synchronise with the host."""
    import torch

    n = max(20, min(2000, int(device_ms / max(single_ms, 1e-3)) + 1))
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()  # warm
    if flush is not None:
        flush.sum()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / n


def compare(out, ref) -> tuple[float, float]:
    import torch

    check(bool(torch.isfinite(out.float()).all()), "kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def decode_cost(lens, hq: int, hkv: int, kv_bytes: int, scale_bytes: int,
                d: int = 128, s: int = 1, window: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of one flash-decode call of S query tokens a row
    over rows of `lens` keys: only the keys below each row's length are
    needed (K and V at kv_bytes a value and scale_bytes a key), under a
    window only those some token's window holds, q read and the output
    written once; token i of a row scores the len - S + i + 1 keys it sees,
    at most `window` of them."""
    w = window or 1 << 62
    keys = sum(min(n, w + s - 1) for n in lens)
    scored = sum(min(max(n - s + i + 1, 0), w) for n in lens for i in range(s))
    return (keys * hkv * 2 * (d * kv_bytes + scale_bytes) + len(lens) * (2 * s * hq * d * 2 + 4),
            4.0 * hq * d * scored)


def linear_cost(m: int, k: int, n: int, w_bytes: float, scale_rows: int = 1, x_bytes: int = 2,
                extra: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one quantized linear: the weight at w_bytes a
    value, scale_rows rows of f32 scales, x read and the bf16 output written
    once, `extra` bytes of gamma, per-token scales and the like."""
    return k * n * w_bytes + scale_rows * n * 4 + m * k * x_bytes + m * n * 2 + extra, 2.0 * m * k * n


LIBRARY = {}  # yardstick calls the card's PyTorch build failed: {call: the reason}


def weight_pack_call(x, q, scales, bits: int, group, ref):
    """One PyTorch call computing x @ dequant(q) on the card (q the logical
    [K, N] values), timed beside a kernel as its yardstick and never called
    by the port: torch._weight_int8pack_mm for int8 per-channel weights (the
    [N, K] copy of q made here), torch._weight_int4pack_mm for int4 weights
    with scale groups (packed here from q + 8, even K in the high nibble, by
    torch._convert_weight_to_int4pack; zero points 0). None where nothing
    computes the function, or where the build has no CUDA kernel for the call
    or the call does not reproduce `ref` (printed once, with the reason)."""
    import torch

    if bits == 8 and group is None:
        name = "torch._weight_int8pack_mm"
    elif bits == 4 and group is not None:
        name = "torch._weight_int4pack_mm"
    else:
        return None
    name += " (m <= 8)" if x.shape[0] <= 8 else " (m > 8)"
    if LIBRARY.get(name):  # failed before
        return None
    try:
        if bits == 8:
            w, s = q.t().contiguous(), scales.to(x.dtype)
            fn = lambda: torch._weight_int8pack_mm(x, w, s)  # noqa: E731
        else:
            u = q.t().to(torch.int32) + 8  # [N, K]
            w = torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)
            sz = torch.stack([scales, torch.zeros_like(scales)], -1).to(x.dtype).contiguous()
            fn = lambda: torch._weight_int4pack_mm(x, w, group, sz)  # noqa: E731
        err = (fn().float() - ref.float()).abs().max().item()
        if err > TOL * ref.float().abs().max().item():
            raise RuntimeError(f"differs from the plain version by {err:.3e}")
    except Exception as exc:  # the yardstick is optional: the run goes on without it
        LIBRARY[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        print(f"  {name} is not timed on this card: {LIBRARY[name]}")
        return None
    return fn


def int_mm_call(xq, q):
    """torch._int_mm(xq, q): the int8 x int8 -> int32 product of a W8A8 GEMM
    before its scales (x's per-token scale, the weight's per-channel one),
    timed beside the per-channel W8A8 kernel as its yardstick; None where the
    card's build has no CUDA kernel for it (printed once)."""
    import torch

    name = "torch._int_mm"
    if LIBRARY.get(name):
        return None
    try:
        fn = lambda: torch._int_mm(xq, q)  # noqa: E731
        fn()
    except Exception as exc:  # the yardstick is optional: the run goes on without it
        LIBRARY[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        print(f"  {name} is not timed on this card: {LIBRARY[name]}")
        return None
    return fn


def epilogue_cases(record, gen, dev, flush, scales_for) -> None:
    """The GEMMs' fused epilogue (EPILOGUE_SHAPES): each activation on the
    gate|up shape and each residual mode on the o_proj shape, all with a
    bias, in every regime (the GEMV at m = 1 and 8, the GEMM and the W8A8 /
    W4A8 GEMM at m = 1024; int8 per-channel and int4 g = 128), each against
    its plain version, recorded as "kernel[epilogue]" beside the bias-only
    kernel's times on the same inputs (`base_ms`, `base_many_ms`): the
    epilogue's cost. The int8 W8A8 cases without a transcendental (relu, add,
    mul) must equal the plain version bit for bit."""
    import torch
    import torch.nn.functional as F

    from eetq_tpu_torch.kernels.w8a8 import (
        quantize_activations,
        w4a8_gemm,
        w8a8_gemm,
        w8a8_gemm_ref,
    )
    from eetq_tpu_torch.kernels.w8a16 import (
        w4a16_gemm,
        w4a16_gemv,
        w8a16_gemm,
        w8a16_gemv,
        w8a16_matmul_ref,
    )
    from eetq_tpu_torch.layout.tiling import pack_weights

    kernels = {("gemv", 8): w8a16_gemv, ("gemv", 4): w4a16_gemv, ("gemm", 8): w8a16_gemm,
               ("gemm", 4): w4a16_gemm, ("a8", 8): w8a8_gemm, ("a8", 4): w4a8_gemm}
    for k, n, kinds in EPILOGUE_SHAPES:
        bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)
        for bits, group in ((8, None), (4, INT4_GROUP)):
            lo, hi = (-127, 128) if bits == 8 else (-8, 8)
            q = torch.randint(lo, hi, (k, n), generator=gen, device=dev, dtype=torch.int8)
            data = pack_weights(q, bits=bits).data
            sc = scales_for(k, n, group)
            srows = 1 if group is None else k // group
            tag = f"K={k} N={n} int{bits} {'per-channel' if group is None else f'g={group}'}"
            for kind, m in EPILOGUE_REGIMES:
                kern = kernels[kind, bits]
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                res = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
                if kind == "a8":
                    xq, sx = quantize_activations(x)
                    xq = F.pad(xq, (0, data.shape[0] * (8 // bits) - k)).contiguous()
                    qp = F.pad(q, (0, 0, 0, xq.shape[1] - k))
                    grp = {} if bits == 8 else dict(group_size=group)
                    run = functools.partial(kern, xq, sx, data, sc, n, bias, **grp)
                    plain = functools.partial(w8a8_gemm_ref, xq, sx, qp, sc, n, bias,
                                              group_size=group)
                    cost = linear_cost(m, k, n, bits / 8, srows, x_bytes=1, extra=4 * m + 2 * n)
                else:
                    run = functools.partial(kern, x, data, sc, n, bias)
                    plain = functools.partial(w8a16_matmul_ref, x, q, sc, bias)
                    cost = linear_cost(m, k, n, bits / 8, srows, extra=2 * n)
                base_ms = time_ms(run, flush=flush)
                base_many_ms = time_many_ms(run, base_ms, flush)
                for e in kinds:
                    epi = (dict(activation=e) if e in ACTIVATION_NAMES
                           else dict(residual=res, residual_mode=e))
                    record(f"{kern.__name__}[epilogue]", f"m={m} {tag} +bias {e}",
                           functools.partial(run, **epi), functools.partial(plain, **epi), True,
                           (cost[0] + (2 * m * n if "residual" in epi else 0), cost[1]),
                           "int8" if kind == "a8" else "bf16",
                           equal=kind == "a8" and bits == 8 and e in ("relu", "add", "mul"),
                           regime=GEMV_REGIMES.get(m) if kind == "gemv" else None,
                           base_ms=base_ms, base_many_ms=base_many_ms, epilogue=e)
            del q, data


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version at llama2-7b shapes, the MoE
    kernels at Mixtral's."""
    import torch
    import torch.nn.functional as F

    from eetq_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from eetq_tpu_torch.kernels.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_int8_ref,
        flash_decode_ref,
        gather_pool,
        paged_flash_decode,
        paged_flash_decode_int8,
        paged_flash_decode_int8_ref,
        paged_flash_decode_ref,
    )
    from eetq_tpu_torch.kernels.mlp_fused import (
        fused_mlp_gemv,
        fused_mlp_gemv_i4,
        fused_mlp_ref,
    )
    from eetq_tpu_torch.kernels.w8a8 import (
        quantize_activations,
        w4a8_gemm,
        w8a8_gemm,
        w8a8_gemm_ref,
    )
    from eetq_tpu_torch.kernels.w8a16 import (
        expert_matmul_ref,
        grouped_matmul_ref,
        w4a16_expert_gemv,
        w4a16_gemm,
        w4a16_gemv,
        w4a16_grouped_gemm,
        w8a16_expert_gemv,
        w8a16_gemm,
        w8a16_gemv,
        w8a16_grouped_gemm,
        w8a16_matmul_ref,
    )
    from eetq_tpu_torch.layout.tiling import pack_weights
    from eetq_tpu_torch.ops.rmsnorm import rmsnorm

    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB
    rows, summary = [], {}

    def record(name, case, fn, plain, path_shape, cost, op_type="bf16", library=None,
               equal=False, regime=None, **extra):
        """Run fn() (the kernel) and plain() on the same inputs, compare and
        time both. cost = (bytes, operations) of the function at this case;
        library() is one PyTorch call computing the same function, if any;
        equal: the outputs must not differ in any element; regime: a path
        shape's regime, summed apart in the kernel's summary too; extra:
        further fields of the case's row."""
        out, ref = fn(), plain()
        err, ref_max = compare(out, ref)
        n_diff = int((out.float() != ref.float()).sum().item())
        repeat_equal = (bool(torch.equal(out, fn())) if name.partition("[")[0] in REPEAT_EQUAL
                        else None)
        ms, plain_ms = time_ms(fn, flush=flush), time_ms(plain, flush=flush)
        library_ms = None if library is None else time_ms(library, flush=flush)
        many_ms = time_many_ms(fn, ms, flush)
        library_many_ms = None if library is None else time_many_ms(library, library_ms, flush)
        bytes_ms = 1e3 * cost[0] / hbm_bytes_per_s()
        ops_ms = 1e3 * cost[1] / peak_ops_per_s(op_type)
        ok = err <= TOL * ref_max and not (equal and n_diff) and repeat_equal is not False
        rows.append(dict(kernel=name, case=case, regime=regime, max_abs_err=err,
                         repeat_equal=repeat_equal,
                         ref_absmax=ref_max, tol=0.0 if equal else TOL * ref_max, n_diff=n_diff, numel=out.numel(),
                         ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         many_ms=many_ms, library_many_ms=library_many_ms,
                         bytes=cost[0], ops=cost[1], bytes_ms=bytes_ms, ops_ms=ops_ms,
                         bound_ms=max(bytes_ms, ops_ms), path_shape=bool(path_shape), **extra))
        lib = "" if library_ms is None else (f", library {library_ms:8.4f} ms "
                                             f"(back to back {library_many_ms:.4f})")
        rep = "" if repeat_equal is None else (", repeat bit-equal" if repeat_equal
                                               else ", REPEAT DIFFERS")
        print(f"  {name:20s} {case:44s} err {err:.3e} (tol {rows[-1]['tol']:.3e}, "
              f"{n_diff}/{out.numel()} differ{rep}) {ms:8.4f} ms (back to back {many_ms:.4f}), "
              f"plain {plain_ms:8.4f} ms, bound {max(bytes_ms, ops_ms):7.4f} ms{lib} "
              f"{'ok' if ok else 'FAIL'}")
        s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes_ms=0.0,
                                          ops_ms=0.0, bound_ms=0.0, library_ms=None,
                                          many_ms=0.0, library_many_ms=None))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if path_shape:  # the main path's own shapes make the reported time
            parts = [s]
            if regime is not None:
                parts.append(s.setdefault("regimes", {}).setdefault(regime, dict(
                    ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0, many_ms=0.0,
                    library_ms=None, library_many_ms=None)))
            for part in parts:
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", bytes_ms),
                                 ("ops_ms", ops_ms), ("bound_ms", max(bytes_ms, ops_ms)),
                                 ("many_ms", many_ms)):
                    part[key] += val
                if library_ms is not None:
                    part["library_ms"] = (part["library_ms"] or 0.0) + library_ms
                    part["library_many_ms"] = (part["library_many_ms"] or 0.0) + library_many_ms
        return out

    def scales_for(k, n, group):
        shape = (n,) if group is None else (k // group, n)
        return torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4

    def int4_linear_cases(k, n, group, gemv_ms, gemm_rows, a8_rows, path_group):
        """The int4 GEMV, GEMM and W4A8 GEMM on one [k, n] weight."""
        q = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
        data = pack_weights(q, bits=4).data
        kp = 2 * data.shape[0]
        sc = scales_for(k, n, group)
        srows = 1 if group is None else k // group
        tag = f"K={k} N={n} {'per-channel' if group is None else f'g={group}'}"
        on_path = group == path_group
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        for m in gemv_ms:
            for norm in ((False, True) if (k, n) in PRENORM_SHAPES else (False,)):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                g = gamma if norm else None
                y = rmsnorm(x, gamma, 1e-5) if norm else x
                ref = w8a16_matmul_ref(y, q, sc)
                record("w4a16_gemv", f"m={m} {tag}{' prenorm' if norm else ''}",
                       lambda: w4a16_gemv(x, data, sc, n, gamma=g, eps=1e-5),
                       lambda: w8a16_matmul_ref(rmsnorm(x, gamma, 1e-5) if norm else x, q, sc),
                       on_path and m in GEMV_REGIMES and (k, n) in W8A8_SHAPES
                       and norm == ((k, n) in PRENORM_SHAPES),
                       linear_cost(m, k, n, 0.5, srows, extra=4 * k if norm else 0),
                       library=weight_pack_call(y, q, sc, 4, group, ref) if on_path else None,
                       regime=GEMV_REGIMES.get(m))
        for m in gemm_rows:
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            ref = w8a16_matmul_ref(x, q, sc)
            record("w4a16_gemm", f"m={m} {tag}", lambda: w4a16_gemm(x, data, sc, n),
                   lambda: w8a16_matmul_ref(x, q, sc), on_path and m == 1024,
                   linear_cost(m, k, n, 0.5, srows),
                   library=weight_pack_call(x, q, sc, 4, group, ref) if on_path else None)
        for m in a8_rows:
            xq, sx = quantize_activations(
                torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
            xq = F.pad(xq, (0, kp - k)).contiguous()
            qp = F.pad(q, (0, 0, 0, kp - k))  # the logical values, zero past K
            record("w4a8_gemm", f"m={m} {tag}",
                   lambda: w4a8_gemm(xq, sx, data, sc, n, group_size=group),
                   lambda: w8a8_gemm_ref(xq, sx, qp, sc, n, group_size=group),
                   on_path and m == 1024,
                   linear_cost(m, k, n, 0.5, srows, x_bytes=1, extra=4 * m), "int8",
                   equal=group is None)

    for k, n in LLAMA_SHAPES:
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        scales = scales_for(k, n, None)
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        for m in (1, 2, 4, 8):
            for norm in ((False, True) if (k, n) in PRENORM_SHAPES else (False,)):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                g = gamma if norm else None
                y = rmsnorm(x, gamma, 1e-5) if norm else x
                ref = w8a16_matmul_ref(y, qw, scales)
                record("w8a16_gemv", f"m={m} K={k} N={n}{' prenorm' if norm else ''}",
                       lambda: w8a16_gemv(x, qw, scales, n, gamma=g, eps=1e-5),
                       lambda: w8a16_matmul_ref(rmsnorm(x, gamma, 1e-5) if norm else x, qw, scales),
                       m in GEMV_REGIMES and norm == ((k, n) in PRENORM_SHAPES),
                       linear_cost(m, k, n, 1, extra=4 * k if norm else 0),
                       library=weight_pack_call(y, qw, scales, 8, None, ref),
                       regime=GEMV_REGIMES.get(m))
        # prefill runs the four layer shapes at m = 1024 (the path's time); the
        # lm_head sees the last token only, and m = 9, 200 and 512 are edges
        # of the tile (one row past the GEMV, ragged row blocks)
        for m in GEMM_ROWS if (k, n) in GEMM_EDGE_SHAPES else (1024,):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            ref = w8a16_matmul_ref(x, qw, scales)
            record("w8a16_gemm", f"m={m} K={k} N={n}", lambda: w8a16_gemm(x, qw, scales, n),
                   lambda: w8a16_matmul_ref(x, qw, scales), m == 1024 and (k, n) in W8A8_SHAPES,
                   linear_cost(m, k, n, 1), library=weight_pack_call(x, qw, scales, 8, None, ref))
        # int8 with group-wise scales (the kernels' group mode, counted as the
        # variant "group"): g = 128 on qkv; the offline tp reshard's o_proj and
        # down at group K / tp (TP_GROUP_CASES), tp_generate's at tp = 2
        groups = (((INT4_GROUP, False),) if (k, n) == LLAMA_SHAPES[0] else ()) + tuple(
            (g, on_path) for kk, nn, g, on_path in TP_GROUP_CASES if (kk, nn) == (k, n))
        for group, on_path in groups:
            gs = scales_for(k, n, group)
            for m in TP_GROUP_ROWS:
                kern = w8a16_gemv if m <= 8 else w8a16_gemm
                xg = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                record(f"{kern.__name__}[group]", f"m={m} K={k} N={n} g={group}",
                       lambda: kern(xg, qw, gs, n), lambda: w8a16_matmul_ref(xg, qw, gs),
                       on_path and m in (1, 1024), linear_cost(m, k, n, 1, k // group),
                       regime=GEMV_REGIMES.get(m) if m <= 8 else None)
        if (k, n) in W8A8_SHAPES:  # the per-channel GEMM's two tiles off the rule
            for m in GEMM_TILE_ROWS:
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                for tile in (128, 256):
                    record("w8a16_gemm", f"m={m} K={k} N={n} tile_m={tile}",
                           lambda: w8a16_gemm(x, qw, scales, n, tile_m=tile),
                           lambda: w8a16_matmul_ref(x, qw, scales), False, linear_cost(m, k, n, 1))
        if (k, n) in W8A8_SHAPES:
            for m in W8A8_ROWS:
                xq, sx = quantize_activations(
                    torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
                xq = xq.contiguous()
                record("w8a8_gemm", f"m={m} K={k} N={n}",
                       lambda: w8a8_gemm(xq, sx, qw, scales, n),
                       lambda: w8a8_gemm_ref(xq, sx, qw, scales, n), m == 1024,
                       linear_cost(m, k, n, 1, x_bytes=1, extra=4 * m), "int8", equal=True,
                       library=int_mm_call(xq, qw) if m == 1024 else None)
        del qw
        prefill = (k, n) in W8A8_SHAPES  # the lm_head sees the last token only
        for group in (None, INT4_GROUP):
            int4_linear_cases(k, n, group, (1, 8), (1024,) if prefill else (),
                              W8A8_ROWS if prefill else (), INT4_GROUP)
    for k, n, group in INT4_ODD:
        int4_linear_cases(k, n, group, (3,), (200,), (37,), "none")
    k, n = GEMM_ODD  # int8 per-channel off the tile in K, N and the rows' alignment, with bias
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    data, scales = pack_weights(qw).data, scales_for(k, n, None)
    bias = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    for m in GEMM_ROWS:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        record("w8a16_gemm", f"m={m} K={k} N={n} +bias", lambda: w8a16_gemm(x, data, scales, n, bias),
               lambda: w8a16_matmul_ref(x, qw, scales, bias), False, linear_cost(m, k, n, 1))
    del qw, data

    epilogue_cases(record, gen, dev, flush, scales_for)

    # the MLP of one llama2-7b layer: gate|up [4096, 22016], down [11008, 4096]
    kh, inter = 4096, 11008
    gamma = 1.0 + 0.1 * torch.randn(kh, generator=gen, device=dev)
    for bits, kernel in ((8, fused_mlp_gemv), (4, fused_mlp_gemv_i4)):
        lo, hi = (-127, 128) if bits == 8 else (-8, 8)
        for k, i, n, ms in ((kh, inter, kh, (1, 4, 8)),) + (((1000, 256, 300, (3,)),)
                                                          if bits == 4 else ()):
            gu = torch.randint(lo, hi, (k, 2 * i), generator=gen, device=dev, dtype=torch.int8)
            dn = torch.randint(lo, hi, (i, n), generator=gen, device=dev, dtype=torch.int8)
            gu_d, dn_d = pack_weights(gu, bits=bits).data, pack_weights(dn, bits=bits).data
            gu_s, dn_s = scales_for(k, 2 * i, None), scales_for(i, n, None)
            gam = gamma if k == kh else 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
            for m in ms:
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                res = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
                cost = (bits / 8 * (k * 2 * i + i * n) + 4 * (2 * i + n + k)
                        + 2 * m * (k + 2 * n), 2.0 * m * (k * 2 * i + i * n))
                record(kernel.__name__, f"m={m} K={k} I={i} N={n} +residual",
                       lambda: kernel(x, gam, 1e-5, gu_d, gu_s, dn_d, dn_s, n, res),
                       lambda: fused_mlp_ref(x, gam, gu, gu_s, dn, dn_s, 1e-5, residual=res),
                       m == 1 and k == kh, cost)
            del gu, dn, gu_d, dn_d

    def sdpa(q, k, v, mask=None):
        """[B, S, H, D] in and out, as the kernels take them."""
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=mask is None).transpose(1, 2)

    for b, sq, skv, hq, hkv, d in ATTENTION_CASES:
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(b, skv, 2 * hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]  # strided views, as the model passes them
        # causal, the last query on the last key: row i sees i + 1 + skv - sq
        # keys; 2 D operations a score, twice (q.k and p.v)
        scores = sq * (skv - sq) + sq * (sq + 1) / 2
        cost = (b * (sq * 2 * hq + skv * 2 * hkv) * d * 2, 4.0 * b * hq * d * scores)
        main = (b, sq, skv, hq, hkv, d) == ATTENTION_CASES[0]
        # torch's is_causal aligns the first query with the first key: the
        # library call is timed where the two agree (sq == skv, no GQA)
        record("flash_attention_fwd", f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d}",
               lambda: flash_attention(q, k, v), lambda: flash_attention_ref(q, k, v),
               main, cost, library=(lambda: sdpa(q, k, v)) if hq == hkv and sq == skv else None)

    for b in (1, 4):
        for hq, hkv in ((32, 32), (32, 8)):
            q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
            kc = torch.randn(b, hkv, 1152, 128, generator=gen, device=dev).to(torch.bfloat16)
            vc = torch.randn(b, hkv, 1152, 128, generator=gen, device=dev).to(torch.bfloat16)
            lens = [1074, 1, 640, 1152][:b]
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            # the same function as one masked attention call over the whole cache
            mask = (torch.arange(1152, device=dev)[None] < lengths[:, None])[:, None, None]
            record("flash_decode", f"B={b} L=1152 Hq={hq} Hkv={hkv} D=128",
                   lambda: flash_decode(q, kc, vc, lengths),
                   lambda: flash_decode_ref(q, kc, vc, lengths), b == 1 and hq == hkv,
                   decode_cost(lens, hq, hkv, 2, 0),
                   library=(lambda: sdpa(q, kc.transpose(1, 2), vc.transpose(1, 2), mask))
                   if hq == hkv else None)

    for b in (1, 8):
        for l in (1152, 2048):
            for hq, hkv in ((32, 32), (32, 8)):
                q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
                kc, ks = quantize_activations(
                    torch.randn(b, hkv, l, 128, generator=gen, device=dev))
                vc, vs = quantize_activations(
                    torch.randn(b, hkv, l, 128, generator=gen, device=dev))
                lens = [1074, 1, 640, l, 17, 1500 % l, 300, 1024][:b]
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                regime = DECODE_REGIMES.get((b, l)) if hq == hkv else None
                record("flash_decode_int8", f"B={b} L={l} Hq={hq} Hkv={hkv} D=128",
                       lambda: flash_decode_int8(q, kc, vc, ks, vs, lengths),
                       lambda: flash_decode_int8_ref(q, kc, vc, ks, vs, lengths),
                       regime is not None, decode_cost(lens, hq, hkv, 1, 4), regime=regime)

    # Paged decode at the engines' shapes: 8 rows of very different lengths
    # over pools of 256-token blocks behind a permuted table. The kernel gets
    # a table whose entries past each row's last live block are far out of
    # the pool: it must never read them. Each case is also held against the
    # dense kernel on the cache gathered through the table (the same keys in
    # the same chunks and tiles, merged in the same order: bit-equal), and
    # timed beside it.
    bs, max_blocks, nblocks = PAGED_BLOCK_SIZE, 2048 // PAGED_BLOCK_SIZE, PAGED_POOL_BLOCKS
    lens = list(PAGED_LENGTHS)
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for int8 in (False, True):
        for hq, hkv in ((32, 32), (32, 8)):
            table = torch.randperm(nblocks, generator=gen, device=dev)[:b * max_blocks].reshape(
                b, max_blocks).to(torch.int32).contiguous()
            live = torch.arange(max_blocks, device=dev)[None] * bs < lengths[:, None]
            wild = torch.where(live, table, torch.full_like(table, 10 ** 6 + 12345))
            q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
            pools = [torch.randn(nblocks, hkv, bs, 128, generator=gen, device=dev)
                     for _ in range(2)]
            case = f"B={b} BS={bs} NB={nblocks} Hq={hq} Hkv={hkv} D=128 permuted table"
            if int8:
                (kp_, ksc), (vp_, vsc) = (quantize_activations(t) for t in pools)
                dense = [gather_pool(t, table) for t in (kp_, vp_, ksc, vsc)]
                dense_ms = time_ms(lambda: flash_decode_int8(q, *dense, lengths), flush=flush)
                out = record(
                    "paged_flash_decode_int8", case,
                    lambda: paged_flash_decode_int8(q, kp_, vp_, ksc, vsc, wild, lengths),
                    lambda: paged_flash_decode_int8_ref(q, kp_, vp_, ksc, vsc, table, lengths),
                    hq != hkv, decode_cost(lens, hq, hkv, 1, 4), dense_ms=dense_ms)
                twin = flash_decode_int8(q, *dense, lengths)
            else:
                kp_, vp_ = (t.to(torch.bfloat16) for t in pools)
                dense = [gather_pool(t, table) for t in (kp_, vp_)]
                dense_ms = time_ms(lambda: flash_decode(q, *dense, lengths), flush=flush)
                out = record(
                    "paged_flash_decode", case,
                    lambda: paged_flash_decode(q, kp_, vp_, wild, lengths),
                    lambda: paged_flash_decode_ref(q, kp_, vp_, table, lengths),
                    hq == hkv, decode_cost(lens, hq, hkv, 2, 0), dense_ms=dense_ms)
                twin = flash_decode(q, *dense, lengths)
            err, _ = compare(out, twin)
            equal = bool(torch.equal(out, twin))
            rows[-1].update(dense_kernel_err=err, dense_kernel_equal=equal)
            print(f"  {'':20s} against the dense kernel on the gathered cache: "
                  f"{'bit-equal' if equal else 'DIFFERS'} (err {err:.3e}), "
                  f"dense kernel {dense_ms:.4f} ms")
            check(equal, f"paged decode differs from the dense kernel: {case}")
            del pools, dense, kp_, vp_

    # The multi-query (S > 1) verify of speculative decoding, query token i of
    # a row at length - S + i: each case against its plain version, its
    # repeats bit-equal, and token i bit-equal to an S = 1 call at
    # length - S + i + 1 (the same chunks, tiles and merge order).
    def sequential_equal(kernel, out, q, lengths, s, case):
        seq = torch.cat([kernel(q[:, i:i + 1].contiguous(), lengths - s + i + 1)
                         for i in range(s)], dim=1)
        equal = bool(torch.equal(out, seq))
        rows[-1].update(sequential_equal=equal)
        print(f"  {'':20s} against {s} sequential S = 1 calls: "
              f"{'bit-equal' if equal else 'DIFFERS'}")
        check(equal, f"the S = {s} call differs from S sequential S = 1 calls: {case}")

    for int8 in (False, True):
        for b, s, hq, hkv, l, lens, regime in VERIFY_CASES:
            q = torch.randn(b, s, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            caches = [torch.randn(b, hkv, l, 128, generator=gen, device=dev) for _ in range(2)]
            case = f"S={s} B={b} L={l} Hq={hq} Hkv={hkv} D=128 lengths {min(lens)}..{max(lens)}"
            if int8:
                (kc, ks), (vc, vs) = (quantize_activations(t) for t in caches)
                kernel = lambda q_, n_: flash_decode_int8(q_, kc, vc, ks, vs, n_)  # noqa: E731
                plain = lambda: flash_decode_int8_ref(q, kc, vc, ks, vs, lengths)  # noqa: E731
                name, cost, library = "flash_decode_int8", decode_cost(lens, hq, hkv, 1, 4, s=s), None
            else:
                kc, vc = (t.to(torch.bfloat16) for t in caches)
                kernel = lambda q_, n_: flash_decode(q_, kc, vc, n_)  # noqa: E731
                plain = lambda: flash_decode_ref(q, kc, vc, lengths)  # noqa: E731
                name, cost = "flash_decode", decode_cost(lens, hq, hkv, 2, 0, s=s)
                # the same function as one attention call with an explicit [S, L] mask
                qpos = lengths[:, None] - s + torch.arange(s, device=dev)
                mask = (torch.arange(l, device=dev) <= qpos[..., None])[:, None]
                library = ((lambda: sdpa(q, kc.transpose(1, 2), vc.transpose(1, 2), mask))
                           if hq == hkv else None)
            if b > 1 and not int8:
                regime = None  # the dense spec engine's cache is int8
            out = record(name, case, lambda: kernel(q, lengths), plain, regime is not None, cost,
                         library=library, regime=regime, s=s)
            sequential_equal(kernel, out, q, lengths, s, case)
            del caches, kc, vc

    # paged verify: the engine's 8 rows of very different lengths (the
    # shortest row's first tokens see no key: zeros), a permuted table whose
    # dead entries point out of the pool; also bit-equal to the dense kernel
    # on the gathered cache
    s, lens = VERIFY_PAGED_S, list(PAGED_LENGTHS)
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for int8 in (False, True):
        hq = hkv = 32
        table = torch.randperm(nblocks, generator=gen, device=dev)[:b * max_blocks].reshape(
            b, max_blocks).to(torch.int32).contiguous()
        live = torch.arange(max_blocks, device=dev)[None] * bs < lengths[:, None]
        wild = torch.where(live, table, torch.full_like(table, 10 ** 6 + 12345))
        q = torch.randn(b, s, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
        pools = [torch.randn(nblocks, hkv, bs, 128, generator=gen, device=dev)
                 for _ in range(2)]
        case = f"S={s} B={b} BS={bs} NB={nblocks} Hq={hq} Hkv={hkv} D=128 permuted table"
        if int8:
            (kp_, ksc), (vp_, vsc) = (quantize_activations(t) for t in pools)
            leaves = (kp_, vp_, ksc, vsc)
            kernel = lambda q_, n_: paged_flash_decode_int8(q_, *leaves, wild, n_)  # noqa: E731
            plain = lambda: paged_flash_decode_int8_ref(q, *leaves, table, lengths)  # noqa: E731
            name, dense_fn, cost = ("paged_flash_decode_int8", flash_decode_int8,
                                    decode_cost(lens, hq, hkv, 1, 4, s=s))
        else:
            leaves = tuple(t.to(torch.bfloat16) for t in pools)
            kernel = lambda q_, n_: paged_flash_decode(q_, *leaves, wild, n_)  # noqa: E731
            plain = lambda: paged_flash_decode_ref(q, *leaves, table, lengths)  # noqa: E731
            name, dense_fn, cost = ("paged_flash_decode", flash_decode,
                                    decode_cost(lens, hq, hkv, 2, 0, s=s))
        out = record(name, case, lambda: kernel(q, lengths), plain, not int8, cost,
                     regime="engine verify B=8 S=8" if not int8 else None, s=s)
        sequential_equal(kernel, out, q, lengths, s, case)
        twin = dense_fn(q, *(gather_pool(t, table) for t in leaves), lengths)
        check(bool(torch.equal(out, twin)), f"paged verify differs from the dense kernel: {case}")
        print(f"  {'':20s} against the dense kernel on the gathered cache: bit-equal")
        del pools, leaves

    variant_cases(record, sequential_equal, gen, dev)

    # Mixtral's banks, int8 and int4, per-channel and with 128-row scale
    # groups. The path's time: the gather of a b=1 decode step (gate|up and
    # down), and the grouped GEMMs of a 1024-token prompt and of an 8-slot
    # engine step, per-channel for the int8 kernels (the W8A16 model) and
    # group-wise for the int4 ones (the W4A16 g=128 model). Only the experts
    # that are picked are read, each once, and only the rows of real blocks
    # are read and multiplied.
    for bits, group in ((8, None), (8, INT4_GROUP), (4, None), (4, INT4_GROUP)):
        gemv, gemm = ((w8a16_expert_gemv, w8a16_grouped_gemm) if bits == 8
                      else (w4a16_expert_gemv, w4a16_grouped_gemm))
        on_path = group is None if bits == 8 else group == INT4_GROUP
        lo, hi = (-127, 128) if bits == 8 else (-8, 8)
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'}"
        for j, (k, n) in enumerate(MIXTRAL_BANKS):
            bank = torch.randint(lo, hi, (8, k, n), generator=gen, device=dev, dtype=torch.int8)
            data = pack_weights(bank, bits=bits).data
            srows = 1 if group is None else k // group
            scales = torch.rand((8, n) if group is None else (8, srows, n), generator=gen,
                                device=dev) * 2e-3 + 1e-4
            expert_bytes = k * n * bits / 8 + 4 * srows * n
            for *ms, ids in GATHER_CASES:
                m = ms[j]
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                eids = torch.tensor(ids, dtype=torch.int32, device=dev)
                rep = " repeated id" if len(set(ids)) < len(ids) else ""
                cost = (len(set(ids)) * expert_bytes + m * k * 2 + len(ids) * (m * n * 2 + 4),
                        2.0 * m * k * n * len(ids))
                record(gemv.__name__, f"{tag} n_sel={len(ids)} m={m} K={k} N={n}{rep}",
                       lambda: gemv(x, data, scales, eids, n),
                       lambda: expert_matmul_ref(x, bank, scales, eids),
                       on_path and len(ids) == 2, cost)
            for bm, nb, real, regime in GROUPED_CASES:
                be = real + (7,) * (nb - len(real))
                x = torch.randn(nb * bm, k, generator=gen, device=dev).to(torch.bfloat16)
                x[len(real) * bm:] = 0  # padding blocks hold zero rows
                blocks = torch.tensor(be, dtype=torch.int32, device=dev)
                count = torch.tensor([len(real)], dtype=torch.int32, device=dev)
                real_rows = len(real) * bm
                cost = (len(set(real)) * expert_bytes + real_rows * k * 2 + nb * bm * n * 2
                        + 4 * (nb + 1), 2.0 * real_rows * k * n)
                record(gemm.__name__,
                       f"{tag} bm={bm} nb={nb} ({nb - len(real)} padding) K={k} N={n}",
                       lambda: gemm(x, data, scales, blocks, n, count),
                       lambda: grouped_matmul_ref(x, bank, scales, blocks, bm),
                       on_path and regime is not None, cost, regime=regime)
            del bank, data
    # the bank kernels off the tile: K and N that need padding, groups of 64
    for bits, (k, n, group) in ((4, INT4_ODD[0]), (4, INT4_ODD[1]), (8, INT4_ODD[1])):
        gemv, gemm = ((w8a16_expert_gemv, w8a16_grouped_gemm) if bits == 8
                      else (w4a16_expert_gemv, w4a16_grouped_gemm))
        lo, hi = (-127, 128) if bits == 8 else (-8, 8)
        bank = torch.randint(lo, hi, (3, k, n), generator=gen, device=dev, dtype=torch.int8)
        data = pack_weights(bank, bits=bits).data
        srows = 1 if group is None else k // group
        scales = torch.rand((3, n) if group is None else (3, srows, n), generator=gen,
                            device=dev) * 2e-3 + 1e-4
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'} K={k} N={n}"
        eids = torch.tensor((2, 0, 2), dtype=torch.int32, device=dev)
        x = torch.randn(3, k, generator=gen, device=dev).to(torch.bfloat16)
        cost = (2 * (k * n * bits / 8 + 4 * srows * n) + 3 * k * 2 + 3 * (3 * n * 2 + 4),
                2.0 * 3 * k * n * 3)
        record(gemv.__name__, f"{tag} n_sel=3 m=3", lambda: gemv(x, data, scales, eids, n),
               lambda: expert_matmul_ref(x, bank, scales, eids), False, cost)
        xg = torch.randn(3 * 40, k, generator=gen, device=dev).to(torch.bfloat16)
        cost = (2 * (k * n * bits / 8 + 4 * srows * n) + 120 * (k + n) * 2 + 12,
                2.0 * 120 * k * n)
        record(gemm.__name__, f"{tag} bm=40 nb=3", lambda: gemm(xg, data, scales, eids, n),
               lambda: grouped_matmul_ref(xg, bank, scales, eids, 40), False, cost)
    del flush
    torch.cuda.synchronize()
    bad = [f"{r['kernel']} {r['case']}" for r in rows if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    for name, s in summary.items():
        s["bound_by"] = "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations"
        for regime, r in s.get("regimes", {}).items():
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
            lib = "" if r["library_ms"] is None else (
                f", library {r['library_ms']:.4f} ms (back to back {r['library_many_ms']:.4f})")
            print(f"  {name:20s} {regime}: {r['ms']:.4f} ms (back to back {r['many_ms']:.4f}), "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms"
                  f"{lib}")
    return dict(rows=rows, summary=summary)


def variant_tag(window, alibi: bool, hq: int, hkv: int) -> str:
    return (f"window {window}" if window else "ALiBi" if alibi else f"G={hq // hkv}")



def seen_bias(qpos, kpos, window, slopes):
    """[B, Hq or 1, S, L] bf16: what a query at qpos [B, S] sees of the keys
    at kpos [L] as one float mask, the ALiBi bias slope (key - qpos) (or 0)
    where it sees a key, -inf elsewhere: the attention kernels' function as
    one `F.scaled_dot_product_attention` call."""
    import torch

    dist = (kpos - qpos[..., None]).float()[:, None]  # [B, 1, S, L]
    seen = dist <= 0
    if window:
        seen &= dist > -window
    bias = dist * slopes.float()[:, None, None] if slopes is not None else torch.zeros_like(dist)
    return torch.where(seen, bias, float("-inf")).to(torch.bfloat16)


def variant_cases(record, sequential_equal, gen, dev) -> None:
    """The attention kernels' variants (a sliding window, ALiBi, a GQA group
    other than 1, 2, 4, 8) at the family paths' shapes, each recorded as
    "kernel[variant]" against its plain version, beside the byte or
    operation bound of the keys it must see and SDPA under the same float
    mask. The flash-decode cases run their four entry points: the paged
    ones over a pool holding the dense cache's keys behind a permuted table
    whose entries before the earliest window and past the length point out
    of the pool, bit-equal to the dense kernel; the multi-query cases each
    token bit-equal to a one-token call at its own length."""
    import torch
    import torch.nn.functional as F

    from eetq_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from eetq_tpu_torch.kernels.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_int8_ref,
        flash_decode_ref,
        paged_flash_decode,
        paged_flash_decode_int8,
        paged_flash_decode_int8_ref,
        paged_flash_decode_ref,
    )
    from eetq_tpu_torch.kernels.autotune import max_query_rows
    from eetq_tpu_torch.kernels.w8a8 import quantize_activations
    from eetq_tpu_torch.ops.alibi import alibi_slopes_cache

    def sdpa(q, k, v, bias):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=bias,
            enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)

    def lower_right_sdpa(q, k, v, window, ref):
        """One SDPA call computing a chunk's attention, the last query on the
        last key: under torch's lower-right causal bias (MHA, no window), else
        under the same float mask; None where the card's PyTorch cannot or
        does not reproduce `ref` (printed once)."""
        b, sq, hq = q.shape[:3]
        skv = k.shape[1]
        plain = window is None and hq == k.shape[2]
        name = ("F.scaled_dot_product_attention " +
                ("(causal_lower_right)" if plain else "(float mask)"))
        if LIBRARY.get(name):
            return None
        try:
            if plain:
                from torch.nn.attention.bias import causal_lower_right

                bias = causal_lower_right(sq, skv)
            else:
                bias = seen_bias(torch.arange(skv - sq, skv, device=dev)[None].expand(b, sq),
                                 torch.arange(skv, device=dev), window, None)
            fn = lambda: sdpa(q, k, v, bias)  # noqa: E731
            err = (fn().float() - ref.float()).abs().max().item()
            if err > TOL * ref.float().abs().max().item():
                raise RuntimeError(f"differs from the plain version by {err:.3e}")
        except Exception as exc:  # the yardstick is optional: the run goes on without it
            LIBRARY[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
            print(f"  {name} is not timed on this card: {LIBRARY[name]}")
            return None
        return fn

    for variant, b, sq, hq, hkv, window, alibi, main, d in ATTENTION_VARIANT_CASES:
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(b, sq, 2 * hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
        slopes = alibi_slopes_cache(hq, dev) if alibi else None
        pos = torch.arange(sq, device=dev)
        scores = int(torch.clamp(pos + 1, max=window or sq).sum())  # the keys each row sees
        cost = (b * sq * 2 * (hq + hkv) * d * 2, 4.0 * b * hq * d * scores)
        bias = seen_bias(pos[None].expand(b, sq), pos, window, slopes)
        record(f"flash_attention_fwd[{variant}]",
               f"B={b} S={sq} Hq={hq} Hkv={hkv} D={d} {variant_tag(window, alibi, hq, hkv)}",
               lambda: flash_attention(q, k, v, window=window, slopes=slopes),
               lambda: flash_attention_ref(q, k, v, window=window, slopes=slopes), main, cost,
               library=lambda: sdpa(q, k, v, bias))
        del q, kv, k, v, bias

    def pooled(leaf, table, bs):
        """A pool holding leaf [B, Hkv, L(, D)] cut into blocks of bs keys at
        the blocks table [B, L / bs] names, with one spare block."""
        b, hkv, l = leaf.shape[:3]
        nb = l // bs
        blocks = leaf.reshape(b, hkv, nb, bs, *leaf.shape[3:]).transpose(1, 2)
        pool = torch.zeros(b * nb + 1, hkv, bs, *leaf.shape[3:], dtype=leaf.dtype, device=dev)
        pool[table.reshape(-1).long()] = blocks.reshape(b * nb, hkv, bs, *leaf.shape[3:])
        return pool

    def decode_entry_points(variant, b, s, hq, hkv, l, lens, window, alibi, main, paged=True,
                            d=128):
        """Dense bf16 and int8, then paged, of one shape: S = 1 cases, or
        S > 1 cases each checked token by token. variant None: the entry
        points' own names."""
        slopes = alibi_slopes_cache(hq, dev) if alibi else None
        suffix = f"[{variant}]" if variant else ""
        # the query rows of a kv head and the row blocks they take (K and V
        # are read once a row block)
        rows = hq // hkv * s
        blocks = dict(rows=rows, row_blocks=-(-rows // max_query_rows(d)))
        kw = dict(window=window, slopes=slopes)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        caches = [torch.randn(b, hkv, l, d, generator=gen, device=dev) for _ in range(2)]
        bs = PAGED_BLOCK_SIZE
        nb = l // bs
        table = torch.randperm(b * nb + 1, generator=gen, device=dev)[:b * nb].reshape(
            b, nb).to(torch.int32).contiguous()
        start = torch.arange(nb, device=dev)[None] * bs
        first = (lengths - s + 1 - (window or 1 << 30)).clamp(min=0)  # token 0's first key
        live = (start < lengths[:, None]) & (start + bs > first[:, None])
        wild = torch.where(live, table, torch.full_like(table, 10 ** 6 + 12345))
        tag = (f"S={s} " if s > 1 else "") + (
            f"B={b} L={l} Hq={hq} Hkv={hkv} D={d} {variant_tag(window, alibi, hq, hkv)} "
            f"lengths {min(lens)}..{max(lens)}")
        qpos = lengths[:, None] - s + torch.arange(s, device=dev)
        for int8 in (False, True):
            if int8:
                (kc, ks), (vc, vs) = (quantize_activations(t) for t in caches)
                leaves = (kc, vc, ks, vs)
                dense, dense_ref = flash_decode_int8, flash_decode_int8_ref
                paged_fn, paged_ref = paged_flash_decode_int8, paged_flash_decode_int8_ref
                cost, library = decode_cost(lens, hq, hkv, 1, 4, d, s, window), None
            else:
                leaves = tuple(t.to(torch.bfloat16) for t in caches)
                dense, dense_ref = flash_decode, flash_decode_ref
                paged_fn, paged_ref = paged_flash_decode, paged_flash_decode_ref
                cost = decode_cost(lens, hq, hkv, 2, 0, d, s, window)
                bias = seen_bias(qpos, torch.arange(l, device=dev), window, slopes)
                kd, vd = (t.transpose(1, 2) for t in leaves)
                library = lambda: sdpa(q, kd, vd, bias)  # noqa: E731
            kernel = lambda q_, n_: dense(q_, *leaves, n_, **kw)  # noqa: E731
            out = record(f"{dense.__name__}{suffix}", tag,
                         lambda: kernel(q, lengths),
                         lambda: dense_ref(q, *leaves, lengths, **kw), main and b == 1, cost,
                         library=library, s=s, **blocks)
            if s > 1:
                sequential_equal(kernel, out, q, lengths, s, tag)
            if not paged:
                continue
            pools = [pooled(t, table, bs) for t in leaves]
            kernel = lambda q_, n_: paged_fn(q_, *pools, wild, n_, **kw)  # noqa: E731
            got = record(f"{paged_fn.__name__}{suffix}",
                         f"{tag} BS={bs} permuted table",
                         lambda: kernel(q, lengths),
                         lambda: paged_ref(q, *pools, table, lengths, **kw), main and b > 1, cost,
                         s=s, **blocks)
            if s > 1:
                sequential_equal(kernel, got, q, lengths, s, tag)
            equal = bool(torch.equal(got, out))
            print(f"  {'':20s} against the dense kernel on the same keys: "
                  f"{'bit-equal' if equal else 'DIFFERS'}")
            check(equal, f"paged decode differs from the dense kernel: {paged_fn.__name__} {tag}")
            del pools
        del caches, leaves

    for case in DECODE_VARIANT_CASES:
        decode_entry_points(case[0], case[1], 1, *case[2:])
    for case in VERIFY_VARIANT_CASES:
        decode_entry_points(*case[:7], window=case[7], alibi=case[8], main=False, d=case[9])
    for case in ROW_BLOCK_CASES:
        decode_entry_points(*case[:10], d=case[10])

    # chunked prefill's attention: a chunk of queries over the cache's prefix,
    # the cache [B, Hkv, L, D] read in place as [B, L, Hkv, D]; also bit-equal
    # to the kernel on a contiguous copy of the same keys
    for variant, b, sq, skv, hq, hkv, cap, window, main in CHUNK_ATTENTION_CASES:
        d = 128
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        k, v = kc[:, :, :skv].transpose(1, 2), vc[:, :, :skv].transpose(1, 2)
        qpos = torch.arange(skv - sq, skv, device=dev)
        # causal, the last query on the last key: sq (skv - sq) + sq (sq + 1) / 2
        # scores without a window, each at most `window` with one
        scores = int(torch.clamp(qpos + 1, max=window or skv).sum())
        cost = (b * (sq * 2 * hq + skv * 2 * hkv) * d * 2, 4.0 * b * hq * d * scores)
        ref = flash_attention_ref(q, k, v, window=window)
        name = "flash_attention_fwd" + (f"[{variant}]" if variant else "")
        case = (f"chunk B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d}"
                + (f" window {window}" if window else "") + f" over a cache of {cap}")
        out = record(name, case, lambda: flash_attention(q, k, v, window=window),
                     lambda: flash_attention_ref(q, k, v, window=window), False, cost,
                     library=lower_right_sdpa(q, k, v, window, ref), chunk_path=main)
        twin = flash_attention(q, k.contiguous(), v.contiguous(), window=window)
        equal = bool(torch.equal(out, twin))
        print(f"  {'':20s} against the kernel on contiguous keys: "
              f"{'bit-equal' if equal else 'DIFFERS'}")
        check(equal, f"the prefill kernel over the cache view differs from contiguous keys: {case}")
        del q, kc, vc, k, v, ref, out, twin


@contextlib.contextmanager
def routing(mode: str, log: list):
    """Wrap `modules.moe.route`: "record" appends each call's (weights, ids)
    to `log`; "replay" returns the entries of `log` in order instead of
    routing, and checks at the end that every entry was used."""
    from eetq_tpu_torch.modules import moe

    route, replay = moe.route, iter(log)

    def wrapped(router, x2, top_k):
        if mode == "record":
            log.append(route(router, x2, top_k))
            return log[-1]
        topw, topi = next(replay)
        check(tuple(topi.shape) == (x2.shape[0], top_k), "replayed routing does not fit the call")
        return topw, topi

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = route
    if mode == "replay":
        check(next(replay, None) is None, "replay left routings unused")


def routing_differences(fn, kernel_log: list) -> dict:
    """Run fn() (the plain path) routing for itself; count the tokens of all
    its route calls whose top-k set differs from the kernel path's."""
    log = []
    with routing("record", log):
        fn()
    check(len(log) == len(kernel_log), "the paths made different numbers of route calls")
    diff = sum(int((a[1].sort(-1).values != b[1].sort(-1).values).any(-1).sum())
               for a, b in zip(kernel_log, log))
    total = sum(a[1].shape[0] for a in kernel_log)
    return dict(differ=diff, routings=total)


def counted(path: str, fn):
    """Run fn() with every launch counter at 0; return (its result, the
    counts). Fails if a kernel of the path did not launch, or if one it
    must not run did: those of PATH_IDLE, the attention kernels' variants
    the path does not run, and on a family path any kernel not of it."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(path, counts)
    return out, counts


def check_launches(path: str, counts: dict) -> None:
    """`counted`'s check of one path's launch counts (for a sharded path, the
    ranks' counts summed)."""
    print(f"  launches on the {path} path: {counts}")
    idle = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    check(not idle, f"kernels not launched on the {path} path: {idle}")
    idle = PATH_IDLE.get(path, ())
    idle += tuple(k for k in counts if k not in PATH_KERNELS[path]
                  and (path not in PATH_IDLE or "[" in k))
    busy = [k for k in idle if counts[k]]
    check(not busy, f"kernels launched on the {path} path that must not be: {busy}")


def moe_layer_phase(dev) -> dict:
    """`moe_apply` on one full-width Mixtral layer (random banks quantized to
    int8 per channel, then to int4 with INT4_GROUP-row groups), kernel
    regimes against the plain masked scan on the same input, at 2, 8 and 2048
    selections (gather, gather, grouped). Both sides route on identical
    input, so their ids must agree. The kernel calls run under
    torch.cuda.set_sync_debug_mode("error"): a host sync fails."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.modules.linear import DenseLinear
    from eetq_tpu_torch.modules.moe import MoEMLP, quantize_moe

    cfg = PRESETS[MIXTRAL]
    h, inter, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, device=dev) * shape[-2] ** -0.5
        return DenseLinear(w.to(torch.bfloat16))

    bf16 = MoEMLP(dense(h, e), dense(e, h, 2 * inter), dense(e, inter, h))
    out = {}
    for bits, group in ((8, None), (4, INT4_GROUP)):
        moe = quantize_moe(bf16, bits=bits, group_size=group)
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'}"
        out[tag] = _moe_layer_cases(moe, cfg, gen, dev, tag)
        if bits == 8:
            out["knobs"] = _moe_knob_cases(moe, cfg, gen, dev)
        del moe
    return out


def _moe_knob_cases(moe, cfg, gen, dev) -> list:
    """MOE_KNOB_CASES: each knob set in turn, the kernel path's launches
    counted, its output against the plain path with the routing replayed."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.modules.moe import moe_apply

    out = []
    for knob, value, t, busy, idle in MOE_KNOB_CASES:
        x = torch.randn(1, t, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
        log = []
        os.environ[knob] = value
        try:
            with routing("record", log):
                reset_launch_counts()
                y = moe_apply(moe, x, cfg.num_experts_per_tok)
                torch.cuda.synchronize()
                counts = {k: n for k, n in launch_counts().items() if n}
        finally:
            del os.environ[knob]
        with routing("replay", log):
            ref = moe_apply(moe, x, cfg.num_experts_per_tok, use_kernel=False)
        err, ref_max = compare(y, ref)
        case = f"{knob}={value} at {t} tokens"
        print(f"  moe_apply {case}: err {err:.3e} (tol {MODEL_TOL * ref_max:.3e}), "
              f"launches {counts}")
        check(err <= MODEL_TOL * ref_max, f"moe_apply {case} differs from the plain path")
        check(all(counts.get(k) for k in busy), f"moe_apply {case}: {busy} must launch")
        check(not any(counts.get(k) for k in idle), f"moe_apply {case}: {idle} must not launch")
        out.append(dict(case=case, max_abs_err=err, ref_absmax=ref_max, counts=counts))
    return out


def _moe_layer_cases(moe, cfg, gen, dev, tag: str) -> dict:
    import torch

    from eetq_tpu_torch.modules.moe import moe_apply

    h, out = cfg.hidden_size, {}
    for t in MOE_TOKENS:
        x = torch.randn(1, t, h, generator=gen, device=dev).to(torch.bfloat16)
        ys, logs = {}, {True: [], False: []}
        for use in (True, False):
            torch.cuda.synchronize()
            with routing("record", logs[use]):
                if use:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    ys[use] = moe_apply(moe, x, cfg.num_experts_per_tok, use_kernel=use)
                except RuntimeError as err:
                    raise CheckFailed(f"moe_apply ({tag}) at {t} tokens: {err}") from err
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        check(torch.equal(logs[True][0][1], logs[False][0][1]),
              f"moe_apply at {t} tokens: the two paths routed differently")
        err, ref_max = compare(ys[True], ys[False])
        n_sel = t * cfg.num_experts_per_tok
        print(f"  moe_apply {tag} {n_sel:5d} selections: err {err:.3e} "
              f"(tol {TOL * ref_max:.3e}), same routing, no host sync")
        check(err <= TOL * ref_max, f"moe_apply at {n_sel} selections differs from the plain path")
        out[n_sel] = dict(max_abs_err=err, ref_absmax=ref_max, tol=TOL * ref_max)
    return out


def check_logits(name: str, got, ref, tol: float = MODEL_TOL) -> dict:
    import torch

    check(bool(torch.isfinite(got).all()), f"{name} logits are not finite")
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    print(f"  {name} logits vs plain path: max abs err {err:.4e}, "
          f"relative {rel:.4e} (tol {tol}), argmax equal {same}")
    check(rel <= tol, f"{name} logits differ from the plain path by {rel:.3e}")
    return dict(max_abs_err=err, rel_err=rel, tol=tol, argmax_equal=same)


def graph_against_eager(params, cfg, dev, prompt, n: int, kv, fused) -> dict:
    """decode_loop (one step captured, replayed n - 2 times) against a Python
    loop of eager decode_step on a copy of the same prefilled caches: the
    greedy tokens must be bit-equal, and the launches of the whole loop those
    of n - 1 eager steps (the warm-up step and the replays; the capture adds
    none)."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.modules.attention import KVCache
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step, prefill

    p = prompt.shape[1]
    caches = init_caches(cfg, prompt.shape[0], p + n, device=dev, dtype=kv)
    lp, caches = prefill(params, cfg, prompt, caches)
    first = torch.argmax(lp, -1)
    twin = [KVCache(*(None if t is None else t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)))
            for c in caches]
    tok, eager = first, [first]
    for i in range(n - 1):
        reset_launch_counts()
        logits, _ = decode_step(params, cfg, tok[:, None], p + i, twin, fused_mlp=fused)
        if i == 0:
            one_step = launch_counts()
        tok = torch.argmax(logits, -1)
        eager.append(tok)
    del twin
    reset_launch_counts()
    toks, caches = decode_loop(params, cfg, first, p, caches, n, fused_mlp=fused)
    counts = launch_counts()
    equal = bool(torch.equal(toks, torch.stack(eager, dim=1)))
    first_diff = None if equal else int((toks != torch.stack(eager, dim=1)).any(0).nonzero()[0])
    check(equal, f"the replayed decode_loop's tokens differ from eager decode_step's from "
                 f"token {first_diff}")
    want = {k: (n - 1) * v for k, v in one_step.items()}
    check(counts == want, f"launches of the replayed decode_loop {counts}, want (n - 1) x one "
                          f"eager step's {want}")
    launches = sum(one_step.values())
    print(f"  decode_loop replayed: {n} greedy tokens bit-equal to eager decode_step's; "
          f"{launches} kernel-wrapper launches a step, replayed and eager alike")
    return dict(tokens=n, equal=equal, wrapper_launches_per_step=launches)


def generate_paths(params, cfg, dev, gen, configs: dict, requests=REQUESTS,
                   check_prompt: int | None = None) -> dict:
    """Each path of `configs` ({path: (KV dtype, fused MLP)}), e.g. the
    generate path (bf16 KV, unfused MLP) and bench.py's decode
    configuration (int8 KV, fused MLP), checked against the plain path and
    driven through the same `requests` ((batch, prompt tokens, new tokens),
    the first of them checked and timed), and timed side by side.
    check_prompt: the check against the plain path runs on the first this
    many tokens of the first request's prompt (the plain group-wise product
    holds a [rows, groups, N] f32 tensor: at llama2-70b's gate|up and 1024
    rows, 15 GB beside the model)."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.modules.linear import QuantLinear
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step, generate, prefill

    prompts = [torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=dev)
               for b, p, _ in requests]
    (_, p1, n1), prompt1 = requests[0], prompts[0]
    cp = check_prompt or p1
    out = {}
    for path, (kv, fused) in configs.items():
        print(f"  -- {path}: {kv} KV, fused MLP {fused}")
        # kernel path against the plain path: prefill, then one decode step
        # (the decode step takes the kernel path's token); the plain path
        # replays the kernel path's routing
        logits, first, routes, step_counts = {}, {}, [], {}

        def check_run(use, kv=kv, fused=fused):
            caches = init_caches(cfg, 1, cp + n1, device=dev, dtype=kv)
            lp, caches = prefill(params, cfg, prompt1[:, :cp], caches, use_kernels=use)
            tok = first.get(True, torch.argmax(lp, -1))
            reset_launch_counts()
            ld, _ = decode_step(params, cfg, tok[:, None], cp, caches, use_kernels=use,
                                fused_mlp=fused)
            if use:
                step_counts.update(launch_counts())
            return (lp, ld), torch.argmax(lp, -1)

        for use in (True, False):
            with routing("record" if use else "replay", routes):
                logits[use], first[use] = check_run(use)
        at = "" if cp == p1 else f" at p={cp}"
        checks = {name: check_logits(f"{path} {name}{at}", logits[True][i], logits[False][i])
                  for i, name in enumerate(("prefill", "decode"))}
        checks["check_prompt"] = cp
        if cp != p1:  # the first token of the full prompt, for the check below
            lp, _ = prefill(params, cfg, prompt1, init_caches(cfg, 1, p1, device=dev, dtype=kv))
            first[True] = torch.argmax(lp, -1)
        # GEMV launches of one b=1 decode step, as before the tensor-core GEMV:
        # qkv and o per layer, the MLP's two projections (the fused MLP or a MoE
        # layer's expert gathers: one wrapper call each), and the lm_head
        gemv_step = sum(step_counts[k] for k in GEMV_FAMILY)
        want = (cfg.num_layers * (2 + (1 if fused and not cfg.num_experts else 2))
                + isinstance(params.lm_head, QuantLinear))
        print(f"  {path}: {gemv_step} GEMV launches in one decode step (want {want})")
        check(gemv_step == want, f"{path}: {gemv_step} GEMV launches a decode step, want {want}")
        checks["gemv_launches_per_step"] = gemv_step
        checks["graph"] = graph_against_eager(params, cfg, dev, prompt1, n1, kv, fused)
        if routes:
            checks["routing"] = routing_differences(lambda: check_run(False), routes)
            print(f"  {path}: {checks['routing']['differ']} of {checks['routing']['routings']} "
                  "routings differ when the plain path routes for itself (not replayed)")

        def serve(kv=kv, fused=fused):
            outs, ms = [], []
            for (b, p, n), prompt in zip(requests, prompts):
                t0 = time.perf_counter()
                caches = init_caches(cfg, b, p + n, device=dev, dtype=kv)
                lp, caches = prefill(params, cfg, prompt, caches)
                toks, caches = decode_loop(params, cfg, torch.argmax(lp, -1), p, caches, n,
                                           fused_mlp=fused)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                outs.append(toks)
            return outs, ms

        (outs, gen_ms), counts = counted(path, serve)
        for (b, p, n), toks, ms in zip(requests, outs, gen_ms):
            print(f"  {path} b={b} p={p} n={n}: {ms:.1f} ms")
            check(tuple(toks.shape) == (b, n), f"{path} returned {tuple(toks.shape)}, want {(b, n)}")
            check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "tokens out of range")
        check(int(outs[0][0, 0]) == int(first[True][0]), f"{path}: first token is not prefill's argmax")
        if path in ("generate", "int4_generate"):  # the entry point itself, once
            g = generate(params, cfg, prompt1, 2)
            check(bool((g[:, 0] == outs[0][:, 0]).all()), "generate disagrees with prefill")
        out[path] = dict(checks=checks, counts=counts, generate_ms=gen_ms)

    # the two stages of the first request, timed apart, the paths in turns;
    # decode_loop's own graph records say what its eager warm-up step and its
    # capture took, and the rest is n1 - 2 replays
    runs = {path: dict(prefill_ms=[], decode_ms=[], replay_ms=[], warm_ms=[], capture_ms=[])
            for path in configs}
    for _ in range(3):
        for path, (kv, fused) in configs.items():
            caches = init_caches(cfg, 1, p1 + n1, device=dev, dtype=kv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lp, caches = prefill(params, cfg, prompt1, caches)
            tok = torch.argmax(lp, -1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec = {}
            decode_loop(params, cfg, tok, p1, caches, n1, fused_mlp=fused, stats=rec)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            r = runs[path]
            r["prefill_ms"].append(1e3 * (t1 - t0))
            r["decode_ms"].append(1e3 * (t2 - t1) / (n1 - 1))
            r["warm_ms"].append(rec["warm_ms"])
            r["capture_ms"].append(rec["capture_ms"])
            r["replay_ms"].append((1e3 * (t2 - t1) - rec["warm_ms"] - rec["capture_ms"])
                                  / (n1 - 2))
            del caches
    for path, r in runs.items():
        med = {key: statistics.median(v) for key, v in r.items()}
        out[path]["timing"] = dict(
            prefill_ms=med["prefill_ms"], decode_ms_per_step=med["decode_ms"],
            decode_tok_s=1e3 / med["decode_ms"], replay_ms_per_step=med["replay_ms"],
            warm_ms=med["warm_ms"], capture_ms=med["capture_ms"], prefill_ms_runs=r["prefill_ms"],
            decode_ms_per_step_runs=r["decode_ms"], replay_ms_per_step_runs=r["replay_ms"])
        print(f"  {path} b=1 p={p1}: prefill {med['prefill_ms']:.2f} ms, decode "
              f"{med['decode_ms']:.3f} ms/step = {1e3 / med['decode_ms']:.2f} tok/s over "
              f"{n1 - 1} steps (runs {['%.3f' % v for v in r['decode_ms']]}); of it the eager "
              f"warm-up step {med['warm_ms']:.2f} ms, the capture {med['capture_ms']:.2f} ms, "
              f"then {med['replay_ms']:.3f} ms a replayed step")
    return out


def _post(port: int, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_TIMEOUT_S)
    try:
        conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    check(r.status == 200, f"/generate answered {r.status}: {data[:200]!r}")
    if body.get("stream"):
        events = [json.loads(line[len(b"data: "):]) for line in data.split(b"\n\n")
                  if line.startswith(b"data: ")]
        check(bool(events) and events[-1]["done"], "stream did not end with done")
        return [t for ev in events for t in ev["tokens"]]
    return json.loads(data)["tokens"]


def engine_step_check(eng, cfg, dev, gen, path: str, prompts=STEP_PROMPTS,
                      budget: int = STEP_BUDGET) -> dict:
    """Fill the engine's slots with prompts of these lengths, then
    run the forward of its next decode step twice on the same caches, with
    the kernels and with the plain versions (the step's writes are the same
    both times), and hold the logits of the busy slots against each other.
    A speculative engine runs a verify round instead: each slot's token and
    k random drafts. The requests are then run to their end."""
    import numpy as np
    import torch

    from eetq_tpu_torch.models.transformer import forward_inner

    for n in prompts[:eng.max_batch]:
        ids = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist()
        eng.add_request(ids, max_new_tokens=budget)
    # one admission each, with a window-1 step while the queue holds more and
    # a chain of windows after the last (shorter than every budget)
    while eng.queue:
        eng.step()
    active = [i for i, r in enumerate(eng.slot_req) if r is not None]
    check(len(active) == eng.max_batch, f"{path}: {len(active)} slots busy before the step check")
    k = eng.spec_ngram or 0
    if eng.paged:  # as Engine._decode does before its forward
        for i in active:
            eng._alloc_blocks(i, int(eng.lengths[i]) + k + 1)
        eng._sync_tables()
    lengths = torch.as_tensor(np.maximum(eng.lengths, 1), device=dev)
    tokens = torch.as_tensor(eng.next_token[:, None], device=dev)
    if k:
        drafts = torch.randint(0, cfg.vocab_size, (eng.max_batch, k), generator=gen, device=dev)
        tokens = torch.cat([tokens, drafts], dim=1)
    positions = lengths[:, None] + torch.arange(k + 1, device=dev)
    logits, routes = {}, []
    for use in (True, False):  # the plain path replays the kernel path's routing
        with routing("record" if use else "replay", routes), torch.inference_mode():
            lg, _ = forward_inner(eng.params, cfg, tokens, positions, eng.caches, lengths,
                                  use_kernels=use, verify=k > 0)
        logits[use] = lg if k else lg[:, -1]
    what = f"verify round (S = {k + 1})" if k else "step"
    out = check_logits(f"{path} engine {what} ({len(active)} slots, lengths "
                       f"{sorted(int(v) for v in eng.lengths)})", logits[True], logits[False])
    eng.run()
    return out


def server_path(params, cfg, dev, gen, path: str = "server", engine_kw: dict | None = None,
                twin_kw: dict | None = None, long: tuple = (),
                step_prompts: tuple = STEP_PROMPTS, admission: bool = True,
                step_budget: int | None = None,
                admission_prompt: int = ADMISSION_PROMPT,
                twin_layers: int | None = None) -> dict:
    """The engine behind its HTTP server: with its accelerator defaults
    (window 8, chained; max_batch 8, max_len 2048), or with `engine_kw` (a
    paged pool, another max_len and prompt buckets). twin_kw: the greedy
    requests also go through an engine built with these keywords instead
    (window 1; a dense bf16 cache for a paged engine), whose tokens must be
    equal. long: (prompt tokens, budget) of greedy requests sent beside the
    server mix; step_prompts: the prompts of a paged engine's step check;
    admission=False skips the admission's check against the plain path (a
    spec engine admits as the engine of another path, checked there); a MoE
    model's twin runs with the routing replayed (`routed_twin`);
    step_budget: the budget of the step check's requests, which a dense
    engine runs too where it is given (a paged engine's default:
    STEP_BUDGET); admission_prompt: the tokens of the checked admission
    (its bucket the rows of the plain forward); twin_layers: a MoE model's
    twin check runs on its first this many layers (the same weights)."""
    import torch

    from eetq_tpu_torch.models.transformer import forward_inner, init_caches
    from eetq_tpu_torch.serve.api import EngineServer
    from eetq_tpu_torch.serve.engine import Engine

    engine_kw = dict(dict(max_batch=8, max_len=2048), **(engine_kw or {}))
    paged = "paged_blocks" in engine_kw
    spec = engine_kw.get("spec_ngram")
    held = torch.cuda.memory_allocated()
    eng = Engine(params, cfg, **engine_kw)
    cache_gb = (torch.cuda.memory_allocated() - held) / 1e9
    # the CUDA defaults: W8A8 prefill; an int8 dense cache, a bf16 pool
    want_kv = engine_kw.get("kv_dtype", torch.bfloat16 if paged else torch.int8)
    a8 = engine_kw.get("a8_prefill", True)
    check(eng.a8_prefill == a8 and eng.kv_dtype == want_kv and eng.paged == paged
          and eng.decode_window == 8 and eng.max_chain == 8,
          f"{path} engine on CUDA: a8_prefill {eng.a8_prefill}, kv {eng.kv_dtype}, "
          f"paged {eng.paged}, window {eng.decode_window}, chain {eng.max_chain}")
    shape = (f"a pool of {engine_kw['paged_blocks']} blocks of {eng.paged_bs}" if paged
             else f"dense 8 x {eng.caches[0].max_len}")
    print(f"  {path}: KV cache of the engine {cache_gb:.2f} GB ({eng.kv_dtype}, {shape})")
    # the traffic below has sampled requests: warm the sampled programs too
    t0 = time.perf_counter()
    eng.warmup()
    eng.warmup(temperature=0.8)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    graphs = {(w, smp, False): g for (w, smp), (g, _) in eng._programs.items()}
    graphs.update({(w, smp, True): prog.graph for (w, smp), prog in eng._spec_programs.items()})
    captures = [dict(window=w, sampled=smp, spec=sp, warm_ms=g.warm_ms, capture_ms=g.capture_ms)
                for (w, smp, sp), g in graphs.items()]
    # a speculative engine's windows above 1 and sampled windows are spec windows
    want = {(w, smp, bool(spec) and (w > 1 or smp)) for w in (1, 8) for smp in (False, True)}
    check(all(g.captured for g in graphs.values()) and set(graphs) == want,
          f"{path}: warmup() left programs uncaptured: {sorted(graphs)}")
    print(f"  {path}: warmup {warmup_s:.1f} s; captures of the greedy and sampled window-1 and "
          f"window-8 programs (spec: {sorted(k for k in graphs if k[2])}) "
          f"{['%.1f ms' % c['capture_ms'] for c in captures]}")

    # one admission's forward, with kernels and with the plain versions: a
    # prompt right-padded to its bucket, as _prefill_group runs it
    n = admission_prompt
    bucket = eng._bucket_for(n)
    toks = torch.zeros(1, bucket, dtype=torch.long, device=dev)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev)
    pos = torch.arange(bucket, device=dev)[None]
    last = torch.tensor([n - 1], device=dev)
    logits, routes = {}, []

    def admit(use):
        with torch.inference_mode():
            scratch = init_caches(cfg, 1, bucket, dev, eng.kv_dtype)
            lg, _ = forward_inner(params, cfg, toks, pos, scratch, 0, use_kernels=use, a8=a8,
                                  last_pos=last)
        return lg[:, -1]

    for use in (True, False) if admission else ():  # the plain path replays the kernel's routing
        with routing("record" if use else "replay", routes):
            logits[use] = admit(use)
    if admission:
        admission = check_logits(f"{path} admission ({'a8' if a8 else 'w8a16'})", logits[True],
                                 logits[False], A8_MODEL_TOL if a8 else MODEL_TOL)
    if routes:
        admission["routing"] = routing_differences(lambda: admit(False), routes)
        print(f"  {path} admission: {admission['routing']['differ']} of "
              f"{admission['routing']['routings']} routings differ when not replayed")
    step = (engine_step_check(eng, cfg, dev, gen, path, step_prompts,
                              step_budget or STEP_BUDGET)
            if paged or step_budget else None)
    spec_before = (eng.spec_rounds, eng.spec_tokens)

    lengths = [SERVE_LENGTHS[i] for i in torch.randint(
        0, len(SERVE_LENGTHS), (SERVE_REQUESTS,), generator=gen, device=dev).tolist()]
    budgets = [SERVE_BUDGETS[i] for i in torch.randint(
        0, len(SERVE_BUDGETS), (SERVE_REQUESTS,), generator=gen, device=dev).tolist()]
    bodies = []
    for i, (p, b) in enumerate(zip(lengths, budgets)):
        ids = torch.randint(0, cfg.vocab_size, (p,), generator=gen, device=dev).tolist()
        body = {"prompt": ids, "max_new_tokens": b, "stream": i % 5 == 1}
        if i in (3, 8):  # two sampled requests
            body.update(temperature=0.8, top_k=40)
        bodies.append(body)
    for p, b in long:
        lengths.append(p)
        budgets.append(b)
        bodies.append({"prompt": torch.randint(0, cfg.vocab_size, (p,), generator=gen,
                                               device=dev).tolist(), "max_new_tokens": b})
    n_req = len(bodies)

    srv = EngineServer(eng, host="127.0.0.1", port=0)
    srv.start()
    results, latency, errors = {}, {}, []

    def worker(idx):
        for i in idx:
            t = time.perf_counter()
            try:
                results[i] = _post(srv.port, bodies[i])
            except Exception as e:  # reported below, fails the run
                errors.append(f"request {i}: {e!r}")
                return
            latency[i] = 1e3 * (time.perf_counter() - t)

    def serve():
        threads = [threading.Thread(target=worker, args=(range(j, n_req, SERVE_THREADS),))
                   for j in range(SERVE_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        return time.perf_counter() - t

    try:
        wall_s, counts = counted(path, serve)
    finally:
        srv.shutdown()
    check(not errors, f"HTTP requests failed: {errors}")
    check(len(results) == n_req, f"{len(results)} of {n_req} requests answered")
    for i, body in enumerate(bodies):
        got = results[i]
        check(len(got) == body["max_new_tokens"],
              f"request {i}: {len(got)} tokens, want {body['max_new_tokens']}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"request {i}: token out of range")
    if paged:
        kernel = "paged_flash_decode_int8" if eng.caches[0].quantized else "paged_flash_decode"
        check(counts[kernel] % cfg.num_layers == 0,
              f"{path}: {counts[kernel]} launches of {kernel} are not {cfg.num_layers} a step")
        print(f"  {path}: {counts[kernel] // cfg.num_layers} decode steps, {cfg.num_layers} "
              f"launches of {kernel} each")
        check(sorted(eng._free_blocks) == list(range(1, engine_kw["paged_blocks"]))
              and not any(eng._slot_blocks) and not eng._table_np.any(),
              f"{path}: blocks still held after the run: {eng._slot_blocks}")
    spec_run = None
    if spec:
        rounds, toks = (a - b for a, b in zip((eng.spec_rounds, eng.spec_tokens), spec_before))
        spec_run = dict(rounds=rounds, tokens=toks, tokens_per_round=toks / max(rounds, 1))
        print(f"  {path}: {rounds} speculative rounds committed {toks} tokens "
              f"({toks / max(rounds, 1):.2f} a round, k = {spec})")
    twin = None
    if twin_kw is not None and cfg.num_experts:
        cut, tcfg = params, cfg
        if twin_layers:
            from eetq_tpu_torch.models.transformer import ModelParams

            cut = ModelParams(params.embed, list(params.layers[:twin_layers]), params.final_norm,
                              params.lm_head)
            tcfg = dataclasses.replace(cfg, num_layers=twin_layers)
        twin = routed_twin(cut, tcfg, dev, path, bodies, engine_kw, twin_kw)
    elif twin_kw is not None:
        # the same kernels, the same chunks of the key range, rows that do not
        # see each other: the same greedy tokens at any window and chain, and
        # through the paged address map or the dense one. A speculative
        # engine's verify at 8 slots is m = 64 rows, the GEMM where its twin
        # runs the GEMV: where a request first differs, the twin's tokens up
        # to there must leave both tokens in a near tie with the top logit
        # (SPEC_TIE_ULPS, on the kernel path)
        greedy = [i for i, body in enumerate(bodies) if "temperature" not in body]
        held = torch.cuda.memory_allocated()
        sizes = {k: v for k, v in engine_kw.items()
                 if k in ("max_batch", "max_len", "prompt_buckets")}
        te = Engine(params, cfg, **dict(sizes, **twin_kw))
        twin_gb = (torch.cuda.memory_allocated() - held) / 1e9
        uids = {i: te.add_request(bodies[i]["prompt"], bodies[i]["max_new_tokens"])
                for i in greedy}
        te.run()
        ties = []
        for i in greedy:
            want = te.result(uids[i])
            first = next((j for j, (a, b) in enumerate(zip(results[i], want)) if a != b), None)
            if first is None:
                continue
            print(f"  {path} request {i} (prompt {lengths[i]}): token {first} is "
                  f"{results[i][first]}, the twin's {want[first]}")
            check(bool(spec), f"{path}: request {i} differs from the twin engine {twin_kw}")
            tie = near_tie(params, cfg, dev, bodies[i]["prompt"] + want[:first],
                           results[i][first], want[first])
            print(f"  {'':20s} logits there: top three {tie['top_ids']} at {tie['top']}; the "
                  f"spec engine's token {tie['spec_logit']:.6f} (rank {tie['spec_rank']}), the "
                  f"twin's {tie['twin_logit']:.6f} (rank {tie['twin_rank']}); "
                  f"{tie['ulps']:.2f} bf16 ulps of the largest |logit| {tie['largest']:.6f} "
                  f"below the top (near tie: {tie['ok']})")
            check(tie["ok"], f"{path}: request {i} differs from the twin engine {twin_kw} at "
                             f"token {first}, not at a near tie of the two tokens")
            ties.append(dict(request=i, token=first, **tie))
        twin = dict(requests=len(greedy), equal=not ties, near_ties=ties, cache_gb=twin_gb,
                    engine=str(twin_kw))
        print(f"  {path}: {len(greedy)} greedy requests against a twin engine {twin_kw} "
              f"(its cache: {twin_gb:.2f} GB): {len(greedy) - len(ties)} equal, {len(ties)} "
              f"diverge at a near tie")
        del te
    tokens = sum(budgets)
    lat = [latency[i] for i in range(n_req)]
    print(f"  {path}: {n_req} requests, prompts {lengths}, budgets {budgets}; "
          f"{tokens} tokens in {wall_s:.2f} s = {tokens / wall_s:.2f} tok/s served "
          f"(warmup {warmup_s:.1f} s)")
    print(f"  {path} latencies (ms): {['%.1f' % v for v in lat]}")
    return dict(admission=admission, counts=counts, prompt_lengths=lengths, budgets=budgets,
                tokens=tokens, wall_s=wall_s, served_tok_s=tokens / wall_s,
                latency_ms=lat, warmup_s=warmup_s, captures=captures, cache_gb=cache_gb,
                engine_step=step, twin=twin, spec=spec_run)


def replay_rows(topw, topi, keys: list, layer: int, table: dict, stats: dict):
    """(weights, ids) of one route call with every row whose (layer, key) is
    in `table` replaced by the recorded routing; counts in `stats` the rows
    replayed, those whose own routing differed, and those not found."""
    import torch

    rows = [r for r, key in enumerate(keys) if key is not None and (layer, key) in table]
    stats["missing"] = stats.get("missing", 0) + sum(k is not None for k in keys) - len(rows)
    if not rows:
        return topw, topi
    idx = torch.tensor(rows, device=topi.device)
    w = torch.stack([table[(layer, keys[r])][0] for r in rows]).to(topw.device)
    i = torch.stack([table[(layer, keys[r])][1] for r in rows]).to(topi.device)
    stats["replayed"] += len(rows)
    stats["differed"] += int((topi[idx].sort(-1).values != i.sort(-1).values).any(-1).sum())
    topw, topi = topw.clone(), topi.clone()
    topw[idx], topi[idx] = w, i
    return topw, topi


def replayed_tie(params, cfg, dev, table: dict, prompt: list, ids: list, spec_tok: int,
                 twin_tok: int) -> dict:
    """`near_tie` over ids (prompt + the common output) with the twin's
    recorded routing replayed at every row (keyed as `keyed_routing` keys
    them), so that the forward judging the tie routes as both engines did."""
    from eetq_tpu_torch.modules import moe

    pid = hash(tuple(prompt))
    keys = [(pid, r, t) for r, t in enumerate(ids)]
    route, layer, stats = moe.route, [0], dict(replayed=0, differed=0)

    def replay(router, x2, top_k):
        topw, topi = route(router, x2, top_k)
        layer[0] += 1
        return replay_rows(topw, topi, keys, layer[0] - 1, table, stats)

    moe.route = replay
    try:
        tie = near_tie(params, cfg, dev, ids, spec_tok, twin_tok)
    finally:
        moe.route = route
    return dict(tie, routing=stats)


@contextlib.contextmanager
def keyed_routing(engine, table: dict, mode: str, stats: dict):
    """Route an engine's forwards by token, not by call: each row of a
    forward is keyed (its request's prompt, its position, its input token),
    and a route call's rows keyed (layer, row key). mode "record" stores
    every keyed row's (weights, ids) in `table`; "replay" hands back the
    stored routing of every row whose key is there and counts in `stats` the
    rows replayed and those whose own routing differed. Before a request's
    first differing token, rows of equal keys have equal prefixes in both
    engines, so a replay gives the spec engine its twin's experts there. The
    engine's programs run eagerly meanwhile (a captured graph runs no
    Python)."""
    import torch

    from eetq_tpu_torch.modules import moe
    from eetq_tpu_torch.serve import engine as engine_mod
    from eetq_tpu_torch.serve import graph as graph_mod
    from eetq_tpu_torch.serve import spec as spec_mod

    ctx = dict(keys=None, layer=0, rows=None, prompts={})
    route, fwd, graphs = moe.route, engine_mod.forward_inner, (engine_mod.StepGraph,
                                                               spec_mod.StepGraph)
    prefill_group = engine._prefill_group

    def keyed_forward(params, cfg, tokens, positions, *args, **kw):
        b, sq = tokens.shape
        reqs = ctx["rows"] or engine.slot_req
        toks, pos = tokens.tolist(), positions.tolist()
        # a request by its prompt (both engines get the same prompts)
        ids = [None if r is None else ctx["prompts"].setdefault(id(r), hash(tuple(r.prompt)))
               for r in reqs]
        ctx["keys"] = [None if ids[i] is None else (ids[i], pos[i][j], toks[i][j])
                       for i in range(b) for j in range(sq)]
        ctx["layer"] = 0
        try:
            return fwd(params, cfg, tokens, positions, *args, **kw)
        finally:
            ctx["keys"] = None

    def keyed_route(router, x2, top_k):
        topw, topi = route(router, x2, top_k)
        keys, layer = ctx["keys"], ctx["layer"]
        ctx["layer"] += 1
        if keys is None:
            return topw, topi
        check(len(keys) == x2.shape[0], "keyed routing: rows and keys differ")
        if mode == "record":
            w, i = topw.cpu(), topi.cpu()
            for r, key in enumerate(keys):
                if key is not None:
                    table[(layer, key)] = (w[r], i[r])
            return topw, topi
        return replay_rows(topw, topi, keys, layer, table, stats)

    def rows_of(assignments):
        ctx["rows"] = {row: req for row, _, req in assignments}
        ctx["rows"] = [ctx["rows"].get(r) for r in range(engine.prefill_rows)]
        try:
            return prefill_group(assignments)
        finally:
            ctx["rows"] = None

    def eager(fn, device, eager=False):
        return graph_mod.StepGraph(fn, device, eager=True)

    moe.route, engine._prefill_group = keyed_route, rows_of
    engine_mod.forward_inner = spec_mod.forward_inner = keyed_forward
    engine_mod.StepGraph = spec_mod.StepGraph = eager
    try:
        yield
    finally:
        moe.route = route
        del engine._prefill_group
        engine_mod.forward_inner = spec_mod.forward_inner = fwd
        engine_mod.StepGraph, spec_mod.StepGraph = graphs


def routed_twin(params, cfg, dev, path: str, bodies: list, engine_kw: dict,
                twin_kw: dict) -> dict:
    """A MoE spec engine against its non-spec twin with the routing replayed
    (`keyed_routing`): the greedy requests in a fixed order through the twin
    (recording each token's routing at every layer), then through a fresh
    engine of the path's keywords (replaying it where the keys agree), both
    eager. Every request must be equal, or first differ at a near tie of the
    two tokens' logits (SPEC_TIE_ULPS) by one forward over the common prefix
    with the twin's routing replayed too (`replayed_tie`): a routing tie is
    no longer a pass. Prints how many replayed rows would have routed
    otherwise."""
    import torch

    from eetq_tpu_torch.serve.engine import Engine

    greedy = [i for i, body in enumerate(bodies) if "temperature" not in body]
    sizes = {k: v for k, v in engine_kw.items() if k in ("max_batch", "max_len", "prompt_buckets")}
    table, stats, outs = {}, dict(replayed=0, differed=0, missing=0), {}
    t0 = time.perf_counter()
    for name, kw, mode in (("twin", dict(sizes, **twin_kw), "record"), (path, engine_kw, "replay")):
        eng = Engine(params, cfg, **kw)
        with keyed_routing(eng, table, mode, stats):
            uids = [eng.add_request(bodies[i]["prompt"], bodies[i]["max_new_tokens"])
                    for i in greedy]
            eng.run()
        outs[name] = [eng.result(u) for u in uids]
        del eng
        torch.cuda.empty_cache()
    ties = []
    for i, got, want in zip(greedy, outs[path], outs["twin"]):
        first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if first is None:
            continue
        ids = bodies[i]["prompt"] + want[:first]
        tie = replayed_tie(params, cfg, dev, table, bodies[i]["prompt"], ids, got[first],
                           want[first])
        free = near_tie(params, cfg, dev, ids, got[first], want[first])
        print(f"  {path} request {i} (routing replayed): token {first} is {got[first]}, the "
              f"twin's {want[first]}; by one forward with the twin's routing replayed "
              f"({tie['routing']}) the top three {tie['top_ids']} at {tie['top']}, the two "
              f"tokens {tie['spec_logit']:.6f} / {tie['twin_logit']:.6f}: {tie['ulps']:.2f} bf16 "
              f"ulps below the top (near tie: {tie['logit_tie']}; routing for itself: "
              f"{free['ulps']:.2f} ulps)")
        ties.append(dict(request=i, token=first, free_ulps=free["ulps"], **tie))
    bad = [t["request"] for t in ties if not t["logit_tie"]]
    check(not bad, f"{path}: requests {bad} differ from the twin with the routing replayed, not "
                   f"at a near tie of the logits")
    wall = time.perf_counter() - t0
    print(f"  {path}: {len(greedy)} greedy requests against the twin {twin_kw} with the routing "
          f"replayed ({len(table)} keyed routings recorded; {stats['replayed']} rows replayed, "
          f"{stats['differed']} of them would have routed otherwise): "
          f"{len(greedy) - len(ties)} equal, {len(ties)} part at a near tie of the logits "
          f"({wall:.1f} s, eager)")
    return dict(requests=len(greedy), equal=not ties, near_ties=ties, routing=stats,
                keyed=len(table), replayed=True, engine=str(twin_kw), wall_s=wall)


def text_tokenizer(vocab_size: int, seed: int):
    """A byte-level BPE `Tokenizer` of at most `vocab_size` ids: the 256 byte
    symbols, then the prefixes of seeded words (half of them after the
    byte-level space 'Ġ'), each prefix one merge, and one special token
    "<|end|>" as the last id; and the seeded words themselves."""
    import random

    from eetq_tpu_torch.serve.tokenizer import Tokenizer, _bytes_to_unicode

    rng = random.Random(seed)
    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges, words = [], []
    while len(vocab) < vocab_size - 1:
        word = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randint(2, 9)))
        words.append(word)
        symbol = ("Ġ" if rng.random() < 0.5 else "") + word
        for i in range(2 if symbol[0] == "Ġ" else 1, len(symbol)):
            if symbol[:i + 1] in vocab or len(vocab) == vocab_size - 1:
                continue
            merges.append(f"{symbol[:i]} {symbol[i]}")
            vocab[symbol[:i + 1]] = len(vocab)
    vocab["<|end|>"] = len(vocab)
    spec = {"model": {"type": "BPE", "vocab": vocab, "merges": merges},
            "added_tokens": [{"id": vocab["<|end|>"], "content": "<|end|>", "special": True}],
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
            "decoder": {"type": "ByteLevel"}}
    return Tokenizer(spec), words


def text_server_path(params, cfg, dev, gen) -> dict:
    """The default engine (W8A8 admission, int8 KV, window 8) behind a server
    holding a byte-level BPE tokenizer of cfg.vocab_size ids
    (`text_tokenizer`): TEXT_REQUESTS greedy text prompts from threads, one
    streamed. Each answer's tokens must equal those of the same prompt sent
    as ids, its "text" decode(tokens), the stream's text deltas concatenated
    its final text; a server without a tokenizer answers a text prompt 400."""
    import torch

    from eetq_tpu_torch.serve.api import EngineServer
    from eetq_tpu_torch.serve.engine import Engine

    tok, words = text_tokenizer(cfg.vocab_size, SEED + 20)
    check(tok.vocab_size <= cfg.vocab_size, f"tokenizer of {tok.vocab_size} ids")
    prompts = []
    for n_words, _, _ in TEXT_REQUESTS:
        picks = torch.randint(0, len(words), (n_words,), generator=gen, device=dev).tolist()
        prompts.append(" ".join(words[i] for i in picks) + ", héllo ☃ 42!")
    eng = Engine(params, cfg, max_batch=8, max_len=2048)
    eng.warmup()

    def serve(srv, bodies, raw: bool = False):
        results, errors = {}, []

        def worker(i):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=SERVE_TIMEOUT_S)
            try:
                conn.request("POST", "/v1/completions", json.dumps(bodies[i]),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                results[i] = (r.status, r.read())
            except Exception as e:  # reported below, fails the run
                errors.append(f"request {i}: {e!r}")
            finally:
                conn.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        check(not errors and len(results) == len(bodies), f"text requests failed: {errors}")
        return results

    text_bodies = [{"prompt": p, "max_new_tokens": n, "stream": st}
                   for p, (_, n, st) in zip(prompts, TEXT_REQUESTS)]
    id_bodies = [{"prompt": tok.encode(p), "max_new_tokens": n}
                 for p, (_, n, _) in zip(prompts, TEXT_REQUESTS)]
    srv = EngineServer(eng, host="127.0.0.1", port=0, tokenizer=tok)
    srv.start()
    try:
        t0 = time.perf_counter()
        answers, counts = counted("text_server", lambda: serve(srv, text_bodies))
        wall_s = time.perf_counter() - t0
        by_ids = serve(srv, id_bodies)
    finally:
        srv.shutdown()
    texts = []
    for i, body in enumerate(text_bodies):
        status, data = answers[i]
        check(status == 200, f"text request {i} answered {status}: {data[:200]!r}")
        if body["stream"]:
            events = [json.loads(line[len(b"data: "):]) for line in data.split(b"\n\n")
                      if line.startswith(b"data: ")]
            toks = [t for ev in events for t in ev["tokens"]]
            text = "".join(ev["text"] for ev in events)
            check(events[-1]["done"], f"text request {i}: the stream did not end")
        else:
            out = json.loads(data)
            toks, text = out["tokens"], out["text"]
        want = json.loads(by_ids[i][1])["tokens"]
        check(len(toks) == body["max_new_tokens"] and toks == want,
              f"text request {i}: tokens {toks} against {want} from the prompt as ids")
        check(text == tok.decode(toks), f"text request {i}: text {text!r} is not decode(tokens)")
        texts.append(text)
    srv = EngineServer(eng, host="127.0.0.1", port=0)
    srv.start()
    try:
        status, data = serve(srv, [{"prompt": prompts[0], "max_new_tokens": 4}])[0]
    finally:
        srv.shutdown()
    check(status == 400 and b"tokenizer" in data, f"a server without a tokenizer answered {status}")
    prompt_tokens = [len(b["prompt"]) for b in id_bodies]
    print(f"  text_server: a byte-level BPE of {tok.vocab_size} ids; {len(text_bodies)} text "
          f"prompts of {prompt_tokens} tokens ({sum(b['stream'] for b in text_bodies)} "
          f"streamed) answered in {wall_s:.2f} s, tokens equal to the prompts sent as ids, text "
          f"= decode(tokens), the stream's deltas its text; 400 without a tokenizer; first "
          f"answer {texts[0][:60]!r}")
    del eng
    torch.cuda.empty_cache()
    return dict(counts=counts, prompt_tokens=prompt_tokens, wall_s=wall_s,
                vocab=tok.vocab_size, texts=texts)


def near_tie(params, cfg, dev, ids: list[int], spec_tok: int, twin_tok: int) -> dict:
    """The next-token logits after `ids` by one forward on the kernel path:
    a near tie of spec_tok and twin_tok when each is at most SPEC_TIE_ULPS
    bf16 ulps of the largest |logit| below the top logit."""
    import math

    import torch

    from eetq_tpu_torch.models.transformer import forward_inner, init_caches

    toks = torch.tensor([ids], device=dev)
    with torch.inference_mode():
        caches = init_caches(cfg, 1, len(ids), device=dev)
        lg, _ = forward_inner(params, cfg, toks, torch.arange(len(ids), device=dev)[None],
                              caches, 0, last_only=True)
    row = lg[0, -1].float()
    top = row.topk(3)
    largest = float(row.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(largest)) - 7)  # bf16: 8 significant bits
    below = max(float(top.values[0] - row[spec_tok]), float(top.values[0] - row[twin_tok]))
    rank = lambda t: int((row > row[t]).sum()) + 1  # noqa: E731
    logit_tie = below <= SPEC_TIE_ULPS * ulp
    return dict(top_ids=[int(t) for t in top.indices], top=[float(v) for v in top.values],
                spec_logit=float(row[spec_tok]), twin_logit=float(row[twin_tok]),
                spec_rank=rank(spec_tok), twin_rank=rank(twin_tok), below=below,
                largest=largest, ulps=below / ulp, logit_tie=logit_tie, ok=logit_tie)


def spec_paths(params, cfg, dev, gen) -> dict:
    """Speculative decoding at b=1 on MODEL: `ngram_spec_generate` (k =
    SPEC_K) with bf16 KV and with bench.py's int8 KV + fused MLP, and
    `spec_generate` with the target's first SPEC_DRAFT_LAYERS layers and its
    head as the draft. The prompt is a seeded SPEC_BASE-token sequence tiled
    to REQUESTS[0]'s length, so the n-gram matcher has history to match.
    Greedy tokens must be bit-equal to `decode_loop`'s on the same prompt
    and cache dtype. Timed against decode_loop in turns (medians of 3):
    rounds, accepted drafts, ms per emitted token and per replayed round,
    the warm-up round and the capture."""
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve import spec
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    _, p, n = REQUESTS[0]
    k = SPEC_K
    base = torch.randint(0, cfg.vocab_size, (1, SPEC_BASE), generator=gen, device=dev)
    prompt = base.repeat(1, p // SPEC_BASE)
    draft, dcfg = spec.truncated_draft(params, cfg, SPEC_DRAFT_LAYERS)

    def timed(loop, kv, with_draft=False):
        """(tokens, stats with the loop's wall ms) of one decode after a
        prefill into fresh caches."""
        caches = init_caches(cfg, 1, p + n + 2 * k + 1, device=dev, dtype=kv)
        lp, caches = prefill(params, cfg, prompt, caches)
        extra = ()
        if with_draft:
            d_caches = init_caches(dcfg, 1, p + n + 2 * k + 1, device=dev, dtype=kv)
            _, d_caches = prefill(draft, dcfg, prompt, d_caches)
            extra = (d_caches,)
        rec = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = loop(torch.argmax(lp, -1), caches, *extra, rec)
        torch.cuda.synchronize()
        rec["ms"] = 1e3 * (time.perf_counter() - t0)
        return toks, rec

    def plain(fused):
        return lambda first, caches, rec: decode_loop(params, cfg, first, p, caches, n,
                                                      fused_mlp=fused, stats=rec)[0]

    def ngram(fused):
        return lambda first, caches, rec: spec.ngram_spec_decode_loop(
            params, cfg, prompt, first, p, caches, n, k=k, fused_mlp=fused, stats=rec)[0]

    def drafted(first, caches, d_caches, rec):
        return spec.spec_decode_loop(params, draft, cfg, dcfg, first, prompt[:, -1], p, caches,
                                     d_caches, n, k=k, stats=rec)[0]

    out = {}
    for path, kv, fused in (("ngram_spec", torch.bfloat16, False),
                            ("ngram_spec_bench", torch.int8, True),
                            ("draft_spec", torch.bfloat16, False)):
        print(f"  -- {path}: {kv} KV, fused MLP {fused}, k = {k}"
              + (f", a draft of {SPEC_DRAFT_LAYERS} layers" if path == "draft_spec" else ""))
        want, _ = timed(plain(fused), kv)
        if path == "draft_spec":
            run = lambda: spec.spec_generate(params, cfg, draft, dcfg, prompt, n, k=k,  # noqa: E731
                                             kv_dtype=kv, return_stats=True)
        else:
            run = lambda: spec.ngram_spec_generate(params, cfg, prompt, n, k=k, kv_dtype=kv,  # noqa: E731
                                                   fused_mlp=fused, return_stats=True)
        (got, stats), counts = counted(path, run)
        first = None if torch.equal(got, want) else int((got != want).any(0).nonzero()[0])
        check(first is None, f"{path}: greedy tokens differ from decode_loop's from token {first}")
        runs = {"decode": [], "spec": []}
        for _ in range(3):
            runs["decode"].append(timed(plain(fused), kv)[1])
            loop = drafted if path == "draft_spec" else ngram(fused)
            runs["spec"].append(timed(loop, kv, with_draft=path == "draft_spec")[1])
        check(all(r["rounds"] == stats["rounds"] for r in runs["spec"]),
              f"{path}: the rounds differ from run to run")
        rounds, acc = stats["rounds"], stats["accepted_drafts"]
        med = lambda rs, f: statistics.median(f(r) for r in rs)  # noqa: E731
        timing = dict(
            decode_ms_per_step=med(runs["decode"], lambda r: r["ms"] / (n - 1)),
            decode_replay_ms=med(runs["decode"], lambda r: (r["ms"] - r["warm_ms"]
                                                            - r["capture_ms"]) / (n - 2)),
            spec_ms_per_token=med(runs["spec"], lambda r: r["ms"] / (n - 1)),
            spec_replay_ms_per_round=med(runs["spec"], lambda r: (r["ms"] - r["warm_ms"]
                                                                   - r["capture_ms"])
                                         / max(rounds - 1, 1)),
            spec_warm_ms=med(runs["spec"], lambda r: r["warm_ms"]),
            spec_capture_ms=med(runs["spec"], lambda r: r["capture_ms"]),
            spec_ms_runs=[r["ms"] for r in runs["spec"]],
            decode_ms_runs=[r["ms"] for r in runs["decode"]])
        print(f"  {path} b=1 p={p} n={n}: {n} greedy tokens bit-equal to decode_loop's; "
              f"{rounds} rounds, {acc} drafts accepted ({acc / rounds:.2f} a round); "
              f"{timing['spec_ms_per_token']:.3f} ms an emitted token against decode_loop's "
              f"{timing['decode_ms_per_step']:.3f} ms/step; a replayed round "
              f"{timing['spec_replay_ms_per_round']:.3f} ms against a replayed step "
              f"{timing['decode_replay_ms']:.3f} ms; the warm-up round "
              f"{timing['spec_warm_ms']:.2f} ms, the capture {timing['spec_capture_ms']:.2f} ms")
        out[path] = dict(counts=counts, rounds=rounds, accepted_drafts=acc, timing=timing)
        if path == "draft_spec":
            out[path]["self_draft"] = self_draft(params, cfg, dev, prompt, want, kv)
    return out


def self_draft(params, cfg, dev, prompt, want, kv) -> dict:
    """spec_decode_loop with the target as its own draft, over caches of the
    length `want` (decode_loop's tokens) was decoded in: drafts are accepted,
    up to k + 1 tokens a round, so later rounds run the draft's 2-token
    catch-up over an accepted round's cache hole (a random truncated draft
    is rejected at every round on the card and never gets there). Not every
    draft need be: the first catch-up recomputes the prompt's last KV on the
    GEMV where the target's prefill used the GEMM, so a near tie in the
    draft may flip."""
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve import spec
    from eetq_tpu_torch.serve.generate import prefill

    _, p, n = REQUESTS[0]
    k = SPEC_K
    ns = 1 + 3 * (k + 1)
    full, fcfg = spec.truncated_draft(params, cfg, cfg.num_layers)
    caches, d_caches = (init_caches(cfg, 1, p + n + 2 * k + 1, device=dev, dtype=kv)
                        for _ in range(2))
    lp, caches = prefill(params, cfg, prompt, caches)
    _, d_caches = prefill(full, fcfg, prompt, d_caches)
    got, (r, acc) = spec.spec_decode_loop(params, full, cfg, fcfg, torch.argmax(lp, -1),
                                          prompt[:, -1], p, caches, d_caches, ns, k=k)
    check(torch.equal(got, want[:, :ns]),
          "draft_spec with the target as its draft: tokens differ from decode_loop's")
    check(acc >= 2 * k and r < ns - 1,
          f"draft_spec with the target as its draft: {r} rounds and {acc} accepted drafts, "
          f"want at least {2 * k}")
    print(f"  draft_spec, the target as its draft: {ns} tokens bit-equal to decode_loop's in "
          f"{r} rounds, {acc} of {r * k} drafts accepted")
    return dict(tokens=ns, rounds=r, accepted_drafts=acc)


def chunked_prefill_path(params, cfg, dev, gen, path: str, b: int, p: int, chunk: int, kv,
                         fused: bool, n: int = FAMILY_NEW_TOKENS, plain: bool = False) -> dict:
    """`prefill_chunked(chunk)` of a seeded [b, p] prompt into a `kv` cache,
    then `decode_loop` of n greedy tokens (fused MLP or not): every chunk's
    attention on the prefill kernel (p / chunk launches a layer), the
    last-token logits within MODEL_TOL of the largest logit of the unchunked
    prefill's on the same prompts (and, with `plain`, of the chunked plain
    path's), the path's launches counted, and the chunked prefill timed
    against the unchunked one in turns (medians of 3)."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, prefill, prefill_chunked

    prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=dev)
    print(f"  -- {path}: b={b} p={p} in chunks of {chunk}, {kv} KV, fused MLP {fused}")
    reset_launch_counts()
    lc, _ = prefill_chunked(params, cfg, prompt, init_caches(cfg, b, p, dev, kv), chunk=chunk)
    torch.cuda.synchronize()
    attn = launch_counts()["flash_attention_fwd"]
    check(attn == p // chunk * cfg.num_layers,
          f"{path}: {attn} prefill-attention launches, want {p // chunk} chunks x {cfg.num_layers}")
    lu, _ = prefill(params, cfg, prompt, init_caches(cfg, b, p, dev, kv))
    checks = dict(unchunked=check_logits(f"{path} chunked prefill against unchunked", lc, lu))
    if plain:
        lp, _ = prefill_chunked(params, cfg, prompt, init_caches(cfg, b, p, dev, kv), chunk=chunk,
                                use_kernels=False)
        checks["plain"] = check_logits(f"{path} chunked prefill", lc, lp)
    del lu

    def serve():
        caches = init_caches(cfg, b, p + n, dev, kv)
        lp, caches = prefill_chunked(params, cfg, prompt, caches, chunk=chunk)
        return decode_loop(params, cfg, torch.argmax(lp, -1), p, caches, n, fused_mlp=fused)[0]

    toks, counts = counted(path, serve)
    check(tuple(toks.shape) == (b, n) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{path} returned {tuple(toks.shape)} tokens, want {(b, n)} in the vocabulary")
    check(bool((toks[:, 0] == torch.argmax(lc, -1)).all()),
          f"{path}: the first tokens are not the chunked prefill's argmax")
    runs = dict(chunked_ms=[], unchunked_ms=[])
    for _ in range(3):
        for key, fn in (("unchunked_ms", lambda c: prefill(params, cfg, prompt, c)),
                        ("chunked_ms", lambda c: prefill_chunked(params, cfg, prompt, c,
                                                                 chunk=chunk))):
            caches = init_caches(cfg, b, p, dev, kv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(caches)
            torch.cuda.synchronize()
            runs[key].append(1e3 * (time.perf_counter() - t0))
            del caches
    med = {key: statistics.median(v) for key, v in runs.items()}
    print(f"  {path}: prefill of {b} x {p} tokens in {p // chunk} chunks {med['chunked_ms']:.2f} ms "
          f"against {med['unchunked_ms']:.2f} ms unchunked (runs {runs}); then {n} greedy tokens")
    return dict(checks=checks, counts=counts, chunks=p // chunk, timing=dict(med, runs=runs))


def family_ngram_path(params, cfg, dev, gen, path: str, k: int) -> dict:
    """`ngram_spec_generate(k)` at b=1 (bf16 KV) on a seeded SPEC_BASE-token
    sequence tiled to REQUESTS[0]'s prompt length: greedy tokens bit-equal
    to `greedy_generate`'s; rounds and accepted drafts, both timed once."""
    import torch

    from eetq_tpu_torch.serve import spec
    from eetq_tpu_torch.serve.generate import greedy_generate

    _, p, n = REQUESTS[0]
    base = torch.randint(0, cfg.vocab_size, (1, SPEC_BASE), generator=gen, device=dev)
    prompt = base.repeat(1, p // SPEC_BASE)
    want = greedy_generate(params, cfg, prompt, n)
    (got, stats), counts = counted(path, lambda: spec.ngram_spec_generate(
        params, cfg, prompt, n, k=k, return_stats=True))
    first = None if torch.equal(got, want) else int((got != want).any(0).nonzero()[0])
    check(first is None, f"{path}: greedy tokens differ from greedy_generate's from token {first}")
    ms = {}
    for name, fn in (("greedy_generate", lambda: greedy_generate(params, cfg, prompt, n)),
                     ("ngram_spec_generate", lambda: spec.ngram_spec_generate(
                         params, cfg, prompt, n, k=k))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
    rounds, acc = stats["rounds"], stats["accepted_drafts"]
    print(f"  {path} b=1 p={p} n={n} k={k}: {n} greedy tokens bit-equal to greedy_generate's; "
          f"{rounds} rounds, {acc} drafts accepted ({acc / rounds:.2f} a round); "
          f"{ms['ngram_spec_generate']:.1f} ms against {ms['greedy_generate']:.1f} ms (prefill "
          f"included, one run each)")
    return dict(counts=counts, rounds=rounds, accepted_drafts=acc, k=k, ms=ms)


def chunked_engine_path(params, cfg, dev, gen, path: str, engine_kw: dict) -> dict:
    """`Engine(prefill_chunk=CHUNKED_ENGINE_CHUNK)` over max_len
    CHUNKED_ENGINE_MAX_LEN with its CUDA window and W8A16 admissions, warmed
    up, driven step by step through CHUNKED_ENGINE_REQUESTS (submitted at
    once: six short prompts, two long ones, two short). A prompt whose bucket
    is larger than the chunk and a multiple of it (700 and 1024 tokens: two
    chunks; the long ones, bucket 4096: eight) takes one chunk a step; every
    chunk must run beside busy slots, each of which commits a token in the
    same step.
    The greedy outputs are held against the same engine without
    prefill_chunk: equal, or where a request first differs both tokens in a
    near tie (SPEC_TIE_ULPS) after the twin's tokens (an int8 cache holds a
    chunk's own keys quantized where unchunked prefill attends over them
    unquantized). A paged engine frees every block."""
    import torch

    from eetq_tpu_torch.serve.engine import Engine

    kw = dict(max_batch=8, max_len=CHUNKED_ENGINE_MAX_LEN, a8_prefill=False,
              prompt_buckets=(32, 128, 512, 1024, 2048, CHUNKED_ENGINE_MAX_LEN), **engine_kw)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist()
               for n, _ in CHUNKED_ENGINE_REQUESTS]
    budgets = [n for _, n in CHUNKED_ENGINE_REQUESTS]
    held = torch.cuda.memory_allocated()
    eng = Engine(params, cfg, prefill_chunk=CHUNKED_ENGINE_CHUNK, **kw)
    cache_gb = (torch.cuda.memory_allocated() - held) / 1e9
    check(eng.decode_window == 8 and not eng.a8_prefill, f"{path}: window {eng.decode_window}")
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    buckets = [eng._bucket_for(len(ids)) for ids in prompts]
    want_chunks = sum(b // CHUNKED_ENGINE_CHUNK for b in buckets
                      if b > CHUNKED_ENGINE_CHUNK and b % CHUNKED_ENGINE_CHUNK == 0)
    chunks = []  # (time, the request's uid) of every chunk
    run_chunk = eng._chunk_step
    eng._chunk_step = lambda: (chunks.append((time.perf_counter(), eng._chunking[0].uid)),
                               run_chunk())[1]
    stats = dict(steps=0, chunk_steps=0, advanced=0)

    prompt_of = {}  # uid: prompt tokens

    def serve():
        uids = [eng.add_request(ids, n) for ids, n in zip(prompts, budgets)]
        prompt_of.update((u, len(ids)) for u, ids in zip(uids, prompts))
        while eng.has_work:
            busy = [r for i, r in enumerate(eng.slot_req) if r is not None and eng.lengths[i] > 0]
            before, ran = [len(r.out_tokens) for r in busy], len(chunks)
            eng.step()
            stats["steps"] += 1
            if len(chunks) > ran and busy:  # a chunk beside decoding slots
                stats["chunk_steps"] += 1
                stats["advanced"] += all(len(r.out_tokens) > k for r, k in zip(busy, before))
        return [eng.result(u) for u in uids]

    t0 = time.perf_counter()
    outs, counts = counted(path, serve)
    wall_s = time.perf_counter() - t0
    check(len(chunks) == want_chunks, f"{path}: {len(chunks)} chunks, want {want_chunks}")
    check(stats["chunk_steps"] == want_chunks and stats["advanced"] == stats["chunk_steps"],
          f"{path}: busy slots advanced in {stats['advanced']} of {stats['chunk_steps']} chunk "
          f"steps ({want_chunks} chunks)")
    check(all(len(o) == n for o, n in zip(outs, budgets)), f"{path}: budgets not met")
    if eng.paged:
        check(sorted(eng._free_blocks) == list(range(1, engine_kw["paged_blocks"]))
              and not any(eng._slot_blocks), f"{path}: blocks still held after the run")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    twin = Engine(params, cfg, **kw)
    uids = [twin.add_request(ids, n) for ids, n in zip(prompts, budgets)]
    twin.run()
    ties = []
    for i, got in enumerate(outs):
        ref = twin.result(uids[i])
        first = next((j for j, (a, b_) in enumerate(zip(got, ref)) if a != b_), None)
        if first is None:
            continue
        tie = near_tie(params, cfg, dev, prompts[i] + ref[:first], got[first], ref[first])
        print(f"  {path} request {i} (prompt {len(prompts[i])}): token {first} is {got[first]}, "
              f"the unchunked engine's {ref[first]}: {tie['ulps']:.2f} bf16 ulps below the top "
              f"(near tie: {tie['ok']})")
        check(tie["ok"], f"{path}: request {i} differs from the unchunked engine at token {first}, "
                         "not at a near tie")
        ties.append(dict(request=i, token=first, **tie))
    del twin
    tokens = sum(budgets)
    # first to last chunk of each chunked prompt (ms), by its prompt length
    span = {}
    for t, uid in chunks:
        span.setdefault(uid, []).append(t)
    span = {prompt_of[uid]: 1e3 * (ts[-1] - ts[0]) for uid, ts in span.items()}
    print(f"  {path}: {len(prompts)} requests (prompts {[len(x) for x in prompts]}), {tokens} "
          f"tokens in {wall_s:.2f} s = {tokens / wall_s:.2f} tok/s ({stats['steps']} steps, "
          f"{len(chunks)} chunks of {CHUNKED_ENGINE_CHUNK}, busy slots advancing in all "
          f"{stats['chunk_steps']} chunk steps; first to last chunk by prompt length "
          f"{ {n: round(t, 1) for n, t in span.items()} } ms); cache {cache_gb:.2f} GB; warmup {warmup_s:.1f} s; "
          f"greedy outputs against the unchunked engine: {len(outs) - len(ties)} equal, "
          f"{len(ties)} part at a near tie")
    return dict(counts=counts, wall_s=wall_s, tokens=tokens, served_tok_s=tokens / wall_s,
                chunks=len(chunks), long_prefill_span_ms=span, cache_gb=cache_gb,
                warmup_s=warmup_s, twin=dict(equal=not ties, near_ties=ties), **stats)


PROFILE_ENGINE_BUDGET = 200  # two chains of 8 x 8 after the admissions


def _device_events(prof) -> tuple[float, int, int, int]:
    """(device-busy ms, kernel launches, flash-decode launches, host launch
    calls) of a torch.profiler run: the sum and the count of its kernel
    events (copies and memsets are busy time but no launches of a kernel),
    the count of those of `csrc/flash_decode.cu`, and the host's calls that
    launch a kernel or a graph (a graph replay is one call for all of its
    kernels)."""
    import torch

    busy_us, launches, decode, host = 0.0, 0, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host += "Launch" in ev.name and ev.name.startswith(("cuda", "cu"))
            continue
        busy_us += ev.time_range.elapsed_us()
        launches += not ev.name.startswith(("Memcpy", "Memset"))
        decode += "flash_decode" in ev.name
    return busy_us / 1e3, launches, decode, host


def _profiled(fn, steps: int | None, layers: int = 0) -> dict:
    """fn() under torch.profiler, per decode step: `steps` of them, or with
    steps None the flash-decode calls over `layers` (one call a layer a
    step). `decode_calls_per_step` counts the flash-decode wrappers' calls
    (their launch counters, exact: a replay adds its capture's counts), and
    `decode_launches_per_step` its kernel events (the profiler may drop a few
    events of a run, and never adds one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    calls = sum(launch_counts()[k] for k in DECODE_FAMILY)
    if steps is None:
        check(calls > 0 and calls % layers == 0, f"{calls} flash-decode calls over {layers} layers")
        steps = calls // layers
    busy_ms, launches, decode, host = _device_events(prof)
    check(busy_ms > 0, "the profiler saw no device time")
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps, busy_ms_per_step=busy_ms / steps,
                launches_per_step=launches / steps, decode_launches_per_step=decode / steps,
                decode_calls_per_step=calls / steps, host_launch_calls_per_step=host / steps,
                idle_share=1 - busy_ms / wall_ms)


def profile_paths(params, cfg, dev, gen, configs: dict, engines: dict) -> dict:
    """`--profile`: each path's first request under torch.profiler: one
    prefill, then its whole decode_loop (the eager warm-up step, the capture
    and the replays); and for each engine of `engines` ({path: Engine
    keywords}), after warmup() and the admissions, one scheduler step of the
    steady state with all 8 slots decoding: a chain of 8 windows of 8 steps.
    Every figure is per decode step. The profiler slows the host, so the
    wall time and the idle share are those of a profiled run."""
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.engine import Engine
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    _, p1, n1 = REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p1), generator=gen, device=dev)
    out = {}
    for path, (kv, fused) in configs.items():
        state = {}

        def run_prefill(kv=kv):
            state["caches"] = init_caches(cfg, 1, p1 + n1, device=dev, dtype=kv)
            lp, state["caches"] = prefill(params, cfg, prompt, state["caches"])
            state["tok"] = torch.argmax(lp, -1)

        run_prefill()  # warm
        out[path] = dict(prefill=_profiled(run_prefill, 1))
        # the first request's whole decode_loop: the eager warm-up step, the
        # capture and n1 - 2 replays, per step
        out[path]["decode"] = _profiled(
            lambda: decode_loop(params, cfg, state["tok"], p1, state["caches"], n1,
                                fused_mlp=fused), n1 - 1)
        del state
    for engine_path, engine_kw in engines.items():
        eng = Engine(params, cfg, max_batch=8, max_len=2048, **engine_kw)
        eng.warmup()
        for _ in range(8):
            ids = torch.randint(0, cfg.vocab_size, (100,), generator=gen, device=dev).tolist()
            eng.add_request(ids, max_new_tokens=PROFILE_ENGINE_BUDGET)
        while eng.queue:  # admissions (window 1), then a chain of 8 windows
            eng.step()
        # one scheduler step of the steady state: a chain of 8 windows of 8,
        # per decode step (the flash-decode's calls count them)
        out[engine_path] = dict(engine_step=_profiled(eng.step, None, cfg.num_layers))
        del eng
    for path, stages in out.items():
        for stage, r in stages.items():
            print(f"  profile {path} {stage}: device busy {r['busy_ms_per_step']:.3f} ms, "
                  f"{r['launches_per_step']:.1f} kernel events ({r['decode_launches_per_step']:.1f} "
                  f"of the flash-decode) from {r['host_launch_calls_per_step']:.1f} host launch "
                  f"calls, wall {r['wall_ms_per_step']:.2f} ms, idle share "
                  f"{r['idle_share']:.3f} (per step, {r['steps']} profiled)")
            # a decode step attends once a layer (the wrappers' counters), in
            # one launch a call (the profiler's flash-decode kernel events are
            # no more than the calls; it may drop an event, never add one)
            want = 0 if stage == "prefill" else cfg.num_layers
            seen = r["decode_launches_per_step"]
            check(r["decode_calls_per_step"] == want,
                  f"profile {path} {stage}: {r['decode_calls_per_step']} flash-decode calls "
                  f"a step, want {want} (one a layer)")
            check(seen <= want and (seen > 0) == (want > 0),
                  f"profile {path} {stage}: {seen} flash-decode launches a step for {want} "
                  "calls (one launch a call)")
    return out


def model_phase(dev, profile: bool = False) -> dict:
    """MODEL at full width and depth, W8A16, through the three paths."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params

    cfg = PRESETS[MODEL]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    dense = random_dense_params(cfg, gen)
    params = quantize_params(dense, quantize_lm_head=True)
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    weight_gb = sum(b.numel() * b.element_size() for b in params.buffers()) / 1e9
    print(f"  {MODEL} W8A16 built in {init_s:.1f} s, {weight_gb:.2f} GB on the card")
    configs = {"generate": (torch.bfloat16, False), "bench_decode": (torch.int8, True)}
    paths = generate_paths(params, cfg, dev, gen, configs)
    paths["bench_decode_chunked"] = chunked_prefill_path(
        params, cfg, dev, gen, "bench_decode_chunked", *BENCH_CHUNKED, torch.int8, True,
        n=REQUESTS[0][2], plain=True)
    paths["chunked_server"] = chunked_engine_path(params, cfg, dev, gen, "chunked_server", {})
    paths["chunked_paged_server"] = chunked_engine_path(
        params, cfg, dev, gen, "chunked_paged_server",
        dict(paged_blocks=CHUNKED_ENGINE_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE))
    paths["server"] = server_path(params, cfg, dev, gen, twin_kw=dict(decode_window=1))
    paths["text_server"] = text_server_path(params, cfg, dev,
                                            torch.Generator(device=dev).manual_seed(SEED + 20))
    paged = dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE)
    paths["paged_server"] = server_path(params, cfg, dev, gen, "paged_server", paged,
                                        twin_kw=dict(kv_dtype=torch.bfloat16, decode_window=1))
    paths.update(spec_paths(params, cfg, dev, gen))
    spec = dict(spec_ngram=SPEC_K)
    paths["spec_server"] = server_path(params, cfg, dev, gen, "spec_server", spec, twin_kw={})
    paths["spec_paged_server"] = server_path(params, cfg, dev, gen, "spec_paged_server",
                                             dict(paged, **spec), twin_kw=paged)
    prof = profile_paths(params, cfg, dev, gen, configs,
                         {"server": {}, "paged_server": paged}) if profile else None
    return dict(paths=paths, init_s=init_s, weight_gb=weight_gb, profile=prof,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def int4_phase(dev, profile: bool = False) -> dict:
    """MODEL at full width and depth with int4 weights, two models built
    one layer at a time: group-wise (INT4_GROUP rows, the lm_head too)
    through generate and the server, and `EETQ_BENCH_BITS=4 bench.py`'s
    (per-channel layers under an int8 lm_head) through its decode
    configuration."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params
    from eetq_tpu_torch.modules.linear import quantize_linear

    cfg = PRESETS[MODEL]
    out = dict(paths={}, models={}, profile={})

    def built(name, make):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = make(gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gb = sum(b.numel() * b.element_size() for b in params.buffers()) / 1e9
        print(f"  {MODEL} {name} built layer by layer in {build_s:.1f} s, {gb:.2f} GB on the card")
        out["models"][name] = dict(build_s=build_s, weight_gb=gb)
        return params, gen

    params, gen = built(f"W4A16 g={INT4_GROUP}", lambda g: random_quantized_params(
        cfg, g, quantize_lm_head=True, bits=4, group_size=INT4_GROUP))
    check(params.lm_head.bits == 4 and params.layers[0].down.scales.dim() == 2,
          "the group-wise int4 model is not int4 group-wise throughout")
    configs = {"int4_generate": (torch.bfloat16, False)}
    out["paths"].update(generate_paths(params, cfg, dev, gen, configs))
    out["paths"]["int4_server"] = server_path(params, cfg, dev, gen, "int4_server")
    if profile:
        out["profile"].update(profile_paths(params, cfg, dev, gen, configs, {"int4_server": {}}))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    def bench_model(g):
        p = random_quantized_params(cfg, g, bits=4)  # the lm_head comes out dense
        p.lm_head = quantize_linear(p.lm_head.weight)  # and is quantized at 8 bits
        return p

    params, gen = built("W4A16 per-channel, int8 lm_head", bench_model)
    check(params.lm_head.bits == 8 and params.layers[0].down.bits == 4
          and params.layers[0].down.scales.dim() == 1, "the bench model is not int4 under int8")
    configs = {"int4_bench_decode": (torch.int8, True)}
    out["paths"].update(generate_paths(params, cfg, dev, gen, configs))
    if profile:
        out["profile"].update(profile_paths(params, cfg, dev, gen, configs, {}))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def mixtral_phase(dev, int4: bool = False, profile: bool = False) -> dict:
    """MIXTRAL at full width and depth, built one layer at a time, through
    generate and the server: W8A16 per-channel behind the default engine, or
    (int4) W4A16 with INT4_GROUP-row scale groups throughout (the expert
    banks, the attention linears and the lm_head) behind an engine with a
    paged int8 pool."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params

    cfg = PRESETS[MIXTRAL]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    if int4:
        name, gen_path, srv_path = f"W4A16 g={INT4_GROUP}", "mixtral_int4_generate", \
            "mixtral_int4_paged_server"
        params = random_quantized_params(cfg, gen, quantize_lm_head=True, bits=4,
                                         group_size=INT4_GROUP)
        bank = params.layers[0].moe.down
        check(bank.bits == 4 and bank.scales.dim() == 3 and params.lm_head.bits == 4
              and params.layers[-1].qkv.scales.dim() == 2,
              "the int4 Mixtral is not int4 group-wise throughout")
        engine_kw = dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE,
                         kv_dtype=torch.int8)
    else:
        name, gen_path, srv_path = "W8A16", "mixtral_generate", "mixtral_server"
        params = random_quantized_params(cfg, gen, quantize_lm_head=True)
        engine_kw = {}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weight_gb = sum(b.numel() * b.element_size() for b in params.buffers()) / 1e9
    scale_gb = sum(b.numel() * b.element_size() for b in params.buffers()
                   if b.dtype == torch.float32) / 1e9
    print(f"  {MIXTRAL} {name} built layer by layer in {build_s:.1f} s: {weight_gb:.2f} GB on "
          f"the card ({scale_gb:.2f} GB of it f32 scales and norms), build peak "
          f"{build_peak_gb:.2f} GB ({before_gb:.2f} GB held before)")
    configs = {gen_path: (torch.bfloat16, False)}
    paths = generate_paths(params, cfg, dev, gen, configs)
    paths[srv_path] = server_path(params, cfg, dev, gen, srv_path, engine_kw)
    if not int4:
        # the spec engine (k = MIXTRAL_SPEC_K) over the same dense int8 cache:
        # an 8-slot verify round against the plain path, and the greedy
        # requests against its non-spec twin
        paths["mixtral_spec_server"] = server_path(
            params, cfg, dev, gen, "mixtral_spec_server", dict(spec_ngram=MIXTRAL_SPEC_K),
            twin_kw={}, admission=False, step_budget=MIXTRAL_SPEC_STEP_BUDGET,
            twin_layers=MIXTRAL_SPEC_TWIN_LAYERS)
    prof = profile_paths(params, cfg, dev, gen, configs, {srv_path: engine_kw}) if profile else None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = paths[gen_path]["timing"]
    print(f"  {MIXTRAL} {name}: weights {weight_gb:.2f} GB, built in {build_s:.1f} s, peak "
          f"{peak_gb:.2f} GB; prefill {t['prefill_ms']:.2f} ms (b=1 p={REQUESTS[0][1]}), decode "
          f"{t['decode_ms_per_step']:.3f} ms/step; served "
          f"{paths[srv_path]['served_tok_s']:.2f} tok/s")
    return dict(paths=paths, build_s=build_s, build_peak_gb=build_peak_gb, weight_gb=weight_gb,
                scale_gb=scale_gb, peak_gb=peak_gb, profile=prof)


def unit_gain_norms(params, cfg) -> None:
    """Every RMSNorm of a random model at gain 1, as the generic initializer
    gives the presets whose norms store their gain (ones): a unit-offset
    preset (gemma) stores gain - 1, so its norms are set to 0. With the
    initializer's ones, gemma-7b's 57 norms each double their input, and
    the random model amplifies the paths' ulp-level differences about 30x
    over 28 layers: its prefill logits part from the plain path's by
    0.1316 of the largest logit, 0.0079 at gain 1, while each layer's own
    difference is at llama2-7b's level (`scripts/torch_logit_drift.py`,
    PERF.md §6)."""
    if cfg.rmsnorm_unit_offset:
        for layer in params.layers:
            layer.input_norm.zero_()
            layer.post_norm.zero_()
        params.final_norm.zero_()


def families_phase(dev, table: dict = FAMILIES, layers: int | None = None) -> dict:
    """Each model of `table` (FAMILIES, or PRESET_MODELS) at full width and
    depth, or cut to `layers` (random W8A16 weights, an int8 lm_head, or
    W4A16 group-wise throughout where the entry has bits 4, built one layer
    at a time from SEED), through its b=1 decode path (prefill and one
    decode step against the plain path, decode_loop bit-equal to eager
    steps, timed) and its engine behind the server; each model is freed
    before the next is built."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8}
    out = dict(paths={}, models={})
    for preset, f in table.items():
        cfg = PRESETS[preset]
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        bits = f.get("bits", 8)
        params = random_quantized_params(cfg, gen, quantize_lm_head=True, bits=bits,
                                         group_size=f.get("group"))
        unit_gain_norms(params, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gb = sum(b.numel() * b.element_size() for b in params.buffers()) / 1e9
        card_gb = torch.cuda.memory_allocated() / 1e9
        build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        quant = "W8A16" if bits == 8 else f"W4A16 g={f['group']}"
        head = (f"an int{params.lm_head.bits} lm_head" if params.lm_head is not None else
                f"a tied head: the bf16 table {tuple(params.embed.shape)} through _tied_head")
        if cfg.rmsnorm_unit_offset:
            head += "; unit-offset norms stored at 0: gain 1"
        print(f"  {preset} {quant} built layer by layer in {build_s:.1f} s, {gb:.2f} GB of "
              f"weights, {card_gb:.2f} GB on the card ({held_gb:.2f} GB held before, build peak "
              f"{build_peak_gb:.2f} GB; {cfg.num_layers} layers, GQA {cfg.num_heads}/"
              f"{cfg.num_kv_heads}, head dim {cfg.head_dim}, vocabulary {cfg.vocab_size}, rope "
              f"theta {cfg.rope_theta:g}, window {cfg.sliding_window}, ALiBi {cfg.alibi}, "
              f"{cfg.activation}; {head})")
        tied = None
        if params.lm_head is None:
            # the tied head's device time at a decode step's rows (b=1) and an
            # 8-slot engine step's (its table, 1.57 GB at gemma-7b, is far
            # larger than L2)
            from eetq_tpu_torch.models.transformer import _tied_head

            tied = {}
            for m in (1, 8):
                x = torch.randn(m, 1, cfg.hidden_size, generator=gen, device=dev).to(
                    torch.bfloat16)
                with torch.inference_mode():
                    tied[f"m={m}"] = time_ms(lambda: _tied_head(x, params.embed), reps=10)
            print(f"  {preset} tied head on the card: {tied['m=1']:.4f} ms a b=1 decode step, "
                  f"{tied['m=8']:.4f} ms an 8-slot engine step")
        kw = {k: dtypes.get(v, v) for k, v in f["engine"].items()}
        twin = {k: dtypes.get(v, v) for k, v in f["twin"].items()}
        dec, srv = (f"{f['tag']}_decode",
                    f"{f['tag']}_{'paged_' if 'paged_blocks' in kw else ''}server")
        paths = generate_paths(params, cfg, dev, gen, {dec: (dtypes[f["kv"]], f["fused"])},
                               requests=((1, f["prompt"], FAMILY_NEW_TOKENS),),
                               check_prompt=f.get("check_prompt"))
        paths[srv] = server_path(params, cfg, dev, gen, srv, kw, twin_kw=twin,
                                 long=f.get("long", ()),
                                 step_prompts=f.get("step_prompts", STEP_PROMPTS),
                                 admission_prompt=f.get("admission_prompt", ADMISSION_PROMPT))
        if "chunk" in f:
            paths[f"{f['tag']}_chunked"] = chunked_prefill_path(
                params, cfg, dev, gen, f"{f['tag']}_chunked", 1, f["prompt"], f["chunk"],
                dtypes[f["kv"]], f["fused"])
        if "spec" in f:
            paths[f"{f['tag']}_ngram_spec"] = family_ngram_path(
                params, cfg, dev, gen, f"{f['tag']}_ngram_spec", f["spec"])
            spec = f"{f['tag']}_spec_{'paged_' if 'paged_blocks' in kw else ''}server"
            paths[spec] = server_path(params, cfg, dev, gen, spec,
                                      dict(kw, spec_ngram=f["spec"], **f["spec_engine"]),
                                      twin_kw=twin, admission=False)
        t = paths[dec]["timing"]
        print(f"  {preset}: prefill {t['prefill_ms']:.2f} ms (b=1 p={f['prompt']}), decode "
              f"{t['decode_ms_per_step']:.3f} ms/step ({t['replay_ms_per_step']:.3f} a replayed "
              f"step), {f['kv']} KV{', fused MLP' if f['fused'] else ''}; {srv} served "
              f"{paths[srv]['served_tok_s']:.2f} tok/s; {cfg.num_layers} of "
              f"{PRESETS[preset].num_layers} layers, {time.perf_counter() - t0:.1f} s")
        out["paths"].update(paths)
        out["models"][preset] = dict(build_s=build_s, weight_gb=gb, card_gb=card_gb,
                                     build_peak_gb=build_peak_gb, tied_head_ms=tied,
                                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                     layers=cfg.num_layers,
                                     seconds=time.perf_counter() - t0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def buffer_kind(name: str) -> str:
    """What a buffer of the port's ModelParams is, by the fp16 tensor the
    checkpoint stores it as."""
    last = name.rsplit(".", 1)[-1]
    if last in ("input_norm", "post_norm", "final_norm"):
        return "norms"
    if ".router." in name:
        return "router"
    return {"scales": "scales", "embed": "embed", "bias": "biases"}.get(last, "dense weights")


def checkpoint_equal(src, got, tag: str) -> dict:
    """Every tensor of `got` (a model loaded from a checkpoint of `src`)
    equal to `src`'s: int8 weights as they are, the tensors the format
    stores in fp16 (scales, norms, biases, the embedding, a router, a dense
    head) as fp16 holds them. Counts the values fp16 changes, by kind; the
    scales must round-trip exactly (a bf16 max|w| / 2^(bits-1) in fp16's
    normal range does). Then rounds src's fp16-stored tensors in place, so
    that src is the model as stored."""
    import torch

    from eetq_tpu_torch.modules.linear import QuantLinear

    mods = dict(got.named_modules())
    for name, mod in src.named_modules():
        other = mods.get(name)
        check(type(other) is type(mod), f"{tag}: {name or 'the model'} loaded as "
                                        f"{type(other).__name__}, saved as {type(mod).__name__}")
        if isinstance(mod, QuantLinear):
            check((other.k, other.n, other.bits) == (mod.k, mod.n, mod.bits),
                  f"{tag}: {name} loaded as k, n, bits {(other.k, other.n, other.bits)}, "
                  f"saved as {(mod.k, mod.n, mod.bits)}")
    want, have = dict(src.named_buffers()), dict(got.named_buffers())
    check(want.keys() == have.keys(), f"{tag}: buffers {sorted(want.keys() ^ have.keys())} on "
                                      f"one side only")
    changed, total, smallest = {}, {}, {}
    for name, t in want.items():
        g = have[name]
        check(g.dtype == t.dtype and g.shape == t.shape,
              f"{tag}: {name} loaded as {g.dtype} {tuple(g.shape)}, saved {t.dtype} "
              f"{tuple(t.shape)}")
        if t.dtype == torch.int8:
            check(torch.equal(g, t), f"{tag}: int8 {name} differs after the round trip")
            continue
        kind = buffer_kind(name)
        stored = t.to(torch.float16).to(t.dtype)
        diff = stored != t
        n = int(diff.sum())
        changed[kind] = changed.get(kind, 0) + n
        total[kind] = total.get(kind, 0) + t.numel()
        if n:
            smallest[kind] = max(smallest.get(kind, 0.0), float(t[diff].abs().max()))
        check(torch.equal(g, stored), f"{tag}: {name} differs from the source as fp16 holds it")
        t.copy_(stored)
    for kind in sorted(total):
        note = (f", all with |x| <= {smallest[kind]:.3e} (fp16 is subnormal below 6.1e-5)"
                if kind in smallest else "")
        print(f"  {tag}: {kind}: {changed[kind]} of {total[kind]} values change when stored as "
              f"fp16{note}")
    check(changed.get("scales", 0) == 0, f"{tag}: {changed.get('scales')} scales change when "
                                         "stored as fp16")
    return dict(changed_by_fp16=changed, values=total, largest_changed=smallest)


def greedy_tokens(params, cfg, dev, prompt, n: int, kv, fused: bool):
    """prefill, then decode_loop's n greedy tokens."""
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    caches = init_caches(cfg, prompt.shape[0], prompt.shape[1] + n, device=dev, dtype=kv)
    lp, caches = prefill(params, cfg, prompt, caches)
    toks, _ = decode_loop(params, cfg, torch.argmax(lp, -1), prompt.shape[1], caches, n,
                          fused_mlp=fused)
    torch.cuda.synchronize()
    return toks


def disk_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9


def round_trip(params, cfg, dev, gen, path: str, kv, fused: bool, shards: int | None,
               tp: int = 1) -> dict:
    """save_quantized through `EETQCausalLM` (an artifact quantized for `tp`
    ranks), `from_quantized` back, `config.json` recording tp, every tensor
    against the source (`checkpoint_equal`), and the loaded model's greedy
    tokens (the path, counted) against the source's, before and after the
    source's fp16-stored tensors are rounded as the file holds them: the
    latter must be equal."""
    import tempfile

    import torch

    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM, EETQCausalLM

    _, p, n = REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=gen, device=dev)
    first = greedy_tokens(params, cfg, dev, prompt, n, kv, fused)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        free_gb = shutil.disk_usage(d).free / 1e9
        check(free_gb >= CKPT_FREE_GB, f"{path}: {free_gb:.1f} GB free under {d}, the phase "
                                       f"needs {CKPT_FREE_GB} GB")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        EETQCausalLM(cfg, params, tp=tp).save_quantized(d)
        save_s = time.perf_counter() - t0
        with open(os.path.join(d, "config.json")) as f:
            recorded = json.load(f)["quantization_config"].get("tp")
        check(recorded == tp, f"{path}: config.json records tp {recorded}, want {tp}")
        gb, files = disk_gb(d), sorted(os.listdir(d))
        st = [f for f in files if f.endswith(".safetensors")]
        print(f"  {path} on {card_line()}: saved {gb:.3f} GB in {save_s:.2f} s "
              f"({gb / save_s:.2f} GB/s) under {d} ({free_gb:.1f} GB free before): {files}")
        if shards is not None:
            check(len(st) == shards and (shards == 1 or "model.safetensors.index.json" in files),
                  f"{path}: {len(st)} shards, want {shards} and an index")
        t0 = time.perf_counter()
        model = AutoEETQForCausalLM.from_quantized(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    print(f"  {path}: loaded in {load_s:.2f} s ({gb / load_s:.2f} GB/s, the files just "
          f"written, through the page cache)")
    check(model.cfg == cfg and model.tp == tp, f"{path}: the loaded config {model.cfg} (tp "
                                               f"{model.tp}) is not {cfg} (tp {tp})")
    check(next(model.params.buffers()).device == dev, f"{path}: from_quantized did not load "
                                                      "onto the card")
    stored = checkpoint_equal(params, model.params, path)
    toks, counts = counted(path, lambda: greedy_tokens(model.params, cfg, dev, prompt, n, kv,
                                                       fused))
    want = greedy_tokens(params, cfg, dev, prompt, n, kv, fused)
    check(torch.equal(toks, want), f"{path}: the loaded model's {n} greedy tokens differ from "
                                   "the source's as stored")
    same = bool(torch.equal(toks, first))
    print(f"  {path}: {n} greedy tokens (b=1 p={p}, {kv} KV, fused MLP {fused}) bit-equal to the "
          f"source's as stored; to the source's before fp16 rounding: {same}")
    return dict(counts=counts, save_s=save_s, load_s=load_s, disk_gb=gb, files=files,
                save_gb_s=gb / save_s, load_gb_s=gb / load_s, stored=stored,
                tokens_equal_unrounded=same)


def dense_hf_checkpoint(cfg, gen, dev) -> tuple[dict, dict]:
    """An fp16 HF-layout llama checkpoint of cfg's shapes, made on the card
    from `gen`: [out, in] projections ~ N(0, 1/in), norms ~ N(1, 0.02^2), the
    embedding ~ N(0, 0.02^2); and its config.json in HF keys."""
    import torch

    def normal(shape, std, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(torch.float16)

    h, i = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    tensors = {}
    for layer in range(cfg.num_layers):
        pfx = f"model.layers.{layer}"
        for name, (out, k) in (("self_attn.q_proj", (nq, h)), ("self_attn.k_proj", (nkv, h)),
                               ("self_attn.v_proj", (nkv, h)), ("self_attn.o_proj", (h, nq)),
                               ("mlp.gate_proj", (i, h)), ("mlp.up_proj", (i, h)),
                               ("mlp.down_proj", (h, i))):
            tensors[f"{pfx}.{name}.weight"] = normal((out, k), k ** -0.5)
        for name in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{pfx}.{name}.weight"] = normal((h,), 0.02, 1.0)
    tensors["model.embed_tokens.weight"] = normal((cfg.vocab_size, h), 0.02)
    tensors["model.norm.weight"] = normal((h,), 0.02, 1.0)
    tensors["lm_head.weight"] = normal((cfg.vocab_size, h), h ** -0.5)
    hf = dict(model_type="llama", architectures=["LlamaForCausalLM"], vocab_size=cfg.vocab_size,
              hidden_size=h, intermediate_size=i, num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
              max_position_embeddings=cfg.max_position, rms_norm_eps=cfg.rms_eps,
              rope_theta=cfg.rope_theta, hidden_act=cfg.activation, tie_word_embeddings=False,
              torch_dtype="float16")
    return tensors, hf


def dense_in_memory(tensors: dict, cfg):
    """The dense bf16 params of `dense_hf_checkpoint`'s tensors, built in
    memory: [in, out] weights, q|k|v and gate|up fused along N."""
    import torch

    from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
    from eetq_tpu_torch.modules.linear import DenseLinear
    from eetq_tpu_torch.surgery import fuse_gateup, fuse_qkv

    def w(name):
        return tensors[f"{name}.weight"].T.to(torch.bfloat16)

    layers = []
    for layer in range(cfg.num_layers):
        a, m = f"model.layers.{layer}.self_attn", f"model.layers.{layer}.mlp"
        layers.append(LayerParams(
            tensors[f"model.layers.{layer}.input_layernorm.weight"].float(),
            DenseLinear(fuse_qkv(w(f"{a}.q_proj"), w(f"{a}.k_proj"), w(f"{a}.v_proj"))),
            DenseLinear(w(f"{a}.o_proj").contiguous()),
            tensors[f"model.layers.{layer}.post_attention_layernorm.weight"].float(),
            DenseLinear(fuse_gateup(w(f"{m}.gate_proj"), w(f"{m}.up_proj"))),
            DenseLinear(w(f"{m}.down_proj").contiguous())))
    return ModelParams(tensors["model.embed_tokens.weight"].to(torch.bfloat16), layers,
                       tensors["model.norm.weight"].float(), DenseLinear(w("lm_head").contiguous()))


def dense_import_path(dev, gen) -> dict:
    """`from_pretrained(quantize=True)` over an fp16 HF checkpoint written by
    the port's own writer: its quantized params bit-equal to `eet_quantize`
    of the same dense params built in memory, and its prefill (the path,
    counted) within MODEL_TOL of the plain path."""
    import tempfile

    import torch

    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.safetensors_io import save_file
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import prefill
    from eetq_tpu_torch.surgery import eet_quantize

    path = "checkpoint_dense_import"
    cfg = dataclasses.replace(PRESETS[MODEL], num_layers=CKPT_DENSE_LAYERS)
    tensors, hf = dense_hf_checkpoint(cfg, gen, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_file(tensors, os.path.join(d, "model.safetensors"))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f, indent=2)
        write_s = time.perf_counter() - t0
        gb = disk_gb(d)
        t0 = time.perf_counter()
        model = AutoEETQForCausalLM.from_pretrained(d, quantize=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    print(f"  {path}: an fp16 HF checkpoint of {MODEL}'s width at {cfg.num_layers} layers, "
          f"{gb:.3f} GB written in {write_s:.2f} s; from_pretrained(quantize=True) in "
          f"{load_s:.2f} s")
    check(model.cfg == cfg, f"{path}: the loaded config {model.cfg} is not {cfg}")
    want = eet_quantize(dense_in_memory(tensors, cfg))
    del tensors
    have = dict(model.params.named_buffers())
    for name, t in want.named_buffers():
        check(torch.equal(have[name], t), f"{path}: {name} differs from eet_quantize of the "
                                          "same dense params built in memory")
    print(f"  {path}: {len(have)} tensors bit-equal to eet_quantize in memory")
    prompt = torch.randint(0, cfg.vocab_size, (1, REQUESTS[0][1]), generator=gen, device=dev)

    def run(use):
        caches = init_caches(cfg, 1, prompt.shape[1], device=dev)
        return prefill(model.params, cfg, prompt, caches, use_kernels=use)[0]

    logits, counts = counted(path, lambda: run(True))
    checks = check_logits(f"{path} prefill", logits, run(False))
    return dict(counts=counts, write_s=write_s, load_s=load_s, disk_gb=gb, checks=checks)


def checkpoint_phase(dev) -> dict:
    """(a) MODEL W8A16 (int8 lm_head) at full width and depth, built as the
    llama phase builds it: saved in two shards, loaded, every tensor and 50
    greedy tokens (bench.py's int8 KV and fused MLP) against the source;
    (b) the dense import; (c) MIXTRAL W8A16 at full width and
    CKPT_MIXTRAL_LAYERS layers: the same round trip (bf16 KV). Each model
    and directory goes before the next."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import (quantize_params, random_dense_params,
                                            random_quantized_params)

    out = dict(paths={})
    cfg = PRESETS[MODEL]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dense = random_dense_params(cfg, gen)
    params = quantize_params(dense, quantize_lm_head=True)
    del dense
    out["paths"]["checkpoint_llama"] = round_trip(params, cfg, dev, gen, "checkpoint_llama",
                                                  torch.int8, True, CKPT_SHARDS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["paths"]["checkpoint_dense_import"] = dense_import_path(dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(PRESETS[MIXTRAL], num_layers=CKPT_MIXTRAL_LAYERS)
    params = random_quantized_params(cfg, gen, quantize_lm_head=True)
    out["paths"]["checkpoint_mixtral"] = round_trip(params, cfg, dev, gen, "checkpoint_mixtral",
                                                    torch.bfloat16, False, None)
    return out


def epilogue_linear_path(base, cfg, dev, gen) -> dict:
    """The epilogue through its user entry point, `linear_apply(activation=,
    residual=)`, on llama2-7b layer 0's gate|up (each activation) and o_proj
    (a residual added, and `w8a16_matmul(residual_mode="mul")`), int8 as the
    model holds them and requantized to int4 g = 128: m = 1 and 8 (the GEMV),
    1024 (the GEMM) and a8 at 1024 (W8A8 / W4A8, activations only: a8 takes
    no residual), each against the plain path within TOL."""
    import torch

    from eetq_tpu_torch.layout.tiling import unpack_weights
    from eetq_tpu_torch.modules.linear import linear_apply, quantize_linear
    from eetq_tpu_torch.ops.linear import w8a16_matmul

    lp = base.layers[0]

    def int4(lin):
        w = unpack_weights(lin.packed).float() * lin.scales.float()
        return quantize_linear(w, bits=4, group_size=INT4_GROUP)

    layers = {"int8": (lp.gateup, lp.o_proj), "int4 g=128": (int4(lp.gateup), int4(lp.o_proj))}
    cases = []
    for tag, (gu, o) in layers.items():
        for m, a8 in ((1, False), (8, False), (1024, False), (1024, True)):
            x = torch.randn(1, m, gu.in_features, generator=gen, device=dev).to(torch.bfloat16)
            res = torch.randn(1, m, o.out_features, generator=gen, device=dev).to(torch.bfloat16)
            for act in ACTIVATION_NAMES:
                cases.append((f"{tag} gate|up m={m}{' a8' if a8 else ''} {act}",
                              functools.partial(linear_apply, gu, x, activation=act, a8=a8)))
            if not a8:
                cases.append((f"{tag} o_proj m={m} +residual",
                              functools.partial(linear_apply, o, x, residual=res)))
                cases.append((f"{tag} o_proj m={m} *residual", functools.partial(
                    w8a16_matmul, x, o.packed, o.scales, residual=res, residual_mode="mul")))

    def run():
        with torch.inference_mode():
            return [fn() for _, fn in cases]

    outs, counts = counted("epilogue_linear", run)
    worst = 0.0
    with torch.inference_mode():
        for (case, fn), out in zip(cases, outs):
            err, ref_max = compare(out, fn(use_kernel=False))
            worst = max(worst, err / ref_max)
            check(err <= TOL * ref_max, f"epilogue_linear {case}: error {err:.3e} of {ref_max:.3e}")
    print(f"  epilogue_linear: {len(cases)} calls through linear_apply / w8a16_matmul against "
          f"the plain path, the largest error {worst:.3e} of the largest output (tol {TOL})")
    return dict(counts=counts, cases=len(cases), rel_err=worst)


def lora_bank(base, cfg, gen):
    """LORA_ADAPTERS adapted copies of `base` (A ~ N(0, 1/r), B ~ N(0,
    LORA_B_STD^2)) stacked into one bank, and each adapter's single-adapter
    twin: the bank's slices over the same base modules (no copy)."""
    import torch

    from eetq_tpu_torch.modules.linear import LoraAdapter
    from eetq_tpu_torch.models.transformer import ModelParams
    from eetq_tpu_torch.surgery import init_lora, stack_adapters
    from eetq_tpu_torch.surgery.lora import replace_layer

    def adapter(lin):
        ad = init_lora(gen, lin.in_features, lin.out_features, LORA_RANK, LORA_ALPHA)
        ad.lora_b.copy_(torch.randn(ad.lora_b.shape, generator=gen, device=gen.device)
                        * LORA_B_STD)
        return ad

    adapted = [ModelParams(base.embed, [replace_layer(lp, qkv_lora=adapter(lp.qkv),
                                                      o_lora=adapter(lp.o_proj))
                                        for lp in base.layers], base.final_norm, base.lm_head)
               for _ in range(LORA_ADAPTERS)]
    bank = stack_adapters(adapted)
    del adapted
    twins = [ModelParams(bank.embed, [replace_layer(
        lp, qkv_lora=LoraAdapter(lp.qkv_lora.lora_a[i], lp.qkv_lora.lora_b[i], lp.qkv_lora.scaling),
        o_lora=LoraAdapter(lp.o_lora.lora_a[i], lp.o_lora.lora_b[i], lp.o_lora.scaling))
        for lp in bank.layers], bank.final_norm, bank.lm_head) for i in range(LORA_ADAPTERS)]
    return bank, twins


def lora_prefill_path(bank, twins, base, cfg, dev, gen) -> dict:
    """b = LORA_PREFILL prompts through the bank, row i on adapter i: the
    logits of every position against twin i's and against the plain path,
    within MODEL_TOL; then the bank's prefill and the base's timed in turns."""
    import torch

    from eetq_tpu_torch.models.transformer import forward_inner

    b, p = LORA_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    idx = torch.arange(b, device=dev) % LORA_ADAPTERS

    def run(params, use=True, rows=slice(None), **kw):
        with torch.inference_mode():
            return forward_inner(params, cfg, toks[rows], pos[rows], None, 0, use_kernels=use,
                                 **kw)[0]

    got, counts = counted("lora_prefill", lambda: run(bank, lora_idx=idx))
    checks = {"plain": check_logits("lora_prefill (b=4, one adapter a row)", got,
                                    run(bank, False, lora_idx=idx))}
    for i in range(b):
        checks[f"twin{i}"] = check_logits(f"lora_prefill row {i} against its twin", got[i:i + 1],
                                          run(twins[int(idx[i])], rows=slice(i, i + 1)))
    del got
    ms = dict(bank=[], base=[])
    for _ in range(3):
        for name, fn in (("bank", lambda: run(bank, lora_idx=idx)), ("base", lambda: run(base))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"  lora_prefill b={b} p={p}: {med['bank']:.2f} ms with the bank against "
          f"{med['base']:.2f} ms without (medians of 3 in turns: {ms})")
    return dict(counts=counts, checks=checks, prefill_ms=med, prefill_ms_runs=ms)


def side_path_cost(bank, base, cfg, dev) -> dict:
    """One eager 8-slot decode step (a token a slot over 1024 cached keys,
    int8 KV) of the bank, each slot on its own adapter, and of the base, under
    torch.profiler: the side path's kernel launches and device ms a step are
    the difference."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eetq_tpu_torch.models.transformer import forward_inner, init_caches

    caches = init_caches(cfg, 8, 1040, dev, torch.int8)
    tok = torch.ones(8, 1, dtype=torch.long, device=dev)
    lens = torch.full((8,), 1024, device=dev)
    ids = torch.arange(8, device=dev) % LORA_ADAPTERS
    out = {}
    for name, params, kw in (("bank", bank, dict(lora_idx=ids)), ("base", base, {})):
        with torch.inference_mode():
            forward_inner(params, cfg, tok, lens[:, None], caches, lens, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                forward_inner(params, cfg, tok, lens[:, None], caches, lens, **kw)
                torch.cuda.synchronize()
        busy_ms, launches, _, _ = _device_events(prof)
        check(busy_ms > 0, "the profiler saw no device time")
        out[name] = dict(busy_ms=busy_ms, launches=launches)
    out["side_launches"] = out["bank"]["launches"] - out["base"]["launches"]
    out["side_busy_ms"] = out["bank"]["busy_ms"] - out["base"]["busy_ms"]
    print(f"  LoRA side path in an 8-slot decode step: {out['side_launches']} kernel launches "
          f"({out['bank']['launches']} against {out['base']['launches']}), "
          f"{out['side_busy_ms']:.3f} device ms ({out['bank']['busy_ms']:.3f} against "
          f"{out['base']['busy_ms']:.3f}), one eager step each")
    return out


def lora_requests(cfg, dev, gen) -> list[dict]:
    """SERVE_REQUESTS greedy HTTP bodies of the server mix, adapters mixed."""
    import torch

    bodies = []
    for i in range(SERVE_REQUESTS):
        p = SERVE_LENGTHS[int(torch.randint(0, len(SERVE_LENGTHS), (), generator=gen, device=dev))]
        n = SERVE_BUDGETS[int(torch.randint(0, len(SERVE_BUDGETS), (), generator=gen, device=dev))]
        ids = torch.randint(0, cfg.vocab_size, (p,), generator=gen, device=dev).tolist()
        bodies.append({"prompt": ids, "max_new_tokens": n, "stream": i % 5 == 1,
                       "lora_id": (i * 3 + 1) % LORA_ADAPTERS})
    return bodies


def lora_serve(eng, path: str | None, bodies: list[dict]) -> tuple[dict, float, dict | None]:
    """The bodies from SERVE_THREADS threads through `eng` behind its HTTP
    server: (tokens by request, wall s, launch counts where `path` is given)."""
    from eetq_tpu_torch.serve.api import EngineServer

    srv = EngineServer(eng, host="127.0.0.1", port=0)
    srv.start()
    results, errors = {}, []

    def worker(idx):
        for i in idx:
            try:
                results[i] = _post(srv.port, bodies[i])
            except Exception as e:  # reported below, fails the run
                errors.append(f"request {i}: {e!r}")
                return

    def serve():
        threads = [threading.Thread(target=worker, args=(range(j, len(bodies), SERVE_THREADS),))
                   for j in range(SERVE_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        return time.perf_counter() - t

    try:
        wall_s, counts = counted(path, serve) if path else (serve(), None)
    finally:
        srv.shutdown()
    check(not errors, f"HTTP requests failed: {errors}")
    check(len(results) == len(bodies), f"{len(results)} of {len(bodies)} requests answered")
    return results, wall_s, counts


def lora_server_path(bank, twins, base, cfg, dev, path: str, engine_kw: dict, bodies,
                     twin_tokens: list[list[int]]) -> dict:
    """The bank behind the engine and its HTTP server (W8A16 admission, max_batch
    8, max_len 2048, `engine_kw`), warmed up: every request equals its twin's
    greedy_generate (`twin_tokens`), or parts from it at a near tie
    (SPEC_TIE_ULPS, on the twin's kernel path); then the same engine over the
    base model serves the same requests without adapters, in turn."""
    import torch

    from eetq_tpu_torch.serve.engine import Engine

    kw = dict(max_batch=8, max_len=2048, a8_prefill=False, **engine_kw)
    eng = Engine(bank, cfg, **kw)
    check(eng._lora_banked and eng._n_adapters == LORA_ADAPTERS and eng.decode_window == 8,
          f"{path}: engine banks {eng._n_adapters}, window {eng.decode_window}")
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    buf = eng._lora_ids
    results, wall_s, counts = lora_serve(eng, path, bodies)
    check(eng._lora_ids is buf, f"{path}: the ids' buffer was rebound")
    if eng.paged:
        check(sorted(eng._free_blocks) == list(range(1, engine_kw["paged_blocks"])),
              f"{path}: blocks still held after the run")
    ties = []
    for i, body in enumerate(bodies):
        got, want = results[i], twin_tokens[i]
        check(len(got) == body["max_new_tokens"], f"{path} request {i}: {len(got)} tokens")
        first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if first is None:
            continue
        tie = near_tie(twins[body["lora_id"]], cfg, dev, body["prompt"] + want[:first],
                       got[first], want[first])
        print(f"  {path} request {i} (adapter {body['lora_id']}, prompt {len(body['prompt'])}): "
              f"token {first} is {got[first]}, the twin's {want[first]}: {tie['ulps']:.2f} bf16 "
              f"ulps below the top (near tie: {tie['ok']})")
        check(tie["ok"], f"{path}: request {i} differs from its twin's greedy_generate at token "
                         f"{first}, not at a near tie")
        ties.append(dict(request=i, token=first, **tie))
    tokens = sum(b["max_new_tokens"] for b in bodies)
    spec = None
    if eng.spec_ngram:
        spec = dict(rounds=eng.spec_rounds, tokens=eng.spec_tokens)
    del eng
    torch.cuda.empty_cache()
    plain = Engine(base, cfg, **kw)
    plain.warmup()
    _, base_wall_s, _ = lora_serve(plain, None,
                                   [{k: v for k, v in b.items() if k != "lora_id"} for b in bodies])
    del plain
    torch.cuda.empty_cache()
    out = dict(counts=counts, results=results, served_tok_s=tokens / wall_s,
               base_served_tok_s=tokens / base_wall_s, wall_s=wall_s, base_wall_s=base_wall_s,
               warmup_s=warmup_s, tokens=tokens, near_ties=ties, spec=spec)
    print(f"  {path}: {len(bodies)} requests, adapters {[b['lora_id'] for b in bodies]}, "
          f"{tokens} tokens: {out['served_tok_s']:.2f} tok/s served with the bank, "
          f"{out['base_served_tok_s']:.2f} by the same engine over the base, in turn; "
          f"{len(bodies) - len(ties)} equal their twin's greedy_generate, {len(ties)} part at a "
          f"near tie" + (f"; {spec['rounds']} rounds, {spec['tokens']} tokens" if spec else ""))
    return out


def lora_merge_path(bank, twins, base, cfg, dev, gen) -> dict:
    """`merge_lora` of adapter LORA_MERGE_ID: the requantized weights that
    moved, then prefill logits of the merged model against the bank's at
    that id, within the JAX test's bounds (LORA_MERGE_MEAN, LORA_MERGE_ARGMAX)."""
    import torch

    from eetq_tpu_torch.layout.tiling import unpack_weights
    from eetq_tpu_torch.models.transformer import forward_inner
    from eetq_tpu_torch.surgery import merge_lora

    t0 = time.perf_counter()
    merged = merge_lora(twins[LORA_MERGE_ID])
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    moved = total = 0
    for lm, lb in zip(merged.layers, base.layers):
        check(lm.qkv_lora is None and lm.o_lora is None, "merge_lora left a side path")
        for name in ("qkv", "o_proj"):
            a, b = unpack_weights(getattr(lm, name).packed), unpack_weights(getattr(lb, name).packed)
            moved += int((a != b).sum())
            total += a.numel()
    p = LORA_PREFILL[1]
    toks = torch.randint(0, cfg.vocab_size, (1, p), generator=gen, device=dev)
    pos = torch.arange(p, device=dev)[None]
    with torch.inference_mode():
        got, counts = counted("lora_merge", lambda: forward_inner(merged, cfg, toks, pos, None,
                                                                  0)[0])
        want = forward_inner(bank, cfg, toks, pos, None, 0,
                             lora_idx=torch.tensor([LORA_MERGE_ID], device=dev))[0]
    mean = float((got - want).abs().mean())
    argmax = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"  lora_merge (adapter {LORA_MERGE_ID}, {merge_s:.2f} s): {moved} of {total} int8 "
          f"weights of qkv and o_proj moved by the requantization; prefill logits against the "
          f"bank at id {LORA_MERGE_ID}: mean |diff| {mean:.4f} (tol {LORA_MERGE_MEAN}), argmax "
          f"equal at {argmax:.4f} of positions (at least {LORA_MERGE_ARGMAX})")
    check(mean < LORA_MERGE_MEAN and argmax > LORA_MERGE_ARGMAX,
          f"lora_merge: mean |diff| {mean:.4f}, argmax share {argmax:.4f}")
    return dict(counts=counts, moved=moved, weights=total, mean_abs=mean, argmax_share=argmax,
                merge_s=merge_s)


def eval_ppl_path(dense, base, cfg, dev, gen) -> dict:
    """`serve/eval.py` on MODEL: `delta_ppl` of the bf16 model and its W8A16
    copy over EVAL_WINDOWS seeded windows of EVAL_WINDOW tokens (random
    weights: ΔPPL has no bound), the W8A16 kernel path's mean NLL against its
    plain path's (EVAL_NLL_TOL nats) and its perplexity against a
    straight-line per-window cross-entropy in float64 (EVAL_MANUAL_RTOL); then
    the W8A16 perplexity timed (median of 3)."""
    import math

    import torch

    from eetq_tpu_torch.models.transformer import forward_inner
    from eetq_tpu_torch.serve.eval import delta_ppl, perplexity

    n = EVAL_WINDOW * EVAL_WINDOWS
    ids = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).cpu().numpy()
    r, counts = counted("eval_ppl", lambda: delta_ppl(dense, base, cfg, ids, window=EVAL_WINDOW))
    check(all(math.isfinite(v) for v in r.values()), f"eval_ppl: {r}")
    plain = perplexity(base, cfg, ids, window=EVAL_WINDOW, use_kernels=False)
    nll_gap = abs(math.log(r["ppl_quant"]) - math.log(plain))
    total = 0.0
    pos = torch.arange(EVAL_WINDOW, device=dev)[None]
    with torch.inference_mode():
        for i in range(0, n, EVAL_WINDOW):
            chunk = torch.from_numpy(ids[i:i + EVAL_WINDOW]).to(dev)[None]
            logits, _ = forward_inner(base, cfg, chunk, pos, None, 0)
            logp = torch.log_softmax(logits[0, :-1].double(), dim=-1)
            total -= float(logp.gather(-1, chunk[0, 1:, None]).sum())
    manual = math.exp(total / (n - EVAL_WINDOWS))
    manual_rel = abs(r["ppl_quant"] - manual) / manual
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perplexity(base, cfg, ids, window=EVAL_WINDOW)
        runs.append(time.perf_counter() - t0)
    sec = statistics.median(runs)
    out = dict(counts=counts, **r, ppl_quant_plain=plain, nll_gap=nll_gap, ppl_manual=manual,
               manual_rel=manual_rel, ms_per_window=1e3 * sec / EVAL_WINDOWS,
               tokens_per_s=n / sec, runs_s=runs)
    print(f"  eval_ppl over {EVAL_WINDOWS} windows of {EVAL_WINDOW} seeded tokens: PPL dense "
          f"{r['ppl_dense']:.4f}, W8A16 {r['ppl_quant']:.4f}, ΔPPL {r['delta_ppl']:+.4f} "
          f"(random weights: no bound); W8A16 plain path {plain:.4f}, mean NLL apart by "
          f"{nll_gap:.2e} nats (tol {EVAL_NLL_TOL}); straight-line {manual:.4f}, relative "
          f"{manual_rel:.2e} (tol {EVAL_MANUAL_RTOL}); {out['ms_per_window']:.2f} ms a window, "
          f"{out['tokens_per_s']:.0f} tokens/s (median of 3: {['%.3f s' % v for v in runs]})")
    check(nll_gap <= EVAL_NLL_TOL, f"eval_ppl: the kernel path's mean NLL is {nll_gap:.3e} nats "
                                   "from the plain path's")
    check(manual_rel <= EVAL_MANUAL_RTOL, f"eval_ppl: perplexity {r['ppl_quant']} against the "
                                          f"straight-line {manual}")
    return out


@contextlib.contextmanager
def backward_timers(ms: dict):
    """Record CUDA events around every call of the backward of `DequantMatmul`
    ("linears") and of `FlashAttention` ("attention"); on exit, after a
    synchronize, ms[name] is the sum of the ms between each pair (the
    device's timeline on the stream both run on)."""
    import torch

    from eetq_tpu_torch.kernels.flash_attention import FlashAttention
    from eetq_tpu_torch.ops.linear import DequantMatmul

    saved = {DequantMatmul: (DequantMatmul.backward, "linears"),
             FlashAttention: (FlashAttention.backward, "attention")}
    pairs = {name: [] for _, name in saved.values()}

    def timed(fn, name):
        def backward(ctx, *grads):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(ctx, *grads)
            end.record()
            pairs[name].append((start, end))
            return out
        return staticmethod(backward)

    for cls, (fn, name) in saved.items():
        cls.backward = timed(fn, name)
    try:
        yield
    finally:
        for cls, (fn, _) in saved.items():
            cls.backward = staticmethod(fn)
    torch.cuda.synchronize()
    ms.update({name: sum(a.elapsed_time(b) for a, b in ab) for name, ab in pairs.items()})


def lora_train_path(twin, cfg, dev, gen) -> dict:
    """LoRA finetuning on MODEL W8A16: `twin`'s adapters on qkv and o_proj of
    every layer, cloned (the twins are slices of the serving bank), set to
    requires_grad_(); one seeded batch of TRAIN_TOKENS tokens, next-token
    cross-entropy over the f32 logits, `forward_inner` (caches=None) and
    `torch.autograd.grad`. Every adapter tensor's gradient finite, nonzero and
    within TRAIN_TOL of the plain path's (use_kernels=False, every layer, on
    the card); the step timed (median of 3 after a warm-up; the forward and
    the backward by CUDA events), its peak memory, and in one more step the
    backward's device time on the attention and on the linears
    (`backward_timers`); then TRAIN_STEPS SGD steps must lower the batch's
    loss."""
    import torch

    from eetq_tpu_torch.models.transformer import ModelParams, forward_inner
    from eetq_tpu_torch.modules.linear import LoraAdapter
    from eetq_tpu_torch.surgery.lora import replace_layer

    def clone(ad):
        return LoraAdapter(ad.lora_a.clone(), ad.lora_b.clone(), ad.scaling)

    params = ModelParams(twin.embed, [replace_layer(lp, qkv_lora=clone(lp.qkv_lora),
                                                    o_lora=clone(lp.o_lora))
                                      for lp in twin.layers], twin.final_norm, twin.lm_head)
    bank_b = twin.layers[-1].o_lora.lora_b.clone()
    leaves = [getattr(ad, name).requires_grad_() for lp in params.layers
              for ad in (lp.qkv_lora, lp.o_lora) for name in ("lora_a", "lora_b")]
    toks = torch.randint(0, cfg.vocab_size, (1, TRAIN_TOKENS), generator=gen, device=dev)
    pos = torch.arange(TRAIN_TOKENS, device=dev)[None]

    def step(use: bool = True):
        logits, _ = forward_inner(params, cfg, toks, pos, None, 0, use_kernels=use)
        loss = torch.nn.functional.cross_entropy(logits[0, :-1], toks[0, 1:])
        return loss.detach(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (loss0, grads), counts = counted("lora_train", step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    above_gb = peak_gb - held / 1e9
    torch.cuda.reset_peak_memory_stats()
    _, plain = step(False)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    worst, names = 0.0, ("qkv A", "qkv B", "o A", "o B")
    for i, (g, p) in enumerate(zip(grads, plain)):
        what = f"lora_train layer {i // 4} {names[i % 4]}"
        check(bool(torch.isfinite(g).all()) and bool(g.any()), f"{what}: gradient not finite "
                                                               "or zero")
        rel = ((g.float() - p.float()).abs().max() / p.float().abs().max()).item()
        check(rel <= TRAIN_TOL, f"{what}: gradient {rel:.3e} from the plain path's")
        worst = max(worst, rel)
    del plain
    runs = []  # (wall, forward, backward) ms: a warm-up, then three
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        logits, _ = forward_inner(params, cfg, toks, pos, None, 0)
        loss = torch.nn.functional.cross_entropy(logits[0, :-1], toks[0, 1:])
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        torch.cuda.synchronize()
        runs.append((1e3 * (time.perf_counter() - t0), ev[0].elapsed_time(ev[1]),
                     ev[1].elapsed_time(ev[2])))
        del logits, loss
    step_ms, fwd_ms, bwd_ms = (statistics.median(r[k] for r in runs[1:]) for k in range(3))
    split = {}
    with backward_timers(split):
        step()
    gnorm2 = sum(float(g.float().pow(2).sum()) for g in grads)
    lr = TRAIN_DECREASE * float(loss0) / gnorm2
    master = [t.detach().float() for t in leaves]
    losses = [float(loss0)]
    for _ in range(TRAIN_STEPS):
        with torch.no_grad():
            for t, m, g in zip(leaves, master, grads):
                m -= lr * g.float()
                t.copy_(m)
        loss, grads = step()
        losses.append(float(loss))
    out = dict(counts=counts, loss=losses[0], worst_rel=worst, step_ms=step_ms, forward_ms=fwd_ms,
               backward_ms=bwd_ms, runs_ms=runs, tokens_per_s=TRAIN_TOKENS / step_ms * 1e3,
               peak_gb=peak_gb, peak_above_model_gb=above_gb, plain_peak_gb=plain_peak_gb,
               backward_attention_ms=split["attention"], backward_linears_ms=split["linears"],
               sgd_lr=lr, sgd_losses=losses, adapter_tensors=len(leaves))
    print(f"  lora_train b=1 x {TRAIN_TOKENS}: {len(leaves)} adapter tensors of {cfg.num_layers} "
          f"layers, gradients within {worst:.3e} of the plain path's (tol "
          f"{TRAIN_TOL}); loss {losses[0]:.4f}")
    print(f"  lora_train: {step_ms:.2f} ms a forward + backward, {fwd_ms:.2f} ms of device time "
          f"from the start to the loss, {bwd_ms:.2f} from the loss to the gradients (medians of 3 "
          f"after a warm-up: {[['%.2f' % v for v in r] for r in runs]}), "
          f"{out['tokens_per_s']:.0f} training tokens/s; peak "
          f"{peak_gb:.2f} GB ({above_gb:.2f} above the {held / 1e9:.2f} GB held), the plain "
          f"path's {plain_peak_gb:.2f} GB")
    print(f"  lora_train: the backward's attention {split['attention']:.2f} ms, its linears "
          f"{split['linears']:.2f} ms (CUDA events around each call of their backward, one step)")
    print(f"  lora_train: {TRAIN_STEPS} SGD steps at lr {lr:.3e}: losses "
          f"{['%.4f' % v for v in losses]}")
    check(losses[-1] < losses[0], f"lora_train: SGD did not lower the loss: {losses}")
    check(torch.equal(twin.layers[-1].o_lora.lora_b, bank_b), "lora_train moved the bank")
    return out


def lora_phase(dev) -> dict:
    """MODEL W8A16 at full width cut to LORA_LAYERS: perplexity of the bf16 model and
    the W8A16 one, the epilogue's entry point, then multi-adapter LoRA (a
    bank of LORA_ADAPTERS, `surgery.stack_adapters`): prefill, a training
    step of one adapter, three servers, the side path's cost a decode step
    and a merge."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params
    from eetq_tpu_torch.serve.generate import greedy_generate

    cfg = dataclasses.replace(PRESETS[MODEL], num_layers=LORA_LAYERS)
    print(f"  {MODEL} cut to {LORA_LAYERS} layers of {PRESETS[MODEL].num_layers}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    dense = random_dense_params(cfg, gen)
    base = quantize_params(dense, quantize_lm_head=True)
    # eval_ppl and lora_train draw from generators of their own, so the
    # phase's generator gives the other paths the draws it gave without them
    paths = {"eval_ppl": eval_ppl_path(dense, base, cfg, dev,
                                       torch.Generator(device=dev).manual_seed(SEED + 18))}
    del dense
    torch.cuda.empty_cache()
    paths["epilogue_linear"] = epilogue_linear_path(base, cfg, dev, gen)
    bank, twins = lora_bank(base, cfg, gen)
    bank_gb = sum(ad.lora_a.numel() * 2 + ad.lora_b.numel() * 2 for lp in bank.layers
                  for ad in (lp.qkv_lora, lp.o_lora)) / 1e9
    print(f"  {MODEL}: a bank of {LORA_ADAPTERS} adapters of rank {LORA_RANK} on qkv and o_proj "
          f"({bank_gb:.3f} GB, B ~ N(0, {LORA_B_STD}^2), scaling {LORA_ALPHA / LORA_RANK})")
    paths["lora_prefill"] = lora_prefill_path(bank, twins, base, cfg, dev, gen)
    paths["lora_train"] = lora_train_path(twins[0], cfg, dev,
                                          torch.Generator(device=dev).manual_seed(SEED + 19))
    torch.cuda.empty_cache()
    side = side_path_cost(bank, base, cfg, dev)
    bodies = lora_requests(cfg, dev, gen)
    twin_tokens = {}
    for kv in (torch.int8, torch.bfloat16):
        twin_tokens[kv] = [greedy_generate(twins[b["lora_id"]], cfg, torch.tensor([b["prompt"]],
                                                                                   device=dev),
                                           b["max_new_tokens"], kv_dtype=kv)[0].tolist()
                           for b in bodies]
    base_tokens = [greedy_generate(base, cfg, torch.tensor([b["prompt"]], device=dev),
                                   b["max_new_tokens"], kv_dtype=torch.int8)[0].tolist()
                   for b in bodies]
    paged = dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE)
    for path, kw, kv in (("lora_server", {}, torch.int8),
                         ("lora_paged_server", dict(paged, kv_dtype=torch.bfloat16),
                          torch.bfloat16),
                         ("lora_spec_server", dict(spec_ngram=LORA_SPEC_K), torch.int8)):
        paths[path] = lora_server_path(bank, twins, base, cfg, dev, path, kw, bodies,
                                       twin_tokens[kv])
    # each adapter moves some request's greedy tokens off the base model's
    served = paths["lora_server"]["results"]
    moved = {a: sum(served[i] != base_tokens[i] for i, b in enumerate(bodies)
                    if b["lora_id"] == a) for a in range(LORA_ADAPTERS)}
    print(f"  requests whose tokens an adapter moved off the base model's, by adapter: {moved}")
    check(all(moved.values()), f"an adapter moved no request off the base model: {moved}")
    paths["lora_merge"] = lora_merge_path(bank, twins, base, cfg, dev, gen)
    for path in ("lora_server", "lora_paged_server", "lora_spec_server"):
        paths[path].pop("results")
    return dict(paths=paths, bank_gb=bank_gb, side_path=side, moved=moved,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


# The tooling phase: the host quantizer (`native/`) on llama2-7b's gate|up
# (NATIVE_SHAPE; f32 and bf16, per-channel and g = NATIVE_GROUP, int4
# packed), `utils/profiling.py` at llama2-7b's four layer shapes
# (PROFILE_ROWS; device_time within DEVICE_TIME_AGREE of time_many_ms, no
# fraction of the roof above ROOF_SLACK), the measured autotune, and the
# offline tensor-parallel reshard: llama2-7b quantized for TP ranks
# (tp_generate, tp_checkpoint) and layer 0 at each of TP_RANKS run one rank
# at a time (tp_ranks).
NATIVE_SHAPE, NATIVE_GROUP = (4096, 22016), 128
PROFILE_ROWS = (1, 1024)
DEVICE_TIME_AGREE, ROOF_SLACK = 0.10, 1.05
# Launches inside the `trace` check: the profiler has been seen to drop a
# kernel event now and then (ROADMAP.md queue 3), and after the lora phase's
# profiled steps it once showed none of a single launch
TRACE_CALLS = 20
TP = 2
TP_RANKS = ((2, 8), (4, 8), (8, 8), (2, 4))  # (tp, bits)
TP_RANK_ROWS = (1, 1024)
# The autotune: llama2-7b's four projections at the decode GEMV's m (b=1 and
# an 8-slot step) and the GEMM's rows; a tuned choice may not be slower than
# the rule by more than AUTOTUNE_SLOWER when the two are re-read in turns
AUTOTUNE_BATCHES = (1, 8)
AUTOTUNE_GEMM_ROWS = (256, 512, 1024)
AUTOTUNE_SLOWER = 1.03
_TP_PATH = ("w8a16_gemv", "w8a16_gemm", "w8a16_gemv[group]", "w8a16_gemm[group]",
            "flash_attention_fwd", "flash_decode")
PATH_KERNELS.update({"tp_generate": _TP_PATH, "tp_checkpoint": _TP_PATH})


def native_path(dev) -> dict:
    """`native.host_symmetric_quantize` of NATIVE_SHAPE on the host against
    `quant/quantizer.py::symmetric_quantize` on the card (bit-equal), f32
    and bf16, per-channel and group-wise; int4 g = NATIVE_GROUP packed by
    `native.host_pack_int4` against `layout/tiling.py::pack_weights`."""
    import torch

    from eetq_tpu_torch import native
    from eetq_tpu_torch.layout.tiling import pack_weights
    from eetq_tpu_torch.quant.quantizer import symmetric_quantize

    check(native.native_available(), "the native quantizer did not load")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    w32 = (torch.randn(NATIVE_SHAPE, generator=gen, device=dev) * 0.02).cpu()
    out = []
    for dtype, bits, group in ((torch.float32, 8, None), (torch.bfloat16, 8, None),
                               (torch.float32, 8, NATIVE_GROUP), (torch.bfloat16, 8, NATIVE_GROUP),
                               (torch.bfloat16, 4, NATIVE_GROUP)):
        w = w32.to(dtype)
        t0 = time.perf_counter()
        q, sc = native.host_symmetric_quantize(w, bits=bits, group_size=group)
        sec = time.perf_counter() - t0
        qd, sd = symmetric_quantize(w.to(dev), bits=bits, group_size=group)
        equal = torch.equal(q, qd.cpu()) and torch.equal(sc, sd.cpu())
        case = f"{str(dtype)[6:]} int{bits} {'per-channel' if group is None else f'g={group}'}"
        gbs = w.numel() * w.element_size() / sec / 1e9
        print(f"  host_symmetric_quantize {list(NATIVE_SHAPE)} {case}: {sec:.4f} s "
              f"({gbs:.2f} GB/s of weights, {os.cpu_count()} host cores); bit-equal to the card's "
              f"symmetric_quantize: {equal}")
        check(equal, f"host_symmetric_quantize {case} differs from symmetric_quantize")
        row = dict(case=case, seconds=sec, gb_s=gbs)
        if bits == 4:
            t0 = time.perf_counter()
            packed = native.host_pack_int4(q)
            row["pack_seconds"] = time.perf_counter() - t0
            same = torch.equal(packed, pack_weights(qd, bits=4).data.cpu())
            print(f"  host_pack_int4: {row['pack_seconds']:.4f} s; equal to pack_weights(bits=4): "
                  f"{same}")
            check(same, "host_pack_int4 differs from pack_weights(bits=4)")
        out.append(row)
    return dict(cases=out)


def profiling_path(dev) -> dict:
    """`utils/profiling.py` on the card: profile_w8a16_matmul at llama2-7b's
    four layer shapes (no fraction of the roof above ROOF_SLACK), device_time
    against time_many_ms on the same calls in turns, host_sync_overhead, and
    a trace written and read back."""
    import tempfile

    import torch

    from eetq_tpu_torch.layout.tiling import pack_weights
    from eetq_tpu_torch.ops.linear import w8a16_matmul
    from eetq_tpu_torch.quant.quantizer import symmetric_quantize
    from eetq_tpu_torch.utils.profiling import (
        device_time,
        host_sync_overhead,
        profile_w8a16_matmul,
        trace,
    )

    reports = []
    for m in PROFILE_ROWS:
        for k, n in LLAMA_SHAPES[:4]:
            r = profile_w8a16_matmul(m, k, n, device=dev)
            print(f"  profile_w8a16_matmul m={m} K={k} N={n}: {r}")
            check(r.fraction_of_roof <= ROOF_SLACK,
                  f"profile_w8a16_matmul m={m} K={k} N={n}: {r.fraction_of_roof:.3f} of the roof")
            reports.append(dict(m=m, k=k, n=n, **dataclasses.asdict(r)))
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    agree = []
    for m, (k, n) in ((1, LLAMA_SHAPES[1]), (1024, LLAMA_SHAPES[2])):
        q, sc = symmetric_quantize(torch.randn(k, n, generator=gen, device=dev))
        pw = pack_weights(q)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        fn = functools.partial(w8a16_matmul, x, pw, sc)
        single = time_ms(fn)
        iters = max(20, min(2000, int(2.0 / max(single, 1e-3)) + 1))  # as time_many_ms
        got = {"device_time": [], "time_many_ms": []}
        for name in ("device_time", "time_many_ms", "time_many_ms", "device_time"):
            got[name].append(1e3 * device_time(fn, iters=iters, reps=1, device=dev)
                             if name == "device_time" else time_many_ms(fn, single))
        a, b = (statistics.median(v) for v in got.values())
        print(f"  m={m} K={k} N={n}: device_time {a:.4f} ms, time_many_ms {b:.4f} ms "
              f"({iters} launches a graph, in turns)")
        check(abs(a - b) <= DEVICE_TIME_AGREE * b, f"device_time and time_many_ms disagree at "
                                                   f"m={m} K={k} N={n}: {a:.4f} vs {b:.4f} ms")
        agree.append(dict(m=m, k=k, n=n, device_time_ms=a, time_many_ms=b, runs=got))
    sync_s = host_sync_overhead(device=dev)
    print(f"  host_sync_overhead: {1e6 * sync_s:.1f} us")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        path = os.path.join(d, "trace.json")
        with trace(path):
            for _ in range(TRACE_CALLS):
                fn()
            torch.cuda.synchronize()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print(f"  trace: {len(events)} events, {len(kernels)} kernel events on the card for "
          f"{TRACE_CALLS} launches")
    check(kernels, "the trace holds no kernel event of the card")
    return dict(reports=reports, agree=agree, host_sync_us=1e6 * sync_s,
                trace_kernel_events=len(kernels))


# Every flash-decode launch writes its output: DECODE_WRITTEN_CALLS launches
# of each entry point, dense and paged, bf16 and int8, at the 8-slot engine
# step's shape, each into a buffer of its own filled with NaN beforehand;
# the profiler's kernel events are counted beside the wrappers' counters
# (ROADMAP.md queue 3: a lost event and a skipped launch look alike to a
# trace, not to the buffers)
DECODE_WRITTEN_CALLS = 64


def decode_written_path(dev) -> dict:
    """DECODE_WRITTEN_CALLS launches of each flash-decode entry point under
    torch.profiler, each into its own NaN-filled `out`: every buffer must be
    written, bit-equal to the first and within TOL of the plain version,
    and the launch counter must read the count of calls; the profiler's
    kernel events are printed beside it, and not checked."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.kernels.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_int8_ref,
        flash_decode_ref,
        paged_flash_decode,
        paged_flash_decode_int8,
        paged_flash_decode_int8_ref,
        paged_flash_decode_ref,
    )
    from eetq_tpu_torch.kernels.w8a8 import quantize_activations

    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    (b, lmax), (hq, hkv, d, bs) = max(DECODE_REGIMES), (32, 32, 128, 256)
    lengths = torch.tensor(ENGINE_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, hq, d, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, lmax, d, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    (k8, ks), (v8, vs) = quantize_activations(k), quantize_activations(v)
    nb = lmax // bs
    perm = torch.randperm(b * nb, generator=gen, device=dev)
    table = perm.reshape(b, nb).to(torch.int32).contiguous()

    def pool(t):  # the dense rows' blocks at the table's pool blocks
        blocks = t.reshape(b, hkv, nb, bs, *t.shape[3:]).transpose(1, 2).reshape(
            b * nb, hkv, bs, *t.shape[3:])
        out = torch.empty_like(blocks)
        out[perm] = blocks
        return out.contiguous()

    pk, pv, pk8, pv8, pks, pvs = (pool(t) for t in (k, v, k8, v8, ks, vs))
    cases = {
        "flash_decode": (lambda o: flash_decode(q, k, v, lengths, out=o),
                         lambda: flash_decode_ref(q, k, v, lengths)),
        "flash_decode_int8": (lambda o: flash_decode_int8(q, k8, v8, ks, vs, lengths, out=o),
                              lambda: flash_decode_int8_ref(q, k8, v8, ks, vs, lengths)),
        "paged_flash_decode": (lambda o: paged_flash_decode(q, pk, pv, table, lengths, out=o),
                               lambda: paged_flash_decode_ref(q, pk, pv, table, lengths)),
        "paged_flash_decode_int8": (
            lambda o: paged_flash_decode_int8(q, pk8, pv8, pks, pvs, table, lengths, out=o),
            lambda: paged_flash_decode_int8_ref(q, pk8, pv8, pks, pvs, table, lengths)),
    }
    n, rows = DECODE_WRITTEN_CALLS, {}
    for name, (kernel, plain) in cases.items():
        ref = plain()
        outs = [torch.full_like(ref, float("nan")) for _ in range(n)]
        torch.cuda.synchronize()
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for o in outs:
                kernel(o)
            torch.cuda.synchronize()
        calls = launch_counts()[name]
        events = sum(ev.device_type == torch.autograd.DeviceType.CUDA
                     and "flash_decode" in ev.name for ev in prof.events())
        unwritten = sum(bool(torch.isnan(o.float()).any()) for o in outs)
        differ = sum(not torch.equal(o, outs[0]) for o in outs)
        err, scale = compare(outs[0], ref)
        print(f"  {name}: {n} launches into NaN-filled buffers: {n - unwritten} written, "
              f"{differ} differing from the first, max |err| {err:.3e} of {scale:.3e}; launch "
              f"counter {calls}, profiler kernel events {events}")
        check(not unwritten, f"{name}: {unwritten} of {n} launches left their buffer unwritten")
        check(not differ and calls == n, f"{name}: {differ} buffers differ, counter {calls}")
        check(err <= TOL * scale, f"{name} differs from its plain version by {err:.3e}")
        rows[name] = dict(calls=n, written=n - unwritten, counter=calls, profiler_events=events,
                          max_abs_err=err)
    return rows


def autotune_path(base, cfg, dev, gen) -> dict:
    """The measured autotune on llama2-7b's projections into the run's
    fresh cache file (`main`): every winner re-read against the rule in
    turns, the lookups reading the file back, and b=1 decode (bf16 KV, 50
    tokens) with the tuned cache against the rules (greedy tokens equal, or
    parting at a near tie; ms a replayed step, in turns). The file is
    removed at the end, so that no other path sees it."""
    import torch

    from eetq_tpu_torch.kernels import autotune
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    path = autotune.cache_path()
    check(not os.path.exists(path), f"the autotune cache {path} exists before the sweep")
    h, i = cfg.hidden_size, cfg.intermediate_size
    proj = [(h, cfg.qkv_out), (cfg.num_heads * cfg.head_dim, h), (h, 2 * i), (i, h)]
    t0 = time.perf_counter()
    tuned = autotune.autotune_shapes(
        [(m, k, n) for m in AUTOTUNE_BATCHES + AUTOTUNE_GEMM_ROWS for k, n in proj],
        verbose=False, device=dev)
    sweep_s = time.perf_counter() - t0
    check(os.path.exists(path), f"the sweep wrote no cache file at {path}")
    rows = []
    for key, t in tuned.items():
        m, rows_, np_, bits, group = t.shape
        reread = (autotune.time_candidates(m, rows_, np_, bits, group, (t.rule, t.choice),
                                           device=dev)
                  if t.choice != t.rule else {t.rule: t.ms[t.rule]})
        looked = (autotune.choose_gemv_splits(dev.index, rows_, np_, bits, m, group)
                  if t.what == "splits" else autotune.choose_gemm_tile(dev.index, m, rows_, np_,
                                                                       bits, group))
        print(f"  {key}: {t.what}={t.choice} {t.ms[t.choice]:.4f} ms in the sweep (the rule's "
              f"{t.rule}: {t.ms[t.rule]:.4f}); re-read in turns: {reread[t.choice]:.4f} ms "
              f"against the rule's {reread[t.rule]:.4f}; looked up: {looked}")
        check(reread[t.choice] <= AUTOTUNE_SLOWER * reread[t.rule],
              f"{key}: the tuned {t.what}={t.choice} is slower than the rule's {t.rule}")
        check(looked == t.choice, f"{key}: the lookup gives {looked}, the cache {t.choice}")
        rows.append(dict(key=key, what=t.what, choice=t.choice, rule=t.rule, sweep_ms=t.ms,
                         reread_ms=reread))
    print(f"  autotune: {len(tuned)} shapes swept in {sweep_s:.1f} s; "
          f"{sum(t.choice != t.rule for t in tuned.values())} differ from the rule")

    _, p, n = REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=gen, device=dev)
    untuned = os.path.join(os.path.dirname(path), "untuned.json")  # never written

    def decode(cache: str):
        os.environ["EETQ_AUTOTUNE_CACHE"] = cache
        autotune.clear_caches()
        caches = init_caches(cfg, 1, p + n, device=dev, dtype=torch.bfloat16)
        lp, caches = prefill(base, cfg, prompt, caches)
        rec = {}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, _ = decode_loop(base, cfg, torch.argmax(lp, -1), p, caches, n, stats=rec)
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t1)
        return toks, (total - rec["warm_ms"] - rec["capture_ms"]) / (n - 2)

    runs = {path: [], untuned: []}
    toks = {}
    for cache in (untuned, path, path, untuned):
        got, ms = decode(cache)
        toks.setdefault(cache, got)
        runs[cache].append(ms)
    os.environ["EETQ_AUTOTUNE_CACHE"] = path
    autotune.clear_caches()
    equal = bool(torch.equal(toks[path], toks[untuned]))
    tie = None
    if not equal:
        j = int((toks[path] != toks[untuned]).any(0).nonzero()[0])
        ids = prompt[0].tolist() + toks[untuned][0, :j].tolist()
        tie = near_tie(base, cfg, dev, ids, int(toks[path][0, j]), int(toks[untuned][0, j]))
        print(f"  tuned decode parts from the rules' at token {j}: {tie}")
        check(tie["logit_tie"], f"the tuned decode parts from the rules' at token {j}, not at "
                                "a near tie")
    runs = {"tuned": runs[path], "rule": runs[untuned]}
    ms = {name: statistics.median(v) for name, v in runs.items()}
    print(f"  decode b=1 p={p}, {n} tokens: tuned {ms['tuned']:.3f} ms a replayed step, the rules "
          f"{ms['rule']:.3f} (in turns: {runs}); greedy tokens equal: {equal}")
    os.remove(path)
    autotune.clear_caches()
    return dict(shapes=rows, sweep_s=sweep_s, decode_ms=ms, decode_runs=runs,
                tokens_equal=equal, near_tie=tie)


def tp_ranks_path(dense, cfg, dev, gen) -> dict:
    """Layer 0 of the dense model at each (tp, bits) of TP_RANKS through
    `quantize_params_tp`, then each rank's shard from the split functions
    through the kernels one rank at a time (m of TP_RANK_ROWS): the column
    shards (qkv, gate|up) against the merged layer's output split the same
    way, the row shards' partials (o_proj, down; x split along K) summed in
    f32, the bias added once by rank 0, against the merged layer, all within
    MODEL_TOL of the largest output. On one card this stands in for the
    all-reduce of a sharded model."""
    import torch

    from eetq_tpu_torch.dist import split_gateup_columns, split_qkv_columns
    from eetq_tpu_torch.models.transformer import ModelParams
    from eetq_tpu_torch.ops.linear import w8a16_matmul
    from eetq_tpu_torch.surgery.tp_reshard import (
        _split_quant_columns_grouped,
        quantize_params_tp,
        split_quant_rows,
    )

    def run(ql, x):
        return w8a16_matmul(x, ql.packed, ql.scales, ql.bias)

    one = ModelParams(dense.embed, [dense.layers[0]], dense.final_norm, dense.lm_head)
    out = []
    for tp, bits in TP_RANKS:
        lp = quantize_params_tp(one, cfg, tp, bits=bits).layers[0]
        worst = 0.0
        for name in ("qkv", "gateup", "o_proj", "down"):
            ql = getattr(lp, name)
            col = name in ("qkv", "gateup")
            shards = (_split_quant_columns_grouped(ql, cfg, tp, name) if col
                      else split_quant_rows(ql, tp))
            for m in TP_RANK_ROWS:
                x = torch.randn(m, ql.k, generator=gen, device=dev).to(torch.bfloat16)
                merged = run(ql, x)
                if col:
                    split = (split_qkv_columns(merged, cfg, tp) if name == "qkv"
                             else split_gateup_columns(merged, tp))
                    got = torch.cat([run(sh, x) for sh in shards], -1).float()
                    want = torch.cat(split, -1).float()
                else:
                    xs = torch.chunk(x, tp, dim=-1)
                    got = sum(run(sh, xi.contiguous()).float() for sh, xi in zip(shards, xs))
                    want = merged.float()
                check(bool(torch.isfinite(got).all()), f"tp_ranks {name} is not finite")
                rel = ((got - want).abs().max() / want.abs().max()).item()
                worst = max(worst, rel)
                check(rel <= MODEL_TOL, f"tp_ranks tp={tp} int{bits} {name} m={m}: the ranks "
                                        f"part from the merged layer by {rel:.3e}")
        groups = (tuple(lp.o_proj.scales.shape), tuple(lp.down.scales.shape))
        print(f"  tp_ranks tp={tp} int{bits}: o_proj and down scales {groups[0]}, {groups[1]}; "
              f"the {tp} ranks against the merged layer at m = {TP_RANK_ROWS}: at most "
              f"{worst:.3e} of the largest output (tol {MODEL_TOL})")
        out.append(dict(tp=tp, bits=bits, scales=groups, max_rel_err=worst))
    return dict(cases=out)


def tooling_phase(dev) -> dict:
    """native_path, profiling_path, then llama2-7b at full width and depth
    built dense from the seed and quantized twice: `EETQCausalLM.quantize(
    tp=TP)` (o_proj and down group-wise at K / TP) and tp = 1 (per-channel),
    both with the dense lm_head: tp_generate (generate's b=1 path on the tp
    model: prefill and a decode step against the plain path, decode_loop
    against eager steps, 50 tokens; its prefill logits' largest gap to the tp
    = 1 model printed), tp_checkpoint (its round trip, `config.json`
    recording tp), the autotune on the tp = 1 model, and tp_ranks."""
    import torch

    from eetq_tpu_torch.models.auto import EETQCausalLM
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_dense_params
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import prefill
    from eetq_tpu_torch.surgery.tp_reshard import quantize_params_tp

    out = dict(native=native_path(dev), profiling=profiling_path(dev),
               decode_written=decode_written_path(dev))
    cfg = PRESETS[MODEL]
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    dense = random_dense_params(cfg, gen)
    model = EETQCausalLM(cfg, dense).quantize(tp=TP)
    base = quantize_params_tp(dense, cfg, 1)
    torch.cuda.synchronize()
    check(tuple(model.params.layers[0].o_proj.scales.shape) == (TP, cfg.hidden_size)
          and tuple(model.params.layers[0].down.scales.shape) == (TP, cfg.hidden_size)
          and model.params.layers[0].qkv.scales.dim() == 1, "quantize(tp) scale shapes")
    paths = generate_paths(model.params, cfg, dev, gen, {"tp_generate": (torch.bfloat16, False)},
                           requests=REQUESTS[:1])
    # o_proj and down, group-wise: 2 a layer in the prefill and in each of
    # the n - 1 decode steps
    counts, n = paths["tp_generate"]["counts"], REQUESTS[0][2]
    want = {"w8a16_gemm[group]": 2 * cfg.num_layers,
            "w8a16_gemv[group]": 2 * cfg.num_layers * (n - 1)}
    check(all(counts[k] == v for k, v in want.items()),
          f"tp_generate: group-wise launches {[counts[k] for k in want]}, want {want}")
    prompt = torch.randint(0, cfg.vocab_size, (1, REQUESTS[0][1]), generator=gen, device=dev)
    lg = [prefill(p, cfg, prompt, init_caches(cfg, 1, prompt.shape[1], device=dev))[0].float()
          for p in (model.params, base)]
    gap = ((lg[0] - lg[1]).abs().max() / lg[1].abs().max()).item()
    print(f"  tp_generate: prefill logits of the tp={TP} model against the tp=1 model: largest "
          f"gap {gap:.4e} of the largest logit")
    paths["tp_generate"]["tp1_gap"] = gap
    paths["tp_checkpoint"] = round_trip(model.params, cfg, dev, gen, "tp_checkpoint",
                                        torch.bfloat16, False, None, tp=TP)
    out["autotune"] = autotune_path(base, cfg, dev, gen)
    out["tp_ranks"] = tp_ranks_path(dense, cfg, dev, gen)
    return dict(out, paths=paths, peak_gb=torch.cuda.max_memory_allocated() / 1e9)

# The sharded phase: tensor and expert parallelism over SHARDED_TP ranks that
# this script spawns (`eetq_tpu_torch/dist/launch.py`), each a process
# holding its shard: NCCL on cuda:rank where the machine has a card for each
# rank, else gloo with both ranks on cuda:0. A gloo collective on a CUDA
# tensor is staged through the host, so the ranks' steps run eagerly, and
# their times model no NVLink deployment.
SHARDED_TP = 2
SHARDED_SPEC_K = 7
SHARDED_MIXTRAL_LAYERS = 2
# tp2_generate and its engines run llama2-7b cut to this depth: every
# collective is staged through the host and every step is eager, and at
# full depth the two eager engines alone took about a minute (the split and
# its collectives are the same in every layer); 8 layers until the presets
# phase needed the run's time (4 layers: 22.7 s in the tp2 ranks, 33.3 s in
# the dp2tp2 ranks)
SHARDED_LLAMA_LAYERS = 2
SHARDED_MIXTRAL_NEW = 16
SHARDED_TIMEOUT_S = 600
# the dp paths: dp 2 x tp 2 ranks of the same artifact, the server's
# heartbeat while idle
SHARDED_DP = 2
SHARDED_HEARTBEAT_S = 1.0
_TP2 = ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode")
PATH_KERNELS.update({"tp2_generate": _TP2, "tp2_server": _TP2, "tp2_spec_server": _TP2,
                     "mixtral_ep2": ("w8a16_expert_gemv", "w8a16_grouped_gemm") + _TP2,
                     "dp2tp2_generate": _TP2, "dp2tp2_server": _TP2,
                     "dp2tp2_spec_server": _TP2})


def _server_requests(cfg, gen, dev) -> list:
    """server_path's mix: SERVE_REQUESTS requests of SERVE_LENGTHS prompts and
    SERVE_BUDGETS budgets, requests 3 and 8 sampled; (prompt, budget, keywords)."""
    import torch

    lengths = [SERVE_LENGTHS[i] for i in torch.randint(
        0, len(SERVE_LENGTHS), (SERVE_REQUESTS,), generator=gen, device=dev).tolist()]
    budgets = [SERVE_BUDGETS[i] for i in torch.randint(
        0, len(SERVE_BUDGETS), (SERVE_REQUESTS,), generator=gen, device=dev).tolist()]
    return [(torch.randint(0, cfg.vocab_size, (p,), generator=gen, device=dev).tolist(), b,
             dict(temperature=0.8, top_k=40) if i in (3, 8) else {})
            for i, (p, b) in enumerate(zip(lengths, budgets))]


def _rank_counts():
    """This rank's launch and collective counters, both set to 0."""
    from eetq_tpu_torch.dist.sharding import reset_collective_counts
    from eetq_tpu_torch.kernels import reset_launch_counts

    reset_launch_counts()
    reset_collective_counts()


def _rank_read():
    import torch

    from eetq_tpu_torch.dist.sharding import collective_counts
    from eetq_tpu_torch.kernels import launch_counts

    torch.cuda.synchronize()
    return launch_counts(), collective_counts()


def _rank_engine(model, requests: list, **kw) -> dict:
    """The requests through Engine(model, max_batch=8, max_len=2048, **kw),
    counted and timed on this rank."""
    import torch

    from eetq_tpu_torch.serve.engine import Engine

    eng = Engine(model, max_batch=8, max_len=2048, **kw)
    uids = [eng.add_request(p, n, **k) for p, n, k in requests]
    _rank_counts()
    t0 = time.perf_counter()
    eng.run()
    counts, coll = _rank_read()
    wall = time.perf_counter() - t0
    out = dict(outputs=[eng.result(u) for u in uids], counts=counts, collectives=coll,
               wall_s=wall, kv=str(eng.kv_dtype), a8=eng.a8_prefill, window=eng.decode_window,
               spec_rounds=eng.spec_rounds, spec_tokens=eng.spec_tokens)
    del eng
    torch.cuda.empty_cache()
    return out


def _rank_llama(mesh, path: str, prompt, ref_tokens, requests: list) -> dict:
    """A rank of tp2_generate, tp2_server and tp2_spec_server:
    `from_quantized(path).shard(mesh)`, then (teacher-forced on the tp = 1
    run's tokens) the prefill's and every decode step's logits and the
    collectives of one forward; then, counted from 0, the prefill and
    len(ref_tokens) greedy tokens, timed; then the server's requests through
    the sharded engine and through its spec twin (k = SHARDED_SPEC_K)."""
    import torch

    from eetq_tpu_torch.dist.sharding import make_forward_fn
    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM
    from eetq_tpu_torch.utils.profiling import count_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    t0 = time.perf_counter()
    full = AutoEETQForCausalLM.from_quantized(path, device=dev)
    model = full.shard(mesh=mesh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out = dict(backend=mesh.backend, device=str(dev), load_s=time.perf_counter() - t0,
               shard_gb=sum(b.numel() * b.element_size() for b in model.params.buffers()) / 1e9,
               o_proj_scales=tuple(model.params.layers[0].o_proj.scales.shape))
    p, n = prompt.shape[1], ref_tokens.shape[1]
    toks = prompt.to(dev)
    pos = torch.arange(p, device=dev)[None]
    fwd = make_forward_fn(model)

    def step(tok, j, caches):
        lg, _ = fwd(model.params, tok.view(1, 1), torch.full((1, 1), p + j, device=dev), caches,
                    p + j)
        return lg[0, -1]

    with torch.inference_mode():
        caches = model.init_caches(1, p + n)
        got = {}
        out["prefill_collectives"] = count_collectives(lambda: got.setdefault(
            "lg", fwd(model.params, toks, pos, caches, 0, last_only=True)[0]))
        out["prefill_logits"] = got["lg"][0, -1].float().cpu()
        ref = ref_tokens.to(dev)
        tf = [step(ref[:, j], j, caches).float().cpu() for j in range(n - 1)]
        out["decode_logits"] = torch.stack(tf)
        caches = model.init_caches(1, p + n)
        _rank_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = fwd(model.params, toks, pos, caches, 0, last_only=True)
        tok = torch.argmax(lg[0, -1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen = [tok]
        for j in range(n - 1):
            tok = torch.argmax(step(tok, j, caches))
            gen.append(tok)
        counts, coll = _rank_read()
        t2 = time.perf_counter()
    out.update(tokens=torch.stack(gen).cpu().tolist(), counts=counts, collectives=coll,
               prefill_ms=1e3 * (t1 - t0), decode_ms=1e3 * (t2 - t1) / (n - 1))
    del caches
    out["server"] = _rank_engine(model, requests)
    out["spec_server"] = _rank_engine(model, requests, spec_ngram=SHARDED_SPEC_K)
    return out


def _rounds(eng) -> list:
    """The engine's admission rounds, each its count of requests, as they run."""
    eng.rounds = []
    group = eng._prefill_group

    def counted(assignments):
        eng.rounds.append(len(assignments))
        return group(assignments)

    eng._prefill_group = counted
    return eng.rounds


def _rank_http(mesh, model, bodies: list) -> dict:
    """dp2tp2_server on this rank: `EngineServer` over Engine(model) on rank
    0, the bodies posted from SERVE_THREADS threads (each answer by body),
    and `serve.api.follow` elsewhere; counted from 0 on every rank."""
    import torch

    from eetq_tpu_torch.serve.api import EngineServer, follow
    from eetq_tpu_torch.serve.engine import Engine

    eng = Engine(model, max_batch=8, max_len=2048)
    rounds = _rounds(eng)
    out = dict(kv=str(eng.kv_dtype), a8=eng.a8_prefill, window=eng.decode_window)
    _rank_counts()
    if mesh.rank != 0:
        out["follow"] = follow(eng)
    else:
        srv = EngineServer(eng, port=0, heartbeat_s=SHARDED_HEARTBEAT_S)
        srv.start()
        answers, errors = {}, []

        def worker(idx):
            for i in idx:
                try:
                    answers[i] = _post(srv.port, bodies[i])
                except Exception as e:  # reported by the parent, fails the run
                    errors.append(f"request {i}: {e!r}")
                    return

        threads = [threading.Thread(target=worker, args=(range(j, len(bodies), SERVE_THREADS),))
                   for j in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(SERVE_TIMEOUT_S)
            out["wall_s"] = time.perf_counter() - t0
        finally:
            srv.shutdown()
        out.update(answers=[answers.get(i) for i in range(len(bodies))], errors=errors)
    counts, coll = _rank_read()
    out.update(counts=counts, collectives=coll, rounds=list(rounds),
               outputs={u: list(r.out_tokens) for u, r in eng.requests.items()})
    del eng
    torch.cuda.empty_cache()
    return out


def _rank_dp(mesh, path: str, prompts, ref_tokens, bodies: list, requests: list) -> dict:
    """A rank of dp2tp2_generate, dp2tp2_server and dp2tp2_spec_server: its
    shard of the tp2 artifact on the dp x tp mesh; then (teacher-forced on
    the tp = 1 run's tokens) its data shard's prefill and decode logits and
    the collectives of one prefill forward; then, counted from 0, the
    prefill and len(ref_tokens) greedy tokens of its row, gathered over
    `data` at the end; then the server (`_rank_http`) and the spec engine
    driven directly (`_rank_engine`)."""
    import torch

    from eetq_tpu_torch.dist.sharding import make_forward_fn, make_mesh
    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM
    from eetq_tpu_torch.utils.profiling import count_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    dpm = make_mesh(tp=SHARDED_TP, dp=SHARDED_DP, device=mesh.device)
    dev = dpm.device
    t0 = time.perf_counter()
    full = AutoEETQForCausalLM.from_quantized(path, device=dev)
    model = full.shard(mesh=dpm)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out = dict(backend=dpm.backend, device=str(dev), load_s=time.perf_counter() - t0,
               place=(dpm.dp_rank, dpm.tp_rank))
    (b, p), n = prompts.shape, ref_tokens.shape[1]
    rows = dpm.data_rows(b)
    toks = prompts.to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    fwd = make_forward_fn(model)

    def step(col, j, caches):  # col [B]: the global batch's tokens, this shard's rows read
        lg, _ = fwd(model.params, col.view(b, 1), torch.full((b, 1), p + j, device=dev), caches,
                    p + j)
        return lg[:, -1]

    with torch.inference_mode():
        caches = model.init_caches(b, p + n)
        got = {}
        out["prefill_collectives"] = count_collectives(lambda: got.setdefault(
            "lg", fwd(model.params, toks, pos, caches, 0, last_only=True)[0]))
        out["prefill_logits"] = got["lg"][:, -1].float().cpu()
        ref = ref_tokens.to(dev)
        out["decode_logits"] = torch.stack([step(ref[:, j], j, caches).float().cpu()
                                            for j in range(n - 1)])
        caches = model.init_caches(b, p + n)
        _rank_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = fwd(model.params, toks, pos, caches, 0, last_only=True)
        col = torch.zeros(b, dtype=torch.int64, device=dev)
        col[rows] = torch.argmax(lg[:, -1], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen = [col[rows].clone()]
        for j in range(n - 1):
            col[rows] = torch.argmax(step(col, j, caches), dim=-1)
            gen.append(col[rows].clone())
        tokens = dpm.gather_rows(torch.stack(gen, dim=1))  # the run's one fetch
        counts, coll = _rank_read()
        t2 = time.perf_counter()
    out.update(tokens=tokens.cpu(), counts=counts, collectives=coll, prefill_ms=1e3 * (t1 - t0),
               decode_ms=1e3 * (t2 - t1) / (n - 1))
    del caches
    out["server"] = _rank_http(dpm, model, bodies)
    eng_out = _rank_engine(model, requests, spec_ngram=SHARDED_SPEC_K)
    out["spec_server"] = eng_out
    return out


def _dp_llama(dev, work: str, backend: str, art: str, cfg, params, prompt, gen, requests: list,
              twin_out: dict) -> dict:
    """dp2tp2_generate, dp2tp2_server and dp2tp2_spec_server (sharded_phase),
    over the tp2 artifact, its tp = 1 twin `params`, tp2_generate's prompt
    (row 0) and the server's requests and the twin engine's outputs."""
    import torch

    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.transformer import forward_inner, init_caches

    _, p, n = REQUESTS[0]
    b, world = SHARDED_DP, SHARDED_DP * SHARDED_TP
    prompts = torch.cat([prompt, torch.randint(0, cfg.vocab_size, (1, p), generator=gen,
                                               device=dev)])
    with torch.inference_mode():  # the tp = 1 run at b = 2
        caches = init_caches(cfg, b, p + n, device=dev)
        lg, _ = forward_inner(params, cfg, prompts, torch.arange(p, device=dev).expand(b, p),
                              caches, 0, last_only=True)
        ref = [lg[:, -1].float()]
        toks = [torch.argmax(ref[-1], dim=-1)]
        for j in range(n - 1):
            lg, _ = forward_inner(params, cfg, toks[-1][:, None],
                                  torch.full((b, 1), p + j, device=dev), caches, p + j)
            ref.append(lg[:, -1].float())
            toks.append(torch.argmax(ref[-1], dim=-1))
        del caches
    ref_tokens, refs = torch.stack(toks, dim=1), torch.stack(ref).cpu()  # [b, n], [n, b, V]
    bodies = [dict({"prompt": pr, "max_new_tokens": nb, "stream": i % 5 == 1}, **kw)
              for i, (pr, nb, kw) in enumerate(requests)]
    greedy = [i for i, (_, _, kw) in enumerate(requests) if not kw]
    t0 = time.perf_counter()
    with RankPool(world, f"file://{os.path.join(work, 'rdv-dp')}", backend=backend,
                  timeout_s=SHARDED_TIMEOUT_S) as pool:
        res = pool.run(_rank_dp, art, prompts.cpu(), ref_tokens.cpu(), bodies, requests)
    ranks_s = time.perf_counter() - t0
    r0, paths = res[0], {}
    check([r["place"] for r in res] == [(i // SHARDED_TP, i % SHARDED_TP) for i in range(world)],
          "dp2tp2: the ranks' places on the mesh")
    print(f"  dp2tp2: {world} ranks (dp {SHARDED_DP} x tp {SHARDED_TP}) over {r0['backend']} on "
          f"{sorted(set(r['device'] for r in res))}, each loaded and sharded the artifact in "
          f"{max(r['load_s'] for r in res):.1f} s at most; {ranks_s:.1f} s in the ranks")
    for r in res:
        mate = res[r["place"][0] * SHARDED_TP]
        check(torch.equal(r["prefill_logits"], mate["prefill_logits"])
              and torch.equal(r["decode_logits"], mate["decode_logits"]),
              "dp2tp2_generate: the ranks of a data shard differ")
        check(torch.equal(r["tokens"], r0["tokens"])
              and r["server"]["outputs"] == r0["server"]["outputs"]
              and r["spec_server"]["outputs"] == r0["spec_server"]["outputs"],
              "dp2tp2: the ranks' tokens or outputs differ")
    # dp2tp2_generate: each data shard's row against the tp = 1 run at b = 2
    pre = [check_logits(f"dp2tp2_generate row {d} prefill (tp=1 run)",
                        res[d * SHARDED_TP]["prefill_logits"][0], refs[0, d])
           for d in range(SHARDED_DP)]
    dec_err = max(((a - c).abs().max() / c.abs().max()).item()
                  for d in range(SHARDED_DP)
                  for a, c in zip(res[d * SHARDED_TP]["decode_logits"][:, 0], refs[1:, d]))
    print(f"  dp2tp2_generate teacher-forced decode logits vs the tp=1 run: at most "
          f"{dec_err:.4e} of the largest logit over {n - 1} steps and {b} rows (tol {MODEL_TOL})")
    check(dec_err <= MODEL_TOL, f"dp2tp2_generate decode logits differ by {dec_err:.3e}")
    ties = []
    for d in range(b):
        got_d, want = r0["tokens"][d].tolist(), ref_tokens[d].tolist()
        j = _first_difference(got_d, want)
        if j is None:
            continue
        rr = res[d * SHARDED_TP]
        rows = (refs[j, d], rr["prefill_logits"][0] if j == 0 else rr["decode_logits"][j - 1, 0])
        tie = all(_logit_tie(row, got_d[j], want[j]) for row in rows)
        print(f"  dp2tp2_generate row {d}: token {j} is {got_d[j]}, the tp=1 run's {want[j]} "
              f"(near tie: {tie})")
        check(tie, f"dp2tp2_generate row {d} differs from the tp=1 run at {j}, not at a near tie")
        ties.append(dict(row=d, token=j))
    h, v, layers = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    want_coll = {"all_reduce_count": 2 * layers, "all_reduce": 2 * layers * p * h * 2,
                 "all_gather_count": 1, "all_gather": v // SHARDED_TP * 2}
    want_run = {"all_reduce_count": 2 * layers * n, "all_gather_count": n + 1,
                "all_reduce": 2 * layers * (p + n - 1) * h * 2,
                "all_gather": n * v // SHARDED_TP * 2 + n * 8}
    print(f"  dp2tp2_generate: one prefill forward's collectives on a rank "
          f"{r0['prefill_collectives']} (want {want_coll}); the greedy run's {r0['collectives']} "
          f"(want {want_run}: the model axis' a forward, and one data-axis gather of the tokens)")
    for r in res:
        check(r["prefill_collectives"] == want_coll and r["collectives"] == want_run,
              "dp2tp2_generate: collectives differ from the prediction")
    counts = _sum_counts(res)
    check_launches("dp2tp2_generate", counts)
    print(f"  dp2tp2_generate b={b} (one row a data shard) p={p} n={n} over {r0['backend']}: "
          f"prefill {r0['prefill_ms']:.2f} ms, decode {r0['decode_ms']:.3f} ms/step (eager; "
          f"tokens {'equal to' if not ties else 'parting at a near tie from'} the tp=1 run's)")
    paths["dp2tp2_generate"] = dict(
        reduced=f"num_layers {PRESETS[MODEL].num_layers} -> {layers}", counts=counts,
        prefill=pre, decode_rel_err=dec_err, near_ties=ties,
        collectives_per_forward=r0["prefill_collectives"], collectives=r0["collectives"],
        prefill_ms=r0["prefill_ms"], decode_ms_per_step=r0["decode_ms"], backend=r0["backend"])
    # dp2tp2_server: the answers by body on rank 0, against the one-card engine
    srv = r0["server"]
    check(not srv["errors"] and all(a is not None for a in srv["answers"]),
          f"dp2tp2_server: HTTP requests failed: {srv['errors']}")
    check(srv["kv"] == "torch.bfloat16" and not srv["a8"],
          f"dp2tp2_server: the sharded engine took kv {srv['kv']}, a8 {srv['a8']}")
    answers = srv["answers"]
    rounds = srv["rounds"]
    check(max(rounds) <= SHARDED_DP and sum(rounds) == len(requests),
          f"dp2tp2_server: admission rounds {rounds}")
    check(sorted(map(tuple, srv["outputs"].values())) == sorted(map(tuple, answers)),
          "dp2tp2_server: the engine's outputs are not the answers")
    for r in res[1:]:
        check(r["server"]["rounds"] == rounds and r["server"]["follow"]["steps"] > 0,
              f"dp2tp2_server: rank {res.index(r)} followed {r['server'].get('follow')}")
    srv_ties = []
    for i, (pr, nb, _) in enumerate(requests):
        check(len(answers[i]) == nb, f"dp2tp2_server request {i}: {len(answers[i])} tokens")
        if i not in greedy:
            continue
        j = _first_difference(answers[i], twin_out[i])
        if j is None:
            continue
        tie = near_tie(params, cfg, dev, pr + twin_out[i][:j], answers[i][j], twin_out[i][j])
        print(f"  dp2tp2_server request {i}: token {j} is {answers[i][j]}, the one-card "
              f"engine's {twin_out[i][j]}; {tie['ulps']:.2f} bf16 ulps below the top (near tie: "
              f"{tie['logit_tie']})")
        check(tie["logit_tie"], f"dp2tp2_server: request {i} differs from the one-card engine "
                                f"at {j}, not at a near tie")
        srv_ties.append(dict(request=i, token=j, ulps=tie["ulps"]))
    counts = _sum_counts([r["server"] for r in res])
    check_launches("dp2tp2_server", counts)
    tokens = sum(nb for _, nb, _ in requests)
    print(f"  dp2tp2_server over {r0['backend']}: rank 0's EngineServer, {world - 1} ranks "
          f"following ({res[1]['server']['follow']['steps']} steps, "
          f"{res[1]['server']['follow']['idle']} heartbeats); {len(requests)} requests over HTTP "
          f"from {SERVE_THREADS} threads in {len(rounds)} admission rounds {rounds}; {tokens} "
          f"tokens in {srv['wall_s']:.2f} s = {tokens / srv['wall_s']:.2f} tok/s (eager windows "
          f"of {srv['window']}); greedy against the one-card engine: "
          f"{len(greedy) - len(srv_ties)} equal, {len(srv_ties)} near ties")
    paths["dp2tp2_server"] = dict(counts=counts, wall_s=srv["wall_s"],
                                  tok_s=tokens / srv["wall_s"], rounds=rounds,
                                  near_ties=srv_ties, collectives=srv["collectives"],
                                  follow=res[1]["server"]["follow"])
    # dp2tp2_spec_server: against dp2tp2_server's answers
    run = r0["spec_server"]
    spec_ties = []
    for i in greedy:
        got_i, want = run["outputs"][i], answers[i]
        check(len(got_i) == requests[i][1], f"dp2tp2_spec_server request {i}: {len(got_i)} tokens")
        j = _first_difference(got_i, want)
        if j is None:
            continue
        tie = near_tie(params, cfg, dev, requests[i][0] + want[:j], got_i[j], want[j])
        print(f"  dp2tp2_spec_server request {i}: token {j} is {got_i[j]}, dp2tp2_server's "
              f"{want[j]}; {tie['ulps']:.2f} bf16 ulps below the top (near tie: "
              f"{tie['logit_tie']})")
        check(tie["logit_tie"], f"dp2tp2_spec_server: request {i} differs from dp2tp2_server at "
                                f"{j}, not at a near tie")
        spec_ties.append(dict(request=i, token=j, ulps=tie["ulps"]))
    counts = _sum_counts([r["spec_server"] for r in res])
    check_launches("dp2tp2_spec_server", counts)
    check(run["spec_rounds"] > 0, "dp2tp2_spec_server ran no speculative round")
    print(f"  dp2tp2_spec_server over {r0['backend']}: {len(requests)} requests, {tokens} tokens "
          f"in {run['wall_s']:.2f} s = {tokens / run['wall_s']:.2f} tok/s; {run['spec_rounds']} "
          f"rounds (the most over the data shards) committed {run['spec_tokens']} tokens "
          f"({run['spec_tokens'] / run['spec_rounds']:.2f} a round, k = {SHARDED_SPEC_K}); "
          f"greedy against dp2tp2_server: {len(greedy) - len(spec_ties)} equal, "
          f"{len(spec_ties)} near ties")
    paths["dp2tp2_spec_server"] = dict(counts=counts, wall_s=run["wall_s"],
                                       tok_s=tokens / run["wall_s"], near_ties=spec_ties,
                                       spec_rounds=run["spec_rounds"],
                                       spec_tokens=run["spec_tokens"])
    return paths


def _int_sums(q) -> tuple:
    """(sum, sum of squares) of an integer tensor, exact in int64."""
    import torch

    v = q.to("cpu", dtype=torch.int64)
    return int(v.sum()), int((v * v).sum())


def _ep_model(cfg, seeds, dev, layers_only: bool = False):
    """MIXTRAL cut to SHARDED_MIXTRAL_LAYERS, drawn from `seeds` on dev:
    (the embedding, final norm and dense lm_head with no layer, the dense
    layers as a generator drawing each when taken)."""
    import torch

    from eetq_tpu_torch.models.init import random_dense_layers, random_dense_params

    stub = random_dense_params(dataclasses.replace(cfg, num_layers=0),
                               torch.Generator(device=dev).manual_seed(seeds[1]))
    return stub, random_dense_layers(cfg, torch.Generator(device=dev).manual_seed(seeds[0]))


def _rank_mixtral(mesh, cfg, seeds, prompt, n: int) -> dict:
    """A rank of mixtral_ep2: `shard_model(quantize=True)` over the dense
    layers drawn one at a time from the seeds (E / tp experts kept), the
    shard's integer sums and scales, then, counted from 0 and with every
    routing recorded, the prefill and n greedy tokens."""
    import torch

    from eetq_tpu_torch.dist.sharding import make_forward_fn, shard_model
    from eetq_tpu_torch.layout.tiling import unpack_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    t0 = time.perf_counter()
    stub, layers = _ep_model(cfg, seeds, dev)
    model = shard_model(stub, cfg, mesh, quantize=True, layers=layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    shard = {}
    for i, lp in enumerate(model.params.layers):
        for name, lin in (("qkv", lp.qkv), ("o_proj", lp.o_proj), ("gateup", lp.moe.gateup),
                          ("down", lp.moe.down)):
            shard[f"{i}.{name}"] = (_int_sums(unpack_weights(lin.packed)), lin.scales.cpu())
    p = prompt.shape[1]
    log = []
    fwd = make_forward_fn(model)
    with torch.inference_mode():  # a first forward, untimed: the library's one-time settings
        fwd(model.params, prompt.to(dev), torch.arange(p, device=dev)[None],
            model.init_caches(1, p), 0, last_only=True)
    with routing("record", log), torch.inference_mode():
        caches = model.init_caches(1, p + n)
        _rank_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = fwd(model.params, prompt.to(dev), torch.arange(p, device=dev)[None], caches, 0,
                    last_only=True)
        logits = [lg[0, -1].float()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = [torch.argmax(logits[-1])]
        for j in range(n - 1):
            lg, _ = fwd(model.params, toks[-1].view(1, 1),
                        torch.full((1, 1), p + j, device=dev), caches, p + j)
            logits.append(lg[0, -1].float())
            toks.append(torch.argmax(logits[-1]))
        counts, coll = _rank_read()
        t2 = time.perf_counter()
    return dict(shard=shard, build_s=build_s, counts=counts, collectives=coll,
                logits=torch.stack(logits).cpu(), tokens=torch.stack(toks).cpu().tolist(),
                routes=[(w.cpu(), i.cpu()) for w, i in log], prefill_ms=1e3 * (t1 - t0),
                decode_ms=1e3 * (t2 - t1) / (n - 1), backend=mesh.backend,
                local_experts=model.params.layers[0].moe.num_local_experts)


def _sum_counts(results: list, key: str = "counts") -> dict:
    out = {}
    for r in results:
        for k, v in r[key].items():
            out[k] = out.get(k, 0) + v
    return out


def _logit_tie(row, a: int, b: int) -> bool:
    """a and b both within SPEC_TIE_ULPS bf16 ulps (of the largest |logit|)
    of the top of `row`."""
    import math

    ulp = 2.0 ** (math.floor(math.log2(float(row.abs().max()))) - 7)
    return float(row.max() - min(row[a], row[b])) <= SPEC_TIE_ULPS * ulp


def _sharded_llama(dev, work: str, backend: str) -> dict:
    """tp2_generate, tp2_server and tp2_spec_server (sharded_phase)."""
    import torch

    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM, EETQCausalLM
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_dense_params
    from eetq_tpu_torch.models.transformer import forward_inner, init_caches
    from eetq_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(PRESETS[MODEL], num_layers=SHARDED_LLAMA_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    art = os.path.join(work, "llama2-7b-tp2")
    t0 = time.perf_counter()
    EETQCausalLM(cfg, random_dense_params(cfg, gen)).quantize(art, tp=SHARDED_TP)
    gc.collect()
    torch.cuda.empty_cache()
    twin = AutoEETQForCausalLM.from_quantized(art, device=dev)  # the tp = 1 run of the artifact
    check(twin.tp == SHARDED_TP, f"the artifact records tp {twin.tp}")
    params = twin.params
    print(f"  {MODEL} W8A16 cut to {cfg.num_layers} layers of {PRESETS[MODEL].num_layers}, built "
          f"dense, quantized with tp={SHARDED_TP}, saved and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    _, p, n = REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=gen, device=dev)
    with torch.inference_mode():  # the tp = 1 run: prefill, then greedy steps
        caches = init_caches(cfg, 1, p + n, device=dev)
        lg, _ = forward_inner(params, cfg, prompt, torch.arange(p, device=dev)[None], caches, 0,
                              last_only=True)
        ref = [lg[0, -1].float()]
        toks = [torch.argmax(ref[-1])]
        for j in range(n - 1):
            lg, _ = forward_inner(params, cfg, toks[-1].view(1, 1),
                                  torch.full((1, 1), p + j, device=dev), caches, p + j)
            ref.append(lg[0, -1].float())
            toks.append(torch.argmax(ref[-1]))
        del caches
    ref_tokens = torch.stack(toks).view(1, n)
    requests = _server_requests(cfg, gen, dev)
    greedy = [i for i, (_, _, kw) in enumerate(requests) if not kw]
    te = Engine(params, cfg, max_batch=8, max_len=2048, kv_dtype=torch.bfloat16, a8_prefill=False)
    uids = {i: te.add_request(requests[i][0], requests[i][1]) for i in greedy}
    te.run()
    twin_out = {i: te.result(u) for i, u in uids.items()}
    del te
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with RankPool(SHARDED_TP, f"file://{os.path.join(work, 'rdv-llama')}", backend=backend,
                  timeout_s=SHARDED_TIMEOUT_S) as pool:
        res = pool.run(_rank_llama, art, prompt.cpu(), ref_tokens.cpu(), requests)
    ranks_s = time.perf_counter() - t0
    r0 = res[0]
    print(f"  ranks: {r0['backend']} on {[r['device'] for r in res]}, each loaded and sharded "
          f"the artifact in {r0['load_s']:.1f} s ({r0['shard_gb']:.2f} GB a shard; o_proj "
          f"scales {r0['o_proj_scales']}: per-channel); {ranks_s:.1f} s in the ranks")
    check(r0["o_proj_scales"] == (cfg.hidden_size,), "a rank's o_proj is not per-channel")
    for r in res[1:]:
        check(torch.equal(r["prefill_logits"], r0["prefill_logits"])
              and torch.equal(r["decode_logits"], r0["decode_logits"])
              and r["tokens"] == r0["tokens"]
              and r["server"]["outputs"] == r0["server"]["outputs"]
              and r["spec_server"]["outputs"] == r0["spec_server"]["outputs"],
              "the ranks' logits or tokens differ")
    paths = {}
    # tp2_generate: logits against the tp = 1 run, tokens equal or a near tie
    refs = torch.stack(ref).cpu()
    pre = check_logits("tp2_generate prefill (tp=1 run)", r0["prefill_logits"], refs[0])
    dec_err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(r0["decode_logits"], refs[1:]))
    print(f"  tp2_generate teacher-forced decode logits vs the tp=1 run: at most {dec_err:.4e} "
          f"of the largest logit over {n - 1} steps (tol {MODEL_TOL})")
    check(dec_err <= MODEL_TOL, f"tp2_generate decode logits differ by {dec_err:.3e}")
    want = ref_tokens[0].tolist()
    first = next((j for j, (a, b) in enumerate(zip(r0["tokens"], want)) if a != b), None)
    if first is not None:
        rows = (refs[first], r0["prefill_logits"] if first == 0 else r0["decode_logits"][first - 1])
        tie = all(_logit_tie(row, r0["tokens"][first], want[first]) for row in rows)
        print(f"  tp2_generate: token {first} is {r0['tokens'][first]}, the tp=1 run's "
              f"{want[first]} (near tie: {tie})")
        check(tie, f"tp2_generate tokens differ from the tp=1 run at {first}, not at a near tie")
    per_fwd = {k: v for k, v in r0["prefill_collectives"].items()}
    want_coll = {"all_reduce_count": 2 * cfg.num_layers, "all_gather_count": 1,
                 "all_reduce": 2 * cfg.num_layers * p * cfg.hidden_size * 2,
                 "all_gather": cfg.vocab_size // SHARDED_TP * 2}
    print(f"  tp2_generate: one prefill forward's collectives on a rank {per_fwd} "
          f"(want {want_coll}); the greedy run's {r0['collectives']} over {n} forwards")
    check(per_fwd == want_coll, "tp2_generate: collectives differ from count_collectives' model")
    check(r0["collectives"]["all_reduce_count"] == 2 * cfg.num_layers * n
          and r0["collectives"]["all_gather_count"] == n, "tp2_generate: collectives a step")
    counts = _sum_counts(res)
    check_launches("tp2_generate", counts)
    print(f"  tp2_generate b=1 p={p} n={n} over {r0['backend']}: prefill {r0['prefill_ms']:.2f} "
          f"ms, decode {r0['decode_ms']:.3f} ms/step (eager; tokens "
          f"{'equal to' if first is None else 'parting at a near tie from'} the tp=1 run's)")
    paths["tp2_generate"] = dict(reduced=f"num_layers {PRESETS[MODEL].num_layers} -> "
                                         f"{cfg.num_layers}",
                                 counts=counts, prefill=pre, decode_rel_err=dec_err,
                                 first_difference=first, collectives_per_forward=per_fwd,
                                 prefill_ms=r0["prefill_ms"], decode_ms_per_step=r0["decode_ms"],
                                 backend=r0["backend"])
    # the engines: greedy requests against the one-card twin and each other
    for path, key in (("tp2_server", "server"), ("tp2_spec_server", "spec_server")):
        run = r0[key]
        counts = _sum_counts([r[key] for r in res])
        check_launches(path, counts)
        check(run["kv"] == "torch.bfloat16" and not run["a8"],
              f"{path}: the sharded engine took kv {run['kv']}, a8 {run['a8']}")
        base = (twin_out if path == "tp2_server"
                else {i: r0["server"]["outputs"][i] for i in greedy})
        ties = []
        for i in greedy:
            got, want_i = run["outputs"][i], base[i]
            check(len(got) == requests[i][1], f"{path} request {i}: {len(got)} tokens")
            j = next((j for j, (a, b) in enumerate(zip(got, want_i)) if a != b), None)
            if j is None:
                continue
            tie = near_tie(params, cfg, dev, requests[i][0] + want_i[:j], got[j], want_i[j])
            print(f"  {path} request {i}: token {j} is {got[j]}, the twin's {want_i[j]}; "
                  f"{tie['ulps']:.2f} bf16 ulps below the top (near tie: {tie['logit_tie']})")
            check(tie["logit_tie"], f"{path}: request {i} differs from its twin at {j}, not at "
                                    f"a near tie")
            ties.append(dict(request=i, token=j, ulps=tie["ulps"]))
        tokens = sum(b for _, b, _ in requests)
        print(f"  {path} over {r0['backend']}: {len(requests)} requests, {tokens} tokens in "
              f"{run['wall_s']:.2f} s = {tokens / run['wall_s']:.2f} tok/s (eager windows of "
              f"{run['window']}); greedy against "
              f"{'the one-card engine' if path == 'tp2_server' else 'tp2_server'}: "
              f"{len(greedy) - len(ties)} equal, {len(ties)} near ties"
              + (f"; {run['spec_rounds']} rounds committed {run['spec_tokens']} tokens"
                 if run["spec_rounds"] else ""))
        paths[path] = dict(counts=counts, wall_s=run["wall_s"], tok_s=tokens / run["wall_s"],
                           near_ties=ties, collectives=run["collectives"],
                           spec_rounds=run["spec_rounds"], spec_tokens=run["spec_tokens"])
    t0 = time.perf_counter()
    paths.update(_dp_llama(dev, work, backend, art, cfg, params, prompt, gen, requests,
                           twin_out))
    print(f"  dp2tp2 paths: {time.perf_counter() - t0:.1f} s")
    del params, twin
    return paths


def _sharded_mixtral(dev, work: str, backend: str) -> dict:
    """mixtral_ep2 (sharded_phase)."""
    import torch

    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.dist.sharding import split_qkv_columns, split_rows
    from eetq_tpu_torch.layout.tiling import unpack_weights
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.transformer import (LayerParams, ModelParams, forward_inner,
                                                   init_caches)
    from eetq_tpu_torch.modules.linear import quantize_linear
    from eetq_tpu_torch.modules.moe import quantize_moe

    tp, n = SHARDED_TP, SHARDED_MIXTRAL_NEW
    cfg = dataclasses.replace(PRESETS[MIXTRAL], num_layers=SHARDED_MIXTRAL_LAYERS)
    seeds = (SEED + 50, SEED + 51)
    _, p, _ = REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p),
                           generator=torch.Generator(device=dev).manual_seed(SEED + 52),
                           device=dev)
    t0 = time.perf_counter()
    with RankPool(tp, f"file://{os.path.join(work, 'rdv-mixtral')}", backend=backend,
                  timeout_s=SHARDED_TIMEOUT_S) as pool:
        res = pool.run(_rank_mixtral, cfg, seeds, prompt.cpu(), n)
    ranks_s = time.perf_counter() - t0
    r0 = res[0]
    # the one-card model holding the same per-shard integers: qkv per
    # channel, o_proj group-wise at K / tp (each rank's rows quantized on
    # their own), the banks per expert, the lm_head dense
    stub, layers = _ep_model(cfg, seeds, dev)
    one = []
    for lp in layers:
        k = lp.o_proj.weight.shape[0]
        one.append(LayerParams(lp.input_norm, quantize_linear(lp.qkv.weight),
                               quantize_linear(lp.o_proj.weight, group_size=k // tp),
                               lp.post_norm, moe=quantize_moe(lp.moe)))
        del lp
    params = ModelParams(stub.embed, one, stub.final_norm, stub.lm_head)
    el = cfg.num_experts // tp
    for r, rr in enumerate(res):
        check(rr["local_experts"] == el, f"rank {r} holds {rr['local_experts']} experts")
        for i, lp in enumerate(params.layers):
            want = {"qkv": (split_qkv_columns(unpack_weights(lp.qkv.packed), cfg, tp)[r],
                            split_qkv_columns(lp.qkv.scales, cfg, tp)[r]),
                    "o_proj": (split_rows(unpack_weights(lp.o_proj.packed), tp)[r],
                               lp.o_proj.scales[r]),
                    "gateup": (unpack_weights(lp.moe.gateup.packed)[r * el:(r + 1) * el],
                               lp.moe.gateup.scales[r * el:(r + 1) * el]),
                    "down": (unpack_weights(lp.moe.down.packed)[r * el:(r + 1) * el],
                             lp.moe.down.scales[r * el:(r + 1) * el])}
            for name, (q, sc) in want.items():
                sums, scales = rr["shard"][f"{i}.{name}"]
                check(sums == _int_sums(q) and torch.equal(scales, sc.cpu()),
                      f"mixtral_ep2: rank {r}'s layer {i} {name} is not the one-card model's slice")
    for r in res[1:]:
        check(torch.equal(r["logits"], r0["logits"]) and r["tokens"] == r0["tokens"]
              and all(torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
                      for a, b in zip(r["routes"], r0["routes"])),
              "mixtral_ep2: the ranks' logits, tokens or routings differ")
    log = [(w.to(dev), i.to(dev)) for w, i in r0["routes"]]

    def one_card():
        with torch.inference_mode():
            caches = init_caches(cfg, 1, p + n, device=dev)
            lg, _ = forward_inner(params, cfg, prompt, torch.arange(p, device=dev)[None], caches,
                                  0, last_only=True)
            out = [lg[0, -1].float()]
            for j in range(n - 1):
                tok = torch.tensor([[r0["tokens"][j]]], device=dev)
                lg, _ = forward_inner(params, cfg, tok, torch.full((1, 1), p + j, device=dev),
                                      caches, p + j)
                out.append(lg[0, -1].float())
        return torch.stack(out).cpu()

    with routing("replay", log):
        want = one_card()
    differ = routing_differences(one_card, log)
    err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(r0["logits"], want))
    print(f"  mixtral_ep2: {cfg.num_layers} layers (cut from 32; the EP code is the same in every "
          f"layer), {el} experts a rank; prefill and {n - 1} decode steps against the one-card "
          f"model of the same per-shard integers with rank 0's routing replayed: at most "
          f"{err:.4e} of the largest logit (tol {MODEL_TOL}, no near-tie pass); "
          f"{differ['differ']} of {differ['routings']} routings differ when not replayed")
    check(bool(torch.isfinite(r0["logits"]).all()), "mixtral_ep2 logits are not finite")
    check(err <= MODEL_TOL, f"mixtral_ep2 logits differ by {err:.3e}")
    want_coll = {"all_reduce_count": 2 * cfg.num_layers * n, "all_gather_count": n}
    check(all(r0["collectives"][k] == v for k, v in want_coll.items()),
          f"mixtral_ep2: collectives {r0['collectives']}, want {want_coll}")
    counts = _sum_counts(res)
    check_launches("mixtral_ep2", counts)
    print(f"  mixtral_ep2 b=1 p={p} n={n} over {r0['backend']}: prefill {r0['prefill_ms']:.2f} "
          f"ms, decode {r0['decode_ms']:.3f} ms/step (eager); built in {r0['build_s']:.1f} s; "
          f"{ranks_s:.1f} s in the ranks")
    return {"mixtral_ep2": dict(counts=counts, max_rel_err=err, routing=differ,
                                prefill_ms=r0["prefill_ms"], decode_ms_per_step=r0["decode_ms"],
                                layers=cfg.num_layers, reduced="num_layers 32 -> 2",
                                backend=r0["backend"])}


def sharded_phase(dev) -> dict:
    """tp2_generate, tp2_server, tp2_spec_server and mixtral_ep2 over
    SHARDED_TP ranks, and the dp2tp2 paths over SHARDED_DP x SHARDED_TP
    (module docstring, 11.)."""
    import tempfile

    import torch

    from eetq_tpu_torch.dist.multihost import choose_backend

    t0 = time.perf_counter()
    backend = choose_backend(SHARDED_TP)
    cards = torch.cuda.device_count()
    print(f"  sharded: {SHARDED_TP} ranks over {backend} on {cards} card(s)"
          + ("; the ranks share cuda:0 and gloo stages every collective through the host: the "
             "steps run eagerly, and these times model no NVLink deployment"
             if backend == "gloo" else ""))
    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        paths = _sharded_llama(dev, work, backend)
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(_sharded_mixtral(dev, work, backend))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  sharded phase: {seconds:.1f} s")
    return dict(paths=paths, backend=backend, cards=cards, seconds=seconds)


# The pipeline phase: pipeline parallelism (`eetq_tpu_torch/dist/
# pipeline.py`) and sequence-parallel long-context prefill
# (`dist/long_context.py`) over ranks this script spawns, as the sharded
# phase's: NCCL on cuda:rank where the machine has a card for each rank, else
# gloo with every rank on cuda:0 (every exchange then goes through the host,
# and the times model no NVLink deployment).
PP_STAGES, PP_BATCH, PP_MICRO, PP_NEW = 2, 2, 2, 50
# pp2_generate's, long_generate's and pp2dp2_generate's depths: the stage,
# the ring and the chunk exchange are the same in every layer; the first two
# ran at full depth (32) and pp2dp2_generate at 8 until the presets phase
# needed the run's time
PP_LAYERS, LONG_LAYERS = 8, 8
PP_TP, PP_TP_LAYERS, PP_TP_NEW = 2, 4, 16
PP_DP, PP_DP_LAYERS, PP_DP_NEW = 2, 4, 16  # pp2dp2_generate: b = PP_BATCH a data shard
LONG_PRESET, LONG_SP, LONG_PROMPT, LONG_NEW = "mistral-7b", 2, 8192, 50
PP_WARMUP, LONG_WARMUP = 64, 256  # an untimed first call of each rank, this many tokens
PIPELINE_TIMEOUT_S = 600
_PP = ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode")
# long_generate: the prefill's projections on the GEMM and its attention
# ring attention (no kernel, as in the JAX package), then decode_loop under
# mistral's window
PATH_KERNELS.update({"pp2_generate": _PP, "pp2tp2_generate": _PP, "pp2dp2_generate": _PP,
                     "long_generate": ("w8a16_gemm", "w8a16_gemv", "flash_decode",
                                       "flash_decode[window]")})


def _seeded_layers(cfg, seeds, dev):
    """(the embedding, final norm and dense lm_head drawn from seeds[1] with
    no layer; the dense layers drawn from seeds[0], each as it is taken)."""
    import torch

    from eetq_tpu_torch.models.init import random_dense_layers, random_dense_params

    stub = random_dense_params(dataclasses.replace(cfg, num_layers=0),
                               torch.Generator(device=dev).manual_seed(seeds[1]))
    return stub, random_dense_layers(cfg, torch.Generator(device=dev).manual_seed(seeds[0]))


def _seeded_twin(cfg, seeds, dev, tp: int = 1):
    """The one-card W8A16 model of `_seeded_layers` holding a tp-way
    stage's integers: qkv and gate|up per channel, o_proj and down per
    channel (tp = 1) or group-wise at K / tp (each rank's rows quantized on
    their own); the lm_head dense."""
    from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
    from eetq_tpu_torch.modules.linear import quantize_linear

    stub, layers = _seeded_layers(cfg, seeds, dev)
    out = []
    for lp in layers:
        def rows(w):
            return quantize_linear(w, group_size=None if tp == 1 else w.shape[0] // tp)

        out.append(LayerParams(lp.input_norm, quantize_linear(lp.qkv.weight), rows(lp.o_proj.weight),
                               lp.post_norm, quantize_linear(lp.gateup.weight), rows(lp.down.weight)))
        del lp
    return ModelParams(stub.embed, out, stub.final_norm, stub.lm_head)


@contextlib.contextmanager
def _exchange_ms(stats: dict):
    """Adds to stats[op] the host ms spent in each `Mesh` exchange and
    collective (ppermute, all_gather, all_reduce_) inside the block, each
    timed from a synchronised start to a synchronised end: the split of a
    rank's time between its exchanges (with the wait for its peers to reach
    them) and its own work. The syncs change the run's timing, so the paths
    read their times from a run without them and the split from a run of
    its own."""
    import torch

    from eetq_tpu_torch.dist.sharding import Mesh

    names = ("ppermute", "all_gather", "all_reduce_")
    orig = {n: getattr(Mesh, n) for n in names}

    def timed(name):
        def call(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](self, *args, **kw)
            torch.cuda.synchronize()
            stats[name] = stats.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out
        return call

    for n in names:
        setattr(Mesh, n, timed(n))
    try:
        yield stats
    finally:
        for n in names:
            setattr(Mesh, n, orig[n])


def _dev_int_sums(q) -> tuple:
    """(sum, sum of squares) of an integer tensor, exact in int64 on its device."""
    import torch

    v = q.to(torch.int64)
    return int(v.sum()), int((v * v).sum())


def _rank_pp(mesh, cfg, seeds, prompt, n: int, pp: int, tp: int, dp: int = 1) -> dict:
    """A rank of pp2_generate / pp2tp2_generate / pp2dp2_generate (the prompt
    the global batch, a data shard's rows its own): its stage of `_seeded_layers`
    (shard_model_pp(quantize=True), layer by layer); an untimed first
    pp_prefill; then pp_prefill (timed, its logits) and pp_decode_loop from
    its argmax (timed), each with its collectives (`_pp_run`), and the same
    again under `_exchange_ms` for the split of its time; then, counted from
    0, the main path: pp_generate of the prompt."""
    import torch

    from eetq_tpu_torch.dist.pipeline import (
        init_pp_caches,
        make_pp_mesh,
        pp_generate,
        pp_prefill,
        shard_model_pp,
    )
    from eetq_tpu_torch.layout.tiling import unpack_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    pmesh = make_pp_mesh(pp, tp, dp, device=mesh.device)
    dev = pmesh.device
    stub, layers = _seeded_layers(cfg, seeds, dev)
    model = shard_model_pp(stub, cfg, pmesh, quantize=True, layers=layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    shard = {}
    if tp > 1:  # the integers of each linear, against the twin's slices
        for j, lp in enumerate(model.params.layers):
            for name in ("qkv", "o_proj", "gateup", "down"):
                lin = getattr(lp, name)
                shard[f"{j}.{name}"] = (_dev_int_sums(unpack_weights(lin.packed)),
                                        lin.scales.cpu())
    b, p = prompt.shape
    toks, m = prompt.to(dev), PP_MICRO
    with torch.inference_mode():
        pp_prefill(model, toks[:, :PP_WARMUP], init_pp_caches(model, b, PP_WARMUP), m)
        run = _pp_run(model, toks, n)
        split = {"prefill": {}, "decode": {}}
        run_split = _pp_run(model, toks, n, split)
        _rank_counts()
        t0 = time.perf_counter()
        gen = pp_generate(model, toks, n, microbatches=m)
        counts, coll = _rank_read()
        t1 = time.perf_counter()
    ticks = (n - 1) * m + pp - 1
    return dict(backend=pmesh.backend, device=str(dev), stage=pmesh.pp_rank,
                shard_index=pmesh.tp_rank, data_index=pmesh.dp_rank, build_s=build_s, shard=shard,
                logits=run["logits"],
                tokens=gen.cpu(), decode_tokens=run["tokens"], pre_collectives=run["pre"],
                dec_collectives=run["dec"], prefill_ms=run["prefill_ms"],
                tick_ms=run["decode_ms"] / ticks, ticks=ticks, generate_ms=1e3 * (t1 - t0),
                counts=counts, collectives=coll, exchange_ms=split,
                split_ms=(run_split["prefill_ms"], run_split["decode_ms"]),
                stage_gb=sum(t.numel() * t.element_size() for t in model.params.buffers()) / 1e9)


def _pp_run(model, toks, n: int, split: dict | None = None) -> dict:
    """pp_prefill of toks into fresh caches, then pp_decode_loop of n
    tokens from its argmax, each timed (host clock, synchronised) with its
    collectives; with `split`, under `_exchange_ms` into split["prefill"]
    and split["decode"]."""
    import torch

    from eetq_tpu_torch.dist.pipeline import init_pp_caches, pp_decode_loop, pp_prefill
    from eetq_tpu_torch.utils.profiling import count_collectives

    b, p = toks.shape
    caches, got, out = init_pp_caches(model, b, p + n), {}, {}
    steps = (("pre", "prefill", lambda: pp_prefill(model, toks, caches, PP_MICRO)),
             ("dec", "decode", lambda: pp_decode_loop(
                 model, torch.argmax(got["pre"][0], dim=-1), p, caches, n,
                 microbatches=PP_MICRO)))
    for key, name, fn in steps:
        timer = _exchange_ms(split[name]) if split is not None else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer:
            out[key] = count_collectives(lambda: got.setdefault(key, fn()))
        torch.cuda.synchronize()
        out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
    out.update(logits=got["pre"][0].float().cpu(), tokens=got["dec"][0].cpu())
    del caches, got
    torch.cuda.empty_cache()
    return out


def _ms(stats: dict) -> str:
    return ", ".join(f"{k.rstrip('_')} {v:.1f}" for k, v in sorted(stats.items())) or "none"


def _first_difference(got, want) -> int | None:
    return next((j for j, (a, c) in enumerate(zip(got, want)) if a != c), None)


def _tokens_or_tie(path: str, params, cfg, dev, prompt, got, want) -> list:
    """Each row's tokens `got` against the twin's `want` (both [B, n]):
    equal, or parting first at a near tie (`near_tie`, judged by the
    twin's forward after the twin's tokens). Returns the ties."""
    ties = []
    for r in range(want.shape[0]):
        g, w = got[r].tolist(), want[r].tolist()
        j = _first_difference(g, w)
        if j is None:
            continue
        tie = near_tie(params, cfg, dev, prompt[r].tolist() + w[:j], g[j], w[j])
        print(f"  {path} row {r}: token {j} is {g[j]}, the one-card model's {w[j]}; "
              f"{tie['ulps']:.2f} bf16 ulps below the top (near tie: {tie['logit_tie']})")
        check(tie["logit_tie"], f"{path}: row {r} differs from the one-card model at {j}, not at "
                                f"a near tie")
        ties.append(dict(row=r, token=j, ulps=tie["ulps"]))
    return ties


def _pp_path(dev, work: str, backend: str, path: str, cfg, seeds, n: int, pp: int, tp: int,
             dp: int = 1) -> dict:
    """pp2_generate (tp 1), pp2tp2_generate or pp2dp2_generate (dp 2, b =
    PP_BATCH a data shard) (pipeline_phase)."""
    import torch

    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.dist.sharding import split_gateup_columns, split_qkv_columns, split_rows
    from eetq_tpu_torch.layout.tiling import unpack_weights
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    b, m, p, h = PP_BATCH * dp, PP_MICRO, REQUESTS[0][1], cfg.hidden_size
    prompt = torch.randint(0, cfg.vocab_size, (b, p), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seeds[0] + 2))
    t0 = time.perf_counter()
    twin = _seeded_twin(cfg, seeds, dev, tp)
    with torch.inference_mode():
        caches = init_caches(cfg, b, p + n, device=dev)
        lg, caches = prefill(twin, cfg, prompt, caches)
        ref_logits = lg.float().cpu()
        ref_tokens, _ = decode_loop(twin, cfg, torch.argmax(lg, dim=-1), p, caches, n)
        ref_tokens = ref_tokens.cpu()
        del caches
    twin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with RankPool(dp * pp * tp, f"file://{os.path.join(work, 'rdv-' + path)}", backend=backend,
                  timeout_s=PIPELINE_TIMEOUT_S) as pool:
        res = pool.run(_rank_pp, cfg, seeds, prompt.cpu(), n, pp, tp, dp)
    ranks_s = time.perf_counter() - t0
    r0, lps = res[0], cfg.num_layers // pp
    check([(r["data_index"], r["stage"], r["shard_index"]) for r in res]
          == [(i // (pp * tp), i // tp % pp, i % tp) for i in range(dp * pp * tp)],
          f"{path}: the ranks' places on the mesh")
    for r in res[1:]:
        check(torch.equal(r["logits"], r0["logits"]) and torch.equal(r["tokens"], r0["tokens"]),
              f"{path}: the ranks' logits or tokens differ")
    check(torch.equal(r0["tokens"], r0["decode_tokens"]),
          f"{path}: pp_generate's tokens differ from pp_prefill and pp_decode_loop's")
    if tp > 1:  # each rank's integers are the twin's slice
        for r in res:
            for j in range(lps):
                lp = twin.layers[r["stage"] * lps + j]
                t = r["shard_index"]
                want = {"qkv": (split_qkv_columns(unpack_weights(lp.qkv.packed), cfg, tp)[t],
                                split_qkv_columns(lp.qkv.scales, cfg, tp)[t]),
                        "gateup": (split_gateup_columns(unpack_weights(lp.gateup.packed), tp)[t],
                                   split_gateup_columns(lp.gateup.scales, tp)[t]),
                        "o_proj": (split_rows(unpack_weights(lp.o_proj.packed), tp)[t],
                                   lp.o_proj.scales[t]),
                        "down": (split_rows(unpack_weights(lp.down.packed), tp)[t],
                                 lp.down.scales[t])}
                for name, (q, sc) in want.items():
                    sums, scales = r["shard"][f"{j}.{name}"]
                    check(sums == _dev_int_sums(q) and torch.equal(scales, sc.cpu()),
                          f"{path}: rank {res.index(r)}'s layer {j} {name} is not the twin's slice")
    pre = check_logits(f"{path} prefill (one-card twin)", r0["logits"], ref_logits)
    bit_equal = torch.equal(r0["logits"], ref_logits)
    ties = _tokens_or_tie(path, twin, cfg, dev, prompt, r0["tokens"], ref_tokens)
    # the schedule's exchanges on a rank: a ppermute a tick in prefill, two a
    # tick (activations, token) in decode; the logits' and the tokens' sum
    # over pipe; under tp, 2 model-axis all-reduces a layer a unit, no vocab
    # gather; under dp, a data shard's b / dp rows, and one gather over
    # `data` of the logits and one of the tokens
    units_pre, units_dec, ticks = m, (n - 1) * m, (n - 1) * m + pp - 1
    bl = b // dp
    mbs = bl // m
    ar_pre = 2 * lps * units_pre if tp > 1 else 0
    ar_dec = 2 * lps * units_dec if tp > 1 else 0
    want_pre = {"ppermute_count": m + pp - 1, "ppermute": (m + pp - 1) * mbs * p * h * 2,
                "all_reduce_count": 1 + ar_pre,
                "all_reduce": bl * cfg.vocab_size * 4 + ar_pre * mbs * p * h * 2}
    want_dec = {"ppermute_count": 2 * ticks, "ppermute": ticks * (mbs * h * 2 + mbs * 4),
                "all_reduce_count": 1 + ar_dec,
                "all_reduce": m * mbs * (n - 1) * 4 + ar_dec * mbs * h * 2}
    if dp > 1:
        want_pre.update(all_gather_count=1, all_gather=bl * cfg.vocab_size * 4)
        want_dec.update(all_gather_count=1, all_gather=bl * n * 8)
    print(f"  {path}: a rank's exchanges in prefill {r0['pre_collectives']} (want {want_pre}); "
          f"in the decode ring's {ticks} ticks {r0['dec_collectives']} (want {want_dec})")
    for i, r in enumerate(res):
        print(f"  {path} rank {i} (stage {r['stage']}), a run of its own under synchronised "
              f"timers: host ms inside exchanges (with the wait for peers) in prefill "
              f"{_ms(r['exchange_ms']['prefill'])} of {r['split_ms'][0]:.2f}, in decode "
              f"{_ms(r['exchange_ms']['decode'])} of {r['split_ms'][1]:.1f}")
    for r in res:
        check(r["pre_collectives"] == want_pre and r["dec_collectives"] == want_dec,
              f"{path}: the exchanges differ from the schedule's")
        check(r["collectives"] == {k: want_pre[k] + want_dec[k] for k in want_pre},
              f"{path}: pp_generate's exchanges {r['collectives']}")
    counts = _sum_counts(res)
    check_launches(path, counts)
    gb = max(r["stage_gb"] for r in res)
    print(f"  {path}: {cfg.num_layers} layers, dp={dp} x pp={pp} x tp={tp} ranks over "
          f"{r0['backend']} on "
          f"{sorted(set(r['device'] for r in res))}, {lps} layers a stage ({gb:.2f} GB a rank); "
          f"b={b} in {m} microbatches, p={p}, {n} greedy tokens: prefill {r0['prefill_ms']:.2f} "
          f"ms, decode {r0['tick_ms']:.3f} ms a tick ({ticks} ticks, eager), pp_generate "
          f"{r0['generate_ms']:.1f} ms; the one-card twin's prefill logits bit-equal: "
          f"{bit_equal}; tokens {'equal to' if not ties else 'parting at near ties from'} the "
          f"twin's; built in {r0['build_s']:.1f} s, twin {twin_s:.1f} s, {ranks_s:.1f} s in the "
          f"ranks")
    del twin
    return dict(counts=counts, prefill=pre, logits_bit_equal=bit_equal, near_ties=ties,
                prefill_ms=r0["prefill_ms"], tick_ms=r0["tick_ms"], ticks=ticks,
                generate_ms=r0["generate_ms"], exchanges_prefill=r0["pre_collectives"],
                exchanges_decode=r0["dec_collectives"], backend=r0["backend"], pp=pp, tp=tp, dp=dp,
                exchange_ms=[dict(r["exchange_ms"], run_ms=r["split_ms"]) for r in res],
                layers=cfg.num_layers, stage_gb=gb)


def _rank_long(mesh, cfg, seeds, prompt, n: int, caches_path: str) -> dict:
    """A rank of long_generate: the whole W8A16 model (`_seeded_twin`,
    replicated); an untimed first long_prefill; then long_prefill of the
    prompt (timed, its logits and exchanges; rank 0 writes the caches' first
    p positions to caches_path, every rank their digest); then, counted from
    0, the main path: generate_long of the prompt (timed); then long_prefill
    again under `_exchange_ms` for the split of its time."""
    import torch

    from eetq_tpu_torch.dist.long_context import generate_long, long_prefill
    from eetq_tpu_torch.utils.profiling import count_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    t0 = time.perf_counter()
    params = _seeded_twin(cfg, seeds, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    toks, p, got = prompt.to(dev), prompt.shape[1], {}
    long_prefill(params, cfg, toks[:, :LONG_WARMUP], mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coll = count_collectives(lambda: got.setdefault("out", long_prefill(
        params, cfg, toks, mesh, max_len=p + n)))
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    logits, caches = got.pop("out")
    digest = [float(t[:, :, :p].double().sum()) for c in caches for t in (c.k, c.v)]
    if mesh.tp_rank == 0:
        torch.save([(c.k[:, :, :p].cpu(), c.v[:, :, :p].cpu()) for c in caches], caches_path)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del caches
    torch.cuda.empty_cache()
    _rank_counts()
    t0 = time.perf_counter()
    out = generate_long(params, cfg, toks, n, mesh)
    counts, coll_gen = _rank_read()
    gen_ms = 1e3 * (time.perf_counter() - t0)
    exchange = {}
    t0 = time.perf_counter()
    with _exchange_ms(exchange):
        long_prefill(params, cfg, toks, mesh, max_len=p + n)
    torch.cuda.synchronize()
    split_ms = 1e3 * (time.perf_counter() - t0)
    return dict(backend=mesh.backend, device=str(dev), build_s=build_s, logits=logits.float().cpu(),
                digest=digest, tokens=out.cpu(), prefill_ms=prefill_ms, prefill_collectives=coll,
                exchange_ms=exchange, split_ms=split_ms, generate_ms=gen_ms, counts=counts,
                collectives=coll_gen, peak_gb=peak)


def _long_path(dev, work: str, backend: str) -> dict:
    """long_generate (pipeline_phase)."""
    import torch

    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    path, sp = "long_generate", LONG_SP
    cfg = dataclasses.replace(PRESETS[LONG_PRESET], num_layers=LONG_LAYERS)
    seeds, p, n = (SEED + 70, SEED + 71), LONG_PROMPT, LONG_NEW
    prompt = torch.randint(0, cfg.vocab_size, (1, p), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 72))
    t0 = time.perf_counter()
    twin = _seeded_twin(cfg, seeds, dev)
    with torch.inference_mode():
        caches = init_caches(cfg, 1, p + n, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, caches = prefill(twin, cfg, prompt, caches)
        torch.cuda.synchronize()
        twin_prefill_ms = 1e3 * (time.perf_counter() - t1)
        ref_logits = lg.float().cpu()
        ref_tokens, _ = decode_loop(twin, cfg, torch.argmax(lg, dim=-1), p, caches, n)
        ref_tokens = ref_tokens.cpu()
    twin_s = time.perf_counter() - t0
    caches_path = os.path.join(work, "long_caches.pt")
    t0 = time.perf_counter()
    with RankPool(sp, f"file://{os.path.join(work, 'rdv-long')}", backend=backend,
                  timeout_s=PIPELINE_TIMEOUT_S) as pool:
        res = pool.run(_rank_long, cfg, seeds, prompt.cpu(), n, caches_path)
    ranks_s = time.perf_counter() - t0
    r0 = res[0]
    for r in res[1:]:
        check(torch.equal(r["logits"], r0["logits"]) and torch.equal(r["tokens"], r0["tokens"])
              and r["digest"] == r0["digest"], f"{path}: the ranks' logits, tokens or caches differ")
    pre = check_logits(f"{path} prefill (one-card twin)", r0["logits"], ref_logits)
    worst = 0.0
    for i, (k, v) in enumerate(torch.load(caches_path, mmap=True)):
        for got, want in ((k, caches[i].k[:, :, :p]), (v, caches[i].v[:, :, :p])):
            err = ((got.to(dev).float() - want.float()).abs().max() / want.float().abs().max()).item()
            worst = max(worst, err)
    print(f"  {path}: the gathered caches' k and v over the first {p} positions against the "
          f"one-card prefill's: at most {worst:.4e} of a layer's largest |value| (tol {MODEL_TOL})")
    check(worst <= MODEL_TOL, f"{path}: the gathered caches differ by {worst:.3e}")
    del caches
    ties = _tokens_or_tie(path, twin, cfg, dev, prompt, r0["tokens"], ref_tokens)
    # 2 p ppermutes a layer (k and v at each of the p steps), one gather of
    # the ranks' last logits, 2 L K/V gathers
    chunk = 1 * (p // sp) * cfg.num_kv_heads * cfg.head_dim * 2
    layers = cfg.num_layers
    want = {"ppermute_count": 2 * sp * layers, "ppermute": 2 * sp * layers * chunk,
            "all_gather_count": 1 + 2 * layers,
            "all_gather": cfg.vocab_size * 4 + 2 * layers * chunk}
    print(f"  {path}: a rank's exchanges in long_prefill {r0['prefill_collectives']} (want {want})")
    for i, r in enumerate(res):
        print(f"  {path} rank {i}, a long_prefill of its own under synchronised timers: host ms "
              f"inside exchanges (with the wait for peers) {_ms(r['exchange_ms'])} of "
              f"{r['split_ms']:.1f}")
    for r in res:
        check(r["prefill_collectives"] == want and r["collectives"] == want,
              f"{path}: the exchanges differ from the ring's")
    counts = _sum_counts(res)
    check_launches(path, counts)
    print(f"  {path}: {LONG_PRESET} W8A16 ({layers} layers, window {cfg.sliding_window}) "
          f"replicated on {sp} ranks over {r0['backend']}, b=1 p={p}: long_prefill "
          f"{r0['prefill_ms']:.1f} ms (the one-card prefill {twin_prefill_ms:.1f} ms), "
          f"generate_long of {n} tokens {r0['generate_ms']:.1f} ms; tokens "
          f"{'equal to' if not ties else 'parting at near ties from'} the one-card model's; "
          f"peak {max(r['peak_gb'] for r in res):.1f} GB a rank; built in {r0['build_s']:.1f} s, "
          f"twin {twin_s:.1f} s, {ranks_s:.1f} s in the ranks")
    del twin
    return {path: dict(counts=counts, prefill=pre, caches_max_rel_err=worst, near_ties=ties,
                       prefill_ms=r0["prefill_ms"], twin_prefill_ms=twin_prefill_ms,
                       generate_ms=r0["generate_ms"], exchanges=r0["prefill_collectives"],
                       exchange_ms=[dict(r["exchange_ms"], run_ms=r["split_ms"]) for r in res],
                       backend=r0["backend"], sp=sp, prompt=p,
                       reduced=f"num_layers {PRESETS[LONG_PRESET].num_layers} -> {LONG_LAYERS}")}


def pipeline_phase(dev) -> dict:
    """pp2_generate, pp2tp2_generate, pp2dp2_generate and long_generate over
    ranks (module docstring, 12.)."""
    import tempfile

    import torch

    from eetq_tpu_torch.dist.multihost import choose_backend
    from eetq_tpu_torch.models.config import PRESETS

    t0 = time.perf_counter()
    cfg = PRESETS[MODEL]
    backend = choose_backend(PP_STAGES * PP_TP)
    cards = torch.cuda.device_count()
    print(f"  pipeline: ranks over {backend} on {cards} card(s)"
          + ("; the ranks share cuda:0 and gloo stages every exchange through the host: these "
             "times model no NVLink deployment" if backend == "gloo" else ""))
    work = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        cut = dataclasses.replace(cfg, num_layers=PP_LAYERS)
        paths = {"pp2_generate": _pp_path(dev, work, choose_backend(PP_STAGES), "pp2_generate",
                                          cut, (SEED + 60, SEED + 61), PP_NEW, PP_STAGES, 1)}
        paths["pp2_generate"]["reduced"] = f"num_layers {cfg.num_layers} -> {PP_LAYERS}"
        gc.collect()
        torch.cuda.empty_cache()
        cut = dataclasses.replace(cfg, num_layers=PP_TP_LAYERS)
        paths["pp2tp2_generate"] = _pp_path(dev, work, backend, "pp2tp2_generate", cut,
                                            (SEED + 65, SEED + 66), PP_TP_NEW, PP_STAGES, PP_TP)
        paths["pp2tp2_generate"]["reduced"] = f"num_layers {cfg.num_layers} -> {PP_TP_LAYERS}"
        print(f"  pp2tp2_generate: {MODEL} cut to {PP_TP_LAYERS} layers of {cfg.num_layers} (the "
              "stage and split code is the same in every layer)")
        gc.collect()
        torch.cuda.empty_cache()
        cut = dataclasses.replace(cfg, num_layers=PP_DP_LAYERS)
        paths["pp2dp2_generate"] = _pp_path(dev, work, choose_backend(PP_DP * PP_STAGES),
                                            "pp2dp2_generate", cut, (SEED + 67, SEED + 68),
                                            PP_DP_NEW, PP_STAGES, 1, PP_DP)
        paths["pp2dp2_generate"]["reduced"] = f"num_layers {cfg.num_layers} -> {PP_DP_LAYERS}"
        print(f"  pp2dp2_generate: {MODEL} cut to {PP_DP_LAYERS} layers of {cfg.num_layers}")
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(_long_path(dev, work, choose_backend(LONG_SP)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  pipeline phase: {seconds:.1f} s")
    return dict(paths=paths, backend=backend, cards=cards, seconds=seconds)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="directory for chip_smoke.json (details)")
    parser.add_argument("--profile", action="store_true",
                        help="also run the llama2-7b paths, the paged engines and the "
                             "Mixtral paths under torch.profiler")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)} (a partial run "
                             "checks what it runs and prints no result line)")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"--phases takes {PHASES}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # the measured autotune's cache: a fresh file that only the tooling
    # phase's autotune writes (and removes), so that a cache in the home
    # directory cannot change what any path launches
    import tempfile

    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["EETQ_AUTOTUNE_CACHE"] = os.path.join(tune_dir, "autotune.json")
    os.environ.pop("EETQ_AUTOTUNE", None)
    try:
        return _main(args, phases)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _main(args, phases) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    from eetq_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    info = _build.build()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {info['nvcc_version']}")
    print(card)
    print(f"kernels built in {info['seconds']:.1f} s (cached: {info['cached']})")
    serialized = serialized_wgmma(info["log"])
    for source, names in sorted(serialized.items()):
        print(f"ptxas C7520 (wgmma serialized) in {source}: {len(names)} kernel(s): "
              + ", ".join(sorted(set(names))))
    bad = sorted(set(serialized) & set(UNSERIALIZED_SOURCES))
    if bad:
        print(f"chip_smoke: C7520 in {bad}: their wgmma must not be serialized", file=sys.stderr)
        return 1
    head256 = head256_usage(info["log"])
    for kernel, u in sorted(head256.items()):
        print(f"{kernel} at head dim 256: {u['instances']} instances, {u['min_registers']}.."
              f"{u['max_registers']} registers, {u['spilling']} spilling (at most "
              f"{u['max_spill_stores']} bytes stored, {u['max_spill_loads']} loaded)")
    mmas = gemv_tensor_core_mmas(info["path"])
    print(f"decode GEMV kernels: {len(mmas)} instances, HMMA.16816 instructions in each: "
          f"{sorted(set(mmas.values()))}")
    if not mmas or not all(mmas.values()):
        print("chip_smoke: a decode GEMV kernel without tensor-core MMAs", file=sys.stderr)
        return 1
    run = {
        "kernels": lambda: kernel_phase(dev),
        "moe_layer": lambda: moe_layer_phase(dev),
        "llama": lambda: model_phase(dev, args.profile),
        "checkpoint": lambda: checkpoint_phase(dev),
        "lora": lambda: lora_phase(dev),
        "tooling": lambda: tooling_phase(dev),
        "int4": lambda: int4_phase(dev, args.profile),
        "mixtral": lambda: mixtral_phase(dev, profile=args.profile),
        "mixtral_int4": lambda: mixtral_phase(dev, int4=True, profile=args.profile),
        "families": lambda: families_phase(dev, layers=FAMILY_LAYERS),
        "presets": lambda: families_phase(dev, PRESET_MODELS),
        "sharded": lambda: sharded_phase(dev),
        "pipeline": lambda: pipeline_phase(dev),
    }
    done = {}
    for phase in PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        if phase in ("kernels", "moe_layer"):
            with torch.inference_mode():
                done[phase] = run[phase]()
        else:
            done[phase] = run[phase]()
        gc.collect()  # each model goes before the next is built
        torch.cuda.empty_cache()
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, build_s=info["seconds"], nvcc_log=info["log"],
                           serialized_wgmma=serialized, head256_ptxas=head256,
                           gemv_hmma=mmas,
                           kernels=done.get("kernels", {}).get("rows"),
                           kernel_summary=done.get("kernels", {}).get("summary"),
                           moe_layer=done.get("moe_layer"), model=done.get("llama"),
                           checkpoint=done.get("checkpoint"), lora=done.get("lora"),
                           tooling=done.get("tooling"),
                           int4=done.get("int4"), mixtral=done.get("mixtral"),
                           mixtral_int4=done.get("mixtral_int4"), families=done.get("families"),
                           presets=done.get("presets"),
                           sharded=done.get("sharded"), pipeline=done.get("pipeline"),
                           seconds=time.perf_counter() - t_start), f, indent=1, default=str)
    if len(done) < len(PHASES):
        print(f"partial run ({','.join(done)}): every check of these phases passed")
        return 0
    paths = {}
    for phase in ("llama", "checkpoint", "lora", "tooling", "int4", "mixtral", "mixtral_int4",
                  "families", "presets", "sharded", "pipeline"):
        paths.update(done[phase]["paths"])
    kern = done["kernels"]
    kernels = [
        dict(name=name, route=REPLACES[name][0], source=REPLACES[name][1],
             replaces=REPLACES[name][2],
             launches=sum(p["counts"][name] for p in paths.values()),
             **{key: kern["summary"][name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "many_ms", "library_many_ms")})
        for name in REPLACES
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
