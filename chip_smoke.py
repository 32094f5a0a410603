#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`), one card.

    python3 chip_smoke.py                     # everything
    python3 chip_smoke.py --phase kernels     # build, kernel checks, probes
    python3 chip_smoke.py --phase train       # kernel checks + training
    python3 chip_smoke.py --phase serve       # kernel checks + serving
    python3 chip_smoke.py --phase fedtrain    # kernel checks + fedtrain
    python3 chip_smoke.py --phase loadgen     # kernel checks + open loop
    python3 chip_smoke.py --phase families    # kernel checks + 5 models
    python3 chip_smoke.py --phase recurrent   # kernel checks + zamba2,
                                              # rwkv6 and the int8 KV arena
    python3 chip_smoke.py --phase multimodal  # kernel checks + the vlm
                                              # and whisper-tiny
    python3 chip_smoke.py --phase mesh        # kernel checks + yi-6b
                                              # served on device meshes
    python3 chip_smoke.py --phase trainmesh   # kernel checks + yi-6b and
                                              # granite-moe trained on
                                              # device meshes
    python3 chip_smoke.py --phase servestep   # kernel checks + the
                                              # whole-batch serve step,
                                              # mesh-less and on meshes
    python3 chip_smoke.py --phase familystep  # kernel checks + the serve
                                              # step of zamba2, rwkv6, the
                                              # vlm and whisper on meshes
    python3 chip_smoke.py --phase dryrun      # kernel checks + the dry
                                              # run's counts on the card
    python3 chip_smoke.py --phase examples    # kernel checks + the
                                              # examples on the card
    python3 chip_smoke.py --phase experiments # kernel checks + the
                                              # paper's experiments, short
    python3 chip_smoke.py --phase procs       # kernel checks + every
                                              # family trained and decoded
                                              # and yi-6b served with one
                                              # process a position
    python3 chip_smoke.py --phase probe       # build + `probe_kernels`
    python3 chip_smoke.py --phase ab --parent DIR   # probes, P C C P
    python3 chip_smoke.py --phase predict     # CPU: phase 11's reports

Phases, each fatal on failure:

  1. build the port's CUDA kernels from `src/repro_torch/csrc` (nvcc,
     sm_90a, one process per source, seven sources, twelve launchers);
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes its path gives it (serving: one row of d 4096, 1024,
     3072, 3584 and 2048, and 1- and 2-row flushes at d 1024, 2048, 3072
     and 3584; training: 1024 rows of d 4096, 1024, 3584 and 2048, k 64;
     the standalone top-k: the tabular evaluation's 4000 and 20000 rows
     of 128 f32, k 3) and at odd ones (rows not a multiple of a block, d not a multiple of 32, k in {1, 64, d-1}, ties, duplicate and
     out-of-range indices, d = 16384): masks, indices, words, scattered
     and non-quant values exact; the fused client codec
     (`encode_sections`) byte for byte, leaves and wire sections, with the
     support selected in the launch and given as a mask, for every kind at
     the serving row, the fedtrain batch (128 x 128 f32 k 3, whose rows
     share packed words), 16384-wide and odd rows, on random rows, ties,
     zeros, signed zeros and rows of few magnitudes; quant headers of
     `encode_rows` and decoded values within
     1 ulp, quant codes exact; projected rows within 1 ulp plus 1e-5 of
     the summed |terms|; the serve's flush decode (`decode_to_slots`)
     for every kind at a 4-row bf16 flush with a pad row on the scratch
     slot, slots out of order, two pad rows on one slot, slots outside
     the buffer (skipped), d 16384 and odd widths, duplicate and
     out-of-range sparse indices; `quantize` (no path runs it) at a
     training cut (1024 x 4096 bf16), a serving flush (4 x 4096 bf16), odd
     shapes, a constant row and rows of signed zeros (d 4, 1001, 4096) for
     bits 2, 4, 8: codes exact, lo and step equal as u32, dequantized
     values within 1 ulp; flash attention (no path runs it): the f32 SIMT
     kernel at the reference tests' four configurations (atol 3e-5), the
     bf16 tensor-core kernel at the same four, at S 32 (below its 128-row
     tile) and at yi-6b's width (Hq 32, Hkv 4, hd 128; B 4 S 256, B 1 S
     4096, B 1 S 4096 with a 1024 window; atol 3e-2), and `project_qkv` +
     flash + wo against the model's `full_attention` at yi-6b width in f32
     (atol and rtol 3e-4); time kernel, plain version and, where one
     exists, the single PyTorch call that computes the same function; for
     flash also the kernel's own device time per launch from a profiler
     trace and its TFLOP/s; for decode_rows (the training cut, a fedtrain
     frame) and scatter_rows where the wrapper's time goes (device time
     per launch, host time per call, of it the allocation and the bare
     launch), with `scatter_add_` in place and out of place and a zero
     fill of the output beside decode_rows; then the codec probes
     (`probe_kernels`, `probe_fused`, `codec_token_ms`): the same split
     for topk_mask_threshold (serving row, tabular batch, the tabular
     evaluation, 1024 x 4096), pack_bits (serving row, fedtrain batch),
     encode_rows (serving row, fedtrain batch) and the fused encode,
     randtopk_mask (training cut, tabular batch), decode_to_slots at
     each serve kind's 4-row flush, quantize (1024 x 4096 and 4 x 4096
     bf16, 4 bits), scatter_rows beside a fresh `zeros.scatter_add`, and
     the serving
     client's whole codec per token (host clock around
     `client_encode_device` + `sections_to_bytes`) with its launches;
  3. serve yi-6b at full width (d 4096, bf16, random weights from a seed),
     depth cut from 32 to 8 layers (`--layers`), through
     `runtime.engine.run_streaming` with `randtopk --k 64`, the cut
     at n_layers // 2: the launch counts (zeroed just before) must show
     every kernel ran, the fused encode once per client token (and once
     for the engine's warm-up step) and no top-k, encode_rows or
     bit-pack launch beside it, the flush decode once per flush (and
     twice per flush bucket in the warm-up), no host densification,
     measured payload
     bytes per
     token = `comp.fwd_bits(d) / 8`, and the tokens must equal a second run
     with the plain versions forced (`backend="torch"`); tokens/s of two
     untraced runs, and the card's busy share from a `torch.profiler` trace
     of a third run of the threaded loop itself;
  4. the client and server steps timed alone, with their kernel time from
     a `torch.profiler` trace of calls made alone;
  5. the same path with the identity, quant and randtopk_mask compressors,
     so every encode and decode kind reaches a kernel, each token's codec
     again one fused launch;
  6. yi-6b SMOKE in f32: the card's tokens equal the port's CPU run;
  7. train yi-6b at full width, depth cut to 8 layers (cut at 4), batch 4
     x seq 256, randtopk k 64, AdamW: the first step's forward gives the
     same support, view and loss with the kernels and with the plain
     versions, and a whole first step with the plain versions launches
     nothing and gives the kernels' first loss, grad norm and updated
     parameters, bit for bit (its backward scatters the wire gradient
     through `scatter_rows`); 10 steps through the
     kernels (counts zeroed just before: every kernel of the path ran),
     their synchronized step times, tokens/s, peak memory, and the busy
     share from a `torch.profiler` trace of 3 more; then 2 steps each
     with randtopk_mask, quant and size_reduction, so every decode kind
     of the path reaches `decode_rows`; then a checkpoint round trip
     through `launch.train.main --ckpt-dir`: granite-moe-1b-a400m at
     full width, depth cut from 24 to 2 layers (cut at 1), batch 4 x seq
     256, randtopk k 64, 3 steps with `--ckpt-every 3` and resumed to 6
     = 6 uninterrupted steps bit for bit (printed losses, final params),
     with the checkpoint's size and its save and restore seconds;
  8. the paper's two-party tabular trainer (`split.tabular.train`, the
     `SplitSpec` defaults, batch 128) for one epoch with randtopk, with
     the kernels and with the plain versions: its byte assertion holds
     and the two runs end with the same loss and trained weights, bit for
     bit;
  9. yi-6b SMOKE in f32: 3 training steps on the CPU (plain versions) and
     on the card (kernels) from one set of weights, batches and RandTopK
     draws give losses within rtol 1e-5;
 10. federated split training over the wire (`fedtrain.run_fedtrain`) at
     the tabular phase's widths, batch 128: one randtopk client for one
     epoch gives `tabular.train`'s losses (rtol 1e-5) and final weights on
     the card; four randtopk_mask clients with the adaptive schedule and
     4 local steps for two epochs (78 steps), stopped at step 40 and
     resumed from a checkpoint every 20 steps in a temporary directory,
     equal the uninterrupted run in losses, bytes and final weights;
     measured bytes within 5% of the analytics both ways, no host
     densification, and the codec kernels' launches (counts zeroed just
     before each run) show the path went through them, two a client step
     for one randtopk client (the Eq. (7) mask and the fused encode); wall
     time, steps
     per second and the busy share from a `torch.profiler` trace of a
     rerun; then under seeded chaos with the kernels built, ARQ 0.3 s x
     40 retries: one randtopk client under `FaultPlan(seed=7)` and under
     the heavy-corruption plan (ARQ 0.2 s x 60; reconnects > 0) equals
     the clean card run bit for bit (losses, test accuracy, final
     weights) with the clean run's launches (one Eq. (7) mask and one
     fused encode a logical step, whatever the retransmits); four
     randtopk_mask clients under chaos complete every sync step; each
     run's registry bytes agree with its byte accounting; and a traced
     clean run gives one `client.encode` and one `server.queue_wait`
     span a step, with their median host ms;
 11. open-loop serving of yi-6b at full width (depth cut from 32 to 4
     layers, cut at 2, bf16; the reports do not depend on the depth):
     (a) 6 clients x (4 + 8) tokens, randtopk k 64, max_batch 4, at
     capacity 2 with the kernels and with the plain versions and at
     capacity 6: equal tokens, evictions and readmissions > 0 in both
     contended runs; (b) the same clients under `FaultPlan(seed=3)` chaos
     with ARQ (retry_timeout 0.3 s, 40 retries): the clean run's tokens,
     replays, reconnects and detected faults > 0; (c) `run_loadgen`, the
     reference tests' `_mini` scenario at full width (mmpp, 2.5 s,
     prompt 2-3, gen 3-5, 400 kB/s links, capacity 16, max_batch 8),
     static (randtopk k 64, 12/24 sessions/s) and QoS (randtopk_quant
     k 64 8-bit down a ladder to (8, 4), 20/40 sessions/s), each with the
     kernels and then the plain versions: equal reports (tokens
     included) but `wall_s_real`, no real waits, no failures, QoS
     switches > 0 with the 4-bit rung reached, one fused encode per
     served token and one flush decode per (flush, meta) group; (d) a
     traced closed-loop `launch/serve --trace`: spans nest, each span's
     count and median host ms; (e) the trace gate
     (`repro_torch.testing.trace_smoke`, the reference's
     `scripts/trace_smoke.py`) on the card: qwen3-8b SMOKE under its
     seeded open-loop scenario with chaos, traced twice: the two files
     byte-identical, schema-valid, spans nested, the seven lifecycle
     spans and the admission, ARQ and QoS instants present;
 12. the qk-norm dense and mixture-of-experts families at full width
     (`--phase families`), random bf16 weights from a seed: serve
     granite-moe-1b-a400m (24 layers, d 1024), qwen3-8b (36, qk-norm),
     granite-3-8b (40), phi3-mini-3.8b (32, d 3072) and
     qwen3-moe-235b-a22b (depth cut from 94 to 4 layers to fit the card),
     each with the cut at n_layers // 2, through `run_streaming` with 2
     clients x (4 + 8) tokens, randtopk k 64, with the kernels and with
     the plain versions: equal tokens below the vocabulary, payload bytes
     per token = `fwd_bits(d) / 8`, one fused encode per served token
     and one flush decode per flush group, no host densification; tokens/s,
     init time and peak memory of each; then train granite-moe-1b-a400m
     FULL (cut 12, batch 4 x seq 256, randtopk k 64 alpha 0.1): two plain
     first steps equal each other and the kernels' first step bit for
     bit (loss, aux, grad norm, updated parameters), aux > 0, the pairs
     dropped at capacity in the first forward, 3 steps through the
     kernels with their median ms and peak memory;
 13. the recurrent families and the int8 KV arena at full width
     (`--phase recurrent`), random bf16 weights from a seed, randtopk
     k 64: serve zamba2-7b (depth cut from 81 to 12 Mamba2 layers, d
     3584, a shared attention block after every 6th: cut 6, 1 site
     below it and 1 above) and
     rwkv6-1.6b (depth cut from 24 to 6 layers, d 2048, cut 3) through
     `run_streaming` with
     2 clients x (4 + 8) tokens, with the kernels and with the plain
     versions: equal tokens, 352 and 344 payload B a token, one fused
     encode per served token and one flush decode per flush group; a
     traced third run for the busy share; rwkv6 again at capacity 1
     (every switch evicts the row's WKV state to the host): evictions > 0
     and the clean run's tokens; yi-6b at full width with its depth cut
     from 32 to 8 layers (cut 4) and `kv_cache_bits=8`: the
     arena's caches built int8 and the clients' 16-bit, kernel tokens =
     plain tokens, and its token agreement with the 16-bit run (reported,
     not gated); then train zamba2-7b at full width with its depth cut
     from 81 to 12 layers (cut 6, one site on each side) and rwkv6-1.6b
     (24 to 6, cut 3), batch 4 x seq 256, randtopk k 64 alpha 0.1, AdamW:
     two plain first steps equal each other and the kernels' first step
     bit for bit, 3 kernel steps with their median ms, the busy share of
     a traced fourth step, and peak memory;
 14. the vision and audio families (`--phase multimodal`), random bf16
     weights from a seed, randtopk k 64: serve llama-3.2-vision-90b at
     full width (d 8192) with its depth cut from 100 to 10 layers (8
     self + 2 gated cross, cut 5: one cross site on each side) and
     whisper-tiny FULL (4 decoder layers, d 384, cut 2) through
     `run_streaming` with 2 clients x (4 + 8) tokens, kernels and plain:
     equal tokens, 360 and 328 payload B a token, one fused encode per
     served token and one flush decode per flush group, a traced third
     run for the busy share; with every vlm gate at 0.5, one split
     forward over 2 x 64 tokens with the pipeline's patches (2 x 1601 x
     8192), kernels = plain bit for bit and unlike the gates-at-0
     logits, then 4 tokens decoded from caches built with the patches,
     kernels = plain; train whisper-tiny FULL (cut 2, batch 4 x seq 256,
     frames 4 x 1500 x 384) and the vlm at SMOKE in f32 (cut 2; the full
     width's smallest valid depth, 10 layers, needs ~128 GB with AdamW):
     first steps bit for bit against the plain versions, 3 kernel steps,
     the busy share of a traced fourth step, peak memory, and the vlm's
     gates nonzero after its first step. The kernel checks cover d 8192
     and 384 (bf16) and the vlm SMOKE's 256 (f32);
 15. serving on a device mesh (`--phase mesh`): yi-6b at full width
     (padded vocab 64000), depth cut from 32 to 4 layers (cut 2, so
     that the whole run stays within its time with phases 19-22),
     random bf16 weights from a seed, 4
     clients x (4 + 4) tokens, randtopk k 64, through
     `run_streaming(mesh=)` at `mesh=None` and at `make_serving_mesh(1)`,
     `(4)`, `(4, model=2)` and `(8, model=2, pod=2)`, every position on
     the one card (the port's meshes are single-controller), with the
     kernels; the pod mesh again with the plain versions, and `(4,
     model=2)` at capacity 2: (1, 1) = mesh=None in tokens and, driven
     directly, every cache leaf bit for bit; kernel = plain tokens under
     the pod mesh; 352 payload B a token, one fused encode a served token
     and one flush decode a flush group; evictions and readmissions at
     capacity 2 with the uncontended tokens; each mesh's counted
     collective bytes per op = `roofline.analysis.
     serving_collective_costs`, for one step driven directly and over the
     run's steps; a mesh's tokens may differ from mesh=None's only where
     the mesh-less top-2 logit gap is within 2 bf16 ulps of the max
     logit (a position multiplies fewer rows, and bf16 GEMMs of another
     row count round differently); tokens/s, wall and peak at each mesh,
     and the busy share of a traced pod-mesh run;
 16. training on a device mesh (`--phase trainmesh`): yi-6b at full width
     (d 4096, 32 heads, 4 KV heads, d_ff 11008, vocab 64000), depth cut
     to 2 layers (cut 1), batch 4 x seq 256, randtopk k 64, bf16, AdamW,
     remat, random weights from a seed, at mesh=None, (1, 1), (2, 4) and
     (2, 2, 2) ('pod', 'data', 'model'), and granite-moe-1b-a400m at
     full width with its depth cut from 24 to 6 layers (cut 3, 32
     experts over 'model') at (1, 4); zamba2-7b (12 layers, cut 6) and
     rwkv6-1.6b (2, cut 1) at full width at
     mesh=None and (2, 2), whisper-tiny FULL at mesh=None, (2, 2) (its
     heads split) and (1, 4) (whole), the vlm SMOKE in f32 at mesh=None
     and (2, 2, 2); every
     position on the one card: a plain first step that launches nothing,
     then 4 kernel steps whose first equals it bit for bit; (1, 1) =
     mesh=None bit for bit; the codec (randtopk_mask, decode_rows,
     scatter_rows) once a batch shard a step; each step's counted
     collective bytes per op = `analysis.training_collective_costs`;
     step ms, peak, the busy share of a fifth step traced on the device
     only, and each
     mesh's first loss against mesh=None's; the first batch's loss in
     f32 (forward only, the weights upcast) through the identity codec
     within 2e-4 of mesh=None's, and through randtopk (reported);
 17. the whole-batch serve step (`--phase servestep`,
     `launch.steps.make_serve_step`): B 8 rows, 48 greedy tokens from an
     empty cache over a 32-slot KV ring (it wraps), randtopk k 64 (TopK
     at inference), bf16, random weights from a seed: yi-6b at full
     width, depth cut to 2 layers (cut 1), at mesh=None with the kernels
     and with the plain versions (tokens and first logits bit for bit,
     the plain run launches nothing), at (1, 4) with flash decode (each
     'model' position holds 8 of the ring's slots) and without (the
     ring replicated), and at (2, 2, 2) (the pod ring at the cut); yi-6b
     at 8 of its 32 layers at mesh=None (16 tokens); granite-moe-1b-a400m
     at full width, depth cut from 24 to 6 layers (cut 3), at mesh=None
     and (1, 4) (its 32 experts over 'model'; 24 tokens over a 16-slot
     ring); every position on the one card.
     Fatal: the cut's TopK mask and sparse decode once a batch shard a
     token and no other launch, counted collective bytes
     = `analysis.decode_collective_costs` every token, tokens in the
     vocabulary, each mesh's first-step logits against mesh=None's
     within 16 bf16 ulps of its largest |logit| through the identity
     codec in bf16 and within 2e-4 through randtopk with the weights
     upcast to f32; printed: the bf16 randtopk first step's difference
     (a mesh's bf16 sums in another order flip TopK elements at the cut)
     and the share of tokens equal to mesh=None's, tokens/s (the median
     of 3 runs of 16 tokens after the checked run), device ms a token
     and the busy share of a device-only trace of 4, peak GiB and
     launches a token;
 18. the serve step of the hybrid, ssm, vlm and audio families on the
     decode mesh (`--phase familystep`): B 8, 24 greedy tokens over a
     16-slot ring, randtopk k 64, bf16, each model at full width:
     whisper-tiny FULL at mesh=None (kernels and plain versions, tokens
     and first logits bit for bit), (1, 4) (its 6 heads whole, its 1500
     frames' cross KV 375 a position) and (2, 2, 2) (its encoder output
     crossing the pod ring to the top layers' cross KV); zamba2-7b (depth
     cut from 81 to 12, cut 6: its 112 Mamba2 heads 28 a position),
     rwkv6-1.6b (24 to 2, cut 1: 32 WKV heads, 8 a position) and
     llama-3.2-vision-90b (100 to 10, cut 5, gates 0.5: its 1601 patches'
     cross KV whole, its self KV ring split) at mesh=None and (1, 4),
     flash decode on; the checks and prints of phase 17 (the cut's
     kernels alone, counted bytes = the closed forms, the cache's too,
     first steps against mesh=None's), and each model's f32
     conditioning (its first step's logits under a 1e-7 relative weight
     perturbation): where it amplifies more than a thousandfold (rwkv6)
     the f32 gate is 10 times it and the bf16 identity step reported;
 19. the dry run against the card (`--phase dryrun`): yi-6b at full
     width, depth cut to 5 (cut 2), trained B 8 x S 256 at (2, 2, 2),
     and cut to 4 decoding B 8 over a 32-slot ring at (1, 4) with flash
     decode; whisper-tiny FULL decoding at (2, 2, 2) (its encoder output
     crossing the pod ring when the cache is built); each counted on
     the `meta` device by `launch.dryrun.count_one`, directly and solved
     from smaller depths (`dryrun.depths`, `extrapolate`: equal in
     FLOPs, bytes, arguments and collective bytes), then run on the card
     under the same counter (`roofline.program.count_program`) with a
     registry: FLOPs and collective bytes per op (the cache's too) equal
     the meta count, the codec's kernels launched; printed: the meta
     peak (arguments + counted) against `max_memory_allocated`, meta's
     bytes (plain codec) against the card's (kernels), and one card's
     roofline terms against the step's median ms;
 20. the examples on the card (`--phase examples`): each
     `examples/torch_*.py`'s `main()` in this process at its defaults
     (the multipod dry run at (2, 2, 2) on the decode step, on meta),
     launch counts zeroed before each: the lines the reference's
     example tests assert, its path's kernels launched, its wall;
 21. the paper's experiments on the card (`--phase experiments`,
     `repro_torch.experiments`): the kernels at the shapes the sections
     give them that phase 2 does not hold (top-k at k 2-13 on 128, 4000
     and 20000 rows of d 128 and 600, and 256 x 1024 k 16; the Eq. 7
     mask at those k on 128 rows; table 2's seven codecs through the
     fused encode, the wire body byte for byte; the quant decodes of table 3's quant
     and the combined section's randtopk_quant rows) against their plain
     versions; then, launch counts zeroed, table 2 in full (analytic =
     measured for all seven codecs), fig 2 in full (topk stuck,
     randtopk escaped) and table 3's high level (k 3: randtopk, topk,
     size_reduction) for one epoch with the kernels and with the plain
     versions from the same generators: final loss, test accuracy and
     every trained tensor bit for bit; the phase's wall;
 22. the training mesh and the decode mesh across processes (`--phase
     procs`, `launch.mesh.spawn`, `mesh.ProcessMesh`; `PROCS_RUNS`,
     `PROCS_DECODE`): training yi-6b at full width, 2 of its 32 layers
     (cut 1), at (2, 2), granite-moe-1b-a400m at full width, 4 of its 24
     layers (cut 2), and zamba2-7b, 6 of 81 (cut 3), at (1, 4),
     rwkv6-1.6b, 2 of 24 (cut 1), whisper-tiny FULL (its frames) and
     llama-3.2-vision-90b SMOKE (its patches) at (2, 2); batch 4 x seq
     256, randtopk k 64, AdamW, remat; one process a position, the four
     sharing the card over gloo (each collective's tensors through host
     memory), each holding its blocks of the params and AdamW moments
     at rest (the reference's sharding trees) and, while a step runs,
     its use blocks (`launch.specs.use_layouts`: the 'model' block of
     each leaf its position reads as one, gathered over the data axes
     only; every other leaf whole), after the single controller's
     first step on the same mesh: the processes' first-step loss and aux
     bit for bit, grad norm within 1e-3, every rank's first-moment blocks
     (the summed gradient) within 5e-2 of the single controller's, leaf
     by leaf in the 2-norm, every rank's updated weight blocks within 2
     lr + half a bf16 ulp of each side and at most 2% of them off by
     more than 1 ulp; after the last step the blocks two ranks hold equal
     and the gathered weights equal on every rank; every rank's counted
     collective bytes = `training_collective_costs`; every rank's held
     parameter bytes in every step = `specs.block_bytes` of its use
     layouts (a shape check: it fails where a step holds more or less
     than `use_layouts` says, not where `use_layouts` keeps a leaf whole
     that the path reads only as a block; the CPU test
     `test_torch_tp_blocks.py::test_held_leaves_are_pinned` pins which
     leaves are blocks); the codec kernels once a process a step; each rank's step
     ms, the gradient reduce's and the parameter gather's ms and bytes
     sent, peak (beside the peaks of whole parameters and moments and of
     blocks at rest with whole parameters in a step) and at-rest GiB.
     Then the
     serve step of six families (yi-6b 4 layers and zamba2 6 at (1, 4),
     granite-moe 6, rwkv6 2 and the vlm SMOKE at (2, 2), whisper FULL at
     ('pod', 'data', 'model') (2, 1, 2)), B 8, 8 tokens over a 32-slot
     ring, flash decode, each process decoding on its use blocks
     (`use_layouts(..., "decode")`, their bytes held to `block_bytes`):
     every token and each position's logits equal
     the single controller's decode mesh bit for bit, counted bytes =
     `decode_collective_costs` (whisper's cache =
     `decode_cache_collective_costs`), the cut's kernels once a process
     a token; each rank's step ms, tokens/s and peak. Then the sharded
     serving arena (`run_streaming` on the process mesh, `PROCS_SERVES`,
     every rank holding `unembed` as its 'model' columns, the params'
     bytes held to `block_bytes` of `use_layouts(..., "arena")`): yi-6b
     at full width, 4 of its 32 layers (cut 2), 4 clients x (4 + 4)
     tokens, randtopk k 64, at (2, 2), (2, 1, 2) over the pod ring, (2,
     2) at capacity 2 and (2, 1, 2) with the plain versions; rank 0
     serves, the others follow its flushes: rank 0's tokens = the single
     controller's sharded arena at the same shape bit for bit, plain =
     kernels, the capacity-2 run's evictions and re-admissions (one or
     more) and the uncontended tokens; every rank's counted bytes =
     `serving_collective_costs` a step over rank 0's flushes and warm-up
     steps, which the other ranks take too; rank 0 launches one fused
     encode a client token and one flush decode a flush group, the other
     ranks neither; tokens/s, ms a flush and each process's peak.

Prints the card's name and power limit, a `kernels` JSON line (each
kernel's launches on its path's randtopk run, for the serve's two kernels
plus the loadgen phase's kernel runs, plus the families, recurrent,
multimodal and mesh phases' serves, live checks and training, plus the
train mesh phase's kernel steps, plus the procs phase's processes, and
the serve step and family step
phases' kernel runs, plus the dry run phase's card steps and the
examples, plus the experiments phase's sections,
plus the fedtrain phase's chaos runs and
launch.train's resumed checkpoint run, or in its check's own loop for the
five no path runs, its largest difference from its plain version,
the CUDA-event times of kernel, plain version and library call at its
path's shapes, and the card's bound for the same work), the loop's and
the step's numbers, and as its last line {"ok": true, "device": {...}}.
Exits nonzero, with no result line, when CUDA is unavailable or any phase
fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor f32 (data sheet)
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
D, K, W_IDX = 4096, 64, 12     # yi-6b cut width, top-k, index bits
D_MOE = 1024                   # granite-moe-1b-a400m's width
D_ZAMBA, D_RWKV = 3584, 2048   # zamba2-7b's and rwkv6-1.6b's widths
D_VLM, D_WHISPER = 8192, 384   # llama-3.2-vision-90b's and whisper-tiny's
D_VLM_SMOKE = 256              # the vlm's SMOKE width (trained in f32)
N_CLIENTS, PROMPT_LEN = 4, 4   # closed-loop sessions and prompt tokens
GEN = 16                       # generated tokens per session, randtopk runs
GEN_OTHER = 8                  # ... and for the other compressors


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Median over `reps` of CUDA-event time per call, `iters` calls each,
    after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def device_ms(fn, match=None, n: int = 20):
    """Device time per call of `fn` from a `torch.profiler` trace of `n`
    calls after a warm-up: the summed time of the device kernels whose name
    holds `match` (every kernel when None) over `n`, and their names; the
    time is None when the trace holds no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and (match is None or match in e.key)]
    total = sum(e.self_device_time_total for e in ev) / 1e3
    return (total / n if total > 0 else None), sorted({e.key for e in ev})


def host_us(fn, n: int = 1000) -> float:
    """Host microseconds per call of `fn` over `n` calls with no
    synchronize, the card idle at the start (what the caller's thread
    pays to enqueue the work)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def split_probe(label, wrapper, kernel, alloc, launch, bound):
    """Where a wrapper's time goes at one shape: its CUDA-event ms, the
    device ms per launch of the kernels whose name holds `kernel` (every
    kernel of the call when None; from a profiler trace), the host us per
    call, and of that the output allocation (`alloc`, None for a wrapper
    that allocates nothing) and the bare launch with fixed arguments
    (`launch`: ctypes call, kernel launch, count). Prints one line and
    returns the numbers."""
    ms = time_ms(wrapper)
    dev, names = device_ms(wrapper, kernel)
    rec = dict(shape=label, ms=ms, device_ms=dev, kernels=names,
               host_us=host_us(wrapper),
               alloc_us=None if alloc is None else host_us(alloc),
               launch_us=host_us(launch), bound_ms=bound[0],
               bound_by=bound[1])
    print(f"  {label}: wrapper {ms} ms (CUDA events), kernel device {dev} "
          f"ms per launch {names}, host {rec['host_us']} us per call, of "
          f"which output allocation {rec['alloc_us']} us and bare launch "
          f"{rec['launch_us']} us; bound {bound[0]} ms ({bound[1]})")
    return rec


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """The least time the card needs: max(bytes / HBM rate, ops / peak
    rate), the f32 peak unless another is named. Returns (ms, "bytes" |
    "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_diff(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def ulp(t):
    """One ulp of f32 at each element's magnitude."""
    import torch

    t = t.float().abs()
    return torch.nextafter(t, torch.full_like(t, float("inf"))) - t


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _tabular_eval_shape():
    """The shapes a path gives the standalone top-k: the tabular trainer's
    evaluation, the whole test set's and then the train set's cut rows at
    once (`n_test` and `n_train` rows of `cut_dim` f32, k of
    `SplitSpec`)."""
    from repro_torch.data.synthetic import ManyClassDataset
    from repro_torch.split.tabular import SplitSpec

    spec = SplitSpec()
    return (ManyClassDataset.n_test, ManyClassDataset.n_train, spec.cut_dim,
            spec.k)


def check_topk(dev, g):
    """The standalone top-k against its plain version, exact, at the
    tabular evaluation's shapes (its only path), the serving row, odd
    shapes and 16384-wide rows, each on random rows, ties (halves), zeros
    and negatives; timed at the test set's rows."""
    import torch
    from repro_torch.kernels.randtopk import ops, ref

    rows, rows_train, d_tab, k_tab = _tabular_eval_shape()
    cases = [((rows, d_tab), torch.float32, k_tab),
             ((rows_train, d_tab), torch.float32, k_tab),
             ((128, d_tab), torch.float32, k_tab),
             ((1, D), torch.bfloat16, K), ((1, D_ZAMBA), torch.bfloat16, K),
             ((1, D_RWKV), torch.bfloat16, K),
             ((1, D_VLM), torch.bfloat16, K),
             ((1, D_WHISPER), torch.bfloat16, K),
             ((37, 1000), torch.float32, 1),
             ((37, 1000), torch.float32, 64), ((37, 1000), torch.float32,
                                               999),
             ((3, 16384), torch.bfloat16, K), ((5, 4097), torch.float32, 64),
             ((9, 70), torch.float32, 3), ((9, 512), torch.bfloat16, 64)]
    err = 0.0
    for shape, dt, k in cases:
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        for xx in (x, torch.round(x * 2) / 2, torch.zeros_like(x),
                   -x.abs()):                       # plus ties and zeros
            mk, tk = ops.topk_mask_threshold(xx, k)
            mp, tp = ref.topk_mask_threshold(xx, k)
            torch.cuda.synchronize()
            if not torch.equal(mk, mp) or not torch.equal(tk, tp):
                fail(f"topk kernel != plain at {shape} {dt} k={k}")
            if not bool((mk.sum(-1) == k).all()):
                fail(f"topk kernel selected != {k} at {shape}")
            err = max(err, max_diff(mk, mp), max_diff(tk, tp))
    x = torch.randn((rows, d_tab), generator=g, device=dev)
    mag = x.abs()
    ms = time_ms(lambda: ops.topk_mask_threshold(x, k_tab))
    plain = time_ms(lambda: ref.topk_mask_threshold(x, k_tab))
    lib = time_ms(lambda: torch.topk(mag, k_tab, dim=-1))
    # radix passes, rank, store
    b = bound_ms(rows * (d_tab * 4 + d_tab + 4), 5 * rows * d_tab)
    print(f"  topk_mask_threshold: {len(cases) * 4} cases equal to the "
          f"plain version (mask and threshold), the tabular evaluation's "
          f"{rows} and {rows_train} x {d_tab} f32 k {k_tab} among them; "
          f"timed at the first: "
          f"kernel {ms} ms, plain {plain} ms, torch.topk {lib} ms, bound "
          f"{b[0]} ms")
    return dict(name="topk_mask_threshold", route="cuda",
                source="src/repro_torch/csrc/topk_select.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:133",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="torch.topk(|x| f32, k)")


KIND_CASES = [("dense", 0, 0), ("slice", K, 0), ("sparse", K, 0),
              ("quant", 0, 4), ("sparse_quant", K, 8), ("mask", K, 0)]
# the QoS ladder's lower rungs the loadgen serves (k 32/16/8, 8 and 4 bits)
RUNG_KS = (32, 16, 8)
RUNG_CASES = [("sparse_quant", k, bits) for k in RUNG_KS for bits in (8, 4)]


def _encode_case(x, kind, k, bits):
    import torch
    from repro_torch.core.payload import KIND_LEAVES
    from repro_torch.kernels.encode import ops, ref
    from repro_torch.kernels.randtopk import ref as tref

    mask = tref.topk_mask_threshold(x, k)[0] if k else None
    p = ops.encode_rows(x, kind, k=k, bits=bits, mask=mask)
    got = [getattr(p, name) for name in KIND_LEAVES[kind]]
    want = ref.encode_rows(x, kind, k, bits, mask)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(KIND_LEAVES[kind], got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"encode {kind} {name}: {a.shape}/{a.dtype} vs "
                 f"{b.shape}/{b.dtype}")
        if kind in ("quant", "sparse_quant") and name == "header":
            if not bool(((a - b).abs() <= ulp(b)).all()):
                fail(f"encode {kind} header beyond 1 ulp")
        elif not torch.equal(a, b):
            fail(f"encode {kind} {name}: kernel != plain at "
                 f"{tuple(x.shape)} k={k}")
        err = max(err, max_diff(a, b))
    return err


def check_encode(dev, g):
    """`encode_rows` (mask given, no sections) against its plain version.
    No path runs it since the client's codec is the fused encode, so its
    launches are those of this check's own loop."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops, ref
    from repro_torch.kernels.randtopk import ref as tref

    err = 0.0
    _lib.reset_launch_counts()
    for kind, k, bits in KIND_CASES:
        x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
        err = max(err, _encode_case(x, kind, k, bits))
        xo = torch.randn((37, 1000), generator=g, device=dev)
        for kk in ((1, 64, 999) if k else (0,)):
            err = max(err, _encode_case(xo, kind, kk, bits))
        err = max(err, _encode_case(torch.zeros((3, 70), device=dev), kind,
                                    min(k, 70), bits))
    launches = _lib.launch_counts()["encode_rows"]
    # its times at the serving row (sparse: a top-k mask, values and
    # indices); `probe_kernels` splits them into host and device
    x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
    mask = tref.topk_mask_threshold(x, K)[0]
    ms = time_ms(lambda: ops.encode_rows(x, "sparse", k=K, mask=mask))
    plain = time_ms(lambda: ref.encode_rows(x, "sparse", K, 0, mask))
    b = bound_ms(D * 2 + D + K * 8, 2 * D)
    return dict(name="encode_rows", route="cuda",
                source="src/repro_torch/csrc/encode_rows.cu",
                replaces="src/repro/kernels/encode/kernel.py:160",
                launches=launches,
                launches_from="this check's own loop: no path runs it (the "
                              "client's codec is encode_sections)",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def _hostile_rows(x, g):
    """The rows a selection can trip on, from one random batch: ties at
    the kth (values rounded to halves), all zeros, -0.0 beside +0.0, and
    many equal magnitudes (a handful of values, signs mixed)."""
    import torch

    few = torch.tensor([0.5, -0.5, 1.0, -1.0, 2.0], device=x.device)
    pick = torch.randint(0, 5, x.shape, generator=g, device=x.device)
    return [("random", x), ("halves", torch.round(x * 2) / 2),
            ("zeros", torch.zeros_like(x)),
            ("signed zeros", torch.where(x < 0, -0.0, 0.0).to(x.dtype)),
            ("few magnitudes", few[pick].to(x.dtype))]


SECTION_CASES = [((1, D), "bfloat16"),          # the serving client's row
                 ((1, 1024), "bfloat16"),       # ... granite-moe's (10 bits)
                 ((1, 3072), "bfloat16"),       # ... phi3's (12 bits)
                 ((1, 3584), "bfloat16"),       # ... zamba2's (12 bits)
                 ((1, 2048), "bfloat16"),       # ... rwkv6's (11 bits)
                 ((1, D_VLM), "bfloat16"),      # ... the vlm's (13 bits)
                 ((1, D_WHISPER), "bfloat16"),  # ... whisper's (9 bits)
                 ((128, 128), "float32"),       # fedtrain: rows share words
                 ((3, 16384), "bfloat16"), ((3, 16384), "float32"),
                 ((37, 1000), "float32"), ((5, 4097), "float32"),
                 ((9, 70), "bfloat16"), ((9, 512), "bfloat16"),
                 ((6, 200), "float32")]


def check_encode_sections(dev, g):
    """The fused client codec against `ref.encode_sections`, byte for byte:
    every leaf and every wire section equal, in both modes (`select`: the
    kernel's own top-k; `mask=`: a Eq. (7) mask drawn by the plain
    version, and a top-k one), for every kind at the serving rows (d 4096,
    1024 and 3072), the
    fedtrain batch (128 x 128 f32 k 3: 21 index bits a row, so rows share
    packed words), 16384-wide rows and odd widths, on the hostile rows of
    `_hostile_rows`. Then its times at the serving row (sparse, select)."""
    import torch
    from repro_torch.core import selection
    from repro_torch.core.payload import KIND_LEAVES
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops, ref
    from repro_torch.kernels.randtopk import ref as tref

    err, n = 0.0, 0
    for shape, dt in SECTION_CASES:
        x0 = torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dt))
        rows, d = shape
        ks = sorted({min(k, d) for k in (1, 3, K) + RUNG_KS} | {d})
        for label, x in _hostile_rows(x0, g):
            for kind, bits_list in (("sparse", (0,)), ("mask", (0,)),
                                    ("sparse_quant", (3, 4, 8)),
                                    ("quant", (3, 4, 8)), ("dense", (0,)),
                                    ("slice", (0,))):
                for k in (ks if kind != "quant" and kind != "dense"
                          else (0,)):
                    for bits in bits_list:
                        modes = [("", False, None)]
                        if kind in ops.MASK_KINDS:
                            gum = selection.gumbel_noise(g, shape,
                                                         device=dev)
                            m = torch.randint(0, k + 1, (rows, 1),
                                              generator=g, device=dev)
                            modes = [
                                ("select", True, None),
                                ("top-k mask", False,
                                 tref.topk_mask_threshold(x, k)[0]),
                                ("Eq. 7 mask", False,
                                 tref.randtopk_mask(x, gum, m, k))]
                        for mode, select, mask in modes:
                            p, secs = ops.encode_sections(
                                x, kind, k=k, bits=bits, mask=mask,
                                select=select)
                            leaves, want = ref.encode_sections(
                                x, kind, k, bits, mask, select)
                            torch.cuda.synchronize()
                            got = [getattr(p, nm) for nm in KIND_LEAVES[kind]]
                            for a, b in list(zip(got, leaves)) + \
                                    list(zip(secs, want)):
                                if a.shape != b.shape or a.dtype != b.dtype \
                                        or not torch.equal(
                                            a.contiguous().view(-1).view(
                                                torch.uint8),
                                            b.contiguous().view(-1).view(
                                                torch.uint8)):
                                    fail(f"encode_sections {kind} {mode} "
                                         f"!= plain at {shape} {dt} k={k} "
                                         f"bits={bits} rows {label}")
                                err = max(err, max_diff(a, b))
                            n += 1
    print(f"  encode_sections: {n} cases, leaves and wire sections equal "
          f"to ref.encode_sections byte for byte (select and mask= modes; "
          f"shapes {[s for s, _ in SECTION_CASES]}; rows random, ties, "
          f"zeros, signed zeros, few magnitudes)")
    x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
    ms = time_ms(lambda: ops.encode_sections(x, "sparse", k=K, select=True))
    plain = time_ms(lambda: ref.encode_sections(x, "sparse", K, 0,
                                                select=True))
    b = sections_bound(D, 2, "sparse", K, 0)
    return dict(name="encode_sections", route="cuda",
                source="src/repro_torch/csrc/encode_rows.cu",
                replaces="src/repro/kernels/encode/kernel.py:160",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None,
                library_call="none: no PyTorch call selects, gathers and "
                             "bit-packs a row")


def sections_bound(d, x_bytes, kind, k, bits, rows=1, masked=False):
    """The fused encode's bound: x read once (and a mask byte per element
    where one is given), the leaves and sections written
    once; the operations of two radix passes, the scan and the gather per
    element (select) or one per element, f32 peak."""
    import math

    r = math.ceil(math.log2(d)) if d > 1 else 1
    per = {"sparse": k * 4 + k * 4 + math.ceil(k * r / 8),
           "quant": d * 4 + 8 + math.ceil(d * bits / 8),
           "sparse_quant": k * 8 + 8 + math.ceil(k * (r + bits) / 8),
           "mask": k * 4 + 4 * math.ceil(d / 32),
           "dense": d * 4, "slice": k * 4}[kind]
    return bound_ms(rows * (d * x_bytes + (d if masked else 0) + per),
                    4 * rows * d)


def check_pack(dev, g):
    """`pack_bits` against its plain version at every width. No path runs
    it since the fused encode packs its own streams, so its launches are
    those of this check's own loop."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops, ref

    err = 0.0
    _lib.reset_launch_counts()
    for w in range(1, 33):
        for n in (1, K, 1000, 4097):
            hi = 2 ** w
            v = torch.randint(0, min(hi, 2 ** 31 - 1), (n,), generator=g,
                              device=dev, dtype=torch.int64)
            if w == 32:
                v = v * 2 - 2 ** 31 + torch.randint(0, 2, (n,), generator=g,
                                                    device=dev)
            v = v.to(torch.int32)
            a, b = ops.pack_bits(v, w), ref.pack_bits(v, w)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"pack_bits kernel != plain at width {w}, n {n}")
            err = max(err, max_diff(a, b))
    launches = _lib.launch_counts()["pack_bits"]
    idx = torch.randint(0, D, (K,), generator=g, device=dev,
                        dtype=torch.int32)
    ms = time_ms(lambda: ops.pack_bits(idx, W_IDX))
    plain = time_ms(lambda: ref.pack_bits(idx, W_IDX))
    b = bound_ms(K * 4 + (K + 31) // 32 * W_IDX * 4, K * 4)
    return dict(name="pack_bits", route="cuda",
                source="src/repro_torch/csrc/pack_bits.cu",
                replaces="src/repro/kernels/encode/kernel.py:236",
                launches=launches,
                launches_from="this check's own loop: no path runs it (the "
                              "fused encode packs its own streams)",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def _flush_payload(dev, g, kind, k, bits, n, d, n_real):
    """A stacked flush of n rows (n_real real, the rest zero pad rows)."""
    import torch
    from repro_torch.core.payload import KIND_LEAVES, Payload, PayloadMeta
    from repro_torch.kernels.encode import ref as eref
    from repro_torch.kernels.randtopk import ref as tref

    x = torch.randn((n, d), generator=g, device=dev)
    mask = tref.topk_mask_threshold(x, k)[0] if k else None
    leaves = list(eref.encode_rows(x, kind, k, bits, mask))
    for leaf in leaves:
        leaf[n_real:] = 0
    meta = PayloadMeta(kind, d=d, k=k if kind != "quant" else 0,
                       bits=bits)
    return Payload(meta=meta, **dict(zip(KIND_LEAVES[kind], leaves)))


# the serve's four compressors and the payload kinds they send
SERVE_KINDS = (("randtopk", "sparse", K, 0), ("identity", "dense", 0, 0),
               ("quant", "quant", 0, 4), ("randtopk_mask", "mask", K, 0))


def _decode_to_slots_case(dev, g, p, slots, cap, dt):
    """The kernel and the plain version on one flush, each into a copy of
    one random xbuf (cap + 1, 1, 1, d) in `dt`; a row aimed outside
    [0, cap] goes to the kernel alone (which skips it; the plain version's
    index would wrap or raise). Returns (kernel's xbuf, plain's)."""
    import torch
    from repro_torch.core.payload import KIND_LEAVES
    from repro_torch.kernels.decode import ops, ref

    kind, d = p.meta.kind, p.meta.d
    base = torch.randn((cap + 1, 1, 1, d), generator=g, device=dev).to(dt)
    xa, xb = base.clone(), base.clone()
    ops.decode_rows_to_slots(xa, p, slots)
    keep = (slots >= 0) & (slots <= cap)
    leaves = [getattr(p, nm)[keep] for nm in KIND_LEAVES[kind]]
    ref.decode_to_slots(xb, leaves, slots[keep], kind, d)
    torch.cuda.synchronize()
    return xa, xb


def _decode_cases(kind, k):
    """(label, d, dtype, rows, real rows, slots, k, hostile, cap) of one
    kind; the scratch slot is cap (6 as in the serve phase, 16 as in the
    loadgen's), pad rows (zero leaves) follow the real ones."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        ("serve flush, one pad row", D, bf, 4, 3, [0, 1, 2, 6], k, False),
        ("slots out of order", D, bf, 4, 4, [3, 0, 5, 1], k, False),
        ("two pad rows on the scratch slot", D, bf, 4, 2, [4, 2, 6, 6], k,
         False),
        ("slots outside [0, cap1) skipped", D, bf, 4, 4, [0, 9, 2, -1], k,
         False),
        ("d 16384", 16384, bf, 4, 3, [1, 0, 2, 6], k, False),
        ("d 1000, f32", 1000, f32, 8, 5, [5, 3, 1, 0, 2, 6, 6, 6],
         min(k, 999), False),
        ("d 1000, k 999", 1000, f32, 3, 3, [2, 0, 1], 999 if k else 0,
         False),
        ("d 70, f32", 70, f32, 8, 6, [5, 4, 3, 2, 1, 0, 6, 6], k, False)]
    cases = [c + (6,) for c in cases]
    # the families and recurrent phases' 2-client flushes (buckets of 1
    # and 2 rows into a 3-row buffer) at granite-moe's, rwkv6's, phi3's
    # and zamba2's widths
    for d in (D_MOE, D_RWKV, 3072, D_ZAMBA, D_VLM, D_WHISPER):
        cases += [(f"d {d} flush, 2 rows", d, bf, 2, 2, [1, 0], k, False,
                   2),
                  (f"d {d} flush, 1 row", d, bf, 1, 1, [1], k, False, 2),
                  (f"d {d} flush, one pad row", d, bf, 2, 1, [0, 2], k,
                   False, 2)]
    # the loadgen's flush buckets (1, 2, 4, 8 rows) into a 17-row buffer
    cases += [
        ("loadgen flush, 1 row", D, bf, 1, 1, [11], k, False, 16),
        ("loadgen flush, 2 rows", D, bf, 2, 2, [15, 0], k, False, 16),
        ("loadgen flush, 4 rows, one pad", D, bf, 4, 3, [13, 7, 1, 16], k,
         False, 16),
        ("loadgen flush, 8 rows, three pads", D, bf, 8, 5,
         [9, 2, 14, 5, 0, 16, 16, 16], k, False, 16)]
    if kind in ("sparse", "sparse_quant", "mask"):
        cases.append(("duplicate and out-of-range indices", D, bf, 4, 3,
                      [2, 0, 1, 6], k, True, 6))
    return cases


def check_decode(dev, g):
    """`decode_rows_to_slots` (the serve's flush decode) against its plain
    version: every kind, and sparse_quant on every QoS rung, at the serve's
    4-row bf16 flush with a pad row on the scratch slot, the loadgen's 1-,
    2-, 4- and 8-row flushes into 17 rows, the families phase's 1- and
    2-row flushes at d 1024 and 3072, slots out of order, two pad rows
    on one slot, slots outside the buffer, d 16384 and odd widths, and
    duplicate and out-of-range sparse indices (mask words with bits past
    k): every kind exact (both dequantize as lo + (code + 0.5) * step,
    each rounding explicit)."""
    import torch
    from repro_torch.kernels.decode import ops, ref

    err, n_cases = 0.0, 0
    for kind, k, bits in KIND_CASES + RUNG_CASES:
        for (label, d, dt, n, n_real, sl, kk, hostile,
             cap) in _decode_cases(kind, k):
            if hostile:
                p = _rows_payload(dev, g, kind, kk, bits, n, d, hostile=True)
                for leaf in (p.values, p.indices, p.header):
                    if leaf is not None:
                        leaf[n_real:] = 0
            else:
                p = _flush_payload(dev, g, kind, kk, bits, n, d, n_real)
            slots = torch.tensor(sl, dtype=torch.int32, device=dev)
            xa, xb = _decode_to_slots_case(dev, g, p, slots, cap, dt)
            if not torch.equal(xa, xb):
                fail(f"decode {kind} k={kk} bits={bits}: kernel != plain: "
                     f"{label}")
            err = max(err, max_diff(xa, xb))
            n_cases += 1
    print(f"decode_to_slots: {n_cases} flushes equal the plain version "
          f"exactly (every kind; sparse_quant at k {RUNG_KS} x 8/4 bits)")
    n = 4
    p = _flush_payload(dev, g, "sparse", K, 0, n, D, 3)
    slots = torch.tensor([0, 1, 2, n], dtype=torch.int32, device=dev)
    xbuf = torch.zeros((n + 1, 1, 1, D), dtype=torch.bfloat16, device=dev)
    leaves = [p.values, p.indices]
    ms = time_ms(lambda: ops.decode_rows_to_slots(xbuf, p, slots))
    plain = time_ms(lambda: ref.decode_to_slots(xbuf, leaves, slots,
                                                "sparse", D))
    rows = slots.long()[:, None].expand(n, K)
    cols = p.indices.long()
    vals = p.values.to(torch.bfloat16)
    x2 = xbuf.view(-1, D)
    lib = time_ms(lambda: x2.index_put_((rows, cols), vals))
    b = bound_ms(n * K * 8 + n * 4 + n * D * 2, n * (D + K))
    return dict(name="decode_to_slots", route="cuda",
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/decode/kernel.py:224",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="xbuf.index_put_((slot, index), values): the "
                             "k values only, the row is not zeroed")


TRAIN_ROWS = 1024               # a training step: batch 4 x seq 256


def _tol_ok(a, b, slack=None) -> bool:
    """|a - b| within one ulp of b in b's dtype (bf16: 2**-7 relative),
    plus `slack` where given."""
    import torch

    bf = b.float()
    if b.dtype == torch.bfloat16:
        tol = bf.abs() * 2.0 ** -7 + 1e-30
    else:
        tol = ulp(bf)
    if slack is not None:
        tol = tol + slack
    return bool(((a.float() - bf).abs() <= tol).all())


def check_randtopk(dev, g):
    import torch
    from repro_torch.kernels.randtopk import ops, ref
    from repro_torch.core import selection

    cases = [((TRAIN_ROWS, D), torch.bfloat16, K),
             ((TRAIN_ROWS, D_MOE), torch.bfloat16, K),
             ((TRAIN_ROWS, D_ZAMBA), torch.bfloat16, K),
             ((TRAIN_ROWS, D_RWKV), torch.bfloat16, K),
             ((TRAIN_ROWS, D_VLM), torch.bfloat16, K),
             ((TRAIN_ROWS, D_WHISPER), torch.bfloat16, K),
             ((TRAIN_ROWS, D_VLM_SMOKE), torch.float32, K),
             ((37, 1000), torch.float32, 1),
             ((37, 1000), torch.float32, 64), ((37, 1000), torch.float32,
                                               500),
             ((37, 1000), torch.float32, 999), ((3, 16384), torch.bfloat16, K),
             ((5, 4097), torch.float32, 64),
             ((128, 128), torch.float32, 3),       # the tabular trainer's
             ((9, 70), torch.float32, 3), ((9, 512), torch.bfloat16, 64)]
    err = 0.0
    for shape, dt, k in cases:
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        gum = selection.gumbel_noise(g, shape, device=dev)
        rows, d = shape
        cap = min(k, d - k)
        m_rand = torch.randint(-2, cap + 3, (rows, 1), generator=g,
                               device=dev)                # clipped in both
        for xx, gg, m in ((x, gum, m_rand),
                          (x, gum, torch.zeros((rows, 1), device=dev,
                                               dtype=torch.int64)),
                          (x, gum, torch.full((rows, 1), cap, device=dev)),
                          (torch.round(x * 2) / 2, torch.round(gum),
                           m_rand),                       # tied scores
                          (torch.zeros_like(x), torch.zeros_like(gum),
                           m_rand)):
            a = ops.randtopk_mask(xx, gg, m, k)
            b = ref.randtopk_mask(xx, gg, m, k)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"randtopk kernel != plain at {shape} {dt} k={k}")
            if not bool((a.sum(-1) == k).all()):
                fail(f"randtopk kernel selected != {k} at {shape}")
            err = max(err, max_diff(a, b))
    x = torch.randn((TRAIN_ROWS, D), generator=g, device=dev).to(
        torch.bfloat16)
    gum = selection.gumbel_noise(g, x.shape, device=dev)
    m = selection.binomial_nontop_count(g, 0.1, K, D, (TRAIN_ROWS,),
                                        device=dev)
    ms = time_ms(lambda: ops.randtopk_mask(x, gum, m, K), iters=50)
    plain = time_ms(lambda: ref.randtopk_mask(x, gum, m, K), iters=10)
    # x bf16 + noise f32 + m i32 read, mask written; three radix selects of
    # 4 histogram passes + 1 emit pass over each row
    b = bound_ms(TRAIN_ROWS * (D * 2 + D * 4 + 4 + D), 15 * TRAIN_ROWS * D)
    return dict(name="randtopk_mask", route="cuda",
                source="src/repro_torch/csrc/randtopk_mask.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:162",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def _rows_payload(dev, g, kind, k, bits, n, d, hostile=False):
    """n payload rows of `kind` from the plain encode of random rows; with
    `hostile`, sparse indices repeat and leave [0, d), mask words carry
    set bits past k, and values are multiples of 1/8 so duplicate sums are
    exact in any order."""
    import torch
    from repro_torch.core.payload import KIND_LEAVES, Payload, PayloadMeta
    from repro_torch.kernels.encode import ref as eref
    from repro_torch.kernels.randtopk import ref as tref

    x = torch.randn((n, d), generator=g, device=dev)
    if hostile:
        x = torch.round(x * 8) / 8
    mask = tref.topk_mask_threshold(x, k)[0] if k else None
    leaves = dict(zip(KIND_LEAVES[kind],
                      eref.encode_rows(x, kind, k, bits, mask)))
    if hostile and kind in ("sparse", "sparse_quant"):
        idx = leaves["indices"]
        idx[:, 1::3] = idx[:, 0:1]                        # duplicates
        idx[:, 2::7] = d + 5                              # out of range
    if hostile and kind == "mask":
        leaves["indices"] = leaves["indices"] | 0x11      # extra bits
    if hostile and kind in ("quant", "sparse_quant"):
        leaves["header"][:, 0] = -4.0                     # exact dequant
        leaves["header"][:, 1] = 1 / 32
    meta = PayloadMeta(kind, d=d, k=k if kind != "quant" else 0, bits=bits)
    return Payload(meta=meta, **leaves)


def check_decode_rows(dev, g):
    import torch
    from repro_torch.core.payload import KINDS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.decode import ops, ref

    err = 0.0
    for kind, k, bits in KIND_CASES:
        for n, d, kk, hostile in ((TRAIN_ROWS, D, k, False),
                                  (TRAIN_ROWS, D_MOE, k, False),
                                  (TRAIN_ROWS, D_ZAMBA, k, False),
                                  (TRAIN_ROWS, D_RWKV, k, False),
                                  (TRAIN_ROWS, D_VLM, k, False),
                                  (TRAIN_ROWS, D_WHISPER, k, False),
                                  (TRAIN_ROWS, D_VLM_SMOKE, k, False),
                                  (37, 1000, min(k, 999), False),
                                  (5, 1000, 999 if k else 0, False),
                                  (37, 1000, min(k, 999), True),
                                  (3, 16384, k, False)):
            p = _rows_payload(dev, g, kind, kk, bits, n, d, hostile)
            quant = kind in ("quant", "sparse_quant")
            for dt in (torch.float32, torch.bfloat16):
                a = ops.decode_rows(p, dtype=dt)
                b = ref.decode_rows(p, dt)
                torch.cuda.synchronize()
                if a.shape != b.shape or a.dtype != b.dtype:
                    fail(f"decode_rows {kind}: {a.shape}/{a.dtype} vs "
                         f"{b.shape}/{b.dtype}")
                if quant and not _tol_ok(a, b):
                    fail(f"decode_rows {kind} beyond 1 ulp at d={d} {dt}")
                if not quant and not torch.equal(a, b):
                    fail(f"decode_rows {kind}: kernel != plain at d={d} "
                         f"n={n} {dt} hostile={hostile}")
                err = max(err, max_diff(a, b))
            if d > 4096:
                continue
            for p_out in (1, 96, 130):
                w = torch.randn((d, p_out), generator=g, device=dev) / d**0.5
                rows = ref.decode_rows(p, torch.float32)
                # f32 sums in another order: 1e-5 of the sum of |terms|
                slack = 1e-5 * (rows.abs() @ w.abs())
                for dt in (torch.float32, torch.bfloat16):
                    a = ops.decode_rows(p, dtype=dt, project=w)
                    b = ref.decode_rows(p, dt, w)
                    torch.cuda.synchronize()
                    if a.shape != (n, p_out) or not _tol_ok(a, b, slack):
                        fail(f"decode_rows {kind} project {p_out}: kernel "
                             f"!= plain at d={d} {dt}")
                    err = max(err, max_diff(a, b))
    # where the wrapper's time goes, at the yi-6b training cut and at one
    # fedtrain flush frame; beside it two yardsticks: in-place
    # `scatter_add_` into a zeroed buffer it does not zero again, and
    # out-of-place `zeros.scatter_add`, which returns a fresh buffer as the
    # decode must
    print("decode_rows, sparse, host/device split:")
    probes = []
    for label, n, d, k, dt in (
            ("training 1024 x 4096 k 64 -> bf16", TRAIN_ROWS, D, K,
             torch.bfloat16),
            ("fedtrain 128 x 128 k 3 -> f32", 128, 128, 3, torch.float32)):
        p = _rows_payload(dev, g, "sparse", k, 0, n, d)
        out = torch.empty((n, d), dtype=dt, device=dev)
        args = (p.values.data_ptr(), 0, p.indices.data_ptr(), 0, n, d,
                KINDS.index("sparse"), k, out.data_ptr(),
                int(dt == torch.bfloat16), _lib.stream_handle(out))
        probes.append(split_probe(
            label, lambda: ops.decode_rows(p, dtype=dt), "decode_rows",
            lambda: p.values.new_empty((n, d), dtype=dt),
            lambda: _lib.launch("decode_rows", *args),
            bound_ms(n * (k * 8 + d * out.element_size()), n * (d + k))))
        rec = probes[-1]
        zeros = torch.zeros((n, d), dtype=dt, device=dev)
        dense = zeros.clone()
        idx, vals = p.indices.long(), p.values.to(dt)
        rec["plain_ms"] = time_ms(lambda: ref.decode_rows(p, dt), iters=50)
        rec["library_ms"] = time_ms(lambda: dense.scatter_add_(-1, idx, vals))
        rec["library_fresh_ms"] = time_ms(
            lambda: zeros.scatter_add(-1, idx, vals))
        lib_dev, _ = device_ms(lambda: dense.scatter_add_(-1, idx, vals))
        fresh_dev, _ = device_ms(lambda: zeros.scatter_add(-1, idx, vals))
        # what the card takes to write the output alone: a zero fill
        fill_dev, _ = device_ms(lambda: out.zero_())
        print(f"    plain {rec['plain_ms']} ms; in-place scatter_add_ "
              f"{rec['library_ms']} ms (device {lib_dev}); out-of-place "
              f"zeros.scatter_add {rec['library_fresh_ms']} ms (device "
              f"{fresh_dev}); a zero fill of the output, device "
              f"{fill_dev} ms")
    # the projection epilogue (no path passes `project=`) at the training
    # cut with a square (4096, 4096) f32 matrix: f32 SIMT operations bound
    p = _rows_payload(dev, g, "sparse", K, 0, TRAIN_ROWS, D)
    w = torch.randn((D, D), generator=g, device=dev) / D ** 0.5
    pb = bound_ms(TRAIN_ROWS * (K * 8 + D * 4 + D * 2) + D * D * 4,
                  2 * TRAIN_ROWS * D * D)
    proj_ms = time_ms(lambda: ops.decode_rows(p, dtype=torch.bfloat16,
                                              project=w), iters=20)
    proj_dev, _ = device_ms(lambda: ops.decode_rows(
        p, dtype=torch.bfloat16, project=w), "project_rows")
    print(f"  decode_rows with project= (1024 x 4096 k 64 times a 4096 x "
          f"4096 f32 matrix -> bf16): wrapper {proj_ms} ms, product device "
          f"{proj_dev} ms ({2 * TRAIN_ROWS * D * D / proj_ms / 1e9} TFLOP/s "
          f"through the wrapper); bound {pb[0]} ms ({pb[1]}, f32 peak)")
    b = probes[0]
    return dict(name="decode_rows", route="cuda",
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/decode/kernel.py:181",
                max_abs_err=err, ms=b["ms"], plain_ms=b["plain_ms"],
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=b["library_ms"],
                library_call="dense.scatter_add_(-1, index, values) into a "
                             "zeroed bf16 buffer it does not zero again")


def check_scatter_rows(dev, g):
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.randtopk import ops, ref

    err = 0.0
    # (2, 16384, 16384): a thread's 64 values, as many as its duplicate
    # record holds; (5, 9000, 70): k > d, more than that
    for n, k, d in ((TRAIN_ROWS, K, D), (TRAIN_ROWS, K, D_MOE),
                    (TRAIN_ROWS, K, D_ZAMBA), (TRAIN_ROWS, K, D_RWKV),
                    (TRAIN_ROWS, K, D_VLM), (TRAIN_ROWS, K, D_WHISPER),
                    (TRAIN_ROWS, K, D_VLM_SMOKE),
                    (37, 1, 1000), (37, 999, 1000),
                    (5, 64, 4097), (3, 64, 16384), (2, 16384, 16384),
                    (5, 9000, 70)):
        for dt in (torch.float32, torch.bfloat16):
            vals = (torch.round(torch.randn((n, k), generator=g,
                                            device=dev) * 8) / 8).to(dt)
            idx = torch.randint(0, d, (n, k), generator=g, device=dev,
                                dtype=torch.int32)
            for ii in (idx, torch.sort(idx, dim=-1).values,
                       torch.where(idx % 5 == 0, d + 3, idx)):
                a = ops.scatter_rows(vals, ii, d)
                b = ref.scatter_rows(vals, ii, d)
                torch.cuda.synchronize()
                if a.dtype != dt or not torch.equal(a, b):
                    fail(f"scatter_rows kernel != plain at n={n} k={k} "
                         f"d={d} {dt}")
                err = max(err, max_diff(a, b))
    vals = torch.randn((TRAIN_ROWS, K), generator=g, device=dev).to(
        torch.bfloat16)
    idx = torch.sort(torch.randperm(D, generator=g, device=dev)[:K]).values
    idx = idx.expand(TRAIN_ROWS, K).to(torch.int32).contiguous()
    dense = torch.zeros((TRAIN_ROWS, D), dtype=torch.bfloat16, device=dev)
    idx64 = idx.long()
    ms = time_ms(lambda: ops.scatter_rows(vals, idx, D))
    plain = time_ms(lambda: ref.scatter_rows(vals, idx, D), iters=50)
    lib = time_ms(lambda: dense.scatter_add_(-1, idx64, vals))
    b = bound_ms(TRAIN_ROWS * (K * 2 + K * 4 + D * 2), TRAIN_ROWS * (D + K))
    # where the wrapper's time goes: the kernel's own device time from a
    # profiler trace, the host's time per call enqueueing it, and of that
    # the output's allocation and the bare launch (ctypes call, kernel
    # launch, count) with fixed arguments
    dev_ms, names = device_ms(lambda: ops.scatter_rows(vals, idx, D),
                              "decode_rows_scatter_kernel")
    lib_dev, lib_names = device_ms(
        lambda: dense.scatter_add_(-1, idx64, vals))
    out = vals.new_empty((TRAIN_ROWS, D))
    args = (vals.data_ptr(), 1, idx.data_ptr(), TRAIN_ROWS, D, K,
            out.data_ptr(), _lib.stream_handle(vals))
    print(f"  scatter_rows (1024 x 4096 bf16, k 64): wrapper {ms} ms "
          f"(CUDA events), kernel device {dev_ms} ms per launch {names}, "
          f"host {host_us(lambda: ops.scatter_rows(vals, idx, D))} us per "
          f"call, of which output allocation "
          f"{host_us(lambda: vals.new_empty((TRAIN_ROWS, D)))} us and bare "
          f"launch {host_us(lambda: _lib.launch('scatter_rows', *args))} "
          f"us; scatter_add_ wrapper {lib} ms, device {lib_dev} ms "
          f"{lib_names}, host "
          f"{host_us(lambda: dense.scatter_add_(-1, idx64, vals))} us per "
          f"call; bound {b[0]} ms ({b[1]})")
    return dict(name="scatter_rows", route="cuda",
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:199",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="dense.scatter_add_(-1, index, values) into a "
                             "zeroed bf16 buffer it does not zero again")


QUANT_CASES = [((TRAIN_ROWS, D), "bfloat16"),    # a yi-6b training cut
               ((N_CLIENTS, D), "bfloat16"),     # a serving flush
               ((17, 96), "float32"), ((17, 96), "bfloat16"),
               ((3, 5, 96), "float32"), ((3, 5, 96), "bfloat16")]


def _signed_zero_rows(dev, g, rows, d):
    """Rows whose least value is a zero, with -0.0 in places: non-negative
    random rows with about one element in eight set to +0.0 or -0.0, the
    first row all +0.0 but a -0.0 at the end, the second all +0.0, the
    third all -0.0 (at d 4: the rows XLA's min and `fminf` disagree on)."""
    import torch

    x = torch.randn((rows, d), generator=g, device=dev).abs()
    at = torch.rand((rows, d), generator=g, device=dev)
    x = torch.where(at < 1 / 16, torch.zeros_like(x), x)
    x = torch.where(at > 15 / 16, torch.full_like(x, -0.0), x)
    x[0] = 0.0
    x[0, -1] = -0.0
    x[1] = 0.0
    x[2] = -0.0
    if d == 4:
        x[3] = torch.tensor([0.0, -0.0, 1.0, 2.0], device=dev)
        x[4] = torch.tensor([0.0, 0.0, -0.0, -0.0], device=dev)
        x[5] = torch.tensor([-0.0, 0.0, 1.0, 2.0], device=dev)
    return x


def _same_bits(a, b) -> bool:
    """f32 tensors equal as u32 patterns (-0.0 != +0.0)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 \
        and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_quant(dev, g):
    """`quantize` against its plain version: codes exact, lo and step equal
    as u32 (so a -0.0 lo is held to its sign), the dequantized values
    within 1 ulp (and whether they were exact), on random rows, a constant
    row, and rows of signed zeros at d 4, an odd d (1001) and 4096. No
    path runs it, so its launches are those of this check's own loop."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.quant import ops, ref

    err, deq_exact = 0.0, True
    _lib.reset_launch_counts()
    cases = QUANT_CASES + [((4, 32), "constant")] + [
        ((rows, d), "zeros " + dt) for rows, d in ((6, 4), (7, 1001),
                                                   (4, D))
        for dt in ("float32", "bfloat16")]
    for shape, dt in cases:
        if dt == "constant":
            x = torch.full(shape, 1.5, device=dev)
            x[1] = -3.0
        elif dt.startswith("zeros"):
            x = _signed_zero_rows(dev, g, *shape).to(getattr(torch,
                                                             dt[6:]))
        else:
            x = torch.randn(shape, generator=g, device=dev).to(
                getattr(torch, dt))
        for bits in (2, 4, 8):
            a, b = ops.quantize(x, bits), ref.quantize(x, bits)
            torch.cuda.synchronize()
            if a[0].dtype != b[0].dtype or not torch.equal(a[0], b[0]):
                fail(f"quantize codes: kernel != plain at {shape} {dt} "
                     f"bits={bits}")
            for name, u, w in (("lo", a[2], b[2]), ("step", a[3], b[3])):
                if not _same_bits(u, w):
                    fail(f"quantize {name}: kernel != plain as u32 at "
                         f"{shape} {dt} bits={bits}")
            if a[1].dtype != x.dtype or not _tol_ok(a[1], b[1]):
                fail(f"quantize deq beyond 1 ulp at {shape} {dt} "
                     f"bits={bits}")
            if torch.isnan(a[1]).any():
                fail(f"quantize gave NaN at {shape} {dt}")
            deq_exact = deq_exact and torch.equal(a[1], b[1])
            err = max(err, *(max_diff(u, w) for u, w in zip(a, b)))
    launches = _lib.launch_counts()["quantize"]
    print(f"quantize: {len(cases) * 3} cases, codes exact, lo and step "
          f"equal as u32 (signed-zero rows included), dequantized values "
          f"{'exact' if deq_exact else 'within 1 ulp, not all exact'}")
    x = torch.randn((TRAIN_ROWS, D), generator=g, device=dev).to(
        torch.bfloat16)
    ms = time_ms(lambda: ops.quantize(x, 4))
    plain = time_ms(lambda: ref.quantize(x, 4), iters=50)
    b = quant_bound(TRAIN_ROWS, D, 2)
    return dict(name="quantize", route="cuda",
                source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quant/kernel.py:34",
                launches=launches,
                launches_from="this check's own loop: no path runs it",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None,
                library_call="none: no single PyTorch call gives per-row "
                             "min/max codes, dequantized values and "
                             "headers (torch.quantize_per_channel takes "
                             "the scales as inputs and rounds to nearest)")


def quant_bound(rows, d, x_bytes):
    """`quantize`'s bound: x read; u8 codes, values in x's dtype, f32 lo
    and step written; min, max, subtract, divide, floor, two clamps, add,
    multiply, add per element."""
    return bound_ms(rows * (d * (x_bytes + 1 + x_bytes) + 8), 10 * rows * d)


def _visible_pairs(S: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask leaves visible, per batch row and head: keys
    up to the query (causal) or all, from the window's start."""
    n = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window else 0
        n += hi - lo + 1
    return n


FLASH_F32 = [dict(B=2, S=128, Hq=4, Hkv=2, hd=64, causal=True, window=0),
             dict(B=1, S=256, Hq=8, Hkv=8, hd=32, causal=True, window=0),
             dict(B=2, S=128, Hq=4, Hkv=1, hd=64, causal=False, window=0),
             dict(B=1, S=256, Hq=4, Hkv=2, hd=64, causal=True, window=64)]
YI = dict(Hq=32, Hkv=4, hd=128)        # yi-6b attention at full width
FLASH_SHORT = dict(B=2, S=32, Hq=4, Hkv=2, hd=64, causal=True, window=0)
FLASH_BF16 = [dict(B=4, S=256, causal=True, window=0, **YI),   # training
              dict(B=1, S=4096, causal=True, window=0, **YI),
              dict(B=1, S=4096, causal=True, window=1024, **YI)]


def _flash_inputs(g, dev, c, dtype):
    import torch

    shapes = [(c["B"], c["S"], h, c["hd"]) for h in (c["Hq"], c["Hkv"],
                                                      c["Hkv"])]
    return [torch.randn(sh, generator=g, device=dev).to(dtype)
            for sh in shapes]


def _sdpa_call(q, k, v, c):
    """The library yardstick: one `scaled_dot_product_attention` call on
    (B, H, S, hd) views, grouped heads by `enable_gqa` where this PyTorch
    has it, else K and V repeated beforehand (outside the timed call)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    S = q.shape[1]
    mask = None
    if c["window"]:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - c["window"])
    kw = dict(attn_mask=mask, is_causal=c["causal"] and mask is None)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw)), "enable_gqa=True"
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        kr, vr = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
        return (lambda: F.scaled_dot_product_attention(qt, kr, vr, **kw)), \
            "K and V repeated per q head"


def check_flash(dev, g):
    """Both flash kernels against their plain version: the f32 (SIMT)
    kernel at the reference tests' four configurations (atol 3e-5); the
    bf16 (tensor-core) kernel at the same four, at S 32 (below its 128-row
    tile, the ragged edge) and at yi-6b's full width (atol 3e-2); then
    project_qkv + the f32 kernel + wo against the model's attention at
    yi-6b full width (atol/rtol 3e-4). No path runs them, so their launches
    are those of this check's own loop. Times at each bf16 shape: kernel
    (wrapper, CUDA events, and its own device time per launch from a
    profiler trace, with the TFLOP/s on the visible pairs), plain version
    and one `scaled_dot_product_attention` call; the f32 kernel's at
    yi-6b's training shape in f32. Returns the two kernels' records."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flashattn import ops, ref
    from repro_torch.models import attention as A
    from repro_torch.models.config import Runtime

    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    _lib.reset_launch_counts()
    for c, dt, atol in ([(c, torch.float32, 3e-5) for c in FLASH_F32]
                        + [(c, torch.bfloat16, 3e-2)
                           for c in FLASH_F32 + [FLASH_SHORT] + FLASH_BF16]):
        q, k, v = _flash_inputs(g, dev, c, dt)
        kw = dict(causal=c["causal"], window=c["window"])
        bt = min(64, c["S"])
        a = ops.flash_attention(q, k, v, bq=bt, bk=bt, **kw)
        b = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        e = max_diff(a.float(), b.float())
        if a.dtype != dt or a.shape != q.shape or not e <= atol:
            fail(f"flash kernel != plain at {c} {dt}: max |diff| {e}")
        err[dt] = max(err[dt], e)
        print(f"  flash {dt} {c}: max |kernel - plain| {e} (atol {atol})")
        del b
    # against the model: yi-6b full width, one layer, B 2, S 256, f32
    cfg = configs.get("yi-6b").with_(n_layers=1, param_dtype="float32",
                                     dtype="float32")
    p = {n: w[0] for n, w in A.init_attention(
        torch.Generator(device=dev).manual_seed(5), cfg, 1,
        device=dev).items() if n != "norm"}
    x = torch.randn((2, 256, cfg.d_model), generator=g, device=dev)
    y_model = A.full_attention(p, cfg, Runtime(), x)
    q, k, v = A.project_qkv(p, cfg, x, torch.arange(256, device=dev)[None])
    y_flash = ops.flash_attention(q, k, v).reshape(2, 256, -1) @ p["wo"]
    torch.cuda.synchronize()
    tol = 3e-4 + 3e-4 * y_model.abs()
    if not bool(((y_flash - y_model).abs() <= tol).all()):
        fail(f"flash + project_qkv != full_attention at yi-6b width: max "
             f"|diff| {max_diff(y_flash, y_model)}")
    print(f"  flash + project_qkv vs full_attention, yi-6b width, B 2, "
          f"S 256, f32: max |diff| {max_diff(y_flash, y_model)} "
          f"(atol/rtol 3e-4)")
    launches = _lib.launch_counts()
    recs = {}
    for c, dt in [(c, torch.bfloat16) for c in FLASH_BF16] + \
            [(FLASH_BF16[0], torch.float32)]:
        q, k, v = _flash_inputs(g, dev, c, dt)
        kw = dict(causal=c["causal"], window=c["window"])
        big = c["S"] > 1024
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                     iters=3 if big else 50, reps=3)
        plain = time_ms(lambda: ref.attention(q, k, v, **kw),
                        iters=1 if big else 10, reps=3)
        lib_fn, how = _sdpa_call(q, k, v, c)
        lib = time_ms(lib_fn, iters=10 if big else 100, reps=3)
        pairs = _visible_pairs(c["S"], c["causal"], c["window"])
        n = c["B"] * c["S"] * (c["Hq"] * 2 + c["Hkv"] * 2) * c["hd"]
        flops = 4 * c["B"] * c["Hq"] * c["hd"] * pairs
        bf16 = dt == torch.bfloat16
        peak = BF16_TENSOR_OPS_PER_S if bf16 else FP32_OPS_PER_S
        b = bound_ms(n * (2 if bf16 else 4), flops, peak)
        dev_ms, names = device_ms(
            lambda: ops.flash_attention(q, k, v, **kw), "flash",
            n=3 if big else 20)
        tflops = flops / (dev_ms * 1e-3) / 1e12 if dev_ms else None
        print(f"  flash {dt} B {c['B']} S {c['S']} window {c['window']}: "
              f"kernel {ms} ms (CUDA events, wrapper), device {dev_ms} ms "
              f"per launch {names} = {tflops} TFLOP/s, wrapper "
              f"{flops / (ms * 1e-3) / 1e12} TFLOP/s; plain {plain} ms, "
              f"sdpa ({how}) {lib} ms; bound {b[0]} ms ({b[1]}, "
              f"{'bf16 tensor' if bf16 else 'f32'} peak, {flops} "
              f"visible-pair FLOP)")
        name = "flash_attention" if bf16 else "flash_attention_simt"
        if name not in recs:            # the training shape goes in the line
            recs[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flashattn/kernel.py:67",
                launches=launches[name],
                launches_from="this check's own loop: no path runs it",
                max_abs_err=err[dt], ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib, device_ms=dev_ms,
                library_call="torch.nn.functional.scaled_dot_product_"
                             f"attention ({how}), B 4 S 256 causal {dt} "
                             "at yi-6b width, as the other times")
        del q, k, v
        torch.cuda.empty_cache()
    return [recs["flash_attention"], recs["flash_attention_simt"]]


# ---------------------------------------------------------------------------
# codec probes: where the serving codec's time goes, kernel by kernel
# ---------------------------------------------------------------------------

CODEC_TOKENS = 300              # client_encode_device calls timed per kind


def codec_token_ms(dev, g, names=("randtopk", "quant", "randtopk_mask")):
    """The serving client's whole codec per token: host clock around
    `client_encode_device` + `sections_to_bytes` (its `.cpu()` pulls
    synchronize) at one row of yi-6b's cut (1 x 1 x 4096 bf16, k 64,
    4-bit quant), median over CODEC_TOKENS calls after a warm-up; with the
    kernel launches one call makes."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.models.config import SplitConfig
    from repro_torch.split import protocol

    out = {}
    x = torch.randn((1, 1, D), generator=g, device=dev).to(torch.bfloat16)
    for name in names:
        comp = protocol.make_cut_compressor(SplitConfig(
            cut_layer=1, compressor=name, k=K))

        def token():
            p, sections = protocol.client_encode_device(comp, x)
            return enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)

        for _ in range(20):
            token()
        _lib.reset_launch_counts()
        token()
        per_call = {n: c for n, c in _lib.launch_counts().items() if c}
        times = []
        for _ in range(CODEC_TOKENS):
            t0 = time.perf_counter()
            token()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(ms=statistics.median(times), launches=per_call)
        print(f"  codec per token, {name}: client_encode_device + "
              f"sections_to_bytes {out[name]['ms']} ms (host clock, median "
              f"of {CODEC_TOKENS}, ends in the .cpu() pull); launches per "
              f"token {per_call}")
    return out


def probe_kernels(dev, g):
    """Host/device split of the codec's kernels at the shapes the paths
    give them (wrapper ms by CUDA events, device ms per launch from a
    profiler trace, host us per call with its allocation and bare launch):
    the standalone top-k, pack_bits, encode_rows and randtopk_mask,
    scatter_rows beside a fresh `zeros.scatter_add`, and the serve's
    flush decode and quantize (`probe_slots_quant`)."""
    import torch
    from repro_torch.core import selection
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.randtopk import ops as tk_ops
    from repro_torch.kernels.randtopk import ref as tk_ref

    out = {}
    rows_eval, _, d_tab, k_tab = _tabular_eval_shape()
    print("topk_mask_threshold, host/device split:")
    for label, rows, d, dt, k in (
            ("serving 1 x 4096 bf16 k 64", 1, D, torch.bfloat16, K),
            ("tabular 128 x 128 f32 k 3", 128, d_tab, torch.float32, k_tab),
            (f"tabular evaluation {rows_eval} x {d_tab} f32 k {k_tab}",
             rows_eval, d_tab, torch.float32, k_tab),
            ("1024 x 4096 bf16 k 64", TRAIN_ROWS, D, torch.bfloat16, K)):
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
        mask = torch.empty((rows, d), dtype=torch.bool, device=dev)
        thr = torch.empty((rows,), dtype=torch.float32, device=dev)
        args = (x.data_ptr(), int(dt == torch.bfloat16), rows, d, k,
                mask.data_ptr(), thr.data_ptr(), _lib.stream_handle(x))
        out["topk " + label] = split_probe(
            label, lambda: tk_ops.topk_mask_threshold(x, k),
            "topk_select_kernel",
            lambda: (torch.empty((rows, d), dtype=torch.bool, device=dev),
                     torch.empty((rows,), dtype=torch.float32,
                                 device=dev)),
            lambda: _lib.launch("topk_mask_threshold", *args),
            bound_ms(rows * (d * x.element_size() + d + 4), 5 * rows * d))
    print("pack_bits, host/device split:")
    for label, n, width in (
            ("serving 64 x 12-bit indices", K, W_IDX),
            ("fedtrain 128 x 3 x 7-bit indices", 128 * k_tab, 7)):
        idx = torch.randint(0, 1 << width, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        n_words = (n + 31) // 32 * width
        words = torch.empty((n_words,), dtype=torch.int32, device=dev)
        args = (idx.data_ptr(), n, width, words.data_ptr(),
                _lib.stream_handle(idx))
        out["pack_bits " + label] = split_probe(
            label, lambda: enc_ops.pack_bits(idx, width), "pack_bits_kernel",
            lambda: torch.empty((n_words,), dtype=torch.int32, device=dev),
            lambda: _lib.launch("pack_bits", *args),
            bound_ms(n * 4 + n_words * 4, n * 4))
    print("encode_rows (sparse, mask given), host/device split (no "
          "library call computes the same function):")
    for label, rows, d, dt, k in (
            ("serving 1 x 4096 bf16 k 64", 1, D, torch.bfloat16, K),
            ("fedtrain 128 x 128 f32 k 3", 128, d_tab, torch.float32,
             k_tab)):
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
        mask = tk_ref.topk_mask_threshold(x, k)[0]
        plan = enc_ops.encode_plan("sparse", x.shape, x.dtype, k, 0)
        p0 = enc_ops.launch_encode(plan, x, mask)
        args = (x.data_ptr(), plan.x_bf16, mask.data_ptr(), rows, d,
                plan.kind_id, k, 0, p0.values.data_ptr(),
                p0.indices.data_ptr(), 0, _lib.stream_handle(x))
        out["encode_rows " + label] = split_probe(
            label, lambda: enc_ops.encode_rows(x, "sparse", k=k, mask=mask),
            "encode_rows",
            lambda: [x.new_empty(s, dtype=t) for s, t in plan.leaves],
            lambda: _lib.launch("encode_rows", *args),
            bound_ms(rows * (d * x.element_size() + d + k * 8),
                     2 * rows * d))
    print("randtopk_mask, host/device split (no library call draws an "
          "Eq. 7 mask):")
    for label, rows, d, dt, k in (
            ("training cut 1024 x 4096 bf16 k 64", TRAIN_ROWS, D,
             torch.bfloat16, K),
            ("tabular 128 x 128 f32 k 3", 128, d_tab, torch.float32,
             k_tab)):
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
        gum = selection.gumbel_noise(g, x.shape, device=dev)
        m = selection.binomial_nontop_count(g, 0.1, k, d, (rows,),
                                            device=dev)
        m32 = m.to(torch.int32).contiguous()
        mask = torch.empty((rows, d), dtype=torch.bool, device=dev)
        args = (x.data_ptr(), int(dt == torch.bfloat16), gum.data_ptr(),
                m32.data_ptr(), rows, d, k, mask.data_ptr(),
                _lib.stream_handle(x))
        out["randtopk_mask " + label] = split_probe(
            label, lambda: tk_ops.randtopk_mask(x, gum, m, k),
            "randtopk_mask_kernel",
            lambda: torch.empty((rows, d), dtype=torch.bool, device=dev),
            lambda: _lib.launch("randtopk_mask", *args),
            bound_ms(rows * (d * x.element_size() + d * 4 + 4 + d),
                     15 * rows * d))
    out.update(probe_slots_quant(dev, g))
    print("scatter_rows beside a fresh zeros.scatter_add (1024 x 4096 bf16, "
          "k 64):")
    vals = torch.randn((TRAIN_ROWS, K), generator=g, device=dev).to(
        torch.bfloat16)
    idx = torch.sort(torch.randperm(D, generator=g, device=dev)[:K]).values
    idx = idx.expand(TRAIN_ROWS, K).to(torch.int32).contiguous()
    idx64 = idx.long()
    zeros = torch.zeros((TRAIN_ROWS, D), dtype=torch.bfloat16, device=dev)
    rec = dict(ms=time_ms(lambda: tk_ops.scatter_rows(vals, idx, D)),
               device_ms=device_ms(lambda: tk_ops.scatter_rows(vals, idx, D),
                                   "decode_rows_scatter_kernel")[0],
               fresh_ms=time_ms(lambda: zeros.scatter_add(-1, idx64, vals)),
               fresh_device_ms=device_ms(
                   lambda: zeros.scatter_add(-1, idx64, vals))[0])
    out["scatter_rows"] = rec
    print(f"  scatter_rows wrapper {rec['ms']} ms, device "
          f"{rec['device_ms']} ms; zeros.scatter_add(-1, idx, vals) "
          f"{rec['fresh_ms']} ms, device {rec['fresh_device_ms']} ms")
    return out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def probe_slots_quant(dev, g):
    """The host/device split of `decode_to_slots` at each serve kind's
    4-row bf16 flush (d 4096, one pad row on the scratch slot; the serve's
    arena of N_CLIENTS slots) and of `quantize` at a training cut and a
    serving flush (bf16, 4 bits). Uses only the wrappers and the C
    launchers, so a parent tree's package can be probed the same way."""
    import torch
    from repro_torch.core.payload import KINDS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.decode import ops as dec_ops
    from repro_torch.kernels.quant import ops as q_ops

    out = {}
    n, cap1 = 4, N_CLIENTS + 1
    print(f"decode_to_slots, host/device split ({n}-row flush of 4096 into "
          f"a ({cap1}, 1, 1, 4096) bf16 xbuf, one pad row on the scratch "
          f"slot; the wrapper allocates nothing):")
    slots = torch.tensor([0, 1, 2, cap1 - 1], dtype=torch.int32, device=dev)
    xbuf = torch.zeros((cap1, 1, 1, D), dtype=torch.bfloat16, device=dev)

    def flush(label, p):
        args = (xbuf.data_ptr(), 1, cap1, D, slots.data_ptr(), n,
                KINDS.index(p.meta.kind), p.meta.k, p.values.data_ptr(),
                0 if p.indices is None else p.indices.data_ptr(),
                0 if p.header is None else p.header.data_ptr(),
                _lib.stream_handle(xbuf))
        out["decode_to_slots " + label] = split_probe(
            label, lambda: dec_ops.decode_rows_to_slots(xbuf, p, slots),
            None, None, lambda: _lib.launch("decode_to_slots", *args),
            bound_ms(_nbytes(p.values, p.indices, p.header, slots)
                     + n * D * 2, n * D))

    for comp, kind, k, bits in SERVE_KINDS:
        flush(f"{comp} ({kind}) flush",
              _flush_payload(dev, g, kind, k, bits, n, D, n - 1))
    # a pad row's k zero values all sit at index 0; the same row with
    # nonzero values takes the scatter kernel's duplicate path (a second
    # barrier and k - 1 shared atomics on one address)
    p = _flush_payload(dev, g, "sparse", K, 0, n, D, n)
    p.indices[-1] = 0
    flush("randtopk (sparse) flush, last row k nonzero values at index 0",
          p)
    print("quantize, host/device split (no library call computes the same "
          "function):")
    for label, rows in (("training cut 1024 x 4096 bf16 4-bit", TRAIN_ROWS),
                        ("serving flush 4 x 4096 bf16 4-bit", N_CLIENTS)):
        x = torch.randn((rows, D), generator=g, device=dev).to(
            torch.bfloat16)
        code, deq, lo, step = q_ops.quantize(x, 4)
        args = (x.data_ptr(), 1, rows, D, 4, code.data_ptr(),
                deq.data_ptr(), lo.data_ptr(), step.data_ptr(),
                _lib.stream_handle(x))
        out["quantize " + label] = split_probe(
            label, lambda: q_ops.quantize(x, 4), None,
            lambda: (x.new_empty(x.shape, dtype=torch.uint8),
                     x.new_empty(x.shape),
                     x.new_empty((rows,), dtype=torch.float32),
                     x.new_empty((rows,), dtype=torch.float32)),
            lambda: _lib.launch("quantize", *args),
            quant_bound(rows, D, 2))
    return out


def probe_fused(dev, g):
    """The same host/device split for the fused client codec
    (`encode_sections`) at the serving row (select; quant) and the
    fedtrain batch (mask given)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.randtopk import ref as tk_ref

    out = {}
    print("encode_sections (the fused client codec), host/device split:")
    for label, shape, dt, kind, k, bits, select in (
            ("serving randtopk 1 x 4096 bf16 k 64, select", (1, D),
             torch.bfloat16, "sparse", K, 0, True),
            ("serving quant 1 x 4096 bf16 4-bit", (1, D),
             torch.bfloat16, "quant", 0, 4, False),
            ("fedtrain randtopk 128 x 128 f32 k 3, mask given",
             (128, 128), torch.float32, "sparse", 3, 0, False)):
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        mask = None if select or not k else \
            tk_ref.topk_mask_threshold(x, k)[0]
        plan = enc_ops.sections_plan(kind, x.shape, x.dtype, k, bits,
                                     select)
        bufs = enc_ops.sections_alloc(plan, x)
        args = enc_ops.sections_args(
            plan, x, 0 if mask is None else mask.data_ptr(), bufs)
        out["encode_sections " + label] = split_probe(
            label, lambda: enc_ops.encode_sections(
                x, kind, k=k, bits=bits, mask=mask, select=select),
            "encode_rows",
            lambda: enc_ops.sections_alloc(plan, x),
            lambda: _lib.launch("encode_sections", *args),
            sections_bound(shape[1], x.element_size(), kind, k, bits,
                           rows=shape[0], masked=mask is not None))
    return out


# ---------------------------------------------------------------------------
# phases 3-6: the serving path
# ---------------------------------------------------------------------------

# every served token's codec is one launch of the fused encode
PATH_KERNELS = {
    "randtopk": ("encode_sections", "decode_to_slots"),
    "identity": ("encode_sections", "decode_to_slots"),
    "quant": ("encode_sections", "decode_to_slots"),
    "randtopk_mask": ("encode_sections", "decode_to_slots"),
}
# what the fused encode does in its launch: none of these may run
NOT_ON_SERVING_PATH = ("topk_mask_threshold", "encode_rows", "pack_bits")


def _warm_decodes(max_batch, n_specs):
    """The server's warm-up flush decodes: per spec, two for each flush
    bucket (powers of two up to max_batch, and max_batch): its decode,
    then its fused step's."""
    buckets = {1 << i for i in range(max_batch.bit_length())} | {max_batch}
    return 2 * len(buckets) * n_specs


def _one_launch_per_token(res, counts, compressor):
    """The serve's counts show the fused encode once per client token (and
    once per compressor for the engine's warm-up step) and none of the
    kernels it replaced, and the flush decode once per flush (and twice
    per flush bucket in the server's warm-up: its decode, then its fused
    step's)."""
    frames = sum(s["frames_up"] for s in res["client_stats"])
    n_comps = len(set(res["compressor_objs"]))
    want = frames + n_comps
    if counts["encode_sections"] != want:
        fail(f"{compressor}: {counts['encode_sections']} fused encode "
             f"launches for {frames} client tokens and a warm-up step")
    extra = {n: counts[n] for n in NOT_ON_SERVING_PATH if counts[n]}
    if extra:
        fail(f"{compressor}: the serving codec launched {extra}")
    warm = _warm_decodes(res["max_batch"], n_comps)
    if counts["decode_to_slots"] != res["flushes"] + warm:
        fail(f"{compressor}: {counts['decode_to_slots']} flush decodes for "
             f"{res['flushes']} flushes and {warm} warm-up decodes")


def serve(cfg, params, compressor, *, gen, backend=None, trace=False,
          n_clients=N_CLIENTS, prompt_len=PROMPT_LEN, capacity=None,
          prompts=None, mesh=None):
    """One closed-loop run of `n_clients` sessions of `prompt_len` + `gen`
    tokens, the cut at n_layers // 2, `capacity` arena slots (None: one a
    session), `prompts` (None: the engine's draw), the server's arena
    sharded over `mesh` (None: one device); returns (result, launch
    counts of
    the run, analytic payload bytes per token). With `trace` the
    call runs under `torch.profiler`, and the result also holds the trace's
    device ms (`device_ms`) and the wall ms of the whole call, warm-up
    included (`call_ms`)."""
    from repro_torch.kernels import _lib
    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import engine
    from repro_torch.split import protocol

    scfg = cfg.with_(split=SplitConfig(cut_layer=cfg.n_layers // 2,
                                       compressor=compressor, k=K,
                                       backend=backend))
    densify0 = protocol.HOST_DENSIFY_COUNT.value
    _lib.reset_launch_counts()
    res, dev_ms, call_ms, _ = traced(lambda: engine.run_streaming(
        scfg, n_clients=n_clients, prompt_len=prompt_len, gen=gen,
        params=params, device="cuda", capacity=capacity, prompts=prompts,
        mesh=mesh), enabled=trace)
    res.update(device_ms=dev_ms, call_ms=call_ms)
    counts = _lib.launch_counts()
    if protocol.HOST_DENSIFY_COUNT.value != densify0:
        fail(f"{compressor}: host densification on the serving path")
    toks = res["tokens"]
    if toks.shape != (n_clients, gen) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        fail(f"{compressor}: tokens {toks.shape} out of shape/range")
    comp = res["compressor_objs"][0]
    want = comp.fwd_bits(cfg.d_model) / 8
    for s in res["client_stats"] + res["server_stats"]:
        got = s["payload_bytes_up"] / s["frames_up"]
        if got != want:
            fail(f"{compressor}: {got} payload B/token measured, {want} "
                 f"analytic")
    return res, counts, want


def step_times(cfg, params, n_clients, max_len, reps: int = 20):
    """Median host-clock ms of one client step (bottom layers + encode +
    pack + pull of the packed sections) and one server step (decode-free
    arena top step over `n_clients` rows + token readback), each alone and
    synchronized: what the serving loop would cost without its threads."""
    import numpy as np
    import torch
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.models import transformer
    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import steps
    from repro_torch.split import protocol

    dev = torch.device("cuda")
    cut = cfg.n_layers // 2
    comp = protocol.make_cut_compressor(SplitConfig(
        cut_layer=cut, compressor="randtopk", k=K))
    bottom = steps.make_bottom_step_device(cfg, cut, comp)
    top = steps.make_arena_top_step(cfg, cut)
    cache = transformer.init_cache(cfg, 1, max_len, device=dev)
    arena = transformer.init_cache(cfg, n_clients, max_len, device=dev)
    xbuf = torch.randn((n_clients + 1, 1, 1, cfg.d_model), device=dev).to(
        cfg.adtype())
    active = np.ones(n_clients, bool)
    tok = np.zeros((1, 1), np.int32)

    def client():
        p, sections = bottom(params, cache, tok)
        enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)

    def server():
        top(params, xbuf, arena, active).cpu()

    out = []
    for fn in (client, server):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        _, dev_ms, _, _ = traced(lambda: [fn() for _ in range(5)])
        out += [statistics.median(times), dev_ms and dev_ms / 5]
    return out


def traced(fn, enabled: bool = True, cpu: bool = True):
    """Run `fn()`, under `torch.profiler` when `enabled`; returns (its
    result, the summed duration in ms of the device work in the trace, the
    wall ms of `fn()` and a synchronize, the trace's device kernels as
    (name, ms, count) from the longest). The times are None when not
    traced, the device time also when the trace holds none; the list is
    then empty. Every thread launches on the one default stream, so
    durations do not overlap. `cpu=False` records the device activity
    only: the host's operator events of a launch-bound step cost most of
    a trace's time (tens of seconds at 20000-70000 launches a step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not enabled:
        return fn(), None, None, []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=lambda e: -e[1])
    ms = sum(e[1] for e in ev)
    return out, (ms if ms > 0 else None), wall_ms, ev


def serve_phase(dev, layers):
    """Phases 3-6: serve yi-6b through the codec. Returns the launch counts
    of the randtopk run (counts zeroed just before it)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get("yi-6b").with_(n_layers=layers)
    print(f"serving yi-6b: {cfg.n_layers} layers (cut at "
          f"{cfg.n_layers // 2}), d_model {cfg.d_model}, "
          f"{cfg.dtype}, {N_CLIENTS} clients x ({PROMPT_LEN} prompt + "
          f"{GEN} gen) tokens for randtopk, {GEN_OTHER} gen for the "
          f"other compressors")
    t0 = time.perf_counter()
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    print(f"init: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    res, counts, nb = serve(cfg, params, "randtopk", gen=GEN)
    missing = [n for n in PATH_KERNELS["randtopk"] if counts[n] == 0]
    if missing:
        fail(f"randtopk path never launched {missing}")
    _one_launch_per_token(res, counts, "randtopk")
    print(f"randtopk: {res['tokens'].size} tokens in {res['wall_s']} s, "
          f"{res['flushes']} flushes, {nb:.0f} payload B/token, "
          f"launches {counts}")
    again, _, _ = serve(cfg, params, "randtopk", gen=GEN)
    tps = [res["tokens_per_s"], again["tokens_per_s"]]
    if not (again["tokens"] == res["tokens"]).all():
        fail("randtopk tokens differ between two runs")
    print(f"randtopk tokens/s, two untraced runs: {tps[0]} and {tps[1]} "
          f"(spread {abs(tps[0] - tps[1]) / min(tps) * 100:.2f}%)")
    rounds = PROMPT_LEN + GEN - 1
    lat = [t for c in res["client_latencies"] for t in c]
    print(f"randtopk time: {res['wall_s'] / rounds * 1e3:.1f} ms per "
          f"round of {N_CLIENTS} tokens; client send->reply median "
          f"{statistics.median(lat) * 1e3:.1f} ms; serve loop s "
          f"{ {k: round(v, 4) for k, v in res['stage_s'].items()} }")
    tr, _, _ = serve(cfg, params, "randtopk", gen=GEN, trace=True)
    if tr["device_ms"] is None:
        print("randtopk loop busy share: not measured (the profiler "
              "trace held no device time)")
    else:
        busy = tr["device_ms"] / tr["call_ms"]
        print(f"randtopk loop under torch.profiler (warm-up included): "
              f"device time {tr['device_ms']} ms of {tr['call_ms']} ms "
              f"wall, card busy {busy * 100:.2f}%, idle "
              f"{(1 - busy) * 100:.2f}%; {tr['tokens_per_s']} tokens/s "
              f"traced")
    client_ms, client_dev, server_ms, server_dev = step_times(
        cfg, params, N_CLIENTS, PROMPT_LEN + GEN)
    print(f"steps alone (synchronized, median): client bottom + encode "
          f"+ pack + pull {client_ms:.2f} ms, server top step over "
          f"{N_CLIENTS} rows {server_ms:.2f} ms; device ms per step "
          f"(torch.profiler of calls made alone): client "
          f"{client_dev or 'not measured'}, server "
          f"{server_dev or 'not measured'}")
    plain, pcounts, _ = serve(cfg, params, "randtopk", backend="torch",
                              gen=GEN)
    if any(pcounts.values()):
        fail(f"plain-version run launched kernels {pcounts}")
    if not (plain["tokens"] == res["tokens"]).all():
        fail("randtopk tokens differ between kernels and plain versions")
    print(f"randtopk plain versions: same tokens, "
          f"{plain['tokens_per_s']} tokens/s")
    for comp in ("identity", "quant", "randtopk_mask"):
        r, c, nb = serve(cfg, params, comp, gen=GEN_OTHER)
        missing = [n for n in PATH_KERNELS[comp] if c[n] == 0]
        if missing:
            fail(f"{comp} path never launched {missing}")
        _one_launch_per_token(r, c, comp)
        print(f"{comp}: {r['tokens_per_s']} tokens/s, {nb:.0f} "
              f"payload B/token, launches {c}")
    del params
    torch.cuda.empty_cache()

    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import engine
    small = configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16))
    sp = transformer.init_model(small, torch.Generator().manual_seed(1))
    on_cpu = engine.run_streaming(small, n_clients=3, prompt_len=3,
                                  gen=4, params=sp, device="cpu")
    on_card = engine.run_streaming(
        small, n_clients=3, prompt_len=3, gen=4, device="cuda",
        params=_to(sp, dev))
    if not (on_cpu["tokens"] == on_card["tokens"]).all():
        fail("yi-6b SMOKE f32: card tokens != CPU tokens")
    print("yi-6b SMOKE f32: card tokens equal the CPU run")
    return counts


# ---------------------------------------------------------------------------
# phases 7-9: the training path
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_CUT = 8, 4     # yi-6b at full width, depth cut to fit
TRAIN_BATCH, TRAIN_SEQ = 4, 256    # 1024 tokens per step
TRAIN_STEPS = 10
TRAIN_OTHER_STEPS = 2              # each of the other compressors
TRAIN_PATH_KERNELS = {
    # forward: the Eq. (7) mask, the decode of the sparse payload;
    # backward: the scatter of the wire gradient onto the support
    "randtopk": ("randtopk_mask", "decode_rows", "scatter_rows"),
    "randtopk_mask": ("randtopk_mask", "decode_rows"),
    "quant": ("decode_rows",),
    "size_reduction": ("decode_rows",),
}


def _train_cfg(compressor, backend=None, layers=TRAIN_LAYERS,
               cut=TRAIN_CUT, smoke=False, k=K, arch="yi-6b"):
    from repro_torch.launch import train as train_cli

    return train_cli.build(arch, smoke=smoke, layers=layers,
                           split=compressor, k=k, cut=cut, backend=backend)


def _cut_probe(params, cfg, batch, seed, dev):
    """The first step's forward alone, under no autograd: the support the
    codec selects, the decoded view the top layers see, and the loss."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.split import protocol

    gen = torch.Generator(device=dev).manual_seed(seed)
    rt = Runtime(training=True)
    with torch.no_grad():
        x = transformer.embed(params, cfg, batch["tokens"])
        x, _ = transformer.apply_layers(params, cfg, rt, x, {}, 0,
                                        cfg.split.cut_layer)
        comp = protocol.make_cut_compressor(cfg.split)
        p = comp.encode(x, generator=gen, training=True)
        view = comp.decode(p, dtype=x.dtype)
        y, _ = transformer.apply_layers(params, cfg, rt, view, {},
                                        cfg.split.cut_layer, cfg.n_layers)
        ce = transformer.cross_entropy(transformer.lm_head(params, cfg, y),
                                       batch["labels"])
    return p.indices, view, ce


def _same_first_step(params, m, p_plain, m_plain,
                     what="kernels vs plain versions"):
    """The first training step with the kernels against the same step with
    the plain versions (or two runs of one, as `what` says): the backward
    runs `scatter_rows` on the wire gradient, so the gradient norm, the
    balance loss and every updated parameter (the layers below the cut and
    the embedding included) must be bit-identical."""
    import torch
    from repro_torch.optim.adamw import tree_leaves

    for key in ("loss", "aux", "grad_norm"):
        if not torch.equal(m[key], m_plain[key]):
            fail(f"first step {key} {float(m[key])} != "
                 f"{float(m_plain[key])} ({what})")
    names = _leaf_names(params)
    off = [(n, float((a.float() - b.float()).abs().max()))
           for n, a, b in zip(names, tree_leaves(params),
                              tree_leaves(p_plain)) if not torch.equal(a, b)]
    if off:
        fail(f"first step updated parameters differ ({what}; leaf, max "
             f"|diff|): {off}")
    print(f"first step, {what}: identical loss ({float(m['loss'])}), aux "
          f"({float(m['aux'])}), grad norm ({float(m['grad_norm'])}) and "
          f"{len(names)} updated parameter tensors")


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


def train_phase(dev):
    """yi-6b split training at full width through the cut codec. Returns
    the launch counts of the randtopk run (counts zeroed just before)."""
    import math

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init, tree_leaves

    cfg = _train_cfg("randtopk")
    rt = Runtime(training=True)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"training yi-6b: {cfg.n_layers} layers (cut at {TRAIN_CUT}), "
          f"d_model {cfg.d_model}, {cfg.dtype}, {n_params:,} params, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k={K} "
          f"alpha={cfg.split.alpha}, AdamW, remat={rt.remat}")
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batch0 = pipe.next_batch(0)

    # the first step's forward, kernels vs plain versions: same support,
    # same view, same loss; the plain run launches nothing
    _lib.reset_launch_counts()
    idx_p, view_p, ce_p = _cut_probe(params, _train_cfg("randtopk", "torch"),
                                     batch0, 1, dev)
    if any(_lib.launch_counts().values()):
        fail(f"plain-version forward launched {_lib.launch_counts()}")
    idx_k, view_k, ce_k = _cut_probe(params, cfg, batch0, 1, dev)
    if not (torch.equal(idx_k, idx_p) and torch.equal(view_k, view_p)
            and torch.equal(ce_k, ce_p)):
        fail("training forward: kernels and plain versions disagree")
    print(f"first forward, kernels vs plain versions: identical support, "
          f"view and loss ({float(ce_k)})")

    # the same first step (forward, backward, AdamW) with the plain
    # versions: no launch, the same loss, and (checked after the kernels'
    # first step) the same gradient norm and updated parameters
    plain_step = steps.make_train_step(_train_cfg("randtopk", "torch"), rt)
    _lib.reset_launch_counts()
    p_plain, opt_plain, m_plain = plain_step(
        params, adamw_init(params), batch0,
        torch.Generator(device=dev).manual_seed(1))
    del opt_plain                       # its f32 moments: 15 GB at 8 layers
    torch.cuda.synchronize()
    if any(_lib.launch_counts().values()):
        fail(f"plain-version step launched {_lib.launch_counts()}")
    torch.cuda.empty_cache()

    step = steps.make_train_step(cfg, rt)
    opt = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [pipe.next_batch(i) for i in range(TRAIN_STEPS + 3)]
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if i == 0:
            _same_first_step(params, m, p_plain, m_plain)
            del p_plain
            torch.cuda.reset_peak_memory_stats(dev)   # peak of steps 2-N
    counts = _lib.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    missing = [n for n in TRAIN_PATH_KERNELS["randtopk"] if counts[n] == 0]
    if missing:
        fail(f"training randtopk path never launched {missing}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"training losses not finite: {losses}")
    per_step = {n: counts[n] / TRAIN_STEPS for n in
                TRAIN_PATH_KERNELS["randtopk"]}
    print(f"randtopk training: losses {losses}; the first equals the "
          f"plain-version step's loss (the no-autograd forward gave "
          f"{float(ce_k)}); launches {counts} ({per_step} per step)")
    med = statistics.median(times[1:])
    print(f"train step (synchronized host clock, steps 2-{TRAIN_STEPS}): "
          f"median {med:.2f} ms, min {min(times[1:]):.2f}, max "
          f"{max(times[1:]):.2f}; first step {times[0]:.2f} ms; "
          f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s; peak "
          f"device memory of steps 2-{TRAIN_STEPS} {peak:.2f} GiB")

    def three_steps():
        nonlocal params, opt
        for b in batches[TRAIN_STEPS:]:
            params, opt, _ = step(params, opt, b, gen)

    _, dev_ms, wall_ms, kernels = traced(three_steps)
    if dev_ms is None:
        print("train step busy share: not measured (the profiler trace "
              "held no device time)")
    else:
        n = sum(c for _, _, c in kernels)
        print(f"3 train steps under torch.profiler: device time {dev_ms} ms "
              f"of {wall_ms} ms wall, card busy "
              f"{dev_ms / wall_ms * 100:.2f}%, idle "
              f"{(1 - dev_ms / wall_ms) * 100:.2f}%; {n / 3:.0f} device "
              f"kernels per step")
        print("  device ms per step by kernel, longest first:")
        for name, ms, count in kernels[:14]:
            print(f"    {ms / 3:9.3f} ms {count / 3:6.0f}x  {name[:110]}")
        # decode_rows (forward) and scatter_rows (backward) both launch
        # decode_rows_scatter_kernel: two launches a step under one name
        ours = {n: (sum(ms for k, ms, _ in kernels if n in k) / 3,
                    sum(c for k, _, c in kernels if n in k) / 3)
                for n in ("randtopk_mask_kernel",
                          "decode_rows_scatter_kernel")}
        print(f"  the codec kernels per step, (device ms, launches): {ours} "
              f"(decode_rows_scatter_kernel runs decode_rows and "
              f"scatter_rows)")

    for comp in ("randtopk_mask", "quant", "size_reduction"):
        other = steps.make_train_step(_train_cfg(comp), rt)
        _lib.reset_launch_counts()
        ls = []
        for i in range(TRAIN_OTHER_STEPS):
            params, opt, m = other(params, opt, batches[i], gen)
            ls.append(float(m["loss"]))
        c = _lib.launch_counts()
        missing = [n for n in TRAIN_PATH_KERNELS[comp] if c[n] == 0]
        if missing:
            fail(f"training {comp} path never launched {missing}")
        if not all(math.isfinite(v) for v in ls):
            fail(f"training {comp} losses not finite: {ls}")
        print(f"{comp} training: losses {ls}, launches {c}")
    del params, opt
    torch.cuda.empty_cache()
    return counts


def tabular_phase(dev):
    """The paper's two-party tabular trainer (Table 3's setting) for one
    epoch with randtopk, kernels against the plain versions on the card.
    Returns the kernel run's launch counts."""
    import torch
    from repro_torch.data.synthetic import ManyClassDataset
    from repro_torch.kernels import _lib
    from repro_torch.split import tabular

    ds = ManyClassDataset()
    out = {}
    for backend in ("torch", None):
        spec = tabular.SplitSpec(method="randtopk", backend=backend)
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        out[backend] = r = tabular.train(spec, ds, epochs=1, device="cuda")
        torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["launches"] = _lib.launch_counts()
    plain, kern = out["torch"], out[None]
    if any(plain["launches"].values()):
        fail(f"tabular plain-version run launched {plain['launches']}")
    if kern["launches"]["randtopk_mask"] < kern["steps"]:
        fail(f"tabular randtopk launched its mask kernel "
             f"{kern['launches']['randtopk_mask']} times in "
             f"{kern['steps']} steps")
    # one generator, one card and bit-identical masks, decodes and
    # scatters: the two runs train the same weights, bit for bit
    off = [f"{part}.{n}" for part in ("bottom", "top")
           for n in kern[part]
           if not torch.equal(kern[part][n], plain[part][n])]
    if off or kern["final_loss"] != plain["final_loss"]:
        fail(f"tabular training with kernels differs from the plain "
             f"versions: final loss {kern['final_loss']} vs "
             f"{plain['final_loss']}, differing tensors {off}")
    if kern["test_acc"] != plain["test_acc"]:
        fail(f"tabular test accuracy {kern['test_acc']} with kernels, "
             f"{plain['test_acc']} with the plain versions")
    if not kern["launches"]["topk_mask_threshold"]:
        fail("tabular randtopk never launched its evaluation's top-k")
    print(f"tabular randtopk (in 64, hidden 256, cut 128, 100 classes, "
          f"k={kern['k']}, batch 128, 1 epoch = {kern['steps']} steps): "
          f"final loss {kern['final_loss']} and every trained tensor "
          f"identical to the plain versions' run; test acc "
          f"{kern['test_acc']} (both runs); train bytes "
          f"{kern['train_bytes_measured']:.0f} measured, "
          f"{kern['train_bytes']:.0f} Table 2; wall {kern['wall_s']:.2f} s "
          f"kernels, {plain['wall_s']:.2f} s plain; launches "
          f"{kern['launches']}")
    return kern["launches"]


def smoke_train_cpu_vs_card(dev, n_steps=3, rtol=1e-5):
    """yi-6b SMOKE in f32, randtopk: the CPU's plain versions against the
    card's kernels, from one set of weights and batches. The RandTopK
    draws are made on the CPU for both runs, so both see the same noise."""
    import torch
    from repro_torch.core import selection
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init

    cfg = _train_cfg("randtopk", layers=None, cut=1, smoke=True, k=16)
    p0 = transformer.init_model(cfg, torch.Generator().manual_seed(2))
    pipe = TokenPipeline(cfg, 2, 32, seed=3, device="cpu")
    batches = [pipe.next_batch(i) for i in range(n_steps)]
    draw_m, draw_g = selection.binomial_nontop_count, selection.gumbel_noise
    losses = {}
    try:
        for device in ("cpu", "cuda"):
            cpu_gen = torch.Generator().manual_seed(4)
            selection.binomial_nontop_count = \
                lambda g, *a, device=None, **kw: draw_m(
                    cpu_gen, *a, **kw).to(device)
            selection.gumbel_noise = \
                lambda g, shape, device=None: draw_g(cpu_gen, shape).to(
                    device)
            params = _to(p0, device)
            opt = adamw_init(params)
            step = steps.make_train_step(cfg, Runtime(training=True),
                                         lr=1e-3)
            _lib.reset_launch_counts()
            losses[device] = []
            for b in batches:
                params, opt, m = step(params, opt, _to(b, device),
                                      torch.Generator())
                losses[device].append(float(m["loss"]))
            counts = _lib.launch_counts()
            launched = sum(counts[n] for n in TRAIN_PATH_KERNELS["randtopk"])
            if (device == "cpu") != (launched == 0):
                fail(f"SMOKE training on {device}: launches {counts}")
    finally:
        selection.binomial_nontop_count = draw_m
        selection.gumbel_noise = draw_g
    for a, b in zip(losses["cpu"], losses["cuda"]):
        if abs(a - b) > rtol * abs(a):
            fail(f"yi-6b SMOKE f32 training: card losses {losses['cuda']} "
                 f"!= CPU losses {losses['cpu']}")
    print(f"yi-6b SMOKE f32 training, {n_steps} steps: card losses "
          f"{losses['cuda']} vs CPU {losses['cpu']} (rtol {rtol})")


CKPT_ARCH, CKPT_LAYERS, CKPT_CUT = "granite-moe-1b-a400m", 2, 1
CKPT_STOP, CKPT_STEPS = 3, 6


def _du(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def train_ckpt_phase(dev):
    """`launch.train.main` with `--ckpt-dir`: granite-moe-1b-a400m at full
    width (d 1024, 32 experts, top-8), depth cut from 24 to 2 layers (the
    cut at 1), batch 4 x seq 256, randtopk k 64: 3 steps with a checkpoint
    every 3, then resumed to 6, equal 6 uninterrupted steps bit for bit
    (printed losses and final params). The checkpoints go to a temporary
    directory, removed afterwards; `store.save` and `store.restore` are
    timed where `main` calls them."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import store
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import tree_leaves

    timed = {"save": [], "restore": []}
    orig = {k: getattr(store, k) for k in timed}

    def timing(name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            timed[name].append(time.perf_counter() - t0)
            return out
        return call

    def run(steps, ckpt=None):
        argv = ["--arch", CKPT_ARCH, "--layers", str(CKPT_LAYERS), "--cut",
                str(CKPT_CUT), "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--split", "randtopk", "--k", str(K),
                "--steps", str(steps), "--log-every", "1"]
        if ckpt:
            argv += ["--ckpt-dir", ckpt, "--ckpt-every", str(CKPT_STOP)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            params = train_cli.main(argv)
        torch.cuda.synchronize()
        out = buf.getvalue()
        return params, out, re.findall(r"step +(\d+) (loss=\S+ ce=\S+ "
                                       r"aux=\S+ gnorm=\S+)", out)

    full, out, want = run(CKPT_STEPS)
    print(out.splitlines()[0])
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        for k in timed:
            setattr(store, k, timing(k))
        _, _, first = run(CKPT_STOP, ckpt)
        nbytes = _du(ckpt)
        _lib.reset_launch_counts()
        resumed, out_b, second = run(CKPT_STEPS, ckpt)
        counts = _lib.launch_counts()
    finally:
        for k, f in orig.items():
            setattr(store, k, f)
        shutil.rmtree(ckpt, ignore_errors=True)
    if f"restored step {CKPT_STOP}" not in out_b:
        fail(f"launch.train did not resume from step {CKPT_STOP}")
    if first + second != want or len(want) != CKPT_STEPS:
        fail(f"launch.train stopped at {CKPT_STOP} and resumed: "
             f"{first + second}, uninterrupted: {want}")
    off = [i for i, (a, b) in enumerate(zip(tree_leaves(resumed),
                                            tree_leaves(full)))
           if not torch.equal(a, b)]
    if off:
        fail(f"launch.train resumed params differ in leaves {off}")
    if counts["randtopk_mask"] != CKPT_STEPS - CKPT_STOP:
        fail(f"launch.train resumed run: launches {counts}")
    print(f"launch.train {CKPT_ARCH} ({CKPT_LAYERS} of 24 layers, full "
          f"width), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k {K}: "
          f"stopped at step {CKPT_STOP} with --ckpt-every {CKPT_STOP} and "
          f"resumed to {CKPT_STEPS} = {CKPT_STEPS} uninterrupted steps, bit "
          f"for bit (losses {[w[1] for w in want]}, every final param); "
          f"the resumed run's launches {counts}")
    print(f"launch.train checkpoint at step {CKPT_STOP} (params, opt, rng): "
          f"{nbytes} B on disk; store.save {['%.3f' % t for t in timed['save']]}"
          f" s (3 files a checkpoint, 2 checkpoints), store.restore "
          f"{['%.3f' % t for t in timed['restore']]} s (params, opt, rng)")
    return counts


# the codec kernels of a fedtrain step: up, the Eq. (7) mask and the
# fused encode (gather and bit-pack in one launch); at the label owner the
# decode; down, for sparse kinds, the scatter onto the support
FED_KERNELS = {"randtopk": ("randtopk_mask", "encode_sections",
                            "decode_rows", "scatter_rows"),
               "randtopk_mask": ("randtopk_mask", "encode_sections",
                                 "decode_rows")}
FED_EPOCHS_N4, FED_CKPT_EVERY, FED_STOP = 2, 20, 40
# the reference tests' fault plans and ARQ settings (`tests/test_faults.py`)
CHAOS_PLAN = dict(corrupt=0.06, truncate=0.03, drop=0.05, duplicate=0.05,
                  reorder=0.03, rechunk=0.15, max_faults=30)
ARQ = dict(retry_timeout=0.3, max_retries=40)
HEAVY_PLAN = dict(corrupt=0.25, truncate=0.08, drop=0.1, duplicate=0.1,
                  reorder=0.05, rechunk=0.2, max_faults=60)
HEAVY_ARQ = dict(retry_timeout=0.2, max_retries=60)


def _fed_bytes_ok(res, what):
    for direction in ("up", "down"):
        got = res[f"payload_bytes_{direction}"]
        want = res[f"analytic_bytes_{direction}"]
        if not abs(got - want) <= 0.05 * want:
            fail(f"fedtrain {what}: {got} B {direction} measured, {want} "
                 f"analytic")


def _fed_same(a, b, what):
    """Two fedtrain results: the same losses from step `b`'s first on,
    bytes, final k and final weights, bit for bit."""
    import torch

    start = b["losses"][0][0][0] if b["losses"][0] else 0
    for cid in range(a["n_clients"]):
        if b["losses"][cid] != [x for x in a["losses"][cid]
                                if x[0] >= start]:
            fail(f"fedtrain {what}: client {cid} losses differ")
    for key in ("payload_bytes_up", "payload_bytes_down", "header_bytes",
                "final_k"):
        if a[key] != b[key]:
            fail(f"fedtrain {what}: {key} {a[key]} vs {b[key]}")
    off = [n for x, y in zip(a["bottoms"] + [a["top"]],
                             b["bottoms"] + [b["top"]])
           for n in x if not torch.equal(x[n], y[n])]
    if off:
        fail(f"fedtrain {what}: final weights differ in {off}")


def _reg(res, name, **labels):
    """One series of a run's `metrics` snapshot: a counter's value, a
    histogram's sample count."""
    for s in res["metrics"][name]["series"]:
        if s["labels"] == labels:
            return s.get("value", s.get("count"))
    fail(f"no {name}{labels} series in the run's registry")


def _fed_registry_bytes(res, clean, what):
    """The registry's byte counters against the result's byte accounting.
    The client counts a step's frame once in its registry and every
    retransmission in its `SessionStats`; the server counts each frame it
    accepted in both."""
    cs, ss = res["client_stats"], res["server_stats"]
    checks = {
        "client payload up (registry) = clean payload_bytes_up":
            (_reg(res, "payload_bytes_total", party="client",
                  direction="up"), clean["payload_bytes_up"]),
        "server payload up (registry) = server stats":
            (_reg(res, "payload_bytes_total", party="server",
                  direction="up"), sum(s["payload_bytes_up"] for s in ss)),
        "server wire down (registry) = server stats":
            (_reg(res, "wire_bytes_total", party="server",
                  direction="down"), sum(s["bytes_down"] for s in ss)),
    }
    if res is clean:
        checks["client wire down (registry) = payload_bytes_down + "
               "framing"] = (
            _reg(res, "wire_bytes_total", party="client", direction="down"),
            res["payload_bytes_down"]
            + sum(s["header_bytes_down"] for s in cs))
    off = {k: v for k, v in checks.items() if v[0] != v[1]}
    if off:
        fail(f"fedtrain {what}: registry bytes disagree: {off}")
    print(f"fedtrain {what}: registry bytes agree: " + "; ".join(
        f"{k} ({a})" for k, (a, _) in checks.items()))


def fedtrain_chaos(spec, ds, clean, clean_counts, spec4, kw4, full):
    """Fedtrain under seeded chaos on the card, with the kernels already
    built (their first launch would spend the 0.3 s retransmit timer):
    (c) one randtopk client under `FaultPlan(seed=7)`, ARQ 0.3 s x 40, =
    the clean card run bit for bit, with the clean run's launches per
    logical step; (d) the heavy-corruption plan: reconnects and the clean
    losses; (e) four randtopk_mask clients under chaos complete every
    sync step, one Eq. (7) mask and one fused encode per logical step;
    (f) a traced clean run: the median host ms of the spans. Returns the
    launch counts of the three chaos runs, summed."""
    import torch
    from repro_torch.fedtrain import run_fedtrain
    from repro_torch.kernels import _lib
    from repro_torch.obs import trace
    from repro_torch.testing import (DESTRUCTIVE_FAULTS, FaultInjector,
                                     FaultPlan)

    _fed_registry_bytes(clean, clean, "N=1 clean")
    total = {}
    base = dict(n_clients=1, epochs=1, batch=128, seed=0, device="cuda")
    for name, plan, arq in (
            ("N=1 chaos", dict(seed=7, **CHAOS_PLAN), ARQ),
            ("N=1 heavy chaos", dict(seed=3, **HEAVY_PLAN), HEAVY_ARQ)):
        inj = FaultInjector(FaultPlan(**plan))
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_fedtrain(spec, ds, wrap_endpoint=inj, **arq, **base)
        wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        fc, injected = res["fault_counters"], inj.injected()
        if not sum(injected[f] for f in DESTRUCTIVE_FAULTS):
            fail(f"fedtrain {name}: no destructive fault injected "
                 f"({dict(injected)})")
        if not fc["replays"] + fc["duplicates"] + fc["reconnects"]:
            fail(f"fedtrain {name}: no recovery ran ({fc})")
        if name == "N=1 heavy chaos" and not fc["reconnects"]:
            fail(f"fedtrain {name}: no reconnect ({fc})")
        if res["losses"] != clean["losses"]:
            fail(f"fedtrain {name}: losses differ from the clean card run")
        off = [n for x, y in zip(res["bottoms"] + [res["top"]],
                                 clean["bottoms"] + [clean["top"]])
               for n in x if not torch.equal(x[n], y[n])]
        if off or res["mean_test_acc"] != clean["mean_test_acc"]:
            fail(f"fedtrain {name}: final weights differ in {off} (test acc "
                 f"{res['mean_test_acc']} vs {clean['mean_test_acc']})")
        # a replay resends bytes and the server re-acks from its cache:
        # the clean run's launches, one mask and one encode a logical step
        steps = res["steps"]
        if counts != clean_counts or \
                not counts["randtopk_mask"] == counts["encode_sections"] \
                == steps:
            fail(f"fedtrain {name}: launches {counts} for {steps} logical "
                 f"steps; the clean run's {clean_counts}")
        if res["payload_bytes_up"] < clean["payload_bytes_up"] or \
                res["analytic_bytes_up"] != clean["analytic_bytes_up"]:
            fail(f"fedtrain {name}: bytes up {res['payload_bytes_up']} "
                 f"measured, {res['analytic_bytes_up']} analytic; clean "
                 f"{clean['payload_bytes_up']}, "
                 f"{clean['analytic_bytes_up']}")
        print(f"fedtrain {name} ({steps} steps, retry "
              f"{arq['retry_timeout']} s x {arq['max_retries']}): injected "
              f"{dict(injected)}; fault counters {fc}; losses, test acc "
              f"and final weights = the clean card run, bit for bit; "
              f"launches {counts} (= the clean run's); "
              f"{res['payload_bytes_up']} B up / "
              f"{res['payload_bytes_down']} B down measured (clean "
              f"{clean['payload_bytes_up']} / "
              f"{clean['payload_bytes_down']}); wall {wall:.3f} s "
              f"(clean {clean['wall_s']:.3f})")
        _fed_registry_bytes(res, clean, name)

    inj = FaultInjector(FaultPlan(seed=21, **CHAOS_PLAN))
    _lib.reset_launch_counts()
    res = run_fedtrain(spec4, ds, wrap_endpoint=inj, **ARQ, **kw4)
    counts = _lib.launch_counts()
    for n, c in counts.items():
        total[n] += c
    syncs = [[s for s, _ in x] for x in res["losses"]]
    n_sync = sum(map(len, syncs))
    if res["steps"] != full["steps"] or \
            syncs != [[s for s, _ in x] for x in full["losses"]]:
        fail(f"fedtrain N=4 chaos: {res['steps']} steps, sync steps "
             f"{[len(x) for x in syncs]} against the clean run's")
    if not counts["randtopk_mask"] == counts["encode_sections"] == n_sync:
        fail(f"fedtrain N=4 chaos: launches {counts} for {n_sync} sync "
             f"steps")
    print(f"fedtrain N=4 randtopk_mask chaos ({res['steps']} steps, "
          f"{n_sync} sync steps): completed every client's sync steps; "
          f"injected {dict(inj.injected())}; fault counters "
          f"{res['fault_counters']}; launches {counts}; mean test acc "
          f"{res['mean_test_acc']} (clean {full['mean_test_acc']}); wall "
          f"{res['wall_s']:.3f} s")
    _fed_registry_bytes(res, full, "N=4 chaos")

    tracer = trace.Tracer()
    res = run_fedtrain(spec, ds, tracer=tracer, **base)
    if res["losses"] != clean["losses"]:
        fail("fedtrain traced run: losses differ from the clean run")
    for span, n in ((trace.SPAN_CLIENT_ENCODE, res["steps"]),
                    (trace.SPAN_QUEUE_WAIT, res["steps"])):
        ms = [e["dur"] * 1e3 for e in tracer.events()
              if e["name"] == span]
        if len(ms) != n:
            fail(f"fedtrain traced run: {len(ms)} {span} spans for {n} "
                 f"steps")
        print(f"fedtrain N=1 traced: {span} x {n}, host ms median "
              f"{statistics.median(ms):.4f}, min {min(ms):.4f}, max "
              f"{max(ms):.4f}")
    print(f"fedtrain N=1 traced: queue_wait_ms count "
          f"{_reg(res, 'queue_wait_ms')} = frames up "
          f"{_reg(res, 'frames_total', party='server', direction='up')}")
    return total


def fedtrain_phase(dev):
    """Federated split training over the wire on the card, at the tabular
    phase's paper widths: (a) one client with randtopk against
    `tabular.train` on the card; (b) four clients with randtopk_mask, the
    adaptive schedule and 4 local steps, stopped at step 40 and resumed
    from a checkpoint, against the uninterrupted run; then the same
    under seeded chaos (`fedtrain_chaos`)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.data.synthetic import ManyClassDataset
    from repro_torch.fedtrain import AsyncPolicy, ScheduleSpec, run_fedtrain
    from repro_torch.kernels import _lib
    from repro_torch.split import protocol, tabular

    ds = ManyClassDataset()
    spec = tabular.SplitSpec(method="randtopk")
    densify0 = protocol.HOST_DENSIFY_COUNT.value
    tab = tabular.train(spec, ds, epochs=1, batch=128, seed=0,
                        record_every=1, device="cuda")
    _lib.reset_launch_counts()
    fed = run_fedtrain(spec, ds, n_clients=1, epochs=1, batch=128, seed=0,
                       device="cuda")
    counts = _lib.launch_counts()
    tl = [t[2] for t in tab["trace"]]
    fl = [x for _, x in fed["losses"][0]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(fl, tl))
    if len(fl) != len(tl) or not rel <= 1e-5:
        fail(f"fedtrain N=1 losses differ from tabular.train (max rel "
             f"{rel})")
    off = [n for part, mine in (("bottom", fed["bottoms"][0]),
                                ("top", fed["top"]))
           for n in mine if not torch.equal(mine[n], tab[part][n])]
    if off:
        fail(f"fedtrain N=1 final weights differ from tabular.train: {off}")
    _fed_bytes_ok(fed, "N=1")
    missing = [n for n in FED_KERNELS["randtopk"] if not counts[n]]
    if missing:
        fail(f"fedtrain N=1 randtopk path never launched {missing}")
    # two codec launches a client step: the Eq. (7) mask and the encode
    if not counts["randtopk_mask"] == counts["encode_sections"] == \
            fed["steps"] or counts["pack_bits"] or counts["encode_rows"]:
        fail(f"fedtrain N=1: launches {counts} for {fed['steps']} steps")
    print(f"fedtrain N=1 randtopk ({fed['steps']} steps, batch 128): losses "
          f"equal tabular.train's on the card (max rel diff {rel}), final "
          f"weights identical; {fed['payload_bytes_up']} B up / "
          f"{fed['payload_bytes_down']} B down measured vs "
          f"{fed['analytic_bytes_up']:.0f} / "
          f"{fed['analytic_bytes_down']:.0f} analytic; wall "
          f"{fed['wall_s']:.3f} s, {fed['steps'] / fed['wall_s']:.1f} "
          f"steps/s; launches {counts}")
    _, dev_ms, wall_ms, _ = traced(lambda: run_fedtrain(
        spec, ds, n_clients=1, epochs=1, batch=128, seed=0, device="cuda"))
    if dev_ms is None:
        print("fedtrain N=1 busy share: not measured (no device time)")
    else:
        print(f"fedtrain N=1 under torch.profiler: device {dev_ms} ms of "
              f"{wall_ms} ms wall, card busy {dev_ms / wall_ms * 100:.2f}%")

    spec4 = tabular.SplitSpec(method="randtopk_mask")
    kw = dict(n_clients=4, epochs=FED_EPOCHS_N4, batch=128, seed=0,
              schedule=ScheduleSpec(k=spec4.k, d=spec4.cut_dim,
                                    anneal_steps=8,
                                    k0=min(spec4.cut_dim, 2 * spec4.k),
                                    k_min=max(1, spec4.k // 2)),
              policy=AsyncPolicy(local_steps=4, warmup_sync=8),
              max_wait=5.0, device="cuda")
    _lib.reset_launch_counts()
    full = run_fedtrain(spec4, ds, **kw)
    counts4 = _lib.launch_counts()
    _fed_bytes_ok(full, "N=4")
    missing = [n for n in FED_KERNELS["randtopk_mask"] if not counts4[n]]
    if missing:
        fail(f"fedtrain N=4 randtopk_mask path never launched {missing}")
    ckpt = tempfile.mkdtemp(prefix="fedtrain_ckpt_")
    try:
        killed = run_fedtrain(spec4, ds, ckpt_dir=ckpt,
                              ckpt_every=FED_CKPT_EVERY,
                              stop_after_steps=FED_STOP, **kw)
        resumed = run_fedtrain(spec4, ds, ckpt_dir=ckpt,
                               ckpt_every=FED_CKPT_EVERY, **kw)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if killed["steps"] != FED_STOP or \
            resumed["losses"][0][0][0] != FED_STOP:
        fail(f"fedtrain N=4: killed at {killed['steps']}, resumed at "
             f"{resumed['losses'][0][:1]}")
    _fed_same(full, resumed, "N=4 resumed vs uninterrupted")
    syncs = [len(x) for x in full["losses"]]
    print(f"fedtrain N=4 randtopk_mask, adaptive schedule, 4 local steps "
          f"({full['steps']} steps, {syncs} sync steps, final k "
          f"{full['final_k']}): stopped at {FED_STOP} and resumed from the "
          f"checkpoint = the uninterrupted run (losses, bytes, weights); "
          f"{full['payload_bytes_up']} B up / {full['payload_bytes_down']} "
          f"B down measured vs {full['analytic_bytes_up']:.0f} / "
          f"{full['analytic_bytes_down']:.0f} analytic; mean test acc "
          f"{full['mean_test_acc']}; wall {full['wall_s']:.3f} s, "
          f"{4 * full['steps'] / full['wall_s']:.1f} client steps/s; "
          f"launches {counts4}")
    again, dev_ms, wall_ms, _ = traced(lambda: run_fedtrain(spec4, ds,
                                                            **kw))
    _fed_same(full, again, "N=4 traced rerun vs first run")
    if dev_ms is None:
        print("fedtrain N=4 busy share: not measured (no device time)")
    else:
        print(f"fedtrain N=4 under torch.profiler: device {dev_ms} ms of "
              f"{wall_ms} ms wall, card busy {dev_ms / wall_ms * 100:.2f}%"
              f"; the rerun trained the same weights")
    chaos_counts = fedtrain_chaos(spec, ds, fed, counts, spec4, kw, full)
    if protocol.HOST_DENSIFY_COUNT.value != densify0:
        fail("fedtrain densified a payload on the host")
    print("fedtrain: HOST_DENSIFY_COUNT unchanged (0 host densifications)")
    return chaos_counts


# ---------------------------------------------------------------------------
# phase 11: open-loop serving — eviction, chaos, the load generator, traces
# ---------------------------------------------------------------------------

LG_CLIENTS, LG_PROMPT, LG_GEN = 6, 4, 8     # (a), (b): 6 x (4 + 8) tokens
# yi-6b's depth in the phase, cut from 32 so that the whole run stays
# within its time: a report is virtual time, a function of the seed, the
# vocabulary and the wire bytes, not of the depth (`loadgen_prediction`);
# 8, then 4 to pay for the procs phase
LG_LAYERS = 4
LG_RATES = {"static": (12.0, 24.0),          # the reference's `_mini`
            # raised from (12, 24), where the ladder moved 6 times but
            # reached only (32, 8) at d 4096 (`--phase predict`), until a
            # session reached the 4-bit rung
            "qos": (20.0, 40.0)}


def _metric(res, name) -> int:
    series = res["metrics"].get(name, {}).get("series", [])
    return int(series[0]["value"]) if series else 0


def _lg_config(kind, rate, burst):
    from repro_torch.runtime import loadgen as lg
    from repro_torch.runtime.qos import QoSSpec

    qos = None
    fleet = ("randtopk:k=64",)
    if kind == "qos":
        fleet = ("randtopk_quant:k=64,bits=8",)
        qos = QoSSpec(k=K, d=D, bits=8, bits_floor=4, k_floor=8,
                      high_depth=6, low_depth=2, deadline_s=0.04,
                      patience=16, cooldown=1)
    return lg.LoadGenConfig(
        seed=3, duration_s=2.5,
        arrivals=lg.ArrivalSpec(process="mmpp", rate=rate, burst_rate=burst,
                                mean_calm_s=1.0, mean_burst_s=1.0),
        fleet=lg.FleetSpec(compressors=fleet, prompt_len=(2, 3), gen=(3, 5),
                           bandwidth_Bps=400_000.0),
        service=lg.ServiceModel(1e-3, 1e-4, 3e-5),
        slo=lg.SLOSpec(p99_ms=60.0, max_reject_frac=0.02), qos=qos,
        capacity=16, max_batch=8, max_wait=0.004, admission_depth=24)


def _lg_warm(lgc):
    """(warm-up encodes, warm-up decodes) of a loadgen run: one bottom step
    per spec it can reach, and the server's warm-up decodes for each."""
    specs = len(lgc.qos.ladder()) if lgc.qos else len(lgc.fleet.compressors)
    return specs, _warm_decodes(lgc.max_batch, specs)


def _lg_launches_ok(kind, rep, counts, lgc):
    """The kernel run's launches: one fused encode per served token, one
    flush decode per (flush, meta) group, plus the warm-up's."""
    specs, warm_dec = _lg_warm(lgc)
    tokens = sum(len(v) for v in rep["trace"]["k_bits"].values())
    groups = rep["served"]["decode_groups"]
    if counts["encode_sections"] != tokens + specs:
        fail(f"loadgen {kind}: {counts['encode_sections']} fused encode "
             f"launches for {tokens} served tokens and {specs} warm-up "
             f"steps")
    if counts["decode_to_slots"] != sum(groups.values()) + warm_dec:
        fail(f"loadgen {kind}: {counts['decode_to_slots']} flush decodes "
             f"for {sum(groups.values())} (flush, meta) groups and "
             f"{warm_dec} warm-up decodes")
    extra = {n: c for n, c in counts.items()
             if c and n not in ("encode_sections", "decode_to_slots")}
    if extra:
        fail(f"loadgen {kind}: launched {extra} beside the serve's two "
             f"kernels")
    print(f"loadgen {kind} launches: encode_sections "
          f"{counts['encode_sections']} = {tokens} served tokens + {specs} "
          f"warm-up steps; decode_to_slots {counts['decode_to_slots']} = "
          f"{sum(groups.values())} (flush, meta) groups {groups} over "
          f"{rep['flushes']} flushes ({rep['served']['mixed_meta_flushes']}"
          f" mixed-meta) + {warm_dec} warm-up decodes")


def _lg_summary(kind, rep, rate, burst):
    s, lat = rep["sessions"], rep["latency_ms"]
    rungs = sorted({tuple(kb) for v in rep["trace"]["k_bits"].values()
                    for kb in v}, reverse=True)
    return (f"loadgen {kind} (mmpp {rate}/{burst} sessions/s, 2.5 s): "
            f"{s['arrived']} arrivals, {s['completed']} completed, "
            f"{s['rejected']} rejected, {rep['tokens_out']} tokens out, "
            f"{rep['flushes']} flushes, decode groups "
            f"{rep['served']['decode_groups']} "
            f"({rep['served']['mixed_meta_flushes']} mixed-meta flushes); "
            f"VIRTUAL-time latency p50 {lat['p50_ms']} / p99 "
            f"{lat['p99_ms']} ms (ServiceModel, not card time); qos "
            f"switches {rep['qos']['switches']}, rungs {rungs}, level hist "
            f"{rep['qos']['level_hist']}"), rungs


def loadgen_prediction() -> None:
    """`--phase predict`, on the CPU: the loadgen reports that phase 11
    must print. A report is a function of the seed, the vocabulary size
    (the prompts' `randrange(vocab)` draws share the fleet's random
    stream) and the wire bytes (virtual time; the bytes depend on d, k
    and bits, not on the weights), so a 2-layer f32 model of yi-6b's
    width and vocabulary gives the full model's report, but for
    `wall_s_real` and the tokens."""
    from repro_torch import configs
    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import loadgen as lg

    cfg = configs.get("yi-6b").with_(
        n_layers=2, d_ff=128, param_dtype="float32", dtype="float32",
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=K))
    # the QoS fleet at the static fleet's rates first: the reason its
    # rates were raised
    runs = [("qos", *LG_RATES["static"]), ("static", *LG_RATES["static"]),
            ("qos", *LG_RATES["qos"])]
    for kind, rate, burst in runs:
        lgc = _lg_config(kind, rate, burst)
        rep = lg.run_loadgen(cfg, lgc, device="cpu")
        print(_lg_summary(kind, rep, rate, burst)[0])
        specs, warm_dec = _lg_warm(lgc)
        frames = sum(len(v) for v in rep["trace"]["k_bits"].values())
        groups = sum(rep["served"]["decode_groups"].values())
        print(f"  launches on the card: encode_sections {frames + specs}, "
              f"decode_to_slots {groups + warm_dec}")


def loadgen_phase(dev, card):
    """Phase 11: open-loop serving of yi-6b at full width (`LG_LAYERS`
    of its 32 layers, cut at half, bf16, random weights from a seed) on
    the card. (a) LRU eviction to
    the host: 6 clients over 2 slots, with the kernels and with the plain
    versions, against 6 slots; (b) chaos: the same clients under seeded
    faults with ARQ; (c) the load generator, static and QoS, each with the
    kernels and then the plain versions: equal reports; (d) a traced
    closed-loop `launch/serve --trace`; (e) the trace gate on the card
    (`trace_smoke_on_card`). Returns the kernels' launches in (c), to
    add to the `kernels` line."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    from repro_torch.models.config import SplitConfig
    from repro_torch.obs.export import check_span_nesting
    from repro_torch.runtime import engine
    from repro_torch.runtime import loadgen as lg
    from repro_torch.testing import (DESTRUCTIVE_FAULTS, FaultInjector,
                                     FaultPlan)

    t_phase = time.perf_counter()
    cfg = configs.with_layers(configs.get("yi-6b"), LG_LAYERS)
    cut = cfg.n_layers // 2
    kern_cfg, plain_cfg = (cfg.with_(split=SplitConfig(
        cut_layer=cut, compressor="randtopk", k=K, backend=b))
        for b in (None, "torch"))
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"loadgen phase: yi-6b {cfg.n_layers} layers (cut at {cut}), "
          f"d_model {cfg.d_model}, {cfg.dtype}; {card}")

    # (a) eviction: contended with kernels and plain, uncontended
    kw = dict(n_clients=LG_CLIENTS, prompt_len=LG_PROMPT, gen=LG_GEN,
              max_batch=4, params=params, seed=0, device="cuda")
    runs = {}
    for name, c, cap in (("contended", kern_cfg, 2),
                         ("uncontended", kern_cfg, LG_CLIENTS),
                         ("contended plain", plain_cfg, 2)):
        _lib.reset_launch_counts()
        runs[name] = r = engine.run_streaming(c, capacity=cap, **kw)
        r["launches"] = _lib.launch_counts()
        print(f"eviction {name} (capacity {cap}): {r['wall_s']:.3f} s, "
              f"{r['flushes']} flushes, evictions "
              f"{_metric(r, 'slot_evictions_total')}, readmissions "
              f"{_metric(r, 'slot_readmissions_total')}, launches "
              f"{ {n: v for n, v in r['launches'].items() if v} }")
    ref = runs["uncontended"]["tokens"]
    for name in ("contended", "contended plain"):
        r = runs[name]
        if not np.array_equal(r["tokens"], ref):
            fail(f"eviction: {name} tokens differ from the uncontended "
                 f"run's")
        if not (_metric(r, "slot_evictions_total") > 0
                and _metric(r, "slot_readmissions_total") > 0):
            fail(f"eviction: the {name} run neither evicted nor "
                 f"re-admitted")
    if any(runs["contended plain"]["launches"].values()):
        fail("eviction: the plain-version run launched kernels")
    print("eviction: contended (kernels and plain) tokens equal the "
          "uncontended run's")

    # (b) chaos
    inj = FaultInjector(FaultPlan(seed=3, **CHAOS_PLAN))
    chaos = engine.run_streaming(kern_cfg, wrap_endpoint=inj, **ARQ, **kw)
    fc = chaos["fault_counters"]
    injected = dict(inj.injected())
    if not np.array_equal(chaos["tokens"], ref):
        fail("chaos: tokens differ from the clean run's")
    if not (fc["replays"] > 0 and fc["reconnects"] > 0
            and fc["server_faults_detected"] + fc["client_faults_detected"]
            > 0 and sum(injected.get(f, 0) for f in DESTRUCTIVE_FAULTS)):
        fail(f"chaos: the recovery did not engage: {fc}, injected "
             f"{injected}")
    print(f"chaos (FaultPlan seed 3, retry_timeout 0.3 s): tokens equal the "
          f"clean run's in {chaos['wall_s']:.3f} s; injected {injected}; "
          f"recovered {fc}")

    # (c) the load generator, kernels then plain versions
    launches = {"encode_sections": 0, "decode_to_slots": 0}
    for kind in ("static", "qos"):
        rate, burst = LG_RATES[kind]
        lgc = _lg_config(kind, rate, burst)
        _lib.reset_launch_counts()
        rep = lg.run_loadgen(kern_cfg, lgc, params=params, device="cuda")
        counts = _lib.launch_counts()
        prep = lg.run_loadgen(plain_cfg, lgc, params=params, device="cuda")
        if any(_lib.launch_counts()[n] != counts[n] for n in counts):
            fail(f"loadgen {kind}: the plain-version run launched kernels")
        a = {k: v for k, v in rep.items() if k != "wall_s_real"}
        b = {k: v for k, v in prep.items() if k != "wall_s_real"}
        if a != b:
            diff = sorted(k for k in a if a[k] != b.get(k))
            fail(f"loadgen {kind}: kernel and plain reports differ in "
                 f"{diff}")
        if rep["cv_waits"] != 0 or rep["sessions"]["failed"] != 0:
            fail(f"loadgen {kind}: cv_waits {rep['cv_waits']}, failed "
                 f"{rep['sessions']['failed']}")
        _lg_launches_ok(kind, rep, counts, lgc)
        for n in launches:
            launches[n] += counts[n]
        line, rungs = _lg_summary(kind, rep, rate, burst)
        if kind == "qos" and not (rep["qos"]["switches"] > 0
                                  and (8, 4) in rungs):
            fail(f"loadgen qos: {rep['qos']['switches']} switches, rungs "
                 f"{rungs}: the 4-bit rung was never reached")
        print(f"{line}; kernel report == plain report (tokens included); "
              f"wall_s_real {rep['wall_s_real']:.3f} s kernels, "
              f"{prep['wall_s_real']:.3f} s plain")

    # (d) a traced closed-loop run through the CLI
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_trace.json")
        serve_cli.main(["--arch", "yi-6b", "--layers", str(LG_LAYERS),
                        "--clients", "4", "--prompt-len", "4", "--gen", "8",
                        "--split", "randtopk", "--k", str(K), "--trace",
                        path])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    problems = check_span_nesting(events)
    if problems:
        fail(f"trace: spans straddle: {problems[:3]}")
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    print(f"trace ({len(events)} events, spans nest; host ms, median over "
          f"the spans; {card}): " + "; ".join(
              f"{n} x{len(v)} {statistics.median(v):.4f}"
              for n, v in sorted(spans.items())))
    trace_smoke_on_card(dev, card)
    print(f"loadgen phase wall: {time.perf_counter() - t_phase:.1f} s")
    return launches


def trace_smoke_on_card(dev, card):
    """(e) The trace gate (`repro_torch.testing.trace_smoke`, the port's
    `scripts/trace_smoke.py`) on the card: qwen3-8b SMOKE under the
    seeded open-loop scenario with chaos, traced twice. Fatal: the two
    files differ, the schema or the span nesting fails, or a lifecycle
    span or the admission, ARQ or QoS instant is missing."""
    from repro_torch.testing import trace_smoke

    t0 = time.perf_counter()
    problems, blob = trace_smoke.run(device=dev)
    if problems:
        fail(f"trace smoke on the card: {problems}")
    events = json.loads(blob)["traceEvents"]
    print(f"trace smoke on the card: {len(events)} events, two runs "
          f"byte-identical, schema, nesting, the 7 lifecycle spans and the "
          f"admission, ARQ and QoS instants present; "
          f"{time.perf_counter() - t0:.1f} s; {card}")


# ---------------------------------------------------------------------------
# phase 12: the qk-norm dense and mixture-of-experts families
# ---------------------------------------------------------------------------

# (arch, depth): full width; qwen3-moe's 94 layers (some 450 GB in bf16)
# cut to 4, cut at 2, to fit one card
FAMILY_SERVES = (("granite-moe-1b-a400m", None), ("qwen3-8b", None),
                 ("granite-3-8b", None), ("phi3-mini-3.8b", None),
                 ("qwen3-moe-235b-a22b", 4))
FAM_CLIENTS, FAM_PROMPT, FAM_GEN = 2, 4, 8
FAM_TRAIN = "granite-moe-1b-a400m"         # full: 24 layers, cut at 12
FAM_TRAIN_STEPS = 3


def held_gib(dev):
    """Free what earlier runs left to the cyclic collector; reset the
    peak. Returns the GiB still allocated, which a `peak_gib` after it
    excludes, so each peak is that model's own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev) / 2**30


def peak_gib(dev, base):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 - base


def _moe_drops(params, cfg, batch, seed, dev):
    """(token, expert) pairs dropped at capacity, summed over the moe
    layers, in the forward of the first step (its RandTopK draws, the plain
    versions, no autograd): `models.moe.route` wrapped to count them."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.config import Runtime
    from repro_torch.split import model as split_model

    route, dropped = moe.route, []

    def counting(probs, k, capacity):
        r = route(probs, k, capacity)
        n_slots = probs.shape[0] * probs.shape[2] * capacity
        dropped.append((r.slot == n_slots).sum())
        return r

    moe.route = counting
    try:
        with torch.no_grad():
            split_model.forward(params, cfg, Runtime(training=True), batch,
                                generator=torch.Generator(
                                    device=dev).manual_seed(seed))
    finally:
        moe.route = route
    return int(sum(dropped)), len(dropped)


def families_phase(dev, card):
    """Phase 12: serve each of the five qk-norm dense and moe models at
    full width through `run_streaming` (2 clients x (4 + 8) tokens,
    randtopk k 64, bf16, random weights from a seed), with the kernels and
    then the plain versions: equal tokens below the vocabulary, payload
    bytes per token = `fwd_bits(d) / 8`, one fused encode per served token
    and one flush decode per flush group, no host densification. Then
    train granite-moe-1b-a400m FULL (24 layers, cut 12, batch 4 x seq 256,
    randtopk k 64 alpha 0.1): two plain first steps equal each other and
    the kernels' first step bit for bit (loss, aux, grad norm, every
    updated parameter), aux > 0, 3 steps through the kernels. Returns the
    kernels' launches of the serves and the training run."""
    import collections
    import math

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init

    t_phase = time.perf_counter()
    total = collections.Counter()
    print(f"families phase: {FAM_CLIENTS} clients x ({FAM_PROMPT} prompt + "
          f"{FAM_GEN} gen) tokens, randtopk k={K}, bf16; {card}")
    for arch, layers in FAMILY_SERVES:
        cfg = configs.get(arch)
        if layers:
            cfg = cfg.with_(n_layers=layers)
        base = held_gib(dev)
        t0 = time.perf_counter()
        params = transformer.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        kw = dict(gen=FAM_GEN, n_clients=FAM_CLIENTS, prompt_len=FAM_PROMPT)
        res, counts, nb = serve(cfg, params, "randtopk", **kw)
        _one_launch_per_token(res, counts, f"{arch} randtopk")
        plain, pcounts, _ = serve(cfg, params, "randtopk", backend="torch",
                                  **kw)
        if any(pcounts.values()):
            fail(f"{arch}: plain-version run launched kernels {pcounts}")
        if not (plain["tokens"] == res["tokens"]).all():
            fail(f"{arch}: tokens differ between kernels and plain versions")
        total.update(counts)
        peak = peak_gib(dev, base)
        print(f"  {arch}: {cfg.n_layers} layers (cut at "
              f"{cfg.n_layers // 2}), d_model {cfg.d_model}, "
              f"{cfg.family}; kernel tokens = plain tokens "
              f"({res['tokens'].tolist()}); {nb} payload B/token "
              f"(fwd_bits(d) / 8); encode_sections "
              f"{counts['encode_sections']}, decode_to_slots "
              f"{counts['decode_to_slots']} launches ({res['flushes']} "
              f"flushes); {res['tokens_per_s']} tokens/s kernels, "
              f"{plain['tokens_per_s']} plain; init {init_s:.2f} s; peak "
              f"{peak:.2f} GiB (above the {base:.2f} GiB held before it)")
        del params
        torch.cuda.empty_cache()

    cfg = _train_cfg("randtopk", layers=None, cut=0, arch=FAM_TRAIN)
    plain_cfg = _train_cfg("randtopk", "torch", layers=None, cut=0,
                           arch=FAM_TRAIN)
    rt = Runtime(training=True)
    base = held_gib(dev)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batches = [pipe.next_batch(i) for i in range(FAM_TRAIN_STEPS)]
    print(f"training {FAM_TRAIN}: {cfg.n_layers} layers (cut at "
          f"{cfg.split.cut_layer}), d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.topk_experts}, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k={K} "
          f"alpha={cfg.split.alpha}, AdamW, remat={rt.remat}")
    plain_step = steps.make_train_step(plain_cfg, rt)
    _lib.reset_launch_counts()
    runs = []
    for _ in range(2):
        p1, _, m1 = plain_step(params, adamw_init(params), batches[0],
                               torch.Generator(device=dev).manual_seed(1))
        runs.append((p1, m1))
    torch.cuda.synchronize()
    if any(_lib.launch_counts().values()):
        fail(f"plain-version step launched {_lib.launch_counts()}")
    (p_plain, m_plain), (p_again, m_again) = runs
    del runs, p1
    _same_first_step(p_plain, m_plain, p_again, m_again,
                     "two runs of the plain versions")
    del p_again
    drops, n_moe = _moe_drops(params, plain_cfg, batches[0], 1, dev)
    step = steps.make_train_step(cfg, rt)
    opt = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    times, losses, auxes = [], [], []
    for i in range(FAM_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        if i == 0:
            _same_first_step(params, m, p_plain, m_plain)
            del p_plain
    counts = _lib.launch_counts()
    peak = peak_gib(dev, base)
    missing = [n for n in TRAIN_PATH_KERNELS["randtopk"] if counts[n] == 0]
    if missing:
        fail(f"{FAM_TRAIN} training never launched {missing}")
    if not all(math.isfinite(v) for v in losses + auxes):
        fail(f"{FAM_TRAIN} losses not finite: {losses}, aux {auxes}")
    if not all(a > 0 for a in auxes):
        fail(f"{FAM_TRAIN} balance loss not positive: {auxes}")
    total.update(counts)
    T = TRAIN_BATCH * TRAIN_SEQ
    cap = moe._capacity(T, cfg, rt.moe_capacity)
    print(f"  {FAM_TRAIN} training: losses {losses}, aux {auxes}; "
          f"launches {counts}; {drops} (token, expert) pairs dropped at "
          f"capacity {cap} of {T} tokens x {cfg.topk_experts} experts x "
          f"{n_moe} layers in the first step's forward; step ms "
          f"{[round(t, 2) for t in times]}, median of steps 2-"
          f"{FAM_TRAIN_STEPS} {statistics.median(times[1:]):.2f} ms; peak "
          f"{peak:.2f} GiB (the plain runs' two first steps included; "
          f"above the {base:.2f} GiB held before it); {card}")
    del params, opt
    torch.cuda.empty_cache()
    print(f"families phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


# the recurrent families: (arch, d, payload B a token at randtopk k 64,
# serving depth (None: full)). zamba2's depth is cut from 81 to 12 at full
# width (cut 6: a shared-attention site after layer 5 below the cut, one
# after layer 11 above it) and rwkv6's from 24 to 12 (cut 6) and then to
# 6 (cut 3) to keep the whole run inside its time
REC_SERVES = (("zamba2-7b", D_ZAMBA, 352, 12),
              ("rwkv6-1.6b", D_RWKV, 344, 6))
# (arch, layers (None: full depth), cut): zamba2's 81 layers hold 13.5 GB
# of bf16 weights, and with f32 AdamW moments leave no room for the
# activations at batch 4 x seq 256, so its training depth is cut to 12;
# rwkv6's (host-bound, ~2.5 s a step at 12 layers) to 6, cut 3, to keep
# the whole run inside its time
REC_TRAIN = (("zamba2-7b", 12, 6), ("rwkv6-1.6b", 6, 3))
REC_INT8 = "yi-6b"
REC_INT8_LAYERS = 8           # of 32 (cut 4): the whole run's time limit


def _busy_text(tr) -> str:
    """The card's busy share of a traced run (`traced`'s device ms over
    its wall ms)."""
    if tr[1] is None:
        return "busy share not measured (the trace held no device time)"
    busy = tr[1] / tr[2]
    return (f"device {tr[1]:.2f} ms of {tr[2]:.2f} ms wall under "
            f"torch.profiler, busy {busy * 100:.2f}%")


def _serve_pair(cfg, params, what, **kw):
    """The kernel serve and the plain-version serve of one config: equal
    tokens, one fused encode per served token and one flush decode per
    flush group, no launch in the plain run. Returns (kernel result, its
    launch counts, plain result, payload B a token)."""
    res, counts, nb = serve(cfg, params, "randtopk", **kw)
    _one_launch_per_token(res, counts, f"{what} randtopk")
    plain, pcounts, _ = serve(cfg, params, "randtopk", backend="torch", **kw)
    if any(pcounts.values()):
        fail(f"{what}: plain-version run launched kernels {pcounts}")
    if not (plain["tokens"] == res["tokens"]).all():
        fail(f"{what}: tokens differ between kernels and plain versions")
    return res, counts, plain, nb


def _evicted_serve(cfg, params, clean, kw):
    """`cfg` at capacity 1: the sessions take turns in one arena row, each
    switch evicting the row's state to the host and restoring it. On the
    card a one-row arena's top-step products round differently from a
    two-row arena's (the GEMM's reduction follows the row count), so the
    run is held to each session served alone in a one-row arena, from the
    same prompts; whether it also equals the two-row run `clean` is
    reported. Returns (result, launch counts, evictions, equal to
    `clean`)."""
    import numpy as np

    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (kw["n_clients"], kw["prompt_len"]))
    ev, counts, _ = serve(cfg, params, "randtopk", capacity=1,
                          prompts=prompts, **kw)
    _one_launch_per_token(ev, counts, f"{cfg.name} at capacity 1")
    n_ev = ev["metrics"]["slot_evictions_total"]["series"][0]["value"]
    alone = np.concatenate([serve(
        cfg, params, "randtopk", prompts=prompts[i:i + 1],
        **dict(kw, n_clients=1))[0]["tokens"] for i in range(len(prompts))])
    if n_ev <= 0 or not (ev["tokens"] == alone).all():
        fail(f"{cfg.name} at capacity 1: {n_ev} evictions, tokens "
             f"{ev['tokens'].tolist()}, each session alone "
             f"{alone.tolist()}")
    return ev, counts, n_ev, bool((ev["tokens"] == clean["tokens"]).all())


def _train_through_codec(dev, arch, layers, cut, card, smoke=False,
                         after_first=None):
    """Train one model through the codec (batch 4 x seq 256, randtopk k 64
    alpha 0.1, AdamW; `smoke`: the SMOKE config): two plain first steps
    equal each other and the kernels' first step bit for bit, then 3
    kernel steps; `after_first(params)` checks the weights after the
    first kernel step. Returns their launch counts."""
    import math

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init, tree_leaves

    cfg = _train_cfg("randtopk", layers=layers, cut=cut, arch=arch,
                     smoke=smoke)
    plain_cfg = _train_cfg("randtopk", "torch", layers=layers, cut=cut,
                           arch=arch, smoke=smoke)
    rt = Runtime(training=True)
    base = held_gib(dev)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batches = [pipe.next_batch(i) for i in range(FAM_TRAIN_STEPS)]
    print(f"training {arch}{' SMOKE' if smoke else ''}: {cfg.n_layers} "
          f"layers (cut at "
          f"{cfg.split.cut_layer}), d_model {cfg.d_model}, {n_params:,} "
          f"params, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k={K} "
          f"alpha={cfg.split.alpha}, AdamW, remat={rt.remat}")
    plain_step = steps.make_train_step(plain_cfg, rt)
    _lib.reset_launch_counts()
    runs = []
    for _ in range(2):
        p1, _, m1 = plain_step(params, adamw_init(params), batches[0],
                               torch.Generator(device=dev).manual_seed(1))
        runs.append((p1, m1))
    torch.cuda.synchronize()
    if any(_lib.launch_counts().values()):
        fail(f"{arch}: plain-version step launched {_lib.launch_counts()}")
    (p_plain, m_plain), (p_again, m_again) = runs
    del runs, p1
    _same_first_step(p_plain, m_plain, p_again, m_again,
                     f"{arch}, two runs of the plain versions")
    del p_again
    step = steps.make_train_step(cfg, rt)
    opt = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    times, losses = [], []
    for i in range(FAM_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if i == 0:
            _same_first_step(params, m, p_plain, m_plain,
                             f"{arch}, kernels vs plain versions")
            del p_plain
            if after_first is not None:
                after_first(params)
    counts = _lib.launch_counts()
    peak = peak_gib(dev, base)
    missing = [n for n in TRAIN_PATH_KERNELS["randtopk"] if counts[n] == 0]
    if missing:
        fail(f"{arch} training never launched {missing}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{arch} losses not finite: {losses}")
    tr = traced(lambda: step(params, opt, batches[0], gen))
    print(f"  {arch} training: losses {losses}; launches {counts}; step ms "
          f"{[round(t, 2) for t in times]}, median of steps 2-"
          f"{FAM_TRAIN_STEPS} {statistics.median(times[1:]):.2f} ms; a "
          f"fourth step: {_busy_text(tr)}; peak {peak:.2f} GiB (the plain "
          f"runs' two first steps included; above the {base:.2f} GiB held "
          f"before it); {card}")
    del params, opt, tr
    torch.cuda.empty_cache()
    return counts


def recurrent_phase(dev, card):
    """Phase 13: the recurrent families and the int8 KV arena at full
    width, random bf16 weights from a seed, randtopk k 64 at the cut. Serve
    zamba2-7b (depth cut to 12 layers, d 3584, cut 6) and rwkv6-1.6b (6,
    d 2048, cut 3) through `run_streaming`, 2 clients x (4 + 8) tokens,
    with the kernels and with the plain versions (equal tokens, 352 and 344 payload
    B a token, one fused encode per served token and one flush decode per
    flush group), and a traced third run for the busy share; rwkv6 again
    at capacity 1 (evictions > 0, the clean run's tokens). Serve yi-6b
    (`REC_INT8_LAYERS` of its 32 layers) with `kv_cache_bits=8` (the
    arena int8, the clients 16-bit), kernels
    and plain (equal tokens), and report its token agreement with the
    16-bit run. Train zamba2 (depth cut to 12, cut 6) and rwkv6 (12, cut
    6): first steps bit for bit against the plain versions, 3 steps.
    Returns the kernels' launches of the serves and the training runs."""
    import collections

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    total = collections.Counter()
    kw = dict(gen=FAM_GEN, n_clients=FAM_CLIENTS, prompt_len=FAM_PROMPT)
    print(f"recurrent phase: {FAM_CLIENTS} clients x ({FAM_PROMPT} prompt "
          f"+ {FAM_GEN} gen) tokens, randtopk k={K}, bf16; {card}")
    for arch, d, want_nb, layers in REC_SERVES:
        cfg = configs.with_layers(configs.get(arch), layers)
        base = held_gib(dev)
        t0 = time.perf_counter()
        params = transformer.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        res, counts, plain, nb = _serve_pair(cfg, params, arch, **kw)
        if cfg.d_model != d or nb != want_nb:
            fail(f"{arch}: {nb} payload B/token at d {cfg.d_model}, "
                 f"{want_nb} expected")
        total.update(counts)
        tr = traced(lambda: serve(cfg, params, "randtopk", **kw)[0])
        evict = ""
        if cfg.family == "ssm":
            ev, ecounts, n_ev, same2 = _evicted_serve(cfg, params, res, kw)
            total.update(ecounts)
            evict = (f"; at capacity 1: {n_ev} evictions, each session's "
                     f"tokens served alone in a one-row arena, "
                     f"{ev['tokens_per_s']} tokens/s (tokens equal to the "
                     f"two-row arena's run: {same2})")
        peak = peak_gib(dev, base)
        sites = [s >= 0 for s in transformer.attn_sites(cfg)]
        below = sum(sites[:cfg.n_layers // 2])
        print(f"  {arch}: {cfg.n_layers} layers (cut at "
              f"{cfg.n_layers // 2}; {cfg.family}"
              + (f", shared-attention sites {below} below the cut and "
                 f"{sum(sites) - below} above" if any(sites) else "")
              + f"), d_model {cfg.d_model}; kernel tokens = plain tokens "
              f"({res['tokens'].tolist()}); {nb} payload B/token "
              f"(fwd_bits(d) / 8); encode_sections "
              f"{counts['encode_sections']}, decode_to_slots "
              f"{counts['decode_to_slots']} launches ({res['flushes']} "
              f"flushes); {res['tokens_per_s']} tokens/s kernels, "
              f"{plain['tokens_per_s']} plain; a third run: "
              f"{_busy_text(tr)}{evict}; init {init_s:.2f} s; peak "
              f"{peak:.2f} GiB (above the {base:.2f} GiB held before it); "
              f"{card}")
        del params, tr
        torch.cuda.empty_cache()

    cfg16 = configs.with_layers(configs.get(REC_INT8), REC_INT8_LAYERS)
    cfg8 = cfg16.with_(kv_cache_bits=8)
    base = held_gib(dev)
    params = transformer.init_model(
        cfg16, torch.Generator(device=dev).manual_seed(0), device=dev)
    built, init_cache = [], transformer.init_cache

    def recording(cfg_, rows, max_len, device=None, bits=16, **kw):
        built.append((rows, bits))
        return init_cache(cfg_, rows, max_len, device, bits, **kw)

    transformer.init_cache = recording
    try:
        r8, c8, p8, _ = _serve_pair(cfg8, params, f"{REC_INT8} int8 KV",
                                    **kw)
    finally:
        transformer.init_cache = init_cache
    arena_bits = {bits for rows, bits in built if rows == FAM_CLIENTS}
    client_bits = {bits for rows, bits in built if rows == 1}
    if arena_bits != {8} or 16 not in client_bits:
        fail(f"int8 KV: caches built {sorted(set(built))}: the arena must "
             f"be int8 and the clients 16-bit")
    total.update(c8)
    r16, _, _ = serve(cfg16, params, "randtopk", **kw)
    agree = float(np.mean(r8["tokens"] == r16["tokens"]))
    peak = peak_gib(dev, base)
    print(f"  {REC_INT8} with kv_cache_bits=8 ({cfg8.n_layers} layers, "
          f"cut at {cfg8.n_layers // 2}; caches built (rows, bits) "
          f"{sorted(set(built))}): kernel tokens = plain tokens "
          f"({r8['tokens'].tolist()}); {r8['tokens_per_s']} tokens/s "
          f"kernels, {p8['tokens_per_s']} plain; token agreement with the "
          f"16-bit run {agree} ({r16['tokens_per_s']} tokens/s 16-bit); "
          f"peak {peak:.2f} GiB; {card}")
    del params
    torch.cuda.empty_cache()

    for arch, layers, cut in REC_TRAIN:
        total.update(_train_through_codec(dev, arch, layers, cut, card))
    print(f"recurrent phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 14: the vision and audio families
# ---------------------------------------------------------------------------

# the vlm at full width, depth cut from 100 to 10 layers (8 self + 2 gated
# cross; 21.3 GB of bf16 weights), cut at 5: one cross site on each side
VLM, VLM_LAYERS, VLM_NB = "llama-3.2-vision-90b", 10, 360
WHISPER, WHISPER_NB = "whisper-tiny", 328         # FULL: 4 layers, cut 2
LIVE_BATCH, LIVE_SEQ, LIVE_DECODE = 2, 64, 4       # the live-gate checks


def _set_gates(params, value):
    """Every cross layer's `gate` (attention and MLP) set to `value`, in
    place."""
    for sub in ("attn", "mlp"):
        params["cross_layers"][sub]["gate"].fill_(value)


def _split_logits(params, cfg, batch, dev):
    """One split forward (randtopk in training mode, draws from a seeded
    generator) under no autograd: the logits."""
    import torch
    from repro_torch.models.config import Runtime
    from repro_torch.split import model as split_model

    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        return split_model.forward(params, cfg, Runtime(training=True),
                                   batch, generator=gen)[0]


def _decode_tokens(params, cfg, extras, first, n, dev):
    """`n` greedy tokens of the split model from caches built with
    `extras` (`init_cache(params=, extras=)`): bottom layers, the cut
    codec (inference mode), top layers, one token a step for every row."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.split import protocol

    comp = protocol.make_cut_compressor(cfg.split)
    cut, rows = cfg.split.cut_layer, first.shape[0]
    tok, out = first, []
    with torch.no_grad():
        cache = transformer.init_cache(cfg, rows, n, device=dev,
                                       params=params, extras=extras)
        for _ in range(n):
            x = transformer.embed(params, cfg, tok)
            x = transformer.decode_layers(params, cfg, x, cache, 0, cut)
            x = comp.decode(comp.encode(x, training=False), dtype=x.dtype)
            x = transformer.decode_layers(params, cfg, x, cache, cut,
                                          cfg.n_layers)
            cache["pos"] += 1
            tok = torch.argmax(transformer.lm_head(params, cfg, x)[:, -1],
                               dim=-1)[:, None].to(torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1)


def _live_cross(params, cfg, dev, card):
    """The vlm's cross branch at full width with every gate at 0.5: a split
    forward over the pipeline's batch (patches (2, 1601, d)) with the
    kernels and with the plain versions, bit for bit, and unlike the
    gates-at-0 logits; then 4 decoded tokens from caches built with the
    patches, kernels = plain. Returns the kernels' launch counts."""
    import collections

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime, SplitConfig

    def with_backend(backend):
        return cfg.with_(split=SplitConfig(
            cut_layer=cfg.n_layers // 2, compressor="randtopk", k=K,
            backend=backend))

    batch = TokenPipeline(cfg, LIVE_BATCH, LIVE_SEQ, device="cuda"
                          ).next_batch(0)
    total = collections.Counter()
    _set_gates(params, 0.0)
    shut = _split_logits(params, with_backend(None), batch, dev)
    _set_gates(params, 0.5)
    _lib.reset_launch_counts()
    live = _split_logits(params, with_backend(None), batch, dev)
    torch.cuda.synchronize()
    total.update(_lib.launch_counts())
    plain = _split_logits(params, with_backend("torch"), batch, dev)
    if not torch.equal(live, plain):
        fail(f"{cfg.name} live cross forward: kernels != plain, max |diff| "
             f"{float((live.float() - plain.float()).abs().max())}")
    moved = float((live.float() - shut.float()).abs().max())
    if moved == 0.0:
        fail(f"{cfg.name}: the gates at 0.5 left the logits as at 0")
    with torch.no_grad():
        extras = transformer.make_extras(params, cfg, Runtime(
            training=False), batch)
    first = batch["tokens"][:, :1]
    _lib.reset_launch_counts()
    toks = _decode_tokens(params, with_backend(None), extras, first,
                          LIVE_DECODE, dev)
    torch.cuda.synchronize()
    total.update(_lib.launch_counts())
    ptoks = _decode_tokens(params, with_backend("torch"), extras, first,
                           LIVE_DECODE, dev)
    if not torch.equal(toks, ptoks) or int(toks.max()) >= cfg.vocab:
        fail(f"{cfg.name} decode with patches: kernels {toks.tolist()}, "
             f"plain {ptoks.tolist()}")
    print(f"  {cfg.name} cross branch live (gates 0.5): split forward over "
          f"{LIVE_BATCH} x {LIVE_SEQ} tokens with patches "
          f"{tuple(batch['patches'].shape)}, logits kernels = plain bit for "
          f"bit, max |logits - gates-at-0 logits| {moved}; {LIVE_DECODE} "
          f"decoded tokens from caches of the patches, kernels = plain "
          f"({toks.tolist()}); launches {dict(total)}; {card}")
    return total


def multimodal_phase(dev, card):
    """Phase 14: the vision and audio families, random bf16 weights from a
    seed, randtopk k 64 at the cut. Serve llama-3.2-vision-90b (depth cut
    to 10 layers, cut 5) and whisper-tiny FULL (4 layers, cut 2) through
    `run_streaming`, 2 clients x (4 + 8) tokens, kernels and plain (equal
    tokens, 360 and 328 payload B a token, one fused encode per served
    token and one flush decode per flush group), a traced third run for
    the busy share; the vlm's cross branch live at full width
    (`_live_cross`); train whisper-tiny FULL (cut 2) and the vlm at SMOKE
    (f32, cut 2): first steps bit for bit against the plain versions, 3
    steps, and the vlm's gates nonzero after its first step. Returns the
    kernels' launches of the serves, the live checks and the training
    runs."""
    import collections

    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    total = collections.Counter()
    kw = dict(gen=FAM_GEN, n_clients=FAM_CLIENTS, prompt_len=FAM_PROMPT)
    print(f"multimodal phase: {FAM_CLIENTS} clients x ({FAM_PROMPT} prompt "
          f"+ {FAM_GEN} gen) tokens, randtopk k={K}, bf16; {card}")
    for arch, layers, want_nb in ((VLM, VLM_LAYERS, VLM_NB),
                                  (WHISPER, None, WHISPER_NB)):
        cfg = configs.with_layers(configs.get(arch), layers)
        base = held_gib(dev)
        t0 = time.perf_counter()
        params = transformer.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tree_leaves(params))
        res, counts, plain, nb = _serve_pair(cfg, params, arch, **kw)
        if nb != want_nb:
            fail(f"{arch}: {nb} payload B/token at d {cfg.d_model}, "
                 f"{want_nb} expected")
        total.update(counts)
        tr = traced(lambda: serve(cfg, params, "randtopk", **kw)[0])
        peak = peak_gib(dev, base)
        print(f"  {arch}: {cfg.n_layers} layers (cut at {cfg.n_layers // 2}"
              f"; {cfg.family}), d_model {cfg.d_model}, {n_params:,} params;"
              f" kernel tokens = plain tokens ({res['tokens'].tolist()}); "
              f"{nb} payload B/token (fwd_bits(d) / 8); encode_sections "
              f"{counts['encode_sections']}, decode_to_slots "
              f"{counts['decode_to_slots']} launches ({res['flushes']} "
              f"flushes); {res['tokens_per_s']} tokens/s kernels, "
              f"{plain['tokens_per_s']} plain; a third run: "
              f"{_busy_text(tr)}; init {init_s:.2f} s; peak {peak:.2f} GiB "
              f"(above the {base:.2f} GiB held before it); {card}")
        del tr
        if cfg.family == "vlm":
            total.update(_live_cross(params, cfg, dev, card))
        del params
        torch.cuda.empty_cache()

    def gates_moved(params):
        for sub in ("attn", "mlp"):
            g = params["cross_layers"][sub]["gate"]
            if not bool((g != 0).all()):
                fail(f"{VLM} SMOKE: {sub} gates {g.tolist()} after the "
                     f"first step")
        print(f"  {VLM} SMOKE gates after the first step: attn "
              f"{params['cross_layers']['attn']['gate'].tolist()}, mlp "
              f"{params['cross_layers']['mlp']['gate'].tolist()}")

    total.update(_train_through_codec(dev, WHISPER, None, 2, card))
    total.update(_train_through_codec(dev, VLM, None, 2, card, smoke=True,
                                      after_first=gates_moved))
    print(f"multimodal phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 15: serving on a device mesh
# ---------------------------------------------------------------------------

MESH_ARCH, MESH_NB = "yi-6b", 352            # full width
MESH_LAYERS = 4               # of 32 (cut 2): the whole run's time limit
                              # (8 until the procs phase came)
MESH_GEN = 4                  # at 8 the phase took 190 s on an H100
                              # and the whole run passed 700 s
# (label, make_serving_mesh arguments): every position on the one card
MESH_SHAPES = (("(1, 1)", (1, {})), ("(4, 1)", (4, {})),
               ("(2, 2)", (4, {"model": 2})),
               ("(2, 2, 2)", (8, {"model": 2, "pod": 2})))
MESH_DRIVE_STEPS = 3


def _mesh_cache_leaves(cache):
    """A cache (a dict, or a mesh's list of per-position dicts) as one
    tensor per leaf over all rows."""
    import torch

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: v})
        return out
    if isinstance(cache, dict):
        return flat(cache)
    blocks = [flat(b) for b in cache]
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def _mesh_1x1_drive(cfg, params, dev, make_top_cache):
    """The (1, 1) mesh's step against the mesh-less step, driven directly
    on the same bf16 activations for `MESH_DRIVE_STEPS` steps (every row,
    then every other one, then the first): tokens of the active rows and
    every cache leaf bit for bit. Returns the leaf count."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.runtime import steps
    from repro_torch.runtime.arena import SlotArena

    cut, cap = cfg.n_layers // 2, N_CLIENTS
    g = torch.Generator(device=dev).manual_seed(3)
    xs = [torch.randn((cap + 1, 1, 1, cfg.d_model), generator=g,
                      device=dev).to(cfg.adtype())
          for _ in range(MESH_DRIVE_STEPS)]
    actives = [np.ones(cap, bool), np.arange(cap) % 2 == 0,
               np.arange(cap) == 0]
    out = []
    for mesh in (None, make_serving_mesh(1)):
        arena = SlotArena(make_top_cache, cap, (1, 1, cfg.d_model),
                          cfg.adtype(), dev, mesh=mesh)
        step = steps.make_arena_top_step(cfg, cut, mesh=mesh)
        toks = []
        for x, active in zip(xs, actives):
            arena.xbuf.copy_(x)
            toks.append(step(params, arena.xbuf, arena.cache,
                             active).cpu().numpy()[active])
        out.append((toks, _mesh_cache_leaves(arena.cache)))
    (t0, c0), (t1, c1) = out
    if any(not np.array_equal(a, b) for a, b in zip(t0, t1)):
        fail(f"mesh (1, 1) direct drive: tokens {t1} != mesh-less {t0}")
    bad = [k for k in c0 if c0[k].shape != c1[k].shape
           or not torch.equal(c0[k], c1[k])]
    if bad or c0.keys() != c1.keys():
        fail(f"mesh (1, 1) direct drive: cache leaves {bad} differ from "
             f"the mesh-less step's")
    return len(c0)


def _mesh_step_collectives(cfg, params, dev, mesh, make_top_cache, cap):
    """One sharded step, driven directly on an arena of `cap` requested
    rows with every row active: the collective bytes it counts per op and
    the closed form's (`serving_collective_costs`, bf16 activations)."""
    import numpy as np
    from repro_torch.mesh import collective_bytes
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.roofline import analysis
    from repro_torch.runtime import steps
    from repro_torch.runtime.arena import SlotArena

    arena = SlotArena(make_top_cache, cap, (1, 1, cfg.d_model), cfg.adtype(),
                      dev, mesh=mesh)
    registry = MetricsRegistry()
    step = steps.make_arena_top_step(cfg, cfg.n_layers // 2, mesh=mesh,
                                     registry=registry)
    step(params, arena.xbuf, arena.cache, np.ones(arena.capacity, bool))
    got = {k: float(v)
           for k, v in collective_bytes(registry.snapshot()).items()}
    want, _ = analysis.serving_collective_costs(
        cfg, arena.capacity, mesh.shape, dtype_bytes=2)
    return got, want


def _mesh_gap(cfg, params, ref, got, kw):
    """Where a mesh's tokens `got` differ from the mesh-less run's `ref`:
    rerun the mesh-less serve recording every row's top-2 logits at every
    position (`steps.top_logits`); every session's history agrees up to
    the first differing step, so the mesh-less logits there are the ones
    the mesh computed on the same inputs. Returns (session, step, top-2
    gap there, 2 bf16 ulps of its max logit)."""
    import math

    import numpy as np
    import torch
    from repro_torch.runtime import steps

    rec, orig = {}, steps.top_logits

    def recording(params_, cfg_, cut, xbuf, cache, rows):
        logits = orig(params_, cfg_, cut, xbuf, cache, rows)
        last = logits[:, -1, :].float()
        top = last.topk(2, dim=-1).values.cpu().tolist()
        tok = torch.argmax(logits[:, -1, :], dim=-1).cpu().tolist()
        pos = cache["pos"].cpu().tolist()
        for r in rows.cpu().tolist():
            rec[(r, pos[r])] = (top[r], tok[r])
        return logits

    steps.top_logits = recording
    try:
        again, _, _ = serve(cfg, params, "randtopk", **kw)
    finally:
        steps.top_logits = orig
    if not np.array_equal(again["tokens"], ref):
        fail("mesh-less serve: a rerun gave other tokens")
    first = [int(np.argmax(ref[s] != got[s])) if (ref[s] != got[s]).any()
             else len(ref[s]) for s in range(len(ref))]
    s = int(np.argmin(first))
    t, p = first[s], kw["prompt_len"] - 1 + first[s]
    rows = [r for (r, pos) in rec if pos == p and all(
        rec.get((r, kw["prompt_len"] - 1 + i), (None, None))[1] == ref[s][i]
        for i in range(t + 1))]
    if not rows:
        fail(f"mesh gap: no arena row served session {s}'s tokens")
    (top1, top2), _ = rec[(rows[0], p)]
    return s, t, top1 - top2, 2 * 2.0 ** (math.floor(math.log2(
        abs(top1))) - 7)


def mesh_phase(dev, card):
    """Phase 15: yi-6b at full width, 4 of its 32 layers (d 4096, padded
    vocab 64000, cut 2; `MESH_LAYERS`), random bf16 weights from a seed,
    served through `run_streaming` at `mesh=None` and on
    `make_serving_mesh` meshes whose positions all share the one card,
    4 clients x (4 + 4) tokens, randtopk k 64. Fatal:
    (1, 1) = mesh-less, tokens and (direct drive) every cache leaf bit for
    bit; kernels = plain under the pod mesh; 352 payload B a token; one
    fused encode a served token and one flush decode a flush group; at
    capacity 2 under (2, 2) evictions and readmissions >= 1 and the
    uncontended tokens; each step's counted collective bytes per op =
    `serving_collective_costs`, in the direct step and over the run's
    steps; tokens that differ from the mesh-less run only where its top-2
    logit gap is within 2 bf16 ulps of its max logit. Returns the kernels'
    launches of the kernel serves."""
    import collections

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.mesh import collective_bytes
    from repro_torch.models import transformer
    from repro_torch.runtime import engine

    t_phase = time.perf_counter()
    total = collections.Counter()
    cfg = configs.with_layers(configs.get(MESH_ARCH), MESH_LAYERS)
    kw = dict(gen=MESH_GEN, n_clients=N_CLIENTS, prompt_len=PROMPT_LEN)
    print(f"mesh phase: {MESH_ARCH} at full width ({cfg.n_layers} of 32 "
          f"layers, cut "
          f"{cfg.n_layers // 2}, d {cfg.d_model}, padded vocab "
          f"{cfg.padded_vocab}), {N_CLIENTS} clients x ({PROMPT_LEN} + "
          f"{MESH_GEN}) tokens, randtopk k={K}, bf16; every mesh position "
          f"on the one card; {card}")
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    _, make_top_cache = engine.cache_makers(cfg, PROMPT_LEN + MESH_GEN,
                                            dev, params)
    buckets = len({1 << i for i in range(N_CLIENTS.bit_length())
                   if (1 << i) <= N_CLIENTS} | {N_CLIENTS})

    def run(label, mesh, **extra):
        base = held_gib(dev)
        t0 = time.perf_counter()
        res, counts, nb = serve(cfg, params, "randtopk", mesh=mesh, **kw,
                                **extra)
        res["call_s"] = time.perf_counter() - t0
        if nb != MESH_NB:
            fail(f"mesh {label}: {nb} payload B/token, {MESH_NB} expected")
        run_bytes = collective_bytes(res["metrics"])
        _one_launch_per_token(res, counts, f"mesh {label} randtopk")
        total.update(counts)
        res["peak_gib"] = peak_gib(dev, base)
        res["run_bytes"] = run_bytes
        return res, counts

    ref, _ = run("None", None)
    print(f"  mesh=None: {ref['tokens_per_s']} tokens/s, wall "
          f"{ref['wall_s']:.3f} s (the call {ref['call_s']:.1f} s), peak {ref['peak_gib']:.2f} GiB; tokens "
          f"{ref['tokens'].tolist()}")
    leaves = _mesh_1x1_drive(cfg, params, dev, make_top_cache)
    results = {}
    for label, (n, spec) in MESH_SHAPES:
        mesh = make_serving_mesh(n, **spec)
        res, counts = run(label, mesh)
        results[label] = (mesh, res)
        got, want = _mesh_step_collectives(cfg, params, dev, mesh,
                                           make_top_cache, N_CLIENTS)
        if got != want:
            fail(f"mesh {label}: a step counted collective bytes {got}, "
                 f"serving_collective_costs {want}")
        n_steps = res["flushes"] + buckets + 1     # + the warm-up's steps
        run_want = {k: int(v) * n_steps for k, v in want.items()}
        if res["run_bytes"] != run_want:
            fail(f"mesh {label}: the run counted {res['run_bytes']} for "
                 f"{n_steps} steps, {run_want} expected")
        same = bool((res["tokens"] == ref["tokens"]).all())
        if label == "(1, 1)" and not same:
            fail(f"mesh (1, 1): tokens {res['tokens'].tolist()} != "
                 f"mesh=None's")
        note = "= mesh=None's tokens"
        if not same:
            s, t, gap, tol = _mesh_gap(cfg, params, ref["tokens"],
                                       res["tokens"], kw)
            if gap > tol:
                fail(f"mesh {label}: session {s} differs from mesh=None at "
                     f"step {t}, where the mesh-less top-2 logit gap {gap} "
                     f"exceeds 2 bf16 ulps ({tol})")
            note = (f"differs from mesh=None's first at session {s} step "
                    f"{t}, where the mesh-less top-2 logit gap is {gap} "
                    f"(2 bf16 ulps of the max logit: {tol}); tokens "
                    f"{res['tokens'].tolist()}")
        print(f"  mesh {label} {mesh.shape}: {res['tokens_per_s']} tokens/s,"
              f" wall {res['wall_s']:.3f} s (the call {res['call_s']:.1f} s),"
              f" peak {res['peak_gib']:.2f} GiB;"
              f" {note}; encode_sections {counts['encode_sections']}, "
              f"decode_to_slots {counts['decode_to_slots']} launches "
              f"({res['flushes']} flushes); collective bytes a step "
              f"counted {got}, serving_collective_costs {want}; over the "
              f"run's {n_steps} steps {res['run_bytes']}")
        if label == "(1, 1)":
            print(f"  mesh (1, 1) direct drive, {MESH_DRIVE_STEPS} steps: "
                  f"tokens and all {leaves} cache leaves bit for bit = "
                  f"mesh=None's")
    pod_mesh, pod = results["(2, 2, 2)"]
    plain, pcounts, _ = serve(cfg, params, "randtopk", backend="torch",
                              mesh=pod_mesh, **kw)
    if any(pcounts.values()):
        fail(f"mesh (2, 2, 2) plain run launched kernels {pcounts}")
    if not (plain["tokens"] == pod["tokens"]).all():
        fail("mesh (2, 2, 2): kernel tokens != plain tokens")
    print(f"  mesh (2, 2, 2) plain versions: kernel tokens = plain tokens, "
          f"{plain['tokens_per_s']} tokens/s")
    tp_mesh, uncontended = results["(2, 2)"]
    ev, _ = run("(2, 2) at capacity 2", tp_mesh, capacity=2)
    n_ev = ev["metrics"]["slot_evictions_total"]["series"][0]["value"]
    n_re = ev["metrics"]["slot_readmissions_total"]["series"][0]["value"]
    if n_ev < 1 or n_re < 1 or not (ev["tokens"] ==
                                    uncontended["tokens"]).all():
        fail(f"mesh (2, 2) at capacity 2: {n_ev} evictions, {n_re} "
             f"readmissions, tokens {ev['tokens'].tolist()} against "
             f"{uncontended['tokens'].tolist()}")
    print(f"  mesh (2, 2) at capacity 2 (padded to "
          f"{-(-2 // tp_mesh.size) * tp_mesh.size} rows): {n_ev} "
          f"evictions, {n_re} readmissions, the uncontended tokens; "
          f"{ev['tokens_per_s']} tokens/s")
    tr = traced(lambda: serve(cfg, params, "randtopk", mesh=pod_mesh,
                              **kw)[0])
    print(f"  mesh (2, 2, 2), a traced run: {_busy_text(tr)}; {card}")
    del params, tr
    torch.cuda.empty_cache()
    print(f"mesh phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 16: training on a device mesh
# ---------------------------------------------------------------------------

TRAINMESH_STEPS = 4           # kernel steps a mesh, after one plain step
# yi-6b's depth on the training meshes: 2 of its 32 layers (cut 1), cut
# from 8 to 4 and then to 2 to pay for the procs phase within the run's
# time
TRAINMESH_LAYERS, TRAINMESH_CUT = 2, 1
# (label, shape): ('data', 'model'), or ('pod', 'data', 'model') for three
TRAINMESH_SHAPES = (("(1, 1)", (1, 1)), ("(2, 4)", (2, 4)),
                    ("(2, 2, 2)", (2, 2, 2)))
TRAINMESH_MOE = ("(1, 4)", (1, 4))
TRAINMESH_MOE_LAYERS = 6      # granite-moe's, of 24 (cut 3): the run's time
# the other families on the training mesh, randtopk at cut_for's cut:
# (arch, depth (None: the config's), SMOKE, meshes after mesh=None).
# zamba2 and rwkv6 at full width with their depth cut (zamba2 12, cut 6,
# a shared-attention site on each side, so the tied weights take a
# gradient through the cut; rwkv6 2, cut 1: its 24 layers
# took 2.36-2.71 s a step mesh-less, host-bound, 6 at (2, 2) 31 s of
# the phase and 4 21.8 s); whisper-tiny FULL, its
# 6 heads split at 'model' 2 and whole at 4 (d_ff split); the vlm at
# SMOKE in f32 (10 full-width layers need ~128 GB with AdamW) on the pod
# ring
TRAINMESH_FAMILIES = (
    ("zamba2-7b", 12, False, (("(2, 2)", (2, 2)),)),
    ("rwkv6-1.6b", 2, False, (("(2, 2)", (2, 2)),)),
    ("whisper-tiny", None, False, (("(2, 2)", (2, 2)), ("(1, 4)", (1, 4)))),
    ("llama-3.2-vision-90b", None, True, (("(2, 2, 2)", (2, 2, 2)),)),
)


def _train_mesh(shape, dev):
    from repro_torch.launch.mesh import make_mesh

    if shape is None:
        return None
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, axes, devices=dev)


def _mesh_train_run(cfg, params, batches, dev, label, mesh, card):
    """One mesh's training through the codec: a first step with the plain
    versions (no launch), then `TRAINMESH_STEPS` kernel steps (counts
    zeroed just before) whose first equals it bit for bit; the codec once
    a batch shard a step (randtopk_mask, decode_rows and scatter_rows
    each); counted collective bytes of every step =
    `analysis.training_collective_costs`; step ms, peak and the busy
    share of an extra step traced on the device only. Returns (launch
    counts, the first kernel step's (params, metrics), a summary
    dict)."""
    import math

    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.mesh import collective_bytes
    from repro_torch.models.config import Runtime
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline import analysis

    t_run = time.perf_counter()
    plain_cfg = cfg.with_(split=dataclasses.replace(cfg.split,
                                                    backend="torch"))
    n_shards = 1 if mesh is None else mesh.size // mesh.shape["model"]
    want = {} if mesh is None else analysis.training_collective_costs(
        cfg, TRAIN_BATCH, TRAIN_SEQ, mesh.shape,
        act_bytes=cfg.adtype().itemsize,
        param_bytes=cfg.pdtype().itemsize)[0]
    base = held_gib(dev)
    reg_plain = MetricsRegistry()
    _lib.reset_launch_counts()
    p_plain, opt_plain, m_plain = steps.make_train_step(
        plain_cfg, Runtime(mesh=mesh, training=True, registry=reg_plain))(
        params, adamw_init(params), batches[0],
        torch.Generator(device=dev).manual_seed(1))
    del opt_plain
    torch.cuda.synchronize()
    if any(_lib.launch_counts().values()):
        fail(f"train mesh {label}: plain-version step launched "
             f"{_lib.launch_counts()}")
    torch.cuda.empty_cache()
    reg = MetricsRegistry()
    step = steps.make_train_step(cfg, Runtime(mesh=mesh, training=True,
                                              registry=reg))
    p, opt = params, adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    times, losses, first = [], [], None
    for i in range(TRAINMESH_STEPS):
        t0 = time.perf_counter()
        p, opt, m = step(p, opt, batches[i], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if i == 0:
            _same_first_step(p, m, p_plain, m_plain,
                             f"train mesh {label}, kernels vs plain "
                             f"versions")
            first = (p, m)
            del p_plain
            torch.cuda.reset_peak_memory_stats(dev)   # peak of steps 2-N
            got = {k: float(v)
                   for k, v in collective_bytes(reg.snapshot()).items()}
            plain_got = {k: float(v) for k, v in
                         collective_bytes(reg_plain.snapshot()).items()}
            if got != want or plain_got != want:
                fail(f"train mesh {label}: a step counted collective bytes "
                     f"{got} (plain: {plain_got}), "
                     f"training_collective_costs {want}")
    counts = _lib.launch_counts()
    run = {k: float(v) for k, v in collective_bytes(reg.snapshot()).items()}
    if run != {k: v * TRAINMESH_STEPS for k, v in want.items()}:
        fail(f"train mesh {label}: {TRAINMESH_STEPS} steps counted {run}, "
             f"{TRAINMESH_STEPS} x {want} expected")
    wrong = {n: counts[n] for n in TRAIN_PATH_KERNELS["randtopk"]
             if counts[n] != n_shards * TRAINMESH_STEPS}
    if wrong:
        fail(f"train mesh {label}: launches {wrong}, {n_shards} batch "
             f"shards x {TRAINMESH_STEPS} steps of each expected")
    if not all(math.isfinite(v) for v in losses):
        fail(f"train mesh {label}: losses not finite: {losses}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    t_trace = time.perf_counter()
    tr = traced(lambda: step(p, opt, batches[TRAINMESH_STEPS], gen),
                cpu=False)
    t_trace = time.perf_counter() - t_trace
    med = statistics.median(times[1:])
    print(f"  mesh {label}{'' if mesh is None else ' ' + str(mesh.shape)}: "
          f"losses {losses}; launches "
          f"{ {n: counts[n] for n in TRAIN_PATH_KERNELS['randtopk']} } "
          f"({n_shards} batch "
          f"shard(s) a step); step ms {[round(t, 2) for t in times]}, "
          f"median of steps 2-{TRAINMESH_STEPS} {med:.2f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s; a traced "
          f"step: {_busy_text(tr)}; peak of steps 2-{TRAINMESH_STEPS} "
          f"{peak:.2f} GiB ({base:.2f} GiB held before the mesh's first "
          f"step); "
          f"collective bytes a step {want or 'none'} = "
          f"training_collective_costs; the run's wall "
          f"{time.perf_counter() - t_run:.1f} s, of it the traced step "
          f"{t_trace:.1f} s; {card}")
    if tr[3]:
        print(f"    the traced step's device ms by kernel, longest first "
              f"({len(tr[3])} kernels, {sum(c for _, _, c in tr[3])} "
              f"launches): " + "; ".join(
                  f"{ms:.2f} ms {c}x {name[:60]}" for name, ms, c in
                  tr[3][:6]))
    del opt, tr
    torch.cuda.empty_cache()
    return counts, first, {"median_ms": med, "peak_gib": peak,
                           "loss0": losses[0]}


def _mesh_forward_f32(cfg, params, batch, dev):
    """The first batch's training loss, forward only, with the weights and
    activations in f32, at mesh=None and at each of `TRAINMESH_SHAPES`,
    through the identity codec (dense payload leaves: the pod ring moves
    them, the labels stay with their rows) and through randtopk (the same
    draws). Fatal: an identity-codec mesh loss off mesh=None's by more
    than 2e-4 (the reference's own bound). The randtopk losses are
    reported: a mask element that flips between two GEMM shapes moves a
    token's top-layer input, so they need not agree as closely. Returns
    {codec: {label: loss}}."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import tree_map

    p32 = tree_map(lambda t: t.float(), params)
    out = {}
    for codec in ("identity", "randtopk"):
        f32 = cfg.with_(param_dtype="float32", dtype="float32",
                        split=dataclasses.replace(cfg.split,
                                                  compressor=codec))
        out[codec] = {}
        for label, shape in (("None", None),) + TRAINMESH_SHAPES:
            rt = Runtime(mesh=_train_mesh(shape, dev), training=True)
            with torch.no_grad():
                loss, _ = steps.loss_fn(p32, f32, rt, batch, torch.Generator(
                    device=dev).manual_seed(1))
            out[codec][label] = float(loss)
    del p32
    torch.cuda.empty_cache()
    ident = out["identity"]
    off = {k: v - ident["None"] for k, v in ident.items()
           if abs(v - ident["None"]) > 2e-4}
    if off:
        fail(f"train mesh, f32 forward through the identity codec: losses "
             f"{ident}; off mesh=None's by more than 2e-4: {off}")
    return out


def trainmesh_phase(dev, card):
    """Phase 16: split training on a device mesh whose positions all share
    the one card. yi-6b at full width (d 4096, 32 heads, 4 KV heads, d_ff
    11008, vocab 64000), depth cut to 2 layers (cut 1), batch 4 x seq 256,
    randtopk k 64 alpha 0.1, bf16, AdamW, remat, random weights from a
    seed, at mesh=None, (1, 1), (2, 4) and (2, 2, 2) ('pod', 'data',
    'model'); granite-moe-1b-a400m at full width, `TRAINMESH_MOE_LAYERS`
    of its 24 layers (32 experts) at (1, 4); then `TRAINMESH_FAMILIES`:
    zamba2-7b (12 layers) and rwkv6-1.6b (2) at full width at mesh=None
    and (2, 2), whisper-tiny
    FULL at mesh=None, (2, 2) and (1, 4), the vlm SMOKE in f32 at
    mesh=None and (2, 2, 2). Fatal: at every mesh the kernels' first step
    = the plain versions' bit for bit (loss, aux, grad norm, every updated weight);
    (1, 1) = mesh=None bit for bit; the codec once a batch shard a step;
    counted collective bytes = `training_collective_costs`. Returns the
    kernels' launches of the kernel steps."""
    import collections

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    total = collections.Counter()
    cfg = _train_cfg("randtopk", layers=TRAINMESH_LAYERS, cut=TRAINMESH_CUT)
    print(f"train mesh phase: yi-6b at full width, {cfg.n_layers} layers "
          f"(cut at {TRAINMESH_CUT}), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"randtopk k={K}, bf16, AdamW, remat; every mesh position on the "
          f"one card; {card}")
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batches = [pipe.next_batch(i) for i in range(TRAINMESH_STEPS + 1)]
    counts, ref, res = _mesh_train_run(cfg, params, batches, dev, "None",
                                       None, card)
    total.update(counts)
    summary = {"None": res}
    for label, shape in TRAINMESH_SHAPES:
        counts, first, res = _mesh_train_run(
            cfg, params, batches, dev, label, _train_mesh(shape, dev), card)
        total.update(counts)
        summary[label] = res
        if label == "(1, 1)":
            _same_first_step(first[0], first[1], ref[0], ref[1],
                             "train mesh (1, 1) vs mesh=None")
            del ref
        del first
    torch.cuda.empty_cache()
    print("  first-step loss against mesh=None's "
          f"({summary['None']['loss0']}): " + ", ".join(
              f"{k} {v['loss0'] - summary['None']['loss0']:+.3g}"
              for k, v in summary.items() if k != "None"))
    for codec, f32 in _mesh_forward_f32(cfg, params, batches[0],
                                        dev).items():
        print(f"  the first batch's loss, forward only, weights and "
              f"activations in f32, {codec} codec: mesh=None "
              f"{f32['None']}; " + ", ".join(
                  f"{k} {v - f32['None']:+.3g}" for k, v in f32.items()
                  if k != "None") + (" (gate: 2e-4)" if codec == "identity"
                                     else " (reported)"))
    del params
    torch.cuda.empty_cache()

    label, shape = TRAINMESH_MOE
    mcfg = _train_cfg("randtopk", layers=TRAINMESH_MOE_LAYERS, cut=0,
                      arch=FAM_TRAIN)
    print(f"  {FAM_TRAIN}: {mcfg.n_layers} layers (cut at "
          f"{mcfg.split.cut_layer}), {mcfg.n_experts} experts over 'model' "
          f"{shape[-1]}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}")
    params = transformer.init_model(
        mcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    pipe = TokenPipeline(mcfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batches = [pipe.next_batch(i) for i in range(TRAINMESH_STEPS + 1)]
    counts, first, _ = _mesh_train_run(mcfg, params, batches, dev, label,
                                       _train_mesh(shape, dev), card)
    total.update(counts)
    if not float(first[1]["aux"]) > 0:
        fail(f"train mesh {label}: the moe's balance loss is "
             f"{float(first[1]['aux'])}")
    del first, params
    torch.cuda.empty_cache()
    for arch, layers, smoke, meshes in TRAINMESH_FAMILIES:
        total.update(_family_mesh_runs(arch, layers, smoke, meshes, dev,
                                       card))
    print(f"train mesh phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


def _family_mesh_runs(arch, layers, smoke, meshes, dev, card):
    """One of `TRAINMESH_FAMILIES` through `_mesh_train_run` at mesh=None
    and at each of `meshes`; prints each mesh's first loss against
    mesh=None's. Returns the kernel steps' launches."""
    import collections

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import tree_leaves

    t0 = time.perf_counter()
    total = collections.Counter()
    cfg = _train_cfg("randtopk", layers=layers, cut=0, arch=arch,
                     smoke=smoke)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  {arch}{' SMOKE' if smoke else ''} ({cfg.family}): "
          f"{cfg.n_layers} layers (cut at {cfg.split.cut_layer}), d_model "
          f"{cfg.d_model}, {n_params:,} params, {cfg.dtype}, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k={cfg.split.k}")
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batches = [pipe.next_batch(i) for i in range(TRAINMESH_STEPS + 1)]
    loss0 = {}
    for label, shape in (("None", None),) + meshes:
        counts, first, res = _mesh_train_run(
            cfg, params, batches, dev, f"{arch} {label}",
            _train_mesh(shape, dev), card)
        total.update(counts)
        loss0[label] = res["loss0"]
        del first
    print(f"  {arch}: first-step loss against mesh=None's "
          f"({loss0['None']}): " + ", ".join(
              f"{k} {v - loss0['None']:+.3g}" for k, v in loss0.items()
              if k != "None") + f"; {time.perf_counter() - t0:.1f} s; "
          f"{card}")
    del params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 22: the training mesh and the decode mesh across processes
# ---------------------------------------------------------------------------

# training: (arch, depth (None: the config's), cut (0: cut_for's), mesh,
# SMOKE, steps). Each of the 4 processes that share the card holds its
# blocks of the parameters and f32 moments (`launch.specs.
# param_shardings`) and gathers the whole parameters for its step.
# yi-6b at full width, 2 of its 32 layers (cut 1; about 0.87 B
# parameters);
# granite-moe-1b-a400m at full width, 4 of its 24 layers (cut 2), its 32
# experts over 'model' 4; zamba2-7b at full width, 6 of its 81 layers
# (cut 3: its one shared-attention site of 6 layers, layer 5, above the
# cut; 112 Mamba2 and 32 attention heads over 'model' 4; 0.903 B
# parameters, yi's size); rwkv6-1.6b at full width, 2 of 24 (cut 1);
# whisper-tiny FULL, frames from the seed; the vlm at SMOKE with patches
# from the seed, every gate at 0.5 (its smallest full-width model with a
# whole-group cut, 10 layers, is 10.66 B parameters: gathered whole in
# each of 4 processes it is far beyond 80 GB, blocks or not).
# The new configs run 2 steps: the checks need steps 1 and 2 only
PROCS_RUNS = (("yi-6b", 2, 1, (2, 2), False, 3),
              (FAM_TRAIN, 4, 2, (1, 4), False, 3),
              ("zamba2-7b", 6, 3, (1, 4), False, 2),
              ("rwkv6-1.6b", 2, 1, (2, 2), False, 2),
              ("whisper-tiny", None, 0, (2, 2), False, 2),
              ("llama-3.2-vision-90b", None, 0, (2, 2), True, 2))
# decoding (`launch.steps.make_serve_step`, B `STEP_BATCH`, a ring of
# `STEP_MAX_LEN` slots, `PROCS_TOKENS` greedy tokens from an empty cache,
# flash decode): (arch, depth, mesh, SMOKE); whisper's (2, 1, 2) over
# ('pod', 'data', 'model') carries its encoder output over the pod ring
# as the caches are built, and `next_tokens`' inverse ring every token
PROCS_DECODE = (("yi-6b", 4, (1, 4), False),
                (FAM_TRAIN, 6, (2, 2), False),
                ("zamba2-7b", 6, (1, 4), False),
                ("rwkv6-1.6b", 2, (2, 2), False),
                ("whisper-tiny", None, (2, 1, 2), False),
                ("llama-3.2-vision-90b", None, (2, 2), True))
PROCS_TOKENS = 8
# serving (`run_streaming`, the sharded arena) with one process a
# position, as the mesh phase serves on the single controller: yi-6b at
# full width, `MESH_LAYERS` of its 32 (cut 2), `N_CLIENTS` clients x
# (`PROMPT_LEN` + `MESH_GEN`) tokens, randtopk k 64; (label, mesh,
# capacity, backend): 'data' x 'model' (2, 2), 'pod' x 'data' x 'model'
# (2, 1, 2) over the pod ring, (2, 2) at capacity 2 (evictions and
# re-admissions whose rows cross between processes) and (2, 1, 2) with
# the plain versions
PROCS_SERVES = (("(2, 2)", (2, 2), None, None),
                ("(2, 1, 2)", (2, 1, 2), None, None),
                ("(2, 2) at capacity 2", (2, 2), 2, None),
                ("(2, 1, 2) plain", (2, 1, 2), None, "torch"))
# each training config's peak a process when every process held the
# whole parameters and f32 moments (GiB, NVIDIA H100 80GB HBM3, 700 W),
# printed beside the resident blocks' peak
PROCS_WHOLE_PEAK_GIB = {"yi-6b": 16.78, FAM_TRAIN: 6.09, "zamba2-7b": 18.00,
                        "rwkv6-1.6b": 7.74, "whisper-tiny": 1.50,
                        "llama-3.2-vision-90b": 0.12}
# ... and when every process held its param and moment blocks at rest
# but gathered the whole parameters for a step (PERF.md section 5, the
# same card), printed beside the use blocks' peak
PROCS_BLOCK_PEAK_GIB = {"yi-6b": 5.34, FAM_TRAIN: 2.33, "zamba2-7b": 6.02,
                        "rwkv6-1.6b": 2.37, "whisper-tiny": 0.84,
                        "llama-3.2-vision-90b": 0.10}
PROCS_WORLD = 4               # the processes, one set for every config
PROCS_TIMEOUT_S = 600         # the processes' join
# the grad norm of the processes' first step against the single
# controller's: the processes add the bf16 gradients of the positions
# in position order, the single controller's autograd in its own order
PROCS_GNORM_RTOL = 1e-3
# the summed gradient against the single controller's, each leaf's
# 2-norm of the difference over its own (over the ranks' blocks, each
# distinct block once): AdamW's first moment after step
# 1 is 0.1 g (clipped alike), so it carries the gradient itself, where
# the first update is about lr sign(g) and hides a wrong sum. On the card
# the two sides' bf16 gradients come out of kernels that reduce in other
# orders: an element passes through up to 5 bf16 roundings a side (its
# position's gradient, then up to 4 adds), each off by 2^-8 relative at
# most, so 10 x 2^-8 = 3.9e-2 bounds the difference where the terms do
# not cancel (measured: 7.3e-3 the median leaf, 1.06e-2 the largest).
# A sum that drops a position's term is off by 0.5 or more, a negated
# or misplaced one by 1 or more.
PROCS_GRAD_RTOL = 5e-2
# the share of the updated weights (the ranks' blocks, each distinct
# block once) more than 1 bf16 ulp off the single controller's (0.151%
# yi, 0.660% moe measured on rank 0's whole weights, none over 1 ulp):
# where |w| < 2^-4 a negated gradient moves a weight by 2 lr, over 2 ulps,
# a zeroed one by lr, over 1 ulp
PROCS_ULP_SHARE = 0.02


def _procs_axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _procs_model(arch, layers, cut, smoke, dev):
    """A config of the procs phase and its weights from seed 0 on the card
    (the vlm's gates at 0.5, so its cross branch reaches the loss)."""
    import torch
    from repro_torch.models import transformer

    cfg = _train_cfg("randtopk", layers=layers, cut=cut, arch=arch,
                     smoke=smoke)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if cfg.family == "vlm":
        _set_gates(params, 0.5)
    return cfg, params


def _procs_rank(rank, dev, single_paths):
    """One process of the procs phase: each of `PROCS_RUNS` in turn
    (`_procs_run`), then each of `PROCS_DECODE` (`_procs_decode`), then
    each of `PROCS_SERVES` (`_procs_serve`), the card's memory freed
    between them. Returns (the training runs' results, the decode runs',
    the serving runs')."""
    import torch

    train, decode, served = [], [], []
    for run, path in zip(PROCS_RUNS, single_paths):
        train.append(_procs_run(rank, dev, *run, path))
        torch.cuda.empty_cache()
    for run in PROCS_DECODE:
        decode.append(_procs_decode(dev, *run, procs=True))
        torch.cuda.empty_cache()
    for run in PROCS_SERVES:
        served.append(_procs_serve(rank, dev, *run))
        torch.cuda.empty_cache()
    return train, decode, served


def _serve_cfg(backend=None):
    """The mesh phase's yi-6b at full width, `MESH_LAYERS` of 32, cut at
    half, randtopk k 64 (`backend`: None the kernels, "torch" the plain
    versions)."""
    from repro_torch import configs
    from repro_torch.models.config import SplitConfig

    cfg = configs.with_layers(configs.get(MESH_ARCH), MESH_LAYERS)
    return cfg.with_(split=SplitConfig(cut_layer=cfg.n_layers // 2,
                                       compressor="randtopk", k=K,
                                       backend=backend))


def _procs_serve(rank, dev, _label, shape, capacity, backend):
    """One serving config of the procs phase in one process: every rank
    calls `run_streaming` on its process mesh (weights from seed 0, the
    engine's prompts), launch counts zeroed just before; rank 0 serves,
    the others follow it. Returns the launches, the call's s, peak GiB,
    the counted bytes and, on rank 0, the tokens, flushes, client tokens,
    payload B a token, slot counters, tokens/s and the serving wall; on
    the others the steps taken; every rank also the bytes of the params
    it served with and of its use blocks (`launch.specs.use_layouts(...,
    "arena")`, `specs.block_bytes`)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.mesh import collective_bytes
    from repro_torch.models.config import Runtime
    from repro_torch.runtime import engine

    mesh = make_process_mesh(shape, _procs_axes(shape), dev)
    cfg = _serve_cfg(backend)
    whole = specs.abstract_params(cfg)
    use_bytes = specs.block_bytes(whole, specs.use_layouts(
        cfg, Runtime(mesh=mesh), "arena", whole), mesh.shape)
    base = held_gib(dev)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.run_streaming(
        cfg, n_clients=N_CLIENTS, prompt_len=PROMPT_LEN,
        gen=MESH_GEN, device=dev, capacity=capacity, mesh=mesh, seed=0)
    torch.cuda.synchronize()
    out = {"launches": _lib.launch_counts(),
           "call_s": time.perf_counter() - t0,
           "peak_gib": peak_gib(dev, base),
           "param_bytes": res["param_bytes"], "use_bytes": use_bytes,
           "bytes": {k: float(v) for k, v in
                     collective_bytes(res["metrics"]).items()}}
    if rank != 0:
        return dict(out, steps=res["steps"])
    stats = res["client_stats"] + res["server_stats"]
    return dict(out, tokens=res["tokens"], flushes=res["flushes"],
                frames=sum(s["frames_up"] for s in res["client_stats"]),
                n_comps=len(set(res["compressor_objs"])),
                max_batch=res["max_batch"],
                payload_b={s["payload_bytes_up"] / s["frames_up"]
                           for s in stats},
                counters=[_metric(res, name) for name in (
                    "slot_evictions_total", "slot_readmissions_total")],
                tokens_per_s=res["tokens_per_s"], wall_s=res["wall_s"])


def _procs_run(rank, dev, arch, layers, cut, shape, smoke, n_steps,
               single_path):
    """One training config of the procs phase in one process: its
    training at the process's position of the process mesh, holding its
    blocks of the parameters and AdamW moments (`launch.specs.
    param_shardings`), `n_steps` steps from the seeds the single
    controller used (launch counts zeroed just before). Every rank holds
    its first step's weight and first-moment blocks against the same
    blocks of the single controller's (`single_path`). Returns the
    metrics, counted bytes, launches, step ms, each step's gradient
    reduce ms and parameter gather ms (each call synchronized around
    it), held parameter bytes and the two moves' bytes sent, the use
    blocks' bytes (`specs.block_bytes` of `use_layouts(..., "train")`),
    peak and at-rest GiB, set-up s, the block of each leaf it holds and
    the digests of its blocks and of the gathered weights after step
    2."""
    import hashlib

    import torch
    from repro_torch import mesh as mesh_mod
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.config import Runtime
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.optim.adamw import adamw_init, tree_leaves

    def digests(ts):
        return [hashlib.sha256(t.detach().cpu().contiguous().view(-1)
                               .view(torch.uint8).numpy().tobytes())
                .hexdigest() for t in ts]

    t_enter = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_process_mesh(shape, _procs_axes(shape), dev)
    cfg, params = _procs_model(arch, layers, cut, smoke, dev)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device=str(dev))
    batches = [pipe.next_batch(i) for i in range(n_steps)]
    reg = MetricsRegistry()
    rt = Runtime(mesh=mesh, training=True, registry=reg)
    step = steps.make_train_step(cfg, rt)
    whole = specs.abstract_params(cfg)
    layouts = specs.param_shardings(cfg, rt, whole)
    p = specs.shard_tree(mesh, params, layouts)
    del params
    opt = adamw_init(p)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"reduce_ms": [], "gather_ms": [], "param_bytes": [],
           "gather_sent": [], "reduce_sent": [],
           "use_bytes": specs.block_bytes(whole, specs.use_layouts(
               cfg, rt, "train", whole, seq=TRAIN_SEQ), mesh.shape),
           "rest_gib": sum(t.numel() * t.element_size() for t in
                           tree_leaves(p) + tree_leaves(opt["mu"])
                           + tree_leaves(opt["nu"])) / 2**30,
           "blocks": [mesh_mod.block_of(mesh, rank, lay)
                      for lay in tree_leaves(layouts)]}
    moves = {"reduce_ms": mesh_mod.reduce_to_block,
             "gather_ms": mesh_mod.gather}
    acc = dict.fromkeys(moves, 0.0)

    def timed(key):
        # the step's gradient reduces and parameter gathers, each timed
        # where the step calls it, summed over a step
        fn = moves[key]

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[key] += (time.perf_counter() - t0) * 1e3
            return got
        return run

    mesh_mod.reduce_to_block = timed("reduce_ms")
    mesh_mod.gather = timed("gather_ms")
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t_enter
    torch.cuda.reset_peak_memory_stats(dev)
    _lib.reset_launch_counts()
    times = []
    try:
        for i in range(n_steps):
            acc.update(dict.fromkeys(moves, 0.0))
            t0 = time.perf_counter()
            p, opt, m = step(p, opt, batches[i], gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for key in moves:
                out[key].append(acc[key])
            for key in ("param_bytes", "gather_sent", "reduce_sent"):
                out[key].append(int(m[key]))
            if i == 0:
                out["metrics"] = {k: float(v) for k, v in m.items()}
                out["bytes1"] = mesh_mod.collective_bytes(reg.snapshot())
                out["vs_single"] = _against_single(
                    p, opt["mu"], single_path, dev, mesh, layouts)
            out.setdefault("losses", []).append(float(m["loss"]))
        out["launches"] = _lib.launch_counts()
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    finally:
        mesh_mod.reduce_to_block, mesh_mod.gather = moves.values()
    out["bytes"] = mesh_mod.collective_bytes(reg.snapshot())
    out["times"] = times
    # after the last step: this rank's blocks, and the weights gathered
    out["digests"] = digests(tree_leaves(p))
    out["gathered"] = [digests([mesh_mod.gather(mesh, b, lay, w.shape)])[0]
                       for b, lay, w in zip(tree_leaves(p),
                                            tree_leaves(layouts),
                                            tree_leaves(whole))]
    return out


def _procs_decode(dev, arch, layers, shape, smoke, procs):
    """One decode config of the procs phase: `PROCS_TOKENS` greedy tokens
    of `make_serve_step` from an empty cache of `STEP_MAX_LEN` slots,
    flash decode, on the process's position of a process mesh (`procs`)
    or on the single controller's mesh of the same shape, weights,
    prompts and side inputs from the seeds of `familystep_phase` (launch
    counts zeroed just before the tokens). Returns the tokens (B,
    PROCS_TOKENS), each token's per-position last logits (the process's
    own on a process mesh, None elsewhere; on the host), the counted
    bytes of the steps and of the cache's build, launches, each step's
    ms, peak GiB, the bytes of the params decoded with (on a process
    mesh its use blocks, `use_layouts(..., "decode")`, made before the
    cache) and of those use blocks by `specs.block_bytes`."""
    import torch
    from repro_torch import mesh as mesh_mod
    from repro_torch.kernels import _lib
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.specs import decode_cache
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.split import model as split_model

    mesh = (make_process_mesh(shape, _procs_axes(shape), dev) if procs
            else _train_mesh(shape, dev))
    base = held_gib(dev)
    cfg, params = _procs_model(arch, layers, 0, smoke, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (STEP_BATCH, 1), generator=g,
                            device=dev)
    side = None
    if cfg.family in ("vlm", "audio"):
        name = "patches" if cfg.family == "vlm" else "frames"
        side = {name: (torch.randn(
            (STEP_BATCH, transformer.cross_tokens(cfg), cfg.d_model),
            generator=g, device=dev) * 0.02).to(cfg.adtype())}
    reg, cache_reg = MetricsRegistry(), MetricsRegistry()
    rt = Runtime(training=False, mesh=mesh, flash_decode=True, registry=reg)
    uses = specs.use_layouts(cfg, rt, "decode", params)
    use_bytes = specs.block_bytes(params, uses, mesh.shape)
    if procs:
        params = specs.shard_tree(mesh, params, uses)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    # the peak from here: the params decoded with, the cache, the steps
    held_gib(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cache = decode_cache(cfg, dataclasses.replace(rt, registry=cache_reg),
                         params, STEP_BATCH, STEP_MAX_LEN, dev, side)
    serve = steps.make_serve_step(cfg, rt)
    decode_mesh, logits = split_model.decode_mesh, []

    def recorded(*a, **kw):
        out = decode_mesh(*a, **kw)
        logits.append(mesh_mod.pmap(lambda _, lg: lg[:, -1].clone(),
                                    out[1]))
        return out

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    tok, toks, times = prompts, [], []
    split_model.decode_mesh = recorded
    try:
        for _ in range(PROCS_TOKENS):
            t0 = time.perf_counter()
            tok, cache = serve(params, cache, tok)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
    finally:
        split_model.decode_mesh = decode_mesh
    out = {"launches": _lib.launch_counts(),
           "tokens": torch.cat(toks, 1).cpu(),
           "logits": [[None if x is None else x.cpu() for x in lg]
                      for lg in logits],
           "bytes": {k: float(v) for k, v in
                     mesh_mod.collective_bytes(reg.snapshot()).items()},
           "built": {k: float(v) for k, v in
                     mesh_mod.collective_bytes(cache_reg.snapshot())
                     .items()},
           "times": times, "peak_gib": peak_gib(dev, base),
           "param_bytes": param_bytes, "use_bytes": use_bytes}
    del cache, params
    return out


def _bf16_ulps(y):
    """1 bf16 ulp of each |y| in [2^(e-1), 2^e): 2^(e-8)."""
    import torch

    return torch.ldexp(torch.ones_like(y), torch.frexp(y)[1] - 8)


def _against_single(params, mu, path, dev, mesh, layouts):
    """This process's blocks of each updated weight and first moment
    against the same blocks of the single controller's, saved whole at
    `path` (`layouts`: the blocks' on `mesh`): (leaf, max |diff|,
    elements that differ, elements, elements off by more than 1 bf16 ulp
    of the single controller's weight y, elements off by more than 2 lr
    + the two roundings (half an ulp of y and half an ulp of this rank's
    weight x: the most two first updates that differ in sign can part
    two round-to-nearest bf16 weights, also where x and y lie on two
    sides of a power of two), the first moment's sum of squares of the
    difference and its own, in f64). The weight bound only says the
    update stayed an AdamW step: a wrong gradient sum is caught by the
    first moment's 2-norm of the difference over its own, leaf by leaf
    over the ranks' blocks (`PROCS_GRAD_RTOL`)."""
    import torch
    from repro_torch import mesh as mesh_mod
    from repro_torch.optim.adamw import tree_leaves

    lr = 3e-4                  # make_train_step's default
    ref = torch.load(path, map_location="cpu", mmap=True)
    (pos,) = mesh.local
    out = []
    for name, a, b, m, n, lay in zip(
            _leaf_names(params), tree_leaves(params),
            tree_leaves(ref["params"]), tree_leaves(mu),
            tree_leaves(ref["mu"]), tree_leaves(layouts)):
        cut = mesh_mod.block_slices(mesh, pos, lay, b.shape)
        b, n = b[cut], n[cut]
        stats = [0.0, 0, a.numel(), 0, 0]
        sq = [0.0, 0.0]        # sum (m - n)^2, sum n^2, in f64
        # 2^26 elements at a time: the f32 temporaries stay small
        for x, y, u, v in zip(a.reshape(-1).split(1 << 26),
                              b.reshape(-1).split(1 << 26),
                              m.reshape(-1).split(1 << 26),
                              n.reshape(-1).split(1 << 26)):
            x, y = x.float(), y.to(dev).float()
            diff = (x - y).abs()
            ulp_y = _bf16_ulps(y)
            stats[0] = max(stats[0], float(diff.max()))
            stats[1] += int((diff > 0).sum())
            stats[3] += int((diff > ulp_y).sum())
            stats[4] += int((diff > 2 * lr + (ulp_y + _bf16_ulps(x)) / 2)
                            .sum())
            v = v.to(dev).double()
            sq[0] += float(torch.sum(torch.square(u.double() - v)))
            sq[1] += float(torch.sum(torch.square(v)))
        out.append((name, *stats, *sq))
    return out


def _leafwise(ranks):
    """Each leaf's readings over the distinct blocks the ranks hold (the
    first holder of each; `_against_single`'s per rank): (leaf, max
    |diff|, differing, elements, over 1 ulp, over the bound, the first
    moment's relative 2-norm of the difference). Fatal where two ranks
    holding one block read it differently."""
    leaves = []
    for i, first in enumerate(ranks[0]["vs_single"]):
        seen, stats, sq = {}, [0.0, 0, 0, 0, 0], [0.0, 0.0]
        for r, got in enumerate(ranks):
            v = got["vs_single"][i]
            blk = got["blocks"][i]
            if blk in seen:
                if v != seen[blk]:
                    fail(f"{first[0]}: ranks holding block {blk} read "
                         f"{seen[blk]} and {v}")
                continue
            seen[blk] = v
            stats[0] = max(stats[0], v[1])
            for j in range(1, 5):
                stats[j] += v[j + 1]
            sq[0] += v[6]
            sq[1] += v[7]
        leaves.append((first[0], *stats, math.sqrt(sq[0] / sq[1]) if sq[1]
                       else math.sqrt(sq[0])))
    return leaves


def _procs_single(arch, layers, cut, shape, smoke, n_steps, path, dev):
    """The single controller's first training step of one config on the
    same mesh, on the card: its metrics (fatal unless its counted bytes =
    `training_collective_costs`, which it returns), its updated weights
    and first moment saved at `path`."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.mesh import collective_bytes
    from repro_torch.models.config import Runtime
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline import analysis

    cfg, params = _procs_model(arch, layers, cut, smoke, dev)
    want = {k: float(v) for k, v in analysis.training_collective_costs(
        cfg, TRAIN_BATCH, TRAIN_SEQ, dict(zip(_procs_axes(shape), shape)),
        act_bytes=cfg.adtype().itemsize,
        param_bytes=cfg.pdtype().itemsize)[0].items()}
    batch = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ,
                          device=str(dev)).next_batch(0)
    reg = MetricsRegistry()
    p1, opt, m = steps.make_train_step(cfg, Runtime(
        mesh=_train_mesh(shape, dev), training=True, registry=reg))(
        params, adamw_init(params), batch,
        torch.Generator(device=dev).manual_seed(1))
    got = {k: float(v) for k, v in collective_bytes(reg.snapshot()).items()}
    if got != want:
        fail(f"procs {arch} {shape}: the single controller counted {got}, "
             f"training_collective_costs {want}")
    torch.save({"params": _to(p1, "cpu"), "mu": _to(opt["mu"], "cpu")},
               path)
    del params, p1, opt, batch
    return {k: float(v) for k, v in m.items()}, want


def _procs_single_serves(dev):
    """The single controller's sharded arena on the card for each kernel
    config of `PROCS_SERVES` (`serve`, the same weights, prompts and
    mesh shape): its tokens, flushes, slot counters, tokens/s and wall;
    None for the plain run, which is held to the processes' kernel run."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer

    cfg = _serve_cfg()
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    out = []
    for _, shape, capacity, backend in PROCS_SERVES:
        if backend is not None:
            out.append(None)
            continue
        mesh = make_serving_mesh(4, model=shape[-1],
                                 pod=shape[0] if len(shape) == 3 else 1)
        res, _, _ = serve(cfg, params, "randtopk", gen=MESH_GEN,
                          capacity=capacity, mesh=mesh)
        out.append({"tokens": res["tokens"], "flushes": res["flushes"],
                    "counters": [_metric(res, name) for name in (
                        "slot_evictions_total",
                        "slot_readmissions_total")],
                    "tokens_per_s": res["tokens_per_s"],
                    "wall_s": res["wall_s"]})
    del params
    return out


def procs_phase(dev, card):
    """Phase 22: the training mesh, the decode mesh and the serving arena
    across processes (`launch.mesh.spawn`, `mesh.ProcessMesh`): for each
    of `PROCS_RUNS` the single controller's first training step on the
    same mesh on the card, for each of `PROCS_DECODE` its decode run and
    for each of `PROCS_SERVES` its serve; then `PROCS_WORLD` processes,
    one a position, sharing the card over gloo (each collective's tensors
    through host memory), run each training config its steps from the
    same seeds, each decode config's tokens and each serving config
    (`_procs_rank`). Fatal: a process's failure, `_procs_checks`,
    `_procs_decode_checks` and `_procs_serve_checks`. Returns the
    processes' launches summed."""
    import collections

    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"single{i}.pt")
                 for i in range(len(PROCS_RUNS))]
        t0 = time.perf_counter()
        singles = [_procs_single(*run, path, dev)
                   for run, path in zip(PROCS_RUNS, paths)]
        single_decodes = [_procs_decode(dev, *run, procs=False)
                          for run in PROCS_DECODE]
        single_serves = _procs_single_serves(dev)
        print(f"procs phase: the single controller's first steps, decode "
              f"runs and serves {time.perf_counter() - t0:.1f} s; this "
              f"process "
              f"holds {held_gib(dev):.2f} GiB of the card before the "
              f"spawn; {card}")
        # each process's allocator grows its segments in place, so that
        # the four hold no reserved but unallocated blocks
        saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        try:
            ranks = spawn(_procs_rank, PROCS_WORLD, (paths,), device=dev,
                          timeout=PROCS_TIMEOUT_S, store_dir=tmp)
        finally:
            if saved is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
        spawn_s = time.perf_counter() - t0
    failed = []
    checks = [(_procs_checks, (run, *singles[j], [r[0][j] for r in ranks]))
              for j, run in enumerate(PROCS_RUNS)]
    checks += [(_procs_decode_checks, (run, single_decodes[j],
                                       [r[1][j] for r in ranks]))
               for j, run in enumerate(PROCS_DECODE)]
    checks += [(_procs_serve_checks, (single_serves,
                                      [r[2] for r in ranks]))]
    for fn, args in checks:
        # every config's readings are printed before a failure ends the run
        try:
            total.update(fn(*args, card))
        except SystemExit as e:
            print(e)
            failed.append(str(e).removeprefix("chip_smoke: FAILED: "))
    if failed:
        fail("; ".join(failed))
    print(f"  {PROCS_WORLD} processes, spawn to results {spawn_s:.1f} s; "
          f"procs phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


def _procs_checks(run, single, want, ranks, card):
    """The fatal checks of one training config's processes against the
    single controller's first step (`single`) and
    `training_collective_costs` (`want`): the first step's loss and aux
    bit for bit, its grad norm within `PROCS_GNORM_RTOL`, the first
    moment's blocks of every rank within `PROCS_GRAD_RTOL` leaf by leaf
    (the summed gradient), every rank's updated weight blocks within 2 lr
    + half a bf16 ulp of each side (`_against_single`, `_leafwise`) and
    at most `PROCS_ULP_SHARE` of them off by more than 1 ulp; after the
    last step the blocks two ranks hold equal and the gathered weights
    equal on every rank; the counted bytes; the codec kernels
    (randtopk_mask, decode_rows, scatter_rows) once a process a step
    (every position of a batch shard runs the codec on equal rows);
    finite losses; every step's held parameter bytes = the use blocks'.
    Prints each rank's step, gradient reduce and parameter gather ms,
    the two moves' bytes sent, peak and at-rest GiB. Returns the
    launches summed over the processes."""
    import collections

    arch, layers, _, shape, smoke, n_steps = run
    total = collections.Counter()
    label = (f"procs {arch}{' SMOKE' if smoke else ''} "
             f"{layers or 'all'} layers {shape}")
    held = {}
    for r, got in enumerate(ranks):
        g = got["metrics"]
        if g["loss"] != single["loss"] or g["aux"] != single["aux"]:
            fail(f"{label} rank {r}: first step loss {g['loss']} aux "
                 f"{g['aux']}, the single controller's {single['loss']} "
                 f"{single['aux']}")
        if abs(g["grad_norm"] - single["grad_norm"]) > \
                PROCS_GNORM_RTOL * abs(single["grad_norm"]):
            fail(f"{label} rank {r}: grad norm {g['grad_norm']}, the "
                 f"single controller's {single['grad_norm']}")
        if ({k: float(v) for k, v in got["bytes1"].items()} != want
                or {k: float(v) for k, v in got["bytes"].items()}
                != {k: v * n_steps for k, v in want.items()}):
            fail(f"{label} rank {r}: counted {got['bytes1']} in the first "
                 f"step, {got['bytes']} in {n_steps}; "
                 f"training_collective_costs {want} a step")
        wrong = {n: got["launches"][n] for n in TRAIN_PATH_KERNELS["randtopk"]
                 if got["launches"][n] != n_steps}
        if wrong:
            fail(f"{label} rank {r}: launches {wrong}, one a step of each "
                 f"expected")
        if got["gathered"] != ranks[0]["gathered"]:
            fail(f"{label}: the weights rank {r} gathers after step "
                 f"{n_steps} differ from rank 0's")
        for i, (blk, digest) in enumerate(zip(got["blocks"],
                                              got["digests"])):
            if held.setdefault((i, blk), digest) != digest:
                fail(f"{label}: rank {r}'s block {blk} of leaf {i} after "
                     f"step {n_steps} differs from another rank's")
        if not all(math.isfinite(v) for v in got["losses"]):
            fail(f"{label} rank {r}: losses {got['losses']}")
        # a shape check: what the steps held against `use_layouts`'
        # blocks, not `use_layouts` against what the model reads
        if set(got["param_bytes"]) != {got["use_bytes"]}:
            fail(f"{label} rank {r}: the steps held {got['param_bytes']} "
                 f"B of parameters, the use blocks' {got['use_bytes']}")
        total.update({n: got["launches"][n]
                      for n in TRAIN_PATH_KERNELS["randtopk"]})
    vs = _leafwise(ranks)
    n_el = sum(v[3] for v in vs)
    share = sum(v[4] for v in vs) / n_el
    worst = max(vs, key=lambda v: v[6])
    print(f"  {label}, {len(ranks)} processes sharing the card over gloo, "
          f"each holding its blocks of the params and moments: first step "
          f"loss {single['loss']} aux {single['aux']} = the single "
          f"controller's bit for bit on every rank; grad norm "
          f"{[g['metrics']['grad_norm'] for g in ranks]} (single "
          f"{single['grad_norm']}); the ranks' first-moment blocks (the "
          f"summed gradient) off the single controller's by "
          f"{worst[6]:.3g} at most ({worst[0]}; 2-norm of the difference "
          f"over its own, limit {PROCS_GRAD_RTOL}), median leaf "
          f"{statistics.median(v[6] for v in vs):.3g}; the ranks' updated "
          f"weight blocks: {sum(v[2] for v in vs)} of {n_el} elements "
          f"differ ({sum(v[2] for v in vs) / n_el:.4%}; max |diff| "
          f"{max(v[1] for v in vs):.3g}; {sum(1 for v in vs if v[2])} of "
          f"{len(vs)} leaves), {share:.4%} by more than 1 ulp (limit "
          f"{PROCS_ULP_SHARE:.0%}), {sum(v[5] for v in vs)} by more than "
          f"2 lr + half an ulp of each side; after step {n_steps} shared "
          f"blocks equal and the gathered weights equal on every rank; "
          f"collective bytes a step {want} on every rank; held parameter "
          f"bytes = the use blocks' ({ranks[0]['use_bytes']} B rank 0) "
          f"on every rank in every step; codec launches a "
          f"process {n_steps} of each in {n_steps} steps")
    off = [v for v in vs if v[5] or v[6] > PROCS_GRAD_RTOL]
    if off:
        fail(f"{label}: the ranks' first step off the single controller's "
             f"(leaf, max |diff|, differing, elements, over 1 ulp, over 2 "
             f"lr + half an ulp of each side, the first moment's relative "
             f"2-norm): {off}")
    if share > PROCS_ULP_SHARE:
        fail(f"{label}: {share:.4%} of the ranks' first-step weights more "
             f"than 1 bf16 ulp off the single controller's")
    for r, got in enumerate(ranks):
        print(f"    rank {r}: losses {got['losses']}; step ms "
              f"{[round(t, 1) for t in got['times']]}, median of steps "
              f"2-{n_steps} {statistics.median(got['times'][1:]):.1f} "
              f"ms, of it the gradient reduce "
              f"{[round(t, 1) for t in got['reduce_ms']]} ms and the "
              f"parameter gather {[round(t, 1) for t in got['gather_ms']]}"
              f" ms, sending {got['reduce_sent'][0] / 1e9:.3f} GB and "
              f"{got['gather_sent'][0] / 1e9:.3f} GB a step to the "
              f"others; parameters held in a step "
              f"{got['use_bytes'] / 2**30:.3f} GiB (the use blocks); peak "
              f"{got['peak_gib']:.2f} GiB (whole parameters and moments: "
              f"{PROCS_WHOLE_PEAK_GIB[arch]:.2f}; blocks at rest, whole "
              f"parameters in a step: {PROCS_BLOCK_PEAK_GIB[arch]:.2f}), "
              f"at rest (param and moment blocks) {got['rest_gib']:.2f} "
              f"GiB; "
              f"set-up (mesh, weights, batches) {got['setup_s']:.1f} s; "
              f"{card}")
    return total


def _procs_serve_checks(singles, ranks, card):
    """The fatal checks of the serving configs' processes (`ranks[r][j]`:
    rank r's run of `PROCS_SERVES[j]`): rank 0's tokens equal the single
    controller's at the same mesh shape (`singles[j]`) bit for bit, the
    plain versions' tokens the kernels', the capacity-2 run's the
    uncontended (2, 2) run's, with evictions and re-admissions (at least
    one each, as on the single controller, whose counts follow the
    threads' timing as the processes' do); every token in the
    vocabulary; payload B a token = the codec's; every rank's counted
    bytes = `serving_collective_costs` a step over rank 0's flushes and
    the warm-up's steps, which every other rank takes too; rank 0
    launches one fused encode a client token (and one a compressor in
    the warm-up) and one flush decode a flush group (and two a flush
    bucket in the warm-up), the plain run none, the other ranks none;
    every rank's params its use blocks' bytes. Prints tokens/s, ms a
    flush and each process's peak GiB beside the single controller's.
    Returns the launches summed over the processes."""
    import collections

    from repro_torch.roofline import analysis

    cfg = _serve_cfg()
    total = collections.Counter()
    kernel_toks = {}
    for j, (label, shape, capacity, backend) in enumerate(PROCS_SERVES):
        what = f"procs serve {MESH_ARCH} {cfg.n_layers} layers {label}"
        runs = [r[j] for r in ranks]
        lead, single = runs[0], singles[j]
        toks = lead["tokens"]
        if toks.shape != (N_CLIENTS, MESH_GEN) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab:
            fail(f"{what}: tokens {toks.shape} out of shape or range")
        if lead["payload_b"] != {MESH_NB}:
            fail(f"{what}: payload B a token {lead['payload_b']}, "
                 f"{MESH_NB} expected")
        if backend is None:
            kernel_toks[shape, capacity] = toks
            if not (toks == single["tokens"]).all():
                fail(f"{what}: tokens {toks.tolist()}, the single "
                     f"controller's {single['tokens'].tolist()}")
        elif not (toks == kernel_toks[shape, None]).all():
            fail(f"{what}: plain tokens {toks.tolist()} != the kernels' "
                 f"{kernel_toks[shape, None].tolist()}")
        if capacity is not None:
            uncontended = kernel_toks[shape, None]
            if min(lead["counters"]) < 1 or min(single["counters"]) < 1 \
                    or not (toks == uncontended).all():
                fail(f"{what}: evictions and re-admissions "
                     f"{lead['counters']} (single controller "
                     f"{single['counters']}), tokens {toks.tolist()} "
                     f"against the uncontended {uncontended.tolist()}")
        buckets = len({1 << i for i in range(lead["max_batch"].bit_length())
                       if (1 << i) <= lead["max_batch"]}
                      | {lead["max_batch"]})
        n_steps = lead["flushes"] + buckets * lead["n_comps"] + 1
        rows = -(-(capacity or N_CLIENTS) // PROCS_WORLD) * PROCS_WORLD
        per_step = analysis.serving_collective_costs(
            cfg, rows, dict(zip(_procs_axes(shape), shape)),
            dtype_bytes=cfg.adtype().itemsize)[0]
        want = {k: v * n_steps for k, v in per_step.items()}
        for r, got in enumerate(runs):
            # a shape check, as in training
            if got["param_bytes"] != got["use_bytes"]:
                fail(f"{what} rank {r}: served on {got['param_bytes']} B of "
                     f"parameters, the use blocks' {got['use_bytes']}")
            if got["bytes"] != want or (r and got["steps"] != n_steps):
                fail(f"{what} rank {r}: counted {got['bytes']} in "
                     f"{got.get('steps', n_steps)} steps; "
                     f"serving_collective_costs {per_step} a step over "
                     f"{n_steps}")
        path = {"encode_sections": lead["frames"] + lead["n_comps"],
                "decode_to_slots": lead["flushes"]
                + _warm_decodes(lead["max_batch"], lead["n_comps"])}
        for r, got in enumerate(runs):
            want_l = {n: path.get(n, 0) if r == 0 and backend is None
                      else 0 for n in got["launches"]}
            if got["launches"] != want_l:
                fail(f"{what} rank {r}: launches {got['launches']}, "
                     f"{want_l} expected")
            total.update({n: got["launches"][n] for n in path})
        ms = lead["wall_s"] / lead["flushes"] * 1e3
        line = (f"  {what}, {len(runs)} processes sharing the card over "
                f"gloo, rank 0 serving: {lead['tokens_per_s']:.3f} "
                f"tokens/s, {ms:.1f} ms a flush ({lead['flushes']} flushes,"
                f" wall {lead['wall_s']:.3f} s)")
        if single is not None:
            line += (f"; single controller {single['tokens_per_s']:.3f} "
                     f"tokens/s, {single['wall_s'] / single['flushes'] * 1e3:.1f}"
                     f" ms a flush; tokens = the single controller's bit "
                     f"for bit")
        else:
            line += "; plain versions: tokens = the kernels'"
        if capacity is not None:
            line += (f"; {lead['counters'][0]} evictions, "
                     f"{lead['counters'][1]} re-admissions (single "
                     f"controller {single['counters'][0]}, "
                     f"{single['counters'][1]}), the uncontended tokens")
        print(line + f"; collective bytes a step {per_step} = "
              f"serving_collective_costs on every rank over {n_steps} "
              f"steps; rank 0 launches {path if backend is None else {}}, "
              f"the other ranks none; every rank on its use blocks "
              f"({runs[0]['use_bytes'] / 2**30:.3f} GiB: unembed's 'model' "
              f"columns, the rest whole); peak GiB (the whole draw "
              f"included) {[round(g['peak_gib'], 2) for g in runs]}, the "
              f"call's s "
              f"{[round(g['call_s'], 1) for g in runs]}; {card}")
    return total


def _procs_decode_checks(run, single, ranks, card):
    """The fatal checks of one decode config's processes against the
    single controller's decode mesh of the same shape (`single`): every
    token equal, each rank's last logits equal the single controller's at
    its position bit for bit, every token in the vocabulary, the counted
    bytes of the steps = `decode_collective_costs` (the tokens' fetch is
    not counted) and of the cache's build = `decode_cache_collective_
    costs` on every rank and on the single controller, the cut's kernels
    (topk_mask_threshold, decode_rows) once a process a token and no
    other launch; every rank's params its use blocks' bytes. Prints each
    rank's step ms, tokens/s and peak GiB. Returns the launches summed
    over the processes."""
    import collections

    import torch
    from repro_torch.roofline import analysis

    arch, layers, shape, smoke = run
    cfg = _train_cfg("randtopk", layers=layers, cut=0, arch=arch,
                     smoke=smoke)
    label = (f"procs decode {arch}{' SMOKE' if smoke else ''} "
             f"{cfg.n_layers} layers (cut {cfg.split.cut_layer}) {shape}")
    mesh_shape = dict(zip(_procs_axes(shape), shape))
    per_tok = analysis.decode_collective_costs(
        cfg, STEP_BATCH, STEP_MAX_LEN, mesh_shape, flash_decode=True,
        act_bytes=cfg.adtype().itemsize)[0]
    want = {k: v * PROCS_TOKENS for k, v in per_tok.items()}
    built = analysis.decode_cache_collective_costs(
        cfg, STEP_BATCH, mesh_shape, act_bytes=cfg.adtype().itemsize)[0]
    total = collections.Counter()
    toks = single["tokens"]
    if toks.shape != (STEP_BATCH, PROCS_TOKENS) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.padded_vocab:
        fail(f"{label}: the single controller's tokens "
             f"{tuple(toks.shape)} out of shape or range")
    for who, got in [("single controller", single)] + [
            (f"rank {r}", g) for r, g in enumerate(ranks)]:
        if got["bytes"] != want or got["built"] != built:
            fail(f"{label} {who}: counted {got['bytes']} in "
                 f"{PROCS_TOKENS} tokens, the cache {got['built']}; "
                 f"decode_collective_costs {per_tok} a token, "
                 f"decode_cache_collective_costs {built}")
    for r, got in enumerate(ranks):
        if not len(got["logits"]) == len(single["logits"]) == PROCS_TOKENS:
            fail(f"{label} rank {r}: {len(got['logits'])} tokens' logits "
                 f"recorded, the single controller {len(single['logits'])},"
                 f" {PROCS_TOKENS} expected")
        if not torch.equal(got["tokens"], toks):
            fail(f"{label} rank {r}: tokens {got['tokens'].tolist()}, the "
                 f"single controller's {toks.tolist()}")
        for i, (a, b) in enumerate(zip(got["logits"], single["logits"])):
            if not torch.equal(a[r], b[r]):
                fail(f"{label} rank {r}: token {i}'s logits off the single "
                     f"controller's by {max_diff(a[r], b[r]):.4g}")
        expected = {n: PROCS_TOKENS if n in STEP_PATH else 0
                    for n in got["launches"]}
        if got["launches"] != expected:
            fail(f"{label} rank {r}: launches {got['launches']}, "
                 f"{expected} expected")
        # a shape check, as in training
        if got["param_bytes"] != got["use_bytes"]:
            fail(f"{label} rank {r}: decoded on {got['param_bytes']} B of "
                 f"parameters, the use blocks' {got['use_bytes']}")
        total.update({n: got["launches"][n] for n in STEP_PATH})
    print(f"  {label}, {len(ranks)} processes: B {STEP_BATCH}, "
          f"{PROCS_TOKENS} tokens over a {STEP_MAX_LEN}-slot ring, flash "
          f"decode; tokens and each position's logits = the single "
          f"controller's decode mesh bit for bit on every rank; collective "
          f"bytes a token {per_tok} = decode_collective_costs"
          + (f", the cache's {built} = decode_cache_collective_costs"
             if built else "")
          + f"; launches a process a token "
          f"{ {n: ranks[0]['launches'][n] / PROCS_TOKENS for n in STEP_PATH} }"
          f"; each rank on its use blocks, "
          f"{ranks[0]['use_bytes'] / 2**30:.3f} GiB of the whole "
          f"{single['param_bytes'] / 2**30:.3f}; single controller step ms "
          f"{[round(t, 1) for t in single['times']]}; {card}")
    for r, got in enumerate(ranks):
        t = got["times"]
        print(f"    rank {r}: step ms {[round(x, 1) for x in t]}, median "
              f"of tokens 2-{PROCS_TOKENS} {statistics.median(t[1:]):.1f} "
              f"ms, {STEP_BATCH * (len(t) - 1) / sum(t[1:]) * 1e3:.1f} "
              f"tokens/s (tokens 2-{PROCS_TOKENS}); peak "
              f"{got['peak_gib']:.2f} GiB (single controller "
              f"{single['peak_gib']:.2f})")
    return total


# ---------------------------------------------------------------------------
# phase 17: the whole-batch serve step
# ---------------------------------------------------------------------------

STEP_BATCH, STEP_MAX_LEN = 8, 32  # rows, ring slots
STEP_TOKENS = 48              # from an empty cache: the 32-slot ring wraps
# the checked run's tokens and ring for yi-6b at `STEP_FULL_LAYERS`
# (tokens/s at half the model's depth) and granite-moe (24 tokens wrap its 16-slot ring,
# 4 slots a position at (1, 4)): the phase's time
STEP_TOKENS_FULL = 16
STEP_FULL_LAYERS = 8          # of 32 (cut 4), cut from 32 to 16 and then
                              # to 8 for the run's time
STEP_MOE_TOKENS, STEP_MOE_MAX_LEN = 24, 16
# granite-moe's depth, cut from 24 to 12 (cut 6) and then to 6 (cut 3)
# to keep the whole run within its time: its (1, 4) run is host-bound
# (20.4 s of the phase at 12 layers)
STEP_MOE_LAYERS = 6
STEP_TIMED, STEP_REPS = 16, 3  # tokens a timed run, runs (after the 48)
STEP_TRACED = 4               # tokens of the device-only trace
STEP_LAYERS = 2               # yi-6b's depth (cut 1), cut from 8 to 4 and
                              # then to 2 for the run's time: its (2, 2, 2)
                              # run took 18.2 s at 8, 11.8 at 4
# the cut at inference: the TopK mask, then the sparse payload's decode,
# once a batch shard a token
STEP_PATH = ("topk_mask_threshold", "decode_rows")
STEP_MESHES = (("(1, 4) flash", (1, 4), True),
               ("(1, 4) replicated", (1, 4), False),
               ("(2, 2, 2) flash", (2, 2, 2), True))
STEP_ULPS = 16                # the bf16 first-step gate, in bf16 ulps of
                              # mesh=None's largest |logit|: bf16 sums in
                              # another order through every layer (4 ulps
                              # measured at yi-6b's 8 layers, 7.9 at
                              # granite-moe's 24); the f32 gate below is
                              # the exact one
STEP_F32_ATOL = 2e-4          # the f32 first-step gate: the reference's
                              # own mesh bound (tests/test_distributed.py)


def _bf16_ulp(x: float) -> float:
    import math

    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _first_logits(cfg, params, dev, mesh, flash, prompts, side=None):
    """The first step's logits (`split.model.decode_step` from an empty
    cache), f32 on the host."""
    from repro_torch.launch.specs import decode_cache
    from repro_torch.models.config import Runtime
    from repro_torch.split import model as split_model

    rt = Runtime(training=False, mesh=mesh, flash_decode=flash)
    return split_model.decode_step(params, cfg, rt, prompts, decode_cache(
        cfg, rt, params, prompts.shape[0], STEP_MAX_LEN, dev,
        side))[0].float().cpu()


def _step_run(cfg, params, dev, label, mesh, flash, card, prompts,
              tokens=STEP_TOKENS, max_len=STEP_MAX_LEN, side=None):
    """`tokens` greedy tokens of `make_serve_step` from an empty cache
    of `max_len` slots (of the rows' `side` inputs; launch counts zeroed
    just before): the codec's kernels once a
    batch shard a token and no other launch (none with the plain
    versions), counted collective bytes = `decode_collective_costs`
    (bf16) every token and the cache's = `decode_cache_collective_costs`,
    tokens in the vocabulary; then tokens/s as the
    median of `STEP_REPS` timed runs of `STEP_TIMED` tokens, device ms a
    token and the busy share from a device-only trace of `STEP_TRACED`,
    peak GiB of the first run. Returns (tokens (B, tokens) on the
    host, launch counts, tokens/s)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.launch.specs import decode_cache
    from repro_torch.mesh import collective_bytes
    from repro_torch.models.config import Runtime
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.roofline import analysis
    from repro_torch.split import model as split_model

    t_run = time.perf_counter()
    B = prompts.shape[0]
    reg, cache_reg = MetricsRegistry(), MetricsRegistry()
    rt = Runtime(training=False, mesh=mesh, flash_decode=flash, registry=reg)
    cache_rt = dataclasses.replace(rt, registry=cache_reg)
    serve = steps.make_serve_step(cfg, rt)

    def new_cache():
        return decode_cache(cfg, cache_rt, params, B, max_len, dev, side)

    def decode(n, cache):
        t, out = prompts, []
        for _ in range(n):
            t, cache = serve(params, cache, t)
            out.append(t)
        return torch.cat(out, 1)

    base = held_gib(dev)
    cache = new_cache()
    built = {k: float(v) for k, v in
             collective_bytes(cache_reg.snapshot()).items()}
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    toks = decode(tokens, cache)
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    peak = peak_gib(dev, base)
    n_shards = 1 if mesh is None else len(
        split_model.decode_layout(cfg, rt, B).groups)
    plain = cfg.split.backend == "torch"
    want = {n: n_shards * tokens if n in STEP_PATH and not plain
            else 0 for n in counts}
    if counts != want:
        fail(f"serve step {label}: launches {counts}, {want} expected")
    per_tok = {}
    if mesh is not None:
        got = {k: float(v) for k, v in
               collective_bytes(reg.snapshot()).items()}
        per_tok = analysis.decode_collective_costs(
            cfg, B, max_len, mesh.shape, flash_decode=flash,
            act_bytes=cfg.adtype().itemsize)[0]
        if got != {k: v * tokens for k, v in per_tok.items()}:
            fail(f"serve step {label}: {tokens} tokens counted collective "
                 f"bytes {got}, {tokens} x {per_tok} expected "
                 f"(decode_collective_costs)")
        want = analysis.decode_cache_collective_costs(
            cfg, B, mesh.shape, act_bytes=cfg.adtype().itemsize)[0]
        if built != want:
            fail(f"serve step {label}: the cache's counted collective "
                 f"bytes {built}, {want} expected "
                 f"(decode_cache_collective_costs)")
    toks = toks.cpu()
    if toks.shape != (B, tokens) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.padded_vocab:
        fail(f"serve step {label}: tokens {tuple(toks.shape)} out of "
             f"shape or range")
    times = []
    for _ in range(STEP_REPS):
        cache = new_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(STEP_TIMED, cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tps = B * STEP_TIMED / statistics.median(times)
    cache = new_cache()
    tr = traced(lambda: decode(STEP_TRACED, cache), cpu=False)
    dev_tok = "not measured" if tr[1] is None else \
        f"{tr[1] / STEP_TRACED:.3f}"
    print(f"  {label}{'' if mesh is None else ' ' + str(mesh.shape)}: "
          f"{tps:.3f} tokens/s (median of {STEP_REPS} runs of "
          f"{STEP_TIMED} tokens: {[round(t * 1e3, 2) for t in times]} "
          f"ms); device ms a token {dev_tok}, {_busy_text(tr)}; peak "
          f"{peak:.2f} GiB ({base:.2f} GiB held before); launches a token "
          f"{ {n: counts[n] / tokens for n in STEP_PATH} } "
          f"({n_shards} batch shard(s)); collective bytes a token "
          f"{per_tok or 'none'}"
          + (" = decode_collective_costs" if per_tok else "")
          + (f", the cache's {built} = decode_cache_collective_costs"
             if built else "")
          + f"; the run's wall {time.perf_counter() - t_run:.1f} s; {card}")
    del cache, tr
    return toks, counts, tps


def _upcast_in_place(tree):
    """Every leaf of the nested dict `tree` replaced by its f32 copy, one
    at a time, so the old leaf is freed before the next is made."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _upcast_in_place(v)
        else:
            tree[k] = v.float()


def _first_step_gates(cfg, params, dev, prompts, meshes, side=None):
    """The first step's logits (`_first_logits`) at mesh=None and at each
    (label, mesh, flash) of `meshes`, for `_step_against_none`: through
    the identity codec and through randtopk in bf16, then, the weights
    upcast, through randtopk in f32. The upcast is IN PLACE, leaf by
    leaf (the vlm's 10 layers hold ~21 GB in bf16, ~43 GB in f32): the
    caller's `params` are f32 afterwards. Returns {None or label: the
    three}."""
    import torch

    ident = cfg.with_(split=dataclasses.replace(cfg.split,
                                                compressor="identity"))
    f32 = cfg.with_(param_dtype="float32", dtype="float32")
    runs = [(None, None, True)] + list(meshes)
    out = {label: {"identity bf16": _first_logits(
        ident, params, dev, mesh, flash, prompts, side),
                   "randtopk bf16": _first_logits(
        cfg, params, dev, mesh, flash, prompts, side)}
           for label, mesh, flash in runs}
    _upcast_in_place(params)
    torch.cuda.empty_cache()
    side32 = side and {k: v.float() for k, v in side.items()}
    for label, mesh, flash in runs:
        out[label]["randtopk f32"] = _first_logits(f32, params, dev, mesh,
                                                   flash, prompts, side32)
    return out


def _f32_conditioning(cfg, params, dev, prompts, side=None):
    """The first step's f32 conditioning at mesh=None through randtopk:
    the largest change of its logits when every weight is scaled by 1 +
    `COND_REL` N(0, 1) (a seeded draw), about what summing in another
    order does to them. The weights (f32, `_first_step_gates`) are
    perturbed IN PLACE: call it last."""
    import torch

    f32 = cfg.with_(param_dtype="float32", dtype="float32")
    side32 = side and {k: v.float() for k, v in side.items()}
    before = _first_logits(f32, params, dev, None, True, prompts, side32)
    g = torch.Generator(device=dev).manual_seed(11)

    def perturb(tree):
        for v in tree.values():
            if isinstance(v, dict):
                perturb(v)
            else:
                v.add_(v * torch.randn(v.shape, generator=g, device=dev),
                       alpha=COND_REL)
    perturb(params)
    after = _first_logits(f32, params, dev, None, True, prompts, side32)
    return float((after - before).abs().max())


def _step_against_none(label, toks, got, ref_toks, ref,
                       f32_atol=STEP_F32_ATOL, bf16_gated=True):
    """Fatal: the first step's logits off mesh=None's by more than
    `STEP_ULPS` bf16 ulps of mesh=None's largest |logit| through the
    identity codec in bf16 (where `bf16_gated`), or by more than
    `f32_atol` through randtopk in f32. Reported: the bf16 randtopk
    first step (and the identity one where not gated) and the
    share of the run's tokens equal to mesh=None's. In bf16 the cut's
    TopK (k 64 of d) flips elements near its boundary when a mesh
    sums in another order (the same flips moved PR 24-25's bf16 mesh
    losses), and a flipped token changes every later one of its row."""
    diffs = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
    tol = STEP_ULPS * _bf16_ulp(float(ref["identity bf16"].abs().max()))
    agree = float((toks == ref_toks).float().mean())
    print(f"    {label} against mesh=None, first-step logits max |diff|: "
          f"identity bf16 {diffs['identity bf16']:.4g} ("
          + ("gate" if bf16_gated else "reported; the gate would be")
          + f" {tol:.4g} = {STEP_ULPS} bf16 ulps of max |logit| "
          f"{float(ref['identity bf16'].abs().max()):.4g}), randtopk f32 "
          f"{diffs['randtopk f32']:.4g} (gate {f32_atol}), randtopk "
          f"bf16 {diffs['randtopk bf16']:.4g} (reported); tokens equal "
          f"{agree * 100:.2f}% of {toks.numel()}, rows equal throughout "
          f"{int((toks == ref_toks).all(1).sum())} of {toks.shape[0]}")
    if not ((diffs["identity bf16"] <= tol or not bf16_gated)
            and diffs["randtopk f32"] <= f32_atol):
        fail(f"serve step {label}: first-step logits off mesh=None's by "
             f"{diffs}; gates identity bf16 {tol}, randtopk f32 "
             f"{f32_atol}")


def servestep_phase(dev, card):
    """Phase 17: the whole-batch serve step (`launch.steps.
    make_serve_step`) from an empty cache, `STEP_TOKENS` greedy tokens of
    B `STEP_BATCH` rows over a `STEP_MAX_LEN`-slot ring, randtopk k 64
    (TopK at inference), bf16, random weights from a seed: yi-6b at full
    width, `STEP_LAYERS` of its 32 layers (cut at half), at mesh=None
    with the kernels and with the plain versions (tokens and first
    logits bit for bit, the plain run launches nothing), then at each of
    `STEP_MESHES`, every position on the one card; yi-6b at
    `STEP_FULL_LAYERS` of its 32 layers at mesh=None (`STEP_TOKENS_FULL`
    tokens); and
    granite-moe-1b-a400m (`STEP_MOE_LAYERS` of its 24 layers) at
    mesh=None and (1, 4) (`STEP_MOE_TOKENS` over a
    `STEP_MOE_MAX_LEN`-slot ring). Each mesh's
    first step against mesh=None's
    (`_step_against_none`) and counted collective bytes =
    `decode_collective_costs`. Returns the kernel runs' launches."""
    import collections

    import torch
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    total = collections.Counter()
    cfg = _train_cfg("randtopk", layers=STEP_LAYERS, cut=0)
    g = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (STEP_BATCH, 1), generator=g,
                            device=dev)
    print(f"serve step phase: yi-6b at full width, {cfg.n_layers} layers "
          f"(cut at {cfg.split.cut_layer}), B {STEP_BATCH}, a ring of "
          f"{STEP_MAX_LEN} slots, {STEP_TOKENS} tokens from an empty "
          f"cache, randtopk k={K} (TopK at inference), bf16; every mesh "
          f"position on the one card; {card}")
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    ref_toks, counts = _kernels_are_plain(cfg, params, dev, card, prompts,
                                          STEP_TOKENS, STEP_MAX_LEN)
    total.update(counts)
    meshes = [(label, _train_mesh(shape, dev), flash)
              for label, shape, flash in STEP_MESHES]
    runs = {}
    for label, mesh, flash in meshes:
        runs[label], counts, _ = _step_run(cfg, params, dev, label, mesh,
                                           flash, card, prompts)
        total.update(counts)
    gates = _first_step_gates(cfg, params, dev, prompts, meshes)
    for label, toks in runs.items():
        _step_against_none(label, toks, gates[label], ref_toks, gates[None])
    del params, gates
    held_gib(dev)
    full = _train_cfg("randtopk", layers=STEP_FULL_LAYERS, cut=0)
    params = transformer.init_model(
        full, torch.Generator(device=dev).manual_seed(0), device=dev)
    _, counts, _ = _step_run(full, params, dev,
                             f"yi-6b {full.n_layers} layers, mesh=None",
                             None, True, card, prompts,
                             tokens=STEP_TOKENS_FULL)
    total.update(counts)
    del params
    held_gib(dev)
    mcfg = _train_cfg("randtopk", layers=STEP_MOE_LAYERS, cut=0,
                      arch=FAM_TRAIN)
    print(f"  {FAM_TRAIN}: {mcfg.n_layers} layers (cut at "
          f"{mcfg.split.cut_layer}), {mcfg.n_experts} experts")
    params = transformer.init_model(
        mcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    m_prompts = prompts % mcfg.vocab
    moe_kw = dict(tokens=STEP_MOE_TOKENS, max_len=STEP_MOE_MAX_LEN)
    ref_toks, counts, _ = _step_run(mcfg, params, dev,
                                    f"{FAM_TRAIN} mesh=None", None, True,
                                    card, m_prompts, **moe_kw)
    total.update(counts)
    label = f"{FAM_TRAIN} (1, 4) flash"
    mesh = _train_mesh((1, 4), dev)
    toks, counts, _ = _step_run(mcfg, params, dev, label, mesh, True, card,
                                m_prompts, **moe_kw)
    total.update(counts)
    gates = _first_step_gates(mcfg, params, dev, m_prompts,
                              [(label, mesh, True)])
    _step_against_none(label, toks, gates[label], ref_toks, gates[None])
    del params, gates
    held_gib(dev)
    print(f"serve step phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


def _kernels_are_plain(cfg, params, dev, card, prompts, tokens, max_len,
                       side=None):
    """`_step_run` at mesh=None with the kernels, then with the plain
    versions: the same tokens and first-step logits, bit for bit, and no
    launch in the plain run. Returns (the kernels' tokens, their launch
    counts)."""
    import torch

    kw = dict(tokens=tokens, max_len=max_len, side=side)
    ref_toks, counts, _ = _step_run(cfg, params, dev, f"{cfg.name} "
                                    "mesh=None, kernels", None, True, card,
                                    prompts, **kw)
    plain = cfg.with_(split=dataclasses.replace(cfg.split, backend="torch"))
    p_toks, _, _ = _step_run(plain, params, dev, f"{cfg.name} mesh=None, "
                             "plain versions", None, True, card, prompts,
                             **kw)
    first = _first_logits(cfg, params, dev, None, True, prompts, side)
    p_first = _first_logits(plain, params, dev, None, True, prompts, side)
    if not (torch.equal(p_toks, ref_toks) and torch.equal(p_first, first)):
        fail(f"serve step {cfg.name} mesh=None: the plain versions' tokens "
             f"or first logits differ from the kernels'")
    print(f"    the plain versions' {tokens} tokens and first logits = the "
          f"kernels', bit for bit")
    return ref_toks, counts


# ---------------------------------------------------------------------------
# phase 18: the hybrid, ssm, vlm and audio families on the decode mesh
# ---------------------------------------------------------------------------

# (arch, layers (None: full), the decode meshes, with flash decode): each
# at full width, its depth cut as the recurrent and multimodal phases cut
# it, rwkv6 then further for the run's time (zamba2 81 -> 12, one
# shared-attention site each side of cut 6, so both sites' rings run;
# rwkv6 24 -> 6 -> 2, cut 1; the vlm 100 -> 10, one cross layer each
# side of cut 5; whisper FULL, cut 2)
FAMSTEP_RUNS = (
    ("whisper-tiny", None, (("(1, 4) flash", (1, 4)),
                            ("(2, 2, 2) flash", (2, 2, 2)))),
    ("zamba2-7b", 12, (("(1, 4) flash", (1, 4)),)),
    ("rwkv6-1.6b", 2, (("(1, 4) flash", (1, 4)),)),
    ("llama-3.2-vision-90b", 10, (("(1, 4) flash", (1, 4)),)),
)
FAMSTEP_PLAIN = "whisper-tiny"     # the model whose plain versions run too
FAMSTEP_TOKENS, FAMSTEP_MAX_LEN = 24, 16       # the 16-slot ring wraps
# A model is ill-conditioned at its first step when a COND_REL relative
# weight perturbation moves its f32 logits by more than COND_AMP times
# COND_REL of their largest |logit| (`_f32_conditioning`). Its f32 gate is
# then COND_FACTOR times that move, and its bf16 identity first step is
# reported, not gated: bf16 rounding (2^-9 relative) amplified a
# thousandfold moves the logits by their own size. rwkv6 at 6 layers
# (full width, random weights) moves them 3.2e-3 of a largest |logit| of
# 4.3 (an amplification of 7500; the per-head group norm of the first
# token's rank-one WKV output, s v, divides by |s|), so a mesh's other
# summation order moves them as far: 2.5e-3 at (1, 4) on the CPU through
# the identity codec, 5.2e-3 on the card through randtopk. The vlm, zamba2
# and whisper amplify 29x or less.
COND_REL, COND_AMP, COND_FACTOR = 1e-7, 1000, 10


def familystep_phase(dev, card):
    """Phase 18: the whole-batch serve step (`make_serve_step`) of the
    hybrid, ssm, vlm and audio families on the decode mesh, B
    `STEP_BATCH`, `FAMSTEP_TOKENS` greedy tokens over a
    `FAMSTEP_MAX_LEN`-slot ring from an empty cache, randtopk k 64 (TopK
    at inference), bf16, random weights from a seed, each model of
    `FAMSTEP_RUNS` at full width at mesh=None and its meshes, every
    position on the one card; the vlm's gates at 0.5 and its caches of
    the rows' patches (B x 1601 x 8192), whisper's of their frames' (B x
    1500 x 384) encoder output. Each run through `_step_run` (the cut's
    kernels once a batch shard a token and nothing else, counted bytes =
    the closed forms, tokens in the vocabulary; tokens/s, device ms,
    busy, peak), each mesh's first step against mesh=None's
    (`_step_against_none`), and for `FAMSTEP_PLAIN` the plain versions
    at mesh=None bit for bit. Returns the kernel runs' launches."""
    import collections

    import torch
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    total = collections.Counter()
    print(f"family step phase: B {STEP_BATCH}, a ring of {FAMSTEP_MAX_LEN} "
          f"slots, {FAMSTEP_TOKENS} tokens from an empty cache, randtopk "
          f"k={K} (TopK at inference), bf16; every mesh position on the "
          f"one card; {card}")
    kw = dict(tokens=FAMSTEP_TOKENS, max_len=FAMSTEP_MAX_LEN)
    for arch, layers, shapes in FAMSTEP_RUNS:
        t0 = time.perf_counter()
        cfg = _train_cfg("randtopk", layers=layers, cut=0, arch=arch)
        params = transformer.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        prompts = torch.randint(0, cfg.vocab, (STEP_BATCH, 1), generator=g,
                                device=dev)
        side = None
        if cfg.family in ("vlm", "audio"):
            name = "patches" if cfg.family == "vlm" else "frames"
            n = transformer.cross_tokens(cfg)
            side = {name: (torch.randn((STEP_BATCH, n, cfg.d_model),
                                       generator=g, device=dev)
                           * 0.02).to(cfg.adtype())}
        if cfg.family == "vlm":
            _set_gates(params, 0.5)
        n_params = sum(p.numel() for p in tree_leaves(params))
        print(f"  {arch} ({cfg.family}): {cfg.n_layers} layers (cut at "
              f"{cfg.split.cut_layer}), d_model {cfg.d_model}, "
              f"{n_params:,} params"
              + (f", {name} {tuple(side[name].shape)}" if side else "")
              + (", gates 0.5" if cfg.family == "vlm" else ""))
        if arch == FAMSTEP_PLAIN:
            ref_toks, counts = _kernels_are_plain(cfg, params, dev, card,
                                                  prompts, side=side, **kw)
        else:
            ref_toks, counts, _ = _step_run(
                cfg, params, dev, f"{arch} mesh=None", None, True, card,
                prompts, side=side, **kw)
        total.update(counts)
        meshes = [(f"{arch} {label}", _train_mesh(shape, dev), True)
                  for label, shape in shapes]
        runs = {}
        for label, mesh, flash in meshes:
            runs[label], counts, _ = _step_run(
                cfg, params, dev, label, mesh, flash, card, prompts,
                side=side, **kw)
            total.update(counts)
        gates = _first_step_gates(cfg, params, dev, prompts, meshes, side)
        cond = _f32_conditioning(cfg, params, dev, prompts, side)
        amp = cond / (COND_REL * float(
            gates[None]["randtopk f32"].abs().max()))
        well = amp <= COND_AMP
        f32_atol = STEP_F32_ATOL if well else COND_FACTOR * cond
        print(f"    {arch}: the f32 first step's conditioning {cond:.4g} "
              f"(max |logit change| at mesh=None under a {COND_REL} "
              f"relative weight perturbation; amplification {amp:.4g}, "
              f"ill-conditioned above {COND_AMP}): the f32 gate "
              f"{f32_atol:.4g}" + ("" if well else
                                  f" = {COND_FACTOR} x it, the bf16 "
                                  f"identity first step reported"))
        for label, toks in runs.items():
            _step_against_none(label, toks, gates[label], ref_toks,
                               gates[None], f32_atol, well)
        del params, gates, side
        held_gib(dev)
        print(f"  {arch}: {time.perf_counter() - t0:.1f} s")
    print(f"family step phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


# phase 19: the dry run's counts against the card
# ---------------------------------------------------------------------------

# (label, arch, depth (None: the config's), kind, mesh, B, S or ring
# slots): yi-6b at full width trained at (2, 2, 2) (depth 5: its bytes
# grow as the depth's square, so training is solved from 2, 3 and 4) and
# decoding B 8 over a 32-slot ring at (1, 4) with flash decode (depth 4,
# solved from 2 and 3); whisper-tiny FULL decoding at (2, 2, 2), its
# encoder output crossing the pod ring when the cache is built
DRY_CASES = (
    ("yi-6b train", "yi-6b", 5, "train", (2, 2, 2), 8, 256),
    ("yi-6b decode", "yi-6b", 4, "decode", (1, 4), STEP_BATCH, STEP_MAX_LEN),
    ("whisper-tiny decode", "whisper-tiny", None, "decode", (2, 2, 2),
     STEP_BATCH, STEP_MAX_LEN),
)
DRY_REPS = 3                  # timed steps on the card after the counted one
DRY_PATH = {"train": TRAIN_PATH_KERNELS["randtopk"], "decode": STEP_PATH}


def _card_step(cfg, shape, mesh, dev, reg, cache_reg):
    """The dry run's step on the card: its arguments (random weights and
    batch from a seed; `count_one`'s `Runtime`) and a `run()` of one
    step."""
    import torch
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch import steps
    from repro_torch.launch.specs import decode_cache
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init

    g = torch.Generator(device=dev).manual_seed(1)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if shape.kind == "train":
        rt = Runtime(mesh=mesh, training=True, registry=reg)
        state = [params, adamw_init(params)]
        batch = make_lm_batch(g, cfg, shape.batch, shape.seq, device=dev)
        step = steps.make_train_step(cfg, rt)
        draws = torch.Generator(device=dev).manual_seed(2)

        def run():
            state[0], state[1], _ = step(state[0], state[1], batch, draws)
        return run
    rt = Runtime(mesh=mesh, training=False, seq_shard=False, registry=reg)
    side = None
    if cfg.family == "audio":
        side = {"frames": (torch.randn((shape.batch, cfg.n_frames,
                                        cfg.d_model), generator=g,
                                       device=dev) * 0.02).to(cfg.adtype())}
    cache = decode_cache(cfg, dataclasses.replace(rt, registry=cache_reg),
                         params, shape.batch, shape.seq, dev, side)
    token = torch.randint(0, cfg.vocab, (shape.batch, 1), generator=g,
                          device=dev, dtype=torch.int32)
    serve = steps.make_serve_step(cfg, rt)
    return lambda: serve(params, cache, token)


def _dry_case(label, arch, layers, kind, mesh_shape, B, S, dev, card):
    """Count one case on `meta` (directly, and solved from smaller
    depths: equal, or fatal), then run it on the card under the same
    counter with a registry: FLOPs and collective bytes per op equal the
    meta count (fatal); printed: the peak against the card's, the bytes
    (plain codec on meta, kernels on the card) and the roofline terms of
    one card holding every position against the step's median ms.
    Returns the card step's launches."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import dryrun, specs
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.roofline import analysis
    from repro_torch.roofline.program import (collective_stats,
                                              count_program)

    t0 = time.perf_counter()
    cfg = _train_cfg("randtopk", layers=layers, cut=0, arch=arch)
    shape = specs.ShapeSpec(label, kind, S, B)
    train = kind == "train"
    meta_mesh = _train_mesh(mesh_shape, "meta")
    meta = dryrun.count_one(cfg, shape, meta_mesh)
    ds = dryrun.depths(cfg, train)
    solved = dryrun.extrapolate(cfg, {
        d: dryrun.count_one(dryrun.at_depth(cfg, d), shape, meta_mesh)
        for d in ds}, train)
    for what, a, b in (("flops", solved.counts.flops, meta.counts.flops),
                       ("bytes", solved.counts.bytes, meta.counts.bytes),
                       ("args", solved.args_bytes, meta.args_bytes),
                       ("collectives", solved.counts.collectives,
                        meta.counts.collectives),
                       ("cache collectives", solved.cache_collectives,
                        meta.cache_collectives)):
        if a != b:
            fail(f"dry run {label}: {what} solved from depths {ds} "
                 f"{a} != the direct count at {cfg.n_layers}'s {b}")
    t_meta = time.perf_counter() - t0
    base = held_gib(dev)
    reg, cache_reg = MetricsRegistry(), MetricsRegistry()
    run = _card_step(cfg, shape, _train_mesh(mesh_shape, dev), dev, reg,
                     cache_reg)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    with count_program(reg) as got:
        run()
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base * 2**30
    if got.flops != meta.counts.flops:
        fail(f"dry run {label}: the card's FLOPs {got.flops} != meta's "
             f"{meta.counts.flops}")
    if got.collectives != meta.counts.collectives:
        fail(f"dry run {label}: the card's collective bytes "
             f"{got.collectives.per_op_bytes} != meta's "
             f"{meta.counts.collectives.per_op_bytes}")
    built = collective_stats(cache_reg).per_op_bytes
    if built != meta.cache_collectives.per_op_bytes:
        fail(f"dry run {label}: the card's cache collective bytes {built} "
             f"!= meta's {meta.cache_collectives.per_op_bytes}")
    missing = [n for n in DRY_PATH[kind] if not counts[n]]
    if missing:
        fail(f"dry run {label}: no launch of {missing} on the card")
    times = []
    for _ in range(DRY_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    roof = analysis.from_program(
        meta.counts, arch=arch, shape=label, mesh_desc=str(mesh_shape),
        chips=1, args_bytes=meta.args_bytes)
    print(f"  {label} ({cfg.n_layers} layers, {mesh_shape}, B {B}, "
          f"{'S' if train else 'ring'} {S}): FLOPs {got.flops} = meta's; "
          f"collective bytes {got.collectives.per_op_bytes} = meta's"
          + (f", the cache's {built} = meta's" if built else "")
          + f"; depths {ds} solved = the direct count at {cfg.n_layers} "
          f"(flops, bytes, args, collectives); bytes: meta (plain codec) "
          f"{meta.counts.bytes} / card (kernels) {got.bytes} = "
          f"{meta.counts.bytes / got.bytes:.4f}; peak: meta args "
          f"{meta.args_bytes} + {meta.counts.peak} = "
          f"{roof.peak_memory:.0f} B against the card's "
          f"max_memory_allocated {peak:.0f} B = "
          f"{roof.peak_memory / peak:.4f}; one card's roofline: compute "
          f"{roof.t_compute * 1e3:.4f} ms, memory "
          f"{roof.t_memory * 1e3:.4f} ms, collective "
          f"{roof.t_collective * 1e3:.4f} ms ({roof.bottleneck}) against "
          f"the step's median {statistics.median(times):.3f} ms "
          f"({[round(t, 3) for t in times]}); launches "
          f"{ {n: c for n, c in counts.items() if c} }; meta counts "
          f"{t_meta:.1f} s, the case {time.perf_counter() - t0:.1f} s; "
          f"{card}")
    del run
    return counts


def dryrun_phase(dev, card):
    """Phase 19: the dry run (`launch.dryrun.count_one`) held against the
    card, for each of `DRY_CASES` (`_dry_case`). Returns the card steps'
    launches."""
    import collections

    t_phase = time.perf_counter()
    total = collections.Counter()
    print(f"dry run phase: each case counted on meta, then run on the card "
          f"under the same counter; every mesh position on the one card; "
          f"{card}")
    for case in DRY_CASES:
        total.update(_dry_case(*case, dev, card))
        held_gib(dev)
    print(f"dry run phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


# phase 20: the examples on the card
# ---------------------------------------------------------------------------

# (example, main()'s keywords, the lines `tests/test_examples.py` asserts
# of the reference's, the kernels its path must launch); every one at its
# defaults (the reference's sizes) but the multipod dry run, which counts
# the qwen3-8b decode step at (2, 2, 2) on meta instead of the train step
# at (2, 16, 16) (~15 minutes of host time)
EXAMPLES = (
    ("quickstart", {}, ("compressed size", "greedy decode"),
     TRAIN_PATH_KERNELS["randtopk"] + STEP_PATH),
    ("two_party_vfl", {}, ("randtopk", "size_reduction"), ()),
    ("streaming_clients", {}, ("identity", "randtopk", "tok/s"),
     PATH_KERNELS["randtopk"]),
    ("fedtrain_two_party", {}, ("randtopk", "B/step up", "B/step down",
                                "test acc"), FED_KERNELS["randtopk"]),
    ("multipod_dryrun", {"shape": "decode_32k", "mesh": (2, 2, 2)},
     ("summary:", "'bottleneck':"), ()),
)


def examples_phase(dev, card):
    """Phase 20: each `examples/torch_*.py`'s `main()` in this process on
    the card (launch counts zeroed just before each): the lines the
    reference's example tests assert (fatal), the kernels of its path
    launched (fatal), its wall and output. Returns the launches."""
    import collections
    import contextlib
    import importlib.util
    import io

    import torch
    from repro_torch.kernels import _lib

    t_phase = time.perf_counter()
    total = collections.Counter()
    print(f"examples phase: examples/torch_*.py's main() on the card; "
          f"{card}")
    for name, kw, lines, path in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", os.path.join(ROOT, "examples",
                                          f"torch_{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if "mesh" in kw:
            kw = dict(kw, mesh=_train_mesh(kw["mesh"], "meta"))
        buf = io.StringIO()
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
        out = buf.getvalue()
        print("\n".join("    | " + ln for ln in out.strip().splitlines()))
        absent = [ln for ln in lines if ln not in out]
        if absent:
            fail(f"example {name}: {absent} not printed")
        missing = [n for n in path if not counts[n]]
        if missing:
            fail(f"example {name}: no launch of {missing}")
        print(f"  {name}: {wall:.1f} s; the asserted lines {list(lines)} "
              f"printed; launches { {n: c for n, c in counts.items() if c} }")
        total.update(counts)
        held_gib(dev)
    print(f"examples phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


EXP_TOPK_KS = (2, 3, 4, 5, 6, 7, 9, 12, 13)   # tables 3 and 7, combined,
                                               # fedtrain's schedule
EXP_LEVEL = ("randtopk", "topk", "size_reduction")    # table 3 at k 3


def _exp_kernel_checks(dev, g):
    """Phase 21's kernels against their plain versions at the shapes the
    experiments give them. Returns the number of cases."""
    import torch
    from repro_torch.core import compressors as C, selection
    from repro_torch.experiments import table2_sizes
    from repro_torch.kernels.randtopk import ops, ref

    n = 0
    shapes = [(rows, d, k) for d, ks in ((128, EXP_TOPK_KS), (600, (2, 9)))
              for k in ks for rows in (128, 4000, 20000)] + [(256, 1024, 16)]
    for rows, d, k in shapes:
        x = torch.relu(torch.randn((rows, d), generator=g, device=dev))
        for xx in (x, torch.round(x * 2) / 2):     # post-ReLU, with ties
            mk, tk = ops.topk_mask_threshold(xx, k)
            mp, tp = ref.topk_mask_threshold(xx, k)
            if not torch.equal(mk, mp) or not torch.equal(tk, tp):
                fail(f"experiments: topk kernel != plain at {rows} x {d} "
                     f"k {k}")
            n += 1
        if rows != 128:
            continue
        gum = selection.gumbel_noise(g, x.shape, device=dev)
        m = torch.randint(0, min(k, d - k) + 1, (rows, 1), generator=g,
                          device=dev)
        if not torch.equal(ops.randtopk_mask(x, gum, m, k),
                           ref.randtopk_mask(x, gum, m, k)):
            fail(f"experiments: randtopk kernel != plain at {rows} x {d} "
                 f"k {k}")
        n += 1
    x = torch.randn((64, 128), generator=g, device=dev)
    for method, kw in table2_sizes.CODECS:
        meta, got = table2_sizes.wire_bytes(C.make_compressor(method, **kw), x)
        plain_meta, plain = table2_sizes.wire_bytes(
            C.make_compressor(method, backend="torch", **kw), x)
        if meta != plain_meta or got != plain:
            fail(f"experiments: table 2's {method} wire body differs: "
                 f"{meta}, {len(got)} B with the fused kernel, "
                 f"{plain_meta}, {len(plain)} B with the plain version")
        n += 1
    for rows in (128, 4000, 20000):
        o = torch.relu(torch.randn((rows, 128), generator=g, device=dev))
        for comp in (C.Quantization(bits=4), C.RandTopKQuant(k=7, bits=8),
                     C.RandTopKQuant(k=12, bits=4)):
            p = comp.encode(o)
            got = C.payload_to_dense(p)
            plain = C.payload_to_dense(p, backend="torch")
            if not torch.equal(got, plain):
                fail(f"experiments: decode_rows != plain for {comp.name} "
                     f"at {rows} x 128: {max_diff(got, plain)}")
            n += 1
    torch.cuda.synchronize()
    return n


def experiments_phase(dev, card):
    """Phase 21: the experiments' kernels at their shapes, then table 2,
    fig 2 and table 3's high level on the card. Returns the launches of
    the sections' run."""
    import torch
    from repro_torch.experiments import common, fig2_toy, table2_sizes
    from repro_torch.kernels import _lib
    from repro_torch.split import tabular

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    n = _exp_kernel_checks(dev, g)
    print(f"experiments phase: {card}; {n} kernel cases at the sections' "
          f"shapes equal to the plain versions in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    for name, main in (("table2", table2_sizes.main),
                       ("fig2", fig2_toy.main)):
        t0 = time.perf_counter()
        lines = []
        main(emit=lines.append)
        torch.cuda.synchronize()
        print("\n".join("    | " + ln for ln in lines))
        bad = [ln for ln in lines if ln.endswith(",False")]
        if bad:
            fail(f"experiments {name}: {bad}")
        print(f"  {name}: {time.perf_counter() - t0:.1f} s")
    ds = common.dataset()
    for method in EXP_LEVEL:
        kw = dict(k=3, alpha=0.1) if method == "randtopk" else dict(k=3)
        runs = {}
        for backend in ("cuda", "torch"):
            t0 = time.perf_counter()
            before = _lib.launch_counts()
            runs[backend] = r = tabular.train(
                common.spec(method, backend=backend, **kw), ds, epochs=1,
                seed=0, device=dev)
            torch.cuda.synchronize()
            r["wall_s"] = time.perf_counter() - t0
            r["launched"] = {k: c - before[k]
                             for k, c in _lib.launch_counts().items()
                             if c - before[k]}
        kern, plain = runs["cuda"], runs["torch"]
        if plain["launched"]:
            fail(f"experiments table3 {method}: the plain run launched "
                 f"{plain['launched']}")
        off = [f"{part}.{n}" for part in ("bottom", "top")
               for n in kern[part]
               if not torch.equal(kern[part][n], plain[part][n])]
        if off or kern["final_loss"] != plain["final_loss"] or \
                kern["test_acc"] != plain["test_acc"]:
            fail(f"experiments table3 {method}: kernels differ from the "
                 f"plain versions: loss {kern['final_loss']} vs "
                 f"{plain['final_loss']}, acc {kern['test_acc']} vs "
                 f"{plain['test_acc']}, tensors {off}")
        want = {"randtopk": ("randtopk_mask", "topk_mask_threshold"),
                "topk": ("topk_mask_threshold",)}.get(method, ())
        missing = [k for k in want if not kern["launched"].get(k)]
        if missing:
            fail(f"experiments table3 {method}: no launch of {missing}")
        print(f"  table3 high {method} (k 3, 1 epoch = {kern['steps']} "
              f"steps): final loss {kern['final_loss']}, test acc "
              f"{kern['test_acc']}, every trained tensor equal to the "
              f"plain run's; {kern['compressed_size_pct']:.2f}% size; wall "
              f"{kern['wall_s']:.2f} s kernels, {plain['wall_s']:.2f} s "
              f"plain; launches {kern['launched']}")
    counts = _lib.launch_counts()
    for name in ("encode_sections", "topk_mask_threshold"):
        if not counts[name]:
            fail(f"experiments: no launch of {name} in the sections")
    held_gib(dev)
    print(f"experiments phase wall: {time.perf_counter() - t_phase:.1f} s")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "serve", "train",
                                        "fedtrain", "loadgen", "families",
                                        "recurrent", "multimodal", "mesh",
                                        "trainmesh", "servestep",
                                        "familystep", "dryrun",
                                        "examples", "experiments", "procs",
                                        "probe",
                                        "ab",
                                        "predict"),
                    default="all",
                    help="kernels: build + kernel checks + codec probes; "
                         "serve / train / fedtrain / loadgen / families / "
                         "recurrent / multimodal / mesh / trainmesh / "
                         "servestep / familystep / dryrun / examples / "
                         "experiments / procs: the "
                         "checks, "
                         "probes and one path; probe: build + `probe_kernels` "
                         "alone; ab: `probe` in turns on a parent tree's "
                         "package and this one (--parent); predict: the "
                         "loadgen phase's reports computed on the CPU "
                         "(checks no card, exits 3)")
    ap.add_argument("--layers", type=int, default=8,
                    help="serving depth of yi-6b, 8 of its 32 layers by "
                         "default to keep the whole run within its time "
                         "(width is never cut)")
    ap.add_argument("--src", help="import repro_torch from this directory "
                                  "(a parent tree's src/) for --phase probe")
    ap.add_argument("--parent", help="the parent tree's root for --phase ab")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if args.phase == "predict":
        loadgen_prediction()
        print("chip_smoke: --phase predict ran on the CPU and checked no "
              "card", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _lib.LAST_BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    if args.phase == "ab":
        ab_phase(args.parent, card)
        return _ok()
    g = torch.Generator(device=dev).manual_seed(0)
    if args.phase == "probe":
        print(f"repro_torch from {os.path.dirname(_lib.CSRC)}")
        print(json.dumps({"probe": probe_kernels(dev, g)}))
        return _ok()
    t0 = time.perf_counter()
    records = [check_topk(dev, g), check_encode_sections(dev, g),
               check_decode(dev, g), check_randtopk(dev, g),
               check_decode_rows(dev, g), check_scatter_rows(dev, g)]
    own = [check_encode(dev, g), check_pack(dev, g), check_quant(dev, g),
           *check_flash(dev, g)]
    print("kernel checks: all twelve kernels agree with their plain "
          "versions (masks, indices, words, packed bits and the fused "
          "encode's wire sections byte for byte, quant codes, lo and step, "
          "scattered and non-quant decoded values exact; encode_rows' quant "
          "headers and dequantized values within 1 ulp; projected rows "
          "within 1 ulp plus 1e-5 of the summed |terms|; flash within 3e-5 "
          f"in f32 and 3e-2 in bf16) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_kernels(dev, g)
    probe_fused(dev, g)
    print("the serving client's codec per token:")
    codec_token_ms(dev, g)
    print(f"codec probes: {time.perf_counter() - t0:.1f} s")

    # each kernel's launches are read from the runs of the paths it serves:
    # the two codec kernels of serving from the serving randtopk run, the
    # three of training from the training randtopk run, the top-k from the
    # tabular trainer's (its evaluation), plus the loadgen's and the
    # families phase's kernel runs; encode_rows, pack_bits, quantize and
    # the two flash kernels, which no path runs, from their checks' own
    # loops
    launches = {r["name"]: 0 for r in records}
    sources = {r["name"]: [] for r in records}

    def add(name, n, source):
        launches[name] += n
        sources[name].append(source)

    # first, while this process holds next to nothing of the card: its
    # four processes need some 70 GB of it
    if args.phase in ("all", "procs"):
        for n, c in procs_phase(dev, card).items():
            add(n, c, "the procs phase's processes (one a position: "
                      "training yi-6b 2 layers at (2, 2), granite-moe 4 at "
                      "(1, 4), zamba2 6 at (1, 4), rwkv6 2, whisper and "
                      "the vlm SMOKE at (2, 2); decoding yi-6b 4 layers "
                      "at (1, 4), granite-moe 6, rwkv6 2 and the vlm "
                      "SMOKE at (2, 2), zamba2 6 at (1, 4), whisper at "
                      "(2, 1, 2); serving yi-6b 4 layers on rank 0 at "
                      "(2, 2), (2, 1, 2) and (2, 2) at capacity 2)")
    if args.phase in ("all", "serve"):
        t0 = time.perf_counter()
        counts = serve_phase(dev, args.layers)
        for n in PATH_KERNELS["randtopk"]:
            add(n, counts[n], "serving randtopk run")
        print(f"serving phases: {time.perf_counter() - t0:.1f} s")
    if args.phase in ("all", "train"):
        t0 = time.perf_counter()
        counts = train_phase(dev)
        for n in TRAIN_PATH_KERNELS["randtopk"]:
            add(n, counts[n], "training randtopk run")
        add("topk_mask_threshold", tabular_phase(dev)["topk_mask_threshold"],
            "tabular trainer's randtopk run (its evaluation)")
        smoke_train_cpu_vs_card(dev)
        for n, c in train_ckpt_phase(dev).items():
            if n in launches and c:
                add(n, c, "launch.train's resumed checkpoint run")
        print(f"training phases: {time.perf_counter() - t0:.1f} s")
    if args.phase in ("all", "fedtrain"):
        t0 = time.perf_counter()
        for n, c in fedtrain_phase(dev).items():
            if n in launches and c:
                add(n, c, "the fedtrain phase's three chaos runs")
        print(f"fedtrain phase: {time.perf_counter() - t0:.1f} s")
    if args.phase in ("all", "loadgen"):
        for n, c in loadgen_phase(dev, card).items():
            add(n, c, "the loadgen phase's two kernel runs")
    if args.phase in ("all", "families"):
        counts = families_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the families phase's kernel serves and "
                                  "granite-moe training")
    if args.phase in ("all", "recurrent"):
        counts = recurrent_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the recurrent phase's kernel serves "
                                  "(zamba2, rwkv6, rwkv6 at capacity 1, "
                                  "yi-6b int8 KV) and zamba2 and rwkv6 "
                                  "training")
    if args.phase in ("all", "multimodal"):
        counts = multimodal_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the multimodal phase's kernel serves "
                                  "(llama-3.2-vision-90b, whisper-tiny), "
                                  "the vlm's live-gate forward and decode, "
                                  "and whisper and vlm SMOKE training")
    if args.phase in ("all", "mesh"):
        counts = mesh_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the mesh phase's kernel serves (yi-6b "
                                  "at mesh=None and four meshes, and at "
                                  "capacity 2)")
    if args.phase in ("all", "trainmesh"):
        counts = trainmesh_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the train mesh phase's kernel steps "
                                  "(yi-6b at mesh=None, (1, 1), (2, 4) and "
                                  "(2, 2, 2); granite-moe at (1, 4); "
                                  "zamba2 and rwkv6 at mesh=None and (2, "
                                  "2); whisper at mesh=None, (2, 2) and "
                                  "(1, 4); vlm SMOKE at mesh=None and "
                                  "(2, 2, 2))")
    if args.phase in ("all", "servestep"):
        counts = servestep_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the serve step phase's kernel runs "
                                  "(yi-6b 2 layers at mesh=None, (1, 4) "
                                  "flash and replicated, (2, 2, 2); yi-6b "
                                  "8 layers; granite-moe at mesh=None "
                                  "and (1, 4))")
    if args.phase in ("all", "familystep"):
        counts = familystep_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the family step phase's kernel runs "
                                  "(whisper at mesh=None, (1, 4) and (2, "
                                  "2, 2); zamba2, rwkv6 and the vlm at "
                                  "mesh=None and (1, 4))")
    if args.phase in ("all", "dryrun"):
        counts = dryrun_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the dry run phase's card steps (yi-6b 5 "
                                  "layers trained at (2, 2, 2) and 4 "
                                  "decoding at (1, 4), whisper decoding at "
                                  "(2, 2, 2))")
    if args.phase in ("all", "examples"):
        counts = examples_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the examples phase (quickstart, "
                                  "two_party_vfl, streaming_clients, "
                                  "fedtrain_two_party)")

    if args.phase in ("all", "experiments"):
        counts = experiments_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the experiments phase (table 2, fig 2, "
                                  "table 3's high level with the kernels)")

    for r in records:
        r["launches"] = launches[r["name"]]
        r["launches_from"] = " + ".join(sources[r["name"]]) or \
            "no path run in this invocation"
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_from", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records + own]}))
    return _ok()


def _ok() -> int:
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


AB_TURNS = "PCCP"


def ab_phase(parent, card):
    """`--phase probe` in fresh processes, in turns P, C, C, P on this
    card: P imports the parent tree's package (`parent`/src, built there),
    C this tree's, and both are driven by this file's probes. Prints each
    turn's output, then one line per probe with the four turns' wrapper
    ms, device ms and host us (allocation, bare launch)."""
    if not parent or not os.path.isdir(os.path.join(parent, "src")):
        fail("--phase ab needs --parent, a tree with src/repro_torch")
    turns = []
    for i, who in enumerate(AB_TURNS):
        src = os.path.join(os.path.abspath(parent) if who == "P" else ROOT,
                           "src")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--phase", "probe", "--src", src],
                             capture_output=True, text=True, timeout=1200)
        print(f"=== turn {i + 1}: {who} ({src}), rc {run.returncode}, "
              f"{time.perf_counter() - t0:.1f} s")
        print(run.stdout)
        if run.returncode != 0:
            print(run.stderr[-4000:])
            fail(f"turn {i + 1} ({who}) failed")
        line = next(ln for ln in run.stdout.splitlines()
                    if ln.startswith('{"probe"'))
        turns.append((who, json.loads(line)["probe"]))
    names = " / ".join(f"{w}{i + 1}" for i, (w, _) in enumerate(turns))
    print(f"A/B summary, turns {names}, {card}:")
    for key in turns[0][1]:
        recs = [t.get(key) or {} for _, t in turns]

        def col(name, scale=1.0):
            return " / ".join("-" if r.get(name) is None
                              else f"{r[name] * scale:.5g}" for r in recs)
        print(f"  {key}: wrapper ms {col('ms')}; device us "
              f"{col('device_ms', 1e3)}; host us {col('host_us')} "
              f"(alloc {col('alloc_us')}, launch {col('launch_us')}); "
              f"bound us {col('bound_ms', 1e3)}")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
