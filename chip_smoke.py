"""Chip smoke test of the PyTorch/CUDA port (client_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main path once at full width and checks it, in phases,
each printing one JSON line:

1. env       torch and CUDA versions, the card's name and power limit.
2. build     builds every CUDA kernel of the paths from ops/csrc with nvcc
             (sm_90a), one process each, all at once, and prints the build
             seconds.
3. kernel    holds flash attention (K1) against its plain PyTorch version
             on the card at the encoder path's shapes, with the tolerances
             stated below, and times the kernel, the plain version, a
             PyTorch library call computing the same function (a yardstick
             the port never calls) and the card's bound for the same work.
             Three times per kernel: ``ms``, the wall time per call of
             back-to-back calls between CUDA events; ``device_ms``, the
             kernel's own duration from torch.profiler's kernel events;
             ``host_us_per_call``, the wrapper's host time per call. Also
             times K1 at a long sequence (B 4, L 2048, causal and not).
4. kernel    the same for paged decode attention (K2) at the generation
             path's shapes: positions 0, 15, 16, mid-context and 191,
             inactive slots on the scratch block, table widths 1, 4 and 12,
             one GQA case; width_invariance: one slot's output launched
             alone and padded to every wider table width beside co-runners
             must be bit-equal (bf16 and f32, r = 1 and 4), or the phase
             fails; the heads one tp rank of a mesh holds (MESH_K2_CASES:
             the path's model at tp 2 and 4, dp 2 x tp 4, a GQA model at
             tp 8 with one KV head a rank), checked and timed at full
             context; no single PyTorch call reads through a block
             table, so its yardstick is a gather plus
             scaled_dot_product_attention.
5. serve     the BERT-base encoder (12 layers, d 768, 12 heads of 64, seq
             128, one bucket of 256, random weights from a seed) behind
             TorchInferenceServer's dynamic batcher and the HTTP front end;
             a few dozen concurrent JSON and binary-extension requests;
             every embedding is held against the same weights' forward with
             the plain attention on the card; the flash-attention launch
             counter, zeroed just before the requests, must show 12
             launches per batch.
6. serve_shm bench.py's headline path: the same encoder behind
             TorchInferenceServer, driven in process (InProcessBackend)
             over the CUDA shared-memory data plane. First 64 requests
             sent together, each with its own input region (distinct
             tokens) and output region: every output region's embedding is
             held against the plain attention's forward, entry by entry,
             within the bf16 bound of embed_bound (EMBED_FLOOR, EMBED_ULPS),
             the pre-split calls must equal the batches, the flash-attention
             launches (zeroed just before) 12 per batch, and every batch
             must have read the registered input tensors themselves (zero
             copies, by data_ptr). Then the perf analyzer's stabilized point
             at bench.py's settings (concurrency 2560, 16 worker threads,
             output region 768 x 4 bytes; window, stability, trials and
             attempts cut to SHM_POINT) with infer/s, p50/p99, MFU against
             the card's bf16 peak, batch sizes and mean compute ns per
             batch, and the latency-bounded point (bucket 128, concurrency
             768) beside bench.py's 250 ms p50 target, and the headline's
             /metrics scrapes (the perf analyzer reads the server's
             metrics around and inside every window): scrapes per window
             and host ms per scrape. No request may fail.
7. generate  the reference bench.py's generation model at full width
             (vocab 30528, d 768, 12 layers, 12 heads of 64, d_ff 3072,
             max_seq 192, bf16, random weights from a seed) served by
             make_continuous_generator on the paged layout (blocks of 16,
             16 slots, chunk 16, token-level prefill, K2 attention) through
             TorchInferenceServer.infer with a response callback: bench.py's
             32 ragged jobs from 32 threads, a quarter of them sampled.
             Every stream must stream exactly its budget and then the final
             flag, every token must be in the vocab, the K2 launch counter
             (zeroed just before) must read 12 x 16 per chunk dispatch, and
             every greedy stream is teacher-forced through the plain path
             on the card: each served token must be the plain argmax
             wherever the plain top-1/top-2 logit gap exceeds a stated bf16
             tolerance. Profiles one greedy chunk dispatch outside the
             engine (host ms, device busy ms, kernel launches).
8. generate_slot
             bench.py's generation point as the reference runs it: the
             same model and 32 jobs, all greedy, on the engine's defaults
             (the slot layout, token-level prefill) with the plain
             attention, served and checked the same way; K2 and K1 must
             not launch. Then, at the same width on the first PREFILL_JOBS
             jobs, the chunked prefill lane (prefill_chunk 64, the default
             budget) on the slot layout and on the paged layout with K2
             (12 x 16 launches per chunk dispatch: frozen riders still
             run), and the batched prefill on the slot layout; each
             checked the same way, each chunked run with lane chunks
             dispatched. Prints useful tokens/s, TTFT, ITL and host ms per
             dispatch of every run, and profiles one greedy slot-layout
             chunk dispatch outside the engine as the generate phase does
             the paged one.
9. generate_prefix
             the prefix cache at the same width: the reference perf
             analyzer's shared-prefix workload (16 streams of a 128-token
             prefix, cut from 256 to fit max_seq 192, and a 32-token suffix,
             budget 32, from the port's DataLoader), 32 requests from 16
             threads rotating over the streams, so each thread's second
             request finds its first one's prompt committed. Three runs:
             prefix_cache on the slot layout (plain attention, the pool<->slot
             copies), on the paged layout (K2 over tables whose heads are
             shared blocks; 12 x 16 launches per chunk dispatch), and off on
             the slot layout. Each prefix run must show at least 16 hits and
             16 x 128 saved tokens; after the drain no trie node may hold a
             ref, and the paged pool must hold no stream block and no
             reservation (free + prefix = usable). Every greedy stream is
             teacher-forced as above. Prints each run's tokens/s, TTFT
             (the engine's, and the client's for the first and second
             request of every thread), ITL, hits, misses, saved tokens,
             commits, evictions and host ms per dispatch.
10. stream_context
             the streaming context at the same width, through the same
             core call gRPC's ModelStreamInfer makes (no gRPC here): bench.py's
             32 jobs on 16 slots, chunk 16, one ring fetch per dispatch. The
             8 next longest go first, with a cancel Event their callback
             sets on their 4th token; from their median time to first token
             the engine's pace is read, and the 8 longest then go with a
             wire timeout of 4.5 dispatches at that pace, which passes
             mid-decode; the other 16 are plain. Two
             runs: the paged layout with the prefix cache (every prompt
             served once first, so the tables are headed by shared blocks;
             K2 12 x 16 per chunk dispatch) and the slot layout. Each timed
             stream must end with one 504 (or complete), at least 4 of 8
             holding their slot when their deadline passed; each cancelled
             one with one 499 and no token after it; each plain one with its
             budget; the engine must count the 504s and 499s, and after the
             drain hold no slot, have closed every request, pin no trie node
             and hold the whole paged pool. Every delivered token, partial
             streams included, is teacher-forced as above. Prints, per trip,
             the engine's dispatch count at the deadline and at the slot's
             release and which side tripped it, and the plain streams'
             tokens/s.

11. speculate
             speculative decoding at the same width with the reference
             speculative A/B's settings (benchmarks/bench_generation_grpc.py):
             a high-agreement draft that keeps the target's first layer
             while the target's wo and w2 of layers 1-11 are scaled by
             0.005, gamma 12, batched prefill admission where the layout
             allows it, bench.py's 32 jobs on 16 slots, chunk 16. Four runs
             on the same target weights: spec_off (no draft, the plain
             arm), spec_slot (slot layout, 8 streams sampled at
             temperature 0.8, top-k 40: the rejection sampler), spec_paged
             (paged layout, K2 on the chunk dispatches, 12 x 16 per chunk
             dispatch, none in the verify rounds) and spec_ladder_floor
             (the first 8 jobs, an adversarial draft of the same shape
             with its own weights, the gamma ladder and an acceptance
             floor of 0.5: every stream with 4 rounds must have latched to
             plain decode and still stream its budget). Every greedy token
             is teacher-forced as above; the high-agreement runs must
             verify more than one token per round at an acceptance above
             the adversarial run's; after the drain no slot may be held and
             the paged pool must be whole. Prints per run tokens/s (and
             against spec_off), rounds, verify and chunk dispatches,
             acceptance, tokens per round, rounds per rung, host ms per
             dispatch by kind, TTFT and ITL, and the streams latched to
             plain decode (the floor or the max_seq edge); a fifth run,
             spec_slot_stride1, repeats spec_slot with one ring fetch per
             dispatch. Profiles one greedy gamma-12 round outside the
             engine (launches, host ms, device busy ms), on the slot layout
             and on the paged layout with 8 of the 16 slots in the round
             (the verify runs all 16 rows, the others into the scratch
             block), and prints spec_paged's host ms per verify dispatch.
12. schedule
             the SLO scheduler and the host tier at the same width:
             preemption on both layouts (bench.py's 32 jobs as bronze, 8
             gold arrivals once every slot is held), three shared-prefix
             families cycled through a small paged pool with a host tier,
             none, and a one-block tier, the burn controller, and the
             duty's pacing.
13. lanes    the dedicated prefill lanes and the int8 KV cache at the same
             width (16 slots, chunk 16): piggyback_paged (the comparison
             arm: bench.py's 32 jobs, paged with K2, the chunked lane of
             prefill_chunk 64 riding the decode chunk), lane_paged (the
             same jobs and budget through 4 lane slots of width 32),
             lane_paged_batch
             (the same with 4 lane slots per dispatch), lane_slot (the
             first 16 jobs on the slot layout, the handoff through the
             prefix cache, policy all), kv8_slot (bench.py's point, slot
             layout and token prefill, under kv_quant, its tokens/s beside
             generate_slot's bench point) and kv8_paged (the first 16 jobs,
             paged, chunked prefill, attn_impl flash under kv_quant). The
             lane runs must hand off exactly the prompts longer than a
             chunk, the paged ones with no pool<->slot copy and K2 at 12 x
             16 per chunk dispatch, the batched one with batched lane
             dispatches; kv8_paged must launch K2 0 times; every greedy
             stream is teacher-forced (the int8 runs through the int8
             plain path); after each drain no slot, lane slot, pin, stream
             block or reservation may be left. Prints the state's and the
             pool's bytes in bf16 and in int8, and moves one int8 block
             through the host tier and back, bit for bit. The slot layout's
             lane run and the int8 paged run are cut from 32 jobs to 16 to
             keep the phase near a minute; the width is bench.py's.
14. observe  the observability plane at the same widths: the BERT-base
             encoder (K1, 12 launches per batch, embeddings held against
             the plain attention's forward) over HTTP with every request
             traced (trace_level TIMESTAMPS, trace_rate 1) to a file,
             each trace holding REQUEST_START through REQUEST_END in
             serving order; bench.py's 32 jobs, paged with K2, through the
             decoupled path twice, tracing off (observe_off) and every
             request traced (observe_paged) while /metrics is scraped over
             HTTP every 250 ms and once after: both arms K2 12 x 16 per
             chunk dispatch and every greedy stream teacher-forced, the
             scrapes parsed by the port's parser with the token counter
             never going down, the last scrape's token and completion
             counters equal to the engine's and client_tpu_engine_up 1,
             one trace per stream; then an engine on the card whose
             dispatch raises: the model, the server and /v2/health/ready
             read not ready and client_tpu_engine_up 0 until an unload
             and a load. Prints both arms' tokens/s (and their ratio), the
             median and largest scrape's host ms, spans per trace and the
             number of families.
15. supervise
             engine supervision, the watchdog and the runtime plane at the
             same widths: bench.py's generation model on the paged layout
             (K2) under supervision (first backoff 0.05 s, a breaker of 3
             failures) with the default watchdog, served by one
             TorchInferenceServer beside the BERT-base encoder, with the
             debug endpoints on. (g) 24 encoder requests over HTTP (K1, 12
             per batch), then GET /v2/debug/runtime: each model's memory
             ledger (the encoder's weights, the LM's weights and pool) sums
             to no more than memory_allocated, and the card's row reads
             memory_allocated. (a) bench.py's 32 jobs, all greedy: no 503,
             no incident, K2 12 x 16 per chunk dispatch. (b) the same jobs
             with an engine_loop fault armed once 8 streams have their
             first token: every stream the death caught gets a 503 with
             Retry-After and is sent again after it, as a retrying client
             does; every job completes, is teacher-forced and equals
             the clean run's stream token for token, one restart,
             the engine_death bundle readable at /v2/debug/incidents, K2
             12 x 16 per chunk dispatch of the dead and the rebuilt engine
             plus the rebuilt engine's two warm chunks, and
             memory_allocated after the drain within half a pool of its
             value before the crash; prints the milliseconds from the
             crash (the liveness flip) to healthy and to the first token
             after the restart. (c) two more crashes trip the breaker:
             /v2/health/ready 400, a submit 503 with no hint, /metrics with
             the restart counter 2, the breaker gauge 1, engine_up 0, the
             five watchdog families and three engine_death incidents; an
             unload and a load restore readiness. (d) a kernel_delay fault
             holds one dispatch 5.5 s, past the default stall wall:
             engine_stall fires once, its bundle has a flight tail, and
             every traced stream carries the INCIDENT span. (h) in a
             process of its own (``chip_smoke.py --profile-process``),
             POST /v2/debug/profile captures 1 s while bench.py's jobs run
             round after round, and the trace names K2. (e) the same 32 jobs unsupervised, the
             watchdog on and off alternately, twice each, with tokens/s,
             host ms per dispatch and the host µs of each watchdog tick
             and flight record (timed around the engine's own calls). Every greedy stream of (a), (b)
             and (e) is teacher-forced. The reference's metrics lint is not run
             here (it imports the JAX package); the CPU tests run it on the
             same collectors.
16. goodput  the goodput plane, the timeline and the profiler's metrics
             half at the same width: bench.py's 32 jobs, all greedy, paged
             with K2, under the debug endpoints with the first 4 streams
             traced, once with device_time_sample_every 0 and once with 4.
             Each run's goodput ledger must count exactly the engine's chunk
             dispatches (no lane or handoff), useful FLOPs exactly equal to
             the sum over the jobs of the positions their chunks carry
             (prompt and budget rounded up to whole chunks), counted in
             this script from the config, cadence device seconds within the
             run's wall, samples at most a quarter of the dispatches and
             each a wait on a CUDA event (none with sampling off), the
             watchdog's two goodput signals numbers, /metrics the MFU pair
             with the card's peak, /v2/debug/timeline a valid Chrome trace
             with the decode-lane track and 4 request tracks, and
             /v2/debug/traces the 4 traces; K2 12 x 16 per chunk dispatch,
             every stream teacher-forced. Prints tokens/s and MFU per run,
             one chunk dispatch's cadence ms, CUDA-event ms and profiled
             busy ms side by side, and one perf-analyzer window in
             streaming mode (16 streams) over the shared-prefix workload on
             the paged layout with the prefix cache: its goodput deltas
             (more than 0) and the goodput floor's verdict (0.5).
17. client   the client library and the perf analyzer's network side:
             the BERT-base encoder (seed 0, K1) and add_sub behind
             TorchInferenceServer and the HTTP front end in this process,
             driven from a separate process (``chip_smoke.py
             --client-process``, which imports only client_tpu_torch):
             24 binary requests through urllib (a connection each, the
             bare socket), 24 binary (8 through async_infer) and 24 JSON
             requests through client_tpu_torch.client.http, 24 requests
             whose input and output are CUDA shm regions the process
             created and registered (each output read back with
             get_contents_as_numpy after its seqno moved), and the control
             plane (health, metadata, config, statistics, the regions'
             status and unregister, a TPU verb's 400); then ``python -m
             client_tpu_torch.perf`` over HTTP with CUDA shm regions at
             concurrency 8 and at half its measured rate, each exiting 0
             with no failed request; then simple_http_cudashm_client's
             flow on add_sub with regions of this process. Every embedding
             is held against the plain attention's forward (embed_bound),
             K1 must launch 12 times per batch over the phase, the server
             must count the client process's successes, the client's
             regions must resolve cross-process and the example's in
             process. Then the perf CLI's foreign ``--service-kind
             torchserve`` in this process against a stdlib stub of
             TorchServe's multipart upload API: exit 0 with a report,
             every upload's bytes intact; the kind imports neither grpcio
             nor protobuf, and the phase prints whether the host has
             them. Prints, per
             arm, client-side infer/s, p50/p99 ms, the server's
             completions/s and mean batch size over the same window, and
             the client's host µs per request.
18. models   the serving core's repository, ensembles and sequences and
             the image models, through one TorchInferenceServer over HTTP
             with the port's client. (a) ResNet-50 (seed 0, bf16, channels
             last, the dynamic batcher at preferred batch 8): the logits
             of 8 FP32 [224, 224, 3] images sent as one binary request,
             held against the same weights' f32 forward on the card (TF32
             off) within MODELS_RTOL of the largest logit, top-1 equal
             wherever the f32 top-1/top-2 gap exceeds that tolerance; the
             same request over CUDA shm regions gives the same logits bit
             for bit; ms per batch-8 forward between CUDA events, images/s
             through the server over one window of single-image requests
             from 16 threads, and the weights' memory_allocated. (b) the
             ensemble preprocess_resnet50 on 8 PNG images made here: its
             logits bit-equal to preprocess then resnet50 called one after
             the other, one execution of each composing model per request.
             The phase fails where Pillow is missing.
             (c) the repository: unloading the ensemble with
             unload_dependents drops memory_allocated by at least the
             weights' bytes and the index reads resnet50
             UNAVAILABLE/unloaded; a load gives (a)'s logits again, bit for
             bit; a model loads from a temporary repository directory's
             model.py; ms per load and unload. (d) sequences: the
             accumulator (its state on the card) over 4 interleaved
             correlation ids gives the running sums; decoder_lm (the
             reference's default decode model, seed 0, bf16) over a
             16-token prompt and 32 further steps equals the port's
             decode_step loop on the same weights, token for token, and
             the guard refuses the step at max_seq; ``python -m
             client_tpu_torch.perf -m decoder_lm`` in sequence mode
             (sync, concurrency 4, sequence length 20) over HTTP fails no
             request, and every sequence the server saw start also ended;
             host and CUDA-event ms per decode step. K1 and K2 must not
             launch in the phase. Every time is printed beside the card's
             name and power limit.
19. generators
             the single-stream and static-batch generators (ROADMAP 7a)
             at the reference's default decode config (vocab 1024, d 128,
             2 layers, max_seq 128, bf16, seed 0): generator_lm and
             batch_generator_lm (chunk 8) through TorchInferenceServer.infer
             with a response callback, as gRPC's ModelStreamInfer calls
             it. Prompts of 1, 8, 9, 33 and 100 tokens (the step path and
             every prefill bucket) with a budget of 21 (two chunks and a
             tail of 5), and a batch of 8 rows of 16 tokens with a budget
             of 64. Every greedy stream and row is teacher-forced as
             above; the same seed gives the same sampled stream twice;
             TOP_K = 1 equals greedy; K1 and K2 launch 0 times. Prints TTFT
             per prompt, ms per token in a chunk and in the tail, host ms
             and kernel launches per chunk, and the batch generator's
             tokens/s at B = 8 and B = 1.
20. fleet    the replica fleet router (ROADMAP 7b's fleet half): two
             replicas of bench.py's generation model on the one card, each
             paged with K2, at the reference fleet benchmark's settings
             (4 slots, chunk 4, prefix cache at blocks of 16, chunked
             prefill at 32, affinity blocks of 16) and its full-scale
             workload (8 tenants x 4 requests of a 64-token tenant prefix
             and an 8-token suffix, budget 8; tenants concurrent, each
             tenant's requests one after another) through
             TorchInferenceServer.infer. Four runs: affinity, random
             (seeded), one replica, and affinity with replica 0 drained
             once 16 tokens have streamed. The affinity run's prefix hit
             rate must beat the random run's; the drain must complete with
             zero failed streams and every stream its budget; every greedy
             stream is teacher-forced and equal, token for token, to the
             one-replica run's; K2 must launch 12 x 4 per chunk dispatch
             on every replica (a tally by engine thread beside the
             wrapper's count; a drained replica's fresh engine adds its
             two warm chunks); /v2/debug/fleet and client_tpu_fleet_* on
             /metrics must read the fleet's routed counts; a traced stream
             must carry FLEET_ROUTE. Prints each run's tokens/s (the two
             replicas share the card: the number is the router's cost, not
             a scaling), the drain's ms and the host µs per route call.
21. autoscale
             the fleet autoscaler and the canary judge (ROADMAP 7b's
             remainder): replicas of the same model on the one card, the
             fleet phase's knobs (paged with K2), at the reference autoscale
             benchmark's settings (benchmarks/bench_autoscale.py: SLO
             classes gold, generous, and flood, 1 ms TTFT; a 3 s SLO
             window; prompts of a 24-token tenant prefix and an 8-token
             suffix, budget 8), the controller stepped on this thread
             every 50 ms. (a) overload: one replica, bands {1..3 replicas,
             burn 1.0/0.2, queue 6/1, hold 2, idle 4, cooldown 0.25 s},
             16 flood and 2 gold tenants resubmitting their 4 requests
             until the fleet holds 3 replicas and the flood's burn crossed
             1.0, then idle until it is back at 1: 1 -> 3 -> 1, the gold
             burn at most 0.05 throughout, scale_up and scale_down in the
             decision ring and as FLEET_SCALE events. (b) canary: two
             replicas pinned, a 50 % tenant split, gates {soak 1.5 s, 4
             requests, burn 1.0 / 1.5x, TTFT p95 3x, MFU 0.5x}: a 0.4 s
             kernel_delay matched to the canary's engine name must roll
             back, and the rollout with the fault cleared must promote
             (every replica on the new version), each verdict in the ring
             and as a CANARY_* event. Both arms: zero failed streams,
             every budget full, every stream of one prompt the same
             tokens, one stream per prompt teacher-forced; K2 12 x 4 per
             chunk dispatch on every replica (tallied by engine thread,
             detached and swapped-out engines included) and on every
             replica that served; memory_allocated after each detach and
             after the arm back within a quarter of one replica's
             footprint. Prints replicas over time, each control round's
             ms and the ring's decisions, ms per attach, detach and
             drain, each verdict's burn, TTFT p95 and MFU on both sides,
             memory_allocated before, at its peak and after, and tokens/s
             per arm.
22. train    training on the card (ROADMAP 9a): (a) TINY (vocab 64, d 32,
             2 layers, f32, the plain attention) from one set of weights,
             three AdamW steps at lr 1e-2 on the card and on the CPU: the
             losses within rtol 1e-4, the parameters within 1e-4 (an
             element whose first gradient lies in (0, 1e-6), where Adam's
             step turns on the gradient's last bits, within the most three
             steps can move it, on under 1 % of a leaf); (b) bench.py's
             generation model at full width (vocab 30528, d 768, 12
             layers, 12 heads of 64, d_ff 3072, max_seq 192, bf16, the
             plain attention), TRAIN_STEPS AdamW steps (lr TRAIN_LR) on
             one seeded 16 x 193 batch: every loss finite, the last below
             the first;
             (c) its Switch-MoE variant with 4 experts, the same and the
             aux loss > 0; (d) (b) with remat: the losses within 1e-3
             relative of (b)'s; (e) in a child process through run_ranks,
             one NCCL rank: make_mesh() over the card, TINY's step with
             the mesh equal to the step without it within rtol 1e-6, and
             the dry run's steps 1-3 at one rank. Prints per arm the ms
             per step between CUDA events, tokens/s, max_memory_allocated,
             the model FLOPs per step and MFU against the card's bf16
             peak, with the card's name and power limit; K1 and K2 must
             not launch.
23. mesh     the engine's mesh (ROADMAP 9b, 9c) in a child process through
             run_ranks, one NCCL rank (the machine has one card, and NCCL
             takes one rank per card): (a) the BERT-base encoder (seq
             128, bf16, K1 on each rank's tp-local heads) as a TorchModel
             with mesh, param_sharding and input_sharding beside the plain
             TorchModel behind one core at bench.py's bucket of 256,
             MESH_REQUESTS full-bucket requests each: the embeddings
             bit-equal, K1 12 launches per forward, the median ms per
             request of both arms; (b)
             bench.py's generation model at full width (paged, K2, the
             prefix cache on, 16 slots, chunk 16) as an engine over the
             mesh beside the unsharded engine, bench.py's 32 jobs all
             greedy: every stream identical, K2 exactly 12 x 16 launches
             per chunk dispatch, tokens/s, host ms per dispatch and plans
             sent of both arms (the plan channel's cost at world 1);
             (c)-(g) the engine's optional planes (ROADMAP 9c) at the same
             width, each over the mesh beside its unsharded twin (the
             first 8 of (b)'s jobs): (c) speculation on the paged layout
             with the speculate phase's high-agreement pair at gamma 4,
             (d) the dedicated lanes (2 lane slots, batched) on both
             layouts, (e) the host tier (the tier cycle one stream a wave
             through a pool of MESH_TIER_POOL blocks), (f) int8 KV on both
             layouts, (g) a supervised paged generator with one injected
             engine_loop crash mid-run, its refused streams resubmitted:
             every stream equal to the twin's, verify rounds and tier
             restores above 0, lane handoffs, one restart with
             memory_allocated after the drain within half a pool of its
             value before the crash, K2 exactly 12 x 16 launches per
             chunk dispatch on the paged non-int8 arms ((g): the dead and
             the rebuilt engine's, and the rebuilt one's 2 warm-up
             chunks) and 0 on the int8 arms, tokens/s and host ms per
             dispatch of both arms; then the dry run's steps 1-4 at one
             rank. The mesh must be NCCL (its plans ride a gloo group,
             parallel/spmd.py).
             Phase 4 holds K2 at the tp-local shapes (MESH_K2_CASES).
24. fleet_mesh
             a replica fleet under the mesh (ROADMAP 9d) in a child
             process through run_ranks, one NCCL rank: the fleet phase's
             2-replica arm (bench.py's generation model at full width,
             paged, K2, the fleet workload behind TorchInferenceServer
             and the HTTP front end) with every replica over a 1 x 1
             mesh, its plans and lifecycle on the fleet's one plan
             channel, beside the unsharded 2-replica fleet in the same
             call, in turns (plain, mesh, mesh, plain); in each, replica
             0 drained once 16 tokens have streamed and a third replica
             attached (warmed) after it: every stream equal to the first
             arm's, none failed, each replica's K2 launches exactly 12 x
             4 per chunk dispatch of its engines (a fresh engine's 2
             warm-up chunks included) and above 0; tokens/s, host ms per
             dispatch and plans sent of each arm and the mean ratios.
             Replicas over more than one card need at least two cards
             (NCCL holds one rank per card): the tests run them on gloo
             ranks on the CPU.
25. native   the port's native C++ stack (ROADMAP 10): (a) prints which
             of g++, nvcc, protoc, protobuf's headers and library and
             cmake are here, builds client_tpu_torch/native at first use
             (client_tpu_torch._native: g++ and nvcc, no cmake) and prints
             the seconds per target group; without protobuf the gRPC
             targets are skipped, and a line says so; without g++ or nvcc
             the phase fails. (b) The DIRECT model library on the card
             (libdirect_models_cuda.so: H2D, D1's hand-written kernel, D2H)
             held bit for bit against the CPU library
             (libdirect_models_cpu.so) and against torch's add/sub/copy on
             the card, for add_sub, add_sub_fp32 and identity at the 16
             elements perf_analyzer drives (and at 2^20, timed), its
             launch counter risen; D1's ``device_ms`` is its kernels' own
             mean duration over torch.profiler's records of 100 calls in
             this process (``device_records`` of them kept; null where it
             keeps none), its ``ms`` the CUDA events the library brackets
             the kernel with; then ``perf_analyzer -i direct`` on each
             model, the card's library and the CPU one in turns, each
             run's infer/s and p50/p99, and D1's launches in the card
             runs (the library's launch log, zeroed by each new process).
             (c) The BERT-base encoder (K1) behind TorchInferenceServer and
             the HTTP front end in this process, driven from a process of
             its own by the native perf_analyzer over CUDA shm with seeded
             ids in [0, 127) (--input-data), then by ``python -m
             client_tpu_torch.perf`` at the same arguments (the client
             phase's window, concurrency and trials): no failed inference,
             the server's inferences at least the report's request count
             and its window count at most 2 x the concurrency above it, every
             region a CrossProcessAttachment, K1 12 per batch and above 0;
             each client's infer/s, p50/p99 and host CPU us per inference;
             then simple_http_cudashm_client (and the gRPC one where
             protobuf is) against add_sub, exit 0 and PASS.
26. examples the port's example clients (ROADMAP 6b, 6d): grpcio and
             protobuf must be importable (find_spec printed if not); the
             port's server on the card over HTTP and gRPC with the models
             tests/test_examples.py registers and continuous_lm (the
             generate phase's model, attn_impl="flash", paged layout);
             every module of client_tpu_torch/examples runs as
             ``python -m client_tpu_torch.examples.<name>`` in a process
             of its own, as tests/test_examples.py runs the reference's
             scripts, four at a time (those that change the server's
             state, EXAMPLE_SERIAL, one after another at the end): exit 0
             and PASS (device_hub: its event), seconds each. Then simple_grpc_generate_client ``-m continuous_lm
             -n 32`` on the first 3 of bench.py's ragged jobs' prompts: 32
             in-vocab tokens each, teacher-forced through the plain path as
             in generate (GREEDY_GAP), K2 (counters zeroed just before)
             12 x 16 per chunk dispatch, K1 0, the engine's TTFT per
             stream. Where a JDK is, the port's Java tree compiled and
             SimpleInferClient and SimpleCudaShmClient (a region made here
             on the card) run against the server; a missing JDK is
             reported, not failed.
27. install  client_tpu_torch._native.install() into a temporary prefix
             from the card's build: the layout; D1 through the installed
             libraries bit-equal to the CPU library and torch (launch
             counted), and the installed bin/perf_analyzer's ``-i direct``
             with no -u (it finds lib/libdirect_models_cuda.so) on each
             model, D1's launches from the library's log; the BERT-base
             encoder over CUDA shm driven by the installed perf_analyzer
             and then the in-tree one at the native phase's settings (no
             failed request, K1 12 per batch, cross-process regions),
             infer/s of each; where cmake is, a find_package(ClientTpuTorch)
             consumer builds the port's simple_http_infer_client.cc
             against ClientTpuTorch::httpclient_tpu_torch_static and runs
             it against add_sub on the same server (PASS); whether cmake
             was found is printed.

Then a line of each phase's wall seconds, the kernel table line
``{"kernels": [...]}`` and, last, the
``{"ok": true, "device": {...}}`` line. Any failure raises and exits
non-zero; so does a machine without CUDA, and a directory that holds this
file without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# the main path's attention shape: bucket 256, seq 128, 12 heads of 64
SLICE_SHAPE = (256, 128, 12, 64)
RAGGED_SHAPE = (4, 100, 12, 64)
# timing only: a long sequence, where the double-buffered key loop matters
LONG_SHAPE = (4, 2048, 12, 64)
# kernel vs plain version, same inputs on the card. f32: the JAX suite's
# own flash tolerance; the two sum in other orders. bf16: one bf16
# rounding of an O(1) output is ~4e-3, and a probability that rounds the
# other way before PV moves an output by about as much again.
ATOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# served embedding (flash) vs the plain attention's forward on the same
# weights and padded batch, entry by entry: |served - plain| <=
# max(EMBED_FLOOR, EMBED_ULPS * ulp_bf16(|plain|)). An embedding entry is a
# bf16 mean over 128 positions of the last of 12 bf16 layers, so no
# absolute bound describes it: one bf16 ulp is 0.03125 for entries in
# [4, 8). Each of the 12 layers rounds the residual stream to bf16 on both
# paths (half an ulp at most each), so one position's value can drift by up
# to 12 ulps between them; the mean over 128 positions averages those
# independent drifts down by about sqrt(128) ~ 11, to about one ulp of the
# mean, and the mean's own rounding to bf16 can put the two values one ulp
# further apart: 2 ulps. The floor, the old absolute bound, covers entries
# near zero, whose ulp is tiny while their drift comes from larger terms.
EMBED_FLOOR = 3e-2
EMBED_ULPS = 2
N_REQUESTS = 48
LAYERS = 12

# K2 vs its plain version on the card. f32: the JAX suite's own tolerance
# for the Pallas kernel (tests/test_paged_attention.py:302); the two sum in
# other orders. bf16: the output is one bf16 rounding of an O(1) value
# (~4e-3), and the kernel keeps P in f32 as the plain version does.
K2_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the generation path: 16 slots, 12 heads of 64, blocks of 16 rows, a
# table of 12 blocks (max_seq 192), a pool of 16 x 12 + 1 blocks
GEN_SLOTS, GEN_CHUNK, GEN_BLOCK, GEN_MAX_SEQ = 16, 16, 16, 192
GEN_POOL = GEN_SLOTS * GEN_MAX_SEQ // GEN_BLOCK + 1
# teacher forcing: the served path (K2, 16 slots) and the plain one (the
# plain K2, another batch) round bf16 activations at other places; over
# 12 layers a logit moves by a few hundredths, so a top-1/top-2 gap above
# this cannot flip between them
GREEDY_GAP = 0.1
# generate_slot: the chunked (slot, paged) and batched runs take the first
# 8 of bench.py's 32 jobs, at full width, to keep the script's time
PREFILL_JOBS = 8
# generate_prefix: the reference perf analyzer's shared-prefix workload
# (client_tpu/perf/__main__.py: 16 streams, suffix 32, budget 32, vocab
# 1024) with the prefix cut from 256 to 128 tokens, so that prompt and
# budget fit max_seq 192; 2 requests per stream from 16 threads
PREFIX_STREAMS, PREFIX_LEN, PREFIX_SUFFIX, PREFIX_BUDGET = 16, 128, 32, 32
PREFIX_VOCAB, PREFIX_REQUESTS = 1024, 32

# the serve_shm phase: requests of the correctness run; bench.py's
# headline and latency-bounded points with the window (6000 ms), stability
# (0.07), trials (10) and attempts (5) cut to keep the phase near two
# minutes
SHM_REQUESTS = 64
SHM_POINT = dict(window_ms=2000, stability=0.10, max_trials=6, attempts=2,
                 max_threads=16)
HEADLINE_CONCURRENCY = 2560
LB_BUCKET, LB_CONCURRENCY, LB_TARGET_P50_MS = 128, 768, 250.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str) -> tuple:
    from client_tpu_torch.perf.bench_harness import card_peaks as lookup

    peaks = lookup(name)
    if peaks is None:
        fail(f"no published peaks for card '{name}'")
    return peaks


def ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits: 2^-7
    of the value's binade); 0 at 0."""
    a = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, np.exp2(e - 7), 0.0)


def embed_bound(plain: np.ndarray) -> np.ndarray:
    """Each embedding entry's tolerance against the plain attention's:
    the larger of EMBED_FLOOR and EMBED_ULPS bf16 ulps of the plain value
    (see EMBED_ULPS)."""
    return np.maximum(EMBED_FLOOR, EMBED_ULPS * ulp_bf16(plain))


def embed_check(served: np.ndarray, plain: np.ndarray) -> dict:
    """The largest |served - plain|, the largest ratio of an entry's error
    to its bound (at most 1 to pass) and, per embedding row, whether every
    entry is within its bound."""
    err = np.abs(np.asarray(served, np.float64) - plain)
    ratio = err / embed_bound(plain)
    return {"max_abs_err": float(err.max()),
            "worst_err_over_bound": float(ratio.max()),
            "rows_within": (ratio <= 1.0).all(axis=-1)}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time per call of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events: the device time where the device sets the
    pace, the host's pacing where the host does."""
    for _ in range(warmup):
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


def device_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the summed durations of the CUDA
    kernels that torch.profiler records over ``iters`` calls, so gaps
    between launches and host pacing do not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # every call launches at least one kernel; a window in which the
    # profiler recorded fewer kernels than calls lost events: profile again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in kernels) >= iters:
            return sum(e.self_device_time_total
                       for e in kernels) / iters / 1e3
    fail(f"torch.profiler recorded fewer kernels than the {iters} calls")


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` (checks, allocation, launch), with the
    card idle at the start: perf_counter around ``calls`` calls that only
    enqueue work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / calls * 1e6


def bound(nbytes: int, flops: int, peaks: tuple) -> dict:
    """The least time the card could take: the larger of the bytes over
    its memory rate and the operations over its bf16 tensor-core rate."""
    bw, bf16_peak = peaks
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / bf16_peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


# ---------------------------------------------------------------- phases

def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    env = {"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit(env)
    return env


def phase_build() -> None:
    from client_tpu_torch.ops import _build

    t0 = time.time()
    paths = _build.build(_build.KERNELS)
    emit({"phase": "build", "kernels": sorted(paths),
          "seconds": time.time() - t0,
          "flags": " ".join(_build.NVCC_FLAGS)})


def _qkv(shape, dtype, gen, strided: bool):
    """q, k, v on the card. ``strided``: views of one [B, L, 3, H, D]
    tensor, the layout the encoder's fused QKV projection hands the
    kernel."""
    b, l, h, d = shape
    if strided:
        qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda",
                          dtype=torch.float32).to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return [torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype) for _ in range(3)]


def phase_kernel(peaks: tuple) -> dict:
    from client_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            cases.append((SLICE_SHAPE, dtype, causal, False))
            cases.append((RAGGED_SHAPE, dtype, causal, False))
        cases.append((SLICE_SHAPE, dtype, False, True))
    errs = []
    for shape, dtype, causal, strided in cases:
        q, k, v = _qkv(shape, dtype, gen, strided)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATOL[dtype]
        case = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "causal": causal, "strided": strided, "max_abs_err": err,
                "atol": tol}
        errs.append(case)
        if not (torch.isfinite(out).all().item() and err <= tol):
            fail(f"flash_attention disagrees with its plain version: {case}")

    def flash_bound(shape, causal, esize):
        b, l, h, d = shape
        pairs = l * (l + 1) // 2 if causal else l * l   # (query, key) pairs
        # read q, k, v and write o once; QK^T and PV on the pairs kept
        return bound(4 * b * l * h * d * esize, 2 * 2 * b * h * pairs * d,
                     peaks)

    def sdpa(q, k, v, causal=False):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)

    # the main path's call: bf16, not causal, q/k/v views of one QKV slab
    q, k, v = _qkv(SLICE_SHAPE, torch.bfloat16, gen, strided=True)
    call = functools.partial(fa.flash_attention, q, k, v)
    timing = {"ms": time_ms(call), "device_ms": device_ms(call),
              "host_us_per_call": host_us_per_call(call),
              "plain_ms": time_ms(
                  lambda: fa.flash_attention_reference(q, k, v), iters=5,
                  warmup=1),
              "library_ms": time_ms(sdpa(q, k, v)),
              "library_device_ms": device_ms(sdpa(q, k, v)),
              **flash_bound(SLICE_SHAPE, False, q.element_size()),
              "max_abs_err": max(c["max_abs_err"] for c in errs)}

    # timing only, at the length where the reference routes attention to
    # its flash kernel (AUTO_FLASH_MIN_SEQ = 512): B 4, L 2048
    long_seq = []
    for causal in (False, True):
        q, k, v = _qkv(LONG_SHAPE, torch.bfloat16, gen, strided=True)
        call = functools.partial(fa.flash_attention, q, k, v, causal=causal)
        err = (call().float() - fa.flash_attention_reference(
            q, k, v, causal=causal).float()).abs().max().item()
        if err > ATOL[torch.bfloat16]:
            fail(f"flash_attention at {LONG_SHAPE} causal={causal} differs "
                 f"from its plain version by {err}")
        long_seq.append({
            "shape": list(LONG_SHAPE), "causal": causal, "max_abs_err": err,
            "ms": time_ms(call, iters=10, warmup=2),
            "device_ms": device_ms(call, iters=10, warmup=1),
            "library_ms": time_ms(sdpa(q, k, v, causal), iters=10, warmup=2),
            "library_device_ms": device_ms(sdpa(q, k, v, causal), iters=10,
                                           warmup=1),
            **flash_bound(LONG_SHAPE, causal, q.element_size())})
    emit({"phase": "kernel", "name": "flash_attention", "cases": errs,
          **timing, "long_sequence": long_seq})
    return timing


def _paged_inputs(s, h, hkv, dh, n, width, pos, dtype, gen, inactive=()):
    """q, one layer's K/V slabs as strided views of a 2-layer pool, block
    tables of distinct non-scratch blocks per slot, positions. Inactive
    slots sit at position 0 on an all-scratch table."""
    q = torch.randn((s, h, dh), generator=gen, device="cuda").to(dtype)
    pool = torch.randn((2, 2, n, GEN_BLOCK, hkv, dh), generator=gen,
                       device="cuda").to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device="cuda") + 1
    tables = perm[:s * width].reshape(s, width).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    for i in inactive:
        tables[i] = 0
        pos[i] = 0
    return q, pool[0, 1], pool[1, 1], tables, pos


# K2 at the heads one tp rank holds: (S/dp, H/tp, Hkv/tp, Dh, pool blocks,
# positions from the path's spread, inactive slots)
MESH_K2_CASES = [
    ("tp2", (16, 6, 6, 64, 193, lambda p: p, (14, 15))),
    ("tp4", (16, 3, 3, 64, 193, lambda p: p, (14, 15))),
    ("dp2_tp4", (8, 3, 3, 64, 193, lambda p: p[8:], (6, 7))),
    ("gqa_tp8", (8, 4, 1, 128, 97, lambda p: p[:8], (7,)))]


# (position, table widths): one slot at live 1, 3, 7 and 12 padded to every
# width up to 12, and at live 25 (clusters of 8, shares of 4 blocks) at
# widths 26, 32 and 48
K2_WIDTH_CASES = [(5, range(1, 13)), (37, range(3, 13)), (100, range(7, 13)),
                  (191, range(12, 13)), (390, (25, 26, 32, 48))]


def _k2_width_invariance(pa, gen) -> list:
    """One slot's K2 output launched alone at its own table width and
    padded to every wider width beside 3 co-runners at longer positions
    (which set the launch's cluster size): it must be bit-equal in every
    launch, in bf16 and f32, at r = 1 and r = 4."""
    runners, n = 3, 1 + 48 * 4
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for h, hkv in ((12, 12), (16, 4)):
            q = torch.randn((runners + 1, h, 64), generator=gen,
                            device="cuda").to(dtype)
            kp, vp = (torch.randn((n, GEN_BLOCK, hkv, 64), generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            blocks = (torch.randperm(n - 1, generator=gen, device="cuda")
                      + 1).to(torch.int32).reshape(runners + 1, 48)
            launches = 0
            for p, widths in K2_WIDTH_CASES:
                live = p // GEN_BLOCK + 1
                own = pa.paged_decode_attention(
                    q[:1], kp, vp, blocks[:1, :live].contiguous(),
                    torch.tensor([p], dtype=torch.int32, device="cuda"))
                for w in widths:
                    tables = blocks[:, :w].clone()
                    tables[0, live:] = 0
                    pos = torch.tensor(
                        [p] + [w * GEN_BLOCK - 1 - i for i in range(runners)],
                        dtype=torch.int32, device="cuda")
                    got = pa.paged_decode_attention(q, kp, vp, tables, pos)
                    launches += 1
                    if not torch.equal(got[0], own[0]):
                        diff = (got[0].float() - own[0].float()).abs().max()
                        fail(f"paged_decode_attention's output for one slot "
                             f"changed with the table width: {dtype}, "
                             f"H {h}/{hkv}, position {p}, width {w}, max "
                             f"|diff| {diff.item()}")
            out.append({"dtype": str(dtype).split(".")[-1], "heads": [h, hkv],
                        "launches_compared": launches, "bit_equal": True})
    return out


def phase_paged_kernel(peaks: tuple) -> dict:
    from client_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    s, h, dh, nb = GEN_SLOTS, 12, 64, GEN_MAX_SEQ // GEN_BLOCK
    spread = [0, 15, 16, 17, 31, 32, 97, 100, 150, 176, 190, 191, 191, 5,
              0, 0]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        # the path's shape: positions 0, a block edge, mid-context, 191
        # and two inactive slots on scratch
        cases.append(("path", dtype, (s, h, h, dh, GEN_POOL, nb, spread,
                                      (14, 15))))
        # narrower tables (the engine's width buckets); positions past the
        # table attend every row of it
        cases.append(("width4", dtype, (s, h, h, dh, GEN_POOL, 4,
                                        [min(p, 70) for p in spread], ())))
        cases.append(("width1", dtype, (s, h, h, dh, GEN_POOL, 1,
                                        [p % 20 for p in spread], ())))
        # grouped queries at the widest head
        cases.append(("gqa", dtype, (8, 32, 8, 128, 97, nb,
                                     [0, 15, 16, 63, 100, 191, 191, 7],
                                     (7,))))
        # the heads one tp rank of a mesh holds (the sharded engine's
        # paged_decode_steps): the path's model at tp 2 and 4 (H = Hkv =
        # 6 and 3), its dp 2 x tp 4 slot block, and the GQA case at tp 8,
        # one KV head a rank
        for name, (ts, th, thkv, tdh, tn, tpos, toff) in MESH_K2_CASES:
            cases.append((name, dtype, (ts, th, thkv, tdh, tn, nb,
                                        tpos(spread), toff)))
    errs = []
    for name, dtype, (cs, ch, chkv, cdh, cn, width, pos, off) in cases:
        args = _paged_inputs(cs, ch, chkv, cdh, cn, width, pos, dtype, gen,
                             off)
        out = pa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        ref = pa.paged_decode_attention_reference(*args)
        err = (out.float() - ref.float()).abs().max().item()
        case = {"case": name, "dtype": str(dtype).split(".")[-1],
                "shape": [cs, ch, chkv, cdh], "table_width": width,
                "max_abs_err": err, "atol": K2_ATOL[dtype]}
        errs.append(case)
        if not (torch.isfinite(out).all().item() and err <= K2_ATOL[dtype]):
            fail(f"paged_decode_attention disagrees with its plain "
                 f"version: {case}")

    width_invariance = _k2_width_invariance(pa, gen)

    # full context: every slot at position 191 over a table of 12 blocks
    q, kp, vp, tables, pos = _paged_inputs(
        s, h, h, dh, GEN_POOL, nb, [GEN_MAX_SEQ - 1] * s, torch.bfloat16,
        gen)
    call = functools.partial(pa.paged_decode_attention, q, kp, vp, tables,
                             pos)
    ms = time_ms(call, iters=50, warmup=5)
    kernel_ms = device_ms(call)
    host_us = host_us_per_call(call)
    plain_ms = time_ms(
        lambda: pa.paged_decode_attention_reference(q, kp, vp, tables, pos),
        iters=10, warmup=2)

    def gather_sdpa():
        idx = tables.long()
        k = kp[idx].reshape(s, nb * GEN_BLOCK, h, dh).transpose(1, 2)
        v = vp[idx].reshape(s, nb * GEN_BLOCK, h, dh).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v)

    # the tp-local shapes at full context, as the main path's call
    tp_local = []
    for name, (ts, th, thkv, tdh, tn, _pos, _off) in MESH_K2_CASES:
        args = _paged_inputs(ts, th, thkv, tdh, tn, nb,
                             [GEN_MAX_SEQ - 1] * ts, torch.bfloat16, gen)
        tcall = functools.partial(pa.paged_decode_attention, *args)
        tbytes = (2 * ts * GEN_MAX_SEQ * thkv * tdh + 2 * ts * th * tdh) \
            * args[0].element_size()
        tp_local.append({
            "case": name, "shape": [ts, th, thkv, tdh],
            "ms": time_ms(tcall, iters=50, warmup=5),
            "device_ms": device_ms(tcall),
            **bound(tbytes, 2 * 2 * ts * th * GEN_MAX_SEQ * tdh, peaks)})

    yard = gather_sdpa()[:, :, 0].float()
    want = pa.paged_decode_attention_reference(q, kp, vp, tables,
                                               pos).float()
    yard_err = (yard - want).abs().max().item()
    yard_ms = time_ms(gather_sdpa, iters=50, warmup=5)
    yard_device_ms = device_ms(gather_sdpa)
    ctx = GEN_MAX_SEQ
    # read the live K and V rows and q, write o
    nbytes = (2 * s * ctx * h * dh + 2 * s * h * dh) * q.element_size()
    timing = {"ms": ms, "device_ms": kernel_ms, "host_us_per_call": host_us,
              "plain_ms": plain_ms, "library_ms": None,
              **bound(nbytes, 2 * 2 * s * h * ctx * dh, peaks),
              "max_abs_err": max(c["max_abs_err"] for c in errs)}
    timing["tp_local"] = tp_local
    emit({"phase": "kernel", "name": "paged_decode_attention",
          "cases": errs, "width_invariance": width_invariance, **timing,
          "library_note": "no single PyTorch call reads K/V through a "
                          "block table; yardstick: gather + "
                          "scaled_dot_product_attention",
          "gather_sdpa_ms": yard_ms, "gather_sdpa_device_ms": yard_device_ms,
          "gather_sdpa_max_abs_err": yard_err})
    return timing


def _post(url: str, body: bytes, headers: dict) -> tuple:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read(), resp.headers


def _infer_json(url: str, tok: np.ndarray) -> np.ndarray:
    body = json.dumps({"inputs": [{
        "name": "input_ids", "shape": list(tok.shape), "datatype": "INT32",
        "data": tok.reshape(-1).tolist()}],
        "outputs": [{"name": "embedding",
                     "parameters": {"binary_data": False}}]}).encode()
    raw, _ = _post(url, body, {"Content-Type": "application/json"})
    out = json.loads(raw)["outputs"][0]
    if out["datatype"] != "FP32":
        fail(f"embedding datatype {out['datatype']}")
    return np.asarray(out["data"], np.float32).reshape(out["shape"])


def _infer_binary(url: str, tok: np.ndarray) -> np.ndarray:
    header = json.dumps({"inputs": [{
        "name": "input_ids", "shape": list(tok.shape), "datatype": "INT32",
        "parameters": {"binary_data_size": tok.nbytes}}],
        "outputs": [{"name": "embedding",
                     "parameters": {"binary_data": True}}]}).encode()
    raw, hdrs = _post(url, header + tok.tobytes(), {
        "Content-Type": "application/octet-stream",
        "Inference-Header-Content-Length": str(len(header))})
    json_len = int(hdrs["Inference-Header-Content-Length"])
    out = json.loads(raw[:json_len])["outputs"][0]
    if out["datatype"] != "FP32":
        fail(f"embedding datatype {out['datatype']}")
    return np.frombuffer(raw[json_len:], np.float32).reshape(out["shape"])


def _encoder_over_http(label: str, seed: int, trace_file: str = "",
                       n_requests: int = N_REQUESTS, core=None) -> dict:
    """The BERT-base encoder (random weights from ``seed``) behind
    TorchInferenceServer's dynamic batcher and the HTTP front end,
    ``n_requests`` concurrent JSON and binary requests, with every request
    traced to ``trace_file`` when one is given. The K1 launch counter is
    set to 0 just before the requests and read just after: 12 per batch.
    Every embedding is held against the same weights' forward with the
    plain attention on the card, at the served (padded) shape. Given a
    ``core``, the encoder joins its models and the core keeps serving
    after the requests."""
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.perf.bench_harness import build_bert_encoder
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    seq, bucket = 128, 256
    cache: dict = {}
    model = build_bert_encoder(seq, bucket, attn_impl="flash",
                               params_cache=cache, seed=seed)
    ref_model = build_bert_encoder(seq, bucket, attn_impl="ref",
                                   params_cache=cache)
    own_core = core is None
    if own_core:
        core = TorchInferenceServer()
    t0 = time.time()
    core.register_model(model, warmup=True)
    register_s = time.time() - t0
    if trace_file:
        core.update_trace_settings(settings={
            "trace_level": ["TIMESTAMPS"], "trace_rate": ["1"],
            "trace_file": [trace_file]})
    http = HttpInferenceServer(core, port=0).start()
    try:
        url = f"http://{http.url}/v2/models/bert_base/infer"
        rng = np.random.default_rng(seed)
        toks = [rng.integers(0, 30528, size=(1, seq)).astype(np.int32)
                for _ in range(n_requests)]
        got: list = [None] * n_requests
        errors: list = []
        go = threading.Barrier(n_requests)

        def client(i):
            try:
                go.wait(timeout=60)
                send = _infer_binary if i % 2 else _infer_json
                got[i] = send(url, toks[i])
            except Exception as e:  # noqa: BLE001 — failed below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        # the main path: counters at 0 just before, read just after
        fa.launches = 0
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.time() - t0
        launches = fa.launches
        if errors or any(t.is_alive() for t in threads):
            fail(f"{label}: {errors[:3]}")
        stats = core.statistics("bert_base")["model_stats"][0]
    finally:
        http.stop()
        if own_core:
            core.stop()      # and flushes the trace file

    batches = stats["execution_count"]
    if stats["inference_count"] != n_requests:
        fail(f"{label}: stats count {stats['inference_count']} inferences")
    if launches != LAYERS * batches:
        fail(f"{label}: {launches} flash_attention launches for {batches} "
             f"batches, expected {LAYERS} per batch")
    padded = np.zeros((bucket, seq), np.int32)
    padded[:n_requests] = np.concatenate(toks)
    want = ref_model.execute({"input_ids": padded})["embedding"][:n_requests]
    for out in got:
        if out.shape != (1,) + want.shape[1:] or out.dtype != np.float32 \
                or not np.isfinite(out).all():
            fail(f"{label}: bad embedding {out.shape} {out.dtype}")
    check = embed_check(np.concatenate(got), want)
    if not check["rows_within"].all():
        fail(f"{label}: embeddings differ from the plain attention's by "
             f"{check['worst_err_over_bound']} of the bound (max "
             f"{EMBED_FLOOR}, {EMBED_ULPS} bf16 ulps), largest error "
             f"{check['max_abs_err']}")
    return {"model": model, "ref_model": ref_model, "stats": stats,
            "batches": batches, "flash_attention_launches": launches,
            "embedding_max_abs_err_vs_ref": check["max_abs_err"],
            "embedding_worst_err_over_bound":
                check["worst_err_over_bound"], "wall_s": wall_s,
            "register_with_warmup_s": register_s}


def phase_serve() -> dict:
    from client_tpu_torch.perf.bench_harness import probe_step_ms

    seq, bucket = 128, 256
    run = _encoder_over_http("serve", 0)
    stats = run["stats"]
    sizes = [b["batch_size"] for b in stats["batch_stats"]]
    if max(sizes) < 2:
        fail(f"serve: the batcher formed no batch of more than one "
             f"request (batch sizes {sizes})")
    step_ms = probe_step_ms(run["model"], seq, bucket)
    ref_step_ms = probe_step_ms(run["ref_model"], seq, bucket)
    result = {"phase": "serve", "requests": N_REQUESTS,
              "batches": run["batches"], "batch_sizes": sizes,
              "flash_attention_launches": run["flash_attention_launches"],
              "embedding_max_abs_err_vs_ref":
                  run["embedding_max_abs_err_vs_ref"],
              "embedding_worst_err_over_bound":
                  run["embedding_worst_err_over_bound"],
              "embed_floor": EMBED_FLOOR, "embed_ulps": EMBED_ULPS,
              "wall_s": run["wall_s"],
              "register_with_warmup_s": run["register_with_warmup_s"],
              "step_ms_flash": step_ms, "step_ms_ref": ref_step_ms,
              "queue_ns": stats["inference_stats"]["queue"]["ns"],
              "compute_infer_ns":
                  stats["inference_stats"]["compute_infer"]["ns"]}
    emit(result)
    return result


@contextlib.contextmanager
def _scrape_meter():
    """Count the perf analyzer's measurement windows and its /metrics
    scrapes (InProcessBackend.server_metrics) while the block runs, with
    the host seconds the scrapes took."""
    from client_tpu_torch.perf.client_backend import InProcessBackend
    from client_tpu_torch.perf.inference_profiler import InferenceProfiler

    meter = {"windows": 0, "scrapes": 0, "scrape_s": 0.0}
    scrape, measure = InProcessBackend.server_metrics, \
        InferenceProfiler.measure

    def timed_scrape(self):
        t0 = time.perf_counter()
        try:
            return scrape(self)
        finally:
            meter["scrape_s"] += time.perf_counter() - t0
            meter["scrapes"] += 1

    def counted_measure(self):
        meter["windows"] += 1
        return measure(self)

    InProcessBackend.server_metrics = timed_scrape
    InferenceProfiler.measure = counted_measure
    try:
        yield meter
    finally:
        InProcessBackend.server_metrics = scrape
        InferenceProfiler.measure = measure


def _scrape_summary(meter: dict) -> dict:
    return {"windows": meter["windows"], "scrapes": meter["scrapes"],
            "scrapes_per_window": meter["scrapes"] / max(1, meter["windows"]),
            "host_ms_per_scrape": (meter["scrape_s"] / meter["scrapes"] * 1e3
                                   if meter["scrapes"] else None)}


def _stats(core, name: str) -> dict:
    return core.statistics(name)["model_stats"][0]


def _batch_profile(before: dict, after: dict) -> dict:
    """What the batcher did between two statistics snapshots: executions,
    inferences, failures, the batch-size distribution and the mean
    compute_input / compute_infer / compute_output ns per batch."""
    execs = after["execution_count"] - before["execution_count"]

    def sizes(stats):
        return {b["batch_size"]: b["compute_infer"]["count"]
                for b in stats["batch_stats"]}

    was = sizes(before)
    dist = {bs: n - was.get(bs, 0) for bs, n in sizes(after).items()
            if n - was.get(bs, 0)}
    per_batch = {}
    for key in ("compute_input", "compute_infer", "compute_output"):
        ns = sum(b[key]["ns"] for b in after["batch_stats"]) \
            - sum(b[key]["ns"] for b in before["batch_stats"])
        per_batch[f"mean_{key}_ns_per_batch"] = ns / execs if execs else None
    fails = (after["inference_stats"]["fail"]["count"]
             - before["inference_stats"]["fail"]["count"])
    return {"executions": execs,
            "inferences": after["inference_count"]
            - before["inference_count"],
            "failed_requests": fails,
            "batch_size_distribution": dict(sorted(dist.items())),
            **per_batch}


def phase_serve_shm() -> dict:
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.perf.bench_harness import (
        D_MODEL,
        VOCAB,
        bert_flops_per_infer,
        build_bert_encoder,
        stabilized_point,
    )
    from client_tpu_torch.perf.client_backend import (
        InProcessBackend,
        PerfInput,
        PerfRequestedOutput,
    )
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    seq, bucket, n = 128, 256, SHM_REQUESTS
    cache: dict = {}
    model = build_bert_encoder(seq, bucket, attn_impl="flash",
                               pipeline_depth=8, params_cache=cache, seed=0)
    ref_model = build_bert_encoder(seq, bucket, attn_impl="ref",
                                   params_cache=cache)
    core = TorchInferenceServer()
    t0 = time.time()
    core.register_model(model, warmup=True)
    register_s = time.time() - t0
    backend = InProcessBackend(core)
    toks = np.random.default_rng(1).integers(
        0, VOCAB, size=(n, 1, seq)).astype(np.int32)
    out_bytes = D_MODEL * 4
    regions = []
    try:
        for i in range(n):
            h_in = cudashm.create_shared_memory_region(
                f"smoke_in_{i}", toks[i].nbytes)
            regions.append(h_in)
            cudashm.set_shared_memory_region(h_in, [toks[i]])
            h_out = cudashm.create_shared_memory_region(
                f"smoke_out_{i}", out_bytes)
            regions.append(h_out)
            for h in (h_in, h_out):
                backend.register_cuda_shared_memory(
                    h.name, cudashm.get_raw_handle(h), h.device_id,
                    h.byte_size)
        registered = {h.device_tensors[0][0].data_ptr()
                      for h in regions[0::2]}

        # every input tensor a batch reads, by data_ptr
        read_ptrs: list = []
        split = model.execute_parts_fused_split

        def recording(parts, b):
            read_ptrs.extend(p["input_ids"].data_ptr() for p in parts)
            return split(parts, b)

        model.execute_parts_fused_split = recording
        got: list = [None] * n
        errors: list = []
        done = threading.Event()
        lock = threading.Lock()

        def callback(i):
            def cb(result, error):
                if error is not None:
                    errors.append(f"request {i}: {error}")
                else:
                    # read right after the response: the row, not stale
                    # bytes
                    got[i] = cudashm.get_contents_as_numpy(
                        regions[2 * i + 1], np.float32, (1, D_MODEL)).copy()
                with lock:
                    if sum(x is not None for x in got) + len(errors) == n:
                        done.set()
            return cb

        requests = []
        for i in range(n):
            x = PerfInput("input_ids", [1, seq], "INT32")
            x.set_shared_memory(f"smoke_in_{i}", toks[i].nbytes)
            o = PerfRequestedOutput("embedding")
            o.set_shared_memory(f"smoke_out_{i}", out_bytes)
            requests.append(([x], [o]))
        before = _stats(core, "bert_base")
        # the main path: counters at 0 just before, read just after
        fa.launches = 0
        model.fused_split_calls = 0
        t0 = time.time()
        for i, (ins, outs) in enumerate(requests):
            backend.async_infer(callback(i), "bert_base", ins, outs)
        if not done.wait(timeout=300):
            fail("serve_shm: requests did not complete")
        wall_s = time.time() - t0
        launches = fa.launches
        split_calls = model.fused_split_calls
        after = _stats(core, "bert_base")
        del model.execute_parts_fused_split
        if errors:
            fail(f"serve_shm: {errors[:3]}")
        correctness = _batch_profile(before, after)
        execs = correctness["executions"]
        if split_calls != execs:
            fail(f"serve_shm: {split_calls} pre-split calls for {execs} "
                 "batches")
        if launches != LAYERS * execs:
            fail(f"serve_shm: {launches} flash_attention launches for "
                 f"{execs} batches, expected {LAYERS} per batch")
        input_copies = len(set(read_ptrs) - registered)
        if input_copies or not registered <= set(read_ptrs):
            fail(f"serve_shm: batches read {input_copies} input tensors "
                 "that are not the registered ones")
        emb = np.concatenate(got)
        if emb.shape != (n, D_MODEL) or not np.isfinite(emb).all():
            fail(f"serve_shm: bad embeddings {emb.shape}")
        padded = np.zeros((bucket, seq), np.int32)
        padded[:n] = toks[:, 0]
        want = ref_model.execute({"input_ids": padded})["embedding"][:n]
        check = embed_check(emb, want)
        within = int(check["rows_within"].sum())
        if within != n:
            fail(f"serve_shm: {n - within} of {n} embeddings differ from "
                 f"the plain attention's by more than the bound (max "
                 f"{EMBED_FLOOR}, {EMBED_ULPS} bf16 ulps; worst "
                 f"{check['worst_err_over_bound']} of it)")

        flops = bert_flops_per_infer(seq)
        before = _stats(core, "bert_base")
        fa.launches = 0
        with _scrape_meter() as meter:
            headline = stabilized_point(
                core, "bert_base", HEADLINE_CONCURRENCY,
                flops_per_infer=flops, output_shm_size=out_bytes,
                **SHM_POINT)
        headline_launches = fa.launches
        headline["metrics_scrapes"] = _scrape_summary(meter)
        headline_batches = _batch_profile(before, _stats(core, "bert_base"))
        if headline_launches != LAYERS * headline_batches["executions"]:
            fail(f"serve_shm: headline point launched flash_attention "
                 f"{headline_launches} times for "
                 f"{headline_batches['executions']} batches")

        core.register_model(build_bert_encoder(
            seq, LB_BUCKET, attn_impl="flash", name="bert_base_lb",
            pipeline_depth=8, params_cache=cache), warmup=True)
        before = _stats(core, "bert_base_lb")
        lb = stabilized_point(
            core, "bert_base_lb", LB_CONCURRENCY, flops_per_infer=flops,
            output_shm_size=out_bytes, **SHM_POINT)
        lb_batches = _batch_profile(before, _stats(core, "bert_base_lb"))
    finally:
        core.stop()
        for h in regions:
            cudashm.destroy_shared_memory_region(h)
    lb.update(max_batch=LB_BUCKET, target_p50_ms=LB_TARGET_P50_MS,
              meets_target=lb["p50_latency_ms"] <= LB_TARGET_P50_MS)
    for name, point, batches in (("headline", headline, headline_batches),
                                 ("latency_bounded", lb, lb_batches)):
        if batches["failed_requests"] or point["client_rejected_count"]:
            fail(f"serve_shm: the {name} point failed "
                 f"{batches['failed_requests']} requests and had "
                 f"{point['client_rejected_count']} rejected")
    result = {
        "phase": "serve_shm", "requests": n, "register_with_warmup_s":
            register_s, "wall_s": wall_s,
        "embeddings_within_bound": within, "embed_floor": EMBED_FLOOR,
        "embed_ulps": EMBED_ULPS,
        "embedding_max_abs_err_vs_ref": check["max_abs_err"],
        "embedding_worst_err_over_bound": check["worst_err_over_bound"],
        "fused_split_calls": split_calls,
        "flash_attention_launches": launches, "input_copies": input_copies,
        "correctness_batches": correctness,
        "headline": {**headline, "flash_attention_launches":
                     headline_launches, **headline_batches},
        "latency_bounded": {**lb, **lb_batches}}
    emit(result)
    return result


def _teacher_forced(cfg, params, seqs: list, plens: list) -> dict:
    """Feed every greedy stream (prompt + served tokens) through the plain
    path on the card, all streams as the slots of one batch:
    ``paged_decode_steps`` with the plain K2, or, under ``cfg.kv_quant``,
    with the dequantising einsum over an int8 pool (K2 never reads int8,
    as in the reference). Per stream, counts the served tokens, the ones
    judged (where the plain top-1/top-2 gap exceeds GREEDY_GAP) and the
    judged ones that differ from the plain argmax."""
    import dataclasses

    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.ops.paged_attention import (
        paged_decode_attention_reference,
    )
    from client_tpu_torch.server.kv_cache import init_paged_pool

    n, nb = len(seqs), GEN_MAX_SEQ // GEN_BLOCK
    longest = max(len(x) for x in seqs)
    grid = np.zeros((n, longest), np.int32)
    for i, x in enumerate(seqs):
        grid[i, :len(x)] = x
    toks = torch.from_numpy(grid).cuda()
    lens = torch.tensor([len(x) for x in seqs], device="cuda")
    plen = torch.tensor(plens, device="cuda")
    attention = paged_decode_attention_reference
    if cfg.kv_quant:
        attention = None
        cfg = dataclasses.replace(cfg, attn_impl="ref")
    pool = init_paged_pool(cfg, n * nb + 1, GEN_BLOCK, "cuda")
    tables = (1 + torch.arange(n * nb, device="cuda")).reshape(
        n, nb).to(torch.int32)
    checked = torch.zeros((n,), dtype=torch.int64, device="cuda")
    bad = torch.zeros((n,), dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        for p in range(longest - 1):
            pos = torch.full((n,), p, dtype=torch.int32, device="cuda")
            width = p // GEN_BLOCK + 1
            logits, pool = t.paged_decode_steps(
                cfg, params, toks[:, p], pos, tables[:, :width], pool,
                attention=attention)
            top2 = logits.topk(2, dim=-1).values
            # logits at p predict token p + 1: a served token when it
            # lies past the prompt and inside the stream
            judged = (p + 1 >= plen) & (p + 1 < lens) \
                & (top2[:, 0] - top2[:, 1] > GREEDY_GAP)
            wrong = logits.argmax(dim=-1) != toks[:, p + 1]
            checked += judged
            bad += judged & wrong
    return {"served": [len(x) - q for x, q in zip(seqs, plens)],
            "judged": checked.tolist(), "bad": bad.tolist()}


def _judge_greedy(cfg, params, runs: list) -> None:
    """Teacher-force the greedy streams of every run of ``runs`` together,
    as one batch: each run gets its ``teacher_forced`` counts, and any
    mismatch, or fewer than half of a run's served tokens judged, fails."""
    seqs, plens, owner = [], [], []
    for k, run in enumerate(runs):
        for seq, q in run.pop("greedy_streams"):
            seqs.append(seq)
            plens.append(q)
            owner.append(k)
    per = _teacher_forced(cfg, params, seqs, plens)
    for k, run in enumerate(runs):
        mine = [i for i, o in enumerate(owner) if o == k]
        tf = {"greedy_streams": len(mine),
              "served_tokens": sum(per["served"][i] for i in mine),
              "judged_tokens": sum(per["judged"][i] for i in mine),
              "mismatches": sum(per["bad"][i] for i in mine),
              "gap_tol": GREEDY_GAP}
        run["teacher_forced"] = tf
        if tf["mismatches"] or tf["judged_tokens"] < tf["served_tokens"] // 2:
            fail(f"{run['run']}: greedy streams differ from the plain path: "
                 f"{tf}")


def _dispatch_profile(engine_cfg, params, slot: bool = False) -> dict:
    """One greedy chunk dispatch of the generation path outside the
    engine, at full width (16 active slots mid-context, none frozen; the
    paged layout's tables of 12 blocks, or with ``slot`` the slot
    layout's rows): its host time, its stream time between CUDA events,
    and by torch.profiler its device busy time (the sum of its kernels)
    and its kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.models.transformer import init_decode_state
    from client_tpu_torch.server.generation import (
        chunk_kernel,
        paged_chunk_kernel,
    )
    from client_tpu_torch.server.kv_cache import init_paged_pool

    s, c, nb = GEN_SLOTS, GEN_CHUNK, GEN_MAX_SEQ // GEN_BLOCK
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    if slot:
        cache = init_decode_state(engine_cfg, s, dev)
    else:
        pool = init_paged_pool(engine_cfg, GEN_POOL, GEN_BLOCK, dev)
        tables = (1 + torch.arange(s * nb, device=dev)).reshape(s, nb).to(
            torch.int32)
    zi = torch.zeros((s,), dtype=torch.int32, device=dev)
    pos = torch.full((s,), 96, dtype=torch.int32, device=dev)
    zf = torch.zeros((s,), device=dev)
    feed = torch.randint(0, engine_cfg.vocab_size, (s, c), generator=gen,
                         device=dev, dtype=torch.int32)
    ones = torch.ones((s,), dtype=torch.bool, device=dev)
    ring = torch.zeros((4, s, c), dtype=torch.int32, device=dev)
    cnt = torch.zeros((4, s), dtype=torch.int32, device=dev)

    def dispatch():
        if slot:
            return chunk_kernel(
                engine_cfg, params, cache, pos, zi, ring, cnt, 0, feed, zi,
                ones, ~ones, None, zi, zf, zi, zf, False)
        return paged_chunk_kernel(
            engine_cfg, params, pool, pos, zi, ring, cnt, 0, tables, feed,
            zi, ones, ones, pos, None, zi, zf, zi, zf, False)

    with torch.inference_mode():
        dispatch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dispatch()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dispatch()
            torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    for evt in prof.key_averages():
        busy_us += getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0))
        if evt.key.startswith("cudaLaunchKernel"):
            launches += evt.count
    return {"layout": "slot" if slot else "paged",
            "host_ms": host_ms, "event_ms": event_ms,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "kernel_launches": launches}


def _stream_request(prompt, budget, sampling, labels=None):
    from client_tpu_torch.server.types import InferRequest, InferTensor

    inputs = [InferTensor("PROMPT", "INT32", (len(prompt),), data=prompt),
              InferTensor("MAX_TOKENS", "INT32", (1,),
                          data=np.asarray([budget], np.int32))]
    if sampling is not None:
        temp, top_k, seed = sampling
        inputs += [
            InferTensor("TEMPERATURE", "FP32", (1,),
                        data=np.asarray([temp], np.float32)),
            InferTensor("TOP_K", "INT32", (1,),
                        data=np.asarray([top_k], np.int32)),
            InferTensor("SEED", "INT32", (1,),
                        data=np.asarray([seed], np.int32))]
    tenant, slo_class = labels or ("default", "best_effort")
    return InferRequest(model_name="continuous_lm", inputs=inputs,
                        tenant_id=tenant, slo_class=slo_class)


def _generation_model() -> tuple:
    """bench.py's generation model at full width (vocab 30528, d 768, 12
    layers, 12 heads of 64, d_ff 3072, max_seq 192, bf16) with random
    weights from seed 0 on the card, and bench.py's 32 ragged jobs."""
    from client_tpu_torch.bench import generation_config
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.perf.bench_harness import ragged_generation_jobs

    cfg = generation_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = t.init_params(gen, cfg)
    jobs = ragged_generation_jobs(7, cfg.vocab_size, 32, (8, 64), (16, 128),
                                  cfg.max_seq)
    return cfg, params, jobs


def _serve_generation(label: str, cfg, params, jobs: list, sampling: list,
                      n_threads: int = 0, settled=None, labels=None,
                      late=None, instrument=None, around=None,
                      **engine_kw) -> dict:
    """Serve ``jobs`` through make_continuous_generator and
    TorchInferenceServer.infer with a response callback, one thread each,
    all started together (with ``n_threads``, thread k sends jobs k,
    k + n_threads, ... one after another; ``labels`` gives each job its
    (tenant, slo_class); with ``late`` = (k, cond), jobs k and later are
    sent once ``cond(engine)`` holds; ``instrument(engine)`` runs on the
    built engine before the warmup stream; ``around(core)``, a context
    manager, is entered just before the counters are set to 0 and left
    once the streams end); check that every stream
    streamed exactly its budget of in-vocab tokens and then one final flag
    (its greedy streams go to ``_judge_greedy``). The K2 and K1 launch
    counters are set to 0 just before the streams start and read just
    after they end. ``settled(engine)``, called once the streams are done
    and before the server stops, adds its dict to the result. Returns the
    run's counters and latencies, with each job's TTFT as its client saw
    it."""
    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import TorchInferenceServer

    model = make_continuous_generator(
        "continuous_lm", cfg=cfg, params=params, n_slots=GEN_SLOTS,
        chunk_size=GEN_CHUNK, dispatch_depth=2, max_new_tokens=128,
        eos_id=-1, device="cuda", **engine_kw)
    if instrument is not None:
        instrument(model.engine)
    core = TorchInferenceServer()
    t0 = time.time()
    core.register_model(model, warmup=True)
    register_s = time.time() - t0
    streams: list = [[] for _ in jobs]
    finals = [0] * len(jobs)
    sent = [0.0] * len(jobs)
    first = [0.0] * len(jobs)
    errors: list = []
    n_threads = n_threads or len(jobs)
    go = threading.Barrier(n_threads)

    def one(i):
        prompt, budget = jobs[i]

        def cb(resp, final):
            if resp.error is not None:
                errors.append(f"job {i}: {resp.error_status} {resp.error}")
            elif final:
                finals[i] += 1
            else:
                if finals[i]:
                    errors.append(f"job {i}: a token after the final flag")
                if not streams[i]:
                    first[i] = time.perf_counter()
                streams[i].append(int(resp.output("TOKEN").data[0]))

        if late is not None and i >= late[0]:
            end = time.time() + 120
            while not late[1](model.engine):
                if time.time() > end:
                    raise TimeoutError(f"job {i}: its arrival condition "
                                       f"never held")
                time.sleep(0.002)
        # the stream runs on this thread: infer returns after its final
        # response
        sent[i] = time.perf_counter()
        core.infer(_stream_request(prompt, budget, sampling[i],
                                   None if labels is None else labels[i]),
                   response_callback=cb)

    def client(k):
        try:
            go.wait(timeout=60)
            for i in range(k, len(jobs), n_threads):
                one(i)
        except Exception as e:  # noqa: BLE001 — failed below
            errors.append(f"thread {k}: {type(e).__name__}: {e}")

    engine = model.engine
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    try:
        before = engine.stats()
        snap0 = engine.gen_stats.snapshot()
        with (around(core) if around is not None
              else contextlib.nullcontext()):
            # the main path: counters at 0 just before, read just after
            pa.launches = 0
            fa.launches = 0
            t0 = time.time()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall_s = time.time() - t0
            k2, k1 = pa.launches, fa.launches
        after = engine.stats()
        snap = engine.gen_stats.snapshot()
        extra = settled(engine) if settled is not None else {}
    finally:
        core.stop()
    if errors or any(th.is_alive() for th in threads):
        fail(f"{label}: {errors[:3]}")
    for i, ((prompt, budget), got) in enumerate(zip(jobs, streams)):
        if len(got) != budget or finals[i] != 1:
            fail(f"{label}: job {i} streamed {len(got)} tokens of {budget} "
                 f"and {finals[i]} final flags")
        if not all(0 <= x < cfg.vocab_size for x in got):
            fail(f"{label}: job {i} streamed a token outside the vocab")
    greedy = [i for i in range(len(jobs)) if sampling[i] is None]
    # every dispatch, and by kind: chunks, verify rounds, draft catch-ups
    dispatches = after["chunks_dispatched"] - before["chunks_dispatched"]
    kinds = {k: {f: v[f] - before["dispatch_by_kind"][k][f] for f in v}
             for k, v in after["dispatch_by_kind"].items()}
    chunks = kinds["chunk"]["dispatches"]
    spec = None
    if after["speculation"] is not None:
        s0, s1 = before["speculation"], after["speculation"]
        d = {k: s1[k] - s0[k] for k in ("proposed", "accepted", "rounds")}
        r0, r1 = snap0["spec_rung_rounds"], snap["spec_rung_rounds"]
        spec = {**d, "verify_dispatches": kinds["spec"]["dispatches"],
                "acceptance": d["accepted"] / max(1, d["proposed"]),
                # verified tokens (accepted + the one every round emits)
                "tokens_per_round": (d["accepted"] + d["rounds"])
                / max(1, d["rounds"]),
                "rounds_by_rung": {str(g): r1[g] - r0.get(g, 0)
                                   for g in sorted(r1)},
                "gamma": s1["gamma"], "ladder": s1["ladder"],
                "min_acceptance": s1["min_acceptance"]}
    useful = sum(b for _, b in jobs)
    phase_s = {k: after["phase_seconds"][k] - before["phase_seconds"][k]
               for k in after["phase_seconds"]}
    timed = after["timed_dispatches"] - before["timed_dispatches"]
    event_ms = after["dispatch_event_ms"] - before["dispatch_event_ms"]
    lane = after["prefill_lane"]
    ttft, itl = snap["ttft"], snap["inter_token"]
    return {
        "run": label, "kv_layout": after["kv_layout"],
        "prefill_mode": after["prefill_mode"], "attn_impl": cfg.attn_impl,
        "jobs": len(jobs), "useful_tokens": useful,
        "sampled_jobs": len(jobs) - len(greedy), "wall_s": wall_s,
        "continuous_batching_ragged_tokens_per_s": useful / wall_s,
        "chunk_dispatches": chunks, "dispatches": dispatches,
        "dispatches_by_kind": {k: v["dispatches"] for k, v in kinds.items()
                               if v["dispatches"]},
        "speculation": spec,
        "host_ms_per_dispatch_by_kind": {
            k: v["host_s"] / v["dispatches"] * 1e3
            for k, v in kinds.items() if v["dispatches"]},
        "paged_decode_attention_launches": k2,
        "flash_attention_launches": k1,
        "prefill_lane_chunks": None if lane is None else
        lane["chunks"] - (before["prefill_lane"] or {}).get("chunks", 0),
        "host_ms_per_dispatch": phase_s["dispatch"] / dispatches * 1e3,
        "event_ms_per_dispatch": event_ms / timed if timed else None,
        "phase_seconds": phase_s,
        "ttft_mean_ms": ttft[1] / max(1, ttft[2]) / 1e6,
        "itl_mean_ms": itl[1] / max(1, itl[2]) / 1e6,
        "client_ttft_ms": [(f - s0) * 1e3 for s0, f in zip(sent, first)],
        "prefix_hits": snap["prefix_hits"],
        "prefix_misses": snap["prefix_misses"],
        "prefix_saved_tokens": snap["prefix_saved_tokens"],
        "register_with_warmup_s": register_s,
        **extra,
        # (prompt + served tokens, prompt length) of the greedy streams,
        # for _judge_greedy
        "greedy_streams": [(np.concatenate([jobs[i][0], streams[i]]),
                            len(jobs[i][0])) for i in greedy]}


def phase_generate(gen_model: tuple) -> dict:
    import dataclasses

    cfg, params, jobs = gen_model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    # a quarter of the jobs sampled, each with its own seed
    sampling = [(0.8, 40, 1000 + i) if i % 4 == 3 else None
                for i in range(len(jobs))]
    t0 = time.time()
    run = _serve_generation("generate", cfg, params, jobs, sampling,
                            kv_layout="paged", kv_block_len=GEN_BLOCK)
    t1 = time.time()
    _judge_greedy(cfg, params, [run])
    t2 = time.time()
    chunks = run["chunk_dispatches"]
    launches = run["paged_decode_attention_launches"]
    if launches != LAYERS * GEN_CHUNK * chunks:
        fail(f"generate: {launches} paged_decode_attention launches for "
             f"{chunks} chunk dispatches, expected {LAYERS} x {GEN_CHUNK} "
             f"per dispatch")
    standalone = [_dispatch_profile(cfg, params)]
    result = {"phase": "generate", **run, "standalone_dispatch": standalone,
              "seconds": {"serve": t1 - t0, "judge": t2 - t1,
                          "profile": time.time() - t2}}
    emit(result)
    return result


def phase_generate_slot(gen_model: tuple) -> dict:
    """bench.py's generation point as the reference runs it (the slot
    layout, the plain attention, token-level prefill, bench.py's 32 jobs),
    then the chunked lane on the slot and on the paged layout (K2) and
    the batched prefill, at the same width on the first PREFILL_JOBS
    jobs."""
    import dataclasses

    cfg, params, jobs = gen_model
    greedy = [None] * len(jobs)
    t0 = time.time()
    runs = [_serve_generation("bench_point", cfg, params, jobs, greedy)]
    cut = jobs[:PREFILL_JOBS]
    flash = dataclasses.replace(cfg, attn_impl="flash")
    for label, run_cfg, kw in (
            ("chunked_slot", cfg, dict(prefill_mode="chunked")),
            ("chunked_paged", flash, dict(prefill_mode="chunked",
                                          kv_layout="paged",
                                          kv_block_len=GEN_BLOCK)),
            ("batched_slot", cfg, dict(prefill_mode="batched"))):
        runs.append(_serve_generation(label, run_cfg, params, cut,
                                      greedy[:len(cut)],
                                      prefill_chunk=64, **kw))
    t1 = time.time()
    # the plain path does not depend on attn_impl: it is given its
    # attention
    _judge_greedy(cfg, params, runs)
    t2 = time.time()
    runs[0]["standalone_dispatch"] = [
        _dispatch_profile(cfg, params, slot=True)]
    seconds = {"serve": t1 - t0, "judge": t2 - t1,
               "profile": time.time() - t2}
    for run in runs:
        paged = run["kv_layout"] == "paged"
        want = LAYERS * GEN_CHUNK * run["chunk_dispatches"] if paged else 0
        if run["paged_decode_attention_launches"] != want:
            fail(f"generate_slot: the {run['run']} run launched "
                 f"paged_decode_attention "
                 f"{run['paged_decode_attention_launches']} times in "
                 f"{run['chunk_dispatches']} chunk dispatches, expected "
                 f"{want}")
        if run["flash_attention_launches"]:
            fail(f"generate_slot: the {run['run']} run launched "
                 f"flash_attention, which no prefill path of the "
                 f"reference takes")
        if run["prefill_mode"] == "chunked" and not run["prefill_lane_chunks"]:
            fail(f"generate_slot: the {run['run']} run dispatched no lane "
                 f"chunk")
    result = {"phase": "generate_slot", "prefill_jobs": PREFILL_JOBS,
              "runs": runs, "seconds": seconds}
    emit(result)
    return result


def _shared_prefix_jobs() -> list:
    """The shared-prefix workload as the port's perf DataLoader builds it,
    PREFIX_REQUESTS (prompt, budget) jobs rotating over its streams."""
    from client_tpu_torch.perf.data_loader import DataLoader
    from client_tpu_torch.perf.model_parser import TensorInfo

    loader = DataLoader(1)
    loader.generate_shared_prefix_data(
        {"PROMPT": TensorInfo("PROMPT", "INT32", [-1]),
         "MAX_TOKENS": TensorInfo("MAX_TOKENS", "INT32", [1])},
        prefix_len=PREFIX_LEN, suffix_len=PREFIX_SUFFIX,
        n_streams=PREFIX_STREAMS, vocab=PREFIX_VOCAB,
        max_tokens=PREFIX_BUDGET)
    return [(loader.get_input_data("PROMPT", r % PREFIX_STREAMS).astype(
        np.int32), int(loader.get_input_data("MAX_TOKENS", 0)[0]))
        for r in range(PREFIX_REQUESTS)]


def _prefix_settled(engine) -> dict:
    """The prefix index once the engine thread has freed the last slot:
    its counters, its occupancy and the trie nodes still holding a ref
    (None of them for an engine without the cache)."""
    deadline = time.time() + 30
    while engine.active_slots() and time.time() < deadline:
        time.sleep(0.01)
    index = engine._prefix_index
    return {"slots_active_after": engine.active_slots(),
            "prefix_cache": None if index is None else index.snapshot(),
            "occupancy": None if index is None else index.occupancy(),
            "pinned_nodes": None if index is None else index.pinned_nodes()}


def phase_generate_prefix(gen_model: tuple) -> dict:
    """The prefix cache at bench.py's generation width: the shared-prefix
    workload on the slot layout and on the paged layout (K2) with
    prefix_cache on, and on the slot layout with it off."""
    import dataclasses

    cfg, params, _ = gen_model
    jobs = _shared_prefix_jobs()
    greedy = [None] * len(jobs)
    flash = dataclasses.replace(cfg, attn_impl="flash")
    t0 = time.time()
    runs = []
    for label, run_cfg, kw in (
            ("prefix_slot", cfg, dict(prefix_cache=True)),
            ("prefix_paged", flash, dict(prefix_cache=True,
                                         kv_layout="paged",
                                         kv_block_len=GEN_BLOCK)),
            ("no_prefix_slot", cfg, dict(prefix_cache=False))):
        runs.append(_serve_generation(
            label, run_cfg, params, jobs, greedy, n_threads=PREFIX_STREAMS,
            settled=_prefix_settled, prefix_block_len=GEN_BLOCK, **kw))
    t1 = time.time()
    _judge_greedy(cfg, params, runs)
    t2 = time.time()
    for run in runs:
        name = run["run"]
        paged = run["kv_layout"] == "paged"
        want = LAYERS * GEN_CHUNK * run["chunk_dispatches"] if paged else 0
        if run["paged_decode_attention_launches"] != want \
                or run["flash_attention_launches"]:
            fail(f"generate_prefix: the {name} run launched "
                 f"paged_decode_attention "
                 f"{run['paged_decode_attention_launches']} times (expected "
                 f"{want}) and flash_attention "
                 f"{run['flash_attention_launches']} times (expected 0)")
        if run["slots_active_after"]:
            fail(f"generate_prefix: {name}: {run['slots_active_after']} "
                 f"slots still held after the drain")
        # each thread's first request against its second
        ttft = run.pop("client_ttft_ms")
        run["client_ttft_first_wave_mean_ms"] = float(
            np.mean(ttft[:PREFIX_STREAMS]))
        run["client_ttft_second_wave_mean_ms"] = float(
            np.mean(ttft[PREFIX_STREAMS:]))
        if run["prefix_cache"] is None:
            if run["prefix_hits"] or run["prefix_misses"]:
                fail(f"generate_prefix: {name} counted prefix lookups "
                     f"with the cache off")
            continue
        if run["prefix_hits"] < PREFIX_STREAMS \
                or run["prefix_saved_tokens"] < PREFIX_STREAMS * PREFIX_LEN:
            fail(f"generate_prefix: {name}: {run['prefix_hits']} hits and "
                 f"{run['prefix_saved_tokens']} saved tokens, expected at "
                 f"least {PREFIX_STREAMS} and {PREFIX_STREAMS * PREFIX_LEN}")
        if run["pinned_nodes"]:
            fail(f"generate_prefix: {name}: {run['pinned_nodes']} trie "
                 f"nodes still pinned after the drain")
        occ = run["occupancy"]
        if paged and (occ["stream"] or occ["reserved"]
                      or occ["free"] + occ["prefix"] != occ["usable"]):
            fail(f"generate_prefix: {name}: blocks left behind after the "
                 f"drain: {occ}")
    result = {"phase": "generate_prefix", "streams": PREFIX_STREAMS,
              "prefix_len": PREFIX_LEN, "suffix_len": PREFIX_SUFFIX,
              "budget": PREFIX_BUDGET, "requests": PREFIX_REQUESTS,
              "runs": runs, "seconds": {"serve": t1 - t0, "judge": t2 - t1}}
    emit(result)
    return result


# stream_context: bench.py's 32 jobs by budget, longest first: 8 timed
# streams, 8 cancelled on their CANCEL_AT-th token, 16 plain. One ring fetch
# per dispatch (dispatch_depth 2 in flight), so a token reaches its callback
# while its stream still holds its slot; the default stride of 4 delivers a
# stream's first tokens after its last one was dispatched. The timed
# streams' wire timeout is TRIP_DISPATCHES dispatches at this run's pace,
# measured over the cancelled streams' median time to first token. A timed stream decodes from its last prompt chunk
# (dispatch 1 with the warm cache, at most 4 for a 63-token prompt) to
# dispatch ceil((prompt + budget) / 16) >= 7 after its admission, so the
# deadline passes mid-decode, while it holds its slot.
CTX_TIMED, CTX_CANCELLED, CANCEL_AT, TRIP_DISPATCHES = 8, 8, 4, 4.5


def _trace_engine(engine) -> dict:
    """Record, on the engine thread, the dispatch count after every round
    (with its time) and, for every request its sweep takes out of a slot,
    the dispatch count then and the request's outcome, keyed by the
    request's tenant label (one per stream here)."""
    log = {"rounds": [], "released": {}}
    sweep, dispatch = engine._reap_slots, engine._dispatch

    def traced_sweep():
        held = [s.req for s in engine._slots if s.req is not None]
        was_open = {id(r): not r.finished for r in held}
        sweep()
        still = {id(s.req) for s in engine._slots if s.req is not None}
        for req in held:
            if id(req) not in still:
                log["released"][req.tenant] = {
                    "dispatches": engine._chunks_dispatched,
                    "outcome": req.outcome,
                    "closed_by_sweep": was_open[id(req)]}

    def traced_dispatch():
        out = dispatch()
        log["rounds"].append((time.monotonic_ns(),
                              engine._chunks_dispatched))
        return out

    engine._reap_slots = traced_sweep
    engine._dispatch = traced_dispatch
    return log


def _serve_stream_context(label: str, cfg, params, jobs: list,
                          warm: bool = False, **engine_kw) -> dict:
    """Serve bench.py's jobs through TorchInferenceServer.infer with a
    response callback, carrying the streaming context: the longest
    CTX_TIMED with a wire timeout, the next CTX_CANCELLED with a cancel
    Event their callback sets on their CANCEL_AT-th token, the rest plain.
    The cancelled streams go first; once all of them have a first token,
    the timed streams go with a timeout of TRIP_DISPATCHES dispatches at
    the engine's pace during that TTFT, then the plain ones. Checks every
    stream's ending and the engine's counters, slots, pins and pool after
    the drain; the greedy streams (partial ones included) go to
    ``_judge_greedy``. With ``warm`` every prompt is served
    once with a budget of 1 first, so the prefix cache heads each later
    stream's table with its own committed blocks."""
    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import TorchInferenceServer

    order = sorted(range(len(jobs)), key=lambda i: -jobs[i][1])
    timed = order[:CTX_TIMED]
    cancelled = order[CTX_TIMED:CTX_TIMED + CTX_CANCELLED]
    plain = order[CTX_TIMED + CTX_CANCELLED:]
    model = make_continuous_generator(
        "continuous_lm", cfg=cfg, params=params, n_slots=GEN_SLOTS,
        chunk_size=GEN_CHUNK, dispatch_depth=2, fetch_stride=1,
        max_new_tokens=128, eos_id=-1, device="cuda", **engine_kw)
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    engine = model.engine
    n = len(jobs)
    streams = [[] for _ in range(n)]
    errors = [[] for _ in range(n)]
    finals = [0] * n
    after_error = [0] * n
    sent = [0.0] * n
    first = [0.0] * n
    last = [0.0] * n
    requests = [None] * n
    events = {i: threading.Event() for i in cancelled}
    problems: list = []

    def one(i, timeout_us=0):
        prompt, budget = jobs[i]
        req = _stream_request(prompt, budget, None)
        req.tenant_id = f"job{i}"
        req.timeout_us = timeout_us
        req.cancel_event = events.get(i)
        requests[i] = req

        def cb(resp, final):
            if resp.error is not None:
                errors[i].append(resp.error_status)
                if not final:
                    problems.append(f"job {i}: an error without the final "
                                    f"flag")
                return
            if final:
                finals[i] += 1
            else:
                if errors[i] or finals[i]:
                    after_error[i] += 1
                streams[i].append(int(resp.output("TOKEN").data[0]))
                if len(streams[i]) == 1:
                    first[i] = time.monotonic_ns()
                if len(streams[i]) == CANCEL_AT and i in events:
                    events[i].set()
            last[i] = time.monotonic_ns()

        sent[i] = time.monotonic_ns()
        try:
            core.infer(req, response_callback=cb)
        except Exception as e:  # noqa: BLE001 — failed below
            problems.append(f"job {i}: {type(e).__name__}: {e}")

    def start(idx, **kw):
        ths = [threading.Thread(target=one, args=(i,), kwargs=kw)
               for i in idx]
        for th in ths:
            th.start()
        return ths

    try:
        if warm:
            ths = [threading.Thread(
                target=lambda p=p: list(engine.submit(p, 1)))
                for p, _ in jobs]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
        log = _trace_engine(engine)
        before = engine.stats()
        snap0 = engine.gen_stats.snapshot()
        # the main path: counter at 0 just before, read just after
        pa.launches = 0
        t0 = time.time()
        threads = start(cancelled)
        deadline = time.time() + 300
        while not all(first[i] for i in cancelled) \
                and time.time() < deadline:
            time.sleep(0.002)
        if not all(first[i] for i in cancelled):
            fail(f"{label}: a cancelled stream had no first token")
        ttft_ns = float(np.median([first[i] - sent[i] for i in cancelled]))
        t_sent = min(sent[i] for i in cancelled)
        window = [ns for ns, _ in log["rounds"]
                  if t_sent <= ns <= t_sent + ttft_ns]
        # the pace: the median interval between the rounds inside the
        # TTFT (from the send to the first round's end the idle engine's
        # admissions ride along, and the TTFT also holds the fetch wait,
        # so neither measures a round), or the TTFT when it holds one
        # round only
        dispatch_ns = (float(np.median(np.diff(window))) if len(window) > 1
                       else ttft_ns)
        timeout_us = int(TRIP_DISPATCHES * dispatch_ns / 1e3)
        t_plain = time.monotonic_ns()
        threads += start(timed, timeout_us=timeout_us)
        threads += start(plain)
        for th in threads:
            th.join(timeout=600)
        wall_s = time.time() - t0
        k2 = pa.launches
        settle = time.time() + 60
        while (engine.active_slots()
               or engine._requests_accepted != engine._requests_closed) \
                and time.time() < settle:
            time.sleep(0.005)
        after = engine.stats()
        snap = engine.gen_stats.snapshot()
        index = engine._prefix_index
        kv = engine._kv_index if engine._paged else None
        drained = {
            "slots_active": engine.active_slots(),
            "accepted": engine._requests_accepted,
            "closed": engine._requests_closed,
            "pinned_nodes": None if index is None else index.pinned_nodes(),
            "occupancy": None if kv is None else kv.occupancy()}
    finally:
        core.stop()
    if problems or any(th.is_alive() for th in threads):
        fail(f"{label}: {problems[:3]}")
    base = before["chunks_dispatched"]
    chunks = after["chunks_dispatched"] - base

    def dispatches_at(t_ns):
        return max([d for ns, d in log["rounds"] if ns <= t_ns],
                   default=base) - base

    misses = []
    trips = []
    for i in timed:
        budget = len(streams[i]), jobs[i][1]
        if errors[i] == [504] and not finals[i] and not after_error[i]:
            ending = "deadline"
        elif not errors[i] and finals[i] == 1 and budget[0] == budget[1]:
            ending = "completed"
        else:
            ending = "bad"
            misses.append(f"timed job {i}: errors {errors[i]}, {finals[i]} "
                          f"final flags, {budget[0]} of {budget[1]} tokens, "
                          f"{after_error[i]} after the error")
        trip = {"job": i, "ending": ending, "tokens": budget[0],
                "budget": budget[1],
                "dispatches_at_arrival": dispatches_at(
                    requests[i].arrival_ns)}
        if ending == "deadline":
            rel = log["released"].get(f"job{i}")
            trip.update({
                "dispatches_at_trip": dispatches_at(
                    requests[i].arrival_ns + timeout_us * 1000),
                # None: the slot was freed at dispatch time, every token
                # left already in flight, before the deadline passed
                "dispatches_at_release": None if rel is None
                else rel["dispatches"] - base,
                "held_slot_at_trip": rel is not None
                and rel["outcome"] == "deadline",
                "tripped_by": None if rel is None
                else ("engine_sweep" if rel["closed_by_sweep"]
                      else "consumer")})
        trips.append(trip)
    for i in cancelled:
        if errors[i] != [499] or finals[i] or after_error[i] \
                or len(streams[i]) < CANCEL_AT:
            misses.append(f"cancelled job {i}: errors {errors[i]}, "
                          f"{finals[i]} final flags, {len(streams[i])} "
                          f"tokens, {after_error[i]} after the 499")
    for i in plain:
        if errors[i] or finals[i] != 1 or len(streams[i]) != jobs[i][1]:
            misses.append(f"plain job {i}: errors {errors[i]}, {finals[i]} "
                          f"final flags, {len(streams[i])} of {jobs[i][1]} "
                          f"tokens")
    n504 = sum(errors[i] == [504] for i in timed)
    counted = {k: snap[k] - snap0[k] for k in ("deadline_expired",
                                               "cancelled")}
    if counted != {"deadline_expired": n504, "cancelled": len(cancelled)}:
        misses.append(f"the engine counted {counted}, the streams saw {n504} "
                      f"504s and {len(cancelled)} 499s")
    in_slot = sum(t.get("held_slot_at_trip", False) for t in trips)
    if in_slot < CTX_TIMED // 2:
        misses.append(f"only {in_slot} of {CTX_TIMED} timed streams held "
                      f"their slot when their deadline passed")
    occ = drained["occupancy"]
    if drained["slots_active"] or drained["accepted"] != drained["closed"] \
            or drained["pinned_nodes"] \
            or (occ is not None and (occ["stream"] or occ["reserved"]
                                     or occ["free"] + occ["prefix"]
                                     != occ["usable"])):
        misses.append(f"not drained: {drained}")
    plain_tokens = sum(jobs[i][1] for i in plain)
    plain_s = (max(last[i] for i in plain) - t_plain) / 1e9
    result = {
        "run": label, "kv_layout": after["kv_layout"],
        "attn_impl": cfg.attn_impl, "jobs": n, "wall_s": wall_s,
        "ttft_cancelled_median_ms": ttft_ns / 1e6,
        "ttft_dispatches": len(window),
        "dispatch_ms_in_ttft": dispatch_ns / 1e6, "timeout_us": timeout_us,
        "chunk_dispatches": chunks,
        "paged_decode_attention_launches": k2,
        "trips": trips, "trips_holding_a_slot": in_slot,
        "trips_by_engine_sweep": sum(t.get("tripped_by") == "engine_sweep"
                                     for t in trips),
        "cancelled_tokens": [len(streams[i]) for i in cancelled],
        "deadline_expired": counted["deadline_expired"],
        "cancelled": counted["cancelled"],
        "plain_tokens": plain_tokens, "plain_s": plain_s,
        "plain_tokens_per_s": plain_tokens / plain_s,
        "prefix_hits": snap["prefix_hits"] - snap0["prefix_hits"],
        "drained": drained}
    if misses:
        fail(f"{label}: {misses}; {json.dumps(result)}")
    # every stream's delivered tokens, partial ones too
    result["greedy_streams"] = [
        (np.concatenate([jobs[i][0], streams[i]]), len(jobs[i][0]))
        for i in range(n) if streams[i]]
    return result


def phase_stream_context(gen_model: tuple) -> dict:
    """The streaming context at bench.py's generation width: wire
    deadlines, cancel Events and SLO labels through the core into the
    engine, on the paged layout with the prefix cache (K2 on tables headed
    by shared blocks) and on the default slot layout."""
    import dataclasses

    cfg, params, jobs = gen_model
    flash = dataclasses.replace(cfg, attn_impl="flash")
    t0 = time.time()
    runs = [
        _serve_stream_context("stream_context_paged", flash, params, jobs,
                              warm=True, kv_layout="paged",
                              kv_block_len=GEN_BLOCK, prefix_cache=True,
                              prefix_block_len=GEN_BLOCK),
        _serve_stream_context("stream_context_slot", cfg, params, jobs)]
    t1 = time.time()
    _judge_greedy(cfg, params, runs)
    paged, slot = runs
    want = LAYERS * GEN_CHUNK * paged["chunk_dispatches"]
    if paged["paged_decode_attention_launches"] != want \
            or slot["paged_decode_attention_launches"]:
        fail(f"stream_context: paged_decode_attention launched "
             f"{paged['paged_decode_attention_launches']} times in the paged "
             f"run (expected {want}) and "
             f"{slot['paged_decode_attention_launches']} in the slot run "
             f"(expected 0)")
    if not paged["prefix_hits"]:
        fail("stream_context: the paged run's tables had no shared block")
    result = {"phase": "stream_context", "runs": runs,
              "seconds": {"serve": t1 - t0, "judge": time.time() - t1}}
    emit(result)
    return result


# speculate: the reference speculative A/B's settings
# (benchmarks/bench_generation_grpc.py: gamma 12, the draft keeps the
# target's first layer, wo and w2 of the later layers damped by 0.005,
# batched prefill admission)
SPEC_GAMMA, SPEC_DRAFT_LAYERS, SPEC_DAMP = 12, 1, 0.005
# run 4 (adversarial draft, ladder, floor 0.5) takes the first 8 jobs
SPEC_FLOOR_JOBS, SPEC_FLOOR = 8, 0.5


def _high_agreement_pair(cfg, params) -> tuple:
    """The reference A/B's synthetic high-agreement pair
    (make_high_agreement_pair): the target's wo and w2 of every layer past
    the draft's depth scaled by SPEC_DAMP, so the target's forward nearly
    equals its first SPEC_DRAFT_LAYERS layers; the draft is those layers
    with the target's embeddings and norm. Returns (target params,
    DraftModel)."""
    import dataclasses

    from client_tpu_torch.server.speculation import DraftModel

    k = SPEC_DRAFT_LAYERS
    layers = dict(params["layers"])
    for name in ("wo", "w2"):
        w = layers[name].clone()
        w[k:] *= SPEC_DAMP
        layers[name] = w
    target = dict(params, layers=layers)
    dparams = {"embed": target["embed"], "final_norm": target["final_norm"],
               "pos_embed": target["pos_embed"],
               "layers": {name: w[:k] for name, w in layers.items()}}
    return target, DraftModel(dataclasses.replace(cfg, n_layers=k), dparams)


def _spec_settled(engine) -> dict:
    """Slots and, on the paged layout, the pool once the engine thread has
    freed the last slot."""
    deadline = time.time() + 30
    while engine.active_slots() and time.time() < deadline:
        time.sleep(0.01)
    return {"slots_active_after": engine.active_slots(),
            "occupancy": (engine._kv_index.occupancy()
                          if engine._paged else None)}


def _spec_round_profile(cfg, params, draft, paged: bool = False) -> dict:
    """One greedy gamma-12 verify round outside the engine, at full width
    (16 slots mid-context): on the slot layout with every slot in the
    round, or with ``paged`` on the paged layout (tables of 12 blocks)
    with every other slot in the round, so the verify also runs the 8
    slots outside it into the scratch block (ROADMAP C8). Its host time,
    its stream time between CUDA events, and by torch.profiler its device
    busy time and kernel launches, as _dispatch_profile takes a chunk's."""
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.models.transformer import init_decode_state
    from client_tpu_torch.server.generation import (
        paged_spec_round,
        spec_round,
    )
    from client_tpu_torch.server.kv_cache import init_paged_pool

    s, dev = GEN_SLOTS, "cuda"
    nb = GEN_MAX_SEQ // GEN_BLOCK
    if paged:
        pool = init_paged_pool(cfg, GEN_POOL, GEN_BLOCK, dev)
        tables = (1 + torch.arange(s * nb, device=dev)).reshape(s, nb).to(
            torch.int32)
        rows = torch.arange(0, s, 2, device=dev)
    else:
        cache = init_decode_state(cfg, s, dev)
    dstate = init_decode_state(draft.cfg, s, dev)
    dcache = {"k": dstate["k"], "v": dstate["v"]}
    pos = torch.full((s,), 96, dtype=torch.int32, device=dev)
    last = torch.randint(0, cfg.vocab_size, (s,), dtype=torch.int32,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    zi = torch.zeros((s,), dtype=torch.int32, device=dev)
    zf = torch.zeros((s,), device=dev)
    ring = torch.zeros((4, s, GEN_CHUNK), dtype=torch.int32, device=dev)
    cnt = torch.zeros((4, s), dtype=torch.int32, device=dev)

    def round_():
        if paged:
            n = rows.shape[0]
            return paged_spec_round(
                cfg, draft.cfg, params, draft.params, pool, pos, dcache,
                pos.clone(), last, ring, cnt, 0, tables, rows,
                (zi[:n], zf[:n], zi[:n], zf[:n]), SPEC_GAMMA, False)
        return spec_round(cfg, draft.cfg, params, draft.params, cache, pos,
                          dcache, pos.clone(), last, ring, cnt, 0, None,
                          (zi, zf, zi, zf), SPEC_GAMMA, False)

    with torch.inference_mode():
        round_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        round_()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            round_()
            torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    for evt in prof.key_averages():
        busy_us += getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0))
        if evt.key.startswith("cudaLaunchKernel"):
            launches += evt.count
    return {"layout": "paged" if paged else "slot",
            "slots_in_round": s // 2 if paged else s,
            "gamma": SPEC_GAMMA, "host_ms": host_ms,
            "event_ms": event_ms,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "kernel_launches": launches}


class _RecordingSpeculation:
    """Collects every stream's RequestSpeculation the engine makes (the
    floor run checks each stream's latch after the streams are gone)."""

    def __init__(self):
        from client_tpu_torch.server import generation, speculation

        self.made: list = []
        self._module = generation
        made = self.made

        class Recorded(speculation.RequestSpeculation):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        self._cls = Recorded

    def __enter__(self):
        self._orig = self._module.RequestSpeculation
        self._module.RequestSpeculation = self._cls
        return self.made

    def __exit__(self, *exc):
        self._module.RequestSpeculation = self._orig


def phase_speculate(gen_model: tuple) -> dict:
    """Speculative decoding at bench.py's generation width with the
    reference A/B's high-agreement draft: the plain arm, gamma 12 on the
    slot layout (a quarter of the streams sampled) and on the paged layout
    (K2 on its chunk dispatches), and an adversarial draft under the
    ladder and the acceptance floor."""
    import dataclasses

    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.server.speculation import (
        FALLBACK_WARMUP_ROUNDS,
        DraftModel,
    )

    cfg, params, jobs = gen_model
    target, draft = _high_agreement_pair(cfg, params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    adversarial = DraftModel(draft.cfg, t.init_params(gen, draft.cfg))
    flash = dataclasses.replace(cfg, attn_impl="flash")
    greedy = [None] * len(jobs)
    sampled = [(0.8, 40, 2000 + i) if i % 4 == 3 else None
               for i in range(len(jobs))]
    spec = dict(speculative_draft=draft, speculative_gamma=SPEC_GAMMA)
    cut = jobs[:SPEC_FLOOR_JOBS]
    plan = [
        # the plain arm serves the same target weights without a draft
        ("spec_off", cfg, jobs, greedy, dict(prefill_mode="batched")),
        ("spec_slot", cfg, jobs, sampled,
         dict(prefill_mode="batched", **spec)),
        # batched admission is refused on the paged layout: prompts feed
        # through the chunk kernel, K2 included
        ("spec_paged", flash, jobs, greedy,
         dict(kv_layout="paged", kv_block_len=GEN_BLOCK, **spec)),
        ("spec_ladder_floor", cfg, cut, greedy[:len(cut)],
         dict(prefill_mode="batched", speculative_draft=adversarial,
              speculative_gamma=SPEC_GAMMA, speculative_gamma_ladder=True,
              speculative_min_acceptance=SPEC_FLOOR)),
        # a diagnostic beside spec_slot: one fetch per dispatch, so a
        # round's real advance corrects pos_hi sooner (fewer rounds past a
        # stream's end, fewer streams latched at the max_seq edge)
        ("spec_slot_stride1", cfg, jobs, sampled,
         dict(prefill_mode="batched", fetch_stride=1, **spec))]
    t0 = time.time()
    runs, records = [], []
    for label, run_cfg, run_jobs, sampling, kw in plan:
        with _RecordingSpeculation() as made:
            run = _serve_generation(label, run_cfg, target, run_jobs,
                                    sampling, settled=_spec_settled, **kw)
        # every stream's record, the warmup stream's included
        run["latched_streams"] = sum(r.fallback for r in made)
        runs.append(run)
        records.append(made)
    streams = records[3]
    t1 = time.time()
    _judge_greedy(cfg, target, runs)
    t2 = time.time()
    off, slot, paged, floor = runs[:4]
    for run in runs:
        name = run["run"]
        want = (LAYERS * GEN_CHUNK * run["chunk_dispatches"]
                if run["kv_layout"] == "paged" else 0)
        if run["paged_decode_attention_launches"] != want \
                or run["flash_attention_launches"]:
            fail(f"speculate: the {name} run launched paged_decode_attention "
                 f"{run['paged_decode_attention_launches']} times in "
                 f"{run['chunk_dispatches']} chunk dispatches (expected "
                 f"{want}) and flash_attention "
                 f"{run['flash_attention_launches']} times (expected 0)")
        if run["slots_active_after"]:
            fail(f"speculate: {name}: {run['slots_active_after']} slots "
                 f"still held after the drain")
        occ = run["occupancy"]
        if occ is not None and (occ["stream"] or occ["reserved"]
                                or occ["free"] != occ["usable"]):
            fail(f"speculate: {name}: blocks left behind: {occ}")
        sp = run["speculation"]
        if name == "spec_off":
            if sp is not None:
                fail("speculate: the plain arm speculated")
            continue
        if not sp or sp["rounds"] <= 0 or sp["accepted"] > sp["proposed"]:
            fail(f"speculate: {name}: speculation counters {sp}")
    for run in (slot, paged, runs[4]):
        sp = run["speculation"]
        if sp["tokens_per_round"] <= 1.0 \
                or sp["acceptance"] <= floor["speculation"]["acceptance"]:
            fail(f"speculate: {run['run']}: {sp['tokens_per_round']} tokens "
                 f"per round at acceptance {sp['acceptance']}, against the "
                 f"adversarial run's {floor['speculation']['acceptance']}")
    warm = [r for r in streams if r.rounds >= FALLBACK_WARMUP_ROUNDS]
    latched = sum(r.fallback for r in warm)
    # the cut's streams and the warmup's
    if len(streams) != len(cut) + 1 or not warm or latched != len(warm):
        fail(f"speculate: spec_ladder_floor: {latched} of {len(warm)} "
             f"streams with {FALLBACK_WARMUP_ROUNDS}+ rounds latched to "
             f"plain decode ({len(streams)} streams recorded)")
    floor["floor_latch"] = {"streams": len(streams),
                            "warm_streams": len(warm), "latched": latched,
                            "rounds": [r.rounds for r in streams]}
    for run in runs:
        run["tokens_per_s_vs_spec_off"] = (
            run["continuous_batching_ragged_tokens_per_s"]
            / off["continuous_batching_ragged_tokens_per_s"])
    profile = _spec_round_profile(cfg, target, draft)
    paged_profile = _spec_round_profile(flash, target, draft, paged=True)
    result = {"phase": "speculate", "gamma": SPEC_GAMMA,
              "draft_layers": SPEC_DRAFT_LAYERS, "damp": SPEC_DAMP,
              "runs": runs, "standalone_round": profile,
              "standalone_paged_round": paged_profile,
              # the paged run's verify rounds run all 16 rows (C8)
              "spec_paged_host_ms_per_verify_dispatch":
                  paged["host_ms_per_dispatch_by_kind"].get("spec"),
              "seconds": {"serve": t1 - t0, "judge": t2 - t1,
                          "profile": time.time() - t2}}
    emit(result)
    return result


# schedule: bench.py's 32 jobs as bronze and 8 gold arrivals (prompts
# 8-63, budgets 16-127, from another seed) once every slot is held; gold
# weighs 4, bronze 1, preemption on weight alone (threshold 0)
SCHED_GOLD_JOBS, SCHED_GOLD_SEED = 8, 11
SCHEDULER = {"class_weights": {"gold": 4.0, "bronze": 1.0},
             "preemption": True, "preempt_burn_threshold": 0.0}
SLO_CLASSES = [{"name": "gold", "ttft_ms": 2000.0},
               {"name": "bronze", "ttft_ms": 10000.0}]
# tier_paged: three shared-prefix families (prefix 128, suffix 32, budget
# 32, 4 streams per wave) cycled A B C A B A through a pool that holds the
# 4 active streams' worst case (4 x 12 blocks) and 1.5 families of
# committed blocks (a family commits 8 prefix + 4 x 2 suffix blocks),
# beside the scratch block; the host tier holds 64 MiB (113 blocks)
TIER_PREFIX, TIER_SUFFIX, TIER_BUDGET, TIER_WAVE = 128, 32, 32, 4
TIER_CYCLE = "ABCABA"
TIER_POOL = TIER_WAVE * GEN_MAX_SEQ // GEN_BLOCK + 24 + 1
TIER_BYTES = 64 << 20
# controller: an objective no gold stream meets, a short window, and a
# baseline duty below the 1.0 latency mode sets
CTL_WINDOW_S, CTL_BASE_DUTY = 2.0, 0.8


class _ResumeProbe:
    """Wraps an engine's preemption and prefix acquire: each preemption
    records the match its resume must get (the full blocks of the rows it
    committed, capped one token short of the extended prompt), and each
    resume's acquire records what it got. A victim whose extended prompt
    fits in one block resumes without a lookup (the engine never matches
    a sub-block prompt): its resume is recorded at the preemption as
    matching the nothing it must match."""

    def __init__(self):
        self.expected: dict = {}
        self.resumes: list = []   # (expected, matched) tokens

    def __call__(self, engine):
        bl = engine._prefix_block_len
        preempt, acquire = engine._preempt_slot, engine._acquire_prefix

        def preempt_slot(idx):
            slot = engine._slots[idx]
            req = slot.req
            ext = len(req.prompt) + len(req.gen_tokens or ())
            want = min(min(slot.pos_hi, ext) // bl, (ext - 1) // bl) * bl
            preempt(idx)
            if ext <= bl:
                self.resumes.append((0, 0))
            else:
                self.expected[id(req.prompt)] = want

        def acquire_prefix(tokens):
            handle = acquire(tokens)
            want = self.expected.pop(id(tokens), None)
            if want is not None:
                self.resumes.append(
                    (want, 0 if handle is None else handle.matched_tokens))
            return handle

        engine._preempt_slot = preempt_slot
        engine._acquire_prefix = acquire_prefix


class _ControllerProbe:
    """Stands in for an engine's EngineController (whose slots forbid
    wrapping a method): steps it, and records the fetch stride and duty
    the engine reads in every round the controller is in latency mode."""

    def __init__(self, ctl):
        self.ctl = ctl
        self.latency_reads: list = []

    def step(self, engine, burn):
        self.ctl.step(engine, burn)
        if self.ctl.latency_mode:
            self.latency_reads.append((engine.fetch_stride,
                                       engine.dispatch_duty))

    def __getattr__(self, name):
        return getattr(self.ctl, name)


def _sched_settled(engine) -> dict:
    """``_prefix_settled`` with the host tier, the scheduler and the SLO
    statistics."""
    snap = engine.gen_stats.snapshot()
    return {**_prefix_settled(engine),
            "kv_tier": engine.stats()["kv_tier"],
            "scheduler": engine.scheduler_snapshot(),
            "slo": engine.slo_snapshot(),
            "preemptions": snap["preemptions"], "resumes": snap["resumes"],
            "tier_hits": snap["tier_hits"]}


def _drained(run: dict, name: str) -> None:
    """No slot, pin, stream block or reservation may be left."""
    occ = run["occupancy"]
    if run["slots_active_after"] or run["pinned_nodes"] or (
            occ is not None and (occ["reserved"] or occ["stream"])):
        fail(f"schedule: {name}: left behind: slots "
             f"{run['slots_active_after']}, pins {run['pinned_nodes']}, "
             f"{occ}")


def _tier_jobs(vocab: int) -> list:
    """The tier cycle's jobs, wave after wave: each family's prefix and
    its 4 streams' suffixes from seed 5."""
    rng = np.random.default_rng(5)
    fams = {f: (rng.integers(0, vocab, TIER_PREFIX),
                [rng.integers(0, vocab, TIER_SUFFIX)
                 for _ in range(TIER_WAVE)]) for f in "ABC"}
    return [(np.concatenate([fams[f][0], suffix]).astype(np.int32),
             TIER_BUDGET) for f in TIER_CYCLE for suffix in fams[f][1]]


def _tier_mover_ms(cfg) -> dict:
    """One spill and one restore of a block of the engine's paged pool,
    outside the engine: ms per move between CUDA events (the spill's until
    its event), over 20 moves each, and the rate for one block's bytes."""
    from client_tpu_torch.server.kv_cache import (
        init_paged_pool,
        pool_block_nbytes,
        tier_restore,
        tier_spill,
    )

    pool = init_paged_pool(cfg, TIER_POOL, GEN_BLOCK, "cuda")
    for p in pool.values():
        p.normal_()
    nbytes = pool_block_nbytes(pool, True)
    rows, ready = tier_spill(pool, 3, True)
    ready.synchronize()
    out = {"block_bytes": nbytes}
    for name, fn in (("spill", lambda: tier_spill(pool, 3, True)[1]),
                     ("restore", lambda: tier_restore(pool, 4, rows, True))):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        out[f"{name}_device_ms"] = ms
        out[f"{name}_gb_per_s"] = nbytes / (ms * 1e-3) / 1e9
    return out


def phase_schedule(gen_model: tuple) -> dict:
    """The closed-loop SLO scheduler and the host tier at bench.py's
    generation width: preemption on both layouts (schedule_paged with K2,
    schedule_slot), the host tier on the paged layout with the chunked
    lane (tier_paged, a tier-less run and a one-block tier beside it), the
    burn controller, and the duty's pacing."""
    import dataclasses

    from client_tpu_torch.perf.bench_harness import ragged_generation_jobs

    cfg, params, jobs = gen_model
    flash = dataclasses.replace(cfg, attn_impl="flash")
    gold = ragged_generation_jobs(SCHED_GOLD_SEED, cfg.vocab_size,
                                  SCHED_GOLD_JOBS, (8, 64), (16, 128),
                                  cfg.max_seq)
    mixed = jobs + gold
    labels = ([("batch", "bronze")] * len(jobs)
              + [("vip", "gold")] * len(gold))
    greedy = [None] * len(mixed)

    def all_held(engine):
        return engine.active_slots() == GEN_SLOTS

    t0 = time.time()
    runs, probes = [], []
    for name, run_cfg, kw in (
            ("schedule_paged", flash, dict(kv_layout="paged",
                                           kv_block_len=GEN_BLOCK)),
            ("schedule_slot", cfg, dict())):
        probe = _ResumeProbe()
        run = _serve_generation(
            name, run_cfg, params, mixed, greedy, labels=labels,
            late=(len(jobs), all_held), settled=_sched_settled,
            instrument=probe, prefix_cache=True, prefix_block_len=GEN_BLOCK,
            scheduler=SCHEDULER, slo_classes=SLO_CLASSES, **kw)
        ttft = run["client_ttft_ms"]
        run["ttft_mean_ms_by_class"] = {
            "bronze": float(np.mean(ttft[:len(jobs)])),
            "gold": float(np.mean(ttft[len(jobs):]))}
        hits = [m for w, m in probe.resumes if m == w]
        run["resumes_on_own_chain"] = len(hits)
        run["resume_saved_tokens"] = sum(hits)
        runs.append(run)
        probes.append(probe)
    tier_jobs = _tier_jobs(cfg.vocab_size)
    tier_kw = dict(kv_layout="paged", kv_block_len=GEN_BLOCK,
                   kv_pool_blocks=TIER_POOL, prefix_cache=True,
                   prefix_block_len=GEN_BLOCK, prefill_mode="chunked",
                   prefill_chunk=64)
    for name, tier_bytes in (("tier_paged", TIER_BYTES),
                             ("tier_off", 0), ("tier_one_block", 1)):
        runs.append(_serve_generation(
            name, flash, params, tier_jobs, [None] * len(tier_jobs),
            n_threads=TIER_WAVE, settled=_sched_settled,
            host_tier_bytes=tier_bytes, **tier_kw))
    ctl_probe = []

    def probe_controller(engine):
        ctl_probe.append(_ControllerProbe(engine._controller))
        engine._controller = ctl_probe[0]

    # the gold jobs beside bench.py's 32: a first completion reaches the
    # host (stride 4, depth 2) while most streams still decode
    gold_greedy = [None] * len(gold)
    runs.append(_serve_generation(
        "controller", cfg, params, mixed, greedy, labels=labels,
        settled=_sched_settled, instrument=probe_controller,
        dispatch_duty=CTL_BASE_DUTY,
        slo_classes=[{"name": "gold", "ttft_ms": 1.0}],
        slo_window_s=CTL_WINDOW_S, scheduler={"controller": True}))
    for duty in (0.5, 1.0):
        runs.append(_serve_generation(
            f"duty_{duty}", cfg, params, gold, gold_greedy,
            settled=_sched_settled, dispatch_duty=duty))
    t1 = time.time()
    by = {run["run"]: run for run in runs}
    # restored rows are the spilled bits, recomputed ones may round
    # otherwise in bf16: counted, and both runs are judged
    by["tier_paged"]["streams_equal_to_tier_off"] = sum(
        np.array_equal(a, b) for (a, _), (b, _) in zip(
            by["tier_paged"]["greedy_streams"],
            by["tier_off"]["greedy_streams"]))
    _judge_greedy(cfg, params, runs)
    t2 = time.time()
    movers = _tier_mover_ms(cfg)
    for name, probe in zip(("schedule_paged", "schedule_slot"), probes):
        run = by[name]
        sched = run["scheduler"]
        if run["preemptions"] < 1 \
                or sched["preemptions_total"] != run["preemptions"] \
                or run["resumes"] != run["preemptions"] \
                or len(probe.resumes) != run["resumes"] \
                or run["resumes_on_own_chain"] != run["resumes"]:
            fail(f"schedule: {name}: {run['preemptions']} preemptions, "
                 f"{run['resumes']} resumes, matches (expected, got) "
                 f"{probe.resumes}")
    for name, run in by.items():
        _drained(run, name)
        paged = run["kv_layout"] == "paged"
        want = LAYERS * GEN_CHUNK * run["chunk_dispatches"] if paged else 0
        if run["paged_decode_attention_launches"] != want \
                or run["flash_attention_launches"]:
            fail(f"schedule: the {name} run launched paged_decode_attention "
                 f"{run['paged_decode_attention_launches']} times in "
                 f"{run['chunk_dispatches']} chunk dispatches (expected "
                 f"{want}) and flash_attention "
                 f"{run['flash_attention_launches']} times (expected 0)")
    tier, one = by["tier_paged"]["kv_tier"], by["tier_one_block"]["kv_tier"]
    if tier["spills"] < 1 or tier["restores"] < 1 \
            or by["tier_paged"]["tier_hits"] < 1 or one["dropped"] < 1 \
            or by["tier_off"]["kv_tier"] is not None:
        fail(f"schedule: tier: {tier}, one block: {one}")
    moves = tier["spills"] + tier["restores"]
    by["tier_paged"]["tier_host_ms_per_move"] = (
        by["tier_paged"]["phase_seconds"]["tier"] * 1e3 / moves)
    by["tier_paged"]["standalone_movers"] = movers
    ctl = ctl_probe[0]
    reads = ctl.latency_reads
    if ctl.flips < 1 or not reads or set(reads) != {(1, 1.0)}:
        fail(f"schedule: controller: {ctl.flips} flips, latency-mode reads "
             f"{sorted(set(reads))[:4]}")
    by["controller"]["controller"] = {
        "flips": ctl.flips, "exited": ctl.flips >= 2,
        "latency_rounds": len(reads)}
    if by["duty_0.5"]["phase_seconds"]["pace"] <= 0 \
            or by["duty_1.0"]["phase_seconds"]["pace"] != 0:
        fail("schedule: duty 0.5 did not pace, or duty 1.0 did")
    result = {"phase": "schedule", "runs": runs,
              "seconds": {"serve": t1 - t0, "judge": t2 - t1,
                          "movers": time.time() - t2}}
    emit(result)
    return result


# lanes: the dedicated prefill lane (4 lane slots of width 32, the chunked
# lane's prefill_chunk 64 as the round's budget; batched 4 rows per
# dispatch) and the int8 KV cache at bench.py's generation width. The slot
# layout's lane run and the int8 paged run take the first 16 of bench.py's
# 32 jobs (cut to keep the phase near a minute); the lane's handoff on the
# slot layout rides the prefix cache (policy all)
LANE_SLOTS, LANE_WIDTH, LANE_BATCH, LANE_CUT = 4, 32, 4, 16


class _CopyCount:
    """Counts the engine's pool<->slot copies (the module functions
    ``pool_to_slot`` / ``slot_to_pool`` its methods call) while active."""

    def __enter__(self):
        from client_tpu_torch.server import generation

        self._mod = generation
        self.n = {"pool_to_slot": 0, "slot_to_pool": 0}
        self._orig = {}
        for name in self.n:
            real = getattr(generation, name)
            self._orig[name] = real

            def counted(*a, _real=real, _name=name, **k):
                self.n[_name] += 1
                return _real(*a, **k)

            setattr(generation, name, counted)
        return self

    def __exit__(self, *exc):
        for name, real in self._orig.items():
            setattr(self._mod, name, real)


def _lane_settled(engine) -> dict:
    """``_prefix_settled`` once both slot kinds are free, with the lane's
    snapshot, the batched lane's counters, the paged pool's occupancy and
    the dispatches by kind."""
    deadline = time.time() + 30
    while (engine.active_slots() or engine.active_lane_slots()) \
            and time.time() < deadline:
        time.sleep(0.01)
    snap = engine.gen_stats.snapshot()
    index = engine._kv_index
    return {**_prefix_settled(engine),
            "lane_slots_active_after": engine.active_lane_slots(),
            "occupancy": None if index is None else index.occupancy(),
            "prefill_lane": engine.stats()["prefill_lane"],
            "lane_handoffs": snap["lane_handoffs"],
            "lane_batch_dispatches": snap["lane_batch_dispatches"],
            "lane_batch_slots": snap["lane_batch_slots"]}


def _kv_bytes(cfg) -> dict:
    """Bytes of the generation path's slot-layout state (16 slots) and
    paged pool (GEN_POOL blocks of 16) under ``cfg``."""
    from client_tpu_torch.models.transformer import init_decode_state
    from client_tpu_torch.server.kv_cache import init_paged_pool

    out = {}
    for name, tree in (("state", init_decode_state(cfg, GEN_SLOTS, "cuda")),
                       ("pool", init_paged_pool(cfg, GEN_POOL, GEN_BLOCK,
                                                "cuda"))):
        out[name] = sum(v.numel() * v.element_size()
                        for k, v in tree.items() if k != "pos")
        del tree
    return out


def _int8_tier_round_trip(cfg) -> dict:
    """One block of an int8 paged pool (random values and scales) through
    the host tier and back into another block: every tensor bit for
    bit."""
    from client_tpu_torch.server.kv_cache import (
        init_paged_pool,
        pool_block_nbytes,
        tier_restore,
        tier_spill,
    )

    pool = init_paged_pool(cfg, 8, GEN_BLOCK, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for name, arr in pool.items():
        if arr.dtype == torch.int8:
            arr.copy_(torch.randint(-127, 128, arr.shape, generator=gen,
                                    device="cuda", dtype=torch.int8))
        else:
            arr.uniform_(1e-3, 5e-2, generator=gen)
    rows, ready = tier_spill(pool, 3, True)
    ready.synchronize()
    tier_restore(pool, 5, rows, True)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(arr[:, 5], arr[:, 3]))
            for name, arr in pool.items()}
    if sorted(same) != ["k", "k_scale", "v", "v_scale"] \
            or not all(same.values()):
        fail(f"lanes: an int8 block's tier round trip changed it: {same}")
    return {"block_bytes": pool_block_nbytes(pool, True), "bit_exact": same}


def phase_lanes(gen_model: tuple, bench_point: dict) -> dict:
    """The dedicated prefill lanes and the int8 KV cache at bench.py's
    generation width: piggyback_paged (the comparison arm: the chunked
    lane riding the decode chunk), lane_paged (paged with K2, the lane per
    slot),
    lane_paged_batch (the same, 4 lane slots per dispatch), lane_slot (the
    slot layout, the handoff through the prefix pool), kv8_slot (bench.py's
    point under kv_quant, beside ``bench_point``, generate_slot's run from
    this call) and kv8_paged (paged, chunked, attn_impl flash under
    kv_quant: no K2 launch)."""
    import dataclasses

    cfg, params, jobs = gen_model
    flash = dataclasses.replace(cfg, attn_impl="flash")
    kv8 = dataclasses.replace(cfg, kv_quant=True)
    kv8_flash = dataclasses.replace(flash, kv_quant=True)
    lane = dict(prefill_mode="chunked", prefill_chunk=64,
                prefill_slots=LANE_SLOTS, prefill_lane_width=LANE_WIDTH)
    paged = dict(kv_layout="paged", kv_block_len=GEN_BLOCK)
    cut = jobs[:LANE_CUT]
    plan = [
        # the comparison arm: the piggyback chunked lane, same jobs
        ("piggyback_paged", flash, jobs, dict(prefill_mode="chunked",
                                              prefill_chunk=64, **paged)),
        ("lane_paged", flash, jobs, dict(**lane, **paged)),
        ("lane_paged_batch", flash, jobs,
         dict(**lane, **paged, prefill_lane_batch=LANE_BATCH)),
        ("lane_slot", cfg, cut, dict(**lane, prefix_cache=True,
                                     prefix_block_len=GEN_BLOCK,
                                     prefix_commit_policy="all")),
        ("kv8_slot", kv8, jobs, dict()),
        ("kv8_paged", kv8_flash, cut, dict(**paged, prefill_mode="chunked",
                                           prefill_chunk=64))]
    t0 = time.time()
    runs = []
    for label, run_cfg, run_jobs, kw in plan:
        with _CopyCount() as copies:
            run = _serve_generation(label, run_cfg, params, run_jobs,
                                    [None] * len(run_jobs),
                                    settled=_lane_settled, **kw)
        run["pool_slot_copies"] = dict(copies.n)
        run["long_prompt_jobs"] = sum(len(p) > GEN_CHUNK
                                      for p, _ in run_jobs)
        runs.append(run)
    t1 = time.time()
    _judge_greedy(cfg, params, runs[:4])
    _judge_greedy(kv8, params, runs[4:])
    t2 = time.time()
    by = {run["run"]: run for run in runs}
    for run in runs:
        name, occ = run["run"], run["occupancy"]
        want = (LAYERS * GEN_CHUNK * run["chunk_dispatches"]
                if run["kv_layout"] == "paged" and not name.startswith("kv8")
                else 0)
        if run["paged_decode_attention_launches"] != want \
                or run["flash_attention_launches"]:
            fail(f"lanes: the {name} run launched paged_decode_attention "
                 f"{run['paged_decode_attention_launches']} times in "
                 f"{run['chunk_dispatches']} chunk dispatches (expected "
                 f"{want}) and flash_attention "
                 f"{run['flash_attention_launches']} times (expected 0)")
        if run["slots_active_after"] or run["lane_slots_active_after"] \
                or run["pinned_nodes"] or (occ is not None and (
                    occ["stream"] or occ["reserved"])):
            fail(f"lanes: {name}: left behind: slots "
                 f"{run['slots_active_after']}, lane slots "
                 f"{run['lane_slots_active_after']}, pins "
                 f"{run['pinned_nodes']}, {occ}")
        if name.startswith("lane"):
            if run["lane_handoffs"] != run["long_prompt_jobs"] \
                    or run["prefill_lane"]["handoffs"] \
                    != run["lane_handoffs"]:
                fail(f"lanes: {name}: {run['lane_handoffs']} handoffs for "
                     f"{run['long_prompt_jobs']} prompts longer than a "
                     f"chunk")
    for name in ("lane_paged", "lane_paged_batch"):
        if any(by[name]["pool_slot_copies"].values()):
            fail(f"lanes: {name}: the paged handoff copied KV: "
                 f"{by[name]['pool_slot_copies']}")
    batch = by["lane_paged_batch"]
    if batch["lane_batch_dispatches"] < 1:
        fail("lanes: lane_paged_batch dispatched no batched lane chunk")
    batch["lane_batch_slots_per_dispatch"] = (
        batch["lane_batch_slots"] / batch["lane_batch_dispatches"])
    if by["lane_slot"]["pool_slot_copies"]["slot_to_pool"] \
            < by["lane_slot"]["lane_handoffs"]:
        fail(f"lanes: lane_slot: {by['lane_slot']['pool_slot_copies']} "
             f"copies for {by['lane_slot']['lane_handoffs']} handoffs")
    rate = "continuous_batching_ragged_tokens_per_s"
    for name in ("lane_paged", "lane_paged_batch"):
        by[name]["tokens_per_s_vs_piggyback"] = (
            by[name][rate] / by["piggyback_paged"][rate])
    by["kv8_slot"]["tokens_per_s_vs_bench_point"] = (
        by["kv8_slot"][rate] / bench_point[rate])
    kv_bytes = {"bf16": _kv_bytes(cfg), "int8": _kv_bytes(kv8)}
    kv_bytes["int8_share"] = {k: kv_bytes["int8"][k] / kv_bytes["bf16"][k]
                              for k in ("state", "pool")}
    tier = _int8_tier_round_trip(kv8)
    result = {"phase": "lanes", "lane_slots": LANE_SLOTS,
              "lane_width": LANE_WIDTH, "lane_batch": LANE_BATCH,
              "cut_jobs": LANE_CUT, "runs": runs, "kv_bytes": kv_bytes,
              "int8_tier_round_trip": tier,
              "seconds": {"serve": t1 - t0, "judge": t2 - t1,
                          "bytes_and_tier": time.time() - t2}}
    emit(result)
    return result


OBSERVE_SPANS = ["REQUEST_START", "QUEUE_START", "COMPUTE_START",
                 "COMPUTE_INPUT_END", "COMPUTE_OUTPUT_START", "REQUEST_END"]
SCRAPE_EVERY_S = 0.25


def _get(url: str) -> tuple:
    """(status, body) of one GET, a 4xx/5xx included."""
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _read_traces(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _observe_encoder(trace_dir: str) -> dict:
    """The encoder over HTTP (``_encoder_over_http``) with every request
    traced to a file: one trace per request, each with its spans in
    serving order."""
    trace_file = os.path.join(trace_dir, "encoder.jsonl")
    run = _encoder_over_http("observe", 1, trace_file)
    traces = _read_traces(trace_file)
    if len(traces) != N_REQUESTS:
        fail(f"observe: {len(traces)} encoder traces for {N_REQUESTS} "
             f"requests")
    for tr in traces:
        names = [s["name"] for s in tr["timestamps"]]
        stamps = [s["ns"] for s in tr["timestamps"]]
        if names != OBSERVE_SPANS or stamps != sorted(stamps):
            fail(f"observe: encoder trace {tr['id']} spans {names}")
    return {"requests": N_REQUESTS, "batches": run["batches"],
            "flash_attention_launches": run["flash_attention_launches"],
            "embedding_max_abs_err_vs_ref":
                run["embedding_max_abs_err_vs_ref"],
            "traces": len(traces), "spans_per_trace": len(OBSERVE_SPANS)}


def _scraper(url: str, samples: list):
    """A context manager that GETs ``url`` every SCRAPE_EVERY_S from a
    thread while it is entered, and once more as it leaves; each scrape
    is parsed with the port's parser into ``samples`` as (host ms,
    parsed)."""
    from client_tpu_torch.server.metrics import parse_prometheus_text

    def scrape():
        t0 = time.perf_counter()
        status, body = _get(url)
        ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise RuntimeError(f"GET /metrics answered {status}")
        samples.append((ms, parse_prometheus_text(body.decode())))

    @contextlib.contextmanager
    def run():
        stop = threading.Event()
        errors: list = []

        def loop():
            while not stop.wait(SCRAPE_EVERY_S):
                try:
                    scrape()
                except Exception as e:  # noqa: BLE001 — failed below
                    errors.append(f"{type(e).__name__}: {e}")
                    return

        th = threading.Thread(target=loop)
        th.start()
        try:
            yield
        finally:
            stop.set()
            th.join(timeout=60)
        if errors:
            fail(f"observe: a scrape failed: {errors[0]}")
        scrape()

    return run()


def _observe_generation(gen_model: tuple, trace_dir: str) -> tuple:
    """bench.py's 32 jobs, paged with K2, through the decoupled path twice:
    tracing off, then every request traced to a file while /metrics is
    scraped over HTTP."""
    import dataclasses

    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.server.metrics import sample_value

    cfg, params, jobs = gen_model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    greedy = [None] * len(jobs)
    kw = dict(kv_layout="paged", kv_block_len=GEN_BLOCK)
    off = _serve_generation("observe_off", cfg, params, jobs, greedy, **kw)
    trace_file = os.path.join(trace_dir, "generation.jsonl")
    scrapes: list = []
    final: dict = {}

    @contextlib.contextmanager
    def traced(core):
        core.update_trace_settings(settings={
            "trace_level": ["TIMESTAMPS"], "trace_rate": ["1"],
            "trace_file": [trace_file]})
        http = HttpInferenceServer(core, port=0).start()
        try:
            with _scraper(f"http://{http.url}/metrics", scrapes):
                yield
            engine = core._entry("continuous_lm").model.engine
            final["stats"] = engine.stats()
        finally:
            http.stop()

    on = _serve_generation("observe_paged", cfg, params, jobs, greedy,
                           around=traced, **kw)
    _judge_greedy(cfg, params, [off, on])
    for run in (off, on):
        want = LAYERS * GEN_CHUNK * run["chunk_dispatches"]
        if run["paged_decode_attention_launches"] != want:
            fail(f"observe: the {run['run']} run launched "
                 f"paged_decode_attention "
                 f"{run['paged_decode_attention_launches']} times in "
                 f"{run['chunk_dispatches']} chunk dispatches, expected "
                 f"{want}")
    lab = {"model": "continuous_lm", "version": "1"}
    last = scrapes[-1][1]
    stats = final["stats"]
    for name, key in (("client_tpu_generation_tokens_total",
                       "tokens_emitted"),
                      ("client_tpu_generation_requests_total",
                       "requests_completed")):
        if sample_value(last, name, lab) != stats[key]:
            fail(f"observe: {name} reads {sample_value(last, name, lab)}, "
                 f"the engine's {key} {stats[key]}")
    tokens = [sample_value(p, "client_tpu_generation_tokens_total", lab)
              for _ms, p in scrapes]
    if tokens != sorted(tokens):
        fail(f"observe: the token counter went down between scrapes")
    if sample_value(last, "client_tpu_engine_up", lab) != 1:
        fail("observe: client_tpu_engine_up does not read 1")
    traces = _read_traces(trace_file)
    if len(traces) != len(jobs):
        fail(f"observe: {len(traces)} generation traces for {len(jobs)} "
             f"streams")
    for tr in traces:
        names = [s["name"] for s in tr["timestamps"]]
        if names[0] != "REQUEST_START" or names[-1] != "REQUEST_END" \
                or not {"GENERATION_ENQUEUE", "QUEUE_WAIT", "FIRST_TOKEN",
                        "DECODE"} <= set(names):
            fail(f"observe: generation trace {tr['id']} spans {names}")
    ms = sorted(m for m, _p in scrapes)
    spans = [len(tr["timestamps"]) for tr in traces]
    scrape = {"scrapes": len(scrapes), "scrape_ms_median": ms[len(ms) // 2],
              "scrape_ms_max": ms[-1], "families": len(last["families"]),
              "traces": len(traces), "spans_per_trace_mean":
                  sum(spans) / len(spans),
              "spans_per_trace_min": min(spans),
              "spans_per_trace_max": max(spans)}
    return off, on, scrape


def _observe_dead_engine(gen_model: tuple) -> dict:
    """An engine on the card whose dispatch raises: the model and the
    server read not ready (also over HTTP) and client_tpu_engine_up 0,
    until an unload and a load stage a fresh engine."""
    import dataclasses

    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.server.metrics import (
        parse_prometheus_text,
        sample_value,
    )

    cfg, params, jobs = gen_model
    model = make_continuous_generator(
        "dead", cfg=dataclasses.replace(cfg, attn_impl="flash"),
        params=params, n_slots=2, chunk_size=GEN_CHUNK, kv_layout="paged",
        kv_block_len=GEN_BLOCK, device="cuda")
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    http = HttpInferenceServer(core, port=0).start()
    prompt = jobs[0][0]

    def readiness():
        return (core.model_ready("dead"), core.ready(),
                _get(f"http://{http.url}/v2/health/ready")[0])

    try:
        healthy = readiness()
        engine = model.engine

        def boom(*a, **k):
            raise RuntimeError("injected dispatch failure")

        engine._dispatch = boom
        try:
            list(engine.submit(prompt, 4))
            fail("observe: a stream on a dead engine did not fail")
        except RuntimeError:
            pass
        engine._thread.join(timeout=60)
        dead = readiness()
        up = sample_value(parse_prometheus_text(core.metrics_text()),
                          "client_tpu_engine_up", {"model": "dead"})
        model.unload()
        model.load()
        served = len(list(model.engine.submit(prompt, 4)))
        restored = readiness()
    finally:
        http.stop()
        core.stop()
    if (healthy, dead, up, restored, served) != \
            ((True, True, 200), (False, False, 400), 0, (True, True, 200),
             4):
        fail(f"observe: readiness {healthy} -> {dead} (engine_up {up}) "
             f"-> {restored}, {served} tokens after the reload")
    return {"ready": healthy, "dead": dead, "engine_up_dead": up,
            "reloaded": restored}


def phase_observe(gen_model: tuple) -> dict:
    """The observability plane at full width: the encoder traced over
    HTTP (K1), bench.py's 32 paged jobs with tracing off and on while
    /metrics is scraped (K2), and a dead engine's readiness."""
    import tempfile

    with tempfile.TemporaryDirectory() as trace_dir:
        t0 = time.time()
        encoder = _observe_encoder(trace_dir)
        t1 = time.time()
        off, on, scrape = _observe_generation(gen_model, trace_dir)
        t2 = time.time()
        dead = _observe_dead_engine(gen_model)
    runs = []
    for run in (off, on):
        runs.append({k: run[k] for k in (
            "run", "continuous_batching_ragged_tokens_per_s",
            "chunk_dispatches", "paged_decode_attention_launches",
            "host_ms_per_dispatch", "ttft_mean_ms", "itl_mean_ms",
            "teacher_forced", "wall_s")})
    result = {"phase": "observe", "encoder": encoder, "runs": runs,
              "traced_vs_off": on["continuous_batching_ragged_tokens_per_s"]
              / off["continuous_batching_ragged_tokens_per_s"],
              "scrape": scrape, "dead_engine": dead,
              "seconds": {"encoder": t1 - t0, "generation": t2 - t1,
                          "dead_engine": time.time() - t2}}
    emit(result)
    return result


# supervise: the supervisor's first backoff, the crash-loop breaker's
# budget (the crash run's one death and two more), the stall the
# kernel_delay fault holds one dispatch for (above the watchdog's default
# 5 s stall wall), the streams that must be decoding before the crash, the
# encoder requests read beside the LM, the profile's capture
SUP_BACKOFF_S, SUP_MAX_FAILURES, STALL_DELAY_S = 0.05, 3, 5.5
SUP_DECODING, SUP_ENCODER_REQUESTS, PROFILE_S, PROFILE_TRIES = 8, 24, 1.0, 3
# the profile process's limit: CUDA start, the model, warmup, the captures
PROFILE_PROCESS_S = 300
# the stalled streams' budget: with a prompt of 8 to 63 tokens each takes
# 8 to 12 chunk dispatches, so each still holds its slot when the delay
# lands, one or two dispatches after the STALL_AFTER-th (80 ms or more of
# host time each, past the watchdog's 0.25 s sampling interval)
STALL_BUDGET, STALL_AFTER = 120, 4
# K2's kernel symbol in ops/csrc/paged_attention.cu, as a profile names it
K2_KERNEL = "paged_decode_kernel"
# the rebuilt engine's warm chunks (greedy and sampled, all slots
# inactive), each 12 x 16 K2 launches, inside the crash run's window
WARM_CHUNKS = 2
WATCHDOG_ARMS = ("watchdog_on", "watchdog_off", "watchdog_on",
                 "watchdog_off")


def _retrying_jobs(core, jobs: list, label: str, on_first=None) -> dict:
    """``jobs`` through ``core.infer`` with a response callback, one
    thread each, all started together, sent as a client with a retry
    policy sends them: a stream that ends in a 503 carrying Retry-After
    is sent again, from its first token, once the hint has passed; any
    other error fails. ``on_first(n)`` is called with the count of
    streams that got their first token so far. Returns each job's tokens
    (of its last attempt), the (status, hint) of each 503 it got, and the
    perf_counter of each attempt's first token."""
    from client_tpu_torch.ops import paged_attention as pa

    n = len(jobs)
    tokens: list = [None] * n
    refusals: list = [[] for _ in jobs]
    firsts: list = [[] for _ in jobs]
    errors: list = []
    started = [0]
    lock = threading.Lock()
    go = threading.Barrier(n)

    def one(i):
        prompt, budget = jobs[i]
        go.wait(timeout=60)
        for _attempt in range(20):
            got, end = [], {}

            def cb(resp, final):
                if resp.error is not None:
                    end["error"] = (resp.error_status, resp.retry_after_s,
                                    resp.error)
                elif resp.outputs:
                    if not got:
                        firsts[i].append(time.perf_counter())
                        with lock:
                            started[0] += 1
                            count = started[0]
                        if on_first is not None:
                            on_first(count)
                    got.append(int(resp.output("TOKEN").data[0]))
                if final:
                    end["final"] = True

            core.infer(_stream_request(prompt, budget, None),
                       response_callback=cb)
            err = end.get("error")
            if err is None:
                tokens[i] = got
                return
            refusals[i].append(err[:2])
            if err[0] != 503 or err[1] is None:
                errors.append(f"job {i}: {err}")
                return
            time.sleep(err[1])
        errors.append(f"job {i}: still refused after 20 attempts")

    def guarded(i):
        try:
            one(i)
        except Exception as e:  # noqa: BLE001 — failed below
            errors.append(f"job {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=guarded, args=(i,))
               for i in range(n)]
    pa.launches = 0
    t0 = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall_s = time.time() - t0
    if errors or any(th.is_alive() for th in threads):
        fail(f"{label}: {errors[:3]}")
    for i, ((_p, budget), got) in enumerate(zip(jobs, tokens)):
        if len(got) != budget:
            fail(f"{label}: job {i} streamed {len(got)} of {budget}")
    return {"tokens": tokens, "refusals": refusals, "firsts": firsts,
            "wall_s": wall_s, "k2": pa.launches}


def _chunks(engine) -> int:
    return engine.stats()["dispatch_by_kind"]["chunk"]["dispatches"]


def _supervise_serve(gen_model: tuple, tmp: str) -> dict:
    """The supervised paged LM beside the encoder in one server with the
    debug endpoints: (g) the runtime ledger after 24 encoder requests, (a)
    the clean run, (b) one crash and the retries, (c) the breaker and (f)
    its /metrics, an unload and a load, (d) a stall, (h) a profile (by a
    server in a process of its own)."""
    import dataclasses

    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server import faultinject
    from client_tpu_torch.server import trace as trace_mod
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.server.metrics import (
        parse_prometheus_text,
        sample_value,
    )

    cfg, params, jobs = gen_model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    model = make_continuous_generator(
        "continuous_lm", cfg=cfg, params=params, n_slots=GEN_SLOTS,
        chunk_size=GEN_CHUNK, dispatch_depth=2, max_new_tokens=128,
        kv_layout="paged", kv_block_len=GEN_BLOCK, device="cuda",
        supervision={"backoff_base_s": SUP_BACKOFF_S,
                     "max_failures": SUP_MAX_FAILURES, "window_s": 300.0})
    sup = model.engine_supervisor
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    http = HttpInferenceServer(core, port=0, debug_endpoints=True).start()
    base = f"http://{http.url}"
    inj = faultinject.get_injector()
    out: dict = {}

    def get_json(path):
        status, body = _get(base + path)
        if status != 200:
            fail(f"supervise: GET {path} answered {status}")
        return json.loads(body)

    try:
        # (g) the runtime ledger with both models loaded
        enc = _encoder_over_http("supervise_encoder", 2,
                                 n_requests=SUP_ENCODER_REQUESTS, core=core)
        gc.collect()
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        runtime = get_json("/v2/debug/runtime")
        alloc1 = torch.cuda.memory_allocated()
        rows = {m["model"]: m["memory"] for m in runtime["models"]}
        ledger = {name: {k: v for k, v in mem.items()
                         if not k.startswith("kv_pool_")}
                  for name, mem in rows.items()}
        ledger_sum = sum(sum(m.values()) for m in ledger.values())
        dev_row = runtime["devices"][0] if runtime["devices"] else {}
        if set(ledger) != {"bert_base", "continuous_lm"} \
                or not ledger["bert_base"].get("weights") \
                or not ledger["continuous_lm"].get("kv_pool") \
                or ledger_sum > alloc0 \
                or not min(alloc0, alloc1) <= dev_row.get("bytes_in_use", -1) \
                <= max(alloc0, alloc1):
            fail(f"supervise: runtime ledger {ledger} (sum {ledger_sum}), "
                 f"devices {runtime['devices']}, memory_allocated "
                 f"{alloc0}..{alloc1}")
        out["runtime"] = {"ledger": ledger, "ledger_sum": ledger_sum,
                          "memory_allocated": alloc0, "device": dev_row,
                          "encoder_batches": enc["batches"],
                          "flash_attention_launches":
                              enc["flash_attention_launches"],
                          "embedding_max_abs_err_vs_ref":
                              enc["embedding_max_abs_err_vs_ref"]}

        # (a) the clean run
        first = model.engine
        c0 = _chunks(first)
        clean = _retrying_jobs(core, jobs, "supervise_clean")
        chunks = _chunks(first) - c0
        incidents = model.incident_snapshot()["recorded_total"]
        if any(clean["refusals"]) or incidents \
                or clean["k2"] != LAYERS * GEN_CHUNK * chunks:
            fail(f"supervise: clean run with {incidents} incident(s), "
                 f"refusals {clean['refusals']}, K2 {clean['k2']} for "
                 f"{chunks} chunk dispatches")
        useful = sum(b for _, b in jobs)
        out["clean"] = {
            "run": "supervise_clean", "chunk_dispatches": chunks,
            "paged_decode_attention_launches": clean["k2"],
            "continuous_batching_ragged_tokens_per_s":
                useful / clean["wall_s"], "incidents": incidents,
            "greedy_streams": [(np.concatenate([p, t]), len(p))
                               for (p, _b), t in zip(jobs, clean["tokens"])]}

        # (b) one crash once SUP_DECODING streams are decoding
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        marks: dict = {}
        armed = threading.Event()

        def arm(count):
            if count >= SUP_DECODING and not armed.is_set():
                armed.set()
                inj.arm([{"point": "engine_loop", "after": 0, "times": 1}])

        def watch():
            # crash to healthy: liveness flips at the death and back once
            # the supervisor swaps the rebuilt engine in
            if not armed.wait(timeout=600):
                return
            while model.engine_healthy():
                time.sleep(0.0002)
            marks["down"] = time.perf_counter()
            while not model.engine_healthy():
                time.sleep(0.0002)
            marks["healthy"] = time.perf_counter()

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        c0 = _chunks(first)
        crash = _retrying_jobs(core, jobs, "supervise_crash", on_first=arm)
        inj.clear()
        watcher.join(timeout=60)
        rebuilt = model.engine
        dead_chunks = _chunks(first) - c0
        new_chunks = _chunks(rebuilt)
        refused = [r for r in crash["refusals"] if r]
        want_k2 = LAYERS * GEN_CHUNK * (dead_chunks + new_chunks
                                        + WARM_CHUNKS)
        if rebuilt is first or sup.restarts != 1 or len(refused) < \
                SUP_DECODING or any(s != 503 or h is None
                                    for r in refused for s, h in r) \
                or new_chunks < 1 \
                or crash["k2"] != want_k2 or "healthy" not in marks:
            fail(f"supervise: crash run restarts {sup.restarts}, "
                 f"{len(refused)} refused {refused[:3]}, K2 {crash['k2']} "
                 f"for {dead_chunks} + {new_chunks} + {WARM_CHUNKS} chunk "
                 f"dispatches, marks {marks}")
        # a resubmitted stream shares its rounds with other streams than
        # in the clean run; a slot's K2 output follows its own blocks
        # only, so every stream must equal the clean run's
        same = [a == b for a, b in zip(crash["tokens"], clean["tokens"])]
        first_diff = [next(k for k, (x, y) in enumerate(zip(a, b))
                           if x != y)
                      for a, b, eq in zip(crash["tokens"], clean["tokens"],
                                          same) if not eq]
        if not all(same):
            fail(f"supervise: {sum(same)} of {len(same)} resubmitted "
                 f"streams equal the clean run's (first differing tokens "
                 f"{first_diff})")
        # the crash: the liveness flip, the first act of the death, read
        # on this host's clock by the watcher
        t_crash = marks["down"]
        after_restart = [f for fs in crash["firsts"] for f in fs
                         if f > marks["healthy"]]
        # the incident bundle of the death, read after the swap
        inc = get_json("/v2/debug/incidents")["models"]
        deaths = [i for m in inc for i in m["incidents"]["incidents"]
                  if i["detector"] == "engine_death"]
        if len(deaths) != 1 or not deaths[0]["evidence"]["flight_tail"]:
            fail(f"supervise: {len(deaths)} engine_death bundles at "
                 f"/v2/debug/incidents")
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        pool = LAYERS * 2 * GEN_POOL * GEN_BLOCK * cfg.n_heads \
            * cfg.head_dim * 2
        if mem_after - mem_before > pool // 2:
            fail(f"supervise: memory_allocated {mem_before} before the "
                 f"crash, {mem_after} after the drain (one pool is {pool})")
        out["crash"] = {
            "run": "supervise_crash", "restarts": sup.restarts,
            "refused_streams": len(refused),
            "retry_after_s": sorted({h for r in refused for _s, h in r}),
            "attempts_max": 1 + max(len(r) for r in crash["refusals"]),
            "dead_engine_chunk_dispatches": dead_chunks,
            "rebuilt_engine_chunk_dispatches": new_chunks,
            "paged_decode_attention_launches": crash["k2"],
            "streams_equal_clean": sum(same),
            "crash_to_healthy_ms": (marks["healthy"] - t_crash) * 1e3,
            "crash_to_first_token_ms": (min(after_restart) - t_crash) * 1e3
            if after_restart else None,
            "memory_allocated_before_crash": mem_before,
            "memory_allocated_after_drain": mem_after,
            "pool_bytes": pool, "death_bundle_keys": sorted(deaths[0]),
            "continuous_batching_ragged_tokens_per_s":
                useful / crash["wall_s"],
            "greedy_streams": [(np.concatenate([p, t]), len(p))
                               for (p, _b), t in zip(jobs, crash["tokens"])]}

        # (c) crash cycles until the breaker trips; (f) /metrics then
        prompt = jobs[0][0]
        cycles = []
        for k in range(SUP_MAX_FAILURES - 1):
            dying = model.engine
            inj.arm([{"point": "engine_loop", "after": 0, "times": 1}])
            try:
                list(dying.submit(prompt, 8))
                fail("supervise: a stream survived an engine_loop fault")
            except Exception as e:  # noqa: BLE001 — the answer is checked
                cycles.append((getattr(e, "status", None),
                               getattr(e, "retry_after", None)))
            inj.clear()
            dying._thread.join(timeout=60)
            if k < SUP_MAX_FAILURES - 2:
                if not _wait_for(lambda: sup.healthy(), 60):
                    fail("supervise: no restart after the second crash")
        if not sup.crash_looped or model.engine_healthy():
            fail(f"supervise: the breaker did not trip: {sup.snapshot()}")
        ready_status = _get(base + "/v2/health/ready")[0]
        try:
            list(model.engine.submit(prompt, 4))
            gate = None
        except Exception as e:  # noqa: BLE001 — the answer is checked
            gate = (getattr(e, "status", None),
                    getattr(e, "retry_after", None))
        status, text = _get(base + "/metrics")
        parsed = parse_prometheus_text(text.decode())
        lab = {"model": "continuous_lm", "version": "1"}
        fams = sorted(parsed["families"])
        wd_fams = [f for f in fams if f.startswith("client_tpu_watchdog_")]
        metrics = {
            "restarts": sample_value(parsed,
                                     "client_tpu_engine_restarts_total",
                                     lab),
            "crash_looped": sample_value(
                parsed, "client_tpu_engine_crash_looped", lab),
            "engine_up": sample_value(parsed, "client_tpu_engine_up", lab),
            "engine_deaths": sample_value(
                parsed, "client_tpu_watchdog_incidents_total",
                dict(lab, detector="engine_death")),
            "watchdog_families": wd_fams, "families": len(fams)}
        if status != 200 or ready_status != 400 \
                or gate != (503, None) \
                or cycles != [(503, SUP_BACKOFF_S * 2), (503, None)] \
                or metrics["restarts"] != 2 or metrics["crash_looped"] != 1 \
                or metrics["engine_up"] != 0 \
                or metrics["engine_deaths"] != SUP_MAX_FAILURES \
                or len(wd_fams) != 5:
            fail(f"supervise: breaker: cycles {cycles}, ready "
                 f"{ready_status}, gate {gate}, metrics {metrics}")
        model.unload()
        model.load()
        back = (_get(base + "/v2/health/ready")[0],
                len(list(model.engine.submit(prompt, 4))))
        if back != (200, 4):
            fail(f"supervise: after an unload and a load: {back}")
        torch.cuda.synchronize()
        out["breaker"] = {"cycles": cycles, "ready_when_tripped":
                          ready_status, "gate": gate, "metrics": metrics,
                          "after_reload": back,
                          "memory_allocated_after_reload":
                              torch.cuda.memory_allocated()}

        # (d) one dispatch held past the stall wall, armed once the
        # traced streams have run STALL_AFTER dispatches (so the watchdog
        # holds a busy sample from before the stall)
        engine = model.engine
        traces = [trace_mod.Trace(f"stall-{i}", "continuous_lm", "1")
                  for i in range(4)]
        c0 = engine._chunks_dispatched
        stall_errors: list = []

        def traced(i):
            try:
                got = list(engine.submit(jobs[i][0], STALL_BUDGET,
                                         trace=traces[i]))
                if len(got) != STALL_BUDGET:
                    stall_errors.append(f"stream {i}: {len(got)} tokens")
            except Exception as e:  # noqa: BLE001 — failed below
                stall_errors.append(f"stream {i}: {e}")

        ths = [threading.Thread(target=traced, args=(i,)) for i in range(4)]
        for th in ths:
            th.start()
        if not _wait_for(lambda: engine._chunks_dispatched
                         >= c0 + STALL_AFTER, 120):
            fail("supervise: the stalled streams never dispatched")
        inj.arm([{"point": "kernel_delay", "after": 0, "times": 1,
                  "delay_s": STALL_DELAY_S,
                  "match": {"engine": "continuous_lm"}}])
        for th in ths:
            th.join(timeout=120)
        inj.clear()
        counts = model.incident_snapshot()["counts"]
        stalls = [i for i in model.incident_snapshot()["incidents"]
                  if i["detector"] == "engine_stall"]
        marked = [[f for name, _ns, f in tr.timestamps
                   if name == trace_mod.INCIDENT] for tr in traces]
        if stall_errors or counts["engine_stall"] != 1 or len(stalls) != 1 \
                or not stalls[0]["evidence"]["flight_tail"] \
                or not all(any(f["detector"] == "engine_stall" for f in m)
                           for m in marked):
            fail(f"supervise: stall: errors {stall_errors}, counts "
                 f"{counts}, INCIDENT spans {marked}")
        out["stall"] = {"breach": stalls[0]["breach"],
                        "flight_tail": len(stalls[0]["evidence"]
                                           ["flight_tail"]),
                        "traces_with_incident": len(marked),
                        "counts": counts}

        # (h) a profile naming K2, taken by a server in a process of its
        # own (see _profile_process)
        out["profile"] = _profile_in_own_process(os.path.join(tmp,
                                                              "profile"))
    finally:
        inj.clear()
        http.stop()
        core.stop()
    return out


def _profile_in_own_process(log_dir: str) -> dict:
    """Run supervise's (h) as ``chip_smoke.py --profile-process`` and
    return its captures; a non-zero exit or a timeout fails the phase."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--profile-process", json.dumps({"log_dir": log_dir})],
            cwd=REPO, capture_output=True, text=True,
            timeout=PROFILE_PROCESS_S)
    except subprocess.TimeoutExpired:
        fail(f"supervise: the profile process ran past {PROFILE_PROCESS_S} s")
    if proc.returncode != 0:
        fail(f"supervise: the profile process exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _profile_process(args: dict) -> int:
    """Supervise's (h) in a process of its own (``chip_smoke.py
    --profile-process <json>``): the paged LM with K2 behind a server with
    the debug endpoints, bench.py's jobs run round after round from before
    the capture starts until it has returned (the profiler takes a while
    to start on a busy host), and POST /v2/debug/profile captures
    PROFILE_S: the trace names K2. A process of its own, since under
    torch.profiler CUPTI can stop delivering kernel records for the rest of
    a process that has taken captures while other threads launched
    kernels (the host's launches are still recorded), and this script
    profiles much before this phase. Prints one JSON line."""
    import dataclasses

    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    cfg, params, jobs = _generation_model()
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    model = make_continuous_generator(
        "continuous_lm", cfg=cfg, params=params, n_slots=GEN_SLOTS,
        chunk_size=GEN_CHUNK, dispatch_depth=2, max_new_tokens=128,
        kv_layout="paged", kv_block_len=GEN_BLOCK, device="cuda")
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    http = HttpInferenceServer(core, port=0, debug_endpoints=True).start()
    base = f"http://{http.url}"
    try:
        engine = model.engine
        c0 = engine._chunks_dispatched
        stop, rounds = threading.Event(), []

        def load():
            while not stop.is_set():
                rounds.append(_retrying_jobs(core, jobs, "supervise_prof"))

        runner = threading.Thread(target=load, daemon=True)
        runner.start()
        if not _wait_for(lambda: engine._chunks_dispatched > c0, 120):
            fail("supervise: no stream started before the profile")
        # torch.profiler may record no kernel in a capture (device_ms
        # meets the same and profiles again): up to PROFILE_TRIES
        # captures, each counted with the engine's dispatches over its
        # request and its events by category, so a capture that lost the
        # card's activity (host launches, no kernel) shows as such
        captures = []
        for k in range(PROFILE_TRIES):
            cap_dir = os.path.join(args["log_dir"], str(k))
            d0, t0 = engine._chunks_dispatched, time.time()
            _post(base + "/v2/debug/profile", json.dumps(
                {"log_dir": cap_dir, "duration_s": PROFILE_S}).encode(),
                {"Content-Type": "application/json"})
            files = [os.path.join(r, f) for r, _d, fs in os.walk(cap_dir)
                     for f in fs if f.endswith(".pt.trace.json")]
            named, cats = 0, {}
            for path in files:
                with open(path) as fh:
                    text = fh.read()
                named += text.count(K2_KERNEL)
                for cat in re.findall(r'"cat": "([^"]+)"', text):
                    cats[cat] = cats.get(cat, 0) + 1
            captures.append({
                "files": len(files), "k2_events": named,
                "kernel_events": cats.get("kernel", 0),
                "dispatches": engine._chunks_dispatched - d0,
                "events_by_cat": cats, "request_s": time.time() - t0,
                "bytes": sum(os.path.getsize(f) for f in files)})
            if named:
                break
        stop.set()
        runner.join(timeout=300)
        if runner.is_alive() or not rounds:
            fail("supervise: the jobs run under the profile failed")
        if not captures[-1]["k2_events"]:
            fail(f"supervise: no profile named K2: {captures}, over "
                 f"{len(rounds)} rounds of jobs")
        result = {"captures": captures, "job_rounds": len(rounds)}
    finally:
        http.stop()
        core.stop()
    print(json.dumps(result), flush=True)
    return 0


def _wait_for(predicate, timeout_s: float) -> bool:
    end = time.time() + timeout_s
    while time.time() < end:
        if predicate():
            return True
        time.sleep(0.002)
    return predicate()


def _time_hooks(engine, acc: dict) -> None:
    """Wrap the engine's watchdog tick and flight record (each once per
    loop iteration, on the engine thread) with host timers: ``acc[name]``
    holds [seconds, calls]. The watchdog's own cost, read apart from the
    host's pace, which moves tokens/s between runs by more than it."""
    for name in ("_watchdog_tick", "_record_flight"):
        fn = getattr(engine, name)
        acc[name] = [0.0, 0]

        def timed(*args, _fn=fn, _slot=acc[name], **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                _slot[0] += time.perf_counter() - t0
                _slot[1] += 1

        setattr(engine, name, timed)


def phase_supervise(gen_model: tuple) -> dict:
    """Engine supervision, the watchdog and the runtime plane at full
    width: the supervised paged LM beside the encoder (the runtime ledger,
    a clean run, a crash with retries, the breaker and /metrics, a stall,
    a profile), then the watchdog's cost, on and off alternately."""
    import dataclasses
    import tempfile

    cfg, params, jobs = gen_model
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        served = _supervise_serve(gen_model, tmp)
    t1 = time.time()
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    greedy = [None] * len(jobs)
    arms = []
    for label in WATCHDOG_ARMS:
        hooks: dict = {}
        run = _serve_generation(label, fcfg, params, jobs, greedy,
                                kv_layout="paged", kv_block_len=GEN_BLOCK,
                                watchdog=label == "watchdog_on",
                                instrument=lambda e: _time_hooks(e, hooks))
        want = LAYERS * GEN_CHUNK * run["chunk_dispatches"]
        if run["paged_decode_attention_launches"] != want:
            fail(f"supervise: {label} launched K2 "
                 f"{run['paged_decode_attention_launches']} times for "
                 f"{run['chunk_dispatches']} chunk dispatches")
        run["host_us_per_call"] = {name: s / n * 1e6 if n else None
                                   for name, (s, n) in hooks.items()}
        run["calls"] = {name: n for name, (_s, n) in hooks.items()}
        arms.append(run)
    t2 = time.time()
    _judge_greedy(fcfg, params, [served["clean"], served["crash"]] + arms)
    runs = [{k: run[k] for k in (
        "run", "continuous_batching_ragged_tokens_per_s",
        "chunk_dispatches", "paged_decode_attention_launches",
        "host_ms_per_dispatch", "ttft_mean_ms", "teacher_forced", "wall_s",
        "host_us_per_call", "calls")}
        for run in arms]
    on = [r["continuous_batching_ragged_tokens_per_s"] for r in runs
          if r["run"] == "watchdog_on"]
    off = [r["continuous_batching_ragged_tokens_per_s"] for r in runs
           if r["run"] == "watchdog_off"]
    result = {"phase": "supervise", **{k: v for k, v in served.items()},
              "watchdog_runs": runs,
              "watchdog_on_vs_off": [a / b for a, b in zip(on, off)],
              "seconds": {"served": t1 - t0, "watchdog_runs": t2 - t1,
                          "judge": time.time() - t2}}
    emit(result)
    return result



# goodput: bench.py's 32 jobs, paged with K2, untraced but for GOODPUT_TRACED
# streams, once without the synchronous sample and once with every
# GOODPUT_SAMPLE_EVERY-th dispatch of a kind sampled; then one perf-analyzer
# window in streaming mode over the shared-prefix workload, with the
# goodput floor GOODPUT_FLOOR evaluated
GOODPUT_TRACED, GOODPUT_SAMPLE_EVERY = 4, 4
GOODPUT_WINDOW_MS, GOODPUT_CONCURRENCY, GOODPUT_FLOOR = 4000, 16, 0.5


def _span_flops(cfg, n: int) -> int:
    """FLOPs of positions 0..n-1 of the generation model (with the logit
    pass at each), from the config alone: a matmul of [m, k] x [k, n] is
    2mkn; per layer and token the QKV and output projections and the FFN,
    and 4 x heads x head_dim per attended position."""
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    kvh = cfg.n_kv_heads or h
    per_token = (2 * d * dh * (h + 2 * kvh) + 2 * h * dh * d
                 + (6 if cfg.ffn == "swiglu" else 4) * d * f)
    per_pos = 4 * h * dh
    return (cfg.n_layers * (per_token * n + per_pos * n * (n + 1) // 2)
            + 2 * d * cfg.vocab_size * n)


class _Result:
    """A streamed response as the perf analyzer's stream worker reads it."""

    def __init__(self, rid: str, final: bool):
        self._doc = {"id": rid,
                     "parameters": {"triton_final_response": final}}

    def get_response(self):
        return self._doc


def _stream_backend(core):
    """The in-process backend with a bidirectional stream, as a gRPC
    ModelStreamInfer gives the perf analyzer one: each request runs
    TorchInferenceServer.infer on its own thread, and every token response
    and the final flag reach the stream callback."""
    from client_tpu_torch.perf.client_backend import InProcessBackend
    from client_tpu_torch.utils import InferenceServerException

    class StreamBackend(InProcessBackend):
        def start_stream(self, callback) -> None:
            self._stream_cb = callback

        def async_stream_infer(self, model_name, inputs, outputs=None,
                               **options) -> None:
            req = self._build_request(model_name, inputs, outputs, options)
            rid = req.id

            def sink(resp, final):
                err = (None if resp.error is None
                       else InferenceServerException(resp.error))
                self._stream_cb(_Result(rid, final), err)

            threading.Thread(target=self._server.infer, args=(req,),
                             kwargs={"response_callback": sink},
                             daemon=True).start()

    return StreamBackend(core)


def _goodput_run(label: str, cfg, params, jobs: list, every: int) -> dict:
    """bench.py's jobs through the paged generator with
    ``device_time_sample_every=every``, served under the debug endpoints
    with the first GOODPUT_TRACED streams traced; the goodput tracker read
    just before the streams start and just after they end, then /metrics,
    /v2/debug/timeline and /v2/debug/traces over HTTP."""
    from client_tpu_torch.server.http_server import HttpInferenceServer

    box: dict = {}

    @contextlib.contextmanager
    def around(core):
        http = HttpInferenceServer(core, port=0,
                                   debug_endpoints=True).start()
        core.update_trace_settings(settings={
            "trace_level": ["TIMESTAMPS"], "trace_rate": ["1"],
            "trace_count": [str(GOODPUT_TRACED)]})
        eng = box["engine"]
        box["gp0"] = eng.goodput.snapshot()
        box["blocks0"] = eng.goodput.event_blocks
        t0 = time.time()
        try:
            yield
        finally:
            box["wall_s"] = time.time() - t0
            box["gp1"] = eng.goodput.snapshot()
            box["blocks1"] = eng.goodput.event_blocks
            box["signals"] = eng._watchdog_signals()
            box["lane"] = (eng._lane_handoffs, eng._kind_n["lane"],
                           eng._kind_n["lane_batch"])
            base = f"http://{http.url}"
            box["http"] = {path: _get(base + path) for path in (
                "/metrics", "/v2/debug/timeline", "/v2/debug/traces")}
            http.stop()

    run = _serve_generation(
        label, cfg, params, jobs, [None] * len(jobs), kv_layout="paged",
        kv_block_len=GEN_BLOCK, device_time_sample_every=every,
        instrument=lambda e: box.__setitem__("engine", e), around=around)
    return run, box


def _goodput_checks(label: str, cfg, jobs: list, run: dict, box: dict,
                    every: int, peak: float) -> dict:
    """The run's goodput ledger against the engine's own counters and an
    independent FLOP count, its cadence against the wall, its samples,
    and what /metrics and the debug routes served."""
    from client_tpu_torch.server.metrics import (
        parse_prometheus_text,
        sample_value,
    )
    from client_tpu_torch.server.timeline import (
        REQUEST_TID_BASE,
        TID_DECODE_LANE,
        validate_chrome_trace,
    )

    g0, g1 = box["gp0"], box["gp1"]

    def delta(key):
        return {k: v - g0[key].get(k, 0) for k, v in g1[key].items()
                if v - g0[key].get(k, 0)}

    dispatches = delta("dispatches")
    chunks = run["chunk_dispatches"]
    if dispatches != {"paged_decode": chunks} or any(box["lane"]):
        fail(f"{label}: goodput dispatches {dispatches} against the "
             f"engine's {chunks} chunk dispatches (lane and handoff counts "
             f"{box['lane']})")
    # a stream's chunks carry its prompt and served tokens rounded up to
    # whole chunks of GEN_CHUNK columns, each column at its real context
    want = sum(_span_flops(cfg, -(-(len(p) + b) // GEN_CHUNK) * GEN_CHUNK)
               for p, b in jobs)
    useful = g1["useful_flops_total"] - g0["useful_flops_total"]
    wasted = g1["wasted_flops_total"] - g0["wasted_flops_total"]
    if useful != want:
        fail(f"{label}: useful FLOPs {useful} != {want} counted from the "
             f"config and the jobs")
    device_s = g1["device_seconds_total"] - g0["device_seconds_total"]
    if not 0 < device_s <= box["wall_s"]:
        fail(f"{label}: {device_s} cadence device seconds against "
             f"{box['wall_s']} s of wall")
    sampled = g1["sampled_total"] - g0["sampled_total"]
    blocks = box["blocks1"] - box["blocks0"]
    if every:
        if not 0 < sampled == blocks or g1["sampling_share"] > 1 / every:
            fail(f"{label}: {sampled} samples, {blocks} of them waited on a "
                 f"CUDA event, share {g1['sampling_share']}")
    elif sampled or blocks:
        fail(f"{label}: {sampled} samples with sampling off")
    sig = box["signals"]
    if not all(isinstance(sig[k], float)
               for k in ("device_time_share", "wasted_flop_share")):
        fail(f"{label}: watchdog goodput signals {sig}")
    (st_m, metrics), (st_t, timeline), (st_r, traces) = (
        box["http"][p] for p in ("/metrics", "/v2/debug/timeline",
                                 "/v2/debug/traces"))
    if (st_m, st_t, st_r) != (200, 200, 200):
        fail(f"{label}: /metrics, timeline, traces answered "
             f"{(st_m, st_t, st_r)}")
    parsed = parse_prometheus_text(metrics.decode())
    lab = {"model": "continuous_lm"}
    mfu = sample_value(parsed, "client_tpu_goodput_mfu", lab)
    peak_g = sample_value(parsed, "client_tpu_goodput_device_peak_flops", lab)
    if mfu is None or peak_g != peak:
        fail(f"{label}: /metrics MFU {mfu}, peak {peak_g} (card peak {peak})")
    doc = json.loads(timeline)
    errors = validate_chrome_trace(doc)
    evs = doc["traceEvents"]
    lane_x = [e for e in evs if e.get("tid") == TID_DECODE_LANE
              and e["ph"] == "X"]
    req_tracks = {e["tid"] for e in evs
                  if e.get("tid", 0) >= REQUEST_TID_BASE}
    n_traces = len(json.loads(traces)["traces"])
    if errors or not lane_x or len(req_tracks) != GOODPUT_TRACED \
            or n_traces != GOODPUT_TRACED:
        fail(f"{label}: timeline errors {errors[:3]}, {len(lane_x)} "
             f"decode-lane slices, {len(req_tracks)} request tracks, "
             f"{n_traces} traces")
    launches = run["paged_decode_attention_launches"]
    if launches != LAYERS * GEN_CHUNK * chunks:
        fail(f"{label}: {launches} K2 launches for {chunks} chunk "
             f"dispatches")
    kind = "paged_decode"
    dev_ns = g1["device_ns"][kind] - g0["device_ns"].get(kind, 0)
    return {
        "chunk_dispatches": chunks, "goodput_dispatches": dispatches,
        "useful_flops": useful, "useful_flops_counted": want,
        "wasted_flops": wasted,
        "wasted_by_reason": {
            r: f - g0["wasted_flops"].get(kind, {}).get(r, 0)
            for r, f in g1["wasted_flops"].get(kind, {}).items()},
        "useful_flop_share": useful / (useful + wasted),
        "device_seconds": device_s, "wall_s": box["wall_s"],
        "device_time_share_of_wall": device_s / box["wall_s"],
        "cadence_ms_per_dispatch": dev_ns / chunks / 1e6,
        "sampled": sampled, "event_blocks": blocks,
        "sampling_share": g1["sampling_share"],
        "sampled_ms_per_dispatch": (
            g1["sampled_ewma_ns"].get(kind, 0.0) / 1e6 if every else None),
        "mfu_metrics": mfu, "mfu_run": useful / box["wall_s"] / peak,
        "peak_flops": peak_g,
        "watchdog_signals": {k: sig[k] for k in ("device_time_share",
                                                 "wasted_flop_share")},
        "timeline_events": len(evs), "timeline_request_tracks":
            len(req_tracks), "decode_lane_slices": len(lane_x),
        "traces": n_traces, "metrics_bytes": len(metrics)}


def _goodput_window(cfg, params, peak: float) -> dict:
    """One perf-analyzer window (InferenceProfiler.measure, the
    ConcurrencyManager in streaming mode, GOODPUT_CONCURRENCY streams)
    over the shared-prefix workload on the paged layout with the prefix
    cache: its scraped goodput deltas and the goodput gate's verdict at
    GOODPUT_FLOOR."""
    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.perf.client_backend import (
        BackendKind,
        ClientBackendFactory,
    )
    from client_tpu_torch.perf.concurrency_manager import ConcurrencyManager
    from client_tpu_torch.perf.data_loader import DataLoader
    from client_tpu_torch.perf.inference_profiler import InferenceProfiler
    from client_tpu_torch.perf.model_parser import ModelParser
    from client_tpu_torch.server import TorchInferenceServer

    core = TorchInferenceServer()
    core.register_model(make_continuous_generator(
        "continuous_lm", cfg=cfg, params=params, n_slots=GEN_SLOTS,
        chunk_size=GEN_CHUNK, max_new_tokens=PREFIX_BUDGET, eos_id=-1,
        kv_layout="paged", kv_block_len=GEN_BLOCK, prefix_cache=True,
        prefix_block_len=GEN_BLOCK, device="cuda"), warmup=True)
    factory = ClientBackendFactory(BackendKind.INPROCESS, server=core)
    factory.create = lambda: _stream_backend(core)
    backend = factory.create()
    parser = ModelParser()
    parser.init(backend, "continuous_lm")
    loader = DataLoader(1)
    loader.generate_shared_prefix_data(
        parser.inputs, prefix_len=PREFIX_LEN, suffix_len=PREFIX_SUFFIX,
        n_streams=PREFIX_STREAMS, vocab=PREFIX_VOCAB,
        max_tokens=PREFIX_BUDGET)
    mgr = ConcurrencyManager(factory, parser, loader, streaming=True)
    prof = InferenceProfiler(mgr, parser, backend,
                             measurement_window_ms=GOODPUT_WINDOW_MS,
                             min_goodput=GOODPUT_FLOOR)
    scrapes = [0]
    inner = backend.server_metrics

    def counted():
        scrapes[0] += 1
        return inner()

    backend.server_metrics = counted
    try:
        mgr.change_concurrency_level(GOODPUT_CONCURRENCY)
        time.sleep(2.0)     # past the first admissions
        mgr.check_health()
        pa.launches = 0
        status = prof.measure()
        k2 = pa.launches
        violation = prof._window_violation(status)
        mgr.check_health()
    finally:
        mgr.cleanup()
        core.stop()
    sm = status.metrics
    if not (sm.scraped and sm.goodput_scraped and sm.generation_scraped):
        fail(f"goodput window: scraped {sm.scraped}, goodput "
             f"{sm.goodput_scraped}, generation {sm.generation_scraped}")
    if not (sm.goodput_useful_flops > 0 and sum(
            sm.goodput_dispatches.values()) > 0 and k2 > 0):
        fail(f"goodput window: deltas {sm.goodput_dispatches}, useful "
             f"{sm.goodput_useful_flops}, K2 {k2}")
    if not sm.goodput_mfu_present or violation is not None:
        fail(f"goodput window: MFU present {sm.goodput_mfu_present}, "
             f"violation {violation}")
    return {"window_s": status.window_s, "valid_requests": status.valid_count,
            "tokens_per_s": status.generation.tokens_per_sec,
            "ttft_avg_ms": status.generation.ttft_avg_us / 1e3,
            "scrapes": scrapes[0],
            "goodput_dispatches": sm.goodput_dispatches,
            "goodput_device_s": sm.goodput_device_s,
            "goodput_useful_flops": sm.goodput_useful_flops,
            "goodput_wasted_flops": sm.goodput_wasted_flops,
            "goodput_useful_flop_share": sm.goodput_useful_flop_share,
            "goodput_mfu": sm.goodput_mfu, "slot_occupancy":
                sm.generation_slot_occupancy, "min_goodput": GOODPUT_FLOOR,
            "violation": violation, "prefix_hits": sm.prefix_hits,
            "paged_decode_attention_launches": k2,
            "slowest_requests": len(status.slowest_requests)}


def phase_goodput(gen_model: tuple) -> dict:
    """The goodput plane, the timeline and the profiler's metrics half at
    bench.py's generation width on the paged layout with K2: the 32 jobs
    with the synchronous sample off and every GOODPUT_SAMPLE_EVERY-th
    dispatch sampled, each run's ledger held exactly against the engine's
    counters and the FLOPs counted from the config; the cadence, CUDA-event
    and profiled busy ms of a chunk dispatch side by side; one streaming
    perf-analyzer window over the shared-prefix workload."""
    import dataclasses

    cfg, params, jobs = gen_model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    peak = card_peaks(torch.cuda.get_device_name(0))[1]
    t0 = time.time()
    runs = []
    for label, every in (("goodput_sample_off", 0),
                         ("goodput_sample_4", GOODPUT_SAMPLE_EVERY)):
        run, box = _goodput_run(label, cfg, params, jobs, every)
        run.update(_goodput_checks(label, cfg, jobs, run, box, every, peak))
        run["device_time_sample_every"] = every
        runs.append(run)
    t1 = time.time()
    _judge_greedy(cfg, params, runs)
    t2 = time.time()
    profile = _dispatch_profile(cfg, params)
    window = _goodput_window(cfg, params, peak)
    keep = ("run", "device_time_sample_every",
            "continuous_batching_ragged_tokens_per_s", "chunk_dispatches",
            "paged_decode_attention_launches", "host_ms_per_dispatch",
            "event_ms_per_dispatch", "teacher_forced", "wall_s")
    result = {
        "phase": "goodput",
        "runs": [{k: v for k, v in run.items()
                  if k in keep or k not in (
                      "greedy_streams", "client_ttft_ms", "phase_seconds",
                      "prefix_hits", "prefix_misses", "prefix_saved_tokens",
                      "prefill_lane_chunks", "speculation",
                      "dispatches_by_kind", "host_ms_per_dispatch_by_kind")}
                 for run in runs],
        # one chunk dispatch three ways: the cadence's split of the wall
        # between drains, the CUDA events around its kernels in the engine,
        # and the kernels' busy time by torch.profiler outside it
        "per_chunk_dispatch_ms": [{
            "run": run["run"], "cadence": run["cadence_ms_per_dispatch"],
            "cuda_event": run["event_ms_per_dispatch"],
            "profiler_busy": profile["device_busy_ms"],
            "sampled": run["sampled_ms_per_dispatch"],
            "host": run["host_ms_per_dispatch"]} for run in runs],
        "dispatch_profile": profile, "window": window,
        "seconds": {"serve": t1 - t0, "judge": t2 - t1,
                    "profile_and_window": time.time() - t2}}
    emit(result)
    return result


# client: the encoder requests each arm of the separate client process
# sends (bare socket, client library binary of which ASYNC_CALLS through
# async_infer, client library JSON, CUDA shm), and the perf CLI's window,
# concurrency and trial cap
CLIENT_CALLS, CLIENT_ASYNC_CALLS = 24, 8
CLIENT_PERF_MS, CLIENT_PERF_CONCURRENCY, CLIENT_PERF_TRIALS = 2000, 8, 5
CLIENT_SEED = 5
# the device of every CUDA shm region the phase makes (None: the card)
CLIENT_DEVICE = None
CLIENT_EMBED_BYTES = 768 * 4      # one pooled FP32 embedding


def _client_tokens(seed: int, n: int) -> np.ndarray:
    """The client phase's token rows [n, 1, 128], made alike in the
    client process and in this one."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 30528, size=(n, 1, 128)).astype(np.int32)


def _lat_summary(lat_s: list) -> dict:
    ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _client_process(args: dict) -> int:
    """The client phase's separate process (``chip_smoke.py
    --client-process <json>``), which imports only client_tpu_torch: the
    bare-socket arm (urllib, one request per connection), the client
    library over HTTP (binary, async_infer, JSON), the client library over
    two CUDA shm regions it creates and registers (input tokens, output
    embeddings, read back with get_contents_as_numpy after a seqno check),
    and the control plane. Writes every embedding to ``out_dir`` and
    prints one JSON line of per-arm numbers; any failed check raises."""
    from client_tpu_torch.client import http as httpclient
    from client_tpu_torch.utils import InferenceServerException
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    url, n = args["url"], CLIENT_CALLS
    toks = _client_tokens(args["seed"], 4 * n)
    bare_t, bin_t, json_t, shm_t = (toks[i * n:(i + 1) * n]
                                    for i in range(4))
    client = httpclient.InferenceServerClient(url, concurrency=8)

    def stats():
        return client.get_inference_statistics(
            "bert_base")["model_stats"][0]

    def arm(fn) -> tuple:
        """fn() -> per-request latencies; the arm's client-side rate and
        latency, the server's completions/s and mean batch size over the
        same window (the statistics extension), and the client's host
        (CPU) µs per request."""
        s0, c0, t0 = stats(), time.process_time(), time.perf_counter()
        lat = fn()
        wall, cpu = time.perf_counter() - t0, time.process_time() - c0
        s1 = stats()
        inf = s1["inference_count"] - s0["inference_count"]
        execs = s1["execution_count"] - s0["execution_count"]
        return {"requests": len(lat), "client_infer_per_s": len(lat) / wall,
                **_lat_summary(lat), "server_inferences": inf,
                "server_completions_per_s": inf / wall,
                "mean_batch_size": inf / execs if execs else None,
                "client_host_us_per_request": cpu / len(lat) * 1e6,
                "wall_s": wall}

    def timed(call) -> float:
        t = time.perf_counter()
        call()
        return time.perf_counter() - t

    got = {"bare": [], "binary": [None] * n, "json": [], "shm": []}
    infer_url = f"http://{url}/v2/models/bert_base/infer"

    def bare():
        return [timed(lambda i=i: got["bare"].append(
            _infer_binary(infer_url, bare_t[i]))) for i in range(n)]

    def library():
        lat = []
        for i in range(n - CLIENT_ASYNC_CALLS):
            x = httpclient.InferInput("input_ids", [1, 128], "INT32")
            x.set_data_from_numpy(bin_t[i])
            lat.append(timed(lambda: got["binary"].__setitem__(
                i, client.infer("bert_base", [x]).as_numpy("embedding"))))
        done = {}
        pending = []
        for i in range(n - CLIENT_ASYNC_CALLS, n):
            x = httpclient.InferInput("input_ids", [1, 128], "INT32")
            x.set_data_from_numpy(bin_t[i])
            pending.append((i, time.perf_counter(), client.async_infer(
                "bert_base", [x], callback=lambda r, e, i=i: done.setdefault(
                    i, (time.perf_counter(), e)))))
        for i, t, req in pending:
            got["binary"][i] = req.get_result(timeout=120).as_numpy(
                "embedding")
            end, err = done[i]
            if err is not None:
                raise err
            lat.append(end - t)
        out = httpclient.InferRequestedOutput("embedding", binary_data=False)
        for i in range(n):
            x = httpclient.InferInput("input_ids", [1, 128], "INT32")
            x.set_data_from_numpy(json_t[i], binary_data=False)
            lat.append(timed(lambda: got["json"].append(client.infer(
                "bert_base", [x], outputs=[out]).as_numpy("embedding"))))
        return lat

    in_h = cudashm.create_shared_memory_region("client_in", n * 512, 0,
                                               device=args["device"])
    out_h = cudashm.create_shared_memory_region(
        "client_out", n * CLIENT_EMBED_BYTES, 0, device=args["device"])
    seqnos = []
    # the regions' set-up (this process's first device copy) stays out
    # of the timed arm
    cudashm.set_shared_memory_region(in_h, [shm_t])
    client.register_cuda_shared_memory(
        "client_in", cudashm.get_raw_handle(in_h), in_h.device_id, n * 512)
    client.register_cuda_shared_memory(
        "client_out", cudashm.get_raw_handle(out_h), out_h.device_id,
        n * CLIENT_EMBED_BYTES)

    def shm():
        lat = []
        for i in range(n):
            x = httpclient.InferInput("input_ids", [1, 128], "INT32")
            x.set_shared_memory("client_in", 512, i * 512)
            y = httpclient.InferRequestedOutput("embedding")
            y.set_shared_memory("client_out", CLIENT_EMBED_BYTES,
                                i * CLIENT_EMBED_BYTES)
            before = out_h.seqno()
            lat.append(timed(lambda: client.infer("bert_base", [x],
                                                  outputs=[y])))
            after = out_h.seqno()
            if after <= before:
                raise RuntimeError(f"shm request {i}: the output region's "
                                   f"seqno read {after} after the server's "
                                   f"write (before it: {before})")
            seqnos.append(after)
            got["shm"].append(np.array(cudashm.get_contents_as_numpy(
                out_h, np.float32, (1, 768),
                offset=i * CLIENT_EMBED_BYTES)))
        return lat

    result = {"bare_socket": arm(bare), "library": arm(library),
              "shm": arm(shm)}
    # (d) the control plane
    status = client.get_cuda_shared_memory_status()
    names = sorted(r["name"] for r in status)
    meta = client.get_model_metadata("bert_base")
    config = client.get_model_config("bert_base")
    control = {"live": client.is_server_live(),
               "ready": client.is_server_ready(),
               "model_ready": client.is_model_ready("bert_base"),
               "metadata_inputs": [i["name"] for i in meta["inputs"]],
               "config_max_batch_size": config.get("max_batch_size"),
               # (the all-models form, /v2/models/stats, reads as a model
               # named "stats" on both packages' servers)
               "statistics_inferences": stats()["inference_count"],
               "cuda_shm_regions": names}
    client.unregister_cuda_shared_memory("client_in")
    client.unregister_cuda_shared_memory("client_out")
    control["cuda_shm_regions_after_unregister"] = sorted(
        r["name"] for r in client.get_cuda_shared_memory_status())
    try:
        client.get_tpu_shared_memory_status()
        control["tpu_verb_status"] = "200"
    except InferenceServerException as e:
        control["tpu_verb_status"] = e.status()
        control["tpu_verb_error"] = e.message()
    result["control"] = control
    result["shm"]["output_seqnos"] = seqnos
    cudashm.destroy_shared_memory_region(in_h)
    cudashm.destroy_shared_memory_region(out_h)
    client.close()
    np.savez(os.path.join(args["out_dir"], "embeddings.npz"),
             **{k: np.concatenate(v) for k, v in got.items()})
    print(json.dumps(result), flush=True)
    return 0


_PERF_PATTERNS = {
    "client_infer_per_s": r"Throughput: ([\d.e+]+) infer/sec",
    "request_count": r"Request count: (\d+)",
    "p50_us": r"p50 latency: (\d+) usec",
    "p99_us": r"p99 latency: (\d+) usec",
    "server_inference_count": r"Inference count: (\d+)",
    "server_execution_count": r"Execution count: (\d+)",
    "server_completions_per_s": r"Inferences/sec: ([\d.]+)",
    "client_rejected": r"Rejected count \(client\): (\d+)",
    # the native perf_analyzer's report
    "server_window_inference_count": r"Server inference count: (\d+)",
}


def _perf_cli(core, url: str, extra: list, prog=None) -> dict:
    """One ``python -m client_tpu_torch.perf`` run (``prog``: another
    analyzer's command, the native one's) against the encoder over HTTP
    with CUDA shm regions, in its own process: the report's numbers, the
    server's inferences and failures over the whole run, and the CLI
    process's host (CPU) µs per server inference over the whole run, its
    start (imports, the CUDA context, the regions) included."""
    import re
    import resource

    prog = prog or [sys.executable, "-m", "client_tpu_torch.perf"]
    cmd = [*prog, "-m", "bert_base",
           "-u", url, "-i", "http", "--shared-memory", "cuda",
           "-p", str(CLIENT_PERF_MS), "-r", str(CLIENT_PERF_TRIALS),
           *(["--device", CLIENT_DEVICE] if CLIENT_DEVICE else []), *extra]
    s0 = _stats(core, "bert_base")
    r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.time()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    wall = time.time() - t0
    r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    s1 = _stats(core, "bert_base")
    if out.returncode != 0:
        fail(f"client: {' '.join(cmd[1:])} exited {out.returncode}: "
             f"{out.stdout[-1000:]}{out.stderr[-2000:]}")
    nums = {}
    for key, pat in _PERF_PATTERNS.items():
        m = re.search(pat, out.stdout)
        nums[key] = float(m.group(1)) if m else None
    if nums["client_infer_per_s"] is None or nums["p99_us"] is None:
        fail(f"client: no report from the perf CLI: {out.stdout[-2000:]}")
    inferences = s1["inference_count"] - s0["inference_count"]
    failed = (s1["inference_stats"]["fail"]["count"]
              - s0["inference_stats"]["fail"]["count"])
    cpu = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
    return {"args": cmd[len(prog):], **nums,
            "p50_ms": nums["p50_us"] / 1e3, "p99_ms": nums["p99_us"] / 1e3,
            "mean_batch_size": (nums["server_inference_count"]
                                / nums["server_execution_count"]
                                if nums["server_execution_count"] else None),
            "stabilized": "did not stabilize" not in out.stdout,
            "run_server_inferences": inferences,
            "run_failed_requests": failed,
            "client_host_us_per_request_with_start":
                cpu / max(1, inferences) * 1e6,
            "wall_s": wall}


TORCHSERVE_BYTES = 4096


def _torchserve_cli() -> dict:
    """The perf CLI's foreign ``torchserve`` kind in this process, against
    a stdlib stub of TorchServe's inference API (a multipart upload to
    ``POST /predictions/{model}``): the CLI must exit 0 with a report, the
    stub must receive the uploaded file's bytes in every request's
    ``data`` part, and the kind must need neither grpcio nor protobuf."""
    import contextlib
    import importlib.util
    import io
    import re
    import tempfile
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from client_tpu_torch.perf.__main__ import main as perf_main

    payload = np.random.default_rng(CLIENT_SEED).integers(
        0, 256, TORCHSERVE_BYTES, dtype=np.uint8).tobytes()
    seen = {"requests": 0, "bad": 0}
    lock = threading.Lock()

    class Stub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            m = re.search(r"boundary=(\S+)", self.headers["Content-Type"])
            ok = m is not None and self.path == "/predictions/densenet"
            if ok:
                parts = body.split(b"--" + m.group(1).encode())
                data = [p for p in parts if b'name="data"' in p]
                ok = len(data) == 1 and data[0].split(
                    b"\r\n\r\n", 1)[1][:-2] == payload
            with lock:
                seen["requests"] += 1
                seen["bad"] += 0 if ok else 1
            reply = json.dumps({"class": "ok" if ok else "bad"}).encode()
            self.send_response(200 if ok else 400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(reply)))
            self.end_headers()
            self.wfile.write(reply)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    printed = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            upload = os.path.join(tmp, "upload.bin")
            with open(upload, "wb") as f:
                f.write(payload)
            data = os.path.join(tmp, "data.json")
            with open(data, "w") as f:
                json.dump({"data": [{"TORCHSERVE_INPUT": [upload]}]}, f)
            t0 = time.time()
            with contextlib.redirect_stdout(printed):
                rc = perf_main(["-m", "densenet", "--service-kind",
                                "torchserve", "-u",
                                f"127.0.0.1:{httpd.server_address[1]}",
                                "--input-data", data, "--sync",
                                "--concurrency-range", "2", "-p",
                                str(CLIENT_PERF_MS), "-r",
                                str(CLIENT_PERF_TRIALS)])
            wall = time.time() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    out = printed.getvalue()
    m = re.search(_PERF_PATTERNS["client_infer_per_s"], out)
    n = re.search(_PERF_PATTERNS["request_count"], out)
    result = {"rc": rc, "wall_s": wall,
              "client_infer_per_s": float(m.group(1)) if m else None,
              "request_count": int(n.group(1)) if n else None,
              "stub_requests": seen["requests"],
              "stub_bad_requests": seen["bad"],
              "upload_bytes": TORCHSERVE_BYTES,
              "grpc_installed":
                  importlib.util.find_spec("grpc") is not None,
              "protobuf_installed":
                  importlib.util.find_spec("google") is not None
                  and importlib.util.find_spec("google.protobuf") is not None}
    if rc != 0 or m is None or not result["request_count"] \
            or seen["bad"] or seen["requests"] < result["request_count"]:
        fail(f"client: the perf CLI's torchserve kind read {result}: "
             f"{out[-1500:]}")
    return result


def phase_client() -> dict:
    """The client library and the perf analyzer's network side, from a
    separate process, against the BERT-base encoder (seed 0, K1) behind
    TorchInferenceServer and the HTTP front end; add_sub's CUDA shm
    example in this process."""
    import contextlib
    import io
    import tempfile

    from client_tpu_torch.examples import simple_http_cudashm_client
    from client_tpu_torch.models import make_add_sub
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.perf.bench_harness import build_bert_encoder
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    seq, bucket, n = 128, 256, CLIENT_CALLS
    cache: dict = {}
    model = build_bert_encoder(seq, bucket, attn_impl="flash",
                               params_cache=cache, seed=0)
    ref_model = build_bert_encoder(seq, bucket, attn_impl="ref",
                                   params_cache=cache)
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    core.register_model(make_add_sub())
    # which attachment each registration resolved to, read as it lands
    kinds: dict = {}
    register = core.cuda_shm.register

    def recording(name, raw_handle, device_id, byte_size):
        register(name, raw_handle, device_id, byte_size)
        kinds[name] = type(core.cuda_shm.try_attachment(name)).__name__

    core.cuda_shm.register = recording
    http = HttpInferenceServer(core, port=0).start()
    url = http.url
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            # the main path: the K1 counter at 0 just before, read after
            s0 = _stats(core, "bert_base")
            fa.launches = 0
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                 "--client-process", json.dumps(
                     {"url": url, "seed": CLIENT_SEED,
                      "out_dir": out_dir, "device": CLIENT_DEVICE})],
                cwd=REPO, capture_output=True, text=True, timeout=180)
            process_s = time.time() - t0
            s1 = _stats(core, "bert_base")
            if proc.returncode != 0:
                fail(f"client: the client process exited "
                     f"{proc.returncode}: {proc.stderr[-3000:]}")
            arms = json.loads(proc.stdout.strip().splitlines()[-1])
            with np.load(os.path.join(out_dir, "embeddings.npz")) as z:
                got = {k: z[k] for k in z.files}
        # (c) the perf CLI, closed loop, then open loop at half its rate
        perf = _perf_cli(core, url, ["--concurrency-range",
                                     str(CLIENT_PERF_CONCURRENCY)])
        rate = perf["client_infer_per_s"] / 2
        perf_rate = _perf_cli(core, url,
                              ["--request-rate-range", f"{rate:.1f}"])
        s2 = _stats(core, "bert_base")
        launches = fa.launches
        # (f) the perf CLI's foreign torchserve kind against a stub
        torchserve = _torchserve_cli()
        # (e) the example's flow on add_sub, regions of this process
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            simple_http_cudashm_client.main(
                ["-u", url]
                + (["--device", CLIENT_DEVICE] if CLIENT_DEVICE else []))
    finally:
        http.stop()
        core.stop()
    execs = s2["execution_count"] - s0["execution_count"]
    if launches != LAYERS * execs:
        fail(f"client: {launches} flash_attention launches for {execs} "
             f"batches, expected {LAYERS} per batch")
    successes = sum(arms[a]["requests"] for a in
                    ("bare_socket", "library", "shm"))
    served = s1["inference_count"] - s0["inference_count"]
    if served != successes or successes != 4 * n:
        fail(f"client: the server counted {served} inferences for the "
             f"client process's {successes} successes")
    failed = (s2["inference_stats"]["fail"]["count"]
              - s0["inference_stats"]["fail"]["count"])
    for label, run in (("perf concurrency", perf), ("perf rate", perf_rate)):
        if run["run_failed_requests"] or run["client_rejected"] \
                or not run["request_count"]:
            fail(f"client: {label}: {run}")
    if failed:
        fail(f"client: {failed} failed requests in the phase")
    for name, want in (("client_in", "CrossProcessAttachment"),
                       ("client_out", "CrossProcessAttachment"),
                       ("example_cudashm", "InProcessAttachment"),
                       ("example_cudashm_out", "InProcessAttachment")):
        if kinds.get(name) != want:
            fail(f"client: region {name} resolved to {kinds.get(name)}, "
                 f"expected {want}")
    if "PASS" not in printed.getvalue():
        fail(f"client: the cudashm example said {printed.getvalue()!r}")
    ctl = arms["control"]
    if not (ctl["live"] and ctl["ready"] and ctl["model_ready"]) \
            or ctl["metadata_inputs"] != ["input_ids"] \
            or ctl["cuda_shm_regions"] != ["client_in", "client_out"] \
            or ctl["cuda_shm_regions_after_unregister"] \
            or ctl["tpu_verb_status"] != "400":
        fail(f"client: the control plane read {ctl}")
    # every embedding against the plain attention's forward
    order = ("bare", "binary", "json", "shm")
    toks = _client_tokens(CLIENT_SEED, 4 * n)
    padded = np.zeros((bucket, seq), np.int32)
    padded[:4 * n] = toks[:, 0]
    want = ref_model.execute({"input_ids": padded})["embedding"][:4 * n]
    served_embeds = np.concatenate([got[k] for k in order])
    if served_embeds.shape != want.shape \
            or not np.isfinite(served_embeds).all():
        fail(f"client: embeddings of shape {served_embeds.shape}, "
             f"expected {want.shape}")
    check = embed_check(served_embeds, want)
    if not check["rows_within"].all():
        bad = [f"{order[i // n]} {i % n}"
               for i in np.flatnonzero(~check["rows_within"])]
        fail(f"client: embeddings {bad[:5]} differ from the plain "
             f"attention's by {check['worst_err_over_bound']} of the bound")
    result = {"phase": "client", "bare_socket": arms["bare_socket"],
              "library": arms["library"], "shm": arms["shm"],
              "perf_concurrency": perf, "perf_request_rate": perf_rate,
              "perf_torchserve": torchserve, "control": ctl, "attachments": kinds,
              "batches": execs, "flash_attention_launches": launches,
              "embedding_max_abs_err_vs_ref": check["max_abs_err"],
              "embedding_worst_err_over_bound":
                  check["worst_err_over_bound"],
              "client_process_s": process_s}
    emit(result)
    return result


MODELS_IMAGES = 8
# bf16 logits against the same weights' f32 forward, relative to the
# largest |logit|: a few bf16 ulps of it (tests/test_torch_resnet.py
# measures 5.5e-3 between the two packages' bf16 forwards at 64x64)
MODELS_RTOL = 2e-2
MODELS_WINDOW_S = 3.0
MODELS_THREADS = 16
LM_PROMPT, LM_STEPS = 16, 32

_REPO_MODEL_PY = """\
from client_tpu_torch.models import make_add_sub


def create_model():
    return make_add_sub("repo_add_sub", 16, "INT32", device={device!r})
"""


def _allocated() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _png_images(n: int, seed: int) -> list:
    """``n`` random 224x224 RGB images as PNG bytes (Pillow, which
    ``preprocess`` decodes with, is on the card's host)."""
    try:
        from PIL import Image
    except ImportError:
        fail("models: Pillow is not installed: preprocess_resnet50 needs it")
    import io

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (224, 224, 3),
                                     dtype=np.uint8)).save(buf, format="PNG")
        out.append(buf.getvalue())
    return out


def _f32_forward(params: dict, images: np.ndarray, device) -> np.ndarray:
    """The same weights' ResNet-50 forward in f32 on ``device``, TF32 off
    in convolutions and matmuls."""
    from client_tpu_torch.models import resnet

    p32 = resnet.to_channels_last(_tree_map(lambda t: t.float(), params))
    conv_tf32 = torch.backends.cudnn.allow_tf32
    mm_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            out = resnet.forward(p32, torch.from_numpy(images).to(device))
        return out.cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.backends.cuda.matmul.allow_tf32 = mm_tf32


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _resnet_http(client, mod, images: np.ndarray) -> np.ndarray:
    x = mod.InferInput("image", list(images.shape), "FP32")
    x.set_data_from_numpy(images, binary_data=True)
    out = mod.InferRequestedOutput("logits", binary_data=True)
    return client.infer("resnet50", [x], outputs=[out]).as_numpy("logits")


def _resnet_shm(client, mod, images: np.ndarray, n_classes: int,
                device) -> np.ndarray:
    """The same request with its input and output in CUDA shm regions of
    this process (read by the server with no copy)."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    in_bytes = images.nbytes
    out_bytes = images.shape[0] * n_classes * 4
    h_in = cudashm.create_shared_memory_region("models_in", in_bytes, 0,
                                               device=device)
    h_out = cudashm.create_shared_memory_region("models_out", out_bytes, 0,
                                                device=device)
    try:
        cudashm.set_shared_memory_region(h_in, [images])
        client.register_cuda_shared_memory(
            "models_in", cudashm.get_raw_handle(h_in), h_in.device_id,
            in_bytes)
        client.register_cuda_shared_memory(
            "models_out", cudashm.get_raw_handle(h_out), h_out.device_id,
            out_bytes)
        x = mod.InferInput("image", list(images.shape), "FP32")
        x.set_shared_memory("models_in", in_bytes)
        out = mod.InferRequestedOutput("logits")
        out.set_shared_memory("models_out", out_bytes)
        client.infer("resnet50", [x], outputs=[out])
        return cudashm.get_contents_as_numpy(
            h_out, np.float32, (images.shape[0], n_classes))
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


def _images_per_s(url: str, image: np.ndarray) -> dict:
    """Single-image binary requests from MODELS_THREADS threads, each with
    its own client, for one MODELS_WINDOW_S window: images/s through the
    server and the requests' p50 ms."""
    from client_tpu_torch.client import http as httpclient

    stop = time.time() + MODELS_WINDOW_S
    lat, errors, lock = [], [], threading.Lock()

    def worker():
        c = httpclient.InferenceServerClient(url)
        try:
            while time.time() < stop:
                t0 = time.perf_counter()
                try:
                    _resnet_http(c, httpclient, image)
                except Exception as e:  # noqa: BLE001 — counted
                    with lock:
                        errors.append(str(e))
                    return
                with lock:
                    lat.append(time.perf_counter() - t0)
        finally:
            c.close()

    t0 = time.time()
    threads = [threading.Thread(target=worker)
               for _ in range(MODELS_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.time() - t0
    if errors or not lat:
        fail(f"models: the images/s window failed: {errors[:3]}")
    return {"images_per_s": len(lat) / wall, "requests": len(lat),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "threads": MODELS_THREADS, "window_s": wall}


def _seq_step(client, mod, model: str, name: str, value, sid, start=False,
              end=False):
    x = mod.InferInput(name, [1], "INT32")
    x.set_data_from_numpy(np.asarray([value], np.int32))
    return client.infer(model, [x], sequence_id=sid, sequence_start=start,
                        sequence_end=end)


def _decode_loop(cfg, params, prompt: list, steps: int, device) -> list:
    """The greedy tokens of the port's decode_step loop over a one-slot
    state: the prompt fed token by token, then each token fed back."""
    from client_tpu_torch.models import transformer as t

    state = t.init_decode_state(cfg, 1, device)
    out, tok = [], None
    with torch.inference_mode():
        for i in range(len(prompt) + steps):
            feed = prompt[i] if i < len(prompt) else tok
            logits, state = t.decode_step(
                cfg, params, torch.tensor([feed], dtype=torch.int32,
                                          device=device), state)
            tok = int(logits.argmax(-1)[0])
            out.append(tok)
    return out


def _decode_step_ms(model, cfg, device) -> dict:
    """One decoder_lm step (the served model's own ``step``, inputs on the
    host as the scheduler hands them) timed on the host, and the device
    work of ``decode_step`` between CUDA events."""
    from client_tpu_torch.models import transformer as t

    state = model.init_state()
    tok = {"TOKEN": np.asarray([3], np.int32)}
    for _ in range(3):
        _, state = model.step(tok, state)
    n = 32
    t0 = time.perf_counter()
    for _ in range(n):
        _, state = model.step(tok, state)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    dev_state = t.init_decode_state(cfg, 1, device)
    token = torch.tensor([3], dtype=torch.int32, device=device)
    params = model._params

    def step():
        nonlocal dev_state
        with torch.inference_mode():
            _, dev_state = t.decode_step(cfg, params, token, dev_state)

    return {"host_ms_per_step": host_ms, "event_ms_per_step":
            time_ms(step)}


def _perf_sequences(core, url: str) -> dict:
    """``python -m client_tpu_torch.perf -m decoder_lm`` in sequence mode
    over HTTP in its own process, the server counting every START and END
    it is sent."""
    sched = core._entry("decoder_lm").scheduler
    seen = {"start": 0, "end": 0}
    submit = sched.submit

    def counting(pending):
        seen["start"] += bool(pending.request.sequence_start)
        seen["end"] += bool(pending.request.sequence_end)
        submit(pending)

    sched.submit = counting
    s0 = _stats(core, "decoder_lm")
    # --sync: a sync worker keeps its own sequence slot; the async
    # workers of both packages' perf analyzers share the slots, so a
    # sequence's next request can reach the server before its START
    cmd = [sys.executable, "-m", "client_tpu_torch.perf", "-m", "decoder_lm",
           "-u", url, "-i", "http", "--sync", "--concurrency-range", "4",
           "--sequence-length", "20", "-p", "1000", "-r", "3"]
    try:
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=180)
    finally:
        del sched.submit
    s1 = _stats(core, "decoder_lm")
    if out.returncode != 0:
        fail(f"models: {' '.join(cmd[1:])} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    nums = {}
    for key, pat in _PERF_PATTERNS.items():
        m = re.search(pat, out.stdout)
        nums[key] = float(m.group(1)) if m else None
    m = re.search(r"Sequence Throughput: ([\d.]+) seq/sec", out.stdout)
    return {"args": cmd[4:], **nums,
            "client_sequences_per_s": float(m.group(1)) if m else None,
            "sequences_started": seen["start"],
            "sequences_ended": seen["end"],
            "live_sequences_after": sched.live_sequences(),
            "run_server_inferences": s1["inference_count"]
            - s0["inference_count"],
            "run_failed_requests": s1["inference_stats"]["fail"]["count"]
            - s0["inference_stats"]["fail"]["count"]}


def phase_models(env: dict) -> dict:
    """The repository, ensembles and sequences and the image models on
    the card, through TorchInferenceServer over HTTP with the port's
    client (docstring, item 18)."""
    import tempfile

    from client_tpu_torch.client import http as httpclient
    from client_tpu_torch.device import resolve_device
    from client_tpu_torch.models import (
        make_accumulator,
        make_decoder_lm,
        make_image_ensemble,
        make_preprocess,
        make_resnet50,
    )
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.models.decoder_lm import decode_config
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.server.runtime_stats import pytree_nbytes

    device = resolve_device(None)
    card = env["nvidia_smi"]
    n_img, n_cls = MODELS_IMAGES, 1000
    images = np.random.default_rng(0).uniform(
        -1.0, 1.0, (n_img, 224, 224, 3)).astype(np.float32)
    pngs = _png_images(n_img, 1)
    fa.launches = 0
    pa.launches = 0
    repo_dir = tempfile.mkdtemp(prefix="models_repo_")
    os.makedirs(os.path.join(repo_dir, "repo_add_sub"))
    with open(os.path.join(repo_dir, "repo_add_sub", "model.py"), "w") as f:
        f.write(_REPO_MODEL_PY.format(device=str(device)))
    core = TorchInferenceServer(model_repository=repo_dir)
    # (a) ResNet-50: the weights' bytes are what loading it allocates
    mem0 = _allocated()
    rn = make_resnet50(seed=0, device=device)
    core.register_model(rn, warmup=True)
    mem_loaded = _allocated()
    weight_bytes = pytree_nbytes(rn._params)
    core.register_model(make_preprocess())
    core.register_model(make_image_ensemble())
    ens_name = "preprocess_resnet50"
    cfg = decode_config(attn_impl="ref")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lm_params = t.init_params(gen, cfg)
    lm = make_decoder_lm(cfg=cfg, params=lm_params, device=device)
    core.register_model(lm)
    core.register_model(make_accumulator("accumulator", 1, "INT32",
                                         device=device))
    http = HttpInferenceServer(core, port=0).start()
    url = http.url
    client = httpclient.InferenceServerClient(url)
    try:
        served = _resnet_http(client, httpclient, images)
        want = _f32_forward(rn._params, images, device)
        via_shm = _resnet_shm(client, httpclient, images, n_cls, device)
        x_dev = {"image": torch.from_numpy(images).to(device)}
        forward_ms = time_ms(lambda: rn.execute_on_device(x_dev))
        window = _images_per_s(url, images[:1])
        # (b) the ensemble against its steps called one after the other
        e0 = {n: _stats(core, n) for n in
              (ens_name, "resnet50", "preprocess")}
        raw = np.array([[b] for b in pngs], dtype=np.object_)
        r_in = httpclient.InferInput("raw_image", [n_img, 1], "BYTES")
        r_in.set_data_from_numpy(raw)
        ens_out = client.infer(ens_name, [r_in]).as_numpy("logits")
        e1 = {n: _stats(core, n) for n in e0}
        pre = client.infer("preprocess", [r_in]).as_numpy("image")
        steps_out = _resnet_http(client, httpclient, pre)
        ens_equal = bool(np.array_equal(ens_out, steps_out))
        ens_execs = {n: (e1[n]["inference_count"] - e0[n]["inference_count"],
                         e1[n]["execution_count"] - e0[n]["execution_count"])
                     for n in e0}
        # (c) the repository through the client
        del x_dev
        gc.collect()
        mem_before_unload = _allocated()
        t0 = time.perf_counter()
        client.unload_model(ens_name, unload_dependents=True)
        unload_ms = (time.perf_counter() - t0) * 1e3
        gc.collect()
        mem_unloaded = _allocated()
        index = {r["name"]: r for r in client.get_model_repository_index()}
        t0 = time.perf_counter()
        client.load_model("resnet50")
        load_ms = (time.perf_counter() - t0) * 1e3
        mem_reloaded = _allocated()
        again = _resnet_http(client, httpclient, images)
        for name in ("preprocess", ens_name):
            client.load_model(name)
        t0 = time.perf_counter()
        client.load_model("repo_add_sub")
        repo_load_ms = (time.perf_counter() - t0) * 1e3
        a = np.arange(16, dtype=np.int32)
        i0 = httpclient.InferInput("INPUT0", [16], "INT32")
        i0.set_data_from_numpy(a)
        i1 = httpclient.InferInput("INPUT1", [16], "INT32")
        i1.set_data_from_numpy(a)
        repo_out = client.infer("repo_add_sub", [i0, i1]).as_numpy("OUTPUT0")
        t0 = time.perf_counter()
        client.unload_model("repo_add_sub")
        repo_unload_ms = (time.perf_counter() - t0) * 1e3
        repo_index = {r["name"]: r
                      for r in client.get_model_repository_index()}
        # (d) sequences
        rng = np.random.default_rng(4)
        vals = rng.integers(-50, 50, (4, 6)).astype(np.int32)
        sums = np.zeros_like(vals)
        for step in range(vals.shape[1]):
            for sid in range(4):
                sums[sid, step] = _seq_step(
                    client, httpclient, "accumulator", "INPUT",
                    vals[sid, step], 1000 + sid, start=step == 0,
                    end=step == vals.shape[1] - 1).as_numpy("OUTPUT")[0]
        prompt = [int(v) for v in np.random.default_rng(5).integers(
            1, cfg.vocab_size, LM_PROMPT)]
        lm_tokens, tok = [], None
        for i in range(LM_PROMPT + LM_STEPS):
            feed = prompt[i] if i < LM_PROMPT else tok
            tok = int(_seq_step(client, httpclient, "decoder_lm", "TOKEN",
                                feed, 77, start=i == 0).as_numpy(
                "NEXT_TOKEN")[0])
            lm_tokens.append(tok)
        lm_want = _decode_loop(cfg, lm_params, prompt, LM_STEPS, device)
        for _ in range(cfg.max_seq - LM_PROMPT - LM_STEPS):
            _seq_step(client, httpclient, "decoder_lm", "TOKEN", 1, 77)
        try:
            _seq_step(client, httpclient, "decoder_lm", "TOKEN", 1, 77)
            guard = None
        except Exception as e:  # noqa: BLE001 — the guard's answer
            guard = (e.status(), str(e))
        _seq_step(client, httpclient, "decoder_lm", "TOKEN", 1, 77,
                  start=True, end=True)
        perf = _perf_sequences(core, url)
        step_ms = _decode_step_ms(lm, cfg, device)
    finally:
        client.close()
        http.stop()
        core.stop()
        import shutil

        shutil.rmtree(repo_dir, ignore_errors=True)
    launches = {"flash_attention": fa.launches,
                "paged_decode_attention": pa.launches}
    # -------------------------------------------------------- the checks
    tol = MODELS_RTOL * float(np.abs(want).max())
    err = float(np.abs(served.astype(np.float64) - want).max())
    if served.shape != (n_img, n_cls) or not np.isfinite(served).all() \
            or err > tol:
        fail(f"models: resnet50 logits {served.shape}, max |err| {err} "
             f"against the f32 forward, tolerance {tol}")
    top = np.argsort(-want, axis=-1)
    gap = want[np.arange(n_img), top[:, 0]] - want[np.arange(n_img),
                                                   top[:, 1]]
    decided = gap > tol
    if (served.argmax(-1)[decided] != top[decided, 0]).any():
        fail("models: resnet50 top-1 differs from the f32 forward's where "
             "the gap exceeds the tolerance")
    if not np.array_equal(via_shm, served):
        fail("models: the logits over CUDA shm differ from HTTP binary's")
    if not ens_equal:
        fail(f"models: the ensemble {ens_name} differs from its steps "
             "called one after the other")
    for name, (n, execs) in ens_execs.items():
        if n != n_img or execs != 1:
            fail(f"models: {name} counted {n} inferences in {execs} "
                 f"executions for one ensemble request of {n_img}")
    freed = mem_before_unload - mem_unloaded
    if freed < weight_bytes:
        fail(f"models: unloading freed {freed} bytes, less than the "
             f"weights' {weight_bytes}")
    if (index["resnet50"]["state"], index["resnet50"]["reason"]) != (
            "UNAVAILABLE", "unloaded"):
        fail(f"models: the index read resnet50 as {index['resnet50']}")
    if not np.array_equal(again, served):
        fail("models: the reloaded resnet50's logits differ")
    if not np.array_equal(repo_out, a + a) \
            or repo_index["repo_add_sub"]["state"] != "UNAVAILABLE":
        fail(f"models: the repository model answered {repo_out}, index "
             f"{repo_index.get('repo_add_sub')}")
    if not np.array_equal(sums, np.cumsum(vals, axis=1)):
        fail(f"models: accumulator sums {sums.tolist()}")
    if lm_tokens != lm_want:
        first = next(i for i, (x, y) in enumerate(zip(lm_tokens, lm_want))
                     if x != y)
        fail(f"models: decoder_lm differs from the decode_step loop at "
             f"step {first}")
    if guard is None or "max context length" not in guard[1]:
        fail(f"models: the guard at max_seq answered {guard}")
    if perf["run_failed_requests"] or perf["client_rejected"] \
            or not perf["sequences_started"] \
            or perf["sequences_started"] != perf["sequences_ended"] \
            or perf["live_sequences_after"]:
        fail(f"models: the perf analyzer's sequence mode: {perf}")
    if any(launches.values()):
        fail(f"models: K1/K2 launched in the phase: {launches}")
    result = {
        "phase": "models", "card": card,
        "resnet50": {
            "images": n_img, "max_abs_err_vs_f32": err, "tolerance": tol,
            "top1_decided": int(decided.sum()),
            "shm_bit_equal": True, "forward_ms_batch8": forward_ms,
            "server_window": window, "weights_bytes": weight_bytes,
            "memory_allocated_for_weights": mem_loaded - mem0},
        "ensemble": {"name": ens_name, "bit_equal_to_steps": ens_equal,
                     "inferences_and_executions": ens_execs},
        "repository": {"unload_ms": unload_ms, "load_ms": load_ms,
                       "freed_bytes": freed,
                       "reload_allocated_bytes":
                           mem_reloaded - mem_unloaded,
                       "repo_load_ms": repo_load_ms,
                       "repo_unload_ms": repo_unload_ms},
        "sequences": {"accumulator_ids": 4, "decoder_lm_tokens":
                      len(lm_tokens), "guard": {"status": guard[0],
                                                "error": guard[1]},
                      "perf": perf, **step_ms},
        "launches": launches}
    emit(result)
    return result


# ------------------------------------------------- generators (ROADMAP 7a)

# prompt lengths covering the step path (1) and every prefill bucket (8,
# 16, 64, 128); chunk 8 and a budget of 21: two chunks and a tail of 5
GENLM_PROMPTS = (1, 8, 9, 33, 100)
GENLM_CHUNK, GENLM_BUDGET = 8, 21
GENLM_BATCH, GENLM_BATCH_PROMPT, GENLM_BATCH_BUDGET = 8, 16, 64
# where the generators and the fleet run: the card (a CPU rehearsal sets
# "cpu"; nothing here falls back to it)
LM_DEVICE = "cuda"


def _lm_request(name: str, inputs: dict, tenant: str = "default"):
    """An InferRequest of host tensors (INT32, or FP32 for floats)."""
    from client_tpu_torch.server.types import InferRequest, InferTensor

    return InferRequest(model_name=name, tenant_id=tenant, inputs=[
        InferTensor(k, "FP32" if v.dtype.kind == "f" else "INT32",
                    tuple(v.shape), data=v) for k, v in inputs.items()])


def _stream_rows(core, name: str, inputs: dict, label: str,
                 tenant: str = "default") -> tuple:
    """Serve one decoupled request through ``core.infer`` with a response
    callback: (the output rows in order, the seconds from the call to the
    first row, to the final flag). Fails on an error or a row after the
    final flag."""
    rows, stamps, errors, finals = [], [], [], []

    def cb(resp, final):
        if resp.error is not None:
            errors.append(f"{resp.error_status} {resp.error}")
        elif final:
            finals.append(time.perf_counter())
        else:
            if finals:
                errors.append("a row after the final flag")
            stamps.append(time.perf_counter())
            rows.append(np.asarray(resp.outputs[0].data).reshape(-1))

    t0 = time.perf_counter()
    core.infer(_lm_request(name, inputs, tenant), response_callback=cb)
    if errors or len(finals) != 1:
        fail(f"{label}: {errors[:3]}, {len(finals)} final flags")
    return rows, (stamps[0] - t0 if stamps else None), finals[0] - t0


def _loop_profile(cfg, params, knobs) -> dict:
    """One chunk of ``sample_loop`` (GENLM_CHUNK eager steps on a one-slot
    state at position 64) and one tail of 5 ``sample_step``s, the way the
    single-stream generator runs them: wall ms per token (host clock
    around the work and its one fetch), the host ms to enqueue a chunk,
    and by torch.profiler the chunk's kernel launches and busy ms."""
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.models import sampling as sm
    from client_tpu_torch.models import transformer as t

    def state():
        st = t.init_decode_state(cfg, 1, LM_DEVICE)
        st["pos"].fill_(64)
        return st

    tok = torch.full((1,), 7, dtype=torch.int32, device=LM_DEVICE)

    def chunk():
        return sm.sample_loop(cfg, params, tok, state(), GENLM_CHUNK,
                              *knobs)[0]

    def tail():
        st, nxt, cols = state(), tok, []
        for i in range(5):
            cols.append(nxt)
            if i < 4:
                nxt, st = sm.sample_step(cfg, params, nxt, st, *knobs)
        return torch.stack(cols, dim=-1)

    with torch.inference_mode():
        for fn in (chunk, tail):
            fn().cpu()
        torch.cuda.synchronize()
        per_tok = {}
        for key, fn, n in (("chunk", chunk, GENLM_CHUNK), ("tail", tail, 5)):
            t0 = time.perf_counter()
            for _ in range(10):
                fn().cpu()
            per_tok[key] = (time.perf_counter() - t0) / 10 / n * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chunk()
        host_ms = (time.perf_counter() - t0) * 1e3
        out.cpu()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chunk().cpu()
            torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    for evt in prof.key_averages():
        busy_us += getattr(evt, "self_device_time_total", 0.0)
        if evt.key.startswith("cudaLaunchKernel"):
            launches += evt.count
    return {"ms_per_token_in_chunk": per_tok["chunk"],
            "ms_per_token_in_tail": per_tok["tail"],
            "host_ms_per_chunk": host_ms,
            "kernel_launches_per_chunk": launches,
            "device_busy_ms_per_chunk": busy_us / 1e3 if busy_us else None}


def phase_generators(env: dict) -> dict:
    """The single-stream and static-batch generators (ROADMAP 7a) at the
    reference's default decode config, served through
    TorchInferenceServer.infer with a response callback."""
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.models.decoder_lm import (
        _sampling_tensors,
        decode_config,
        make_batch_generator,
        make_generator,
    )
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import TorchInferenceServer

    cfg = decode_config(attn_impl="ref")
    gen = torch.Generator(device=LM_DEVICE)
    gen.manual_seed(0)
    params = t.init_params(gen, cfg)
    core = TorchInferenceServer()
    core.register_model(make_generator(cfg=cfg, params=params,
                                       chunk_size=GENLM_CHUNK,
                                       device=LM_DEVICE))
    core.register_model(make_batch_generator(
        cfg=cfg, params=params, max_batch=GENLM_BATCH,
        chunk_size=GENLM_CHUNK, device=LM_DEVICE))
    rng = np.random.default_rng(11)
    prompts = {n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in GENLM_PROMPTS}
    budget = np.asarray([GENLM_BUDGET], np.int32)
    batch = rng.integers(0, cfg.vocab_size,
                         (GENLM_BATCH, GENLM_BATCH_PROMPT)).astype(np.int32)

    def single(prompt, label, **extra):
        rows, ttft, total = _stream_rows(
            core, "generator_lm", {"PROMPT": prompt, "MAX_TOKENS": budget,
                                   **extra}, label)
        return [int(r[0]) for r in rows], ttft, total

    def batched(b, label):
        rows, ttft, total = _stream_rows(core, "batch_generator_lm", {
            "PROMPTS": batch[:b],
            "MAX_TOKENS": np.full((b, 1), GENLM_BATCH_BUDGET, np.int32)},
            label)
        return np.stack(rows, axis=1), total

    try:
        # warm: parameters on the card, cuBLAS handles, every bucket
        for n in GENLM_PROMPTS:
            single(prompts[n], "generators warmup")
        batched(GENLM_BATCH, "generators warmup")
        # the main path: counters at 0 just before, read just after
        pa.launches = fa.launches = 0
        greedy, ttft = {}, {}
        for n in GENLM_PROMPTS:
            greedy[n], ttft[n], _ = single(prompts[n], f"prompt {n}")
        rows8, wall8 = batched(GENLM_BATCH, "batch 8")
        rows1, wall1 = batched(1, "batch 1")
        sampled = [single(prompts[33], f"sampled {k}",
                          TEMPERATURE=np.asarray([0.8], np.float32),
                          TOP_K=np.asarray([40], np.int32),
                          SEED=np.asarray([5], np.int32))[0]
                   for k in range(2)]
        top1 = single(prompts[33], "top_k 1",
                      TEMPERATURE=np.asarray([0.8], np.float32),
                      TOP_K=np.asarray([1], np.int32),
                      SEED=np.asarray([3], np.int32))[0]
        k2, k1 = pa.launches, fa.launches
    finally:
        core.stop()
    for n, toks in greedy.items():
        if len(toks) != GENLM_BUDGET or not all(
                0 <= x < cfg.vocab_size for x in toks):
            fail(f"generators: prompt {n} streamed {len(toks)} tokens of "
                 f"{GENLM_BUDGET} or a token outside the vocab")
    if rows8.shape != (GENLM_BATCH, GENLM_BATCH_BUDGET) \
            or rows1.shape != (1, GENLM_BATCH_BUDGET):
        fail(f"generators: batch rows {rows8.shape}, {rows1.shape}")
    if sampled[0] != sampled[1]:
        fail("generators: one seed gave two sampled streams")
    if sampled[0] == greedy[33]:
        fail("generators: the sampled stream equals the greedy one")
    if top1 != greedy[33]:
        fail("generators: TOP_K = 1 differs from greedy")
    if k2 or k1:
        fail(f"generators: K2 launched {k2} and K1 {k1} times (the "
             f"generators run the einsum attention)")
    runs = [{"run": "generator_lm", "greedy_streams": [
        (np.concatenate([prompts[n], np.asarray(greedy[n], np.int32)]),
         n) for n in GENLM_PROMPTS]},
        {"run": "batch_generator_lm", "greedy_streams": [
            (np.concatenate([batch[i], rows8[i]]), GENLM_BATCH_PROMPT)
            for i in range(GENLM_BATCH)]}]
    _judge_greedy(cfg, params, runs)
    knobs = _sampling_tensors(LM_DEVICE, 0, 0.0, 0, 0.0)
    result = {
        "phase": "generators", "card": env["nvidia_smi"],
        "config": {"vocab": cfg.vocab_size, "d_model": cfg.d_model,
                   "n_layers": cfg.n_layers, "max_seq": cfg.max_seq,
                   "dtype": "bfloat16", "chunk": GENLM_CHUNK,
                   "budget": GENLM_BUDGET},
        "ttft_ms_by_prompt": {str(n): v * 1e3 for n, v in ttft.items()},
        **_loop_profile(cfg, params, knobs),
        "batch_tokens_per_s": {
            "B8": GENLM_BATCH * GENLM_BATCH_BUDGET / wall8,
            "B1": GENLM_BATCH_BUDGET / wall1},
        "batch_speedup_B8_over_B1": GENLM_BATCH * wall1 / wall8,
        "same_seed_same_stream": True, "top_k1_equals_greedy": True,
        "teacher_forced": {r["run"]: r["teacher_forced"] for r in runs},
        "launches": {"paged_decode_attention": k2, "flash_attention": k1}}
    emit(result)
    return result


# ------------------------------------------- replica fleet (ROADMAP 7b)

# the reference fleet benchmark's settings and full-scale workload
# (benchmarks/bench_fleet_router.py): 8 tenants x 4 requests of a
# 64-token tenant prefix and an 8-token suffix, budget 8
FLEET_TENANTS, FLEET_REQS, FLEET_PREFIX, FLEET_SUFFIX, FLEET_BUDGET = \
    8, 4, 64, 8, 8
FLEET_KNOBS = dict(n_slots=4, chunk_size=4, prefix_cache=True,
                   prefix_block_len=16, prefill_mode="chunked",
                   prefill_chunk=32, kv_layout="paged",
                   kv_block_len=16, max_new_tokens=FLEET_BUDGET)
FLEET_CHUNK = 4
FLEET_ROUTE_CALLS = 2000


def _fleet_workload(vocab: int, seed: int = 7) -> dict:
    """The benchmark's build_workload: tenant t's requests share its
    prefix and differ in the suffix."""
    rng = np.random.default_rng(seed)
    work = {}
    for t in range(FLEET_TENANTS):
        prefix = rng.integers(1, vocab, size=FLEET_PREFIX).astype(np.int32)
        work[f"tenant{t}"] = [np.concatenate([prefix, rng.integers(
            1, vocab, size=FLEET_SUFFIX).astype(np.int32)])
            for _ in range(FLEET_REQS)]
    return work


@contextlib.contextmanager
def _k2_by_thread(tally: dict):
    """Tally K2 calls by the calling thread (each replica's engine runs on
    its own; keyed by the Thread object, whose identity, unlike an ident,
    is never reused): the transformer's reference to the wrapper is
    wrapped for the block, and the wrapper itself still counts every
    launch."""
    from client_tpu_torch.models import transformer as t

    real = t.paged_decode_attention
    lock = threading.Lock()

    def counted(*args, **kw):
        out = real(*args, **kw)
        with lock:
            key = threading.current_thread()
            tally[key] = tally.get(key, 0) + 1
        return out

    t.paged_decode_attention = counted
    try:
        yield
    finally:
        t.paged_decode_attention = real


def _fleet_arm(label: str, cfg, params, work: dict, replicas: int,
               policy: str, drain: bool = False, mesh=None,
               attach: bool = False) -> dict:
    """Serve the workload through a replica fleet behind
    TorchInferenceServer.infer (one thread per tenant, its requests one
    after another), the HTTP front end up with the debug endpoints. With
    ``drain``, replica 0 is drained once 16 tokens have streamed; with
    ``attach`` a replica is attached (warmed on a short stream) after it.
    ``mesh`` puts every replica over that mesh (the fleet's plans on its
    one channel)."""
    from client_tpu_torch.models.decoder_lm import make_replica_fleet
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server import trace as trace_mod
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.server.metrics import (
        parse_prometheus_text,
        sample_value,
    )

    name = f"fleet_{label}"
    model = make_replica_fleet(
        name, replicas=replicas,
        fleet={"replicas": replicas, "policy": policy,
               "affinity_block_len": 16, "random_seed": 0},
        cfg=cfg, params=params,
        **({"device": LM_DEVICE} if mesh is None else {"mesh": mesh}),
        **FLEET_KNOBS)
    fleet = model.fleet
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)   # one stream per replica
    srv = HttpInferenceServer(core, port=0, debug_endpoints=True).start()
    streams, errors, tally = {}, [], {}
    started = threading.Event()
    delivered = [0]
    lock = threading.Lock()

    def tenant(t, reqs):
        for i, prompt in enumerate(reqs):
            toks, finals = [], []

            def cb(resp, final):
                if resp.error is not None:
                    errors.append(f"{t}/{i}: {resp.error_status} "
                                  f"{resp.error}")
                elif final:
                    finals.append(1)
                else:
                    toks.append(int(resp.output("TOKEN").data[0]))
                    with lock:
                        delivered[0] += 1
                        if delivered[0] >= 16:
                            started.set()

            try:
                core.infer(_lm_request(name, {
                    "PROMPT": prompt,
                    "MAX_TOKENS": np.asarray([FLEET_BUDGET], np.int32)},
                    tenant=t), response_callback=cb)
            except Exception as e:  # noqa: BLE001 — failed below
                errors.append(f"{t}/{i}: {type(e).__name__}: {e}")
            streams[(t, i)] = (toks, len(finals))

    engines = {}   # engine thread -> replica, old engines included

    def note_engines():
        for r in fleet.replicas:
            th = getattr(r.engine, "_thread", None)
            if th is not None:
                engines[th] = r.idx

    note_engines()
    seen = {id(r.engine): r.engine for r in fleet.replicas}
    before = {id(e): e.stats()["dispatch_by_kind"]["chunk"]["dispatches"]
              for e in seen.values()}
    owner = {id(r.engine): r.idx for r in fleet.replicas}
    drain_ms = None
    threads = [threading.Thread(target=tenant, args=(t, reqs))
               for t, reqs in work.items()]
    try:
        with _k2_by_thread(tally):
            # the main path: the K2 counter at 0 just before, read after
            pa.launches = 0
            t0 = time.time()
            for th in threads:
                th.start()
            if drain:
                if not started.wait(120):
                    fail(f"{label}: no stream started")
                old = fleet.replicas[0].engine
                d0 = time.perf_counter()
                ok = fleet.drain(0, timeout=120)
                drain_ms = (time.perf_counter() - d0) * 1e3
                if not ok or fleet.replicas[0].engine is old:
                    fail(f"{label}: the drain of replica 0 did not "
                         f"complete ({ok})")
                new = fleet.replicas[0].engine
                seen[id(new)] = new
                # the fresh engine's first submit, if it gets one, readies
                # it with its two warm chunk launches, which no dispatch
                # counts (None: counted at the end)
                before[id(new)] = None
                owner[id(new)] = 0
            if attach:
                idx = fleet.attach_replica(
                    warm_prompt=np.zeros(4, np.int32))
                new = fleet.replicas[-1].engine
                seen[id(new)] = new
                before[id(new)] = None
                owner[id(new)] = idx
            for th in threads:
                th.join(timeout=600)
            wall_s = time.time() - t0
            k2 = pa.launches
        note_engines()
        chunks = {}
        for key, eng in seen.items():
            base = before[key]
            if base is None:
                base = -WARM_CHUNKS if eng._started else 0
            n = eng.stats()["dispatch_by_kind"]["chunk"]["dispatches"] \
                - base
            chunks[owner[key]] = chunks.get(owner[key], 0) + n
        gen = model.generation_stats()
        plans_sent = fleet.plans.sent if fleet.plans is not None else 0
        snap = model.fleet_snapshot()
        url = f"http://{srv.url}"
        status, body = _get(f"{url}/v2/debug/fleet")
        debug = json.loads(body) if status == 200 else None
        status_m, text = _get(f"{url}/metrics")
        parsed = parse_prometheus_text(text.decode())
        # one traced stream: its trace must carry the routing decision
        core.tracer.update_settings("", {"trace_level": ["TIMESTAMPS"],
                                         "trace_rate": "1"})
        probe = work["tenant0"][0]
        _stream_rows(core, name, {"PROMPT": probe, "MAX_TOKENS":
                                  np.asarray([2], np.int32)},
                     f"{label} traced", tenant="tenant0")
        traced = [tr for tr in list(core.tracer.completed)
                  if tr.model_name == name]
        route_spans = [e for tr in traced for e in tr.timestamps
                       if e[0] == trace_mod.FLEET_ROUTE]
        core.tracer.update_settings("", {"trace_level": ["OFF"]})
        route_us = None
        if replicas > 1:
            t1 = time.perf_counter()
            for k in range(FLEET_ROUTE_CALLS):
                fleet.route(work[f"tenant{k % FLEET_TENANTS}"][0],
                            f"tenant{k % FLEET_TENANTS}")
            route_us = ((time.perf_counter() - t1) / FLEET_ROUTE_CALLS
                        * 1e6)
    finally:
        srv.stop()
        core.stop()
    if errors or any(th.is_alive() for th in threads):
        fail(f"{label}: {errors[:3]}")
    short = {f"{t}/{i}": (len(v[0]), v[1]) for (t, i), v in streams.items()
             if len(v[0]) != FLEET_BUDGET or v[1] != 1}
    if short or len(streams) != FLEET_TENANTS * FLEET_REQS:
        fail(f"{label}: streams short of their budget: {short}")
    by_replica = {}
    for th, n in tally.items():
        if th not in engines:
            fail(f"{label}: K2 launched from a thread of no replica")
        by_replica[engines[th]] = by_replica.get(engines[th], 0) + n
    # the drained replica's chunks include its fresh engine's warm chunks
    per = LAYERS * FLEET_CHUNK
    if sum(by_replica.values()) != k2 or any(
            by_replica.get(r, 0) != per * chunks.get(r, 0)
            for r in set(chunks) | set(by_replica)):
        fail(f"{label}: K2 launches {k2}, by replica {by_replica}, for "
             f"chunk dispatches {chunks}: expected {per} per dispatch")
    rows = {r["replica"]: r for r in snap["rows"]}
    routed = {r: rows[r]["routed"] for r in sorted(rows)}
    if sum(routed.values()) != FLEET_TENANTS * FLEET_REQS:
        fail(f"{label}: routed {routed}")
    # the snapshot, /v2/debug/fleet and /metrics were read together,
    # before the traced stream and the timed route calls
    debug_routed = None if debug is None else {
        r["replica"]: r["routed"]
        for r in debug["models"][0]["fleet"]["rows"]}
    if debug_routed != routed:
        fail(f"{label}: /v2/debug/fleet reads {debug_routed}, the fleet "
             f"{routed}")
    metric_routed = {r: sample_value(parsed, "client_tpu_fleet_routed_total",
                                     {"model": name, "replica": str(r)})
                     for r in routed}
    if status_m != 200 or metric_routed != routed:
        fail(f"{label}: /metrics routed {metric_routed}, fleet {routed}")
    if len(route_spans) != 1:
        fail(f"{label}: {len(route_spans)} FLEET_ROUTE spans on the "
             f"traced stream")
    lookups = gen["prefix_hits"] + gen["prefix_misses"]
    return {
        "run": label, "replicas": replicas, "policy": policy,
        "streams": len(streams), "wall_s": wall_s,
        "tokens_per_s": FLEET_TENANTS * FLEET_REQS * FLEET_BUDGET / wall_s,
        "prefix_hits": gen["prefix_hits"],
        "prefix_misses": gen["prefix_misses"],
        "prefix_hit_rate": gen["prefix_hits"] / lookups if lookups else 0.0,
        "routed": routed,
        "affinity_hits": sum(r["affinity_hits"] for r in rows.values()),
        "rerouted": sum(r["rerouted"] for r in rows.values()),
        "drains": {r: rows[r]["drains"] for r in rows},
        "drain_ms": drain_ms, "failed_streams": 0,
        "chunk_dispatches_by_replica": chunks,
        "paged_decode_attention_launches": k2,
        "paged_decode_attention_launches_by_replica": by_replica,
        "host_us_per_route": route_us,
        "host_ms_per_dispatch": gen["phase_seconds"].get("dispatch", 0.0)
        / max(1, gen["chunks_dispatched"]) * 1e3,
        "plans_sent": plans_sent,
        "fleet_route_span": route_spans[0][2]["leg"],
        "tokens": {f"{t}/{i}": v[0] for (t, i), v in streams.items()},
        "greedy_streams": [
            (np.concatenate([work[t][i], np.asarray(v[0], np.int32)]),
             len(work[t][i])) for (t, i), v in sorted(streams.items())]}


def phase_fleet(gen_model: tuple, env: dict) -> dict:
    """The replica fleet router (ROADMAP 7b's fleet half): two replicas of
    bench.py's generation model on one card, paged with K2."""
    import dataclasses

    cfg, params, _ = gen_model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    work = _fleet_workload(cfg.vocab_size)
    t0 = time.time()
    arms = [_fleet_arm("affinity", cfg, params, work, 2, "affinity"),
            _fleet_arm("random", cfg, params, work, 2, "random"),
            _fleet_arm("one_replica", cfg, params, work, 1, "affinity"),
            _fleet_arm("drain", cfg, params, work, 2, "affinity",
                       drain=True)]
    t1 = time.time()
    by = {a["run"]: a for a in arms}
    if not by["affinity"]["prefix_hit_rate"] \
            > by["random"]["prefix_hit_rate"]:
        fail(f"fleet: affinity's hit rate "
             f"{by['affinity']['prefix_hit_rate']} does not beat random's "
             f"{by['random']['prefix_hit_rate']}")
    if by["drain"]["drains"][0] != 1:
        fail(f"fleet: replica 0 drained {by['drain']['drains']} times")
    ref = by["one_replica"].pop("tokens")
    differ = {}
    for arm in ("affinity", "random", "drain"):
        toks = by[arm].pop("tokens")
        differ[arm] = sorted(k for k in ref if toks[k] != ref[k])
    _judge_greedy(cfg, params, arms)
    if any(differ.values()):
        fail(f"fleet: greedy streams differ from the one-replica arm's: "
             f"{ {k: v[:4] for k, v in differ.items()} }")
    result = {"phase": "fleet", "card": env["nvidia_smi"],
              "workload": {"tenants": FLEET_TENANTS,
                           "requests_per_tenant": FLEET_REQS,
                           "prefix": FLEET_PREFIX, "suffix": FLEET_SUFFIX,
                           "budget": FLEET_BUDGET},
              "runs": arms,
              "greedy_streams_equal_to_one_replica": {
                  k: FLEET_TENANTS * FLEET_REQS - len(v)
                  for k, v in differ.items()},
              "seconds": {"serve": t1 - t0, "judge": time.time() - t1}}
    emit(result)
    return result



# the reference autoscale benchmark's settings (benchmarks/bench_autoscale.py):
# gold holds objectives it always meets, flood an unmeetable 1 ms TTFT, so
# the flood burns its own budget (the scale signal) and gold's stays 0
AUTOSCALE_SLO_CLASSES = [
    {"name": "gold", "ttft_ms": 60000.0, "itl_ms": 60000.0,
     "queue_wait_ms": 60000.0},
    {"name": "flood", "ttft_ms": 1.0},
]
AUTOSCALE_WINDOW_S = 3.0
AUTOSCALE_PREFIX, AUTOSCALE_SUFFIX, AUTOSCALE_REQS = 24, 8, 4
AUTOSCALE_BANDS = {"min_replicas": 1, "max_replicas": 3,
                   "burn_high": 1.0, "burn_low": 0.2,
                   "queue_high": 6, "queue_low": 1,
                   "hold_rounds": 2, "idle_rounds": 4,
                   "cooldown_s": 0.25, "warm_tokens": 2, "interval_s": 0}
AUTOSCALE_PINNED = {"min_replicas": 2, "max_replicas": 2,
                    "hold_rounds": 10_000, "idle_rounds": 10_000,
                    "cooldown_s": 0.0, "warm_tokens": 2, "interval_s": 0}
CANARY_GATES = {"split_pct": 50, "soak_s": 1.5, "min_requests": 4,
                "burn_abs_max": 1.0, "burn_ratio_max": 1.5,
                "ttft_p95_ratio_max": 3.0, "mfu_ratio_min": 0.5}
CANARY_DELAY_S = 0.4
AUTOSCALE_STEP_S = 0.05
AUTOSCALE_TIMEOUT_S = 150.0
# a detached or swapped-out engine must give its memory back: what stays
# allocated after an arm may exceed the level before by at most this
# share of one replica's footprint
AUTOSCALE_MEM_SLACK = 0.25


def _quiet_allocated() -> int:
    """memory_allocated with no engine running, less PyTorch's cuBLAS
    workspaces: each thread's cuBLAS handle keeps one (32 MiB on the
    H100) for the life of the process, whatever engine ran on it."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return _allocated()


def _autoscale_workload(vocab: int, tenants: list, seed: int = 7) -> dict:
    """The benchmark's build_workload: tenant t's requests share its
    24-token prefix and differ in the 8-token suffix."""
    rng = np.random.default_rng(seed)
    work = {}
    for t in tenants:
        prefix = rng.integers(1, vocab, size=AUTOSCALE_PREFIX).astype(
            np.int32)
        work[t] = [np.concatenate([prefix, rng.integers(
            1, vocab, size=AUTOSCALE_SUFFIX).astype(np.int32)])
            for _ in range(AUTOSCALE_REQS)]
    return work


def _split_tenants(split_pct: int, n_canary: int, n_stable: int) -> tuple:
    """Tenant names on each side of the router's tenant-hash split
    (crc32(tenant) % 100 < split_pct routes to the canary)."""
    import zlib

    canary, stable, i = [], [], 0
    while len(canary) < n_canary or len(stable) < n_stable:
        name = f"tenant{i}"
        i += 1
        if zlib.crc32(name.encode()) % 100 < split_pct:
            if len(canary) < n_canary:
                canary.append(name)
        elif len(stable) < n_stable:
            stable.append(name)
    return canary, stable


class _FleetWatch:
    """Watches one autoscaled fleet through an arm: times every attach,
    detach and drain (the verbs are wrapped on the fleet object, which the
    controller calls), maps each engine thread to its replica for the K2
    tally, keeps each replica's routed count, counts each engine's chunk
    dispatches inside the window (an engine started inside it adds its two
    warm chunks), samples the replica count, and after each round that
    took an engine out (a detach, a drain-swap) requires that engine to be
    collected and reads memory_allocated."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.threads = {}     # engine thread -> replica
        self.base = {}        # id(engine) -> dispatches at the window start
        self.live = {}        # id(engine) -> (replica, engine)
        self.chunks = {}      # replica -> chunk dispatches in the window
        self.routed = {}      # replica -> streams the router admitted
        self.ms = {"attach": [], "detach": [], "drain": []}
        self.after_detach = []
        self.left = []        # weak references to the engines taken out
        self.freed = 0
        self.detached = False
        self.timeline = []
        self.t0 = time.time()
        attach, detach, drain = (fleet.attach_replica, fleet.detach_replica,
                                 fleet.drain)

        def attach_timed(*args, **kw):
            t = time.perf_counter()
            out = attach(*args, **kw)
            self.ms["attach"].append((time.perf_counter() - t) * 1e3)
            self.note()
            return out

        def leaving(verb, real):
            def call(replica, *args, **kw):
                self.note()
                old = next(r.engine for r in fleet.replicas
                           if r.idx == replica)
                t = time.perf_counter()
                out = real(replica, *args, **kw)
                self.ms[verb].append((time.perf_counter() - t) * 1e3)
                self.retire(old)
                self.left.append(weakref.ref(old))
                del old
                # read memory once the caller's frame (the controller's
                # round holds the victim) has let the engine go
                self.detached |= verb == "detach"
                self.note()
                return out
            return call

        fleet.attach_replica = attach_timed
        fleet.detach_replica = leaving("detach", detach)
        fleet.drain = leaving("drain", drain)

    @staticmethod
    def _dispatches(engine) -> int:
        return engine.stats()["dispatch_by_kind"]["chunk"]["dispatches"]

    def start(self) -> None:
        """The window starts: every engine now in the fleet has warmed."""
        for r in self.fleet.replicas:
            self.base[id(r.engine)] = self._dispatches(r.engine)
        self.note()

    def note(self) -> None:
        for r in self.fleet.replicas:
            eng = r.engine
            self.live.setdefault(id(eng), (r.idx, eng))
            self.base.setdefault(id(eng), -WARM_CHUNKS)
            self.routed[r.idx] = r.routed
            th = getattr(eng, "_thread", None)
            if th is not None:
                self.threads[th] = r.idx
        n = len(self.fleet.replicas)
        if not self.timeline or self.timeline[-1][1] != n:
            self.timeline.append((round(time.time() - self.t0, 3), n))

    def retire(self, engine) -> None:
        """Count a leaving engine's dispatches and drop the reference, so
        its pool can be freed (an engine never started dispatched
        nothing)."""
        idx, eng = self.live.pop(id(engine), (None, None))
        if eng is not None and getattr(eng, "_thread", None) is not None:
            self.chunks[idx] = (self.chunks.get(idx, 0)
                                + self._dispatches(eng) - self.base[id(eng)])

    def settle(self) -> None:
        """After a control round (whose frame held the victim): every
        engine it took out must be collected, its pool with it; read
        memory_allocated if it detached a replica."""
        self.note()
        if not self.left:
            return
        gc.collect()
        alive = [r() for r in self.left if r() is not None]
        if alive:
            fail(f"autoscale: {len(alive)} engine(s) taken out of the fleet "
                 f"are still referenced: {[e.name for e in alive]}")
        self.freed += len(self.left)
        self.left = []
        if self.detached:
            self.detached = False
            self.after_detach.append(_allocated())

    def close(self) -> None:
        """The arm is over: count the engines still in the fleet and let
        the fleet go."""
        self.note()
        for _idx, eng in list(self.live.values()):
            self.retire(eng)
        self.fleet = None


def _warm_fleet(model, sample) -> None:
    """One warm stream per replica outside the window, and the
    controller's warm prompt pointed at the workload's shape (an attached
    or canary replica warms on it)."""
    for rep in model.fleet.replicas:
        list(rep.engine.submit(sample, 2))
    model.autoscaler.warm_prompt = sample


def _autoscale_model(name: str, cfg, params, replicas: int, autoscale: dict,
                     canary=None):
    from client_tpu_torch.models.decoder_lm import make_replica_fleet

    return make_replica_fleet(
        name, replicas=replicas,
        fleet={"replicas": replicas, "policy": "affinity",
               "affinity_block_len": 16},
        cfg=cfg, params=params, device=LM_DEVICE,
        slo_classes=AUTOSCALE_SLO_CLASSES, slo_window_s=AUTOSCALE_WINDOW_S,
        autoscale=autoscale, canary=canary, **FLEET_KNOBS)


def _tenant_threads(fleet, work: dict, slo_for, streams: dict, errors: list,
                    stop=None) -> list:
    """One thread per tenant, its requests one after another (with
    ``stop``, resubmitted round and round until it is set); every stream's
    tokens land in ``streams[(tenant, k)]``."""
    lock = threading.Lock()

    def worker(tenant, reqs):
        k = 0
        while k < len(reqs) or (stop is not None and not stop.is_set()):
            prompt = reqs[k % len(reqs)]
            try:
                toks = list(fleet.submit(prompt, FLEET_BUDGET,
                                         tenant_id=tenant,
                                         slo_class=slo_for(tenant)))
                with lock:
                    streams[(tenant, k)] = (k % len(reqs), toks)
            except Exception as e:  # noqa: BLE001 — failed below
                with lock:
                    errors.append(f"{tenant}/{k}: {type(e).__name__}: {e}")
            k += 1
            if stop is None and k >= len(reqs):
                break

    return [threading.Thread(target=worker, args=(t, reqs), daemon=True)
            for t, reqs in work.items()]


def _step_rounds(ctl, watch, rounds: list, until, observe=None,
                 label: str = "") -> None:
    """Step the controller on this thread until ``until()``: every round's
    wall ms and its decisions are kept."""
    t_end = time.time() + AUTOSCALE_TIMEOUT_S
    while not until():
        if time.time() > t_end:
            fail(f"autoscale {label}: the control loop did not converge "
                 f"within {AUTOSCALE_TIMEOUT_S} s (replicas "
                 f"{len(watch.fleet.replicas)})")
        t = time.perf_counter()
        out = ctl.step()
        rounds.append(((time.perf_counter() - t) * 1e3,
                       [d["action"] for d in out]))
        watch.settle()
        if observe is not None:
            observe()
        time.sleep(AUTOSCALE_STEP_S)


def _rounds_summary(rounds: list, ring: list) -> dict:
    ms = sorted(r[0] for r in rounds)
    first = ring[0]["ns"] if ring else 0
    return {"rounds": len(rounds),
            "round_ms_p50": ms[len(ms) // 2] if ms else None,
            "round_ms_max": ms[-1] if ms else None,
            "acting_rounds": [{"ms": r[0], "actions": r[1]}
                              for r in rounds if r[1]],
            "ring": [{"at_ms": (d["ns"] - first) / 1e6,
                      "action": d["action"], "replica": d.get("replica"),
                      "replicas": d["replicas"]} for d in ring]}


def _arm_k2(label: str, watch, tally: dict, k2: int) -> dict:
    by_replica = {}
    for th, n in tally.items():
        if th not in watch.threads:
            fail(f"{label}: K2 launched from a thread of no replica")
        r = watch.threads[th]
        by_replica[r] = by_replica.get(r, 0) + n
    per = LAYERS * FLEET_CHUNK
    if sum(by_replica.values()) != k2 or any(
            by_replica.get(r, 0) != per * watch.chunks.get(r, 0)
            for r in set(watch.chunks) | set(by_replica)):
        fail(f"{label}: K2 launches {k2}, by replica {by_replica}, for "
             f"chunk dispatches {watch.chunks}: expected {per} per dispatch")
    return by_replica


def _arm_streams(label: str, streams: dict, errors: list, work: dict,
                 routed: dict, by_replica: dict) -> list:
    """Zero failed streams, every budget full, every replica that served
    launched K2, and every stream of one prompt the same tokens; returns
    one greedy stream per prompt for the teacher-forced judge."""
    if errors:
        fail(f"{label}: failed streams {errors[:3]}")
    short = [k for k, (_, toks) in streams.items()
             if len(toks) != FLEET_BUDGET]
    if short:
        fail(f"{label}: streams short of their budget: {short[:5]}")
    idle = [r for r, n in routed.items() if n and not by_replica.get(r)]
    if idle:
        fail(f"{label}: replicas {idle} served without a K2 launch")
    first, differ = {}, []
    for (tenant, k), (i, toks) in sorted(streams.items()):
        key = (tenant, i)
        if key in first and first[key] != toks:
            differ.append(f"{tenant}/{k}")
        first.setdefault(key, toks)
    if differ:
        fail(f"{label}: streams of one prompt differ: {differ[:5]}")
    return [(np.concatenate([work[t][i], np.asarray(toks, np.int32)]),
             len(work[t][i])) for (t, i), toks in sorted(first.items())]


def _autoscale_overload(cfg, params) -> dict:
    """(a) the overload arm: one replica, 16 flood tenants and 2 gold
    tenants resubmitting until the fleet holds 3 replicas and the flood's
    burn crossed 1.0; then idle until it is back at 1."""
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import trace as trace_mod

    bands = AUTOSCALE_BANDS
    flood = [f"flood{i}" for i in range(16)]
    gold = ["gold0", "gold1"]
    work = _autoscale_workload(cfg.vocab_size, flood + gold)
    mem_before = _quiet_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = _autoscale_model("autoscale_lm", cfg, params, 1, bands)
    fleet, ctl = model.fleet, model.autoscaler
    sample = work["flood0"][0]
    peak = {"replicas": 1, "gold_burn": 0.0, "flood_burn": 0.0}
    streams, errors, tally, rounds = {}, [], {}, []
    stop = threading.Event()

    def observe():
        reps = fleet.replicas
        peak["replicas"] = max(peak["replicas"], len(reps))
        for cls in ("gold", "flood"):
            b = max((r.engine.slo_stats.class_burn(cls) for r in reps),
                    default=0.0)
            peak[f"{cls}_burn"] = max(peak[f"{cls}_burn"], b)

    try:
        _warm_fleet(model, sample)
        mem_one = _allocated()
        watch = _FleetWatch(fleet)
        threads = _tenant_threads(
            fleet, work, lambda t: "gold" if t.startswith("gold")
            else "flood", streams, errors, stop=stop)
        with _k2_by_thread(tally):
            # the main path: the K2 counter at 0 just before, read after
            pa.launches = 0
            watch.start()
            t0 = time.time()
            for th in threads:
                th.start()
            _step_rounds(ctl, watch, rounds,
                         lambda: peak["replicas"] >= bands["max_replicas"]
                         and peak["flood_burn"] >= bands["burn_high"],
                         observe, "overload")
            stop.set()
            for th in threads:
                th.join(timeout=300)
            flood_s = time.time() - t0
            _step_rounds(ctl, watch, rounds,
                         lambda: len(fleet.replicas) <= bands["min_replicas"],
                         observe, "overload idle")
            wall_s = time.time() - t0
            k2 = pa.launches
        snap = model.fleet_snapshot()
        ctl_snap = ctl.snapshot()
        routed = {r["replica"]: r["routed"] for r in snap["rows"]}
        events = snap["lifecycle_events"]
        watch.close()
    finally:
        stop.set()
        model.shutdown()
    mem_peak = torch.cuda.max_memory_allocated()
    del model, fleet, ctl, observe
    gc.collect()
    mem_after_raw = _allocated()
    mem_after = _quiet_allocated()
    label = "autoscale overload"
    if any(th.is_alive() for th in threads):
        fail(f"{label}: tenant threads still running")
    by_replica = _arm_k2(label, watch, tally, k2)
    greedy = _arm_streams(label, streams, errors, work, watch.routed,
                          by_replica)
    acts = [d["action"] for d in ctl_snap["decisions"]]
    scale_events = [e["verb"] for e in events
                    if e["event"] == trace_mod.FLEET_SCALE]
    per_replica = mem_one - mem_before
    checks = {
        "peak_replicas": peak["replicas"], "final_replicas": len(routed),
        "gold_burn_peak": peak["gold_burn"],
        "flood_burn_peak": peak["flood_burn"],
        "scale_ups": ctl_snap["scale_ups"],
        "scale_downs": ctl_snap["scale_downs"]}
    if peak["replicas"] != bands["max_replicas"] or len(routed) != 1 \
            or ctl_snap["scale_ups"] < 2 or ctl_snap["scale_downs"] < 2:
        fail(f"{label}: expected 1 -> 3 -> 1 replicas: {checks}")
    if peak["gold_burn"] > 0.05 or peak["flood_burn"] < bands["burn_high"]:
        fail(f"{label}: the burns read {checks}")
    if "scale_up" not in acts or "scale_down" not in acts \
            or "attach_replica" not in scale_events \
            or "detach_replica" not in scale_events:
        fail(f"{label}: ring {acts}, FLEET_SCALE events {scale_events}")
    if watch.freed != ctl_snap["scale_downs"] \
            or mem_after - mem_before > AUTOSCALE_MEM_SLACK * per_replica:
        fail(f"{label}: memory not given back: {watch.freed} engines "
             f"collected for {ctl_snap['scale_downs']} detaches; before "
             f"{mem_before}, one replica {mem_one}, after each detach "
             f"{watch.after_detach}, after the arm {mem_after} "
             f"({mem_after_raw} with the cuBLAS workspaces)")
    tokens = len(streams) * FLEET_BUDGET
    return {
        "run": "autoscale_overload", "bands": bands,
        "tenants": {"flood": len(flood), "gold": len(gold)},
        "streams": len(streams), "failed_streams": 0,
        "flood_s": flood_s, "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        **checks, "pressure_events": ctl_snap["pressure_events"],
        "steer_flips": ctl_snap["steer_flips"],
        "replicas_over_time": watch.timeline,
        "attach_ms": watch.ms["attach"], "detach_ms": watch.ms["detach"],
        "unexpected_compiles": [d.get("unexpected_compiles")
                                for d in ctl_snap["decisions"]
                                if d["action"] == "scale_down"],
        **_rounds_summary(rounds, ctl_snap["decisions"]),
        "memory_allocated": {"before": mem_before, "one_replica": mem_one,
                             "peak": mem_peak,
                             "after_each_detach": watch.after_detach,
                             "after_with_cublas_workspaces": mem_after_raw,
                             "after": mem_after},
        "engines_collected": watch.freed,
        "routed_final": routed, "routed_by_replica": watch.routed,
        "chunk_dispatches_by_replica": watch.chunks,
        "paged_decode_attention_launches": k2,
        "paged_decode_attention_launches_by_replica": by_replica,
        "greedy_streams": greedy}


def _verdict(d: dict) -> dict:
    keys = ("canary_routed", "reasons", "canary_burn", "stable_burn",
            "canary_ttft_p95_s", "stable_ttft_p95_s", "canary_mfu",
            "stable_mfu", "soak_elapsed_s")
    out = {k: d.get(k) for k in keys}
    c, s = d.get("canary_ttft_p95_s"), d.get("stable_ttft_p95_s")
    out["ttft_p95_ratio"] = c / s if c and s else None
    c, s = d.get("canary_mfu"), d.get("stable_mfu")
    out["mfu_ratio"] = c / s if c is not None and s else None
    return out


def _autoscale_canary(cfg, params) -> dict:
    """(b) the canary arm: two replicas pinned, a 50 % tenant split; a
    kernel_delay on the next replica's engine must roll back, and the same
    rollout with the fault cleared must promote."""
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import trace as trace_mod
    from client_tpu_torch.server.faultinject import get_injector

    canary_tenants, stable_tenants = _split_tenants(
        CANARY_GATES["split_pct"], 4, 4)
    work = _autoscale_workload(cfg.vocab_size,
                               canary_tenants + stable_tenants)
    mem_before = _quiet_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = _autoscale_model("canary_lm", cfg, params, 2, AUTOSCALE_PINNED,
                             canary=CANARY_GATES)
    fleet, ctl = model.fleet, model.autoscaler
    inj = get_injector()
    streams, errors, tally, rounds = {}, [], {}, []
    phases = {}
    try:
        _warm_fleet(model, work[canary_tenants[0]][0])
        mem_two = _allocated()
        watch = _FleetWatch(fleet)
        with _k2_by_thread(tally):
            pa.launches = 0
            watch.start()
            t0 = time.time()
            for phase, version in (("regressed", "v2"), ("clean", "v3")):
                next_idx = max(r.idx for r in fleet.replicas) + 1
                if phase == "regressed":
                    inj.arm([{"point": "kernel_delay",
                              "delay_s": CANARY_DELAY_S, "times": 0,
                              "match": {"engine": f"canary_lm/r{next_idx}"}}])
                p0 = time.time()
                cidx = ctl.rolling_restart(version)
                watch.note()
                if phase == "regressed" and cidx != next_idx:
                    fail(f"canary: the canary is replica {cidx}, expected "
                         f"{next_idx}, whose engine the fault names")
                mine, errs = {}, []
                threads = _tenant_threads(fleet, work, lambda t: "gold",
                                          mine, errs)
                for th in threads:
                    th.start()
                _step_rounds(ctl, watch, rounds,
                             lambda: fleet.canary is None
                             and not any(th.is_alive() for th in threads),
                             label=f"canary {phase}")
                inj.clear()
                streams.update({(phase, t, k): v
                                for (t, k), v in mine.items()})
                errors.extend(errs)
                gc.collect()
                ring = ctl.snapshot()["decisions"]
                verdict = [d for d in ring if d["action"] in (
                    "canary_rollback", "canary_promote")][-1]
                phases[phase] = {
                    "canary_replica": cidx, "verdict": verdict["action"],
                    **_verdict(verdict), "streams": len(mine),
                    "wall_s": time.time() - p0,
                    "tokens_per_s": len(mine) * FLEET_BUDGET
                    / (time.time() - p0),
                    "memory_allocated_after": _allocated(),
                    "fleet_version": fleet.fleet_snapshot()["version"]}
            wall_s = time.time() - t0
            k2 = pa.launches
        snap = model.fleet_snapshot()
        ctl_snap = ctl.snapshot()
        routed = {r["replica"]: r["routed"] for r in snap["rows"]}
        watch.close()
    finally:
        inj.clear()
        model.shutdown()
    mem_peak = torch.cuda.max_memory_allocated()
    del model, fleet, ctl
    gc.collect()
    mem_after_raw = _allocated()
    mem_after = _quiet_allocated()
    label = "autoscale canary"
    by_replica = _arm_k2(label, watch, tally, k2)
    flat = {(f"{p}:{t}", k): v for (p, t, k), v in streams.items()}
    flat_work = {f"{p}:{t}": work[t] for p in phases for t in work}
    greedy = _arm_streams(label, flat, errors, flat_work, watch.routed,
                          by_replica)
    acts = [d["action"] for d in ctl_snap["decisions"]]
    kinds = [e["event"] for e in snap["lifecycle_events"]]
    if phases["regressed"]["verdict"] != "canary_rollback" \
            or phases["regressed"]["fleet_version"] == "v2":
        fail(f"{label}: the regressed canary was not rolled back: "
             f"{phases['regressed']}")
    if phases["clean"]["verdict"] != "canary_promote" \
            or snap["version"] != "v3" \
            or any(r["version"] != "v3" for r in snap["rows"]):
        fail(f"{label}: the clean canary was not promoted: "
             f"{phases['clean']}, rows {snap['rows']}")
    if "canary_rollback" not in acts or "canary_promote" not in acts \
            or trace_mod.CANARY_ROLLBACK not in kinds \
            or trace_mod.CANARY_PROMOTE not in kinds:
        fail(f"{label}: ring {acts}, lifecycle {kinds}")
    per_replica = (mem_two - mem_before) / 2
    after_rollback = phases["regressed"]["memory_allocated_after"]
    # the rollback detached the canary, the promote swapped out both
    # stable engines
    if watch.freed != 3 \
            or mem_after - mem_before > AUTOSCALE_MEM_SLACK * per_replica:
        fail(f"{label}: memory not given back: {watch.freed} engines "
             f"collected of 3 taken out; before {mem_before}, two replicas "
             f"{mem_two}, after the rollback {after_rollback}, after the "
             f"arm {mem_after} ({mem_after_raw} with the cuBLAS "
             f"workspaces)")
    return {
        "run": "autoscale_canary", "bands": AUTOSCALE_PINNED,
        "gates": CANARY_GATES, "injected_delay_s": CANARY_DELAY_S,
        "tenants": {"canary_side": canary_tenants,
                    "stable_side": stable_tenants},
        "phases": phases, "streams": len(streams), "failed_streams": 0,
        "wall_s": wall_s,
        "tokens_per_s": len(streams) * FLEET_BUDGET / wall_s,
        "replicas_over_time": watch.timeline,
        "attach_ms": watch.ms["attach"], "detach_ms": watch.ms["detach"],
        "drain_ms": watch.ms["drain"],
        **_rounds_summary(rounds, ctl_snap["decisions"]),
        "memory_allocated": {"before": mem_before, "two_replicas": mem_two,
                             "peak": mem_peak,
                             "after_rollback": after_rollback,
                             "after_each_detach": watch.after_detach,
                             "after_with_cublas_workspaces": mem_after_raw,
                             "after": mem_after},
        "engines_collected": watch.freed,
        "routed_final": routed, "routed_by_replica": watch.routed,
        "chunk_dispatches_by_replica": watch.chunks,
        "paged_decode_attention_launches": k2,
        "paged_decode_attention_launches_by_replica": by_replica,
        "greedy_streams": greedy}


def phase_autoscale(gen_model: tuple, env: dict) -> dict:
    """The fleet autoscaler and the canary judge (ROADMAP 7b's remainder):
    bench.py's generation model at full width, paged with K2, replicas
    sharing the one card, at the reference autoscale benchmark's
    settings."""
    import dataclasses

    cfg, params, _ = gen_model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    t0 = time.time()
    arms = [_autoscale_overload(cfg, params),
            _autoscale_canary(cfg, params)]
    t1 = time.time()
    _judge_greedy(cfg, params, arms)
    result = {"phase": "autoscale", "card": env["nvidia_smi"],
              "workload": {"prefix": AUTOSCALE_PREFIX,
                           "suffix": AUTOSCALE_SUFFIX,
                           "requests_per_tenant": AUTOSCALE_REQS,
                           "budget": FLEET_BUDGET,
                           "slo_classes": AUTOSCALE_SLO_CLASSES,
                           "slo_window_s": AUTOSCALE_WINDOW_S},
              "runs": arms,
              "seconds": {"serve": t1 - t0, "judge": time.time() - t1}}
    emit(result)
    return result


# ---------------------------------------------------------------- train (9a)

TRAIN_STEPS = 5
TRAIN_BATCH = 16
# the full-width arms' AdamW learning rate: BERT-base's (Devlin et al.
# 2019, Adam at 1e-4). At make_train_step's default 1e-3, with no warmup,
# this model's loss on one batch rises at the fifth step (10.80, 10.18,
# 9.24, 8.54, 13.67 in bf16; 13.45 in f32, so the dynamics and not bf16)
# before falling again; 1e-4 falls at every step.
TRAIN_LR = 1e-4
TRAIN_TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                  head_dim=8, d_ff=64, max_seq=32)
TRAIN_TINY_LR = 1e-2
# Adam's first step is g / (|g| + 1e-8): an element whose first gradient
# lies in (0, TRAIN_TINY_GRAD) moves by a step that turns on the
# gradient's last f32 bits, which the card's and the CPU's summation
# orders do not share; such elements are held to the most the steps can
# move them (two learning rates a step) and must stay under 1 % of a leaf
TRAIN_PARAM_ATOL, TRAIN_TINY_GRAD, TRAIN_TINY_SHARE = 1e-4, 1e-6, 0.01
TRAIN_REMAT_RTOL = 1e-3
TRAIN_MESH_RTOL = 1e-6
TRAIN_MESH_TIMEOUT_S = 300
# where the train phase runs: the card (a CPU rehearsal sets "cpu")
TRAIN_DEVICE = "cuda"


def _train_tokens(cfg, batch: int, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=gen).to(device)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def _param_check(card: dict, cpu: dict, grads: dict, steps: int) -> dict:
    """(a)'s parameter rule, leaf by leaf: the largest difference where the
    first gradient is 0 or at least TRAIN_TINY_GRAD (<= TRAIN_PARAM_ATOL)
    and where it is not (<= 2 lr steps, on under TRAIN_TINY_SHARE)."""
    worst = {"well": 0.0, "tiny": 0.0, "tiny_share": 0.0}

    def walk(a, b, g, name):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], g[k], f"{name}.{k}")
            return
        err = np.abs(a.astype(np.float64) - b.astype(np.float64))
        mag = np.abs(g)
        tiny = (mag > 0) & (mag < TRAIN_TINY_GRAD)
        well = float(err[~tiny].max(initial=0.0))
        bad = float(err[tiny].max(initial=0.0))
        share = float(tiny.mean())
        if well > TRAIN_PARAM_ATOL or bad > 2 * TRAIN_TINY_LR * steps \
                or share >= TRAIN_TINY_SHARE:
            fail(f"train (a): {name} differs between the card and the CPU "
                 f"(well-conditioned {well}, tiny-gradient {bad} on "
                 f"{share:.4f} of the leaf)")
        worst["well"] = max(worst["well"], well)
        worst["tiny"] = max(worst["tiny"], bad)
        worst["tiny_share"] = max(worst["tiny_share"], share)

    walk(card, cpu, grads, "params")
    return worst


def _train_tiny_card_vs_cpu() -> dict:
    """(a): three steps of TINY from one set of weights, on the card and on
    the CPU."""
    from client_tpu_torch.models import transformer as t

    cfg = t.TransformerConfig(dtype=torch.float32, attn_impl="ref",
                              **TRAIN_TINY)
    params = t.init_params(torch.Generator().manual_seed(3), cfg)
    tokens = _train_tokens(cfg, 4, 4, "cpu")
    _, first = t.value_and_grad(cfg, params, tokens)
    out = {}
    for device in (TRAIN_DEVICE, "cpu"):
        _, step = t.make_train_step(cfg, learning_rate=TRAIN_TINY_LR)
        state = t.init_state_from_params(cfg, t._tree_map(
            lambda p: p.to(device), params))
        losses = []
        for _ in range(3):
            state, metrics = step(state, tokens.to(device))
            losses.append(metrics["loss"])
        out[device] = ([float(x) for x in losses], _tree_np(state["params"]))
    card, cpu = out[TRAIN_DEVICE], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    if rel > 1e-4:
        fail(f"train (a): card losses {card[0]} against the CPU's {cpu[0]}")
    worst = _param_check(card[1], cpu[1], _tree_np(first), 3)
    return {"arm": "tiny_card_vs_cpu", "losses_card": card[0],
            "losses_cpu": cpu[0], "loss_max_rel_err": rel,
            "param_max_abs_err": worst["well"],
            "tiny_grad_param_max_abs_err": worst["tiny"],
            "tiny_grad_share": worst["tiny_share"]}


def _train_arm(label: str, cfg, tokens, peak: float) -> dict:
    """TRAIN_STEPS steps of ``cfg`` from seed-0 weights on ``tokens``: the
    losses (finite, the last below the first), ms per step between CUDA
    events, tokens/s, the peak allocation, model FLOPs and MFU."""
    from client_tpu_torch.models import transformer as t

    init_state, step = t.make_train_step(cfg, learning_rate=TRAIN_LR)
    gen = torch.Generator(device=TRAIN_DEVICE)
    gen.manual_seed(0)
    state = init_state(gen)
    with torch.no_grad():
        _, aux = t.forward(cfg, state["params"], tokens[:, :-1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, tokens)
        end.record()
        events.append((start, end))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(x) for x in losses]
    peak_bytes = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train {label}: losses {losses} (finite, falling expected)")
    b, l = tokens.shape[0], tokens.shape[1] - 1
    # fwd + bwd (twice the forward) of the model's useful FLOPs: the causal
    # attention counts its attended positions, remat's recompute is not
    flops = 3 * b * t.span_flops(cfg, 0, l)
    steady = float(np.mean(ms[1:]))
    del state
    return {"arm": label, "losses": losses, "aux_loss": float(aux),
            "ms_per_step": ms, "steady_ms_per_step": steady,
            "tokens_per_s": b * l / (steady / 1e3),
            "max_memory_allocated": peak_bytes,
            "model_flops_per_step": flops,
            "mfu": flops / (steady / 1e3) / peak}


def _train_mesh_rank(rank: int, world: int, device: str) -> dict:
    """(e), in a process of its own started by run_ranks (one NCCL rank):
    make_mesh() over the card, TINY's step with the mesh against the step
    without it, three steps each, and the dry run's steps 1-3."""
    import torch.distributed as dist

    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.parallel.dryrun import dryrun_steps
    from client_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=device)
    cfg = t.TransformerConfig(dtype=torch.float32, attn_impl="ref",
                              **TRAIN_TINY)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    params = t.init_params(gen, cfg)
    tokens = _train_tokens(cfg, 4, 4, device)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        _, step = t.make_train_step(cfg, mesh=m,
                                    learning_rate=TRAIN_TINY_LR)
        state = t.init_state_from_params(cfg, params, m)
        losses = []
        for _ in range(3):
            state, metrics = step(state, tokens)
            losses.append(float(metrics["loss"]))
        runs[name] = (losses, state["params"])
    diff = max(float((a - b).abs().max()) for a, b in zip(
        t._tree_leaves(runs["plain"][1]), t._tree_leaves(runs["mesh"][1])))
    return {"backend": str(dist.get_backend()),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "device": (torch.cuda.get_device_name(0) if device == "cuda"
                       else device),
            "losses": runs["plain"][0], "mesh_losses": runs["mesh"][0],
            "param_max_abs_diff": diff,
            "dryrun": dryrun_steps(1, device, steps=(1, 2, 3))}


def phase_train(env: dict, peaks: tuple) -> dict:
    """Training on the card (ROADMAP 9a), arms (a)-(e): see the module
    docstring."""
    import dataclasses

    from client_tpu_torch.bench import generation_config
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.parallel.collectives import run_ranks

    peak = peaks[1]
    fa.launches = pa.launches = 0
    arms = [_train_tiny_card_vs_cpu()]
    emit({"phase": "train", **arms[0]})
    cfg = generation_config()
    tokens = _train_tokens(cfg, TRAIN_BATCH, 11, TRAIN_DEVICE)
    dense = _train_arm("dense_bf16", cfg, tokens, peak)
    moe = _train_arm("moe_bf16", dataclasses.replace(cfg, n_experts=4),
                     tokens, peak)
    if not moe["aux_loss"] > 0:
        fail(f"train moe_bf16: aux loss {moe['aux_loss']} (> 0 expected)")
    remat = _train_arm("dense_bf16_remat",
                       dataclasses.replace(cfg, remat=True), tokens, peak)
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(remat["losses"], dense["losses"]))
    remat["loss_max_rel_err_vs_dense"] = rel
    if rel > TRAIN_REMAT_RTOL:
        fail(f"train remat: losses {remat['losses']} against "
             f"{dense['losses']} (rtol {TRAIN_REMAT_RTOL})")
    for arm in (dense, moe, remat):
        emit({"phase": "train", "card": env["nvidia_smi"], **arm})
        arms.append(arm)
    backend = "nccl" if TRAIN_DEVICE == "cuda" else "gloo"
    (mesh,) = run_ranks(_train_mesh_rank, 1, backend, TRAIN_MESH_TIMEOUT_S,
                        args=(TRAIN_DEVICE,))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(mesh["mesh_losses"], mesh["losses"]))
    if mesh["backend"] != backend or rel > TRAIN_MESH_RTOL \
            or set(mesh["dryrun"]) != {"dp_sp_tp", "dp_ep", "pp"}:
        fail(f"train (e): {mesh}")
    mesh.update({"arm": "mesh_one_rank", "loss_max_rel_err": rel})
    emit({"phase": "train", **mesh})
    arms.append(mesh)
    k1, k2 = fa.launches, pa.launches
    if k1 or k2:
        fail(f"train: K1 launched {k1} and K2 {k2} times (0 expected)")
    result = {"phase": "train", "card": env["nvidia_smi"],
              "flash_attention_launches": k1,
              "paged_decode_attention_launches": k2,
              "summary": {a["arm"]: {k: a[k] for k in (
                  "steady_ms_per_step", "tokens_per_s",
                  "max_memory_allocated", "mfu") if k in a}
                  for a in arms}}
    emit(result)
    return result


MESH_TIMEOUT_S = 600
MESH_DEVICE = "cuda"
MESH_SEQ = 128
# the encoder's static bucket in the mesh phase (bench.py's), and its
# requests: each a full batch of MESH_BATCH rows, so every forward is one
# whole bucket on both models
MESH_BATCH = 256
MESH_REQUESTS = 8


def _mesh_encoder(mesh, device: str) -> dict:
    """(a): the BERT-base encoder at bench.py's width and bucket (seq 128,
    bf16, K1, 256 rows) as a TorchModel over the one-rank mesh
    (param_sharding, input_sharding) and as the plain TorchModel, both
    behind one core: MESH_REQUESTS full-bucket requests of distinct
    tokens, one at a time, to the plain model and then to the mesh model.
    The embeddings must be bit-equal (a one-rank mesh's collectives are
    identities, so the two run the same kernels on the same inputs); K1's
    counter, zeroed just before the mesh model's requests, must read 12
    per forward. The ms per request are the median of each arm's
    requests, each a whole 256-row forward with its plan, broadcast and
    gather under the mesh."""
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.perf import bench_harness as bh
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.types import InferRequest, InferTensor

    cfg = bh.bert_config(MESH_SEQ)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = t.init_params(gen, cfg)
    core = TorchInferenceServer()
    core.register_model(bh.make_encoder_model(
        cfg, params, MESH_SEQ, MESH_BATCH, name="bert_plain", device=device))
    core.register_model(bh.make_encoder_model(
        cfg, params, MESH_SEQ, MESH_BATCH, name="bert_mesh", mesh=mesh))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size,
                          (MESH_REQUESTS, MESH_BATCH, MESH_SEQ),
                          dtype=np.int32)

    def serve(name):
        out, ms = [], []
        for batch in tokens:
            t0 = time.perf_counter()
            resp = core.infer(InferRequest(model_name=name, inputs=[
                InferTensor("input_ids", "INT32", batch.shape,
                            data=batch)]))
            out.append(np.asarray(resp.output("embedding").data))
            ms.append((time.perf_counter() - t0) * 1e3)
        return np.concatenate(out), float(np.median(ms))

    try:
        serve("bert_plain")              # the kernels' first launches
        serve("bert_mesh")
        plain, plain_ms = serve("bert_plain")
        fa.launches = 0
        sharded, mesh_ms = serve("bert_mesh")
        k1 = fa.launches
    finally:
        core.stop()
    equal = bool(np.array_equal(plain, sharded))
    return {"requests": MESH_REQUESTS, "bucket": MESH_BATCH,
            "shape_ok": list(plain.shape) == [MESH_REQUESTS * MESH_BATCH,
                                              cfg.d_model],
            "bit_equal": equal,
            "max_abs_diff": float(np.abs(plain - sharded).max()),
            "finite": bool(np.isfinite(sharded).all()),
            "flash_attention_launches": k1,
            "median_ms_per_request": {"plain": plain_ms, "mesh": mesh_ms},
            "rows_per_s": {"plain": MESH_BATCH / plain_ms * 1e3,
                           "mesh": MESH_BATCH / mesh_ms * 1e3}}


def _mesh_engine_arm(cfg, params, jobs: list, mesh, device: str) -> dict:
    """One arm of (b): the engine (paged, K2, prefix cache on, 16 slots,
    chunk 16) over ``mesh`` or unsharded, warmed on one short stream, then
    the jobs submitted together and read to their ends: streams, K2
    launches and chunk dispatches (counters at 0 just before), tokens/s,
    host ms per dispatch and the plans the channel sent."""
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        cfg, params, n_slots=GEN_SLOTS, chunk=GEN_CHUNK, kv_layout="paged",
        kv_block_len=GEN_BLOCK, prefix_cache=True,
        **({"mesh": mesh} if mesh is not None else {"device": device}))
    try:
        list(eng.submit(np.zeros(4, np.int32), 2))
        before = eng.stats()
        sent0 = eng._chan.sent if eng._chan is not None else 0
        pa.launches = 0
        t0 = time.perf_counter()
        its = [eng.submit(p, b) for p, b in jobs]
        streams = [list(it) for it in its]
        wall = time.perf_counter() - t0
        k2 = pa.launches
        after = eng.stats()
        plans = (eng._chan.sent - sent0) if eng._chan is not None else 0
    finally:
        eng.stop()
    kind = {f: after["dispatch_by_kind"]["chunk"][f]
            - before["dispatch_by_kind"]["chunk"][f]
            for f in ("dispatches", "host_s")}
    dispatches = after["chunks_dispatched"] - before["chunks_dispatched"]
    disp_s = after["phase_seconds"]["dispatch"] \
        - before["phase_seconds"]["dispatch"]
    return {"streams": streams, "wall_s": wall,
            "tokens_per_s": sum(b for _, b in jobs) / wall,
            "chunk_dispatches": kind["dispatches"],
            "host_ms_per_chunk_dispatch":
                kind["host_s"] / max(1, kind["dispatches"]) * 1e3,
            "host_ms_per_dispatch": disp_s / max(1, dispatches) * 1e3,
            "paged_decode_attention_launches": k2, "plans_sent": plans}


# the planes' arms (c)-(g): the first 8 of (b)'s jobs on every arm but
# the tier's; speculation at gamma 4 with the speculate phase's pair; two
# lane slots, batched; the tier's cycle one stream a wave through a pool
# that holds one stream's worst case and 12 committed blocks; one crash
# after 6 loop iterations, with a 50 ms backoff
MESH_PLANE_JOBS = 8
MESH_SPEC_GAMMA = 4
MESH_LANES = dict(prefill_mode="chunked", prefill_chunk=64,
                  prefill_slots=2, prefill_lane_width=32,
                  prefill_lane_batch=2)
MESH_TIER_POOL = GEN_MAX_SEQ // GEN_BLOCK + 12 + 1
MESH_CRASH_AFTER = 6


def _plane_arm(cfg, params, jobs: list, mesh, device: str,
               sequential: bool = False, **knobs) -> dict:
    """One arm of (c)-(f): an engine of 16 slots, chunk 16, with
    ``knobs``, over ``mesh`` or unsharded, warmed on one short stream,
    then the jobs (submitted together, or one after another with
    ``sequential``) read to their ends: streams, tokens/s, host ms per
    dispatch (every kind's), dispatches by kind, K2 launches (counter at
    0 just before), verify rounds, tier restores and lane handoffs."""
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        cfg, params, n_slots=GEN_SLOTS, chunk=GEN_CHUNK,
        **({"mesh": mesh} if mesh is not None else {"device": device}),
        **knobs)
    try:
        list(eng.submit(np.zeros(4, np.int32), 2))
        before = eng.stats()
        pa.launches = 0
        t0 = time.perf_counter()
        if sequential:
            streams = [list(eng.submit(p, b)) for p, b in jobs]
        else:
            its = [eng.submit(p, b) for p, b in jobs]
            streams = [list(it) for it in its]
        wall = time.perf_counter() - t0
        k2 = pa.launches
        after = eng.stats()
    finally:
        eng.stop()
    by_kind = {k: after["dispatch_by_kind"][k]["dispatches"]
               - before["dispatch_by_kind"][k]["dispatches"]
               for k in after["dispatch_by_kind"]}
    host_s = sum(after["dispatch_by_kind"][k]["host_s"]
                 - before["dispatch_by_kind"][k]["host_s"] for k in by_kind)

    def delta(block, key):
        if key not in (after[block] or {}):
            return None
        return after[block][key] - before[block][key]

    return {"streams": streams, "wall_s": wall,
            "tokens_per_s": sum(len(x) for x in streams) / wall,
            "host_ms_per_dispatch":
                host_s / max(1, sum(by_kind.values())) * 1e3,
            "dispatches_by_kind": by_kind,
            "paged_decode_attention_launches": k2,
            "spec_rounds": delta("speculation", "rounds"),
            "tier_restores": delta("kv_tier", "restores"),
            "tier_spills": delta("kv_tier", "spills"),
            "lane_handoffs": delta("prefill_lane", "handoffs")}


def _resubmitting(model, jobs: list) -> list:
    """The jobs, one thread each, each resubmitted from its first token
    on a retryable 503 once its Retry-After has passed (to the live
    engine: a supervised restart swaps it); any other error fails."""
    from client_tpu_torch.server.types import ServerError

    tokens: list = [None] * len(jobs)
    refused = [0] * len(jobs)
    errors: list = []

    def one(i):
        prompt, budget = jobs[i]
        for _attempt in range(20):
            try:
                tokens[i] = list(model.engine.submit(prompt, budget))
                return
            except ServerError as e:
                if e.status != 503 or e.retry_after is None:
                    errors.append(f"job {i}: {e}")
                    return
                refused[i] += 1
                time.sleep(e.retry_after)
        errors.append(f"job {i}: refused 20 times")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or any(th.is_alive() for th in threads):
        fail(f"mesh supervise: {errors[:3]}")
    return tokens, refused


def _supervised_arm(cfg, params, jobs: list, mesh, device: str) -> dict:
    """Arm (g): a supervised paged generator (K2) over ``mesh`` or
    unsharded; one injected ``engine_loop`` crash after
    MESH_CRASH_AFTER loop iterations of the jobs' run, healed by the
    supervisor, and every refused stream resubmitted. Returns the final
    streams, the restarts, K2 launches against the dead and the rebuilt
    engines' chunk dispatches (and the rebuilt engine's warm-up), and
    ``memory_allocated`` before the crash and after the drain."""
    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import faultinject

    name = "sup_plain" if mesh is None else "sup_mesh"
    model = make_continuous_generator(
        name, cfg=cfg, params=params, n_slots=GEN_SLOTS, chunk_size=GEN_CHUNK,
        kv_layout="paged", kv_block_len=GEN_BLOCK,
        supervision={"backoff_base_s": 0.05, "max_failures": 3},
        **({"mesh": mesh} if mesh is not None else {"device": device}))
    sup = model.engine_supervisor
    inj = faultinject.get_injector()
    try:
        first = model.engine
        list(first.submit(np.zeros(4, np.int32), 2))
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        c0 = _chunks(first)
        pa.launches = 0
        inj.arm([{"point": "engine_loop", "after": MESH_CRASH_AFTER,
                  "times": 1, "match": {"engine": name}}])
        t0 = time.perf_counter()
        streams, refused = _resubmitting(model, jobs)
        wall = time.perf_counter() - t0
        inj.clear()
        rebuilt = model.engine
        k2 = pa.launches
        dead, new = _chunks(first) - c0, _chunks(rebuilt)
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        host = rebuilt.stats()["dispatch_by_kind"]
    finally:
        inj.clear()
        model.shutdown()
    n = sum(v["dispatches"] for v in host.values())
    return {"streams": streams, "wall_s": wall,
            "tokens_per_s": sum(len(x) for x in streams) / wall,
            "host_ms_per_dispatch":
                sum(v["host_s"] for v in host.values()) / max(1, n) * 1e3,
            "restarts": sup.restarts, "refused_streams": sum(
                1 for r in refused if r),
            "rebuilt": rebuilt is not first,
            "dead_engine_chunk_dispatches": dead,
            "rebuilt_engine_chunk_dispatches": new,
            "paged_decode_attention_launches": k2,
            "k2_want": LAYERS * GEN_CHUNK * (dead + new + WARM_CHUNKS),
            "memory_allocated": {"before_crash": mem_before,
                                 "after_drain": mem_after},
            "pool_bytes": cfg.n_layers * 2 * GEN_POOL * GEN_BLOCK
            * cfg.kv_heads * cfg.head_dim * 2}


def _mesh_planes(cfg, params, jobs: list, mesh, device: str) -> dict:
    """(c)-(g), each arm beside its unsharded twin: speculation (paged,
    the speculate phase's high-agreement pair at gamma 4), the dedicated
    lanes (both layouts, batched), the host tier (paged), int8 KV (both
    layouts) and supervision (paged, one crash)."""
    import dataclasses

    paged = dict(kv_layout="paged", kv_block_len=GEN_BLOCK)
    cut = jobs[:MESH_PLANE_JOBS]
    target, draft = _high_agreement_pair(cfg, params)
    kv8 = dataclasses.replace(cfg, kv_quant=True)
    tier_jobs = _tier_jobs(cfg.vocab_size)[::TIER_WAVE]
    arms = {
        "spec_paged": (cfg, target, cut, False, dict(
            paged, speculative_draft=draft,
            speculative_gamma=MESH_SPEC_GAMMA)),
        "lane_slot": (cfg, params, cut, False, dict(
            MESH_LANES, prefix_cache=True, prefix_block_len=GEN_BLOCK)),
        "lane_paged": (cfg, params, cut, False, dict(MESH_LANES, **paged)),
        "tier_paged": (cfg, params, tier_jobs, True, dict(
            paged, kv_pool_blocks=MESH_TIER_POOL, prefix_cache=True,
            prefix_block_len=GEN_BLOCK, prefill_mode="chunked",
            prefill_chunk=64, host_tier_bytes=TIER_BYTES)),
        "kv8_slot": (kv8, params, cut, False, {}),
        "kv8_paged": (kv8, params, cut, False, paged),
    }
    out = {}
    for label, (acfg, aparams, ajobs, seq, knobs) in arms.items():
        out[label] = {side: _plane_arm(acfg, aparams, ajobs, m, device,
                                       sequential=seq, **knobs)
                      for side, m in (("plain", None), ("mesh", mesh))}
    out["supervise"] = {side: _supervised_arm(cfg, params, cut, m, device)
                        for side, m in (("plain", None), ("mesh", mesh))}
    return out


def _mesh_rank(rank: int, world: int, layers: int, device: str) -> dict:
    """The mesh phase in a process of its own started by run_ranks (one
    NCCL rank on the card): (a) the sharded encoder, (b) the sharded
    engine beside the unsharded one, (c)-(g) the engine's optional planes
    sharded beside their unsharded twins (``_mesh_planes``), and the dry
    run's steps 1-4 at one rank."""
    import dataclasses

    import torch.distributed as dist

    from client_tpu_torch.bench import generation_config
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.parallel.dryrun import dryrun_steps
    from client_tpu_torch.parallel.mesh import make_mesh
    from client_tpu_torch.perf.bench_harness import ragged_generation_jobs

    mesh = make_mesh({"dp": 1, "tp": 1}, device=device)
    out = {"backend": str(dist.get_backend()),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "encoder": _mesh_encoder(mesh, device)}
    cfg = dataclasses.replace(generation_config(), attn_impl="flash",
                              n_layers=layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = t.init_params(gen, cfg)
    jobs = ragged_generation_jobs(7, cfg.vocab_size, 32, (8, 64), (16, 128),
                                  cfg.max_seq)
    out["engine"] = {
        "plain": _mesh_engine_arm(cfg, params, jobs, None, device),
        "mesh": _mesh_engine_arm(cfg, params, jobs, mesh, device)}
    out["planes"] = _mesh_planes(cfg, params, jobs, mesh, device)
    out["dryrun"] = dryrun_steps(1, device)
    return out


def phase_mesh(env: dict) -> dict:
    """The engine's mesh (ROADMAP 9b) on the card, in a run_ranks child
    with one NCCL rank: see the module docstring."""
    from client_tpu_torch.parallel.collectives import run_ranks

    backend = "nccl" if MESH_DEVICE == "cuda" else "gloo"
    (r,) = run_ranks(_mesh_rank, 1, backend, MESH_TIMEOUT_S,
                     args=(LAYERS, MESH_DEVICE))
    enc, arms = r["encoder"], r["engine"]
    plain, mesh = arms["plain"], arms["mesh"]
    checks = {
        "backend": r["backend"] == backend,
        "encoder_bit_equal": enc["bit_equal"] and enc["finite"]
        and enc["shape_ok"],
        "encoder_k1": enc["flash_attention_launches"]
        == LAYERS * MESH_REQUESTS,
        "streams_equal": mesh["streams"] == plain["streams"],
        "k2_per_chunk": mesh["paged_decode_attention_launches"]
        == LAYERS * GEN_CHUNK * mesh["chunk_dispatches"] > 0,
        "dryrun": set(r["dryrun"]) == {"dp_sp_tp", "dp_ep", "pp", "engine"}
        and r["dryrun"]["engine"] == 5}
    planes = r["planes"]
    for label, pair in planes.items():
        checks[f"{label}_streams_equal"] = (
            pair["mesh"]["streams"] == pair["plain"]["streams"])
        for side, arm in pair.items():
            if label == "supervise":
                k2_ok = (arm["paged_decode_attention_launches"]
                         == arm["k2_want"])
            elif label.startswith("kv8"):
                k2_ok = arm["paged_decode_attention_launches"] == 0
            elif label.endswith("paged"):
                chunks = arm["dispatches_by_kind"]["chunk"]
                k2_ok = (arm["paged_decode_attention_launches"]
                         == LAYERS * GEN_CHUNK * chunks > 0)
            else:
                k2_ok = arm["paged_decode_attention_launches"] == 0
            checks[f"{label}_{side}_k2"] = k2_ok
    for side in ("plain", "mesh"):
        spec, tier = planes["spec_paged"][side], planes["tier_paged"][side]
        sup = planes["supervise"][side]
        mem = sup["memory_allocated"]
        checks[f"spec_rounds_{side}"] = spec["spec_rounds"] > 0
        checks[f"tier_restores_{side}"] = tier["tier_restores"] > 0
        checks[f"lane_handoffs_{side}"] = all(
            planes[k][side]["lane_handoffs"] > 0
            for k in ("lane_slot", "lane_paged"))
        # a leak of the dead engine's state would be about one pool
        checks[f"supervise_{side}"] = (
            sup["restarts"] == 1 and sup["rebuilt"]
            and sup["refused_streams"] > 0
            and mem["after_drain"] - mem["before_crash"]
            <= sup["pool_bytes"] // 2)
    for arm in (plain, mesh):
        arm["streamed_tokens"] = sum(len(x) for x in arm.pop("streams"))
    for pair in planes.values():
        for arm in pair.values():
            arm["streamed_tokens"] = sum(len(x) for x in arm.pop("streams"))
    result = {"phase": "mesh", "card": env["nvidia_smi"],
              "backend": r["backend"], "mesh": r["mesh"], "encoder": enc,
              "engine": arms, "planes": planes, "dryrun": r["dryrun"],
              "checks": checks,
              "paged_decode_attention_launches":
                  mesh["paged_decode_attention_launches"],
              "flash_attention_launches": enc["flash_attention_launches"]}
    emit(result)
    if not all(checks.values()):
        fail(f"mesh: {checks}")
    return result


def _fleet_mesh_rank(rank: int, world: int, layers: int,
                     device: str) -> dict:
    """The fleet_mesh phase in a process of its own started by run_ranks
    (one NCCL rank on the card): the fleet phase's drained 2-replica arm,
    with a replica attached after the drain, unsharded and with every
    replica over a 1 x 1 mesh."""
    import dataclasses

    from client_tpu_torch.bench import generation_config
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(generation_config(), attn_impl="flash",
                              n_layers=layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = t.init_params(gen, cfg)
    work = _fleet_workload(cfg.vocab_size)
    mesh = make_mesh({"dp": 1, "tp": 1}, device=device)
    out = []
    # in turns: plain, mesh, mesh, plain
    for side, m in (("plain", None), ("mesh", mesh), ("mesh", mesh),
                    ("plain", None)):
        arm = _fleet_arm(f"fleet_mesh_{side}", cfg, params, work, 2,
                         "affinity", drain=True, mesh=m, attach=True)
        arm.pop("greedy_streams")
        arm["side"] = side
        out.append(arm)
    return out


def phase_fleet_mesh(env: dict) -> dict:
    """A replica fleet under the mesh (ROADMAP 9d) on the card, in a
    run_ranks child with one NCCL rank: see the module docstring."""
    from client_tpu_torch.parallel.collectives import run_ranks

    backend = "nccl" if MESH_DEVICE == "cuda" else "gloo"
    (runs,) = run_ranks(_fleet_mesh_rank, 1, backend, MESH_TIMEOUT_S,
                        args=(LAYERS, MESH_DEVICE))
    want = runs[0]["tokens"]
    checks = {}
    for k, arm in enumerate(runs):
        by = arm["paged_decode_attention_launches_by_replica"]
        tag = f"{arm['side']}{k}"
        checks[f"{tag}_streams_equal"] = arm.pop("tokens") == want
        checks[f"{tag}_plans_sent"] = (arm["plans_sent"] > 0) == (
            arm["side"] == "mesh")
        checks[f"{tag}_no_failed_stream"] = arm["failed_streams"] == 0
        checks[f"{tag}_drained"] = arm["drains"][0] == 1
        checks[f"{tag}_attached"] = sorted(arm["routed"]) == [0, 1, 2]
        # _fleet_arm failed already unless each replica's launches are
        # 12 x 4 per chunk dispatch of its engines
        checks[f"{tag}_k2_every_replica"] = sorted(by) == [0, 1, 2] \
            and all(n > 0 for n in by.values())

    def mean(side, key):
        vals = [a[key] for a in runs if a["side"] == side]
        return sum(vals) / len(vals)

    result = {"phase": "fleet_mesh", "card": env["nvidia_smi"],
              "runs": runs, "checks": checks,
              "tokens_per_s_ratio": mean("mesh", "tokens_per_s")
              / mean("plain", "tokens_per_s"),
              "host_ms_per_dispatch_ratio":
                  mean("mesh", "host_ms_per_dispatch")
                  / mean("plain", "host_ms_per_dispatch")}
    emit(result)
    if not all(checks.values()):
        fail(f"fleet_mesh: {checks}")
    return result


# ---------------------------------------------------------------- native

# the DIRECT models' elements as perf_analyzer drives them, and a size that
# prices D1 against the card's memory rate
NATIVE_DIRECT_N = 16
NATIVE_DIRECT_BIG = 1 << 20
NATIVE_DIRECT_CALLS = 200
NATIVE_DIRECT_MODELS = ("add_sub", "add_sub_fp32", "identity")
NATIVE_DIRECT_PERF = ["--concurrency-range", "2", "-p", "500", "-s", "90",
                      "-r", "3"]
# float32 outside the tensor cores (the guide's table; it has no int32
# rate, and int32 add/sub is counted at the same)
FP32_PEAK = 67e12
NATIVE_TARGETS = ["perf_analyzer", "libdirect_models_cpu.so",
                  "libdirect_models_cuda.so", "simple_http_cudashm_client"]
# D1's kernels as torch.profiler names them, by launch counter
D1_KERNEL_NAMES = {"add_sub": "AddSubKernel", "copy": "CopyKernel"}


def _native_build() -> tuple:
    """(a): the tools here, then the native targets the phase runs."""
    from client_tpu_torch import _native

    tools = _native.toolchain()
    emit({"phase": "native_tools", **{
        k: tools[k] for k in ("g++", "g++_version", "nvcc", "nvcc_version",
                              "protoc", "protobuf_missing", "cmake")}})
    if tools["g++"] is None or tools["nvcc"] is None:
        fail(f"native: g++ {tools['g++']}, nvcc {tools['nvcc']}: the "
             "native tree needs both")
    names = list(NATIVE_TARGETS)
    if tools["protobuf_missing"]:
        print("native: the gRPC targets are skipped: protobuf's "
              + ", ".join(tools["protobuf_missing"]) + " not found",
              flush=True)
    else:
        names.append("simple_grpc_cudashm_client")
    timings: dict = {}
    t0 = time.time()
    paths = _native.build(names, timings=timings)
    return paths, {"seconds": time.time() - t0, "seconds_by_group": timings,
                   "dir": str(_native.build_dir()), "targets": names}


def _direct_inputs(model: str, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1 if model == "identity" else 2):
        out[f"INPUT{i}"] = (rng.standard_normal(n).astype(np.float32)
                            if model == "add_sub_fp32" else
                            rng.integers(-2**30, 2**30, n).astype(np.int32))
    return out


def _direct_torch(model: str, inputs: dict) -> dict:
    """The same function through torch on the card."""
    a = torch.from_numpy(inputs["INPUT0"]).cuda()
    if model == "identity":
        return {"OUTPUT0": a.clone().cpu().numpy()}
    b = torch.from_numpy(inputs["INPUT1"]).cuda()
    return {"OUTPUT0": (a + b).cpu().numpy(),
            "OUTPUT1": (a - b).cpu().numpy()}


def _d1_device_ms(fn, kernel: str, iters: int = 100) -> tuple:
    """D1's device time per call of ``fn`` (one DirectModelInfer, one
    launch of ``kernel``): the mean duration of the kernel records
    torch.profiler takes of it in this process, the copies around it left
    out; and the number of records. The profiler may drop some of a
    window's records (it has beside other launching threads), so the mean
    is over those it kept; (None, 0) where it kept none in three windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name = D1_KERNEL_NAMES[kernel]
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in records)
        if count:
            return (sum(e.self_device_time_total for e in records)
                    / count / 1e3, count)
    return None, 0


def _direct_case(cpu, gpu, model: str, n: int, seed: int) -> dict:
    """One model at ``n`` elements: bit-equality against the CPU library
    and torch, then NATIVE_DIRECT_CALLS timed calls of each library (the
    card's kernel time from its CUDA events, its host time per call) and
    D1's device time from the profiler's kernel records."""
    inputs = _direct_inputs(model, n, seed)
    kernel = "copy" if model == "identity" else "add_sub"
    name = f"{model}:{n}"
    with cpu.model(name) as c, gpu.model(name) as g:
        want = c.infer(inputs)
        before = gpu.launches(kernel)
        got = g.infer(inputs)
        rose = gpu.launches(kernel) - before
        ref = _direct_torch(model, inputs)
        errs = [float(np.max(np.abs(got[k].astype(np.float64)
                                    - want[k].astype(np.float64))))
                for k in want]
        equal = (set(got) == set(want) == set(ref) and all(
            got[k].tobytes() == want[k].tobytes() == ref[k].tobytes()
            for k in want))
        g0, c0 = g.stats()["inference_stats"], c.stats()["inference_stats"]
        t0 = time.perf_counter()
        for _ in range(NATIVE_DIRECT_CALLS):
            g.infer(inputs)
        host_us = (time.perf_counter() - t0) / NATIVE_DIRECT_CALLS * 1e6
        for _ in range(NATIVE_DIRECT_CALLS):
            c.infer(inputs)
        g1, c1 = g.stats()["inference_stats"], c.stats()["inference_stats"]
        device, records = _d1_device_ms(lambda: g.infer(inputs), kernel)

    def per_call_ms(a, b, key):
        return (b[key]["ns"] - a[key]["ns"]) / NATIVE_DIRECT_CALLS / 1e6

    n_in, n_out = len(inputs), len(want)
    return {"model": model, "elements": n, "kernel": kernel,
            "bit_equal": equal, "launches_rose": rose, "max_abs_err":
            max(errs), "ms": per_call_ms(g0, g1, "compute_infer"),
            "device_ms": device, "device_records": records,
            "h2d_ms": per_call_ms(g0, g1, "compute_input"),
            "d2h_ms": per_call_ms(g0, g1, "compute_output"),
            "host_us_per_call": host_us,
            "plain_ms": per_call_ms(c0, c1, "compute_infer"),
            "bytes": 4 * n * (n_in + n_out),
            "ops": 0 if model == "identity" else 2 * n}


def _direct_perf(paths: dict, log_dir: str,
                 libs=("libdirect_models_cuda.so",
                       "libdirect_models_cpu.so")) -> list:
    """perf_analyzer -i direct on each model, the card's library (the
    analyzer's default: no -u) and the CPU one in turns; the card runs'
    D1 launches from the library's launch log (each process starts at
    0)."""
    import re

    runs = []
    for model in NATIVE_DIRECT_MODELS:
        for lib in libs:
            log = os.path.join(log_dir, f"{model}-{lib}.jsonl")
            env = dict(os.environ, CLIENT_TPU_TORCH_DIRECT_LAUNCH_LOG=log)
            args = [str(paths["perf_analyzer"]), "-m", model, "-i", "direct",
                    *([] if lib.endswith("cuda.so") else
                      ["-u", str(paths[lib])]), *NATIVE_DIRECT_PERF]
            out = subprocess.run(args, capture_output=True, text=True,
                                 timeout=120, env=env)
            if out.returncode != 0:
                fail(f"native: {' '.join(args[1:])} exited "
                     f"{out.returncode}: {out.stdout[-1500:]}"
                     f"{out.stderr[-1500:]}")
            nums = {}
            for key in ("client_infer_per_s", "request_count", "p50_us",
                        "p99_us", "server_window_inference_count"):
                m = re.search(_PERF_PATTERNS[key], out.stdout)
                nums[key] = float(m.group(1)) if m else None
            launches = {"add_sub": 0, "copy": 0}
            if os.path.exists(log):
                with open(log) as f:
                    for line in f:
                        for k, v in json.loads(line).items():
                            launches[k] += v
            runs.append({"model": model, "library": lib, **nums,
                         "launches": launches,
                         "stabilized": "did not stabilize" not in out.stdout})
    return runs


def _native_encoder(paths: dict, tmp: str, clients=None,
                    examples: bool = True, around=None) -> dict:
    """(c): the encoder behind this process's server, driven by the native
    perf_analyzer, then the Python perf CLI, over CUDA shm (``clients``:
    other (label, command) pairs, None for the Python CLI); then the
    cudashm examples against add_sub (unless ``examples`` is False), and
    ``around(url)`` where given, with the server still up."""
    from client_tpu_torch.models import make_add_sub
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.perf.bench_harness import build_bert_encoder
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    seq, bucket = 128, 256
    model = build_bert_encoder(seq, bucket, attn_impl="flash",
                               params_cache={}, seed=0)
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    core.register_model(make_add_sub(device=CLIENT_DEVICE))
    kinds: dict = {}
    register = core.cuda_shm.register

    def recording(name, raw_handle, device_id, byte_size):
        register(name, raw_handle, device_id, byte_size)
        kinds[name] = type(core.cuda_shm.try_attachment(name)).__name__

    core.cuda_shm.register = recording
    data = os.path.join(tmp, "bert_ids.json")
    rng = np.random.default_rng(CLIENT_SEED)
    with open(data, "w") as f:
        json.dump({"data": [{"input_ids": rng.integers(0, 127, seq).tolist()}
                            for _ in range(16)]}, f)
    extra = ["--concurrency-range", str(CLIENT_PERF_CONCURRENCY),
             "--input-data", data]
    grpc = "simple_grpc_cudashm_client" in paths
    http = HttpInferenceServer(core, port=0).start()
    grpc_srv = None
    if grpc:   # grpcio only where the C++ gRPC example was built
        from client_tpu_torch.server.grpc_server import GrpcInferenceServer
        grpc_srv = GrpcInferenceServer(core, port=0).start()
    runs, ran = [], {}
    clients = clients or (("native", [str(paths["perf_analyzer"])]),
                          ("python", None))
    try:
        for label, prog in clients:
            kinds.clear()
            e0 = _stats(core, "bert_base")["execution_count"]
            fa.launches = 0
            run = _perf_cli(core, http.url, extra, prog=prog)
            run["flash_attention_launches"] = fa.launches
            run["batches"] = _stats(core, "bert_base")["execution_count"] - e0
            run["attachments"] = sorted(set(kinds.values()))
            run["client"] = label
            runs.append(run)
        device = ["--device", CLIENT_DEVICE] if CLIENT_DEVICE else []
        for proto, url in (("http", http.url),
                           *((("grpc", f"localhost:{grpc_srv.port}"),)
                             if grpc else ())):
            if not examples:
                break
            out = subprocess.run(
                [str(paths[f"simple_{proto}_cudashm_client"]), "-u",
                 url.split("//")[-1], *device],
                capture_output=True, text=True, timeout=60)
            ran[proto] = {"rc": out.returncode,
                          "pass": "PASS" in out.stdout,
                          "tail": (out.stdout + out.stderr)[-400:]}
        extra_out = around(http.url.split("//")[-1]) if around else None
    finally:
        http.stop()
        if grpc_srv is not None:
            grpc_srv.stop()
        core.stop()
    return {"runs": runs, "examples": ran, "around": extra_out}


def phase_native(env: dict, peaks: tuple) -> dict:
    """The native C++ stack (ROADMAP 10) on the card: see the module
    docstring."""
    import tempfile

    from client_tpu_torch._native.direct import DirectLibrary

    paths, build = _native_build()
    cpu = DirectLibrary(paths["libdirect_models_cpu.so"])
    gpu = DirectLibrary(paths["libdirect_models_cuda.so"])
    cases = [_direct_case(cpu, gpu, m, n, seed)
             for seed, m in enumerate(NATIVE_DIRECT_MODELS)
             for n in (NATIVE_DIRECT_N, NATIVE_DIRECT_BIG)]
    for c in cases:
        c.update(bound(c["bytes"], c["ops"], (peaks[0], FP32_PEAK)))
        c["bound_share"] = c["bound_ms"] / c["ms"] if c["ms"] else None
    with tempfile.TemporaryDirectory() as tmp:
        direct_runs = _direct_perf(paths, tmp)
        encoder = _native_encoder(paths, tmp)
    checks = {}
    for c in cases:
        tag = f"{c['model']}_{c['elements']}"
        checks[f"{tag}_bit_equal"] = c["bit_equal"]
        checks[f"{tag}_launch_counted"] = c["launches_rose"] == 1
    for r in direct_runs:
        tag = f"direct_{r['model']}_{r['library'].split('_')[-1][:-3]}"
        checks[f"{tag}_report"] = bool(r["client_infer_per_s"]) \
            and r["request_count"] and r["p99_us"] is not None
        if r["library"].endswith("cuda.so"):
            kernel = "copy" if r["model"] == "identity" else "add_sub"
            checks[f"{tag}_launches"] = (
                r["launches"][kernel] >= r["request_count"] > 0)
    for run in encoder["runs"]:
        tag = run["client"]
        checks[f"{tag}_no_failure"] = (not run["run_failed_requests"]
                                       and not run["client_rejected"])
        checks[f"{tag}_served"] = (run["run_server_inferences"]
                                   >= run["request_count"] > 0)
        checks[f"{tag}_cross_process"] = run["attachments"] == [
            "CrossProcessAttachment"]
        checks[f"{tag}_k1"] = (run["flash_attention_launches"]
                               == LAYERS * run["batches"] > 0)
    # the server counts every request it completed between the window's
    # two snapshots, the report only those wholly inside: at most the
    # ones in flight across each edge more
    native = encoder["runs"][0]
    checks["native_window_count"] = 0 <= (
        native["server_window_inference_count"] - native["request_count"]) \
        <= 2 * CLIENT_PERF_CONCURRENCY
    for proto, ex in encoder["examples"].items():
        checks[f"example_{proto}"] = ex["rc"] == 0 and ex["pass"]
    d1 = {}
    for kernel, model in (("add_sub", "add_sub"), ("copy", "identity")):
        main = next(c for c in cases if c["model"] == model
                    and c["elements"] == NATIVE_DIRECT_N)
        lib_ms = None
        if kernel == "copy":
            a = torch.from_numpy(_direct_inputs(model, NATIVE_DIRECT_N, 0)[
                "INPUT0"]).cuda()
            dst = torch.empty_like(a)
            lib_ms = time_ms(lambda: dst.copy_(a), iters=200)
        d1[kernel] = {
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if c["kernel"] == kernel),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "host_us_per_call": main["host_us_per_call"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": lib_ms,
            "launches": sum(r["launches"][kernel] for r in direct_runs)}
    result = {"phase": "native", "card": env["nvidia_smi"], "build": build,
              "direct_cases": cases, "direct_perf": direct_runs,
              "encoder_perf": encoder["runs"],
              "examples": encoder["examples"], "checks": checks, "d1": d1,
              "flash_attention_launches": sum(
                  r["flash_attention_launches"] for r in encoder["runs"])}
    emit(result)
    if not all(checks.values()):
        fail(f"native: {[k for k, v in checks.items() if not v]}")
    return result


# ------------------------------- the example clients (ROADMAP 6b, 6d)

# the port's example modules as tests/test_examples.py runs the
# reference's scripts: (module, protocol of -u, extra arguments)
EXAMPLE_RUNS = [
    *((m, "http", []) for m in (
        "simple_http_infer_client", "simple_http_explicit_infer_client",
        "simple_http_async_infer_client", "simple_http_string_infer_client",
        "simple_http_health_metadata", "simple_http_model_control",
        "simple_http_sequence_sync_client", "simple_http_shm_client",
        "simple_http_shm_string_client", "simple_http_cudashm_client",
        "memory_growth_test", "ensemble_image_client")),
    *((m, "grpc", []) for m in (
        "simple_grpc_infer_client", "simple_grpc_async_infer_client",
        "simple_grpc_string_infer_client", "simple_grpc_health_metadata",
        "simple_grpc_keepalive_client", "simple_grpc_model_control",
        "simple_grpc_sequence_sync_client",
        "simple_grpc_sequence_stream_client",
        "simple_grpc_custom_repeat_client", "simple_grpc_shm_client",
        "simple_grpc_shm_string_client", "simple_grpc_cudashm_client",
        "simple_grpc_generate_client", "grpc_client",
        "grpc_explicit_int_content_client",
        "grpc_explicit_int8_content_client",
        "grpc_explicit_byte_content_client")),
    ("grpc_image_client", "grpc", ["{img.jpg}"]),
    ("image_client", "http", ["-c", "3"]),
    ("image_client", "grpc", ["-i", "grpc"]),
    ("base64_image_client", "http", ["{img.png}"]),
    ("infer_classification_client", "http", ["-c", "5"]),
    ("device_hub", "http", ["--events", "{events.jsonl}"]),
    ("reuse_infer_objects_client", "http", ["-g", "{grpc}"]),
]
# simple_grpc_generate_client on continuous_lm: bench.py's first ragged
# jobs' prompts, 32 tokens each
EXAMPLE_GEN_PROMPTS, EXAMPLE_GEN_TOKENS = 3, 32
# the examples run EXAMPLE_WORKERS at a time, but those that change the
# server's state (shm regions, unregistering every one; a model's load;
# the accumulator's sequences) one after another once the rest are done
EXAMPLE_WORKERS = 4
EXAMPLE_SERIAL = ("shm", "model_control", "sequence")


def _example_inputs(tmp: str) -> dict:
    """The image and event files the image examples read."""
    import base64
    import io

    from PIL import Image

    files = {}
    for name, size, fmt in (("img.jpg", 64, "JPEG"), ("img.png", 48, "PNG")):
        files[name] = os.path.join(tmp, name)
        Image.fromarray(np.zeros((size, size, 3), np.uint8)).save(
            files[name], format=fmt)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, format="JPEG")
    files["events.jsonl"] = os.path.join(tmp, "events.jsonl")
    with open(files["events.jsonl"], "w") as f:
        f.write(json.dumps({"device_id": "elevator-7", "image_b64":
                            base64.b64encode(buf.getvalue()).decode()})
                + "\n")
    return files


def _run_example(module: str, args: list) -> dict:
    """``python -m client_tpu_torch.examples.<module> args`` in a process
    of its own: exit code, PASS, seconds and stdout."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", f"client_tpu_torch.examples.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    ok = out.returncode == 0 and "PASS" in out.stdout
    if module == "device_hub" and out.returncode == 0:
        event = json.loads(out.stdout.strip().splitlines()[-1])
        ok = event.get("device_id") == "elevator-7" and "class" in event
    return {"module": module, "rc": out.returncode, "ok": ok,
            "seconds": time.time() - t0, "stdout": out.stdout,
            "tail": (out.stdout + out.stderr)[-600:]}


def _java_examples(http_url: str, tmp: str) -> dict:
    """Where a JDK is, the port's Java tree compiled and both examples run
    against the server, SimpleCudaShmClient on a region made here on the
    card; a missing JDK is reported, not failed (tests/test_java.py)."""
    import base64
    import shutil

    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    javac, java = shutil.which("javac"), shutil.which("java")
    if javac is None or java is None:
        return {"jdk": None}
    src = os.path.join(REPO, "client_tpu_torch", "java", "src")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(src) for f in fs
               if f.endswith(".java")]
    out_dir = os.path.join(tmp, "javac")
    comp = subprocess.run([javac, "-d", out_dir, *sources],
                          capture_output=True, text=True, timeout=300)
    if comp.returncode != 0:
        fail(f"examples: javac failed: {comp.stderr[-1500:]}")
    h = cudashm.create_shared_memory_region("java_cudashm_src", 128, 0)
    try:
        cudashm.set_shared_memory_region(
            h, [np.arange(16, dtype=np.int32), np.ones(16, np.int32)])
        raw = base64.b64encode(cudashm.get_raw_handle(h)).decode()
        runs = {}
        for cls, extra in (("SimpleInferClient", []),
                           ("SimpleCudaShmClient", [raw, str(h.device_id)])):
            t0 = time.time()
            r = subprocess.run(
                [java, "-cp", out_dir, f"torch.client.examples.{cls}",
                 http_url, *extra], capture_output=True, text=True,
                timeout=120)
            runs[cls] = {"rc": r.returncode, "ok": r.returncode == 0
                         and "PASS" in r.stdout, "seconds": time.time() - t0,
                         "tail": (r.stdout + r.stderr)[-400:]}
    finally:
        cudashm.destroy_shared_memory_region(h)
    return {"jdk": javac, "runs": runs}


def phase_examples(env: dict, gen_model: tuple) -> dict:
    """The port's example clients (ROADMAP 6b, 6d): see the module
    docstring."""
    import dataclasses
    import importlib.util
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import client_tpu_torch.models as tm
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    specs = {m: importlib.util.find_spec(m) for m in ("grpc",
                                                      "google.protobuf")}
    if not all(specs.values()):
        print(f"examples: find_spec: {specs}", flush=True)
        fail("examples: grpcio and protobuf must be importable here")
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer

    cfg, params, jobs = gen_model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    core = TorchInferenceServer()
    for model in (tm.make_add_sub("add_sub", 16, "INT32"),
                  tm.make_add_sub("add_sub_int8", 16, "INT8"),
                  tm.make_add_sub_string("add_sub_string", 16),
                  tm.make_identity("identity", 16, "INT32"),
                  tm.make_repeat("repeat_int32"),
                  tm.make_generator("generator_lm"),
                  tm.make_accumulator("accumulator", 1, "INT32"),
                  tm.make_preprocess(max_batch_size=4),
                  tm.make_resnet50(max_batch_size=4, dynamic_batching=False),
                  tm.make_image_ensemble(max_batch_size=4)):
        core.register_model(model)
    lm = tm.make_continuous_generator(
        "continuous_lm", cfg=cfg, params=params, n_slots=GEN_SLOTS,
        chunk_size=GEN_CHUNK, dispatch_depth=2, max_new_tokens=128,
        eos_id=-1, kv_layout="paged", device="cuda")
    core.register_model(lm, warmup=True)
    http = HttpInferenceServer(core, port=0).start()
    grpc_srv = GrpcInferenceServer(core, port=0).start()
    urls = {"http": http.url, "grpc": f"localhost:{grpc_srv.port}"}
    gen_runs, checks = [], {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            files = {**_example_inputs(tmp), "grpc": urls["grpc"]}

            def one(entry):
                module, proto, extra = entry
                run = _run_example(module, ["-u", urls[proto], *(
                    files[a[1:-1]] if a.startswith("{") else a
                    for a in extra)])
                run["protocol"] = proto
                return run

            serial = [e for e in EXAMPLE_RUNS
                      if any(k in e[0] for k in EXAMPLE_SERIAL)]
            with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
                runs = list(pool.map(one, [e for e in EXAMPLE_RUNS
                                           if e not in serial]))
            runs += [one(e) for e in serial]
            # the K2 path: the generate example on continuous_lm, the
            # counters at 0 just before and read just after
            snap0 = lm.engine.generation_snapshot()
            pa.launches = fa.launches = 0
            for prompt, _ in jobs[:EXAMPLE_GEN_PROMPTS]:
                before = lm.engine.generation_snapshot()["ttft"]
                run = _run_example("simple_grpc_generate_client", [
                    "-u", urls["grpc"], "-m", "continuous_lm", "-n",
                    str(EXAMPLE_GEN_TOKENS), "-p",
                    ",".join(str(int(x)) for x in prompt)])
                after = lm.engine.generation_snapshot()["ttft"]
                run["tokens"] = [int(x) for x in re.findall(
                    r"token\[\d+\] = (-?\d+)", run["stdout"])]
                run["prompt_len"] = len(prompt)
                run["engine_ttft_ms"] = ((after[1] - before[1])
                                         / max(1, after[2] - before[2])
                                         / 1e6)
                gen_runs.append(run)
            k2, k1 = pa.launches, fa.launches
            dispatches = (lm.engine.generation_snapshot()["chunks_dispatched"]
                          - snap0["chunks_dispatched"])
            java = _java_examples(urls["http"], tmp)
    finally:
        http.stop()
        grpc_srv.stop()
        core.stop()
    for run in runs:
        checks[f"{run['module']}_{run['protocol']}"] = run["ok"]
    for i, run in enumerate(gen_runs):
        checks[f"generate_continuous_{i}"] = run["ok"] and (
            len(run["tokens"]) == EXAMPLE_GEN_TOKENS
            and all(0 <= x < cfg.vocab_size for x in run["tokens"]))
    checks["k2_per_chunk_dispatch"] = (
        k2 == LAYERS * GEN_CHUNK * dispatches and dispatches > 0)
    checks["k1_not_launched"] = k1 == 0
    for cls, r in java.get("runs", {}).items():
        checks[f"java_{cls}"] = r["ok"]
    if not all(checks.values()):
        bad = [k for k, v in checks.items() if not v]
        tails = {f"{r['module']}_{r.get('protocol', 'grpc')}": r["tail"]
                 for r in runs + gen_runs if not r["ok"]}
        fail(f"examples: {bad}: {tails}")
    judged = [{"run": "examples_generate", "greedy_streams": [
        (np.concatenate([np.asarray(p, np.int32),
                         np.asarray(r["tokens"], np.int32)]), len(p))
        for (p, _), r in zip(jobs, gen_runs)]}]
    _judge_greedy(cfg, params, judged)
    result = {
        "phase": "examples", "card": env["nvidia_smi"],
        "grpc_spec": {m: str(s) for m, s in specs.items()},
        "seconds_by_example": {f"{r['module']}_{r['protocol']}":
                               r["seconds"] for r in runs},
        "generate_continuous": [
            {k: r[k] for k in ("prompt_len", "tokens", "seconds",
                               "engine_ttft_ms")} for r in gen_runs],
        "teacher_forced": judged[0]["teacher_forced"],
        "chunk_dispatches": dispatches,
        "paged_decode_attention_launches": k2,
        "k2_per_chunk_dispatch": k2 / dispatches,
        "java": {"jdk": java["jdk"], **{
            cls: {k: r[k] for k in ("ok", "seconds")}
            for cls, r in java.get("runs", {}).items()}},
        "checks": checks}
    emit(result)
    return result


# --------------------------------- the installed native tree (10b)

def phase_install(env: dict) -> dict:
    """The native tree installed under a prefix (ROADMAP 10b): see the
    module docstring."""
    import shutil
    import tempfile

    from client_tpu_torch import _native
    from client_tpu_torch._native.direct import DirectLibrary

    tools = _native.toolchain()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "prefix")
        t0 = time.time()
        installed = _native.install(prefix)
        install_s = time.time() - t0
        perf = os.path.join(prefix, "bin", "perf_analyzer")
        lib = os.path.join(prefix, "lib")
        checks = {
            "layout": all(os.path.isfile(os.path.join(lib, n)) for n in (
                "libhttpclient_tpu_torch.so", "libhttpclient_tpu_torch.a",
                "libcshm_tpu_torch.so", "libdirect_models_cpu.so",
                "libdirect_models_cuda.so")) and os.access(perf, os.X_OK)
            and os.path.isfile(os.path.join(
                lib, "cmake", "ClientTpuTorch", "ClientTpuTorchTargets.cmake"))}
        # D1 through the installed libraries: bit-equal to the CPU library
        # and torch, then the installed analyzer's -i direct with no -u
        # (it finds lib/libdirect_models_cuda.so), launches from the log
        cpu = DirectLibrary(os.path.join(lib, "libdirect_models_cpu.so"))
        gpu = DirectLibrary(os.path.join(lib, "libdirect_models_cuda.so"))
        cases = [_direct_case(cpu, gpu, m, NATIVE_DIRECT_N, seed)
                 for seed, m in enumerate(NATIVE_DIRECT_MODELS)]
        direct = _direct_perf({"perf_analyzer": perf}, tmp,
                              libs=("libdirect_models_cuda.so",))
        consumer = {"cmake": tools["cmake"]}

        def cmake_consumer(url):
            if tools["cmake"] is None:
                return None
            src = os.path.join(tmp, "consumer")
            os.makedirs(src)
            shutil.copy2(os.path.join(
                _native.NATIVE_DIR, "examples",
                "simple_http_infer_client.cc"), src)
            with open(os.path.join(src, "CMakeLists.txt"), "w") as f:
                f.write(
                    "cmake_minimum_required(VERSION 3.18)\n"
                    "project(consumer CXX)\nset(CMAKE_CXX_STANDARD 17)\n"
                    "find_package(ClientTpuTorch 0.1 REQUIRED)\n"
                    "add_executable(simple_http_infer_client "
                    "simple_http_infer_client.cc)\n"
                    "target_link_libraries(simple_http_infer_client "
                    "ClientTpuTorch::httpclient_tpu_torch_static)\n")
            steps = []
            for cmd in ([tools["cmake"], "-S", src, "-B", f"{src}/build",
                         f"-DCMAKE_PREFIX_PATH={prefix}"],
                        [tools["cmake"], "--build", f"{src}/build"],
                        [f"{src}/build/simple_http_infer_client", "-u", url]):
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=300)
                steps.append(r.returncode)
                if r.returncode != 0:
                    return {"rc": steps, "ok": False,
                            "tail": (r.stdout + r.stderr)[-800:]}
            return {"rc": steps, "ok": "PASS" in r.stdout}

        # K1 through the installed analyzer, then the in-tree one in the
        # same call, over CUDA shm; the consumer against add_sub meanwhile
        paths, _ = _native_build()
        encoder = _native_encoder(paths, tmp, clients=(
            ("installed", [perf]),
            ("in_tree", [str(paths["perf_analyzer"])])), examples=False,
            around=cmake_consumer)
        consumer.update(encoder["around"] or {})
    for c in cases:
        checks[f"direct_{c['model']}_bit_equal"] = c["bit_equal"]
        checks[f"direct_{c['model']}_launch_counted"] = c["launches_rose"] == 1
    for r in direct:
        kernel = "copy" if r["model"] == "identity" else "add_sub"
        checks[f"direct_perf_{r['model']}"] = (
            bool(r["client_infer_per_s"]) and r["p99_us"] is not None
            and r["launches"][kernel] >= r["request_count"] > 0)
    for run in encoder["runs"]:
        tag = run["client"]
        checks[f"{tag}_no_failure"] = (not run["run_failed_requests"]
                                       and not run["client_rejected"])
        checks[f"{tag}_k1"] = (run["flash_attention_launches"]
                               == LAYERS * run["batches"] > 0)
        checks[f"{tag}_cross_process"] = run["attachments"] == [
            "CrossProcessAttachment"]
    if tools["cmake"] is not None:
        checks["cmake_consumer"] = consumer.get("ok", False)
    installed_run = encoder["runs"][0]
    result = {
        "phase": "install", "card": env["nvidia_smi"],
        "install_s": install_s, "installed": sorted(installed),
        "cmake": consumer, "direct_cases": cases, "direct_perf": direct,
        "encoder_perf": encoder["runs"],
        "installed_over_in_tree_infer_per_s": (
            installed_run["client_infer_per_s"]
            / encoder["runs"][1]["client_infer_per_s"]),
        "flash_attention_launches": installed_run["flash_attention_launches"],
        "d1_launches": {k: sum(r["launches"][k] for r in direct)
                        for k in ("add_sub", "copy")},
        "checks": checks}
    emit(result)
    if not all(checks.values()):
        fail(f"install: {[k for k, v in checks.items() if not v]}: "
             f"{consumer.get('tail', '')}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available: the smoke test runs on the card only")
    if not os.path.isdir(os.path.join(REPO, "client_tpu_torch", "ops",
                                      "csrc")):
        fail("client_tpu_torch/ops/csrc is missing beside chip_smoke.py: "
             "run it from a checkout of the repository")
    sys.path.insert(0, REPO)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t0
        return out

    env = phase_env()
    peaks = card_peaks(env["device"])
    timed("build", phase_build)
    timing = timed("kernel_flash", phase_kernel, peaks)
    paged_timing = timed("kernel_paged", phase_paged_kernel, peaks)
    serve = timed("serve", phase_serve)
    serve_shm = timed("serve_shm", phase_serve_shm)
    gen_model = timed("generation_model", _generation_model)
    generate = timed("generate", phase_generate, gen_model)
    generate_slot = timed("generate_slot", phase_generate_slot, gen_model)
    generate_prefix = timed("generate_prefix", phase_generate_prefix,
                            gen_model)
    stream_context = timed("stream_context", phase_stream_context, gen_model)
    speculate = timed("speculate", phase_speculate, gen_model)
    schedule = timed("schedule", phase_schedule, gen_model)
    lanes = timed("lanes", phase_lanes, gen_model, generate_slot["runs"][0])
    observe = timed("observe", phase_observe, gen_model)
    supervise = timed("supervise", phase_supervise, gen_model)
    goodput = timed("goodput", phase_goodput, gen_model)
    client = timed("client", phase_client)
    timed("models", phase_models, env)
    timed("generators", phase_generators, env)
    fleet = timed("fleet", phase_fleet, gen_model, env)
    autoscale = timed("autoscale", phase_autoscale, gen_model, env)
    train = timed("train", phase_train, env, peaks)
    mesh = timed("mesh", phase_mesh, env)
    fleet_mesh = timed("fleet_mesh", phase_fleet_mesh, env)
    native = timed("native", phase_native, env, peaks)
    examples = timed("examples", phase_examples, env, gen_model)
    install = timed("install", phase_install, env)
    emit({"phase": "seconds", **seconds})

    def row(name, source, replaces, launches, t, **paths):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_path": paths,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "device_ms": t["device_ms"],
                "host_us_per_call": t["host_us_per_call"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    emit({"kernels": [
        row("flash_attention",
            "client_tpu_torch/ops/csrc/flash_attention.cu",
            "client_tpu/ops/flash_attention.py:36",
            serve_shm["flash_attention_launches"], timing,
            serve=serve["flash_attention_launches"],
            serve_shm=serve_shm["flash_attention_launches"],
            serve_shm_headline=serve_shm["headline"][
                "flash_attention_launches"],
            observe=observe["encoder"]["flash_attention_launches"],
            supervise_encoder=supervise["runtime"][
                "flash_attention_launches"],
            client=client["flash_attention_launches"],
            train=train["flash_attention_launches"],
            mesh=mesh["flash_attention_launches"],
            native=native["flash_attention_launches"],
            install=install["flash_attention_launches"]),
        row("paged_decode_attention",
            "client_tpu_torch/ops/csrc/paged_attention.cu",
            "client_tpu/ops/paged_attention.py:52",
            generate["paged_decode_attention_launches"], paged_timing,
            generate=generate["paged_decode_attention_launches"],
            generate_slot_chunked_paged=generate_slot["runs"][2][
                "paged_decode_attention_launches"],
            generate_prefix_paged=generate_prefix["runs"][1][
                "paged_decode_attention_launches"],
            stream_context_paged=stream_context["runs"][0][
                "paged_decode_attention_launches"],
            speculate_paged=speculate["runs"][2][
                "paged_decode_attention_launches"],
            schedule_paged=schedule["runs"][0][
                "paged_decode_attention_launches"],
            tier_paged=schedule["runs"][2][
                "paged_decode_attention_launches"],
            lane_paged=lanes["runs"][1]["paged_decode_attention_launches"],
            lane_paged_batch=lanes["runs"][2][
                "paged_decode_attention_launches"],
            observe_off=observe["runs"][0][
                "paged_decode_attention_launches"],
            observe_paged=observe["runs"][1][
                "paged_decode_attention_launches"],
            supervise_clean=supervise["clean"][
                "paged_decode_attention_launches"],
            supervise_crash=supervise["crash"][
                "paged_decode_attention_launches"],
            **{f"{r['run']}_{k}": r["paged_decode_attention_launches"]
               for k, r in enumerate(supervise["watchdog_runs"])},
            **{r["run"]: r["paged_decode_attention_launches"]
               for r in goodput["runs"]},
            goodput_window=goodput["window"][
                "paged_decode_attention_launches"],
            **{f"fleet_{r['run']}_r{rep}": n for r in fleet["runs"]
               for rep, n in sorted(r[
                   "paged_decode_attention_launches_by_replica"].items())},
            **{f"{r['run']}_r{rep}": n for r in autoscale["runs"]
               for rep, n in sorted(r[
                   "paged_decode_attention_launches_by_replica"].items())},
            train=train["paged_decode_attention_launches"],
            mesh=mesh["paged_decode_attention_launches"],
            **{f"mesh_{label}_{side}": arm["paged_decode_attention_launches"]
               for label, pair in mesh["planes"].items()
               for side, arm in pair.items()},
            **{f"{arm['run']}{k}_r{rep}": n
               for k, arm in enumerate(fleet_mesh["runs"])
               for rep, n in sorted(arm[
                   "paged_decode_attention_launches_by_replica"].items())},
            examples=examples["paged_decode_attention_launches"]),
        # D1: the DIRECT library's kernels, no Pallas port: they stand in
        # for the StableHLO programs the JAX package's device-backed
        # library compiles through PJRT
        *(row(f"direct_{k}",
              "client_tpu_torch/native/src/direct_models_cuda.cu",
              "native/src/direct_models_pjrt.cc:207", d["launches"], d,
              native_direct=d["launches"],
              install_direct=install["d1_launches"][k])
          for k, d in native["d1"].items()),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--client-process"]:
        sys.path.insert(0, REPO)
        sys.exit(_client_process(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--profile-process"]:
        sys.path.insert(0, REPO)
        sys.exit(_profile_process(json.loads(sys.argv[2])))
    sys.exit(main())
