#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``repro_torch``), one H100.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --kernels NAME,...   # build + kernel_check only

Phases, each printing one JSON line (any failure raises and exits non-zero):

  build         build every CUDA kernel of the serving and training paths
                from ``src/repro_torch/csrc`` with nvcc for sm_90a, one
                nvcc per source, all at once (eight sources; the expert
                GEMM's backward is its forward's kernel)
  kernel_check  each kernel against its plain PyTorch version on the card,
                at minitron-8b's attention shapes (Hq=32, Hkv=8, D=128,
                page_size=16), deepseek-moe-16b's (Hq=Hkv=16; experts
                E=64, D=2048 <-> F=1408) and rwkv6-3b's (H=40 heads of
                N=64), float32 within 1e-4, bfloat16 within one bf16 ulp
                plus 1e-4 (under a 2e-2 ceiling), each relative to the
                output's scale where that is not 1 (the expert GEMM and the
                WKV scan); median time of each over 50 launches with L2
                flushed in between, beside the plain version's, the bound,
                and one PyTorch call's where one computes the same
                function (flash and dense decode:
                scaled_dot_product_attention; expert GEMM: torch.bmm):
                  ragged       decode (8 slots, kv_len 1..2048), prefill
                               (max_q=128), idle rows; decode and prefill
                               again at deepseek's G=1 and at a tp = 2
                               rank's 16 over 4 heads; the speculative
                               verify's windows, 8 of K+1 queries at G=4
                               (verify_k3, verify_k4; kv_len 100..2048);
                               untimed, the draft catch-up's 8 segments of
                               1 or 2 queries, and the edges
                               of the paged tensor-core walk: page sizes 8
                               and 128, prefill segments packed back to
                               back, D=64 at G=3, D=16, kv_len off the
                               64-key tiles beside an idle segment, a
                               4096-key table at 2 slots (the split's cap),
                               and D=72, which takes the CUDA-core walk in
                               bf16 too
                  paged decode 8 slots, lengths 0..2048; untimed, the same
                               edges
                  flash        prefill (2 rows x 128 queries), partial
                               chunk (37 queries), dense decode (8 slots,
                               Sq=1), sliding window (mistral-7b-swa's
                               W=4096 at 8192 keys); prefill and decode
                               again at deepseek's G=1; untimed, the
                               tensor-core tile edges: D=64 (Hq 24 over
                               Hkv 8) at 37 queries, D=16, a row with
                               kv_len 0 beside a 24-key window (16
                               queries and a decode), and D=72, which
                               takes the CUDA-core walk in bf16 too
                  expert GEMM  a mixed step's up/gate (C=264 packed tokens,
                               x broadcast over the experts) and down
                               products, the decode-only step's (C=8), the
                               mixed shape with distinct per-expert x, and
                               two ragged cases (C, D, F off the tiles),
                               jamba's four, and an expert-parallel
                               rank's buffer (ep_local, ep_local_down:
                               E=20, C=512, D=1536 <-> F=512, each
                               expert's own tokens); untimed, C=1,
                               C=600 broadcast (three C tiles) and
                               granite-moe-3b-a800m's mixed up/gate
                               (E=40, D=1536, F=512); each line
                               names the route (bf16: wgmma; f32:
                               cuda_core) and the bf16 launch plan, and
                               the build line gives ptxas's registers,
                               spills and shared memory of every instance
                  WKV scan     prefill (2 rows x 128 steps), partial chunk
                               (37 steps), decode (8 rows x 1 step); a
                               non-zero state0 and bonus, decays in
                               (0.45, 0.95); out and final state both held;
                               untimed, the decode in place at N 64,
                               N 16 and 32 at 37 steps; after every other
                               kernel's profiles (so that they are timed
                               as before), the plan's edges: the decode
                               in place at N 16 and 32, 161 steps (ring
                               turns and a ragged tail), one row (80
                               blocks), no step (the final state is
                               state0), decays exp(-exp(x)) for x in
                               [-8, 3]; the line prints the bf16 plan
                  dense decode 8 rows against a 2048-key cache, lengths
                               0..2048, at G=4 and at deepseek's G=1;
                               untimed, G=3 at D=64
                  flash backward
                               qwen1.5-0.5b's training shape (8 x 1,024,
                               16 heads of 64, causal), minitron-8b's
                               G=4 at D=128 over 1,024 tokens, a 512-key
                               window at 2,048, a 128-query chunk against
                               kv_len 1,500 and 256 (q_offset), rows
                               with no visible key (kv_len 0 beside a
                               24-key window), hubert's bidirectional
                               pass at D=80 and granite-moe-3b-a800m's
                               G=3 at D=64 over 1,024 tokens, each
                               timed: dq, dk, dv
                               against the plain backward on the same o
                               and lse (each relative to its gradient's
                               scale), the forward kernel's lse against
                               the plain lse; library: SDPA's backward
                  expert GEMM backward
                               granite-moe-3b-a800m's training shapes (E
                               40, D 1,536 <-> F 512, 1,024 tokens): the
                               up/gate products' dX with x broadcast (one
                               1,024 x 20,480 x 1,536 product) and dW, the
                               down product's per-expert dX and dW, each
                               timed beside torch.bmm (einsum where x is
                               broadcast), and the four gradients of an
                               expert-parallel rank's buffer (E 20, C
                               512, x per expert: ep_dx_up, ep_dw_up,
                               ep_dx_down, ep_dw_down); untimed, 37
                               tokens (dW's depth padded to 40), both
                               gradients
                  WKV backward rwkv6-3b's training micro-batch (1 row x
                               1,024 steps) from a zero state, a partial
                               chunk (77 steps, 2 rows) from a non-zero
                               state with a final-state gradient, timed;
                               untimed, N 16; dr, dk, dv, dw, du and the
                               initial state's gradient against the plain
                               reverse walk on the same boundary states,
                               the forward's own boundary states against
                               the plain ones, and its out and final state
                               unchanged by writing them
                the ragged, paged decode, flash, dense decode and flash
                backward lines name the route each dtype took (bf16 at
                D % 16 == 0, D <= 128: tensor_core, and wgmma for the flash
                backward; else cuda_core) and the bf16 launch plan
  decode_op     the dense decode's path: kernels.ops.decode_attention, its
                entry point (no model routes to it, as in the reference),
                once per layer of a minitron-8b decode step; its launches
                must equal the calls
  serve_full    minitron-8b at its published width (32 layers, random bf16
                weights drawn on the card from a seed) served through
                ServeEngine(EngineConfig(cache_layout="paged", unified=True)):
                8 greedy requests of 100-1500 prompt tokens, 32 new tokens
                each, first on the eager engine (graphs=False), then on the
                replay engine (the main path: each step one CUDA-graph
                replay), each engine warmed by one short request that binds
                (on the replay engine: captures) both step profiles; in
                each run the ragged kernel's launch count must equal
                n_layers x (2 x mixed steps + decode-only steps), every
                launch on the tensor-core route, and dispatches == d2h
                copies == steps; each line gives TTFT, TPOT, tokens/s, host
                ms per step, the device ms of each step's profile run (CUDA
                events around it), the captures per profile (exactly 1),
                capture seconds and graph-pool MB; an eager_vs_replay line
                holds the two runs' greedy outputs token-identical (or
                parting only at a genuine tie, top-2 logit gap < 1e-4)
  serve_profile the same model and replay engine under torch.profiler for a
                short serve, no capture inside it: device time by kernel
                class (a replay's kernels keep their names), graph launches
                (at least one per dispatch), the device's busy share of the
                wall clock
  serve_prefix  the same model on the unified replay engine, a seeded
                multi-tenant, multi-turn trace (24 root requests of 3
                tenants x 2 system prompts of 512-1024 tokens, 16-128
                fresh tokens each, 16-32 new tokens, follow-up turns that
                carry their whole history: 38 requests) replayed at its own
                clock (time_scale 1) with the prefix cache off, on, and off
                again, each engine warmed by one short request; in each replay
                every request finishes, no profile is captured (a hit only
                changes staged lengths and page-table rows), the ragged
                launches equal n_layers x (2 x mixed + decode-only
                forwards), d2h copies == steps and dispatches == steps +
                copy-on-write forks, and the allocator and the radix tree
                pass their audits; with the cache on it must hit and prefill
                fewer tokens; a prefix_vs_off line gives prefill tokens,
                TTFT, TPOT, tokens/s and host and device ms per step side
                by side, and how many requests' outputs match token for
                token, cache on against off and off against off, with each
                divergence's position and, where the prompts were the same,
                its top-2 logit gap (reported, not asserted: a replay
                follows the trace's clock, so the batches a token shares
                differ from run to run, and in bf16 at full width that can
                move a near-tie)
  serve_spec    the same model and the 8 requests of serve_full through the
                unified engine with speculative decoding, K = 4 (the
                reference bench's default): spec off (replay), a self-draft
                (draft_model=model, its own mirrored KV pool; eager, then
                replay, and an eager_vs_replay line), and a perturbed
                full-width draft, the target's weights times (1 + 0.04
                N(0, 1)) from a seed (replay); each round (draft catch-up,
                K-1 proposals, target verify, accept/reject, first-token
                samples) one replay and one d2h copy; in each run every
                request finishes, dispatches == d2h copies == steps, one
                capture per profile, the ragged launches exactly L_t (2 m +
                d) + L_d ((K+1) m + K d) for m mixed and d decode-only
                rounds, all on the tensor-core route, every other kernel 0;
                each line gives tokens/s, TTFT, TPOT, host and device ms per
                step, the acceptance rate, tokens per round, bonus windows,
                captures, capture seconds, graph-pool MB and peak memory;
                a spec_rejections line gives, for each window a draft
                rejected, the target's top-2 logit gap where the window
                committed the target's token: every self-draft one must be
                under SPEC_BF16_TIE_GAP (bf16 noise between the draft's and
                the verify's batch shapes; the perturbed draft's are
                recorded); a spec_vs_off line per draft gives outputs
                identical to spec off, each parting's position and top-2 gap
                (recorded, not required, in bf16) and the peak memory over
                spec off
  serve_two_dispatch
                the same model and requests through the two-dispatch
                engine, EngineConfig(cache_layout="paged", unified=False)
                and EngineConfig(cache_layout="dense"), eager then replay
                (each prefill chunk, row reset, insert, first-token sample
                and decode step one replay; one prefill profile per chunk
                width), each engine warmed by the serve's own prompts (2
                new tokens each), so that every width is captured before
                the timed serve and none during it; the profile runs
                counted by class (prefill runs == prefill calls, decode
                runs == decode steps, all runs == dispatches); launch counts
                exact in each run: paged decode n_layers x decode steps and
                flash n_layers x prefill calls (paged); flash n_layers x
                (prefill calls + decode steps) (dense), every flash and
                paged decode call on the tensor-core route (each line
                prints the calls of each route); each line gives the
                captures per profile and the widths, capture seconds,
                graph-pool MB, host ms per step, device ms per step and per
                run of each profile class; eager_vs_replay lines as above;
                a cold line: the dense replay engine with no warm-up, every
                capture inside its serve; then serve_profile of the dense
                replay engine (warmed the same way), where flash launches
                most
  serve_kvq     the int8 KV cache (kv_quant) on the same weights and the
                same 8 requests, the replay engine in all three modes
                (warmed as above): K/V quantized on every write, and every
                read through the kernels over the dequantized view (one
                pass per tensor into buffers the layers share); launch
                counts exact: ragged n_layers x (2 x mixed + decode-only)
                (unified), flash n_layers x (prefill calls + decode steps)
                and paged decode 0 (paged two-dispatch: the quantized
                decode gathers the slots' pages and runs flash at Sq = 1,
                the reference's gather route), flash n_layers x (prefill
                calls + decode steps) (dense), all on the tensor-core
                route; each line gives kv_reserved_bytes, peak memory and
                the engine's own memory beside the unquantized serve's,
                TTFT, TPOT, tokens/s, host and device ms per step; a
                kvq_vs_full line per mode: how many bf16 outputs equal
                the unquantized ones, and each parting's top-2 logit gap
                under the full-precision model (recorded, not required);
                then serve_profile of each
                quantized engine (classes kv_dequantize and gather beside
                the kernels)
  serve_disagg  P/D disaggregation on the same model: a DisaggCluster
                (max_seq 2048, 16-token pages, 128-token chunks, 2 prefill
                rows, 8 decode slots, the device link) serves the 8
                requests of serve_full, its decode pool unified and then
                two-dispatch, each cluster warmed first (every profile
                captured: the prefill pool's mixed step, the decode
                pool's decode, the page copy): every prompt prefills in
                the unified prefill engine, exports at its first token,
                migrates page by page (one replay of the cluster's copy,
                every tensor of every layer, per migration) and decodes in
                the decode engine; in each run 8 migrations, every request
                done, no capture, each engine's profile runs equal its
                dispatches, and launches exact: ragged n_layers x (2 x
                mixed + decode-only) over the prefill engine's packed
                steps and, unified, the decode engine's; two-dispatch,
                paged decode n_layers x decode steps and flash n_layers x
                local prefill calls; every call on the tensor-core route;
                the line gives tokens/s, TTFT with and without migration,
                TPOT, host ms per cluster step, each engine's device ms per
                cluster step, migrations, pages, bytes, device ms per copy
                against its bytes bound, pool utilisation, peak memory, and
                how many outputs equal serve_full's (recorded)
  beam          beam search on the same model: beam 4 on one prompt, 16
                new tokens, the dense cache; flash launches exactly
                n_layers x (1 prefill + 15 decode steps), tensor-core route
  serve_parity  minitron-8b widths at 2 layers in float32, each engine mode
                served on the replay engine through the kernels and with
                the plain versions selected explicitly, and on the eager
                engine through the kernels: greedy outputs token-identical
                between kernel and plain, replay and eager, and across the
                three modes, or diverging only at a genuine tie (top-2
                logit gap < 1e-4); both two-dispatch layouts on 8 prompts
                of 1,500-2,000 tokens (prefill-only steps back to back),
                eager against replay, all 8 token-identical; then, with the
                same exactness, the
                prefix cache: page-aligned two-tenant requests submitted
                together (two of them full hits that fork their tail page)
                cache on against off, through the kernels and the plain
                versions; a full hit's fork against its shared tail page
                set to 1e9 in every layer after the fork; a 48-page pool
                that must evict cached pages against the cache-off engine;
                and the cache-on serve under debug_guards
  kvq_parity    the int8 KV cache at minitron-8b widths, 2 layers, float32,
                on the eager engine (the quantized replay engines are held
                by serve_kvq and debug_guards), each mode through the
                kernels and the plain versions, and
                the paged two-dispatch layout against the dense one: exact
                up to TIE_GAP; the unified step against each two-dispatch
                layout recorded, beside the first layer's K/V projected in
                the unified and the two-dispatch batch shapes: the f32
                values differing in any bit, and the int8 codes that
                differ (a whole scale step each)
  spec_parity   speculative decoding at minitron-8b widths, 2 layers,
                float32, K = 4, exact up to TIE_GAP: self-draft and
                perturbed draft against spec off, through the kernels and
                the plain versions; the self-draft's acceptance 1.0 (each
                rejected window must sit at a tie, reported); the perturbed
                draft's strictly between 0 and 1; a 32-page pool that
                preempts (8 requests of 64-192 prompt tokens and 48 new
                ones) against spec off in the default pool; a prefix-cache
                full hit's fork with the shared original set to 1e9 in both
                pools, against cache off; the batch-1 SpeculativeDecoder
                at temperature 0 (flash on its dense caches; its
                temperature floor of 1e-4 makes it greedy beyond a top-2
                gap of 2e-3) against the engine's greedy outputs; the spec
                engine under debug_guards
  disagg_parity the cluster at minitron-8b widths, 2 layers, float32, with
                debug_guards, on replay engines, exact up to TIE_GAP: both
                decode pools through the kernels against the plain
                versions and against the unified engine; a 32-page decode
                pool that preempts mid-migration (both decode pools); the
                source pages set to 1e3 as each migration lands (outputs
                identical); the int8 KV cache, kernel against plain
                (required) and against the quantized unified engine
                (recorded)
  beam_parity   beam 4 at minitron-8b widths, 2 layers, float32, kernel
                against plain, without and with an eos id: the same
                tokens, scores within 1e-4
  debug_guards  minitron-8b widths at 2 layers in bf16, the unified and the
                paged two-dispatch replay engines, each in full precision
                and with the int8 KV cache, with
                EngineConfig(debug_guards=True): token-identical to the
                unguarded engines; a .item() inside the step guard raises
                (torch.cuda.set_sync_debug_mode("error")); binding a
                profile again, or a foreign key, raises "recapture"
  serve_moe     deepseek-moe-16b at its published width (28 layers, 64
                routed experts top-6 + 2 shared, random bf16 weights drawn
                on the card from a seed) through the unified engine, eager
                then replay, after minitron-8b's weights are freed: the same
                8 requests; the expert GEMM's launches must equal n_layers
                x 3 x dispatches and the ragged kernel's n_layers x (2 x
                mixed steps + decode-only steps); then serve_profile of the
                replay engine
  serve_parity  again at deepseek-moe-16b widths, 2 layers, float32
  kvq_parity    again at deepseek-moe-16b widths, 2 layers, float32
  spec_parity   again at deepseek-moe-16b widths, 2 layers, float32
  kvq_parity    again at mistral-7b-swa widths (window 4096), 2 layers,
                float32, in the dense and paged two-dispatch layouts (the
                latter serves a window only with the int8 cache)
  serve_rwkv    rwkv6-3b at its published width (32 RWKV-6 layers, random
                bf16 weights drawn on the card from a seed, the token-shift
                mixes and the bonus drawn non-zero) through the dense and
                the paged two-dispatch engines, eager then replay, after
                deepseek's weights are freed: the same 8 requests; the WKV
                scan's launches must equal n_layers x (prefill calls +
                decode steps) and every other kernel's 0; the lines, the
                warm-up and the cold line as serve_two_dispatch's; then
                serve_profile of the dense replay engine
  serve_parity  again at rwkv6-3b widths, 2 layers, float32, mixes and
                bonus drawn non-zero, in the two two-dispatch layouts (the
                long prompts too)
  scenario      GenZ against the card, after rwkv6-3b's weights are
                freed: one Scenario per mode (minitron-8b given inline, so
                at its published width, bf16, random weights from seed 0;
                Workload(batch=8, tau_p=1024, tau_d=32); hgx-h100x1;
                max_slots 8, max_seq 2048, 2 prefill rows; ChunkedSpec(128,
                8) outside monolithic): monolithic (the dense two-dispatch
                engine, one 1,024-token chunk a prompt), chunked (the
                unified engine), speculative (K = 4, the draft a second
                full-width model from the same seed) and disaggregated
                (DisaggSpec(total_npus=2, colocated_tp=1, tp_options=(1,)):
                a DisaggCluster whose split the plan picks, its decode pool
                unified; the prediction prices two NPUs, the card runs
                both pools).  Each: the analytical Report (max_workers=1),
                then engine_backend.lower, a warm-up of 2-token requests,
                the counters reset, serve and the Report; fails on a
                Report not ok, a clamp, a profile bound twice or during
                the serve, or launches off their formula (flash n_layers x
                (prefill calls + decode steps); ragged n_layers x (2 x
                mixed + decode-only), with speculation L_t (2 m + d) + L_d
                ((K+1) m + K d), over both engines of the cluster), all on
                the tensor-core route; its line gives the predicted and
                measured TTFT, TPOT, tokens/s, max concurrency,
                compare()'s relative errors (recorded, not held), the
                engine config, captures, host and device ms per step and
                the launches; then one cold evaluate() of monolithic (its
                captures inside its TTFT) and the phase's seconds
  serve_tp      the sharded unified engine (serving/sharded.py), after every
                earlier model is freed: two ranks spawned with the kernels
                already built, sharing the one card over gloo (every
                collective staged through pinned host memory; gloo cannot
                be captured, so graphs=False, and an engine with graphs on
                must be refused), each drawing its shard of full-width
                minitron-8b from seed 0 in bf16, tp = 2 then pp = 2, serving
                serve_full's 8 requests; on each rank ragged launches
                exactly (n_layers / pp) x (2 x mixed + decode-only steps)
                on the tensor-core route, every other kernel 0, collectives
                65 a step at tp = 2 (2 x 32 all-reduces + the logits
                gather) and 3 at pp = 2 (2 hops + 1 broadcast), dispatches
                == d2h copies == steps; both ranks' outputs identical; each
                rank's line gives tokens/s, TTFT, TPOT, step ms, peak
                memory and its label: two ranks on one card are not a
                measure of tp across cards.  With two or more cards the
                nccl route runs too (a card a rank, graphs on); else a line
                says it was not run
  tp_parity     minitron-8b widths at 2 layers in float32: the tp = 1
                unified replay engine, then tp = 2 and pp = 2 (one layer a
                stage) on two gloo ranks, through the kernels and the plain
                versions: both ranks identical, and every run
                token-identical to tp = 1 and kernel to plain, up to a
                genuine tie (top-2 gap under TIE_GAP)

  train         qwen1.5-0.5b at its published width (24 layers, d_model
                1,024, a tied 151,936-token head; 463,987,712 parameters,
                random weights from seed 0) through launch/train.py's code
                path: 10 AdamW steps of 8 x 1,024 tokens in float32, then
                with bf16 weights (m and v float32); the loss must fall
                (last-5 mean 0.2 under the first-5), flash forward and
                backward launch exactly 24 x micro-batches x steps times on
                the dtype's route, every other kernel 0, and the last
                step's checkpoint must commit; the line gives the loss
                curve, ms a step split into forward, backward and optimizer
                (CUDA events), tokens/s and peak memory
  train_parity  float32, 2 layers at qwen1.5-0.5b's, deepseek-moe-16b's and
                rwkv6-3b's widths, 8, 1 and 2 x 1,024 tokens (deepseek's 8
                did not fit the card): a trainer through the
                kernels against one through the plain versions from the
                same weights and batches: step-0 gradients within 1e-4 of
                each leaf's scale, 5 steps' losses within 1e-4; exact
                launches of every kernel, forward and backward; the plain
                one launches nothing
  train_restart launch/train_faulty.py's configuration on the card (reduced
                deepseek-7b, float32, 40 steps, a failure at step 25, a
                checkpoint every 10): the restarted weights within 1e-5 of
                the uninterrupted run's, and whether they are equal bit for
                bit
  train_moe     granite-moe-3b-a800m's first 4 of 32 layers at its
                published width (d_model 1,536, 40 experts of 512, top-8,
                a tied 49,155-token head), bf16 weights (m, v and the accumulator
                float32), launch/train.py's code path, 5 AdamW steps of
                8 x 1,024 tokens in 1,024-token micro-batches: the loss
                falls (last half's mean 0.2 under the first half's), flash
                and the expert GEMM launch exactly per layer, micro-batch
                and step, forward and backward apart, on tensor cores; the
                last checkpoint commits; ms a step by part, tokens/s, peak
                memory, the cut of depth and its bytes
  train_rwkv    rwkv6-3b's first 4 of 32 layers at its published width
                (d_model 2,560, 40 heads of 64), the same: the WKV scan
                and its backward 4 x 8 x steps each
  train_jamba   jamba-v0.1-52b's first 2 layers at full width (a Mamba
                layer with the dense MLP, one with 16 experts of 14,336),
                2 x 1,024 tokens a step: the expert GEMM 3 and its backward
                6 a micro-batch; the Mamba scan plain torch; the cut of
                depth and its bytes on the line
  mesh_parity   mesh-sharded training (build_model(mesh=), two gloo
                ranks sharing the card, f32, granite-moe-3b-a800m's widths
                at 2 layers, 2 x 256 tokens, every model from seed 0):
                against the single-rank model's loss and step-0 gradients,
                the (data 1, model 2) mesh expert-parallel at capacity 8.0
                through the kernels (tokens partitioned over the ranks and
                not) and through the plain versions, and the (data 2,
                model 1) mesh: loss within 1e-5 relative, gradients within
                1e-4 of each leaf's own scale (max |g|) on the rank's
                slices, each leaf's scale and error on the line; the
                kernel runs' launches exact (flash and its
                backward 1 a layer, the expert GEMM 3 and its backward 6 a
                MoE layer, CUDA-core routes), 2 all-to-alls forward and 2
                backward a MoE layer, no drop; at capacity 1.25 each rank's
                drops and loss recorded
  train_mesh    launch/train.py's --devices 2 --tp 2 code path
                (make_trainer(mesh=), Trainer.run) on two gloo ranks
                sharing the card: granite-moe-3b-a800m's first 4 of 32
                layers at full width, bf16 weights (m and v f32), a (data
                1, model 2) mesh (12 of 24 heads over 4 of 8 KV heads and
                20 of 40 experts a rank), 2 x 1,024 tokens a step, 3 steps,
                capacity 1.25 with the tokens partitioned over the two
                ranks before routing (moe_partition_tokens, as the
                reference's dryrun runs its MoE cells: both ranks then
                train the same replicated weights; E_local 20, C_cap 512);
                on each rank the launches exact (flash and its
                backward once a layer and step on tensor cores and wgmma,
                the expert GEMM 3 and its backward 6 a MoE layer and step
                on wgmma), the token all-to-alls 2 forward and 2 backward a
                MoE layer and step, the losses finite, the gathered last
                checkpoint committed; each rank's line: losses, ms a step
                by part, each collective's host ms apart, drops, peak
                memory, and its label: two ranks on one card measure
                nothing of collectives across cards

A replay does not run the kernel wrappers: the step graph adds each
capture's launch counts on every replay, so the counts above hold on both
engines with the same formulas.

After the phases: the card's name and power limit (nvidia-smi), one JSON
line listing every kernel (launches summed over its main-path runs,
error, times, bound), and last ``{"ok": true, "device": {...}}``.  Without
a CUDA device it exits 1 and prints no result.  Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_ATOL = 1e-4  # kernel vs plain, float32: f32 sums in different orders
# kernel vs plain, bfloat16: both accumulate in f32 (within F32_ATOL) and
# round once, so an element may differ by one bf16 ulp (<= 2^-7 |want|)
# more; never more than BF16_ATOL in all
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 2e-2
TIE_GAP = 1e-4  # serve_parity: a divergence is a tie below this gap
# the batch-1 SpeculativeDecoder samples at a temperature of at least 1e-4
# (as the reference's does): there a runner-up within 20 x 1e-4 of the top
# logit keeps a probability above e^-20 and may be drawn, so the decoder
# is greedy only beyond that gap
DECODER_TIE_GAP = 20 * 1e-4
# serve_spec, bf16 at full width: the self-draft runs the target's weights
# at other batch shapes than the verify, so the two round apart by bf16
# noise; a self-draft rejection must sit where the target's top-2 logit gap
# is within that noise.  The bound sits above the widest gap at which a
# full-width bf16 spec round and spec off were seen to part (0.094, H100)
SPEC_BF16_TIE_GAP = 0.125
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate, published
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores, published
TIMED_LAUNCHES = 50
PLAIN_LAUNCHES = 5  # the plain versions are no yardstick: a median of 5
SPIN_CYCLES = 5_000_000  # ~3 ms at H100 clocks: longer than any enqueue
DEV = "cuda"


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - T0}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel_check
# ---------------------------------------------------------------------------

HQ, HKV, D, PS, MAX_PAGES = 32, 8, 128, 16, 128  # minitron-8b attention

# (q_len, kv_len) segments in the engine's fixed layouts: the decode
# sub-batch (8 slots at offsets 0..7, one idle) and the prefill sub-batch
# (2 rows of a 128-token chunk each)
PROFILES = {
    "decode": dict(max_q=1, segs=[(1, 1), (1, 17), (1, 255), (0, 0),
                                  (1, 640), (1, 1024), (1, 1500),
                                  (1, 2048)]),
    "prefill": dict(max_q=128, segs=[(128, 1500), (37, 293)]),
    "prefill_idle": dict(max_q=128, segs=[(100, 100), (0, 0)]),
}
# the same decode and prefill segments at deepseek-moe-16b's attention
# (16 query heads over 16 KV heads: G = 1)
DS_HEADS = dict(hq=16, hkv=16)
PROFILES["deepseek_decode"] = dict(PROFILES["decode"], **DS_HEADS)
PROFILES["deepseek_prefill"] = dict(PROFILES["prefill"], **DS_HEADS)
# untimed, the edges of the paged tensor-core walk: page sizes 8 and 128
# (a page a fraction of a 64-key tile, and two tiles a page); prefill
# segments packed back to back (q_start 0, 37, 137: a row written past
# its segment lands on the next one); granite-moe's D = 64 at G = 3 and
# the reduced configs' D = 16; kv_len off the 64-key tiles beside an idle
# segment; a 4,096-key table at 2 slots, which asks the split for more
# than the combine's 32; and D = 72, which takes the CUDA-core walk in bf16
# too
_EDGE_SEGS = [(16, 200), (1, 33), (5, 5)]
PROFILES.update({
    "page8": dict(PROFILES["decode"], ps=8, max_pages=256),
    "page128": dict(PROFILES["prefill"], ps=128, max_pages=16),
    "tight_prefill": dict(max_q=128, packed=True,
                          segs=[(37, 300), (100, 1100), (5, 64)]),
    "granite_d64": dict(max_q=128, segs=[(1, 700), (37, 293), (0, 0),
                                         (128, 1500)], hq=24, hkv=8, d=64),
    "reduced_d16": dict(max_q=16, packed=True, segs=_EDGE_SEGS, hq=8,
                        hkv=2, d=16),
    "odd_lengths_idle": dict(max_q=64, segs=[(64, 1000), (0, 0), (13, 77),
                                             (1, 65)]),
    "long_pool": dict(max_q=1, segs=[(1, 4096), (1, 2113)], max_pages=256),
    "d72_cuda_core": dict(max_q=16, segs=_EDGE_SEGS, hq=8, hkv=2, d=72),
})
# the speculative round's ragged sub-batches at minitron-8b's heads (G = 4),
# kv_len spread over 100-2048: the target verify's 8 windows of K+1
# queries (K = 3: 16 rows, one 16-row block; K = 4, serve_spec's: 20 rows,
# one 64-row block) and, untimed, the draft catch-up's 8 segments of 1 or 2
SPEC_KV = [100, 257, 511, 777, 1024, 1300, 1700, 2048]
PROFILES.update({
    "verify_k3": dict(max_q=4, segs=[(4, kl) for kl in SPEC_KV]),
    "verify_k4": dict(max_q=5, segs=[(5, kl) for kl in SPEC_KV]),
    "catch_up": dict(max_q=2, segs=[(1 + i % 2, kl)
                                    for i, kl in enumerate(SPEC_KV)]),
})
# yi-34b's attention (56 query heads over 8 KV heads: G = 7, so the rows
# of a (query, KV head) are not a power of two) at the same decode and
# prefill sub-batches
YI_HEADS = dict(hq=56, hkv=8)
PROFILES["yi_decode"] = dict(PROFILES["decode"], **YI_HEADS)
PROFILES["yi_prefill"] = dict(PROFILES["prefill"], **YI_HEADS)
# a tp = 2 rank's shard of minitron-8b's attention (16 query heads over 4
# KV heads: G = 4 as unsharded, half the heads, so another key split) at
# the same sub-batches: serve_tp's launches
TP2_HEADS = dict(hq=HQ // 2, hkv=HKV // 2)
PROFILES["tp2_decode"] = dict(PROFILES["decode"], **TP2_HEADS)
PROFILES["tp2_prefill"] = dict(PROFILES["prefill"], **TP2_HEADS)
TIMED = ("decode", "prefill", "deepseek_decode", "deepseek_prefill",
         "verify_k3", "verify_k4", "yi_decode", "yi_prefill", "tp2_decode",
         "tp2_prefill")  # profiles the main paths launch

# paged decode: the same 8 slots, lengths counting the token just written;
# untimed, the same edges as the ragged kernel's
DECODE_LENGTHS = [1, 17, 255, 0, 640, 1024, 1500, 2048]
_EDGE_LENGTHS = [1, 40, 0, 300]
PAGED_DECODE_PROFILES = {
    "decode": dict(lengths=DECODE_LENGTHS),
    "page8": dict(lengths=DECODE_LENGTHS, ps=8, max_pages=256),
    "page128": dict(lengths=DECODE_LENGTHS, ps=128, max_pages=16),
    "granite_d64": dict(lengths=DECODE_LENGTHS, hq=24, hkv=8, d=64),
    "reduced_d16": dict(lengths=_EDGE_LENGTHS, hq=8, hkv=2, d=16,
                        max_pages=32),
    "odd_lengths": dict(lengths=[65, 0, 127, 1000, 1, 63]),
    "long_pool": dict(lengths=[4096, 2113], max_pages=256),
    "d72_cuda_core": dict(lengths=_EDGE_LENGTHS, hq=8, hkv=2, d=72,
                          max_pages=32),
}
PAGED_DECODE_TIMED = ("decode",)

# flash forward: (rows, queries, keys, q_offset per row, window); kv_len =
# q_offset + queries unless given.  The two scratch rows of a full and of a
# partial chunk, the dense decode of 8 slots, and mistral-7b-swa's window;
# the same prefill and decode at deepseek-moe-16b's heads (G = 1, the head
# shape of its two-dispatch serve); yi-34b's G = 7 prefill and decode; and
# hubert-xlarge's encoder pass, bidirectional (``causal`` False) over 4 rows
# of 1,024 frames at D = 80.  Then, untimed, the edges of the tensor-core
# tiles: granite-moe's D = 64 heads (Hq 24 over Hkv 8) at a partial chunk,
# the reduced configs' D = 16, one row with kv_len 0 beside a window
# narrower than one 64-key tile (a 16-query chunk, and a decode), and D =
# 72 (a multiple of 8, not of 16), which takes the CUDA-core walk in bf16
# too.
FLASH_PROFILES = {
    "prefill": dict(b=2, sq=128, skv=2048, q_offset=[1372, 128]),
    "prefill_partial": dict(b=2, sq=37, skv=2048, q_offset=[256, 0]),
    "dense_decode": dict(b=8, sq=1, skv=2048,
                         q_offset=[0, 16, 254, 639, 1023, 1499, 2046, 2047]),
    "window": dict(b=1, sq=128, skv=8192, q_offset=[6000], window=4096),
    "deepseek_prefill": dict(b=2, sq=128, skv=2048, q_offset=[1372, 128],
                             **DS_HEADS),
    "deepseek_decode": dict(b=8, sq=1, skv=2048,
                            q_offset=[0, 16, 254, 639, 1023, 1499, 2046,
                                      2047], **DS_HEADS),
    "yi_prefill": dict(b=2, sq=128, skv=2048, q_offset=[1372, 128],
                       **YI_HEADS),
    "yi_decode": dict(b=8, sq=1, skv=2048,
                      q_offset=[0, 16, 254, 639, 1023, 1499, 2046, 2047],
                      **YI_HEADS),
    "hubert_encoder": dict(b=4, sq=1024, skv=1024, q_offset=[0] * 4,
                           causal=False, hq=16, hkv=16, d=80),
    "granite_d64_partial": dict(b=2, sq=37, skv=2048, q_offset=[256, 0],
                                hq=24, hkv=8, d=64),
    "reduced_d16": dict(b=2, sq=37, skv=512, q_offset=[300, 0], hq=8, hkv=2,
                        d=16),
    "kv_len0_narrow_window": dict(b=3, sq=16, skv=512,
                                  q_offset=[200, 0, 400],
                                  kv_len=[216, 0, 416], window=24),
    "decode_kv_len0_window": dict(b=3, sq=1, skv=512,
                                  q_offset=[215, 0, 415],
                                  kv_len=[216, 0, 416], window=24),
    "d72_cuda_core": dict(b=2, sq=37, skv=512, q_offset=[300, 0], hq=8,
                          hkv=2, d=72),
}
FLASH_TIMED = ("prefill", "prefill_partial", "dense_decode", "window",
               "deepseek_prefill", "deepseek_decode", "yi_prefill",
               "yi_decode", "hubert_encoder")


def head_dims(prof):
    """(Hq, Hkv, D) of a profile (minitron-8b's unless it says)."""
    return prof.get("hq", HQ), prof.get("hkv", HKV), prof.get("d", D)


def paged_dims(prof):
    """(Hq, Hkv, D, page size, table width) of a ragged or paged decode
    profile (minitron-8b's heads and the engine's 128 pages of 16 unless
    it says)."""
    return head_dims(prof) + (prof.get("ps", PS),
                              prof.get("max_pages", MAX_PAGES))


def _pools(torch, gen, kv_lens, hkv, d, ps, max_pages):
    """Paged pools on the card with a page run of ``ceil(kv_len / ps)``
    random pages per row; every table entry past a row's kv_len points at
    a junk page filled with 1e4, so a kernel that reads past kv_len
    disagrees loudly."""
    need = [-(-kl // ps) for kl in kv_lens]
    n_junk = 16
    n_pool = 1 + sum(need) + n_junk
    kp = torch.randn((n_pool, hkv, ps, d), generator=gen, device=DEV)
    vp = torch.randn((n_pool, hkv, ps, d), generator=gen, device=DEV)
    junk = list(range(n_pool - n_junk, n_pool))
    kp[junk] = 1e4
    vp[junk] = 1e4
    perm = (torch.randperm(n_pool - 1 - n_junk, generator=gen,
                           device=DEV) + 1).tolist()
    pt = torch.tensor([junk[(i + j) % n_junk] for i in range(len(kv_lens))
                       for j in range(max_pages)],
                      dtype=torch.int32).reshape(len(kv_lens), max_pages)
    for i, n in enumerate(need):
        pt[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return kp, vp, pt.to(DEV)


def q_starts(prof):
    """Each segment's first packed row: the engine's fixed layout (segment
    i at i max_q), or back to back when the profile is ``packed``."""
    lens = [ql for ql, _ in prof["segs"]]
    if prof.get("packed"):
        return [sum(lens[:i]) for i in range(len(lens))]
    return [i * prof["max_q"] for i in range(len(lens))]


def make_case(torch, prof, dtype, seed):
    """Packed ragged inputs on the card (see ``_pools``)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    segs = prof["segs"]
    hq, hkv, d, ps, max_pages = paged_dims(prof)
    kp, vp, pt = _pools(torch, gen, [kl for _, kl in segs], hkv, d, ps,
                        max_pages)
    starts = q_starts(prof)
    t = (starts[-1] + segs[-1][0] if prof.get("packed")
         else len(segs) * prof["max_q"])
    q = torch.randn((t, hq, d), generator=gen, device=DEV)
    return dict(q=q.to(dtype), k_pool=kp.to(dtype), v_pool=vp.to(dtype),
                seg_page_table=pt,
                q_start=torch.tensor(starts, dtype=torch.int32, device=DEV),
                q_len=torch.tensor([s[0] for s in segs], dtype=torch.int32,
                                   device=DEV),
                kv_len=torch.tensor([s[1] for s in segs], dtype=torch.int32,
                                    device=DEV))


def make_decode_case(torch, prof, dtype, seed):
    """Paged decode inputs on the card (see ``_pools``)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lengths = prof["lengths"]
    hq, hkv, d, ps, max_pages = paged_dims(prof)
    kp, vp, pt = _pools(torch, gen, lengths, hkv, d, ps, max_pages)
    q = torch.randn((len(lengths), 1, hq, d), generator=gen, device=DEV)
    return dict(q=q.to(dtype), k_pool=kp.to(dtype), v_pool=vp.to(dtype),
                page_table=pt,
                lengths=torch.tensor(lengths, dtype=torch.int32, device=DEV))


def make_flash_case(torch, prof, dtype, seed):
    """Dense inputs on the card; every key at or past a row's kv_len is
    1e4, so a kernel that reads past kv_len disagrees loudly."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b, sq, skv = prof["b"], prof["sq"], prof["skv"]
    hq, hkv, d = head_dims(prof)
    q = torch.randn((b, sq, hq, d), generator=gen, device=DEV)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=DEV)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=DEV)
    qo = torch.tensor(prof["q_offset"], dtype=torch.int32, device=DEV)
    kl = (torch.tensor(prof["kv_len"], dtype=torch.int32, device=DEV)
          if "kv_len" in prof else qo + sq)
    past = torch.arange(skv, device=DEV)[None, :] >= kl[:, None]
    k[past] = 1e4
    v[past] = 1e4
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), kv_len=kl,
                q_offset=qo, window=prof.get("window"),
                causal=prof.get("causal", True))


# expert GEMM (E, C, D) @ (E, D, F) at deepseek-moe-16b's experts (E 64,
# D 2048 <-> F 1408): the unified engine's mixed step packs 8 decode slots
# and 2 prefill rows of 128 (C = 264), its decode-only step 8 (C = 8).
# ``broadcast``: x is one (C, D) matrix seen by every expert (stride 0), as
# the dense MoE's up and gate products pass it; the down product's x is
# each expert's own activation.
GEMM_PROFILES = {
    "mixed": dict(e=64, c=264, d=2048, f=1408, broadcast=True),
    "mixed_down": dict(e=64, c=264, d=1408, f=2048, broadcast=False),
    "decode": dict(e=64, c=8, d=2048, f=1408, broadcast=True),
    "decode_down": dict(e=64, c=8, d=1408, f=2048, broadcast=False),
    "mixed_distinct": dict(e=64, c=264, d=2048, f=1408, broadcast=False),
    "ragged": dict(e=3, c=37, d=200, f=136, broadcast=False),
    "ragged_broadcast": dict(e=5, c=70, d=72, f=200, broadcast=True),
    # untimed: one token (an 8-wide tile with 7 idle columns); 600 tokens
    # broadcast, past one C tile (three tiles of 200); granite-moe-3b-
    # a800m's mixed up/gate (E 40, D 1536, F 512)
    "c1": dict(e=64, c=1, d=1408, f=2048, broadcast=False),
    "c600_broadcast": dict(e=64, c=600, d=2048, f=1408, broadcast=True),
    "granite_mixed": dict(e=40, c=264, d=1536, f=512, broadcast=True),
    # jamba-v0.1-52b's experts (E 16, D 4,096 <-> F 14,336) at its
    # two-dispatch engine's shapes: a prefill chunk's 2 rows of 128 (C =
    # 256) and a decode step's 8 slots, up/gate and down (14,336 deep)
    "jamba_prefill": dict(e=16, c=256, d=4096, f=14336, broadcast=True),
    "jamba_prefill_down": dict(e=16, c=256, d=14336, f=4096,
                               broadcast=False),
    "jamba_decode": dict(e=16, c=8, d=4096, f=14336, broadcast=True),
    "jamba_decode_down": dict(e=16, c=8, d=14336, f=4096, broadcast=False),
    # an expert-parallel rank's buffer (train_mesh): granite-moe-3b-a800m's
    # 40 experts over 2 ranks (E_local 20), C_cap 512 (2 x 1,024 tokens
    # partitioned over the 2 ranks, top-8 at capacity 1.25), each expert's
    # own tokens: up/gate and down
    "ep_local": dict(e=20, c=512, d=1536, f=512, broadcast=False),
    "ep_local_down": dict(e=20, c=512, d=512, f=1536, broadcast=False),
}
GEMM_TIMED = ("mixed", "mixed_down", "decode", "decode_down",
              "jamba_prefill", "jamba_prefill_down", "jamba_decode",
              "jamba_decode_down", "ep_local", "ep_local_down")


def make_gemm_case(torch, prof, dtype, seed):
    """x ~ N(0, 1), w ~ N(0, 1/D) on the card: outputs of unit scale."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    e, c, d, f = prof["e"], prof["c"], prof["d"], prof["f"]
    if prof["broadcast"]:
        x = torch.randn((c, d), generator=gen, device=DEV).to(dtype)
        x = x.expand(e, c, d)
    else:
        x = torch.randn((e, c, d), generator=gen, device=DEV).to(dtype)
    w = torch.randn((e, d, f), generator=gen, device=DEV) / d ** 0.5
    return dict(x=x, w=w.to(dtype))


def work_gemm(prof, itemsize):
    """Least bytes and operations of one expert GEMM: x read once (one
    (C, D) matrix when it is broadcast), every expert's w read once, the
    output written once; 2 E C D F operations."""
    e, c, d, f = prof["e"], prof["c"], prof["d"], prof["f"]
    x_elems = c * d if prof["broadcast"] else e * c * d
    nbytes = (x_elems + e * d * f + e * c * f) * itemsize
    return _bound(nbytes, 2 * e * c * d * f)


def bmm_call(torch, case):
    """The one PyTorch call that computes the expert GEMM (the yardstick;
    the port never calls it)."""
    return lambda: torch.bmm(case["x"], case["w"])


def valid_rows(prof):
    """The packed rows of the profile's live segments."""
    rows = []
    for start, (ql, _) in zip(q_starts(prof), prof["segs"]):
        rows.extend(range(start, start + ql))
    return rows


def _bound(nbytes, flops, peak=BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def work(prof, itemsize):
    """Least bytes and operations of one ragged launch.  Bytes: the live q
    rows (q_len of each segment) read once, the whole (T, Hq, D) output
    written once (gap rows are zero-filled), K+V of the valid tokens read
    once, and the table entries the walk reads (q_start/q_len/kv_len of
    every segment, ceil(kv_len / page) page ids of each live one).
    Operations: 4 D per visible query-key pair per head."""
    segs = prof["segs"]
    hq, hkv, d, ps, _ = paged_dims(prof)
    live = [(ql, kl) for ql, kl in segs if ql > 0]
    t = (sum(ql for ql, _ in segs) if prof.get("packed")
         else len(segs) * prof["max_q"])
    nbytes = (sum(ql for ql, _ in live) * hq * d * itemsize
              + t * hq * d * itemsize
              + sum(2 * kl * hkv * d * itemsize for _, kl in live)
              + (3 * len(segs) + sum(-(-kl // ps) for _, kl in live)) * 4)
    pairs = sum(kl - ql + i + 1 for ql, kl in live for i in range(ql))
    return _bound(nbytes, 4 * d * hq * pairs)


def work_decode(prof, itemsize):
    """Least bytes and operations of one paged decode call: q read and the
    output written once, K+V of each slot's valid tokens read once, its
    ceil(length / page) page ids and its length; 4 D operations per valid
    key per query head."""
    lengths = prof["lengths"]
    hq, hkv, d, ps, _ = paged_dims(prof)
    b = len(lengths)
    nbytes = (2 * b * hq * d * itemsize
              + sum(2 * n * hkv * d * itemsize for n in lengths)
              + (sum(-(-n // ps) for n in lengths) + b) * 4)
    return _bound(nbytes, 4 * d * hq * sum(lengths))


def _visible(prof):
    """(keys any query of the row sees, visible query-key pairs) per row."""
    out = []
    causal = prof.get("causal", True)
    for r, qo in enumerate(prof["q_offset"]):
        kl = prof["kv_len"][r] if "kv_len" in prof else qo + prof["sq"]
        w = prof.get("window")
        spans = [(max(0, qo + i - w + 1) if w else 0,
                  min(kl, qo + i + 1) if causal else kl)
                 for i in range(prof["sq"])]
        spans = [(lo, hi) for lo, hi in spans if hi > lo]
        keys = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)
                if spans else 0)
        out.append((keys, sum(hi - lo for lo, hi in spans)))
    return out


def work_flash(prof, itemsize):
    """Least bytes and operations of one flash call: q read and the output
    written once, K+V of the keys some query of the row can see (inside
    kv_len, the causal bound and the window) read once, kv_len and
    q_offset; 4 D operations per visible query-key pair per head."""
    hq, hkv, d = head_dims(prof)
    vis = _visible(prof)
    nbytes = (2 * prof["b"] * prof["sq"] * hq * d * itemsize
              + sum(2 * keys * hkv * d * itemsize for keys, _ in vis)
              + 8 * prof["b"])
    return _bound(nbytes, 4 * d * hq * sum(pairs for _, pairs in vis))


def sdpa_call(torch, case):
    """The one PyTorch call that computes the flash profile's function
    (the yardstick; the port never calls it): scaled_dot_product_attention
    with the boolean visibility mask and grouped-query heads."""
    q, k, v = (case[n].transpose(1, 2).contiguous() for n in "qkv")
    sq, skv = q.shape[2], k.shape[2]
    qpos = case["q_offset"][:, None] + torch.arange(sq, device=DEV)
    kpos = torch.arange(skv, device=DEV)
    mask = (kpos < case["kv_len"][:, None, None]).expand(-1, sq, -1)
    if case["causal"]:
        mask = mask & (kpos <= qpos[:, :, None])
    if case["window"]:
        mask = mask & (qpos[:, :, None] - kpos < case["window"])
    mask = mask[:, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(q, k, v, attn_mask=mask, enable_gqa=True)


# flash backward (training): qwen1.5-0.5b's training shape (8 rows of
# 1,024 tokens, 16 heads of 64, causal: the train phase's every layer),
# minitron-8b's heads (32 over 8: G = 4, D = 128) at 1,024 tokens, a
# sliding window, a chunk against a longer cache (kv_len and q_offset),
# rows with no visible key (kv_len 0 beside a 24-key window), hubert's
# bidirectional pass at D = 80, and granite-moe-3b-a800m's training shape
# (one row of 1,024 tokens, 24 heads over 8: G = 3, D = 64: each of
# the 8 launches a layer of each train_moe step); each timed.  The forward's inputs
# are made on the card; o and lse come from the plain forward, so the
# kernel and the plain backward read the same residuals.
FLASH_BWD_PROFILES = {
    "qwen_train": dict(b=8, sq=1024, skv=1024, q_offset=[0] * 8, hq=16,
                       hkv=16, d=64),
    "minitron_g4": dict(b=2, sq=1024, skv=1024, q_offset=[0, 0]),
    "window": dict(b=1, sq=2048, skv=2048, q_offset=[0], window=512),
    "kv_len_q_offset": dict(b=2, sq=128, skv=2048, q_offset=[1372, 128],
                            kv_len=[1500, 256], hq=16, hkv=16, d=64),
    "no_visible_key": dict(b=3, sq=16, skv=512, q_offset=[200, 0, 400],
                           kv_len=[216, 0, 416], window=24, hq=16, hkv=16,
                           d=64),
    "hubert_bidirectional": dict(b=2, sq=512, skv=512, q_offset=[0, 0],
                                 causal=False, hq=16, hkv=16, d=80),
    "granite_train": dict(b=1, sq=1024, skv=1024, q_offset=[0], hq=24,
                          hkv=8, d=64),
}


def make_bwd_case(torch, ref, prof, dtype, seed):
    """The forward's inputs (as make_flash_case), the plain forward's o (in
    dtype) and lse, and a random upstream gradient do."""
    case = make_flash_case(torch, prof, dtype, seed)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    o, lse = ref.flash_fwd_reference(**case)
    case.update(o=o, lse=lse.float(),
                do=torch.randn(o.shape, generator=gen, device=DEV).to(dtype))
    return case


def _fwd_kw(case):
    return {k: case[k] for k in ("causal", "window", "kv_len", "q_offset")}


def work_flash_bwd(prof, itemsize):
    """Least bytes and operations of one backward call: q, o, do read and
    dq written (B Sq Hq D each), K+V of the keys some query sees read once,
    dk and dv written whole (B Skv Hkv D each), lse read (4 bytes a row),
    kv_len and q_offset; 10 D operations per visible query-key pair per
    query head (S and dP recomputed, dq, dk, dv)."""
    hq, hkv, d = head_dims(prof)
    vis = _visible(prof)
    b, sq, skv = prof["b"], prof["sq"], prof["skv"]
    nbytes = (4 * b * sq * hq * d * itemsize + 4 * b * sq * hq
              + sum(2 * keys * hkv * d * itemsize for keys, _ in vis)
              + 2 * b * skv * hkv * d * itemsize + 8 * b)
    return _bound(nbytes, 10 * d * hq * sum(pairs for _, pairs in vis))


def sdpa_bwd_call(torch, case):
    """The one PyTorch call that computes the backward's function (the
    yardstick; the port never calls it): scaled_dot_product_attention's
    backward, the graph built once and walked again each call, with
    is_causal where the profile is the plain causal square, else the
    boolean visibility mask."""
    q, k, v = (case[n].transpose(1, 2).detach().requires_grad_()
               for n in "qkv")
    sq, skv = q.shape[2], k.shape[2]
    f = torch.nn.functional.scaled_dot_product_attention
    square = (case["causal"] and not case["window"] and sq == skv
              and bool((case["q_offset"] == 0).all())
              and bool((case["kv_len"] == skv).all()))
    with torch.enable_grad():
        if square:
            o = f(q, k, v, is_causal=True, enable_gqa=True)
        else:
            qpos = case["q_offset"][:, None] + torch.arange(sq, device=DEV)
            kpos = torch.arange(skv, device=DEV)
            mask = (kpos < case["kv_len"][:, None, None]).expand(-1, sq, -1)
            if case["causal"]:
                mask = mask & (kpos <= qpos[:, :, None])
            if case["window"]:
                mask = mask & (qpos[:, :, None] - kpos < case["window"])
            o = f(q, k, v, attn_mask=mask[:, None], enable_gqa=True)
    do = case["do"].transpose(1, 2)
    return lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)


def check_bwd_profile(torch, name, prof):
    """One profile of the flash backward: dq, dk and dv of the kernel
    against the plain backward on the same inputs and residuals, float32
    within F32_ATOL and bfloat16 within one bf16 ulp plus F32_ATOL, each
    relative to the gradient's scale max(1, max |want|) (each gradient's
    max error on the line); the forward
    kernel's lse against the plain lse on the rows that see a key (a row
    that sees none must read NEG_INF on both); the route each dtype took,
    and in bfloat16 the launch plan and a second launch on the same
    inputs, which must give the same bits (the walk has no atomics); in
    bfloat16 the median times of the kernel, the plain backward and
    SDPA's backward beside the bound."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref
    res = dict(prof)
    for dtype, rtol, tag in ((torch.float32, 0.0, "f32"),
                             (torch.bfloat16, BF16_RTOL, "bf16")):
        case = make_bwd_case(torch, ref, prof, dtype, seed=prof["sq"])
        args = [case[n] for n in ("q", "k", "v", "o", "lse", "do")]
        kw = _fwd_kw(case)
        got = flash_attention_bwd.flash_attention_bwd_cuda(*args, **kw)
        want = ref.flash_bwd_reference(*args, **kw)
        _, lse_k = flash_attention.flash_attention_cuda(
            case["q"], case["k"], case["v"], return_lse=True, **kw)
        torch.cuda.synchronize()
        errs = []
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = max(1.0, _amax(w))
            res[f"{gname}_scale_{tag}"] = scale
            errs.append(_compare(f"flash_attention_bwd/{name}/{tag}/{gname}",
                                 g, w, rtol, scale))
            res[f"{gname}_max_abs_err_{tag}"] = errs[-1]
        res[f"max_abs_err_{tag}"] = max(errs)
        seen = case["lse"] > ref.NEG_INF / 2
        if bool((lse_k[~seen] > ref.NEG_INF / 2).any()):
            raise AssertionError(f"flash_attention/{name}/{tag}: lse of a "
                                 "row with no visible key")
        res[f"max_abs_err_lse_{tag}"] = _compare(
            f"flash_attention/{name}/{tag}/lse", lse_k[seen],
            case["lse"][seen], 0.0)
        res[f"empty_rows_{tag}"] = int((~seen).sum())
        route = flash_attention_bwd.last_route
        if route != flash_attention_bwd.route(dtype, head_dims(prof)[2]):
            raise AssertionError(f"flash_attention_bwd/{name}/{tag}: route "
                                 f"{route}")
        res[f"route_{tag}"] = route
        if tag == "bf16":
            res["plan_bf16"] = vars(flash_attention_bwd.last_plan)
            again = flash_attention_bwd.flash_attention_bwd_cuda(*args, **kw)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError(f"flash_attention_bwd/{name}: two "
                                     "launches on the same inputs differ")
            res["bitwise_repeat"] = True
            del again
            res["ms"] = median_ms(
                torch, lambda: flash_attention_bwd.flash_attention_bwd_cuda(
                    *args, **kw), TIMED_LAUNCHES)
            res["plain_ms"] = median_ms(
                torch, lambda: ref.flash_bwd_reference(*args, **kw),
                PLAIN_LAUNCHES)
            res["library_ms"] = median_ms(torch, sdpa_bwd_call(torch, case),
                                          TIMED_LAUNCHES)
            res.update(work_flash_bwd(prof, 2))
        del case, args, got, want, lse_k
    emit("kernel_check", kernel="flash_attention_bwd", profile=name,
         atol_f32=F32_ATOL, rtol_bf16=BF16_RTOL, atol_bf16=F32_ATOL, **res)
    return res


# WKV scan at rwkv6-3b's heads (H 40 of N 64): the two-dispatch engine's
# prefill calls (2 scratch rows, a full and a partial chunk) and its decode
# steps (8 slots, one step); then, untimed, the decode step with the final
# state written over state0 (as the engine's decode writes its cache in
# place) and the head sizes of the reduced configs (N 16 and 32); and
# RWKV_EDGES, the edges of the launch plan, which kernel_check runs after
# every other kernel's profiles so that they change no kernel's timing
# conditions: the in-place decode at N 16 and 32, 161 steps (several turns
# of the chunk ring and a ragged tail), one row (a grid of 80 blocks), no
# step at all (the final state is state0), and decays drawn as the model
# draws them, exp(-exp(x)) for x in [-8, 3]: from 2e-9 to 0.9997.
RWKV_H, RWKV_N = 40, 64
RWKV_PROFILES = {
    "prefill": dict(b=2, t=128),
    "prefill_partial": dict(b=2, t=37),
    "decode": dict(b=8, t=1),
    "decode_in_place": dict(b=8, t=1, in_place=True),
    "n16": dict(b=2, t=37, h=4, n=16),
    "n32": dict(b=2, t=37, h=4, n=32),
    "decode_in_place_n16": dict(b=8, t=1, n=16, in_place=True),
    "decode_in_place_n32": dict(b=8, t=1, n=32, in_place=True),
    "t161": dict(b=2, t=161),
    "one_row": dict(b=1, t=128),
    "no_step": dict(b=2, t=0),
    "decay_edge": dict(b=2, t=128, decay="edge"),
}
RWKV_TIMED = ("prefill", "prefill_partial", "decode")
RWKV_EDGES = ("decode_in_place_n16", "decode_in_place_n32", "t161",
              "one_row", "no_step", "decay_edge")


def rwkv_dims(prof):
    return (prof["b"], prof["t"], prof.get("h", RWKV_H),
            prof.get("n", RWKV_N))


def make_rwkv_case(torch, prof, dtype, seed):
    """r, k, v ~ N(0, 1/4) in ``dtype``; w, u and state0 float32: decays in
    (0.45, 0.95) (as tests/test_kernels.py draws them), or exp(-exp(x))
    for x uniform in [-8, 3] with ``decay="edge"``, a non-zero bonus
    u ~ N(0, 0.09) and state0 ~ N(0, 0.04)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b, t, h, n = rwkv_dims(prof)

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=DEV) * scale

    r, k, v = (randn((b, t, h, n), 0.5).to(dtype) for _ in range(3))
    if prof.get("decay") == "edge":
        x = torch.rand((b, t, h, n), generator=gen, device=DEV) * 11 - 8
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(randn((b, t, h, n), 1.0)) * 0.5 + 0.45
    return dict(r=r, k=k, v=v, w=w, u=randn((h, n), 0.3),
                state=randn((b, h, n, n), 0.2))


def run_rwkv_in_place(rwkv6_scan, case):
    """The kernel with its final state written over (a copy of) state0."""
    state = case["state"].clone()
    return rwkv6_scan.rwkv6_scan_cuda(**{**case, "state": state},
                                      state_out=state)


def work_rwkv(prof, itemsize):
    """Least bytes and operations of one WKV scan: r, k, v read and out
    written once in the compute dtype, w, u and state0 read and the final
    state written once in f32; 5 N^2 + 5 N f32 operations per (row, step,
    head): out_j = sum_i r_i S_ij (2 N^2) + v_j * sum_i r_i u_i k_i (3 N
    for the sum, 2 N for the product and the add), and S_ij <- w_i S_ij +
    k_i v_j (3 N^2), at the f32 rate outside the tensor cores."""
    b, t, h, n = rwkv_dims(prof)
    seq = b * t * h * n
    state = b * h * n * n
    nbytes = 4 * seq * itemsize + (seq + h * n + 2 * state) * 4
    return _bound(nbytes, (5 * n * n + 5 * n) * b * t * h, F32_FLOPS)


# expert GEMM backward (training): granite-moe-3b-a800m's experts (E 40,
# D 1,536 <-> F 512) at its 1,024-token training micro-batch.  A profile
# is one gradient, one counted call of the backward (bf16: its own kernel,
# csrc/expert_gemm_bwd.cu, on the operands as they lie; f32: the forward's
# kernel on transposed copies): the up/gate products' dX, x broadcast over
# the experts (summed over their 20,480-deep (expert, F) pairs, in shares
# when the plan splits it), and dW (X read through an expert stride of 0);
# the down product's per-expert dX and dW.  Untimed: C = 37 (off the
# 8-row edge, both gradients), C = 1,000 (past a tile) with F = 200 (the
# summed dX's last slab of each expert cut at its end) and per expert.
# library: the one PyTorch call of the same product (torch.bmm, or
# einsum where x is broadcast).
GEMM_BWD_PROFILES = {
    "granite_dx_broadcast": dict(e=40, c=1024, d=1536, f=512,
                                 broadcast=True, grad="x"),
    "granite_dw_broadcast": dict(e=40, c=1024, d=1536, f=512,
                                 broadcast=True, grad="w"),
    "granite_dx_down": dict(e=40, c=1024, d=512, f=1536, broadcast=False,
                            grad="x"),
    "granite_dw_down": dict(e=40, c=1024, d=512, f=1536, broadcast=False,
                            grad="w"),
    "ragged_c37_broadcast": dict(e=5, c=37, d=72, f=200, broadcast=True,
                                 grad="xw"),
    "ragged_c37": dict(e=3, c=37, d=200, f=136, broadcast=False, grad="xw"),
    "c1000_f200_broadcast": dict(e=8, c=1000, d=512, f=200, broadcast=True,
                                 grad="xw"),
    "c1000": dict(e=4, c=1000, d=256, f=384, broadcast=False, grad="xw"),
    # the expert-parallel rank's buffer (E_local 20, C_cap 512): every
    # product's x is per expert, so both dX are per expert too
    "ep_dx_up": dict(e=20, c=512, d=1536, f=512, broadcast=False,
                     grad="x"),
    "ep_dw_up": dict(e=20, c=512, d=1536, f=512, broadcast=False,
                     grad="w"),
    "ep_dx_down": dict(e=20, c=512, d=512, f=1536, broadcast=False,
                       grad="x"),
    "ep_dw_down": dict(e=20, c=512, d=512, f=1536, broadcast=False,
                       grad="w"),
}
GEMM_BWD_TIMED = ("granite_dx_broadcast", "granite_dw_broadcast",
                  "granite_dx_down", "granite_dw_down", "ep_dx_up",
                  "ep_dw_up", "ep_dx_down", "ep_dw_down")


def make_gemm_bwd_case(torch, prof, dtype, seed):
    """x ~ N(0, 1) ((C, D) when broadcast), w ~ N(0, 1/D), dy ~ N(0, 1)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    e, c, d, f = prof["e"], prof["c"], prof["d"], prof["f"]
    x = torch.randn((c, d) if prof["broadcast"] else (e, c, d),
                    generator=gen, device=DEV)
    w = torch.randn((e, d, f), generator=gen, device=DEV) / d ** 0.5
    dy = torch.randn((e, c, f), generator=gen, device=DEV)
    return dict(x=x.to(dtype), w=w.to(dtype), dy=dy.to(dtype))


def work_gemm_bwd(prof, itemsize):
    """Least bytes and operations of the profile's gradients: dX reads dy
    and w and writes dX (one (C, D) matrix when x is broadcast); dW reads
    x and dy and writes dW; 2 E C D F operations each."""
    e, c, d, f = prof["e"], prof["c"], prof["d"], prof["f"]
    x = c * d if prof["broadcast"] else e * c * d
    nbytes = flops = 0
    if "x" in prof["grad"]:
        nbytes += (e * c * f + e * d * f + x) * itemsize
        flops += 2 * e * c * d * f
    if "w" in prof["grad"]:
        nbytes += (x + e * c * f + e * d * f) * itemsize
        flops += 2 * e * c * d * f
    return _bound(nbytes, flops)


def gemm_bwd_library(torch, prof, case):
    """The one PyTorch call of the profile's product (the yardstick; the
    port never calls it)."""
    x, w, dy = case["x"], case["w"], case["dy"]
    if prof["grad"] == "x":
        if prof["broadcast"]:
            return lambda: torch.einsum("ecf,edf->cd", dy, w)
        return lambda: torch.bmm(dy, w.transpose(1, 2))
    if prof["broadcast"]:
        return lambda: torch.einsum("cd,ecf->edf", x, dy)
    return lambda: torch.bmm(x.transpose(1, 2), dy)


def check_gemm_bwd_profile(torch, name, prof):
    """One profile of the expert GEMM's backward: the kernel's gradients
    against ``ref.expert_gemm_bwd_reference`` on the same inputs, float32
    within F32_ATOL and bfloat16 within one bf16 ulp plus F32_ATOL, each
    relative to the gradient's scale max(1, max |want|); the route (bf16:
    wgmma, f32: cuda_core) and one backward call a gradient; in bfloat16
    the plan of each gradient and, in a timed profile, a second launch bit
    for bit equal to the first and the median times of the kernel, the
    plain backward and the library's product beside the bound."""
    from repro_torch.kernels import expert_gemm, ref
    res = dict(prof)
    need = dict(need_x="x" in prof["grad"], need_w="w" in prof["grad"])
    for dtype, rtol, tag in ((torch.float32, 0.0, "f32"),
                             (torch.bfloat16, BF16_RTOL, "bf16")):
        case = make_gemm_bwd_case(torch, prof, dtype, seed=prof["c"])
        n0 = expert_gemm.bwd_launches
        got = expert_gemm.expert_gemm_bwd_cuda(**case, **need)
        if expert_gemm.bwd_launches - n0 != len(prof["grad"]):
            raise AssertionError(f"expert_gemm_bwd/{name}: "
                                 f"{expert_gemm.bwd_launches - n0} launches")
        want = ref.expert_gemm_bwd_reference(**case, **need)
        torch.cuda.synchronize()
        route = expert_gemm.last_plan.route
        if route != ("wgmma" if dtype == torch.bfloat16 else "cuda_core"):
            raise AssertionError(f"expert_gemm_bwd/{name}/{tag}: route "
                                 f"{route}")
        res[f"route_{tag}"] = route
        errs = []
        for gname, g, w in zip(("dx", "dw"), got, want):
            if g is None:
                continue
            scale = max(1.0, _amax(w))
            res[f"{gname}_scale_{tag}"] = scale
            errs.append(_compare(f"expert_gemm_bwd/{name}/{tag}/{gname}",
                                 g, w, rtol, scale))
        res[f"max_abs_err_{tag}"] = max(errs)
        if tag == "bf16":
            res["plan_bf16"] = {g: vars(p) for g, p in
                                expert_gemm.last_bwd_plans.items()}
            if name in GEMM_BWD_TIMED:
                again = expert_gemm.expert_gemm_bwd_cuda(**case, **need)
                torch.cuda.synchronize()
                res["bitwise_equal_bf16"] = all(
                    g is None or torch.equal(g, h)
                    for g, h in zip(got, again))
                if not res["bitwise_equal_bf16"]:
                    raise AssertionError(f"expert_gemm_bwd/{name}: two bf16 "
                                         "launches differ")
                del again
                res["ms"] = median_ms(
                    torch, lambda: expert_gemm.expert_gemm_bwd_cuda(
                        **case, **need), TIMED_LAUNCHES)
                res["plain_ms"] = median_ms(
                    torch, lambda: ref.expert_gemm_bwd_reference(
                        **case, **need), PLAIN_LAUNCHES)
                res["library_ms"] = median_ms(
                    torch, gemm_bwd_library(torch, prof, case),
                    TIMED_LAUNCHES)
                res.update(work_gemm_bwd(prof, 2))
        del case, got, want
    emit("kernel_check", kernel="expert_gemm_bwd", profile=name,
         atol_f32=F32_ATOL, rtol_bf16=BF16_RTOL, atol_bf16=F32_ATOL, **res)
    return res


# WKV scan backward (training): rwkv6-3b's training micro-batch (1 row of
# 1,024 steps, 40 heads of 64) from a zero state; a partial last chunk (77
# = 2 x 32 + 13 steps, 2 rows) from a non-zero state with a gradient of
# the final state; untimed, N 16, and the partial chunk again with decays
# exp(-exp(x)) for x in [-8, 3] (`edge`: decays near 0 and 1, whose
# products over a chunk underflow).  Both backward versions read the plain
# forward's chunk-boundary states; the forward kernel's own (return_bounds)
# are held against them, and its out and final state with them against
# those of a call without them, bit for bit; a second bf16 launch must
# equal the first bit for bit.  No PyTorch call computes it.
RWKV_BWD_PROFILES = {
    "train": dict(b=1, t=1024),
    "partial_state": dict(b=2, t=77, state=True),
    "n16": dict(b=2, t=45, h=4, n=16, state=True),
    "edge": dict(b=2, t=77, state=True, decay="edge"),
}
RWKV_BWD_TIMED = ("train", "partial_state")


def make_rwkv_bwd_case(torch, prof, dtype, seed):
    """make_rwkv_case's inputs (state0 zero unless ``state``), the plain
    forward's boundary states, dout ~ N(0, 1) in ``dtype`` and, with
    ``state``, a final-state gradient ~ N(0, 1)."""
    from repro_torch.kernels import ref, rwkv6_scan
    case = make_rwkv_case(torch, prof, dtype, seed)
    if not prof.get("state"):
        case["state"].zero_()
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    b, t, h, n = rwkv_dims(prof)
    chunk = rwkv6_scan.bound_chunk(t)
    _, _, bounds = ref.rwkv6_fwd_reference(**case, chunk=chunk)
    case.update(
        bounds=bounds, chunk=chunk,
        dout=torch.randn((b, t, h, n), generator=gen, device=DEV).to(dtype),
        dstate=(torch.randn((b, h, n, n), generator=gen, device=DEV)
                if prof.get("state") else None))
    return case


def work_rwkv_bwd(prof, itemsize):
    """Least bytes and operations of one backward call: r, k, v, dout read
    and dr, dk, dv written in the compute dtype; w read and dw written, u,
    the boundary states and the final state's gradient read, du and the
    initial state's gradient written, in f32; 14 N^2 + 13 N f32 operations
    per (row, step, head): the chunk's states recomputed (3 N^2), dr's,
    dk's, dw's and dv's sums over the state (2 N^2 each), the state
    gradient's update (3 N^2), and the bonus, dout . v and the combine's
    terms (13 N)."""
    b, t, h, n = rwkv_dims(prof)
    seq, state = b * t * h * n, b * h * n * n
    chunks = -(-t // min(32, max(t, 1)))
    nbytes = (7 * seq * itemsize + 2 * seq * 4 + 2 * h * n * 4
              + (chunks + 1 + bool(prof.get("state"))) * state * 4)
    return _bound(nbytes, (14 * n * n + 13 * n) * b * t * h, F32_FLOPS)


def check_rwkv_bwd_profile(torch, name, prof):
    """One profile of the WKV backward: dr, dk, dv (float32 within
    F32_ATOL, bfloat16 within one bf16 ulp plus F32_ATOL) and dw, du and
    the initial state's gradient (f32 in both runs, within F32_ATOL), each
    relative to its scale max(1, max |want|), against
    ``ref.rwkv6_bwd_reference`` on the same inputs and boundary states;
    the forward kernel's boundary states within F32_ATOL of the plain
    ones, its out and final state equal to a call without them; in
    bfloat16 a second launch equal to the first bit for bit, and the
    kernel's and the plain backward's median times beside the bound."""
    from repro_torch.kernels import ref, rwkv6_scan, rwkv6_scan_bwd
    res = dict(prof)
    fwd = ("r", "k", "v", "w", "u", "state")
    for dtype, rtol, tag in ((torch.float32, 0.0, "f32"),
                             (torch.bfloat16, BF16_RTOL, "bf16")):
        case = make_rwkv_bwd_case(torch, prof, dtype, seed=prof["t"])
        args = [case[k] for k in fwd[:5]] + [case["bounds"], case["dout"],
                                             case["dstate"]]
        n0 = rwkv6_scan_bwd.launches
        got = rwkv6_scan_bwd.rwkv6_scan_bwd_cuda(*args, chunk=case["chunk"])
        want = ref.rwkv6_bwd_reference(*args, chunk=case["chunk"])
        out_b, fin_b, bounds_k = rwkv6_scan.rwkv6_scan_cuda(
            *(case[k] for k in fwd), return_bounds=True)
        out, fin = rwkv6_scan.rwkv6_scan_cuda(*(case[k] for k in fwd))
        torch.cuda.synchronize()
        if rwkv6_scan_bwd.launches - n0 != 1:
            raise AssertionError(f"rwkv6_scan_bwd/{name}: launches")
        if not (torch.equal(out, out_b) and torch.equal(fin, fin_b)):
            raise AssertionError(f"rwkv6_scan/{name}/{tag}: return_bounds "
                                 "changed out or the final state")
        res[f"max_abs_err_bounds_{tag}"] = _compare(
            f"rwkv6_scan/{name}/{tag}/bounds", bounds_k, case["bounds"], 0.0,
            max(1.0, _amax(case["bounds"])))
        errs = []
        for gname, g, w in zip(("dr", "dk", "dv", "dw", "du", "dstate0"),
                               got, want):
            if g.dtype != w.dtype:
                raise AssertionError(f"rwkv6_scan_bwd/{name}/{gname}: "
                                     f"dtype {g.dtype}, want {w.dtype}")
            scale = max(1.0, _amax(w))
            res[f"{gname}_scale_{tag}"] = scale
            errs.append(_compare(f"rwkv6_scan_bwd/{name}/{tag}/{gname}", g,
                                 w, rtol if gname in ("dr", "dk", "dv")
                                 else 0.0, scale))
        res[f"max_abs_err_{tag}"] = max(errs)
        if tag == "bf16":
            res["plan_bf16"] = vars(rwkv6_scan_bwd.last_plan)
            again = rwkv6_scan_bwd.rwkv6_scan_bwd_cuda(*args,
                                                       chunk=case["chunk"])
            torch.cuda.synchronize()
            res["bitwise_equal_bf16"] = all(
                torch.equal(g, h) for g, h in zip(got, again))
            if not res["bitwise_equal_bf16"]:
                raise AssertionError(f"rwkv6_scan_bwd/{name}: two bf16 "
                                     "launches differ")
            del again
            if name in RWKV_BWD_TIMED:
                res["ms"] = median_ms(
                    torch, lambda: rwkv6_scan_bwd.rwkv6_scan_bwd_cuda(
                        *args, chunk=case["chunk"]), TIMED_LAUNCHES)
                res["plain_ms"] = median_ms(
                    torch, lambda: ref.rwkv6_bwd_reference(
                        *args, chunk=case["chunk"]), PLAIN_LAUNCHES)
                res["library_ms"] = None
                res.update(work_rwkv_bwd(prof, 2))
        del case, args, got, want
    h, n = rwkv_dims(prof)[2:]
    emit("kernel_check", kernel="rwkv6_scan_bwd", profile=name,
         atol_f32=F32_ATOL, rtol_bf16=BF16_RTOL, atol_bf16=F32_ATOL,
         **{"h": h, "n": n, **res})
    return res


# dense decode: 8 rows against a 2048-key cache at minitron-8b's heads and
# at deepseek-moe-16b's (G = 1); DECODE_LENGTHS include a length-0 row.
# Untimed: granite-moe's heads (G = 3, D = 64), a tile edge of the
# tensor-core walk; and 2 rows of a 4096-key cache, whose 16 (row, KV
# head) pairs would ask for 64 splits, past the tensor-core combine's 32.
DENSE_DECODE_T = 2048
DENSE_DECODE_PROFILES = {"decode": dict(hq=HQ, hkv=HKV),
                         "deepseek_decode": DS_HEADS,
                         "granite_d64": dict(hq=24, hkv=8, d=64),
                         "long_cache": dict(hq=HQ, hkv=HKV, t=4096,
                                            lengths=[4096, 2113])}
DENSE_DECODE_TIMED = ("decode", "deepseek_decode")


def dense_decode_shape(prof):
    """(row lengths, cache length T) of a dense decode profile."""
    return (prof.get("lengths", DECODE_LENGTHS),
            prof.get("t", DENSE_DECODE_T))


def make_dense_decode_case(torch, prof, dtype, seed):
    """Dense decode inputs on the card; every key at or past a row's length
    is 1e4, so a kernel that reads past the length disagrees loudly."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lens, t = dense_decode_shape(prof)
    b = len(lens)
    hq, hkv, d = head_dims(prof)
    q = torch.randn((b, 1, hq, d), generator=gen, device=DEV)
    k = torch.randn((b, t, hkv, d), generator=gen, device=DEV)
    v = torch.randn((b, t, hkv, d), generator=gen, device=DEV)
    lengths = torch.tensor(lens, dtype=torch.int32, device=DEV)
    past = torch.arange(t, device=DEV)[None, :] >= lengths[:, None]
    k[past] = 1e4
    v[past] = 1e4
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), lengths=lengths)


def work_dense_decode(prof, itemsize):
    """Least bytes and operations of one dense decode call: q read and the
    output written once, K+V of each row's valid keys read once, and the
    lengths; 4 D operations per valid key per query head."""
    lens, _ = dense_decode_shape(prof)
    b = len(lens)
    hq, hkv, d = head_dims(prof)
    nbytes = (2 * b * hq * d * itemsize
              + sum(2 * n * hkv * d * itemsize for n in lens)
              + 4 * b)
    return _bound(nbytes, 4 * d * hq * sum(lens))


def sdpa_decode_call(torch, case):
    """scaled_dot_product_attention with the length mask and grouped-query
    heads: the dense decode's yardstick (the port never calls it)."""
    q, k, v = (case[n].transpose(1, 2).contiguous() for n in "qkv")
    kpos = torch.arange(k.shape[2], device=DEV)
    mask = (kpos[None, :] < case["lengths"][:, None])[:, None, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(q, k, v, attn_mask=mask, enable_gqa=True)


def median_ms(torch, fn, n):
    """Median device time of one call over n calls, each after a 64 MiB
    write that evicts the 50 MB L2 (the serving step finds the pools
    cold: a whole layer runs between two launches).  A spin of SPIN_CYCLES
    before each call keeps the card busy while the host enqueues it, so
    the events time the device's work, not the host's Python."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    fn()  # warm-up
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _compare(what, got, want, rtol, scale=1.0):
    """Max abs error of ``got`` against ``want``; every element within
    rtol |want| + F32_ATOL scale and none above the BF16_ATOL scale
    ceiling (written so that NaN fails too)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not (bool((diff <= rtol * w.abs() + F32_ATOL * scale).all())
            and err <= BF16_ATOL * scale):
        raise AssertionError(f"{what}: max abs err {err} over {rtol} |want| "
                             f"+ {F32_ATOL} x {scale}")
    return err


def _amax(x):
    """max |x|, 0 for an empty tensor (a WKV call of no step)."""
    return float(x.abs().max()) if x.numel() else 0.0


def check_profile(torch, kernel, profile, make, run, plain, work_ms, *,
                  rows=None, library=None, timed=True, scaled=False,
                  module=None, **info):
    """One profile of one kernel: float32 and bfloat16 against the plain
    version on the same inputs (only on ``rows`` of the output, the rest
    exactly 0, when given; with ``scaled``, the tolerances relative to the
    output's scale, max(1, max |want|)); then in bfloat16 the kernel's,
    the plain version's and (``library``) the yardstick call's median
    times beside the bound.  A kernel that returns (out, state) has both
    held, the float32 state within the float32 tolerance in both runs.
    A ``module`` records the bf16 launch plan and, where it has routes,
    the route each dtype took, which must be the one its
    ``tensor_core_route`` names (attention) or, for the expert GEMM,
    ``wgmma`` in bf16 and ``cuda_core`` in f32."""
    res = dict(info)
    for dtype, rtol, tag in ((torch.float32, 0.0, "f32"),
                             (torch.bfloat16, BF16_RTOL, "bf16")):
        case = make(dtype)
        got, want = run(case), plain(case)
        torch.cuda.synchronize()
        if module is not None and hasattr(module, "routes"):
            route = module.last_plan.route
            if "q" in case:
                d = case["q"].shape[-1]
                expected = ("tensor_core"
                            if module.tensor_core_route(dtype, d)
                            else "cuda_core")
            else:
                d = case["x"].shape[-1]
                expected = ("wgmma" if dtype == torch.bfloat16
                            else "cuda_core")
            if route != expected:
                raise AssertionError(f"{kernel}/{profile}/{tag}: route "
                                     f"{route} at D = {d}")
            res[f"route_{tag}"] = route
        if module is not None and tag == "bf16":
            res["plan_bf16"] = vars(module.last_plan)
        if isinstance(got, tuple):  # (out, final state): the state is f32
            (got, got_state), (want, want_state) = got, want
            scale = max(1.0, _amax(want_state)) if scaled else 1.0
            res[f"state_scale_{tag}"] = scale
            res[f"max_abs_err_state_{tag}"] = _compare(
                f"{kernel}/{profile}/{tag}/state", got_state, want_state,
                0.0, scale)
        if rows is not None:
            gap = sorted(set(range(got.shape[0])) - set(rows))
            if gap and bool(got[gap].ne(0).any()):
                raise AssertionError(f"{kernel}/{profile}/{tag}: gap rows "
                                     "not zero")
            got, want = got[rows], want[rows]
        scale = max(1.0, _amax(want)) if scaled else 1.0
        res[f"output_scale_{tag}"] = scale
        res[f"max_abs_err_{tag}"] = _compare(f"{kernel}/{profile}/{tag}",
                                             got, want, rtol, scale)
        if tag == "bf16" and timed:
            res["ms"] = median_ms(torch, lambda: run(case), TIMED_LAUNCHES)
            res["plain_ms"] = median_ms(torch, lambda: plain(case),
                                        PLAIN_LAUNCHES)
            res["library_ms"] = (median_ms(torch, library(torch, case),
                                           TIMED_LAUNCHES)
                                 if library else None)
            res.update(work_ms)
        del case, got, want
    emit("kernel_check", kernel=kernel, profile=profile, atol_f32=F32_ATOL,
         rtol_bf16=BF16_RTOL, atol_bf16=F32_ATOL, **res)
    return res


def phase_kernel_check(torch, only=None) -> dict:
    """{kernel: {profile: result}} for the nine kernels (those ``only``
    names, when given)."""
    from repro_torch.kernels import (decode_attention, expert_gemm,
                                     flash_attention, paged_decode_attention,
                                     ragged_attention, ref, rwkv6_scan)

    def skip(kernel):
        return only is not None and kernel not in only

    out = {name: {} for name in kernel_modules()}
    for name, prof in PROFILES.items():
        if skip("ragged_paged_attention"):
            break
        max_q = prof["max_q"]
        out["ragged_paged_attention"][name] = check_profile(
            torch, "ragged_paged_attention", name,
            lambda dt: make_case(torch, prof, dt, seed=len(prof["segs"])),
            lambda c: ragged_attention.ragged_paged_attention_cuda(
                **c, max_q=max_q),
            lambda c: ref.ragged_paged_reference(**c, max_q=max_q),
            work(prof, 2), rows=valid_rows(prof), timed=name in TIMED,
            module=ragged_attention, segments=prof["segs"],
            **{k: v for k, v in prof.items() if k != "segs"})
    for name, prof in PAGED_DECODE_PROFILES.items():
        if skip("paged_decode_attention"):
            break
        out["paged_decode_attention"][name] = check_profile(
            torch, "paged_decode_attention", name,
            lambda dt: make_decode_case(torch, prof, dt, seed=8),
            lambda c: paged_decode_attention.paged_decode_attention_cuda(
                **c),
            lambda c: ref.paged_decode_reference(**c),
            work_decode(prof, 2), timed=name in PAGED_DECODE_TIMED,
            module=paged_decode_attention, **prof)
    for name, prof in FLASH_PROFILES.items():
        if skip("flash_attention"):
            break
        out["flash_attention"][name] = check_profile(
            torch, "flash_attention", name,
            lambda dt: make_flash_case(torch, prof, dt, seed=prof["sq"]),
            lambda c: flash_attention.flash_attention_cuda(**c),
            lambda c: ref.mha_reference(**c),
            work_flash(prof, 2), library=sdpa_call,
            timed=name in FLASH_TIMED, module=flash_attention, **prof)
    for name, prof in GEMM_PROFILES.items():
        if skip("expert_gemm"):
            break
        out["expert_gemm"][name] = check_profile(
            torch, "expert_gemm", name,
            lambda dt: make_gemm_case(torch, prof, dt, seed=prof["c"]),
            lambda c: expert_gemm.expert_gemm_cuda(**c),
            lambda c: ref.moe_gemm_reference(**c),
            work_gemm(prof, 2), library=bmm_call,
            timed=name in GEMM_TIMED, scaled=True, module=expert_gemm,
            **prof)
    # the WKV scan: f32 tolerances relative to the output's and the state's
    # scale (sums over N in another order; the state update fused into one
    # multiply-add where the plain version rounds twice, over T steps)
    def check_rwkv(name):
        prof = RWKV_PROFILES[name]
        h, n = rwkv_dims(prof)[2:]
        out["rwkv6_scan"][name] = check_profile(
            torch, "rwkv6_scan", name,
            lambda dt: make_rwkv_case(torch, prof, dt, seed=prof["t"]),
            (lambda c: run_rwkv_in_place(rwkv6_scan, c))
            if prof.get("in_place")
            else (lambda c: rwkv6_scan.rwkv6_scan_cuda(**c)),
            lambda c: ref.rwkv6_reference(**c),
            work_rwkv(prof, 2), timed=name in RWKV_TIMED, scaled=True,
            module=rwkv6_scan, **{"h": h, "n": n, **prof})

    for name in RWKV_PROFILES:
        if skip("rwkv6_scan"):
            break
        if name not in RWKV_EDGES:
            check_rwkv(name)
    for name, prof in DENSE_DECODE_PROFILES.items():
        if skip("decode_attention"):
            break
        out["decode_attention"][name] = check_profile(
            torch, "decode_attention", name,
            lambda dt: make_dense_decode_case(torch, prof, dt,
                                              seed=prof["hq"]),
            lambda c: decode_attention.decode_attention_cuda(**c),
            lambda c: ref.mha_reference(
                c["q"], c["k"], c["v"], causal=False, kv_len=c["lengths"],
                q_offset=c["lengths"].long() - 1),
            work_dense_decode(prof, 2), library=sdpa_decode_call,
            timed=name in DENSE_DECODE_TIMED, module=decode_attention,
            **{"lengths": DECODE_LENGTHS, "t": DENSE_DECODE_T, **prof})
    for name, prof in FLASH_BWD_PROFILES.items():
        if skip("flash_attention_bwd"):
            break
        out["flash_attention_bwd"][name] = check_bwd_profile(torch, name,
                                                             prof)
    for name, prof in GEMM_BWD_PROFILES.items():
        if skip("expert_gemm_bwd"):
            break
        out["expert_gemm_bwd"][name] = check_gemm_bwd_profile(torch, name,
                                                               prof)
    for name, prof in RWKV_BWD_PROFILES.items():
        if skip("rwkv6_scan_bwd"):
            break
        out["rwkv6_scan_bwd"][name] = check_rwkv_bwd_profile(torch, name,
                                                             prof)
    for name in RWKV_EDGES:
        if skip("rwkv6_scan"):
            break
        check_rwkv(name)
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEOMETRY = dict(max_slots=8, prefill_rows=2, chunk_size=128, page_size=16,
                max_seq=2048)
MODES = {"unified": dict(cache_layout="paged", unified=True),
         "paged": dict(cache_layout="paged", unified=False),
         "dense": dict(cache_layout="dense", unified=False)}
MAX_NEW = 32


class GemmBackward:
    """The expert GEMM's backward as a kernel of its own in the launch
    counts and the kernels line: ``csrc/expert_gemm_bwd.cu`` in bf16 (the
    forward's kernel on transposed copies in f32), called by
    ``expert_gemm_bwd_cuda`` (one counted call a gradient) and counted
    apart from the forward (``bwd_launches``, ``bwd_routes``).  The
    reference differentiates its jnp einsum."""
    REPLACES = "src/repro/kernels/ops.py:102"  # expert_gemm, differentiated

    def __init__(self, mod):
        self._mod = mod
        self.SOURCE = mod.BWD_SOURCE

    @property
    def launches(self):
        return self._mod.bwd_launches

    @launches.setter
    def launches(self, n):
        self._mod.bwd_launches = n

    @property
    def routes(self):
        return self._mod.bwd_routes


def kernel_modules():
    """{kernel name: wrapper module}; each module's ``launches`` counts."""
    from repro_torch.kernels import (decode_attention, expert_gemm,
                                     flash_attention, flash_attention_bwd,
                                     paged_decode_attention,
                                     ragged_attention, rwkv6_scan,
                                     rwkv6_scan_bwd)
    return {"ragged_paged_attention": ragged_attention,
            "paged_decode_attention": paged_decode_attention,
            "flash_attention": flash_attention,
            "expert_gemm": expert_gemm,
            "rwkv6_scan": rwkv6_scan,
            "decode_attention": decode_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "expert_gemm_bwd": GemmBackward(expert_gemm),
            "rwkv6_scan_bwd": rwkv6_scan_bwd}


def reset_launches() -> None:
    """Every kernel's launch count, and each route's calls, to 0."""
    for mod in kernel_modules().values():
        mod.launches = 0
        for route in getattr(mod, "routes", {}):
            mod.routes[route] = 0


def read_routes() -> dict[str, dict[str, int]]:
    """Calls of each route of the kernels that have two."""
    return {name: dict(mod.routes) for name, mod in kernel_modules().items()
            if hasattr(mod, "routes")}


def read_launches() -> dict[str, int]:
    return {name: mod.launches for name, mod in kernel_modules().items()}


def expert_launches_per_forward(spec) -> int:
    """Expert GEMM launches of one forward: 3 per MoE layer (up, gate,
    down) with swiglu, 2 without a gate; 0 for a dense model."""
    if spec.moe is None:
        return 0
    per_layer = 3 if spec.act == "swiglu" else 2
    return per_layer * sum(spec.moe.is_moe_layer(i)
                           for i in range(spec.n_layers))


def make_requests(spec, n, max_new, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, spec.vocab,
                                        size=int(rng.integers(100, 1501))
                                        ).tolist(),
                    max_new_tokens=max_new) for _ in range(n)]


def long_requests(spec, n, max_new, seed):
    """``n`` greedy requests of 1,500-2,000 prompt tokens: each prompt takes
    12-16 chunks, so a two-dispatch engine runs prefill-only steps back to
    back before its first decode."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, spec.vocab,
                                        size=int(rng.integers(1500, 2001))
                                        ).tolist(),
                    max_new_tokens=max_new) for _ in range(n)]


def _timed_runs(torch, graphs):
    """CUDA events around every ``graphs.run`` (a StepGraph's profile
    runs): the list of (key, event, event), filled as it runs."""
    spans, run = [], graphs.run

    def timed_run(key):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run(key)
        e1.record()
        spans.append((key, e0, e1))
        return out
    graphs.run = timed_run
    return spans


def time_steps(torch, eng):
    """Time each step of ``eng`` (an engine, or a DisaggCluster, whose own
    StepGraph runs its page copies) on the host clock (ms), and the device
    work of each of its profile runs (replayed, or eager with
    ``graphs=False``) with CUDA events around its ``StepGraph.run``;
    returns the list of host times and the list of (profile key, event,
    event), filled as it steps."""
    host, step = [], eng.step

    def timed_step():
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
    eng.step = timed_step
    return host, _timed_runs(torch, eng._graphs)


def span_stats(spans, steps):
    """Profile runs by class (a key's part before its first '/': prefill,
    decode, reset, insert, sample, unified, spec), the mean device ms of a
    run of each class, and the device ms per engine step."""
    by_class: dict[str, list[float]] = {}
    for key, a, b in spans:
        by_class.setdefault(key.split("/")[0], []).append(a.elapsed_time(b))
    return ({c: len(ms) for c, ms in by_class.items()},
            {c: statistics.mean(ms) for c, ms in by_class.items()},
            sum(map(sum, by_class.values())) / steps)


def prefill_widths(captures):
    """The chunk widths of the bound ``prefill/<w>`` profiles."""
    return sorted(int(key.split("/")[1]) for key in captures
                  if key.startswith("prefill/"))


def record_rejections(eng):
    """Record, as ``eng`` commits each speculative round, where each
    rejected window put the target's own token: per request (in the order
    served), the output index of that token.  A window cut short by the
    request's max_new_tokens before that index records nothing."""
    rejected = {}
    finish = eng._finish_spec_slots

    def recorded(out_toks, n_emit, win, now):
        for slot, req in eng.active.items():
            w, e = int(win[slot]), int(n_emit[slot])
            j = len(req.output) + e - 1
            if e < w and j < req.max_new_tokens:
                rejected.setdefault(req.rid, []).append(j)
        finish(out_toks, n_emit, win, now)
    eng._finish_spec_slots = recorded
    return rejected


def warmed_engine(model, cfg, what, *, graphs=True, draft=None,
                  prompts=None):
    """A ServeEngine for ``cfg`` (speculating with ``draft`` when
    ``cfg.n_spec``) that requests of 2 new tokens have warmed (on a replay
    engine they captured every step profile then), its metrics reset;
    every profile must have been bound exactly once.  ``prompts`` are the
    warm-up's prompts (default one of 39 tokens; a two-dispatch engine is
    warmed with a serve's own prompts, so that every chunk width it will
    run is captured).  Returns the engine and its capture counts."""
    from repro_torch.serving import EngineMetrics, Request, ServeEngine
    eng = ServeEngine(model, cfg, device=DEV, graphs=graphs,
                      draft_model=draft)
    eng.serve([Request(prompt=list(p), max_new_tokens=2)
               for p in prompts or [range(1, 40)]])
    eng.metrics = EngineMetrics()
    captures = dict(eng._graphs.captures)
    if captures != dict.fromkeys(eng._graphs.profiles, 1):
        raise AssertionError(f"{what}: profiles bound {captures}, expected "
                             f"each of {sorted(eng._graphs.profiles)} once")
    return eng, captures


def serve_counted(torch, model, spec, mode, *, graphs=True, n_spec=0,
                  draft=None, warm=True, tp=1, pp=1):
    """Serve the 8 main-path requests through ``mode`` (speculating K =
    ``n_spec`` tokens a round with ``draft``, when given; with ``tp`` x
    ``pp`` > 1, this rank's engine of the sharded serve, ``model`` its
    shard and ``spec`` the whole model's), with every kernel
    count set to 0 just before and read just after; every request must
    finish with MAX_NEW tokens in the vocabulary, and every dispatch must be
    one profile run (two-dispatch: the prefill runs equal the prefill
    calls and the decode runs the decode steps).  On an engine warmed first
    (``warm``; see ``warmed_engine``: the two-dispatch engine with the
    serve's own prompts) no profile may be captured during the serve; a
    cold engine (``warm=False``) must bind every profile once inside it,
    which puts the captures' cost in its numbers.  Returns the engine, its
    stats and the outputs."""
    from repro_torch.serving import EngineConfig, ServeEngine
    cfg = EngineConfig(**GEOMETRY, **MODES[mode], n_spec=n_spec, tp=tp,
                       pp=pp)
    reqs = make_requests(spec, 8, MAX_NEW, seed=0)
    gc.collect()
    mem_before_engine = torch.cuda.memory_allocated()
    if warm:
        prompts = None if cfg.unified else [r.prompt for r in reqs]
        eng, captures = warmed_engine(model, cfg, mode, graphs=graphs,
                                      draft=draft, prompts=prompts)
    else:
        eng, captures = ServeEngine(model, cfg, device=DEV, graphs=graphs,
                                    draft_model=draft), {}
    host, spans = time_steps(torch, eng)
    rejected = record_rejections(eng) if n_spec else {}
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    routes = read_routes()
    if not warm:
        captures = dict(eng._graphs.captures)
        if captures != dict.fromkeys(eng._graphs.profiles, 1):
            raise AssertionError(f"{mode} cold: profiles bound {captures}, "
                                 "expected each once")
    if eng._graphs.captures != captures:
        raise AssertionError(f"{mode}: a profile was bound during the "
                             f"serve: {eng._graphs.captures}")
    for r in reqs:
        if r.state != "done":
            raise AssertionError(f"{mode}: request {r.rid} not done "
                                 f"({r.state})")
        if len(r.output) != MAX_NEW:
            raise AssertionError(f"{mode}: request {r.rid}: "
                                 f"{len(r.output)} tokens")
        if any(not 0 <= t < spec.vocab for t in r.output):
            raise AssertionError(f"{mode}: request {r.rid}: token out of "
                                 "range")
    m = eng.metrics
    runs, device_ms, device_ms_per_step = span_stats(spans, m.steps)
    if len(spans) != m.dispatches:
        raise AssertionError(f"{mode}: {len(spans)} step-profile runs, "
                             f"expected {m.dispatches}")
    if not cfg.unified and (runs.get("prefill", 0), runs.get("decode", 0)) \
            != (m.prefill_calls, m.decode_steps):
        raise AssertionError(f"{mode}: profile runs {runs}, expected "
                             f"{m.prefill_calls} prefill and "
                             f"{m.decode_steps} decode")
    s = m.summary(reqs)
    stats = dict(mode=mode, graphs=graphs, warm=warm, requests=len(reqs),
                 prompt_tokens=sum(len(r.prompt) for r in reqs),
                 generated_tokens=m.generated_tokens, steps=m.steps,
                 decode_steps=m.decode_steps, prefill_calls=m.prefill_calls,
                 dispatches=m.dispatches, transfers_d2h=m.transfers_d2h,
                 preemptions=m.preemptions, wall_s=wall,
                 tokens_per_s=m.generated_tokens / wall,
                 ttft_s_mean=s["ttft_s_mean"], tpot_s_mean=s["tpot_s_mean"],
                 host_ms_per_step=statistics.mean(host),
                 device_ms_per_step=device_ms_per_step,
                 profile_runs=len(spans),
                 device_ms_per_run=statistics.mean(
                     a.elapsed_time(b) for _, a, b in spans),
                 runs_by_class=runs, device_ms_by_class=device_ms,
                 captures=captures, prefill_widths=prefill_widths(captures),
                 capture_s=eng._graphs.capture_s,
                 bind_s=eng._graphs.bind_s,
                 graph_pool_mb=eng._graphs.pool_bytes / 2 ** 20,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 mem_at_start_gb=mem_at_start / 1e9,
                 engine_mem_gb=(mem_at_start - mem_before_engine) / 1e9,
                 kv_quant=model.kv_quant,
                 kv_reserved_bytes=eng.kv_stats()["kv_reserved_bytes"],
                 launches=counts, routes=routes)
    if n_spec:
        stats.update(n_spec=n_spec, spec_rounds=m.spec_rounds,
                     spec_slot_rounds=m.spec_slot_rounds,
                     spec_acceptance_rate=m.spec_acceptance_rate,
                     spec_tokens_per_round=m.spec_tokens_per_round,
                     spec_bonus=m.spec_bonus,
                     rejected_at=[rejected.get(r.rid, []) for r in reqs])
    return eng, stats, [r.output for r in reqs]


def serve_eager_and_replay(torch, model, spec, mode, phase, expect, *,
                           n_spec=0, draft=None, **info):
    """``mode`` (speculating with ``draft`` when ``n_spec``) on the eager
    engine, then on the replay engine (the main path) with the same
    requests: each run's launch counts as ``expect(m, stats)`` asserts
    them, each run's line, then one line holding the two against each
    other: greedy outputs token-identical, or parting only at a genuine
    tie.  Returns the replay run's stats and outputs."""
    outs, lines = {}, {}
    for graphs in (False, True):
        eng, stats, outs[graphs] = serve_counted(torch, model, spec, mode,
                                                 graphs=graphs, n_spec=n_spec,
                                                 draft=draft)
        expect(eng.metrics, stats)
        emit(phase, model=spec.name, **info, **stats, kv=eng.kv_stats())
        lines[graphs] = stats
        del eng
        free(torch)
    prompts = [r.prompt for r in make_requests(spec, 8, MAX_NEW, seed=0)]
    what = f"{spec.name} {mode} eager vs replay"
    ties = _ties(torch, model, prompts, outs[False], outs[True], what)
    keys = ("tokens_per_s", "ttft_s_mean", "tpot_s_mean", "host_ms_per_step",
            "device_ms_per_step", "device_ms_per_run", "device_ms_by_class",
            "steps", "profile_runs", "runs_by_class", "dispatches")
    emit("eager_vs_replay", model=spec.name, mode=mode, n_spec=n_spec,
         identical=sum(a == b for a, b in zip(outs[False], outs[True])),
         ties=ties, eager={k: lines[False][k] for k in keys},
         replay={k: lines[True][k] for k in keys},
         launches_eager=lines[False]["launches"],
         launches_replay=lines[True]["launches"],
         captures=lines[True]["captures"],
         capture_s=lines[True]["capture_s"], bind_s=lines[True]["bind_s"],
         graph_pool_mb=lines[True]["graph_pool_mb"])
    return lines[True], outs[True]


def _expect(mode, counts, nonzero):
    """Every kernel's launches are as ``nonzero`` says, every other 0."""
    want = {name: 0 for name in kernel_modules()}
    want.update(nonzero)
    if counts != want:
        raise AssertionError(f"{mode}: kernel launches {counts}, expected "
                             f"{want}")


def _expect_tensor_cores(mode, routes, kernel, n, route="tensor_core"):
    """All ``n`` calls of ``kernel`` (bf16 at D % 16 == 0 for attention,
    bf16 for the expert GEMM) took the tensor-core ``route``."""
    if routes[kernel] != {route: n, "cuda_core": 0}:
        raise AssertionError(f"{mode}: {kernel} routes {routes[kernel]}, "
                             f"expected all {n} on {route}")


def phase_serve_unified(torch, model, spec, init_s, phase):
    """The unified engine, eager and replayed, then the replay engine's
    profile (``phase`` names the serves' lines); returns the replay
    serve's stats (its kernel launch counts among them) and outputs."""
    from repro_torch.serving import EngineConfig

    def expect(m, stats):
        if not m.dispatches == m.transfers_d2h == m.steps:
            raise AssertionError(f"unified: {m.dispatches} dispatches, "
                                 f"{m.transfers_d2h} transfers, {m.steps} "
                                 "steps")
        mixed = m.prefill_calls
        decode_only = m.dispatches - mixed
        n_ragged = spec.n_layers * (2 * mixed + decode_only)
        n_gemm = expert_launches_per_forward(spec) * m.dispatches
        _expect("unified", stats["launches"], {
            "ragged_paged_attention": n_ragged, "expert_gemm": n_gemm})
        _expect_tensor_cores("unified", stats["routes"],
                             "ragged_paged_attention", n_ragged)
        _expect_tensor_cores("unified", stats["routes"], "expert_gemm",
                             n_gemm, route="wgmma")
        stats.update(mixed_steps=mixed, decode_only_steps=decode_only)

    n_params = sum(p.numel() for p in model.parameters())
    replay = serve_eager_and_replay(
        torch, model, spec, "unified", phase, expect, params=n_params,
        weight_gb=n_params * 2 / 1e9, init_s=init_s)
    phase_serve_profile(torch, model, spec,
                        EngineConfig(**GEOMETRY, **MODES["unified"]))
    return replay


def build_full(torch, arch, n_layers=None):
    """``arch`` at its published width (and depth, unless ``n_layers``
    cuts it), random bf16 weights drawn on the card from seed 0; returns
    (spec, model, seconds to build).  Fails unless the model has exactly
    the layers its spec states."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    spec = get_spec(arch)
    if n_layers is not None:
        spec = spec.scaled(n_layers=n_layers)
    t0 = time.perf_counter()
    model = build_model(spec, device=DEV, dtype=torch.bfloat16, seed=0)
    if len(model.layers) != spec.n_layers:
        raise AssertionError(f"{arch}: {len(model.layers)} layers built, "
                             f"{spec.n_layers} stated")
    if spec.is_attention_free:
        draw_rwkv_mixes(torch, model, seed=0)
    torch.cuda.synchronize()
    return spec, model, time.perf_counter() - t0


def draw_rwkv_mixes(torch, model, seed) -> None:
    """The reference's init leaves every RWKV layer's token-shift mixes and
    its bonus u at zero, which exercises neither the token shift nor the
    bonus term: draw them on the card from ``seed`` (mixes uniform in
    [0, 1), bonus N(0, 1/4))."""
    from repro_torch.models.ssm import MIXES
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for layer in model.layers:
            for name in MIXES:
                p = getattr(layer.mixer, name)
                p.copy_(torch.rand(p.shape, generator=gen, device=DEV))
            u = layer.mixer.u_bonus
            u.copy_(torch.randn(u.shape, generator=gen, device=DEV) * 0.5)


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


# the multi-tenant, multi-turn trace serve_prefix replays (the generator's
# defaults scaled to full-width prompts: system prompts of 512-1024 tokens,
# follow-up turns carrying their whole history; the longest request stays
# under max_seq)
PREFIX_TRACE = dict(n_requests=24, seed=0, n_tenants=3,
                    templates_per_tenant=2, template_tokens=(512, 1025),
                    suffix_tokens=(16, 129), max_new_tokens=(16, 33),
                    multi_turn_p=0.4, max_turns=3, rate_req_s=6.0,
                    burst_factor=4.0, on_s=0.4, off_s=0.4, think_s=0.05)


def replay_counted(torch, model, spec, trace, prefix_cache):
    """Replay ``trace`` at time_scale 1 through the unified replay engine,
    the prefix cache on or off, on an engine that one short request has
    warmed (its profiles captured then), every kernel count set to 0 just
    before and read just after.  Every request must finish with its
    max_new_tokens in the vocabulary, no profile may be captured during the
    replay, the ragged launches must equal n_layers x (2 x mixed + decode-
    only forwards), all on the tensor-core route, and the accounting must be
    the reference's: d2h copies == steps, dispatches == steps + copy-on-write
    forks (0 with the cache off); the allocator and the tree pass their
    audits.  Returns the engine, its stats and the requests."""
    from repro_torch.serving import EngineConfig, replay
    what = f"serve_prefix cache {'on' if prefix_cache else 'off'}"
    eng, captures = warmed_engine(model, EngineConfig(
        **GEOMETRY, **MODES["unified"], prefix_cache=prefix_cache), what)
    host, spans = time_steps(torch, eng)
    torch.cuda.synchronize()
    gc.collect()
    reset_launches()
    summary, reqs = replay(eng, trace, time_scale=1.0)
    torch.cuda.synchronize()
    counts = read_launches()
    routes = read_routes()
    if eng._graphs.captures != captures:
        raise AssertionError(f"{what}: a profile was bound during the "
                             f"replay: {eng._graphs.captures}")
    for i, (r, t) in enumerate(zip(reqs, trace)):
        if r.state != "done" or len(r.output) != t.max_new_tokens:
            raise AssertionError(f"{what}: trace request {i} {r.state}, "
                                 f"{len(r.output)} tokens")
        if any(not 0 <= tok < spec.vocab for tok in r.output):
            raise AssertionError(f"{what}: trace request {i}: token out of "
                                 "range")
    m = eng.metrics
    if not (m.transfers_d2h == m.steps
            and m.dispatches == m.steps + m.prefix_cow_forks):
        raise AssertionError(f"{what}: {m.dispatches} dispatches, "
                             f"{m.transfers_d2h} transfers, {m.steps} steps, "
                             f"{m.prefix_cow_forks} forks")
    mixed = m.prefill_calls
    decode_only = m.transfers_d2h - mixed
    n_ragged = spec.n_layers * (2 * mixed + decode_only)
    _expect(what, counts, {"ragged_paged_attention": n_ragged})
    _expect_tensor_cores(what, routes, "ragged_paged_attention", n_ragged)
    if len(spans) != m.transfers_d2h:
        raise AssertionError(f"{what}: {len(spans)} step-profile runs, "
                             f"expected {m.transfers_d2h}")
    eng.pager.check()
    if prefix_cache:
        eng.prefix.check()
    e = summary.engine
    stats = dict(prefix_cache=prefix_cache, requests=summary.n_requests,
                 prompt_tokens=sum(len(r.prompt) for r in reqs),
                 prefill_tokens=m.prefill_tokens,
                 generated_tokens=m.generated_tokens, steps=m.steps,
                 mixed_steps=mixed, decode_only_steps=decode_only,
                 dispatches=m.dispatches, transfers_d2h=m.transfers_d2h,
                 preemptions=m.preemptions, wall_s=summary.wall_s,
                 tokens_per_s=summary.throughput_tok_s,
                 ttft_s_mean=summary.ttft_mean_s,
                 tpot_s_mean=summary.tpot_mean_s,
                 ttft_s_p95=e["ttft_s_p95"], by_tenant=summary.by_tenant,
                 host_ms_per_step=statistics.mean(host),
                 device_ms_per_run=statistics.mean(a.elapsed_time(b)
                                                   for _, a, b in spans),
                 captures=captures, pages_in_use_peak=m.pages_in_use_peak,
                 launches=counts, routes=routes,
                 prefix={k: v for k, v in e.items()
                         if k.startswith("prefix_")})
    return eng, stats, reqs


def _divergences(torch, model, a, b, gaps=None):
    """Where the replays ``a`` and ``b`` (lists of requests) part: each
    differing request's first differing position, whether its resolved
    prompt was the same (a follow-up turn's prompt carries its parent's
    output), and where it was, the top-2 logit gap there (kept in ``gaps``
    by the tokens before it, when given, for the caller's next call)."""
    out, gaps = [], {} if gaps is None else gaps
    for i, (x, y) in enumerate(zip(a, b)):
        if x.output == y.output:
            continue
        j = next((k for k, (s, t) in enumerate(zip(x.output, y.output))
                  if s != t), min(len(x.output), len(y.output)))
        d = {"request": i, "position": j, "same_prompt": x.prompt == y.prompt}
        if d["same_prompt"]:
            key = tuple(x.prompt + x.output[:j])
            if key not in gaps:
                top2 = _last_logits(torch, model, list(key)).topk(2).values
                gaps[key] = float(top2[0] - top2[1])
            d["top2_gap"] = gaps[key]
        out.append(d)
    return out


def phase_serve_prefix(torch, model, spec) -> list[dict]:
    """The prefix cache on the main path: the multi-tenant trace replayed
    through the unified replay engine with the cache off, on, and off again
    (see ``replay_counted``); the cache must hit, skip prefill tokens and
    cause no capture.  One line per replay, then one holding them against
    each other: prefill tokens, TTFT, TPOT, tokens/s, host and device ms
    per step, and how many requests' outputs match token for token, cache
    on against off and off against off (the replays follow the trace's
    clock, so the batches a token shares differ from run to run, and at
    full width in bf16 that can move a near-tie; reported, not asserted:
    the exact checks are serve_parity's, in f32).  Returns each replay's
    kernel launch counts."""
    from repro_torch.serving import TraceConfig, generate_trace
    trace = generate_trace(TraceConfig(vocab=spec.vocab, **PREFIX_TRACE))
    lines, reqs = [], []
    for on in (False, True, False):
        eng, stats, served = replay_counted(torch, model, spec, trace, on)
        emit("serve_prefix", model=spec.name, trace=len(trace), **stats)
        lines.append(stats)
        reqs.append(served)
        del eng
        free(torch)
    off, on = lines[0], lines[1]
    p = on["prefix"]
    if not (p["prefix_hits"] > 0 and p["prefix_cached_tokens"] > 0
            and on["prefill_tokens"] < off["prefill_tokens"]):
        raise AssertionError(f"serve_prefix: no saving: {p}, prefill tokens "
                             f"{on['prefill_tokens']} on, "
                             f"{off['prefill_tokens']} off")
    keys = ("prefill_tokens", "tokens_per_s", "ttft_s_mean", "ttft_s_p95",
            "tpot_s_mean", "host_ms_per_step", "device_ms_per_run", "steps",
            "mixed_steps", "decode_only_steps")
    on_off = _divergences(torch, model, reqs[1], reqs[0])
    off_off = _divergences(torch, model, reqs[2], reqs[0])
    emit("prefix_vs_off", model=spec.name, requests=len(trace),
         identical=len(trace) - len(on_off), diverged=on_off,
         identical_off_vs_off=len(trace) - len(off_off),
         diverged_off_vs_off=off_off,
         prefill_saved=1 - on["prefill_tokens"] / off["prefill_tokens"],
         on={k: on[k] for k in keys}, off={k: off[k] for k in keys},
         off_again={k: lines[2][k] for k in keys})
    return [line["launches"] for line in lines]


SPEC_K = 4  # draft tokens a round: the reference bench's default --n-spec


def perturbed_draft(torch, target):
    """A second model of ``target``'s spec and dtype whose weights are the
    target's times (1 + 0.04 N(0, 1)), the noise drawn on the card from
    seed 99 (the reference tests' ``drafted`` recipe): its argmax agrees
    with the target's often but not always, so greedy rounds take both the
    accept and the reject/rollback path."""
    from repro_torch.models import build_model
    draft = build_model(target.spec, device=DEV, dtype=target.dtype, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(99)
    with torch.no_grad():
        for p, q in zip(draft.parameters(), target.parameters()):
            noise = torch.randn(p.shape, generator=gen, device=DEV,
                                dtype=p.dtype)
            p.copy_(q * noise.mul_(0.04).add_(1.0))
    torch.cuda.synchronize()
    return draft


def _as_requests(prompts, outputs):
    """Requests holding ``outputs`` for ``prompts`` (what ``_divergences``
    reads)."""
    from repro_torch.serving import Request
    return [Request(prompt=list(p), output=list(o))
            for p, o in zip(prompts, outputs)]


def phase_serve_spec(torch, model, spec) -> list[dict]:
    """Speculative decoding on the main path: the 8 main-path requests
    through the unified engine with spec off (replay engine), with a
    self-draft (K = SPEC_K; eager, then replay, and an eager_vs_replay
    line), and with a perturbed full-width draft (replay; built here and
    freed after).  Each run: every request finishes, dispatches == d2h
    copies == steps, one capture per profile and none in the serve, the
    ragged launches exactly L_t (2 m + d) + L_d ((K+1) m + K d) (m mixed
    and d decode-only rounds; the verify and the catch-up split in a mixed
    round, each of the K-1 proposals is one launch), all on the
    tensor-core route, every other kernel 0.  Each line gives peak device
    memory and its increase over spec off (the paper's §IV-B cost); a
    spec_vs_off line per draft gives the outputs identical to spec off and
    where the others part, with the top-2 logit gap there (recorded, not
    required: in bf16 at full width the verify's batches round differently
    from the plain decode's).  Each self-draft window rejected in the
    replay run must have committed the target's token where the target's
    top-2 gap is under SPEC_BF16_TIE_GAP: there the draft, the same weights
    at other batch shapes, may round to the runner-up; a rejection at a
    wider gap is a fault of the round.  Returns each replay run's launch
    counts."""
    k, n_layers = SPEC_K, spec.n_layers

    def expect_for(l_draft):
        def expect(m, stats):
            if not m.dispatches == m.transfers_d2h == m.steps:
                raise AssertionError(f"serve_spec: {m.dispatches} "
                                     f"dispatches, {m.transfers_d2h} "
                                     f"transfers, {m.steps} steps")
            mixed = m.prefill_calls
            d = m.dispatches - mixed
            n = n_layers * (2 * mixed + d) + l_draft * ((k + 1) * mixed
                                                        + k * d)
            _expect("serve_spec", stats["launches"],
                    {"ragged_paged_attention": n})
            _expect_tensor_cores("serve_spec", stats["routes"],
                                 "ragged_paged_attention", n)
            stats.update(mixed_steps=mixed, decode_only_steps=d)
        return expect

    prompts = [r.prompt for r in make_requests(spec, 8, MAX_NEW, seed=0)]
    eng, off, off_outs = serve_counted(torch, model, spec, "unified")
    expect_for(0)(eng.metrics, off)
    emit("serve_spec", model=spec.name, draft_model="off", **off)
    del eng
    free(torch)
    runs = {"off": off}
    outs = {}
    runs["self"], outs["self"] = serve_eager_and_replay(
        torch, model, spec, "unified", "serve_spec", expect_for(n_layers),
        n_spec=k, draft=model, draft_model="self")
    draft = perturbed_draft(torch, model)
    eng, runs["perturbed"], outs["perturbed"] = serve_counted(
        torch, model, spec, "unified", n_spec=k, draft=draft)
    expect_for(draft.spec.n_layers)(eng.metrics, runs["perturbed"])
    emit("serve_spec", model=spec.name, draft_model="perturbed",
         **runs["perturbed"])
    del eng, draft
    free(torch)
    gaps = {name: _rejection_gaps(torch, model, prompts, outs[name],
                                  runs[name]["rejected_at"])
            for name in ("self", "perturbed")}
    wide = [g for g in gaps["self"] if not g["top2_gap"] < SPEC_BF16_TIE_GAP]
    emit("spec_rejections", model=spec.name, n_spec=k,
         tie_gap=SPEC_BF16_TIE_GAP,
         self={"rejected_windows": len(gaps["self"]), "at": gaps["self"]},
         perturbed={"rejected_windows": len(gaps["perturbed"]),
                    "top2_gaps": sorted(g["top2_gap"]
                                        for g in gaps["perturbed"])})
    if wide:
        raise AssertionError(f"serve_spec: self-draft windows rejected at "
                             f"top-2 gaps of {SPEC_BF16_TIE_GAP} or more: "
                             f"{wide}")
    keys = ("tokens_per_s", "ttft_s_mean", "tpot_s_mean", "host_ms_per_step",
            "device_ms_per_run", "steps", "mixed_steps", "decode_only_steps",
            "peak_mem_gb")
    for name in ("self", "perturbed"):
        line = runs[name]
        parted = _divergences(torch, model, _as_requests(prompts, outs[name]),
                              _as_requests(prompts, off_outs))
        emit("spec_vs_off", model=spec.name, draft_model=name, n_spec=k,
             identical=len(prompts) - len(parted), diverged=parted,
             spec={key: line[key] for key in keys
                   + ("spec_rounds", "spec_acceptance_rate",
                      "spec_tokens_per_round", "spec_bonus")},
             off={key: off[key] for key in keys},
             peak_mem_increase_gb=line["peak_mem_gb"] - off["peak_mem_gb"])
    return [runs[name]["launches"] for name in ("off", "self", "perturbed")]


def serve_cold(torch, model, spec, mode, phase, expect, **info) -> None:
    """``mode`` served once on a fresh replay engine that no warm-up has
    captured: every profile's capture falls inside the serve (see
    ``serve_counted``); the launches as ``expect`` asserts them, one line
    with the captures, their seconds (inside the graph blocks, and
    ``bind_s`` for the whole first uses) and the graph pool beside the
    serve's TTFT, TPOT and tokens/s."""
    eng, stats, _ = serve_counted(torch, model, spec, mode, warm=False)
    expect(eng.metrics, stats)
    emit(phase, model=spec.name, cold=True, **info, **stats)
    del eng
    free(torch)


def phase_serve_two_dispatch(torch, model, spec) -> dict:
    """The two-dispatch engine in both layouts, eager and replayed (every
    prefill chunk, row reset, insert, first-token sample and decode one
    replay), a cold dense serve whose captures fall inside it, then the
    dense replay engine's profile; returns {layout: (stats, outputs)} of
    each warm replay serve (its kernel launch counts among the stats).
    Every flash call of the bf16 model must take the tensor-core route."""
    from repro_torch.serving import EngineConfig

    def expect_for(mode):
        def expect(m, stats):
            n = spec.n_layers
            want = {"paged_decode_attention": n * m.decode_steps,
                    "flash_attention": n * m.prefill_calls,
                    "expert_gemm": expert_launches_per_forward(spec)
                    * (m.decode_steps + m.prefill_calls)}
            if mode == "dense":
                want.update(paged_decode_attention=0,
                            flash_attention=n * (m.prefill_calls
                                                 + m.decode_steps))
            _expect(mode, stats["launches"], want)
            for kernel in ("flash_attention", "paged_decode_attention"):
                _expect_tensor_cores(mode, stats["routes"], kernel,
                                     want[kernel])
        return expect

    out = {mode: serve_eager_and_replay(torch, model, spec, mode,
                                        "serve_two_dispatch",
                                        expect_for(mode))
           for mode in ("paged", "dense")}
    serve_cold(torch, model, spec, "dense", "serve_two_dispatch",
               expect_for("dense"))
    phase_serve_profile(torch, model, spec,
                        EngineConfig(**GEOMETRY, **MODES["dense"]))
    return out


def phase_serve_kvq(torch, model, spec, base) -> list[dict]:
    """The int8 KV cache on the main paths: the same weights (``model``
    with ``kv_quant`` set for the phase) and the same 8 requests through
    the replay engine in all three modes, warmed as the unquantized serves
    were.  Launch counts exact in each run, each attention call on its
    kernel's tensor-core route over the dequantized view: ragged n_layers x
    (2 x mixed + decode-only) (unified); flash n_layers x (prefill calls +
    decode steps) and paged decode 0 (paged two-dispatch: the quantized
    decode takes the reference's gather route, flash at Sq = 1); flash
    n_layers x (prefill calls + decode steps) (dense).  Each mode's line
    gives kv_reserved_bytes, peak memory and the engine's own memory (what
    its construction and warm-up left allocated) beside the unquantized
    serve's
    (``base[mode]``: its replay stats and outputs), TTFT, TPOT, tokens/s,
    host and device ms per step; a kvq_vs_full line per mode gives how many
    of the 8 bf16 outputs equal the unquantized ones and, where they part,
    the full-precision model's top-2 logit gap there (recorded, not
    required); then serve_profile of each quantized replay engine (the
    dequantize, the gather and the attention kernels as classes of their
    own).  Returns each run's kernel launch counts."""
    from repro_torch.serving import EngineConfig

    def expect_for(mode):
        def expect(m, stats):
            n = spec.n_layers
            if mode == "unified":
                mixed = m.prefill_calls
                kernel, want = "ragged_paged_attention", {
                    "ragged_paged_attention":
                        n * (2 * mixed + m.dispatches - mixed)}
            else:
                kernel, want = "flash_attention", {
                    "flash_attention": n * (m.prefill_calls
                                            + m.decode_steps)}
            _expect(f"serve_kvq {mode}", stats["launches"], want)
            _expect_tensor_cores(f"serve_kvq {mode}", stats["routes"],
                                 kernel, want[kernel])
        return expect

    prompts = [r.prompt for r in make_requests(spec, 8, MAX_NEW, seed=0)]
    keys = ("tokens_per_s", "ttft_s_mean", "tpot_s_mean", "host_ms_per_step",
            "device_ms_per_step", "device_ms_by_class", "peak_mem_gb",
            "mem_at_start_gb", "engine_mem_gb", "kv_reserved_bytes")
    launches, outs = [], {}
    model.kv_quant = True
    try:
        for mode in MODES:
            eng, stats, outs[mode] = serve_counted(torch, model, spec, mode)
            expect_for(mode)(eng.metrics, stats)
            full = base[mode][0]
            emit("serve_kvq", model=spec.name, **stats, full={
                k: full[k] for k in keys},
                 kv_bytes_ratio=stats["kv_reserved_bytes"]
                 / full["kv_reserved_bytes"],
                 peak_mem_saved_gb=full["peak_mem_gb"] - stats["peak_mem_gb"],
                 engine_mem_saved_gb=full["engine_mem_gb"]
                 - stats["engine_mem_gb"])
            launches.append(stats["launches"])
            del eng
            free(torch)
        for mode in MODES:
            phase_serve_profile(torch, model, spec,
                                EngineConfig(**GEOMETRY, **MODES[mode]))
    finally:
        model.kv_quant = False
    gaps = {}  # the layouts part at the same tokens: one forward each
    for mode in MODES:
        parted = _divergences(torch, model, _as_requests(prompts, outs[mode]),
                              _as_requests(prompts, base[mode][1]), gaps)
        emit("kvq_vs_full", model=spec.name, mode=mode,
             identical=len(prompts) - len(parted), diverged=parted)
    return launches


# the disaggregated cluster's geometry at full width: the serves' page and
# chunk sizes, 2 prefill rows, 8 decode slots, one idle packed decode lane
# on the prefill side
DISAGG = dict(max_seq=2048, page_size=16, chunk_size=128, prefill_rows=2,
              prefill_slots=1, decode_slots=8)


def _fresh_cluster_counters(cl) -> None:
    """Zero a warmed cluster's counters (its own, its channel's and both
    engines'), keeping its engines, pools and captured profiles."""
    from repro_torch.serving import (ClusterMetrics, EngineMetrics,
                                     KvMigrationChannel)
    cl.metrics = ClusterMetrics()
    for eng in (cl.prefill_eng, cl.decode_eng):
        eng.metrics = EngineMetrics()
        eng.finished = []
    cl.channel = KvMigrationChannel(cl.prefill_eng.pager,
                                    cl.decode_eng.pager, cl._copy_pages,
                                    cl.page_bytes, link=cl.cfg.link)
    cl.migration_s = {}
    cl._finished_at_prefill = []


def warmed_cluster(model, decode_unified, **cfg):
    """A DisaggCluster on ``model`` (DISAGG, ``cfg`` on top) that two
    requests of 39 prompt tokens and 2 new ones have warmed: on the card
    every profile the serve will run is captured then (the prefill pool's
    mixed step, the decode pool's decode, the page copy); its counters
    zeroed after."""
    from repro_torch.serving import DisaggCluster, DisaggClusterConfig, Request
    cl = DisaggCluster(model, DisaggClusterConfig(
        **DISAGG, decode_unified=decode_unified, **cfg), device=DEV)
    cl.serve([Request(prompt=list(range(1, 40)), max_new_tokens=2)
              for _ in range(2)])
    _fresh_cluster_counters(cl)
    return cl


def phase_serve_disagg(torch, model, spec, base_outs) -> list[dict]:
    """P/D disaggregation on the main path: the 8 main-path requests
    through a DisaggCluster (DISAGG; the device link) on ``model``, with
    the decode pool unified and then two-dispatch, each warmed first
    (``warmed_cluster``): every prompt prefills in the unified prefill
    engine, exports at its first token, migrates page by page (one replay
    of the cluster's copy per migration) and decodes in the decode engine.
    Each run: every request finishes with MAX_NEW tokens, 8 migrations, no
    profile captured during the serve, each engine's profile runs equal
    its dispatches, and the launches exact: ragged n_layers x (2 x mixed +
    decode-only) over the prefill engine's packed steps (each mixed) and,
    unified, the decode engine's; two-dispatch, paged decode n_layers x
    decode steps and flash n_layers x local prefill calls (recompute after
    a preemption); every other kernel 0, every call on the tensor-core
    route.  The line gives tokens/s, TTFT with and without the migration,
    TPOT, host ms per cluster step, each engine's device ms per cluster
    step, the migrations, pages and bytes, the device ms of a copy against
    its bytes bound (2 x the content pages' bytes at 3.35 TB/s; the copy
    moves max_pages pages, the padded lanes null page onto null page), the
    pools' utilisation and peak memory; how many of the 8 bf16 outputs
    equal ``base_outs`` (serve_full's replay, the unified engine) is
    recorded, not required.  Returns each run's launch counts."""
    launches = []
    for du in (True, False):
        launches.append(_serve_disagg_once(torch, model, spec, du,
                                           base_outs))
        free(torch)
    return launches


def _serve_disagg_once(torch, model, spec, du, base_outs) -> dict:
    """One run of serve_disagg (decode pool unified when ``du``): its
    checks and its line; returns its launch counts.  Everything the run
    made dies with this frame, so the next run's memory is its own."""
    n = spec.n_layers
    mode = "unified" if du else "two_dispatch"
    gc.collect()
    mem_before = torch.cuda.memory_allocated()
    cl = warmed_cluster(model, du)
    pre, dec = cl.prefill_eng, cl.decode_eng
    captures = {"prefill": dict(pre._graphs.captures),
                "decode": dict(dec._graphs.captures),
                "cluster": dict(cl._graphs.captures)}
    _, pre_spans = time_steps(torch, pre)
    _, dec_spans = time_steps(torch, dec)
    host, mig_spans = time_steps(torch, cl)  # cluster steps, page copies
    reqs = make_requests(spec, 8, MAX_NEW, seed=0)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    cl.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = read_launches(), read_routes()
    what = f"serve_disagg {mode}"
    now = {"prefill": pre._graphs.captures, "decode": dec._graphs.captures,
           "cluster": cl._graphs.captures}
    if now != captures:
        raise AssertionError(f"{what}: a profile was bound during the "
                             f"serve: {now}, warmed {captures}")
    for r in reqs:
        if r.state != "done" or len(r.output) != MAX_NEW or any(
                not 0 <= t < spec.vocab for t in r.output):
            raise AssertionError(f"{what}: request {r.rid} "
                                 f"{r.state}, {len(r.output)} tokens")
    pm, dm, cm = pre.metrics, dec.metrics, cl.metrics
    s = cl.summary(reqs)
    if not (s["migrations"] == cm.migration_dispatches == len(mig_spans)
            == pm.exports == dm.imports == len(reqs)):
        raise AssertionError(f"{what}: {s['migrations']} migrations, "
                             f"{cm.migration_dispatches} copies, "
                             f"{len(mig_spans)} copy runs, "
                             f"{pm.exports} exports, {dm.imports} "
                             "imports")
    for name, eng, spans in (("prefill", pre, pre_spans),
                             ("decode", dec, dec_spans)):
        m = eng.metrics
        if len(spans) != m.dispatches:
            raise AssertionError(f"{what}: {name} engine ran "
                                 f"{len(spans)} profiles for "
                                 f"{m.dispatches} dispatches")
    runs_pre, ms_pre, _ = span_stats(pre_spans, cm.steps)
    runs_dec, ms_dec, _ = span_stats(dec_spans, cm.steps)
    if set(runs_pre) != {"unified"} or pm.dispatches != pm.transfers_d2h:
        raise AssertionError(f"{what}: prefill engine runs {runs_pre}, "
                             f"{pm.dispatches} dispatches, "
                             f"{pm.transfers_d2h} transfers")
    want = {"ragged_paged_attention":
            n * (2 * pm.prefill_calls + pm.dispatches - pm.prefill_calls)}
    if du:
        want["ragged_paged_attention"] += n * (
            2 * dm.prefill_calls + dm.dispatches - dm.prefill_calls)
    else:
        if (runs_dec.get("prefill", 0), runs_dec.get("decode", 0)) \
                != (dm.prefill_calls, dm.decode_steps):
            raise AssertionError(f"{what}: decode engine runs "
                                 f"{runs_dec}, {dm.prefill_calls} "
                                 f"prefill calls, {dm.decode_steps} "
                                 "decode steps")
        want["paged_decode_attention"] = n * dm.decode_steps
        want["flash_attention"] = n * dm.prefill_calls
    _expect(what, counts, want)
    for kernel, k in want.items():
        _expect_tensor_cores(what, routes, kernel, k)
    copy_ms = [a.elapsed_time(b) for _, a, b in mig_spans]
    bytes_per_copy = s["migrated_bytes"] / s["migrations"]
    stats = dict(
        decode_unified=du, requests=len(reqs),
        prompt_tokens=sum(len(r.prompt) for r in reqs),
        generated_tokens=s["generated_tokens"], wall_s=wall,
        tokens_per_s=s["generated_tokens"] / wall,
        ttft_s_mean=s["ttft_s_mean"],
        ttft_incl_migration_s_mean=s["ttft_incl_migration_s_mean"],
        tpot_s_mean=s["tpot_s_mean"], cluster_steps=cm.steps,
        host_ms_per_cluster_step=statistics.mean(host),
        prefill_device_ms_per_cluster_step=sum(
            a.elapsed_time(b) for _, a, b in pre_spans) / cm.steps,
        decode_device_ms_per_cluster_step=sum(
            a.elapsed_time(b) for _, a, b in dec_spans) / cm.steps,
        copy_device_ms_per_cluster_step=sum(copy_ms) / cm.steps,
        prefill_runs_by_class=runs_pre, prefill_ms_by_class=ms_pre,
        decode_runs_by_class=runs_dec, decode_ms_by_class=ms_dec,
        prefill_engine=dict(steps=pm.steps, dispatches=pm.dispatches,
                            prefill_calls=pm.prefill_calls,
                            exports=pm.exports),
        decode_engine=dict(steps=dm.steps, dispatches=dm.dispatches,
                           decode_steps=dm.decode_steps,
                           prefill_calls=dm.prefill_calls,
                           imports=dm.imports,
                           preemptions=dm.preemptions),
        migrations=s["migrations"],
        migrated_pages=s["migrated_pages"],
        migrated_bytes=s["migrated_bytes"], page_bytes=cl.page_bytes,
        migration_dispatches=cm.migration_dispatches,
        migrations_inflight_peak=cm.migrations_inflight_peak,
        copy_ms_mean=statistics.mean(copy_ms),
        copy_ms_median=statistics.median(copy_ms),
        copy_ms=copy_ms,
        copy_bound_ms=2 * bytes_per_copy / HBM_BYTES_PER_S * 1e3,
        copy_bound_by="bytes",
        copy_moved_pages=cl.max_pages,
        copy_moved_bound_ms=2 * cl.max_pages * cl.page_bytes
        / HBM_BYTES_PER_S * 1e3,
        prefill_pool_util_mean=s["prefill_pool_util_mean"],
        decode_pool_util_mean=s["decode_pool_util_mean"],
        prefill_rows_busy_mean=s["prefill_rows_busy_mean"],
        decode_slot_occupancy_mean=s["decode_slot_occupancy_mean"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        mem_at_start_gb=mem_at_start / 1e9,
        cluster_mem_gb=(mem_at_start - mem_before) / 1e9,
        kv=cl.kv_stats(), captures=captures,
        identical_to_serve_full=sum(
            r.output == o for r, o in zip(reqs, base_outs)),
        launches=counts, routes=routes)
    emit("serve_disagg", model=spec.name, **stats)
    return counts


BEAM_SIZE = 4
BEAM_NEW = 16


def phase_beam(torch, model, spec) -> dict:
    """Beam search on the main path: ``model`` (full width, bf16), beam
    BEAM_SIZE on one main-path prompt, BEAM_NEW tokens, no eos, on the
    dense cache: the flash kernel's launches exactly n_layers x (1 prefill
    + BEAM_NEW - 1 decode steps), all on the tensor-core route, every other
    kernel 0.  The line gives the sequence's length, its score, the wall
    time and ms per token; returns the launch counts."""
    from repro_torch.serving import BeamSearcher
    prompt = make_requests(spec, 1, BEAM_NEW, seed=5)[0].prompt
    calls = {"prefill_chunk": 0, "decode_step": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(model, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(model, name, counted)
    try:
        searcher = BeamSearcher(model, beam_size=BEAM_SIZE,
                                max_seq=GEOMETRY["max_seq"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        seq, score = searcher.search(prompt, BEAM_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name in calls:
            delattr(model, name)
    counts, routes = read_launches(), read_routes()
    n = spec.n_layers * (calls["prefill_chunk"] + calls["decode_step"])
    if calls != {"prefill_chunk": 1, "decode_step": BEAM_NEW - 1}:
        raise AssertionError(f"beam: model calls {calls}")
    _expect("beam", counts, {"flash_attention": n})
    _expect_tensor_cores("beam", routes, "flash_attention", n)
    if len(seq) != BEAM_NEW or any(not 0 <= t < spec.vocab for t in seq) \
            or not score == score:
        raise AssertionError(f"beam: {seq}, score {score}")
    emit("beam", model=spec.name, beam_size=BEAM_SIZE,
         prompt_tokens=len(prompt), new_tokens=len(seq), score=score,
         model_calls=calls, wall_s=wall, ms_per_token=wall * 1e3 / len(seq),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=counts, routes=routes)
    return counts


def phase_decode_op(torch) -> dict:
    """The dense decode's path: its entry point,
    ``kernels.ops.decode_attention``, once per layer of a minitron-8b
    decode step on the decode profile's bf16 inputs, counts set to 0 just
    before and read just after; returns the counts."""
    from repro_torch.configs import get_spec
    from repro_torch.kernels import ops
    n_layers = get_spec("minitron-8b").n_layers
    case = make_dense_decode_case(torch, DENSE_DECODE_PROFILES["decode"],
                                  torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [ops.decode_attention(case["q"], case["k"], case["v"],
                                 lengths=case["lengths"])
            for _ in range(n_layers)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    routes = read_routes()["decode_attention"]
    _expect("decode_op", counts, {"decode_attention": n_layers})
    if routes != {"tensor_core": n_layers, "cuda_core": 0}:
        raise AssertionError(f"decode_op: routes {routes}")
    out = outs[-1].float()
    if not bool(out.isfinite().all()):
        raise AssertionError("decode_op: non-finite output")
    zero_rows = [i for i, n in enumerate(DECODE_LENGTHS) if n == 0]
    if bool(out[zero_rows].ne(0).any()):
        raise AssertionError("decode_op: a length-0 row is not zero")
    emit("decode_op", calls=n_layers, wall_ms=wall * 1e3,
         shape=list(case["k"].shape), lengths=DECODE_LENGTHS,
         launches=counts, routes=routes)
    return counts


def phase_serve_rwkv(torch, model, spec, init_s) -> list[dict]:
    """The attention-free stack through the two-dispatch engine in both
    layouts, eager and replayed, a cold dense serve whose captures fall
    inside it, then the dense replay engine's profile; returns each warm
    replay serve's kernel launch counts."""
    from repro_torch.serving import EngineConfig

    def expect(m, stats):
        _expect("rwkv", stats["launches"], {
            "rwkv6_scan": spec.n_layers * (m.prefill_calls
                                           + m.decode_steps)})

    n_params = sum(p.numel() for p in model.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    out = [serve_eager_and_replay(torch, model, spec, mode, "serve_rwkv",
                                  expect, params=n_params,
                                  weight_gb=weight_gb,
                                  init_s=init_s)[0]["launches"]
           for mode in ("dense", "paged")]
    serve_cold(torch, model, spec, "dense", "serve_rwkv", expect,
               params=n_params, weight_gb=weight_gb, init_s=init_s)
    phase_serve_profile(torch, model, spec,
                        EngineConfig(**GEOMETRY, **MODES["dense"]))
    return out


def _kernel_class(name: str) -> str:
    """The class of a device kernel by its name.  The tensor-core attention
    walk (attn_tc_*) names its caller's addressing type: the ragged
    kernel's and the paged decode's contain their names, and the dense one
    counts as flash (no serve calls the dense decode, its other user); the
    CUDA-core split-KV combine belongs to the paged decode.  The int8 KV
    cache's dequantize (an elementwise product that casts) and the gather
    kernels (the quantized paged decode's page gather among them) are
    classes of their own."""
    n = name.lower()
    if "ragged_paged" in n:
        return "ragged_attention"
    if "paged_decode" in n or "decode_combine" in n:
        return "paged_decode_attention"
    if "flash_attention" in n or "attn_tc_" in n:
        return "flash_attention"
    if "expert_gemm" in n:
        return "expert_gemm"
    if "rwkv6_scan" in n:
        return "rwkv6_scan"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                            "nvjet")):
        return "matmul"
    if "sort" in n or "radix" in n:
        return "sampling_sort"
    if "mulfunctor" in n and "gpu_kernel_impl<" in n:
        # the one product that casts its operands: int8 codes times f32
        # scales into the compute dtype (every other product is nocast)
        return "kv_dequantize"
    if "gather" in n:
        return "gather"
    if "index" in n or "scatter" in n:
        return "index"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def phase_serve_profile(torch, model, spec, cfg) -> dict:
    """Where a step's time goes: torch.profiler over a short serve (8
    requests of 100-1500 prompt tokens, 8 new tokens each) through the
    replay engine ``cfg`` names, its profiles captured before (see
    ``warmed_engine``; a two-dispatch engine warmed with the serve's own
    prompts) and none during it; device time summed by kernel class (a
    replay's kernels keep their names), against the wall clock of the same
    steps; every dispatch one graph launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = make_requests(spec, 8, 8, seed=2)
    eng, captures = warmed_engine(
        model, cfg, "serve_profile",
        prompts=None if cfg.unified else [r.prompt for r in reqs])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict[str, float] = {}
    launches = graph_launches = 0
    # the raw kineto events: the same sums as key_averages() (checked on an
    # H100: every class to the last digit), without building its 90,000
    # Python events (1.0 s against 7.3 for minitron-8b's serve)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name == "cudaGraphLaunch":
            graph_launches += 1
        if ev.device_type() != DeviceType.CUDA:
            continue  # host-side ops and runtime calls
        cls = _kernel_class(name)
        by_class[cls] = (by_class.get(cls, 0.0)
                         + (ev.end_ns() - ev.start_ns()) / 1e6)
        launches += 1
    busy = sum(by_class.values())
    m = eng.metrics
    if graph_launches < m.dispatches:
        raise AssertionError(f"serve_profile: {graph_launches} graph "
                             f"launches under the profiler for "
                             f"{m.dispatches} dispatches")
    if eng._graphs.captures != captures:
        raise AssertionError(f"serve_profile: a profile was bound during "
                             f"the serve: {eng._graphs.captures}")
    steps = (dict(mixed_steps=m.prefill_calls,
                  decode_only_steps=m.dispatches - m.prefill_calls)
             if cfg.unified else dict(decode_steps=m.decode_steps,
                                      prefill_calls=m.prefill_calls))
    line = dict(model=spec.name, layout=cfg.cache_layout,
                unified=cfg.unified, kv_quant=model.kv_quant, steps=m.steps,
                **steps, dispatches=m.dispatches,
                wall_ms=wall * 1e3, device_busy_ms=busy,
                device_busy_share=busy / (wall * 1e3),
                kernel_launches=launches, graph_launches=graph_launches,
                device_ms_by_class=dict(sorted(by_class.items(),
                                               key=lambda kv: -kv[1])),
                device_ms_per_step_by_class={c: ms / m.steps
                                             for c, ms in by_class.items()})
    emit("serve_profile", **line)
    return line


def _prefill_alone(torch, model, tokens, packed=True):
    """``tokens`` as one request's prompt, walked chunk by chunk on a fresh
    cache of the model's (int8 when ``model.kv_quant``): through the packed
    step on a one-request pool (``packed``), or through ``prefill_chunk``
    on a one-row dense cache (a stack with Mamba or RWKV layers, or a
    sliding window, has no packed step).  Returns the last chunk's logits
    and the cache."""
    from repro_torch.models.attention import PackedSegs
    chunk, ps = GEOMETRY["chunk_size"], GEOMETRY["page_size"]
    spec = model.spec
    stateful = "ssm" in spec.layer_kinds()
    if not packed or stateful or spec.attn.kind == "swa":
        cache = model.init_cache(1, GEOMETRY["max_seq"], layout="dense")
        for lo in range(0, len(tokens), chunk):
            toks = torch.tensor([tokens[lo:lo + chunk]], device=DEV)
            logits, cache = model.prefill_chunk(cache, toks)
        return logits, cache
    max_pages = GEOMETRY["max_seq"] // ps
    cache = model.init_cache(1, GEOMETRY["max_seq"], page_size=ps,
                             n_pages=max_pages + 1)
    cache.page_table.copy_(torch.arange(1, max_pages + 1, dtype=torch.int32,
                                        device=DEV)[None])
    logits = None
    for lo in range(0, len(tokens), chunk):
        w = min(chunk, len(tokens) - lo)
        segs = PackedSegs(
            q_start=torch.zeros(1, dtype=torch.int32, device=DEV),
            q_len=torch.tensor([w], dtype=torch.int32, device=DEV),
            kv_len=torch.tensor([lo + w], dtype=torch.int32, device=DEV),
            page_table=cache.page_table, max_q=chunk)
        toks = torch.tensor(tokens[lo:lo + w], device=DEV)
        pos = torch.arange(lo, lo + w, dtype=torch.int32, device=DEV)
        logits, cache = model.unified_step(cache, toks, pos, segs)
    return logits, cache


def _last_logits(torch, model, tokens):
    """Logits after ``tokens`` (see ``_prefill_alone``; plain attention
    where the caller selected it)."""
    return _prefill_alone(torch, model, tokens)[0][0].float()


def _code_flips(torch, model, prompts):
    """The first layer's K/V of each prompt's first chunk, projected inside
    the unified step's packed batch (T = max_slots + prefill_rows x chunk
    rows, the chunk at prefill row 0's offset) and inside the two-dispatch
    prefill's (prefill_rows, chunk) batch, then quantized: how many f32
    values differ in any bit between the two (the same products in GEMMs
    of other shapes), how many int8 codes differ, and by how much at most
    (a code flip moves a dequantized value by a whole scale step)."""
    from repro_torch.models.attention import _project_qkv, _quantize_kv
    g = GEOMETRY
    chunk, slots, rows = g["chunk_size"], g["max_slots"], g["prefill_rows"]
    mixer = model.layers[0].mixer
    d = dict(values=0, values_differing=0, codes_differing=0,
             max_code_diff=0)
    for tokens in prompts:
        x = model.embed[torch.tensor(tokens[:chunk], device=DEV)]
        w = x.shape[0]
        pos = torch.arange(w, device=DEV)
        packed = x.new_zeros((slots + rows * chunk, x.shape[1]))
        packed[slots:slots + w] = x
        ppos = torch.zeros(packed.shape[0], dtype=torch.long, device=DEV)
        ppos[slots:slots + w] = pos
        scratch = x.new_zeros((rows, w, x.shape[1]))
        scratch[0] = x
        _, ku, vu = _project_qkv(model.spec, mixer, packed, ppos)
        _, kt, vt = _project_qkv(model.spec, mixer, scratch,
                                 pos.expand(rows, w))
        for a, b in ((ku[slots:slots + w], kt[0]), (vu[slots:slots + w],
                                                     vt[0])):
            d["values"] += a.numel()
            d["values_differing"] += int((a != b).sum())
            diff = (_quantize_kv(a)[0].int()
                    - _quantize_kv(b)[0].int()).abs()
            d["codes_differing"] += int((diff > 0).sum())
            d["max_code_diff"] = max(d["max_code_diff"], int(diff.max()))
    return d


def _ties(torch, model, prompts, a, b, what, tie_gap=TIE_GAP):
    """Where outputs ``a`` and ``b`` part, the top-2 logit gap at the first
    differing token; raises unless every divergence is a genuine tie (a
    gap under ``tie_gap``)."""
    ties = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        j = next(k for k in range(min(len(x), len(y))) if x[k] != y[k])
        top2 = _last_logits(torch, model, prompts[i] + x[:j]).topk(2).values
        gap = float(top2[0] - top2[1])
        ties.append({"request": i, "position": j, "tokens": [x[j], y[j]],
                     "top2_gap": gap})
        if not gap < tie_gap:
            raise AssertionError(f"serve_parity {what}: request {i} "
                                 f"diverges at token {j} with top-2 gap "
                                 f"{gap}")
    return ties


def phase_serve_parity(torch, arch) -> None:
    """``arch``'s widths at 2 layers in float32, every engine mode that
    serves it on the replay engine through the kernels and through the
    plain versions, and on the eager engine through the kernels (an
    attention-free stack: the two two-dispatch layouts, its RWKV mixes and
    bonus drawn non-zero); then both two-dispatch layouts on 8 prompts of
    1,500-2,000 tokens, eager against replay, all 8 token-identical (the
    prefill-only steps run back to back, so a staged upload that a later
    host write overtook would show)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    spec = get_spec(arch).scaled(name=f"{arch}-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    modes = tuple(MODES)
    if spec.is_attention_free:
        draw_rwkv_mixes(torch, model, seed=1)
        modes = ("dense", "paged")
    outs = {}
    for mode in modes:
        for run, impl, graphs in (("kernel", "kernel", True),
                                  ("plain", "plain", True),
                                  ("eager", "kernel", False)):
            model.kernel_impl = impl
            reqs = make_requests(spec, 8, 16, seed=1)
            ServeEngine(model, EngineConfig(**GEOMETRY, **MODES[mode]),
                        device=DEV, graphs=graphs).serve(reqs)
            outs[mode, run] = [r.output for r in reqs]
            prompts = [r.prompt for r in reqs]
    model.kernel_impl = "plain"
    pairs = [((mode, "kernel"), (mode, other)) for mode in modes
             for other in ("plain", "eager")] + [
        ((modes[0], "kernel"), (mode, "kernel")) for mode in modes[1:]]
    comparisons = {}
    for a, b in pairs:
        what = f"{'/'.join(a)} vs {'/'.join(b)}"
        comparisons[what] = {
            "identical": sum(x == y for x, y in zip(outs[a], outs[b])),
            "ties": _ties(torch, model, prompts, outs[a], outs[b], what)}
    # long prompts: every two-dispatch engine runs prefill-only steps back
    # to back (no device->host copy between their staged uploads)
    model.kernel_impl = "kernel"
    long_reqs = {}
    for mode in ("dense", "paged"):
        for graphs in (False, True):
            long_reqs[mode, graphs] = reqs = long_requests(spec, 8, 8, seed=4)
            ServeEngine(model, EngineConfig(**GEOMETRY, **MODES[mode]),
                        device=DEV, graphs=graphs).serve(reqs)
    model.kernel_impl = "plain"
    for mode in ("dense", "paged"):
        eager, replay = long_reqs[mode, False], long_reqs[mode, True]
        what = f"{mode} long prompts eager vs replay"
        identical = sum(a.output == b.output for a, b in zip(eager, replay))
        comparisons[what] = {
            "identical": identical,
            "prompt_tokens": [len(r.prompt) for r in eager],
            "ties": _ties(torch, model, [r.prompt for r in eager],
                          [r.output for r in eager],
                          [r.output for r in replay], what)}
        if identical != len(eager):
            raise AssertionError(f"serve_parity {what}: {identical} of "
                                 f"{len(eager)} identical")
    emit("serve_parity", model=spec.name, dtype="float32",
         requests=len(prompts),
         tokens=sum(len(o) for o in outs[modes[0], "kernel"]),
         comparisons=comparisons)
    del model
    free(torch)


def phase_kvq_parity(torch, arch, modes=tuple(MODES)) -> None:
    """The int8 KV cache at ``arch``'s widths, 2 layers, float32, on the
    eager engine (serve_kvq and debug_guards hold the quantized replay
    engines): each of ``modes`` through the kernels and with the plain
    versions selected explicitly, and the paged two-dispatch layout against
    the dense one (the same GEMM shapes write the same codes); greedy
    outputs token-identical, or parting only at a genuine tie (top-2 logit
    gap under TIE_GAP, of the quantized model).  The unified step against
    each two-dispatch layout is recorded, not required: its K/V come from
    GEMMs of other shapes, whose f32 results differ in their last bits, and
    the int8 rounding turns such a difference into a whole code step
    wherever a value sits near a rounding boundary; the line gives those
    comparisons beside the code flips between the two paths' caches for
    the same prompts."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    spec = get_spec(arch).scaled(name=f"{arch}-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1,
                        kv_quant=True)
    outs = {}
    for mode in modes:
        for impl in ("kernel", "plain"):
            model.kernel_impl = impl
            reqs = make_requests(spec, 8, 16, seed=5)
            ServeEngine(model, EngineConfig(**GEOMETRY, **MODES[mode]),
                        device=DEV, graphs=False).serve(reqs)
            outs[mode, impl] = [r.output for r in reqs]
            prompts = [r.prompt for r in reqs]
    model.kernel_impl = "plain"
    required = [((mode, "kernel"), (mode, "plain")) for mode in modes]
    if {"paged", "dense"} <= set(modes):
        required.append((("paged", "kernel"), ("dense", "kernel")))
    comparisons, recorded = {}, {}
    for a, b in required:
        what = f"kvq {'/'.join(a)} vs {'/'.join(b)}"
        comparisons[what] = {
            "identical": sum(x == y for x, y in zip(outs[a], outs[b])),
            "ties": _ties(torch, model, prompts, outs[a], outs[b], what)}
    if "unified" in modes:
        for mode in modes[1:]:
            a, b = outs["unified", "kernel"], outs[mode, "kernel"]
            recorded[f"kvq unified/kernel vs {mode}/kernel"] = {
                "identical": sum(x == y for x, y in zip(a, b)),
                "diverged": _divergences(torch, model,
                                         _as_requests(prompts, a),
                                         _as_requests(prompts, b))}
        recorded["layer0_unified_vs_two_dispatch"] = _code_flips(
            torch, model, prompts)
    emit("kvq_parity", model=spec.name, dtype="float32", kv_quant=True,
         requests=len(prompts), comparisons=comparisons, recorded=recorded)
    del model
    free(torch)


def _serve_prefix_engine(torch, model, reqs, **cfg):
    """Serve ``reqs`` (submitted together) on a fresh unified replay engine
    with ``cfg`` over GEOMETRY; returns the engine."""
    from repro_torch.serving import EngineConfig, ServeEngine
    eng = ServeEngine(model, EngineConfig(**{**GEOMETRY, **MODES["unified"],
                                             **cfg}), device=DEV)
    eng.serve(reqs)
    if any(r.state != "done" for r in reqs):
        raise AssertionError(f"prefix parity {cfg}: a request not done")
    return eng


def _prefix_requests(spec, seed):
    """Page-aligned multi-tenant requests: two tenants, each a 256-token
    template (16 pages) plus a fresh suffix of 20-100 tokens, alternating,
    then each template alone (a full hit: its tail page forks)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(1, spec.vocab, size=256).tolist() for _ in range(2)]
    prompts = [tmpl[i % 2] + rng.integers(
        1, spec.vocab, size=int(rng.integers(20, 101))).tolist()
        for i in range(8)] + tmpl
    return [Request(prompt=list(p), max_new_tokens=16, tenant=f"t{i % 2}")
            for i, p in enumerate(prompts)]


def phase_prefix_parity(torch) -> None:
    """The prefix cache at minitron-8b's widths, 2 layers, float32, on the
    replay engine, exactly (only genuine ties, TIE_GAP, allowed): cache on
    against cache off through the kernels and through the plain versions;
    a full hit's forked tail page against its shared original poisoned with
    1e9 in every layer after the fork; a pool too small to cache every
    prompt (evictions) against the cache-off engine; and the cache-on serve
    under debug_guards against the unguarded one."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import Request

    spec = get_spec("minitron-8b").scaled(name="minitron-8b-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    prompts = [r.prompt for r in _prefix_requests(spec, seed=4)]
    outs, runs = {}, {}
    for impl in ("kernel", "plain"):
        model.kernel_impl = impl
        for on in (False, True):
            reqs = _prefix_requests(spec, seed=4)
            m = _serve_prefix_engine(torch, model, reqs,
                                     prefix_cache=on).metrics
            outs[impl, on] = [r.output for r in reqs]
            runs[f"{impl}/{'on' if on else 'off'}"] = dict(
                prefill_tokens=m.prefill_tokens, hits=m.prefix_hits,
                cached_tokens=m.prefix_cached_tokens,
                cow_forks=m.prefix_cow_forks, dispatches=m.dispatches,
                steps=m.steps)
            if on and not (m.prefix_hits > 0 and m.prefix_cow_forks == 2
                           and m.dispatches == m.steps + 2):
                raise AssertionError(f"prefix parity {impl}: {runs}")
    model.kernel_impl = "kernel"
    pairs = [(f"{a[0]}/{'on' if a[1] else 'off'} vs "
              f"{b[0]}/{'on' if b[1] else 'off'}", prompts, outs[a], outs[b])
             for a, b in ((("kernel", True), ("kernel", False)),
                          (("kernel", True), ("plain", True)),
                          (("plain", True), ("plain", False)))]

    # copy-on-write: the shared tail page poisoned after the fork
    prompt = prompts[-1]  # a 16-page template alone
    r1 = Request(prompt=list(prompt), max_new_tokens=16)
    eng = _serve_prefix_engine(torch, model, [r1], prefix_cache=True)
    shared, n_cached = eng.prefix.lookup(prompt)
    r2 = Request(prompt=list(prompt), max_new_tokens=16)
    eng.submit(r2)
    eng.step()  # admission: the hit and the fork, then r2's one query
    if not (n_cached == len(prompt) and eng.metrics.prefix_cow_forks == 1
            and r2.n_cached == len(prompt) - 1
            and shared[-1] not in eng.pager.owned(r2.rid)):
        raise AssertionError(f"prefix parity: no fork ({n_cached} cached, "
                             f"{eng.metrics.prefix_cow_forks} forks)")
    for layer in eng.cache.layers:
        layer.k[shared[-1]] = 1e9
        layer.v[shared[-1]] = 1e9
    while r2.state != "done":
        eng.step()
    pairs.append(("poisoned tail fork vs first", [prompt], [r2.output],
                  [r1.output]))
    del eng

    # eviction under pressure: 48 pages of 16 cannot cache every prompt
    tight_reqs = _prefix_requests(spec, seed=5)[:8]
    tight = _serve_prefix_engine(torch, model, tight_reqs, prefix_cache=True,
                                 n_pages=1 + 48)
    tm = tight.metrics
    if tm.prefix_evicted_pages <= 0:
        raise AssertionError("prefix parity: no eviction under pressure")
    tight.pager.check()
    tight.prefix.check()
    del tight
    roomy = _prefix_requests(spec, seed=5)[:8]
    _serve_prefix_engine(torch, model, roomy, prefix_cache=False)
    pairs.append(("evicting on vs off", [r.prompt for r in roomy],
                  [r.output for r in tight_reqs], [r.output for r in roomy]))

    # debug_guards with the cache on: the same outputs, every audit passing
    reqs = _prefix_requests(spec, seed=4)
    guarded = _serve_prefix_engine(torch, model, reqs, prefix_cache=True,
                                   debug_guards=True)
    if [r.output for r in reqs] != outs["kernel", True]:
        raise AssertionError("prefix parity: guarded outputs differ")
    captures = guarded._graphs.captures
    del guarded

    model.kernel_impl = "plain"
    comparisons = {what: {"identical": sum(x == y for x, y in zip(a, b)),
                          "ties": _ties(torch, model, ps, a, b, what)}
                   for what, ps, a, b in pairs}
    emit("serve_parity", model=spec.name, dtype="float32",
         prefix_cache=True, requests=len(prompts), runs=runs,
         evicted_pages=tm.prefix_evicted_pages,
         preemptions_tight=tm.preemptions, guarded_identical=True,
         guarded_captures=captures, comparisons=comparisons)
    del model
    free(torch)


def _output_gaps(torch, model, prompt, output):
    """The top-2 logit gap at each position that chose a token of
    ``output``: one packed segment walked chunk by chunk on a fresh cache
    through ``verify_step``, which returns every position's logits."""
    from repro_torch.models.attention import PackedSegs
    chunk, ps = GEOMETRY["chunk_size"], GEOMETRY["page_size"]
    max_pages = GEOMETRY["max_seq"] // ps
    cache = model.init_cache(1, GEOMETRY["max_seq"], page_size=ps,
                             n_pages=max_pages + 1)
    ptab = torch.arange(1, max_pages + 1, dtype=torch.int32,
                        device=DEV)[None]
    tokens = list(prompt) + list(output[:-1])
    gaps = []
    for lo in range(0, len(tokens), chunk):
        w = min(chunk, len(tokens) - lo)
        packed = PackedSegs(
            q_start=torch.zeros(1, dtype=torch.int32, device=DEV),
            q_len=torch.tensor([w], dtype=torch.int32, device=DEV),
            kv_len=torch.tensor([lo + w], dtype=torch.int32, device=DEV),
            page_table=ptab, max_q=chunk)
        dec, _, cache = model.verify_step(
            cache, torch.tensor(tokens[lo:lo + w], device=DEV),
            torch.arange(lo, lo + w, dtype=torch.int32, device=DEV), packed,
            n_decode=1, width=w)
        top2 = dec[0].float().topk(2).values
        gaps.extend((top2[:, 0] - top2[:, 1]).tolist())
    return gaps[len(prompt) - 1:]


def _rejection_gaps(torch, model, prompts, outputs, rejected_at):
    """The target's top-2 logit gap at each output position where a
    rejected window committed the target's own token (``rejected_at``:
    per request, those output indices, as ``record_rejections`` gives
    them)."""
    out = []
    for i, at in enumerate(rejected_at):
        if at:
            gaps = _output_gaps(torch, model, prompts[i], outputs[i])
            out += [{"request": i, "position": j, "top2_gap": gaps[j]}
                    for j in at]
    return out


def _self_draft_ties(torch, model, m, prompts, outputs, what):
    """A self-draft rejects a window only where the draft's rounding and
    the target's part at a near-tie, and each rejected window commits the
    target's token at its own such position: with rejected windows, the
    outputs must hold at least as many positions whose top-2 gap is under
    TIE_GAP.  Returns the rejected windows and those positions."""
    rejected = m.spec_slot_rounds - m.spec_bonus
    if not rejected:
        return {"rejected_windows": 0, "ties": []}
    ties = [{"request": i, "position": j, "top2_gap": g}
            for i, (p, o) in enumerate(zip(prompts, outputs))
            for j, g in enumerate(_output_gaps(torch, model, p, o))
            if g < TIE_GAP]
    if len(ties) < rejected:
        raise AssertionError(f"spec parity {what}: {rejected} self-draft "
                             f"windows rejected, {len(ties)} ties: {ties}")
    return {"rejected_windows": rejected, "ties": ties}


# the tight-pool case: 8 requests of 64-192 prompt tokens and 48 new ones
# in a pool of 1 + 32 pages of 16 (512 tokens), where decodes outgrow the
# pages their admissions reserved: the engines must preempt
SPEC_TIGHT_PAGES = 32


def _tight_requests(spec):
    """The tight-pool case's 8 requests (see SPEC_TIGHT_PAGES)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(6)
    return [Request(prompt=rng.integers(0, spec.vocab, size=int(
        rng.integers(64, 193))).tolist(), max_new_tokens=48)
        for _ in range(8)]


def phase_spec_parity(torch, arch) -> None:
    """Speculative decoding at ``arch``'s widths, 2 layers, float32, K =
    SPEC_K, on the unified replay engine, exactly (only genuine ties,
    TIE_GAP, allowed): spec on with a self-draft and with a perturbed draft
    against spec off, through the kernels and through the plain versions;
    the self-draft accepts every draft, any rejection sitting at a tie; the
    perturbed draft's acceptance strictly between 0 and 1; a pool tight
    enough to preempt against spec off; the prefix cache's full-hit fork
    with the shared original set to 1e9 in both pools after the fork,
    against cache off; the batch-1 SpeculativeDecoder at temperature 0
    (flash on its dense caches) against the engine's greedy outputs; and the
    self-draft engine under debug_guards against the unguarded one."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import (EngineConfig, Request, ServeEngine,
                                     SpeculativeDecoder)

    spec = get_spec(arch).scaled(name=f"{arch}-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    draft = perturbed_draft(torch, model)
    drafts = {"off": None, "self": model, "perturbed": draft}
    k = SPEC_K

    def serve(reqs, name, **cfg):
        d = drafts[name]
        eng = ServeEngine(model, EngineConfig(**{
            **GEOMETRY, **MODES["unified"], "n_spec": k if d else 0, **cfg}),
            device=DEV, draft_model=d)
        eng.serve(reqs)
        m = eng.metrics
        if any(r.state != "done" for r in reqs) or not (
                m.transfers_d2h == m.steps
                and m.dispatches == m.steps + m.prefix_cow_forks):
            raise AssertionError(f"spec parity {arch} {name} {cfg}: "
                                 f"{[r.state for r in reqs]}, {m.steps} "
                                 f"steps, {m.dispatches} dispatches")
        return eng

    def stats(m):
        return dict(steps=m.steps, mixed_steps=m.prefill_calls,
                    preemptions=m.preemptions, spec_rounds=m.spec_rounds,
                    spec_slot_rounds=m.spec_slot_rounds,
                    acceptance=m.spec_acceptance_rate,
                    tokens_per_round=m.spec_tokens_per_round,
                    spec_bonus=m.spec_bonus, cow_forks=m.prefix_cow_forks)

    prompts = [r.prompt for r in make_requests(spec, 8, 16, seed=1)]
    outs, runs, metrics = {}, {}, {}
    for impl in ("kernel", "plain"):
        model.kernel_impl = draft.kernel_impl = impl
        for name in drafts:
            reqs = make_requests(spec, 8, 16, seed=1)
            metrics[impl, name] = m = serve(reqs, name).metrics
            outs[impl, name] = [r.output for r in reqs]
            runs[f"{impl}/{name}"] = stats(m)
        if not 0.0 < metrics[impl, "perturbed"].spec_acceptance_rate < 1.0:
            raise AssertionError(f"spec parity {arch} {impl}: perturbed "
                                 f"draft {runs[f'{impl}/perturbed']}")
    model.kernel_impl = draft.kernel_impl = "kernel"
    pairs = [(f"{impl}/{name} vs {impl}/off", prompts, outs[impl, name],
              outs[impl, "off"])
             for impl in ("kernel", "plain") for name in ("self", "perturbed")]
    pairs.append(("kernel/perturbed vs plain/perturbed", prompts,
                  outs["kernel", "perturbed"], outs["plain", "perturbed"]))

    # a pool too small for every request: preemption and recompute,
    # against spec off in the default pool
    roomy = _tight_requests(spec)
    serve(roomy, "off")
    for name in ("self", "perturbed"):
        reqs = _tight_requests(spec)
        m = serve(reqs, name, n_pages=1 + SPEC_TIGHT_PAGES).metrics
        runs[f"tight/{name}"] = stats(m)
        if m.preemptions <= 0:
            raise AssertionError(f"spec parity {arch}: no preemption in a "
                                 f"{SPEC_TIGHT_PAGES}-page pool")
        pairs.append((f"tight/{name} vs roomy off",
                      [r.prompt for r in roomy], [r.output for r in reqs],
                      [r.output for r in roomy]))

    # the prefix cache: a full hit forks its tail page in both pools; the
    # shared original is then poisoned in both
    tmpl = _prefix_requests(spec, seed=4)[-1].prompt  # 16 pages
    r1 = Request(prompt=list(tmpl), max_new_tokens=16)
    eng = serve([r1], "self", prefix_cache=True)
    shared, n_cached = eng.prefix.lookup(tmpl)
    r2 = Request(prompt=list(tmpl), max_new_tokens=16)
    eng.submit(r2)
    eng.step()  # admission: the hit and the fork, then r2's one query
    if not (n_cached == len(tmpl) and eng.metrics.prefix_cow_forks == 1
            and shared[-1] not in eng.pager.owned(r2.rid)):
        raise AssertionError(f"spec parity {arch}: no fork ({n_cached} "
                             f"cached, {eng.metrics.prefix_cow_forks} forks)")
    for cache in (eng.cache, eng.speculator.d_cache):
        for layer in cache.layers:
            layer.k[shared[-1]] = 1e9
            layer.v[shared[-1]] = 1e9
    while r2.state != "done":
        eng.step()
    fork_m = eng.metrics
    runs["prefix_fork/self"] = stats(fork_m)
    del eng
    off_req = Request(prompt=list(tmpl), max_new_tokens=16)
    serve([off_req], "off")
    pairs += [("poisoned fork vs cache off", [tmpl], [r2.output],
               [off_req.output]),
              ("first vs cache off", [tmpl], [r1.output], [off_req.output])]

    # the batch-1 oracle with the perturbed draft, greedy
    decoded, decoder_stats = [], []
    for p in prompts[:2]:
        sd = SpeculativeDecoder(model, draft, n_spec=k,
                                max_seq=GEOMETRY["max_seq"], temperature=0.0)
        decoded.append(sd.generate(p, 16))
        decoder_stats.append(dict(vars(sd.stats),
                                  acceptance=sd.stats.acceptance_rate))

    # debug_guards: the sync-debug mode "error" for the whole round
    reqs = make_requests(spec, 8, 16, seed=1)
    guarded = serve(reqs, "self", debug_guards=True)
    if [r.output for r in reqs] != outs["kernel", "self"]:
        raise AssertionError(f"spec parity {arch}: guarded outputs differ")
    captures = guarded._graphs.captures
    if captures != {"spec/mixed": 1, "spec/decode": 1}:
        raise AssertionError(f"spec parity {arch}: captures {captures}")
    del guarded

    model.kernel_impl = "plain"
    self_ties = {impl: _self_draft_ties(torch, model, metrics[impl, "self"],
                                        prompts, outs[impl, "self"],
                                        f"{arch} {impl}")
                 for impl in ("kernel", "plain")}
    self_ties["prefix_fork"] = _self_draft_ties(
        torch, model, fork_m, [tmpl] * 2, [r1.output, r2.output],
        f"{arch} prefix fork")
    comparisons = {what: {"identical": sum(x == y for x, y in zip(a, b)),
                          "ties": _ties(torch, model, ps, a, b, what)}
                   for what, ps, a, b in pairs}
    decoder_ties = _ties(torch, model, prompts[:2], decoded,
                         outs["kernel", "off"][:2],
                         "batch-1 decoder vs kernel/off", DECODER_TIE_GAP)
    emit("spec_parity", model=spec.name, dtype="float32", n_spec=k,
         requests=len(prompts), runs=runs, self_draft=self_ties,
         decoder=decoder_stats, decoder_identical=sum(
             x == y for x, y in zip(decoded, outs["kernel", "off"])),
         decoder_ties=decoder_ties, guarded_identical=True,
         guarded_captures=captures, comparisons=comparisons)
    del model, draft
    free(torch)


def phase_disagg_parity(torch) -> None:
    """The disaggregated cluster at minitron-8b's widths, 2 layers,
    float32, every cluster with ``debug_guards`` (the engines' steps and the
    channel's pump under the sync-debug mode "error") on the replay
    engines, exactly (only genuine ties, TIE_GAP, allowed): with the decode
    pool unified and two-dispatch, the cluster through the kernels against
    the cluster through the plain versions and against the unified engine;
    a 32-page decode pool that preempts while migrations are in flight
    against the unified engine in its default pool, for both decode pools;
    the source pages set to 1e3 in every layer as each migration lands,
    against the unpoisoned cluster (identical: the same kernels on the same
    inputs); and with the int8 KV cache, the cluster through the kernels
    against the plain versions (required) and against the quantized
    unified engine (recorded: the pools' packed steps have other GEMM
    shapes, whose f32 differences int8 rounding can amplify, as kvq_parity
    found).  Every cluster leaves both pools empty and their allocators
    audited."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import (DisaggCluster, DisaggClusterConfig,
                                     EngineConfig, ServeEngine)

    spec = get_spec("minitron-8b").scaled(name="minitron-8b-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)

    def cluster(reqs, du, probe=None, **cfg):
        cl = DisaggCluster(model, DisaggClusterConfig(
            **DISAGG, decode_unified=du, debug_guards=True, **cfg),
            device=DEV)
        if probe is not None:
            probe(cl)
        cl.serve(reqs)
        pre, dec = cl.prefill_eng, cl.decode_eng
        for eng in (pre, dec):
            eng.pager.check()
        if (any(r.state != "done" for r in reqs) or pre.pager.pages_in_use
                or dec.pager.pages_in_use
                or cl.metrics.migrations_inflight_peak < 1
                or cl.channel.migrations != len(reqs)):
            raise AssertionError(f"disagg parity du={du} {cfg}: "
                                 f"{[r.state for r in reqs]}, "
                                 f"{cl.channel.stats()}")
        return cl

    def engine(reqs):
        ServeEngine(model, EngineConfig(**GEOMETRY, **MODES["unified"]),
                    device=DEV).serve(reqs)

    def stats(cl):
        return dict(steps=cl.metrics.steps,
                    migrations=cl.channel.migrations,
                    migrated_pages=cl.channel.migrated_pages,
                    inflight_peak=cl.metrics.migrations_inflight_peak,
                    decode_preemptions=cl.decode_eng.metrics.preemptions,
                    decode_prefill_calls=cl.decode_eng.metrics.prefill_calls,
                    captures={"prefill": cl.prefill_eng._graphs.captures,
                              "decode": cl.decode_eng._graphs.captures,
                              "cluster": cl._graphs.captures})

    prompts = [r.prompt for r in make_requests(spec, 8, 16, seed=1)]
    outs, runs, pairs = {}, {}, []
    for impl in ("kernel", "plain"):
        model.kernel_impl = impl
        for du in (True, False):
            reqs = make_requests(spec, 8, 16, seed=1)
            runs[f"{impl}/du={du}"] = stats(cluster(reqs, du))
            outs[impl, du] = [r.output for r in reqs]
        reqs = make_requests(spec, 8, 16, seed=1)
        engine(reqs)
        outs[impl, "engine"] = [r.output for r in reqs]
    model.kernel_impl = "kernel"
    for du in (True, False):
        pairs += [(f"kernel/du={du} vs plain/du={du}", prompts,
                   outs["kernel", du], outs["plain", du]),
                  (f"kernel/du={du} vs unified engine", prompts,
                   outs["kernel", du], outs["kernel", "engine"])]

    # a decode pool too small for every request: preemption (and, on the
    # two-dispatch pool, its flash recompute) while migrations queue
    roomy = _tight_requests(spec)
    engine(roomy)
    for du in (True, False):
        reqs = _tight_requests(spec)
        cl = cluster(reqs, du, decode_pages=1 + SPEC_TIGHT_PAGES)
        runs[f"tight/du={du}"] = stats(cl)
        if cl.decode_eng.metrics.preemptions <= 0:
            raise AssertionError(f"disagg parity du={du}: no preemption in "
                                 f"a {SPEC_TIGHT_PAGES}-page decode pool")
        pairs.append((f"tight/du={du} vs unified engine",
                      [r.prompt for r in roomy], [r.output for r in reqs],
                      [r.output for r in roomy]))
        del cl

    # the poisoned-source-page probe
    poisoned = []

    def probe(cl):
        install = cl._install

        def install_and_poison(mig):
            install(mig)
            for layer in cl.prefill_eng.cache.layers:
                for t in (layer.k, layer.v):
                    for page in mig.src_pages:
                        t[page].fill_(1e3)
            poisoned.append(mig.req.rid)
        cl._install = install_and_poison

    reqs = make_requests(spec, 8, 16, seed=1)
    runs["poisoned"] = stats(cluster(reqs, True, probe))
    if len(poisoned) != len(reqs) or \
            [r.output for r in reqs] != outs["kernel", True]:
        raise AssertionError(f"disagg parity: poisoned source pages moved "
                             f"the outputs ({len(poisoned)} poisoned)")

    # the int8 KV cache: codes and scales migrate together
    model.kv_quant = True
    try:
        for impl in ("kernel", "plain"):
            model.kernel_impl = impl
            reqs = make_requests(spec, 8, 16, seed=1)
            runs[f"kv_quant/{impl}"] = stats(cluster(reqs, True))
            outs["kvq", impl] = [r.output for r in reqs]
        reqs = make_requests(spec, 8, 16, seed=1)
        engine(reqs)
        outs["kvq", "engine"] = [r.output for r in reqs]
        model.kernel_impl = "plain"
        kvq_vs_engine = _divergences(
            torch, model, _as_requests(prompts, outs["kvq", "kernel"]),
            _as_requests(prompts, outs["kvq", "engine"]))
        comparisons = {"kv_quant kernel vs plain": {
            "identical": sum(x == y for x, y in zip(outs["kvq", "kernel"],
                                                    outs["kvq", "plain"])),
            "ties": _ties(torch, model, prompts, outs["kvq", "kernel"],
                          outs["kvq", "plain"], "disagg kv_quant")}}
    finally:
        model.kv_quant = False
    model.kernel_impl = "plain"
    comparisons.update({what: {"identical": sum(x == y for x, y in zip(a, b)),
                               "ties": _ties(torch, model, ps, a, b, what)}
                        for what, ps, a, b in pairs})
    emit("disagg_parity", model=spec.name, dtype="float32",
         requests=len(prompts), runs=runs, poisoned_identical=True,
         comparisons=comparisons,
         kv_quant_vs_engine={"identical": len(prompts) - len(kvq_vs_engine),
                             "diverged": kvq_vs_engine})
    del model
    free(torch)


def phase_beam_parity(torch) -> None:
    """Beam search at minitron-8b's widths, 2 layers, float32, beam
    BEAM_SIZE on the dense cache: through the kernels (flash) against the
    plain versions, with no eos and with an eos id the kernel run's search
    emits second (hypotheses exit at the first decode step): the same
    tokens, the scores within 1e-4."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import BeamSearcher

    spec = get_spec("minitron-8b").scaled(name="minitron-8b-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    prompt = make_requests(spec, 1, BEAM_NEW, seed=5)[0].prompt
    results = {}
    eos = None
    for case in ("no_eos", "eos"):
        for impl in ("kernel", "plain"):
            model.kernel_impl = impl
            before = read_launches()["flash_attention"]
            results[case, impl] = BeamSearcher(
                model, beam_size=BEAM_SIZE,
                max_seq=GEOMETRY["max_seq"]).search(prompt, BEAM_NEW,
                                                    eos_id=eos)
            flash = read_launches()["flash_attention"] - before
            if (flash > 0) != (impl == "kernel"):
                raise AssertionError(f"beam parity {case} {impl}: "
                                     f"{flash} flash launches")
        eos = results["no_eos", "kernel"][0][1]
    model.kernel_impl = "kernel"
    line = {}
    for case in ("no_eos", "eos"):
        (a, sa), (b, sb) = results[case, "kernel"], results[case, "plain"]
        if a != b or not abs(sa - sb) <= 1e-4:
            raise AssertionError(f"beam parity {case}: kernel {a} {sa}, "
                                 f"plain {b} {sb}")
        line[case] = {"tokens": a, "score_kernel": sa, "score_plain": sb,
                      "score_diff": abs(sa - sb)}
    emit("beam_parity", model=spec.name, dtype="float32",
         beam_size=BEAM_SIZE, eos_id=eos, **line)
    del model
    free(torch)


def phase_debug_guards(torch) -> None:
    """``debug_guards`` on the card, at minitron-8b's widths and 2 layers in
    bf16, in the unified and the paged two-dispatch replay engines, each in
    full precision and with the int8 KV cache: a guarded serve is
    token-identical to an unguarded one, a ``.item()`` on a card tensor
    inside ``_step_guard()`` raises, and binding a profile again, or a key
    of no profile, raises "recapture"."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    spec = get_spec("minitron-8b").scaled(name="minitron-8b-2l",
                                          n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.bfloat16, seed=1)
    for mode, quant in itertools.product(("unified", "paged"),
                                         (False, True)):
        model.kv_quant = quant
        outs = {}
        for guards in (False, True):
            eng = ServeEngine(model, EngineConfig(
                **GEOMETRY, **MODES[mode], debug_guards=guards), device=DEV)
            reqs = make_requests(spec, 8, 16, seed=3)
            eng.serve(reqs)
            outs[guards] = [r.output for r in reqs]
        if outs[True] != outs[False]:
            raise AssertionError(f"debug_guards {mode} kv_quant={quant}: "
                                 "guarded outputs differ from unguarded "
                                 "ones")
        try:
            with eng._step_guard():
                eng.cache.lengths.sum().item()
        except RuntimeError as e:
            armed = str(e).splitlines()[0]
        else:
            raise AssertionError(f"debug_guards {mode}: .item() inside the "
                                 "step guard did not raise")
        recapture = []
        for key in (sorted(eng._graphs.profiles)[0], "decode/foreign"):
            try:
                eng._graphs.capture(key)
            except AssertionError as e:
                if "recapture" not in str(e):
                    raise
                recapture.append(key)
        if len(recapture) != 2:
            raise AssertionError(f"debug_guards {mode}: binding again did "
                                 f"not raise for {recapture}")
        emit("debug_guards", model=spec.name, mode=mode, kv_quant=quant,
             requests=len(reqs), identical=True, steps=eng.steps,
             captures=eng._graphs.captures, item_raised=armed,
             recapture_raised=recapture)
        del eng
    del model
    free(torch)


# the scenario phase: GenZ's prediction against the card's measurement of
# one Scenario per mode, minitron-8b at its published width on hgx-h100x1
SCENARIO_KW = dict(max_slots=8, max_seq=2048, max_prompt=1024, max_new=32,
                   prefill_rows=2)
SCENARIO_CHUNK = 128  # ChunkedSpec.chunk: the engine's chunk in every mode


def scenarios(spec):
    """[(mode, Scenario, engine_kw of its lowering)]: Workload(batch=8,
    tau_p=1024, tau_d=32) on hgx-h100x1, ``spec`` inline.  Each mode but
    monolithic carries ChunkedSpec(128, 8), which the engine lowering
    reads as its chunk (the analytical backend reads it in chunked mode
    only); chunked lowers to the unified engine, the packed step that
    ``core.stages.chunked`` prices."""
    from repro_torch.core.stages import Workload
    from repro_torch.scenario import (ChunkedSpec, DisaggSpec, Scenario,
                                      SpeculativeSpec)
    base = Scenario.make(spec, workload=Workload(batch=8, tau_p=1024,
                                                 tau_d=32),
                         platform="hgx-h100x1")
    chunk = ChunkedSpec(chunk=SCENARIO_CHUNK, decode_batch=8)
    return [
        ("monolithic", base, {}),
        ("chunked", base.replace(mode="chunked", chunked=chunk),
         dict(unified=True)),
        ("speculative", base.replace(
            mode="speculative", chunked=chunk,
            speculative=SpeculativeSpec(draft=spec, n=SPEC_K)), {}),
        ("disaggregated", base.replace(
            mode="disaggregated", chunked=chunk,
            disaggregated=DisaggSpec(total_npus=2, colocated_tp=1,
                                     tp_options=(1,))), {}),
    ]


def _bound_once(what, captures, now=None):
    """Every profile bound exactly once (and, given ``now``, none bound
    since ``captures`` was read)."""
    if any(n != 1 for c in captures.values() for n in c.values()):
        raise AssertionError(f"{what}: a profile bound more than once: "
                             f"{captures}")
    if now is not None and now != captures:
        raise AssertionError(f"{what}: a profile was bound during the "
                             f"serve: {now}, warmed {captures}")


def warm_lowered(low) -> dict:
    """Warm what ``engine_backend.lower`` built, as ``warmed_engine`` and
    ``warmed_cluster`` do (requests of 2 new tokens: the lowered prompts
    for a two-dispatch engine, so that its chunk width is captured; one of
    39 tokens for a unified or spec engine; two for a cluster), then reset
    its counters; returns the captures."""
    from repro_torch.serving import EngineMetrics, Request
    runner = low.runner
    if low.kind == "cluster":
        runner.serve([Request(prompt=list(range(1, 40)), max_new_tokens=2)
                      for _ in range(2)])
        _fresh_cluster_counters(runner)
        return {"prefill": dict(runner.prefill_eng._graphs.captures),
                "decode": dict(runner.decode_eng._graphs.captures),
                "cluster": dict(runner._graphs.captures)}
    prompts = [r.prompt for r in low.requests] if not runner.unified \
        else [list(range(1, 40))]
    runner.serve([Request(prompt=list(p), max_new_tokens=2)
                  for p in prompts])
    runner.metrics = EngineMetrics()
    if runner._graphs.captures != dict.fromkeys(runner._graphs.profiles, 1):
        raise AssertionError(f"scenario {low.scenario.mode}: profiles bound "
                             f"{runner._graphs.captures}")
    return {"engine": dict(runner._graphs.captures)}


def scenario_launches(mode, spec, low) -> dict:
    """The launches ``mode``'s lowering must make (PERF.md §2): flash
    n_layers x (prefill calls + decode steps) in the dense two-dispatch
    engine (monolithic); ragged n_layers x (2 x mixed + decode-only) in the
    unified one (chunked), L_t (2 m + d) + L_d ((K+1) m + K d) with
    speculation, and over both engines of the cluster (its decode pool
    unified)."""
    n = spec.n_layers
    if low.kind == "cluster":
        want = 0
        for eng in (low.runner.prefill_eng, low.runner.decode_eng):
            m = eng.metrics
            want += n * (2 * m.prefill_calls + m.dispatches
                         - m.prefill_calls)
        if not low.runner.cfg.decode_unified:
            raise AssertionError("scenario: the decode pool is not unified")
        return {"ragged_paged_attention": want}
    m = low.runner.metrics
    if not low.runner.unified:
        return {"flash_attention": n * (m.prefill_calls + m.decode_steps)}
    if not m.dispatches == m.transfers_d2h == m.steps:
        raise AssertionError(f"scenario {mode}: {m.dispatches} dispatches, "
                             f"{m.transfers_d2h} transfers, {m.steps} steps")
    mixed, d = m.prefill_calls, m.dispatches - m.prefill_calls
    k = low.runner.cfg.n_spec
    want = n * (2 * mixed + d)
    if k:
        want += n * ((k + 1) * mixed + k * d)
    return {"ragged_paged_attention": want}


def _scenario_line(torch, mode, ana, rep, low, spans, host, steps):
    """The measured side of one scenario line."""
    from repro_torch.scenario import compare
    if low.kind == "cluster":
        runs, ms, per_step = {}, {}, 0.0
        for name, sp in spans.items():
            r, m, _ = span_stats(sp, steps)
            runs[name], ms[name] = r, m
            per_step += sum(a.elapsed_time(b) for _, a, b in sp) / steps
        engine = {key: rep.extra["engine"][key] for key in (
            "steps", "migrations", "migrated_pages", "migrated_bytes",
            "requests_done", "generated_tokens")}
        engine["prefill"] = {key: rep.extra["engine"]["prefill"][key]
                             for key in ("steps", "dispatches",
                                         "prefill_calls", "exports")}
        engine["decode"] = {key: rep.extra["engine"]["decode"][key]
                            for key in ("steps", "dispatches",
                                        "decode_steps", "imports",
                                        "peak_active", "preemptions")}
    else:
        runs, ms, per_step = span_stats(spans["engine"], steps)
        engine = {key: rep.extra["engine"].get(key) for key in (
            "steps", "decode_steps", "prefill_calls", "dispatches",
            "transfers_d2h", "generated_tokens", "peak_active",
            "preemptions", "requests_done", "spec_rounds",
            "spec_acceptance_rate", "spec_tokens_per_round")}
    return dict(
        mode=mode, model=low.spec.name, platform="hgx-h100x1",
        predicted=ana.metrics(), measured=rep.metrics(),
        errors=compare(ana, rep), engine_config=rep.extra["engine_config"],
        lowering=rep.extra["lowering"], engine=engine,
        host_ms_per_step=statistics.mean(host),
        device_ms_per_step=per_step, runs_by_class=runs,
        device_ms_by_class=ms,
        predicted_detail={k: v for k, v in ana.extra.items()
                          if k in ("plan", "kv_transfer_s", "goodput_rps",
                                   "chunked_two_dispatch")},
        measured_kv_transfer_s=rep.extra.get("measured_kv_transfer_s"),
        acceptance_rate=rep.extra.get("acceptance_rate"),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _serve_scenario(torch, mode, sc, kw) -> dict:
    """One scenario: the analytical Report (no pool: CUDA is up), then the
    lowered engine or cluster warmed, its serve measured with every count
    set to 0 just before and read just after, its Report held ok and
    unclamped, the launches exact, each profile bound once and none during
    the serve; the line; returns the launch counts."""
    from repro_torch.scenario import engine_backend as eb
    from repro_torch.scenario import run
    ana, = run([sc], max_workers=1)
    if not ana.ok:
        raise AssertionError(f"scenario {mode}: analytical {ana.status}: "
                             f"{ana.error}")
    t0 = time.perf_counter()
    low = eb.lower(sc, **kw)
    lower_s = time.perf_counter() - t0
    captures = warm_lowered(low)
    if low.kind == "cluster":
        cl = low.runner
        _, pre_spans = time_steps(torch, cl.prefill_eng)
        _, dec_spans = time_steps(torch, cl.decode_eng)
        host, mig_spans = time_steps(torch, cl)
        spans = {"prefill": pre_spans, "decode": dec_spans,
                 "migrate": mig_spans}
    else:
        host, spans = time_steps(torch, low.runner)
        spans = {"engine": spans}
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eb.serve(low)
    torch.cuda.synchronize()
    counts, routes = read_launches(), read_routes()
    rep = eb.report(low)
    what = f"scenario {mode}"
    if not rep.ok:
        raise AssertionError(f"{what}: engine {rep.status}: {rep.error}")
    if rep.extra["lowering"]["clamped"]:
        raise AssertionError(f"{what}: the workload was clamped: "
                             f"{rep.extra['lowering']}")
    if low.kind == "cluster":
        now = {"prefill": dict(low.runner.prefill_eng._graphs.captures),
               "decode": dict(low.runner.decode_eng._graphs.captures),
               "cluster": dict(low.runner._graphs.captures)}
    else:
        now = {"engine": dict(low.runner._graphs.captures)}
    _bound_once(what, captures, now)
    for r in low.requests:
        if r.state != "done" or len(r.output) != SCENARIO_KW["max_new"] \
                or any(not 0 <= t < low.spec.vocab for t in r.output):
            raise AssertionError(f"{what}: request {r.rid} {r.state}, "
                                 f"{len(r.output)} tokens")
    want = scenario_launches(mode, low.spec, low)
    _expect(what, counts, want)
    for kernel, k in want.items():
        _expect_tensor_cores(what, routes, kernel, k)
    line = _scenario_line(torch, mode, ana, rep, low, spans, host,
                          low.runner.metrics.steps)
    emit("scenario", **line, lower_s=lower_s, captures=captures,
         launches=counts, routes=routes)
    return counts


def phase_scenario(torch) -> list[dict]:
    """GenZ against the card: minitron-8b given inline (full width, bf16,
    random weights from seed 0) in one Scenario per mode on hgx-h100x1,
    priced by the analytical backend and measured through
    ``engine_backend.lower`` -> warm -> ``serve`` -> Report (see
    ``_serve_scenario``); then one cold ``evaluate()`` of monolithic, as
    the reference measures it (its captures inside its TTFT).  Fails on a
    Report that is not ok, a clamp, a profile bound twice or a launch count
    off its formula; ``compare()``'s errors are recorded, not held.
    Returns each measured run's launch counts."""
    from repro_torch.configs import get_spec
    from repro_torch.scenario import compare, run
    from repro_torch.scenario import engine_backend as eb
    t_phase = time.perf_counter()
    spec = get_spec("minitron-8b")
    kw = dict(SCENARIO_KW, device=DEV, dtype=torch.bfloat16)
    launches = []
    cases = scenarios(spec)
    for mode, sc, extra in cases:
        launches.append(_serve_scenario(torch, mode, sc, dict(kw, **extra)))
        free(torch)
    mode, sc, extra = cases[0]
    ana, = run([sc], max_workers=1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cold = eb.evaluate(sc, **kw, **extra)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    if not cold.ok:
        raise AssertionError(f"scenario cold: {cold.status}: {cold.error}")
    m = cold.extra["engine"]
    _expect("scenario cold", counts, {"flash_attention": spec.n_layers * (
        m["prefill_calls"] + m["decode_steps"])})
    emit("scenario_cold", mode=mode, predicted=ana.metrics(),
         measured=cold.metrics(), errors=compare(ana, cold),
         engine_config=cold.extra["engine_config"],
         engine={k: m[k] for k in ("steps", "prefill_calls", "decode_steps",
                                   "dispatches", "generated_tokens")},
         evaluate_s=seconds, launches=counts)
    launches.append(counts)
    free(torch)
    emit("scenario_phase", seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# the rest of the registry
# ---------------------------------------------------------------------------

#: jamba-v0.1-52b's depth on the card: one 8-layer period (7 Mamba layers
#: and attention at offset 4; MoE on layers 1, 3, 5 and 7): 13.3 B
#: parameters, 26.7 GB in bf16.  The published 32 layers are 103 GB and do
#: not fit one 80 GB card.
JAMBA_LAYERS = 8
#: rows x frames of the encoder pass (hubert-xlarge) and of the frontend
#: prefill (pixtral-12b)
ENCODER_ROWS, ENCODER_FRAMES = 4, 1024


def scan_ms(torch, spec, rows, steps):
    """Median device ms of one Mamba scan (``ops.mamba_scan``, the
    reference's arithmetic in PyTorch) at ``spec``'s inner width, over
    ``rows`` x ``steps`` inputs in bf16 (f32 decays and state), replayed
    from a CUDA graph as the engine's prefill and decode replays run it
    (eager, its per-step launches would wait on the host)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEV).manual_seed(steps)
    di, n = spec.ssm.d_inner(spec.d_model), spec.ssm.d_state
    x = torch.randn((rows, steps, di), generator=gen,
                    device=DEV).bfloat16()
    dt = torch.rand((rows, steps, di), generator=gen, device=DEV) * 0.1
    a = -torch.rand((di, n), generator=gen, device=DEV) - 0.5
    b = torch.randn((rows, steps, n), generator=gen, device=DEV).bfloat16()
    c = torch.randn((rows, steps, n), generator=gen, device=DEV).bfloat16()
    d = torch.ones((di,), device=DEV)
    state = torch.zeros((rows, di, n), device=DEV)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        ops.mamba_scan(x, dt, a, b, c, d, state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ops.mamba_scan(x, dt, a, b, c, d, state)
    return median_ms(torch, graph.replay, TIMED_LAUNCHES)


def phase_serve_jamba(torch) -> list[dict]:
    """jamba-v0.1-52b at full width and one period of depth (JAMBA_LAYERS)
    through the dense and the paged two-dispatch engines, eager and
    replayed (the unified step refuses Mamba layers, as the reference's
    does).  Launches exact: flash once per attention layer per forward
    (dense) or per prefill call (paged, where the paged decode takes the
    decode steps), the expert GEMM 3 per MoE layer per forward, all on the
    tensor-core routes, every other kernel 0.  Then the dense replay
    engine's profile beside the Mamba scan's share: the scan timed alone
    at the serve's shapes, times its calls.  Returns each warm replay
    serve's launch counts."""
    from repro_torch.configs import get_spec
    from repro_torch.serving import EngineConfig
    spec, model, init_s = build_full(torch, "jamba-v0.1-52b",
                                     n_layers=JAMBA_LAYERS)
    kinds = [layer.cls.key for layer in model.layers]
    if kinds != ["mamba", "mamba_moe", "mamba", "mamba_moe", "attn",
                 "mamba_moe", "mamba", "mamba_moe"]:
        raise AssertionError(f"jamba: layers {kinds}")
    n_attn, n_mamba = spec.n_attn_layers(), spec.n_ssm_layers()
    n_gemm = expert_launches_per_forward(spec)

    def expect_for(mode):
        def expect(m, stats):
            fwd = m.prefill_calls + m.decode_steps
            want = {"expert_gemm": n_gemm * fwd,
                    "flash_attention": n_attn * (fwd if mode == "dense"
                                                 else m.prefill_calls)}
            if mode == "paged":
                want["paged_decode_attention"] = n_attn * m.decode_steps
            _expect(f"jamba {mode}", stats["launches"], want)
            _expect_tensor_cores(mode, stats["routes"], "expert_gemm",
                                 want["expert_gemm"], route="wgmma")
            for kernel in ("flash_attention", "paged_decode_attention"):
                if kernel in want:
                    _expect_tensor_cores(mode, stats["routes"], kernel,
                                         want[kernel])
        return expect

    n_params = sum(p.numel() for p in model.parameters())
    info = dict(params=n_params, weight_gb=n_params * 2 / 1e9,
                init_s=init_s, layers=spec.n_layers,
                published_layers=get_spec("jamba-v0.1-52b").n_layers,
                depth_cut="one 8-layer period of 32: the published 103 GB "
                          "of bf16 weights do not fit one 80 GB card",
                layer_kinds=kinds)
    out, lines = [], {}
    for mode in ("dense", "paged"):
        lines[mode] = serve_eager_and_replay(
            torch, model, spec, mode, "serve_jamba", expect_for(mode),
            **info)[0]
        out.append(lines[mode]["launches"])
    prof = phase_serve_profile(torch, model, spec,
                               EngineConfig(**GEOMETRY, **MODES["dense"]))
    # the profile's serve: 8 requests, 8 new tokens (see phase_serve_profile)
    rows, chunk = GEOMETRY["prefill_rows"], GEOMETRY["chunk_size"]
    t_prefill = scan_ms(torch, spec, rows, chunk)
    t_decode = scan_ms(torch, spec, GEOMETRY["max_slots"], 1)
    scan = n_mamba * (prof["prefill_calls"] * t_prefill
                      + prof["decode_steps"] * t_decode)
    busy = prof["device_busy_ms"]
    emit("jamba_split", model=spec.name, layers=spec.n_layers,
         scan_ms_prefill_call=t_prefill, scan_ms_decode_step=t_decode,
         scan_calls=n_mamba * (prof["prefill_calls"]
                               + prof["decode_steps"]),
         scan_ms_in_profile=scan, scan_share=scan / busy,
         expert_gemm_ms=prof["device_ms_by_class"].get("expert_gemm", 0.0),
         expert_gemm_share=prof["device_ms_by_class"].get(
             "expert_gemm", 0.0) / busy,
         elementwise_ms=prof["device_ms_by_class"].get("other", 0.0),
         device_busy_ms=busy,
         peak_mem_gb={m: lines[m]["peak_mem_gb"] for m in lines})
    del model
    free(torch)
    return out


def phase_serve_dense_registry(torch) -> list[dict]:
    """deepseek-7b (MHA, G = 1) and yi-34b (G = 7) at full width through the
    unified engine, eager and replayed, ragged launches exact on the
    tensor-core route (see ``phase_serve_unified``).  yi-34b's 68.8 GB of
    weights are built only after every earlier model is freed, and its
    peak stands beside the card's total.  Returns each replay serve's
    launch counts."""
    out = []
    for arch in ("deepseek-7b", "yi-34b"):
        free(torch)
        held = torch.cuda.memory_allocated()
        spec, model, init_s = build_full(torch, arch)
        stats = phase_serve_unified(torch, model, spec, init_s,
                                    "serve_dense_registry")[0]
        out.append(stats["launches"])
        total = torch.cuda.get_device_properties(0).total_memory
        emit("registry_memory", model=spec.name, layers=spec.n_layers,
             g=spec.n_heads // spec.n_kv_heads,
             weight_gb=sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9,
             held_before_build_gb=held / 1e9,
             peak_mem_gb=stats["peak_mem_gb"], card_total_gb=total / 1e9,
             max_slots=GEOMETRY["max_slots"], max_seq=GEOMETRY["max_seq"],
             kv_reserved_gb=stats["kv_reserved_bytes"] / 1e9)
        del model
        free(torch)
    return out


def _frames(torch, rows, frames, d, seed):
    """Seeded stand-in frontend embeddings (unit scale), bf16 on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((rows, frames, d), generator=gen,
                       device=DEV).bfloat16()


def _timed_call(torch, fn):
    """One call of ``fn`` with every kernel count 0 and the peak memory
    reset just before, read just after: (its result, its device ms, the
    launch counts, the routes); the peak stays for the caller to read."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1), read_launches(), read_routes()


def phase_encoder_frontend(torch) -> list[dict]:
    """hubert-xlarge at full width: ``forward(embeds=)`` over 4 x 1,024
    frames, bidirectional, one flash launch per layer on the tensor-core
    route at D = 80; logits finite, (4, 1,024, 504).  pixtral-12b at full
    width: the unified engine on token prompts (see
    ``phase_serve_unified``), then one ``prefill(embeds=)`` of 4 x 1,024
    patch embeddings into a dense cache, one flash launch per layer.
    Returns the launch counts of each."""
    out = []
    spec, model, init_s = build_full(torch, "hubert-xlarge")
    if model.embed is not None or spec.attn.causal:
        raise AssertionError("hubert: an encoder has no token embedding "
                             "and bidirectional attention")
    emb = _frames(torch, ENCODER_ROWS, ENCODER_FRAMES, spec.d_model, 0)
    model.forward(embeds=emb)  # warm-up
    logits, ms, counts, routes = _timed_call(
        torch, lambda: model.forward(embeds=emb))
    _expect("encoder hubert", counts, {"flash_attention": spec.n_layers})
    _expect_tensor_cores("encoder hubert", routes, "flash_attention",
                         spec.n_layers)
    if tuple(logits.shape) != (ENCODER_ROWS, ENCODER_FRAMES, spec.vocab) \
            or not bool(logits.isfinite().all()):
        raise AssertionError(f"encoder hubert: logits {tuple(logits.shape)}"
                             " not finite or not (rows, frames, vocab)")
    n_params = sum(p.numel() for p in model.parameters())
    emit("encoder_frontend", model=spec.name, entry="forward(embeds=)",
         rows=ENCODER_ROWS, frames=ENCODER_FRAMES, d_head=spec.d_head,
         causal=spec.attn.causal, params=n_params, init_s=init_s,
         device_ms=ms, frames_per_s=ENCODER_ROWS * ENCODER_FRAMES / ms * 1e3,
         launches=counts, routes=routes,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    out.append(counts)
    del model, logits
    free(torch)

    spec, model, init_s = build_full(torch, "pixtral-12b")
    out.append(phase_serve_unified(torch, model, spec, init_s,
                                   "serve_frontend")[0]["launches"])
    emb = _frames(torch, ENCODER_ROWS, ENCODER_FRAMES, spec.d_model, 1)
    cache = model.init_cache(ENCODER_ROWS, GEOMETRY["max_seq"],
                             layout="dense")
    (logits, cache), ms, counts, routes = _timed_call(
        torch, lambda: model.prefill(embeds=emb, cache=cache))
    _expect("frontend pixtral", counts, {"flash_attention": spec.n_layers})
    _expect_tensor_cores("frontend pixtral", routes, "flash_attention",
                         spec.n_layers)
    if tuple(logits.shape) != (ENCODER_ROWS, spec.vocab) \
            or not bool(logits.isfinite().all()) \
            or cache.lengths.tolist() != [ENCODER_FRAMES] * ENCODER_ROWS:
        raise AssertionError("frontend pixtral: prefill(embeds=) logits or "
                             "lengths wrong")
    emit("encoder_frontend", model=spec.name, entry="prefill(embeds=)",
         rows=ENCODER_ROWS, frames=ENCODER_FRAMES, device_ms=ms,
         tokens_per_s=ENCODER_ROWS * ENCODER_FRAMES / ms * 1e3,
         launches=counts, routes=routes,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    out.append(counts)
    del model, cache, logits
    free(torch)
    return out


def phase_registry_parity(torch) -> None:
    """The new architectures at full width and 2 layers in float32, each
    kernel against its plain version.  jamba-v0.1-52b: a Mamba layer (dense
    MLP) then an attention layer (MoE), through the dense and the paged
    two-dispatch replay engines: kernel against plain in each layout and
    dense against paged, token-identical up to genuine ties (top-2 gap
    under TIE_GAP).  yi-34b (G = 7) through the unified engine, kernel
    against plain likewise.  hubert-xlarge's ``forward(embeds=)`` over 2 x
    256 frames: kernel against plain logits within F32_ATOL."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    def serve_outs(model, spec, modes):
        outs = {}
        for mode in modes:
            for impl in ("kernel", "plain"):
                model.kernel_impl = impl
                reqs = make_requests(spec, 8, 16, seed=1)
                ServeEngine(model, EngineConfig(**GEOMETRY, **MODES[mode]),
                            device=DEV).serve(reqs)
                outs[mode, impl] = [r.output for r in reqs]
        model.kernel_impl = "plain"
        prompts = [r.prompt for r in make_requests(spec, 8, 16, seed=1)]
        pairs = [((m, "kernel"), (m, "plain")) for m in modes] + [
            ((modes[0], "kernel"), (m, "kernel")) for m in modes[1:]]
        comparisons = {}
        for a, b in pairs:
            what = f"{'/'.join(a)} vs {'/'.join(b)}"
            comparisons[what] = {
                "identical": sum(x == y for x, y in zip(outs[a], outs[b])),
                "ties": _ties(torch, model, prompts, outs[a], outs[b],
                              what)}
        return comparisons

    jamba = get_spec("jamba-v0.1-52b").scaled(
        name="jamba-v0.1-52b-2l", n_layers=2, hybrid_pattern=("ssm", "attn"))
    yi = get_spec("yi-34b").scaled(name="yi-34b-2l", n_layers=2)
    for spec, modes in ((jamba, ("dense", "paged")), (yi, ("unified",))):
        model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
        emit("registry_parity", model=spec.name, dtype="float32",
             layers=[layer.cls.key for layer in model.layers],
             comparisons=serve_outs(model, spec, modes))
        del model
        free(torch)

    spec = get_spec("hubert-xlarge").scaled(name="hubert-xlarge-2l",
                                            n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    emb = _frames(torch, 2, 256, spec.d_model, 2).float()
    logits = {}
    for impl in ("kernel", "plain"):
        model.kernel_impl = impl
        logits[impl] = model.forward(embeds=emb)
    err = float((logits["kernel"] - logits["plain"]).abs().max())
    if not err <= F32_ATOL:
        raise AssertionError(f"registry_parity hubert: kernel against "
                             f"plain logits differ by {err}")
    emit("registry_parity", model=spec.name, dtype="float32",
         entry="forward(embeds=)", max_abs_err_logits=err, atol=F32_ATOL)
    del model, logits
    free(torch)


# ---------------------------------------------------------------------------
# serve_tp, tp_parity: the sharded unified engine, two ranks on one card
# ---------------------------------------------------------------------------

#: the meshes of two ranks serve_tp and tp_parity serve
TP_MESHES = ((2, 1), (1, 2))
TP_NOTE = ("two ranks share one card over gloo, which stages every "
           "collective through host memory: not a measure of tp across "
           "cards")


def run_ranks(fn, *args, backend="gloo"):
    """``fn(*args)`` on two ranks (``sharded.spawn``: each a fresh process
    in a process group of ``backend``); returns their results, rank 0's
    first.  Stops both ranks whatever happens."""
    from repro_torch.serving import sharded
    return sharded.spawn(2, fn, *args, backend=backend, timeout_s=600)


def collectives_per_step(spec, tp, pp) -> int:
    """The reference's count of one step's collectives on a rank: two
    all-reduces a layer and one logits gather (an untied head) at tp > 1;
    pp hops and one broadcast at pp > 1 (65 and 3 at minitron-8b)."""
    n = 0
    if tp > 1:
        n += 2 * spec.n_layers + (not spec.tied_embeddings)
    if pp > 1:
        n += pp + 1
    return n


def _rank_setup(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_serve_tp(arch, graphs):
    """One rank of serve_tp: for each of TP_MESHES, the rank's shard of
    ``arch`` at its published width in bf16 (every full tensor drawn from
    seed 0, the rank's slice kept), then the 8 requests of serve_full
    through the sharded unified engine, warmed by one short request;
    launches exact (ragged: the stage's layers x (2 x mixed + decode-only
    steps), every other kernel 0, all on the tensor-core route), collectives
    the reference's count a step, dispatches == d2h copies == steps.  Over
    gloo a card engine with graphs=True must be refused first.  Returns
    {mesh: (stats, outputs)}."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine, sharded

    _rank_setup(torch)
    spec = get_spec(arch)
    out = {}
    for tp, pp in TP_MESHES:
        what = f"serve_tp rank {dist.get_rank()} tp={tp} pp={pp}"
        mesh = sharded.make_engine_mesh(tp, pp, DEV)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(spec, device=DEV, dtype=torch.bfloat16, seed=0,
                            shard=mesh.shard)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        refusal = None
        if mesh.staged:  # gloo on the card
            try:
                ServeEngine(model, EngineConfig(**GEOMETRY, **MODES["unified"],
                                                tp=tp, pp=pp), device=DEV)
            except ValueError as e:
                refusal = str(e)
            if refusal is None or "gloo" not in refusal:
                raise AssertionError(f"{what}: graphs=True over gloo was not "
                                     f"refused ({refusal})")
        eng, stats, outs = serve_counted(torch, model, spec, "unified",
                                         graphs=graphs, tp=tp, pp=pp)
        m = eng.metrics
        if not m.dispatches == m.transfers_d2h == m.steps:
            raise AssertionError(f"{what}: {m.dispatches} dispatches, "
                                 f"{m.transfers_d2h} transfers, {m.steps} "
                                 "steps")
        mixed = m.prefill_calls
        decode_only = m.dispatches - mixed
        n_ragged = model.spec.n_layers * (2 * mixed + decode_only)
        _expect(what, stats["launches"], {"ragged_paged_attention": n_ragged})
        _expect_tensor_cores(what, stats["routes"], "ragged_paged_attention",
                             n_ragged)
        per_step = collectives_per_step(spec, tp, pp)
        if m.collectives != per_step * m.steps or m.collective_bytes <= 0:
            raise AssertionError(f"{what}: {m.collectives} collectives "
                                 f"({m.collective_bytes} bytes) over "
                                 f"{m.steps} steps, expected {per_step} a "
                                 "step")
        n_params = sum(p.numel() for p in model.parameters())
        stats.update(tp=tp, pp=pp, rank=dist.get_rank(),
                     tp_rank=mesh.tp_rank, pp_rank=mesh.pp_rank,
                     backend=mesh.backend, staged=mesh.staged,
                     local_layers=model.spec.n_layers,
                     local_heads=[model.spec.n_heads, model.spec.n_kv_heads],
                     params=n_params, weight_gb=n_params * 2 / 1e9,
                     init_s=init_s, mixed_steps=mixed,
                     decode_only_steps=decode_only,
                     collectives=m.collectives,
                     collective_bytes=m.collective_bytes,
                     collectives_per_step=m.collectives / m.steps,
                     step_ms=stats["host_ms_per_step"],
                     kv_rank_bytes=stats["kv_reserved_bytes"] // (tp * pp),
                     graphs_refused=refusal)
        out[f"tp{tp}pp{pp}"] = (stats, outs)
        del eng, model, mesh
        free(torch)
    return out


def phase_serve_tp(torch, base_outs) -> list[dict]:
    """minitron-8b at its published width served by the sharded unified
    engine as two ranks on the one card over gloo (graphs=False), tp=2
    then pp=2 (``_rank_serve_tp``): both ranks' outputs identical, each
    rank's line; how many outputs equal the tp=1 replay serve's
    (``base_outs``, recorded: bf16 sums in another order).  Where two or
    more cards are visible, the nccl route as well, one card a rank,
    graphs on; else a line says it was not run.  Returns each rank's
    launch counts of each serve."""
    emit("serve_tp_route", backend="gloo", graphs=False, ranks=2,
         device="cuda:0", cards=torch.cuda.device_count(), note=TP_NOTE)
    routes = [("gloo", False)]
    if torch.cuda.device_count() >= 2:
        routes.append(("nccl", True))
    else:
        emit("serve_tp_nccl", run=False,
             reason=f"{torch.cuda.device_count()} card visible; nccl needs "
                    "one card a rank (its route, the collectives captured in "
                    "the step's CUDA graph, is unverified here)")
    launches = []
    for backend, graphs in routes:
        t0 = time.perf_counter()
        ranks = run_ranks(_rank_serve_tp, "minitron-8b", graphs,
                          backend=backend)
        for mesh in ranks[0]:
            outs = [r[mesh][1] for r in ranks]
            if outs[0] != outs[1]:
                raise AssertionError(f"serve_tp {backend} {mesh}: the ranks' "
                                     "outputs differ")
            for r in ranks:
                stats = r[mesh][0]
                emit("serve_tp", model="minitron-8b", mesh=mesh,
                     label=TP_NOTE if backend == "gloo" else None, **stats)
                launches.append(stats["launches"])
            emit("serve_tp_outputs", mesh=mesh, backend=backend,
                 ranks_identical=True,
                 identical_to_tp1=sum(a == b for a, b in
                                      zip(outs[0], base_outs)),
                 requests=len(outs[0]))
        emit("serve_tp_phase", backend=backend,
             seconds=time.perf_counter() - t0)
    return launches


def _rank_tp_parity(arch):
    """One rank of tp_parity: for each of TP_MESHES the rank's shard of
    ``arch``'s widths at 2 layers (one a stage at pp=2) in float32 from
    seed 1, serving 8 requests through the sharded unified engine, eager,
    through the kernels and with the plain versions selected; returns
    {(mesh, impl): outputs}."""
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine, sharded

    _rank_setup(torch)
    spec = get_spec(arch).scaled(name=f"{arch}-2l", n_layers=2)
    out = {}
    for tp, pp in TP_MESHES:
        mesh = sharded.make_engine_mesh(tp, pp, DEV)
        model = build_model(spec, device=DEV, dtype=torch.float32, seed=1,
                            shard=mesh.shard)
        for impl in ("kernel", "plain"):
            model.kernel_impl = impl
            reqs = make_requests(spec, 8, 16, seed=1)
            eng = ServeEngine(model, EngineConfig(**GEOMETRY, **MODES[
                "unified"], tp=tp, pp=pp), device=DEV, graphs=False)
            eng.serve(reqs)
            m = eng.metrics
            if not m.dispatches == m.transfers_d2h == m.steps:
                raise AssertionError(f"tp_parity tp={tp} pp={pp} {impl}: "
                                     f"{m.dispatches} dispatches, "
                                     f"{m.transfers_d2h} transfers, "
                                     f"{m.steps} steps")
            out[f"tp{tp}pp{pp}", impl] = [r.output for r in reqs]
            del eng
        del model, mesh
        free(torch)
    return out


def phase_tp_parity(torch, arch="minitron-8b") -> None:
    """``arch``'s widths at 2 layers in float32: the tp=1 unified replay
    engine, then tp=2 and pp=2 as two ranks on the card over gloo, each
    through the kernels and the plain versions (``_rank_tp_parity``):
    both ranks identical, and every run token-identical to tp=1 and to
    each other, or parting only at a genuine tie (top-2 logit gap of the
    tp=1 model under TIE_GAP)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    t0 = time.perf_counter()
    spec = get_spec(arch).scaled(name=f"{arch}-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    reqs = make_requests(spec, 8, 16, seed=1)
    ServeEngine(model, EngineConfig(**GEOMETRY, **MODES["unified"]),
                device=DEV).serve(reqs)
    prompts = [r.prompt for r in reqs]
    outs = {"tp1": [r.output for r in reqs]}
    ranks = run_ranks(_rank_tp_parity, arch)
    for key in ranks[0]:
        if ranks[0][key] != ranks[1][key]:
            raise AssertionError(f"tp_parity {key}: the ranks' outputs "
                                 "differ")
        outs["/".join(key)] = ranks[0][key]
    model.kernel_impl = "plain"
    comparisons = {}
    pairs = [(k, "tp1") for k in outs if k != "tp1"] + [
        (f"tp{tp}pp{pp}/kernel", f"tp{tp}pp{pp}/plain")
        for tp, pp in TP_MESHES]
    for a, b in pairs:
        what = f"tp_parity {a} vs {b}"
        comparisons[f"{a} vs {b}"] = {
            "identical": sum(x == y for x, y in zip(outs[a], outs[b])),
            "ties": _ties(torch, model, prompts, outs[a], outs[b], what)}
    emit("tp_parity", model=spec.name, dtype="float32", requests=len(reqs),
         backend="gloo", ranks_identical=True, comparisons=comparisons,
         seconds=time.perf_counter() - t0, note=TP_NOTE)
    del model
    free(torch)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"  # the reference launcher's default --arch
TRAIN = dict(steps=10, batch=8, seq=1024)
TRAIN_PARITY_STEPS = 5
TRAIN_PARITY_LAYERS = 2


def _train_args(dtype, ckpt_dir):
    """launch/train.py's arguments for a full-width run."""
    from repro_torch.launch import train
    return train.parse([
        "--full", "--arch", TRAIN_ARCH, "--steps", str(TRAIN["steps"]),
        "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
        "--dtype", dtype, "--device", DEV, "--checkpoint-dir", ckpt_dir,
        "--checkpoint-every", "1000"])


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def phase_train(torch) -> list[dict]:
    """qwen1.5-0.5b at its published width through launch/train.py's code
    path (``make_trainer``, then ``Trainer.run``): 10 AdamW steps of 8 x
    1,024 tokens in float32, then in bf16 weights (AdamW's m and v f32).
    Each run: the loss falls (last-5 mean at least 0.2 under the first-5),
    flash forward and backward launch exactly n_layers x micro-batches x
    steps times, both on the route for the dtype (bf16 at D = 64:
    tensor_core forward, wgmma backward; f32: cuda_core), every other
    kernel 0, and the last
    step's checkpoint
    committed; the line gives the loss curve, ms a step split into
    forward, backward and optimizer (CUDA events, steps after the first),
    tokens/s, the run's seconds (the last checkpoint's write included) and
    peak memory."""
    import tempfile

    from repro_torch.configs import get_spec
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.launch import train
    out = []
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as d:
            args = _train_args(dtype, d)
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr = train.make_trainer(args)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            spec = tr.model.spec
            if spec != get_spec(TRAIN_ARCH):
                raise AssertionError(f"train: not {TRAIN_ARCH}'s published "
                                     f"width: {spec}")
            reset_launches()
            t0 = time.perf_counter()
            tr.run(0, args.steps)  # waits for the last checkpoint's write
            run_s = time.perf_counter() - t0
            counts, routes = read_launches(), read_routes()
            ckpt = tr.ckpt.latest_step()
            if ckpt != args.steps - 1:
                raise AssertionError(f"train {dtype}: the last step's "
                                     f"checkpoint is missing ({ckpt})")
        hist = tr.history
        losses = [h["loss"] for h in hist]
        n = spec.n_layers * tr.cfg.micro_batches * args.steps
        fwd_route = ("tensor_core" if flash_attention.tensor_core_route(
            tr.model.dtype, spec.d_head) else "cuda_core")
        _expect(f"train {dtype}", counts,
                {"flash_attention": n, "flash_attention_bwd": n})
        bwd_route = flash_attention_bwd.route(tr.model.dtype, spec.d_head)
        if routes["flash_attention"][fwd_route] != n \
                or routes["flash_attention_bwd"][bwd_route] != n:
            raise AssertionError(f"train {dtype}: routes {routes}")
        first, last = _mean(losses[:5]), _mean(losses[-5:])
        if not all(map(math.isfinite, losses)) or last > first - 0.2:
            raise AssertionError(f"train {dtype}: the loss did not fall by "
                                 f"0.2: {losses}")
        steady = hist[1:]
        step_s = _mean([h["dt"] for h in steady])
        line = dict(
            arch=TRAIN_ARCH, dtype=dtype, optimizer_state="float32",
            params=sum(p.numel() for p in tr.model.parameters()),
            n_layers=spec.n_layers, d_model=spec.d_model, vocab=spec.vocab,
            steps=args.steps, batch=args.batch, seq=args.seq,
            micro_batches=tr.cfg.micro_batches, lr=args.lr,
            losses=losses, loss_first5=first, loss_last5=last,
            step_ms=step_s * 1e3, first_step_ms=hist[0]["dt"] * 1e3,
            **{f"{part}_ms": _mean([h[f"{part}_ms"] for h in steady
                                    if f"{part}_ms" in h])
               for part in ("forward", "backward", "optimizer")},
            tokens_per_s=args.batch * args.seq / step_s,
            build_s=build_s, run_s=run_s,
            checkpoint_step=ckpt,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=counts, routes=routes, forward_route=fwd_route,
            backward_route=bwd_route)
        emit("train", **line)
        out.append(counts)
        del tr
    free(torch)
    return out


def _leaf_scale_err(torch, got, want):
    """max |got - want| over max(1, max |want|), per leaf."""
    return {n: float((got[n].float() - w.float()).abs().max())
            / max(1.0, float(w.abs().max())) for n, w in want.items()}


def train_launches(spec, passes) -> dict[str, int]:
    """Kernel launches of ``passes`` forward and backward passes of the
    loss through the kernels (one a micro-batch and step): flash forward
    and backward once per attention layer; the expert GEMM
    ``expert_launches_per_forward`` times forward and twice that backward
    (dX and dW of each product); the WKV scan and its backward once per
    RWKV layer.  The Mamba scan is plain torch."""
    from repro_torch.models import transformer as T
    kinds = [c.kind for c in T.layer_classes(spec)]
    attn, rwkv = kinds.count("attn"), kinds.count("rwkv6")
    gemm = expert_launches_per_forward(spec)
    out = {"flash_attention": attn, "flash_attention_bwd": attn,
           "expert_gemm": gemm, "expert_gemm_bwd": 2 * gemm,
           "rwkv6_scan": rwkv, "rwkv6_scan_bwd": rwkv}
    return {k: n * passes for k, n in out.items() if n}


#: train_parity's widths, each with its rows of TRAIN["seq"] tokens and
#: AdamW's peak lr and eps.  deepseek-moe-16b's 64 experts of 1,408 run on
#: every token in f32: at 8 rows its backward did not fit the card (74 GB
#: held, on an H100); it and rwkv6-3b run at 1 and 2 rows for the time.
#: A larger eps and a smaller lr at the MoE and RWKV widths: a leaf whose
#: gradient is near eps moves by lr g / (|g| + eps), which turns the two
#: trainers' f32 rounding (deepseek's step-0 gradients agree within 6.4e-7
#: of their scale) into weight differences of a fraction of lr, and then
#: into routing.  deepseek's losses parted within 5 steps by 7.6e-3 at lr
#: 3e-3 and eps 1e-8, by 2.3e-4 at 3e-3 and 1e-6, by 2.1e-4 at 3e-4 and
#: 1e-6 (on an H100); tests/test_torch_train_moe.py meets the same against
#: the JAX Trainer on the CPU
TRAIN_PARITY_ARCHS = {TRAIN_ARCH: (TRAIN["batch"], 3e-3, 1e-8),
                      "deepseek-moe-16b": (1, 3e-4, 1e-4),
                      "rwkv6-3b": (2, 3e-4, 1e-6)}


def phase_train_parity(torch) -> list[dict]:
    """train_parity at each width of TRAIN_PARITY_ARCHS."""
    return [_train_parity(torch, arch, *cfg)
            for arch, cfg in TRAIN_PARITY_ARCHS.items()]


def _train_parity(torch, arch, rows, lr, eps) -> dict:
    """f32, ``arch``'s width at 2 layers (qwen1.5-0.5b: attention;
    deepseek-moe-16b: a dense and a MoE layer with shared experts;
    rwkv6-3b: two RWKV-6 layers), ``rows`` x TRAIN["seq"] tokens, AdamW's
    peak ``lr`` and ``eps``: a trainer through the kernels
    (impl="kernel") against one through the plain versions
    (impl="plain") from the same weights and batches: step-0 gradients
    within 1e-4 of each leaf's scale, then TRAIN_PARITY_STEPS steps'
    losses within 1e-4 and the final weights recorded.  The kernel
    trainer launches ``train_launches`` of 1 + steps passes, forward and
    backward; the plain one's none."""
    import tempfile

    from repro_torch.configs import get_spec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer
    spec = get_spec(arch).scaled(n_layers=TRAIN_PARITY_LAYERS)
    data = DataConfig(vocab=spec.vocab, seq_len=TRAIN["seq"],
                      global_batch=rows)
    runs = {}
    for impl in ("kernel", "plain"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            model = build_model(spec, device=DEV, dtype=torch.float32)
            model.kernel_impl = impl
            tr = Trainer(model, data,
                         TrainConfig(checkpoint_every=1000, checkpoint_dir=d,
                                     optimizer=AdamWConfig(
                                         lr=lr, warmup_steps=2, eps=eps,
                                         total_steps=TRAIN_PARITY_STEPS)),
                         generator=torch.Generator(device=DEV)
                         .manual_seed(0))
            reset_launches()
            batches = [tuple(torch.from_numpy(b[k]).to(DEV)
                             for k in ("x", "targets"))
                       for b in map(tr.data.batch_at,
                                    range(TRAIN_PARITY_STEPS))]
            loss0, grads = tr._grads(*batches[0])
            grads = {n: g.detach().clone()
                     for n, g in zip(tr.params, grads)}
            # the trainer's steps without Trainer.run's checkpoint at the
            # last one (13 GB at deepseek's width in f32: about 20 s a
            # trainer, and nothing here reads it)
            losses = [float(tr._step(x, t)) for x, t in batches]
            runs[impl] = dict(loss0=float(loss0), grads=grads,
                              losses=losses,
                              state={n: v.detach().clone() for n, v in
                                     tr.model.state_dict().items()},
                              launches=read_launches(),
                              seconds=time.perf_counter() - t0)
            del tr, model, grads
            free(torch)
    k, p = runs["kernel"], runs["plain"]
    _expect(f"train_parity {arch} kernel", k["launches"],
            train_launches(spec, 1 + TRAIN_PARITY_STEPS))
    _expect(f"train_parity {arch} plain", p["launches"], {})
    grad_err = _leaf_scale_err(torch, k["grads"], p["grads"])
    loss_err = max(abs(a - b) for a, b in zip(k["losses"], p["losses"]))
    weight_err = max(float((k["state"][n_] - w).abs().max())
                     for n_, w in p["state"].items())
    worst = max(grad_err, key=grad_err.get)
    line = dict(arch=arch, n_layers=spec.n_layers, dtype="float32",
                steps=TRAIN_PARITY_STEPS, batch=rows, lr=lr, adamw_eps=eps,
                seq=TRAIN["seq"], loss0_kernel=k["loss0"],
                loss0_plain=p["loss0"], losses_kernel=k["losses"],
                losses_plain=p["losses"], max_loss_err=loss_err,
                max_grad_err_of_scale=grad_err[worst], worst_leaf=worst,
                max_weight_err=weight_err, launches_kernel=k["launches"],
                launches_plain=p["launches"], seconds_kernel=k["seconds"],
                seconds_plain=p["seconds"])
    emit("train_parity", **line)
    if grad_err[worst] > 1e-4 or loss_err > 1e-4:
        raise AssertionError(f"train_parity {arch}: step-0 gradient {worst} "
                             f"off by {grad_err[worst]} of its scale, losses "
                             f"by {loss_err}")
    del runs
    free(torch)
    return k["launches"]


def phase_train_restart(torch) -> dict:
    """launch/train_faulty.py's configuration on the card (reduced
    deepseek-7b at a 128-token vocabulary, f32, 40 steps, a failure
    injected at step 25, checkpoints every 10): the restarted run's
    weights within 1e-5 of the uninterrupted run's; whether they are equal
    bit for bit is recorded, with the leaf that parts most.  Flash
    forward and backward launch n_layers x (40 + 25 + the replayed steps)
    times (the uninterrupted run, the run up to the failure, the replay
    from the newest checkpoint: step 20)."""
    from repro_torch.launch import train_faulty
    reset_launches()
    t0 = time.perf_counter()
    ref, tr, diff = train_faulty.run(steps=40, fail_at=25, device=DEV,
                                     log=lambda *a: None)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    # the restarted trainer replays from its checkpoint (step 20 when the
    # step-19 write had landed before the failure)
    n = ref.model.spec.n_layers * (40 + 25 + len(tr.history))
    _expect("train_restart", counts,
            {"flash_attention": n, "flash_attention_bwd": n})
    theirs = tr.model.state_dict()
    parts = {name: float((t - theirs[name]).abs().max())
             for name, t in ref.model.state_dict().items()}
    bitwise = all(torch.equal(t, theirs[name])
                  for name, t in ref.model.state_dict().items())
    if not diff < 1e-5:
        raise AssertionError(f"train_restart: weights off by {diff}")
    emit("train_restart", arch="deepseek-7b (reduced, vocab 128)",
         steps=40, fail_at=25, replayed_steps=len(tr.history),
         max_weight_diff=diff, bitwise_equal=bitwise,
         worst_leaf=max(parts, key=parts.get), seconds=seconds,
         launches=counts)
    return counts


# training the MoE, RWKV-6 and Mamba stacks at their published widths
# through launch/train.py's code path: bf16 weights, f32 AdamW m and v
# and the trainer's f32 gradient accumulator, 1,024-token micro-batches,
# the launcher's warmup (10 steps) to a peak of TRAIN_STACK_LR (at the
# launcher's 3e-3 jamba's loss jumped 10.6 -> 13.5 at step 4, and with a
# 2-step warmup rwkv6-3b's 11.4 -> 29.6 at step 1; on an H100).
# granite-moe-3b-a800m's and rwkv6-3b's first 4 layers, 8 x 1,024 tokens
# a step: at full depth the last step's checkpoint (30-33 GB by np.savez)
# took 46-62 s of each phase on an H100's host, and the whole script
# neared its 1,200 s limit.  jamba-v0.1-52b's first 2 layers (a Mamba
# layer with the dense MLP, a Mamba layer with 16 experts of 14,336),
# 2 x 1,024 tokens: its 32 layers, about 52 B parameters at 16 bytes each
# (the weight, its accumulator, m, v and a micro-batch's bf16 gradient),
# would take 0.8 TB.
TRAIN_STACKS = {
    "train_moe": dict(arch="granite-moe-3b-a800m", steps=5, batch=8,
                      micro_batches=8, n_layers=4),
    "train_rwkv": dict(arch="rwkv6-3b", steps=5, batch=8, micro_batches=8,
                       n_layers=4),
    "train_jamba": dict(arch="jamba-v0.1-52b", steps=5, batch=2,
                        micro_batches=2, n_layers=2),
}
TRAIN_STACK_SEQ = 1024
TRAIN_STACK_LR = 1e-3
#: bytes a parameter holds while it trains in bf16: the weight, its f32
#: accumulator, AdamW's f32 m and v, a micro-batch's bf16 gradient
TRAIN_BYTES_PER_PARAM = 2 + 4 + 4 + 4 + 2


def phase_train_stack(torch, phase) -> dict:
    """One of TRAIN_STACKS through ``make_trainer`` and ``Trainer.run``:
    the loss falls (the mean of the last half of the steps at least 0.2
    under the first half's, and the last step's loss under the first's),
    every kernel launches exactly
    ``train_launches`` of micro-batches x steps passes, forward and
    backward apart, every other kernel 0, the bf16 routes (the flash
    forward at D = 64 and 128 on tensor cores, its backward, the expert
    GEMM forward and backward on wgmma), and the last step's checkpoint commits; the line gives the
    loss curve, ms a step by part (CUDA events, steps after the first),
    tokens/s, peak memory and each cut with its bytes."""
    import tempfile

    from repro_torch.configs import get_spec
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.launch import train
    cfg = TRAIN_STACKS[phase]
    arch, steps, mb = cfg["arch"], cfg["steps"], cfg["micro_batches"]
    argv = ["--full", "--arch", arch, "--steps", str(steps), "--batch",
            str(cfg["batch"]), "--seq", str(TRAIN_STACK_SEQ),
            "--micro-batches", str(mb), "--lr", str(TRAIN_STACK_LR),
            "--dtype", "bfloat16", "--device", DEV,
            "--checkpoint-every", "1000"]
    if "n_layers" in cfg:
        argv += ["--n-layers", str(cfg["n_layers"])]
    with tempfile.TemporaryDirectory() as d:
        args = train.parse(argv + ["--checkpoint-dir", d])
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train.make_trainer(args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        spec, full = tr.model.spec, get_spec(arch)
        if spec != full.scaled(n_layers=cfg.get("n_layers",
                                                full.n_layers)):
            raise AssertionError(f"{phase}: not {arch}'s published width: "
                                 f"{spec}")
        reset_launches()
        t0 = time.perf_counter()
        tr.run(0, steps)  # waits for the last checkpoint's write
        run_s = time.perf_counter() - t0
        counts, routes = read_launches(), read_routes()
        ckpt = tr.ckpt.latest_step()
        if ckpt != steps - 1:
            raise AssertionError(f"{phase}: the last step's checkpoint is "
                                 f"missing ({ckpt})")
    want = train_launches(spec, mb * steps)
    _expect(phase, counts, want)
    for kernel in ("flash_attention", "flash_attention_bwd"):
        if kernel in want:
            route = (flash_attention_bwd.route(torch.bfloat16, spec.d_head)
                     if kernel == "flash_attention_bwd" else
                     "tensor_core" if flash_attention.tensor_core_route(
                         torch.bfloat16, spec.d_head) else "cuda_core")
            _expect_tensor_cores(phase, routes, kernel, want[kernel], route)
    for kernel in ("expert_gemm", "expert_gemm_bwd"):
        if kernel in want:
            _expect_tensor_cores(phase, routes, kernel, want[kernel],
                                 route="wgmma")
    hist = tr.history
    losses = [h["loss"] for h in hist]
    half = steps // 2
    first, last = _mean(losses[:half]), _mean(losses[-half:])
    if not all(map(math.isfinite, losses)) or last > first - 0.2 \
            or losses[-1] >= losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall by 0.2: "
                             f"{losses}")
    params = sum(p.numel() for p in tr.model.parameters())
    cuts = {}
    if spec.n_layers != full.n_layers:
        cuts["n_layers"] = dict(
            published=full.n_layers, run=spec.n_layers,
            published_params=full.param_count(),
            published_train_bytes=full.param_count()
            * TRAIN_BYTES_PER_PARAM,
            card_bytes=torch.cuda.get_device_properties(0).total_memory)
    steady = hist[1:]
    step_s = _mean([h["dt"] for h in steady])
    line = dict(
        arch=arch, dtype="bfloat16", optimizer_state="float32",
        params=params, train_bytes=params * TRAIN_BYTES_PER_PARAM,
        n_layers=spec.n_layers, d_model=spec.d_model, vocab=spec.vocab,
        steps=steps, batch=args.batch, seq=args.seq, micro_batches=mb,
        lr=args.lr, losses=losses,
        loss_first_half=first, loss_last_half=last,
        step_ms=step_s * 1e3, first_step_ms=hist[0]["dt"] * 1e3,
        **{f"{part}_ms": _mean([h[f"{part}_ms"] for h in steady
                                if f"{part}_ms" in h])
           for part in ("forward", "backward", "optimizer")},
        tokens_per_s=args.batch * args.seq / step_s, build_s=build_s,
        run_s=run_s, checkpoint_step=ckpt,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        cuts=cuts, launches=counts, routes=routes)
    emit(phase, **line)
    del tr
    free(torch)
    return counts

# ---------------------------------------------------------------------------
# mesh_parity, train_mesh: mesh-sharded training, two ranks on one card
# ---------------------------------------------------------------------------

MESH_ARCH = "granite-moe-3b-a800m"
#: mesh_parity: f32, granite's widths at 2 layers, 2 x 256 tokens (at
#: capacity 8.0 each all-to-all carries 16,384 f32 rows of 1,536 a rank
#: through host memory; at 2 x 1,024 the phase took 48 s on an H100's
#: host, at 2 x 256 the shapes still cover every path)
MESH_PARITY = dict(n_layers=2, batch=2, seq=256)
#: train_mesh: bf16 weights (m and v f32), granite's first 4 of 32 layers
#: at full width, a (data 1, model 2) mesh, 2 x 1,024 tokens a step
TRAIN_MESH = dict(n_layers=4, steps=3, batch=2, seq=1024, lr=1e-3)
MESH_NOTE = ("two ranks share one card over gloo, which stages every "
             "collective through host memory: not a measure of collectives "
             "across cards")


def _shard_line(shard) -> dict:
    """How a mesh rank's shard splits the model."""
    return dict(tp=shard.tp, ffn_tp=shard.ffn_tp, head_tp=shard.head_tp,
                ep=shard.ep, shared_tp=shard.shared_tp)


def _dispatch_line(calls) -> dict:
    """The geometry and the summed drops of recorded EP calls."""
    if not calls:
        return {}
    return dict(partition=calls[0]["partition"], c_send=calls[0]["c_send"],
                c_cap=calls[0]["c_cap"],
                assignments=sum(c["assignments"] for c in calls),
                dropped_send=sum(int(c["dropped_send"]) for c in calls),
                dropped_expert=sum(int(c["dropped_expert"]) for c in calls))


def _rank_mesh_parity():
    """One rank of mesh_parity (f32, MESH_ARCH's widths at 2 layers, 2 x
    256 tokens, every model from seed 0, so that a mesh rank holds the
    slices of the single-rank model's weights): the single-rank model's
    loss and step-0 gradients (the dense MoE route) against, on this
    rank's slices, the (data 1, model 2) mesh model's through the kernels
    at capacity 8.0 (expert-parallel, no drop; the tokens routed whole on
    each rank, and partitioned over the ranks), the same through the plain
    versions, the (data 2, model 1) mesh model's, and the expert-parallel
    model's at capacity 1.25 (drops recorded).  Returns each run's loss,
    each leaf's scale (max |g| of the rank's slice of the single-rank
    gradient) and error over it, the worst leaf, launches, routes and
    collectives."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_spec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    _rank_setup(torch)
    spec = get_spec(MESH_ARCH).scaled(n_layers=MESH_PARITY["n_layers"])
    batch = TokenPipeline(DataConfig(
        vocab=spec.vocab, seq_len=MESH_PARITY["seq"],
        global_batch=MESH_PARITY["batch"])).batch_at(0)
    x, t = (torch.from_numpy(batch[k]).to(DEV) for k in ("x", "targets"))

    def loss_grads(model):
        model.requires_grad_(True)
        loss = model.loss(x, t)
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = {n: torch.zeros_like(p) if g is None else g
               for n, p, g in zip(names, leaves, grads)}
        if model.mesh is not None:  # the data ranks' shares
            axes = model.batch_axes(x.shape[0])
            out = {n: model.mesh.all_reduce(g, axes) for n, g in out.items()}
        return float(loss.detach()), out

    single = build_model(spec, DEV, torch.float32, seed=0)
    ref_loss, ref_g = loss_grads(single)
    del single
    free(torch)
    out = dict(rank=dist.get_rank(), single_loss=ref_loss)

    def run(what, shape, impl, cf, partition=False):
        mesh = make_mesh(shape, ("data", "model"), DEV)
        model = build_model(spec, DEV, torch.float32, seed=0, mesh=mesh,
                            policy="train_2d")
        model.kernel_impl = impl
        model.moe_capacity_factor = cf
        model.moe_partition_tokens = partition
        model.dispatch_log = calls = []
        reset_launches()
        mesh.reset_stats()
        t0 = time.perf_counter()
        loss, g = loss_grads(model)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        places = model.param_placements()
        leaves = {}
        for n, v in g.items():
            want = places[n].local(ref_g[n])
            scale = float(want.abs().max())
            leaves[n] = (scale, float((v - want).abs().max())
                         / max(scale, 1e-30))
        worst = max(leaves, key=lambda n: leaves[n][1])
        out[what] = dict(
            mesh=dict(mesh.shape), impl=impl, capacity_factor=cf,
            partition_tokens=partition, loss=loss,
            loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
            max_grad_err_of_scale=leaves[worst][1], worst_leaf=worst,
            worst_leaf_scale=leaves[worst][0],
            leaf_scale_and_err=leaves, launches=read_launches(),
            routes={k: v for k, v in read_routes().items() if any(v.values())},
            collectives=dict(mesh.stats["calls"]), seconds=seconds,
            shard=_shard_line(model.shard), **_dispatch_line(calls))
        del model, g
        free(torch)

    run("ep_kernel", (1, 2), "kernel", 8.0)
    run("ep_part", (1, 2), "kernel", 8.0, partition=True)
    run("ep_plain", (1, 2), "plain", 8.0)
    run("data2", (2, 1), "kernel", 8.0)
    run("ep_drops", (1, 2), "kernel", 1.25)
    return out


def phase_mesh_parity(torch) -> list[dict]:
    """mesh_parity (``_rank_mesh_parity`` on two gloo ranks sharing the
    card): against the single-rank model, the expert-parallel mesh
    through the kernels (tokens whole and partitioned) and through the
    plain versions and the data mesh: loss within 1e-5 relative, step-0
    gradients within 1e-4 of each leaf's own scale; the kernel runs
    launch exactly flash 1 and its backward 1 per layer, the expert GEMM
    3 and its backward 6 per MoE layer, all on the f32 CUDA-core routes,
    the plain run none; their all-to-alls 2 forward and 2 backward per MoE
    layer, with no drop at capacity 8.0; at 1.25 the drops and the loss
    are recorded.  Returns each rank's kernel-run launches."""
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_mesh_parity)
    from repro_torch.configs import get_spec
    spec = get_spec(MESH_ARCH).scaled(n_layers=MESH_PARITY["n_layers"])
    n_moe = sum(spec.moe.is_moe_layer(i) for i in range(spec.n_layers))
    want = train_launches(spec, 1)
    launches = []
    for r in ranks:
        what = f"mesh_parity rank {r['rank']}"
        for run in ("ep_kernel", "ep_part", "ep_plain", "data2"):
            got = r[run]
            if got["loss_rel_err"] > 1e-5 \
                    or got["max_grad_err_of_scale"] > 1e-4:
                raise AssertionError(f"{what} {run}: loss off by "
                                     f"{got['loss_rel_err']}, "
                                     f"{got['worst_leaf']} by "
                                     f"{got['max_grad_err_of_scale']} of "
                                     f"its scale {got['worst_leaf_scale']}")
        _expect(f"{what} ep_plain", r["ep_plain"]["launches"], {})
        for run, partition in (("ep_kernel", False), ("ep_part", True)):
            k = r[run]
            _expect(f"{what} {run}", k["launches"], want)
            for kernel, n in want.items():
                routes = k["routes"][kernel]
                if routes["cuda_core"] != n or sum(routes.values()) != n:
                    raise AssertionError(f"{what} {run}: {kernel} routes "
                                         f"{routes}, expected all {n} on "
                                         "cuda_core")
            a2a = (k["collectives"].get("all_to_all"),
                   k["collectives"].get("all_to_all_bwd"))
            if a2a != (2 * n_moe, 2 * n_moe) or k["dropped_send"] \
                    or k["dropped_expert"] or k["partition"] != partition:
                raise AssertionError(f"{what} {run}: all-to-alls {a2a}, "
                                     f"drops {k['dropped_send']}, "
                                     f"{k['dropped_expert']} at capacity "
                                     f"8.0, partition {k['partition']}")
            launches.append(k["launches"])
        launches.append(r["data2"]["launches"])
        launches.append(r["ep_drops"]["launches"])
        emit("mesh_parity", arch=MESH_ARCH, dtype="float32",
             n_layers=spec.n_layers, batch=MESH_PARITY["batch"],
             seq=MESH_PARITY["seq"], label=MESH_NOTE, **r)
    emit("mesh_parity_phase", seconds=time.perf_counter() - t0)
    return launches


def _rank_train_mesh(argv):
    """One rank of train_mesh: launch/train.py's code path for a
    ``--devices 2 --tp 2`` run (``make_trainer(args, mesh=)``, then
    ``Trainer.run``, its last checkpoint gathered and written by rank 0)
    on the (data 1, model 2) mesh; returns the history, launches, routes,
    the mesh's collectives (calls, bytes, seconds by tag), the EP
    geometry and drops, and peak memory."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    _rank_setup(torch)
    args = train.parse(argv)
    with tempfile.TemporaryDirectory() as d:
        if dist.get_rank() == 0:
            ckpt = [d]
        else:
            ckpt = [None]
        dist.broadcast_object_list(ckpt, src=0)
        args.checkpoint_dir = ckpt[0]
        mesh = make_mesh((args.devices // args.tp, args.tp),
                         ("data", "model"), DEV)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train.make_trainer(args, mesh=mesh)
        # the reference's dryrun runs its MoE cells so: both model ranks
        # then train one set of replicated weights
        tr.model.moe_partition_tokens = True
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reset_launches()
        mesh.reset_stats()
        tr.model.dispatch_log = calls = []
        t0 = time.perf_counter()
        tr.run(0, args.steps)  # waits for the last checkpoint's write
        run_s = time.perf_counter() - t0
        ckpt_step = tr.ckpt.latest_step()
        dist.barrier()  # rank 0's temporary directory outlives the read
    stats = {k: dict(v) for k, v in mesh.stats.items()}
    return dict(rank=dist.get_rank(), coords=dict(mesh.coords),
                history=tr.history, launches=read_launches(),
                routes=read_routes(), collectives=stats,
                dispatch=_dispatch_line(calls), build_s=build_s,
                run_s=run_s, checkpoint_step=ckpt_step,
                shard=_shard_line(tr.model.shard),
                params=sum(p.numel() for p in tr.model.parameters()),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_train_mesh(torch) -> list[dict]:
    """train_mesh (``_rank_train_mesh`` on two gloo ranks sharing the card):
    on each rank the losses finite, the last checkpoint committed, and the
    launches exact: flash and its backward once per layer and step, the
    expert GEMM 3 and its backward 6 per MoE layer and step, on the bf16
    tensor-core routes (flash forward tensor_core, its backward and the
    expert GEMM wgmma), every other kernel 0; the token all-to-alls 2
    forward and 2 backward per MoE layer and step, the tokens partitioned
    over the ranks, so that both train one set of replicated weights and
    their losses agree.  Each rank's line: the
    loss each step, ms a step by part (CUDA events: forward, backward,
    the data gradient sum, optimizer), the host seconds of each
    collective apart, the EP buffers' geometry and drops, peak memory.
    Returns each rank's launches."""
    from repro_torch.configs import get_spec
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    cfg = TRAIN_MESH
    argv = ["--full", "--arch", MESH_ARCH, "--steps", str(cfg["steps"]),
            "--batch", str(cfg["batch"]), "--seq", str(cfg["seq"]),
            "--lr", str(cfg["lr"]), "--dtype", "bfloat16", "--device", DEV,
            "--n-layers", str(cfg["n_layers"]), "--devices", "2", "--tp",
            "2", "--checkpoint-every", "1000"]
    free(torch)
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_train_mesh, argv)
    seconds = time.perf_counter() - t0
    full = get_spec(MESH_ARCH)
    spec = full.scaled(n_layers=cfg["n_layers"])
    n_moe = sum(spec.moe.is_moe_layer(i) for i in range(spec.n_layers))
    steps = cfg["steps"]
    want = train_launches(spec, steps)
    out = []
    for r in ranks:
        what = f"train_mesh rank {r['rank']}"
        _expect(what, r["launches"], want)
        local_d_head = spec.d_head
        fwd = ("tensor_core" if flash_attention.tensor_core_route(
            torch.bfloat16, local_d_head) else "cuda_core")
        _expect_tensor_cores(what, r["routes"], "flash_attention",
                             want["flash_attention"], fwd)
        _expect_tensor_cores(what, r["routes"], "flash_attention_bwd",
                             want["flash_attention_bwd"],
                             flash_attention_bwd.route(torch.bfloat16,
                                                       local_d_head))
        for kernel in ("expert_gemm", "expert_gemm_bwd"):
            _expect_tensor_cores(what, r["routes"], kernel, want[kernel],
                                 route="wgmma")
        calls = r["collectives"]["calls"]
        a2a = (calls.get("all_to_all"), calls.get("all_to_all_bwd"))
        if a2a != (2 * n_moe * steps, 2 * n_moe * steps):
            raise AssertionError(f"{what}: token all-to-alls {a2a}, expected "
                                 f"{2 * n_moe * steps} each way")
        hist = r["history"]
        losses = [h["loss"] for h in hist]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{what}: losses {losses}")
        if r["checkpoint_step"] != steps - 1:
            raise AssertionError(f"{what}: the last step's checkpoint is "
                                 f"missing ({r['checkpoint_step']})")
        if not r["dispatch"].get("partition"):
            raise AssertionError(f"{what}: the tokens were not partitioned "
                                 f"({r['dispatch']})")
        first = [h["loss"] for h in ranks[0]["history"]]
        if any(abs(a - b) > 1e-6 * abs(b) for a, b in zip(losses, first)):
            raise AssertionError(f"{what}: losses {losses} part from rank "
                                 f"0's {first}: the ranks train different "
                                 "replicas")
        steady = hist[1:]
        step_s = _mean([h["dt"] for h in steady])
        coll_s = r["collectives"]["seconds"]
        emit("train_mesh", arch=MESH_ARCH, dtype="bfloat16",
             optimizer_state="float32", rank=r["rank"], coords=r["coords"],
             mesh={"data": 1, "model": 2}, n_layers=spec.n_layers,
             published_layers=full.n_layers, d_model=spec.d_model,
             experts_local=spec.moe.num_experts // 2, shard=r["shard"],
             params_rank=r["params"], steps=steps, batch=cfg["batch"],
             seq=cfg["seq"], lr=cfg["lr"], losses=losses,
             step_ms=step_s * 1e3, first_step_ms=hist[0]["dt"] * 1e3,
             **{f"{part}_ms": _mean([h[f"{part}_ms"] for h in steady
                                     if f"{part}_ms" in h])
                for part in ("forward", "backward", "grad_sync",
                             "optimizer")},
             collective_ms_per_step={
                 tag: sec * 1e3 / steps for tag, sec in coll_s.items()
                 if tag != "checkpoint"},
             collective_calls=calls,
             collective_mb={tag: b / 1e6 for tag, b in
                            r["collectives"]["bytes"].items()},
             checkpoint_gather_s=coll_s.get("checkpoint", 0.0),
             tokens_per_s=cfg["batch"] * cfg["seq"] / step_s,
             dispatch=r["dispatch"], build_s=r["build_s"], run_s=r["run_s"],
             peak_memory_gb=r["peak_memory_gb"], launches=r["launches"],
             routes=r["routes"], label=MESH_NOTE)
        out.append(r["launches"])
    emit("train_mesh_phase", seconds=seconds)
    return out


def ptxas_of(log, marker):
    """ptxas's lines (entry, registers, spills) of the kernels whose
    mangled names hold ``marker``."""
    out, keep = [], False
    for ln in log.splitlines():
        if "entry function" in ln:
            keep = marker in ln
        if keep and any(w in ln for w in ("entry function", "registers",
                                          "spill")):
            out.append(ln.strip())
    return out


def kernel_entry(name, mod, launches, profiles, top):
    """The kernels line's entry of one kernel: ``top`` names the profile
    whose numbers stand at the top level (all timed profiles follow)."""
    timed = {p: r for p, r in profiles.items() if "ms" in r}
    t = timed[top]
    return {"name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches,
            "max_abs_err": max(r["max_abs_err_bf16"]
                               for r in profiles.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "top_profile": top,
            "profiles": {p: {k: r[k] for k in
                             ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "max_abs_err_f32",
                              "max_abs_err_bf16", "max_abs_err_state_f32",
                              "max_abs_err_state_bf16") if k in r}
                         for p, r in timed.items()}}


def main(argv: list[str]) -> int:
    """No arguments: every phase.  ``--kernels a,b``: build, then only the
    kernel_check of the named kernels (no serve, no result line)."""
    only = None
    if argv[:1] == ["--kernels"] and len(argv) == 2:
        only = set(argv[1].split(","))
    elif argv:
        print("usage: chip_smoke.py [--kernels NAME,...]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    unknown = sorted((only or set()) - set(kernel_modules()))
    if unknown:
        print(f"chip_smoke.py: unknown kernels {unknown}; the kernels are "
              f"{sorted(kernel_modules())}", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    mods = kernel_modules()
    # the WKV backward's check runs the forward too; the expert GEMM's
    # backward runs the forward's source in f32
    wanted = None if only is None else only | (
        {"rwkv6_scan"} if "rwkv6_scan_bwd" in only else set()) | (
        {"expert_gemm"} if "expert_gemm_bwd" in only else set())
    names = sorted({Path(mod.SOURCE).stem for name, mod in mods.items()
                    if wanted is None or name in wanted})
    t0 = time.perf_counter()
    built = build.build_all(names)
    for name in names:
        build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         compile_seconds={n: b.seconds for n, b in built.items()},
         libraries=[str(b.path.relative_to(ROOT)) for b in built.values()],
         ptxas={n: [ln.strip() for ln in b.log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))]
                for n, b in built.items()},
         # hubert-xlarge's heads: the tensor-core walk's D = 80 kernels
         ptxas_flash_d80=(ptxas_of(built["flash_attention"].log, "Li80E")
                          if "flash_attention" in built else None),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    if only is not None:  # a short run: the named kernels' checks alone
        phase_kernel_check(torch, only)
        print(smi, flush=True)
        return 0
    checks = phase_kernel_check(torch)
    serves = [phase_decode_op(torch)]

    spec, model, init_s = build_full(torch, "minitron-8b")
    full = {"unified": phase_serve_unified(torch, model, spec, init_s,
                                           "serve_full")}
    serves += phase_serve_prefix(torch, model, spec)
    serves += phase_serve_spec(torch, model, spec)
    full.update(phase_serve_two_dispatch(torch, model, spec))
    serves += [stats["launches"] for stats, _ in full.values()]
    serves += phase_serve_kvq(torch, model, spec, full)
    serves += phase_serve_disagg(torch, model, spec, full["unified"][1])
    serves.append(phase_beam(torch, model, spec))
    base_outs = full["unified"][1]
    del model, full
    free(torch)
    phase_serve_parity(torch, "minitron-8b")
    phase_kvq_parity(torch, "minitron-8b")
    phase_prefix_parity(torch)
    phase_spec_parity(torch, "minitron-8b")
    phase_disagg_parity(torch)
    phase_beam_parity(torch)
    phase_debug_guards(torch)

    spec, model, init_s = build_full(torch, "deepseek-moe-16b")
    serves.append(phase_serve_unified(torch, model, spec, init_s,
                                      "serve_moe")[0]["launches"])
    del model
    free(torch)
    phase_serve_parity(torch, "deepseek-moe-16b")
    phase_kvq_parity(torch, "deepseek-moe-16b")
    phase_spec_parity(torch, "deepseek-moe-16b")
    phase_kvq_parity(torch, "mistral-7b-swa", modes=("dense", "paged"))

    spec, model, init_s = build_full(torch, "rwkv6-3b")
    serves += phase_serve_rwkv(torch, model, spec, init_s)
    del model
    free(torch)
    phase_serve_parity(torch, "rwkv6-3b")
    serves += phase_scenario(torch)

    serves += phase_serve_jamba(torch)
    serves += phase_serve_dense_registry(torch)
    serves += phase_encoder_frontend(torch)
    phase_registry_parity(torch)

    serves += phase_serve_tp(torch, base_outs)
    phase_tp_parity(torch)

    serves += phase_train(torch)
    serves += phase_train_parity(torch)
    serves.append(phase_train_restart(torch))
    for phase in TRAIN_STACKS:
        serves.append(phase_train_stack(torch, phase))
    serves += phase_mesh_parity(torch)
    serves += phase_train_mesh(torch)

    launches = {name: sum(c[name] for c in serves) for name in mods}
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: "
                             f"{idle}")
    tops = {"ragged_paged_attention": "decode",
            "paged_decode_attention": "decode", "flash_attention": "prefill",
            "expert_gemm": "mixed", "rwkv6_scan": "decode",
            "decode_attention": "decode",
            "flash_attention_bwd": "qwen_train",
            "expert_gemm_bwd": "granite_dx_broadcast",
            "rwkv6_scan_bwd": "train"}
    kernels = [kernel_entry(name, mod, launches[name], checks[name],
                            tops[name]) for name, mod in mods.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
