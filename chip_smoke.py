#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every phase.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any mismatch or exception exits non-zero; no phase catches its
own failure):

1. Build the Hopper kernels from the seven sources of
   ``src/repro_torch/csrc`` with ``nvcc`` (one process per source, started
   together; ``serve_route.cu`` holds ``serve_route`` and ``serve_slots``)
   and print the
   build time and the compiler's register and spill report; for each
   instance of the two flash kernels (bf16 on the tensor cores for dh, dv
   in {64, 128, 256}; float32 on the CUDA cores) its registers, spills
   and dynamic shared memory, and the same for the backward's D pass, its
   bf16 dq and dk/dv kernels (``wgmma``) and its float32 pair; and the
   launch floor (an empty block with
   the queue filled) that phases 2 and 7 print beside their kernels.
2. Hold each kernel against its plain PyTorch version on the card, on the
   same inputs, with exact equality (outputs are int32, bool, or float32
   sums of whole ``+1.0`` steps):
   ``jsaq_route`` (the level fill) at D=64, K=1000, N=256 with an
   all-ties row, on a staircase batch of that shape (23 rounds a row, the
   most), at D=16, K=1e5, N=4096, and at D=16, K=1e5 with a row's work
   space just under and just over the shared memory a block may opt in
   to, each also repeated, timed with the queue filled and from the host
   beside its bound (the bytes it moves), the dense bound of the chain it
   replaced and an empty launch (the floor), with its rounds a row;
   ``care_route`` for jsq/jsaq x six trigger kinds at D=8, K=300, T=500
   with mixed horizons; ``care_route`` at K=1e6, T=4000 for two runs;
   ``care_route`` on rows whose tiles rest and wake: rt and et_rt over
   K=1e5 (391 tiles), D=4, T=4000 with rt_period 37-250; then every kind
   at K=1000 with x <= 0 (every tile due every slot), rt_period 1, msr 1,
   horizons 0 and 1, a run with an arrival every slot and one with none,
   cap 1; and at K=6, cap 1, jobs of 8-12 slots, so jobs drop;
   ``serve_route`` for comm et / exact at D=4, R=1024, A=304 and at R=200,
   with an all-ties row, a row of full rings, a run with ``act=0``, a row
   with ``-0.0`` scores and runs with ``n_arr=0`` and ``n_arr=A``;
   ``serve_slots`` against the dense serving backend (its plain version),
   every output of ``_serve_core`` and the end-of-run routing state, one
   ``serve_slots`` launch and no ``serve_route`` launch each, on
   ``SLOTS_CASES`` of ``tests/test_torch_cuda.py`` (the card tests' cases
   and comparison): R in {1, 8, 31, 32, 33, 200, 1024, 1025, 2048},
   the six push kinds, decode rates, occupancy traced, ``rem`` / ``arid``
   in shared memory and (R=2048 x 16 decode slots) in device memory,
   rings of 2 that drop, horizons 0, 1 and mixed.
3. The main paths at the size their users run them, each with the launch
   counts set to 0 just before and read just after:
   the slotted simulator's mean-field sweep (``benchmarks/bench_route.py``):
   ``simulate_grid`` with the fused backend, load 0.95, deterministic jobs
   of 8 slots, DT-x with x in {2, 3} x 8 seeds (16 runs), FIFO cap 16,
   4000 slots, at K=1e5 and K=1e6; asserts Theorem 2.3 (max AQ <= x-1),
   conservation, and one ``care_route`` launch per call; times the kernel
   at the path's inputs (D=16, K=1e6) under dt and, with the comm kind
   switched, rt and et_rt (rt_period 100), each against its plain
   version, beside two bounds: the work these inputs need (35 operations
   for each server-slot not at rest or triggering at rest, counted by the
   plain version) and the dense work of the TPU kernel (every server every
   slot); profiles one fused grid call.
   Then the serving engine at ``serve/replicas1024`` of
   ``benchmarks/bench_serving.py``: ``serve_grid`` with the fused backend,
   1024 replicas x 16 decode slots, ring cap 128, load 0.9, mean prefill 4
   and decode 60, MSR drain 0.25, JSAQ with ET-4 and lowest-index ties,
   2048 slots, seeds (0, 1); asserts one ``serve_slots`` launch and no
   ``serve_route`` launch for the call, no drops, conservation and finite
   JCT; holds ``serve_slots`` against the dense backend over the whole
   horizon (every ring's cap is passed, so rings wrap), times both on it,
   prints the kernel's bound (the lane chain's work and the replica
   stage's) beside the dense bound of an argmin over R for each lane, and
   its microseconds per routed lane; times ``serve_route`` on the routing
   state ``serve_slots`` leaves after half the horizon (the middle slot's)
   against its plain version; times ``serve_slots`` with no arrival lane
   (its replica stage alone); profiles one ``serve_grid`` call for the
   device busy share.
3b. The streaming serving engine, with the launch counts set to 0 just
   before and read just after: ``serve_stream`` at ``serve/replicas1024``
   (phase 3's cell) on the fused backend, 16,384 slots in chunks of 4096,
   warmup 2048, seed 0; asserts 4 ``serve_slots`` launches and no other,
   no drops and conservation.  Held exactly against ``serve_one`` on
   ``StreamSampler.full(16384)``: every counter, the final occupancy, and
   the count, histogram and maximum of its JCTs past the warmup, the mean
   within 1e-4 and the std within 1e-3 (relative, float32 accumulators
   against float64); bit for bit (the whole carry) against chunks of 1024,
   one chunk, 8192 + 8192 resumed, and the stepped run (prefetch off).
   Times the pipelined and the stepped wall; the kernel in stream mode on
   chunk 0 (every slot folding) against the fixed horizon on the same
   slots, in turns, beside its bound; the plain version (the dense stream
   on the card) on the chunk's first 64 slots, the carry equal; the
   host's slab sampling a chunk.  Then the dense stream against the fused
   one at 64 replicas x 16, 500 slots, chunk 256; a degraded cell (crash
   faults, ET+RT, suspect masking) on the card against the CPU; and
   stream-mode ``serve_slots`` on ``SLOTS_CASES`` cut into uneven chunks
   against the dense stream on the CPU (``stream_vs_dense`` of
   ``tests/test_torch_cuda.py``).  Every carry field is equal; the float32
   mean and m2 within 1e-6 / 2e-5 (relative), since each slot's squared
   deviations are summed in the kernel's order.  Cuts: 16,384 slots (the
   reference's soak runs 1e6-1e7), the plain version on 64 slots (~80 ms a
   slot at 1024 replicas).
3c. The per-request dispatcher, ``dispatch_sim`` and the two examples
   (no kernel but the examples' own; every count printed, none added to
   the main paths'). ``run_serving_sim`` at ``examples/serve_care.py``'s
   cell (8 replicas x 16 decode slots, load 0.9, mean prefill 4 and
   decode 60, MSR drain 0.25, ET-4), 150 slots, seed 0, under JSAQ,
   SQ(2), RR and drain at 2:1 rates, JIQ, hsq, the ack wire (delay 2,
   jitter 1, drop 0.1, timeout 8, backoff 2, 6 retries, suspect_age 8)
   and crash faults (0.005 / 0.1, suspect_age 20) (``DISPATCH_CELLS`` of
   ``tests/test_torch_cuda.py``): each call equals the CPU in every
   returned field and the dense ``serve_one`` on the card in the JCT
   vector, messages, final occupancy and control counters; ms a slot on
   the card and on the CPU, and a profiled ET-4 call's device busy share.
   The dispatcher at ``serve/replicas1024``'s width (1024 x 16, cap 128,
   80 slots, lowest-index ties) against the fused ``serve_one`` (one
   ``serve_slots`` launch): JCT vector, messages and final occupancy
   equal; ms a slot and us a routed request.  ``dispatch_sim`` at
   ``bench_moe_balance.py``'s section B (E 64, D 8, T 256, k 8, 120 of its
   800 steps, 5 seeds in one ``dispatch_batch``; no_bias, off, exact, dt8,
   et4, et8):
   each regime equal to the CPU on the card's draws in every field, each
   et4 seed and the first seed of the others equal to ``simulate``,
   exact's messages D x steps and off's 0; prints each regime's wall, ms
   a step and the bench's aggregates and headline (not asserted).  Then
   ``python -m repro_torch.examples.quickstart --slots 2000`` and
   ``serve_care --slots 1000`` as subprocesses: exit 0, their closing
   lines, and serve_care's 30 ``flash_attention`` launches a prefill and
   none in decode (SmolLM-135M at its published widths); serve_care
   asserts its own golden replay.  Cuts: 150 slots (the example's
   default 20,000), 80 slots at full width (the bench's 2048), 120
   dispatch_sim steps (the bench's 800): halved because the whole run at
   1000 slots and 800 steps took 1250.8 s on an H100's host, past the
   1200 s limit, halved again when phase 9 came and a run took ~1150 s,
   and cut again when phase 10 (f)-(h) came and runs took 1052-1096 s.
4. The slotted dense backend against the fused one on the card, decision
   for decision, at K=200, T=1000, on Bernoulli arrivals and on MMPP
   arrivals under a diurnal curve (``MMPP_FUSED`` of
   ``tests/test_torch_cuda.py``, one ``care_route`` launch); then the
   paper's Section 9 cell (K=30, load 0.95, geometric sizes of mean 30,
   JSAQ with ET-3 and MSR, 5,000 slots: the paper's 20,000 cut with
   phase 3c's depth, as that run measured) on the dense backend.
4b. The slotted tier's breadth on the dense backend (no kernel: every
   launch count stays 0), the Section 9 setting (K=30, cap 2048, geometric
   sizes of mean 30 unless stated, load 0.95 unless stated) at 4 seeds x
   800 slots, one ``simulate_grid`` call per static kind: SQ(2) (and a
   diurnal cell at load 0.9, amp 0.1, period 2000), random, MMPP bursts of
   intensity 1.7 under JSAQ + ET-3 + MSR and SQ(2), rates 1.5 / 0.5 on
   the two halves under rate-aware JSAQ + ET-3 + MSR and SQ(2), Pareto
   alpha {1.5, 3} x ET-{2, 3, 8}, Weibull shape 0.5, JIQ and hsq at load
   0.9, two classes on servers 0-19 and 10-29.  Each call is held against
   ``run_draws`` on the CPU on its draws, every ``SimResult`` field equal;
   asserts conservation, max AQ <= x-1 under ET (Prop 6.8), SQ(2)'s 4
   messages an arrival, JIQ's messages <= departures, token counters >= 0,
   the fast half's share of arrivals under rate-aware JSAQ, and that no
   class routes outside its affinity.  Profiles an SQ(2) call of 100
   slots (device busy share, device operations a slot).  Then SQ(2) at
   K=1e5, cap 16, 2 seeds x 1000 slots: the draws' peak device memory
   stays O(N T d).
4c. The degraded control plane on both dense backends (no kernel: every
   launch count stays 0), each call against the CPU on the same draws,
   every result field equal.  Slotted, at the Section 9.1 setting (K=30,
   load 0.95, geometric sizes of mean 30, cap 2048), 4 seeds x 400
   slots, one ``simulate_grid`` call per static kind: CARE (JSAQ + ET-3 +
   MSR) over the delay ladder {1, 4, 8, 16} and the drop ladder {0, 0.1,
   0.3, 0.5} at delay 2 (``benchmarks/bench_faults.py:104-170``); SQ(2)
   with RT at 1e-4 over the delay ladder; the ack ladder, drop {0.1, 0.3,
   0.5} at delay 2, jitter 1, timeout 8, backoff 2, 6 retries, and JIQ at
   load 0.9 fire-and-forget and ack at drop 0.1
   (``bench_retrans.py:53-80``); crash (0.005 / 0.1, suspect_age 20) and
   slow (0.01 / 0.1, factor 0.5) cells (``tests/test_faults.py:594-595``).
   Asserts conservation, drops wherever drop > 0, retransmits in every ack
   cell with drops, SQ(2)'s >= 4 messages an arrival, token counters >= 0,
   and in the crash cell no arrival routed to a suspect server while one
   was healthy (counted at every routed arrival on the card).  The
   zero-operand network and a silent fault chain equal ``none`` bit for bit
   on the card, on both tiers.  Serving: ``bench_pull.py:68-92``'s
   frontier, 8 replicas x 16 decode slots, load 0.9, CARE / SQ(2) / JIQ /
   hsq, degraded (delay 2, drop 0.1, suspect_age 8) and clean, 4 seeds x
   300 slots; ``bench_faults.py:203-240``'s engineered crash / recovery
   (800 slots, a third of its quick 2500) through ``serve_one`` with suspect masking on
   and off and a fault-free control.  Then CARE with delay 4 and drop 0.1 at K=1e5, cap 16, 2 seeds
   x 1000 slots, with the draws' and the call's peak device memory.
5. The serving bench's ET ladder (``bench_serving._ladder``): 8 replicas,
   load 0.9, ET-x for x in {2, 4, 8, 16} x 4 seeds as one fused grid call,
   20,000 slots, then the exact-state grid call on the same workloads
   (messages must equal completions), one ``serve_slots`` launch each;
   prints ``et_comm_vs_exact``.
6. The serving dense backend against the fused one (one ``serve_slots``
   launch) on the card, field for field, at 64 replicas x 16 decode slots,
   500 slots, comm et / dt / exact, seeds (0, 1).
7. The MoE serving path (``repro_torch.models``): DeepSeek-V2 at its
   published widths (bf16, d_model 5120, 128 heads, MLA, 160 routed + 2
   shared experts, top-6 softmax) with the depth cut to 3 layers (one
   dense, two MoE), initialised on the card from a seed.  4 prompts of 512
   tokens; prefill #1 without bias, its routed counts fed to the CARE
   balancer, prefill #2 with the balancer's selection bias, then greedy
   decode of 16 tokens each (cache 528).  Asserts one ``moe_route`` launch
   per MoE layer per prefill and per decode step (one launch returns the
   route, the counts and each (token, slot)'s capacity position), finite
   logits, the kernel's outputs on the path (T=2048 and T=4) against its
   plain versions (ids, counts and positions equal, weights within 1e-5),
   and the same at DeepSeek-V3's shape (T=2048, E=256, k=8, sigmoid) with
   ties and a 1e9 bias, at T=16384 (a 4 x 4096 chunk), T=1, bf16 logits,
   an all-ties batch and rows that take an expert twice, and a later call
   against the path's (no state left in the kernel's scratch); times the
   kernel at those T, an empty launch (the floor) and the torch sequence
   the kernel replaced (one_hot ... sum), prints the expert load per layer
   and a profiler window of one prefill and one decode step (its device
   operations; it fails on an ``aten::one_hot`` or ``aten::cumsum``).
   Then the same model in float32 with each expert's
   capacity raised to T (no token dropped): prefill over S against prefill
   over S-1 and one ``decode_step``, within 2e-2.
8. The dense GQA serving path (``repro_torch.models``): Gemma2-9B at its
   published widths and full depth (bf16, d_model 3584, 42 layers, 16
   heads / 8 KV of width 256, window 4096 on even layers, attention softcap
   50, final softcap 30, GeGLU 14336, vocab 256000, tied embedding),
   initialised on the card from a seed after phase 7's models are freed.
   2 prompts of 8064 tokens, prefill into a cache of 8192, then 16 greedy
   decode steps (positions 8064-8079, past the window).  Asserts 42
   ``flash_attention`` launches for the prefill and none in decode, finite
   logits, the kernel against its plain version on the path's own q/k/v
   of a local and a global layer (B=1, 2e-2 in bf16) and on further
   shapes (float32 within 2e-5, dh 64 with GQA group 3, dh 128, non-causal
   dv != dh, ragged S=T=8000, S=1, window 100, softcap on and off, rows
   with no key, small ragged S and T); times the float32 kernel at its
   case (TFLOP/s and bound / kernel, softcap 50 and 0), and the bf16
   kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (softcap 0; the window as a mask) at
   the path's shapes beside their bound, with TFLOP/s, bound / kernel and
   kernel / SDPA; times the float32 kernel and float32 SDPA (the window as
   a mask) at the float32 case with softcap 0; prints the prefill wall, decode ms a token and a
   profiler window of one prefill and one decode step.  ``ops.flash_attention``
   on each tensor-parallel rank's heads of the global layer at TP 2 and 4
   (8 and 4 query heads over 4 and 2 KV heads) equals those heads of the
   whole-head call bit for bit; each rank's call is timed beside the whole
   call's.  Then the same
   model in float32:
   prefill over S=4224 (B=1, past the window) against prefill over S-1
   and one ``decode_step``, within 2e-2.
8b. The hybrid, attention-free and encoder-decoder families
   (``repro_torch.models``) at published widths and full depth, bf16,
   each initialised on the card from a seed after phase 8's model is
   freed, each with the launch counts set to 0 just before its prefill
   and read after its 16 greedy decode steps.  Hymba-1.5B (32 layers of
   parallel GQA, 25 heads over 5 KV heads of width 64, and Mamba heads;
   window 1024, layers 0, 15 and 31 global): 2 prompts of 2048 tokens
   into a cache of 2064; asserts 32 ``flash_attention`` launches for the
   prefill (3 global, 29 local) and none in decode.  Whisper-small (12
   encoder and 12 decoder layers of width 768): 4 x 1500 frame embeddings
   from the seed, decoder prompts of 432 into a cache of 448; asserts 36
   launches a prefill (12 non-causal encoder, 12 causal decoder, 12
   cross-attention) and none in decode.  RWKV6-1.6B (24 layers,
   attention-free): 2 prompts of 2048 (the chunked WKV form); asserts
   that every count stays 0.  Finite logits throughout.  The kernel
   against its plain version within 2e-2 on the paths' own q/k/v: Hymba's
   global and local layer (GQA group 5), Whisper's encoder (S = T = 1500,
   non-causal), decoder self-attention and cross-attention (S = 432, T =
   1500); each timed beside its bound, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (the window as a mask).  Prints each
   model's parameter count, prefill wall and decode ms a token, and a
   profiler window of one Hymba prefill and one decode step (device busy
   share), the Mamba calls' share of one prefill (CUDA events around each
   layer's call), and one Mamba layer alone at the prefill's shape (device
   operations a token).  Then each model in float32: prefill over S
   against prefill over S-1 and one ``decode_step`` within 2e-2, at S =
   1100 (Hymba, past the window), 64 (Whisper) and 256 (RWKV: the chunked
   form against the sequential scan and the state hand-off).
9. Training, after phase 8b's models are freed.  Each backward
   kernel against its plain version (``FLASH_BWD_CASES`` / ``MOE_BWD_CASES``
   of ``tests/test_torch_cuda.py``): ``flash_attention_bwd`` at
   SmolLM-135M's training shape (B 1, S 2048, 9 heads over 3 KV heads of
   64, causal, bf16), Gemma2's dh 256 with window 4096 and softcap 50 (S
   1024) and a window that masks, Hymba's GQA 5 local, Whisper's
   non-causal encoder (S = T = 1500) and cross-attention (S 432, T 1500),
   float32, odd float32 widths, S = 1, rows with no key and dh 128 with a
   window over ragged tiles, within 2e-2 (bf16) and 1e-4 (float32) of the
   largest of dq, dk and dv, and two calls equal bit for bit at SmolLM's
   and Gemma2's dh 256 shapes;
   ``moe_route_bwd`` at DeepSeek-V2's (T 2048, E 160, k 6, softmax) and
   V3's (E 256, k 8, sigmoid) shapes, a microbatch of 16,384 tokens, T =
   1, all-tied batches, E 67 and E 3, routes that name an expert twice
   and logits off a 16-byte boundary, each within atol 1e-6 / rtol 1e-5
   and two calls equal bit for bit.  Then
   two train steps on the card against the same steps on the CPU
   (``train_step_card_vs_cpu``: SmolLM-135M's and DeepSeek-V2's reduced
   configs in float32, the balancer sync off and on, 1 and 2
   microbatches): loss, ``grad_norm``, ``lr``, parameters, ``m``, ``v``
   and the balancer within 1e-4, routed counts equal.  Then SmolLM-135M
   at its published width and full depth (bf16, seed 0) through
   ``repro_torch.launch.train --full-size``, 8 x 2048 tokens a step, 12
   steps, a checkpoint every 4, a crash after step 8, a relaunch that
   resumes, and an uninterrupted run with the launch counts set to 0
   just before and read just after: 30 ``flash_attention`` and 30
   ``flash_attention_bwd`` launches a step, no plain version called,
   finite losses, the last below the first, the resumed losses equal to
   the uninterrupted run's within ``TRAIN_RESUME_RTOL``; prints ms a
   step, tokens/s, peak memory, a profiled step's device busy share and
   the backward kernel's share, AdamW's share (CUDA events), and the
   backward kernel at the path's shape (layer 0's q/k/v, B 8) beside its
   bound (and bound / kernel, TFLOP/s), its plain version, SDPA's own
   backward and the CUDA-core design's time, each of its three launches'
   device time (the D pass's share), and the forward there with and
   without its lse.  Then
   ``moe_route_bwd``'s time at DeepSeek-V2's and V3's shapes and at 16,384
   tokens (``MOE_BWD_TIMED``), each beside its bound and its plain
   version, and
   ``repro_torch.examples.train_moe_care`` as a subprocess at
   ``tests/test_examples.py``'s sizes (exit 0, "[done]", one
   ``moe_route`` and one ``moe_route_bwd`` launch per MoE layer per
   step).
10. The parallel context on one card (``models/parallel.py``,
   ``launch/mesh.py``): a world-size-1 NCCL process group (a failure to
   start it fails the phase; no gloo or CPU fallback), a (1, 1)
   ``DeviceMesh`` on the card, DeepSeek-V2's context from
   ``make_context`` and one ``all_reduce`` over its dispatcher grid.
   Phase 7's model (published widths, 3 layers, bf16, seed 0) with a
   random CARE bias under the context and with ``ctx=None``, after a
   warm-up: prefill of phase 7's 4 x 512 prompts, 4 greedy decode steps,
   and ``train_loss`` with the gradient of every parameter at 2 x 128
   tokens; the launch counts set to 0 just before the context's run and
   read just after (``moe_route`` 2 + 4 a MoE layer, ``moe_route_bwd``
   one).  Every routed id and count equal, the training counts as one
   dispatcher's ``(L, 1, 1, E)`` rows, logits, loss and gradients within
   1e-4 of each one's largest magnitude; ``moe_route`` against its plain
   version on the context's own inputs.  Then one train step of the
   reduced config (float32, balancer sync on; AdamW's moments as ZeRO-1
   blocks) under the context against ``ctx=None``, and
   ``repro_torch.launch.train --mesh 1,1`` against the same run without
   a mesh.  Then SmolLM-135M (published width and depth, bf16, seed 0)
   under a (1, 1) dense context against ``ctx=None``: one TP rank takes
   the unsplit path (``partitioning.tp_layout`` gives no layout), so this
   holds that path's equality, not the split arithmetic (the gloo tests
   hold that): a prefill of 2 x 512, 4 decode steps and ``train_loss``
   with every gradient at 2 x 256, each under the op recorder with the
   launch counts set to 0 just before: logits, loss and gradients equal
   bit for bit, the same launches (60 ``flash_attention``, 30
   ``flash_attention_bwd``), no collective issued.  Then decode's
   log-sum-exp softmax of a row-split cache (``attention._sdpa_seq_split``
   over a group of one) against the plain softmax at Gemma2-9B's global
   layer.  Then the MoE family's split arithmetic at published width,
   the ranks simulated in this process through the functions they call:
   DeepSeek-V2's absorbed MLA decode on a cache of 2 x 8192 rows in 4 row
   blocks (each block's scores and partial softmax, combined by
   log-sum-exp in float32) against the plain ``mla_decode``, and one MoE
   layer's 160 experts in 16 blocks of 10 (``ffn._moe_local`` on each
   block's weights: the whole batch routed, its experts' buffers only),
   the shares of ``y`` on 128 decode tokens added, against the whole
   layer (~7.5 GB of bf16 weights), each within 1e-2 of the largest
   magnitude.  Then the other families' blocks the same way (bf16,
   published width, 2 x 2048 tokens, ``tests/test_torch_cuda.py``'s
   helpers): RWKV6-1.6B's time and channel mix as 16 ranks of 2 WKV heads
   and 448 hidden units (each rank's chunked WKV heads and state against
   the whole call's, the summed ``wo`` and ``wv`` products against the
   whole layer), Hymba-1.5B's Mamba layer as 16 blocks of 200 inner
   channels (summed ``xdbc`` and outputs), each within 1e-2 of the
   largest magnitude, rank 0's layer timed against the whole layer's;
   and Whisper-small's encoder self-attention (S = T = 1500) and
   cross-attention (S 432, T 1500) through ``ops.flash_attention`` on
   each rank's heads at TP 2 and 4, bit for bit, each call timed.
   Expert and tensor parallelism across ranks (``ep`` or ``tp > 1``)
   need more than one card: the CPU tests run them over gloo ranks.
11. The dry run against the card (``launch/dryrun.py``).  Phase 9's
   SmolLM-135M train step (8 x 2048, full width and depth, bf16, no
   context) traced on fake CUDA tensors (no kernel launched), then run for
   real under the same ``FlopCounterMode`` and op recorder: the FLOPs
   equal exactly, and each of the 60 kernel calls' fake outputs has its
   real launch's shapes, dtypes and strides.  Prints the predicted and
   measured peak memory and their ratio, the roofline's three terms at
   H100 peaks (``launch/roofline.py``), the median of three real steps
   and the step's roofline share (6ND over the peak times the step).
   Then ``smollm-135m / train_4k``, ``deepseek-v2-236b / decode_32k`` and
   ``gemma2-9b / decode_32k`` on the 256-rank production mesh (a fake
   process group; each rank its dp block of the rows and its TP and
   expert blocks), with their records' totals, collective bytes by group
   (dp, TP, EP) and trace seconds: SmolLM's FLOPs a rank at most 9.15e13
   beside the reference chip's 7.817e13; each decode cache 1/256 of the
   whole batch's (rows over dp, the sequence over TP); a DeepSeek-V2
   decode rank's arguments at most 6.5e9 B and its FLOPs at most 1.0e12.
12. Print the kernels line (launch counts from the main paths, parity,
   times and bounds; ``serve_slots`` also carries phase 3b's stream-mode
   launches, ms a chunk, bound, plain time and error under ``stream_*``;
   ``flash_attention`` also carries phase 8b's launches per model under
   ``family_launches`` and the kernel, plain, bound and SDPA times at its
   shapes under ``family_shapes``, and its ``max_abs_err`` covers both
   phases; ``flash_attention_bwd`` and ``moe_route_bwd`` carry phase 9's
   launches, times and bounds, and the training step's numbers under
   ``train_*``; ``moe_route``, ``moe_route_bwd``, ``flash_attention`` and
   ``flash_attention_bwd`` carry phase 10's launches under
   ``parallel_launches``, and ``flash_attention`` phase 8's rank-heads
   check under ``tp_heads``), the card's name and power limit, and the
   contract line last.

Exits non-zero without printing a result when no CUDA card is present or
when the port's sources are not beside this script.
"""
from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Roofline inputs: NVIDIA H100 SXM data sheet.  Device memory 3.35 TB/s.
# The card issues at most 33.5e12 32-bit lane operations per second outside
# the tensor cores (its float32 rate of 67 TFLOP/s counts each fused
# multiply-add as two); integer compares, adds and selects run at that
# rate or below, so it bounds the integer work of both kernels.
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 33.5e12
# Dense peaks of the same data sheet: bf16 on the tensor cores, float32 on
# the CUDA cores (the attention bounds count useful matmul FLOP only).
BF16_TENSOR_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# Integer operations per server per active slot that the fused CARE loop
# must do (counted from _care_kernel): argmin scan 2; service 10 (busy
# test, decrement, departure test, queue decrement, next-job reset);
# emulation drain 8; trigger and snap 10 (error, two counter updates, the
# comparison, two counter resets, two snaps); slot metrics 5.  The bound
# counts them for each server-slot these inputs need (not at rest, or at
# rest and triggering); the TPU kernel's dense schedule, every server every
# slot, is printed beside it.
CARE_OPS_PER_SERVER_SLOT = 35
# jsaq_route: its bound is the bytes it must move, 4 (2 D K + D N) (the
# level fill's operations, a few per server and per job, take less time);
# the dense work of the chain it replaced, one compare and one select per
# server per routed job, is printed beside it.
JSAQ_OPS_PER_SERVER_JOB = 2
# Its device time (the queue filled) over JSAQ_TIME_REPS launches, and its
# time from the host (CUDA events around JSAQ_HOST_REPS calls, the host's
# cost per call included), which is the kernels line's ms.
JSAQ_TIME_REPS = 100
JSAQ_HOST_REPS = 20
# serve_route's and serve_slots' lane chain (csrc/serve_lanes.cuh), counted
# from what it reads: per slot of a run, each replica's key and its
# sub-block's minimum (a compare and a select a replica); per routed lane,
# two 32-wide warp reductions (the least key, then its lowest owner; 32
# operations each) and a compare and a select for each entry its rescan
# reads: 32 and, above R = 1024, ceil(R / 1024) sub-block minima.  The TPU
# kernel's dense schedule, an argmin over all R replicas for each lane
# (SERVE_OPS_PER_REPLICA_LANE x R), is printed beside it.
SERVE_OPS_PER_ENTRY = 2
SERVE_OPS_PER_LANE_REDUCTION = 32
SERVE_OPS_PER_REPLICA_LANE = 2
# serve_slots' replica stage, counted from _serve_core's steps 2-5: per
# decode slot 12 (free test and rank, the FIFO take test and two selects,
# the active test, the decrement, the done test, the completion count, the
# arid reset, the busy count); per replica 19 (n_admit, q_head and q_len
# updates 3; drain 4: busy test, product, difference, clamp; trigger and
# snap 11: true occupancy 2, error 2, two counter updates, the comparison,
# two counter resets, the snap, the message count; the occupancy row 1).
# The bound counts them for every replica of every slot a run is active,
# beside the lane chain's operations.
SERVE_SLOT_OPS_PER_REPLICA = 19
SERVE_SLOT_OPS_PER_DECODE_SLOT = 12
# serve_slots' stream-mode fold, counted from the kernel: per measured
# completion 13 (the JCT 2; count, sum and maximum 3; the bucket 5: clz,
# shift, mask, multiply-add, select; the histogram add 1; the second pass's
# deviation and square-add 2), beside the stage and the chain.
SERVE_FOLD_OPS_PER_COMPLETION = 13

KINDS = ("rt", "dt", "et", "et_rt", "exact", "none")
# The backward kernels' counts, which no serving path may move.
NO_BWD = {"moe_route_bwd": 0, "flash_attention_bwd": 0}

# Shapes of the phases (see the module docstring).
JSAQ_SHAPE = (64, 1000, 256)  # D, K, N
CARE_SMALL = (8, 300, 500)  # D, K, T
CARE_FULL = (2, 1_000_000, 4000)  # D, K, T
# Rows that rest and wake: rt / et_rt over many tiles (D, K, T; each row
# [x, rt_period, msr, horizon]); edge rows at cap 1; rows that drop at cap 1.
CARE_WAKE = (4, 100_000, 4000)
CARE_WAKE_ROWS = [[2, 100, 8, 4000], [3, 37, 8, 4000], [2, 100, 8, 3000], [1, 250, 3, 4000]]
CARE_EDGE = (6, 1000, 600)
CARE_EDGE_ROWS = [[0, 100, 8, 600], [-1, 3, 4, 600], [2, 1, 1, 600], [3, 5, 1, 1],
                  [1, 7, 8, 0], [2, 9, 8, 600]]
CARE_DROP = (4, 6, 600)
CARE_DROP_ROWS = [[2, 5, 8, 600], [0, 3, 8, 600], [3, 1, 12, 600], [1, 7, 8, 300]]
MAIN_KS = (100_000, 1_000_000)
MAIN_SLOTS = 4000
# Phases 4 and 6: halved again (T 2000, 10,000 and 1000 slots) when a
# whole run with phase 10 (f)-(h), the kernels' build included, took
# 1048.4 s.
DENSE_VS_FUSED = (200, 1000)  # K, T
SECTION9_SLOTS = 5000  # the paper's 20,000 quartered: see DISPATCH_SLOTS
# Phase 4b: the paper's Section 9 setting (K = 30, cap 2048, geometric sizes
# of mean 30) on the dense backend, cut from the benches' 20,000-100,000
# slots to 4 seeds x 800 (the dense loop takes ~1.7-3.8 ms a slot on the
# card; 4000 until phase 4c came and the whole run passed 600 s, 2500
# until phase 9 came and a whole run took ~1150 s, 1250 until a whole run
# with phase 10 (f)-(h) took 1048.4 s); then SQ(2) at K = 1e5, cap 16, 2
# seeds x 1000 slots, for width.
BREADTH_SLOTS = 800
BREADTH_SEEDS = (0, 1, 2, 3)
BREADTH_PROFILE_SLOTS = 100  # the profiled SQ(2) call; the profiler slows the loop many fold
BREADTH_WIDE = dict(servers=100_000, buffer_cap=16, slots=1000, load=0.95,
                    policy="sq2", comm="none")
BREADTH_WIDE_SEEDS = (0, 1)
# Phase 4c: the degraded control plane on the dense backends, the benches'
# cells (Section 9.1 setting for the slotted tier; bench_pull's and
# bench_faults' serving cells) cut from the benches' 20,000-100,000 slots
# to 4 seeds x DEGRADED_SLOTS (slotted) and SERVE_DEGRADED_SLOTS (serving),
# the engineered crash / recovery to half bench_faults' quick 2500 slots
# (the phase took 333 s with 4000 slots everywhere, 178 s at 2000 / 1500,
# and 225 s at 1500 / 1000 / 2500 in a whole run of ~1150 s once phase 9
# came, so each was halved again; cut again to 400 / 300 / 800 / 300 when
# phase 10 (f)-(h) came and whole runs took 1052-1096 s); the
# identity checks at IDENTITY_SLOTS; the width check at K = 1e5, cap 16,
# 2 seeds x 1000 slots.
DEGRADED_SLOTS = 400
DEGRADED_SEEDS = (0, 1, 2, 3)
SERVE_DEGRADED_SLOTS = 300
CRASH_SLOTS = 800
IDENTITY_SLOTS = 300
DEGRADED_WIDE = dict(servers=100_000, buffer_cap=16, slots=1000, load=0.95,
                     mean_service=30, policy="jsaq", comm="et", x=3, network="net",
                     net_delay=4, net_drop=0.1)
DEGRADED_WIDE_SEEDS = (0, 1)
# A lossy cell must have dropped a message once it has sent this many (at
# drop 0.1, all get through with probability 0.9^100 < 3e-5); JIQ's tokens
# at serving load 0.9 are this rare (a replica of 16 decode slots is
# never idle).
DROP_CHECK_MSGS = 100
SERVE_PARITY = ((4, 1024, 304), (4, 200, 304))  # D, R, A
SERVE_MAIN = dict(replicas=1024, decode_slots=16, slots=2048, queue_cap=128)
SERVE_MAIN_SEEDS = (0, 1)
SERVE_WORK = dict(load=0.9, mean_prefill=4, mean_decode=60, msr_drain=0.25)
LADDER_SLOTS = 20_000
LADDER_X = (2, 4, 8, 16)
LADDER_SEEDS = (0, 1, 2, 3)
SERVE_DENSE_VS_FUSED = dict(replicas=64, decode_slots=16, slots=512, queue_cap=128)
# Phase 3b: serve_stream at serve/replicas1024 (SERVE_MAIN's cell), its
# rechunkings and resume, the dense stream at SERVE_DENSE_VS_FUSED.
STREAM_SLOTS = 16_384
STREAM_CHUNK = 4096
STREAM_WARMUP = 2048
STREAM_SEED = 0
STREAM_RECHUNK = 1024
STREAM_DENSE_CHUNK = 256
STREAM_TIME_REPS = 3
STREAM_PLAIN_SLOTS = 64  # the dense loop takes ~80 ms a slot at 1024 replicas
# Phase 3c: the per-request dispatcher at examples/serve_care's cell for
# 250 slots (the reference runs 20,000) and at serve/replicas1024's width
# for 128 slots (the bench runs 2048); dispatch_sim at bench_moe_balance's
# section B for 200 of its 800 steps, 5 seeds; the examples at
# tests/test_examples.py's sizes.  With 1000 slots, 800 steps and Section
# 9's 20,000 slots the whole run took 1250.8 s on an H100's host (phase 3c
# 285.2 s, Section 9 50.7 s), past the 1200 s limit; halved, the earlier
# runs took 777-872 s; with phase 9 a whole run took ~1150 s (phase 3c
# 186 s), so the dispatcher's slots and dispatch_sim's steps were halved
# again; with phase 10 (f)-(h) they were cut to 150 / 80 slots and 120
# steps (whole runs had taken 1052-1096 s).
DISPATCH_SLOTS = 150
DISPATCH_WIDE_SLOTS = 80
MOE_DISPATCH_STEPS = 120
MOE_DISPATCH_SEEDS = 5
EXAMPLE_TIMEOUT_S = 600
# Phase 7: DeepSeek-V2 serving at published widths, depth cut to one dense
# and two MoE layers; 4 prompts of 512 tokens (2048 routed tokens a MoE
# layer), greedy decode of 16 tokens each into a cache of 528.
MOE_ARCH = "deepseek-v2-236b"
MOE_LAYERS = 3
MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_CACHE = 4, 512, 16, 528
MOE_SEED = 0
MOE_TIME_REPS = 100
# A 4 x 4096-token prefill chunk: 4 tokens a warp on the card.
MOE_LONG_T = 16384
# moe_route_bwd's timed cases (tests/test_torch_cuda.MOE_BWD_CASES), the
# first the kernels line's: DeepSeek-V2's and V3's shapes and a training
# microbatch of MOE_LONG_T tokens.
MOE_BWD_TIMED = ("deepseek_v2", "deepseek_v3", "long")
# moe_route: per logit, the gate (max, subtract, exp, sum, divide) and the
# score (subtract) are 6 operations; each of the k sweeps compares and
# selects (2 more).  Per (token, slot) entry, its position takes a match,
# a rank add and the add of its block's prefix (3).
MOE_OPS_PER_SCORE = 6
MOE_OPS_PER_ENTRY = 3
# Phase 8: Gemma2-9B serving at published widths and full depth; 2 prompts
# of 8064 tokens (63 x 128) into a cache of 8192, 16 greedy decode steps;
# then a float32 rebuild for prefill over S=4224 against decode.
DENSE_ARCH = "gemma2-9b"
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW, DENSE_CACHE = 2, 8064, 16, 8192
DENSE_SEED = 0
DENSE_F32_PROMPT = 4224
FLASH_TIME_REPS = 5
TP_HEAD_SPLITS = (2, 4)  # phase 8: flash_attention on one rank's heads at these TP widths
# Further shapes of the kernel against its plain version: name, (B, S, T, H,
# KVH, dh, dv), dtype, options (the scale is 1 / sqrt(dh)).
FLASH_CASES = [
    ("float32 dh 256, window 1000, softcap 50", (1, 2048, 2048, 16, 8, 256, 256), torch.float32,
     dict(causal=True, window=1000, softcap=50.0)),
    ("dh 64, GQA group 3 (smollm)", (2, 2048, 2048, 9, 3, 64, 64), torch.bfloat16,
     dict(causal=True)),
    ("dh 128 (qwen3)", (2, 2048, 2048, 16, 8, 128, 128), torch.bfloat16, dict(causal=True)),
    ("non-causal, dh 64, dv 128", (1, 512, 1024, 4, 2, 64, 128), torch.bfloat16,
     dict(causal=False)),
    ("ragged S=T=8000, window 4096, softcap 50", (1, 8000, 8000, 16, 8, 256, 256),
     torch.bfloat16, dict(causal=True, window=4096, softcap=50.0)),
    ("S=1 against T=8064, non-causal", (2, 1, 8064, 16, 8, 256, 256), torch.bfloat16,
     dict(causal=False)),
    ("S=T=1", (1, 1, 1, 16, 8, 256, 256), torch.bfloat16, dict(causal=True)),
    ("window 100", (1, 1024, 1024, 16, 8, 256, 256), torch.bfloat16,
     dict(causal=True, window=100)),
    ("no key: S=300 past T=100 + window 20", (1, 300, 100, 2, 1, 64, 64), torch.bfloat16,
     dict(causal=True, window=20)),
    ("ragged S=77, T=45, dh 64, dv 128", (1, 77, 45, 3, 3, 64, 128), torch.bfloat16,
     dict(causal=True)),
    ("ragged S=T=200, window 37, softcap 50", (1, 200, 200, 4, 2, 256, 256), torch.bfloat16,
     dict(causal=True, window=37, softcap=50.0)),
]
# Phase 8b: Hymba-1.5B, Whisper-small and RWKV6-1.6B at published widths and
# full depth, bf16, 16 greedy decode steps each; then a float32 rebuild of
# each for prefill over S against prefill over S-1 plus one decode step.
# Hymba: 2 prompts of 2048 tokens into a cache of 2064 (past the 1024
# window), float32 S = 1100.  Whisper: 4 x 1500 frame embeddings, decoder
# prompts of 432 into a cache of 448 (the published text context), float32
# S = 64.  RWKV: 2 prompts of 2048 (the chunked WKV form, 64 chunks a
# layer), float32 S = 256 (chunked) against 255 (the sequential scan).
FAMILY_SEED = 0
FAMILY_NEW = 16
HYMBA = dict(arch="hymba-1.5b", batch=2, prompt=2048, cache=2064, f32_prompt=1100)
WHISPER = dict(arch="whisper-small", batch=4, prompt=432, cache=448, f32_prompt=64)
RWKV = dict(arch="rwkv6-1.6b", batch=2, prompt=2048, cache=2048, f32_prompt=256)
# Phase 9: training.  SmolLM-135M at its published width and full depth
# (the JAX launcher's default arch, --full-size), bf16, from seed 0; batch
# 8 x 2048 tokens (SmolLM's training context); 12 steps, a checkpoint every
# 4, a crash after step 8 and a relaunch, then 12 uninterrupted steps.  The
# resumed losses must equal the uninterrupted run's within
# TRAIN_RESUME_RTOL: every kernel of the step is deterministic (the two
# backward kernels use no atomics), but the embedding's gradient is an
# index_put_ with accumulate on the card, whose float sums PyTorch does not
# promise to order the same way twice.
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--full-size", "--steps", "12", "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--ckpt-every", "4", "--log-every", "4"]
TRAIN_CRASH_AT = 8
TRAIN_RESUME_RTOL = 1e-3
BWD_TIME_REPS = 5
# The example at tests/test_examples.py's sizes.
TRAIN_EXAMPLE_ARGS = ["--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "2"]
# Phase 10: the parallel context on one card (a world-size-1 NCCL group, a
# (1, 1) DeviceMesh).  Phase 7's model and prompts, PARALLEL_NEW decode
# steps, a forward and backward at PARALLEL_TRAIN (batch, seq) tokens, then
# a train step and the launcher at the reduced config.
PARALLEL_NEW = 4
PARALLEL_TRAIN = (2, 128)
PARALLEL_TOL = 1e-4
PARALLEL_DENSE_ARCH = "smollm-135m"  # phase 10 (d): a dense decoder under the (1, 1) context
PARALLEL_DENSE_PROMPT = (2, 512)
PARALLEL_DENSE_TRAIN = 256
PARALLEL_WALL_ROUNDS = 10  # (ctx=None, context, context, ctx=None) rounds of phase 10's walls
PARALLEL_LAUNCH_ARGS = ["--arch", MOE_ARCH, "--steps", "3", "--batch", "2", "--seq", "32",
                        "--log-every", "0", "--lr", "1e-2"]
# About 25 ms at the H100's 1.98 GHz: longer than the host takes to
# enqueue MOE_TIME_REPS launches (~35 us each).
SLEEP_CYCLES = 50_000_000


def _time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, ref) -> float:
    err = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(
                f"{tuple(g.shape)} {g.dtype} != {tuple(r.shape)} {r.dtype}"
            )
        if g.numel():
            err = max(err, float((g.double() - r.double()).abs().max()))
    return err


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / LANE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _care_bound(arrive, params, k: int, server_slots: int) -> tuple[float, str]:
    """care_route's bound: arrivals, params, routed, the (D, K) queues and
    per-server arrivals and the stats read or written once, against
    CARE_OPS_PER_SERVER_SLOT for each of ``server_slots``."""
    d, t = arrive.shape
    n_bytes = 4 * (2 * d * t + 4 * d + 2 * d * k + 8 * d)
    return _bound_ms(n_bytes, CARE_OPS_PER_SERVER_SLOT * server_slots)


def _chain_ops(r: int, routed: int, run_slots: int) -> int:
    """Operations of the lane chain: ``routed`` lanes over R replicas in
    ``run_slots`` slots of runs (see SERVE_OPS_PER_ENTRY)."""
    reads = 32 + (-(-r // 1024) if r > 1024 else 0)
    per_lane = 2 * SERVE_OPS_PER_LANE_REDUCTION + SERVE_OPS_PER_ENTRY * reads
    return SERVE_OPS_PER_ENTRY * r * run_slots + per_lane * routed


def _serve_bound(tie_u, q_len, n_arr, act) -> tuple[float, str, float, str]:
    """serve_route's bound: the (D, R) state and (D, A) lanes read or
    written once, against the lane chain's operations for these live
    lanes; then the same bytes against the TPU kernel's dense count, one
    argmin over R replicas for every live lane plus one for the dead."""
    d, a_n = tie_u.shape
    r = q_len.shape[1]
    n_live = torch.where(act, n_arr.clamp(0, a_n), 0)
    live = int(n_live.sum())
    dense_lanes = live + int((n_live < a_n).sum())
    # in: tie_u, q_len, q_head, busy, approx, n_arr, act;
    # out: jv, tail, admit, q_len', approx', drops.
    n_bytes = d * a_n * (4 + 4 + 4 + 1) + d * r * 4 * (4 + 2) + d * (4 + 1 + 4)
    return (*_bound_ms(n_bytes, _chain_ops(r, live, d)),
            *_bound_ms(n_bytes, SERVE_OPS_PER_REPLICA_LANE * r * dense_lanes))


def _serve_state(rng, d: int, r: int, a_n: int, cap: int, dev):
    """Random serving states for phase 2: row 0 routes all A lanes into an
    all-ties score, row 1 has every ring full, row 2 is past its horizon,
    row 3 holds -0.0 scores (equal to +0.0, ties broken by index);
    ``n_arr`` and ``act`` are returned as numpy arrays to edit."""
    q_len = rng.integers(0, cap + 1, (d, r)).astype(np.int32)
    busy = rng.integers(0, 17, (d, r)).astype(np.int32)
    approx = (rng.integers(0, 80, (d, r)) * 0.25).astype(np.float32)
    q_len[0], busy[0], approx[0] = 3, 5, 7.0
    q_len[1] = cap
    approx[3, ::3] = -0.0
    n_arr = rng.integers(1, a_n, d).astype(np.int32)
    n_arr[0] = a_n
    act = np.ones(d, bool)
    act[2] = False
    arrays = [rng.random((d, a_n), dtype=np.float32), q_len,
              rng.integers(0, cap, (d, r)).astype(np.int32), busy, approx]
    return [torch.from_numpy(a).to(dev) for a in arrays], n_arr, act


def _routed_lanes(n_arr, horizon, t_end: int, a_n: int) -> list[int]:
    """Live lanes each run routes in slots [0, min(horizon, t_end))."""
    live = n_arr.cpu().clamp(0, a_n).to(torch.int64)
    slots = torch.arange(live.shape[0])[:, None]
    return (live * (slots < horizon.cpu().clamp(max=t_end))).sum(0).tolist()


def _serve_slots_bound(work, scn, static, n_cap: int, t_end: int,
                       lanes: list[int]) -> tuple[float, str, float, str]:
    """serve_slots' bound: n_arr, work, rid and the scenario read once and
    its outputs written once, against the lane chain's operations for the
    routed lanes and the replica stage's for each replica of each active
    slot; then the same with the TPU kernel's dense argmin for each lane."""
    t_n, d, a_n = work.shape
    r, s_n = static.replicas, static.decode_slots
    active = int(scn.horizon.cpu().clamp(0, t_end).sum())
    n_bytes = 4 * (t_n * d + 2 * t_n * d * a_n + 4 * d + d * r)  # inputs
    n_bytes += 4 * (d * n_cap + 3 * d + 5 * d * r)  # outputs and end state
    if static.trace_occupancy:
        n_bytes += 4 * d * t_n * r
    stage = (SERVE_SLOT_OPS_PER_REPLICA + SERVE_SLOT_OPS_PER_DECODE_SLOT * s_n) * r * active
    dense = SERVE_OPS_PER_REPLICA_LANE * r * sum(lanes)
    return (*_bound_ms(n_bytes, _chain_ops(r, sum(lanes), active) + stage),
            *_bound_ms(n_bytes, dense + stage))


def _profile_serving(engine, cell, wall_s: float) -> None:
    """Where a serving call's time goes: one profiled ``serve_grid`` call of
    the main path.  Device times come from the card's kernel records; the
    host's per-op times are inflated by the profiler, so only their shares
    of the profiled host time are printed.  The device busy share is taken
    against the unprofiled wall of the same call."""
    from torch.profiler import ProfilerActivity, profile

    seeds = list(SERVE_MAIN_SEEDS)
    # A profile has come back with no device record once in a run whose
    # other profiles had them; a second call is profiled before giving up.
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.serve_grid(seeds, cell.static_part(), [cell])
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in device)
        if device_us:
            break
    else:
        print("phase 3 serving profile: the profiler saw no device time in two calls; "
              "device busy share not measured (the kernel's share of the wall, by "
              "CUDA events, is printed above)")
        return
    slots_us = sum(e.self_device_time_total for e in device if "serve_slots" in e.key)
    launches = sum(e.count for e in device)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    host_us = sum(e.self_cpu_time_total for e in host)
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"phase 3 serving profile, {cell.slots} slots: device busy {device_us / 1e3:.4f} "
          f"ms ({launches} device operations, {launches / cell.slots:.4f} per slot), "
          f"{device_us / 1e6 / wall_s:.3f} of the unprofiled wall {wall_s:.4f} s; "
          f"serve_slots {slots_us / device_us:.3f} of device time; device operations: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in device[:6])
          + "; top host ops by self time (profiled): "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / host_us:.3f}" for e in host[:8]))


def _device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches.

    A sleep kernel holds the stream while the host enqueues every launch,
    so the host's cost per call (a ctypes call and the output allocations,
    more than a small kernel's device time) does not show.  Fails if the
    enqueue outlasted the sleep, since the device would then have waited
    on the host inside the timed window.
    """
    fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0 = time.perf_counter()
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    sleep_ms = slept.elapsed_time(start)
    assert enqueue_ms < sleep_ms, (
        f"enqueueing {reps} launches took {enqueue_ms:.2f} ms, longer than the "
        f"{sleep_ms:.2f} ms sleep: the timing would include host time"
    )
    return start.elapsed_time(end) / reps


def _jsaq_cases(rng, dev, card_tests) -> list:
    """Phase 2's ``jsaq_route`` cases, ``(name, q, n)``: ``JSAQ_SHAPE`` with
    an all-ties row (drawn from ``rng``), a staircase batch of that shape
    (23 rounds a row, the most), the wide shape (D=16, K=1e5, N=4096), and
    D=16, K=1e5 with a row's work space just under (N=19000) and just over
    (N=19500) the shared memory a block may opt in to."""
    d, k, n = JSAQ_SHAPE
    q = torch.from_numpy(rng.integers(0, 50, (d, k), dtype=np.int32)).to(dev)
    q[0] = 7  # an all-ties row
    cases = [("JSAQ_SHAPE", q, n)]
    for name in ("staircase_batch", "wide", "smem_limit_below", "smem_limit_above"):
        qc, n = card_tests.jsaq_case(name)
        cases.append((name, torch.as_tensor(qc, device=dev), n))
    return cases


def _jsaq_times(route, q, n: int) -> tuple[float, float]:
    """``route(q, n)``'s device time and its time from the host, in ms."""
    return (_device_ms(lambda: route(q, n), JSAQ_TIME_REPS),
            _time_ms(lambda: route(q, n), JSAQ_HOST_REPS))


def jsaq_ab(src: str, smem_max: int | None = None) -> None:
    """Time the ``jsaq_route`` of the package under ``src`` (this or another
    checkout's ``src`` directory) at phase 2's cases, by device time and
    from the host, and print one JSON line.  ``smem_max``, if given, sets
    the binding's ``JSAQ_SMEM_MAX`` (-1: every row's work space in device
    scratch).  Run on the card from this checkout's root, one process per
    tree, e.g. parent, change, change, parent::

        python3 -c 'import chip_smoke; chip_smoke.jsaq_ab("path/to/src")'
    """
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import jsaq_route as cuda_k

    if smem_max is not None:
        cuda_k.JSAQ_SMEM_MAX = smem_max
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cases = {}
    for name, q, n in _jsaq_cases(np.random.default_rng(2022), dev, _card_tests()):
        device_ms, host_ms = _jsaq_times(cuda_k.jsaq_route_cuda, q, n)
        cases[name] = {"device_ms": device_ms, "host_ms": host_ms}
    print(json.dumps({"src": src, "smem_max": smem_max, "card": _card(),
                      "jsaq_route": cases}))


def slots_ab(src: str, reps: int = 5, mode: str = "fixed", lanes: bool = True) -> None:
    """Time the ``serve_slots`` of the package under ``src`` (this or
    another checkout's ``src`` directory) at phase 3's inputs
    (``serve/replicas1024``, seeds 0 and 1, 2048 slots) by CUDA events and
    print one JSON line.  ``mode``: ``"fixed"`` (the fixed horizon),
    ``"stream"`` (stream mode from an empty carry, every slot folding) or
    ``"stream_nofold"`` (stream mode with the warmup past the horizon, so
    no slot folds); ``lanes=False`` routes no arrival (the replica stage
    alone).  Run on the card from this checkout's root, one process per
    tree, e.g. parent, change, change, parent::

        python3 -c 'import chip_smoke; chip_smoke.slots_ab("path/to/src")'
    """
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import jsaq_route as cuda_k
    from repro_torch.serve import engine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = engine.ServeConfig(**SERVE_MAIN, **SERVE_WORK, comm="et", x=4,
                              deterministic_ties=True, route_backend="fused")
    args = engine._core_args(
        *engine._grid_runs(list(SERVE_MAIN_SEEDS), cell.static_part(), [cell]), dev)
    n_arr, work, _, rid, _, scn, static, n_cap, t_end = args[:9]
    if not lanes:
        n_arr = torch.zeros_like(n_arr)
    kw = dict(cap=static.queue_cap, comm=static.comm, decode_slots=static.decode_slots,
              use_rates=static.use_rates, trace_occupancy=False, n_cap=n_cap, t_end=t_end)
    slot_args = (n_arr, work, rid, scn.x, scn.rt_period, scn.msr_drain, scn.decode_rates,
                 scn.horizon)
    if mode == "fixed":
        def fn():
            return cuda_k.serve_slots_cuda(*slot_args, **kw)
    else:
        st = dataclasses.replace(static, stream=True)
        warm = torch.full_like(scn.horizon, 0 if mode == "stream" else 2**31 - 1)
        views = iter([engine._slots_view(engine._engine_init(st, 0, work.shape[1], dev))
                      for _ in range(reps + 1)])

        def fn():
            return cuda_k.serve_slots_cuda(*slot_args, **kw, carry=next(views), t0=0,
                                           warmup=warm)
    ms = _time_ms(fn, reps)
    print(json.dumps({"src": src, "mode": mode, "lanes": lanes, "card": _card(),
                      "serve_slots_ms": ms, "us_a_slot": ms / t_end * 1e3}))


# flash_bwd_ab's shapes, bf16: SmolLM-135M's training shape (B 8), Gemma2's
# dh 256 with its window and softcap, and dh 128 at GQA 2.
FLASH_BWD_AB = [
    ("smollm_path", (8, 2048, 2048, 9, 3, 64), dict(causal=True)),
    ("gemma2_dh256", (1, 4096, 4096, 16, 8, 256), dict(causal=True, window=4096, softcap=50.0)),
    ("dh128", (2, 2048, 2048, 16, 8, 128), dict(causal=True)),
]


def flash_bwd_ab(src: str, reps: int = 20) -> None:
    """Time the bf16 ``flash_attention_bwd_cuda`` of the package under
    ``src`` (this or another checkout's ``src`` directory) at
    ``FLASH_BWD_AB``'s shapes by CUDA events, with each launch's device time
    from a profile at SmolLM's shape, and print one JSON line.  Run on the
    card from this checkout's root, one process per tree, e.g. parent,
    change, change, parent::

        python3 -c 'import chip_smoke; chip_smoke.flash_bwd_ab("path/to/src")'
    """
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import flash_attn

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"src": src, "card": _card()}
    for name, (b, s, t, h, kvh, d), opts in FLASH_BWD_AB:
        q, dout = (torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2))
        k, v = (torch.randn(b, t, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(scale=d ** -0.5, **opts)
        o, lse = flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw)

        def call():
            return flash_attn.flash_attention_bwd_cuda(q, k, v, o, dout, lse, **kw)

        out[name] = {"ms": _time_ms(call, reps)}
        if name == "smollm_path":
            out[name]["device_us"] = _bwd_kernel_us(call)
    print(json.dumps(out))


def _moe_bwd_bound(t: int, e: int, k: int) -> tuple[float, str]:
    """moe_route_bwd's bound: the float32 logits, idx and grad_w read once
    and the logits' gradient written once; (6 + k) operations a logit."""
    return _bound_ms(4 * (2 * t * e + 2 * t * k), (6 + k) * t * e)


def _ab_library(csrc: Path, out: Path) -> subprocess.Popen:
    """Start ``nvcc`` on ``csrc/moe_route_bwd.cu`` into ``out``, with the
    port's flags."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(out / "libmoe_route_bwd.so"), str(csrc / "moe_route_bwd.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def moe_bwd_ab(src: str, reps: int = MOE_TIME_REPS) -> None:
    """Time the ``moe_route_bwd`` kernel of the package under ``src`` (another
    checkout's ``src`` directory) against this checkout's, in one process,
    in turns (``src``, this, this, ``src``) at each ``MOE_BWD_TIMED`` shape,
    by device time with the queue filled, and print one JSON line with each
    shape's bound and plain time and each kernel's largest error against
    the plain version.  Both sources are built here with the port's flags
    and called through their C interface, so the two calls are alike.  Run
    on the card from this checkout's root::

        python3 -c 'import chip_smoke; chip_smoke.moe_bwd_ab("path/to/src")'
    """
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card_tests = _card_tests()
    out_dir = ROOT / "build" / "moe_bwd_ab"
    trees = {"src": Path(src).resolve() / "repro_torch" / "csrc",
             "here": ROOT / "src" / "repro_torch" / "csrc"}
    procs = {name: _ab_library(csrc, out_dir / name) for name, csrc in trees.items()}
    launch = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log.decode(errors="replace")[-3000:]
        fn = ctypes.CDLL(str(out_dir / name / "libmoe_route_bwd.so")).moe_route_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launch[name] = fn
    result = {"src": src, "card": _card(), "reps": reps}
    for case in MOE_BWD_TIMED:
        logits, idx, gw, gate = card_tests.moe_bwd_inputs(case, dev)
        t, e = logits.shape
        k = idx.shape[1]
        want = ref.moe_route_weights_vjp_ref(logits, idx, gw, gate)
        outs = {name: torch.empty_like(want) for name in launch}

        def call(name):
            err = launch[name](logits.data_ptr(), idx.data_ptr(), gw.data_ptr(),
                               outs[name].data_ptr(), t, e, k, int(gate == "softmax"),
                               torch.cuda.current_stream().cuda_stream)
            assert err == 0, (name, err)

        row = {"src_ms": [], "here_ms": []}
        for name in ("src", "here", "here", "src"):
            row[f"{name}_ms"].append(_device_ms(lambda n=name: call(n), reps))
        for name, got in outs.items():
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            row[f"{name}_max_abs_err"] = float((got - want).abs().max())
        bound = _moe_bwd_bound(t, e, k)
        plain_ms = _time_ms(lambda: ref.moe_route_weights_vjp_ref(logits, idx, gw, gate), 3)
        row.update(plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])
        result[case] = row
    print(json.dumps(result))


def _moe_bound(t: int, e: int, k: int, logit_bytes: int) -> tuple[float, str]:
    """moe_route's bound: logits and bias read once, idx / weights / pos
    and counts written once; MOE_OPS_PER_SCORE + 2 k operations per logit
    and MOE_OPS_PER_ENTRY per (token, slot)."""
    n_bytes = t * e * logit_bytes + 4 * e + 3 * 4 * t * k + 4 * e
    return _bound_ms(n_bytes, (MOE_OPS_PER_SCORE + 2 * k) * t * e + MOE_OPS_PER_ENTRY * t * k)


def _moe_config():
    """DeepSeek-V2 at its published widths, depth cut to MOE_LAYERS."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)


def _moe_parity(moe_k, ref, logits, bias, k: int, gate_fn: str, got=None) -> float:
    """``moe_route`` (or its outputs ``got``) against its plain versions on
    the same card tensors: ids, counts and positions equal, weights within
    rtol 1e-5 / atol 1e-6."""
    if got is None:
        got = moe_k.moe_route_cuda(logits, bias, k, gate_fn=gate_fn)
    want = ref.moe_route_ref(logits, bias, k, gate_fn)
    want = (*want, ref.moe_positions_ref(want[0], logits.shape[1]))
    shape = f"T={logits.shape[0]} E={logits.shape[1]} k={k} {gate_fn} {logits.dtype}"
    assert torch.equal(got[0], want[0]), f"moe_route ids differ at {shape}"
    assert torch.equal(got[2], want[2]), f"moe_route counts differ at {shape}"
    assert torch.equal(got[3], want[3]), f"moe_route positions differ at {shape}"
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6, msg=shape)
    assert int(got[2].sum()) == logits.shape[0] * k
    return _max_abs_err(got, want)


def _moe_serving(dev, times: dict, floor_ms: float) -> dict:
    """Phase 7: the MoE serving path at full width, its CARE loop, the
    router kernel against its plain version, and prefill against decode in
    float32; ``floor_ms`` is phase 1's launch floor.  Returns the kernel's
    line for the kernels JSON."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import moe_balancer
    from repro_torch.kernels import moe_route as moe_k
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ffn, model

    cfg = _moe_config()
    n_moe = model.num_scanned_layers(cfg)
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(MOE_SEED), cfg, dev)
    torch.cuda.synchronize()
    times["moe_init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    print(f"phase 7 {cfg.name} x {MOE_LAYERS} layers ({n_moe} MoE), {cfg.param_dtype}: "
          f"{n_params:,} parameters initialised on the card in {times['moe_init_s']:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    rng = np.random.default_rng(MOE_SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)).astype(np.int64)
    ).to(dev)

    # The spy forwards every call and keeps its inputs and counts.
    calls = []
    route = ops.moe_route

    def spy(logits, bias, top_k, *, gate_fn):
        out = route(logits, bias, top_k, gate_fn=gate_fn)
        calls.append((logits, bias, out))
        return out

    def prefill(bias):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens}, cfg, cache_len=MOE_CACHE,
                                      bias=bias)
        torch.cuda.synchronize()
        return logits, cache, time.perf_counter() - t0, [c[2][2] for c in calls[-n_moe:]]

    ops.moe_route = spy
    ops.reset_launch_counts()
    logits1, _, wall1, counts1 = prefill(None)
    state = moe_balancer.BalancerState.init(n_moe, e, dev)
    state = moe_balancer.post_step_update(state, torch.stack(counts1).float(), cfg.care)
    bias = moe_balancer.selection_bias(state, cfg.care)
    first2 = len(calls)
    logits2, cache, wall2, counts2 = prefill(bias)
    nxt = logits2.argmax(-1)
    generated = [nxt]
    finite = torch.isfinite(logits1).all() & torch.isfinite(logits2).all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MOE_NEW - 1):
        logits, cache = model.decode_step(params, nxt, cache, MOE_PROMPT + i, cfg, bias=bias)
        nxt = logits.argmax(-1)
        generated.append(nxt)
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (MOE_NEW - 1)
    launches = ops.launch_counts()
    ops.moe_route = route
    expected = n_moe * (2 + MOE_NEW - 1)
    assert launches == {"jsaq_route": 0, "care_route": 0, "serve_route": 0, "serve_slots": 0,
                        "moe_route": expected, "flash_attention": 0, **NO_BWD}, (
        launches, expected)
    assert bool(finite), "non-finite logits on the MoE serving path"
    times["moe_prefill1_s"], times["moe_prefill2_s"] = wall1, wall2
    times["moe_decode_ms_per_token"] = decode_ms
    out_tokens = torch.stack(generated, 1).cpu().tolist()

    def imbalance(counts):
        return [round(float(c.max()) / float(c.float().mean()), 4) for c in counts]

    cap = ffn._capacity(MOE_BATCH * MOE_PROMPT, k, e, cfg.moe_capacity_factor)

    def dropped(counts):
        return [int((c - cap).clamp(min=0).sum()) for c in counts]

    print(f"phase 7 CARE loop: prefill #1 (no bias) {wall1:.4f} s, prefill #2 (CARE bias, "
          f"same prompts) {wall2:.4f} s, decode {MOE_NEW - 1} steps {decode_ms:.3f} ms a "
          f"token (B={MOE_BATCH}, cache {MOE_CACHE}); launches {launches}; expert max/mean "
          f"per MoE layer {imbalance(counts1)} -> {imbalance(counts2)}, max count "
          f"{[int(c.max()) for c in counts1]} -> {[int(c.max()) for c in counts2]} against "
          f"capacity {cap}, (token, slot) pairs dropped {dropped(counts1)} -> "
          f"{dropped(counts2)} of {MOE_BATCH * MOE_PROMPT * k}; bias range [{float(bias.min()):.3f}, {float(bias.max()):.3f}]; "
          f"needs_sync {bool(moe_balancer.needs_sync(state, cfg.care))}")
    print(f"phase 7 generated tokens: {out_tokens}")

    # The kernel against its plain versions at the main path's own inputs
    # (the spy's outputs are the path's launches), then at DeepSeek-V3's
    # shape, a 4 x 4096 chunk and the edge cases.
    p_logits, p_bias, p_out = calls[first2]
    d_logits, d_bias, d_out = calls[first2 + n_moe]
    gate = cfg.gate_fn
    errs = [_moe_parity(moe_k, ref, p_logits, p_bias, k, gate, got=p_out),
            _moe_parity(moe_k, ref, d_logits, d_bias, k, gate, got=d_out),
            _moe_parity(moe_k, ref, p_logits, p_bias, k, gate)]
    v3 = torch.from_numpy(rng.standard_normal((MOE_BATCH * MOE_PROMPT, 256)).astype(np.float32))
    v3[0] = 0  # an all-ties row
    v3_bias = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    v3_bias[7] = 1e9  # an expert no token may choose
    v3, v3_bias = v3.to(dev), v3_bias.to(dev)
    errs.append(_moe_parity(moe_k, ref, v3, v3_bias, 8, "sigmoid"))
    assert int(moe_k.moe_route_cuda(v3, v3_bias, 8, gate_fn="sigmoid")[2][7]) == 0
    long_logits = torch.from_numpy(rng.standard_normal((MOE_LONG_T, e)).astype(np.float32)).to(dev)
    errs.append(_moe_parity(moe_k, ref, long_logits, p_bias, k, gate))
    errs.append(_moe_parity(moe_k, ref, p_logits[:1].contiguous(), p_bias, k, gate))
    errs.append(_moe_parity(moe_k, ref, p_logits.to(torch.bfloat16), p_bias, k, gate))
    ties = torch.zeros((MOE_BATCH, e), device=dev)
    errs.append(_moe_parity(moe_k, ref, ties, torch.zeros(e, device=dev), k, gate))
    assert moe_k.moe_route_cuda(ties, torch.zeros(e, device=dev), k)[0].tolist() == [
        list(range(k))] * MOE_BATCH, "all ties must choose the lowest indices"
    # Every score but k - 1 below -1e30: the last sweep takes an expert
    # again, and its position counts the repeat in slot order.
    rep_bias = torch.full((e,), 2e30, device=dev)
    rep_bias[torch.from_numpy(rng.choice(e, k - 1, replace=False)).to(dev)] = 0.0
    errs.append(_moe_parity(moe_k, ref, p_logits, rep_bias, k, gate))
    rep_idx = moe_k.moe_route_cuda(p_logits, rep_bias, k, gate_fn=gate)[0]
    assert bool((rep_idx[:, -1:] == rep_idx[:, :-1]).any(1).all()), "no expert repeated"
    # The look-back words live across calls: after the other shapes, the
    # path's call gives what it gave.
    again = moe_k.moe_route_cuda(p_logits, p_bias, k, gate_fn=gate)
    assert all(torch.equal(a, b) for a, b in zip(again, p_out)), "a later call differs"

    t_p, t_d = p_logits.shape[0], d_logits.shape[0]
    kernel_ms = _device_ms(lambda: moe_k.moe_route_cuda(p_logits, p_bias, k, gate_fn=gate),
                           MOE_TIME_REPS)
    decode_kernel_ms = _device_ms(
        lambda: moe_k.moe_route_cuda(d_logits, d_bias, k, gate_fn=gate), MOE_TIME_REPS)
    v3_ms = _device_ms(lambda: moe_k.moe_route_cuda(v3, v3_bias, 8, gate_fn="sigmoid"),
                       MOE_TIME_REPS)
    long_ms = _device_ms(lambda: moe_k.moe_route_cuda(long_logits, p_bias, k, gate_fn=gate),
                         MOE_TIME_REPS)
    host_ms = _time_ms(lambda: moe_k.moe_route_cuda(p_logits, p_bias, k, gate_fn=gate),
                       MOE_TIME_REPS)
    # The positions in torch (one_hot ... sum on the kernel's ids: what the
    # MoE layer would run without the kernel's pos), and the plain version.
    seq_ms = _device_ms(lambda: ref.moe_positions_ref(p_out[0], e), 20)

    def plain(logits, bias):
        out = ref.moe_route_ref(logits, bias, k, gate)
        return out, ref.moe_positions_ref(out[0], e)

    plain_ms = _time_ms(lambda: plain(p_logits, p_bias), 20)
    decode_plain_ms = _time_ms(lambda: plain(d_logits, d_bias), 20)
    bound = _moe_bound(t_p, e, k, 4)
    decode_bound = _moe_bound(t_d, e, k, 4)
    v3_bound = _moe_bound(v3.shape[0], 256, 8, 4)
    long_bound = _moe_bound(MOE_LONG_T, e, k, 4)
    max_clusters = moe_k._scratch(dev, torch.cuda.current_stream().cuda_stream).flags.shape[1]
    print(f"phase 7 moe_route against its plain versions: equal ids, counts and positions, "
          f"weights max_abs_err {max(errs):.3g}, at the main path's T={t_p} and T={t_d} "
          f"(E={e}, k={k}, {gate}), V3's T={v3.shape[0]} E=256 k=8 sigmoid with an "
          f"all-ties row and a 1e9 bias, T={MOE_LONG_T}, T=1, bf16 logits, an all-ties "
          f"batch and the repeated-expert rows; a later call equals the path's")
    print(f"phase 7 moe_route kernel (device time, queue filled; at most {max_clusters} "
          f"clusters of {moe_k.MOE_CLUSTER} one-SM CTAs at once; (tokens a warp, warps a "
          f"CTA, CTAs, CTAs a cluster) at T={t_p} {moe_k.moe_tiling(t_p, max_clusters)}, at "
          f"T={t_d} {moe_k.moe_tiling(t_d, max_clusters)}, at T={MOE_LONG_T} "
          f"{moe_k.moe_tiling(MOE_LONG_T, max_clusters)}) T={t_p}: {kernel_ms:.5f} ms, "
          f"bound {bound[0]:.6f} ms ({bound[1]}), plain {plain_ms:.4f} ms, host time per "
          f"call {host_ms:.5f} ms; T={t_d}: {decode_kernel_ms:.5f} ms, bound "
          f"{decode_bound[0]:.7f} ms ({decode_bound[1]}), plain {decode_plain_ms:.4f} ms; "
          f"V3 T={v3.shape[0]} E=256 k=8: {v3_ms:.5f} ms, bound {v3_bound[0]:.6f} ms "
          f"({v3_bound[1]}); T={MOE_LONG_T}: {long_ms:.5f} ms, bound {long_bound[0]:.6f} ms "
          f"({long_bound[1]}); launch floor (an empty block, queue filled) {floor_ms:.5f} "
          f"ms; the replaced torch sequence "
          f"(one_hot ... sum) at T={t_p} {seq_ms:.5f} ms; kernel share of prefill #2's wall "
          f"{n_moe * kernel_ms / (wall2 * 1e3):.5f}, of a decode step "
          f"{n_moe * decode_kernel_ms / decode_ms:.5f}")

    # Where the time goes: one profiled prefill and decode step.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits, cache = model.prefill(params, {"tokens": tokens}, cfg, cache_len=MOE_CACHE,
                                      bias=bias)
        model.decode_step(params, logits.argmax(-1), cache, MOE_PROMPT, cfg, bias=bias)
        torch.cuda.synchronize()
    events = prof.key_averages()
    replaced = [ev.key for ev in events if ev.key in ("aten::one_hot", "aten::cumsum")]
    assert not replaced, f"the MoE layer ran {replaced} on the card"
    device = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(ev.self_device_time_total for ev in device)
    if device_us == 0:
        print("phase 7 profile: the profiler saw no device time; busy share not measured")
    else:
        device.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
        route_us = sum(ev.self_device_time_total for ev in device if "moe_route" in ev.key)
        print(f"phase 7 profile of one prefill + one decode step: device busy "
              f"{device_us / 1e3:.3f} ms against an unprofiled wall of "
              f"{wall2 * 1e3 + decode_ms:.3f} ms (busy share "
              f"{device_us / 1e3 / (wall2 * 1e3 + decode_ms):.3f}); "
              f"{sum(ev.count for ev in device)} device operations, no aten::one_hot or "
              f"aten::cumsum; moe_route {route_us / device_us:.5f} of device time; top "
              f"device operations: "
              + "; ".join(f"{ev.key[:60]} {ev.self_device_time_total / 1e3:.3f} ms "
                          f"x{ev.count}" for ev in device[:8]))
    del params, cache, calls, logits, logits1, logits2, p_logits, d_logits, p_out, d_out
    torch.cuda.empty_cache()

    # Prefill against decode in float32.  A full expert may drop a
    # request's last token in the 2048-token prefill and keep it in the
    # 4-token decode, a legitimate difference.  The random gate routes with
    # max/mean 3-5 (above), past reduced()'s factor of 4.0, so the check
    # sets the capacity to T (factor E / k): no token can be dropped, which
    # the spy's counts confirm.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                moe_capacity_factor=e / k)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(MOE_SEED), cfg32, dev)
    torch.cuda.synchronize()
    times["moe_f32_init_s"] = time.perf_counter() - t0
    routes = []

    def spy32(logits, bias, top_k, *, gate_fn):
        out = route(logits, bias, top_k, gate_fn=gate_fn)
        routes.append(out)
        return out

    ops.moe_route = spy32
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    full, _ = model.prefill(params, {"tokens": tokens}, cfg32, cache_len=MOE_PROMPT)
    _, cache = model.prefill(params, {"tokens": tokens[:, :-1]}, cfg32, cache_len=MOE_PROMPT)
    step, _ = model.decode_step(params, tokens[:, -1], cache, MOE_PROMPT - 1, cfg32)
    torch.cuda.synchronize()
    times["moe_f32_check_s"] = time.perf_counter() - t0
    ops.moe_route = route
    assert len(routes) == 3 * n_moe
    for idx, _, counts, _ in routes:
        t = idx.shape[0]
        c = ffn._capacity(t, k, e, cfg32.moe_capacity_factor)
        assert int(counts.max()) <= c, f"an expert overflowed ({int(counts.max())} > {c}, T={t})"
    differ = sum(
        int((full_idx.reshape(MOE_BATCH, MOE_PROMPT, k)[:, -1] != dec_idx).sum())
        for full_idx, dec_idx in zip((r[0] for r in routes[:n_moe]),
                                     (r[0] for r in routes[2 * n_moe:]))
    )
    err = float((step - full).abs().max())
    torch.testing.assert_close(step, full, rtol=2e-2, atol=2e-2)
    print(f"phase 7 float32 prefill over S={MOE_PROMPT} against prefill over S-1 + "
          f"decode_step, capacity factor {e / k:.3f}: logits within 2e-2 (max abs "
          f"difference {err:.3g}); no expert over capacity; {differ} of "
          f"{n_moe * MOE_BATCH * k} routing decisions of the last position differ; "
          f"init {times['moe_f32_init_s']:.2f} s, check {times['moe_f32_check_s']:.2f} s, "
          f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    del params, cache, full, step, routes
    torch.cuda.empty_cache()

    return {
        "name": "moe_route", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_route.cu",
        "replaces": "src/repro/kernels/moe_route.py:89",
        "launches": launches["moe_route"],
        "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
    }


def _attn_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs one head attends: keys ``max(0, q - w + 1)..min(q,
    T - 1)`` of query q under a causal window; a query with no such key
    averages all T (the dense softmax of an all-masked row)."""
    if not causal:
        return s * t
    q = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, q - (window or 2**62) + 1)
    cnt = np.minimum(q, t - 1) - lo + 1
    return int(np.where(cnt > 0, cnt, t).sum())


def _flash_flop(q, k, v, causal: bool, window) -> int:
    """Useful FLOP of one flash_attention call: 2 (dh + dv) per attended
    (query, key) pair and head."""
    b, s, h, dh = q.shape
    return 2 * (dh + v.shape[3]) * b * h * _attn_pairs(s, k.shape[1], causal, window)


def _flash_bound(q, k, v, causal: bool, window) -> tuple[float, str]:
    """flash_attention's bound: q, k, v read once and the output written
    once, against 2 (dh + dv) FLOP per attended pair on the tensor cores
    (bf16) or the CUDA cores (float32)."""
    b, s, h, dh = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    elem = q.element_size()
    n_bytes = elem * (b * s * h * dh + b * t * kvh * (dh + dv) + b * s * h * dv)
    n_ops = _flash_flop(q, k, v, causal, window)
    rate = BF16_TENSOR_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _flash_parity(flash_k, ref, q, k, v, **kw) -> float:
    """``flash_attention`` against its plain version on the same card
    tensors: within 2e-2 in bf16, 2e-5 in float32."""
    got = flash_k.flash_attention_cuda(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
    shape = f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} {q.dtype} {kw}"
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol, msg=shape)
    return _max_abs_err([got], [want])


def _dense_config():
    """Gemma2-9B at its published widths and depth."""
    from repro_torch.configs import get_config

    return get_config(DENSE_ARCH)


def _dense_serving(dev, times: dict) -> dict:
    """Phase 8: the dense GQA serving path at full width and depth, the
    flash kernel against its plain version, and prefill against decode in
    float32.  Returns the kernel's line for the kernels JSON."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in full float32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    assert torch.cuda.memory_allocated(dev) < 1e9, (
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated before phase 8")
    cfg = _dense_config()
    windows = tfm.layer_windows(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(DENSE_SEED), cfg, dev)
    torch.cuda.synchronize()
    times["dense_init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    print(f"phase 8 {cfg.name} x {cfg.num_layers} layers, {cfg.param_dtype}: {n_params:,} "
          f"parameters initialised on the card in {times['dense_init_s']:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    rng = np.random.default_rng(DENSE_SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT)).astype(np.int64)
    ).to(dev)

    # Warm-up on a short prompt; then the main path with the counts at 0.
    # The spy forwards every call and keeps the q/k/v of layers 0 (local)
    # and 1 (global).
    model.prefill(params, {"tokens": tokens[:, :128]}, cfg, cache_len=256)
    kept = []
    attend = ops.flash_attention

    def spy(q, k, v, **kw):
        if len(kept) < 2:
            kept.append((q, k, v, kw))
        return attend(q, k, v, **kw)

    ops.flash_attention = spy
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, cfg, cache_len=DENSE_CACHE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefill_launches = ops.launch_counts()["flash_attention"]
    nxt = logits.argmax(-1)
    generated = [nxt]
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for i in range(DENSE_NEW):
        logits, cache = model.decode_step(params, nxt, cache, DENSE_PROMPT + i, cfg)
        nxt = logits.argmax(-1)
        generated.append(nxt)
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DENSE_NEW
    launches = ops.launch_counts()
    ops.flash_attention = attend
    assert prefill_launches == cfg.num_layers, (prefill_launches, cfg.num_layers)
    assert launches == {"jsaq_route": 0, "care_route": 0, "serve_route": 0, "serve_slots": 0,
                        "moe_route": 0, "flash_attention": cfg.num_layers, **NO_BWD}, launches
    assert bool(finite), "non-finite logits on the dense serving path"
    assert [kw["window"] for *_, kw in kept] == [int(windows[0]), int(windows[1])]
    times["dense_prefill_s"], times["dense_decode_ms_per_token"] = wall, decode_ms
    print(f"phase 8 serving: prefill {DENSE_BATCH} x {DENSE_PROMPT} tokens {wall:.4f} s, "
          f"decode {DENSE_NEW} steps {decode_ms:.3f} ms a token (cache {DENSE_CACHE}); "
          f"launches {launches}; cache k {tuple(cache['scan']['k'].shape)} "
          f"{cache['scan']['k'].dtype}; peak {torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    print(f"phase 8 generated tokens: {torch.stack(generated, 1).cpu().tolist()}")

    # The kernel against its plain version on the path's own q/k/v (B=1 so
    # that the plain version's float32 scores fit), softcap on and off.
    errs = []
    for q, k, v, kw in kept:
        q1, k1, v1 = q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous()
        errs.append(_flash_parity(flash_k, ref, q1, k1, v1, **kw))
        errs.append(_flash_parity(flash_k, ref, q1, k1, v1, **{**kw, "softcap": 0.0}))
    print(f"phase 8 flash_attention against its plain version on the path's q/k/v "
          f"(B=1, S=T={DENSE_PROMPT}, windows {[kw['window'] for *_, kw in kept]}, softcap "
          f"50 and 0): max_abs_err {max(errs):.3g} ({kept[0][0].dtype})")

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype).to(dev)

    for name, (b, sq, t, h, kvh, dh, dv), dtype, kw in FLASH_CASES:
        q, k, v = (randn(b, n, heads, w, dtype=dtype)
                   for n, heads, w in ((sq, h, dh), (t, kvh, dh), (t, kvh, dv)))
        err = _flash_parity(flash_k, ref, q, k, v, scale=dh**-0.5, **kw)
        errs.append(err)
        print(f"phase 8 flash_attention {name} ({dtype}): max_abs_err {err:.3g}")
        if dtype == torch.bfloat16 and sq >= 2048 and kw == dict(causal=True):
            # the tensor-core kernel at the other widths, against SDPA
            kernel_ms = _time_ms(
                lambda: flash_k.flash_attention_cuda(q, k, v, scale=dh**-0.5, **kw),
                FLASH_TIME_REPS)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=dh**-0.5, enable_gqa=True), FLASH_TIME_REPS)
            print(f"phase 8 flash_attention {name}: kernel {kernel_ms:.3f} ms, "
                  f"{_flash_flop(q, k, v, True, None) / kernel_ms / 1e9:.1f} TFLOP/s, "
                  f"scaled_dot_product_attention {sdpa_ms:.3f} ms, kernel / SDPA "
                  f"{kernel_ms / sdpa_ms:.3f}")
            del qt, kt, vt
        if dtype == torch.float32:  # the CUDA-core kernel's time, once
            kw32 = dict(scale=dh**-0.5, **kw)
            bound = _flash_bound(q, k, v, kw["causal"], kw.get("window"))
            f32_ms = _time_ms(lambda: flash_k.flash_attention_cuda(q, k, v, **kw32),
                              FLASH_TIME_REPS)
            f32_plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw32), 2)
            times["flash_f32_ms"], times["flash_f32_plain_ms"] = f32_ms, f32_plain_ms
            flop32 = _flash_flop(q, k, v, kw["causal"], kw.get("window"))
            print(f"phase 8 flash_attention float32 kernel at {name}: {f32_ms:.4f} ms, "
                  f"{flop32 / f32_ms / 1e9:.2f} TFLOP/s, bound / kernel "
                  f"{bound[0] / f32_ms:.3f}; plain {f32_plain_ms:.3f} ms; bound "
                  f"{bound[0]:.4f} ms ({bound[1]}; operations at the CUDA cores' float32 peak)")
            # Beside it, float32 SDPA on the same inputs with softcap 0, the
            # window as a boolean mask, against the kernel with softcap 0.
            nocap32 = dict(kw32, softcap=0.0)
            f32_nocap_ms = _time_ms(lambda: flash_k.flash_attention_cuda(q, k, v, **nocap32),
                                    FLASH_TIME_REPS)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            pos = torch.arange(sq, device=q.device)
            allowed = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < kw["window"])

            def sdpa32():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                      scale=dh**-0.5, enable_gqa=True)

            sdpa32_ms = _time_ms(sdpa32, FLASH_TIME_REPS)
            sdpa32_diff = _max_abs_err(
                [sdpa32().transpose(1, 2)],
                [flash_k.flash_attention_cuda(q, k, v, **nocap32)])
            times["flash_f32_nocap_ms"], times["flash_f32_sdpa_ms"] = f32_nocap_ms, sdpa32_ms
            print(f"phase 8 flash_attention float32 at {name} with softcap 0: kernel "
                  f"{f32_nocap_ms:.4f} ms, {flop32 / f32_nocap_ms / 1e9:.2f} TFLOP/s, bound / "
                  f"kernel {bound[0] / f32_nocap_ms:.3f}; scaled_dot_product_attention "
                  f"(window as a mask) "
                  f"{sdpa32_ms:.3f} ms, kernel / SDPA {f32_nocap_ms / sdpa32_ms:.3f} (outputs "
                  f"differ by at most {sdpa32_diff:.3g})")
            del qt, kt, vt, allowed
    del q, k, v

    # Where the time goes: one profiled prefill and decode step.
    del logits, cache
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits, cache = model.prefill(params, {"tokens": tokens}, cfg, cache_len=DENSE_CACHE)
        model.decode_step(params, logits.argmax(-1), cache, DENSE_PROMPT, cfg)
        torch.cuda.synchronize()
    device = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(ev.self_device_time_total for ev in device)
    if device_us == 0:
        print("phase 8 profile: the profiler saw no device time; busy share not measured")
    else:
        device.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
        flash_us = sum(ev.self_device_time_total for ev in device
                       if "flash_wgmma" in ev.key or "flash_kernel" in ev.key)
        print(f"phase 8 profile of one prefill + one decode step: device busy "
              f"{device_us / 1e3:.3f} ms against an unprofiled wall of "
              f"{wall * 1e3 + decode_ms:.3f} ms (busy share "
              f"{device_us / 1e3 / (wall * 1e3 + decode_ms):.3f}); flash_attention "
              f"{flash_us / device_us:.4f} of device time; top device operations: "
              + "; ".join(f"{ev.key[:60]} {ev.self_device_time_total / 1e3:.3f} ms "
                          f"x{ev.count}" for ev in device[:8]))
    del params, cache, logits
    torch.cuda.empty_cache()

    # Times at the path's shapes (B=2), the model freed so that the plain
    # version's float32 scores of both prompts fit.  Beside each layer,
    # PyTorch's scaled_dot_product_attention on the same inputs with softcap
    # 0 against the kernel with softcap 0: causal for the global layer, the
    # window as a boolean mask (whichever backend PyTorch picks) for the local.
    rows = {}
    for (q, k, v, kw), layer in zip(kept, ("local", "global")):
        bound = _flash_bound(q, k, v, True, kw["window"])
        flop = _flash_flop(q, k, v, True, kw["window"])
        kernel_ms = _time_ms(lambda: flash_k.flash_attention_cuda(q, k, v, **kw), FLASH_TIME_REPS)
        plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 2)
        # the model's global layers pass a window of 2**30, wider than S
        nocap = dict(kw, softcap=0.0, window=None if layer == "global" else kw["window"])
        nocap_ms = _time_ms(lambda: flash_k.flash_attention_cuda(q, k, v, **nocap),
                            FLASH_TIME_REPS)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's (B, H, S, D)
        if nocap["window"] is None:
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      scale=kw["scale"], enable_gqa=True)
        else:
            pos = torch.arange(q.shape[1], device=q.device)
            allowed = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < kw["window"])

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                      scale=kw["scale"], enable_gqa=True)
        sdpa_ms = _time_ms(sdpa, FLASH_TIME_REPS)
        sdpa_diff = _max_abs_err([sdpa().transpose(1, 2).float()],
                                 [flash_k.flash_attention_cuda(q, k, v, **nocap).float()])
        rows[layer] = (kernel_ms, plain_ms, bound, sdpa_ms)
        if layer == "global":
            tp_heads = _tp_heads_check(q, k, v, kw, kernel_ms)
        print(f"phase 8 flash_attention {layer} layer (B={q.shape[0]}, S=T={q.shape[1]}, "
              f"H={q.shape[2]}, KVH={k.shape[2]}, dh={q.shape[3]}, window {kw['window']}, "
              f"softcap {kw['softcap']}): kernel {kernel_ms:.3f} ms, {flop / kernel_ms / 1e9:.1f} "
              f"TFLOP/s, bound {bound[0]:.4f} ms ({bound[1]}), bound / kernel "
              f"{bound[0] / kernel_ms:.3f}; plain {plain_ms:.3f} ms; softcap 0: kernel "
              f"{nocap_ms:.3f} ms, scaled_dot_product_attention {sdpa_ms:.3f} ms, kernel / SDPA "
              f"{nocap_ms / sdpa_ms:.3f} (outputs differ by at most {sdpa_diff:.3g})")
        del qt, kt, vt
    layers_ms = cfg.num_layers // 2 * (rows["local"][0] + rows["global"][0])
    print(f"phase 8 {cfg.num_layers // 2} local + {cfg.num_layers // 2} global layers: kernel "
          f"{layers_ms:.1f} ms, bound "
          f"{cfg.num_layers // 2 * (rows['local'][2][0] + rows['global'][2][0]):.2f} ms, "
          f"{layers_ms / (wall * 1e3):.3f} of the prefill wall")
    sdpa_ms = rows["global"][3]
    del kept, q, k, v
    torch.cuda.empty_cache()

    # Prefill against decode in float32, B=1, S past the window.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(DENSE_SEED), cfg32, dev)
    torch.cuda.synchronize()
    times["dense_f32_init_s"] = time.perf_counter() - t0
    tok = tokens[:1, :DENSE_F32_PROMPT]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    full, _ = model.prefill(params, {"tokens": tok}, cfg32, cache_len=DENSE_F32_PROMPT)
    _, cache = model.prefill(params, {"tokens": tok[:, :-1]}, cfg32, cache_len=DENSE_F32_PROMPT)
    step, _ = model.decode_step(params, tok[:, -1], cache, DENSE_F32_PROMPT - 1, cfg32)
    torch.cuda.synchronize()
    times["dense_f32_check_s"] = time.perf_counter() - t0
    err = float((step - full).abs().max())
    torch.testing.assert_close(step, full, rtol=2e-2, atol=2e-2)
    print(f"phase 8 float32 prefill over S={DENSE_F32_PROMPT} against prefill over S-1 + "
          f"decode_step (window {cfg.sliding_window}): logits within 2e-2 (max abs "
          f"difference {err:.3g}); init {times['dense_f32_init_s']:.2f} s, check "
          f"{times['dense_f32_check_s']:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    del params, cache, full, step
    torch.cuda.empty_cache()

    kernel_ms, plain_ms, bound, _ = rows["global"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn.py:84",
        "launches": launches["flash_attention"],
        "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": sdpa_ms,
        "tp_heads": tp_heads,
    }


def _tp_heads_check(q, k, v, kw: dict, whole_ms: float,
                    label: str = "phase 8 flash_attention on one rank's heads of the global "
                                 "layer") -> dict:
    """``ops.flash_attention`` on each TP rank's heads of a layer (its
    query heads and, since the KV heads divide too, its KV heads, as
    ``attention_full`` calls it under a context) against those heads of
    the whole-head call, bit for bit, at TP 2 and 4; each rank's call
    timed beside the whole call's.  Returns ``{tp: {...}}``."""
    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ops

    whole = ops.flash_attention(q, k, v, **kw)
    h, kvh = q.shape[2], k.shape[2]
    out = {}
    for tp in TP_HEAD_SPLITS:
        hl, kl = h // tp, kvh // tp
        equal, rank_ms = True, []
        for r in range(tp):
            qr, kr, vr = (x[:, :, i * n:(i + 1) * n].contiguous()
                          for x, i, n in ((q, r, hl), (k, r, kl), (v, r, kl)))
            got = ops.flash_attention(qr, kr, vr, **kw)
            equal &= torch.equal(got, whole[:, :, r * hl:(r + 1) * hl])
            rank_ms.append(_time_ms(lambda: flash_k.flash_attention_cuda(qr, kr, vr, **kw),
                                    FLASH_TIME_REPS))
        assert equal, f"a rank's heads at tp {tp} differ from the whole call's"
        out[tp] = {"heads": hl, "kv_heads": kl, "equal": equal, "rank_ms": rank_ms,
                   "whole_ms": whole_ms}
        print(f"{label} at tp {tp} ({hl} query heads over {kl} KV heads, B={q.shape[0]}, "
              f"S={q.shape[1]}, T={k.shape[1]}): "
              f"every rank's output equals its heads of the whole call bit for bit; a rank's "
              f"call {min(rank_ms):.3f}-{max(rank_ms):.3f} ms against the whole call's "
              f"{whole_ms:.3f} ms ({whole_ms / tp:.3f} over {tp})")
    return out


def _family_config(arch: str):
    from repro_torch.configs import get_config

    return get_config(arch)


def _family_batch(cfg, run: dict, rng, dev, dtype) -> dict:
    """Token ids (and whisper's frame embeddings) drawn from ``rng``."""
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (run["batch"], run["prompt"])).astype(np.int64)).to(dev)}
    if cfg.family == "audio":
        frames = rng.standard_normal((run["batch"], cfg.encoder_seq, cfg.d_model))
        batch["frames"] = torch.from_numpy(frames.astype(np.float32)).to(dev, dtype)
    return batch


def _cut(batch: dict, b: int, s: int) -> dict:
    """The first ``b`` rows of a batch, tokens cut to ``s`` (frames whole)."""
    return {k: (v[:b, :s] if k == "tokens" else v[:b]) for k, v in batch.items()}


def _serve_family(dev, run: dict, times: dict, keep: tuple) -> dict:
    """One model of phase 8b at published widths and depth, bf16: init on
    the card from the seed, a warm-up, then the main path with the launch
    counts set to 0 just before and read just after (prefill, then
    ``FAMILY_NEW`` greedy decode steps).  A spy forwards every
    ``flash_attention`` call, records its options and keeps the q/k/v of
    the calls numbered in ``keep``.  Returns what the checks need."""
    from repro_torch.kernels import ops
    from repro_torch.models import model

    name = run["arch"]
    cfg = _family_config(name)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(FAMILY_SEED), cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(FAMILY_SEED)
    batch = _family_batch(cfg, run, rng, dev, torch.bfloat16)
    warm = _cut(batch, run["batch"], 64)
    logits, cache = model.prefill(params, warm, cfg, cache_len=128)
    model.decode_step(params, logits.argmax(-1), cache, 64, cfg)
    calls, kept = [], []
    attend = ops.flash_attention

    def spy(q, k, v, **kw):
        if len(calls) in keep:
            kept.append((q, k, v, kw))
        calls.append(kw)
        return attend(q, k, v, **kw)

    ops.flash_attention = spy
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cfg, cache_len=run["cache"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefill_launches = ops.launch_counts()["flash_attention"]
    nxt = logits.argmax(-1)
    generated = [nxt]
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for i in range(FAMILY_NEW):
        logits, cache = model.decode_step(params, nxt, cache, run["prompt"] + i, cfg)
        nxt = logits.argmax(-1)
        generated.append(nxt)
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / FAMILY_NEW
    launches = ops.launch_counts()
    ops.flash_attention = attend
    assert bool(finite), f"non-finite logits on the {name} serving path"
    assert launches["flash_attention"] == prefill_launches, (
        f"{name}: decode launched flash_attention ({prefill_launches} -> {launches})")
    assert len(calls) == prefill_launches and len(kept) == len(keep), (len(calls), launches)
    label = name.split("-")[0]
    times[f"{label}_init_s"], times[f"{label}_prefill_s"] = init_s, wall
    times[f"{label}_decode_ms_per_token"] = decode_ms
    cache_shapes = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                    for k, t in cache["scan"].items()}
    print(f"phase 8b {name} x {cfg.num_layers} layers"
          + (f" + {cfg.encoder_layers} encoder layers" if cfg.family == "audio" else "")
          + f", {cfg.param_dtype}: {n_params:,} parameters initialised on the card in "
          f"{init_s:.2f} s; prefill {run['batch']} x {run['prompt']} tokens "
          + (f"(and {cfg.encoder_seq} frames) " if cfg.family == "audio" else "")
          + f"{wall:.4f} s, decode {FAMILY_NEW} steps {decode_ms:.3f} ms a token (cache "
          f"{run['cache']}); launches {launches}; cache {cache_shapes}; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    print(f"phase 8b {name} generated tokens: {torch.stack(generated, 1).cpu().tolist()}")
    return dict(cfg=cfg, params=params, batch=batch, calls=calls, kept=kept,
                launches=launches, wall=wall, decode_ms=decode_ms)


def _family_kernel_times(label: str, q, k, v, kw: dict) -> dict:
    """The kernel at one of phase 8b's shapes: against its plain version
    (within 2e-2 in bf16), its time, its bound and PyTorch's
    ``scaled_dot_product_attention`` on the same inputs (causal, the window
    as a boolean mask, or every key)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as flash_k
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tfm

    causal = kw["causal"]
    window = kw["window"] if causal and kw["window"] != tfm.BIG_WINDOW else None
    err = _flash_parity(flash_k, ref, q, k, v, **kw)
    kernel_ms = _time_ms(lambda: flash_k.flash_attention_cuda(q, k, v, **kw), FLASH_TIME_REPS)
    plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 2)
    bound = _flash_bound(q, k, v, causal, window)
    flop = _flash_flop(q, k, v, causal, window)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's (B, H, S, D)
    mask = None
    if window is not None:
        qpos = torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = (kpos[None, :] <= qpos[:, None]) & (qpos[:, None] - kpos[None, :] < window)

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=kw["scale"],
            enable_gqa=True)

    sdpa_ms = _time_ms(sdpa, FLASH_TIME_REPS)
    sdpa_diff = _max_abs_err([sdpa().transpose(1, 2).float()],
                             [flash_k.flash_attention_cuda(q, k, v, **kw).float()])
    b, s, h, dh = q.shape
    shape = (f"B={b} S={s} T={k.shape[1]} H={h} KVH={k.shape[2]} dh={dh}, "
             + (f"causal, window {window}" if window else "causal" if causal else "non-causal"))
    print(f"phase 8b flash_attention {label} ({shape}, {q.dtype}): against its plain version "
          f"max_abs_err {err:.3g}; kernel {kernel_ms:.4f} ms, {flop / kernel_ms / 1e9:.1f} "
          f"TFLOP/s, bound {bound[0]:.4f} ms ({bound[1]}), bound / kernel "
          f"{bound[0] / kernel_ms:.3f}; plain {plain_ms:.3f} ms; scaled_dot_product_attention "
          f"{sdpa_ms:.4f} ms, kernel / SDPA {kernel_ms / sdpa_ms:.3f} (outputs differ by at most "
          f"{sdpa_diff:.3g})")
    return {"shape": shape, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": sdpa_ms}


def _family_f32_check(dev, run: dict, times: dict) -> None:
    """Float32 rebuild of a phase 8b model: logits of prefill over S against
    prefill over S-1 plus one ``decode_step`` at S-1, within 2e-2 (B=1)."""
    from repro_torch.models import model

    name, s = run["arch"], run["f32_prompt"]
    cfg = dataclasses.replace(_family_config(name), param_dtype="float32",
                              compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(FAMILY_SEED), cfg, dev)
    rng = np.random.default_rng(FAMILY_SEED + 1)
    batch = _family_batch(cfg, {**run, "batch": 1, "prompt": s}, rng, dev, torch.float32)
    full, _ = model.prefill(params, batch, cfg, cache_len=s)
    _, cache = model.prefill(params, _cut(batch, 1, s - 1), cfg, cache_len=s)
    step, _ = model.decode_step(params, batch["tokens"][:, -1], cache, s - 1, cfg)
    torch.cuda.synchronize()
    label = name.split("-")[0]
    times[f"{label}_f32_check_s"] = time.perf_counter() - t0
    err = float((step - full).abs().max())
    torch.testing.assert_close(step, full, rtol=2e-2, atol=2e-2)
    print(f"phase 8b {name} float32 prefill over S={s} against prefill over S-1 + decode_step: "
          f"logits within 2e-2 (max abs difference {err:.3g}, largest logit "
          f"{float(full.abs().max()):.3g}); init and check {times[f'{label}_f32_check_s']:.2f} "
          f"s, peak {torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    del params, cache, full, step
    torch.cuda.empty_cache()


def _profile_hymba(served: dict, wall_ms: float) -> None:
    """Where Hymba's time goes: one profiled prefill plus one decode step
    (device busy share against the unprofiled wall); one unprofiled
    prefill with CUDA events around the whole of it and around each
    layer's ``ssm.mamba`` call (the Mamba calls' share of the prefill);
    and one profiled Mamba call of layer 0 alone at the prefill's shape
    on a random x: its device operations a token (the selective scan is a
    loop of small operations)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model, ssm

    cfg, params, batch = served["cfg"], served["params"], served["batch"]
    # Device activity only: with host activity too, the ~140,000 operations'
    # host records cost the profiler far more than the window itself.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, cache = model.prefill(params, batch, cfg, cache_len=HYMBA["cache"])
        model.decode_step(params, logits.argmax(-1), cache, HYMBA["prompt"], cfg)
        torch.cuda.synchronize()
    del logits, cache
    device = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(ev.self_device_time_total for ev in device)
    if device_us == 0:
        print("phase 8b hymba profile: the profiler saw no device time; busy share not measured")
        return
    device.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
    flash_us = sum(ev.self_device_time_total for ev in device if "flash_" in ev.key)
    n_ops = sum(ev.count for ev in device)
    print(f"phase 8b hymba profile of one prefill + one decode step: device busy "
          f"{device_us / 1e3:.3f} ms against an unprofiled wall of {wall_ms:.3f} ms (busy share "
          f"{device_us / 1e3 / wall_ms:.3f}); {n_ops} device operations; flash_attention "
          f"{flash_us / device_us:.4f} of device time; top device operations: "
          + "; ".join(f"{ev.key[:60]} {ev.self_device_time_total / 1e3:.3f} ms x{ev.count}"
                      for ev in device[:8]))
    # The Mamba calls inside one prefill: the stream's time from each
    # call's first operation to its last (host-bound, so this is the
    # call's wall as the stream sees it) against the whole prefill's.
    spans = []
    plain_mamba = ssm.mamba

    def timed_mamba(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = plain_mamba(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ssm.mamba = timed_mamba
    try:
        whole[0].record()
        logits, cache = model.prefill(params, batch, cfg, cache_len=HYMBA["cache"])
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        ssm.mamba = plain_mamba
    del logits, cache
    prefill_ms = whole[0].elapsed_time(whole[1])
    in_mamba_ms = sum(a.elapsed_time(z) for a, z in spans)
    assert len(spans) == cfg.num_layers, len(spans)
    print(f"phase 8b hymba Mamba calls inside one prefill (CUDA events): {len(spans)} calls "
          f"{in_mamba_ms:.3f} ms of the prefill's {prefill_ms:.3f} ms (share "
          f"{in_mamba_ms / prefill_ms:.4f})")
    b, s = batch["tokens"].shape
    x = torch.randn((b, s, cfg.d_model), device=batch["tokens"].device,
                    generator=torch.Generator(device=batch["tokens"].device).manual_seed(1))
    x = x.to(torch.bfloat16)
    layer = params.layers[0].mamba
    ssm.mamba(layer, x, cfg)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssm.mamba(layer, x, cfg)
    torch.cuda.synchronize()
    mamba_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssm.mamba(layer, x, cfg)
        torch.cuda.synchronize()
    device = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    n_ops = sum(ev.count for ev in device)
    busy_us = sum(ev.self_device_time_total for ev in device)
    print(f"phase 8b hymba Mamba layer 0 alone on a random x at B={b}, S={s}: {mamba_ms:.2f} "
          f"ms wall ({mamba_ms * 1e3 / s:.2f} us a token), {n_ops} device operations "
          f"({n_ops / s:.3f} a token), device busy {busy_us / 1e3:.3f} ms"
          + (f" ({busy_us / 1e3 / mamba_ms:.3f} of the wall)" if busy_us else " (not measured)"))


def _family_serving(dev, times: dict) -> dict:
    """Phase 8b: Hymba-1.5B, Whisper-small and RWKV6-1.6B at published
    widths and full depth in bf16, each with the launch counts set to 0
    just before its prefill and read after its decode steps; the flash
    kernel against its plain version on the paths' own q/k/v (GQA group 5
    with window 1024 and global; whisper's non-causal encoder at S = T =
    1500 and its cross-attention at S = 432, T = 1500), timed beside its
    bound and SDPA; float32 prefill against decode for each.  Returns the
    new keys of the flash_attention entry."""
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in full float32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    assert torch.cuda.memory_allocated(dev) < 1e9, (
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated before phase 8b")
    other = {"jsaq_route": 0, "care_route": 0, "serve_route": 0, "serve_slots": 0,
             "moe_route": 0, **NO_BWD}
    shapes, launches = {}, {}

    # Hymba: layer 0 is global, layer 1 local (window 1024).
    served = _serve_family(dev, HYMBA, times, keep=(0, 1))
    cfg = served["cfg"]
    windows = [int(w) for w in tfm.layer_windows(cfg)]
    assert served["launches"] == {**other, "flash_attention": cfg.num_layers} == {
        **other, "flash_attention": 32}, served["launches"]
    assert [c["window"] for c in served["calls"]] == windows
    assert windows.count(tfm.BIG_WINDOW) == 3 and windows.count(cfg.sliding_window) == 29
    assert cfg.num_heads // cfg.num_kv_heads == 5 and cfg.resolved_head_dim == 64
    launches[HYMBA["arch"]] = served["launches"]["flash_attention"]
    for (q, k, v, kw), layer in zip(served["kept"], ("global", "local")):
        shapes[f"hymba_{layer}"] = _family_kernel_times(f"hymba {layer} layer", q, k, v, kw)
    t0 = time.perf_counter()
    _profile_hymba(served, served["wall"] * 1e3 + served["decode_ms"])
    times["hymba_profile_s"] = time.perf_counter() - t0
    del served
    torch.cuda.empty_cache()
    _family_f32_check(dev, HYMBA, times)

    # Whisper: calls 0-11 are the encoder's, then each decoder layer's self-
    # and cross-attention; call 13 is layer 0's cross-attention.
    served = _serve_family(dev, WHISPER, times, keep=(0, 12, 13))
    cfg = served["cfg"]
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    assert served["launches"] == {**other, "flash_attention": n_enc + 2 * n_dec} == {
        **other, "flash_attention": 36}, served["launches"]
    assert [c["causal"] for c in served["calls"]] == [False] * n_enc + [True, False] * n_dec
    assert all(c["window"] is None for c in served["calls"] if not c["causal"])
    launches[WHISPER["arch"]] = served["launches"]["flash_attention"]
    for (q, k, v, kw), part in zip(served["kept"], ("encoder", "decoder_self", "cross")):
        shapes[f"whisper_{part}"] = _family_kernel_times(f"whisper {part}", q, k, v, kw)
    del served
    torch.cuda.empty_cache()
    _family_f32_check(dev, WHISPER, times)

    # RWKV: attention-free; no kernel launches at all.
    served = _serve_family(dev, RWKV, times, keep=())
    assert served["launches"] == {**other, "flash_attention": 0}, served["launches"]
    launches[RWKV["arch"]] = 0
    del served
    torch.cuda.empty_cache()
    _family_f32_check(dev, RWKV, times)

    return {"family_launches": launches,
            "family_max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            "family_shapes": shapes}


def _flash_bwd_flop(q, k, v, causal: bool, window) -> int:
    """flash_attention's backward work: 2 (3 dh + 2 dv) FLOP per attended
    (query, key) pair and head, the five products (the scores recomputed,
    dp, dv, dk and dq)."""
    b, s, h, dh = q.shape
    t, dv = k.shape[1], v.shape[3]
    return 2 * (3 * dh + 2 * dv) * b * h * _attn_pairs(s, t, causal, window)


def _flash_bwd_bound(q, k, v, causal: bool, window) -> tuple[float, str]:
    """flash_attention's backward bound: q, k, v, the output and its
    gradient read once, dq, dk and dv written once, against
    ``_flash_bwd_flop`` on the tensor cores (bf16) or the CUDA cores
    (float32)."""
    b, s, h, dh = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    n_bytes = q.element_size() * 2 * (b * s * h * (dh + dv) + b * t * kvh * (dh + dv))
    n_ops = _flash_bwd_flop(q, k, v, causal, window)
    rate = BF16_TENSOR_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _path_qkv(params, cfg, tokens):
    """Layer 0's attention inputs on the training path: the normed
    embeddings projected to q, k, v with RoPE, as ``attention_full`` makes
    them."""
    from repro_torch.models import attention, common, model
    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        h = tfm._norm(params.layers[0].ln1, model.embed_tokens(params, tokens, cfg), cfg)
        q, k, v = attention._project_qkv(params.layers[0].attn, h, h, cfg)
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)[None]
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _plain_guard(ref) -> tuple[dict, callable]:
    """Count every call of the kernels' plain versions until ``undo()``."""
    calls = {}
    saved = {}
    for name in ("flash_attention_ref", "flash_attention_bwd_ref", "moe_route_ref",
                 "moe_route_weights_vjp_ref"):
        fn = saved[name] = getattr(ref, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(ref, name, counted)

    def undo():
        for name, fn in saved.items():
            setattr(ref, name, fn)

    return calls, undo


def _bwd_kernel_us(call) -> dict:
    """Device us a call of each kernel that ``call`` (one backward) launches,
    by name, from a profile of 5 calls; empty if the profiler saw no device
    time (as in a process that has profiled before)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    return {ev.key.split("<")[0].split("::")[-1]: ev.self_device_time_total / 5
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total}


def _profile_train_step(step_fn, state, batch, step_ms: float) -> dict:
    """One profiled train step (device activity only): device busy time
    against the unprofiled step, the backward flash kernels' share of the
    step and each one's device us a launch (``bwd_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
    device = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in device)
    if busy_us == 0:
        print("phase 9 profile: the profiler saw no device time; busy share not measured")
        return {"busy_share": None, "bwd_share": None, "bwd_kernels": {}}
    device.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
    bwd_us = sum(ev.self_device_time_total for ev in device if "bwd_d" in ev.key)
    fwd_us = sum(ev.self_device_time_total for ev in device
                 if "flash_" in ev.key and "bwd" not in ev.key)
    print(f"phase 9 profile of one train step: device busy {busy_us / 1e3:.3f} ms against an "
          f"unprofiled step of {step_ms:.3f} ms (busy share {busy_us / 1e3 / step_ms:.4f}); "
          f"flash_attention backward {bwd_us / 1e3:.3f} ms ({bwd_us / 1e3 / step_ms:.4f} of the "
          f"step), forward {fwd_us / 1e3:.3f} ms; {sum(ev.count for ev in device)} device "
          f"operations; top: " + "; ".join(
              f"{ev.key[:50]} {ev.self_device_time_total / 1e3:.2f} ms x{ev.count}"
              for ev in device[:8]))
    return {"busy_share": busy_us / 1e3 / step_ms, "bwd_share": bwd_us / 1e3 / step_ms,
            "bwd_kernels": {ev.key.split("<")[0].split("::")[-1]: ev.self_device_time_total
                            / ev.count for ev in device if "bwd_d" in ev.key}}


def _training_phase(dev, times: dict, card_tests) -> list:
    """Phase 9: the backward kernels against their plain versions, the
    train step on the card against the CPU, SmolLM-135M trained at full
    width and depth through ``repro_torch.launch.train`` (crash and resume),
    and the MoE training example.  Returns the kernels line's entries of
    ``flash_attention_bwd`` and ``moe_route_bwd``."""
    import shutil

    import torch.nn.functional as F

    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attn, moe_route, ops, ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models import common
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated(dev) < 1e9, (
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated before phase 9")

    # (a) each backward kernel against its plain version.
    flash_err, moe_err = 0.0, 0.0
    for case in card_tests.FLASH_BWD_CASES:
        q, k, v, dout, kw = card_tests.flash_bwd_inputs(case, dev)
        err = card_tests.flash_bwd_vs_plain(q, k, v, dout, kw)
        flash_err = max(flash_err, err)
        print(f"phase 9 flash_attention_bwd {case} {card_tests.FLASH_BWD_CASES[case][:8]} "
              f"{kw}: largest error / largest of dq, dk, dv {err:.3g} (at most "
              f"{card_tests.FLASH_BWD_TOL[q.dtype]})")
    for case in ("smollm_path", "gemma2_dh256"):
        card_tests.flash_bwd_repeat_equal(*card_tests.flash_bwd_inputs(case, dev))
        print(f"phase 9 flash_attention_bwd {case}: two calls give equal dq, dk, dv bits")
    del q, k, v, dout
    for case in card_tests.MOE_BWD_CASES:
        inputs = card_tests.moe_bwd_inputs(case, dev)
        err = card_tests.moe_bwd_vs_plain(*inputs)
        card_tests.moe_bwd_repeat_equal(*inputs)
        moe_err = max(moe_err, err)
        print(f"phase 9 moe_route_bwd {case} {card_tests.MOE_BWD_CASES[case]}: max abs err "
              f"{err:.3g} (within atol 1e-6, rtol 1e-5), two calls equal bit for bit")
    del inputs
    times["train_kernels_s"] = time.perf_counter() - t_phase

    # (b) one train step on the card against the same step on the CPU.
    t0 = time.perf_counter()
    for arch, sync, micro in card_tests.TRAIN_STEP_CASES:
        r = card_tests.train_step_card_vs_cpu(dev, arch, sync, micro)
        print(f"phase 9 train step card == CPU, {arch} reduced float32, sync {sync}, "
              f"{micro} microbatch(es), 2 steps: largest difference {r['max_rel_err']:.3g} of "
              f"each leaf's largest magnitude (at most 1e-4), routed counts equal; card launches "
              f"flash_attention {r['launches']['flash_attention']} / bwd "
              f"{r['launches']['flash_attention_bwd']}, moe_route {r['launches']['moe_route']} / "
              f"bwd {r['launches']['moe_route_bwd']}")
    times["train_step_vs_cpu_s"] = time.perf_counter() - t0

    # (c) SmolLM-135M at full width and depth through the launcher.
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings, cfg.param_dtype) == (
        30, 576, 9, 3, 64, 1536, 49152, True, "bfloat16"), cfg
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    calls, undo = _plain_guard(ref)
    try:
        try:
            launch_train.main(TRAIN_ARGS + ["--ckpt-dir", str(ckpt_dir),
                                            "--crash-at", str(TRAIN_CRASH_AT)])
            raise AssertionError("the launcher did not crash")
        except SystemExit as exc:
            assert exc.code == 42, exc.code
        assert checkpoint.latest_step(ckpt_dir) == TRAIN_CRASH_AT
        resumed = launch_train.main(TRAIN_ARGS + ["--ckpt-dir", str(ckpt_dir)])
        assert resumed["start_step"] == TRAIN_CRASH_AT
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        whole = launch_train.main(TRAIN_ARGS)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    finally:
        undo()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = len(whole["losses"])
    assert not calls, f"plain versions ran on the card's training path: {calls}"
    assert launches == {"jsaq_route": 0, "care_route": 0, "serve_route": 0, "serve_slots": 0,
                        "moe_route": 0, "flash_attention": 30 * n_steps, "moe_route_bwd": 0,
                        "flash_attention_bwd": 30 * n_steps}, launches
    losses = np.array(whole["losses"])
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    resume_diff = np.abs(np.array(resumed["losses"]) - losses[TRAIN_CRASH_AT:]) / np.abs(
        losses[TRAIN_CRASH_AT:])
    assert resume_diff.max() <= TRAIN_RESUME_RTOL, (resumed["losses"], losses)
    step_ms = float(np.median(whole["step_s"][1:])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    times["train_full_s"] = time.perf_counter() - t0
    print(f"phase 9 {TRAIN_ARCH} full width and depth (30 layers, d_model 576, 9 heads / 3 KV "
          f"of 64, d_ff 1536, vocab 49152, tied, bf16), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{n_steps} steps: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; crash after step {TRAIN_CRASH_AT} and relaunch: resumed losses "
          + ", ".join(f"{x:.4f}" for x in resumed["losses"])
          + f" (largest relative difference from the uninterrupted run {resume_diff.max():.3g}, "
          f"at most {TRAIN_RESUME_RTOL}); launches a step: flash_attention "
          f"{launches['flash_attention'] // n_steps}, flash_attention_bwd "
          f"{launches['flash_attention_bwd'] // n_steps}; no plain version called; step "
          f"{step_ms:.1f} ms (median of steps 2-{n_steps}), "
          f"{tokens / step_ms * 1e3:,.0f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB; {times['train_full_s']:.1f} s")

    # (d) a profiled step, AdamW's share, and the kernel at the path's shape.
    t0 = time.perf_counter()
    opt_cfg = adamw.OptimConfig(lr=3e-4, total_steps=12, warmup_steps=2)
    state = train_loop.init_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    step_fn = train_loop.make_train_step(cfg, opt_cfg)
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    batch = pipeline.global_batch_at(0, data)
    state, _ = step_fn(state, batch)  # warm
    prof = _profile_train_step(step_fn, state, batch, step_ms)
    grads = {n: torch.full_like(p, 1e-3) for n, p in state.params.named_parameters()}
    adamw_ms = _time_ms(lambda: adamw.update(grads, state.opt, state.params, opt_cfg), 3)
    del grads
    print(f"phase 9 AdamW update alone ({common.param_count(state.params):,} parameters, "
          f"{len(state.opt.m)} tensors): "
          f"{adamw_ms:.3f} ms, {adamw_ms / step_ms:.4f} of the step")
    tokens_t = torch.from_numpy(batch["tokens"]).to(dev)
    q, k, v = _path_qkv(state.params, cfg, tokens_t)
    del state
    kw = dict(scale=cfg.resolved_head_dim ** -0.5, causal=True, window=None, softcap=0.0)
    dout = torch.randn(q.shape[:3] + (v.shape[3],), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(q.dtype)
    one = card_tests.flash_bwd_vs_plain(q[:1].contiguous(), k[:1].contiguous(),
                                        v[:1].contiguous(), dout[:1].contiguous(), kw)
    flash_err = max(flash_err, one)
    out, lse = flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    bwd_ms = _time_ms(lambda: flash_attn.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw),
                      BWD_TIME_REPS)
    fwd_ms = _time_ms(lambda: flash_attn.flash_attention_cuda(q, k, v, **kw), BWD_TIME_REPS)
    fwd_lse_ms = _time_ms(lambda: flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw),
                          BWD_TIME_REPS)
    split = prof["bwd_kernels"]  # the step's layers run the path's shape
    plain_ms = _time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, dout, **kw), 1)
    bound = _flash_bwd_bound(q, k, v, True, None)
    bwd_tflops = _flash_bwd_flop(q, k, v, True, None) / bwd_ms / 1e9
    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=kw["scale"])
    dout_t = dout.transpose(1, 2)
    sdpa_ms = _time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                                   retain_graph=True), BWD_TIME_REPS)
    del qt, kt, vt, sdpa_out, out, lse
    split_total = sum(split.values())
    d_us = split.get("bwd_dot_kernel")
    print(f"phase 9 flash_attention_bwd at the path's shape (layer 0's q/k/v, "
          f"{tuple(q.shape)}, {q.dtype}, causal): against its plain version at B=1 "
          f"{one:.3g} of the largest gradient; kernel {bwd_ms:.4f} ms (the CUDA-core design "
          f"it replaced: 13.274-13.399 ms, PERF.md), {bwd_tflops:.1f} TFLOP/s (the bound's five "
          f"products), plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), bound / "
          f"kernel {bound[0] / bwd_ms:.4f}; PyTorch SDPA's own backward (K and V repeated to 9 "
          f"heads) {sdpa_ms:.4f} ms, kernel / SDPA {bwd_ms / sdpa_ms:.3f}; 30 layers' backward "
          f"{30 * bwd_ms:.1f} ms, {30 * bwd_ms / step_ms:.4f} of the step")
    print("phase 9 flash_attention_bwd's launches, device us a launch (the profiled step): "
          + (", ".join(f"{n} {us:.1f}" for n, us in split.items())
             + f"; the D pass {d_us / split_total:.4f} of them" if d_us else "not measured")
          + f"; the forward at this shape {fwd_ms:.4f} ms without lse, {fwd_lse_ms:.4f} ms "
          f"writing it ({fwd_lse_ms / fwd_ms:.4f}x)")
    del q, k, v, dout
    torch.cuda.empty_cache()

    moe_shapes = {}
    for case in MOE_BWD_TIMED:
        logits, idx, gw, gate = card_tests.moe_bwd_inputs(case, dev)
        ms = _device_ms(lambda: moe_route.moe_route_bwd_cuda(logits, idx, gw, gate_fn=gate),
                        MOE_TIME_REPS)
        plain = _time_ms(lambda: ref.moe_route_weights_vjp_ref(logits, idx, gw, gate), 3)
        # (its own name: ``bound`` is the attention backward's, for the kernels line)
        moe_bound = _moe_bwd_bound(*logits.shape, idx.shape[1])
        moe_shapes[case] = {"ms": ms, "plain_ms": plain, "bound_ms": moe_bound[0],
                            "bound_by": moe_bound[1], "bound_share": moe_bound[0] / ms}
        print(f"phase 9 moe_route_bwd at {case} {card_tests.MOE_BWD_CASES[case][:4]}: kernel "
              f"{ms:.5f} ms (device time, queue filled), plain {plain:.3f} ms, bound "
              f"{moe_bound[0]:.6f} ms ({moe_bound[1]}), bound / kernel {moe_bound[0] / ms:.4f}")
    del logits, idx, gw
    main_moe = moe_shapes[MOE_BWD_TIMED[0]]
    times["train_profile_s"] = time.perf_counter() - t0

    # (e) the MoE training example on the card, as a subprocess.
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.examples.train_moe_care",
                           *TRAIN_EXAMPLE_ARGS], capture_output=True, text=True,
                          timeout=EXAMPLE_TIMEOUT_S, env=env, cwd=ROOT)
    times["train_example_s"] = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[done]" in proc.stdout, proc.stdout[-2000:]
    lines = proc.stdout.strip().splitlines()
    ex_launches = json.loads(next(ln for ln in lines if ln.startswith("[launches]")).split(
        " ", 1)[1])
    ecfg = get_config("deepseek-v2-236b").reduced()
    steps, every = int(TRAIN_EXAMPLE_ARGS[1]), int(TRAIN_EXAMPLE_ARGS[7])
    crash = steps // 2
    n_run = crash + steps - (crash - crash % every)  # to the crash, then from its checkpoint
    n_moe = ecfg.num_layers - ecfg.first_dense_layers
    assert ex_launches["moe_route"] == ex_launches["moe_route_bwd"] == n_moe * n_run, (
        ex_launches, n_moe, n_run)
    print(f"phase 9 example train_moe_care {' '.join(TRAIN_EXAMPLE_ARGS)}: exit 0 in "
          f"{times['train_example_s']:.1f} s; " + " | ".join(
              ln.strip() for ln in lines if ln.startswith(("[done]", "[launches]"))))
    times["train_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 9: {times['train_phase_s']:.1f} s")

    return [
        {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
            "replaces": "src/repro/kernels/flash_attn.py:84",
            "launches": launches["flash_attention_bwd"], "launches_per_step": 30,
            "max_abs_err": flash_err, "ms": bwd_ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": sdpa_ms,
            "bound_share": bound[0] / bwd_ms, "tflops": bwd_tflops,
            "over_library": bwd_ms / sdpa_ms, "kernel_device_us": split,
            "d_pass_share": d_us / split_total if d_us else None,
            "fwd_ms": fwd_ms, "fwd_lse_ms": fwd_lse_ms,
            "train_step_ms": step_ms, "train_tokens_per_s": tokens / step_ms * 1e3,
            "train_peak_gb": peak_gb, "train_busy_share": prof["busy_share"],
            "train_bwd_share": prof["bwd_share"], "train_adamw_share": adamw_ms / step_ms,
        },
        {
            "name": "moe_route_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_route_bwd.cu",
            "replaces": "src/repro/kernels/moe_route.py:89",
            "launches": ex_launches["moe_route_bwd"], "max_abs_err": moe_err,
            "ms": main_moe["ms"], "plain_ms": main_moe["plain_ms"],
            "bound_ms": main_moe["bound_ms"], "bound_by": main_moe["bound_by"],
            "library_ms": None, "shapes": moe_shapes,
        },
    ]


def _flash_build_report() -> None:
    """Registers, spills and shared memory of each flash kernel instance,
    from the ``-Xptxas -v`` log kept beside the library (shared memory is
    dynamic, so it comes from the library's own size query)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as flash_k

    log = (_build.build_dir() / "libflash_attn.log").read_text(errors="replace")
    name, spill = None, ""
    for line in log.splitlines():
        if m := re.search(r"entry function .*(flash_wgmma|flash_kernel)(?:I(\w+?)EEv|E)", line):
            widths = [int(w) for w in re.findall(r"Li(\d+)E", (m.group(2) or "") + "E")]
            name, dtype = m.group(1), (torch.bfloat16 if widths else torch.float32)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            dh, dv = widths or (256, 256)
            smem = flash_k.smem_bytes(dtype, dh, dv)
            label = f"{name}<{dh}, {dv}>" if widths else f"{name} at dh = dv = 256"
            regs = f"{m.group(1)} registers at launch (setmaxnreg: " + (
                "240 a consumer, 24 a producer thread)" if widths
                else "232 a consumer, 40 a producer thread)")
            print(f"phase 1 flash_attn {label}: {regs}, {spill}, {smem} B of dynamic shared "
                  f"memory a block")
            name = None
    # The backward's kernels: the D pass, and bf16's dq and dk/dv on wgmma
    # (setmaxnreg 240 / 24 but in the one-consumer dq block at dh = dv =
    # 256), and the float32 CUDA-core pair (by float4 column groups a thread).
    log = (_build.build_dir() / "libflash_attn_bwd.log").read_text(errors="replace")
    name, spill = None, ""
    kinds = "bwd_dq_wgmma|bwd_dkv_wgmma|bwd_dot_kernel|bwd_dq_kernel|bwd_dkv_kernel"
    for line in log.splitlines():
        if m := re.search(rf"entry function .*({kinds})I(\w+?)EEv", line):
            name, widths = m.group(1), [int(w) for w in re.findall(r"Li(\d+)E", m.group(2) + "E")]
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            if name.endswith("wgmma"):
                dh, dv = widths
                kernel = "dq" if name == "bwd_dq_wgmma" else "dkv"
                at = "" if kernel == "dq" and dh + dv > 384 else " at launch (setmaxnreg)"
                print(f"phase 1 flash_attn_bwd {name}<{dh}, {dv}>: {m.group(1)} registers{at}, "
                      f"{spill}, {flash_k.bwd_smem_bytes(kernel, dh, dv)} B of dynamic shared "
                      f"memory a block")
            else:
                print(f"phase 1 flash_attn_bwd {name}<{widths[0]}>: {m.group(1)} registers, "
                      f"{spill}")
            name = None


def _breadth_calls(slotted_sim) -> list:
    """Phase 4b's calls, ``(name, cells)``, one ``simulate_grid`` call (one
    static kind) each: Table 5's and the quickstart's SQ(2) with a diurnal
    cell, random, the bursty and heterogeneous CCDF cells
    (``benchmarks/bench_jct_ccdf.py:116-130``), the heavy-tail quick set
    (``bench_heavy_tail.py``), Weibull, the pull frontier's JIQ and hsq
    (``bench_pull.py:47-53``), and two classes on overlapping servers."""
    base = dict(servers=30, slots=BREADTH_SLOTS, buffer_cap=2048, mean_service=30,
                load=0.95, policy="jsaq", comm="et", x=3, approx="msr")
    rates = tuple(1.5 if i < 15 else 0.5 for i in range(30))
    group_a = tuple(i < 20 for i in range(30))
    group_b = tuple(i >= 10 for i in range(30))

    def cell(**kw):
        return slotted_sim.SimConfig(**{**base, **kw})

    sq2 = dict(policy="sq2", comm="none")
    return [
        ("sq2", [cell(**sq2), cell(**sq2, load=0.9, diurnal_amp=0.1,
                                   diurnal_period=2000)]),
        ("random", [cell(policy="random", comm="none")]),
        ("bursty_et3_msr", [cell(arrival="mmpp", burst_intensity=1.7)]),
        ("bursty_sq2", [cell(**sq2, arrival="mmpp", burst_intensity=1.7)]),
        ("hetero_et3_msr", [cell(service_rates=rates)]),
        ("hetero_sq2", [cell(**sq2, service_rates=rates)]),
        ("pareto_et_msr", [cell(x=x, service="pareto", service_tail=a)
                           for a in (1.5, 3.0) for x in (2, 3, 8)]),
        ("weibull_et3_msr", [cell(service="weibull", service_tail=0.5)]),
        ("jiq", [cell(policy="jiq", comm="jiq", load=0.9)]),
        ("hsq", [cell(policy="hsq", comm="hsq", load=0.9, rt_rate=0.02)]),
        ("classes_et3_msr", [cell(class_mix=(0.5, 0.5),
                                  class_affinity=(group_a, group_b))]),
    ]


def _profile_dense(slotted_sim, cell) -> None:
    """Where a dense-backend call's time goes: ``cell`` once unprofiled
    (its wall) and once under the profiler; the device busy share is its
    device time against that wall."""
    from torch.profiler import ProfilerActivity, profile

    static, scn = cell.static_part(), cell.scenario()
    seeds = list(BREADTH_SEEDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slotted_sim.simulate_grid(seeds, static, [scn])
    wall_s = time.perf_counter() - t0
    for _ in range(2):  # as _profile_serving: a second try before giving up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            slotted_sim.simulate_grid(seeds, static, [scn])
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in device)
        if device_us:
            break
    else:
        print("phase 4b dense profile: the profiler saw no device time; not measured")
        return
    launches = sum(e.count for e in device)
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"phase 4b dense profile ({cell.policy}, {len(seeds)} runs x {cell.slots} "
          f"slots): unprofiled wall {wall_s:.4f} s ({wall_s / cell.slots * 1e3:.3f} ms a "
          f"slot), device busy {device_us / 1e3:.3f} ms, busy share "
          f"{device_us / 1e6 / wall_s:.4f}; {launches} device operations, "
          f"{launches / cell.slots:.1f} a slot; top: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in device[:5]))


def _slotted_breadth(dev, times: dict, card_tests) -> None:
    """Phase 4b: the slotted tier's policies and workloads on the card
    through the dense backend, each call against the CPU on its draws."""
    from repro_torch.core.care import metrics, slotted_sim
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    cpu_total = 0.0
    for name, cells in _breadth_calls(slotted_sim):
        static = cells[0].static_part()
        ops.reset_launch_counts()
        grid, card_s, cpu_s, draws, raw = card_tests.grid_vs_cpu(
            dev, BREADTH_SEEDS, static, [c.scenario() for c in cells])
        launches = ops.launch_counts()
        assert sum(launches.values()) == 0, launches  # the dense backend
        times[f"breadth_{name}_s"] = card_s
        cpu_total += cpu_s
        for c, (cfg, row) in enumerate(zip(cells, grid)):
            for r in row:
                assert r.arrivals == r.departures + int(r.final_q.sum()), name
                assert r.token_misses >= 0 and r.token_sum >= 0, name
                if cfg.comm == "et":
                    assert r.max_aq <= cfg.x - 1, (name, r.max_aq)  # Prop 6.8
                if cfg.policy == "sq2":
                    assert metrics.relative_communication(r, "sq2") == (
                        4 * r.arrivals / max(r.departures, 1))
                if cfg.policy == "jiq":
                    assert r.messages <= r.departures, name
                if cfg.service_rates is not None and cfg.policy == "jsaq":
                    fast = int(r.per_server_arrivals[:15].sum())
                    assert fast > 0.5 * r.arrivals, (name, fast, r.arrivals)
            if cfg.class_affinity is not None:
                aff = torch.tensor(cfg.class_affinity)
                n_s = len(BREADTH_SEEDS)
                routed = raw["routed"][c * n_s:(c + 1) * n_s].long()
                cls = draws["classes"][c * n_s:(c + 1) * n_s].long()
                took = routed >= 0
                assert bool(aff[cls[took], routed[took]].all()), name
            jct = np.concatenate([r.jct for r in row])
            s = metrics.jct_summary(jct)
            assert s["count"] > 0 and np.isfinite(s["mean"]), name
            arrived = sum(r.arrivals + r.dropped for r in row)
            tokens = metrics.token_summary(sum(r.token_sum for r in row),
                                           sum(r.token_misses for r in row),
                                           BREADTH_SLOTS * len(row), arrived)
            label = f"{name}[{c}]" if len(cells) > 1 else name
            print(f"phase 4b {label} (load {cfg.load}, x {cfg.x}, "
                  f"{len(BREADTH_SEEDS)} seeds x {BREADTH_SLOTS} slots): JCT mean "
                  f"{s['mean']:.3f} p99 {s['p99']:.1f}, messages per departure "
                  f"{np.mean([r.msgs_per_departure for r in row]):.4f}, max_aq "
                  f"{max(r.max_aq for r in row)}, token miss rate "
                  f"{tokens['miss_rate']:.4f}")
        print(f"phase 4b {name}: card {card_s:.2f} s ({len(cells) * len(BREADTH_SEEDS)} "
              f"runs, {card_s / BREADTH_SLOTS * 1e3:.3f} ms a slot), the CPU on the "
              f"same draws {cpu_s:.2f} s: every SimResult field equal")
    times["breadth_cpu_s"] = cpu_total
    _profile_dense(slotted_sim, dataclasses.replace(
        _breadth_calls(slotted_sim)[0][1][0], slots=BREADTH_PROFILE_SLOTS))

    wide = slotted_sim.SimConfig(**BREADTH_WIDE)
    static, scn = wide.static_part(), wide.scenario()
    n, t = len(BREADTH_WIDE_SEEDS), wide.slots
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    arrive, sizes, draws = slotted_sim.draw_workload(BREADTH_WIDE_SEEDS, static, [scn], dev)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated(dev) - before
    held = sum(x.numel() * x.element_size() for x in (arrive, sizes, *draws.values()))
    assert draws["subset"].shape == (n, t, 2)
    # O(N T d): a (N, T, K) permutation would take 4 N T K bytes.
    assert draw_peak <= 64 * n * t * 2 * 4, draw_peak
    del arrive, sizes, draws
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = slotted_sim.simulate_grid(BREADTH_WIDE_SEEDS, static, [scn], device=dev)[0]
    times["breadth_wide_s"] = time.perf_counter() - t0
    assert sum(ops.launch_counts().values()) == 0
    for r in res:
        assert r.arrivals == r.departures + int(r.final_q.sum()) and r.arrivals > 0
    print(f"phase 4b sq2 K={wide.servers:.0e} cap {wide.buffer_cap}, {n} seeds x {t} "
          f"slots: {times['breadth_wide_s']:.2f} s ({times['breadth_wide_s'] / t * 1e3:.3f} "
          f"ms a slot); the draws hold {held} B, their peak {draw_peak} B "
          f"(a (N, T, K) permutation: {4 * n * t * wide.servers} B); the run's peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 1e6:.1f} MB; JCT mean "
          f"{metrics.jct_summary(np.concatenate([r.jct for r in res]))['mean']:.3f}")
    times["breadth_phase_s"] = time.perf_counter() - t_phase


def _degraded_calls(slotted_sim) -> list:
    """Phase 4c's slotted calls, ``(name, cells)``, one ``simulate_grid``
    call (one static kind) each, at the paper's Section 9.1 setting (K =
    30, load 0.95, geometric sizes of mean 30, cap 2048): CARE's delay
    ladder and drop ladder (``benchmarks/bench_faults.py:104-170``), stale
    SQ(2) over the delay ladder, the ack loss ladder and JIQ's token repair
    at load 0.9 (``bench_retrans.py:53-80``), and the crash and slow cells
    of ``tests/test_faults.py:594-595``."""
    base = dict(servers=30, slots=DEGRADED_SLOTS, buffer_cap=2048, mean_service=30,
                load=0.95, policy="jsaq", comm="et", x=3, approx="msr")

    def cell(**kw):
        return slotted_sim.SimConfig(**{**base, **kw})

    net = dict(network="net", net_delay=2, net_jitter=1)
    ack = dict(transport="ack", ack_timeout=8, backoff_base=2.0, max_retries=6)
    return [
        ("care_delay_drop", [cell(network="net", net_delay=d) for d in (1, 4, 8, 16)]
         + [cell(network="net", net_delay=2, net_drop=p) for p in (0.0, 0.1, 0.3, 0.5)]),
        ("sq2_delay", [cell(policy="sq2", comm="rt", rt_rate=1e-4, network="net",
                            net_delay=d) for d in (1, 4, 8, 16)]),
        ("ack_drop", [cell(**net, **ack, net_drop=p) for p in (0.1, 0.3, 0.5)]),
        ("jiq_ff_drop10", [cell(policy="jiq", comm="jiq", load=0.9, **net, net_drop=0.1)]),
        ("jiq_ack_drop10", [cell(policy="jiq", comm="jiq", load=0.9, **net, **ack,
                                 net_drop=0.1)]),
        ("crash", [cell(fault="crash", crash_rate=0.005, recover_rate=0.1,
                        suspect_age=20)]),
        ("slow", [cell(fault="slow", crash_rate=0.01, recover_rate=0.1, slow_factor=0.5)]),
    ]


def _serve_degraded_calls(engine) -> list:
    """Phase 4c's serving calls, ``(name, cell)``, one ``serve_grid`` call
    each: ``benchmarks/bench_pull.py:68-92``'s frontier (8 replicas x 16
    decode slots, load 0.9, mean prefill 4, decode 60, MSR drain 0.25;
    CARE, SQ(2), JIQ and hsq with x 16) degraded (delay 2, drop 0.1,
    suspect_age 8; CARE over et_rt with rt_period 32) and clean."""
    work = dict(replicas=8, decode_slots=16, slots=SERVE_DEGRADED_SLOTS, load=0.9,
                mean_prefill=4, mean_decode=60, msr_drain=0.25, queue_cap=512)
    calls = []
    for tag, extra in (("degraded", dict(network="net", net_delay=2, net_drop=0.1,
                                         suspect_age=8)), ("clean", {})):
        care = dict(comm="et_rt", rt_period=32) if extra else dict(comm="et")
        for name, kw in (("care_et3", dict(x=3, **care)),
                         ("sqd", dict(policy="sqd", sqd=2, comm="et", x=3)),
                         ("jiq", dict(policy="jiq", comm="jiq")),
                         ("hsq", dict(policy="hsq", comm="hsq", x=16, rt_period=32))):
            calls.append((f"{tag}_{name}", engine.ServeConfig(**work, **extra, **kw)))
    return calls


def _crash_cells(engine) -> tuple:
    """``bench_faults.py:203-240``'s engineered outage: 8 replicas x 8 decode
    slots, ET-3 over et_rt with rt_period 8, load 0.85, mean prefill 4,
    decode 28, MSR 0.25; replica 3 crashes at a quarter of the horizon and
    recovers at half.  Returns the workload and the (name, cell) pairs:
    fault-free, suspect masking on (suspect_age 16) and off."""
    crash_at, recover_at = CRASH_SLOTS // 4, CRASH_SLOTS // 2
    wl = engine.sample_workload(0, replicas=8, decode_slots=8, slots=CRASH_SLOTS,
                                load=0.85, mean_prefill=4, mean_decode=28,
                                with_fault=True)
    wl.fault_u[:] = 0.9  # above both rates: no transition ...
    wl.fault_u[crash_at, 3] = 0.0  # ... but these two
    wl.fault_u[recover_at, 3] = 0.0
    base = dict(replicas=8, decode_slots=8, slots=CRASH_SLOTS, load=0.85,
                mean_prefill=4, mean_decode=28, msr_drain=0.25, comm="et_rt", x=3,
                rt_period=8, queue_cap=1024)
    crash = dict(fault="crash", crash_rate=0.5, recover_rate=0.5)
    return wl, [("fault_free", engine.ServeConfig(**base)),
                ("suspect_on", engine.ServeConfig(**base, **crash, suspect_age=16)),
                ("suspect_off", engine.ServeConfig(**base, **crash))]


def _same_serve(engine, got, want, label: str) -> None:
    for f in dataclasses.fields(engine.ServeResult):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f"{label} {f.name}"
        else:
            assert a == b, f"{label} {f.name}: {a} != {b}"


def _degraded(dev, times: dict, card_tests) -> None:
    """Phase 4c: the degraded control plane on both dense backends, each
    call against the CPU on the same draws, every result field equal."""
    from repro_torch.core.care import metrics, slotted_sim
    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    cpu_total = 0.0
    seeds = list(DEGRADED_SEEDS)
    for name, cells in _degraded_calls(slotted_sim):
        static = cells[0].static_part()
        crash = static.fault == "crash"
        ops.reset_launch_counts()
        grid, card_s, cpu_s, _, raw = card_tests.grid_vs_cpu(
            dev, seeds, static, [c.scenario() for c in cells], raw_on_card=crash)
        assert sum(ops.launch_counts().values()) == 0, ops.launch_counts()
        times[f"degraded_{name}_s"] = card_s
        cpu_total += cpu_s
        for cfg, row in zip(cells, grid):
            for r in row:
                assert r.arrivals == r.departures + int(r.final_q.sum()), name
                assert r.token_misses >= 0 and r.token_sum >= 0, name
                if cfg.policy == "sq2":
                    assert r.messages >= 4 * r.arrivals, name
            if cfg.net_drop > 0 and sum(r.messages for r in row) >= DROP_CHECK_MSGS:
                assert sum(r.net_drops for r in row) > 0, name
                if cfg.transport == "ack":
                    assert sum(r.retrans for r in row) > 0, name
            jct = metrics.jct_summary(np.concatenate([r.jct for r in row]))
            assert jct["count"] > 0 and np.isfinite(jct["mean"]), name
            print(f"phase 4c {name} (delay {cfg.net_delay}, jitter {cfg.net_jitter}, drop "
                  f"{cfg.net_drop}, fault {cfg.fault}): JCT mean {jct['mean']:.3f} p99 "
                  f"{jct['p99']:.1f}, messages a slot "
                  f"{np.mean([r.messages for r in row]) / DEGRADED_SLOTS:.4f}, net drops "
                  f"{sum(r.net_drops for r in row)}, retransmits "
                  f"{sum(r.retrans for r in row)}, token misses "
                  f"{sum(r.token_misses for r in row)}")
        if crash:
            # Every routed arrival, slot by slot: none went to a suspect
            # server while some server was healthy (the card's counters).
            assert int(raw["suspect_routes"].sum()) == 0, raw["suspect_routes"]
            assert int(raw["masked_routes"].sum()) > 0
            print(f"phase 4c {name}: arrivals routed under a partial suspect mask "
                  f"{raw['masked_routes'].tolist()}, to a suspect server "
                  f"{raw['suspect_routes'].tolist()}")
        print(f"phase 4c {name}: card {card_s:.2f} s ({len(cells) * len(seeds)} runs, "
              f"{card_s / DEGRADED_SLOTS * 1e3:.3f} ms a slot), the CPU on the same draws "
              f"{cpu_s:.2f} s: every SimResult field equal")

    # The zero-operand network and a fault chain that never fires equal
    # the instant fault-free cell, bit for bit, on the card.
    plain = slotted_sim.SimConfig(servers=30, slots=IDENTITY_SLOTS, load=0.95,
                                  mean_service=30, policy="jsaq", comm="et", x=3)
    ref = slotted_sim.simulate_batch([0, 1], plain, device=dev)
    for zero in (dict(network="net"), dict(fault="crash")):
        got = slotted_sim.simulate_batch([0, 1], dataclasses.replace(plain, **zero),
                                         device=dev)
        for a, b in zip(got, ref):
            card_tests.same_results(a, b, f"slotted zero-operand {zero}")
    cell = engine.ServeConfig(replicas=8, decode_slots=16, slots=IDENTITY_SLOTS,
                              load=0.9, mean_prefill=4, mean_decode=60, msr_drain=0.25)
    ref = engine.serve_grid([0, 1], cell.static_part(), [cell], device=dev)[0]
    for zero in (dict(network="net"), dict(fault="crash")):
        zcell = dataclasses.replace(cell, **zero)
        got = engine.serve_grid([0, 1], zcell.static_part(), [zcell], device=dev)[0]
        for a, b in zip(got, ref):
            _same_serve(engine, a, b, f"serving zero-operand {zero}")
    print(f"phase 4c zero-operand identity on the card: network='net' and "
          f"fault='crash' with zero operands equal 'none' bit for bit, slotted and "
          f"serving ({IDENTITY_SLOTS} slots, 2 seeds)")

    for name, cell in _serve_degraded_calls(engine):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = engine.serve_grid(seeds, cell.static_part(), [cell], device=dev)[0]
        card_s = time.perf_counter() - t0
        assert sum(ops.launch_counts().values()) == 0, ops.launch_counts()
        t0 = time.perf_counter()
        cpu = engine.serve_grid(seeds, cell.static_part(), [cell], device="cpu")[0]
        cpu_s = time.perf_counter() - t0
        times[f"serve_degraded_{name}_s"] = card_s
        cpu_total += cpu_s
        for seed, a, b in zip(seeds, card, cpu):
            _same_serve(engine, a, b, f"{name} seed {seed}")
            assert a.offered == a.completed + a.dropped + int(a.final_occupancy.sum())
            assert a.token_misses >= 0 and a.token_sum >= 0
            if cell.policy == "sqd" and cell.network != "none":
                assert a.messages >= 2 * cell.sqd * a.offered, name
        if cell.net_drop > 0 and sum(r.messages for r in card) >= DROP_CHECK_MSGS:
            assert sum(r.net_drops for r in card) > 0, name
        jct = float(np.mean([r.mean_jct for r in card]))
        arrived = sum(r.offered for r in card)
        tokens = metrics.token_summary(sum(r.token_sum for r in card),
                                       sum(r.token_misses for r in card),
                                       SERVE_DEGRADED_SLOTS * len(card),
                                       arrived if cell.policy in ("jiq", "hsq") else 0)
        print(f"phase 4c serving {name}: JCT mean {jct:.3f}, messages per completion "
              f"{np.mean([r.msgs_per_completion for r in card]):.4f}, net drops "
              f"{sum(r.net_drops for r in card)}, token miss rate "
              f"{tokens['miss_rate']:.4f}; card {card_s:.2f} s ({len(seeds)} runs, "
              f"{card_s / SERVE_DEGRADED_SLOTS * 1e3:.3f} ms a slot), the CPU "
              f"{cpu_s:.2f} s: every ServeResult field equal")

    wl, crash_cells = _crash_cells(engine)
    window = CRASH_SLOTS // 2 + CRASH_SLOTS // 4
    tails = {}
    for name, cell in crash_cells:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = engine.serve_one(0, cell, workload=wl, device=dev)
        card_s = time.perf_counter() - t0
        assert sum(ops.launch_counts().values()) == 0, ops.launch_counts()
        _same_serve(engine, got, engine.serve_one(0, cell, workload=wl, device="cpu"),
                    f"crash {name}")
        times[f"crash_{name}_s"] = card_s
        assert got.dropped == 0
        assert got.offered == got.completed + int(got.final_occupancy.sum())
        tail = (wl.arrival_slot >= window) & (got.jct_by_rid >= 0)
        tails[name] = float(got.jct_by_rid[tail].mean())
        if name == "suspect_on":
            # The per-lane counters of this run on the card: no request went
            # to a suspect replica while another was healthy.
            static = dataclasses.replace(cell.static_part(), max_arrivals=max(
                8, -(-int(wl.n_arr.max()) // 8) * 8))
            out = engine._serve_core(*engine._core_args(
                [wl], [cell], static, -(-wl.total // 1024) * 1024, dev))
            assert int(out["suspect_routes"][0]) == 0 and int(out["masked_routes"][0]) > 0
            masked = int(out["masked_routes"][0])
        print(f"phase 4c crash / recovery {name}: mean JCT {got.mean_jct:.3f}, tail "
              f"(arrivals from slot {window}) {tails[name]:.3f}, messages {got.messages}; "
              f"card {card_s:.2f} s ({card_s / CRASH_SLOTS * 1e3:.3f} ms a slot), equal "
              f"to the CPU")
    print(f"phase 4c crash / recovery: {masked} requests routed while replica 3 was "
          f"suspect, none to it; tail JCT fault-free {tails['fault_free']:.3f}, suspect "
          f"masking on {tails['suspect_on']:.3f}, off {tails['suspect_off']:.3f}")

    # Width: CARE over the lossy wire at K = 1e5.
    wide = slotted_sim.SimConfig(**DEGRADED_WIDE)
    static, scn = wide.static_part(), wide.scenario()
    n, t = len(DEGRADED_WIDE_SEEDS), wide.slots
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    arrive, sizes, draws = slotted_sim.draw_workload(DEGRADED_WIDE_SEEDS, static, [scn], dev)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated(dev) - before
    held = sum(x.numel() * x.element_size() for x in (arrive, sizes, *draws.values()))
    assert sorted(draws) == ["gumbel", "net_drop_u", "net_jit_u"], sorted(draws)
    del arrive, sizes, draws
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res, card_s, cpu_s, _, _ = card_tests.grid_vs_cpu(dev, DEGRADED_WIDE_SEEDS, static, [scn])
    assert sum(ops.launch_counts().values()) == 0
    times["degraded_wide_s"] = card_s
    for r in res[0]:
        assert r.arrivals == r.departures + int(r.final_q.sum()) and r.arrivals > 0
    if sum(r.messages for r in res[0]) >= DROP_CHECK_MSGS:
        assert sum(r.net_drops for r in res[0]) > 0
    print(f"phase 4c CARE delay 4 drop 0.1 at K={wide.servers:.0e} cap {wide.buffer_cap}, "
          f"{n} seeds x {t} slots: card {card_s:.2f} s ({card_s / t * 1e3:.3f} ms a slot), "
          f"the CPU {cpu_s:.2f} s, every field equal; the draws (the ties' Gumbels and the "
          f"wire's drop and jitter uniforms, (N, T, K) float32 each) hold {held} B, their "
          f"peak {draw_peak} B; no stale ring under JSAQ (it routes on "
          f"the approximation; jsq / SQ(d) would hold N x {static.net_delay_cap} x K int32, "
          f"{n * static.net_delay_cap * wide.servers * 4} B); the call's peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 1e6:.1f} MB; messages "
          f"{[r.messages for r in res[0]]}, net drops {[r.net_drops for r in res[0]]}")
    times["degraded_cpu_s"] = cpu_total
    times["degraded_phase_s"] = time.perf_counter() - t_phase


def _identical_carry(a, b, label: str) -> None:
    """Two stream carries equal bit for bit, every field."""
    def leaves(x):
        if x is None:
            return []
        if torch.is_tensor(x):
            return [x]
        if dataclasses.is_dataclass(x):
            return [leaf for f in dataclasses.fields(x) for leaf in leaves(getattr(x, f.name))]
        return [leaf for v in x for leaf in leaves(v)]

    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), label
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{label}: carries differ"


def _stream_bound(work, static, t_end: int, lanes: int, completions: int):
    """serve_slots' stream-mode bound for one chunk of one run: n_arr, work
    and the scenario read once, the carry read and written once, against
    the lane chain's, the replica stage's and the fold's operations."""
    t_n, d, a_n = work.shape
    r, s_n, cap = static.replicas, static.decode_slots, static.queue_cap
    carry = 4 * d * (2 * r * cap + 2 * r * s_n + 5 * r + 8 + 119)
    n_bytes = 4 * (t_n * d + t_n * d * a_n + 6 * d + d * r) + 2 * carry
    stage = (SERVE_SLOT_OPS_PER_REPLICA + SERVE_SLOT_OPS_PER_DECODE_SLOT * s_n) * r * t_end * d
    ops_n = (_chain_ops(r, lanes, t_end * d) + stage
             + SERVE_FOLD_OPS_PER_COMPLETION * completions)
    return _bound_ms(n_bytes, ops_n)


def _serving_stream(dev, times: dict, card_tests) -> dict:
    """Phase 3b: serve_stream on the fused backend at serve/replicas1024.
    Returns the stream mode's numbers for the kernels line."""
    from repro_torch.core.care import metrics
    from repro_torch.kernels import jsaq_route as cuda_k
    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    cell = engine.ServeConfig(**{**SERVE_MAIN, "slots": STREAM_SLOTS}, **SERVE_WORK,
                              comm="et", x=4, deterministic_ties=True,
                              route_backend="fused")
    n, chunk, warm, seed = STREAM_SLOTS, STREAM_CHUNK, STREAM_WARMUP, STREAM_SEED
    params = engine.StreamParams.for_cell(cell)

    def run(slots, **kw):
        kw = {"chunk": chunk, "warmup": warm, "slots": slots, **kw}
        if "state" not in kw:
            kw["sampler"] = engine.StreamSampler(seed, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.serve_stream(seed, cell, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(2 * chunk)  # first-call allocations, pinned memory
    ops.reset_launch_counts()
    main, main_s = run(n)
    launches = ops.launch_counts()
    assert launches == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                        "serve_slots": -(-n // chunk), "moe_route": 0,
                        "flash_attention": 0, **NO_BWD}, launches
    assert main.dropped == 0 and main.count > 0
    assert main.offered == main.completed + int(main.final_occupancy.sum())

    # The fixed horizon on the whole trace: every counter, and the
    # accumulators recomputed on the host from its JCTs.
    t0 = time.perf_counter()
    full = engine.StreamSampler(seed, params).full(n)
    fixed = engine.serve_one(seed, cell, workload=full)
    fixed_s = time.perf_counter() - t0
    for name in ("completed", "messages", "dropped", "offered"):
        assert getattr(main, name) == getattr(fixed, name), name
    assert np.array_equal(main.final_occupancy, fixed.final_occupancy)
    done = fixed.jct_by_rid >= 0
    comp_t = full.arrival_slot[done] + fixed.jct_by_rid[done] - 1
    measured = fixed.jct_by_rid[done][comp_t >= warm]
    del full
    assert main.count == measured.size and main.max_jct == int(measured.max())
    assert np.array_equal(main.hist, np.bincount(metrics.jct_bucket(measured),
                                                 minlength=metrics.HIST_BUCKETS))
    mean_err = abs(main.mean_jct - measured.mean()) / measured.mean()
    std_err = abs(main.std_jct - measured.std()) / measured.std()
    assert mean_err <= 1e-4 and std_err <= 1e-3, (mean_err, std_err)

    # Rechunked, one chunk, resumed, and stepped: bit for bit.
    other = {}
    other[f"chunk {STREAM_RECHUNK}"] = run(n, chunk=STREAM_RECHUNK)[0]
    other["one chunk"] = run(n, chunk=n)[0]
    half = run(n // 2)[0]
    other[f"{n // 2} + {n // 2}"] = run(n - n // 2, state=half.state)[0]
    stepped, stepped_s = run(n, prefetch=False)
    other["stepped"] = stepped
    for label, res in other.items():
        _identical_carry(res.state.carry, main.state.carry, label)
        assert (res.mean_jct, res.std_jct, res.slots, res.offered) == (
            main.mean_jct, main.std_jct, main.slots, main.offered), label
    s = main.jct_summary()
    print(f"phase 3b serve_stream fused {cell.replicas} replicas x {cell.decode_slots}, "
          f"{n} slots in chunks of {chunk}, warmup {warm}, seed {seed}: "
          f"{main_s:.4f} s ({n / main_s:.1f} slots/s), stepped (prefetch off) "
          f"{stepped_s:.4f} s ({n / stepped_s:.1f} slots/s); launches {launches}; "
          f"offered {main.offered}, completed {main.completed}, dropped 0; measured "
          f"{main.count}, JCT mean {main.mean_jct:.4f} std {main.std_jct:.4f} p50 "
          f"{s['p50']:.1f} p99 {s['p99']:.1f} max {main.max_jct}; messages per "
          f"completion {main.msgs_per_completion:.5f}")
    print(f"phase 3b equal to serve_one on the whole trace ({fixed_s:.2f} s): every "
          f"counter, the final occupancy, count, histogram and maximum of its "
          f"{measured.size} JCTs past slot {warm}; mean within {mean_err:.2e}, std "
          f"within {std_err:.2e} (relative); bit for bit against "
          + ", ".join(other))

    # The kernel on chunk 0's inputs: stream mode (every slot folds) against
    # the fixed horizon on the same slots, in turns, and the host's slab.
    sampler = engine.StreamSampler(seed, params)
    t0 = time.perf_counter()
    for k in range(n // chunk):
        wl = sampler.slab(k * chunk, (k + 1) * chunk)
        engine._pad_workload(wl, chunk, main.state.a_pad, 0, with_rid=False)
    slab_ms = (time.perf_counter() - t0) * 1e3 / (n // chunk)
    wl = engine.StreamSampler(seed, params).slab(0, chunk)
    a_pad = main.state.a_pad
    padded = engine._pad_workload(wl, chunk, a_pad, 0)
    n_arr, work, tie_u, rid, _ = (torch.from_numpy(p[:, None]).to(dev) for p in padded)
    scn = engine.stack_scenarios([dataclasses.replace(
        cell.scenario(), horizon=torch.tensor(n, dtype=torch.int32),
        warmup=torch.tensor(0, dtype=torch.int32))]).to(dev)
    static = dataclasses.replace(cell.static_part(), stream=True, slots=chunk,
                                 max_arrivals=a_pad)
    kw = dict(cap=static.queue_cap, comm=static.comm, decode_slots=static.decode_slots,
              use_rates=False, trace_occupancy=False, t_end=chunk)
    slot_args = (n_arr, work, rid, scn.x, scn.rt_period, scn.msr_drain, scn.decode_rates,
                 scn.horizon)
    n_cap = -(-wl.total // 1024) * 1024

    def fixed_call():
        return cuda_k.serve_slots_cuda(*slot_args, **kw, n_cap=n_cap)

    def stream_calls(reps):
        views = [engine._slots_view(engine._engine_init(static, 0, 1, dev))
                 for _ in range(reps + 1)]
        it = iter(views)
        return views, lambda: cuda_k.serve_slots_cuda(*slot_args, **kw, n_cap=0,
                                                      carry=next(it), t0=0,
                                                      warmup=scn.warmup)

    reps = STREAM_TIME_REPS
    fixed_ms, stream_ms = [], []
    for mode in ("fixed", "stream", "stream", "fixed"):
        if mode == "fixed":
            fixed_ms.append(_time_ms(fixed_call, reps))
        else:
            views, fn = stream_calls(reps)
            stream_ms.append(_time_ms(fn, reps))
    fixed_out = fixed_call()
    view = views[-1]
    for name in ("q_len", "q_head", "approx", "msgs", "total_comp", "dropped"):
        assert torch.equal(view[name], fixed_out[name]), f"stream vs fixed {name}"
    completions = int(view["total_comp"].sum())
    assert int(view["count"].sum()) == completions  # warmup 0: every one measured
    lanes = _routed_lanes(n_arr, scn.horizon, chunk, a_pad)
    bound = _stream_bound(work, static, chunk, sum(lanes), completions)
    # The plain version (the dense stream on the card) on the chunk's first
    # STREAM_PLAIN_SLOTS slots, from the same empty carry.
    cut = STREAM_PLAIN_SLOTS
    views, fn = stream_calls(0)
    sl = slice(0, cut)
    got = cuda_k.serve_slots_cuda(n_arr[sl].contiguous(), work[sl].contiguous(), None,
                                  *slot_args[3:], **{**kw, "t_end": cut}, n_cap=0,
                                  carry=views[0], t0=0, warmup=scn.warmup)
    dense = dataclasses.replace(static, route_backend="dense")
    live = np.minimum(padded[0][:cut], a_pad)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = engine._serve_core(n_arr[sl], work[sl], tie_u[sl], rid[sl][..., :0],
                              torch.zeros((cut, 1, a_pad, 0), device=dev), scn, dense, 0,
                              cut, live, None, engine._engine_init(dense, 0, 1, dev), 0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_carry = engine._from_slots_view(want, got)
    card_tests.stream_carry_equal(got_carry, want, "phase 3b plain")
    stream_err = max(float((got[k].double() - getattr(want.comp_slot, k).double()).abs().max())
                     for k in ("mean", "m2"))
    fold_cost = stream_ms[0] / fixed_ms[0] - 1
    print(f"phase 3b serve_slots stream mode on chunk 0 (D=1, R={static.replicas}, "
          f"S={static.decode_slots}, A={a_pad}, {chunk} slots, every slot folding, "
          f"{completions} completions): kernel {stream_ms[0]:.4f}, {stream_ms[1]:.4f} ms "
          f"({stream_ms[0] / chunk * 1e3:.4f} us a slot) against the fixed horizon on "
          f"the same slots {fixed_ms[0]:.4f}, {fixed_ms[1]:.4f} ms "
          f"({fixed_ms[0] / chunk * 1e3:.4f} us a slot; the fold and carry cost "
          f"{fold_cost * 100:.2f}%); bound {bound[0]:.6f} ms ({bound[1]}); the plain "
          f"version (the dense stream on the card) over {cut} slots {plain_ms:.1f} ms "
          f"({plain_ms / cut:.2f} ms a slot), the carry equal (mean and m2 within "
          f"{stream_err:.3g}); the host's slab sampling and padding {slab_ms:.2f} ms a "
          f"chunk of {chunk}")

    # The dense stream against the fused one, a degraded cell against the
    # CPU, and stream mode on SLOTS_CASES against the dense stream.
    t0 = time.perf_counter()
    small = engine.ServeConfig(**SERVE_DENSE_VS_FUSED, **SERVE_WORK, comm="et", x=4,
                               deterministic_ties=True, route_backend="fused")
    ops.reset_launch_counts()
    rf = engine.serve_stream(0, small, chunk=STREAM_DENSE_CHUNK, warmup=100)
    assert ops.launch_counts()["serve_slots"] == -(-small.slots // STREAM_DENSE_CHUNK)
    rd = engine.serve_stream(0, dataclasses.replace(small, route_backend="dense"),
                             chunk=STREAM_DENSE_CHUNK, warmup=100)
    card_tests.stream_carry_equal(rf.state.carry, rd.state.carry, "dense vs fused")
    degraded = engine.ServeConfig(**card_tests.STREAM_DEGRADED)
    got = engine.serve_stream(3, degraded, chunk=64)
    want = engine.serve_stream(3, degraded, chunk=64, device="cpu")
    card_tests.stream_carry_equal(got.state.carry, want.state.carry, "degraded")
    assert got.completed == want.completed > 0
    cases = []
    for name, (kw_case, horizons) in card_tests.SLOTS_CASES.items():
        case = engine.ServeConfig(**{**card_tests.SLOTS_BASE, **kw_case})
        carry, case_launches, _ = card_tests.stream_vs_dense(dev, case, horizons)
        cases.append(f"{name} ({case_launches} launches, measured "
                     f"{carry.comp_slot.count.tolist()})")
    checks_s = time.perf_counter() - t0
    print(f"phase 3b dense stream == fused at {SERVE_DENSE_VS_FUSED}, chunk "
          f"{STREAM_DENSE_CHUNK} (every carry field; mean and m2 within "
          f"{card_tests.STREAM_MEAN_RTOL:g} / {card_tests.STREAM_M2_RTOL:g}); the degraded "
          f"cell (crash, ET+RT, suspect masking) card == CPU; stream-mode serve_slots "
          f"against the dense stream on the CPU, cut at {card_tests.STREAM_CUTS}: "
          f"{'; '.join(cases)} ({checks_s:.1f} s)")
    times["stream_main_s"] = main_s
    times["stream_stepped_s"] = stepped_s
    times["stream_phase_s"] = time.perf_counter() - t_phase
    return {"stream_launches": launches["serve_slots"], "stream_ms": stream_ms[0],
            "stream_fixed_ms": fixed_ms[0], "stream_plain_ms": plain_ms,
            "stream_plain_slots": cut, "stream_bound_ms": bound[0],
            "stream_bound_by": bound[1], "stream_max_abs_err": stream_err,
            "stream_slots_per_s": n / main_s}


def _dispatch_profile(engine, cell, card_tests, dev, wall_s: float) -> None:
    """Where the per-request dispatcher's time goes: one profiled
    ``run_serving_sim`` call; the device busy share against the unprofiled
    wall of the same call."""
    from torch.profiler import ProfilerActivity, profile

    args = card_tests._sim_args(cell, 0)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.run_serving_sim(cell.engine_config(), device=dev, **args)
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in device)
        if device_us:
            break
    else:
        print("phase 3c dispatcher profile: the profiler saw no device time in two calls; "
              "device busy share not measured")
        return
    launches = sum(e.count for e in device)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    host_us = sum(e.self_cpu_time_total for e in host)
    print(f"phase 3c dispatcher profile ({cell.slots} slots, ET-4): device busy "
          f"{device_us / 1e3:.3f} ms, {device_us / 1e6 / wall_s:.4f} of the unprofiled "
          f"wall {wall_s:.3f} s; {launches} device operations ({launches / cell.slots:.1f} "
          f"a slot); top host ops by self time (profiled): "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / host_us:.3f}" for e in host[:8]))


def _dispatcher_phase(dev, times: dict, card_tests) -> None:
    """Phase 3c: the per-request dispatcher, dispatch_sim and the two
    examples on the card (no kernel but the examples' own; every count
    printed)."""
    from repro_torch.core import dispatch_sim
    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    # (a) examples/serve_care's cell under each policy and control plane,
    # the card against the CPU and against the dense serve_one.
    for name, kw in card_tests.DISPATCH_CELLS.items():
        cell = card_tests.dispatch_cell(name, DISPATCH_SLOTS)
        ops.reset_launch_counts()
        got, card_s, cpu_s = card_tests.dispatcher_card_vs_cpu(dev, cell)
        res, serve_s = card_tests.dispatcher_vs_serve_one(dev, cell, got)
        launches = ops.launch_counts()
        assert sum(launches.values()) == 0, launches
        assert got["offered"] == got["completed"] + int(got["final_occupancy"].sum())
        if kw.get("net_drop"):
            assert got["net_drops"] > 0 and got["retrans"] > 0
        if name in ("jiq", "hsq"):
            assert got["token_misses"] >= 0 and got["token_sum"] >= 0
        times[f"dispatch_{name}_s"] = card_s
        print(f"phase 3c dispatcher {name} ({cell.replicas} x {cell.decode_slots}, "
              f"{cell.slots} slots, {got['offered']} requests): equal to the CPU in every "
              f"field and to serve_one (dense, the card) in {', '.join(card_tests.DISPATCH_VS_SERVE)}; "
              f"card {card_s / cell.slots * 1e3:.3f} ms a slot ({card_s * 1e6 / max(got['offered'], 1):.1f} "
              f"us a request), CPU {cpu_s / cell.slots * 1e3:.3f} ms a slot, serve_one "
              f"{serve_s / cell.slots * 1e3:.3f} ms a slot; messages {got['messages']}, mean "
              f"JCT {got['mean_jct']:.3f}, net_drops {got['net_drops']}, retrans "
              f"{got['retrans']}, token_misses {got['token_misses']}, token_sum "
              f"{got['token_sum']}; launches {launches}")
    et4 = card_tests.dispatch_cell("et4", DISPATCH_SLOTS)
    _dispatch_profile(engine, et4, card_tests, dev, times["dispatch_et4_s"])

    # (b) serve/replicas1024's width against the fused serve_one.
    wide = engine.ServeConfig(**{**SERVE_MAIN, "slots": DISPATCH_WIDE_SLOTS}, **SERVE_WORK,
                              comm="et", x=4, deterministic_ties=True, route_backend="fused")
    args = card_tests._sim_args(wide, 0)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = engine.run_serving_sim(wide.engine_config(), device=dev, **args)
    wide_s = time.perf_counter() - t0
    assert sum(ops.launch_counts().values()) == 0
    t0 = time.perf_counter()
    res = engine.serve_one(0, wide, workload=args["workload"], device=dev)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert launches["serve_slots"] == 1 and sum(launches.values()) == 1, launches
    assert res.dropped == 0
    for name in ("jct_by_rid", "messages", "final_occupancy"):
        assert np.array_equal(np.asarray(got[name]), np.asarray(getattr(res, name))), name
    n_req = got["offered"]
    times["dispatch_wide_s"] = wide_s
    print(f"phase 3c dispatcher at {wide.replicas} x {wide.decode_slots}, cap "
          f"{wide.queue_cap}, {wide.slots} slots ({n_req} routed requests, "
          f"{n_req / wide.slots:.1f} a slot): jct_by_rid, messages and final occupancy "
          f"equal to the fused serve_one (one serve_slots launch, {fused_s:.3f} s); "
          f"dispatcher {wide_s:.3f} s, {wide_s / wide.slots * 1e3:.3f} ms a slot, "
          f"{wide_s * 1e6 / n_req:.2f} us a routed request; messages {got['messages']}, "
          f"completed {got['completed']}")

    # (c) dispatch_sim at bench_moe_balance's section B.
    seeds = list(range(MOE_DISPATCH_SEEDS))
    regimes = [
        ("no_bias", dict(enabled=False, comm="off")),
        ("off", dict(comm="off")),
        ("exact", dict(comm="exact", x=1)),
        ("dt8", dict(comm="dt", x=8)),
        ("et4", dict(comm="et", x=4)),
        ("et8", dict(comm="et", x=8)),
    ]
    agg = {}
    for name, kw in regimes:
        cfg = dispatch_sim.DispatchSimConfig(steps=MOE_DISPATCH_STEPS, **kw)
        ops.reset_launch_counts()
        card, card_s, cpu_s = card_tests.dispatch_sim_card_vs_cpu(dev, cfg, seeds)
        assert sum(ops.launch_counts().values()) == 0
        # Each seed of the batch equals simulate: every seed under et4, the
        # first seed under the others.
        for seed in seeds if name == "et4" else seeds[:1]:
            one = dispatch_sim.simulate(seed, cfg, device=dev)
            assert np.array_equal(one.gap, card[seed].gap), (name, seed)
            assert np.array_equal(one.backlog, card[seed].backlog), (name, seed)
            assert (one.messages, one.max_err) == (card[seed].messages, card[seed].max_err)
        if name == "exact":
            assert all(r.messages == cfg.dispatchers * cfg.steps for r in card)
        if name in ("off", "no_bias"):
            assert all(r.messages == 0 for r in card)
        for r in card:
            assert np.isfinite(r.backlog).all() and np.isfinite(r.gap).all()
        agg[name] = {
            "tail_gap": float(np.mean([r.tail_gap for r in card])),
            "transient_gap": float(np.mean([r.transient_gap for r in card])),
            "tail_backlog": float(np.mean([r.tail_backlog for r in card])),
            "rel_comm": float(np.mean([r.rel_comm for r in card])),
            "max_err": float(np.max([r.max_err for r in card])),
        }
        times[f"moe_dispatch_{name}_s"] = card_s
        print(f"phase 3c dispatch_sim {name} (E {cfg.experts}, D {cfg.dispatchers}, T "
              f"{cfg.tokens_per_step}, k {cfg.top_k}, {cfg.steps} steps, {len(seeds)} seeds "
              f"in one dispatch_batch): card == CPU on the card's draws in every field; card "
              f"{card_s:.3f} s ({card_s / cfg.steps * 1e3:.3f} ms a step), CPU {cpu_s:.3f} s "
              f"({cpu_s / cfg.steps * 1e3:.3f} ms a step); " + json.dumps(agg[name]))
    ex, et, off = agg["exact"], agg["et4"], agg["off"]
    print("phase 3c dispatch_sim headline (printed, not asserted; the port's draws are "
          "not the reference's): " + json.dumps({
              "et4_gap_vs_exact": et["tail_gap"] / max(ex["tail_gap"], 1e-9),
              "et4_rel_comm": et["rel_comm"], "comm_saving": 1.0 - et["rel_comm"],
              "et_matches_exact": bool(et["tail_gap"] <= 1.1 * ex["tail_gap"]),
              "off_transient_vs_et": off["transient_gap"] / max(et["transient_gap"], 1e-9),
          }))

    # (d) both examples as subprocesses, at tests/test_examples.py's sizes.
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for name, argv, closing in (
        ("quickstart", ["--slots", "2000"], "Next: python -m repro_torch.examples.serve_care"),
        ("serve_care", ["--slots", "1000"], "Reading: the ET dispatcher matches"),
    ):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
                              capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S,
                              env=env, cwd=ROOT)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, f"{name}: {proc.stderr[-3000:]}"
        assert closing in proc.stdout, proc.stdout[-2000:]
        times[f"example_{name}_s"] = wall
        lines = proc.stdout.strip().splitlines()
        if name == "serve_care":
            got = [ln for ln in lines if ln.startswith("[decode] flash_attention launches")]
            want = "[decode] flash_attention launches: 30 in the prefill, 0 in 11 decode steps"
            assert got == [want], got
            shown = [ln for ln in lines if ln.startswith(("[decode]", "[golden]", "9 cells"))]
        else:
            shown = [ln for ln in lines if "simulate_grid calls" in ln]
        print(f"phase 3c example {name} {' '.join(argv)}: exit 0 in {wall:.1f} s; "
              + " | ".join(shown))
    times["dispatcher_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 3c: {times['dispatcher_phase_s']:.1f} s")


def dispatcher_phase_only() -> None:
    """Phase 1's build and phase 3c alone, for a short call on the card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build_all()
    times: dict[str, float] = {}
    _dispatcher_phase(torch.device("cuda", 0), times, _card_tests())
    print("times (s): " + json.dumps(times) + f" on {_card()}")


def family_phase_only() -> None:
    """Phase 1's build and phase 8b alone, for a short call on the card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    times: dict[str, float] = {}
    t0 = time.perf_counter()
    family = _family_serving(dev, times)
    times["family_phase_s"] = time.perf_counter() - t0
    print("times (s): " + json.dumps(times) + f" on {_card()}")
    print(json.dumps(family))


def _scaled_err(got, want) -> float:
    """Largest ``|got - want|`` over the largest ``|want|``."""
    w = want.detach().float()
    return float((got.detach().float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def _parallel_phase(dev, times: dict) -> dict:
    """Phase 10: the port's parallel context on one card.  Returns the
    launches of the phase's path, by kernel."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_route as moe_k
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated(dev) < 1e9, (
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated before phase 10")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    assert mesh_lib.init_ranks(dev), "a process group was already running"
    try:
        assert dist.get_backend() == backend, dist.get_backend()
        dmesh = mesh_lib.make_debug_mesh((1, 1), dev)
        cfg = _moe_config()
        ctx = mesh_lib.make_context(dmesh, cfg.n_routed_experts)
        one = torch.ones(1, device=dev)
        dist.all_reduce(one, group=ctx.group(ctx.grid_axes))
        assert float(one) == 1.0
        times["parallel_init_s"] = time.perf_counter() - t_phase
        print(f"phase 10 {backend} group of world size {dist.get_world_size()}, DeviceMesh "
              f"{dmesh.device_type} (1, 1) ('data', 'model'); {cfg.name} context: ep_axes "
              f"{ctx.ep_axes}, fsdp {ctx.fsdp_axis}, ep/dp/tp {ctx.ep_size}/{ctx.dp_size}/"
              f"{ctx.tp_size}; an all_reduce over the grid group gives 1.0; "
              f"{times['parallel_init_s']:.2f} s")

        # (a) phase 7's model under the context and without one: prefill,
        # decode, and a forward and backward; after a warm-up, the
        # context's runs first, with the launch counts set to 0 just
        # before and read just after.
        params = model.init_params(torch.Generator(device=dev).manual_seed(MOE_SEED), cfg, dev)
        n_moe = model.num_scanned_layers(cfg)
        e, k = cfg.n_routed_experts, cfg.moe_top_k
        rng = np.random.default_rng(MOE_SEED)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)).astype(np.int64)).to(dev)
        bias = torch.from_numpy(rng.standard_normal((n_moe, e)).astype(np.float32)).to(dev)
        tb = tokens[:PARALLEL_TRAIN[0], :PARALLEL_TRAIN[1]]
        batch = {"tokens": tb, "labels": torch.roll(tb, -1, 1)}
        calls = []
        route = ops.moe_route

        def spy(logits, b, top_k, *, gate_fn):
            out = route(logits, b, top_k, gate_fn=gate_fn)
            calls.append((logits, b, out))
            return out

        def run(c):
            b = bias if c is None else bias[:, None, None, :]
            start = len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, cache = model.prefill(params, {"tokens": tokens}, cfg, c,
                                              cache_len=MOE_PROMPT + PARALLEL_NEW, bias=b)
                out = [logits]
                for i in range(PARALLEL_NEW):
                    logits, cache = model.decode_step(params, out[-1].argmax(-1), cache,
                                                      MOE_PROMPT + i, cfg, c, bias=b)
                    out.append(logits)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            del cache
            params.requires_grad_(True)
            t0 = time.perf_counter()
            loss, aux = model.train_loss(params, batch, cfg, c, b)
            grads = torch.autograd.grad(loss, list(params.parameters()))
            torch.cuda.synchronize()
            params.requires_grad_(False)
            return dict(logits=torch.stack(out), routes=calls[start:], loss=loss.detach(),
                        counts=aux["counts"], grads=grads, serve_s=serve_s,
                        train_s=time.perf_counter() - t0)

        ops.moe_route = spy
        try:
            run(None)  # a warm-up, dropped: the timed runs below start warm
            calls.clear()
            ops.reset_launch_counts()
            got = run(ctx)
            launches = ops.launch_counts()
            want = run(None)
        finally:
            ops.moe_route = route
        assert launches == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                            "serve_slots": 0, "moe_route": n_moe * (2 + PARALLEL_NEW),
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "moe_route_bwd": n_moe}, launches
        assert len(got["routes"]) == len(want["routes"]) == n_moe * (2 + PARALLEL_NEW)
        for (_, _, a), (_, _, w) in zip(got["routes"], want["routes"]):
            assert torch.equal(a[0], w[0]) and torch.equal(a[2], w[2]), "routes differ"
        assert got["counts"].shape == (n_moe, 1, 1, e)
        assert torch.equal(got["counts"][:, 0, 0], want["counts"]), "train counts differ"
        errs = {"logits": _scaled_err(got["logits"], want["logits"]),
                "loss": _scaled_err(got["loss"], want["loss"]),
                "grads": max(_scaled_err(a, w) for a, w in zip(got["grads"], want["grads"]))}
        assert max(errs.values()) <= PARALLEL_TOL, errs
        assert bool(torch.isfinite(got["logits"]).all()) and bool(torch.isfinite(got["loss"]))
        # The router kernel inside the context's path against its plain
        # version on that path's own inputs (a prefill and a decode call).
        kerr = max(_moe_parity(moe_k, ref, lg, b, k, cfg.gate_fn, got=o)
                   for lg, b, o in (got["routes"][0], got["routes"][n_moe]))
        # The single runs above follow their order (the context's first after
        # the warm-up); the walls compared are warm and taken in turns.
        def serve_turn(c, b):
            with torch.no_grad():
                logits, cache = model.prefill(params, {"tokens": tokens}, cfg, c,
                                              cache_len=MOE_PROMPT + PARALLEL_NEW, bias=b)
                for i in range(PARALLEL_NEW):
                    logits, cache = model.decode_step(params, logits.argmax(-1), cache,
                                                      MOE_PROMPT + i, cfg, c, bias=b)

        def train_turn(c, b):
            params.requires_grad_(True)
            torch.autograd.grad(model.train_loss(params, batch, cfg, c, b)[0],
                                list(params.parameters()))
            params.requires_grad_(False)

        turns = {(part, name): [] for part in ("serve", "train") for name in ("ctx", "none")}
        for _ in range(PARALLEL_WALL_ROUNDS):
            for name, c in (("none", None), ("ctx", ctx), ("ctx", ctx), ("none", None)):
                for part, fn in (("serve", serve_turn), ("train", train_turn)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(c, bias if c is None else bias[:, None, None, :])
                    torch.cuda.synchronize()
                    turns[part, name].append(time.perf_counter() - t0)
        turn_ms = {k: float(np.median(v)) * 1e3 for k, v in turns.items()}
        times["parallel_serve_s"], times["none_serve_s"] = got["serve_s"], want["serve_s"]
        times["parallel_fwd_bwd_s"], times["none_fwd_bwd_s"] = got["train_s"], want["train_s"]
        print(f"phase 10 {cfg.name} x {MOE_LAYERS} layers, {cfg.param_dtype}, under the (1, 1) "
              f"context against ctx=None: prefill {MOE_BATCH} x {MOE_PROMPT} + {PARALLEL_NEW} "
              f"decode steps {got['serve_s']:.4f} s (ctx=None {want['serve_s']:.4f} s, ratio "
              f"{got['serve_s'] / want['serve_s']:.3f}), forward + backward "
              f"{PARALLEL_TRAIN[0]} x {PARALLEL_TRAIN[1]} {got['train_s']:.4f} s "
              f"({want['train_s']:.4f} s, ratio {got['train_s'] / want['train_s']:.3f}); warm, "
              f"in turns ({PARALLEL_WALL_ROUNDS} x none, ctx, ctx, none), medians: prefill + "
              f"decode {turn_ms['serve', 'ctx']:.2f} ms against {turn_ms['serve', 'none']:.2f} "
              f"ms, ratio {turn_ms['serve', 'ctx'] / turn_ms['serve', 'none']:.3f}, forward + "
              f"backward {turn_ms['train', 'ctx']:.2f} ms against {turn_ms['train', 'none']:.2f} "
              f"ms, ratio {turn_ms['train', 'ctx'] / turn_ms['train', 'none']:.3f}; a dp group "
              f"of one issues no collective; "
              f"every routed id and count "
              f"equal, train counts (L, 1, 1, E) equal; largest error / largest magnitude: "
              f"logits {errs['logits']:.3g}, loss {errs['loss']:.3g}, gradients "
              f"{errs['grads']:.3g} (at most {PARALLEL_TOL}); launches {launches}; moe_route "
              f"on the path's inputs against its plain version: max abs err {kerr:.3g}; "
              f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
        del params, got, want, calls, tokens, batch
        torch.cuda.empty_cache()

        # (b) one train step at the reduced config (AdamW's ZeRO-1 path over
        # the mesh), under the context and without one.
        rcfg = get_config(MOE_ARCH).reduced()
        rctx = mesh_lib.make_context(dmesh, rcfg.n_routed_experts)
        opt = adamw.OptimConfig(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-4)
        tok = torch.from_numpy(rng.integers(0, rcfg.vocab_size, (4, 32)).astype(np.int64))
        rbatch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        res = {}
        for name, c in (("ctx", rctx), ("none", None)):
            state = train_loop.init_state(torch.Generator(device=dev).manual_seed(0), rcfg, c,
                                          device=dev)
            state, metrics = train_loop.make_train_step(rcfg, opt, c, sync=True)(state, rbatch)
            res[name] = (metrics, dict(state.params.named_parameters()),
                         adamw.gather_state(state.opt, state.params, c), state.balancer)
        (gm, gp, go, gb), (wm, wp, wo, wb) = res["ctx"], res["none"]
        assert torch.equal(gb.true_counts[:, 0, 0], wb.true_counts)
        step_err = max([_scaled_err(gm[n], wm[n]) for n in ("loss", "grad_norm")]
                       + [_scaled_err(gp[n], wp[n]) for n in wp]
                       + [_scaled_err(go.m[n], wo.m[n]) for n in wp]
                       + [_scaled_err(go.v[n], wo.v[n]) for n in wp])
        assert step_err <= PARALLEL_TOL, step_err
        print(f"phase 10 train step, {rcfg.name} float32, balancer sync on, under the (1, 1) "
              f"context (moments as ZeRO-1 blocks of the JAX leaves) against ctx=None: counts "
              f"equal, loss, grad_norm, parameters and moments within {step_err:.3g} of each "
              f"leaf's largest magnitude")
        del res, state

        # (c) the launcher with --mesh 1,1 against the same run without it.
        t0 = time.perf_counter()
        with_mesh = launch_train.main(PARALLEL_LAUNCH_ARGS + ["--mesh", "1,1"])["losses"]
        plain = launch_train.main(PARALLEL_LAUNCH_ARGS)["losses"]
        np.testing.assert_allclose(with_mesh, plain, rtol=PARALLEL_TOL)
        print(f"phase 10 launch.train {' '.join(PARALLEL_LAUNCH_ARGS)} --mesh 1,1: losses "
              f"{[round(x, 6) for x in with_mesh]} equal the run without a mesh within "
              f"{PARALLEL_TOL}; {time.perf_counter() - t0:.1f} s")

        # (d) a dense decoder under the (1, 1) context (the unsplit path)
        # against ctx=None, and the row-split decode's softmax.
        dense = _parallel_dense(dev, dmesh)
    finally:
        dist.destroy_process_group()
    # (e) the MoE family's and (f)-(h) the other families' split arithmetic
    # at published width, with the ranks simulated in this process through
    # the functions they call.
    _mla_row_blocks(dev)
    _expert_blocks(dev)
    _family_blocks(dev, times)
    times["parallel_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 10: {times['parallel_phase_s']:.1f} s")
    return {"moe": launches, "dense": dense}


def _parallel_dense(dev, dmesh) -> dict:
    """Phase 10 (d): a dense decoder at published width and depth (bf16,
    seed 0) under the (1, 1) context against ``ctx=None``: a prefill and
    greedy decode steps, then ``train_loss`` with every gradient.  One TP
    rank takes the unsplit path (no layout, no collective).  Each run under
    the op recorder with the launch counts set to 0 just before it; the
    context's logits, loss and gradients equal ``ctx=None``'s bit for bit,
    its launches equal, and it issues no collective.  Then
    :func:`_seq_split_softmax`.  Returns the context's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import op_analysis
    from repro_torch.models import model, partitioning

    cfg = get_config(PARALLEL_DENSE_ARCH)
    ctx = mesh_lib.make_context(dmesh, 0)
    assert partitioning.tp_layout(cfg, ctx) is None and not ctx.tp_split
    params = model.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev, ctx)
    b, s = PARALLEL_DENSE_PROMPT
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)).to(dev)
    tb = tokens[:, :PARALLEL_DENSE_TRAIN]
    batch = {"tokens": tb, "labels": torch.roll(tb, -1, 1)}

    def run(c):
        ops.reset_launch_counts()
        with op_analysis.OpRecorder() as rec:
            with torch.no_grad():
                logits, cache = model.prefill(params, {"tokens": tokens}, cfg, c,
                                              cache_len=s + PARALLEL_NEW)
                out = [logits]
                for i in range(PARALLEL_NEW):
                    logits, cache = model.decode_step(params, out[-1].argmax(-1), cache, s + i,
                                                      cfg, c)
                    out.append(logits)
            params.requires_grad_(True)
            loss, _ = model.train_loss(params, batch, cfg, c)
            grads = torch.autograd.grad(loss, list(params.parameters()))
            params.requires_grad_(False)
        torch.cuda.synchronize()
        return dict(logits=torch.stack(out), loss=loss.detach(), grads=grads,
                    launches=ops.launch_counts(), collectives=rec.n_coll)

    t0 = time.perf_counter()
    want = run(None)
    got = run(ctx)
    errs = {"logits": _scaled_err(got["logits"], want["logits"]),
            "loss": _scaled_err(got["loss"], want["loss"]),
            "grads": max(_scaled_err(a, w) for a, w in zip(got["grads"], want["grads"]))}
    assert max(errs.values()) == 0.0, errs
    assert got["launches"] == want["launches"], (got["launches"], want["launches"])
    assert got["launches"]["flash_attention"] == 2 * cfg.num_layers, got["launches"]
    assert got["launches"]["flash_attention_bwd"] == cfg.num_layers, got["launches"]
    assert got["collectives"] == 0 == want["collectives"], got["collectives"]
    assert bool(torch.isfinite(got["logits"]).all()) and bool(torch.isfinite(got["loss"]))
    print(f"phase 10 {cfg.name} x {cfg.num_layers} layers, {cfg.param_dtype}, under the (1, 1) "
          f"context (one TP rank: no layout, the unsplit path) against ctx=None: "
          f"prefill {b} x {s} + {PARALLEL_NEW} decode steps and train_loss at {b} x "
          f"{PARALLEL_DENSE_TRAIN} with every gradient; largest error / largest magnitude: "
          f"logits {errs['logits']:.3g}, loss {errs['loss']:.3g}, gradients "
          f"{errs['grads']:.3g} (bit for bit); launches {got['launches']} equal; collectives "
          f"issued {got['collectives']}; {time.perf_counter() - t0:.1f} s")
    launches = got["launches"]
    del params, got, want
    torch.cuda.empty_cache()
    _seq_split_softmax(dev)
    return launches


SEQ_SPLIT_ARCH = "gemma2-9b"
SEQ_SPLIT_SHAPE = (2, 8192, 6000)  # batch, cache rows, decode position
SEQ_SPLIT_TOL = 1e-2  # of the largest magnitude: the plain path rounds its probabilities to bf16


def _seq_split_softmax(dev) -> None:
    """Decode's softmax over a row-split cache, combined by log-sum-exp
    (``attention._sdpa_seq_split``, here over a TP group of one: its max
    and sums issue nothing), against the plain softmax (``_sdpa``) at
    Gemma2-9B's global layer (16 query heads, 8 KV heads of 256, soft-cap
    50), bf16, one-token queries against a cache of SEQ_SPLIT_SHAPE's rows
    filled up to its position, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = get_config(SEQ_SPLIT_ARCH)
    b, rows, pos = SEQ_SPLIT_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    dh = cfg.resolved_head_dim
    q = torch.randn((b, 1, cfg.num_heads, dh), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, rows, cfg.num_kv_heads, dh), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    kpos = torch.arange(rows, device=dev)
    mask = (kpos <= pos)[None, None, None, None, :]
    got = attention._sdpa_seq_split(q, k, v, mask, cfg, None)
    want = attention._sdpa(q, k, v, mask, cfg)
    torch.cuda.synchronize()
    err = _scaled_err(got, want)
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), got.shape
    assert err <= SEQ_SPLIT_TOL, err
    print(f"phase 10 decode's row-split softmax (log-sum-exp combine, float32) against the plain "
          f"softmax at {cfg.name}'s global layer, batch {b}, {rows} cache rows, position {pos}, "
          f"bf16, on the card: largest error / largest magnitude {err:.3g} (tolerance "
          f"{SEQ_SPLIT_TOL})")


MLA_BLOCKS = (2, 8192, 4, 6000)  # batch, cache rows, row blocks, decode position
MLA_BLOCKS_TOL = 1e-2  # of the largest magnitude: the plain path rounds its probabilities to bf16
EXPERT_BLOCKS = (128, 16)  # decode tokens, expert blocks (160 / 16 = 10 experts a rank)
EXPERT_BLOCKS_TOL = 1e-2  # of the largest magnitude: bf16 partial sums added in another order


def _mla_row_blocks(dev) -> None:
    """DeepSeek-V2's absorbed MLA decode (published width: 128 heads, R
    512, bf16) on a cache of MLA_BLOCKS' rows cut into row blocks, as the
    TP ranks of a row-split cache hold it: each block's scores
    (``mla.absorbed_scores``) against the largest maximum of any block,
    its partial softmax (``mla.partial_softmax``), the sums added and
    divided in float32 (the ranks' log-sum-exp combine), then ``W_uv`` and
    ``wo`` (``mla.decode_out``); against the plain ``mla.mla_decode`` on
    the whole cache.  The position leaves the last block masked."""
    from repro_torch.models import mla

    cfg = _moe_config()
    b, rows, nblk, pos = MLA_BLOCKS
    g = torch.Generator(device=dev).manual_seed(0)
    p = mla.MLA(cfg, device=dev, generator=g)
    x = torch.randn((b, 1, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    cache = {"ckv": torch.randn((b, rows, cfg.kv_lora_rank), generator=g, device=dev),
             "k_rope": torch.randn((b, rows, cfg.qk_rope_head_dim), generator=g, device=dev)}
    cache = {k: v.to(torch.bfloat16) for k, v in cache.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        want, _ = mla.mla_decode(p, x, {k: v.clone() for k, v in cache.items()}, pos, cfg)
        q_eff, q_rope, ckv_t, kr_t = mla.decode_queries(p, x, pos, cfg)
        ckv, kr = cache["ckv"], cache["k_rope"]
        ckv[:, pos], kr[:, pos] = ckv_t[:, 0], kr_t[:, 0]
        blk = rows // nblk
        cuts = [slice(i * blk, (i + 1) * blk) for i in range(nblk)]
        kpos = torch.arange(rows, dtype=torch.int32, device=dev)
        scores = [mla.absorbed_scores(q_eff, q_rope, ckv[:, c], kr[:, c], kpos[c], pos, cfg)
                  for c in cuts]
        m = torch.stack([sc.amax(dim=-1, keepdim=True) for sc in scores]).amax(dim=0)
        parts = [mla.partial_softmax(sc, ckv[:, c], m) for sc, c in zip(scores, cuts)]
        den = sum(d for d, _ in parts)
        num = sum(n for _, n in parts)
        got = mla.decode_out(p, (num / den.permute(0, 2, 1)[..., None]).to(x.dtype), cfg)
    torch.cuda.synchronize()
    err = _scaled_err(got, want)
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), got.shape
    assert err <= MLA_BLOCKS_TOL, err
    print(f"phase 10 {cfg.name}'s absorbed MLA decode ({cfg.num_heads} heads, R "
          f"{cfg.kv_lora_rank}, bf16) on {b} x {rows} cache rows in {nblk} row blocks, "
          f"position {pos}, combined by log-sum-exp in float32, against the plain decode on "
          f"the whole cache, on the card: largest error / largest magnitude {err:.3g} "
          f"(tolerance {MLA_BLOCKS_TOL}); {time.perf_counter() - t0:.2f} s")
    del p, cache, got, want
    torch.cuda.empty_cache()


def _expert_blocks(dev) -> None:
    """One DeepSeek-V2 MoE layer at published width (160 experts of 5120 x
    1536, bf16, ~7.5 GB) on EXPERT_BLOCKS' decode tokens: each block of
    experts' share of ``y`` (``ffn._moe_local`` on the block's weights,
    ``first`` its first expert: the whole batch routed, only its experts'
    buffers filled), the shares added as the EP group's all-reduce adds
    them, against ``_moe_local`` on the whole layer; every block's counts
    equal the whole layer's."""
    import types

    from repro_torch.models import ffn

    cfg = _moe_config()
    t, nblk = EXPERT_BLOCKS
    e = cfg.n_routed_experts
    g = torch.Generator(device=dev).manual_seed(0)
    p = ffn.MoEFFN(cfg, device=dev, generator=g)
    x = torch.randn((t, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    bias = 0.1 * torch.randn((e,), generator=g, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        want, counts = ffn._moe_local(x, bias, p, cfg)
        got = torch.zeros(want.shape, dtype=torch.float32, device=dev)
        el = e // nblk
        for j in range(nblk):
            rows = slice(j * el, (j + 1) * el)
            blk = types.SimpleNamespace(gate=p.gate, w_in=p.w_in[rows], w_gate_h=p.w_gate_h[rows],
                                        w_out=p.w_out[rows])
            part, c = ffn._moe_local(x, bias, blk, cfg, first=j * el)
            assert torch.equal(c, counts), f"block {j}: counts differ"
            got += part.float()
    torch.cuda.synchronize()
    err = _scaled_err(got.to(want.dtype), want)
    assert bool(torch.isfinite(got).all()) and err <= EXPERT_BLOCKS_TOL, err
    print(f"phase 10 {cfg.name}'s MoE layer ({e} experts of {cfg.d_model} x {cfg.moe_d_ff}, "
          f"top-{cfg.moe_top_k}, bf16) on {t} decode tokens as {nblk} expert blocks of {el}, "
          f"each block's share of y added, against the whole layer, on the card: counts equal, "
          f"largest error / largest magnitude {err:.3g} (tolerance {EXPERT_BLOCKS_TOL}); "
          f"{time.perf_counter() - t0:.2f} s")
    del p, x, got, want
    torch.cuda.empty_cache()


FAMILY_BLOCKS = (2, 2048, 16)  # batch, tokens (RWKV's chunked WKV form), TP ranks
FAMILY_BLOCKS_REPS = 10


def _whole_rank_ms(res) -> tuple[float, float]:
    """``res``' whole and rank callables timed as whole, rank, rank, whole
    (FAMILY_BLOCKS_REPS calls each), so that neither reading always comes
    first; each the mean of its two readings."""
    w1 = _time_ms(res["whole"], FAMILY_BLOCKS_REPS)
    r1 = _time_ms(res["rank"], FAMILY_BLOCKS_REPS)
    r2 = _time_ms(res["rank"], FAMILY_BLOCKS_REPS)
    w2 = _time_ms(res["whole"], FAMILY_BLOCKS_REPS)
    print(f"phase 10 readings (ms): whole {w1:.3f}, rank {r1:.3f}, rank {r2:.3f}, whole {w2:.3f}")
    return (w1 + w2) / 2, (r1 + r2) / 2


def _family_blocks(dev, times: dict) -> None:
    """Phase 10 (f)-(h), the other families' TP blocks at published width,
    bf16, on the card (``tests/test_torch_cuda.py``'s helpers): (f)
    RWKV6-1.6B's time and channel mix on FAMILY_BLOCKS' tokens as 16 ranks
    of 2 WKV heads and 448 hidden units, each rank's WKV heads and state
    against the whole call's, the ranks' summed ``wo`` and ``wv`` products
    against the whole layer; (g) Hymba-1.5B's Mamba layer as 16 blocks of
    200 inner channels, the summed partial ``xdbc`` and outputs against
    the whole layer; each within TP_BLOCKS_TOL of the largest magnitude,
    rank 0's layer timed against the whole layer's; (h) Whisper-small's
    encoder self-attention (S = T = 1500) and cross-attention (S 432, T
    1500) through ``ops.flash_attention`` on each rank's heads at TP 2
    and 4, bit for bit, each rank's call timed."""
    from repro_torch.kernels import flash_attn as flash_k

    card_tests = _card_tests()
    tol = card_tests.TP_BLOCKS_TOL
    b, s, tp = FAMILY_BLOCKS
    t0 = time.perf_counter()
    res = card_tests.rwkv_rank_blocks(dev, b, s, tp)
    errs = {k: res[k] for k in ("wkv_err", "state_err", "tm_err", "cm_err")}
    assert all(e <= tol for e in errs.values()), errs
    whole_ms, rank_ms = _whole_rank_ms(res)
    times["rwkv_blocks_ms"] = {"whole": whole_ms, "rank": rank_ms}
    print(f"phase 10 {res['cfg'].name}'s time and channel mix (bf16) on {b} x {s} tokens as "
          f"{tp} ranks of {res['heads']} WKV heads and {res['hidden']} hidden units, on the "
          f"card: each rank's chunked WKV heads "
          f"{'equal the whole call bit for bit' if res['wkv_equal'] else 'differ'} (largest "
          f"error / magnitude {errs['wkv_err']:.3g}); the time mix's state "
          f"{errs['state_err']:.3g}, the summed wo products {errs['tm_err']:.3g}, the channel "
          f"mix (gate gathered, wv products summed) {errs['cm_err']:.3g} (tolerance {tol}); a "
          f"rank's layer {rank_ms:.3f} ms against the whole layer's {whole_ms:.3f} ms "
          f"({whole_ms / rank_ms:.2f}x)")
    del res
    res = card_tests.mamba_rank_blocks(dev, b, s, tp)
    errs = {k: res[k] for k in ("xdbc_err", "out_err", "state_err")}
    assert all(e <= tol for e in errs.values()), errs
    whole_ms, rank_ms = _whole_rank_ms(res)
    times["mamba_blocks_ms"] = {"whole": whole_ms, "rank": rank_ms}
    print(f"phase 10 {res['cfg'].name}'s Mamba layer (bf16) on {b} x {s} tokens as {tp} blocks "
          f"of {res['channels']} inner channels, on the card: summed partial xdbc "
          f"{errs['xdbc_err']:.3g}, summed outputs {errs['out_err']:.3g}, the blocks' states "
          f"{errs['state_err']:.3g} of the largest magnitude (tolerance {tol}); a rank's call "
          f"{rank_ms:.3f} ms against the whole call's {whole_ms:.3f} ms "
          f"({whole_ms / rank_ms:.2f}x)")
    del res
    torch.cuda.empty_cache()
    times["whisper_heads"] = {}
    for which in card_tests.WHISPER_ATTN:
        q, k, v, kw = card_tests.whisper_attn_inputs(dev, which, b)
        whole_ms = _time_ms(lambda: flash_k.flash_attention_cuda(q, k, v, **kw), FLASH_TIME_REPS)
        times["whisper_heads"][which] = _tp_heads_check(
            q, k, v, kw, whole_ms, f"phase 10 whisper-small {which} attention on one rank's heads")
    times["family_blocks_s"] = time.perf_counter() - t0
    print(f"phase 10 (f)-(h): {times['family_blocks_s']:.1f} s")
    torch.cuda.empty_cache()


DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
                ("gemma2-9b", "decode_32k"))
# FLOPs a rank of smollm-135m / train_4k / pod16x16: with every rank
# holding the whole batch of 256 rows; on its 16 rows with whole layers;
# the reference's chip (its examples/multipod_dryrun.py --single-pod).
WHOLE_BATCH_TRAIN_FLOPS = 2.2005e15
ROWS_TRAIN_FLOPS = 1.375334e14
REFERENCE_TRAIN_FLOPS = 7.817e13
# A rank's FLOPs with the dense decoder split over model, bounded just
# above its count by term (65,536 tokens x (30 layers x 4 passes with
# remat x 11.54 MFLOP of whole attention and 1/16 of the FFN + 3 passes x
# 1/16 of the head's 56.6)).  It stays above the reference chip's: the 9
# heads do not divide over 16 ranks, so each rank computes the whole
# attention (ROADMAP item 19d).
TP_TRAIN_FLOPS_MAX = 9.15e13
# A deepseek-v2-236b / decode_32k rank holding its blocks (MLA heads and
# the shared experts over TP, 10 experts' 1/16 of D, 1/256 of the cache):
# ~5.0e9 B of arguments and ~5.2e11 FLOPs (8.1443e12 with whole MLA).
MOE_DECODE_ARGS_MAX = 6.5e9
MOE_DECODE_FLOPS_MAX = 1.0e12
DRYRUN_STEPS = 3  # real steps timed after the traced one


def _dryrun_phase(dev, times: dict) -> dict:
    """Phase 11: the dry run against the card.  (a) Phase 9's SmolLM-135M
    train step (8 x 2048, full width and depth, bf16, no context) traced
    on fake tensors, then run for real under the same ``FlopCounterMode``
    and op recorder: the FLOPs must be equal and every kernel call's fake
    outputs must have the real launch's shapes, dtypes and strides; the
    predicted and measured peak memory, the roofline's three terms at
    H100 peaks and the step's roofline share are printed.  (b) Three cells
    of ``launch/dryrun.py`` on the production mesh: a rank's FLOPs,
    temporaries and collective bytes by group (dp, TP), and its decode
    cache against the whole batch's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, model_stats, roofline
    from repro_torch.models import parallel
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated(dev) < 1e9, (
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated before phase 11")
    card = _card()
    cfg = get_config(TRAIN_ARCH)
    step_fn = train_loop.make_train_step(
        cfg, adamw.OptimConfig(lr=3e-4, total_steps=12, warmup_steps=2))

    # (a) the fake trace, then the same step for real.
    ops.reset_launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fstate = dryrun.fake_train_state(cfg, None, dev)
        fbatch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32, device=dev)
                  for k in ("tokens", "labels")}
        fake = dryrun.trace_step(lambda: step_fn(fstate, fbatch), (fstate, fbatch))
    del fstate, fbatch
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    state = train_loop.init_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipeline.global_batch_at(0, data).items()}
    assert all(t.dtype == torch.int32 for t in batch.values())
    state, _ = step_fn(state, batch)  # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    real = dryrun.trace_step(lambda: step_fn(state, batch), (state, batch))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == cfg.num_layers, (
        launches)
    assert fake["flops"] == real["flops"], (fake["flops"], real["flops"])
    assert fake["analysis"]["flops"] == real["analysis"]["flops"]
    calls = [(name, [(shape, dt, st) for shape, dt, st in outs])
             for name, outs in real["kernel_calls"]]
    assert len(calls) == 2 * cfg.num_layers and fake["kernel_calls"] == calls, (
        [c for c in zip(fake["kernel_calls"], calls) if c[0] != c[1]][:2])
    real_flops = real["flops"]
    del real
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(DRYRUN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    assert bool(torch.isfinite(metrics["loss"])), metrics
    del state, batch, metrics
    step_s = float(np.median(walls))
    an = fake["analysis"]
    predicted = an["argument_bytes"] + an["peak_bytes"]
    rec = dryrun.cell_record(fake, parallel.MeshShape((1,), ("data",)), [cfg.num_layers])
    cell = roofline.cell_roofline(
        {"arch": TRAIN_ARCH, "shape": "phase9", "mesh": "one card", **rec}, 1)
    model_flops = 6.0 * model_stats.count_active_params(cfg) * TRAIN_BATCH * TRAIN_SEQ
    share = model_flops / (roofline.PEAK_FLOPS * step_s)
    times["dryrun_step_s"] = time.perf_counter() - t_phase
    print(f"phase 11 dry run of phase 9's step ({TRAIN_ARCH}, {TRAIN_BATCH} x {TRAIN_SEQ}, bf16, "
          f"no context) on {card}: fake trace {fake['seconds']:.2f} s, {an['n_ops']} ops, no "
          f"kernel launched; FLOPs fake {fake['flops']:.6e} == real {real_flops:.6e} "
          f"(FlopCounterMode, equal), the op trace's {an['flops']:.6e}; "
          f"{len(calls)} kernel calls, fake outputs equal the real launches' shapes, dtypes and "
          f"strides; arguments predicted {an['argument_bytes'] / 1e9:.3f} GB, held "
          f"{held / 1e9:.3f} GB; peak predicted {predicted / 1e9:.3f} GB, measured "
          f"{peak / 1e9:.3f} GB (ratio {predicted / peak:.3f})")
    print(f"phase 11 roofline at H100 peaks (989e12 FLOP/s, 3.35e12 B/s, 450e9 B/s) on {card}: "
          f"compute {cell.compute_s * 1e3:.3f} ms, memory {cell.memory_s * 1e3:.3f} ms, "
          f"collective {cell.collective_s * 1e3:.3f} ms ({cell.dominant}); measured step "
          f"{step_s * 1e3:.1f} ms (median of {DRYRUN_STEPS}: "
          + ", ".join(f"{w * 1e3:.1f}" for w in walls)
          + f"); model FLOPs 6ND {model_flops:.4e}, roofline share {share:.4f}; the bound "
          f"{cell.step_s * 1e3:.3f} ms over the step {cell.step_s / step_s:.4f}")

    # (b) three cells of the dry run on the production mesh, each rank on its
    # dp block of the rows and a dense decoder's TP blocks.
    out_dir = ROOT / "build" / "dryrun"
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=out_dir, force=True)
        assert rec["ok"], rec.get("traceback")
        assert rec["trace_device"] == "cuda" and rec["hlo_flops"] == rec["cost"]["flops"] > 0
        by_group = json.dumps(rec["collectives_by_group"])
        if dryrun.SHAPES[shape].kind == "train":
            assert rec["hlo_flops"] <= TP_TRAIN_FLOPS_MAX, rec["hlo_flops"]
            split = (f"flops over the whole batch's {WHOLE_BATCH_TRAIN_FLOPS:.4e}: "
                     f"{rec['hlo_flops'] / WHOLE_BATCH_TRAIN_FLOPS:.6f}, over the rank's with "
                     f"whole layers {ROWS_TRAIN_FLOPS:.6e}: "
                     f"{rec['hlo_flops'] / ROWS_TRAIN_FLOPS:.4f}, over the reference chip's "
                     f"{REFERENCE_TRAIN_FLOPS:.4e}: {rec['hlo_flops'] / REFERENCE_TRAIN_FLOPS:.4f}; "
                     f"collective bytes by group {by_group}")
        else:
            whole, rank, parts = _decode_cache_bytes(arch, shape)
            assert rank * parts == whole == rank * 256, (rank, whole, parts)
            if arch.startswith("deepseek"):  # MLA, shared and expert blocks held
                assert rec["memory"]["argument_size_in_bytes"] <= MOE_DECODE_ARGS_MAX, rec["memory"]
                assert rec["hlo_flops"] <= MOE_DECODE_FLOPS_MAX, rec["hlo_flops"]
            split = (f"the rank's decode cache {rank / 2**30:.4f} GiB over the whole batch's "
                     f"{whole / 2**30:.3f} GiB: {rank / whole:.6f} (1/{parts}); collective bytes "
                     f"by group {by_group}")
        print(f"phase 11 dry run {arch} / {shape} / pod16x16 (256 fake ranks, fake cuda "
              f"tensors, each rank its dp block of the rows): traced in {rec['lower_s']} s, "
              f"{rec['n_ops']} ops; per rank flops {rec['hlo_flops']:.4e}, HBM bytes "
              f"{rec['hlo_bytes_hbm_v2']:.4e}, collective bytes "
              f"{rec['collectives']['total']:.4e} " + json.dumps(rec["collectives"])
              + f", arguments {rec['memory']['argument_size_in_bytes'] / 1e9:.2f} GB, "
              f"temporaries {rec['memory']['temp_size_in_bytes'] / 1e9:.2f} GB "
              f"({rec['memory']['temp_size_in_bytes'] / 2**30:.2f} GiB); {split}")
    assert not any(ops.launch_counts()[k] for k in ops.launch_counts()
                   if k not in ("flash_attention", "flash_attention_bwd")), ops.launch_counts()

    # (c) what calling the kernels as operators costs the host.
    host = _op_host_cost(dev)
    print(f"phase 11 host time a call through the operator against the binding alone "
          f"(median of {OP_COST_ROUNDS} rounds of {OP_COST_CALLS} calls, in turns) on {card}: "
          + "; ".join(f"{name} {op_us:.2f} us against {bind_us:.2f} us (+{op_us - bind_us:.2f})"
                      for name, (op_us, bind_us) in host.items()))
    times["dryrun_phase_s"] = time.perf_counter() - t_phase
    return {"fake_flops": fake["flops"], "step_ms": step_s * 1e3, "share": share,
            "peak_ratio": predicted / peak, "host_us": host}


OP_COST_CALLS = 200
OP_COST_ROUNDS = 5


def _decode_cache_bytes(arch: str, shape: str) -> tuple[int, int, int]:
    """Bytes of a decode cell's cache (meta tensors): the whole batch's, a
    rank's on the production mesh (``init_decode_cache``: its dp rows and a
    dense decoder's ``cache_specs`` block over TP), and the number of
    blocks the whole cache should split into (dp, times TP where it
    splits)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_context, make_production_mesh
    from repro_torch.models import model, partitioning

    cfg = dryrun.cell_config(arch, dryrun.SHAPES[shape])
    ctx = make_context(make_production_mesh(), cfg.n_routed_experts if cfg.moe else 0)
    params = model.Model(cfg, device="meta")
    b, s = dryrun.SHAPES[shape].global_batch, dryrun.SHAPES[shape].seq_len

    def nbytes(tree) -> int:
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    tree = {k: v for k, v in model.init_decode_cache(params, cfg, b, s, ctx).items()
            if isinstance(v, dict)}  # the split marks are strings
    parts = ctx.dp_size * (ctx.tp_size if partitioning.kv_cache_split(cfg, ctx, s) else 1)
    return nbytes(model.init_decode_cache(params, cfg, b, s)), nbytes(tree), parts


def _op_host_cost(dev) -> dict:
    """``name -> (us a call through ops.*, us a call of the binding)`` at a
    decode step's router shape (T 4, E 160, k 6) and a small attention,
    each timed with the host clock over ``OP_COST_CALLS`` calls ending in a
    synchronise, in turns (binding, operator, operator, binding)."""
    from repro_torch.kernels import flash_attn, moe_route, ops

    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((4, 160), generator=g, device=dev)
    bias = torch.zeros(160, device=dev)
    q = torch.randn((1, 16, 8, 64), generator=g, device=dev).to(torch.bfloat16)
    calls = {
        "moe_route": (lambda: ops.moe_route(logits, bias, 6),
                      lambda: moe_route.moe_route_cuda(logits, bias, 6)),
        "flash_attention": (lambda: ops.flash_attention(q, q, q, scale=0.125),
                            lambda: flash_attn.flash_attention_cuda(q, q, q, scale=0.125)),
    }

    def per_call_us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_COST_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OP_COST_CALLS * 1e6

    out = {}
    with torch.no_grad():
        for name, (op, binding) in calls.items():
            op(), binding()  # warm
            ops_us, bind_us = [], []
            for _ in range(OP_COST_ROUNDS):
                bind_us.append(per_call_us(binding))
                ops_us.append(per_call_us(op))
                ops_us.append(per_call_us(op))
                bind_us.append(per_call_us(binding))
            out[name] = (float(np.median(ops_us)), float(np.median(bind_us)))
    return out


def dryrun_phase_only() -> None:
    """Phase 1's build and phase 11 alone, for a short call on the card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    times: dict[str, float] = {}
    result = _dryrun_phase(dev, times)
    print("times (s): " + json.dumps(times) + f" on {_card()}")
    print(json.dumps(result))


def parallel_phase_only() -> None:
    """Phase 1's build and phase 10 alone, for a short call on the card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    times: dict[str, float] = {}
    launches = _parallel_phase(dev, times)
    print("times (s): " + json.dumps(times) + f" on {_card()}")
    print(json.dumps(launches))


def training_phase_only() -> None:
    """Phase 1's build and phase 9 alone, for a short call on the card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    times: dict[str, float] = {}
    kernels = _training_phase(dev, times, _card_tests())
    print("times (s): " + json.dumps(times) + f" on {_card()}")
    print(json.dumps(kernels))


def _card_tests():
    """``tests/test_torch_cuda.py``, whose serve_slots cases and comparison
    with the dense backend phases 2 and 3 share (loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", ROOT / "tests" / "test_torch_cuda.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.care import metrics, slotted_sim
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import jsaq_route as cuda_k
    from repro_torch.kernels import moe_route as moe_k
    from repro_torch.serve import engine
    card_tests = _card_tests()

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    times: dict[str, float] = {}

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    per_source = _build.build_all()
    times["build_s"] = time.perf_counter() - t0
    print(f"phase 1 build: {times['build_s']:.2f} s wall, per source "
          + ", ".join(f"{n} {s:.2f} s" for n, s in per_source.items()))
    for name in _build.KERNELS:
        log = (_build.build_dir() / f"lib{name}.log").read_text(errors="replace")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    _flash_build_report()
    floor_ms = _device_ms(moe_k.launch_floor_cuda, MOE_TIME_REPS)
    print(f"phase 1 launch floor (an empty block, queue filled): {floor_ms:.5f} ms")
    k = MAIN_KS[-1]
    tile = cuda_k.care_tile(k)
    n_tiles = -(-k // tile)
    print(f"phase 1 care_route at K={k:.0e}: tiles of {tile} servers, {n_tiles} tiles, "
          f"{20 * n_tiles} B of dynamic shared memory a block (the tile table), "
          f"{min(cuda_k.CARE_WARPS, n_tiles)} warps")

    rng = np.random.default_rng(2022)

    # -- 2. kernels against their plain versions -------------------------------
    jsaq_err = 0.0
    # Each case equal to its plain version; device time with the queue
    # filled, and from the host (the kernels line's ms).
    for name, qc, n in _jsaq_cases(rng, dev, card_tests):
        d, k = qc.shape
        got = cuda_k.jsaq_route_cuda(qc, n)
        err = _max_abs_err(got, ref.jsaq_route_ref(qc, n))
        assert err == 0, f"jsaq_route {name} differs from its plain version by {err}"
        again = cuda_k.jsaq_route_cuda(qc, n)
        assert all(torch.equal(a, b) for a, b in zip(again, got)), f"jsaq_route {name} repeat"
        if name == "JSAQ_SHAPE":
            assert int(got[0][0, 0]) == 0, "the all-ties row must route to index 0 first"
        rounds = cuda_k.jsaq_route_levels(qc.cpu(), n)[2]
        work = 4 * (3 * n + 3 * cuda_k.jsaq_max_rounds(n))
        smem_max = cuda_k._jsaq_smem_max(qc.device)
        home = "shared memory" if work <= smem_max else "device scratch"
        ms, host_ms = _jsaq_times(cuda_k.jsaq_route_cuda, qc, n)
        plain_ms = _time_ms(lambda: ref.jsaq_route_ref(qc, n), 3)
        bound = _bound_ms(4 * (2 * d * k + d * n), 0)
        dense = _bound_ms(4 * (2 * d * k + d * n), JSAQ_OPS_PER_SERVER_JOB * d * k * n)
        print(f"phase 2 jsaq_route {name} D={d} K={k} N={n}: equal, a repeat identical; "
              f"rounds a row {int(rounds.min())}-{int(rounds.max())} (at most "
              f"{cuda_k.jsaq_max_rounds(n)}); work space {work} B a row in {home} (at most "
              f"{smem_max} B shared); kernel {ms:.5f} ms device time ({host_ms:.5f} ms from "
              f"the host), plain {plain_ms:.3f} ms; bound {bound[0]:.6f} ms ({bound[1]}), "
              f"dense bound {dense[0]:.6f} ms ({dense[1]}), launch floor {floor_ms:.5f} ms, "
              f"kernel / floor {ms / floor_ms:.2f}")
        jsaq_err = max(jsaq_err, err)
        if name == "JSAQ_SHAPE":
            jsaq_ms, jsaq_plain_ms, jsaq_bound = host_ms, plain_ms, bound

    def care_parity(arrive, params, **kw):
        got = cuda_k.care_route_cuda(arrive, params, **kw)
        err = _max_abs_err(got, ref.care_route_ref(arrive, params, **kw))
        assert err == 0, f"care_route {kw} differs from its plain version by {err}"
        return got

    d, k, t = CARE_SMALL
    horizons = torch.tensor([t, t, 4 * t // 5, 0, 1, t // 2, t, t - 1], dtype=torch.int32)
    arrive = torch.from_numpy((rng.random((d, t)) < 0.95).astype(np.int32))
    arrive = (arrive * (torch.arange(t)[None, :] < horizons[:, None])).int().to(dev)
    params = torch.stack([
        torch.from_numpy(rng.integers(2, 5, d).astype(np.int32)),
        torch.full((d,), 7, dtype=torch.int32),
        torch.full((d,), 8, dtype=torch.int32),
        horizons,
    ], 1).contiguous().to(dev)
    t0 = time.perf_counter()
    for policy in ("jsq", "jsaq"):
        for comm in KINDS:
            care_parity(arrive, params, servers=k, cap=16, policy=policy, comm=comm)
    print(f"phase 2 care_route jsq/jsaq x {len(KINDS)} kinds D={d} K={k} T={t}: "
          f"equal ({time.perf_counter() - t0:.1f} s)")

    d, k, t = CARE_FULL
    arrive = torch.from_numpy((rng.random((d, t)) < 0.95).astype(np.int32)).to(dev)
    arrive[1, 7 * t // 8:] = 0
    params = torch.tensor([[2, 100, 8, t], [3, 100, 8, 7 * t // 8]],
                          dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    got = care_parity(arrive, params, servers=k, cap=16, policy="jsaq", comm="dt")
    assert int(got[3][:, 2].sum()) > 0
    print(f"phase 2 care_route D={d} K={k:.0e} T={t}: equal "
          f"({time.perf_counter() - t0:.1f} s with the plain version)")
    del got

    # Rows whose tiles rest and wake, then the edge and drop rows.
    t0 = time.perf_counter()
    drops = 0
    for (d, k, t), rows, cap, comms in (
        (CARE_WAKE, CARE_WAKE_ROWS, 16, ("rt", "et_rt")),
        (CARE_EDGE, CARE_EDGE_ROWS, 1, KINDS),
        (CARE_DROP, CARE_DROP_ROWS, 1, KINDS),
    ):
        params = torch.tensor(rows, dtype=torch.int32, device=dev)
        arrive = (torch.from_numpy(rng.random((d, t)) < 0.95).to(dev)
                  & (torch.arange(t, device=dev)[None, :] < params[:, 3:4])).int()
        if rows is CARE_EDGE_ROWS:
            arrive[2], arrive[5] = 1, 0  # an arrival every slot; none
        for policy in ("jsq", "jsaq"):
            for comm in comms:
                got = care_parity(arrive, params, servers=k, cap=cap, policy=policy, comm=comm)
                if rows is CARE_DROP_ROWS:
                    drops += int(got[3][:, 3].sum())
    assert drops > 0, "cap 1 must drop jobs"
    print(f"phase 2 care_route rows that rest and wake (rt, et_rt at D, K, T = "
          f"{CARE_WAKE}), edge rows (x <= 0, rt_period 1, msr 1, horizons 0 and 1, "
          f"cap 1) and drop rows ({drops} drops), jsq/jsaq: equal "
          f"({time.perf_counter() - t0:.1f} s with the plain version)")
    del got

    t0 = time.perf_counter()
    serve_cap = SERVE_MAIN["queue_cap"]
    for d, r, a_n in SERVE_PARITY:
        arrays, n_arr, act = _serve_state(rng, d, r, a_n, serve_cap, dev)
        for n_last in (0, a_n):  # the last run routes no lane, then all
            n_arr[-1] = n_last
            inputs = arrays + [torch.from_numpy(n_arr).to(dev),
                               torch.from_numpy(act).to(dev)]
            for comm in ("et", "exact"):
                kw = dict(cap=serve_cap, comm=comm)
                got = cuda_k.serve_route_cuda(*inputs, **kw)
                err = _max_abs_err(got, ref.serve_route_ref(*inputs, **kw))
                assert err == 0, f"serve_route R={r} {comm} differs by {err}"
                assert not bool(got[2][1].any()) and not bool(got[2][2].any())
                assert int(got[5][1]) == int(n_arr[1]) and int(got[5][2]) == 0
                if comm == "et":
                    assert int(got[0][0, 0]) == 0, "all ties must route to index 0 first"
    print(f"phase 2 serve_route et/exact at (D, R, A) in {list(SERVE_PARITY)} with "
          f"all-ties, full-ring, act=0, -0.0, n_arr=0 and n_arr=A runs: equal "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    slots_cases = []
    for name, (kw, horizons) in card_tests.SLOTS_CASES.items():
        cell = engine.ServeConfig(**{**card_tests.SLOTS_BASE, **kw})
        static = dataclasses.replace(cell.static_part(), trace_occupancy=True)
        got, args, _ = card_tests.slots_vs_dense(dev, static, cell, horizons)
        _, rem_in_smem = cuda_k.serve_slots_smem(
            cell.replicas, cell.decode_slots, args.work.shape[2], cell.comm,
            cell.decode_rates is not None)
        assert rem_in_smem == (not name.endswith("device_memory")), name
        if horizons is None or max(horizons) > 1:
            assert int(got["total_comp"].sum()) > 0, name
        if "drops" in name:
            assert int(got["dropped"].sum()) > 0, name
        slots_cases.append(f"{name} (comp {got['total_comp'].tolist()}, drops "
                           f"{got['dropped'].tolist()}, msgs {got['msgs'].tolist()})")
    print(f"phase 2 serve_slots against the dense backend, every output of _serve_core "
          f"and the end state, one serve_slots launch and no serve_route launch each: "
          f"equal in {'; '.join(slots_cases)} ({time.perf_counter() - t0:.1f} s)")

    # -- 3. the main path --------------------------------------------------------
    seeds = list(range(8))
    cells = [slotted_sim.Scenario.create(load=0.95, x=x, mean_service=8,
                                         service="deterministic", horizon=MAIN_SLOTS)
             for x in (2, 3)]
    main_launches = {}
    for k in MAIN_KS:
        static = slotted_sim.StaticConfig(
            servers=k, slots=MAIN_SLOTS, policy="jsaq", comm="dt", approx="msr",
            buffer_cap=16, service="deterministic", deterministic_ties=True,
            route_backend="fused",
        )
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        grid = slotted_sim.simulate_grid(seeds, static, cells)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        main_launches = ops.launch_counts()
        assert main_launches == {"jsaq_route": 0, "care_route": 1, "serve_route": 0,
                                 "serve_slots": 0, "moe_route": 0, "flash_attention": 0,
                                 **NO_BWD}, main_launches
        for c, x in enumerate((2, 3)):
            for res in grid[c]:
                assert res.max_aq <= x - 1, f"Theorem 2.3 violated: {res.max_aq}"
                assert res.arrivals - res.departures == int(res.final_q.sum())
                assert int(res.per_server_arrivals.sum()) == res.arrivals
                assert res.arrivals > 0.9 * MAIN_SLOTS and res.departures > 0
        runs = [r for row in grid for r in row]
        times[f"main_K{k}_s"] = wall
        print(f"phase 3 simulate_grid fused K={k:.0e} {len(runs)} runs T={MAIN_SLOTS}: "
              f"{wall:.2f} s; launches {main_launches}; messages per run "
              f"{min(r.messages for r in runs)}..{max(r.messages for r in runs)}; "
              f"max_aq {max(r.max_aq for r in runs)}; "
              f"gap_sup {max(r.queue_gap_sup for r in runs)}")

    # Kernel and plain times at the main path's largest shape, same inputs.
    arrive, _, _ = slotted_sim.draw_workload(seeds, static, cells, dev)
    arrive = arrive.int().contiguous()
    params = torch.tensor(
        [[int(s.x), int(s.rt_period), int(s.service.msr_slots), int(s.horizon)]
         for s in cells for _ in seeds], dtype=torch.int32, device=dev,
    )
    care = {}
    for comm in ("dt", "rt", "et_rt"):  # dt is the path's; rt and et_rt wake tiles
        kw = dict(servers=static.servers, cap=static.buffer_cap, policy="jsaq", comm=comm)
        kernel_ms = _time_ms(lambda: cuda_k.care_route_cuda(arrive, params, **kw), 5)
        got = cuda_k.care_route_cuda(arrive, params, **kw)
        plain = []
        plain_ms = _time_ms(
            lambda: plain.append(ref.care_route_ref(arrive, params, count_live=True, **kw)),
            1, warm=False,
        )
        err = _max_abs_err(got, plain[0][:4])
        assert err == 0, f"care_route {comm} at the main-path shape differs by {err}"
        live = int(plain[0][4].sum())
        active = int(params[:, 3].clamp(0, MAIN_SLOTS).sum())
        bound = _care_bound(arrive, params, static.servers, live)
        dense_bound = _care_bound(arrive, params, static.servers, static.servers * active)
        care[comm] = (kernel_ms, plain_ms, err, bound)
        print(f"phase 3 care_route {comm} D={arrive.shape[0]} K={static.servers:.0e} "
              f"T={MAIN_SLOTS}: equal; kernel {kernel_ms:.3f} ms "
              f"({kernel_ms / MAIN_SLOTS * 1e3:.3f} us a slot of the chain), plain "
              f"{plain_ms:.1f} ms; bound of these inputs {bound[0]:.6f} ms ({bound[1]}; "
              f"{live} server-slots not at rest or triggering, "
              f"{live / (static.servers * active):.2e} of all), dense bound "
              f"{dense_bound[0]:.3f} ms ({dense_bound[1]}; every server every slot)")
        del got, plain
    care_ms, care_plain_ms, care_err, care_bound = care["dt"]

    # Where the fused grid's time goes: one profiled call at K = 1e6.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slotted_sim.simulate_grid(seeds, static, cells)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    if device_us == 0:
        print("phase 3 fused grid profile: the profiler saw no device time; not measured")
    else:
        device.sort(key=lambda e: e.self_device_time_total, reverse=True)
        print(f"phase 3 fused grid profile, K={static.servers:.0e}: device busy "
              f"{device_us / 1e3:.3f} ms against an unprofiled wall of "
              f"{times[f'main_K{static.servers}_s'] * 1e3:.3f} ms; top device operations: "
              + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                          for e in device[:5]))

    # The serving engine's main path: one serve_slots launch a call.
    big = engine.ServeConfig(**SERVE_MAIN, **SERVE_WORK, comm="et", x=4,
                             deterministic_ties=True, route_backend="fused")
    t0 = time.perf_counter()
    for seed in SERVE_MAIN_SEEDS:
        engine.workload_for(big, seed)
    times["serve_main_sampling_s"] = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served = engine.serve_grid(list(SERVE_MAIN_SEEDS), big.static_part(), [big])[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = ops.launch_counts()
    assert serve_launches == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                              "serve_slots": 1, "moe_route": 0, "flash_attention": 0,
                              **NO_BWD}, serve_launches
    for res in served:
        assert res.dropped == 0, f"{res.dropped} requests dropped"
        assert res.offered == res.completed + res.dropped + int(res.final_occupancy.sum())
        assert res.completed > 0.8 * res.offered
        assert np.isfinite(res.mean_jct) and np.isfinite(res.p99_jct)
    times["serve_main_s"] = wall
    mpc = float(np.mean([r.msgs_per_completion for r in served]))
    print(f"phase 3 serve_grid fused {big.replicas} replicas x {big.decode_slots} "
          f"decode slots, {big.slots} slots, seeds {SERVE_MAIN_SEEDS}: "
          f"{wall:.4f} s ({wall / big.slots * 1e3:.5f} ms per slot; workload "
          f"sampling before it {times['serve_main_sampling_s']:.3f} s); launches "
          f"{serve_launches}; offered {[r.offered for r in served]}, completed "
          f"{[r.completed for r in served]}, dropped 0; JCT mean "
          f"{np.mean([r.mean_jct for r in served]):.3f} p99 "
          f"{np.mean([r.p99_jct for r in served]):.1f}; messages per completion "
          f"{mpc:.5f}")

    # serve_slots at the path's inputs: the whole horizon against the dense
    # backend (which fails on any difference), then timed.
    big_static = big.static_part()
    slots_out, args, plain_s = card_tests.slots_vs_dense(dev, big_static, big,
                                                         seeds=SERVE_MAIN_SEEDS)
    slots_err = 0.0
    n_arr, work, tie_u, rid, _, scn, static, n_cap, t_end = args[:9]
    kw = dict(cap=static.queue_cap, comm=static.comm, decode_slots=static.decode_slots,
              use_rates=static.use_rates, trace_occupancy=static.trace_occupancy,
              n_cap=n_cap)
    slot_args = (n_arr, work, rid, scn.x, scn.rt_period, scn.msr_drain, scn.decode_rates,
                 scn.horizon)
    slots_ms = _time_ms(lambda: cuda_k.serve_slots_cuda(*slot_args, **kw, t_end=t_end), 5)
    # The replica stage alone: the same call with no arrival lane.
    no_lanes = (torch.zeros_like(n_arr),) + slot_args[1:]
    stage_ms = _time_ms(lambda: cuda_k.serve_slots_cuda(*no_lanes, **kw, t_end=t_end), 5)
    slots_plain_ms = plain_s * 1e3
    lanes = _routed_lanes(n_arr, scn.horizon, t_end, work.shape[2])
    # A replica admits (lanes - drops) / R on average; past the ring's cap
    # some ring wrapped, and its reads after the wrap were compared too.
    admits = [n - d for n, d in zip(lanes, slots_out["dropped"].tolist())]
    per_replica = min(admits) / big.replicas
    assert per_replica > big.queue_cap, f"{per_replica} admits a replica: no ring wraps"
    slots_bound = _serve_slots_bound(work, scn, static, n_cap, t_end, lanes)
    print(f"phase 3 serve_slots D={work.shape[1]} R={big.replicas} S={big.decode_slots} "
          f"A={work.shape[2]} T={t_end}: equal to the dense backend over the whole "
          f"horizon ({per_replica:.1f} admits a replica against rings of "
          f"{big.queue_cap}); kernel {slots_ms:.4f} ms "
          f"({slots_ms / t_end * 1e3:.4f} us a slot, {slots_ms * 1e3 / max(lanes):.5f} us "
          f"per routed lane of the longest run; routed lanes per run {lanes}); with no "
          f"lane (the replica stage alone) {stage_ms:.4f} ms "
          f"({stage_ms / t_end * 1e3:.4f} us a slot); plain (the dense backend) "
          f"{slots_plain_ms:.3f} ms ({slots_plain_ms / t_end:.3f} ms a slot); bound of "
          f"the chain {slots_bound[0]:.6f} ms ({slots_bound[1]}), dense bound "
          f"{slots_bound[2]:.6f} ms ({slots_bound[3]}; an argmin over R a lane); kernel "
          f"share of the serve_grid wall {slots_ms / 1e3 / wall:.3f}")

    # The single-slot kernel on the routing state the loop leaves after
    # half the horizon (the state its middle slot routes on).
    half = cuda_k.serve_slots_cuda(*slot_args, **kw, t_end=big.slots // 2)
    mid = big.slots // 2
    state = [tie_u[mid].contiguous(), half["q_len"], half["q_head"], half["busy"],
             half["approx"], n_arr[mid].contiguous(), scn.horizon > mid]
    serve_kw = dict(cap=big.queue_cap, comm="et")
    serve_ms = _time_ms(lambda: cuda_k.serve_route_cuda(*state, **serve_kw), 50)
    got = cuda_k.serve_route_cuda(*state, **serve_kw)
    plain = []
    serve_plain_ms = _time_ms(
        lambda: plain.append(ref.serve_route_ref(*state, **serve_kw)), 3, warm=False
    )
    serve_err = _max_abs_err(got, plain[0])
    assert serve_err == 0, f"serve_route at the main-path shape differs by {serve_err}"
    serve_bound = _serve_bound(state[0].cpu(), state[1].cpu(), state[5].cpu(),
                               state[6].cpu())
    live = state[5].tolist()
    print(f"phase 3 serve_route D={state[0].shape[0]} R={big.replicas} "
          f"A={state[0].shape[1]} at slot {mid}'s state (lanes live {live}): equal; "
          f"kernel {serve_ms:.4f} ms ({serve_ms * 1e3 / max(live):.5f} us per live lane "
          f"of the longer run), plain {serve_plain_ms:.3f} ms, bound of the chain "
          f"{serve_bound[0]:.7f} ms ({serve_bound[1]}), dense bound {serve_bound[2]:.7f} "
          f"ms ({serve_bound[3]}; an argmin over R a lane)")
    del got, plain, half
    _profile_serving(engine, big, wall)

    # -- 3b. the streaming serving engine ------------------------------------------
    stream = _serving_stream(dev, times, card_tests)

    # -- 3c. the per-request dispatcher, dispatch_sim, the examples --------------
    _dispatcher_phase(dev, times, card_tests)

    # -- 4. dense against fused, then the Section 9 cell ---------------------------
    k, t = DENSE_VS_FUSED
    t0 = time.perf_counter()
    for policy, comm in (("jsaq", "dt"), ("jsaq", "et"), ("jsq", "exact"), ("jsq", "none")):
        dense = slotted_sim.StaticConfig(
            servers=k, slots=t, policy=policy, comm=comm, approx="msr",
            buffer_cap=16, service="deterministic", deterministic_ties=True,
        )
        fused = dataclasses.replace(dense, route_backend="fused")
        scn = slotted_sim.Scenario.create(load=0.95, x=3, rt_rate=0.02, mean_service=8,
                                          service="deterministic", horizon=t)
        arrive, sizes, _ = slotted_sim.draw_workload([0, 1], dense, [scn], dev)
        rd = slotted_sim.run_draws(arrive, sizes, dense, scn)
        rf = slotted_sim.run_draws(arrive, None, fused, scn)
        for name, value in rd.items():
            if name != "comp_slot":
                assert torch.equal(value.int(), rf[name].int()), f"{policy}/{comm} {name}"
        assert int((rd["routed"] >= 0).sum()) > 0
    # MMPP arrivals under a diurnal curve (the fused backend takes them as
    # the reference's pallas backend does).
    static_kw, scn_kw = card_tests.MMPP_FUSED
    card_tests.fused_vs_dense(dev, slotted_sim.StaticConfig(**static_kw),
                              slotted_sim.Scenario.create(**scn_kw))
    times["dense_vs_fused_s"] = time.perf_counter() - t0
    print(f"phase 4 dense == fused, decision for decision, K={k} T={t}, "
          f"jsaq x {{dt, et}}, jsq x {{exact, none}}, and jsaq x dt on MMPP arrivals "
          f"under a diurnal curve (K={static_kw['servers']}, T={static_kw['slots']}, "
          f"load {scn_kw['load']}, burst {scn_kw['burst_intensity']}, amp "
          f"{scn_kw['diurnal_amp']}): {times['dense_vs_fused_s']:.1f} s")

    cfg = slotted_sim.SimConfig(servers=30, slots=SECTION9_SLOTS, load=0.95,
                                mean_service=30, policy="jsaq", comm="et", x=3,
                                approx="msr")
    t0 = time.perf_counter()
    r = slotted_sim.simulate(0, cfg)
    times["section9_s"] = time.perf_counter() - t0
    assert r.max_aq <= 2 and r.arrivals - r.departures == int(r.final_q.sum())
    s = metrics.jct_summary(r.jct)
    assert s["count"] > 0.5 * SECTION9_SLOTS and np.isfinite(s["mean"])
    print(f"phase 4 Section 9 cell (K=30, JSAQ ET-3 + MSR, {SECTION9_SLOTS} slots, "
          f"dense): JCT mean {s['mean']:.3f} p99 {s['p99']:.1f}, messages per "
          f"departure {r.msgs_per_departure:.4f}, max_aq {r.max_aq}, "
          f"{times['section9_s']:.1f} s")

    # -- 4b. the slotted tier's breadth -----------------------------------------
    _slotted_breadth(dev, times, card_tests)

    # -- 4c. the degraded control plane ------------------------------------------
    _degraded(dev, times, card_tests)

    # -- 5. the serving ET ladder --------------------------------------------------
    def fused_cell(comm, x=4):
        return engine.ServeConfig(slots=LADDER_SLOTS, **SERVE_WORK, comm=comm, x=x,
                                  deterministic_ties=True, route_backend="fused")

    ladder = {}
    for comm, xs in (("et", LADDER_X), ("exact", (4,))):
        cells = [fused_cell(comm, x) for x in xs]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        grid = engine.serve_grid(list(LADDER_SEEDS), cells[0].static_part(), cells)
        times[f"ladder_{comm}_s"] = time.perf_counter() - t0
        ladder_launches = ops.launch_counts()
        assert ladder_launches["serve_slots"] == 1, ladder_launches
        assert ladder_launches["serve_route"] == 0, ladder_launches
        for x, row in zip(xs, grid):
            assert all(r.dropped == 0 for r in row)
            if comm == "exact":
                assert all(r.messages == r.completed for r in row)
            ladder[f"{comm}_x{x}"] = (
                float(np.mean([r.mean_jct for r in row])),
                float(np.mean([r.msgs_per_completion for r in row])),
            )
    exact_jct, exact_mpc = ladder["exact_x4"]
    print(f"phase 5 ET ladder, 8 replicas, {LADDER_SLOTS} slots, x {LADDER_X} x "
          f"{len(LADDER_SEEDS)} seeds: {times['ladder_et_s']:.2f} s, exact "
          f"{times['ladder_exact_s']:.2f} s; (mean JCT, messages per completion) "
          + json.dumps(ladder)
          + f"; et_comm_vs_exact {ladder['et_x4'][1] / exact_mpc:.5f}, "
          f"et_jct_vs_exact {ladder['et_x4'][0] / exact_jct:.4f}")

    # -- 6. serving dense against fused ---------------------------------------------
    t0 = time.perf_counter()
    for comm in ("et", "dt", "exact"):
        fused = engine.ServeConfig(**SERVE_DENSE_VS_FUSED, **SERVE_WORK, comm=comm,
                                   x=4, deterministic_ties=True, route_backend="fused")
        dense = dataclasses.replace(fused, route_backend="dense")
        ops.reset_launch_counts()
        rf = engine.serve_grid([0, 1], fused.static_part(), [fused])[0]
        assert ops.launch_counts()["serve_slots"] == 1
        rd = engine.serve_grid([0, 1], dense.static_part(), [dense])[0]
        assert ops.launch_counts()["serve_slots"] == 1
        for a, b in zip(rf, rd):
            for f in dataclasses.fields(engine.ServeResult):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if isinstance(va, np.ndarray):
                    assert np.array_equal(va, vb), f"serving {comm} {f.name}"
                else:
                    assert va == vb, f"serving {comm} {f.name}: {va} != {vb}"
            assert a.completed > 0
    times["serve_dense_vs_fused_s"] = time.perf_counter() - t0
    print(f"phase 6 serving dense == fused, field for field, "
          f"{SERVE_DENSE_VS_FUSED}, et/dt/exact x 2 seeds: "
          f"{times['serve_dense_vs_fused_s']:.1f} s")

    # -- 7. MoE serving -----------------------------------------------------------
    t0 = time.perf_counter()
    moe_kernel = _moe_serving(dev, times, floor_ms)
    times["moe_phase_s"] = time.perf_counter() - t0

    # -- 8. dense GQA serving ---------------------------------------------------
    t0 = time.perf_counter()
    flash_kernel = _dense_serving(dev, times)
    times["dense_phase_s"] = time.perf_counter() - t0

    # -- 8b. hybrid, attention-free and encoder-decoder serving -------------------
    t0 = time.perf_counter()
    family = _family_serving(dev, times)
    times["family_phase_s"] = time.perf_counter() - t0
    flash_kernel = {**flash_kernel, **family,
                    "max_abs_err": max(flash_kernel["max_abs_err"], family["family_max_abs_err"])}

    # -- 9. training ---------------------------------------------------------------
    train_kernels = _training_phase(dev, times, card_tests)

    # -- 10. the parallel context on one card ------------------------------------
    parallel = _parallel_phase(dev, times)
    moe_kernel["parallel_launches"] = parallel["moe"]["moe_route"]
    flash_kernel["parallel_launches"] = parallel["dense"]["flash_attention"]
    for entry in train_kernels:
        if entry["name"] == "moe_route_bwd":
            entry["parallel_launches"] = parallel["moe"]["moe_route_bwd"]
        if entry["name"] == "flash_attention_bwd":
            entry["parallel_launches"] = parallel["dense"]["flash_attention_bwd"]

    # -- 11. the dry run against the card ----------------------------------------
    _dryrun_phase(dev, times)

    # -- 12. output --------------------------------------------------------------
    kernels = [
        {
            "name": "care_route", "route": "cuda",
            "source": "src/repro_torch/csrc/care_route.cu",
            "replaces": "src/repro/kernels/jsaq_route.py:355",
            "launches": main_launches["care_route"],
            "max_abs_err": care_err, "ms": care_ms, "plain_ms": care_plain_ms,
            "bound_ms": care_bound[0], "bound_by": care_bound[1], "library_ms": None,
        },
        {
            "name": "jsaq_route", "route": "cuda",
            "source": "src/repro_torch/csrc/jsaq_route.cu",
            "replaces": "src/repro/kernels/jsaq_route.py:169",
            "launches": main_launches["jsaq_route"],
            "max_abs_err": jsaq_err, "ms": jsaq_ms, "plain_ms": jsaq_plain_ms,
            "bound_ms": jsaq_bound[0], "bound_by": jsaq_bound[1], "library_ms": None,
        },
        {
            "name": "serve_route", "route": "cuda",
            "source": "src/repro_torch/csrc/serve_route.cu",
            "replaces": "src/repro/kernels/jsaq_route.py:496",
            "launches": serve_launches["serve_route"],
            "max_abs_err": serve_err, "ms": serve_ms, "plain_ms": serve_plain_ms,
            "bound_ms": serve_bound[0], "bound_by": serve_bound[1], "library_ms": None,
        },
        {
            "name": "serve_slots", "route": "cuda",
            "source": "src/repro_torch/csrc/serve_route.cu",
            "replaces": "src/repro/kernels/jsaq_route.py:496",
            "launches": serve_launches["serve_slots"],
            "max_abs_err": slots_err, "ms": slots_ms, "plain_ms": slots_plain_ms,
            "bound_ms": slots_bound[0], "bound_by": slots_bound[1], "library_ms": None,
            **stream,
        },
        moe_kernel,
        flash_kernel,
        *train_kernels,
    ]
    times["total_s"] = time.perf_counter() - t_main
    print("times (s): " + json.dumps(times) + f" on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
