#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100, the CUDA
toolkit (``nvcc``) and Triton. Uses ``repro_torch`` only. Phases:

1. the card's name and power limit; float32 matmuls and convolutions in full
   float32 (TF32 off); the caching allocator's expandable segments, as the
   entry points set them (``device.resolve_device``), unless
   ``PYTORCH_ALLOC_CONF`` or ``PYTORCH_CUDA_ALLOC_CONF`` is set;
2. build the kernels from the checkout (K1 flash attention's four sources:
   the forward's sm90 kernel for bf16 at head dim 64-256 and SIMT kernel for
   the rest, the backward's sm90 kernel for bf16 at head dim 64, 128 and 256
   and SIMT kernel for the rest; K3 the RG-LRU scan, forward and
   backward; and the sLSTM recurrence; with ``nvcc`` for
   sm_90a, one process each, started together; K2 RMSNorm's forward and
   backward with Triton), report each library's ptxas lines and its HGMMA /
   UTMALDG / SYNCS instruction counts from ``cuobjdump -sass``, and hold
   each kernel against its plain version on the card: fp32 within 2e-5,
   bf16 within 2e-2, the LSE within 2e-5, the scan within 1e-5
   (``tests/test_kernels.py``), at the tests' shapes, at non-causal shapes
   with T != S, on strided views (sm90 route) and at the serving and
   training shapes of every path (whisper's non-causal encoder over 1500
   frames and cross-attention with T != S among them; K2 at widths 1024
   and 4096 too), each check naming its route; K3's
   backward against ``rglru_scan_backward_plain`` within the scan's 1e-5,
   with and without h0, at the tests' shapes and at the hybrid's training
   shape (2, 4096, 2560); K3 and its backward also equal to the bit to
   their blocked mirrors (``rglru_scan_blocked_plain``,
   ``rglru_scan_backward_blocked_plain``: the kernels' own order) and to a
   second call on the same inputs; then K1's and K2's gradients
   through their autograd functions (the backward kernels) against autograd
   through their plain versions and against the plain backwards
   (``flash_attention_bwd``, ``rmsnorm_backward``) on the same inputs: fp32
   within 1e-5 abs / 1e-4 rel, bf16 within 2e-2 of max(1, the gradient's
   largest magnitude); K1's bf16 gradients also against autograd through
   the plain version on fp32 copies of the inputs, at the same bound, with
   the plain bf16 versions' distances to that reference printed beside; at
   the tests' shapes with and without a window, at
   the training shape, at a windowed shape of training width, at head dim
   256 (windowed, ragged, and the hybrid's training shape q (2,4096,10,256)
   with window 2048; bf16 on the sm90 backward, fp32 on the SIMT one), at
   the training shapes of deepseek-moe-16b, whisper-medium (the
   non-causal encoder over 1500 frames, a ragged T, and cross-attention
   with S 448 and T 1500; the causal decoder at 448), internvl2-26b (a GQA
   group of 6) and qwen3-moe (a group of 16), at two small non-causal
   shapes with S and T both ragged and T != S ((2,100,4,2,64,300),
   (1,257,3,3,128,129)), and
   on views of a packed projection with a strided cotangent, each check
   naming its backward route; K2's backward also at the families' training
   widths (4,1500,1024), (4,448,1024), (4,1024,6144) and (4,1024,4096); the
   sLSTM kernel against ``slstm_scan_plain`` (``_slstm_checks``: fp32 max abs
   within 1e-5, bf16 relative L2 of h and of the last c within 2e-2) at
   xlstm-1.3b's gx (4, 2048, 8192) and the decode step's S = 1, in bf16 and
   fp32, from zeros and from a state, equal to a second call to the bit,
   and at long_500k's (1, 524288, 8192) on its first and last 4,096 steps,
   the last from the kernel's own state at step 520,192, with the kernel
   run in those two pieces equal to one run to the bit; the sm90 d-256 backward twice on the same
   inputs, equal to the bit (K2's fp32 gradients also against autograd through
   ``rmsnorm_plain`` and against ``rmsnorm_backward`` on fp64 copies of the
   inputs, since the kernel sums dw in fp64; the fp32 versions' distances
   to those are printed beside);
3. serve llama3-8b at its published width (32 layers, d_model 4096, vocab
   128256; random weights from a seed): prefill 4 x 512 tokens, then 16
   greedy decode steps through ``repro_torch.launch.serve``, counting kernel
   launches: K1 32 per prefill (all 32 on the sm90 kernel) and 0 per decode
   step, K2 65 per step; then
   one prefill and two decode steps under ``torch.profiler``: device time by
   kernel and the card's idle share; teacher forcing at full width
   (``forward`` over 513 tokens against prefill(512) + decode(1), relative
   L2 of the last logits <= 3e-2); the reduced config on the card against
   the CPU with the same weights, logits within 3e-2 (head dim 16: K1 takes
   the SIMT kernel, no sm90 launch);
4. the same for recurrentgemma-2b at its published width (26 layers: 18
   RG-LRU and 8 local attention with window 2048, d_model 2560, head dim
   256, vocab 256000): prefill 4 x 4096 tokens (longer than the window, so
   the ring buffer wraps), 16 decode steps, launches K1 8 (all sm90) / K2
   53 / K3 18 per prefill and 0 / 53 / 0 per decode step; the profile; teacher
   forcing at batch 1 over 4097 tokens (rel. L2 <= 1e-1 with bf16
   activations, the reference's own bound, and <= 3e-2 with fp32
   activations); the reduced config (40-token prompt, window 32) on the
   card against the CPU;
   the sharded runtime on the card (``phase_sharded_serve``,
   ``phase_hybrid_sharded_serve``, each right after its model's profile):
   a one-rank NCCL group (a ``file://`` store) and a (data 1, model 1)
   ``Mesh`` with its ``DeviceMesh``; the served weights wrapped as DTensors
   on ``param_pspec``'s placements with no copy, the same batch through the
   sharded ``make_serve_fns`` (caches on ``cache_pspec``), a warm-up at the
   counted shapes (its prefill ms printed: DTensor's first propagation),
   then 16 greedy steps: launch counts per step equal the single-device
   run's, prefill and last logits within 2e-2 of it (0.0 on an H100) and
   the same ids, prefill and decode ms beside the single-device path's;
   the group is destroyed after, so later phases run as before;
   then qwen2.5-14b at its published width and depth (48 layers, d_model
   5120, 40 q heads on 8 kv heads: a GQA group of 5, QKV bias; 14.77 B
   params, 59.1 GB in fp32) and granite-34b at its published width (48 q
   heads on one kv head, the non-gated GELU-tanh MLP) cut to 40 of its 88
   layers (63.1 GB in fp32; all 88 would take 135.8 GB): the same prefill
   and decode with launch counts (K1 48 and 40 per prefill, all sm90),
   teacher forcing and the reduced config card vs CPU;
   then the MoE, VLM, audio and SSM families at their published widths
   through the same entry points, each with launch counts per step,
   the peak memory, teacher forcing and its reduced config card vs CPU:
   deepseek-moe-16b whole (28 layers, 64 experts top 6 and 2 shared; 16.88
   B params, 67.5 GB in fp32; K1 28 / K2 57 per prefill, all sm90) with the
   share of assignments its capacity factor of 1.25 drops and the expert
   bytes a decode step reads; qwen3-moe-235b-a22b (128 experts top 8, 64 q
   heads on 4 kv heads: a GQA group of 16; bf16 params) cut to 12 of its
   94 layers (62.2 GB); both checked against teacher forcing at a
   capacity factor of E/k, where nothing drops, the decode step routed to
   the forward's experts, at batch 1, with bf16 and fp32 activations
   (3e-2), and card vs CPU in fp32 (bf16 routing near-ties); internvl2-26b's backbone (a GQA group of 6) cut to
   36 of its 48 layers (60.7 GB), 256 stub patches in front of 4 x 512
   tokens,
   decoding at 256 + 512 + i; whisper-medium whole (24 + 24 layers, head
   dim 64), 1500 stub frames and 4 x 432 tokens: K1 72 per prefill (24
   non-causal encoder, 24 non-causal cross-attention with S 432 and T
   1500, 24 causal self-attention; all sm90, tallied by shape), K2 122 per
   prefill and 73 per decode step; xlstm-1.3b whole (48 blocks, 4 x 2048
   tokens: 8 mLSTM chunks, each sLSTM block's 2,048 steps one kernel
   launch), no K1, K2 97 and the sLSTM kernel 6 per prefill and per decode
   step, its prefill ms printed beside the 4,616 ms the sLSTM's Python loop
   took (``XLSTM_LOOP_PREFILL_MS``),
   checked against teacher forcing in bf16 (1e-1) and fp32 (3e-2); each of
   these five also served on the one-rank NCCL mesh right after its
   single-device run, on the same weights with no copy
   (``phase_*_sharded_serve``): launches per step, prefill and last logits
   (within 2e-2; 0.0 expected) and ids equal to the single-device run's,
   for the MoE also every layer's expert ids of the prefill; then a
   training step of deepseek-moe-16b at full width cut to 4 of its 28
   layers (2.77 B params; fp32 params, grads, m and v 44 GB) at 4 x 1024,
   3 steps on one device, then 3 on the one-rank mesh from the same seed
   (``phase_moe_train``): the first loss equal to the bit, later losses
   and gnorms within 1e-5 relative (the dispatch's gathers add with
   atomics in the backward), equal launches, step ms, busy share and peak
   memory of both; then four more families train through
   ``launch/train.py --dp-sync gspmd --fixed-batch`` for 4 steps at batch
   4 (``phase_whisper_train``, ``phase_vlm_train``,
   ``phase_qwen3moe_train``, ``phase_xlstm_train``; the sLSTM kernel has no
   backward yet, so training runs its plain loop): whisper-medium whole
   over 1500 stub frames and 448 tokens (per step K1 144: 48 non-causal
   encoder, 48 non-causal cross-attention, 48 causal self-attention; K1's
   backward 72, the non-causal ones the first on the card; K2 242, K2's
   backward 122; tallied by shape), internvl2-26b's backbone at 4 of 48
   layers (2.70 B params) with 256 stub patches then 768 tokens through the
   ``step_fn`` the driver returns (the driver, like the reference's, draws
   no patches; K1 8, K1's backward 4, K2 17, K2's backward 9),
   qwen3-moe-235b-a22b at 1 of 94 layers in its bf16 params (3.73 B; K1 2,
   K1's backward 1, K2 5, K2's backward 3) and xlstm-1.3b at full width cut
   to 8 of its 48 blocks, one period, at 4 x 1024 (no K1, no sLSTM kernel;
   K2 33 and its backward 17, tallied by width; the cut keeps the script
   within its time beside the long_500k_xlstm cell): finite losses,
   the last below the first, the launches per step held to those counts,
   every K1 and K1-backward launch on the sm90 route, step ms (median of
   steps 2-4), tokens/s, peak GiB, the parameter count, and one more step
   under ``torch.profiler`` read from its raw events (busy share, top
   kernels, kernel groups); each reduced config then on the card against
   the CPU as ``phase_train_card_vs_cpu`` (head dim 16: the SIMT routes,
   whisper's non-causal backward among them; whisper's frames and the
   VLM's patches in the batch; qwen3-moe with fp32 params, its bf16 run
   compared only where every layer's routing ids agree on the two);
5. train qwen2.5-3b at its published width and depth (36 layers, d_model
   2048, vocab 151936, tied embeddings, 3.09 B params in fp32, bf16
   activations, remat "full"; random weights from a seed) through
   ``repro_torch.launch.train`` (``--dp-sync gspmd``, mesh 1x1), batch
   4 x 1024 on one fixed batch for 6 steps: finite losses, the last below
   the first; step ms (median of steps 2-6, host clock after a
   synchronize), tokens/s, peak memory, launches per step held to K1 72
   (36 forward + 36 recomputed, all sm90), K1's backward 36 (all sm90), K2
   145 and K2's backward 73; one more step under
   ``torch.profiler`` (card busy, idle share, time by kernel group and by
   the port's profiler ranges); the same six steps and profile under remat
   "dots" (``--remat-policy dots``: the projections' outputs saved, the
   attention, norms and gate math recomputed): the same launches, the
   first loss equal to "full"'s to the bit; each run's FLOP floor and
   ``model_flops_6nd`` (``launch/roofline.py``) at the bf16 peak as shares
   of its step time, on a line of their own; the Themis step on one card at
   full width cut to 18 layers, 16 chunks (1.70 B params: it keeps an fp32
   master, m, v and a flat gradient buffer beside the params), 2 steps from
   the same weights and batch as the GSPMD step: losses and gnorms within 1e-5
   relative, params per leaf within 1e-4 of the update's L2 and 1e-2 lr per
   element (set from that phase's own readings on an H100, 2.0e-6 and
   4e-4, with room on both sides); the sharded GSPMD step at the same
   size (``phase_sharded_train``): 3 single-device steps through
   ``launch/train.py``, then the same command on a one-rank (data 1,
   model 1) NCCL mesh (DTensor params and ZeRO-1 m/v, the batch on
   ``batch_pspec``): losses and gnorms within 1e-5 relative, params within
   the Themis phase's limits, equal launch counts, the step ms of both;
   and the GPipe loss of one "pipe" stage at n_micro 4 within 1e-3 of
   ``loss_fn`` (bf16); the reduced qwen2.5-3b (head dim 16,
   the SIMT routes) on
   the card against the CPU with the same weights and batch, loss and
   per-leaf grads within 1e-4 relative L2 with fp32 activations, and within
   3e-2 with bf16 or the CPU's own bf16-to-fp32 gap for a leaf where that
   is larger; checkpoints through ``launch/train.py --ckpt-dir`` at full
   width cut to 2 layers (``phase_ckpt_resume``: an uninterrupted run, the
   same run writing checkpoints 2 and 4, whose distance is the card's
   run-to-run gap, then a resume from checkpoint 2 after checkpoint 4 is
   deleted, whose steps 3-4 must lie within that gap; bytes and seconds of
   the writes and the restore);
6. train recurrentgemma-2b at its published width and depth (2.89 B params
   in fp32, bf16 activations, remat "full" per (rec, rec, attn) period, the
   2 tail blocks not checkpointed) the same way at 2 x 4096 tokens (twice
   the window) for 6 steps: finite, falling losses, step ms, tokens/s, peak
   memory, the FLOP floor's share, launches per step held to K1 16 (8
   forward + 8 recomputed, all sm90), K1's backward 8 (all sm90, head dim
   256), K2 101, K2's backward 53, K3 34 (18 + 16 recomputed) and K3's
   backward 18; one more step under ``torch.profiler``; the six steps and
   profile again under remat "dots" per period; the reduced
   recurrentgemma-2b (head dim 16, SIMT routes; 64 tokens past its window
   of 32) on the card against the CPU at qwen2.5-3b's bounds;
7. the repo's four shape cells (``configs/base.py``: prefill_32k,
   decode_32k, long_500k, train_4k) at full width and depth through the
   same entry points, each at one card's share: one data replica of the
   dry run's 16x16 mesh, so a batch of the global batch / 16 (long_500k's
   global batch of 1 stays 1) with the whole model on the card; one
   ``cell`` line each with its batch, lengths, peak GiB, times and the
   card. First their kernels against the plain versions at the cells'
   shapes (``_cell_checks``, the end of phase 2): K1 at prefill_32k's
   causal q (2, 32768, 32, 128) over 32,784 and 32,768 keys and at
   long_500k's q (1, 524288, 10, 256) with window 2048, every head of
   three or four query tiles of 128 rows (the first, the middle or those
   either side of the window's edge, the last) against the plain
   arithmetic over the keys they see, on fp32 copies, out and LSE (the
   whole score matrix is 275 GB), every launch sm90; K1 and its backward
   at train_4k's microbatch (2, 4096, 16 on 2 kv heads, 128); K3 at (1,
   524288, 2560) from h0 = 0 equal to its blocked mirror and a second
   call to the bit; K2 at (2, 32768, 4096), (8, 1, 4096), (1, 524288,
   2560) and (2, 4096, 2048), its backward at the last. Then
   ``phase_prefill_32k``: llama3-8b, 2 x 32,768 through ``serve.setup``
   and ``serve.generate`` after a warm-up of the same batch and one step,
   then 16 decode steps over the 32,784-position cache (K1 32 per
   prefill, all sm90; K2 65 per step), prefill ms, decode ms/token, peak
   GiB, and teacher forcing (row 0's first decode logits against a
   batch-1 prefill over the prompt and its token, 3e-2);
   ``phase_decode_32k``: the same params, 8 rows of 32,768-token prompts
   in a 32,784-position cache, filled a row at a time with the bf16 cache
   (32.0 GiB) and with the int8 cache of ``kv_quant`` (16.3 GiB), then 16 decode steps timed with CUDA events and one
   profiled, for each cache; the two caches' first decode logits on the
   same rows and tokens within ``INT8_VS_BF16_LIMIT`` (8e-2, about 3x
   the card's sound reading), and a planted fault beyond it (the codes
   read with the previous position's scales); the int8 cache's layer-0
   codes against the bf16 cache's values there within
   ``INT8_CODE_LIMITS`` (rms and bias in units of the scale), and the
   same values quantised with a truncating and a flooring round beyond
   them; ``phase_long_500k``:
   recurrentgemma-2b, 1 x 524,288 (the ring buffer of 2,048 slots wraps
   256 times), 16 decode steps from position 524,288 (K1 8, K3 18 per
   prefill), teacher forcing at 1e-1; ``phase_long_500k_xlstm``: xlstm-1.3b
   whole, 1 x 524,288 after a short warm-up (each mLSTM block runs 2,048
   chunks, 32 at a time; the sLSTM kernel 6 and K2 97 per prefill and per
   decode step), 16 decode steps, teacher forcing at 1e-1 as a decode of
   the prompt's last token from a prefill of the rest against the counted
   prefill's logits, the counted prefill split by CUDA events into the
   mLSTM chunk loops and the sLSTM kernel calls, and the card's busy share
   from a profiled prefill of 32,768 tokens; ``phase_train_4k``: qwen2.5-3b, 16 x
   4096 on one fixed batch, ``--microbatch`` from
   ``launch/dryrun.py::pick_microbatch`` for one data replica (8 slices of
   2 rows), 3 steps through ``launch/train.py`` with ``--dp-sync gspmd``
   (launches per step 8x those of a 2-row step; step ms, tokens/s, the
   ``model_flops_6nd`` share, peak GiB; one more step profiled), then with
   ``--dp-sync themis``, held to it at ``phase_themis_train``'s limits;
8. the simulator (``repro_torch.core``, on the host): paper Fig. 8 (the six
   Table-2 topologies x 100-1000 MB all-reduce under baseline/FIFO,
   themis/FIFO and themis/SCF through ``simulate_scheduled``) and Fig. 12
   (four workloads, compute calibrated to the paper's Ideal, then
   baseline/FIFO, themis/SCF and ideal iteration times), printed as
   simulated values (the CPU tests hold them equal to the reference's);
   the scenarios of ``benchmarks/faults_study.py``, ``tenancy_study.py``
   and ``traffic_study.py`` at their full sizes, through the port's
   ``faults``, ``tenancy`` and ``traffic`` packages (host only; simulated
   fabric times beside host seconds): the fault-free identity, 24 seeded
   chaos scenarios equal across the indexed and reference engines with the
   invariant sanitizer armed, and re-planning's speed-up >= 1.15 at a
   degradation to 0.1 (``phase_faults``); the fairness and workloads
   sweeps over four arbiter policies, the preemption cost and the tracker
   ablation on three Table-2 topologies, with weighted-fair beating fifo on
   Jain and the shared tracker winning on each (``phase_tenancy``); the
   traffic equivalence gate (the IR equal to ``simulate_requests`` and the
   batch runner equal to indexed, exactly; indexed within 1e-12 relative
   of reference, the reference's own 1-2 ulp gap), the mixed training and
   serving tenants' decode p50/p95/p99 and prefill p99, the DCN jitter
   sweep, and the long stream up to about 953k stage-ops with the compiled
   engine equal to indexed at each size (``phase_traffic``; its host times
   and their scaling exponent are printed, not gated); the four parts of
   ``benchmarks/fleet_study.py`` at full size through the port's ``fleet``
   package: calibration on 2D-SW_SW, the knee at 0.5-1.75x saturation
   with and without admission, four overload scenarios equal across the
   indexed and reference engines with the sanitizer armed (compiled equal
   to indexed), and the SLO-debt sweep on three Table-2 topologies, held to
   the study's gates and to its printed values (``phase_fleet``); the
   prover of ``verify_study.py`` through the port's ``verify`` package (24
   decisions in the expected verdict pattern, each refutation replayed
   identically on both engines) and the sanitizer off and on with
   identical results on both engines (``phase_verify``; its host-time
   ratios printed, not gated);
   then the compiled engine's wave kernel (``wave_done_times``, vectorized
   torch) on the card over 20 MB baseline RS requests of 4096 chunks, one
   every 100 us, at 64, 208 and 640 requests (2,621,440 chunks, 3 ranks):
   within 1e-9 relative of ``simulate(engine="compiled", fusion=False)``
   at 64 requests, of its own CPU run and of the sequential plain version
   at 640, a second card call equal to the bit; its ms (median of CUDA
   events), stage-ops per second and bound beside the host's
   ``simulate_compiled`` and CPU times;
9. each kernel's time at the serving and training shapes with CUDA events, beside its
   bound, its plain version's time and one PyTorch library call's time
   where one computes the same function (``ms`` with the launch queue
   filled first, so the card's time alone; ``host_ms`` as issued one call
   after another from Python); K1's rows also time the SIMT kernel at the
   same shapes (``previous_ms``) and give the achieved TFLOP/s and
   ``bound_ms / ms``; at the training shapes also K1's and K2's backward
   kernels beside their plain versions (``previous_ms``, the code the
   training path ran before them: the plain recompute at qwen2.5-3b's
   shape, the SIMT kernel at head dim 256), the library's backward and
   their bounds; K3 and its backward at (2, 4096, 2560); K1 and K2 at the
   prefills of qwen2.5-14b, granite-34b, deepseek-moe-16b, qwen3-moe,
   internvl2-26b and whisper-medium (its three attention shapes, the two
   non-causal ones against SDPA with ``is_causal=False``), K2 at
   xlstm-1.3b's (4, 2048, 4096); K1, K2 and their backwards at
   deepseek-moe-16b's training shape (q, k/v (4, 1024, 16, 128); x (4,
   1024, 2048)); K1, K1's backward, K2 and K2's backward at the four
   families' training shapes (whisper's three attention shapes, the
   non-causal ones against SDPA with ``is_causal=False``, and its two
   norm widths; internvl2-26b's q (4,1024,48,128) on 8 kv heads and x
   (4,1024,6144); qwen3-moe's q (4,1024,64,128) on 4 and x (4,1024,4096);
   xlstm-1.3b's x (4,1024,2048) and (4,1024,4096)), each row's launches its
   shape's in that run; the sLSTM kernel at xlstm-1.3b's gx (4, 2048, 8192)
   and long_500k's (1, 524288, 8192) in bf16, beside the plain loop over
   its first 2,048 steps, its bound with µs per step, and cuDNN's LSTM
   through ``torch.nn.LSTM(bias=False)`` (W_ih the identity, W_hh the dense
   expansion of r_gates; its c in bf16; cuDNN refuses the long shape); the kernels at the shape cells' shapes (phase 7;
   there the plain K1 runs by blocks of query rows and the plain K3 is its
   blocked mirror, one call each, and SDPA cannot take long_500k's
   window); and each training step's floor
   (its FLOPs at the bf16 peak) and ``model_flops_6nd`` share beside the
   measured step time;
10. the dry run (``python -m repro_torch.launch.dryrun``, meta tensors on a
   fake process group, host only; ``phase_dryrun``), one subprocess per
   cell, all at once, on the 16x16 production mesh: llama3-8b train_4k,
   qwen2.5-3b train_4k with ``--dp-sync themis``, deepseek-moe-16b
   train_4k, internvl2-26b prefill_32k, whisper-medium decode_32k,
   xlstm-1.3b long_500k, recurrentgemma-2b decode_32k, and llama3-8b
   train_4k on the 2x16x16 multi-pod mesh: every cell ``status: ok`` with
   the reference's keys, every train cell counting an all-reduce, an
   all-gather and a reduce-scatter; per-device GiB against the card's 80,
   FLOPs, bytes by kind and seconds per cell printed.

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, then
``{"ok": true, "device": {...}}`` last. Exits non-zero, without that last
line, when no CUDA card is present, when run outside a checkout of the
repository, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

# H100 SXM published peaks (dense, no sparsity), at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
L2_BYTES = 50 * 2**20
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = 1e-5
ARCH, BATCH, PROMPT, GEN = "llama3-8b", 4, 512, 16
HYB_ARCH, HYB_PROMPT = "recurrentgemma-2b", 4096
HYB = dict(h=10, kv=1, d=256, window=2048, d_model=2560)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen2.5-3b", 4, 1024, 6
HYB_TRAIN_BATCH, HYB_TRAIN_SEQ = 2, 4096      # twice the window
# K1's (b, s, h, kv, d, t, window) and the (b, s, width) of K2 and K3 in
# recurrentgemma-2b's training step
HYB_TRAIN_ATTN = (HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, HYB["h"], HYB["kv"], HYB["d"],
                  HYB_TRAIN_SEQ, HYB["window"])
HYB_TRAIN_X = (HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, HYB["d_model"])
QWEN = dict(h=16, kv=2, d=128, d_model=2048, layers=36)
THEMIS_LAYERS, THEMIS_STEPS = 18, 2
SHARDED_STEPS = 3
# the two dense configs served at full width: qwen2.5-14b (a GQA group of 5)
# at its published depth, granite-34b (MQA: 48 q heads on one kv head) cut
# to 40 of its 88 layers, whose fp32 weights then take 63.1 GB of the card
DENSE14B, GRANITE, GRANITE_LAYERS = "qwen2.5-14b", "granite-34b", 40
QWEN14B = dict(h=40, kv=8, d=128, d_model=5120, layers=48)
GRANITE_D = dict(h=48, kv=1, d=128, d_model=6144)
# K1's (b, s, h, kv, d, t, window) at the two prefills (t: the cache of
# PROMPT + GEN positions)
QWEN14B_ATTN = (BATCH, PROMPT, QWEN14B["h"], QWEN14B["kv"], QWEN14B["d"],
                PROMPT + GEN, 0)
GRANITE_ATTN = (BATCH, PROMPT, GRANITE_D["h"], GRANITE_D["kv"], GRANITE_D["d"],
                PROMPT + GEN, 0)
# the MoE, VLM, audio and SSM families served at full width: deepseek-moe-16b
# at its published depth (16.88 B params, 67.5 GB in fp32), qwen3-moe-235b-a22b
# cut to 12 of its 94 layers (bf16 params, its own param_dtype: 62.2 GB),
# internvl2-26b's backbone cut to 36 of its 48 layers (60.7 GB in fp32),
# whisper-medium (24 + 24 layers) and xlstm-1.3b (48 blocks), both whole
MOE16B, QWEN3MOE, QWEN3MOE_LAYERS = "deepseek-moe-16b", "qwen3-moe-235b-a22b", 12
VLM, VLM_LAYERS, WHISPER, XLSTM = "internvl2-26b", 36, "whisper-medium", "xlstm-1.3b"
MOE16B_D = dict(h=16, kv=16, d=128, d_model=2048, layers=28)
QWEN3MOE_D = dict(h=64, kv=4, d=128, d_model=4096)
VLM_D = dict(h=48, kv=8, d=128, d_model=6144, patches=256)
WHISPER_D = dict(h=16, kv=16, d=64, d_model=1024, frames=1500, prompt=432, layers=24)
XLSTM_D = dict(d_model=2048, inner=4096, prompt=2048, blocks=48)
# xlstm-1.3b's 4 x 2048 prefill with the sLSTM as a Python loop over time
# (this script on an H100 80GB HBM3 at 700 W, before the sLSTM kernel),
# printed beside the kernel's
XLSTM_LOOP_PREFILL_MS = 4616
# the sLSTM kernel on xlstm-1.3b's paths: gx (B, S, 4 x d_model), r_gates (4
# heads, 512, 2048); its gates against slstm_scan_plain: fp32 max abs, bf16
# relative L2 of h and of the last c
SLSTM_HEADS = 4
XLSTM_GX = (BATCH, XLSTM_D["prompt"], 4 * XLSTM_D["d_model"])
SLSTM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# deepseek-moe-16b's training step: full width cut to 4 of its 28 layers
# (2.77 B params: fp32 params, grads, m and v 44 GB), 4 x 1024, 3 steps;
# K1 at q, k/v (4, 1024, 16, 128) (a GQA group of 1), K2 at (4, 1024, 2048)
MOE_TRAIN = dict(layers=4, batch=4, seq=1024, steps=3)
MOE16B_TRAIN_ATTN = (MOE_TRAIN["batch"], MOE_TRAIN["seq"], MOE16B_D["h"],
                     MOE16B_D["kv"], MOE16B_D["d"], MOE_TRAIN["seq"], 0)
MOE16B_TRAIN_X = (MOE_TRAIN["batch"], MOE_TRAIN["seq"], MOE16B_D["d_model"])
# K1's (b, s, h, kv, d, t, window) on the new paths; window None: non-causal
MOE16B_ATTN = (BATCH, PROMPT, MOE16B_D["h"], MOE16B_D["kv"], 128, PROMPT + GEN, 0)
QWEN3MOE_ATTN = (BATCH, PROMPT, QWEN3MOE_D["h"], QWEN3MOE_D["kv"], 128,
                 PROMPT + GEN, 0)
VLM_PROMPT = VLM_D["patches"] + PROMPT
VLM_ATTN = (BATCH, VLM_PROMPT, VLM_D["h"], VLM_D["kv"], 128, VLM_PROMPT + GEN, 0)
WH_S, WH_F = WHISPER_D["prompt"], WHISPER_D["frames"]
WHISPER_ENC_ATTN = (BATCH, WH_F, 16, 16, 64, WH_F, None)
WHISPER_CROSS_ATTN = (BATCH, WH_S, 16, 16, 64, WH_F, None)
WHISPER_SELF_ATTN = (BATCH, WH_S, 16, 16, 64, WH_S + GEN, 0)
# K2's x on the new paths (b, s, width)
MOE16B_X = (BATCH, PROMPT, MOE16B_D["d_model"])
QWEN3MOE_X = (BATCH, PROMPT, QWEN3MOE_D["d_model"])
VLM_X = (BATCH, VLM_PROMPT, VLM_D["d_model"])
WHISPER_X = (BATCH, WH_F, WHISPER_D["d_model"])
XLSTM_X = (BATCH, XLSTM_D["prompt"], XLSTM_D["inner"])
# the serving-error keys of the new paths' kernel checks, by shape
# the four families that train after phase_moe_train, 4 steps each at batch
# 4: whisper-medium whole over 1500 stub frames and 448 tokens (its
# published text context); internvl2-26b's backbone cut to 4 of its 48
# layers, 256 stub patches then 768 tokens; qwen3-moe-235b-a22b cut to 1 of
# its 94 layers (bf16 params); xlstm-1.3b whole at 1024 tokens
FAM_TRAIN_BATCH, FAM_TRAIN_STEPS = 4, 4
WH_TRAIN_SEQ, VLM_TRAIN_LAYERS, VLM_TRAIN_TEXT = 448, 4, 768
QWEN3MOE_TRAIN_LAYERS, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_BLOCKS = 1, 1024, 8
VLM_TRAIN_POS = VLM_D["patches"] + VLM_TRAIN_TEXT
# K1's (b, s, h, kv, d, t, window) in those steps (window None: non-causal);
# the encoder's is WHISPER_ENC_ATTN
WHISPER_TRAIN_CROSS = (FAM_TRAIN_BATCH, WH_TRAIN_SEQ, 16, 16, 64, WH_F, None)
WHISPER_TRAIN_SELF = (FAM_TRAIN_BATCH, WH_TRAIN_SEQ, 16, 16, 64, WH_TRAIN_SEQ, 0)
VLM_TRAIN_ATTN = (FAM_TRAIN_BATCH, VLM_TRAIN_POS, VLM_D["h"], VLM_D["kv"], 128,
                  VLM_TRAIN_POS, 0)
QWEN3MOE_TRAIN_ATTN = (FAM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, QWEN3MOE_D["h"],
                       QWEN3MOE_D["kv"], 128, XLSTM_TRAIN_SEQ, 0)
# and K2's x: whisper's decoder, the VLM's, qwen3-moe's (also the xLSTM's
# group norm) and the xLSTM's (also deepseek-moe-16b's training width);
# whisper's encoder's is WHISPER_X
WHISPER_DEC_X = (FAM_TRAIN_BATCH, WH_TRAIN_SEQ, WHISPER_D["d_model"])
VLM_TRAIN_X = (FAM_TRAIN_BATCH, VLM_TRAIN_POS, VLM_D["d_model"])
QWEN3MOE_TRAIN_X = (FAM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, QWEN3MOE_D["d_model"])
XLSTM_TRAIN_X = (FAM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, XLSTM_D["d_model"])
FAMILY_ATTN = {MOE16B_ATTN: "flash_attention_moe16b",
               QWEN3MOE_ATTN: "flash_attention_qwen3moe",
               VLM_ATTN: "flash_attention_vlm",
               WHISPER_ENC_ATTN: "flash_attention_whisper_enc",
               WHISPER_CROSS_ATTN: "flash_attention_whisper_cross",
               WHISPER_SELF_ATTN: "flash_attention_whisper_self",
               MOE16B_TRAIN_ATTN: "flash_attention_moe16b_train",
               WHISPER_TRAIN_CROSS: "flash_attention_whisper_train_cross",
               WHISPER_TRAIN_SELF: "flash_attention_whisper_train_self",
               VLM_TRAIN_ATTN: "flash_attention_vlm_train",
               QWEN3MOE_TRAIN_ATTN: "flash_attention_qwen3moe_train"}
FAMILY_NORM = {MOE16B_X: "rmsnorm_moe16b", QWEN3MOE_X: "rmsnorm_qwen3moe",
               VLM_X: "rmsnorm_vlm", WHISPER_X: "rmsnorm_whisper",
               XLSTM_X: "rmsnorm_xlstm", MOE16B_TRAIN_X: "rmsnorm_moe16b_train",
               WHISPER_DEC_X: "rmsnorm_whisper_dec", VLM_TRAIN_X: "rmsnorm_vlm_train",
               QWEN3MOE_TRAIN_X: "rmsnorm_qwen3moe_train"}
# K1's backward at two small non-causal shapes, S and T both ragged, T != S
RAGGED_NONCAUSAL = [(2, 100, 4, 2, 64, 300, None), (1, 257, 3, 3, 128, 129, None)]
# the keys of the largest bf16 gradient errors at the families' training
# shapes (K1's backward; K2's, whose (4, 1024, 2048) is qwen2.5-3b's)
FAM_GRAD_KEYS = {WHISPER_ENC_ATTN: "flash_attention_backward_whisper_enc",
                 WHISPER_TRAIN_CROSS: "flash_attention_backward_whisper_cross",
                 WHISPER_TRAIN_SELF: "flash_attention_backward_whisper_self",
                 VLM_TRAIN_ATTN: "flash_attention_backward_vlm_train",
                 QWEN3MOE_TRAIN_ATTN: "flash_attention_backward_qwen3moe_train"}
FAM_NORM_GRAD_KEYS = {WHISPER_X: "rmsnorm_backward_whisper_enc",
                      WHISPER_DEC_X: "rmsnorm_backward_whisper_dec",
                      VLM_TRAIN_X: "rmsnorm_backward_vlm_train",
                      QWEN3MOE_TRAIN_X: "rmsnorm_backward_qwen3moe_train"}
# the checkpoint phase: qwen2.5-3b at full width cut to 2 layers
CKPT_LAYERS, CKPT_BATCH, CKPT_STEPS = 2, 2, 4
GRAD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": 2e-2}
# the repo's four shape cells (configs/base.py: PREFILL_32K, DECODE_32K,
# LONG_500K, TRAIN_4K) at one card's share: one data replica of the dry
# run's 16x16 mesh, a batch of global batch / 16 (long_500k's global batch
# of 1 stays 1), the whole model on the card; each serving cell then
# decodes CELL_GEN tokens
CELL_REPLICAS, CELL_GEN = 16, 16
P32K_B, P32K_S, D32K_B, L500K_S, T4K_B, T4K_S, T4K_STEPS = 2, 32768, 8, 524288, 16, 4096, 3
# K1's (b, s, h, kv, d, t, window) on the cells' paths: llama3-8b's
# prefill_32k (t: the cache, 16 decode positions past the prompt),
# recurrentgemma-2b's long_500k, one microbatch of 2 rows of qwen2.5-3b's
# train_4k; and K2's x
P32K_ATTN = (P32K_B, P32K_S, 32, 8, 128, P32K_S + CELL_GEN, 0)
L500K_ATTN = (1, L500K_S, HYB["h"], HYB["kv"], HYB["d"], L500K_S, HYB["window"])
T4K_ATTN = (2, T4K_S, QWEN["h"], QWEN["kv"], QWEN["d"], T4K_S, 0)
P32K_X, L500K_X, T4K_X = (P32K_B, P32K_S, 4096), (1, L500K_S, HYB["d_model"]), (2, T4K_S, 2048)
# xlstm-1.3b's long_500k: the sLSTM kernel's gx, checked against the plain
# loop on the first and the last SLSTM_WINDOW steps (the loop over all
# 524,288 steps would take some 6 M launches)
L500K_GX, SLSTM_WINDOW = (1, L500K_S, 4 * XLSTM_D["d_model"]), 4096
# the prompt of the profiled xlstm-1.3b prefill (1/16 of long_500k's, the
# same blocks and chunk loop)
XLSTM_PROFILE_S = L500K_S // 16
# the int8 KV cache's first decode logits against the bf16 cache's on the
# same rows and tokens (relative L2): about 3x the card's sound reading of
# 0.0276, below the reading with every position's codes read with the
# previous position's scales, a fault that phase_decode_32k plants (0.444
# on an H100; 0.589 at the reduced config, tests/test_torch_long_context.py)
INT8_VS_BF16_LIMIT = 8e-2
# the int8 codes of layer 0 against the bf16 cache's values there, e = code
# - x / scale in units of the scale (``_int8_code_error``): (rms, |bias|)
# limits between the sound quantiser's readings and those of a truncating
# and a flooring round (llama3-8b on an H100: rms 0.315, bias -0.004;
# truncating 0.497, -0.397; flooring 0.498, 0.0003. The reduced config:
# 0.320, under 0.012; 0.467, -0.356; 0.467-0.470, under 0.01, as
# tests/test_torch_long_context.py prints them). A truncating round moves
# the logits' gap only from 0.0172 to 0.0198 at the reduced config, so
# this gate and not the logits' holds the quantiser
INT8_CODE_LIMITS = (0.4, 0.1)
# the simulator: paper Fig. 8's all-reduce sizes (MB = 1e6 bytes) and Fig. 12's
# reported speed-ups over the baseline (Sec. 6.2: Themis, and the Ideal that
# calibrate_compute fits each workload's compute time to)
FIG8_SIZES_MB = (100, 250, 500, 750, 1000)
FIG8_PAPER = {"avg_speedup_fifo": 1.58, "avg_speedup_scf": 1.72, "max_speedup_scf": 2.70}
FIG12_PAPER = {"resnet152": (1.49, 1.54), "gnmt": (1.30, 1.32), "dlrm": (1.30, 1.33),
               "transformer_1t": (1.25, 1.26)}
# the wave kernel's stream: baseline RS of 20 MB in 4096 chunks on
# 3D-SW_SW_SW_hetero, one request every 100 us, each chunk a group of its own
# (baseline visits each dim once per chunk, so the kernel's rank barriers are
# exact); 640 requests is the compiled tier's backlog in BENCH_sched_perf.json
WAVE_TOPOLOGY, WAVE_BYTES, WAVE_CHUNKS, WAVE_PERIOD_S = "3D-SW_SW_SW_hetero", 20e6, 4096, 100e-6
WAVE_REQUESTS = (64, 208, 640)
WAVE_RTOL = 1e-9
# faults, tenancy and traffic: the scenarios of
# benchmarks/{faults,tenancy,traffic}_study.py at their full sizes
MB = 1e6
FAULTS_TOPOLOGY, FAULTS_HORIZON_S = "2D-SW_SW", 2e-3
REPLAN_GATE, SWEEP_FACTORS = 1.15, (0.7, 0.5, 0.25, 0.1)
TENANCY_TOPOLOGIES = ("2D-SW_SW", "3D-SW_SW_SW_homo", "3D-SW_SW_SW_hetero")
TENANCY_POLICIES = ("fifo", "strict-priority", "weighted-fair", "slo-aware")
TENANCY_CHUNKS, PREEMPT_PENALTIES_S = 16, (0.0, 50e-6, 200e-6, 1e-3)
TRAFFIC_ARCH, TRAFFIC_COSTS = "llama3-8b", dict(batch=4, prompt_len=512, tp=8)
LONG_STREAM_SIZES = ((10, 150), (30, 450), (80, 1200), (160, 2400))
# fleet and verify: the scenarios of benchmarks/{fleet,verify}_study.py at
# their full sizes. One serving request's costs (heavy enough that 2D-SW_SW
# saturates at a few hundred requests/s), the knee's loads as multiples of the
# saturation rate, and the study's gates: admission p99 at >= 1.5x within
# P99_GATE of its at-capacity value, goodput within GOODPUT_GATE of the best
FLEET_COSTS = dict(prefill_bytes=512e6, decode_bytes=24e6, prefill_s=1e-3, decode_s=1e-4,
                   prefill_ops=2, gen_tokens=6)
FLEET_TOPOLOGY, FLEET_LOADS = "2D-SW_SW", (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
FLEET_SLO_TOPOLOGIES = ("2D-SW_SW", "3D-SW_SW_SW_homo", "4D-Ring_FC_Ring_SW")
P99_GATE, GOODPUT_GATE = 3.0, 0.9
# the studies' simulated values, as they print them (the reference's run on a
# CPU): phase_fleet holds the port's readings to them digit for digit
FLEET_READINGS = {
    "sat_rate_rps": "368", "capacity": 4, "est_service_s": "2.78e-03",
    "knee_shed": ["0%", "0%", "16%", "27%", "36%", "41%"],
    "knee_admission_p99_s": ["8.24e-03", "1.05e-02"],
    "knee_baseline_p99_max_s": "4.83e-02",
    "differential_shed_groups": [88, 88, 56, 112],
    "slo_violation_rate": [["0.3", "0.0"], ["0.2", "0.0"], ["0.0", "0.0"]]}
# (instance, property) pairs the prover must refute; every other one it proves
VERIFY_EXPECTED_REFUTED = {("wf-rearrival-stale", "bounded_slowdown"),
                           ("fifo-mixed", "bounded_slowdown")}
VERIFY_READINGS = {"n_decided": 24, "n_proved": 22, "n_refuted": 2, "replays": 2}
# the prover's backend: witness evaluation, which decides these instances (the
# systems are functionally determined) and which the study's recorded run used.
# Its "auto" picks z3 where z3 is importable; z3's lowering slackens every
# comparison by 1e-6 s and refutes 15 of the 22 theorems the witnesses prove
# (ROADMAP §3, R7), so phase_verify prints z3's verdicts beside, ungated
VERIFY_BACKEND = "native"
# indexed vs reference on traffic graphs: the reference's own engines sum
# group_wire_bytes (and, under an arbiter, dim_busy / dim_wire_bytes) in
# another order and differ by 1-2 ulp (ROADMAP §3, R6); the port's copies too
TRAFFIC_ENGINE_RTOL = 1e-12
FA_TEST_SHAPES = [(2, 128, 4, 2, 64, 128, 0), (1, 200, 8, 1, 64, 200, 0),
                  (2, 96, 4, 4, 32, 96, 32), (1, 64, 2, 2, 128, 256, 0),
                  (1, 257, 3, 3, 16, 257, 64)]
RN_TEST_SHAPES = [((4, 37, 128), "bfloat16"), ((8, 256), "float32"),
                  ((1, 1, 512), "float32"), ((7, 384), "float32"),
                  ((7, 384), "bfloat16")]
RG_TEST_SHAPES = [(2, 100, 96), (1, 257, 64), (3, 16, 300), (2, 1, 8),
                  (1, 33, 130), (3, 128, 8)]


def emit(**obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: repro_torch not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    from repro_torch.device import nvidia_smi, resolve_device

    # the entry points' allocator setting, before the first allocation
    resolve_device("cuda")
    card = nvidia_smi()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.empty(1, device="cuda")
    expandable = sorted({str(seg.get("is_expandable"))
                         for seg in torch.cuda.memory_snapshot()})
    emit(settings={"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": False,
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "alloc_conf": {k: os.environ.get(k) for k in
                                  ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF")},
                   "segments_expandable": expandable})

    state: dict = {"card": card, "kernels": []}
    failed = []
    phases = (phase_kernels, phase_serve, phase_profile, phase_sharded_serve,
              phase_teacher_forcing, phase_card_vs_cpu, phase_hybrid_serve,
              phase_hybrid_profile, phase_hybrid_sharded_serve,
              phase_hybrid_teacher_forcing, phase_hybrid_card_vs_cpu,
              phase_dense14b_serve, phase_granite_serve,
              phase_moe16b_serve, phase_moe16b_sharded_serve, phase_moe16b_checks,
              phase_qwen3moe_serve, phase_qwen3moe_sharded_serve,
              phase_qwen3moe_checks, phase_vlm_serve, phase_vlm_sharded_serve,
              phase_vlm_checks, phase_whisper_serve, phase_whisper_sharded_serve,
              phase_whisper_checks, phase_xlstm_serve, phase_xlstm_sharded_serve,
              phase_xlstm_checks, phase_moe_train, phase_whisper_train,
              phase_vlm_train, phase_qwen3moe_train, phase_xlstm_train,
              phase_train, phase_train_profile, phase_train_dots,
              phase_train_dots_profile, phase_themis_train, phase_sharded_train,
              phase_train_card_vs_cpu, phase_ckpt_resume, phase_hybrid_train,
              phase_hybrid_train_profile, phase_hybrid_train_dots,
              phase_hybrid_train_dots_profile, phase_hybrid_train_card_vs_cpu,
              phase_prefill_32k, phase_decode_32k, phase_long_500k,
              phase_long_500k_xlstm, phase_train_4k,
              phase_simulator, phase_faults, phase_tenancy, phase_traffic,
              phase_fleet, phase_verify, phase_wave, phase_dryrun, phase_times)
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:  # report the phase, run the rest, then fail
            traceback.print_exc()
            failed.append(phase.__name__)
        torch.cuda.synchronize()
        emit(phase=phase.__name__, seconds=time.perf_counter() - t0,
             ok=phase.__name__ not in failed)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit(kernels=state["kernels"])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _scan_inputs(gen, b, s, c):
    """a in [0, 0.999), b and h0 normal: the distribution of the tests."""
    import torch

    a = torch.rand((b, s, c), generator=gen, device="cuda") * 0.999
    return a, _randn(gen, (b, s, c), torch.float32), _randn(gen, (b, c),
                                                            torch.float32)


def _dtype(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check(name, got, want, tol, errs):
    import torch

    err = _max_err(got, want)
    errs.append(err)
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs err {err} beyond {tol}")
    return err


# -- phase 2 ---------------------------------------------------------------------
def phase_kernels(state):
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rmsnorm as rn

    sources = ["flash_attention_sm90", "flash_attention", "flash_attention_bwd_sm90",
               "flash_attention_bwd", "rglru_scan", "slstm_scan"]
    t0 = time.perf_counter()
    libs = _build.build(sources)
    build_s = time.perf_counter() - t0
    emit(build={f"{name}.cu": {
        "nvcc_seconds_all": build_s,
        "ptxas": [ln.split("ptxas info    : ")[-1]
                  for ln in _build.build_log(name).splitlines()
                  if "Used" in ln or "spill" in ln or "C7508" in ln],
        "sass_counts": _sass_counts(libs[name])}
        for name in sources})

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the shapes added with the qwen2.5-14b and granite-34b prefills draw
    # from a generator of their own, so every earlier check (and
    # _grad_checks) keeps the inputs it had
    new_gen = torch.Generator(device="cuda").manual_seed(19)
    new_shapes = (QWEN14B_ATTN, GRANITE_ATTN, (BATCH, PROMPT, QWEN14B["d_model"]),
                  (BATCH, PROMPT, GRANITE_D["d_model"]))
    checks = []
    serving_errs = {k: [] for k in ("flash_attention", "rmsnorm", "rglru_scan",
                                    "flash_attention_hybrid", "rmsnorm_hybrid",
                                    "flash_attention_train", "rmsnorm_train",
                                    "flash_attention_hybrid_train",
                                    "rmsnorm_hybrid_train", "rglru_scan_hybrid_train",
                                    "rglru_scan_backward", "flash_attention_qwen14b",
                                    "rmsnorm_qwen14b", "flash_attention_granite",
                                    "rmsnorm_granite")}
    hyb = (BATCH, HYB_PROMPT, HYB["h"], HYB["kv"], HYB["d"], HYB_PROMPT,
           HYB["window"])
    train = (TRAIN_BATCH, TRAIN_SEQ, QWEN["h"], QWEN["kv"], QWEN["d"], TRAIN_SEQ, 0)
    seq = FA_TEST_SHAPES + [(BATCH, PROMPT, 32, 8, 128, PROMPT, 0),
                            (BATCH, PROMPT, 32, 8, 128, PROMPT + GEN, 0),
                            (2, 130, 4, 2, 16, 130, None),
                            (2, 200, 8, 2, 64, 300, None),
                            (1, 300, 4, 1, 128, 130, None),
                            (1, 130, 2, 1, 256, 200, None),
                            (2, 300, 10, 1, 256, 300, 128), hyb, train, HYB_TRAIN_ATTN,
                            QWEN14B_ATTN, GRANITE_ATTN]
    serving_shapes = {hyb: "flash_attention_hybrid", train: "flash_attention_train",
                      HYB_TRAIN_ATTN: "flash_attention_hybrid_train",
                      QWEN14B_ATTN: "flash_attention_qwen14b",
                      GRANITE_ATTN: "flash_attention_granite"}
    for shape in seq:
        g = new_gen if shape in new_shapes else gen
        for dn in ("float32", "bfloat16"):
            errs = []
            if dn == "bfloat16" and shape[:3] == (BATCH, PROMPT, 32):
                errs = serving_errs["flash_attention"]
            elif dn == "bfloat16" and shape in serving_shapes:
                errs = serving_errs[serving_shapes[shape]]
            checks.append(_flash_check(g, shape, dn, errs))
    # the sm90 kernel reads views through their strides: q from a packed QKV
    # projection, k and v from a packed cache longer than T (llama3-8b shape)
    b, s, h, kv, d, t = BATCH, PROMPT, 32, 8, 128, PROMPT + GEN
    qkv = _randn(gen, (b, s, h + 2 * kv, d), torch.bfloat16)
    cache = _randn(gen, (b, t + 64, 2, kv, d), torch.bfloat16)
    q, k, v = qkv[:, :, :h], cache[:, :t, 0], cache[:, :t, 1]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    out, lse = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=True)
    name = f"flash_attention{(b, s, h, kv, d, t, 0)} bfloat16 strided views"
    checks.append({"kernel": "flash_attention", "route": fa.route(q.dtype, d),
                   "shape": [b, s, h, kv, d, t], "window": 0, "causal": True,
                   "dtype": "bfloat16", "layout": "strided views",
                   "max_abs_err": _check(name, out, p_out, TOL["bfloat16"], []),
                   "lse_max_abs_err": _check(name + " lse", lse, p_lse,
                                             TOL["float32"], []),
                   "tol": TOL["bfloat16"]})
    del qkv, cache, q, k, v, out, lse, p_out, p_lse
    t1 = time.perf_counter()
    first = True
    for shape, dn in RN_TEST_SHAPES + [((BATCH, PROMPT, 4096), "bfloat16"),
                                       ((BATCH, 1, 4096), "bfloat16"),
                                       ((BATCH, PROMPT, 4096), "float32"),
                                       ((BATCH, HYB_PROMPT, 2560), "bfloat16"),
                                       ((BATCH, 1, 2560), "bfloat16"),
                                       ((TRAIN_BATCH, TRAIN_SEQ, 2048), "bfloat16"),
                                       (HYB_TRAIN_X, "bfloat16"),
                                       ((BATCH, PROMPT, QWEN14B["d_model"]), "bfloat16"),
                                       ((BATCH, PROMPT, GRANITE_D["d_model"]), "bfloat16")]:
        dt = _dtype(dn)
        serving = shape[-1] in (4096, 2560, 2048, 5120, 6144)
        g = new_gen if shape in new_shapes else gen
        x = _randn(g, shape, dt)
        w = _randn(g, shape[-1:], dt if serving else torch.float32)
        y = rn.rmsnorm(x, w, 1e-6)
        torch.cuda.synchronize()
        if first:
            emit(build={"rmsnorm (triton jit)": {"first_call_seconds":
                                                 time.perf_counter() - t1}})
            first = False
        errs = []
        if shape == HYB_TRAIN_X:
            errs = serving_errs["rmsnorm_hybrid_train"]
        elif serving and dn == "bfloat16":
            errs = serving_errs[{4096: "rmsnorm", 2560: "rmsnorm_hybrid",
                                 2048: "rmsnorm_train", 5120: "rmsnorm_qwen14b",
                                 6144: "rmsnorm_granite"}[shape[-1]]]
        e = _check(f"rmsnorm{shape} {dn}", y, rn.rmsnorm_plain(x, w, 1e-6),
                   TOL[dn], errs)
        checks.append({"kernel": "rmsnorm", "shape": list(shape), "dtype": dn,
                       "max_abs_err": e, "tol": TOL[dn]})
    for b, s, c in RG_TEST_SHAPES + [(BATCH, HYB_PROMPT, HYB["d_model"]), HYB_TRAIN_X]:
        a, bb, h0 = _scan_inputs(gen, b, s, c)
        g = _randn(gen, (b, s, c), torch.float32)
        for init in (h0, None):
            out = rg.rglru_scan(a, bb, init)
            torch.cuda.synchronize()
            errs = []
            if (b, s, c) == HYB_TRAIN_X:
                errs = serving_errs["rglru_scan_hybrid_train"]
            elif s == HYB_PROMPT:
                errs = serving_errs["rglru_scan"]
            name = f"rglru_scan{(b, s, c)} h0={init is not None}"
            e = _check(name, out, rg.rglru_scan_plain(a, bb, init), SCAN_TOL, errs)
            # the kernel runs the blocked order: equal to its mirror and to
            # a second call, to the bit
            mirror = torch.equal(out, rg.rglru_scan_blocked_plain(a, bb, init))
            again = torch.equal(out, rg.rglru_scan(a, bb, init))
            checks.append({"kernel": "rglru_scan", "shape": [b, s, c],
                           "h0": init is not None, "dtype": "float32",
                           "max_abs_err": e, "tol": SCAN_TOL,
                           "equal_to_blocked_mirror": mirror,
                           "equal_across_calls": again})
            assert mirror and again, (name, mirror, again)
            # K3's backward on the forward's h, against its plain version
            got = rg.rglru_scan_backward(a, out, g, init)
            torch.cuda.synchronize()
            want = rg.rglru_scan_backward_plain(a, out, g, init)
            errs = serving_errs["rglru_scan_backward"] if (b, s, c) == HYB_TRAIN_X else []
            e = [_check(f"{name} backward {n}", x, y, SCAN_TOL, errs)
                 for n, x, y in zip(("da", "db", "dh0"), got, want) if y is not None]

            def equal(xs, ys):
                return all(torch.equal(x, y) for x, y in zip(xs, ys) if y is not None)

            mirror = equal(got, rg.rglru_scan_backward_blocked_plain(a, out, g, init))
            again = equal(got, rg.rglru_scan_backward(a, out, g, init))
            checks.append({"kernel": "rglru_scan_backward", "shape": [b, s, c],
                           "h0": init is not None, "dtype": "float32",
                           "max_abs_err": max(e), "tol": SCAN_TOL,
                           "equal_to_plain": equal(got, want),
                           "equal_to_blocked_mirror": mirror,
                           "equal_across_calls": again})
            assert mirror and again, (f"{name} backward", mirror, again)
            del got, want
        del a, bb, h0, g, out
    # the shapes of the MoE, VLM, audio and SSM paths draw from a generator
    # of their own, so every check above keeps its inputs
    fam_gen = torch.Generator(device="cuda").manual_seed(23)
    for shape, key in FAMILY_ATTN.items():
        for dn in ("float32", "bfloat16"):
            errs = serving_errs.setdefault(key, []) if dn == "bfloat16" else []
            checks.append(_flash_check(fam_gen, shape, dn, errs))
    for shape, key in FAMILY_NORM.items():
        for dn in ("float32", "bfloat16"):
            dt = _dtype(dn)
            x, w = _randn(fam_gen, shape, dt), _randn(fam_gen, shape[-1:], dt)
            y = rn.rmsnorm(x, w, 1e-6)
            torch.cuda.synchronize()
            errs = serving_errs.setdefault(key, []) if dn == "bfloat16" else []
            e = _check(f"rmsnorm{shape} {dn}", y, rn.rmsnorm_plain(x, w, 1e-6),
                       TOL[dn], errs)
            checks.append({"kernel": "rmsnorm", "shape": list(shape), "dtype": dn,
                           "max_abs_err": e, "tol": TOL[dn]})
            del x, w, y
    emit(kernel_checks=checks)
    state["serving_err"] = {k: max(v) for k, v in serving_errs.items()}
    torch.cuda.empty_cache()
    state["grad_err"] = _grad_checks(gen)
    torch.cuda.empty_cache()
    _cell_checks(state)
    torch.cuda.empty_cache()
    _slstm_checks(state)
    torch.cuda.empty_cache()


def _attention_rows(q, k, v, r0, r1, window):
    """K1's plain arithmetic (fp32 copies of the inputs, fp32 scores,
    ``-1e30`` masks, as ``flash_attention_plain``) for the query rows r0 ..
    r1-1 of a causal call with ``window`` (0: none), over only the keys
    those rows see: (out (B, r1-r0, H, d) fp32, LSE (B, H, r1-r0)). The
    shape cells' whole score matrices do not fit the card (prefill_32k's
    is 275 GB in fp32)."""
    from repro_torch.models.common import _flash_fwd_impl

    k0 = max(0, r0 - window + 1) if window else 0
    q, k, v = (x.float() for x in (q[:, r0:r1], k[:, k0:r1], v[:, k0:r1]))
    return _flash_fwd_impl(q, k, v, r0 - k0, True, window, r1 - r0, r1 - k0)


def _cell_checks(state):
    """The kernels at the shape cells' shapes, against their plain versions
    at the tolerances above, from a generator of their own (every earlier
    check keeps its inputs). K1 at prefill_32k's causal q (2, 32768, 32,
    128) over 32,784 keys (the cache) and over 32,768, and at long_500k's
    q (1, 524288, 10, 256) with window 2048: every head of the first query
    tile of 128 rows, a middle one (at long_500k the two either side of
    2,048, the window's edge) and the last, which reads every key tile the
    mask leaves, against ``_attention_rows``, out and LSE; each launch on
    the sm90 route. K1 and K1's backward at train_4k's microbatch, q (2,
    4096, 16, 128) on 2 kv heads, in bf16 as ``_grad_checks`` holds them.
    K3 at (1, 524288, 2560) from h0 = 0, as long_500k's prefill runs it,
    equal to ``rglru_scan_blocked_plain`` and to a second call to the bit
    (the sequential loop would take a million launches). K2 at the cells'
    widths and decode_32k's (8, 1, 4096); its backward at train_4k's."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(47)
    bf, errs, checks = torch.bfloat16, state["serving_err"], []
    p32k_tiles = (0, P32K_S // 2, P32K_S - 128)
    window = HYB["window"]
    for key, shape, tiles in (
            ("flash_attention_prefill_32k", P32K_ATTN, p32k_tiles),
            ("flash_attention_prefill_32k", P32K_ATTN[:5] + (P32K_S, 0), p32k_tiles),
            ("flash_attention_long_500k", L500K_ATTN,
             (0, window - 128, window, L500K_S - 128))):
        b, s, h, kv, d, t, win = shape
        q = _randn(gen, (b, s, h, d), bf)
        k, v = _randn(gen, (b, t, kv, d), bf), _randn(gen, (b, t, kv, d), bf)
        before = launch_counts()["flash_attention_sm90"]
        out, lse = fa.flash_attention(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        sm90 = launch_counts()["flash_attention_sm90"] - before
        rows = []
        for r0 in tiles:
            p_out, p_lse = _attention_rows(q, k, v, r0, r0 + 128, win)
            name = f"flash_attention{shape} bfloat16 rows {r0}-{r0 + 128}"
            rows.append({"rows": [r0, r0 + 128],
                         "max_abs_err": _check(name, out[:, r0:r0 + 128], p_out,
                                               TOL["bfloat16"], errs.setdefault(key, [])),
                         "lse_max_abs_err": _check(name + " lse", lse[:, :, r0:r0 + 128],
                                                   p_lse, TOL["float32"], [])})
            del p_out, p_lse
        checks.append({"kernel": "flash_attention", "route": fa.route(bf, d),
                       "sm90_launches": sm90, "shape": [b, s, h, kv, d, t],
                       "window": win, "causal": True, "dtype": "bfloat16",
                       "vs": "_attention_rows on fp32 copies", "tiles": rows,
                       "tol": TOL["bfloat16"], "lse_tol": TOL["float32"]})
        assert sm90 == 1, f"flash_attention{shape}: {sm90} sm90 launches"
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    checks.append(_flash_check(gen, T4K_ATTN, "bfloat16",
                               errs.setdefault("flash_attention_train_4k", [])))
    check, state["grad_err"]["flash_attention_backward_train_4k"] = _flash_grad_check(
        gen, T4K_ATTN, "bfloat16")
    checks.append(check)
    assert check["backward_route"] == "sm90", check["backward_route"]
    a, bb, _ = _scan_inputs(gen, *L500K_X)
    h0 = torch.zeros((1, L500K_X[2]), device="cuda")
    out = rg.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    mirror = rg.rglru_scan_blocked_plain(a, bb, h0)
    equal, again = torch.equal(out, mirror), torch.equal(out, rg.rglru_scan(a, bb, h0))
    errs["rglru_scan_long_500k"] = [_max_err(out, mirror)]
    checks.append({"kernel": "rglru_scan", "shape": list(L500K_X), "h0": "zeros",
                   "dtype": "float32", "equal_to_blocked_mirror": equal,
                   "equal_across_calls": again})
    assert equal and again, ("rglru_scan long_500k", equal, again)
    del a, bb, h0, out, mirror
    for shape, key in ((P32K_X, "rmsnorm_prefill_32k"), ((D32K_B, 1, 4096), "rmsnorm_decode_32k"),
                       (L500K_X, "rmsnorm_long_500k"), (T4K_X, "rmsnorm_train_4k")):
        x, w = _randn(gen, shape, bf), _randn(gen, shape[-1:], bf)
        y = rn.rmsnorm(x, w, 1e-6)
        torch.cuda.synchronize()
        e = _check(f"rmsnorm{shape} bfloat16", y, rn.rmsnorm_plain(x, w, 1e-6),
                   TOL["bfloat16"], errs.setdefault(key, []))
        checks.append({"kernel": "rmsnorm", "shape": list(shape), "dtype": "bfloat16",
                       "max_abs_err": e, "tol": TOL["bfloat16"]})
        del x, w, y
    check, state["grad_err"]["rmsnorm_backward_train_4k"] = _rmsnorm_grad_check(
        gen, T4K_X, "bfloat16")
    checks.append(check)
    emit(cell_kernel_checks=checks)
    for key in ("flash_attention_prefill_32k", "flash_attention_long_500k",
                "flash_attention_train_4k", "rglru_scan_long_500k", "rmsnorm_prefill_32k",
                "rmsnorm_decode_32k", "rmsnorm_long_500k", "rmsnorm_train_4k"):
        errs[key] = max(errs[key])


def _slstm_inputs(gen, b, s, dt, with_state):
    """xlstm-1.3b's sLSTM inputs: gx (b, s, 8192) normal in ``dt``, r_gates
    (4, 512, 2048) at the init's scale (fan-in 512) in ``dt``, and h0 (b, 2048)
    in (-1, 1) in ``dt`` and c0 (b, 2048) normal in fp32, or None."""
    import torch

    d, nh = XLSTM_D["d_model"], SLSTM_HEADS
    dh = d // nh
    gx = _randn(gen, (b, s, 4 * d), dt)
    r = (torch.randn((nh, dh, 4 * dh), generator=gen, device="cuda") / math.sqrt(dh)).to(dt)
    if not with_state:
        return gx, r, None, None
    h0 = torch.tanh(torch.randn((b, d), generator=gen, device="cuda")).to(dt)
    return gx, r, h0, torch.randn((b, d), generator=gen, device="cuda")


def _rel_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def _slstm_gate(name, got, want, dn):
    """The kernel's (h, last h, last c) against the plain loop's: fp32 max
    abs within 1e-5; bf16 relative L2 of h and of the last c within 2e-2.
    Returns the readings; raises beyond the gate."""
    tol = SLSTM_TOL[dn]
    r = {"h_max_abs_err": _max_err(got[0], want[0]),
         "h_last_max_abs_err": _max_err(got[1], want[1]),
         "c_last_max_abs_err": _max_err(got[2], want[2]),
         "h_rel_l2": _rel_l2(got[0], want[0]), "c_last_rel_l2": _rel_l2(got[2], want[2])}
    keys = (("h_max_abs_err", "h_last_max_abs_err", "c_last_max_abs_err")
            if dn == "float32" else ("h_rel_l2", "c_last_rel_l2"))
    if max(r[k] for k in keys) > tol:
        raise AssertionError(f"{name}: {r} beyond {tol} on {keys}")
    return r


def _slstm_checks(state):
    """The sLSTM kernel against ``slstm_scan_plain`` at xlstm-1.3b's shapes,
    from a generator of its own (every earlier check keeps its inputs):
    serving's gx (4, 2048, 8192) and the decode step's S = 1, in bf16 and
    fp32, from zeros and from a state, each also equal to a second call to
    the bit; long_500k's (1, 524288, 8192) in both dtypes on windows (the
    first SLSTM_WINDOW steps from zeros; the last from the kernel's own state
    at step 524,288 - SLSTM_WINDOW, which a run of the kernel over the steps
    before gives), and the kernel over all steps equal to the bit to the
    same two pieces run one after the other."""
    import torch

    from repro_torch.kernels import slstm as sl

    gen = torch.Generator(device="cuda").manual_seed(59)
    checks, errs = [], state["serving_err"]
    for dn in ("bfloat16", "float32"):
        for with_state in (False, True):
            for s in (XLSTM_GX[1], 1):
                inputs = _slstm_inputs(gen, BATCH, s, _dtype(dn), with_state)
                got = sl.slstm_scan(*inputs)
                torch.cuda.synchronize()
                name = f"slstm_scan{(BATCH, s, XLSTM_GX[2])} {dn} state={with_state}"
                r = _slstm_gate(name, got, sl.slstm_scan_plain(*inputs), dn)
                again = all(torch.equal(a, b) for a, b in zip(got, sl.slstm_scan(*inputs)))
                checks.append({"kernel": "slstm_scan", "shape": [BATCH, s, XLSTM_GX[2]],
                               "state": with_state, "dtype": dn, **r,
                               "tol": SLSTM_TOL[dn], "equal_across_calls": again})
                if dn == "bfloat16" and s > 1:
                    errs.setdefault("slstm_scan_xlstm", []).append(r["h_max_abs_err"])
                assert again, (name, "second call differs")
                del inputs, got
    cut = L500K_S - SLSTM_WINDOW
    for dn in ("bfloat16", "float32"):
        gx, r, _, _ = _slstm_inputs(gen, 1, L500K_S, _dtype(dn), False)
        whole = sl.slstm_scan(gx, r)
        head = sl.slstm_scan(gx[:, :SLSTM_WINDOW], r)
        first = sl.slstm_scan(gx[:, :cut], r)
        tail = sl.slstm_scan(gx[:, cut:], r, first[1], first[2])
        torch.cuda.synchronize()
        pieces = (torch.equal(whole[0][:, :cut], first[0])
                  and torch.equal(whole[0][:, cut:], tail[0])
                  and torch.equal(whole[1], tail[1]) and torch.equal(whole[2], tail[2])
                  and torch.equal(head[0], whole[0][:, :SLSTM_WINDOW]))
        h_cut, c_cut = first[1], first[2]
        del first
        name = f"slstm_scan{L500K_GX} {dn}"
        first_w = _slstm_gate(name + " first window", head,
                              sl.slstm_scan_plain(gx[:, :SLSTM_WINDOW], r), dn)
        last_w = _slstm_gate(name + " last window", tail,
                             sl.slstm_scan_plain(gx[:, cut:], r, h_cut, c_cut), dn)
        checks.append({"kernel": "slstm_scan", "shape": list(L500K_GX), "dtype": dn,
                       "h0": "zeros", "window": SLSTM_WINDOW, "first_window": first_w,
                       "last_window": {"from_step": cut, **last_w},
                       "tol": SLSTM_TOL[dn], "pieces_equal_to_whole": pieces})
        if dn == "bfloat16":
            errs["slstm_scan_long_500k"] = max(first_w["h_max_abs_err"],
                                               last_w["h_max_abs_err"])
        assert pieces, (name, "the kernel in two pieces differs from one run")
        del gx, r, whole, head, tail, h_cut, c_cut
        torch.cuda.empty_cache()
    emit(slstm_checks=checks)
    errs["slstm_scan_xlstm"] = max(errs["slstm_scan_xlstm"])


def _flash_check(gen, shape, dn, errs):
    """K1 at ``shape`` = (b, s, h, kv, d, t, window) in ``dn`` against its
    plain version (window None: non-causal); out within TOL[dn], the LSE
    within TOL["float32"]; the out error also goes into ``errs``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    b, s, h, kv, d, t, win = shape
    causal = win is not None
    dt = _dtype(dn)
    q = _randn(gen, (b, s, h, d), dt)
    k, v = _randn(gen, (b, t, kv, d), dt), _randn(gen, (b, t, kv, d), dt)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=win or 0)
    torch.cuda.synchronize()
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=causal, window=win or 0)
    name = f"flash_attention{shape} {dn}"
    e = _check(name, out, p_out, TOL[dn], errs)
    el = _check(name + " lse", lse, p_lse, TOL["float32"], [])
    return {"kernel": "flash_attention", "route": fa.route(dt, d),
            "shape": [b, s, h, kv, d, t], "window": win, "causal": causal,
            "dtype": dn, "max_abs_err": e, "lse_max_abs_err": el, "tol": TOL[dn]}


def _grad_close(name, got, want, dn, errs):
    """fp32: elementwise within 1e-5 abs / 1e-4 rel; bf16: max abs error
    within 2e-2 of max(1, the gradient's largest magnitude)."""
    import torch

    err = _max_err(got, want)
    scale = want.float().abs().max().item()
    errs.append({"grad": name, "max_abs_err": err, "max_abs": scale})
    if dn == "float32":
        atol, rtol = GRAD_TOL[dn]
        ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
        tol = f"{atol} abs / {rtol} rel"
    else:
        tol = GRAD_TOL[dn] * max(1.0, scale)
        ok = err <= tol
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} beyond {tol}")


def _flash_grad_check(gen, shape, dn):
    """K1's gradients through ``ops.flash_attention`` at ``shape`` (b, s, h,
    kv, d, t, window) in ``dn`` (window None: non-causal, as
    ``_flash_check``; else causal): against autograd through the plain
    version, against ``flash_attention_bwd`` fed with the kernel's out and
    LSE, and in bf16 against autograd through the plain version on fp32
    copies. Returns the check's line and its largest error against the
    first two."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.common import flash_attention_bwd

    b, s, h, kv, d, t, win = shape
    causal, w = win is not None, win or 0
    dt = _dtype(dn)
    q = _randn(gen, (b, s, h, d), dt).requires_grad_(True)
    k = _randn(gen, (b, t, kv, d), dt).requires_grad_(True)
    v = _randn(gen, (b, t, kv, d), dt).requires_grad_(True)
    dout = _randn(gen, (b, s, h, d), dt)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal, w),
                              (q, k, v), dout)
    p_out, _ = fa.flash_attention_plain(q, k, v, causal=causal, window=w)
    want = torch.autograd.grad(p_out, (q, k, v), dout)
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=w)
        plain = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                    window=w)
    readings = fp32_errs = None
    if dn == "bfloat16":
        # the gate against fp32: the kernel's gradients against
        # autograd through the plain version on fp32 copies of the
        # same inputs; beside it, how far each bf16 gradient lies
        # from that reference (the plain bf16 backward carries most
        # of the error of the two bf16 gates below)
        q32, k32, v32 = (x.detach().float().requires_grad_(True)
                         for x in (q, k, v))
        ref = torch.autograd.grad(fa.flash_attention_plain(
            q32, k32, v32, causal=causal, window=w)[0], (q32, k32, v32),
            dout.float())
        readings = {label: {n: _max_err(a, r) for n, a, r in
                            zip(("dq", "dk", "dv"), grads, ref)}
                    for label, grads in (("kernel", got), ("autograd_plain", want),
                                         ("flash_attention_bwd", plain))}
        fp32_errs = []
        for n, a, r in zip(("dq", "dk", "dv"), got, ref):
            _grad_close(f"flash_attention{(b, s, h, kv, d, t, win)} {dn} {n} "
                        "vs fp32 autograd", a, r, dn, fp32_errs)
        del q32, k32, v32, ref
    torch.cuda.synchronize()
    errs, plain_errs = [], []
    for n, a, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        name = f"flash_attention{(b, s, h, kv, d, t, win)} {dn} {n}"
        _grad_close(name, a, w, dn, errs)
        _grad_close(name + " vs flash_attention_bwd", a, pl, dn, plain_errs)
    worst = max(e["max_abs_err"] for e in errs + plain_errs)
    check = {"kernel": "flash_attention", "route": fa.route(dt, d),
             "backward_route": fa.bwd_route(dt, d),
             "shape": [b, s, h, kv, d, t], "window": win, "causal": causal,
             "dtype": dn, "grads": errs,
             "vs_plain_backward": plain_errs, "tol": GRAD_TOL[dn],
             "vs_fp32_autograd": fp32_errs,
             "bf16_max_abs_err_vs_fp32_autograd": readings}
    del q, k, v, dout, got, p_out, want, out, lse, plain
    torch.cuda.empty_cache()
    return check, worst


def _grad_checks(gen):
    """K1's and K2's gradients on the card: each autograd path that the
    training step runs (``ops.flash_attention``, ``ops.rmsnorm``, whose
    backwards launch the backward kernels) against PyTorch's autograd
    through the kernel's plain version, and against the plain backward
    (``flash_attention_bwd`` fed with the kernel's out and LSE;
    ``rmsnorm_backward``) on the same inputs, with one random cotangent.
    Returns the largest bf16 error at the training shapes, by kernel."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.common import flash_attention_bwd

    checks = []
    worst = {"flash_attention_backward": 0.0, "rmsnorm_backward": 0.0,
             "flash_attention_backward_hybrid": 0.0, "rmsnorm_backward_hybrid": 0.0,
             "flash_attention_backward_moe16b_train": 0.0}
    train = (TRAIN_BATCH, TRAIN_SEQ, QWEN["h"], QWEN["kv"], QWEN["d"], TRAIN_SEQ,
             0)
    train_window = (2, TRAIN_SEQ, QWEN["h"], QWEN["kv"], QWEN["d"], TRAIN_SEQ, 300)
    # head dim 256: windowed, ragged (S not a multiple of 64), the hybrid's
    # training shape with its window of 2048
    d256 = [(2, 256, 4, 1, 256, 256, 64), (2, 300, 10, 1, 256, 300, 128), HYB_TRAIN_ATTN]
    shapes = (FA_TEST_SHAPES + [(b, s, h, kv, d, t, 16)
                                for b, s, h, kv, d, t, _ in FA_TEST_SHAPES]
              + [train, train_window] + d256)
    for shape in shapes:
        for dn in ("float32", "bfloat16"):
            check, err = _flash_grad_check(gen, shape, dn)
            key = {train: "flash_attention_backward",
                   HYB_TRAIN_ATTN: "flash_attention_backward_hybrid"}.get(shape)
            if dn == "bfloat16" and key:
                worst[key] = err
            checks.append(check)
    # deepseek-moe-16b's training shape (MHA), from a generator of its own so
    # every check here keeps its inputs
    moe_gen = torch.Generator(device="cuda").manual_seed(31)
    for dn in ("float32", "bfloat16"):
        check, err = _flash_grad_check(moe_gen, MOE16B_TRAIN_ATTN, dn)
        if dn == "bfloat16":
            worst["flash_attention_backward_moe16b_train"] = err
        checks.append(check)
    # the four families' training shapes: whisper's non-causal encoder (a
    # ragged T of 1500) and cross-attention (S 448, T 1500) and its causal
    # decoder; internvl2-26b's group of 6 and qwen3-moe's of 16; then two
    # small non-causal shapes with S and T ragged and T != S. A generator of
    # their own, so every check above keeps its inputs
    fam_gen = torch.Generator(device="cuda").manual_seed(41)
    for shape in list(FAM_GRAD_KEYS) + RAGGED_NONCAUSAL:
        for dn in ("float32", "bfloat16"):
            check, err = _flash_grad_check(fam_gen, shape, dn)
            if dn == "bfloat16" and shape in FAM_GRAD_KEYS:
                worst[FAM_GRAD_KEYS[shape]] = err
            checks.append(check)
    # the sm90 backward at d 256 gives the same bits from run to run
    b, s, h, kv, d, t, win = HYB_TRAIN_ATTN
    bf = torch.bfloat16
    q, k, v = (_randn(gen, (b, s, n, d), bf) for n in (h, kv, kv))
    dout = _randn(gen, (b, s, h, d), bf)
    out, lse = fa.flash_attention(q, k, v, causal=True, window=win)
    runs = [fa.flash_attention_backward(q, k, v, out, lse, dout, causal=True, window=win)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(*runs)]
    checks.append({"kernel": "flash_attention", "backward_route": fa.bwd_route(bf, d),
                   "shape": [b, s, h, kv, d, t], "window": win, "dtype": "bfloat16",
                   "two_calls_equal_to_the_bit": dict(zip(("dq", "dk", "dv"), same))})
    assert fa.bwd_route(bf, d) == "sm90" and all(same), (
        f"sm90 d-256 backward differs between two calls: {same}")
    del q, k, v, dout, out, lse, runs
    # the sm90 backward reads q, k and v through their strides: views of one
    # packed projection, with a cotangent that is not contiguous
    b, s, h, kv, d = 2, 256, 8, 2, 128
    qkv = _randn(gen, (b, s, h + 2 * kv, d), torch.bfloat16).requires_grad_(True)
    dout = _randn(gen, (b, h, s, d), torch.bfloat16).transpose(1, 2)

    def split(x):
        return x[:, :, :h], x[:, :, h:h + kv], x[:, :, h + kv:]

    got = torch.autograd.grad(ops.flash_attention(*split(qkv), True, 0), qkv, dout)[0]
    want = torch.autograd.grad(fa.flash_attention_plain(*split(qkv), causal=True)[0],
                               qkv, dout)[0]
    errs = []
    _grad_close(f"flash_attention{(b, s, h, kv, d, s, 0)} bfloat16 views dqkv", got,
                want, "bfloat16", errs)
    checks.append({"kernel": "flash_attention", "route": fa.route(qkv.dtype, d),
                   "backward_route": fa.bwd_route(qkv.dtype, d),
                   "shape": [b, s, h, kv, d, s], "window": 0, "dtype": "bfloat16",
                   "layout": "q, k, v views of one packed tensor; strided cotangent",
                   "grads": errs, "tol": GRAD_TOL["bfloat16"]})
    del qkv, dout, got, want
    # the families' training widths come last, so every check before keeps
    # its inputs
    for shape, dn in RN_TEST_SHAPES + [((TRAIN_BATCH, TRAIN_SEQ, 2048), "bfloat16"),
                                       ((TRAIN_BATCH, TRAIN_SEQ, 2048), "float32"),
                                       (HYB_TRAIN_X, "bfloat16")] + [
            (x, dn) for x in FAM_NORM_GRAD_KEYS for dn in ("bfloat16", "float32")]:
        check, err = _rmsnorm_grad_check(gen, shape, dn)
        key = {(TRAIN_BATCH, TRAIN_SEQ, 2048): "rmsnorm_backward",
               HYB_TRAIN_X: "rmsnorm_backward_hybrid", **FAM_NORM_GRAD_KEYS}.get(shape)
        if dn == "bfloat16" and key:
            worst[key] = err
        checks.append(check)
    emit(grad_checks=checks)
    return worst


def _rmsnorm_grad_check(gen, shape, dn):
    """K2's gradients through ``ops.rmsnorm`` (its backward kernels) at x
    ``shape`` in ``dn``: against autograd through ``rmsnorm_plain`` and
    against ``rmsnorm_backward`` on the same inputs, in fp32 also against
    both on fp64 copies. Returns the check's line and its largest error."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    dt = _dtype(dn)
    x = _randn(gen, shape, dt).requires_grad_(True)
    w = _randn(gen, shape[-1:], dt).requires_grad_(True)
    dy = _randn(gen, shape, dt)
    got = torch.autograd.grad(ops.rmsnorm(x, w, 1e-6), (x, w), dy)
    want = torch.autograd.grad(rn.rmsnorm_plain(x, w, 1e-6), (x, w), dy)
    plain = rn.rmsnorm_backward(x.detach(), w.detach(), dy, 1e-6)
    refs = {"": want, " vs rmsnorm_backward": plain}
    fp32_readings = None
    if dn == "float32":
        # the kernel sums dw in fp64 and rounds once, where the fp32
        # versions sum 4,096 rows in fp32: fp32 also holds the kernel to
        # both versions on fp64 copies of the inputs (they then compute
        # in fp64), and reports the fp32 versions' distances to those
        want64, plain64 = _rmsnorm_grads_fp64(x, w, dy)
        refs.update({" vs fp64 autograd": want64,
                     " vs fp64 rmsnorm_backward": plain64})
        fp32_readings = {"autograd32_vs_fp64": _rmsnorm_readings(want, want64),
                         "plain32_vs_fp64": _rmsnorm_readings(plain, plain64)}
    torch.cuda.synchronize()
    errs = {label: [] for label in refs}
    for label, ref in refs.items():
        for n, a, r in zip(("dx", "dw"), got, ref):
            _grad_close(f"rmsnorm{shape} {dn} {n}{label}", a, r, dn, errs[label])
    worst = max(e["max_abs_err"] for v in errs.values() for e in v)
    return {"kernel": "rmsnorm", "route": "triton",
            "backward_route": "triton", "shape": list(shape), "dtype": dn,
            "grads": errs[""], "vs_plain_backward": errs[" vs rmsnorm_backward"],
            "vs_fp64": (errs[" vs fp64 autograd"]
                        + errs[" vs fp64 rmsnorm_backward"]
                        if fp32_readings else None),
            "fp32_readings": fp32_readings, "tol": GRAD_TOL[dn]}, worst


def _rmsnorm_grads_fp64(x, w, dy):
    """((dx, dw) of autograd through ``rmsnorm_plain``, and the result of
    ``rmsnorm_backward``) on fp64 copies of the inputs, cast to the inputs'
    dtypes."""
    import torch

    from repro_torch.kernels import rmsnorm as rn

    xd, wd, gd = (t.detach().double() for t in (x, w, dy))
    xd.requires_grad_(True)
    wd.requires_grad_(True)
    auto = torch.autograd.grad(rn.rmsnorm_plain(xd, wd, 1e-6), (xd, wd), gd)
    plain = rn.rmsnorm_backward(xd.detach(), wd.detach(), gd, 1e-6)
    return tuple((a.to(x.dtype), b.to(w.dtype)) for a, b in (auto, plain))


def _rmsnorm_readings(got, want):
    """Max abs error of (dx, dw) and the count of elements beyond GRAD_TOL's
    fp32 bound, against ``want``."""
    atol, rtol = GRAD_TOL["float32"]
    return {n: {"max_abs_err": _max_err(a, b),
                "beyond_tol": int(((a.float() - b.float()).abs()
                                   > atol + rtol * b.float().abs()).sum())}
            for n, a, b in zip(("dx", "dw"), got, want)}


def _sass_counts(so):
    """HGMMA (wgmma), UTMALDG (TMA load) and SYNCS (mbarrier) instructions in
    ``cuobjdump -sass`` of the built library, where the toolkit has it."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG", "SYNCS")}


# -- phase 3 and 4: the two serving paths ---------------------------------------
def _serve(state, arch, prompt, expect, layers=0, on_reset=None, rows=BATCH,
           full_warmup=False):
    """Serve ``arch`` at full width (``layers`` > 0: cut to that depth):
    ``rows`` x ``prompt`` tokens (with the family's patches or frames,
    ``serve.synthetic_batch``), GEN decode steps, launch counts per step
    held to ``expect`` (kind -> counts); the peak memory of the counted
    run. ``on_reset()`` is called where the counts are set to 0, after the
    warm-up, just before the counted run. The warm-up serves 64 tokens and
    2 steps; with ``full_warmup`` the whole batch and one step, so each
    kernel's first launch at the counted shapes falls outside the timed
    run, and that step's logits and its fed token are kept
    (``first_step``)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    server = serve.setup(arch, layers=layers, device="cuda", seed=0)
    cfg = server.cfg
    batch = serve.synthetic_batch(cfg, rows, prompt, device="cuda")
    first_step = None
    if full_warmup:
        warm = serve.generate(server, batch, 1)
        first_step = {"ids": warm["ids"], "logits": warm["last_logits"].float()}
        del warm
        torch.cuda.empty_cache()
    else:
        serve.generate(server, {**batch, "tokens": batch["tokens"][:, :64]}, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snaps = []
    reset_launch_counts()
    if on_reset:
        on_reset()
    res = serve.generate(server, batch, GEN,
                         on_step=lambda kind: snaps.append((kind, launch_counts())))
    total = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_step, prev = [], {k: 0 for k in total}
    for kind, c in snaps:
        per_step.append((kind, {k: c[k] - prev[k] for k in c}))
        prev = c
    finite = bool(torch.isfinite(res["prefill_logits"].float()).all()
                  and torch.isfinite(res["last_logits"].float()).all())
    emit(serve={"arch": arch, "layers": cfg.num_layers,
                "published_layers": get_arch(arch).num_layers,
                "params": sum(p.numel() for p in _leaves(server.params)),
                "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
                "vocab": cfg.vocab_size, "batch": rows, "prompt_len": prompt,
                "gen": GEN, "prefill_ms": res["prefill_ms"],
                "decode_ms_per_token": res["decode_ms_per_token"],
                "launches_total": total,
                "launches_prefill": per_step[0][1],
                "launches_per_decode_step": [c for _, c in per_step[1:]],
                "peak_memory_gib": peak_gib,
                "finite": finite, "sample_ids": res["ids"][0].tolist(),
                "card": state["card"]})
    assert finite, "non-finite logits"
    assert len(per_step) == GEN + 1
    for kind, c in per_step:
        assert c == expect[kind], f"{kind}: launches {c}, expected {expect[kind]}"
    return {"server": server, "tokens": batch["tokens"], "batch": batch,
            "ids": res["ids"], "launches": total, "prompt": prompt,
            "decode_ms_per_token": res["decode_ms_per_token"],
            "prefill_ms": res["prefill_ms"], "expect": expect,
            "prefill_logits": res["prefill_logits"].float(),
            "last_logits": res["last_logits"].float(), "peak_gib": peak_gib,
            "per_step": per_step, "first_step": first_step}


NO_BACKWARD = {"flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0,
               "rmsnorm_bwd": 0, "rglru_scan_bwd": 0}


def _dense_launches(n):
    """A dense model of ``n`` layers: K1 once per layer in the prefill (all
    on the sm90 kernel), none in a decode step; K2 twice per layer and once
    before the head in both."""
    return {"prefill": {"flash_attention": n, "flash_attention_sm90": n,
                        "rmsnorm": 2 * n + 1, "rglru_scan": 0, "slstm_scan": 0,
                        **NO_BACKWARD},
            "decode": {"flash_attention": 0, "flash_attention_sm90": 0,
                       "rmsnorm": 2 * n + 1, "rglru_scan": 0, "slstm_scan": 0,
                       **NO_BACKWARD}}


def phase_serve(state):
    state[ARCH] = _serve(state, ARCH, PROMPT, _dense_launches(32))


def _hybrid_launches():
    """recurrentgemma-2b's 26 layers: K1 once per attention layer (8, all
    sm90) and K3 once per recurrent layer (18) in the prefill, neither in a
    decode step; K2 twice per layer and once before the head in both."""
    n, attn, rec = 26, 8, 18
    return {"prefill": {"flash_attention": attn, "flash_attention_sm90": attn,
                        "rmsnorm": 2 * n + 1, "rglru_scan": rec, "slstm_scan": 0,
                        **NO_BACKWARD},
            "decode": {"flash_attention": 0, "flash_attention_sm90": 0,
                       "rmsnorm": 2 * n + 1, "rglru_scan": 0, "slstm_scan": 0,
                       **NO_BACKWARD}}


def phase_hybrid_serve(state):
    state[HYB_ARCH] = _serve(state, HYB_ARCH, HYB_PROMPT, _hybrid_launches())


@contextlib.contextmanager
def _one_rank_mesh(names=("data", "model")):
    """A one-rank NCCL process group (a ``file://`` store in a temporary
    directory) and a ``Mesh`` of 1 x ... x 1 over it, with its
    ``DeviceMesh``: the sharded runtime's path on one card. The group is
    destroyed on the way out, so later phases run as before. The DTensor
    API must import; nothing falls back to the single-device path."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor  # noqa: F401
    from torch.distributed.tensor.experimental import (  # noqa: F401
        implicit_replication,
        local_map,
    )

    from repro_torch.launch.mesh import Mesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    try:
        mesh = Mesh((1,) * len(names), names, "cuda")
        assert mesh.device_mesh is not None
        yield mesh
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _sharded_serve(state, arch):
    """``arch``'s served weights (``_serve``'s, still on the card) through
    the sharded ``make_serve_fns`` on a one-rank (data 1, model 1) mesh:
    the param DTensors wrap the same storage (no second copy), the same
    batch and GEN greedy steps. Launch counts per step equal the
    single-device run's; the prefill and last logits within 2e-2 of it
    (bit-equal expected; the max abs differences are printed) and the same
    ids; for the MoE family also each layer's expert ids in the prefill
    (one more single-device prefill, not counted, records them); prefill
    ms and decode ms per token beside the single-device path's (the
    difference is DTensor's host cost)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.registry import leaves

    run = state[arch]
    single = run["server"]
    batch = run["batch"]
    plen = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                       if "patches" in batch else 0)
    is_moe = single.cfg.family == "moe"
    routes, route = {"single": [], "sharded": []}, moe.route

    def recording(key):
        def fn(p, x, cfg):
            out = route(p, x, cfg)
            routes[key].append(out[1].detach().clone())
            return out
        return fn

    if is_moe:
        moe.route = recording("single")
        try:
            single.prefill(single.params, batch, plen + GEN)
        finally:
            moe.route = route
        torch.cuda.synchronize()
    with _one_rank_mesh() as mesh:
        server = serve.setup(arch, device="cuda", mesh=mesh, params=single.params,
                             layers=single.cfg.num_layers)
        same = all(a.to_local().data_ptr() == b.data_ptr()
                   for a, b in zip(leaves(server.params), leaves(single.params)))
        # the warm-up at the counted run's shapes: DTensor propagates each
        # op's placements once per new shape (its cost is printed)
        first = serve.generate(server, batch, 2)
        torch.cuda.synchronize()
        snaps = []
        reset_launch_counts()
        if is_moe:
            moe.route = recording("sharded")
        try:
            res = serve.generate(server, batch, GEN,
                                 on_step=lambda kind: snaps.append((kind, launch_counts())))
        finally:
            moe.route = route
        per_step, prev = [], {k: 0 for k in launch_counts()}
        for kind, c in snaps:
            per_step.append((kind, {k: c[k] - prev[k] for k in c}))
            prev = c
        err = {"prefill": _max_err(res["prefill_logits"].float(), run["prefill_logits"]),
               "last": _max_err(res["last_logits"].float(), run["last_logits"])}
        same_ids = bool(torch.equal(res["ids"], run["ids"]))
        n_layers = single.cfg.num_layers
        same_experts = [bool(torch.equal(a, b)) for a, b in
                        zip(routes["single"], routes["sharded"][:n_layers])]
        emit(sharded_serve={
            "arch": arch, "layers": n_layers, "mesh": "1x1", "same_storage": same,
            "max_abs_err": err, "same_ids": same_ids,
            **({"same_expert_ids_per_layer": same_experts} if is_moe else {}),
            "prefill_ms": res["prefill_ms"],
            "first_prefill_ms": first["prefill_ms"],
            "single_device_prefill_ms": run["prefill_ms"],
            "decode_ms_per_token": res["decode_ms_per_token"],
            "single_device_decode_ms_per_token": run["decode_ms_per_token"],
            "launches_prefill": per_step[0][1],
            "launches_per_decode_step": per_step[1][1], "card": state["card"]})
        del server, res, first
    torch.cuda.empty_cache()
    assert same, "the sharded params copied the weights"
    assert err["prefill"] <= 2e-2 and err["last"] <= 2e-2, err
    assert same_ids, "the sharded path generated other ids"
    if is_moe:
        assert len(routes["single"]) == n_layers and all(same_experts), (
            f"expert ids per layer differ: {same_experts}")
    assert len(per_step) == GEN + 1
    for kind, c in per_step:
        assert c == run["expect"][kind], (
            f"{kind}: launches {c}, expected {run['expect'][kind]}")


def phase_sharded_serve(state):
    _sharded_serve(state, ARCH)


def phase_hybrid_sharded_serve(state):
    _sharded_serve(state, HYB_ARCH)


def _is_kernel(e, device_type):
    """A kernel's row of ``key_averages``: device time, and not the
    device-side copy of one of the port's profiler ranges (``repro_torch.*``),
    whose time its kernels already count."""
    return (e.device_type == device_type.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("repro_torch."))


def _kernel_table(prof, wall_ms, steps):
    """Device time by kernel name from a torch.profiler run over ``wall_ms``
    of host time; ms per step, busy share, top kernels."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if _is_kernel(e, DeviceType)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / steps,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:90], "ms_per_step": t / steps,
                     "launches_per_step": c / steps} for k, t, c in rows[:14]]}


def _profile(run):
    """One prefill and two decode steps of the served model under
    torch.profiler: device time by kernel and the card's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    server, prompt = run["server"], run["prompt"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, caches = server.prefill(server.params, {"tokens": run["tokens"]},
                                        prompt + 2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    emit(profile_prefill={"arch": server.cfg.name,
                          **_kernel_table(prof, wall, 1)})
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            logits, caches = server.decode(server.params, caches, tok, prompt + i)
            tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    emit(profile_decode={"arch": server.cfg.name, **_kernel_table(prof, wall, 2)})


def phase_profile(state):
    _profile(state[ARCH])


def phase_hybrid_profile(state):
    _profile(state[HYB_ARCH])


class _moe_last_token_routes:
    """With ``on``, record for each MoE layer of a call, in order, the last
    token's input (fp32) and the top-k expert ids that its routing chose,
    as (x, ids) pairs in ``out``. With ``replay`` (the pairs of an earlier
    call), a call of one token is routed to the replayed ids of each layer
    instead, weighted by its own gates: teacher-forced routing."""

    def __init__(self, on, out, replay=None):
        self.on, self.out, self.replay = on, out, replay

    def __enter__(self):
        if self.on:
            import torch

            from repro_torch.models import moe

            self.mod, self.orig = moe, moe.route

            def route(p, x, cfg):
                res = self.orig(p, x, cfg)
                self.out.append((x[:, -1].float(), res[1][:, -1]))
                if self.replay is None:
                    return res
                assert x.shape[1] == 1, "replay routes a decode step"
                ids = self.replay[len(self.out) - 1][1][:, None]        # (B,1,k)
                gates = torch.softmax((x @ p["router"].to(x.dtype)).float(), -1)
                w = torch.gather(gates, -1, ids)
                w = (w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)).to(x.dtype)
                return (w, ids, *moe.dispatch_plan(ids, cfg, moe.expert_capacity(cfg, 1)))

            moe.route = route
        return self

    def __exit__(self, *exc):
        if self.on:
            self.mod.route = self.orig
        return False


def _teacher_forcing(state, arch, batch, limits, cfg_kw=None):
    """``forward`` over prompt + 1 tokens against prefill(prompt) +
    decode(1), for each activation dtype in ``limits`` (dtype -> limit on
    the relative L2 of the last logits), with the served weights and
    inputs (the VLM's patches come first: decode at P + prompt) and the
    config's fields replaced by ``cfg_kw``. Frees the model."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.train.serve import make_serve_fns

    run = state[arch]
    server, prompt = run["server"], run["prompt"]
    toks = torch.cat([run["tokens"], run["ids"][:, :1]], dim=1)[:batch]
    extra = {k: v[:batch] for k, v in run.get("batch", {}).items() if k != "tokens"}
    n_extra = extra["patches"].shape[1] if "patches" in extra else 0
    fails = []
    moe_family = server.cfg.family == "moe"
    for dtype, limit in limits.items():
        api = build_model(server.cfg.replace(dtype=dtype, **(cfg_kw or {})))
        prefill, decode = make_serve_fns(api, "cuda")
        fwd_routes, dec_routes = [], []
        with _moe_last_token_routes(moe_family, fwd_routes):
            with torch.inference_mode():
                full = api.forward(server.params, toks, **extra)[:, -1].float()
        _, caches = prefill(server.params, {"tokens": toks[:, :prompt], **extra},
                            n_extra + prompt + 1)
        with _moe_last_token_routes(moe_family, dec_routes, replay=fwd_routes):
            step, _ = decode(server.params, caches, toks[:, prompt], n_extra + prompt)
        step = step[:, 0].float()
        rel = ((step - full).norm() / full.norm()).item()
        line = {"arch": arch, "dtype": dtype, "batch": batch, "tokens": prompt + 1,
                "rel_l2": rel, "limit": limit, "max_abs_err": _max_err(step, full)}
        if moe_family:
            # the decode step took the forward's experts in every layer; print
            # each layer's MoE input of the last token (rel. L2 between the
            # two runs) and the layers where the step's own top-k set differs
            # from the forward's (a near-tie of two gates)
            assert len(fwd_routes) == len(dec_routes) == server.cfg.num_layers
            moved = [((d[0] - f[0]).norm() / f[0].norm()).item()
                     for f, d in zip(fwd_routes, dec_routes)]
            apart = [i for i, (f, d) in enumerate(zip(fwd_routes, dec_routes))
                     if not torch.equal(f[1].sort(-1).values, d[1].sort(-1).values)]
            line.update(moe_input_rel_l2=moved, layers_routed_apart=apart)
        emit(teacher_forcing=line)
        if rel > limit:
            fails.append(f"{dtype}: teacher forcing rel L2 {rel} > {limit}")
        del full, caches, step
    del run["server"], server
    torch.cuda.empty_cache()
    assert not fails, fails


def phase_teacher_forcing(state):
    _teacher_forcing(state, ARCH, BATCH, {"bfloat16": 3e-2})


def phase_hybrid_teacher_forcing(state):
    """Batch 1: forward's full logits over 4097 positions are 2.1 GB in bf16.
    In bf16 the reference's own decode arithmetic (the conv step's einsum
    where forward sums tap by tap, bf16 window-attention probabilities)
    rounds differently from forward, and 26 random layers grow that: the
    reference's own bf16 teacher forcing has rel. L2 0.059 on a 26-layer,
    width-256 cut on the CPU (``tests/test_torch_recurrent.py``). So bf16
    is held to the reference's own 1e-1 (``tests/test_models_smoke.py``)
    and the fp32 activations, where only the bf16 conv history rounds, to
    3e-2."""
    _teacher_forcing(state, HYB_ARCH, 1, {"bfloat16": 1e-1, "float32": 3e-2})


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _card_vs_cpu(arch, prompt, steps=4, dtype="bfloat16"):
    """The reduced config with the same weights and inputs, kernels on the
    card and plain PyTorch on the CPU, activations in ``dtype``: prefill
    and ``steps`` decode steps, logits within 3e-2. The reduced configs'
    head dim is 16, so K1 takes the SIMT kernel: launches there, none on
    the sm90 kernel (and none at all in the SSM family, which has no
    attention; K2 launches there)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.train.serve import make_serve_fns

    cfg = get_arch(arch, reduced=True).replace(dtype=dtype)
    api = build_model(cfg)
    p_cpu = api.init(0, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    pre_c, dec_c = make_serve_fns(api, "cpu")
    pre_g, dec_g = make_serve_fns(api, "cuda")
    batch = serve.synthetic_batch(cfg, 2, prompt, seed=1, device="cpu")
    pos0 = prompt + (cfg.num_patches if "patches" in batch else 0)
    reset_launch_counts()
    lc, cc = pre_c(p_cpu, batch, pos0 + steps)
    lg, cg = pre_g(p_gpu, batch, pos0 + steps)
    pairs = [(lg, lc)]
    for i in range(steps):
        tok = lc[:, -1].argmax(-1)
        lc, cc = dec_c(p_cpu, cc, tok, pos0 + i)
        lg, cg = dec_g(p_gpu, cg, tok, pos0 + i)
        pairs.append((lg, lc))
    counts = launch_counts()
    errs = [_max_err(g.cpu(), c) for g, c in pairs]
    ok = all(torch.allclose(g.cpu().float(), c.float(), atol=3e-2, rtol=3e-2)
             for g, c in pairs)
    emit(card_vs_cpu={"arch": f"{arch} reduced", "dtype": dtype,
                      "prompt_len": prompt,
                      "steps": ["prefill"] + ["decode"] * steps,
                      "max_abs_err": errs, "tol": 3e-2, "launches": counts})
    assert ok, f"card and CPU logits differ beyond 3e-2: {errs}"
    attends = cfg.family != "ssm"
    assert (counts["flash_attention"] > 0) == attends and counts["rmsnorm"] > 0 \
        and counts["flash_attention_sm90"] == 0, (
            f"reduced {arch}: launches {counts}, expected K1 on SIMT only")


def phase_card_vs_cpu(state):
    _card_vs_cpu(ARCH, 24)


def phase_hybrid_card_vs_cpu(state):
    _card_vs_cpu(HYB_ARCH, 40)          # longer than the reduced window of 32


def phase_dense14b_serve(state):
    """qwen2.5-14b at its published width and depth (48 layers, d_model 5120,
    40 q heads on 8 kv heads of 128: a GQA group of 5; QKV bias, untied
    head, vocab 152064; 14.77 B params, 59.1 GB in fp32): serve with launch
    counts, teacher forcing at 3e-2, then the reduced config on the card
    against the CPU."""
    state[DENSE14B] = _serve(state, DENSE14B, PROMPT,
                             _dense_launches(QWEN14B["layers"]))
    _teacher_forcing(state, DENSE14B, BATCH, {"bfloat16": 3e-2})
    _card_vs_cpu(DENSE14B, 24)


def phase_granite_serve(state):
    """granite-34b at its published width (d_model 6144, 48 q heads on one kv
    head of 128: MQA; the non-gated GELU-tanh MLP, d_ff 24576; untied head,
    vocab 49152) cut to GRANITE_LAYERS of its 88 layers: 15.77 B params,
    63.1 GB in fp32, where the whole model's 135.8 GB exceed the card. The
    same checks as qwen2.5-14b."""
    state[GRANITE] = _serve(state, GRANITE, PROMPT, _dense_launches(GRANITE_LAYERS),
                            layers=GRANITE_LAYERS)
    _teacher_forcing(state, GRANITE, BATCH, {"bfloat16": 3e-2})
    _card_vs_cpu(GRANITE, 24)


def _moe_drop_and_weights(state, arch):
    """The share of (token, slot) assignments that the published capacity
    factor drops in the served prefill (one more prefill, every layer's
    routing read; not counted), and the expert weights a decode step reads
    and casts: every expert's full weights in every layer, whatever the
    batch (capacity k at S = 1), beside the step's measured time."""
    import torch

    from repro_torch.models import moe

    run = state[arch]
    server, cfg = run["server"], run["server"].cfg
    shares, orig = [], moe.apply_moe

    def record(p, x, c):
        keep = moe.route(p, x, c)[3]
        shares.append(1.0 - keep.float().mean().item())
        return orig(p, x, c)

    moe.apply_moe = record
    try:
        server.prefill(server.params, run["batch"], run["prompt"] + GEN)
    finally:
        moe.apply_moe = orig
    elems = cfg.num_layers * 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
    pbytes = 4 if cfg.param_dtype == "float32" else 2
    # read the params; an fp32 param is also cast: bf16 written, then read
    step_bytes = elems * (pbytes + (4 if pbytes == 4 else 0))
    emit(moe={"arch": arch, "capacity_factor": cfg.capacity_factor,
              "prefill_tokens": [BATCH, run["prompt"]],
              "dropped_share_per_layer": shares,
              "dropped_share_mean": sum(shares) / len(shares),
              "decode_expert_bytes_per_step": step_bytes,
              "decode_expert_bytes_per_token": step_bytes / BATCH,
              "decode_expert_bytes_bound_ms": step_bytes / PEAK_BYTES_PER_S * 1e3,
              "decode_ms_per_step": run["decode_ms_per_token"],
              "card": state["card"]})
    torch.cuda.empty_cache()


# MoE teacher forcing: the dense limit on the logits in bf16 and fp32
# activations, the decode step routed to the forward's experts
# (_moe_last_token_routes), since at a near-tie of two gates the two runs,
# which round the hidden state apart (the cache holds bf16 k/v), would
# otherwise compute different functions
MOE_TEACHER_LIMITS = {"bfloat16": 3e-2, "float32": 3e-2}


def _drop_free(experts, k):
    """A capacity factor of E/k: capacity int(S k cf / E) = S, so nothing
    drops; nudged up so that the float product (64/6 is inexact) cannot
    round the capacity down to S - 1."""
    return experts / k * (1 + 1e-6)


def phase_moe16b_serve(state):
    """deepseek-moe-16b at its published width and depth (28 layers, d_model
    2048, 16 heads of 128 on 16 kv heads: a GQA group of 1; 64 routed
    experts top 6 of width 1408 and 2 shared, capacity factor 1.25; vocab
    102400; 16.88 B params, 67.5 GB in fp32): serve with launch counts, the
    dropped share and the decode step's expert bytes."""
    state[MOE16B] = _serve(state, MOE16B, PROMPT, _dense_launches(MOE16B_D["layers"]))
    _moe_drop_and_weights(state, MOE16B)


def phase_moe16b_sharded_serve(state):
    _sharded_serve(state, MOE16B)


def phase_moe16b_checks(state):
    """Teacher forcing with a capacity factor of E/k (nothing drops) and
    the decode step routed to the forward's experts, at batch 1 in bf16 and
    fp32 (``MOE_TEACHER_LIMITS``), then the reduced config on the card
    against the CPU in fp32 (in bf16 a near-tie of two gates may route a
    token to another expert on another device, ROADMAP §3). Frees the
    served model."""
    _teacher_forcing(state, MOE16B, 1, MOE_TEACHER_LIMITS,
                     cfg_kw={"capacity_factor": _drop_free(64, 6)})
    _card_vs_cpu(MOE16B, 24, dtype="float32")


def phase_qwen3moe_serve(state):
    """qwen3-moe-235b-a22b at its published width (d_model 4096, 64 q heads
    on 4 kv heads of 128: a GQA group of 16; 128 experts top 8 of width
    1536; vocab 151936; bf16 params, its own param_dtype) cut to 12 of its
    94 layers (62.2 GB; all 94 take 470 GB): the same checks as
    deepseek-moe-16b."""
    state[QWEN3MOE] = _serve(state, QWEN3MOE, PROMPT, _dense_launches(QWEN3MOE_LAYERS),
                             layers=QWEN3MOE_LAYERS)
    _moe_drop_and_weights(state, QWEN3MOE)


def phase_qwen3moe_sharded_serve(state):
    _sharded_serve(state, QWEN3MOE)


def phase_qwen3moe_checks(state):
    _teacher_forcing(state, QWEN3MOE, 1, MOE_TEACHER_LIMITS,
                     cfg_kw={"capacity_factor": _drop_free(128, 8)})
    _card_vs_cpu(QWEN3MOE, 24, dtype="float32")


def phase_vlm_serve(state):
    """internvl2-26b's backbone at its published width (d_model 6144, 48 q
    heads on 8 kv heads of 128: a GQA group of 6; d_ff 16384; vocab 92553)
    cut to 36 of its 48 layers (60.7 GB in fp32; all 48 take 79.4 GB), the
    vision frontend a stub: 256 patch embeddings (bf16 standard normals)
    in front of 4 x 512 text tokens, decoding at 256 + 512 + i, with launch
    counts."""
    state[VLM] = _serve(state, VLM, PROMPT, _dense_launches(VLM_LAYERS),
                        layers=VLM_LAYERS)


def phase_vlm_sharded_serve(state):
    _sharded_serve(state, VLM)


def phase_vlm_checks(state):
    """Teacher forcing, and the reduced config card vs CPU in fp32 (the
    patches make the activations some 50 times the token embeddings'
    scale, and bf16 then rounds apart across devices beyond 3e-2 as it does
    across frameworks; ``tests/test_torch_vlm.py``)."""
    _teacher_forcing(state, VLM, BATCH, {"bfloat16": 3e-2})
    _card_vs_cpu(VLM, 24, dtype="float32")


def phase_whisper_serve(state):
    """whisper-medium at its published width and depth (24 encoder and 24
    decoder layers, d_model 1024, 16 heads of 64, vocab 51865; 0.81 B
    params), the mel frontend a stub: 1500 frame embeddings (bf16 standard
    normals) and 4 x 432 text tokens (with 16 decode steps, the published
    448-token text context). K1 launches per prefill: 24 non-causal over
    the 1500 frames, 24 causal self-attentions over the cache, 24
    non-causal cross-attentions (S 432, T 1500), all sm90; K2 122 per
    prefill, 73 per decode step. The launches are tallied by shape for
    the kernel rows. Teacher forcing, and the reduced config (30 frames)
    on the card against the CPU."""
    n = WHISPER_D["layers"]
    with _tally_by_shape() as tally:
        state[WHISPER] = _serve(state, WHISPER, WH_S, on_reset=tally.counts.clear, expect={
            "prefill": {"flash_attention": 3 * n, "flash_attention_sm90": 3 * n,
                        "rmsnorm": 5 * n + 2, "rglru_scan": 0, "slstm_scan": 0,
                        **NO_BACKWARD},
            "decode": {"flash_attention": 0, "flash_attention_sm90": 0,
                       "rmsnorm": 3 * n + 1, "rglru_scan": 0, "slstm_scan": 0,
                       **NO_BACKWARD}})
    # the counted run's sm90 launches by (S, T, causal) (the tally was
    # cleared with the counts, after the warm-up)
    k1 = {shape: m for (kind, shape), m in tally.counts.items()
          if kind == "flash_attention_sm90"}
    by_shape = {"enc": k1.get((WH_F, WH_F, False), 0),
                "cross": k1.get((WH_S, WH_F, False), 0),
                "self": k1.get((WH_S, WH_S + GEN, True), 0)}
    emit(whisper_k1_launches_by_shape=by_shape, all_shapes=
         {f"{'causal' if c else 'full'} {s}x{t}": m for (s, t, c), m in k1.items()})
    assert by_shape == {"enc": n, "cross": n, "self": n}, by_shape
    assert sum(k1.values()) == 3 * n, k1
    state[WHISPER]["k1_by_shape"] = by_shape


def phase_whisper_sharded_serve(state):
    _sharded_serve(state, WHISPER)


def phase_whisper_checks(state):
    """Teacher forcing, and the reduced config (30 frames) on the card
    against the CPU."""
    _teacher_forcing(state, WHISPER, BATCH, {"bfloat16": 3e-2})
    _card_vs_cpu(WHISPER, 24)


def _xlstm_launches():
    """xlstm-1.3b's 48 blocks (6 periods of 7 mLSTM blocks and one sLSTM
    block): no K1 (the family has no attention); K2 twice per block and once
    before the head, and the sLSTM kernel once per sLSTM block, in the
    prefill and in each decode step alike."""
    n = XLSTM_D["blocks"]
    step = {"flash_attention": 0, "flash_attention_sm90": 0, "rmsnorm": 2 * n + 1,
            "rglru_scan": 0, "slstm_scan": n // 8, **NO_BACKWARD}
    return {"prefill": step, "decode": step}


def phase_xlstm_serve(state):
    """xlstm-1.3b at its published width and depth (48 blocks: 6 periods of
    7 mLSTM blocks and one sLSTM block; d_model 2048, 4 heads: mLSTM head
    dim 1024, sLSTM 512; vocab 50304; 1.94 B params, 7.8 GB in fp32): 4 x
    2048 tokens (8 chunks of 256 in each mLSTM block, the sLSTM's 2,048 steps
    in one kernel launch a block), 16 decode steps. No K1 and no Pallas
    kernel of the reference: K2 97 and the sLSTM kernel 6 per prefill and
    per decode step. Prints the prefill ms beside the sLSTM's Python
    loop's (``XLSTM_LOOP_PREFILL_MS``)."""
    state[XLSTM] = _serve(state, XLSTM, XLSTM_D["prompt"], _xlstm_launches())
    emit(xlstm_prefill={"prefill_ms": state[XLSTM]["prefill_ms"],
                        "loop_prefill_ms": XLSTM_LOOP_PREFILL_MS,
                        "card": state["card"]})


def phase_xlstm_sharded_serve(state):
    _sharded_serve(state, XLSTM)


def phase_xlstm_checks(state):
    """Teacher forcing with bf16 activations at the reference's own 1e-1
    and fp32 activations at 3e-2 (as for the hybrid; in bf16 the reduced
    model is chaotic in the reference itself, ``tests/test_torch_xlstm.py``),
    and the reduced config card vs CPU in fp32 (for that reason)."""
    _teacher_forcing(state, XLSTM, BATCH, {"bfloat16": 1e-1, "float32": 3e-2})
    _card_vs_cpu(XLSTM, 300, dtype="float32")


def phase_moe_train(state):
    """deepseek-moe-16b at full width cut to MOE_TRAIN["layers"] of its 28
    layers through ``launch/train.py --dp-sync gspmd``, MOE_TRAIN["steps"]
    steps on one fixed batch of 4 x 1024: on one device, freed, then the
    same command on a one-rank (data 1, model 1) NCCL mesh from the same
    seed (DTensor params, m and v; the experts on "model"). The first loss
    equal to the bit; later losses and gnorms within 1e-5 relative (the
    backward of the dispatch's gathers adds with atomics); launch counts
    equal; step ms, the card's busy share over one more profiled step, and
    peak GiB of both. The single-device run's launches give the kernel
    rows at this shape (``phase_times``)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    argv = _train_argv("--steps", str(MOE_TRAIN["steps"]), "--layers",
                       str(MOE_TRAIN["layers"]), "--dp-sync", "gspmd",
                       arch=MOE16B, batch=MOE_TRAIN["batch"], seq=MOE_TRAIN["seq"])
    runs = {}

    def run(name):
        torch.cuda.empty_cache()
        reset_launch_counts()
        res = train.main(argv)
        launches = launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res["step_fn"](res["params"], res["opt"], res["batch"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        table = _kernel_table(prof, wall, 1)
        runs[name] = {"losses": res["losses"], "gnorms": res["gnorms"],
                      "step_ms": res["step_ms"],
                      "step_ms_median_2_3": statistics.median(res["step_ms"][1:]),
                      "profiled_step_wall_ms": wall,
                      "device_busy_ms": table["device_busy_ms_per_step"],
                      "busy_share": 1.0 - table["idle_share"],
                      "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
                      "params": sum(p.numel() for p in _leaves(res["params"])),
                      "launches": launches}
        del res, prof
        torch.cuda.empty_cache()

    run("single_device")
    with _one_rank_mesh():
        run("sharded")
    a, b = runs["sharded"], runs["single_device"]
    rel = {k: max(abs(x - y) / abs(y) for x, y in zip(a[k][1:], b[k][1:]))
           for k in ("losses", "gnorms")}
    first_equal = a["losses"][0] == b["losses"][0]
    emit(moe_train={"arch": MOE16B, "layers": MOE_TRAIN["layers"],
                    "published_layers": MOE16B_D["layers"], "batch": MOE_TRAIN["batch"],
                    "seq": MOE_TRAIN["seq"], "mesh": "1x1", **runs,
                    "first_loss_equal": first_equal, "rel_diff_later_steps": rel,
                    "card": state["card"]})
    state["moe16b_train"] = {"launches": b["launches"]}
    assert all(math.isfinite(x) for x in b["losses"] + a["losses"]), runs
    assert first_equal, (a["losses"][0], b["losses"][0])
    assert rel["losses"] <= 1e-5 and rel["gnorms"] <= 1e-5, rel
    assert a["launches"] == b["launches"], (a["launches"], b["launches"])
    for k in ("flash_attention_sm90", "flash_attention_bwd_sm90", "rmsnorm",
              "rmsnorm_bwd"):
        assert b["launches"][k] > 0, b["launches"]


class _tally_by_shape:
    """While open, tally the launches of K1, K1's backward, K2 and K2's
    backward by shape into ``counts`` (key: (kernel, shape) -> launches),
    where K1's shape is (S, T, causal) and K2's the x shape; and K1's and
    its backward's launches on the sm90 route under (kernel + "_sm90", ...).
    It wraps the module functions that ``kernels/ops.py`` calls and counts
    the wrappers' own launch counts across each call, so it adds none."""

    KINDS = (("flash_attention", "flash_attention", "flash_attention"),
             ("flash_attention", "flash_attention_backward", "flash_attention_bwd"),
             ("rmsnorm", "rmsnorm", "rmsnorm"), ("rmsnorm", "rmsnorm_grad", "rmsnorm_bwd"))

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        from repro_torch.kernels import flash_attention, launch_counts, rmsnorm

        mods = {"flash_attention": flash_attention, "rmsnorm": rmsnorm}
        self.saved = []
        for mod_name, fn_name, kind in self.KINDS:
            mod = mods[mod_name]
            orig = getattr(mod, fn_name)

            def counted(*a, _orig=orig, _kind=kind, **kw):
                before = launch_counts()
                out = _orig(*a, **kw)
                after = launch_counts()
                if _kind.startswith("flash"):
                    shape = (a[0].shape[1], a[1].shape[1], kw.get("causal", True))
                else:
                    shape = tuple(a[0].shape)
                for k in (_kind, _kind + "_sm90"):
                    if k in after and after[k] > before[k]:
                        key = (k, shape)
                        self.counts[key] = self.counts.get(key, 0) + after[k] - before[k]
                return out

            self.saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, counted)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)
        return False


def _profile_step(step, batch):
    """``step(batch)`` once under torch.profiler: the card's busy ms (the sum
    of its kernels', copies' and sets' device times; the port's profiler
    ranges not counted, as ``_is_kernel``), their idle share of the step's
    wall, the top kernels and device ms by kernel group. CUDA activity
    only, read from the raw kineto events: recording the host's ops too,
    and building the profiler's Python event tree, take minutes for a step
    of some 10^5 launches (xlstm-1.3b's sLSTM loop)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or name.startswith("repro_torch.")):
            continue
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = sorted(by_name.items(), key=lambda r: -r[1][0])
    busy = sum(ms for _, (ms, _) in rows)
    groups = {name: 0.0 for name, _ in _GROUPS}
    groups["other kernels (elementwise, reductions)"] = 0.0
    for name, (ms, _) in rows:
        groups[_kernel_group(name)] += ms
    return {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / wall,
            "top": [{"kernel": k[:90], "ms_per_step": ms, "launches_per_step": n}
                    for k, (ms, n) in rows[:14]],
            "device_launches_per_step": sum(n for _, (_, n) in rows),
            "groups_ms": groups}


def _family_train(state, key, arch, seq, want, *, layers=0, patches=False):
    """``arch`` at full width (``layers`` > 0: cut to that depth) through
    ``launch/train.py --dp-sync gspmd --fixed-batch``, FAM_TRAIN_STEPS steps
    at FAM_TRAIN_BATCH x ``seq``: finite losses, the last below the first;
    step ms (the median of steps 2 on), tokens/s, peak GiB, the parameter
    count; launches per step held to ``want``, every K1 and K1-backward
    launch on the sm90 route; launches by shape (``_tally_by_shape``) for
    the kernel rows; one more step under torch.profiler (busy share, top
    kernels). ``patches``: the VLM, whose batches the driver does not draw
    (nor the reference's): ``train.main`` takes no step (``--steps 0``;
    its schedule then warms up over step 1 and holds 10% of the peak rate
    from step 2) and returns its ``step_fn``, which takes the steps with
    256 stub patches, drawn as ``serve.synthetic_batch`` draws them, in
    front of the tokens (host clock after a synchronize, as the driver
    times its steps)."""
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve, train

    steps = FAM_TRAIN_STEPS
    extra = ("--layers", str(layers)) if layers else ()
    argv = _train_argv("--steps", "0" if patches else str(steps), "--dp-sync", "gspmd",
                       *extra, arch=arch, batch=FAM_TRAIN_BATCH, seq=seq)
    torch.cuda.empty_cache()
    snaps, tally = [], _tally_by_shape()
    with tally:
        reset_launch_counts()
        res = train.main(argv, on_step=lambda step, m: snaps.append(launch_counts()))
        batch, cfg = res["batch"], res["cfg"]
        if patches:
            batch = {**batch, "patches": serve.synthetic_batch(
                cfg, FAM_TRAIN_BATCH, seq, device="cuda")["patches"]}
            for k in ("losses", "gnorms", "lrs", "step_ms"):
                res[k] = []
            for _ in range(steps):
                t0 = time.perf_counter()
                _, _, m = res["step_fn"](res["params"], res["opt"], batch)
                torch.cuda.synchronize()
                res["step_ms"].append((time.perf_counter() - t0) * 1e3)
                for k, name in (("losses", "loss"), ("gnorms", "gnorm"), ("lrs", "lr")):
                    res[k].append(float(m[name]))
                snaps.append(launch_counts())
            res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    total = launch_counts()
    per_step, prev = [], {k: 0 for k in total}
    for c in snaps:
        per_step.append({k: c[k] - prev[k] for k in c})
        prev = c
    losses = res["losses"]
    step_ms = statistics.median(res["step_ms"][1:])
    positions = seq + (cfg.num_patches if patches else 0)
    prof = _profile_step(lambda b: res["step_fn"](res["params"], res["opt"], b), batch)
    by_shape = {f"{k} {shape}": n for (k, shape), n in sorted(tally.counts.items(),
                                                              key=str)}
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "published_layers": get_arch(arch).num_layers,
           "params": sum(p.numel() for p in _leaves(res["params"])),
           "param_dtype": cfg.param_dtype, "dtype": cfg.dtype, "remat": cfg.remat_policy,
           "batch": FAM_TRAIN_BATCH, "seq": seq, "positions": positions,
           "patches": cfg.num_patches if patches else 0, "dp_sync": "gspmd",
           "losses": losses, "gnorms": res["gnorms"], "lrs": res["lrs"],
           "step_ms": res["step_ms"], "step_ms_median_2_on": step_ms,
           "tokens_per_s": FAM_TRAIN_BATCH * seq / (step_ms / 1e3),
           "positions_per_s": FAM_TRAIN_BATCH * positions / (step_ms / 1e3),
           "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
           "launches_per_step": per_step, "launches_total": total,
           "launches_by_shape": by_shape, "profile": prof,
           "busy_share": 1.0 - prof["idle_share"],
           # the profiler's host cost stretches the profiled step: the same
           # busy ms over the unprofiled median step as well
           "busy_share_of_median_step": prof["device_busy_ms_per_step"] / step_ms,
           "card": state["card"]}
    emit(**{key: out})
    state[key] = {"launches": total, "by_shape": dict(tally.counts), "step_ms": step_ms,
                  "busy_share": out["busy_share"], "peak_mem_gib": out["peak_mem_gib"],
                  "busy_share_of_median_step": out["busy_share_of_median_step"]}
    del res, batch
    torch.cuda.empty_cache()
    assert all(math.isfinite(x) for x in losses), f"non-finite loss {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    assert len(per_step) == steps, per_step
    for i, c in enumerate(per_step):
        assert c == want, f"step {i + 1}: launches {c}, expected {want}"
    assert (total["flash_attention"] == total["flash_attention_sm90"]
            and total["flash_attention_bwd"] == total["flash_attention_bwd_sm90"]), (
        f"{arch}: a K1 launch off the sm90 route: {total}")


def _whisper_train_launches(enc, dec):
    """whisper-medium's launches per step under remat "full": each encoder
    block runs K1 once (non-causal over the frames) and K2 twice, each
    decoder block K1 twice (causal self-attention, non-causal
    cross-attention) and K2 three times, all again in the backward's
    recompute; K2 once more after each stack."""
    return {"flash_attention": 2 * (enc + 2 * dec),
            "flash_attention_sm90": 2 * (enc + 2 * dec),
            "flash_attention_bwd": enc + 2 * dec, "flash_attention_bwd_sm90": enc + 2 * dec,
            "rmsnorm": 2 * (2 * enc + 3 * dec) + 2, "rmsnorm_bwd": 2 * enc + 3 * dec + 2,
            "rglru_scan": 0, "rglru_scan_bwd": 0, "slstm_scan": 0}


def _xlstm_train_launches(blocks):
    """xlstm-1.3b's launches per step under remat "full" per period: no K1;
    K2 twice per block (mLSTM: the norm at d_model and the group norm at
    the inner width; sLSTM: both at d_model), again in the recompute, and
    once before the head."""
    return {"flash_attention": 0, "flash_attention_sm90": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_sm90": 0, "rmsnorm": 4 * blocks + 1,
            "rmsnorm_bwd": 2 * blocks + 1, "rglru_scan": 0, "rglru_scan_bwd": 0,
            "slstm_scan": 0}


def phase_whisper_train(state):
    """whisper-medium whole (24 + 24 layers, 0.8 B params; fp32 params,
    grads, m and v 13 GB): 1500 stub frames (``launch/train.py::_frames``)
    and 4 x 448 tokens. Per step K1 144 (48 non-causal over the frames, 48
    causal, 48 non-causal cross-attention with S 448, T 1500), K1's
    backward 72 (the first non-causal backwards on the card, ragged T),
    K2 242, K2's backward 122. Then the reduced config card vs CPU."""
    n = WHISPER_D["layers"]
    _family_train(state, "whisper_train", WHISPER, WH_TRAIN_SEQ,
                  _whisper_train_launches(n, n))
    by = state["whisper_train"]["by_shape"]
    want = {("flash_attention", (WH_F, WH_F, False)): 2 * FAM_TRAIN_STEPS * n,
            ("flash_attention", (WH_TRAIN_SEQ, WH_F, False)): 2 * FAM_TRAIN_STEPS * n,
            ("flash_attention", (WH_TRAIN_SEQ, WH_TRAIN_SEQ, True)): 2 * FAM_TRAIN_STEPS * n,
            ("flash_attention_bwd", (WH_F, WH_F, False)): FAM_TRAIN_STEPS * n,
            ("flash_attention_bwd", (WH_TRAIN_SEQ, WH_F, False)): FAM_TRAIN_STEPS * n,
            ("flash_attention_bwd", (WH_TRAIN_SEQ, WH_TRAIN_SEQ, True)): FAM_TRAIN_STEPS * n,
            ("rmsnorm", WHISPER_X): FAM_TRAIN_STEPS * (4 * n + 1),
            ("rmsnorm", WHISPER_DEC_X): FAM_TRAIN_STEPS * (6 * n + 1),
            ("rmsnorm_bwd", WHISPER_X): FAM_TRAIN_STEPS * (2 * n + 1),
            ("rmsnorm_bwd", WHISPER_DEC_X): FAM_TRAIN_STEPS * (3 * n + 1)}
    got = {k: by.get(k, 0) for k in want}
    assert got == want, f"whisper launches by shape {got}, expected {want}"
    _train_card_vs_cpu(WHISPER, 32)


def phase_vlm_train(state):
    """internvl2-26b's backbone at full width cut to 4 of its 48 layers (2.70
    B params, 1.14 B of them the untied embedding and head; fp32 params,
    grads, m and v 43 GB), 256 stub patches then 4 x 768 tokens through the
    step that ``launch/train.py`` returns: K1 (a GQA group of 6) 8, K1's
    backward 4, K2 17, K2's backward 9 per step. Then the reduced config
    (16 patches) card vs CPU."""
    _family_train(state, "vlm_train", VLM, VLM_TRAIN_TEXT,
                  _train_launches(VLM_TRAIN_LAYERS), layers=VLM_TRAIN_LAYERS,
                  patches=True)
    _train_card_vs_cpu(VLM, 24)


def phase_qwen3moe_train(state):
    """qwen3-moe-235b-a22b at full width cut to 1 of its 94 layers (3.73 B
    params in its own bf16 param_dtype: bf16 params and grads, fp32 m and v,
    about 45 GB; the stacked layer dim is 1), 4 x 1024: the only training
    path with bf16 params (AdamW's and the clip's bf16 branches). K1 (a GQA
    group of 16) 2, K1's backward 1 (16 per-head fp32 dK/dV scratches
    summed per kv head), K2 5, K2's backward 3 per step. Then the reduced
    config card vs CPU: fp32 params in both, fp32 activations, and bf16
    activations where every layer's routing ids agree across the two."""
    _family_train(state, "qwen3moe_train", QWEN3MOE, XLSTM_TRAIN_SEQ,
                  _train_launches(QWEN3MOE_TRAIN_LAYERS), layers=QWEN3MOE_TRAIN_LAYERS)
    _train_card_vs_cpu(QWEN3MOE, 64, cfg_kw={"param_dtype": "float32"})


def phase_xlstm_train(state):
    """xlstm-1.3b at full width cut to XLSTM_TRAIN_BLOCKS of its 48 blocks (one
    period: 7 mLSTM blocks and one sLSTM block), 4 x 1024: no K1; K2 33 and
    K2's backward 17 per step, at (4, 1024, 2048) and at the group norm's
    (4, 1024, 4096); no sLSTM kernel (it has no backward yet: under
    autograd the model runs the plain loop). That loop runs on the host in
    the forward, the recompute and the backward, so its step ms and busy
    share are readings, not faults; the depth is cut to keep the script
    within its time with xlstm-1.3b's long_500k cell (the whole model took
    94.7 s of a run of this script on an H100 80GB HBM3 at 700 W). Then the
    reduced config card vs CPU."""
    n = XLSTM_TRAIN_BLOCKS
    _family_train(state, "xlstm_train", XLSTM, XLSTM_TRAIN_SEQ, _xlstm_train_launches(n),
                  layers=n)
    by = state["xlstm_train"]["by_shape"]
    n_s = n // 8
    n_m = n - n_s
    want = {("rmsnorm", XLSTM_TRAIN_X): FAM_TRAIN_STEPS * (2 * (n_m + 2 * n_s) + 1),
            ("rmsnorm", QWEN3MOE_TRAIN_X): FAM_TRAIN_STEPS * 2 * n_m,
            ("rmsnorm_bwd", XLSTM_TRAIN_X): FAM_TRAIN_STEPS * (n_m + 2 * n_s + 1),
            ("rmsnorm_bwd", QWEN3MOE_TRAIN_X): FAM_TRAIN_STEPS * n_m}
    got = {k: by.get(k, 0) for k in want}
    assert got == want, f"xlstm launches by shape {got}, expected {want}"
    _train_card_vs_cpu(XLSTM, 32)


# -- phase 5: training ----------------------------------------------------------
def _train_argv(*extra, arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    return ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
            "--fixed-batch", "--log-every", "1", "--device", "cuda", *extra]


def _step_floor_flop(cfg, batch, seq):
    """FLOPs of one training step: matmuls forward (2 per weight per token,
    the tied head included), backward (twice that), the recomputed forward
    of the checkpointed blocks, and attention's forward, recompute and
    backward (2.5x the forward) over the (q, k) pairs inside the causal
    window. Dense: every layer is checkpointed. Hybrid: the RG-LRU block's
    five matmuls (linear_y, linear_x, the two gates, linear_out) or the
    attention projections, the gated MLP, and only the periods' blocks
    recomputed (the tail is not checkpointed). Under remat "dots" the
    recompute keeps its attention and loses its matmuls, whose outputs
    were saved."""
    hd = cfg.resolved_head_dim
    d, f = cfg.d_model, cfg.d_ff
    attn = d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd
    mlp = (3 if cfg.gated_mlp or cfg.family == "hybrid" else 2) * d * f
    window = cfg.local_window if cfg.family == "hybrid" else seq
    pairs = sum(min(i + 1, window) for i in range(seq))
    attn_fwd = 4 * hd * pairs * batch * cfg.num_heads
    if cfg.family == "hybrid":
        r = cfg.d_rnn
        pat = cfg.block_pattern
        kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
        n_remat = cfg.num_layers // len(pat) * len(pat)
        weights = [(3 * d * r + 2 * r * r if k == "rec" else attn) + mlp for k in kinds]
        n_attn = kinds.count("attn")
        n_attn_remat = kinds[:n_remat].count("attn")
    else:
        weights = [attn + mlp] * cfg.num_layers
        n_remat = n_attn = n_attn_remat = cfg.num_layers
    tokens = batch * seq
    dense = 2 * tokens * (sum(weights) + d * cfg.vocab_size)
    recompute = 0 if cfg.remat_policy == "dots" else 2 * tokens * sum(weights[:n_remat])
    return (3 * dense + recompute + attn_fwd * (n_attn * (1 + 2.5) + n_attn_remat))


def _run_training(state, key, arch, batch, seq, want, remat="full", steps=TRAIN_STEPS,
                  extra=()):
    """Full ``arch`` through ``launch/train.py --dp-sync gspmd`` (and the
    arguments ``extra``) under remat policy ``remat``: ``steps`` steps on
    one fixed batch, launches per step held to ``want``; keeps the trainer
    in ``state["trainer"]`` for the profile."""
    import statistics

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import roofline, train

    snaps = []
    state.pop("trainer", None)         # the previous run's, if a phase failed
    torch.cuda.empty_cache()
    reset_launch_counts()
    res = train.main(_train_argv("--steps", str(steps), "--dp-sync", "gspmd",
                                 "--remat-policy", remat, *extra, arch=arch,
                                 batch=batch, seq=seq),
                     on_step=lambda step, m: snaps.append(launch_counts()))
    total = launch_counts()
    per_step, prev = [], {k: 0 for k in total}
    for c in snaps:
        per_step.append({k: c[k] - prev[k] for k in c})
        prev = c
    cfg = res["cfg"]
    steady = res["step_ms"][1:]
    step_ms = statistics.median(steady)
    flop = _step_floor_flop(cfg, batch, seq)
    floor_ms = flop / PEAK_OPS_PER_S["bfloat16"] * 1e3
    losses = res["losses"]
    n_params = sum(p.numel() for p in _leaves(res["params"]))
    out = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": n_params, "remat": cfg.remat_policy,
           "batch": batch, "seq": seq, "dp_sync": "gspmd",
           "losses": losses, "gnorms": res["gnorms"], "lrs": res["lrs"],
           "step_ms": res["step_ms"], f"step_ms_median_2_{steps}": step_ms,
           "tokens_per_s": res["tokens_per_step"] / (step_ms / 1e3),
           "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
           "launches_per_step": per_step, "launches_total": total,
           "floor_tflop": flop / 1e12, "floor_ms": floor_ms,
           "floor_share": floor_ms / step_ms, "card": state["card"]}
    emit(**{key: out})
    # the roofline's useful work, 6 N D, at the bf16 peak over the step
    model_flop = roofline.model_flops_6nd(
        cfg, ShapeConfig(key, seq, batch, "train"), n_params)
    model_ms = model_flop / roofline.PEAK_FLOPS * 1e3
    emit(model_flops_share={"path": key, "arch": cfg.name, "remat": cfg.remat_policy,
                            "model_flops_6nd_tflop": model_flop / 1e12,
                            "step_ms": step_ms, "share": model_ms / step_ms,
                            "floor_share": floor_ms / step_ms,
                            "peak_flops": roofline.PEAK_FLOPS, "card": state["card"]})
    state[key] = {"launches": total, "step_ms": step_ms, "floor_ms": floor_ms,
                  "model_flops_share": model_ms / step_ms, "losses": losses,
                  "per_step": per_step, "peak_mem_gib": out["peak_mem_gib"]}
    state["trainer"] = res
    assert all(math.isfinite(x) for x in losses), f"non-finite loss {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    for i, c in enumerate(per_step):
        assert c == want, f"step {i + 1}: launches {c}, expected {want}"
    assert len(per_step) == steps
    torch.cuda.synchronize()


def _train_launches(n):
    """The launches per step of a decoder of ``n`` layers with one attention
    and two norms each (qwen2.5-3b, and the internvl2-26b and qwen3-moe
    training phases), remat "full" or "dots" alike: K1 and K2 run again in
    the backward (attention and the norms are recomputed; "dots" keeps only
    the projections' outputs)."""
    return {"flash_attention": 2 * n, "flash_attention_sm90": 2 * n,
            "flash_attention_bwd": n, "flash_attention_bwd_sm90": n,
            "rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1, "rglru_scan": 0,
            "rglru_scan_bwd": 0, "slstm_scan": 0}


def _hybrid_train_launches():
    """recurrentgemma-2b's launches per step: each of the 8 periods (rec,
    rec, attn) runs once forward and once again in the backward, the 2 tail
    blocks (rec, rec) once; K2 twice per block and once before the head."""
    periods, tail, attn, rec = 8, 2, 8, 18
    blocks = 3 * periods + tail
    return {"flash_attention": 2 * attn, "flash_attention_sm90": 2 * attn,
            "flash_attention_bwd": attn, "flash_attention_bwd_sm90": attn,
            "rmsnorm": 2 * blocks + 1 + 2 * 3 * periods, "rmsnorm_bwd": 2 * blocks + 1,
            "rglru_scan": rec + 2 * periods, "rglru_scan_bwd": rec, "slstm_scan": 0}


def phase_train(state):
    """Full qwen2.5-3b through ``launch/train.py --dp-sync gspmd``: six
    steps on one fixed batch, launches counted per step."""
    _run_training(state, "train", TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                  _train_launches(QWEN["layers"]))


def _dots_run(state, key, full_key, arch, batch, seq, want):
    """``full_key``'s run again under remat "dots": the same launches per
    step, and the first loss (before any update) equal to "full"'s to the
    bit, since the forward computes the same values."""
    _run_training(state, key, arch, batch, seq, want, remat="dots")
    got, full = state[key]["losses"], state[full_key]["losses"]
    emit(**{f"{key}_vs_full": {"first_loss_equal": got[0] == full[0],
                               "losses_equal": got == full,
                               "max_loss_diff": max(abs(a - b) for a, b in zip(got, full)),
                               "step_ms": [state[full_key]["step_ms"],
                                           state[key]["step_ms"]],
                               "peak_mem_gib": [state[full_key]["peak_mem_gib"],
                                                state[key]["peak_mem_gib"]]}})
    assert got[0] == full[0], f"first loss {got[0]} under dots, {full[0]} under full"


def phase_train_dots(state):
    """Full qwen2.5-3b as ``phase_train``, remat "dots"."""
    _dots_run(state, "train_dots", "train", TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
              _train_launches(QWEN["layers"]))


def phase_hybrid_train_dots(state):
    """Full recurrentgemma-2b as ``phase_hybrid_train``, remat "dots" per
    period."""
    _dots_run(state, "hybrid_train_dots", "hybrid_train", HYB_ARCH, HYB_TRAIN_BATCH,
              HYB_TRAIN_SEQ, _hybrid_train_launches())


def phase_hybrid_train(state):
    """Full recurrentgemma-2b through ``launch/train.py --dp-sync gspmd``:
    2 x 4096 tokens (twice the window, so the window masks keys), six steps
    on one fixed batch, remat "full" per period."""
    _run_training(state, "hybrid_train", HYB_ARCH, HYB_TRAIN_BATCH, HYB_TRAIN_SEQ,
                  _hybrid_train_launches())


def _leaves(tree):
    from repro_torch.models.registry import leaves

    return leaves(tree)


_GROUPS = (("K1 forward (attn_fwd)", ("attn_fwd",)),
           ("K1 backward (attn_bwd)", ("attn_bwd",)),
           ("K2 (_rmsnorm_kernel)", ("_rmsnorm_kernel",)),
           ("K2 backward (_rmsnorm_bwd_kernel, _rmsnorm_dw_kernel)",
            ("_rmsnorm_bwd_kernel", "_rmsnorm_dw_kernel")),
           ("K3 (rglru_scan_fwd)", ("rglru_scan_fwd",)),
           ("K3 backward (rglru_scan_bwd)", ("rglru_scan_bwd",)),
           ("sLSTM (slstm_scan_kernel)", ("slstm_scan_kernel",)),
           ("GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
           ("copies and dtype casts", ("copy",)))


def _kernel_group(name):
    """The ``_GROUPS`` entry of a kernel's name."""
    key = name.lower()
    return next((g for g, pats in _GROUPS if any(p in key for p in pats)),
                "other kernels (elementwise, reductions)")


def _train_profile(state, arch):
    """One more training step under torch.profiler: card busy time and idle
    share, device time by kernel group (by name) and by the port's
    profiler ranges (each range's total holds the GEMMs it launched)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res = state.pop("trainer")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res["step_fn"](res["params"], res["opt"], res["batch"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    groups = {name: 0.0 for name, _ in _GROUPS}
    groups["other kernels (elementwise, reductions)"] = 0.0
    for e in events:
        if _is_kernel(e, DeviceType):
            groups[_kernel_group(e.key)] += e.self_device_time_total / 1e3
    # a range's kernel time: the device time of the kernels its CPU side
    # launched; its device-side span also holds the gaps between them
    ranges = {e.key: {"kernels_ms": e.device_time_total / 1e3, "calls": e.count}
              for e in events if e.key.startswith("repro_torch.")
              and e.device_type == DeviceType.CPU}
    for e in events:
        if e.key.startswith("repro_torch.") and e.device_type == DeviceType.CUDA:
            ranges.setdefault(e.key, {})["span_ms"] = e.self_device_time_total / 1e3
    emit(profile_train={"arch": arch, "remat": res["cfg"].remat_policy,
                        **_kernel_table(prof, wall, 1),
                        "groups_ms": groups, "ranges": ranges,
                        "card": state["card"]})
    del res
    torch.cuda.empty_cache()


def phase_train_profile(state):
    _train_profile(state, TRAIN_ARCH)


def phase_hybrid_train_profile(state):
    _train_profile(state, HYB_ARCH)


def phase_train_dots_profile(state):
    _train_profile(state, TRAIN_ARCH)


def phase_hybrid_train_dots_profile(state):
    _train_profile(state, HYB_ARCH)


def phase_themis_train(state):
    """qwen2.5-3b at full width cut to 18 layers: two GSPMD steps and two
    Themis steps (one rank, 16 chunks, no collective) from the same seed
    and batch; losses and gnorms within 1e-5 relative, params per leaf
    within 1e-4 of the update's L2 and 1e-2 lr per element. Both sides are
    the port on one card, so these limits come from this phase's own
    readings (2.0e-6 of the update, 4e-4 lr on an H100), with room on
    both sides, not from the CPU comparison against the reference."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import build_model

    argv = _train_argv("--steps", str(THEMIS_STEPS), "--layers",
                       str(THEMIS_LAYERS))
    runs = {}
    final = {}
    for mode in ("gspmd", "themis"):
        torch.cuda.empty_cache()
        res = train.main(argv + ["--dp-sync", mode])
        runs[mode] = {"losses": res["losses"], "gnorms": res["gnorms"],
                      "lrs": res["lrs"], "step_ms": res["step_ms"],
                      "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
                      "orders": sorted({"->".join(o) or "()"
                                        for o in (res["orders"] or [])})}
        final[mode] = [p.detach().cpu() for p in _leaves(res["params"])]
        del res
    torch.cuda.empty_cache()
    cfg = get_arch(TRAIN_ARCH).replace(num_layers=THEMIS_LAYERS)
    gap = _themis_gap(runs, final, build_model(cfg))
    emit(themis_train={"arch": TRAIN_ARCH, "layers": THEMIS_LAYERS,
                       "d_model": cfg.d_model, "chunks": 16,
                       "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, **runs, **gap,
                       "card": state["card"]})
    _themis_gate(gap)


def _themis_gap(runs, final, api):
    """The Themis run against the GSPMD run from the same seed and batch:
    the largest relative gap of their losses and of their gnorms; over
    the param leaves (``final``: each run's, on the host) the largest L2
    of their difference over the L2 of the GSPMD run's update from
    ``api``'s params of seed 0, and the largest element gap over the peak
    lr."""
    import torch

    init = _leaves(api.init(0, "cuda"))
    lr_max = max(runs["gspmd"]["lrs"])
    diff_over_update, max_abs_over_lr = 0.0, 0.0
    for a, b, c in zip(final["themis"], final["gspmd"], init):
        a, b = a.cuda(), b.cuda()
        diff_over_update = max(diff_over_update,
                               ((a - b).norm() / (b - c).norm()).item())
        max_abs_over_lr = max(max_abs_over_lr, (a - b).abs().max().item() / lr_max)
        del a, b
    del init, final
    torch.cuda.empty_cache()
    rel = {k: max(abs(x - y) / abs(y) for x, y in zip(runs["themis"][k],
                                                       runs["gspmd"][k]))
           for k in ("losses", "gnorms")}
    return {"rel_diff": rel, "params_diff_over_update": diff_over_update,
            "params_max_abs_over_lr": max_abs_over_lr}


def _themis_gate(gap):
    """``phase_themis_train``'s limits on ``_themis_gap``'s readings."""
    rel = gap["rel_diff"]
    assert rel["losses"] <= 1e-5 and rel["gnorms"] <= 1e-5, rel
    assert gap["params_diff_over_update"] <= 1e-4 and gap["params_max_abs_over_lr"] <= 1e-2, gap


def phase_sharded_train(state):
    """qwen2.5-3b at full width cut to THEMIS_LAYERS layers, TRAIN_BATCH x
    TRAIN_SEQ: SHARDED_STEPS single-device GSPMD steps through
    ``launch/train.py``, freed, then the same command on a one-rank
    (data 1, model 1) mesh over an NCCL group, which runs the sharded step
    (DTensor params, m and v, the batch on ``batch_pspec``) from the same
    seed and batch. Losses and gnorms within 1e-5 relative, params per leaf
    within ``phase_themis_train``'s limits (1e-4 of the update's L2, 1e-2 lr
    per element), the launch counts equal; the step ms of both printed.
    Then the GPipe loss (``train/pipeline.py``) of one "pipe" stage at
    n_micro=4 on the same weights and batch, held to ``loss_fn`` within 1e-3
    relative (bf16 activations)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.sharding.specs import gather
    from repro_torch.train.pipeline import make_pipeline_loss, stage_split_params

    argv = _train_argv("--steps", str(SHARDED_STEPS), "--layers",
                       str(THEMIS_LAYERS), "--dp-sync", "gspmd")
    runs, final = {}, {}

    def run(name):
        torch.cuda.empty_cache()
        reset_launch_counts()
        res = train.main(argv)
        runs[name] = {"losses": res["losses"], "gnorms": res["gnorms"],
                      "lrs": res["lrs"], "step_ms": res["step_ms"],
                      "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
                      "launches": launch_counts()}
        final[name] = [p.detach().cpu() for p in _leaves(gather(res["params"]))]

    run("single_device")
    with _one_rank_mesh():
        run("sharded")
    torch.cuda.empty_cache()
    cfg = get_arch(TRAIN_ARCH).replace(num_layers=THEMIS_LAYERS)
    api = build_model(cfg)
    params = api.init(0, "cuda")
    init = [p.detach().cpu() for p in _leaves(params)]
    lr_max = max(runs["single_device"]["lrs"])
    diff_over_update, max_abs_over_lr = 0.0, 0.0
    for a, b, c in zip(final["sharded"], final["single_device"], init):
        diff_over_update = max(diff_over_update,
                               ((a - b).norm() / (b - c).norm()).item())
        max_abs_over_lr = max(max_abs_over_lr, (a - b).abs().max().item() / lr_max)
    del init, final
    rel = {k: max(abs(x - y) / abs(y) for x, y in zip(runs["sharded"][k],
                                                       runs["single_device"][k]))
           for k in ("losses", "gnorms")}
    # the one-stage pipeline on the initial weights and the run's batch
    b = SyntheticLM(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0)
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device="cuda")
             for k, v in b.items()}
    with _one_rank_mesh(("pipe",)) as mesh, torch.no_grad():
        sp = stage_split_params(params, 1, 0)
        pipe = float(make_pipeline_loss(cfg, mesh, 4)(sp, batch["tokens"],
                                                      batch["labels"]))
        plain = float(api.loss_fn(params, batch))
    del params, sp
    torch.cuda.empty_cache()
    pipe_rel = abs(pipe - plain) / abs(plain)
    emit(sharded_train={"arch": TRAIN_ARCH, "layers": THEMIS_LAYERS,
                        "d_model": cfg.d_model, "batch": TRAIN_BATCH,
                        "seq": TRAIN_SEQ, "mesh": "1x1", **runs,
                        "rel_diff": rel,
                        "params_diff_over_update": diff_over_update,
                        "params_max_abs_over_lr": max_abs_over_lr,
                        "pipeline": {"n_micro": 4, "stages": 1, "loss": pipe,
                                     "loss_fn": plain, "rel_diff": pipe_rel},
                        "card": state["card"]})
    assert rel["losses"] <= 1e-5 and rel["gnorms"] <= 1e-5, rel
    assert diff_over_update <= 1e-4 and max_abs_over_lr <= 1e-2, (
        diff_over_update, max_abs_over_lr)
    assert runs["sharded"]["launches"] == runs["single_device"]["launches"], runs
    assert pipe_rel <= 1e-3, (pipe, plain)


def phase_ckpt_resume(state):
    """Checkpoints through ``launch/train.py --ckpt-dir`` on the card:
    qwen2.5-3b at full width cut to CKPT_LAYERS layers (0.47 B params; its
    params, m and v 5.6 GB), CKPT_BATCH x TRAIN_SEQ tokens, a new batch at
    every step, CKPT_STEPS steps. Run 1 trains without checkpoints; run 2
    trains the same and writes checkpoints 2 and 4 into a temporary
    directory; their distance is the card's own run-to-run gap. Then
    checkpoint 4 is deleted (the manifest is ahead of the data, as after a
    crash mid-write), and run 3, the same command in a fresh trainer,
    restores checkpoint 2 onto the card and trains steps 3-4: its losses and
    final params must lie within the gap of run 1's. Prints the bytes
    written and the seconds of the host copies, the waits, the writes and
    the restore; deletes the directory."""
    import tempfile

    import torch

    from repro_torch.ckpt import latest_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    argv = ["--arch", TRAIN_ARCH, "--layers", str(CKPT_LAYERS), "--batch",
            str(CKPT_BATCH), "--seq", str(TRAIN_SEQ), "--steps", str(CKPT_STEPS),
            "--log-every", "1", "--device", "cuda"]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ck = argv + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]

    def run(args):
        torch.cuda.empty_cache()
        res = train.main(args)
        out = {k: res[k] for k in ("losses", "start_step", "restored", "checkpoints",
                                   "checkpoint_final_wait_s", "step_ms")}
        out["params"] = [p.detach().cpu() for p in _leaves(res["params"])]
        return out

    try:
        whole = run(argv)
        saved = run(ck)
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{CKPT_STEPS:08d}"))
        fallback = latest_step(ckpt_dir)
        reset_launch_counts()
        resumed = run(ck)
        counts = launch_counts()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    def dist(a, b):
        return {"loss": max(abs(x - y) for x, y in zip(a["losses"], b["losses"])),
                "params": max((x - y).abs().max().item()
                              for x, y in zip(a["params"], b["params"]))}

    gap = dist(saved, whole)
    tail = {"losses": whole["losses"][2:], "params": whole["params"]}
    got = dist(resumed, tail)
    emit(ckpt_resume={
        "arch": TRAIN_ARCH, "layers": CKPT_LAYERS, "batch": [CKPT_BATCH, TRAIN_SEQ],
        "params": sum(p.numel() for p in whole["params"]),
        "losses": {"whole": whole["losses"], "with_checkpoints": saved["losses"],
                   "resumed": resumed["losses"]},
        "checkpoints_written": saved["checkpoints"],
        "final_wait_s": saved["checkpoint_final_wait_s"],
        "fallback_step": fallback, "restored": resumed["restored"],
        "start_step": resumed["start_step"], "run_to_run_gap": gap,
        "resumed_vs_whole": got, "launches_resumed": counts, "card": state["card"]})
    assert fallback == 2 and resumed["restored"]["step"] == 2, (fallback, resumed)
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == CKPT_STEPS - 2
    assert got["loss"] <= gap["loss"] and got["params"] <= gap["params"], (got, gap)
    assert counts["flash_attention_sm90"] > 0 and counts["flash_attention_bwd_sm90"] > 0
    assert counts["rmsnorm"] > 0 and counts["rmsnorm_bwd"] > 0, counts


def _train_card_vs_cpu(arch, seq, cfg_kw=None):
    """The reduced ``arch`` (config fields replaced by ``cfg_kw``; head dim
    16: K1's forward and backward take the SIMT kernels) with the same
    weights and batch on the card and on the CPU: the loss and every leaf's
    gradient, relative L2 within 1e-4 with fp32 activations; with bf16
    within 3e-2, or the CPU's own distance between its bf16 and fp32
    gradients where that is larger. The audio and VLM families' batches
    carry their stub frames or patches (bf16 standard normals). A MoE's
    bf16 run is compared only where every layer's routing ids agree on the
    two devices (a near-tie of two gates may round apart). Returns the
    launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model, moe

    base = get_arch(arch, reduced=True).replace(**(cfg_kw or {}))
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, base.vocab_size, (2, seq)))
             for k in ("tokens", "labels")}
    extra = {"audio": ("frames", base.num_frames),
             "vlm": ("patches", base.num_patches)}.get(base.family)
    if extra:
        name, n = extra
        batch[name] = torch.as_tensor(
            rng.standard_normal((2, n, base.d_model))).to(torch.bfloat16)
    p_cpu = build_model(base).init(0, device="cpu")

    def copy(tree, dev):
        if isinstance(tree, dict):
            return {k: copy(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [copy(v, dev) for v in tree]
        return tree.detach().to(dev, copy=True).requires_grad_(True)

    def grads(cfg, dev):
        """(loss, the leaves' gradients in fp32 on the CPU, the routing ids
        of every MoE call in order, the backward's recomputes included)."""
        params = copy(p_cpu, dev)
        leaves = _leaves(params)
        ids, orig = [], moe.route

        def route(p, x, c):
            res = orig(p, x, c)
            ids.append(res[1].cpu())
            return res

        moe.route = route
        try:
            loss = build_model(cfg).loss_fn(params, {k: v.to(dev)
                                                     for k, v in batch.items()})
            gs = torch.autograd.grad(loss, leaves)
        finally:
            moe.route = orig
        return loss.item(), [g.cpu().float() for g in gs], ids

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    out, fails = {}, []
    cpu32 = grads(base.replace(dtype="float32"), "cpu")
    reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dtype)
        gl, gg, g_ids = grads(cfg, "cuda")
        cl, cg, c_ids = cpu32 if dtype == "float32" else grads(cfg, "cpu")
        rels = [rel(a, b) for a, b in zip(gg, cg)]
        if dtype == "float32":
            tols = [1e-4] * len(rels)
        else:
            tols = [max(3e-2, rel(a, b)) for a, b in zip(cg, cpu32[1])]
        routes_agree = (len(g_ids) == len(c_ids)
                        and all(torch.equal(a, b) for a, b in zip(g_ids, c_ids)))
        out[dtype] = {"loss_card": gl, "loss_cpu": cl,
                      "loss_rel": abs(gl - cl) / abs(cl),
                      "grad_rel_l2": rels, "tols": tols}
        if g_ids:
            out[dtype]["routing_ids_agree"] = routes_agree
            out[dtype]["routing_calls"] = len(g_ids)
        if dtype == "bfloat16" and not routes_agree:
            out[dtype]["compared"] = False   # a routing split: not the same function
            continue
        if out[dtype]["loss_rel"] > min(tols):
            fails.append(f"{dtype} loss {gl} vs {cl}")
        fails += [f"{dtype} leaf {i}: {r} > {t}" for i, (r, t) in
                  enumerate(zip(rels, tols)) if r > t]
    counts = launch_counts()
    emit(train_card_vs_cpu={"arch": f"{arch} reduced", "batch": [2, seq],
                            "extra": sorted(set(batch) - {"tokens", "labels"}),
                            "cfg_kw": cfg_kw, **out, "launches": counts})
    assert not fails, fails
    assert out["float32"].get("routing_ids_agree", True), "fp32 routing split"
    attends = base.family != "ssm"
    assert (counts["flash_attention"] > 0) == attends and counts["flash_attention_sm90"] == 0, (
        f"reduced {arch}: K1 launches {counts}, expected SIMT only")
    assert ((counts["flash_attention_bwd"] > 0) == attends
            and counts["flash_attention_bwd_sm90"] == 0), (
        f"reduced {arch}: K1 backward launches {counts}, expected SIMT only")
    assert counts["rmsnorm"] > 0 and counts["rmsnorm_bwd"] > 0
    return counts


def phase_train_card_vs_cpu(state):
    _train_card_vs_cpu(TRAIN_ARCH, 64)


def phase_hybrid_train_card_vs_cpu(state):
    """Reduced recurrentgemma-2b: 64 tokens cross its window of 32, and K3
    and its backward launch."""
    counts = _train_card_vs_cpu(HYB_ARCH, 64)
    assert counts["rglru_scan"] > 0 and counts["rglru_scan_bwd"] > 0, counts


# -- the shape cells --------------------------------------------------------------
def _cell_share(shape):
    """(batch, seq) of a shape cell (``configs/base.py``) at one card's
    share: one data replica of the dry run's 16x16 mesh."""
    return max(shape.global_batch // CELL_REPLICAS, 1), shape.seq_len


def _cell_teacher_forcing(run, prompt):
    """Row 0's first decode logits (``_serve``'s full warm-up) against the
    last logits of a batch-1 prefill over the prompt and the token that
    step was fed: (relative L2, max abs error)."""
    import torch

    server, first = run["server"], run["first_step"]
    if first is None:
        return _prefix_teacher_forcing(run, prompt)
    toks = torch.cat([run["tokens"][:1], first["ids"][:1, :1]], dim=1)
    logits, caches = server.prefill(server.params, {"tokens": toks}, prompt + 1)
    want, got = logits[0, -1].float(), first["logits"][0, 0]
    del logits, caches
    torch.cuda.empty_cache()
    return ((got - want).norm() / want.norm()).item(), _max_err(got, want)


def _prefix_teacher_forcing(run, prompt):
    """Teacher forcing where ``_serve`` ran no full warm-up: row 0's last
    prefill logits in the counted run against a decode step of its last
    prompt token from a batch-1 prefill over the tokens before it:
    (relative L2, max abs error)."""
    import torch

    server = run["server"]
    toks = run["tokens"][:1]
    _, caches = server.prefill(server.params, {"tokens": toks[:, :-1]}, prompt)
    step, _ = server.decode(server.params, caches, toks[:, -1], prompt - 1)
    got, want = step[0, 0].float(), run["prefill_logits"][0, -1]
    del step, caches
    torch.cuda.empty_cache()
    return ((got - want).norm() / want.norm()).item(), _max_err(got, want)


def _serve_cell(state, name, arch, shape, expect, limit, *, full_warmup=True,
                on_reset=None, before_tf=None):
    """A serving cell at one card's share through ``_serve`` with a full
    warm-up (``full_warmup``; without it, a short one), its launches per step
    held to ``expect``, ``on_reset`` passed on; then ``before_tf()``, where
    given, and teacher forcing at ``limit`` (``_cell_teacher_forcing``).
    Prints the cell's line; keeps the run (with its server)."""
    b, s = _cell_share(shape)
    run = _serve(state, arch, s, expect, rows=b, full_warmup=full_warmup,
                 on_reset=on_reset)
    state[name] = run
    if before_tf:
        before_tf()
    rel, err = _cell_teacher_forcing(run, s)
    pre, dec = run["per_step"][0][1], run["per_step"][1][1]
    emit(cell={"cell": name, "arch": arch, "layers": run["server"].cfg.num_layers,
               "batch": b, "global_batch": shape.global_batch, "prompt_len": s, "gen": GEN,
               "decode_positions": [s, s + GEN - 1], "prefill_ms": run["prefill_ms"],
               "decode_ms_per_token": run["decode_ms_per_token"],
               "decode_tokens_per_s": b * 1e3 / run["decode_ms_per_token"],
               "peak_gib": run["peak_gib"], "launches_prefill": pre,
               "launches_per_decode_step": dec,
               "teacher_forcing": {"rel_l2": rel, "max_abs_err": err, "limit": limit,
                                   "tokens": s + 1},
               "cut": None, "card": state["card"]})
    assert rel <= limit, f"{name}: teacher forcing rel L2 {rel} > {limit}"


def phase_prefill_32k(state):
    """prefill_32k at one card's share: llama3-8b whole, 2 x 32,768 (a global
    batch of 32 over 16 replicas) through ``serve.setup`` and
    ``serve.generate`` after a warm-up of the same batch and one step, then
    16 greedy decode steps over the 32,784-position cache: K1 32 per
    prefill, all sm90, none per decode step; K2 65 per step. Teacher
    forcing at ``phase_teacher_forcing``'s 3e-2. Keeps the server for
    ``phase_decode_32k``."""
    from repro_torch.configs.base import PREFILL_32K

    assert _cell_share(PREFILL_32K) == (P32K_B, P32K_S)
    _serve_cell(state, "prefill_32k", ARCH, PREFILL_32K, _dense_launches(32), 3e-2)


def _fill_cache(prefill, params, cfg, tokens, max_len, group):
    """A cache of ``max_len`` positions for every row of ``tokens``, filled
    by prefilling ``group`` rows at a time and copying each group's rows in
    (the whole batch's prefill temporaries do not fit beside the cache):
    (cache, each row's last prefill logits)."""
    import torch

    from repro_torch.models.transformer import init_cache

    b = tokens.shape[0]
    with torch.inference_mode():
        cache = init_cache(cfg, b, max_len, device="cuda")
        last = []
        for i in range(0, b, group):
            logits, part = prefill(params, {"tokens": tokens[i:i + group]}, max_len)
            for k, v in cache.items():
                v[:, i:i + group].copy_(part[k])
            last.append(logits[:, -1].float())
            del logits, part
    return cache, torch.cat(last)


def _planted_quantize(x, rnd):
    """``models/transformer.py::_kv_quantize`` with ``rnd`` in place of its
    round-half-to-even: a planted fault for the int8 gates."""
    import torch

    scale = torch.clamp(x.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(rnd(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _int8_code_error(codes, scales, x):
    """Int8 codes against the values ``x`` they encode, in units of each
    position's scale, e = code - x / scale: (rms of e, the bias mean(e *
    sign(x)), whether both lie within INT8_CODE_LIMITS)."""
    import torch

    e = codes.float() - x.float() / scales.float()[..., None]
    rms = e.square().mean().sqrt().item()
    bias = (e * torch.sign(x.float())).mean().item()
    rms_limit, bias_limit = INT8_CODE_LIMITS
    return rms, bias, rms <= rms_limit and abs(bias) <= bias_limit


def _int8_code_gate(cache, x0, s):
    """Layer 0 of the int8 ``cache`` against ``x0``, the bf16 cache's layer
    0 (k and v of the same prompts, which the cache's type does not reach),
    over the prompt's ``s`` positions: the sound codes within
    INT8_CODE_LIMITS, the same values quantised with a truncating and a
    flooring round beyond them. Returns the readings."""
    import torch

    out = {}
    for key, x in x0.items():
        out[key] = _int8_code_error(cache[key][0, :, :s], cache[key + "_scale"][0, :, :s], x)
        for name, rnd in (("trunc", torch.trunc), ("floor", torch.floor)):
            out[f"{key} {name}"] = _int8_code_error(*_planted_quantize(x, rnd), x)
    bad = [k for k, r in out.items() if r[2] != (" " not in k)]
    assert not bad, f"int8 codes: {bad} on the wrong side of {INT8_CODE_LIMITS}: {out}"
    return out


def phase_decode_32k(state):
    """decode_32k at one card's share: llama3-8b whole (the served params of
    ``phase_prefill_32k``), 8 rows (128 / 16) of 32,768-token prompts in a
    cache of 32,784 positions, once with the bf16 cache (32.0 GiB) and
    once with the int8 cache of ``kv_quant`` (16.3 GiB), the same params,
    each filled a row at a time (so layer 0's k and v are the same bits
    in both). Each cache's first decode step
    is fed the bf16 prompts' greedy tokens, its logits compared across the
    caches (relative L2 within INT8_VS_BF16_LIMIT, a planted fault beyond
    it) and the int8 codes of layer 0 held to the bf16 cache's values
    (``_int8_code_gate``); then 16 greedy steps at positions
    32,768-32,783 timed with CUDA events, launches per step K1 0 and K2
    65; one more step profiled (busy share)."""
    import torch

    from repro_torch.configs.base import DECODE_32K
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.train.serve import make_serve_fns

    b, s = _cell_share(DECODE_32K)
    assert (b, s) == (D32K_B, P32K_S)
    server = (state.get("prefill_32k", {}).pop("server", None)
              or serve.setup(ARCH, device="cuda", seed=0))
    torch.cuda.empty_cache()
    tokens = serve.synthetic_batch(server.cfg, b, s, seed=1, device="cuda")["tokens"]
    max_len, want = s + GEN, _dense_launches(32)["decode"]
    first, tok0 = {}, None
    for kv_quant in (False, True):
        cfg = server.cfg.replace(kv_quant=kv_quant)
        prefill, decode = make_serve_fns(build_model(cfg), "cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cache, last = _fill_cache(prefill, server.params, cfg, tokens, max_len, 1)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        cache_gib = sum(v.numel() * v.element_size() for v in cache.values()) / 2**30
        if kv_quant:
            codes = _int8_code_gate(cache, x0, s)
            del x0
        else:
            x0 = {k: cache[k][0, :, :s].clone() for k in ("k", "v")}
        if tok0 is None:
            tok0 = last.argmax(-1)
        del last
        torch.cuda.empty_cache()
        # warm-up; the step returns the cache, so take the logits alone
        first[kv_quant] = decode(server.params, cache, tok0, s)[0][:, 0].float()
        snaps = []
        reset_launch_counts()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        tok = tok0
        t0.record()
        for i in range(GEN):
            tok = decode(server.params, cache, tok, s + i)[0][:, 0].argmax(-1)
            snaps.append(launch_counts())
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1) / GEN
        per_step = [{k: c[k] - p.get(k, 0) for k in c} for p, c in zip([{}] + snaps, snaps)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = _profile_step(lambda _: decode(server.params, cache, tok, s + GEN - 1), None)
        if kv_quant:
            # a planted fault the logits gate must catch: every position's
            # codes read with the previous position's scales
            rolled = {**cache, **{k: torch.roll(cache[k], 1, dims=2)
                                  for k in ("k_scale", "v_scale")}}
            planted = decode(server.params, rolled, tok0, s)[0][:, 0].float()
            del rolled
        name = "decode_32k " + ("int8" if kv_quant else "bf16")
        emit(cell={"cell": name, "arch": ARCH,
                   "kv_cache": "int8 codes, bf16 scales" if kv_quant else "bf16",
                   "batch": b, "global_batch": DECODE_32K.global_batch, "prompt_len": s,
                   "cache_positions": max_len, "gen": GEN,
                   "decode_positions": [s, s + GEN - 1], "fill_group": 1,
                   "fill_seconds": fill_s, "cache_gib": cache_gib,
                   "decode_ms_per_token": ms, "decode_tokens_per_s": b * 1e3 / ms,
                   "peak_gib": peak, "launches_per_decode_step": per_step[0],
                   "profiled_step": prof, "busy_share": 1.0 - prof["idle_share"],
                   "cut": None, "card": state["card"]})
        state[name] = {"ms": ms, "peak_gib": peak, "busy_share": 1.0 - prof["idle_share"],
                       "launches": snaps[-1]}
        assert all(c == want for c in per_step), f"{name}: launches {per_step}, expected {want}"
        del cache, prefill, decode
        torch.cuda.empty_cache()
    rel, planted_rel = (((x - first[False]).norm() / first[False].norm()).item()
                        for x in (first[True], planted))
    emit(int8_vs_bf16={"arch": ARCH, "rows": b, "position": s, "rel_l2": rel,
                       "max_abs_err": _max_err(first[True], first[False]),
                       "limit": INT8_VS_BF16_LIMIT,
                       "planted_scales_one_position_off_rel_l2": planted_rel,
                       "layer0_codes_rms_bias_ok": codes, "code_limits": INT8_CODE_LIMITS,
                       "card": state["card"]})
    del server, first, planted
    torch.cuda.empty_cache()
    assert rel <= INT8_VS_BF16_LIMIT < planted_rel, \
        f"int8 vs bf16 cache: rel L2 {rel}, planted fault {planted_rel}"


def phase_long_500k(state):
    """long_500k at one card's share: recurrentgemma-2b whole, 1 x 524,288
    (a global batch of 1) through ``serve.setup`` and ``serve.generate``
    after a warm-up of the same prompt and one step; the hybrid's prefill
    keeps its ring buffer of 2,048 slots (it wraps 256 times) and the
    RG-LRU states; 16 decode steps from position 524,288. K1 8 per prefill
    (windowed, all sm90), K3 18, K2 53 per step. Teacher forcing at the
    hybrid's bf16 bound of 1e-1 (``phase_hybrid_teacher_forcing``)."""
    import torch

    from repro_torch.configs.base import LONG_500K

    assert _cell_share(LONG_500K) == (1, L500K_S)
    torch.cuda.empty_cache()
    try:
        _serve_cell(state, "long_500k", HYB_ARCH, LONG_500K, _hybrid_launches(), 1e-1)
    finally:
        state.get("long_500k", {}).pop("server", None)
        torch.cuda.empty_cache()


def phase_long_500k_xlstm(state):
    """long_500k at one card's share for xlstm-1.3b: whole (48 blocks), 1 x
    524,288 (a global batch of 1), nothing cut, through ``serve.setup`` and
    ``serve.generate`` after a short warm-up (64 tokens, 2 steps: a full one
    would add a third prefill): each mLSTM block runs 2,048 chunks of 256,
    32 at a time, each sLSTM block's 524,288 steps are one kernel launch;
    16 decode steps from position 524,288. K2 97 and the sLSTM kernel
    6 per prefill and per decode step. Teacher forcing at the reference's
    bf16 bound of 1e-1 (``phase_xlstm_checks``), by
    ``_prefix_teacher_forcing``. CUDA events around each mLSTM chunk loop and
    each sLSTM kernel call of the counted prefill split its time
    (``_XlstmSpans``); the card's busy share comes from a prefill of
    XLSTM_PROFILE_S tokens under ``_profile_step`` (reading back the whole
    prompt's launches from the profiler took minutes)."""
    import torch

    from repro_torch.configs.base import LONG_500K

    assert _cell_share(LONG_500K) == (1, L500K_S)
    torch.cuda.empty_cache()
    spans = _XlstmSpans()
    try:
        with spans:
            _serve_cell(state, "long_500k_xlstm", XLSTM, LONG_500K, _xlstm_launches(), 1e-1,
                        full_warmup=False, on_reset=spans.start, before_tf=spans.stop)
            run = state["long_500k_xlstm"]
            split = spans.summary(run["prefill_ms"])
            server, toks = run["server"], run["tokens"][:, :XLSTM_PROFILE_S]
            spans.start()
            prof = _profile_step(lambda _: server.prefill(
                server.params, {"tokens": toks}, XLSTM_PROFILE_S), None)
            spans.stop()
        emit(long_500k_xlstm_prefill={
            "prompt_len": L500K_S, "prefill_ms": run["prefill_ms"], **split,
            "profiled": {"prompt_len": XLSTM_PROFILE_S, "wall_ms": prof["wall_ms_per_step"],
                         "busy_ms": prof["device_busy_ms_per_step"],
                         "busy_share": 1 - prof["idle_share"],
                         "device_launches": prof["device_launches_per_step"],
                         **spans.summary(prof["wall_ms_per_step"]),
                         "groups_ms": prof["groups_ms"], "top": prof["top"][:8]},
            "card": state["card"]})
    finally:
        state.get("long_500k_xlstm", {}).pop("server", None)
        torch.cuda.empty_cache()


class _XlstmSpans:
    """While open, CUDA events around each mLSTM chunk loop
    (``models/xlstm.py::_mlstm_chunk_scan``) and each sLSTM kernel call of
    more than one step (``kernels.slstm.slstm_scan``), recorded between
    ``start()`` and ``stop()``. ``summary(wall_ms)``: the device-timeline ms
    between each pair, summed by kind, and their shares of ``wall_ms`` (the
    host-bound chunk loop's span is its host time; the kernel's its device
    time)."""

    def __init__(self):
        self.on, self.spans = False, {"mlstm_chunk_loop": [], "slstm_kernel": []}

    def start(self):
        self.on = True
        for v in self.spans.values():
            v.clear()

    def stop(self):
        self.on = False

    def _timed(self, key, fn, steps):
        import torch

        def call(*a, **kw):
            if not (self.on and steps(*a) > 1):
                return fn(*a, **kw)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            res = fn(*a, **kw)
            e1.record()
            self.spans[key].append((e0, e1))
            return res
        return call

    def __enter__(self):
        from repro_torch.kernels import slstm as sl
        from repro_torch.models import xlstm as txl

        self.saved = txl._mlstm_chunk_scan, sl.slstm_scan
        txl._mlstm_chunk_scan = self._timed("mlstm_chunk_loop", self.saved[0],
                                            lambda q, *_: q.shape[1])
        sl.slstm_scan = self._timed("slstm_kernel", self.saved[1], lambda gx, *_: gx.shape[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import slstm as sl
        from repro_torch.models import xlstm as txl

        txl._mlstm_chunk_scan, sl.slstm_scan = self.saved

    def summary(self, wall_ms):
        ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.spans.items()}
        return {"spans_ms": ms, "span_calls": {k: len(v) for k, v in self.spans.items()},
                "span_shares": {k: v / wall_ms for k, v in ms.items()}}


def phase_train_4k(state):
    """train_4k at one card's share: qwen2.5-3b whole, 16 x 4096 (256 / 16)
    on one fixed batch, gradients accumulated over ``pick_microbatch``'s
    slices (computed here for one data replica, {"data": 16, "model": 1}:
    8 slices of 2 rows), T4K_STEPS steps through ``launch/train.py
    --microbatch`` with ``--dp-sync gspmd`` (launches per step 8x a step of
    2 rows; one more step profiled), then with ``--dp-sync themis`` from the
    same seed and batch, held to the GSPMD run at ``phase_themis_train``'s
    limits."""
    import statistics

    import torch

    from repro_torch.configs import ParallelConfig, get_arch
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import pick_microbatch
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    b, s = _cell_share(TRAIN_4K)
    cfg = get_arch(TRAIN_ARCH)
    axes = {"data": CELL_REPLICAS, "model": 1}
    mb = pick_microbatch(cfg, TRAIN_4K, axes, ParallelConfig(data=CELL_REPLICAS))
    carry = cfg.num_layers * b * s * cfg.d_model * 2
    emit(train_4k_microbatch={"arch": TRAIN_ARCH, "mesh": axes, "batch": b, "seq": s,
                              "carry_bytes": carry, "target_bytes": 2 * 2**30,
                              "microbatch": mb, "rows_per_slice": b // mb})
    assert (b, s, b // mb) == (T4K_B, T4K_S, T4K_ATTN[0])
    want = {k: v * mb for k, v in _train_launches(QWEN["layers"]).items()}
    extra = ("--microbatch", str(mb))
    _run_training(state, "train_4k", TRAIN_ARCH, b, s, want, steps=T4K_STEPS, extra=extra)
    runs, final = {}, {}
    res = state["trainer"]
    runs["gspmd"] = {k: res[k] for k in ("losses", "gnorms", "lrs", "step_ms")}
    final["gspmd"] = [p.detach().cpu() for p in _leaves(res["params"])]
    # one more GSPMD step profiled from the raw CUDA events (the profiler's
    # Python event tree of a step of 8 slices takes long to build)
    prof = _profile_step(lambda b: res["step_fn"](res["params"], res["opt"], b), res["batch"])
    emit(profile_train={"arch": TRAIN_ARCH, "cell": "train_4k", **prof, "card": state["card"]})
    del res, state["trainer"]
    torch.cuda.empty_cache()
    snaps = []
    reset_launch_counts()
    res = train.main(_train_argv("--steps", str(T4K_STEPS), "--dp-sync", "themis", *extra,
                                 batch=b, seq=s),
                     on_step=lambda step, m: snaps.append(launch_counts()))
    runs["themis"] = {k: res[k] for k in ("losses", "gnorms", "lrs", "step_ms")}
    themis_peak = res["peak_mem_bytes"] / 2**30
    final["themis"] = [p.detach().cpu() for p in _leaves(res["params"])]
    del res
    torch.cuda.empty_cache()
    per_step = [{k: c[k] - p.get(k, 0) for k in c} for p, c in zip([{}] + snaps, snaps)]
    gap = _themis_gap(runs, final, build_model(cfg))
    del final
    run = state["train_4k"]
    themis_ms = statistics.median(runs["themis"]["step_ms"][1:])
    emit(cell={"cell": "train_4k", "arch": TRAIN_ARCH, "layers": cfg.num_layers, "batch": b,
               "global_batch": TRAIN_4K.global_batch, "seq": s, "microbatch": mb,
               "steps": T4K_STEPS,
               "gspmd": {"step_ms_median_2_on": run["step_ms"],
                         "tokens_per_s": b * s * 1e3 / run["step_ms"],
                         "model_flops_6nd_share": run["model_flops_share"],
                         "floor_share": run["floor_ms"] / run["step_ms"],
                         "peak_gib": run["peak_mem_gib"],
                         "launches_per_step": run["per_step"][0],
                         "busy_share_profiled_step": 1.0 - prof["idle_share"],
                         "losses": runs["gspmd"]["losses"]},
               "themis": {"step_ms_median_2_on": themis_ms,
                          "tokens_per_s": b * s * 1e3 / themis_ms, "peak_gib": themis_peak,
                          "launches_per_step": per_step[0],
                          "losses": runs["themis"]["losses"], **gap},
               "cut": None, "card": state["card"]})
    state["train_4k"].update(themis_step_ms=themis_ms, themis_peak_gib=themis_peak,
                             busy_share=1.0 - prof["idle_share"], microbatch=mb)
    assert all(c == want for c in per_step), f"themis launches {per_step}, expected {want}"
    _themis_gate(gap)


# -- phase 6 ---------------------------------------------------------------------
def _n_sets(set_bytes):
    """Input sets to cycle so that together they hold twice the L2."""
    return max(4, math.ceil(2 * L2_BYTES / set_bytes))


def _time_ms(fn, inputs, iters, *, queued=True, warmup=3):
    """Mean ms per call over ``iters`` calls cycling through ``inputs`` (at
    least ``_n_sets`` of them, twice the L2 in all, so each call reads its
    inputs cold; the ``warmup`` calls use the last sets, the timed calls
    start at the first).

    ``queued``: a sleep kernel holds the card while the host enqueues every
    call, so the events time the card alone; without it they also count the
    gaps where the card waits for the host to launch the next call."""
    import torch

    for i in range(1, warmup + 1):
        fn(*inputs[-i])
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
    t0.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


PATH_NAME = {ARCH: ARCH, HYB_ARCH: HYB_ARCH, "train": f"train {TRAIN_ARCH}",
             "hybrid_train": f"train {HYB_ARCH}", DENSE14B: DENSE14B,
             GRANITE: f"{GRANITE} ({GRANITE_LAYERS} of 88 layers)",
             MOE16B: MOE16B, QWEN3MOE: f"{QWEN3MOE} ({QWEN3MOE_LAYERS} of 94 layers)",
             VLM: f"{VLM} ({VLM_LAYERS} of 48 layers)",
             "whisper_enc": f"{WHISPER} encoder", "whisper_cross": f"{WHISPER} cross",
             "whisper_self": f"{WHISPER} decoder self", WHISPER: WHISPER,
             XLSTM: XLSTM,
             "moe16b_train": f"train {MOE16B} ({MOE_TRAIN['layers']} of 28 layers)",
             "whisper_train": f"train {WHISPER}",
             "vlm_train": f"train {VLM} ({VLM_TRAIN_LAYERS} of 48 layers, 256 patches)",
             "qwen3moe_train": f"train {QWEN3MOE} ({QWEN3MOE_TRAIN_LAYERS} of 94 layers, "
                               "bf16 params)",
             "xlstm_train": f"train {XLSTM} ({XLSTM_TRAIN_BLOCKS} of 48 blocks)",
             "prefill_32k": f"{ARCH} prefill_32k ({P32K_B} x {P32K_S})",
             "decode_32k": f"{ARCH} decode_32k ({D32K_B} rows, bf16 cache of "
                           f"{P32K_S + CELL_GEN} positions)",
             "long_500k": f"{HYB_ARCH} long_500k (1 x {L500K_S})",
             "long_500k_xlstm": f"{XLSTM} long_500k (1 x {L500K_S})",
             "train_4k": f"train {TRAIN_ARCH} train_4k ({T4K_B} x {T4K_S}, "
                         "8 microbatches)"}
ERR_SUFFIX = {ARCH: "", HYB_ARCH: "_hybrid", "train": "_train",
              "hybrid_train": "_hybrid_train", DENSE14B: "_qwen14b",
              GRANITE: "_granite", MOE16B: "_moe16b", QWEN3MOE: "_qwen3moe",
              VLM: "_vlm", "whisper_enc": "_whisper_enc",
              "whisper_cross": "_whisper_cross", "whisper_self": "_whisper_self",
              WHISPER: "_whisper", XLSTM: "_xlstm", "moe16b_train": "_moe16b_train"}


def _time_flash(state, gen, path, b, s, h, kvh, d, t, window, iters, causal=True,
                launches=None, err_key=None, plain_rows=0, no_library=None):
    """K1's row at q (b,s,h,d), k/v (b,t,kvh,d), bf16, ``causal`` (SDPA then
    runs with ``is_causal`` alike), ``window``: the sm90 kernel that the
    serving path runs, and beside it the earlier SIMT kernel at the same
    shape (``previous_ms``, launched directly through its route; not on
    the main path). ``launches``: the path's launches at this shape, where
    the path runs K1 at more than one (else all of the path's); ``err_key``:
    the check's key in ``state["serving_err"]`` (else the path's).

    At the shape cells' lengths, whose whole score matrix does not fit the
    card: ``plain_rows`` > 0 times the plain version's arithmetic over
    blocks of that many query rows and the keys each sees
    (``_attention_rows``), one call, and leaves out the SIMT kernel;
    ``no_library``, the reason SDPA cannot run the shape, leaves out
    ``library_ms``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    bf = torch.bfloat16
    sets = [(_randn(gen, (b, s, h, d), bf), _randn(gen, (b, t, kvh, d), bf),
             _randn(gen, (b, t, kvh, d), bf))
            for _ in range(_n_sets(2 * (b * s * h * d + 2 * b * t * kvh * d)))]

    def kern(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def simt(q, k, v):
        return fa.run_kernel("simt", q, k, v, causal=causal, window=window)

    ms = _time_ms(kern, sets, iters)
    host_ms = _time_ms(kern, sets, iters, queued=False)
    previous_ms = None if plain_rows else _time_ms(simt, sets, max(5, iters // 4))
    ms_again = _time_ms(kern, sets, iters)
    if plain_rows:
        def plain(q, k, v):
            for r in range(0, s, plain_rows):
                _attention_rows(q, k, v, r, min(r + plain_rows, s), window)

        plain_ms = _time_ms(plain, sets, 1, warmup=1)
    else:
        plain_ms = _time_ms(lambda q, k, v: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), sets, 5)
    lib_ms = lib_err = None
    if no_library is None:
        # SDPA with the KV heads expanded; is_causal has no window, so a
        # window takes an explicit boolean mask (True = attend)
        qpos = torch.arange(s, device="cuda")[:, None]
        kpos = torch.arange(t, device="cuda")[None, :]
        mask = (qpos >= kpos) & (kpos > qpos - window) if window else None
        lib_sets = [(q.transpose(1, 2).contiguous(),
                     k.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous(),
                     v.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous())
                    for q, k, v in sets]

        def lib(q, k, v):
            if mask is None:
                return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        lib_ms = _time_ms(lib, lib_sets, iters)
        lib_err = _max_err(lib(*lib_sets[0]).transpose(1, 2), kern(*sets[0])[0])
        del lib_sets
    prev_err = None if plain_rows else _max_err(simt(*sets[0])[0], kern(*sets[0])[0])
    w = window or t
    # unmasked (q, k) pairs
    pairs = sum(min(i + 1, t, w) for i in range(s)) if causal else s * t
    ops = 4 * d * pairs * b * h
    nbytes = 2 * (2 * b * s * h * d + 2 * b * t * kvh * d) + 4 * b * h * s
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    run = state[path]
    return {"name": "flash_attention", "route": "cuda", "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "launches": (run["launches"]["flash_attention_sm90"] if launches is None
                         else launches),
            "max_abs_err": state["serving_err"][
                err_key or "flash_attention" + ERR_SUFFIX[path]],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "ms_second_pass": ms_again, "previous_ms": previous_ms,
            "previous_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "previous_max_abs_diff": prev_err,
            "tflops": ops / (ms * 1e-3) / 1e12,
            "previous_tflops": previous_ms and ops / (previous_ms * 1e-3) / 1e12,
            "bound_fraction": bound_ms / ms,
            "shape": {"q": [b, s, h, d], "kv": [b, t, kvh, d],
                      "dtype": "bfloat16", "causal": causal, "window": window},
            "plain": (f"flash_attention_plain's arithmetic over blocks of {plain_rows} "
                      "query rows and the keys each sees (_attention_rows), one call"
                      if plain_rows else "flash_attention_plain"),
            "library": no_library or (
                "F.scaled_dot_product_attention, KV heads expanded"
                + (", windowed causal boolean mask" if window else "")
                + ("" if causal else ", is_causal=False")),
            "library_max_abs_err": lib_err}


def _time_rmsnorm(state, gen, path, shape, launches=None, err_key=None):
    """K2's row at x ``shape`` bf16 (w bf16); ``launches`` and ``err_key``
    as ``_time_flash``'s."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    bf = torch.bfloat16
    n = _n_sets(2 * (math.prod(shape) + shape[-1]))
    sets = [(_randn(gen, shape, bf), _randn(gen, shape[-1:], bf))
            for _ in range(n)]
    ms = _time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets, 200)
    host_ms = _time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets, 200,
                       queued=False)
    plain_ms = _time_ms(lambda x, w: rn.rmsnorm_plain(x, w, 1e-6), sets, 50)
    lib_ms = _time_ms(lambda x, w: F.rms_norm(x, (shape[-1],), w, 1e-6),
                      sets, 200)
    elems = math.prod(shape)
    bound_ms, bound_by = _bound(2 * (2 * elems + shape[-1]), 4 * elems,
                                "float32")
    return {"name": "rmsnorm", "route": "triton", "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:20",
            "launches": (state[path]["launches"]["rmsnorm"] if launches is None
                         else launches),
            "max_abs_err": state["serving_err"][err_key or "rmsnorm" + ERR_SUFFIX[path]],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "shape": {"x": list(shape), "dtype": "bfloat16"},
            "library": "F.rms_norm"}


_NO_SCAN_LIBRARY = ("none: no single PyTorch call computes this recurrence "
                    "(a cumprod/cumsum form divides by a running product "
                    "that underflows)")


def _time_rglru(state, gen, path, b, s, c, with_h0, err_key=None, blocked_plain=False):
    """K3's row at a, b (b,s,c) fp32, with h0 (b,c) as prefill calls it or
    without, as training does. ``blocked_plain``: the plain version timed
    is the blocked mirror, one call (the sequential loop takes 2 launches a
    step: over a million at long_500k's length)."""
    from repro_torch.kernels import rglru as rg

    sets = [_scan_inputs(gen, b, s, c)[:3 if with_h0 else 2]
            for _ in range(_n_sets(4 * (2 * b * s * c + b * c)))]
    ms = _time_ms(rg.rglru_scan, sets, 20)
    host_ms = _time_ms(rg.rglru_scan, sets, 20, queued=False)
    if blocked_plain:
        plain_ms = _time_ms(rg.rglru_scan_blocked_plain, sets, 1, warmup=1)
    else:
        plain_ms = _time_ms(rg.rglru_scan_plain, sets, 2)
    # a and b read once, h0 read once, h written once; a multiply and an add
    # per element
    nbytes = 4 * (3 * b * s * c + (b * c if with_h0 else 0))
    bound_ms, bound_by = _bound(nbytes, 2 * b * s * c, "float32")
    return {"name": "rglru_scan", "route": "cuda", "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru.py:50",
            "launches": state[path]["launches"]["rglru_scan"],
            "max_abs_err": state["serving_err"][err_key or {
                HYB_ARCH: "rglru_scan", "hybrid_train": "rglru_scan_hybrid_train"}[path]],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "host_ms": host_ms,
            "bound_fraction": bound_ms / ms,
            "plain": ("rglru_scan_blocked_plain, one call" if blocked_plain
                      else "rglru_scan_plain"),
            "shape": {"a": [b, s, c], "h0": [b, c] if with_h0 else None,
                      "dtype": "float32"},
            "library": _NO_SCAN_LIBRARY}


SLSTM_PLAIN_STEPS = 2048


def _dense_r(r):
    """r_gates (nh, dh, 4dh) as the recurrent matrix (4D, D) of
    ``torch.nn.LSTM``: row h * 4dh + e (the flat gate order) holds head h's
    column e over h_{t-1}'s channels h * dh .. h * dh + dh - 1."""
    import torch

    return torch.block_diag(*[r[h].t() for h in range(r.shape[0])])


def _time_slstm(state, path, b, s, iters, launches, err_key):
    """The sLSTM kernel's row at gx (b, s, 8192) bf16 from zeros, as a prefill
    calls it, from a generator of its own: the kernel (input sets cycled
    past the L2; one set at long_500k's 8.6 GB), the plain loop at
    SLSTM_PLAIN_STEPS steps only (at long_500k the whole loop would take
    some 6 M launches), the bound (gx read once, h written once, r_gates read
    once; the products' FLOPs at the bf16 peak) with its µs per step, and as
    the library call cuDNN's LSTM through ``torch.nn.LSTM(bias=False)``:
    W_ih the identity (gx as its input), W_hh ``_dense_r(r_gates)``, the
    same cell with its gates in i, f, g, o order, but its c held in bf16."""
    import torch

    from repro_torch.kernels import slstm as sl

    gen = torch.Generator(device="cuda").manual_seed(61)
    bf, d, nh = torch.bfloat16, XLSTM_D["d_model"], SLSTM_HEADS
    dh = d // nh
    long = s > SLSTM_PLAIN_STEPS
    sets = [_slstm_inputs(gen, b, s, bf, False)[:2]
            for _ in range(1 if long else _n_sets(2 * b * s * 4 * d))]
    ms = _time_ms(sl.slstm_scan, sets, iters, warmup=1)
    host_ms = None if long else _time_ms(sl.slstm_scan, sets, iters, queued=False)
    gx0, r0 = sets[0]
    plain_ms = _time_ms(sl.slstm_scan_plain,
                        [(gx0[:, :SLSTM_PLAIN_STEPS].contiguous(), r0)], 1, warmup=1)
    nbytes = 2 * (b * s * 4 * d + b * s * d + nh * dh * 4 * dh)
    bound_ms, bound_by = _bound(nbytes, sl.flops(b, s, nh, dh), "bfloat16")
    lib_ms, lib_note, lib_gap = None, None, None
    try:
        lstm = torch.nn.LSTM(4 * d, d, bias=False, batch_first=True, device="cuda",
                             dtype=bf)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(torch.eye(4 * d, device="cuda", dtype=bf))
            lstm.weight_hh_l0.copy_(_dense_r(r0))
            lstm.flatten_parameters()
            lib_ms = _time_ms(lambda gx, r: lstm(gx), sets, iters, warmup=1)
            lib_gap = _rel_l2(lstm(gx0)[0][:, :SLSTM_PLAIN_STEPS],
                              sl.slstm_scan(gx0, r0)[0][:, :SLSTM_PLAIN_STEPS])
        del lstm
    except RuntimeError as e:     # the yardstick only: the port never calls it
        lib_note = f"cuDNN LSTM failed: {str(e)[:200]}"
    del sets, gx0, r0
    torch.cuda.empty_cache()
    return {"name": "slstm_scan", "route": "cuda", "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/csrc/slstm_scan.cu",
            "replaces": "none: the reference's jax.lax.scan of _slstm_cell, "
                        "src/repro/models/xlstm.py:229 (cell :198)",
            "launches": launches, "max_abs_err": state["serving_err"][err_key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "host_ms": host_ms, "bound_fraction": bound_ms / ms,
            "us_per_step": ms * 1e3 / s, "bound_us_per_step": bound_ms * 1e3 / s,
            "plain": f"slstm_scan_plain over the first {SLSTM_PLAIN_STEPS} steps",
            "plain_us_per_step": plain_ms * 1e3 / SLSTM_PLAIN_STEPS,
            "shape": {"gx": [b, s, 4 * d], "r_gates": [nh, dh, 4 * dh], "h0": None,
                      "dtype": "bfloat16"},
            "library": lib_note or ("torch.nn.LSTM(bias=False) on cuDNN, W_ih = I, W_hh "
                                    "the dense (4D, D) expansion of r_gates; its c in bf16"),
            "library_h_rel_l2_first_steps": lib_gap}


def _time_rglru_backward(state, gen, b, s, c):
    """K3's backward kernel at a, h, g (b,s,c) fp32 without h0, as training
    calls it, beside its plain version."""
    from repro_torch.kernels import rglru as rg

    sets = []
    for _ in range(_n_sets(4 * 5 * b * s * c)):
        a, bb = _scan_inputs(gen, b, s, c)[:2]
        sets.append((a, rg.rglru_scan(a, bb), _randn(gen, (b, s, c), _dtype("float32"))))
    ms = _time_ms(rg.rglru_scan_backward, sets, 20)
    host_ms = _time_ms(rg.rglru_scan_backward, sets, 20, queued=False)
    ms_again = _time_ms(rg.rglru_scan_backward, sets, 20)
    plain_ms = _time_ms(rg.rglru_scan_backward_plain, sets, 2)
    # g, a and h read once, da and db written once; a multiply and an add
    # for lam and a multiply for da per element
    bound_ms, bound_by = _bound(4 * 5 * b * s * c, 3 * b * s * c, "float32")
    return {"name": "rglru_scan_backward", "route": "cuda",
            "path": PATH_NAME["hybrid_train"],
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru.py:50 (its gradient: the reference "
                        "differentiates associative_scan in XLA, "
                        "src/repro/models/recurrent.py:67 rglru_scan)",
            "launches": state["hybrid_train"]["launches"]["rglru_scan_bwd"],
            "max_abs_err": state["serving_err"]["rglru_scan_backward"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "host_ms": host_ms,
            "ms_second_pass": ms_again, "bound_fraction": bound_ms / ms,
            "calls_per_step": 18,
            "shape": {"a": [b, s, c], "h0": None, "dtype": "float32"},
            "library": _NO_SCAN_LIBRARY}


def _time_attention_backward(state, gen, path, b, s, h, kvh, d, window, iters, *,
                             t=None, causal=True, launches=None, err_key=None,
                             calls_per_step=None):
    """K1's backward kernel at q (b,s,h,d), k/v (b,t,kvh,d) bf16 (t: s when
    None), ``causal`` (SDPA's alike) with ``window`` (0: none), as training
    calls it (``flash_attention_backward`` from the forward's out and LSE);
    ``launches``, ``err_key`` (in ``state["grad_err"]``) and
    ``calls_per_step`` override the path's. Beside it its plain version, the
    recompute ``flash_attention_bwd`` (``plain_ms``), SDPA's backward under
    the same mask (SDPA forward + backward minus its forward, KV heads
    expanded) and ``previous_ms``, the code the training path ran before:
    at qwen2.5-3b's shape the plain recompute, whose backward of the
    materialising plain version is also timed (``materialised_ms``); at
    head dim 256 the SIMT backward kernel (fp32 atomics)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import flash_attention_bwd

    bf = torch.bfloat16
    t = s if t is None else t
    per_set = 2 * (3 * b * s * h * d + 2 * b * t * kvh * d) + 4 * b * h * s
    sets = []
    for _ in range(_n_sets(per_set)):
        q = _randn(gen, (b, s, h, d), bf)
        k, v = (_randn(gen, (b, t, kvh, d), bf) for _ in range(2))
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=window)
        sets.append((q, k, v, out, lse, _randn(gen, (b, s, h, d), bf)))

    def kern(q, k, v, out, lse, g):
        return fa.flash_attention_backward(q, k, v, out, lse, g, causal=causal,
                                           window=window)

    def simt(q, k, v, out, lse, g):
        return fa.run_backward_kernel("simt", q, k, v, out, lse, g, causal=causal,
                                      window=window)

    def recompute(q, k, v, out, lse, g):
        return flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)

    ms = _time_ms(kern, sets, iters)
    host_ms = _time_ms(kern, sets, iters, queued=False)
    plain_ms = _time_ms(recompute, sets, max(3, iters // 4))
    simt_ms = _time_ms(simt, sets, 3) if d == 256 else None
    ms_again = _time_ms(kern, sets, iters)

    def grad_sets(expand):
        out = []
        for q, k, v, _, _, g in sets:
            if expand:
                q, k, v, g = (x.repeat_interleave(h // x.shape[2], dim=2)
                              .transpose(1, 2).contiguous() for x in (q, k, v, g))
            out.append(tuple(x.detach().requires_grad_(True) for x in (q, k, v))
                       + (g,))
        return out

    # SDPA's is_causal has no window, so a window takes an explicit boolean
    # mask (True = attend)
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    mask = (qpos >= kpos) & (kpos > qpos - window) if window else None

    def sdpa(q, k, v):
        if mask is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def plain(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window)[0]

    def fwd_bwd(f):
        return lambda q, k, v, g: torch.autograd.grad(f(q, k, v), (q, k, v), g)

    lib = grad_sets(True)
    lib_ms = (_time_ms(fwd_bwd(sdpa), lib, iters)
              - _time_ms(lambda q, k, v, g: sdpa(q, k, v), lib, iters))
    del lib
    row = {}
    if d == 256:
        row.update(previous_ms=simt_ms, previous_source=(
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu (SIMT, fp32 "
            "atomics; the route of bf16 at head dim 256 before)"))
    else:
        pl = grad_sets(False)
        row.update(previous_ms=plain_ms, previous_source=(
            "src/repro_torch/models/common.py (flash_attention_bwd, plain recompute)"),
            materialised_ms=(_time_ms(fwd_bwd(plain), pl, 3)
                             - _time_ms(lambda q, k, v, g: plain(q, k, v), pl, 3)),
            materialised="autograd through flash_attention_plain (materialised "
                         "scores), forward+backward minus forward")
        del pl
    pairs = fa.attention_pairs(s, t, causal, window)
    ops = 2.5 * 4 * d * pairs * b * h
    nbytes = per_set + 2 * (b * s * h * d + 2 * b * t * kvh * d)
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    err_key = err_key or {"train": "flash_attention_backward",
                          "hybrid_train": "flash_attention_backward_hybrid",
                          "moe16b_train": "flash_attention_backward_moe16b_train"}[path]
    return {"name": "flash_attention_backward", "route": "cuda",
            "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
            "replaces": "src/repro/kernels/ops.py:42 (_fa_bwd: the XLA recompute "
                        "src/repro/models/common.py:265 _flash_vjp_bwd)",
            "launches": (state[path]["launches"]["flash_attention_bwd_sm90"]
                         if launches is None else launches),
            "max_abs_err": state["grad_err"][err_key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "ms_second_pass": ms_again, **row,
            "tflops": ops / (ms * 1e-3) / 1e12, "bound_fraction": bound_ms / ms,
            "calls_per_step": (calls_per_step if calls_per_step is not None else
                               {"train": QWEN["layers"], "hybrid_train": 8,
                                "moe16b_train": MOE_TRAIN["layers"]}[path]),
            "shape": {"q": [b, s, h, d], "kv": [b, t, kvh, d], "dtype": "bfloat16",
                      "causal": causal, "window": window},
            "library": "F.scaled_dot_product_attention forward+backward minus "
                       "forward, KV heads expanded"
                       + (", windowed causal boolean mask" if window else "")
                       + ("" if causal else ", is_causal=False")}


def _time_rmsnorm_backward(state, gen, path, shape, calls_per_step, launches=None,
                           err_key=None):
    """K2's backward kernels (``rmsnorm_grad``) at x ``shape`` bf16, w bf16;
    beside its plain version ``rmsnorm_backward`` (``previous_ms``, the code
    the training path ran before; also ``plain_ms``) and ``F.rms_norm``'s
    backward (forward+backward minus forward). ``launches`` and ``err_key``
    (in ``state["grad_err"]``) override the path's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    bf = torch.bfloat16
    elems = math.prod(shape)
    sets = [(_randn(gen, shape, bf), _randn(gen, shape[-1:], bf),
             _randn(gen, shape, bf))
            for _ in range(_n_sets(2 * (3 * elems + shape[-1])))]

    def kern(x, w, g):
        return rn.rmsnorm_grad(x, w, g, 1e-6)

    ms = _time_ms(kern, sets, 200)
    host_ms = _time_ms(kern, sets, 200, queued=False)
    previous_ms = _time_ms(lambda x, w, g: rn.rmsnorm_backward(x, w, g, 1e-6), sets, 50)
    ms_again = _time_ms(kern, sets, 200)
    lib = [(x.requires_grad_(True), w.requires_grad_(True), g)
           for x, w, g in ((x.clone(), w.clone(), g) for x, w, g in sets)]

    def lib_fwd(x, w, g):
        return F.rms_norm(x, (shape[-1],), w, 1e-6)

    lib_ms = (_time_ms(lambda x, w, g: torch.autograd.grad(
        lib_fwd(x, w, g), (x, w), g), lib, 50) - _time_ms(lib_fwd, lib, 50))
    # x and dy read once, w read once; dx and dw written once
    bound_ms, bound_by = _bound(2 * (3 * elems + 2 * shape[-1]), 10 * elems,
                                "float32")
    return {"name": "rmsnorm_backward", "route": "triton",
            "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:20 (its gradient: the "
                        "reference differentiates src/repro/models/common.py:103 "
                        "rms_norm)",
            "launches": (state[path]["launches"]["rmsnorm_bwd"] if launches is None
                         else launches),
            "max_abs_err": state["grad_err"][err_key or
                {"train": "rmsnorm_backward",
                 "hybrid_train": "rmsnorm_backward_hybrid",
                 # the same shape as qwen2.5-3b's training, (4, 1024, 2048)
                 "moe16b_train": "rmsnorm_backward"}[path]],
            "ms": ms, "plain_ms": previous_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "ms_second_pass": ms_again, "previous_ms": previous_ms,
            "previous_source": "src/repro_torch/kernels/rmsnorm.py "
                               "(rmsnorm_backward, plain torch)",
            "bound_fraction": bound_ms / ms,
            "calls_per_step": calls_per_step,
            "shape": {"x": list(shape), "dtype": "bfloat16"},
            "library": "F.rms_norm forward+backward minus forward"}


# -- phase 7: the simulator -------------------------------------------------------
def fig8_grid():
    """Paper Fig. 8 through the port: all-reduce makespans on the six Table-2
    topologies x ``FIG8_SIZES_MB`` under baseline/FIFO, themis/FIFO and
    themis/SCF (``simulate_scheduled``, 64 chunks), and the speed-ups'
    summary. Simulated fabric times, computed on the host."""
    from repro_torch.core import simulate_scheduled
    from repro_torch.topology import make_table2_topologies

    rows = []
    for name, topo in make_table2_topologies().items():
        for mb in FIG8_SIZES_MB:
            rows.append({"topology": name, "size_mb": mb, **{
                label: simulate_scheduled(topo, "AR", mb * 1e6, policy=policy,
                                          intra=intra)[0].makespan
                for label, policy, intra in (("baseline_fifo_s", "baseline", "FIFO"),
                                             ("themis_fifo_s", "themis", "FIFO"),
                                             ("themis_scf_s", "themis", "SCF"))}})
    fifo = [r["baseline_fifo_s"] / r["themis_fifo_s"] for r in rows]
    scf = [r["baseline_fifo_s"] / r["themis_scf_s"] for r in rows]
    return rows, {"avg_speedup_fifo": sum(fifo) / len(fifo),
                  "avg_speedup_scf": sum(scf) / len(scf), "max_speedup_scf": max(scf)}


def fig12_grid():
    """Paper Fig. 12 through the port: each workload's compute time
    calibrated to the paper's Ideal speed-up (``calibrate_compute``), then
    its iteration time under baseline/FIFO, themis/SCF and ideal on the six
    Table-2 topologies, and the speed-ups' summary. Simulated times."""
    import statistics

    from repro_torch.core.workloads import ALL_WORKLOADS, calibrate_compute, iteration_time
    from repro_torch.topology import make_table2_topologies

    topos = list(make_table2_topologies().values())
    rows, summary = [], {}
    for wname, make in ALL_WORKLOADS.items():
        w = make()
        compute_s = calibrate_compute(w, topos, FIG12_PAPER[wname][1])
        themis, ideal = [], []
        for topo in topos:
            b = iteration_time(w, topo, "baseline", intra="FIFO").total_s
            t = iteration_time(w, topo, "themis", intra="SCF").total_s
            i = iteration_time(w, topo, "ideal").total_s
            rows.append({"workload": wname, "topology": topo.name, "baseline_fifo_s": b,
                         "themis_scf_s": t, "ideal_s": i})
            themis.append(b / t)
            ideal.append(b / i)
        summary[wname] = {"compute_s": compute_s, "themis_avg": statistics.mean(themis),
                          "themis_max": max(themis), "ideal_avg": statistics.mean(ideal)}
    return rows, summary


def phase_simulator(state):
    """Fig. 8 and Fig. 12 on the port's simulator (the host, no card). The
    CPU tests hold each value equal to the reference's; this prints them."""
    t0 = time.perf_counter()
    rows8, sum8 = fig8_grid()
    t1 = time.perf_counter()
    rows12, sum12 = fig12_grid()
    t2 = time.perf_counter()
    emit(fig8={"simulated": True, "summary": sum8, "paper": FIG8_PAPER,
               "rows": rows8, "host_seconds": t1 - t0})
    emit(fig12={"simulated": True, "summary": sum12,
                "paper": {k: {"themis_avg": v[0], "ideal_avg": v[1]}
                          for k, v in FIG12_PAPER.items()},
                "rows": rows12, "host_seconds": t2 - t1})


# -- phase 7b: faults, tenancy and traffic ----------------------------------------
# The scenarios of benchmarks/{faults,tenancy,traffic}_study.py at their full
# sizes, through the port. Each is a function here, and a CPU test holds it
# equal to the study's own on every simulated value; the phases print the
# simulated fabric times beside host seconds and gate as the studies do
# (the constants are with the others at the top).


def _gap(a, b):
    """Largest relative gap between two results' float values and the
    number of non-float values (ints, orders, tags, lengths) that differ."""
    if isinstance(a, float) and isinstance(b, float):
        return (0.0 if a == b else abs(a - b) / max(abs(a), abs(b))), 0
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return 0.0, 1
        gaps = [_gap(x, y) for x, y in zip(a, b)]
        return max((g for g, _ in gaps), default=0.0), sum(n for _, n in gaps)
    return 0.0, int(a != b)


def sim_gap(res_a, res_b):
    """``_gap`` over every ``SimResult`` field: (largest relative float gap,
    the fields whose non-float values differ)."""
    import dataclasses

    gaps = {f.name: _gap(getattr(res_a, f.name), getattr(res_b, f.name))
            for f in dataclasses.fields(res_a)}
    return max(g for g, _ in gaps.values()), sorted(k for k, (_, n) in gaps.items() if n)


def faults_identity():
    """``faults_study.identity_part``: with ``faults=None`` both engines give
    the same result, and an empty ``FaultSchedule`` changes nothing but the
    retry counts (all zero)."""
    from repro_torch.core import simulate_requests
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.faults import FaultSchedule
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FAULTS_TOPOLOGY]
    reqs = [CollectiveRequest("AR", 8.0 * MB, issue_time=i * 2e-4) for i in range(8)]

    def run_once(eng, faults):
        return simulate_requests(topo, reqs, chunks_per_collective=8, engine=eng,
                                 check_invariants=True, faults=faults)[0]

    base = {eng: run_once(eng, None) for eng in ("indexed", "reference")}
    empty_same = True
    for eng, res in base.items():
        empty = run_once(eng, FaultSchedule())
        diff = [f for f in res.diff_fields(empty) if f != "group_retries"]
        empty_same &= not diff and not any(empty.group_retries) and not empty.failed_groups
    return {"engines_identical": not base["indexed"].diff_fields(base["reference"]),
            "empty_schedule_identical": empty_same}


def _random_faults(rng, horizon):
    """``faults_study._random_faults``: per dim at most one degradation,
    outage or flap plus an optional straggler burst, and a retry policy."""
    from repro_torch.faults import (BwDegradation, DimOutage, FaultSchedule, LinkFlap,
                                    RetryPolicy, StragglerBurst)

    events = []
    for dim in (0, 1):
        kind = rng.choice(("degrade", "outage", "flap", "none"))
        t0 = rng.uniform(0.1, 0.5) * horizon
        if kind == "degrade":
            events.append(BwDegradation(
                dim=dim, start=t0, end=t0 + rng.uniform(0.2, 0.5) * horizon,
                factor=rng.uniform(0.1, 0.8)))
        elif kind == "outage":
            events.append(DimOutage(
                dim=dim, start=t0, end=t0 + rng.uniform(0.05, 0.2) * horizon))
        elif kind == "flap":
            down = rng.uniform(0.02, 0.06) * horizon
            events.append(LinkFlap(
                dim=dim, start=t0, down_s=down,
                period_s=down + rng.uniform(0.05, 0.15) * horizon,
                count=rng.randint(1, 3)))
        if rng.random() < 0.5:
            s0 = rng.uniform(0.0, 0.4) * horizon
            events.append(StragglerBurst(
                dim=dim, start=s0, end=s0 + rng.uniform(0.2, 0.6) * horizon,
                sigma=rng.uniform(0.05, 0.4)))
    retry = RetryPolicy(timeout_s=rng.uniform(0.02, 0.08) * horizon,
                        backoff_s=rng.uniform(0.01, 0.03) * horizon,
                        max_attempts=rng.choice((3, 8)))
    return FaultSchedule(events=tuple(events), retry=retry)


def faults_chaos():
    """``faults_study.chaos_part``: 24 seeded fault timelines over
    {themis, baseline} x {SCF, FIFO} x {no arbiter, weighted-fair,
    strict-priority}, re-planning on odd seeds under themis, each run on
    both engines with the invariant sanitizer armed."""
    import random

    from repro_torch.core import simulate_requests
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.tenancy import FabricArbiter, TenantSpec
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FAULTS_TOPOLOGY]
    policies, intras = ("themis", "baseline"), ("SCF", "FIFO")
    arbiters = (None, "weighted-fair", "strict-priority")
    specs = [TenantSpec("a", weight=1.0), TenantSpec("b", weight=3.0, priority=5)]
    results = []
    for i in range(24):
        policy, intra, arb_policy, seed = (policies[i % 2], intras[(i // 2) % 2],
                                           arbiters[(i // 4) % 3], 1000 + i)
        faults = _random_faults(random.Random(seed), FAULTS_HORIZON_S)
        reqs = [CollectiveRequest("AR", 6.0 * MB, issue_time=j * 2e-4,
                                  tenant="a" if j % 3 else "b") for j in range(10)]
        replan = bool(seed % 2) and policy == "themis"

        def run_once(eng):
            arb = (FabricArbiter(arb_policy, specs, quantum_chunks=4, preemption=True)
                   if arb_policy is not None else None)
            return simulate_requests(topo, reqs, policy=policy, chunks_per_collective=8,
                                     intra=intra, arbiter=arb, engine=eng,
                                     check_invariants=True, faults=faults,
                                     replan=replan)[0]

        res_i, res_r = run_once("indexed"), run_once("reference")
        results.append({"policy": policy, "intra": intra, "arbiter": arb_policy,
                        "seed": seed, "replan": replan, "makespan": res_i.makespan,
                        "retries": sum(res_i.group_retries),
                        "failed_groups": len(res_i.failed_groups),
                        "identical": not res_i.diff_fields(res_r)})
    return {"n_scenarios": len(results),
            "all_identical": all(r["identical"] for r in results),
            "total_retries": sum(r["retries"] for r in results),
            "total_failed_groups": sum(r["failed_groups"] for r in results),
            "scenarios": results}


def faults_sweep():
    """``faults_study.sweep_part``: six staggered 64 MiB all-reduces in 16
    chunks, the fat dim degraded to each of ``SWEEP_FACTORS`` from 150 us on,
    with and without Themis re-planning (indexed engine, sanitizer armed)."""
    from repro_torch.core import simulate_requests
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.faults import BwDegradation, FaultSchedule
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FAULTS_TOPOLOGY]
    reqs = [CollectiveRequest("AR", float(1 << 26), issue_time=i * 1e-4) for i in range(6)]

    def run_once(faults, replan):
        return simulate_requests(topo, reqs, chunks_per_collective=16, engine="indexed",
                                 check_invariants=True, faults=faults, replan=replan)[0]

    clean = run_once(None, False).makespan
    points = []
    for f in SWEEP_FACTORS:
        faults = FaultSchedule(events=(BwDegradation(dim=1, start=1.5e-4, end=1.0,
                                                     factor=f),))
        plain, replanned = run_once(faults, False), run_once(faults, True)
        points.append({"factor": f, "makespan_clean": clean,
                       "makespan_no_replan": plain.makespan,
                       "makespan_replan": replanned.makespan,
                       "inflation_no_replan": plain.makespan / clean,
                       "inflation_replan": replanned.makespan / clean,
                       "replan_speedup": plain.makespan / replanned.makespan})
    worst = points[-1]["replan_speedup"]  # factors descend: the last is the harshest
    return {"factors": list(SWEEP_FACTORS), "points": points, "gate": REPLAN_GATE,
            "worst_severity_speedup": worst, "gate_passed": worst >= REPLAN_GATE}


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_faults(state):
    """Fault injection and re-planning through the port (host only): the
    fault-free identity, 24 chaos scenarios equal across the port's two
    engines with the sanitizer armed, and re-planning's speed-up of at
    least ``REPLAN_GATE`` at the harshest degradation."""
    identity, s_id = _timed(faults_identity)
    chaos, s_chaos = _timed(faults_chaos)
    sweep, s_sweep = _timed(faults_sweep)
    emit(faults={"simulated": True, "identity": identity, "chaos": chaos, "sweep": sweep,
                 "host_seconds": {"identity": s_id, "chaos": s_chaos, "sweep": s_sweep}})
    assert identity["engines_identical"], "fault-free engines differ"
    assert identity["empty_schedule_identical"], "an empty FaultSchedule changed a result"
    bad = [(r["seed"], r["policy"], r["intra"], r["arbiter"]) for r in chaos["scenarios"]
           if not r["identical"]]
    assert not bad, f"engines differ under faults in {len(bad)}/24 scenarios: {bad}"
    assert sweep["gate_passed"], (
        f"re-planning speed-up {sweep['worst_severity_speedup']} < {REPLAN_GATE} "
        f"at factor {SWEEP_FACTORS[-1]}")


def _tenancy_scenario(name):
    """``tenancy_study._fairness_tenants`` / ``_workload_tenants`` /
    ``_ablation_tenants``: (specs, requests)."""
    from repro_torch.core.workloads import make_gnmt, make_resnet152
    from repro_torch.tenancy import TenantJob, TenantSpec, synthetic_requests

    if name == "fairness":
        specs = [TenantSpec("batch", weight=1.0),
                 TenantSpec("prod", weight=1.0, priority=1, slo_slowdown=1.5)]
        return specs, (synthetic_requests("batch", "AR", 400 * MB, 3)
                       + synthetic_requests("prod", "AR", 10 * MB, 12, gap_s=0.0005,
                                            start_s=0.0002))
    if name == "workloads":
        light = TenantJob(TenantSpec("resnet", weight=1.0, priority=1, slo_slowdown=2.0,
                                     arrival_offset_s=0.005, iterations=2, n_buckets=8),
                          make_resnet152())
        heavy = TenantJob(TenantSpec("gnmt", weight=1.0, iterations=2, n_buckets=2),
                          make_gnmt())
        return [light.spec, heavy.spec], light.requests() + heavy.requests()
    specs = [TenantSpec(n) for n in ("a", "b", "c")]
    reqs = []
    for i, s in enumerate(specs):
        reqs += synthetic_requests(s.name, "AR", 200 * MB, 3, gap_s=3 * 0.001,
                                   start_s=i * 0.001)
    return specs, reqs


def tenancy_sweep(topo, name):
    """``tenancy_study._sweep``: the scenario under each arbiter policy, with
    isolated latencies as the slowdowns' base; (cells, (specs, reqs, iso))."""
    from repro_torch.tenancy import (FabricArbiter, fairness_index, isolated_latencies,
                                     mean_slowdown, simulate_fabric, slo_violations,
                                     tenant_reports)

    specs, reqs = _tenancy_scenario(name)
    iso = isolated_latencies(topo, reqs, chunks_per_collective=TENANCY_CHUNKS)
    spec_map = {s.name: s for s in specs}
    iso_mean = {t: sum(v) / len(v) for t, v in iso.items()}
    cells = {}
    for policy in TENANCY_POLICIES:
        arb = FabricArbiter(policy, specs, isolated_latency=iso_mean)
        res, _ = simulate_fabric(topo, reqs, arbiter=arb,
                                 chunks_per_collective=TENANCY_CHUNKS)
        reps = tenant_reports(res, reqs, iso, spec_map)
        cells[policy] = {
            "jain": fairness_index(reps), "mean_slowdown": mean_slowdown(reps),
            "makespan_ms": res.finish_time() * 1e3, "slo_violations": slo_violations(reps),
            "preemptions": arb.preempt_count,
            "tenants": {t: {"mean_slowdown": r.mean_slowdown, "finish_ms": r.finish_s * 1e3,
                            "bw_share": r.bw_share, "slo_violated": r.slo_violated}
                        for t, r in reps.items()}}
    return cells, (specs, reqs, iso)


def tenancy_ablation(topo):
    """``tenancy_study._ablation``: three staggered tenants under
    weighted-fair, one shared Dim Load Tracker against one per tenant."""
    from repro_torch.tenancy import (FabricArbiter, isolated_latencies, mean_slowdown,
                                     simulate_fabric, tenant_reports)

    specs, reqs = _tenancy_scenario("ablation")
    spec_map = {s.name: s for s in specs}
    iso = isolated_latencies(topo, reqs, chunks_per_collective=32)
    out = {}
    for mode, shared in (("shared", True), ("per_tenant", False)):
        arb = FabricArbiter("weighted-fair", specs)
        res, _ = simulate_fabric(topo, reqs, arbiter=arb, shared_tracker=shared,
                                 chunks_per_collective=32)
        reps = tenant_reports(res, reqs, iso, spec_map)
        out[mode] = {"makespan_ms": res.finish_time() * 1e3,
                     "mean_slowdown": mean_slowdown(reps)}
    out["shared_wins"] = (
        out["shared"]["makespan_ms"] < out["per_tenant"]["makespan_ms"]
        or out["shared"]["mean_slowdown"] < out["per_tenant"]["mean_slowdown"])
    return out


def tenancy_preemption_cost(topo, specs, reqs, iso):
    """``tenancy_study._preemption_cost``: the fairness scenario under
    weighted-fair at each re-arm penalty of ``PREEMPT_PENALTIES_S``."""
    from repro_torch.tenancy import (FabricArbiter, fairness_index, simulate_fabric,
                                     tenant_reports)

    spec_map = {s.name: s for s in specs}
    out = {}
    for penalty in PREEMPT_PENALTIES_S:
        arb = FabricArbiter("weighted-fair", specs, preempt_penalty_s=penalty)
        res, _ = simulate_fabric(topo, reqs, arbiter=arb, chunks_per_collective=TENANCY_CHUNKS)
        reps = tenant_reports(res, reqs, iso, spec_map)
        out[f"{penalty * 1e6:.0f}us"] = {
            "makespan_ms": res.finish_time() * 1e3, "prod_slowdown": reps["prod"].mean_slowdown,
            "jain": fairness_index(reps), "preemptions": arb.preempt_count}
    return out


def tenancy_study():
    """``tenancy_study.run``'s report, without its file: on each of
    ``TENANCY_TOPOLOGIES`` the fairness and workloads sweeps, the
    preemption cost and the tracker ablation, and the study's two checks."""
    from repro_torch.topology import make_table2_topologies

    topos = make_table2_topologies()
    report = {"scenarios": {}, "checks": {}}
    wf_beats_fifo, shared_wins = [], []
    for tname in TENANCY_TOPOLOGIES:
        topo = topos[tname]
        fairness, ctx = tenancy_sweep(topo, "fairness")
        workloads, _ = tenancy_sweep(topo, "workloads")
        abl = tenancy_ablation(topo)
        report["scenarios"][tname] = {
            "fairness": fairness, "workloads": workloads,
            "preemption_cost": tenancy_preemption_cost(topo, *ctx),
            "tracker_ablation": abl}
        if fairness["weighted-fair"]["jain"] > fairness["fifo"]["jain"]:
            wf_beats_fifo.append(tname)
        if abl["shared_wins"]:
            shared_wins.append(tname)
    report["checks"] = {"weighted_fair_beats_fifo_jain_on": wf_beats_fifo,
                        "shared_tracker_wins_on": shared_wins}
    return report


def phase_tenancy(state):
    """Multi-tenant arbitration through the port (host only): the study's
    checks hold on every topology, as in ``BENCH_tenancy.json``."""
    report, secs = _timed(tenancy_study)
    emit(tenancy={"simulated": True, **report, "host_seconds": secs})
    for check, on in report["checks"].items():
        assert list(on) == list(TENANCY_TOPOLOGIES), f"{check} holds only on {on}"


def traffic_costs():
    """The serving costs of the traffic study: llama3-8b, 4 x 512, tp 8, from
    the port's config and roofline."""
    from repro_torch.traffic import serving_costs_from_arch

    return serving_costs_from_arch(TRAFFIC_ARCH, **TRAFFIC_COSTS)


def _serving_job(costs, *, gen_tokens, n_requests, arrival_gap_s):
    from repro_torch.tenancy import TenantJob, TenantSpec
    from repro_torch.traffic import serving_traffic

    return TenantJob(TenantSpec("serve", weight=2.0, slo_slowdown=1.5),
                     traffic_builder=lambda job: serving_traffic(
                         gen_tokens=gen_tokens, n_requests=n_requests,
                         arrival_gap_s=arrival_gap_s, **costs))


def _mixed_graph(costs, *, iterations, gen_tokens, n_requests, arrival_gap_s=2e-3,
                 n_buckets=16):
    """``traffic_study._mixed_graph``: closed-loop ResNet-152 training beside
    a serving tenant, as one graph, and the two tenants' specs."""
    from repro_torch.core.workloads import make_resnet152
    from repro_torch.tenancy import TenantJob, TenantSpec, tenant_traffic

    train = TenantJob(TenantSpec("train", weight=1.0, iterations=iterations,
                                 n_buckets=n_buckets), make_resnet152())
    serve = _serving_job(costs, gen_tokens=gen_tokens, n_requests=n_requests,
                         arrival_gap_s=arrival_gap_s)
    return tenant_traffic([train, serve]), [train.spec, serve.spec]


def traffic_equivalence(costs):
    """``traffic_study.equivalence_gate``'s scenarios: a fixed-time stream
    through the IR against ``simulate_requests``, then the 1F1B pipeline, the
    serving chains and the mixed tenants, each plain, under weighted-fair
    and with DCN stragglers, on the indexed and reference engines and through
    ``simulate_batch``. Returns the pairs of results under the study's
    labels: ``exact`` (the IR against ``simulate_requests``, each batch
    against indexed) and ``engines`` (indexed against reference)."""
    from repro_torch.core import simulate_requests
    from repro_torch.core.batch import Scenario, simulate_batch
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.tenancy import FabricArbiter
    from repro_torch.topology import make_tpu_pod_topology
    from repro_torch.traffic import (from_requests, pipeline_traffic, serving_traffic,
                                     simulate_traffic)

    topo = make_tpu_pod_topology(2, 8, 8)
    reqs = [CollectiveRequest(["AR", "RS", "AG"][i % 3], (4 + 7 * (i % 5)) * MB,
                              issue_time=i * 1.1e-4, priority=i % 2, stream=f"s{i % 2}")
            for i in range(14)]
    r_plain, _ = simulate_requests(topo, reqs, chunks_per_collective=8)
    r_graph, _ = simulate_traffic(topo, from_requests(reqs), chunks_per_collective=8)
    out = {"exact": {"fixed-time-ir-vs-simulate_requests": (r_graph, r_plain)},
           "engines": {}}
    graphs = {
        "pipeline-1f1b": pipeline_traffic(stages=4, microbatches=6, fwd_s=1e-3, bwd_s=2e-3,
                                          act_bytes=8 * MB, grad_ar_bytes=60 * MB,
                                          n_grad_buckets=4),
        "serving-chains": serving_traffic(gen_tokens=12, n_requests=3,
                                          arrival_gap_s=1.5e-3, **costs)}
    mixed, specs = _mixed_graph(costs, iterations=2, gen_tokens=8, n_requests=2)
    graphs["mixed-tenant"] = mixed
    jit_topo = make_tpu_pod_topology(2, 8, 8, dcn_straggler_sigma=0.4)
    cases = [("plain", topo, None, 0.0, 0),
             ("arbiter:weighted-fair", topo, lambda: FabricArbiter("weighted-fair", specs),
              0.0, 0),
             ("dcn-straggler", jit_topo, None, 0.05, 3)]
    for gname, graph in graphs.items():
        for cname, t, factory, jitter, seed in cases:
            kw = dict(chunks_per_collective=6, jitter=jitter, seed=seed)
            ri, _ = simulate_traffic(t, graph, engine="indexed",
                                     arbiter=factory() if factory else None, **kw)
            rr, _ = simulate_traffic(t, graph, engine="reference",
                                     arbiter=factory() if factory else None, **kw)
            sc = Scenario(t, traffic=graph, chunks_per_collective=6, jitter=jitter,
                          seed=seed, arbiter_factory=factory)
            rb = simulate_batch([sc])[0]
            label = f"{gname}/{cname}"
            out["engines"][label] = (ri, rr)
            out["exact"][label + "/batch"] = (rb, ri)
    return out


def traffic_mixed_tenancy(costs):
    """``traffic_study.mixed_tenancy``: 3 training iterations beside 3
    serving requests of 32 tokens on a 2 x 8 x 8 pod under fifo,
    weighted-fair and slo-aware through ``simulate_batch``: decode
    p50/p95/p99, prefill p99 and the training slowdown."""
    from repro_torch.core.batch import BatchCaches, Scenario, simulate_batch
    from repro_torch.core.workloads import make_resnet152
    from repro_torch.tenancy import FabricArbiter, TenantJob, TenantSpec
    from repro_torch.topology import make_tpu_pod_topology
    from repro_torch.traffic import simulate_traffic

    topo = make_tpu_pod_topology(2, 8, 8)
    iterations, gen_tokens = 3, 32
    graph, specs = _mixed_graph(costs, iterations=iterations, gen_tokens=gen_tokens,
                                n_requests=3)
    train_alone = TenantJob(TenantSpec("train", iterations=iterations, n_buckets=16),
                            make_resnet152())
    res_train, _ = simulate_traffic(topo, train_alone.traffic(), chunks_per_collective=16)
    train_iso = res_train.finish_time()
    serve_alone = _serving_job(costs, gen_tokens=gen_tokens, n_requests=3,
                               arrival_gap_s=2e-3)
    res_serve, _ = simulate_traffic(topo, serve_alone.traffic(), chunks_per_collective=16)
    decode_iso = res_serve.stream_stats()["serve/decode"]
    iso_lat = {"serve": decode_iso.latency_mean, "train": train_iso / max(1, iterations)}
    scenarios = [Scenario(topo, traffic=graph, chunks_per_collective=16,
                          arbiter_factory=(lambda p=pol: FabricArbiter(
                              p, specs, isolated_latency=iso_lat)), label=pol)
                 for pol in ("fifo", "weighted-fair", "slo-aware")]
    results = simulate_batch(scenarios, caches=BatchCaches())
    out = {"topology": topo.name, "iterations": iterations, "gen_tokens": gen_tokens,
           "train_isolated_finish_s": train_iso,
           "decode_isolated_p99_s": decode_iso.latency_p99, "policies": {}}
    for sc, res in zip(scenarios, results):
        dec = res.stream_stats()["serve/decode"]
        train_fin = res.stream_stats(by="tenant")["train"].finish
        out["policies"][sc.label] = {
            "decode_p50_s": dec.latency_p50, "decode_p95_s": dec.latency_p95,
            "decode_p99_s": dec.latency_p99,
            "prefill_p99_s": res.stream_stats()["serve/prefill"].latency_p99,
            "train_finish_s": train_fin, "train_slowdown": train_fin / train_iso}
    return out


def traffic_dcn_jitter(costs):
    """``traffic_study.dcn_jitter``: the mixed scenario (2 iterations, 2
    requests of 24 tokens) under weighted-fair with a lognormal straggler
    sigma of 0, 0.25 and 0.5 on the pod dim, 4 seeds each: decode p99."""
    from repro_torch.core.batch import BatchCaches, Scenario, simulate_batch
    from repro_torch.tenancy import FabricArbiter
    from repro_torch.topology import make_tpu_pod_topology

    sigmas, seeds = (0.0, 0.25, 0.5), range(4)
    out = {"sigmas": {}}
    caches = BatchCaches()
    for sigma in sigmas:
        topo = make_tpu_pod_topology(2, 8, 8, dcn_straggler_sigma=sigma)
        graph, specs = _mixed_graph(costs, iterations=2, gen_tokens=24, n_requests=2)
        scenarios = [Scenario(topo, traffic=graph, chunks_per_collective=8, seed=seed,
                              arbiter_factory=(lambda: FabricArbiter("weighted-fair", specs)))
                     for seed in seeds]
        results = simulate_batch(scenarios, caches=caches)
        p99s = [r.stream_stats()["serve/decode"].latency_p99 for r in results]
        fins = [r.finish_time() for r in results]
        out["sigmas"][str(sigma)] = {"decode_p99_mean_s": sum(p99s) / len(p99s),
                                     "decode_p99_max_s": max(p99s),
                                     "finish_mean_s": sum(fins) / len(fins),
                                     "seeds": len(seeds)}
    base = out["sigmas"]["0.0"]["decode_p99_mean_s"]
    worst = out["sigmas"][str(sigmas[-1])]["decode_p99_mean_s"]
    out["tail_inflation"] = worst / base if base else 0.0
    return out


def _fit_exponent(points):
    xs = [math.log(n) for n, _ in points]
    ys = [math.log(s) for _, s in points]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def traffic_long_stream(costs, sizes=LONG_STREAM_SIZES):
    """``traffic_study.long_stream``: the mixed scenario grown to about 1M
    stage-ops (``sizes`` of (iterations, decode tokens)); at each size the
    indexed and compiled engines on the same task arrays, timed (best of 3
    up to 60k stage-ops, else 1; compiled best of 2 or more). The host
    seconds and their log-log exponent are printed, not gated: a timing fit
    on a shared host is no correctness check. ``compiled_equal`` is."""
    from repro_torch.core import simulate
    from repro_torch.core.batch import BatchCaches, Scenario
    from repro_torch.topology import make_tpu_pod_topology

    def best(repeat, **kw):
        out, secs = None, float("inf")
        for _ in range(repeat):
            t0 = time.perf_counter()
            out = simulate(topo, groups, task_arrays=ta, **kw)
            secs = min(secs, time.perf_counter() - t0)
        return out, secs

    topo = make_tpu_pod_topology(2, 8, 8)
    caches = BatchCaches()
    detail = []
    for iterations, gen_tokens in sizes:
        graph, _ = _mixed_graph(costs, iterations=iterations, gen_tokens=gen_tokens,
                                n_requests=2, arrival_gap_s=1e-3)
        groups, ta = caches.groups_and_arrays(Scenario(topo, traffic=graph,
                                                       chunks_per_collective=32))
        kw = graph.sim_kwargs()
        repeat = 3 if ta.n_tasks <= 60_000 else 1
        res, secs = best(repeat, engine="indexed", **kw)
        equal = not res.diff_fields(simulate(topo, groups, task_arrays=ta,
                                             engine="compiled", **kw))
        _, secs_c = best(max(repeat, 2), engine="compiled", **kw)
        detail.append({"iterations": iterations, "gen_tokens": gen_tokens,
                       "stage_ops": ta.n_tasks,
                       "stage_ops_match_groups": ta.n_tasks == sum(
                           len(c.schedule) for g in groups for c in g),
                       "makespan_s": res.makespan, "compiled_equal": equal,
                       "indexed_s": secs, "compiled_s": secs_c,
                       "compiled_stage_ops_per_sec": ta.n_tasks / secs_c})
    return {"points": detail,
            "exponent": _fit_exponent([(p["stage_ops"], p["indexed_s"]) for p in detail]),
            "compiled_exponent": _fit_exponent([(p["stage_ops"], p["compiled_s"])
                                                for p in detail]),
            "compiled_speedup_largest": detail[-1]["indexed_s"] / detail[-1]["compiled_s"],
            "largest_stage_ops": detail[-1]["stage_ops"]}


def phase_traffic(state):
    """Dependency-gated traffic through the port (host only): the
    equivalence gate (the IR equals ``simulate_requests`` and the batch
    equals indexed, exactly; indexed and reference within
    ``TRAFFIC_ENGINE_RTOL`` on float values and equal on the rest), the mixed
    tenancy, the DCN jitter and the long stream (compiled equals indexed at
    every size)."""
    costs, s_costs = _timed(traffic_costs)
    equiv, s_equiv = _timed(traffic_equivalence, costs)
    mixed, s_mixed = _timed(traffic_mixed_tenancy, costs)
    dcn, s_dcn = _timed(traffic_dcn_jitter, costs)
    long, s_long = _timed(traffic_long_stream, costs)
    gaps = {kind: {label: sim_gap(*pair) for label, pair in pairs.items()}
            for kind, pairs in equiv.items()}
    del equiv
    emit(traffic={"simulated": True, "serving_costs": costs,
                  "equivalence": {kind: {label: {"max_rel_gap": g, "other_fields_differ": f}
                                         for label, (g, f) in by_label.items()}
                                  for kind, by_label in gaps.items()},
                  "indexed_vs_reference_max_rel_gap": max(
                      g for g, _ in gaps["engines"].values()),
                  "mixed_tenancy": mixed, "dcn_jitter": dcn, "long_stream": long,
                  "host_seconds": {"costs": s_costs, "equivalence": s_equiv,
                                   "mixed_tenancy": s_mixed, "dcn_jitter": s_dcn,
                                   "long_stream": s_long}})
    for kind, rtol in (("exact", 0.0), ("engines", TRAFFIC_ENGINE_RTOL)):
        for label, (gap, fields) in gaps[kind].items():
            assert not fields and gap <= rtol, (
                f"traffic equivalence {label}: largest relative gap {gap} "
                f"(limit {rtol}), other values differ in {fields}")
    bad = [p["stage_ops"] for p in long["points"]
           if not (p["compiled_equal"] and p["stage_ops_match_groups"])]
    assert not bad, f"long stream: compiled differs from indexed at {bad} stage-ops"


# -- phase 7c: fleet and verify ---------------------------------------------------
# The four parts of benchmarks/fleet_study.py and the two of verify_study.py,
# through the port's fleet and verify packages, without their files. A CPU
# test holds each function equal to the study's own part.


def fleet_unit_metrics(res, unit_of):
    """``fleet_study._unit_metrics``: each request unit's (tenant, arrival,
    finish, alive); a shed or failed group kills its unit."""
    dead = {g for g, _ in res.shed_groups} | {g for g, _ in res.failed_groups}
    n_units = max(unit_of) + 1 if unit_of else 0
    arrive, finish = [float("inf")] * n_units, [0.0] * n_units
    tenant, alive = [""] * n_units, [True] * n_units
    for g, u in enumerate(unit_of):
        arrive[u] = min(arrive[u], res.group_issue[g])
        tenant[u] = res.group_tenants[g]
        if g in dead:
            alive[u] = False
        else:
            finish[u] = max(finish[u], res.group_finish[g])
    return [(tenant[u], arrive[u], finish[u], alive[u]) for u in range(n_units)]


def _p99(vals):
    s = sorted(vals)
    return s[min(len(s) - 1, int(0.99 * len(s)))] if s else 0.0


def fleet_calibrate(quick=False):
    """``fleet_study.calibrate_part``: the saturation rate of a closed batch,
    then a traced open-loop run at that rate through ``calibrate_admission``."""
    from repro_torch.fleet import FleetTenant, PoissonArrivals, calibrate_admission, fleet_traffic
    from repro_torch.obs import BwTimeline, Tracer
    from repro_torch.topology import make_table2_topologies
    from repro_torch.traffic import serving_traffic, simulate_traffic

    topo = make_table2_topologies()[FLEET_TOPOLOGY]
    n = 12 if quick else 24
    res, _ = simulate_traffic(topo, serving_traffic(name="cal", arrival_times=[0.0] * n,
                                                    **FLEET_COSTS), engine="indexed")
    sat_rate = n / res.makespan
    graph = fleet_traffic([FleetTenant("web", PoissonArrivals(sat_rate, seed=7),
                                       serving=dict(FLEET_COSTS))],
                          horizon_s=(8 if quick else 16) / sat_rate)
    trc = Tracer()
    simulate_traffic(topo, graph, engine="indexed", tracer=trc)
    n_req = sum(1 for node in graph.nodes if node.name.endswith("prefill-compute"))
    # 64 chunks per collective x the request's wire collectives: chunk-stage
    # queue depth in request units
    per_unit = 64.0 * (FLEET_COSTS["prefill_ops"] + FLEET_COSTS["gen_tokens"])
    calib = calibrate_admission(BwTimeline.from_tracer(trc), window_s=res.makespan / n,
                                n_requests=n_req, target_depth=3.0, chunks_per_unit=per_unit)
    return {"sat_rate_rps": sat_rate, "closed_makespan_s": res.makespan, **calib}


def fleet_overload_run(topo, rate, horizon, *, admission=None, engine="indexed", faults=None):
    """``fleet_study._overload_run``: one Poisson web tenant at ``rate`` over
    ``horizon`` with the sanitizer armed and a fresh controller built from
    the keywords ``admission``; (result, unit of each group)."""
    from repro_torch.fleet import (AdmissionController, FleetTenant, PoissonArrivals,
                                   fleet_traffic, unit_of_group)
    from repro_torch.traffic import simulate_traffic

    graph = fleet_traffic([FleetTenant("web", PoissonArrivals(rate, seed=11),
                                       serving=dict(FLEET_COSTS))], horizon_s=horizon)
    unit_of, unit_priority = unit_of_group(graph)
    ctl = (None if admission is None else
           AdmissionController(unit_of, unit_priority=unit_priority, **admission))
    res, _ = simulate_traffic(topo, graph, engine=engine, admission=ctl, faults=faults,
                              check_invariants=True)
    return res, unit_of


def _fleet_policies(calib):
    cap, est = int(calib["capacity"]), calib["est_service_s"]
    return {"reject-newest": dict(policy="reject-newest", capacity=cap),
            "shed-lowest-priority": dict(policy="shed-lowest-priority", capacity=cap),
            "deadline-aware": dict(policy="deadline-aware", capacity=cap,
                                   deadline_s=cap * est, est_service_s=est)}


def fleet_knee(calib, quick=False):
    """``fleet_study.knee_part``: offered load through and past saturation,
    without admission and under each policy: p99 request latency, goodput
    and shed rate per point, and the study's three gates (returned, not
    raised)."""
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FLEET_TOPOLOGY]
    sat = calib["sat_rate_rps"]
    loads = (0.75, 1.0, 1.5) if quick else FLEET_LOADS
    horizon = (10 if quick else 24) / sat
    policies = _fleet_policies(calib)
    points = []
    for x in loads:
        pt = {"load_x": x, "rate_rps": x * sat}
        for name, kw in (("baseline", None), *policies.items()):
            res, uo = fleet_overload_run(topo, x * sat, horizon, admission=kw)
            units = fleet_unit_metrics(res, uo)
            lats = [f - a for _, a, f, alive in units if alive]
            pt[name] = {"p99_s": _p99(lats), "goodput_rps": len(lats) / res.makespan,
                        "shed_rate": (sum(1 for u in units if not u[3]) / len(units)
                                      if units else 0.0)}
            if kw is None:
                pt[name]["n_requests"] = len(units)
        points.append(pt)
    at_cap = next(p for p in points if abs(p["load_x"] - 1.0) < 1e-9)
    over = [p for p in points if p["load_x"] >= 1.5]
    best = max(p["reject-newest"]["goodput_rps"] for p in points)
    gates = {
        "p99_bounded": all(p[n]["p99_s"] <= P99_GATE * max(at_cap[n]["p99_s"], 1e-12)
                           for p in over for n in policies),
        "baseline_p99_grows": all(p["baseline"]["p99_s"] > at_cap["baseline"]["p99_s"]
                                  for p in over),
        "goodput_retained": all(p["reject-newest"]["goodput_rps"] >= GOODPUT_GATE * best
                                for p in over)}
    return {"loads": list(loads), "horizon_s": horizon, "points": points, "gates": gates}


def fleet_differential(calib, quick=False):
    """``fleet_study.differential_part``: four overload scenarios at 1.6x
    saturation (each policy, and reject-newest under a dim outage) on the
    indexed and reference engines with the sanitizer armed; also on the
    compiled engine, which falls back to indexed under admission and must
    equal it."""
    from repro_torch.faults import DimOutage, FaultSchedule, RetryPolicy
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FLEET_TOPOLOGY]
    sat = calib["sat_rate_rps"]
    horizon = (8 if quick else 16) / sat
    outage = FaultSchedule(events=(DimOutage(dim=1, start=0.3 * horizon, end=0.45 * horizon),),
                           retry=RetryPolicy(timeout_s=0.1 * horizon, backoff_s=0.02 * horizon,
                                             max_attempts=4))
    policies = _fleet_policies(calib)
    scenarios = [(name, kw, None) for name, kw in policies.items()]
    scenarios.append(("overload+outage", policies["reject-newest"], outage))
    results, compiled_equal = [], []
    for name, kw, faults in scenarios:
        res = {eng: fleet_overload_run(topo, 1.6 * sat, horizon, admission=kw, engine=eng,
                                       faults=faults)[0]
               for eng in ("indexed", "reference", "compiled")}
        results.append({"scenario": name, "shed_groups": len(res["indexed"].shed_groups),
                        "failed_groups": len(res["indexed"].failed_groups),
                        "identical": not res["indexed"].diff_fields(res["reference"])})
        compiled_equal.append(not res["indexed"].diff_fields(res["compiled"]))
    return {"scenarios": results, "all_identical": all(r["identical"] for r in results),
            "total_shed_groups": sum(r["shed_groups"] for r in results),
            "compiled_equal_indexed": compiled_equal}


def _slo_tenants(sat):
    """A steady web tenant with a tight SLO against a bursty batch tenant."""
    from repro_torch.fleet import FleetTenant, MMPPArrivals, PoissonArrivals

    period = 4.0 / sat
    return [FleetTenant("web", PoissonArrivals(0.45 * sat, seed=3), serving=dict(FLEET_COSTS),
                        weight=1.0, slo_slowdown=2.5),
            FleetTenant("batch", MMPPArrivals((0.1 * sat, 1.4 * sat), (period, period), seed=4),
                        serving=dict(FLEET_COSTS), weight=1.0)]


def fleet_slo_debt(quick=False):
    """``fleet_study.slo_debt_part``: on each of ``FLEET_SLO_TOPOLOGIES``,
    the worst tenant's SLO-violation rate under ``SloDebtArbiter`` against
    the instantaneous slo-aware policy; ``wins`` counts where the debted
    controller is no worse, ``needed`` is the study's gate."""
    from repro_torch.fleet import fleet_tenant_specs, fleet_traffic, unit_of_group
    from repro_torch.tenancy import FabricArbiter, SloDebtArbiter
    from repro_torch.topology import make_table2_topologies
    from repro_torch.traffic import serving_traffic, simulate_traffic

    topos = make_table2_topologies()
    names = FLEET_SLO_TOPOLOGIES[:2] if quick else FLEET_SLO_TOPOLOGIES
    results, wins = [], 0
    for tn in names:
        topo = topos[tn]
        res8, _ = simulate_traffic(topo, serving_traffic(name="web", arrival_times=[0.0] * 8,
                                                         **FLEET_COSTS), engine="indexed")
        sat = 8 / res8.makespan
        res1, _ = simulate_traffic(topo, serving_traffic(name="web", arrival_times=[0.0],
                                                         **FLEET_COSTS), engine="indexed")
        iso_unit = res1.makespan
        tenants = _slo_tenants(sat)
        graph = fleet_traffic(tenants, horizon_s=(12 if quick else 24) / sat)
        uo, _ = unit_of_group(graph)
        specs = fleet_tenant_specs(tenants)
        # the arbiter's slowdowns are per group, the score's per request unit
        iso_group = {"web": iso_unit / (2 + FLEET_COSTS["gen_tokens"])}
        rates = {}
        for label, arb in (
                ("slo-aware", FabricArbiter("slo-aware", specs, isolated_latency=iso_group)),
                ("slo-debt", SloDebtArbiter(specs, isolated_latency=iso_group,
                                            horizon_s=6.0 / sat, gain=2.0, alpha=0.4))):
            res, _ = simulate_traffic(topo, graph, engine="indexed", arbiter=arb,
                                      check_invariants=True)
            slow = [(f - a) / iso_unit for t, a, f, alive in fleet_unit_metrics(res, uo)
                    if alive and t == "web"]
            rates[label] = sum(1 for s in slow if s > 2.5) / len(slow) if slow else 0.0
        win = rates["slo-debt"] <= rates["slo-aware"] + 1e-12
        wins += win
        results.append({"topology": tn, "sat_rate_rps": sat, "violation_rate": rates,
                        "debt_no_worse": win})
    return {"topologies": results, "wins": wins,
            "needed": 2 if len(names) >= 3 else len(names) - 1}


def fleet_readings(calib, knee, diff, slo):
    """The values the study prints, as it prints them (``FLEET_READINGS``)."""
    adm = [p["reject-newest"]["p99_s"] for p in knee["points"]]
    return {
        "sat_rate_rps": f"{calib['sat_rate_rps']:.0f}", "capacity": calib["capacity"],
        "est_service_s": f"{calib['est_service_s']:.2e}",
        "knee_shed": [f"{p['reject-newest']['shed_rate']:.0%}" for p in knee["points"]],
        "knee_admission_p99_s": [f"{min(adm):.2e}", f"{max(adm):.2e}"],
        "knee_baseline_p99_max_s": f"{max(p['baseline']['p99_s'] for p in knee['points']):.2e}",
        "differential_shed_groups": [r["shed_groups"] for r in diff["scenarios"]],
        "slo_violation_rate": [[f"{t['violation_rate'][k]:.1f}" for k in ("slo-aware", "slo-debt")]
                               for t in slo["topologies"]]}


def phase_fleet(state):
    """Open-loop overload and admission control through the port (host
    only): calibration, the knee, the engines under overload and the SLO-debt
    sweep at the study's full sizes, held to the study's gates and to its
    printed values (``FLEET_READINGS``)."""
    calib, s_cal = _timed(fleet_calibrate)
    knee, s_knee = _timed(fleet_knee, calib)
    diff, s_diff = _timed(fleet_differential, calib)
    slo, s_slo = _timed(fleet_slo_debt)
    readings = fleet_readings(calib, knee, diff, slo)
    emit(fleet={"simulated": True, "calibrate": calib, "knee": knee, "differential": diff,
                "slo_debt": slo, "readings": readings,
                "host_seconds": {"calibrate": s_cal, "knee": s_knee, "differential": s_diff,
                                 "slo_debt": s_slo}})
    assert all(knee["gates"].values()), f"fleet knee gates failed: {knee['gates']}"
    bad = [r["scenario"] for r in diff["scenarios"] if not r["identical"]]
    assert not bad, f"indexed and reference differ under overload in {bad}"
    assert all(diff["compiled_equal_indexed"]), (
        f"compiled differs from indexed under overload: {diff['compiled_equal_indexed']}")
    assert diff["total_shed_groups"] > 0, "the overload never engaged the controller"
    assert slo["wins"] >= slo["needed"], (
        f"slo-debt no worse on {slo['wins']} of {len(slo['topologies'])} topologies")
    wrong = {k: (readings[k], v) for k, v in FLEET_READINGS.items() if readings[k] != v}
    assert not wrong, f"fleet readings differ from the study's (got, want): {wrong}"


def verify_prover(quick=False):
    """``verify_study.prover_part``: ``verify_suite`` over the default
    instances with the ``VERIFY_BACKEND`` backend; (report, the pairs whose verdict is not the expected one,
    the refutations without a bit-identical replay)."""
    from repro_torch.verify import verify_suite

    rep = verify_suite(quick=quick, backend=VERIFY_BACKEND)
    flipped, unreplayed = [], []
    for v in rep["verdicts"]:
        key = (v["instance"], v["property"])
        if v["status"] != ("refuted" if key in VERIFY_EXPECTED_REFUTED else "proved"):
            flipped.append(key)
        if v["status"] == "refuted" and not (
                v["replays"] and all(r["engines_bit_identical"] for r in v["replays"])):
            unreplayed.append(key)
    return rep, flipped, unreplayed


def verify_z3():
    """Where z3 is importable: its version and the pairs whose verdict under
    the z3 backend differs from ``VERIFY_BACKEND``'s (no replays); else
    None."""
    from repro_torch.verify import verify_suite, z3_available

    if not z3_available():
        return None
    import z3

    want = {(v["instance"], v["property"]): v["status"]
            for v in verify_suite(backend=VERIFY_BACKEND, replay=False)["verdicts"]}
    got = verify_suite(backend="z3", replay=False)
    return {"version": z3.get_version_string(), "n_proved": got["n_proved"],
            "n_refuted": got["n_refuted"],
            "differ": [[v["instance"], v["property"], v["status"]] for v in got["verdicts"]
                       if v["status"] != want[(v["instance"], v["property"])]]}


def verify_sanitizer(quick=False):
    """``verify_study.sanitizer_part``: a pinned two-tenant preemption
    stream under weighted-fair on both engines with ``check_invariants`` off
    and on, best of 5 (3 quick): host seconds, their ratio and whether the
    results are identical."""
    from repro_torch.core import simulate_requests
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.tenancy import FabricArbiter, TenantSpec
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()["2D-SW_SW"]
    specs = [TenantSpec("heavy", weight=1.0), TenantSpec("light", weight=4.0, priority=5)]
    reqs = [CollectiveRequest("AR", (200.0 if i % 4 == 0 else 4.0) * MB, issue_time=i * 2e-4,
                              tenant="heavy" if i % 4 == 0 else "light")
            for i in range(24 if quick else 64)]

    def best(eng, check):
        out, secs = None, float("inf")
        for _ in range(3 if quick else 5):
            arb = FabricArbiter("weighted-fair", specs, quantum_chunks=8, preemption=True)
            t0 = time.perf_counter()
            out, _ = simulate_requests(topo, reqs, chunks_per_collective=16, arbiter=arb,
                                       engine=eng, check_invariants=check)
            secs = min(secs, time.perf_counter() - t0)
        return out, secs

    out = {}
    for eng in ("indexed", "reference"):
        (res_off, t_off), (res_on, t_on) = best(eng, False), best(eng, True)
        out[eng] = {"off_s": t_off, "on_s": t_on, "on_over_off": t_on / t_off,
                    "results_identical": not res_off.diff_fields(res_on)}
    return out


def phase_verify(state):
    """The prover and the sanitizer through the port (host only): under
    ``VERIFY_BACKEND``, the verdict pattern of ``verify_study.py``
    (``VERIFY_EXPECTED_REFUTED`` refuted, the rest proved, each refutation
    replayed identically on both engines, the counts of
    ``VERIFY_READINGS``), and the sanitizer off and on giving identical
    results on both engines (its host-time ratios printed, not gated);
    where z3 is importable, its verdicts (printed, not gated: R7)."""
    (rep, flipped, unreplayed), s_prover = _timed(verify_prover)
    sanitizer, s_san = _timed(verify_sanitizer)
    z3_verdicts, s_z3 = _timed(verify_z3)
    readings = {"n_decided": rep["n_decided"], "n_proved": rep["n_proved"],
                "n_refuted": rep["n_refuted"],
                "replays": sum(len(v["replays"]) for v in rep["verdicts"])}
    emit(verify={"simulated": True, "backend": VERIFY_BACKEND, "prover": rep,
                 "readings": readings, "sanitizer": sanitizer, "z3": z3_verdicts,
                 "host_seconds": {"prover": s_prover, "sanitizer": s_san, "z3": s_z3}})
    assert not flipped, f"verdicts differ from the expected pattern: {flipped}"
    assert not unreplayed, f"refutations without an identical replay: {unreplayed}"
    assert readings == VERIFY_READINGS, f"prover readings {readings}, want {VERIFY_READINGS}"
    bad = [eng for eng, r in sanitizer.items() if not r["results_identical"]]
    assert not bad, f"check_invariants changed the results of {bad}"


def _wave_stream(n_requests):
    """The wave stream's chunk groups and issue times: ``n_requests``
    requests of one baseline RS schedule, each chunk a group of its own."""
    from repro_torch.core import schedule_collective
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[WAVE_TOPOLOGY]
    one = schedule_collective(topo, "RS", WAVE_BYTES, WAVE_CHUNKS, "baseline")
    groups = [[c] for _ in range(n_requests) for c in one]
    issue = [r * WAVE_PERIOD_S for r in range(n_requests) for _ in one]
    return topo, groups, issue


def _tiled_wave_arrays(one, n_requests):
    """``wave_arrays`` of ``n_requests`` requests from one request's (issued
    at 0): the arrays tiled, each request's issue time added."""
    import numpy as np

    issue, occupy, fixed, dims = one
    offsets = np.arange(n_requests) * WAVE_PERIOD_S
    return ((offsets[:, None] + issue[None, :]).ravel(), np.tile(occupy, (n_requests, 1)),
            np.tile(fixed, (n_requests, 1)), np.tile(dims, (n_requests, 1)))


def _rel_err(got, want):
    import numpy as np

    return float(np.max(np.abs(got - want) / np.abs(want)))


def _cuda_event_ms(fn, warmup=3, reps=10):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after ``warmup`` calls."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def phase_wave(state):
    """The compiled engine's wave kernel (``wave_done_times``, vectorized
    torch) on the card: the stream at 64, 208 and 640 requests of 4096
    chunks, against the port's ``simulate(engine="compiled", fusion=False)``
    at 64 requests, against its own CPU run and the sequential plain version
    at 640, and a second card call at 640 equal to the first."""
    import numpy as np
    import torch

    from repro_torch.core import engine_compiled as ec
    from repro_torch.core import simulate

    topo, groups, issue = _wave_stream(1)
    one = ec.wave_arrays(topo, groups, issue)
    topo, groups, issue = _wave_stream(16)
    want = ec.wave_arrays(topo, groups, issue)
    tiled_equal = all(np.array_equal(a, w) for a, w in zip(_tiled_wave_arrays(one, 16), want))
    assert tiled_equal, "tiled wave arrays differ from wave_arrays at 16 requests"
    arrays = {n: _tiled_wave_arrays(one, n) for n in WAVE_REQUESTS}
    ec.launches = 0
    done = {n: ec.wave_done_times(*arrays[n]) for n in WAVE_REQUESTS}
    again = ec.wave_done_times(*arrays[WAVE_REQUESTS[-1]])
    launches = ec.launches
    assert launches == len(WAVE_REQUESTS) + 1, launches
    n = WAVE_REQUESTS[0]
    topo, groups, issue = _wave_stream(n)
    ec.reset_fallbacks()  # earlier phases run compiled under faults and admission
    t0 = time.perf_counter()
    res = simulate(topo, groups, engine="compiled", issue_times=issue, fusion=False)
    host_s = time.perf_counter() - t0
    assert ec.LAST_FALLBACK is None, ec.LAST_FALLBACK
    err_sim = _rel_err(done[n], np.asarray(res.group_finish))
    del groups, issue, res
    big = WAVE_REQUESTS[-1]
    t0 = time.perf_counter()
    cpu = ec.wave_done_times(*arrays[big], device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = ec.wave_done_times_plain(*arrays[big])
    plain_s = time.perf_counter() - t0
    err_cpu, err_plain = _rel_err(done[big], cpu), _rel_err(done[big], plain)
    same = bool(np.array_equal(done[big], again))
    rows = []
    for n in WAVE_REQUESTS:
        issue_t, occupy, fixed, dims = (torch.as_tensor(x, device="cuda") for x in arrays[n])
        C, R = occupy.shape
        ms = _cuda_event_ms(lambda: ec._wave_scan(issue_t, occupy, fixed, dims))
        call_ms = _cuda_event_ms(lambda: ec.wave_done_times(*arrays[n]), reps=5)
        # each input read once (issue C, occupy, fixed and dims C x R, 8 bytes
        # each), the done times written once (C); five float64 operations per
        # chunk and rank in the closed form
        bound_ms, bound_by = _bound(8 * (2 * C + 3 * C * R), 5 * C * R, "float64")
        rows.append({"requests": n, "chunks": C, "ranks": R, "ms": ms, "call_ms": call_ms,
                     "stage_ops_per_s": C * R / (ms * 1e-3), "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_fraction": bound_ms / ms})
        del issue_t, occupy, fixed, dims
    checks = {"tiled_arrays_equal_wave_arrays_at_16": tiled_equal,
              "rel_err_vs_simulate_compiled_at_64": err_sim,
              "rel_err_vs_cpu_at_640": err_cpu, "rel_err_vs_plain_at_640": err_plain,
              "second_call_equal": same, "rtol": WAVE_RTOL}
    emit(wave={"card": state["card"], "rows": rows, "checks": checks,
               "host_simulate_compiled_s_at_64": host_s, "cpu_torch_s_at_640": cpu_s,
               "plain_s_at_640": plain_s, "launches": launches})
    assert err_sim <= WAVE_RTOL, f"wave vs simulate_compiled: {err_sim}"
    assert err_cpu <= WAVE_RTOL, f"wave card vs cpu: {err_cpu}"
    assert err_plain <= WAVE_RTOL, f"wave card vs plain: {err_plain}"
    assert same, "wave: a second card call differs"
    top = rows[-1]
    state["wave_kernel"] = {
        "name": "wave_done_times", "route": "torch", "path": "simulator",
        "source": "src/repro_torch/core/engine_compiled.py",
        "replaces": "src/repro/core/engine_compiled.py:962 (jax.jit, not Pallas)",
        "launches": launches, "max_abs_err": float(np.max(np.abs(done[big] - plain))),
        "ms": top["ms"], "plain_ms": plain_s * 1e3, "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": None, "call_ms": top["call_ms"],
        "cpu_torch_ms": cpu_s * 1e3, "stage_ops_per_s": top["stage_ops_per_s"],
        "shape": {"chunks": top["chunks"], "ranks": top["ranks"], "dtype": "float64/int64"},
        "plain": "wave_done_times_plain: the sequential loop, float64 on the host CPU",
        "library": "none: no single PyTorch call computes a segmented max-plus scan"}


# the dry run's cells (arch, shape, extra flags): one per family on the
# 16x16 mesh, and llama3-8b's training on the 2x16x16 multi-pod mesh
DRYRUN_CELLS = (("llama3-8b", "train_4k", ()),
                ("qwen2.5-3b", "train_4k", ("--dp-sync", "themis")),
                ("deepseek-moe-16b", "train_4k", ()),
                ("internvl2-26b", "prefill_32k", ()),
                ("whisper-medium", "decode_32k", ()),
                ("xlstm-1.3b", "long_500k", ()),
                ("recurrentgemma-2b", "decode_32k", ()),
                ("llama3-8b", "train_4k", ("--multi-pod",)))
DRYRUN_KEYS = {"arch", "shape", "kind", "mesh", "chips", "dp_sync", "status",
               "n_params", "lower_s", "compile_s", "memory", "cost",
               "collectives_hlo", "roofline"}
DRYRUN_TIMEOUT_S = 300


def phase_dryrun(state):
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS, one
    subprocess each (a process holds one default process group), all at
    once, writing under a temporary directory: each cell ``status: ok`` with
    the reference's keys, and each train cell counting at least one
    all-reduce, all-gather and reduce-scatter. Prints per-device GiB
    against the card's 80, FLOPs, bytes by kind and seconds per cell. Host
    only: meta tensors on a fake group."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    procs = []
    try:
        t0 = time.perf_counter()
        for arch, shape, extra in DRYRUN_CELLS:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, *extra, "--out", tmp], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append((p.returncode, out, err, time.perf_counter() - t0))
        lines, fails = [], []
        for (arch, shape, extra), (rc, out, err, wall) in zip(DRYRUN_CELLS, outs):
            mp = "--multi-pod" in extra
            dp = extra[extra.index("--dp-sync") + 1] if "--dp-sync" in extra else "gspmd"
            tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}_{dp}"
            path = os.path.join(tmp, tag + ".json")
            res = json.load(open(path)) if os.path.exists(path) else {}
            lines.append({"arch": arch, "shape": shape, "mesh": res.get("mesh"),
                          "dp_sync": dp, "status": res.get("status"), "rc": rc,
                          "per_device_total_gib": res.get("memory", {}).get(
                              "per_device_total_gib"), "card_gib": 80,
                          "memory": res.get("memory"),
                          "flops_per_device": res.get("cost", {}).get("flops"),
                          "bytes_by_kind": res.get("collectives_hlo", {}).get(
                              "bytes_by_kind"),
                          "op_counts": res.get("collectives_hlo", {}).get("op_counts"),
                          "lower_s": res.get("lower_s"), "process_wall_s": wall})
            if rc != 0 or res.get("status") != "ok":
                fails.append(f"{tag}: rc {rc}, status {res.get('status')}: "
                             f"{err[-1500:]}")
                continue
            if not DRYRUN_KEYS <= set(res):
                fails.append(f"{tag}: keys {sorted(res)}")
            kinds = set(res["collectives_hlo"]["op_counts"])
            if res["kind"] == "train" and not {"all-reduce", "all-gather",
                                               "reduce-scatter"} <= kinds:
                fails.append(f"{tag}: collectives {sorted(kinds)}")
        emit(dryrun={"cells": lines, "seconds": time.perf_counter() - t0,
                     "card": state["card"]})
        assert not fails, fails
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_times(state):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    hb, hs, hd = HYB_TRAIN_X
    kernels = [
        # K1 at llama3-8b's prefill shape: q (4,512,32,128), k/v (4,528,8,128)
        _time_flash(state, gen, ARCH, BATCH, PROMPT, 32, 8, 128, PROMPT + GEN, 0,
                    iters=50),
        _time_rmsnorm(state, gen, ARCH, (BATCH, PROMPT, 4096)),
        # K3, K1 and K2 at recurrentgemma-2b's prefill shapes
        _time_rglru(state, gen, HYB_ARCH, BATCH, HYB_PROMPT, hd, True),
        _time_flash(state, gen, HYB_ARCH, BATCH, HYB_PROMPT, HYB["h"], HYB["kv"],
                    HYB["d"], HYB_PROMPT, HYB["window"], iters=20),
        _time_rmsnorm(state, gen, HYB_ARCH, (BATCH, HYB_PROMPT, hd)),
        # K1 and K2 at qwen2.5-3b's training shapes: q (4,1024,16,128),
        # k/v (4,1024,2,128); x (4,1024,2048)
        _time_flash(state, gen, "train", TRAIN_BATCH, TRAIN_SEQ, QWEN["h"],
                    QWEN["kv"], QWEN["d"], TRAIN_SEQ, 0, iters=50),
        _time_rmsnorm(state, gen, "train", (TRAIN_BATCH, TRAIN_SEQ, QWEN["d_model"])),
        # K1's and K2's backward kernels at the same training shapes
        _time_attention_backward(state, gen, "train", TRAIN_BATCH, TRAIN_SEQ,
                                 QWEN["h"], QWEN["kv"], QWEN["d"], 0, 50),
        _time_rmsnorm_backward(state, gen, "train",
                               (TRAIN_BATCH, TRAIN_SEQ, QWEN["d_model"]),
                               2 * QWEN["layers"] + 1),
        # K1, K2 and K3, forward and backward, at recurrentgemma-2b's training
        # shapes: q (2,4096,10,256), k/v (2,4096,1,256), window 2048;
        # x, a, b (2,4096,2560)
        _time_flash(state, gen, "hybrid_train", hb, hs, HYB["h"], HYB["kv"],
                    HYB["d"], hs, HYB["window"], iters=20),
        _time_attention_backward(state, gen, "hybrid_train", hb, hs, HYB["h"],
                                 HYB["kv"], HYB["d"], HYB["window"], 20),
        _time_rmsnorm(state, gen, "hybrid_train", HYB_TRAIN_X),
        _time_rmsnorm_backward(state, gen, "hybrid_train", HYB_TRAIN_X, 53),
        _time_rglru(state, gen, "hybrid_train", hb, hs, hd, False),
        _time_rglru_backward(state, gen, hb, hs, hd),
        # K1 and K2 at the two new prefills: qwen2.5-14b q (4,512,40,128),
        # k/v (4,528,8,128), x (4,512,5120); granite-34b q (4,512,48,128),
        # k/v (4,528,1,128), x (4,512,6144)
        _time_flash(state, gen, DENSE14B, *QWEN14B_ATTN, iters=50),
        _time_rmsnorm(state, gen, DENSE14B, (BATCH, PROMPT, QWEN14B["d_model"])),
        _time_flash(state, gen, GRANITE, *GRANITE_ATTN, iters=50),
        _time_rmsnorm(state, gen, GRANITE, (BATCH, PROMPT, GRANITE_D["d_model"])),
    ]
    # the MoE, VLM, audio and SSM prefills, from a generator of their own so
    # the rows above keep their inputs: K1 at deepseek-moe-16b's q
    # (4,512,16,128) k/v (4,528,16,128), qwen3-moe's (4,512,64,128) on 4 kv
    # heads, internvl2-26b's (4,768,48,128) on 8; whisper's three shapes
    # (the encoder and the cross-attention non-causal, against SDPA with
    # is_causal=False); K2 at each path's widest norm
    fam = torch.Generator(device="cuda").manual_seed(29)
    for key in ("whisper_enc", "whisper_cross", "whisper_self"):
        state[key] = state[WHISPER]
    by_shape = state[WHISPER]["k1_by_shape"]
    kernels += [
        _time_flash(state, fam, MOE16B, *MOE16B_ATTN, iters=50),
        _time_rmsnorm(state, fam, MOE16B, MOE16B_X),
        _time_flash(state, fam, QWEN3MOE, *QWEN3MOE_ATTN, iters=50),
        _time_rmsnorm(state, fam, QWEN3MOE, QWEN3MOE_X),
        _time_flash(state, fam, VLM, *VLM_ATTN, iters=50),
        _time_rmsnorm(state, fam, VLM, VLM_X),
        _time_flash(state, fam, "whisper_enc", *WHISPER_ENC_ATTN[:-1], 0, iters=20,
                    causal=False, launches=by_shape["enc"]),
        _time_flash(state, fam, "whisper_cross", *WHISPER_CROSS_ATTN[:-1], 0,
                    iters=50, causal=False, launches=by_shape["cross"]),
        _time_flash(state, fam, "whisper_self", *WHISPER_SELF_ATTN, iters=50,
                    launches=by_shape["self"]),
        _time_rmsnorm(state, fam, WHISPER, WHISPER_X),
        _time_rmsnorm(state, fam, XLSTM, XLSTM_X),
        _time_slstm(state, XLSTM, *XLSTM_GX[:2], iters=20,
                    launches=state[XLSTM]["per_step"][0][1]["slstm_scan"],
                    err_key="slstm_scan_xlstm"),
    ]
    # K1, K2 and their backwards at deepseek-moe-16b's training shapes, from
    # a generator of their own
    moe = torch.Generator(device="cuda").manual_seed(37)
    mb, ms_, mh, mkv, md, _, _ = MOE16B_TRAIN_ATTN
    kernels += [
        _time_flash(state, moe, "moe16b_train", *MOE16B_TRAIN_ATTN, iters=50),
        _time_attention_backward(state, moe, "moe16b_train", mb, ms_, mh, mkv, md,
                                 0, 50),
        _time_rmsnorm(state, moe, "moe16b_train", MOE16B_TRAIN_X),
        _time_rmsnorm_backward(state, moe, "moe16b_train", MOE16B_TRAIN_X,
                               2 * MOE_TRAIN["layers"] + 1),
    ]
    kernels += _family_train_rows(state)
    kernels += _cell_rows(state)
    emit(rmsnorm_decode_shape=_time_rmsnorm(state, gen, ARCH, (BATCH, 1, 4096)))
    emit(times={"card": state["card"], "peak_bytes_per_s": PEAK_BYTES_PER_S,
                "peak_ops_per_s": PEAK_OPS_PER_S,
                **{f"{k}_{m}": v
                   for k in ("train", "hybrid_train", "train_dots", "hybrid_train_dots")
                   for m, v in (("step_ms", state[k]["step_ms"]),
                                ("step_floor_ms", state[k]["floor_ms"]),
                                ("floor_share", state[k]["floor_ms"]
                                 / state[k]["step_ms"]),
                                ("model_flops_share", state[k]["model_flops_share"]))}})
    emit(times_family_train={
        "card": state["card"],
        **{k: {m: state[k][m] for m in ("step_ms", "busy_share",
                                        "busy_share_of_median_step", "peak_mem_gib")}
           for k in ("whisper_train", "vlm_train", "qwen3moe_train", "xlstm_train")}})
    state["kernels"] = kernels + [state["wave_kernel"]]


def _cell_rows(state):
    """K1, K2, K3 and the backwards at the shape cells' shapes, from a
    generator of their own; each row's launches are its shape's in the
    cell's counted run (serving: a prefill and 16 decode steps; decode_32k:
    the bf16 cache's 16 timed steps; train_4k: the GSPMD run's steps)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(53)
    p32k = state["prefill_32k"]["per_step"][0][1]       # the prefill's launches
    l500k = state["long_500k"]["per_step"][0][1]
    mb = state["train_4k"]["microbatch"]
    b, s, h, kv, d, _, _ = P32K_ATTN
    # over 32,768 keys: SDPA's is_causal aligns its mask top-left only where
    # q and k are equally long; the path's 16 more cache positions lie past
    # every query's mask, and the kernel check covers them (T = 32,784)
    k1_32k = _time_flash(state, gen, "prefill_32k", b, s, h, kv, d, s, 0, iters=10,
                         launches=p32k["flash_attention_sm90"],
                         err_key="flash_attention_prefill_32k", plain_rows=512)
    k1_32k["note"] = (f"the path's k/v hold {P32K_S + CELL_GEN} positions; timed at "
                      f"{P32K_S}, where SDPA's causal mask is the same")
    return [
        k1_32k,
        _time_rmsnorm(state, gen, "prefill_32k", P32K_X, launches=p32k["rmsnorm"],
                      err_key="rmsnorm_prefill_32k"),
        _time_rmsnorm(state, gen, "decode_32k", (D32K_B, 1, 4096),
                      launches=state["decode_32k bf16"]["launches"]["rmsnorm"],
                      err_key="rmsnorm_decode_32k"),
        _time_flash(state, gen, "long_500k", *L500K_ATTN, iters=10,
                    launches=l500k["flash_attention_sm90"],
                    err_key="flash_attention_long_500k", plain_rows=2048,
                    no_library="none: SDPA takes a window only as a dense boolean "
                               f"mask of {L500K_S} x {L500K_S} (275 GB); is_causal "
                               "has no window"),
        _time_rmsnorm(state, gen, "long_500k", L500K_X, launches=l500k["rmsnorm"],
                      err_key="rmsnorm_long_500k"),
        _time_rglru(state, gen, "long_500k", *L500K_X, True,
                    err_key="rglru_scan_long_500k", blocked_plain=True),
        _time_flash(state, gen, "train_4k", *T4K_ATTN, iters=20,
                    err_key="flash_attention_train_4k"),
        _time_attention_backward(state, gen, "train_4k", *T4K_ATTN[:5], 0, 20,
                                 err_key="flash_attention_backward_train_4k",
                                 calls_per_step=QWEN["layers"] * mb),
        _time_rmsnorm(state, gen, "train_4k", T4K_X, err_key="rmsnorm_train_4k"),
        _time_rmsnorm_backward(state, gen, "train_4k", T4K_X, (2 * QWEN["layers"] + 1) * mb,
                               err_key="rmsnorm_backward_train_4k"),
        _time_slstm(state, "long_500k_xlstm", *L500K_GX[:2], iters=2,
                    launches=state["long_500k_xlstm"]["per_step"][0][1]["slstm_scan"],
                    err_key="slstm_scan_long_500k"),
    ]


def _family_train_rows(state):
    """K1, K1's backward, K2 and K2's backward at the shapes of the four
    families' training steps, from a generator of their own; each row's
    launches, and calls per step, are its shape's in that run
    (``_tally_by_shape``; the VLM's last norm, for one, runs on the 768
    token positions alone)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(43)

    def n(key, kind, shape):
        return state[key]["by_shape"].get((kind, shape), 0)

    def attn(key, shape, fkey, bkey):
        b, s, h, kv, d, t, win = shape
        causal, iters = win is not None, 20 if s == WH_F else 50
        fwd = n(key, "flash_attention_sm90", (s, t, causal))
        bwd = n(key, "flash_attention_bwd_sm90", (s, t, causal))
        return [_time_flash(state, gen, key, b, s, h, kv, d, t, win or 0, iters=iters,
                            causal=causal, launches=fwd, err_key=fkey),
                _time_attention_backward(state, gen, key, b, s, h, kv, d, win or 0, iters,
                                         t=t, causal=causal, launches=bwd, err_key=bkey,
                                         calls_per_step=bwd // FAM_TRAIN_STEPS)]

    def norm(key, x, fkey, bkey):
        bwd = n(key, "rmsnorm_bwd", x)
        return [_time_rmsnorm(state, gen, key, x, launches=n(key, "rmsnorm", x),
                              err_key=fkey),
                _time_rmsnorm_backward(state, gen, key, x, bwd // FAM_TRAIN_STEPS,
                                       launches=bwd, err_key=bkey)]

    # the xLSTM's two widths share their shapes, and so their checks, with
    # deepseek-moe-16b's and qwen3-moe's training norms
    return (attn("whisper_train", WHISPER_ENC_ATTN, "flash_attention_whisper_enc",
                 "flash_attention_backward_whisper_enc")
            + attn("whisper_train", WHISPER_TRAIN_CROSS, "flash_attention_whisper_train_cross",
                   "flash_attention_backward_whisper_cross")
            + attn("whisper_train", WHISPER_TRAIN_SELF, "flash_attention_whisper_train_self",
                   "flash_attention_backward_whisper_self")
            + norm("whisper_train", WHISPER_X, "rmsnorm_whisper",
                   "rmsnorm_backward_whisper_enc")
            + norm("whisper_train", WHISPER_DEC_X, "rmsnorm_whisper_dec",
                   "rmsnorm_backward_whisper_dec")
            + attn("vlm_train", VLM_TRAIN_ATTN, "flash_attention_vlm_train",
                   "flash_attention_backward_vlm_train")
            + norm("vlm_train", VLM_TRAIN_X, "rmsnorm_vlm_train", "rmsnorm_backward_vlm_train")
            + attn("qwen3moe_train", QWEN3MOE_TRAIN_ATTN, "flash_attention_qwen3moe_train",
                   "flash_attention_backward_qwen3moe_train")
            + norm("qwen3moe_train", QWEN3MOE_TRAIN_X, "rmsnorm_qwen3moe_train",
                   "rmsnorm_backward_qwen3moe_train")
            + norm("xlstm_train", XLSTM_TRAIN_X, "rmsnorm_moe16b_train", "rmsnorm_backward")
            + norm("xlstm_train", QWEN3MOE_TRAIN_X, "rmsnorm_qwen3moe_train",
                   "rmsnorm_backward_qwen3moe_train"))


if __name__ == "__main__":
    sys.exit(main())
