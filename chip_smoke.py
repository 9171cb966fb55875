#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``distributed_learning_tpu_torch``) on
one NVIDIA card: the quickest proof that the port builds and trains there.

    python3 chip_smoke.py [--profile] [--out DIR]
    python3 chip_smoke.py --decode-timing N | --step-timing N
    python3 chip_smoke.py [--wide-only] [--d256-only] [--d32-only] [--sharded-only]
    python3 chip_smoke.py --sass-against DIR

Phases, each printing one JSON line (any failure exits non-zero; ``at_s``
in each is the seconds since the process started, so a slow phase shows):

1. build   — compile ``csrc/*.cu`` with nvcc, one process per source, all
             together; prints the seconds and each kernel's registers and
             spills as ptxas reports them (the D-256 and D-32 forwards'
             apart, the latter with its shared memory; the wide wgmma
             forward's four instantiations with its shared memory by head
             dim and its cluster shape).
2. kernels — each flash-attention kernel and the backward's pre-pass
             against its plain PyTorch version on the same card tensors:
             the slice's launch shape (4 agents x B 2 x 8 heads, T 4096,
             head dim 128, bf16, causal; there the limits must also reject
             a dQ whose first Q tile and a dK or dV whose last key tile is
             zeroed), the lse cotangent (``dadj``) path, a
             windowed ragged case, a non-causal case, head-dim-64 cases,
             the edges of the wgmma bodies' 128-row tiles (T 64, T 129, a
             window of 100 over T 1000, non-causal T 333) and head dims the
             kernels run zero-padded (48, 96; float32 16); head dim 32 (bf16:
             the forward, dQ and dK/dV on their wgmma bodies with 64-byte
             rows; float32 all CUDA-core) at the slice's model
             width and T as 32 heads x 32 (B 1, with the tile controls and
             the lse cotangent), windowed and ragged, non-causal and ragged,
             and 8 and 16 zero-padded to 32, with the bodies the bf16 cases
             launched checked; head dim 256
             (bf16: all three on their wgmma bodies, the forward with
             64-key tiles; float32 all CUDA-core) at the
             slice's model width as 4 heads x 256 (B 2, T 4096, with the
             tile controls), windowed and ragged, non-causal and ragged,
             float32, and head dim 192 zero-padded to 256, with the bodies
             the bf16 cases launched checked;
             head dims above 256 (bf16: the forward on its wide wgmma
             body, O's columns split across blocks; dQ, dK/dV and float32
             on the wide CUDA-core bodies, walked in 128-column chunks) at
             the slice's width as 2 heads x 512 (with the tile controls,
             a control that zeroes O's last 128 columns, and the lse
             cotangent), 320 run at 384 with the lse cotangent, 384
             windowed and ragged, 640 non-causal, 1152 windowed and
             ragged, non-causal, and causal with the lse cotangent,
             float32 512 and 320, with the bodies each case launched
             checked.
3. slice   — ``MasterNode`` over 4 agents on ``Topology.ring(4)`` training
             the full-width TransformerLM (8 layers, 8 x 128 heads, vocab
             8192, T 4096, B 2 per agent, bf16 over float32 weights, adam)
             for 3 epochs of 3 steps with one gossip round per epoch, on
             cyclic token windows; launch counts must match layers x steps
             (the pre-pass once per layer backward), and every forward, dQ
             and dK/dV launch must take the wgmma body.
4. plain   — from identical weights, one training step through the kernels
             and one through plain attention (``attn_impl="full"``):
             the loss and every leaf's gradient (Q, K and V weights
             apart) must agree per agent, and a control step whose dK/dV
             drops key tile 0 must not.
5. times   — each kernel at the slice's shape: CUDA-event time, its bound
             on this card, its plain version's time, and
             ``scaled_dot_product_attention``'s time as a yardstick (for
             the pre-pass a ``vecdot``); then the same at 4 heads x 256
             (``times_d256``, the D-256 bodies), 2 heads x 512
             (``times_wide``: the wide wgmma forward, the wide CUDA-core
             dQ and dK/dV), in float32 at the slice's width, at 4 heads x
             256 and at 2 heads x 512 (``times_f32``, ``times_f32_d256``,
             ``times_f32_wide``: the float32 CUDA-core bodies, SDPA in
             float32 their yardstick) and at 32 heads x 32
             (``times_d32``: the wgmma forward, dQ and dK/dV).  A bound is the largest
             of the bytes, the products and (below head dim 64 the largest)
             the exponentials over the special-function units' rate.
   profile — with ``--profile``: one ``torch.profiler`` window over one
             more epoch of the slice (steps, gossip, eval), device time by
             kernel name; the full table is written to ``--out``.
6. conv_layout — every WRN-28-10 convolution, forward and both backward
             products at 4 agents x B 256 in bf16, as one cuDNN call per
             agent (the layout models/vision.py keeps) and as one grouped
             call with groups=4, timed in turns.
7. vision_slice — the paper's own path at full depth and width:
             ``MasterNode`` over 4 agents on ``Topology.ring(4)`` training
             WRN-28-10 (bf16 over float32 weights, dropout 0.3, SGD lr 0.1,
             momentum 0.9, weight decay 5e-4, augmentation on) on
             normalized synthetic CIFAR-10, B 256 per agent, 3 epochs of 4
             steps with one gossip round and an eval of 1024 images per
             epoch; the loss must fall, the running statistics must differ
             across agents after the first epoch, every gossip round must
             lower the deviation, and no flash kernel may launch.
   vision_profile — with ``--profile``: one profiled epoch of it, device
             time split into convolutions, optimizer, gossip, augmentation,
             BatchNorm/elementwise/the rest, and idle; the table is written
             to ``--out``.
8. vision_plain — one WRN-16-4 step (4 agents x B 8, float32) on the card
             and on the CPU from the same weights and batch: loss, every
             leaf's gradient and the new running statistics per agent; a
             control in which agent 1 is normalised with agent 0's batch
             statistics must fail the same limits.
9. zoo     — LeNet, VGG-16, ResNet-20 and the MLP for one epoch of 2 steps
             each, ``prefetch_to_device`` streaming 4 batches to the card,
             and 200 iterations of the Titanic K4 consensus GD
             (``examples/titanic_consensus_gd.py``'s loop); finite, falling.

10. superstep — WRN-28-10 as in vision_slice: ``train_epochs(3)`` as CUDA-graph
             replays against 3 eager ``train_epoch()`` calls from the same
             init and seeds, under deterministic algorithms: parameters,
             running statistics, optimizer state, traces, round counts and
             deviations must be equal bit for bit (or within the spread of
             two eager runs, which is reported); a control superstep whose
             index buffer is not refreshed after epoch 0 must be rejected;
             no host sync inside the replays.  Then the eager and superstep
             epoch times, capture time, replays per epoch and peak memory
             (``superstep_timing``), and with ``--profile`` one profiled
             superstep (table in ``--out``/profile_wrn_superstep.txt).
11. lm_superstep — the same for the LM slice, and the replay-aware launch
             counts: layers x steps x 3 for every kernel (plus the boundary
             eval's forwards), all on the wgmma body.
12. superstep_routes — plain, ``mix_times_schedule``, Chebyshev, Gossip-PGA,
             ``topology_schedule`` (also with Chebyshev), an Adam
             learning-rate schedule, the port's AdamW with ``eps_root``,
             ``adaptive_comm`` and ``mix_eps`` on
             the MLP (784 -> 150, 4 agents x B 64): graph against eager, and
             the host syncs per superstep (0 for every fixed-count one).
             The WRN superstep also compares eval-mode logits of 256 test
             images, and reports what sets the test accuracy (eval-mode
             accuracy and top-class share against per-batch statistics).
13. choco_slice — WRN-28-10 as vision_slice with top-k CHOCO (10% per leaf,
             gamma 0.2): two supersteps of 3 epochs as graph replays; per
             epoch the loss, post-mix deviation, rate and each replay's
             device time; the round's parts timed alone, the nominal wire
             bytes against the dense round's, peak memory, and the dense
             superstep epoch of phase 10 beside it.
14. choco_routes — the card's top-k keeps the CPU's entries (NaN, ties),
             then top-k per leaf, top-k global with error feedback,
             random-k, sign, int8, approximate top-k, Gossip-PGA resets
             (top-k and random-k), ``mix_times_schedule`` and
             ``adaptive_comm`` on the MLP: graph replays against eager
             epochs bit for bit, estimates and generator included.
15. checkpoint — the WRN-28-10 CHOCO run saves after 2 epochs and trains
             one more; a fresh trainer restores and trains that epoch: equal
             bit for bit; the checkpoint's bytes, save and restore seconds.
16. async_slice — WRN-28-10 as vision_slice with asynchronous gossip on the
             Metropolis ring, two rounds an epoch, agent 3 a straggler that
             publishes every third round (``staleness_bound`` 1, so its
             pull is halved, then dropped): graph against eager bit for bit,
             the carry (published buffer, ages, round counter) included,
             0 host syncs; two supersteps of 3 epochs with the per-epoch
             loss and deviation, the ages and round counter after each
             superstep, each replay's device time, the superstep epoch
             beside phase 10's dense one, the async round alone against its
             byte bound, and peak memory.
17. robust_slice — the same for (a) the straggler's async gossip through
             the trimmed mean (trim 1) on ``Topology.complete(4)`` and (b)
             clipped gossip with an adaptive radius (2x the median
             neighbour distance) on the ring: the redirected mass per epoch
             (> 0 for (a)) included in the bitwise check, each round alone
             against its byte bound, peak memory, and for (b) the Gram
             form's cancellation (``pairwise_sq_dists`` against float64
             direct distances on the trainer's buffers).
18. robust_routes — async (neutral, straggler, a ``staleness_bound``
             schedule, with ``mix_times_schedule``, with ``adaptive_comm``),
             clip, adaptive clip, trim and median on ``complete(4)``, async
             clip and async trim on the MLP of superstep_routes: graph
             against eager bit for bit, host syncs (0 but for
             ``adaptive_comm``); async tau 0, clip radius inf and trim 0
             bitwise the plain route; the persistent-liar attack (8 agents,
             ``complete(8)``, 2 liars at 1e3, 6 rounds): plain spread > 50,
             clip 2.0, trim 2, median and async clip < 5, the async clip's
             mass > 0 every round, and each card round equal to the CPU's
             round from the same input and carry (2e-6 relative, one
             float32 step at 1e3 absolute).
19. tracking_slice — DSGT and EXTRA (``project_every`` 2) train the LM
             slice's model at full depth and width: 4 agents on the
             Metropolis ring, B 2 per agent on each agent's own token
             stream, step 0.5, ``init`` and 3 steps each through the
             stacked gradient oracle (one forward/backward of the
             agent-stacked LM into ``flat_grads``).  Per step: CUDA-event
             ms split into gradients and gossip/update beside the update's
             byte bound, the loss, the residual, host syncs (0), peak
             memory, DSGT's tracker sum gap; the flash launches (counted
             under ``lm_tracking``: layers x 8 oracle calls, all on the
             wgmma body).  Then both engines at 2 layers through the
             kernels and through plain attention: the plain model's loss
             at every state the kernel path's oracle saw (2e-4), the
             trajectories' displacement and tracker or difference (5e-2
             relative), the tracking invariant (1e-5 of max |sum_i g_i|),
             and a control step whose tracker update forgets ``- g_old``,
             which must break it.
20. tracking_routes — DSGT, EXTRA and gossip GD (grad step, one round)
             for 200 steps on the label-skewed synthetic Titanic logreg:
             the card against the port on the CPU (1e-4), 0 host syncs in
             a run on the card.
21. pushsum_pairwise — push-sum on a directed ring of 4 over 4 x
             36,489,290 float32 (WRN-28-10's parameter count, normal from
             a seed): numerator and weight totals kept (1e-5 relative),
             estimates at the mean of x0 after 40 rounds, ms a round
             against its byte bound; 64 pairwise rounds on the same
             buffers: the mean kept (1e-6), ms a round; both against the
             CPU on fed draws at width 4096 (2e-6).
22. mixer_interop — ``TorchModelMixer`` over 4 port WRN-28-10 replicas
             (``n_agents=1``, each its own init) on the ring: equal to
             ``ConsensusEngine.mix_`` on the stacked buffers (2e-6), the
             running statistics untouched, ms a mix against the bound of
             reading and writing every parameter once.

23. obs_superstep — WRN-28-10 as phase 10 runs it: ``train_epochs(3)``
             with obs on (``obs=MetricsRegistry()``, ``profile_costs``,
             ``timer_every_n=1``) against obs off, bit for bit under
             deterministic algorithms, 0 host syncs inside either
             superstep, the engines' counters (default registry) and the
             trainer's round counter equal to those of 3 eager epochs;
             the epoch-time delta of a second superstep, the step
             profile's FLOPs against ``wrn_conv_flops``, the timer's step
             time against phase 10's events, MFU; then one superstep
             under ``utils/profiling.trace``: ``summarize_trace``'s top
             rows and the share of the event-timed window its device
             rows cover.  The obs-on registry is dumped to JSONL.
24. obs_lm — the same checks on the full-width flash LM superstep; A,
             B, C and the pre-pass launched by it (the profile step's
             launches uncounted); the profile's FLOPs a step within 2%
             of ``lm_step_flops``; MFU.
25. lm_eval — ``training/eval.perplexity`` of that LM, trained to 12
             epochs, on 8 x 4096 tokens through kernel A alone (no
             backward launch): ms by CUDA events, tokens/s, perplexity
             <= vocab; the 2-layer LM through kernel A against plain
             attention from one seed (1e-3 relative).
26. cli    — ``cli.main`` in process: WRN-10-10 on synthetic CIFAR, 4
             nodes x B 256, 4096 images, supersteps of 2: 2 epochs and
             ``--resume`` to 3 against an uninterrupted 3-epoch run, the
             checkpoints equal bit for bit; ``--testOnly``; ``obs-report``
             over phase 23's JSONL (exit 0).  Checkpoints removed after.

27. lm_extras — the LM slice's model with rope, 2 KV heads, top-2 MoE over
             4 experts (capacity 1.25) and dropout 0.1 (306,423,808
             params per agent), 4 agents on the ring, adam, B 1 (B 2
             does not fit the superstep's captures), ``moe_aux_coef``
             0.01: 3 eager epochs of 3 steps (A, B, C
             and the pre-pass counted: 8 layers x steps, plus the evals'
             forwards) against ``train_epochs(3)`` as graph replays with
             obs on, bit for bit under deterministic algorithms, 0 host
             syncs; tokens/s, the timer's MFU and peak memory beside the
             dense slice's from this run; the trainer's loss equal to CE
             + 0.01 aux; each block's dropped fraction.
28. lm_extras_plain — that model at 2 layers, 2 agents, dropout off: one
             step through the kernels against plain attention under
             phase 4's limits; the control rotates Q but not K.  Every
             route the plain path would flip is a near-tie
             (``ROUTE_FLIP_RTOL``), and so is every route flipped by a
             witness run with the plain attention in float32, at a
             tighter limit (``ROUTE_FLIP_F32_RTOL``); a confident route
             swapped to another expert must fail both bounds.
29. lm_remat — that model at 2 layers with dropout: one epoch with
             ``remat`` off, on, and on as a graph replay, bit for bit,
             flash launches equal; step ms by CUDA events and peak memory
             both ways.
30. lm_decode — ``generate`` at ``benchmarks/bench_lm.py``'s full-scale
             decode (1 agent, 8 layers, B 2, prefill 2048 + 256 greedy
             steps, bf16; MHA and 2 KV heads): tokens/s by the
             prefill-subtracted protocol, ms a step against the byte
             bound, the KV cache's bytes, kernel A once a layer in the
             prefill; the logits of the prefill and 32 steps against a
             full forward (``DECODE_LOGITS_RTOL``), the greedy tokens
             against its argmax; the same on a float32 copy of each model
             (``DECODE_F32_LOGITS_RTOL``, kernel A's float32 body in the
             prefill), where a cache write one slot off must fail; the same
             for a 2-layer rope + GQA + MoE (drop-free) + window-4 decode,
             whose cache write one slot off must fail.

31. lm_head_dims — ``benchmarks/bench_lm.py``'s small config (2 layers, 2
             heads x 16, vocab 64, T 128, B 2) on 2 agents through the
             kernels at head dim 16 (run zero-padded to 32): one step
             against plain attention under phase 4's limits with the
             dropped-key-tile control, then 4 epochs of 1 step trained both
             ways from the same weights (losses within
             ``SMALL_LM_LOSS_RTOL``); kernel launches counted (the forward,
             dQ and dK/dV on wgmma, the backward with the pre-pass).
    lm_head_dim_256 — the slice's LM at 4 heads x 256
             (``TransformerLM(attn_impl="flash", num_heads=4,
             head_dim=256)``, d_model 1024, vocab 8192, T 4096, bf16 over
             float32): one step of 2 agents x 2 layers against plain
             attention under phase 4's limits with the dropped-key-tile
             control, then one eager epoch of the full slice (8 layers, 4
             agents on a ring, B 2, 3 steps and a round): tokens/s, peak
             memory, launches by body (the forward, dQ and dK/dV on their
             wgmma bodies, the backward with the pre-pass).
    lm_head_dim_32 — the slice's LM at 32 heads x 32 (``num_heads=32,
             head_dim=32``, d_model 1024, vocab 8192, bf16 over float32):
             ``generate`` at lm_decode's configuration (B 2, prefill 2048,
             MHA): the prefill's seconds, tokens/s and launches (kernel A
             on wgmma once a layer), kernel A's ms at the prefill's shape,
             the logits of the prefill and 32 steps against a full forward
             over 2,080 positions (``DECODE_LOGITS_RTOL``, greedy tokens
             against its argmax); one step of 2 agents x 2 layers at T 2048
             (cut so plain attention's scores fit) against plain attention
             under phase 4's limits with the dropped-key-tile control; one
             eager epoch of the full slice: tokens/s, peak memory, launches
             by body (the forward, dQ and dK/dV on wgmma, the backward with
             the pre-pass) and the epoch split by kernel time.
    lm_head_dim_512 — the slice's LM at 2 heads x 512 (``num_heads=2,
             head_dim=512``, d_model 1024, vocab 8192, bf16 over float32):
             the prefill and decode check as lm_head_dim_32's (kernel A
             once a layer on its wide wgmma body), one step of 2 agents x
             2 layers at T 4096 against plain attention under phase 4's
             limits with the dropped-key-tile control, and one eager epoch
             of the full slice: tokens/s, peak memory, launches by body
             (the forward on wgmma, dQ and dK/dV on the wide CUDA-core
             bodies, the backward with the pre-pass) and the epoch split
             by kernel time.
32. wire   — the ``comm/`` wire layer on the card's WRN-28-10 agents (4 x
             36,489,290 float32 parameters, Metropolis ring): both native
             libraries built into ``_build/``; each agent's parameters
             ``tree_to_flat`` from the card and encoded as dense float32,
             bf16 and int8 frames and one fused top-k 10% CHOCO correction
             frame; sent to the ring neighbours through
             ``open_framed_connection`` / ``FramedStream`` over 127.0.0.1
             and read through a ``StreamMultiplexer``; decoded into pinned
             ``out=`` scratch, ``flat_to_tree`` onto the card and mixed
             with W there: the float32 round against ``ConsensusEngine``'s
             (``WIRE_MIX_ATOL``), bf16 and int8 values within their wire
             rounding, ``decode_fused_apply`` into a live estimate equal
             to ``hat + decode_fused_sparse`` bit for bit, native frames
             equal to the numpy path's byte for byte, the
             ``comm.wire.native`` gauge never 0; a flipped byte in each
             kind of frame must raise (``FrameError`` in transit,
             ``CodecError`` for the fused frame's own check, its apply
             target untouched).  Per mode and agent: frame bytes, D2H +
             encode, send, decode + H2D times, MB/s, and the pinned copy
             time of the same bytes as the transfer's bound.
33. comm_runtime — the ``comm/`` runtime driving gossip SGD between the WRN
             slice's 4 agents (full width, seed 0) over 127.0.0.1, under
             deterministic algorithms: a port ``ConsensusMaster``
             (Metropolis ring, eps 1e-4) and 4 port ``ConsensusAgent``s
             in one event loop.  (1) 2 epochs of the slice's 4 steps with
             the trainer's own round off (``mix_times=0``), each followed
             by one master-gated ``run_round(max_iterations=1)`` written
             back into ``flat_params``: against ``ConsensusEngine`` with
             the master's W on the same input (``WIRE_MIX_ATOL``) and
             against a dense trainer (steps, then its on-card round):
             epoch 1 at ``WIRE_MIX_ATOL``, epoch 2 at
             ``RUNTIME_EPOCH2_ATOL``; one agent's value scaled by 1 +
             2^-10 must fail the epoch-1 limit.  (2) a bf16-wire
             ``run_round`` to ``RUNTIME_BF16_K`` iterations against as
             many engine rounds, per value within the propagated bf16
             rounding (``_bf16_envelope``).  (3) ``run_choco_tree``,
             top-k 10% per leaf, fused sparse frames, 2 iterations,
             against a host numpy CHOCO recurrence with its own top-k
             (selection flips counted, 0 expected).  (4)
             ``AsyncGossipRunner`` at tau 0 bit-equal to ``run_choco_once``
             (sparse frames, every 100th value) and to ``run_once`` (bf16
             wire); then tau 1 with agent 3 held back
             (overlap decode): staleness, drops, pokes, and
             ``comm.wire.scratch_misses`` exactly one per inbound edge;
             a seeded ``FaultPlan`` (drop / dup / reorder) on edge 0 -> 1
             whose decision stream must equal the plan's schedule.  (5) a
             lying peer (byzantine fields) quarantined by a
             ``regenerate`` master.  Per agent and operation: D2H,
             encode, send, decode, H2D, mix and wall seconds, beside the
             pinned copy of one agent's ravel.
34. sharded — the sharded engine on ``torch.distributed``: 4 rank
             processes of this script (``--sharded-rank``), one agent
             each, sharing ``cuda:0`` over gloo (4 cards or more: nccl,
             one card each); each rank prints its backend and device.
             (1) The engine at WRN-28-10 width (a 36,489,290-float32
             bucket a rank, the stacked state from one seed): ``mix``
             (matchings), ``mix_with`` on the ring and the gathered row
             against an Erdos-Renyi W, ``mix_chebyshev``, ``mix_until`` to
             an eps, ``global_average`` and ``max_deviation`` against the
             dense engine on the same state, each rank its own row
             (``SHARDED_MIX_ATOL``); a round in which agent 0 loses one
             matching's message must fail; one round's D2H, exchange,
             H2D and arithmetic ms beside the dense round.  (2) Gossip
             SGD: one epoch of vision_slice's steps on WRN-28-10 (ring
             Metropolis, one round) with ``mesh=``, against the dense
             trainer's same epoch run on rank 0 after it: losses and
             running statistics (vision_plain's limits; bit for bit
             expected), parameters (``SHARDED_MIX_ATOL``); samples/s.
             (3) The LM slice's model (full width, B 2, T 4096, adam), one
             epoch of 3 steps and a round: A, B, C and the pre-pass
             counted on every rank (``launches_by_path["lm_sharded"]``,
             all wgmma), losses within ``LOSS_RTOL`` and each agent's
             update within ``GRAD_RTOL`` of the dense epoch's; tokens/s.
             (4) DSGT and EXTRA on tracking_routes' Titanic logreg
             (``ROUTES_ATOL``) and push-sum at WRN-28-10 width on a
             directed ring (``SHARDED_MIX_ATOL``, the totals within
             ``PUSHSUM_SUM_RTOL``) with ``mesh=``, against the dense
             engines.  (5) superstep_routes' MLP with ``mesh=`` (plain,
             Chebyshev, ``topology_schedule``, Gossip-PGA, ``mix_eps``):
             ``train_epochs(3)`` (training replays, eager rounds) equal
             to 3 eager epochs bit for bit and to the dense trainer's
             agent (``SHARDED_MIX_ATOL``).  (6) ROADMAP item 3b at
             WRN-28-10 width: ``mix_async`` (tau 1, periods 1, 2, 1, 2),
             clip (fixed and adaptive), trimmed mean (trim 1, complete
             graph), async clip and async trim, CHOCO top-k 10% per-leaf
             and global with error feedback, each against the dense
             engine (``SHARDED_MIX_ATOL``, masses ``SHARDED_MASS_RTOL``);
             a dropped partner message and a publication one round stale
             must fail; each route's D2H, exchange, H2D and arithmetic
             ms and bytes beside the dense call.  (7) One WRN-28-10
             epoch with each of CHOCO, async, trim and clip against the
             dense trainer (as (2)); samples/s.  (8) ring_flash over the
             4 ranks (B 2, 8 x 128 heads, T 4096, 1024 a rank, bf16),
             causal and not, forward and backward against kernels A/B/C
             at full T (phase 2's limits), launches a rank (r + 1 or 4),
             a wrong source index and a skipped rotation must fail.  (9)
             ``make_gossip_lm_step`` on the ranks regrouped as agents 2
             x seq 2 at the LM slice's full width with ring_flash, 3
             steps, against the two agents in one process with flash at
             full T (loss ``LOSS_RTOL``, updates ``GRAD_RTOL``); a step's
             split (compute, K/V rotation, gradient all_reduce, gossip),
             tokens/s and peak memory; A, B, C and the pre-pass counted
             (``launches_by_path["seq_parallel"]``); ring and ulysses at
             a 2-layer cut, one step (loss, the step's gradient).  (10)
             ROADMAP item 5a at full width on the ranks regrouped: the TP
             step on data 2 x model 2 (2 steps, global B 4) and the FSDP
             step on data 4 against one process (loss ``LOSS_RTOL``, the
             first step's gathered gradient ``GRAD_RTOL``), TP decode of
             float32 copies (MHA, 2 K/V heads, 1 K/V head) against
             ``generate``, gossip x FSDP and gossip x TP (2 layers), the
             expert-parallel MoE LM on data 2 x expert 2 in float32 with
             its routes replayed (``MOE_EP_RTOL``), each with a control
             (``launches_by_path["model_parallel"]``).  (11) The pipeline
             (ROADMAP items 5b / 5c): on stage 4 at full width (2 layers a
             stage, 1 a chunk for the interleaved schedule, V 2), M 8
             microbatches of one sequence, adam, 2 steps, GPipe, GPipe
             with ``remat_stage``, 1F1B and interleaved, each against the
             one-process model on the same 8 sequences (each step's loss
             ``LOSS_RTOL``, the first step's gradient per leaf
             ``GRAD_RTOL``); launches a rank a step A 16 / 32 / 32 / 32,
             B, C and the pre-pass 16, all wgmma
             (``launches_by_path["pipeline"]``, with the compositions');
             1F1B's peak memory below GPipe's; two controls that must fail
             (every stage seeding its backward from the head; each input
             filed one stash slot off); a step's split (stage compute,
             hops, end broadcasts, reductions over the other axes),
             tokens/s and the measured bubble share beside (S - 1) / (M + S
             - 1).  Then 1F1B at 4 layers, M 4 of 2 sequences, one step, on
             stage 2 x seq 2 (ring_flash), stage 2 x model 2 and data 2 x
             stage 2 (the same limits), and on stage 2 x expert 2 the
             extras' MoE at 2 layers in float32, its routes replayed
             (``MOE_EP_RTOL``, flips ``ROUTE_FLIP_F32_RTOL``).  A failing
             rank stops the others and the phase.

``--wide-only``, ``--d256-only``, ``--d32-only`` and ``--sharded-only``
build and run only the cases and times above head dim 256 (phase 2's,
``times_wide`` and ``times_f32_wide``), only the
head-dim-256 and 192 cases of phase 2 and ``times_d256``, only the
head-dim-32, 16 and 8 cases of phase 2 and ``times_d32``, or only phase
34, and end with the card line.  ``--sass-against DIR`` builds this
checkout's kernels and those of the checkout at ``DIR`` (the parent
commit, say, unpacked with ``git archive``) and prints which kernels have
the same SASS (``cuobjdump -sass``, addresses and the file's anonymous
namespace stripped), which differ and which only one library has.

Then a ``kernels`` JSON line (each kernel also carries its D-256 bodies'
error, time, bound, plain and library times under ``head_dim_256``, its
body's above head dim 256 (at 2 x 512) under ``head_dim_wide``, the times
of its float32 bodies under ``float32``, ``float32_head_dim_256`` and
``float32_head_dim_wide``, and its head-dim-32 bodies' error and times
under ``head_dim_32``),
the card's name and power limit as
``nvidia-smi`` gives them, and the last line
``{"ok": true, "device": {...}}``.  With no CUDA device it exits non-zero
before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM rate and its operations over
# the bf16 tensor-core rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # CUDA cores, for the pre-pass's float32 reduction
PEAK_HBM_BYTES = 3.35e12
# The special-function unit's exponentials: 16 ex2 a clock on each SM at
# the clock PEAK_BF16_FLOPS assumes (989e12 / (132 SMs x 4,096 FLOPs a
# clock) = 1.83 GHz); each live (query, key) pair of A, B and C costs one.
EX2_PER_SM_CLOCK, PEAK_CLOCK_HZ = 16, 1.83e9
# Score bytes a plain attention version may hold at once in kernel_times.
PLAIN_SCORE_BYTES = 24e9

# The slice's model: the JAX package's full-scale LM (benchmarks/bench_lm.py).
AGENTS, LAYERS, HEADS, HEAD_DIM, VOCAB, SEQ, BATCH = 4, 8, 8, 128, 8192, 4096, 2
EPOCHS, STEPS = 3, 3
CSRC = "distributed_learning_tpu_torch/csrc"
# The source that holds each kernel's body on the slice's path.
SOURCES = {
    "flash_fwd": f"{CSRC}/flash_attention_sm90.cu",
    "flash_bwd_dq": f"{CSRC}/flash_attention_sm90.cu",
    "flash_bwd_dkv": f"{CSRC}/flash_attention_sm90.cu",
    "flash_bwd_rowterm": f"{CSRC}/flash_attention_sm90.cu",
}
# The slice against its plain path (phase 4): relative limits on the loss
# and on each leaf's gradient, per agent.  The plain path rounds the
# scores to bfloat16 before its softmax, so a leaf's gradient differs
# from the kernel path's by up to 1.5e-2 at init (H100, T 4096); a dK/dV
# that drops key tile 0 moves the K and V weights' gradients by 0.17-0.52
# there, and the limit sits between the two.
LOSS_RTOL, GRAD_RTOL = 2e-4, 5e-2
DEVICE = "cuda"


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 2)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Kernel-vs-plain limits, the same as tests/torch_port/test_torch_kernels_gpu.py.
# bfloat16: a difference of one or two bf16 ulps is under 2**-6 of the
# element, inside rtol; atol only covers elements near zero, and sits
# between the errors measured at the slice's launch shape (O 0.0039, dQ,
# dK, dV 0.00098) and the values compared there (|O| and |dQ| ~0.03 at
# T 4096, late-key dK and dV ~0.003-0.01).  ``tile`` bounds
# ||a - b|| / ||b|| over each 64-row tile of each (batch, head), so a
# small late-key tile or a ragged tail that is wrong fails even where
# its elements sit under atol (measured at most 0.0026 on an H100).
# float32: summation order only.
TOL = {
    torch.bfloat16: {"o": 5e-3, "grad": 2e-3, "rtol": 2e-2, "tile": 1e-2},
    torch.float32: {"o": 2e-5, "grad": 2e-5, "rtol": 2e-5, "tile": 1e-5},
}
TILE_ROWS = 64


def tile_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max over (batch, 64-row tile of T, head) of ||a - b|| / ||b|| for
    (B, T, H, D) tensors; a ragged last tile counts its own rows."""
    a, b = a.float(), b.float()
    T = b.shape[1]
    pad = (0, 0, 0, 0, 0, (-T) % TILE_ROWS)

    def tiles(x):
        x = torch.nn.functional.pad(x, pad)
        return x.reshape(x.shape[0], -1, TILE_ROWS, *x.shape[2:]).square().sum((2, 4)).sqrt()

    num, den = tiles(a - b), tiles(b)
    rel = torch.where(num == 0, torch.zeros_like(num), num / den)
    return float(rel.max())


def compare(a, b, atol, rtol, tile):
    """(max |a - b|, max tile error, whether a matches b): elementwise
    |a - b| <= atol + rtol |b|, every tile within ``tile``, all finite."""
    diff = (a.float() - b.float()).abs()
    t_err = tile_rel_err(a, b) if a.dim() == 4 else 0.0
    ok = (bool((diff <= atol + rtol * b.float().abs()).all())
          and bool(torch.isfinite(a).all()) and t_err <= tile)
    return float(diff.max()), t_err, ok


# ---------------------------------------------------------------------- #
# Phase 1: build                                                         #
# ---------------------------------------------------------------------- #
def ptxas_summary(report: str) -> dict:
    """``{kernel<dtype,D>: "R regs, S spill bytes"}`` from ptxas -v (the
    wide wgmma forward as ``<resident|streamed,NS>``)."""
    out, name, spills = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"[0-9](flash_[a-z_0-9]+?kernel(?:_sm90)?)I(?:Lb([01])E)?"
                      r"(13__nv_bfloat16|f)?(?:Li(\d+)E)?", line)
        if m:
            q_tile = {"1": "resident", "0": "streamed", None: ""}[m.group(2)]
            dtype = {"13__nv_bfloat16": "bf16", "f": "f32", None: ""}[m.group(3)]
            name = f"{m.group(1)}<{','.join(x for x in (q_tile, dtype, m.group(4)) if x)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} regs, {spills} spill bytes"
            name = None
    return out


def phase_build() -> None:
    from distributed_learning_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load_library()
    seconds = time.perf_counter() - t0
    smem = {f"{name}<{D}>": lib.dlt_flash_wgmma_smem_bytes(which, D)
            for which, name in ((0, "flash_fwd_kernel_sm90"), (1, "flash_dq_kernel_sm90"),
                                (2, "flash_dkv_kernel_sm90"))
            for D in (32, 64, 128, 256) if lib.dlt_flash_wgmma_smem_bytes(which, D) > 0}
    report = _build.ptxas_report()
    ptxas = ptxas_summary(report)
    # The target is no spill anywhere; a spill is reported, not fatal.
    spills = {k: v for k, v in ptxas.items() if not v.endswith(" 0 spill bytes")}
    # C7520 (warpgroup.wait injected) would serialise a wgmma pipeline, and
    # C7515 names a kernel whose wgmmas ptxas serialised.
    c7520 = [line.strip() for line in report.splitlines() if "C7520" in line]
    c7515 = sorted({m.group(1) for m in re.finditer(r"C7515.*?function '(\S+?)'", report)})
    # The wide forward (bf16, head dims above 256): its four instantiations
    # (Q resident up to D 512 or streamed; 256- and 128-column slices), its
    # dynamic shared memory by head dim, and its cluster shape (none: each
    # block is a cluster of one).
    fwd_wide = {"ptxas": {k: v for k, v in ptxas.items()
                          if k.startswith("flash_fwd_wide_kernel_sm90")},
                "dynamic_smem_bytes": {D: lib.dlt_flash_wgmma_smem_bytes(0, D)
                                       for D in (384, 512, 640, 1152)},
                "cluster_dims": [1, 1, 1]}
    emit({"phase": "build", "sources": sorted(set(SOURCES.values())),
          "seconds": round(seconds, 3), "ptxas": ptxas, "spills": spills,
          "fwd_d256": ptxas.get("flash_fwd_kernel_sm90<256>"),
          **{f"{tag}_d32": {"ptxas": ptxas.get(f"{name}<32>"),
                            "dynamic_smem_bytes": smem.get(f"{name}<32>")}
             for tag, name in (("fwd", "flash_fwd_kernel_sm90"), ("dq", "flash_dq_kernel_sm90"),
                               ("dkv", "flash_dkv_kernel_sm90"))},
          "fwd_wide": fwd_wide, "c7520": c7520, "c7515": c7515,
          "wgmma_dynamic_smem_bytes": smem})


# ---------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version                         #
# ---------------------------------------------------------------------- #
def _qkv(B, T, H, D, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    # Strided views of one packed buffer, as the model hands them over.
    packed = torch.randn(B, T, 3, H, D, generator=g, device=DEVICE).to(dtype)
    do = torch.randn(B, T, H, D, generator=g, device=DEVICE).to(dtype)
    return packed[:, :, 0], packed[:, :, 1], packed[:, :, 2], do


def _compare_case(fa, label, B, T, H, D, dtype, causal, window, with_lse_grad, controls=False):
    # The lse cotangent enters through flash_attention_with_lse, which has no window.
    assert window is None or not with_lse_grad
    q, k, v, do = _qkv(B, T, H, D, dtype, seed=B * T + D)
    scale = D ** -0.5
    tol = TOL[dtype]
    res = {"case": label, "shape": [B, T, H, D], "dtype": str(dtype).split(".")[-1],
           "causal": causal, "window": window, "tol": tol}
    errs = {}

    def check(name, a, b, kind):
        errs[name] = compare(a, b, tol[kind], tol["rtol"], tol["tile"])

    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, with_lse=True)
    o, lse = fa.flash_fwd(q, k, v, scale, causal, window, with_lse=True)
    o2, _ = fa.flash_fwd(q, k, v, scale, causal, window, with_lse=False)
    torch.cuda.synchronize()
    check("fwd_lse.o", o, po, "o")
    errs["fwd_lse.lse"] = compare(lse, plse, 1e-4, 1e-5, 0.0)
    check("fwd.o", o2, po, "o")
    rejected = {}
    if controls:
        # The limits must reject a forward that leaves the first Q tile at
        # zero, as they reject such a dQ below.
        broken = o.clone()
        broken[:, :TILE_ROWS] = 0
        rejected["o_first_tile_zeroed"] = not compare(
            broken, po, tol["o"], tol["rtol"], tol["tile"])[2]
        if fa.kernel_head_dim(D) > 256:
            # Above 256 O's columns are split across blocks: the limits must
            # reject an O whose last 128 columns (one slice's share) are zero.
            broken = o.clone()
            broken[..., -128:] = 0
            rejected["o_last_128_columns_zeroed"] = not compare(
                broken, po, tol["o"], tol["rtol"], tol["tile"])[2]
        del broken
    del o, o2, lse
    dadj = None
    if with_lse_grad:
        g = torch.Generator(device=DEVICE).manual_seed(7)
        dadj = torch.randn(B, H, T, generator=g, device=DEVICE)
    pdq = fa.plain_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, window)
    dq = fa.flash_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, window)
    torch.cuda.synchronize()
    check("dq", dq, pdq, "grad")
    if controls:
        # The limits must reject a dQ kernel that leaves the first Q tile
        # at zero: its few live keys under the causal mask make it the
        # smallest tile.
        broken = dq.clone()
        broken[:, :TILE_ROWS] = 0
        rejected["dq_first_tile_zeroed"] = not compare(
            broken, pdq, tol["grad"], tol["rtol"], tol["tile"])[2]
        del broken
    del dq, pdq
    rt = fa.flash_bwd_rowterm(po, do, dadj)
    torch.cuda.synchronize()
    errs["rowterm"] = compare(rt, fa.plain_bwd_rowterm(po, do, dadj), 1e-4, 1e-5, 0.0)
    del rt
    pdk, pdv = fa.plain_bwd_dkv(q, k, v, po, do, plse, dadj, scale, causal, window)
    dk, dv = fa.flash_bwd_dkv(q, k, v, po, do, plse, dadj, scale, causal, window)
    torch.cuda.synchronize()
    check("dk", dk, pdk, "grad")
    check("dv", dv, pdv, "grad")
    if controls:
        # The limits must reject a dK/dV kernel that leaves the last key
        # tile at zero: its few queries make it the smallest tile.
        for name, a, b in (("dk", dk, pdk), ("dv", dv, pdv)):
            broken = a.clone()
            broken[:, -TILE_ROWS:] = 0
            rejected[f"{name}_last_tile_zeroed"] = not compare(
                broken, b, tol["grad"], tol["rtol"], tol["tile"])[2]
        res["controls_rejected"] = rejected
    del dk, dv, pdk, pdv
    if with_lse_grad:
        # The public lse-returning function end to end: its backward must
        # route the lse cotangent into both kernels as dadj.  At a head dim
        # the kernels have, held against the independent plain pipeline
        # (the plain forward's O and lse into the plain backward).  At a
        # padded head dim the plain backward gets the inputs the kernels
        # saw, the kernel forward's O and lse (O is held against the plain
        # forward above): there the plain O's one-ulp bf16 differences,
        # carried by rowsum(dO * O), put dQ / dK 7.8e-3 off at D 16 on a
        # correct kernel, which the pipeline's numbers, reported beside,
        # show.  The bf16 D-256 body takes the second reference too: its
        # row sum carries 256 terms of those differences (dK 7.8e-3 off
        # at T 129, non-causal, on an H100, where the kernel's own dQ,
        # dK, dV against the plain versions on the same inputs are within
        # 2.5e-4).
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out, l_out = fa.flash_attention_with_lse(qq, kk, vv, causal=causal)
        grads = torch.autograd.grad((out, l_out), (qq, kk, vv), (do, dadj))
        pipeline = [fa.plain_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, None),
                    *fa.plain_bwd_dkv(q, k, v, po, do, plse, dadj, scale, causal, None)]
        names = ("lse_fn.dq", "lse_fn.dk", "lse_fn.dv")
        if fa.kernel_head_dim(D) == D and (D <= 128 or dtype == torch.float32):
            res["lse_fn_reference"] = "plain_pipeline"
            refs = pipeline
        else:
            res["lse_fn_reference"] = "kernel_o_and_lse"
            res["lse_fn_vs_plain_pipeline"] = {
                name: compare(a, b, tol["grad"], tol["rtol"], tol["tile"])
                for name, a, b in zip(names, grads, pipeline)}
            ko, klse = out.detach(), l_out.detach()
            refs = [fa.plain_bwd_dq(q, k, v, ko, do, klse, dadj, scale, causal, None),
                    *fa.plain_bwd_dkv(q, k, v, ko, do, klse, dadj, scale, causal, None)]
        for name, a, b in zip(names, grads, refs):
            check(name, a, b, "grad")
    res["max_abs_err"] = {k: v[0] for k, v in errs.items()}
    res["max_tile_rel_err"] = {k: v[1] for k, v in errs.items()
                               if k not in ("fwd_lse.lse", "rowterm")}
    res["body"] = _bodies(fa, D, dtype)
    res["kernel_head_dim"] = fa.kernel_head_dim(D)
    res["ok"] = all(v[2] for v in errs.values()) and all(res.get("controls_rejected", {}).values())
    emit({"phase": "kernels", **res})
    if not res["ok"]:
        raise AssertionError(f"kernel/plain mismatch in case {label}: {res}")
    per_kernel = {
        "flash_fwd": max(errs["fwd_lse.o"][0], errs["fwd.o"][0]),
        "flash_bwd_dq": errs["dq"][0],
        "flash_bwd_dkv": max(errs["dk"][0], errs["dv"][0]),
        "flash_bwd_rowterm": errs["rowterm"][0],
    }
    return per_kernel


def phase_kernels(fa):
    bf16, f32 = torch.bfloat16, torch.float32
    main = _compare_case(fa, "slice_launch_shape", AGENTS * BATCH, SEQ, HEADS, HEAD_DIM,
                         bf16, True, None, False, controls=True)
    _compare_case(fa, "per_agent_dadj", BATCH, SEQ, HEADS, HEAD_DIM, bf16, True, None, True)
    _compare_case(fa, "window_ragged", 2, 1000, 2, 128, bf16, True, 256, False)
    _compare_case(fa, "non_causal_dadj", 2, 512, 4, 128, bf16, False, None, True)
    _compare_case(fa, "head_dim_64", 2, 768, 4, 64, bf16, True, None, False)
    # The edges of the wgmma bodies' 128-row tiles.
    _compare_case(fa, "under_one_tile", 2, 64, 2, 128, bf16, True, None, False)
    _compare_case(fa, "one_row_past_a_tile", 2, 129, 2, 128, bf16, True, None, False)
    _compare_case(fa, "window_under_a_tile", 2, 1000, 2, 128, bf16, True, 100, False)
    _compare_case(fa, "head_dim_64_non_causal_dadj", 2, 384, 2, 64, bf16, False, None, True)
    _compare_case(fa, "non_causal_ragged", 2, 333, 2, 128, bf16, False, None, False)
    # Head dims the kernels do not have, zero-padded to the next of 32, 64
    # and 128: 48 and 96 on wgmma (8 and 16 in phase_kernels_d32).
    _compare_case(fa, "head_dim_48", 2, 768, 4, 48, bf16, True, None, False)
    _compare_case(fa, "head_dim_96_non_causal_dadj", 2, 384, 2, 96, bf16, False, None, True)
    _compare_case(fa, "f32_head_dim_16_window", 2, 333, 2, 16, f32, True, 64, False)
    d32 = phase_kernels_d32(fa)
    d256 = phase_kernels_d256(fa)
    wide = phase_kernels_wide(fa)
    torch.cuda.empty_cache()
    return main, d32, d256, wide


# The LM slice's model width (8 x 128) as 4 heads of 256, and as 32 heads
# of 32 (the head dim that 8, 16 and 24 run zero-padded at).
D256_HEADS, D256_HEAD_DIM = 4, 256
D32_HEADS = HEADS * HEAD_DIM // 32


def _bodies(fa, D, dtype) -> dict:
    """The body each kernel runs for a call of head dim ``D`` in ``dtype``
    (the pre-pass has one body)."""
    q = torch.empty(0, 0, 0, D, dtype=dtype)
    return {**{n: fa._body(q, n) for n in fa._KERNEL_NAMES}, "flash_bwd_rowterm": "cuda_core"}


def phase_kernels_d256(fa):
    """Head dim 256 at the slice's model width as 4 heads of 256 (with the
    tile controls and the lse cotangent), windowed and ragged, non-causal
    and ragged, and 192 zero-padded to 256: in bf16 all three run their
    wgmma bodies (the forward with 64-key tiles, dQ with 32-key tiles,
    dK/dV with 64-key blocks whose dK and dV are split between the
    consumers), which the launch counts must show; float32 runs the
    CUDA-core bodies."""
    bf16, f32 = torch.bfloat16, torch.float32
    fa.reset_launch_counts()
    d256 = _compare_case(fa, "head_dim_256_slice_width", BATCH, SEQ, D256_HEADS, D256_HEAD_DIM,
                         bf16, True, None, True, controls=True)
    _compare_case(fa, "head_dim_256_window_ragged", 2, 1000, 2, 256, bf16, True, 100, False)
    _compare_case(fa, "head_dim_256_non_causal_ragged_dadj", 2, 129, 2, 256, bf16, False, None,
                  True)
    _compare_case(fa, "head_dim_192", 2, 768, 4, 192, bf16, True, None, False)
    bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    _compare_case(fa, "f32_head_dim_256_dadj", 2, 333, 2, 256, f32, True, None, True)
    _compare_case(fa, "f32_head_dim_192_non_causal_dadj", 2, 384, 2, 192, f32, False, None, True)
    emit({"phase": "kernels_d256_bodies", "bf16_launches_by_body": bodies})
    fwd, dq, dkv = (bodies[n] for n in fa._KERNEL_NAMES)
    if not all(b["wgmma"] > 0 and b["cuda_core"] == 0 for b in (fwd, dq, dkv)):
        raise AssertionError(f"bf16 head dim 256 bodies {bodies}: want the wgmma forward, dQ "
                             "and dK/dV")
    torch.cuda.empty_cache()
    return d256


def phase_kernels_d32(fa):
    """Head dim 32 at the slice's model width and T as 32 heads of 32 (B 1,
    so the plain versions fit; with the tile controls and the lse
    cotangent), windowed and ragged, non-causal and ragged, and 8 and 16
    zero-padded to 32: in bf16 the forward, dQ and dK/dV run their wgmma
    bodies (64-byte rows and swizzle; the backward reads the pre-pass),
    which the launch counts must show; float32 runs the CUDA-core
    bodies."""
    bf16, f32 = torch.bfloat16, torch.float32
    fa.reset_launch_counts()
    d32 = _compare_case(fa, "head_dim_32_slice_width", 1, SEQ, D32_HEADS, 32, bf16, True, None,
                        True, controls=True)
    _compare_case(fa, "bf16_head_dim_32", 2, 200, 2, 32, bf16, True, None, True)
    _compare_case(fa, "head_dim_32_window_ragged", 2, 1000, 2, 32, bf16, True, 100, False)
    _compare_case(fa, "head_dim_32_non_causal_ragged_dadj", 2, 333, 2, 32, bf16, False, None,
                  True)
    _compare_case(fa, "head_dim_8", 2, 200, 2, 8, bf16, True, None, False)
    _compare_case(fa, "head_dim_16_dadj", 2, 512, 4, 16, bf16, True, None, True)
    bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    _compare_case(fa, "f32_head_dim_32", 2, 333, 2, 32, f32, True, None, True)
    emit({"phase": "kernels_d32_bodies", "bf16_launches_by_body": bodies})
    fwd, dq, dkv = (bodies[n] for n in fa._KERNEL_NAMES)
    if not all(b["wgmma"] > 0 and b["cuda_core"] == 0 for b in (fwd, dq, dkv)):
        raise AssertionError(f"bf16 head dim 32/16/8 bodies {bodies}: want the wgmma forward, "
                             "dQ and dK/dV")
    torch.cuda.empty_cache()
    return d32


# Head dims above 256 (the next multiple of 128): the slice's model width
# as 2 heads of 512, with the tile and column controls.
WIDE_HEADS, WIDE_HEAD_DIM = 2, 512


def phase_kernels_wide(fa):
    """Head dims above 256 against the plain versions: D 512 at the
    slice's width and T (with the tile and column controls and the lse
    cotangent), D 320 (run at 384) with the lse cotangent, D 384 windowed
    and ragged, D 640 non-causal (its last column slice 128 wide), D 1152
    windowed and ragged, non-causal, and causal with the lse cotangent,
    and float32 cases.  In bf16 the forward runs its wide wgmma body and
    dQ and dK/dV the wide CUDA-core bodies; float32 runs all three on the
    wide CUDA-core bodies: each case's launches must show it."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (
        ("head_dim_512_slice_width", BATCH, SEQ, WIDE_HEADS, WIDE_HEAD_DIM, bf16, True, None, True,
         True),
        ("head_dim_320_dadj", 2, 333, 2, 320, bf16, True, None, True, False),
        ("head_dim_384_window_ragged", 2, 1000, 2, 384, bf16, True, 100, False, False),
        ("head_dim_640_non_causal", 2, 333, 2, 640, bf16, False, None, False, False),
        ("head_dim_1152_window_ragged", 1, 300, 1, 1152, bf16, True, 50, False, False),
        ("head_dim_1152_non_causal", 1, 160, 2, 1152, bf16, False, None, False, False),
        ("head_dim_1152_dadj", 1, 257, 2, 1152, bf16, True, None, True, False),
        ("f32_head_dim_512_non_causal_dadj", 1, 200, 2, 512, f32, False, None, True, False),
        ("f32_head_dim_320", 1, 130, 2, 320, f32, True, None, False, False),
    )
    wide, launched, wrong = None, {}, []
    for label, B, T, H, D, dtype, causal, window, dadj, controls in cases:
        fa.reset_launch_counts()
        errs = _compare_case(fa, label, B, T, H, D, dtype, causal, window, dadj, controls=controls)
        wide = wide or errs
        got = {n: dict(fa.KERNELS[n].by_body) for n in fa._KERNEL_NAMES}
        launched[label] = got
        want = {"flash_fwd": "wgmma" if dtype == bf16 else "cuda_core_wide",
                "flash_bwd_dq": "cuda_core_wide", "flash_bwd_dkv": "cuda_core_wide"}
        if not all(got[n][b] > 0 and sum(got[n].values()) == got[n][b] for n, b in want.items()):
            wrong.append(label)
    emit({"phase": "kernels_wide_bodies", "launches_by_body": launched})
    if wrong:
        raise AssertionError(f"wide cases {wrong} launched {launched}: want the bf16 forward on "
                             "wgmma, every other wide launch on cuda_core_wide")
    torch.cuda.empty_cache()
    return wide


# ---------------------------------------------------------------------- #
# Phase 3: the slice                                                     #
# ---------------------------------------------------------------------- #
def pattern_batch(n_seq: int, phases, rng: np.random.Generator, vocab=None, seq_len=None):
    """Cyclic token windows ``x[t] = (start + t) % vocab`` from the given
    start phases (shuffled by ``rng``); y is the next token.  A window
    covers half the cycle, so each agent's quarter of start phases hides
    transitions the others see.  ``vocab`` and ``seq_len`` default to the
    slice's."""
    vocab, seq_len = vocab or VOCAB, seq_len or SEQ
    starts = rng.choice(np.asarray(list(phases)), size=n_seq)
    seq = (starts[:, None] + np.arange(seq_len + 1)[None, :]) % vocab
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def make_trainer(attn_impl, layers, agents, epochs, steps, seed=0, model_kwargs=None,
                 batch=BATCH, dims=None, mesh=None, **trainer_kwargs):
    """The slice's trainer; ``dims`` (``vocab``, ``heads``, ``head_dim``,
    ``seq``) replaces the slice's widths.  With ``mesh`` this rank's agent
    of it (the same data and init; a model of one agent)."""
    from distributed_learning_tpu_torch.models import TransformerLM
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training.trainer import MasterNode

    d = {"vocab": VOCAB, "heads": HEADS, "head_dim": HEAD_DIM, "seq": SEQ, **(dims or {})}
    rng = np.random.default_rng(seed)
    quarter = d["vocab"] // agents
    nodes = list(range(agents))
    train = {a: pattern_batch(steps * batch, range(quarter * a, quarter * (a + 1)), rng,
                              d["vocab"], d["seq"])
             for a in nodes}
    test = pattern_batch(4, range(d["vocab"]), rng, d["vocab"], d["seq"])
    model = TransformerLM(
        vocab_size=d["vocab"], num_layers=layers, num_heads=d["heads"], head_dim=d["head_dim"],
        max_len=d["seq"], attn_impl=attn_impl, dtype=torch.bfloat16,
        n_agents=1 if mesh is not None else agents, device=DEVICE, seed=seed,
        **(model_kwargs or {}),
    )
    if mesh is not None:
        trainer_kwargs["mesh"] = mesh
    master = MasterNode(
        nodes, model, optimizer="adam", optimizer_kwargs={"lr": 1e-3},
        weights=Topology.ring(agents), train_loaders=train, test_loader=test,
        stat_step=1, epoch=epochs, epoch_len=steps, batch_size=batch,
        mix_times=1, eval_batch_size=2, seed=seed, device=DEVICE, **trainer_kwargs,
    )
    master.initialize_nodes()
    return master


def phase_slice(fa):
    master = make_trainer("flash", LAYERS, AGENTS, EPOCHS, STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    tokens_per_epoch = AGENTS * BATCH * SEQ * STEPS
    losses = []
    for _ in range(EPOCHS):
        t0 = time.perf_counter()
        p = master.train_epoch()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(float(np.mean(p["train_loss"])))
        emit({"phase": "slice", "epoch": p["epoch"], "train_loss": p["train_loss"].tolist(),
              "grad_norm": p["grad_norm"].tolist(), "deviation": p["deviation"],
              "mix_rounds": p["mix_rounds"], "test_acc": p["test_acc"].tolist(),
              "epoch_seconds": round(dt, 4),
              "train_tokens_per_s_incl_eval_and_mix": round(tokens_per_epoch / dt, 1)})
    launches = {k.name: k.launches for k in fa.KERNELS.values()}
    bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    n_eval = math.ceil(len(master.test_data[0]) / master.eval_batch_size)
    expect = {
        "flash_fwd": LAYERS * EPOCHS * (STEPS + n_eval),
        "flash_bwd_dq": LAYERS * EPOCHS * STEPS,
        "flash_bwd_dkv": LAYERS * EPOCHS * STEPS,
        "flash_bwd_rowterm": LAYERS * EPOCHS * STEPS,
    }
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "slice_summary", "params_per_agent": master.model.param_count(),
          "agents": AGENTS, "layers": LAYERS, "seq": SEQ, "batch_per_agent": BATCH,
          "launches": launches, "launches_by_body": bodies, "expected_launches": expect,
          "peak_memory_bytes": peak, "epoch_losses": losses})
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if bodies[name]["wgmma"] != launches[name]:
            raise AssertionError(f"{name} left the wgmma body: {bodies[name]}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return master, launches, bodies


def phase_profile(master, out_dir):
    """One profiler window over one more epoch of the slice: its training
    steps, its gossip round and its eval."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        master.train_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernel rows only (device_type CUDA): an operator row's device time
    # repeats the kernels it launched, and so does a range annotation on
    # the device track (the optimizer's "Optimizer.step#Adam.step").
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or "#" in ev.key:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    # Kernel name (either body) -> group.
    flash = {"flash_fwd_kernel": "A flash_fwd", "flash_dq_kernel": "B flash_dq",
             "flash_dkv_kernel": "C flash_dkv", "flash_bwd_rowterm_kernel": "C pre-pass"}
    groups = dict.fromkeys([*flash.values(), "GEMMs (cuBLAS)", "other"], 0.0)
    for us, key, _ in rows:
        m = re.search(r"flash_(fwd|dq|dkv)_kernel|flash_bwd_rowterm_kernel", key)
        if m:
            groups[flash[m.group(0)]] += us
        elif re.search(r"gemm|nvjet|cutlass|sm90_xmma", key, re.I):
            groups["GEMMs (cuBLAS)"] += us
        else:
            groups["other"] += us
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_epoch.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    emit({"phase": "profile", "epoch_wall_ms": round(wall * 1e3, 3),
          "device_busy_ms": round(total_us / 1e3, 3),
          "device_idle_share": round(max(0.0, 1 - total_us / 1e3 / (wall * 1e3)), 4),
          "groups_ms": {k: round(v / 1e3, 3) for k, v in groups.items()},
          "top": [{"kernel": k[:90], "ms": round(us / 1e3, 3), "count": c,
                   "share": round(us / total_us, 4)} for us, k, c in rows[:12]]})


# ---------------------------------------------------------------------- #
# Phase 4: the slice against its plain path                              #
# ---------------------------------------------------------------------- #
def leaf_grads(model) -> dict:
    """``{leaf: (N, ...)}`` gradients of the last training step, read from
    the model's fused gradient buffer; the QKV kernel is split into its
    Q, K and V parts, so each attention weight is held on its own."""
    out = {}
    for name, p in model.stacked_parameters().items():
        off, size = model.param_slices[name]
        g = model.flat_grads[:, off: off + size].reshape(p.shape)
        if name.endswith("attn.qkv"):
            for j, part in enumerate("qkv"):
                out[f"{name}.{part}"] = g[:, :, j].clone()
        elif name.endswith("attn.kv_proj"):
            for j, part in enumerate("kv"):
                out[f"{name}.{part}"] = g[:, :, j].clone()
        else:
            out[name] = g.clone()
    return out


def rel_errs(a: dict, b: dict) -> dict:
    """Per leaf, the max over agents of ||a - b|| / ||b||."""
    out = {}
    for name, gb in b.items():
        d = (a[name] - gb).reshape(gb.shape[0], -1).norm(dim=1)
        out[name] = float((d / gb.reshape(gb.shape[0], -1).norm(dim=1)).max())
    return out


def _drop_first_key_tile(fa):
    """A deliberately wrong dK/dV kernel for the control run: key tile 0
    (keys 0-63, which every query reaches) gets no gradient."""
    real = fa.flash_bwd_dkv

    def broken(*args, **kwargs):
        dk, dv = real(*args, **kwargs)
        dk[:, :TILE_ROWS] = 0
        dv[:, :TILE_ROWS] = 0
        return dk, dv

    return broken


@contextlib.contextmanager
def _patched(owner, name, value):
    """``owner.name`` replaced by ``value`` inside the block (the
    attribute as ``owner`` holds it, so a static method stays one)."""
    real = vars(owner)[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


def kernel_vs_plain(agents, layers, control, model_kwargs=None, around=None, witness=None,
                    **trainer_kwargs) -> dict:
    """One training step of ``agents`` x ``layers`` at full width, through
    the kernels and through plain attention from identical weights (the
    first model's, round-tripped through ``convert.py``), then a control
    run through the kernels inside ``control()``: the loss and every
    leaf's gradient per agent, each run against the plain one under
    LOSS_RTOL / GRAD_RTOL.  ``around(run)``, when given, is a context
    manager around each run.  ``witness()``, when given, adds a fourth
    run through plain attention inside it, reported against the kernel
    run.  Returns the facts; ``ok`` when the kernel run passes and the
    control fails."""
    from distributed_learning_tpu_torch.convert import flax_to_torch, torch_to_flax

    out = {}
    weights = None
    runs = [("flash", "flash"), ("full", "full"), ("control", "flash")]
    if witness is not None:
        runs.append(("witness", "full"))
    for run, impl in runs:
        master = make_trainer(impl, layers, agents, 1, 1, model_kwargs=model_kwargs,
                              **trainer_kwargs)
        if weights is None:
            weights = flax_to_torch(torch_to_flax(
                {k: v.detach().cpu().numpy().copy()
                 for k, v in master.model.stacked_parameters().items()}
            ), n_agents=agents)
        master.initialize_nodes(params=weights)
        with contextlib.ExitStack() as stack:
            if around is not None:
                stack.enter_context(around(run))
            if run == "control":
                stack.enter_context(control())
            if run == "witness":
                stack.enter_context(witness())
            p = master.train_epoch()
        out[run] = (p["train_loss"], leaf_grads(master.model))
        del master
        gc.collect()
        torch.cuda.empty_cache()
    full_loss, full_grads = out["full"]
    verdict = {}
    for run in ("flash", "control"):
        loss, grads = out[run]
        errs = rel_errs(grads, full_grads)
        worst = max(errs, key=errs.get)
        verdict[run] = {
            "loss_rel_err": float(np.max(np.abs(loss - full_loss) / np.abs(full_loss))),
            "grad_rel_err": errs, "worst_leaf": worst,
        }
        verdict[run]["ok"] = (verdict[run]["loss_rel_err"] <= LOSS_RTOL
                              and errs[worst] <= GRAD_RTOL)
    if witness is not None:
        # How far each plain run is from the kernel run.
        flash_loss, flash_grads = out["flash"]
        verdict["plain_runs_vs_flash"] = {
            run: {"loss_rel_err": float(np.max(np.abs(out[run][0] - flash_loss)
                                               / np.abs(flash_loss))),
                  "worst_grad_rel_err": max(rel_errs(out[run][1], flash_grads).values())}
            for run in ("full", "witness")}
    return {"agents": agents, "layers": layers,
            "loss": {k: v[0].tolist() for k, v in out.items()},
            "limits": {"loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL},
            **verdict, "ok": verdict["flash"]["ok"] and not verdict["control"]["ok"]}


def phase_plain(fa):
    """One training step of 2 agents x 2 layers at full width, through the
    kernels and through plain attention from identical weights: loss and
    every leaf's gradient, per agent.  A control run with a dK/dV that
    drops key tile 0 must fail the same limits."""
    facts = kernel_vs_plain(2, 2, lambda: _patched(fa, "flash_bwd_dkv", _drop_first_key_tile(fa)))
    emit({"phase": "plain", **facts})
    if not facts["ok"]:
        raise AssertionError("kernel path and plain path disagree, or the "
                             "control was not rejected")


# ---------------------------------------------------------------------- #
# Phase 5: times                                                         #
# ---------------------------------------------------------------------- #
def _times_phase(fa, phase, H, D, dtype=torch.bfloat16):
    """``kernel_times`` at the slice's launch shape with its width as H
    heads of D, emitted with the body each kernel ran."""
    times = kernel_times(fa, AGENTS * BATCH, SEQ, H, D, dtype)
    emit({"phase": phase, "shape": [AGENTS * BATCH, SEQ, H, D],
          "dtype": str(dtype).split(".")[-1], "causal": True, "bodies": _bodies(fa, D, dtype),
          **_rounded(times)})
    return times


def phase_times_d256(fa):
    """The D-256 bodies (bf16: the wgmma forward, dQ and dK/dV) at 4
    heads of 256."""
    return _times_phase(fa, "times_d256", D256_HEADS, D256_HEAD_DIM)


def phase_times_wide(fa):
    """Head dims above 256 at the slice's launch shape with its width as 2
    heads of 512: the bf16 wide wgmma forward, dQ and dK/dV on the wide
    CUDA-core bodies."""
    return _times_phase(fa, "times_wide", WIDE_HEADS, WIDE_HEAD_DIM)


def phase_times_f32_wide(fa):
    """The float32 wide CUDA-core bodies (all three) at 2 heads of 512."""
    return _times_phase(fa, "times_f32_wide", WIDE_HEADS, WIDE_HEAD_DIM, torch.float32)


def phase_times_d32(fa):
    """Head dim 32 (which 8, 16 and 24 run zero-padded) at 32 heads of
    32: the bf16 wgmma forward, dQ and dK/dV."""
    return _times_phase(fa, "times_d32", D32_HEADS, 32)


def kernel_times(fa, B, T, H, D, dtype=torch.bfloat16):
    """Each kernel at (B, T, H, D), causal, in ``dtype``: CUDA-event ms,
    its bound on this card, its plain version's ms and one PyTorch call's
    ms.  The bound is the largest of the bytes over HBM's rate, the
    products over the tensor cores' bf16 peak (in float32 the CUDA
    cores': wgmma has no float32-exact product) and the exponentials,
    one a live pair in A, B and C, over the special-function units' rate
    (it binds below head dim 64)."""
    import torch.nn.functional as F

    q, k, v, do = _qkv(B, T, H, D, dtype, seed=11)
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, True, None, with_lse=True)
    pairs = B * H * T * (T + 1) // 2  # live (row, col) pairs of the causal mask
    elem = B * T * H * D * q.element_size()  # bytes of one (B, T, H, D) tensor
    row = B * H * T * 4               # bytes of one float32 (B, H, T) tensor
    rowterm = fa.flash_bwd_rowterm(o, do, None)
    # (flops, bytes): each input read once, each output written once.
    work = {
        "flash_fwd": (4 * pairs * D, 3 * elem + elem + row),
        # Q, K, V, dO, lse and the pre-pass's row term in; dQ out.
        "flash_bwd_dq": (6 * pairs * D, 4 * elem + 2 * row + elem),
        # Q, K, V, dO, lse and the pre-pass's row term in; dK, dV out.
        "flash_bwd_dkv": (8 * pairs * D, 4 * elem + 2 * row + 2 * elem),
        # O and dO in, the row term out.
        "flash_bwd_rowterm": (2 * B * T * H * D, 2 * elem + row),
    }
    peak = dict.fromkeys(work, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
    peak["flash_bwd_rowterm"] = PEAK_FP32_FLOPS
    ex2_rate = torch.cuda.get_device_properties(0).multi_processor_count * EX2_PER_SM_CLOCK \
        * PEAK_CLOCK_HZ
    exps = {name: (pairs if name != "flash_bwd_rowterm" else 0) for name in work}
    kernel_fn = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, scale, True, None, with_lse=True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, o, do, lse, None, scale, True, None,
                                                rowterm=rowterm),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, o, do, lse, None, scale, True, None,
                                                  rowterm=rowterm),
        "flash_bwd_rowterm": lambda: fa.flash_bwd_rowterm(o, do, None),
    }
    # The plain versions hold about four float32 (B, H, T, T) score tensors
    # at once; where those pass PLAIN_SCORE_BYTES they run over equal head
    # chunks, one call each (the same work; the time is the sum).
    n_chunks = next(n for n in range(1, H + 1)
                    if H % n == 0 and 4 * B * (H // n) * T * T * 4 <= PLAIN_SCORE_BYTES)
    heads = [slice(c * H // n_chunks, (c + 1) * H // n_chunks) for c in range(n_chunks)]

    def chunked(fn, *ts):
        # ts: (B, T, H, D) tensors, then lse as (B, H, T).
        return lambda: [fn(*(t[:, :, h] for t in ts[:-1]), ts[-1][:, h]) for h in heads]

    plain_fn = {
        "flash_fwd": chunked(lambda q, k, v, _: fa.plain_fwd(q, k, v, scale, True, None, True),
                             q, k, v, lse),
        "flash_bwd_dq": chunked(lambda q, k, v, o, do, lse: fa.plain_bwd_dq(
            q, k, v, o, do, lse, None, scale, True, None), q, k, v, o, do, lse),
        "flash_bwd_dkv": chunked(lambda q, k, v, o, do, lse: fa.plain_bwd_dkv(
            q, k, v, o, do, lse, None, scale, True, None), q, k, v, o, do, lse),
        "flash_bwd_rowterm": lambda: fa.plain_bwd_rowterm(o, do, None),
    }
    # Yardstick only: one PyTorch call per function (SDPA forward; SDPA's
    # backward, which computes dQ, dK and dV in one call, for B and C), in
    # the kernels' dtype.
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 5)
    out_h = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out_h, (qh, kh, vh), doh, retain_graph=True), 5)
    del out_h
    # The pre-pass's yardstick: rowsum(dO * O) as one float32 vecdot (from
    # float32 copies made outside the timing; it leaves out the dadj
    # subtraction).
    o32, do32 = o.float(), do.float()
    lib_row = cuda_ms(lambda: torch.linalg.vecdot(do32, o32, dim=-1), 5)
    del o32, do32
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd,
               "flash_bwd_rowterm": lib_row}
    times = {}
    for name in kernel_fn:
        flops, nbytes = work[name]
        terms = {"operations": flops / peak[name] * 1e3, "bytes": nbytes / PEAK_HBM_BYTES * 1e3,
                 "exp": exps[name] / ex2_rate * 1e3}
        bound_by = max(terms, key=terms.get)
        ms = cuda_ms(kernel_fn[name], 5)
        times[name] = {
            "ms": ms,
            "tflops": flops / ms / 1e9,
            "plain_ms": cuda_ms(plain_fn[name], 2),
            "bound_ms": terms[bound_by],
            "bound_by": bound_by,
            "library_ms": library[name],
            "flops": flops, "bytes": nbytes, "exps": exps[name],
            "bound_terms_ms": terms, "plain_head_chunks": n_chunks,
        }
        torch.cuda.empty_cache()
    del q, k, v, do, o, lse, rowterm, qh, kh, vh, doh
    torch.cuda.empty_cache()
    return times


def _rounded(times: dict) -> dict:
    return {k: {kk: (round(vv, 4) if isinstance(vv, float) else vv) for kk, vv in t.items()}
            for k, t in times.items()}


# ---------------------------------------------------------------------- #
# Titanic consensus GD                                                   #
# ---------------------------------------------------------------------- #
TITANIC_ALPHA, TITANIC_TAU = 0.1, 1e-4  # examples/titanic_consensus_gd.py


def titanic_consensus_gd(iters: int, eps: float = 1e-10, agents: int = 4,
                         max_rounds: int = 300, device=None):
    """The K``agents`` consensus-GD loop of ``examples/titanic_consensus_gd.py``
    on the port: each iteration one logreg GD step per agent on its
    contiguous shard (lr ``0.1 / sqrt(it + 1)``), then gossip on the
    complete graph until the agents' max deviation is under ``eps`` (at
    most ``max_rounds`` rounds).  Returns ``(w (agents, d), losses before
    each step (iters, agents), per-agent test accuracy, max |w - mean|)``."""
    from distributed_learning_tpu_torch.data import load_titanic, split_data
    from distributed_learning_tpu_torch.models.logreg import accuracy, grad_step
    from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology

    device = DEVICE if device is None else device
    X, y, X_te, y_te = load_titanic()
    shards = split_data(X, y, agents)
    m = min(len(s[0]) for s in shards.values())
    Xs = torch.tensor(np.stack([shards[a][0][:m] for a in range(agents)]), device=device)
    ys = torch.tensor(np.stack([shards[a][1][:m] for a in range(agents)]),
                      dtype=torch.float32, device=device)
    engine = ConsensusEngine(Topology.complete(agents).metropolis_weights(), device=device)
    state = {"w": torch.zeros(agents, Xs.shape[-1], device=device)}
    losses = []
    for it in range(iters):
        lr = TITANIC_ALPHA * np.float32(it + 1.0) ** np.float32(-0.5)
        state["w"], loss = grad_step(state["w"], Xs, ys, lr=float(lr), tau=TITANIC_TAU)
        engine.mix_until_(state, eps=eps, max_rounds=max_rounds)
        losses.append(loss)
    w = state["w"]
    X_te = torch.tensor(X_te, device=device)
    y_te = torch.tensor(y_te, dtype=torch.float32, device=device)
    accs = [float(accuracy(w[a], X_te, y_te)) for a in range(agents)]
    spread = float((w - w.mean(0)).abs().max())
    return w, torch.stack(losses), accs, spread


# ---------------------------------------------------------------------- #
# The WRN slice's convolution layout                                     #
# ---------------------------------------------------------------------- #
def wrn_conv_shapes(depth: int, widen: int, size: int = 32):
    """Every convolution of a WideResNet-depth-widen on ``size``-pixel
    images, in order: ``(c_in, c_out, kernel, stride, padding, H_in)``."""
    n = (depth - 4) // 6
    shapes = [(3, 16, 3, 1, 1, size)]
    c_in, h = 16, size
    for stage, width in enumerate((16 * widen, 32 * widen, 64 * widen)):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            if c_in != width or stride != 1:
                shapes.append((c_in, width, 1, stride, 0, h))  # shortcut
            shapes.append((c_in, width, 3, 1, 1, h))
            shapes.append((width, width, 3, stride, 1, h))
            c_in, h = width, h // stride
    return shapes


def wrn_conv_flops(images: int, depth: int, widen: int) -> int:
    """Operations of the forward and both backward products of every
    convolution (3 x 2 x MACs) for ``images`` 32 x 32 images."""
    return sum(6 * images * c_out * ((h + 2 * p - k) // s + 1) ** 2 * c_in * k * k
               for c_in, c_out, k, s, p, h in wrn_conv_shapes(depth, widen))


def phase_conv_layout(agents=AGENTS, batch=256, depth=28, widen=10, iters=3):
    """Forward + both backward products of every WRN convolution at the
    slice's shape, bf16, channels_last, in the two agent layouts:
    (a) one cuDNN call per agent on (B, C, H, W), (b) one grouped call with
    ``groups=agents`` on (B, agents*C, H, W).  Times are CUDA-event means
    over ``iters`` passes over all layers, the two layouts in turns."""
    import torch.nn.functional as F

    bf16, cl = torch.bfloat16, torch.channels_last
    g = torch.Generator(device=DEVICE).manual_seed(0)
    layers = []
    for c_in, c_out, k, s, p, h in wrn_conv_shapes(depth, widen):
        x = torch.randn(batch, agents * c_in, h, h, generator=g, device=DEVICE).to(bf16)
        x = x.contiguous(memory_format=cl).requires_grad_(True)
        w = (torch.randn(agents * c_out, c_in, k, k, generator=g, device=DEVICE) * 0.05)
        w = w.to(bf16).contiguous(memory_format=cl).requires_grad_(True)
        ho = (h + 2 * p - k) // s + 1
        dy = torch.randn(batch, agents * c_out, ho, ho, generator=g, device=DEVICE).to(bf16)
        layers.append((x, w, dy.contiguous(memory_format=cl), s, p, c_in, c_out))

    def per_agent():
        for x, w, dy, s, p, c_in, c_out in layers:
            for a in range(agents):
                xa = x[:, a * c_in:(a + 1) * c_in]
                wa = w[a * c_out:(a + 1) * c_out]
                y = F.conv2d(xa, wa, stride=s, padding=p)
                torch.autograd.grad(y, (xa, wa), dy[:, a * c_out:(a + 1) * c_out])

    def grouped():
        for x, w, dy, s, p, _, _ in layers:
            y = F.conv2d(x, w, stride=s, padding=p, groups=agents)
            torch.autograd.grad(y, (x, w), dy)

    # Per agent the slices are strided views of the stacked tensors; each
    # agent's activations in the model are their own tensors, so give the
    # per-agent run contiguous copies of its own.
    per = []
    for x, w, dy, s, p, c_in, c_out in layers:
        for a in range(agents):
            xa = x[:, a * c_in:(a + 1) * c_in].detach().contiguous(memory_format=cl)
            wa = w[a * c_out:(a + 1) * c_out].detach().contiguous(memory_format=cl)
            dya = dy[:, a * c_out:(a + 1) * c_out].contiguous(memory_format=cl)
            per.append((xa.requires_grad_(True), wa.requires_grad_(True), dya, s, p))

    def per_agent_own():
        for xa, wa, dya, s, p in per:
            y = F.conv2d(xa, wa, stride=s, padding=p)
            torch.autograd.grad(y, (xa, wa), dya)

    flops = wrn_conv_flops(agents * batch, depth, widen)
    res = {"per_agent": [], "grouped": []}
    for _ in range(2):  # (a), (b), (a), (b)
        res["per_agent"].append(cuda_ms(per_agent_own, iters))
        res["grouped"].append(cuda_ms(grouped, iters))
    emit({"phase": "conv_layout", "model": f"wrn-{depth}-{widen}", "agents": agents,
          "batch_per_agent": batch, "dtype": "bfloat16", "convs": len(layers),
          "tflop_per_pass": round(flops / 1e12, 3),
          "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "ms_per_pass": {k: [round(v, 3) for v in t] for k, t in res.items()},
          "strided_per_agent_ms": round(cuda_ms(per_agent, iters), 3)})
    del layers, per
    torch.cuda.empty_cache()
    return {k: min(t) for k, t in res.items()}


# ---------------------------------------------------------------------- #
# The WRN slice: the paper's own path                                    #
# ---------------------------------------------------------------------- #
# bench.py:699-733's configuration: WRN-28-10, dropout 0.3, bf16 compute
# over float32 parameters, SGD lr 0.1, momentum 0.9, weight decay 5e-4,
# 4 agents on a Metropolis ring, B 256 per agent, augmentation on.
WRN_AGENTS, WRN_BATCH, WRN_EPOCHS, WRN_STEPS, WRN_EVAL = 4, 256, 3, 4, 1024
WRN_SGD = {"lr": 0.1, "momentum": 0.9, "weight_decay": 5e-4}
# vision_plain: WRN-16-4, 4 agents x B 8, float32, one step on the card
# against the same step on the CPU.  Limits: the loss and the running
# statistics depend on the forward only (float32 sums in another order,
# ~1e-6); a gradient also moves where a ReLU input lies within float32
# rounding of 0 and takes the other branch on one side, which moved a
# leaf by up to 0.5% in norm between two float32 implementations
# (tests/torch_port/test_torch_vision.py).  The control, one agent
# normalised with another agent's batch statistics, moves that agent's
# loss and gradients by far more.
PLAIN_LOSS_RTOL, PLAIN_GRAD_RTOL, PLAIN_STAT_RTOL = 1e-4, 2e-2, 1e-4


def _cifar(n_train, n_test, seed=0):
    from distributed_learning_tpu_torch.data import normalize, synthetic_cifar

    (x, y), (xt, yt) = synthetic_cifar(n_train=n_train, n_test=n_test, seed=seed)
    return (normalize(x).numpy(), y), (normalize(xt).numpy(), yt)


def make_vision_master(model, agents, batch, steps, epochs, n_test, *, device=DEVICE,
                       optimizer_kwargs=None, augment=False, dropout=True, trainer_kwargs=None,
                       **model_kwargs):
    """``MasterNode`` over ``agents`` nodes on a Metropolis ring with one
    gossip round an epoch, on normalized synthetic CIFAR-10 dealt by
    ``shard_dataset``; ``trainer_kwargs`` go to the trainer (the gossip
    options; ``weights`` and ``mix_times`` there replace the ring and the
    one round)."""
    from distributed_learning_tpu_torch.data import normalized_pad_value, shard_dataset
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training.trainer import MasterNode

    (x, y), test = _cifar(agents * batch * steps, n_test)
    nodes = list(range(agents))
    kw = dict(weights=Topology.ring(agents), mix_times=1)
    kw.update(trainer_kwargs or {})
    master = MasterNode(
        nodes, model, model_args=(10,), optimizer="sgd",
        optimizer_kwargs=dict(optimizer_kwargs or WRN_SGD),
        train_loaders=shard_dataset(x, y, nodes, batch_size=batch),
        test_loader=test, stat_step=1, epoch=epochs, epoch_len=steps, batch_size=batch,
        eval_batch_size=WRN_EVAL, seed=0, device=device, augment=augment,
        augment_pad_value=normalized_pad_value(), dropout=dropout, model_kwargs=model_kwargs,
        **kw,
    )
    master.initialize_nodes()
    return master


def _record_gossip(master):
    """Wrap ``master._gossip`` so each round's deviation before and after
    is kept, and mark it for the profiler."""
    real, seen = master._gossip, []

    def gossip(*args):
        before = master.parameter_deviation()
        with torch.profiler.record_function("gossip"):
            rounds = real(*args)
        seen.append((before, master.parameter_deviation()))
        return rounds

    master._gossip = gossip
    return seen


def phase_vision_slice(fa):
    """WRN-28-10 at full depth and width through ``MasterNode``: 4 agents,
    3 epochs of 4 steps, one gossip round and an eval of 1024 test images
    per epoch."""
    master = make_vision_master(
        "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, WRN_EPOCHS, WRN_EVAL, augment=True,
        depth=28, widen_factor=10, dropout_rate=0.3, dtype=torch.bfloat16)
    mixes = _record_gossip(master)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    samples = WRN_AGENTS * WRN_BATCH * WRN_STEPS  # per epoch, as bench.py:341 counts them
    losses, rates = [], []
    stats_differ = None
    for _ in range(WRN_EPOCHS):
        t0 = time.perf_counter()
        p = master.train_epoch()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(float(np.mean(p["train_loss"])))
        rates.append(samples / dt)
        if stats_differ is None:
            # After the first epoch every agent's running statistics come
            # from its own batches: no two agents may share them.
            flat = master.model.flat_stats
            stats_differ = all(not torch.equal(flat[a], flat[b])
                               for a in range(WRN_AGENTS) for b in range(a))
        emit({"phase": "vision_slice", "epoch": p["epoch"],
              "train_loss": p["train_loss"].tolist(), "test_acc": p["test_acc"].tolist(),
              "deviation_before_mix": mixes[-1][0], "deviation": p["deviation"],
              "epoch_seconds": round(dt, 4),
              "train_samples_per_s_incl_eval_and_mix": round(samples / dt, 1),
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    flash_launches = {k.name: k.launches for k in fa.KERNELS.values()}
    emit({"phase": "vision_summary", "model": "wrn-28-10", "agents": WRN_AGENTS,
          "batch_per_agent": WRN_BATCH, "params_per_agent": master.model.param_count(),
          "epoch_losses": losses, "samples_per_s": rates,
          "running_stats_differ_across_agents": stats_differ,
          "gossip_deviation_before_after": mixes, "flash_launches": flash_launches,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"WRN loss did not fall: {losses}")
    if not stats_differ:
        raise AssertionError("running statistics are shared between agents after epoch 0")
    if not all(after < before for before, after in mixes):
        raise AssertionError(f"a gossip round did not lower the deviation: {mixes}")
    if any(flash_launches.values()):
        raise AssertionError(f"the WRN path launched a flash kernel: {flash_launches}")
    return master


def phase_vision_profile(master, out_dir):
    """One profiled epoch of the WRN slice: device time split into the
    convolutions (cuDNN), the optimizer, the gossip round, the
    augmentation, BatchNorm with the elementwise work and the rest, and
    idle."""
    from torch.profiler import ProfilerActivity, profile

    real_aug = master._augment

    def augment(x):
        with torch.profiler.record_function("augment"):
            return real_aug(x)

    master._augment = augment
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        master.train_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    master._augment = real_aug

    def dev_us(ev):
        v = getattr(ev, "device_time_total", None)
        return ev.cuda_time_total if v is None else v

    kernels, annotated = [], {}
    for ev in prof.key_averages():
        if ev.key in ("gossip", "augment") or ev.key.startswith("Optimizer.step#"):
            name = "optimizer" if ev.key.startswith("Optimizer") else ev.key
            annotated[name] = max(annotated.get(name, 0.0), dev_us(ev))
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or "#" in ev.key:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0:
            kernels.append((us, ev.key, ev.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    conv = sum(us for us, key, _ in kernels
               if re.search(r"conv|cudnn|xmma|implicit|fprop|dgrad|wgrad|winograd", key, re.I))
    groups = {"convolutions (cuDNN)": conv,
              "optimizer (SGD)": annotated.get("optimizer", 0.0),
              "gossip round": annotated.get("gossip", 0.0),
              "augmentation": annotated.get("augment", 0.0)}
    groups["BatchNorm, elementwise, head GEMM, rest"] = busy - sum(groups.values())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_wrn_epoch.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    emit({"phase": "vision_profile", "epoch_wall_ms": round(wall * 1e3, 3),
          "device_busy_ms": round(busy / 1e3, 3),
          "device_idle_ms": round(wall * 1e3 - busy / 1e3, 3),
          "device_idle_share": round(max(0.0, 1 - busy / 1e3 / (wall * 1e3)), 4),
          "groups_ms": {k: round(v / 1e3, 3) for k, v in groups.items()},
          "conv_bound_ms": round(wrn_conv_flops(WRN_AGENTS * WRN_BATCH, 28, 10) * WRN_STEPS
                                 / PEAK_BF16_FLOPS * 1e3, 3),
          "top": [{"kernel": k[:90], "ms": round(us / 1e3, 3), "count": c,
                   "share": round(us / busy, 4)} for us, k, c in kernels[:14]]})


def floored_rel_errs(a: dict, b: dict, floor: float = 1e-4) -> dict:
    """Per leaf, the max over agents of ||a - b|| / max(||b||, floor x the
    agent's norm over all leaves).  The floor is for leaves whose value is
    0 up to rounding: a conv bias that feeds a train-mode BatchNorm has a
    gradient of exactly 0, which float32 leaves at ~1e-7 of the others."""
    total = torch.stack([v.reshape(v.shape[0], -1).norm(dim=1) for v in b.values()]).norm(dim=0)
    out = {}
    for name, vb in b.items():
        d = (a[name] - vb).reshape(vb.shape[0], -1).norm(dim=1)
        ref = torch.maximum(vb.reshape(vb.shape[0], -1).norm(dim=1), floor * total)
        out[name] = float((d / ref).max())
    return out


def _cross_agent_batch_norm(vision):
    """The control of vision_plain: a BatchNorm that normalises agent 1's
    batch with agent 0's batch statistics (its running statistics are
    still its own)."""
    real = vision.BatchNorm.forward

    def forward(self, xs):
        ys = real(self, xs)
        if self.training:
            x0, x1 = xs[0].float(), xs[1].float()
            mean = x0.mean((0, 2, 3), keepdim=True)
            var = x0.var((0, 2, 3), unbiased=False, keepdim=True)
            scale, bias = self.scale[1][None, :, None, None], self.bias[1][None, :, None, None]
            ys[1] = ((x1 - mean) * torch.rsqrt(var + vision.BN_EPS) * scale + bias).to(xs[1].dtype)
        return ys

    return real, forward


def phase_vision_plain():
    """One WRN-16-4 training step (4 agents x B 8, float32, dropout and
    augmentation off) on the card and on the CPU from the same weights,
    statistics and batch: loss, every leaf's gradient and the new running
    statistics per agent.  The control must fail the same limits."""
    from distributed_learning_tpu_torch.models import vision

    kw = dict(depth=16, widen_factor=4, dropout_rate=0.3)
    out, weights = {}, None
    real, broken = _cross_agent_batch_norm(vision)
    for run, device in (("card", DEVICE), ("cpu", "cpu"), ("control", DEVICE)):
        master = make_vision_master("wide-resnet", 4, 8, 1, 1, 16, device=device,
                                    dropout=False, **kw)
        if weights is None:
            weights = {k: v.detach().cpu().clone() for k, v in
                       master.model.stacked_parameters().items()}
        master.initialize_nodes(params=weights)
        vision.BatchNorm.forward = broken if run == "control" else real
        try:
            p = master.train_epoch()
        finally:
            vision.BatchNorm.forward = real
        grads = {name: master.model.flat_grads[:, off: off + size].detach().cpu().clone()
                 for name, (off, size) in master.model.param_slices.items()}
        stats = {k: v.detach().cpu().clone() for k, v in master.model.stacked_stats().items()}
        out[run] = (p["train_loss"], grads, stats)
        del master
    loss_ref, grads_ref, stats_ref = out["cpu"]
    verdict = {}
    for run in ("card", "control"):
        loss, grads, stats = out[run]
        g_err, s_err = floored_rel_errs(grads, grads_ref), floored_rel_errs(stats, stats_ref)
        verdict[run] = {
            "loss_rel_err": float(np.max(np.abs(loss - loss_ref) / np.abs(loss_ref))),
            "worst_grad_leaf": max(g_err, key=g_err.get), "grad_rel_err": max(g_err.values()),
            "worst_stat": max(s_err, key=s_err.get), "stat_rel_err": max(s_err.values()),
        }
        v = verdict[run]
        v["ok"] = (v["loss_rel_err"] <= PLAIN_LOSS_RTOL and v["grad_rel_err"] <= PLAIN_GRAD_RTOL
                   and v["stat_rel_err"] <= PLAIN_STAT_RTOL)
    ok = verdict["card"]["ok"] and not verdict["control"]["ok"]
    emit({"phase": "vision_plain", "model": "wrn-16-4", "agents": 4, "batch_per_agent": 8,
          "loss": {k: v[0].tolist() for k, v in out.items()},
          "limits": {"loss_rtol": PLAIN_LOSS_RTOL, "grad_rtol": PLAIN_GRAD_RTOL,
                     "stat_rtol": PLAIN_STAT_RTOL},
          **verdict, "ok": ok})
    if not ok:
        raise AssertionError("the WRN step on the card and on the CPU disagree, or the "
                             "control was not rejected")


def phase_zoo():
    """Every other registry model for one epoch of 2 steps at its
    published width (4 agents x B 128, float32), and 200 iterations of
    the Titanic K4 consensus GD."""
    runs = {"lenet": {}, "vggnet": {"depth": 16}, "resnet": {"depth": 20},
            "ann": {"hidden_dim": 150}}
    for name, kw in runs.items():
        master = make_vision_master(name, 4, 128, 2, 1, 256,
                                    optimizer_kwargs={"lr": 0.05, "momentum": 0.9}, **kw)
        t0 = time.perf_counter()
        p = master.train_epoch()
        torch.cuda.synchronize()
        ok = bool(np.isfinite(p["train_loss"]).all() and np.isfinite(p["test_acc"]).all())
        emit({"phase": "zoo", "model": name, **kw, "params_per_agent": master.model.param_count(),
              "train_loss": p["train_loss"].tolist(), "test_acc": p["test_acc"].tolist(),
              "epoch_seconds": round(time.perf_counter() - t0, 4), "ok": ok})
        if not ok:
            raise AssertionError(f"{name}: non-finite loss or accuracy")
        del master
    # The input pipeline for data that does not stay on the card: pinned
    # host batches copied on a side stream must arrive intact.
    from distributed_learning_tpu_torch.data import epoch_batches, prefetch_to_device

    (x, y), _ = _cifar(1024, 1)
    got = list(prefetch_to_device(epoch_batches(x, y, 256, seed=0), size=2))
    want = list(epoch_batches(x, y, 256, seed=0))
    ok = len(got) == len(want) == 4 and all(
        gx.device.type == "cuda" and np.array_equal(gx.cpu().numpy(), wx)
        and np.array_equal(gy.cpu().numpy(), wy) for (gx, gy), (wx, wy) in zip(got, want))
    emit({"phase": "zoo", "model": "prefetch_to_device", "batches": len(got), "ok": ok})
    if not ok:
        raise AssertionError("prefetch_to_device changed or lost a batch")
    w, losses, accs, spread = titanic_consensus_gd(200)
    mean_loss = losses.mean(dim=1).cpu().numpy()
    ok = bool(np.isfinite(mean_loss).all() and mean_loss[-1] < mean_loss[0])
    emit({"phase": "zoo", "model": "titanic_logreg_k4_consensus_gd", "iterations": 200,
          "eps": 1e-10, "loss_first_last": [float(mean_loss[0]), float(mean_loss[-1])],
          "test_acc": accs, "spread": spread, "ok": ok})
    if not ok:
        raise AssertionError(f"Titanic consensus GD: loss did not fall ({mean_loss[[0, -1]]})")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# The epoch superstep: CUDA-graph replays against the eager epochs       #
# ---------------------------------------------------------------------- #
SUPERSTEP_K = 3


def trainer_record(master, payloads, logits=False) -> dict:
    """Every value a run leaves behind, as tensors: parameters, running
    statistics, optimizer state, CHOCO's estimates, error-feedback bank
    and generator, the async carry (published buffer, ages, round
    counter), each robust epoch's redirected mass, the payloads' per-epoch
    traces, round counts, deviations and the last test accuracy, and
    (``logits``) the eval-mode logits of the first test images."""
    # On the host: four runs of the LM's state would not fit the card
    # beside a live trainer.
    rec = {"params": master.model.flat_params.to("cpu", copy=True),
           "stats": master.model.flat_stats.to("cpu", copy=True)}
    if master._choco is not None:
        rec["choco.xhat"] = master._choco_xhat.to("cpu", copy=True)
        if master._choco_ef is not None:
            rec["choco.ef"] = master._choco_ef.to("cpu", copy=True)
        rec["choco.generator"] = master._choco_gen.get_state().to(torch.int64)
    if master._async_state is not None:
        st = master._async_state
        rec["async.pub"] = st.pub["float32"].to("cpu", copy=True)
        rec["async.age"] = st.age.to("cpu", copy=True)
        rec["async.rnd"] = st.rnd.to("cpu", copy=True)
    if master._robust_mass is not None:
        rec["robust.masses"] = torch.tensor(master._robust_masses, dtype=torch.float64)
    if logits:
        rec["eval_logits"] = eval_logits(master)
    for st in master._opt.state.values():
        for key, v in st.items():
            if isinstance(v, torch.Tensor):
                rec[f"opt.{key}"] = v.detach().to("cpu", copy=True)
    for key in ("train_loss", "train_acc", "grad_norm"):
        rec[key] = torch.tensor(np.stack([p[key] for p in payloads]))
    rec["deviation"] = torch.tensor([p["deviation"] for p in payloads], dtype=torch.float64)
    rec["mix_rounds"] = torch.tensor([float(p["mix_rounds"]) for p in payloads])
    rec["test_acc_last"] = torch.tensor(np.asarray(payloads[-1]["test_acc"], dtype=np.float64))
    return rec


def eval_logits(master, n: int = 256) -> torch.Tensor:
    """Eval-mode logits (running statistics, no dropout) of every agent on
    the first ``n`` test inputs, on the host."""
    X = master.test_data[0][:n]
    master.model.eval()
    with torch.no_grad():
        return master.model(X.unsqueeze(0).expand(len(master.node_names), *X.shape)).float().cpu()


def max_diffs(a: dict, b: dict) -> dict:
    """Per key, max |a - b| (host tensors, in their own dtype)."""
    return {k: 0.0 if torch.equal(a[k], b[k]) else float((a[k] - b[k]).abs().max())
            for k in b}


def _stale_indices(master):
    """The control of the superstep phases: from epoch 1 on, a replay
    whose fixed-address index buffer is not refreshed, so the training
    graph runs epoch 0's batches again."""
    real = master._stage_inputs

    def stage(j, idx, lr):
        if j == 0:
            real(j, idx, lr)
        elif lr is not None:
            master._static.lr.copy_(lr[j])

    master._stage_inputs = stage


def superstep_equality(make, k=SUPERSTEP_K, control=True, logits=False, inspect=None):
    """``make()`` builds a fresh initialised trainer on the card (same
    init and seeds each time).  Under deterministic algorithms: two eager
    runs of ``k`` ``train_epoch()`` calls (their spread is the limit; it
    is 0 when they agree bit for bit), the superstep ``train_epochs(k)``
    as graph replays, and (``control``) a superstep with stale indices,
    which must exceed the limit.  With ``logits`` the records hold the
    eval-mode logits after the last epoch too; ``inspect(master)`` adds
    its dict on the graph run to the facts.  Returns the verdict and the
    graph run's trainer facts."""
    runs, facts, nondet = {}, {}, set()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for run in ("eager_a", "eager_b", "graph") + (("control",) if control else ()):
            master = make()
            if run == "control":
                _stale_indices(master)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if run.startswith("eager"):
                    payloads = [master.train_epoch() for _ in range(k)]
                else:
                    payloads = master.train_epochs(k)
                torch.cuda.synchronize()
            nondet.update(str(w.message).split(" does not have a deterministic")[0][:80]
                          for w in caught if "deterministic" in str(w.message))
            runs[run] = trainer_record(master, payloads, logits)
            if run == "graph":
                facts = {"mix_rounds": [p["mix_rounds"] for p in payloads]}
                if inspect is not None:
                    facts["inspect"] = inspect(master)
                g = master._graphs
                if g is not None:  # None only in a rehearsal on the CPU
                    facts.update(
                        host_syncs_per_superstep=master.superstep_host_syncs[-1],
                        replays={"/".join(map(str, key)): n for key, n in g.replays.items()},
                        replays_per_epoch=sum(g.replays.values()) / k,
                        capture_seconds=g.capture_seconds)
            del master
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    spread = max_diffs(runs["eager_b"], runs["eager_a"])
    graph = max_diffs(runs["graph"], runs["eager_a"])
    verdict = {"eager_vs_eager_max_abs": spread, "graph_vs_eager_max_abs": graph,
               "bitwise_eager_vs_eager": not any(spread.values()),
               "bitwise_graph_vs_eager": not any(graph.values()),
               "graph_within_eager_spread": all(graph[key] <= spread[key] for key in graph),
               "nondeterministic_ops_warned": sorted(nondet)}
    if control:
        ctl = max_diffs(runs["control"], runs["eager_a"])
        verdict["control_params_max_abs"] = ctl["params"]
        verdict["control_rejected"] = ctl["params"] > spread["params"]
    verdict["ok"] = verdict["graph_within_eager_spread"] and verdict.get("control_rejected", True)
    return verdict, facts


def superstep_timing(make, samples_per_epoch, unit, k=SUPERSTEP_K, profile_to=None,
                     inspect=None):
    """Epoch wall times of the eager loop and of the superstep on one
    fresh trainer (default, non-deterministic algorithms): ``k`` eager
    epochs, then two supersteps of ``k`` (the first captures its graphs);
    the steady rates come from the last eager epoch and the second
    superstep.  With ``profile_to`` a third superstep runs under
    ``torch.profiler``; ``inspect(master)`` adds its dict at the end."""
    master = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager, eager_spans = [], None
    for i in range(k):
        if i == k - 1:
            eager_spans = _time_device_spans(master, eager=True)
        t0 = time.perf_counter()
        master.train_epoch()
        torch.cuda.synchronize()
        eager.append(time.perf_counter() - t0)
    for name in ("_run_steps", "_gossip", "_eval_accuracy"):
        del master.__dict__[name]
    eager_peak = torch.cuda.max_memory_allocated()
    sup = []
    for i in range(2):
        spans = _time_device_spans(master) if i == 1 else None
        t0 = time.perf_counter()
        master.train_epochs(k)
        torch.cuda.synchronize()
        sup.append(time.perf_counter() - t0)
    g = master._graphs
    device_ms = {name: sum(a.elapsed_time(b) for a, b in pairs) for name, pairs in spans.items()}
    out = {"eager_epoch_s": eager, "superstep_s": sup,
           "eager_epoch_spans_ms_by_events": {
               name: sum(a.elapsed_time(b) for a, b in pairs) for name, pairs in eager_spans.items()},
           "superstep_device_ms_by_events": device_ms,
           "superstep_idle_share_by_events": 1 - sum(device_ms.values()) / (sup[-1] * 1e3),
           "capture_seconds": g.capture_seconds,
           "steady_eager_epoch_s": eager[-1], "steady_superstep_epoch_s": sup[-1] / k,
           f"eager_{unit}_per_s": samples_per_epoch / eager[-1],
           f"superstep_{unit}_per_s": samples_per_epoch * k / sup[-1],
           "host_syncs_per_superstep": master.superstep_host_syncs,
           "replays_per_epoch": sum(g.replays.values()) / (2 * k),
           "peak_memory_bytes_eager": eager_peak,
           "peak_memory_bytes_with_graphs": torch.cuda.max_memory_allocated()}
    if profile_to is not None:
        out["profile"] = profile_superstep(master, k, *profile_to)
    if inspect is not None:
        out["inspect"] = inspect(master)
    del master
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _time_device_spans(master, eager=False) -> dict:
    """CUDA events around the trainer's phases from now on:
    ``{"train"|"gossip"|"eval": [(start, end), ...]}``.  Superstep: around
    each graph replay (device time with no host in it: one launch) and
    the eval.  ``eager``: around each epoch's steps, gossip and eval
    (device time with the host's launch gaps in it)."""
    spans = {"train": [], "gossip": [], "eval": []}

    def timed(name, fn):
        def run(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            spans[name].append((a, b))
            return out
        return run

    master._eval_accuracy = timed("eval", master._eval_accuracy)
    if eager:
        master._run_steps = timed("train", master._run_steps)
        master._gossip = timed("gossip", master._gossip)
    else:
        replay = master._graphs.replay
        master._graphs.replay = lambda key: timed(key[0], replay)(key)
    return spans


def profile_superstep(master, k, out_dir, name):
    """One profiled superstep of ``k`` epochs: device busy time from the
    kernel rows (graph-replayed kernels included), idle share of the
    wall; the table goes to ``out_dir/name``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        master.train_epochs(k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or "#" in ev.key:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return {"epochs": k, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "top": [{"kernel": key[:80], "ms": us / 1e3, "count": c} for us, key, c in rows[:8]]}


def _wrn_master():
    """The vision_slice's WRN-28-10 trainer, freshly initialised."""
    return make_vision_master(
        "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, WRN_EPOCHS, WRN_EVAL, augment=True,
        depth=28, widen_factor=10, dropout_rate=0.3, dtype=torch.bfloat16)


def eval_diagnosis(master) -> dict:
    """Why a trained vision trainer's test accuracy is what it is: per
    agent, the eval-mode accuracy (running statistics) and the share of
    test images its argmax puts in its most common class, against the
    accuracy of the same weights normalising each batch with its own
    statistics (train-mode BatchNorm, dropout off; the running statistics
    are put back after), and the test labels' most common class share."""
    X, y = master.test_data
    model, n = master.model, len(master.node_names)
    xs = X.unsqueeze(0).expand(n, *X.shape)
    stats = model.flat_stats.clone()
    with torch.no_grad():
        model.eval()
        pred = model(xs).argmax(-1)
        model.set_dropout(False)
        model.train()
        batch_pred = model(xs).argmax(-1)
        model.flat_stats.copy_(stats)
        model.set_dropout(master.dropout)
        model.eval()
    counts = torch.stack([torch.bincount(p, minlength=10) for p in pred])
    return {"eval_mode_acc": (pred == y).float().mean(1).tolist(),
            "eval_mode_top_class_share": (counts.max(1).values / len(y)).tolist(),
            "batch_stats_acc": (batch_pred == y).float().mean(1).tolist(),
            "test_labels_top_class_share": float(torch.bincount(y.long()).max() / len(y))}


def phase_superstep(out_dir=None):
    """WRN-28-10 as vision_slice runs it (4 agents x B 256, bf16, dropout
    0.3, augmentation, SGD): the graph superstep of 3 epochs against 3
    eager epochs, bit for bit (or within two eager runs' spread; eval-mode
    logits of 256 test images included), the stale-index control, then
    the eager and superstep epoch times; what sets the test accuracy
    (:func:`eval_diagnosis`) after the 3 epochs and after the timing's 9."""
    verdict, facts = superstep_equality(_wrn_master, logits=True, inspect=eval_diagnosis)
    emit({"phase": "superstep", "model": "wrn-28-10", "k": SUPERSTEP_K, **facts, **verdict})
    if not verdict["ok"]:
        raise AssertionError("WRN superstep disagrees with the eager epochs, or the "
                             "stale-index control was not rejected")
    if facts["host_syncs_per_superstep"] != 0:
        raise AssertionError(f"WRN superstep synchronised: {facts}")
    timing = superstep_timing(_wrn_master, WRN_AGENTS * WRN_BATCH * WRN_STEPS, "samples",
                              profile_to=None if out_dir is None
                              else (out_dir, "profile_wrn_superstep.txt"), inspect=eval_diagnosis)
    emit({"phase": "superstep_timing", "model": "wrn-28-10", **timing})
    return timing


def phase_lm_superstep(fa, out_dir=None):
    """The full-width LM slice as a superstep of 3 epochs against 3 eager
    epochs (bit for bit, or within two eager runs' spread, with the
    stale-index control), its replay-aware launch counts (layers x steps
    x k for every kernel, plus the boundary eval's forwards, all on the
    wgmma body), then the eager and superstep epoch times."""
    make = lambda: make_trainer("flash", LAYERS, AGENTS, EPOCHS, STEPS)  # noqa: E731
    verdict, facts = superstep_equality(make)
    master = make()
    fa.reset_launch_counts()
    master.train_epochs(SUPERSTEP_K)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in fa.KERNELS.values()}
    bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    n_eval = math.ceil(len(master.test_data[0]) / master.eval_batch_size)
    per = LAYERS * STEPS * SUPERSTEP_K
    expect = {"flash_fwd": per + LAYERS * n_eval, "flash_bwd_dq": per,
              "flash_bwd_dkv": per, "flash_bwd_rowterm": per}
    del master
    gc.collect()
    torch.cuda.empty_cache()
    on_wgmma = all(bodies[n]["wgmma"] == launches[n]
                   for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    emit({"phase": "lm_superstep", "k": SUPERSTEP_K, **facts, **verdict, "launches": launches,
          "launches_by_body": bodies, "expected_launches": expect})
    if not verdict["ok"]:
        raise AssertionError("LM superstep disagrees with the eager epochs, or the "
                             "stale-index control was not rejected")
    if launches != expect or not on_wgmma:
        raise AssertionError(f"LM superstep launches {launches} != {expect} or off wgmma")
    if facts["host_syncs_per_superstep"] != 0:
        raise AssertionError(f"LM superstep synchronised: {facts}")
    timing = superstep_timing(make, AGENTS * BATCH * SEQ * STEPS, "tokens",
                              profile_to=None if out_dir is None
                              else (out_dir, "profile_lm_superstep.txt"))
    emit({"phase": "lm_superstep_timing", **timing})
    return launches, timing["superstep_tokens_per_s"]


def _route_trainer(**over):
    """The MLP of the CPU superstep oracles at MNIST width (784 -> 150)
    on 4 agents, B 64, 2 steps an epoch, on the card."""
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training.trainer import GossipTrainer

    rng = np.random.default_rng(0)
    nodes = list(range(4))
    train = {a: (rng.normal(size=(128, 784)).astype(np.float32),
                 rng.integers(0, 10, size=(128,)).astype(np.int32)) for a in nodes}
    test = (rng.normal(size=(64, 784)).astype(np.float32),
            rng.integers(0, 10, size=(64,)).astype(np.int32))
    kw = dict(node_names=nodes, model="mlp", model_kwargs={"hidden_dim": 150},
              weights=Topology.ring(4), train_data=train, test_data=test, batch_size=64,
              epoch_len=2, stat_step=1, learning_rate=0.05, optimizer="sgd",
              optimizer_kwargs={"momentum": 0.9}, seed=3, device=DEVICE)
    kw.update(over)
    master = GossipTrainer(**kw)
    master.initialize_nodes()
    return master


def route_configs():
    from distributed_learning_tpu_torch.parallel import Topology

    ring, complete = Topology.ring(4), Topology.complete(4)
    alternating = lambda e: ring if e % 2 == 0 else complete  # noqa: E731
    return {
        "plain": dict(mix_times=2),
        "mix_times_schedule": dict(mix_times_schedule=lambda e: 1 + e % 3),
        "chebyshev": dict(chebyshev=True, mix_times=3),
        "global_avg_every": dict(global_avg_every=2, epoch_cons_num=2),
        "topology_schedule": dict(topology_schedule=alternating, mix_times=2),
        "topology_schedule_chebyshev": dict(topology_schedule=alternating, chebyshev=True,
                                            mix_times=3),
        "lr_schedule_adam": dict(optimizer="adam", optimizer_kwargs={},
                                 learning_rate=lambda c: 1e-3 / (1 + c)),
        # The port's Adam (eps_root != 0): its moments and step count are
        # device tensors from construction, so the capture takes it.
        "adamw_eps_root": dict(optimizer="adamw",
                               optimizer_kwargs={"eps_root": 1e-8, "weight_decay": 1e-2},
                               learning_rate=lambda c: 1e-3 / (1 + c)),
        "adaptive_comm": dict(mix_times=2, adaptive_comm={"target": 0.05, "gain": 1.0}),
        "mix_eps": dict(mix_eps=1e-3),
    }


def phase_superstep_routes():
    """Each gossip configuration the superstep carries, graph against
    eager on the MLP; the host syncs inside each superstep (0 for the
    fixed-count configurations; eps and adaptive read the residual)."""
    bad = []
    for name, cfg in route_configs().items():
        verdict, facts = superstep_equality(lambda: _route_trainer(**cfg), control=False)
        emit({"phase": "superstep_routes", "config": name, **facts, **verdict})
        fixed = "eps" not in name and "adaptive" not in name
        if not verdict["ok"] or (fixed and facts.get("host_syncs_per_superstep", 0) != 0):
            bad.append(name)
    if bad:
        raise AssertionError(f"superstep routes failed: {bad}")


# ---------------------------------------------------------------------- #
# CHOCO compressed gossip and checkpoints                                #
# ---------------------------------------------------------------------- #
# Top-k CHOCO at 10% per leaf with the reference's default step size.
CHOCO = {"compression": "topk:0.1", "compression_gamma": 0.2}


def _wrn_choco_master():
    """The WRN slice's trainer (as :func:`_wrn_master`) gossiping with
    top-k CHOCO."""
    return make_vision_master(
        "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, WRN_EPOCHS, WRN_EVAL, augment=True,
        trainer_kwargs=CHOCO, depth=28, widen_factor=10, dropout_rate=0.3,
        dtype=torch.bfloat16)


def choco_round_parts(master) -> dict:
    """The CHOCO round's parts timed alone (CUDA events, mean of 3 after a
    warm-up) on copies of the trainer's buffers: the per-leaf top-k
    selection with its scatter (``FusedCompressor.compress``), the mixing
    GEMM on the estimates, and the whole in-place round; with the bytes
    the round must move (x and xhat read and written, once each) over
    the card's memory rate."""
    from distributed_learning_tpu_torch.ops import mixing as ops

    eng, layout = master._choco, master._choco_layout
    x = {"float32": master.model.flat_params.clone()}
    xhat = {"float32": master._choco_xhat.clone()}
    gen = torch.Generator(DEVICE)
    gen.set_state(master._choco_gen.get_state())
    delta = {"float32": x["float32"] - xhat["float32"]}
    out = {"float32": torch.empty_like(xhat["float32"])}
    W = eng.engine._W_dev
    parts = {
        "selection_ms": cuda_ms(lambda: eng.fused_compressor.compress(delta, layout, gen,
                                                                      n=eng.n), 3),
        "mix_gemm_ms": cuda_ms(lambda: ops.dense_mix(xhat, W, out=out), 3),
        "round_ms": cuda_ms(lambda: eng.round_(x, xhat, None, layout, gen), 3),
    }
    nbytes = 4 * x["float32"].numel() * 4
    parts.update(round_bytes=nbytes, round_bytes_bound_ms=nbytes / PEAK_HBM_BYTES * 1e3)
    del x, xhat, delta, out
    torch.cuda.empty_cache()
    return parts


def phase_choco_slice(dense_timing):
    """WRN-28-10 as vision_slice runs it, gossiping with top-k CHOCO (10%
    per leaf, gamma 0.2): two supersteps of 3 epochs as graph replays (the
    first captures), the second timed; per epoch the loss, the post-mix
    deviation, the training and gossip replays' device time (CUDA
    events) and the rate; then the round's parts alone, the nominal wire
    bytes against the dense round's, and peak memory, beside the dense
    superstep epoch of the same run."""
    master = _wrn_choco_master()
    layout = master._choco_layout
    wire = master._choco.fused_compressor.wire_bytes_per_round(layout, WRN_AGENTS)
    dense_bytes = layout.bytes_per_round(WRN_AGENTS)
    samples = WRN_AGENTS * WRN_BATCH * WRN_STEPS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = master.train_epochs(SUPERSTEP_K)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    spans = _time_device_spans(master)
    t0 = time.perf_counter()
    payloads = master.train_epochs(SUPERSTEP_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in spans.items()}
    for j, p in enumerate(payloads):
        emit({"phase": "choco_slice", "epoch": p["epoch"],
              "train_loss": p["train_loss"].tolist(), "deviation": p["deviation"],
              "mix_rounds": p["mix_rounds"], "train_replay_ms": ms["train"][j],
              "choco_round_replay_ms": ms["gossip"][j],
              "superstep_samples_per_s": samples * SUPERSTEP_K / wall,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    g = master._graphs
    losses = [float(np.mean(p["train_loss"])) for p in first + payloads]
    epoch_s = wall / SUPERSTEP_K
    dense_epoch_s = dense_timing["steady_superstep_epoch_s"]
    summary = {
        "phase": "choco_summary", "model": "wrn-28-10", "compression": CHOCO,
        "params_per_agent": master.model.param_count(),
        "largest_leaf": max(size for _o, size in layout.bucket_spans("float32")),
        "epoch_losses": losses, "first_superstep_s": first_s,
        "choco_superstep_epoch_s": epoch_s, "dense_superstep_epoch_s_same_run": dense_epoch_s,
        "choco_over_dense_epoch": epoch_s / dense_epoch_s,
        "choco_round_replay_ms_mean": float(np.mean(ms["gossip"])),
        # The dense superstep's gossip replays (round + deviation), per epoch.
        "dense_round_replay_ms_same_run":
            dense_timing["superstep_device_ms_by_events"]["gossip"] / SUPERSTEP_K,
        "choco_round_share_of_epoch": float(np.mean(ms["gossip"])) / (epoch_s * 1e3),
        "wire_bytes_per_round": wire, "dense_bytes_per_round": dense_bytes,
        "wire_over_dense": wire / dense_bytes,
        "host_syncs_per_superstep": master.superstep_host_syncs,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "round_parts": choco_round_parts(master),
    }
    if g is not None:  # None only in a rehearsal on the CPU
        summary.update(replays={"/".join(map(str, key)): n for key, n in g.replays.items()},
                       capture_seconds=g.capture_seconds)
    emit(summary)
    xhat_live = bool(master._choco_present and master._choco_xhat.abs().sum() > 0)
    del master
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"CHOCO WRN loss did not fall: {losses}")
    if not all(math.isfinite(p["deviation"]) for p in payloads) or not xhat_live:
        raise AssertionError("CHOCO WRN: non-finite deviation or no live estimates")
    if g is not None and (any(summary["host_syncs_per_superstep"])
                          or summary["replays"].get("gossip/1/1") != 2 * SUPERSTEP_K):
        raise AssertionError(f"CHOCO WRN superstep synchronised or skipped a replay: {summary}")


def selection_order_check() -> dict:
    """The card's top-k keeps the CPU's entries (``lax.top_k``'s order:
    NaN first, ties to the lowest index) on a (4, P) buffer shaped like
    WRN-28-10's largest leaves, whose magnitudes take 8 values so that
    ties straddle every k boundary, with NaNs, bitwise, per leaf and
    over the whole buffer; and random-k keeps exactly k per agent on
    both (their generators differ, so their draws do)."""
    from distributed_learning_tpu_torch.ops import mixing as ops
    from distributed_learning_tpu_torch.parallel import compression as tc

    g = torch.Generator().manual_seed(0)
    sizes = {"conv": 640 * 640 * 9, "shortcut": 320 * 640, "bn": 640}
    x = {k: (torch.randint(1, 9, (WRN_AGENTS, n), generator=g).float() / 8
             * (torch.randint(0, 2, (WRN_AGENTS, n), generator=g) * 2 - 1))
         for k, n in sizes.items()}
    x["conv"][0, ::100_003] = float("nan")
    buffers, layout = ops.flatten_stacked(x)
    out = {}
    for name, comp, budget in (("topk_per_leaf", tc.top_k(0.1), "per-leaf"),
                               ("topk_global", tc.top_k(0.1), "global"),
                               ("randk_global", tc.random_k(0.1), "global")):
        fc = tc.FusedCompressor(comp, budget)
        cpu = fc.compress(buffers, layout, torch.Generator().manual_seed(1), n=WRN_AGENTS)
        card = fc.compress({k: v.to(DEVICE) for k, v in buffers.items()}, layout,
                           torch.Generator(DEVICE).manual_seed(1), n=WRN_AGENTS)
        a, b = card["float32"].cpu(), cpu["float32"]
        if name == "randk_global":
            k = (b != 0).sum(1)
            out[name + "_keeps_k"] = bool(((a != 0).sum(1) == k).all() and (k == k[0]).all())
        else:
            out[name] = bool(torch.equal(a.isnan(), b.isnan())
                             and torch.equal(a.nan_to_num(), b.nan_to_num()))
    return out


def choco_route_configs():
    return {
        "topk_per_leaf": dict(compression="topk:0.1", mix_times=2),
        "topk_global_error_feedback": dict(compression="topk:0.1", compression_budget="global",
                                           compression_error_feedback=True,
                                           compression_gamma=0.1),
        "randk_per_leaf": dict(compression="randk:0.1", mix_times=2),
        "sign": dict(compression="sign", compression_gamma=0.1),
        "int8": dict(compression="int8"),
        "atopk": dict(compression="atopk:0.1"),
        "topk_global_avg_every": dict(compression="topk:0.1", global_avg_every=2),
        "randk_global_avg_every": dict(compression="randk:0.1", global_avg_every=2),
        "topk_mix_times_schedule": dict(compression="topk:0.1",
                                        mix_times_schedule=lambda e: 1 + e % 3),
        "topk_adaptive_comm": dict(compression="topk:0.1", mix_times=2,
                                   adaptive_comm={"target": 0.05, "gain": 1.0}),
    }


def phase_choco_routes():
    """Each CHOCO configuration, graph replays against eager epochs on the
    MLP of superstep_routes, bit for bit (CHOCO's estimates, bank and
    generator included); host syncs per superstep (0 but for
    adaptive_comm)."""
    order = selection_order_check()
    emit({"phase": "choco_routes", "check": "selection_order_card_vs_cpu", **order})
    bad = [k for k, v in order.items() if not v]
    for name, cfg in choco_route_configs().items():
        verdict, facts = superstep_equality(lambda: _route_trainer(**cfg), control=False)
        emit({"phase": "choco_routes", "config": name, **facts, **verdict})
        fixed = "adaptive" not in name
        if not (verdict["bitwise_eager_vs_eager"] and verdict["bitwise_graph_vs_eager"]) or (
                fixed and facts.get("host_syncs_per_superstep", 0) != 0):
            bad.append(name)
    if bad:
        raise AssertionError(f"CHOCO routes failed: {bad}")


def phase_checkpoint():
    """The WRN-28-10 CHOCO run trains 2 epochs (graph replays), saves a
    checkpoint and trains 1 more; a fresh trainer restores it and trains
    that epoch: parameters, statistics, optimizer state, CHOCO's
    estimates and generator, and the payloads must be equal bit for bit
    (deterministic algorithms).  Prints the checkpoint's bytes and its
    save and restore seconds."""
    import shutil

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_ckpt")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "wrn_choco.pt")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic.*")
            a = _wrn_choco_master()
            a.train_epochs(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.save_checkpoint(path)
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(path)
            want = trainer_record(a, [a.train_epoch()])
            del a
            gc.collect()
            torch.cuda.empty_cache()
            b = _wrn_choco_master()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.restore_checkpoint(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            epochs_done = b._epochs_done
            got = trainer_record(b, [b.train_epoch()])
            del b
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(folder, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    diffs = max_diffs(got, want)
    ok = not any(diffs.values()) and "choco.xhat" in want and epochs_done == 2
    emit({"phase": "checkpoint", "model": "wrn-28-10", "compression": CHOCO,
          "checkpoint_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
          "resumed_vs_uninterrupted_max_abs": diffs, "ok": ok})
    if not ok:
        raise AssertionError("the resumed WRN CHOCO run differs from the uninterrupted one")


# ---------------------------------------------------------------------- #
# Async (stale-weighted) and Byzantine-robust gossip                     #
# ---------------------------------------------------------------------- #
# Agent 3 publishes every third round; a contribution older than one round
# is dropped.  Two rounds an epoch: over 3 epochs its age runs 0, 1, 2, 0,
# 1, 2, so its pull is halved, then dropped.
STRAGGLER = {"staleness_bound": 1, "publish_period": [1, 1, 1, 3]}
ASYNC = {"async_gossip": STRAGGLER, "mix_times": 2}


def _robust_configs():
    """Phase 17's two WRN gossip configurations."""
    from distributed_learning_tpu_torch.parallel import Topology

    return {
        "async_trim_complete": dict(ASYNC, weights=Topology.complete(WRN_AGENTS),
                                    robust_mixing={"kind": "trim", "trim": 1}),
        "clip_adaptive_ring": dict(robust_mixing={"kind": "clip", "radius": 2.0,
                                                  "adaptive": True}),
    }


def _wrn_gossip_master(trainer_kwargs):
    """The WRN slice's trainer (as :func:`_wrn_master`) with these gossip
    options."""
    return make_vision_master(
        "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, WRN_EPOCHS, WRN_EVAL, augment=True,
        trainer_kwargs=trainer_kwargs, depth=28, widen_factor=10, dropout_rate=0.3,
        dtype=torch.bfloat16)


def _carry(master) -> dict:
    st = master._async_state
    return {"age": st.age.tolist(), "rnd": int(st.rnd)} if st is not None else {}


def gossip_round_alone(master) -> dict:
    """The trainer's gossip round timed alone (CUDA events, mean of 3 after
    a warm-up) on copies of its buffers, carry and mass, with the dense
    round on the same buffers beside it; the bytes the round must move
    (x read and written once, and with the async carry its published
    buffer read once) over the card's memory rate; the memory the round
    takes above what it starts from."""
    from distributed_learning_tpu_torch.parallel import AsyncGossipState

    eng, st = master.engine, master._async_state
    x = {"float32": master.model.flat_params.clone()}
    spare = eng.spare_for(x, 1)
    mass = torch.zeros((), device=DEVICE)
    cfg = master._robust_cfg
    if st is not None:
        carry = AsyncGossipState({"float32": st.pub["float32"].clone()}, st.age.clone(),
                                 st.rnd.clone())
        tau, periods = master._async_tau(master._epochs_done), master._async_sim["periods"]

    def run():
        if st is None:
            eng.mix_robust_(x, cfg, 1, mass=mass, spare=spare)
        elif cfg is None:
            eng.mix_async_(x, carry, tau, 1, periods=periods, spare=spare)
        else:
            eng.mix_async_robust_(x, carry, cfg, tau, 1, periods=periods, mass=mass, spare=spare)

    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(run, 3, warmup=0)
    extra = torch.cuda.max_memory_allocated() - base
    dense_ms = cuda_ms(lambda: eng.mix_(x, 1, spare=spare), 3)
    nbytes = x["float32"].numel() * 4 * (3 if st is not None else 2)
    out = {"round_ms": ms, "dense_round_ms_same_buffers": dense_ms, "round_bytes": nbytes,
           "round_bytes_bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
           "round_over_bound": ms / (nbytes / PEAK_HBM_BYTES * 1e3),
           "round_peak_extra_bytes": extra}
    del x, spare
    torch.cuda.empty_cache()
    return out


def gram_cancellation(master) -> dict:
    """``pairwise_sq_dists`` (the reference's Gram form ``sx + sy - 2 x.y``
    in float32) on the trainer's buffers (live against published with
    the async carry) against the float64 direct distance ``sum (x_i -
    y_j)^2``, over pairs of distinct agents: the largest relative and
    absolute gaps, the smallest direct distance and the largest squared
    norm (the scale the cancellation works at)."""
    from distributed_learning_tpu_torch.ops import mixing as ops

    x = master.model.flat_params
    y = x if master._async_state is None else master._async_state.pub["float32"]
    gram = ops.pairwise_sq_dists({"float32": x}, None if y is x else {"float32": y}).double()
    n, rel, abs_gap, direct_min = x.shape[0], 0.0, 0.0, math.inf
    for i in range(n):
        for j in range(n):
            if i != j:
                direct = float((x[i].double() - y[j].double()).square().sum())
                gap = abs(float(gram[i, j]) - direct)
                rel, abs_gap = max(rel, gap / direct), max(abs_gap, gap)
                direct_min = min(direct_min, direct)
    return {"gram_vs_float64_max_rel_gap": rel, "gram_vs_float64_max_abs_gap": abs_gap,
            "float64_min_sq_dist": direct_min,
            "max_sq_norm": float(x.double().square().sum(1).max())}


def gossip_slice(phase, make, dense_timing) -> dict:
    """A WRN gossip configuration ``make()`` builds: its graph superstep
    against eager epochs bit for bit (carry and masses included) with the
    host syncs, then two supersteps of 3 epochs (the first captures) with
    the per-epoch loss, deviation and mass, the carry after each superstep,
    each replay's device time, the superstep epoch beside phase 10's
    dense one, the round alone against its bound, peak memory and the
    Gram form's cancellation.  Returns the summary."""
    verdict, facts = superstep_equality(make, control=False)
    emit({"phase": phase, "check": "graph_vs_eager", **facts, **verdict})
    if not (verdict["bitwise_eager_vs_eager"] and verdict["bitwise_graph_vs_eager"]):
        raise AssertionError(f"{phase}: the graph superstep differs from the eager epochs")
    if facts.get("host_syncs_per_superstep", 0) != 0:
        raise AssertionError(f"{phase}: the superstep synchronised: {facts}")
    master = make()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = master.train_epochs(SUPERSTEP_K)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    carries = [_carry(master)]
    spans = _time_device_spans(master)
    t0 = time.perf_counter()
    payloads = master.train_epochs(SUPERSTEP_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    carries.append(_carry(master))
    peak = torch.cuda.max_memory_allocated()
    ms = {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in spans.items()}
    masses = master._robust_masses[-SUPERSTEP_K:] if master._robust_mass is not None else None
    for j, p in enumerate(payloads):
        emit({"phase": phase, "epoch": p["epoch"], "train_loss": p["train_loss"].tolist(),
              "deviation": p["deviation"], "mix_rounds": p["mix_rounds"],
              "robust_mass": None if masses is None else masses[j],
              "train_replay_ms": ms["train"][j], "gossip_replay_ms": ms["gossip"][j]})
    epoch_s = wall / SUPERSTEP_K
    dense_epoch_s = dense_timing["steady_superstep_epoch_s"]
    losses = [float(np.mean(p["train_loss"])) for p in first + payloads]
    summary = {
        "phase": phase + "_summary", "model": "wrn-28-10",
        "params_per_agent": master.model.param_count(), "epoch_losses": losses,
        "deviations": [p["deviation"] for p in first + payloads],
        "robust_masses": list(master._robust_masses) if masses is not None else None,
        "carry_after_each_superstep": carries, "first_superstep_s": first_s,
        "superstep_epoch_s": epoch_s, "dense_superstep_epoch_s_phase10": dense_epoch_s,
        "over_dense_epoch": epoch_s / dense_epoch_s,
        "gossip_replay_ms_mean": float(np.mean(ms["gossip"])),
        "dense_gossip_replay_ms_phase10":
            dense_timing["superstep_device_ms_by_events"]["gossip"] / SUPERSTEP_K,
        "host_syncs_per_superstep": master.superstep_host_syncs,
        "peak_memory_bytes": peak,
        "round_alone": gossip_round_alone(master),
    }
    if master._robust_cfg is not None and master._robust_cfg.kind == "clip":
        summary["gram_form"] = gram_cancellation(master)
    g = master._graphs
    if g is not None:  # None only in a rehearsal on the CPU
        summary.update(replays={"/".join(map(str, key)): n for key, n in g.replays.items()},
                       capture_seconds=g.capture_seconds)
    emit(summary)
    del master
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the WRN loss did not fall: {losses}")
    if not all(math.isfinite(d) for d in summary["deviations"]):
        raise AssertionError(f"{phase}: a deviation is not finite")
    if g is not None and any(summary["host_syncs_per_superstep"]):
        raise AssertionError(f"{phase}: the superstep synchronised: {summary}")
    return summary


def phase_async_slice(dense_timing):
    """WRN-28-10 as vision_slice runs it, gossiping asynchronously on the
    Metropolis ring with the straggler (two rounds an epoch): agent 3's
    age after epoch 0, 1, 2 of a superstep must be 1, 0, 2 (its round
    ages 0, 1, 2, 0, 1, 2)."""
    summary = gossip_slice("async_slice", lambda: _wrn_gossip_master(ASYNC), dense_timing)
    ages = [c["age"][3] for c in summary["carry_after_each_superstep"]]
    if ages != [2, 2] or [c["rnd"] for c in summary["carry_after_each_superstep"]] != [6, 12]:
        raise AssertionError(f"async_slice: straggler ages / rounds off: {summary}")


def phase_robust_slice(dense_timing):
    """Two WRN-28-10 configurations as phase 16 runs them: (a) the
    straggler's async gossip on ``Topology.complete(4)`` (Metropolis)
    through the trimmed mean (trim 1), whose mass must be > 0 every
    epoch; (b) clipped gossip on the ring with an adaptive radius, 2x the
    median neighbour distance, synchronous."""
    for name, cfg in _robust_configs().items():
        summary = gossip_slice(f"robust_slice/{name}", lambda cfg=cfg: _wrn_gossip_master(cfg),
                               dense_timing)
        if name.startswith("async_trim") and not all(m > 0 for m in summary["robust_masses"]):
            raise AssertionError(f"robust_slice/{name}: the trim redirected no mass: {summary}")


def robust_route_configs():
    from distributed_learning_tpu_torch.parallel import Topology

    complete = Topology.complete(4)
    clip = {"kind": "clip", "radius": 0.05}
    return {
        "async_neutral": dict(async_gossip={"staleness_bound": 0, "publish_period": 1},
                              mix_times=2),
        "async_straggler": dict(ASYNC),
        "async_tau_schedule": dict(async_gossip={"staleness_bound": lambda e: e % 3,
                                                 "publish_period": [1, 1, 1, 3]}, mix_times=2),
        "async_mix_times_schedule": dict(async_gossip=STRAGGLER,
                                         mix_times_schedule=lambda e: 1 + e % 3),
        "async_adaptive_comm": dict(ASYNC, adaptive_comm={"target": 0.05, "gain": 1.0}),
        "clip": dict(robust_mixing=clip, mix_times=2),
        "clip_adaptive": dict(robust_mixing={"kind": "clip", "radius": 0.5, "adaptive": True},
                              mix_times=2),
        "trim_complete": dict(robust_mixing={"kind": "trim", "trim": 1}, weights=complete,
                              mix_times=2),
        "median_complete": dict(robust_mixing="median", weights=complete, mix_times=2),
        "async_clip": dict(ASYNC, robust_mixing=clip),
        "async_trim_complete": dict(ASYNC, robust_mixing={"kind": "trim", "trim": 1},
                                    weights=complete),
    }


def neutral_knobs_check() -> dict:
    """On the card, under deterministic algorithms: the MLP route's
    superstep with async tau 0 and periods 1, with clip radius inf and
    with trim 0 equals the plain route bit for bit (parameters and
    deviations)."""
    plain = dict(mix_times=2)
    knobs = {"async_tau0": dict(plain, async_gossip={"staleness_bound": 0, "publish_period": 1}),
             "clip_inf": dict(plain, robust_mixing={"kind": "clip", "radius": math.inf}),
             "trim0": dict(plain, robust_mixing={"kind": "trim", "trim": 0})}
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic.*")
            ref = _route_trainer(**plain)
            ref_dev = [p["deviation"] for p in ref.train_epochs(SUPERSTEP_K)]
            for name, cfg in knobs.items():
                t = _route_trainer(**cfg)
                dev = [p["deviation"] for p in t.train_epochs(SUPERSTEP_K)]
                out[name] = bool(torch.equal(t.model.flat_params, ref.model.flat_params)
                                 and dev == ref_dev)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


# The persistent-liar attack of tests/test_robust.py: 8 agents on the
# complete graph, agents 2 and 5 re-inject 1e3 before every round.
LIAR_AGENTS, LIARS, POISON, LIAR_ROUNDS = 8, (2, 5), 1e3, 6
LIAR_DEFENSES = {"plain": None, "clip": {"kind": "clip", "radius": 2.0},
                 "trim": {"kind": "trim", "trim": 2}, "median": "median",
                 "async_plain": None, "async_clip": {"kind": "clip", "radius": 2.0}}
# A card round against the CPU round from the same input and carry: 2e-6
# relative (the liars' rows sit at 1e3) and one float32 step at the
# poison's scale absolute (6.1e-5): an honest agent's trimmed round adds
# ~W * 1e3 in the GEMM and takes it back in the correction.
LIAR_RTOL, LIAR_ATOL = 2e-6, float(np.spacing(np.float32(POISON)))


def _liar_engine(device):
    from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology

    return ConsensusEngine(Topology.complete(LIAR_AGENTS).metropolis_weights(), device=device)


def _liar_round(eng, name, x, st):
    """One round of defense ``name`` on the poisoned state ``x`` (the
    async ones with the carry ``st``): ``(mixed, carry, mass or None)``."""
    spec, inp = LIAR_DEFENSES[name], {"w": x}
    if name == "plain":
        return eng.mix(inp, times=1)["w"], None, None
    if name == "async_plain":
        y, st = eng.mix_async(inp, st, tau=1, periods=1)
        return y["w"], st, None
    if name.startswith("async"):
        y, st, m = eng.mix_async_robust(inp, st, spec=spec, tau=1, periods=1)
        return y["w"], st, float(m)
    y, m = eng.mix_robust(inp, spec, times=1)
    return y["w"], None, float(m)


def _to_cpu(st):
    from distributed_learning_tpu_torch.parallel import AsyncGossipState

    if st is None:
        return None
    return AsyncGossipState({k: v.cpu() for k, v in st.pub.items()}, st.age.cpu(), st.rnd.cpu())


def liar_attack(device) -> dict:
    """The attack on ``device``: per defense the honest agents' largest
    distance from their initial mean after 6 rounds, the mass per round,
    and each round's poisoned input, carry and output (host copies)."""
    eng = _liar_engine(device)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.normal(size=(LIAR_AGENTS, 6)).astype(np.float32), device=device)
    honest = [i for i in range(LIAR_AGENTS) if i not in LIARS]
    mean = x0[honest].double().mean(0)
    out = {}
    for name in LIAR_DEFENSES:
        x, st, masses, rounds = x0, None, [], []
        for _ in range(LIAR_ROUNDS):
            inp = x.clone()
            inp[list(LIARS)] = POISON
            carry = _to_cpu(st)
            x, st, m = _liar_round(eng, name, inp, st)
            masses += [] if m is None else [m]
            rounds.append((inp.cpu(), carry, x.cpu()))
        out[name] = {"honest_spread": float((x[honest].double() - mean).abs().max()),
                     "masses": masses, "rounds": rounds}
    return out


def liar_rounds_vs_cpu(attack) -> tuple:
    """Each round of ``attack`` run again on the CPU from the same input
    and carry: per defense the largest gap, and whether every round is
    within the limits."""
    eng = _liar_engine("cpu")
    gaps, held = {}, {}
    for name, r in attack.items():
        gaps[name], held[name] = 0.0, True
        for inp, carry, got in r["rounds"]:
            want = _liar_round(eng, name, inp, carry)[0]
            gaps[name] = max(gaps[name], float((got - want).abs().max()))
            held[name] &= bool(((got - want).abs() <= LIAR_ATOL + LIAR_RTOL * want.abs()).all())
    return gaps, held


def phase_robust_routes():
    """Each async and robust configuration on the MLP of superstep_routes:
    graph replays against eager epochs bit for bit (carry and masses
    included), host syncs per superstep (0 but for adaptive_comm); then
    the neutral knobs against the plain route, and the persistent-liar
    attack on the card: plain mixing dragged past 50, every defense held
    under 5, the async clip's mass positive every round, and every round
    equal to the CPU's round from the same input and carry."""
    bad = []
    for name, cfg in robust_route_configs().items():
        verdict, facts = superstep_equality(lambda: _route_trainer(**cfg), control=False)
        emit({"phase": "robust_routes", "config": name, **facts, **verdict})
        fixed = "adaptive_comm" not in name
        if not (verdict["bitwise_eager_vs_eager"] and verdict["bitwise_graph_vs_eager"]) or (
                fixed and facts.get("host_syncs_per_superstep", 0) != 0):
            bad.append(name)
    neutral = neutral_knobs_check()
    emit({"phase": "robust_routes", "check": "neutral_knobs_bitwise_plain", **neutral})
    bad += [f"neutral/{k}" for k, v in neutral.items() if not v]
    card = liar_attack(DEVICE)
    gaps, held = liar_rounds_vs_cpu(card)
    emit({"phase": "robust_routes", "check": "persistent_liars",
          "honest_spread": {k: r["honest_spread"] for k, r in card.items()},
          "masses": {k: r["masses"] for k, r in card.items() if r["masses"]},
          "card_vs_cpu_max_abs": gaps, "card_equals_cpu": held})
    if not (card["plain"]["honest_spread"] > 50 and card["async_plain"]["honest_spread"] > 50):
        bad.append("liars/plain_not_dragged")
    bad += [f"liars/{k}" for k in ("clip", "trim", "median", "async_clip")
            if not card[k]["honest_spread"] < 5]
    if not all(m > 0 for m in card["async_clip"]["masses"]):
        bad.append("liars/async_clip_mass")
    bad += [f"liars/card_vs_cpu/{k}" for k, ok in held.items() if not ok]
    if bad:
        raise AssertionError(f"robust routes failed: {bad}")


# ---------------------------------------------------------------------- #
# Phases 19-22: gradient tracking, EXTRA, push-sum, pairwise, interop     #
# ---------------------------------------------------------------------- #
# tracking_slice: DSGT and EXTRA train the LM slice's model (4 agents on
# the Metropolis ring, B 2 per agent, each agent its own token stream)
# for 3 steps after init, EXTRA guarding every 2nd step.  Limits against
# the same steps through plain attention (2 layers, where the plain
# path's scores fit the card): the LM slice's (loss 2e-4, 5e-2 relative
# on the state's displacement from init and on the tracker or
# difference).  The tracking invariant: |sum_i y_i - sum_i g_i| within
# 1e-5 of max |sum_i g_i| (float32 round-off of 4-term sums over 3
# steps); the control, a tracker update without "- g_old", leaves a gap
# of the size of sum_i g_old, which must exceed it.
TRACK_STEPS, TRACK_ALPHA, TRACK_PROJECT_EVERY, TRACK_PLAIN_LAYERS = 3, 0.5, 2, 2
SUM_GAP_RTOL = 1e-5
# tracking_routes: card against the port on the CPU, 200 steps of the
# Titanic logreg; float32 sums in another order over contracting steps.
ROUTES_STEPS, ROUTES_ATOL = 200, 1e-4
# pushsum_pairwise / mixer_interop: WRN-28-10's parameter count per agent.
WRN_PARAMS = 36_489_290
PUSHSUM_ROUNDS, PAIRWISE_ROUNDS, NARROW = 40, 64, 4096
PUSHSUM_SUM_RTOL, PUSHSUM_MEAN_ATOL, PAIRWISE_MEAN_ATOL, INTEROP_ATOL = 1e-5, 1e-4, 1e-6, 2e-6


def _lm_batches(steps: int, seed: int = 0):
    """(steps, N, B, T) inputs and next-token labels on the card: agent
    ``a`` reads cyclic windows from its own quarter of start phases."""
    rng = np.random.default_rng(seed)
    quarter = VOCAB // AGENTS
    xs, ys = [], []
    for _ in range(steps):
        per = [pattern_batch(BATCH, range(quarter * a, quarter * (a + 1)), rng)
               for a in range(AGENTS)]
        xs.append(np.stack([p[0] for p in per]))
        ys.append(np.stack([p[1] for p in per]))
    return (torch.as_tensor(np.stack(xs), device=DEVICE),
            torch.as_tensor(np.stack(ys), device=DEVICE))


class LMOracle:
    """The stacked gradient oracle of the LM: ``(x (N, P), step) ->
    flat_grads`` by one forward/backward of the agent-stacked model on
    batch ``step``, each agent on its own stream.  It records each call's
    (N,) loss into a device tensor and CUDA events around the call, and
    with ``keep_inputs`` a copy of each call's ``(x, step)``."""

    def __init__(self, model, xs, ys, keep_inputs=False):
        from distributed_learning_tpu_torch.training.trainer import get_loss

        self.model, self.xs, self.ys = model, xs, ys
        self.loss_fn = get_loss("cross_entropy")
        self.losses = torch.zeros(xs.shape[0], AGENTS, device=DEVICE)
        self.spans, self.inputs, self.keep_inputs = [], [], keep_inputs

    def __call__(self, x, step):
        if self.keep_inputs:
            self.inputs.append((x.clone(), step))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        model = self.model
        model.flat_params.copy_(x)
        model.flat_grads.zero_()
        loss = self.loss_fn(model(self.xs[step]), self.ys[step])
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="grad and param do not obey")
            loss.sum().backward()
        self.losses[step] = loss.detach()
        b.record()
        self.spans.append((a, b))
        return model.flat_grads


def _lm_model(attn_impl, layers):
    from distributed_learning_tpu_torch.models import TransformerLM

    return TransformerLM(
        vocab_size=VOCAB, num_layers=layers, num_heads=HEADS, head_dim=HEAD_DIM, max_len=SEQ,
        attn_impl=attn_impl, dtype=torch.bfloat16, n_agents=AGENTS, device=DEVICE, seed=0)


def _tracking_engine(kind, oracle):
    from distributed_learning_tpu_torch.parallel import (
        ExtraEngine, GradientTrackingEngine, Topology)

    W = Topology.ring(AGENTS).metropolis_weights()
    if kind == "dsgt":
        return GradientTrackingEngine(W, oracle, learning_rate=TRACK_ALPHA, stacked_grads=True,
                                      device=DEVICE)
    return ExtraEngine(W, oracle, learning_rate=TRACK_ALPHA, stacked_grads=True,
                       project_every=TRACK_PROJECT_EVERY, device=DEVICE)


def _tracker_sum_gap_rel(state) -> tuple:
    """(max |sum_i y_i - sum_i g_i|, that over max |sum_i g_i|)."""
    gap = float((state.y.sum(0) - state.g.sum(0)).abs().max())
    return gap, gap / float(state.g.sum(0).abs().max())


def plain_losses(inputs) -> np.ndarray:
    """The plain-attention model's (N,) loss at each (x, step) the kernel
    path's oracle saw: forward only, same batches."""
    from distributed_learning_tpu_torch.training.trainer import get_loss

    model = _lm_model("full", TRACK_PLAIN_LAYERS)
    xs, ys = _lm_batches(TRACK_STEPS + 2)
    loss_fn = get_loss("cross_entropy")
    out = []
    with torch.no_grad():
        for x, step in inputs:
            model.flat_params.copy_(x)
            out.append(loss_fn(model(xs[step]), ys[step]).cpu().numpy())
    del model
    return np.stack(out)


def tracking_run(kind, attn_impl, layers, timed=False, control=False,
                 keep_inputs=False) -> dict:
    """``init`` and TRACK_STEPS steps of DSGT or EXTRA on the LM, each step
    run alone between CUDA events (the oracle's own events split it into
    gradients and gossip/update); returns the losses, the state and its
    facts.  ``control`` (DSGT): one more step whose tracker update
    forgets ``- g_old`` (the state's g zeroed before it).
    ``keep_inputs``: also return a copy of every (x, step) the oracle
    was given."""
    from distributed_learning_tpu_torch.training.graphs import count_host_syncs

    model = _lm_model(attn_impl, layers)
    xs, ys = _lm_batches(TRACK_STEPS + 2)  # the last one for the control's step
    oracle = LMOracle(model, xs, ys, keep_inputs)
    eng = _tracking_engine(kind, oracle)
    x0 = model.flat_params.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = eng.init(x0)
    steps, trace = [], []
    with count_host_syncs(eng.device) as syncs:
        for _ in range(TRACK_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, tr = eng.run(state, 1)
            b.record()
            steps.append((a, b))
            trace.append(tr)
    torch.cuda.synchronize()
    out = {"losses": oracle.losses[:TRACK_STEPS + 1].cpu().numpy(), "state": state, "x0": x0,
           "residual_trace": torch.cat(trace).tolist(), "host_syncs_in_steps": syncs[0],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "params_per_agent": model.param_count()}
    if keep_inputs:
        out["inputs"] = oracle.inputs
    if timed:
        grad = [a.elapsed_time(b) for a, b in oracle.spans[1:]]
        total = [a.elapsed_time(b) for a, b in steps]
        out["step_ms"] = total
        out["grad_ms"] = grad
        out["gossip_update_ms"] = [t - g for t, g in zip(total, grad)]
    if kind == "dsgt":
        out["tracker_sum_gap"], out["tracker_sum_gap_rel"] = _tracker_sum_gap_rel(state)
    if control:
        bad, _ = eng.run(state._replace(g=torch.zeros_like(state.g)), 1)
        out["control_sum_gap"], out["control_sum_gap_rel"] = _tracker_sum_gap_rel(bad)
        del bad
    del model, oracle, eng
    return out


def _update_bound_ms(kind, P) -> tuple:
    """The byte bound of one step's gossip/update: each (N, P) float32
    input read once and each output written once (a fused step that
    mixes in the same pass).  DSGT reads x, y, g_old, g_new and writes x,
    y (g_new is kept as g); EXTRA reads x, c, d, r, g_prev, g_new and
    writes x, c, d, r."""
    passes = 6 if kind == "dsgt" else 10
    nbytes = passes * AGENTS * P * 4
    return nbytes, nbytes / PEAK_HBM_BYTES * 1e3


def _rel(a, b) -> float:
    """Max over agents of ||a - b|| / ||b|| for (N, ...) tensors."""
    d = (a.float() - b.float()).reshape(a.shape[0], -1).norm(dim=1)
    return float((d / b.float().reshape(b.shape[0], -1).norm(dim=1)).max())


def phase_tracking_slice(fa):
    """DSGT and EXTRA on the LM slice's model at full depth and width,
    the kernels launched by the stacked oracle counted under
    ``lm_tracking``; then both at 2 layers through the kernels and through
    plain attention from the same init and batches."""
    fa.reset_launch_counts()
    full = {}
    for kind in ("dsgt", "extra"):
        full[kind] = tracking_run(kind, "flash", LAYERS, timed=True)
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k.name: k.launches for k in fa.KERNELS.values()}
    bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    calls = 2 * (TRACK_STEPS + 1)  # oracle calls: init + the steps, per engine
    expect = {name: LAYERS * calls for name in launches}
    bad = []
    for kind, r in full.items():
        nbytes, bound = _update_bound_ms(kind, r["params_per_agent"])
        st = r.pop("state")
        finite = bool(torch.isfinite(st.x).all())
        r.pop("x0")
        losses = r.pop("losses")
        emit({"phase": "tracking_slice", "engine": kind, "layers": LAYERS, "agents": AGENTS,
              "params_per_agent": r["params_per_agent"], "alpha": TRACK_ALPHA,
              "project_every": TRACK_PROJECT_EVERY if kind == "extra" else None,
              "loss_per_call": losses.tolist(), "update_bytes_bound": nbytes,
              "update_bound_ms": bound,
              "update_over_bound": [t / bound for t in r["gossip_update_ms"]],
              **r, "finite": finite})
        if not (finite and np.isfinite(losses).all()):
            bad.append(f"{kind}/not_finite")
        if r["host_syncs_in_steps"] not in (0, None):
            bad.append(f"{kind}/host_syncs")
        del st
    if not full["dsgt"]["tracker_sum_gap_rel"] <= SUM_GAP_RTOL:
        bad.append("dsgt/sum_gap")
    emit({"phase": "tracking_slice", "launches": launches, "expected_launches": expect,
          "launches_by_body": bodies})
    if launches != expect:
        bad.append("launches")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if bodies[name].get("wgmma", 0) != launches[name]:
            bad.append(f"{name}_left_wgmma")
    gc.collect()
    torch.cuda.empty_cache()
    # Against plain attention, 2 layers: the plain model's loss at every
    # state the kernel path's oracle saw, and the two trajectories; the
    # DSGT run adds the control.
    for kind in ("dsgt", "extra"):
        runs = {impl: tracking_run(kind, impl, TRACK_PLAIN_LAYERS, keep_inputs=(impl == "flash"),
                                   control=(kind == "dsgt" and impl == "flash"))
                for impl in ("flash", "full")}
        f, p = runs["flash"], runs["full"]
        plain = plain_losses(f.pop("inputs")[:TRACK_STEPS + 1])
        loss_err = float(np.max(np.abs(f["losses"] - plain) / np.abs(plain)))
        disp = _rel(f["state"].x - f["x0"], p["state"].x - p["x0"])
        second = "y" if kind == "dsgt" else "d"
        sec = _rel(getattr(f["state"], second), getattr(p["state"], second))
        ok = loss_err <= LOSS_RTOL and disp <= GRAD_RTOL and sec <= GRAD_RTOL
        gaps = {k: f[k] for k in ("tracker_sum_gap_rel", "control_sum_gap_rel") if k in f}
        if kind == "dsgt":
            ok = ok and gaps["tracker_sum_gap_rel"] <= SUM_GAP_RTOL < gaps["control_sum_gap_rel"]
        emit({"phase": "tracking_slice", "check": "flash_vs_plain", "engine": kind,
              "layers": TRACK_PLAIN_LAYERS, "loss_rel_err_same_state": loss_err,
              "trajectory_loss_rel_err": float(np.max(np.abs(f["losses"] - p["losses"])
                                                      / np.abs(p["losses"]))),
              "displacement_rel_err": disp, f"{second}_rel_err": sec, **gaps,
              "limits": {"loss_rtol": LOSS_RTOL, "state_rtol": GRAD_RTOL,
                         "sum_gap_rtol": SUM_GAP_RTOL}, "ok": ok})
        if not ok:
            bad.append(f"{kind}/flash_vs_plain")
        del runs, f, p
        gc.collect()
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"tracking_slice failed: {bad}")
    return launches


def _titanic_routes(device):
    """DSGT, EXTRA (guard every 2nd step) and the reference's gossip GD
    recipe (grad step, then one round) for ROUTES_STEPS steps on the
    label-skewed synthetic Titanic of examples/dsgt_titanic.py, on
    ``device``: final states, residual traces, host syncs in the runs."""
    from distributed_learning_tpu_torch.data import load_titanic, split_data
    from distributed_learning_tpu_torch.models.logreg import loss_fn
    from distributed_learning_tpu_torch.parallel import (
        ConsensusEngine, ExtraEngine, GradientTrackingEngine, Topology)
    from distributed_learning_tpu_torch.training.graphs import count_host_syncs

    X_tr, y_tr, _, _ = load_titanic()
    order = np.argsort(y_tr)
    shards = split_data(X_tr[order], y_tr[order], AGENTS)
    m = min(len(shards[i][0]) for i in range(AGENTS))
    X = torch.as_tensor(np.stack([shards[i][0][:m] for i in range(AGENTS)]), dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(np.stack([shards[i][1][:m] for i in range(AGENTS)]), dtype=torch.float32,
                        device=device)

    def grads(w, step):
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(w, X, y, 1e-2).sum(), w)
        return g

    W = Topology.ring(AGENTS).metropolis_weights()
    x0 = torch.zeros(AGENTS, X.shape[-1], device=device)
    out = {}
    for name, eng in (
            ("dsgt", GradientTrackingEngine(W, grads, learning_rate=0.5, stacked_grads=True,
                                            device=device)),
            ("extra", ExtraEngine(W, grads, learning_rate=0.5, project_every=2,
                                  stacked_grads=True, device=device))):
        state = eng.init(x0)
        with count_host_syncs(eng.device) as syncs:
            state, trace = eng.run(state, ROUTES_STEPS)
        out[name] = (state.x.cpu(), trace.cpu(), syncs[0])
    engine = ConsensusEngine(W, device=device)
    x = {"float32": x0.clone()}
    trace = torch.empty(ROUTES_STEPS, device=device)
    with count_host_syncs(engine.device) as syncs:
        for t in range(ROUTES_STEPS):
            x["float32"].sub_(grads(x["float32"], t), alpha=0.5)
            engine.mix_(x, 1)
            engine.max_deviation_(x, trace[t])
    out["gossip"] = (x["float32"].cpu(), trace.cpu(), syncs[0])
    return out


def phase_tracking_routes():
    """DSGT, EXTRA and gossip GD on the Titanic logreg: the card against
    the port on the CPU, states and residual traces within ROUTES_ATOL,
    and no host sync inside a run on the card."""
    card, cpu = _titanic_routes(DEVICE), _titanic_routes("cpu")
    bad = []
    for name in card:
        (x, tr, syncs), (cx, ctr, _) = card[name], cpu[name]
        dx, dtr = float((x - cx).abs().max()), float((tr - ctr).abs().max())
        ok = dx <= ROUTES_ATOL and dtr <= ROUTES_ATOL and syncs in (0, None)
        emit({"phase": "tracking_routes", "route": name, "steps": ROUTES_STEPS,
              "card_vs_cpu_state_max_abs": dx, "card_vs_cpu_trace_max_abs": dtr,
              "final_residual": float(tr[-1]), "host_syncs_in_run": syncs,
              "limit": ROUTES_ATOL, "ok": ok})
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"tracking_routes failed: {bad}")


def phase_pushsum_pairwise():
    """Push-sum on a directed ring of 4 over WRN-28-10-sized parameter
    buffers (4 x 36,489,290 float32, normal from a seed): totals kept,
    estimates at the mean of x0, each round's time against its byte
    bound; 64 pairwise rounds: the mean kept, time per round; both
    against the CPU on fed draws at a narrow width."""
    from distributed_learning_tpu_torch.parallel import (
        ConsensusEngine, PushSumEngine, Topology, push_sum_matrix)

    P = push_sum_matrix({i: [(i + 1) % AGENTS] for i in range(AGENTS)})
    g = torch.Generator(device=DEVICE).manual_seed(8)
    x0 = torch.randn(AGENTS, WRN_PARAMS, generator=g, device=DEVICE)
    eng = PushSumEngine(P, device=DEVICE)
    num, den = eng.lift(x0)
    s_num, s_den = num["float32"].double().sum(0), float(den.double().sum())
    spare = {k: torch.empty_like(v) for k, v in num.items()}
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    den = eng.rounds_(num, den, PUSHSUM_ROUNDS, spare)
    b.record()
    torch.cuda.synchronize()
    round_ms = a.elapsed_time(b) / PUSHSUM_ROUNDS
    num_rel = float((num["float32"].double().sum(0) - s_num).norm() / s_num.norm())
    den_rel = abs(float(den.double().sum()) - s_den) / s_den
    est = num["float32"] / den[:, None]
    mean_err = float((est - x0.mean(0, keepdim=True)).abs().max())
    round_bytes = 2 * x0.numel() * 4  # the numerator read and written once
    bound = round_bytes / PEAK_HBM_BYTES * 1e3
    del num, spare, est
    # Pairwise rounds on the same buffers, draws from a card generator.
    ring = ConsensusEngine(Topology.ring(AGENTS).metropolis_weights(), device=DEVICE)
    buf = {"float32": x0}
    mean0 = x0.double().mean(0)
    draws = torch.randint(0, len(ring.pairwise_edges()), (PAIRWISE_ROUNDS,), generator=g,
                          device=DEVICE)
    torch.cuda.synchronize()
    a.record()
    ring.pairwise_(buf, draws)
    b.record()
    torch.cuda.synchronize()
    pair_ms = a.elapsed_time(b) / PAIRWISE_ROUNDS
    pair_mean = float((x0.double().mean(0) - mean0).abs().max())
    pair_bytes = 4 * WRN_PARAMS * 4  # two rows read, two rows written
    del x0, buf
    torch.cuda.empty_cache()
    # The card against the CPU at a narrow width, draws fed.
    xn = torch.from_numpy(np.random.default_rng(9).normal(size=(AGENTS, NARROW))
                          .astype(np.float32))
    fed = torch.from_numpy(np.random.default_rng(10).integers(0, AGENTS, PAIRWISE_ROUNDS))
    cpu_ring = ConsensusEngine(Topology.ring(AGENTS).metropolis_weights(), device="cpu")
    pw_gap = float((ring.mix_pairwise_edges({"x": xn.to(DEVICE)}, fed)["x"].cpu()
                    - cpu_ring.mix_pairwise_edges({"x": xn}, fed)["x"]).abs().max())
    w = [1.0, 2.0, 3.0, 4.0]
    ps_gap = float((eng.mix(xn.to(DEVICE), 7, weights=w).cpu()
                    - PushSumEngine(P, device="cpu").mix(xn, 7, weights=w)).abs().max())
    ok = (num_rel <= PUSHSUM_SUM_RTOL and den_rel <= PUSHSUM_SUM_RTOL
          and mean_err <= PUSHSUM_MEAN_ATOL and pair_mean <= PAIRWISE_MEAN_ATOL
          and pw_gap <= INTEROP_ATOL and ps_gap <= INTEROP_ATOL)
    emit({"phase": "pushsum_pairwise", "agents": AGENTS, "width": WRN_PARAMS,
          "pushsum_rounds": PUSHSUM_ROUNDS, "pushsum_round_ms": round_ms,
          "pushsum_round_bound_ms": bound, "pushsum_round_over_bound": round_ms / bound,
          "numerator_sum_rel_err": num_rel, "weight_sum_rel_err": den_rel,
          "estimate_vs_mean_max_abs": mean_err,
          "pairwise_rounds": PAIRWISE_ROUNDS, "pairwise_round_ms": pair_ms,
          "pairwise_round_bound_ms": pair_bytes / PEAK_HBM_BYTES * 1e3,
          "pairwise_mean_drift_max_abs": pair_mean,
          "narrow_card_vs_cpu_max_abs": {"pairwise_fed": pw_gap, "pushsum_weighted": ps_gap},
          "limits": {"sum_rtol": PUSHSUM_SUM_RTOL, "mean_atol": PUSHSUM_MEAN_ATOL,
                     "pairwise_mean_atol": PAIRWISE_MEAN_ATOL, "card_vs_cpu": INTEROP_ATOL},
          "ok": ok})
    if not ok:
        raise AssertionError("pushsum_pairwise failed")


def phase_mixer_interop():
    """``TorchModelMixer`` over 4 port WRN-28-10 replicas (``n_agents=1``,
    each its own init) on the ring: the mixed parameters equal
    ``ConsensusEngine.mix_`` on the stacked buffers, the running
    statistics stay per replica, and the time per mix against the bound
    of reading and writing every parameter once."""
    from distributed_learning_tpu_torch.interop import TorchModelMixer
    from distributed_learning_tpu_torch.models import WideResNet
    from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology

    models = {a: WideResNet(28, 10, n_agents=1, device=DEVICE, seed=a) for a in range(AGENTS)}
    for a, m in models.items():
        m.flat_stats.fill_(float(a))
    W = Topology.ring(AGENTS).metropolis_weights()
    ref = {"float32": torch.cat([m.flat_params for m in models.values()]).clone()}
    ConsensusEngine(W, device=DEVICE).mix_(ref, 1)
    mixer = TorchModelMixer(models, W)
    mixer.mix(1)
    err = max(float((m.flat_params[0] - ref["float32"][a]).abs().max())
              for a, m in models.items())
    stats_kept = all(bool((m.flat_stats == float(a)).all()) for a, m in models.items())
    n_tensors = len(list(models[0].parameters()))
    ms = cuda_ms(lambda: mixer.mix(1), 5)
    P = models[0].param_count()
    nbytes = 2 * AGENTS * P * 4
    bound = nbytes / PEAK_HBM_BYTES * 1e3
    ok = err <= INTEROP_ATOL and stats_kept
    emit({"phase": "mixer_interop", "replicas": AGENTS, "params_per_replica": P,
          "parameter_tensors_per_replica": n_tensors, "max_abs_vs_engine": err,
          "statistics_per_replica_kept": stats_kept, "mix_ms": ms, "mix_bound_ms": bound,
          "mix_over_bound": ms / bound, "limit": INTEROP_ATOL, "ok": ok})
    del models, mixer, ref
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("mixer_interop failed")


# ---------------------------------------------------------------------- #
# Phases 23-26: the observability layer, LM eval and the CLI             #
# ---------------------------------------------------------------------- #
SMOKE_OBS = "_smoke_obs"
OBS_ON = dict(profile_costs=True, timer_every_n=1)
# lm_eval: perplexity of the 2-layer LM through kernel A against plain
# attention from the same weights.  The slice's plain-path check held
# the loss to 1.3e-5-1.7e-5 relative (PR 8), i.e. ~1.5e-4 on a
# perplexity; 1e-3 leaves room and still fails a forward that drops a
# key tile (several percent there).
EVAL_PPL_RTOL = 1e-3
# The LM profile's FLOPs against the formula (obs_lm).
LM_FLOPS_RTOL = 2e-2


def _smoke_dir(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


def lm_step_flops(layers=None) -> float:
    """One LM slice step's model FLOPs: 6 per multiply-add parameter of
    the matrix products per token (forward, dX, dW; the embeddings are
    gathers) and, per layer, 4 forward and 10 backward per live (query,
    key) pair and head dimension of the causal attention."""
    layers = LAYERS if layers is None else layers
    d = HEADS * HEAD_DIM
    tokens = AGENTS * BATCH * SEQ
    mm_params = layers * (3 * d * d + d * d + 8 * d * d) + d * VOCAB
    pairs = AGENTS * BATCH * HEADS * SEQ * (SEQ + 1) // 2
    return 6.0 * mm_params * tokens + 14.0 * pairs * HEAD_DIM * layers


def _obs_runs(make, k=SUPERSTEP_K, launches=None):
    """Under deterministic algorithms: ``train_epochs(k)`` with obs off
    and with ``obs=MetricsRegistry()``, ``profile_costs`` and
    ``timer_every_n=1`` (each a fresh trainer from ``make(**kw)`` under a
    default registry of its own), then ``k`` eager ``train_epoch()``
    calls with obs on.  A second superstep of each superstep run is
    timed (wall, synchronised).  Returns the records, registries, times,
    host syncs and the obs-on trainer (kept for later phases, 2k epochs
    trained); with
    ``launches`` (the flash module) the kernel counts of the obs-on
    superstep alone."""
    from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry
    from distributed_learning_tpu_torch.obs import cost

    cost.clear_profiles()
    out = {"records": {}, "defaults": {}, "trainers": {}, "seconds": {}, "syncs": {}}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for run in ("off", "eager", "on"):  # one trainer alive at a time
            default = MetricsRegistry()
            with use_registry(default), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                kw = {} if run == "off" else dict(obs=MetricsRegistry(), **OBS_ON)
                master = make(**kw)
                torch.cuda.synchronize()
                if run == "eager":
                    payloads = [master.train_epoch() for _ in range(k)]
                else:
                    if run == "on" and launches is not None:
                        launches.reset_launch_counts()
                    payloads = master.train_epochs(k)
                    torch.cuda.synchronize()
                    if run == "on" and launches is not None:
                        out["launches"] = {kk.name: kk.launches for kk in launches.KERNELS.values()}
                        out["bodies"] = {kk.name: dict(kk.by_body)
                                         for kk in launches.KERNELS.values()}
                    out["syncs"][run] = list(master.superstep_host_syncs)
                out["records"][run] = trainer_record(master, payloads)
                out["defaults"][run] = (dict(default.counters), dict(default.gauges))
                if run != "off":
                    out.setdefault("trainer_counters", {})[run] = dict(
                        master._obs_registry.counters)
                if run != "eager":
                    t0 = time.perf_counter()
                    master.train_epochs(k)
                    torch.cuda.synchronize()
                    out["seconds"][run] = time.perf_counter() - t0
                    out["syncs"][run] += master.superstep_host_syncs[1:]
            if run == "on":
                out["trainers"][run] = master
                out["registry"] = master._obs_registry
            del master
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _obs_checks(phase, runs, k=SUPERSTEP_K) -> dict:
    """The obs phases' common checks: obs-on == obs-off bit for bit, 0
    host syncs inside every superstep, and the superstep's counters
    (the engines' on the default registry, the trainer's rounds and
    mass) equal to those of ``k`` eager epochs."""
    diff = max_diffs(runs["records"]["on"], runs["records"]["off"])
    reg = runs["registry"]
    dflt_on, dflt_eager = runs["defaults"]["on"], runs["defaults"]["eager"]
    con, ceager = runs["trainer_counters"]["on"], runs["trainer_counters"]["eager"]
    trainer_counts = {key: (con.get(key), ceager.get(key))
                      for key in ("consensus.rounds_run", "consensus.robust.clipped_mass")}
    facts = {
        "obs_on_vs_off_max_abs": diff,
        "bitwise_obs_on_vs_off": not any(diff.values()),
        "host_syncs_per_superstep": runs["syncs"],
        "default_registry_superstep": dflt_on[0],
        "default_registry_eager": dflt_eager[0],
        "trainer_counters_superstep_vs_eager": trainer_counts,
        "trainer_dispatches": {"superstep": con.get("trainer.dispatches"),
                               "eager": ceager.get("trainer.dispatches")},
        "superstep_s": runs["seconds"],
        "epoch_ms": {r: s / k * 1e3 for r, s in runs["seconds"].items()},
        "obs_epoch_delta_ms": (runs["seconds"]["on"] - runs["seconds"]["off"]) / k * 1e3,
        "timer": {"samples": reg.counters.get("cost.timer.samples"),
                  "step_time_s": reg.series.get("cost.step_time_s/trainer.superstep"),
                  "mfu": reg.gauges.get("cost.mfu/trainer.superstep")},
    }
    if not facts["bitwise_obs_on_vs_off"]:
        raise AssertionError(f"{phase}: obs-on run differs from obs-off: {diff}")
    if any(n != 0 for s in runs["syncs"].values() for n in s):
        raise AssertionError(f"{phase}: a superstep synchronised: {runs['syncs']}")
    if dflt_on != dflt_eager or not dflt_on[0]:
        raise AssertionError(f"{phase}: superstep counters {dflt_on} != eager {dflt_eager}")
    if any(a != b for a, b in trainer_counts.values()):
        raise AssertionError(f"{phase}: trainer counters differ: {trainer_counts}")
    if facts["timer"]["mfu"] is None or not facts["timer"]["step_time_s"]:
        raise AssertionError(f"{phase}: the timer recorded no step time or MFU: {facts['timer']}")
    return facts


def phase_obs_superstep(dense_timing):
    """WRN-28-10 as the superstep phase runs it: ``train_epochs(3)`` with
    obs on (``MetricsRegistry``, ``profile_costs``, ``timer_every_n=1``)
    against obs off, bit for bit, 0 host syncs, counters equal to 3
    eager epochs'; the epoch-time delta, the step profile's FLOPs against
    ``wrn_conv_flops``, the timer's step time against superstep_timing's
    events, MFU.  Then one more superstep under ``utils/profiling.trace``:
    ``summarize_trace``'s top rows and its coverage of the event-timed
    window.  Returns the obs-on trainer's registry dump path."""
    from distributed_learning_tpu_torch.obs import cost
    from distributed_learning_tpu_torch.utils import profiling

    def make(**kw):
        return make_vision_master(
            "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, WRN_EPOCHS, WRN_EVAL,
            augment=True, trainer_kwargs=kw, depth=28, widen_factor=10, dropout_rate=0.3,
            dtype=torch.bfloat16)

    runs = _obs_runs(make)
    facts = _obs_checks("obs_superstep", runs)
    prof = cost.get_profile(f"trainer.superstep{SUPERSTEP_K}")
    conv = wrn_conv_flops(WRN_AGENTS * WRN_BATCH, 28, 10)
    events_ms = dense_timing["superstep_device_ms_by_events"]
    facts.update(profile_flops_per_step=prof.flops, wrn_conv_flops_per_step=conv,
                 profile_over_conv=prof.flops / conv,
                 superstep_timing_events_ms=sum(events_ms.values()),
                 peak_flops=cost.device_peak_flops())
    master = runs["trainers"]["on"]
    out_dir = _smoke_dir(SMOKE_OBS)
    os.makedirs(out_dir, exist_ok=True)
    trace_dir = os.path.join(out_dir, "trace")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profiling.trace(trace_dir):
        start.record()
        master.train_epochs(SUPERSTEP_K)
        end.record()
        torch.cuda.synchronize()
    window_s = start.elapsed_time(end) / 1e3
    rows = profiling.summarize_trace(trace_dir, top=8)
    coverage = profiling.trace_coverage(trace_dir, window_s)
    print(profiling.format_trace_summary(rows, coverage), flush=True)
    facts["trace"] = {"window_ms": window_s * 1e3, "device_rows_coverage": coverage,
                      "top": [{k: r[k] for k in ("operation", "host_or_device", "occurrences",
                                                 "total_self_us", "device_self_pct")}
                              for r in rows]}
    dump = os.path.join(out_dir, "obs_superstep.jsonl")
    facts["jsonl_lines"] = master._obs_registry.dump_jsonl(dump)
    shutil.rmtree(trace_dir)
    del master, runs
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "obs_superstep", "model": "wrn-28-10", "k": SUPERSTEP_K, **facts})
    if coverage is None:
        raise AssertionError("the trace of a WRN superstep holds no device row")
    return dump


def phase_obs_lm(fa):
    """The full-width flash LM slice as obs_superstep: bit for bit, 0
    host syncs, counters equal to 3 eager epochs'; A, B, C and the
    pre-pass launched by the obs-on superstep (the profile step's own
    launches uncounted); the profile's FLOPs a step within 2% of
    :func:`lm_step_flops`; MFU.  Returns the superstep's launch counts
    and the obs-on trainer (6 epochs trained) in a dict the eval phase
    takes it from."""
    from distributed_learning_tpu_torch.obs import cost

    def make(**kw):
        return make_trainer("flash", LAYERS, AGENTS, EPOCHS, STEPS, **kw)

    runs = _obs_runs(make, launches=fa)
    facts = _obs_checks("obs_lm", runs)
    launches, bodies = runs["launches"], runs["bodies"]
    n_eval = math.ceil(4 / 2)  # make_trainer's 4 test sequences, eval batch 2
    per = LAYERS * STEPS * SUPERSTEP_K
    expect = {"flash_fwd": per + LAYERS * n_eval, "flash_bwd_dq": per,
              "flash_bwd_dkv": per, "flash_bwd_rowterm": per}
    prof = cost.get_profile(f"trainer.superstep{SUPERSTEP_K}")
    formula = lm_step_flops()
    facts.update(launches=launches, launches_by_body=bodies, expected_launches=expect,
                 profile_flops_per_step=prof.flops, formula_flops_per_step=formula,
                 profile_over_formula=prof.flops / formula, peak_flops=cost.device_peak_flops())
    emit({"phase": "obs_lm", "k": SUPERSTEP_K, **facts})
    if launches != expect:
        raise AssertionError(f"obs_lm launches {launches} != {expect}")
    if abs(prof.flops / formula - 1.0) > LM_FLOPS_RTOL:
        raise AssertionError(f"LM profile {prof.flops:.4e} FLOPs a step vs formula {formula:.4e}")
    return {"launches": launches, "master": runs["trainers"]["on"], "mfu": facts["timer"]["mfu"]}


EVAL_EPOCHS = 12  # the LM's epochs before lm_eval (obs_lm's 6 and 2 more supersteps)


def phase_lm_eval(fa, obs_lm):
    """``training/eval.perplexity`` of the trained full-width LM (the
    obs_lm trainer, trained to ``EVAL_EPOCHS`` epochs: at init the
    random head is not calibrated and its perplexity may exceed the
    vocabulary) on 8 x 4096 tokens of the slice's test distribution,
    every agent, through kernel A (no lse; no backward kernel may
    launch): eval ms by CUDA events, tokens/s, perplexity <= vocab.  Then
    the 2-layer LM from one seed (untrained) through kernel A and through
    plain attention: perplexity within ``EVAL_PPL_RTOL``."""
    from distributed_learning_tpu_torch.models import TransformerLM
    from distributed_learning_tpu_torch.training.eval import perplexity

    master = obs_lm.pop("master")
    while master._epochs_done < EVAL_EPOCHS:
        master.train_epochs(SUPERSTEP_K)
    torch.cuda.synchronize()
    tokens, _ = pattern_batch(8, range(VOCAB), np.random.default_rng(21))
    perplexity(master.model, tokens[:2], batch_size=2)  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ppl = perplexity(master.model, tokens, batch_size=2)
    end.record()
    end.synchronize()
    launches = {k.name: k.launches for k in fa.KERNELS.values()}
    ms = start.elapsed_time(end)
    scored = AGENTS * tokens.shape[0] * tokens.shape[1]
    del master
    gc.collect()
    torch.cuda.empty_cache()
    pair = {}
    for impl in ("flash", "full"):
        model = TransformerLM(vocab_size=VOCAB, num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM,
                              max_len=SEQ, attn_impl=impl, dtype=torch.bfloat16, n_agents=1,
                              device=DEVICE, seed=5)
        pair[impl] = perplexity(model, tokens, batch_size=2)
        del model
        torch.cuda.empty_cache()
    rel = abs(pair["flash"] / pair["full"] - 1.0)
    emit({"phase": "lm_eval", "sequences": tokens.shape[0], "seq": tokens.shape[1],
          "agents": AGENTS, "trained_epochs": EVAL_EPOCHS, "perplexity": ppl.tolist(),
          "vocab": VOCAB, "eval_ms": ms,
          "tokens_per_s": scored / (ms / 1e3), "launches": launches,
          "two_layer_perplexity": pair, "two_layer_rel_diff": rel,
          "two_layer_rtol": EVAL_PPL_RTOL})
    if not (launches["flash_fwd"] > 0 and launches["flash_bwd_dq"] == 0
            and launches["flash_bwd_dkv"] == 0 and launches["flash_bwd_rowterm"] == 0):
        raise AssertionError(f"eval did not run forward-only through kernel A: {launches}")
    if not (np.all(np.isfinite(ppl)) and np.max(ppl) <= VOCAB):
        raise AssertionError(f"perplexity {ppl} not finite or above the vocabulary {VOCAB}")
    if not rel <= EVAL_PPL_RTOL:
        raise AssertionError(f"2-layer perplexity through kernel A vs plain: {pair}")
    return launches


def _checkpoint_tree(folder):
    from distributed_learning_tpu_torch import cli

    return torch.load(os.path.join(folder, cli.CHECKPOINT_FILE), weights_only=True)


def _tree_diffs(a, b, where=""):
    """Paths where two checkpoint trees differ (tensors bit for bit)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [where]
        return [d for k in a for d in _tree_diffs(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _tree_diffs(x, y, f"{where}/{i}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [where]
    return [] if a == b else [where]


# The CLI phase's model and data flags (the baseline notebook's WRN at
# width 10 and the WRN slice's batch, its depth cut from 28 to 10: what the
# phase holds — resume == uninterrupted bit for bit, --testOnly, obs-report
# — does not depend on depth, and the whole script must stay within its
# time limit), and flags every training run gets (none on the card: the
# CLI's default device is the card).
CLI_MODEL = ["--net_type", "wide-resnet", "--depth", "10", "--widen_factor", "10",
             "--dropout", "0.3", "--dataset", "cifar10"]
CLI_DATA = ["--nodes", "4", "--batch-size", "256", "--n-train", "4096"]
CLI_EVERY_RUN: list = []


def phase_cli(obs_jsonl):
    """``cli.main`` in process, WRN-10-10 on synthetic CIFAR (4 nodes x B
    256, 4096 training images, supersteps of 2): 2 epochs with a
    checkpoint, ``--resume`` to 3, against an uninterrupted 3-epoch run
    (the checkpoints equal bit for bit, under deterministic algorithms);
    ``--testOnly`` on the resumed checkpoint; ``obs-report`` over
    obs_superstep's JSONL.  The checkpoints are removed after."""
    import contextlib
    import io

    from distributed_learning_tpu_torch import cli

    root = _smoke_dir("_smoke_cli_ckpt")
    a, b = os.path.join(root, "resumed"), os.path.join(root, "uninterrupted")
    common = CLI_MODEL + CLI_DATA + ["--superstep", "2"] + CLI_EVERY_RUN
    runs = {"first": common + ["--epochs", "2", "--checkpoint-dir", a],
            "resume": ["--resume", "--epochs", "3", "--checkpoint-dir", a] + CLI_EVERY_RUN,
            "uninterrupted": common + ["--epochs", "3", "--checkpoint-dir", b],
            "test_only": ["--testOnly", "--checkpoint-dir", a] + CLI_EVERY_RUN,
            "obs_report": ["obs-report", obs_jsonl]}
    out, seconds, rcs = {}, {}, {}
    os.makedirs(root, exist_ok=True)  # the configs are saved beside the checkpoint dirs
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, argv in runs.items():
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rcs[name] = cli.main(argv)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            out[name] = buf.getvalue().splitlines()
            gc.collect()
            torch.cuda.empty_cache()
        diffs = _tree_diffs(_checkpoint_tree(a), _checkpoint_tree(b))
        epochs_done = _checkpoint_tree(a)["epochs_done"]
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
        for path in (a, b):
            if os.path.exists(path + ".config.json"):
                os.remove(path + ".config.json")
    emit({"phase": "cli", "rcs": rcs, "seconds": seconds,
          "epoch_lines": {n: [l for l in out[n] if l.startswith("| epoch")]
                          for n in ("first", "resume", "uninterrupted")},
          "test_only": [l for l in out["test_only"] if l.startswith("node ")],
          "obs_report_head": out["obs_report"][:6], "resumed_epochs_done": epochs_done,
          "resumed_vs_uninterrupted_diffs": diffs})
    if any(rcs.values()):
        raise AssertionError(f"a CLI run failed: {rcs}")
    if diffs or epochs_done != 3:
        raise AssertionError(f"resumed run differs from the uninterrupted one at {diffs}")
    if len([l for l in out["test_only"] if l.startswith("node ")]) != 4:
        raise AssertionError(f"--testOnly printed {out['test_only']}")


# ---------------------------------------------------------------------- #
# Phases 27-30: the LM extras and the serving path                       #
# ---------------------------------------------------------------------- #
# The LM slice's model with the modern-LM options of the JAX package's
# TransformerLM: rotary positions, 2 KV heads, top-2 MoE over 4 experts
# (GShard capacity 1.25), residual dropout 0.1; moe_aux_coef the
# reference trainer's default.  306,423,808 parameters per agent.  The
# superstep phase trains it at B 1 per agent: at B 2 its captures need
# ~77 GB (state 19.6 GB, the warm-up's snapshot 9.8 GB, the gossip's spare
# set 4.9 GB, the training graph's pool 34.5 GB, the gossip warm-up's
# deviation temporaries) and ran out of the card's 79.2 GB.
EXTRAS_BATCH = 1
EXTRAS = dict(pos_emb="rope", num_kv_heads=2, mlp="moe", num_experts=4, moe_top_k=2,
              moe_capacity_factor=1.25)
EXTRAS_DROPOUT, EXTRAS_AUX_COEF, EXTRAS_PARAMS = 0.1, 0.01, 306_423_808
EXTRAS_PLAIN_LAYERS, REMAT_LAYERS = 2, 2
# lm_decode: benchmarks/bench_lm.py's full-scale decode (B 2, prefill 2048,
# 256 greedy steps), MHA and 2 KV heads; the short decode adds rope, MoE
# (drop-free; capacity 8 so the full forward drops nothing either) and a
# window of 4 over a prefill of 256, at 2 layers.
DECODE_BATCH, DECODE_PREFILL, DECODE_STEPS, DECODE_CHECK_STEPS = 2, 2048, 256, 32
SHORT_DECODE = dict(pos_emb="rope", num_kv_heads=2, mlp="moe", num_experts=4, moe_top_k=2,
                    moe_capacity_factor=8.0, attn_window=4)
SHORT_LAYERS, SHORT_PREFILL = 2, 256
# Decode logits against the full forward at the same positions, bf16: per
# step ||decode - full|| / ||full|| over the vocabulary.  The two paths
# round differently (the masked product over the cache against kernel A,
# GEMMs of 1 row against GEMMs of 2080): ~1e-2 expected.  A cache write one
# slot off hides each query's own key and value: in the short decode's
# window of 4 that is a quarter of what it attends to, O(1e-1) or more of
# the logits.  At prefill 2048 under random weights attention is near
# uniform, so the same fault moves the logits by ~1/2048: reported there,
# gated on the short decode.
DECODE_LOGITS_RTOL = 5e-2
# The same check on a float32 copy of the full-scale decode model (the
# same weights; its prefill runs kernel A's float32 body): the decode
# path and the full forward differ by float32 summation order only, so a
# correct cache sits near 1e-6 relative, and the shifted write (~3e-2 /
# ~1.5e-2 at prefill 2048 in bf16) far above this limit.
DECODE_F32_LOGITS_RTOL = 1e-3
# lm_extras_plain: a route the plain path's own choice would flip must be
# a near-tie: its two experts' router probabilities (the plain run's)
# within |p_own - p_tape| <= limit * max(p_own, p_tape).  A flip's gap
# follows the two runs' activation difference at the router (phase 4's
# gradients differ by ~1e-2 relative) times the size of the bf16 router
# logits, not bf16 rounding of the probabilities (2**-7).  On the card
# (H100 80GB HBM3, 700 W), of 196,608 routes at full width the plain run
# flips 1,058, 403 above 2**-7, the largest at 0.0823; a witness run with
# the plain attention in float32 (the bf16 inputs upcast, the output
# rounded to bf16 once, as the kernels round theirs) flips 693, 158 above
# 2**-7, 2 above 2**-5 (86 for the plain run), the largest at 0.0421.
# The bf16 attention scores make the tail above 2**-5; no run attributes
# the rest (the kernel's bf16 P and its summation order differ from both
# plain runs).  Each limit is the power of two above its run's reading
# (both readings repeat to the digit from run to run).  A wrong
# argmax or capacity queue on the kernel path flips confident routes (the
# control's swap reads 0.99) and fails both.
ROUTE_FLIP_RTOL = 2 ** -3
ROUTE_FLIP_F32_RTOL = 2 ** -4


def _extras_model_kwargs(dropout=EXTRAS_DROPOUT):
    return dict(EXTRAS, dropout_rate=dropout)


def _extras_trainer(layers=LAYERS, dropout=EXTRAS_DROPOUT, batch=BATCH, **trainer_kwargs):
    return make_trainer("flash", layers, AGENTS, EPOCHS, STEPS,
                        model_kwargs=_extras_model_kwargs(dropout), batch=batch,
                        moe_aux_coef=EXTRAS_AUX_COEF, **trainer_kwargs)


def _launches(fa) -> dict:
    return {k.name: k.launches for k in fa.KERNELS.values()}


def _moe_facts(master) -> dict:
    """On one training batch in eval mode (no dropout; the same routing
    and capacity drops as training): the trainer's loss, the plain cross
    entropy and the mean load-balance aux per agent, and each block's
    dropped fraction.  The trainer's loss is CE + coef * aux."""
    from distributed_learning_tpu_torch.models.moe import collect_load_balance_loss

    model = master.model
    idx = torch.as_tensor(master._epoch_perm(0)[0].astype(np.int64), device=DEVICE)
    x, y = master._Xs[master._agent, idx], master._ys[master._agent, idx]
    model.eval()
    with torch.no_grad():
        ce = master.loss_fn(model(x), y)
        aux = collect_load_balance_loss(model)
        dropped = [blk.moe.dropped_fraction.tolist() for blk in model.blocks]
        loss, _ = master._loss(x, y)
    gap = float((loss - ce - EXTRAS_AUX_COEF * aux).abs().max())
    return {"trainer_loss": loss.tolist(), "cross_entropy": ce.tolist(), "aux": aux.tolist(),
            "loss_minus_ce_minus_coef_aux_max_abs": gap, "dropped_fraction_by_block": dropped}


def phase_lm_extras(fa, dense):
    """The extras LM at the slice's width and depth, 4 agents on the ring,
    adam, B 1 (``EXTRAS_BATCH``), 3 steps an epoch, under deterministic
    algorithms: 3 eager
    ``train_epoch()`` calls (A, B, C and the pre-pass launched, counted),
    then a fresh trainer's ``train_epochs(3)`` as graph replays with obs
    on (cost profile, chunk timer), equal to the eager run bit for bit
    with 0 host syncs inside the superstep; then a second superstep,
    timed.  Tokens/s, MFU (the timer's, from ``cost_profile``) and peak
    memory beside the dense slice's numbers from this run (``dense``);
    the trainer's loss is CE + 0.01 aux, and each block's dropped
    fraction.  Returns the eager run's launch counts."""
    from distributed_learning_tpu_torch.obs import MetricsRegistry
    from distributed_learning_tpu_torch.obs import cost

    cost.clear_profiles()
    facts, records = {"memory_allocated_at_start_bytes": torch.cuda.memory_allocated()}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for run in ("eager", "graph"):
            kw = {} if run == "eager" else dict(obs=MetricsRegistry(), **OBS_ON)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                master = _extras_trainer(batch=EXTRAS_BATCH, **kw)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fa.reset_launch_counts()
                t0 = time.perf_counter()
                if run == "eager":
                    payloads = []
                    for _ in range(SUPERSTEP_K):
                        t1 = time.perf_counter()
                        payloads.append(master.train_epoch())
                        torch.cuda.synchronize()
                        facts["eager_epoch_s"] = time.perf_counter() - t1
                else:
                    payloads = master.train_epochs(SUPERSTEP_K)
                torch.cuda.synchronize()
                facts[f"{run}_first_s"] = time.perf_counter() - t0
                facts[f"{run}_launches"] = _launches(fa)
                facts[f"{run}_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
                records[run] = trainer_record(master, payloads)
                facts[f"{run}_losses"] = [p["train_loss"].tolist() for p in payloads]
                if run == "graph":
                    facts["host_syncs_per_superstep"] = list(master.superstep_host_syncs)
                    t0 = time.perf_counter()
                    master.train_epochs(SUPERSTEP_K)
                    torch.cuda.synchronize()
                    facts["superstep_s"] = time.perf_counter() - t0
                    facts["host_syncs_per_superstep"] += master.superstep_host_syncs[1:]
                    reg = master._obs_registry
                    facts["mfu"] = reg.gauges.get("cost.mfu/trainer.superstep")
                    facts["timer_step_time_s"] = reg.series.get(
                        "cost.step_time_s/trainer.superstep")
                    prof = cost.get_profile(f"trainer.superstep{SUPERSTEP_K}")
                    facts["profile_flops_per_step"] = prof.flops
                    facts["peak_memory_bytes_with_graphs"] = torch.cuda.max_memory_allocated()
                    facts["moe"] = _moe_facts(master)
                    facts["params_per_agent"] = master.model.param_count()
            del master
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = max_diffs(records["graph"], records["eager"])
    del records
    tokens = AGENTS * EXTRAS_BATCH * SEQ * STEPS
    n_eval = 2  # make_trainer's 4 test sequences, eval batch 2
    per = LAYERS * STEPS * SUPERSTEP_K
    expect = {"flash_fwd": per + LAYERS * n_eval * SUPERSTEP_K, "flash_bwd_dq": per,
              "flash_bwd_dkv": per, "flash_bwd_rowterm": per}
    facts.update(
        graph_vs_eager_max_abs=diff, bitwise_graph_vs_eager=not any(diff.values()),
        expected_eager_launches=expect,
        eager_tokens_per_s=tokens / facts["eager_epoch_s"],
        superstep_tokens_per_s=tokens * SUPERSTEP_K / facts["superstep_s"],
        dense=dense)
    emit({"phase": "lm_extras", "agents": AGENTS, "layers": LAYERS, "batch_per_agent": EXTRAS_BATCH,
          "seq": SEQ, "options": _extras_model_kwargs(), "moe_aux_coef": EXTRAS_AUX_COEF,
          **facts})
    if facts["params_per_agent"] != EXTRAS_PARAMS:
        raise AssertionError(f"extras LM has {facts['params_per_agent']} params per agent")
    if not facts["bitwise_graph_vs_eager"]:
        raise AssertionError(f"extras LM superstep differs from the eager epochs: {diff}")
    if any(n != 0 for n in facts["host_syncs_per_superstep"]):
        raise AssertionError(
            f"extras LM superstep synchronised: {facts['host_syncs_per_superstep']}")
    if facts["eager_launches"] != expect:
        raise AssertionError(f"extras LM launches {facts['eager_launches']} != {expect}")
    if not facts["moe"]["loss_minus_ce_minus_coef_aux_max_abs"] <= 1e-5:
        raise AssertionError(f"the trainer's loss is not CE + coef * aux: {facts['moe']}")
    if facts["mfu"] is None:
        raise AssertionError("the extras LM's timer recorded no MFU")
    return facts["eager_launches"]


def route_flip_gaps(probs, own, taped) -> torch.Tensor:
    """For every route where ``own`` (k of (N, S) expert choices) differs
    from ``taped``, the relative gap of the two experts' probabilities in
    ``probs`` (N, S, E): ``|p_own - p_tape| / max(p_own, p_tape)``."""
    gaps, probs = [], probs.detach()
    for a, b in zip(own, taped):
        flip = a != b
        pa = probs.gather(-1, a[..., None]).squeeze(-1)[flip]
        pb = probs.gather(-1, b[..., None]).squeeze(-1)[flip]
        gaps.append((pa - pb).abs() / torch.maximum(pa, pb))
    return torch.cat(gaps)


class RouteTape:
    """The MoE blocks' expert choices of the kernel run, handed to the
    other runs of :func:`kernel_vs_plain`.  Routing is a discrete function
    of bf16 activations: the plain path's rounding flips near-tied routes
    and capacity queues, which moves the gradients by more than the
    kernels do (measured: up to 0.19 relative on a gate).  With the
    kernel run's routes replayed, both paths compute one continuous
    function.  The gaps of every route a plain run (``full``, ``witness``)
    would have flipped are kept per run (:func:`route_flip_gaps`); the
    first block's probabilities and own choices of the ``full`` run are
    kept for the swapped-route control."""

    def __init__(self):
        self.routes, self.pos, self.sample = [], 0, None
        self.total, self.gaps = {}, {}

    def around(self, run):
        from distributed_learning_tpu_torch.models.moe import MoEMLP

        real = MoEMLP._choose
        tape = self

        def choose(module, probs):
            if run == "flash":
                choices = real(module, probs)
                tape.routes.append(choices)
                return choices
            choices = tape.routes[tape.pos % len(tape.routes)]
            tape.pos += 1
            if run in ("full", "witness"):
                own = real(module, probs)
                tape.total[run] = tape.total.get(run, 0) + sum(c.numel() for c in choices)
                tape.gaps.setdefault(run, []).append(route_flip_gaps(probs, own, choices).cpu())
                if run == "full" and tape.sample is None:
                    tape.sample = (probs.detach().clone(), [c.clone() for c in own])
            return choices

        return _patched(MoEMLP, "_choose", choose)

    def flip_facts(self, run, limit) -> dict:
        gaps = torch.cat(self.gaps[run])
        return {"routes_replayed": self.total[run], "flips": int(gaps.numel()),
                "flip_share": gaps.numel() / max(self.total[run], 1), "limit": limit,
                "max_gap": float(gaps.max()) if gaps.numel() else 0.0,
                "over_2**-e": {e: int((gaps > 2.0 ** -e).sum()) for e in (4, 5, 6, 7, 8)},
                "over_limit": int((gaps > limit).sum())}

    def swapped_route_control(self) -> float:
        """The bound's control: the plain run's own choices for the first
        block with one confident route (the largest first-choice
        probability) swapped to that token's least likely expert.  Returns
        the largest gap the bound sees, which must exceed the limit."""
        probs, own = self.sample
        taped = [c.clone() for c in own]
        first = probs.gather(-1, own[0][..., None]).squeeze(-1)
        i = int(first.argmax())
        taped[0].view(-1)[i] = probs.argmin(-1).view(-1)[i]
        return float(route_flip_gaps(probs, own, taped).max())


def _f32_attention():
    """The plain path's attention in float32: the bf16 inputs upcast and
    the output rounded to their dtype once."""
    from distributed_learning_tpu_torch.models import transformer
    from distributed_learning_tpu_torch.ops.ring_attention import attention_reference

    def f32(q, k, v, **kw):
        return attention_reference(q.float(), k.float(), v.float(), **kw).to(v.dtype)

    return _patched(transformer, "attention_reference", f32)


def phase_lm_extras_plain(fa):
    """The extras LM at 2 layers, 2 agents, dropout off: one step through
    the kernels and through plain attention from identical weights under
    the plain phase's limits, the MoE routes of the kernel run replayed
    in the others (:class:`RouteTape`); the control applies rope to Q
    only.  The plain run's route flips are held to ``ROUTE_FLIP_RTOL``,
    and a witness run with the plain attention in float32 to
    ``ROUTE_FLIP_F32_RTOL``."""
    from distributed_learning_tpu_torch.models import transformer

    def q_only(self, q, k, positions):
        return transformer._rope(q, positions), k

    tape = RouteTape()
    facts = kernel_vs_plain(2, EXTRAS_PLAIN_LAYERS,
                            lambda: _patched(transformer._Attention, "_rotate", q_only),
                            model_kwargs=_extras_model_kwargs(0.0), around=tape.around,
                            witness=_f32_attention, moe_aux_coef=EXTRAS_AUX_COEF)
    flips = {"full": tape.flip_facts("full", ROUTE_FLIP_RTOL),
             "witness_f32_attention": tape.flip_facts("witness", ROUTE_FLIP_F32_RTOL)}
    control_gap = tape.swapped_route_control()
    emit({"phase": "lm_extras_plain", "options": _extras_model_kwargs(0.0),
          "route_flips": flips, "control_swapped_route_gap": control_gap, **facts})
    if not facts["ok"]:
        raise AssertionError("extras kernel path and plain path disagree, or the rope "
                             "control was not rejected")
    for run, f in flips.items():
        if f["over_limit"]:
            raise AssertionError(f"{run}: {f['over_limit']} MoE route flips are not "
                                 f"near-ties (largest gap {f['max_gap']} > {f['limit']})")
    if not control_gap > ROUTE_FLIP_RTOL:
        raise AssertionError("a swapped confident route passed the route flip bound")


def phase_lm_remat(fa):
    """The extras LM at 2 layers with dropout on, 4 agents, under
    deterministic algorithms: one eager epoch of 3 steps with ``remat``
    off and on, and on as a graph replay (``train_epochs(1)``): parameters,
    optimizer state and traces bit for bit, flash launches equal; then
    3 more steps each, timed by CUDA events, with peak memory.  Returns
    the remat run's launch counts."""
    facts, records = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for run in ("off", "on", "on_graph"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                master = _extras_trainer(REMAT_LAYERS, remat=run != "off")
                fa.reset_launch_counts()
                payloads = (master.train_epochs(1) if run == "on_graph"
                            else [master.train_epoch()])
                torch.cuda.synchronize()
                facts[f"{run}_launches"] = _launches(fa)
                records[run] = trainer_record(master, payloads)
                if run != "on_graph":
                    idx = master._indices(1, 1)[0]
                    trace = torch.empty(STEPS, 3, AGENTS, device=DEVICE)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    master._run_steps(idx, None, trace)
                    end.record()
                    end.synchronize()
                    facts[f"{run}_step_ms"] = start.elapsed_time(end) / STEPS
                    facts[f"{run}_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            del master
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    diffs = {run: max_diffs(records[run], records["off"]) for run in ("on", "on_graph")}
    facts.update({f"{run}_vs_off_max_abs": d for run, d in diffs.items()},
                 bitwise={run: not any(d.values()) for run, d in diffs.items()},
                 memory_saved_bytes=facts["off_peak_memory_bytes"] - facts["on_peak_memory_bytes"])
    emit({"phase": "lm_remat", "layers": REMAT_LAYERS, "agents": AGENTS,
          "options": _extras_model_kwargs(), **facts})
    if not all(facts["bitwise"].values()):
        raise AssertionError(f"remat changed the run: {diffs}")
    if not facts["on_launches"] == facts["off_launches"] == facts["on_graph_launches"]:
        raise AssertionError("remat changed the flash launch counts")
    return facts["on_launches"]


def _decode_model(layers, num_kv_heads=None, max_len=DECODE_PREFILL + DECODE_STEPS,
                  dtype=torch.bfloat16, heads=HEADS, head_dim=HEAD_DIM, **kw):
    from distributed_learning_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=VOCAB, num_layers=layers, num_heads=heads,
                         head_dim=head_dim, max_len=max_len, attn_impl="flash",
                         dtype=dtype, num_kv_heads=num_kv_heads, n_agents=1,
                         device=DEVICE, seed=3, **kw)


def _write_one_slot_off(ck, cv, k, v, i):
    """The decode control: every cache write lands one slot later."""
    L, T = ck.shape[1], k.shape[1]
    slots = (i + 1 + torch.arange(T, device=k.device)).clamp(max=L - 1)
    ck.index_copy_(1, slots, k.to(ck.dtype))
    cv.index_copy_(1, slots, v.to(cv.dtype))


def decode_vs_full(model, prompt, steps, control=False) -> dict:
    """Greedy decode of ``steps`` tokens after ``prompt`` (1, B, Tp),
    keeping the prefill's and every step's logits (``control``: every
    cache write one slot off), then a full forward over the prompt and
    the decoded tokens at the same positions: the largest per-position
    relative logits error, and whether the greedy tokens equal the full
    forward's argmax wherever its top-2 margin exceeds twice that
    position's largest logit error."""
    from distributed_learning_tpu_torch.models import transformer

    Tp = prompt.shape[-1]
    cache = model.init_cache(prompt.shape[1])
    fault = (_patched(transformer._Attention, "_write_cache", staticmethod(_write_one_slot_off))
             if control else contextlib.nullcontext())
    with torch.no_grad(), fault:
        logits = [model(prompt, cache)[:, :, -1]]
        toks = []
        for _ in range(steps):
            toks.append(logits[-1].argmax(-1))
            logits.append(model(toks[-1][..., None], cache)[:, :, -1])
    with torch.no_grad():
        dec = torch.stack(logits, dim=2)                       # positions Tp-1 .. Tp+steps-1
        seq = torch.cat([prompt, torch.stack(toks, dim=-1)], dim=-1)
        full = model(seq)[:, :, Tp - 1:]
    err = (dec - full).norm(dim=-1) / full.norm(dim=-1)
    top2 = full.topk(2, dim=-1).values
    worst = (dec - full).abs().amax(dim=-1)
    sure = (top2[..., 0] - top2[..., 1]) > 2 * worst
    agree = (dec.argmax(-1) == full.argmax(-1)) | ~sure
    return {"max_rel_err": float(err.max()), "max_abs_err": float(worst.max()),
            "tokens_checked": int(sure.sum()), "tokens_agree": bool(agree.all())}


def decode_step_profile(model, prompt, steps=32) -> dict:
    """``steps`` greedy decode steps after a prefill outside the window,
    under ``torch.profiler``: the window's wall ms a step and the device
    ms a step that its kernel rows sum to, and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(prompt.shape[1])
    with torch.no_grad():
        tok = model(prompt, cache)[:, :, -1].argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = model(tok[..., None], cache)[:, :, -1].argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    dev_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or "#" in ev.key:
            continue
        us = getattr(ev, "self_device_time_total", None)
        dev_us += ev.self_cuda_time_total if us is None else us
    return {"wall_ms_per_step": wall * 1e3 / steps, "device_ms_per_step": dev_us / 1e3 / steps,
            "device_idle_share": max(0.0, 1 - dev_us / 1e3 / (wall * 1e3))}


DECODE_CASES = (("mha", None), ("gqa", 2))
DECODE_WARMUP_STEPS = 8


def _decode_prompt():
    rng = np.random.default_rng(31)
    return torch.as_tensor(rng.integers(0, VOCAB, (1, DECODE_BATCH, DECODE_PREFILL)),
                           device=DEVICE)


def time_decode(fa, model, prompt, steps=DECODE_STEPS):
    """``generate``'s times by the prefill-subtracted protocol
    (``bench_lm.py:112``): after a warm-up, the prefill alone (one token)
    and the whole of ``steps`` steps (none when ``steps`` is 0).  Returns
    (prefill seconds, generate seconds or None, the prefill's launch
    counts).  The warm-up's decode runs ``DECODE_WARMUP_STEPS`` of the
    same one-token steps."""
    from distributed_learning_tpu_torch.models.transformer import generate

    for n in (1, DECODE_WARMUP_STEPS):
        generate(model, prompt, n)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    generate(model, prompt, 1)
    torch.cuda.synchronize()
    dt_prefill = time.perf_counter() - t0
    launches = _launches(fa)
    if not steps:
        return dt_prefill, None, launches
    t0 = time.perf_counter()
    generate(model, prompt, steps)
    torch.cuda.synchronize()
    return dt_prefill, time.perf_counter() - t0, launches


def decode_timing(fa, repeats):
    """``--decode-timing``: the serving path's decode tokens/s alone, MHA
    and GQA, ``repeats`` times each, as phase 30 times them (a fresh
    model a repeat); no check and no other phase."""
    prompt = _decode_prompt()
    for r in range(repeats):
        for label, hkv in DECODE_CASES:
            model = _decode_model(LAYERS, hkv)
            dt_prefill, dt, _ = time_decode(fa, model, prompt)
            emit({"phase": "decode_timing", "repeat": r, "case": label,
                  "tokens_per_s": DECODE_BATCH * (DECODE_STEPS - 1) / (dt - dt_prefill),
                  "prefill_s": dt_prefill, "generate_s": dt})
            del model
            torch.cuda.empty_cache()


def step_timing(repeats):
    """``--step-timing``: the dense LM slice's training step (adam,
    ``make_trainer``'s full width) alone, ``repeats`` times on a fresh
    trainer each, by ``superstep_timing`` (eager epochs, then supersteps
    as graph replays); no check and no other phase.  For parent against
    change, run this script in both trees in one call, A B B A."""
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    opt = make_optimizer("adam", {"lr": 1e-3})(torch.zeros(1, device=DEVICE))
    make = lambda: make_trainer("flash", LAYERS, AGENTS, EPOCHS, STEPS)  # noqa: E731
    for r in range(repeats):
        t = superstep_timing(make, AGENTS * BATCH * SEQ * STEPS, "tokens")
        emit({"phase": "step_timing", "repeat": r,
              "optimizer": f"{type(opt).__module__}.{type(opt).__name__}",
              "eager_step_ms": t["steady_eager_epoch_s"] / STEPS * 1e3,
              "superstep_step_ms": t["steady_superstep_epoch_s"] / STEPS * 1e3,
              "superstep_tokens_per_s": t["superstep_tokens_per_s"],
              "superstep_device_ms_by_events": t["superstep_device_ms_by_events"]})


def phase_lm_decode(fa):
    """The serving path: ``generate`` at bench_lm's full-scale decode
    (B 2, prefill 2048, 256 greedy steps; MHA and 2 KV heads) through the
    flash prefill and the masked product over the KV cache.  Tokens/s by
    the prefill-subtracted protocol of ``_time_decode``, ms a step, the
    cache's bytes, kernel A's launches in the prefill (one a layer, no
    backward kernel), the per-step byte bound; the logits of the first 32
    steps against a full forward (DECODE_LOGITS_RTOL), the greedy tokens
    against its argmax; then the short rope + GQA + MoE + window decode
    the same way, with a cache write one slot off as the control.
    Returns the prefill's launch counts, both models together."""
    from distributed_learning_tpu_torch.models.transformer import generate
    from distributed_learning_tpu_torch.training.graphs import count_host_syncs

    prompt = _decode_prompt()
    prefill_launches = dict.fromkeys(fa.KERNELS, 0)
    cases = {}
    for label, hkv in DECODE_CASES:
        model = _decode_model(LAYERS, hkv)
        cache_bytes = model.init_cache(DECODE_BATCH).nbytes()
        dt_prefill, dt, launches = time_decode(fa, model, prompt)
        for name, n in launches.items():
            prefill_launches[name] += n
        decode_s = dt - dt_prefill
        with count_host_syncs(torch.device(DEVICE)) as syncs:
            out = generate(model, prompt, 8)
        out.cpu()
        # The step's least bytes: every float32 weight the step multiplies
        # by (blocks and head; the embedding is a gather of B rows) read
        # once, and the whole cache read once.
        weights = sum(p[0].numel() for name, p in model.stacked_parameters().items()
                      if name != "embed" and not name.endswith(("scale", "bias")))
        bound_ms = (weights * 4 + cache_bytes) / PEAK_HBM_BYTES * 1e3
        profiled = decode_step_profile(model, prompt)
        check = decode_vs_full(model, prompt, DECODE_CHECK_STEPS)
        shifted = decode_vs_full(model, prompt, DECODE_CHECK_STEPS, control=True)
        # The float32 copy: the same weights, computed in float32.
        f32 = _decode_model(LAYERS, hkv, dtype=torch.float32)
        with torch.no_grad():
            f32.flat_params.copy_(model.flat_params)
        fa.reset_launch_counts()
        f32_check = decode_vs_full(f32, prompt, DECODE_CHECK_STEPS)
        f32_bodies = dict(fa.KERNELS["flash_fwd"].by_body)
        f32_shifted = decode_vs_full(f32, prompt, DECODE_CHECK_STEPS, control=True)
        del f32
        cases[label] = {
            "num_kv_heads": hkv or HEADS, "kv_cache_bytes": cache_bytes,
            "prefill_s": dt_prefill, "generate_s": dt,
            "tokens_per_s": DECODE_BATCH * (DECODE_STEPS - 1) / decode_s,
            "ms_per_step": decode_s / (DECODE_STEPS - 1) * 1e3,
            "bound_ms_per_step": bound_ms,
            "bound_tokens_per_s": DECODE_BATCH / (bound_ms / 1e3),
            "host_syncs_in_generate_8": syncs[0], "profiled_steps": profiled,
            "prefill_launches": launches, "check": check, "shifted_write": shifted,
            "f32_check": f32_check, "f32_flash_fwd_by_body": f32_bodies,
            "f32_control_shifted_write": f32_shifted}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    short = _decode_model(SHORT_LAYERS, max_len=SHORT_PREFILL + DECODE_CHECK_STEPS + 1,
                          **SHORT_DECODE)
    sp = prompt[..., :SHORT_PREFILL]
    cases["short"] = {"options": SHORT_DECODE, "layers": SHORT_LAYERS, "prefill": SHORT_PREFILL,
                      "check": decode_vs_full(short, sp, DECODE_CHECK_STEPS),
                      "control_shifted_write": decode_vs_full(short, sp, DECODE_CHECK_STEPS,
                                                              control=True)}
    del short
    torch.cuda.empty_cache()
    emit({"phase": "lm_decode", "batch": DECODE_BATCH, "prefill": DECODE_PREFILL,
          "steps": DECODE_STEPS, "layers": LAYERS, "logits_rtol": DECODE_LOGITS_RTOL,
          "f32_logits_rtol": DECODE_F32_LOGITS_RTOL, **cases})
    for label in ("mha", "gqa", "short"):
        c = cases[label]["check"]
        if not (c["max_rel_err"] <= DECODE_LOGITS_RTOL and c["tokens_agree"]):
            raise AssertionError(f"{label} decode disagrees with the full forward: {c}")
    if cases["short"]["control_shifted_write"]["max_rel_err"] <= DECODE_LOGITS_RTOL:
        raise AssertionError("a cache write one slot off passed the logits check")
    for label in ("mha", "gqa"):
        c = cases[label]["f32_check"]
        if not (c["max_rel_err"] <= DECODE_F32_LOGITS_RTOL and c["tokens_agree"]):
            raise AssertionError(f"{label} float32 decode disagrees with its full forward: {c}")
        if cases[label]["f32_control_shifted_write"]["max_rel_err"] <= DECODE_F32_LOGITS_RTOL:
            raise AssertionError(f"{label}: a cache write one slot off passed the float32 "
                                 "logits check at full scale")
        if not cases[label]["f32_flash_fwd_by_body"]["cuda_core"]:
            raise AssertionError(f"{label}: the float32 prefill did not run kernel A's "
                                 "float32 body")
    for label in ("mha", "gqa"):
        if cases[label]["host_syncs_in_generate_8"]:
            raise AssertionError(f"{label} generate synchronised: {cases[label]}")
        got = cases[label]["prefill_launches"]
        if got != {"flash_fwd": LAYERS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                   "flash_bwd_rowterm": 0}:
            raise AssertionError(f"{label} prefill launches {got}: want kernel A once a layer")
    return prefill_launches


# ---------------------------------------------------------------------- #
# Phase 31: a head dim the kernels run zero-padded                       #
# ---------------------------------------------------------------------- #
# benchmarks/bench_lm.py's small config (its non-full-scale branch).
SMALL_LM = {"vocab": 64, "heads": 2, "head_dim": 16, "seq": 128}
SMALL_LM_LAYERS, SMALL_LM_AGENTS, SMALL_LM_EPOCHS = 2, 2, 4
# Losses of 4 epochs (one adam step and one gossip round each) through the
# kernels against plain attention from the same weights: step one is held
# to LOSS_RTOL by kernel_vs_plain; after it the two runs' bf16 rounding
# differences move the weights apart by ~lr x a few bf16 ulps a step, which
# moves a loss of ~4.2 by under 1e-3 relative.
SMALL_LM_LOSS_RTOL = 1e-3


def phase_lm_head_dims(fa):
    """``TransformerLM(attn_impl="flash", head_dim=16)`` at bench_lm's small
    config on the card: one step against plain attention (phase 4's limits
    and control), then 4 epochs trained both ways.  Returns the kernel
    run's launch counts."""
    facts = kernel_vs_plain(SMALL_LM_AGENTS, SMALL_LM_LAYERS,
                            lambda: _patched(fa, "flash_bwd_dkv", _drop_first_key_tile(fa)),
                            dims=SMALL_LM)
    losses, launches, bodies = {}, None, None
    for impl in ("flash", "full"):
        master = make_trainer(impl, SMALL_LM_LAYERS, SMALL_LM_AGENTS, SMALL_LM_EPOCHS, 1,
                              dims=SMALL_LM)
        if impl == "flash":
            weights = {k: v.detach().clone() for k, v in master.model.stacked_parameters().items()}
            fa.reset_launch_counts()
        else:
            with torch.no_grad():
                for k, v in master.model.stacked_parameters().items():
                    v.copy_(weights[k])
        losses[impl] = np.asarray([master.train_epoch()["train_loss"].tolist()
                                   for _ in range(SMALL_LM_EPOCHS)])
        torch.cuda.synchronize()
        if impl == "flash":
            launches = _launches(fa)
            bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
        del master
    gc.collect()
    torch.cuda.empty_cache()
    rel = np.abs(losses["flash"] - losses["full"]) / np.abs(losses["full"])
    trained = {"losses_flash": losses["flash"].tolist(), "losses_full": losses["full"].tolist(),
               "loss_rel_err": float(rel.max()), "limit": SMALL_LM_LOSS_RTOL,
               "loss_falls": bool((losses["flash"][-1] < losses["flash"][0]).all()),
               "launches": launches, "by_body": bodies}
    emit({"phase": "lm_head_dims", "config": SMALL_LM, "layers": SMALL_LM_LAYERS,
          "kernel_head_dim": fa.kernel_head_dim(SMALL_LM["head_dim"]), "one_step": facts,
          "trained": trained})
    if not facts["ok"]:
        raise AssertionError("head dim 16: kernel path and plain path disagree, or the "
                             "control was not rejected")
    if not (trained["loss_rel_err"] <= SMALL_LM_LOSS_RTOL and trained["loss_falls"]):
        raise AssertionError(f"head dim 16 training disagrees with plain attention: {trained}")
    per = SMALL_LM_LAYERS * SMALL_LM_EPOCHS
    if not (launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == per
            and bodies["flash_bwd_dq"]["wgmma"] == bodies["flash_bwd_dkv"]["wgmma"] == per
            and launches["flash_bwd_rowterm"] == per
            and bodies["flash_fwd"]["wgmma"] >= per and not bodies["flash_fwd"]["cuda_core"]):
        raise AssertionError(f"head dim 16 launches {launches} {bodies}: want the wgmma forward, "
                             "dQ and dK/dV and the pre-pass once a layer and step")
    return launches


def lm_epoch(fa, dims, rowterm) -> dict:
    """One eager epoch of the full slice (8 layers, 4 agents on a ring, B
    2, 3 steps and a round) with ``dims`` in place of the slice's widths:
    seconds, tokens/s, peak memory, launches by kernel and body, and the
    launches it should make (the pre-pass once a layer backward when
    ``rowterm``)."""
    master = make_trainer("flash", LAYERS, AGENTS, 1, STEPS, dims=dims)
    n_eval = math.ceil(len(master.test_data[0]) / master.eval_batch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    p = master.train_epoch()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    epoch = {"train_loss": p["train_loss"].tolist(), "epoch_seconds": dt,
             "train_tokens_per_s_incl_eval_and_mix": AGENTS * BATCH * SEQ * STEPS / dt,
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "params_per_agent": master.model.param_count(), "launches": _launches(fa),
             "by_body": {k.name: dict(k.by_body) for k in fa.KERNELS.values()},
             "expected_launches": {"flash_fwd": LAYERS * (STEPS + n_eval),
                                   "flash_bwd_dq": LAYERS * STEPS,
                                   "flash_bwd_dkv": LAYERS * STEPS,
                                   "flash_bwd_rowterm": LAYERS * STEPS if rowterm else 0}}
    del master
    gc.collect()
    torch.cuda.empty_cache()
    return epoch


# ---------------------------------------------------------------------- #
# Phase 31, continued: the LM at head dim 256                            #
# ---------------------------------------------------------------------- #
# The slice's LM with its model width (d_model 1024) as 4 heads of 256.
D256_LM = {"heads": D256_HEADS, "head_dim": D256_HEAD_DIM}


def phase_lm_head_dim_256(fa):
    """``TransformerLM(attn_impl="flash", num_heads=4, head_dim=256)`` at
    the slice's configuration otherwise: one step of 2 agents x 2 layers
    against plain attention (phase 4's limits and control), then one
    eager epoch of the full slice (8 layers, 4 agents on a ring, B 2, 3
    steps and a round), where the forward, dQ and dK/dV run their wgmma
    bodies, the backward with the pre-pass.  Returns the epoch's launch
    counts."""
    facts = kernel_vs_plain(2, 2, lambda: _patched(fa, "flash_bwd_dkv", _drop_first_key_tile(fa)),
                            dims=D256_LM)
    epoch = lm_epoch(fa, D256_LM, rowterm=True)
    launches, bodies, expect = epoch["launches"], epoch["by_body"], epoch["expected_launches"]
    emit({"phase": "lm_head_dim_256", "config": {"vocab": VOCAB, "seq": SEQ, **D256_LM},
          "agents": AGENTS, "layers": LAYERS, "batch_per_agent": BATCH, "steps": STEPS,
          "one_step": facts, "epoch": epoch})
    if not facts["ok"]:
        raise AssertionError("head dim 256: kernel path and plain path disagree, or the "
                             "control was not rejected")
    if not all(math.isfinite(x) for x in epoch["train_loss"]):
        raise AssertionError(f"head dim 256 epoch loss not finite: {epoch['train_loss']}")
    fwd, dq, dkv = (bodies[n] for n in fa._KERNEL_NAMES)
    if not (launches == expect and fwd["wgmma"] == expect["flash_fwd"]
            and dq["wgmma"] == dkv["wgmma"] == LAYERS * STEPS):
        raise AssertionError(f"head dim 256 launches {launches} {bodies}: want {expect}, the "
                             "forward, dQ and dK/dV on wgmma")
    return launches


# ---------------------------------------------------------------------- #
# Phase 31, continued: the LM at head dim 32                             #
# ---------------------------------------------------------------------- #
# The slice's LM with its model width (d_model 1024) as 32 heads of 32, the
# head dim that the reference's default (16) and the examples' (8) run at.
D32_LM = {"heads": D32_HEADS, "head_dim": 32}
# Its step against plain attention runs at T 2048: the plain path's float32
# scores of one agent, (B 2, 32, T, T), are 4.3 GB at T 4096 and it holds
# several a layer; at T 2048 one is 1.1 GB.
D32_PLAIN_SEQ = 2048


def phase_lm_head_dim_32(fa, times_d32):
    """``TransformerLM(attn_impl="flash", num_heads=32, head_dim=32)`` at
    the slice's configuration otherwise.  (1) Serving: ``generate`` at
    lm_decode's configuration (B 2, prefill 2048, MHA): the prefill's
    seconds by the prefill-subtracted protocol (no timed steps), its
    tokens/s and launches (kernel A once a layer, on wgmma), kernel A's
    own ms at the prefill's shape; the logits of the prefill and
    ``DECODE_CHECK_STEPS`` steps against a full forward over the 2,080
    positions (a ragged T), the greedy tokens against its argmax.  (2)
    One step of 2 agents x 2 layers at T ``D32_PLAIN_SEQ`` against plain
    attention (phase 4's limits and control).  (3) One eager epoch of the
    full slice (8 layers, 4 agents on a ring, B 2, 3 steps and a round):
    tokens/s, peak memory, launches by body (the forward, dQ and dK/dV on
    wgmma, the pre-pass once a layer backward) and the epoch split by
    kernel time (launches x ``times_d32``'s ms).  Returns the epoch's and the
    prefill's launch counts."""
    prompt = _decode_prompt()
    model = _decode_model(LAYERS, heads=D32_HEADS, head_dim=32)
    dt_prefill, _, prefill_launches = time_decode(fa, model, prompt, steps=0)
    prefill_bodies = dict(fa.KERNELS["flash_fwd"].by_body)
    fa.reset_launch_counts()
    check = decode_vs_full(model, prompt, DECODE_CHECK_STEPS)
    check_bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    del model
    q, k, v, _ = _qkv(DECODE_BATCH, DECODE_PREFILL, D32_HEADS, 32, torch.bfloat16, seed=5)
    a_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, 32 ** -0.5, True, None, with_lse=True), 10)
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    serving = {"batch": DECODE_BATCH, "prefill": DECODE_PREFILL, "prefill_s": dt_prefill,
               "prefill_tokens_per_s": DECODE_BATCH * DECODE_PREFILL / dt_prefill,
               "prefill_launches": prefill_launches, "prefill_flash_fwd_by_body": prefill_bodies,
               "kernel_a_ms_at_prefill_shape": a_ms, "kernel_a_ms_per_prefill": LAYERS * a_ms,
               "logits_rtol": DECODE_LOGITS_RTOL, "check": check,
               "check_launches_by_body": check_bodies}

    facts = kernel_vs_plain(2, 2, lambda: _patched(fa, "flash_bwd_dkv", _drop_first_key_tile(fa)),
                            dims={**D32_LM, "seq": D32_PLAIN_SEQ})

    epoch = lm_epoch(fa, D32_LM, rowterm=True)
    launches, bodies, expect = epoch["launches"], epoch["by_body"], epoch["expected_launches"]
    split = {name: launches[name] * times_d32[name]["ms"] for name in fa.KERNELS}
    split["rest"] = epoch["epoch_seconds"] * 1e3 - sum(split.values())
    epoch["split_ms_by_kernel_time"] = split
    emit({"phase": "lm_head_dim_32", "config": {"vocab": VOCAB, "seq": SEQ, **D32_LM},
          "agents": AGENTS, "layers": LAYERS, "batch_per_agent": BATCH, "steps": STEPS,
          "serving": serving, "one_step_seq": D32_PLAIN_SEQ, "one_step": facts, "epoch": epoch})
    if not (check["max_rel_err"] <= DECODE_LOGITS_RTOL and check["tokens_agree"]):
        raise AssertionError(f"head dim 32 decode disagrees with the full forward: {check}")
    want_prefill = {"flash_fwd": LAYERS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                    "flash_bwd_rowterm": 0}
    if prefill_launches != want_prefill or prefill_bodies["wgmma"] != LAYERS:
        raise AssertionError(f"head dim 32 prefill launches {prefill_launches} "
                             f"{prefill_bodies}: want kernel A on wgmma once a layer")
    fwd_check = check_bodies["flash_fwd"]
    if not (fwd_check["wgmma"] >= 2 * LAYERS and fwd_check["cuda_core"] == 0):
        raise AssertionError(f"head dim 32 decode check launched {check_bodies}: want every "
                             "forward on wgmma")
    if not facts["ok"]:
        raise AssertionError("head dim 32: kernel path and plain path disagree, or the "
                             "control was not rejected")
    if not all(math.isfinite(x) for x in epoch["train_loss"]):
        raise AssertionError(f"head dim 32 epoch loss not finite: {epoch['train_loss']}")
    fwd, dq, dkv = (bodies[n] for n in fa._KERNEL_NAMES)
    if not (launches == expect and fwd["wgmma"] == expect["flash_fwd"]
            and dq["wgmma"] == dkv["wgmma"] == LAYERS * STEPS):
        raise AssertionError(f"head dim 32 launches {launches} {bodies}: want {expect}, the "
                             "forward, dQ and dK/dV on wgmma, the pre-pass once a layer backward")
    return launches, prefill_launches


# ---------------------------------------------------------------------- #
# Phase 31, continued: the LM at head dim 512                            #
# ---------------------------------------------------------------------- #
# The slice's LM with its model width (d_model 1024) as 2 heads of 512, the
# width at which the wide bodies are held and timed (phase 2, times_wide).
# Its step against plain attention runs at the full T: the plain path's
# float32 scores of one agent, (B 2, 2, 4096, 4096), are 268 MB.
D512_LM = {"heads": WIDE_HEADS, "head_dim": WIDE_HEAD_DIM}


def phase_lm_head_dim_512(fa, times_wide):
    """``TransformerLM(attn_impl="flash", num_heads=2, head_dim=512)`` at
    the slice's configuration otherwise.  (1) Serving: ``generate`` at
    lm_decode's configuration (B 2, prefill 2048, MHA): the prefill's
    seconds by the prefill-subtracted protocol (no timed steps), its
    tokens/s and launches (kernel A once a layer, on its wide wgmma body),
    kernel A's own ms at the prefill's shape; the logits of the prefill
    and ``DECODE_CHECK_STEPS`` steps against a full forward over the 2,080
    positions (a ragged T), the greedy tokens against its argmax.  (2) One
    step of 2 agents x 2 layers at T 4096 against plain attention (phase
    4's limits and control).  (3) One eager epoch of the full slice (8
    layers, 4 agents on a ring, B 2, 3 steps and a round): tokens/s, peak
    memory, launches by body (the forward on wgmma, dQ and dK/dV on the
    wide CUDA-core bodies, the pre-pass once a layer backward) and the
    epoch split by kernel time (launches x ``times_wide``'s ms).  Returns
    the epoch's and the prefill's launch counts."""
    prompt = _decode_prompt()
    model = _decode_model(LAYERS, heads=WIDE_HEADS, head_dim=WIDE_HEAD_DIM)
    dt_prefill, _, prefill_launches = time_decode(fa, model, prompt, steps=0)
    prefill_bodies = dict(fa.KERNELS["flash_fwd"].by_body)
    fa.reset_launch_counts()
    check = decode_vs_full(model, prompt, DECODE_CHECK_STEPS)
    check_bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    del model
    q, k, v, _ = _qkv(DECODE_BATCH, DECODE_PREFILL, WIDE_HEADS, WIDE_HEAD_DIM, torch.bfloat16,
                      seed=5)
    a_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, WIDE_HEAD_DIM ** -0.5, True, None,
                                        with_lse=True), 10)
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    serving = {"batch": DECODE_BATCH, "prefill": DECODE_PREFILL, "prefill_s": dt_prefill,
               "prefill_tokens_per_s": DECODE_BATCH * DECODE_PREFILL / dt_prefill,
               "prefill_launches": prefill_launches, "prefill_flash_fwd_by_body": prefill_bodies,
               "kernel_a_ms_at_prefill_shape": a_ms, "kernel_a_ms_per_prefill": LAYERS * a_ms,
               "logits_rtol": DECODE_LOGITS_RTOL, "check": check,
               "check_launches_by_body": check_bodies}

    facts = kernel_vs_plain(2, 2, lambda: _patched(fa, "flash_bwd_dkv", _drop_first_key_tile(fa)),
                            dims=D512_LM)

    epoch = lm_epoch(fa, D512_LM, rowterm=True)
    launches, bodies, expect = epoch["launches"], epoch["by_body"], epoch["expected_launches"]
    split = {name: launches[name] * times_wide[name]["ms"] for name in fa.KERNELS}
    split["rest"] = epoch["epoch_seconds"] * 1e3 - sum(split.values())
    epoch["split_ms_by_kernel_time"] = split
    emit({"phase": "lm_head_dim_512", "config": {"vocab": VOCAB, "seq": SEQ, **D512_LM},
          "agents": AGENTS, "layers": LAYERS, "batch_per_agent": BATCH, "steps": STEPS,
          "serving": serving, "one_step": facts, "epoch": epoch})
    if not (check["max_rel_err"] <= DECODE_LOGITS_RTOL and check["tokens_agree"]):
        raise AssertionError(f"head dim 512 decode disagrees with the full forward: {check}")
    want_prefill = {"flash_fwd": LAYERS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                    "flash_bwd_rowterm": 0}
    if prefill_launches != want_prefill or prefill_bodies["wgmma"] != LAYERS:
        raise AssertionError(f"head dim 512 prefill launches {prefill_launches} "
                             f"{prefill_bodies}: want kernel A on wgmma once a layer")
    fwd_check = check_bodies["flash_fwd"]
    if not (fwd_check["wgmma"] >= 2 * LAYERS and fwd_check["cuda_core_wide"] == 0):
        raise AssertionError(f"head dim 512 decode check launched {check_bodies}: want every "
                             "forward on wgmma")
    if not facts["ok"]:
        raise AssertionError("head dim 512: kernel path and plain path disagree, or the "
                             "control was not rejected")
    if not all(math.isfinite(x) for x in epoch["train_loss"]):
        raise AssertionError(f"head dim 512 epoch loss not finite: {epoch['train_loss']}")
    fwd, dq, dkv = (bodies[n] for n in fa._KERNEL_NAMES)
    if not (launches == expect and fwd["wgmma"] == expect["flash_fwd"]
            and dq["cuda_core_wide"] == dkv["cuda_core_wide"] == LAYERS * STEPS):
        raise AssertionError(f"head dim 512 launches {launches} {bodies}: want {expect}, the "
                             "forward on wgmma, dQ and dK/dV on cuda_core_wide, the pre-pass "
                             "once a layer backward")
    return launches, prefill_launches


# ---------------------------------------------------------------------- #
# Phase 32: the comm/ wire layer on the card's WRN-28-10 agents          #
# ---------------------------------------------------------------------- #
# The float32 wire carries the parameters exactly, so its ring round
# differs from ConsensusEngine's dense round (one GEMM) by summation order
# only: 2e-6, the mixing tolerance of tests/test_consensus.py.  A bf16 wire
# value is the RNE narrowing of its float32 source, within 2**-9 of it
# relative; 2**-8 is held.  An int8 wire value is round(x / s) * s with
# s = max|x| / 127: within s / 2, plus one float32 rounding of the product
# (an ulp of max|x|).  The bf16 and int8 rounds are then held to the
# ring weights times each received vector's largest error, plus 2e-6.
WIRE_MIX_ATOL = 2e-6
WIRE_BF16_RTOL = 2.0 ** -8
WIRE_TOPK = 0.1
WIRE_MODES = {"f32": {}, "bf16": {"bf16_wire": True}, "int8": {"int8_wire": True}}
WIRE_DEPTH, WIDEN = 28, 10


def _nest(flat: dict) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``: a model's parameters
    under flax's names, the tree the comm layer carries."""
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def _unnest(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_unnest(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _wire_transport(packed: dict, nbrs: dict, controls: dict) -> tuple:
    """Every packed body ``packed[mode][a]`` (an ``AsyncValue`` body) sent
    from agent ``a`` to each ring neighbour over 127.0.0.1 through
    ``FramedStream``, read back through the receiver's
    ``StreamMultiplexer``, sender by sender and mode by mode.  Returns the
    received payloads ``{(mode, a, b): DenseFrame or FusedFrame}``, the
    send seconds ``{(mode, a): s}`` and the controls' outcomes: each body
    of ``controls`` sent with one flipped byte (the transport crc of the
    true body) on a fresh connection, which must raise ``FrameError``."""
    import asyncio
    import dataclasses
    import struct

    from distributed_learning_tpu_torch.comm import framing, protocol
    from distributed_learning_tpu_torch.comm.multiplexer import StreamMultiplexer
    from distributed_learning_tpu_torch import native

    @dataclasses.dataclass
    class Packed(protocol.AsyncValue):
        """An ``AsyncValue`` whose body was packed before the timed send."""

        body: bytes = b""

        def _pack(self) -> bytes:
            return self.body

    async def flipped_byte_rejected(body) -> bool:
        """``body`` with one payload byte flipped in transit (the frame's
        crc is the true body's) on a fresh connection: True when the
        receiving ``FramedStream`` raises ``FrameError``."""
        accepted = asyncio.get_running_loop().create_future()
        srv = await asyncio.start_server(
            lambda r, w: accepted.set_result(framing.FramedStream(r, w)), "127.0.0.1", 0)
        sender = await framing.open_framed_connection(
            "127.0.0.1", srv.sockets[0].getsockname()[1])
        receiver = await asyncio.wait_for(accepted, 60)
        header = struct.pack("<IBBH", len(body), framing.WIRE_VERSION,
                             protocol.AsyncValue.TYPE_CODE, 0)
        bad = bytearray(body)
        bad[29 + (len(body) - 30) // 2] ^= 0x10  # inside the frame's payload

        async def send():
            sender.writer.write(header + bytes(bad) + struct.pack("<I", native.crc32(body)))
            await sender.writer.drain()

        try:  # the receiver reads while the sender drains
            _, got = await asyncio.wait_for(
                asyncio.gather(send(), receiver.recv(), return_exceptions=True), 120)
            return isinstance(got, framing.FrameError)
        finally:
            sender.close()
            receiver.close()
            srv.close()
            await srv.wait_closed()

    async def main():
        inbound = {b: {} for b in nbrs}
        edges = sum(len(v) for v in nbrs.values())
        ready = asyncio.Event()

        async def handle(reader, writer, b):
            stream = framing.FramedStream(reader, writer)
            hello = await stream.recv()
            inbound[b][int(hello.token)] = stream
            if sum(len(v) for v in inbound.values()) == edges:
                ready.set()

        servers = {b: await asyncio.start_server(
            lambda r, w, b=b: handle(r, w, b), "127.0.0.1", 0) for b in nbrs}
        out = {}
        for a in nbrs:
            for b in nbrs[a]:
                out[a, b] = await framing.open_framed_connection(
                    "127.0.0.1", servers[b].sockets[0].getsockname()[1])
                await out[a, b].send(protocol.Register(token=str(a), host="127.0.0.1", port=0))
        await asyncio.wait_for(ready.wait(), 60)
        muxes = {b: StreamMultiplexer(inbound[b]) for b in nbrs}
        received, send_s, rejected = {}, {}, {}
        try:
            for mode, bodies in packed.items():
                for a, body in bodies.items():
                    async def send_all(a=a, body=body):
                        for b in nbrs[a]:
                            await out[a, b].send(Packed(body=body))

                    async def recv_one(b, a=a):
                        token, msg, _ = await asyncio.wait_for(muxes[b].__anext__(), 120)
                        if token != a or msg is None:
                            raise AssertionError(f"agent {b} got {msg!r} from {token}, want {a}")
                        return b, msg.value

                    t0 = time.perf_counter()
                    got = await asyncio.gather(send_all(), *(recv_one(b) for b in nbrs[a]))
                    send_s[mode, a] = time.perf_counter() - t0
                    for b, value in got[1:]:
                        received[mode, a, b] = value
            for kind, body in controls.items():
                rejected[kind] = await flipped_byte_rejected(body)
        finally:
            for m in muxes.values():
                m.close()
            for s in out.values():
                s.close()
            for per in inbound.values():
                for s in per.values():
                    s.close()
            for srv in servers.values():
                srv.close()
                await srv.wait_closed()
        return received, send_s, rejected

    return asyncio.run(asyncio.wait_for(main(), 600))


def phase_wire():
    """The wire layer on the WRN slice's 4 agents (see the module
    docstring, phase 32).  The wire has no kernel: every number here is a
    host or copy time."""
    from distributed_learning_tpu_torch import native
    from distributed_learning_tpu_torch.comm import protocol, pytree_codec
    from distributed_learning_tpu_torch.comm import tensor_codec as tc
    from distributed_learning_tpu_torch.comm import top_k_compressor
    from distributed_learning_tpu_torch.models import WideResNet
    from distributed_learning_tpu_torch.native import wire as native_wire
    from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry
    from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology

    os.environ.pop("DLT_NO_NATIVE", None)
    t0 = time.perf_counter()
    built = {"codec": native.native_available(), "wire": native_wire.available()}
    libs = {"codec": native.library_path(native._SRC), "wire": native.library_path(native_wire._SRC)}
    facts = {"native_build_and_load_s": time.perf_counter() - t0, "native_built": built,
             "libraries": {k: os.path.relpath(v) for k, v in libs.items()}}
    if not all(built.values()) or any(os.path.dirname(p) != str(native.BUILD_DIR)
                                      for p in libs.values()):
        emit({"phase": "wire", **facts})
        raise AssertionError(f"the native wire libraries did not build into _build/: {facts}")

    model = WideResNet(WIRE_DEPTH, WIDEN, n_agents=AGENTS, device=DEVICE, seed=0)
    stacked = {k: v.detach() for k, v in model.stacked_parameters().items()}
    P = model.param_count()
    trees = [_nest({k: v[a] for k, v in stacked.items()}) for a in range(AGENTS)]
    W = Topology.ring(AGENTS).metropolis_weights()
    nbrs = {a: [b for b in range(AGENTS) if b != a and W[a, b] > 0] for a in range(AGENTS)}
    ref = ConsensusEngine(W, device=DEVICE).mix({k: v.clone() for k, v in stacked.items()})

    # The bound of the transfer part: the pinned copy of the float32 ravel.
    dev_buf = torch.empty(P, device=DEVICE)
    host_buf = torch.empty(P, pin_memory=DEVICE == "cuda")
    bound = {"bytes": 4 * P, "d2h_ms": cuda_ms(lambda: host_buf.copy_(dev_buf), 5),
             "h2d_ms": cuda_ms(lambda: dev_buf.copy_(host_buf), 5)}
    del dev_buf

    reg = MetricsRegistry()
    gauge = []  # the comm.wire.native gauge after every encode and decode

    def served():
        gauge.append(reg.gauges.get("comm.wire.native"))

    rec = {m: {a: {} for a in range(AGENTS)} for m in (*WIRE_MODES, "topk")}
    flats, frames, packed, hats, spec = {}, {m: {} for m in rec}, {m: {} for m in rec}, {}, None
    same_as_numpy_path = True
    compress = top_k_compressor(WIRE_TOPK)
    with use_registry(reg):
        for a in range(AGENTS):
            for mode, kw in WIRE_MODES.items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                flat, spec = pytree_codec.tree_to_flat(trees[a])
                t2 = time.perf_counter()
                frames[mode][a] = tc.encode_tensor(flat, **kw)
                t3 = time.perf_counter()
                served()
                rec[mode][a].update(d2h_s=t2 - t1, encode_s=t3 - t2)
                flats[a] = flat
            # CHOCO's correction against the estimate the neighbours hold
            # after the int8 round: top-k 10% of x - hat, one fused frame.
            hats[a] = tc.decode_tensor(frames["int8"][a])
            served()
            t1 = time.perf_counter()
            q = compress(flats[a] - hats[a])
            t2 = time.perf_counter()
            frames["topk"][a] = tc.encode_fused_sparse(q, spec.dtype_buckets())
            t3 = time.perf_counter()
            served()
            rec["topk"][a].update(select_s=t2 - t1, encode_s=t3 - t2, kept=int(np.count_nonzero(q)))
            rec["topk"][a]["q"] = q
            # The same frames from the numpy path, and the protocol's body.
            with use_registry(MetricsRegistry()):
                os.environ["DLT_NO_NATIVE"] = "1"
                try:
                    for mode, kw in WIRE_MODES.items():
                        same_as_numpy_path &= tc.encode_tensor(flats[a], **kw) == frames[mode][a]
                    same_as_numpy_path &= (tc.encode_fused_sparse(q, spec.dtype_buckets())
                                           == frames["topk"][a])
                    same_as_numpy_path &= np.array_equal(
                        tc.decode_tensor(frames["int8"][a]).view(np.uint32),
                        hats[a].view(np.uint32))
                finally:
                    del os.environ["DLT_NO_NATIVE"]
            for mode, kw in WIRE_MODES.items():
                _, body = protocol.pack_message(protocol.AsyncValue(value=flats[a], **kw))
                packed[mode][a] = body
            _, packed["topk"][a] = protocol.pack_message(protocol.AsyncValue(
                value=q, kind=2, buckets=spec.dtype_buckets()))
            served()
            for mode in rec:
                n = len(frames[mode][a])
                same_as_numpy_path &= packed[mode][a][29:29 + n] == frames[mode][a]
                rec[mode][a]["frame_bytes"] = n
        received, send_s, rejected = _wire_transport(
            packed, nbrs, {m: packed[m][0] for m in rec})

        # Receive side: decode into pinned out= scratch, flat_to_tree onto
        # the card, mix with W there.
        scratch = torch.empty(P, pin_memory=DEVICE == "cuda").numpy()
        errs, mixed_err, recv_trees = {}, {}, {}
        for mode in WIRE_MODES:
            worst = {}
            for (m, a, b), frame in received.items():
                if m != mode:
                    continue
                t1 = time.perf_counter()
                dec = frame.densify(out=scratch)
                t2 = time.perf_counter()
                served()
                tree = pytree_codec.flat_to_tree(dec, spec, device=DEVICE)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                x = flats[a]
                diff = np.abs(dec - x)
                if mode == "f32":
                    ok = bool(np.array_equal(dec.view(np.uint32), x.view(np.uint32)))
                elif mode == "bf16":
                    ok = bool((diff <= WIRE_BF16_RTOL * np.abs(x)).all())
                else:
                    amax = float(np.abs(x).max())
                    ok = bool((diff <= amax / 127 / 2 + np.spacing(np.float32(amax))).all())
                worst[a, b] = (float(diff.max()), ok)
                recv_trees[a, b] = tree
                r = rec[mode][a].setdefault("to", {})
                r[b] = {"decode_s": t2 - t1, "h2d_s": t3 - t2}
            errs[mode] = {f"{a}->{b}": v for (a, b), v in worst.items()}
            # x_b' = sum_a W[b, a] x_a over b and its neighbours' received trees.
            dev = 0.0
            for b in range(AGENTS):
                parts = [(W[b, b], _unnest(trees[b]))] + [
                    (W[b, a], _unnest(recv_trees[a, b])) for a in nbrs[b]]
                allowed = WIRE_MIX_ATOL + sum(W[b, a] * worst[a, b][0] for a in nbrs[b])
                for name in stacked:
                    acc = sum(float(w) * leaves[name].float() for w, leaves in parts)
                    d = float((acc - ref[name][b]).abs().max())
                    dev = max(dev, d / allowed)
                del parts
            mixed_err[mode] = dev  # the largest error over its limit; <= 1 passes
            recv_trees.clear()
            gc.collect()
            torch.cuda.empty_cache()

        # The fused frames: applied into a live estimate, and densified.
        apply_equal, fused_exact = True, True
        for (m, a, b), frame in received.items():
            if m != "topk":
                continue
            target = hats[a].copy()
            t1 = time.perf_counter()
            frame.apply_into(target)
            t2 = time.perf_counter()
            served()
            pytree_codec.flat_to_tree(target, spec, device=DEVICE)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            want = hats[a] + tc.decode_fused_sparse(frames["topk"][a])
            served()
            apply_equal &= np.array_equal(target.view(np.uint32), want.view(np.uint32))
            fused_exact &= np.array_equal(frame.densify(out=scratch), rec["topk"][a]["q"])
            served()
            rec["topk"][a].setdefault("to", {})[b] = {"decode_s": t2 - t1, "h2d_s": t3 - t2}

    # Codec-level control: a flipped byte in the fused frame fails its own
    # crc, and the live target of decode_fused_apply stays as it was.
    bad = bytearray(frames["topk"][0])
    bad[len(bad) // 2] ^= 0x10
    target = hats[0].copy()
    fused_rejected = {}
    for name, fn in (("decode_fused_apply", lambda: tc.decode_fused_apply(bytes(bad), target)),
                     ("FusedFrame", lambda: tc.FusedFrame(bytes(bad))),
                     ("decode_fused_sparse", lambda: tc.decode_fused_sparse(bytes(bad)))):
        try:
            fn()
            fused_rejected[name] = False
        except tc.CodecError:
            fused_rejected[name] = True
    target_untouched = bool(np.array_equal(target.view(np.uint32), hats[0].view(np.uint32)))

    for mode in rec:
        agents = []
        for a in range(AGENTS):
            r = rec[mode][a]
            r.pop("q", None)
            send = send_s[mode, a]
            into = r.pop("to")
            agents.append({
                "agent": a, **r,
                "d2h_encode_s": r.get("d2h_s", 0.0) + r.get("select_s", 0.0) + r["encode_s"],
                "send_s": send, "send_MBps": r["frame_bytes"] * len(nbrs[a]) / send / 1e6,
                "decode_h2d_s": {str(b): v["decode_s"] + v["h2d_s"] for b, v in into.items()},
                "decode_s": {str(b): v["decode_s"] for b, v in into.items()},
                "h2d_s": {str(b): v["h2d_s"] for b, v in into.items()}})
        emit({"phase": "wire", "mode": mode, "params_per_agent": P,
              "copy_bound": bound, "agents": agents})
    reads = [g for g in gauge]
    checks = {
        "params_per_agent_is_wrn_28_10": P == WRN_PARAMS or (WIRE_DEPTH, WIDEN) != (28, 10),
        "f32_round_vs_engine_over_limit": mixed_err["f32"],
        "bf16_round_over_limit": mixed_err["bf16"], "int8_round_over_limit": mixed_err["int8"],
        "values_within_wire_rounding": {m: all(ok for _, ok in e.values()) for m, e in errs.items()},
        "max_abs_value_err": {m: max(v for v, _ in e.values()) for m, e in errs.items()},
        "fused_apply_bit_equal": apply_equal, "fused_densify_exact": fused_exact,
        "native_frames_equal_numpy_path": bool(same_as_numpy_path),
        "gauge_reads": len(reads), "gauge_min": min((g for g in reads if g is not None),
                                                     default=None),
        "gauge_never_0": bool(reads) and all(g == 1.0 for g in reads),
        "transit_flip_rejected": rejected, "fused_flip_rejected": fused_rejected,
        "apply_target_untouched": target_untouched,
    }
    ok = (checks["params_per_agent_is_wrn_28_10"]
          and all(mixed_err[m] <= 1.0 for m in WIRE_MODES)
          and all(checks["values_within_wire_rounding"].values())
          and apply_equal and fused_exact and checks["native_frames_equal_numpy_path"]
          and checks["gauge_never_0"] and all(rejected.values()) and len(rejected) == len(rec)
          and all(fused_rejected.values()) and target_untouched)
    emit({"phase": "wire", "summary": True, **facts, "limits": {
        "mix_atol": WIRE_MIX_ATOL, "bf16_rtol": WIRE_BF16_RTOL,
        "int8": "max|x| / 127 / 2 + ulp(max|x|)"}, "topk_fraction": WIRE_TOPK, **checks,
        "ok": ok})
    del model, stacked, trees, ref
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"wire phase failed: {checks}")


# ---------------------------------------------------------------------- #
# Phase 33: the comm/ runtime on the WRN slice's agents                  #
# ---------------------------------------------------------------------- #
# The epoch-1 TCP round against the dense on-card epoch: the wire phase's
# limit (the f32 round equalled the engine exactly there).  The control
# scales one agent's value by 1 + 2^-10 before its send, which moves its
# neighbours' results by ~w 2^-10 |x| (3.3e-4 on an H100), far above it.
RUNTIME_SCALE = 1.0 + 2.0 ** -10
# After epoch 2 the TCP trainer and the dense trainer have each trained on
# its own epoch-1 result, which differ by one float32 rounding of the
# round (1.2e-7); the 4 steps of epoch 2 amplify that to 1.9e-3 on an H100
# (the CPU rehearsals at WRN-16-2 / 16-4 read 5.9e-3 / 8.4e-3).  The limit
# is 2^-7, 4x the card's reading.  The round itself is held at
# WIRE_MIX_ATOL on the same input every epoch.
RUNTIME_EPOCH2_ATOL = 2.0 ** -7
RUNTIME_EPOCHS = 2
RUNTIME_BF16_K = 1  # bf16-wire run_round iterations
RUNTIME_CHOCO_ITERS, RUNTIME_CHOCO_GAMMA = 2, 0.2
RUNTIME_STRAGGLER = {"tau": 1, "deadline_s": 3.0, "fast_rounds": 1, "slow_rounds": 1}
RUNTIME_FAULT = {"seed": 12, "drop_p": 0.25, "dup_p": 0.25, "reorder_p": 0.25, "rounds": 2}
# The honest agents wait this long for a neighbour's value beside a liar,
# long enough to read its lies (73 MB frames) in their first round.
RUNTIME_LIAR_DEADLINE_S, RUNTIME_LIAR_ROUNDS = 60.0, 3
# One agent operation may take RUNTIME_STEP_S, the whole phase RUNTIME_LIMIT_S.
RUNTIME_STEP_S, RUNTIME_LIMIT_S = 180, 480


class _RuntimeClock:
    """Per-agent host seconds of the runtime's parts, attributed through a
    context variable each agent's task carries: D2H (``host_value``), H2D
    (the way back), encode and decode (the protocol's pack and unpack),
    send (inside ``FramedStream.send`` past the encode: the socket write
    and drain, on a loop the agents share), mix (the host arithmetic after
    the exchange) and round wall time.  Installed around the phase and
    removed after it."""

    def __init__(self):
        import contextvars

        self.var = contextvars.ContextVar("runtime_agent", default=None)
        self.secs: dict = {}
        self._undo = []

    def add(self, key: str, dt: float) -> None:
        agent = self.var.get()
        if agent is not None:
            d = self.secs.setdefault(agent, {})
            d[key] = d.get(key, 0.0) + dt

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def install(self):
        from distributed_learning_tpu_torch.comm import agent as agent_mod
        from distributed_learning_tpu_torch.comm import async_runtime, framing

        clock, real_host_value = self, agent_mod.host_value
        real_pack, real_unpack = framing.pack_message, framing.unpack_message
        real_send = framing.FramedStream.send
        real_exchange = agent_mod.ConsensusAgent._exchange_values
        real_iteration = agent_mod.ConsensusAgent._gossip_iteration
        real_finish = agent_mod.ConsensusAgent._choco_finish

        def host_value(value):
            t0 = time.perf_counter()
            flat, back = real_host_value(value)
            clock.add("d2h_s", time.perf_counter() - t0)

            def timed_back(out):
                t1 = time.perf_counter()
                res = back(out)
                if res.device.type == "cuda":
                    torch.cuda.synchronize()
                clock.add("h2d_s", time.perf_counter() - t1)
                return res

            return flat, timed_back

        def pack(msg):
            t0 = time.perf_counter()
            out = real_pack(msg)
            clock.add("encode_s", time.perf_counter() - t0)
            return out

        def unpack(code, body):
            t0 = time.perf_counter()
            out = real_unpack(code, body)
            clock.add("decode_s", time.perf_counter() - t0)
            return out

        async def send(stream, msg):
            before = clock.secs.get(clock.var.get(), {}).get("encode_s", 0.0)
            t0 = time.perf_counter()
            await real_send(stream, msg)
            after = clock.secs.get(clock.var.get(), {}).get("encode_s", 0.0)
            clock.add("send_s", time.perf_counter() - t0 - (after - before))

        async def exchange(agent, *a, **k):
            out = await real_exchange(agent, *a, **k)
            agent._rt_exchange_end = time.perf_counter()
            return out

        async def iteration(agent, y):
            out = await real_iteration(agent, y)
            clock.add("mix_s", time.perf_counter() - agent._rt_exchange_end)
            return out

        def finish(agent, *a, **k):
            t0 = time.perf_counter()
            out = real_finish(agent, *a, **k)
            clock.add("mix_s", time.perf_counter() - t0)
            return out

        self._patch(agent_mod, "host_value", host_value)
        self._patch(async_runtime, "host_value", host_value)
        self._patch(framing, "pack_message", pack)
        self._patch(framing, "unpack_message", unpack)
        self._patch(framing.FramedStream, "send", send)
        self._patch(agent_mod.ConsensusAgent, "_exchange_values", exchange)
        self._patch(agent_mod.ConsensusAgent, "_gossip_iteration", iteration)
        self._patch(agent_mod.ConsensusAgent, "_choco_finish", finish)
        return self

    def remove(self):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()

    async def call(self, token, fn):
        """``await fn()`` (within ``RUNTIME_STEP_S``) with its wall time
        counted as ``wall_s`` of ``token``, and every part inside it
        attributed to ``token``."""
        import asyncio

        self.var.set(token)
        t0 = time.perf_counter()
        out = await asyncio.wait_for(fn(), RUNTIME_STEP_S)
        self.add("wall_s", time.perf_counter() - t0)
        return out

    def take(self) -> dict:
        out, self.secs = self.secs, {}
        return out


def _topk_per_leaf(v: np.ndarray, fraction: float) -> np.ndarray:
    """Top-k by magnitude (``k = max(1, round(fraction * n))``, ties to the
    lowest index), written independently of ``tensor_codec.top_k_sparse``:
    the k-th largest magnitude from a partition, everything above it,
    then the lowest indices at it."""
    flat = v.ravel()
    n = flat.size
    k = max(1, int(round(fraction * n)))
    mag = np.abs(flat)
    thr = np.partition(mag, n - k)[n - k]
    out = np.zeros_like(flat)
    above = np.flatnonzero(mag > thr)
    at = np.flatnonzero(mag == thr)[: k - above.size]
    keep = np.concatenate([above, at])
    out[keep] = flat[keep]
    return out.reshape(v.shape)


def _bf16_envelope(W: np.ndarray, ys: list, k: int) -> torch.Tensor:
    """Per-value bound on a ``k``-iteration bf16-wire run_round against
    ``k`` float32 rounds: every value an agent receives is rounded to
    bf16 (within 2^-8 of itself, ``WIRE_BF16_RTOL``), its own is
    not, and the errors propagate through W: E' = W_ii E_i + sum_j W_ij
    (E_j + 2^-8 (|Y_j| + E_j)), plus ``WIRE_MIX_ATOL`` for the float32
    sums.  ``ys[t]`` is the (N, P) float32 state after t rounds; float64
    on the state's device."""
    n = W.shape[0]
    E = torch.zeros(ys[0].shape, dtype=torch.float64, device=ys[0].device)
    for t in range(k):
        Y = ys[t].abs().double()
        nxt = torch.zeros_like(E)
        for i in range(n):
            nxt[i] = W[i, i] * E[i]
            for j in range(n):
                if j != i and W[i, j] > 0:
                    nxt[i] += W[i, j] * (E[j] + WIRE_BF16_RTOL * (Y[j] + E[j]))
        E = nxt
        del Y
    return E + WIRE_MIX_ATOL


def _every_hundredth(v: np.ndarray) -> np.ndarray:
    """A 1% sparse CHOCO compressor without a selection: every 100th value."""
    out = np.zeros_like(v)
    out[::100] = v[::100]
    return out


def phase_comm_runtime():
    """The ``comm/`` runtime driving gossip SGD between the WRN slice's 4
    agents (see the module docstring, phase 33).  The runtime has no
    kernel: every time here is a host or copy time."""
    import asyncio

    torch.use_deterministic_algorithms(True, warn_only=True)
    clock = _RuntimeClock().install()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic.*")
            facts = asyncio.run(asyncio.wait_for(_comm_runtime(clock), RUNTIME_LIMIT_S))
    finally:
        clock.remove()
        torch.use_deterministic_algorithms(False)
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "comm_runtime", **facts})
    failed = [k for k, v in facts["checks"].items() if not v]
    if failed:
        raise AssertionError(f"comm_runtime checks failed: {failed}")


def _runtime_wrn(**trainer_kwargs):
    return make_vision_master(
        "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, RUNTIME_EPOCHS, WRN_EVAL, augment=True,
        depth=WIRE_DEPTH, widen_factor=WIDEN, dropout_rate=0.3, dtype=torch.bfloat16,
        trainer_kwargs=trainer_kwargs)


async def _runtime_deploy(master_kw, agent_kw):
    import asyncio

    from distributed_learning_tpu_torch.comm import ConsensusAgent, ConsensusMaster
    from distributed_learning_tpu_torch.parallel import Topology

    master = ConsensusMaster(Topology.ring(AGENTS), **master_kw)
    host, port = await master.start()
    agents = [ConsensusAgent(str(a), host, port, **agent_kw) for a in range(AGENTS)]
    await asyncio.gather(*(a.start() for a in agents))
    assert [master._index[a.token] for a in agents] == list(range(AGENTS))
    return master, agents


async def _runtime_close(master, agents):
    import asyncio

    await master.shutdown()
    await asyncio.gather(*(a.close(drain=0.1) for a in agents))


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


async def _comm_runtime(clock) -> dict:
    import asyncio

    from distributed_learning_tpu_torch.comm import AsyncGossipRunner, FaultPlan
    from distributed_learning_tpu_torch.comm import inject_neighbor_faults, top_k_compressor
    from distributed_learning_tpu_torch.comm.pytree_codec import tree_to_flat
    from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry
    from distributed_learning_tpu_torch.parallel import ConsensusEngine

    checks, facts, times = {}, {}, {}
    t_phase = time.perf_counter()
    # --- 1. gossip SGD: local steps, then one master-gated TCP round --- #
    # A round that max_iterations ended is still open at the master; it is
    # cut as the master's enforced deadline would cut it (600 s, a safety
    # net) once all 4 agents asked for the next round, which then starts
    # at once.  The agents drop the cut's Done while they wait for it.
    master, agents = await _runtime_deploy(
        dict(convergence_eps=1e-4, enforce_round_deadline=True, round_deadline_s=600.0),
        dict(sparse_wire=True))
    W = master.W
    tcp = _runtime_wrn(mix_times=0)
    dense = _runtime_wrn(weights=W, mix_times=1)
    P = tcp.model.param_count()
    engine = ConsensusEngine(W, device=DEVICE)
    facts["params_per_agent"] = P
    checks["full_width"] = P == WRN_PARAMS

    async def cut_open_round():
        if master._round_running:
            while len(master._round_weights) < AGENTS:
                await asyncio.sleep(0.001)
            await master._deadline_cut(master._round_id)

    async def tcp_round(values, label):
        t0 = time.perf_counter()
        outs, _ = await asyncio.gather(asyncio.gather(*(clock.call(a.token, lambda a=a, v=v: a.run_round(
            v, 1.0, max_iterations=1)) for a, v in zip(agents, values))), cut_open_round())
        torch.cuda.synchronize()
        times[label] = {"wall_s": time.perf_counter() - t0, "agents": clock.take()}
        return torch.stack(outs)

    epochs = []
    for e in range(RUNTIME_EPOCHS):
        t0 = time.perf_counter()
        tcp.train_epoch()
        dense.train_epoch()
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        flat = tcp.model.flat_params
        before = flat.detach().clone()
        ref = engine.mix({"p": before.clone()})["p"]
        mixed = await tcp_round([flat[a] for a in range(AGENTS)], f"epoch_{e + 1}")
        rec = {"epoch": e + 1, "steps_and_eval_s_both_trainers": steps_s,
               "round_id": master._round_id, "generation": master.generation,
               "tcp_vs_engine_on_same_input": _max_abs(mixed, ref)}
        if e == 0:
            scaled = [before[a] * RUNTIME_SCALE if a == 0 else before[a] for a in range(AGENTS)]
            control = await tcp_round(scaled, "control")
            rec["control_vs_engine"] = _max_abs(control, ref)
            checks["control_rejected"] = rec["control_vs_engine"] > WIRE_MIX_ATOL
        with torch.no_grad():
            flat.copy_(mixed)
        torch.cuda.synchronize()
        rec["tcp_vs_dense_trainer"] = _max_abs(tcp.model.flat_params, dense.model.flat_params)
        limit = WIRE_MIX_ATOL if e == 0 else RUNTIME_EPOCH2_ATOL
        rec["limit"] = limit
        checks[f"epoch_{e + 1}_round_equals_engine"] = rec["tcp_vs_engine_on_same_input"] <= WIRE_MIX_ATOL
        checks[f"epoch_{e + 1}_tcp_trainer_vs_dense_trainer"] = rec["tcp_vs_dense_trainer"] <= limit
        epochs.append(rec)
    facts["epochs"] = epochs
    checks["finite"] = bool(torch.isfinite(tcp.model.flat_params).all())
    trees = [_nest({k: v[a].detach() for k, v in tcp.model.stacked_parameters().items()})
             for a in range(AGENTS)]
    x0 = tcp.model.flat_params.detach().clone()
    del dense
    gc.collect()
    torch.cuda.empty_cache()

    # --- 3. run_choco_tree: top-k 10% per leaf, fused sparse frames --- #
    comp = top_k_compressor(WIRE_TOPK)
    host_trees = [{k: v.float().cpu().numpy() for k, v in _unnest(t).items()} for t in trees]
    hats = [{k: np.zeros_like(v) for k, v in t.items()} for t in host_trees]
    xs, cur = host_trees, trees
    choco = {"iterations": []}
    w_of = {(i, j): W[i, j] for i in range(AGENTS) for j in range(AGENTS)}
    for it in range(RUNTIME_CHOCO_ITERS):
        t0 = time.perf_counter()
        cur = await asyncio.gather(*(clock.call(a.token, lambda a=a, t=t: a.run_choco_tree(
            t, comp, gamma=RUNTIME_CHOCO_GAMMA, fused=True)) for a, t in zip(agents, cur)))
        torch.cuda.synchronize()
        times[f"choco_{it + 1}"] = {"wall_s": time.perf_counter() - t0, "agents": clock.take()}
        # The independent host recurrence: q = topk(x - hat) per leaf,
        # hat += q, x' = x + gamma sum_j w_ij (hat_j - hat_i), neighbours
        # in token order, float32.
        for i in range(AGENTS):
            for k in xs[i]:
                hats[i][k] = hats[i][k] + _topk_per_leaf(xs[i][k] - hats[i][k], WIRE_TOPK)
        new = []
        for i in range(AGENTS):
            out = {k: v.copy() for k, v in xs[i].items()}
            for j in sorted(range(AGENTS), key=str):
                if j != i and W[i, j] > 0:
                    for k in out:
                        out[k] += RUNTIME_CHOCO_GAMMA * w_of[i, j] * (hats[j][k] - hats[i][k])
            new.append(out)
        xs = new
        flips = 0
        for i, a in enumerate(agents):
            mine, _ = tree_to_flat(_nest({k: torch.from_numpy(v) for k, v in hats[i].items()}))
            flips += int(((a._choco_hat_self != 0) != (mine != 0)).sum())
        got = [{k: v.float().cpu().numpy() for k, v in _unnest(t).items()} for t in cur]
        diff = max(float(np.abs(got[i][k] - xs[i][k]).max()) for i in range(AGENTS) for k in xs[i])
        frames = sum(a.counters.get("fused_frames", 0) for a in agents)
        choco["iterations"].append({"selection_flips": flips, "max_abs_vs_host_recurrence": diff,
                                    "fused_frames_total": frames})
    checks["choco_tree_equals_host_recurrence"] = all(
        r["max_abs_vs_host_recurrence"] <= WIRE_MIX_ATOL for r in choco["iterations"])
    checks["choco_tree_no_selection_flip"] = all(r["selection_flips"] == 0 for r in choco["iterations"])
    facts["choco_tree"] = choco

    # --- 4a. AsyncGossipRunner at tau = 0 against the lock-step path --- #
    # CHOCO here (sparse frames); the plain round below on the bf16 wire.
    # The compressor keeps every 100th value: a 1% sparse correction
    # without the host top-k's ~0.7 s an agent (the equality holds for
    # any compressor).
    vals = [x0[a] for a in range(AGENTS)]
    runners = [AsyncGossipRunner(a, staleness_bound=0) for a in agents]
    for a in agents:
        a.reset_choco()
    lock_c = await asyncio.gather(*(clock.call(a.token, lambda a=a, v=v: a.run_choco_once(
        v, _every_hundredth, gamma=RUNTIME_CHOCO_GAMMA)) for a, v in zip(agents, vals)))
    times["run_choco_once"] = {"agents": clock.take()}
    for a in agents:
        a.reset_choco()
    asy_c = await asyncio.gather(*(clock.call(a.token, lambda r=r, v=v: r.run_async_choco(
        v, _every_hundredth, gamma=RUNTIME_CHOCO_GAMMA)) for a, r, v in zip(agents, runners, vals)))
    times["async_choco_tau0"] = {"agents": clock.take()}
    checks["async_tau0_choco_bitwise"] = all(torch.equal(x, y) for x, y in zip(lock_c, asy_c))
    facts["async_tau0"] = {"choco_max_abs": max(_max_abs(x, y) for x, y in zip(lock_c, asy_c))}
    facts["wire_stats_agent_0"] = agents[0].wire_stats()
    await _runtime_close(master, agents)

    # --- 2. bf16 wire: run_round to max_iterations K -------------------- #
    master, agents = await _runtime_deploy(dict(convergence_eps=1e-4), dict(bf16_wire=True))
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(clock.call(a.token, lambda a=a, v=x0[i]: a.run_round(
        v, 1.0, max_iterations=RUNTIME_BF16_K)) for i, a in enumerate(agents)))
    torch.cuda.synchronize()
    times["bf16_round"] = {"wall_s": time.perf_counter() - t0, "agents": clock.take()}
    ys = [x0]
    for _ in range(RUNTIME_BF16_K):
        ys.append(engine.mix({"p": ys[-1].clone()})["p"])
    got = torch.stack(outs)
    env = _bf16_envelope(W, ys, RUNTIME_BF16_K)
    diff = (got.double() - ys[-1].double()).abs()
    facts["bf16_round"] = {
        "iterations": RUNTIME_BF16_K, "round_id": master._round_id,
        "agent_iterations": [a._iteration + 1 for a in agents],
        "master_statuses": {t: ("converged" if ok else "not_converged")
                            for t, ok in master._converged.items()},
        "max_abs_vs_engine": float(diff.max()), "max_ratio_to_limit": float((diff / env).max()),
        "deviation_after_k": float((got - got.mean(0)).abs().max()),
        "deviation_before": float((x0 - x0.mean(0)).abs().max())}
    checks["bf16_round_within_envelope"] = bool((diff <= env).all())
    del env, diff, got, ys
    # The plain async round at tau 0 against run_once, on this bf16 wire.
    vals = [x0[a] for a in range(AGENTS)]
    t0 = time.perf_counter()
    lock = await asyncio.gather(*(clock.call(a.token, lambda a=a, v=v: a.run_once(v))
                                  for a, v in zip(agents, vals)))
    times["run_once"] = {"wall_s": time.perf_counter() - t0, "agents": clock.take()}
    runners = [AsyncGossipRunner(a, staleness_bound=0) for a in agents]
    t0 = time.perf_counter()
    asy = await asyncio.gather(*(clock.call(a.token, lambda r=r, v=v: r.run_async_round(v))
                                 for a, r, v in zip(agents, runners, vals)))
    torch.cuda.synchronize()
    times["async_tau0"] = {"wall_s": time.perf_counter() - t0, "agents": clock.take()}
    checks["async_tau0_plain_bitwise"] = all(torch.equal(x, y) for x, y in zip(lock, asy))
    facts["async_tau0"]["plain_bf16_max_abs"] = max(_max_abs(x, y) for x, y in zip(lock, asy))

    # --- 4b. straggler rounds (tau 1): agent 3 held back ---------------- #
    st = RUNTIME_STRAGGLER
    reg = MetricsRegistry()
    with use_registry(reg):
        runners = [AsyncGossipRunner(a, staleness_bound=st["tau"], deadline_s=st["deadline_s"],
                                     overlap=True) for a in agents]
        released = asyncio.Event()

        async def fast(i):
            x = x0[i]
            for _ in range(st["fast_rounds"]):
                x = await runners[i].run_async_round(x)
            return x

        async def slow(i):
            await released.wait()
            x = x0[i]
            for _ in range(st["slow_rounds"]):
                x = await runners[i].run_async_round(x)
            return x

        t0 = time.perf_counter()
        slow_task = asyncio.ensure_future(clock.call("3", lambda: slow(3)))
        fast_out = await asyncio.gather(*(clock.call(str(i), lambda i=i: fast(i)) for i in range(3)))
        released.set()
        slow_out = await slow_task
        times["straggler"] = {"wall_s": time.perf_counter() - t0, "agents": clock.take()}
        straggler_counters = dict(reg.counters)
        staleness = [v for _, v in reg.series.get("comm.agent.staleness", ())]
        # The fault plan: seeded drop / dup / reorder on edge 0 -> 1.
        ft = RUNTIME_FAULT
        plan = FaultPlan(ft["seed"], drop_p=ft["drop_p"], dup_p=ft["dup_p"],
                         reorder_p=ft["reorder_p"])
        wrapped = inject_neighbor_faults(agents[0], "1", plan)
        xs = list(fast_out) + [slow_out]
        for _ in range(ft["rounds"]):
            xs = await asyncio.gather(*(clock.call(str(i), lambda i=i: runners[i].run_async_round(
                xs[i])) for i in range(AGENTS)))
        times["fault_rounds"] = {"agents": clock.take()}
        expected = [(i, d.kind) for i, d in enumerate(plan.schedule(wrapped.send_index))
                    if d.kind != "none"]
        facts["fault_plan"] = {"frames": wrapped.send_index, "events": wrapped.events,
                               "counters": wrapped.counters}
        checks["fault_decisions_replay_the_plan"] = wrapped.events == expected
        checks["fault_rounds_finite"] = all(bool(torch.isfinite(x).all()) for x in xs)
        # Every inbound edge has now decoded frames; in overlap mode only
        # its first decode misses the pool (skipped, dropped and duplicate
        # frames are never decoded).
        scratch = {k: reg.counters.get(f"comm.wire.scratch_{k}", 0) for k in ("misses", "hits")}
    counters = straggler_counters
    facts["straggler"] = {
        "rounds": [r.round for r in runners[:3]] + [runners[3].round],
        "staleness_max": max(staleness) if staleness else None,
        "staleness_points": len(staleness),
        "stale_dropped": counters.get("comm.agent.async_stale_dropped", 0),
        "stale_mixed": counters.get("comm.agent.async_stale_mixed", 0),
        "pokes_sent": counters.get("comm.agent.pokes_sent", 0),
        "deadline_drops": counters.get("comm.agent.async_deadline_drops", 0),
        "scratch_misses_after_fault_rounds": scratch["misses"],
        "scratch_hits_after_fault_rounds": scratch["hits"]}
    checks["straggler_dropped_and_poked"] = (facts["straggler"]["stale_dropped"] > 0
                                             and facts["straggler"]["pokes_sent"] > 0)
    checks["straggler_staleness_observed"] = bool(staleness) and max(staleness) >= 1
    checks["scratch_misses_one_per_inbound_edge"] = scratch["misses"] == 2 * AGENTS
    checks["straggler_finite"] = all(bool(torch.isfinite(x).all()) for x in (*fast_out, slow_out))
    await _runtime_close(master, agents)

    # --- 5. a lying peer is quarantined by the master ------------------- #
    master, agents = await _runtime_deploy(dict(convergence_eps=1e-4, regenerate=True),
                                           dict(bf16_wire=True))
    liar = agents[3]
    for nb in ("0", "2"):
        inject_neighbor_faults(liar, nb, FaultPlan(7, byzantine_p=1.0))
    honest = [AsyncGossipRunner(a, staleness_bound=1, deadline_s=RUNTIME_LIAR_DEADLINE_S,
                                quarantine_after=2) for a in agents[:3]]
    lying = AsyncGossipRunner(liar, staleness_bound=1)
    xs = [x0[i] for i in range(3)]
    t0 = time.perf_counter()
    # The liar pushes two lying frames to each neighbour (its whole run).
    # The honest agents' first round waits for every neighbour's value (the
    # deadline is long), so it reads both lies; their reports then reach
    # the master.
    flat, _ = tree_to_flat(x0[3])
    for _ in range(2):
        await lying._push(flat)
    honest_rounds = 0
    while not master.counters.get("agents_quarantined") and honest_rounds < RUNTIME_LIAR_ROUNDS:
        xs = await asyncio.gather(*(clock.call(r.agent.token, lambda r=r, x=x: r.run_async_round(x))
                                    for r, x in zip(honest, xs)))
        honest_rounds += 1
        for _ in range(1000):  # the accusers' telemetry is on its way (at most 5 s)
            if master.counters.get("agents_quarantined"):
                break
            await asyncio.sleep(0.005)
    times["quarantine_rounds"] = {"agents": clock.take()}
    facts["quarantine"] = {"seconds": time.perf_counter() - t0, "honest_rounds": honest_rounds,
                           "master_agents_quarantined": master.counters.get("agents_quarantined", 0),
                           "master_reports": master.counters.get("quarantine_reports", 0),
                           "generation": master.generation,
                           "quarantined_by": [r.agent.token for r in honest if "3" in r.quarantined],
                           "violations": [r.agent.counters.get("async_field_violations", 0)
                                          for r in honest]}
    checks["liar_quarantined_by_master"] = (facts["quarantine"]["master_agents_quarantined"] == 1
                                            and "3" in master._quarantined)
    await _runtime_close(master, agents)

    # --- the per-agent host times beside the pinned-copy bound ---------- #
    dev_buf = torch.empty(P, device=DEVICE)
    host_buf = torch.empty(P, pin_memory=DEVICE == "cuda")
    facts["pinned_copy_bound"] = {"bytes": 4 * P,
                                  "d2h_ms": cuda_ms(lambda: host_buf.copy_(dev_buf), 5),
                                  "h2d_ms": cuda_ms(lambda: dev_buf.copy_(host_buf), 5)}
    del dev_buf, host_buf
    facts["times"] = times
    facts["checks"] = checks
    facts["seconds"] = time.perf_counter() - t_phase
    return facts


# ---------------------------------------------------------------------- #
# Phase 34: the sharded engine on torch.distributed, one agent a rank    #
# ---------------------------------------------------------------------- #
# Four rank processes of this script share cuda:0 over gloo (with four
# cards or more: nccl, one card each).  Limits: the engine's routes at
# WRN-28-10 width against the dense engine on the same stacked state
# within SHARDED_MIX_ATOL (the reference's mixing tolerance,
# tests/test_consensus.py); the max deviation within SHARDED_DEV_RTOL
# (float32 sums over 36.5M elements taken in another order).  The WRN
# epoch against the dense trainer's: losses and running statistics
# within the vision_plain limits (bit for bit expected: the same cuDNN
# calls per agent under deterministic algorithms), parameters after the
# round within SHARDED_MIX_ATOL (the round's sums in another order).
# The LM epoch against the dense one: losses within LOSS_RTOL, each
# agent's parameter update within GRAD_RTOL of the dense update
# (||p - p_dense|| / ||p_dense - p_0||: the batched and the one-agent
# GEMMs round differently, carried through Adam).  DSGT and EXTRA
# within ROUTES_ATOL, push-sum within SHARDED_MIX_ATOL and its totals
# within PUSHSUM_SUM_RTOL.
SHARDED_WORLD = 4
SHARDED_TIMEOUT_S = 900
SHARDED_MIX_ATOL = 2e-6
SHARDED_DEV_RTOL = 1e-5
SHARDED_EPS = 100.0  # mix_until's eps on the N(0, 1) WRN-width state (~4 rounds)
SHARDED_PS_ROUNDS = 8
SHARDED_TIMING_ROUNDS = 3


def phase_sharded():
    """Spawn the ranks, stream nothing, print their lines when they end,
    and fail if one fails (the others are stopped at once)."""
    import socket
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(SHARDED_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
             "--coordinator", f"127.0.0.1:{port}", "--sharded-out", tmp],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=here)
            for r in range(SHARDED_WORLD)]
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            time.sleep(0.5)
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
            elif time.perf_counter() - t0 > SHARDED_TIMEOUT_S:
                failed = f"ranks still running after {SHARDED_TIMEOUT_S} s"
        for p in procs:  # stop every process this phase started
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        for out in outs:
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = "a rank exited non-zero"
        if failed:
            tails = "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs))
            raise AssertionError(f"sharded phase failed: {failed}\n{tails}")
        facts = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(SHARDED_WORLD)]
    launches = {k: sum(f["lm"]["launches"][k] for f in facts) for k in facts[0]["lm"]["launches"]}
    mp_launches = {k: sum(f["model_parallel"][part]["launches"][k] for f in facts
                          for part in ("tp_step", "fsdp_step"))
                   + sum(g["launches"][k] for f in facts
                         for g in f["model_parallel"]["gossip"].values())
                   for k in launches}
    mp = [f["model_parallel"] for f in facts]
    seq_launches = {k: sum(f["lm_step"]["ring_flash"]["launches"][k] for f in facts)
                    for k in launches}
    pp_launches = {k: sum(f["pipeline"]["launches"][k] for f in facts) for k in launches}
    pp = [f["pipeline"] for f in facts]
    step = [f["lm_step"]["ring_flash"] for f in facts]
    lm_s = max(f["lm"]["epoch_seconds"] for f in facts)
    wrn_s = max(f["wrn"]["epoch_seconds"] for f in facts)
    summary = {
        "phase": "sharded_summary", "world": SHARDED_WORLD,
        "backend": facts[0]["backend"], "devices": [f["device"] for f in facts],
        "engine_round_ms": {f"rank{f['rank']}": f["engine"]["round_ms"] for f in facts},
        "dense_round_ms": facts[0]["engine"]["dense_round_ms"],
        "wrn_epoch_seconds": wrn_s,
        "wrn_transport_s": {f"rank{f['rank']}": f["wrn"]["transport_s"] for f in facts},
        "lm_transport_s": {f"rank{f['rank']}": f["lm"]["transport_s"] for f in facts},
        "wrn_samples_per_s": WRN_AGENTS * WRN_BATCH * WRN_STEPS / wrn_s,
        "lm_epoch_seconds": lm_s, "lm_tokens_per_s": AGENTS * BATCH * SEQ * STEPS / lm_s,
        "lm_sharded_launches": launches,
        "item_3b_route_ms": {f"rank{f['rank']}": f["sharded_3b"]["route_ms"] for f in facts},
        "item_3b_dense_ms": facts[0]["sharded_3b"]["dense_ms"],
        "wrn_3b_samples_per_s": {k: max(f["wrn_3b"]["epochs"][k]["samples_per_s"]
                                        for f in facts) for k in facts[0]["wrn_3b"]["epochs"]},
        "ring_flash_ms": {f"rank{f['rank']}": {t: f["ring_flash"][t]["ring_ms"]
                                               for t in ("causal", "full")} for f in facts},
        "lm_step_seconds": max(sum(r["step_seconds"]) for r in step) / SPMD_STEPS,
        "lm_step_tokens_per_s": min(r["tokens_per_s"] for r in step),
        "lm_step_split": {f"rank{f['rank']}": f["lm_step"]["ring_flash"]["split"]
                          for f in facts},
        "lm_step_peak_memory_bytes": max(r["peak_memory_bytes"] for r in step),
        "seq_parallel_launches": seq_launches,
        "tp_step_seconds": max(sum(m["tp_step"]["step_seconds"]) for m in mp) / MP_STEPS,
        "tp_step_tokens_per_s": min(m["tp_step"]["tokens_per_s"] for m in mp),
        "tp_step_split": {f"rank{f['rank']}": f["model_parallel"]["tp_step"]["split"]
                          for f in facts},
        "fsdp_step_seconds": max(sum(m["fsdp_step"]["step_seconds"]) for m in mp) / MP_STEPS,
        "fsdp_step_tokens_per_s": min(m["fsdp_step"]["tokens_per_s"] for m in mp),
        "fsdp_step_split": {f"rank{f['rank']}": f["model_parallel"]["fsdp_step"]["split"]
                            for f in facts},
        "tp_decode_ms_per_step": {k: max(m["tp_generate"][k]["ms_per_decode_step"] for m in mp)
                                  for k in mp[0]["tp_generate"]},
        "model_parallel_launches": mp_launches,
        "model_parallel_seconds": max(m["seconds"] for m in mp),
        "pipeline_step_seconds": {k: max(max(p["schedules"][k]["step_seconds"]) for p in pp)
                                  for k in pp[0]["schedules"]},
        "pipeline_tokens_per_s": {k: min(p["schedules"][k]["tokens_per_s"] for p in pp)
                                  for k in pp[0]["schedules"]},
        "pipeline_peak_memory_bytes": {k: max(p["schedules"][k]["peak_memory_bytes"] for p in pp)
                                       for k in pp[0]["schedules"]},
        "pipeline_bubble_share": {f"rank{f['rank']}": {k: f["pipeline"]["schedules"][k]["bubble_share"]
                                                       for k in pp[0]["schedules"]}
                                  for f in facts},
        "pipeline_bubble_share_schedule": pp[0]["schedules"]["gpipe"]["bubble_share_schedule"],
        "pipeline_split": {f"rank{f['rank']}": {k: f["pipeline"]["schedules"][k]["split"][-1]
                                                for k in pp[0]["schedules"]} for f in facts},
        "pipeline_launches": pp_launches,
        "pipeline_seconds": max(p["seconds"] for p in pp),
        "seconds": round(time.perf_counter() - t0, 2),
    }
    emit(summary)
    return launches, seq_launches, mp_launches, pp_launches


def _transport_s(mesh) -> dict:
    """The transport's seconds since the clock's reset: the gossip round's
    and the trainer's cross-rank reads (traces, eval, residual)."""
    c = mesh.clock
    return {"d2h": c.d2h_s, "exchange": c.exchange_s, "h2d": c.h2d_s,
            "bytes_sent": c.bytes_sent}


def _rank_emit(mesh, part, facts):
    emit({"phase": f"sharded_{part}", "rank": mesh.rank, "agent": mesh.agent, **facts})


def _sharded_engine(mesh) -> dict:
    """The engine's routes at WRN-28-10 width on this rank against the
    dense engine on the same stacked state (every rank draws it from one
    seed and checks its own row), a dropped-message control, and one
    round's parts timed."""
    from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology

    n, a, dev = mesh.size, mesh.agent, mesh.device
    W = Topology.ring(n).metropolis_weights()
    W2 = Topology.erdos_renyi(n, 0.6, seed=1).metropolis_weights()
    g = torch.Generator(device=dev).manual_seed(0)
    X = {"float32": torch.randn(n, WRN_PARAMS, generator=g, device=dev)}
    x = {"float32": X["float32"][a:a + 1].clone()}
    dense = ConsensusEngine(W, device=dev)
    eng = ConsensusEngine(W, mesh=mesh)
    errs, checks = {}, {}

    def held(name, got, want):
        errs[name] = float((got["float32"] - want["float32"][a:a + 1]).abs().max())
        checks[name] = errs[name] <= SHARDED_MIX_ATOL

    held("mix", eng.mix(x, 1), dense.mix(X, 1))
    for route in ("ring", "allgather"):
        held(f"mix_with_{route}", eng.mix_with(x, W2, 1, route=route), dense.mix_with(X, W2, 1))
    held("mix_chebyshev", eng.mix_chebyshev(x, 3), dense.mix_chebyshev(X, 3))
    s, t, res = eng.mix_until(x, eps=SHARDED_EPS)
    sd, td, rd = dense.mix_until(X, eps=SHARDED_EPS)
    held("mix_until", s, sd)
    checks["mix_until_rounds"] = t == td and t > 1
    del s, sd
    held("global_average", eng.global_average(x), dense.global_average(X))
    md, mdd = float(eng.max_deviation(x)), float(dense.max_deviation(X))
    checks["max_deviation"] = abs(md - mdd) <= SHARDED_DEV_RTOL * mdd
    # Control: agent 0 loses one matching's message (zeros arrive).
    orig, dropped = mesh.exchange, []

    def dropping(sends, recvs):
        orig(sends, recvs)
        if a == 0 and not dropped:
            for _, buf in recvs:
                buf.zero_()
            dropped.append(True)

    mesh.exchange = dropping
    try:
        bad = eng.mix(x, 1)
    finally:
        mesh.exchange = orig
    ctrl = float((bad["float32"] - dense.mix(X, 1)["float32"][a:a + 1]).abs().max())
    checks["dropped_message_rejected"] = a != 0 or ctrl > SHARDED_MIX_ATOL
    del bad
    # One round's parts: device-to-host, exchange, host-to-device, and the rest.
    buffers, spare = {"float32": x["float32"].clone()}, eng.spare_for(x, 1)
    eng.mix_(buffers, 1, spare=spare)  # warm-up: pinned buffers, allocator
    mesh.clock.reset()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(SHARDED_TIMING_ROUNDS):
        eng.mix_(buffers, 1, spare=spare)
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / SHARDED_TIMING_ROUNDS * 1e3
    c = mesh.clock
    parts = {"d2h_ms": c.d2h_s * 1e3 / SHARDED_TIMING_ROUNDS,
             "exchange_ms": c.exchange_s * 1e3 / SHARDED_TIMING_ROUNDS,
             "h2d_ms": c.h2d_s * 1e3 / SHARDED_TIMING_ROUNDS}
    parts["arithmetic_and_rest_ms"] = wall - sum(parts.values())
    round_ms = {"wall_ms": wall, **parts,
                "bytes_sent_per_round": c.bytes_sent // SHARDED_TIMING_ROUNDS}
    dspare = dense.spare_for(X, 1)
    dense_ms = cuda_ms(lambda: dense.mix_(X, 1, spare=dspare), 3)
    facts = {"width": WRN_PARAMS, "max_abs_err": errs, "limit": SHARDED_MIX_ATOL,
             "mix_until_rounds": [t, td], "mix_until_residual": [res, rd],
             "max_deviation": [md, mdd], "control_max_abs_err": ctrl,
             "round_ms": round_ms, "dense_round_ms": dense_ms, "checks": checks}
    _rank_emit(mesh, "engine", facts)
    del X, x, buffers, spare, dspare
    gc.collect()
    torch.cuda.empty_cache()
    return facts


def _sharded_wrn(mesh) -> dict:
    """One epoch of gossip SGD on WRN-28-10 (the vision slice's steps, one
    round) with one agent a rank, against agent i of the dense trainer's
    same epoch, run on rank 0 once the sharded trainers are freed."""
    def master(**kw):
        return make_vision_master(
            "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, 1, WRN_EVAL, augment=True,
            depth=28, widen_factor=10, dropout_rate=0.3, dtype=torch.bfloat16, trainer_kwargs=kw)

    dev = mesh.device
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*deterministic.*")
        sm = master(mesh=mesh)
        torch.cuda.synchronize(dev)
        mesh.clock.reset()
        t0 = time.perf_counter()
        p = sm.train_epoch()
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        transport = _transport_s(mesh)
        params = mesh.all_gather(sm.model.flat_params[0])
        stats = mesh.all_gather(sm.model.flat_stats[0])
        losses = [list(sm.network[a].stats.train_loss) for a in range(WRN_AGENTS)]
        del sm
        gc.collect()
        torch.cuda.empty_cache()
        facts = {"epoch_seconds": dt, "transport_s": transport, "steps": WRN_STEPS,
                 "batch_per_agent": WRN_BATCH, "train_loss": p["train_loss"].tolist(),
                 "deviation": p["deviation"]}
        if mesh.agent == 0:
            dm = master()
            pd = dm.train_epoch()
            dlosses = np.asarray([dm.network[a].stats.train_loss for a in range(WRN_AGENTS)])
            loss_rel = float(np.max(np.abs(np.asarray(losses) - dlosses) / np.abs(dlosses)))
            p_err = float((params - dm.model.flat_params).abs().max())
            ds = dm.model.flat_stats
            s_rel = max(float((stats[i] - ds[i]).norm() / ds[i].norm()) for i in range(WRN_AGENTS))
            facts.update(
                dense_train_loss=pd["train_loss"].tolist(), dense_deviation=pd["deviation"],
                loss_max_rel_err=loss_rel, params_max_abs_err=p_err,
                stats_bitwise=bool(torch.equal(stats, dm.model.flat_stats)),
                stats_max_rel_err=s_rel,
                checks={"losses": loss_rel <= PLAIN_LOSS_RTOL,
                        "stats": s_rel <= PLAIN_STAT_RTOL,
                        "params": p_err <= SHARDED_MIX_ATOL,
                        "deviation": abs(p["deviation"] - pd["deviation"])
                        <= SHARDED_DEV_RTOL * pd["deviation"]})
            del dm
        del params, stats
        gc.collect()
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    mesh.barrier()
    _rank_emit(mesh, "wrn", facts)
    return facts


def _sharded_lm(mesh, fa) -> dict:
    """The LM slice sharded: one epoch of the slice's steps and one round
    with one agent a rank; A, B, C and the pre-pass counted on this rank
    around the epoch.  Rank 0 then runs the dense slice's same epoch."""
    dev = mesh.device
    sm = make_trainer("flash", LAYERS, AGENTS, 1, STEPS, mesh=mesh)
    p0 = mesh.all_gather(sm.model.flat_params[0])
    torch.cuda.synchronize(dev)
    mesh.clock.reset()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    p = sm.train_epoch()
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in fa.KERNELS.values()}
    transport = _transport_s(mesh)
    bodies = {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    n_eval = math.ceil(len(sm.test_data[0]) / sm.eval_batch_size)
    expect = {"flash_fwd": LAYERS * (STEPS + n_eval), "flash_bwd_dq": LAYERS * STEPS,
              "flash_bwd_dkv": LAYERS * STEPS, "flash_bwd_rowterm": LAYERS * STEPS}
    params = mesh.all_gather(sm.model.flat_params[0])
    losses = np.asarray([sm.network[a].stats.train_loss for a in range(AGENTS)])
    facts = {"epoch_seconds": dt, "transport_s": transport,
             "tokens_per_s": AGENTS * BATCH * SEQ * STEPS / dt,
             "params_per_agent": sm.model.param_count(), "launches": launches,
             "launches_by_body": bodies, "expected_launches": expect,
             "train_loss": p["train_loss"].tolist(), "peak_memory_bytes":
             torch.cuda.max_memory_allocated(dev)}
    checks = {"launches": launches == expect,
              "wgmma": all(bodies[k]["wgmma"] == launches[k]
                           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))}
    del sm
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.agent == 0:
        dm = make_trainer("flash", LAYERS, AGENTS, 1, STEPS)
        pd = dm.train_epoch()
        dlosses = np.asarray([dm.network[a].stats.train_loss for a in range(AGENTS)])
        loss_rel = float(np.max(np.abs(losses - dlosses) / np.abs(dlosses)))
        upd = [float((params[a] - dm.model.flat_params[a]).norm()
                     / (dm.model.flat_params[a] - p0[a]).norm()) for a in range(AGENTS)]
        facts.update(dense_train_loss=pd["train_loss"].tolist(), loss_max_rel_err=loss_rel,
                     update_rel_err=upd)
        checks.update(losses=loss_rel <= LOSS_RTOL, params=max(upd) <= GRAD_RTOL)
        del dm
    facts["checks"] = checks
    del params, p0
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    _rank_emit(mesh, "lm", facts)
    return facts


def _sharded_tracking(mesh) -> dict:
    """DSGT and EXTRA on the Titanic logreg and push-sum at WRN-28-10
    width with ``mesh=``, each against the dense engine on this rank's
    row, and push-sum's totals across the ranks."""
    from distributed_learning_tpu_torch.data import load_titanic, split_data
    from distributed_learning_tpu_torch.models.logreg import loss_fn
    from distributed_learning_tpu_torch.parallel import (
        ExtraEngine, GradientTrackingEngine, PushSumEngine, Topology, push_sum_matrix)

    n, a, dev = mesh.size, mesh.agent, mesh.device
    X_tr, y_tr, _, _ = load_titanic()
    order = np.argsort(y_tr)
    shards = split_data(X_tr[order], y_tr[order], n)
    m = min(len(shards[i][0]) for i in range(n))
    X = torch.as_tensor(np.stack([shards[i][0][:m] for i in range(n)]), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(np.stack([shards[i][1][:m] for i in range(n)]), dtype=torch.float32,
                        device=dev)

    def grad(w, i, step):
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            (gw,) = torch.autograd.grad(loss_fn(w, X[i], y[i], 1e-2).sum(), w)
        return gw

    W = Topology.ring(n).metropolis_weights()
    x0 = torch.zeros(n, X.shape[-1], device=dev)
    errs, checks = {}, {}
    for name, cls, kw in (("dsgt", GradientTrackingEngine, {}),
                          ("extra", ExtraEngine, {"project_every": 2})):
        sh = cls(W, grad, learning_rate=0.5, mesh=mesh, **kw)
        de = cls(W, grad, learning_rate=0.5, device=dev, **kw)
        (ss, st), (ds, dtr) = sh.run(sh.init(x0), ROUTES_STEPS), de.run(de.init(x0), ROUTES_STEPS)
        errs[name] = {"state": float((ss.x - ds.x[a:a + 1]).abs().max()),
                      "trace": float((st - dtr).abs().max())}
        checks[name] = max(errs[name].values()) <= ROUTES_ATOL
    P = push_sum_matrix({i: [(i + 1) % n] for i in range(n)}, n)
    g = torch.Generator(device=dev).manual_seed(1)
    V = torch.randn(n, WRN_PARAMS, generator=g, device=dev)
    ps, dps = PushSumEngine(P, mesh=mesh), PushSumEngine(P, device=dev)
    est = ps.mix(ps.shard(V), SHARDED_PS_ROUNDS)
    errs["pushsum"] = float((est - dps.mix(V, SHARDED_PS_ROUNDS)[a:a + 1]).abs().max())
    checks["pushsum"] = errs["pushsum"] <= SHARDED_MIX_ATOL
    del est
    num, den = ps.lift(ps.shard(V))
    tot0 = mesh.all_reduce(num["float32"].double().sum(0), "sum")
    den = ps.rounds_(num, den, SHARDED_PS_ROUNDS)
    tot = mesh.all_reduce(num["float32"].double().sum(0), "sum")
    dtot = float(mesh.all_reduce(den.double().sum().reshape(1), "sum")[0])
    sum_rel = float((tot - tot0).abs().max() / tot0.abs().max())
    checks["pushsum_totals"] = sum_rel <= PUSHSUM_SUM_RTOL and abs(dtot - n) <= PUSHSUM_SUM_RTOL * n
    facts = {"steps": ROUTES_STEPS, "pushsum_rounds": SHARDED_PS_ROUNDS, "max_abs_err": errs,
             "pushsum_total_rel_err": sum_rel, "pushsum_weight_total": dtot, "checks": checks}
    del V, num, den
    gc.collect()
    torch.cuda.empty_cache()
    _rank_emit(mesh, "tracking", facts)
    return facts


SHARDED_ROUTES = ("plain", "chebyshev", "topology_schedule", "global_avg_every", "mix_eps")


def _sharded_superstep(mesh) -> dict:
    """superstep_routes' MLP with ``mesh=`` for the slice's gossip
    routes: ``train_epochs(3)`` (the training graph replayed, the round
    eager between the replays) against 3 eager epochs bit for bit, and
    against the dense trainer's agent on this rank (``SHARDED_MIX_ATOL``)."""
    configs = route_configs()
    checks, errs = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*deterministic.*")
        for name in SHARDED_ROUTES:
            eager = _route_trainer(mesh=mesh, **configs[name])
            pe = [eager.train_epoch() for _ in range(SUPERSTEP_K)]
            graph = _route_trainer(mesh=mesh, **configs[name])
            pg = graph.train_epochs(SUPERSTEP_K)
            dense = _route_trainer(**configs[name])
            for _ in range(SUPERSTEP_K):
                dense.train_epoch()
            a = mesh.agent
            same = (torch.equal(eager.model.flat_params, graph.model.flat_params)
                    and all(x["mix_rounds"] == y["mix_rounds"]
                            and np.array_equal(x["train_loss"], y["train_loss"])
                            and x["deviation"] == y["deviation"] for x, y in zip(pe, pg)))
            errs[name] = float((eager.model.flat_params[0]
                                - dense.model.flat_params[a]).abs().max())
            checks[f"{name}_graph_equals_eager"] = same
            checks[f"{name}_equals_dense"] = errs[name] <= SHARDED_MIX_ATOL
            del eager, graph, dense
    torch.use_deterministic_algorithms(False)
    facts = {"epochs": SUPERSTEP_K, "dense_max_abs_err": errs, "checks": checks}
    _rank_emit(mesh, "superstep", facts)
    return facts



# -- Phase 34, part 2: ROADMAP item 3b and sequence parallelism ------- #
# Limits: each 3b route at WRN-28-10 width against the dense engine on
# the same stacked state within SHARDED_MIX_ATOL (float32: the sums of a
# round in another order), the redirected masses within
# SHARDED_MASS_RTOL (float32 sums over the ranks in another order).
# The clip radius makes every edge clip: an N(0, 1) delta at this width
# has norm ~sqrt(2 WRN_PARAMS) ~ 8543.  ring_flash alone (seq 4) against
# kernels A/B/C run at full T in one process under phase 2's bfloat16
# limits (TOL); the agents x seq step and its ring / ulysses cut against
# two agents in one process with attn_impl "flash" at full T, the same
# Adam and the same Metropolis round: losses within LOSS_RTOL, each
# agent's update within GRAD_RTOL (the ring's blocks and the full-T
# kernels round differently, carried through Adam; ring and ulysses
# round the scores to bfloat16 as the plain path does).
SHARDED_MASS_RTOL = 1e-5
SHARDED_3B_ROUNDS = 2
SHARDED_CLIP_RADIUS = 6000.0
SHARDED_CLIP_MULTIPLIER = 0.99
SHARDED_TOPK = 0.1
SHARDED_PERIODS, SHARDED_TAU = (1, 2, 1, 2), 1
SPMD_SHAPE = {"agents": 2, "seq": 2}
SPMD_STEPS, SPMD_CUT_LAYERS, SPMD_LR = 3, 2, 3e-4
# Gossip SGD on WRN-28-10 with each 3b option, one epoch each.
WRN_3B = {
    "choco": {"compression": "topk:0.1", "compression_gamma": 0.2},
    "async": {"async_gossip": {"staleness_bound": 1, "publish_period": [1, 2, 1, 2]}},
    "trim": {"robust_mixing": {"kind": "trim", "trim": 1}, "weights": "complete"},
    "clip": {"robust_mixing": {"kind": "clip", "radius": 2.0, "adaptive": True}},
}


def _timed_transport(mesh, fn):
    """``fn()``'s result, wall ms and transport parts on ``mesh``'s clock
    (D2H, exchange or collective, H2D, the rest) and the bytes it sent."""
    dev = mesh.device
    torch.cuda.synchronize(dev)
    mesh.clock.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3
    c = mesh.clock
    parts = {"wall_ms": wall, "d2h_ms": c.d2h_s * 1e3, "exchange_ms": c.exchange_s * 1e3,
             "h2d_ms": c.h2d_s * 1e3}
    parts["arithmetic_and_rest_ms"] = wall - parts["d2h_ms"] - parts["exchange_ms"] - parts[
        "h2d_ms"]
    parts["bytes_sent"] = c.bytes_sent
    return out, parts


def _event_ms(fn):
    """``fn()``'s result and its milliseconds between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _wrn_leaf_shapes(total: int):
    """WRN-28-10's convolution kernels as leaf shapes, and one leaf with
    the rest of the ``total`` parameters (the per-leaf budgets' layout)."""
    shapes = [(c_out, c_in, k, k) for c_in, c_out, k, _s, _p, _h in wrn_conv_shapes(28, 10)]
    rest = total - sum(math.prod(s) for s in shapes)
    return shapes + [(rest,)]


def _sharded_3b(mesh) -> dict:
    """ROADMAP item 3b at WRN-28-10 width on this rank: async gossip,
    clip (fixed and adaptive), trimmed mean, async clip and trim, and
    CHOCO top-k (per-leaf, and global with error feedback), each against
    the dense engine on the same stacked state; a dropped partner
    message and a one-round-stale publication must fail; each route's
    transport parts beside the dense call."""
    from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology
    from distributed_learning_tpu_torch.parallel import compression as tc

    n, a, dev = mesh.size, mesh.agent, mesh.device
    W = {"ring": Topology.ring(n).metropolis_weights(),
         "complete": Topology.complete(n).metropolis_weights()}
    sh = {m: ConsensusEngine(w, mesh=mesh) for m, w in W.items()}
    de = {m: ConsensusEngine(w, device=dev) for m, w in W.items()}
    g = torch.Generator(device=dev).manual_seed(3)
    X = {"float32": torch.randn(n, WRN_PARAMS, generator=g, device=dev)}
    x = {"float32": X["float32"][a:a + 1].clone()}
    R = SHARDED_3B_ROUNDS
    clip = {"kind": "clip", "radius": SHARDED_CLIP_RADIUS}
    trim = {"kind": "trim", "trim": 1}
    kw = dict(tau=SHARDED_TAU, periods=SHARDED_PERIODS, times=R)
    routes = {
        "async": ("ring", lambda e, s: e.mix_async(s, **kw)),
        "clip": ("ring", lambda e, s: e.mix_robust(s, clip, R)),
        "clip_adaptive": ("ring", lambda e, s: e.mix_robust(
            s, {"kind": "clip", "radius": SHARDED_CLIP_MULTIPLIER, "adaptive": True}, R)),
        "trim": ("complete", lambda e, s: e.mix_robust(s, trim, R)),
        "async_clip": ("ring", lambda e, s: e.mix_async_robust(s, spec=clip, **kw)),
        "async_trim": ("complete", lambda e, s: e.mix_async_robust(s, spec=trim, **kw)),
    }
    errs, masses, parts, dense_ms, checks = {}, {}, {}, {}, {}

    def row_err(got, want):
        return max(float((got[k] - want[k][a:a + 1]).abs().max()) for k in got)

    for name, (m, fn) in routes.items():
        got, parts[name] = _timed_transport(mesh, lambda: fn(sh[m], x))
        want, dense_ms[name] = _event_ms(lambda: fn(de[m], X))
        errs[name] = row_err(got[0], want[0])
        if name.startswith("async"):
            errs[f"{name}_pub"] = row_err(got[1].pub, want[1].pub)
        if not name == "async":
            masses[name] = [float(got[-1]), float(want[-1])]
            checks[f"{name}_mass"] = (abs(masses[name][0] - masses[name][1])
                                      <= SHARDED_MASS_RTOL * abs(masses[name][1])
                                      and masses[name][1] > 0)
        del got, want
    # CHOCO top-k 10% on WRN-28-10's leaves (per-leaf, and global with EF).
    shapes, off, leaves = _wrn_leaf_shapes(WRN_PARAMS), 0, {}
    for i, shp in enumerate(shapes):
        size = math.prod(shp)
        leaves[f"l{i:02d}"] = X["float32"][:, off:off + size].reshape(n, *shp)
        off += size
    for name, ckw in (("choco_per_leaf", {}),
                      ("choco_global_ef", {"budget": "global", "error_feedback": True})):
        se = tc.ChocoGossipEngine(W["ring"], tc.top_k(SHARDED_TOPK), gamma=0.2, mesh=mesh, **ckw)
        dce = tc.ChocoGossipEngine(W["ring"], tc.top_k(SHARDED_TOPK), gamma=0.2, device=dev, **ckw)
        (st, trace), parts[name] = _timed_transport(mesh, lambda: se.run(se.init(leaves), R))
        (dst, dtrace), dense_ms[name] = _event_ms(lambda: dce.run(dce.init(leaves), R))
        errs[name] = max(float((st.x[k] - dst.x[k][a:a + 1]).abs().max()) for k in st.x)
        errs[f"{name}_xhat"] = max(float((st.xhat[k] - dst.xhat[k][a:a + 1]).abs().max())
                                   for k in st.x)
        checks[f"{name}_trace"] = bool(((trace - dtrace).abs()
                                        <= SHARDED_DEV_RTOL * dtrace.abs()).all())
        del st, dst
    del leaves
    for k, e in errs.items():
        checks[k] = e <= SHARDED_MIX_ATOL
    # Control 1: agent 0 loses one partner message in a clipped round.
    orig, dropped = mesh.exchange, []

    def dropping(sends, recvs):
        orig(sends, recvs)
        if a == 0 and not dropped:
            for _, buf in recvs:
                buf.zero_()
            dropped.append(True)

    mesh.exchange = dropping
    try:
        bad = sh["ring"].mix_robust(x, {"kind": "clip", "radius": SHARDED_CLIP_RADIUS * 2}, 1)[0]
    finally:
        mesh.exchange = orig
    want = de["ring"].mix_robust(X, {"kind": "clip", "radius": SHARDED_CLIP_RADIUS * 2}, 1)[0]
    ctrl_drop = row_err(bad, want)
    # Control 2: agent 0 skips its second publication, so its neighbours
    # mix a copy one round stale.
    eng, calls = sh["ring"], []
    real = eng._publish_local_

    def stale(xs, state, periods):
        calls.append(1)
        if a == 0 and len(calls) == 2:
            keep = {k: v.clone() for k, v in state.pub.items()}
            real(xs, state, periods)
            for k, v in keep.items():
                state.pub[k].copy_(v)
            return
        real(xs, state, periods)

    eng._publish_local_ = stale
    try:
        bad = eng.mix_async(x, **kw)[0]
    finally:
        del eng._publish_local_
    want = de["ring"].mix_async(X, **kw)[0]
    err = torch.tensor([row_err(bad, want)], device=dev)
    ctrl_stale = float(mesh.all_reduce(err, "max")[0])
    checks["dropped_message_rejected"] = a != 0 or ctrl_drop > SHARDED_MIX_ATOL
    checks["stale_publication_rejected"] = ctrl_stale > SHARDED_MIX_ATOL
    del bad, want, X, x
    gc.collect()
    torch.cuda.empty_cache()
    facts = {"width": WRN_PARAMS, "rounds": R, "max_abs_err": errs, "masses": masses,
             "limit": SHARDED_MIX_ATOL, "control_dropped_max_abs_err": ctrl_drop,
             "control_stale_max_abs_err": ctrl_stale, "route_ms": parts,
             "dense_ms": dense_ms, "checks": checks}
    _rank_emit(mesh, "3b", facts)
    return facts


def _sharded_wrn_3b(mesh) -> dict:
    """One epoch of gossip SGD on WRN-28-10 with each of ``WRN_3B``'s
    options and one agent a rank, against agent i of the dense trainer's
    same epoch, run on rank 0 once the sharded trainer is freed."""
    from distributed_learning_tpu_torch.parallel import Topology

    def master(opts, **kw):
        opts = dict(opts)
        if opts.pop("weights", "ring") == "complete":
            opts["weights"] = Topology.complete(WRN_AGENTS)
        return make_vision_master(
            "wide-resnet", WRN_AGENTS, WRN_BATCH, WRN_STEPS, 1, WRN_EVAL, augment=True,
            depth=28, widen_factor=10, dropout_rate=0.3, dtype=torch.bfloat16,
            trainer_kwargs=dict(opts, **kw))

    dev, out = mesh.device, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*deterministic.*")
        for name, opts in WRN_3B.items():
            sm = master(opts, mesh=mesh)
            torch.cuda.synchronize(dev)
            mesh.clock.reset()
            t0 = time.perf_counter()
            sm.train_epoch()
            torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            transport = _transport_s(mesh)
            params = mesh.all_gather(sm.model.flat_params[0])
            stats = mesh.all_gather(sm.model.flat_stats[0])
            losses = [list(sm.network[i].stats.train_loss) for i in range(WRN_AGENTS)]
            masses = list(sm._robust_masses)
            del sm
            gc.collect()
            torch.cuda.empty_cache()
            facts = {"epoch_seconds": dt, "transport_s": transport,
                     "samples_per_s": WRN_AGENTS * WRN_BATCH * WRN_STEPS / dt}
            if mesh.agent == 0:
                dm = master(opts)
                dm.train_epoch()
                dl = np.asarray([dm.network[i].stats.train_loss for i in range(WRN_AGENTS)])
                loss_rel = float(np.max(np.abs(np.asarray(losses) - dl) / np.abs(dl)))
                p_err = float((params - dm.model.flat_params).abs().max())
                ds = dm.model.flat_stats
                s_rel = max(float((stats[i] - ds[i]).norm() / ds[i].norm())
                            for i in range(WRN_AGENTS))
                m_ok = len(masses) == len(dm._robust_masses) and all(
                    abs(x - y) <= SHARDED_MASS_RTOL * abs(y)
                    for x, y in zip(masses, dm._robust_masses))
                facts.update(loss_max_rel_err=loss_rel, params_max_abs_err=p_err,
                             stats_max_rel_err=s_rel, masses=[masses, list(dm._robust_masses)],
                             checks={"losses": loss_rel <= PLAIN_LOSS_RTOL,
                                     "stats": s_rel <= PLAIN_STAT_RTOL,
                                     "params": p_err <= SHARDED_MIX_ATOL,
                                     "masses": m_ok})
                del dm
            del params, stats
            gc.collect()
            torch.cuda.empty_cache()
            mesh.barrier()
            out[name] = facts
    torch.use_deterministic_algorithms(False)
    checks = {f"{k}.{c}": ok for k, f in out.items() for c, ok in f.get("checks", {}).items()}
    facts = {"epochs": out, "checks": checks}
    _rank_emit(mesh, "wrn_3b", facts)
    return facts


def _ring_blocks_controls():
    """Two broken ``_blocks``: the second block labelled with the wrong
    source, and the first rotation skipped (the own K/V kept under the
    received source)."""
    from distributed_learning_tpu_torch.ops import ring_attention as ra

    orig = ra._blocks

    def wrong_src(mesh_, k_, v_):
        return [(kb, vb, (s + 1) % mesh_.size if i == 1 else s)
                for i, (kb, vb, s) in enumerate(orig(mesh_, k_, v_))]

    def skipped(mesh_, k_, v_):
        out = orig(mesh_, k_, v_)
        return [out[0], (out[0][0], out[0][1], out[1][2])] + out[2:]

    return {"wrong_src": wrong_src, "skipped_rotation": skipped}


def _sharded_ring_flash(mesh, fa) -> dict:
    """ring_flash alone on the 4 ranks as one sequence axis at the LM
    slice's attention shape (B 2, 8 x 128 heads, T 4096 bf16, 1024 a
    rank), causal and not: forward and backward gathered to rank 0 and
    held against kernels A/B/C at full T; the launches a rank; the ring's
    transport beside the rest.  The controls must fail."""
    from distributed_learning_tpu_torch.ops import ring_attention as ra

    n, a, dev = mesh.size, mesh.agent, mesh.device
    g = torch.Generator(device=dev).manual_seed(4)
    full = [torch.randn(BATCH, SEQ, HEADS, HEAD_DIM, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(4)]
    t = SEQ // n
    lim, checks, facts = TOL[torch.bfloat16], {}, {}

    def gathered(x):
        return torch.cat(list(mesh.all_gather(x.contiguous()).unbind(0)), dim=1)

    for causal in (True, False):
        tag = "causal" if causal else "full"
        loc = [x[:, a * t:(a + 1) * t].clone().requires_grad_(True) for x in full[:3]]
        do = full[3][:, a * t:(a + 1) * t].contiguous()
        ra.ring_flash_attention(*loc, mesh=mesh, causal=causal).backward(do)  # warm-up
        for x in loc:
            x.grad = None
        fa.reset_launch_counts()

        def run():
            out = ra.ring_flash_attention(*loc, mesh=mesh, causal=causal)
            out.backward(do)
            return out

        out, parts = _timed_transport(mesh, run)
        launches = {k.name: k.launches for k in fa.KERNELS.values()}
        live = a + 1 if causal else n
        expect = {"flash_fwd": live, "flash_bwd_dq": live, "flash_bwd_dkv": live,
                  "flash_bwd_rowterm": live}
        # The kernels' own time for this rank's live blocks (CUDA events).
        kb = full[1][:, :t].contiguous()
        o_, lse_ = fa.flash_fwd(loc[0].detach(), kb, kb, 1.0 / math.sqrt(HEAD_DIM), causal,
                                None, with_lse=True)
        fwd_ms = cuda_ms(lambda: fa.flash_fwd(loc[0].detach(), kb, kb, 0.1, causal, None,
                                              with_lse=True), 3)
        bwd_ms = cuda_ms(lambda: fa._layer_backward(loc[0].detach(), kb, kb, o_, do, lse_,
                                                    lse_, 0.1, causal, None), 3)
        res = [gathered(x) for x in (out.detach(), loc[0].grad, loc[1].grad, loc[2].grad)]
        f = {"launches": launches, "expected_launches": expect, "ring_ms": parts,
             "kernels_ms_per_live_block": {"fwd": fwd_ms, "bwd": bwd_ms},
             "kernels_ms_live_blocks": live * (fwd_ms + bwd_ms)}
        checks[f"{tag}_launches"] = launches == expect
        if a == 0:
            ref = [x.clone().requires_grad_(True) for x in full[:3]]
            ro = fa.flash_attention(*ref, causal=causal)
            ro.backward(full[3])
            errs = {}
            for name, got, want, atol in zip(("o", "dq", "dk", "dv"), res,
                                             [ro.detach()] + [x.grad for x in ref],
                                             (lim["o"],) + (lim["grad"],) * 3):
                err, tile, ok = compare(got, want, atol, lim["rtol"], lim["tile"])
                errs[name] = {"max_abs_err": err, "tile_rel_err": tile}
                checks[f"{tag}_{name}"] = ok
            f["errors"] = errs
            del ref, ro
        facts[tag] = f
        del res, out, loc
    # Controls: the forward with a broken rotation must leave the limits.
    orig = ra._blocks
    for name, fake in _ring_blocks_controls().items():
        loc = [x[:, a * t:(a + 1) * t].contiguous() for x in full[:3]]
        ra._blocks = fake
        try:
            with torch.no_grad():
                bad = gathered(ra.ring_flash_attention(*loc, mesh=mesh, causal=True))
        finally:
            ra._blocks = orig
        if a == 0:
            with torch.no_grad():
                want = fa.flash_attention(*full[:3], causal=True)
            err, tile, ok = compare(bad, want, lim["o"], lim["rtol"], lim["tile"])
            facts[f"control_{name}"] = {"max_abs_err": err, "tile_rel_err": tile}
            checks[f"control_{name}_rejected"] = not ok
    del full
    gc.collect()
    torch.cuda.empty_cache()
    facts["checks"] = checks
    _rank_emit(mesh, "ring_flash", facts)
    return facts


def _spmd_model(grid, attn_impl, layers, n_agents=1):
    from distributed_learning_tpu_torch.models.transformer import TransformerLM

    kw = dict(vocab_size=VOCAB, num_layers=layers, num_heads=HEADS, head_dim=HEAD_DIM,
              max_len=SEQ, attn_impl=attn_impl, dtype=torch.bfloat16, n_agents=n_agents,
              device=grid.device, seed=0)
    if grid is not None and attn_impl not in ("full", "flash"):
        kw["mesh"] = grid
    return TransformerLM(**kw)


def _spmd_tokens(dev):
    """Two agents' (B, T) tokens and targets, shifted on the global
    sequence: each agent counts up from its own start."""
    g = torch.Generator(device=dev).manual_seed(5)
    starts = torch.randint(0, VOCAB, (2, BATCH, 1), generator=g, device=dev)
    seq = (starts + torch.arange(SEQ + 1, device=dev) * 7) % VOCAB
    return seq[..., :-1], seq[..., 1:]


def _spmd_dense(layers, steps, dev):
    """The comparator: the two agents in one process (attn_impl "flash" at
    full T), the same Adam and the same Metropolis round each step:
    ``(per-step mean losses, (2, P) parameters after, (P,) init, (2, P)
    first step's gradients)``."""
    import torch.nn.functional as F

    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    class _Grid:
        device = dev

    dm = _spmd_model(_Grid, "flash", layers, n_agents=2)
    p0 = dm.flat_params[0].clone()
    dm.flat_grads.zero_()
    dm.flat_params.grad = dm.flat_grads
    opt = make_optimizer("adam", None, SPMD_LR)(dm.flat_params)
    X, Y = _spmd_tokens(dev)
    losses, grads, w = [], None, 1.0 / 3.0
    for _ in range(steps):
        dm.flat_grads.zero_()
        logits = dm(X)
        ce = F.cross_entropy(logits.reshape(-1, VOCAB), Y.reshape(-1), reduction="none")
        loss = ce.reshape(2, -1).mean(dim=1)
        loss.sum().backward()
        if grads is None:
            grads = dm.flat_grads.clone()
        opt.step()
        with torch.no_grad():
            p = dm.flat_params
            p.copy_(p * (1.0 - 2.0 * w) + p.flip(0) * w + p.flip(0) * w)
        losses.append(float(loss.mean()))
    out = dm.flat_params.detach().clone()
    del dm, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, out, p0, grads


def _spmd_run(grid, attn_impl, layers, steps, fa=None):
    """``make_gossip_lm_step`` on this rank for ``steps`` steps: the
    losses, each step's wall seconds and its split (compute, the K/V
    rotation, the gradient all_reduce over seq, the gossip exchange),
    the launches a rank, peak memory, and both agents' parameters after
    (gathered along agents, on rank 0's column) and the first step's
    gradient (summed over seq)."""
    from distributed_learning_tpu_torch.training.spmd_lm import (
        make_gossip_lm_step,
        stack_agent_states,
    )
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    dev = grid.device
    seq, agents = grid["seq"], grid["agents"]
    a, s = grid.coords["agents"], grid.coords["seq"]
    model = _spmd_model(grid, attn_impl, layers)
    opt = stack_agent_states(model, make_optimizer("adam", None, SPMD_LR), seed=0)
    step = make_gossip_lm_step(grid, model, opt)
    X, Y = _spmd_tokens(dev)
    t = SEQ // seq.size
    x, y = X[a][:, s * t:(s + 1) * t], Y[a][:, s * t:(s + 1) * t]
    # The gradient all_reduce over seq timed apart from the K/V rotation.
    real, reduce_s = seq.all_reduce, [0.0]

    def timed_reduce(tensor, op="sum"):
        t0 = time.perf_counter()
        out = real(tensor, op)
        reduce_s[0] += time.perf_counter() - t0
        return out

    seq.all_reduce = timed_reduce
    if fa is not None:
        fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, split, first_grads = [], [], [], None
    try:
        for _ in range(steps):
            seq.clock.reset()
            agents.clock.reset()
            reduce_s[0] = 0.0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
            if first_grads is None:  # the first step's gradient, summed over seq
                first_grads = model.flat_grads[0].clone()
            sc, ac = seq.clock, agents.clock
            seq_s = sc.d2h_s + sc.exchange_s + sc.h2d_s
            gossip_s = ac.d2h_s + ac.exchange_s + ac.h2d_s
            split.append({"compute_s": walls[-1] - max(seq_s, reduce_s[0]) - gossip_s,
                          "kv_rotation_s": max(seq_s - reduce_s[0], 0.0),
                          "grad_all_reduce_s": reduce_s[0], "gossip_s": gossip_s})
    finally:
        del seq.all_reduce
    launches = None if fa is None else {k.name: k.launches for k in fa.KERNELS.values()}
    bodies = None if fa is None else {k.name: dict(k.by_body) for k in fa.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated(dev)
    params = agents.all_gather(model.flat_params[0].detach())
    grads = agents.all_gather(first_grads)
    del model, opt, step, first_grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_seconds": walls, "split": split, "launches": launches,
            "bodies": bodies, "peak_memory_bytes": peak}, (params, grads)


def _sharded_lm_step(mesh, fa) -> dict:
    """The agents x seq LM step (agents 2 x seq 2) at the LM slice's full
    width with ring_flash, 3 steps, against the one-process comparator on
    rank 0 (losses, each agent's update); then ring and ulysses at a
    2-layer cut, one step each, against the comparator's 2-layer cut
    (the forward's loss and the step's gradient)."""
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh

    dev = mesh.device
    grid = GridMesh(SPMD_SHAPE, dev)
    a, s = grid.coords["agents"], grid.coords["seq"]
    checks, facts = {}, {"coords": grid.coords}
    run, (params, grads) = _spmd_run(grid, "ring_flash", LAYERS, SPMD_STEPS, fa)
    live = s + 1
    expect = {"flash_fwd": LAYERS * live * SPMD_STEPS, "flash_bwd_dq": LAYERS * live * SPMD_STEPS,
              "flash_bwd_dkv": LAYERS * live * SPMD_STEPS,
              "flash_bwd_rowterm": LAYERS * live * SPMD_STEPS}
    checks["launches"] = run["launches"] == expect
    checks["wgmma"] = all(run["bodies"][k]["wgmma"] == run["launches"][k]
                          for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    tokens = SPMD_SHAPE["agents"] * BATCH * SEQ
    run["tokens_per_s"] = tokens * SPMD_STEPS / sum(run["step_seconds"])
    run["expected_launches"] = expect
    facts["ring_flash"] = run
    cut = {}
    for impl in ("ring", "ulysses"):
        cut[impl] = _spmd_run(grid, impl, SPMD_CUT_LAYERS, 1)
    if mesh.agent == 0:
        dl, dp, p0, dg = _spmd_dense(LAYERS, SPMD_STEPS, dev)
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(run["losses"], dl))
        upd = [float((params[i] - dp[i]).norm() / (dp[i] - p0).norm()) for i in range(2)]
        grel = [float((grads[i] - dg[i]).norm() / dg[i].norm()) for i in range(2)]
        run.update(dense_losses=dl, loss_max_rel_err=loss_rel, update_rel_err=upd,
                   first_step_grad_rel_err=grel)
        checks.update(losses=loss_rel <= LOSS_RTOL, params=max(upd) <= GRAD_RTOL,
                      first_step_grads=max(grel) <= GRAD_RTOL)
        del dp, dg
        dl2, _, _, dg2 = _spmd_dense(SPMD_CUT_LAYERS, 1, dev)
        for impl, (r, (_p, g)) in cut.items():
            # One Adam step moves each parameter by about lr sign(g), so an
            # update read after one step counts sign flips of gradients
            # near 0; the cut holds the gradient of the step instead.
            lrel = abs(r["losses"][0] - dl2[0]) / abs(dl2[0])
            grel = [float((g[i] - dg2[i]).norm() / dg2[i].norm()) for i in range(2)]
            facts[impl] = dict(r, dense_losses=dl2, loss_max_rel_err=lrel, grad_rel_err=grel)
            checks[f"{impl}_loss"] = lrel <= LOSS_RTOL
            checks[f"{impl}_grads"] = max(grel) <= GRAD_RTOL
        del dg2
    else:
        for impl, (r, _pg) in cut.items():
            facts[impl] = r
    del params, grads, cut
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    facts["checks"] = checks
    _rank_emit(mesh, "lm_step", facts)
    return facts


# ---------------------------------------------------------------------- #
# Phase 34, ROADMAP item 5a: tensor parallelism with TP decode, FSDP,    #
# gossip x FSDP / TP and the expert-parallel MoE LM.                     #
# ---------------------------------------------------------------------- #
# limits (TOL); the TP and FSDP steps against the same model in one
# process (global B 4, the same Adam): losses within LOSS_RTOL, the first
# step's gradient (gathered from the blocks) within GRAD_RTOL.  TP decode
# runs a float32 copy (DECODE_F32_LOGITS_RTOL on the prefill logits;
# tokens equal, or a near-tie at the first step that differs).  The
# expert-parallel LM runs in float32 with the one-process run's routes
# replayed from the EP run's (route flips bounded by ROUTE_FLIP_F32_RTOL):
# both then compute one continuous function, and the logits and the
# step's gradient differ by float32 summation order only (the combine's
# all_reduce adds two partial sums), ~1e-6 expected; MOE_EP_RTOL is 100x
# that, and the control (a rank combining the other rank's experts)
# moves the logits by O(1).
MP_BATCH, MP_STEPS, MP_LR = 4, 2, 3e-4
MP_GOSSIP_LAYERS, MP_GOSSIP_BATCH = 2, 2
MP_W = [[0.75, 0.25], [0.25, 0.75]]
MP_GEN_BATCH, MP_GEN_PROMPT, MP_GEN_STEPS, MP_GEN_MQA_LAYERS = 4, 128, 16, 2
MP_GEN_CASES = (("mha", None, LAYERS), ("gqa", 2, LAYERS), ("mqa", 1, MP_GEN_MQA_LAYERS))
MOE_EP_LAYERS, MOE_EP_BATCH, MOE_EP_RTOL = 2, 2, 1e-4


def _mp_model(layers, dev, dtype=torch.bfloat16, **kw):
    from distributed_learning_tpu_torch.models.transformer import TransformerLM

    kw.setdefault("max_len", SEQ)
    kw.setdefault("attn_impl", "flash")
    return TransformerLM(vocab_size=VOCAB, num_layers=layers, num_heads=HEADS,
                         head_dim=HEAD_DIM, dtype=dtype, device=dev, seed=0, **kw)


def _mp_tokens(dev, lead, seed):
    """``lead + (SEQ,)`` tokens and their next-token targets: each row
    counts up by 7 from its own start."""
    g = torch.Generator(device=dev).manual_seed(seed)
    starts = torch.randint(0, VOCAB, tuple(lead) + (1,), generator=g, device=dev)
    seq = (starts + torch.arange(SEQ + 1, device=dev) * 7) % VOCAB
    return seq[..., :-1], seq[..., 1:]


def _mp_whole(model, line, flat) -> torch.Tensor:
    """The whole (P,) vector of a model-parallel model's ``flat`` (1, P
    local) buffer, its blocks gathered along ``line`` and laid out as the
    one-process model's buffer."""
    parts = line.all_gather(flat[0].contiguous())
    out = []
    for name, (off, size) in model.param_slices.items():
        shape = tuple(model.get_parameter(name).shape)
        blocks = [parts[r, off:off + size].view(shape) for r in range(line.size)]
        spec = model.layout.get(name, ())
        if any(spec):
            dim = 1 + next(d for d, ax in enumerate(spec) if ax is not None)
            out.append(torch.cat(blocks, dim).reshape(-1))
        else:
            out.append(blocks[0].reshape(-1))
    return torch.cat(out)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _mp_reference(dev, layers, X, Y, steps, lr=MP_LR, aux=0.0, routes=None, **kw):
    """The one-process comparator (rank 0): per-step losses and the first
    step's gradient of the same model and Adam on the whole batch; with
    ``routes`` the MoE blocks replay them (the route flip gaps kept)."""
    from distributed_learning_tpu_torch.models.moe import MoEMLP
    from distributed_learning_tpu_torch.training.tp import bind_optimizer, lm_loss
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    m = _mp_model(layers, dev, **kw)
    opt = bind_optimizer(m, make_optimizer("adam", None, lr))
    losses, g0, gaps, logits = [], None, [], None
    ctx = contextlib.nullcontext()
    if routes is not None:
        real, pos = MoEMLP._choose, [0]

        def choose(module, probs):
            taped = routes[pos[0] % len(routes)]
            pos[0] += 1
            gaps.append(route_flip_gaps(probs, real(module, probs), taped).cpu())
            return taped

        ctx = _patched(MoEMLP, "_choose", choose)
    with ctx:
        if routes is not None:
            with torch.no_grad():
                logits = m(X[None])[0]
        for _ in range(steps):
            m.flat_grads.zero_()
            loss = lm_loss(m, X, Y, aux)
            loss.backward()
            if g0 is None:
                g0 = m.flat_grads[0].clone()
            opt.step()
            losses.append(float(loss))
    del m, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, g0, (torch.cat(gaps) if gaps else None), logits


def _mp_launches(fa):
    return ({k.name: k.launches for k in fa.KERNELS.values()},
            {k.name: dict(k.by_body) for k in fa.KERNELS.values()})


def _mp_launch_checks(launches, bodies, fwd, bwd) -> dict:
    expect = {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd,
              "flash_bwd_rowterm": bwd}
    return {"launches": launches == expect,
            "wgmma": all(bodies[k]["wgmma"] == launches[k]
                         for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))}, expect


def _mp_tp_step(mesh, fa, X, Y) -> tuple:
    """The TP step on (data 2, model 2), 8 layers, global B 4, 2 steps;
    the control (every attention's exit all_reduce skipped) at the init.
    Returns (facts, checks, the first step's whole gradient, losses)."""
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training.tp import _rows, lm_loss, make_tp_train_step
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    dev = mesh.device
    grid = GridMesh({"data": 2, "model": 2}, dev)
    line = grid["model"]
    model = _mp_model(LAYERS, dev, tp_axis="model", mesh=grid)
    with torch.no_grad():
        saved = [b.attn.tp for b in model.blocks]
        for b in model.blocks:
            b.attn.tp = None
        try:
            control = float(lm_loss(model, _rows(X, grid["data"]), _rows(Y, grid["data"]), 0.0))
        finally:
            for b, t in zip(model.blocks, saved):
                b.attn.tp = t
    control = float(grid["data"].all_reduce(torch.tensor([control], device=dev))[0] / 2)
    step = make_tp_train_step(grid, model, make_optimizer("adam", None, MP_LR))
    whole = [(o, n) for name, (o, n) in model.param_slices.items() if not any(model.layout[name])]
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, split, g0, equal = [], [], [], None, []
    for _ in range(MP_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(X, Y)))
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        c = step.clock
        split.append({"compute_s": walls[-1] - c["model_s"] - c["data_s"],
                      "model_all_reduce_s": c["model_s"], "data_all_reduce_s": c["data_s"]})
        if g0 is None:
            g0 = _mp_whole(model, line, model.flat_grads)
        rep = torch.cat([model.flat_params[0, o:o + n] for o, n in whole])
        rows = line.all_gather(rep)
        equal.append(bool(torch.equal(rows[0], rows[1])))
    launches, bodies = _mp_launches(fa)
    checks, expect = _mp_launch_checks(launches, bodies, LAYERS * MP_STEPS, LAYERS * MP_STEPS)
    checks["whole_leaves_equal_on_model_line"] = all(equal)
    full_params = sum(math.prod(s) for s in model.full_shapes.values())
    state = sum(t.numel() * t.element_size() for st in step.optimizer.state.values()
                for t in st.values() if isinstance(t, torch.Tensor))
    facts = {"grid": dict(grid.coords), "losses": losses, "step_seconds": walls, "split": split,
             "tokens_per_s": MP_BATCH * SEQ * MP_STEPS / sum(walls),
             "launches": launches, "launches_by_body": bodies, "expected_launches": expect,
             "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
             "param_and_moment_bytes": model.flat_params.numel() * 4 + state,
             "replica_param_and_moment_bytes": full_params * 4 * 3,
             "whole_leaves_bitwise_equal": equal, "control_skipped_exit_loss": control}
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return facts, checks, g0, losses


def _mp_fsdp_step(mesh, fa, X, Y) -> tuple:
    """The FSDP step on data 4, 8 layers, B 1 a rank, 2 steps; the control
    (a reduce_scatter that keeps the neighbouring rank's block) on a
    fresh step.  Returns (facts, checks, first whole gradient, control's
    whole gradient)."""
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training.fsdp import make_fsdp_train_step
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    dev = mesh.device
    grid = GridMesh({"data": 4}, dev)
    data = grid["data"]

    def whole(step, buf):
        g = step.gather_params(buf)
        return torch.cat([g[n].reshape(-1) for n in step.model.param_slices])

    step = make_fsdp_train_step(grid, _mp_model(LAYERS, dev), make_optimizer("adam", None, MP_LR))
    gc.collect()
    torch.cuda.empty_cache()
    persistent = step.persistent_bytes()
    param_and_moments = persistent - step.grads.numel() * step.grads.element_size()
    full_params = step.model.param_count()
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, split, g0 = [], [], [], None
    for _ in range(MP_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(X, Y)))
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        t = step.timing
        split.append({"compute_s": walls[-1] - t["gather_s"] - t["reduce_scatter_s"],
                      "gather_s": t["gather_s"], "reduce_scatter_s": t["reduce_scatter_s"]})
        if g0 is None:
            g0 = whole(step, step.grads)
    launches, bodies = _mp_launches(fa)
    # The forward and the backward's recompute each launch A once a layer.
    checks, expect = _mp_launch_checks(launches, bodies, 2 * LAYERS * MP_STEPS,
                                       LAYERS * MP_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    real = data.reduce_scatter

    def neighbours(t):
        total = data.all_reduce(t.clone(), "sum")
        k = t.shape[0] // data.size
        nb = (data.agent + 1) % data.size
        return total[nb * k:(nb + 1) * k]

    step = make_fsdp_train_step(grid, _mp_model(LAYERS, dev), make_optimizer("adam", None, MP_LR))
    data.reduce_scatter = neighbours
    try:
        step(X, Y)
    finally:
        data.reduce_scatter = real
    control = whole(step, step.grads)
    facts = {"losses": losses, "step_seconds": walls, "split": split,
             "tokens_per_s": MP_BATCH * SEQ * MP_STEPS / sum(walls),
             "launches": launches, "launches_by_body": bodies, "expected_launches": expect,
             "peak_memory_bytes": peak, "persistent_bytes": persistent,
             "param_and_moment_bytes": param_and_moments,
             "replica_param_and_moment_bytes": full_params * 4 * 3,
             "param_and_moment_share": param_and_moments / (full_params * 4 * 3)}
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return facts, checks, g0, control


def _mp_generate(mesh) -> dict:
    """TP decode on (data 2, model 2) of float32 copies: MHA and 2 K/V
    heads at 8 layers, 1 K/V head (the replicated fallback) at 2; B 4, a
    128-token prompt, 16 greedy steps against the one-process generate;
    the control (the GQA cache swapped for the neighbouring head group
    after the prefill) must move the first step's logits past the limit."""
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training.tp import make_tp_generate

    dev = mesh.device
    grid = GridMesh({"data": 2, "model": 2}, dev)
    line, data = grid["model"], grid["data"]
    prompt, _ = _mp_tokens(dev, (MP_GEN_BATCH,), 11)
    prompt = prompt[:, :MP_GEN_PROMPT]
    b = MP_GEN_BATCH // 2
    rows = slice(data.agent * b, (data.agent + 1) * b)
    max_len = MP_GEN_PROMPT + MP_GEN_STEPS
    out, checks = {}, {}
    for kind, kv, layers in MP_GEN_CASES:
        kw = dict(max_len=max_len, num_kv_heads=kv, dtype=torch.float32)
        model = _mp_model(layers, dev, tp_axis="model", mesh=grid, **kw)
        gen = make_tp_generate(grid, model)
        with torch.no_grad():
            cache = model.init_cache(b)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            prefill = model(prompt[rows][None], cache)[0]
            torch.cuda.synchronize(dev)
            prefill_s = time.perf_counter() - t0
            ctrl = None
            if kind == "gqa":
                # The control: this rank's cache replaced by its neighbour's
                # head group, then the first decode step.
                for t in cache.keys + cache.values:
                    t.copy_(line.all_gather(t)[(line.agent + 1) % line.size])
                tok = prefill[:, -1].argmax(-1)
                ctrl = model(tok[None, :, None], cache)[0, :, -1]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        toks = gen(prompt, MP_GEN_STEPS)
        torch.cuda.synchronize(dev)
        gen_s = time.perf_counter() - t0
        cache_bytes = model.init_cache(b).nbytes()
        whole_cache = 2 * layers * MP_GEN_BATCH * max_len * (kv or HEADS) * HEAD_DIM * 4
        out[kind] = {"layers": layers, "num_kv_heads": kv, "tokens": toks,
                     "prefill_logits": prefill, "control_logits": ctrl,
                     "facts": {"prefill_s": prefill_s, "generate_s": gen_s,
                               "ms_per_decode_step": (gen_s - prefill_s) * 1e3 / MP_GEN_STEPS,
                               "rank_cache_bytes": cache_bytes,
                               "whole_cache_bytes": whole_cache,
                               "cache_share": cache_bytes / whole_cache}}
        del model, gen
        gc.collect()
        torch.cuda.empty_cache()
    return grid, prompt, out


def _mp_generate_reference(dev, prompt, kind, kv, layers) -> tuple:
    """The one-process generate's tokens, prefill logits, first decode
    step's logits and each step's top-2 gap relative to the row's largest
    |logit| (rank 0)."""
    from distributed_learning_tpu_torch.models.transformer import generate

    m = _mp_model(layers, dev, max_len=MP_GEN_PROMPT + MP_GEN_STEPS, num_kv_heads=kv,
                  dtype=torch.float32)
    with torch.no_grad():
        toks = generate(m, prompt[None], MP_GEN_STEPS)[0]
        cache = m.init_cache(MP_GEN_BATCH)
        logits = m(prompt[None], cache)[0]
        prefill = logits
        gaps, first = [], None
        tok = logits[:, -1].argmax(-1)
        for t in range(MP_GEN_STEPS):
            step = m(tok[None, :, None], cache)[0, :, -1]
            if first is None:
                first = step
            top = step.topk(2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]) / step.abs().max(dim=-1).values)
            tok = step.argmax(-1)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    # gaps[t] is the gap of the logits that pick token t + 1; token 0 comes
    # from the prefill.
    top = prefill[:, -1].topk(2, dim=-1).values
    gap0 = (top[:, 0] - top[:, 1]) / prefill[:, -1].abs().max(dim=-1).values
    return toks, prefill, first, torch.stack([gap0] + gaps[:-1], dim=1)


def _mp_gossip(mesh, fa, kind) -> tuple:
    """Gossip x FSDP on (agents 2, data 2) or gossip x TP on (agents 2,
    model 2), a 2-layer cut, B 2 an agent, 2 steps; then the mix alone on
    a random stacked state, and the control (W's rows swapped)."""
    from distributed_learning_tpu_torch.parallel.multihost import (
        GridMesh,
        MeshPosition,
        local_shard,
    )
    from distributed_learning_tpu_torch.training import gossip_fsdp as gf
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    dev = mesh.device
    inner_axis = "data" if kind == "fsdp" else "model"
    grid = GridMesh({"agents": 2, inner_axis: 2}, dev)
    agents = grid["agents"]
    X, Y = _mp_tokens(dev, (2, MP_GOSSIP_BATCH), 13)
    adam = make_optimizer("adam", None, MP_LR)
    if kind == "fsdp":
        model = _mp_model(MP_GOSSIP_LAYERS, dev)
        step = gf.make_gossip_fsdp_step(grid, model, adam, MP_W)
        flat = step.inner.flat
        views = step.inner.local_params()

        def whole_grads():
            g = step.inner.gather_params(step.inner.grads)
            return torch.cat([g[n].reshape(-1) for n in model.param_slices])

        pos = MeshPosition({"data": 2}, {"data": grid.coords["data"]})

        def block(name, full):
            return local_shard(full, step.inner.specs[name], pos, offset=1)

        def full_shape(name):
            return tuple(model.get_parameter(name).shape[1:])
    else:
        model = _mp_model(MP_GOSSIP_LAYERS, dev, tp_axis="model", mesh=grid)
        step = gf.make_gossip_tp_step(grid, model, adam, MP_W)
        flat = model.flat_params
        views = model.stacked_parameters()

        def whole_grads():
            return _mp_whole(model, grid["model"], model.flat_grads)

        def block(name, full):
            spec = model.layout[name]
            return local_shard(full, spec, model.position, offset=1) if any(spec) else full

        def full_shape(name):
            return model.full_shapes[name]
    fa.reset_launch_counts()
    losses, walls, g0 = [], [], None
    for _ in range(MP_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(X, Y)))
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        if g0 is None:
            g0 = agents.all_gather(whole_grads())
    launches, _ = _mp_launches(fa)
    # The mix alone on a random stacked state: this rank's block of each
    # agent's leaves, mixed, against the block of W @ state.
    g = torch.Generator(device=dev).manual_seed(17)
    state = {n: torch.randn((2,) + full_shape(n), generator=g, device=dev) for n in views}
    W = torch.tensor(MP_W, device=dev)
    errs = {}
    for tag, mix_ in (("mix", step.mix_), ("control_swapped_rows",
                                           gf._gossip(grid, MP_W[::-1], "agents")[0])):
        with torch.no_grad():
            saved = flat.clone()
            a = grid.coords["agents"]
            for n, v in views.items():
                v.copy_(block(n, state[n][a:a + 1]))
            mix_(flat)
            err = 0.0
            for n, v in views.items():
                want = block(n, torch.einsum("ab,b...->a...", W, state[n])[a:a + 1])
                err = max(err, float((v - want).abs().max()))
            flat.copy_(saved)
        errs[tag] = float(mesh.all_reduce(torch.tensor([err], device=dev), "max")[0])
    facts = {"losses": losses, "step_seconds": walls, "launches": launches,
             "mix_max_abs_err": errs["mix"],
             "control_swapped_rows_max_abs_err": errs["control_swapped_rows"]}
    del step, model, views, flat, state
    gc.collect()
    torch.cuda.empty_cache()
    return facts, g0, X, Y


def _mp_gossip_reference(dev, X, Y) -> tuple:
    """Two one-process agents (an n_agents=2 model, each with its own
    Adam moments), one W round after each update: mean losses, the first
    step's (2, P) gradient."""
    import torch.nn.functional as F

    from distributed_learning_tpu_torch.training.tp import bind_optimizer
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    m = _mp_model(MP_GOSSIP_LAYERS, dev, n_agents=2)
    opt = bind_optimizer(m, make_optimizer("adam", None, MP_LR))
    W = torch.tensor(MP_W, device=dev)
    losses, g0 = [], None
    for _ in range(MP_STEPS):
        m.flat_grads.zero_()
        logits = m(X)
        ce = F.cross_entropy(logits.reshape(-1, VOCAB), Y.reshape(-1), reduction="none")
        loss = ce.reshape(2, -1).mean(dim=1)
        loss.sum().backward()
        if g0 is None:
            g0 = m.flat_grads.clone()
        opt.step()
        with torch.no_grad():
            m.flat_params.copy_(W @ m.flat_params)
        losses.append(float(loss.mean()))
    del m, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, g0


def _mp_moe_ep(mesh) -> tuple:
    """The expert-parallel extras LM (rope, 2 K/V heads, 4 experts, top-2)
    on (data 2, expert 2), 2 layers, float32, B 2: the logits of this
    rank's row and one step's gradient; the routes this rank took; the
    control's logits (expert rank 1 combining rank 0's experts)."""
    from distributed_learning_tpu_torch.models.moe import MoEMLP
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training.tp import make_tp_train_step
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    dev = mesh.device
    grid = GridMesh({"data": 2, "expert": 2}, dev)
    X, Y = _mp_tokens(dev, (MOE_EP_BATCH,), 19)
    model = _mp_model(MOE_EP_LAYERS, dev, dtype=torch.float32, moe_expert_axis="expert",
                      mesh=grid, **EXTRAS)
    step = make_tp_train_step(grid, model, make_optimizer("adam", None, MP_LR),
                              model_axis="expert", moe_aux_coef=EXTRAS_AUX_COEF)
    routes, real = [], MoEMLP._choose

    def record(module, probs):
        choices = real(module, probs)
        routes.append([c.clone() for c in choices])
        return choices

    r = grid.coords["data"]
    row = slice(r, r + 1)
    with _patched(MoEMLP, "_choose", record):
        with torch.no_grad():
            logits = model(X[row][None])[0]
        loss = float(step(X, Y))
    grads = _mp_whole(model, grid["expert"], model.flat_grads)
    real_local = MoEMLP._local_experts

    def others(module):
        E_loc, e0 = real_local(module)
        return E_loc, (0 if module.ep is not None and module.ep.agent == 1 else e0)

    with _patched(MoEMLP, "_local_experts", others), torch.no_grad():
        control = model(X[row][None])[0]
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return X, Y, logits, loss, grads, routes, control


def _sharded_model_parallel(mesh, fa) -> dict:
    """ROADMAP item 5a's five parts on the 4 ranks (each regrouped into a
    GridMesh) at bench_lm's full width, each against its one-process
    comparator on rank 0, each with a control that must fail."""
    dev = mesh.device
    t_start = time.perf_counter()
    checks, facts = {}, {}
    X, Y = _mp_tokens(dev, (MP_BATCH,), 7)
    tp_facts, tp_checks, tp_g0, tp_losses = _mp_tp_step(mesh, fa, X, Y)
    fs_facts, fs_checks, fs_g0, fs_control = _mp_fsdp_step(mesh, fa, X, Y)
    checks.update({f"tp_{k}": v for k, v in tp_checks.items()})
    checks.update({f"fsdp_{k}": v for k, v in fs_checks.items()})
    gen_grid, prompt, gen = _mp_generate(mesh)
    gossip = {kind: _mp_gossip(mesh, fa, kind) for kind in ("fsdp", "tp")}
    for kind, (f, *_rest) in gossip.items():
        checks[f"gossip_{kind}_mix"] = f["mix_max_abs_err"] <= SHARDED_MIX_ATOL
        checks[f"gossip_{kind}_control_fails"] = f["control_swapped_rows_max_abs_err"] \
            > SHARDED_MIX_ATOL
    fa.reset_launch_counts()
    ep = _mp_moe_ep(mesh)
    # Float32: every launch on the CUDA-core bodies.
    facts["moe_ep_launches_by_body"] = _mp_launches(fa)[1]
    if mesh.agent != 0:  # the comparators run on rank 0
        tp_g0 = fs_g0 = fs_control = None
    if mesh.agent == 0:
        ref_losses, ref_g0, _, _ = _mp_reference(dev, LAYERS, X, Y, MP_STEPS)
        for tag, f, g0 in (("tp", tp_facts, tp_g0), ("fsdp", fs_facts, fs_g0)):
            f["reference_losses"] = ref_losses
            f["loss_max_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(f["losses"],
                                                                           ref_losses))
            f["first_step_grad_rel_err"] = _rel(g0, ref_g0)
            checks[f"{tag}_losses"] = f["loss_max_rel_err"] <= LOSS_RTOL
            checks[f"{tag}_first_step_grads"] = f["first_step_grad_rel_err"] <= GRAD_RTOL
        tp_facts["control_loss_rel_err"] = abs(tp_facts["control_skipped_exit_loss"]
                                               - ref_losses[0]) / abs(ref_losses[0])
        checks["tp_control_fails"] = tp_facts["control_loss_rel_err"] > LOSS_RTOL
        fs_facts["control_grad_rel_err"] = _rel(fs_control, ref_g0)
        checks["fsdp_control_fails"] = fs_facts["control_grad_rel_err"] > GRAD_RTOL
        del ref_g0
        gen_facts = {}
        for kind, kv, layers in MP_GEN_CASES:
            got = gen[kind]
            toks, prefill, first, gaps = _mp_generate_reference(dev, prompt, kind, kv, layers)
            b = MP_GEN_BATCH // 2
            prefill_err = _rel(got["prefill_logits"], prefill[:b])
            diff = (got["tokens"] != toks)
            ties = []
            for i in range(MP_GEN_BATCH):
                where = torch.nonzero(diff[i])
                if where.numel():
                    t = int(where[0])
                    ties.append({"row": i, "step": t, "reference_top2_gap": float(gaps[i, t])})
            f = dict(got["facts"], prefill_logits_rel_err=prefill_err, differing_tokens=ties,
                     tokens_equal=not ties)
            checks[f"generate_{kind}_prefill"] = prefill_err <= DECODE_F32_LOGITS_RTOL
            checks[f"generate_{kind}_tokens"] = all(t["reference_top2_gap"]
                                                    <= DECODE_F32_LOGITS_RTOL for t in ties)
            if got["control_logits"] is not None:
                f["control_first_step_rel_err"] = _rel(got["control_logits"], first[:b])
                checks["generate_control_fails"] = f["control_first_step_rel_err"] \
                    > DECODE_F32_LOGITS_RTOL
            gen_facts[kind] = f
        facts["tp_generate"] = gen_facts
        for kind, (f, g0, gx, gy) in gossip.items():
            ref_losses, ref_g0 = _mp_gossip_reference(dev, gx, gy)
            f["reference_losses"] = ref_losses
            f["loss_max_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(f["losses"],
                                                                           ref_losses))
            f["first_step_grad_rel_err"] = [_rel(g0[i], ref_g0[i]) for i in range(2)]
            checks[f"gossip_{kind}_losses"] = f["loss_max_rel_err"] <= LOSS_RTOL
            checks[f"gossip_{kind}_first_step_grads"] = max(f["first_step_grad_rel_err"]) \
                <= GRAD_RTOL
        X2, Y2, logits, loss, grads, routes, control = ep
        ref_losses, ref_g0, gaps, ref_logits = _mp_reference(
            dev, MOE_EP_LAYERS, X2, Y2, 1, aux=EXTRAS_AUX_COEF, routes=routes,
            dtype=torch.float32, **EXTRAS)
        flips = {"routes": sum(c.numel() for rt in routes for c in rt), "flips": int(gaps.numel()),
                 "max_gap": float(gaps.max()) if gaps.numel() else 0.0,
                 "limit": ROUTE_FLIP_F32_RTOL}
        ep_facts = {"loss": loss, "reference_loss": ref_losses[0],
                    "loss_rel_err": abs(loss - ref_losses[0]) / abs(ref_losses[0]),
                    "logits_rel_err": _rel(logits, ref_logits[:1]),
                    "grad_rel_err": _rel(grads, ref_g0), "route_flips": flips,
                    "control_logits_rel_err": _rel(control, ref_logits[:1])}
        checks["moe_ep_loss"] = ep_facts["loss_rel_err"] <= MOE_EP_RTOL
        checks["moe_ep_logits"] = ep_facts["logits_rel_err"] <= MOE_EP_RTOL
        checks["moe_ep_grads"] = ep_facts["grad_rel_err"] <= MOE_EP_RTOL
        checks["moe_ep_route_flips"] = flips["max_gap"] <= ROUTE_FLIP_F32_RTOL
        checks["moe_ep_control_fails"] = ep_facts["control_logits_rel_err"] > MOE_EP_RTOL
        facts["moe_ep"] = ep_facts
    else:
        facts["tp_generate"] = {k: g["facts"] for k, g in gen.items()}
    facts["tp_step"], facts["fsdp_step"] = tp_facts, fs_facts
    facts["gossip"] = {k: g[0] for k, g in gossip.items()}
    facts["seconds"] = time.perf_counter() - t_start
    del tp_g0, fs_g0, fs_control, gen, gossip, ep
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    facts["checks"] = checks
    _rank_emit(mesh, "model_parallel", facts)
    return facts


# ---------------------------------------------------------------------- #
# Phase 34, ROADMAP items 5b / 5c: the pipeline (training/pp*.py).       #
# ---------------------------------------------------------------------- #
# Stage 4 at the LM slice's full width: 2 layers a stage (1 a chunk for
# the interleaved schedule, V 2), M 8 microbatches of one sequence (the
# dense slice's 8 sequences), adam, 2 steps, each schedule against the
# one-process model on the same 8 sequences (LOSS_RTOL on each step's
# loss, GRAD_RTOL on each leaf's first-step gradient).  The compositions
# at 4 layers, 1F1B, M 4 of 2 sequences, one step; the MoE one at 2
# layers in float32 with the one-process run's routes replayed from the
# pipeline's (MOE_EP_RTOL, flips ROUTE_FLIP_F32_RTOL, as moe_ep).
PP_STAGES, PP_M, PP_STEPS, PP_V = 4, 8, 2, 2
PP_COMP_LAYERS, PP_COMP_M, PP_COMP_MB = 4, 4, 2
PP_MOE_LAYERS, PP_MOE_M = 2, 4
PP_SCHEDULES = ("gpipe", "remat", "1f1b", "interleaved")
PP_COMPOSITIONS = (("seq", {"stage": 2, "seq": 2}), ("model", {"stage": 2, "model": 2}),
                   ("data", {"data": 2, "stage": 2}))
# Per step and rank at stage 4 (2 layers x 8 microbatches): A once a layer
# and microbatch, twice where the backward recomputes (remat, 1F1B,
# interleaved); B, C and the pre-pass once.
PP_LAUNCHES = {"gpipe": (16, 16), "remat": (32, 16), "1f1b": (32, 16), "interleaved": (32, 16)}


def _pp_step(schedule, grid, model, tx, **kw):
    from distributed_learning_tpu_torch.training import pp_lm

    if schedule in ("gpipe", "remat"):
        return pp_lm.make_lm_pipeline_train_step(grid, model, tx,
                                                 remat_stage=schedule == "remat", **kw)
    if schedule == "1f1b":
        return pp_lm.make_lm_1f1b_train_step(grid, model, tx, **kw)
    return pp_lm.make_lm_interleaved_train_step(grid, model, tx, PP_V, PP_M, **kw)


def _pp_grads(step, grid) -> dict:
    """``{name: whole gradient}`` of every parameter of the pipelined
    model on the rank at coordinate 0 of every axis but the stage axis
    (``None`` elsewhere): blocks split over ``model`` / ``expert`` joined
    along that line, then every stage's gathered along the stage line."""
    import torch.distributed as dist

    model = step.model
    split = next((a for a in ("model", "expert") if a in grid.shape), None)
    names = list(model.param_slices)
    local = {n: step.grads[0, o:o + k].view(model.get_parameter(n).shape[1:])
             for n, (o, k) in model.param_slices.items()}
    if split is not None:
        line = grid[split]
        parts = line.all_gather(step.grads[0].contiguous())
        for n, (o, k) in model.param_slices.items():
            spec = model.layout.get(n, ())
            if any(spec):
                dim = next(d for d, ax in enumerate(spec) if ax is not None)
                local[n] = torch.cat([parts[r, o:o + k].view(local[n].shape)
                                      for r in range(line.size)], dim)
    stage = grid["stage"]
    flat = torch.cat([local[n].reshape(-1) for n in names])
    lists = [None] * stage.size
    dist.all_gather_object(lists, (names, [tuple(local[n].shape) for n in names]),
                           group=stage.group)
    flats = stage.all_gather(flat)
    if any(grid.coords[a] for a in grid.shape if a != "stage") or stage.agent != 0:
        return None
    out = {}
    for (ns, shapes), f in zip(lists, flats):
        off = 0
        for n, shp in zip(ns, shapes):
            k = math.prod(shp)
            out.setdefault(n, f[off:off + k].view(shp).clone())
            off += k
    return out


def _pp_reference(dev, layers, X, Y, steps, dtype=torch.bfloat16, aux=0.0, routes=None,
                  microbatches=1, **kw) -> tuple:
    """The one-process comparator (rank 0): per-step losses and the first
    step's ``{name: gradient}`` of the same model and Adam on the whole
    batch (``microbatches`` > 1: the mean of per-microbatch losses, as
    the pipeline routes an MoE model's microbatches apart; ``routes``
    ``{(layer, microbatch): choices}`` replayed, their flip gaps kept)."""
    from distributed_learning_tpu_torch.models.moe import MoEMLP
    from distributed_learning_tpu_torch.training.tp import bind_optimizer, lm_loss
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    m = _mp_model(layers, dev, dtype=dtype, **kw)
    opt = bind_optimizer(m, make_optimizer("adam", None, MP_LR))
    layer_of = {id(b.moe): i for i, b in enumerate(m.blocks) if hasattr(b, "moe")}
    losses, g0, gaps, cur = [], None, [], [0]
    ctx = contextlib.nullcontext()
    if routes is not None:
        real = MoEMLP._choose

        def choose(module, probs):
            taped = routes[(layer_of[id(module)], cur[0])]
            gaps.append(route_flip_gaps(probs, real(module, probs), taped).cpu())
            return taped

        ctx = _patched(MoEMLP, "_choose", choose)
    with ctx:
        for _ in range(steps):
            m.flat_grads.zero_()
            total = 0.0
            for i, (x, y) in enumerate(zip(X.chunk(microbatches), Y.chunk(microbatches))):
                cur[0] = i
                loss = lm_loss(m, x, y, aux) / microbatches
                loss.backward()
                total += float(loss)
            if g0 is None:
                g0 = {n: p.grad[0].clone() for n, p in m.stacked_parameters().items()}
            opt.step()
            losses.append(total)
    del m, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, g0, (torch.cat(gaps) if gaps else None)


def _pp_leaf_errs(got: dict, want: dict) -> dict:
    return {n: _rel(got[n], want[n]) for n in want}


def _pp_run(grid, fa, schedule, model, X, Y, steps, **kw) -> tuple:
    """One pipelined schedule for ``steps`` Adam steps: facts (losses, wall
    seconds, the split, tokens/s, bubble share, peak memory, launches)
    and the first step's gathered gradient."""
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    dev = grid.device
    step = _pp_step(schedule, grid, model, make_optimizer("adam", None, MP_LR), **kw)
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, split, g0 = [], [], [], None
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(X, Y)))
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        split.append(dict(step.timing))
        if i == 0:  # every rank gathers (rank 0 alone keeps the result)
            g0 = _pp_grads(step, grid)
    launches, bodies = _mp_launches(fa)
    S = grid.shape["stage"]
    M = X.shape[0]
    facts = {"grid": dict(grid.coords), "layers": step.layers, "losses": losses,
             "step_seconds": walls, "split": split, "stats": dict(step.stats),
             "tokens_per_s": X.numel() * steps / sum(walls),
             "bubble_share": [1.0 - s["stage_s"] / w for s, w in zip(split, walls)],
             "bubble_share_schedule": (S - 1) / (M + S - 1),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
             "launches": launches, "launches_by_body": bodies}
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return facts, g0


def _pp_control(grid, tag, X, Y) -> dict:
    """One 1F1B step at stage 4 with a fault in (every stage seeding its
    backward from the head; each input filed one stash slot off): the
    first step's gathered gradient."""
    from distributed_learning_tpu_torch.training import pp
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    real_put = pp._Stash.put
    fault = (_patched(pp, "_is_head_stage", lambda v, n: True) if tag == "head_every_stage"
             else _patched(pp._Stash, "put", lambda self, m, a: real_put(self, m + 1, a)))
    step = _pp_step("1f1b", grid, _mp_model(LAYERS, grid.device),
                    make_optimizer("adam", None, MP_LR))
    with fault:
        step(X, Y)
    g = _pp_grads(step, grid)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return g


def _pp_moe_ep(grid, fa, X, Y) -> tuple:
    """Stage 2 x expert 2: the extras' MoE options (no dropout) at 2
    layers in float32, 1F1B, one step; the routes each block took in its
    recompute, by (layer, microbatch)."""
    from distributed_learning_tpu_torch.models.moe import MoEMLP
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    model = _mp_model(PP_MOE_LAYERS, grid.device, dtype=torch.float32, mesh=grid,
                      moe_expert_axis="expert", **EXTRAS)
    layer_of = {id(b.moe): i for i, b in enumerate(model.blocks)}
    step = _pp_step("1f1b", grid, model, make_optimizer("adam", None, MP_LR),
                    expert_axis="expert", moe_aux_coef=EXTRAS_AUX_COEF)
    routes, state = {}, {"m": -1, "on": False}
    real_rec, real_choose = step.runner.recompute, MoEMLP._choose

    def recompute(c, a):  # the recomputes run in microbatch order
        state["m"] += 1
        state["on"] = True
        try:
            return real_rec(c, a)
        finally:
            state["on"] = False

    def choose(module, probs):
        ch = real_choose(module, probs)
        if state["on"]:
            routes[(layer_of[id(module)], state["m"])] = [c.clone() for c in ch]
        return ch

    step.runner.recompute = recompute
    fa.reset_launch_counts()
    with _patched(MoEMLP, "_choose", choose):
        loss = float(step(X, Y))
    launches, _ = _mp_launches(fa)
    g0 = _pp_grads(step, grid)
    import torch.distributed as dist

    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {k: [c.cpu() for c in v] for k, v in routes.items()})
    merged = {}
    for d in everyone:
        merged.update({k: [c.to(grid.device) for c in v] for k, v in d.items()})
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "launches": launches}, g0, merged


def _sharded_pipeline(mesh, fa) -> dict:
    """ROADMAP items 5b / 5c on the 4 ranks: GPipe, GPipe with remat, 1F1B
    and interleaved at stage 4, full width, against the one-process model;
    the two controls; the compositions (stage 2 x seq 2 with ring_flash,
    x model 2, data 2 x stage 2, x expert 2 with MoE)."""
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh

    dev = mesh.device
    t_start = time.perf_counter()
    checks, facts = {}, {}
    X, Y = _mp_tokens(dev, (PP_M,), 23)
    Xm, Ym = X[:, None], Y[:, None]                      # (M, 1, T): one sequence each
    grid = GridMesh({"stage": PP_STAGES}, dev)
    runs, grads = {}, {}
    total = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_rowterm"), 0)
    for schedule in PP_SCHEDULES:
        f, g0 = _pp_run(grid, fa, schedule, _mp_model(LAYERS, dev), Xm, Ym, PP_STEPS)
        fwd, bwd = PP_LAUNCHES[schedule]
        c, f["expected_launches"] = _mp_launch_checks(f["launches"], f["launches_by_body"],
                                                      fwd * PP_STEPS, bwd * PP_STEPS)
        checks.update({f"{schedule}_{k}": v for k, v in c.items()})
        for k in total:
            total[k] += f["launches"][k]
        runs[schedule], grads[schedule] = f, g0
    checks["1f1b_peak_below_gpipe"] = runs["1f1b"]["peak_memory_bytes"] \
        < runs["gpipe"]["peak_memory_bytes"]
    controls = {tag: _pp_control(grid, tag, Xm, Ym) for tag in ("head_every_stage", "slot_off")}
    comp = {}
    for tag, shape in PP_COMPOSITIONS:
        g = GridMesh(shape, dev)
        kw = {"seq": dict(attn_impl="ring_flash", mesh=g), "model": dict(tp_axis="model", mesh=g),
              "data": {}}[tag]
        Xc = X[:PP_COMP_M * PP_COMP_MB].reshape(PP_COMP_M, PP_COMP_MB, -1)
        Yc = Y[:PP_COMP_M * PP_COMP_MB].reshape(PP_COMP_M, PP_COMP_MB, -1)
        f, g0 = _pp_run(g, fa, "1f1b", _mp_model(PP_COMP_LAYERS, dev, **kw), Xc, Yc, 1,
                        **({"tp_axis": "model"} if tag == "model" else {}))
        # 2 layers a stage x 4 microbatches, A twice (1F1B); ring_flash
        # launches once a live ring block: seq position s has s + 1.
        live = g.coords["seq"] + 1 if tag == "seq" else 1
        c, f["expected_launches"] = _mp_launch_checks(f["launches"], f["launches_by_body"],
                                                      16 * live, 8 * live)
        checks.update({f"{tag}_{k}": v for k, v in c.items()})
        for k in total:
            total[k] += f["launches"][k]
        comp[tag] = (f, g0)
    gm = GridMesh({"stage": 2, "expert": 2}, dev)
    Xe = X[:PP_MOE_M].reshape(PP_MOE_M, 1, -1)
    Ye = Y[:PP_MOE_M].reshape(PP_MOE_M, 1, -1)
    moe, moe_g0, routes = _pp_moe_ep(gm, fa, Xe, Ye)
    for k in total:
        total[k] += moe["launches"][k]
    if mesh.agent == 0:
        ref_losses, ref_g0, _ = _pp_reference(dev, LAYERS, X, Y, PP_STEPS)
        for schedule, f in runs.items():
            errs = _pp_leaf_errs(grads[schedule], ref_g0)
            f["loss_max_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                        zip(f["losses"], ref_losses))
            f["first_step_grad_max_leaf_rel_err"] = max(errs.values())
            f["worst_leaf"] = max(errs, key=errs.get)
            f["reference_losses"] = ref_losses
            checks[f"{schedule}_losses"] = f["loss_max_rel_err"] <= LOSS_RTOL
            checks[f"{schedule}_first_step_grads"] = f["first_step_grad_max_leaf_rel_err"] \
                <= GRAD_RTOL
        for tag, g in controls.items():
            # The whole first-step gradient: a control may leave a leaf with
            # no gradient at all.
            err = _rel(torch.cat([g[n].reshape(-1) for n in ref_g0]),
                       torch.cat([ref_g0[n].reshape(-1) for n in ref_g0]))
            facts[f"control_{tag}_grad_rel_err"] = err
            checks[f"control_{tag}_fails"] = err > GRAD_RTOL
        del ref_g0, grads, controls
        ref_losses, ref_g0, _ = _pp_reference(dev, PP_COMP_LAYERS, X[:PP_COMP_M * PP_COMP_MB],
                                              Y[:PP_COMP_M * PP_COMP_MB], 1)
        for tag, (f, g0) in comp.items():
            errs = _pp_leaf_errs(g0, ref_g0)
            f["loss_rel_err"] = abs(f["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
            f["first_step_grad_max_leaf_rel_err"] = max(errs.values())
            checks[f"{tag}_loss"] = f["loss_rel_err"] <= LOSS_RTOL
            checks[f"{tag}_first_step_grads"] = f["first_step_grad_max_leaf_rel_err"] <= GRAD_RTOL
        ref_losses, ref_g0, gaps = _pp_reference(
            dev, PP_MOE_LAYERS, X[:PP_MOE_M], Y[:PP_MOE_M], 1, dtype=torch.float32,
            aux=EXTRAS_AUX_COEF, routes=routes, microbatches=PP_MOE_M, **EXTRAS)
        flat_ref = torch.cat([ref_g0[n].reshape(-1) for n in ref_g0])
        flat_got = torch.cat([moe_g0[n].reshape(-1) for n in ref_g0])
        moe.update(reference_loss=ref_losses[0],
                   loss_rel_err=abs(moe["loss"] - ref_losses[0]) / abs(ref_losses[0]),
                   grad_rel_err=_rel(flat_got, flat_ref),
                   route_flips={"routes": sum(c.numel() for v in routes.values() for c in v),
                                "flips": int(gaps.numel()),
                                "max_gap": float(gaps.max()) if gaps.numel() else 0.0,
                                "limit": ROUTE_FLIP_F32_RTOL})
        checks["moe_ep_loss"] = moe["loss_rel_err"] <= MOE_EP_RTOL
        checks["moe_ep_grads"] = moe["grad_rel_err"] <= MOE_EP_RTOL
        checks["moe_ep_route_flips"] = moe["route_flips"]["max_gap"] <= ROUTE_FLIP_F32_RTOL
        del ref_g0
    facts["schedules"] = runs
    facts["compositions"] = {k: v[0] for k, v in comp.items()}
    facts["moe_ep"] = moe
    facts["launches"] = total
    facts["seconds"] = time.perf_counter() - t_start
    del comp, moe_g0, routes
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    facts["checks"] = checks
    _rank_emit(mesh, "pipeline", facts)
    return facts


SHARDED_PARTS = ("engine", "wrn", "lm", "tracking", "superstep", "sharded_3b", "wrn_3b",
                 "ring_flash", "lm_step", "model_parallel", "pipeline")


def sharded_rank_main(args) -> int:
    """One rank of phase 34: join the group, run every part, write the
    facts for the parent; exit 1 if a check failed."""
    from distributed_learning_tpu_torch.ops import flash_attention as fa
    from distributed_learning_tpu_torch.parallel import multihost
    from distributed_learning_tpu_torch.parallel.consensus import make_agent_mesh

    rank = int(args.sharded_rank)
    cards = torch.cuda.device_count()
    dev = torch.device("cuda", rank if cards >= SHARDED_WORLD else 0)
    torch.cuda.set_device(dev)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = multihost.initialize(args.coordinator, SHARDED_WORLD, rank, device=dev,
                                   timeout_s=SHARDED_TIMEOUT_S)
    mesh = make_agent_mesh(SHARDED_WORLD, device=dev)
    emit({"phase": "sharded_rank", "rank": rank, "agent": mesh.agent, "world": mesh.size,
          "backend": backend, "device": str(dev), "card": torch.cuda.get_device_name(dev),
          "staged_through_host": mesh.staged})
    facts = {"rank": rank, "backend": backend, "device": str(dev)}
    facts["engine"] = _sharded_engine(mesh)
    facts["wrn"] = _sharded_wrn(mesh)
    facts["lm"] = _sharded_lm(mesh, fa)
    facts["tracking"] = _sharded_tracking(mesh)
    facts["superstep"] = _sharded_superstep(mesh)
    facts["sharded_3b"] = _sharded_3b(mesh)
    facts["wrn_3b"] = _sharded_wrn_3b(mesh)
    facts["ring_flash"] = _sharded_ring_flash(mesh, fa)
    facts["lm_step"] = _sharded_lm_step(mesh, fa)
    facts["model_parallel"] = _sharded_model_parallel(mesh, fa)
    facts["pipeline"] = _sharded_pipeline(mesh, fa)
    with open(os.path.join(args.sharded_out, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)
    mesh.barrier()
    torch.distributed.destroy_process_group()
    failed = [f"{part}.{k}" for part in SHARDED_PARTS
              for k, ok in facts[part].get("checks", {}).items() if not ok]
    if failed:
        print(f"rank {rank}: sharded checks failed: {failed}", file=sys.stderr, flush=True)
        return 1
    return 0


def _sass_by_kernel(lib: str) -> dict:
    """``{kernel: [instruction, ...]}`` of a built library from ``cuobjdump
    -sass``, without addresses and with the source file's anonymous
    namespace (a hash of its path) replaced, so two checkouts compare."""
    from distributed_learning_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_[A-Za-z0-9_]+?_cu_[0-9a-f]+", "ANON", text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name:
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return out


def sass_against(other: str) -> None:
    """Build the kernels of the checkout at ``other`` in a process of its
    own (this checkout's are built by then), then compare the two
    libraries' SASS kernel by kernel."""
    from distributed_learning_tpu_torch.ops import _build

    other = os.path.abspath(other)
    code = "from distributed_learning_tpu_torch.ops import _build; print(_build.load_library()._name)"
    there = subprocess.run([sys.executable, "-c", code], cwd=other, capture_output=True,
                           text=True, check=True, timeout=900,
                           env={**os.environ, "PYTHONPATH": other}).stdout.split()[-1]
    here = _build.load_library()._name
    a, b = _sass_by_kernel(there), _sass_by_kernel(here)
    both = sorted(set(a) & set(b))
    emit({"phase": "sass", "against": other, "kernels_in_both": len(both),
          "same": sum(a[k] == b[k] for k in both), "differ": [k for k in both if a[k] != b[k]],
          "only_against": sorted(set(a) - set(b)), "only_here": sorted(set(b) - set(a))})


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler window over one epoch of the slice")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the profiler table (with --profile)")
    ap.add_argument("--decode-timing", type=int, default=0, metavar="N",
                    help="only time the serving path's decode N times (MHA and GQA)")
    ap.add_argument("--step-timing", type=int, default=0, metavar="N",
                    help="only time the dense LM slice's training step N times")
    ap.add_argument("--sharded-only", action="store_true",
                    help="only build and run the sharded phase (34)")
    ap.add_argument("--wide-only", action="store_true",
                    help="only build, hold and time the wide (D > 256) bodies")
    ap.add_argument("--d256-only", action="store_true",
                    help="only build, hold (D 256 and 192) and time (D 256) the D-256 bodies")
    ap.add_argument("--d32-only", action="store_true",
                    help="only build, hold (D 32, 16 and 8) and time (D 32) the D-32 bodies "
                         "(A, B and C on wgmma)")
    ap.add_argument("--sass-against", default=None, metavar="DIR",
                    help="only build this checkout's kernels and those of the checkout at DIR "
                         "and compare their SASS kernel by kernel")
    # Set by the sharded phase for its rank processes.
    ap.add_argument("--sharded-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if args.sharded_rank is not None:
        return sharded_rank_main(args)
    from distributed_learning_tpu_torch.ops import flash_attention as fa

    t_start = time.perf_counter()
    # cuBLAS's deterministic workspace, read when its first handle is made;
    # the superstep phases compare runs bit for bit under it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0)})
    phase_build()
    if args.sass_against:
        sass_against(args.sass_against)
        print_card()
        return 0
    if args.decode_timing:
        decode_timing(fa, args.decode_timing)
        print_card()
        return 0
    if args.step_timing:
        step_timing(args.step_timing)
        print_card()
        return 0
    if args.wide_only or args.d256_only or args.d32_only or args.sharded_only:
        if args.wide_only:
            phase_kernels_wide(fa)
            phase_times_wide(fa)
            phase_times_f32_wide(fa)
        if args.d256_only:
            phase_kernels_d256(fa)
            phase_times_d256(fa)
        if args.d32_only:
            phase_kernels_d32(fa)
            phase_times_d32(fa)
        if args.sharded_only:
            phase_sharded()
        print_card()
        return 0
    # Seconds of each group of phases, in the done line.
    phase_seconds, last = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_seconds[name] = round(now - last[0], 2)
        last[0] = now

    main_errs, d32_errs, d256_errs, wide_errs = phase_kernels(fa)
    mark("kernels")
    master, launches, bodies = phase_slice(fa)
    if args.profile:
        phase_profile(master, args.out)
    del master
    gc.collect()
    torch.cuda.empty_cache()
    phase_plain(fa)
    times = _times_phase(fa, "times", HEADS, HEAD_DIM)
    times_d256 = phase_times_d256(fa)
    times_wide = phase_times_wide(fa)
    # The float32 CUDA-core bodies (the TP decode's float32 prefill and the
    # float32 MoE LMs run them; at D 256 dQ and dK/dV serve float32 only),
    # and the bf16 D-32 ones (A, B and C on wgmma).
    times_f32 = _times_phase(fa, "times_f32", HEADS, HEAD_DIM, torch.float32)
    times_f32_d256 = _times_phase(fa, "times_f32_d256", D256_HEADS, D256_HEAD_DIM,
                                  torch.float32)
    times_f32_wide = phase_times_f32_wide(fa)
    times_d32 = phase_times_d32(fa)
    gc.collect()
    torch.cuda.empty_cache()
    mark("slice_plain_times")
    # The paper's own path: no hand-written kernel on it.
    phase_conv_layout()
    master = phase_vision_slice(fa)
    if args.profile:
        phase_vision_profile(master, args.out)
    del master
    gc.collect()
    torch.cuda.empty_cache()
    phase_vision_plain()
    phase_zoo()
    mark("vision")
    # The epoch superstep: graph replays against the eager epochs.
    out = args.out if args.profile else None
    dense_timing = phase_superstep(out)
    ss_launches, lm_tokens_per_s = phase_lm_superstep(fa, out)
    phase_superstep_routes()
    mark("superstep")
    # CHOCO compressed gossip, its routes, and checkpoint/resume.
    phase_choco_slice(dense_timing)
    phase_choco_routes()
    phase_checkpoint()
    mark("choco_checkpoint")
    # Async and Byzantine-robust gossip: WRN slices and the routes.
    phase_async_slice(dense_timing)
    phase_robust_slice(dense_timing)
    phase_robust_routes()
    mark("async_robust")
    # Gradient tracking and EXTRA on the LM, push-sum, pairwise, interop.
    tracking_launches = phase_tracking_slice(fa)
    phase_tracking_routes()
    phase_pushsum_pairwise()
    phase_mixer_interop()
    mark("tracking_pushsum_interop")
    # The observability layer, LM eval and the training CLI.
    obs_jsonl = phase_obs_superstep(dense_timing)
    obs_lm = phase_obs_lm(fa)
    dense_mfu = obs_lm["mfu"]
    eval_launches = phase_lm_eval(fa, obs_lm)
    phase_cli(obs_jsonl)
    shutil.rmtree(_smoke_dir(SMOKE_OBS), ignore_errors=True)
    mark("obs_eval_cli")
    # The LM extras, remat and the serving path.
    extras_launches = phase_lm_extras(fa, {"superstep_tokens_per_s": lm_tokens_per_s,
                                           "mfu": dense_mfu})
    phase_lm_extras_plain(fa)
    remat_launches = phase_lm_remat(fa)
    prefill_launches = phase_lm_decode(fa)
    mark("extras_remat_decode")
    # A head dim the kernels run zero-padded, and the comm/ wire layer.
    head_dim_launches = phase_lm_head_dims(fa)
    d256_launches = phase_lm_head_dim_256(fa)
    d32_launches, d32_prefill_launches = phase_lm_head_dim_32(fa, times_d32)
    d512_launches, d512_prefill_launches = phase_lm_head_dim_512(fa, times_wide)
    mark("head_dims")
    phase_wire()
    mark("wire")
    # The comm/ runtime: gossip SGD over loopback TCP between the WRN agents.
    phase_comm_runtime()
    mark("comm_runtime")
    # The sharded engine on torch.distributed: one agent a rank process.
    sharded_launches, seq_launches, mp_launches, pp_launches = phase_sharded()
    mark("sharded")
    bodies_d256 = _bodies(fa, D256_HEAD_DIM, torch.bfloat16)
    bodies_f32 = _bodies(fa, HEAD_DIM, torch.float32)
    bodies_d32 = _bodies(fa, 32, torch.bfloat16)
    bodies_wide = _bodies(fa, WIDE_HEAD_DIM, torch.bfloat16)
    bodies_f32_wide = _bodies(fa, WIDE_HEAD_DIM, torch.float32)
    kernels = []
    for k in fa.KERNELS.values():
        t = times[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": SOURCES[k.name],
            "replaces": k.replaces, "launches": launches[k.name],
            "launches_by_path": {"slice": launches[k.name],
                                 "lm_superstep": ss_launches[k.name],
                                 "lm_tracking": tracking_launches[k.name],
                                 "lm_obs": obs_lm["launches"][k.name],
                                 "lm_eval": eval_launches[k.name],
                                 "lm_extras": extras_launches[k.name],
                                 "lm_remat": remat_launches[k.name],
                                 "lm_prefill": prefill_launches[k.name],
                                 "lm_head_dims": head_dim_launches[k.name],
                                 "lm_head_dim_256": d256_launches[k.name],
                                 "lm_head_dim_32": d32_launches[k.name],
                                 "lm_head_dim_32_prefill": d32_prefill_launches[k.name],
                                 "lm_head_dim_512": d512_launches[k.name],
                                 "lm_head_dim_512_prefill": d512_prefill_launches[k.name],
                                 "lm_sharded": sharded_launches[k.name],
                                 "seq_parallel": seq_launches[k.name],
                                 "model_parallel": mp_launches[k.name],
                                 "pipeline": pp_launches[k.name]},
            "body": "+".join(b for b, n in bodies[k.name].items() if n),
            "max_abs_err": main_errs[k.name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            # The D-256 bodies at 4 heads x 256 (bf16: A, B and C on
            # wgmma), held and timed in the kernels and times_d256
            # phases; lm_head_dim_256 launches them.
            "head_dim_256": {"body": bodies_d256[k.name], "max_abs_err": d256_errs[k.name],
                             **{f: times_d256[k.name][f] for f in
                                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
            # The float32 bodies (CUDA cores) at the slice's launch shape,
            # at 4 heads x 256 and at 2 heads x 512, and the bf16
            # head-dim-32 bodies at 32 heads x 32 (A, B and C on wgmma,
            # held in phase 2 at that width).
            **{tag: {"body": bodies_t[k.name], "dtype": dt, "heads": hh, "head_dim": dd,
                     **{f: tt[k.name][f] for f in
                        ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
               for tag, tt, bodies_t, dt, hh, dd in (
                   ("float32", times_f32, bodies_f32, "float32", HEADS, HEAD_DIM),
                   ("float32_head_dim_256", times_f32_d256, bodies_f32, "float32", D256_HEADS,
                    D256_HEAD_DIM),
                   ("float32_head_dim_wide", times_f32_wide, bodies_f32_wide, "float32",
                    WIDE_HEADS, WIDE_HEAD_DIM),
                   ("head_dim_32", times_d32, bodies_d32, "bfloat16", D32_HEADS, 32))},
            # Head dims above 256 at 2 heads x 512 (bf16: A on its wide
            # wgmma body, B and C on the wide CUDA-core bodies), held and
            # timed in the kernels and times_wide phases; lm_head_dim_512
            # launches them.
            "head_dim_wide": {"body": bodies_wide[k.name], "head_dim": WIDE_HEAD_DIM,
                              "max_abs_err": wide_errs[k.name],
                              **{f: times_wide[k.name][f] for f in
                                 ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        })
        kernels[-1]["head_dim_32"]["max_abs_err"] = d32_errs[k.name]
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 2),
          "phase_seconds": phase_seconds})
    emit({"kernels": kernels})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
