#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``distributed_learning_tpu_torch``) on
one NVIDIA card: the quickest proof that the port builds and trains there.

    python3 chip_smoke.py [--profile] [--out DIR]

Phases, each printing one JSON line (any failure exits non-zero):

1. build   — compile ``csrc/*.cu`` with nvcc, one process per source, all
             together; prints the seconds and each kernel's registers and
             spills as ptxas reports them.
2. kernels — each flash-attention kernel and the backward's pre-pass
             against its plain PyTorch version on the same card tensors:
             the slice's launch shape (4 agents x B 2 x 8 heads, T 4096,
             head dim 128, bf16, causal; there the limits must also reject
             a dQ whose first Q tile and a dK or dV whose last key tile is
             zeroed), the lse cotangent (``dadj``) path, a
             windowed ragged case, a non-causal case, head-dim-64 cases,
             the edges of the wgmma bodies' 128-row tiles (T 64, T 129, a
             window of 100 over T 1000, non-causal T 333), the CUDA-core
             bodies (float32, bf16 head dim 32) and head dims the kernels
             run zero-padded (8, 16, 48, 96; float32 16).
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
             ``scaled_dot_product_attention``'s time as a yardstick (none
             for the pre-pass, which no one PyTorch call computes).
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
26. cli    — ``cli.main`` in process: WRN-28-10 on synthetic CIFAR, 4
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
             ``SMALL_LM_LOSS_RTOL``); kernel launches counted.
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

Then a ``kernels`` JSON line, the card's name and power limit as
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


def emit(obj) -> None:
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
    """``{kernel<dtype,D>: "R regs, S spill bytes"}`` from ptxas -v."""
    out, name, spills = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"[0-9](flash_[a-z_0-9]+?kernel(?:_sm90)?)I(13__nv_bfloat16|f)?Li(\d+)E", line)
        if m:
            dtype = {"13__nv_bfloat16": "bf16,", "f": "f32,", None: ""}[m.group(2)]
            name = f"{m.group(1)}<{dtype}{m.group(3)}>"
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
            for D in (64, 128)}
    emit({"phase": "build", "sources": sorted(set(SOURCES.values())),
          "seconds": round(seconds, 3), "ptxas": ptxas_summary(_build.ptxas_report()),
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
    del o, o2, lse
    dadj = None
    if with_lse_grad:
        g = torch.Generator(device=DEVICE).manual_seed(7)
        dadj = torch.randn(B, H, T, generator=g, device=DEVICE)
    pdq = fa.plain_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, window)
    dq = fa.flash_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, window)
    torch.cuda.synchronize()
    check("dq", dq, pdq, "grad")
    rejected = {}
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
        # show.
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out, l_out = fa.flash_attention_with_lse(qq, kk, vv, causal=causal)
        grads = torch.autograd.grad((out, l_out), (qq, kk, vv), (do, dadj))
        pipeline = [fa.plain_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, None),
                    *fa.plain_bwd_dkv(q, k, v, po, do, plse, dadj, scale, causal, None)]
        names = ("lse_fn.dq", "lse_fn.dk", "lse_fn.dv")
        if fa.kernel_head_dim(D) == D:
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
    res["body"] = "wgmma" if fa.wgmma_body(dtype, fa.kernel_head_dim(D)) else "cuda_core"
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
    # The CUDA-core bodies.
    _compare_case(fa, "f32_head_dim_32", 2, 333, 2, 32, f32, True, None, True)
    _compare_case(fa, "bf16_head_dim_32", 2, 200, 2, 32, bf16, True, None, True)
    # Head dims the kernels do not have, zero-padded to the next of 32, 64
    # and 128: 8 and 16 on the CUDA-core bodies, 48 and 96 on wgmma.
    _compare_case(fa, "head_dim_8", 2, 200, 2, 8, bf16, True, None, False)
    _compare_case(fa, "head_dim_16_dadj", 2, 512, 4, 16, bf16, True, None, True)
    _compare_case(fa, "head_dim_48", 2, 768, 4, 48, bf16, True, None, False)
    _compare_case(fa, "head_dim_96_non_causal_dadj", 2, 384, 2, 96, bf16, False, None, True)
    _compare_case(fa, "f32_head_dim_16_window", 2, 333, 2, 16, f32, True, 64, False)
    torch.cuda.empty_cache()
    return main


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
                 batch=BATCH, dims=None, **trainer_kwargs):
    """The slice's trainer; ``dims`` (``vocab``, ``heads``, ``head_dim``,
    ``seq``) replaces the slice's widths."""
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
        n_agents=agents, device=DEVICE, seed=seed, **(model_kwargs or {}),
    )
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
def phase_times(fa):
    import torch.nn.functional as F

    B, T, H, D = AGENTS * BATCH, SEQ, HEADS, HEAD_DIM
    q, k, v, do = _qkv(B, T, H, D, torch.bfloat16, seed=11)
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, True, None, with_lse=True)
    pairs = B * H * T * (T + 1) // 2  # live (row, col) pairs of the causal mask
    elem = B * T * H * D * 2          # bytes of one bf16 (B, T, H, D) tensor
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
    peak = dict.fromkeys(work, PEAK_BF16_FLOPS)
    peak["flash_bwd_rowterm"] = PEAK_FP32_FLOPS
    kernel_fn = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, scale, True, None, with_lse=True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, o, do, lse, None, scale, True, None,
                                                rowterm=rowterm),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, o, do, lse, None, scale, True, None,
                                                  rowterm=rowterm),
        "flash_bwd_rowterm": lambda: fa.flash_bwd_rowterm(o, do, None),
    }
    plain_fn = {
        "flash_fwd": lambda: fa.plain_fwd(q, k, v, scale, True, None, with_lse=True),
        "flash_bwd_dq": lambda: fa.plain_bwd_dq(q, k, v, o, do, lse, None, scale, True, None),
        "flash_bwd_dkv": lambda: fa.plain_bwd_dkv(q, k, v, o, do, lse, None, scale, True, None),
        "flash_bwd_rowterm": lambda: fa.plain_bwd_rowterm(o, do, None),
    }
    # Yardstick only: one PyTorch call per function (SDPA forward; SDPA's
    # backward, which computes dQ, dK and dV in one call, for B and C).
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 5)
    out_h = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out_h, (qh, kh, vh), doh, retain_graph=True), 5)
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
        t_ops, t_bytes = flops / peak[name] * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        ms = cuda_ms(kernel_fn[name], 5)
        times[name] = {
            "ms": ms,
            "tflops": flops / ms / 1e9,
            "plain_ms": cuda_ms(plain_fn[name], 2),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[name],
            "flops": flops, "bytes": nbytes,
        }
        torch.cuda.empty_cache()
    emit({"phase": "times", "shape": [B, T, H, D], "dtype": "bfloat16", "causal": True,
          **{k: {kk: (round(vv, 4) if isinstance(vv, float) else vv) for kk, vv in t.items()}
             for k, t in times.items()}})
    return times


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


# The CLI phase's model and data flags (the baseline notebook's WRN-28-10
# at the WRN slice's batch), and flags every training run gets (none on
# the card: the CLI's default device is the card).
CLI_MODEL = ["--net_type", "wide-resnet", "--depth", "28", "--widen_factor", "10",
             "--dropout", "0.3", "--dataset", "cifar10"]
CLI_DATA = ["--nodes", "4", "--batch-size", "256", "--n-train", "4096"]
CLI_EVERY_RUN: list = []


def phase_cli(obs_jsonl):
    """``cli.main`` in process, WRN-28-10 on synthetic CIFAR (4 nodes x B
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
                  dtype=torch.bfloat16, **kw):
    from distributed_learning_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=VOCAB, num_layers=layers, num_heads=HEADS,
                         head_dim=HEAD_DIM, max_len=max_len, attn_impl="flash",
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


def _decode_prompt():
    rng = np.random.default_rng(31)
    return torch.as_tensor(rng.integers(0, VOCAB, (1, DECODE_BATCH, DECODE_PREFILL)),
                           device=DEVICE)


def time_decode(fa, model, prompt):
    """``generate``'s times by the prefill-subtracted protocol
    (``bench_lm.py:112``): after a warm-up, the prefill alone (one token)
    and the whole of ``DECODE_STEPS`` steps.  Returns (prefill seconds,
    generate seconds, the prefill's launch counts)."""
    from distributed_learning_tpu_torch.models.transformer import generate

    for n in (1, DECODE_STEPS):  # warm-up
        generate(model, prompt, n)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    generate(model, prompt, 1)
    torch.cuda.synchronize()
    dt_prefill = time.perf_counter() - t0
    launches = _launches(fa)
    t0 = time.perf_counter()
    generate(model, prompt, DECODE_STEPS)
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
            and bodies["flash_fwd"]["cuda_core"] >= per and not bodies["flash_fwd"]["wgmma"]):
        raise AssertionError(f"head dim 16 launches {launches} {bodies}: want the CUDA-core "
                             "bodies once a layer and step")
    return launches


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
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
    if args.decode_timing:
        decode_timing(fa, args.decode_timing)
        print_card()
        return 0
    main_errs = phase_kernels(fa)
    master, launches, bodies = phase_slice(fa)
    if args.profile:
        phase_profile(master, args.out)
    del master
    gc.collect()
    torch.cuda.empty_cache()
    phase_plain(fa)
    times = phase_times(fa)
    gc.collect()
    torch.cuda.empty_cache()
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
    # The epoch superstep: graph replays against the eager epochs.
    out = args.out if args.profile else None
    dense_timing = phase_superstep(out)
    ss_launches, lm_tokens_per_s = phase_lm_superstep(fa, out)
    phase_superstep_routes()
    # CHOCO compressed gossip, its routes, and checkpoint/resume.
    phase_choco_slice(dense_timing)
    phase_choco_routes()
    phase_checkpoint()
    # Async and Byzantine-robust gossip: WRN slices and the routes.
    phase_async_slice(dense_timing)
    phase_robust_slice(dense_timing)
    phase_robust_routes()
    # Gradient tracking and EXTRA on the LM, push-sum, pairwise, interop.
    tracking_launches = phase_tracking_slice(fa)
    phase_tracking_routes()
    phase_pushsum_pairwise()
    phase_mixer_interop()
    # The observability layer, LM eval and the training CLI.
    obs_jsonl = phase_obs_superstep(dense_timing)
    obs_lm = phase_obs_lm(fa)
    dense_mfu = obs_lm["mfu"]
    eval_launches = phase_lm_eval(fa, obs_lm)
    phase_cli(obs_jsonl)
    shutil.rmtree(_smoke_dir(SMOKE_OBS), ignore_errors=True)
    # The LM extras, remat and the serving path.
    extras_launches = phase_lm_extras(fa, {"superstep_tokens_per_s": lm_tokens_per_s,
                                           "mfu": dense_mfu})
    phase_lm_extras_plain(fa)
    remat_launches = phase_lm_remat(fa)
    prefill_launches = phase_lm_decode(fa)
    # A head dim the kernels run zero-padded, and the comm/ wire layer.
    head_dim_launches = phase_lm_head_dims(fa)
    phase_wire()
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
                                 "lm_head_dims": head_dim_launches[k.name]},
            "body": "+".join(b for b, n in bodies[k.name].items() if n),
            "max_abs_err": main_errs[k.name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 2)})
    emit({"kernels": kernels})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
