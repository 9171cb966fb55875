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
             window of 100 over T 1000, non-causal T 333) and the CUDA-core
             bodies (float32, bf16 head dim 32).
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
             learning-rate schedule, ``adaptive_comm`` and ``mix_eps`` on
             the MLP (784 -> 150, 4 agents x B 64): graph against eager, and
             the host syncs per superstep (0 for every fixed-count one).

Then a ``kernels`` JSON line, the card's name and power limit as
``nvidia-smi`` gives them, and the last line
``{"ok": true, "device": {...}}``.  With no CUDA device it exits non-zero
before any phase.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
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
        # route the lse cotangent into both kernels as dadj.
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out, l_out = fa.flash_attention_with_lse(qq, kk, vv, causal=causal)
        grads = torch.autograd.grad((out, l_out), (qq, kk, vv), (do, dadj))
        pdq = fa.plain_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, None)
        pdk, pdv = fa.plain_bwd_dkv(q, k, v, po, do, plse, dadj, scale, causal, None)
        for name, a, b in zip(("lse_fn.dq", "lse_fn.dk", "lse_fn.dv"), grads, (pdq, pdk, pdv)):
            check(name, a, b, "grad")
    res["max_abs_err"] = {k: v[0] for k, v in errs.items()}
    res["max_tile_rel_err"] = {k: v[1] for k, v in errs.items()
                               if k not in ("fwd_lse.lse", "rowterm")}
    res["body"] = "wgmma" if fa.wgmma_body(dtype, D) else "cuda_core"
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
    torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------- #
# Phase 3: the slice                                                     #
# ---------------------------------------------------------------------- #
def pattern_batch(n_seq: int, phases, rng: np.random.Generator):
    """Cyclic token windows ``x[t] = (start + t) % VOCAB`` from the given
    start phases (shuffled by ``rng``); y is the next token.  A window
    covers half the cycle, so each agent's quarter of start phases hides
    transitions the others see."""
    starts = rng.choice(np.asarray(list(phases)), size=n_seq)
    seq = (starts[:, None] + np.arange(SEQ + 1)[None, :]) % VOCAB
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def make_trainer(attn_impl, layers, agents, epochs, steps, seed=0):
    from distributed_learning_tpu_torch.models import TransformerLM
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training.trainer import MasterNode

    rng = np.random.default_rng(seed)
    quarter = VOCAB // agents
    nodes = list(range(agents))
    train = {a: pattern_batch(steps * BATCH, range(quarter * a, quarter * (a + 1)), rng)
             for a in nodes}
    test = pattern_batch(4, range(VOCAB), rng)
    model = TransformerLM(
        vocab_size=VOCAB, num_layers=layers, num_heads=HEADS, head_dim=HEAD_DIM,
        max_len=SEQ, attn_impl=attn_impl, dtype=torch.bfloat16,
        n_agents=agents, device=DEVICE, seed=seed,
    )
    master = MasterNode(
        nodes, model, optimizer="adam", optimizer_kwargs={"lr": 1e-3},
        weights=Topology.ring(agents), train_loaders=train, test_loader=test,
        stat_step=1, epoch=epochs, epoch_len=steps, batch_size=BATCH,
        mix_times=1, eval_batch_size=2, seed=seed, device=DEVICE,
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

    return real, broken


def phase_plain(fa):
    """One training step of 2 agents x 2 layers at full width, through the
    kernels and through plain attention from identical weights: loss and
    every leaf's gradient, per agent.  A control run with a dK/dV that
    drops key tile 0 must fail the same limits."""
    from distributed_learning_tpu_torch.convert import flax_to_torch, torch_to_flax

    agents, layers = 2, 2
    out = {}
    weights = None
    real, broken = _drop_first_key_tile(fa)
    for run, impl in (("flash", "flash"), ("full", "full"), ("control", "flash")):
        master = make_trainer(impl, layers, agents, 1, 1)
        if weights is None:
            weights = flax_to_torch(torch_to_flax(
                {k: v.detach().cpu().numpy().copy()
                 for k, v in master.model.stacked_parameters().items()}
            ), n_agents=agents)
        master.initialize_nodes(params=weights)
        fa.flash_bwd_dkv = broken if run == "control" else real
        try:
            p = master.train_epoch()
        finally:
            fa.flash_bwd_dkv = real
        out[run] = (p["train_loss"], leaf_grads(master.model))
        del master
        gc.collect()
        torch.cuda.empty_cache()
    loss_rtol, grad_rtol = LOSS_RTOL, GRAD_RTOL
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
        verdict[run]["ok"] = (verdict[run]["loss_rel_err"] <= loss_rtol
                              and errs[worst] <= grad_rtol)
    ok = verdict["flash"]["ok"] and not verdict["control"]["ok"]
    emit({"phase": "plain", "agents": agents, "layers": layers,
          "loss": {k: v[0].tolist() for k, v in out.items()},
          "limits": {"loss_rtol": loss_rtol, "grad_rtol": grad_rtol},
          **verdict, "ok": ok})
    if not ok:
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
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd,
               "flash_bwd_rowterm": None}
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
                       optimizer_kwargs=None, augment=False, dropout=True, **model_kwargs):
    """``MasterNode`` over ``agents`` nodes on a Metropolis ring, on
    normalized synthetic CIFAR-10 dealt by ``shard_dataset``."""
    from distributed_learning_tpu_torch.data import normalized_pad_value, shard_dataset
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training.trainer import MasterNode

    (x, y), test = _cifar(agents * batch * steps, n_test)
    nodes = list(range(agents))
    master = MasterNode(
        nodes, model, model_args=(10,), optimizer="sgd",
        optimizer_kwargs=dict(optimizer_kwargs or WRN_SGD),
        weights=Topology.ring(agents), train_loaders=shard_dataset(x, y, nodes, batch_size=batch),
        test_loader=test, stat_step=1, epoch=epochs, epoch_len=steps, batch_size=batch,
        mix_times=1, eval_batch_size=WRN_EVAL, seed=0, device=device, augment=augment,
        augment_pad_value=normalized_pad_value(), dropout=dropout, model_kwargs=model_kwargs,
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


def trainer_record(master, payloads) -> dict:
    """Every value a run leaves behind, as tensors: parameters, running
    statistics, optimizer state, and the payloads' per-epoch traces,
    round counts, deviations and the last test accuracy."""
    # On the host: four runs of the LM's state would not fit the card
    # beside a live trainer.
    rec = {"params": master.model.flat_params.to("cpu", copy=True),
           "stats": master.model.flat_stats.to("cpu", copy=True)}
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


def superstep_equality(make, k=SUPERSTEP_K, control=True):
    """``make()`` builds a fresh initialised trainer on the card (same
    init and seeds each time).  Under deterministic algorithms: two eager
    runs of ``k`` ``train_epoch()`` calls (their spread is the limit; it
    is 0 when they agree bit for bit), the superstep ``train_epochs(k)``
    as graph replays, and (``control``) a superstep with stale indices,
    which must exceed the limit.  Returns the verdict and the graph run's
    trainer facts."""
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
            runs[run] = trainer_record(master, payloads)
            if run == "graph":
                facts = {"mix_rounds": [p["mix_rounds"] for p in payloads]}
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


def superstep_timing(make, samples_per_epoch, unit, k=SUPERSTEP_K, profile_to=None):
    """Epoch wall times of the eager loop and of the superstep on one
    fresh trainer (default, non-deterministic algorithms): ``k`` eager
    epochs, then two supersteps of ``k`` (the first captures its graphs);
    the steady rates come from the last eager epoch and the second
    superstep.  With ``profile_to`` a third superstep runs under
    ``torch.profiler``."""
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


def phase_superstep(out_dir=None):
    """WRN-28-10 as vision_slice runs it (4 agents x B 256, bf16, dropout
    0.3, augmentation, SGD): the graph superstep of 3 epochs against 3
    eager epochs, bit for bit (or within two eager runs' spread), the
    stale-index control, then the eager and superstep epoch times."""
    verdict, facts = superstep_equality(_wrn_master)
    emit({"phase": "superstep", "model": "wrn-28-10", "k": SUPERSTEP_K, **facts, **verdict})
    if not verdict["ok"]:
        raise AssertionError("WRN superstep disagrees with the eager epochs, or the "
                             "stale-index control was not rejected")
    if facts["host_syncs_per_superstep"] != 0:
        raise AssertionError(f"WRN superstep synchronised: {facts}")
    timing = superstep_timing(_wrn_master, WRN_AGENTS * WRN_BATCH * WRN_STEPS, "samples",
                              profile_to=None if out_dir is None
                              else (out_dir, "profile_wrn_superstep.txt"))
    emit({"phase": "superstep_timing", "model": "wrn-28-10", **timing})


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
    return launches


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler window over one epoch of the slice")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the profiler table (with --profile)")
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
    phase_superstep(out)
    ss_launches = phase_lm_superstep(fa, out)
    phase_superstep_routes()
    kernels = []
    for k in fa.KERNELS.values():
        t = times[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": SOURCES[k.name],
            "replaces": k.replaces, "launches": launches[k.name],
            "launches_by_path": {"slice": launches[k.name],
                                 "lm_superstep": ss_launches[k.name]},
            "body": "+".join(b for b, n in bodies[k.name].items() if n),
            "max_abs_err": main_errs[k.name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 2)})
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a",
          flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
