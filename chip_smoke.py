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
    kernels = []
    for k in fa.KERNELS.values():
        t = times[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": SOURCES[k.name],
            "replaces": k.replaces, "launches": launches[k.name],
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
