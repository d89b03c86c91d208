#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-dir DIR] [--seed N] [--phases A,B]
                          [--parent DIR]

Phases, each printing one JSON line (any failure exits nonzero and prints
no result line):

1. device  — CUDA must be available; prints the card's name and power
             limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build   — compiles every kernel source under
             ``mxnet_tpu_torch/kernels/csrc/`` with nvcc (all in parallel);
             reports each kernel's registers and spill bytes (ptxas).
3. kernel  — the flash prefill kernel against its plain PyTorch version
             on the card at the serving path's shapes: q (1, 8, C, 64)
             against k/v (1, 8, 512, 64) float32, C in {64, 256}, at
             several global offsets including a ring-style one whose rows
             are all masked. Max abs error on out and lse <= 1e-4 (float32
             with a different summation order); fully masked rows must
             hold lse == -1e30 and out == 0 exactly. Device times per
             call from CUDA graphs of 20 calls replayed between CUDA events
             (median of 7, inputs warm in L2 as on the serving path, where
             k/v were just gathered): kernel, plain version, and
             ``F.scaled_dot_product_attention`` as a yardstick only; the
             kernel's eager per-call time (wrapper overhead included); and
             the card's bound for the same work. Every attention kernel's
             bound prices its operations as float32-accurate products on
             the tensor cores: three TF32 products each at the 495 TFLOP/s
             dense TF32 rate (the larger of that and its bytes at 3.35
             TB/s); the CUDA-core float32 figure (67 TFLOP/s) of earlier
             slices stays beside it as bound_cuda_core_ms.
4. serve   — full-width transformer decode (vocab 32000, 12 layers, 8
             heads, d_model 512, max_len 512, random weights from a seeded
             generator) through the port's DecodeEngine: 8 prompts of 5-480
             tokens (three longer than the 256-token prefill chunk), 32 new
             tokens each. Checks: all served, the kernel launched 12 times
             per prefill call, program_counts() == (2, 1), no KV block
             left live, every stream equal to the same prompt decoded solo
             (bit identity under continuous batching), and a full 12-layer
             prefill through the kernel agreeing with the plain tier's
             pages within 1e-4.
5. profile — host wall against traced device time per call of the two
             serving programs (the batch-8 step and a 256-token prefill
             chunk), so the device's idle share; with --profile-dir the
             profiler tables go to DIR/profile_*.txt.
6. train_kernel — the training forward kernel (flash_fwd.cu) and the
             backward pair (flash_bwd_offs.cu) against their plain
             versions on the card, float32: q/k/v (8, 8, 512, 64) causal
             (the train phase's shape), a non-causal ragged case, head dims
             32 and 128 (ragged, and 128 at (8, 8, 512) causal); and
             flash_attention_with_lse's gradients through
             its autograd Function at the kernel phase's serving shapes
             with a nonzero lse cotangent, including the ring step whose
             rows all see no key (dq, dk and dv exactly 0 there). Max abs
             error <= 1e-4 on out, lse, dq, dk and dv, scaled by the
             reference's max abs where that exceeds 1 (float32 in another
             order of summation); #5's and the pair's two calls on the same
             inputs bit-identical. Device times from CUDA graphs as in
             phase 3: each kernel, its plain version, and as a yardstick
             only F.scaled_dot_product_attention(is_causal=True) forward
             and forward plus backward; each kernel's bound, TFLOP/s and
             factor against SDPA (#5 and the pair also at D = 128).
7. train   — full-width training (the serve phase's model, random weights
             from a seeded generator) through ShardedTrainStep(adam, lr
             1e-3, grad_clip 1.0): 20 steps of 8 x 512 tokens from the
             long-context example's periodic corpus (numpy, --seed).
             Checks: every loss finite, the mean of the last 3 below the
             first, each training kernel launched exactly 12 times per
             step, one program signature, and one step's loss and every
             gradient leaf through the kernels agreeing with the plain
             tier (MXNET_TPU_MESH_KERNEL_TIER=off) on fresh copies of the
             same params and batch (loss 1e-5 relative, gradients 1e-4 of
             each leaf's max abs).
8. train_profile — one train step under torch.profiler: host wall against
             device time, idle share, top device ops and ops per step;
             with --profile-dir the table goes to DIR/profile_train.txt.
9. opt_kernel — the fused optimizer update kernel (opt_update.cu, TPU
             kernel #7, one multi-tensor launch per update) against its
             plain version, fused_update_step_plain, for SGD, SGD-momentum
             and Adam over clip {None, 0.01} x wd {0, 1e-4} x rescale {1,
             1/32}, two successive steps, with NaN and +-inf in every grad:
             single leaves of 1024, 128 * 513 and ResNet-50's largest (fc1
             2,048,000; a 3x3x512x512 conv 2,359,296); a mixed table of 3,
             15, 64, 1000, 1024, 9408 and 128 * 513 elements and a
             1024-element param 4 bytes into its buffer (the scalar path);
             a table of 337 leaves, three launches an update; and the
             main path's table, ResNet-50's 157 leaves (clip {None,
             0.01}, wd 1e-4, rescale 1/32), one launch an update. Bitwise
             equal (NaN in the same places, every other value the same
             bits). Then, for each kind, two rows of one ResNet-50 update:
             its 71 TPU-kernel leaves, and all 157 leaves, each in one
             launch: device time (CUDA graphs, median of 7), eager
             host_ms, the plain version, the card's bound (bytes: each
             operand read once, written once, 4 bytes of lr a launch)
             and, as a yardstick only, torch.optim.SGD(foreach=True) /
             torch.optim.Adam(fused=True, capturable=True) over the same
             leaves, timed the same way (library_host_ms its eager wall);
             and update_host_ms, a whole fused_update_step call eager.
10. symbolic_train — the symbolic stack at full width, as the JAX
             package's bench times it (bench.py:555-594): ResNet-50 at
             3x224x224, batch 32, float32, through mx.sym and
             DataParallelTrainStep(lr 0.05, momentum 0.9,
             fused_optupdate=True), 4 seeded batches (uniform(-1, 1)
             images, random labels) staged on the card and cycled for 20
             steps; then 3 Adam steps and 2 plain-SGD steps from the trained
             weights, so all three kernels run on the path. Checks: every
             loss finite, the mean cross-entropy of the last 4 steps below
             that of the first 4, exactly 1 kernel launch of 157 leaves per
             step (every parameter; none takes the eager plain expression)
             and 1 program signature; and one step from
             identical params with fused_optupdate True and False under
             cudnn.deterministic: params and slots bit for bit equal, or
             within 1e-6 of each leaf's max abs where the backward is not
             deterministic (reported).
11. symbolic_profile — one symbolic train step under torch.profiler: host
             wall against device time, idle share, device time by kind
             (convolution, BatchNorm, pooling, elementwise, kernel #7) and
             ops per step; with --profile-dir the table goes to
             DIR/profile_symbolic.txt. Then, as a measurement only, the
             step wall with torch.backends.cudnn.benchmark on (float32
             kept).
12. grid_kernel — the split-KV grid kernels against their plain versions
             on the card, float32: #6 (flash_fwd_grid.cu) and #4
             (flash_bwd_grid.cu) through flash_attention(variant="grid")
             at q/k/v (4, 8, 4096, 64) causal with 1, 8 and 128 key splits
             (blocks 4096, 512, 32), a non-causal ragged case and head dims
             32 and 128 with ragged splits; #3 (flash_fwd_offs_grid.cu)
             and #4 with a nonzero lse cotangent through
             flash_attention_with_lse(variant="grid") at the prefill shapes
             q (1, 8, C, 64) against k/v (1, 8, 4096, 64), C in {256, 1024},
             from the first chunk to the last of a 3800-token prompt and a
             ring-style offset whose rows all see no key; the combine and
             reduce passes alone on the plain version's partials. Max abs
             error <= 1e-4 on out, lse, dq, dk and dv, scaled by the
             reference's max abs where that exceeds 1; fully masked rows
             exactly (0, -1e30) with zero gradients; two calls on the same
             inputs bit-identical. Device times from CUDA graphs as in phase
             3: each kernel and pass, its plain version, the stream kernel
             at the same shape (#5, #2, #1), #4 with one split and, as a
             yardstick only, F.scaled_dot_product_attention; each kernel's
             bound, TFLOP/s and factor against SDPA.
13. serve_long — the long-context configuration served:
             TransformerConfig(vocab 32000, 12 layers, 8 heads, d_model
             512, max_len 4096, attn_variant "grid", block_k 512), random
             weights from a seeded generator, through DecodeEngine(
             block_size 16, 1025 blocks, batch 4, max_seq_len 4096, buckets
             (256, 1024), prefill_chunk 1024): 4 prompts of about 600,
             1400, 2500 and 3800 tokens (--seed), 32 new tokens each.
             Checks: all served, #3 and its combine launched 12 times per
             prefill call and the stream kernels not at all, no KV block
             left live, every stream equal to its solo decode, and the
             third 1024-token chunk of the longest prompt through the
             kernel agreeing with the plain tier's pages within 1e-4.
             Then, as a measurement only, the two long serving programs
             (the batch-4 step over 4096-position tables, a 1024-token
             prefill chunk at start 2048) under torch.profiler as in
             phase 5, device time by kind (DIR/profile_step_b4_t4096.txt,
             DIR/profile_prefill_c1024_grid.txt).
14. train_long — the same model trained through ShardedTrainStep(adam,
             lr 1e-3, grad_clip 1.0): 10 steps of 4 x 4096 tokens of the
             periodic corpus. Checks: every loss finite, the mean of the
             last 3 below the first, #6, #4-dq and #4-dkv and their
             combine/reduce passes launched 12 times per step and the
             stream kernels not at all, one program signature, and one
             step's loss and gradients at 2 layers (full width, S = 4096)
             agreeing with the plain tier (loss 1e-5 relative, gradients
             1e-4 of each leaf's max abs). As a measurement only: the step
             wall of the same model with attn_variant "stream", and one
             step under torch.profiler (device time by kind, idle share,
             ops per step; with --profile-dir the table goes to
             DIR/profile_train_long.txt).
15. rtc_kernel — mx.rtc, MXNet's runtime kernels, at n = ResNet-50's
             parameter count (25.55 M, read from the symbol): CudaModule
             compiles RTC_AXPY_SOURCE with NVRTC (--fmad=false; exports
             saxpy<float> and saxpy<double>), and the Triton analog launches
             triton_double_kernel (the JAX package's rtc test kernel). The
             path, launch counts at 0 just before: axpy f32, saxpy<float>
             with 96 KB of dynamic shared memory (above the 48 KB default),
             saxpy<double> and the Triton double, once each at full size;
             each bit for bit equal to its plain version (y + alpha * x, x *
             2.0). A dtype mismatch, a CPU ctx, a 2048-thread block, 300 KB
             of shared memory, a source that does not compile (NVRTC's log in
             the message), a malformed signature and an unknown C type each
             raise, and write and count nothing. A register_triton_op op's nd
             function on a Python list runs on the card (one launch). Reports
             NVRTC's version, path and compile seconds; device times from
             CUDA graphs as in phase 3 (kernel, plain version, torch.add /
             torch.mul as a yardstick only); the bound (12 bytes an element
             for axpy); host microseconds per eager launch
             (CudaKernel.launch, torch.add, the Triton launch) at 4096
             elements.
16. rtc_infer — ResNet-50 v2 (models/resnet.get_symbol(1000, 50,
             "3,224,224")) at batch 32, float32, seeded weights and moving
             statistics, inference through simple_bind(grad_req="null") and
             forward(is_train=False) in two graphs: the built-in one, and its
             JSON with every Activation(relu) node's op set to "user_relu"
             (USER_RELU_SOURCE through NVRTC and register_cuda_op) and loaded
             with load_json. 50 nodes (relu0, 3 per unit x 16, relu1). cuDNN
             deterministic, its autotuner off. One untimed forward of each
             graph, with the op functions wrapped, checks that Activation
             does not run in the rewritten graph and records the user op's
             inputs; the timed forwards run the op functions as a user does.
             Checks: every forward's output bit for bit the built-in graph's,
             exactly 50 user_relu launches per timed forward, each launch bit
             for bit clamp_min on the recorded inputs, and user_relu's nd
             function on a Python list launching on the card. Reports the
             forward wall p50 of both graphs (12 timed forwards each, in
             turns, the first 2 of each left out); the device time of one
             forward's 50 launches on those tensors (CUDA graphs), against
             clamp_min, F.relu (a yardstick only) and the bound (the 50
             inferred outputs, 8 bytes an element); the host microseconds a
             node costs (the user op, the built-in relu, the launch alone); a
             profile of the rewritten forward (DIR/profile_rtc_infer.txt,
             device time by kind, idle share).

``--phases`` runs a subset (comma-separated phase names; device and build
always run); the default runs all of them. ``--parent DIR`` adds a last
phase, ``parent``: the attention kernels and #7 of the checkout in DIR
(e.g. the parent commit unpacked with ``git archive``) built beside this
one's and called through the same C entries on the same inputs (#7: DIR's
per-leaf entries on the 71 leaves its rule takes and the plain expression
on the rest, against this checkout's one launch, on one ResNet-50 update
of each kind): #2's, #4's and #7's outputs must be the same bits in both,
every kernel is timed in turns (DIR's, this, this, DIR's) at its path's
shape, and the forwards' largest difference is reported.

The line before last is ``{"kernels": [...]}`` with each kernel's launches
on its path's run (serving, training, symbolic training, long-context
serving or training, the rtc kernels' full-size run or the ResNet-50
forwards), its error and times; the last line is ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

SEED = 0
TOL = 1e-4
TRAIN_STEPS = 20
PLAIN_TIER = "MXNET_TPU_MESH_KERNEL_TIER"
# one H100 SXM, published dense peaks (NVIDIA data sheet): float32 outside
# the tensor cores, TF32 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
NEG = -1e30
SYM_BATCH = 32
SYM_STEPS = 20
RESNET_SHAPES = {"data": (SYM_BATCH, 3, 224, 224),
                 "softmax_label": (SYM_BATCH,)}
OPT_REF = "mxnet_tpu/kernels/opt_update.py:"
#: update kind -> (line of the TPU kernel in OPT_REF, the C entry's name)
OPT_KERNELS = {"sgd": ("96", "optupdate_multi_sgd_f32"),
               "sgd_mom": ("103", "optupdate_multi_sgd_mom_f32"),
               "adam": ("113", "optupdate_multi_adam_f32")}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _event_ms(run, reps):
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms(fn, iters=20, reps=7):
    """Median per-call DEVICE time of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed between CUDA events, so the host's launch
    overhead is out of the number (a call at these shapes takes tens of
    microseconds of Python, more than the kernel itself)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, reps) / iters


def time_host_ms(fn, iters=50, reps=7):
    """Median per-call time of ``fn`` called eagerly back to back: what a
    caller sees, wrapper overhead included."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _event_ms(run, reps) / iters


def ptxas_kernels(log):
    """{kernel: [registers, spill store bytes, spill load bytes]} from
    nvcc's ``-Xptxas -v`` report; kernels named ``base<template ints>``
    from their mangled names."""
    import re
    found, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled, base = m.group(1), None
            i = 3 if mangled.startswith("_ZN") else 2
            while i < len(mangled) and mangled[i].isdigit():   # <len><id>s
                j = i
                while mangled[j].isdigit():
                    j += 1
                n = int(mangled[i:j])
                base, i = mangled[j:j + n], j + n
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = "%s<%s>" % (base or mangled, ",".join(args))
            found[name] = [None, None, None]
        elif name and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            found[name][1:] = [int(x) for x in nums]
        elif name and "Used" in ln and "registers" in ln:
            found[name][0] = int(re.search(r"Used (\d+) registers",
                                           ln).group(1))
    return found


def visible_keys(sq, sk, q0, k0):
    """Per-row count of keys a causal row at global q0 + i sees."""
    return [min(max(q0 + i - k0 + 1, 0), sk) for i in range(sq)]


def phase_kernel(torch, fa, dev):
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(SEED)
    B, H, SK, D = 1, 8, 512, 64
    sm = 1.0 / math.sqrt(D)
    cases = [(c, o) for c in (64, 256)
             for o in ((0, 0), (192, 0), (448, 0), (0, 256))]
    cases.append((256, (256, 0)))   # a long prompt's second 256-token chunk
    worst = 0.0
    rows = []
    for C, (q0, k0) in cases:
        q = torch.randn(B, H, C, D, generator=gen).to(dev)
        k = torch.randn(B, H, SK, D, generator=gen).to(dev)
        v = torch.randn(B, H, SK, D, generator=gen).to(dev)
        offs = torch.tensor([q0, k0], dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_with_lse(q, k, v, offs, sm, True)
        ref_out, ref_lse = fa.flash_fwd_offs_plain(q, k, v, offs, sm, True)
        torch.cuda.synchronize()
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        if not err <= TOL:
            fail("kernel vs plain C=%d offs=%s: max abs err %g > %g"
                 % (C, (q0, k0), err, TOL))
        vis = visible_keys(C, SK, q0, k0)
        dead = torch.tensor([n == 0 for n in vis], device=dev)
        n_dead = int(dead.sum().item())
        if n_dead:
            if not bool((lse[..., dead] == NEG).all().item()) or \
                    not bool((out[..., dead, :] == 0).all().item()):
                fail("fully masked rows not pinned (C=%d offs=%s)"
                     % (C, (q0, k0)))
        worst = max(worst, err)
        pos = torch.arange(C, device=dev)[:, None] + q0
        kpos = torch.arange(SK, device=dev)[None, :] + k0
        mask = pos >= kpos
        ms = time_ms(lambda: fa.flash_attention_with_lse(q, k, v, offs, sm,
                                                         True))
        host_ms = time_host_ms(lambda: fa.flash_attention_with_lse(
            q, k, v, offs, sm, True))
        plain_ms = time_ms(lambda: fa.flash_fwd_offs_plain(q, k, v, offs, sm,
                                                           True))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm))
        flops = 4.0 * B * H * sum(vis) * D
        nbytes = 4.0 * (q.numel() + k.numel() + v.numel() + out.numel()
                        + lse.numel()) + 8
        row = {"C": C, "offs": [q0, k0], "max_abs_err": err,
               "masked_rows": n_dead, "ms": ms, "host_ms": host_ms,
               "plain_ms": plain_ms,
               "sdpa_ms": sdpa_ms, "flops": flops, "bytes": nbytes,
               "tflops": tflops(flops, ms),
               **attention_bounds(flops, nbytes)}
        rows.append(row)
        emit({"phase": "kernel_case", **row})
    return worst, rows


def phase_serve(torch, fa, dev):
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, TransformerDecodeModel, transformer_decode_prefill)
    from mxnet_tpu_torch.serving import DecodeEngine
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                            d_model=512, max_len=512)
    t0 = time.perf_counter()
    model = TransformerDecodeModel(cfg, seed=SEED, device=dev)
    if not model.use_kernel:
        fail("model on %s did not resolve to the kernel tier" % dev)
    eng = DecodeEngine(block_size=16, num_blocks=257, batch_size=8,
                       max_seq_len=512, prefill_buckets=(64, 256),
                       prefill_chunk=256, **model.engine_kwargs())
    setup_s = time.perf_counter() - t0
    try:
        rng = torch.Generator().manual_seed(SEED + 1)
        lengths = [5, 37, 64, 100, 200, 257, 380, 480]
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
                   .tolist() for n in lengths]
        new = 32
        stamps = {}

        def on_token(stream, seq_no, token):
            stamps.setdefault(stream.rid, []).append(time.monotonic())

        torch.cuda.synchronize()
        fa.launches = 0
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new, on_token=on_token)
                   for p in prompts]
        outs = [s.result_wait(600.0) for s in streams]
        wall = time.perf_counter() - t0
        launches = fa.launches
        calls = sum(-(-n // 256) for n in lengths)
        st = eng.stats()
        if st["served"] != len(prompts):
            fail("served %d of %d" % (st["served"], len(prompts)))
        if launches < cfg.num_layers * calls:
            fail("flash kernel launched %d times, want >= %d"
                 % (launches, cfg.num_layers * calls))
        if eng.program_counts() != (2, 1):
            fail("program_counts %s != (2, 1)" % (eng.program_counts(),))
        if st["kv"]["blocks_live"] != 0:
            fail("%d KV blocks still live" % st["kv"]["blocks_live"])
        for o in outs:
            if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
                fail("bad stream %s" % o)
        ttft = [stamps[s.rid][0] - s.submitted_t for s in streams]
        gaps = [b - a for s in streams
                for a, b in zip(stamps[s.rid], stamps[s.rid][1:])]
        solo = [eng.generate(p, max_new_tokens=new, timeout=600.0)
                for p in prompts]
        if solo != outs:
            bad = [i for i, (a, b) in enumerate(zip(solo, outs)) if a != b]
            fail("continuous != solo for prompts %s" % bad)
        # reference: a full 12-layer prefill through the kernel against the
        # plain tier, on fresh pages
        i64 = dict(dtype=torch.int64, device=dev)
        toks = torch.tensor(prompts[4] + [0] * (256 - lengths[4]), **i64)
        table = torch.arange(1, 33, **i64)
        pages = {}
        for use_kernel in (True, False):
            kp = torch.zeros((33, 16, 12, 512), device=dev)
            vp = torch.zeros_like(kp)
            tok, kp, vp = transformer_decode_prefill(
                model.params, cfg, kp, vp, toks, torch.tensor(0, **i64),
                torch.tensor(lengths[4], **i64), table,
                use_kernel=use_kernel)
            pages[use_kernel] = (int(tok.item()), kp, vp)
        # blocks 1..32 only: the null block 0 takes the padding rows'
        # duplicate writes, whose winner is unspecified and never read
        page_err = max(
            (pages[True][1][1:] - pages[False][1][1:]).abs().max().item(),
            (pages[True][2][1:] - pages[False][2][1:]).abs().max().item())
        if not page_err <= TOL:
            fail("kernel-tier prefill pages differ from the plain tier by %g"
                 % page_err)
    finally:
        eng.stop()
    result = {"phase": "serve", "setup_s": setup_s, "wall_s": wall,
              "tokens": sum(len(o) for o in outs),
              "tokens_per_s": sum(len(o) for o in outs) / wall,
              "ttft_p50_ms": statistics.median(ttft) * 1e3,
              "intertoken_p50_ms": statistics.median(gaps) * 1e3,
              "prefill_calls": calls, "flash_launches": launches,
              "steps": st["steps"], "program_counts": list(
                  eng.program_counts()),
              "continuous_equals_solo": True,
              "prefill_pages_max_abs_err_vs_plain": page_err,
              "first_token_kernel_vs_plain": [pages[True][0],
                                              pages[False][0]]}
    return result, launches, model


def phase_profile(torch, model, dev, out_dir):
    """Where the time of the two serving programs goes: the full-width
    decode step (batch 8, 512-position tables) and a 256-token prefill
    chunk at start 256, called directly on the main thread. Host wall per
    call (synchronized) against device time per call (the sum of the
    kernels torch.profiler traced), hence the device's idle share. With
    ``out_dir``, each program's profiler table goes to
    ``out_dir/profile_<program>.txt``."""
    from mxnet_tpu_torch.models.transformer import (
        transformer_decode_prefill, transformer_decode_step)
    cfg = model.cfg
    i64 = dict(dtype=torch.int64, device=dev)
    kp = torch.zeros((257, 16, cfg.num_layers, cfg.d_model), device=dev)
    vp = torch.zeros_like(kp)
    tables = torch.arange(1, 257, **i64).reshape(8, 32)
    ids = torch.zeros(8, **i64)
    pos = torch.full((8,), 300, **i64)
    active = torch.ones(8, dtype=torch.bool, device=dev)
    toks = torch.zeros(256, **i64)
    start, length = torch.tensor(256, **i64), torch.tensor(256, **i64)
    programs = {
        "step_b8": lambda: transformer_decode_step(
            model.params, cfg, kp, vp, ids, pos, tables, active),
        "prefill_c256": lambda: transformer_decode_prefill(
            model.params, cfg, kp, vp, toks, start, length, tables[0],
            use_kernel=True)}
    result = {"phase": "profile"}
    for name, fn in programs.items():
        result[name] = profile_calls(torch, fn, name, out_dir)
    return result


def profile_calls(torch, fn, name, out_dir, warm=3, n=20, calls=5,
                  classify=None):
    """Host wall per call of ``fn`` (``n`` synchronized calls after
    ``warm``) against the device time torch.profiler traced over
    ``calls`` more, hence the idle share; the top device ops, and with
    ``classify`` (kernel name -> kind) the device ms per call by kind. With
    ``out_dir`` the profiler table goes to ``out_dir/profile_<name>.txt``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += evt.time_range.elapsed_us()
    device_ms = sum(v[1] for v in kernels.values()) / calls / 1e3
    if not device_ms > 0:
        fail("profile %s: the profiler traced no device time" % name)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_%s.txt" % name), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    result = {"wall_ms": wall_ms, "device_ms": device_ms,
              "idle_share": 1.0 - device_ms / wall_ms,
              "device_ops_per_call": sum(v[0] for v in kernels.values())
              / calls,
              "top": [[k, v[1] / calls / 1e3] for k, v in top]}
    if classify is not None:
        by_kind = {}
        for k, v in kernels.items():
            kind = by_kind.setdefault(classify(k), [0, 0.0])
            kind[0] += v[0] / calls
            kind[1] += v[1] / calls / 1e3
        result["by_kind"] = by_kind    # kind -> [launches, device ms]
    return result


def scaled_err(got, ref):
    """Max abs error of ``got`` against ``ref``, divided by ``ref``'s max
    abs where that exceeds 1."""
    return ((got - ref).abs().max().item()
            / max(1.0, ref.abs().max().item()))


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    """The card's least time for the work: the larger of operations over
    ``peak`` and bytes over the memory rate; and which it is."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bounds(flops, nbytes):
    """The attention kernels' bound: float32-accurate products on the
    tensor cores take three TF32 products each (3xTF32), so operations
    cost 3 * flops at the dense TF32 rate; the larger of that and the
    bytes. -> {bound_ms, bound_by, bound_cuda_core_ms}, the last the
    CUDA-core float32 figure earlier slices priced them at."""
    ms, by = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return {"bound_ms": ms, "bound_by": by,
            "bound_cuda_core_ms": bound_ms(flops, nbytes)[0]}


def tflops(flops, ms):
    """Achieved TFLOP/s of ``flops`` (a multiply-add counted as two) in
    ``ms``."""
    return flops / (ms * 1e-3) / 1e12


def phase_train_kernel(torch, fa, dev):
    """The training kernels against their plain versions (see the module
    docstring, phase 6). Returns (per-kernel worst errors, timing row)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    def check(kind, what, got, ref):
        err = scaled_err(got, ref)
        if not err <= TOL:
            fail("train_kernel %s: %s max abs err %g > %g" % (what, kind, err,
                                                              TOL))
        worst[kind] = max(worst[kind], err)

    # forward #5 and the pair #2 at offs 0 through _FlashAttention
    for (b, h, s, d), causal in (((8, 8, 512, 64), True),
                                 ((2, 8, 200, 64), False),
                                 ((1, 4, 150, 32), True),
                                 ((1, 4, 150, 128), True),
                                 ((8, 8, 512, 128), True)):
        what = "%s causal=%s" % ((b, h, s, d), causal)
        sm = 1.0 / math.sqrt(d)
        q, k, v, do = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d), \
            rand(b, h, s, d)
        out, lse = fa._flash_fwd_cuda(q, k, v, sm, causal)
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, sm, causal)
        check("fwd", what + " out", out, ref_out)
        check("fwd", what + " lse", lse, ref_lse)
        # #5 owns its output rows too: a second call is bit-identical
        if not all(torch.equal(a, b_) for a, b_ in zip(
                fa._flash_fwd_cuda(q, k, v, sm, causal), (out, lse))):
            fail("train_kernel %s: two forward calls on the same inputs "
                 "differ" % what)
        ts = leaves(q, k, v)
        o = fa.flash_attention(*ts, causal=causal, sm_scale=sm,
                               use_pallas=True)
        if o.grad_fn is None:
            fail("flash_attention on CUDA is cut off from autograd")
        o.backward(do)
        ref = fa.flash_bwd_offs_plain(q, k, v, fa._offs0(dev), do, None,
                                      ref_out, ref_lse, sm, causal)
        check("dq", what + " dq", ts[0].grad, ref[0])
        check("dkv", what + " dk", ts[1].grad, ref[1])
        check("dkv", what + " dv", ts[2].grad, ref[2])
        # #2 owns its output rows (no atomics): a second call is
        # bit-identical
        again = leaves(q, k, v)
        fa.flash_attention(*again, causal=causal, sm_scale=sm,
                           use_pallas=True).backward(do)
        if not all(torch.equal(a.grad, t.grad) for a, t in zip(again, ts)):
            fail("train_kernel %s: two backward calls on the same inputs "
                 "differ" % what)
    torch.cuda.synchronize()

    # flash_attention_with_lse (#1 forward, #2 backward) at the serving
    # shapes with a nonzero lse cotangent, ring step included
    SK, D = 512, 64
    sm = 1.0 / math.sqrt(D)
    cases = [(c, o) for c in (64, 256)
             for o in ((0, 0), (192, 0), (448, 0), (0, 256))]
    cases.append((256, (256, 0)))
    for C, (q0, k0) in cases:
        what = "with_lse C=%d offs=%s" % (C, (q0, k0))
        q, k, v = rand(1, 8, C, D), rand(1, 8, SK, D), rand(1, 8, SK, D)
        do, dlse = rand(1, 8, C, D), rand(1, 8, C)
        offs = torch.tensor([q0, k0], dtype=torch.int32, device=dev)
        ts = leaves(q, k, v)
        out, lse = fa.flash_attention_with_lse(*ts, offs, sm, True)
        if out.grad_fn is None or lse.grad_fn is None:
            fail("flash_attention_with_lse on CUDA is cut off from autograd")
        torch.autograd.backward((out, lse), (do, dlse))
        ref_out, ref_lse = fa.flash_fwd_offs_plain(q, k, v, offs, sm, True)
        ref = fa.flash_bwd_offs_plain(q, k, v, offs, do, dlse, ref_out,
                                      ref_lse, sm, True)
        check("dq", what + " dq", ts[0].grad, ref[0])
        check("dkv", what + " dk", ts[1].grad, ref[1])
        check("dkv", what + " dv", ts[2].grad, ref[2])
        dead_rows = torch.arange(C, device=dev) + q0 < k0
        dead_keys = torch.arange(SK, device=dev) + k0 > C - 1 + q0
        if not (bool((ts[0].grad[..., dead_rows, :] == 0).all().item())
                and bool((ts[1].grad[..., dead_keys, :] == 0).all().item())
                and bool((ts[2].grad[..., dead_keys, :] == 0).all().item())):
            fail("%s: fully masked rows or keys got nonzero gradient"
                 % what)
    torch.cuda.synchronize()

    # device times at the training shape (D = 64), and the pair #5, #2 at
    # D = 128
    t = {}
    for B, H, S, D in ((8, 8, 512, 64), (8, 8, 512, 128)):
        pre = "" if D == 64 else "d128_"
        sm = 1.0 / math.sqrt(D)
        q, k, v, do = rand(B, H, S, D), rand(B, H, S, D), \
            rand(B, H, S, D), rand(B, H, S, D)
        offs0 = fa._offs0(dev)
        out, lse = fa._flash_fwd_cuda(q, k, v, sm, True)
        deff = fa._deff(do, out, None).contiguous()
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  offs0.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  deff.data_ptr())
        tail = (B * H, S, S, D, sm, 1)
        qg, kg, vg = leaves(q, k, v)
        sdpa = lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True, scale=sm)
        t.update({
            pre + "dq_ms": time_ms(lambda: fa._launch(
                "mx_flash_bwd_dq_f32", *common, dq.data_ptr(), *tail,
                device=dev)),
            pre + "dkv_ms": time_ms(lambda: fa._launch(
                "mx_flash_bwd_dkv_f32", *common, dk.data_ptr(),
                dv.data_ptr(), *tail, device=dev)),
            pre + "fwd_ms": time_ms(lambda: fa._flash_fwd_cuda(q, k, v, sm,
                                                               True)),
            pre + "sdpa_fwd_ms": time_ms(lambda: sdpa(q, k, v)),
            pre + "sdpa_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                sdpa(qg, kg, vg), (qg, kg, vg), do))})
        if D == 64:
            t.update({
                "fwd_plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                    q, k, v, sm, True)),
                "bwd_plain_ms": time_ms(lambda: fa.flash_bwd_offs_plain(
                    q, k, v, offs0, do, None, out, lse, sm, True)),
                "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                    fa._FlashAttention.apply(qg, kg, vg, sm, True),
                    (qg, kg, vg), do))})
        t[pre + "sdpa_bwd_ms"] = (t[pre + "sdpa_fwd_bwd_ms"]
                                  - t[pre + "sdpa_fwd_ms"])
        vis = B * H * S * (S + 1) // 2
        n, rows = q.numel(), B * H * S
        work = [("dq", 6.0 * vis * D, 4.0 * (5 * n + 2 * rows) + 8),
                ("dkv", 8.0 * vis * D, 4.0 * (6 * n + 2 * rows) + 8),
                ("fwd", 4.0 * vis * D, 4.0 * (4 * n + rows))]
        for name, flops, nbytes in work:
            for key, val in attention_bounds(flops, nbytes).items():
                t[pre + name + "_" + key] = val
            t[pre + name + "_flops"], t[pre + name + "_bytes"] = flops, nbytes
            t[pre + name + "_tflops"] = tflops(flops, t[pre + name + "_ms"])
        # the backward pair against SDPA's backward (fwd+bwd minus fwd)
        t[pre + "bwd_vs_sdpa"] = ((t[pre + "dq_ms"] + t[pre + "dkv_ms"])
                                  / t[pre + "sdpa_bwd_ms"])
        t[pre + "fwd_vs_sdpa"] = t[pre + "fwd_ms"] / t[pre + "sdpa_fwd_ms"]
        del q, k, v, do, out, lse, deff, dq, dk, dv, qg, kg, vg
    return worst, t


def periodic_batches(seed, vocab, seq_len, batch, lag=96, pool=32):
    """The long-context example's corpus (train_long_context.py:92-102):
    a fixed pool of truly periodic sequences, so every target at position
    >= lag equals the token exactly ``lag`` back. -> make_batch()."""
    import numpy as np
    rng = np.random.RandomState(seed)
    base = rng.randint(1, vocab, (pool, lag), dtype=np.int64)
    reps = seq_len // lag + 2
    corpus = np.tile(base, (1, reps))[:, :seq_len + 1].astype(np.int32)

    def make_batch():
        toks = corpus[rng.randint(0, pool, batch)]
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return make_batch


def phase_train(torch, fa, dev, seed):
    """Full-width training (module docstring, phase 7). Returns (result,
    launches per kernel on the run, the step, a batch)."""
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_loss)
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves, tree_map
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                            d_model=512, max_len=512)
    B, S = 8, 512
    t0 = time.perf_counter()
    params = init_transformer(cfg, torch.Generator().manual_seed(seed), dev)
    make_batch = periodic_batches(seed, cfg.vocab_size, S, B)
    batches = [make_batch() for _ in range(TRAIN_STEPS)]

    def loss_fn(p, b):
        return transformer_loss(p, b["tokens"], b["targets"], cfg)

    step = ShardedTrainStep(loss_fn, optimizer="adam", lr=1e-3,
                            grad_clip=1.0, device=dev).init(params)
    setup_s = time.perf_counter() - t0
    names = ("launches", "launches_fwd", "launches_bwd_dq",
             "launches_bwd_dkv")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for name in names:
        setattr(fa, name, 0)
    losses, walls = [], []
    t0 = time.perf_counter()
    for b in batches:
        ts = time.perf_counter()
        losses.append(step(b).item())      # .item() synchronizes
        walls.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    counts = {name: getattr(fa, name) for name in names}
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        fail("train: non-finite loss in %s" % losses)
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail("train: loss did not fall: %s" % losses)
    want = cfg.num_layers * TRAIN_STEPS
    for name in names[1:]:
        if counts[name] != want:
            fail("train: %s = %d, want %d (12 per step)" % (name,
                                                           counts[name],
                                                           want))
    if counts["launches"] != 0:
        fail("train: the serving kernel launched %d times"
             % counts["launches"])
    if step.program_count() != 1:
        fail("train: %d step signatures, want 1" % step.program_count())

    # one step's loss and gradients, kernel tier against plain tier, on
    # fresh copies of the initial params and the first batch
    batch = {k: torch.as_tensor(x).to(dev) for k, x in batches[0].items()}
    prior = os.environ.get(PLAIN_TIER)
    tiers = {}
    try:
        for tier in ("on", "off"):
            os.environ[PLAIN_TIER] = tier
            p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                         params)
            before = fa.launches_fwd
            loss = loss_fn(p, batch)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            tiers[tier] = (loss.item(), grads, fa.launches_fwd - before)
    finally:
        if prior is None:
            os.environ.pop(PLAIN_TIER, None)
        else:
            os.environ[PLAIN_TIER] = prior
    if tiers["on"][2] != cfg.num_layers or tiers["off"][2] != 0:
        fail("train: tier comparison launched %d / %d forward kernels"
             % (tiers["on"][2], tiers["off"][2]))
    loss_rel = abs(tiers["on"][0] - tiers["off"][0]) / abs(tiers["off"][0])
    if not loss_rel <= 1e-5:
        fail("train: kernel-tier loss %r vs plain %r" % (tiers["on"][0],
                                                         tiers["off"][0]))
    grad_err = max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(tiers["on"][1], tiers["off"][1]))
    if not grad_err <= TOL:
        fail("train: kernel-tier gradients differ from the plain tier by "
             "%g of a leaf's max abs" % grad_err)
    step_ms = statistics.median(walls[1:]) * 1e3
    result = {"phase": "train", "setup_s": setup_s, "steps": TRAIN_STEPS,
              "batch": [B, S], "wall_s": wall, "first_step_ms":
              walls[0] * 1e3, "step_ms_p50": step_ms,
              "tokens_per_s": B * S / step_ms * 1e3, "losses": losses,
              "launches": counts, "program_count": step.program_count(),
              "peak_mem_gb": peak / 1e9,
              "tier_loss": [tiers["on"][0], tiers["off"][0]],
              "tier_loss_rel_err": loss_rel, "tier_grad_err": grad_err}
    return result, counts, step, batches[0]


def _opt_hp(kind, lr=0.05):
    return {"lr": lr, "momentum": 0.9 if kind == "sgd_mom" else 0.0,
            "beta1": 0.9, "beta2": 0.999, "eps": 1e-8}


def _opt_state(torch, kind, params):
    if kind == "adam":
        return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()},
                "t": torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device)}
    if kind == "sgd_mom":
        return {"mom": {k: torch.zeros_like(v) for k, v in params.items()}}
    return {"mom": None}


def _bit_diff(torch, got, want):
    """(same bits, max abs diff over finite values) of two float32 or
    float64 tensors of one shape: NaN must sit in the same places, every
    other value must have the same bits."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, math.inf
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False, math.inf
    bits = {4: torch.int32, 8: torch.int64}[want.element_size()]
    same = torch.equal(got[~nan].view(bits), want[~nan].view(bits))
    fin = torch.isfinite(want) & torch.isfinite(got)
    diff = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    return same, diff


def resnet50_param_shapes(tres):
    """ResNet-50's symbol and the shapes of its 157 parameters (the port's
    infer_shape), in argument order."""
    sym = tres.get_symbol(num_classes=1000, num_layers=50,
                          image_shape="3,224,224")
    arg_shapes, _, _ = sym.infer_shape(**RESNET_SHAPES)
    return sym, {n: s for n, s in zip(sym.list_arguments(), arg_shapes)
                 if n not in RESNET_SHAPES}


def meta_walk(torch, sym, shapes):
    """Yield (node, inputs, outputs) for each op node of ``sym`` at
    ``shapes``, the graph run on ``meta`` tensors in topological order."""
    from mxnet_tpu_torch.executor import GraphPlan
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    known = dict(zip(sym.list_arguments(), arg_shapes))
    known.update(zip(sym.list_auxiliary_states(), aux_shapes))
    plan = GraphPlan(sym)
    vals = {(nid, 0): torch.empty(known[name], device="meta")
            for nid, name, _ in plan.variables}
    for node, params, in_keys, n_vis, _ in plan.nodes:
        ins = [vals[k] for k in in_keys]
        outs = node.op.apply(params, ins, is_train=True)
        for i in range(n_vis):
            vals[(id(node), i)] = outs[i]
        yield node, ins, outs


def graph_macs(torch, sym, shapes):
    """Multiply-adds of one forward pass of ``sym`` at ``shapes`` (its
    convolutions and fully connected layers)."""
    return sum(outs[0].numel() * math.prod(ins[1].shape[1:])
               for node, ins, outs in meta_walk(torch, sym, shapes)
               if node.op.name in ("Convolution", "FullyConnected"))


def _specials(torch, g, step):
    """NaN, +inf and -inf into grad ``g`` at positions from ``step``."""
    for j, x in enumerate((math.nan, math.inf, -math.inf)):
        g.view(-1)[(step + j) % g.numel()] = x


def _opt_battery(torch, tou, kind, make, steps=2, **kw):
    """Two updates of the tree ``make()`` -> (params, grads a step) through
    the kernel and through the plain version on copies of the same
    inputs; -> (same bits, max abs diff over finite values)."""
    runs = []
    for fn in (tou.fused_update_step, tou.fused_update_step_plain):
        params, grads = make()
        state = _opt_state(torch, kind, params)
        for g in grads[:steps]:
            fn("adam" if kind == "adam" else "sgd", _opt_hp(kind), params,
               state, g, **kw)
        runs.append([params[n] for n in sorted(params)]
                    + [state[s][n] for s in ("m", "v", "mom")
                       if state.get(s) for n in sorted(params)])
    same, worst = True, 0.0
    for got, want in zip(*runs):
        ok, diff = _bit_diff(torch, got, want)
        same &= ok
        worst = max(worst, diff)
    return same, worst


#: the mixed table: small and large leaves, and a param that is a view 4
#: bytes into its buffer (the scalar path)
OPT_MIXED = {"a": 3, "b": 15, "c": 64, "d": 1000, "e": 1024, "f": 9408,
             "g": 128 * 513, "h": 1024}
OPT_MISALIGNED = "h"
#: the long table: more leaves than one launch takes
OPT_LONG_SIZES = (1, 7, 64, 1000, 4096, 4097, 9408)


def phase_opt_kernel(torch, dev):
    """Kernel #7 against its plain version, bitwise, and its device time
    over one ResNet-50 update (module docstring, phase 9). Returns (per
    update kind: worst abs diff, cases, timing rows)."""
    import itertools
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {k: 0.0 for k in OPT_KERNELS}
    launches = {k: 0 for k in OPT_KERNELS}
    leaves = {k: 0 for k in OPT_KERNELS}
    n_cases = 0

    def check(same, diff, kind, what):
        if not same:
            fail("opt_kernel %s %s: the kernel differs from its plain "
                 "version (max abs diff %g)" % (kind, what, diff))
        worst[kind] = max(worst[kind], diff)

    def single(n):
        p = torch.randn(n, device=dev, generator=gen)
        grads = []
        for step in range(2):
            g = torch.randn(n, device=dev, generator=gen) * 2
            _specials(torch, g, step)
            grads.append(g)
        return lambda: ({"w": p.clone()}, [{"w": g} for g in grads])

    def mixed():
        p = {k: torch.randn(n, device=dev, generator=gen)
             for k, n in OPT_MIXED.items()}
        grads = []
        for step in range(2):
            g = {k: torch.randn(n, device=dev, generator=gen) * 2
                 for k, n in OPT_MIXED.items()}
            for v in g.values():
                _specials(torch, v, step)
            grads.append(g)

        def make():
            params = {k: v.clone() for k, v in p.items()}
            buf = torch.empty(OPT_MIXED[OPT_MISALIGNED] + 1, device=dev)
            params[OPT_MISALIGNED] = buf[1:].copy_(p[OPT_MISALIGNED])
            return params, grads
        return make

    def long_table():
        names = ["l%03d" % i for i in range(2 * tou._MAX_LEAVES + 17)]
        sizes = {k: OPT_LONG_SIZES[i % len(OPT_LONG_SIZES)]
                 for i, k in enumerate(names)}
        p = {k: torch.randn(n, device=dev, generator=gen)
             for k, n in sizes.items()}
        grads = [{k: torch.randn(n, device=dev, generator=gen)
                  for k, n in sizes.items()} for _ in range(2)]
        for step, g in enumerate(grads):
            _specials(torch, g[names[step]], step)
        return lambda: ({k: v.clone() for k, v in p.items()}, grads)

    def resnet_table():
        # the main path's table: ResNet-50's 157 leaves, NaN and +-inf in
        # every 16th leaf's grad and in the 3-element one's
        names = sorted(shapes)
        p = {n: torch.randn(s, device=dev, generator=gen) * 0.05
             for n, s in shapes.items()}
        grads = []
        for step in range(2):
            g = {n: torch.randn(s, device=dev, generator=gen) * 2
                 for n, s in shapes.items()}
            for n in names[step::16] + [min(names, key=lambda n_:
                                            g[n_].numel())]:
                _specials(torch, g[n], step)
            grads.append(g)
        return lambda: ({k: v.clone() for k, v in p.items()}, grads)

    _, shapes = resnet50_param_shapes(tres)
    for kind, clip, wd, rescale in itertools.product(
            OPT_KERNELS, (None, 0.01), (0.0, 1e-4), (1.0, 1 / 32)):
        for n in (1024, 128 * 513, 2048000, 2359296):
            check(*_opt_battery(torch, tou, kind, single(n), clip=clip,
                                wd=wd, rescale=rescale), kind,
                  "clip=%s wd=%s rescale=%s n=%d" % (clip, wd, rescale, n))
            launches[kind] += 2
            leaves[kind] += 2
            n_cases += 1
        if rescale != 1.0:
            check(*_opt_battery(torch, tou, kind, mixed(), clip=clip,
                                wd=wd, rescale=rescale), kind,
                  "clip=%s wd=%s mixed table" % (clip, wd))
            launches[kind] += 2
            leaves[kind] += 2 * len(OPT_MIXED)
            n_cases += 1
    long_launches = {}
    for kind in OPT_KERNELS:
        before = _opt_counts(tou)[kind]
        check(*_opt_battery(torch, tou, kind, long_table(), clip=0.01,
                            wd=1e-4, rescale=1 / 32), kind, "long table")
        long_launches[kind] = _opt_counts(tou)[kind] - before
        n_long = 2 * tou._MAX_LEAVES + 17
        if long_launches[kind] != 2 * 3:
            fail("opt_kernel %s long table of %d leaves: %d launches in 2 "
                 "updates, want 6" % (kind, n_long, long_launches[kind]))
        launches[kind] += 6
        leaves[kind] += 2 * n_long
        n_cases += 1
        for clip in (None, 0.01):
            before = _opt_counts(tou)[kind]
            check(*_opt_battery(torch, tou, kind, resnet_table(), clip=clip,
                                wd=1e-4, rescale=1 / 32), kind,
                  "clip=%s ResNet-50 table" % clip)
            made = _opt_counts(tou)[kind] - before
            if made != 2:
                fail("opt_kernel %s ResNet-50 table of %d leaves: %d "
                     "launches in 2 updates, want 2" % (kind, len(shapes),
                                                       made))
            launches[kind] += 2
            leaves[kind] += 2 * len(shapes)
            n_cases += 1
    counted, counted_leaves = _opt_counts(tou), _opt_leaves(tou)
    if any(counted[k] < launches[k] or counted_leaves[k] < leaves[k]
           for k in OPT_KERNELS):
        fail("opt_kernel: counters %s launches, %s leaves below the %s, %s "
             "launched" % (counted, counted_leaves, launches, leaves))
    torch.cuda.synchronize()

    # device time of one ResNet-50 update: its 71 TPU-kernel leaves, and
    # all 157 leaves in one launch
    rows = {}
    for kind in OPT_KERNELS:
        params = {n: torch.randn(s, device=dev, generator=gen) * 0.05
                  for n, s in shapes.items()}
        grads = {n: torch.randn(s, device=dev, generator=gen) * 1e-3
                 for n, s in shapes.items()}
        state = _opt_state(torch, kind, params)
        hp = _opt_hp(kind)
        lr_t = torch.full((), hp["lr"], device=dev)
        opt = "adam" if kind == "adam" else "sgd"
        kw = dict(rescale=1 / 32, clip=None, wd=1e-4)
        names = sorted(params)
        rows[kind] = {}
        for key, part_names in (
                ("leaves71", [n for n in names
                              if tou._kernel_eligible(params[n])]),
                ("leaves157", names)):
            part = [(params[n], grads[n], tuple(
                state[s][n] for s in ("m", "v", "mom") if state.get(s)))
                for n in part_names]

            def kernel(part=part):
                tou._launch(opt, hp, lr_t, part, **kw)

            def plain(part=part):
                for p_, g_, sl in part:
                    tou._plain_leaf(opt, hp, lr_t, p_, g_, sl, **kw)

            lib_params = [p_.clone().requires_grad_(True)
                          for p_, _, _ in part]
            for lp, (_, g_, _) in zip(lib_params, part):
                lp.grad = g_.clone()
            if kind == "adam":
                lib = torch.optim.Adam(lib_params, lr=hp["lr"], fused=True,
                                       capturable=True)
            else:
                lib = torch.optim.SGD(lib_params, lr=hp["lr"],
                                      momentum=hp["momentum"], foreach=True)
            before = sum(_opt_counts(tou).values())
            sizes = sorted(p_.numel() for p_, _, _ in part)
            row = {"leaves": len(part), "elements": sum(sizes),
                   "leaf_elements_median": sizes[len(sizes) // 2],
                   "leaves_le_256k": sum(1 for n_ in sizes
                                         if n_ <= 1 << 18),
                   "launches": -(-len(part) // tou._MAX_LEAVES),
                   "ms": time_ms(kernel, iters=5),
                   "host_ms": time_host_ms(kernel, iters=10),
                   "plain_ms": time_ms(plain, iters=5)}
            # the yardstick, device time in a CUDA graph as the kernel's
            # (SGD with foreach and Adam with fused + capturable both
            # capture), and its eager wall beside the kernel's host_ms
            row["library_ms"] = time_ms(lib.step, iters=5)
            row["library_host_ms"] = time_host_ms(lib.step, iters=10)
            if sum(_opt_counts(tou).values()) == before:
                fail("opt_kernel: the timed kernel never launched")
            nbytes = (tou.optupdate_ideal_bytes(
                opt, {n: params[n] for n in part_names}, state)
                      + 4 * row["launches"])
            flops = {"sgd": 5, "sgd_mom": 7, "adam": 15}[kind] \
                * row["elements"]
            row["bytes"], row["flops"] = nbytes, flops
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
            row["share"] = row["bound_ms"] / row["ms"]
            row["vs_library"] = row["ms"] / row["library_ms"]
            rows[kind][key] = row
        # the whole update as a caller makes it, eager: checks, the table
        # and the launch (Adam: its step count and correction too)
        rows[kind]["update_host_ms"] = time_host_ms(
            lambda: tou.fused_update_step(opt, hp, params, state, grads,
                                          **kw), iters=10)
    return worst, n_cases, rows


def _reset_opt_counts(tou):
    for k in OPT_KERNELS:
        setattr(tou, "launches_" + k, 0)
        setattr(tou, "leaves_" + k, 0)


def _opt_counts(tou):
    return {k: getattr(tou, "launches_" + k) for k in OPT_KERNELS}


def _opt_leaves(tou):
    return {k: getattr(tou, "leaves_" + k) for k in OPT_KERNELS}


def _cross_entropy(torch, prob, label):
    picked = prob.gather(1, label.long()[:, None]).clamp_min(1e-30)
    return -picked.log().mean()


def phase_symbolic_train(torch, dev, seed):
    """Full-width ResNet-50 through the symbolic stack (module docstring,
    phase 10). Returns (result, per-kernel (launches, leaves) on the path,
    the SGD step, a batch)."""
    import numpy as np
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.parallel import DataParallelTrainStep
    t0 = time.perf_counter()
    sym, shapes = resnet50_param_shapes(tres)
    n_leaves = len(shapes)
    n_el = sum(1 for s in shapes.values() if tou._kernel_eligible(
        torch.empty(s, device="meta")))
    step = DataParallelTrainStep(sym, lr=0.05, momentum=0.9,
                                 fused_optupdate=True, device=dev)
    step.init(RESNET_SHAPES, seed=seed)
    rng = np.random.RandomState(seed)
    batches = [{"data": torch.from_numpy(rng.uniform(
        -1, 1, RESNET_SHAPES["data"]).astype(np.float32)).to(dev),
        "softmax_label": torch.from_numpy(rng.randint(
            0, 1000, (SYM_BATCH,)).astype(np.float32)).to(dev)}
        for _ in range(4)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def run(st, steps):
        losses, walls = [], []
        for i in range(steps):
            b = batches[i % len(batches)]
            ts = time.perf_counter()
            prob = st(b)[0]
            losses.append(_cross_entropy(torch, prob,
                                         b["softmax_label"]).item())
            walls.append(time.perf_counter() - ts)
        return losses, walls

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_opt_counts(tou)
    losses, walls = run(step, SYM_STEPS)
    counts = {"sgd_mom": (_opt_counts(tou), _opt_leaves(tou))}
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        fail("symbolic_train: non-finite loss in %s" % losses)
    if not statistics.mean(losses[-4:]) < statistics.mean(losses[:4]):
        fail("symbolic_train: loss did not fall: %s" % losses)
    # one launch a step over every parameter: none takes the eager plain
    # expression
    if counts["sgd_mom"] != ({"sgd": 0, "sgd_mom": SYM_STEPS, "adam": 0},
                             {"sgd": 0, "sgd_mom": n_leaves * SYM_STEPS,
                              "adam": 0}):
        fail("symbolic_train: kernel #7 (launches, leaves) %s, want %d "
             "sgd_mom launches of %d leaves" % (counts["sgd_mom"],
                                                SYM_STEPS, n_leaves))
    if step.program_count() != 1:
        fail("symbolic_train: %d step signatures, want 1"
             % step.program_count())

    # Adam, then plain SGD, from the trained weights: the other two
    # kernels on the same path
    extra = {}
    for kind, kw, steps in (("adam", dict(optimizer="adam", lr=1e-4), 3),
                            ("sgd", dict(lr=0.01, momentum=0.0), 2)):
        st = DataParallelTrainStep(sym, fused_optupdate=True, device=dev,
                                   **kw).init_from(step.params, step.aux,
                                                   RESNET_SHAPES)
        torch.cuda.synchronize()
        _reset_opt_counts(tou)
        l2, w2 = run(st, steps)
        counts[kind] = (_opt_counts(tou), _opt_leaves(tou))
        want = tuple({k: (n * steps if k == kind else 0)
                      for k in OPT_KERNELS} for n in (1, n_leaves))
        if counts[kind] != want:
            fail("symbolic_train %s: kernel #7 (launches, leaves) %s, want "
                 "%s" % (kind, counts[kind], want))
        if not all(math.isfinite(x) for x in l2):
            fail("symbolic_train %s: non-finite loss %s" % (kind, l2))
        extra[kind] = {"losses": l2, "step_ms": [w * 1e3 for w in w2]}
        del st

    # one step from identical params, fused against the plain update
    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tiers = []
        for fused in (True, False):
            st = DataParallelTrainStep(sym, lr=0.05, momentum=0.9,
                                       fused_optupdate=fused, device=dev)
            st.init_from(step.params, step.aux, RESNET_SHAPES)
            st(batches[0])
            tiers.append(st)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prior
    bitwise, tier_err = True, 0.0
    a, b = tiers
    for n in a.param_names:
        for got, want in ((a.params[n], b.params[n]),
                          (a.opt_state["mom"][n], b.opt_state["mom"][n])):
            same, _ = _bit_diff(torch, got.detach(), want.detach())
            bitwise &= same
            tier_err = max(tier_err, scaled_err(got.detach(), want.detach()))
    if not bitwise and not tier_err <= 1e-6:
        fail("symbolic_train: fused and plain update tiers differ by %g of "
             "a leaf's max abs" % tier_err)
    del tiers, a, b
    step_ms = statistics.median(walls[1:]) * 1e3
    macs = graph_macs(torch, sym, RESNET_SHAPES)
    result = {"phase": "symbolic_train", "model": "resnet50",
              # forward multiply-adds x 2 flops x 3 (forward + the two
              # backward products of every conv and matmul)
              "macs_forward": macs, "gflop_per_step": 6 * macs / 1e9,
              "batch": list(RESNET_SHAPES["data"]), "setup_s": setup_s,
              "steps": SYM_STEPS, "first_step_ms": walls[0] * 1e3,
              "step_ms_p50": step_ms,
              "img_per_s": SYM_BATCH / step_ms * 1e3,
              "losses": losses, "tpu_kernel_leaves": n_el,
              "params": len(step.param_names),
              "launches_per_step":
                  counts["sgd_mom"][0]["sgd_mom"] / SYM_STEPS,
              "leaves_per_step": counts["sgd_mom"][1]["sgd_mom"] / SYM_STEPS,
              "program_count": step.program_count(),
              "peak_mem_gb": peak / 1e9, "adam": extra["adam"],
              "sgd": extra["sgd"],
              "tiers_bitwise": bitwise, "tiers_max_err": tier_err}
    return (result, {k: (counts[k][0][k], counts[k][1][k])
                     for k in OPT_KERNELS}, step, batches[0])


def cudnn_benchmark_step_ms(torch, fn, warm=3, n=5):
    """Median step wall (synchronized) with cuDNN's autotuner on, float32
    kept (no TF32): how much of the convolution time is the default
    algorithm choice. The port leaves the flag to the user; this only
    measures it."""
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for _ in range(warm):   # the first call tunes each shape
            fn()
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.benchmark = prior
    return statistics.median(walls)


def kind_of(name):
    """The kind of a device kernel, from its name (phase 11)."""
    n = name.lower()
    if "optupdate" in n:
        return "opt_update_#7"
    if "batch_norm" in n or "batchnorm" in n or "bn_fw" in n \
            or "bn_bw" in n:
        return "batch_norm"
    if "pool" in n:
        return "pooling"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "wgrad",
                            "dgrad", "fprop", "winograd", "cutlass",
                            "sm90", "sm80")):
        return "conv_matmul"
    if any(k in n for k in ("elementwise", "vectorized", "reduce",
                            "unrolled", "copy", "fill", "softmax",
                            "index", "cat")):
        return "elementwise_reduce"
    return "other"


# --- the long-context grid configuration (phases 12-14) --------------------

LONG_S = 4096          # the long configuration's sequence and table width
LONG_W = 512           # its block_k: 8 key splits of 4096
LONG_STEPS = 10
LONG_PROMPTS = (600, 1400, 2500, 3800)
#: grid kernel -> (C entry, launch counter, library, TPU function line)
GRID_KERNELS = {
    "fwd": ("mx_flash_fwd_grid_f32", "launches_fwd_grid",
            "flash_fwd_grid.cu", "1011"),
    "fwd_combine": ("mx_flash_fwd_grid_combine_f32",
                    "launches_fwd_grid_combine", "flash_fwd_grid.cu",
                    "1068"),
    "offs": ("mx_flash_fwd_offs_grid_f32", "launches_fwd_offs_grid",
             "flash_fwd_offs_grid.cu", "594"),
    "offs_combine": ("mx_flash_fwd_offs_grid_combine_f32",
                     "launches_fwd_offs_grid_combine",
                     "flash_fwd_offs_grid.cu", "646"),
    "dq": ("mx_flash_bwd_dq_grid_f32", "launches_bwd_dq_grid",
           "flash_bwd_grid.cu", "722"),
    "dq_reduce": ("mx_flash_bwd_dq_grid_reduce_f32",
                  "launches_bwd_dq_grid_reduce", "flash_bwd_grid.cu", "768"),
    "dkv": ("mx_flash_bwd_dkv_grid_f32", "launches_bwd_dkv_grid",
            "flash_bwd_grid.cu", "772"),
    "dkv_reduce": ("mx_flash_bwd_dkv_grid_reduce_f32",
                   "launches_bwd_dkv_grid_reduce", "flash_bwd_grid.cu",
                   "822"),
}
STREAM_COUNTERS = ("launches", "launches_fwd", "launches_bwd_dq",
                   "launches_bwd_dkv")


def long_config(TransformerConfig, num_layers=12, variant="grid"):
    """The long-context grid configuration: the serve phase's widths at
    max_len 4096 with the grid kernels and 512-key blocks."""
    return TransformerConfig(vocab_size=32000, num_layers=num_layers,
                             num_heads=8, d_model=512, max_len=LONG_S,
                             attn_variant=variant, block_k=LONG_W)


def n_live_kv(rows_pos, k0, w, n_split):
    """Key splits each causal row (global positions) can see."""
    return [0 if p < k0 else min((p - k0) // w + 1, n_split)
            for p in rows_pos]


def grid_bounds(b, h, sq, sk, d, q0, wq, wk):
    """{kernel: (flops, bytes)} of the causal grid kernels at these shapes,
    counting what these inputs need: visible keys only, and the workspace
    rows of the splits each row (key) can see."""
    nk, nq = -(-sk // wk), -(-sq // wq)
    bh, f = b * h, 4.0
    vis = bh * sum(visible_keys(sq, sk, q0, 0))
    live_rows = bh * sum(n_live_kv(range(q0, q0 + sq), 0, wk, nk))
    # query splits that see each key: those from the first row that does
    live_keys = bh * sum(0 if j > q0 + sq - 1 else
                         nq - max(0, j - q0) // wq for j in range(sk))
    n_q, n_k = bh * sq * d, bh * sk * d
    return {
        "fwd": (4.0 * vis * d, f * (n_q + 2 * n_k + live_rows * (d + 1))),
        "fwd_combine": (2.0 * live_rows * (d + 1),
                        f * (live_rows + bh * sq) * (d + 1)),
        "dq": (6.0 * vis * d, f * (2 * n_q + 2 * n_k + 2 * bh * sq
                                   + live_rows * d)),
        "dq_reduce": (1.0 * live_rows * d, f * (live_rows + bh * sq) * d),
        "dkv": (8.0 * vis * d, f * (2 * n_q + 2 * n_k + 2 * bh * sq
                                    + 2 * live_keys * d)),
        "dkv_reduce": (2.0 * live_keys * d,
                       f * 2 * (live_keys + bh * sk) * d),
    }


def phase_grid_kernel(torch, fa, dev):
    """The grid kernels against their plain versions (module docstring,
    phase 12). Returns (per-kernel worst errors, timing rows)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(SEED + 4)
    worst = {k: 0.0 for k in GRID_KERNELS}
    n_cases = 0

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    def check(kind, what, got, ref):
        err = scaled_err(got, ref)
        if not err <= TOL:
            fail("grid_kernel %s: %s max abs err %g > %g" % (what, kind, err,
                                                            TOL))
        worst[kind] = max(worst[kind], err)

    def identical(what, a, b):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                fail("grid_kernel %s: two calls on the same inputs differ"
                     % what)

    def run_twice(fn, ts_in, cot):
        """Outputs and input gradients of two calls of ``fn``."""
        runs = []
        for _ in range(2):
            ts = leaves(*ts_in)
            outs = fn(*ts)
            outs = outs if isinstance(outs, tuple) else (outs,)
            if any(o.grad_fn is None for o in outs):
                fail("grid_kernel: an output is cut off from autograd")
            torch.autograd.backward(outs, cot[:len(outs)])
            runs.append([o.detach() for o in outs]
                        + [t.grad for t in ts])
        return runs

    # #6 and #4 through _FlashAttention at 1, 8 and 128 key splits of the
    # long training shape, then a non-causal ragged case and head dims 32
    # and 128 with ragged splits
    for (b, h, s, d), causal, w in (
            ((4, 8, LONG_S, 64), True, LONG_S), ((4, 8, LONG_S, 64), True,
                                                 LONG_W),
            ((4, 8, LONG_S, 64), True, 32), ((2, 8, 1000, 64), False, 256),
            ((1, 4, 300, 32), True, 64), ((1, 4, 300, 128), True, 64)):
        what = "%s causal=%s block=%d" % ((b, h, s, d), causal, w)
        sm = 1.0 / math.sqrt(d)
        q, k, v, do = (rand(b, h, s, d) for _ in range(4))
        runs = run_twice(lambda *t: fa.flash_attention(
            *t, causal=causal, sm_scale=sm, block_q=w, block_k=w,
            use_pallas=True, variant="grid"), (q, k, v), (do,))
        identical(what, *runs)
        _, lse = fa._flash_fwd_grid_cuda(q, k, v, None, sm, causal,
                                         fa.split_width(w, s))
        ref_out, ref_lse = fa.flash_fwd_grid_plain(q, k, v, sm, causal, w)
        check("fwd", what + " out", runs[0][0], ref_out)
        check("fwd", what + " lse", lse, ref_lse)
        ref = fa.flash_bwd_offs_grid_plain(q, k, v, fa._offs0(dev), do, None,
                                           ref_out, ref_lse, sm, causal, w,
                                           w)
        check("dq", what + " dq", runs[0][1], ref[0])
        check("dkv", what + " dk", runs[0][2], ref[1])
        check("dkv", what + " dv", runs[0][3], ref[2])
        n_cases += 1
        del runs, ref, ref_out, ref_lse, lse
        torch.cuda.empty_cache()

    # #3 (and #4 with the lse cotangent) at the prefill shapes: the JAX
    # call's blocks (bq = min(512, C), bk = 512), one split and one split
    # per tile; offsets from the first chunk to the last of a 3800-token
    # prompt, and a ring-style one whose rows all see no key
    D = 64
    sm = 1.0 / math.sqrt(D)
    for C, (q0, k0), bk in ((1024, (0, 0), LONG_W), (1024, (2816, 0), LONG_W),
                            (256, (3840, 0), LONG_W), (256, (0, 2048), LONG_W),
                            (1024, (1024, 0), LONG_S), (256, (768, 0), 32),
                            (1024, (2816, 0), 32)):
        what = "with_lse C=%d offs=%s block_k=%d" % (C, (q0, k0), bk)
        bq = min(LONG_W, C)
        q, k, v = rand(1, 8, C, D), rand(1, 8, LONG_S, D), rand(1, 8, LONG_S,
                                                                 D)
        do, dlse = rand(1, 8, C, D), rand(1, 8, C)
        offs = torch.tensor([q0, k0], dtype=torch.int32, device=dev)
        runs = run_twice(lambda *t: fa.flash_attention_with_lse(
            *t, offs, sm, True, bq, bk, variant="grid"), (q, k, v),
            (do, dlse))
        identical(what, *runs)
        ref_out, ref_lse = fa.flash_fwd_offs_grid_plain(q, k, v, offs, sm,
                                                        True, bk)
        check("offs", what + " out", runs[0][0], ref_out)
        check("offs", what + " lse", runs[0][1], ref_lse)
        ref = fa.flash_bwd_offs_grid_plain(q, k, v, offs, do, dlse, ref_out,
                                           ref_lse, sm, True, bq, bk)
        check("dq", what + " dq", runs[0][2], ref[0])
        check("dkv", what + " dk", runs[0][3], ref[1])
        check("dkv", what + " dv", runs[0][4], ref[2])
        dead_rows = torch.arange(C, device=dev) + q0 < k0
        dead_keys = torch.arange(LONG_S, device=dev) + k0 > C - 1 + q0
        out, lse, dq, dk, dv = runs[0]
        if not (bool((lse[..., dead_rows] == NEG).all().item())
                and bool((out[..., dead_rows, :] == 0).all().item())
                and bool((dq[..., dead_rows, :] == 0).all().item())
                and bool((dk[..., dead_keys, :] == 0).all().item())
                and bool((dv[..., dead_keys, :] == 0).all().item())):
            fail("grid_kernel %s: fully masked rows or keys are not exactly "
                 "(0, -1e30) with zero gradients" % what)
        n_cases += 1
        del runs, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the combine and reduce passes alone, on the plain version's
    # partials (a split a row cannot see holds (0, -1e30) or zeros there,
    # which the kernels never read)
    t = {}
    B, H, S = 4, 8, LONG_S
    n_split = S // LONG_W
    q, k, v, do = (rand(B, H, S, D) for _ in range(4))
    offs0 = fa._offs0(dev)
    out_part, lse_part = fa.fwd_grid_parts(q, k, v, 0, 0, sm, True, LONG_W)
    out, lse = torch.empty_like(q), torch.empty(B, H, S, device=dev)
    combine = lambda: fa._launch(
        "mx_flash_fwd_grid_combine_f32", out_part.data_ptr(),
        lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(), B * H, S, D,
        LONG_W, n_split, 1, device=dev)
    combine()
    ref_out, ref_lse = fa._combine_splits(out_part, lse_part)
    check("fwd_combine", "combine out", out, ref_out)
    check("fwd_combine", "combine lse", lse, ref_lse)
    t["fwd_combine_ms"] = time_ms(combine)
    t["fwd_combine_plain_ms"] = time_ms(
        lambda: fa._combine_splits(out_part, lse_part), iters=5)
    t["fwd_plain_ms"] = time_ms(lambda: fa.fwd_grid_parts(
        q, k, v, 0, 0, sm, True, LONG_W), iters=3, reps=3)
    t["fwd_whole_plain_ms"] = time_ms(lambda: fa.flash_fwd_grid_plain(
        q, k, v, sm, True, LONG_W), iters=3, reps=3)
    ws_out, ws_lse = torch.empty_like(out_part), torch.empty_like(lse_part)
    t["fwd_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_fwd_grid_f32", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ws_out.data_ptr(), ws_lse.data_ptr(), B * H, S, S, D, LONG_W,
        n_split, sm, 1, device=dev), iters=5)
    t["fwd_whole_ms"] = time_ms(lambda: fa._flash_fwd_grid_cuda(
        q, k, v, None, sm, True, LONG_W), iters=5)
    t["fwd_stream_ms"] = time_ms(lambda: fa._flash_fwd_cuda(q, k, v, sm,
                                                            True), iters=5)
    sdpa = lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=True, scale=sm)
    t["sdpa_fwd_ms"] = time_ms(lambda: sdpa(q, k, v), iters=5)
    del out_part, lse_part, ws_out, ws_lse
    torch.cuda.empty_cache()

    out, lse = fa._flash_fwd_grid_cuda(q, k, v, None, sm, True, LONG_W)
    deff = fa._deff(do, out, None).contiguous()
    dq_part, dk_part, dv_part = fa.bwd_grid_parts(
        q, k, v, offs0, do, None, out, lse, sm, True, LONG_W, LONG_W)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dq_reduce = lambda: fa._launch(
        "mx_flash_bwd_dq_grid_reduce_f32", offs0.data_ptr(),
        dq_part.data_ptr(), dq.data_ptr(), B * H, S, D, LONG_W, n_split, sm,
        1, device=dev)
    dkv_reduce = lambda: fa._launch(
        "mx_flash_bwd_dkv_grid_reduce_f32", offs0.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, S, S, D, LONG_W, n_split, 1, device=dev)
    dq_reduce()
    dkv_reduce()
    check("dq_reduce", "dq reduce", dq, fa._sum_splits(dq_part) * sm)
    check("dkv_reduce", "dk reduce", dk, fa._sum_splits(dk_part))
    check("dkv_reduce", "dv reduce", dv, fa._sum_splits(dv_part))
    t["dq_reduce_ms"] = time_ms(dq_reduce)
    t["dkv_reduce_ms"] = time_ms(dkv_reduce)
    t["dq_reduce_plain_ms"] = time_ms(
        lambda: fa._sum_splits(dq_part) * sm, iters=5)
    t["dkv_reduce_plain_ms"] = time_ms(
        lambda: (fa._sum_splits(dk_part), fa._sum_splits(dv_part)), iters=5)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), offs0.data_ptr(),
              do.data_ptr(), lse.data_ptr(), deff.data_ptr())
    t["dq_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dq_grid_f32", *common, dq_part.data_ptr(), B * H, S, S,
        D, LONG_W, n_split, sm, 1, device=dev), iters=5)
    t["dkv_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dkv_grid_f32", *common, dk_part.data_ptr(),
        dv_part.data_ptr(), B * H, S, S, D, LONG_W, n_split, sm, 1,
        device=dev), iters=5)
    del dq_part, dk_part, dv_part
    torch.cuda.empty_cache()
    t["bwd_plain_ms"] = time_ms(lambda: fa.bwd_grid_parts(
        q, k, v, offs0, do, None, out, lse, sm, True, LONG_W, LONG_W),
        iters=1, reps=3)
    t["bwd_whole_ms"] = time_ms(lambda: fa._flash_bwd_grid_cuda(
        q, k, v, offs0, do, deff, lse, sm, True, (LONG_W, LONG_W)), iters=5)
    # #4 with one split (block 4096): the kernels write dq, dk, dv
    # directly and no reduce runs
    t["dq_1split_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dq_grid_f32", *common, dq.data_ptr(), B * H, S, S, D,
        S, 1, sm, 1, device=dev), iters=5)
    t["dkv_1split_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dkv_grid_f32", *common, dk.data_ptr(), dv.data_ptr(),
        B * H, S, S, D, S, 1, sm, 1, device=dev), iters=5)
    t["bwd_whole_1split_ms"] = time_ms(lambda: fa._flash_bwd_grid_cuda(
        q, k, v, offs0, do, deff, lse, sm, True, (S, S)), iters=5)
    stream_tail = (B * H, S, S, D, sm, 1)
    t["dq_stream_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dq_f32", *common, dq.data_ptr(), *stream_tail,
        device=dev), iters=3)
    t["dkv_stream_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dkv_f32", *common, dk.data_ptr(), dv.data_ptr(),
        *stream_tail, device=dev), iters=3)
    qg, kg, vg = leaves(q, k, v)
    t["sdpa_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        sdpa(qg, kg, vg), (qg, kg, vg), do), iters=5)
    t["sdpa_bwd_ms"] = t["sdpa_fwd_bwd_ms"] - t["sdpa_fwd_ms"]
    bounds = grid_bounds(B, H, S, S, D, 0, LONG_W, LONG_W)
    del q, k, v, do, out, lse, deff, dq, dk, dv, qg, kg, vg
    torch.cuda.empty_cache()

    # #3 at the last 1024-token chunk of a 3800-token prompt
    C, q0 = 1024, 2816
    q, k, v = rand(1, H, C, D), rand(1, H, S, D), rand(1, H, S, D)
    offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
    out_part, lse_part = fa.fwd_grid_parts(q, k, v, offs[0], offs[1], sm,
                                           True, LONG_W)
    out, lse = torch.empty_like(q), torch.empty(1, H, C, device=dev)
    combine = lambda: fa._launch(
        "mx_flash_fwd_offs_grid_combine_f32", offs.data_ptr(),
        out_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(),
        lse.data_ptr(), H, C, D, LONG_W, n_split, 1, device=dev)
    combine()
    ref_out, ref_lse = fa._combine_splits(out_part, lse_part)
    check("offs_combine", "offs combine out", out, ref_out)
    check("offs_combine", "offs combine lse", lse, ref_lse)
    t["offs_combine_ms"] = time_ms(combine)
    t["offs_combine_plain_ms"] = time_ms(
        lambda: fa._combine_splits(out_part, lse_part))
    ws_out, ws_lse = torch.empty_like(out_part), torch.empty_like(lse_part)
    t["offs_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_fwd_offs_grid_f32", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), offs.data_ptr(), ws_out.data_ptr(), ws_lse.data_ptr(),
        H, C, S, D, LONG_W, n_split, sm, 1, device=dev))
    t["offs_whole_ms"] = time_ms(lambda: fa._flash_fwd_grid_cuda(
        q, k, v, offs, sm, True, LONG_W))
    t["offs_stream_ms"] = time_ms(lambda: fa._flash_fwd_offs_cuda(
        q, k, v, offs, sm, True))
    t["offs_plain_ms"] = time_ms(lambda: fa.fwd_grid_parts(
        q, k, v, offs[0], offs[1], sm, True, LONG_W), iters=5)
    t["offs_whole_plain_ms"] = time_ms(lambda: fa.flash_fwd_offs_grid_plain(
        q, k, v, offs, sm, True, LONG_W), iters=5)
    mask = (torch.arange(C, device=dev)[:, None] + q0
            >= torch.arange(S, device=dev)[None, :])
    t["sdpa_offs_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm))
    ob = grid_bounds(1, H, C, S, D, q0, LONG_W, LONG_W)
    bounds["offs"], bounds["offs_combine"] = ob["fwd"], ob["fwd_combine"]
    for name, (flops, nbytes) in bounds.items():
        for key, val in attention_bounds(flops, nbytes).items():
            t[name + "_" + key] = val
        t[name + "_flops"], t[name + "_bytes"] = flops, nbytes
        t[name + "_tflops"] = tflops(flops, t[name + "_ms"])
    # #4 (pass 1 and reduce of dq and dk/dv) against SDPA's backward, with
    # 8 splits and with one
    t["bwd_vs_sdpa"] = (t["dq_ms"] + t["dq_reduce_ms"] + t["dkv_ms"]
                        + t["dkv_reduce_ms"]) / t["sdpa_bwd_ms"]
    t["bwd_1split_vs_sdpa"] = ((t["dq_1split_ms"] + t["dkv_1split_ms"])
                               / t["sdpa_bwd_ms"])
    t["dq_1split_tflops"] = tflops(t["dq_flops"], t["dq_1split_ms"])
    t["dkv_1split_tflops"] = tflops(t["dkv_flops"], t["dkv_1split_ms"])
    t["fwd_vs_sdpa"] = (t["fwd_ms"] + t["fwd_combine_ms"]) / t["sdpa_fwd_ms"]
    t["cases"] = n_cases
    return worst, t


def phase_serve_long(torch, fa, dev, seed, out_dir):
    """The long-context configuration served (module docstring, phase
    13). Returns (result, launches per grid kernel on the run)."""
    import numpy as np
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, TransformerDecodeModel, transformer_decode_prefill,
        transformer_decode_step)
    from mxnet_tpu_torch.serving import DecodeEngine
    cfg = long_config(TransformerConfig)
    t0 = time.perf_counter()
    model = TransformerDecodeModel(cfg, seed=seed, device=dev)
    if not model.use_kernel:
        fail("serve_long: model on %s did not resolve to the kernel tier"
             % dev)
    eng = DecodeEngine(block_size=16, num_blocks=1025, batch_size=4,
                       max_seq_len=LONG_S, prefill_buckets=(256, 1024),
                       prefill_chunk=1024, **model.engine_kwargs())
    setup_s = time.perf_counter() - t0
    counters = [GRID_KERNELS[k][1] for k in ("offs", "offs_combine")]
    try:
        rng = np.random.RandomState(seed)
        lengths = [n + int(rng.randint(-32, 33)) for n in LONG_PROMPTS]
        prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in lengths]
        new = 32
        stamps = {}

        def on_token(stream, seq_no, token):
            stamps.setdefault(stream.rid, []).append(time.monotonic())

        torch.cuda.synchronize()
        for name in counters + list(STREAM_COUNTERS):
            setattr(fa, name, 0)
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new, on_token=on_token)
                   for p in prompts]
        outs = [s.result_wait(600.0) for s in streams]
        wall = time.perf_counter() - t0
        counts = {name: getattr(fa, name) for name in counters}
        stream_counts = {name: getattr(fa, name) for name in STREAM_COUNTERS}
        calls = sum(-(-n // 1024) for n in lengths)
        st = eng.stats()
        if st["served"] != len(prompts):
            fail("serve_long: served %d of %d" % (st["served"], len(prompts)))
        for name in counters:
            if counts[name] != cfg.num_layers * calls:
                fail("serve_long: %s = %d, want %d (12 per prefill call, %d "
                     "calls)" % (name, counts[name], cfg.num_layers * calls,
                                 calls))
        if any(stream_counts.values()):
            fail("serve_long: stream kernels launched: %s" % stream_counts)
        if st["kv"]["blocks_live"] != 0:
            fail("serve_long: %d KV blocks still live"
                 % st["kv"]["blocks_live"])
        for o in outs:
            if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
                fail("serve_long: bad stream %s" % o)
        ttft = [stamps[s.rid][0] - s.submitted_t for s in streams]
        gaps = [b - a for s in streams
                for a, b in zip(stamps[s.rid], stamps[s.rid][1:])]
        solo = [eng.generate(p, max_new_tokens=new, timeout=600.0)
                for p in prompts]
        if solo != outs:
            bad = [i for i, (a, b) in enumerate(zip(solo, outs)) if a != b]
            fail("serve_long: continuous != solo for prompts %s" % bad)
    finally:
        eng.stop()

    # reference: the third 1024-token chunk of the longest prompt (start
    # 2048, 8 key splits of which 5-6 are live) through the kernel against
    # the plain tier, on the same pages, which the plain tier filled with
    # the first two chunks
    i64 = dict(dtype=torch.int64, device=dev)
    n_blocks = LONG_S // 16
    table = torch.arange(1, n_blocks + 1, **i64)
    kp = torch.zeros((n_blocks + 1, 16, cfg.num_layers, cfg.d_model),
                     device=dev)
    vp = torch.zeros_like(kp)
    prompt = prompts[-1]

    def chunk(kp_, vp_, start, use_kernel):
        toks = torch.tensor(prompt[start:start + 1024], **i64)
        return transformer_decode_prefill(
            model.params, cfg, kp_, vp_, toks, torch.tensor(start, **i64),
            torch.tensor(1024, **i64), table, use_kernel=use_kernel)
    for start in (0, 1024):
        _, kp, vp = chunk(kp, vp, start, False)
    pages = {}
    for use_kernel in (True, False):
        tok, kpu, vpu = chunk(kp.clone(), vp.clone(), 2048, use_kernel)
        pages[use_kernel] = (int(tok.item()), kpu, vpu)
    page_err = max(
        (pages[True][1][1:] - pages[False][1][1:]).abs().max().item(),
        (pages[True][2][1:] - pages[False][2][1:]).abs().max().item())
    if not page_err <= TOL:
        fail("serve_long: kernel-tier prefill pages differ from the plain "
             "tier by %g" % page_err)
    # where the time of the two long serving programs goes: the batch-4
    # decode step over 4096-position tables and the 1024-token prefill
    # chunk at start 2048 (fresh pages: device time does not depend on
    # their content)
    del pages
    ids = torch.zeros(4, **i64)
    pos = torch.full((4,), LONG_S - 200, **i64)
    tables = table.repeat(4, 1)
    active = torch.ones(4, dtype=torch.bool, device=dev)
    toks = torch.tensor(prompt[2048:3072], **i64)
    start, length = torch.tensor(2048, **i64), torch.tensor(1024, **i64)
    programs = {
        "step_b4_t4096": lambda: transformer_decode_step(
            model.params, cfg, kp, vp, ids, pos, tables, active),
        "prefill_c1024_grid": lambda: transformer_decode_prefill(
            model.params, cfg, kp, vp, toks, start, length, table,
            use_kernel=True)}
    profiles = {name: profile_calls(torch, fn, name, out_dir, warm=2, n=10,
                                    calls=3, classify=kind_of_attention)
                for name, fn in programs.items()}
    del model, kp, vp
    result = {"phase": "serve_long", "setup_s": setup_s, "wall_s": wall,
              "prompt_tokens": lengths,
              "tokens": sum(len(o) for o in outs),
              "tokens_per_s": sum(len(o) for o in outs) / wall,
              "ttft_ms": [x * 1e3 for x in ttft],
              "ttft_p50_ms": statistics.median(ttft) * 1e3,
              "intertoken_p50_ms": statistics.median(gaps) * 1e3,
              "prefill_calls": calls, "launches": counts,
              "stream_launches": stream_counts, "steps": st["steps"],
              "program_counts": list(eng.program_counts()),
              "continuous_equals_solo": True,
              "prefill_pages_max_abs_err_vs_plain": page_err,
              "profile": profiles}
    return result, counts


def kind_of_attention(name):
    """The kind of a device kernel of the transformer step (phase 14)."""
    n = name.lower()
    if "grid" in n and ("combine" in n or "reduce" in n):
        return "attention_combine_reduce"
    if "flash" in n:
        return "attention"
    if any(k in n for k in ("gemm", "sgemm", "cutlass", "xmma", "sm90",
                            "sm80", "ampere", "matmul")):
        return "matmul"
    return "elementwise_other"


def phase_train_long(torch, fa, dev, seed, out_dir):
    """The long-context configuration trained (module docstring, phase
    14). Returns (result, launches per grid kernel on the run)."""
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_loss)
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves, tree_map
    cfg = long_config(TransformerConfig)
    B, S = 4, LONG_S
    t0 = time.perf_counter()
    params = init_transformer(cfg, torch.Generator().manual_seed(seed), dev)
    make_batch = periodic_batches(seed, cfg.vocab_size, S, B)
    batches = [{k: torch.as_tensor(x).to(dev) for k, x in make_batch().items()}
               for _ in range(LONG_STEPS)]

    def make_step(c, p):
        return ShardedTrainStep(
            lambda p_, b: transformer_loss(p_, b["tokens"], b["targets"], c),
            optimizer="adam", lr=1e-3, grad_clip=1.0, device=dev).init(p)

    step = make_step(cfg, params)
    setup_s = time.perf_counter() - t0
    counters = [v[1] for k, v in GRID_KERNELS.items()
                if k not in ("offs", "offs_combine")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for name in counters + list(STREAM_COUNTERS):
        setattr(fa, name, 0)
    losses, walls = [], []
    t0 = time.perf_counter()
    for b in batches:
        ts = time.perf_counter()
        losses.append(step(b).item())      # .item() synchronizes
        walls.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    counts = {name: getattr(fa, name) for name in counters}
    stream_counts = {name: getattr(fa, name) for name in STREAM_COUNTERS}
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        fail("train_long: non-finite loss in %s" % losses)
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail("train_long: loss did not fall: %s" % losses)
    want = cfg.num_layers * LONG_STEPS
    for name in counters:
        if counts[name] != want:
            fail("train_long: %s = %d, want %d (12 per step)"
                 % (name, counts[name], want))
    if any(stream_counts.values()):
        fail("train_long: stream kernels launched: %s" % stream_counts)
    if step.program_count() != 1:
        fail("train_long: %d step signatures, want 1" % step.program_count())
    step_ms = statistics.median(walls[1:]) * 1e3

    # as a measurement only: one step of the same model and batch with
    # the stream kernels, then one grid step under torch.profiler
    stream_step = make_step(long_config(TransformerConfig, variant="stream"),
                            tree_map(lambda x: x.detach().clone(),
                                     step.params))
    stream_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        stream_step(batches[0]).item()
        stream_walls.append((time.perf_counter() - ts) * 1e3)
    del stream_step
    torch.cuda.empty_cache()
    prof = profile_calls(torch, lambda: step(batches[0]).item(), "train_long",
                         out_dir, warm=1, n=2, calls=1,
                         classify=kind_of_attention)
    del step
    torch.cuda.empty_cache()

    # one step's loss and gradients, kernel tier against plain tier, at
    # full width and S = 4096 but 2 layers (the plain tier keeps every
    # block's scores for autograd: 0.27 GB per 512-key block per layer)
    cfg2 = long_config(TransformerConfig, num_layers=2)
    params2 = init_transformer(cfg2, torch.Generator().manual_seed(seed),
                               dev)
    prior = os.environ.get(PLAIN_TIER)
    tiers = {}
    try:
        for tier in ("on", "off"):
            os.environ[PLAIN_TIER] = tier
            p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                         params2)
            before = fa.launches_fwd_grid
            loss = transformer_loss(p, batches[0]["tokens"],
                                    batches[0]["targets"], cfg2)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            tiers[tier] = (loss.item(), grads,
                           fa.launches_fwd_grid - before)
            del loss, p
    finally:
        if prior is None:
            os.environ.pop(PLAIN_TIER, None)
        else:
            os.environ[PLAIN_TIER] = prior
    if tiers["on"][2] != cfg2.num_layers or tiers["off"][2] != 0:
        fail("train_long: tier comparison launched %d / %d grid forwards"
             % (tiers["on"][2], tiers["off"][2]))
    loss_rel = abs(tiers["on"][0] - tiers["off"][0]) / abs(tiers["off"][0])
    if not loss_rel <= 1e-5:
        fail("train_long: kernel-tier loss %r vs plain %r"
             % (tiers["on"][0], tiers["off"][0]))
    grad_err = max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(tiers["on"][1], tiers["off"][1]))
    if not grad_err <= TOL:
        fail("train_long: kernel-tier gradients differ from the plain tier "
             "by %g of a leaf's max abs" % grad_err)
    result = {"phase": "train_long", "setup_s": setup_s,
              "steps": LONG_STEPS, "batch": [B, S], "wall_s": wall,
              "first_step_ms": walls[0] * 1e3, "step_ms_p50": step_ms,
              "tokens_per_s": B * S / step_ms * 1e3, "losses": losses,
              "launches": counts, "stream_launches": stream_counts,
              "program_count": 1, "peak_mem_gb": peak / 1e9,
              "stream_variant_step_ms": stream_walls,
              "profile": prof,
              "tier_layers": cfg2.num_layers,
              "tier_loss": [tiers["on"][0], tiers["off"][0]],
              "tier_loss_rel_err": loss_rel, "tier_grad_err": grad_err}
    return result, counts


# --- runtime user kernels, mx.rtc (phases 15-16) -----------------------------

RTC_REF = "mxnet_tpu/rtc.py:"
RTC_BLOCK = 256
RTC_ALPHA = 0.1          # rounded to float32 alike by ctypes and by torch
RTC_BIG_SMEM = 96 * 1024  # above the 48 KB a block gets without opting in
RTC_FORWARDS = 12       # per graph, in turns; the first 2 are warm-up
#: MXNet's rtc pattern: an ``extern "C"`` kernel and a template staged
#: through dynamic shared memory, exported as ``saxpy<float>`` and
#: ``saxpy<double>``. Compiled with ``--fmad=false``, so that ``y + alpha
#: * x`` rounds twice, as the two torch ops of the plain version do.
RTC_AXPY_SOURCE = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    y[i] += alpha * x[i];
}

template <typename DType>
__global__ void saxpy(const DType *x, DType *y, DType alpha, long long n) {
  extern __shared__ double smem_raw[];
  DType *smem = reinterpret_cast<DType *>(smem_raw);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    smem[threadIdx.x] = x[i];
    y[i] += alpha * smem[threadIdx.x];
  }
}
"""
RTC_AXPY_SIG = "const {t} *x, {t} *y, {t} alpha, int64_t n"
#: The user op of the full-width path: relu over n float32 elements, one
#: read and one write each, so bound by bytes; a grid-stride loop. The
#: sources spell 64-bit integers ``long long``, which NVRTC knows without
#: headers; the signatures name them ``int64_t``, as MXNet's types do.
USER_RELU_SOURCE = r"""
extern "C" __global__ void user_relu(const float *x, float *y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    y[i] = x[i] > 0.0f ? x[i] : 0.0f;
}
"""
USER_RELU_SIG = "const float *x, float *y, int64_t n"


def rtc_grid(n):
    return ((n + RTC_BLOCK - 1) // RTC_BLOCK, 1, 1), (RTC_BLOCK, 1, 1)


def triton_double_kernel():
    """The JAX package's rtc test kernel (``o = x * 2``) as a
    ``@triton.jit`` function: one masked elementwise pass per block."""
    import triton
    import triton.language as tl

    @triton.jit
    def double_kernel(x_ptr, out_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask)
        tl.store(out_ptr + offs, x * 2.0, mask=mask)

    return double_kernel


def host_us(torch, fn, n=200):
    """Host microseconds per eager call of ``fn``: the enqueue, timed on
    the host clock before the closing synchronize (at a size whose device
    time is below it)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def expect_raise(what, fn, errors, match=None):
    """``fn()`` must raise one of ``errors`` (with ``match`` in the
    message); returns the message."""
    try:
        fn()
    except errors as e:
        if match is not None and match not in str(e):
            fail("rtc_kernel %s: raised %r without %r" % (what, e, match))
        return str(e)
    fail("rtc_kernel %s: did not raise" % what)


def resnet50_param_count(tres):
    sym = tres.get_symbol(num_classes=1000, num_layers=50,
                          image_shape="3,224,224")
    arg_shapes, _, _ = sym.infer_shape(**RESNET_SHAPES)
    return sum(math.prod(s) for n, s in zip(sym.list_arguments(), arg_shapes)
               if n not in RESNET_SHAPES)


def phase_rtc_kernel(torch, dev):
    """``mx.rtc`` at the size of ResNet-50's parameters (module docstring,
    phase 15). Returns (result, kernel rows)."""
    from mxnet_tpu_torch import MXNetError, rtc
    from mxnet_tpu_torch.kernels import _rtc_driver
    from mxnet_tpu_torch.models import resnet as tres
    major, minor, nvrtc_path = _rtc_driver.nvrtc_version()
    n = resnet50_param_count(tres)
    mod = rtc.CudaModule(RTC_AXPY_SOURCE, options=("--fmad=false",),
                         exports=("saxpy<float>", "saxpy<double>"))
    axpy = mod.get_kernel("axpy", RTC_AXPY_SIG.format(t="float"))
    sax_f = mod.get_kernel("saxpy<float>", RTC_AXPY_SIG.format(t="float"))
    sax_d = mod.get_kernel("saxpy<double>", RTC_AXPY_SIG.format(t="double"))
    tmod = rtc.TritonModule()
    tdouble = tmod.add_kernel("double", triton_double_kernel(),
                              lambda x: torch.empty_like(x),
                              plain_fn=lambda x: x * 2.0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    x = torch.randn(n, device=dev, generator=gen)
    y0 = torch.randn(n, device=dev, generator=gen)
    xd = torch.randn(n, device=dev, generator=gen, dtype=torch.float64)
    yd0 = torch.randn(n, device=dev, generator=gen, dtype=torch.float64)
    grid, block = rtc_grid(n)
    t_grid = ((n + 1023) // 1024,)
    torch.cuda.synchronize()

    # the path: every count to 0, then each kernel once at full size
    kernels = {"axpy": axpy, "saxpy_f32_smem96k": sax_f,
               "saxpy_f64": sax_d, "triton_double": tdouble}
    for k in kernels.values():
        k.launches = 0
    y, ys, yd = y0.clone(), y0.clone(), yd0.clone()
    axpy.launch([x, y, RTC_ALPHA, n], dev, grid, block)
    sax_f.launch([x, ys, RTC_ALPHA, n], dev, grid, block, RTC_BIG_SMEM)
    sax_d.launch([xd, yd, RTC_ALPHA, n], dev, grid, block,
                 RTC_BLOCK * 8)
    x2 = tdouble.launch([x], t_grid, n=n, BLOCK=1024)._data
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in kernels.items()}
    if counts != {k: 1 for k in kernels}:
        fail("rtc_kernel: launch counts %s, want one each" % counts)

    plain = {"axpy": y0 + RTC_ALPHA * x, "saxpy_f64": yd0 + RTC_ALPHA * xd,
             "triton_double": x * 2.0}
    plain["saxpy_f32_smem96k"] = plain["axpy"]
    got = {"axpy": y, "saxpy_f32_smem96k": ys, "saxpy_f64": yd,
           "triton_double": x2}
    errs = {}
    for k in kernels:
        errs[k] = (got[k] - plain[k]).abs().max().item()
        if not _bit_diff(torch, got[k], plain[k])[0]:
            fail("rtc_kernel %s: differs from its plain version (max abs "
                 "diff %g)" % (k, errs[k]))

    # every refused launch raises and writes nothing
    before = y.clone()
    cpu = torch.device("cpu")
    refusals = {
        "dtype": expect_raise("dtype mismatch", lambda: axpy.launch(
            [xd, y, RTC_ALPHA, n], dev, grid, block), MXNetError,
            "takes torch.float32"),
        "cpu_ctx": expect_raise("cpu ctx", lambda: axpy.launch(
            [x[:8].cpu(), y[:8].cpu(), RTC_ALPHA, 8], cpu, grid, block),
            MXNetError,
            "only be launched on GPU"),
        "block_2048": expect_raise("2048-thread block", lambda: axpy.launch(
            [x, y, RTC_ALPHA, n], dev, grid, (2048, 1, 1)), MXNetError,
            "cuLaunchKernel"),
        "smem_300k": expect_raise("300 KB of shared memory",
                                  lambda: sax_f.launch(
            [x, y, RTC_ALPHA, n], dev, grid, block, 300 * 1024), MXNetError,
            "MAX_DYNAMIC_SHARED"),
        "compile": expect_raise("a source that does not compile",
                                lambda: rtc.CudaModule(
            'extern "C" __global__ void broken(float *x) '
            '{ x[0] = undefined_name; }'), MXNetError, "undefined_name"),
        "signature": expect_raise("a malformed signature",
                                  lambda: mod.get_kernel("axpy", "float x y"),
                                  ValueError),
        "ctype": expect_raise("an unknown C type",
                              lambda: mod.get_kernel("axpy", "half *x"),
                              TypeError)}
    torch.cuda.synchronize()
    if not torch.equal(y, before):
        fail("rtc_kernel: a refused launch wrote its output")
    if {k: v.launches for k, v in kernels.items()} != counts:
        fail("rtc_kernel: a refused launch was counted")

    # a registered op's nd function puts host data (a list) on the card,
    # as NDArray does, and launches its kernel (register_triton_op's path;
    # no plain_fn, so the CPU would raise)
    tnd = rtc.register_triton_op(
        "rtc_smoke_double", triton_double_kernel(),
        lambda v: torch.empty_like(v),
        grid=lambda v: ((v.numel() + 1023) // 1024,),
        kwargs=lambda v: {"n": v.numel(), "BLOCK": 1024})
    host_out = tnd([float(i - 2048) for i in range(4096)])
    torch.cuda.synchronize()
    if host_out.context != dev or tnd.kernel.launches != 1 or \
            not torch.equal(host_out._data, 2.0 * torch.arange(
                -2048, 2048, device=dev, dtype=torch.float32)):
        fail("rtc_kernel: the registered Triton op on host data ran on %s "
             "with %d launches" % (host_out.context, tnd.kernel.launches))

    # device times (CUDA graphs), the bound, and eager host cost
    ms = {"axpy": time_ms(lambda: axpy.launch([x, y, RTC_ALPHA, n], dev,
                                              grid, block)),
          "saxpy_f32_smem96k": time_ms(lambda: sax_f.launch(
              [x, ys, RTC_ALPHA, n], dev, grid, block, RTC_BIG_SMEM)),
          "saxpy_f64": time_ms(lambda: sax_d.launch(
              [xd, yd, RTC_ALPHA, n], dev, grid, block, RTC_BLOCK * 8)),
          "triton_double": time_ms(lambda: tdouble.launch(
              [x], t_grid, n=n, BLOCK=1024))}
    plain_ms = {"axpy": time_ms(lambda: y + RTC_ALPHA * x),
                "saxpy_f64": time_ms(lambda: yd + RTC_ALPHA * xd),
                "triton_double": time_ms(lambda: x * 2.0)}
    plain_ms["saxpy_f32_smem96k"] = plain_ms["axpy"]
    lib_ms = {"axpy": time_ms(lambda: torch.add(y, x, alpha=RTC_ALPHA)),
              "saxpy_f64": time_ms(lambda: torch.add(yd, xd,
                                                     alpha=RTC_ALPHA)),
              "triton_double": time_ms(lambda: torch.mul(x, 2.0))}
    lib_ms["saxpy_f32_smem96k"] = lib_ms["axpy"]
    rows = {}
    for k in kernels:
        size = 8 if k == "saxpy_f64" else 4
        per = 2 if k == "triton_double" else 3   # arrays read or written
        b_ms, b_by = bound_ms((1 if k == "triton_double" else 2) * n,
                              per * size * n)
        rows[k] = {"ms": ms[k], "plain_ms": plain_ms[k],
                   "library_ms": lib_ms[k], "bound_ms": b_ms,
                   "bound_by": b_by, "share": b_ms / ms[k],
                   "max_abs_err": errs[k], "launches": counts[k]}
    xs, ys_small = x[:4096].clone(), y[:4096].clone()
    sgrid, sblock = rtc_grid(4096)
    eager = {"cudakernel_launch_us": host_us(torch, lambda: axpy.launch(
        [xs, ys_small, RTC_ALPHA, 4096], dev, sgrid, sblock)),
        "torch_add_us": host_us(torch, lambda: torch.add(
            ys_small, xs, alpha=RTC_ALPHA)),
        "triton_launch_us": host_us(torch, lambda: tdouble.launch(
            [xs], (4,), n=4096, BLOCK=1024))}
    result = {"phase": "rtc_kernel", "nvrtc": "%d.%d" % (major, minor),
              "nvrtc_path": nvrtc_path, "n": n,
              "compile_s": mod.compile_seconds,
              "compile_log": mod.log, "bitwise": True, "kernels": rows,
              "refusals": {k: v.splitlines()[0][:160]
                           for k, v in refusals.items()},
              "host_data_device": str(host_out.context),
              "eager_host": eager}
    return result, rows


def activation_shapes(torch, sym, shapes):
    """Output shapes of ``sym``'s Activation nodes at ``shapes``, in
    graph order."""
    return [tuple(outs[0].shape) for node, _, outs in
            meta_walk(torch, sym, shapes) if node.op.name == "Activation"]


def resnet_values(torch, sym, dev, seed):
    """Seeded weights, BN affine parameters and moving statistics, and a
    batch, on the card. Convolutions take 0.7 of the He-normal scale:
    inference BatchNorm with these statistics does not renormalize, so at
    the full scale the pre-activation residual sum doubles its variance
    unit by unit and the softmax saturates; at 0.7 the log-probabilities
    of a row span about 3 (a batch of 4 on the CPU)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    arg_shapes, _, aux_shapes = sym.infer_shape(**RESNET_SHAPES)

    def rand(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, device=dev, generator=gen)

    def randn(shape, std):
        return std * torch.randn(shape, device=dev, generator=gen)

    args, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            args[name] = rand(shape, -1, 1)
        elif name == "softmax_label":
            args[name] = torch.randint(0, 1000, shape, device=dev,
                                       generator=gen).float()
        elif name.endswith("_gamma"):
            args[name] = rand(shape, 0.8, 1.2)
        elif name.endswith("_beta") or name.endswith("_bias"):
            args[name] = randn(shape, 0.1)
        elif name.startswith("fc"):
            args[name] = randn(shape, 0.01)
        else:
            args[name] = randn(shape, 0.7 * math.sqrt(
                2.0 / math.prod(shape[1:])))
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = (randn(shape, 0.1) if name.endswith("_mean")
                     else rand(shape, 0.5, 1.5))
    return args, aux


def kind_of_rtc(name):
    """The kind of a device kernel of the rtc_infer forward (phase 16)."""
    return "user_relu_#8" if "user_relu" in name else kind_of(name)


def phase_rtc_infer(torch, dev, seed, out_dir):
    """ResNet-50 inference with a runtime-compiled user op in place of
    every relu (module docstring, phase 16). Returns (result, the
    user_relu kernel row)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.kernels import _rtc_driver
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.ops import find_op
    from mxnet_tpu_torch.symbol import load_json
    t0 = time.perf_counter()
    mod = rtc.CudaModule(USER_RELU_SOURCE)
    relu_k = mod.get_kernel("user_relu", USER_RELU_SIG)

    def plain_relu(x):
        if x.is_cuda:
            fail("rtc_infer: a CUDA tensor reached user_relu's plain version")
        return torch.clamp_min(x, 0)

    relu_nd = rtc.register_cuda_op(
        "user_relu", relu_k, lambda x: torch.empty_like(x),
        lambda x: rtc_grid(x.numel()), scalars=lambda x: (x.numel(),),
        plain_fn=plain_relu)
    sym = tres.get_symbol(num_classes=1000, num_layers=50,
                          image_shape="3,224,224")
    graph = json.loads(sym.tojson())
    rewritten = [nd["name"] for nd in graph["nodes"]
                 if nd["op"] == "Activation"
                 and nd.get("attrs", {}).get("act_type") == "relu"]
    for nd in graph["nodes"]:
        if nd["name"] in rewritten:
            nd["op"] = "user_relu"
    user_sym = load_json(json.dumps(graph))
    shapes = activation_shapes(torch, sym, RESNET_SHAPES)
    if len(rewritten) != 50 or len(shapes) != 50:
        fail("rtc_infer: %d relu nodes rewritten (%d Activation outputs), "
             "want 50" % (len(rewritten), len(shapes)))
    elements = sum(math.prod(s) for s in shapes)
    args, aux = resnet_values(torch, sym, dev, seed)
    exes = {}
    for key, s in (("builtin", sym), ("user", user_sym)):
        exe = s.simple_bind(dev, grad_req="null", **RESNET_SHAPES)
        for k, v in args.items():
            exe.arg_dict[k][:] = v
        for k, v in aux.items():
            exe.aux_dict[k][:] = v
        exes[key] = exe
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    activation, user_op = find_op("Activation"), find_op("user_relu")
    act_fn, user_fn = activation.fn, user_op.fn
    act_calls, relu_inputs = [0], []

    def counting_act(params, x):
        if x.device.type != "meta":
            act_calls[0] += 1
        return act_fn(params, x)

    def recording_user(params, x):
        if x.device.type == "cuda" and len(relu_inputs) < 50:
            relu_inputs.append(x)
        return user_fn(params, x)

    prior = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    walls, outs = {"user": [], "builtin": []}, {"user": [], "builtin": []}
    acts = {}
    try:
        # one untimed forward of each graph with the op functions wrapped:
        # which op ran each relu, and the user op's inputs
        activation.fn, user_op.fn = counting_act, recording_user
        try:
            for key in ("user", "builtin"):
                calls_before = act_calls[0]
                # the executor writes its bound outputs in place (as
                # MXNet's do): keep a copy of each forward's
                outs[key].append(
                    exes[key].forward(is_train=False)[0]._data.clone())
                acts[key] = act_calls[0] - calls_before
        finally:
            activation.fn, user_op.fn = act_fn, user_fn
        torch.cuda.synchronize()
        # the path, as a user runs it: the rewritten graph's forwards, its
        # kernel's count at 0 just before and read just after; the built-in
        # graph's forwards in turns with them (the host's speed drifts)
        relu_k.launches = 0
        for _ in range(RTC_FORWARDS):
            for key in ("user", "builtin"):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                out = exes[key].forward(is_train=False)[0]._data
                torch.cuda.synchronize()
                walls[key].append((time.perf_counter() - ts) * 1e3)
                outs[key].append(out.clone())
        launches = relu_k.launches
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prior
    if launches != 50 * RTC_FORWARDS or relu_k.launches != launches:
        fail("rtc_infer: user_relu launched %d times in %d forwards (then "
             "%d), want 50 each" % (launches, RTC_FORWARDS, relu_k.launches))
    if acts != {"user": 0, "builtin": 50}:
        fail("rtc_infer: Activation ran %s times, want none in the "
             "rewritten graph and 50 a forward in the built-in one" % acts)
    want = outs["builtin"][0]
    if tuple(want.shape) != (SYM_BATCH, 1000) or \
            not torch.isfinite(want).all():
        fail("rtc_infer: output of shape %s, finite: %s"
             % (tuple(want.shape), torch.isfinite(want).all().item()))
    for key in ("user", "builtin"):
        for i, o in enumerate(outs[key]):
            if not _bit_diff(torch, o, want)[0]:
                fail("rtc_infer: %s forward %d differs from the built-in "
                     "graph (max abs diff %g)" % (
                         key, i, (o - want).abs().max().item()))
    # the op's nd function puts host data (a list) on the card and
    # launches the kernel there, not plain_relu
    before = relu_k.launches
    host_out = relu_nd([-1.5, 0.0, 2.5, -0.0, 3.0])
    torch.cuda.synchronize()
    if host_out.context != dev or relu_k.launches != before + 1 or \
            host_out.asnumpy().tolist() != [0.0, 0.0, 2.5, 0.0, 3.0]:
        fail("rtc_infer: user_relu on host data ran on %s, %d launches, "
             "gave %s" % (host_out.context, relu_k.launches - before,
                          host_out.asnumpy().tolist()))
    if [tuple(x.shape) for x in relu_inputs] != shapes:
        fail("rtc_infer: the user op saw shapes %s, inferred %s"
             % ([tuple(x.shape) for x in relu_inputs], shapes))

    # device time of one forward's 50 launches over its own tensors
    relu_outs = [torch.empty_like(x) for x in relu_inputs]
    dims = [rtc_grid(x.numel()) for x in relu_inputs]

    def kernel50():
        for x, o, (g, b) in zip(relu_inputs, relu_outs, dims):
            relu_k.launch([x, o, x.numel()], dev, g, b)

    err = 0.0
    kernel50()
    for x, o in zip(relu_inputs, relu_outs):
        ref = torch.clamp_min(x, 0)
        if not _bit_diff(torch, o, ref)[0]:
            fail("rtc_infer: user_relu differs from clamp_min at %s"
                 % (tuple(x.shape),))
        err = max(err, (o - ref).abs().max().item())
    ms = time_ms(kernel50, iters=5)
    plain_ms = time_ms(lambda: [torch.clamp_min(x, 0) for x in relu_inputs],
                       iters=5)
    lib_ms = time_ms(lambda: [F.relu(x) for x in relu_inputs], iters=5)
    b_ms, b_by = bound_ms(elements, 8 * elements)
    # host cost a node: the user op (outputs allocated, then the launch)
    # and the built-in relu, as run_graph calls them, and the launch
    # alone, on one image of the last relu's input
    xs, xo = relu_inputs[-1][:1], relu_outs[-1][:1]
    act_params = activation.make_params({"act_type": "relu"})
    user_params = user_op.make_params({})
    op_host = {"user_relu_op_us": host_us(
        torch, lambda: user_op.apply(user_params, [xs])),
        "activation_relu_op_us": host_us(
            torch, lambda: activation.apply(act_params, [xs])),
        "cudakernel_launch_us": host_us(torch, lambda: relu_k.launch(
            [xs, xo, xs.numel()], dev, *rtc_grid(xs.numel())))}
    del relu_outs, xo
    prof = profile_calls(torch, lambda: exes["user"].forward(is_train=False),
                         "rtc_infer", out_dir, warm=2, n=5, calls=3,
                         classify=kind_of_rtc)
    probs = want.float()
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
           "max_abs_err": err, "launches": launches,
           "elements": elements}
    major, minor, nvrtc_path = _rtc_driver.nvrtc_version()
    result = {"phase": "rtc_infer", "model": "resnet50",
              "nvrtc": "%d.%d" % (major, minor), "nvrtc_path": nvrtc_path,
              "batch": list(RESNET_SHAPES["data"]), "setup_s": setup_s,
              "compile_s": mod.compile_seconds,
              "rewritten_nodes": len(rewritten),
              "forwards": RTC_FORWARDS, "launches": launches,
              "forward_ms_p50": {k: statistics.median(v[2:])
                                 for k, v in walls.items()},
              "forward_ms": walls, "bitwise": True,
              "max_prob_mean": probs.max(1).values.mean().item(),
              "user_relu_50": row, "host_per_node": op_host,
              "profile": prof}
    return result, row


def parent_opt_update(torch, dev, lib, result):
    """Kernel #7 of the parent checkout (``lib``: its ``opt_update``
    library with the per-leaf entries) against this one's multi-tensor
    launch on one ResNet-50 update of each kind: the parent's path is its
    kernel on the 71 leaves ``_kernel_eligible`` takes and the plain
    expression on the other 86, as its ``fused_update_step`` ran them. Both
    must give the same bits; both are timed in turns (parent, this, this,
    parent) as device time in a CUDA graph and as eager wall."""
    import ctypes
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    P, I, F, N = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
    # the parent's per-leaf entries and their argument types: p, g, the
    # slots, lr, n, the kind's scalars, the prologue's, stream
    entries = {
        "sgd": ("mx_optupdate_sgd_f32", [P] * 3 + [N, F, I, F, F, F, P]),
        "sgd_mom": ("mx_optupdate_sgd_mom_f32",
                    [P] * 4 + [N, F, F, I, F, F, F, P]),
        "adam": ("mx_optupdate_adam_f32",
                 [P] * 5 + [N] + [F] * 6 + [I] + [F] * 3 + [P])}
    _, shapes = resnet50_param_shapes(tres)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    kw = dict(rescale=1 / 32, clip=0.01, wd=1e-4)
    for kind, (name, argtypes) in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        opt = "adam" if kind == "adam" else "sgd"
        hp = _opt_hp(kind)
        lr_t = torch.full((), hp["lr"], device=dev)
        params0 = {n: torch.randn(s, device=dev, generator=gen) * 0.05
                   for n, s in shapes.items()}
        grads = {n: torch.randn(s, device=dev, generator=gen) * 1e-3
                 for n, s in shapes.items()}
        names = sorted(params0)
        trees = []
        for _ in range(2):
            params = {n: v.clone() for n, v in params0.items()}
            state = _opt_state(torch, kind, params)
            trees.append([(params[n], grads[n], tuple(
                state[k][n] for k in ("m", "v", "mom") if state.get(k)))
                for n in names])
        pro = (kw["rescale"], 1, -kw["clip"], kw["clip"], kw["wd"])
        if kind == "adam":
            extra = (hp["beta1"], 1 - hp["beta1"], hp["beta2"],
                     1 - hp["beta2"], hp["eps"])
        else:
            extra = (hp["momentum"],) if kind == "sgd_mom" else ()

        def theirs(table=trees[0]):
            stream = torch.cuda.current_stream().cuda_stream
            for p_, g_, sl in table:
                if not tou._kernel_eligible(p_):
                    tou._plain_leaf(opt, hp, lr_t, p_, g_, sl, **kw)
                    continue
                ptrs = [t.data_ptr() for t in (p_, g_) + sl]
                if fn(*ptrs, lr_t.data_ptr(), p_.numel(), *extra, *pro,
                      stream):
                    fail("parent opt_update %s: the parent's launch "
                         "failed" % kind)

        def ours(table=trees[1]):
            tou._launch(opt, hp, lr_t, table, **kw)

        theirs()
        ours()
        torch.cuda.synchronize()
        for (a, _, sa), (b, _, sb) in zip(*trees):
            for x, y in zip((a,) + sa, (b,) + sb):
                same, diff = _bit_diff(torch, y, x)
                if not same:
                    result["opt_bit_identical"] = False
                    fail("parent: #7 %s differs from the parent's bits "
                         "(max abs diff %g)" % (kind, diff))
        ms = [time_ms(f, iters=5) for f in (theirs, ours, ours, theirs)]
        host = [time_host_ms(f, iters=10)
                for f in (theirs, ours, ours, theirs)]
        result["times"]["opt_update_" + kind] = {
            "parent_ms": (ms[0] + ms[3]) / 2, "ms": (ms[1] + ms[2]) / 2,
            "parent_host_ms": (host[0] + host[3]) / 2,
            "host_ms": (host[1] + host[2]) / 2,
            "leaves": len(names), "parent_launches": sum(
                1 for p_, _, _ in trees[0] if tou._kernel_eligible(p_))}
        del trees, params0, grads
        torch.cuda.empty_cache()


def phase_parent(torch, fa, dev, parent):
    """This checkout's attention kernels and #7 against another's
    (``--parent DIR``: a checkout, e.g. the parent commit unpacked with
    ``git archive``), built from DIR's ``csrc/`` and called through the
    same C entries (#7: the parent's per-leaf entries) on the same card.
    The backward entries (#2, #4) and #7 must give the same bits in both;
    every kernel is timed in turns (DIR's, this, this, DIR's) at its main
    path's shape, and the forward outputs' largest difference is
    reported."""
    import ctypes
    from mxnet_tpu_torch.kernels import _build
    csrc = os.path.join(parent, "mxnet_tpu_torch", "kernels", "csrc")
    paths = _build.build_all([n for n in _build.SOURCES
                              if n.startswith("flash")
                              or n == "opt_update"], csrc=csrc)
    libs = {n: ctypes.CDLL(p) for n, p in paths.items()}
    gen = torch.Generator().manual_seed(SEED + 5)

    def theirs(name):
        lib, argtypes = fa._ENTRIES[name]
        fn = getattr(libs[lib], name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lambda *a: fn(*a, torch.cuda.current_stream().cuda_stream)

    def ours(name):
        return lambda *a: fa._launch(name, *a, device=dev)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    result = {"phase": "parent", "dir": parent, "bwd_bit_identical": True,
              "opt_bit_identical": True, "fwd_max_abs_diff": {},
              "times": {}}

    def both(key, name, args, outs, iters=20):
        """Run entry ``name`` of both trees on ``args`` (outs are among
        them), then time both in turns; -> the two output lists."""
        fns = [make(name) for make in (theirs, ours)]
        got = []
        for fn in fns:
            for o in outs:
                o.zero_()   # a dead split's slot stays 0 in both
            if fn(*args):
                fail("parent %s: the parent's %s launch failed" % (key,
                                                                  name))
            torch.cuda.synchronize()
            got.append([o.clone() for o in outs])
        ms = [time_ms(lambda: fn(*args), iters=iters)
              for fn in (fns[0], fns[1], fns[1], fns[0])]
        result["times"][key] = {"parent_ms": (ms[0] + ms[3]) / 2,
                                "ms": (ms[1] + ms[2]) / 2}
        return got

    # the training pair #5, #2 and the grid pair #6, #4 at their paths'
    # shapes (#4 with 8 splits and with one)
    for B, S, w, pre in ((8, 512, None, ""), (4, LONG_S, LONG_W, "grid_"),
                         (4, LONG_S, LONG_S, "grid_1split_")):
        H, D = 8, 64
        sm = 1.0 / math.sqrt(D)
        q, k, v, do = (rand(B, H, S, D) for _ in range(4))
        offs0 = fa._offs0(dev)
        out, lse = fa.flash_fwd_plain(q, k, v, sm, True)
        deff = fa._deff(do, out, None).contiguous()
        n = 1 if w is None else -(-S // w)
        part = (n,) if n > 1 else ()
        o_, l_ = (torch.empty(part + (B, H, S, D), device=dev),
                  torch.empty(part + (B, H, S), device=dev))
        dq, dk, dv = (torch.empty(part + (B, H, S, D), device=dev)
                      for _ in range(3))
        common = [t.data_ptr() for t in (q, k, v, offs0, do, lse, deff)]
        grid = () if w is None else (w, n)
        bh = (B * H, S, S, D) + grid + (sm, 1)
        iters = 20 if w is None else 5
        if pre != "grid_1split_":
            fwd = ("mx_flash_fwd_f32" if w is None else
                   "mx_flash_fwd_grid_f32")
            a, b_ = both(pre + "fwd", fwd, [q.data_ptr(), k.data_ptr(),
                                            v.data_ptr(), o_.data_ptr(),
                                            l_.data_ptr()] + list(bh),
                         [o_, l_], iters)
            live = b_[1] > NEG / 2
            result["fwd_max_abs_diff"][pre + "fwd"] = max(
                (a[0] - b_[0]).abs().max().item(),
                (a[1] - b_[1])[live].abs().max().item())
        sfx = "" if w is None else "_grid"
        for key, outs in (("dq", [dq]), ("dkv", [dk, dv])):
            a, b_ = both(pre + key, "mx_flash_bwd_%s%s_f32" % (key, sfx),
                         common + [o.data_ptr() for o in outs] + list(bh),
                         outs, iters)
            if not all(torch.equal(x, y) for x, y in zip(a, b_)):
                result["bwd_bit_identical"] = False
                fail("parent: %s%s differs from the parent's bits"
                     % (pre, key))
        del q, k, v, do, out, lse, deff, o_, l_, dq, dk, dv
        torch.cuda.empty_cache()

    # the serving forwards #1 and #3 at their paths' shapes
    for key, C, SK, q0, w in (("offs", 256, 512, 256, None),
                              ("grid_offs", 1024, LONG_S, 2816, LONG_W)):
        H, D = 8, 64
        sm = 1.0 / math.sqrt(D)
        q, k, v = rand(1, H, C, D), rand(1, H, SK, D), rand(1, H, SK, D)
        offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
        n = 1 if w is None else -(-SK // w)
        part = (n,) if n > 1 else ()
        o_, l_ = (torch.empty(part + (1, H, C, D), device=dev),
                  torch.empty(part + (1, H, C), device=dev))
        name = ("mx_flash_fwd_offs_f32" if w is None else
                "mx_flash_fwd_offs_grid_f32")
        grid = () if w is None else (w, n)
        a, b_ = both(key, name, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 offs.data_ptr(), o_.data_ptr(),
                                 l_.data_ptr(), H, C, SK, D] + list(grid)
                     + [sm, 1], [o_, l_])
        live = b_[1] > NEG / 2
        result["fwd_max_abs_diff"][key] = max(
            (a[0] - b_[0]).abs().max().item(),
            (a[1] - b_[1])[live].abs().max().item())
    parent_opt_update(torch, dev, libs["opt_update"], result)
    for v_ in result["times"].values():
        v_["speedup"] = v_["parent_ms"] / v_["ms"]
    return result


PHASES = ("kernel", "serve", "profile", "train_kernel", "train",
          "train_profile", "opt_kernel", "symbolic_train", "symbolic_profile",
          "grid_kernel", "serve_long", "train_long", "rtc_kernel",
          "rtc_infer")
#: phase -> the phases whose results it needs
NEEDS = {"profile": ("serve",), "train_profile": ("train",),
         "symbolic_profile": ("symbolic_train",)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="also write the profiler tables of the "
                             "profile phases into this directory")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the train phases' weights and data")
    parser.add_argument("--parent", default=None, metavar="DIR",
                        help="also hold this checkout's attention kernels "
                             "and #7 against those of the checkout in DIR "
                             "(same bits for the backward and #7, times in "
                             "turns)")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %s (default: all)"
                        % ",".join(PHASES))
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        parser.error("unknown phases %s" % sorted(phases - set(PHASES)))
    for ph in list(phases):
        phases.update(NEEDS.get(ph, ()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    # float32 must stay float32 on the card: the kernels keep float32
    # accuracy (on CUDA cores, or as three TF32 products a product on the
    # tensor cores), and the plain versions, the model's matmuls and cuDNN's
    # convolutions must too, or one TF32 product's ~3 decimal digits would
    # swamp the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "card": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(paths),
          # per library: kernel -> [registers, spill stores, spill loads]
          "ptxas": {k: ptxas_kernels(v["ptxas"])
                    for k, v in _build.build_info.items()}})

    entries = []
    src = "mxnet_tpu_torch/kernels/csrc/"
    ref = "mxnet_tpu/kernels/flash_attention.py:"
    if "kernel" in phases:
        worst, rows = phase_kernel(torch, fa, dev)
        emit({"phase": "kernel", "cases": len(rows), "max_abs_err": worst,
              "tol": TOL, "card": card})
    if "serve" in phases:
        serve, launches, model = phase_serve(torch, fa, dev)
        emit({**serve, "card": card})
        if "profile" in phases:
            emit({**phase_profile(torch, model, dev, args.profile_dir),
                  "card": card})
        del model
        if "kernel" in phases:
            path_row = next(r for r in rows if r["C"] == 256
                            and r["offs"] == [256, 0])
            entries.append({
                "name": "flash_fwd_offs_f32", "route": "cuda",
                "source": src + "flash_fwd_offs.cu", "replaces": ref + "285",
                "launches": launches, "max_abs_err": worst,
                "ms": path_row["ms"], "plain_ms": path_row["plain_ms"],
                "bound_ms": path_row["bound_ms"],
                "bound_by": path_row["bound_by"],
                "library_ms": path_row["sdpa_ms"],
                "bound_cuda_core_ms": path_row["bound_cuda_core_ms"],
                "tflops": path_row["tflops"],
                "shape": "q (1,8,256,64) k/v (1,8,512,64) f32 offs [256,0]"})

    if "train_kernel" in phases:
        tk_worst, tk = phase_train_kernel(torch, fa, dev)
        emit({"phase": "train_kernel", "max_abs_err": tk_worst, "tol": TOL,
              **tk, "card": card})
    if "train" in phases:
        train, train_counts, step, batch = phase_train(torch, fa, dev,
                                                       args.seed)
        emit({**train, "card": card})
        if "train_profile" in phases:
            emit({"phase": "train_profile", "card": card,
                  "step_b8_s512": profile_calls(
                      torch, lambda: step(batch), "train", args.profile_dir,
                      warm=2, n=5, calls=3)})
        del step
        train_shape = "q/k/v (8,8,512,64) f32 causal"
        if "train_kernel" in phases:
            for name, file, line, key, plain, lib in (
                    ("flash_fwd_f32", "flash_fwd.cu", "205", "fwd",
                     "fwd_plain_ms", "sdpa_fwd_ms"),
                    ("flash_bwd_dq_f32", "flash_bwd_offs.cu", "402", "dq",
                     "bwd_plain_ms", "sdpa_bwd_ms"),
                    ("flash_bwd_dkv_f32", "flash_bwd_offs.cu", "453", "dkv",
                     "bwd_plain_ms", "sdpa_bwd_ms")):
                entries.append({
                    "name": name, "route": "cuda", "source": src + file,
                    "replaces": ref + line,
                    "launches": train_counts[
                        {"fwd": "launches_fwd", "dq": "launches_bwd_dq",
                         "dkv": "launches_bwd_dkv"}[key]],
                    "max_abs_err": tk_worst[key], "ms": tk[key + "_ms"],
                    "plain_ms": tk[plain], "bound_ms": tk[key + "_bound_ms"],
                    "bound_by": tk[key + "_bound_by"], "library_ms": tk[lib],
                    "bound_cuda_core_ms": tk[key + "_bound_cuda_core_ms"],
                    "tflops": tk[key + "_tflops"], "shape": train_shape})
    torch.cuda.empty_cache()

    if "opt_kernel" in phases:
        ok_worst, ok_cases, ok_rows = phase_opt_kernel(torch, dev)
        emit({"phase": "opt_kernel", "cases": ok_cases,
              "max_abs_err": ok_worst, "bitwise": True, "resnet50_update":
              ok_rows, "card": card})
    if "symbolic_train" in phases:
        sym_result, sym_counts, sym_step, sym_batch = phase_symbolic_train(
            torch, dev, args.seed)
        emit({**sym_result, "card": card})
        if "symbolic_profile" in phases:
            prof = profile_calls(torch, lambda: sym_step(sym_batch),
                                 "symbolic", args.profile_dir, warm=2, n=5,
                                 calls=3, classify=kind_of)
            conv_ms = prof["by_kind"].get("conv_matmul", [0, 0.0])[1]
            emit({"phase": "symbolic_profile", "card": card,
                  "step_resnet50_b32": prof,
                  "conv_matmul_tflops": sym_result["gflop_per_step"]
                  / conv_ms if conv_ms else None,
                  "step_ms_cudnn_benchmark": cudnn_benchmark_step_ms(
                      torch, lambda: sym_step(sym_batch))})
        if "opt_kernel" in phases:
            for k, (line, name) in OPT_KERNELS.items():
                row = ok_rows[k]["leaves157"]
                entries.append({
                    "name": name, "route": "cuda",
                    "source": src + "opt_update.cu",
                    "replaces": OPT_REF + line,
                    "launches": sym_counts[k][0],
                    "leaves": sym_counts[k][1],
                    "max_abs_err": ok_worst[k], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    "shape": "one ResNet-50 update: %d launch, %d leaves, "
                             "%d f32 elements" % (row["launches"],
                                                  row["leaves"],
                                                  row["elements"])})
    torch.cuda.empty_cache()

    if "grid_kernel" in phases:
        gk_worst, gk = phase_grid_kernel(torch, fa, dev)
        emit({"phase": "grid_kernel", "max_abs_err": gk_worst, "tol": TOL,
              **gk, "card": card})
        torch.cuda.empty_cache()
    path_counts = {}
    if "serve_long" in phases:
        serve_long, counts = phase_serve_long(torch, fa, dev, args.seed,
                                              args.profile_dir)
        emit({**serve_long, "card": card})
        path_counts.update(counts)
        torch.cuda.empty_cache()
    if "train_long" in phases:
        train_long, counts = phase_train_long(torch, fa, dev, args.seed,
                                              args.profile_dir)
        emit({**train_long, "card": card})
        path_counts.update(counts)
        torch.cuda.empty_cache()
    if "grid_kernel" in phases:
        for key, (entry, counter, file, line) in GRID_KERNELS.items():
            if counter not in path_counts:
                continue   # its path's phase did not run
            lib = {"fwd": "sdpa_fwd_ms", "dq": "sdpa_bwd_ms",
                   "dkv": "sdpa_bwd_ms", "offs": "sdpa_offs_ms"}.get(key)
            plain = {"dkv": "bwd_plain_ms", "dq": "bwd_plain_ms"}.get(
                key, key + "_plain_ms")
            entries.append({
                "name": entry[3:], "route": "cuda", "source": src + file,
                "replaces": ref + line, "launches": path_counts[counter],
                "max_abs_err": gk_worst[key], "ms": gk[key + "_ms"],
                "plain_ms": gk[plain], "bound_ms": gk[key + "_bound_ms"],
                "bound_by": gk[key + "_bound_by"],
                "library_ms": gk[lib] if lib else None,
                "bound_cuda_core_ms": gk[key + "_bound_cuda_core_ms"],
                "tflops": gk[key + "_tflops"],
                "shape": ("q (1,8,1024,64) k/v (1,8,4096,64) f32 offs "
                          "[2816,0], 8 key splits" if key.startswith("offs")
                          else "q/k/v (4,8,4096,64) f32 causal, 8 splits")})
    if "rtc_kernel" in phases:
        rtc_result, rtc_rows = phase_rtc_kernel(torch, dev)
        emit({**rtc_result, "card": card})
        torch.cuda.empty_cache()
        for entry, key, route, line in (
                ("rtc_axpy_f32", "axpy", "cuda", "57"),
                ("triton_double_f32", "triton_double", "triton", "57")):
            row = rtc_rows[key]
            entries.append({
                "name": entry, "route": route, "source": "chip_smoke.py",
                "replaces": RTC_REF + line, "launches": row["launches"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "shape": "%d f32 elements (ResNet-50's parameters), %s"
                         % (rtc_result["n"], "RTC_AXPY_SOURCE via NVRTC"
                            if route == "cuda" else "triton_double_kernel")})
    if "rtc_infer" in phases:
        infer, row = phase_rtc_infer(torch, dev, args.seed, args.profile_dir)
        emit({**infer, "card": card})
        torch.cuda.empty_cache()
        entries.append({
            "name": "rtc_user_relu_f32", "route": "cuda",
            "source": "chip_smoke.py", "replaces": RTC_REF + "96",
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": "the 50 relu inputs of one ResNet-50 forward at batch "
                     "32 (%d f32 elements), USER_RELU_SOURCE via NVRTC"
                     % row["elements"]})
    if args.parent:
        emit({**phase_parent(torch, fa, dev, args.parent), "card": card})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
