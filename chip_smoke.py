#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-dir DIR] [--seed N]

Phases, each printing one JSON line (any failure exits nonzero and prints
no result line):

1. device  — CUDA must be available; prints the card's name and power
             limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build   — compiles every kernel source under
             ``mxnet_tpu_torch/kernels/csrc/`` with nvcc (all in parallel).
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
             the card's bound for the same work.
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
             32 and 128; and flash_attention_with_lse's gradients through
             its autograd Function at the kernel phase's serving shapes
             with a nonzero lse cotangent, including the ring step whose
             rows all see no key (dq, dk and dv exactly 0 there). Max abs
             error <= 1e-4 on out, lse, dq, dk and dv, scaled by the
             reference's max abs where that exceeds 1 (float32 in another
             order of summation). Device times from CUDA graphs as in
             phase 3: each kernel, its plain version, and as a yardstick
             only F.scaled_dot_product_attention(is_causal=True) forward
             and forward plus backward; each kernel's bound.
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
             kernel #7) against its plain version, fused_update_step_plain,
             for SGD, SGD-momentum and Adam over clip {None, 0.01} x wd
             {0, 1e-4} x rescale {1, 1/32}, two successive steps, at leaf
             sizes 1024, 128 * 513 and ResNet-50's largest (fc1 2,048,000;
             a 3x3x512x512 conv 2,359,296), with NaN and +-inf in every
             grad: bitwise equal (NaN in the same places, every other value
             the same bits). Device time of the 71 launches of one
             ResNet-50 update (CUDA graphs, median of 7) against the plain
             version, the card's bound (bytes: each operand read once,
             written once) and, as a yardstick only,
             torch.optim.SGD(foreach=True) / torch.optim.Adam(fused=True)
             over the same leaves.
10. symbolic_train — the symbolic stack at full width, as the JAX
             package's bench times it (bench.py:555-594): ResNet-50 at
             3x224x224, batch 32, float32, through mx.sym and
             DataParallelTrainStep(lr 0.05, momentum 0.9,
             fused_optupdate=True), 4 seeded batches (uniform(-1, 1)
             images, random labels) staged on the card and cycled for 20
             steps; then 3 Adam steps and 2 plain-SGD steps from the trained
             weights, so all three kernels run on the path. Checks: every
             loss finite, the mean cross-entropy of the last 4 steps below
             that of the first 4, exactly 71 kernel launches per step (the
             eligible leaves) and 1 program signature; and one step from
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

``--phases`` runs a subset (comma-separated phase names; device and build
always run); the default runs all of them.

The line before last is ``{"kernels": [...]}`` with each kernel's launches
on its path's run (serving, training or symbolic training), its error and
times; the last line is ``{"ok": true, "device": {"platform": "gpu",
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
# the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
NEG = -1e30
SYM_BATCH = 32
SYM_STEPS = 20
RESNET_SHAPES = {"data": (SYM_BATCH, 3, 224, 224),
                 "softmax_label": (SYM_BATCH,)}
OPT_REF = "mxnet_tpu/kernels/opt_update.py:"
#: update kind -> (line of the TPU kernel in OPT_REF, the C entry's name)
OPT_KERNELS = {"sgd": ("96", "optupdate_sgd_f32"),
               "sgd_mom": ("103", "optupdate_sgd_mom_f32"),
               "adam": ("113", "optupdate_adam_f32")}


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
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        row = {"C": C, "offs": [q0, k0], "max_abs_err": err,
               "masked_rows": n_dead, "ms": ms, "host_ms": host_ms,
               "plain_ms": plain_ms,
               "sdpa_ms": sdpa_ms, "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
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


def bound_ms(flops, nbytes):
    """The card's least time for the work: the larger of operations over
    the float32 peak and bytes over the memory rate; and which it is."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
                                 ((1, 4, 150, 128), True)):
        what = "%s causal=%s" % ((b, h, s, d), causal)
        sm = 1.0 / math.sqrt(d)
        q, k, v, do = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d), \
            rand(b, h, s, d)
        out, lse = fa._flash_fwd_cuda(q, k, v, sm, causal)
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, sm, causal)
        check("fwd", what + " out", out, ref_out)
        check("fwd", what + " lse", lse, ref_lse)
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

    # device times at the training shape
    B, H, S, D = 8, 8, 512, 64
    sm = 1.0 / math.sqrt(D)
    q, k, v, do = rand(B, H, S, D), rand(B, H, S, D), rand(B, H, S, D), \
        rand(B, H, S, D)
    offs0 = fa._offs0(dev)
    out, lse = fa._flash_fwd_cuda(q, k, v, sm, True)
    deff = fa._deff(do, out, None).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), offs0.data_ptr(),
              do.data_ptr(), lse.data_ptr(), deff.data_ptr())
    tail = (B * H, S, S, D, sm, 1)
    qg, kg, vg = leaves(q, k, v)
    sdpa = lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=True, scale=sm)
    t = {
        "fwd_ms": time_ms(lambda: fa._flash_fwd_cuda(q, k, v, sm, True)),
        "fwd_plain_ms": time_ms(lambda: fa.flash_fwd_plain(q, k, v, sm,
                                                           True)),
        "dq_ms": time_ms(lambda: fa._launch(
            "mx_flash_bwd_dq_f32", *common, dq.data_ptr(), *tail,
            device=dev)),
        "dkv_ms": time_ms(lambda: fa._launch(
            "mx_flash_bwd_dkv_f32", *common, dk.data_ptr(), dv.data_ptr(),
            *tail, device=dev)),
        "bwd_plain_ms": time_ms(lambda: fa.flash_bwd_offs_plain(
            q, k, v, offs0, do, None, out, lse, sm, True)),
        "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
            fa._FlashAttention.apply(qg, kg, vg, sm, True), (qg, kg, vg),
            do)),
        "sdpa_fwd_ms": time_ms(lambda: sdpa(q, k, v)),
        "sdpa_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg), (qg, kg, vg), do)),
    }
    t["sdpa_bwd_ms"] = t["sdpa_fwd_bwd_ms"] - t["sdpa_fwd_ms"]
    vis = B * H * S * (S + 1) // 2
    n, rows = q.numel(), B * H * S
    for name, flops, nbytes in (
            ("fwd", 4.0 * vis * D, 4.0 * (4 * n + rows)),
            ("dq", 6.0 * vis * D, 4.0 * (5 * n + 2 * rows) + 8),
            ("dkv", 8.0 * vis * D, 4.0 * (6 * n + 2 * rows) + 8)):
        t[name + "_bound_ms"], t[name + "_bound_by"] = bound_ms(flops,
                                                               nbytes)
        t[name + "_flops"], t[name + "_bytes"] = flops, nbytes
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
    """(same bits, max abs diff over finite values): NaN must sit in the
    same places, every other value must have the same bits."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False, math.inf
    same = torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    fin = torch.isfinite(want) & torch.isfinite(got)
    diff = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    return same, diff


def resnet50_eligible_shapes(tres, tou, torch):
    """Shapes of ResNet-50's kernel-#7 leaves (the port's infer_shape)."""
    sym = tres.get_symbol(num_classes=1000, num_layers=50,
                          image_shape="3,224,224")
    arg_shapes, _, _ = sym.infer_shape(**RESNET_SHAPES)
    eligible = {n: s for n, s in zip(sym.list_arguments(), arg_shapes)
                if n not in RESNET_SHAPES and tou._kernel_eligible(
                    torch.empty(s, device="meta"))}
    return sym, eligible


def graph_macs(torch, sym, shapes):
    """Multiply-adds of one forward pass of ``sym`` at ``shapes`` (its
    convolutions and fully connected layers), counted by walking the
    graph on ``meta`` tensors."""
    from mxnet_tpu_torch.executor import GraphPlan
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    known = dict(zip(sym.list_arguments(), arg_shapes))
    known.update(zip(sym.list_auxiliary_states(), aux_shapes))
    plan = GraphPlan(sym)
    vals = {(nid, 0): torch.empty(known[name], device="meta")
            for nid, name, _ in plan.variables}
    macs = 0
    for node, params, in_keys, n_vis, _ in plan.nodes:
        ins = [vals[k] for k in in_keys]
        outs = node.op.apply(params, ins, is_train=True)
        for i in range(n_vis):
            vals[(id(node), i)] = outs[i]
        if node.op.name in ("Convolution", "FullyConnected"):
            macs += outs[0].numel() * math.prod(ins[1].shape[1:])
    return macs


def phase_opt_kernel(torch, dev):
    """Kernel #7 against its plain version, bitwise, and its device time
    over one ResNet-50 update (module docstring, phase 9). Returns (per
    update kind: worst abs diff, timing rows)."""
    import itertools
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {k: 0.0 for k in OPT_KERNELS}
    launches = {k: 0 for k in OPT_KERNELS}
    n_cases = 0
    for kind, clip, wd, rescale in itertools.product(
            OPT_KERNELS, (None, 0.01), (0.0, 1e-4), (1.0, 1 / 32)):
        for n in (1024, 128 * 513, 2048000, 2359296):
            p = torch.randn(n, device=dev, generator=gen)
            grads = []
            for step in range(2):
                g = torch.randn(n, device=dev, generator=gen) * 2
                g[step:step + 3] = torch.tensor(
                    [math.nan, math.inf, -math.inf], device=dev)
                grads.append(g)
            runs = []
            for fn in (tou.fused_update_step, tou.fused_update_step_plain):
                params = {"w": p.clone()}
                state = _opt_state(torch, kind, params)
                for g in grads:
                    fn("adam" if kind == "adam" else "sgd", _opt_hp(kind),
                       params, state, {"w": g}, rescale=rescale, clip=clip,
                       wd=wd)
                runs.append([params["w"]] + [state[s]["w"] for s in
                                             ("m", "v", "mom")
                                             if state.get(s)])
            launches[kind] += 2
            for got, want in zip(*runs):
                same, diff = _bit_diff(torch, got, want)
                if not same:
                    fail("opt_kernel %s clip=%s wd=%s rescale=%s n=%d: the "
                         "kernel differs from its plain version (max abs "
                         "diff %g)" % (kind, clip, wd, rescale, n, diff))
                worst[kind] = max(worst[kind], diff)
            n_cases += 1
    counted = _opt_counts(tou)
    if any(counted[k] < launches[k] for k in OPT_KERNELS):
        fail("opt_kernel: launch counters %s below the %s launched"
             % (counted, launches))
    torch.cuda.synchronize()

    # device time of one ResNet-50 update: its 71 kernel leaves
    _, eligible = resnet50_eligible_shapes(tres, tou, torch)
    rows = {}
    for kind in OPT_KERNELS:
        params = {n: torch.randn(s, device=dev, generator=gen) * 0.05
                  for n, s in eligible.items()}
        grads = {n: torch.randn(s, device=dev, generator=gen) * 1e-3
                 for n, s in eligible.items()}
        state = _opt_state(torch, kind, params)
        hp = _opt_hp(kind)
        lr_t = torch.full((), hp["lr"], device=dev)
        names = sorted(params)
        slots = [tuple(state[s][n] for s in ("m", "v", "mom")
                       if state.get(s)) for n in names]
        opt = "adam" if kind == "adam" else "sgd"
        leaves = [(params[n], grads[n], sl) for n, sl in zip(names, slots)]

        def kernel():
            for p_, g_, sl in leaves:
                tou._launch_leaf(opt, hp, lr_t, p_, g_, sl, 1 / 32, None,
                                 1e-4)

        def plain():
            for p_, g_, sl in leaves:
                tou._plain_leaf(opt, hp, lr_t, p_, g_, sl, 1 / 32, None,
                                1e-4)

        lib_params = [params[n].clone().requires_grad_(True) for n in names]
        for lp, n in zip(lib_params, names):
            lp.grad = grads[n].clone()
        if kind == "adam":
            lib = torch.optim.Adam(lib_params, lr=hp["lr"], fused=True,
                                   capturable=True)
        else:
            lib = torch.optim.SGD(lib_params, lr=hp["lr"],
                                  momentum=hp["momentum"], foreach=True)
        before = sum(_opt_counts(tou).values())
        sizes = sorted(p_.numel() for p_, _, _ in leaves)
        row = {"leaves": len(leaves), "elements": sum(sizes),
               "leaf_elements_median": sizes[len(sizes) // 2],
               "leaves_le_256k": sum(1 for n_ in sizes if n_ <= 1 << 18),
               "ms": time_ms(kernel, iters=5),
               "host_ms": time_host_ms(kernel, iters=10),
               "plain_ms": time_ms(plain, iters=5)}
        # the yardstick, called eagerly as a user would (a few multi-tensor
        # launches per step; compare with host_ms, the kernel's eager time)
        row["library_ms"] = time_host_ms(lib.step, iters=10)
        if sum(_opt_counts(tou).values()) == before:
            fail("opt_kernel: the timed kernel never launched")
        nbytes = tou.optupdate_ideal_bytes(opt, params, state) + 4
        flops = {"sgd": 5, "sgd_mom": 7, "adam": 15}[kind] * row["elements"]
        row["bytes"], row["flops"] = nbytes, flops
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        rows[kind] = row
    return worst, n_cases, rows


def _reset_opt_counts(tou):
    tou.launches_sgd = tou.launches_sgd_mom = tou.launches_adam = 0


def _opt_counts(tou):
    return {"sgd": tou.launches_sgd, "sgd_mom": tou.launches_sgd_mom,
            "adam": tou.launches_adam}


def _cross_entropy(torch, prob, label):
    picked = prob.gather(1, label.long()[:, None]).clamp_min(1e-30)
    return -picked.log().mean()


def phase_symbolic_train(torch, dev, seed):
    """Full-width ResNet-50 through the symbolic stack (module docstring,
    phase 10). Returns (result, per-kernel launches on the path, the SGD
    step, a batch)."""
    import numpy as np
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.parallel import DataParallelTrainStep
    t0 = time.perf_counter()
    sym, eligible = resnet50_eligible_shapes(tres, tou, torch)
    n_el = len(eligible)
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
    counts = {"sgd_mom": _opt_counts(tou)}
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        fail("symbolic_train: non-finite loss in %s" % losses)
    if not statistics.mean(losses[-4:]) < statistics.mean(losses[:4]):
        fail("symbolic_train: loss did not fall: %s" % losses)
    if counts["sgd_mom"] != {"sgd": 0, "sgd_mom": n_el * SYM_STEPS,
                             "adam": 0}:
        fail("symbolic_train: kernel #7 launches %s, want %d sgd_mom (%d "
             "per step)" % (counts["sgd_mom"], n_el * SYM_STEPS, n_el))
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
        counts[kind] = _opt_counts(tou)
        want = {k: (n_el * steps if k == kind else 0) for k in OPT_KERNELS}
        if counts[kind] != want:
            fail("symbolic_train %s: kernel #7 launches %s, want %s"
                 % (kind, counts[kind], want))
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
              "losses": losses, "eligible_leaves": n_el,
              "params": len(step.param_names),
              "launches_per_step": counts["sgd_mom"]["sgd_mom"] / SYM_STEPS,
              "program_count": step.program_count(),
              "peak_mem_gb": peak / 1e9, "adam": extra["adam"],
              "sgd": extra["sgd"],
              "tiers_bitwise": bitwise, "tiers_max_err": tier_err}
    return result, {k: counts[k][k] for k in OPT_KERNELS}, step, batches[0]


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
    if "sgd_mom_kernel" in n or "adam_kernel" in n or "sgd_kernel" in n:
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


PHASES = ("kernel", "serve", "profile", "train_kernel", "train",
          "train_profile", "opt_kernel", "symbolic_train", "symbolic_profile")
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
    # float32 must stay float32 on the card: the kernels run full f32 on
    # CUDA cores, and the plain versions, the model's matmuls and cuDNN's
    # convolutions must too, or TF32's ~3 decimal digits would swamp the
    # comparisons
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
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]
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
                    "shape": train_shape})
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
                row = ok_rows[k]
                entries.append({
                    "name": name, "route": "cuda",
                    "source": src + "opt_update.cu",
                    "replaces": OPT_REF + line, "launches": sym_counts[k],
                    "max_abs_err": ok_worst[k], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    "shape": "one ResNet-50 update: %d leaves, %d f32 "
                             "elements" % (row["leaves"], row["elements"])})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
