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

The line before last is ``{"kernels": [...]}`` with each kernel's launches
on its path's run (serving or training), its error and times; the last
line is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``.
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


def profile_calls(torch, fn, name, out_dir, warm=3, n=20, calls=5):
    """Host wall per call of ``fn`` (``n`` synchronized calls after
    ``warm``) against the device time torch.profiler traced over
    ``calls`` more, hence the idle share; the top device ops. With
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
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "device_ops_per_call": sum(v[0] for v in kernels.values())
            / calls,
            "top": [[k, v[1] / calls / 1e3] for k, v in top]}


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="also write the profiler tables of the "
                             "profile phases into this directory")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the train phase's weights and data")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    # float32 must stay float32 on the card: the kernel runs full f32 on
    # CUDA cores, and the plain version and the model's matmuls must too,
    # or TF32's ~3 decimal digits would swamp the 1e-4 comparisons
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

    worst, rows = phase_kernel(torch, fa, dev)
    emit({"phase": "kernel", "cases": len(rows), "max_abs_err": worst,
          "tol": TOL, "card": card})

    serve, launches, model = phase_serve(torch, fa, dev)
    emit({**serve, "card": card})
    emit({**phase_profile(torch, model, dev, args.profile_dir),
          "card": card})

    tk_worst, tk = phase_train_kernel(torch, fa, dev)
    emit({"phase": "train_kernel", "max_abs_err": tk_worst, "tol": TOL,
          **tk, "card": card})
    train, train_counts, step, batch = phase_train(torch, fa, dev, args.seed)
    emit({**train, "card": card})
    emit({"phase": "train_profile", "card": card,
          "step_b8_s512": profile_calls(torch, lambda: step(batch), "train",
                                        args.profile_dir, warm=2, n=5,
                                        calls=3)})

    path_row = next(r for r in rows if r["C"] == 256
                    and r["offs"] == [256, 0])
    train_shape = "q/k/v (8,8,512,64) f32 causal"
    src = "mxnet_tpu_torch/kernels/csrc/"
    ref = "mxnet_tpu/kernels/flash_attention.py:"
    emit({"kernels": [{
        "name": "flash_fwd_offs_f32",
        "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_fwd_offs.cu",
        "replaces": "mxnet_tpu/kernels/flash_attention.py:285",
        "launches": launches,
        "max_abs_err": worst,
        "ms": path_row["ms"],
        "plain_ms": path_row["plain_ms"],
        "bound_ms": path_row["bound_ms"],
        "bound_by": path_row["bound_by"],
        "library_ms": path_row["sdpa_ms"],
        "shape": "q (1,8,256,64) k/v (1,8,512,64) f32 offs [256,0]"}, {
        "name": "flash_fwd_f32", "route": "cuda",
        "source": src + "flash_fwd.cu", "replaces": ref + "205",
        "launches": train_counts["launches_fwd"],
        "max_abs_err": tk_worst["fwd"], "ms": tk["fwd_ms"],
        "plain_ms": tk["fwd_plain_ms"], "bound_ms": tk["fwd_bound_ms"],
        "bound_by": tk["fwd_bound_by"], "library_ms": tk["sdpa_fwd_ms"],
        "shape": train_shape}, {
        "name": "flash_bwd_dq_f32", "route": "cuda",
        "source": src + "flash_bwd_offs.cu", "replaces": ref + "402",
        "launches": train_counts["launches_bwd_dq"],
        "max_abs_err": tk_worst["dq"], "ms": tk["dq_ms"],
        "plain_ms": tk["bwd_plain_ms"], "bound_ms": tk["dq_bound_ms"],
        "bound_by": tk["dq_bound_by"], "library_ms": tk["sdpa_bwd_ms"],
        "shape": train_shape}, {
        "name": "flash_bwd_dkv_f32", "route": "cuda",
        "source": src + "flash_bwd_offs.cu", "replaces": ref + "453",
        "launches": train_counts["launches_bwd_dkv"],
        "max_abs_err": tk_worst["dkv"], "ms": tk["dkv_ms"],
        "plain_ms": tk["bwd_plain_ms"], "bound_ms": tk["dkv_bound_ms"],
        "bound_by": tk["dkv_bound_by"], "library_ms": tk["sdpa_bwd_ms"],
        "shape": train_shape}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
