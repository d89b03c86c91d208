#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-dir DIR]

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

The line before last is ``{"kernels": [...]}`` with each kernel's launches
on the serving run, its error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
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
    from torch.profiler import ProfilerActivity, profile
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
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    result = {"phase": "profile"}
    for name, fn in programs.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        calls = 5
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
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        result[name] = {
            "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "device_ops_per_call": sum(v[0] for v in kernels.values())
            / calls,
            "top": [[k, v[1] / calls / 1e3] for k, v in top]}
        if out_dir:
            with open(os.path.join(out_dir, "profile_%s.txt" % name),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=40))
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="also write the profiler tables of the "
                             "profile phase into this directory")
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
          "ptxas": {k: [ln for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_info.items()}})

    worst, rows = phase_kernel(torch, fa, dev)
    emit({"phase": "kernel", "cases": len(rows), "max_abs_err": worst,
          "tol": TOL, "card": card})

    serve, launches, model = phase_serve(torch, fa, dev)
    emit({**serve, "card": card})
    emit({**phase_profile(torch, model, dev, args.profile_dir),
          "card": card})

    path_row = next(r for r in rows if r["C"] == 256
                    and r["offs"] == [256, 0])
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
        "shape": "q (1,8,256,64) k/v (1,8,512,64) f32 offs [256,0]"}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
