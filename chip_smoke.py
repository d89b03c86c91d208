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

17. module_fit — full-width ResNet-50 (3x224x224, batch 32, float32) as
             a user trains it (bench.py:1433-1441): mx.mod.Module(sym,
             context=cuda:0).fit(kvstore='tpu_sync', SGD lr 0.05, momentum
             0.9, wd 1e-4, Xavier(gaussian, magnitude 2) after
             mx.random.seed) under MXNET_TPU_FUSED_OPTUPDATE=1, over an
             NDArrayIter of the 4 seeded batches six times over (one epoch,
             24 steps, host batches) with a CrossEntropy metric read and
             reset every 6 batches. Checks: the fused step built, exactly 1
             launch of #7 with 157 leaves a step, 1 program signature, the
             cross-entropy finite and lower in the last quarter than in the
             first. Reports img/s over the second half and the step wall p50
             (batch-end stamps), and one Module iteration (forward_backward,
             update, update_metric on a host batch) against the bare step on
             a staged batch under torch.profiler (device time, idle share,
             by kind; DIR/profile_module_fit.txt), and the host time of
             NDArrayIter.next() and of each step's enqueue on an idle
             card. Then, under
             cudnn.deterministic, one step through a Module against one of a
             bare DataParallelTrainStep from the fitted params and the same
             batch: params and momentum bit for bit equal, or within 1e-6 of
             each leaf's own max abs (reported); 2 steps with
             kvstore='local' (the per-parameter updater, no kernel) from
             the same params, within 1e-6 of each leaf's own max abs of the
             tpu_sync steps (reported); and Module.score on a 2-batch
             validation iterator (finite).
18. example_scripts — the reference's scripts, unchanged, on the card
             through the launcher (mxnet_tpu_torch.run_script) in a
             subprocess each: train_mnist.py --gpus 0 --network lenet
             --num-epochs 3 (MNIST_SYNTH_N 6000) with --kv-store local and
             with tpu_sync under MXNET_TPU_FUSED_OPTUPDATE=1, and
             train_imagenet.py --benchmark 1 --gpus 0 --kv-store tpu_sync
             --num-examples 768 --num-epochs 1 under it. Checks: exit 0, the
             child's "jax not in sys.modules" line, TF32 off in the child
             (Module pins float32), each epoch's
             Train-accuracy and a Speedometer rate printed, the fused step
             active exactly with tpu_sync and then #7 launched with every
             leaf (8 for LeNet, 157 for ResNet-50) and otherwise not at all;
             LeNet's last epoch above the first Speedometer window's
             accuracy and at or above the JAX package's value on the CPU
             (JAX_CPU_LENET_ACC) less 0.02.
19. serve_bf16 — the serve phase's transformer with dtype bfloat16
             (bf16 weights from the same seeded generator, bf16 KV pages)
             through the same DecodeEngine and prompts. Checks: all served,
             #1's bf16 entry (flash_fwd_offs.cu, flash_fwd_bf16.cuh)
             launched at least 12 times per prefill call and the float32
             one not at all, no KV block left live, every stream equal to
             its solo decode. Reports tokens/s, TTFT and inter-token p50.
20. train_bf16 — the train phase's model in bf16 through
             ShardedTrainStep(adam, lr 1e-3, grad_clip 1.0), 20 steps of 8
             x 512 tokens. Checks: every loss finite, the mean of the last 3
             below the first, #5's and #2's bf16 entries launched 12 times
             per step each and no float32 attention kernel; from the
             first batch, the first loss within BF16_LOSS_RTOL and every
             leaf's first gradient within BF16_GRAD_RTOL (relative L2) of
             the float32 model's from the same weights, where two controls
             (the model under a plain attention that drops each query
             tile's own key tile, or skips the rescale of its running sum)
             must fail the gradients' gate. The first Adam step leaves
             float32 params (jnp's promotion, as the JAX step), which the
             forward casts to bf16: float32 masters from step 2 on. Reports the step wall p50,
             tokens/s, and one step under torch.profiler (device time, idle
             share; DIR/profile_train_bf16.txt).
21. symbolic_bf16 — module_fit's ResNet-50 run with optimizer_params
             multi_precision=True: the fused step computes in bf16 with
             float32 masters. Checks: the step's compute dtype bf16,
             exactly 1 launch of #7 with 157 float32 leaves a step, every
             master and BatchNorm running statistic float32, the
             cross-entropy lower in the last quarter than in the first; from
             the fitted params and one batch, a bf16 and a float32
             DataParallelTrainStep: the bf16 step's outputs bf16, its
             cross-entropy within BF16_CE_RTOL and its update of the
             classifier within BF16_UPDATE_RTOL (relative L2) of the float32
             step's, where two controls (the bf16 step on labels rounded to
             bf16, and on masters rounded to float8 e4m3) must fail them
             in turn. Reports img/s over the second half and both bare
             steps under torch.profiler (device time by kind, idle share;
             DIR/profile_symbolic_bf16.txt).
22. bf16_kernel — #1, #5 and #2 on bf16 inputs against their plain bf16
             versions (the JAX kernels' roundings): #1 at q (1, 8, C, D)
             against k/v (1, 8, 512, D), C in {64, 256}, D in {32, 64,
             128}, offsets including rows that see no key, with #2 through
             flash_attention_with_lse and an lse cotangent; #5 and #2 at
             (8, 8, 512, D) causal for D in {32, 64, 128}, (2, 8, 200, 64)
             non-causal and bench.py's flash shape (4, 8, 4096, 128)
             causal. Outputs and gradients within BF16_ULPS bf16 ulps of
             each row's largest magnitude in the plain version
             (mxnet_tpu_torch/kernels/bf16_gate.py), lse within 1e-4, rows
             with no visible key exactly (0, -1e30) with zero gradients,
             two calls bit-identical. Device times from CUDA graphs at the
             serving shape (C 256 at offs [256, 0]), the training shape and
             bench.py's: each kernel, the plain version, and as a
             yardstick only F.scaled_dot_product_attention in bf16; the
             bf16 bound (operations at 989 TFLOP/s, bytes at 3.35 TB/s).
             Then the grid kernels in bf16, held the same way: #6 and #4
             through flash_attention(variant="grid") at (4, 8, 4096, 64)
             and bench.py's (4, 8, 4096, 128) causal with 512-key blocks
             (8 splits), (1, 4, 300, 32) with ragged 64-row splits and
             (2, 8, 1000, 64) non-causal; #3 and #4 with an lse cotangent
             through flash_attention_with_lse(variant="grid") at q (1, 8,
             1024, 64) on 4096 keys at offset 2816, at a chunk whose rows
             see no key (every split dead) and with one split per 32-key
             tile; #4 against the plain backward fed the kernels' own out
             and lse; the combine and reduce passes alone on the plain
             version's float32 partials. Device times of each pass at the
             long shapes (the bounds count bf16 inputs and outputs and
             float32 workspaces), the plain versions, bf16 SDPA; at
             bench.py's shape each family whole against SDPA. Then
             ``hgmma``: ``cuobjdump -sass`` of every built flash_*
             library; each bf16 body (flash_fwd_bf16_kernel,
             flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel) must
             issue Hopper's warpgroup products (HGMMA) and every other
             kernel, the float32 bodies and the passes, none. Each bf16
             entry on the kernels line carries its bound share, TFLOP/s,
             its time over SDPA's (``vs_library``) and its body's
             registers and spill bytes.
23. serve_long_bf16 — serve_long's configuration with dtype bfloat16
             (bf16 weights from the same seeded generator, bf16 KV pages)
             through the same DecodeEngine and prompts. Checks: all served,
             #3's bf16 entries (flash_fwd_offs_grid.cu,
             flash_fwd_bf16.cuh; and the bf16 combine) launched 12 times
             per prefill call and no other attention kernel, no KV block
             left live, every stream equal to its solo decode. Reports
             tokens/s, TTFT and inter-token p50.
24. train_long_bf16 — train_long's model in bf16 through
             ShardedTrainStep(adam, lr 1e-3, grad_clip 1.0), 10 steps of 4
             x 4096 tokens. Checks: every loss finite, the mean of the last
             3 below the first, #6's and #4's bf16 entries and their
             combine and reduce passes launched 12 times per step and no
             other attention kernel, float32 masters after the steps; and,
             at 2 layers from the first batch, the bf16 model's first loss
             within BF16_LONG_LOSS_RTOL and every leaf's first gradient
             within BF16_LONG_GRAD_RTOL (relative L2) of the float32
             model's from the same weights, where the two controls of
             train_bf16 must fail the gradients' gate. Reports the step
             wall p50, tokens/s and one step under torch.profiler (device
             time by kind, idle share; DIR/profile_train_long_bf16.txt).

``--phases`` runs a subset (comma-separated phase names; device and build
always run); the default runs all of them. ``--parent DIR`` adds a last
phase, ``parent``: the attention kernels and #7 of the checkout in DIR
(e.g. the parent commit unpacked with ``git archive``) built beside this
one's and called through the same C entries on the same inputs (#7: DIR's
per-leaf entries on the 71 leaves its rule takes and the plain expression
on the rest, against this checkout's one launch, on one ResNet-50 update
of each kind): the float32 forwards' (#5, #6, #1, #3), #2's, #4's and
#7's outputs must be the same bits in both; the bf16 entries (#5, #1 and
#2 at their stream shapes, #6, #4 and #3 at the long shapes, the grid
workspaces through this checkout's combine and reduce passes on both
sides), whose bodies sum in another order than DIR's, are each held to
BF16_ULPS row ulps of the plain version, with the row-ulp distance to
DIR's output recorded (``bf16``); every kernel is timed in turns (DIR's,
this, this, DIR's) at its path's shape.

The line before last is ``{"kernels": [...]}`` with each kernel's launches
on its path's run (serving, training, symbolic training, long-context
serving or training, the rtc kernels' full-size run or the ResNet-50
forwards, the bf16 serving and training runs, long ones included; #7's
adds its launches in
module_fit, example_scripts and symbolic_bf16, by path in
``launches_by_path``), its error (the bf16 entries in bf16 ulps) and
times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

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
ROOT = os.path.dirname(os.path.abspath(__file__))
#: update kind -> (line of the TPU kernel in OPT_REF, the C entry's name)
OPT_KERNELS = {"sgd": ("96", "optupdate_multi_sgd_f32"),
               "sgd_mom": ("103", "optupdate_multi_sgd_mom_f32"),
               "adam": ("113", "optupdate_multi_adam_f32")}
OPT_BY_ENTRY = {name: kind for kind, (_, name) in OPT_KERNELS.items()}


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


def kernel_name(mangled):
    """``base<template ints>`` of a kernel's mangled name (the last name
    of its nested names, and its integer and bool template arguments)."""
    import re
    base, i = None, 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():   # <len><id>s
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        base, i = mangled[j:j + n], j + n
    args = re.findall(r"L[ib](\d+)E", mangled)
    return "%s<%s>" % (base or mangled, ",".join(args))


def ptxas_kernels(log):
    """{kernel: [registers, spill store bytes, spill load bytes]} from
    nvcc's ``-Xptxas -v`` report; kernels named by ``kernel_name``."""
    import re
    found, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            found[name] = [None, None, None]
        elif name and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            found[name][1:] = [int(x) for x in nums]
        elif name and "Used" in ln and "registers" in ln:
            found[name][0] = int(re.search(r"Used (\d+) registers",
                                           ln).group(1))
    return found


#: the bf16 attention bodies, which must issue Hopper's warpgroup
#: products (HGMMA in SASS); every other attention kernel issues none
BF16_BODIES = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
               "flash_bwd_dkv_bf16_kernel")


def hgmma_counts(paths):
    """{library: {kernel: HGMMA instructions}} from ``cuobjdump -sass``
    of each built ``flash_*`` library (``paths``: name -> file); fails
    unless every bf16 body has some and every other kernel none."""
    import re
    from mxnet_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    counts = {}
    for lib, path in sorted(paths.items()):
        if not lib.startswith("flash"):
            continue
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        found, name = {}, None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\w+)", ln)
            if m:
                name = kernel_name(m.group(1))
                found[name] = 0
            elif name and "HGMMA" in ln:
                found[name] += 1
        for name, n in found.items():
            body = name.split("<")[0] in BF16_BODIES
            if body and n == 0:
                fail("hgmma: %s of %s issues no warpgroup product"
                     % (name, lib))
            if not body and n:
                fail("hgmma: %s of %s issues %d warpgroup products"
                     % (name, lib, n))
        if not any(n for n in found.values()):
            fail("hgmma: %s holds no bf16 body" % lib)
        counts[lib] = found
    return counts


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


def leaf_err(got, ref):
    """Max abs error of ``got`` against ``ref``, divided by ``ref``'s own
    max abs (by float32's least normal where ``ref`` is all zeros)."""
    return ((got - ref).abs().max().item()
            / max(ref.abs().max().item(), 1.1754944e-38))


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


def long_config(TransformerConfig, num_layers=12, variant="grid",
                dtype=None):
    """The long-context grid configuration: the serve phase's widths at
    max_len 4096 with the grid kernels and 512-key blocks (``dtype`` None:
    float32)."""
    kw = {} if dtype is None else {"dtype": dtype}
    return TransformerConfig(vocab_size=32000, num_layers=num_layers,
                             num_heads=8, d_model=512, max_len=LONG_S,
                             attn_variant=variant, block_k=LONG_W, **kw)


def n_live_kv(rows_pos, k0, w, n_split):
    """Key splits each causal row (global positions) can see."""
    return [0 if p < k0 else min((p - k0) // w + 1, n_split)
            for p in rows_pos]


def grid_bounds(b, h, sq, sk, d, q0, wq, wk, es=4.0):
    """{kernel: (flops, bytes)} of the causal grid kernels at these shapes,
    counting what these inputs need: visible keys only, and the workspace
    rows of the splits each row (key) can see. ``es``: bytes an element of
    q, k, v, do and the outputs (4 float32, 2 bf16); the workspaces, lse
    and deff are float32."""
    nk, nq = -(-sk // wk), -(-sq // wq)
    bh, f = b * h, 4.0
    vis = bh * sum(visible_keys(sq, sk, q0, 0))
    live_rows = bh * sum(n_live_kv(range(q0, q0 + sq), 0, wk, nk))
    # query splits that see each key: those from the first row that does
    live_keys = bh * sum(0 if j > q0 + sq - 1 else
                         nq - max(0, j - q0) // wq for j in range(sk))
    n_q, n_k = bh * sq * d, bh * sk * d
    return {
        "fwd": (4.0 * vis * d, es * (n_q + 2 * n_k)
                + f * live_rows * (d + 1)),
        "fwd_combine": (2.0 * live_rows * (d + 1),
                        f * live_rows * (d + 1) + bh * sq * (es * d + f)),
        "dq": (6.0 * vis * d, es * (2 * n_q + 2 * n_k)
               + f * (2 * bh * sq + live_rows * d)),
        "dq_reduce": (1.0 * live_rows * d, f * live_rows * d + es * n_q),
        "dkv": (8.0 * vis * d, es * (2 * n_q + 2 * n_k)
                + f * (2 * bh * sq + 2 * live_keys * d)),
        "dkv_reduce": (2.0 * live_keys * d,
                       2 * (f * live_keys * d + es * n_k)),
    }


def phase_grid_kernel(torch, fa, dev):
    """The grid kernels against their plain versions (module docstring,
    phase 12). Returns (per-kernel worst errors, timing rows)."""
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

    # each pass alone, timed
    t = grid_pass_times(torch, fa, dev, rand, leaves, torch.float32,
                        check, lambda kind, what, lse, ref: check(
                            kind, what + " lse", lse, ref))
    t["cases"] = n_cases
    return worst, t


def grid_pass_times(torch, fa, dev, rand, leaves, dtype, check,
                    check_lse):
    """Each grid kernel and pass alone in ``dtype`` (float32 or bf16): the
    combine and reduce passes on the plain version's float32 partials (a
    split a row cannot see holds (0, -1e30) or zeros there, which the
    kernels never read), held by ``check(kind, what, got, ref)`` and
    ``check_lse(kind, what, lse, ref)``; then device times (CUDA graphs)
    at the long training shape (4, 8, 4096, 64) causal with 8 splits and
    at #3's last chunk of a 3800-token prompt: each kernel and pass, the
    whole wrapper, its plain version, the stream kernel at the same shape,
    #4 with one split, and F.scaled_dot_product_attention as a yardstick
    only; each kernel's bound (float32: attention_bounds, 3xTF32; bf16:
    bf16_bounds), TFLOP/s and factor against SDPA. -> the row."""
    import torch.nn.functional as F
    sfx = "f32" if dtype == torch.float32 else "bf16"
    es = float(torch.finfo(dtype).bits // 8)
    bounds_of = attention_bounds if dtype == torch.float32 else bf16_bounds
    t = {}
    B, H, S, D = 4, 8, LONG_S, 64
    sm = 1.0 / math.sqrt(D)
    n_split = S // LONG_W
    q, k, v, do = (rand(B, H, S, D) for _ in range(4))
    offs0 = fa._offs0(dev)
    out_part, lse_part = fa.fwd_grid_parts(q, k, v, 0, 0, sm, True, LONG_W)
    out, lse = torch.empty_like(q), torch.empty(B, H, S, device=dev)
    combine = lambda: fa._launch(   # noqa: E731
        "mx_flash_fwd_grid_combine_" + sfx, out_part.data_ptr(),
        lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(), B * H, S, D,
        LONG_W, n_split, 1, device=dev)
    combine()
    ref_out, ref_lse = fa._combine_splits(out_part, lse_part)
    check("fwd_combine", "combine out", out, ref_out.to(dtype))
    check_lse("fwd_combine", "combine", lse, ref_lse)
    t["fwd_combine_ms"] = time_ms(combine)
    t["fwd_combine_plain_ms"] = time_ms(
        lambda: fa._combine_splits(out_part, lse_part)[0].to(dtype),
        iters=5)
    t["fwd_plain_ms"] = time_ms(lambda: fa.fwd_grid_parts(
        q, k, v, 0, 0, sm, True, LONG_W), iters=3, reps=3)
    t["fwd_whole_plain_ms"] = time_ms(lambda: fa.flash_fwd_grid_plain(
        q, k, v, sm, True, LONG_W), iters=3, reps=3)
    ws_out, ws_lse = torch.empty_like(out_part), torch.empty_like(lse_part)
    t["fwd_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_fwd_grid_" + sfx, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), ws_out.data_ptr(), ws_lse.data_ptr(), B * H, S, S, D,
        LONG_W, n_split, sm, 1, device=dev), iters=5)
    t["fwd_whole_ms"] = time_ms(lambda: fa._flash_fwd_grid_cuda(
        q, k, v, None, sm, True, LONG_W), iters=5)
    t["fwd_stream_ms"] = time_ms(lambda: fa._flash_fwd_cuda(q, k, v, sm,
                                                            True), iters=5)
    sdpa = lambda a, b_, c: F.scaled_dot_product_attention(  # noqa: E731
        a, b_, c, is_causal=True, scale=sm)
    t["sdpa_fwd_ms"] = time_ms(lambda: sdpa(q, k, v), iters=5)
    del out_part, lse_part, ws_out, ws_lse
    torch.cuda.empty_cache()

    out, lse = fa._flash_fwd_grid_cuda(q, k, v, None, sm, True, LONG_W)
    deff = fa._deff(do, out, None).contiguous()
    dq_part, dk_part, dv_part = fa.bwd_grid_parts(
        q, k, v, offs0, do, None, out, lse, sm, True, LONG_W, LONG_W)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dq_reduce = lambda: fa._launch(   # noqa: E731
        "mx_flash_bwd_dq_grid_reduce_" + sfx, offs0.data_ptr(),
        dq_part.data_ptr(), dq.data_ptr(), B * H, S, D, LONG_W, n_split, sm,
        1, device=dev)
    dkv_reduce = lambda: fa._launch(   # noqa: E731
        "mx_flash_bwd_dkv_grid_reduce_" + sfx, offs0.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, S, S, D, LONG_W, n_split, 1, device=dev)
    dq_reduce()
    dkv_reduce()
    check("dq_reduce", "dq reduce", dq,
          (fa._sum_splits(dq_part) * sm).to(dtype))
    check("dkv_reduce", "dk reduce", dk, fa._sum_splits(dk_part).to(dtype))
    check("dkv_reduce", "dv reduce", dv, fa._sum_splits(dv_part).to(dtype))
    t["dq_reduce_ms"] = time_ms(dq_reduce)
    t["dkv_reduce_ms"] = time_ms(dkv_reduce)
    t["dq_reduce_plain_ms"] = time_ms(
        lambda: (fa._sum_splits(dq_part) * sm).to(dtype), iters=5)
    t["dkv_reduce_plain_ms"] = time_ms(
        lambda: (fa._sum_splits(dk_part).to(dtype),
                 fa._sum_splits(dv_part).to(dtype)), iters=5)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), offs0.data_ptr(),
              do.data_ptr(), lse.data_ptr(), deff.data_ptr())
    t["dq_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dq_grid_" + sfx, *common, dq_part.data_ptr(), B * H,
        S, S, D, LONG_W, n_split, sm, 1, device=dev), iters=5)
    t["dkv_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dkv_grid_" + sfx, *common, dk_part.data_ptr(),
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
        "mx_flash_bwd_dq_grid_" + sfx, *common, dq.data_ptr(), B * H, S, S,
        D, S, 1, sm, 1, device=dev), iters=5)
    t["dkv_1split_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dkv_grid_" + sfx, *common, dk.data_ptr(),
        dv.data_ptr(), B * H, S, S, D, S, 1, sm, 1, device=dev), iters=5)
    t["bwd_whole_1split_ms"] = time_ms(lambda: fa._flash_bwd_grid_cuda(
        q, k, v, offs0, do, deff, lse, sm, True, (S, S)), iters=5)
    stream_tail = (B * H, S, S, D, sm, 1)
    t["dq_stream_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dq_" + sfx, *common, dq.data_ptr(), *stream_tail,
        device=dev), iters=3)
    t["dkv_stream_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_bwd_dkv_" + sfx, *common, dk.data_ptr(), dv.data_ptr(),
        *stream_tail, device=dev), iters=3)
    qg, kg, vg = leaves(q, k, v)
    t["sdpa_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        sdpa(qg, kg, vg), (qg, kg, vg), do), iters=5)
    t["sdpa_bwd_ms"] = t["sdpa_fwd_bwd_ms"] - t["sdpa_fwd_ms"]
    bounds = grid_bounds(B, H, S, S, D, 0, LONG_W, LONG_W, es)
    del q, k, v, do, out, lse, deff, dq, dk, dv, qg, kg, vg
    torch.cuda.empty_cache()

    # #3 at the last 1024-token chunk of a 3800-token prompt
    C, q0 = 1024, 2816
    q, k, v = rand(1, H, C, D), rand(1, H, S, D), rand(1, H, S, D)
    offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
    out_part, lse_part = fa.fwd_grid_parts(q, k, v, offs[0], offs[1], sm,
                                           True, LONG_W)
    out, lse = torch.empty_like(q), torch.empty(1, H, C, device=dev)
    combine = lambda: fa._launch(   # noqa: E731
        "mx_flash_fwd_offs_grid_combine_" + sfx, offs.data_ptr(),
        out_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(),
        lse.data_ptr(), H, C, D, LONG_W, n_split, 1, device=dev)
    combine()
    ref_out, ref_lse = fa._combine_splits(out_part, lse_part)
    check("offs_combine", "offs combine out", out, ref_out.to(dtype))
    check_lse("offs_combine", "offs combine", lse, ref_lse)
    t["offs_combine_ms"] = time_ms(combine)
    t["offs_combine_plain_ms"] = time_ms(
        lambda: fa._combine_splits(out_part, lse_part)[0].to(dtype))
    ws_out, ws_lse = torch.empty_like(out_part), torch.empty_like(lse_part)
    t["offs_ms"] = time_ms(lambda: fa._launch(
        "mx_flash_fwd_offs_grid_" + sfx, q.data_ptr(), k.data_ptr(),
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
    ob = grid_bounds(1, H, C, S, D, q0, LONG_W, LONG_W, es)
    bounds["offs"], bounds["offs_combine"] = ob["fwd"], ob["fwd_combine"]
    for name, (flops, nbytes) in bounds.items():
        for key, val in bounds_of(flops, nbytes).items():
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
    del q, k, v, out_part, lse_part, ws_out, ws_lse, out, lse
    torch.cuda.empty_cache()
    return t


def serve_long_prompts(model, cfg, seed, counters, others, what):
    """The long-context engine (``DecodeEngine`` over ``model``: block_size
    16, 1025 blocks, batch 4, max_seq_len 4096, buckets (256, 1024),
    prefill_chunk 1024) serving LONG_PROMPTS (+-32 tokens, ``seed``), 32
    new tokens each, with the launch ``counters`` set to 0 just before and
    read just after. Fails unless all are served, each counter reads 12
    per prefill call, every counter of ``others`` reads 0, no KV block
    stays live and every stream equals its solo decode. -> (result,
    counts, prompts, engine setup seconds)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.serving import DecodeEngine
    t0 = time.perf_counter()
    eng = DecodeEngine(block_size=16, num_blocks=1025, batch_size=4,
                       max_seq_len=LONG_S, prefill_buckets=(256, 1024),
                       prefill_chunk=1024, **model.engine_kwargs())
    setup_s = time.perf_counter() - t0
    try:
        if eng._k_pages.dtype != cfg.dtype:
            fail("%s: pages are %s, the model's dtype %s"
                 % (what, eng._k_pages.dtype, cfg.dtype))
        rng = np.random.RandomState(seed)
        lengths = [n + int(rng.randint(-32, 33)) for n in LONG_PROMPTS]
        prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in lengths]
        new = 32
        stamps = {}

        def on_token(stream, seq_no, token):
            stamps.setdefault(stream.rid, []).append(time.monotonic())

        torch.cuda.synchronize()
        for name in tuple(counters) + tuple(others):
            setattr(fa, name, 0)
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new, on_token=on_token)
                   for p in prompts]
        outs = [s.result_wait(600.0) for s in streams]
        wall = time.perf_counter() - t0
        counts = {name: getattr(fa, name) for name in counters}
        other_counts = {name: getattr(fa, name) for name in others}
        calls = sum(-(-n // 1024) for n in lengths)
        st = eng.stats()
        if st["served"] != len(prompts):
            fail("%s: served %d of %d" % (what, st["served"], len(prompts)))
        for name in counters:
            if counts[name] != cfg.num_layers * calls:
                fail("%s: %s = %d, want %d (12 per prefill call, %d calls)"
                     % (what, name, counts[name], cfg.num_layers * calls,
                        calls))
        if any(other_counts.values()):
            fail("%s: other attention kernels launched: %s"
                 % (what, other_counts))
        if st["kv"]["blocks_live"] != 0:
            fail("%s: %d KV blocks still live" % (what,
                                                   st["kv"]["blocks_live"]))
        for o in outs:
            if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
                fail("%s: bad stream %s" % (what, o))
        ttft = [stamps[s.rid][0] - s.submitted_t for s in streams]
        gaps = [b - a for s in streams
                for a, b in zip(stamps[s.rid], stamps[s.rid][1:])]
        solo = [eng.generate(p, max_new_tokens=new, timeout=600.0)
                for p in prompts]
        if solo != outs:
            bad = [i for i, (a, b) in enumerate(zip(solo, outs)) if a != b]
            fail("%s: continuous != solo for prompts %s" % (what, bad))
    finally:
        eng.stop()
    result = {"wall_s": wall, "prompt_tokens": lengths,
              "tokens": sum(len(o) for o in outs),
              "tokens_per_s": sum(len(o) for o in outs) / wall,
              "ttft_ms": [x * 1e3 for x in ttft],
              "ttft_p50_ms": statistics.median(ttft) * 1e3,
              "intertoken_p50_ms": statistics.median(gaps) * 1e3,
              "prefill_calls": calls, "launches": counts,
              "other_launches": other_counts, "steps": st["steps"],
              "program_counts": list(eng.program_counts()),
              "continuous_equals_solo": True,
              "kv_page_bytes": eng._k_pages.element_size()}
    return result, counts, prompts, setup_s


def phase_serve_long(torch, fa, dev, seed, out_dir):
    """The long-context configuration served (module docstring, phase
    13). Returns (result, launches per grid kernel on the run)."""
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, TransformerDecodeModel, transformer_decode_prefill,
        transformer_decode_step)
    cfg = long_config(TransformerConfig)
    t0 = time.perf_counter()
    model = TransformerDecodeModel(cfg, seed=seed, device=dev)
    if not model.use_kernel:
        fail("serve_long: model on %s did not resolve to the kernel tier"
             % dev)
    setup_s = time.perf_counter() - t0
    counters = [GRID_KERNELS[k][1] for k in ("offs", "offs_combine")]
    served, counts, prompts, eng_s = serve_long_prompts(
        model, cfg, seed, counters, STREAM_COUNTERS, "serve_long")

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
    result = {"phase": "serve_long", "setup_s": setup_s + eng_s, **served,
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
                            "sm80", "ampere", "matmul", "nvjet")):
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
    library) against this one's multi-tensor launch on one ResNet-50
    update of each kind. A parent with per-leaf entries
    (``mx_optupdate_*_f32``) runs its kernel on the 71 leaves
    ``_kernel_eligible`` takes and the plain expression on the other 86,
    as its ``fused_update_step`` ran them; a parent with the multi-tensor
    entries runs them through this checkout's wrapper with the parent's
    functions. Both must give the same bits; both are timed in turns
    (parent, this, this, parent) as device time in a CUDA graph and as
    eager wall."""
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
    parent_fns = None
    if hasattr(lib, tou._ENTRY["sgd"]):
        parent_fns = {}
        for name, argtypes in tou._ENTRIES.items():
            parent_fns[name] = getattr(lib, name)
            parent_fns[name].argtypes = argtypes
            parent_fns[name].restype = ctypes.c_int
    _, shapes = resnet50_param_shapes(tres)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    kw = dict(rescale=1 / 32, clip=0.01, wd=1e-4)
    for kind, (name, argtypes) in entries.items():
        if parent_fns is None:
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
            if parent_fns is not None:
                tou._launch(opt, hp, lr_t, table, **kw, fns=parent_fns)
                return
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
            "leaves": len(names), "parent_launches": (
                -(-len(names) // tou._MAX_LEAVES) if parent_fns else sum(
                    1 for p_, _, _ in trees[0]
                    if tou._kernel_eligible(p_)))}
        del trees, params0, grads
        torch.cuda.empty_cache()


def phase_parent(torch, fa, dev, parent):
    """This checkout's attention kernels and #7 against another's
    (``--parent DIR``: a checkout, e.g. the parent commit unpacked with
    ``git archive``), built from DIR's ``csrc/`` and called through the
    same C entries (#7: the parent's per-leaf entries) on the same card.
    The float32 attention entries (forwards #5, #6, #1, #3 and backwards
    #2, #4) and #7 must give the same bits in both; the bf16 entries
    (#5, #1, #2, #6, #3, #4) are each held to BF16_ULPS row ulps of the
    plain version in both trees, with the row-ulp distance between the
    trees recorded; every kernel is timed in turns (DIR's, this, this,
    DIR's) at its main path's shape. The registers and spill bytes of
    DIR's bf16 bodies are reported beside this tree's (the build line)."""
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
              "fwd_bit_identical": True, "opt_bit_identical": True,
              "fwd_max_abs_diff": {}, "times": {}}

    def same_fwd(key, a, b_):
        live = b_[1] > NEG / 2
        result["fwd_max_abs_diff"][key] = max(
            (a[0] - b_[0]).abs().max().item(),
            (a[1] - b_[1])[live].abs().max().item())
        if not all(torch.equal(x, y) for x, y in zip(a, b_)):
            result["fwd_bit_identical"] = False
            fail("parent: %s differs from the parent's bits" % key)

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
            same_fwd(pre + "fwd", a, b_)
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
        same_fwd(key, a, b_)

    # the bf16 entries: their bodies' sums run in another order than the
    # parent's, so each tree is held to BF16_ULPS row ulps of the plain
    # version (lse to TOL) and the distance between the trees is printed.
    # The grid entries' workspaces go through this tree's combine or
    # reduce pass on both sides. #5 and #2 at the training shape, #1 at the
    # serving shape, #6 and #4 at the long training shape (8 splits), #3
    # at the long prefill's last chunk
    from mxnet_tpu_torch.kernels.bf16_gate import BF16_ULPS, row_ulps
    bf = torch.bfloat16
    result["bf16"] = {}

    def hold_bf16(key, a, b_, ref):
        """a, b_: the parent's and this tree's final outputs; ref: the
        plain version's, in the same order (bf16 outputs, float32 lse)."""
        row = {"ulps": [], "parent_ulps": [], "to_parent_ulps": []}
        for x, y, r in zip(a, b_, ref):
            if r.dtype != bf:   # lse
                live = r > NEG / 2
                err = scaled_err(y[live], r[live])
                if not err <= TOL or not bool((y[~live] == NEG).all()):
                    fail("parent: bf16 %s lse err %g" % (key, err))
                continue
            u = row_ulps(y, r)
            if not u <= BF16_ULPS:
                fail("parent: bf16 %s %.2f row ulps off the plain version"
                     % (key, u))
            row["ulps"].append(u)
            row["parent_ulps"].append(row_ulps(x, r))
            row["to_parent_ulps"].append(row_ulps(y, x))
        result["bf16"][key] = row

    B, H, S, D = 8, 8, 512, 64
    sm = 1.0 / math.sqrt(D)
    q, k, v, do = (rand(B, H, S, D).to(bf) for _ in range(4))
    offs0 = fa._offs0(dev)
    out, lse = fa.flash_fwd_plain(q, k, v, sm, True)
    deff = fa._deff(do, out, None).contiguous()
    o_, l_ = torch.empty_like(q), torch.empty(B, H, S, device=dev)
    tail = [B * H, S, S, D, sm, 1]
    a, b_ = both("bf16_fwd", "mx_flash_fwd_bf16",
                 [t.data_ptr() for t in (q, k, v, o_, l_)] + tail, [o_, l_])
    hold_bf16("bf16_fwd", a, b_, (out, lse))
    common = [t.data_ptr() for t in (q, k, v, offs0, do, lse, deff)]
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ref = fa.flash_bwd_offs_plain(q, k, v, offs0, do, None, out, lse, sm,
                                  True)
    for key, outs, want in (("dq", [dq], ref[:1]),
                            ("dkv", [dk, dv], ref[1:])):
        a, b_ = both("bf16_" + key, "mx_flash_bwd_%s_bf16" % key,
                     common + [o.data_ptr() for o in outs] + tail, outs)
        hold_bf16("bf16_" + key, a, b_, want)
    C, SK, q0 = 256, 512, 256
    q, k, v = (rand(1, H, n, D).to(bf) for n in (C, SK, SK))
    offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
    o_, l_ = torch.empty_like(q), torch.empty(1, H, C, device=dev)
    a, b_ = both("bf16_offs", "mx_flash_fwd_offs_bf16",
                 [t.data_ptr() for t in (q, k, v, offs, o_, l_)]
                 + [H, C, SK, D, sm, 1], [o_, l_])
    hold_bf16("bf16_offs", a, b_,
              fa.flash_fwd_offs_plain(q, k, v, offs, sm, True))
    del q, k, v, do, out, lse, deff, o_, l_, dq, dk, dv, ref
    torch.cuda.empty_cache()

    def launch(name, *args):   # this tree's pass (raises if refused)
        fa._launch(name, *args, device=dev)

    B, S, w = 4, LONG_S, LONG_W
    n = S // w
    q, k, v, do = (rand(B, H, S, D).to(bf) for _ in range(4))
    out, lse = fa.flash_fwd_grid_plain(q, k, v, sm, True, w)
    deff = fa._deff(do, out, None).contiguous()
    po, pl = (torch.empty(n, B, H, S, D, device=dev),
              torch.empty(n, B, H, S, device=dev))
    a, b_ = both("bf16_grid_fwd", "mx_flash_fwd_grid_bf16",
                 [t.data_ptr() for t in (q, k, v, po, pl)]
                 + [B * H, S, S, D, w, n, sm, 1], [po, pl], iters=5)
    finals = []
    for po_, pl_ in (a, b_):
        o_, l_ = torch.empty_like(q), torch.empty(B, H, S, device=dev)
        launch("mx_flash_fwd_grid_combine_bf16", po_.data_ptr(),
               pl_.data_ptr(), o_.data_ptr(), l_.data_ptr(), B * H, S, D,
               w, n, 1)
        finals.append([o_, l_])
    hold_bf16("bf16_grid_fwd", *finals, (out, lse))
    del po, pl, a, b_, finals
    common = [t.data_ptr() for t in (q, k, v, offs0, do, lse, deff)]
    ref = fa.flash_bwd_offs_grid_plain(q, k, v, offs0, do, None, out, lse,
                                       sm, True, w, w)
    parts = [torch.empty(n, B, H, S, D, device=dev) for _ in range(3)]
    for key, outs, want in (("dq", parts[:1], ref[:1]),
                            ("dkv", parts[1:], ref[1:])):
        a, b_ = both("bf16_grid_" + key, "mx_flash_bwd_%s_grid_bf16" % key,
                     common + [o.data_ptr() for o in outs]
                     + [B * H, S, S, D, w, n, sm, 1], outs, iters=5)
        finals = []
        for got in (a, b_):
            fin = [torch.empty_like(q) for _ in got]
            if key == "dq":
                launch("mx_flash_bwd_dq_grid_reduce_bf16", offs0.data_ptr(),
                       got[0].data_ptr(), fin[0].data_ptr(), B * H, S, D, w,
                       n, sm, 1)
            else:
                launch("mx_flash_bwd_dkv_grid_reduce_bf16",
                       offs0.data_ptr(), got[0].data_ptr(),
                       got[1].data_ptr(), fin[0].data_ptr(),
                       fin[1].data_ptr(), B * H, S, S, D, w, n, 1)
            finals.append(fin)
        hold_bf16("bf16_grid_" + key, *finals, want)
        del a, b_, finals
    del q, k, v, do, out, lse, deff, ref, parts
    torch.cuda.empty_cache()
    C, q0 = 1024, 2816
    q, k, v = rand(1, H, C, D).to(bf), rand(1, H, S, D).to(bf), \
        rand(1, H, S, D).to(bf)
    offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
    po, pl = (torch.empty(n, 1, H, C, D, device=dev),
              torch.empty(n, 1, H, C, device=dev))
    a, b_ = both("bf16_grid_offs", "mx_flash_fwd_offs_grid_bf16",
                 [t.data_ptr() for t in (q, k, v, offs, po, pl)]
                 + [H, C, S, D, w, n, sm, 1], [po, pl])
    finals = []
    for po_, pl_ in (a, b_):
        o_, l_ = torch.empty_like(q), torch.empty(1, H, C, device=dev)
        launch("mx_flash_fwd_offs_grid_combine_bf16", offs.data_ptr(),
               po_.data_ptr(), pl_.data_ptr(), o_.data_ptr(), l_.data_ptr(),
               H, C, D, w, n, 1)
        finals.append([o_, l_])
    hold_bf16("bf16_grid_offs", *finals,
              fa.flash_fwd_offs_grid_plain(q, k, v, offs, sm, True, w))
    del q, k, v, po, pl, a, b_, finals
    torch.cuda.empty_cache()
    parent_opt_update(torch, dev, libs["opt_update"], result)
    for v_ in result["times"].values():
        v_["speedup"] = v_["parent_ms"] / v_["ms"]
    # the parent's bf16 bodies: [registers, spill store, spill load bytes]
    result["ptxas"] = {}
    for n in paths:
        info = _build.csrc_build_info.get((csrc, n))
        bodies = {k: v for k, v in ptxas_kernels(
            info["ptxas"] if info else "").items()
                  if k.split("<")[0] in BF16_BODIES}
        if bodies:
            result["ptxas"][n] = bodies
    return result


# --- Module.fit and the reference's scripts (phases 17-18) -----------------

FIT_STEPS = 24          # one epoch: the 4 seeded batches, 6 times over
FIT_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
#: the JAX package's last-epoch Train-accuracy of train_mnist.py --network
#: lenet --num-epochs 3 (MNIST_SYNTH_N 6000) on the CPU, both --kv-store
#: local and tpu_sync (PERF.md, the Module slice)
JAX_CPU_LENET_ACC = 1.0
#: runs the launcher in the child and prints kernel #7's counts at its end
SCRIPT_BOOT = (
    "import json, sys\n"
    "from mxnet_tpu_torch import run_script\n"
    "from mxnet_tpu_torch.kernels import opt_update as tou\n"
    "rc = run_script.main(sys.argv[1:])\n"
    "print('opt_update_counts ' + json.dumps({k: [getattr(tou, "
    "'launches_' + k), getattr(tou, 'leaves_' + k)] for k in "
    "('sgd', 'sgd_mom', 'adam')}), flush=True)\n"
    "import torch\n"
    "print('allow_tf32 ' + json.dumps([torch.backends.cuda.matmul."
    "allow_tf32, torch.backends.cudnn.allow_tf32]), flush=True)\n"
    "sys.exit(rc)\n")


def _module(mx, sym, dev, it, arg, aux, kvstore):
    """A Module bound for training on ``it``'s shapes from ``arg``/``aux``
    with the fit phase's SGD, its optimizer built for ``kvstore``."""
    mod = mx.mod.Module(sym, context=dev)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=FIT_OPT)
    return mod


def phase_module_fit(torch, dev, seed, out_dir):
    """Full-width ResNet-50 through Module.fit(kvstore='tpu_sync')
    (module docstring, phase 17). Returns (result, per-kernel (launches,
    leaves) on the path)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.parallel import DataParallelTrainStep
    t0 = time.perf_counter()
    with mx.name.NameManager():
        sym = tres.get_symbol(num_classes=1000, num_layers=50,
                              image_shape="3,224,224")
    n_leaves = len(sym.list_arguments()) - 2
    rng = np.random.RandomState(seed)
    data = rng.uniform(-1, 1, (4 * SYM_BATCH, 3, 224, 224)).astype(
        np.float32)
    label = rng.randint(0, 1000, (4 * SYM_BATCH,)).astype(np.float32)
    rows = np.arange(FIT_STEPS * SYM_BATCH) % (4 * SYM_BATCH)
    train = mx.io.NDArrayIter(data[rows], label[rows], SYM_BATCH)
    setup_s = time.perf_counter() - t0

    stamps, quarters = [], []

    def on_batch(p):
        if p.nbatch in (FIT_STEPS // 2 - 1, FIT_STEPS - 1):
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if p.nbatch % (FIT_STEPS // 4) == FIT_STEPS // 4 - 1:
            quarters.append(float(p.eval_metric.get()[1]))
            p.eval_metric.reset()

    mx.random.seed(seed)
    mod = mx.mod.Module(sym, context=dev)
    torch.cuda.synchronize()
    _reset_opt_counts(tou)
    t1 = time.perf_counter()
    with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
        mod.fit(train, eval_metric="crossentropy", kvstore="tpu_sync",
                optimizer="sgd", optimizer_params=FIT_OPT,
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           magnitude=2),
                batch_end_callback=on_batch, num_epoch=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    counts = (_opt_counts(tou), _opt_leaves(tou))
    want = ({"sgd": 0, "sgd_mom": FIT_STEPS, "adam": 0},
            {"sgd": 0, "sgd_mom": n_leaves * FIT_STEPS, "adam": 0})
    if mod._fused_step is None:
        fail("module_fit: Module.fit(kvstore='tpu_sync') built no fused "
             "step")
    if counts != want:
        fail("module_fit: kernel #7 (launches, leaves) %s, want %s"
             % (counts, want))
    if mod._fused_step.program_count() != 1:
        fail("module_fit: %d step signatures, want 1"
             % mod._fused_step.program_count())
    if len(quarters) != 4 or not all(math.isfinite(q) for q in quarters):
        fail("module_fit: cross-entropy by quarter %s" % quarters)
    if not quarters[-1] < quarters[0]:
        fail("module_fit: the loss did not fall: %s" % quarters)
    half = FIT_STEPS // 2
    walls = [b - a for a, b in zip(stamps[half:], stamps[half + 1:])]
    result = {"phase": "module_fit", "model": "resnet50",
              "batch": [SYM_BATCH, 3, 224, 224], "steps": FIT_STEPS,
              "setup_s": setup_s, "fit_s": fit_s,
              "img_per_s_second_half": SYM_BATCH * (FIT_STEPS - half)
              / (stamps[-1] - stamps[half - 1]),
              "step_wall_ms_p50": statistics.median(walls) * 1e3,
              "cross_entropy_by_quarter": quarters,
              "launches_per_step": counts[0]["sgd_mom"] / FIT_STEPS,
              "leaves_per_step": counts[1]["sgd_mom"] / FIT_STEPS,
              "program_count": mod._fused_step.program_count()}

    # one Module iteration as fit runs it, against the bare step
    metric = mx.metric.create("crossentropy")
    train.reset()
    batch = train.next()

    def module_step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)

    bare = mod._fused_step
    staged = {"data": torch.from_numpy(data[:SYM_BATCH]).to(dev),
              "softmax_label": torch.from_numpy(label[:SYM_BATCH]).to(dev)}
    result["module_step"] = profile_calls(
        torch, module_step, "module_fit", out_dir, warm=2, n=5, calls=3,
        classify=kind_of)
    result["bare_step"] = profile_calls(
        torch, lambda: bare(staged, lr=0.05), "module_fit_bare", None,
        warm=2, n=5, calls=3, classify=kind_of)

    def host_ms(fn, n=5):
        """Median host time of ``fn`` started on an idle card (no sync at
        its end: for a step, the time to enqueue it)."""
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return statistics.median(walls) * 1e3

    train.reset()
    result["host_ms"] = {"iterator_next": host_ms(train.next),
                         "module_step": host_ms(module_step),
                         "bare_step": host_ms(lambda: bare(staged, lr=0.05))}
    metric.get()

    # one step through Module against one of a bare DataParallelTrainStep
    # from the same params and batch; then 2 steps with kvstore='local'
    arg, aux = mod.get_params()
    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train.reset()
        first, second = train.next(), train.next()
        with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
            fused = _module(mx, sym, dev, train, arg, aux, "tpu_sync")
        step = DataParallelTrainStep(
            sym, lr=0.05, momentum=0.9, wd=1e-4,
            rescale_grad=1.0 / SYM_BATCH, fused_optupdate=True,
            device=dev).init_from(arg, aux, RESNET_SHAPES)
        fused.forward_backward(first)
        fused.update()
        step({"data": data[:SYM_BATCH], "softmax_label": label[:SYM_BATCH]},
             lr=0.05)
        torch.cuda.synchronize()
        bitwise, err = True, 0.0
        got_step = fused._fused_step
        for n in step.param_names:
            for got, ref in ((got_step.params[n], step.params[n]),
                             (got_step.opt_state["mom"][n],
                              step.opt_state["mom"][n])):
                same, _ = _bit_diff(torch, got.detach(), ref.detach())
                bitwise &= same
                err = max(err, leaf_err(got.detach(), ref.detach()))
        if not bitwise and not err <= 1e-6:
            fail("module_fit: a Module step and a bare step differ by %g "
                 "of a leaf's max abs" % err)
        local = _module(mx, sym, dev, train, arg, aux, "local")
        local_err = []
        for i, b in enumerate((first, second)):
            if i:
                fused.forward_backward(b)
                fused.update()
            local.forward_backward(b)
            local.update()
            want_arg, _ = fused.get_params()
            got_arg, _ = local.get_params()
            local_err.append(max(leaf_err(got_arg[n]._data,
                                          want_arg[n]._data)
                                 for n in step.param_names))
        # the per-param updater against the fused step: the same update
        # written twice (optimizer_ops and optim_update), 0.0 observed
        if local._fused_step is not None or \
                not all(e <= 1e-6 for e in local_err):
            fail("module_fit: kvstore='local' steps differ from tpu_sync "
                 "by %s of a leaf's max abs (limit 1e-6)" % local_err)
    finally:
        torch.backends.cudnn.deterministic = prior
    val = mx.io.NDArrayIter(data[:2 * SYM_BATCH], label[:2 * SYM_BATCH],
                            SYM_BATCH)
    score = {k: float(v) for k, v in mod.score(val, ["acc",
                                                     "crossentropy"])}
    if not all(math.isfinite(v) for v in score.values()):
        fail("module_fit: score %s" % score)
    result.update({"module_vs_bare_bitwise": bitwise,
                   "module_vs_bare_max_err": err,
                   "local_vs_tpu_sync_max_err": local_err,
                   "score": score})
    return result, {k: (counts[0][k], counts[1][k]) for k in OPT_KERNELS}


def _run_script(torch, script, args, env_extra, tmp):
    """The launcher in a subprocess on ``script`` -> (stdout + stderr,
    kernel #7's counts in the child, seconds)."""
    env = dict(os.environ, MNIST_DIR=os.path.join(tmp, "no-mnist"),
               PYTHONPATH=ROOT, **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT_BOOT, os.path.join(
            ROOT, "example", "image-classification", script)] + args,
        cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        fail("example_scripts: %s %s exited %d: %s" % (
            script, args, proc.returncode, out[-3000:]))
    if "run_script: jax not in sys.modules" not in proc.stdout:
        fail("example_scripts: %s printed no 'jax not in sys.modules'"
             % script)
    counts = json.loads(proc.stdout.split("opt_update_counts ")[1]
                        .splitlines()[0])
    tf32 = json.loads(proc.stdout.split("allow_tf32 ")[1].splitlines()[0])
    if tf32 != [False, False]:
        fail("example_scripts: %s trained with TF32 allowed (matmul, "
             "cuDNN): %s; Module must pin float32" % (script, tf32))
    return out, counts, seconds


def phase_example_scripts(torch, dev, tmp):
    """The reference's example scripts, unchanged, on the card through the
    launcher (module docstring, phase 18). Returns (result, per-kernel
    (launches, leaves) on the path)."""
    import re
    result = {"phase": "example_scripts", "runs": {}}
    total = {k: [0, 0] for k in OPT_KERNELS}
    fused = {"MXNET_TPU_FUSED_OPTUPDATE": "1"}
    runs = (("mnist_lenet_local", "train_mnist.py",
             ["--kv-store", "local"], {}, 3, 8),
            ("mnist_lenet_tpu_sync", "train_mnist.py",
             ["--kv-store", "tpu_sync"], fused, 3, 8),
            ("imagenet_resnet50_tpu_sync", "train_imagenet.py",
             ["--benchmark", "1", "--kv-store", "tpu_sync",
              "--num-examples", "768"], fused, 1, 157))
    for name, script, args, env, epochs, leaves in runs:
        if script == "train_mnist.py":
            args = ["--network", "lenet", "--num-epochs", "3"] + args
        else:
            args = args + ["--num-epochs", "1"]
        out, counts, seconds = _run_script(
            torch, script, ["--gpus", "0"] + args, env, tmp)
        acc = [float(v) for v in re.findall(
            r"Epoch\[\d+\] Train-accuracy=([0-9.]+)", out)]
        speeds = [float(v) for v in re.findall(
            r"Speed: ([0-9.]+) samples/sec", out)]
        windows = [float(v) for v in re.findall(
            r"samples/sec\taccuracy=([0-9.]+)", out)]
        if len(acc) != epochs or not speeds:
            fail("example_scripts %s: Train-accuracy %s, Speedometer %s"
                 % (name, acc, speeds))
        tpu_sync = "tpu_sync" in name
        if tpu_sync != ("fused train step active" in out):
            fail("example_scripts %s: fused step active is %s"
                 % (name, not tpu_sync))
        steps = counts["sgd_mom"][0]
        if (tpu_sync and (steps < 1 or counts["sgd_mom"][1]
                          != leaves * steps)) or \
                (not tpu_sync and steps) or \
                counts["sgd"][0] or counts["adam"][0]:
            fail("example_scripts %s: kernel #7 counts %s" % (name, counts))
        if script == "train_mnist.py":
            # the epoch line holds the batches after the Speedometer's last
            # reset; its first window is the earliest accuracy
            if not (acc[-1] > windows[0]
                    and acc[-1] >= JAX_CPU_LENET_ACC - 0.02):
                fail("example_scripts %s: LeNet did not learn: first window "
                     "%s, epochs %s (the JAX package on the CPU: %s)"
                     % (name, windows[:1], acc, JAX_CPU_LENET_ACC))
        for k in OPT_KERNELS:
            total[k][0] += counts[k][0]
            total[k][1] += counts[k][1]
        result["runs"][name] = {
            "seconds": seconds, "train_accuracy": acc,
            "first_window_accuracy": windows[:1],
            "speedometer_samples_per_s": speeds,
            "opt_update_launches": steps}
    return result, {k: tuple(v) for k, v in total.items()}


# --- bf16 compute (phases 19-24) --------------------------------------------

PEAK_BF16_FLOPS = 989e12
BF16_COUNTERS = ("launches_bf16", "launches_fwd_bf16", "launches_bwd_dq_bf16",
                 "launches_bwd_dkv_bf16")
#: grid kernel -> its bf16 instantiation's launch counter
BF16_GRID_COUNTERS = {key: counter + "_bf16"
                      for key, (_, counter, _, _) in GRID_KERNELS.items()}


def bf16_bounds(flops, nbytes):
    ms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    return {"bound_ms": ms, "bound_by": by}


# Limits of the bf16 paths against float32, set from readings of seeds 0 to
# 2 on the card beside controls that are wrong on purpose; every run reads
# its controls again and fails if one passes the gate it is held to
# (PERF.md, section 6).
#: the bf16 model's first loss against the float32 model's from the same
#: weights (relative): sound runs read at most 1.1e-5. At random init the
#: loss hardly depends on attention (the controls read 1.7e-5 to 8.8e-4),
#: so the gradients are the gate the controls must fail
BF16_LOSS_RTOL = 3e-5
#: the bf16 model's first gradients against the float32 model's from the
#: same weights, the largest ||g_bf16 - g_f32|| / ||g_f32|| over the
#: leaves: sound runs read at most 0.0146, both controls at least 0.72
BF16_GRAD_RTOL = 0.1
#: ResNet-50's first cross-entropy in bf16 against float32's from the same
#: params and batch (relative): sound runs read at most 4.4e-3, the
#: control on masters rounded to float8 e4m3 at least 2.5e-2
BF16_CE_RTOL = 1e-2
#: ResNet-50's first update of the classifier (fc1_weight, fc1_bias) in
#: bf16 against float32's, ||dw_bf16 - dw_f32|| / ||dw_f32||, the layer
#: the labels enter: sound runs read at most 0.046, the control on labels
#: rounded to bf16 at least 1.16 (the float8 one 0.15-0.17). Over all 157
#: masters sound runs already differ by 0.75-0.80, too much to gate on
BF16_UPDATE_RTOL = 0.1
#: key tile of the transformer's control attention (the kernels' at D 64)
CONTROL_TILE = 64


def _control_attention(torch, fault):
    """Plain causal bf16 attention over key tiles of CONTROL_TILE with one
    planted fault, a control for the bf16 model's gates (the signature of
    ``models.transformer._attention``). "diagonal": each query tile's own
    key tile is dropped, so its first rows see no key and give 0.
    "rescale": a tile's P V joins the running sum without rescaling the
    sum when the row max rises (the sums l are rescaled)."""
    def attention(q, k, v, cfg, mesh):
        B, H, S, D = q.shape
        qs = (q.float() / math.sqrt(D)).to(q.dtype).float()
        m = q.new_full((B, H, S), NEG, dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, S, D, dtype=torch.float32, device=q.device)
        qi = torch.arange(S, device=q.device)[:, None]
        for t0 in range(0, S, CONTROL_TILE):
            kj = torch.arange(t0, min(S, t0 + CONTROL_TILE),
                              device=q.device)[None, :]
            seen = kj <= qi
            if fault == "diagonal":
                seen = seen & (kj // CONTROL_TILE != qi // CONTROL_TILE)
            s = (qs @ k[:, :, t0:t0 + CONTROL_TILE].float().transpose(-1, -2)
                 ).masked_fill(~seen, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None]) * seen
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = p.to(q.dtype).float() @ v[:, :, t0:t0 + CONTROL_TILE].float()
            acc = acc + pv if fault == "rescale" else \
                acc * alpha[..., None] + pv
            m = m_new
        return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return attention


def _first_grads(torch, loss_fn, params, batch):
    """(loss, gradients in ``tree_leaves`` order) of ``loss_fn`` at
    ``params`` (nested dicts of tensors)."""
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)

    loss = loss_fn(rebuild(params), batch)
    return loss.item(), torch.autograd.grad(loss, leaves)


def _leaf_names(tree, prefix=""):
    """Names of ``tree``'s leaves in ``tree_leaves`` order."""
    return [n for k in sorted(tree) for n in (
        _leaf_names(tree[k], prefix + k + ".") if isinstance(tree[k], dict)
        else [prefix + k])]


def _rel_l2(got, want):
    """||got - want|| / ||want|| over lists of tensors, in float64."""
    num = sum(((g.double() - w.double()) ** 2).sum() for g, w in
              zip(got, want))
    return math.sqrt((num / sum((w.double() ** 2).sum()
                                for w in want)).item())


def _bf16_counts(fa):
    return {name: getattr(fa, name) for name in BF16_COUNTERS}


def _zero_attention_counts(fa):
    for name in STREAM_COUNTERS + BF16_COUNTERS:
        setattr(fa, name, 0)


def _attention_counters(but):
    """Every attention kernel's launch counter but those in ``but``."""
    every = (STREAM_COUNTERS + BF16_COUNTERS
             + tuple(v[1] for v in GRID_KERNELS.values())
             + tuple(BF16_GRID_COUNTERS.values()))
    return tuple(n for n in every if n not in but)


def phase_serve_bf16(torch, fa, dev):
    """The serve phase's transformer in bf16 through DecodeEngine (module
    docstring, phase 19). Returns (result, #1's bf16 launches)."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerDecodeModel)
    from mxnet_tpu_torch.serving import DecodeEngine
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                            d_model=512, max_len=512, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = TransformerDecodeModel(cfg, seed=SEED, device=dev)
    eng = DecodeEngine(block_size=16, num_blocks=257, batch_size=8,
                       max_seq_len=512, prefill_buckets=(64, 256),
                       prefill_chunk=256, **model.engine_kwargs())
    setup_s = time.perf_counter() - t0
    try:
        if eng._k_pages.dtype != torch.bfloat16:
            fail("serve_bf16: pages are %s" % eng._k_pages.dtype)
        rng = torch.Generator().manual_seed(SEED + 1)
        lengths = [5, 37, 64, 100, 200, 257, 380, 480]
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
                   .tolist() for n in lengths]
        new = 32
        stamps = {}

        def on_token(stream, seq_no, token):
            stamps.setdefault(stream.rid, []).append(time.monotonic())

        torch.cuda.synchronize()
        _zero_attention_counts(fa)
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new, on_token=on_token)
                   for p in prompts]
        outs = [s.result_wait(600.0) for s in streams]
        wall = time.perf_counter() - t0
        counts = {**_bf16_counts(fa), "launches": fa.launches}
        calls = sum(-(-n // 256) for n in lengths)
        st = eng.stats()
        if st["served"] != len(prompts):
            fail("serve_bf16: served %d of %d" % (st["served"],
                                                  len(prompts)))
        if counts["launches_bf16"] < cfg.num_layers * calls or \
                counts["launches"]:
            fail("serve_bf16: #1 launches %s, want >= %d in bf16 and none "
                 "in float32" % (counts, cfg.num_layers * calls))
        if st["kv"]["blocks_live"] != 0:
            fail("serve_bf16: %d KV blocks still live"
                 % st["kv"]["blocks_live"])
        for o in outs:
            if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
                fail("serve_bf16: bad stream %s" % o)
        ttft = [stamps[s.rid][0] - s.submitted_t for s in streams]
        gaps = [b - a for s in streams
                for a, b in zip(stamps[s.rid], stamps[s.rid][1:])]
        solo = [eng.generate(p, max_new_tokens=new, timeout=600.0)
                for p in prompts]
        if solo != outs:
            bad = [i for i, (a, b) in enumerate(zip(solo, outs)) if a != b]
            fail("serve_bf16: continuous != solo for prompts %s" % bad)
    finally:
        eng.stop()
    return {"phase": "serve_bf16", "setup_s": setup_s, "wall_s": wall,
            "tokens": sum(len(o) for o in outs),
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "intertoken_p50_ms": statistics.median(gaps) * 1e3,
            "prefill_calls": calls, "launches": counts,
            "program_counts": list(eng.program_counts()),
            "continuous_equals_solo": True,
            "kv_page_bytes": eng._k_pages.element_size()}, \
        counts["launches_bf16"]


def phase_train_bf16(torch, fa, dev, seed, out_dir):
    """The train phase's transformer in bf16 through ShardedTrainStep
    (module docstring, phase 20). Returns (result, bf16 launch counts)."""
    import mxnet_tpu_torch.models.transformer as tm
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_loss)
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                            d_model=512, max_len=512, dtype=torch.bfloat16)
    B, S = 8, 512
    t0 = time.perf_counter()
    params = init_transformer(cfg, torch.Generator().manual_seed(seed), dev)
    make_batch = periodic_batches(seed, cfg.vocab_size, S, B)
    batches = [make_batch() for _ in range(TRAIN_STEPS)]

    def loss_fn(p, b):
        return transformer_loss(p, b["tokens"], b["targets"], cfg)

    # the first loss and gradients against the float32 model's from the
    # same weights; then the bf16 model's under two faulty attentions, the
    # controls of BF16_LOSS_RTOL and BF16_GRAD_RTOL
    cfg32 = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                              d_model=512, max_len=512)
    first = {k: torch.as_tensor(x).to(dev) for k, x in batches[0].items()}
    params32 = {k: (v.float() if not isinstance(v, dict) else
                    {kk: vv.float() for kk, vv in v.items()})
                for k, v in params.items()}
    loss32, g32 = _first_grads(
        torch, lambda p, b: transformer_loss(p, b["tokens"], b["targets"],
                                             cfg32), params32, first)
    names = _leaf_names(params)

    def readings(loss, grads):
        errs = [_rel_l2([g], [w]) for g, w in zip(grads, g32)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        return {"loss_rel_err": abs(loss - loss32) / abs(loss32),
                "grad_rel_err": errs[worst], "grad_worst_leaf": names[worst]}

    gate = {"sound": readings(*_first_grads(torch, loss_fn, params, first))}
    for fault in ("diagonal", "rescale"):
        with mock.patch.object(tm, "_attention",
                               _control_attention(torch, fault)):
            gate[fault] = readings(*_first_grads(torch, loss_fn, params,
                                                 first))
    del params32, g32
    step = ShardedTrainStep(loss_fn, optimizer="adam", lr=1e-3,
                            grad_clip=1.0, device=dev).init(params)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_attention_counts(fa)
    losses, walls = [], []
    t0 = time.perf_counter()
    for b in batches:
        ts = time.perf_counter()
        losses.append(step(b).item())
        walls.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    counts = _bf16_counts(fa)
    f32_counts = {n: getattr(fa, n) for n in STREAM_COUNTERS}
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        fail("train_bf16: non-finite loss in %s" % losses)
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail("train_bf16: loss did not fall: %s" % losses)
    want = cfg.num_layers * TRAIN_STEPS
    for name in ("launches_fwd_bf16", "launches_bwd_dq_bf16",
                 "launches_bwd_dkv_bf16"):
        if counts[name] != want:
            fail("train_bf16: %s = %d, want %d (12 per step)"
                 % (name, counts[name], want))
    if any(f32_counts.values()) or counts["launches_bf16"]:
        fail("train_bf16: other attention kernels launched: %s %s"
             % (f32_counts, counts))
    rel = abs(losses[0] - loss32) / abs(loss32)
    if not (rel <= BF16_LOSS_RTOL and gate["sound"]["grad_rel_err"]
            <= BF16_GRAD_RTOL):
        fail("train_bf16: first bf16 loss %r vs float32 %r (rel %g, limit "
             "%g), gradients %s (limit %g)" % (losses[0], loss32, rel,
                                               BF16_LOSS_RTOL, gate,
                                               BF16_GRAD_RTOL))
    if not min(gate[f]["grad_rel_err"] for f in ("diagonal", "rescale")) \
            > BF16_GRAD_RTOL:
        fail("train_bf16: a control passes the gradient gate: %s" % gate)
    dtypes = sorted({str(t.dtype) for t in tree_leaves(step.params)})
    step_ms = statistics.median(walls[1:]) * 1e3
    prof = profile_calls(torch, lambda: step(batches[0]), "train_bf16",
                         out_dir, warm=2, n=5, calls=3)
    return {"phase": "train_bf16", "setup_s": setup_s, "steps": TRAIN_STEPS,
            "batch": [B, S], "wall_s": wall, "first_step_ms": walls[0] * 1e3,
            "step_ms_p50": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
            "losses": losses, "loss_f32_same_weights": loss32,
            "first_loss_rel_err": rel, "loss_rtol": BF16_LOSS_RTOL,
            "grad_rtol": BF16_GRAD_RTOL, "gates": gate,
            "param_dtypes_after": dtypes, "launches": counts,
            "peak_mem_gb": peak / 1e9, "profile": prof}, counts


def phase_symbolic_bf16(torch, dev, seed, out_dir):
    """Full-width ResNet-50 through Module.fit(kvstore='tpu_sync',
    multi_precision=True) (module docstring, phase 21). Returns (result,
    kind -> (launches, leaves) of #7 on the path)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.parallel import DataParallelTrainStep
    t0 = time.perf_counter()
    with mx.name.NameManager():
        sym = tres.get_symbol(num_classes=1000, num_layers=50,
                              image_shape="3,224,224")
    n_leaves = len(sym.list_arguments()) - 2
    rng = np.random.RandomState(seed)
    data = rng.uniform(-1, 1, (4 * SYM_BATCH, 3, 224, 224)).astype(
        np.float32)
    label = rng.randint(0, 1000, (4 * SYM_BATCH,)).astype(np.float32)
    rows = np.arange(FIT_STEPS * SYM_BATCH) % (4 * SYM_BATCH)
    train = mx.io.NDArrayIter(data[rows], label[rows], SYM_BATCH)
    setup_s = time.perf_counter() - t0
    stamps, quarters = [], []

    def on_batch(p):
        if p.nbatch in (FIT_STEPS // 2 - 1, FIT_STEPS - 1):
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if p.nbatch % (FIT_STEPS // 4) == FIT_STEPS // 4 - 1:
            quarters.append(float(p.eval_metric.get()[1]))
            p.eval_metric.reset()

    mx.random.seed(seed)
    mod = mx.mod.Module(sym, context=dev)
    torch.cuda.synchronize()
    _reset_opt_counts(tou)
    t1 = time.perf_counter()
    with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
        mod.fit(train, eval_metric="crossentropy", kvstore="tpu_sync",
                optimizer="sgd",
                optimizer_params={**FIT_OPT, "multi_precision": True},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           magnitude=2),
                batch_end_callback=on_batch, num_epoch=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    counts = (_opt_counts(tou), _opt_leaves(tou))
    want = ({"sgd": 0, "sgd_mom": FIT_STEPS, "adam": 0},
            {"sgd": 0, "sgd_mom": n_leaves * FIT_STEPS, "adam": 0})
    fused = mod._fused_step
    if fused is None or fused.compute_dtype != torch.bfloat16:
        fail("symbolic_bf16: the fused step is %s" % (
            None if fused is None else fused.compute_dtype))
    if counts != want:
        fail("symbolic_bf16: kernel #7 (launches, leaves) %s, want %s"
             % (counts, want))
    bad = [n for n, t in list(fused.params.items()) + list(fused.aux.items())
           if t.dtype != torch.float32]
    if bad:
        fail("symbolic_bf16: masters or aux not float32: %s" % bad[:5])
    if len(quarters) != 4 or not all(math.isfinite(q) for q in quarters):
        fail("symbolic_bf16: cross-entropy by quarter %s" % quarters)
    if not quarters[-1] < quarters[0]:
        fail("symbolic_bf16: the loss did not fall: %s" % quarters)
    half = FIT_STEPS // 2
    walls = [b - a for a, b in zip(stamps[half:], stamps[half + 1:])]
    result = {"phase": "symbolic_bf16", "model": "resnet50",
              "batch": [SYM_BATCH, 3, 224, 224], "steps": FIT_STEPS,
              "setup_s": setup_s, "fit_s": fit_s,
              "img_per_s_second_half": SYM_BATCH * (FIT_STEPS - half)
              / (stamps[-1] - stamps[half - 1]),
              "step_wall_ms_p50": statistics.median(walls) * 1e3,
              "cross_entropy_by_quarter": quarters,
              "launches_per_step": counts[0]["sgd_mom"] / FIT_STEPS,
              "leaves_per_step": counts[1]["sgd_mom"] / FIT_STEPS}

    # from fresh copies of the fitted params and one batch: the bf16 step's
    # activations, its first cross-entropy and its first update of the
    # masters against the float32 step's, and two controls: the bf16 step
    # on labels rounded to bf16 (what the step must never do), and on
    # masters rounded to float8 e4m3; then the bf16 step alone under the
    # profiler
    arg, aux = mod.get_params()
    masters = {n: getattr(v, "_data", v).to(dev).float()
               for n, v in arg.items()}
    lab0 = torch.from_numpy(label[:SYM_BATCH]).to(dev)
    staged = {"data": torch.from_numpy(data[:SYM_BATCH]).to(dev),
              "softmax_label": lab0}
    ces, deltas, steps = {}, {}, {}
    for name, cdt, lab, start in (
            ("f32", None, lab0, masters),
            ("bf16", "bfloat16", lab0, masters),
            ("labels_bf16", "bfloat16", lab0.to(torch.bfloat16).float(),
             masters),
            ("masters_f8", "bfloat16", lab0, {
                n: v.to(torch.float8_e4m3fn).float()
                for n, v in masters.items()})):
        st = DataParallelTrainStep(
            sym, lr=0.05, momentum=0.9, wd=1e-4,
            rescale_grad=1.0 / SYM_BATCH, fused_optupdate=True,
            compute_dtype=cdt, device=dev).init_from(start, aux,
                                                     RESNET_SHAPES)
        with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
            prob = st({**staged, "softmax_label": lab})[0]
        want_dt = torch.bfloat16 if cdt else torch.float32
        if prob.dtype != want_dt:
            fail("symbolic_bf16: %s step's output is %s" % (name,
                                                            prob.dtype))
        ces[name] = _cross_entropy(torch, prob.float(), lab0).item()
        deltas[name] = [st.params[n].detach() - start[n]
                        for n in st.param_names]
        if name in ("f32", "bf16"):
            steps[name] = st
    fc = [i for i, n in enumerate(steps["f32"].param_names)
          if n.startswith("fc1_")]
    gate = {name: {"ce_rel_err": abs(ces[name] - ces["f32"]) / ces["f32"],
                   "update_rel_err": _rel_l2([deltas[name][i] for i in fc],
                                             [deltas["f32"][i] for i in fc]),
                   "update_all_rel_err": _rel_l2(deltas[name],
                                                 deltas["f32"])}
            for name in ("bf16", "labels_bf16", "masters_f8")}
    del deltas
    sound = gate["bf16"]
    if not (sound["ce_rel_err"] <= BF16_CE_RTOL
            and sound["update_rel_err"] <= BF16_UPDATE_RTOL):
        fail("symbolic_bf16: bf16 against float32 %s (limits: cross-entropy "
             "%g, update %g)" % (gate, BF16_CE_RTOL, BF16_UPDATE_RTOL))
    if not (gate["masters_f8"]["ce_rel_err"] > BF16_CE_RTOL and
            gate["labels_bf16"]["update_rel_err"] > BF16_UPDATE_RTOL):
        fail("symbolic_bf16: a control passes the gates: %s" % gate)
    result.update({"first_ce": ces, "first_ce_rel_err": sound["ce_rel_err"],
                   "ce_rtol": BF16_CE_RTOL, "update_rtol": BF16_UPDATE_RTOL,
                   "gates": gate})
    for name, st in steps.items():
        result["bare_step_" + name] = profile_calls(
            torch, lambda: st(staged, lr=0.05),
            "symbolic_bf16" if name == "bf16" else "symbolic_f32_same",
            out_dir if name == "bf16" else None, warm=2, n=5, calls=3,
            classify=kind_of)
    return result, {k: (counts[0][k], counts[1][k]) for k in OPT_KERNELS}

# The long bf16 model's first loss and gradients against the float32
# model's from the same weights, at 2 layers (full width, 4 x 4096 tokens;
# the controls' plain attention keeps every tile's scores for autograd).
# Set from readings of seeds 0 to 2 on the card beside the controls of
# _control_attention, which must fail the gradients' gate in every run
# (PERF.md, section 6).
#: the first loss (relative): sound runs read at most 7.1e-6; the controls
#: read 1.2e-5 to 9.3e-5, too close to gate on, as at 512 tokens
BF16_LONG_LOSS_RTOL = 3e-5
#: the worst leaf's first gradient, ||g_bf16 - g_f32|| / ||g_f32||: sound
#: runs read at most 0.0080, the controls at least 0.164 (one 64-key tile
#: of 4096 dropped from each row moves less than at 512 tokens)
BF16_LONG_GRAD_RTOL = 0.04
#: layers of the long gate's models
BF16_LONG_GATE_LAYERS = 2


def phase_serve_long_bf16(torch, fa, dev, seed):
    """The long-context configuration served in bf16 (module docstring,
    phase 23). Returns (result, launches of #3's bf16 passes)."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerDecodeModel)
    cfg = long_config(TransformerConfig, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = TransformerDecodeModel(cfg, seed=seed, device=dev)
    if not model.use_kernel:
        fail("serve_long_bf16: model on %s did not resolve to the kernel "
             "tier" % dev)
    setup_s = time.perf_counter() - t0
    counters = [BF16_GRID_COUNTERS[k] for k in ("offs", "offs_combine")]
    served, counts, _, eng_s = serve_long_prompts(
        model, cfg, seed, counters, _attention_counters(counters),
        "serve_long_bf16")
    del model
    return {"phase": "serve_long_bf16", "setup_s": setup_s + eng_s,
            **served}, counts


def phase_train_long_bf16(torch, fa, dev, seed, out_dir):
    """The long-context configuration trained in bf16 (module docstring,
    phase 24). Returns (result, launches per bf16 grid kernel and pass)."""
    import mxnet_tpu_torch.models.transformer as tm
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_loss)
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves, tree_map
    B, S = 4, LONG_S
    t0 = time.perf_counter()
    make_batch = periodic_batches(seed, 32000, S, B)
    batches = [{k: torch.as_tensor(x).to(dev) for k, x in make_batch().items()}
               for _ in range(LONG_STEPS)]

    # the gate: first loss and gradients at 2 layers against the float32
    # model from the same bf16 weights, then under the two controls
    nl = BF16_LONG_GATE_LAYERS
    cfg_g = long_config(TransformerConfig, nl, dtype=torch.bfloat16)
    params_g = init_transformer(cfg_g, torch.Generator().manual_seed(seed),
                                dev)
    cfg32 = long_config(TransformerConfig, nl)
    params32 = tree_map(lambda x: x.float(), params_g)

    def loss_fn_of(c):
        return lambda p, b: transformer_loss(p, b["tokens"], b["targets"], c)

    loss32, g32 = _first_grads(torch, loss_fn_of(cfg32), params32,
                               batches[0])
    del params32
    names = _leaf_names(params_g)

    def readings(loss, grads):
        errs = [_rel_l2([g], [w]) for g, w in zip(grads, g32)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        return {"loss_rel_err": abs(loss - loss32) / abs(loss32),
                "grad_rel_err": errs[worst], "grad_worst_leaf": names[worst]}

    gate_counters = [BF16_GRID_COUNTERS[k] for k in ("fwd", "dq", "dkv")]
    for name in gate_counters:
        setattr(fa, name, 0)
    gate = {"sound": readings(*_first_grads(torch, loss_fn_of(cfg_g),
                                            params_g, batches[0]))}
    if any(getattr(fa, n) != nl for n in gate_counters):
        fail("train_long_bf16: the gate's bf16 step launched %s, want %d "
             "each" % ({n: getattr(fa, n) for n in gate_counters}, nl))
    for fault in ("diagonal", "rescale"):
        with mock.patch.object(tm, "_attention",
                               _control_attention(torch, fault)):
            gate[fault] = readings(*_first_grads(
                torch, loss_fn_of(cfg_g), params_g, batches[0]))
    del g32, params_g
    torch.cuda.empty_cache()
    if not (gate["sound"]["loss_rel_err"] <= BF16_LONG_LOSS_RTOL and
            gate["sound"]["grad_rel_err"] <= BF16_LONG_GRAD_RTOL):
        fail("train_long_bf16: first bf16 loss and gradients %s against "
             "float32's (limits %g, %g)" % (gate["sound"],
                                            BF16_LONG_LOSS_RTOL,
                                            BF16_LONG_GRAD_RTOL))
    if not min(gate[f]["grad_rel_err"] for f in ("diagonal", "rescale")) \
            > BF16_LONG_GRAD_RTOL:
        fail("train_long_bf16: a control passes the gradient gate: %s"
             % gate)

    # the path: 12 layers, 10 steps through the bf16 grid kernels
    cfg = long_config(TransformerConfig, dtype=torch.bfloat16)
    params = init_transformer(cfg, torch.Generator().manual_seed(seed), dev)
    step = ShardedTrainStep(loss_fn_of(cfg), optimizer="adam", lr=1e-3,
                            grad_clip=1.0, device=dev).init(params)
    setup_s = time.perf_counter() - t0
    counters = [BF16_GRID_COUNTERS[k] for k in GRID_KERNELS
                if k not in ("offs", "offs_combine")]
    others = _attention_counters(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for name in tuple(counters) + others:
        setattr(fa, name, 0)
    losses, walls = [], []
    t0 = time.perf_counter()
    for b in batches:
        ts = time.perf_counter()
        losses.append(step(b).item())      # .item() synchronizes
        walls.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    counts = {name: getattr(fa, name) for name in counters}
    other_counts = {name: getattr(fa, name) for name in others}
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        fail("train_long_bf16: non-finite loss in %s" % losses)
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail("train_long_bf16: loss did not fall: %s" % losses)
    want = cfg.num_layers * LONG_STEPS
    for name in counters:
        if counts[name] != want:
            fail("train_long_bf16: %s = %d, want %d (12 per step)"
                 % (name, counts[name], want))
    if any(other_counts.values()):
        fail("train_long_bf16: other attention kernels launched: %s"
             % other_counts)
    dtypes = sorted({str(t.dtype) for t in tree_leaves(step.params)})
    if dtypes != ["torch.float32"]:
        fail("train_long_bf16: masters are %s, want float32" % dtypes)
    step_ms = statistics.median(walls[1:]) * 1e3
    prof = profile_calls(torch, lambda: step(batches[0]).item(),
                         "train_long_bf16", out_dir, warm=1, n=2, calls=1,
                         classify=kind_of_attention)
    del step
    torch.cuda.empty_cache()
    return {"phase": "train_long_bf16", "setup_s": setup_s,
            "steps": LONG_STEPS, "batch": [B, S], "wall_s": wall,
            "first_step_ms": walls[0] * 1e3, "step_ms_p50": step_ms,
            "tokens_per_s": B * S / step_ms * 1e3, "losses": losses,
            "gate_layers": nl, "loss_f32_same_weights": loss32,
            "loss_rtol": BF16_LONG_LOSS_RTOL,
            "grad_rtol": BF16_LONG_GRAD_RTOL, "gates": gate,
            "param_dtypes_after": dtypes, "launches": counts,
            "other_launches": other_counts, "peak_mem_gb": peak / 1e9,
            "profile": prof}, counts


def phase_bf16_kernel(torch, fa, dev):
    """#1, #5 and #2 in bf16 against their plain bf16 versions on the card
    (module docstring, phase 22). Returns (worst ulps per kernel, rows of
    times by kernel)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels.bf16_gate import BF16_ULPS, row_ulps
    gen = torch.Generator().manual_seed(SEED + 7)
    bf = torch.bfloat16
    worst = {"offs": 0.0, "fwd": 0.0, "dq": 0.0, "dkv": 0.0,
             **{"grid_" + key: 0.0 for key in GRID_KERNELS}}
    lse_worst = 0.0

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev, bf)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    def check(kind, what, got, ref):
        if got.dtype != ref.dtype:
            fail("bf16_kernel %s: %s is %s, the plain version's %s"
                 % (what, kind, got.dtype, ref.dtype))
        u = row_ulps(got, ref)
        if not u <= BF16_ULPS:
            fail("bf16_kernel %s: %s %.2f bf16 ulps > %g" % (what, kind, u,
                                                             BF16_ULPS))
        if u >= worst[kind]:
            worst[kind], worst[kind + "_at"] = u, what

    def check_lse(what, lse, ref):
        nonlocal lse_worst
        live = ref > NEG / 2
        if not bool((lse[~live] == NEG).all().item()):
            fail("bf16_kernel %s: dead rows' lse not -1e30" % what)
        err = scaled_err(lse[live], ref[live]) if bool(live.any()) else 0.0
        if not err <= TOL:
            fail("bf16_kernel %s: lse err %g > %g" % (what, err, TOL))
        lse_worst = max(lse_worst, err)

    def same(what, a, b):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail("bf16_kernel %s: two calls on the same inputs differ"
                 % what)

    # #1 at the serving shapes, rows that see no key included
    SK = 512
    for D in (32, 64, 128):
        sm = 1.0 / math.sqrt(D)
        for C, (q0, k0) in ((64, (0, 0)), (256, (0, 0)), (256, (256, 0)),
                            (64, (448, 0)), (64, (0, 256))):
            what = "#1 D=%d C=%d offs=%s" % (D, C, (q0, k0))
            q, k, v = rand(1, 8, C, D), rand(1, 8, SK, D), rand(1, 8, SK, D)
            offs = torch.tensor([q0, k0], dtype=torch.int32, device=dev)
            out, lse = fa._flash_fwd_offs_cuda(q, k, v, offs, sm, True)
            ref = fa.flash_fwd_offs_plain(q, k, v, offs, sm, True)
            check("offs", what, out, ref[0])
            check_lse(what, lse, ref[1])
            dead = ref[1] == NEG
            if not bool((out[dead] == 0).all().item()):
                fail("bf16_kernel %s: dead rows' out not 0" % what)
            same(what, fa._flash_fwd_offs_cuda(q, k, v, offs, sm, True),
                 (out, lse))
            # #2 through flash_attention_with_lse, lse cotangent included,
            # against the plain backward on the inputs #2 got: the forward
            # kernel's out and lse
            do, dlse = rand(1, 8, C, D), rand(1, 8, C).float()
            ts = leaves(q, k, v)
            o, l = fa.flash_attention_with_lse(*ts, offs, sm, True)
            torch.autograd.backward((o, l), (do, dlse))
            want = fa.flash_bwd_offs_plain(q, k, v, offs, do, dlse,
                                           o.detach(), l.detach(), sm, True)
            check("dq", what + " dq", ts[0].grad, want[0])
            check("dkv", what + " dk", ts[1].grad, want[1])
            check("dkv", what + " dv", ts[2].grad, want[2])

    # #5 and #2 at the training shape, other head dims, a non-causal
    # ragged case and bench.py's flash shape
    for (b, h, s, d), causal in (((8, 8, 512, 64), True),
                                 ((8, 8, 512, 32), True),
                                 ((8, 8, 512, 128), True),
                                 ((2, 8, 200, 64), False),
                                 ((4, 8, 4096, 128), True)):
        what = "#5/#2 %s causal=%s" % ((b, h, s, d), causal)
        sm = 1.0 / math.sqrt(d)
        q, k, v, do = (rand(b, h, s, d) for _ in range(4))
        out, lse = fa._flash_fwd_cuda(q, k, v, sm, causal)
        ref = fa.flash_fwd_plain(q, k, v, sm, causal)
        check("fwd", what + " out", out, ref[0])
        check_lse(what, lse, ref[1])
        same(what + " fwd", fa._flash_fwd_cuda(q, k, v, sm, causal),
             (out, lse))
        ts = leaves(q, k, v)
        fa.flash_attention(*ts, causal=causal, sm_scale=sm,
                           use_pallas=True).backward(do)
        # the plain backward on the inputs #2 got: #5's out and lse
        want = fa.flash_bwd_offs_plain(q, k, v, fa._offs0(dev), do, None,
                                       out, lse, sm, causal)
        check("dq", what + " dq", ts[0].grad, want[0])
        check("dkv", what + " dk", ts[1].grad, want[1])
        check("dkv", what + " dv", ts[2].grad, want[2])
        again = leaves(q, k, v)
        fa.flash_attention(*again, causal=causal, sm_scale=sm,
                           use_pallas=True).backward(do)
        same(what + " bwd", [t.grad for t in again], [t.grad for t in ts])
        del q, k, v, do, out, lse, ref, ts, want, again
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # device times (CUDA graphs) at the path shapes and bench.py's flash
    # shape, against the plain versions and SDPA in bf16
    rows = {}
    C, q0, D = 256, 256, 64
    sm = 1.0 / math.sqrt(D)
    q, k, v = rand(1, 8, C, D), rand(1, 8, SK, D), rand(1, 8, SK, D)
    offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
    mask = (torch.arange(C, device=dev)[:, None] + q0
            >= torch.arange(SK, device=dev)[None, :])
    flops = 4.0 * 8 * sum(visible_keys(C, SK, q0, 0)) * D
    nbytes = 2.0 * (2 * q.numel() + 2 * k.numel()) + 4.0 * 8 * C + 8
    ms = time_ms(lambda: fa._flash_fwd_offs_cuda(q, k, v, offs, sm, True))
    rows["offs"] = {
        "shape": "q (1,8,256,64) k/v (1,8,512,64) bf16 offs [256,0]",
        "ms": ms, "plain_ms": time_ms(lambda: fa.flash_fwd_offs_plain(
            q, k, v, offs, sm, True)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm)),
        "flops": flops, "bytes": nbytes, "tflops": tflops(flops, ms),
        **bf16_bounds(flops, nbytes)}
    for key, (B, H, S, D) in (("train", (8, 8, 512, 64)),
                              ("bench", (4, 8, 4096, 128))):
        sm = 1.0 / math.sqrt(D)
        q, k, v, do = (rand(B, H, S, D) for _ in range(4))
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
        iters = 20 if key == "train" else 5
        t = {"fwd_ms": time_ms(lambda: fa._flash_fwd_cuda(q, k, v, sm, True),
                               iters=iters),
             "dq_ms": time_ms(lambda: fa._launch(
                 "mx_flash_bwd_dq_bf16", *common, dq.data_ptr(), *tail,
                 device=dev), iters=iters),
             "dkv_ms": time_ms(lambda: fa._launch(
                 "mx_flash_bwd_dkv_bf16", *common, dk.data_ptr(),
                 dv.data_ptr(), *tail, device=dev), iters=iters),
             "sdpa_fwd_ms": time_ms(lambda: sdpa(q, k, v), iters=iters),
             "sdpa_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                 sdpa(qg, kg, vg), (qg, kg, vg), do), iters=iters)}
        t["sdpa_bwd_ms"] = t["sdpa_fwd_bwd_ms"] - t["sdpa_fwd_ms"]
        if key == "train":
            t["fwd_plain_ms"] = time_ms(lambda: fa.flash_fwd_plain(
                q, k, v, sm, True))
            t["bwd_plain_ms"] = time_ms(lambda: fa.flash_bwd_offs_plain(
                q, k, v, offs0, do, None, out, lse, sm, True))
        vis = B * H * S * (S + 1) // 2
        n, nrows = q.numel(), B * H * S
        for name, fl, nb in (
                ("fwd", 4.0 * vis * D, 2.0 * 4 * n + 4.0 * nrows),
                ("dq", 6.0 * vis * D, 2.0 * 5 * n + 8.0 * nrows + 8),
                ("dkv", 8.0 * vis * D, 2.0 * 6 * n + 8.0 * nrows + 8)):
            t[name + "_flops"], t[name + "_bytes"] = fl, nb
            t[name + "_tflops"] = tflops(fl, t[name + "_ms"])
            for k_, v_ in bf16_bounds(fl, nb).items():
                t[name + "_" + k_] = v_
        t["fwd_vs_sdpa"] = t["fwd_ms"] / t["sdpa_fwd_ms"]
        t["bwd_vs_sdpa"] = (t["dq_ms"] + t["dkv_ms"]) / t["sdpa_bwd_ms"]
        rows[key] = t
        del q, k, v, do, out, lse, deff, dq, dk, dv, qg, kg, vg
        torch.cuda.empty_cache()
    rows["grid"] = bf16_grid_rows(torch, fa, dev, rand, leaves, check,
                                  check_lse, same)
    return worst, lse_worst, rows


def bf16_grid_rows(torch, fa, dev, rand, leaves, check, check_lse, same):
    """The grid kernels #6, #4 and #3 on bf16 inputs (module docstring,
    phase 22): each against its plain bf16 version, then timed. ``check``
    (kind, what, got, ref) holds a bf16 output to BF16_ULPS row ulps,
    ``check_lse`` an lse to TOL, ``same`` two calls to the same bits.
    Returns the timing row."""
    import torch.nn.functional as F
    sdpa = lambda a, b_, c, sm: F.scaled_dot_product_attention(  # noqa
        a, b_, c, is_causal=True, scale=sm)

    # #6 and #4 through flash_attention(variant="grid"): the long training
    # shape (8 splits), bench.py's flash shape with its (512, 512) blocks,
    # ragged splits at D 32 and a non-causal case; #4 against the plain
    # backward on the inputs it got (the kernels' own out and lse)
    for (b, h, s, d), causal, w in (((4, 8, LONG_S, 64), True, LONG_W),
                                    ((4, 8, LONG_S, 128), True, LONG_W),
                                    ((1, 4, 300, 32), True, 64),
                                    ((2, 8, 1000, 64), False, 256)):
        what = "#6/#4 %s causal=%s block=%d" % ((b, h, s, d), causal, w)
        sm = 1.0 / math.sqrt(d)
        q, k, v, do = (rand(b, h, s, d) for _ in range(4))
        out, lse = fa._flash_fwd_grid_cuda(q, k, v, None, sm, causal,
                                           fa.split_width(w, s))
        ref = fa.flash_fwd_grid_plain(q, k, v, sm, causal, w)
        check("grid_fwd", what + " out", out, ref[0])
        check_lse(what, lse, ref[1])
        same(what + " fwd", fa._flash_fwd_grid_cuda(
            q, k, v, None, sm, causal, fa.split_width(w, s)), (out, lse))
        runs = []
        for _ in range(2):
            ts = leaves(q, k, v)
            fa.flash_attention(*ts, causal=causal, sm_scale=sm, block_q=w,
                               block_k=w, use_pallas=True,
                               variant="grid").backward(do)
            runs.append([t.grad for t in ts])
        same(what + " bwd", *runs)
        want = fa.flash_bwd_offs_grid_plain(q, k, v, fa._offs0(dev), do,
                                            None, out, lse, sm, causal, w, w)
        check("grid_dq", what + " dq", runs[0][0], want[0])
        check("grid_dkv", what + " dk", runs[0][1], want[1])
        check("grid_dkv", what + " dv", runs[0][2], want[2])
        del q, k, v, do, out, lse, ref, runs, want
        torch.cuda.empty_cache()

    # #3 (and #4 with an lse cotangent) through flash_attention_with_lse:
    # the last chunk of a 3800-token prompt, a chunk whose rows see no key
    # (every split dead), and one split per 32-key tile with most dead
    D, SK = 64, LONG_S
    sm = 1.0 / math.sqrt(D)
    for C, (q0, k0), bk in ((1024, (2816, 0), LONG_W),
                            (256, (0, 2048), LONG_W), (256, (768, 0), 32)):
        what = "#3 C=%d offs=%s block_k=%d" % (C, (q0, k0), bk)
        bq = min(LONG_W, C)
        q, k, v = rand(1, 8, C, D), rand(1, 8, SK, D), rand(1, 8, SK, D)
        do, dlse = rand(1, 8, C, D), rand(1, 8, C).float()
        offs = torch.tensor([q0, k0], dtype=torch.int32, device=dev)
        runs = []
        for _ in range(2):
            ts = leaves(q, k, v)
            o, l = fa.flash_attention_with_lse(*ts, offs, sm, True, bq, bk,
                                               variant="grid")
            torch.autograd.backward((o, l), (do, dlse))
            runs.append([o.detach(), l.detach()] + [t.grad for t in ts])
        same(what, *runs)
        out, lse = runs[0][:2]
        ref = fa.flash_fwd_offs_grid_plain(q, k, v, offs, sm, True, bk)
        check("grid_offs", what + " out", out, ref[0])
        check_lse(what, lse, ref[1])
        dead = ref[1] == NEG
        if not bool((out[dead] == 0).all().item()):
            fail("bf16_kernel %s: dead rows' out not 0" % what)
        want = fa.flash_bwd_offs_grid_plain(q, k, v, offs, do, dlse, out,
                                            lse, sm, True, bq, bk)
        check("grid_dq", what + " dq", runs[0][2], want[0])
        check("grid_dkv", what + " dk", runs[0][3], want[1])
        check("grid_dkv", what + " dv", runs[0][4], want[2])
        del q, k, v, do, runs, want, ref
    torch.cuda.empty_cache()

    # each pass alone at the long shapes, timed
    t = grid_pass_times(
        torch, fa, dev, rand, leaves, torch.bfloat16,
        lambda kind, what, got, ref: check("grid_" + kind, what, got, ref),
        lambda kind, what, lse, ref: check_lse(what, lse, ref))

    # bench.py's flash shape (4, 8, 4096, 128) with its (512, 512) blocks:
    # each family whole (pass 1 and its combine or reduce) against SDPA
    B, H, S, D = 4, 8, LONG_S, 128
    sm = 1.0 / math.sqrt(D)
    q, k, v, do = (rand(B, H, S, D) for _ in range(4))
    offs0 = fa._offs0(dev)
    out, lse = fa._flash_fwd_grid_cuda(q, k, v, None, sm, True, LONG_W)
    deff = fa._deff(do, out, None).contiguous()
    bench = {
        "fwd_ms": time_ms(lambda: fa._flash_fwd_grid_cuda(
            q, k, v, None, sm, True, LONG_W), iters=5),
        "bwd_ms": time_ms(lambda: fa._flash_bwd_grid_cuda(
            q, k, v, offs0, do, deff, lse, sm, True, (LONG_W, LONG_W)),
            iters=5),
        "sdpa_fwd_ms": time_ms(lambda: sdpa(q, k, v, sm), iters=5)}
    qg, kg, vg = leaves(q, k, v)
    bench["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        sdpa(qg, kg, vg, sm), (qg, kg, vg), do), iters=5) \
        - bench["sdpa_fwd_ms"]
    bb = grid_bounds(B, H, S, S, D, 0, LONG_W, LONG_W, es=2.0)
    for key, parts in (("fwd", ("fwd", "fwd_combine")),
                       ("bwd", ("dq", "dq_reduce", "dkv", "dkv_reduce"))):
        flops = sum(bb[p_][0] for p_ in parts)
        nbytes = sum(bb[p_][1] for p_ in parts)
        for k_, v_ in bf16_bounds(flops, nbytes).items():
            bench[key + "_" + k_] = v_
        bench[key + "_tflops"] = tflops(flops, bench[key + "_ms"])
        bench[key + "_vs_sdpa"] = bench[key + "_ms"] / bench[
            "sdpa_%s_ms" % key]
    t["bench"] = bench
    del q, k, v, do, out, lse, deff, qg, kg, vg
    torch.cuda.empty_cache()
    return t


PHASES = ("kernel", "serve", "profile", "train_kernel", "train",
          "train_profile", "opt_kernel", "symbolic_train", "symbolic_profile",
          "grid_kernel", "serve_long", "train_long", "rtc_kernel",
          "rtc_infer", "module_fit", "example_scripts", "serve_bf16",
          "train_bf16", "symbolic_bf16", "bf16_kernel", "serve_long_bf16",
          "train_long_bf16")
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
    # per library: kernel -> [registers, spill stores, spill loads]
    ptxas = {k: ptxas_kernels(v["ptxas"])
             for k, v in _build.build_info.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(paths), "ptxas": ptxas})

    entries = []
    opt_paths = {}
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
    # kernel #7's launches on the Module paths join its entries
    if "module_fit" in phases:
        fit_result, opt_paths["module_fit"] = phase_module_fit(
            torch, dev, args.seed, args.profile_dir)
        emit({**fit_result, "card": card})
        torch.cuda.empty_cache()
    if "example_scripts" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            scripts, opt_paths["example_scripts"] = phase_example_scripts(
                torch, dev, tmp)
        emit({**scripts, "card": card})
    bf16_launches = {}
    if "serve_bf16" in phases:
        sb, bf16_launches["launches_bf16"] = phase_serve_bf16(torch, fa, dev)
        emit({**sb, "card": card})
        torch.cuda.empty_cache()
    if "train_bf16" in phases:
        tb, counts = phase_train_bf16(torch, fa, dev, args.seed,
                                      args.profile_dir)
        emit({**tb, "card": card})
        bf16_launches.update((k, v) for k, v in counts.items()
                             if k != "launches_bf16")
        torch.cuda.empty_cache()
    if "symbolic_bf16" in phases:
        symb, opt_paths["symbolic_bf16"] = phase_symbolic_bf16(
            torch, dev, args.seed, args.profile_dir)
        emit({**symb, "card": card})
        torch.cuda.empty_cache()
    if "serve_long_bf16" in phases:
        slb, counts = phase_serve_long_bf16(torch, fa, dev, args.seed)
        emit({**slb, "card": card})
        bf16_launches.update(counts)
        torch.cuda.empty_cache()
    if "train_long_bf16" in phases:
        tlb, counts = phase_train_long_bf16(torch, fa, dev, args.seed,
                                            args.profile_dir)
        emit({**tlb, "card": card})
        bf16_launches.update(counts)
        torch.cuda.empty_cache()
    for entry in entries:
        opt_kind = OPT_BY_ENTRY.get(entry["name"])
        if opt_kind is None:
            continue
        for path, counts in opt_paths.items():
            entry["launches"] += counts[opt_kind][0]
            entry["leaves"] += counts[opt_kind][1]
            entry.setdefault("launches_by_path", {})[path] = \
                counts[opt_kind][0]
    if "bf16_kernel" in phases:
        from mxnet_tpu_torch.kernels.bf16_gate import BF16_ULPS
        bk_worst, bk_lse, bk = phase_bf16_kernel(torch, fa, dev)
        emit({"phase": "bf16_kernel", "max_row_ulps": bk_worst,
              "ulps_tol": BF16_ULPS, "lse_max_err": bk_lse, "lse_tol": TOL,
              **bk, "card": card})
        torch.cuda.empty_cache()
        hgmma = hgmma_counts(paths)
        emit({"phase": "hgmma", "card": card,
              # per library: each kernel's HGMMA instructions in SASS
              "counts": hgmma})

        def body_ptxas(lib, kernel, d=64):
            """The registers and spill bytes of the body instantiation an
            entry runs at its path's head dim."""
            args = {"flash_fwd_bf16_kernel": "%d,%d" % (
                d, lib in ("flash_fwd_offs", "flash_fwd_offs_grid"))}.get(
                    kernel, "%d" % d)
            regs, st, ld = ptxas.get(lib, {}).get(
                "%s<%s>" % (kernel, args), (None, None, None))
            return {"registers": regs, "spill_bytes": [st, ld]}

        def shares(row, pair=None, of=None):
            """Bound share and the time over the library call's. SDPA's
            backward computes dq, dk and dv together, so dq and dk/dv are
            held to it by ``pair``, the summed ms of what ``of`` names."""
            ms = row["ms"] if pair is None else pair
            out = {"bound_share": row["bound_ms"] / row["ms"],
                   "vs_library": (ms / row["library_ms"]
                                  if row.get("library_ms") else None)}
            if of:
                out["vs_library_of"] = of
            return out
        train_row = bk["train"]
        bwd_pair = {"pair": train_row["dq_ms"] + train_row["dkv_ms"],
                    "of": "dq + dk/dv"}
        for name, file, line, counter, key in (
                ("flash_fwd_offs_bf16", "flash_fwd_offs.cu", "285",
                 "launches_bf16", "offs"),
                ("flash_fwd_bf16", "flash_fwd.cu", "205",
                 "launches_fwd_bf16", "fwd"),
                ("flash_bwd_dq_bf16", "flash_bwd_offs.cu", "402",
                 "launches_bwd_dq_bf16", "dq"),
                ("flash_bwd_dkv_bf16", "flash_bwd_offs.cu", "453",
                 "launches_bwd_dkv_bf16", "dkv")):
            if counter not in bf16_launches:
                continue   # its path's phase did not run
            if key == "offs":
                row = bk["offs"]
                times = {"ms": row["ms"], "plain_ms": row["plain_ms"],
                         "bound_ms": row["bound_ms"],
                         "bound_by": row["bound_by"],
                         "library_ms": row["library_ms"],
                         "tflops": row["tflops"], "shape": row["shape"]}
            else:
                plain = "fwd_plain_ms" if key == "fwd" else "bwd_plain_ms"
                lib = "sdpa_fwd_ms" if key == "fwd" else "sdpa_bwd_ms"
                times = {"ms": train_row[key + "_ms"],
                         "plain_ms": train_row[plain],
                         "bound_ms": train_row[key + "_bound_ms"],
                         "bound_by": train_row[key + "_bound_by"],
                         "library_ms": train_row[lib],
                         "tflops": train_row[key + "_tflops"],
                         "shape": "q/k/v (8,8,512,64) bf16 causal"}
            kernel = {"offs": "flash_fwd_bf16_kernel",
                      "fwd": "flash_fwd_bf16_kernel",
                      "dq": "flash_bwd_dq_bf16_kernel",
                      "dkv": "flash_bwd_dkv_bf16_kernel"}[key]
            entries.append({
                "name": name, "route": "cuda", "source": src + file,
                "replaces": ref + line, "launches": bf16_launches[counter],
                "max_abs_err": bk_worst[key], "err_unit": "bf16 row ulps",
                **times,
                **shares(times, **(bwd_pair if key in ("dq", "dkv")
                                   else {})),
                **body_ptxas(file[:-3], kernel)})
        grid = bk["grid"]
        grid_pair = {"pair": sum(grid[k + "_ms"] for k in (
            "dq", "dq_reduce", "dkv", "dkv_reduce")),
                     "of": "dq + dk/dv with their reduce passes"}
        for key, (entry, _, file, line) in GRID_KERNELS.items():
            counter = BF16_GRID_COUNTERS[key]
            if counter not in bf16_launches:
                continue   # its path's phase did not run
            lib = {"fwd": "sdpa_fwd_ms", "dq": "sdpa_bwd_ms",
                   "dkv": "sdpa_bwd_ms", "offs": "sdpa_offs_ms"}.get(key)
            plain = {"dkv": "bwd_plain_ms", "dq": "bwd_plain_ms"}.get(
                key, key + "_plain_ms")
            row = {"ms": grid[key + "_ms"],
                   "bound_ms": grid[key + "_bound_ms"],
                   "library_ms": grid[lib] if lib else None}
            kernel = {"fwd": "flash_fwd_bf16_kernel",
                      "offs": "flash_fwd_bf16_kernel",
                      "dq": "flash_bwd_dq_bf16_kernel",
                      "dkv": "flash_bwd_dkv_bf16_kernel"}.get(key)
            entries.append({
                "name": entry[3:-3] + "bf16", "route": "cuda",
                "source": src + file, "replaces": ref + line,
                "launches": bf16_launches[counter],
                "max_abs_err": bk_worst["grid_" + key],
                "err_unit": "bf16 row ulps", **row,
                "plain_ms": grid[plain],
                "bound_by": grid[key + "_bound_by"],
                "tflops": grid[key + "_tflops"],
                **shares(row, **(grid_pair if key in ("dq", "dkv")
                                 else {})),
                **(body_ptxas(file[:-3], kernel) if kernel else
                   {"registers": None, "spill_bytes": None}),
                "shape": ("q (1,8,1024,64) k/v (1,8,4096,64) bf16 offs "
                          "[2816,0], 8 key splits" if key.startswith("offs")
                          else "q/k/v (4,8,4096,64) bf16 causal, 8 splits")})
    if args.parent:
        emit({**phase_parent(torch, fa, dev, args.parent), "card": card})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
