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
             0.01}, wd 1e-4, rescale 1/32), one launch an update, and
             with the step's verdict true and false (the pointer beside
             lr; false writes nothing). Bitwise equal (NaN in the same
             places, every other value the same bits). Then, for each kind, two rows of one ResNet-50 update:
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
             #1's bf16 entry (flash_fwd_offs.cu, flash_fwd_half.cuh)
             launched at least 12 times per prefill call and no other
             attention kernel, no KV block left live, every stream equal to
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
             forward casts to bf16: float32 masters from step 2 on (checked
             after the steps). Reports the step wall p50, tokens/s, and one
             step under torch.profiler (device time, idle share;
             DIR/profile_train_bf16.txt).
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
             ``hgmma`` (after this phase or f16_kernel): ``cuobjdump
             -sass`` of every built flash_* library; each 16-bit body
             (flash_fwd_half_kernel, flash_bwd_dq_half_kernel,
             flash_bwd_dkv_half_kernel), in both its bf16 and its float16
             instantiation, must issue Hopper's warpgroup products (HGMMA)
             and every other kernel, the float32 bodies and the passes,
             none. Each 16-bit entry on the kernels line carries its bound
             share, TFLOP/s, its time over SDPA's (``vs_library``) and its
             body's registers and spill bytes.
23. serve_long_bf16 — serve_long's configuration with dtype bfloat16
             (bf16 weights from the same seeded generator, bf16 KV pages)
             through the same DecodeEngine and prompts. Checks: all served,
             #3's bf16 entries (flash_fwd_offs_grid.cu,
             flash_fwd_half.cuh; and the bf16 combine) launched 12 times
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
25. serve_f16 — serve_bf16 with dtype float16 (float16 weights from the
             same seeded generator, float16 KV pages): #1's f16 entry
             launched at least 12 times per prefill call and no other
             attention kernel, every stream equal to its solo decode.
26. train_f16 — train_bf16 with dtype float16 for 10 steps
             (HALF_TRAIN_STEPS; Adam's first step leaves float32 masters,
             as in bf16): #5's and #2's f16 entries 12 times per step each
             and no other attention kernel, the loss falls, float32
             masters after the steps. The gate: a
             float16 gradient at full width is not float32's in either
             package (the cotangent of the float16 logits rounds its
             off-target entries, ~(1/32000)/4096, to 0), so the first loss
             and every leaf's first gradient are held within F16_LOSS_RTOL
             and F16_GRAD_RTOL of the same float16 model through the
             kernels' plain versions (their roundings; ``first_step_gate``)
             from the same weights, on the card, where train_bf16's two
             controls must fail the gradients' gate; the gap to the
             float32 model is printed (``f32_gap``), not gated.
27. f16_kernel — bf16_kernel's rows in float16: all six kernels and their
             passes against their plain float16 versions at the same shapes
             (F16_ULPS float16 ulps of each row's scale,
             kernels/bf16_gate.py), timed against float16 SDPA; the hgmma
             check follows.
28. serve_long_f16 — serve_long_bf16 with dtype float16: #3's f16 entry
             and its combine 12 times per prefill call, no other attention
             kernel, streams equal to their solo decodes.
29. train_long_f16 — train_long_bf16 with dtype float16: #6's and #4's
             f16 entries and passes 12
             times per step, no other attention kernel; the gate at 2
             layers against the plain versions (F16_LONG_LOSS_RTOL,
             F16_LONG_GRAD_RTOL), the controls failing it, the float32 gap
             printed.
30. supervised_fit — module_fit's ResNet-50 (3x224x224, batch 32) through
             Module.fit(kvstore='tpu_sync', supervisor=TrainingSupervisor())
             under MXNET_TPU_FUSED_OPTUPDATE=1 with the device prefetch on
             (DevicePrefetchIter: pinned buffers, a side stream), every fit
             from one set of Xavier values, 4 seeded batches cycled.
             Gates: (a) float32 at loss scale 1.0, 8 steps: after every
             step each param, momentum slot and BatchNorm statistic bit
             for bit the same fit's unsupervised and unprefetched, #7
             launched once a step over 157 leaves (the verdict pointer
             set), 8 verdicts observed, none bad; (b) a train.nan fault
             at dispatch 4: the state after that step bit for bit the
             state after step 3 (the steps before it those of (a)), the
             next step changes it, one bad step, the scale stays 1.0,
             everything finite; (c) 6 staged batches bit for bit the host
             batches, on the card; (d) float16 compute
             (MXNET_FUSED_COMPUTE_DTYPE=float16) for 20 steps from the
             default scale 2^15 with bad_steps_limit=16: every master
             finite, no divergence, the cross-entropy lower in the last
             quarter than in the first (the backoff and regrow counts
             printed). With the default limit of 3 the same fit raises
             NumericDivergence (printed, not gated: MXNet's gradients
             are sums over the batch, and float16 overflows them at
             2^10 and above at this width). Reports img/s and
             the step wall p50 with the prefetch on and off (16 steps
             each, in turns off, on, off, on), the prefetch's hits,
             stalls and staging ms, the batch's host-to-device copy time
             on the compute stream and on other streams (torch.profiler's
             trace, prefetch off and on), the supervised bare step's
             device time and ops against the unsupervised one's
             (profiles DIR/profile_supervised_fit_*.txt), #7's device time
             over the 157 leaves with no, a true and a false verdict, and
             the first float16 master update's relative L2 to the float32
             update at scale 2^15 and 1.0 (not gated).
31. serve_engine — ResNet-50 v2 (3x224x224, rtc_infer's seeded weights)
             served through serving.InferenceEngine with buckets (1, 4,
             8, 16, 32), max_batch 32, max_delay_ms 5 and the batcher's
             worker thread: warmup captures one CUDA graph a bucket (5),
             then a trace of the sizes [1, 2, 4, 8, 16, 32] permuted 20
             times by RandomState(7) (120 requests, 1260 images) goes
             through predict_async at once. Gates: (a) every request's
             rows bit for bit the eager forward of its padded bucket
             (the group the batcher formed, recorded); (b) within rtol
             1e-5 / atol 1e-6 of an executor bound at exactly n; (c) 5
             programs, 0 misses, 5 captures after the trace; (d) a
             result held from the first request unchanged after it.
             cuDNN deterministic throughout. Also Executor.warmup at
             batch 32: its replayed forwards bit for bit its eager one.
             Reports the capture seconds and the graph pool's bytes,
             served img/s against a plain pre-staged batch-32 eager
             executor loop over the same images (in turns: plain,
             served, served, plain), request p50/p99
             (profiler.latency_counters), per bucket a replay's event ms
             and host enqueue ms against the eager forward's, the
             device's idle share over one permutation (DIR/profile_
             serve_engine.txt), and program_cost() of the batch-32
             training executor.
32. serve_engine_rtc — rtc_infer's graph (#8 user_relu in all 50 relu
             nodes) and the built-in graph each through an engine with
             buckets (1, 32): outputs bit for bit at 32 and 1; #8's count
             from 0 before the user engine's warmup and first requests,
             200 after (a warm run and a capture a bucket); replays move
             it no further; torch.profiler's trace of one replay holds
             50 user_relu kernels. Reports a replay's wall against the
             eager forward's at 32.
33. model_server — serving.ModelServer with the SLA model (FC 1024, relu,
             FC 1024, relu, FC 10, softmax; input 128, bucket 8,
             max_delay_ms 1, slack_factor 3, shed_margin 2.5) on 2
             replicas colocated on the card, and the serve phase's
             transformer on 2 DecodeEngine replicas (register_decode).
             Gates: 8 prompts through submit_decode(pin=...) give streams
             equal to the same prompts through a DecodeEngine alone, each
             on the replica crc32(pin) picks, #1 launched (>= 12 a
             prefill call) on the kernel tier; traffic of 8-row requests
             while a version 3 is registered (captured during traffic)
             and a rollover swaps the default's weights: every answer
             bit for bit the old weights' or the new ones' (both seen),
             no capture added; version 3 answers right; under
             resilience.configure("serving.dispatch:replica=0:raise=
             OSError") replica 0's breaker opens and every request is
             served right on replica 1; 16 requests with a 0.01 ms
             deadline shed as DeadlineExceeded and are counted;
             submitted == served + shed + failed, none failed. Reports
             breakers, counters, request p50/p95/p99.
34. frontdoor — the network tier: serving.ServingFrontDoor on
             127.0.0.1 (port 0, frames sealed with MXNET_SERVING_AUTH_KEY)
             over a ModelServer holding the SLA model on 2 captured
             replicas, the serve phase's transformer on 2 decode replicas
             ("lm") and the long-context configuration on one decode engine
             ("lm_long": serve_long's engine geometry). A ServingClient in
             another OS process (this script with --frontdoor-client)
             streams the serve phase's 8 prompts and one 3800-token prompt,
             32 new tokens each (the prompt of index 5 through a client of
             its own whose transport it breaks after token 10), then sends
             256 SLA predicts of 8 rows. Gates: every stream bit for bit
             DecodeEngine.generate of its prompt in the gateway process;
             the broken stream resumed once and delivered seq_nos 1..32; #1
             launched at least 12 times per prefill call of the 8 prompts
             and #3 and its combine exactly 12 times per prefill call of the
             long one (counts from 0 just before the client starts); every
             predict bit for bit the in-process predict; a tampered frame
             refused before decode and counted (auth_rejected); on the
             gateway submitted == served + shed + failed with none failed
             and none pending; no KV block live. Reports the predicts'
             wire/queue/device/total ms (p50, p99), TTFT and inter-token
             over TCP against the same prompts submitted in-process, and
             the launch counts.
35. fleet — a gateway ModelServer with the SLA model on one captured
             local replica and a serving.FleetPool (heartbeat 0.5 s);
             LocalProcessLauncher starts one worker process on the same
             card (python -m mxnet_tpu_torch.serving.worker --builder
             chip_smoke:build_fleet_worker: the same weights from the same
             seed, its bucket captured before it joins). Gates: the worker
             joins through the half-open probe and its answers are bit for
             bit the local replica's; a burst of 240 requests submitted
             at once with the worker SIGKILLed before the 81st: every one
             served or shed typed,
             none failed, right answers, submitted == served + shed +
             failed; the pool marks the worker SUSPECT, then DEAD, and
             detaches it; Autoscaler(min_workers=1) launches a replacement,
             which is admitted and answers bit for bit; a rollover under
             traffic reaches both replicas (every answer from the old
             weights or the new, the worker's answers the new ones after
             it). Reports the join seconds (process start and capture
             included), the failover's counts and latency p50/p99, the
             seconds to SUSPECT and DEAD after the kill, the rollover ms.
36. imperative — the imperative runtime at full width: ResNet-50 v2
             (batch 32, 3x224x224, rtc_infer's seeded weights) walked
             node by node as getattr(mx.nd, op)(...) under
             mx.autograd.record(), with cudnn.deterministic (pulls in
             rtc_infer). Gates: (a) the loss output and all 157
             gradients bit for bit the Executor's forward(is_train=True)
             / backward(); (b) attach_grad on the data and
             mx.autograd.grad give the input gradient bit for bit the
             executor's (grad_req write on data); (c) one
             mx.nd.sgd_mom_update(..., out=w) a leaf bit for bit one
             fused_update_step (#7: 1 launch of 157 leaves); (d) under
             predict_mode the forward with its 50 relus through
             mx.nd.user_relu (#8, USER_RELU_SOURCE) bit for bit the
             built-in forward, 50 launches; (e) a second backward without
             retain_graph raises. Reports the imperative forward +
             backward wall against the executor's, host us a mx.nd call.
37. stochastic_fit — ResNet-50 with Dropout(p=0.5) before fc1 (built
             from get_internals()["flatten0_output"]) through
             Module.fit(kvstore='tpu_sync') under
             MXNET_TPU_FUSED_OPTUPDATE=1, 4 steps from one params dict.
             Gates: #7 one launch of 157 leaves a step; one numpy seed
             twice gives the same params, optimizer slots and BatchNorm
             statistics bit for bit, another seed other ones; p=0 bit for
             bit the graph without Dropout; each step's keep fraction
             within 0.5 +- 5 binomial sigma, kept values scaled by
             exactly 2; predict mode the identity (the executor's
             forward bit for bit the plain graph's). Then the reference
             example's Python softmax (custom_softmax, a CustomOp) as
             the head: its own gradient within CUSTOM_HEAD_TOL of
             SoftmaxOutput's, the network's within CUSTOM_GRAD_TOL
             (relative L2 a leaf), and 2 fused steps with #7 launching
             once a step.
             example_scripts (phase 18) also runs
             example/numpy-ops/custom_softmax.py and
             example/cnn_text_classification/text_cnn.py unchanged:
             "final accuracy" above 0.9 (the reference test's threshold).
38. rnn_seq — sequence models at the medium PTB LSTM's width (Zaremba
             et al. 2014: bptt 35, batch 20, 650 wide, 2 layers, vocab
             10000), float32 under cudnn.deterministic. Gates: (a) the RNN
             op's cuDNN route (torch._VF over views into the reference's
             packed parameters) against its plain per-step loop in every
             mode (lstm, gru, rnn_tanh, rnn_relu), one and two
             directions: the outputs, h_T/c_T and the gradients into
             data, parameters and both states within RNN_TOL of max
             |a - b| / max |b|; the control, the loop with the LSTM's i
             and f gates swapped in the unpacking, must fail that limit
             (read in every run); (b) dropout 0.5 between the layers: one
             numpy seed gives the same bits, another seed others, and at
             inference p changes nothing; (c) a FusedRNNCell LM
             (Embedding 10000 x 650, the fused 2 x 650 LSTM,
             FullyConnected to 10000, SoftmaxOutput) takes LM_STEPS steps
             of Module.fit(kvstore='tpu_sync', optimizer='adam') under
             MXNET_TPU_FUSED_OPTUPDATE=1: its loss falls every step, #7
             launches once a step over its 4 leaves, every RNN call runs
             cuDNN;
             its first step's loss and gradients match the network
             FusedRNNCell.unfuse() builds on the unpacked weights (loss
             LM_LOSS_TOL relative, each gradient LM_GRAD_TOL relative
             L2); the same fit with dropout 0.5 twice from one numpy seed
             gives the same params bit for bit; (d) CTCLoss at a speech
             shape (T 100, B 32, A 29, labels up to 20, with lengths) on
             the card against the same recursion on the CPU, loss and
             gradient within CTC_TOL. Reports each mode's forward +
             backward wall for the op, the plain loop and torch.nn's
             module on its own contiguous weights (the difference is the
             weight copy cuDNN makes of the views), the cuDNN kernels the
             profile names, the LM's losses and step walls, and CTC's
             times beside torch's ctc_loss.
39. bucketing_fit — the reference's example/rnn/lstm_bucketing.py,
             unchanged, through the launcher (python -m
             mxnet_tpu_torch.run_script) with --num-hidden 200
             --num-embed 200 --num-layers 2 --batch-size 32 --num-epochs 2
             (upstream MXNet's width) on CORPUS=, a file of 4000
             synthetic sentences over a 10000-token vocabulary with
             lengths spread over the buckets 10-40. Gates:
             Train-perplexity falls from epoch 1 to 2 (the reference's
             tests/python/unittest/test_examples.py:179-182), the fused
             step is active and #7 launches; the default bucket (40)
             updates through the fused step and every other bucket
             through the shared per-parameter updater (ROADMAP §C); a
             6-batch BucketingModule fit over 3 buckets on the card ends
             within BUCKET_TOL (each leaf's relative L2) of the same fit
             on the CPU, and the control, that fit with one batch left
             out, must fail it. Reports each bucket's step wall p50, its
             device ms (one traced step) and update path, and #7's
             launches.
40. detection_ops — the op families of ROADMAP A6 part 3 on the card
             against the same ops on CPU tensors. The multibox ops at
             SSD-300's shapes (the reference's example/ssd graph, built
             by its own files: batch 32, 21 classes, the anchors of its
             6-scale pyramid at 300x300, counted from the graph):
             MultiBoxPrior within DET_TOL; MultiBoxTarget with the train
             graph's parameters on SyntheticDetIter labels and seeded
             class scores, its classes and masks equal and its targets
             within DET_TOL (controls: variances reversed, mining ratio
             2); MultiBoxDetection as the train graph runs it (nms_topk
             400), ids equal, scores and boxes within DET_TOL (control:
             variances reversed); box_nms over each image's top 400
             rows equal (control: overlap 0.3). Each reports its wall,
             its device ms (a traced call) and the CPU's wall. Then 33
             more ops of the families (ROI pooling and align, the
             deformable ops, proposals, samplers, correlations, the
             fork's ops, image and linalg ops, 4-D Pooling) at
             detection-sized inputs, outputs and the gradients of the
             first output within OPS_TOL of max(1, |CPU|) (images
             IMG_TOL; bipartite matching and flips equal; control:
             ROIAlign's features moved by 0.01), and gelqf / syevd
             (eigenvalues 1..32) within OPS_TOL of LAPACK's up to each
             row's sign, reconstructing their input, rows orthonormal.
41. ssd_fit — (a) SSD-300 (VGG16-reduced, symbol_builder's DEFAULT_*
             pyramid, 20 classes plus background) through
             Module.fit(kvstore='tpu_sync', optimizer='sgd') at batch 32
             on 4 seeded SyntheticDetIter batches for 4 epochs (lr 0.004,
             momentum 0.9, wd 5e-4): #7 launches once a step over all 71
             float32 leaves, both MultiBoxMetric losses lower in the last
             epoch than in the first; reports the step wall p50, a
             Module step's device ms and idle share (profiled), and the
             wall inside MultiBoxTarget and MultiBoxDetection. (b) A
             narrow SSD (three small conv blocks for the backbone, two
             scales, 3x64x64, batch 4, 3 classes) takes 3 tpu_sync steps
             on the card and on the CPU from one numpy init: each leaf
             within NARROW_TOL relative L2; the control, the CPU fit one
             batch short, must fail it. (c) The reference's
             example/ssd/train.py, unchanged, through the launcher with
             --tpus 0 --batch-size 32 --data-shape 300 --epochs 1
             --num-batches 8 (its synthetic data; its default kvstore
             'local' updates through the per-parameter updater): it
             must print Epoch[0]'s Train-CrossEntropy and
             Validation-mAP, finite, and "run_script: jax not in
             sys.modules".

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
this, this, DIR's) at its path's shape. The float16 entries, which DIR
may lack, are held to F16_ULPS of the plain version and timed in this
checkout only (``f16``).

The line before last is ``{"kernels": [...]}`` with each kernel's launches
on its path's run (serving, training, symbolic training, long-context
serving or training, the rtc kernels' full-size run or the ResNet-50
forwards, the bf16 and float16 serving and training runs, long ones
included; #7's adds its launches in module_fit, example_scripts,
symbolic_bf16, supervised_fit, imperative, stochastic_fit, rnn_seq,
bucketing_fit and ssd_fit, by path in ``launches_by_path``; #1's and #8's ``launches_by_path`` add
model_server's and serve_engine_rtc's counts, taken on the host at
capture, #8's imperative's; #1's and #3's (and
its combine's) add frontdoor's), its error (the 16-bit
entries in row ulps of their dtype) and times; the last line is
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
    """``base<template arguments>`` of a kernel's mangled name (the last
    name of its nested names; its element type, half_mma.cuh's Bf16, F16
    or F32, as ``bf16``, ``f16`` or ``f32``, then its integer and bool
    template arguments)."""
    import re
    base, i = None, 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():   # <len><id>s
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        base, i = mangled[j:j + n], j + n
    types = [t.lower() for t in re.findall(r"\d(Bf16|F16|F32)E", mangled)]
    args = re.findall(r"L[ib](\d+)E", mangled)
    return "%s<%s>" % (base or mangled, ",".join(types + args))


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


#: the 16-bit attention bodies (each instantiated for bf16 and float16),
#: which must issue Hopper's warpgroup products (HGMMA in SASS); every
#: other attention kernel issues none
HALF_BODIES = ("flash_fwd_half_kernel", "flash_bwd_dq_half_kernel",
               "flash_bwd_dkv_half_kernel")
#: the same bodies in a parent checkout that had only bf16 ones
PARENT_BF16_BODIES = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                      "flash_bwd_dkv_bf16_kernel")


def hgmma_counts(paths):
    """{library: {kernel: HGMMA instructions}} from ``cuobjdump -sass``
    of each built ``flash_*`` library (``paths``: name -> file); fails
    unless every 16-bit body, in both dtypes, has some and every other
    kernel none."""
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
            body = name.split("<")[0] in HALF_BODIES
            if body and n == 0:
                fail("hgmma: %s of %s issues no warpgroup product"
                     % (name, lib))
            if not body and n:
                fail("hgmma: %s of %s issues %d warpgroup products"
                     % (name, lib, n))
        for dt in ("bf16", "f16"):
            if not any(n and name.split("<")[0] in HALF_BODIES
                       and "<%s," % dt in name for name, n in found.items()):
                fail("hgmma: %s holds no %s body" % (lib, dt))
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
        # the step's verdict: true updates, false writes nothing, the
        # plain version given the same verdict agreeing bit for bit
        for good in (True, False):
            verdict = torch.full((), good, dtype=torch.bool, device=dev)
            check(*_opt_battery(torch, tou, kind, resnet_table(), clip=0.01,
                                wd=1e-4, rescale=1 / 32, verdict=verdict),
                  kind, "ResNet-50 table, verdict %s" % good)
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
    """Each grid kernel and pass alone in ``dtype`` (float32, bf16 or
    float16): the
    combine and reduce passes on the plain version's float32 partials (a
    split a row cannot see holds (0, -1e30) or zeros there, which the
    kernels never read), held by ``check(kind, what, got, ref)`` and
    ``check_lse(kind, what, lse, ref)``; then device times (CUDA graphs)
    at the long training shape (4, 8, 4096, 64) causal with 8 splits and
    at #3's last chunk of a 3800-token prompt: each kernel and pass, the
    whole wrapper, its plain version, the stream kernel at the same shape,
    #4 with one split, and F.scaled_dot_product_attention as a yardstick
    only; each kernel's bound (float32: attention_bounds, 3xTF32; 16-bit:
    half_bounds), TFLOP/s and factor against SDPA. -> the row."""
    import torch.nn.functional as F
    sfx = fa._DTYPES[dtype]
    es = float(torch.finfo(dtype).bits // 8)
    bounds_of = attention_bounds if dtype == torch.float32 else half_bounds
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
    return result, row, {"kernel": relu_k, "user_sym": user_sym,
                         "builtin_sym": sym, "args": args, "aux": aux}


def parent_opt_update(torch, dev, lib, csrc, result):
    """Kernel #7 of the parent checkout (``lib``: its ``opt_update``
    library, built from ``csrc``) against this one's multi-tensor launch
    on one ResNet-50 update of each kind. A parent with per-leaf entries
    (``mx_optupdate_*_f32``) runs its kernel on the 71 leaves
    ``_kernel_eligible`` takes and the plain expression on the other 86,
    as its ``fused_update_step`` ran them; a parent with the multi-tensor
    entries runs them through this checkout's wrapper with the parent's
    functions (a parent whose entries take no verdict pointer is called
    without it). This checkout's launch runs with a null and with a true
    verdict: all three must give the same bits; the parent's and the null
    verdict's are timed in turns (parent, this, this, parent) as device
    time in a CUDA graph and as eager wall."""
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
        with open(os.path.join(csrc, "opt_update.cu")) as f:
            takes_verdict = "const bool* ok" in f.read()
        parent_fns = {}
        for name, argtypes in tou._ENTRIES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            if takes_verdict:
                fn.argtypes = argtypes
                parent_fns[name] = fn
                continue
            # records, count, lr, then (no verdict) the kind's scalars
            fn.argtypes = argtypes[:3] + argtypes[4:]
            parent_fns[name] = (lambda recs, count, lr, ok, *rest, f=fn:
                                f(recs, count, lr, *rest))
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
        for _ in range(3):
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

        def ours(table=trees[1], ok_t=None):
            tou._launch(opt, hp, lr_t, table, **kw, ok_t=ok_t)

        theirs()
        ours()
        ours(trees[2], torch.ones((), dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
        for mine, what in ((trees[1], "null"), (trees[2], "true")):
            for (a, _, sa), (b, _, sb) in zip(trees[0], mine):
                for x, y in zip((a,) + sa, (b,) + sb):
                    same, diff = _bit_diff(torch, y, x)
                    if not same:
                        result["opt_bit_identical"] = False
                        fail("parent: #7 %s with a %s verdict differs from "
                             "the parent's bits (max abs diff %g)"
                             % (kind, what, diff))
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


def parent_half(torch, fa, dev, sfx, rand, both, ours, result, gates,
                row_ulps):
    """``phase_parent``'s 16-bit part in bf16 (``sfx`` "bf16": both trees,
    each held to the plain version, the distance between them recorded,
    timed in turns) or float16 ("f16": this tree only, held to the plain
    version and timed). ``both(key, name, args, outs, iters)`` runs an
    entry of both trees and times them, ``ours(name)`` this tree's entry;
    readings go to ``result[sfx]``."""
    bf = getattr(torch, HALF[sfx])
    limit = gates[bf][2]
    result[sfx] = {}

    def pair(key, name, args, outs, iters=20):
        """[the parent's outputs, this tree's], or [this tree's] in
        float16."""
        if sfx == "bf16":
            return both(key, name, args, outs, iters)
        fn = ours(name)
        for o in outs:
            o.zero_()
        fn(*args)
        torch.cuda.synchronize()
        got = [o.clone() for o in outs]
        result["times"][key] = {"ms": time_ms(lambda: fn(*args),
                                              iters=iters)}
        return [got]

    def hold(key, runs, ref):
        """runs: [the parent's final outputs, this tree's] or [this
        tree's]; ref: the plain version's, in the same order (16-bit
        outputs, float32 lse)."""
        a, b_ = runs if len(runs) == 2 else (None, runs[0])
        row = {"ulps": [], "parent_ulps": [], "to_parent_ulps": []}
        for i, (y, r) in enumerate(zip(b_, ref)):
            if r.dtype != bf:   # lse
                live = r > NEG / 2
                err = scaled_err(y[live], r[live])
                if not err <= TOL or not bool((y[~live] == NEG).all()):
                    fail("parent: %s %s lse err %g" % (sfx, key, err))
                continue
            u = row_ulps(y, r)
            if not u <= limit:
                fail("parent: %s %s %.2f row ulps off the plain version"
                     % (sfx, key, u))
            row["ulps"].append(u)
            if a is not None:
                row["parent_ulps"].append(row_ulps(a[i], r))
                row["to_parent_ulps"].append(row_ulps(y, a[i]))
        result[sfx][key] = row

    B, H, S, D = 8, 8, 512, 64
    sm = 1.0 / math.sqrt(D)
    q, k, v, do = (rand(B, H, S, D).to(bf) for _ in range(4))
    offs0 = fa._offs0(dev)
    out, lse = fa.flash_fwd_plain(q, k, v, sm, True)
    deff = fa._deff(do, out, None).contiguous()
    o_, l_ = torch.empty_like(q), torch.empty(B, H, S, device=dev)
    tail = [B * H, S, S, D, sm, 1]
    hold(sfx + "_fwd", pair(sfx + "_fwd", "mx_flash_fwd_" + sfx,
                            [t.data_ptr() for t in (q, k, v, o_, l_)]
                            + tail, [o_, l_]), (out, lse))
    common = [t.data_ptr() for t in (q, k, v, offs0, do, lse, deff)]
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ref = fa.flash_bwd_offs_plain(q, k, v, offs0, do, None, out, lse, sm,
                                  True)
    for key, outs, want in (("dq", [dq], ref[:1]),
                            ("dkv", [dk, dv], ref[1:])):
        hold(sfx + "_" + key,
             pair(sfx + "_" + key, "mx_flash_bwd_%s_%s" % (key, sfx),
                  common + [o.data_ptr() for o in outs] + tail, outs), want)
    C, SK, q0 = 256, 512, 256
    q, k, v = (rand(1, H, n, D).to(bf) for n in (C, SK, SK))
    offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
    o_, l_ = torch.empty_like(q), torch.empty(1, H, C, device=dev)
    hold(sfx + "_offs", pair(sfx + "_offs", "mx_flash_fwd_offs_" + sfx,
                             [t.data_ptr() for t in (q, k, v, offs, o_, l_)]
                             + [H, C, SK, D, sm, 1], [o_, l_]),
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
    runs = pair(sfx + "_grid_fwd", "mx_flash_fwd_grid_" + sfx,
                [t.data_ptr() for t in (q, k, v, po, pl)]
                + [B * H, S, S, D, w, n, sm, 1], [po, pl], iters=5)
    finals = []
    for po_, pl_ in runs:
        o_, l_ = torch.empty_like(q), torch.empty(B, H, S, device=dev)
        launch("mx_flash_fwd_grid_combine_" + sfx, po_.data_ptr(),
               pl_.data_ptr(), o_.data_ptr(), l_.data_ptr(), B * H, S, D,
               w, n, 1)
        finals.append([o_, l_])
    hold(sfx + "_grid_fwd", finals, (out, lse))
    del po, pl, runs, finals
    common = [t.data_ptr() for t in (q, k, v, offs0, do, lse, deff)]
    ref = fa.flash_bwd_offs_grid_plain(q, k, v, offs0, do, None, out, lse,
                                       sm, True, w, w)
    parts = [torch.empty(n, B, H, S, D, device=dev) for _ in range(3)]
    for key, outs, want in (("dq", parts[:1], ref[:1]),
                            ("dkv", parts[1:], ref[1:])):
        runs = pair(sfx + "_grid_" + key,
                    "mx_flash_bwd_%s_grid_%s" % (key, sfx),
                    common + [o.data_ptr() for o in outs]
                    + [B * H, S, S, D, w, n, sm, 1], outs, iters=5)
        finals = []
        for got in runs:
            fin = [torch.empty_like(q) for _ in got]
            if key == "dq":
                launch("mx_flash_bwd_dq_grid_reduce_" + sfx,
                       offs0.data_ptr(), got[0].data_ptr(),
                       fin[0].data_ptr(), B * H, S, D, w, n, sm, 1)
            else:
                launch("mx_flash_bwd_dkv_grid_reduce_" + sfx,
                       offs0.data_ptr(), got[0].data_ptr(),
                       got[1].data_ptr(), fin[0].data_ptr(),
                       fin[1].data_ptr(), B * H, S, S, D, w, n, 1)
            finals.append(fin)
        hold(sfx + "_grid_" + key, finals, want)
        del runs, finals
    del q, k, v, do, out, lse, deff, ref, parts
    torch.cuda.empty_cache()
    C, q0 = 1024, 2816
    q, k, v = rand(1, H, C, D).to(bf), rand(1, H, S, D).to(bf), \
        rand(1, H, S, D).to(bf)
    offs = torch.tensor([q0, 0], dtype=torch.int32, device=dev)
    po, pl = (torch.empty(n, 1, H, C, D, device=dev),
              torch.empty(n, 1, H, C, device=dev))
    runs = pair(sfx + "_grid_offs", "mx_flash_fwd_offs_grid_" + sfx,
                [t.data_ptr() for t in (q, k, v, offs, po, pl)]
                + [H, C, S, D, w, n, sm, 1], [po, pl])
    finals = []
    for po_, pl_ in runs:
        o_, l_ = torch.empty_like(q), torch.empty(1, H, C, device=dev)
        launch("mx_flash_fwd_offs_grid_combine_" + sfx, offs.data_ptr(),
               po_.data_ptr(), pl_.data_ptr(), o_.data_ptr(), l_.data_ptr(),
               H, C, D, w, n, 1)
        finals.append([o_, l_])
    hold(sfx + "_grid_offs", finals,
         fa.flash_fwd_offs_grid_plain(q, k, v, offs, sm, True, w))
    del q, k, v, po, pl, runs, finals
    torch.cuda.empty_cache()


def phase_parent(torch, fa, dev, parent):
    """This checkout's attention kernels and #7 against another's
    (``--parent DIR``: a checkout, e.g. the parent commit unpacked with
    ``git archive``), built from DIR's ``csrc/`` and called through the
    same C entries (#7: the parent's per-leaf entries) on the same card.
    The float32 attention entries (forwards #5, #6, #1, #3 and backwards
    #2, #4) and #7 must give the same bits in both; the bf16 entries
    (#5, #1, #2, #6, #3, #4) are each held to the bf16 row-ulp limit of
    the plain version in both trees, with the row-ulp distance between
    the trees recorded, and the float16 entries, which DIR may lack, in
    this tree only (``parent_half``); every kernel is timed in turns
    (DIR's, this, this, DIR's) at its main path's shape, the float16 ones
    in this tree alone. The registers and spill bytes of DIR's 16-bit
    bodies are reported beside this tree's (the build line)."""
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

    # the 16-bit entries: their bodies' sums run in another order than the
    # parent's, so each tree is held to its dtype's row-ulp limit of the
    # plain version (lse to TOL) and the distance between the trees is
    # printed. The parent has no float16 entries: float16 is held in this
    # tree only. The grid entries' workspaces go through this tree's
    # combine or reduce pass on both sides. #5 and #2 at the training
    # shape, #1 at the serving shape, #6 and #4 at the long training shape
    # (8 splits), #3 at the long prefill's last chunk
    from mxnet_tpu_torch.kernels.bf16_gate import GATES, row_ulps
    for sfx in HALF:
        parent_half(torch, fa, dev, sfx, rand, both, ours, result,
                    GATES, row_ulps)
    parent_opt_update(torch, dev, libs["opt_update"], csrc, result)
    for v_ in result["times"].values():
        if "parent_ms" in v_:   # the float16 entries run in this tree only
            v_["speedup"] = v_["parent_ms"] / v_["ms"]
    # the parent's 16-bit bodies: [registers, spill store, spill load
    # bytes]
    result["ptxas"] = {}
    for n in paths:
        info = _build.csrc_build_info.get((csrc, n))
        bodies = {k: v for k, v in ptxas_kernels(
            info["ptxas"] if info else "").items()
                  if k.split("<")[0] in HALF_BODIES + PARENT_BF16_BODIES}
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
#: custom_softmax.py's and text_cnn.py's final accuracy must pass it (the
#: reference's tests/python/unittest/test_examples.py:246-253, 377-385)
EXAMPLE_ACC = 0.9
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
            ROOT, "example", script)] + args,
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
    ic = "image-classification/"
    runs = (("mnist_lenet_local", ic + "train_mnist.py",
             ["--kv-store", "local"], {}, 3, 8),
            ("mnist_lenet_tpu_sync", ic + "train_mnist.py",
             ["--kv-store", "tpu_sync"], fused, 3, 8),
            ("imagenet_resnet50_tpu_sync", ic + "train_imagenet.py",
             ["--benchmark", "1", "--kv-store", "tpu_sync",
              "--num-examples", "768"], fused, 1, 157),
            # the imperative slice's: a Python CustomOp loss layer, and
            # Embedding, Reshape, Concat and Dropout (both run kvstore
            # 'local', so #7 never launches)
            ("numpy_ops_custom_softmax", "numpy-ops/custom_softmax.py",
             ["--epochs", "15"], {}, 15, 0),
            ("text_cnn", "cnn_text_classification/text_cnn.py",
             ["--epochs", "8"], {}, 8, 0))
    for name, script, args, env, epochs, leaves in runs:
        if script.endswith("train_mnist.py"):
            args = ["--network", "lenet", "--num-epochs", "3"] + args
        elif script.endswith("train_imagenet.py"):
            args = args + ["--num-epochs", "1"]
        if script.startswith(ic):
            args = ["--gpus", "0"] + args
        out, counts, seconds = _run_script(torch, script, args, env, tmp)
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
        final = [float(v) for v in re.findall(
            r"final accuracy: ([0-9.]+)", out)]
        if not script.startswith(ic) and not (final and final[-1]
                                              > EXAMPLE_ACC):
            fail("example_scripts %s: final accuracy %s, want > %g (the "
                 "reference test's threshold)" % (name, final, EXAMPLE_ACC))
        if script.endswith("train_mnist.py"):
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
            "final_accuracy": final[-1] if final else None,
            "first_window_accuracy": windows[:1],
            "speedometer_samples_per_s": speeds,
            "opt_update_launches": steps}
    return result, {k: tuple(v) for k, v in total.items()}


# --- the supervised, prefetched Module.fit (phase 30) -----------------------

SUP_STEPS = 8           # gates (a) and (b): one epoch of 8 steps
SUP_NAN_STEP = 4        # the dispatch train.nan poisons in gate (b)
SUP_F16_STEPS = 20      # gate (d)
SUP_F16_BAD = 16        # its consecutive bad steps allowed: 2^15 to 1
SUP_RATE_STEPS = 16     # the prefetch on/off walls, twice each


def _fit_state(step):
    """Every param, momentum slot and BatchNorm statistic of a fused
    step, as device copies (in that order)."""
    return [t.detach().clone() for t in
            [step.params[n] for n in step.param_names]
            + [step.opt_state["mom"][n] for n in step.param_names]
            + [step.aux[n] for n in step.aux_names]]


def _same_state(torch, a, b):
    """True when two ``_fit_state`` lists hold the same bits."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.int32),
                                           y.view(torch.int32))
        for x, y in zip(a, b))


def h2d_by_stream(prof, nbytes):
    """Device ms and count of the host-to-device copies of ``nbytes`` (a
    batch's data) in a torch.profiler trace: on the stream that ran the
    most kernel time (the compute stream) and on every other stream."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    events = events.get("traceEvents", []) if isinstance(events, dict) \
        else events
    kernel_us, copy_us, n_copies = {}, {}, 0
    for e in events:
        args = e.get("args") or {}
        stream = args.get("stream")
        if e.get("cat") == "kernel":
            kernel_us[stream] = kernel_us.get(stream, 0.0) + e.get("dur", 0)
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "") \
                and args.get("bytes") == nbytes:
            copy_us[stream] = copy_us.get(stream, 0.0) + e.get("dur", 0)
            n_copies += 1
    compute = max(kernel_us, key=kernel_us.get) if kernel_us else None
    return {"compute_stream_ms": copy_us.get(compute, 0.0) / 1e3,
            "other_streams_ms": sum(v for k, v in copy_us.items()
                                    if k != compute) / 1e3,
            "copies": n_copies}


def phase_supervised_fit(torch, dev, seed, out_dir):
    """Full-width ResNet-50 through Module.fit(kvstore='tpu_sync',
    supervisor=TrainingSupervisor()) with the device prefetch (module
    docstring, phase 30). Returns (result, per-kernel (launches, leaves)
    of #7 on the path)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import profiler as mxprof
    from mxnet_tpu_torch.io_device import (DevicePrefetchIter,
                                           default_stage_fn)
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.parallel import DataParallelTrainStep
    from mxnet_tpu_torch.resilience import (NumericDivergence,
                                            TrainingSupervisor, faults)
    t0 = time.perf_counter()
    with mx.name.NameManager():
        sym = tres.get_symbol(num_classes=1000, num_layers=50,
                              image_shape="3,224,224")
    n_leaves = len(sym.list_arguments()) - 2
    rng = np.random.RandomState(seed + 30)
    data = rng.uniform(-1, 1, (4 * SYM_BATCH, 3, 224, 224)).astype(
        np.float32)
    label = rng.randint(0, 1000, (4 * SYM_BATCH,)).astype(np.float32)

    def batches(steps):
        rows = np.arange(steps * SYM_BATCH) % (4 * SYM_BATCH)
        return mx.io.NDArrayIter(data[rows], label[rows], SYM_BATCH)

    # one set of initial values for every fit of the phase
    mx.random.seed(seed)
    first = mx.mod.Module(sym, context=dev)
    it = batches(1)
    first.bind(it.provide_data, it.provide_label)
    first.init_params(initializer=mx.init.Xavier(rnd_type="gaussian",
                                                 magnitude=2))
    arg0, aux0 = first.get_params()
    del first
    result = {"phase": "supervised_fit", "model": "resnet50",
              "batch": [SYM_BATCH, 3, 224, 224],
              "setup_s": time.perf_counter() - t0}

    def fit(steps, supervisor=False, prefetch=True, snap=False, env=None,
            quarters=None):
        """One epoch of ``steps``; -> (module, per-step states, batch-end
        stamps)."""
        mod = mx.mod.Module(sym, context=dev)
        states, stamps = [], []

        def on_batch(p):
            if snap:
                states.append(_fit_state(mod._fused_step))
            if p.nbatch in (steps // 2 - 1, steps - 1):
                torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if quarters is not None and \
                    p.nbatch % (steps // 4) == steps // 4 - 1:
                quarters.append(float(p.eval_metric.get()[1]))
                p.eval_metric.reset()

        envs = {"MXNET_TPU_FUSED_OPTUPDATE": "1",
                "MXNET_DEVICE_PREFETCH": "1" if prefetch else "0",
                **(env or {})}
        with mock.patch.dict(os.environ, envs):
            mod.fit(batches(steps), eval_metric="crossentropy",
                    kvstore="tpu_sync", optimizer="sgd",
                    optimizer_params=FIT_OPT, arg_params=arg0,
                    aux_params=aux0, batch_end_callback=on_batch,
                    num_epoch=1, supervisor=supervisor)
        torch.cuda.synchronize()
        return mod, states, stamps

    # (a) float32 at scale 1.0, supervised and prefetched, against the
    # same fit unsupervised and unprefetched: every step's state bit for
    # bit (cuDNN's deterministic algorithms for (a) and (b), as module_fit
    # compares). The path's #7 launches are counted in the supervised fit.
    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, plain, _ = fit(SUP_STEPS, prefetch=False, snap=True)
        mxprof.supervisor_counters(reset=True)
        mxprof.pipeline_counters(reset=True)
        _reset_opt_counts(tou)
        sup = TrainingSupervisor()
        mod, supervised, _ = fit(SUP_STEPS, supervisor=sup, snap=True)
        counts = (_opt_counts(tou), _opt_leaves(tou))
        want = ({"sgd": 0, "sgd_mom": SUP_STEPS, "adam": 0},
                {"sgd": 0, "sgd_mom": n_leaves * SUP_STEPS, "adam": 0})
        if counts != want:
            fail("supervised_fit: kernel #7 (launches, leaves) %s, want "
                 "%s" % (counts, want))
        if not mod._fused_step.supervise:
            fail("supervised_fit: the fused step was built unsupervised")
        same = [_same_state(torch, a, b)
                for a, b in zip(plain, supervised)]
        if len(same) != SUP_STEPS or not all(same):
            bad = [i for i, ok in enumerate(same) if not ok]
            fail("supervised_fit (a): the supervised, prefetched fit "
                 "differs from the plain fit at steps %s (step %d: max "
                 "%g of a leaf's max abs)" % (bad, bad[0], max(
                     leaf_err(x, y) for x, y in zip(supervised[bad[0]],
                                                    plain[bad[0]]))))
        sc = mxprof.supervisor_counters()
        if sc["steps"] != SUP_STEPS or sc["bad_steps"] \
                or sup.loss_scale != 1.0:
            fail("supervised_fit (a): supervisor counters %s, scale %g"
                 % (sc, sup.loss_scale))
        result["a_fp32_scale1_bitwise_steps"] = sum(same)
        result["pipeline_counters_a"] = mxprof.pipeline_counters()

        # (b) train.nan at dispatch SUP_NAN_STEP: that step leaves the
        # state of the step before, bit for bit; one bad step, scale 1,
        # training goes on
        mxprof.supervisor_counters(reset=True)
        faults.configure("train.nan:step=%d:raise=FaultInjected"
                         % SUP_NAN_STEP)
        try:
            sup_b = TrainingSupervisor()
            _, nan_run, _ = fit(SUP_STEPS, supervisor=sup_b, snap=True)
        finally:
            faults.reset()
        k = SUP_NAN_STEP
        sc = mxprof.supervisor_counters()
        checks = {
            "prefix_is_clean": all(_same_state(torch, a, b) for a, b in
                                   zip(nan_run[:k], supervised[:k])),
            "bad_step_kept_state": _same_state(torch, nan_run[k],
                                               nan_run[k - 1]),
            "training_went_on": not _same_state(torch, nan_run[k + 1],
                                                nan_run[k]),
            "finite": all(bool(torch.isfinite(t).all())
                          for t in nan_run[-1]),
            "bad_steps": sc["bad_steps"] == 1 and sup_b.bad_steps == 1,
            "scale": sup_b.loss_scale == 1.0}
        if not all(checks.values()):
            fail("supervised_fit (b): %s, counters %s"
                 % ({c: v for c, v in checks.items() if not v}, sc))
        result["b_nan_step"] = {"step": k, "counters": sc,
                                "loss_scale": sup_b.loss_scale}
    finally:
        torch.backends.cudnn.deterministic = prior
    del plain, supervised, nan_run

    # (c) the staged batches are bit for bit the unwrapped ones, on the
    # card
    staged_it = DevicePrefetchIter(batches(6), stage_fn=default_stage_fn(
        dev), depth=2)
    n_staged = 0
    for sb, hb in zip(staged_it, batches(6)):
        for s_arr, h_arr in zip(sb.data + sb.label, hb.data + hb.label):
            s_t, h_t = s_arr._data, h_arr._data.to(dev)
            if s_t.device.type != "cuda" or not torch.equal(
                    s_t.view(torch.int32), h_t.view(torch.int32)):
                fail("supervised_fit (c): staged batch %d differs from "
                     "the host batch" % n_staged)
        n_staged += 1
    staged_it._shutdown()
    if n_staged != 6:
        fail("supervised_fit (c): %d staged batches, want 6" % n_staged)
    result["c_staged_batches_bitwise"] = n_staged

    # the first float16 master update against the float32 one from the
    # same values and batch, at each loss scale from 2^15 down to 1: the
    # step's verdict and the update's relative L2 (printed, not gated)
    staged = {"data": torch.from_numpy(data[:SYM_BATCH]).to(dev),
              "softmax_label": torch.from_numpy(label[:SYM_BATCH]).to(dev)}

    def update(cdt=None, scale=None):
        step = DataParallelTrainStep(
            sym, lr=0.05, momentum=0.9, wd=1e-4,
            rescale_grad=1.0 / SYM_BATCH, fused_optupdate=True,
            supervise=scale is not None, compute_dtype=cdt,
            device=dev).init_from(arg0, aux0, RESNET_SHAPES)
        before = [step.params[n].detach().clone() for n in step.param_names]
        step(staged, lr=0.05, **({} if scale is None else {"scale": scale}))
        delta = [step.params[n].detach() - b
                 for n, b in zip(step.param_names, before)]
        return delta, True if scale is None else bool(step.last_flag)

    d32, _ = update()
    probe = {}
    for k2 in (15, 13, 11, 10, 9, 7, 5, 3, 0):
        d16, good = update("float16", 2.0 ** k2)
        probe["2^%d" % k2] = {"verdict": good, "rel_l2": _rel_l2(d16, d32)}
    result["f16_first_update"] = probe
    emit({"phase": "supervised_fit_f16_probe", "f16_first_update": probe})
    del d32, d16

    # the same float16 fit under the supervisor's defaults (3 bad steps in
    # a row): MXNet's gradients are sums over the batch, and at full width
    # float16 overflows well below 2^15 (the probe above), so it raises
    # NumericDivergence, as the reference's does (printed, not gated)
    mxprof.supervisor_counters(reset=True)
    sup_0 = TrainingSupervisor()
    try:
        fit(SUP_F16_STEPS, supervisor=sup_0,
            env={"MXNET_FUSED_COMPUTE_DTYPE": "float16"})
        raised = None
    except NumericDivergence as e:
        raised = str(e)
    result["d_default_limit"] = {
        "bad_steps_limit": sup_0.bad_steps_limit, "raised": raised,
        "loss_scale_then": sup_0.loss_scale,
        "counters": mxprof.supervisor_counters()}
    emit({"phase": "supervised_fit_f16_default",
          **result["d_default_limit"]})

    # (d) float16 compute from the default scale 2^15: masters finite, no
    # divergence, the loss falls by quarter. The supervisor takes up to
    # SUP_F16_BAD consecutive bad steps, past the backoffs from 2^15 to a
    # scale that holds (the verdict is read 2 steps late)
    mxprof.supervisor_counters(reset=True)
    quarters = []
    sup_d = TrainingSupervisor(bad_steps_limit=SUP_F16_BAD)
    mod16, _, _ = fit(SUP_F16_STEPS, supervisor=sup_d,
                      env={"MXNET_FUSED_COMPUTE_DTYPE": "float16"},
                      quarters=quarters)
    sc = mxprof.supervisor_counters()
    step16 = mod16._fused_step
    finite = all(bool(torch.isfinite(p).all())
                 for p in step16.params.values())
    if step16.compute_dtype != torch.float16 or not finite \
            or sc["divergences"] or len(quarters) != 4 \
            or not all(math.isfinite(q) for q in quarters) \
            or not quarters[-1] < quarters[0]:
        fail("supervised_fit (d): dtype %s, masters finite %s, counters "
             "%s, cross-entropy by quarter %s" % (step16.compute_dtype,
                                                  finite, sc, quarters))
    result["d_float16"] = {"steps": SUP_F16_STEPS, "counters": sc,
                           "loss_scale_start": 2.0 ** 15,
                           "loss_scale_end": sup_d.loss_scale,
                           "scale_backoffs": sc["scale_backoffs"],
                           "scale_regrows": sc["scale_regrows"],
                           "cross_entropy_by_quarter": quarters}
    del mod16, step16

    # img/s and step wall p50 with the prefetch on and off, in turns
    rates = {"on": [], "off": []}
    mxprof.pipeline_counters(reset=True)
    for key in ("off", "on", "off", "on"):
        _, _, stamps = fit(SUP_RATE_STEPS, prefetch=key == "on")
        half = SUP_RATE_STEPS // 2
        walls = [b - a for a, b in zip(stamps[half:], stamps[half + 1:])]
        rates[key].append({
            "img_per_s_second_half": SYM_BATCH * (SUP_RATE_STEPS - half)
            / (stamps[-1] - stamps[half - 1]),
            "step_wall_ms_p50": statistics.median(walls) * 1e3})
    pc = mxprof.pipeline_counters()
    result["prefetch"] = {
        key: {"img_per_s": [r["img_per_s_second_half"] for r in v],
              "step_wall_ms_p50": [r["step_wall_ms_p50"] for r in v]}
        for key, v in rates.items()}
    result["prefetch"]["hit"] = pc["prefetch_hit"]
    result["prefetch"]["stall"] = pc["prefetch_stall"]
    result["prefetch"]["stall_ms"] = pc["prefetch_stall_ms"]
    result["prefetch"]["stage_ms_per_batch"] = pc["prefetch_stage_ms"] / max(
        1, pc["prefetch_hit"] + pc["prefetch_stall"])

    # the host-to-device copy of the batch left on the compute stream
    nbytes = SYM_BATCH * 3 * 224 * 224 * 4
    h2d = {}
    for key in ("off", "on"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fit(6, prefetch=key == "on")
        h2d[key] = h2d_by_stream(prof, nbytes)
        for v in ("compute_stream_ms", "other_streams_ms"):
            h2d[key][v + "_per_step"] = h2d[key].pop(v) / 6
    result["h2d_copy"] = h2d

    # the supervised bare step against the unsupervised one: device time
    # and ops per step
    bare = {}
    for key, supervise in (("unsupervised", False), ("supervised", True)):
        step = DataParallelTrainStep(
            sym, lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=1.0 / SYM_BATCH,
            fused_optupdate=True, supervise=supervise,
            device=dev).init_from(arg0, aux0, RESNET_SHAPES)
        bare[key] = profile_calls(torch, lambda: step(staged, lr=0.05),
                                  "supervised_fit_" + key, out_dir, warm=2,
                                  n=5, calls=3, classify=kind_of)
        del step
    bare["device_ms_ratio"] = bare["supervised"]["device_ms"] \
        / bare["unsupervised"]["device_ms"]
    bare["extra_ops"] = bare["supervised"]["device_ops_per_call"] \
        - bare["unsupervised"]["device_ops_per_call"]
    result["bare_step"] = bare

    # #7 over the 157 leaves with a true, a false and no verdict
    params = {n: p._data.detach().clone() for n, p in arg0.items()}
    names = sorted(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    grads = {n: torch.randn(params[n].shape, device=dev, generator=gen)
             * 1e-3 for n in names}
    moms = {n: torch.zeros_like(params[n]) for n in names}
    table = [(params[n], grads[n], (moms[n],)) for n in names]
    hp = _opt_hp("sgd_mom")
    lr_t = torch.full((), hp["lr"], device=dev)
    verdicts = {"null": None,
                "true": torch.ones((), dtype=torch.bool, device=dev),
                "false": torch.zeros((), dtype=torch.bool, device=dev)}
    result["opt_update_ms"] = {
        key: time_ms(lambda ok=ok: tou._launch(
            "sgd", hp, lr_t, table, rescale=1 / SYM_BATCH, clip=None,
            wd=1e-4, ok_t=ok), iters=5)
        for key, ok in verdicts.items()}
    del params, grads, moms, table

    result["card"] = card_line()
    return result, {k: (counts[0][k], counts[1][k]) for k in OPT_KERNELS}


# --- 16-bit compute: bf16 (phases 19-24) and float16 (25-29) ----------------

#: the dense bf16 and float16 tensor-core rate of one H100 SXM (the same)
PEAK_HALF_FLOPS = 989e12
#: the 16-bit paths: entry and counter suffix -> torch dtype name
HALF = {"bf16": "bfloat16", "f16": "float16"}


def half_counters(sfx):
    """The stream kernels' launch counters of the ``sfx`` entries."""
    return tuple(n + "_" + sfx for n in STREAM_COUNTERS)


def half_grid_counters(sfx):
    """grid kernel -> the launch counter of its ``sfx`` instantiation."""
    return {key: counter + "_" + sfx
            for key, (_, counter, _, _) in GRID_KERNELS.items()}


def half_bounds(flops, nbytes):
    ms, by = bound_ms(flops, nbytes, PEAK_HALF_FLOPS)
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
# Limits of the float16 paths. A float16 gradient at full width is not the
# float32 one in either package (the cotangent of the float16 logits rounds
# its off-target entries, ~(1/32000)/4096, to 0, and dS falls into
# float16's subnormals), so the float16 model through the kernels is held
# to the same float16 model through the kernels' plain versions from the
# same weights, on the card; the gap to float32 is printed, not gated.
# Set from readings of seeds 0 to 2 on the card beside the two controls,
# which must fail the gradients' gate in every run (PERF.md, section 6).
#: the first loss (relative): sound runs read 4.6e-7 to 1.09e-6, the
#: controls 1.49e-5 to 9.0e-4
F16_LOSS_RTOL = 5e-6
#: the worst leaf's first gradient (relative L2): sound runs read 0.0439
#: to 0.0453 (layers.wq: dS falls into float16's subnormals, where the
#: kernel's and the plain version's float32 sums round it apart), the
#: controls 0.744 to 0.792; the float32 model is 0.54-0.58 away
F16_GRAD_RTOL = 0.15
#: path -> (loss limit, gradient limit) of the first step's gate
GATE_LIMITS = {"bf16": (BF16_LOSS_RTOL, BF16_GRAD_RTOL),
               "f16": (F16_LOSS_RTOL, F16_GRAD_RTOL)}
#: path -> the train phase's steps. float16 takes the 10 the loss falls
#: in: at lr 1e-3 the residual stream passes 256 around step 12, where
#: the layer norm's float16 (x - mu)^2 overflows, its variance is inf and
#: the model's output collapses to uniform (loss 10.36, ln 32000), in the
#: reference's function as in the port's (PERF.md, section 6)
HALF_TRAIN_STEPS = {"bf16": TRAIN_STEPS, "f16": 10}
#: key tile of the transformer's control attention (the kernels' at D 64)
CONTROL_TILE = 64


def _control_attention(torch, fault):
    """Plain causal 16-bit attention over key tiles of CONTROL_TILE with
    one planted fault, a control for the 16-bit model's gates (the
    signature of ``models.transformer._attention``). "diagonal": each
    query tile's own key tile is dropped, so its first rows see no key and
    give 0. "rescale": a tile's P V joins the running sum without
    rescaling the sum when the row max rises (the sums l are
    rescaled)."""
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


def _half_counts(fa, sfx):
    return {name: getattr(fa, name) for name in half_counters(sfx)}


def _attention_counters(but=()):
    """Every attention kernel's launch counter, of every dtype, but those
    in ``but``."""
    every = STREAM_COUNTERS + tuple(v[1] for v in GRID_KERNELS.values())
    for sfx in HALF:
        every += half_counters(sfx) + tuple(half_grid_counters(sfx).values())
    return tuple(n for n in every if n not in but)


def _zero_attention_counts(fa):
    for name in _attention_counters():
        setattr(fa, name, 0)


def phase_serve_half(torch, fa, dev, sfx):
    """The serve phase's transformer in bf16 (``sfx`` "bf16") or float16
    ("f16") through DecodeEngine (module docstring, phases 19 and 25).
    Returns (result, #1's launches in that dtype)."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerDecodeModel)
    from mxnet_tpu_torch.serving import DecodeEngine
    phase = "serve_" + sfx
    dtype = getattr(torch, HALF[sfx])
    counter = "launches_" + sfx
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                            d_model=512, max_len=512, dtype=dtype)
    t0 = time.perf_counter()
    model = TransformerDecodeModel(cfg, seed=SEED, device=dev)
    eng = DecodeEngine(block_size=16, num_blocks=257, batch_size=8,
                       max_seq_len=512, prefill_buckets=(64, 256),
                       prefill_chunk=256, **model.engine_kwargs())
    setup_s = time.perf_counter() - t0
    try:
        if eng._k_pages.dtype != dtype:
            fail("%s: pages are %s" % (phase, eng._k_pages.dtype))
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
        counts = {name: getattr(fa, name) for name in _attention_counters()}
        calls = sum(-(-n // 256) for n in lengths)
        st = eng.stats()
        if st["served"] != len(prompts):
            fail("%s: served %d of %d" % (phase, st["served"], len(prompts)))
        others = {n: c for n, c in counts.items() if c and n != counter}
        if counts[counter] < cfg.num_layers * calls or others:
            fail("%s: #1 launches %d, want >= %d in %s; other attention "
                 "kernels %s" % (phase, counts[counter],
                                 cfg.num_layers * calls, HALF[sfx], others))
        if st["kv"]["blocks_live"] != 0:
            fail("%s: %d KV blocks still live" % (phase,
                                                  st["kv"]["blocks_live"]))
        for o in outs:
            if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
                fail("%s: bad stream %s" % (phase, o))
        ttft = [stamps[s.rid][0] - s.submitted_t for s in streams]
        gaps = [b - a for s in streams
                for a, b in zip(stamps[s.rid], stamps[s.rid][1:])]
        solo = [eng.generate(p, max_new_tokens=new, timeout=600.0)
                for p in prompts]
        if solo != outs:
            bad = [i for i, (a, b) in enumerate(zip(solo, outs)) if a != b]
            fail("%s: continuous != solo for prompts %s" % (phase, bad))
    finally:
        eng.stop()
    return {"phase": phase, "setup_s": setup_s, "wall_s": wall,
            "tokens": sum(len(o) for o in outs),
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "intertoken_p50_ms": statistics.median(gaps) * 1e3,
            "prefill_calls": calls, "launches": _half_counts(fa, sfx),
            "program_counts": list(eng.program_counts()),
            "continuous_equals_solo": True,
            "kv_page_bytes": eng._k_pages.element_size()}, counts[counter]


def _gate_readings(names, ref):
    """readings(loss, grads) against ``ref`` = (loss, grads): the loss's
    relative error and the worst leaf's relative L2 gradient error."""
    loss_ref, g_ref = ref

    def readings(loss, grads):
        errs = [_rel_l2([g], [w]) for g, w in zip(grads, g_ref)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        return {"loss_rel_err": abs(loss - loss_ref) / abs(loss_ref),
                "grad_rel_err": errs[worst], "grad_worst_leaf": names[worst]}
    return readings


def first_step_gate(torch, tm, loss_fn, loss_fn32, params, batch, sfx):
    """The 16-bit model's first loss and gradients (through the kernels)
    and under the two faulty attentions of ``_control_attention``, read
    against the gate's reference from the same weights and batch: for
    bf16 the float32 model, for float16 the same float16 model under the
    plain attention, the kernels' own plain versions with the reference
    kernels' roundings (``_FlashAttention`` on its CPU path, run on the
    card: ``flash_attention._on_cuda`` reads False), its float32 gap read
    and printed as ``f32_gap``, not gated (module docstring, phases 20 and
    26). -> (readings, the reference's loss)."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel.optim_update import tree_map
    names = _leaf_names(params)
    f32 = _first_grads(torch, loss_fn32, tree_map(lambda x: x.float(),
                                                  params), batch)
    if sfx == "bf16":
        ref = f32
    else:
        with mock.patch.object(fa, "_on_cuda", lambda t, where: False):
            ref = _first_grads(torch, loss_fn, params, batch)
    readings = _gate_readings(names, ref)
    sound = _first_grads(torch, loss_fn, params, batch)
    gate = {"sound": readings(*sound)}
    if sfx != "bf16":
        gate["f32_gap"] = _gate_readings(names, f32)(*sound)
    del f32, sound
    for fault in ("diagonal", "rescale"):
        with mock.patch.object(tm, "_attention",
                               _control_attention(torch, fault)):
            gate[fault] = readings(*_first_grads(torch, loss_fn, params,
                                                 batch))
    return gate, ref[0]


def phase_train_half(torch, fa, dev, seed, out_dir, sfx):
    """The train phase's transformer in bf16 (``sfx`` "bf16") or float16
    ("f16") through ShardedTrainStep (module docstring, phases 20 and
    26). Returns (result, launch counts in that dtype)."""
    import mxnet_tpu_torch.models.transformer as tm
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_loss)
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves
    phase = "train_" + sfx
    loss_rtol, grad_rtol = GATE_LIMITS[sfx]
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                            d_model=512, max_len=512,
                            dtype=getattr(torch, HALF[sfx]))
    B, S = 8, 512
    t0 = time.perf_counter()
    params = init_transformer(cfg, torch.Generator().manual_seed(seed), dev)
    make_batch = periodic_batches(seed, cfg.vocab_size, S, B)
    steps = HALF_TRAIN_STEPS[sfx]
    batches = [make_batch() for _ in range(steps)]

    def loss_fn(p, b):
        return transformer_loss(p, b["tokens"], b["targets"], cfg)

    cfg32 = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=8,
                              d_model=512, max_len=512)
    first = {k: torch.as_tensor(x).to(dev) for k, x in batches[0].items()}
    gate, loss_ref = first_step_gate(
        torch, tm, loss_fn, lambda p, b: transformer_loss(
            p, b["tokens"], b["targets"], cfg32), params, first, sfx)
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
    counts = _half_counts(fa, sfx)
    others = {n: getattr(fa, n) for n in _attention_counters(
        half_counters(sfx)) if getattr(fa, n)}
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        fail("%s: non-finite loss in %s" % (phase, losses))
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail("%s: loss did not fall: %s" % (phase, losses))
    want = cfg.num_layers * steps
    for name in ("launches_fwd_", "launches_bwd_dq_", "launches_bwd_dkv_"):
        if counts[name + sfx] != want:
            fail("%s: %s = %d, want %d (12 per step)"
                 % (phase, name + sfx, counts[name + sfx], want))
    if others or counts["launches_" + sfx]:
        fail("%s: other attention kernels launched: %s %s"
             % (phase, others, counts))
    rel = abs(losses[0] - loss_ref) / abs(loss_ref)
    if not (rel <= loss_rtol and gate["sound"]["grad_rel_err"]
            <= grad_rtol):
        fail("%s: first loss %r vs the reference's %r (rel %g, limit %g), "
             "gradients %s (limit %g)" % (phase, losses[0], loss_ref, rel,
                                          loss_rtol, gate, grad_rtol))
    if not min(gate[f]["grad_rel_err"] for f in ("diagonal", "rescale")) \
            > grad_rtol:
        fail("%s: a control passes the gradient gate: %s" % (phase, gate))
    dtypes = sorted({str(t.dtype) for t in tree_leaves(step.params)})
    if dtypes != ["torch.float32"]:
        fail("%s: masters are %s after Adam, want float32" % (phase,
                                                              dtypes))
    step_ms = statistics.median(walls[1:]) * 1e3
    prof = profile_calls(torch, lambda: step(batches[0]), phase, out_dir,
                         warm=2, n=5, calls=3)
    return {"phase": phase, "setup_s": setup_s, "steps": steps,
            "batch": [B, S], "wall_s": wall, "first_step_ms": walls[0] * 1e3,
            "step_ms_p50": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
            "losses": losses, "loss_gate_reference": loss_ref,
            "gate_reference": "float32 model" if sfx == "bf16" else
            "plain attention, same float16 model",
            "first_loss_rel_err": rel, "loss_rtol": loss_rtol,
            "grad_rtol": grad_rtol, "gates": gate,
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

# The long 16-bit model's first loss and gradients at 2 layers (full width,
# 4 x 4096 tokens; the controls' plain attention keeps every tile's scores
# for autograd), against the float32 model's from the same weights (bf16)
# or the same float16 model's under the plain attention (float16). Set from
# readings of seeds 0 to 2 on the card beside the controls of
# _control_attention, which must fail the gradients' gate in every run
# (PERF.md, section 6).
#: the first loss (relative): sound runs read at most 7.1e-6; the controls
#: read 1.2e-5 to 9.3e-5, too close to gate on, as at 512 tokens
BF16_LONG_LOSS_RTOL = 3e-5
#: the worst leaf's first gradient, ||g_bf16 - g_f32|| / ||g_f32||: sound
#: runs read at most 0.0080, the controls at least 0.164 (one 64-key tile
#: of 4096 dropped from each row moves less than at 512 tokens)
BF16_LONG_GRAD_RTOL = 0.04
#: the float16 ones, against the same model through the kernels' plain
#: versions: sound runs read losses of 0 to 2.7e-7 and worst leaves
#: (layers.wq) of 0.0323-0.0335; the controls 2.1e-5 to 9.0e-5 and
#: 0.450-0.611; the float32 model is 0.41-0.45 away
F16_LONG_LOSS_RTOL = 5e-6
F16_LONG_GRAD_RTOL = 0.08
#: path -> (loss limit, gradient limit) of the long first step's gate
LONG_GATE_LIMITS = {"bf16": (BF16_LONG_LOSS_RTOL, BF16_LONG_GRAD_RTOL),
                    "f16": (F16_LONG_LOSS_RTOL, F16_LONG_GRAD_RTOL)}
#: layers of the long gate's models
HALF_LONG_GATE_LAYERS = 2


def phase_serve_long_half(torch, fa, dev, seed, sfx):
    """The long-context configuration served in bf16 (``sfx`` "bf16") or
    float16 ("f16") (module docstring, phases 23 and 28). Returns (result,
    launches of #3's passes in that dtype)."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerDecodeModel)
    phase = "serve_long_" + sfx
    cfg = long_config(TransformerConfig, dtype=getattr(torch, HALF[sfx]))
    t0 = time.perf_counter()
    model = TransformerDecodeModel(cfg, seed=seed, device=dev)
    if not model.use_kernel:
        fail("%s: model on %s did not resolve to the kernel tier"
             % (phase, dev))
    setup_s = time.perf_counter() - t0
    counters = [half_grid_counters(sfx)[k] for k in ("offs", "offs_combine")]
    served, counts, _, eng_s = serve_long_prompts(
        model, cfg, seed, counters, _attention_counters(counters), phase)
    del model
    return {"phase": phase, "setup_s": setup_s + eng_s, **served}, counts


def phase_train_long_half(torch, fa, dev, seed, out_dir, sfx):
    """The long-context configuration trained in bf16 (``sfx`` "bf16") or
    float16 ("f16") (module docstring, phases 24 and 29). Returns (result,
    launches per grid kernel and pass in that dtype)."""
    import mxnet_tpu_torch.models.transformer as tm
    from mxnet_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_loss)
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves
    phase = "train_long_" + sfx
    dtype = getattr(torch, HALF[sfx])
    grid_counters = half_grid_counters(sfx)
    loss_rtol, grad_rtol = LONG_GATE_LIMITS[sfx]
    B, S = 4, LONG_S
    t0 = time.perf_counter()
    make_batch = periodic_batches(seed, 32000, S, B)
    batches = [{k: torch.as_tensor(x).to(dev) for k, x in make_batch().items()}
               for _ in range(LONG_STEPS)]

    def loss_fn_of(c):
        return lambda p, b: transformer_loss(p, b["tokens"], b["targets"], c)

    # the gate at 2 layers, its counters read on the sound step
    nl = HALF_LONG_GATE_LAYERS
    cfg_g = long_config(TransformerConfig, nl, dtype=dtype)
    params_g = init_transformer(cfg_g, torch.Generator().manual_seed(seed),
                                dev)
    gate_counters = [grid_counters[k] for k in ("fwd", "dq", "dkv")]
    for name in gate_counters:
        setattr(fa, name, 0)
    gate, loss_ref = first_step_gate(
        torch, tm, loss_fn_of(cfg_g),
        loss_fn_of(long_config(TransformerConfig, nl)), params_g,
        batches[0], sfx)
    if any(getattr(fa, n) != nl for n in gate_counters):
        fail("%s: the gate's step launched %s, want %d each"
             % (phase, {n: getattr(fa, n) for n in gate_counters}, nl))
    del params_g
    torch.cuda.empty_cache()
    if not (gate["sound"]["loss_rel_err"] <= loss_rtol and
            gate["sound"]["grad_rel_err"] <= grad_rtol):
        fail("%s: first loss and gradients %s against the reference's "
             "(limits %g, %g)" % (phase, gate, loss_rtol, grad_rtol))
    if not min(gate[f]["grad_rel_err"] for f in ("diagonal", "rescale")) \
            > grad_rtol:
        fail("%s: a control passes the gradient gate: %s" % (phase, gate))

    # the path: 12 layers, 10 steps through the grid kernels
    cfg = long_config(TransformerConfig, dtype=dtype)
    params = init_transformer(cfg, torch.Generator().manual_seed(seed), dev)
    step = ShardedTrainStep(loss_fn_of(cfg), optimizer="adam", lr=1e-3,
                            grad_clip=1.0, device=dev).init(params)
    setup_s = time.perf_counter() - t0
    counters = [grid_counters[k] for k in GRID_KERNELS
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
        fail("%s: non-finite loss in %s" % (phase, losses))
    if not statistics.mean(losses[-3:]) < losses[0]:
        fail("%s: loss did not fall: %s" % (phase, losses))
    want = cfg.num_layers * LONG_STEPS
    for name in counters:
        if counts[name] != want:
            fail("%s: %s = %d, want %d (12 per step)"
                 % (phase, name, counts[name], want))
    if any(other_counts.values()):
        fail("%s: other attention kernels launched: %s"
             % (phase, {n: c for n, c in other_counts.items() if c}))
    dtypes = sorted({str(t.dtype) for t in tree_leaves(step.params)})
    if dtypes != ["torch.float32"]:
        fail("%s: masters are %s, want float32" % (phase, dtypes))
    step_ms = statistics.median(walls[1:]) * 1e3
    prof = profile_calls(torch, lambda: step(batches[0]).item(), phase,
                         out_dir, warm=1, n=2, calls=1,
                         classify=kind_of_attention)
    del step
    torch.cuda.empty_cache()
    return {"phase": phase, "setup_s": setup_s,
            "steps": LONG_STEPS, "batch": [B, S], "wall_s": wall,
            "first_step_ms": walls[0] * 1e3, "step_ms_p50": step_ms,
            "tokens_per_s": B * S / step_ms * 1e3, "losses": losses,
            "gate_layers": nl, "loss_gate_reference": loss_ref,
            "gate_reference": "float32 model" if sfx == "bf16" else
            "plain attention, same float16 model",
            "loss_rtol": loss_rtol, "grad_rtol": grad_rtol, "gates": gate,
            "param_dtypes_after": dtypes, "launches": counts,
            "other_launches": {n: c for n, c in other_counts.items() if c},
            "peak_mem_gb": peak / 1e9, "profile": prof}, counts


def phase_half_kernel(torch, fa, dev, sfx):
    """The six attention kernels in bf16 (``sfx`` "bf16") or float16
    ("f16") against their plain versions in that dtype on the card (module
    docstring, phases 22 and 27). Returns (worst ulps per kernel, worst
    lse error, rows of times by kernel)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels.bf16_gate import GATES, row_ulps
    gen = torch.Generator().manual_seed(SEED + 7)
    bf = getattr(torch, HALF[sfx])
    limit = GATES[bf][2]
    phase = sfx + "_kernel"
    worst = {"offs": 0.0, "fwd": 0.0, "dq": 0.0, "dkv": 0.0,
             **{"grid_" + key: 0.0 for key in GRID_KERNELS}}
    lse_worst = 0.0

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev, bf)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    def check(kind, what, got, ref):
        if got.dtype != ref.dtype or got.dtype != bf:
            fail("%s %s: %s is %s, the plain version's %s"
                 % (phase, what, kind, got.dtype, ref.dtype))
        u = row_ulps(got, ref)
        if not u <= limit:
            fail("%s %s: %s %.2f row ulps > %g" % (phase, what, kind, u,
                                                   limit))
        if u >= worst[kind]:
            worst[kind], worst[kind + "_at"] = u, what

    def check_lse(what, lse, ref):
        nonlocal lse_worst
        live = ref > NEG / 2
        if not bool((lse[~live] == NEG).all().item()):
            fail("%s %s: dead rows' lse not -1e30" % (phase, what))
        err = scaled_err(lse[live], ref[live]) if bool(live.any()) else 0.0
        if not err <= TOL:
            fail("%s %s: lse err %g > %g" % (phase, what, err, TOL))
        lse_worst = max(lse_worst, err)

    def same(what, a, b):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail("%s %s: two calls on the same inputs differ"
                 % (phase, what))

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
                fail("%s %s: dead rows' out not 0" % (phase, what))
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
    # shape, against the plain versions and SDPA in the dtype
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
        "shape": "q (1,8,256,64) k/v (1,8,512,64) %s offs [256,0]" % sfx,
        "ms": ms, "plain_ms": time_ms(lambda: fa.flash_fwd_offs_plain(
            q, k, v, offs, sm, True)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm)),
        "flops": flops, "bytes": nbytes, "tflops": tflops(flops, ms),
        **half_bounds(flops, nbytes)}
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
                 "mx_flash_bwd_dq_" + sfx, *common, dq.data_ptr(), *tail,
                 device=dev), iters=iters),
             "dkv_ms": time_ms(lambda: fa._launch(
                 "mx_flash_bwd_dkv_" + sfx, *common, dk.data_ptr(),
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
            for k_, v_ in half_bounds(fl, nb).items():
                t[name + "_" + k_] = v_
        t["fwd_vs_sdpa"] = t["fwd_ms"] / t["sdpa_fwd_ms"]
        t["bwd_vs_sdpa"] = (t["dq_ms"] + t["dkv_ms"]) / t["sdpa_bwd_ms"]
        rows[key] = t
        del q, k, v, do, out, lse, deff, dq, dk, dv, qg, kg, vg
        torch.cuda.empty_cache()
    rows["grid"] = half_grid_rows(torch, fa, dev, rand, leaves, check,
                                  check_lse, same, bf)
    return worst, lse_worst, rows


def half_grid_rows(torch, fa, dev, rand, leaves, check, check_lse, same,
                   dtype):
    """The grid kernels #6, #4 and #3 on bf16 or float16 inputs
    (``dtype``; module docstring, phases 22 and 27): each against its
    plain version in that dtype, then timed. ``check`` (kind, what, got,
    ref) holds a 16-bit output to the dtype's row-ulp limit, ``check_lse``
    an lse to TOL, ``same`` two calls to the same bits. Returns the timing
    row."""
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
            fail("%s kernel %s: dead rows' out not 0" % (dtype, what))
        want = fa.flash_bwd_offs_grid_plain(q, k, v, offs, do, dlse, out,
                                            lse, sm, True, bq, bk)
        check("grid_dq", what + " dq", runs[0][2], want[0])
        check("grid_dkv", what + " dk", runs[0][3], want[1])
        check("grid_dkv", what + " dv", runs[0][4], want[2])
        del q, k, v, do, runs, want, ref
    torch.cuda.empty_cache()

    # each pass alone at the long shapes, timed
    t = grid_pass_times(
        torch, fa, dev, rand, leaves, dtype,
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
        for k_, v_ in half_bounds(flops, nbytes).items():
            bench[key + "_" + k_] = v_
        bench[key + "_tflops"] = tflops(flops, bench[key + "_ms"])
        bench[key + "_vs_sdpa"] = bench[key + "_ms"] / bench[
            "sdpa_%s_ms" % key]
    t["bench"] = bench
    del q, k, v, do, out, lse, deff, qg, kg, vg
    torch.cuda.empty_cache()
    return t


# --- the serving tier: captured bucket programs (phases 31-33) --------------

SERVE_BUCKETS = (1, 4, 8, 16, 32)
SERVE_SIZES = (1, 2, 4, 8, 16, 32)
SERVE_PERMS = 20        # the trace: SERVE_SIZES permuted 20 times
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6
SLA_BUCKET, SLA_IN, SLA_HIDDEN = 8, 128, 1024
SLA_REQUESTS = 400      # the rollover trace's requests, at most
WAIT_S = 600.0


def _deterministic_cudnn(torch):
    """cuDNN on fixed algorithms (the bit-for-bit gates); returns the
    prior flags for ``_restore_cudnn``."""
    prior = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return prior


def _restore_cudnn(torch, prior):
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = prior


def _host_ms(torch, fn, n=20):
    """Median host time to enqueue one call of ``fn`` (the card synced
    between calls, so the enqueue never waits on a full queue)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _synced_ms(torch, fn, n=10):
    """Median wall of one call of ``fn`` to the card's completion."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _request(torch, x):
    """An engine request of rows ``x`` (a tensor on the card) with its
    label input zeroed, as the engine fills a label it is not given."""
    return {"data": x, "softmax_label": torch.zeros(x.shape[0],
                                                    device=x.device)}


def _bind_at(torch, sym, dev, n, params, aux, grad_req="null"):
    exe = sym.simple_bind(dev, grad_req=grad_req, data=(n, 3, 224, 224),
                          softmax_label=(n,))
    for k, v in params.items():
        exe.arg_dict[k][:] = v
    for k, v in aux.items():
        exe.aux_dict[k][:] = v
    return exe


def phase_serve_engine(torch, dev, seed, out_dir):
    """ResNet-50 served through InferenceEngine's captured bucket programs
    (module docstring, phase 31)."""
    import numpy as np
    from mxnet_tpu_torch import profiler as tprof
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.serving import InferenceEngine, pad_to_bucket
    from mxnet_tpu_torch.serving import bucket_for
    t0 = time.perf_counter()
    sym = tres.get_symbol(num_classes=1000, num_layers=50,
                          image_shape="3,224,224")
    args, aux = resnet_values(torch, sym, dev, seed)
    params = {k: v for k, v in args.items() if k not in RESNET_SHAPES}
    trng = np.random.RandomState(7)
    trace = [int(s) for _ in range(SERVE_PERMS)
             for s in trng.permutation(SERVE_SIZES)]
    n_img = sum(trace)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    dev_images = torch.rand((n_img, 3, 224, 224), device=dev,
                            generator=gen) * 2 - 1
    images = dev_images.cpu().numpy()
    starts = np.cumsum([0] + trace[:-1])
    reqs = [images[s:s + n] for s, n in zip(starts, trace)]
    prior = _deterministic_cudnn(torch)
    eng = None
    try:
        eng = InferenceEngine(sym, params, aux, ctx=dev,
                              buckets=SERVE_BUCKETS, max_batch=32,
                              max_delay_ms=5.0, name="resnet50")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        built = eng.warmup({"data": RESNET_SHAPES["data"]})
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t1
        if built != len(SERVE_BUCKETS) or eng.captures != built:
            fail("serve_engine: warmup built %d programs (%d captures), "
                 "want %d" % (built, eng.captures, len(SERVE_BUCKETS)))
        pool_bytes = eng._cache.builder.pool_bytes()

        groups = []
        run_group = eng._batcher._run_group

        def recording(group, total):
            groups.append(list(group))
            return run_group(group, total)

        def serve_trace(record):
            eng._batcher._run_group = recording if record else run_group
            torch.cuda.synchronize()
            ts = time.perf_counter()
            futs = [eng.predict_async({"data": r}) for r in reqs]
            first = futs[0].result_wait(WAIT_S)[0]
            held = first.clone()
            outs = [f.result_wait(WAIT_S)[0] for f in futs]
            torch.cuda.synchronize()
            eng._batcher._run_group = run_group
            return time.perf_counter() - ts, futs, outs, first, held

        tprof.latency_counters(reset=True, prefix="serving.resnet50.")
        wall, futs, outs, first, held = serve_trace(True)
        lat = tprof.latency_counters(prefix="serving.resnet50.")
        stats = eng.stats()
        # (c) the five captured programs serve the whole trace
        if eng.compiles != len(SERVE_BUCKETS) or eng.misses != 0 or \
                eng.captures != len(SERVE_BUCKETS):
            fail("serve_engine: %d programs, %d misses, %d captures after "
                 "the trace" % (eng.compiles, eng.misses, eng.captures))
        # (d) a result held from the first request keeps its values
        if not torch.equal(first, held):
            fail("serve_engine: the first request's result changed")
        # (a) every request's rows bit for bit the eager forward of the
        # same padded bucket
        body = eng._cache.builder._fn
        checked = 0
        with torch.no_grad():
            for group in groups:
                stacked = np.concatenate([r.arrays["data"] for r in group])
                total = stacked.shape[0]
                padded = pad_to_bucket({"data": stacked}, total,
                                       bucket_for(total, SERVE_BUCKETS))
                eager = body(_request(torch, torch.from_numpy(
                    padded["data"]).to(dev)), eng._params, eng._aux)[0]
                row = 0
                for r in group:
                    if not torch.equal(r.result[0], eager[row:row + r.n]):
                        fail("serve_engine: a request's rows differ from "
                             "the eager forward of its padded bucket %d "
                             "(max abs %g)" % (eager.shape[0], (
                                 r.result[0] - eager[row:row + r.n])
                                 .abs().max().item()))
                    row += r.n
                    checked += 1
        if checked != len(trace):
            fail("serve_engine: %d of %d requests checked"
                 % (checked, len(trace)))
        # (b) within rtol 1e-5 of an executor bound at exactly n
        exes = {n: _bind_at(torch, sym, dev, n, params, aux)
                for n in SERVE_SIZES}
        worst_abs = 0.0
        for r, out, n in zip(reqs, outs, trace):
            exe = exes[n]
            exe.arg_dict["data"][:] = torch.from_numpy(r).to(dev)
            ref = exe.forward(is_train=False)[0]._data
            if not torch.allclose(out, ref, rtol=SERVE_RTOL,
                                  atol=SERVE_ATOL):
                fail("serve_engine: a batch-%d request is %g off the "
                     "exact-n executor" % (n, (out - ref).abs().max()
                                           .item()))
            worst_abs = max(worst_abs, (out - ref).abs().max().item())
        probs = torch.cat(outs)
        if tuple(probs.shape) != (n_img, 1000) or \
                not torch.isfinite(probs).all():
            fail("serve_engine: outputs of shape %s" % (tuple(probs.shape),))

        # Executor.warmup: the captured forward bit for bit the eager one,
        # and the two timed in turns against an unwarmed executor
        exe32 = exes[32]
        exe32.arg_dict["data"][:] = dev_images[:32]
        eager32 = exe32.forward(is_train=False)[0]._data.clone()
        exe32.warmup()
        if not exe32.has_compiled_forward():
            fail("serve_engine: Executor.warmup built no forward")
        for _ in range(3):
            if not torch.equal(exe32.forward(is_train=False)[0]._data,
                               eager32):
                fail("serve_engine: the warmed executor's forward differs "
                     "from its eager forward")
        plain = _bind_at(torch, sym, dev, 32, params, aux)
        plain.arg_dict["data"][:] = dev_images[:32]
        exe_ms = {"eager": [], "replay": []}
        for key in ("eager", "replay", "replay", "eager"):
            exe = plain if key == "eager" else exe32
            exe_ms[key].append(_synced_ms(
                torch, lambda exe=exe: exe.forward(is_train=False)))
        del exes

        # the yardstick: a plain pre-staged batch-32 eager executor loop
        # over the same images, in turns with the served trace
        n_iter = n_img // 32

        def plain_loop():
            torch.cuda.synchronize()
            ts = time.perf_counter()
            for i in range(n_iter):
                plain.arg_dict["data"][:] = dev_images[32 * i:32 * i + 32]
                plain.forward(is_train=False)
            torch.cuda.synchronize()
            return n_iter * 32 / (time.perf_counter() - ts)

        rates = {"plain": [plain_loop()], "served": [n_img / wall]}
        rates["served"].append(n_img / serve_trace(False)[0])
        rates["plain"].append(plain_loop())
        del plain

        # per bucket: a replay against the eager forward of the same batch
        per_bucket = {}
        with torch.no_grad():
            for b in SERVE_BUCKETS:
                batch = _request(torch, dev_images[:b].contiguous())
                prog = eng.program(b)
                prog(batch, eng._params, eng._aux)

                def eager(batch=batch):
                    body(batch, eng._params, eng._aux)
                per_bucket[str(b)] = {
                    "replay_event_ms": _event_ms(prog.replay, 7),
                    "replay_host_ms": _host_ms(torch, prog.replay),
                    "eager_event_ms": _event_ms(eager, 7),
                    "eager_host_ms": _host_ms(torch, eager, n=10)}

        # the device's idle share over one permutation of the trace
        def burst():
            fs = [eng.predict_async({"data": r}) for r in reqs[:6]]
            for f in fs:
                f.result_wait(WAIT_S)
        prof = profile_calls(torch, burst, "serve_engine", out_dir, warm=1,
                             n=3, calls=2, classify=kind_of)

        # the training executor's cost at the same width
        t2 = time.perf_counter()
        train_exe = _bind_at(torch, sym, dev, 32, params, aux,
                             grad_req="write")
        cost = train_exe.program_cost()
        cost_s = time.perf_counter() - t2
        del train_exe
    finally:
        if eng is not None:
            eng.stop()
        _restore_cudnn(torch, prior)
    macs = graph_macs(torch, sym, RESNET_SHAPES)
    total = lat.get("serving.resnet50.total", {})
    return {"phase": "serve_engine", "model": "resnet50",
            "buckets": list(SERVE_BUCKETS), "requests": len(trace),
            "images": n_img, "setup_s": setup_s, "capture_s": capture_s,
            "captures": eng.captures, "graph_pool_bytes": pool_bytes,
            "wall_s": wall, "served_img_per_s": rates["served"],
            "plain_b32_img_per_s": rates["plain"],
            "served_vs_plain": statistics.median(rates["served"])
            / statistics.median(rates["plain"]),
            "request_p50_ms": total.get("p50_ms"),
            "request_p99_ms": total.get("p99_ms"), "latency": lat,
            "batches": stats["batches_run"],
            "padded_rows": stats["padded_rows"],
            "step_time_ms": stats["step_time_ms"],
            "compiles": eng.compiles, "misses": eng.misses,
            "hits": eng.hits, "bitwise_vs_eager_bucket": True,
            "exact_n_max_abs_err": worst_abs, "exact_n_rtol": SERVE_RTOL,
            "held_result_unchanged": True, "per_bucket": per_bucket,
            "executor_warmup": {"bitwise": True,
                                "wall_ms_in_turns": exe_ms},
            "idle_share": prof["idle_share"], "profile": prof,
            "program_cost_train_b32": cost, "program_cost_s": cost_s,
            "macs_forward_b32": macs}


def phase_serve_engine_rtc(torch, dev, rtc):
    """rtc_infer's graph (#8 in every relu) served through an engine's
    captured programs (module docstring, phase 32). Returns (result, #8's
    launches on this path)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from mxnet_tpu_torch.serving import InferenceEngine
    relu_k = rtc["kernel"]
    params = {k: v for k, v in rtc["args"].items() if k not in RESNET_SHAPES}
    x32 = rtc["args"]["data"]
    prior = _deterministic_cudnn(torch)
    engines = {}
    try:
        torch.cuda.synchronize()
        relu_k.launches = 0
        t0 = time.perf_counter()
        for key in ("user", "builtin"):
            eng = engines[key] = InferenceEngine(
                rtc[key + "_sym"], params, rtc["aux"], ctx=dev,
                buckets=(1, 32), async_worker=False,
                name="resnet50_%s_relu" % key)
            eng.warmup({"data": RESNET_SHAPES["data"]})
            if key == "user":
                outs = {key: [eng.predict({"data": x})[0]._data
                              for x in (x32, x32[:1])]}
                launches = relu_k.launches
            else:
                outs[key] = [eng.predict({"data": x})[0]._data
                             for x in (x32, x32[:1])]
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        if launches != 2 * 2 * 50:
            fail("serve_engine_rtc: user_relu launched %d times building "
                 "and serving 2 buckets, want 200 (a warm run and a "
                 "capture each)" % launches)
        for a, b in zip(outs["user"], outs["builtin"]):
            if not _bit_diff(torch, a, b)[0]:
                fail("serve_engine_rtc: the user-op engine differs from "
                     "the built-in relu engine (max abs %g)"
                     % (a - b).abs().max().item())
        user = engines["user"]
        prog = user.program(32)
        before = relu_k.launches
        for _ in range(5):
            user.predict({"data": x32})
        torch.cuda.synchronize()
        if relu_k.launches != before:
            fail("serve_engine_rtc: replays moved #8's host count from %d "
                 "to %d" % (before, relu_k.launches))
        # one replay traced after a warm-up step of the profiler: a
        # trace's first kernels can go unrecorded while its device
        # tracing starts (one run saw 184 of a replay's 189 events)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as tr:
            for _ in range(2):
                prog.replay()
                torch.cuda.synchronize()
                tr.step()
        names = [e.name for e in tr.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        n_user = sum(1 for n in names if "user_relu" in n)
        if n_user != 50:
            fail("serve_engine_rtc: the trace of one replay shows %d "
                 "user_relu kernels, want 50 (%d device events)"
                 % (n_user, len(names)))
        body = user._cache.builder._fn
        batch = _request(torch, x32)
        walls = {"eager": [], "replay": []}
        with torch.no_grad():
            for key in ("eager", "replay", "replay", "eager"):
                walls[key].append(_synced_ms(torch, (
                    prog.replay if key == "replay" else
                    lambda: body(batch, user._params, user._aux))))
        replay_event_ms = _event_ms(prog.replay, 7)
    finally:
        for eng in engines.values():
            eng.stop()
        _restore_cudnn(torch, prior)
    return {"phase": "serve_engine_rtc", "model": "resnet50 (50 user_relu)",
            "buckets": [1, 32], "capture_s": capture_s,
            "captures": user.captures, "launches_building": launches,
            "bitwise_vs_builtin": True, "user_relu_kernels_per_replay": n_user,
            "device_kernels_per_replay": len(names),
            "wall_ms_b32_in_turns": walls,
            "replay_event_ms_b32": replay_event_ms}, launches


def _sla_symbol():
    from mxnet_tpu_torch import sym as S
    net = S.Variable("data")
    for i in range(2):
        net = S.FullyConnected(net, num_hidden=SLA_HIDDEN,
                               name="sla_fc%d" % i)
        net = S.Activation(net, act_type="relu")
    net = S.FullyConnected(net, num_hidden=10, name="sla_fc2")
    return S.SoftmaxOutput(net, name="softmax")


def phase_model_server(torch, fa, dev, seed, model):
    """ModelServer: the SLA model on two colocated replicas, the serve
    phase's transformer on two decode replicas (module docstring, phase
    33). Returns (result, #1's launches on this path)."""
    import threading
    import zlib
    import numpy as np
    from mxnet_tpu_torch import profiler as tprof
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.serving import (DeadlineExceeded, DecodeEngine,
                                         ModelServer)
    sym = _sla_symbol()
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(SLA_BUCKET, SLA_IN))
    weights = [{n: rng.normal(0, 0.05, s).astype(np.float32)
                for n, s in zip(sym.list_arguments(), shapes)
                if n not in ("data", "softmax_label")} for _ in range(3)]
    xs = rng.uniform(-1, 1, (8, SLA_BUCKET, SLA_IN)).astype(np.float32)
    knobs = dict(ctx=dev, buckets=(SLA_BUCKET,), max_delay_ms=1.0,
                 slack_factor=3.0, shed_margin=2.5,
                 warmup_shapes={"data": (SLA_BUCKET, SLA_IN)})
    tprof.latency_counters(reset=True, prefix="serving.sla_model.")
    srv = ModelServer(hedge_ms=False)
    decs = []
    try:
        t0 = time.perf_counter()
        srv.register("sla_model", sym, weights[0], replicas=2, **knobs)
        reps = [srv.engine("sla_model", replica=r) for r in (0, 1)]
        if [e.captures for e in reps] != [1, 1] or \
                {e.device for e in reps} != {dev}:
            fail("model_server: replicas captured %s on %s, want one "
                 "each on %s"
                 % ([e.captures for e in reps], [e.device for e in reps],
                    dev))
        decs = [DecodeEngine(block_size=16, num_blocks=257, batch_size=8,
                             max_seq_len=512, prefill_buckets=(64, 256),
                             prefill_chunk=256, name="lm%d" % i,
                             **model.engine_kwargs()) for i in range(2)]
        for d in decs:
            srv.register_decode("lm", d)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        # expected answers of each weight set: the eager body of a
        # replica on each request's own 8 rows
        body = reps[0]._cache.builder._fn

        def answers(w):
            p = {k: torch.from_numpy(v).to(dev) for k, v in w.items()}
            with torch.no_grad():
                return [body(_request(torch, torch.from_numpy(x).to(dev)),
                             p, {})[0] for x in xs]
        want = [answers(w) for w in weights]

        # decode through the server, pinned by crc32, against the engines
        # alone; #1 counted from 0 just before
        if not model.use_kernel:
            fail("model_server: the decode model is not on the kernel tier")
        prng = torch.Generator().manual_seed(SEED + 1)
        lengths = [5, 37, 64, 100, 200, 257, 380, 480]
        prompts = [torch.randint(0, model.cfg.vocab_size, (n,),
                                 generator=prng).tolist() for n in lengths]
        pins = ["seq-%d" % i for i in range(len(prompts))]
        torch.cuda.synchronize()
        fa.launches = 0
        streams = [srv.submit_decode("lm", p, pin=pin, max_new_tokens=32)
                   for p, pin in zip(prompts, pins)]
        got = [s.result_wait(WAIT_S) for s in streams]
        launches = fa.launches
        calls = sum(-(-n // 256) for n in lengths)
        if launches < model.cfg.num_layers * calls:
            fail("model_server: #1 launched %d times, want >= %d"
                 % (launches, model.cfg.num_layers * calls))
        picked = [zlib.crc32(p.encode("utf-8")) % 2 for p in pins]
        # an engine counts a stream just after resolving it
        deadline = time.monotonic() + 60.0
        while sum(d.stats()["served"] for d in decs) < len(prompts) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        served = [d.stats()["served"] for d in decs]
        if served != [picked.count(0), picked.count(1)]:
            fail("model_server: decode replicas served %s, the pins pick %s"
                 % (served, picked))
        alone = [decs[0].generate(p, max_new_tokens=32, timeout=WAIT_S)
                 for p in prompts]
        if got != alone:
            fail("model_server: streams through the server differ from the "
                 "engine alone for prompts %s"
                 % [i for i, (a, b) in enumerate(zip(got, alone)) if a != b])

        # the tier unloaded: one request at a time
        for k in range(64):
            srv.predict_async("sla_model", {"data": xs[k % 8]}).result_wait(
                WAIT_S)
        unloaded = tprof.latency_counters(
            reset=True, prefix="serving.sla_model.").get(
                "serving.sla_model.total", {})

        # traffic; a new version captured and a rollover while it flows
        results, stop = [], threading.Event()

        def traffic():
            i = 0
            while not stop.is_set() and i < SLA_REQUESTS:
                results.append((i % 8, srv.predict_async(
                    "sla_model", {"data": xs[i % 8]})))
                i += 1
                time.sleep(5e-4)

        thread = threading.Thread(target=traffic, daemon=True)
        thread.start()
        time.sleep(0.05)
        srv.register("sla_model", sym, weights[2], version=3, replicas=1,
                     **knobs)
        captures = sum(e.captures for e in reps)
        time.sleep(0.05)
        t1 = time.perf_counter()
        if srv.rollover("sla_model", weights[1], version=2) != 2:
            fail("model_server: rollover did not relabel the version")
        rollover_ms = (time.perf_counter() - t1) * 1e3
        time.sleep(0.05)
        stop.set()
        thread.join(WAIT_S)
        n_old = n_new = 0
        for k, f in results:
            out = f.result_wait(WAIT_S)[0]
            old, new = torch.equal(out, want[0][k]), torch.equal(
                out, want[1][k])
            if not (old or new):
                fail("model_server: an answer during the rollover is "
                     "neither the old weights' nor the new ones' (max abs "
                     "%g / %g)" % ((out - want[0][k]).abs().max().item(),
                                   (out - want[1][k]).abs().max().item()))
            n_old += old
            n_new += new and not old
        if not (n_old and n_new):
            fail("model_server: the rollover did not land inside the "
                 "traffic (%d old, %d new answers)" % (n_old, n_new))
        if sum(e.captures for e in reps) != captures or \
                [e.compiles for e in reps] != [1, 1]:
            fail("model_server: the rollover captured %d programs"
                 % (sum(e.captures for e in reps) - captures))
        v3 = srv.predict("sla_model", {"data": xs[0]}, version=3)[0]._data
        if not torch.equal(v3, want[2][0]):
            fail("model_server: version 3 (captured during traffic) "
                 "answers wrong")
        lat = tprof.latency_counters(prefix="serving.sla_model.")

        # a faulted replica: its breaker opens, replica 1 serves everything
        resilience.configure("serving.dispatch:replica=0:raise=OSError")
        try:
            futs = [srv.predict_async("sla_model", {"data": xs[k % 8]})
                    for k in range(40)]
            for k, f in enumerate(futs):
                if not torch.equal(f.result_wait(WAIT_S)[0],
                                   want[1][k % 8]):
                    fail("model_server: a rerouted answer is wrong")
        finally:
            resilience.configure(None)
        st = srv.stats()["sla_model"]
        breakers = [r["breaker"] for r in st["versions"]["2"]]
        if breakers[0]["state"] != "open" or \
                breakers[1]["state"] != "closed" or \
                st["counters"]["failed"] != 0:
            fail("model_server: breakers %s, counters %s"
                 % (breakers, st["counters"]))

        # impossible deadlines shed, typed and counted
        shed0 = st["counters"]["shed"]
        sheds = [srv.predict_async("sla_model", {"data": xs[0]},
                                   deadline_ms=0.01) for _ in range(16)]
        n_shed = 0
        for f in sheds:
            try:
                f.result_wait(WAIT_S)
            except DeadlineExceeded:
                n_shed += 1
        counters = srv.stats()["sla_model"]["counters"]
        if n_shed != 16 or counters["shed"] - shed0 != 16:
            fail("model_server: %d of 16 impossible deadlines shed (%d "
                 "counted)" % (n_shed, counters["shed"] - shed0))
        if counters["submitted"] != counters["served"] + counters["shed"] \
                + counters["failed"] or counters["failed"]:
            fail("model_server: accounting %s" % counters)
        dstats = srv.decode_stats()["lm"]
    finally:
        srv.stop()
    total = lat.get("serving.sla_model.total", {})
    return {"phase": "model_server", "setup_s": setup_s,
            "replicas": 2, "decode_replicas": 2,
            "decode_streams_equal_engine": True, "decode_pins": picked,
            "decode_served": served, "flash_launches": launches,
            "rollover_answers": {"old": n_old, "new": n_new},
            "rollover_ms": rollover_ms, "rollover_captures": 0,
            "captured_during_traffic": 1,
            "breakers": breakers, "counters": counters,
            "request_p50_ms": total.get("p50_ms"),
            "request_p95_ms": total.get("p95_ms"),
            "request_p99_ms": total.get("p99_ms"), "latency": lat,
            "traffic_requests": len(results),
            "unloaded_p50_ms": unloaded.get("p50_ms"),
            "unloaded_p99_ms": unloaded.get("p99_ms"),
            "decode_stats": [{k: d[k] for k in ("served", "tokens",
                                                "steps")} for d in dstats]
            }, launches


# ----------------------------------------------------------------------
# the network tier: the front door over TCP and the fleet (phases 34, 35)
# ----------------------------------------------------------------------
FD_NEW = 32             # new tokens a stream
FD_PREDICTS = 256       # SLA predicts through the wire
FD_BREAK_AT = 10        # the broken stream loses its transport after this
FD_BREAK_PROMPT = 5     # ... and is the serve phase's prompt of this index
FLEET_HEARTBEAT_S = 0.5
FLEET_TRAFFIC = 240     # requests of the failover trace
FLEET_KILL_AT = 80      # the worker is SIGKILLed before this request
FLEET_WAIT_S = 120.0    # a worker's start, import and capture included
SEED_ENV = "MXNET_CHIP_SMOKE_SEED"
DEVICE_ENV = "MXNET_CHIP_SMOKE_DEVICE"


def _pct(values, q):
    """The q-quantile (0..1) of ``values`` by nearest rank, or None."""
    if not values:
        return None
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))]


def _p50_p99(values):
    return {"p50": _pct(values, 0.50), "p99": _pct(values, 0.99),
            "n": len(values)}


def sla_weights(seed, n=1):
    """The SLA model's weight sets from ``seed``, as the model_server
    phase draws them (numpy float32)."""
    import numpy as np
    sym = _sla_symbol()
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(SLA_BUCKET, SLA_IN))
    return sym, [{k: rng.normal(0, 0.05, s).astype(np.float32)
                  for k, s in zip(sym.list_arguments(), shapes)
                  if k not in ("data", "softmax_label")} for _ in range(n)]


def build_fleet_worker():
    """The fleet worker's builder (``python -m
    mxnet_tpu_torch.serving.worker --builder chip_smoke:build_fleet_worker``):
    the SLA model on one replica on the gateway's device
    (``MXNET_CHIP_SMOKE_DEVICE``, else the card), with the gateway's
    weights (``MXNET_CHIP_SMOKE_SEED``, else SEED), its bucket captured
    before it returns, float32 kept float32."""
    import torch
    from mxnet_tpu_torch.serving import ModelServer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sym, (weights,) = sla_weights(int(os.environ.get(SEED_ENV, SEED)))
    srv = ModelServer(hedge_ms=False)
    srv.register("sla_model", sym, weights, ctx=os.environ.get(DEVICE_ENV),
                 buckets=(SLA_BUCKET,), max_delay_ms=1.0, slack_factor=3.0,
                 shed_margin=2.5,
                 warmup_shapes={"data": (SLA_BUCKET, SLA_IN)})
    eng = srv.engine("sla_model")
    if eng.device.type == "cuda" and eng.captures != 1:
        fail("build_fleet_worker: the bucket was not captured")
    return srv


def frontdoor_client(spec_path):
    """The front door phase's client, in its own OS process (``python3
    chip_smoke.py --frontdoor-client SPEC``): the streams and the SLA
    predicts of SPEC through ``ServingClient`` over TCP; writes what it
    got to SPEC's ``out`` (JSON) and ``outs`` (npz)."""
    import numpy as np
    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch.serving import ServingClient
    with open(spec_path) as f:
        spec = json.load(f)
    host, port = "127.0.0.1", spec["port"]
    main = ServingClient(host, port, pool_size=2, connect_deadline_s=60.0)
    breaker = ServingClient(host, port, pool_size=1, connect_deadline_s=60.0)
    stamps, seqs = {}, {}

    def on_token(stream, seq_no, token):
        stamps.setdefault(stream.trace, []).append(time.monotonic())
        seqs.setdefault(stream.trace, []).append(seq_no)
        if stream.trace == "broken" and seq_no == FD_BREAK_AT:
            breaker._pool[0].break_transport()

    t0 = time.monotonic()
    streams = []
    for i, (model, prompt) in enumerate(spec["streams"]):
        client = breaker if i == spec["broken"] else main
        trace = "broken" if i == spec["broken"] else "s%d" % i
        streams.append(client.decode_async(
            prompt, model=model, max_new_tokens=FD_NEW, trace_id=trace,
            on_token=on_token))
    tokens = [s.result_wait(WAIT_S) for s in streams]
    stream_s = time.monotonic() - t0
    ttft = {s.trace: (stamps[s.trace][0] - s.t_submit) * 1e3
            for s in streams}
    gaps = {s.trace: [(b - a) * 1e3 for a, b in zip(stamps[s.trace],
                                                     stamps[s.trace][1:])]
            for s in streams}
    xs = np.load(spec["xs"])
    t0 = time.monotonic()
    futs = [main.predict_async({"data": xs[k % len(xs)]}, model="sla_model")
            for k in range(spec["predicts"])]
    outs = [f.result_wait(WAIT_S)[0] for f in futs]
    predict_s = time.monotonic() - t0
    np.savez(spec["outs"], *outs)
    health = main.health()
    result = {"tokens": tokens, "seq_nos": [seqs[s.trace] for s in streams],
              "ttft_ms": [ttft[s.trace] for s in streams],
              "gaps_ms": [gaps[s.trace] for s in streams],
              "timings": [f.timings for f in futs],
              "stream_s": stream_s, "predict_s": predict_s,
              "client_stats": {"main": main.stats, "breaker": breaker.stats},
              "health_models": sorted(health["models"])}
    main.close()
    breaker.close()
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


def phase_frontdoor(torch, fa, dev, seed, model):
    """A ServingFrontDoor over a ModelServer on the card, its client in
    another OS process (module docstring, phase 34). Returns (result,
    {counter: launches on this path})."""
    import socket
    import numpy as np
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerDecodeModel)
    from mxnet_tpu_torch.serving import (DecodeEngine, ModelServer,
                                         ServingFrontDoor, wire)
    sym, weights = sla_weights(seed)
    rng = np.random.RandomState(seed + 1)
    xs = rng.uniform(-1, 1, (8, SLA_BUCKET, SLA_IN)).astype(np.float32)
    key = os.environ["MXNET_SERVING_AUTH_KEY"]
    long_cfg = long_config(TransformerConfig)
    srv = ModelServer(hedge_ms=False)
    fd = None
    try:
        t0 = time.perf_counter()
        srv.register("sla_model", sym, weights[0], ctx=dev, replicas=2,
                     buckets=(SLA_BUCKET,), max_delay_ms=1.0,
                     slack_factor=3.0, shed_margin=2.5,
                     warmup_shapes={"data": (SLA_BUCKET, SLA_IN)})
        decs = [DecodeEngine(block_size=16, num_blocks=257, batch_size=8,
                             max_seq_len=512, prefill_buckets=(64, 256),
                             prefill_chunk=256, name="fd_lm%d" % i,
                             **model.engine_kwargs()) for i in range(2)]
        for d in decs:
            srv.register_decode("lm", d)
        long_model = TransformerDecodeModel(long_cfg, seed=seed, device=dev)
        if not (model.use_kernel and long_model.use_kernel):
            fail("frontdoor: a decode model is not on the kernel tier")
        long_eng = DecodeEngine(block_size=16, num_blocks=1025,
                                batch_size=4, max_seq_len=LONG_S,
                                prefill_buckets=(256, 1024),
                                prefill_chunk=1024, name="fd_long",
                                **long_model.engine_kwargs())
        srv.register_decode("lm_long", long_eng)
        fd = ServingFrontDoor(srv, host="127.0.0.1", port=0).start()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        want = [srv.predict("sla_model", {"data": x})[0]._data for x in xs]

        prng = torch.Generator().manual_seed(SEED + 1)
        lengths = [5, 37, 64, 100, 200, 257, 380, 480]
        prompts = [torch.randint(0, model.cfg.vocab_size, (n,),
                                 generator=prng).tolist() for n in lengths]
        long_prompt = np.random.RandomState(seed).randint(
            0, long_cfg.vocab_size, LONG_PROMPTS[-1]).tolist()
        streams = [("lm", p) for p in prompts] + [("lm_long", long_prompt)]
        grid = [GRID_KERNELS[k][1] for k in ("offs", "offs_combine")]
        with tempfile.TemporaryDirectory() as tmp:
            spec = {"port": fd.port, "streams": streams,
                    "broken": FD_BREAK_PROMPT, "predicts": FD_PREDICTS,
                    "xs": os.path.join(tmp, "xs.npy"),
                    "outs": os.path.join(tmp, "outs.npz"),
                    "out": os.path.join(tmp, "out.json")}
            np.save(spec["xs"], xs)
            with open(os.path.join(tmp, "spec.json"), "w") as f:
                json.dump(spec, f)
            torch.cuda.synchronize()
            for name in ("launches",) + tuple(grid):
                setattr(fa, name, 0)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--frontdoor-client", os.path.join(tmp, "spec.json")],
                capture_output=True, text=True, timeout=WAIT_S)
            client_s = time.perf_counter() - t0
            counts = {name: getattr(fa, name)
                      for name in ("launches",) + tuple(grid)}
            if proc.returncode != 0:
                fail("frontdoor: the client process exited %d: %s"
                     % (proc.returncode, proc.stderr[-3000:]))
            with open(spec["out"]) as f:
                got = json.load(f)
            with np.load(spec["outs"]) as z:
                outs = [z["arr_%d" % k] for k in range(FD_PREDICTS)]

        # the streams, bit for bit the engines' own decode in this process
        solo = [decs[0].generate(p, max_new_tokens=FD_NEW, timeout=WAIT_S)
                for p in prompts]
        solo.append(long_eng.generate(long_prompt, max_new_tokens=FD_NEW,
                                      timeout=WAIT_S))
        if got["tokens"] != solo:
            fail("frontdoor: streams over TCP differ from generate() for "
                 "prompts %s" % [i for i, (a, b) in enumerate(
                     zip(got["tokens"], solo)) if a != b])
        if got["seq_nos"][FD_BREAK_PROMPT] != list(range(1, FD_NEW + 1)):
            fail("frontdoor: the resumed stream delivered seq_nos %s"
                 % got["seq_nos"][FD_BREAK_PROMPT])
        bstats = got["client_stats"]["breaker"]
        if bstats["stream_resumes"] != 1 or bstats["failovers"] != 1:
            fail("frontdoor: the broken stream did not resume once: %s"
                 % bstats)
        calls = sum(-(-n // 256) for n in lengths)
        long_calls = -(-len(long_prompt) // 1024)
        if counts["launches"] < model.cfg.num_layers * calls:
            fail("frontdoor: #1 launched %d times, want >= %d"
                 % (counts["launches"], model.cfg.num_layers * calls))
        for name in grid:
            if counts[name] != long_cfg.num_layers * long_calls:
                fail("frontdoor: %s = %d, want %d" % (
                    name, counts[name], long_cfg.num_layers * long_calls))
        for k, out in enumerate(outs):
            if not torch.equal(torch.from_numpy(out),
                               want[k % len(xs)].cpu()):
                fail("frontdoor: predict %d over the wire differs from "
                     "the in-process answer" % k)

        # a tampered frame: refused before decode, and counted
        rejected = fd.stats()["auth_rejected"]
        sock = socket.create_connection(("127.0.0.1", fd.port), timeout=10)
        try:
            sock.settimeout(10.0)
            wire.recv_msg(sock, auth_key=key.encode())
            sealed = wire._seal(wire.encode_payload(
                ("ping", "x"), wire.CODEC_SAFE), key.encode())
            tampered = bytes([sealed[0] ^ 0xFF]) + sealed[1:]
            sock.sendall(len(tampered).to_bytes(8, "little") + tampered)
            deadline = time.monotonic() + 10.0
            while fd.stats()["auth_rejected"] == rejected and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            sock.close()
        st = fd.stats()
        if st["auth_rejected"] != rejected + 1:
            fail("frontdoor: the tampered frame was not refused and "
                 "counted: %s" % st)
        if st["submitted"] != st["served"] + st["shed"] + st["failed"] \
                or st["failed"] or st["submitted"] != len(streams) \
                + FD_PREDICTS or st["pending"]:
            fail("frontdoor: gateway accounting %s" % st)
        live = [d.stats()["kv"]["blocks_live"] for d in decs + [long_eng]]
        if any(live):
            fail("frontdoor: KV blocks still live %s" % live)

        # the same prompts in this process, all at once, for TTFT and
        # inter-token against the wire's
        stamps = {}

        def on_token(stream, seq_no, token):
            stamps.setdefault(stream.rid, []).append(time.monotonic())
        local = [srv.submit_decode("lm", p, pin="local-%d" % i,
                                   max_new_tokens=FD_NEW, on_token=on_token)
                 for i, p in enumerate(prompts)]
        local.append(srv.submit_decode("lm_long", long_prompt,
                                       max_new_tokens=FD_NEW,
                                       on_token=on_token))
        for s in local:
            s.result_wait(WAIT_S)
        local_ttft = [(stamps[s.rid][0] - s.submitted_t) * 1e3
                      for s in local]
        local_gaps = [(b - a) * 1e3 for s in local
                      for a, b in zip(stamps[s.rid], stamps[s.rid][1:])]
    finally:
        if fd is not None:
            fd.drain(timeout=30.0)
        srv.stop()
    keep = [i for i in range(len(streams)) if i != FD_BREAK_PROMPT]
    tcp_gaps = [g for i in keep for g in got["gaps_ms"][i]]
    timings = {k: _p50_p99([t[k] for t in got["timings"]])
               for k in ("wire_ms", "queue_ms", "device_ms", "total_ms")}
    return {"phase": "frontdoor", "setup_s": setup_s,
            "client_process_s": client_s, "stream_s": got["stream_s"],
            "predict_s": got["predict_s"],
            "streams": len(streams), "new_tokens": FD_NEW,
            "prompt_tokens": lengths + [len(long_prompt)],
            "streams_equal_generate": True,
            "resumed_seq_nos": [1, FD_NEW], "predicts": FD_PREDICTS,
            "predicts_bitwise": True, "predict_timings_ms": timings,
            "ttft_ms_tcp": _p50_p99([got["ttft_ms"][i] for i in keep]),
            "ttft_ms_in_process": _p50_p99(local_ttft),
            "intertoken_ms_tcp": _p50_p99(tcp_gaps),
            "intertoken_ms_in_process": _p50_p99(local_gaps),
            "broken_stream_ttft_ms": got["ttft_ms"][FD_BREAK_PROMPT],
            "launches": counts, "prefill_calls": calls,
            "long_prefill_calls": long_calls,
            "gateway": st, "client_stats": got["client_stats"]}, counts


def phase_fleet(torch, dev, seed):
    """A gateway with one local SLA replica and a FleetPool, one worker
    process on the same card (module docstring, phase 35)."""
    import signal
    import threading
    from mxnet_tpu_torch.serving import (Autoscaler, DeadlineExceeded,
                                         FleetPool, LocalProcessLauncher,
                                         ModelServer)
    from mxnet_tpu_torch.serving.pool import RemoteReplica
    import numpy as np
    sym, weights = sla_weights(seed, n=2)
    rng = np.random.RandomState(seed + 2)
    xs = rng.uniform(-1, 1, (8, SLA_BUCKET, SLA_IN)).astype(np.float32)
    srv = ModelServer(hedge_ms=False, dispatch_retries=3)
    pool = launcher = None
    try:
        srv.register("sla_model", sym, weights[0], ctx=dev,
                     buckets=(SLA_BUCKET,), max_delay_ms=1.0,
                     slack_factor=3.0, shed_margin=2.5,
                     warmup_shapes={"data": (SLA_BUCKET, SLA_IN)})
        local = srv.engine("sla_model")
        pool = FleetPool(srv, host="127.0.0.1", port=0,
                         heartbeat_s=FLEET_HEARTBEAT_S,
                         connect_deadline_s=1.0).start()
        launcher = LocalProcessLauncher(
            "127.0.0.1:%d" % pool.port, "chip_smoke:build_fleet_worker",
            env={"PYTHONPATH": ROOT, SEED_ENV: str(seed),
                 DEVICE_ENV: str(dev)},
            extra_args=["--heartbeat-s", str(FLEET_HEARTBEAT_S)])

        def remote():
            return [r for r in srv._models["sla_model"].versions[1]
                    if isinstance(r.engine, RemoteReplica)]

        def wait_for(cond, what, timeout=FLEET_WAIT_S):
            deadline = time.monotonic() + timeout
            while not cond():
                if time.monotonic() > deadline:
                    fail("fleet: timed out waiting for %s (%s)"
                         % (what, pool.stats()))
                time.sleep(0.01)

        def answers(engine):
            return [engine.predict({"data": x})[0]._data for x in xs]

        def remote_answers(rep):
            return [torch.from_numpy(rep.engine.predict_async(
                {"data": x}).result_wait(WAIT_S)[0]) for x in xs]

        def same(a, b):
            return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

        want0 = answers(local)
        t0 = time.perf_counter()
        proc = launcher.launch()
        wait_for(lambda: len(remote()) == 1 and pool.stats()[
            "workers_alive"] == 1, "the worker's join")
        join_s = time.perf_counter() - t0
        wid = next(iter(pool.workers()))
        if not same(remote_answers(remote()[0]), want0):
            fail("fleet: the worker's answers differ from the local ones")

        # SIGKILL inside an open-loop burst (every request submitted at
        # once, so both replicas hold a queue): nothing lost, the pool
        # sees it go
        base = srv.stats()["sla_model"]["counters"]
        futs, lat = [], []
        for i in range(FLEET_TRAFFIC):
            if i == FLEET_KILL_AT:
                proc.send_signal(signal.SIGKILL)
                t_kill = time.monotonic()
            t_sub = time.monotonic()
            f = srv.predict_async("sla_model", {"data": xs[i % 8]},
                                  deadline_ms=8000.0)
            f.add_done_callback(
                lambda f, t=t_sub: lat.append((time.monotonic() - t) * 1e3))
            futs.append((i % 8, f))
        served = shed = retried = 0
        for k, f in futs:
            try:
                out = f.result_wait(WAIT_S)[0]
            except DeadlineExceeded:
                shed += 1
                continue
            except Exception as e:
                fail("fleet: a request failed across the SIGKILL: %s: %s"
                     % (type(e).__name__, e))
            if not torch.equal(torch.as_tensor(out).cpu(), want0[k].cpu()):
                fail("fleet: an answer across the SIGKILL is wrong")
            served += 1
            retried += f.attempts > 1
        counters = srv.stats()["sla_model"]["counters"]
        if served + shed != FLEET_TRAFFIC or counters["failed"] or \
                counters["submitted"] - base["submitted"] != FLEET_TRAFFIC \
                or counters["submitted"] != counters["served"] \
                + counters["shed"] + counters["failed"]:
            fail("fleet: accounting across the SIGKILL: %d served, %d "
                 "shed; %s" % (served, shed, counters))
        handle = pool._workers[wid]
        wait_for(lambda: handle.state != "alive", "SUSPECT", 30.0)
        t_suspect = time.monotonic() - t_kill
        seen = handle.state
        wait_for(lambda: handle.state == "dead", "DEAD", 30.0)
        t_dead = time.monotonic() - t_kill
        if pool.stats()["suspects"] != 1 or remote():
            fail("fleet: the dead worker is not SUSPECT then DEAD and "
                 "detached: %s" % pool.stats())

        # the floor of one worker: the autoscaler launches a replacement
        asc = Autoscaler(pool.health, launcher, min_workers=1,
                         max_workers=1, cooldown_s=0.0)
        t0 = time.perf_counter()
        if asc.tick() != "up":
            fail("fleet: the autoscaler did not replace the dead worker")
        wait_for(lambda: len(remote()) == 1 and pool.stats()[
            "workers_alive"] == 1, "the replacement's join")
        rejoin_s = time.perf_counter() - t0
        if not same(remote_answers(remote()[0]), want0):
            fail("fleet: the replacement's answers differ from the local")

        # a rollover under traffic reaches both replicas
        results, stop = [], threading.Event()

        def traffic():
            i = 0
            while not stop.is_set() and i < SLA_REQUESTS:
                results.append((i % 8, srv.predict_async(
                    "sla_model", {"data": xs[i % 8]})))
                i += 1
                time.sleep(5e-4)

        thread = threading.Thread(target=traffic, daemon=True)
        thread.start()
        time.sleep(0.05)
        t1 = time.perf_counter()
        srv.rollover("sla_model", weights[1])
        rollover_ms = (time.perf_counter() - t1) * 1e3
        time.sleep(0.05)
        stop.set()
        thread.join(WAIT_S)
        want1 = answers(local)
        if not same(remote_answers(remote()[0]), want1):
            fail("fleet: the worker serves the old weights after rollover")
        n_old = n_new = 0
        for k, f in results:
            out = torch.as_tensor(f.result_wait(WAIT_S)[0]).cpu()
            old, new = torch.equal(out, want0[k].cpu()), torch.equal(
                out, want1[k].cpu())
            if not (old or new):
                fail("fleet: an answer during the rollover is neither "
                     "weight set's")
            n_old += old
            n_new += new and not old
        pstats = pool.stats()
    finally:
        if pool is not None:
            pool.stop()
        if launcher is not None:
            launcher.stop_all(timeout=30.0)
        srv.stop()
    return {"phase": "fleet", "join_s": join_s, "rejoin_s": rejoin_s,
            "failover": {"requests": FLEET_TRAFFIC, "served": served,
                         "shed": shed, "failed": 0, "rerouted": retried,
                         "p50_ms": _pct(lat, 0.50), "p99_ms": _pct(lat, 0.99),
                         "suspect_after_kill_s": t_suspect,
                         "first_state": seen, "dead_after_kill_s": t_dead},
            "rollover_ms": rollover_ms,
            "rollover_answers": {"old": n_old, "new": n_new},
            "pool": {k: pstats[k] for k in ("joins", "rejoins", "rejects",
                                            "suspects", "deads",
                                            "recoveries", "heartbeats")},
            "launches": launcher.launches, "gateway_counters": counters}


# --- the imperative runtime (phases 36 and 37) ------------------------------

#: ResNet-50's Flatten output, where stochastic_fit inserts its Dropout
FLATTEN_OUTPUT = "flatten0_output"
STOCH_STEPS = 4         # stochastic_fit's Module.fit steps a run
STOCH_P = 0.5
CUSTOM_STEPS = 2        # the Custom softmax head's fit
#: the Custom softmax head against SoftmaxOutput: its own gradient (max
#: abs; probabilities in [0, 1]), and the network's (each leaf's relative
#: L2 distance)
CUSTOM_HEAD_TOL = 1e-6
CUSTOM_GRAD_TOL = 1e-2


def imperative_forward(mx, sym, arrays, relu=None):
    """``sym``'s outputs computed op by op as a user does in ``mx.nd``:
    each node is ``getattr(mx.nd, op)(*inputs, **attrs)`` on the NDArrays
    of its inputs (``arrays``: variable name -> NDArray; BatchNorm's aux
    arrays are updated in place). ``relu`` (NDArray -> NDArray) replaces
    every relu ``Activation``. Returns (outputs, mx.nd calls made)."""
    vals, calls = {}, 0
    for node in sym._topo():
        if node.is_variable:
            vals[(id(node), 0)] = arrays[node.name]
            continue
        ins = [vals[(id(i), oi)] for i, oi in node.inputs]
        if relu is not None and node.op.name == "Activation" and \
                node.attrs.get("act_type") == "relu":
            out = relu(ins[0])
        else:
            out = getattr(mx.nd, node.op.name)(*ins, **node.attrs)
        calls += 1
        for i, o in enumerate(out if isinstance(out, list) else [out]):
            vals[(id(node), i)] = o
    return [vals[(id(n), oi)] for n, oi in sym._outputs], calls


def phase_imperative(torch, dev, seed, rtc_state):
    """Full-width ResNet-50 trained imperatively (module docstring, phase
    36). Returns (result, #7's (launches, leaves) by kind, #8's
    launches)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.kernels.opt_update import fused_update_step
    from mxnet_tpu_torch.models import resnet as tres
    t0 = time.perf_counter()
    with mx.name.NameManager():
        sym = tres.get_symbol(num_classes=1000, num_layers=50,
                              image_shape="3,224,224")
    args, aux = resnet_values(torch, sym, dev, seed)
    leaves = [n for n in sym.list_arguments()
              if n not in ("data", "softmax_label")]
    if len(leaves) != 157:
        fail("imperative: %d parameters, want 157" % len(leaves))
    exe = sym.simple_bind(dev, grad_req="write", **RESNET_SHAPES)
    for k, v in args.items():
        exe.arg_dict[k][:] = v
    for k, v in aux.items():
        exe.aux_dict[k][:] = v
    arrays = {k: mx.nd.NDArray(v.clone()) for k, v in {**args,
                                                        **aux}.items()}
    for k in leaves + ["data"]:
        arrays[k].attach_grad()
    setup_s = time.perf_counter() - t0
    prior = _deterministic_cudnn(torch)
    result = {"phase": "imperative", "model": "resnet50",
              "batch": list(RESNET_SHAPES["data"]), "setup_s": setup_s}
    try:
        # (a), (b): one training forward and backward each way
        exe_out = exe.forward(is_train=True)[0]._data.clone()
        exe.backward()
        with mx.autograd.record():
            (out,), calls = imperative_forward(mx, sym, arrays)
        # the input gradient asked for beside the parameters': a pass for
        # the input alone runs other backward kernels (no weight
        # gradients), whose bits need not be the full pass's
        g_all = mx.autograd.grad(out, [arrays[k] for k in ["data"] + leaves],
                                 retain_graph=True)
        g_data = g_all[0]
        out.backward()
        torch.cuda.synchronize()
        same, diff = _bit_diff(torch, out._data, exe_out)
        if not same:
            fail("imperative: the loss output differs from the executor's "
                 "(max abs diff %g)" % diff)
        bad = [k for k in leaves if not _bit_diff(
            torch, arrays[k].grad._data, exe.grad_dict[k]._data)[0]]
        if bad:
            fail("imperative: %d of 157 gradients differ from the "
                 "executor's, e.g. %s" % (len(bad), bad[:3]))
        if not _bit_diff(torch, g_data._data, exe.grad_dict["data"]._data)[0]:
            fail("imperative: autograd.grad's input gradient differs from "
                 "the executor's")
        if not all(_bit_diff(torch, g._data, exe.grad_dict[k]._data)[0]
                   for g, k in zip(g_all[1:], leaves)):
            fail("imperative: autograd.grad's parameter gradients differ "
                 "from the executor's")
        if not _bit_diff(torch, arrays["data"].grad._data,
                         exe.grad_dict["data"]._data)[0]:
            fail("imperative: the data's attached gradient differs")
        # (e): the first backward freed the graph
        try:
            out.backward()
            fail("imperative: a second backward without retain_graph ran")
        except mx.MXNetError as e:
            if "cannot differentiate" not in str(e):
                fail("imperative: a second backward raised %r" % e)
        # the step's walls, the forward's host time a call
        walls = {"imperative": [], "executor": []}
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            with mx.autograd.record():
                (o,), _ = imperative_forward(mx, sym, arrays)
            host.append(time.perf_counter() - ts)
            o.backward()
            torch.cuda.synchronize()
            walls["imperative"].append((time.perf_counter() - ts) * 1e3)
            ts = time.perf_counter()
            exe.forward(is_train=True)
            exe.backward()
            torch.cuda.synchronize()
            walls["executor"].append((time.perf_counter() - ts) * 1e3)
            del o
        result.update({
            "bitwise": True, "nd_calls_per_forward": calls,
            "step_wall_ms": walls,
            "step_wall_ms_p50": {k: statistics.median(v)
                                 for k, v in walls.items()},
            "forward_host_us_per_nd_call": statistics.median(host) * 1e6
            / calls,
            "nd_add_host_us": host_us(
                torch, lambda: mx.nd.elemwise_add(arrays["fc1_bias"],
                                                  arrays["fc1_bias"]))})

        # (c): one mx.nd.sgd_mom_update a leaf against one #7 launch
        gen = torch.Generator(device=dev).manual_seed(seed + 36)
        moms = {k: 0.01 * torch.randn(exe.arg_dict[k].shape, device=dev,
                                      generator=gen) for k in leaves}
        grads = {k: exe.grad_dict[k]._data for k in leaves}
        hp = dict(lr=0.05, wd=1e-4, rescale_grad=1.0 / SYM_BATCH,
                  clip_gradient=5.0)
        fused_p = {k: exe.arg_dict[k]._data.clone() for k in leaves}
        fused_m = {k: v.clone() for k, v in moms.items()}
        torch.cuda.synchronize()
        _reset_opt_counts(tou)
        fused_update_step("sgd", {"lr": hp["lr"], "momentum": 0.9},
                          fused_p, {"mom": fused_m}, grads,
                          rescale=hp["rescale_grad"],
                          clip=hp["clip_gradient"], wd=hp["wd"])
        torch.cuda.synchronize()
        opt = {k: (getattr(tou, "launches_" + k), getattr(tou, "leaves_" + k))
               for k in OPT_KERNELS}
        if opt["sgd_mom"] != (1, 157) or opt["sgd"][0] or opt["adam"][0]:
            fail("imperative: #7 (launches, leaves) %s, want one launch "
                 "of 157 leaves" % opt)
        nd_w = {k: mx.nd.NDArray(exe.arg_dict[k]._data.clone())
                for k in leaves}
        nd_m = {k: mx.nd.NDArray(v.clone()) for k, v in moms.items()}
        ts = time.perf_counter()
        for k in leaves:
            mx.nd.sgd_mom_update(nd_w[k], mx.nd.NDArray(grads[k]), nd_m[k],
                                 out=nd_w[k], momentum=0.9, **hp)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - ts) * 1e3
        bad = [k for k in leaves
               if not (_bit_diff(torch, nd_w[k]._data, fused_p[k])[0]
                       and _bit_diff(torch, nd_m[k]._data, fused_m[k])[0])]
        if bad:
            fail("imperative: sgd_mom_update differs from #7 at %d leaves, "
                 "e.g. %s" % (len(bad), bad[:3]))
        result["sgd_mom_update_vs_7"] = {"leaves": 157, "bitwise": True,
                                         "nd_loop_ms": loop_ms}

        # (d): predict mode, the 50 relus through mx.nd.user_relu (#8)
        user_relu = getattr(mx.nd, "user_relu")
        relu_k = rtc_state["kernel"]
        with mx.autograd.predict_mode():
            (builtin,), _ = imperative_forward(mx, sym, arrays)
            builtin = builtin._data.clone()
            torch.cuda.synchronize()
            relu_k.launches = 0
            (user,), _ = imperative_forward(mx, sym, arrays, relu=user_relu)
            torch.cuda.synchronize()
            relu_launches = relu_k.launches
        if relu_launches != 50:
            fail("imperative: mx.nd.user_relu launched #8 %d times in a "
                 "forward, want 50" % relu_launches)
        same, diff = _bit_diff(torch, user._data, builtin)
        if not same or not torch.isfinite(builtin).all():
            fail("imperative: the user_relu forward differs from the "
                 "built-in one (max abs diff %g)" % diff)
        result["user_relu_forward"] = {"launches": relu_launches,
                                       "bitwise": True}
    finally:
        _restore_cudnn(torch, prior)
    del exe, arrays
    return result, opt, relu_launches


def _stochastic_symbols(mx, tres, p):
    """ResNet-50, and ResNet-50 with Dropout(p) between the flatten and
    fc1 (None: the plain graph), built from the internals' Flatten
    output."""
    with mx.name.NameManager():
        sym = tres.get_symbol(num_classes=1000, num_layers=50,
                              image_shape="3,224,224")
    if p is None:
        return sym
    flat = sym.get_internals()[FLATTEN_OUTPUT]
    fc1 = mx.sym.FullyConnected(mx.sym.Dropout(flat, p=p), num_hidden=1000,
                                name="fc1")
    return mx.sym.SoftmaxOutput(fc1, name="softmax")


def _custom_softmax(mx):
    """The reference example's Python softmax loss layer
    (example/numpy-ops/custom_softmax.py:22-53), registered once."""
    import numpy as np
    if "custom_softmax" in mx.operator.get_all_registered_operators():
        return

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy()
            y[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("custom_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def phase_stochastic_fit(torch, dev, seed):
    """Full-width ResNet-50 with Dropout through Module.fit(kvstore=
    'tpu_sync'), and with a Python softmax head (module docstring, phase
    37). Returns (result, #7's (launches, leaves) by kind on the path)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.models import resnet as tres
    from mxnet_tpu_torch.ops import find_op
    t0 = time.perf_counter()
    plain = _stochastic_symbols(mx, tres, None)
    args, aux = resnet_values(torch, plain, dev, seed)
    arg0 = {k: mx.nd.NDArray(v) for k, v in args.items()
            if k not in ("data", "softmax_label")}
    aux0 = {k: mx.nd.NDArray(v) for k, v in aux.items()}
    rng = np.random.RandomState(seed + 37)
    data = rng.uniform(-1, 1, (STOCH_STEPS * SYM_BATCH, 3, 224, 224)) \
        .astype(np.float32)
    label = rng.randint(0, 1000, STOCH_STEPS * SYM_BATCH).astype(np.float32)
    setup_s = time.perf_counter() - t0
    dropout = find_op("Dropout")
    drop_fn, seen = dropout.fn, []

    def watching_dropout(params, x, is_train=False, rng=None):
        out = drop_fn(params, x, is_train=is_train, rng=rng)
        if is_train and x.device.type == "cuda":
            seen.append((x.detach(), out.detach()))
        return out

    totals = {k: [0, 0] for k in OPT_KERNELS}

    def fit(sym, np_seed, steps=STOCH_STEPS):
        """``steps`` steps of Module.fit(kvstore='tpu_sync') from the same
        params -> (every param and aux state, #7's counts, the synced
        walls of the steps after the first)."""
        it = mx.io.NDArrayIter(data[:steps * SYM_BATCH],
                               label[:steps * SYM_BATCH], SYM_BATCH)
        mod = mx.mod.Module(sym, context=dev)
        np.random.seed(np_seed)
        torch.cuda.synchronize()
        _reset_opt_counts(tou)
        stamps = []

        def on_batch(p):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
            mod.fit(it, kvstore="tpu_sync", optimizer="sgd",
                    optimizer_params=FIT_OPT, arg_params=arg0,
                    aux_params=aux0, num_epoch=1,
                    batch_end_callback=on_batch)
        torch.cuda.synchronize()
        # the steps after the first (which builds the step), synced
        seconds = [b - a for a, b in zip(stamps, stamps[1:])]
        counts = {k: (getattr(tou, "launches_" + k),
                      getattr(tou, "leaves_" + k)) for k in OPT_KERNELS}
        for k, (n, leaves) in counts.items():
            totals[k][0] += n
            totals[k][1] += leaves
        if mod._fused_step is None or counts["sgd_mom"] != (steps,
                                                            157 * steps):
            fail("stochastic_fit: #7 (launches, leaves) %s in %d steps, "
                 "want one launch of 157 leaves a step" % (counts, steps))
        return _fit_state(mod._fused_step), counts, seconds

    prior = _deterministic_cudnn(torch)
    result = {"phase": "stochastic_fit", "model": "resnet50+dropout",
              "batch": list(RESNET_SHAPES["data"]), "steps": STOCH_STEPS,
              "p": STOCH_P, "setup_s": setup_s}
    try:
        drop = _stochastic_symbols(mx, tres, STOCH_P)
        walls = {}
        dropout.fn = watching_dropout
        try:
            a, counts, walls["dropout_watched"] = fit(drop, seed + 1)
        finally:
            dropout.fn = drop_fn
        masks = seen[:]
        seen.clear()
        b, _, walls["dropout"] = fit(drop, seed + 1)
        c, _, _ = fit(drop, seed + 2)
        zero, _, walls["dropout_p0"] = fit(_stochastic_symbols(mx, tres,
                                                              0.0), seed + 3)
        ref, _, walls["plain"] = fit(plain, seed + 3)
        if not _same_state(torch, a, b):
            fail("stochastic_fit: one numpy seed gave other params")
        if _same_state(torch, a, c):
            fail("stochastic_fit: two numpy seeds gave the same params")
        if not _same_state(torch, zero, ref):
            fail("stochastic_fit: Dropout(p=0) differs from the graph "
                 "without it")
        if len(masks) != STOCH_STEPS:
            fail("stochastic_fit: Dropout drew %d times in %d steps"
                 % (len(masks), STOCH_STEPS))
        keep = []
        for x, y in masks:
            live = x != 0
            kept = (y != 0) & live
            n = int(live.sum())
            frac = kept.sum().item() / n
            sigma = math.sqrt(STOCH_P * (1 - STOCH_P) / n)
            if abs(frac - (1 - STOCH_P)) > 5 * sigma:
                fail("stochastic_fit: keep fraction %g of %d, want %g +- 5 "
                     "sigma (%g)" % (frac, n, 1 - STOCH_P, 5 * sigma))
            if not torch.equal(y[kept], x[kept] * 2) or \
                    (y[live & ~kept] != 0).any():
                fail("stochastic_fit: kept values not scaled by exactly 2")
            keep.append(frac)
        # predict mode: the Dropout graph's forward is the plain graph's
        outs = []
        for s in (drop, plain):
            exe = s.simple_bind(dev, grad_req="null", **RESNET_SHAPES)
            for k, v in args.items():
                exe.arg_dict[k][:] = v
            for k, v in aux.items():
                exe.aux_dict[k][:] = v
            outs.append(exe.forward(is_train=False)[0]._data.clone())
            del exe
        if not _bit_diff(torch, outs[0], outs[1])[0]:
            fail("stochastic_fit: predict mode is not the identity")

        # the Python softmax head: gradients against SoftmaxOutput's, then
        # a fit through the fused step (host callbacks on the card)
        _custom_softmax(mx)
        with mx.name.NameManager():
            body = tres.get_symbol(num_classes=1000, num_layers=50,
                                   image_shape="3,224,224")
        fc1 = body.get_internals()["fc1_output"]
        custom = mx.sym.Custom(fc1, mx.sym.Variable("softmax_label"),
                               op_type="custom_softmax", name="softmax")
        grads = []
        for s in (custom, plain):
            exe = s.simple_bind(dev, grad_req="write", **RESNET_SHAPES)
            for k, v in args.items():
                exe.arg_dict[k][:] = v
            for k, v in aux.items():
                exe.aux_dict[k][:] = v
            exe.forward(is_train=True)
            exe.backward()
            grads.append({k: exe.grad_dict[k]._data.clone() for k in arg0})
            del exe
        # the op's own gradient (at its input: softmax - one-hot) against
        # SoftmaxOutput's, imperatively on the same logits: numpy's
        # float32 softmax against torch's on the card
        gen = torch.Generator(device=dev).manual_seed(seed + 37)
        logits = 2 * torch.randn(SYM_BATCH, 1000, device=dev, generator=gen)
        lab = mx.nd.NDArray(torch.randint(0, 1000, (SYM_BATCH,), device=dev,
                                          generator=gen).float())
        head = []
        for op in ("custom", "softmax"):
            x = mx.nd.NDArray(logits.clone())
            x.attach_grad()
            with mx.autograd.record():
                y = (mx.nd.Custom(x, lab, op_type="custom_softmax")
                     if op == "custom" else mx.nd.SoftmaxOutput(x, lab))
            y.backward()
            head.append(x.grad._data.clone())
        head_err = (head[0] - head[1]).abs().max().item()
        if not head_err <= CUSTOM_HEAD_TOL:
            fail("stochastic_fit: the Custom softmax's gradient differs from "
                 "SoftmaxOutput's by %g (tol %g)" % (head_err,
                                                     CUSTOM_HEAD_TOL))
        # through the network, each leaf's relative L2 distance (BatchNorm's
        # backward magnifies the heads' float32 difference)
        rel = {k: (torch.linalg.vector_norm(grads[0][k] - grads[1][k])
                   / torch.linalg.vector_norm(grads[1][k]).clamp_min(
                       1e-30)).item() for k in arg0}
        worst_leaf = max(rel, key=rel.get)
        worst = rel[worst_leaf]
        if not worst <= CUSTOM_GRAD_TOL:
            fail("stochastic_fit: the Custom head's network gradients are "
                 "%g (relative L2, %s) from SoftmaxOutput's (tol %g)"
                 % (worst, worst_leaf, CUSTOM_GRAD_TOL))
        cstate, ccounts, walls["custom_head"] = fit(custom, seed + 4,
                                                    CUSTOM_STEPS)
        if not all(torch.isfinite(t).all() for t in cstate):
            fail("stochastic_fit: the Custom head's fit is not finite")
    finally:
        dropout.fn = drop_fn
        _restore_cudnn(torch, prior)
    result.update({
        # synced after every step (no dispatch overlap), the first step
        # (which builds it) left out; the plain graph in the same call
        "step_wall_ms": {k: [1e3 * x for x in v] for k, v in walls.items()},
        "step_wall_ms_p50": {k: 1e3 * statistics.median(v)
                             for k, v in walls.items()},
        "launches_per_step": counts["sgd_mom"][0] / STOCH_STEPS,
        "leaves_per_step": counts["sgd_mom"][1] / STOCH_STEPS,
        "keep_fraction": keep, "scaled_by_2": True,
        "same_seed_bitwise": True, "other_seed_differs": True,
        "p0_bitwise_plain": True, "predict_identity": True,
        "custom_softmax": {"head_grad_max_abs_err": head_err,
                           "head_tol": CUSTOM_HEAD_TOL,
                           "grad_rel_l2_worst": worst,
                           "grad_rel_l2_worst_leaf": worst_leaf,
                           "grad_rel_l2_median": statistics.median(
                               rel.values()),
                           "tol": CUSTOM_GRAD_TOL, "steps": CUSTOM_STEPS,
                           "launches_per_step": ccounts["sgd_mom"][0]
                           / CUSTOM_STEPS}})
    return result, {k: tuple(v) for k, v in totals.items()}


# --- sequence models: the RNN op, mx.rnn, BucketingModule (phases 38-39) ---
#: the medium PTB LSTM (Zaremba et al. 2014): bptt 35, batch 20, 650 wide,
#: 2 layers, vocabulary 10000, init uniform +-0.05
RNN_T, RNN_N, RNN_H, RNN_L = 35, 20, 650, 2
RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
#: cuDNN against the plain loop: max|a - b| / max|b| over every output and
#: every gradient (float32, 35 steps and 2 layers summed in another order)
RNN_TOL = 1e-4
RNN_DROP_P = 0.5
LM_VOCAB = 10000
LM_INIT = 0.05
LM_STEPS = 4
LM_LR = 0.003
#: the fused LM's first step against its unfused twin: the loss's relative
#: error, and each gradient's relative L2
LM_LOSS_TOL = 1e-5
LM_GRAD_TOL = 1e-4
#: CTC at a speech shape (DeepSpeech-style: 100 frames, 29 characters)
CTC_T, CTC_B, CTC_A, CTC_L = 100, 32, 29, 20
CTC_TOL = 1e-4
#: the reference's example/rnn/lstm_bucketing.py at upstream MXNet's width
BUCKET_LIST = (10, 20, 30, 40)
BUCKET_SENTENCES = 4000
BUCKET_ARGS = ["--num-hidden", "200", "--num-embed", "200", "--num-layers",
               "2", "--batch-size", "32", "--num-epochs", "2"]
BUCKET_TIMED_BATCHES = 24
#: the 6-batch bucketed fit on the card against the CPU: each leaf's
#: relative L2 (Adam amplifies float32 noise where gradients are tiny)
BUCKET_GATE_BUCKETS = (10, 20, 30)
BUCKET_TOL = 1e-4


def _rel_max(torch, got, want):
    """max |got - want| / max |want| over pairs of tensors."""
    return max(((g.double() - w.double()).abs().max()
                / w.double().abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


def _rnn_inputs(torch, tnn, mode, bi, dev, seed, p=0.0):
    d = 2 if bi else 1
    n = tnn.rnn_param_size(mode, RNN_H, RNN_H, RNN_L, bi)
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = 1.0 / math.sqrt(RNN_H)
    inputs = [torch.randn(RNN_T, RNN_N, RNN_H, device=dev, generator=gen),
              (torch.rand(n, device=dev, generator=gen) * 2 - 1) * k]
    for _ in range(2 if mode == "lstm" else 1):
        inputs.append(torch.randn(RNN_L * d, RNN_N, RNN_H, device=dev,
                                  generator=gen))
    params = tnn.RNNParam(state_size=RNN_H, num_layers=RNN_L,
                          bidirectional=bi, mode=mode, state_outputs=True,
                          p=p)
    shapes = [(RNN_T, RNN_N, d * RNN_H)] + [(RNN_L * d, RNN_N, RNN_H)] * (
        len(inputs) - 2)
    cots = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    return params, inputs, cots


def _rnn_fwd_bwd(torch, tnn, params, inputs, cots, route):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = tnn.rnn_forward(params, *xs, route=route)
    grads = torch.autograd.grad(outs, xs, cots)
    return [o.detach() for o in outs] + list(grads)


def _swap_input_forget(tnn, params, blob):
    """The packed blob with every LSTM weight's and bias's i and f gate
    rows swapped: the control of the parity gate."""
    out = blob.clone()
    for dirs in tnn.unpack_rnn_params(out, params.mode, RNN_H, RNN_H,
                                      RNN_L, params.bidirectional):
        for w in (w for ws in dirs for w in ws):
            i_rows = w[:RNN_H].clone()
            w[:RNN_H] = w[RNN_H:2 * RNN_H]
            w[RNN_H:2 * RNN_H] = i_rows
    return out


def _torch_rnn_module(torch, tnn, params, blob):
    """torch.nn's RNN module of the same mode on the same weights, in its
    own contiguous cuDNN layout: the library call beside the op."""
    nn = torch.nn
    kind = {"lstm": nn.LSTM, "gru": nn.GRU}.get(params.mode, nn.RNN)
    kw = {} if params.mode in ("lstm", "gru") else {
        "nonlinearity": params.mode[4:]}
    mod = kind(RNN_H, RNN_H, RNN_L, bidirectional=params.bidirectional,
               **kw).to(blob.device)
    layers = tnn.unpack_rnn_params(blob, params.mode, RNN_H, RNN_H, RNN_L,
                                   params.bidirectional)
    with torch.no_grad():
        for li, dirs in enumerate(layers):
            for di, (wi, wh, bi, bh) in enumerate(dirs):
                sfx = "_l%d%s" % (li, "_reverse" if di else "")
                for name, w in (("weight_ih", wi), ("weight_hh", wh),
                                ("bias_ih", bi), ("bias_hh", bh)):
                    getattr(mod, name + sfx).copy_(w)
    mod.flatten_parameters()
    return mod


def _lm_symbol(mx, fused, p=0.0):
    """The medium PTB LM: Embedding, the fused 2 x 650 LSTM (or the
    network unfuse() builds from it), FullyConnected to the vocabulary,
    SoftmaxOutput. Returns (symbol, the fused cell)."""
    cell = mx.rnn.FusedRNNCell(RNN_H, num_layers=RNN_L, mode="lstm",
                               dropout=p, prefix="lstm_")
    embed = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=LM_VOCAB,
                             output_dim=RNN_H, name="embed")
    body = cell if fused else cell.unfuse()
    out, _ = body.unroll(RNN_T, embed, layout="NTC", merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, RNN_H)),
                                 num_hidden=LM_VOCAB, name="pred")
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label, name="softmax"), cell


def _lm_values(np, seed):
    rng = np.random.RandomState(seed)
    n = RNN_L * 4 * RNN_H * (RNN_H + RNN_H) + RNN_L * 8 * RNN_H
    u = lambda *s: rng.uniform(-LM_INIT, LM_INIT, s).astype(np.float32)
    args = {"embed_weight": u(LM_VOCAB, RNN_H), "lstm_parameters": u(n),
            "pred_weight": u(LM_VOCAB, RNN_H), "pred_bias": u(LM_VOCAB)}
    # rows of arithmetic sequences: the next token follows from the last two
    start = rng.randint(1, LM_VOCAB, (RNN_N, 1))
    step = rng.randint(1, 4, (RNN_N, 1))
    toks = (start + step * np.arange(RNN_T + 1)) % (LM_VOCAB - 1) + 1
    return args, toks[:, :-1].astype(np.float32), \
        toks[:, 1:].astype(np.float32)


def phase_rnn_seq(torch, dev, seed, out_dir):
    """The RNN op on cuDNN against its plain loop, RNN dropout, a fused
    LSTM LM through Module.fit(kvstore='tpu_sync', adam) and CTCLoss at a
    speech shape (module docstring, phase 38). Returns (result, #7's
    (launches, leaves) by kind on the path)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.ops import find_op
    from mxnet_tpu_torch.ops import nn as tnn
    result = {"phase": "rnn_seq", "shape": {"T": RNN_T, "N": RNN_N,
                                            "input": RNN_H, "hidden": RNN_H,
                                            "layers": RNN_L},
              "tol": RNN_TOL}
    prior = _deterministic_cudnn(torch)
    try:
        # (a) parity: cuDNN against the plain loop, every mode, both
        # directions, outputs and the gradients into every input
        modes = {}
        for mode in RNN_MODES:
            for bi in (False, True):
                params, inputs, cots = _rnn_inputs(torch, tnn, mode, bi, dev,
                                                   seed)
                tnn.RNN_COUNTS.update(cudnn=0, plain=0)
                got = _rnn_fwd_bwd(torch, tnn, params, inputs, cots, "cudnn")
                want = _rnn_fwd_bwd(torch, tnn, params, inputs, cots,
                                    "plain")
                if tnn.RNN_COUNTS != {"cudnn": 1, "plain": 1}:
                    fail("rnn_seq: routes ran %s" % tnn.RNN_COUNTS)
                err = _rel_max(torch, got, want)
                if not err <= RNN_TOL:
                    fail("rnn_seq %s bi=%s: cuDNN is %g from the plain loop "
                         "(tol %g)" % (mode, bi, err, RNN_TOL))
                lib = _torch_rnn_module(torch, tnn, params, inputs[1])
                hx = tuple(inputs[2:]) if mode == "lstm" else inputs[2]
                lib_out = lib(inputs[0], hx)[0]
                lib_err = _rel_max(torch, [lib_out.detach()], got[:1])
                row = {"rel_max_err": err, "torch_nn_rel_max_err": lib_err}
                if mode == "lstm":
                    swapped = _swap_input_forget(tnn, params, inputs[1])
                    ctrl = _rnn_fwd_bwd(torch, tnn, params, [inputs[0],
                                        swapped] + inputs[2:], cots,
                                        "plain")
                    row["control_rel_max_err"] = _rel_max(torch, ctrl, got)
                    if not row["control_rel_max_err"] > RNN_TOL:
                        fail("rnn_seq: the i/f-swapped control passes the "
                             "gate (%g)" % row["control_rel_max_err"])
                # forward + backward walls, synced: the op on views into the
                # packed blob (cuDNN copies the weights each call), the plain
                # loop, and torch.nn's module on its own flat weights
                xs = [x.detach().clone().requires_grad_(True)
                      for x in inputs]
                lib_x = inputs[0].detach().clone().requires_grad_(True)

                def op_call(route):
                    return lambda: torch.autograd.grad(
                        tnn.rnn_forward(params, *xs, route=route), xs, cots)

                def lib_call():
                    out, hn = lib(lib_x, hx)
                    hn = list(hn) if isinstance(hn, tuple) else [hn]
                    torch.autograd.grad([out] + hn, [lib_x] + list(
                        lib.parameters()), cots)
                row.update(ms=_synced_ms(torch, op_call("cudnn")),
                           plain_ms=_synced_ms(torch, op_call("plain"), n=3),
                           library_ms=_synced_ms(torch, lib_call))
                row["weight_copy_ms"] = row["ms"] - row["library_ms"]
                modes["%s_%s" % (mode, "bi" if bi else "uni")] = row
                del lib
        result["parity"] = modes
        result["control"] = "lstm i/f gates swapped in the unpacking"

        # the cuDNN kernels one forward + backward runs
        from torch.profiler import ProfilerActivity, profile
        params, inputs, cots = _rnn_inputs(torch, tnn, "lstm", False, dev,
                                           seed)
        with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
            _rnn_fwd_bwd(torch, tnn, params, inputs, cots, "cudnn")
            torch.cuda.synchronize()
        kernels = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(evt.name[:80], [0, 0.0])
                k[0] += 1
                k[1] += evt.time_range.elapsed_us() / 1e3
        rnn_kernels = {k: v for k, v in kernels.items()
                       if "rnn" in k.lower() or "lstm" in k.lower()}
        if not rnn_kernels:
            fail("rnn_seq: the profile shows no cuDNN RNN kernel: %s"
                 % sorted(kernels))
        result["profile_lstm_uni"] = {
            "rnn_kernels": rnn_kernels,
            "device_ms": sum(v[1] for v in kernels.values()),
            "top": sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]}
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "profile_rnn_lstm.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=30))

        # (b) dropout between layers: one numpy seed, the same bits; at
        # inference p changes nothing
        params, inputs, _ = _rnn_inputs(torch, tnn, "lstm", False, dev, seed,
                                        p=RNN_DROP_P)
        plain_p = tnn.RNNParam(**dict(vars(params), p=0.0))

        def dropped(np_seed, p=params, is_train=True):
            np.random.seed(np_seed)
            gen = torch.Generator(device=dev).manual_seed(
                int(np.random.randint(0, 2 ** 31)))
            with torch.no_grad():
                return tnn.rnn_forward(p, *inputs, is_train=is_train,
                                       rng=gen)
        a, b, c = dropped(seed), dropped(seed), dropped(seed + 1)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail("rnn_seq: RNN dropout from one numpy seed differs")
        if torch.equal(a[0], c[0]):
            fail("rnn_seq: two numpy seeds gave the same RNN dropout")
        if not all(torch.equal(x, y) for x, y in zip(
                dropped(seed, is_train=False),
                dropped(seed, plain_p, is_train=False))):
            fail("rnn_seq: RNN dropout changed an inference forward")
        result["dropout"] = {"p": RNN_DROP_P, "same_seed_bitwise": True,
                             "other_seed_differs": True,
                             "inference_unchanged": True}

        # (c) the fused LM through Module.fit: loss falls; its first step
        # against the unfused twin; #7's Adam launches
        args, data, label = _lm_values(np, seed + 38)
        fused_sym, cell = _lm_symbol(mx, True)
        twin_sym, _ = _lm_symbol(mx, False)
        first = {}
        unfused = {k: (v.asnumpy() if hasattr(v, "asnumpy") else v)
                   for k, v in cell.unpack_weights(args).items()}
        for name, sym, vals in (("fused", fused_sym, args),
                                ("unfused", twin_sym, unfused)):
            exe = sym.simple_bind(dev, data=data.shape,
                                  softmax_label=label.shape)
            for k, v in vals.items():
                exe.arg_dict[k][:] = v
            exe.arg_dict["data"][:] = data
            exe.arg_dict["softmax_label"][:] = label
            prob = exe.forward(is_train=True)[0]._data
            exe.backward()
            grads = {k: exe.grad_dict[k].asnumpy() for k in vals}
            if name == "unfused":
                grads = {k: (v.asnumpy() if hasattr(v, "asnumpy") else v)
                         for k, v in cell.pack_weights(grads).items()}
            first[name] = (_cross_entropy(torch, prob, exe.arg_dict[
                "softmax_label"]._data.reshape(-1)).item(), grads)
            del exe
        loss_err = abs(first["fused"][0] - first["unfused"][0]) \
            / abs(first["unfused"][0])
        grad_err = {k: _rel_l2([torch.from_numpy(first["fused"][1][k])],
                               [torch.from_numpy(first["unfused"][1][k])])
                    for k in args}
        if not (loss_err <= LM_LOSS_TOL
                and max(grad_err.values()) <= LM_GRAD_TOL):
            fail("rnn_seq: the fused LM's first step is %g (loss) and %s "
                 "(gradients) from its unfused twin (tol %g, %g)"
                 % (loss_err, grad_err, LM_LOSS_TOL, LM_GRAD_TOL))

        def lm_fit(p, np_seed, steps):
            sym, _ = _lm_symbol(mx, True, p)
            it = mx.io.NDArrayIter(np.tile(data, (steps, 1)),
                                   np.tile(label, (steps, 1)), RNN_N)
            mod = mx.mod.Module(sym, context=dev)
            losses, stamps = [], []
            metric = mx.metric.CrossEntropy()

            def on_batch(cb):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                losses.append(float(cb.eval_metric.get()[1]))
                cb.eval_metric.reset()
            np.random.seed(np_seed)
            with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
                mod.fit(it, eval_metric=metric, kvstore="tpu_sync",
                        optimizer="adam",
                        optimizer_params={"learning_rate": LM_LR},
                        arg_params={k: mx.nd.array(v, ctx=dev)
                                    for k, v in args.items()},
                        num_epoch=1, batch_end_callback=on_batch)
            torch.cuda.synchronize()
            if mod._fused_step is None:
                fail("rnn_seq: the LM's fit built no fused step")
            state = [mod._fused_step.params[n].detach().clone()
                     for n in mod._fused_step.param_names]
            return losses, state, [b - a for a, b in zip(stamps,
                                                          stamps[1:])]
        tnn.RNN_COUNTS.update(cudnn=0, plain=0)
        _reset_opt_counts(tou)
        losses, _, walls = lm_fit(0.0, seed, LM_STEPS)
        counts = {k: (getattr(tou, "launches_" + k),
                      getattr(tou, "leaves_" + k)) for k in OPT_KERNELS}
        routes = dict(tnn.RNN_COUNTS)
        if counts["adam"] != (LM_STEPS, 4 * LM_STEPS) or \
                counts["sgd"][0] or counts["sgd_mom"][0]:
            fail("rnn_seq: #7 counts %s in %d Adam steps, want one launch "
                 "of 4 leaves a step" % (counts, LM_STEPS))
        if routes["plain"] or routes["cudnn"] < LM_STEPS:
            fail("rnn_seq: the LM's RNN ran %s" % routes)
        if not all(b < a for a, b in zip(losses, losses[1:])):
            fail("rnn_seq: the LM's loss did not fall step by step: %s"
                 % losses)
        # the same fit with dropout 0.5, twice from one numpy seed
        _, s1, _ = lm_fit(RNN_DROP_P, seed + 5, 2)
        _, s2, _ = lm_fit(RNN_DROP_P, seed + 5, 2)
        if not all(torch.equal(x, y) for x, y in zip(s1, s2)):
            fail("rnn_seq: the dropout LM's fit is not reproducible from "
                 "one numpy seed")
        drop_counts = {k: (getattr(tou, "launches_" + k) - counts[k][0],
                           getattr(tou, "leaves_" + k) - counts[k][1])
                       for k in OPT_KERNELS}
        result["lm"] = {
            "vocab": LM_VOCAB, "embed": RNN_H, "hidden": RNN_H,
            "layers": RNN_L, "bptt": RNN_T, "batch": RNN_N, "lr": LM_LR,
            "steps": LM_STEPS, "losses": losses,
            "step_wall_ms": [1e3 * w for w in walls],
            "first_step_loss_rel_err": loss_err,
            "first_step_grad_rel_l2": grad_err,
            "loss_tol": LM_LOSS_TOL, "grad_tol": LM_GRAD_TOL,
            "rnn_routes": routes, "adam_launches": counts["adam"][0],
            "dropout_fit_bitwise": True}
        totals = {k: (counts[k][0] + drop_counts[k][0],
                      counts[k][1] + drop_counts[k][1]) for k in OPT_KERNELS}

        # (d) CTC at a speech shape: the card against the CPU, loss and
        # gradient; torch's ctc_loss timed beside it
        gen = torch.Generator().manual_seed(seed + 39)
        acts = 2 * torch.randn(CTC_T, CTC_B, CTC_A, generator=gen)
        lab_len = torch.randint(5, CTC_L + 1, (CTC_B,), generator=gen)
        labels = torch.randint(1, CTC_A, (CTC_B, CTC_L), generator=gen)
        labels[torch.arange(CTC_L)[None, :] >= lab_len[:, None]] = 0
        data_len = torch.randint(CTC_T * 3 // 5, CTC_T + 1, (CTC_B,),
                                 generator=gen)
        cot = torch.randn(CTC_B, generator=gen)
        ctc = find_op("CTCLoss")
        cp = ctc.make_params({"use_data_lengths": True,
                              "use_label_lengths": True})

        def ctc_run(where):
            x = acts.to(where).requires_grad_(True)
            ins = [x] + [t.float().to(where) for t in (labels, data_len,
                                                       lab_len)]
            loss = ctc.apply(cp, ins)[0]
            return loss.detach(), torch.autograd.grad(loss, x,
                                                      cot.to(where))[0]
        card = ctc_run(dev)
        t0 = time.perf_counter()
        host = ctc_run("cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        ctc_err = _rel_max(torch, [t.cpu() for t in card], list(host))
        if not ctc_err <= CTC_TOL:
            fail("rnn_seq: CTC on the card is %g from the CPU (tol %g)"
                 % (ctc_err, CTC_TOL))
        x_lib = acts.to(dev).requires_grad_(True)

        def lib_ctc():
            loss = torch.nn.functional.ctc_loss(
                torch.log_softmax(x_lib, -1), labels.to(dev),
                data_len.to(dev), lab_len.to(dev), blank=0,
                reduction="none")
            return loss, torch.autograd.grad(loss, x_lib, cot.to(dev))[0]
        lib_loss = lib_ctc()[0].detach().cpu()
        result["ctc"] = {
            "shape": {"T": CTC_T, "B": CTC_B, "A": CTC_A,
                      "max_label": CTC_L},
            "rel_max_err_card_vs_cpu": ctc_err, "tol": CTC_TOL,
            "ms": _synced_ms(torch, lambda: ctc_run(dev), n=5),
            "cpu_ms": cpu_ms, "library_ms": _synced_ms(torch, lib_ctc),
            # torch's ctc_loss on these (all feasible) sequences
            "library_loss_rel_max_err": _rel_max(torch, [lib_loss],
                                                 [host[0]])}
    finally:
        _restore_cudnn(torch, prior)
    return result, totals


def _bucket_sym_gen(mx, vocab_size, num_hidden, num_embed, num_layers):
    """lstm_bucketing.py's lm_sym_gen, line for line."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size,
                                 output_dim=num_embed, name="embed")
        stack = mx.rnn.SequentialRNNCell()
        for i in range(num_layers):
            stack.add(mx.rnn.LSTMCell(num_hidden=num_hidden,
                                      prefix="lstm_l%d_" % i))
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab_size,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax",
                                    use_ignore=True, ignore_label=0)
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def bucket_corpus(np, seed, n=BUCKET_SENTENCES):
    """Sentences over a 10000-token vocabulary, lengths spread over the
    buckets: rows of arithmetic token sequences, as the example's own
    synthetic corpus makes them."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        length = int(rng.choice(BUCKET_LIST)) - rng.randint(0, 10)
        start = rng.randint(1, LM_VOCAB)
        step = rng.randint(1, 4)
        lines.append(" ".join("w%d" % ((start + step * k) % (LM_VOCAB - 1))
                              for k in range(max(2, length))))
    return lines


def phase_bucketing_fit(torch, dev, seed, tmp):
    """The reference's example/rnn/lstm_bucketing.py unchanged through the
    launcher, per-bucket step times, and a bucketed fit on the card
    against the CPU (module docstring, phase 39). Returns (result, #7's
    (launches, leaves) by kind on the path)."""
    import re
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.ops import nn as tnn
    result = {"phase": "bucketing_fit"}
    lines = bucket_corpus(np, seed + 39)
    corpus = os.path.join(tmp, "bucket_corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(lines) + "\n")
    # (a) the example, unchanged
    out, counts, seconds = _run_script(
        torch, "rnn/lstm_bucketing.py", BUCKET_ARGS,
        {"CORPUS": corpus, "MXNET_TPU_FUSED_OPTUPDATE": "1"}, tmp)
    ppl = [float(v) for v in re.findall(
        r"Epoch\[\d+\] Train-perplexity=([0-9.]+)", out)]
    val = [float(v) for v in re.findall(
        r"Epoch\[\d+\] Validation-perplexity=([0-9.]+)", out)]
    if len(ppl) != 2 or not ppl[1] < ppl[0]:
        fail("bucketing_fit: Train-perplexity %s, want 2 epochs falling "
             "(tests/python/unittest/test_examples.py:179-182)" % ppl)
    if "fused train step active" not in out or counts["adam"][0] < 1:
        fail("bucketing_fit: no fused step or no #7 Adam launch: %s"
             % counts)
    totals = {k: list(counts[k]) for k in OPT_KERNELS}
    result["script"] = {"args": BUCKET_ARGS, "sentences": len(lines),
                        "seconds": seconds, "train_perplexity": ppl,
                        "validation_perplexity": val,
                        "adam_launches": counts["adam"][0],
                        "adam_leaves": counts["adam"][1]}

    sents, vocab = mx.rnn.encode_sentences([s.split() for s in lines],
                                           start_label=1, invalid_label=0)
    vocab_size = max(vocab.values()) + 1
    sym_gen = _bucket_sym_gen(mx, vocab_size, 200, 200, 2)

    def bucketed(ctx, it, limit=None, skip=None, timed=False, args=None):
        mod = mx.mod.BucketingModule(sym_gen,
                                     default_bucket_key=it.default_bucket_key,
                                     context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        if args is None:
            mod.init_params(mx.init.Xavier())
        else:
            mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                        for k, v in args.items()},
                            aux_params={})
        mod.init_optimizer(kvstore="tpu_sync", optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
        walls, device, keys = {}, {}, []
        for i, batch in enumerate(it):
            if i == limit:
                break
            if i == skip:
                continue
            keys.append(batch.bucket_key)
            if timed:
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                t0 = time.perf_counter()
                start.record()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            if timed:
                end.record()
                torch.cuda.synchronize()
                walls.setdefault(batch.bucket_key, []).append(
                    1e3 * (time.perf_counter() - t0))
                device.setdefault(batch.bucket_key, []).append(
                    start.elapsed_time(end))
        return mod, keys, walls, device

    # (b) per-bucket step times at the script's width, and each bucket's
    # update path
    with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
        _reset_opt_counts(tou)
        it = mx.rnn.BucketSentenceIter(sents, 32, buckets=list(BUCKET_LIST),
                                       invalid_label=0, shuffle_seed=1)
        mod, keys, walls, events = bucketed(dev, it, BUCKET_TIMED_BATCHES,
                                            timed=True)
        timed_counts = _opt_counts(tou)
        # device time a step by bucket: the kernels one more step of each
        # bucket runs, traced
        from torch.profiler import ProfilerActivity, profile
        it.reset()
        seen, device_ms = set(), {}
        for batch in it:
            if batch.bucket_key in seen:
                continue
            seen.add(batch.bucket_key)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
                torch.cuda.synchronize()
            device_ms[str(batch.bucket_key)] = sum(
                e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        step_counts = _opt_counts(tou)
        paths = {str(k): ("fused step (#7)" if m._fused_step is not None
                          else "per-parameter updater")
                 for k, m in sorted(mod._buckets.items())}
        for k in OPT_KERNELS:
            totals[k][0] += getattr(tou, "launches_" + k)
            totals[k][1] += getattr(tou, "leaves_" + k)
    del mod
    result["per_bucket"] = {
        "batches": keys,
        "step_wall_ms_p50": {str(k): statistics.median(v[1:] or v)
                             for k, v in walls.items()},
        "step_event_ms_p50": {str(k): statistics.median(v[1:] or v)
                              for k, v in events.items()},
        "step_device_ms": device_ms, "update_path": paths,
        "adam_launches": step_counts["adam"],
        "adam_launches_timed_run": timed_counts["adam"]}
    # the default bucket's module (whose init_optimizer ran) builds the
    # fused step; the others update through the shared updater (the
    # reference's split, ROADMAP §C)
    if paths != {
            k: ("fused step (#7)" if k == str(max(BUCKET_LIST))
                else "per-parameter updater") for k in paths} or \
            len(paths) != len(BUCKET_LIST):
        fail("bucketing_fit: update paths %s" % paths)

    # (c) a 6-batch fit over 3 buckets: the card against the CPU; the
    # control leaves one batch out
    rng = np.random.RandomState(seed + 40)
    gate_sents = [list(rng.randint(1, vocab_size, n - rng.randint(0, 5)))
                  for n in BUCKET_GATE_BUCKETS for _ in range(64)]
    shapes = sym_gen(max(BUCKET_GATE_BUCKETS))[0].infer_shape(
        data=(32, max(BUCKET_GATE_BUCKETS)),
        softmax_label=(32, max(BUCKET_GATE_BUCKETS)))[0]
    names = sym_gen(max(BUCKET_GATE_BUCKETS))[0].list_arguments()
    init = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(names, shapes)
            if n not in ("data", "softmax_label")}
    fits = {}
    with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
        for name, ctx, skip in (("card", dev, None),
                                ("cpu", mx.cpu(), None),
                                ("control", mx.cpu(), 3)):
            _reset_opt_counts(tou)
            it = mx.rnn.BucketSentenceIter(
                gate_sents, 32, buckets=list(BUCKET_GATE_BUCKETS),
                invalid_label=0, shuffle_seed=2)
            mod, keys, _, _ = bucketed(ctx, it, skip=skip, args=init)
            params = mod.get_params()[0]
            fits[name] = ({k: torch.from_numpy(v.asnumpy())
                           for k, v in params.items()}, keys)
            if name == "card":
                for k in OPT_KERNELS:
                    totals[k][0] += getattr(tou, "launches_" + k)
                    totals[k][1] += getattr(tou, "leaves_" + k)
    card, keys = fits["card"]
    if len(keys) != 6 or len(set(keys)) != 3 or keys != fits["cpu"][1]:
        fail("bucketing_fit: the gate's batches %s / %s" % (
            keys, fits["cpu"][1]))
    gate = {k: _rel_l2([card[k]], [fits["cpu"][0][k]]) for k in card}
    ctrl = {k: _rel_l2([fits["control"][0][k]], [fits["cpu"][0][k]])
            for k in card}
    if not max(gate.values()) <= BUCKET_TOL:
        fail("bucketing_fit: the card's fit is %s (relative L2) from the "
             "CPU's (tol %g)" % (gate, BUCKET_TOL))
    if not max(ctrl.values()) > BUCKET_TOL:
        fail("bucketing_fit: the control (one batch left out) passes the "
             "gate: %s" % ctrl)
    result["card_vs_cpu"] = {"buckets": list(BUCKET_GATE_BUCKETS),
                             "batches": keys, "rel_l2": gate,
                             "control_rel_l2_max": max(ctrl.values()),
                             "tol": BUCKET_TOL}
    result["rnn_routes"] = dict(tnn.RNN_COUNTS)
    return result, {k: tuple(v) for k, v in totals.items()}


SSD_CLASSES = 20        # VOC: 20 classes plus the background
SSD_BATCH = 32
SSD_SIDE = 300
SSD_OBJECTS = 8         # SyntheticDetIter's label rows (padding -1)
SSD_OPT = {"learning_rate": 0.004, "momentum": 0.9, "wd": 5e-4}
SSD_EPOCH = 4           # ssd_fit (a): 4 epochs over 4 synthetic batches
SSD_EPOCHS = 4
SSD_SCRIPT_ARGS = ["--tpus", "0", "--batch-size", "32", "--data-shape",
                   "300", "--epochs", "1", "--num-batches", "8"]
DET_TOL = 1e-5          # boxes, targets and scores: card against CPU
OPS_TOL = 1e-4          # the other families: |card - CPU| / max(1, |CPU|)
IMG_TOL = 1e-3          # images on the [0, 255] scale
NARROW_BATCH = 4
NARROW_SIDE = 64
NARROW_CLASSES = 3
NARROW_STEPS = 3
NARROW_TOL = 1e-4       # ssd_fit (b): each leaf's relative L2


def ssd_example(mx):
    """The reference's example/ssd files, unchanged: its symbol package
    (symbol_builder, common, vgg16_reduced), train/metric.py and
    dataset/iterator.py, loaded under names of their own with
    ``mxnet_tpu`` (and ``mxnet_tpu.io``) bound to ``mx`` while they
    import."""
    import importlib
    import importlib.util
    base = os.path.join(ROOT, "example", "ssd")
    names = ("mxnet_tpu", "mxnet_tpu.io")
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update({"mxnet_tpu": mx, "mxnet_tpu.io": mx.io})
    out = {}
    try:
        for key, rel, pkg in (("symbol", "symbol/__init__.py", True),
                              ("metric", "train/metric.py", False),
                              ("iterator", "dataset/iterator.py", False)):
            path = os.path.join(base, rel)
            name = "chip_smoke_ssd_" + key
            spec = importlib.util.spec_from_file_location(
                name, path, submodule_search_locations=[
                    os.path.dirname(path)] if pkg else None)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            out[key] = mod
        for sub in ("symbol_builder", "vgg16_reduced"):
            out[sub] = importlib.import_module("chip_smoke_ssd_symbol."
                                               + sub)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    return out


def narrow_backbone(mx):
    """A stand-in for vgg16_reduced.get_symbol: three small conv blocks,
    relu4_3's tap at 1/4 of the input (16 channels), relu7's at 1/8 (32)."""
    def get_symbol(num_classes=1000, **kwargs):
        body = mx.sym.Variable(name="data")
        taps = []
        for i, (filters, pool) in enumerate(((8, True), (16, True),
                                             (32, False))):
            if i == 2:
                body = mx.sym.Pooling(data=body, pool_type="max",
                                      kernel=(2, 2), stride=(2, 2),
                                      name="pool_b%d" % i)
            body = mx.sym.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                      num_filter=filters,
                                      name="conv_b%d" % i)
            body = mx.sym.Activation(data=body, act_type="relu",
                                     name="relu_b%d" % i)
            if pool:
                body = mx.sym.Pooling(data=body, pool_type="max",
                                      kernel=(2, 2), stride=(2, 2),
                                      name="pool_a%d" % i)
            taps.append(body)
        return taps[1], taps[2]
    return get_symbol


def _max_err(torch, got, want):
    """``scaled_err`` over lists of tensors (of any device), the max."""
    return max((scaled_err(g.detach().double().cpu(),
                           w.detach().double().cpu())
                for g, w in zip(got, want) if w.numel()), default=0.0)


def _same(torch, got, want):
    return all(torch.equal(g.detach().cpu(), w.detach().cpu())
               for g, w in zip(got, want))


def detection_battery(np, rng):
    """The other families' ops at detection-sized inputs: (name, op,
    numpy inputs, attrs, inputs whose gradient is held, tolerance or
    "exact")."""
    def f(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def rois(n, side=600.0):
        xy = rng.uniform(0, side * 0.7, (n, 2))
        wh = rng.uniform(16, side * 0.3, (n, 2))
        return np.concatenate([rng.randint(0, 2, (n, 1)), xy, xy + wh],
                              axis=1).astype(np.float32)

    def tri(n, b):
        a = f(b, n, n, lo=-0.5, hi=0.5) + 4.0 * np.eye(n, dtype=np.float32)
        return np.tril(a)

    spd = f(8, 32, 32)
    spd = (spd @ spd.transpose(0, 2, 1) + 32 * np.eye(32)).astype(
        np.float32)
    boxes = np.concatenate([f(400, 2, lo=0, hi=0.7), f(400, 2, lo=0,
                                                        hi=0.7) + 0.3], 1)
    img = rng.uniform(0, 255, (8, 300, 300, 3)).astype(np.float32)
    scale = {"spatial_scale": 0.0625}
    return [
        ("roi_pooling", "ROIPooling", [f(2, 8, 38, 38), rois(32)],
         dict(scale, pooled_size=(7, 7)), (0,), OPS_TOL),
        ("roi_align", "_contrib_ROIAlign", [f(2, 16, 38, 38), rois(64)],
         dict(scale, pooled_size=(7, 7), sample_ratio=2), (0,), OPS_TOL),
        ("psroi_pooling", "_contrib_PSROIPooling",
         [f(2, 18, 38, 38), rois(64)],
         dict(scale, output_dim=2, pooled_size=3), (0,), OPS_TOL),
        ("deformable_psroi_pooling", "_contrib_DeformablePSROIPooling",
         [f(2, 18, 38, 38), rois(64), f(64, 18, lo=-0.5, hi=0.5)],
         dict(scale, output_dim=2, group_size=3, pooled_size=3,
              part_size=3, sample_per_part=2, trans_std=0.1), (0, 2),
         OPS_TOL),
        ("deformable_convolution", "_contrib_DeformableConvolution",
         [f(2, 16, 19, 19), f(2, 18, 19, 19), f(32, 16, 3, 3, lo=-0.1,
                                                 hi=0.1), f(32)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 32}, (0, 1, 2),
         OPS_TOL),
        ("multi_proposal", "_contrib_MultiProposal",
         [f(2, 24, 19, 19, lo=0, hi=1), f(2, 48, 19, 19, lo=-0.1, hi=0.1),
          np.array([[304, 304, 1.0]] * 2, np.float32)],
         {"rpn_pre_nms_top_n": 2000, "rpn_post_nms_top_n": 100,
          "feature_stride": 16}, (), OPS_TOL),
        ("box_iou", "_contrib_box_iou", [boxes[:300], boxes[100:]], {},
         (0, 1), DET_TOL),
        ("bipartite_matching", "_contrib_bipartite_matching",
         [f(8, 64, 48, lo=0, hi=1)], {"threshold": 0.2}, (), "exact"),
        ("bilinear_sampler", "BilinearSampler",
         [f(4, 16, 38, 38), f(4, 2, 38, 38, lo=-1.1, hi=1.1)], {}, (0, 1),
         OPS_TOL),
        ("spatial_transformer", "SpatialTransformer",
         [f(4, 16, 38, 38), np.array([[1.0, 0.1, 0.05, -0.1, 0.9, 0.0]] * 4,
                                     np.float32)],
         {"transform_type": "affine", "sampler_type": "bilinear",
          "target_shape": (32, 32)}, (0, 1), OPS_TOL),
        ("grid_generator_warp", "GridGenerator", [f(4, 2, 38, 38)],
         {"transform_type": "warp"}, (0,), OPS_TOL),
        ("correlation", "Correlation", [f(2, 16, 24, 24), f(2, 16, 24, 24)],
         {"max_displacement": 4, "pad_size": 4}, (0, 1), OPS_TOL),
        ("correlation1d", "Correlation1D",
         [f(2, 16, 24, 48), f(2, 16, 24, 48)],
         {"max_displacement": 8, "pad_size": 8}, (0, 1), OPS_TOL),
        ("bilinear_resize", "_contrib_BilinearResize2D", [f(4, 16, 19, 19)],
         {"height": 38, "width": 38}, (0,), OPS_TOL),
        ("adaptive_avg_pool", "_contrib_AdaptiveAvgPooling2D",
         [f(4, 16, 38, 38)], {"output_size": (7, 7)}, (0,), OPS_TOL),
        ("crop", "Crop", [f(4, 16, 38, 38)],
         {"h_w": (32, 32), "center_crop": True}, (0,), OPS_TOL),
        ("pooling_4d", "Pooling", [f(2, 4, 8, 8, 8, 8)],
         {"kernel": (2, 2, 2, 2), "stride": (2, 2, 2, 2)}, (0,), OPS_TOL),
        ("lsoftmax_train", "LSoftmax",
         [f(64, 128), f(100, 128), rng.randint(0, 100, 64).astype(
             np.float32)], {"num_hidden": 100, "margin": 2}, (0, 1),
         OPS_TOL),
        ("multi_logistic", "MultiLogistic",
         [f(64, 100, lo=-3, hi=3), (f(64, 100) > 0).astype(np.float32)],
         {"weight": 3.0}, (0,), OPS_TOL),
        ("weighted_l1", "WeightedL1", [f(64, 100), f(64, 100)], {}, (0,),
         OPS_TOL),
        ("kl_sparse_reg", "IdentityAttachKLSparseReg",
         [f(64, 256, lo=0.05, hi=0.95), f(256, lo=0.05, hi=0.3)], {}, (0,),
         OPS_TOL),
        ("count_sketch", "_contrib_count_sketch",
         [f(64, 512), rng.randint(0, 128, (1, 512)).astype(np.float32),
          np.sign(f(1, 512))], {"out_dim": 128}, (0,), OPS_TOL),
        ("khatri_rao", "khatri_rao", [f(8, 16), f(6, 16)], {}, (0, 1),
         OPS_TOL),
        ("linalg_gemm", "linalg_gemm", [f(8, 64, 48), f(8, 48, 32),
                                        f(8, 64, 32)],
         {"alpha": 0.5, "beta": 2.0}, (0, 1, 2), OPS_TOL),
        ("linalg_trsm", "linalg_trsm", [tri(32, 8), f(8, 32, 16)],
         {"alpha": 2.0}, (0, 1), OPS_TOL),
        ("linalg_trmm", "linalg_trmm", [tri(32, 8), f(8, 16, 32)],
         {"rightside": True, "transpose": True}, (0, 1), OPS_TOL),
        ("linalg_potri", "linalg_potri",
         [np.linalg.cholesky(spd).astype(np.float32)], {}, (0,), OPS_TOL),
        ("linalg_sumlogdiag", "linalg_sumlogdiag", [spd], {}, (0,),
         OPS_TOL),
        ("linalg_makediag", "linalg_makediag", [f(8, 32)], {"offset": 1},
         (0,), OPS_TOL),
        ("image_flip", "_image_flip_left_right", [img], {}, (), "exact"),
        ("image_hue", "_image_random_hue", [img],
         {"min_factor": 0.1, "max_factor": 0.1}, (), IMG_TOL),
        ("image_lighting", "_image_adjust_lighting", [img],
         {"alpha": (0.1, -0.2, 0.05)}, (), IMG_TOL),
        ("image_contrast", "_image_random_contrast", [img],
         {"min_factor": 0.6, "max_factor": 0.6}, (), IMG_TOL),
    ]


def _run_op(torch, op, arrays, attrs, grad, device, seed):
    """The op on ``device``: (outputs, gradients of the first output for a
    seeded cotangent)."""
    import numpy as np
    ins = [torch.from_numpy(a).to(device) for a in arrays]
    for i in grad:
        ins[i].requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(seed) \
        if op.need_rng else None
    with torch.set_grad_enabled(bool(grad)):
        outs = op.apply(op.make_params(dict(attrs)), ins, is_train=True,
                        rng=gen)
    grads = []
    if grad:
        cot = torch.from_numpy(np.random.RandomState(seed).standard_normal(
            tuple(outs[0].shape)).astype(np.float32)).to(device)
        grads = list(torch.autograd.grad(outs[0], [ins[i] for i in grad],
                                         cot))
    return [o.detach() for o in outs], grads


def phase_detection_ops(torch, dev, seed):
    """The slice's op families on the card against the same ops on CPU
    tensors (module docstring, phase 40). Returns the result."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import OPS
    cpu = torch.device("cpu")
    card = str(dev)
    result = {"phase": "detection_ops"}
    ex = ssd_example(mx)
    sb = ex["symbol_builder"]
    with mx.name.NameManager():
        net = sb.get_symbol_train(SSD_CLASSES)
    shapes = {"data": (SSD_BATCH, 3, SSD_SIDE, SSD_SIDE),
              "label": (SSD_BATCH, SSD_OBJECTS, 5)}
    internals = net.get_internals()
    taps = ["relu4_3_output", "relu7_output"] + [
        "multi_feat_%d_conv_3x3_relu_output" % k for k in range(2, 6)]
    maps = mx.sym.Group([internals[t] for t in taps]).infer_shape(
        data=shapes["data"])[1]
    n_anchors = internals["multibox_anchors_output"].infer_shape(
        data=shapes["data"])[1][0][1]

    # (1) anchors of the six scales, card against CPU
    prior = OPS["_contrib_MultiBoxPrior"]
    anchors = {}
    for device in (dev, cpu):
        anchors[str(device)] = torch.cat([prior.apply(prior.make_params(
            {"sizes": sb.DEFAULT_SIZES[k], "ratios": sb.DEFAULT_RATIOS[k]}),
            [torch.zeros((1, 1) + tuple(m[2:]), device=device)])[0]
            for k, m in enumerate(maps)], dim=1)
    if anchors[card].shape != (1, n_anchors, 4):
        fail("detection_ops: anchors %s, the graph has %d"
             % (tuple(anchors[card].shape), n_anchors))
    prior_err = _max_err(torch, [anchors[card]], [anchors["cpu"]])
    if not prior_err <= DET_TOL:
        fail("detection_ops: MultiBoxPrior is %g from the CPU's" % prior_err)
    result["anchors"] = {"count": n_anchors, "maps": [list(m[2:])
                                                      for m in maps],
                         "max_abs_err": prior_err}

    # (2) MultiBoxTarget at SSD-300's shapes, the train graph's params
    rng = np.random.RandomState(seed + 41)
    it = ex["iterator"].SyntheticDetIter(
        SSD_BATCH, data_shape=(3, SSD_SIDE, SSD_SIDE),
        num_classes=SSD_CLASSES, num_batches=1, seed=seed)
    label = it.next().label[0].asnumpy()
    cls_pred = rng.standard_normal((SSD_BATCH, SSD_CLASSES + 1,
                                    n_anchors)).astype(np.float32)
    target = OPS["_contrib_MultiBoxTarget"]
    tgt_attrs = {"overlap_threshold": 0.5, "ignore_label": -1.0,
                 "negative_mining_ratio": 3.0,
                 "minimum_negative_samples": 0,
                 "negative_mining_thresh": 0.5,
                 "variances": (0.1, 0.1, 0.2, 0.2)}

    def run_target(device, **over):
        ins = [anchors[str(device)], torch.from_numpy(label).to(device),
               torch.from_numpy(cls_pred).to(device)]
        return target.apply(target.make_params(dict(tgt_attrs, **over)),
                            ins)
    t_card, t_cpu = run_target(dev), run_target(cpu)
    t_err = _max_err(torch, t_card[:1], t_cpu[:1])
    if not (_same(torch, t_card[1:], t_cpu[1:]) and t_err <= DET_TOL):
        fail("detection_ops: MultiBoxTarget: masks/classes equal %s, "
             "box_target err %g" % (_same(torch, t_card[1:], t_cpu[1:]),
                                    t_err))
    ctrl_var = _max_err(torch, run_target(dev, variances=(
        0.2, 0.2, 0.1, 0.1))[:1], t_cpu[:1])
    ctrl_mining = _same(torch, run_target(dev, negative_mining_ratio=2.0)[
        2:], t_cpu[2:])
    if not ctrl_var > DET_TOL or ctrl_mining:
        fail("detection_ops: a MultiBoxTarget control passes: reversed "
             "variances err %g, mining ratio 2 classes equal %s"
             % (ctrl_var, ctrl_mining))
    cls_t = t_cpu[2]
    result["multibox_target"] = {
        "max_abs_err": t_err, "classes_equal": True,
        "control_variances_reversed_err": ctrl_var,
        "control_mining_ratio_2_classes_equal": ctrl_mining,
        "positives": int((cls_t > 0).sum()),
        "negatives": int((cls_t == 0).sum()),
        "ignored": int((cls_t == -1).sum()),
        "wall_ms": _synced_ms(torch, lambda: run_target(dev), n=5),
        "device_ms": profile_calls(torch, lambda: run_target(dev),
                                   "multibox_target", None, warm=1, n=2,
                                   calls=4)["device_ms"],
        "cpu_wall_ms": _synced_ms(torch, lambda: run_target(cpu), n=2)}

    # (3) MultiBoxDetection as the train graph runs it
    logits = rng.standard_normal((SSD_BATCH, SSD_CLASSES + 1,
                                  n_anchors)).astype(np.float32) * 3.0
    cls_prob = np.exp(logits - logits.max(axis=1, keepdims=True))
    cls_prob = (cls_prob / cls_prob.sum(axis=1, keepdims=True)).astype(
        np.float32)
    loc = (rng.standard_normal((SSD_BATCH, n_anchors * 4)) * 0.2).astype(
        np.float32)
    detect = OPS["_contrib_MultiBoxDetection"]
    det_attrs = {"nms_threshold": 0.5, "force_suppress": False,
                 "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": 400}

    def run_detect(device, **over):
        ins = [torch.from_numpy(cls_prob).to(device),
               torch.from_numpy(loc).to(device), anchors[str(device)]]
        return detect.apply(detect.make_params(dict(det_attrs, **over)),
                            ins)[0]
    d_card, d_cpu = run_detect(dev), run_detect(cpu)
    ids_equal = _same(torch, [d_card[..., 0]], [d_cpu[..., 0]])
    d_err = _max_err(torch, [d_card[..., 1:]], [d_cpu[..., 1:]])
    if not (ids_equal and d_err <= DET_TOL):
        fail("detection_ops: MultiBoxDetection: ids equal %s, err %g"
             % (ids_equal, d_err))
    ctrl_det = _max_err(torch, [run_detect(dev, variances=(
        0.2, 0.2, 0.1, 0.1))[..., 1:]], [d_cpu[..., 1:]])
    if not ctrl_det > DET_TOL:
        fail("detection_ops: the MultiBoxDetection control (variances "
             "reversed) passes: %g" % ctrl_det)
    result["multibox_detection"] = {
        "max_abs_err": d_err, "ids_equal": True,
        "kept": int((d_cpu[..., 0] >= 0).sum()),
        "control_variances_reversed_err": ctrl_det,
        "wall_ms": _synced_ms(torch, lambda: run_detect(dev), n=5),
        "device_ms": profile_calls(torch, lambda: run_detect(dev),
                                   "multibox_detection", None, warm=1, n=2,
                                   calls=4)["device_ms"],
        "cpu_wall_ms": _synced_ms(torch, lambda: run_detect(cpu), n=2)}

    # (4) box_nms over each image's top 400 detections
    nms = OPS["_contrib_box_nms"]
    rows = d_cpu[:, :400].clone()
    nms_attrs = {"overlap_thresh": 0.45, "id_index": 0, "topk": 200}

    def run_nms(device, **over):
        return nms.apply(nms.make_params(dict(nms_attrs, **over)),
                         [rows.to(device)])[0]
    n_card, n_cpu = run_nms(dev), run_nms(cpu)
    if not torch.equal(n_card.cpu(), n_cpu):
        fail("detection_ops: box_nms's rows differ from the CPU's")
    ctrl_nms = torch.equal(run_nms(dev, overlap_thresh=0.3).cpu(), n_cpu)
    if ctrl_nms:
        fail("detection_ops: the box_nms control (overlap 0.3) passes")
    result["box_nms"] = {"equal": True, "kept": int((n_cpu[..., 0] >= 0)
                                                    .sum()),
                         "control_overlap_0.3_equal": ctrl_nms,
                         "wall_ms": _synced_ms(torch, lambda: run_nms(dev),
                                               n=5)}

    # (5) the other families, outputs and gradients
    ops, bad = {}, {}
    battery = detection_battery(np, np.random.RandomState(seed + 42))
    for name, opname, arrays, attrs, grad, tol in battery:
        op = OPS[opname]
        got = _run_op(torch, op, arrays, attrs, grad, dev, seed)
        want = _run_op(torch, op, arrays, attrs, grad, cpu, seed)
        if tol == "exact":
            ok = _same(torch, got[0], want[0])
            err = grad_err = 0.0 if ok else float("inf")
        else:
            err = _max_err(torch, got[0], want[0])
            grad_err = _max_err(torch, got[1], want[1])
            ok = max(err, grad_err) <= tol
        ops[name] = {"op": opname, "err": err, "grad_err": grad_err,
                     "tol": tol, "grads": len(grad), "wall_ms": _synced_ms(
                         torch, lambda: _run_op(torch, op, arrays, attrs,
                                                (), dev, seed), n=3)}
        if not ok:
            bad[name] = ops[name]
    if bad:
        fail("detection_ops: ops off the CPU's: %s" % json.dumps(bad))
    # the battery's control: ROIAlign on the card with its features moved
    # by 0.01
    name, opname, arrays, attrs, grad, tol = battery[1]
    moved = [arrays[0] + np.float32(0.01)] + arrays[1:]
    ctrl = _max_err(torch, _run_op(torch, OPS[opname], moved, attrs, grad,
                                   dev, seed)[0],
                    _run_op(torch, OPS[opname], arrays, attrs, grad, cpu,
                            seed)[0])
    if not ctrl > OPS_TOL:
        fail("detection_ops: the battery's control (%s's features moved by "
             "0.01) passes: %g" % (opname, ctrl))
    # the factorisations: cuSOLVER's against LAPACK's up to each row's
    # sign; the symmetric matrices have eigenvalues 1, 2, ..., 32, so each
    # eigenvector is defined up to its sign
    frng = np.random.RandomState(seed + 43)
    a = frng.uniform(-1, 1, (8, 32, 48)).astype(np.float32)
    q = np.linalg.qr(frng.standard_normal((8, 32, 32)))[0]
    s = q @ (np.arange(1.0, 33.0)[:, None] * q.transpose(0, 2, 1))
    s = (s + s.transpose(0, 2, 1)) / 2
    factor = {}
    for opname, arr in (("linalg_gelqf", a), ("linalg_syevd",
                                              s.astype(np.float32))):
        op = OPS[opname]
        (g1, g2), _ = _run_op(torch, op, [arr], {}, (), dev, seed)
        (w1, w2), _ = _run_op(torch, op, [arr], {}, (), cpu, seed)
        g1, g2 = g1.cpu().double(), g2.cpu().double()
        w1, w2 = w1.double(), w2.double()
        signs = torch.sign((g1 * w1).sum(-1, keepdim=True))
        flips = int((signs < 0).sum())
        if opname == "linalg_gelqf":
            recon = g2 @ g1
            err = _max_err(torch, [g1 * signs, g2 * signs.transpose(-1, -2),
                                   recon], [w1, w2, torch.from_numpy(a)
                                            .double()])
        else:
            recon = g1.transpose(-1, -2) @ (g2[..., None] * g1)
            err = _max_err(torch, [g1 * signs, g2, recon / 32.0],
                           [w1, w2, torch.from_numpy(s).double() / 32.0])
        ortho = _max_err(torch, [g1 @ g1.transpose(-1, -2)],
                         [torch.eye(g1.shape[-2]).double().expand(
                             g1.shape[:-2] + (g1.shape[-2],) * 2)])
        if not (err <= OPS_TOL and ortho <= OPS_TOL):
            fail("detection_ops: %s up to sign %g, orthonormality %g"
                 % (opname, err, ortho))
        factor[opname] = {"err_up_to_sign": err, "sign_flips_vs_cpu": flips,
                          "orthonormality_err": ortho}
    result["ops"] = ops
    result["battery_control_err"] = ctrl
    result["factorisations"] = factor
    result["families"] = len(ops) + len(factor) + 4
    return result


def phase_ssd_fit(torch, dev, seed, tmp, out_dir):
    """Full-width SSD-300 through Module.fit(kvstore='tpu_sync'), a narrow
    SSD's fit on the card against the CPU, and the reference's
    example/ssd/train.py through the launcher (module docstring, phase
    41). Returns (result, #7's (launches, leaves) by kind on the path)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import opt_update as tou
    from mxnet_tpu_torch.ops import OPS
    result = {"phase": "ssd_fit"}
    totals = {k: [0, 0] for k in OPT_KERNELS}

    def add_counts():
        """#7's counts since the last call join the path's totals."""
        for k in OPT_KERNELS:
            totals[k][0] += getattr(tou, "launches_" + k)
            totals[k][1] += getattr(tou, "leaves_" + k)
        _reset_opt_counts(tou)

    # (a) SSD-300 (VGG16-reduced, symbol_builder's DEFAULT_* pyramid)
    ex = ssd_example(mx)
    with mx.name.NameManager():
        net = ex["symbol_builder"].get_symbol_train(SSD_CLASSES)
    n_leaves = len(net.list_arguments()) - 2
    synth = ex["iterator"].SyntheticDetIter(
        SSD_BATCH, data_shape=(3, SSD_SIDE, SSD_SIDE),
        num_classes=SSD_CLASSES, num_batches=SSD_EPOCH, seed=seed)
    fixed = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in synth]
    it = mx.io.NDArrayIter(np.concatenate([d for d, _ in fixed]),
                           np.concatenate([lb for _, lb in fixed]),
                           SSD_BATCH, label_name="label")
    del fixed
    stamps, losses = [], []

    def on_batch(p):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if p.nbatch == SSD_EPOCH - 1:      # each epoch's MultiBoxMetric
            losses.append([float(v) for v in p.eval_metric.get()[1]])

    mx.random.seed(seed)
    mod = mx.mod.Module(net, label_names=("label",), context=dev)
    _reset_opt_counts(tou)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
        mod.fit(it, eval_metric=ex["metric"].MultiBoxMetric(),
                kvstore="tpu_sync", optimizer="sgd",
                optimizer_params=SSD_OPT, initializer=mx.init.Xavier(),
                batch_end_callback=on_batch, num_epoch=SSD_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = SSD_EPOCH * SSD_EPOCHS
    counts = (_opt_counts(tou), _opt_leaves(tou))
    want = ({"sgd": 0, "sgd_mom": steps, "adam": 0},
            {"sgd": 0, "sgd_mom": n_leaves * steps, "adam": 0})
    if mod._fused_step is None or counts != want:
        fail("ssd_fit: fused step %s, #7 (launches, leaves) %s, want %s"
             % (mod._fused_step is not None, counts, want))
    add_counts()
    if len(losses) != SSD_EPOCHS or not all(math.isfinite(v) for q in
                                            losses for v in q):
        fail("ssd_fit: MultiBoxMetric by epoch %s" % losses)
    if not (losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]):
        fail("ssd_fit: the two MultiBoxMetric losses did not both fall: "
             "%s" % losses)
    half = steps // 2
    walls = [(b - a) * 1e3 for a, b in zip(stamps[half:], stamps[half + 1:])]
    metric = ex["metric"].MultiBoxMetric()
    it.reset()
    batch = it.next()

    def module_step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)

    with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
        prof = profile_calls(torch, module_step, "ssd_fit", out_dir,
                             warm=1, n=3, calls=2, classify=kind_of)
        inside = {}

        def timed(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                inside.setdefault(name, []).append(
                    (time.perf_counter() - t) * 1e3)
                return out
            return run
        ops = {n: OPS["_contrib_" + n] for n in ("MultiBoxTarget",
                                                 "MultiBoxDetection")}
        with mock.patch.object(ops["MultiBoxTarget"], "fn", timed(
                "MultiBoxTarget", ops["MultiBoxTarget"].fn)), \
                mock.patch.object(ops["MultiBoxDetection"], "fn", timed(
                    "MultiBoxDetection", ops["MultiBoxDetection"].fn)):
            for _ in range(3):
                module_step()
        add_counts()
    result["ssd300"] = {
        "config": "VGG16-reduced, symbol_builder DEFAULT_* (6 scales), "
                  "%d classes + background" % SSD_CLASSES,
        "batch": [SSD_BATCH, 3, SSD_SIDE, SSD_SIDE], "steps": steps,
        "leaves": n_leaves, "fit_s": fit_s,
        "step_wall_ms_p50": statistics.median(walls),
        "multibox_metric_by_epoch": losses,
        "sgd_mom_launches": counts[0]["sgd_mom"],
        "sgd_mom_leaves": counts[1]["sgd_mom"],
        "module_step": prof,
        "op_wall_ms_p50": {n: statistics.median(v)
                           for n, v in inside.items()}}
    del mod
    torch.cuda.empty_cache()

    # (b) a narrow SSD: 3 steps on the card against the CPU
    vgg = ex["vgg16_reduced"]
    saved = vgg.get_symbol
    vgg.get_symbol = narrow_backbone(mx)
    try:
        sb = ex["symbol_builder"]
        with mx.name.NameManager():
            small = sb.get_symbol_train(
                NARROW_CLASSES, num_filters=(16, 32),
                sizes=sb.DEFAULT_SIZES[:2], ratios=sb.DEFAULT_RATIOS[:2],
                normalization=(20, -1))
    finally:
        vgg.get_symbol = saved
    synth = ex["iterator"].SyntheticDetIter(
        NARROW_BATCH, data_shape=(3, NARROW_SIDE, NARROW_SIDE),
        num_classes=NARROW_CLASSES, num_batches=NARROW_STEPS, seed=seed)
    batches = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in synth]
    shapes = {"data": (NARROW_BATCH, 3, NARROW_SIDE, NARROW_SIDE),
              "label": batches[0][1].shape}
    rng = np.random.RandomState(seed + 44)
    init = {}
    for name, shape in zip(small.list_arguments(),
                           small.infer_shape(**shapes)[0]):
        if name in shapes:
            continue
        if name.endswith("_scale"):
            init[name] = np.full(shape, 20.0, np.float32)
        elif name.endswith("_bias"):
            init[name] = np.zeros(shape, np.float32)
        else:
            init[name] = rng.normal(0, (2.0 / np.prod(shape[1:])) ** 0.5,
                                    shape).astype(np.float32)

    def narrow_fit(ctx, n):
        data = np.concatenate([d for d, _ in batches[:n]])
        lab = np.concatenate([lb for _, lb in batches[:n]])
        train = mx.io.NDArrayIter(data, lab, NARROW_BATCH, label_name="label")
        m = mx.mod.Module(small, label_names=("label",), context=ctx)
        m.fit(train, eval_metric=ex["metric"].MultiBoxMetric(),
              kvstore="tpu_sync", optimizer="sgd", optimizer_params=SSD_OPT,
              arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                          for k, v in init.items()},
              aux_params={}, num_epoch=1)
        return {k: torch.from_numpy(v.asnumpy())
                for k, v in m.get_params()[0].items()}

    with mock.patch.dict(os.environ, MXNET_TPU_FUSED_OPTUPDATE="1"):
        on_card = narrow_fit(dev, NARROW_STEPS)
        add_counts()
        on_cpu = narrow_fit(mx.cpu(), NARROW_STEPS)
        short = narrow_fit(mx.cpu(), NARROW_STEPS - 1)
    gate = {k: _rel_l2([on_card[k]], [on_cpu[k]]) for k in on_cpu}
    ctrl = {k: _rel_l2([short[k]], [on_cpu[k]]) for k in on_cpu}
    if not max(gate.values()) <= NARROW_TOL:
        fail("ssd_fit: the narrow SSD's fit on the card is %s (relative "
             "L2) from the CPU's (tol %g)" % (gate, NARROW_TOL))
    if not max(ctrl.values()) > NARROW_TOL:
        fail("ssd_fit: the control (one batch short) passes the gate: %s"
             % ctrl)
    result["narrow_card_vs_cpu"] = {
        "batch": list(shapes["data"]), "steps": NARROW_STEPS,
        "rel_l2_max": max(gate.values()),
        "control_rel_l2_max": max(ctrl.values()), "tol": NARROW_TOL}

    # (c) the reference's example/ssd/train.py, unchanged
    out, child, seconds = _run_script(
        torch, "ssd/train.py", SSD_SCRIPT_ARGS,
        {"MXNET_TPU_FUSED_OPTUPDATE": "1"}, tmp)
    import re
    ce = [float(v) for v in re.findall(
        r"Epoch\[0\] Train-CrossEntropy=([0-9.e+-]+)", out)]
    maps = [float(v) for v in re.findall(
        r"Epoch\[0\] Validation-mAP=([0-9.e+-]+)", out)]
    if not ce or not maps or not all(math.isfinite(v) for v in ce + maps):
        fail("ssd_fit: example/ssd/train.py printed Train-CrossEntropy %s, "
             "Validation-mAP %s: %s" % (ce, maps, out[-2000:]))
    for k in OPT_KERNELS:
        totals[k][0] += child[k][0]
        totals[k][1] += child[k][1]
    result["script"] = {"args": SSD_SCRIPT_ARGS, "seconds": seconds,
                        "train_cross_entropy": ce, "validation_map": maps,
                        "opt_update_counts": child}
    return result, {k: tuple(v) for k, v in totals.items()}


PHASES = ("kernel", "serve", "profile", "train_kernel", "train",
          "train_profile", "opt_kernel", "symbolic_train", "symbolic_profile",
          "grid_kernel", "serve_long", "train_long", "rtc_kernel",
          "rtc_infer", "module_fit", "example_scripts", "serve_bf16",
          "train_bf16", "symbolic_bf16", "bf16_kernel", "serve_long_bf16",
          "train_long_bf16", "serve_f16", "train_f16", "f16_kernel",
          "serve_long_f16", "train_long_f16", "supervised_fit",
          "serve_engine", "serve_engine_rtc", "model_server", "frontdoor",
          "fleet", "imperative", "stochastic_fit", "rnn_seq",
          "bucketing_fit", "detection_ops", "ssd_fit")
#: phase -> the phases whose results it needs
NEEDS = {"profile": ("serve",), "train_profile": ("train",),
         "symbolic_profile": ("symbolic_train",),
         "serve_engine_rtc": ("rtc_infer",), "model_server": ("serve",),
         "imperative": ("rtc_infer",),
         "frontdoor": ("serve",)}


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
    parser.add_argument("--frontdoor-client", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.frontdoor_client:
        # the frontdoor phase's client process (it needs no card)
        return frontdoor_client(args.frontdoor_client)
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
        # the model_server and frontdoor phases serve the same model on
        # their decode replicas
        serve_model = model if phases & {"model_server", "frontdoor"} \
            else None
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
        infer, row, rtc_state = phase_rtc_infer(torch, dev, args.seed,
                                                args.profile_dir)
        emit({**infer, "card": card})
        launches_by_path = {"rtc_infer": row["launches"]}
        if "serve_engine_rtc" in phases:
            res, launches_by_path["serve_engine_rtc"] = \
                phase_serve_engine_rtc(torch, dev, rtc_state)
            emit({**res, "card": card})
        if "imperative" in phases:
            res, opt_paths["imperative"], launches_by_path["imperative"] = \
                phase_imperative(torch, dev, args.seed, rtc_state)
            emit({**res, "card": card})
            torch.cuda.empty_cache()
        del rtc_state
        torch.cuda.empty_cache()
        entries.append({
            "name": "rtc_user_relu_f32", "route": "cuda",
            "source": "chip_smoke.py", "replaces": RTC_REF + "96",
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "launches_by_path": launches_by_path,
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
    if "supervised_fit" in phases:
        sup_result, opt_paths["supervised_fit"] = phase_supervised_fit(
            torch, dev, args.seed, args.profile_dir)
        emit(sup_result)
        torch.cuda.empty_cache()
    if "stochastic_fit" in phases:
        res, opt_paths["stochastic_fit"] = phase_stochastic_fit(
            torch, dev, args.seed)
        emit({**res, "card": card})
        torch.cuda.empty_cache()
    if "rnn_seq" in phases:
        res, opt_paths["rnn_seq"] = phase_rnn_seq(torch, dev, args.seed,
                                                  args.profile_dir)
        emit({**res, "card": card})
        torch.cuda.empty_cache()
    if "bucketing_fit" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            res, opt_paths["bucketing_fit"] = phase_bucketing_fit(
                torch, dev, args.seed, tmp)
        emit({**res, "card": card})
        torch.cuda.empty_cache()
    if "detection_ops" in phases:
        emit({**phase_detection_ops(torch, dev, args.seed), "card": card})
        torch.cuda.empty_cache()
    if "ssd_fit" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            res, opt_paths["ssd_fit"] = phase_ssd_fit(
                torch, dev, args.seed, tmp, args.profile_dir)
        emit({**res, "card": card})
        torch.cuda.empty_cache()
    if "serve_engine" in phases:
        emit({**phase_serve_engine(torch, dev, args.seed, args.profile_dir),
              "card": card})
        torch.cuda.empty_cache()
    if "model_server" in phases:
        res, server_launches = phase_model_server(torch, fa, dev, args.seed,
                                                  serve_model)
        emit({**res, "card": card})
        torch.cuda.empty_cache()
        for entry in entries:
            if entry["name"] == "flash_fwd_offs_f32":
                entry["launches_by_path"] = {
                    "serve": entry["launches"],
                    "model_server": server_launches}
    if phases & {"frontdoor", "fleet"}:
        # the network tier's frames are sealed with a key of this run
        os.environ["MXNET_SERVING_AUTH_KEY"] = "chip-smoke-%s" % os.urandom(
            8).hex()
    if "frontdoor" in phases:
        res, fd_counts = phase_frontdoor(torch, fa, dev, args.seed,
                                         serve_model)
        emit({**res, "card": card})
        torch.cuda.empty_cache()
        # #1's and #3's launches on this path join their entries
        by_name = {"flash_fwd_offs_f32": "launches",
                   GRID_KERNELS["offs"][0][3:]: GRID_KERNELS["offs"][1],
                   GRID_KERNELS["offs_combine"][0][3:]:
                       GRID_KERNELS["offs_combine"][1]}
        for entry in entries:
            counter = by_name.get(entry["name"])
            if counter is not None:
                entry.setdefault("launches_by_path", {
                    "serve_long" if counter != "launches" else "serve":
                        entry["launches"]})["frontdoor"] = fd_counts[counter]
    serve_model = None
    if "fleet" in phases:
        emit({**phase_fleet(torch, dev, args.seed), "card": card})
        torch.cuda.empty_cache()
    # the 16-bit paths, bf16 then float16; symbolic_bf16 between them
    half_launches = {sfx: {} for sfx in HALF}
    for sfx in HALF:
        hl = half_launches[sfx]
        if "serve_" + sfx in phases:
            res, hl["launches_" + sfx] = phase_serve_half(torch, fa, dev,
                                                          sfx)
            emit({**res, "card": card})
            torch.cuda.empty_cache()
        if "train_" + sfx in phases:
            res, counts = phase_train_half(torch, fa, dev, args.seed,
                                           args.profile_dir, sfx)
            emit({**res, "card": card})
            hl.update((k, v) for k, v in counts.items()
                      if k != "launches_" + sfx)
            torch.cuda.empty_cache()
        if sfx == "bf16" and "symbolic_bf16" in phases:
            symb, opt_paths["symbolic_bf16"] = phase_symbolic_bf16(
                torch, dev, args.seed, args.profile_dir)
            emit({**symb, "card": card})
            torch.cuda.empty_cache()
        if "serve_long_" + sfx in phases:
            res, counts = phase_serve_long_half(torch, fa, dev, args.seed,
                                                sfx)
            emit({**res, "card": card})
            hl.update(counts)
            torch.cuda.empty_cache()
        if "train_long_" + sfx in phases:
            res, counts = phase_train_long_half(torch, fa, dev, args.seed,
                                                args.profile_dir, sfx)
            emit({**res, "card": card})
            hl.update(counts)
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
    from mxnet_tpu_torch.kernels.bf16_gate import GATES

    def body_ptxas(lib, kernel, sfx, d=64):
        """The registers and spill bytes of the body instantiation an
        entry runs at its path's head dim."""
        args = "%s,%d" % (sfx, d)
        if kernel == "flash_fwd_half_kernel":
            args += ",%d" % (lib in ("flash_fwd_offs", "flash_fwd_offs_grid"))
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

    kernel_phases = [sfx for sfx in HALF if sfx + "_kernel" in phases]
    for sfx in kernel_phases:
        dtype = getattr(torch, HALF[sfx])
        bk_worst, bk_lse, bk = phase_half_kernel(torch, fa, dev, sfx)
        emit({"phase": sfx + "_kernel", "max_row_ulps": bk_worst,
              "ulps_tol": GATES[dtype][2], "lse_max_err": bk_lse,
              "lse_tol": TOL, **bk, "card": card})
        torch.cuda.empty_cache()
        hl = half_launches[sfx]
        unit = "%s row ulps" % sfx
        train_row = bk["train"]
        bwd_pair = {"pair": train_row["dq_ms"] + train_row["dkv_ms"],
                    "of": "dq + dk/dv"}
        for name, file, line, counter, key in (
                ("flash_fwd_offs", "flash_fwd_offs.cu", "285", "launches",
                 "offs"),
                ("flash_fwd", "flash_fwd.cu", "205", "launches_fwd", "fwd"),
                ("flash_bwd_dq", "flash_bwd_offs.cu", "402",
                 "launches_bwd_dq", "dq"),
                ("flash_bwd_dkv", "flash_bwd_offs.cu", "453",
                 "launches_bwd_dkv", "dkv")):
            counter += "_" + sfx
            if counter not in hl:
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
                         "shape": "q/k/v (8,8,512,64) %s causal" % sfx}
            kernel = {"offs": "flash_fwd_half_kernel",
                      "fwd": "flash_fwd_half_kernel",
                      "dq": "flash_bwd_dq_half_kernel",
                      "dkv": "flash_bwd_dkv_half_kernel"}[key]
            entries.append({
                "name": name + "_" + sfx, "route": "cuda",
                "source": src + file, "replaces": ref + line,
                "launches": hl[counter], "max_abs_err": bk_worst[key],
                "err_unit": unit, **times,
                **shares(times, **(bwd_pair if key in ("dq", "dkv")
                                   else {})),
                **body_ptxas(file[:-3], kernel, sfx)})
        grid = bk["grid"]
        grid_pair = {"pair": sum(grid[k + "_ms"] for k in (
            "dq", "dq_reduce", "dkv", "dkv_reduce")),
                     "of": "dq + dk/dv with their reduce passes"}
        for key, (entry, _, file, line) in GRID_KERNELS.items():
            counter = half_grid_counters(sfx)[key]
            if counter not in hl:
                continue   # its path's phase did not run
            lib = {"fwd": "sdpa_fwd_ms", "dq": "sdpa_bwd_ms",
                   "dkv": "sdpa_bwd_ms", "offs": "sdpa_offs_ms"}.get(key)
            plain = {"dkv": "bwd_plain_ms", "dq": "bwd_plain_ms"}.get(
                key, key + "_plain_ms")
            row = {"ms": grid[key + "_ms"],
                   "bound_ms": grid[key + "_bound_ms"],
                   "library_ms": grid[lib] if lib else None}
            kernel = {"fwd": "flash_fwd_half_kernel",
                      "offs": "flash_fwd_half_kernel",
                      "dq": "flash_bwd_dq_half_kernel",
                      "dkv": "flash_bwd_dkv_half_kernel"}.get(key)
            entries.append({
                "name": entry[3:-3] + sfx, "route": "cuda",
                "source": src + file, "replaces": ref + line,
                "launches": hl[counter],
                "max_abs_err": bk_worst["grid_" + key],
                "err_unit": unit, **row,
                "plain_ms": grid[plain],
                "bound_by": grid[key + "_bound_by"],
                "tflops": grid[key + "_tflops"],
                **shares(row, **(grid_pair if key in ("dq", "dkv")
                                 else {})),
                **(body_ptxas(file[:-3], kernel, sfx) if kernel else
                   {"registers": None, "spill_bytes": None}),
                "shape": ("q (1,8,1024,64) k/v (1,8,4096,64) %s offs "
                          "[2816,0], 8 key splits" % sfx
                          if key.startswith("offs") else
                          "q/k/v (4,8,4096,64) %s causal, 8 splits" % sfx)})
    if kernel_phases:
        emit({"phase": "hgmma", "card": card,
              # per library: each kernel's HGMMA instructions in SASS
              "counts": hgmma_counts(paths)})
    if args.parent:
        emit({**phase_parent(torch, fa, dev, args.parent), "card": card})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
